"""Compiled query pipelines — trace a maximal plan segment into ONE XLA
program.

Eager execution (engine/executor.py) dispatches one or more device programs
per plan node and syncs a row count after every size-changing operator to
pick the next output capacity bucket, so an eight-operator query pays ~10
dispatches and host syncs even when the math itself takes microseconds.

A compiled pipeline instead threads a *selection mask* through the segment:

    filter / HAVING       sel &= predicate(cols)           (no compaction)
    DISTINCT [ON]         sel &= first-occurrence flags    (no compaction)
    LIMIT / OFFSET        sel &= rank window over sel      (no compaction)
    projection / window   new planes, sel unchanged
    sort                  planes gathered by permutation; sel = prefix mask
    aggregate             segment-reduce into a statically bounded group
                          space; sel = prefix mask over groups

so an entire scan->filter->aggregate->having->sort->limit query compiles to
ONE XLA program (XLA fuses the filter mask into the aggregate's reduction —
the intermediate "filtered table" never materializes in HBM), plus a single
row-count sync, plus one compaction program when the surviving rows aren't
already front-packed (after sort/aggregate they are, so most shapes skip it).

Programs are cached by (plan structure, leaf capacities/dtypes/dictionary
identities): steady-state serving reuses one executable per query shape per
pow2 capacity bucket.

Equi-joins with a statically unique side trace in-segment with a static
emit bound; set operations trace as concatenation (UNION [ALL]) or mask
refinement (INTERSECT/EXCEPT). Unsupported constructs (subqueries, UDFs,
string concatenation, joins with no unique side) fall back to the eager
executor — per *subtree*, not per query: the segment above an
eagerly-executed join still compiles, with the join result fed in as a
leaf.

This is the compiled answer to the reference's interpreter-style recursive
executor (crates/query-executor/src/executor.rs:19-91, one materialized
Vec<RecordBatch> per node): plans compile, not interpret (SURVEY.md §7).
The eager executor remains the semantics oracle — differential-tested in
tests/test_compiled_pipeline.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from query_engine_tpu.core.errors import ExecutionError
from query_engine_tpu.core.schema import Schema
from query_engine_tpu.columnar.batch import Column, ColumnBatch, padded_capacity
from query_engine_tpu.ops import kernels as K
from query_engine_tpu.plan import logical as lp
from query_engine_tpu.plan import physical as pp


class _CountReady(Exception):
    """Raised mid-trace by a count-mode join: carries the traced output-size
    scalar up to the count program's body (emit-capacity sync — the host
    reads this one scalar, picks a pow2 emit bucket, and dispatches the
    companion emit program; SURVEY.md §7 hard-part #1)."""

    def __init__(self, node, count, extras=()):
        super().__init__("join count ready")
        self.node = node
        self.count = count
        # sorted-space planes (sperm, sorted_lead, change) the emit program
        # can reuse to skip its joint sort (VERDICT r2 item 4a); () when the
        # count path had no sort to share (direct ranks / aggregates)
        self.extras = extras


class _Unsupported(Exception):
    """Raised during segment analysis/tracing: fall back to eager."""


# trace-time failures that mean "host-dependent value inside jit" — fall back
_TRACE_ERRORS = (
    _Unsupported,
    ExecutionError,
    NotImplementedError,
    jax.errors.TracerArrayConversionError,
    jax.errors.TracerBoolConversionError,
    jax.errors.TracerIntegerConversionError,
    jax.errors.ConcretizationTypeError,
)


@dataclass
class _TTable:
    """A traced table: column planes at a static capacity plus a boolean
    selection mask. `dense` is statically known: the selected rows are a
    prefix (sel == live_mask(cap, count)), so no compaction is needed.
    `bounds[i]` is a static conservative (lo, bucket_range) cover of integer
    column i's values (None if unknown) — it survives filter/sort/limit
    (subsets and permutations keep covers valid) and enables sort-free
    direct grouping without the eager path's key-range host sync."""

    schema: Schema
    cols: List[Column]  # .data/.validity are tracers
    sel: jnp.ndarray
    capacity: int
    dense: bool
    bounds: List[Optional[Tuple[int, int]]]


def _stats_eligible(col) -> bool:
    return (
        col.dictionary is None
        and np.issubdtype(np.dtype(col.data.dtype), np.integer)
    )


_minmax_jits = {}


def ensure_bounds(batch: ColumnBatch) -> None:
    """Populate integer-column bounds caches. Host-backed planes use numpy;
    device-backed planes (intermediate results, device-resident tables) use
    ONE fused device reduction for the whole batch — never a device->host
    plane transfer (a 32M-row join output would ship ~1GB to the host per
    query otherwise)."""
    pending = []
    for c in batch.columns:
        if getattr(c, "_qe_bounds", False) is not False:
            continue
        dt = np.dtype(c.data.dtype)
        if c.dictionary is not None or not np.issubdtype(dt, np.integer):
            c._qe_bounds = (0, 1) if dt == np.bool_ else None
        elif isinstance(c.data, np.ndarray):
            c._qe_bounds = (
                (int(c.data.min()), int(c.data.max())) if c.data.size else None
            )
        else:
            pending.append(c)
    if not pending:
        return
    key = tuple((c.data.shape[0], str(c.data.dtype)) for c in pending)
    fn = _minmax_jits.get(key)
    if fn is None:
        fn = jax.jit(
            lambda planes: [(jnp.min(p), jnp.max(p)) for p in planes]
        )
        _minmax_jits[key] = fn
    outs = fn([c.data for c in pending])
    for c, (lo, hi) in zip(pending, outs):
        c._qe_bounds = (int(lo), int(hi)) if c.data.shape[0] else None


def _col_bounds(col) -> Optional[Tuple[int, int]]:
    """Cached raw (min, max) over an integer column's full data plane
    (padding included — a conservative cover is all direct grouping needs).
    Cached on the Column object; DML replaces batches, so staleness is
    impossible. Device-backed planes without a cache entry return None —
    ensure_bounds() fills them in one fused dispatch per batch."""
    b = getattr(col, "_qe_bounds", False)
    if b is not False:
        return b
    dt = np.dtype(col.data.dtype)
    if col.dictionary is not None:
        b = None
    elif dt == np.bool_:
        b = (0, 1)
    elif not np.issubdtype(dt, np.integer):
        b = None
    elif isinstance(col.data, np.ndarray):
        b = (int(col.data.min()), int(col.data.max())) if col.data.size else None
    else:
        return None  # no cache write: ensure_bounds may fill it later
    col._qe_bounds = b
    return b


def _bucket_bounds(b: Optional[Tuple[int, int]]):
    """Quantize raw bounds to (lo floored to 128, pow2 range) so appends
    within the bucket reuse the compiled program. Ranges too large for
    direct grouping collapse to a single sentinel (no recompile churn)."""
    if b is None:
        return None
    lo, hi = b
    lo_b = (lo >> 7) << 7
    rng = hi - lo_b + 1
    if rng > (1 << 21):  # _DIRECT_GROUP_MAX_RANGE
        return ("big",)
    return (lo_b, padded_capacity(rng))


def ensure_device(batch: ColumnBatch) -> ColumnBatch:
    """Move a batch's planes to the device once, in place. Tables live in
    host memory as numpy until first use; without this every query re-ships
    every scanned plane over the host-to-device path — at 1M rows
    that transfer dwarfs the query itself."""
    for c in batch.columns:
        if not isinstance(c.data, jax.Array):
            c.data = jnp.asarray(c.data)
        if not isinstance(c.validity, jax.Array):
            c.validity = jnp.asarray(c.validity)
    return batch


_maxdup_jits = {}


def _device_max_dup(cols, num_rows: int) -> int:
    """Max multiplicity of the live fully-valid key tuple, computed on
    device (one jitted sort + run-length scan) — device planes never ship
    to host for stats."""
    cap = cols[0].data.shape[0]
    key = tuple((cap, str(c.data.dtype)) for c in cols)
    fn = _maxdup_jits.get(key)
    if fn is None:

        @jax.jit
        def fn(datas, valids, n):
            lm = K.live_mask(cap, n)
            okall = lm
            for v in valids:
                okall = okall & v
            ops = [(~okall).astype(jnp.int32)]
            for d in datas:
                ops.append(jnp.where(okall, K.orderable_i64(d),
                                     jnp.zeros((), K.orderable_i64(d).dtype)))
            srt = jax.lax.sort(
                ops + [okall.astype(jnp.int32)], num_keys=len(ops),
                is_stable=True,
            )
            keys_sorted = srt[:-1]
            ok_sorted = srt[-1].astype(bool)
            idx = jnp.arange(cap)
            change = jnp.zeros(cap, dtype=bool).at[0].set(True)
            for k2 in keys_sorted:
                change = change | (idx > 0) & (k2 != jnp.roll(k2, 1))
            start = K._seg_start_pos(change)
            end = K._seg_end_pos(change)
            runlen = end - start + 1
            return jnp.max(jnp.where(ok_sorted, runlen, 0))

        _maxdup_jits[key] = fn
    d = int(fn([c.data for c in cols], [c.validity for c in cols],
               np.int64(num_rows)))
    return max(d, 1)


def _col_max_dup(col, num_rows: int) -> int:
    """Cached: maximum multiplicity of any live valid value in the column
    (1 == unique). Subsetting (filter/limit/distinct) can only shrink
    multiplicities, so the stat computed on a leaf batch stays a valid
    bound anywhere above it in the plan. Drives the static join-emit bound:
    probing a side with max-dup d yields <= d matches per probe row."""
    cached = getattr(col, "_qe_max_dup", None)
    if cached is not None and cached[0] == num_rows:
        return cached[1]
    if isinstance(col.data, np.ndarray):
        host = col.data[:num_rows]
        valid = np.asarray(col.validity)[:num_rows]
        vals = host[valid]
        if len(vals):
            _, counts = np.unique(vals, return_counts=True)
            d = int(counts.max())
        else:
            d = 1
    else:
        d = _device_max_dup([col], num_rows)
    col._qe_max_dup = (num_rows, d)
    return d


def _cols_max_dup(batch, idxs) -> int:
    """Multi-column variant of _col_max_dup: max multiplicity of any live
    fully-valid key TUPLE (lexsort + run length; cached per batch)."""
    cache = getattr(batch.columns[idxs[0]], "_qe_tuple_max_dup", None)
    key = (tuple(idxs), batch.num_rows)
    if cache is not None and key in cache:
        return cache[key]
    n = batch.num_rows
    if any(not isinstance(batch.columns[i].data, np.ndarray) for i in idxs):
        d = _device_max_dup([batch.columns[i] for i in idxs], n)
        cache = getattr(batch.columns[idxs[0]], "_qe_tuple_max_dup", None)
        if cache is None:
            cache = {}
            batch.columns[idxs[0]]._qe_tuple_max_dup = cache
        cache[key] = d
        return d
    planes, valid = [], np.ones(n, dtype=bool)
    for i in idxs:
        c = batch.columns[i]
        planes.append(np.asarray(c.data)[:n])
        valid &= np.asarray(c.validity)[:n]
    rows = [p[valid] for p in planes]
    if rows and len(rows[0]) > 1:
        order = np.lexsort(rows[::-1])
        srt = [r[order] for r in rows]
        eq = np.ones(len(order) - 1, dtype=bool)
        for r in srt:
            eq &= r[1:] == r[:-1]
        # longest run of equal adjacent tuples + 1
        bounds = np.flatnonzero(~eq)
        run_lens = np.diff(np.concatenate([[-1], bounds, [len(eq)]]))
        d = int(run_lens.max())
    else:
        d = 1
    if cache is None:
        cache = {}
        batch.columns[idxs[0]]._qe_tuple_max_dup = cache
    cache[key] = d
    return d


def _dup_bucket(d: int):
    """Bucket a max-duplication stat to {1,2,4,8,16}; above that the emit
    capacity blowup isn't worth it (demote to eager count-then-emit)."""
    for b in (1, 2, 4, 8, 16):
        if d <= b:
            return b
    return None


def _key_ranges(exprs, vals, t):
    """Per-sort-key static (lo, range) covers: dictionary sizes or
    table-stat bounds for bare columns; None disables composite packing."""
    out = []
    for e, v in zip(exprs, vals):
        if v.dictionary is not None:
            out.append((0, max(len(v.dictionary), 1)))
        else:
            b = _proj_bounds(e, t)
            out.append(b if (b is not None and len(b) == 2) else None)
    return out

def _gather_bounds(t: "_TTable"):
    """Per-column static covers for gather_columns_packed: table-stat
    bounds where tracked, dictionary sizes for dict columns."""
    out = []
    for c, b in zip(t.cols, t.bounds):
        if c.dictionary is not None:
            out.append((0, max(len(c.dictionary), 1)))
        elif b is not None and len(b) == 2:
            out.append(b)
        else:
            out.append(None)
    return out

def _proj_bounds(e: "lp.LogicalExpr", t: _TTable):
    """Bounds survive a projection only for bare column references."""
    if isinstance(e, lp.AliasExpr):
        e = e.expr
    if isinstance(e, lp.ColumnRef) and e.index < len(t.bounds):
        return t.bounds[e.index]
    return None


def _group_key_bounds(e: "lp.LogicalExpr", t: _TTable):
    """Static (lo, range) cover for a group-key expression, if known."""
    return _proj_bounds(e, t)


class _ShimBatch:
    """Duck-typed ColumnBatch over traced planes for Evaluator calls."""

    __slots__ = ("schema", "columns", "num_rows", "capacity")

    def __init__(self, t: _TTable):
        self.schema = t.schema
        self.columns = t.cols
        self.capacity = t.capacity
        self.num_rows = t.sel  # kernels accept masks via live_mask

    @property
    def num_columns(self):
        return len(self.columns)


# ---------------------------------------------------------------------------
# expression admission + structural keys
# ---------------------------------------------------------------------------


def _expr_traceable(e: lp.LogicalExpr) -> bool:
    """Static check for expressions whose evaluation needs host work that
    cannot live inside a traced program (subquery execution, UDF callbacks,
    per-row string materialization)."""
    bad = []

    def visit(x):
        if isinstance(x, lp.UdfExpr):
            bad.append(x)  # host callback
        elif isinstance(x, lp.BinaryExpr) and x.op is lp.BinOp.CONCAT:
            bad.append(x)  # decodes data planes to host strings
        elif isinstance(x, lp.ScalarFnExpr) and x.func is lp.ScalarFn.CONCAT:
            bad.append(x)
        elif isinstance(x, lp.CastExpr) and x.target.is_dictionary and not (
            x.expr.dtype.is_dictionary
        ):
            bad.append(x)  # numeric -> string stringifies the data plane
        elif isinstance(x, lp.BinaryExpr) and x.op in lp._JSON_OPS:
            # traceable when the key is a literal: the extraction table is
            # built per dictionary value at trace time, only the code
            # remap gather is traced (expr_eval._eval_json_get)
            from query_engine_tpu.engine.expr_eval import _static_json_key

            if _static_json_key(x.right) is None:
                bad.append(x)
        elif isinstance(x, lp.ScalarFnExpr) and x.func in (
            lp.ScalarFn.JSON_EXTRACT_PATH, lp.ScalarFn.JSON_EXTRACT_PATH_TEXT,
        ):
            # same rule as the operators: every path element must be a
            # literal so the extraction table is static at trace time
            # (zero path elements is fine: identity over the document)
            from query_engine_tpu.engine.expr_eval import _static_json_key

            if any(_static_json_key(a) is None for a in x.args[1:]):
                bad.append(x)
        elif isinstance(x, lp.BinaryExpr) and x.op is lp.BinOp.TS_MATCH:
            # traceable only when the query side is a literal (the match
            # table is then built per dictionary value at trace time)
            r = x.right
            if isinstance(r, lp.ScalarFnExpr) and r.func is lp.ScalarFn.TO_TSQUERY:
                r = r.args[0] if r.args else r
            if not isinstance(r, lp.Literal):
                bad.append(x)

    lp.walk_exprs(e, visit)
    return not bad


def _trace_range_off_plane(ex, wexpr, shim, sorted_arg):
    """Sorted raw ORDER BY key for a value-distance frame inside a traced
    window segment (single numeric key; K.range_off_order_plane normalizes
    DESC and NULL sentinels — shared with the eager executor)."""
    if len(wexpr.order_by) != 1:
        raise _Unsupported("RANGE offset order keys")
    ok0 = wexpr.order_by[0]
    kv = ex.evaluator.eval(ok0.expr, shim)
    if kv.dictionary is not None or not (
        jnp.issubdtype(kv.data.dtype, jnp.integer)
        or jnp.issubdtype(kv.data.dtype, jnp.floating)
    ):
        raise _Unsupported("RANGE offset key type")
    kd, kok = sorted_arg(kv, ok0.expr)
    return K.range_off_order_plane(
        kd, kok, ok0.asc, ok0.resolved_nulls_first()
    )


def _mark_static_literals(e: lp.LogicalExpr, out: set) -> None:
    """Literals that are consumed as STATIC values during tracing (string
    function offsets, window function parameters) must stay baked into the
    program; everything else can become a traced scalar input."""
    def visit(x):
        args = None
        if isinstance(x, lp.ScalarFnExpr) and x.func in (
            lp.ScalarFn.SUBSTRING, lp.ScalarFn.ROUND, lp.ScalarFn.TRUNC,
            lp.ScalarFn.LEFT, lp.ScalarFn.RIGHT, lp.ScalarFn.LPAD,
            lp.ScalarFn.RPAD, lp.ScalarFn.SPLIT_PART, lp.ScalarFn.REPEAT,
        ):
            args = x.args[1:]
        elif isinstance(x, lp.ScalarFnExpr) and x.func in (
            lp.ScalarFn.JSON_EXTRACT_PATH, lp.ScalarFn.JSON_EXTRACT_PATH_TEXT,
        ):
            args = x.args[1:]
        elif isinstance(x, lp.BinaryExpr) and x.op in lp._JSON_OPS:
            # the key is baked into the per-dictionary extraction table at
            # trace time — it must not become a traced scalar input
            args = [x.right]
        elif isinstance(x, lp.WindowExpr):
            if x.func is lp.WindowFn.NTILE:
                args = x.args[:1]
            elif x.func in (lp.WindowFn.LAG, lp.WindowFn.LEAD):
                args = x.args[1:2]
            elif x.func is lp.WindowFn.NTH_VALUE:
                args = x.args[1:2]
        if args:
            for a in args:
                lp.walk_exprs(a, lambda y: out.add(id(y)))

    lp.walk_exprs(e, visit)


def _expr_key(e: lp.LogicalExpr, ctx=None):
    """Structural key: equal keys => identical computation over identical
    input planes. (Unlike LogicalExpr.name(), aliases do not hide the inner
    expression and column references key on their resolved index.)

    With a _SegCtx, eligible numeric/bool literals key as ("dynlit", kind)
    and their VALUES are collected into ctx.dyn_vals — they become traced
    scalar inputs, so one compiled program serves every parameter value
    (prepared statements / dashboards do not recompile per constant)."""
    if isinstance(e, lp.ColumnRef):
        return ("col", e.index, str(e.dtype))
    if isinstance(e, lp.Literal):
        v = e.value.value
        if (
            ctx is not None and v is not None and not isinstance(v, str)
            and id(e) not in ctx.static_ids
            and isinstance(v, (bool, int, float, np.bool_, np.integer,
                               np.floating))
            and not e.value.dtype.is_dictionary
        ):
            if isinstance(v, (bool, np.bool_)):
                tag, sv = "b", np.bool_(v)
            elif isinstance(v, (int, np.integer)) and not e.value.dtype.is_float:
                tag, sv = "i", np.int64(v)
            else:
                tag, sv = "f", np.float64(float(v))
            ctx.dyn_vals.append(sv)
            ctx.dyn_ids.append(id(e))
            ctx.dyn_exprs.append(e)
            return ("dynlit", tag)
        return ("lit", str(e.value.dtype), repr(v))
    if isinstance(e, lp.IntervalLiteral):
        return ("ival", e.months, e.days, e.micros)
    if isinstance(e, lp.AliasExpr):
        # alias names land in the output schema -> they are part of the key
        return ("as", e.alias, _expr_key(e.expr, ctx))
    if isinstance(e, lp.BinaryExpr):
        return ("bin", e.op.value, _expr_key(e.left, ctx), _expr_key(e.right, ctx))
    if isinstance(e, lp.UnaryExpr):
        return ("un", e.op.value, _expr_key(e.expr, ctx))
    if isinstance(e, lp.CastExpr):
        return ("cast", str(e.target), _expr_key(e.expr, ctx))
    if isinstance(e, lp.ScalarFnExpr):
        return ("fn", e.func.value, tuple(_expr_key(a, ctx) for a in e.args))
    if isinstance(e, lp.AggregateExpr):
        return (
            "agg", e.func.value, e.distinct,
            None if e.expr is None else _expr_key(e.expr, ctx),
        )
    if isinstance(e, lp.CaseExpr):
        return (
            "case",
            tuple((_expr_key(c, ctx), _expr_key(v, ctx)) for c, v in e.branches),
            None if e.else_expr is None else _expr_key(e.else_expr, ctx),
        )
    if isinstance(e, lp.InListExpr):
        return (
            "inlist", e.negated, _expr_key(e.expr, ctx),
            tuple(_expr_key(i, ctx) for i in e.items),
        )
    if isinstance(e, lp.IsNullExpr):
        return ("isnull", e.negated, _expr_key(e.expr, ctx))
    if isinstance(e, lp.WindowExpr):
        return (
            "win", e.func.value,
            tuple(_expr_key(a, ctx) for a in e.args),
            tuple(_expr_key(p, ctx) for p in e.partition_by),
            tuple(_sort_key_key(k, ctx) for k in e.order_by),
            repr(e.frame),
        )
    # subquery expressions: the subplan runs EAGERLY and its result batch
    # feeds the program as an extra leaf, so the key carries only the outer
    # computation — a different subplan with identical output shape reuses
    # the same (correct) executable
    if ctx is not None and isinstance(e, lp.ScalarSubqueryExpr):
        ctx.sub_exprs.append(e)
        return ("ssub", str(e.dtype))
    if ctx is not None and isinstance(e, lp.InSubqueryExpr):
        inner = _expr_key(e.expr, ctx)
        ctx.sub_exprs.append(e)
        return ("insub", e.negated, inner)
    if ctx is not None and isinstance(e, lp.ExistsExpr):
        ctx.sub_exprs.append(e)
        return ("exists", e.negated)
    if ctx is not None and isinstance(e, lp.QuantifiedCmpExpr):
        inner = _expr_key(e.expr, ctx)
        ctx.sub_exprs.append(e)
        return ("qcmp", e.op.value, e.is_any, inner)
    if ctx is not None and isinstance(e, lp.CorrelatedLookupExpr):
        okeys = tuple(_expr_key(k, ctx) for k in e.outer_keys)
        ctx.sub_exprs.append(e)
        return (
            "corr", e.mode, e.negated,
            None if e.miss_value is None else repr(e.miss_value.value),
            okeys,
        )
    raise _Unsupported(f"expr {type(e).__name__}")


def _sort_key_key(k: lp.SortKey, ctx=None):
    return (_expr_key(k.expr, ctx), k.asc, k.resolved_nulls_first())


# ---------------------------------------------------------------------------
# the pipeline compiler
# ---------------------------------------------------------------------------

# nodes that participate in a compiled segment; anything else is a leaf
# boundary executed eagerly and fed in as a materialized batch
_COMPUTE_NODES = (
    pp.PFilter, pp.PSort, pp.PHashAggregate, pp.PDistinct, pp.PWindow,
)


class _SegCtx:
    """Per-analysis context: joins forced to eager boundaries, join
    duplication checks, and dynamic-literal collection (parameterized
    programs)."""

    __slots__ = ("forced", "checks", "static_ids", "dyn_vals", "dyn_ids",
                 "dyn_exprs", "sub_exprs")

    def __init__(self, forced):
        self.forced = forced
        self.checks = []  # (join node, left provenance, right provenance)
        self.static_ids = set()  # literal ids that must stay baked
        self.dyn_vals = []   # np scalars, traversal order
        self.dyn_ids = []    # id(expr) per dyn literal (this plan)
        self.dyn_exprs = []  # the literal exprs (kept alive via entry.plan)
        self.sub_exprs = []  # subquery exprs: plans execute eagerly, their
        # result batches feed the program as extra leaves


class CompiledPipeline:
    def __init__(self, executor):
        self.executor = executor  # eager QueryExecutor (fallback + leaves)
        self._cache = {}  # plan key -> _Entry
        self._eager_bodies = set()  # structural keys known to fail tracing
        self._compact_cache = {}  # (cap, out_cap, dtypes) -> jitted fn
        self._xfer_by_node = None  # trace-time: counted-join node id ->
        # (sperm, sorted_lead, change) planes handed over from the count
        # program (emit skips its joint sort)
        self.stats = {"compiles": 0, "hits": 0, "fallbacks": 0,
                      "joins_inlined": 0, "joins_demoted": 0,
                      "joins_counted": 0}

    # ---- entry -----------------------------------------------------------
    def try_execute(self, plan: pp.PhysicalPlan) -> Optional[ColumnBatch]:
        """Returns the result batch, or None to run the eager path."""
        forced: set = set()
        while True:  # joins without a unique side demote to eager leaves
            ctx = _SegCtx(forced)
            try:
                key_body, leaf_nodes, n_compute = self._plan_key(plan, ctx)
            except _Unsupported:
                return None
            if n_compute == 0:
                return None  # pure scan/limit/rename — eager is already cheap
            if key_body in self._eager_bodies:
                self.stats["fallbacks"] += 1
                return None

            # materialize leaves (table scans + eager subtrees)
            leaves = [self._materialize_leaf(n) for n in leaf_nodes]
            for b in leaves:
                ensure_bounds(b)  # one fused dispatch per device-backed batch
            batch_by_node = dict(zip(map(id, leaf_nodes), leaves))

            # resolve join duplication stats; joins without a static bound
            # go through the count->emit two-program capacity sync
            res = {}
            for jnode, lprov, rprov in ctx.checks:
                if lprov == "AGG":
                    # unbounded-key aggregate: group-space count->emit
                    res[id(jnode)] = ("C", None)
                    continue
                dl = self._prov_max_dup(lprov, batch_by_node, res)
                dr = self._prov_max_dup(rprov, batch_by_node, res)
                side = None
                # prefer the right (build) side on ties; bucket to pow2 so
                # data drift within a bucket reuses the program
                if dr is not None and (dl is None or dr <= dl):
                    side = ("R", _dup_bucket(dr))
                elif dl is not None:
                    side = ("L", _dup_bucket(dl))
                # HBM guard: the emit capacity is probe_cap * dup; count
                # rather than allocate beyond ~64M-row planes
                if side is not None and side[1] is not None and leaves:
                    cap_est = max(b.capacity for b in leaves)
                    if cap_est * side[1] > (1 << 26):
                        side = (side[0], None)
                if side is None or side[1] is None:
                    res[id(jnode)] = ("C", None)  # size via count program
                else:
                    res[id(jnode)] = side

            # subquery plans execute eagerly; their results are extra leaves
            sub_batches = [
                self.executor.execute(x.plan) for x in ctx.sub_exprs
            ]
            for b in leaves + sub_batches:
                ensure_device(b)

            def batch_args(b):
                return {
                    "d": [c.data for c in b.columns],
                    "v": [c.validity for c in b.columns],
                    "n": np.int64(b.num_rows),
                }

            leaf_args = [batch_args(b) for b in leaves]
            sub_args = [batch_args(b) for b in sub_batches]
            dyn_args = tuple(ctx.dyn_vals)  # traced scalars, traversal order
            leaf_sigs = tuple(self._leaf_sig(b) for b in leaves)
            sub_sigs = tuple(self._leaf_sig(b) for b in sub_batches)

            # count->emit capacity sync: each unresolved join costs ONE
            # extra cached dispatch (its count program) + one host scalar
            # read; the emit program is then fully static. Replaces the
            # eager demotion for joins with unbounded key duplication.
            demoted = False
            xfers_by_ord = {}  # check ordinal -> sorted-space device planes
            while True:
                pending = [
                    j for j, _, _ in ctx.checks
                    if res.get(id(j)) == ("C", None)
                ]
                if not pending:
                    break
                sides_now = tuple(res[id(j)] for j, _, _ in ctx.checks)
                ckey = (key_body, leaf_sigs, sub_sigs, sides_now, "count")
                centry = self._cache.get(ckey)
                if centry is None:
                    centry = self._build_count_entry(
                        plan, ctx, leaves, leaf_nodes, res, sub_batches
                    )
                    try:
                        out_val, extras = centry.fn(
                            leaf_args, sub_args, dyn_args
                        )
                    except _TRACE_ERRORS:
                        out_val, extras = None, ()
                    if out_val is not None and centry.ordinal is not None:
                        self._cache[ckey] = centry
                        self.stats["compiles"] += 1
                else:
                    self.stats["hits"] += 1
                    out_val, extras = centry.fn(leaf_args, sub_args, dyn_args)
                jnode = (
                    ctx.checks[centry.ordinal][0]
                    if centry is not None and centry.ordinal is not None
                    else pending[0]
                )
                if out_val is None or centry.ordinal is None:
                    forced.add(id(jnode))
                    self.stats["joins_demoted"] += 1
                    demoted = True
                    break
                out_rows = int(out_val)
                bucket = 128
                while bucket < out_rows:
                    bucket *= 2
                if bucket > (1 << 26):  # HBM guard on the counted size
                    forced.add(id(jnode))
                    self.stats["joins_demoted"] += 1
                    demoted = True
                    break
                res[id(jnode)] = ("E", bucket)
                if extras:
                    xfers_by_ord[centry.ordinal] = extras
                self.stats["joins_counted"] += 1
            if not demoted:
                break

        sides = tuple(res[id(j)] for j, _, _ in ctx.checks)
        xfer_ords = tuple(sorted(xfers_by_ord))
        xfer_args = tuple(xfers_by_ord[o] for o in xfer_ords)
        key = (key_body, leaf_sigs, sub_sigs, sides, xfer_ords)
        entry = self._cache.get(key)

        if entry is None:
            entry = _Entry(plan, leaves)
            entry.leaf_ids = frozenset(map(id, leaf_nodes))
            entry.res = res
            entry.dyn_exprs = list(ctx.dyn_exprs)
            entry.sub_exprs = list(ctx.sub_exprs)
            entry.sub_batches = sub_batches  # dict/schema refs for tracing
            entry.xfer_ords = xfer_ords
            entry.check_nodes = [j for j, _, _ in ctx.checks]

            @jax.jit
            def fn(args, subs, dyn, xfer):
                tables = [
                    _TTable(
                        schema=b.schema,
                        cols=[
                            Column(d, v, c.dtype, c.dictionary)
                            for d, v, c in zip(a["d"], a["v"], b.columns)
                        ],
                        sel=K.live_mask(b.capacity, a["n"]),
                        capacity=b.capacity,
                        dense=True,
                        bounds=[
                            (None if (bb := _bucket_bounds(_col_bounds(c))) is None
                             or bb == ("big",) else bb)
                            for c in b.columns
                        ],
                    )
                    for a, b in zip(args, entry.leaves)
                ]
                it = iter(tables)
                ev = self.executor.evaluator
                ev._dyn_literals = {
                    id(e): v for e, v in zip(entry.dyn_exprs, dyn)
                }
                sub_shims = {}
                for x, a, b in zip(entry.sub_exprs, subs, entry.sub_batches):
                    st = _TTable(
                        schema=b.schema,
                        cols=[
                            Column(d, v, c.dtype, c.dictionary)
                            for d, v, c in zip(a["d"], a["v"], b.columns)
                        ],
                        sel=K.live_mask(b.capacity, a["n"]),
                        capacity=b.capacity,
                        dense=True,
                        bounds=[None] * b.num_columns,
                    )
                    sub_shims[id(x.plan)] = _ShimBatch(st)
                ev._subplans = sub_shims
                self._xfer_by_node = {
                    id(entry.check_nodes[o]): x
                    for o, x in zip(entry.xfer_ords, xfer)
                }
                try:
                    t = self._trace(entry.plan, it, entry.leaf_ids, entry.res)
                finally:
                    ev._dyn_literals = None
                    ev._subplans = None
                    self._xfer_by_node = None
                if not entry.meta:
                    entry.meta.update(
                        schema=t.schema,
                        dtypes=[c.dtype for c in t.cols],
                        dicts=[c.dictionary for c in t.cols],
                        capacity=t.capacity,
                        dense=t.dense,
                    )
                count = K.filter_count(t.sel, t.sel)
                return (
                    tuple(c.data for c in t.cols),
                    tuple(c.validity for c in t.cols),
                    t.sel,
                    count,
                )

            entry.fn = fn
            try:
                out = fn(leaf_args, sub_args, dyn_args, xfer_args)
            except _TRACE_ERRORS:
                self._eager_bodies.add(key_body)
                self.stats["fallbacks"] += 1
                return None
            self._cache[key] = entry
            self.stats["compiles"] += 1
        else:
            self.stats["hits"] += 1
            out = entry.fn(leaf_args, sub_args, dyn_args, xfer_args)

        datas, valids, sel, count = out
        count = int(count)
        meta = entry.meta
        if meta["dense"]:
            cols = [
                Column(d, v, dt, dic)
                for d, v, dt, dic in zip(
                    datas, valids, meta["dtypes"], meta["dicts"]
                )
            ]
            return ColumnBatch(meta["schema"], cols, count)
        # surviving rows are scattered: one compaction program
        out_cap = padded_capacity(count)
        ckey = (
            meta["capacity"], out_cap, tuple(str(d.dtype) for d in datas)
        )
        compact = self._compact_cache.get(ckey)
        if compact is None:

            @jax.jit
            def compact(datas, valids, sel):
                idx = K.compaction_indices(sel, sel, out_cap)
                # validity bits pack into shared words even without bounds
                return K.gather_columns_packed(
                    list(datas), list(valids), [None] * len(datas), idx
                )

            self._compact_cache[ckey] = compact
        cd, cv = compact(datas, valids, sel)
        cols = [
            Column(d, v, dt, dic)
            for d, v, dt, dic in zip(cd, cv, meta["dtypes"], meta["dicts"])
        ]
        return ColumnBatch(meta["schema"], cols, count)

    # ---- segment analysis --------------------------------------------------
    def _child(self, plan, ctx):
        """Key a child subtree; an unsupported child becomes a leaf boundary
        (executed eagerly) instead of abandoning the segment above it."""
        cp_checks, cp_dyn = len(ctx.checks), len(ctx.dyn_vals)
        cp_sub = len(ctx.sub_exprs)
        try:
            return self._plan_key(plan, ctx)
        except _Unsupported:
            # drop state collected by the failed subtree: phantom dyn
            # literals / subplans would misalign against the key's slots
            del ctx.checks[cp_checks:]
            del ctx.dyn_vals[cp_dyn:]
            del ctx.dyn_ids[cp_dyn:]
            del ctx.dyn_exprs[cp_dyn:]
            del ctx.sub_exprs[cp_sub:]
            return ("leaf",), [plan], 0

    def _build_count_entry(self, plan, ctx, leaves, leaf_nodes, res,
                           sub_batches):
        """Build the COUNT program for the first size-unresolved join in
        trace order: traces the same segment body as the emit program, but
        the counted join raises _CountReady with its traced output size —
        the program returns that one scalar. Entry is cached alongside emit
        programs, so steady state is 2 dispatches per unbounded join."""
        entry = _Entry(plan, leaves)
        entry.leaf_ids = frozenset(map(id, leaf_nodes))
        entry.res = dict(res)
        entry.dyn_exprs = list(ctx.dyn_exprs)
        entry.sub_exprs = list(ctx.sub_exprs)
        entry.sub_batches = sub_batches
        checks = list(ctx.checks)

        @jax.jit
        def fn(args, subs, dyn):
            tables = [
                _TTable(
                    schema=b.schema,
                    cols=[
                        Column(d, v, c.dtype, c.dictionary)
                        for d, v, c in zip(a["d"], a["v"], b.columns)
                    ],
                    sel=K.live_mask(b.capacity, a["n"]),
                    capacity=b.capacity,
                    dense=True,
                    bounds=[
                        (None if (bb := _bucket_bounds(_col_bounds(c))) is None
                         or bb == ("big",) else bb)
                        for c in b.columns
                    ],
                )
                for a, b in zip(args, entry.leaves)
            ]
            it = iter(tables)
            ev = self.executor.evaluator
            ev._dyn_literals = {
                id(e): v for e, v in zip(entry.dyn_exprs, dyn)
            }
            sub_shims = {}
            for x, a, b in zip(entry.sub_exprs, subs, entry.sub_batches):
                st = _TTable(
                    schema=b.schema,
                    cols=[
                        Column(d, v, c.dtype, c.dictionary)
                        for d, v, c in zip(a["d"], a["v"], b.columns)
                    ],
                    sel=K.live_mask(b.capacity, a["n"]),
                    capacity=b.capacity,
                    dense=True,
                    bounds=[None] * b.num_columns,
                )
                sub_shims[id(x.plan)] = _ShimBatch(st)
            ev._subplans = sub_shims
            try:
                self._trace(entry.plan, it, entry.leaf_ids, entry.res)
            except _CountReady as e:
                if entry.ordinal is None:
                    for i, (j, _, _) in enumerate(checks):
                        if j is e.node:
                            entry.ordinal = i
                            break
                # extras: sorted-space planes the emit program reuses
                return e.count, tuple(e.extras)
            finally:
                ev._dyn_literals = None
                ev._subplans = None
            raise _Unsupported("no counted join reached in trace")

        entry.fn = fn
        return entry

    def _plan_key(self, plan, ctx):
        """Validate + build the structural cache key; returns (body, leaf
        plan nodes in trace order, #compute nodes). Raises _Unsupported when
        this node cannot live inside a compiled segment."""
        if isinstance(plan, pp.PScan):
            return ("leaf",), [plan], 0
        if id(plan) in ctx.forced:
            raise _Unsupported("forced boundary")
        if isinstance(plan, pp.PHashJoin):
            return self._plan_key_join(plan, ctx)
        if isinstance(plan, pp.PFilter):
            if not _expr_traceable(plan.predicate):
                raise _Unsupported("filter predicate")
            body, leaves, n = self._child(plan.input, ctx)
            _mark_static_literals(plan.predicate, ctx.static_ids)
            return (
                ("filter", _expr_key(plan.predicate, ctx), body),
                leaves, n + 1,
            )
        if isinstance(plan, pp.PProjection):
            if not all(_expr_traceable(e) for e in plan.exprs):
                raise _Unsupported("projection exprs")
            body, leaves, n = self._child(plan.input, ctx)
            trivial = all(
                isinstance(e, lp.ColumnRef)
                or (isinstance(e, lp.AliasExpr) and isinstance(e.expr, lp.ColumnRef))
                for e in plan.exprs
            )
            for e in plan.exprs:
                _mark_static_literals(e, ctx.static_ids)
            return (
                ("proj", tuple(_expr_key(e, ctx) for e in plan.exprs), body),
                leaves,
                n if trivial else n + 1,
            )
        if isinstance(plan, pp.PSort):
            if not all(_expr_traceable(k.expr) for k in plan.keys):
                raise _Unsupported("sort keys")
            body, leaves, n = self._child(plan.input, ctx)
            for k in plan.keys:
                _mark_static_literals(k.expr, ctx.static_ids)
            return (
                ("sort", tuple(_sort_key_key(k, ctx) for k in plan.keys), body),
                leaves, n + 1,
            )
        if isinstance(plan, pp.PLimit):
            body, leaves, n = self._child(plan.input, ctx)
            return ("limit", plan.skip, plan.fetch, body), leaves, n
        if isinstance(plan, pp.PDistinct):
            on = plan.on
            if on is not None and not all(_expr_traceable(e) for e in on):
                raise _Unsupported("distinct exprs")
            body, leaves, n = self._child(plan.input, ctx)
            if on is not None:
                for e in on:
                    _mark_static_literals(e, ctx.static_ids)
            okey = None if on is None else tuple(_expr_key(e, ctx) for e in on)
            return ("distinct", okey, body), leaves, n + 1
        if isinstance(plan, pp.PWindow):
            if not all(_expr_traceable(w) for w in plan.window_exprs):
                raise _Unsupported("window exprs")
            body, leaves, n = self._child(plan.input, ctx)
            for w in plan.window_exprs:
                _mark_static_literals(w, ctx.static_ids)
            return (
                (
                    "window",
                    tuple(_expr_key(w, ctx) for w in plan.window_exprs),
                    tuple(plan.names),
                    body,
                ),
                leaves, n + 1,
            )
        if isinstance(plan, pp.PHashAggregate):
            if plan.mode != "single":
                raise _Unsupported("distributed aggregate mode")
            if any(a.func in lp.ORDERED_SET_FNS
                   or a.func in (lp.AggFunc.STRING_AGG, lp.AggFunc.ARRAY_AGG)
                   for a in plan.agg_exprs):
                # sort-based quantiles run in the eager engine (an eager
                # leaf here); a traced segment-percentile is future work
                raise _Unsupported("percentile aggregate")
            exprs = list(plan.group_exprs) + [
                a.expr for a in plan.agg_exprs if a.expr is not None
            ]
            if not all(_expr_traceable(e) for e in exprs):
                raise _Unsupported("aggregate exprs")
            body, leaves, n = self._child(plan.input, ctx)
            for e in exprs:
                _mark_static_literals(e, ctx.static_ids)
            # group-space count->emit: group keys that can't carry static
            # ranges (computed expressions, floats) would otherwise run
            # every downstream plane at ROW capacity. Register a count
            # check: a cached COUNT program returns ng once, and the emit
            # program aggregates at padded(ng).
            if plan.group_exprs and self._agg_needs_count(plan):
                ctx.checks.append((plan, "AGG", None))
            return (
                (
                    "agg",
                    tuple(_expr_key(g, ctx) for g in plan.group_exprs),
                    tuple(
                        (a.func.value, a.distinct,
                         None if a.expr is None else _expr_key(a.expr, ctx))
                        for a in plan.agg_exprs
                    ),
                    tuple(plan.schema().names()),
                    body,
                ),
                leaves, n + 1,
            )
        if isinstance(plan, pp.PSubquery):
            if plan.shared:
                # multiply-referenced WITH query: a leaf boundary so the
                # executor materializes it ONCE and every reference (this
                # segment, other segments, subquery expressions) reuses the
                # same batch
                raise _Unsupported("shared CTE (materialized once)")
            body, leaves, n = self._child(plan.input, ctx)
            return ("subq", tuple(plan.out_schema.names()), body), leaves, n
        if isinstance(plan, pp.PSetOp):
            lbody, lleaves, ln = self._child(plan.left, ctx)
            rbody, rleaves, rn = self._child(plan.right, ctx)
            return (
                ("setop", plan.kind.value, lbody, rbody),
                lleaves + rleaves, ln + rn + 1,
            )
        # anything else: eager leaf boundary (index scan, values, ...)
        raise _Unsupported(type(plan).__name__)

    @staticmethod
    def _agg_needs_count(plan: pp.PHashAggregate) -> bool:
        """Static proxy for 'this aggregate will land in the S=capacity
        sort-based grouping branch': some group key is not a bare
        integer/bool/dictionary column (whose leaf stats/dict sizes give
        static ranges). Conservative both ways — a spurious check costs
        one cached count dispatch; a miss keeps the status-quo S=cap."""
        for g in plan.group_exprs:
            e = g
            while isinstance(e, lp.AliasExpr):
                e = e.expr
            if not isinstance(e, lp.ColumnRef):
                return True
            if e.dtype.is_dictionary:
                continue
            dt = e.dtype.device_dtype
            if not (np.issubdtype(dt, np.integer) or dt == np.bool_):
                return True
        return False

    def _plan_key_join(self, plan: pp.PHashJoin, ctx):
        """A join joins the segment when one side's key multiplicity is
        statically bounded: with max-dup d on the build side the emit size
        is <= d * probe rows — a static capacity, so no count sync is
        needed (d == 1 is the unique/FK case). The bound comes from a GROUP
        BY above the key (structural, d=1) or a cached multiplicity stat on
        the leaf column (valid under the filters/sorts/limits between leaf
        and join — subsets only shrink multiplicities). Joins with no
        bounded side (d > 16 or unknown provenance) are demoted to eager
        leaves by the try_execute loop (the segment above still compiles).
        """
        if plan.join_type is lp.JoinType.CROSS or not plan.key_pairs:
            raise _Unsupported("cross join")
        for le, re_ in plan.key_pairs:
            if not (_expr_traceable(le) and _expr_traceable(re_)):
                raise _Unsupported("join key exprs")
        if plan.residual is not None and not _expr_traceable(plan.residual):
            raise _Unsupported("join residual")
        lprov = self._unique_prov_multi(
            plan.left, [le for le, _ in plan.key_pairs], ctx
        )
        rprov = self._unique_prov_multi(
            plan.right, [re_ for _, re_ in plan.key_pairs], ctx
        )
        if lprov is None and rprov is None:
            raise _Unsupported("no statically bounded join side")
        lbody, lleaves, ln = self._child(plan.left, ctx)
        rbody, rleaves, rn = self._child(plan.right, ctx)
        ctx.checks.append((plan, lprov, rprov))
        for le, re_ in plan.key_pairs:
            _mark_static_literals(le, ctx.static_ids)
            _mark_static_literals(re_, ctx.static_ids)
        if plan.residual is not None:
            _mark_static_literals(plan.residual, ctx.static_ids)
        body = (
            "join", plan.join_type.value,
            tuple(
                (_expr_key(le, ctx), _expr_key(re_, ctx))
                for le, re_ in plan.key_pairs
            ),
            None if plan.residual is None else _expr_key(plan.residual, ctx),
            tuple(plan.out_schema.names()),
            lbody, rbody,
        )
        return body, lleaves + rleaves, ln + rn + 1

    def _unique_prov_multi(self, plan, key_exprs, ctx):
        """Provenance for a key TUPLE: structurally unique when the keys
        are exactly a child aggregate's group columns; otherwise a stat
        check when all keys trace to columns of ONE materialized node."""
        if len(key_exprs) == 1:
            return self._unique_prov(plan, key_exprs[0], ctx)
        provs = [self._unique_prov(plan, k, ctx) for k in key_exprs]
        if any(p is None for p in provs):
            # tuple-level structural check: keys cover all group columns of
            # a single-aggregate child
            idxs = []
            for k in key_exprs:
                e = k
                while isinstance(e, lp.AliasExpr):
                    e = e.expr
                if not isinstance(e, lp.ColumnRef):
                    return None
                idxs.append(e.index)
            node = plan
            while isinstance(node, (pp.PFilter, pp.PSort, pp.PLimit,
                                    pp.PDistinct, pp.PSubquery)):
                node = node.input
            if (
                isinstance(node, pp.PHashAggregate)
                and node.mode == "single"
                and sorted(idxs) == list(range(len(node.group_exprs)))
            ):
                return ("unique",)
            return None
        if any(p[0] == "unique" for p in provs):
            return ("unique",)  # any singly-unique key makes the tuple unique
        if any(p[0] != "stat" for p in provs):
            return None
        nodes = {id(p[1]) for p in provs}
        if len(nodes) != 1:
            return None
        return ("stat_multi", provs[0][1], tuple(p[2] for p in provs))



    def _unique_prov(self, plan, key_expr, ctx):
        """Provenance of a join-key expr: ("unique",) if unique by
        construction, ("stat", node, col_idx) to check a materialized batch
        column, ("via_join", node, side, inner) for columns flowing through
        an in-segment join, or None (unknown)."""
        e = key_expr
        while isinstance(e, lp.AliasExpr):
            e = e.expr
        if not isinstance(e, lp.ColumnRef):
            return None
        return self._unique_prov_idx(plan, e.index, ctx)

    def _unique_prov_idx(self, plan, idx, ctx):
        node = plan
        while True:
            if id(node) in ctx.forced:
                return ("stat", node, idx)
            if isinstance(node, pp.PScan):
                return ("stat", node, idx)
            if isinstance(node, (pp.PFilter, pp.PSort, pp.PLimit,
                                 pp.PDistinct, pp.PSubquery)):
                node = node.input
                continue
            if isinstance(node, pp.PWindow):
                if idx >= len(node.input.schema()):
                    return None
                node = node.input
                continue
            if isinstance(node, pp.PProjection):
                pe = node.exprs[idx]
                while isinstance(pe, lp.AliasExpr):
                    pe = pe.expr
                if not isinstance(pe, lp.ColumnRef):
                    return None
                node, idx = node.input, pe.index
                continue
            if isinstance(node, pp.PHashAggregate):
                if (node.mode == "single" and len(node.group_exprs) == 1
                        and idx == 0):
                    return ("unique",)
                return None
            if isinstance(node, pp.PHashJoin) and id(node) not in ctx.forced:
                # through an in-segment join: a column from side X gains a
                # multiplicity factor equal to the OTHER side's key dup —
                # known when the child join resolved its bounded side to X's
                # opposite. Child checks precede the parent's in ctx.checks,
                # so its resolution is available at our resolution time.
                n_left = len(node.left.schema())
                if idx < n_left:
                    inner = self._unique_prov_idx(node.left, idx, ctx)
                    return ("via_join", node, "L", inner)
                inner = self._unique_prov_idx(node.right, idx - n_left, ctx)
                return ("via_join", node, "R", inner)
            # opaque boundary (set-op, forced join, ...): stat on its batch
            return ("stat", node, idx)

    def _prov_max_dup(self, prov, batch_by_node, res=None):
        """-> max key multiplicity for this provenance, or None."""
        if prov is None:
            return None
        if prov[0] == "unique":
            return 1
        if prov[0] == "via_join":
            _, jnode, side, inner = prov
            d = self._prov_max_dup(inner, batch_by_node, res)
            if d is None:
                return None
            r = (res or {}).get(id(jnode))
            if r is None or r[0] not in ("L", "R"):
                return None  # child join demoted / counted-not-bounded
            bounded_side, bdup = r
            # each row of side X appears <= (other side's key dup) times;
            # known only when the child's bounded side IS the other side
            if bounded_side == side:
                return None
            return d * bdup
        if prov[0] == "stat_multi":
            _, node, idxs = prov
            b = self._prov_batch(node, batch_by_node)
            if b is None or any(i >= b.num_columns for i in idxs):
                return None
            return _cols_max_dup(b, list(idxs))
        _, node, idx = prov
        b = self._prov_batch(node, batch_by_node)
        if b is None or idx >= b.num_columns:
            return None
        return _col_max_dup(b.columns[idx], b.num_rows)

    def _prov_batch(self, node, batch_by_node):
        b = batch_by_node.get(id(node))
        if b is None and isinstance(node, pp.PScan):
            b = self._materialize_leaf(node)  # cheap: stored batch
        return b

    def _materialize_leaf(self, node) -> ColumnBatch:
        if isinstance(node, pp.PScan):
            return self.executor._exec_scan(node)
        return self.executor.execute(node)

    @staticmethod
    def _leaf_sig(b: ColumnBatch):
        return (
            b.capacity,
            tuple(b.schema.names()),
            tuple(str(np.dtype(c.data.dtype)) for c in b.columns),
            tuple(
                None if c.dictionary is None else id(c.dictionary)
                for c in b.columns
            ),
            # integer-column bounds are baked into direct-grouping programs
            tuple(_bucket_bounds(_col_bounds(c)) for c in b.columns),
        )

    # ---- tracing -----------------------------------------------------------
    def _trace(self, plan, tables, leaf_ids=frozenset(), res=None) -> _TTable:
        if isinstance(plan, pp.PScan) or id(plan) in leaf_ids:
            # segment leaf: a table scan, or a subtree the segment analysis
            # designated as an eager boundary (join, subquery filter, ...)
            return next(tables)
        if isinstance(plan, pp.PFilter):
            t = self._trace(plan.input, tables, leaf_ids, res)
            mask = self.executor.evaluator.eval_predicate_mask(
                plan.predicate, _ShimBatch(t)
            )
            return _TTable(t.schema, t.cols, t.sel & mask, t.capacity,
                           False, t.bounds)
        if isinstance(plan, pp.PProjection):
            t = self._trace(plan.input, tables, leaf_ids, res)
            shim = _ShimBatch(t)
            schema = plan.schema()
            cols = []
            for e, f in zip(plan.exprs, schema):
                v = self.executor.evaluator.eval(e, shim)
                cols.append(Column(v.data, v.validity, f.data_type, v.dictionary))
            bounds = [_proj_bounds(e, t) for e in plan.exprs]
            return _TTable(schema, cols, t.sel, t.capacity, t.dense, bounds)
        if isinstance(plan, pp.PSort):
            return self._trace_sort(plan, tables, leaf_ids, res)
        if isinstance(plan, pp.PLimit):
            if isinstance(plan.input, pp.PSort) and plan.fetch is not None:
                return self._trace_topk(plan, tables, leaf_ids, res)
            t = self._trace(plan.input, tables, leaf_ids, res)
            rank = jnp.cumsum(t.sel.astype(jnp.int32)) - 1
            sel = t.sel
            if plan.skip:
                sel = sel & (rank >= plan.skip)
            if plan.fetch is not None:
                sel = sel & (rank < plan.skip + plan.fetch)
            dense = t.dense and plan.skip == 0
            return _TTable(t.schema, t.cols, sel, t.capacity, dense,
                           t.bounds)
        if isinstance(plan, pp.PDistinct):
            return self._trace_distinct(plan, tables, leaf_ids, res)
        if isinstance(plan, pp.PWindow):
            return self._trace_window(plan, tables, leaf_ids, res)
        if isinstance(plan, pp.PHashAggregate):
            return self._trace_aggregate(plan, tables, leaf_ids, res)
        if isinstance(plan, pp.PHashJoin):
            return self._trace_join(plan, tables, leaf_ids, res)
        if isinstance(plan, pp.PSetOp):
            return self._trace_setop(plan, tables, leaf_ids, res)
        if isinstance(plan, pp.PSubquery):
            t = self._trace(plan.input, tables, leaf_ids, res)
            return _TTable(plan.out_schema, t.cols, t.sel, t.capacity,
                           t.dense, t.bounds)
        raise _Unsupported(type(plan).__name__)

    def _trace_join(self, plan: pp.PHashJoin, tables, leaf_ids, res) -> _TTable:
        """Equi-join with a statically unique side: the emit capacity is the
        probe side's capacity (unique build => <=1 match per probe row), so
        ranks, counts, emit, and gather all trace into the enclosing program
        — no count sync. Semantics mirror the eager executor's two-pass
        sort-merge join (engine/executor.py _exec_join; the claimed hash-join
        behavior the reference stubs at executor.rs:363-435)."""
        ex = self.executor
        self.stats["joins_inlined"] += 1
        lt = self._trace(plan.left, tables, leaf_ids, res)
        rt = self._trace(plan.right, tables, leaf_ids, res)
        resolution = (res or {}).get(id(plan))
        if resolution is None:
            raise _Unsupported("join resolution missing")
        side, dup = resolution
        jt = plan.join_type
        cap_l, cap_r = lt.capacity, rt.capacity
        # outer join with a residual ON condition: matched-ness means "has
        # an equi pair SURVIVING the residual" — evaluated on the emitted
        # inner pairs, with NULL-padded outer blocks recomputed from the
        # survivors (PG ON semantics; TPC-H Q13's LEFT JOIN ... AND NOT
        # LIKE). The eager oracle is executor._exec_outer_join_residual.
        residual_outer = (
            plan.residual is not None and jt is not lp.JoinType.INNER
        )

        if side == "E":
            # emit-capacity sync: the companion count program already told
            # the host the exact output size; dup is the pow2 bucket
            out_cap = dup
        else:
            # static emit bound: each probe-side row contributes
            # <= max(dup, 1) outputs (its matches, or its single outer-pad
            # row), so probe_cap * dup covers INNER plus the probe side's
            # outer rows; outer rows from the BOUNDED side need their own
            # slots on top. ("C" = count mode: out_cap unused.)
            probe_cap = cap_l if side == "R" else cap_r
            out_cap = probe_cap * (dup or 1)
            if side == "R" and jt in (lp.JoinType.RIGHT, lp.JoinType.FULL):
                out_cap += cap_r
            if side == "L" and jt in (lp.JoinType.LEFT, lp.JoinType.FULL):
                out_cap += cap_l
            if residual_outer:
                # probe-side pads need their own slots: a probe row whose
                # equi pairs ALL fail the residual occupies its (dead)
                # inner slots AND one pad row
                if side == "R" and jt in (lp.JoinType.LEFT, lp.JoinType.FULL):
                    out_cap += cap_l
                if side == "L" and jt in (lp.JoinType.RIGHT, lp.JoinType.FULL):
                    out_cap += cap_r

        from query_engine_tpu.engine.expr_eval import unify_dicts

        lkeys, rkeys = [], []
        for le, re_ in plan.key_pairs:
            lv = ex.evaluator.eval(le, _ShimBatch(lt))
            rv = ex.evaluator.eval(re_, _ShimBatch(rt))
            if lv.dictionary is not None or rv.dictionary is not None:
                lv, rv = unify_dicts(lv, rv)
            lkeys.append((lv.data, lv.validity))
            rkeys.append((rv.data, rv.validity))

        # direct ranks when the single key's value range is statically
        # bounded (dictionary codes or int min/max stats): rank = key - lo,
        # skipping join_ranks' joint sort entirely
        n_ranks = None
        lr = rr = None
        if len(plan.key_pairs) == 1:
            n_ranks, lr, rr = self._direct_join_ranks(
                plan, lkeys[0], rkeys[0], lt, rt
            )

        if side == "C":
            # count pass (emit-capacity sync): surface the total output
            # size to the host. Sorted path: join_count_total works
            # entirely in sorted space — no rank scatter, no count gather
            # (the count program costs ~the joint sort alone).
            if n_ranks is None:
                total, ml, mr, space = K.join_count_total(
                    lkeys, rkeys, lt.sel, rt.sel, return_space=True
                )
                out_rows = total
                if jt in (lp.JoinType.LEFT, lp.JoinType.FULL):
                    # with a residual, rows whose every equi pair fails it
                    # also pad — the count pass cannot evaluate the residual
                    # (no pair columns in sorted space), so bound by ALL
                    # live rows instead of just the equi-unmatched
                    out_rows = out_rows + (
                        jnp.sum(lt.sel.astype(jnp.int64))
                        - (0 if residual_outer else ml)
                    )
                if jt in (lp.JoinType.RIGHT, lp.JoinType.FULL):
                    out_rows = out_rows + (
                        jnp.sum(rt.sel.astype(jnp.int64))
                        - (0 if residual_outer else mr)
                    )
                raise _CountReady(plan, out_rows, extras=space)
            total, _, _, _, _, lm_c, rm_c = K.join_counts(
                lr, rr, lt.sel, rt.sel
            )
            out_rows = total
            if jt in (lp.JoinType.LEFT, lp.JoinType.FULL):
                out_rows = out_rows + jnp.sum(
                    ((jnp.ones_like(lm_c) if residual_outer else ~lm_c)
                     & lt.sel).astype(jnp.int64)
                )
            if jt in (lp.JoinType.RIGHT, lp.JoinType.FULL):
                out_rows = out_rows + jnp.sum(
                    ((jnp.ones_like(rm_c) if residual_outer else ~rm_c)
                     & rt.sel).astype(jnp.int64)
                )
            raise _CountReady(plan, out_rows)

        fk_r = dup == 1 and side == "R" and jt in (
            lp.JoinType.INNER, lp.JoinType.LEFT,
        )
        fk_l = dup == 1 and side == "L" and jt in (
            lp.JoinType.INNER, lp.JoinType.RIGHT,
        )
        if n_ranks is None and (fk_r or fk_l):
            # the FK fast paths need row-order ranks only
            lr, rr = K.join_ranks(lkeys, rkeys, lt.sel, rt.sel)

        if fk_l:
            # mirrored FK fast path: the UNIQUE side is the LEFT (the
            # dim ⋈ fact / TPC-H Q3 orders ⋈ lineitem shape): <=1 match
            # per RIGHT row, so left columns gather by the right rows'
            # ranks and the right planes pass through untouched — no
            # join_counts, no emit, no right-side packed gather.
            ld = [c.data for c in lt.cols]
            lvs = [c.validity for c in lt.cols]
            nl_eff = n_ranks if n_ranks is not None else cap_l + cap_r
            fused = K.fk_gather_by_rank(
                ld, lvs, _gather_bounds(lt), lr,
                K.live_mask(cap_l, lt.sel), rr,
                K.live_mask(cap_r, rt.sel), nl_eff,
            )
            if fused is not None:
                gl_d, gl_v, matched = fused
            else:
                li, matched = K.fk_join_right_lookup(
                    rr, lr, rt.sel, lt.sel, n_ranks
                )
                gl_d, gl_v = K.gather_columns_packed(
                    ld, lvs, _gather_bounds(lt), li, matched,
                )
            cols = [
                Column(d, v, c.dtype, c.dictionary)
                for d, v, c in zip(gl_d, gl_v, lt.cols)
            ] + list(rt.cols)
            sel = rt.sel if jt is lp.JoinType.RIGHT else (rt.sel & matched)
            out = _TTable(plan.out_schema, cols, sel, cap_r, False,
                          lt.bounds + rt.bounds)
            if plan.residual is not None:
                mask = ex.evaluator.eval_predicate_mask(
                    plan.residual, _ShimBatch(out)
                )
                if jt is lp.JoinType.RIGHT:
                    # outer: a failing residual un-matches the pair — the
                    # right row stays, gathered LEFT planes go NULL
                    nlc = len(lt.cols)
                    cols2 = [
                        Column(c.data, c.validity & mask, c.dtype,
                               c.dictionary)
                        for c in out.cols[:nlc]
                    ] + list(out.cols[nlc:])
                    out = _TTable(out.schema, cols2, out.sel, cap_r,
                                  False, out.bounds)
                else:
                    out = _TTable(out.schema, out.cols, out.sel & mask,
                                  cap_r, False, out.bounds)
            return out

        if fk_r:
            # FK fast path: <=1 match per probe row -> direct rank lookup;
            # left planes pass through untouched, output rows keep their
            # left positions (identical order to the general left-major
            # emit after compaction)
            rd = [c.data for c in rt.cols]
            rvs = [c.validity for c in rt.cols]
            nr_eff = n_ranks if n_ranks is not None else cap_l + cap_r
            fused = K.fk_gather_by_rank(
                rd, rvs, _gather_bounds(rt), rr,
                K.live_mask(cap_r, rt.sel), lr,
                K.live_mask(cap_l, lt.sel), nr_eff,
            )
            if fused is not None:
                # one probe-length gather per word: rank -> packed columns
                gr_d, gr_v, matched = fused
            else:
                ri, matched = K.fk_join_right_lookup(
                    lr, rr, lt.sel, rt.sel, n_ranks
                )
                gr_d, gr_v = K.gather_columns_packed(
                    rd, rvs, _gather_bounds(rt), ri, matched,
                )
            cols = list(lt.cols) + [
                Column(d, v, c.dtype, c.dictionary)
                for d, v, c in zip(gr_d, gr_v, rt.cols)
            ]
            sel = lt.sel if jt is lp.JoinType.LEFT else (lt.sel & matched)
            out = _TTable(plan.out_schema, cols, sel, cap_l, False,
                          lt.bounds + rt.bounds)
            if plan.residual is not None:
                mask = ex.evaluator.eval_predicate_mask(
                    plan.residual, _ShimBatch(out)
                )
                if jt is lp.JoinType.LEFT:
                    # outer: a failing residual un-matches the pair — the
                    # left row stays, gathered RIGHT planes go NULL
                    nlc = len(lt.cols)
                    cols2 = list(out.cols[:nlc]) + [
                        Column(c.data, c.validity & mask, c.dtype,
                               c.dictionary)
                        for c in out.cols[nlc:]
                    ]
                    out = _TTable(out.schema, cols2, out.sel, cap_l,
                                  False, out.bounds)
                else:
                    out = _TTable(out.schema, out.cols, out.sel & mask,
                                  cap_l, False, out.bounds)
            return out

        if n_ranks is None:
            # fused general path: counts from sorted-space scans (no
            # rank-table gather; kernels.join_ranks_counts). A counted
            # join reuses the count program's sorted space (handed across
            # dispatches as device planes) and skips the joint sort.
            space = (self._xfer_by_node or {}).get(id(plan))
            if space is not None:
                self.stats["join_sorts_reused"] = (
                    self.stats.get("join_sorts_reused", 0) + 1
                )
            (lr, rr, total, counts, _off, rank_start, right_by_rank,
             lmatched, rmatched) = K.join_ranks_counts(
                lkeys, rkeys, lt.sel, rt.sel, space=space
            )
        else:
            (total, counts, _off, rank_start, right_by_rank,
             lmatched, rmatched) = K.join_counts(lr, rr, lt.sel, rt.sel)

        li, ri, valid = K.join_emit_inner(
            counts, rank_start, right_by_rank, lr, total, out_cap
        )
        lvalid = valid
        rvalid = valid
        keep = valid
        if residual_outer:
            # evaluate the residual on the emitted inner pairs BEFORE the
            # outer padding: gather only the columns the residual touches
            # (the full gather happens once, below, after pad indices are
            # merged in), then recompute matched-ness from the SURVIVORS
            refs = set()
            lp.walk_exprs(
                plan.residual,
                lambda x: refs.add(x.index)
                if isinstance(x, lp.ColumnRef) else None,
            )
            nlc = len(lt.cols)
            bl, br = _gather_bounds(lt), _gather_bounds(rt)
            l_sel = [i for i in sorted(refs) if i < nlc]
            r_sel = [i - nlc for i in sorted(refs) if i >= nlc]
            mini_cols = {}
            if l_sel:
                gd, gv = K.gather_columns_packed(
                    [lt.cols[i].data for i in l_sel],
                    [lt.cols[i].validity for i in l_sel],
                    [bl[i] for i in l_sel], li, valid,
                )
                for i, d, v in zip(l_sel, gd, gv):
                    mini_cols[i] = Column(
                        d, v, lt.cols[i].dtype, lt.cols[i].dictionary
                    )
            if r_sel:
                gd, gv = K.gather_columns_packed(
                    [rt.cols[i].data for i in r_sel],
                    [rt.cols[i].validity for i in r_sel],
                    [br[i] for i in r_sel], ri, valid,
                )
                for i, d, v in zip(r_sel, gd, gv):
                    mini_cols[i + nlc] = Column(
                        d, v, rt.cols[i].dtype, rt.cols[i].dictionary
                    )
            all_cols = [
                mini_cols.get(i, Column(
                    jnp.zeros(out_cap, jnp.int32),
                    jnp.zeros(out_cap, bool), f.data_type, None,
                ))
                for i, f in enumerate(plan.out_schema)
            ]
            mini = _TTable(plan.out_schema, all_cols, valid, out_cap, True,
                           [None] * len(all_cols))
            keep = valid & ex.evaluator.eval_predicate_mask(
                plan.residual, _ShimBatch(mini)
            )
            ki = keep.astype(jnp.int32)
            lmatched = (
                jnp.zeros(cap_l + 1, jnp.int32)
                .at[jnp.where(keep, li, cap_l)].max(ki)[:cap_l] > 0
            )
            rmatched = (
                jnp.zeros(cap_r + 1, jnp.int32)
                .at[jnp.where(keep, ri, cap_r)].max(ki)[:cap_r] > 0
            )
        pos = jnp.arange(out_cap, dtype=jnp.int64)
        pad_mask = jnp.zeros(out_cap, dtype=bool)
        extra_l = jnp.int64(0)
        extra_r = jnp.int64(0)
        if jt in (lp.JoinType.LEFT, lp.JoinType.FULL):
            um_l = ~lmatched & lt.sel
            extra_l = jnp.sum(um_l.astype(jnp.int64))
            ul_idx = K.compaction_indices(um_l, um_l, out_cap)
            in_l = (pos >= total) & (pos < total + extra_l)
            sel_i = jnp.clip(pos - total, 0, out_cap - 1)
            li = jnp.where(in_l, ul_idx[sel_i], li)
            lvalid = lvalid | in_l
            valid = valid | in_l
            pad_mask = pad_mask | in_l
        if jt in (lp.JoinType.RIGHT, lp.JoinType.FULL):
            um_r = ~rmatched & rt.sel
            extra_r = jnp.sum(um_r.astype(jnp.int64))
            ur_idx = K.compaction_indices(um_r, um_r, out_cap)
            start = total + extra_l
            in_r = (pos >= start) & (pos < start + extra_r)
            sel_i = jnp.clip(pos - start, 0, out_cap - 1)
            ri = jnp.where(in_r, ur_idx[sel_i], ri)
            rvalid = rvalid | in_r
            valid = valid | in_r
            pad_mask = pad_mask | in_r

        out_rows = total + extra_l + extra_r
        ld = [c.data for c in lt.cols]
        lvs = [c.validity for c in lt.cols]
        rd = [c.data for c in rt.cols]
        rvs = [c.validity for c in rt.cols]
        gl_d, gl_v = K.gather_columns_packed(
            ld, lvs, _gather_bounds(lt), li, lvalid
        )
        gr_d, gr_v = K.gather_columns_packed(
            rd, rvs, _gather_bounds(rt), ri, rvalid
        )
        cols = [
            Column(d, v, c.dtype, c.dictionary)
            for d, v, c in zip(gl_d + gr_d, gl_v + gr_v,
                               list(lt.cols) + list(rt.cols))
        ]
        # residual_outer: surviving inner pairs + the pad blocks; otherwise
        # every emitted row up to out_rows is live. NOTE the residual_outer
        # sel has HOLES (equi pairs the residual rejected), so the table is
        # NOT dense — the root assembly must compact, not slice by count.
        sel = (keep | pad_mask) if residual_outer else (pos < out_rows)
        # gathered columns keep their source value covers
        out = _TTable(plan.out_schema, cols, sel, out_cap,
                      not residual_outer, lt.bounds + rt.bounds)
        if plan.residual is not None and not residual_outer:
            mask = ex.evaluator.eval_predicate_mask(
                plan.residual, _ShimBatch(out)
            )
            out = _TTable(out.schema, out.cols, out.sel & mask, out_cap,
                          False, out.bounds)
        return out

    def _trace_setop(self, plan: pp.PSetOp, tables, leaf_ids, res) -> _TTable:
        """UNION [ALL]: plane concatenation at cap_l + cap_r (UNION's dedup
        is the Distinct node the planner adds above). INTERSECT/EXCEPT:
        membership mask on the left side (rank match, NULLs compare equal)
        then first-occurrence dedup — both pure mask refinements."""
        from query_engine_tpu.engine.expr_eval import unify_dicts, Val

        lt = self._trace(plan.left, tables, leaf_ids, res)
        rt = self._trace(plan.right, tables, leaf_ids, res)
        if plan.kind in (lp.SetOpKind.UNION, lp.SetOpKind.UNION_ALL):
            cols = []
            for lc, rc in zip(lt.cols, rt.cols):
                if lc.dictionary is not None or rc.dictionary is not None:
                    lv = Val(lc.data, lc.validity, lc.dtype, lc.dictionary)
                    rv = Val(rc.data, rc.validity, rc.dtype, rc.dictionary)
                    lv, rv = unify_dicts(lv, rv)
                    d = jnp.concatenate([lv.data, rv.data])
                    v = jnp.concatenate([lc.validity, rc.validity])
                    cols.append(Column(d, v, lc.dtype, lv.dictionary))
                else:
                    d = jnp.concatenate([lc.data, rc.data])
                    v = jnp.concatenate([lc.validity, rc.validity])
                    cols.append(Column(d, v, lc.dtype, None))
            sel = jnp.concatenate([lt.sel, rt.sel])
            return _TTable(
                lt.schema, cols, sel, lt.capacity + rt.capacity, False,
                [None] * len(cols),
            )
        # INTERSECT / EXCEPT: rank-match left rows against right rows
        lkeys, rkeys = [], []
        for lc, rc in zip(lt.cols, rt.cols):
            lv = Val(lc.data, lc.validity, lc.dtype, lc.dictionary)
            rv = Val(rc.data, rc.validity, rc.dtype, rc.dictionary)
            if lc.dictionary is not None or rc.dictionary is not None:
                lv, rv = unify_dicts(lv, rv)
            lkeys.append((lv.data, lv.validity))
            rkeys.append((rv.data, rv.validity))
        lr, rr = K.join_ranks(lkeys, rkeys, lt.sel, rt.sel, null_equal=True)
        member = K.rank_member(lr, rr, K.live_mask(rt.capacity, rt.sel))
        keep = member if plan.kind is lp.SetOpKind.INTERSECT else ~member
        sel = lt.sel & keep
        # set ops return distinct rows: keep first occurrence per key
        gid, ng, rep = K.group_ids(
            [k for k, _ in lkeys], [v for _, v in lkeys], sel
        )
        cap = lt.capacity
        first_mask = (
            jnp.zeros(cap, dtype=bool)
            .at[jnp.where(jnp.arange(cap) < ng, rep, cap)]
            .set(True, mode="drop")
        )
        return _TTable(lt.schema, lt.cols, sel & first_mask, cap, False,
                       lt.bounds)

    def _trace_topk(self, plan: pp.PLimit, tables, leaf_ids, res) -> _TTable:
        """ORDER BY ... LIMIT k: gather only the fetched window of the sort
        permutation (k rows per column) instead of materializing the whole
        sorted table — the window bounds are static plan fields."""
        sort_plan = plan.input
        t = self._trace(sort_plan.input, tables, leaf_ids, res)
        shim = _ShimBatch(t)
        datas, valids, ascs, nfs, kvals = [], [], [], [], []
        for k in sort_plan.keys:
            v = self.executor.evaluator.eval(k.expr, shim)
            kvals.append(v)
            datas.append(v.data)
            valids.append(v.validity)
            ascs.append(k.asc)
            nfs.append(k.resolved_nulls_first())
        perm = K.sort_permutation(
            datas, valids, ascs, nfs, t.sel,
            ranges=_key_ranges([k.expr for k in sort_plan.keys], kvals, t),
        )
        lo = min(plan.skip, t.capacity)
        hi = min(plan.skip + plan.fetch, t.capacity)
        wlen = hi - lo
        wcap = padded_capacity(max(wlen, 1))
        win = jnp.zeros(wcap, dtype=jnp.int32).at[:wlen].set(perm[lo:hi])
        n_live = jnp.sum(t.sel.astype(jnp.int32))
        # live rows pack to the front of the permutation: window position i
        # holds a live row iff lo + i < n_live (and i < wlen)
        sel = (jnp.arange(wcap, dtype=jnp.int32) + lo) < jnp.minimum(
            n_live, hi
        )
        cols = [
            Column(c.data[win], c.validity[win], c.dtype, c.dictionary)
            for c in t.cols
        ]
        return _TTable(t.schema, cols, sel, wcap, True, t.bounds)

    def _direct_join_ranks(self, plan, lkey, rkey, lt, rt):
        """(n_ranks, lr, rr) via rank = key - lo when the key range is
        statically bounded and fits the downstream rank space; (None, ..)
        otherwise. NULL keys get unique negative ranks (never match), same
        convention as join_ranks."""
        (ld, lv), (rd, rv) = lkey, rkey
        cap_l, cap_r = lt.capacity, rt.capacity
        if (
            jnp.issubdtype(ld.dtype, jnp.integer)
            and jnp.issubdtype(rd.dtype, jnp.integer)
        ):
            le, re_ = plan.key_pairs[0]
            bl = _proj_bounds(le, lt)
            br = _proj_bounds(re_, rt)
            if bl is None or br is None:
                return None, None, None
            lo = min(bl[0], br[0])
            hi = max(bl[0] + bl[1], br[0] + br[1])
            rng = hi - lo
            # downstream consumers size rank tables at cap_l + cap_r
            if rng > min(1 << 21, cap_l + cap_r):
                return None, None, None
            iota_l = jnp.arange(cap_l, dtype=jnp.int32)
            iota_r = jnp.arange(cap_r, dtype=jnp.int32)
            lr = jnp.where(
                lt.sel & lv, (ld - lo).astype(jnp.int32), -(iota_l + 2)
            )
            rr = jnp.where(
                rt.sel & rv, (rd - lo).astype(jnp.int32),
                -(iota_r + cap_l + 2),
            )
            return rng, lr, rr
        return None, None, None

    def _trace_sort(self, plan: pp.PSort, tables, leaf_ids, res) -> _TTable:
        t = self._trace(plan.input, tables, leaf_ids, res)
        shim = _ShimBatch(t)
        datas, valids, ascs, nfs, kvals = [], [], [], [], []
        for k in plan.keys:
            v = self.executor.evaluator.eval(k.expr, shim)
            kvals.append(v)
            datas.append(v.data)
            valids.append(v.validity)
            ascs.append(k.asc)
            nfs.append(k.resolved_nulls_first())
        perm = K.sort_permutation(
            datas, valids, ascs, nfs, t.sel,
            ranges=_key_ranges([k.expr for k in plan.keys], kvals, t),
        )
        n_live = jnp.sum(t.sel.astype(jnp.int32))
        g_d, g_v = K.gather_columns_packed(
            [c.data for c in t.cols], [c.validity for c in t.cols],
            _gather_bounds(t), perm,
        )
        cols = [
            Column(d, v, c.dtype, c.dictionary)
            for d, v, c in zip(g_d, g_v, t.cols)
        ]
        return _TTable(
            t.schema, cols, K.live_mask(t.capacity, n_live), t.capacity,
            True, t.bounds,
        )

    def _trace_distinct(self, plan: pp.PDistinct, tables, leaf_ids, res) -> _TTable:
        t = self._trace(plan.input, tables, leaf_ids, res)
        shim = _ShimBatch(t)
        if plan.on is not None:
            kvals = [self.executor.evaluator.eval(e, shim) for e in plan.on]
            kd = [v.data for v in kvals]
            kv = [v.validity for v in kvals]
        else:
            kd = [c.data for c in t.cols]
            kv = [c.validity for c in t.cols]
        gid, ng, rep = K.group_ids(kd, kv, t.sel)
        cap = t.capacity
        first_mask = (
            jnp.zeros(cap, dtype=bool)
            .at[jnp.where(jnp.arange(cap) < ng, rep, cap)]
            .set(True, mode="drop")
        )
        return _TTable(t.schema, t.cols, t.sel & first_mask, cap, False,
                       t.bounds)

    # ---- aggregate ---------------------------------------------------------
    def _fd_dependent_keys(self, plan, leaf_ids, res):
        """Group keys functionally dependent on other group keys through a
        unique-side equi-join — the TPC-H Q3 shape: GROUP BY l_orderkey,
        o_orderdate, o_shippriority where orders is unique on o_orderkey,
        so the o_* keys are determined by l_orderkey. Dropping them from
        the grouping-key set turns multi-key sort-based grouping into
        single-key direct/bucket grouping (sort-free when the key is
        bounded); their output values come from a representative row.

        Sound because: on the join's unique (dup=1) side, one key VALUE
        matches at most one build row, so every output column of that side
        is single-valued per probe-key value. Outer rows are safe only
        when the probe side is the outer side (their dependent columns are
        all-NULL, still single-valued per key) — hence the join-type gate.
        """
        exprs = plan.group_exprs
        if len(exprs) < 2 or not res:
            return frozenset()

        def unwrap(e):
            while isinstance(e, lp.AliasExpr):
                e = e.expr
            return e

        def resolve(node, idx):
            """-> (terminal node id, col idx, [(join, side) crossings])"""
            crossings = []
            while True:
                if id(node) in leaf_ids:
                    return (id(node), idx, crossings)
                if isinstance(node, (pp.PFilter, pp.PSort, pp.PLimit,
                                     pp.PDistinct, pp.PSubquery)):
                    node = node.input
                    continue
                if isinstance(node, pp.PProjection):
                    pe = unwrap(node.exprs[idx])
                    if not isinstance(pe, lp.ColumnRef):
                        return None
                    idx = pe.index
                    node = node.input
                    continue
                if isinstance(node, pp.PHashJoin):
                    n_left = len(node.left.schema())
                    if idx < n_left:
                        crossings.append((node, "L"))
                        node = node.left
                    else:
                        crossings.append((node, "R"))
                        idx -= n_left
                        node = node.right
                    continue
                return (id(node), idx, crossings)

        provs = []
        for e in exprs:
            ee = unwrap(e)
            provs.append(
                resolve(plan.input, ee.index)
                if isinstance(ee, lp.ColumnRef) else None
            )

        dep: set = set()
        joins = {}
        for p in provs:
            if p:
                for j, _s in p[2]:
                    joins[id(j)] = j
        for jid, J in joins.items():
            r = res.get(jid)
            if r is None or r[0] not in ("L", "R") or r[1] != 1:
                continue
            side_b = r[0]
            jt = J.join_type
            if not (
                jt is lp.JoinType.INNER
                or (jt is lp.JoinType.LEFT and side_b == "R")
                or (jt is lp.JoinType.RIGHT and side_b == "L")
            ):
                continue
            cand = [
                i for i, p in enumerate(provs)
                if p and any(j is J and s == side_b for j, s in p[2])
            ]
            if not cand:
                continue
            # every probe-side join key must be among the kept group keys
            probe_child = J.left if side_b == "R" else J.right
            probe_terms = []
            ok = True
            for le, re_ in J.key_pairs:
                pe = unwrap(le if side_b == "R" else re_)
                if not isinstance(pe, lp.ColumnRef):
                    ok = False
                    break
                term = resolve(probe_child, pe.index)
                if term is None:
                    ok = False
                    break
                probe_terms.append((term[0], term[1]))
            if not ok:
                continue
            kept_terms = {
                (p[0], p[1]) for i, p in enumerate(provs)
                if p and i not in cand and i not in dep
            }
            if all(t in kept_terms for t in probe_terms):
                dep.update(cand)
        if not dep or len(dep) >= len(exprs):
            return frozenset()
        return frozenset(dep)

    def _trace_aggregate(self, plan: pp.PHashAggregate, tables, leaf_ids, res) -> _TTable:
        ex = self.executor
        t = self._trace(plan.input, tables, leaf_ids, res)
        shim = _ShimBatch(t)
        cap = t.capacity
        sel = t.sel
        schema = plan.schema()

        resolution = (res or {}).get(id(plan))  # group-space count->emit
        dep_keys = self._fd_dependent_keys(plan, leaf_ids, res)
        if dep_keys:
            self.stats["fd_pruned_keys"] = (
                self.stats.get("fd_pruned_keys", 0) + len(dep_keys)
            )
        if plan.group_exprs:
            gvals = [ex.evaluator.eval(g, shim) for g in plan.group_exprs]
            ind = [i for i in range(len(gvals)) if i not in dep_keys]
            g_exprs_i = [plan.group_exprs[i] for i in ind]
            gvals_i = [gvals[i] for i in ind]
            # direct (sort-free) grouping when the single key's value range
            # is statically bounded: dictionary codes (range = dict size) or
            # an integer column with leaf min/max stats (bounds survive
            # filter/sort/limit; the eager path needs a key-range host sync
            # for the same information). Also shrinks every downstream
            # operator from row capacity to group capacity.
            direct = None  # (key plane, validity, lo, num_buckets)
            # FD-pruned grouping: only the independent keys participate in
            # group-id computation (dense ids sorted by the independent
            # keys equal those sorted by all keys — dependents are
            # functions of them)
            ranges = []  # per INDEPENDENT key: (lo, range) or None
            for g, v in zip(g_exprs_i, gvals_i):
                if v.dictionary is not None:
                    ranges.append((0, max(len(v.dictionary), 1)))
                elif jnp.issubdtype(v.data.dtype, jnp.integer):
                    ranges.append(_group_key_bounds(g, t))
                elif v.data.dtype == jnp.bool_:
                    ranges.append((0, 2))
                else:
                    ranges.append(None)
            if len(gvals_i) == 1:
                r0 = ranges[0]
                if r0 is not None and r0[1] + 1 <= ex._DIRECT_GROUP_MAX_RANGE:
                    direct = (gvals_i[0].data, gvals_i[0].validity,
                              r0[0], r0[1])
            elif all(r is not None for r in ranges):
                # combined code: lexicographic packing with a null slot per
                # key (code R_i), matching the sort-based group order
                # (nulls last per level) so dense ids agree with the eager
                # path
                prod = 1
                for _, rng_i in ranges:
                    prod *= rng_i + 1
                    if prod > ex._DIRECT_GROUP_MAX_RANGE:
                        break
                if prod <= ex._DIRECT_GROUP_MAX_RANGE:
                    combined = None
                    for v, (lo_i, rng_i) in zip(gvals_i, ranges):
                        code = jnp.where(
                            v.validity,
                            jnp.clip(
                                v.data.astype(jnp.int32) - lo_i, 0, rng_i - 1
                            ),
                            jnp.int32(rng_i),
                        )
                        combined = (
                            code if combined is None
                            else combined * (rng_i + 1) + code
                        )
                    direct = (combined, jnp.ones(cap, dtype=bool), 0, prod)
            bucket_mode = False
            if (
                direct is not None
                and padded_capacity(direct[3] + 1) <= cap
            ):
                # BUCKET MODE: aggregate straight into the bounded bucket
                # space and let the selection mask absorb the unobserved
                # buckets — no row-space dense-id gather, no representative
                # -row scatter (this removes two full-length random
                # gathers per GROUP BY). Output rows
                # sit at their bucket positions (key order, like the dense
                # ids), sel marks observed buckets, and the group-key
                # columns are computed from the bucket index directly.
                kd, kv, lo, nb = direct
                S = padded_capacity(nb + 1)
                lm = K.live_mask(cap, sel)
                gid = jnp.where(
                    lm & kv,
                    jnp.clip(kd.astype(jnp.int32) - lo, 0, nb - 1),
                    jnp.int32(nb),  # null-key group (pad rows masked by lm)
                ).astype(jnp.int32)
                ng = rep = None
                bucket_mode = True
            elif direct is not None:
                kd, kv, lo, nb = direct
                gid, ng, rep = K.group_ids_direct(kd, kv, sel, lo, nb)
                S = min(padded_capacity(nb + 1), cap)
            else:
                # bounded keys whose combination space exceeds the direct
                # bucket range still compose into ONE i64 sort operand.
                # A counted aggregate reuses the count program's grouping
                # (gid/ng/rep handed over as device planes) and skips the
                # group sort in the emit program.
                space = (self._xfer_by_node or {}).get(id(plan))
                if space is not None:
                    gid, ng, rep = space
                    self.stats["group_sorts_reused"] = (
                        self.stats.get("group_sorts_reused", 0) + 1
                    )
                else:
                    gid, ng, rep = K.group_ids(
                        [v.data for v in gvals_i],
                        [v.validity for v in gvals_i],
                        sel, ranges=ranges,
                    )
                S = cap
            if resolution is not None and not bucket_mode:
                if resolution == ("C", None):
                    # group-space COUNT pass: surface ng; the emit program
                    # then aggregates at padded(ng), not row capacity
                    raise _CountReady(plan, ng, extras=(gid, ng, rep))
                if resolution[0] == "E":
                    S = min(resolution[1], S)
            elif resolution == ("C", None):
                # bucket mode reached despite the count check (static
                # bounds appeared at materialize time): the bucket bound
                # already caps S — report it so the count program returns
                raise _CountReady(plan, jnp.int64(S))
        else:
            gvals = []
            bucket_mode = False
            gid = jnp.zeros(cap, dtype=jnp.int32)
            ng = jnp.int64(1)  # global aggregate: one row even on empty input
            rep = None
            S = min(128, cap)

        cols: List[Column] = []
        if bucket_mode:
            iota_s = jnp.arange(S, dtype=jnp.int32)
            key_cols = {}  # group-key position -> (data, validity, dict)
            if len(gvals_i) == 1:
                v = gvals_i[0]
                # int64 intermediate: lo can exceed int32 (timestamps)
                d = (iota_s.astype(jnp.int64) + lo).astype(v.data.dtype)
                key_cols[ind[0]] = (d, iota_s < nb, v.dictionary)
            else:
                # decompose the combined lexicographic code per key
                rem = iota_s
                codes = []
                for _, rng_i in reversed(ranges):
                    codes.append(rem % (rng_i + 1))
                    rem = rem // (rng_i + 1)
                codes.reverse()
                for pos, v, code, (lo_i, rng_i) in zip(
                    ind, gvals_i, codes, ranges
                ):
                    d = (code.astype(jnp.int64) + lo_i).astype(v.data.dtype)
                    key_cols[pos] = (d, code < rng_i, v.dictionary)
            if dep_keys:
                # FD-dependent keys: single-valued per bucket, so any live
                # row of the bucket serves; ONE i32 scatter-max builds the
                # representative-row plane the bucket path otherwise avoids
                lm_b = K.live_mask(cap, sel)
                rep_b = jnp.zeros(S, dtype=jnp.int32).at[
                    jnp.where(lm_b, gid, S)
                ].max(jnp.arange(cap, dtype=jnp.int32), mode="drop")
                dpos = sorted(dep_keys)
                dvals = [gvals[i] for i in dpos]
                kb_d = []
                for i in dpos:
                    v = gvals[i]
                    if v.dictionary is not None:
                        kb_d.append((0, max(len(v.dictionary), 1)))
                    else:
                        b = _group_key_bounds(plan.group_exprs[i], t)
                        kb_d.append(
                            b if (b is not None and len(b) == 2) else None
                        )
                g_d, g_v = K.gather_columns_packed(
                    [v.data for v in dvals], [v.validity for v in dvals],
                    kb_d, rep_b,
                )
                for pos, d, vv, v in zip(dpos, g_d, g_v, dvals):
                    key_cols[pos] = (d, vv, v.dictionary)
            for i, f in enumerate(schema):
                if i >= len(gvals):
                    break
                d, vv, dic = key_cols[i]
                cols.append(Column(d, vv, f.data_type, dic))
        elif gvals:
            # representative-row gather of the group keys, packed: narrow
            # keys + validity bits share words (one gather, not 2/key)
            kb = []
            for g, v in zip(plan.group_exprs, gvals):
                if v.dictionary is not None:
                    kb.append((0, max(len(v.dictionary), 1)))
                else:
                    b = _group_key_bounds(g, t)
                    kb.append(b if (b is not None and len(b) == 2) else None)
            g_d, g_v = K.gather_columns_packed(
                [v.data for v in gvals], [v.validity for v in gvals],
                kb, rep[:S],
            )
            for d, vd, v, f in zip(g_d, g_v, gvals, schema):
                cols.append(Column(d, vd, f.data_type, v.dictionary))

        # pre-pass: evaluate aggregate args once
        agg_evals = []
        for agg in plan.agg_exprs:
            if agg.expr is None:
                agg_evals.append(None)
                continue
            av = ex.evaluator.eval(agg.expr, shim)
            if (
                av.dtype.kind.name == "DECIMAL128"
                and agg.func is lp.AggFunc.AVG
            ):
                from query_engine_tpu.engine.expr_eval import _descale

                av = _descale(av)
            agg_evals.append(av)
        fi = len(gvals)
        for agg, av in zip(plan.agg_exprs, agg_evals):
            func = agg.func
            if agg.expr is None:
                fname = "count_star"
                data = validity = None
                arg_dict = None
            else:
                data, validity, arg_dict = av.data, av.validity, av.dictionary
                fname = func.value.lower()
            distinct_first = None
            if agg.distinct and agg.expr is not None:
                distinct_first = K.distinct_first_flags(
                    [data], [validity], gid, sel
                )
            f = schema.field(fi)
            fi += 1
            vb = None
            if func in (lp.AggFunc.MIN, lp.AggFunc.MAX, lp.AggFunc.SUM,
                        lp.AggFunc.AVG) and agg.expr is not None:
                # bounds shrink MIN/MAX to one i32 scatter and SUM/AVG to
                # only the chunk scatters covering the value span
                b = _proj_bounds(agg.expr, t)
                if b is not None:
                    vb = (b[0], b[0] + b[1] - 1)
            if not plan.group_exprs and distinct_first is None:
                vals, valid = K.global_aggregate(
                    fname,
                    data if data is not None else jnp.zeros(cap, jnp.int64),
                    validity if validity is not None else jnp.ones(cap, bool),
                    sel, S,
                )
            else:
                vals, valid = K.segment_aggregate(
                    fname, data, validity, gid, sel, S,
                    distinct_first=distinct_first, value_bounds=vb,
                )
            out_d = vals[:S]
            out_v = valid[:S]
            out_dict = (
                arg_dict
                if func in (lp.AggFunc.MIN, lp.AggFunc.MAX) and arg_dict is not None
                else None
            )
            if out_dict is not None:
                out_d = out_d.astype(jnp.int32)
            cols.append(Column(out_d, out_v, f.data_type, out_dict))

        if bucket_mode:
            # observed buckets only; shares the count_star computation
            # with any COUNT(*) agg via XLA CSE
            rows_per_bucket = jax.ops.segment_sum(
                K.live_mask(cap, sel).astype(jnp.int32), gid,
                num_segments=S,
            )
            sel_out = rows_per_bucket[:S] > 0
            return _TTable(schema, cols, sel_out, S, False,
                           [None] * len(cols))
        sel_out = jnp.arange(S, dtype=jnp.int32) < ng
        return _TTable(schema, cols, sel_out, S, True,
                       [None] * len(cols))

    # ---- window ------------------------------------------------------------
    def _trace_window(self, plan: pp.PWindow, tables, leaf_ids, res) -> _TTable:
        from query_engine_tpu.engine.executor import classify_window_frame

        ex = self.executor
        t = self._trace(plan.input, tables, leaf_ids, res)
        shim = _ShimBatch(t)
        cap = t.capacity
        sel = t.sel
        out_cols = list(t.cols)
        schema = plan.schema()

        # ---- shared-sort planning (VERDICT r2 item 6) -------------------
        # Specs with the same PARTITION BY whose ORDER BY is a PREFIX of
        # another spec's share that spec's single sort permutation: the
        # within-peer order the extra keys impose is invisible to
        # order-independent functions (RANK/DENSE_RANK; aggregates over
        # whole-partition or RANGE..CURRENT frames — peers resolve them).
        # A 3-spec query then costs ~1 sort instead of 3.
        def _spec_key(wexpr):
            return (
                tuple(str(_expr_key(p)) for p in wexpr.partition_by),
                tuple(
                    (str(_expr_key(k.expr)), k.asc, k.resolved_nulls_first())
                    for k in wexpr.order_by
                ),
            )

        def _order_independent(wexpr):
            fn = wexpr.func
            if fn in (lp.WindowFn.RANK, lp.WindowFn.DENSE_RANK,
                      lp.WindowFn.PERCENT_RANK, lp.WindowFn.CUME_DIST):
                # computed from segment/peer boundaries only — the
                # within-peer order extra prefix keys impose is invisible
                return True
            if fn in (lp.WindowFn.SUM, lp.WindowFn.COUNT, lp.WindowFn.AVG,
                      lp.WindowFn.MIN, lp.WindowFn.MAX):
                from query_engine_tpu.engine.executor import (
                    classify_window_frame,
                )

                try:
                    fdesc = classify_window_frame(
                        wexpr.frame, bool(wexpr.order_by)
                    )
                except Exception:
                    return False
                return fdesc[0] in ("partition", "range_current")
            return False

        spec_keys = [_spec_key(w) for w in plan.window_exprs]
        spec_exprs = {}  # spec key -> a window expr carrying those keys
        for w, sk in zip(plan.window_exprs, spec_keys):
            spec_exprs.setdefault(sk, w)
        host_of = []
        for w, (pk, okeys) in zip(plan.window_exprs, spec_keys):
            best = (pk, okeys)
            if _order_independent(w):
                for pk2, ok2 in spec_exprs:
                    if (
                        pk2 == pk and len(ok2) > len(best[1])
                        and ok2[: len(okeys)] == okeys
                    ):
                        best = (pk2, ok2)
            host_of.append(best)

        host_cache = {}  # host key -> (perm, pad_sorted, parts_norm,
        #                               orders_norm per-key, np_)
        seg_cache = {}   # (host key, n order keys used) -> seg triple
        spec_cache = {}  # inverse permutations per host
        for wi, (wexpr, _name) in enumerate(zip(plan.window_exprs, plan.names)):
            spec_key = host_of[wi]
            n_own_order = len(wexpr.order_by)
            host = host_cache.get(spec_key)
            if host is None:
                hexpr = spec_exprs[spec_key]
                part_vals = [
                    ex.evaluator.eval(p, shim) for p in hexpr.partition_by
                ]
                o_vals, o_ascs, o_nfs = [], [], []
                for k in hexpr.order_by:
                    o_vals.append(ex.evaluator.eval(k.expr, shim))
                    o_ascs.append(k.asc)
                    o_nfs.append(k.resolved_nulls_first())
                o_datas = [v.data for v in o_vals]
                o_valids = [v.validity for v in o_vals]
                p_datas = [v.data for v in part_vals]
                p_valids = [v.validity for v in part_vals]
                key_exprs = list(hexpr.partition_by) + [
                    k.expr for k in hexpr.order_by
                ]
                kb = _key_ranges(key_exprs, part_vals + o_vals, t)
                if not key_exprs:
                    # OVER () — no partition, no order: sort by a constant
                    # key (stable => live rows first in input order)
                    p_datas = [jnp.zeros(t.capacity, jnp.int32)]
                    p_valids = [jnp.ones(t.capacity, bool)]
                    kb = [(0, 1)]
                perm = K.sort_permutation(
                    p_datas + o_datas,
                    p_valids + o_valids,
                    [True] * len(p_datas) + o_ascs,
                    [False] * len(p_datas) + o_nfs,
                    sel,
                    ranges=kb,
                )
                pad_sorted = ~sel[perm]
                # one packed gather for ALL key planes through perm
                # (bare-column keys carry bounds; validity bits always pack)
                g_d, g_v = K.gather_columns_packed(
                    p_datas + o_datas, p_valids + o_valids, kb, perm
                )
                np_ = len(p_datas)
                parts_norm = []
                for d, v in zip(g_d[:np_], g_v[:np_]):
                    key, null = K.normalize_key(d, v)
                    parts_norm += [null.astype(jnp.int32), key]
                orders_norm = []  # one [null, key] pair per order key
                for d, v in zip(g_d[np_:], g_v[np_:]):
                    key, null = K.normalize_key(d, v)
                    orders_norm.append([null.astype(jnp.int32), key])
                host = (perm, pad_sorted, parts_norm, orders_norm)
                host_cache[spec_key] = host
            perm, pad_sorted, parts_norm, orders_norm = host
            seg_key = (spec_key, n_own_order)
            trip = seg_cache.get(seg_key)
            if trip is None:
                order_sorted = [
                    p for pair in orders_norm[:n_own_order] for p in pair
                ]
                trip = K.window_segments(
                    parts_norm, order_sorted, pad_sorted
                )
                seg_cache[seg_key] = trip
            seg_change, peer_change, seg = trip

            def sorted_arg(av, e):
                """Argument plane through perm, packed (1 gather when the
                column is bounded/dict/bool instead of data+valid)."""
                b = _proj_bounds(e, t)
                if not (b is not None and len(b) == 2):
                    b = ((0, max(len(av.dictionary), 1))
                         if av.dictionary is not None else None)
                gd, gv = K.gather_columns_packed(
                    [av.data], [av.validity], [b], perm
                )
                return gd[0], gv[0]

            fn = wexpr.func
            f = schema.field(len(t.cols) + wi)
            out_dict = None
            if fn is lp.WindowFn.ROW_NUMBER:
                svals = K.row_number_sorted(seg_change)
                svalid = jnp.ones(cap, dtype=bool)
            elif fn is lp.WindowFn.RANK:
                svals = K.rank_sorted(seg_change, peer_change)
                svalid = jnp.ones(cap, dtype=bool)
            elif fn is lp.WindowFn.DENSE_RANK:
                svals = K.dense_rank_sorted(seg_change, peer_change)
                svalid = jnp.ones(cap, dtype=bool)
            elif fn is lp.WindowFn.NTILE:
                n_tiles = ex._const_int(wexpr.args[0], 1)
                svals = K.ntile_sorted(seg_change, n_tiles, pad_sorted)
                svalid = jnp.ones(cap, dtype=bool)
            elif fn is lp.WindowFn.PERCENT_RANK:
                svals = K.percent_rank_sorted(seg_change, peer_change)
                svalid = jnp.ones(cap, dtype=bool)
            elif fn is lp.WindowFn.CUME_DIST:
                svals = K.cume_dist_sorted(seg_change, peer_change)
                svalid = jnp.ones(cap, dtype=bool)
            elif fn in (lp.WindowFn.FIRST_VALUE, lp.WindowFn.LAST_VALUE,
                        lp.WindowFn.NTH_VALUE):
                av = ex.evaluator.eval(wexpr.args[0], shim)
                sd, sv = sorted_arg(av, wexpr.args[0])
                fdesc = classify_window_frame(
                    wexpr.frame, bool(wexpr.order_by)
                )
                oplane = None
                if fdesc[0] == "range_off":
                    oplane = _trace_range_off_plane(ex, wexpr, shim,
                                                    sorted_arg)
                lo, hi = K.window_frame_bounds(
                    fdesc, seg_change, peer_change, pad_sorted, oplane
                )
                if fn is lp.WindowFn.FIRST_VALUE:
                    pos = lo
                elif fn is lp.WindowFn.LAST_VALUE:
                    pos = hi
                else:
                    nth = ex._const_int(wexpr.args[1], 1)
                    if nth < 1:
                        raise _Unsupported("NTH_VALUE position must be >= 1")
                    pos = lo + (nth - 1)
                svals, svalid = K.value_at(sd, sv, pos)
                svalid = svalid & (pos <= hi) & (pos >= lo)
                out_dict = av.dictionary
            elif fn in (lp.WindowFn.LAG, lp.WindowFn.LEAD):
                av = ex.evaluator.eval(wexpr.args[0], shim)
                offset = (
                    ex._const_int(wexpr.args[1], 1) if len(wexpr.args) > 1 else 1
                )
                if fn is lp.WindowFn.LEAD:
                    offset = -offset
                a_d, a_v = sorted_arg(av, wexpr.args[0])
                svals, svalid = K.shift_in_segment(a_d, a_v, seg, offset)
                if len(wexpr.args) > 2:
                    dv = ex.evaluator.eval(wexpr.args[2], shim)
                    if av.dictionary is not None or dv.dictionary is not None:
                        raise _Unsupported("LAG/LEAD string default")
                    dv_d, dv_v = sorted_arg(dv, wexpr.args[2])
                    svals = jnp.where(svalid, svals, dv_d)
                    svalid = svalid | dv_v
                out_dict = av.dictionary
            elif fn in (lp.WindowFn.SUM, lp.WindowFn.COUNT, lp.WindowFn.AVG,
                        lp.WindowFn.MIN, lp.WindowFn.MAX):
                from query_engine_tpu.engine.executor import (
                    classify_window_frame,
                )

                if wexpr.args:
                    av = ex.evaluator.eval(wexpr.args[0], shim)
                    if (
                        av.dtype.kind.name == "DECIMAL128"
                        and fn is lp.WindowFn.AVG
                    ):
                        from query_engine_tpu.engine.expr_eval import _descale

                        av = _descale(av)
                    wvals, wok = sorted_arg(av, wexpr.args[0])
                    if fn in (lp.WindowFn.MIN, lp.WindowFn.MAX):
                        out_dict = av.dictionary
                    fname = fn.value.lower()
                else:
                    wvals = wok = None
                    fname = "count_star"
                fdesc = classify_window_frame(wexpr.frame, bool(wexpr.order_by))
                oplane = None
                if fdesc[0] == "range_off":
                    oplane = _trace_range_off_plane(ex, wexpr, shim,
                                                    sorted_arg)
                svals, svalid = K.window_aggregate_sorted(
                    fname, wvals, wok, seg_change, peer_change, pad_sorted,
                    fdesc, order_plane=oplane,
                )
            else:
                raise _Unsupported(f"window function {fn.value}")

            # back to row order via the inverse permutation: ONE i32
            # scatter (cached per spec) + a packed gather, in place of a
            # direct i64 result scatter
            inv = spec_cache.get((spec_key, "inv"))
            if inv is None:
                inv = (
                    jnp.zeros(cap, dtype=jnp.int32)
                    .at[perm].set(jnp.arange(cap, dtype=jnp.int32))
                )
                spec_cache[(spec_key, "inv")] = inv
            rb = (
                (0, cap + 1) if fn in (
                    lp.WindowFn.ROW_NUMBER, lp.WindowFn.RANK,
                    lp.WindowFn.DENSE_RANK, lp.WindowFn.NTILE,
                ) else None  # rank family: values in [1, cap]
            )
            (out_d,), (out_v,) = K.gather_columns_packed(
                [svals], [svalid], [rb], inv
            )
            out_v = out_v & sel
            if out_dict is not None:
                out_d = out_d.astype(jnp.int32)
            out_cols.append(Column(out_d, out_v, f.data_type, out_dict))

        self.stats["window_sorts"] = (
            self.stats.get("window_sorts", 0) + len(host_cache)
        )
        self.stats["window_specs"] = (
            self.stats.get("window_specs", 0) + len(set(spec_keys))
        )
        return _TTable(schema, out_cols, sel, cap, t.dense,
                       t.bounds + [None] * len(plan.window_exprs))


class _Entry:
    """Cached compiled program + trace-captured output metadata."""

    __slots__ = ("plan", "leaves", "leaf_ids", "res", "dyn_exprs",
                 "sub_exprs", "sub_batches", "fn", "meta", "ordinal",
                 "xfer_ords", "check_nodes")

    def __init__(self, plan, leaves):
        self.plan = plan
        self.leaves = leaves  # holds dictionary refs so leaf ids stay unique
        self.leaf_ids = frozenset()
        self.res = {}
        self.dyn_exprs = []
        self.sub_exprs = []
        self.sub_batches = []
        self.fn = None
        self.meta = {}
        self.ordinal = None  # count programs: which ctx.checks join counts
        self.xfer_ords = ()  # emit programs: check ordinals whose counted
        # joins receive the count program's sorted space as extra inputs
        self.check_nodes = []  # ctx.checks join nodes (ordinal -> node)


def compiled_enabled() -> bool:
    return os.environ.get("QE_COMPILED", "1") != "0"
