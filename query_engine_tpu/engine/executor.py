"""Physical plan executor.

Parity surface: reference crates/query-executor/src/executor.rs:12-541 —
recursive plan walk materializing results per node. Where the reference stubs
the hot operators (sort pass-through :290-297, Cartesian joins :500-540,
empty grouped aggregate :188-189, window pass-through :76-80), this executor
implements the claimed semantics with the device kernels in ops/kernels.py.

Execution model: host-driven walk; each blocking operator runs jitted device
kernels over fixed-capacity planes, syncing only the scalar row counts that
size the next operator's output bucket (count-then-emit two-pass; SURVEY.md
§7 hard-part #1).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from query_engine_tpu.core.errors import ExecutionError
from query_engine_tpu.core.schema import Field, Schema
from query_engine_tpu.columnar.batch import Column, ColumnBatch, padded_capacity
from query_engine_tpu.columnar.dictionary import Dictionary
from query_engine_tpu.engine.expr_eval import Evaluator, Val, unify_dicts
from query_engine_tpu.ops import kernels as K
from query_engine_tpu.plan import logical as lp
from query_engine_tpu.plan import physical as pp


def _val_to_column(v: Val, f: Field) -> Column:
    return Column(v.data, v.validity, f.data_type, v.dictionary)


def _take(
    batch: ColumnBatch,
    indices: jnp.ndarray,
    count: int,
    row_valid: Optional[jnp.ndarray] = None,
    schema: Optional[Schema] = None,
) -> ColumnBatch:
    """Device gather of whole-batch rows into a new batch of len(indices)
    capacity (the vectorized `take` — reference partition.rs:292-316).
    Bounded/dictionary columns and validity bits ride packed uint32 words
    (each random gather pays per element; K.gather_columns_packed)."""
    from query_engine_tpu.engine.pipeline import _bucket_bounds, _col_bounds

    datas = [jnp.asarray(c.data) for c in batch.columns]
    valids = [jnp.asarray(c.validity) for c in batch.columns]
    bounds = []
    for c in batch.columns:
        if c.dictionary is not None:
            bounds.append((0, max(len(c.dictionary), 1)))
        else:
            # opportunistic: cached stats only — never sync a device
            # plane to host just to pack a gather
            b = getattr(c, "_qe_bounds", None)
            bb = _bucket_bounds(b) if isinstance(b, tuple) else None
            bounds.append(bb if (bb is not None and len(bb) == 2) else None)
    out_d, out_v = K.gather_columns_packed(
        datas, valids, bounds, indices, row_valid
    )
    cols = [
        Column(d, v, c.dtype, c.dictionary)
        for d, v, c in zip(out_d, out_v, batch.columns)
    ]
    return ColumnBatch(schema or batch.schema, cols, count)


def _expr_struct_key(e: lp.LogicalExpr) -> str:
    """Rendered label for an expression — display/duplicate-detection WITHIN
    one execution only. NOT a cache key across queries: names hide resolved
    column indices (aliases, projection-pruned scans), so two different
    computations can render identically. Cross-query caches must use
    pipeline._expr_key."""
    return f"{type(e).__name__}:{e.name()}"


def _expr_has_host_dependency(e: lp.LogicalExpr) -> bool:
    """True if evaluating `e` requires host work that cannot be traced into
    one jitted program (subquery execution)."""
    found = []

    def visit(x):
        if isinstance(
            x, (lp.ScalarSubqueryExpr, lp.InSubqueryExpr, lp.ExistsExpr,
                lp.CorrelatedLookupExpr, lp.UdfExpr),
        ):
            found.append(x)

    lp.walk_exprs(e, visit)
    return bool(found)


def _batch_nbytes(batch) -> int:
    """Device-plane footprint of a batch (data + validity), for the
    profiler's achieved-bandwidth accounting."""
    total = 0
    for c in getattr(batch, "columns", ()):
        total += getattr(c.data, "nbytes", 0) + getattr(c.validity, "nbytes", 0)
    return total


class _ShimBatch:
    """Duck-typed ColumnBatch over traced arrays for in-jit evaluation."""

    __slots__ = ("schema", "columns", "num_rows", "capacity")

    def __init__(self, schema, columns, capacity):
        self.schema = schema
        self.columns = columns
        self.capacity = capacity
        self.num_rows = None

    @property
    def num_columns(self):
        return len(self.columns)


def _shim_batch(schema, datas, valids, dtypes, dicts) -> "_ShimBatch":
    cols = [
        Column(d, v, t, dic)
        for d, v, t, dic in zip(datas, valids, dtypes, dicts)
    ]
    return _ShimBatch(schema, cols, datas[0].shape[0])


def classify_window_frame(frame, has_order: bool):
    """Map an ast.WindowFrame (or None) onto the kernel's frame descriptor.
    PG defaults: no frame + ORDER BY => RANGE UNBOUNDED PRECEDING..CURRENT
    ROW (current row and its peers); no ORDER BY => whole partition."""
    if frame is None:
        return ("range_current",) if has_order else ("partition",)
    start, end = frame.start, frame.end
    mode = frame.mode.value if hasattr(frame.mode, "value") else str(frame.mode)
    if mode == "RANGE":
        if start.kind == "PRECEDING" and start.offset is None:
            if end is None or end.kind == "CURRENT":
                return ("range_current",)
            if end.kind == "FOLLOWING" and end.offset is None:
                return ("partition",)
            if end.kind == "FOLLOWING":
                return ("range_off", None, int(end.offset))
        # value-distance frames: RANGE BETWEEN x PRECEDING AND y FOLLOWING
        # over a single numeric ORDER BY key
        if start.kind == "CURRENT":
            s_off = 0
        elif start.kind == "PRECEDING":
            s_off = None if start.offset is None else int(start.offset)
        else:
            raise ExecutionError("FOLLOWING RANGE frame starts not supported")
        if end is None or end.kind == "CURRENT":
            e_off = 0
        elif end.kind == "FOLLOWING":
            e_off = None if end.offset is None else int(end.offset)
        else:
            raise ExecutionError("PRECEDING RANGE frame ends not supported")
        return ("range_off", s_off, e_off)
    # ROWS
    if start.kind == "CURRENT":
        s_off = 0
    elif start.kind == "PRECEDING":
        s_off = None if start.offset is None else int(start.offset)
    else:
        raise ExecutionError("FOLLOWING frame starts not supported")
    if end is None or end.kind == "CURRENT":
        e_off = 0
    elif end.kind == "FOLLOWING":
        e_off = None if end.offset is None else int(end.offset)
    else:
        raise ExecutionError("PRECEDING frame ends not supported")
    return ("rows", s_off, e_off)


_WINDOW_AGGS = {
    lp.WindowFn.SUM, lp.WindowFn.COUNT, lp.WindowFn.AVG,
    lp.WindowFn.MIN, lp.WindowFn.MAX,
}


class QueryExecutor:
    """Executes physical plans against in-memory/device tables."""

    def __init__(self, udfs=None):
        self.udfs = udfs
        self.evaluator = Evaluator(subquery_exec=self.execute, udfs=udfs)
        self._fused_cache = {}
        from query_engine_tpu.engine.pipeline import (
            CompiledPipeline, compiled_enabled,
        )

        self.pipeline = CompiledPipeline(self)
        self._compiled = compiled_enabled()
        from query_engine_tpu.engine.chunked import ChunkedAggregate

        self.chunked = ChunkedAggregate(self)
        # per-query memo for shared (multiply-referenced) WITH subplans,
        # keyed by id() of the shared physical node; session-managed
        self._cte_memo: Dict[int, ColumnBatch] = {}

    # ---- entry ---------------------------------------------------------
    def execute(self, plan: pp.PhysicalPlan) -> ColumnBatch:
        from query_engine_tpu.utils.profiling import GLOBAL_PROFILER

        if not GLOBAL_PROFILER.enabled:
            return self._execute_node(plan)
        if isinstance(plan, _Materialized):
            return plan.batch
        name = type(plan).__name__
        name = (name[1:] if name.startswith("P") else name).lower() or "node"
        if self._compiled:
            out = self.chunked.try_execute(plan)  # engages above threshold
            if out is not None:
                return out
            with GLOBAL_PROFILER.op("compiled_pipeline") as rec:
                out = self.pipeline.try_execute(plan)
                if out is not None:
                    rec.rows = out.num_rows
                    rec.bytes = _batch_nbytes(out)
                    return out
                rec.rows = rec.bytes = 0  # fell through: charge the node
        with GLOBAL_PROFILER.op(name) as rec:
            out = self._execute_node(plan, _skip_compiled=True)
            rec.rows = out.num_rows
            rec.bytes = _batch_nbytes(out)
        return out

    def _execute_node(self, plan: pp.PhysicalPlan,
                      _skip_compiled: bool = False) -> ColumnBatch:
        if isinstance(plan, _Materialized):
            return plan.batch
        if self._compiled and not _skip_compiled:
            # 100M+-row aggregates run chunked (partial per row-chunk ->
            # final combine) to stay inside HBM; engages only above the
            # QE_CHUNK_ENGAGE capacity threshold
            out = self.chunked.try_execute(plan)
            if out is not None:
                return out
            out = self.pipeline.try_execute(plan)
            if out is not None:
                return out
        if isinstance(plan, pp.PScan):
            return self._exec_scan(plan)
        if isinstance(plan, pp.PIndexScan):
            return self._exec_index_scan(plan)
        if isinstance(plan, pp.PProjection):
            return self._exec_projection(plan)
        if isinstance(plan, pp.PFilter):
            return self._exec_filter(plan)
        if isinstance(plan, pp.PHashJoin):
            return self._exec_join(plan)
        if isinstance(plan, pp.PHashAggregate):
            return self._exec_aggregate(plan)
        if isinstance(plan, pp.PSort):
            return self._exec_sort(plan)
        if isinstance(plan, pp.PLimit):
            return self._exec_limit(plan)
        if isinstance(plan, pp.PWindow):
            return self._exec_window(plan)
        if isinstance(plan, pp.PDistinct):
            return self._exec_distinct(plan)
        if isinstance(plan, pp.PSetOp):
            return self._exec_setop(plan)
        if isinstance(plan, pp.PSubquery):
            if plan.shared:
                # WITH query referenced multiple times: materialize once,
                # every reference reuses the SAME batch (PG semantics; also
                # keeps float aggregates bit-identical across references).
                # The session clears the memo around each query.
                child = self._cte_memo.get(id(plan.input))
                if child is None:
                    child = self.execute(plan.input)
                    self._cte_memo[id(plan.input)] = child
            else:
                child = self.execute(plan.input)
            return ColumnBatch(plan.out_schema, child.columns, child.num_rows)
        if isinstance(plan, pp.PEmpty):
            if plan.produce_one_row:
                cols = []
                cap = 128
                for f in plan.out_schema:
                    cols.append(
                        Column(
                            np.zeros(cap, f.data_type.device_dtype),
                            np.zeros(cap, bool),
                            f.data_type,
                            Dictionary.empty() if f.data_type.is_dictionary else None,
                        )
                    )
                return ColumnBatch(plan.out_schema, cols, 1)
            return ColumnBatch.empty(plan.out_schema)
        if isinstance(plan, pp.PValues):
            return self._exec_values(plan)
        if isinstance(plan, pp.PUnnest):
            return self._exec_unnest(plan)
        if isinstance(plan, pp.PGenerateSeries):
            start, stop, step = plan.start, plan.stop, plan.step
            if plan.values is not None:  # month-stepped temporal series
                n = len(plan.values)
                cap = padded_capacity(n)
                host = np.zeros(cap, dtype=np.int64)
                host[:n] = plan.values
                data = jnp.asarray(host)
            else:
                if step > 0:
                    n = 0 if start > stop else (stop - start) // step + 1
                else:
                    n = 0 if start < stop else (start - stop) // (-step) + 1
                cap = padded_capacity(n)
                data = start + step * jnp.arange(cap, dtype=jnp.int64)
            col = Column(data, jnp.ones(cap, dtype=bool),
                         plan.out_schema.field(0).data_type, None)
            return ColumnBatch(plan.out_schema, [col], n)
        raise ExecutionError(f"cannot execute {type(plan).__name__}")

    def _exec_unnest(self, plan: pp.PUnnest) -> ColumnBatch:
        """Lateral list explosion (host): LIST columns are terminal
        dictionary-of-Python-lists values, so lengths/flatten run on the
        host, then one take per input column re-aligns the base rows."""
        batch = self.execute(plan.input)
        v = self.evaluator.eval(plan.list_expr, batch)
        n = batch.num_rows
        if v.dictionary is None:
            raise ExecutionError("UNNEST requires a LIST value")
        codes = np.asarray(v.data)[:n]
        valid = np.asarray(v.validity)[:n]
        vals = v.dictionary.values
        lists = []
        for c, ok in zip(codes, valid):
            x = vals[int(c)] if ok and 0 <= int(c) < len(vals) else None
            if x is None:
                lists.append([])
            elif isinstance(x, (list, tuple)):
                lists.append(list(x))
            else:
                lists.append([x])
        lengths = np.asarray([len(x) for x in lists], dtype=np.int64)
        ridx = np.repeat(np.arange(n, dtype=np.int64), lengths)
        elems = [e for x in lists for e in x]
        total = len(elems)
        fld = plan.out_schema.field(len(plan.out_schema) - 1)
        elem_batch = ColumnBatch.from_pydict(
            {"v": elems}, Schema([Field("v", fld.data_type, True)])
        )
        cols = []
        if batch.num_columns:
            base = batch.take_host(ridx)
            cols = list(base.columns)
            if base.capacity != elem_batch.capacity:
                raise ExecutionError("UNNEST capacity mismatch")
        return ColumnBatch(
            plan.out_schema, cols + [elem_batch.columns[0]], total
        )

    # ---- scan ----------------------------------------------------------
    def _exec_scan(self, plan: pp.PScan) -> ColumnBatch:
        batch = plan.source.scan()
        if plan.projection is not None:
            batch = batch.select(plan.projection)
        if len(batch.schema) != len(plan.out_schema):
            raise ExecutionError(
                f"scan schema mismatch for {plan.table_name}"
            )
        from query_engine_tpu.engine.pipeline import ensure_device

        # columns are shared with the stored batch: planes move to the
        # device once per table version, not once per query
        ensure_device(batch)
        return ColumnBatch(plan.out_schema, batch.columns, batch.num_rows)

    def _exec_index_scan(self, plan: pp.PIndexScan) -> ColumnBatch:
        batch = plan.source.scan()
        if plan.projection is not None:
            batch = batch.select(plan.projection)
        row_ids = plan.lookup()  # host-side index lookup -> np array of rows
        row_ids = np.asarray(row_ids, dtype=np.int64)
        out = batch.take_host(row_ids)
        out = ColumnBatch(plan.out_schema, out.columns, out.num_rows)
        if plan.residual is not None:
            out = self._filter_batch(out, plan.residual)
        return out

    # ---- projection / filter ------------------------------------------
    def _exec_projection(self, plan: pp.PProjection) -> ColumnBatch:
        batch = self.execute(plan.input)
        schema = plan.schema()
        cols = []
        for e, f in zip(plan.exprs, schema):
            v = self.evaluator.eval(e, batch)
            cols.append(_val_to_column(v, f))
        return ColumnBatch(schema, cols, batch.num_rows)

    def _filter_batch(self, batch: ColumnBatch, predicate) -> ColumnBatch:
        fused = self._fused_filter(batch, predicate)
        if fused is not None:
            return fused
        mask = self.evaluator.eval_predicate_mask(predicate, batch)
        count = int(K.filter_count(mask, batch.num_rows))
        out_cap = padded_capacity(count)
        idx = K.compaction_indices(mask, batch.num_rows, out_cap)
        return _take(batch, idx, count)

    # ---- fused filter ----------------------------------------------------
    # Eager evaluation dispatches one device program per expression node,
    # so a 5-column filter costs ~15 round trips. Fusing mask+count into
    # one jitted program and
    # compact+gather into a second (static out-capacity chosen after the
    # count sync) gets any subquery-free filter down to 2 dispatches.
    def _fused_filter(self, batch: ColumnBatch, predicate):
        if batch.num_columns == 0 or _expr_has_host_dependency(predicate):
            return None
        from query_engine_tpu.engine.pipeline import _expr_key, _Unsupported

        try:
            pkey = _expr_key(predicate)  # structural: resolved indices,
            # literal values — name-based keys aliased ACROSS queries when
            # projection pruning remapped the same column name to different
            # indices (the cached program then filtered the wrong column)
        except _Unsupported:
            return None
        key = (
            "filter", pkey, batch.capacity,
            tuple(str(c.data.dtype) for c in batch.columns),
            tuple(id(c.dictionary) for c in batch.columns),
        )
        mask_fn = self._fused_cache.get(key)
        if mask_fn is None:
            evaluator = self.evaluator
            schema = batch.schema
            dicts = [c.dictionary for c in batch.columns]
            dtypes = [c.dtype for c in batch.columns]

            @jax.jit
            def mask_fn(datas, valids, num_rows):
                shim = _shim_batch(schema, datas, valids, dtypes, dicts)
                shim.num_rows = num_rows
                mask = evaluator.eval_predicate_mask(predicate, shim)
                return mask, K.filter_count(mask, num_rows)

            self._fused_cache[key] = mask_fn
        datas = [jnp.asarray(c.data) for c in batch.columns]
        valids = [jnp.asarray(c.validity) for c in batch.columns]
        try:
            mask, count = mask_fn(datas, valids, batch.num_rows)
        except ExecutionError:
            return None
        count = int(count)
        out_cap = padded_capacity(count)
        take_key = ("take", batch.capacity, out_cap,
                    tuple(str(d.dtype) for d in datas))
        take_fn = self._fused_cache.get(take_key)
        if take_fn is None:

            @jax.jit
            def take_fn(mask, datas, valids, num_rows):
                idx = K.compaction_indices(mask, num_rows, out_cap)
                return K.gather_columns(datas, valids, idx)

            self._fused_cache[take_key] = take_fn
        out_d, out_v = take_fn(mask, datas, valids, batch.num_rows)
        cols = [
            Column(d, v, c.dtype, c.dictionary)
            for d, v, c in zip(out_d, out_v, batch.columns)
        ]
        return ColumnBatch(batch.schema, cols, count)

    def _exec_filter(self, plan: pp.PFilter) -> ColumnBatch:
        batch = self.execute(plan.input)
        return self._filter_batch(batch, plan.predicate)

    # ---- join ----------------------------------------------------------
    def _exec_join(self, plan: pp.PHashJoin) -> ColumnBatch:
        left = self.execute(plan.left)
        right = self.execute(plan.right)
        nl, nr = left.num_rows, right.num_rows
        jt = plan.join_type

        if plan.residual is not None and jt in (
            lp.JoinType.LEFT, lp.JoinType.RIGHT, lp.JoinType.FULL
        ):
            return self._exec_outer_join_residual(plan, left, right)

        if jt is lp.JoinType.CROSS or not plan.key_pairs:
            if jt is not lp.JoinType.CROSS:
                raise ExecutionError("non-cross join requires equi-keys")
            total = nl * nr
            out_cap = padded_capacity(total)
            li, ri, valid = K.cross_join_indices(nl, nr, out_cap)
            out = self._assemble_join(
                plan, left, right, li, ri, valid, valid, total
            )
            return out

        # pass 1 (one dispatch): key eval + ranks + counts, fused and cached
        # per plan shape — the host syncs only the three output sizes
        state = self._join_count_pass(plan, left, right)
        (lr, counts, rank_start, right_by_rank, lmatched, rmatched,
         total_t, extra_l_t, extra_r_t) = state
        total = int(total_t)
        extra_l = int(extra_l_t)
        extra_r = int(extra_r_t)

        out_rows = total + extra_l + extra_r
        out_cap = padded_capacity(out_rows)

        if out_cap <= (1 << 22):
            # pass 2 (one dispatch): emit + outer padding + column gathers,
            # fused and cached per (shape, out_cap, which-extras). Gated by
            # output size: at tens of millions of rows one mega-program
            # holds every intermediate live and runs ~30% slower than the
            # step-by-step kernels, while the dispatch savings stop
            # mattering next to multi-second compute.
            out = self._join_emit_pass(
                plan, left, right,
                (lr, counts, rank_start, right_by_rank, lmatched, rmatched),
                total, extra_l, extra_r, out_cap, out_rows,
            )
            if plan.residual is not None:
                out = self._filter_batch(out, plan.residual)
            return out

        li, ri, valid = K.join_emit_inner(
            counts, rank_start, right_by_rank, lr, total, out_cap
        )
        lvalid = valid
        rvalid = valid
        if extra_l:
            ul_idx, _ = K.unmatched_indices(
                lmatched, nl, padded_capacity(extra_l)
            )
            pos = jnp.arange(out_cap)
            in_l = (pos >= total) & (pos < total + extra_l)
            sel = jnp.clip(pos - total, 0, padded_capacity(extra_l) - 1)
            li = jnp.where(in_l, ul_idx[sel], li)
            lvalid = lvalid | in_l
            valid = valid | in_l
        if extra_r:
            ur_idx, _ = K.unmatched_indices(
                rmatched, nr, padded_capacity(extra_r)
            )
            pos = jnp.arange(out_cap)
            start = total + extra_l
            in_r = (pos >= start) & (pos < start + extra_r)
            sel = jnp.clip(pos - start, 0, padded_capacity(extra_r) - 1)
            ri = jnp.where(in_r, ur_idx[sel], ri)
            rvalid = rvalid | in_r
            valid = valid | in_r
        out = self._assemble_join(
            plan, left, right, li, ri, lvalid, rvalid, out_rows
        )
        if plan.residual is not None:
            out = self._filter_batch(out, plan.residual)
        return out

    def _join_emit_pass(self, plan, left, right, state, total, extra_l,
                        extra_r, out_cap: int, out_rows: int) -> ColumnBatch:
        lr, counts, rank_start, right_by_rank, lmatched, rmatched = state
        key = (
            "joinemit", out_cap, extra_l > 0, extra_r > 0,
            left.capacity, right.capacity,
            tuple(str(c.data.dtype) for c in left.columns),
            tuple(str(c.data.dtype) for c in right.columns),
        )
        fn = self._fused_cache.get(key)
        if fn is None:
            has_l, has_r = extra_l > 0, extra_r > 0
            cap_l, cap_r = left.capacity, right.capacity

            @jax.jit
            def fn(lr, counts, rank_start, right_by_rank, lmatched,
                   rmatched, total, extra_l, extra_r, nl, nr, ld, lv, rd, rv):
                li, ri, valid = K.join_emit_inner(
                    counts, rank_start, right_by_rank, lr, total, out_cap
                )
                lvalid = valid
                rvalid = valid
                pos = jnp.arange(out_cap)
                if has_l:
                    ul_idx = K.compaction_indices(
                        ~lmatched & K.live_mask(cap_l, nl), nl, out_cap
                    )
                    in_l = (pos >= total) & (pos < total + extra_l)
                    sel = jnp.clip(pos - total, 0, out_cap - 1)
                    li = jnp.where(in_l, ul_idx[sel], li)
                    lvalid = lvalid | in_l
                    valid = valid | in_l
                if has_r:
                    ur_idx = K.compaction_indices(
                        ~rmatched & K.live_mask(cap_r, nr), nr, out_cap
                    )
                    start = total + extra_l
                    in_r = (pos >= start) & (pos < start + extra_r)
                    sel = jnp.clip(pos - start, 0, out_cap - 1)
                    ri = jnp.where(in_r, ur_idx[sel], ri)
                    rvalid = rvalid | in_r
                    valid = valid | in_r
                gl_d, gl_v = K.gather_columns(ld, lv, li, lvalid)
                gr_d, gr_v = K.gather_columns(rd, rv, ri, rvalid)
                return tuple(gl_d), tuple(gl_v), tuple(gr_d), tuple(gr_v)

            self._fused_cache[key] = fn
        gl_d, gl_v, gr_d, gr_v = fn(
            lr, counts, rank_start, right_by_rank, lmatched, rmatched,
            np.int64(total), np.int64(extra_l), np.int64(extra_r),
            np.int64(left.num_rows), np.int64(right.num_rows),
            [jnp.asarray(c.data) for c in left.columns],
            [jnp.asarray(c.validity) for c in left.columns],
            [jnp.asarray(c.data) for c in right.columns],
            [jnp.asarray(c.validity) for c in right.columns],
        )
        cols = [
            Column(d, v, c.dtype, c.dictionary)
            for d, v, c in zip(
                list(gl_d) + list(gr_d), list(gl_v) + list(gr_v),
                list(left.columns) + list(right.columns),
            )
        ]
        return ColumnBatch(plan.out_schema, cols, out_rows)

    def _join_count_pass(self, plan, left, right):
        """Fused, cached count pass for the eager join: one device program
        for key evaluation + rank assignment + match counting (the eager
        path previously dispatched each step separately)."""
        from query_engine_tpu.engine.pipeline import _expr_key, _Unsupported

        jt = plan.join_type
        try:
            kkey = tuple(
                (_expr_key(a), _expr_key(b)) for a, b in plan.key_pairs
            )
        except _Unsupported:
            kkey = None
        if kkey is None or any(
            _expr_has_host_dependency(e)
            for pair in plan.key_pairs for e in pair
        ):
            return self._join_count_eager(plan, left, right)
        key = (
            "joincount", jt.value, kkey,
            left.capacity, right.capacity,
            tuple(str(c.data.dtype) for c in left.columns),
            tuple(str(c.data.dtype) for c in right.columns),
            tuple(id(c.dictionary) for c in left.columns),
            tuple(id(c.dictionary) for c in right.columns),
        )
        fn = self._fused_cache.get(key)
        if fn is None:
            evaluator = self.evaluator
            lschema, rschema = plan.left.schema(), plan.right.schema()
            ldts = [c.dtype for c in left.columns]
            rdts = [c.dtype for c in right.columns]
            ldics = [c.dictionary for c in left.columns]
            rdics = [c.dictionary for c in right.columns]
            key_pairs = plan.key_pairs
            jtt = jt

            @jax.jit
            def fn(ld, lv, rd, rv, nl, nr):
                lb = _shim_batch(lschema, ld, lv, ldts, ldics)
                rb = _shim_batch(rschema, rd, rv, rdts, rdics)
                lkeys, rkeys = [], []
                for le, re_ in key_pairs:
                    a = evaluator.eval(le, lb)
                    b = evaluator.eval(re_, rb)
                    if a.dictionary is not None or b.dictionary is not None:
                        a, b = unify_dicts(a, b)
                    lkeys.append((a.data, a.validity))
                    rkeys.append((b.data, b.validity))
                lr, rr = K.join_ranks(lkeys, rkeys, nl, nr)
                (total, counts, _off, rank_start, right_by_rank,
                 lmatched, rmatched) = K.join_counts(lr, rr, nl, nr)
                extra_l = jnp.int64(0)
                extra_r = jnp.int64(0)
                if jtt in (lp.JoinType.LEFT, lp.JoinType.FULL):
                    extra_l = jnp.sum(
                        (~lmatched & K.live_mask(lr.shape[0], nl)).astype(jnp.int64)
                    )
                if jtt in (lp.JoinType.RIGHT, lp.JoinType.FULL):
                    extra_r = jnp.sum(
                        (~rmatched & K.live_mask(rr.shape[0], nr)).astype(jnp.int64)
                    )
                return (lr, counts, rank_start, right_by_rank, lmatched,
                        rmatched, total, extra_l, extra_r)

            self._fused_cache[key] = fn
        try:
            return fn(
                [jnp.asarray(c.data) for c in left.columns],
                [jnp.asarray(c.validity) for c in left.columns],
                [jnp.asarray(c.data) for c in right.columns],
                [jnp.asarray(c.validity) for c in right.columns],
                np.int64(left.num_rows), np.int64(right.num_rows),
            )
        except ExecutionError:
            return self._join_count_eager(plan, left, right)

    def _join_count_eager(self, plan, left, right):
        nl, nr = left.num_rows, right.num_rows
        lkeys, rkeys = [], []
        for le, re_ in plan.key_pairs:
            lv = self.evaluator.eval(le, left)
            rv = self.evaluator.eval(re_, right)
            if lv.dictionary is not None or rv.dictionary is not None:
                lv, rv = unify_dicts(lv, rv)
            lkeys.append((lv.data, lv.validity))
            rkeys.append((rv.data, rv.validity))
        lr, rr = K.join_ranks(lkeys, rkeys, nl, nr)
        (total, counts, _off, rank_start, right_by_rank,
         lmatched, rmatched) = K.join_counts(lr, rr, nl, nr)
        jt = plan.join_type
        extra_l = jnp.int64(0)
        extra_r = jnp.int64(0)
        if jt in (lp.JoinType.LEFT, lp.JoinType.FULL):
            extra_l = jnp.sum(
                (~lmatched & K.live_mask(left.capacity, nl)).astype(jnp.int64)
            )
        if jt in (lp.JoinType.RIGHT, lp.JoinType.FULL):
            extra_r = jnp.sum(
                (~rmatched & K.live_mask(right.capacity, nr)).astype(jnp.int64)
            )
        return (lr, counts, rank_start, right_by_rank, lmatched, rmatched,
                total, extra_l, extra_r)

    def _exec_outer_join_residual(self, plan, left, right) -> ColumnBatch:
        """Outer join with a non-equi residual ON condition (PG: a pair
        matches only when the equi-keys AND the residual hold; an outer row
        whose every candidate pair fails the residual still emits once,
        NULL-padded — e.g. TPC-H Q13's `LEFT JOIN orders ON c_custkey =
        o_custkey AND o_comment NOT LIKE ...`). A post-join filter would
        wrongly drop those rows, so: run the inner match, filter the pairs
        by the residual, recompute the unmatched sets from the surviving
        pairs, and concatenate the NULL-padded blocks.

        Traceable residuals run as two fused cached programs (emit +
        residual + survivor counting, then compact + pad + gather) with
        one 3-int sync between them — the step path below is the fallback
        and the oracle."""
        import dataclasses

        jt = plan.join_type
        nl, nr = left.num_rows, right.num_rows
        inner = dataclasses.replace(
            plan, join_type=lp.JoinType.INNER, residual=None
        )
        state = self._join_count_pass(inner, left, right)
        (lr, counts, rank_start, right_by_rank, _lm, _rm,
         total_t, _el, _er) = state
        total = int(total_t)
        out_cap = padded_capacity(total)
        fused = self._outer_residual_fused(
            plan, left, right, state, total, out_cap
        )
        if fused is not None:
            return fused
        li, ri, valid = K.join_emit_inner(
            counts, rank_start, right_by_rank, lr, total, out_cap
        )
        pairs = self._assemble_join(
            plan, left, right, li, ri, valid, valid, total
        )
        keep = self.evaluator.eval_predicate_mask(plan.residual, pairs)
        keep = keep & (jnp.arange(out_cap) < total)
        kept = int(K.filter_count(keep, total))
        idx = K.compaction_indices(keep, total, padded_capacity(kept))
        blocks = [_take(pairs, idx, kept)]
        keep_i = keep.astype(jnp.int32)

        def pad_block(surv_count_plane, n_rows, n_pad_cap, is_left):
            surv = surv_count_plane > 0
            n_extra = int(n_rows - jnp.sum(surv))
            if n_extra == 0:
                return None
            ecap = padded_capacity(n_extra)
            u = K.compaction_indices(~surv, n_rows, ecap)
            pos = jnp.arange(ecap)
            present = pos < n_extra
            absent = jnp.zeros(ecap, dtype=bool)
            zeros = jnp.zeros(ecap, dtype=u.dtype)
            if is_left:
                return self._assemble_join(
                    plan, left, right, u, zeros, present, absent, n_extra
                )
            return self._assemble_join(
                plan, left, right, zeros, u, absent, present, n_extra
            )

        if jt in (lp.JoinType.LEFT, lp.JoinType.FULL):
            lsurv = jnp.zeros(nl + 1, jnp.int32).at[
                jnp.where(keep, li, nl)
            ].max(keep_i)[:nl]
            blocks.append(pad_block(lsurv, nl, out_cap, True))
        if jt in (lp.JoinType.RIGHT, lp.JoinType.FULL):
            rsurv = jnp.zeros(nr + 1, jnp.int32).at[
                jnp.where(keep, ri, nr)
            ].max(keep_i)[:nr]
            blocks.append(pad_block(rsurv, nr, out_cap, False))
        return ColumnBatch.concat([b for b in blocks if b is not None])

    def _outer_residual_fused(self, plan, left, right, state, total,
                              out_cap) -> Optional[ColumnBatch]:
        """Fused outer-residual join: program A emits the inner pairs,
        evaluates the residual on the joined planes, and counts surviving
        pairs + per-side unmatched rows; the host syncs three ints; program
        B compacts the kept pairs, appends the NULL-padded outer blocks,
        and gathers the output columns. Returns None (fall back to the
        step path) when the residual cannot live inside a traced program."""
        from query_engine_tpu.engine.pipeline import (
            _expr_key, _Unsupported, _expr_traceable,
        )

        if not _expr_traceable(plan.residual) or _expr_has_host_dependency(
            plan.residual
        ):
            return None
        try:
            rkey = _expr_key(plan.residual)
        except _Unsupported:
            return None
        jt = plan.join_type
        has_l = jt in (lp.JoinType.LEFT, lp.JoinType.FULL)
        has_r = jt in (lp.JoinType.RIGHT, lp.JoinType.FULL)
        lcap, rcap = left.capacity, right.capacity
        shape = (
            jt.value, rkey, out_cap, lcap, rcap,
            tuple(str(c.data.dtype) for c in left.columns),
            tuple(str(c.data.dtype) for c in right.columns),
            tuple(id(c.dictionary) for c in left.columns),
            tuple(id(c.dictionary) for c in right.columns),
        )
        evaluator = self.evaluator
        jschema = plan.out_schema
        dts = [c.dtype for c in left.columns] + [c.dtype for c in right.columns]
        dics = ([c.dictionary for c in left.columns]
                + [c.dictionary for c in right.columns])
        residual = plan.residual

        keyA = ("ojresA",) + shape
        fa = self._fused_cache.get(keyA)
        if fa is None:

            @jax.jit
            def fa(ld, lv, rd, rv, lr, counts, rank_start, right_by_rank,
                   total_t, nl, nr):
                li, ri, valid = K.join_emit_inner(
                    counts, rank_start, right_by_rank, lr, total_t, out_cap
                )
                gl_d, gl_v = K.gather_columns(ld, lv, li, valid)
                gr_d, gr_v = K.gather_columns(rd, rv, ri, valid)
                jb = _shim_batch(
                    jschema, list(gl_d) + list(gr_d),
                    list(gl_v) + list(gr_v), dts, dics,
                )
                keep = evaluator.eval_predicate_mask(residual, jb)
                keep = keep & valid & (
                    jnp.arange(out_cap, dtype=jnp.int64) < total_t
                )
                kept = jnp.sum(keep.astype(jnp.int64))
                keep_i = keep.astype(jnp.int32)
                surv_l = (
                    jnp.zeros(lcap + 1, jnp.int32)
                    .at[jnp.where(keep, li, lcap)].max(keep_i)[:lcap] > 0
                )
                surv_r = (
                    jnp.zeros(rcap + 1, jnp.int32)
                    .at[jnp.where(keep, ri, rcap)].max(keep_i)[:rcap] > 0
                )
                live_l = jnp.arange(lcap) < nl
                live_r = jnp.arange(rcap) < nr
                nxl = jnp.sum((live_l & ~surv_l).astype(jnp.int64))
                nxr = jnp.sum((live_r & ~surv_r).astype(jnp.int64))
                return li, ri, keep, surv_l, surv_r, kept, nxl, nxr

            self._fused_cache[keyA] = fa

        ld = [jnp.asarray(c.data) for c in left.columns]
        lv = [jnp.asarray(c.validity) for c in left.columns]
        rd = [jnp.asarray(c.data) for c in right.columns]
        rv = [jnp.asarray(c.validity) for c in right.columns]
        (lr, counts, rank_start, right_by_rank, _lm, _rm,
         total_t, _el, _er) = state
        try:
            li, ri, keep, surv_l, surv_r, kept_t, nxl_t, nxr_t = fa(
                ld, lv, rd, rv, lr, counts, rank_start, right_by_rank,
                np.int64(total), np.int64(left.num_rows),
                np.int64(right.num_rows),
            )
        except ExecutionError:
            return None
        kept = int(kept_t)
        nxl = int(nxl_t) if has_l else 0
        nxr = int(nxr_t) if has_r else 0
        out_rows = kept + nxl + nxr
        fcap = padded_capacity(out_rows)

        keyB = ("ojresB",) + shape + (fcap, has_l, has_r)
        fb = self._fused_cache.get(keyB)
        if fb is None:

            @jax.jit
            def fb(ld, lv, rd, rv, li, ri, keep, surv_l, surv_r, kept_t,
                   nxl_t, nxr_t, nl, nr):
                cidx = K.compaction_indices(keep, out_cap, fcap)
                pos = jnp.arange(fcap, dtype=jnp.int64)
                in_m = pos < kept_t
                li_f = li[cidx]
                ri_f = ri[cidx]
                lval = in_m
                rval = in_m
                if has_l:
                    ul = K.compaction_indices(
                        ~surv_l, nl, fcap
                    )
                    in_l = (pos >= kept_t) & (pos < kept_t + nxl_t)
                    sel = jnp.clip(pos - kept_t, 0, fcap - 1)
                    li_f = jnp.where(in_l, ul[sel], li_f)
                    lval = lval | in_l
                if has_r:
                    start = kept_t + nxl_t
                    ur = K.compaction_indices(
                        ~surv_r, nr, fcap
                    )
                    in_r = (pos >= start) & (pos < start + nxr_t)
                    sel = jnp.clip(pos - start, 0, fcap - 1)
                    ri_f = jnp.where(in_r, ur[sel], ri_f)
                    rval = rval | in_r
                gl_d, gl_v = K.gather_columns(ld, lv, li_f, lval)
                gr_d, gr_v = K.gather_columns(rd, rv, ri_f, rval)
                return tuple(gl_d), tuple(gl_v), tuple(gr_d), tuple(gr_v)

            self._fused_cache[keyB] = fb

        gl_d, gl_v, gr_d, gr_v = fb(
            ld, lv, rd, rv, li, ri, keep, surv_l, surv_r,
            np.int64(kept), np.int64(nxl), np.int64(nxr),
            np.int64(left.num_rows), np.int64(right.num_rows),
        )
        cols = [
            Column(d, v, c.dtype, c.dictionary)
            for d, v, c in zip(
                list(gl_d) + list(gr_d), list(gl_v) + list(gr_v),
                list(left.columns) + list(right.columns),
            )
        ]
        return ColumnBatch(plan.out_schema, cols, out_rows)

    def _assemble_join(
        self, plan, left, right, li, ri, lvalid, rvalid, num_rows
    ) -> ColumnBatch:
        ld = [jnp.asarray(c.data) for c in left.columns]
        lv = [jnp.asarray(c.validity) for c in left.columns]
        rd = [jnp.asarray(c.data) for c in right.columns]
        rv = [jnp.asarray(c.validity) for c in right.columns]
        gl_d, gl_v = K.gather_columns(ld, lv, li, lvalid)
        gr_d, gr_v = K.gather_columns(rd, rv, ri, rvalid)
        cols = [
            Column(d, v, c.dtype, c.dictionary)
            for d, v, c in zip(gl_d + gr_d, gl_v + gr_v,
                               list(left.columns) + list(right.columns))
        ]
        return ColumnBatch(plan.out_schema, cols, num_rows)

    # ---- aggregate -----------------------------------------------------
    def _exec_aggregate(self, plan: pp.PHashAggregate) -> ColumnBatch:
        batch = self.execute(plan.input)
        cap = batch.capacity
        schema = plan.schema()

        if plan.group_exprs:
            gvals = [self.evaluator.eval(g, batch) for g in plan.group_exprs]
            gid, ng, rep = self._group_ids_best(gvals, batch.num_rows)
            num_groups = int(ng)
        else:
            gvals = []
            gid = jnp.zeros(cap, dtype=jnp.int64)
            rep = jnp.zeros(cap, dtype=jnp.int64)
            num_groups = 1  # global aggregate: one row even on empty input

        out_cap = padded_capacity(num_groups)
        cols: List[Column] = []
        # group key columns at representative rows
        for v, f in zip(gvals, schema):
            d = v.data[rep][:out_cap]
            vd = v.validity[rep][:out_cap]
            cols.append(Column(d, vd, f.data_type, v.dictionary))

        fi = len(gvals)
        if plan.mode == "final":
            # input columns after the group keys are partial-aggregate planes
            # in agg order (avg contributes a sum + count pair)
            ci = len(plan.group_exprs)
            for agg in plan.agg_exprs:
                f = schema.field(fi)
                fi += 1
                if agg.func is lp.AggFunc.AVG:
                    s_col = batch.columns[ci]
                    c_col = batch.columns[ci + 1]
                    ci += 2
                    s, sv = K.segment_aggregate(
                        "sum", jnp.asarray(s_col.data),
                        jnp.asarray(s_col.validity), gid, batch.num_rows, cap,
                    )
                    c, _ = K.segment_aggregate(
                        "sum", jnp.asarray(c_col.data),
                        jnp.asarray(c_col.validity), gid, batch.num_rows, cap,
                    )
                    out_d = (s / jnp.maximum(c, 1).astype(jnp.float64))[:out_cap]
                    out_v = (sv & (c > 0))[:out_cap]
                    cols.append(Column(out_d, out_v, f.data_type, None))
                    continue
                col = batch.columns[ci]
                ci += 1
                combine = {
                    lp.AggFunc.COUNT: "sum",
                    lp.AggFunc.SUM: "sum",
                    lp.AggFunc.MIN: "min",
                    lp.AggFunc.MAX: "max",
                }[agg.func]
                vals, valid = K.segment_aggregate(
                    combine, jnp.asarray(col.data), jnp.asarray(col.validity),
                    gid, batch.num_rows, cap,
                )
                if agg.func is lp.AggFunc.COUNT:
                    valid = jnp.ones_like(valid)
                cols.append(
                    Column(vals[:out_cap], valid[:out_cap], f.data_type,
                           col.dictionary)
                )
            return ColumnBatch(schema, cols, num_groups)

        pct_sort_cache: dict = {}
        for agg in plan.agg_exprs:
            func = agg.func
            if agg.expr is None:
                fname = "count_star"
                data = validity = None
                arg_dict = None
            else:
                av = self.evaluator.eval(agg.expr, batch)
                if (
                    av.dtype.kind.name == "DECIMAL128"
                    and func is lp.AggFunc.AVG
                ):
                    from query_engine_tpu.engine.expr_eval import _descale

                    av = _descale(av)  # mean of scaled ints is not the mean
                data, validity, arg_dict = av.data, av.validity, av.dictionary
                fname = func.value.lower()
            distinct_first = None
            if (agg.distinct and agg.expr is not None
                    and func not in (lp.AggFunc.STRING_AGG,
                                     lp.AggFunc.ARRAY_AGG)):
                # the host-finalized aggregates dedup on the host — the
                # device flags would be wasted work
                distinct_first = K.distinct_first_flags(
                    [data], [validity], gid, batch.num_rows
                )
            if func in lp.ORDERED_SET_FNS:
                f = schema.field(fi)
                fi += 1
                out_d, out_v = self._grouped_percentile(
                    agg, data, validity, gid, batch.num_rows, cap, out_cap,
                    pct_sort_cache,
                )
                cols.append(Column(out_d[:out_cap], out_v[:out_cap],
                                   f.data_type, None))
                continue
            if func is lp.AggFunc.STRING_AGG:
                fi += 1
                cols.append(self._grouped_string_agg(
                    agg, av, gid, batch, cap, out_cap
                ))
                continue
            if func is lp.AggFunc.ARRAY_AGG:
                f = schema.field(fi)
                fi += 1
                cols.append(self._grouped_array_agg(
                    agg, av, gid, batch, cap, out_cap, f.data_type
                ))
                continue
            if plan.mode == "partial" and func is lp.AggFunc.AVG:
                s, sv = K.segment_aggregate(
                    "sum", data.astype(jnp.float64), validity, gid,
                    batch.num_rows, cap, distinct_first=distinct_first,
                )
                c, _ = K.segment_aggregate(
                    "count", data, validity, gid, batch.num_rows, cap,
                    distinct_first=distinct_first,
                )
                f_s = schema.field(fi)
                f_c = schema.field(fi + 1)
                fi += 2
                cols.append(Column(s[:out_cap], sv[:out_cap], f_s.data_type, None))
                cols.append(
                    Column(c[:out_cap], jnp.ones(out_cap, bool), f_c.data_type, None)
                )
                continue
            f = schema.field(fi)
            fi += 1
            if not plan.group_exprs and distinct_first is None:
                vals, valid = K.global_aggregate(
                    fname,
                    data if data is not None else jnp.zeros(cap, jnp.int64),
                    validity if validity is not None else jnp.ones(cap, bool),
                    batch.num_rows, out_cap,
                )
            else:
                vals, valid = K.segment_aggregate(
                    fname, data, validity, gid, batch.num_rows, cap,
                    distinct_first=distinct_first,
                )
            out_d = vals[:out_cap]
            out_v = valid[:out_cap]
            out_dict = (
                arg_dict
                if func in (lp.AggFunc.MIN, lp.AggFunc.MAX) and arg_dict is not None
                else None
            )
            if out_dict is not None:
                out_d = out_d.astype(jnp.int32)
            cols.append(Column(out_d, out_v, f.data_type, out_dict))

        return ColumnBatch(schema, cols, num_groups)

    def _grouped_percentile(self, agg, data, validity, gid, num_rows, cap,
                            out_cap, sort_cache=None):
        """Sort-based per-group quantile (PERCENTILE_CONT/DISC, MEDIAN):
        ONE two-key lax.sort orders live valid rows by (group, value);
        exclusive-scan group offsets + counts give each group's target
        position, then clipped gathers (plus a lerp for CONT) read the
        answer. O(n log n) in rows + O(G) — no per-group loops, so it maps
        onto lax.sort like every other sort here.

        PG semantics: CONT interpolates at frac*(c-1); DISC returns the
        first value whose cume_dist >= frac (1-based index ceil(frac*c)).
        DESC order mirrors the index from the other end.

        MODE(): most frequent value per group. Runs of equal (group, value)
        in the same sorted space give run lengths; one segment_max over a
        packed (length, tiebreak-position) key picks each group's winner —
        ties break to the FIRST value in the WITHIN GROUP order (PG)."""
        frac, desc = agg.param
        fn = agg.func
        # multiple quantiles over one column (P50/P90/P99 dashboards) share
        # ONE sorted space per (argument plane, value representation). The
        # cache entry keeps the keying arrays ALIVE — id() of a freed array
        # can be recycled for a different expression's planes
        ck = (id(data), id(validity), fn is lp.AggFunc.PERCENTILE_CONT)
        entry = sort_cache.get(ck) if sort_cache is not None else None
        hit = None if entry is None else entry[2]
        if hit is None:
            lm = K.live_mask(cap, num_rows)
            ok = lm & validity
            gkey = jnp.where(ok, gid.astype(jnp.int64), jnp.int64(out_cap))
            vals = (data.astype(jnp.float64)
                    if fn is lp.AggFunc.PERCENTILE_CONT else data)
            skey, sval = jax.lax.sort([gkey, vals], num_keys=2)
            cnt = jax.ops.segment_sum(
                ok.astype(jnp.int64), gkey, num_segments=out_cap + 1
            )[:out_cap]
            start = jnp.cumsum(cnt) - cnt
            hit = (skey, sval, cnt, start)
            if sort_cache is not None:
                sort_cache[ck] = (data, validity, hit)
        skey, sval, cnt, start = hit
        c = cnt
        if fn is lp.AggFunc.MODE:
            idx = jnp.arange(cap)
            rc = (idx == 0) | (skey != jnp.roll(skey, 1)) | (
                sval != jnp.roll(sval, 1)
            )
            run_start = jax.lax.cummax(
                jnp.where(rc, idx, 0).astype(jnp.int32)
            ).astype(jnp.int64)
            run_len = (K._seg_end_pos(rc).astype(jnp.int64) - run_start + 1)
            # pack (len, position tiebreak): ASC ties -> smallest value ->
            # earliest run; DESC -> largest value -> latest run
            big = jnp.int64(cap + 1)
            tie = run_start if desc else (cap - run_start)
            pack = run_len * big + tie
            best = jax.ops.segment_max(
                pack, skey, num_segments=out_cap + 1
            )[:out_cap]
            bs = (best % big) if desc else (cap - best % big)
            out = sval[jnp.clip(bs, 0, cap - 1)]
            return out, c > 0
        if fn is lp.AggFunc.PERCENTILE_CONT:
            fr = 1.0 - frac if desc else frac
            pos = fr * jnp.maximum(c - 1, 0).astype(jnp.float64)
            lo = jnp.floor(pos).astype(jnp.int64)
            hi = jnp.ceil(pos).astype(jnp.int64)
            w = pos - lo.astype(jnp.float64)
            vlo = sval[jnp.clip(start + lo, 0, cap - 1)]
            vhi = sval[jnp.clip(start + hi, 0, cap - 1)]
            out = vlo * (1.0 - w) + vhi * w
        else:
            k_ = jnp.ceil(frac * c.astype(jnp.float64)).astype(jnp.int64)
            k_ = jnp.clip(k_, 1, jnp.maximum(c, 1))
            idx = (c - k_) if desc else (k_ - 1)
            out = sval[jnp.clip(start + idx, 0, cap - 1)]
        return out, c > 0

    def _range_off_order_plane(self, wexpr, batch, perm):
        """Sorted raw ORDER BY key for a value-distance (RANGE offset)
        frame: exactly one numeric key; DESC negates so the kernel applies
        [k - s_off, k + e_off] uniformly."""
        if len(wexpr.order_by) != 1:
            raise ExecutionError(
                "RANGE offset frames require exactly one ORDER BY key"
            )
        k0 = wexpr.order_by[0]
        ov = self.evaluator.eval(k0.expr, batch)
        if ov.dictionary is not None or not (
            jnp.issubdtype(ov.data.dtype, jnp.integer)
            or jnp.issubdtype(ov.data.dtype, jnp.floating)
        ):
            raise ExecutionError(
                "RANGE offset frames require a numeric ORDER BY key"
            )
        return K.range_off_order_plane(
            ov.data[perm], ov.validity[perm], k0.asc,
            k0.resolved_nulls_first(),
        )

    def _agg_host_row_order(self, agg, batch, rows):
        """Order the host row indices of one order-sensitive aggregate by
        its in-call ORDER BY (ARRAY_AGG(x ORDER BY k)). Stable multi-pass
        sort from the last key to the first; None placement follows the
        resolved NULLS FIRST/LAST. Input order is kept when there is no
        ORDER BY (PG leaves it unspecified; input order is deterministic
        here)."""
        if not agg.order_by:
            return rows
        keys = []
        for k, _asc, _nf in agg.order_by:
            kv = self.evaluator.eval(k, batch)
            host = Column(
                np.asarray(kv.data), np.asarray(kv.validity), kv.dtype,
                kv.dictionary,
            )
            keys.append(host.to_pylist(int(kv.data.shape[0])))
        rows = list(rows)
        for (_, asc, nulls_first), vals in reversed(
            list(zip(agg.order_by, keys))
        ):
            nn = [i for i in rows if vals[i] is not None]
            nulls = [i for i in rows if vals[i] is None]
            nn.sort(key=lambda i: vals[i], reverse=not asc)
            rows = nulls + nn if nulls_first else nn + nulls
        return rows

    @staticmethod
    def _dedup_keep_order(vals):
        seen = set()
        out = []
        for v in vals:
            k = (v is None, v)
            if k not in seen:
                seen.add(k)
                out.append(v)
        return out

    def _grouped_string_agg(self, agg, av, gid, batch, cap, out_cap):
        """STRING_AGG([DISTINCT] expr, delim [ORDER BY k]): host
        finalization — one pass over the live rows' dictionary codes (PG
        leaves the order unspecified without an ORDER BY; input order is
        deterministic here). O(n log n) host work is acceptable: the
        output is a per-group STRING, inherently a host materialization."""
        from query_engine_tpu.core.types import DataType

        delim = agg.param[0]
        lm = K.live_mask(cap, batch.num_rows)
        ok = np.asarray(lm & av.validity)
        g = np.asarray(gid)
        codes = np.asarray(av.data)
        values = av.dictionary.values if av.dictionary is not None else []
        rows = self._agg_host_row_order(agg, batch, np.nonzero(ok)[0])
        parts: dict = {}
        for i in rows:
            gi = int(g[i])
            if 0 <= gi < out_cap:
                parts.setdefault(gi, []).append(values[int(codes[i])])
        out_strs = [None] * out_cap
        for gi, vs in parts.items():
            if agg.distinct:
                vs = self._dedup_keep_order(vs)
            out_strs[gi] = delim.join(vs)
        new_dict, new_codes = Dictionary.from_values(
            ["" if v is None else v for v in out_strs]
        )
        valid = np.array([v is not None for v in out_strs], dtype=bool)
        return Column(
            jnp.asarray(new_codes.astype(np.int32)), jnp.asarray(valid),
            DataType.utf8(), new_dict,
        )

    def _grouped_array_agg(self, agg, av, gid, batch, cap, out_cap, dtype):
        """ARRAY_AGG([DISTINCT] expr [ORDER BY k]) [FILTER (WHERE p)]:
        per-group Python lists; PG keeps NULL inputs (result is NULL only
        for zero-row groups / all-rows-filtered groups). FILTER excludes
        rows entirely (the CASE desugar used by other aggregates would
        surface them as NULL elements). The result column is a dictionary
        of Python list objects — the dictionary machinery already routes
        host objects through to_pylist/to_arrow; such a column is terminal
        output (not sortable/groupable)."""
        import numpy as np

        host_col = Column(
            np.asarray(av.data), np.asarray(av.validity), av.dtype,
            av.dictionary,
        )
        pyvals = host_col.to_pylist(cap)
        lm = np.asarray(K.live_mask(cap, batch.num_rows))
        if agg.filter is not None:
            fv = self.evaluator.eval(agg.filter, batch)
            lm = lm & np.asarray(fv.data & fv.validity)
        g = np.asarray(gid)
        rows = self._agg_host_row_order(agg, batch, np.nonzero(lm)[0])
        lists: dict = {}
        for i in rows:
            gi = int(g[i])
            if 0 <= gi < out_cap:
                lists.setdefault(gi, []).append(pyvals[i])
        values = np.empty(out_cap, dtype=object)
        valid = np.zeros(out_cap, dtype=bool)
        for gi, vs in lists.items():
            values[gi] = self._dedup_keep_order(vs) if agg.distinct else vs
            valid[gi] = True
        return Column(
            jnp.arange(out_cap, dtype=jnp.int32), jnp.asarray(valid),
            dtype, Dictionary(values),
        )

    # Direct (sort-free) grouping applies when there is a single integer or
    # dictionary group key whose value range is bounded — dictionary codes
    # always qualify; int columns qualify after a cheap min/max host sync.
    _DIRECT_GROUP_MAX_RANGE = 1 << 21

    def _group_ids_best(self, gvals, num_rows):
        """Returns (gid, ng, rep): direct grouping when a single bounded
        integer or dictionary key allows it, sort-based grouping otherwise."""
        if len(gvals) == 1:
            v = gvals[0]
            if v.dictionary is not None:
                nb = max(len(v.dictionary), 1)
                if nb <= self._DIRECT_GROUP_MAX_RANGE:
                    g, ng, rep = K.group_ids_direct(
                        v.data, v.validity, num_rows, 0, nb
                    )
                    return g, ng, rep
            elif jnp.issubdtype(v.data.dtype, jnp.integer) or v.data.dtype == jnp.bool_:
                data = v.data.astype(jnp.int32) if v.data.dtype == jnp.bool_ else v.data
                kmin, kmax, anyv = K.key_range(data, v.validity, num_rows)
                if bool(anyv):
                    lo, hi = int(kmin), int(kmax)
                    if hi - lo + 1 <= self._DIRECT_GROUP_MAX_RANGE:
                        g, ng, rep = K.group_ids_direct(
                            data, v.validity, num_rows, lo, hi - lo + 1
                        )
                        return g, ng, rep
        g, ng, rep = K.group_ids(
            [v.data for v in gvals], [v.validity for v in gvals], num_rows
        )
        return g, ng, rep

    # ---- sort / limit --------------------------------------------------
    def _sort_val_keys(
        self, keys: Sequence[lp.SortKey], batch: ColumnBatch
    ):
        datas, valids, ascs, nfs = [], [], [], []
        for k in keys:
            v = self.evaluator.eval(k.expr, batch)
            datas.append(v.data)
            valids.append(v.validity)
            ascs.append(k.asc)
            nfs.append(k.resolved_nulls_first())
        return datas, valids, ascs, nfs

    def _exec_sort(self, plan: pp.PSort) -> ColumnBatch:
        batch = self.execute(plan.input)
        datas, valids, ascs, nfs = self._sort_val_keys(plan.keys, batch)
        perm = K.sort_permutation(datas, valids, ascs, nfs, batch.num_rows)
        return _take(batch, perm, batch.num_rows)

    def _exec_limit(self, plan: pp.PLimit) -> ColumnBatch:
        # top-k fusion: LIMIT over a Sort gathers only the fetched window of
        # the permutation instead of materializing the full sorted batch
        if isinstance(plan.input, pp.PSort) and plan.fetch is not None:
            sort_plan = plan.input
            batch = self.execute(sort_plan.input)
            datas, valids, ascs, nfs = self._sort_val_keys(sort_plan.keys, batch)
            perm = K.sort_permutation(datas, valids, ascs, nfs, batch.num_rows)
            lo = min(plan.skip, batch.num_rows)
            hi = min(plan.skip + plan.fetch, batch.num_rows)
            window = np.asarray(perm[lo:hi])
            return batch.take_host(window)
        batch = self.execute(plan.input)
        fetch = plan.fetch if plan.fetch is not None else batch.num_rows
        return batch.slice(plan.skip, fetch)

    # ---- window --------------------------------------------------------
    def _exec_window(self, plan: pp.PWindow) -> ColumnBatch:
        batch = self.execute(plan.input)
        cap = batch.capacity
        n = batch.num_rows
        out_cols = list(batch.columns)
        schema = plan.schema()

        # one sort per distinct OVER spec, shared across window functions
        spec_cache = {}
        for wi, (wexpr, name) in enumerate(zip(plan.window_exprs, plan.names)):
            spec_key = (
                tuple(_expr_struct_key(p) for p in wexpr.partition_by),
                tuple(
                    (_expr_struct_key(k.expr), k.asc, k.resolved_nulls_first())
                    for k in wexpr.order_by
                ),
            )
            if spec_key in spec_cache:
                perm, seg_change, peer_change, seg = spec_cache[spec_key]
            else:
                part_vals = [
                    self.evaluator.eval(p, batch) for p in wexpr.partition_by
                ]
                order_keys = wexpr.order_by
                o_datas, o_valids, o_ascs, o_nfs = self._sort_val_keys(
                    order_keys, batch
                )
                p_datas = [v.data for v in part_vals]
                p_valids = [v.validity for v in part_vals]
                if not (p_datas or o_datas):
                    # OVER () — no partition, no order: constant key keeps
                    # live rows in input order as ONE partition
                    p_datas = [jnp.zeros(cap, jnp.int32)]
                    p_valids = [jnp.ones(cap, bool)]
                perm = K.sort_permutation(
                    p_datas + o_datas,
                    p_valids + o_valids,
                    [True] * len(p_datas) + o_ascs,
                    [False] * len(p_datas) + o_nfs,
                    n,
                )
                pad_sorted = jnp.arange(cap) >= n
                part_sorted = []
                for d, v in zip(p_datas, p_valids):
                    key, null = K.normalize_key(d[perm], v[perm])
                    part_sorted += [null.astype(jnp.int32), key]
                order_sorted = []
                for d, v in zip(o_datas, o_valids):
                    key, null = K.normalize_key(d[perm], v[perm])
                    order_sorted += [null.astype(jnp.int32), key]
                seg_change, peer_change, seg = K.window_segments(
                    part_sorted, order_sorted, pad_sorted
                )
                spec_cache[spec_key] = (perm, seg_change, peer_change, seg)

            fn = wexpr.func
            f = schema.field(len(batch.columns) + wi)
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
                n_tiles = self._const_int(wexpr.args[0], 1)
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
                av = self.evaluator.eval(wexpr.args[0], batch)
                sd, sv = av.data[perm], av.validity[perm]
                fdesc = classify_window_frame(
                    wexpr.frame, bool(wexpr.order_by)
                )
                oplane = (self._range_off_order_plane(wexpr, batch, perm)
                          if fdesc[0] == "range_off" else None)
                lo, hi = K.window_frame_bounds(
                    fdesc, seg_change, peer_change, pad_sorted, oplane
                )
                if fn is lp.WindowFn.FIRST_VALUE:
                    pos = lo
                elif fn is lp.WindowFn.LAST_VALUE:
                    pos = hi
                else:
                    nth = self._const_int(wexpr.args[1], 1)
                    if nth < 1:
                        raise ExecutionError(
                            "NTH_VALUE position must be >= 1"
                        )
                    pos = lo + (nth - 1)
                svals, svalid = K.value_at(sd, sv, pos)
                svalid = svalid & (pos <= hi) & (pos >= lo)
                out_dict = av.dictionary
            elif fn in (lp.WindowFn.LAG, lp.WindowFn.LEAD):
                av = self.evaluator.eval(wexpr.args[0], batch)
                offset = self._const_int(wexpr.args[1], 1) if len(wexpr.args) > 1 else 1
                if fn is lp.WindowFn.LEAD:
                    offset = -offset
                svals, svalid = K.shift_in_segment(
                    av.data[perm], av.validity[perm], seg, offset
                )
                if len(wexpr.args) > 2:
                    dv = self.evaluator.eval(wexpr.args[2], batch)
                    if av.dictionary is not None or dv.dictionary is not None:
                        raise ExecutionError(
                            "LAG/LEAD default over strings not supported yet"
                        )
                    svals = jnp.where(svalid, svals, dv.data[perm])
                    svalid = svalid | dv.validity[perm]
                out_dict = av.dictionary
            elif fn in _WINDOW_AGGS:
                if wexpr.args:
                    av = self.evaluator.eval(wexpr.args[0], batch)
                    if (
                        av.dtype.kind.name == "DECIMAL128"
                        and fn is lp.WindowFn.AVG
                    ):
                        from query_engine_tpu.engine.expr_eval import _descale

                        av = _descale(av)
                    vals, vok = av.data[perm], av.validity[perm]
                    if fn in (lp.WindowFn.MIN, lp.WindowFn.MAX):
                        out_dict = av.dictionary
                    fname = fn.value.lower()
                else:
                    vals = vok = None
                    fname = "count_star"
                fdesc = classify_window_frame(wexpr.frame, bool(wexpr.order_by))
                oplane = None
                if fdesc[0] == "range_off":
                    oplane = self._range_off_order_plane(wexpr, batch, perm)
                svals, svalid = K.window_aggregate_sorted(
                    fname, vals, vok, seg_change, peer_change, pad_sorted,
                    fdesc, order_plane=oplane,
                )
            else:
                raise ExecutionError(f"window function {fn.value} not implemented")

            # back to original row order via the inverse permutation:
            # one i32 scatter + gathers (half the bytes of i64)
            inv = (
                jnp.zeros(cap, dtype=jnp.int32)
                .at[perm].set(jnp.arange(cap, dtype=jnp.int32))
            )
            out_d = svals[inv]
            out_v = svalid[inv] & K.live_mask(cap, n)
            if out_dict is not None:
                out_d = out_d.astype(jnp.int32)
            out_cols.append(Column(out_d, out_v, f.data_type, out_dict))

        return ColumnBatch(schema, out_cols, n)

    @staticmethod
    def _const_int(e: lp.LogicalExpr, default: int) -> int:
        if isinstance(e, lp.Literal) and e.value.value is not None:
            return int(e.value.value)
        return default

    # ---- distinct / set ops --------------------------------------------
    def _exec_distinct(self, plan: pp.PDistinct) -> ColumnBatch:
        batch = self.execute(plan.input)
        if plan.on is not None:
            kvals = [self.evaluator.eval(e, batch) for e in plan.on]
            kd = [v.data for v in kvals]
            kv = [v.validity for v in kvals]
        else:
            kd = [jnp.asarray(c.data) for c in batch.columns]
            kv = [jnp.asarray(c.validity) for c in batch.columns]
        gid, ng, rep = K.group_ids(kd, kv, batch.num_rows)
        num_groups = int(ng)
        cap = batch.capacity
        first_mask = jnp.zeros(cap, dtype=bool).at[
            jnp.where(jnp.arange(cap) < num_groups, rep, cap)
        ].set(True, mode="drop")
        count = num_groups
        out_cap = padded_capacity(count)
        idx = K.compaction_indices(first_mask, batch.num_rows, out_cap)
        return _take(batch, idx, count)

    def _exec_setop(self, plan: pp.PSetOp) -> ColumnBatch:
        left = self.execute(plan.left)
        right = self.execute(plan.right)
        right = ColumnBatch(left.schema, right.columns, right.num_rows)
        if plan.kind in (lp.SetOpKind.UNION, lp.SetOpKind.UNION_ALL):
            # UNION dedup is applied by the Distinct node the planner adds
            return ColumnBatch.concat([left, right])
        # INTERSECT / EXCEPT: set semantics with NULLs equal, dedup left
        lcols = []
        rcols = []
        for ci in range(left.num_columns):
            lc, rc = left.columns[ci], right.columns[ci]
            lval = Val(jnp.asarray(lc.data), jnp.asarray(lc.validity),
                       lc.dtype, lc.dictionary)
            rval = Val(jnp.asarray(rc.data), jnp.asarray(rc.validity),
                       rc.dtype, rc.dictionary)
            if lc.dictionary is not None or rc.dictionary is not None:
                lval, rval = unify_dicts(lval, rval)
            lcols.append((lval.data, lval.validity))
            rcols.append((rval.data, rval.validity))
        lr, rr = K.join_ranks(
            lcols, rcols, left.num_rows, right.num_rows, null_equal=True
        )
        member = K.rank_member(
            lr, rr, K.live_mask(right.capacity, right.num_rows)
        )
        keep = member if plan.kind is lp.SetOpKind.INTERSECT else ~member
        count = int(K.filter_count(keep, left.num_rows))
        out_cap = padded_capacity(count)
        idx = K.compaction_indices(keep, left.num_rows, out_cap)
        filtered = _take(left, idx, count)
        # set ops return distinct rows
        return self._exec_distinct(pp.PDistinct(_Materialized(filtered)))

    # ---- values --------------------------------------------------------
    def _exec_values(self, plan: pp.PValues) -> ColumnBatch:
        schema = plan.out_schema
        n = len(plan.rows)
        data = {f.name: [] for f in schema}
        one = ColumnBatch(Schema([]), [], 1)
        for row in plan.rows:
            for f, e in zip(schema, row):
                v = self.evaluator.eval(e, one)
                if v.dictionary is not None:
                    vals = v.dictionary.decode(np.asarray(v.data[:1]))
                    data[f.name].append(
                        vals[0] if bool(np.asarray(v.validity[0])) else None
                    )
                else:
                    val = np.asarray(v.data[:1])[0]
                    data[f.name].append(
                        val.item() if bool(np.asarray(v.validity[0])) else None
                    )
        return ColumnBatch.from_pydict(data, schema)


class _Materialized(pp.PhysicalPlan):
    """Wraps an already-computed batch as a plan node (internal reuse)."""

    def __init__(self, batch: ColumnBatch):
        self.batch = batch

    def schema(self) -> Schema:
        return self.batch.schema
