"""Vectorized expression evaluation over a ColumnBatch.

Parity surface: reference crates/query-executor/src/operators.rs:13-848 —
evaluate_expr over Arrow kernels: arithmetic with per-type dispatch
(:382-507), comparisons with numeric coercion (:509-538,616-675), and/or/not
(:539-570), `@@` full-text match (:571-611), literal broadcast (:322-347),
scalar functions (:64-319).

Device-side evaluation: every result is (device data plane, device validity
plane, optional host dictionary). Numeric work happens on-device in jnp;
string transforms run once per *dictionary value* on the host (dictionaries
are tiny relative to row counts), producing remap planes the device gathers —
so string UPPER/LOWER/LIKE over a billion rows costs one gather.

Null semantics: SQL three-valued logic. Comparisons with NULL are NULL;
AND/OR follow Kleene logic; predicates treat NULL as false at filter time.
"""

from __future__ import annotations

import json as _json
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from query_engine_tpu.core.errors import ExecutionError
from query_engine_tpu.core.types import DataType, TypeKind
from query_engine_tpu.columnar.batch import ColumnBatch
from query_engine_tpu.columnar.dictionary import Dictionary
from query_engine_tpu.plan import logical as lp
from query_engine_tpu.ops import kernels as K


@dataclass
class Val:
    """An evaluated column: device planes + optional dictionary."""

    data: jnp.ndarray
    validity: jnp.ndarray
    dtype: DataType
    dictionary: Optional[Dictionary] = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


def _bcast(value, dtype: DataType, capacity: int) -> Val:
    if value is None:
        return Val(
            jnp.zeros(capacity, dtype=jnp.int64),
            jnp.zeros(capacity, dtype=bool),
            dtype if dtype.kind is not TypeKind.NULL else DataType.null(),
        )
    if dtype.is_dictionary or isinstance(value, str):
        d, codes = Dictionary.from_values([value])
        return Val(
            jnp.zeros(capacity, dtype=jnp.int32),
            jnp.ones(capacity, dtype=bool),
            DataType.utf8(),
            d,
        )
    if isinstance(value, bool):
        return Val(
            jnp.full(capacity, value, dtype=bool),
            jnp.ones(capacity, dtype=bool),
            DataType.boolean(),
        )
    if isinstance(value, int) and not dtype.is_float:
        return Val(
            jnp.full(capacity, value, dtype=jnp.int64),
            jnp.ones(capacity, dtype=bool),
            DataType.int64(),
        )
    return Val(
        jnp.full(capacity, float(value), dtype=jnp.float64),
        jnp.ones(capacity, dtype=bool),
        DataType.float64(),
    )


def unify_dicts(a: Val, b: Val) -> Tuple[Val, Val]:
    """Remap two dictionary-encoded values onto a merged dictionary so code
    comparison == string comparison (dictionaries are sorted)."""
    da = a.dictionary or Dictionary.empty()
    db = b.dictionary or Dictionary.empty()
    merged, ra, rb = da.merge(db)
    ra_j = jnp.asarray(ra if len(ra) else np.zeros(1, np.int32))
    rb_j = jnp.asarray(rb if len(rb) else np.zeros(1, np.int32))
    a2 = Val(
        ra_j[jnp.clip(a.data, 0, max(len(da) - 1, 0))], a.validity, a.dtype, merged
    )
    b2 = Val(
        rb_j[jnp.clip(b.data, 0, max(len(db) - 1, 0))], b.validity, b.dtype, merged
    )
    return a2, b2


def _dict_map_host(v: Val, fn, out_dtype: DataType = None) -> Val:
    """Apply a host string fn per dictionary value, remap codes on device."""
    d = v.dictionary or Dictionary.empty()
    new_dict, remap = d.map_values(fn)
    remap_j = jnp.asarray(remap if len(remap) else np.zeros(1, np.int32))
    codes = remap_j[jnp.clip(v.data, 0, max(len(d) - 1, 0))]
    return Val(codes, v.validity, out_dtype or v.dtype, new_dict)


def _dict_map_host_nullable(v: Val, fn, out_dtype: DataType = None) -> Val:
    """Like _dict_map_host, but fn may return None -> the row goes NULL
    (JSON extraction of a missing field, malformed document, ...)."""
    d = v.dictionary or Dictionary.empty()
    outs = [fn(x) for x in d.values]
    null = np.asarray([o is None for o in outs], dtype=bool)
    new_dict, codes = Dictionary.from_values(
        ["" if o is None else o for o in outs])
    remap_j = jnp.asarray(codes if len(codes) else np.zeros(1, np.int32))
    null_j = jnp.asarray(null if len(null) else np.zeros(1, bool))
    old = jnp.clip(v.data, 0, max(len(d) - 1, 0))
    return Val(remap_j[old], v.validity & ~null_j[old],
               out_dtype or v.dtype, new_dict)


def _all_null_val(capacity: int, dtype: DataType) -> Val:
    """All-NULL column of the given dtype (strict fns over NULL input)."""
    if dtype.is_dictionary or dtype.kind is TypeKind.UTF8:
        d, _ = Dictionary.from_values([""])
        return Val(jnp.zeros(capacity, jnp.int32),
                   jnp.zeros(capacity, bool), DataType.utf8(), d)
    return Val(jnp.zeros(capacity, jnp.int64),
               jnp.zeros(capacity, bool), dtype)


def _static_json_key(node):
    """Literal (or negated numeric literal) key of a JSON operator."""
    if isinstance(node, lp.Literal):
        return node.value.value
    if isinstance(node, lp.UnaryExpr) and node.op is lp.UnOp.NEG and \
            isinstance(node.expr, lp.Literal) and \
            isinstance(node.expr.value.value, (int, float)):
        return -node.expr.value.value
    return None


_JSON_MISSING = object()


def _json_step(doc, key):
    if isinstance(doc, dict):
        return doc.get(str(key), _JSON_MISSING)
    if isinstance(doc, list):
        try:
            i = int(key)
        except (TypeError, ValueError):
            return _JSON_MISSING
        if -len(doc) <= i < len(doc):
            return doc[i]  # negative indexes wrap from the end (PG)
        return _JSON_MISSING
    return _JSON_MISSING


def _json_extract(s: str, keys, as_text: bool):
    """PG -> / ->> / #> / #>> semantics over one document. Malformed json
    yields NULL (PG raises; NULL keeps the vectorized path total — the same
    documented deviation as div-by-zero)."""
    try:
        doc = _json.loads(s)
    except Exception:  # noqa: BLE001
        return None
    for k in keys:
        doc = _json_step(doc, k)
        if doc is _JSON_MISSING:
            return None
    if as_text:
        if doc is None:
            return None  # json null ->> SQL NULL
        if isinstance(doc, str):
            return doc  # unquoted
        if isinstance(doc, bool):
            return "true" if doc else "false"
        return _json.dumps(doc)
    return _json.dumps(doc)


def _json_array_length(s: str):
    try:
        doc = _json.loads(s)
    except Exception:  # noqa: BLE001
        return None
    return len(doc) if isinstance(doc, list) else None  # PG errors -> NULL


def _json_typeof(s: str):
    try:
        doc = _json.loads(s)
    except Exception:  # noqa: BLE001
        return None
    if doc is None:
        return "null"
    if isinstance(doc, bool):
        return "boolean"
    if isinstance(doc, (int, float)):
        return "number"
    if isinstance(doc, str):
        return "string"
    return "array" if isinstance(doc, list) else "object"


def _dict_lookup_host(v: Val, fn, np_dtype, out_dtype: DataType) -> Val:
    """Compute a host value per dictionary entry, gather by code on device
    (e.g. LENGTH: one strlen per distinct string, one gather per row)."""
    d = v.dictionary or Dictionary.empty()
    table = np.asarray([fn(x) for x in d.values], dtype=np_dtype)
    if len(table) == 0:
        table = np.zeros(1, dtype=np_dtype)
    t_j = jnp.asarray(table)
    return Val(
        t_j[jnp.clip(v.data, 0, max(len(d) - 1, 0))], v.validity, out_dtype
    )


def _tokenize_tsvector(s: str) -> str:
    """Reference to_tsvector parity (operators.rs:261-286): split on
    non-alphanumeric, sort (pre-lowercase order!), dedup, lowercase, join."""
    tokens = sorted(w for w in re.split(r"[^0-9A-Za-z]+", s) if w)
    # rust dedup() removes only consecutive dups after sort -> set-like
    dedup = []
    for t in tokens:
        if not dedup or dedup[-1] != t:
            dedup.append(t)
    return " ".join(t.lower() for t in dedup)


def _normalize_tsquery(s: str) -> str:
    """Reference to_tsquery parity (operators.rs:290-315)."""
    return " ".join(
        t if t in ("&", "|", "!") else t.lower() for t in s.split()
    )


def _ts_match(doc: str, query: str) -> bool:
    """Reference @@ parity (operators.rs:571-611): all non-operator,
    non-!-prefixed terms must appear in the doc's whitespace token set."""
    doc_tokens = set(doc.split())
    terms = [
        t for t in query.split() if t not in ("&", "|") and not t.startswith("!")
    ]
    return all(t in doc_tokens for t in terms)


def _like_to_regex(pattern: str, case_insensitive: bool) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile(
        "^" + "".join(out) + "$", re.IGNORECASE if case_insensitive else 0
    )


def _similar_to_regex(pattern: str) -> str:
    """SQL SIMILAR TO pattern -> Python regex source. The SQL dialect keeps
    regex metachars | * + ? {m,n} ( ) [ ... ] but adds %/_ wildcards and
    treats . ^ $ as LITERAL characters; % and _ inside a bracket class stay
    literal (PG pattern-matching docs, 9.7.2)."""
    out = []
    i, n = 0, len(pattern)
    in_class = False
    while i < n:
        ch = pattern[i]
        if in_class:
            out.append(ch)
            if ch == "\\" and i + 1 < n:
                out.append(pattern[i + 1])
                i += 1
            elif ch == "]":
                in_class = False
        elif ch == "\\" and i + 1 < n:
            # escaped char is literal (PG default escape is backslash)
            out.append(re.escape(pattern[i + 1]))
            i += 1
        elif ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        elif ch in ".^$":
            out.append("\\" + ch)
        elif ch == "[":
            out.append(ch)
            in_class = True
        else:
            out.append(ch)
        i += 1
    return "".join(out)


def _parse_temporal(text: str, kind: TypeKind):
    import datetime

    try:
        if kind is TypeKind.DATE32:
            d = datetime.date.fromisoformat(text)
            return (d - datetime.date(1970, 1, 1)).days
        dt = datetime.datetime.fromisoformat(text)
        us = int((dt - datetime.datetime(1970, 1, 1)).total_seconds() * 1e6)
        return us if kind is TypeKind.TIMESTAMP else us // 1000
    except ValueError:
        return None


def _coerce_temporal_literal(l: "Val", r: "Val"):
    """If one side is a temporal column and the other a single-string
    dictionary (a literal), parse the literal into the temporal lane."""
    for a, b, flip in ((l, r, False), (r, l, True)):
        if (
            a.dtype.is_temporal
            and b.dictionary is not None
            and len(b.dictionary) == 1
        ):
            parsed = _parse_temporal(b.dictionary.values[0], a.dtype.kind)
            if parsed is not None:
                lit = Val(
                    jnp.full(b.capacity, parsed, dtype=a.data.dtype),
                    b.validity, a.dtype,
                )
                return (l, lit) if not flip else (lit, r)
    return l, r


# ---------------------------------------------------------------------------
# temporal math (vectorized civil-date algorithms; Howard Hinnant's
# days<->civil, exact for the whole proleptic Gregorian calendar; floor
# division makes the era adjustments unconditional)
# ---------------------------------------------------------------------------

_US_DAY = 86_400_000_000


def _civil_from_days(days: jnp.ndarray):
    """days since 1970-01-01 -> (year, month, day), vectorized."""
    z = days.astype(jnp.int64) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = jnp.where(mp < 10, mp + 3, mp - 9)
    y = jnp.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y: jnp.ndarray, m: jnp.ndarray, d: jnp.ndarray):
    y = y - (m <= 2)
    era = y // 400
    yoe = y - era * 400
    mp = jnp.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _temporal_split(v: "Val"):
    """-> (days since epoch int64, intra-day microseconds int64)."""
    k = v.dtype.kind
    data = v.data.astype(jnp.int64)
    if k is TypeKind.DATE32:
        return data, jnp.zeros_like(data)
    if k is TypeKind.DATE64:
        days = data // 86_400_000
        return days, (data - days * 86_400_000) * 1000
    # TIMESTAMP: microseconds
    days = data // _US_DAY
    return days, data - days * _US_DAY


def _dec_scale(t: DataType) -> int:
    return t.params[1] if t.params else 0


def _descale(v: "Val") -> "Val":
    """Decimal scaled-int plane -> float64 value plane."""
    s = _dec_scale(v.dtype)
    return Val(
        v.data.astype(jnp.float64) / (10.0 ** s), v.validity,
        DataType.float64(),
    )


def _coerce_decimals(op, l: "Val", r: "Val"):
    """Scale-aware decimal arithmetic/comparison (the stored lane is an
    int64 scaled by 10^scale). Division or a float operand descales to
    float64; otherwise both sides become int64 planes at the RESULT scale
    (max for add/sub/mod/compare; untouched for mul, whose scales add) so
    the generic integer path computes the correctly-scaled plane."""
    l_dec = l.dtype.kind is TypeKind.DECIMAL128
    r_dec = r.dtype.kind is TypeKind.DECIMAL128
    if not (l_dec or r_dec):
        return l, r
    if op is lp.BinOp.DIV or l.dtype.is_float or r.dtype.is_float:
        return (_descale(l) if l_dec else l), (_descale(r) if r_dec else r)
    s1 = _dec_scale(l.dtype) if l_dec else 0
    s2 = _dec_scale(r.dtype) if r_dec else 0
    if op is lp.BinOp.MUL:
        tgt1, tgt2 = s1, s2  # result scale = s1 + s2, no rescaling needed
    else:
        tgt1 = tgt2 = max(s1, s2)

    def rescale(v, frm, to):
        d = v.data.astype(jnp.int64)
        if to > frm:
            d = d * (10 ** (to - frm))
        return Val(d, v.validity, DataType.int64())

    return rescale(l, s1, tgt1), rescale(r, s2, tgt2)


_ARITH = {lp.BinOp.ADD, lp.BinOp.SUB, lp.BinOp.MUL, lp.BinOp.DIV, lp.BinOp.MOD}
_CMP = {lp.BinOp.EQ, lp.BinOp.NEQ, lp.BinOp.LT, lp.BinOp.LTE, lp.BinOp.GT, lp.BinOp.GTE}


class Evaluator:
    """Evaluates LogicalExprs over a batch. `subquery_exec` is a callback
    (physical plan -> ColumnBatch) supplied by the query executor."""

    def __init__(self, subquery_exec=None, udfs=None, params=None):
        self.subquery_exec = subquery_exec
        self.udfs = udfs
        # per-query reuse of the (outer keys x shared subplan keys)
        # rank-match: multiple CorrelatedLookupExprs rooted at one shared
        # aggregate (membership + MIN/MAX bounds) match identical key sets,
        # so row/found compute once. Session clears this per query.
        self._corr_match_memo = {}
        # trace-time map id(Literal) -> traced scalar (compiled pipelines
        # parameterize eligible literals so programs are value-independent)
        self._dyn_literals = None
        # trace-time map id(subplan) -> shim batch of traced planes
        # (compiled pipelines feed materialized subquery results in as
        # leaves, so subquery predicates evaluate inside the program)
        self._subplans = None

    # ---- public --------------------------------------------------------
    def eval(self, e: lp.LogicalExpr, batch: ColumnBatch) -> Val:
        cap = batch.capacity
        if isinstance(e, lp.ColumnRef):
            col = batch.columns[e.index]
            return Val(
                jnp.asarray(col.data), jnp.asarray(col.validity),
                e.dtype, col.dictionary,
            )
        if isinstance(e, lp.Literal):
            if self._dyn_literals is not None:
                dv = self._dyn_literals.get(id(e))
                if dv is not None:
                    dt = {
                        "b": DataType.boolean(), "i": DataType.int64(),
                        "f": DataType.float64(),
                    }[dv.dtype.kind]
                    return Val(
                        jnp.full(cap, dv), jnp.ones(cap, dtype=bool), dt
                    )
            return _bcast(e.value.value, e.value.dtype, cap)
        if isinstance(e, lp.AliasExpr):
            return self.eval(e.expr, batch)
        if isinstance(e, lp.BinaryExpr):
            return self._eval_binary(e, batch)
        if isinstance(e, lp.UnaryExpr):
            v = self.eval(e.expr, batch)
            if e.op is lp.UnOp.NOT:
                return Val(~v.data.astype(bool), v.validity, DataType.boolean())
            return Val(-v.data, v.validity, v.dtype)
        if isinstance(e, lp.CastExpr):
            return self._eval_cast(e, batch)
        if isinstance(e, lp.ScalarFnExpr):
            return self._eval_scalar_fn(e, batch)
        if isinstance(e, lp.UdfExpr):
            return self._eval_udf(e, batch)
        if isinstance(e, lp.CaseExpr):
            return self._eval_case(e, batch)
        if isinstance(e, lp.InListExpr):
            return self._eval_in_list(e, batch)
        if isinstance(e, lp.IsNullExpr):
            v = self.eval(e.expr, batch)
            data = v.validity if e.negated else ~v.validity
            return Val(data, jnp.ones(cap, dtype=bool), DataType.boolean())
        if isinstance(e, lp.ScalarSubqueryExpr):
            return self._eval_scalar_subquery(e, batch)
        if isinstance(e, lp.InSubqueryExpr):
            return self._eval_in_subquery(e, batch)
        if isinstance(e, lp.QuantifiedCmpExpr):
            return self._eval_quantified_cmp(e, batch)
        if isinstance(e, lp.ExistsExpr):
            return self._eval_exists(e, batch)
        if isinstance(e, lp.CorrelatedLookupExpr):
            return self._eval_correlated_lookup(e, batch)
        if isinstance(e, lp.AggregateExpr):
            raise ExecutionError(
                "aggregate expression outside aggregation context"
            )
        raise ExecutionError(f"cannot evaluate {type(e).__name__}")

    def eval_predicate_mask(self, e: lp.LogicalExpr, batch: ColumnBatch):
        """Predicate -> boolean mask; NULL -> excluded (SQL WHERE)."""
        v = self.eval(e, batch)
        return v.data.astype(bool) & v.validity

    # ---- binary --------------------------------------------------------
    def _eval_binary(self, e: lp.BinaryExpr, batch: ColumnBatch) -> Val:
        op = e.op
        if op in (lp.BinOp.AND, lp.BinOp.OR):
            l = self.eval(e.left, batch)
            r = self.eval(e.right, batch)
            ld, rd = l.data.astype(bool), r.data.astype(bool)
            if op is lp.BinOp.AND:
                data = ld & rd
                # Kleene: false AND anything = false (valid)
                valid = (l.validity & r.validity) | (l.validity & ~ld) | (
                    r.validity & ~rd
                )
            else:
                data = ld | rd
                valid = (l.validity & r.validity) | (l.validity & ld) | (
                    r.validity & rd
                )
            return Val(data, valid, DataType.boolean())

        if op in (lp.BinOp.ADD, lp.BinOp.SUB) and (
            isinstance(e.left, lp.IntervalLiteral)
            or isinstance(e.right, lp.IntervalLiteral)
        ):
            return self._eval_temporal_interval(e, batch)

        l = self.eval(e.left, batch)
        r = self.eval(e.right, batch)

        if op is lp.BinOp.TS_MATCH:
            return self._eval_ts_match(l, r, batch)
        if op in (lp.BinOp.LIKE, lp.BinOp.ILIKE, lp.BinOp.NOT_LIKE,
                  lp.BinOp.NOT_ILIKE) or op in lp._REGEX_OPS:
            return self._eval_like(l, r, op)
        if op is lp.BinOp.CONCAT:
            return self._eval_concat([l, r], batch)
        if op in lp._JSON_OPS:
            return self._eval_json_get(e, l, op)

        valid = l.validity & r.validity
        # temporal column vs string literal: parse the literal as a date/
        # timestamp so WHERE d > '2024-01-01' works
        l, r = _coerce_temporal_literal(l, r)
        l, r = _coerce_decimals(op, l, r)
        if l.dictionary is not None or r.dictionary is not None:
            # string comparison via merged sorted dictionary -> code compare
            if op not in _CMP:
                raise ExecutionError(
                    f"operator {op.value} not valid for strings"
                )
            l2, r2 = unify_dicts(l, r)
            ld, rd = l2.data, r2.data
        elif op in _CMP or op in _ARITH:
            if l.dtype.is_float or r.dtype.is_float:
                ld = l.data.astype(jnp.float64)
                rd = r.data.astype(jnp.float64)
            elif l.dtype.kind is TypeKind.BOOLEAN and r.dtype.kind is TypeKind.BOOLEAN:
                ld, rd = l.data, r.data
            else:
                ld = l.data.astype(jnp.int64)
                rd = r.data.astype(jnp.int64)
        else:
            ld, rd = l.data, r.data

        if op in _CMP:
            fn = {
                lp.BinOp.EQ: jnp.equal,
                lp.BinOp.NEQ: jnp.not_equal,
                lp.BinOp.LT: jnp.less,
                lp.BinOp.LTE: jnp.less_equal,
                lp.BinOp.GT: jnp.greater,
                lp.BinOp.GTE: jnp.greater_equal,
            }[op]
            return Val(fn(ld, rd), valid, DataType.boolean())

        # arithmetic
        if op is lp.BinOp.ADD:
            data = ld + rd
        elif op is lp.BinOp.SUB:
            data = ld - rd
        elif op is lp.BinOp.MUL:
            data = ld * rd
        elif op is lp.BinOp.DIV:
            if jnp.issubdtype(ld.dtype, jnp.integer):
                # SQL integer division truncates toward zero (Arrow/PG);
                # div-by-zero yields NULL (PG raises; NULL keeps the
                # vectorized path total — documented deviation)
                zero = rd == 0
                data = jnp.where(zero, 0, ld) // jnp.where(zero, 1, rd)
                neg = (ld < 0) ^ (rd < 0)
                rem = jnp.where(zero, 0, ld) % jnp.where(zero, 1, rd)
                data = jnp.where(neg & (rem != 0), data + 1, data)
                valid = valid & ~zero
            else:
                zero = rd == 0.0
                data = ld / jnp.where(zero, 1.0, rd)
                valid = valid & ~zero
        elif op is lp.BinOp.MOD:
            zero = rd == 0
            safe_r = jnp.where(zero, 1, rd)
            data = ld % safe_r
            # Python % floors; SQL/C % truncates (sign follows dividend)
            data = jnp.where(
                (data != 0) & (jnp.sign(data) != jnp.sign(ld)),
                data - safe_r, data,
            )
            valid = valid & ~zero
        else:
            raise ExecutionError(f"unhandled operator {op.value}")
        return Val(data, valid, e.dtype)

    def _eval_temporal_interval(self, e: lp.BinaryExpr, batch) -> Val:
        """date/timestamp +/- INTERVAL literal. Months use calendar math
        with day-of-month clamping (Jan 31 + 1 month = Feb 28/29, like PG);
        days and sub-day micros are direct."""
        if isinstance(e.right, lp.IntervalLiteral):
            tv = self.eval(e.left, batch)
            iv = e.right
            sign = 1 if e.op is lp.BinOp.ADD else -1
        else:
            if e.op is lp.BinOp.SUB:
                raise ExecutionError("cannot subtract a timestamp from an interval")
            tv = self.eval(e.right, batch)
            iv = e.left
            sign = 1
        if not tv.dtype.is_temporal:
            raise ExecutionError(
                f"interval arithmetic needs a date/timestamp, got {tv.dtype}"
            )
        k = tv.dtype.kind
        if k is TypeKind.DATE32 and iv.micros:
            raise ExecutionError(
                "date +/- sub-day interval: cast the date to TIMESTAMP first"
            )
        days, tod = _temporal_split(tv)
        m, d, us = iv.months * sign, iv.days * sign, iv.micros * sign
        if m:
            y, mo, dd = _civil_from_days(days)
            t = y * 12 + (mo - 1) + m
            y2 = t // 12
            mo2 = t % 12 + 1
            nxt_y = jnp.where(mo2 == 12, y2 + 1, y2)
            nxt_m = jnp.where(mo2 == 12, 1, mo2 + 1)
            one = jnp.ones_like(y2)
            dim = _days_from_civil(nxt_y, nxt_m, one) - _days_from_civil(
                y2, mo2, one
            )
            days = _days_from_civil(y2, mo2, jnp.minimum(dd, dim))
        days = days + d
        tod = tod + us
        extra = tod // _US_DAY
        days = days + extra
        tod = tod - extra * _US_DAY
        if k is TypeKind.DATE32:
            return Val(days.astype(jnp.int32), tv.validity, tv.dtype)
        if k is TypeKind.DATE64:
            return Val(days * 86_400_000 + tod // 1000, tv.validity, tv.dtype)
        return Val(days * _US_DAY + tod, tv.validity, tv.dtype)

    def _eval_json_get(self, e: "lp.BinaryExpr", l: Val, op) -> Val:
        """-> / ->> / #> / #>> : per-dictionary-value extraction (one
        json.loads per DISTINCT document, one gather per row). The key must
        be a literal so the extraction table is static — this also makes
        the operator traceable inside compiled pipelines (the table is
        built at trace time, only the code remap gather is traced)."""
        key = _static_json_key(e.right)
        if key is None:
            raise ExecutionError(
                f"the right side of {op.value} must be a non-null string or "
                "integer literal")
        if l.dictionary is None:
            raise ExecutionError(
                f"operator {op.value} requires a json (string) left operand")
        if op in (lp.BinOp.JSON_PATH, lp.BinOp.JSON_PATH_TEXT):
            keys = [p.strip().strip('"')
                    for p in str(key).strip().lstrip("{").rstrip("}").split(",")
                    if p.strip() != ""]
        else:
            keys = [key]
        as_text = op in (lp.BinOp.JSON_GET_TEXT, lp.BinOp.JSON_PATH_TEXT)
        return _dict_map_host_nullable(
            l, lambda s: _json_extract(s, keys, as_text), DataType.utf8())

    def _eval_ts_match(self, l: Val, r: Val, batch: ColumnBatch) -> Val:
        if l.dictionary is None or r.dictionary is None:
            raise ExecutionError("@@ requires string operands")
        # evaluate match per (doc_code, query_code) pair; query dict is
        # usually a single literal, so this is |doc_dict| host checks
        dl, dr = l.dictionary, r.dictionary
        if len(dr) == 1:
            q = dr.values[0]
            table = np.asarray([_ts_match(doc, q) for doc in dl.values], dtype=bool)
            if len(table) == 0:
                table = np.zeros(1, bool)
            data = jnp.asarray(table)[jnp.clip(l.data, 0, max(len(dl) - 1, 0))]
        else:
            # general case: host per-row
            docs = dl.decode(np.asarray(l.data))
            queries = dr.decode(np.asarray(r.data))
            data = jnp.asarray(
                np.asarray(
                    [_ts_match(d, q) for d, q in zip(docs, queries)], dtype=bool
                )
            )
        return Val(data, l.validity & r.validity, DataType.boolean())

    def _eval_like(self, l: Val, r: Val, op: lp.BinOp) -> Val:
        """LIKE / POSIX `~` / SIMILAR TO families: one compiled-regex match
        per distinct dictionary value, then a device gather by code (same
        cost model as every string fn here)."""
        B = lp.BinOp
        if l.dictionary is None or r.dictionary is None or len(r.dictionary) != 1:
            raise ExecutionError(
                f"{op.value} requires a string column and a literal pattern"
            )
        pat = r.dictionary.values[0]
        ci = op in (B.ILIKE, B.NOT_ILIKE, B.REGEX_IMATCH, B.NOT_REGEX_IMATCH)
        neg = op in (B.NOT_LIKE, B.NOT_ILIKE, B.NOT_REGEX_MATCH,
                     B.NOT_REGEX_IMATCH, B.NOT_SIMILAR_TO)
        flags = re.IGNORECASE if ci else 0
        if op in (B.LIKE, B.ILIKE, B.NOT_LIKE, B.NOT_ILIKE):
            rx = _like_to_regex(pat, ci)
            match = rx.match
        elif op in (B.SIMILAR_TO, B.NOT_SIMILAR_TO):
            rx = re.compile("^(?:" + _similar_to_regex(pat) + ")$", flags)
            match = rx.match
        else:
            # PG POSIX operators: unanchored search
            rx = re.compile(pat, flags)
            match = rx.search
        d = l.dictionary
        table = np.asarray([bool(match(v)) for v in d.values], dtype=bool)
        if len(table) == 0:
            table = np.zeros(1, bool)
        data = jnp.asarray(table)[jnp.clip(l.data, 0, max(len(d) - 1, 0))]
        if neg:
            data = ~data
        return Val(data, l.validity & r.validity, DataType.boolean())

    def _eval_concat(self, vals: List[Val], batch: ColumnBatch) -> Val:
        """String concatenation; decodes to host rows (dict cross-products
        explode, so per-row is the honest cost here)."""
        n = batch.capacity
        parts = []
        valid = jnp.ones(n, dtype=bool)
        for v in vals:
            if v.dictionary is not None:
                parts.append(v.dictionary.decode(np.asarray(v.data)))
            else:
                host = np.asarray(v.data)
                if jnp.issubdtype(v.data.dtype, jnp.floating):
                    parts.append(np.asarray([repr(float(x)) for x in host], dtype=object))
                else:
                    parts.append(host.astype(str).astype(object))
            valid = valid & v.validity
        out = parts[0]
        for p in parts[1:]:
            out = np.char.add(out.astype(str), p.astype(str)).astype(object)
        d, codes = Dictionary.from_values(list(out))
        return Val(jnp.asarray(codes), valid, DataType.utf8(), d)

    # ---- cast ----------------------------------------------------------
    def _eval_cast(self, e: lp.CastExpr, batch: ColumnBatch) -> Val:
        v = self.eval(e.expr, batch)
        t = e.target
        if t.is_dictionary:
            if v.dictionary is not None:
                return Val(v.data, v.validity, t, v.dictionary)
            host = np.asarray(v.data)
            if v.dtype.is_float:
                strs = [repr(float(x)) for x in host]
            elif v.dtype.kind is TypeKind.BOOLEAN:
                strs = ["true" if x else "false" for x in host]
            else:
                strs = [str(int(x)) for x in host]
            d, codes = Dictionary.from_values(strs)
            return Val(jnp.asarray(codes), v.validity, t, d)
        if v.dictionary is not None:
            if t.is_temporal:
                # string -> date/timestamp via per-dictionary-value ISO parse
                sentinel = np.iinfo(np.int64).min

                def parse_t(s):
                    p = _parse_temporal(s, t.kind)
                    return sentinel if p is None else p

                tv = _dict_lookup_host(v, parse_t, np.int64, t)
                bad = tv.data == sentinel
                return Val(tv.data.astype(jnp.dtype(t.device_dtype)),
                           tv.validity & ~bad, t)
            # string -> numeric via per-dictionary-value parse
            def parse(s):
                try:
                    return float(s)
                except ValueError:
                    return np.nan

            fv = _dict_lookup_host(v, parse, np.float64, DataType.float64())
            bad = jnp.isnan(fv.data)
            if t.is_float:
                return Val(fv.data, fv.validity & ~bad, t)
            return Val(
                fv.data.astype(jnp.int64), fv.validity & ~bad, t
            )
        np_t = t.device_dtype
        if t.kind is TypeKind.BOOLEAN:
            return Val(v.data.astype(bool), v.validity, t)
        if t.kind is TypeKind.DECIMAL128 and t.params:
            scale = t.params[1]
            src = (
                _descale(v).data if v.dtype.kind is TypeKind.DECIMAL128
                else v.data.astype(jnp.float64)
            )
            scaled = jnp.round(src * (10 ** scale))
            return Val(scaled.astype(jnp.int64), v.validity, t)
        if v.dtype.kind is TypeKind.DECIMAL128:
            f = _descale(v)
            if t.is_float:
                return Val(f.data.astype(jnp.dtype(np_t)), v.validity, t)
            # toward zero, like PG numeric -> int casts truncate? PG rounds;
            # round half away from zero for parity with our ROUND
            d = jnp.sign(f.data) * jnp.floor(jnp.abs(f.data) + 0.5)
            return Val(d.astype(jnp.dtype(np_t)), v.validity, t)
        return Val(v.data.astype(jnp.dtype(np_t)), v.validity, t)

    # ---- scalar functions ----------------------------------------------
    def _eval_scalar_fn(self, e: lp.ScalarFnExpr, batch: ColumnBatch) -> Val:
        f = e.func
        args = [self.eval(a, batch) for a in e.args]
        F = lp.ScalarFn
        if f is F.UPPER:
            return _dict_map_host(args[0], str.upper)
        if f is F.LOWER:
            return _dict_map_host(args[0], str.lower)
        if f is F.TRIM:
            return _dict_map_host(args[0], str.strip)
        if f is F.LENGTH:
            # parity: reference uses byte length (s.len() in Rust)
            return _dict_lookup_host(
                args[0], lambda s: len(s.encode("utf-8")), np.int64,
                DataType.int64(),
            )
        if f is F.REPLACE:
            frm = self._literal_str(args[1], "REPLACE")
            to = self._literal_str(args[2], "REPLACE")
            return _dict_map_host(args[0], lambda s: s.replace(frm, to))
        if f is F.SUBSTRING:
            start = int(self._static_num(e.args[1], args[1], "SUBSTRING"))
            length = (
                int(self._static_num(e.args[2], args[2], "SUBSTRING"))
                if len(args) > 2 else None
            )
            lo = max(start - 1, 0)  # SQL is 1-based

            def sub(s):
                return s[lo: lo + length] if length is not None else s[lo:]

            return _dict_map_host(args[0], sub)
        if f is F.CONCAT:
            return self._eval_concat(args, batch)
        if f is F.ABS:
            v = args[0]
            return Val(jnp.abs(v.data), v.validity, v.dtype)
        if f in (F.CEIL, F.FLOOR, F.SQRT):
            v = args[0]
            if v.dtype.kind is TypeKind.DECIMAL128:
                v = _descale(v)
            x = v.data.astype(jnp.float64)
            fn = {F.CEIL: jnp.ceil, F.FLOOR: jnp.floor, F.SQRT: jnp.sqrt}[f]
            out = fn(x)
            valid = v.validity
            if f is F.SQRT:
                valid = valid & (x >= 0)
            return Val(out, valid, DataType.float64())
        if f is F.ROUND:
            v = args[0]
            if v.dtype.kind is TypeKind.DECIMAL128:
                v = _descale(v)
            x = v.data.astype(jnp.float64)
            if len(args) > 1:
                nd = int(self._static_num(e.args[1], args[1], "ROUND"))
                m = 10.0 ** nd
                # half-away-from-zero (PG/Arrow), not banker's rounding
                out = jnp.sign(x) * jnp.floor(jnp.abs(x) * m + 0.5) / m
            else:
                out = jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)
            return Val(out, v.validity, DataType.float64())
        if f is F.POWER:
            a, b = args
            out = jnp.power(
                a.data.astype(jnp.float64), b.data.astype(jnp.float64)
            )
            return Val(out, a.validity & b.validity, DataType.float64())
        if f is F.COALESCE:
            return self._eval_coalesce(args)
        if f is F.NULLIF:
            a, b = args
            if a.dictionary is not None or b.dictionary is not None:
                a2, b2 = unify_dicts(a, b)
                eq = (a2.data == b2.data) & a.validity & b.validity
                return Val(a2.data, a.validity & ~eq, a.dtype, a2.dictionary)
            eq = (a.data == b.data) & a.validity & b.validity
            return Val(a.data, a.validity & ~eq, a.dtype, a.dictionary)
        if f is F.EXTRACT:
            return self._eval_extract(args)
        if f is F.DATE_TRUNC:
            return self._eval_date_trunc(args)
        if f in (F.JSON_EXTRACT_PATH, F.JSON_EXTRACT_PATH_TEXT):
            # function form of #> / #>> (PG json_extract_path[_text]):
            # one json.loads per DISTINCT document, one gather per row.
            # Zero path elements = identity over the reparsed document (PG).
            keys = [_static_json_key(a) for a in e.args[1:]]
            if any(k is None for k in keys):
                raise ExecutionError(
                    f"{f.value} path elements must be string or integer "
                    "literals")
            if args[0].dtype.kind is TypeKind.NULL:
                return _all_null_val(args[0].capacity, DataType.utf8())
            if args[0].dictionary is None:
                raise ExecutionError(
                    f"{f.value} requires a json (string) first argument")
            as_text = f is F.JSON_EXTRACT_PATH_TEXT
            return _dict_map_host_nullable(
                args[0], lambda s: _json_extract(s, keys, as_text),
                DataType.utf8())
        if f in (F.JSON_ARRAY_LENGTH, F.JSON_TYPEOF):
            v = args[0]
            if v.dtype.kind is TypeKind.NULL:
                # strict functions: NULL input -> NULL output (PG)
                return _all_null_val(
                    v.capacity,
                    DataType.int64() if f is F.JSON_ARRAY_LENGTH
                    else DataType.utf8())
            if v.dictionary is None:
                raise ExecutionError(
                    f"{f.value} requires a json (string) argument")
            if f is F.JSON_TYPEOF:
                return _dict_map_host_nullable(
                    v, _json_typeof, DataType.utf8())
            d = v.dictionary
            outs = [_json_array_length(x) for x in d.values]
            table = np.asarray([0 if o is None else o for o in outs],
                               np.int64)
            null = np.asarray([o is None for o in outs], bool)
            if len(table) == 0:
                table, null = np.zeros(1, np.int64), np.zeros(1, bool)
            idx = jnp.clip(v.data, 0, max(len(d) - 1, 0))
            return Val(jnp.asarray(table)[idx],
                       v.validity & ~jnp.asarray(null)[idx],
                       DataType.int64())
        if f is F.TO_TSVECTOR:
            return _dict_map_host(
                args[0], _tokenize_tsvector, DataType(TypeKind.TSVECTOR)
            )
        if f is F.TO_TSQUERY:
            return _dict_map_host(
                args[0], _normalize_tsquery, DataType(TypeKind.TSQUERY)
            )
        out = self._eval_math_fn(e, f, args)
        if out is None:
            out = self._eval_string_fn(e, f, args)
        if out is not None:
            return out
        raise ExecutionError(f"scalar function {f.value} not implemented")

    # unary math: (jnp fn, domain-validity fn or None)
    _MATH_UNARY = {
        lp.ScalarFn.EXP: (jnp.exp, None),
        lp.ScalarFn.LN: (jnp.log, lambda x: x > 0),
        lp.ScalarFn.LOG10: (lambda x: jnp.log(x) / np.log(10.0),
                            lambda x: x > 0),
        lp.ScalarFn.SIGN: (jnp.sign, None),
        lp.ScalarFn.SIN: (jnp.sin, None),
        lp.ScalarFn.COS: (jnp.cos, None),
        lp.ScalarFn.TAN: (jnp.tan, None),
        lp.ScalarFn.ASIN: (jnp.arcsin, lambda x: jnp.abs(x) <= 1),
        lp.ScalarFn.ACOS: (jnp.arccos, lambda x: jnp.abs(x) <= 1),
        lp.ScalarFn.ATAN: (jnp.arctan, None),
        lp.ScalarFn.DEGREES: (jnp.degrees, None),
        lp.ScalarFn.RADIANS: (jnp.radians, None),
    }

    def _eval_math_fn(self, e, f, args) -> Optional[Val]:
        """Device-vectorized math batch. Domain violations (LN of a
        non-positive, ASIN out of [-1,1]) yield NULL rather than NaN —
        closer to erroring PG than silent NaN propagation, and NULL-safe
        through every downstream aggregate."""
        F = lp.ScalarFn

        def f64(v):
            x = _descale(v) if v.dtype.kind is TypeKind.DECIMAL128 else v
            return x.data.astype(jnp.float64), x.validity

        if f in self._MATH_UNARY:
            fn, dom = self._MATH_UNARY[f]
            x, ok = f64(args[0])
            if dom is not None:
                ok = ok & dom(x)
            return Val(fn(x), ok, DataType.float64())
        if f is F.LOG:
            if len(args) == 1:  # PG: LOG(x) = log10
                x, ok = f64(args[0])
                return Val(jnp.log(x) / np.log(10.0), ok & (x > 0),
                           DataType.float64())
            b, bok = f64(args[0])
            x, xok = f64(args[1])
            ok = bok & xok & (x > 0) & (b > 0) & (b != 1.0)
            return Val(jnp.log(x) / jnp.log(b), ok, DataType.float64())
        if f is F.ATAN2:
            y, yok = f64(args[0])
            x, xok = f64(args[1])
            return Val(jnp.arctan2(y, x), yok & xok, DataType.float64())
        if f is F.TRUNC:
            x, ok = f64(args[0])
            if len(args) > 1:
                nd = int(self._static_num(e.args[1], args[1], "TRUNC"))
                m = 10.0 ** nd
                return Val(jnp.trunc(x * m) / m, ok, DataType.float64())
            return Val(jnp.trunc(x), ok, DataType.float64())
        if f in (F.GREATEST, F.LEAST):
            # PG: NULL args are ignored; NULL only when every arg is NULL
            if any(a.dictionary is not None for a in args):
                raise ExecutionError(f"{f.value} over strings not supported")
            pick_hi = f is F.GREATEST
            acc, ok = args[0].data, args[0].validity
            for a in args[1:]:
                better = (a.data > acc) if pick_hi else (a.data < acc)
                take = a.validity & (better | ~ok)
                acc = jnp.where(take, a.data, acc)
                ok = ok | a.validity
            dt = next(
                (a.dtype for a in args if a.dtype.kind is not TypeKind.NULL),
                args[0].dtype,
            )
            return Val(acc, ok, dt)
        return None

    def _eval_string_fn(self, e, f, args) -> Optional[Val]:
        """Host per-dictionary-value string batch (same execution model as
        UPPER/SUBSTRING: functions run once per distinct value)."""
        F = lp.ScalarFn
        if f in (F.LEFT, F.RIGHT):
            # PG: negative n drops |n| chars from the other end; Python
            # slicing matches exactly (RIGHT(s,0) is the one special case)
            n = int(self._static_num(e.args[1], args[1], f.value))
            if f is F.LEFT:
                cut = lambda s: s[:n]  # noqa: E731
            else:
                cut = lambda s: "" if n == 0 else s[-n:]  # noqa: E731
            return _dict_map_host(args[0], cut)
        if f in (F.LPAD, F.RPAD):
            ln = int(self._static_num(e.args[1], args[1], f.value))
            fill = (self._literal_str(args[2], f.value)
                    if len(args) > 2 else " ")

            def pad(s, ln=ln, fill=fill, left=(f is F.LPAD)):
                if len(s) >= ln:
                    return s[:ln]
                if not fill:
                    return s
                need = ln - len(s)
                p = (fill * (need // len(fill) + 1))[:need]
                return p + s if left else s + p

            return _dict_map_host(args[0], pad)
        if f is F.REVERSE:
            return _dict_map_host(args[0], lambda s: s[::-1])
        if f is F.INITCAP:
            import re as _re

            def initcap(s):
                return _re.sub(
                    r"[A-Za-z0-9]+",
                    lambda m: m.group(0)[:1].upper() + m.group(0)[1:].lower(),
                    s,
                )

            return _dict_map_host(args[0], initcap)
        if f is F.SPLIT_PART:
            delim = self._literal_str(args[1], "SPLIT_PART")
            n = int(self._static_num(e.args[2], args[2], "SPLIT_PART"))
            if n == 0:
                raise ExecutionError("SPLIT_PART field position must not be 0")

            def part(s, delim=delim, n=n):
                parts = s.split(delim) if delim else [s]
                i = n - 1 if n > 0 else len(parts) + n
                return parts[i] if 0 <= i < len(parts) else ""

            return _dict_map_host(args[0], part)
        if f is F.REPEAT:
            n = int(self._static_num(e.args[1], args[1], "REPEAT"))
            return _dict_map_host(args[0], lambda s: s * max(n, 0))
        if f is F.LTRIM:
            chars = (self._literal_str(args[1], "LTRIM")
                     if len(args) > 1 else None)
            return _dict_map_host(args[0], lambda s: s.lstrip(chars))
        if f is F.RTRIM:
            chars = (self._literal_str(args[1], "RTRIM")
                     if len(args) > 1 else None)
            return _dict_map_host(args[0], lambda s: s.rstrip(chars))
        if f is F.STRPOS:
            sub = self._literal_str(args[1], "STRPOS")
            return _dict_lookup_host(
                args[0], lambda s: s.find(sub) + 1, np.int64,
                DataType.int64(),
            )
        if f is F.STARTS_WITH:
            pre = self._literal_str(args[1], "STARTS_WITH")
            return _dict_lookup_host(
                args[0], lambda s: s.startswith(pre), np.bool_,
                DataType.boolean(),
            )
        if f in (F.REGEXP_REPLACE, F.REGEXP_LIKE, F.REGEXP_SUBSTR,
                 F.REGEXP_COUNT):
            return self._eval_regexp_fn(e, f, args)
        if f is F.STRING_TO_ARRAY:
            delim = self._literal_str(args[1], "STRING_TO_ARRAY")
            return _dict_map_host(
                args[0],
                lambda s: s.split(delim) if s else [],
                DataType.list_(DataType.utf8()),
            )
        if f is F.ARRAY_TO_STRING:
            delim = self._literal_str(args[1], "ARRAY_TO_STRING")

            def join_elems(lst):
                if not isinstance(lst, (list, tuple)):
                    return "" if lst is None else str(lst)
                return delim.join(
                    str(x) for x in lst if x is not None  # PG skips NULLs
                )

            return _dict_map_host(args[0], join_elems, DataType.utf8())
        if f is F.ARRAY_LENGTH:
            return _dict_lookup_host(
                args[0],
                lambda lst: len(lst) if isinstance(lst, (list, tuple)) else 1,
                np.int64, DataType.int64(),
            )
        return None

    def _eval_regexp_fn(self, e, f, args) -> Val:
        """PG regexp_* scalar functions. Patterns/flags must be literals;
        the regex runs once per distinct dictionary value (host), rows get
        their result by one device gather."""
        F = lp.ScalarFn
        pat = self._literal_str(args[1], f.value)
        # trailing optional flags argument: 'g' = replace all, 'i' = fold case
        fi = 3 if f is F.REGEXP_REPLACE else 2
        flags_s = (self._literal_str(args[fi], f.value)
                   if len(args) > fi else "")
        unknown = set(flags_s) - set("gi")
        if unknown:
            raise ExecutionError(
                f"{f.value}: unsupported regex flag(s) {sorted(unknown)}"
            )
        rx = re.compile(pat, re.IGNORECASE if "i" in flags_s else 0)
        if f is F.REGEXP_REPLACE:
            repl_raw = self._literal_str(args[2], f.value)
            # PG replacement escapes: \1..\9 group refs, \& whole match,
            # \\ literal backslash -> Python re.sub syntax
            repl = re.sub(r"\\&", r"\\g<0>", repl_raw)
            count = 0 if "g" in flags_s else 1
            return _dict_map_host(
                args[0], lambda s: rx.sub(repl, s, count=count)
            )
        if f is F.REGEXP_LIKE:
            return _dict_lookup_host(
                args[0], lambda s: bool(rx.search(s)), np.bool_,
                DataType.boolean(),
            )
        if f is F.REGEXP_COUNT:
            return _dict_lookup_host(
                args[0], lambda s: len(rx.findall(s)), np.int64,
                DataType.int64(),
            )
        # REGEXP_SUBSTR: first match, NULL when the pattern never matches
        out = _dict_map_host(
            args[0],
            lambda s: (lambda m: m.group(0) if m else "")(rx.search(s)),
        )
        matched = _dict_lookup_host(
            args[0], lambda s: bool(rx.search(s)), np.bool_,
            DataType.boolean(),
        )
        return Val(out.data, out.validity & matched.data, out.dtype,
                   out.dictionary)

    def _eval_extract(self, args: List[Val]) -> Val:
        """EXTRACT(field FROM temporal) — vectorized on-device. PG semantics:
        dow 0=Sunday..6, isodow 1=Monday..7, week = ISO 8601 week number;
        second/epoch carry the fractional part (float64), the rest are
        int64."""
        field = self._literal_str(args[0], "EXTRACT").lower()
        v = args[1]
        if not v.dtype.is_temporal:
            raise ExecutionError(
                f"EXTRACT needs a date/timestamp argument, got {v.dtype}"
            )
        days, tod = _temporal_split(v)
        valid = args[0].validity & v.validity
        if field in ("year", "month", "day", "quarter", "decade",
                     "century", "millennium"):
            y, m, d = _civil_from_days(days)
            out = {
                "year": y, "month": m, "day": d,
                "quarter": (m - 1) // 3 + 1,
                "decade": y // 10,
                "century": (y + 99) // 100,
                "millennium": (y + 999) // 1000,
            }[field]
        elif field == "dow":
            out = (days + 4) % 7
        elif field == "isodow":
            out = (days + 3) % 7 + 1
        elif field == "doy":
            y, _, _ = _civil_from_days(days)
            out = days - _days_from_civil(y, jnp.ones_like(y), jnp.ones_like(y)) + 1
        elif field == "week":
            # ISO week: week containing this date's Thursday
            thursday = days - (days + 3) % 7 + 3
            ty, _, _ = _civil_from_days(thursday)
            jan1 = _days_from_civil(ty, jnp.ones_like(ty), jnp.ones_like(ty))
            out = (thursday - jan1) // 7 + 1
        elif field == "hour":
            out = tod // 3_600_000_000
        elif field == "minute":
            out = (tod // 60_000_000) % 60
        elif field == "second":
            return Val((tod % 60_000_000).astype(jnp.float64) / 1e6, valid,
                       DataType.float64())
        elif field in ("epoch",):
            sec = days.astype(jnp.float64) * 86400.0 + tod.astype(jnp.float64) / 1e6
            return Val(sec, valid, DataType.float64())
        elif field in ("milliseconds",):
            out = tod % 60_000_000 // 1000
        elif field in ("microseconds",):
            out = tod % 60_000_000
        else:
            raise ExecutionError(f"EXTRACT field '{field}' not supported")
        return Val(out.astype(jnp.int64), valid, DataType.int64())

    def _eval_date_trunc(self, args: List[Val]) -> Val:
        """DATE_TRUNC(unit, temporal) — result keeps the argument's type
        (PG widens date->timestamp; keeping the type is a documented
        deviation that keeps the column device-native)."""
        unit = self._literal_str(args[0], "DATE_TRUNC").lower()
        v = args[1]
        if not v.dtype.is_temporal:
            raise ExecutionError(
                f"DATE_TRUNC needs a date/timestamp argument, got {v.dtype}"
            )
        days, tod = _temporal_split(v)
        valid = args[0].validity & v.validity
        if unit in ("microseconds",):
            pass
        elif unit in ("milliseconds",):
            tod = tod - tod % 1000
        elif unit == "second":
            tod = tod - tod % 1_000_000
        elif unit == "minute":
            tod = tod - tod % 60_000_000
        elif unit == "hour":
            tod = tod - tod % 3_600_000_000
        elif unit == "day":
            tod = jnp.zeros_like(tod)
        elif unit == "week":
            days = days - (days + 3) % 7  # back to Monday
            tod = jnp.zeros_like(tod)
        elif unit in ("month", "quarter", "year"):
            y, m, _ = _civil_from_days(days)
            if unit == "quarter":
                m = ((m - 1) // 3) * 3 + 1
            elif unit == "year":
                m = jnp.ones_like(m)
            days = _days_from_civil(y, m, jnp.ones_like(m))
            tod = jnp.zeros_like(tod)
        else:
            raise ExecutionError(f"DATE_TRUNC unit '{unit}' not supported")
        k = v.dtype.kind
        if k is TypeKind.DATE32:
            return Val(days.astype(jnp.int32), valid, v.dtype)
        if k is TypeKind.DATE64:
            return Val(days * 86_400_000 + tod // 1000, valid, v.dtype)
        return Val(days * _US_DAY + tod, valid, v.dtype)

    def _eval_coalesce(self, args: List[Val]) -> Val:
        if any(a.dictionary is not None for a in args):
            out = args[0]
            for nxt in args[1:]:
                o2, n2 = unify_dicts(out, nxt)
                data = jnp.where(out.validity, o2.data, n2.data)
                valid = out.validity | nxt.validity
                out = Val(data, valid, out.dtype, o2.dictionary)
            return out
        is_float = any(a.dtype.is_float for a in args)
        cast = (lambda x: x.astype(jnp.float64)) if is_float else (
            lambda x: x.astype(jnp.int64)
        )
        out = args[0]
        data = cast(out.data)
        valid = out.validity
        for nxt in args[1:]:
            data = jnp.where(valid, data, cast(nxt.data))
            valid = valid | nxt.validity
        dt = DataType.float64() if is_float else args[0].dtype
        return Val(data, valid, dt)

    @staticmethod
    def _literal_str(v: Val, fn: str) -> str:
        if v.dictionary is None or len(v.dictionary) != 1:
            raise ExecutionError(f"{fn} requires a string literal argument")
        return v.dictionary.values[0]

    @staticmethod
    def _literal_num(v: Val, fn: str):
        return np.asarray(v.data)[0]

    def _static_num(self, expr: lp.LogicalExpr, val: Val, fn: str):
        """Static numeric argument (SUBSTRING offsets, ROUND digits, ...).
        Read it from the EXPRESSION node: inside a traced program even a
        constant's broadcast plane is a tracer, so converting the evaluated
        Val would fail. Falls back to the Val for non-literal shapes (eager
        path only)."""
        x, neg = expr, False
        while isinstance(x, (lp.AliasExpr, lp.UnaryExpr)):
            if isinstance(x, lp.UnaryExpr):
                if x.op is not lp.UnOp.NEG:
                    break
                neg = not neg
            x = x.expr
        if isinstance(x, lp.Literal) and x.value.value is not None \
                and not isinstance(x.value.value, str):
            v = x.value.value
            return -v if neg else v
        return self._literal_num(val, fn)

    # ---- udf -----------------------------------------------------------
    def _eval_udf(self, e: lp.UdfExpr, batch: ColumnBatch) -> Val:
        if self.udfs is None:
            raise ExecutionError(f"unknown function '{e.fn_name}'")
        udf = self.udfs.get(e.fn_name)
        if udf is None:
            raise ExecutionError(f"unknown function '{e.fn_name}'")
        args = [self.eval(a, batch) for a in e.args]
        data, validity = udf.invoke([(a.data, a.validity) for a in args])
        return Val(data, validity, udf.signature.return_type)

    # ---- case / in -----------------------------------------------------
    def _eval_case(self, e: lp.CaseExpr, batch: ColumnBatch) -> Val:
        conds = [self.eval(c, batch) for c, _ in e.branches]
        thens = [self.eval(t, batch) for _, t in e.branches]
        else_v = (
            self.eval(e.else_expr, batch) if e.else_expr is not None else None
        )
        vals = thens + ([else_v] if else_v is not None else [])
        if any(v.dictionary is not None for v in vals):
            merged = vals[0].dictionary or Dictionary.empty()
            for v in vals[1:]:
                merged, _, _ = merged.merge(v.dictionary or Dictionary.empty())
            remapped = []
            for v in vals:
                d = v.dictionary or Dictionary.empty()
                _, r, _ = merged.merge(d)  # identity for merged
                rm = np.searchsorted(merged.values, d.values).astype(np.int32)
                rm_j = jnp.asarray(rm if len(rm) else np.zeros(1, np.int32))
                remapped.append(
                    Val(rm_j[jnp.clip(v.data, 0, max(len(d) - 1, 0))],
                        v.validity, v.dtype, merged)
                )
            vals = remapped
            thens = vals[: len(thens)]
            else_v = vals[len(thens)] if else_v is not None else None
            out_dict = merged
        else:
            out_dict = None
        cap = batch.capacity
        if else_v is not None:
            data, valid = else_v.data, else_v.validity
        else:
            data = jnp.zeros_like(thens[0].data)
            valid = jnp.zeros(cap, dtype=bool)
        for c, t in reversed(list(zip(conds, thens))):
            hit = c.data.astype(bool) & c.validity
            data = jnp.where(hit, t.data, data)
            valid = jnp.where(hit, t.validity, valid)
        return Val(data, valid, e.dtype, out_dict)

    def _eval_in_list(self, e: lp.InListExpr, batch: ColumnBatch) -> Val:
        # x IN (a, b, c) == (x = a) OR (x = b) OR (x = c), 3VL included
        acc = None
        for item in e.items:
            cmp = self._eval_binary(
                lp.BinaryExpr(e.expr, lp.BinOp.EQ, item), batch
            )
            if acc is None:
                acc = cmp
            else:
                data = acc.data | cmp.data
                valid = (acc.validity & cmp.validity) | (
                    acc.validity & acc.data
                ) | (cmp.validity & cmp.data)
                acc = Val(data, valid, DataType.boolean())
        if e.negated:
            acc = Val(~acc.data, acc.validity, DataType.boolean())
        return acc

    # ---- subqueries ----------------------------------------------------
    @staticmethod
    def _shared_root_id(p):
        """id() of the shared (multiply-referenced) physical subplan a
        lookup plan is rooted at, else None. Walks only row-preserving
        unary wrappers (PSubquery rename, PProjection)."""
        from query_engine_tpu.plan import physical as pp

        while p is not None:
            if isinstance(p, pp.PSubquery):
                return id(p.input) if p.shared else None
            if not isinstance(p, pp.PProjection):
                return None
            p = p.input
        return None

    def _run_subplan(self, plan) -> ColumnBatch:
        if self._subplans is not None and id(plan) in self._subplans:
            return self._subplans[id(plan)]  # traced shim (compiled path)
        if self.subquery_exec is None:
            raise ExecutionError("subquery execution not available here")
        return self.subquery_exec(plan)

    def _eval_scalar_subquery(self, e: lp.ScalarSubqueryExpr, batch) -> Val:
        sub = self._run_subplan(e.plan)
        col = sub.columns[0]
        # branchless (trace-compatible): value = first row, NULL when the
        # subquery returned no rows
        has = K.live_mask(sub.capacity, sub.num_rows)[0]
        data = jnp.full(batch.capacity, jnp.asarray(col.data)[0])
        valid = jnp.full(
            batch.capacity, has & jnp.asarray(col.validity)[0]
        )
        return Val(data, valid, e.dtype, col.dictionary)

    def _eval_in_subquery(self, e: lp.InSubqueryExpr, batch) -> Val:
        sub = self._run_subplan(e.plan)
        v = self.eval(e.expr, batch)
        scol = sub.columns[0]
        sdata = jnp.asarray(scol.data)
        svalid = jnp.asarray(scol.validity)
        if v.dictionary is not None or scol.dictionary is not None:
            sval = Val(sdata, svalid, DataType.utf8(), scol.dictionary)
            v2, s2 = unify_dicts(v, sval)
            probe, build = v2.data.astype(jnp.int64), s2.data.astype(jnp.int64)
        else:
            if v.dtype.is_float or (
                scol.dtype.is_float if hasattr(scol, "dtype") else False
            ):
                probe = v.data.astype(jnp.float64)
                build = sdata.astype(jnp.float64)
            else:
                probe = v.data.astype(jnp.int64)
                build = sdata.astype(jnp.int64)
        lm = K.live_mask(sub.capacity, sub.num_rows)
        sub_has_null = jnp.any(lm & ~svalid)  # traced-compatible
        # rank membership: joint sort + presence scatter/gather
        lr, rr = K.join_ranks(
            [(probe, v.validity)], [(build, svalid)],
            batch.num_rows, sub.num_rows,
        )
        found = K.rank_member(lr, rr, lm)
        data = found
        # 3VL: NOT found & subquery has NULL -> NULL
        valid = v.validity & (found | ~sub_has_null)
        if e.negated:
            data = ~data
        return Val(data, valid, DataType.boolean())

    def _eval_quantified_cmp(self, e: lp.QuantifiedCmpExpr, batch) -> Val:
        """x op ANY|ALL (S): reduce S to MIN/MAX of its non-null values and
        apply PG 3-valued logic. x > ANY(S) <=> x > MIN(S); x > ALL(S) <=>
        x > MAX(S); <> ANY / = ALL test against BOTH extremes. Result per
        row: ANY — TRUE when the extreme test passes; FALSE when it fails
        with no NULL in play; else NULL (empty S is FALSE even for NULL x).
        ALL mirrors with TRUE/FALSE swapped and empty S TRUE."""
        sub = self._run_subplan(e.plan)
        v = self.eval(e.expr, batch)
        scol = sub.columns[0]
        sdata = jnp.asarray(scol.data)
        svalid = jnp.asarray(scol.validity)
        if v.dictionary is not None and scol.dictionary is not None:
            sval = Val(sdata, svalid, DataType.utf8(), scol.dictionary)
            v2, s2 = unify_dicts(v, sval)
            # dictionaries are SORTED, so code order == string order
            x, sd = v2.data.astype(jnp.int64), s2.data.astype(jnp.int64)
        elif v.dictionary is not None or scol.dictionary is not None:
            # one side is strings, the other is not: legal only when the
            # string side carries no actual values (an all-NULL column
            # infers as utf8 with an EMPTY dictionary) — then it never
            # contributes a comparison, only NULL-ness
            strside = v if v.dictionary is not None else scol
            if any(x_ != "" for x_ in strside.dictionary.values):
                raise ExecutionError(
                    "cannot compare string and non-string in ANY/ALL"
                )
            if v.dictionary is not None:  # probe side is the empty one
                x = jnp.zeros(v.data.shape, jnp.int64)
                v = Val(v.data, jnp.zeros_like(v.validity), v.dtype)
                sd = sdata.astype(jnp.int64)
            else:  # subquery side is the empty one: no valid s values
                x = v.data.astype(jnp.int64)
                sd = jnp.zeros(sdata.shape, jnp.int64)
                svalid = jnp.zeros_like(svalid)
        elif v.dtype.is_float or scol.dtype.is_float:
            x, sd = v.data.astype(jnp.float64), sdata.astype(jnp.float64)
        else:
            x, sd = v.data.astype(jnp.int64), sdata.astype(jnp.int64)
        lm = K.live_mask(sub.capacity, sub.num_rows)
        nn = lm & svalid
        nonempty = jnp.any(lm)
        has_nonnull = jnp.any(nn)
        has_null = jnp.any(lm & ~svalid)
        big = jnp.asarray(
            jnp.finfo(sd.dtype).max if jnp.issubdtype(sd.dtype, jnp.floating)
            else jnp.iinfo(sd.dtype).max, sd.dtype
        )
        mn = jnp.min(jnp.where(nn, sd, big))
        mx = jnp.max(jnp.where(nn, sd, -big))
        O = lp.BinOp
        if e.is_any:
            cand = {
                O.GT: lambda: x > mn, O.GTE: lambda: x >= mn,
                O.LT: lambda: x < mx, O.LTE: lambda: x <= mx,
                O.NEQ: lambda: (x != mn) | (x != mx),
                O.EQ: lambda: (x >= mn) & (x <= mx) & (x == x),  # unused
            }[e.op]()
            true_m = v.validity & has_nonnull & cand
            false_m = ~nonempty | (v.validity & ~has_null & has_nonnull
                                   & ~cand)
            return Val(true_m, true_m | false_m, DataType.boolean())
        cand = {
            O.GT: lambda: x > mx, O.GTE: lambda: x >= mx,
            O.LT: lambda: x < mn, O.LTE: lambda: x <= mn,
            O.EQ: lambda: (x == mn) & (x == mx),
            O.NEQ: lambda: (x != mn) | (x != mx),  # unused (routed to IN)
        }[e.op]()
        true_m = ~nonempty | (v.validity & ~has_null & has_nonnull & cand)
        false_m = v.validity & has_nonnull & ~cand
        return Val(true_m, true_m | false_m, DataType.boolean())

    def _eval_correlated_lookup(self, e: lp.CorrelatedLookupExpr, batch) -> Val:
        """Vectorized decorrelated-subquery evaluation: run the grouped
        subplan once, rank-match the outer batch's key expressions against
        its key columns, gather the value column (or the found mask for
        EXISTS). One subplan execution + one match for the whole batch —
        never per-row re-execution."""
        sub = self._run_subplan(e.plan)
        nk = len(e.outer_keys)
        mkey = None
        if self._subplans is None:  # eager path only (no traced arrays)
            sid = self._shared_root_id(e.plan)
            if sid is not None:
                mkey = (id(batch), sid, tuple(id(k) for k in e.outer_keys))
        hit = self._corr_match_memo.get(mkey) if mkey is not None else None
        if hit is not None:
            row, found = hit
        else:
            okeys, skeys = [], []
            for i, ke in enumerate(e.outer_keys):
                ov = self.eval(ke, batch)
                sc = sub.columns[i]
                sv = Val(jnp.asarray(sc.data), jnp.asarray(sc.validity),
                         sc.dtype, sc.dictionary)
                if ov.dictionary is not None or sc.dictionary is not None:
                    ov, sv = unify_dicts(ov, sv)
                okeys.append((ov.data, ov.validity))
                skeys.append((sv.data, sv.validity))
            lr, rr = K.join_ranks(okeys, skeys, batch.num_rows, sub.num_rows)
            # grouped subplan => unique keys: rank -> row scatter table +
            # one lookup gather (no searchsorted)
            row, found = K.fk_join_right_lookup(
                lr, rr, batch.num_rows, sub.num_rows
            )
            if mkey is not None:
                self._corr_match_memo[mkey] = (row, found)
        if e.mode == "exists":
            data = ~found if e.negated else found
            return Val(data, jnp.ones(batch.capacity, dtype=bool),
                       DataType.boolean())
        vcol = sub.columns[nk]
        data = jnp.asarray(vcol.data)[row]
        valid = found & jnp.asarray(vcol.validity)[row]
        if e.miss_value is not None and e.miss_value.value is not None:
            data = jnp.where(found, data, e.miss_value.value)
            valid = valid | ~found
        return Val(data, valid, e.dtype, vcol.dictionary)

    def _eval_exists(self, e: lp.ExistsExpr, batch) -> Val:
        sub = self._run_subplan(e.plan)
        hit = K.live_mask(sub.capacity, sub.num_rows)[0]  # any live row?
        if e.negated:
            hit = ~hit
        return Val(
            jnp.full(batch.capacity, hit),
            jnp.ones(batch.capacity, dtype=bool),
            DataType.boolean(),
        )
