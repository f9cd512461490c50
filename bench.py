"""Engine benchmark, in one process on the default JAX device.

    python bench.py                     # on the accelerator
    JAX_PLATFORMS=cpu python bench.py   # rehearsal, labelled "cpu"

Without an accelerator it refuses to run unless JAX_PLATFORMS names the CPU.

Measures the BASELINE.json operator set (filter, hash aggregate, hash join
build+probe+emit, sort) on synthetic tables, stage by stage:

  quick_filter  one filter-count over QE_BENCH_ROWS rows
  engine_small  the SQL engine path (parse -> plan -> compiled pipeline ->
                result) on a filter+join+aggregate+sort query, 2^20 rows
  engine        the same query at QE_BENCH_ROWS rows (at most 2^23)
  per_op        each operator alone at QE_BENCH_ROWS rows (QE_BENCH_OPS=0
                skips)
  tpch          the 22 TPC-H queries at QE_BENCH_TPCH_ROWS lineitem rows
                (default 2^21; QE_BENCH_TPCH=0 skips)
  fused         the same operators as one hand-fused jitted pipeline

Each stage's compile-and-first-run seconds land under "compile_s" (set-up
time); measured times are the best of QE_BENCH_ITERS runs (default 3), each
ended by the result fetch. Achieved bytes/s are divided by the device's
published peak (utils/profiling.DEVICE_PEAKS) where it has one. Every record
names the device: platform, device_kind, count, and the card's name and
power limit. A JSON line is printed after each stage; the last line is the
full record. A stage that fails is recorded with its error and the run
exits non-zero.

Headline metric: the best rows/s/device of the engine and fused stages.
vs_baseline compares against the reference's only published join
throughput — 813.01 QPS on the 6x4-row employees/departments join
(README.md:693), i.e. 813 * 24 = 19,512 joined rows/sec (and that join is a
Cartesian stub; see BASELINE.md caveat).
"""

import json
import os
import sys
import time
import traceback

import numpy as np

import query_engine_tpu  # noqa: F401  (enables x64 + compile cache)
import jax
import jax.numpy as jnp

from query_engine_tpu.ops import kernels as K
from query_engine_tpu.utils.profiling import (
    HOST_PLATFORMS, device_peaks, device_record,
)

REPO = os.path.dirname(os.path.abspath(__file__))
REFERENCE_JOIN_ROWS_PER_SEC = 813.01 * 24  # README.md:678-694 sample output
N_GROUPS = 1024  # aggregate cardinality (dept-style grouping)
ITERS = int(os.environ.get("QE_BENCH_ITERS", 3))
ROWS = int(os.environ.get("QE_BENCH_ROWS", 1 << 24))

REPORT = {
    "metric": None,
    "value": 0.0,
    "unit": "rows/sec/device",
    "vs_baseline": 0.0,
    "compile_s": {},
}


def emit():
    print(json.dumps(REPORT), flush=True)


def _set_headline(metric, rows_per_sec):
    if rows_per_sec > REPORT["value"]:
        REPORT["metric"] = metric
        REPORT["value"] = rows_per_sec
        REPORT["vs_baseline"] = rows_per_sec / REFERENCE_JOIN_ROWS_PER_SEC


def _best_of(fn, iters=ITERS):
    """(compile-and-first-run seconds, best run seconds); fn must end in a
    host fetch of its result."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return first, min(ts)


def _hbm_share(bytes_moved, secs):
    peaks = device_peaks()
    if peaks is None:
        return None
    return bytes_moved / secs / peaks["hbm_bytes_per_sec"]


# ---- synthetic planes -------------------------------------------------------

def _pin(a, lo, hi):
    """Force a generated plane to attain exact (lo, hi) bounds, so the
    data-derived program constants (table-stat bounds) are the same in
    every run."""
    return a.at[0].set(lo).at[1].set(hi)


def _build_args(cap, bcap):
    """Fact and dimension planes generated on the device. The PRNG keys are
    arguments: a nullary jit would be constant-folded at compile time."""
    import jax.random as jr

    n_rows = cap - 17
    n_build = bcap - 3
    n_keys = bcap  # every probe row matches ~1 build row

    @jax.jit
    def gen(ks):
        return (
            _pin(jr.randint(ks[0], (cap,), 18, 65, jnp.int32), 18, 64),
            _pin(jr.randint(ks[1], (cap,), 50_000, 150_000, jnp.int64),
                 50_000, 149_999),
            _pin(jr.randint(ks[2], (cap,), 0, n_keys, jnp.int32),
                 0, n_keys - 1),
            jr.uniform(ks[3], (cap,)) > 0.02,
            _pin(jr.randint(ks[4], (cap,), 0, 1024, jnp.int32), 0, 1023),
            jr.permutation(ks[5], jnp.arange(bcap, dtype=jnp.int32)),
            _pin(jr.randint(ks[6], (bcap,), 0, 1000, jnp.int64), 0, 999),
            jnp.ones(cap, bool),
            jnp.ones(bcap, bool),
        )

    age, salary, dept, dept_v, grp, bdept, bval, ones_c, ones_b = gen(
        jr.split(jr.PRNGKey(42), 7))
    return (
        age, ones_c, salary, ones_c, dept, dept_v, grp,
        bdept, ones_b, bval, ones_b,
        np.int64(n_rows), np.int64(n_build),
    )


# ---- stages -------------------------------------------------------------

def stage_quick_filter():
    import jax.random as jr

    n = ROWS - 17
    age = jax.jit(lambda k: _pin(
        jr.randint(k, (ROWS,), 18, 65, jnp.int32), 18, 64))(jr.PRNGKey(42))
    f = jax.jit(lambda a, n: K.filter_count(a > 25, n))
    first, best = _best_of(lambda: int(f(age, n)))
    REPORT["compile_s"]["quick_filter"] = first
    return {"rows_per_sec": n / best, "ms": best * 1e3, "rows": n}


def _engine_setup(n):
    """Session with a device-generated fact table (bounds pinned) and a
    1,024-row dimension table, plus the benchmark query."""
    from query_engine_tpu.core.schema import Field, Schema
    from query_engine_tpu.core.types import DataType
    from query_engine_tpu.columnar.batch import Column, ColumnBatch, \
        padded_capacity
    from query_engine_tpu.engine.session import Session
    import jax.random as jr

    nd = 1024
    cap = padded_capacity(n)

    @jax.jit
    def gen(ks):
        return (
            _pin(jr.randint(ks[0], (cap,), 18, 65, jnp.int64), 18, 64),
            _pin(jr.randint(ks[1], (cap,), 50_000, 150_000, jnp.int64),
                 50_000, 149_999),
            _pin(jr.randint(ks[2], (cap,), 0, nd, jnp.int64), 0, nd - 1),
            jnp.ones(cap, bool),
        )

    age, salary, dept, valid = gen(jr.split(jr.PRNGKey(7), 3))
    i64 = DataType.int64()
    fact = ColumnBatch(
        Schema([Field("age", i64), Field("salary", i64),
                Field("dept", i64)]),
        [Column(age, valid, i64), Column(salary, valid, i64),
         Column(dept, valid, i64)],
        n,
    )
    rng = np.random.default_rng(7)
    bonus = rng.integers(0, 1000, nd)
    bonus[0], bonus[1] = 0, 999  # pin bounds
    dim = ColumnBatch.from_pydict({
        "dept_id": np.arange(nd), "bonus": bonus,
    })
    s = Session()
    s.register_table("f", fact)
    s.register_table("d", dim)
    q = ("SELECT f.dept, COUNT(*) AS c, SUM(f.salary + d.bonus) AS s "
         "FROM f JOIN d ON f.dept = d.dept_id "
         "WHERE f.age > 25 GROUP BY f.dept ORDER BY s DESC LIMIT 10")
    return s, q


def stage_engine(name, n):
    s, q = _engine_setup(n)
    first, best = _best_of(lambda: s.sql(q).to_pylist())
    REPORT["compile_s"][name] = first
    _set_headline(f"{name}_sql_filter_join_agg_sort", n / best)
    return {"rows_per_sec": n / best, "ms_per_query": best * 1e3, "rows": n}


def _op_defs(cap, bcap, args):
    """The per-operator registry: (name, bytes read per row, op, args,
    rows). Bytes are the inputs read once."""
    (age, age_v, salary, salary_v, dept, dept_v, grp,
     bdept, bdept_v, bval, bval_v, n_rows, n_build) = args
    defs = [
        ("filter", 5,
         lambda a, av, n: K.filter_count((a > 25) & av, n),
         (age, age_v, n_rows), None),
        # table-stat bounds as the engine passes them (pipeline.py
        # _proj_bounds): salary spans 17 bits
        ("hash_aggregate_direct", 14,
         lambda d, dv, s, sv, n: K.segment_aggregate(
             "sum", s, sv, K.group_ids_direct(d, dv, n, 0, bcap)[0], n,
             bcap + 1, value_bounds=(50_000, 150_001),
         ),
         (dept, dept_v, salary, salary_v, n_rows), None),
        # what GROUP BY runs: SUM(int64) + COUNT over 1,024 dense groups
        ("hash_aggregate_1024_groups", 13,
         lambda s, sv, g, n: (
             K.segment_aggregate("sum", s, sv, g, n, N_GROUPS),
             K.segment_aggregate("count", s, sv, g, n, N_GROUPS),
         ),
         (salary, salary_v, grp, n_rows), None),
        # the engine's general join: fused ranks + counts
        ("sort_rank_join_count", 5,
         lambda d, dv, bd, bdv, n, nb: K.join_ranks_counts(
             [(d, dv)], [(bd, bdv)], n, nb),
         (dept, dept_v, bdept, bdept_v, n_rows, n_build), None),
        # the emit-capacity COUNT program: sorted space only
        ("join_count_program", 5,
         lambda d, dv, bd, bdv, n, nb: K.join_count_total(
             [(d, dv)], [(bd, bdv)], n, nb)[0],
         (dept, dept_v, bdept, bdept_v, n_rows, n_build), None),
    ]

    def fk_join(d, dv, bd, bdv, bv, bvv, n, nb):
        # FK fast path: direct ranks + fused rank-space gather
        iota_l = jnp.arange(cap, dtype=jnp.int32)
        iota_r = jnp.arange(bcap, dtype=jnp.int32)
        keep = dv & K.live_mask(cap, n)
        lr = jnp.where(keep, d, -(iota_l + 2))
        rr = jnp.where(bdv, bd, -(iota_r + cap + 2))
        (jd,), (jv,), matched = K.fk_gather_by_rank(
            [bv], [bvv], [(0, 1024)], rr, jnp.ones(bcap, bool),
            lr, keep, bcap,
        )
        return jnp.sum(jnp.where(matched, jd, 0))

    defs.append(("hash_join_fk_gather", 13, fk_join,
                 (dept, dept_v, bdept, bdept_v, bval, bval_v, n_rows,
                  n_build), None))
    defs.append(("sort", 13,
                 lambda s, sv, n: K.sort_permutation(
                     [s], [sv], [False], [False], n),
                 (salary, salary_v, n_rows), None))

    # open addressing (ops/hash_join.py): no engine path routes here; kept
    # as the comparison for the sort-rank join
    from query_engine_tpu.ops.hash_join import hash_join_unique, table_size_for

    hj_n = min(cap, 1 << 19)
    T = table_size_for(bcap)
    defs.append(("hash_join_openaddr", 5,
                 lambda d, dv, bd, bdv: hash_join_unique(
                     d[:hj_n], dv[:hj_n], bd, bdv, T),
                 (dept, dept_v, bdept, bdept_v), hj_n))
    return defs


def stage_per_op():
    bcap = max(ROWS >> 4, 128)
    args = _build_args(ROWS, bcap)
    n_rows = int(args[-2])
    out = {}
    for name, bytes_per_row, op, a, rows in _op_defs(ROWS, bcap, args):
        f = jax.jit(op)
        first, best = _best_of(
            lambda: jax.tree_util.tree_map(np.asarray, f(*a)))
        n = rows or n_rows
        out[name] = {
            "ms": best * 1e3, "rows_per_sec": n / best,
            "achieved_gb_per_sec": n * bytes_per_row / best / 1e9,
            "compile_s": first,
        }
        share = _hbm_share(n * bytes_per_row, best)
        if share is not None:
            out[name]["hbm_share"] = share
    return out


def stage_tpch():
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    import tpch_mini

    n_li = int(os.environ.get("QE_BENCH_TPCH_ROWS", 1 << 21))
    t0 = time.perf_counter()
    s, _tables = tpch_mini.build(n_li)
    out = {"lineitem_rows": n_li, "build_s": time.perf_counter() - t0}
    compile_s = {}
    for name, q in tpch_mini.QUERIES.items():
        first, best = _best_of(lambda: s.sql(q).to_pylist())
        compile_s[name] = first
        out[name] = best * 1e3
    out["total_warm_ms"] = sum(out[name] for name in tpch_mini.QUERIES)
    REPORT["compile_s"]["tpch"] = compile_s
    return out


def build_pipeline(cap: int, bcap: int):
    def pipeline(age, age_v, salary, salary_v, dept, dept_v, grp,
                 bdept, bdept_v, bval, bval_v, n_rows, n_build):
        # --- filter: age > 25 ---
        live = K.live_mask(cap, n_rows)
        keep = (age > 25) & age_v & live

        # --- hash aggregate: GROUP BY grp -> COUNT/SUM/AVG ---
        gid, ng, rep = K.group_ids_direct(grp, keep, n_rows, 0, N_GROUPS)
        gcap = N_GROUPS + 1
        s, sv = K.segment_aggregate("sum", salary, salary_v & keep, gid,
                                    n_rows, gcap)
        c, _ = K.segment_aggregate("count_star", None, None, gid,
                                   n_rows, gcap)
        avg = s.astype(jnp.float64) / jnp.maximum(c, 1)

        # --- hash join: probe (filtered fact) x build (dim, unique keys),
        # FK fast path with direct ranks and the fused rank-space gather ---
        iota_l = jnp.arange(cap, dtype=jnp.int32)
        iota_r = jnp.arange(bcap, dtype=jnp.int32)
        lr = jnp.where(dept_v & keep, dept, -(iota_l + 2))
        rr = jnp.where(bdept_v, bdept, -(iota_r + cap + 2))
        (jval_col,), (jval_ok,), jvalid = K.fk_gather_by_rank(
            [bval], [bval_v], [(0, 1024)], rr, jnp.ones(bcap, bool),
            lr, keep, bcap,
        )
        total = jnp.sum(jvalid.astype(jnp.int64))
        joined_val = jnp.where(jvalid, jval_col + salary, 0)

        # --- sort: ORDER BY salary DESC ---
        perm = K.sort_permutation([salary], [salary_v], [False], [False],
                                  n_rows)
        top = salary[perm[:128]]  # top-k: gather only the fetched window

        return s[:128], c[:128], avg[:128], total, jnp.sum(joined_val), top, ng

    return jax.jit(pipeline)


def stage_fused():
    bcap = max(ROWS >> 4, 128)
    args = _build_args(ROWS, bcap)
    pipeline = build_pipeline(ROWS, bcap)
    first, best = _best_of(
        lambda: jax.tree_util.tree_map(np.asarray, pipeline(*args)))
    REPORT["compile_s"]["fused"] = first
    n = int(args[-2])
    _set_headline("fused_filter_agg_join_sort_pipeline", n / best)
    out = {"rows_per_sec": n / best, "ms": best * 1e3, "rows": n}
    # each input plane read once: age 4+1, salary 8+1, dept 4+1, grp 4
    share = _hbm_share(n * 23, best)
    if share is not None:
        out["hbm_share"] = share
    return out


def main() -> int:
    if (jax.devices()[0].platform in HOST_PLATFORMS
            and "cpu" not in os.environ.get("JAX_PLATFORMS", "")):
        raise RuntimeError(
            "bench.py found no accelerator; set JAX_PLATFORMS=cpu for a CPU "
            "rehearsal")
    REPORT["device"] = device_record()
    stages = [
        ("quick_filter", stage_quick_filter),
        ("engine_small", lambda: stage_engine("engine_small", 1 << 20)),
        ("engine", lambda: stage_engine("engine", min(ROWS - 17, 1 << 23))),
    ]
    if os.environ.get("QE_BENCH_OPS", "1") != "0":
        stages.append(("per_op", stage_per_op))
    if os.environ.get("QE_BENCH_TPCH", "1") != "0":
        stages.append(("tpch", stage_tpch))
    stages.append(("fused", stage_fused))
    failed = []
    t_start = time.perf_counter()
    for name, fn in stages:
        try:
            REPORT[name] = fn()
        except Exception:  # noqa: BLE001 - record the stage, run the rest
            failed.append(name)
            REPORT[name] = {"error": traceback.format_exc(limit=3)}
            traceback.print_exc()
        emit()
    REPORT["failed_stages"] = failed
    REPORT["wall_s"] = time.perf_counter() - t_start
    emit()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
