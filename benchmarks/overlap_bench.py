"""Shuffle/compute overlap benchmark (north-star clause; VERDICT item 6).

Compares, on an 8-device virtual CPU mesh:
  * sequential: exchange-ALL program, host barrier, aggregate program
    (the reference's stage walk, executor.rs:148-209);
  * overlapped: ONE double-buffered program interleaving chunked
    all_to_all with the previous chunk's aggregation
    (parallel/overlap.py).

Prints one JSON line with both wall-clocks and the separately-timed phase
costs; the overlap claim is `overlapped_ms < exchange_ms + aggregate_ms`.
On the virtual mesh the win comes from dispatch fusion + smaller live
intermediates; on a real interconnect the XLA latency-hiding scheduler
additionally runs the collective under the scatter-adds.

Usage: python benchmarks/overlap_bench.py  (forces JAX_PLATFORMS=cpu,8 dev)
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def child():
    import numpy as np
    import query_engine_tpu  # noqa: F401
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from query_engine_tpu.parallel.overlap import (
        make_overlapped_exchange_aggregate,
        make_sequential_exchange_aggregate,
    )

    n_dev = 8
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("data",))
    per = 1 << 18  # 256k rows/shard -> 2M rows total
    rows = per * n_dev
    rng = np.random.default_rng(3)
    key = jnp.asarray(rng.integers(0, 1 << 14, rows))
    kv = jnp.ones(rows, bool)
    val = jnp.asarray(rng.integers(0, 1000, rows))
    shard_rows = np.full(n_dev, per, np.int64)

    def timeit(fn, iters=5):
        fn()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return min(ts) * 1e3

    ov = make_overlapped_exchange_aggregate(mesh, n_chunks=4)
    seq_exch, seq_agg = make_sequential_exchange_aggregate(mesh)

    def run_overlapped():
        s, c = ov(key, kv, val, shard_rows)
        jax.block_until_ready((s, c))
        return s

    def run_sequential():
        planes = seq_exch(key, kv, val, shard_rows)
        jax.block_until_ready(planes)  # the stage barrier
        s, c = seq_agg(*planes)
        jax.block_until_ready((s, c))
        return s

    exch_only = lambda: jax.block_until_ready(
        seq_exch(key, kv, val, shard_rows)
    )
    planes = seq_exch(key, kv, val, shard_rows)
    agg_only = lambda: jax.block_until_ready(seq_agg(*planes))

    t_ov = timeit(run_overlapped)
    t_seq = timeit(run_sequential)
    t_ex = timeit(exch_only)
    t_ag = timeit(agg_only)

    # correctness: both paths must agree
    s1, c1 = ov(key, kv, val, shard_rows)
    s2, c2 = seq_agg(*seq_exch(key, kv, val, shard_rows))
    assert np.asarray(jnp.sum(s1)) == np.asarray(jnp.sum(s2))
    assert np.asarray(jnp.sum(c1)) == np.asarray(jnp.sum(c2))

    print(json.dumps({
        "metric": "exchange_compute_overlap_8vdev",
        "rows": rows,
        "overlapped_ms": round(t_ov, 2),
        "sequential_ms": round(t_seq, 2),
        "exchange_phase_ms": round(t_ex, 2),
        "aggregate_phase_ms": round(t_ag, 2),
        "overlap_beats_phase_sum": bool(t_ov < t_ex + t_ag),
        "speedup_vs_sequential": round(t_seq / t_ov, 3),
    }))


if __name__ == "__main__":
    if os.environ.get("QE_OVERLAP_CHILD") == "1":
        child()
    else:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()
        env["QE_OVERLAP_CHILD"] = "1"
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        subprocess.run(
            [sys.executable, os.path.abspath(__file__)], env=env, check=True
        )
