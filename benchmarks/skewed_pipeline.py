"""BASELINE config #5: TPC-H-style join+agg+sort pipeline on ~100M-row
synthetic tables, hash-partitioned with skewed (Zipf) keys.

Two measurements, each printed as a JSON line:

1. single_chip: throughput of the fused filter -> FK join -> grouped
   aggregate -> sort pipeline at QE_SKEW_ROWS rows (default 10^8) on the
   default device. Keys are Zipf-skewed; the single-device path is
   skew-insensitive by construction (rank lookups, no hash table chains),
   which is itself the answer to join skew on one device.

2. exchange_balance: on an 8-device virtual CPU mesh (the multi-host
   stand-in per SURVEY.md §4), the hash-repartition exchange
   (parallel/spmd.py make_distributed_join_counts) is run over uniform and
   Zipf-skewed keys, with and without salted build replication
   (spmd salt > 1). Reports per-shard received-row imbalance
   (max/mean) — the projected scaling bottleneck — and asserts the skewed
   salted case lands within 1.5x of uniform (BASELINE skew target). These
   are structural/projected numbers: virtual devices serialize on one
   host, so wall-clock is not interconnect time.

Usage:  python benchmarks/skewed_pipeline.py [single_chip|balance|all]
Env:    QE_SKEW_ROWS (default 10^8), QE_SKEW_ZIPF (default 1.2)
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_ROWS = int(os.environ.get("QE_SKEW_ROWS", 100_000_000))
ZIPF_A = float(os.environ.get("QE_SKEW_ZIPF", 1.2))
N_DIM = 1 << 20      # 1M-row dimension table, unique keys
N_GROUPS = 1024


def _zipf_keys(rng, n, n_keys, a):
    """Zipf-distributed keys clipped to [0, n_keys) — a handful of keys
    receive a large share of rows (the join-skew stressor)."""
    z = rng.zipf(a, n)
    return ((z - 1) % n_keys).astype("int32")


def single_chip():
    import numpy as np
    import query_engine_tpu  # noqa: F401  (x64)
    import jax
    import jax.numpy as jnp
    from query_engine_tpu.ops import kernels as K

    cap = 1 << max(17, (N_ROWS - 1).bit_length())
    n = N_ROWS
    rng = np.random.default_rng(5)
    print(f"# generating {n} rows (cap {cap})", file=sys.stderr)
    keys = np.zeros(cap, np.int32)
    keys[:n] = _zipf_keys(rng, n, N_DIM, ZIPF_A)
    vals = rng.integers(0, 1_000_000, cap)
    filt = rng.integers(0, 100, cap).astype(np.int32)
    dim_val = rng.integers(0, 1000, N_DIM)
    dim_grp = rng.integers(0, N_GROUPS, N_DIM).astype(np.int32)


    def pipeline(keys, vals, filt, dim_val, dim_grp, n_rows):
        live = K.live_mask(cap, n_rows)
        keep = live & (filt > 9)  # ~90% selectivity filter
        # FK join: key IS the dim row id (bounds-direct ranks — the
        # compiled pipeline's stats-direct fast path, zero sorts).
        # Each random gather pays per element, so the two narrow dim
        # columns pack into ONE gathered i32 plane
        # (bounds from stats: dim_val < 1000, grp < N_GROUPS).
        packed = (dim_val.astype(jnp.int32) * N_GROUPS
                  + dim_grp.astype(jnp.int32))
        g = packed[keys]
        jval = vals + (g // N_GROUPS).astype(vals.dtype)
        grp = g % N_GROUPS
        # grouped aggregate over the joined group column
        s, _ = K.segment_aggregate("sum", jval, keep, grp, n_rows, N_GROUPS)
        c, _ = K.segment_aggregate("count", jval, keep, grp, n_rows,
                                   N_GROUPS)
        # ORDER BY sum DESC over the group table (top-level sort)
        perm = K.sort_permutation([s], [c > 0], [False], [False], N_GROUPS)
        return s[perm], c[perm], jnp.sum(keep.astype(jnp.int64))

    f = jax.jit(pipeline)
    args = [jnp.asarray(x) for x in (keys, vals, filt, dim_val, dim_grp)]
    args.append(np.int64(n))

    def run():
        s, c, kept = f(*args)
        return float(np.asarray(s)[0]) + float(np.asarray(kept))

    t0 = time.time()
    run()
    print(f"# compile {time.time() - t0:.1f}s", file=sys.stderr)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    rps = n / min(ts)
    print(json.dumps({
        "metric": "skewed_pipeline_single_chip",
        "rows": n, "zipf_a": ZIPF_A,
        "ms": round(min(ts) * 1e3, 1),
        "rows_per_sec": round(rps, 1),
    }))


def _balance_child():
    import numpy as np
    import query_engine_tpu  # noqa: F401
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from query_engine_tpu.parallel import spmd

    n_dev = 8
    devs = jax.devices()[:n_dev]
    mesh = Mesh(np.asarray(devs), ("data",))
    per = 1 << 16  # 64k rows/shard probe side
    rng = np.random.default_rng(11)
    rows = per * n_dev
    nb = 1 << 12

    results = {}
    for dist in ("uniform", "zipf"):
        if dist == "uniform":
            lkey = rng.integers(0, nb, rows).astype(np.int64)
        else:
            lkey = _zipf_keys(rng, rows, nb, ZIPF_A).astype(np.int64)
        rkey = np.arange(nb * n_dev, dtype=np.int64) % nb  # sharded build
        for salt in (1, 4):
            # recv_factor=None: this measures the imbalance of the raw
            # (unbounded) exchange; a bounded recv would clip the hot
            # shard and understate the skew
            prog = spmd.make_distributed_join_counts(
                mesh, 1, 1, salt=salt, recv_factor=None
            )
            out = prog(
                jnp.asarray(lkey), jnp.ones(rows, bool),
                np.full(n_dev, per, np.int64),
                jnp.asarray(rkey), jnp.ones(nb * n_dev, bool),
                np.full(n_dev, nb, np.int64),
                jnp.asarray(lkey), jnp.ones(rows, bool),
                jnp.asarray(rkey), jnp.ones(nb * n_dev, bool),
            )
            # out[1] = per-shard received probe-row counts
            lcount = np.asarray(out[1]).reshape(-1)
            imb = float(lcount.max() / max(lcount.mean(), 1.0))
            results[f"{dist}_salt{salt}"] = {
                "shard_rows_max": int(lcount.max()),
                "shard_rows_mean": round(float(lcount.mean()), 1),
                "imbalance": round(imb, 3),
                "projected_efficiency": round(1.0 / imb, 3),
            }
    # BASELINE skew target: salted skewed within 1.5x of uniform
    ok = (results["zipf_salt4"]["imbalance"]
          <= 1.5 * results["uniform_salt1"]["imbalance"])
    print(json.dumps({
        "metric": "exchange_balance_8vdev",
        "rows_per_shard": per, "zipf_a": ZIPF_A,
        "skew_target_met": bool(ok),
        **results,
    }))


def balance():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    env["QE_SKEW_CHILD"] = "1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, os.path.abspath(__file__), "child"],
                   env=env, check=True)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "all"
    if mode == "child":
        _balance_child()
    elif mode == "single_chip":
        single_chip()
    elif mode == "balance":
        balance()
    else:
        balance()
        single_chip()
