"""Grouped-aggregate timings on the accelerator, in one process.

    python benchmarks/agg_probe.py

At 2^24 rows and 1,024 groups, the shape bench.py's aggregate uses:

1. The grouped aggregate GROUP BY takes (K.segment_aggregate): one int64
   SUM plus COUNT, jitted alone; its time and its share of
   the device's published memory bandwidth (bytes it must read: the int64
   values, the int32 group ids and the validity bytes).
2. A native int64 scatter-add (jax.ops.segment_sum) over the same groups,
   the alternative to K.segment_aggregate's chunked int32 scatters.
3. The float SUM GROUP BY takes: a native f64 scatter-add.

Times are medians of 20 runs, each ended by block_until_ready. Every line
names the device (profiling.device_record).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import query_engine_tpu  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from query_engine_tpu.ops import kernels as K  # noqa: E402
from query_engine_tpu.utils.profiling import (  # noqa: E402
    device_peaks, device_record,
)

ROWS = 1 << 24
GROUPS = 1024
REPS = 20


def timed(fn):
    jax.block_until_ready(fn())  # compile + warm
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main():
    rec = device_record()
    peaks = device_peaks()
    n, G = ROWS, GROUPS

    rng = np.random.default_rng(0)
    gid = jnp.asarray(rng.integers(0, G, n).astype(np.int32))
    ok = jnp.asarray(rng.random(n) > 0.1)
    ivals = jnp.asarray(rng.integers(1, 51, n).astype(np.int64))
    fvals = jnp.asarray(np.round(rng.uniform(900, 105000, n), 2))

    def emit(**kw):
        print(json.dumps({**kw, "rows": n, "groups": G, "device": rec}),
              flush=True)

    @jax.jit
    def sum_count(v, ok, gid):
        s, _ = K.segment_aggregate("sum", v, ok, gid, n, G)
        c, _ = K.segment_aggregate("count", v, ok, gid, n, G)
        return s, c

    t = timed(lambda: sum_count(ivals, ok, gid))
    need = n * (8 + 4 + 1)
    emit(probe="grouped_sum_count_i64", ms=t * 1e3, bytes_read=need,
         hbm_share=need / peaks["hbm_bytes_per_sec"] / t if peaks else None)

    @jax.jit
    def native_s64(v, ok, gid):
        return jax.ops.segment_sum(jnp.where(ok, v, 0), gid, num_segments=G)

    emit(probe="segment_sum_s64_native",
         ms=timed(lambda: native_s64(ivals, ok, gid)) * 1e3)

    @jax.jit
    def sum_f64(v, ok, gid):
        return K.segment_aggregate("sum", v, ok, gid, n, G)[0]

    emit(probe="grouped_sum_f64",
         ms=timed(lambda: sum_f64(fvals, ok, gid)) * 1e3)


if __name__ == "__main__":
    main()
