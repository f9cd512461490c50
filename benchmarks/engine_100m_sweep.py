"""Chunk-size sweep for the 100M steady-state probe: build + upload the
100M-row table ONCE (the upload dominates set-up), then re-run the
chunked aggregate query at several QE_CHUNK_ROWS settings through the same
session — compiled programs are keyed by capacity so the settings don't
collide.

Env: QE_100M_ROWS (default 10^8), QE_SWEEP (default "25,24,23" — log2 chunk
sizes), QE_100M_ITERS (default 5).
Prints one JSON line per setting.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

import query_engine_tpu  # noqa: F401  (x64)

from query_engine_tpu.columnar.batch import ColumnBatch
from query_engine_tpu.core.schema import Field, Schema
from query_engine_tpu.core.types import DataType
from query_engine_tpu.engine.session import Session


def main():
    n = int(os.environ.get("QE_100M_ROWS", 100_000_000))
    iters = int(os.environ.get("QE_100M_ITERS", 5))
    sweep = [int(x) for x in os.environ.get("QE_SWEEP", "25,24,23").split(",")]
    nd = 1024
    rng = np.random.default_rng(7)
    print(f"# building {n} rows", file=sys.stderr)
    fact = ColumnBatch.from_pydict({
        "age": rng.integers(18, 65, n),
        "salary": rng.integers(50_000, 150_000, n),
        "dept": rng.integers(0, nd, n),
    }, Schema([Field("age", DataType.int64()),
               Field("salary", DataType.int64()),
               Field("dept", DataType.int64())]))
    dim = ColumnBatch.from_pydict({
        "dept_id": np.arange(nd), "bonus": rng.integers(0, 1000, nd),
    })
    s = Session()
    s.register_table("f", fact)
    s.register_table("d", dim)
    q = ("SELECT f.dept, COUNT(*) AS c, SUM(f.salary + d.bonus) AS s "
         "FROM f JOIN d ON f.dept = d.dept_id "
         "WHERE f.age > 25 GROUP BY f.dept ORDER BY s DESC LIMIT 10")

    for lg in sweep:
        os.environ["QE_CHUNK_ROWS"] = str(1 << lg)
        t0 = time.time()
        try:
            s.sql(q)  # compile + warm for this chunk capacity
        except Exception as e:
            print(json.dumps({
                "metric": "engine_100m_sweep", "chunk_log2": lg,
                "ok": False, "error": repr(e)[:300],
            }), flush=True)
            continue
        print(f"# 2^{lg}: first dispatch+compile {time.time() - t0:.1f}s",
              file=sys.stderr)
        ts = []
        for i in range(iters):
            t0 = time.perf_counter()
            s.sql(q)
            ts.append(time.perf_counter() - t0)
        best = min(ts)
        print(json.dumps({
            "metric": "engine_100m_sweep", "chunk_log2": lg, "ok": True,
            "rows": n, "ms_best": round(best * 1e3, 1),
            "ms_all": [round(t * 1e3, 1) for t in ts],
            "rows_per_sec": round(n / best, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
