"""SQL on a device mesh: the distributed execution walkthrough.

The reference's distributed layer plans stages and then *simulates* them
(crates/query-distributed/src/executor.rs:242-251 echoes partition input;
worker.rs:132-137 is a TODO). This engine's distributed path is real:
`Session(mesh=...)` lowers each eligible query to ONE jitted
`shard_map` program over the mesh —

    sharded scan  ->  local filter  ->  all_to_all hash repartition
    -> local sort-merge join -> partial aggregate -> all_to_all of the
    partial GROUPS -> final combine -> sampled range-partition sort

No RPC, no serialization: the shuffle IS the collective, and everything
between collectives reuses the single-chip compiled kernels, so results
are bit-identical to the single-device engine.

This demo runs on a virtual 8-device CPU mesh (the same mechanism the
test suite uses); on real GPUs the identical program runs over their
interconnect (python chip_smoke.py --devices 4).

Run: python examples/mesh_sql_walkthrough.py
"""

import os
import sys

# virtual 8-device CPU mesh BEFORE jax initializes
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import query_engine_tpu  # noqa: F401,E402
import jax  # noqa: E402

from query_engine_tpu.engine.session import Session  # noqa: E402
from query_engine_tpu.parallel.mesh import make_mesh  # noqa: E402
from query_engine_tpu.cli.format import format_table  # noqa: E402

print(f"devices: {jax.devices()}")
mesh = make_mesh(jax.devices()[:8])
print(f"mesh: {mesh}")

# ---- a small star schema ---------------------------------------------------
rng = np.random.default_rng(42)
N = 50_000
orders = {
    "o_id": list(range(N)),
    "cust": rng.integers(0, 500, N).tolist(),
    "amount": rng.integers(1, 1000, N).tolist(),
}
customers = {
    "c_id": list(range(500)),
    "region": rng.choice(
        ["EMEA", "APAC", "AMER", "LATAM"], 500
    ).tolist(),
}

dist = Session(mesh=mesh)     # <- the only change vs a single-chip session
local = Session()
for s in (dist, local):
    s.register_table("orders", orders)
    s.register_table("customers", customers)

# ---- 1) the full pipeline: filter + join + group + sort --------------------
q = (
    "SELECT c.region, COUNT(*) AS n, SUM(o.amount) AS total "
    "FROM orders o JOIN customers c ON o.cust = c.c_id "
    "WHERE o.amount > 250 "
    "GROUP BY c.region ORDER BY total DESC"
)
print("\n=== distributed:", q)
r_mesh = dist.sql(q)
print(format_table(r_mesh))
assert r_mesh.to_pylist() == local.sql(q).to_pylist(), "parity violated!"
print("bit-identical to the single-device engine ✓")

# what actually happened on the mesh:
st = dist.mesh_pipeline.stats
print(f"mesh stats: {st}")
print(
    "  - the join repartitioned BOTH sides by key hash (2 all_to_all)\n"
    "  - the aggregate ran partial-per-shard, exchanged partial GROUPS\n"
    "    (not rows), and combined on the owning shard\n"
    "  - ORDER BY sampled pivots (all_gather), range-partitioned rows,\n"
    "    and sorted locally: shard-order concatenation IS the answer"
)

# ---- 2) program reuse: the second run hits the compiled cache --------------
before = dist.mesh_pipeline.stats["compiles"]
dist.sql(q)
assert dist.mesh_pipeline.stats["compiles"] == before
print(f"\nre-run compiled nothing (hits={dist.mesh_pipeline.stats['hits']})")

# ---- 3) skew is handled by grow-and-retry ----------------------------------
# every row shares one join key: the bounded exchange (balanced share x
# 1.25 by default) overflows, the driver doubles the factor and retries;
# the working factor is remembered per plan shape.
skew = {"k": [7] * 20_000, "v": list(range(20_000))}
dim = {"k": list(range(16)), "w": [10 * i for i in range(16)]}
for s in (dist, local):
    s.register_table("skew", skew)
    s.register_table("dim", dim)
qs = "SELECT SUM(s.v + d.w) AS t FROM skew s JOIN dim d ON s.k = d.k"
assert dist.sql(qs).to_pylist() == local.sql(qs).to_pylist()
print(
    f"skewed join correct after "
    f"{dist.mesh_pipeline.stats['overflow_retries']} overflow retr(y/ies)"
)

# ---- 4) global aggregates ride all_gather ----------------------------------
qg = ("SELECT COUNT(*), MIN(amount), MAX(amount), AVG(amount) "
      "FROM orders WHERE amount % 3 = 0")
print("\n=== global aggregate (psum-style combine):", qg)
print(format_table(dist.sql(qg)))
assert dist.sql(qg).to_pylist() == local.sql(qg).to_pylist()

# ---- 5) anything without a distributed lowering falls back cleanly ---------
qw = ("SELECT o_id, ROW_NUMBER() OVER (ORDER BY amount DESC) AS rn "
      "FROM orders LIMIT 5")
assert dist.sql(qw).to_pylist() == local.sql(qw).to_pylist()
print("\nwindow query fell back to the single-device engine, same answer ✓")
print("\nmesh walkthrough OK")
