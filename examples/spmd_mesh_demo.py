"""SPMD shuffle over an 8-device mesh: the all_to_all exchange that
replaces the reference's coordinator/worker shuffle."""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

from _common import show  # noqa: F401  (sys.path setup)
import jax

import query_engine_tpu  # noqa: F401
from query_engine_tpu.columnar.batch import ColumnBatch
from query_engine_tpu.parallel import spmd
from query_engine_tpu.parallel.mesh import ShardedTable, make_mesh

mesh = make_mesh(jax.devices()[:8])
rng = np.random.default_rng(0)
batch = ColumnBatch.from_pydict({
    "k": rng.integers(0, 100, 50_000).tolist(),
    "v": rng.integers(0, 10, 50_000).tolist(),
})
st = ShardedTable(batch, mesh)
agg = spmd.make_distributed_aggregate(mesh, aggs=[("count_star", -1), ("sum", 0)], n_args=1)
out = agg(st.datas[0], st.valids[0], st.shard_rows, st.datas[1], st.valids[1])
ngs = np.asarray(out[-1])
print(f"8-device mesh: {int(ngs.sum())} groups, shard counts = {ngs.tolist()}")
