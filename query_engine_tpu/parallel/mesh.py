"""Device mesh + row-sharded tables.

Replaces the reference's coordinator/worker cluster topology
(query-distributed/src/types.rs, coordinator.rs) with the SPMD model:
a `jax.sharding.Mesh` over all devices, tables sharded row-wise along the
'data' axis (the SQL analog of data parallelism — SURVEY.md §5
"long-context" note: scaling the row dimension), and XLA collectives over
the device interconnect instead of Arrow Flight RPCs.

Single controller, SPMD: host 0 drives one jitted program per stage
(SURVEY.md §7 design stance).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from query_engine_tpu.columnar.batch import Column, ColumnBatch, padded_capacity


def make_mesh(devices: Optional[Sequence] = None, axis: str = "data") -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def row_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


class ShardedTable:
    """A ColumnBatch whose planes are sharded row-wise over the mesh.

    Each shard holds capacity/n_devices rows; per-shard live row counts are
    carried in a device plane `shard_rows[n_devices]` so kernels inside
    shard_map can mask their local pad tails.
    """

    def __init__(self, batch: ColumnBatch, mesh: Mesh, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        n = mesh.devices.size
        self.schema = batch.schema
        self.dictionaries = [c.dictionary for c in batch.columns]
        total = batch.num_rows
        per = padded_capacity(max((total + n - 1) // n, 1))
        self.shard_capacity = per
        self.num_rows = total
        counts = np.full(n, per, dtype=np.int64)
        used = 0
        for i in range(n):
            counts[i] = min(per, max(total - used, 0))
            used += counts[i]
        self.shard_rows = jax.device_put(
            jnp.asarray(counts), replicated(mesh)
        )
        sharding = row_sharding(mesh, axis)
        self.datas = []
        self.valids = []
        for c in batch.columns:
            data = np.zeros(per * n, dtype=np.asarray(c.data).dtype)
            valid = np.zeros(per * n, dtype=bool)
            src_d = np.asarray(c.data)[:total]
            src_v = np.asarray(c.validity)[:total]
            used = 0
            for i in range(n):
                k = int(counts[i])
                data[i * per: i * per + k] = src_d[used: used + k]
                valid[i * per: i * per + k] = src_v[used: used + k]
                used += k
            self.datas.append(jax.device_put(jnp.asarray(data), sharding))
            self.valids.append(jax.device_put(jnp.asarray(valid), sharding))

    @property
    def n_devices(self) -> int:
        return self.mesh.devices.size

    def to_batch(self) -> ColumnBatch:
        """Gather back to a host ColumnBatch (drops per-shard padding)."""
        n = self.n_devices
        per = self.shard_capacity
        counts = np.asarray(self.shard_rows)
        keep = np.concatenate(
            [np.arange(i * per, i * per + counts[i]) for i in range(n)]
        ) if n else np.zeros(0, np.int64)
        cap = padded_capacity(len(keep))
        cols = []
        for d, v, dic, f in zip(self.datas, self.valids, self.dictionaries,
                                self.schema):
            hd = np.asarray(d)[keep]
            hv = np.asarray(v)[keep]
            pad_d = np.zeros(cap, dtype=hd.dtype)
            pad_v = np.zeros(cap, dtype=bool)
            pad_d[: len(keep)] = hd
            pad_v[: len(keep)] = hv
            cols.append(Column(pad_d, pad_v, f.data_type, dic))
        return ColumnBatch(self.schema, cols, len(keep))
