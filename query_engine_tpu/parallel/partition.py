"""Partitioner: hash / range / round-robin / single.

Parity surface: reference crates/query-distributed/src/partition.rs:12-359 —
row-level Hash partitioning (per-row hash over key columns % num_partitions,
gather rows per partition via take, :151-212,292-316), Range (boundary scan
:232-289), RoundRobin (batch-level modulo :215-229), Single (gather), and
`route(key)` for key->partition routing.

Partition ids are computed on-device (splitmix64 of the
orderable key), the per-partition gathers are device `take`s, and inside an
SPMD program the same math feeds `lax.all_to_all` (parallel/spmd.py) instead
of materializing per-partition batches. This host-level API exists for the
distributed executor's stage boundaries and for parity tests.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from query_engine_tpu.core.errors import DistributedError
from query_engine_tpu.columnar.batch import ColumnBatch
from query_engine_tpu.ops import kernels as K
from query_engine_tpu.parallel.spmd import splitmix64


class PartitionStrategy(enum.Enum):
    HASH = "hash"
    RANGE = "range"
    ROUND_ROBIN = "round_robin"
    SINGLE = "single"


@dataclass
class RangeBoundary:
    """Upper bound (exclusive) of a range partition (partition.rs:319-340)."""

    upper: float


class Partitioner:
    def __init__(
        self,
        strategy: PartitionStrategy,
        num_partitions: int,
        key_columns: Optional[List[str]] = None,
        boundaries: Optional[List[RangeBoundary]] = None,
    ):
        if num_partitions <= 0:
            raise DistributedError("num_partitions must be positive")
        self.strategy = strategy
        self.num_partitions = num_partitions
        self.key_columns = key_columns or []
        self.boundaries = boundaries

    # ---- constructors (reference Exchange::hash/round_robin/gather) ----
    @staticmethod
    def hash(num_partitions: int, key_columns: List[str]) -> "Partitioner":
        return Partitioner(PartitionStrategy.HASH, num_partitions, key_columns)

    @staticmethod
    def round_robin(num_partitions: int) -> "Partitioner":
        return Partitioner(PartitionStrategy.ROUND_ROBIN, num_partitions)

    @staticmethod
    def range(num_partitions: int, key_columns: List[str],
              boundaries: List[RangeBoundary]) -> "Partitioner":
        return Partitioner(
            PartitionStrategy.RANGE, num_partitions, key_columns, boundaries
        )

    @staticmethod
    def single() -> "Partitioner":
        return Partitioner(PartitionStrategy.SINGLE, 1)

    # ---- partitioning ---------------------------------------------------
    def partition(self, batch: ColumnBatch) -> List[ColumnBatch]:
        """Split a batch into num_partitions batches (row conservation
        guaranteed — reference partition tests partition.rs:361-441)."""
        n = batch.num_rows
        if self.strategy is PartitionStrategy.SINGLE:
            return [batch]
        if self.strategy is PartitionStrategy.ROUND_ROBIN:
            pid = np.arange(n) % self.num_partitions
        elif self.strategy is PartitionStrategy.HASH:
            pid = np.asarray(self._hash_pids(batch))[:n]
        elif self.strategy is PartitionStrategy.RANGE:
            pid = self._range_pids(batch)
        else:
            raise DistributedError(f"unknown strategy {self.strategy}")
        out = []
        for p in range(self.num_partitions):
            rows = np.nonzero(pid == p)[0]
            out.append(batch.take_host(rows))
        return out

    def _key_plane(self, batch: ColumnBatch, col: str):
        c = batch.column(col)
        return jnp.asarray(c.data), jnp.asarray(c.validity)

    def _hash_pids(self, batch: ColumnBatch) -> jnp.ndarray:
        if not self.key_columns:
            raise DistributedError("hash partitioning requires key columns")
        acc = None
        valid_all = None
        for col in self.key_columns:
            data, valid = self._key_plane(batch, col)
            h = splitmix64(K.orderable_i64(data).astype(jnp.int64))
            h = jnp.where(valid, h, jnp.uint64(0))
            acc = h if acc is None else splitmix64(acc ^ h)
            valid_all = valid if valid_all is None else (valid_all & valid)
        pid = (acc % jnp.uint64(self.num_partitions)).astype(jnp.int32)
        return jnp.where(valid_all, pid, 0)

    def _range_pids(self, batch: ColumnBatch) -> np.ndarray:
        if not self.boundaries:
            raise DistributedError("range partitioning requires boundaries")
        col = batch.column(self.key_columns[0])
        vals = np.asarray(col.data)[: batch.num_rows].astype(np.float64)
        uppers = np.asarray([b.upper for b in self.boundaries])
        pid = np.searchsorted(uppers, vals, side="right")
        return np.clip(pid, 0, self.num_partitions - 1)

    def route(self, key) -> int:
        """Single-key routing (reference partition.rs route)."""
        if self.strategy is PartitionStrategy.SINGLE:
            return 0
        if self.strategy is PartitionStrategy.HASH:
            h = int(np.asarray(splitmix64(jnp.asarray([np.int64(hash(key))]))))
            return h % self.num_partitions
        if self.strategy is PartitionStrategy.RANGE:
            uppers = [b.upper for b in self.boundaries]
            return int(
                np.clip(np.searchsorted(uppers, float(key), side="right"),
                        0, self.num_partitions - 1)
            )
        raise DistributedError("route() not defined for round-robin")
