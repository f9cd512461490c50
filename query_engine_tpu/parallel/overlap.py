"""Shuffle/compute overlap: double-buffered chunked exchange.

The reference walks distributed stages strictly sequentially — every
Exchange completes before the next stage's operators start
(crates/query-distributed/src/executor.rs:148-209). The SPMD
redesign overlaps them: rows are split into C chunks, and the stage loop
is unrolled INSIDE one jitted SPMD program so that chunk k+1's
`lax.all_to_all` has no data dependence on chunk k's operator compute.
XLA's latency-hiding scheduler can then issue the collective over the
interconnect while the previous chunk computes — the classic double-buffer
pattern, here at the XLA program level where the compiler owns the async
collective pair.

Two additional wins apply even where collectives cannot physically
overlap (the single-host virtual mesh used for testing):
  * one dispatch instead of 2C (no host round-trip between stages);
  * chunk intermediates stay in chunk-sized working sets instead of
    materializing a full-capacity exchanged table to HBM between stages.

benchmarks/overlap_bench.py measures the fused-overlapped program against
the sequential exchange-then-compute pair.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from query_engine_tpu.ops import kernels as K
from query_engine_tpu.parallel import spmd


def make_overlapped_exchange_aggregate(
    mesh: Mesh,
    n_chunks: int = 4,
    axis: str = "data",
):
    """Hash-repartition + grouped partial-sum, double-buffered over
    `n_chunks` row chunks.

    Per chunk: rows route to their key's owner shard via all_to_all, the
    owner accumulates SUM/COUNT per key bucket. The loop is unrolled so
    chunk k+1's all_to_all is independent of chunk k's aggregation —
    overlap is the compiler's to exploit on a real interconnect.

    Input (per shard): key[cap] int, kv[cap] bool, val[cap] int64,
    n_rows[1]. Output: per-shard bucket sums/counts (buckets = key % n,
    n_buckets per shard static = bucket_cap).
    """
    n = mesh.devices.size
    bucket_cap = 1 << 12  # per-shard key-space slice (static)

    def step(key, kv, val, shard_rows):
        my = jax.lax.axis_index(axis)
        cap = key.shape[0]
        n_rows = shard_rows[my]
        chunk = cap // n_chunks
        sums = jnp.zeros(bucket_cap, jnp.int64)
        cnts = jnp.zeros(bucket_cap, jnp.int32)

        def exchange(k0):
            ck = jax.lax.dynamic_slice_in_dim(key, k0, chunk)
            cv = jax.lax.dynamic_slice_in_dim(kv, k0, chunk)
            cx = jax.lax.dynamic_slice_in_dim(val, k0, chunk)
            live = (jnp.arange(chunk) + k0) < n_rows
            pid = spmd.partition_ids(ck, cv, n)
            idx, counts = spmd.bucket_rows(pid, live, n, chunk)
            rd, rv, rlive = spmd.exchange_columns(
                axis, idx, counts, [ck, cx], [cv, jnp.ones(chunk, bool)]
            )
            return rd, rv, rlive

        def consume(sums, cnts, rd, rv, rlive):
            rkey, rval = rd
            rkv, _ = rv
            ok = rlive & rkv
            # owner-local dense bucket: key -> slot in this shard's slice
            slot = jnp.where(
                ok, (rkey.astype(jnp.int64) // n) % bucket_cap, bucket_cap
            ).astype(jnp.int32)
            sums = sums.at[slot].add(
                jnp.where(ok, rval, 0), mode="drop"
            )
            cnts = cnts.at[slot].add(ok.astype(jnp.int32), mode="drop")
            return sums, cnts

        # double buffer: exchange chunk k+1 is issued before consuming
        # chunk k, so the collective and the scatter-adds are independent
        pending = exchange(0)
        for c in range(1, n_chunks):
            nxt = exchange(c * chunk)
            sums, cnts = consume(sums, cnts, *pending)
            pending = nxt
        sums, cnts = consume(sums, cnts, *pending)
        return sums, cnts

    in_specs = (P(axis), P(axis), P(axis), P())
    out_specs = (P(axis), P(axis))
    return jax.jit(
        spmd.shard_map(step, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs)
    )


def make_sequential_exchange_aggregate(mesh: Mesh, axis: str = "data"):
    """The un-overlapped baseline: one program that exchanges ALL rows,
    plus one program that aggregates the exchanged planes — a hard barrier
    (host dispatch) between the phases, like the reference's stage walk."""
    n = mesh.devices.size
    bucket_cap = 1 << 12

    def exch(key, kv, val, shard_rows):
        my = jax.lax.axis_index(axis)
        cap = key.shape[0]
        live = jnp.arange(cap) < shard_rows[my]
        pid = spmd.partition_ids(key, kv, n)
        idx, counts = spmd.bucket_rows(pid, live, n, cap)
        rd, rv, rlive = spmd.exchange_columns(
            axis, idx, counts, [key, val], [kv, jnp.ones(cap, bool)]
        )
        return rd[0], rd[1], rv[0], rlive

    def agg(rkey, rval, rkv, rlive):
        ok = rlive & rkv
        slot = jnp.where(
            ok, (rkey.astype(jnp.int64) // n) % bucket_cap, bucket_cap
        ).astype(jnp.int32)
        sums = jnp.zeros(bucket_cap, jnp.int64).at[slot].add(
            jnp.where(ok, rval, 0), mode="drop"
        )
        cnts = jnp.zeros(bucket_cap, jnp.int32).at[slot].add(
            ok.astype(jnp.int32), mode="drop"
        )
        return sums, cnts

    exch_p = jax.jit(spmd.shard_map(
        exch, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    ))
    agg_p = jax.jit(spmd.shard_map(
        agg, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
    ))
    return exch_p, agg_p
