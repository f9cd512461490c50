"""Open-addressing hash-join build/probe kernels (XLA, vectorized).

The BASELINE operator the reference never implements (its join_batches is a
Cartesian product that ignores ON keys — crates/query-executor/src/
executor.rs:500-540). This is the classic build/probe redesign:

  * build: open-addressed table (pow2 slots, linear probing) of
    (key, row-id) planes in HBM. Placement is fully vectorized — each
    round, every still-unplaced row proposes its next slot, empty slots
    take the minimum proposing row id (one scatter-min), winners retire
    (occupied slots are never proposed into, so earlier placements are
    never stolen); rounds run under lax.while_loop until all rows placed.
    Round count = max probe-sequence length (~log n / log log n at 50%
    load), not O(n).
  * probe: each probe row walks its sequence under lax.while_loop —
    gather (key, row) at the current slot; empty slot => no match, key
    match => done, else advance. All rows advance in lockstep; iteration
    count = the longest active probe sequence.

Every probe round costs two full-length random gathers, and probe
chains serialize rounds; the engine's default is the sort-rank join. On
the H100, with fast random access and hardware atomics, the two have not
been measured against each other yet (ROADMAP). This module exists as the
BASELINE "hash join build/probe" operator and as that comparison:
bench.py reports both head-to-head.

Scope: build keys must be UNIQUE (SQL FK/dimension joins — the engine
verifies via table stats); duplicate-key builds use the rank path.
NULL keys never match (callers pre-mask validity into `ok`).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_EMPTY = jnp.int32(2147483647)  # INT32_MAX = empty slot sentinel


def _mix32(x: jnp.ndarray) -> jnp.ndarray:
    """murmur3 finalizer on uint32 lanes."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _hash_key(key: jnp.ndarray) -> jnp.ndarray:
    """Key plane -> uint32 hash. 64-bit keys mix hi/lo words separately
    on 32-bit multiplies."""
    if key.dtype in (jnp.int64, jnp.uint64):
        u = key.astype(jnp.uint64)
        lo = (u & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
        hi = (u >> jnp.uint64(32)).astype(jnp.uint32)
        return _mix32(lo) ^ _mix32(hi ^ jnp.uint32(0x9E3779B9))
    return _mix32(key.astype(jnp.uint32))


def table_size_for(n_rows: int, load: float = 0.5) -> int:
    """Pow2 table size at the given max load factor."""
    t = 128
    while t * load < n_rows:
        t *= 2
    return t


def hash_build(
    keys: jnp.ndarray,      # [cap_r] key plane (orderable image)
    ok: jnp.ndarray,        # [cap_r] bool — live, non-null build rows
    table_size: int,        # pow2, > number of ok rows
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Build the open-addressed table. Returns (table_keys[table_size],
    table_rows[table_size] int32, _EMPTY where unoccupied)."""
    cap = keys.shape[0]
    mask = jnp.uint32(table_size - 1)
    h = _hash_key(keys)
    rows = jnp.arange(cap, dtype=jnp.int32)
    t_rows0 = jnp.full(table_size, _EMPTY, dtype=jnp.int32)
    t_keys0 = jnp.zeros(table_size, dtype=keys.dtype)

    def cond(state):
        _, _, placed, _ = state
        return jnp.any(ok & ~placed)

    def body(state):
        t_keys, t_rows, placed, off = state
        active = ok & ~placed
        slot = ((h + off.astype(jnp.uint32)) & mask).astype(jnp.int32)
        # propose only into currently-empty slots: occupied slots are
        # final, so earlier placements can never be stolen
        empty = t_rows[slot] == _EMPTY
        propose = active & empty
        cand = jnp.where(propose, slot, table_size)
        t_rows = t_rows.at[cand].min(rows, mode="drop")
        won = propose & (t_rows[slot] == rows)
        t_keys = t_keys.at[jnp.where(won, slot, table_size)].set(
            keys, mode="drop"
        )
        placed = placed | won
        off = jnp.where(active & ~won, off + 1, off)
        return t_keys, t_rows, placed, off

    t_keys, t_rows, _, _ = jax.lax.while_loop(
        cond, body,
        (t_keys0, t_rows0, jnp.zeros(cap, bool), jnp.zeros(cap, jnp.int32)),
    )
    return t_keys, t_rows


def hash_probe_unique(
    table_keys: jnp.ndarray,
    table_rows: jnp.ndarray,
    probe_keys: jnp.ndarray,   # [cap_l]
    ok: jnp.ndarray,           # [cap_l] live, non-null probe rows
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Probe (unique build keys: at most one match per row). Returns
    (right_row[cap_l] int32, matched[cap_l] bool) — the same contract as
    kernels.fk_join_right_lookup, so callers share the emit path."""
    table_size = table_keys.shape[0]
    mask = jnp.uint32(table_size - 1)
    h = _hash_key(probe_keys)
    cap = probe_keys.shape[0]

    def cond(state):
        active, _, _, _ = state
        return jnp.any(active)

    def body(state):
        active, off, ri, matched = state
        slot = ((h + off.astype(jnp.uint32)) & mask).astype(jnp.int32)
        tr = table_rows[slot]
        tk = table_keys[slot]
        empty = tr == _EMPTY
        hit = active & ~empty & (tk == probe_keys)
        ri = jnp.where(hit, tr, ri)
        matched = matched | hit
        active = active & ~empty & ~hit
        off = jnp.where(active, off + 1, off)
        return active, off, ri, matched

    _, _, ri, matched = jax.lax.while_loop(
        cond, body,
        (
            ok,
            jnp.zeros(cap, jnp.int32),
            jnp.zeros(cap, jnp.int32),
            jnp.zeros(cap, bool),
        ),
    )
    return jnp.where(matched, ri, 0), matched


def hash_join_unique(
    probe_keys: jnp.ndarray,
    probe_ok: jnp.ndarray,
    build_keys: jnp.ndarray,
    build_ok: jnp.ndarray,
    table_size: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """build + probe in one jittable call (bench/engine entry)."""
    t_keys, t_rows = hash_build(build_keys, build_ok, table_size)
    return hash_probe_unique(t_keys, t_rows, probe_keys, probe_ok)
