"""SPMD distributed query kernels: shard_map pipelines over the mesh.

This is the SPMD replacement for the reference's distributed shuffle
(query-distributed: Partitioner partition.rs:151-212 per-row hash + take,
Exchange/Merge operators.rs:17-294, two-stage partial/final aggregates
planner.rs:200-226): rows live sharded across chips, the hash shuffle is a
single `lax.all_to_all` inside a jitted shard_map program, and
partial/final aggregation happens on both sides of that collective — no
serialization, no RPC (SURVEY.md §5 "Distributed communication backend").

All shapes are static: each device buckets its rows into an [n_devices,
shard_capacity] send buffer (worst-case skew bound), all_to_all swaps the
leading axis, and local kernels mask by live-row counts that travel with
the data.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from query_engine_tpu.ops import kernels as K


def shard_map(f, mesh, in_specs, out_specs, **kw):
    """jax.shard_map with replication checking off (our kernels mix
    per-shard scalars and collectives freely)."""
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False, **kw,
    )


# ---------------------------------------------------------------------------
# hashing (splitmix64 finalizer — good avalanche, 64-bit lanes)
# ---------------------------------------------------------------------------


def splitmix64(x: jnp.ndarray) -> jnp.ndarray:
    x = x.astype(jnp.uint64)
    x = (x ^ (x >> 30)) * jnp.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> 27)) * jnp.uint64(0x94D049BB133111EB)
    x = x ^ (x >> 31)
    return x


def partition_ids(
    key: jnp.ndarray, valid: jnp.ndarray, n_parts: int
) -> jnp.ndarray:
    """Row -> partition id by key hash; NULL keys all route to partition 0
    (they form one group / never match in joins, so co-location is all that
    matters). Mirrors reference hash partitioning partition.rs:151-212."""
    h = splitmix64(K.orderable_i64(key).astype(jnp.int64))
    pid = (h % jnp.uint64(n_parts)).astype(jnp.int32)
    return jnp.where(valid, pid, 0)


# ---------------------------------------------------------------------------
# the exchange: bucket locally, all_to_all across the mesh
# ---------------------------------------------------------------------------


def bucket_rows(
    pid: jnp.ndarray, live: jnp.ndarray, n_parts: int, per: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gather row indices per destination partition.

    Returns (idx[n_parts, per] local row index planes, counts[n_parts]).
    Slots beyond a destination's count hold garbage indices — consumers mask
    by `counts` (exchange_columns does). Rows past a destination's `per`
    capacity are dropped (callers count the drop as exchange overflow and
    grow-retry).

    For the mesh-sized n_parts (<= 32) this is a COUNTING scatter, not a
    sort: a [rows, n_parts] one-hot cumsum gives each row its within-bucket
    rank in O(rows * n_parts) elementwise work (constant total work
    across the mesh, since rows = table/n_parts per shard), then ONE
    scatter places row indices into their [dest, rank] slot, in place of
    a stable lax.sort([pid, iota]).
    Above 32 destinations the sort variant wins again (one-hot width) and
    is kept as the fallback.
    """
    rows = pid.shape[0]
    key = jnp.where(live, pid.astype(jnp.int32), jnp.int32(n_parts))
    if n_parts <= 32:
        lanes = jnp.arange(n_parts, dtype=jnp.int32)
        onehot = key[:, None] == lanes[None, :]
        pc = jnp.cumsum(onehot.astype(jnp.int32), axis=0)  # inclusive
        counts = pc[-1].astype(jnp.int64)
        within = jnp.sum(jnp.where(onehot, pc, 0), axis=1) - 1
        pos = key.astype(jnp.int64) * per + within.astype(jnp.int64)
        ok = live & (within < per)
        pos = jnp.where(ok, pos, n_parts * per)  # dropped/dead -> spill slot
        iota = jnp.arange(rows, dtype=jnp.int32)
        flat = jnp.zeros(n_parts * per + 1, jnp.int32).at[pos].set(
            iota, mode="drop"
        )
        return flat[:-1].reshape(n_parts, per), counts
    iota = jnp.arange(rows, dtype=jnp.int32)
    _, siota = jax.lax.sort([key, iota], num_keys=1, is_stable=True)
    counts = jax.ops.segment_sum(
        live.astype(jnp.int64), key, num_segments=n_parts + 1
    )[:n_parts]
    starts = jnp.cumsum(counts) - counts
    slot = jax.lax.broadcasted_iota(jnp.int64, (n_parts, per), 1)
    gpos = jnp.clip(starts[:, None] + slot, 0, rows - 1).astype(jnp.int32)
    return siota[gpos], counts


def exchange_columns(
    axis: str,
    idx: jnp.ndarray,          # [n, per] send row indices
    counts: jnp.ndarray,       # [n] send counts
    datas: Sequence[jnp.ndarray],
    valids: Sequence[jnp.ndarray],
):
    """Shuffle rows to their destination shards. Runs inside shard_map.

    Returns (recv_datas [n*per], recv_valids, recv_live [n*per] bool).
    recv_live marks which received slots hold real rows.
    """
    n, per = idx.shape
    # slot mask for send buffers
    slot = jax.lax.broadcasted_iota(jnp.int64, (n, per), 1)
    send_live = slot < counts[:, None]
    recv_counts = jax.lax.all_to_all(counts, axis, 0, 0, tiled=True)
    recv_live = (
        jax.lax.broadcasted_iota(jnp.int64, (n, per), 1)
        < recv_counts.reshape(n, 1)
    ).reshape(-1)
    out_d, out_v = [], []
    for d, v in zip(datas, valids):
        send = d[idx]  # [n, per]
        send_valid = v[idx] & send_live
        recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=True)
        recv_v = jax.lax.all_to_all(send_valid, axis, 0, 0, tiled=True)
        out_d.append(recv.reshape(-1))
        out_v.append(recv_v.reshape(-1) )
    return out_d, out_v, recv_live


def compact_received(recv_live, datas, valids, out_capacity: int = None):
    """Compact received rows to the front of the local planes (cumsum +
    scatter, not nonzero — K.compaction_indices rationale).

    out_capacity bounds the compacted planes: the receive buffer is
    [n_devices, per_shard] = whole-table worst case, but a balanced
    exchange delivers ~per_shard rows per shard — without the bound,
    every downstream local operator runs at WHOLE-TABLE capacity and
    total work grows with N (measured 4.7x inflation at N=8 for the
    distributed join before this). Rows beyond out_capacity are dropped;
    callers must check count <= out_capacity (overflow -> retry larger,
    the mesh-level count-then-emit)."""
    cap = recv_live.shape[0]
    count = jnp.sum(recv_live.astype(jnp.int64))
    oc = cap if out_capacity is None else min(out_capacity, cap)
    idx = K.compaction_indices(recv_live, recv_live, oc)
    out_d = [d[idx] for d in datas]
    out_v = [v[idx] & (jnp.arange(oc) < count) for v in valids]
    return out_d, out_v, count


# ---------------------------------------------------------------------------
# distributed hash aggregate (partial -> shuffle -> final)
# ---------------------------------------------------------------------------

_AGG_PARTIAL = {
    # final-combine function for each aggregate's partial columns
    "count_star": ("sum",),
    "count": ("sum",),
    "sum": ("sum",),
    "min": ("min",),
    "max": ("max",),
    "avg": ("sum", "sum"),  # (sum, count)
}


def local_partial_aggregate(
    keys, key_valids, n_rows, aggs: Sequence[Tuple[str, int]],
    arg_datas: Sequence, arg_valids: Sequence,
):
    """Per-shard grouped partial aggregation (multi-key).

    aggs: list of (func, arg_index or -1). Returns (group_keys, group_valids,
    partial planes list, num_groups) at local capacity.
    """
    cap = keys[0].shape[0]
    gid, ng, rep = K.group_ids(keys, key_valids, n_rows)
    out_key = [k[rep] for k in keys]
    out_kv = [v[rep] for v in key_valids]
    partials = []
    for func, ai in aggs:
        data = arg_datas[ai] if ai >= 0 else None
        valid = arg_valids[ai] if ai >= 0 else None
        if func == "avg":
            s, sv = K.segment_aggregate("sum", data, valid, gid, n_rows, cap)
            c, _ = K.segment_aggregate("count", data, valid, gid, n_rows, cap)
            partials.append((s, sv))
            partials.append((c.astype(jnp.float64), jnp.ones(cap, bool)))
        else:
            v, vv = K.segment_aggregate(func, data, valid, gid, n_rows, cap)
            partials.append((v, vv))
    return out_key, out_kv, partials, ng


def local_final_aggregate(
    keys, key_valids, n_rows, combine_funcs: Sequence[str],
    partial_datas: Sequence, partial_valids: Sequence,
):
    """Combine partial rows that landed on this shard after the exchange."""
    cap = keys[0].shape[0]
    gid, ng, rep = K.group_ids(keys, key_valids, n_rows)
    out_key = [k[rep] for k in keys]
    out_kv = [v[rep] for v in key_valids]
    outs = []
    for cf, d, v in zip(combine_funcs, partial_datas, partial_valids):
        val, vv = K.segment_aggregate(cf, d, v, gid, n_rows, cap)
        outs.append((val, vv))
    return out_key, out_kv, outs, ng


def make_distributed_aggregate(
    mesh: Mesh, aggs: Sequence[Tuple[str, int]], n_args: int,
    axis: str = "data", n_keys: int = 1, group_capacity: int = None,
):
    """Build a jitted SPMD grouped-aggregate: rows sharded on `axis` ->
    per-group results sharded by group-key hash. Supports multi-column
    group keys (n_keys planes; partition id = combined splitmix64 hash).

    group_capacity bounds the per-shard group count AFTER the local partial
    aggregate (callers derive it from dictionary sizes / key-range stats the
    same way the single-chip compiled pipeline does). It shrinks the
    exchange from [n_devices, row_capacity] to [n_devices, group_capacity]
    — the all_to_all then moves partial groups, not row-capacity planes.
    None keeps the safe worst-case bound (every live row its own group).

    Input (per call): n_keys key planes, n_keys validity planes, shard row
    counts, arg planes. Output: group key/validity planes, per-agg
    (value, valid) planes, per-shard group counts — all still sharded.
    """
    n = mesh.devices.size

    combine: List[str] = []
    for func, _ in aggs:
        combine.extend(_AGG_PARTIAL[func])

    def step(*flat_in):
        keys = list(flat_in[:n_keys])
        kvs = list(flat_in[n_keys: 2 * n_keys])
        shard_rows = flat_in[2 * n_keys]
        args = flat_in[2 * n_keys + 1:]
        my = jax.lax.axis_index(axis)
        n_rows = shard_rows[my]
        cap = keys[0].shape[0]
        arg_datas = list(args[:n_args])
        arg_valids = list(args[n_args:])

        # 1) local partial aggregate
        gkeys, gkvs, partials, ng = local_partial_aggregate(
            keys, kvs, n_rows, aggs, arg_datas, arg_valids
        )
        S = min(group_capacity, cap) if group_capacity else cap
        if S < cap:
            gkeys = [k[:S] for k in gkeys]
            gkvs = [v[:S] for v in gkvs]
            partials = [(p[:S], pv[:S]) for p, pv in partials]
        # 2) shuffle partial groups by combined key hash
        pid = combined_partition_ids(gkeys, gkvs, n)
        live = jnp.arange(S) < ng
        idx, counts = bucket_rows(pid, live, n, S)
        datas = gkeys + [p[0] for p in partials]
        valids = gkvs + [p[1] for p in partials]
        rdatas, rvalids, rlive = exchange_columns(axis, idx, counts, datas, valids)
        cdatas, cvalids, ccount = compact_received(rlive, rdatas, rvalids)
        # 3) local final aggregate (received key validity carries null-ness;
        # padding rows are masked by ccount inside the grouping kernels)
        fkeys, fkvs, outs, fng = local_final_aggregate(
            cdatas[:n_keys], cvalids[:n_keys], ccount, combine,
            cdatas[n_keys:], cvalids[n_keys:],
        )
        flat = list(fkeys) + list(fkvs)
        for v, vv in outs:
            flat += [v, vv]
        flat.append(fng.reshape(1))
        return tuple(flat)

    in_specs = tuple(
        [P(axis)] * (2 * n_keys) + [P()] + [P(axis)] * (2 * n_args)
    )
    n_out = 2 * n_keys + 2 * len(combine) + 1
    out_specs = tuple([P(axis)] * n_out)
    return jax.jit(
        shard_map(step, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    )


def combined_partition_ids(keys, valids, n_parts: int) -> jnp.ndarray:
    """Partition ids from the combined hash of several key columns (rows
    with any NULL key route to partition 0, like partition_ids)."""
    acc = None
    all_valid = None
    for k, v in zip(keys, valids):
        h = splitmix64(K.orderable_i64(k).astype(jnp.int64))
        h = jnp.where(v, h, jnp.uint64(0))
        acc = h if acc is None else splitmix64(acc ^ h)
        all_valid = v if all_valid is None else (all_valid & v)
    pid = (acc % jnp.uint64(n_parts)).astype(jnp.int32)
    return jnp.where(all_valid, pid, 0)


def _recv_key_valid(key_validity, rlive, ccount):
    # key validity of received rows already carries null-ness; padding rows
    # are masked by ccount inside the grouping kernels
    return key_validity


# ---------------------------------------------------------------------------
# distributed hash join (repartition both sides -> local sort-merge join)
# ---------------------------------------------------------------------------


def _cap128(x: int) -> int:
    """Capacity rounding in multiples of 128 lanes — NOT pow2 buckets:
    pow2 rounding of a 1.25x-slack capacity costs up to 2x local-work
    inflation by itself (round-2 scaling showed 1.84-1.89x join/sort
    inflation from exactly this; docs/DESIGN.md #4)."""
    return max(128, ((int(x) + 127) // 128) * 128)


def send_cap(per_shard: int, n: int, factor) -> int:
    """Per-destination send-buffer capacity: the balanced share x factor.
    factor=None keeps the whole-table worst case."""
    if factor is None:
        return per_shard
    want = int(np.ceil(per_shard / n * factor))
    return min(_cap128(want), per_shard)


DEFAULT_RECV_FACTOR = 1.125  # bounded exchanges are the DEFAULT; overflow
# flags + the caller's grow-and-retry handle skew (docs/DESIGN.md #4).
# Round 5: 1.25 -> 1.125. Every point of receive capacity is a point of
# LOCAL WORK downstream (the received planes feed full-capacity sorts and
# scans), and splitmix64 hash balance at mesh sizes is sub-percent for
# non-degenerate keys — the 1.25 slack was charging a ~12% local-work tax
# on every exchange to avoid retries that the factor-memory makes
# once-per-plan-shape anyway (SCALING_r04 join_n2 inflation 1.267, most
# of it exactly this capacity tax).


def make_distributed_join_counts(mesh: Mesh, n_left_cols: int,
                                 n_right_cols: int, axis: str = "data",
                                 salt: int = 1,
                                 recv_factor: float = DEFAULT_RECV_FACTOR):
    """Build the SPMD 'repartition + local join count' program.

    Returns per-shard: exchanged left/right planes (compacted) + local
    match counts — the host then sizes emit buffers per shard (count-then-
    emit across the mesh).

    Skew-aware repartitioning (BASELINE skew target; PAPERS.md join-skew
    refs): with salt > 1, each probe (left) row routes to one of `salt`
    consecutive partitions of its key hash, and every build (right) row is
    replicated to all `salt` of them — hot keys spread over `salt` shards
    instead of melting one. salt=1 is the plain hash shuffle.

    Exchanges are bounded by DEFAULT (recv_factor=1.25): both the send
    planes (balanced share x factor per destination) and the compacted
    receive planes. Skew beyond the bound trips the trailing overflow
    output — the caller retries with a larger factor (or salts). Pass
    recv_factor=None for the always-correct whole-table worst case
    (measured 4.7x total-work inflation at N=8).
    """
    n = mesh.devices.size
    salt = max(1, min(salt, n))

    def _rcap(per_shard: int, mult: int = 1) -> int:
        """Compacted receive capacity: balanced share x factor."""
        if recv_factor is None:
            return per_shard * mult * n
        want = int(per_shard * mult * recv_factor)
        return min(_cap128(want), per_shard * mult * n)

    def step(lkey, lkv, l_rows, rkey, rkv, r_rows, *cols):
        my = jax.lax.axis_index(axis)
        nl = l_rows[my]
        nr = r_rows[my]
        lcap = lkey.shape[0]
        rcap = rkey.shape[0]
        ldatas = list(cols[:n_left_cols])
        lvalids = list(cols[n_left_cols: 2 * n_left_cols])
        rdatas = list(cols[2 * n_left_cols: 2 * n_left_cols + n_right_cols])
        rvalids = list(cols[2 * n_left_cols + n_right_cols:])

        # repartition left by key hash (+ per-row salt when salt > 1)
        lpid = partition_ids(lkey, lkv, n)
        if salt > 1:
            row_salt = (jnp.arange(lcap, dtype=jnp.int32) % salt)
            lpid = (lpid + row_salt) % n
        llive = jnp.arange(lcap) < nl
        sc_l = send_cap(lcap, n, recv_factor)
        lidx, lcounts = bucket_rows(lpid, llive, n, sc_l)
        send_drop_l = jnp.sum(jnp.maximum(lcounts - sc_l, 0))
        ld, lv, llive_r = exchange_columns(
            axis, lidx, lcounts, [lkey] + ldatas, [lkv] + lvalids
        )
        lcd, lcv, lcount = compact_received(llive_r, ld, lv, _rcap(lcap))
        # repartition right; with salting the build side is replicated to
        # every salted partition of its key
        if salt > 1:
            rep = salt
            rkey_r = jnp.tile(rkey, rep)
            rkv_r = jnp.tile(rkv, rep)
            rdatas_r = [jnp.tile(d, rep) for d in rdatas]
            rvalids_r = [jnp.tile(v, rep) for v in rvalids]
            s_of = jnp.repeat(
                jnp.arange(rep, dtype=jnp.int32), rcap
            )
            rpid = (partition_ids(rkey_r, rkv_r, n) + s_of) % n
            rlive = jnp.tile(jnp.arange(rcap) < nr, rep)
            rcap_eff = rcap * rep
        else:
            rkey_r, rkv_r = rkey, rkv
            rdatas_r, rvalids_r = rdatas, rvalids
            rpid = partition_ids(rkey, rkv, n)
            rlive = jnp.arange(rcap) < nr
            rcap_eff = rcap
        sc_r = send_cap(rcap_eff, n, recv_factor)
        ridx, rcounts = bucket_rows(rpid, rlive, n, sc_r)
        send_drop_r = jnp.sum(jnp.maximum(rcounts - sc_r, 0))
        rd, rv, rlive_r = exchange_columns(
            axis, ridx, rcounts, [rkey_r] + rdatas_r, [rkv_r] + rvalids_r
        )
        rcd, rcv, rcount = compact_received(
            rlive_r, rd, rv, _rcap(rcap, salt)
        )

        # local join ranks + counts
        lr, rr = K.join_ranks(
            [(lcd[0], lcv[0])], [(rcd[0], rcv[0])], lcount, rcount
        )
        (total, counts, _offsets, rank_start, right_by_rank,
         lm, rm) = K.join_counts(lr, rr, lcount, rcount)
        overflow = (
            (lcount > _rcap(lcap)).astype(jnp.int64)
            + (rcount > _rcap(rcap, salt)).astype(jnp.int64)
            + send_drop_l + send_drop_r
        )
        out = [total.reshape(1), lcount.reshape(1), rcount.reshape(1)]
        out += [counts, lr, rank_start, right_by_rank]
        out += lcd + lcv + rcd + rcv
        out.append(overflow.reshape(1))  # capacity overflow: retry bigger
        return tuple(out)

    n_cols = 2 * (n_left_cols + n_right_cols)
    in_specs = tuple([P(axis), P(axis), P(), P(axis), P(axis), P()]
                     + [P(axis)] * n_cols)
    n_out = 3 + 4 + (n_left_cols + 1 + n_right_cols + 1) * 2 + 1
    out_specs = tuple([P(axis)] * n_out)
    return jax.jit(
        shard_map(step, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    )


# ---------------------------------------------------------------------------
# distributed sort (local sort -> sampled range partition -> local sort)
# ---------------------------------------------------------------------------


def sort_samples_for(n: int, cap: int) -> int:
    """Samples per shard for the range-exchange splitter pass: 1024*n
    (capped at the shard capacity), so the relative shard-size error
    2.5*sqrt(n/s) stays ~8% for every mesh size. The error math: a shard's
    received fraction is the gap between two adjacent sample quantiles of
    s*n draws; each boundary has sd sqrt(q(1-q)/(s*n)) of T, so the gap's
    sd RELATIVE to the 1/n mean width is ~sqrt(n/(2s)) — it GROWS with n
    at fixed s (the round-5 n=8 overflow-retry regression: a 1.0625
    factor at s=512 was one sd, not four)."""
    return min(cap, 1024 * max(n, 1))


def sort_recv_factor(n: int, n_samples: int) -> float:
    """Default receive-capacity factor for the sampled range exchange:
    1 + 2.5*sqrt(n/s) concentration slack (see sort_samples_for; ~5 sd of
    the shard-width error, so overflow-retries are rare). Never looser
    than DEFAULT_RECV_FACTOR; the grow-and-retry path covers pathological
    distributions (e.g. one value spanning a whole shard)."""
    return min(DEFAULT_RECV_FACTOR,
               1.0 + 2.5 * float(np.sqrt(max(n, 1) / n_samples)))


def make_distributed_sort(mesh: Mesh, n_cols: int, n_samples: int = None,
                          axis: str = "data",
                          recv_factor="auto"):
    """Build the SPMD global sort: after it runs, shard i holds keys <=
    shard i+1's keys and each shard is locally sorted — the concatenation in
    shard order is the global ORDER BY (sorted-merge parity,
    reference operators.rs:141-194, without the single-node concat).

    Splitter pass (round 5): stride-sample the UNSORTED live keys (a
    systematic sample ~ random sample; no local pre-sort — the previous
    jnp.sort-for-order-statistics cost a full extra sort pass per shard,
    ~10% of the step, and was dead code at N=1, which alone inflated
    t(N)/t(1) by ~0.10; benchmarks/probe_sort_phases.py), all_gather the
    s*n samples, sort that tiny plane, take n-1 evenly spaced pivots. The
    receive capacity defaults to the sampling-theory factor
    (sort_recv_factor: ~1.08 at s=1024*n) instead of the generic
    1.25 — every point of capacity is a point of local-sort work
    downstream. recv_factor: "auto" = sort_recv_factor(n, s); a float =
    that factor (the grow-retry path passes doubled floats); None = the
    whole-table worst case."""
    n = mesh.devices.size
    if n_samples is None:
        n_samples = 1024 * n  # keeps the relative width error ~8% at any n
    if recv_factor == "auto":
        recv_factor = sort_recv_factor(n, n_samples)

    def step(key, kv, shard_rows, *cols):
        my = jax.lax.axis_index(axis)
        n_rows = shard_rows[my]
        cap = key.shape[0]
        datas = list(cols[:n_cols])
        valids = list(cols[n_cols:])
        okey = K.orderable_i64(key)
        live = jnp.arange(cap) < n_rows
        # nulls sort last: +inf surrogate
        skey = jnp.where(live & kv, okey, jnp.int64(np.iinfo(np.int64).max))
        # stride sample of the live prefix (positions are arbitrary wrt
        # key order, so this is a systematic ~ random value sample)
        qpos = (
            jnp.linspace(0.0, 1.0, n_samples)
            * jnp.maximum(n_rows - 1, 0).astype(jnp.float64)
        ).astype(jnp.int64)
        samples = skey[qpos]
        all_samples = jax.lax.all_gather(samples, axis).reshape(-1)
        all_sorted = jnp.sort(all_samples)
        # n-1 boundary pivots
        bidx = (jnp.arange(1, n) * (all_sorted.shape[0] // n)).astype(
            jnp.int64)
        pivots = all_sorted[bidx]
        pid = jnp.searchsorted(pivots, skey, side="right").astype(jnp.int32)
        sc = send_cap(cap, n, recv_factor)
        idx, counts = bucket_rows(pid, live, n, sc)
        send_drop = jnp.sum(jnp.maximum(counts - sc, 0))
        rd, rv, rlive = exchange_columns(
            axis, idx, counts, [key] + datas, [kv] + valids
        )
        if recv_factor is None:
            oc = cap * n
        else:
            oc = min(_cap128(int(cap * recv_factor)), cap * n)
        cd, cv, ccount = compact_received(rlive, rd, rv, oc)
        # local sort of received rows
        perm = K.sort_permutation([cd[0]], [cv[0]], [True], [False], ccount)
        out = [d[perm] for d in cd] + [v[perm] for v in cv]
        out.append(ccount.reshape(1))
        overflow = (ccount > oc).astype(jnp.int64) + send_drop
        out.append(overflow.reshape(1))  # capacity overflow: retry bigger
        return tuple(out)

    in_specs = tuple([P(axis), P(axis), P()] + [P(axis)] * (2 * n_cols))
    n_out = (n_cols + 1) * 2 + 2
    out_specs = tuple([P(axis)] * n_out)
    return jax.jit(
        shard_map(step, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    )
