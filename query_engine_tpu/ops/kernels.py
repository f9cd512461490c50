"""Vectorized operator kernels over fixed-capacity device arrays.

These replace the reference's Arrow compute kernels and implement the
*claimed* semantics its executor stubs out (SURVEY.md table at top):
real multi-key sort (vs executor.rs:290-297 pass-through), real equi-join
build/probe for all five join types (vs the Cartesian join_batches
executor.rs:500-540), real grouped hash aggregation (vs the empty vec at
executor.rs:188-189), and real window functions (vs executor.rs:76-80).

Design rules (SURVEY.md §7):
  * static shapes everywhere — every function takes/returns arrays at a
    fixed capacity plus a live-row count; callers pick pow2 capacity buckets
    so XLA compiles each bucket once;
  * data-dependent output sizes (join/filter/group counts) use a
    count-then-emit two-pass split: the count pass is jitted, the host reads
    one scalar, picks the output bucket, and runs the jitted emit pass;
  * no data-dependent Python control flow — masks + lax.sort + segment
    scans (cummax/cumsum) instead;
  * exactness over hashing: multi-column keys are reduced to dense ranks by
    a joint lexicographic sort, so key equality is exact (no hash-collision
    corrections needed). Sort-merge join == hash-join semantics.

Nulls: SQL three-valued logic. Group keys: NULLs group together. Join keys:
NULLs never match (each null row gets a unique negative rank).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# small utilities
# ---------------------------------------------------------------------------


def live_mask(capacity: int, num_rows) -> jnp.ndarray:
    """Boolean live-row plane. `num_rows` is either a row-count scalar or an
    explicit boolean selection mask (compiled pipelines thread masks through
    operators instead of syncing counts; engine/pipeline.py)."""
    if getattr(num_rows, "ndim", 0) == 1 and num_rows.dtype == jnp.bool_:
        return num_rows
    # int32 iota: capacities are < 2^31
    return jnp.arange(capacity, dtype=jnp.int32) < num_rows


_I64_MIN = np.int64(np.iinfo(np.int64).min)


def _f64_orderable_bits(x: jnp.ndarray) -> jnp.ndarray:
    """Map float64 -> int64 whose signed integer order matches float order
    (sign-flip trick; the reference uses the same idea for its IndexKey,
    query-index/src/types.rs:101-110).

    For non-negative floats the raw bits are already ordered; for negative
    floats the signed bit pattern *increases* as the value decreases, so we
    reflect them below zero: y = I64_MIN - bits (no overflow: bits is in
    [I64_MIN, -1], and -0.0 maps to 0 == +0.0).
    """
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float64), jnp.int64)
    return jnp.where(bits < 0, _I64_MIN - bits, bits)


_I32_MIN = np.int32(np.iinfo(np.int32).min)


def _f32_orderable_bits(x: jnp.ndarray) -> jnp.ndarray:
    """float32 variant of the sign-flip trick, on a 32-bit bitcast."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)
    return jnp.where(bits < 0, _I32_MIN - bits, bits)


def orderable_i64(data: jnp.ndarray) -> jnp.ndarray:
    """Normalize a key column to a sortable plane preserving order &
    equality. 32-bit-or-smaller lanes map to int32 (half the bytes through
    the hot sort/scatter path); int64 stays int64; float64 stays float64 —
    no 64-bit bitcast is needed, and lax.sort handles f64 operands
    natively, so floats ride as themselves (order and equality preserved;
    NaNs are mapped to NULL at ingest)."""
    if data.dtype == jnp.float64:
        return data
    if jnp.issubdtype(data.dtype, jnp.floating):
        return _f32_orderable_bits(data)
    if data.dtype == jnp.int64 or data.dtype == jnp.uint64:
        return data.astype(jnp.int64)
    if data.dtype == jnp.bool_:
        return data.astype(jnp.int32)
    return data.astype(jnp.int32)


def from_orderable(y: jnp.ndarray, dtype) -> jnp.ndarray:
    """Inverse of orderable_i64 for value recovery (min/max results). f64
    planes ride as themselves; the f32 sign-flip transform is its own
    inverse; integer images are the values."""
    if dtype == jnp.float64:
        return y
    if dtype == jnp.float32:
        bits = jnp.where(y < 0, _I32_MIN - y, y).astype(jnp.int32)
        return jax.lax.bitcast_convert_type(bits, jnp.float32)
    return y


def normalize_key(
    data: jnp.ndarray, validity: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(orderable int64 key, null mask). Null data slots are zeroed so equal
    nulls compare equal; callers append the null plane as a separate key."""
    key = orderable_i64(data)
    null = ~validity
    return jnp.where(null, jnp.zeros((), key.dtype), key), null


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------


def _sort_key_operands(
    key_datas: Sequence[jnp.ndarray],
    key_valids: Sequence[jnp.ndarray],
    ascs: Sequence[bool],
    nulls_firsts: Sequence[bool],
    pad: jnp.ndarray,
) -> List[jnp.ndarray]:
    """Minimal lax.sort key-operand list for a multi-key sort with pad rows
    last. Per key: one packed i64 operand when the orderable image is
    32-bit, else (class, key) pairs; the pad flag rides the first key's
    class plane (pad class 2 dominates null ranks {0, 1})."""
    operands: List[jnp.ndarray] = []
    for i, (data, valid, asc, nf) in enumerate(
        zip(key_datas, key_valids, ascs, nulls_firsts)
    ):
        key, null = normalize_key(data, valid)
        cls = jnp.where(null, jnp.int32(0 if nf else 1),
                        jnp.int32(1 if nf else 0))
        if i == 0:
            cls = jnp.where(pad, jnp.int32(2), cls)
        if key.dtype == jnp.int32:
            # unsigned 32-bit image; desc = reflect within the low word
            # (no negation — INT32_MIN stays in range)
            u = key.astype(jnp.int64) - jnp.int64(np.iinfo(np.int32).min)
            if not asc:
                u = jnp.int64(2**32 - 1) - u
            operands.append((cls.astype(jnp.int64) << 32) | u)
        else:
            if not asc:
                # i64: orderable images never hit INT64_MIN for live data
                # (f64 rides as f64 and negates exactly)
                key = -key
            operands.append(cls)
            operands.append(key)
    if not operands:  # no keys: pad plane alone orders live-first
        operands.append(pad.astype(jnp.int32))
    return operands


def sort_permutation(
    key_datas: Sequence[jnp.ndarray],
    key_valids: Sequence[jnp.ndarray],
    ascs: Sequence[bool],
    nulls_firsts: Sequence[bool],
    num_rows,
    ranges: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
) -> jnp.ndarray:
    """Stable multi-key sort permutation.

    Returns perm of length capacity: perm[out_pos] = in_row. Live rows come
    first in the requested order; pad rows sink to the end.
    Implements the semantics of Arrow lexsort_to_indices as used by the
    reference's SortedMerge (query-distributed/src/operators.rs:180-193).

    ranges: optional per-key (lo, range) static covers; when EVERY key is
    covered and the fields (+1 null bit each, +1 pad bit) fit 63 bits, all
    keys compose into ONE i64 operand (desc = bit-flipped field,
    nulls-first = flipped null bit) — operand count is the lax.sort cost.
    """
    capacity = key_datas[0].shape[0]
    pad = ~live_mask(capacity, num_rows)

    if ranges is not None and len(ranges) == len(key_datas) and all(
        r is not None and len(r) == 2 for r in ranges
    ):
        widths = [max(int(r[1] - 1).bit_length(), 1) for r in ranges]
        total_bits = sum(w + 1 for w in widths) + 1
        if total_bits <= 63:
            comp = jnp.zeros(capacity, dtype=jnp.int64)
            for (data, valid, asc, nf), (lo, _r), w in zip(
                zip(key_datas, key_valids, ascs, nulls_firsts),
                ranges, widths,
            ):
                code = jnp.clip(
                    data.astype(jnp.int64) - lo, 0, (1 << w) - 1
                )
                if not asc:
                    code = ((1 << w) - 1) - code
                # nulls-first: null sorts below live (bit 0 vs 1); else above
                null_bit = (
                    valid.astype(jnp.int64) if nf
                    else (~valid).astype(jnp.int64)
                )
                comp = (
                    (comp << (w + 1))
                    | (null_bit << w)
                    | jnp.where(valid, code, 0)
                )
            comp = comp | (pad.astype(jnp.int64) << (total_bits - 1))
            perm = jnp.arange(capacity, dtype=jnp.int32)
            out = jax.lax.sort([comp, perm], num_keys=1, is_stable=True)
            return out[-1]

    operands = _sort_key_operands(key_datas, key_valids, ascs,
                                  nulls_firsts, pad)
    perm = jnp.arange(capacity, dtype=jnp.int32)
    out = jax.lax.sort(
        operands + [perm], num_keys=len(operands), is_stable=True
    )
    return out[-1]


# ---------------------------------------------------------------------------
# filter / compaction
# ---------------------------------------------------------------------------


def filter_count(mask: jnp.ndarray, num_rows) -> jnp.ndarray:
    m = mask & live_mask(mask.shape[0], num_rows)
    return jnp.sum(m.astype(jnp.int64))


def compaction_indices(mask: jnp.ndarray, num_rows, out_capacity: int):
    """Indices of mask-true live rows, compacted to the front of an
    out_capacity-sized index plane (vectorized Arrow filter_record_batch
    analog, reference executor.rs:131-155).

    Implemented as cumsum + scatter with int32 index planes in place of
    jnp.nonzero; int32 scatters move half the bytes of int64 ones.
    """
    capacity = mask.shape[0]
    m = mask & live_mask(capacity, num_rows)
    pos = jnp.cumsum(m.astype(jnp.int32)) - 1
    idx = (
        jnp.zeros(out_capacity, dtype=jnp.int32)
        .at[jnp.where(m, pos, out_capacity)]
        .set(jnp.arange(capacity, dtype=jnp.int32), mode="drop")
    )
    return idx


def gather_columns(
    datas: Sequence[jnp.ndarray],
    valids: Sequence[jnp.ndarray],
    indices: jnp.ndarray,
    row_valid: Optional[jnp.ndarray] = None,
):
    """Gather rows by index across columns; optional row_valid plane ANDs
    into every column's validity (outer-join null padding)."""
    out_d, out_v = [], []
    for d, v in zip(datas, valids):
        out_d.append(d[indices])
        vv = v[indices]
        if row_valid is not None:
            vv = vv & row_valid
        out_v.append(vv)
    return out_d, out_v


def gather_columns_packed(
    datas: Sequence[jnp.ndarray],
    valids: Sequence[jnp.ndarray],
    bounds: Sequence[Optional[Tuple[int, int]]],
    indices: jnp.ndarray,
    row_valid: Optional[jnp.ndarray] = None,
):
    """gather_columns with bit-packing: each random gather pays per
    element, so K columns' 2K gathers (data + validity each) dominate join
    emits and sorts. Columns whose
    static bounds (table stats / dictionary sizes) fit 31 bits pack
    (data - lo) plus their validity bit into shared uint32 words, and ALL
    remaining columns contribute their validity bits too — typically
    cutting the gather count 3-6x for dimension-table shapes.

    bounds[i]: None, or a static (lo, range) cover of column i's live
    values. Pad/garbage rows may lie outside the cover — their packed
    image wraps, which is fine because only rows with a true validity bit
    are ever read downstream.
    """
    n_cols = len(datas)
    slots = []  # (col_idx, data_bits or 0 for valid-only)
    direct = []  # columns gathered directly (data), valid bit still packed
    for i, (d, b) in enumerate(zip(datas, bounds)):
        if d.dtype == jnp.bool_:
            slots.append((i, 1))
        elif (
            b is not None and len(b) == 2
            and jnp.issubdtype(d.dtype, jnp.integer)
            and max(int(b[1]) - 1, 1).bit_length() <= 31 - 1
        ):
            slots.append((i, max(int(b[1] - 1).bit_length(), 1)))
        else:
            direct.append(i)
    if not slots and n_cols <= 1:
        return gather_columns(datas, valids, indices, row_valid)

    # first-fit-decreasing into 32-bit words; every slot carries +1 valid
    # bit, and direct columns add valid-only 1-bit slots
    items = sorted(
        [(bits + 1, i, bits) for i, bits in slots]
        + [(1, i, 0) for i in direct],
        reverse=True,
    )
    words: List[list] = []  # per word: [(col, data_bits, offset)], used
    used: List[int] = []
    layout = {}
    for size, i, bits in items:
        for w in range(len(words)):
            if used[w] + size <= 32:
                layout[i] = (w, used[w], bits)
                words[w].append(i)
                used[w] += size
                break
        else:
            layout[i] = (len(words), 0, bits)
            words.append([i])
            used.append(size)

    raw_planes = []
    for w in range(len(words)):
        plane = jnp.zeros(datas[0].shape[0], dtype=jnp.uint32)
        for i in words[w]:
            _, off, bits = layout[i]
            if bits:
                lo = 0 if datas[i].dtype == jnp.bool_ else int(bounds[i][0]) \
                    if bounds[i] is not None and len(bounds[i]) == 2 else 0
                img = (
                    (datas[i].astype(jnp.int64) - lo).astype(jnp.uint32)
                    & jnp.uint32((1 << bits) - 1)
                )
                plane = plane | (img << off)
            plane = plane | (valids[i].astype(jnp.uint32) << (off + bits))
        raw_planes.append(plane)
    planes = [p[indices] for p in raw_planes]

    out_d, out_v = [], []
    for i in range(n_cols):
        w, off, bits = layout[i]
        gw = planes[w]
        vv = ((gw >> (off + bits)) & 1) != 0
        if row_valid is not None:
            vv = vv & row_valid
        if bits:
            if datas[i].dtype == jnp.bool_:
                d = ((gw >> off) & 1) != 0
            else:
                lo = int(bounds[i][0]) if (
                    bounds[i] is not None and len(bounds[i]) == 2
                ) else 0
                d = (
                    ((gw >> off) & jnp.uint32((1 << bits) - 1))
                    .astype(jnp.int64) + lo
                ).astype(datas[i].dtype)
        else:
            d = datas[i][indices]
        out_d.append(d)
        out_v.append(vv)
    return out_d, out_v


def fk_gather_by_rank(
    datas: Sequence[jnp.ndarray],
    valids: Sequence[jnp.ndarray],
    bounds: Sequence[Optional[Tuple[int, int]]],
    rr: jnp.ndarray,
    r_live: jnp.ndarray,
    lr: jnp.ndarray,
    l_live: jnp.ndarray,
    n_ranks: int,
):
    """FK join emit fused to ONE probe-length random access per packed
    word: the build side's packed words scatter to RANK space (build-side
    cost), so each probe row gathers its rank's word directly — no
    rank -> row lookup gather first. An 'occupied' bit rides along, so
    `matched` comes from the same gathered word.

    Requires every right column to pack (31-bit bounded ints / bools);
    returns (out_datas, out_valids, matched), or None for the caller to
    fall back to fk_join_right_lookup + gather_columns_packed.
    """
    n_cols = len(datas)
    src_len = r_live.shape[0]
    slots = []
    for i, (d, b) in enumerate(zip(datas, bounds)):
        if d.dtype == jnp.bool_:
            slots.append((i, 1))
        elif (
            b is not None and len(b) == 2
            and jnp.issubdtype(d.dtype, jnp.integer)
            and max(int(b[1]) - 1, 1).bit_length() <= 30
        ):
            slots.append((i, max(int(b[1] - 1).bit_length(), 1)))
        else:
            return None
    slots.append((n_cols, 1))  # occupied marker (bool, always valid)

    items = sorted([(bits + 1, i, bits) for i, bits in slots], reverse=True)
    words: List[list] = []
    used: List[int] = []
    layout = {}
    for size, i, bits in items:
        for w in range(len(words)):
            if used[w] + size <= 32:
                layout[i] = (w, used[w], bits)
                words[w].append(i)
                used[w] += size
                break
        else:
            layout[i] = (len(words), 0, bits)
            words.append([i])
            used.append(size)

    all_d = list(datas) + [jnp.ones(src_len, dtype=jnp.bool_)]
    all_v = list(valids) + [r_live]
    all_b = list(bounds) + [None]
    r_ok = r_live & (rr >= 0)
    tgt = jnp.where(r_ok, rr, n_ranks).astype(jnp.int32)
    l_ok = l_live & (lr >= 0)
    src = jnp.clip(lr, 0, n_ranks - 1).astype(jnp.int32)

    planes = []
    for w in range(len(words)):
        plane = jnp.zeros(src_len, dtype=jnp.uint32)
        for i in words[w]:
            _, off, bits = layout[i]
            if all_d[i].dtype == jnp.bool_:
                lo = 0
            else:
                lo = int(all_b[i][0])
            img = (
                (all_d[i].astype(jnp.int64) - lo).astype(jnp.uint32)
                & jnp.uint32((1 << bits) - 1)
            )
            plane = plane | (img << off)
            plane = plane | (all_v[i].astype(jnp.uint32) << (off + bits))
        by_rank = (
            jnp.zeros(n_ranks, dtype=jnp.uint32)
            .at[tgt].set(plane, mode="drop")
        )
        planes.append(by_rank[src])

    w, off, bits = layout[n_cols]
    matched = l_ok & (((planes[w] >> (off + bits)) & 1) != 0)

    out_d, out_v = [], []
    for i in range(n_cols):
        w, off, bits = layout[i]
        gw = planes[w]
        vv = ((((gw >> (off + bits)) & 1) != 0)) & matched
        if all_d[i].dtype == jnp.bool_:
            d = ((gw >> off) & 1) != 0
        else:
            lo = int(all_b[i][0])
            d = (
                ((gw >> off) & jnp.uint32((1 << bits) - 1))
                .astype(jnp.int64) + lo
            ).astype(all_d[i].dtype)
        out_d.append(d)
        out_v.append(vv)
    return out_d, out_v, matched


# ---------------------------------------------------------------------------
# grouping: dense ranks via joint sort
# ---------------------------------------------------------------------------


def _segment_ids_from_sorted(
    sorted_keys: Sequence[jnp.ndarray], pad_sorted: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Boundary flags + segment ids over rows already in sorted order.
    Pad rows are all assigned to a trailing dummy segment."""
    capacity = pad_sorted.shape[0]
    idx = jnp.arange(capacity, dtype=jnp.int32)
    change = jnp.zeros(capacity, dtype=bool).at[0].set(True)
    for k in sorted_keys:
        prev = jnp.roll(k, 1)
        change = change | (idx > 0) & (k != prev)
    change = change | (pad_sorted & ~jnp.roll(pad_sorted, 1))
    seg = jnp.cumsum(change.astype(jnp.int32)) - 1
    return change, seg


def group_ids(
    key_datas: Sequence[jnp.ndarray],
    key_valids: Sequence[jnp.ndarray],
    num_rows,
    ranges: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Dense group ids for GROUP BY keys (NULLs group together).

    Returns (group_id per row [capacity], num_groups scalar, representative
    row index per group [capacity, padded]). Group ids are dense in sorted
    key order -> deterministic output order across shards.

    ranges: optional per-key static (lo, range) covers. When every key is
    covered and the widths (+1 null bit each, +1 pad bit) fit 63 bits, ALL
    keys compose into ONE i64 sort operand — the shape where the bounded
    key-combination space exceeds direct grouping's bucket range but the
    sort still collapses to a single plane (lax.sort cost scales with
    operand count).
    """
    capacity = key_datas[0].shape[0]
    pad = ~live_mask(capacity, num_rows)

    if ranges is not None and len(ranges) == len(key_datas) and all(
        r is not None and len(r) == 2 for r in ranges
    ):
        widths = [max(int(r[1] - 1).bit_length(), 1) for r in ranges]
        total_bits = sum(w + 1 for w in widths) + 1
        if total_bits <= 63:
            comp = jnp.zeros(capacity, dtype=jnp.int64)
            for (data, valid), (lo, _rng), w in zip(
                zip(key_datas, key_valids), ranges, widths
            ):
                code = jnp.clip(
                    data.astype(jnp.int64) - lo, 0, (1 << w) - 1
                )
                null = (~valid).astype(jnp.int64)
                comp = (
                    (comp << (w + 1))
                    | (null << w)
                    | jnp.where(valid, code, 0)
                )
            comp = comp | (pad.astype(jnp.int64) << (total_bits - 1))
            perm = jnp.arange(capacity, dtype=jnp.int32)
            sorted_comp, sperm = jax.lax.sort(
                [comp, perm], num_keys=1, is_stable=True
            )
            sorted_pad = (sorted_comp >> (total_bits - 1)) == 1
            change, seg = _segment_ids_from_sorted([sorted_comp], sorted_pad)
            seg = seg.astype(jnp.int32)
            num_groups = jnp.sum((change & ~sorted_pad).astype(jnp.int64))
            gid = jnp.zeros(capacity, dtype=jnp.int32).at[sperm].set(seg)
            rep = jnp.zeros(capacity, dtype=jnp.int32).at[
                jnp.where(change & ~sorted_pad, seg, capacity)
            ].set(sperm, mode="drop")
            return gid, num_groups, rep
    # one packed i64 operand per 32-bit-image key (nulls group together:
    # null flag in the class word; pad class 2 on the first key) — operand
    # count, not bit width, is what lax.sort's cost follows
    operands: List[jnp.ndarray] = []
    for i, (data, valid) in enumerate(zip(key_datas, key_valids)):
        key, null = normalize_key(data, valid)
        cls = null.astype(jnp.int32)
        if i == 0:
            cls = jnp.where(pad, jnp.int32(2), cls)
        if key.dtype == jnp.int32:
            u = key.astype(jnp.int64) - jnp.int64(np.iinfo(np.int32).min)
            operands.append((cls.astype(jnp.int64) << 32) | u)
        else:
            operands.append(cls)
            operands.append(key)
    perm = jnp.arange(capacity, dtype=jnp.int32)
    sorted_all = jax.lax.sort(
        operands + [perm], num_keys=len(operands), is_stable=True
    )
    first = sorted_all[0]
    sorted_pad = (
        (first >> 32) == 2 if first.dtype == jnp.int64 else first == 2
    )
    sorted_keys = sorted_all[:-1]
    sperm = sorted_all[-1]
    change, seg = _segment_ids_from_sorted(sorted_keys, sorted_pad)
    seg = seg.astype(jnp.int32)
    num_groups = jnp.sum((change & ~sorted_pad).astype(jnp.int64))
    # scatter group id back to original row order
    gid = jnp.zeros(capacity, dtype=jnp.int32).at[sperm].set(seg)
    # representative row (first in sorted order) for each group; non-boundary
    # rows scatter out of bounds and are dropped
    rep = jnp.zeros(capacity, dtype=jnp.int32).at[
        jnp.where(change & ~sorted_pad, seg, capacity)
    ].set(sperm, mode="drop")
    return gid, num_groups, rep


def group_ids_direct(
    key: jnp.ndarray,
    valid: jnp.ndarray,
    num_rows,
    key_min: int,
    num_buckets: int,
):
    """Sort-free grouping for a single integer key with a bounded range
    (dictionary codes, enum/FK columns): bucket = key - key_min, then
    densify over observed buckets. 10-50x cheaper than the sort-based
    group_ids when applicable — no O(n log n) at all.

    Same contract and group ordering as group_ids: ids dense in key order,
    NULLs one trailing group. (key_min/num_buckets are static: the host
    reads min/max once per column batch.)
    """
    capacity = key.shape[0]
    lm = live_mask(capacity, num_rows)
    nb = num_buckets + 1  # + null bucket
    bucket = jnp.where(
        lm & valid,
        jnp.clip(key.astype(jnp.int32) - key_min, 0, num_buckets - 1),
        jnp.where(lm, num_buckets, nb),  # nulls -> last; pad -> dropped
    ).astype(jnp.int32)
    counts = jax.ops.segment_sum(
        lm.astype(jnp.int32), jnp.clip(bucket, 0, nb - 1),
        num_segments=nb,
    )
    observed = counts > 0
    dense = jnp.cumsum(observed.astype(jnp.int32)) - 1  # bucket -> dense id
    num_groups = jnp.sum(observed.astype(jnp.int64))
    gid = dense[jnp.clip(bucket, 0, nb - 1)]
    gid = jnp.where(lm, gid, 0)
    # representative row per dense group: min row index per bucket
    rows = jnp.arange(capacity, dtype=jnp.int32)
    big = jnp.int32(capacity)
    rep_by_bucket = (
        jnp.full(nb, big, dtype=jnp.int32)
        .at[jnp.where(lm, bucket, nb)]
        .min(rows, mode="drop")
    )
    rep = (
        jnp.zeros(capacity, dtype=jnp.int32)
        .at[jnp.where(observed, dense, capacity)]
        .set(jnp.minimum(rep_by_bucket, capacity - 1), mode="drop")
    )
    return gid, num_groups, rep


def key_range(key: jnp.ndarray, valid: jnp.ndarray, num_rows):
    """(min, max, any_valid) of the live valid key values (for the direct
    grouping fast path; one tiny host sync)."""
    lm = live_mask(key.shape[0], num_rows) & valid
    big = jnp.iinfo(jnp.int32).max if key.dtype == jnp.int32 else jnp.iinfo(jnp.int64).max
    kmin = jnp.min(jnp.where(lm, key, big))
    kmax = jnp.max(jnp.where(lm, key, -big - 1))
    return kmin, kmax, jnp.any(lm)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

_INT_MIN = np.int64(np.iinfo(np.int64).min)
_INT_MAX = np.int64(np.iinfo(np.int64).max)


def _segment_sum_i64(
    data: jnp.ndarray, ok: jnp.ndarray, gid: jnp.ndarray, num_segments: int,
    value_bounds: Optional[Tuple[int, int]] = None,
    counts: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Exact int64 segment sum via bit-chunked int32 scatters.

    Splitting the value into unsigned bit chunks, scattering each in
    int32, and recombining shifted chunk totals is exact (two's complement
    works out: the implicit sign chunks recombine modulo 2^64). Whether
    this beats a native s64 scatter-add depends on the device (ROADMAP).
    Chunk width is chosen statically from capacity so per-segment chunk
    sums cannot overflow int32: 16-bit chunks up to 2^15 rows, 8-bit up to
    2^23; beyond that, fall back to the plain s64 scatter.

    With static value_bounds (table stats) + per-segment counts, values are
    biased to [0, hi-lo] and only the chunks that cover that span scatter
    (sum = biased sum + lo * count) — e.g. a 17-bit span takes 3 of 8
    chunk scatters.
    """
    capacity = gid.shape[0]
    bias = 0
    if (
        value_bounds is not None and counts is not None
        and value_bounds[1] >= value_bounds[0]
    ):
        bias = int(value_bounds[0])
        span_bits = max(int(value_bounds[1] - value_bounds[0]).bit_length(), 1)
    else:
        bias = 0
        span_bits = 64
    x64 = jnp.where(ok, data.astype(jnp.int64) - bias, 0)
    if capacity <= (1 << 15):
        bits, n_chunks, acc = 16, 4, jnp.int32
    elif capacity <= (1 << 23):
        bits, n_chunks, acc = 8, 8, jnp.int32
    elif capacity <= (1 << 24):
        # 255 * 2^24 < 2^32: exact in unsigned 32-bit accumulation
        bits, n_chunks, acc = 8, 8, jnp.uint32
    elif capacity <= (1 << 28):
        bits, n_chunks, acc = 4, 16, jnp.uint32
    else:
        s = jax.ops.segment_sum(x64, gid, num_segments=num_segments)
        return s if bias == 0 else s + jnp.int64(bias) * counts
    if span_bits < 64:
        n_chunks = min(n_chunks, -(-span_bits // bits))
    u = x64.astype(jnp.uint64)

    def chunked(bits_k, n_k, acc_k):
        mask = jnp.uint64((1 << bits_k) - 1)
        out = jnp.zeros(num_segments, dtype=jnp.uint64)
        for k in range(n_k):
            chunk = ((u >> jnp.uint64(bits_k * k)) & mask).astype(acc_k)
            s = jax.ops.segment_sum(chunk, gid, num_segments=num_segments)
            out = out + (s.astype(jnp.uint64) << jnp.uint64(bits_k * k))
        return out.astype(jnp.int64)

    if counts is not None and bits < 16:
        # 16-bit chunks HALVE the scatter passes whenever per-segment row
        # counts stay under 2^16 (uint32 chunk accumulation cannot
        # overflow: cnt * (2^16-1) < 2^32) — one runtime lax.cond decides.
        # Analytic groupings (TPC-H: a handful of lineitems per order)
        # take the fast branch; pathological ones keep the safe widths.
        n16 = min(4, -(-span_bits // 16)) if span_bits < 64 else 4
        result = jax.lax.cond(
            jnp.max(counts) < (1 << 16),
            lambda: chunked(16, n16, jnp.uint32),
            lambda: chunked(bits, n_chunks, acc),
        )
    else:
        result = chunked(bits, n_chunks, acc)
    if bias != 0:
        result = result + jnp.int64(bias) * counts
    return result


def segment_aggregate(
    func: str,
    data: Optional[jnp.ndarray],
    validity: Optional[jnp.ndarray],
    gid: jnp.ndarray,
    num_rows,
    num_segments: int,
    distinct_first: Optional[jnp.ndarray] = None,
    value_bounds: Optional[Tuple[int, int]] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One aggregate over segments. Returns (values[num_segments],
    valid[num_segments]).

    func: count_star | count | sum | avg | min | max
    Semantics parity (reference operators.rs:745-848): COUNT ignores nulls
    (COUNT(*) counts rows), SUM/AVG/MIN/MAX ignore nulls and are NULL for
    empty/all-null groups; SUM(int) accumulates in int64, AVG in float64.
    """
    capacity = gid.shape[0]
    lm = live_mask(capacity, num_rows)
    if func == "count_star":
        ones = lm.astype(jnp.int32)
        if distinct_first is not None:
            ones = ones * distinct_first.astype(jnp.int32)
        cnt = jax.ops.segment_sum(ones, gid, num_segments=num_segments)
        return cnt.astype(jnp.int64), jnp.ones(num_segments, dtype=bool)
    assert data is not None and validity is not None
    ok = lm & validity
    if distinct_first is not None:
        ok = ok & distinct_first
    # counts in int32 (capacity < 2^31), widened at the boundary: half the
    # scatter bytes of an s64 count
    cnt = jax.ops.segment_sum(
        ok.astype(jnp.int32), gid, num_segments=num_segments
    ).astype(jnp.int64)
    if func == "count":
        return cnt, jnp.ones(num_segments, dtype=bool)
    has = cnt > 0
    if func == "sum" or func == "avg":
        if jnp.issubdtype(data.dtype, jnp.floating):
            s = jax.ops.segment_sum(
                jnp.where(ok, data.astype(jnp.float64), 0.0), gid,
                num_segments=num_segments,
            )
        else:
            # integer AVG rides the exact integer path too; the divide
            # happens once per group
            s = _segment_sum_i64(data, ok, gid, num_segments,
                                 value_bounds=value_bounds, counts=cnt)
        if func == "avg":
            return s.astype(jnp.float64) / jnp.maximum(cnt, 1).astype(
                jnp.float64
            ), has
        return s, has
    if func == "min" or func == "max":
        out = _segment_extreme(data, ok, gid, num_segments, func == "min",
                               value_bounds)
        if jnp.issubdtype(data.dtype, jnp.floating):
            out = out.astype(jnp.float64)
        return out, has
    raise ValueError(f"unknown aggregate {func}")


def _segment_extreme(
    data: jnp.ndarray, ok: jnp.ndarray, gid: jnp.ndarray,
    num_segments: int, is_min: bool,
    value_bounds: Optional[Tuple[int, int]] = None,
) -> jnp.ndarray:
    """Exact segment min/max through the orderable-integer image.

    32-bit lanes take one int32 scatter. 64-bit lanes split into (hi32,
    biased lo32) and take two int32 scatters: the extreme's high word first,
    then the extreme low word among rows whose high word matches, in place
    of one 64-bit segment_min.
    Results for empty groups are garbage; callers mask by the count plane.
    """
    red = jax.ops.segment_min if is_min else jax.ops.segment_max
    y = orderable_i64(data)
    if (
        y.dtype == jnp.int64 and value_bounds is not None
        and value_bounds[0] >= -(2**31) and value_bounds[1] < 2**31
    ):
        # caller-supplied value cover fits int32: one native scatter
        y = y.astype(jnp.int32)
    if y.dtype == jnp.float64:
        fill = jnp.float64(np.inf if is_min else -np.inf)
        return red(jnp.where(ok, y, fill), gid, num_segments=num_segments)
    if y.dtype == jnp.int32:
        fill = (
            jnp.iinfo(jnp.int32).max if is_min else jnp.iinfo(jnp.int32).min
        )
        g = red(jnp.where(ok, y, fill), gid, num_segments=num_segments)
        out32 = from_orderable(g, data.dtype)
        if jnp.issubdtype(data.dtype, jnp.floating):
            return out32
        return out32.astype(jnp.int64)
    hi = (y >> 32).astype(jnp.int32)
    # low word biased so signed int32 order matches unsigned 32-bit order
    lo = ((y & jnp.int64(0xFFFFFFFF)).astype(jnp.uint32)
          ^ jnp.uint32(0x80000000)).astype(jnp.int32)
    fill32 = jnp.iinfo(jnp.int32).max if is_min else jnp.iinfo(jnp.int32).min
    g_hi = red(jnp.where(ok, hi, fill32), gid, num_segments=num_segments)
    sel = ok & (hi == g_hi[gid])
    g_lo = red(jnp.where(sel, lo, fill32), gid, num_segments=num_segments)
    lo_u = (g_lo.astype(jnp.int32).astype(jnp.uint32)
            ^ jnp.uint32(0x80000000)).astype(jnp.uint64)
    g = (g_hi.astype(jnp.int64) << 32) | lo_u.astype(jnp.int64)
    return from_orderable(g, data.dtype)


def global_aggregate(
    func: str,
    data: Optional[jnp.ndarray],
    validity: Optional[jnp.ndarray],
    num_rows,
    out_len: int = 128,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ungrouped aggregate as a plain tree reduction. The grouped kernel
    with a constant group id degenerates to a scatter-add where EVERY row
    collides on one address and serialises; a reduction does not.
    Returns [out_len] planes with the result
    in slot 0 (same layout the executors slice)."""
    capacity = (data if data is not None else validity).shape[0] \
        if (data is not None or validity is not None) else None
    if capacity is None:
        raise ValueError("global_aggregate needs data or validity")
    lm = live_mask(capacity, num_rows)
    ok = lm if (validity is None or data is None) else (lm & validity)
    cnt = jnp.sum(ok.astype(jnp.int64))
    if func in ("count_star", "count"):
        out = jnp.zeros(out_len, dtype=jnp.int64).at[0].set(cnt)
        return out, jnp.ones(out_len, dtype=bool)
    has = cnt > 0
    if func in ("sum", "avg"):
        if func == "avg" or jnp.issubdtype(data.dtype, jnp.floating):
            tot = jnp.sum(jnp.where(ok, data.astype(jnp.float64), 0.0))
        else:
            tot = jnp.sum(jnp.where(ok, data.astype(jnp.int64), 0))
        if func == "avg":
            tot = tot / jnp.maximum(cnt, 1).astype(jnp.float64)
        out = jnp.zeros(out_len, dtype=tot.dtype).at[0].set(tot)
    elif func in ("min", "max"):
        if jnp.issubdtype(data.dtype, jnp.floating):
            fill = jnp.float64(np.inf if func == "min" else -np.inf)
            x = jnp.where(ok, data.astype(jnp.float64), fill)
        else:
            fill = _INT_MAX if func == "min" else _INT_MIN
            x = jnp.where(ok, data.astype(jnp.int64), fill)
        red = jnp.min if func == "min" else jnp.max
        out = jnp.zeros(out_len, dtype=x.dtype).at[0].set(red(x))
    else:
        raise ValueError(f"unknown aggregate {func}")
    valid = jnp.zeros(out_len, dtype=bool).at[0].set(has)
    return out, valid


def distinct_first_flags(
    key_datas: Sequence[jnp.ndarray],
    key_valids: Sequence[jnp.ndarray],
    gid: jnp.ndarray,
    num_rows,
) -> jnp.ndarray:
    """True for the first occurrence of each (group, value) pair — the
    dedup plane for DISTINCT aggregates."""
    capacity = gid.shape[0]
    pad = ~live_mask(capacity, num_rows)
    operands: List[jnp.ndarray] = [pad.astype(jnp.int32), gid]
    for data, valid in zip(key_datas, key_valids):
        key, null = normalize_key(data, valid)
        operands.append(null.astype(jnp.int32))
        operands.append(key)
    perm = jnp.arange(capacity, dtype=jnp.int32)
    sorted_all = jax.lax.sort(
        operands + [perm], num_keys=len(operands), is_stable=True
    )
    sorted_keys = sorted_all[:-1]
    sperm = sorted_all[-1]
    idx = jnp.arange(capacity)
    change = jnp.zeros(capacity, dtype=bool).at[0].set(True)
    for k in sorted_keys[1:]:  # skip pad plane for equality, include gid
        prev = jnp.roll(k, 1)
        change = change | (idx > 0) & (k != prev)
    change = change | (idx == 0)
    first = jnp.zeros(capacity, dtype=bool).at[sperm].set(change)
    return first


# ---------------------------------------------------------------------------
# joins (sort-merge, exact; two-pass count-then-emit)
# ---------------------------------------------------------------------------


def join_ranks(
    left_keys: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    right_keys: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    n_left,
    n_right,
    null_equal: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Joint dense ranks: rank equality <=> key-tuple equality.

    By default rows with any NULL key get unique negative ranks so NULL never
    matches NULL (SQL equi-join). With null_equal=True, NULLs compare equal
    (IS NOT DISTINCT semantics — used by INTERSECT/EXCEPT and DISTINCT).

    left_keys/right_keys: per-key (data, validity); capacities may differ.
    Returns (left_ranks[cap_l], right_ranks[cap_r]) int32.
    """
    out = _join_ranks_full(left_keys, right_keys, n_left, n_right,
                           null_equal)
    return out[0], out[1]


def _join_ranks_full(left_keys, right_keys, n_left, n_right,
                     null_equal: bool = False, space=None):
    """Also returns (sorted_perm, sorted_pad_or_null) for reuse by
    join_counts (right-side rank ordering comes from the same sort).
    `space` = (sperm, sorted_lead, change) from a prior count-program
    dispatch over the SAME inputs skips the joint sort entirely — the
    emit half of the count->emit capacity sync reuses the count's sort."""
    cap_l = left_keys[0][0].shape[0]
    cap_r = right_keys[0][0].shape[0]
    cap = cap_l + cap_r
    any_null = jnp.zeros(cap, dtype=bool)
    for (_, lv), (_, rv) in zip(left_keys, right_keys):
        any_null = any_null | ~jnp.concatenate([lv, rv])
    perm = jnp.arange(cap, dtype=jnp.int32)
    if space is not None:
        sperm, sorted_lead, change = space
        seg = jnp.cumsum(change.astype(jnp.int32)) - 1
        ranks = (
            jnp.zeros(cap, dtype=jnp.int32).at[sperm].set(seg.astype(jnp.int32))
        )
        if not null_equal:
            ranks = jnp.where(any_null, -(perm + 2), ranks)
        return ranks[:cap_l], ranks[cap_l:], sperm, sorted_lead, change
    pad = jnp.concatenate(
        [~live_mask(cap_l, n_left), ~live_mask(cap_r, n_right)]
    )
    datas: List[jnp.ndarray] = []
    valids: List[jnp.ndarray] = []
    for (ld, lv), (rd, rv) in zip(left_keys, right_keys):
        datas.append(jnp.concatenate([orderable_i64(ld), orderable_i64(rd)]))
        valids.append(jnp.concatenate([lv, rv]))
    # sort order: live non-null rows first (grouped by key), then nulls,
    # then pad — so rank-r rows are contiguous from the front. Each
    # 32-bit-image key packs its class word + unsigned key image into ONE
    # i64 operand (operand count is what lax.sort's cost follows).
    lead = pad.astype(jnp.int32) * 2
    if not null_equal:
        lead = lead + any_null.astype(jnp.int32)
    lead_thr = 1  # sorted rows with first-class >= lead_thr are null/pad
    operands: List[jnp.ndarray] = []
    for i, (d, v) in enumerate(zip(datas, valids)):
        dz = jnp.where(v, d, jnp.zeros((), d.dtype))
        if i == 0:
            cls = lead
            if null_equal:
                cls = lead * 2 + (~v).astype(jnp.int32)
                lead_thr = 4  # null-in-key0 rows keep real ranks here
        elif null_equal:
            cls = (~v).astype(jnp.int32)
        else:
            cls = None
        if d.dtype == jnp.int32:
            u = dz.astype(jnp.int64) - jnp.int64(np.iinfo(np.int32).min)
            if cls is not None:
                u = (cls.astype(jnp.int64) << 32) | u
            operands.append(u)
        else:
            if cls is not None:
                operands.append(cls)
            operands.append(dz)
    sorted_all = jax.lax.sort(
        operands + [perm], num_keys=len(operands), is_stable=True
    )
    first = sorted_all[0]
    first_cls = (
        first >> 32 if (datas[0].dtype == jnp.int32) else first
    )
    sorted_lead = (first_cls >= lead_thr).astype(jnp.int32)
    change, seg = _segment_ids_from_sorted(
        sorted_all[:-1], sorted_lead > 0
    )
    sperm = sorted_all[-1]
    ranks = jnp.zeros(cap, dtype=jnp.int32).at[sperm].set(seg.astype(jnp.int32))
    if not null_equal:
        # null keys never match: unique negative rank per row
        ranks = jnp.where(any_null, -(perm + 2), ranks)
    return ranks[:cap_l], ranks[cap_l:], sperm, sorted_lead, change


def join_ranks_counts(
    left_keys: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    right_keys: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    n_left,
    n_right,
    space=None,
):
    """Fused join_ranks + join_counts from ONE joint sort.

    join_counts' per-left-row count was a random gather from the rank
    table (`cnt_r[lr_c]`, a full-length random gather). Here the
    per-segment right-count is computed IN SORTED SPACE with scans
    (bandwidth-bound) and scattered once to row order — the scatter
    shares its cost class with the rank scatter that already exists.

    Returns (lr, rr, total, counts, offsets, rank_start, right_by_rank,
    left_matched, right_matched) — same contract as join_ranks followed
    by join_counts (SQL equi-join NULL semantics: NULL keys never match).
    """
    cap_l = left_keys[0][0].shape[0]
    cap_r = right_keys[0][0].shape[0]
    n_ranks = cap_l + cap_r
    lr, rr, sperm, sorted_lead, change = _join_ranks_full(
        left_keys, right_keys, n_left, n_right, space=space
    )
    n = sperm.shape[0]
    assert n < (1 << 31), n  # (idx << 32) | prefix encoding bit budget
    valid_pos = sorted_lead == 0  # live, non-null keys
    is_right = sperm >= cap_l
    left_pos = valid_pos & ~is_right
    x_r = (valid_pos & is_right).astype(jnp.int32)
    x_l = left_pos.astype(jnp.int32)
    # Left rows precede right rows inside every key segment (stable sort
    # over the left++right concatenation — see join_count_total), so a
    # left position's match count is the segment's rights BETWEEN p and
    # the next segment start: ONE reverse encoded cummax carrying the
    # next change's exclusive right-prefix (replaces a fwd+bwd
    # _seg_total_i32), and a right position's matched bit needs only the
    # FORWARD left-prefix carry (replaces the second fwd+bwd pass).
    L = jnp.cumsum(x_l)
    R = jnp.cumsum(x_r)
    idx = jnp.arange(n, dtype=jnp.int64)
    lo = jnp.int64(0xFFFFFFFF)
    rex = (R - x_r).astype(jnp.int64)
    enc_rr = jnp.where(change[::-1], (idx << 32) | rex[::-1], jnp.int64(-1))
    m_rr = jax.lax.cummax(enc_rr)[::-1]  # nearest change >= p
    m_next = jnp.concatenate([m_rr[1:], jnp.full((1,), -1, jnp.int64)])
    r_end = jnp.where(m_next < 0, R[-1].astype(jnp.int64), m_next & lo)
    nr_at = (r_end - R.astype(jnp.int64)).astype(jnp.int32)
    # scatter per-left counts back to row order (i32; drop non-left)
    tgt = jnp.where(left_pos, sperm, jnp.int32(n_ranks))
    counts = (
        jnp.zeros(cap_l, dtype=jnp.int32)
        .at[tgt]
        .set(jnp.where(left_pos, nr_at, 0), mode="drop")
    )
    offsets = (jnp.cumsum(counts) - counts).astype(jnp.int64)
    total = jnp.sum(counts.astype(jnp.int64))
    left_matched = counts > 0
    lex = (L - x_l).astype(jnp.int64)
    enc_l = jnp.where(change, (idx << 32) | lex, jnp.int64(-1))
    m_l = jax.lax.cummax(enc_l)
    nl_at = L.astype(jnp.int64) - jnp.where(m_l < 0, 0, m_l & lo)
    rtgt = jnp.where(valid_pos & is_right, sperm - cap_l, jnp.int32(n_ranks))
    right_matched = (
        jnp.zeros(cap_r, dtype=bool)
        .at[rtgt]
        .set(nl_at > 0, mode="drop")
    )
    # emit machinery: right rows grouped by rank (small-side sort)
    lm_r = live_mask(cap_r, n_right)
    r_ok = lm_r & (rr >= 0)
    rr_c = jnp.where(r_ok, rr, n_ranks - 1).astype(jnp.int32)
    cnt_r_table = jax.ops.segment_sum(
        r_ok.astype(jnp.int32), rr_c, num_segments=n_ranks
    )
    rank_start = jnp.cumsum(cnt_r_table) - cnt_r_table
    rperm = jnp.arange(cap_r, dtype=jnp.int32)
    _, right_by_rank = jax.lax.sort([rr_c, rperm], num_keys=1,
                                    is_stable=True)
    return (lr, rr, total, counts, offsets, rank_start, right_by_rank,
            left_matched, right_matched)


def join_count_total(
    left_keys: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    right_keys: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    n_left,
    n_right,
    return_space: bool = False,
):
    """COUNT-pass-only join size with NO scatters or gathers: one joint
    sort + segmented scans + reductions (the emit-capacity count program
    reads one scalar; ranks are never materialized — XLA DCE removes the
    rank scatter inside _join_ranks_full since lr/rr go unused).

    Returns (total_matches, matched_left_rows, matched_right_rows)
    [+ (sperm, sorted_lead, change) when return_space — the count program
    surfaces its sorted space so the emit program skips the joint sort].
    """
    cap_l = left_keys[0][0].shape[0]
    _, _, sperm, sorted_lead, change = _join_ranks_full(
        left_keys, right_keys, n_left, n_right
    )
    n = sperm.shape[0]
    assert n < (1 << 31), n  # (idx << 32) | prefix encoding bit budget
    valid_pos = sorted_lead == 0
    is_right = sperm >= cap_l
    x_r = (valid_pos & is_right).astype(jnp.int32)
    x_l = (valid_pos & ~is_right).astype(jnp.int32)
    # The stable joint sort keeps original order within equal keys, and
    # left rows precede right rows in the input concatenation — so inside
    # every key segment ALL left rows come before ALL right rows. A right
    # position p therefore sees its segment's ENTIRE left count in the
    # forward prefix: nl(p) = L[p] - Lex[seg_start(p)]. That makes the
    # whole count program forward-only: 2 cumsums + 2 encoded cummaxes
    # (vs the previous 2x _seg_total_i32 = 4 encoded scans + 4 plane
    # reversals — measured 64% of the op's speed-of-light in round 4;
    # VERDICT r4 item 3).
    L = jnp.cumsum(x_l)  # inclusive
    R = jnp.cumsum(x_r)
    idx = jnp.arange(n, dtype=jnp.int64)
    lex = (L - x_l).astype(jnp.int64)  # exclusive prefix
    rex = (R - x_r).astype(jnp.int64)
    enc_l = jnp.where(change, (idx << 32) | lex, jnp.int64(-1))
    enc_r = jnp.where(change, (idx << 32) | rex, jnp.int64(-1))
    m_l = jax.lax.cummax(enc_l)  # latest segment start's lex, per position
    m_r = jax.lax.cummax(enc_r)
    lo = jnp.int64(0xFFFFFFFF)
    l_start = jnp.where(m_l < 0, 0, m_l & lo)
    nl_at = L.astype(jnp.int64) - l_start
    right_here = x_r > 0
    # total = sum over segments nl*nr = sum over right positions nl(p)
    total = jnp.sum(jnp.where(right_here, nl_at, 0))
    matched_right = jnp.sum((right_here & (nl_at > 0)).astype(jnp.int64))
    # matched_left = sum over segments nl*[nr>0]: close each segment at
    # the NEXT change position (prev-start carries via a 1-shift of the
    # cummaxes), plus the final segment's term at the array end
    m_lp = jnp.concatenate([jnp.full((1,), -1, jnp.int64), m_l[:-1]])
    m_rp = jnp.concatenate([jnp.full((1,), -1, jnp.int64), m_r[:-1]])
    nl_seg = lex - jnp.where(m_lp < 0, 0, m_lp & lo)
    nr_seg = rex - jnp.where(m_rp < 0, 0, m_rp & lo)
    ml_terms = jnp.where(change & (nr_seg > 0), nl_seg, 0)
    nl_fin = L[-1].astype(jnp.int64) - jnp.where(m_l[-1] < 0, 0, m_l[-1] & lo)
    nr_fin = R[-1].astype(jnp.int64) - jnp.where(m_r[-1] < 0, 0, m_r[-1] & lo)
    matched_left = jnp.sum(ml_terms) + jnp.where(nr_fin > 0, nl_fin,
                                                 jnp.int64(0))
    if return_space:
        return total, matched_left, matched_right, (sperm, sorted_lead, change)
    return total, matched_left, matched_right


def join_counts(
    left_ranks: jnp.ndarray,
    right_ranks: jnp.ndarray,
    n_left,
    n_right,
):
    """Pass 1: per-left-row match counts. No searchsorted —
    pure segment-sum + gather over the dense rank space.

    Returns (total_matches, counts[cap_l], offsets[cap_l] exclusive-cumsum,
    rank_start[n_ranks], right_by_rank[cap_r], left_matched, right_matched).
    rank_start[r] is the start of rank r's rows inside right_by_rank, which
    lists live non-null right row indices grouped by rank.
    """
    cap_l = left_ranks.shape[0]
    cap_r = right_ranks.shape[0]
    n_ranks = cap_l + cap_r
    lm_l = live_mask(cap_l, n_left)
    lm_r = live_mask(cap_r, n_right)
    l_ok = lm_l & (left_ranks >= 0)
    r_ok = lm_r & (right_ranks >= 0)
    lr_c = jnp.where(l_ok, left_ranks, n_ranks - 1).astype(jnp.int32)
    rr_c = jnp.where(r_ok, right_ranks, n_ranks - 1).astype(jnp.int32)
    # per-rank cardinalities
    cnt_r = jax.ops.segment_sum(
        r_ok.astype(jnp.int32), rr_c, num_segments=n_ranks
    )
    cnt_l = jax.ops.segment_sum(
        l_ok.astype(jnp.int32), lr_c, num_segments=n_ranks
    )
    # note: the n_ranks-1 dummy slot may mix pad/null counts; mask at use
    counts = jnp.where(l_ok, cnt_r[lr_c], 0)  # int32
    offsets = (jnp.cumsum(counts) - counts).astype(jnp.int64)
    total = jnp.sum(counts.astype(jnp.int64))
    left_matched = counts > 0
    right_matched = r_ok & (cnt_l[rr_c] > 0)
    # right rows grouped by rank: scatter row index to rank_start[r] + #seen
    rank_start = jnp.cumsum(cnt_r) - cnt_r  # exclusive cumsum per rank
    # position of each right row within its rank group = running count of
    # prior same-rank rows; rows are processed in index order, so use a
    # stable sort of (rank, row) and subtract the rank start position.
    rperm = jnp.arange(cap_r, dtype=jnp.int32)
    rr_sorted, rperm_sorted = jax.lax.sort(
        [rr_c, rperm], num_keys=1, is_stable=True
    )
    # in sorted order, live non-null rows of rank r occupy a contiguous run
    # whose global start equals rank_start[r]; so right_by_rank is simply
    # the sorted row indices.
    right_by_rank = rperm_sorted
    return (
        total, counts, offsets, rank_start, right_by_rank,
        left_matched, right_matched,
    )


def join_emit_inner(
    counts: jnp.ndarray,
    rank_start: jnp.ndarray,
    right_by_rank: jnp.ndarray,
    left_ranks: jnp.ndarray,
    total,
    out_capacity: int,
):
    """Pass 2: emit (left_idx, right_idx) pairs, compacted, left-major.

    out_capacity is a static bucket >= total (host chose it after pass 1).
    The owning left row for each output slot is recovered with a scatter of
    row ids at each row's output offset followed by a running cummax — no
    searchsorted.
    """
    # all-int32 emit: indices/offsets fit int32 (out_capacity < 2^31 by
    # construction — the host sized it from the count pass), half the
    # bytes of int64
    cap_l = counts.shape[0]
    counts32 = counts.astype(jnp.int32)
    csum = jnp.cumsum(counts32)
    starts = csum - counts32
    rows = jnp.arange(cap_l, dtype=jnp.int32)
    mark = (
        jnp.zeros(out_capacity, dtype=jnp.int32)
        .at[jnp.where(counts32 > 0, starts, out_capacity)]
        .max(rows, mode="drop")
    )
    owner = jax.lax.cummax(mark)
    t = jnp.arange(out_capacity, dtype=jnp.int32)
    j = t - starts[owner]
    lrank = jnp.clip(
        left_ranks[owner].astype(jnp.int32), 0, rank_start.shape[0] - 1
    )
    rpos = rank_start[lrank].astype(jnp.int32) + j
    ri = right_by_rank[jnp.clip(rpos, 0, right_by_rank.shape[0] - 1)]
    valid = t < total
    return (
        jnp.where(valid, owner, 0),
        jnp.where(valid, ri, 0),
        valid,
    )


def fk_join_right_lookup(
    left_ranks: jnp.ndarray,
    right_ranks: jnp.ndarray,
    n_left,
    n_right,
    n_ranks: int = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """FK fast path for joins whose build (right) side is UNIQUE per key:
    each probe row has at most one match, so the emit is a direct rank ->
    right-row lookup — no per-left counts, no owner recovery, no output
    repacking (output rows sit at their left-row positions; callers carry a
    selection mask). Measured ~4x cheaper than join_counts+join_emit at
    16.7M rows. Returns (right_row per left row, matched mask)."""
    cap_l = left_ranks.shape[0]
    cap_r = right_ranks.shape[0]
    if n_ranks is None:
        n_ranks = cap_l + cap_r
    lm_r = live_mask(cap_r, n_right)
    r_ok = lm_r & (right_ranks >= 0)
    rows_r = jnp.arange(cap_r, dtype=jnp.int32)
    table = (
        jnp.full(n_ranks, -1, dtype=jnp.int32)
        .at[jnp.where(r_ok, right_ranks, n_ranks)]
        .set(rows_r, mode="drop")
    )
    lm_l = live_mask(cap_l, n_left)
    l_ok = lm_l & (left_ranks >= 0)
    ri = jnp.where(
        l_ok, table[jnp.clip(left_ranks, 0, n_ranks - 1)], jnp.int32(-1)
    )
    matched = ri >= 0
    return jnp.where(matched, ri, 0), matched


def rank_member(
    lr: jnp.ndarray, rr: jnp.ndarray, r_live: jnp.ndarray,
    n_ranks: int = None,
) -> jnp.ndarray:
    """member[i] = probe rank lr[i] occurs among the live right ranks.
    One build-sized presence scatter + one probe gather — replaces the
    sorted-membership searchsorted. Used by INTERSECT/EXCEPT and
    IN-subquery membership."""
    cap_l = lr.shape[0]
    cap_r = rr.shape[0]
    if n_ranks is None:
        n_ranks = cap_l + cap_r
    r_ok = r_live & (rr >= 0)
    pres = (
        jnp.zeros(n_ranks, dtype=bool)
        .at[jnp.where(r_ok, rr, n_ranks)]
        .set(True, mode="drop")
    )
    return (lr >= 0) & pres[jnp.clip(lr, 0, n_ranks - 1)]


def unmatched_indices(matched: jnp.ndarray, num_rows, out_capacity: int):
    """Rows with no match (for outer joins): compacted indices + count."""
    um = ~matched & live_mask(matched.shape[0], num_rows)
    count = jnp.sum(um.astype(jnp.int64))
    idx = compaction_indices(um, num_rows, out_capacity)
    return idx, count


def cross_join_indices(n_left, n_right, out_capacity: int):
    """CROSS join index planes (left-major order, matching the reference's
    take-based repetition executor.rs:437-498)."""
    t = jnp.arange(out_capacity, dtype=jnp.int64)
    total = n_left * n_right
    li = t // jnp.maximum(n_right, 1)
    ri = t % jnp.maximum(n_right, 1)
    valid = t < total
    return jnp.where(valid, li, 0), jnp.where(valid, ri, 0), valid


# ---------------------------------------------------------------------------
# window functions (over sorted rows; results scattered back by caller)
# ---------------------------------------------------------------------------


def window_segments(
    part_sorted: Sequence[jnp.ndarray],
    order_sorted: Sequence[jnp.ndarray],
    pad_sorted: jnp.ndarray,
):
    """Given partition/order key planes already in window order, compute:
    seg_start flag, peer_start flag (order-key change), segment id."""
    capacity = pad_sorted.shape[0]
    idx = jnp.arange(capacity)
    seg_change = jnp.zeros(capacity, dtype=bool).at[0].set(True)
    for k in part_sorted:
        seg_change = seg_change | (idx > 0) & (k != jnp.roll(k, 1))
    seg_change = seg_change | (pad_sorted & ~jnp.roll(pad_sorted, 1))
    peer_change = seg_change
    for k in order_sorted:
        peer_change = peer_change | (idx > 0) & (k != jnp.roll(k, 1))
    seg = jnp.cumsum(seg_change.astype(jnp.int64)) - 1
    return seg_change, peer_change, seg


def _seg_start_pos(seg_change: jnp.ndarray) -> jnp.ndarray:
    idx = jnp.arange(seg_change.shape[0], dtype=jnp.int32)
    return jax.lax.cummax(jnp.where(seg_change, idx, 0))


def _seg_end_pos(seg_change: jnp.ndarray) -> jnp.ndarray:
    """Index of last row of each row's segment."""
    capacity = seg_change.shape[0]
    idx = jnp.arange(capacity, dtype=jnp.int32)
    nxt = jnp.roll(seg_change, -1).at[capacity - 1].set(True)
    ends = jnp.where(nxt, idx, capacity - 1)
    return jnp.flip(jax.lax.cummin(jnp.flip(ends)))


def row_number_sorted(seg_change: jnp.ndarray) -> jnp.ndarray:
    idx = jnp.arange(seg_change.shape[0], dtype=jnp.int32)
    return (idx - _seg_start_pos(seg_change) + 1).astype(jnp.int64)


def rank_sorted(seg_change: jnp.ndarray, peer_change: jnp.ndarray) -> jnp.ndarray:
    idx = jnp.arange(seg_change.shape[0], dtype=jnp.int32)
    run_start = jax.lax.cummax(jnp.where(peer_change, idx, 0))
    return (run_start - _seg_start_pos(seg_change) + 1).astype(jnp.int64)


def dense_rank_sorted(seg_change, peer_change) -> jnp.ndarray:
    peers = jnp.cumsum(peer_change.astype(jnp.int32))
    at_seg_start = jax.lax.cummax(jnp.where(seg_change, peers, 0))
    return (peers - at_seg_start + 1).astype(jnp.int64)


def ntile_sorted(seg_change: jnp.ndarray, n_tiles, pad_sorted) -> jnp.ndarray:
    """PG NTILE: q=count//n, r=count%n; first r buckets get q+1 rows."""
    rn = row_number_sorted(seg_change) - 1  # 0-based
    start = _seg_start_pos(seg_change)
    end = _seg_end_pos(seg_change)
    count = (end - start + 1).astype(jnp.int64)
    count = jnp.where(pad_sorted, 1, count)
    n = jnp.maximum(n_tiles, 1)
    q = count // n
    r = count % n
    big = r * (q + 1)
    in_big = rn < big
    bucket = jnp.where(
        in_big,
        rn // jnp.maximum(q + 1, 1),
        r + jnp.where(q > 0, (rn - big) // jnp.maximum(q, 1), 0),
    )
    return bucket + 1


def percent_rank_sorted(seg_change, peer_change) -> jnp.ndarray:
    """PG PERCENT_RANK = (rank - 1) / (count - 1); 0 for 1-row partitions."""
    rank = rank_sorted(seg_change, peer_change)
    count = (_seg_end_pos(seg_change) - _seg_start_pos(seg_change) + 1)
    count = count.astype(jnp.float64)
    return jnp.where(
        count > 1,
        (rank - 1).astype(jnp.float64) / jnp.maximum(count - 1.0, 1.0),
        0.0,
    )


def cume_dist_sorted(seg_change, peer_change) -> jnp.ndarray:
    """PG CUME_DIST = (# rows <= current incl. tie peers) / count. The last
    tie peer's position gives the numerator; peer runs never cross segment
    boundaries (seg_change implies peer_change in window_segments)."""
    start = _seg_start_pos(seg_change)
    count = (_seg_end_pos(seg_change) - start + 1).astype(jnp.float64)
    peers_thru = (_seg_end_pos(peer_change) - start + 1).astype(jnp.float64)
    return peers_thru / jnp.maximum(count, 1.0)


def _run_broadcast_first(vals: jnp.ndarray, start_flag: jnp.ndarray):
    """Broadcast each run's FIRST value across the run (runs delimited by
    start_flag) — encoded cummax scans, no gathers, no associative_scan
    (slow to compile at 16M+ rows; docs/DESIGN.md #8). The run-start
    position keys the max; the
    payload rides in the low 32 bits, split into two half scans for
    64-bit payloads (both scans pick the same flagged slot, so the halves
    recombine consistently). Positions before any flag keep their value
    (identity), matching the old scan's semantics."""
    n = vals.shape[0]
    dt = vals.dtype
    if jnp.issubdtype(dt, jnp.floating):
        u = jax.lax.bitcast_convert_type(
            vals.astype(jnp.float64), jnp.uint64
        )
    else:
        u = vals.astype(jnp.int64).astype(jnp.uint64)
    idx = jnp.arange(n, dtype=jnp.int64)
    lo = (u & jnp.uint64(0xFFFFFFFF)).astype(jnp.int64)
    hi = (u >> jnp.uint64(32)).astype(jnp.int64)
    none = jnp.int64(-1)
    m_lo = jax.lax.cummax(jnp.where(start_flag, (idx << 32) | lo, none))
    m_hi = jax.lax.cummax(jnp.where(start_flag, (idx << 32) | hi, none))
    out_u = (
        ((m_hi & jnp.int64(0xFFFFFFFF)).astype(jnp.uint64) << jnp.uint64(32))
        | (m_lo & jnp.int64(0xFFFFFFFF)).astype(jnp.uint64)
    )
    if jnp.issubdtype(dt, jnp.floating):
        out = jax.lax.bitcast_convert_type(out_u, jnp.float64).astype(dt)
    else:
        out = out_u.astype(jnp.int64).astype(dt)
    return jnp.where(m_lo >= 0, out, vals)


def _segment_running_extreme(
    vals: jnp.ndarray, ok: jnp.ndarray, seg_change: jnp.ndarray, is_min: bool
) -> jnp.ndarray:
    """Running min/max within segments.

    32-bit-image values (int32/float32/dictionary codes) ride ONE encoded
    cummax: segment id in the high word, order-preserving value image in
    the low word — segment ids are nondecreasing along the plane, so the
    running max always comes from the CURRENT segment (a built-in reset).
    MIN negates the image. 64-bit values keep the associative_scan
    (running extremes are not positional, so the broadcast-first
    half-splitting trick does not apply); their compile cost at very
    large capacities is a known compile-time hazard (docs/DESIGN.md #8)."""
    dt = vals.dtype
    cap = vals.shape[0]
    if dt in (jnp.int32, jnp.float32) and cap < (1 << 29):
        # encode (segment id << 33) | (ok << 32) | value image: segment
        # ids are nondecreasing along the plane so one cummax resets at
        # every boundary for free; the ok bit makes any valid row beat
        # the invalid ones of its segment; the 32-bit order-preserving
        # image compares like the value. MIN complements the image.
        if dt == jnp.float32:
            img = _f32_orderable_bits(vals).astype(jnp.int64) - jnp.int64(
                np.iinfo(np.int32).min
            )
        else:
            img = vals.astype(jnp.int64) - jnp.int64(np.iinfo(np.int32).min)
        if is_min:
            img = jnp.int64(0xFFFFFFFF) - img
        enc = jnp.where(ok, (jnp.int64(1) << 32) | img, jnp.int64(0))
        seg = jnp.cumsum(seg_change.astype(jnp.int64)) - 1
        m = jax.lax.cummax((seg << 33) | enc)
        seen = ((m >> 32) & jnp.int64(1)) > 0
        got = m & jnp.int64(0xFFFFFFFF)
        img_out = jnp.where(is_min, jnp.int64(0xFFFFFFFF) - got, got)
        if dt == jnp.float32:
            # recover the f32 image, invert the sign-flip, widen exactly
            sf = (img_out + jnp.int64(np.iinfo(np.int32).min)).astype(
                jnp.int32
            )
            out = from_orderable(sf, jnp.float32).astype(jnp.float64)
            neu = jnp.float64(np.inf if is_min else -np.inf)
            return jnp.where(seen, out, neu)
        out = img_out + jnp.int64(np.iinfo(np.int32).min)
        neu = _INT_MAX if is_min else _INT_MIN
        return jnp.where(seen, out, neu)
    if jnp.issubdtype(dt, jnp.floating):
        x = vals.astype(jnp.float64)
        neutral = jnp.float64(np.inf if is_min else -np.inf)
    else:
        x = vals.astype(jnp.int64)
        neutral = _INT_MAX if is_min else _INT_MIN
    x = jnp.where(ok, x, neutral)
    pick = jnp.minimum if is_min else jnp.maximum

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, pick(va, vb))

    _, out = jax.lax.associative_scan(combine, (seg_change, x))
    return out


def range_off_order_plane(kd, kok, asc: bool, nulls_first: bool):
    """Normalize a sorted ORDER BY key plane for a value-distance frame:
    DESC negates (offsets then apply uniformly as [k - s, k + e]); NULL
    keys get a sentinel at the end of the segment they occupy in window
    order so the joint sort reproduces window-order positions exactly.
    Shared by the eager executor and the compiled tracer."""
    if not asc:
        kd = -kd
    if jnp.issubdtype(kd.dtype, jnp.floating):
        s_lo, s_hi = -jnp.inf, jnp.inf
    else:
        s_lo = jnp.iinfo(kd.dtype).min // 2
        s_hi = jnp.iinfo(kd.dtype).max // 2
    sent = s_lo if nulls_first else s_hi
    return jnp.where(kok, kd, jnp.asarray(sent, kd.dtype)), kok


def _range_off_bounds(okey, okey_ok, seg_change, peer_change, pad_sorted,
                      s_off, e_off):
    """Per-row [lo, hi] POSITIONS for a value-distance frame
    (RANGE BETWEEN s_off PRECEDING AND e_off FOLLOWING) over rows already
    in window order. `okey` is the single ORDER BY key in sorted order,
    monotone non-decreasing within each segment (callers negate for DESC,
    so offsets apply uniformly as [k - s_off, k + e_off]).

    No searchsorted: ONE
    joint lax.sort of (segment, key, tag) over data rows + one probe per
    bounded side places each bound among the data keys; an exclusive
    data-count prefix read at the probe's slot IS the boundary position.
    Rows with a NULL order key frame their NULL peer group (PG)."""
    cap = okey.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    seg = jnp.cumsum(seg_change.astype(jnp.int64)) - 1
    seg = jnp.where(pad_sorted, jnp.int64(cap), seg)
    segs = [seg]
    keys = [okey]
    tags = [jnp.ones(cap, dtype=jnp.int32)]
    ids = [idx]
    if s_off is not None:
        segs.append(seg)
        keys.append(okey - s_off)
        tags.append(jnp.zeros(cap, dtype=jnp.int32))  # before equal keys
        ids.append(idx)
    if e_off is not None:
        segs.append(seg)
        keys.append(okey + e_off)
        tags.append(jnp.full(cap, 2, dtype=jnp.int32))  # after equal keys
        ids.append(idx)
    sseg, skey, stag, sid = jax.lax.sort(
        [jnp.concatenate(segs), jnp.concatenate(keys),
         jnp.concatenate(tags), jnp.concatenate(ids)],
        num_keys=3,
    )
    is_data = stag == 1
    data_before = jnp.cumsum(is_data.astype(jnp.int32)) - is_data
    seg_start = _seg_start_pos(seg_change)
    seg_end = _seg_end_pos(seg_change)
    if s_off is not None:
        dest = jnp.where(stag == 0, sid, cap)
        lo = jnp.zeros(cap + 1, jnp.int32).at[dest].set(data_before)[:cap]
        lo = jnp.maximum(lo, seg_start)
    else:
        lo = seg_start
    if e_off is not None:
        dest = jnp.where(stag == 2, sid, cap)
        hi = (jnp.zeros(cap + 1, jnp.int32).at[dest].set(data_before)[:cap]
              - 1)
        hi = jnp.minimum(hi, seg_end)
    else:
        hi = seg_end
    # NULL order keys: the frame is the row's NULL peer group
    peer_start = _seg_start_pos(peer_change)
    peer_end = _seg_end_pos(peer_change)
    lo = jnp.where(okey_ok, lo, peer_start)
    hi = jnp.where(okey_ok, hi, peer_end)
    return lo, hi


def window_frame_bounds(frame, seg_change, peer_change, pad_sorted,
                        order_plane=None):
    """Per-row frame [lo, hi] POSITIONS in sorted space for any frame
    descriptor — shared by aggregate windows and the positional value
    functions (FIRST_VALUE/LAST_VALUE/NTH_VALUE read positions lo / hi /
    lo + n - 1). Empty frames have hi < lo."""
    cap = seg_change.shape[0]
    i32 = jnp.arange(cap, dtype=jnp.int32)
    seg_start = _seg_start_pos(seg_change)
    seg_end = _seg_end_pos(seg_change)
    kind = frame[0]
    if kind == "partition":
        return seg_start, seg_end
    if kind == "range_current":
        return seg_start, _seg_end_pos(peer_change)
    if kind == "range_off":
        okey, okey_ok = order_plane
        return _range_off_bounds(
            okey, okey_ok, seg_change, peer_change, pad_sorted,
            frame[1], frame[2],
        )
    _, s_off, e_off = frame
    lo = seg_start if s_off is None else jnp.maximum(i32 - s_off, seg_start)
    hi = seg_end if e_off is None else jnp.minimum(i32 + e_off, seg_end)
    return lo, hi


def window_aggregate_sorted(
    func: str,                      # count_star|count|sum|avg|min|max
    vals: Optional[jnp.ndarray],    # sorted order; None for count_star
    ok: Optional[jnp.ndarray],      # validity in sorted order
    seg_change: jnp.ndarray,
    peer_change: jnp.ndarray,
    pad_sorted: jnp.ndarray,
    frame,                          # ("partition",) | ("range_current",) |
                                    # ("rows", start, end): None=UNBOUNDED,
                                    # int = row offset (0 = CURRENT ROW) |
                                    # ("range_off", s, e): value distances
    order_plane=None,               # ("range_off" only) (okey, okey_ok) in
                                    # sorted order, DESC pre-negated
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Aggregate window functions over rows already in window order:
    running totals and rolling frames as prefix-sum differences; MIN/MAX as
    a segmented scan (unbounded start) or per-segment reduce (whole
    partition). Returns (values, valid) in sorted order.

    Beyond the reference: its WindowFunctionType has no aggregate members
    (ast.rs:236-245) and its executor passes windows through unchanged."""
    cap = seg_change.shape[0]
    i32 = jnp.arange(cap, dtype=jnp.int32)
    live = ~pad_sorted
    ok_live = live if (ok is None or vals is None) else (ok & live)
    seg_start = _seg_start_pos(seg_change)
    seg_end = _seg_end_pos(seg_change)

    kind = frame[0]
    lo, hi = window_frame_bounds(
        frame, seg_change, peer_change, pad_sorted, order_plane
    )
    empty = hi < lo

    if kind in ("partition", "range_current"):
        # gather-free frame sums: P[hi] is "P at the end of my (peer) run"
        # = reverse broadcast-first scan, and P[seg_start-1] is a shift +
        # forward broadcast — two scans in place of two full-length
        # random gathers
        end_flag = (
            jnp.roll(seg_change, -1).at[cap - 1].set(True)
            if kind == "partition"
            else jnp.roll(peer_change, -1).at[cap - 1].set(True)
        )

        def frame_range(P):
            at_end = jnp.flip(_run_broadcast_first(
                jnp.flip(P), jnp.flip(end_flag)
            ))
            p_shift = jnp.roll(P, 1).at[0].set(0)
            before_seg = _run_broadcast_first(
                jnp.where(seg_change, p_shift, 0), seg_change
            )
            return at_end - before_seg
    else:
        def frame_range(P):
            lo_prev = jnp.where(lo > 0, P[jnp.clip(lo - 1, 0, cap - 1)], 0)
            return P[jnp.clip(hi, 0, cap - 1)] - lo_prev

    cnt = jnp.where(
        empty, 0, frame_range(jnp.cumsum(ok_live.astype(jnp.int64)))
    )
    if func in ("count", "count_star"):
        return cnt, jnp.ones(cap, dtype=bool)
    assert vals is not None
    if func in ("sum", "avg"):
        acc_t = (
            jnp.float64 if jnp.issubdtype(vals.dtype, jnp.floating)
            else jnp.int64
        )
        x = jnp.where(ok_live, vals.astype(acc_t), jnp.zeros((), acc_t))
        ssum = jnp.where(empty, 0, frame_range(jnp.cumsum(x)))
        if func == "avg":
            return (
                ssum.astype(jnp.float64) / jnp.maximum(cnt, 1).astype(jnp.float64),
                cnt > 0,
            )
        return ssum, cnt > 0
    # min / max
    is_min = func == "min"
    whole = kind == "partition" or (
        kind == "rows" and frame[1] is None and frame[2] is None
    )
    if whole:
        seg32 = (jnp.cumsum(seg_change.astype(jnp.int32)) - 1)
        per_seg = _segment_extreme(vals, ok_live, seg32, cap, is_min)
        return per_seg[seg32], cnt > 0
    if kind == "range_current" or frame[1] is None:
        # unbounded start: running extreme, read at the frame end
        run = _segment_running_extreme(vals, ok_live, seg_change, is_min)
        return run[jnp.clip(hi, 0, cap - 1)], cnt > 0
    if kind == "range_off":
        if frame[2] is None:
            # unbounded end: reverse running extreme, read at frame start
            seg_end_flag2 = jnp.roll(seg_change, -1).at[cap - 1].set(True)
            pick2 = jnp.minimum if is_min else jnp.maximum
            if jnp.issubdtype(vals.dtype, jnp.floating):
                x2 = vals.astype(jnp.float64)
                neu = jnp.float64(np.inf if is_min else -np.inf)
            else:
                x2 = vals.astype(jnp.int64)
                neu = _INT_MAX if is_min else _INT_MIN
            x2 = jnp.where(ok_live, x2, neu)
            _, rev2 = jax.lax.associative_scan(
                lambda a, b: (a[0] | b[0],
                              jnp.where(b[0], b[1], pick2(a[1], b[1]))),
                (jnp.flip(seg_end_flag2), jnp.flip(x2)),
            )
            return jnp.flip(rev2)[jnp.clip(lo, 0, cap - 1)], cnt > 0
        from query_engine_tpu.core.errors import ExecutionError

        raise ExecutionError(
            "MIN/MAX over a bounded RANGE offset frame is not supported"
        )
    # bounded ROWS start: van Herk / Gil-Werman block decomposition for the
    # interior windows, with running / reverse-running extremes covering
    # the segment-clamped edges
    s_off, e_off = frame[1], frame[2]
    if jnp.issubdtype(vals.dtype, jnp.floating):
        x = vals.astype(jnp.float64)
        neutral = jnp.float64(np.inf if is_min else -np.inf)
    else:
        x = vals.astype(jnp.int64)
        neutral = _INT_MAX if is_min else _INT_MIN
    x = jnp.where(ok_live, x, neutral)
    pick = jnp.minimum if is_min else jnp.maximum
    red = jax.lax.cummin if is_min else jax.lax.cummax
    run = _segment_running_extreme(vals, ok_live, seg_change, is_min)
    # reverse running extreme (suffix within segment)
    seg_end_flag = jnp.roll(seg_change, -1).at[cap - 1].set(True)
    _, rev = jax.lax.associative_scan(
        lambda a, b: (a[0] | b[0], jnp.where(b[0], b[1], pick(a[1], b[1]))),
        (jnp.flip(seg_end_flag), jnp.flip(x)),
    )
    rev_run = jnp.flip(rev)
    if e_off is None:
        # frame = [max(i - s, seg_start), seg_end]
        return rev_run[jnp.clip(lo, 0, cap - 1)], cnt > 0
    k = s_off + e_off + 1
    nb = -(-cap // k)
    xp = jnp.concatenate([x, jnp.full(nb * k - cap, neutral, x.dtype)])
    X = xp.reshape(nb, k)
    pref = red(X, axis=1).reshape(-1)
    suff = jnp.flip(red(jnp.flip(X, axis=1), axis=1), axis=1).reshape(-1)
    # window of size k ending at j: combine(suff[j-k+1], pref[j]) — sourced
    # positions stay inside [j-k+1, j], so interior windows never read
    # across a segment boundary
    j = jnp.clip(hi, 0, cap - 1)
    start_pos = jnp.clip(j - k + 1, 0, cap - 1)
    vh = pick(suff[start_pos], pref[jnp.clip(j, 0, nb * k - 1)])
    start_clamped = (jnp.arange(cap, dtype=jnp.int32) - s_off) < lo
    end_clamped = (jnp.arange(cap, dtype=jnp.int32) + e_off) > hi
    out = jnp.where(
        start_clamped, run[j],
        jnp.where(end_clamped, rev_run[jnp.clip(lo, 0, cap - 1)], vh),
    )
    return out, cnt > 0


def shift_in_segment(
    values: jnp.ndarray,
    valid: jnp.ndarray,
    seg: jnp.ndarray,
    offset: int,
):
    """LAG(offset>0)/LEAD(offset<0) within segments; out-of-segment -> null.

    src = i - offset is a constant shift, so jnp.roll (contiguous copy)
    replaces the full-length random gather."""
    capacity = values.shape[0]
    idx = jnp.arange(capacity, dtype=jnp.int32)
    src = idx - offset
    in_range = (src >= 0) & (src < capacity)
    same_seg = in_range & (jnp.roll(seg, offset) == seg)
    out = jnp.where(same_seg, jnp.roll(values, offset), values[0] * 0)
    out_v = same_seg & jnp.roll(valid, offset)
    return out, out_v


def value_at(values, valid, pos):
    pos_c = jnp.clip(pos, 0, values.shape[0] - 1)
    return values[pos_c], valid[pos_c]
