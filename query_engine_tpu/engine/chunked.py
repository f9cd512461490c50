"""Capacity-chunked execution: 100M+-row aggregate queries within HBM.

The compiled pipeline materializes a whole query segment's intermediates
at row capacity — at 100M+ rows (BASELINE config #5) that exhausts a
single chip's HBM. For the dominant analytical shape

    [Limit] [Sort] [Projection/Filter]* Aggregate( row-local subtree
        over ONE big table [+ small build sides] )

the fix is the same partial/final decomposition the mesh path uses
(engine/partial_agg.py), with row CHUNKS standing in for shards: the big
leaf's planes are sliced into fixed-capacity chunks, the partial
aggregate runs per chunk through the normal compiled pipeline (one
compiled program, reused by every chunk — chunk batches share capacity,
dtypes, dictionaries, and stat buckets), partials concat, and the final
combine + the group-table operators above run at group size.

Peak device memory ≈ resident table + ONE chunk's working set.
Correct for any row-partition of the big table because every admitted
node below the aggregate is row-decomposable: filters/projections are
rowwise, and joins see the full (small) build side in every chunk, with
join types gated so outer rows of the UNCHUNKED side cannot be emitted
once per chunk.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

from query_engine_tpu.columnar.batch import Column, ColumnBatch
from query_engine_tpu.engine.partial_agg import (
    build_partial_final, partial_eligible,
)
from query_engine_tpu.plan import logical as lp
from query_engine_tpu.plan import physical as pp


def chunk_engage_rows() -> int:
    """Capacity above which aggregates execute chunked (pow2)."""
    return int(os.environ.get("QE_CHUNK_ENGAGE", 1 << 27))


def chunk_rows() -> int:
    """Chunk capacity: smaller chunks trade extra dispatches for smaller
    working sets. This size and chunk_engage_rows are not yet measured on
    the H100."""
    return int(os.environ.get("QE_CHUNK_ROWS", 1 << 25))


class ChunkedAggregate:
    def __init__(self, executor):
        self.executor = executor
        self.stats = {"queries": 0, "chunks": 0}

    def try_execute(self, plan: pp.PhysicalPlan) -> Optional[ColumnBatch]:
        """Returns the result, or None when the plan shape / size does not
        call for chunking."""
        # path of group-table operators above the aggregate
        path: List[pp.PhysicalPlan] = []
        node = plan
        while isinstance(node, (pp.PLimit, pp.PSort, pp.PProjection,
                                pp.PFilter, pp.PDistinct, pp.PWindow,
                                pp.PSubquery)):
            path.append(node)
            node = node.input
        if not isinstance(node, pp.PHashAggregate) or node.mode != "single":
            return None
        agg = node
        if not partial_eligible(agg):
            return None
        big = self._admit_below(agg.input, big=None)
        if big is None or isinstance(big, bool):
            return None
        batch = self.executor._exec_scan(big)
        if batch.capacity < chunk_engage_rows():
            return None
        cc = min(chunk_rows(), batch.capacity)

        from query_engine_tpu.engine.pipeline import (
            ensure_bounds, ensure_device,
        )

        # the table must be device-resident BEFORE chunking: chunk slices
        # are then device-side ops — without this every chunk re-uploads
        # its slice through the host on EVERY dispatch
        ensure_device(batch)
        ensure_bounds(batch)
        partial, final, proj = build_partial_final(agg)

        self.stats["queries"] += 1
        partials: List[ColumnBatch] = []
        n = batch.num_rows
        n_chunks = max(1, (batch.capacity + cc - 1) // cc)
        from query_engine_tpu.engine.executor import _Materialized

        for i in range(n_chunks):
            lo = i * cc
            rows = min(cc, max(n - lo, 0))
            if rows == 0 and i > 0:
                break
            chunk = self._chunk_batch(batch, lo, cc, rows)
            part_plan = _substitute(partial, id(big), _Materialized(chunk))
            partials.append(self.executor.execute(part_plan))
            self.stats["chunks"] += 1

        combined = ColumnBatch.concat(partials)
        final_plan = _substitute(proj, id(partial), _Materialized(combined))
        out = self.executor.execute(final_plan)

        # the group-table operators above the aggregate
        for upper in reversed(path):
            rebuilt = dataclasses.replace(upper, input=_Materialized(out))
            out = self.executor.execute(rebuilt)
        return out

    def _admit_below(self, node, big):
        """Validate the sub-aggregate tree is row-decomposable and find
        the single big scan. Returns the big PScan, None (reject), or
        False (no big scan in this subtree — a small build side)."""
        if isinstance(node, pp.PScan):
            b = self.executor._exec_scan(node)
            if b.capacity >= chunk_engage_rows():
                return node if big is None else None
            return False
        if isinstance(node, (pp.PFilter, pp.PProjection, pp.PSubquery)):
            return self._admit_below(node.input, big)
        if isinstance(node, pp.PHashJoin):
            lb = self._admit_below(node.left, big)
            rb = self._admit_below(node.right, big)
            if lb is None or rb is None:
                return None
            if lb is False and rb is False:
                return False
            if lb is not False and rb is not False:
                return None  # two big sides: cannot chunk one
            # outer-join gate: the UNCHUNKED side must not be outer —
            # its unmatched rows would be emitted once per chunk
            jt = node.join_type
            if lb is not False:  # big side is LEFT
                if jt in (lp.JoinType.RIGHT, lp.JoinType.FULL,
                          lp.JoinType.CROSS):
                    return None
                return lb
            if jt in (lp.JoinType.LEFT, lp.JoinType.FULL,
                      lp.JoinType.CROSS):
                return None
            return rb
        return None  # sort/distinct/window/setop below the aggregate

    @staticmethod
    def _chunk_batch(batch: ColumnBatch, lo: int, cc: int, rows: int):
        cols = []
        for c in batch.columns:
            d = c.data[lo: lo + cc]
            v = c.validity[lo: lo + cc]
            nc = Column(d, v, c.dtype, c.dictionary)
            # global stats remain valid covers for any row subset
            b = getattr(c, "_qe_bounds", False)
            if b is not False:
                nc._qe_bounds = b
            md = getattr(c, "_qe_max_dup", None)
            if md is not None:
                nc._qe_max_dup = (rows, md[1])
            cols.append(nc)
        return ColumnBatch(batch.schema, cols, rows)


def _substitute(node, target_id, repl):
    """Copy the plan tree with the node `target_id` replaced."""
    if id(node) == target_id:
        return repl
    changes = {}
    for fname in ("input", "left", "right"):
        child = getattr(node, fname, None)
        if isinstance(child, pp.PhysicalPlan):
            new = _substitute(child, target_id, repl)
            if new is not child:
                changes[fname] = new
    if not changes:
        return node
    return dataclasses.replace(node, **changes)
