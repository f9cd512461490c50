"""Global dictionary merge for multi-host string ingest.

SURVEY.md §7 hard-part #3: each host ingests its rows independently and
builds a LOCAL sorted dictionary; before any cross-shard keyed operator
(distributed GROUP BY / ORDER BY / join on a string column) the codes must
agree globally. The protocol:

  1. host metadata plane: every host's dictionary VALUES travel over the
     control plane (they are host-side Python strings, never device data —
     the reference ships whole Utf8 arrays through Arrow IPC instead,
     network.rs:54-101);
  2. the controller computes the sorted union (columnar/dictionary.py
     merge_many — order-preserving, so code order == lexicographic order
     still holds globally);
  3. each shard's old->new remap plane is stacked into one [n_shards,
     pad] device array sharded over the mesh, and ONE shard_map gather
     re-encodes every shard's code plane in place.

After recode, distributed GROUP BY/ORDER BY on the string column are plain
int32 SPMD ops (parallel/spmd.py) and the global dictionary decodes the
results on the way out.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from query_engine_tpu.columnar.dictionary import Dictionary, merge_many
from query_engine_tpu.parallel import spmd


def merge_shard_dictionaries(
    dicts: Sequence[Dictionary],
) -> Tuple[Dictionary, np.ndarray]:
    """Sorted global union of per-shard dictionaries.

    Returns (global_dict, remap_planes[n_shards, pad]) where
    remap_planes[s, old_code] is shard s's new global code. Rows of the
    plane are padded with 0 (dead codes never gathered by live rows)."""
    merged, remaps = merge_many(list(dicts))
    pad = max([len(r) for r in remaps] + [1])
    planes = np.zeros((len(remaps), pad), dtype=np.int32)
    for s, r in enumerate(remaps):
        planes[s, : len(r)] = r
    return merged, planes


def make_recode(mesh: Mesh, axis: str = "data"):
    """SPMD program: codes[n*cap], remap_planes[n, pad] -> global codes.

    One gather per shard; codes stay int32 device planes throughout."""

    def step(codes, remap):
        # remap arrives as this shard's [1, pad] slice
        r = remap[0]
        return r[jnp.clip(codes, 0, r.shape[0] - 1)]

    return jax.jit(
        spmd.shard_map(
            step, mesh=mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=P(axis),
        )
    )


def ingest_sharded_strings(
    mesh: Mesh,
    per_shard_values: List[List[str]],
    cap: int,
    axis: str = "data",
) -> Tuple[jnp.ndarray, jnp.ndarray, np.ndarray, Dictionary]:
    """Multi-host string ingest end-to-end: each shard encodes its own
    values locally (per-host dictionary), then the global merge + recode
    runs. Returns (codes[n*cap] globally coded, validity, rows_per_shard,
    global_dict)."""
    n = mesh.devices.size
    assert len(per_shard_values) == n
    local_dicts, local_codes, valid = [], [], []
    rows = np.zeros(n, dtype=np.int64)
    for s, vals in enumerate(per_shard_values):
        d, codes = Dictionary.from_values(vals)
        local_dicts.append(d)
        rows[s] = len(vals)
        c = np.zeros(cap, np.int32)
        c[: len(vals)] = codes
        v = np.zeros(cap, bool)
        v[: len(vals)] = [x is not None for x in vals]
        local_codes.append(c)
        valid.append(v)
    gdict, planes = merge_shard_dictionaries(local_dicts)
    recode = make_recode(mesh, axis)
    codes = recode(
        jnp.asarray(np.concatenate(local_codes)), jnp.asarray(planes)
    )
    return codes, jnp.asarray(np.concatenate(valid)), rows, gdict
