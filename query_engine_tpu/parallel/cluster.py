"""Multi-host cluster bootstrap.

Replaces the reference's coordinator/worker TCP registration
(coordinator.rs:45-107, worker.rs) for real pods: `jax.distributed.initialize`
is the membership/coordination service, every host runs the same SPMD
program, and host 0 is the single controller driving stage launches
(SURVEY.md §7 design stance).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import jax

from query_engine_tpu.core.errors import DistributedError


@dataclass
class HostInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_controller(self) -> bool:
        return self.process_index == 0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> HostInfo:
    """Join the pod. On single-host setups this is a no-op that reports the
    local topology; on multi-host, args (or the standard JAX env vars /
    cluster metadata) select the coordination service."""
    multi = (
        coordinator_address is not None
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
        or os.environ.get("COORDINATOR_ADDRESS")
    )
    if multi:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        except Exception as e:  # noqa: BLE001
            raise DistributedError(f"jax.distributed.initialize failed: {e}")
    return HostInfo(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_device_count=jax.local_device_count(),
        global_device_count=jax.device_count(),
    )


def global_mesh(axis: str = "data"):
    """A mesh over every device of every process in the cluster."""
    from query_engine_tpu.parallel.mesh import make_mesh

    return make_mesh(jax.devices(), axis)


def shutdown() -> None:
    try:
        jax.distributed.shutdown()
    except Exception:  # noqa: BLE001 single-host: nothing to shut down
        pass
