"""Tracing + per-operator performance counters.

Parity surface (SURVEY.md §5 auxiliary subsystems): the reference logs with
the `tracing` crate and ad-hoc Instant::now timing (repl.rs:303,347,
worker.rs:96-108). Here: structured per-operator wall-clock + rows/sec +
achieved-bandwidth counters against the device's published peak, the
device record every measurement carries, and jax.profiler trace capture
for Perfetto.
"""

from __future__ import annotations

import contextlib
import logging
import subprocess
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Optional

logger = logging.getLogger("query_engine_tpu")

# Published peaks by jax `device_kind`, dense rates without sparsity. A
# roofline share is stated against these.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_sec": 3.35e12,
        "bf16_flops_per_sec": 989e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM part",
    },
}
# Backends that are no accelerator and so have no roofline.
HOST_PLATFORMS = frozenset({"cpu"})


def device_peaks(device=None) -> Optional[dict]:
    """Published peaks of `device` (default: the first JAX device); None
    on the CPU backend. An accelerator missing from DEVICE_PEAKS raises:
    a roofline share against a guessed peak would mislead."""
    import jax

    device = device if device is not None else jax.devices()[0]
    if device.platform in HOST_PLATFORMS:
        return None
    try:
        return DEVICE_PEAKS[device.device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device.device_kind!r}; "
            "add them to DEVICE_PEAKS with their source"
        ) from None


def device_record(device=None) -> dict:
    """What every measurement names: platform, device_kind and device
    count as JAX reports them, and on an NVIDIA GPU the card's name and
    power limit from nvidia-smi (a child process, off JAX)."""
    import jax

    device = device if device is not None else jax.devices()[0]
    rec = {"platform": device.platform, "kind": device.device_kind,
           "count": len(jax.devices())}
    if device.platform == "gpu":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    return rec


@dataclass
class OpStats:
    calls: int = 0
    total_secs: float = 0.0   # self time: children's time is subtracted
    total_rows: int = 0
    total_bytes: int = 0

    @property
    def rows_per_sec(self) -> float:
        return self.total_rows / self.total_secs if self.total_secs else 0.0

    def bandwidth_fraction(self, peaks: Optional[dict]) -> Optional[float]:
        """Achieved memory bandwidth / the device's published peak; None
        without a peak (CPU backend) or a timing."""
        if peaks is None or not self.total_secs:
            return None
        return (self.total_bytes / self.total_secs) / peaks["hbm_bytes_per_sec"]


@dataclass
class _OpRecord:
    """Mutable handle yielded by Profiler.op — callers may set rows/bytes
    once the output size is known (data-dependent row counts)."""

    rows: int = 0
    bytes: int = 0


class Profiler:
    """Collects per-operator SELF timings (child operator time subtracted
    via an activation stack, so a recursive executor walk attributes each
    node only its own work). Wall-clock caveat: JAX dispatch is async — a
    node is charged the host time until its successor forces a sync, which
    is exactly the cost structure the engine pays per dispatch."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.ops: Dict[str, OpStats] = defaultdict(OpStats)
        self._child_secs: list = []  # per-active-frame accumulated child time

    @contextlib.contextmanager
    def op(self, name: str, rows: int = 0, bytes_: int = 0):
        if not self.enabled:
            yield _OpRecord(rows, bytes_)
            return
        rec = _OpRecord(rows, bytes_)
        self._child_secs.append(0.0)
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            dt = time.perf_counter() - t0
            child = self._child_secs.pop()
            if self._child_secs:
                self._child_secs[-1] += dt
            s = self.ops[name]
            s.calls += 1
            s.total_secs += max(dt - child, 0.0)
            s.total_rows += rec.rows
            s.total_bytes += rec.bytes

    def report(self) -> str:
        peaks = device_peaks()
        lines = ["operator             calls     total_ms       rows/s  bw_frac"]
        for name in sorted(self.ops):
            s = self.ops[name]
            frac = s.bandwidth_fraction(peaks)
            lines.append(
                f"{name:<20} {s.calls:>5} {s.total_secs * 1e3:>12.2f} "
                f"{s.rows_per_sec:>12,.0f} "
                + (f"{frac:>8.3f}" if frac is not None else f"{'-':>8}")
            )
        return "\n".join(lines)

    def snapshot(self) -> Dict[str, dict]:
        """Per-op dict for structured emission (bench JSON); the roofline
        share only where the device has a published peak."""
        peaks = device_peaks()
        out = {}
        for name, s in sorted(self.ops.items()):
            out[name] = {
                "calls": s.calls,
                "total_ms": round(s.total_secs * 1e3, 3),
                "rows_per_sec": round(s.rows_per_sec, 1),
            }
            frac = s.bandwidth_fraction(peaks)
            if frac is not None:
                out[name]["hbm_roofline_frac"] = frac
        return out

    def reset(self) -> None:
        self.ops.clear()


GLOBAL_PROFILER = Profiler(enabled=False)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace viewable in Perfetto/XProf."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclass
class QueryTiming:
    """Plan/execute/total breakdown (doc example CLI_REFERENCE.md:290-292)."""

    parse_ms: float = 0.0
    plan_ms: float = 0.0
    execute_ms: float = 0.0

    @property
    def total_ms(self) -> float:
        return self.parse_ms + self.plan_ms + self.execute_ms

    def __str__(self) -> str:
        return (
            f"Planning: {self.plan_ms:.2f} ms | "
            f"Execution: {self.execute_ms:.2f} ms | "
            f"Total: {self.total_ms:.2f} ms"
        )
