"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators per SURVEY.md §4:
JAX CPU backend + xla_force_host_platform_device_count=8. A run whose mark
expression selects only on-card tests (`-m gpu`, `-m "gpu and not slow"`)
keeps the default backend, so those tests reach the GPU; elsewhere they
skip.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
from _pytest.mark.expression import Expression  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def selects_only_gpu(markexpr: str) -> bool:
    """True when `markexpr` selects a test marked `gpu` and no unmarked
    test."""
    if not markexpr:
        return False
    expr = Expression.compile(markexpr)
    return (expr.evaluate(lambda name, **kw: name == "gpu")
            and not expr.evaluate(lambda name, **kw: False))


def pytest_configure(config):
    if not selects_only_gpu(config.getoption("markexpr")):
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
