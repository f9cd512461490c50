"""Device set-up: compile-cache placement, the device peak table, the
QE_MESH_DEVICES check, and the main path without pyarrow."""

import os
import subprocess
import sys
import types

import pytest

from query_engine_tpu.core.errors import ExecutionError
from query_engine_tpu.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Prints the cache directory, then whether compiling a fresh program added
# an entry to it.
_CACHE_PROBE = """
import os, sys, time
import query_engine_tpu, jax, jax.numpy as jnp
d = jax.config.jax_compilation_cache_dir
print(d)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
before = set(os.listdir(d)) if os.path.isdir(d) else set()
salt = time.time_ns() % 1000003
jax.jit(lambda x: jnp.sin(x) * salt + jnp.cos(x * salt))(jnp.arange(7.0)).block_until_ready()
print(bool(set(os.listdir(d)) - before))
"""


def _run_probe(env):
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.split()


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(kw)
    return env


def test_compile_cache_follows_the_environment(tmp_path):
    d = str(tmp_path / "cache")
    where, added = _run_probe(_env(JAX_COMPILATION_CACHE_DIR=d))
    assert where == d
    assert added == "True"


def test_compile_cache_defaults_to_the_checkout():
    where, added = _run_probe(_env())
    assert where == os.path.join(REPO, ".jax_cache")
    assert added == "True"


def _fake_device(platform, kind):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


def test_peak_table_rejects_an_unknown_accelerator():
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.device_peaks(_fake_device("gpu", "NVIDIA Imaginary 1"))


def test_peak_table_h100_and_cpu():
    peaks = profiling.device_peaks(_fake_device("gpu", "NVIDIA H100 80GB HBM3"))
    assert peaks["hbm_bytes_per_sec"] == 3.35e12
    assert "data sheet" in peaks["source"]
    assert profiling.device_peaks(_fake_device("cpu", "cpu")) is None


def test_device_record_names_the_device():
    rec = profiling.device_record()
    assert rec["platform"] == "cpu" and rec["count"] >= 1
    assert "card" not in rec  # nvidia-smi is asked only on a GPU


def test_profiler_omits_the_roofline_share_on_cpu():
    p = profiling.Profiler()
    with p.op("scan", rows=10, bytes_=80):
        pass
    assert "hbm_roofline_frac" not in p.snapshot()["scan"]
    assert p.report().splitlines()[1].split()[-1] == "-"


def test_mesh_devices_beyond_the_device_count_raise(monkeypatch):
    from query_engine_tpu.engine.session import Session

    import jax

    monkeypatch.setenv("QE_MESH_DEVICES", str(len(jax.devices()) + 1))
    with pytest.raises(ExecutionError, match="QE_MESH_DEVICES"):
        Session()


def test_bench_refuses_the_cpu_unless_asked(monkeypatch, capsys):
    import bench

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(RuntimeError, match="no accelerator"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_main_path_imports_without_pyarrow():
    """Session, the compiled path, the mesh path and pgwire need none of
    pyarrow or pandas; CSV sources say they need pyarrow."""
    code = """
import sys
for m in ("pyarrow", "pandas"):
    sys.modules[m] = None
from query_engine_tpu.engine.session import Session
import query_engine_tpu.pgwire.server, query_engine_tpu.parallel.mesh_pipeline
s = Session()
s.register_table("t", {"k": [1, 2, 1], "v": [10, 20, 30]})
print(s.sql("SELECT k, SUM(v) FROM t GROUP BY k ORDER BY k").to_pylist())
try:
    s.register_csv("e", "data/employees.csv")
except ImportError as e:
    print("csv:", e)
"""
    out = subprocess.run(
        [sys.executable, "-c", code], env=_env(), cwd=REPO,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.splitlines()
    assert out[0] == "[(1, 40), (2, 20)]"
    assert out[1].startswith("csv:") and "pyarrow" in out[1]
