"""chip_smoke.py's phases rehearsed on the CPU backend at a tiny size, and
its refusal to run anywhere but on a GPU."""

import os

import jax
import pytest

import chip_smoke as C

N_LI = 1 << 11


@pytest.fixture(scope="module")
def loaded():
    s, raw = C.phase_load(N_LI)
    return s, raw, C.phase_queries(s, "cpu rehearsal")


def test_main_refuses_a_non_gpu_device(capsys):
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="not a GPU"):
        C.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_tests_phase_collects_every_gpu_module():
    files = [os.path.basename(f) for f in C.gpu_test_files()]
    assert "test_grouped_sums.py" in files
    assert "test_chip_smoke.py" not in files


@pytest.mark.parametrize("markexpr,only_gpu", [
    ("gpu", True),
    ("gpu and not slow", True),
    ("", False),
    ("not slow", False),
    ("not gpu", False),
    ("gpu or not slow", False),
])
def test_conftest_keeps_the_gpu_only_for_gpu_runs(markexpr, only_gpu):
    from conftest import selects_only_gpu

    assert selects_only_gpu(markexpr) == only_gpu


def test_queries_phase_runs_all_22(loaded, capsys):
    _, _, results = loaded
    assert sorted(results) == sorted(C.tpch_mini.QUERIES)
    assert all(isinstance(r, list) for r in results.values())


def test_oracle_phase_matches_numpy(loaded):
    s, raw, results = loaded
    assert results["Q1"] and results["Q3"] and results["Q6"][0][0] is not None
    C.phase_oracle(raw, results)


def test_oracle_catches_a_wrong_sum(loaded):
    _, raw, results = loaded
    bad = dict(results)
    row = list(bad["Q6"][0])
    row[0] *= 1 + 1e-6
    bad["Q6"] = [tuple(row)]
    with pytest.raises(RuntimeError, match="Q6 differs"):
        C.phase_oracle(raw, bad)


def test_parity_phase_on_the_cpu_backend():
    C.phase_parity(1 << 10)


def test_pgwire_phase_matches_session(loaded):
    s, _, results = loaded
    C.phase_pgwire(s, results)


def test_mesh_phase_on_four_virtual_devices(loaded):
    s, _, _ = loaded
    C.phase_mesh(s, 4, "cpu rehearsal")


@pytest.mark.parametrize("got,want,ok", [
    ([(1, "a", 2.0)], [(1, "a", 2.0 * (1 + 5e-10))], True),
    ([(1, "a", 2.0)], [(1, "a", 2.0 * (1 + 5e-9))], False),
    ([(1, "a", None)], [(1, "a", None)], True),
    ([(1, "a", None)], [(1, "a", 0.0)], False),
    ([(2, "a", 2.0)], [(1, "a", 2.0)], False),
    ([(1, "b", 2.0)], [(1, "a", 2.0)], False),
    ([(1, "a", 2.0)], [], False),
])
def test_rows_mismatch_tolerances(got, want, ok):
    assert (C.rows_mismatch(got, want) is None) == ok
