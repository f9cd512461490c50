"""Grouped SUM/COUNT (K.segment_aggregate), the packed gather, and the
engine's GROUP BY against numpy. The tests marked `gpu` run the same
kernels at 2^24 rows on the card and skip elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import query_engine_tpu  # noqa: F401
from query_engine_tpu.ops import kernels as K


def _grouped(func, vals, ok, gid, num_groups):
    """segment_aggregate over all rows live, with `ok` as validity."""
    out, valid = K.segment_aggregate(
        func, jnp.asarray(vals), jnp.asarray(ok), jnp.asarray(gid),
        len(gid), num_groups,
    )
    return np.asarray(out), np.asarray(valid)


def _np_sums_counts(vals, ok, gid, num_groups):
    sums = np.zeros(num_groups, vals.dtype)
    np.add.at(sums, gid[ok], vals[ok])
    return sums, np.bincount(gid[ok], minlength=num_groups)


@pytest.mark.parametrize("n,G", [(100, 7), (5000, 37), (2048, 1024)])
def test_grouped_sum_count_exact(n, G):
    rng = np.random.default_rng(n)
    vals = rng.integers(-(1 << 40), 1 << 40, n)
    gid = rng.integers(0, G, n).astype(np.int32)
    ok = rng.random(n) > 0.15
    sums, has = _grouped("sum", vals, ok, gid, G)
    counts, _ = _grouped("count", vals, ok, gid, G)
    ref_s, ref_c = _np_sums_counts(vals, ok, gid, G)
    assert np.array_equal(sums, ref_s)
    assert np.array_equal(counts, ref_c)
    assert np.array_equal(has, ref_c > 0)


def test_grouped_sum_empty_groups():
    vals = np.asarray([5, 10])
    gid = np.asarray([3, 3], np.int32)
    ok = np.ones(2, bool)
    sums, has = _grouped("sum", vals, ok, gid, 8)
    counts, _ = _grouped("count", vals, ok, gid, 8)
    assert sums[3] == 15 and counts[3] == 2
    assert counts.sum() == 2
    assert has.tolist() == [False, False, False, True] + [False] * 4


def test_grouped_sum_many_groups():
    rng = np.random.default_rng(11)
    n, G = 4000, 6000
    vals = rng.integers(-(1 << 30), 1 << 30, n)
    gid = rng.integers(0, G, n).astype(np.int32)
    ok = rng.random(n) > 0.1
    sums, _ = _grouped("sum", vals, ok, gid, G)
    counts, _ = _grouped("count", vals, ok, gid, G)
    ref_s, ref_c = _np_sums_counts(vals, ok, gid, G)
    assert np.array_equal(sums, ref_s)
    assert np.array_equal(counts, ref_c)


def test_grouped_sum_f64_accuracy():
    rng = np.random.default_rng(7)
    n, G = 3000, 41
    vals = rng.normal(0.0, 1e7, n)
    gid = rng.integers(0, G, n).astype(np.int32)
    ok = rng.random(n) > 0.2
    sums, _ = _grouped("sum", vals, ok, gid, G)
    counts, _ = _grouped("count", vals, ok, gid, G)
    ref_s, ref_c = _np_sums_counts(vals, ok, gid, G)
    assert np.array_equal(counts, ref_c)
    # summation order differs from numpy's: f64 round-off only
    np.testing.assert_allclose(sums, ref_s, rtol=1e-9, atol=1e-3)


def test_grouped_sum_f64_ieee_semantics():
    vals = np.asarray([1.0, np.inf, 2.0, -np.inf, np.inf, -np.inf, np.nan, 5.0])
    gid = np.asarray([0, 0, 1, 1, 2, 2, 3, 4], np.int32)
    ok = np.ones(8, bool)
    s, _ = _grouped("sum", vals, ok, gid, 5)
    counts, _ = _grouped("count", vals, ok, gid, 5)
    assert s[0] == np.inf           # finite + inf
    assert s[1] == -np.inf          # finite + -inf
    assert np.isnan(s[2])           # inf + -inf
    assert np.isnan(s[3])           # nan
    assert s[4] == 5.0
    assert counts.tolist() == [2, 2, 2, 1, 1]


def test_engine_float_sum_avg_vs_numpy():
    from query_engine_tpu.engine.session import Session

    rng = np.random.default_rng(9)
    k = rng.integers(0, 8, 400)
    x = rng.normal(0, 1000, 400)
    s = Session()
    s.register_table("t", {"k": k.tolist(), "x": x.tolist()})
    rows = s.sql(
        "SELECT k, SUM(x), AVG(x), COUNT(x) FROM t GROUP BY k ORDER BY k"
    ).to_pylist()
    assert [r[0] for r in rows] == sorted(set(k.tolist()))
    for key, total, mean, cnt in rows:
        sel = x[k == key]
        assert cnt == len(sel)
        np.testing.assert_allclose(total, sel.sum(), rtol=1e-9)
        np.testing.assert_allclose(mean, sel.mean(), rtol=1e-9)


def test_engine_int_aggregates_vs_numpy():
    from query_engine_tpu.engine.session import Session

    rng = np.random.default_rng(4)
    k = rng.integers(0, 9, 300)
    v = rng.integers(-100, 100, 300)
    s = Session()
    s.register_table("t", {"k": k.tolist(), "v": v.tolist()})
    rows = s.sql(
        "SELECT k, COUNT(*), SUM(v), AVG(v) FROM t GROUP BY k ORDER BY k"
    ).to_pylist()
    want = [
        (int(key), int((k == key).sum()), int(v[k == key].sum()),
         float(v[k == key].mean()))
        for key in np.unique(k)
    ]
    assert [r[:3] for r in rows] == [w[:3] for w in want]
    for r, w in zip(rows, want):
        np.testing.assert_allclose(r[3], w[3], rtol=1e-12)


def test_gather_columns_packed_vs_numpy():
    """Packed words of bounded columns plus a wide one, gathered by index,
    with -1 rows masked out by row_valid."""
    rng = np.random.default_rng(3)
    T, n = 300, 4000
    a = rng.integers(0, 50, T)
    b = rng.integers(-(1 << 40), 1 << 40, T)
    flag = rng.random(T) > 0.5
    valid = [rng.random(T) > 0.1 for _ in range(3)]
    idx = rng.integers(-1, T, n)
    matched = idx >= 0
    safe = np.where(matched, idx, 0)
    out_d, out_v = K.gather_columns_packed(
        [jnp.asarray(a), jnp.asarray(b), jnp.asarray(flag)],
        [jnp.asarray(v) for v in valid],
        [(0, 50), None, None],
        jnp.asarray(safe.astype(np.int32)), jnp.asarray(matched),
    )
    for col, d, v, ok in zip((a, b, flag), out_d, out_v, valid):
        want_v = ok[safe] & matched
        assert np.array_equal(np.asarray(v), want_v)
        assert np.array_equal(np.asarray(d)[want_v], col[safe][want_v])


def test_engine_fk_join_gather_vs_numpy():
    """FK join through the engine: every fact row picks its dimension
    row's column."""
    from query_engine_tpu.engine.session import Session

    rng = np.random.default_rng(5)
    fk = rng.integers(0, 50, 500)
    v = rng.integers(0, 100, 500)
    w = rng.integers(0, 9, 50)
    s = Session()
    s.register_table("f", {"k": fk.tolist(), "v": v.tolist()})
    s.register_table("d", {"id": list(range(50)), "w": w.tolist()})
    rows = s.sql(
        "SELECT f.k, f.v, d.w FROM f JOIN d ON f.k = d.id "
        "ORDER BY f.k, f.v, d.w"
    ).to_pylist()
    assert rows == sorted(zip(fk.tolist(), v.tolist(), w[fk].tolist()))


# ---- on the card --------------------------------------------------------

@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the first JAX device is {dev.platform}")
    return dev


@pytest.mark.gpu
def test_gpu_grouped_sum_count_2p24(gpu):
    """SUM(int64) + COUNT over 1,024 groups at 2^24 rows, exact."""
    rng = np.random.default_rng(24)
    n, G = 1 << 24, 1024
    vals = rng.integers(-(1 << 40), 1 << 40, n)
    gid = rng.integers(0, G, n).astype(np.int32)
    ok = rng.random(n) > 0.1
    sums, _ = _grouped("sum", vals, ok, gid, G)
    counts, _ = _grouped("count", vals, ok, gid, G)
    ref_s, ref_c = _np_sums_counts(vals, ok, gid, G)
    assert np.array_equal(sums, ref_s)
    assert np.array_equal(counts, ref_c)


@pytest.mark.gpu
def test_gpu_grouped_sum_f64_2p24(gpu):
    """SUM(f64) over 1,024 groups at 2^24 rows; atomics sum in a varying
    order, so f64 round-off only."""
    rng = np.random.default_rng(25)
    n, G = 1 << 24, 1024
    vals = rng.uniform(900.0, 105000.0, n)
    gid = rng.integers(0, G, n).astype(np.int32)
    ok = rng.random(n) > 0.1
    sums, _ = _grouped("sum", vals, ok, gid, G)
    ref = np.bincount(gid[ok], weights=vals[ok], minlength=G)
    np.testing.assert_allclose(sums, ref, rtol=1e-9)
