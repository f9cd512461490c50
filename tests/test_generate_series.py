"""GENERATE_SERIES table function: int64 arithmetic series as a device
iota — the cheapest possible device relation (no reference analog; PG
set-returning function subset: constant integer arguments)."""

import pytest

from query_engine_tpu.core.errors import PlanError
from query_engine_tpu.engine.session import Session


@pytest.fixture(scope="module")
def sess():
    return Session()


def test_basic(sess):
    assert sess.sql("SELECT * FROM GENERATE_SERIES(1, 5)").to_pylist() == [
        (1,), (2,), (3,), (4,), (5,)
    ]


def test_step_and_alias(sess):
    out = sess.sql(
        "SELECT i FROM GENERATE_SERIES(0, 10, 5) AS g(i)"
    ).to_pylist()
    assert out == [(0,), (5,), (10,)]


def test_negative_step(sess):
    out = sess.sql("SELECT * FROM GENERATE_SERIES(5, 1, -2)").to_pylist()
    assert out == [(5,), (3,), (1,)]


def test_empty_when_step_points_away(sess):
    assert sess.sql("SELECT * FROM GENERATE_SERIES(3, 1)").to_pylist() == []
    assert sess.sql(
        "SELECT * FROM GENERATE_SERIES(1, 3, -1)"
    ).to_pylist() == []


def test_negative_bounds(sess):
    out = sess.sql("SELECT * FROM GENERATE_SERIES(-2, 1)").to_pylist()
    assert out == [(-2,), (-1,), (0,), (1,)]


def test_aggregate_over_series(sess):
    assert sess.sql(
        "SELECT SUM(i), COUNT(*) FROM GENERATE_SERIES(1, 100) g(i)"
    ).to_pylist() == [(5050, 100)]


def test_join_and_group(sess):
    out = sess.sql(
        "SELECT i % 3 AS m, COUNT(*) AS c FROM GENERATE_SERIES(1, 999) g(i) "
        "GROUP BY i % 3 ORDER BY m"
    ).to_pylist()
    assert out == [(0, 333), (1, 333), (2, 333)]


def test_series_in_subquery(sess):
    s = Session()
    s.register_table("x", {"a": [2, 4, 5]})
    out = s.sql(
        "SELECT a FROM x WHERE a IN "
        "(SELECT i FROM GENERATE_SERIES(0, 10, 4) g(i)) ORDER BY a"
    ).to_pylist()
    assert out == [(4,)]


def test_zero_step_rejected(sess):
    with pytest.raises(PlanError):
        sess.sql("SELECT * FROM GENERATE_SERIES(1, 5, 0)")


def test_non_constant_rejected(sess):
    s = Session()
    s.register_table("x", {"a": [1]})
    with pytest.raises(PlanError):
        s.sql("SELECT * FROM x, GENERATE_SERIES(1, a)")


# ---- temporal series ------------------------------------------------------

import datetime  # noqa: E402


def test_date_series_day_step(sess):
    out = sess.sql(
        "SELECT * FROM GENERATE_SERIES(DATE '2024-01-29', "
        "DATE '2024-02-03', INTERVAL '2 days')"
    ).to_pylist()
    assert out == [(datetime.date(2024, 1, 29),),
                   (datetime.date(2024, 1, 31),),
                   (datetime.date(2024, 2, 2),)]


def test_month_step_clamps_to_month_end(sess):
    # PG: Jan 31 + 1 mon = Feb 29 (leap), then Mar 31 — clamped, not Mar 2
    out = sess.sql(
        "SELECT * FROM GENERATE_SERIES(DATE '2024-01-31', "
        "DATE '2024-04-30', INTERVAL '1 month')"
    ).to_pylist()
    assert out == [(datetime.date(2024, 1, 31),),
                   (datetime.date(2024, 2, 29),),
                   (datetime.date(2024, 3, 31),),
                   (datetime.date(2024, 4, 30),)]


def test_timestamp_series(sess):
    out = sess.sql(
        "SELECT * FROM GENERATE_SERIES(TIMESTAMP '2024-01-01 00:00:00', "
        "TIMESTAMP '2024-01-01 03:00:00', INTERVAL '90 minutes')"
    ).to_pylist()
    assert out == [(datetime.datetime(2024, 1, 1, 0, 0),),
                   (datetime.datetime(2024, 1, 1, 1, 30),),
                   (datetime.datetime(2024, 1, 1, 3, 0),)]


def test_negative_month_step(sess):
    out = sess.sql(
        "SELECT * FROM GENERATE_SERIES(DATE '2024-03-01', "
        "DATE '2024-01-01', INTERVAL '-1 month')"
    ).to_pylist()
    assert [r[0].month for r in out] == [3, 2, 1]


def test_date_series_joins_and_groups(sess):
    out = sess.sql(
        "SELECT EXTRACT(month FROM d) AS m, COUNT(*) AS c "
        "FROM GENERATE_SERIES(DATE '2024-01-01', DATE '2024-03-31', "
        "INTERVAL '1 day') g(d) GROUP BY EXTRACT(month FROM d) ORDER BY m"
    ).to_pylist()
    assert out == [(1, 31), (2, 29), (3, 31)]


def test_subday_step_over_dates_rejected(sess):
    with pytest.raises(PlanError):
        sess.sql(
            "SELECT * FROM GENERATE_SERIES(DATE '2024-01-01', "
            "DATE '2024-01-02', INTERVAL '1 hour')"
        )


def test_temporal_requires_interval_step(sess):
    with pytest.raises(PlanError):
        sess.sql(
            "SELECT * FROM GENERATE_SERIES(DATE '2024-01-01', "
            "DATE '2024-01-05')"
        )
