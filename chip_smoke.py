"""Smoke run of the SQL engine on NVIDIA GPUs, through the entry points a
user calls.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --devices 4   # four GPUs: the mesh path only

One GPU, in one process:

  device   the first JAX device must be a GPU; print its kind, the card's
           name and power limit (nvidia-smi), the JAX version and the
           compile-cache directory
  load     build the TPC-H tables (benchmarks/tpch_mini.py) at 2^24
           lineitem rows (about SF 2.8 by row count) and register them in a
           Session
  queries  all 22 queries through Session.sql: cold compile-and-run
           seconds, one warm time ended by the result fetch, row count and
           the compiled pipeline's counters
  oracle   Q1, Q3 and Q6 at full size against a numpy reference that
           shares no code with the engine
  parity   all 22 queries at 2^16 lineitem rows on the GPU against the same
           queries on the CPU backend, in this process
  pgwire   Q1, Q3 and Q6 over the PostgreSQL wire protocol from a PgServer
           thread serving the loaded tables; rows equal Session.sql's
  tests    the tests marked `gpu`, from every module under tests/ that uses
           the marker, run in this process

--devices 4 runs the load phase and then the 22 queries through
Session(mesh=...) over four GPUs, compared with a single-device Session on
device 0 (both timed warm, in this process); no mesh query may fall back,
and every query with a join, a subquery or a GROUP BY must exchange rows.

Counts, integers, strings and dates must match exactly. Float sums and
averages match to rtol=1e-9: scatter-add atomics and the CPU backend sum in
other orders. Any failed check raises, so the exit code is non-zero and the
last line is not printed. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import asyncio
import datetime
import json
import math
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

# The parity phase needs the CPU backend beside the GPU one.
if os.environ.get("JAX_PLATFORMS") and "cpu" not in os.environ["JAX_PLATFORMS"]:
    os.environ["JAX_PLATFORMS"] += ",cpu"

import numpy as np  # noqa: E402

import query_engine_tpu  # noqa: E402,F401  (enables x64, places the cache)
import jax  # noqa: E402

import tpch_mini  # noqa: E402
from query_engine_tpu.engine.session import Session  # noqa: E402

RTOL = 1e-9
EPOCH = datetime.date(1970, 1, 1)
PG_QUERIES = ("Q1", "Q3", "Q6")
FULL_ROWS = 1 << 24
PARITY_ROWS = 1 << 16


def log(*parts):
    print(*parts, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_info() -> str:
    """Name and power limit of every card, one per line, from nvidia-smi
    (a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---- comparison -------------------------------------------------------------

def values_match(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or abs(a - b) <= RTOL * max(abs(a), abs(b))
    return a == b


def rows_mismatch(got, want):
    """None when the row lists match, else a description of the first
    difference."""
    if len(got) != len(want):
        return f"{len(got)} rows, expected {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w) or not all(map(values_match, g, w)):
            return f"row {i}: {g!r} != {w!r}"
    return None


# ---- phases -------------------------------------------------------------

def phase_device(expect_count: int):
    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"first JAX device is {dev.platform!r}, not a GPU")
    n = len(jax.devices())
    check(n >= expect_count, f"{n} GPU(s), {expect_count} needed")
    card = card_info()
    log(f"[device] kind={dev.device_kind!r} count={n} jax={jax.__version__}")
    log(f"[device] card: {card}")
    log(f"[device] compile cache: {jax.config.jax_compilation_cache_dir}")
    return dev, card


def phase_load(n_li: int):
    t0 = time.perf_counter()
    raw = tpch_mini.generate(n_li)
    s, _ = tpch_mini.build(n_li, raw)
    secs = time.perf_counter() - t0
    n_ord = len(raw["orders"]["o_orderkey"])
    log(f"[load] lineitem={n_li} orders={n_ord} host_build_s={secs:.3f}")
    if n_li < FULL_ROWS:
        log(f"[load] cut: lineitem={n_li} is below the full {FULL_ROWS}")
    return s, raw


def peak_bytes(dev) -> int:
    stats = dev.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def run_query(s: Session, sql: str):
    t0 = time.perf_counter()
    rows = s.sql(sql).to_pylist()
    return rows, time.perf_counter() - t0


def phase_queries(s: Session, card: str):
    """Every query cold (compile + run) then warm; returns name -> rows."""
    results = {}
    stats = s.executor.pipeline.stats
    for name, sql in tpch_mini.QUERIES.items():
        before = dict(stats)
        rows, cold = run_query(s, sql)
        warm_rows, warm = run_query(s, sql)
        bad = rows_mismatch(warm_rows, rows)
        check(bad is None, f"{name}: warm rows differ from cold rows: {bad}")
        delta = {k: v - before.get(k, 0) for k, v in stats.items()
                 if v != before.get(k, 0)}
        log(f"[queries] {name} cold_s={cold:.3f} warm_ms={warm * 1e3:.3f} "
            f"rows={len(rows)} pipeline={json.dumps(delta, sort_keys=True)} "
            f"card={card!r}")
        results[name] = rows
    log(f"[queries] pipeline totals {json.dumps(stats, sort_keys=True)}")
    return results


def _days(x) -> datetime.date:
    return EPOCH + datetime.timedelta(days=int(x))


def oracle_q1(raw):
    li = raw["lineitem"]
    m = li["l_shipdate"] <= (datetime.date(1998, 9, 2) - EPOCH).days
    keys = np.char.add(np.char.add(li["l_returnflag"][m], "|"),
                       li["l_linestatus"][m])
    uniq, g = np.unique(keys, return_inverse=True)
    k = len(uniq)
    qty = li["l_quantity"][m].astype(np.int64)
    price = li["l_extendedprice"][m]
    disc = li["l_discount"][m]
    n = np.bincount(g, minlength=k)
    sum_qty = np.zeros(k, np.int64)
    np.add.at(sum_qty, g, qty)
    sum_base = np.bincount(g, weights=price, minlength=k)
    sum_disc = np.bincount(g, weights=price * (1 - disc), minlength=k)
    sum_d = np.bincount(g, weights=disc, minlength=k)
    rows = []
    for i, key in enumerate(uniq):  # np.unique sorts: ORDER BY both keys
        rf, ls = str(key).split("|")
        rows.append((rf, ls, int(sum_qty[i]), float(sum_base[i]),
                     float(sum_disc[i]), float(sum_qty[i] / n[i]),
                     float(sum_d[i] / n[i]), int(n[i])))
    return rows


def oracle_q3(raw):
    li, o, c = raw["lineitem"], raw["orders"], raw["customer"]
    cut = (datetime.date(1995, 3, 15) - EPOCH).days
    # o_orderkey and c_custkey are 0..n-1, so a key is its row index
    building = c["c_mktsegment"] == "BUILDING"
    o_ok = building[o["o_custkey"]] & (o["o_orderdate"] < cut)
    l_ok = o_ok[li["l_orderkey"]] & (li["l_shipdate"] > cut)
    rev_row = li["l_extendedprice"] * (1 - li["l_discount"])
    rev = np.bincount(li["l_orderkey"][l_ok], weights=rev_row[l_ok],
                      minlength=len(o["o_orderkey"]))
    hit = np.zeros(len(o["o_orderkey"]), bool)
    hit[li["l_orderkey"][l_ok]] = True
    keys = np.nonzero(hit)[0]
    top = keys[np.argsort(-rev[keys], kind="stable")[:10]]
    return [(int(k), float(rev[k]), _days(o["o_orderdate"][k]),
             int(o["o_shippriority"][k])) for k in top]


def oracle_q6(raw):
    li = raw["lineitem"]
    lo = (datetime.date(1994, 1, 1) - EPOCH).days
    hi = (datetime.date(1995, 1, 1) - EPOCH).days
    m = ((li["l_shipdate"] >= lo) & (li["l_shipdate"] < hi)
         & (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07)
         & (li["l_quantity"] < 24))
    return [(float(np.sum(li["l_extendedprice"][m] * li["l_discount"][m])),)]


ORACLES = {"Q1": oracle_q1, "Q3": oracle_q3, "Q6": oracle_q6}


def phase_oracle(raw, results):
    for name, fn in ORACLES.items():
        bad = rows_mismatch(results[name], fn(raw))
        check(bad is None, f"{name} differs from the numpy oracle: {bad}")
        log(f"[oracle] {name} matches numpy ({len(results[name])} rows)")


def phase_parity(n_li: int):
    gpu_s, _ = tpch_mini.build(n_li)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu_s, _ = tpch_mini.build(n_li)
        cpu_rows = {name: cpu_s.sql(sql).to_pylist()
                    for name, sql in tpch_mini.QUERIES.items()}
    for name, sql in tpch_mini.QUERIES.items():
        got = gpu_s.sql(sql).to_pylist()
        bad = rows_mismatch(got, cpu_rows[name])
        check(bad is None, f"{name} at {n_li} rows: GPU differs from CPU: {bad}")
    log(f"[parity] all {len(tpch_mini.QUERIES)} queries at lineitem={n_li} "
        f"match the CPU backend")


def _pg_text(v):
    """Session.sql's value in the form pgwire's text encoding reads back:
    floats as floats (sent as repr, so exact), the rest as text."""
    if v is None or isinstance(v, float):
        return v
    return str(v)


class _ServerThread:
    """A PgServer on an ephemeral localhost port, in a thread with its own
    event loop."""

    def __init__(self, session: Session):
        from query_engine_tpu.pgwire.server import PgServer

        self.server = PgServer(session, host="127.0.0.1", port=0)
        self.port = None
        self._loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        asyncio.set_event_loop(self._loop)
        srv = self._loop.run_until_complete(self.server.start())
        self.port = srv.sockets[0].getsockname()[1]
        self._ready.set()
        self._loop.run_forever()
        srv.close()
        self._loop.run_until_complete(srv.wait_closed())
        self._loop.close()

    def __enter__(self):
        self._thread.start()
        check(self._ready.wait(60), "pgwire server did not start")
        return self

    def __exit__(self, *exc):
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(60)
        check(not self._thread.is_alive(), "pgwire server did not stop")


def _pg_client():
    """tests/pg_client.py, loaded by path: an installed package named
    `tests` may shadow the repo's test directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "pg_client", os.path.join(REPO, "tests", "pg_client.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PgTestClient


def phase_pgwire(s: Session, results):
    PgTestClient = _pg_client()

    with _ServerThread(s) as srv:
        client = PgTestClient("127.0.0.1", srv.port)
        try:
            for name in PG_QUERIES:
                t0 = time.perf_counter()
                _, rows, _ = client.query(tpch_mini.QUERIES[name])
                secs = time.perf_counter() - t0
                want = [tuple(_pg_text(v) for v in r) for r in results[name]]
                got = [
                    tuple(float(g) if isinstance(w, float) else g
                          for g, w in zip(r, wr))
                    for r, wr in zip(rows, want)
                ] if len(rows) == len(want) else rows
                bad = rows_mismatch(got, want)
                check(bad is None, f"{name} over pgwire: {bad}")
                log(f"[pgwire] {name} rows={len(rows)} "
                    f"client_ms={secs * 1e3:.3f} match Session.sql")
        finally:
            client.close()


def gpu_test_files() -> list[str]:
    """The test modules that use the `gpu` marker. Only these are collected,
    so a module that needs a package the GPU host lacks (pyarrow, pandas)
    cannot fail the collection."""
    tests = os.path.join(REPO, "tests")
    files = []
    for name in sorted(os.listdir(tests)):
        path = os.path.join(tests, name)
        if name.startswith("test_") and name.endswith(".py"):
            with open(path, encoding="utf-8") as f:
                if "mark.gpu" in f.read():
                    files.append(path)
    return files


def phase_tests():
    import pytest

    files = gpu_test_files()
    check(files, "no test module uses the gpu marker")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", *files])
    check(rc == 0, f"gpu-marked tests failed (pytest exit code {int(rc)})")
    log(f"[tests] gpu-marked tests passed in {len(files)} module(s)")


def _needs_exchange(sql: str) -> bool:
    up = sql.upper()
    return any(w in up for w in ("JOIN", "GROUP BY", "EXISTS", "IN (SELECT"))


def phase_mesh(single: Session, n_dev: int, card: str):
    """The 22 queries through Session(mesh=...) against `single`."""
    from query_engine_tpu.parallel.mesh import make_mesh

    meshed = Session(mesh=make_mesh(jax.devices()[:n_dev]))
    for name, src in single.sources.items():
        meshed.register_source(name, src)
    stats = meshed.mesh_pipeline.stats
    for name, sql in tpch_mini.QUERIES.items():
        before = dict(stats)
        want, single_cold = run_query(single, sql)
        _, single_warm = run_query(single, sql)
        got, cold = run_query(meshed, sql)
        _, warm = run_query(meshed, sql)
        delta = {k: v - before.get(k, 0) for k, v in stats.items()
                 if v != before.get(k, 0)}
        check(stats["fallbacks"] == 0, f"{name}: mesh path fell back")
        check(not _needs_exchange(sql) or delta.get("exchanges", 0) > 0,
              f"{name}: no exchange on the mesh path")
        bad = rows_mismatch(got, want)
        check(bad is None, f"{name}: mesh differs from one device: {bad}")
        log(f"[mesh] {name} devices={n_dev} cold_s={cold:.3f} "
            f"warm_ms={warm * 1e3:.3f} single_cold_s={single_cold:.3f} "
            f"single_warm_ms={single_warm * 1e3:.3f} "
            f"rows={len(got)} mesh={json.dumps(delta, sort_keys=True)} "
            f"card={card!r}")
    log(f"[mesh] totals {json.dumps(stats, sort_keys=True)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    dev, card = phase_device(args.devices)
    s, raw = phase_load(FULL_ROWS)
    if args.devices == 1:
        results = phase_queries(s, card.splitlines()[0])
        log(f"[queries] peak_bytes_in_use={peak_bytes(dev)}")
        phase_oracle(raw, results)
        del raw
        phase_parity(PARITY_ROWS)
        phase_pgwire(s, results)
        phase_tests()
    else:
        phase_mesh(s, args.devices, card.splitlines()[0])
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": args.devices,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
