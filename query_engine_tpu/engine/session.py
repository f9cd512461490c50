"""Session: the user-facing engine entry point.

Ties the whole pipeline together: Parse -> Plan -> Optimize -> Lower ->
Execute — the same chain as the reference's only complete path
(pgwire backend.rs:159-218 execute_query_sync), but for *every* entry point
(REPL, CLI, pgwire, Flight), not just pgwire.

Also owns the session-level statement handlers the reference implements in
its pgwire backend: CREATE TABLE (backend.rs:1041-1089), INSERT with
ON CONFLICT upsert (:1092-1479), UPDATE (:1505-1596), DELETE (:1599-1904),
CREATE/DROP INDEX (repl.rs:365-462), and recursive CTEs via fixed-point
iteration re-registering the CTE as a temp table, max 1000 iterations
(backend.rs:221-369).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from query_engine_tpu.core.errors import (
    ExecutionError, PlanError, SchemaError,
)
from query_engine_tpu.core.schema import Field, Schema
from query_engine_tpu.core.udf import UdfRegistry
from query_engine_tpu.columnar.batch import ColumnBatch
from query_engine_tpu.engine.executor import QueryExecutor
from query_engine_tpu.plan import logical as lp
from query_engine_tpu.plan.lowering import Lowering
from query_engine_tpu.plan.optimizer import Optimizer
from query_engine_tpu.plan.planner import Planner
from query_engine_tpu.sql import ast
from query_engine_tpu.sql.parser import parse_sql
from query_engine_tpu.storage.memory import MemoryDataSource

MAX_RECURSION_ITERS = 1000  # parity: backend.rs recursive CTE cap


class Session:
    def __init__(self, enable_cache: bool = False, mesh=None):
        """mesh: optional jax.sharding.Mesh — queries then execute SPMD over
        the mesh as ONE shard_map program per query (distributed compiled
        pipelines, parallel/mesh_pipeline.py); plans without a distributed
        lowering fall back to the single-device engine transparently."""
        self.udfs = UdfRegistry()
        self.planner = Planner(self.udfs)
        self.optimizer = Optimizer()
        self.executor = QueryExecutor(self.udfs)
        self.mesh_pipeline = None
        if mesh is None:
            # QE_MESH_DEVICES=N turns every entry point (REPL, CLI,
            # pgwire, Flight) into a mesh session without code changes
            import os

            n = int(os.environ.get("QE_MESH_DEVICES", "0"))
            if n > 1:
                import jax

                from query_engine_tpu.parallel.mesh import make_mesh

                devs = jax.devices()
                if len(devs) < n:
                    raise ExecutionError(
                        f"QE_MESH_DEVICES={n} but only {len(devs)} "
                        f"{devs[0].platform} device(s) exist"
                    )
                mesh = make_mesh(devs[:n])
        if mesh is not None:
            from query_engine_tpu.parallel.mesh_pipeline import MeshPipeline

            self.mesh_pipeline = MeshPipeline(self.executor, mesh)
        self.sources: Dict[str, object] = {}
        # parse/plan/execute breakdown of the last statement (REPL .timing;
        # reference doc example CLI_REFERENCE.md:290-292)
        from query_engine_tpu.utils.profiling import QueryTiming

        self.last_timing = QueryTiming()
        self._cache = None
        if enable_cache:
            from query_engine_tpu.cache.cache import QueryCache
            from query_engine_tpu.cache.config import CacheConfig

            self._cache = QueryCache(CacheConfig())
        # transaction state: snapshot taken at BEGIN (None = autocommit),
        # savepoint stack, and PG's aborted-until-ROLLBACK flag. The
        # reference accepts BEGIN/COMMIT/ROLLBACK but ignores them
        # (backend.rs:807-832); here they are real.
        self._txn = None
        self._txn_failed = False
        self._savepoints: List[tuple] = []

    # ---- registration --------------------------------------------------
    def register_csv(self, name: str, path: str, schema: Optional[Schema] = None):
        from query_engine_tpu.storage.csv import CsvDataSource  # needs pyarrow

        src = CsvDataSource(path, schema)
        self.sources[name.lower()] = src
        self.planner.register_table(name, src.schema())
        return src

    def register_parquet(self, name: str, path: str):
        from query_engine_tpu.storage.parquet import ParquetDataSource  # needs pyarrow

        src = ParquetDataSource(path)
        self.sources[name.lower()] = src
        self.planner.register_table(name, src.schema())
        return src

    def register_table(self, name: str, data) -> MemoryDataSource:
        """Register an in-memory table from a ColumnBatch or dict of lists."""
        if isinstance(data, dict):
            data = ColumnBatch.from_pydict(data)
        src = MemoryDataSource(batch=data, name=name.lower())
        self.sources[name.lower()] = src
        self.planner.register_table(name, data.schema)
        return src

    def register_source(self, name: str, source) -> None:
        self.sources[name.lower()] = source
        self.planner.register_table(name, source.schema())

    def deregister_table(self, name: str) -> None:
        self.sources.pop(name.lower(), None)
        self.planner.deregister_table(name)

    def tables(self) -> List[str]:
        return sorted(self.sources)

    def views(self) -> List[str]:
        return sorted(self.planner.views)

    def table_schema(self, name: str) -> Schema:
        key = name.lower()
        if key not in self.sources and key in self.planner.views:
            return self.planner.views[key].schema()
        return self.sources[key].schema()

    # ---- SQL entry -----------------------------------------------------
    def sql(self, query: str, params: Optional[list] = None) -> ColumnBatch:
        import time as _time

        from query_engine_tpu.utils.profiling import QueryTiming

        lead = query.lstrip().upper()
        if lead.startswith("EXPLAIN"):
            return self._exec_explain(query)

        self.last_timing = QueryTiming()
        t0 = _time.perf_counter()
        stmt = parse_sql(query)
        self.last_timing.parse_ms = (_time.perf_counter() - t0) * 1e3
        if params:
            stmt = _bind_params(stmt, params)
            # cache key must distinguish parameter values
            key = query + "\x00" + repr(params)
            return self.execute_statement(stmt, sql_text=key)
        return self.execute_statement(stmt, sql_text=query)

    def sql_script(self, script: str) -> List[ColumnBatch]:
        """Execute a semicolon-separated script; returns one result per
        statement."""
        from query_engine_tpu.sql.parser import parse_many

        return [self.execute_statement(s) for s in parse_many(script)]

    def _exec_explain(self, query: str) -> ColumnBatch:
        """EXPLAIN [ANALYZE] <stmt> -> one text column "QUERY PLAN", like
        PostgreSQL. ANALYZE executes with the per-operator profiler on and
        appends rows/timing/per-op counters (the observability surface the
        reference only has as .timing in its REPL, repl.rs:303,347)."""
        rest = query.lstrip()[len("EXPLAIN"):].lstrip()
        analyze = rest.upper().startswith("ANALYZE")
        if analyze:
            rest = rest[len("ANALYZE"):].lstrip()
        if not rest:
            raise PlanError("EXPLAIN requires a statement")
        lines = self.explain(rest).splitlines()
        if analyze:
            from query_engine_tpu.utils.profiling import GLOBAL_PROFILER

            prev = GLOBAL_PROFILER.enabled
            GLOBAL_PROFILER.reset()
            GLOBAL_PROFILER.enabled = True
            try:
                result = self.sql(rest)
            finally:
                GLOBAL_PROFILER.enabled = prev
            lines += [
                "",
                f"rows: {result.num_rows}",
                f"timing: {self.last_timing}",
            ]
            if self.mesh_pipeline is not None:
                st = self.mesh_pipeline.stats
                lines.append(
                    f"mesh: devices={self.mesh_pipeline.n} "
                    f"compiles={st['compiles']} hits={st['hits']} "
                    f"fallbacks={st['fallbacks']} "
                    f"exchanges={st['exchanges']} "
                    f"overflow_retries={st['overflow_retries']}"
                )
            lines.append("")
            lines += GLOBAL_PROFILER.report().splitlines()
        return ColumnBatch.from_pydict({"QUERY PLAN": lines})

    def explain(self, query: str) -> str:
        stmt = parse_sql(query)
        if isinstance(stmt, (ast.Select, ast.WithSelect)):
            plan = self._plan_query(stmt)
            return plan.pretty()
        return f"-- {type(stmt).__name__}"

    def execute_statement(self, stmt: ast.Statement, sql_text: str = "") -> ColumnBatch:
        if isinstance(stmt, ast.Transaction):
            return self._exec_transaction(stmt)
        if self._txn_failed:
            raise ExecutionError(
                "current transaction is aborted, commands ignored until "
                "end of transaction block")
        if self._txn is None:
            return self._execute_statement_inner(stmt, sql_text)
        try:
            return self._execute_statement_inner(stmt, sql_text)
        except Exception:
            # PG semantics: any error inside an explicit transaction aborts
            # it; only ROLLBACK [TO SAVEPOINT] / COMMIT are accepted after.
            self._txn_failed = True
            raise

    # ---- transactions ----------------------------------------------------
    # Snapshot-based: BEGIN captures the registries plus every memory
    # table's (immutable) batch reference; DML replaces batches rather
    # than mutating them, so a snapshot is O(tables), not O(rows), and
    # ROLLBACK is a pointer swap + index rebuild for tables that changed.
    def in_transaction(self) -> bool:
        return self._txn is not None

    def transaction_failed(self) -> bool:
        return self._txn_failed

    def begin(self) -> None:
        if self._txn is not None:
            return  # PG: WARNING + no-op on nested BEGIN
        self._txn = self._snapshot()
        self._txn_failed = False
        self._savepoints = []

    def commit(self) -> str:
        """Returns the PG command tag: COMMIT, or ROLLBACK if the
        transaction had failed (PG commits an aborted txn as a rollback)."""
        if self._txn is None:
            return "COMMIT"
        failed = self._txn_failed
        if failed:
            self._restore(self._txn)
        self._txn = None
        self._txn_failed = False
        self._savepoints = []
        return "ROLLBACK" if failed else "COMMIT"

    def rollback(self) -> None:
        if self._txn is None:
            return  # PG: WARNING + no-op outside a transaction
        self._restore(self._txn)
        self._txn = None
        self._txn_failed = False
        self._savepoints = []

    def savepoint(self, name: str) -> None:
        if self._txn is None:
            raise ExecutionError("SAVEPOINT can only be used in transaction blocks")
        self._savepoints.append((name.lower(), self._snapshot()))

    def rollback_to(self, name: str) -> None:
        if self._txn is None:
            raise ExecutionError("ROLLBACK TO can only be used in transaction blocks")
        i = self._find_savepoint(name)
        sp_name, snap = self._savepoints[i]
        self._restore(snap)
        # PG keeps the savepoint itself alive after ROLLBACK TO
        del self._savepoints[i + 1:]
        self._txn_failed = False

    def release(self, name: str) -> None:
        if self._txn is None:
            raise ExecutionError("RELEASE can only be used in transaction blocks")
        i = self._find_savepoint(name)
        del self._savepoints[i:]

    def _find_savepoint(self, name: str) -> int:
        key = name.lower()
        for i in range(len(self._savepoints) - 1, -1, -1):
            if self._savepoints[i][0] == key:
                return i
        raise ExecutionError(f"savepoint \"{name}\" does not exist")

    def _exec_transaction(self, stmt: ast.Transaction) -> ColumnBatch:
        if self._txn_failed and stmt.kind not in (
                "commit", "rollback", "rollback_to"):
            raise ExecutionError(
                "current transaction is aborted, commands ignored until "
                "end of transaction block")
        if stmt.kind == "begin":
            self.begin()
            return _status_batch("BEGIN")
        if stmt.kind == "commit":
            return _status_batch(self.commit())
        if stmt.kind == "rollback":
            self.rollback()
            return _status_batch("ROLLBACK")
        if stmt.kind == "rollback_to":
            self.rollback_to(stmt.name)
            return _status_batch("ROLLBACK")
        if stmt.kind == "savepoint":
            self.savepoint(stmt.name)
            return _status_batch("SAVEPOINT")
        if stmt.kind == "release":
            self.release(stmt.name)
            return _status_batch("RELEASE")
        raise ExecutionError(f"unknown transaction statement {stmt.kind!r}")

    def _snapshot(self) -> dict:
        mem = {}
        for name, src in self.sources.items():
            if isinstance(src, MemoryDataSource):
                mem[name] = (
                    src, src._batch, dict(src.serials), src.name,
                    dict(src.indexes._meta),
                )
        return {
            "sources": dict(self.sources),
            "tables": dict(self.planner.tables),
            "views": dict(self.planner.views),
            "mem": mem,
        }

    def _restore(self, snap: dict) -> None:
        self.sources = dict(snap["sources"])
        self.planner.tables = dict(snap["tables"])
        self.planner.views = dict(snap["views"])
        for _key, (src, batch, serials, name, idx_meta) in snap["mem"].items():
            changed = src._batch is not batch
            src._batch = batch
            src.serials = dict(serials)
            src.name = name
            for idx in list(src.indexes._indexes):
                if idx not in idx_meta:
                    src.indexes.drop_index(idx)  # created inside the txn
            for idx, meta in idx_meta.items():
                if not src.indexes.has_index(idx):  # dropped inside the txn
                    src.create_index(idx, meta.columns, meta.index_type,
                                     meta.unique)
            if changed:
                src.rebuild_indexes()
        self._invalidate_cache()

    def _execute_statement_inner(self, stmt: ast.Statement, sql_text: str = "") -> ColumnBatch:
        if isinstance(stmt, (ast.Select, ast.WithSelect)):
            if self._cache is not None and sql_text:
                hit = self._cache.get_sql(sql_text)
                if hit is not None:
                    return hit
            result = self._execute_query(stmt)
            if self._cache is not None and sql_text:
                self._cache.put_sql(sql_text, result)
            return result
        if isinstance(stmt, ast.CreateTable):
            return self._exec_create_table(stmt)
        if isinstance(stmt, ast.CreateTableAs):
            return self._exec_create_table_as(stmt)
        if isinstance(stmt, ast.CreateView):
            return self._exec_create_view(stmt)
        if isinstance(stmt, ast.DropView):
            return self._exec_drop_view(stmt)
        if isinstance(stmt, ast.DropTable):
            return self._exec_drop_table(stmt)
        if isinstance(stmt, ast.Truncate):
            src = self._require_memory_table(stmt.name)
            src.replace(ColumnBatch.empty(src.schema()))
            self._invalidate_cache()
            return _status_batch("TRUNCATE TABLE")
        if isinstance(stmt, ast.AlterTable):
            return self._exec_alter_table(stmt)
        if isinstance(stmt, ast.Insert):
            return self._exec_insert(stmt)
        if isinstance(stmt, ast.Update):
            return self._exec_update(stmt)
        if isinstance(stmt, ast.Delete):
            return self._exec_delete(stmt)
        if isinstance(stmt, ast.CreateIndex):
            return self._exec_create_index(stmt)
        if isinstance(stmt, ast.DropIndex):
            return self._exec_drop_index(stmt)
        raise ExecutionError(f"unsupported statement {type(stmt).__name__}")

    # ---- query path ----------------------------------------------------
    def _plan_query(self, stmt) -> lp.LogicalPlan:
        if isinstance(stmt, ast.WithSelect) and any(
            stmt.recursive and Planner._references_table(c.query, c.name)
            for c in stmt.ctes
        ):
            raise PlanError("recursive CTE must go through _execute_query")
        plan = self.planner.create_logical_plan(stmt)
        return self.optimizer.optimize(plan)

    def _execute_query(self, stmt) -> ColumnBatch:
        if isinstance(stmt, ast.WithSelect) and stmt.recursive:
            rec = [
                c for c in stmt.ctes
                if Planner._references_table(c.query, c.name)
            ]
            if rec:
                return self._execute_recursive_cte(stmt, rec)
        import time as _time

        t0 = _time.perf_counter()
        plan = self._plan_query(stmt)
        from query_engine_tpu.plan.lowering import shared_subquery_ids

        pplan = Lowering(
            self.sources, shared_cte_ids=shared_subquery_ids(plan)
        ).lower(plan)
        t1 = _time.perf_counter()
        self.last_timing.plan_ms += (t1 - t0) * 1e3
        self.executor._cte_memo.clear()
        self.executor.evaluator._corr_match_memo.clear()
        try:
            out = None
            if self.mesh_pipeline is not None:
                out = self.mesh_pipeline.try_execute(pplan)
            if out is None:
                out = self.executor.execute(pplan)
        finally:
            self.executor._cte_memo.clear()
            self.executor.evaluator._corr_match_memo.clear()
        self.last_timing.execute_ms += (_time.perf_counter() - t1) * 1e3
        return out

    def _execute_recursive_cte(self, stmt: ast.WithSelect, rec) -> ColumnBatch:
        """Fixed-point recursive CTE evaluation (backend.rs:221-369):
        iterate `base UNION [ALL] step`, re-registering the accumulated
        result as a temp table each round, until no new rows (or 1000
        iterations)."""
        if len(stmt.ctes) != 1:
            raise PlanError("recursive WITH supports exactly one CTE")
        cte = stmt.ctes[0]
        sel = cte.query
        if sel.union_clause is None:
            raise PlanError("recursive CTE requires base UNION step shape")
        base_sel = _strip_union(sel)
        step_sel = sel.union_clause.select
        dedup = sel.union_clause.set_op is ast.SetOperation.UNION

        tmp_name = cte.name.lower()
        had_prev = tmp_name in self.sources
        if had_prev:
            raise PlanError(
                f"recursive CTE name '{cte.name}' shadows an existing table"
            )
        try:
            acc = self._execute_query(ast.Select(base_sel))
            if cte.columns:
                acc = _rename_batch(acc, list(cte.columns))
            frontier = acc
            for _ in range(MAX_RECURSION_ITERS):
                if frontier.num_rows == 0:
                    break
                self.register_table(tmp_name, frontier)
                try:
                    new_rows = self._execute_query(ast.Select(step_sel))
                finally:
                    self.deregister_table(tmp_name)
                if cte.columns:
                    new_rows = _rename_batch(new_rows, list(cte.columns))
                if dedup:
                    seen = set(acc.to_pylist())
                    fresh = [r for r in new_rows.to_pylist() if r not in seen]
                    if not fresh:
                        break
                    cols = {
                        f.name: [r[i] for r in fresh]
                        for i, f in enumerate(acc.schema)
                    }
                    new_rows = ColumnBatch.from_pydict(cols, acc.schema)
                elif new_rows.num_rows == 0:
                    break
                acc = ColumnBatch.concat([acc, new_rows])
                frontier = new_rows
            # run the outer select against the final CTE result
            self.register_table(tmp_name, acc)
            try:
                return self._execute_query(ast.Select(stmt.select))
            finally:
                self.deregister_table(tmp_name)
        finally:
            if tmp_name in self.sources:
                self.deregister_table(tmp_name)

    # ---- DDL / DML -----------------------------------------------------
    def _exec_create_table(self, stmt: ast.CreateTable) -> ColumnBatch:
        name = stmt.name.lower()
        if name in self.sources:
            if stmt.if_not_exists:
                return _status_batch("CREATE TABLE")
            raise ExecutionError(f"table '{stmt.name}' already exists")
        schema = Schema(
            [Field(c.name, c.data_type, c.nullable) for c in stmt.columns]
        )
        src = MemoryDataSource(schema=schema, name=name)
        src.serials = {c.name: 1 for c in stmt.columns if c.serial}
        self.sources[name] = src
        self.planner.register_table(name, schema)
        self._invalidate_cache()
        return _status_batch("CREATE TABLE")

    def _exec_alter_table(self, stmt: ast.AlterTable) -> ColumnBatch:
        """ALTER TABLE: ADD COLUMN (all-NULL fill), DROP COLUMN (dependent
        indexes dropped), RENAME COLUMN, RENAME TO."""
        from query_engine_tpu.columnar.batch import Column
        from query_engine_tpu.columnar.dictionary import Dictionary

        src = self._require_memory_table(stmt.table)
        batch = src.scan()
        schema = batch.schema
        table_key = stmt.table.lower()
        if stmt.action == "add":
            cd = stmt.column
            if schema.try_index_of(cd.name) is not None:
                raise ExecutionError(f"column '{cd.name}' already exists")
            if not cd.nullable and batch.num_rows:
                raise ExecutionError(
                    "ADD COLUMN NOT NULL on a non-empty table needs a "
                    "default (unsupported)"
                )
            dt = cd.data_type
            col = Column(
                np.zeros(batch.capacity, dtype=dt.device_dtype),
                np.zeros(batch.capacity, dtype=bool),
                dt,
                Dictionary.empty() if dt.is_dictionary else None,
            )
            src.replace(ColumnBatch(
                Schema(list(schema.fields) + [Field(cd.name, dt, True)]),
                list(batch.columns) + [col], batch.num_rows,
            ))
        elif stmt.action == "drop":
            i = schema.index_of(stmt.name)
            if len(schema.fields) == 1:
                raise ExecutionError("cannot drop the only column")
            for idx in list(src.indexes.table_indexes(src.name)):
                if stmt.name in src.indexes.metadata(idx).columns:
                    src.indexes.drop_index(idx)
            src.replace(ColumnBatch(
                Schema([f for j, f in enumerate(schema) if j != i]),
                [c for j, c in enumerate(batch.columns) if j != i],
                batch.num_rows,
            ))
        elif stmt.action == "rename_column":
            i = schema.index_of(stmt.name)
            if schema.try_index_of(stmt.new_name) is not None:
                raise ExecutionError(
                    f"column '{stmt.new_name}' already exists"
                )
            fields = list(schema.fields)
            f = fields[i]
            fields[i] = Field(stmt.new_name, f.data_type, f.nullable)
            src.replace(ColumnBatch(
                Schema(fields), list(batch.columns), batch.num_rows
            ))
        elif stmt.action == "rename_table":
            new = stmt.name.lower()
            if new in self.sources or new in self.planner.views:
                raise ExecutionError(f"'{stmt.name}' already exists")
            del self.sources[table_key]
            self.planner.deregister_table(table_key)
            src.name = new
            self.sources[new] = src
            table_key = new
        else:
            raise ExecutionError(f"unknown ALTER action {stmt.action}")
        self.planner.register_table(table_key, src.schema())
        self._invalidate_cache()
        return _status_batch("ALTER TABLE")

    def _exec_create_table_as(self, stmt: ast.CreateTableAs) -> ColumnBatch:
        """CREATE TABLE t AS select — materialize the result as a new
        memory table (unqualified column names, PG CTAS)."""
        name = stmt.name.lower()
        if name in self.sources or name in self.planner.views:
            if stmt.if_not_exists:
                return _status_batch("CREATE TABLE AS")
            raise ExecutionError(f"'{stmt.name}' already exists")
        result = self._execute_query(stmt.query)
        schema = Schema([
            Field(f.name.rsplit(".", 1)[-1], f.data_type, f.nullable)
            for f in result.schema
        ])
        batch = ColumnBatch(schema, result.columns, result.num_rows)
        src = MemoryDataSource(schema=schema, name=name)
        src.append(batch)
        self.sources[name] = src
        self.planner.register_table(name, schema)
        self._invalidate_cache()
        return _status_batch(f"SELECT {result.num_rows}")

    def _exec_create_view(self, stmt: ast.CreateView) -> ColumnBatch:
        """CREATE [OR REPLACE] VIEW v [(cols)] AS select — bound at
        creation (PG semantics): the body plans NOW against the current
        schemas and every later reference shares the plan object, so a
        view used twice in one query materializes once (shared-CTE
        machinery)."""
        name = stmt.name.lower()
        if name in self.sources:
            raise ExecutionError(f"'{stmt.name}' is a table")
        if name in self.planner.views and not stmt.or_replace:
            raise ExecutionError(f"view '{stmt.name}' already exists")
        plan = self.optimizer.optimize(
            self.planner.create_logical_plan(stmt.query)
        )
        if stmt.columns:
            sch = plan.schema()
            if len(stmt.columns) != len(sch):
                raise ExecutionError(
                    f"view '{stmt.name}' column list has {len(stmt.columns)} "
                    f"names for {len(sch)} columns"
                )
            plan = lp.Projection(plan, [
                lp.AliasExpr(
                    lp.ColumnRef(i, f.name, f.data_type, f.nullable), c
                )
                for i, (f, c) in enumerate(zip(plan.schema(), stmt.columns))
            ])
        self.planner.register_view(name, plan)
        self._invalidate_cache()
        return _status_batch("CREATE VIEW")

    def _exec_drop_view(self, stmt: ast.DropView) -> ColumnBatch:
        name = stmt.name.lower()
        if name not in self.planner.views:
            if stmt.if_exists:
                return _status_batch("DROP VIEW")
            raise ExecutionError(f"view '{stmt.name}' does not exist")
        self.planner.deregister_view(name)
        self._invalidate_cache()
        return _status_batch("DROP VIEW")

    def _exec_drop_table(self, stmt: ast.DropTable) -> ColumnBatch:
        name = stmt.name.lower()
        if name not in self.sources:
            if stmt.if_exists:
                return _status_batch("DROP TABLE")
            raise ExecutionError(f"table '{stmt.name}' does not exist")
        del self.sources[name]
        self.planner.deregister_table(name)
        self._invalidate_cache()
        return _status_batch("DROP TABLE")

    def _require_memory_table(self, name: str) -> MemoryDataSource:
        src = self.sources.get(name.lower())
        if src is None:
            raise ExecutionError(f"table '{name}' not found")
        if not isinstance(src, MemoryDataSource):
            # snapshot file-backed tables into memory for DML
            mem = MemoryDataSource(batch=src.scan(), name=name.lower())
            self.sources[name.lower()] = mem
            return mem
        return src

    def _exec_insert(self, stmt: ast.Insert) -> ColumnBatch:
        src = self._require_memory_table(stmt.table)
        schema = src.schema()
        col_names = stmt.columns or [f.name for f in schema]
        for c in col_names:
            schema.index_of(c)  # validate

        rows: Dict[str, list] = {f.name: [] for f in schema}
        if stmt.query is not None:
            # INSERT INTO t [(cols)] SELECT ... — run the query through the
            # ordinary engine and align its columns positionally
            result = self._execute_query(stmt.query)
            if len(result.schema) != len(col_names):
                raise ExecutionError(
                    f"INSERT SELECT returns {len(result.schema)} columns "
                    f"for {len(col_names)} target columns"
                )
            for out_row in result.to_pylist():
                given = dict(zip(col_names, out_row))
                for f in schema:
                    rows[f.name].append(given.get(f.name))
        for vrow in stmt.values:
            if len(vrow) != len(col_names):
                raise ExecutionError(
                    f"INSERT row has {len(vrow)} values for {len(col_names)} columns"
                )
            given = dict(zip(col_names, [_literal_value(e) for e in vrow]))
            for f in schema:
                rows[f.name].append(given.get(f.name))
        for col, nxt in getattr(src, "serials", {}).items():
            vals = rows.get(col, [])
            for i, v in enumerate(vals):
                if v is None:
                    vals[i] = nxt
                    nxt += 1
                else:
                    nxt = max(nxt, int(v) + 1)
            src.serials[col] = nxt
        batch = ColumnBatch.from_pydict(rows, schema)

        inserted = batch
        if stmt.on_conflict is not None:
            inserted = self._apply_on_conflict(src, batch, stmt.on_conflict)
        else:
            src.append(batch)
        self._invalidate_cache()
        if stmt.returning is not None:
            return self._returning(inserted, schema, stmt.returning)
        return _status_batch(f"INSERT 0 {inserted.num_rows}")

    def _apply_on_conflict(
        self, src: MemoryDataSource, batch: ColumnBatch,
        clause: ast.OnConflictClause,
    ) -> ColumnBatch:
        """UPSERT semantics (backend.rs:1092-1479): match on the conflict
        columns; DO NOTHING skips, DO UPDATE SET rewrites matched rows."""
        existing = src.scan()
        key_cols = list(clause.columns)
        exist_keys = {
            tuple(r): i
            for i, r in enumerate(
                zip(*[existing.column(c).to_pylist(existing.num_rows)
                      for c in key_cols])
            )
        }
        new_rows = batch.to_pylist()
        names = existing.schema.names()
        batch_key_idx = [batch.schema.index_of(c) for c in key_cols]
        fresh, conflicts = [], []
        for r in new_rows:
            k = tuple(r[i] for i in batch_key_idx)
            if k in exist_keys:
                conflicts.append((exist_keys[k], r))
            else:
                fresh.append(r)
        out_rows: List[tuple] = []
        if conflicts and isinstance(clause.action, ast.DoUpdate):
            data = existing.to_pydict()
            for row_i, new_r in conflicts:
                for a in clause.action.assignments:
                    data[a.column][row_i] = _literal_value(a.value)
                out_rows.append(tuple(data[n][row_i] for n in names))
            src.replace(ColumnBatch.from_pydict(data, existing.schema))
        if fresh:
            cols = {
                f.name: [r[i] for r in fresh]
                for i, f in enumerate(batch.schema)
            }
            fresh_batch = ColumnBatch.from_pydict(cols, batch.schema)
            src.append(fresh_batch)
            out_rows.extend(fresh)
        if not out_rows:
            return ColumnBatch.empty(batch.schema)
        cols = {
            f.name: [r[i] for r in out_rows]
            for i, f in enumerate(batch.schema)
        }
        return ColumnBatch.from_pydict(cols, batch.schema)

    def _dml_from_rows(self, table: str, from_ref, selection, value_exprs):
        """FROM/USING join for multi-table DML: run `SELECT __rid, values
        FROM target-with-rowids AS <table>, <from_ref> [WHERE ...]` through
        the ordinary engine and keep the FIRST match per target row (PG:
        which match wins is unspecified when several join)."""
        src = self._require_memory_table(table)
        batch = src.scan()
        from query_engine_tpu.core.types import DataType
        from query_engine_tpu.columnar.batch import Column

        aug_schema = Schema(
            [Field("__rid", DataType.int64(), False)]
            + list(batch.schema.fields)
        )
        rid_col = Column(
            np.arange(batch.capacity, dtype=np.int64),
            np.ones(batch.capacity, dtype=bool), DataType.int64(), None,
        )
        tmp = "__dml_target"
        self.sources[tmp] = MemoryDataSource(
            batch=ColumnBatch(
                aug_schema, [rid_col] + list(batch.columns), batch.num_rows
            ),
            name=tmp,
        )
        self.planner.register_table(tmp, aug_schema)
        try:
            sel = ast.SelectStatement()
            sel.projection = [ast.ExprItem(ast.Column("__rid"), "__rid")] + [
                ast.ExprItem(e, f"__v{i}")
                for i, e in enumerate(value_exprs)
            ]
            sel.from_ = ast.TableName(tmp, table)
            sel.joins = [ast.Join(ast.JoinType.CROSS, from_ref)]
            sel.selection = selection
            out = self._execute_query(ast.Select(sel))
        finally:
            del self.sources[tmp]
            self.planner.deregister_table(tmp)
        first: Dict[int, tuple] = {}
        for r in out.to_pylist():
            if r[0] not in first:
                first[r[0]] = r[1:]
        return src, batch, first

    def _exec_update(self, stmt: ast.Update) -> ColumnBatch:
        if stmt.from_table is not None:
            return self._exec_update_from(stmt)
        src = self._require_memory_table(stmt.table)
        batch = src.scan()
        mask = self._dml_mask(stmt.table, stmt.selection, batch)
        data = batch.to_pydict()
        touched = []
        # evaluate assignment expressions row-wise over the full batch
        assign_vals = {}
        for a in stmt.assignments:
            assign_vals[a.column] = self._eval_assignment(
                stmt.table, a.value, batch
            )
        for i in range(batch.num_rows):
            if mask[i]:
                touched.append(i)
                for col, vals in assign_vals.items():
                    data[col][i] = vals[i]
        src.replace(ColumnBatch.from_pydict(data, batch.schema))
        self._invalidate_cache()
        if stmt.returning is not None:
            upd = src.scan().take_host(np.asarray(touched, dtype=np.int64))
            return self._returning(upd, batch.schema, stmt.returning)
        return _status_batch(f"UPDATE {len(touched)}")

    def _exec_update_from(self, stmt: ast.Update) -> ColumnBatch:
        src, batch, first = self._dml_from_rows(
            stmt.table, stmt.from_table, stmt.selection,
            [a.value for a in stmt.assignments],
        )
        cols = [a.column for a in stmt.assignments]
        for c in cols:
            batch.schema.index_of(c)  # validate target columns
        data = batch.to_pydict()
        for rid, vals in first.items():
            for c, v in zip(cols, vals):
                data[c][rid] = v
        src.replace(ColumnBatch.from_pydict(data, batch.schema))
        self._invalidate_cache()
        touched = sorted(first)
        if stmt.returning is not None:
            upd = src.scan().take_host(np.asarray(touched, dtype=np.int64))
            return self._returning(upd, batch.schema, stmt.returning)
        return _status_batch(f"UPDATE {len(touched)}")

    def _exec_delete_using(self, stmt: ast.Delete) -> ColumnBatch:
        src, batch, first = self._dml_from_rows(
            stmt.table, stmt.using, stmt.selection, []
        )
        matched = set(first)
        keep = [i for i in range(batch.num_rows) if i not in matched]
        deleted_batch = batch.take_host(
            np.asarray(sorted(matched), dtype=np.int64)
        )
        src.replace(batch.take_host(np.asarray(keep, dtype=np.int64)))
        self._invalidate_cache()
        if stmt.returning is not None:
            return self._returning(
                deleted_batch, batch.schema, stmt.returning
            )
        return _status_batch(f"DELETE {len(matched)}")

    def _exec_delete(self, stmt: ast.Delete) -> ColumnBatch:
        if stmt.using is not None:
            return self._exec_delete_using(stmt)
        src = self._require_memory_table(stmt.table)
        batch = src.scan()
        mask = self._dml_mask(stmt.table, stmt.selection, batch)
        keep = [i for i in range(batch.num_rows) if not mask[i]]
        deleted = [i for i in range(batch.num_rows) if mask[i]]
        deleted_batch = batch.take_host(np.asarray(deleted, dtype=np.int64))
        src.replace(batch.take_host(np.asarray(keep, dtype=np.int64)))
        self._invalidate_cache()
        if stmt.returning is not None:
            return self._returning(deleted_batch, batch.schema, stmt.returning)
        return _status_batch(f"DELETE {len(deleted)}")

    def _dml_mask(self, table: str, selection, batch: ColumnBatch):
        if selection is None:
            return [True] * batch.num_rows
        from query_engine_tpu.plan.planner import Resolver, prefix_schema

        scope = Resolver(prefix_schema(batch.schema, table))
        pred = self.planner.plan_expr(selection, scope, {})
        mask = self.executor.evaluator.eval_predicate_mask(pred, batch)
        return np.asarray(mask)[: batch.num_rows].tolist()

    def _eval_assignment(self, table: str, expr, batch: ColumnBatch):
        from query_engine_tpu.plan.planner import Resolver, prefix_schema

        scope = Resolver(prefix_schema(batch.schema, table))
        le = self.planner.plan_expr(expr, scope, {})
        v = self.executor.evaluator.eval(le, batch)
        if v.dictionary is not None:
            decoded = v.dictionary.decode(np.asarray(v.data)[: batch.num_rows])
            valid = np.asarray(v.validity)[: batch.num_rows]
            return [d if ok else None for d, ok in zip(decoded, valid)]
        host = np.asarray(v.data)[: batch.num_rows]
        valid = np.asarray(v.validity)[: batch.num_rows]
        return [h.item() if ok else None for h, ok in zip(host, valid)]

    def _returning(self, rows: ColumnBatch, schema: Schema, items) -> ColumnBatch:
        names = [f.name for f in schema]
        out_cols: Dict[str, list] = {}
        for item in items:
            if isinstance(item, ast.WildcardItem):
                d = rows.to_pydict()
                for n in names:
                    out_cols[n] = d[n]
            elif isinstance(item, ast.ExprItem) and isinstance(item.expr, ast.Column):
                out_cols[item.alias or item.expr.name] = rows.column(
                    item.expr.name
                ).to_pylist(rows.num_rows)
            else:
                raise ExecutionError("RETURNING supports columns and *")
        return ColumnBatch.from_pydict(out_cols)

    # ---- indexes -------------------------------------------------------
    def _exec_create_index(self, stmt: ast.CreateIndex) -> ColumnBatch:
        src = self._require_memory_table(stmt.table)
        src.create_index(
            stmt.name, stmt.columns,
            "hash" if stmt.index_type is ast.IndexType.HASH else "btree",
            stmt.unique,
        )
        return _status_batch("CREATE INDEX")

    def _exec_drop_index(self, stmt: ast.DropIndex) -> ColumnBatch:
        for src in self.sources.values():
            if isinstance(src, MemoryDataSource) and src.indexes.has_index(stmt.name):
                src.drop_index(stmt.name)
                return _status_batch("DROP INDEX")
        if stmt.if_exists:
            return _status_batch("DROP INDEX")
        raise ExecutionError(f"index '{stmt.name}' not found")

    def _invalidate_cache(self):
        if self._cache is not None:
            self._cache.clear()


def _strip_union(sel: ast.SelectStatement) -> ast.SelectStatement:
    import copy

    base = copy.copy(sel)
    base.union_clause = None
    return base


def _rename_batch(batch: ColumnBatch, names: List[str]) -> ColumnBatch:
    if len(names) != len(batch.schema):
        raise SchemaError("CTE column list arity mismatch")
    return batch.rename(names)


def _literal_value(e: ast.Expr):
    if isinstance(e, ast.NumberLit):
        return float(e.value) if any(c in e.value for c in ".eE") else int(e.value)
    if isinstance(e, ast.StringLit):
        return e.value
    if isinstance(e, ast.BoolLit):
        return e.value
    if isinstance(e, ast.NullLit):
        return None
    if isinstance(e, ast.UnaryOp) and e.op is ast.UnaryOperator.MINUS:
        v = _literal_value(e.expr)
        return -v
    raise ExecutionError("INSERT values must be literals")


def _status_batch(tag: str) -> ColumnBatch:
    b = ColumnBatch.from_pydict({"status": [tag]})
    return b


def _bind_params(stmt: ast.Statement, params: list) -> ast.Statement:
    """Substitute $n parameters with literal AST nodes (extended protocol,
    reference extended.rs:141-230 does SQL-text substitution; we do it on
    the AST, which is safer)."""
    import dataclasses

    def sub(obj):
        if isinstance(obj, ast.Param):
            v = params[obj.index - 1]
            if v is None:
                return ast.NullLit()
            if isinstance(v, bool):
                return ast.BoolLit(v)
            if isinstance(v, (int, float)):
                return ast.NumberLit(repr(v))
            return ast.StringLit(str(v))
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            changes = {}
            for f in dataclasses.fields(obj):
                val = getattr(obj, f.name)
                new = sub_value(val)
                if new is not val:
                    changes[f.name] = new
            if changes:
                try:
                    return dataclasses.replace(obj, **changes)
                except TypeError:
                    for k, v in changes.items():
                        object.__setattr__(obj, k, v)
                    return obj
        return obj

    def sub_value(val):
        if isinstance(val, (list, tuple)):
            newv = [sub_value(x) for x in val]
            if isinstance(val, tuple):
                newv = tuple(newv)
            return newv
        if dataclasses.is_dataclass(val) and not isinstance(val, type):
            return sub(val)
        return val

    return sub(stmt)
