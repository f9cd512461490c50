"""Distributed execution walkthrough with real data movement.

The reference's examples/distributed_query.rs is an API tour where no
data moves (its coordinator returns Ok(vec![]), coordinator.rs:134-155;
its worker's execute_plan_fragment is a TODO, worker.rs:132-137). Here
every phase executes: cluster bring-up, stage planning with exchange
points, partitioned execution with real shuffles, fault handling with
retry + stage checkpoints, and the SPMD skew-aware salted join.

Run: JAX_PLATFORMS=cpu python examples/distributed_query.py
"""

import numpy as np

from _common import show
from query_engine_tpu.columnar.batch import ColumnBatch
from query_engine_tpu.parallel.coordinator import Coordinator
from query_engine_tpu.parallel.dexecutor import DistributedExecutor
from query_engine_tpu.parallel.dplanner import DistributedPlanner
from query_engine_tpu.parallel.fault import FaultConfig, FaultManager
from query_engine_tpu.parallel.partition import Partitioner, PartitionStrategy
from query_engine_tpu.parallel.scheduler import TaskScheduler
from query_engine_tpu.parallel.types import QueryTask
from query_engine_tpu.plan.planner import Planner
from query_engine_tpu.sql.parser import parse_sql
from query_engine_tpu.storage.memory import MemoryDataSource

rng = np.random.default_rng(0)
N = 50_000
batch = ColumnBatch.from_pydict({
    "k": rng.integers(0, 8, N).tolist(),
    "v": rng.integers(0, 1000, N).tolist(),
})

# ---- 1) cluster bring-up + health ------------------------------------
coord = Coordinator()
workers = [coord.register_worker(f"host{i}:50051") for i in range(4)]
coord.heartbeat(workers[0])
status = coord.cluster_status()
print(f"cluster: {status.active_workers}/{status.total_workers} active, "
      f"utilization {status.utilization:.0%}")

# ---- 2) distributed plan: stages + exchange points -------------------
planner = Planner()
planner.register_table("t", batch.schema)
plan = planner.create_logical_plan(parse_sql(
    "SELECT k, COUNT(*) AS n, SUM(v) AS total FROM t GROUP BY k"))
dplanner = DistributedPlanner(default_partitions=4)
dplan = dplanner.plan(plan)
for st in dplan.stages:
    print(f"stage {st.stage_id}: {st.kind} partitions={st.num_partitions} "
          f"shuffle={st.requires_shuffle} deps={st.dependencies}")

# ---- 3) hash partitioning: the shuffle math itself -------------------
parts = Partitioner(PartitionStrategy.HASH, 4, key_columns=["k"]).partition(batch)
sizes = [p.num_rows for p in parts]
print(f"hash partitions: {sizes} (conserves {sum(sizes)} == {N} rows)")

# ---- 4) full distributed execution with real movement ----------------
result = coord.execute(plan, {"t": MemoryDataSource(batch=batch, name="t")})
show("distributed partial+final aggregate over 4 workers", result)

# ---- 5) fault handling: retry, thresholds, checkpoints ---------------
fm = FaultManager(FaultConfig(max_task_retries=2, retry_delay_secs=0.0))
task = QueryTask.new(query_id="q1", stage_id=0, partition=0)
print("first failure  ->", fm.handle_task_failure(task.task_id, "io error")[0])
print("second failure ->", fm.handle_task_failure(task.task_id, "io error")[0])
print("third failure  ->", fm.handle_task_failure(task.task_id, "io error")[0])
fm.checkpoint_stage("q1", stage_id=0, intermediate=[batch.slice(0, 100)])
fm.checkpoint_stage("q1", stage_id=1, intermediate=[batch.slice(100, 100)])
rp = fm.recover_from_checkpoint("q1")
cp = fm.get_checkpoint("q1")
print(f"recovery plan: resume from stage {rp.resume_from_stage} "
      f"(completed {cp.completed_stages})")
restored = fm.load_checkpoint_data("q1", 1)
print(f"checkpoint restored stage 1: {restored[0].num_rows} rows")

# ---- 6) scheduler: FIFO + least-loaded placement ---------------------
sched = TaskScheduler()
for p in range(4):
    sched.submit(QueryTask.new(query_id="q2", stage_id=0, partition=p))
infos = coord.active_workers()
first = sched.get_next_task()
chosen = sched.choose_worker(infos)
print(f"scheduler: {sched.pending_count} pending after one grab; "
      f"task {first.partition} -> {chosen.address}")

# ---- 7) SPMD skew-aware salted join (the collective shuffle) ---------
import os
if os.environ.get("JAX_PLATFORMS", "") == "cpu":
    import jax
    if len(jax.devices()) >= 8:
        import jax.numpy as jnp
        from jax.sharding import Mesh
        from query_engine_tpu.parallel import spmd

        mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
        per = 1 << 12
        rows = per * 8
        # 60% of probe rows hit ONE hot key — the melt-one-shard case
        hot = rng.random(rows) < 0.6
        lkey = np.where(hot, 3, rng.integers(0, 64, rows)).astype(np.int64)
        rkey = np.arange(64, dtype=np.int64)
        rcap = 64 * 8
        for salt in (1, 4):
            prog = spmd.make_distributed_join_counts(mesh, 1, 1, salt=salt)
            out = prog(
                jnp.asarray(lkey), jnp.ones(rows, bool),
                np.full(8, per, np.int64),
                jnp.asarray(np.tile(rkey, 8)), jnp.ones(rcap, bool),
                np.full(8, 64, np.int64),
                jnp.asarray(lkey), jnp.ones(rows, bool),
                jnp.asarray(np.tile(rkey, 8)), jnp.ones(rcap, bool),
            )
            lcount = np.asarray(out[1]).reshape(-1)
            print(f"salt={salt}: probe rows per shard "
                  f"max/mean = {lcount.max()}/{lcount.mean():.0f} "
                  f"(imbalance {lcount.max() / lcount.mean():.2f}x)")
    else:
        print("(run with XLA_FLAGS=--xla_force_host_platform_device_count=8 "
              "for the SPMD salted-join demo)")
else:
    print("(set JAX_PLATFORMS=cpu for the SPMD salted-join demo)")
