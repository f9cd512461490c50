"""query_engine_tpu — a vectorized SQL query engine on JAX/XLA.

Brand-new JAX/XLA/Pallas implementation with the capabilities of the Rust
reference engine AarambhDevHub/query-engine (see SURVEY.md). Not a port: the
compute path is columnar device arrays with validity masks, jitted operator
pipelines compiled by XLA, and jax.sharding/shard_map collectives for the
distributed shuffle.

Layer map (mirrors the reference's crate DAG, SURVEY.md §1):
  core/       types, schema, errors, UDF registry, flight config
  columnar/   ColumnBatch: fixed-width device arrays + validity planes + dicts
  sql/        lexer, AST, recursive-descent parser
  plan/       logical plan, planner, optimizer, physical plan
  ops/        operator kernels (filter/project/join/aggregate/sort/window)
  engine/     physical executor + session
  cache/      LRU result cache with TTL + stats + invalidation
  storage/    CSV / Parquet / in-memory data sources
  index/      B-Tree and Hash indexes + manager
  streaming/  stream sources, windows, watermarks
  flight/     Arrow Flight server/client data plane
  parallel/   mesh, partitioner, distributed planner, exchange, fault manager
  pgwire/     PostgreSQL wire-protocol server
  cli/        `qe` command-line interface and REPL
"""

import os as _os

import jax as _jax

# The reference engine computes in Arrow Int64/Float64 (reference
# query-executor/src/operators.rs:745-848 sums Int64 in Int64, AVG in f64).
# Bit-exact parity therefore requires 64-bit lanes; hot kernels downcast
# explicitly where it is safe.
_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache, shared by every process of a checkout. JAX
# reads JAX_COMPILATION_CACHE_DIR itself; only when it is unset does the
# cache go to <checkout>/.jax_cache (gitignored). The path is part of the
# cache key, so it stays fixed.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.1.0"

from query_engine_tpu.core.errors import QueryError  # noqa: E402
from query_engine_tpu.core.types import DataType  # noqa: E402
from query_engine_tpu.core.schema import Field, Schema  # noqa: E402

__all__ = ["QueryError", "DataType", "Field", "Schema", "__version__"]
