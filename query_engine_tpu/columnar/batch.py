"""ColumnBatch: the engine's columnar batch (Arrow RecordBatch analog).

Device layout (SURVEY.md §7 design stance):
  * a batch is a list of fixed-width 1-D device planes, one per column,
    all padded to the same power-of-two `capacity` (>=128) so every operator
    sees a static shape and XLA compiles each capacity bucket exactly once;
  * nulls are a separate boolean validity plane per column (Arrow null
    bitmap analog) — never sentinel values;
  * the live row count `num_rows` is a host int: rows [0, num_rows) are
    live, the pad tail is garbage that operators mask with `live_mask()`;
  * strings and other variable-width types are int32 codes into a sorted
    host-side `Dictionary` (see columnar/dictionary.py).

Parity surface: Arrow RecordBatch semantics as used throughout the reference
(e.g. query-executor/src/executor.rs operates on Vec<RecordBatch>; selection
is `filter_record_batch` executor.rs:131-155, row movement is
`arrow::compute::take` partition.rs:292-316).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from query_engine_tpu.core.errors import ExecutionError, SchemaError
from query_engine_tpu.core.schema import Field, Schema
from query_engine_tpu.core.types import DataType, TypeKind
from query_engine_tpu.columnar.dictionary import Dictionary, merge_many

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None

CAPACITY_MIN = 128


def padded_capacity(n: int) -> int:
    """Pad row counts to power-of-two buckets (>=128) to bound jit recompiles."""
    if n <= CAPACITY_MIN:
        return CAPACITY_MIN
    return 1 << (int(n - 1).bit_length())


def _pad_1d(arr: np.ndarray, capacity: int, fill=0) -> np.ndarray:
    if len(arr) == capacity:
        return arr
    if len(arr) > capacity:
        raise ExecutionError(f"array of {len(arr)} rows exceeds capacity {capacity}")
    out = np.full(capacity, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


@dataclass
class Column:
    """One column: data plane + validity plane (+ dictionary for strings)."""

    data: np.ndarray  # (capacity,) — np.ndarray or jax.Array
    validity: np.ndarray  # (capacity,) bool; True = non-null
    dtype: DataType
    dictionary: Optional[Dictionary] = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def np_data(self) -> np.ndarray:
        return np.asarray(self.data)

    def np_validity(self) -> np.ndarray:
        return np.asarray(self.validity)

    def to_pylist(self, num_rows: int) -> list:
        data = self.np_data()[:num_rows]
        valid = self.np_validity()[:num_rows]
        if self.dictionary is not None:
            vals = self.dictionary.values
            out = [
                vals[c] if v and 0 <= c < len(vals) else None
                for c, v in zip(data.tolist(), valid.tolist())
            ]
            return out
        k = self.dtype.kind
        if k is TypeKind.DATE32:
            import datetime

            epoch = datetime.date(1970, 1, 1)
            return [
                epoch + datetime.timedelta(days=int(x)) if v else None
                for x, v in zip(data.tolist(), valid.tolist())
            ]
        if k is TypeKind.TIMESTAMP or k is TypeKind.DATE64:
            import datetime

            epoch = datetime.datetime(1970, 1, 1)
            mult = 1 if k is TypeKind.TIMESTAMP else 1000
            return [
                epoch + datetime.timedelta(microseconds=int(x) * mult)
                if v else None
                for x, v in zip(data.tolist(), valid.tolist())
            ]
        if k is TypeKind.DECIMAL128 and self.dtype.params:
            scale = self.dtype.params[1]
            return [
                (int(x) / (10**scale)) if v else None
                for x, v in zip(data.tolist(), valid.tolist())
            ]
        return [x if v else None for x, v in zip(data.tolist(), valid.tolist())]

    def take_host(self, indices: np.ndarray, capacity: int) -> "Column":
        """Host-side gather (used by slicing/limit paths)."""
        d = self.np_data()[indices]
        v = self.np_validity()[indices]
        return Column(
            _pad_1d(d, capacity),
            _pad_1d(v, capacity, fill=False),
            self.dtype,
            self.dictionary,
        )


def _infer_type(values: Sequence) -> DataType:
    if isinstance(values, np.ndarray) and values.dtype != object:
        if values.dtype == np.bool_:
            return DataType.boolean()
        if np.issubdtype(values.dtype, np.integer):
            return DataType.int64()
        if np.issubdtype(values.dtype, np.floating):
            return DataType.float64()
        if values.dtype.kind in ("U", "S"):
            return DataType.utf8()
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            return DataType.boolean()
        if isinstance(v, (int, np.integer)):
            return DataType.int64()
        if isinstance(v, (float, np.floating)):
            return DataType.float64()
        if isinstance(v, str):
            return DataType.utf8()
    return DataType.utf8()


def _encode_values(values: Sequence, dtype: DataType) -> Column:
    n = len(values)
    cap = padded_capacity(n)
    if (
        isinstance(values, np.ndarray) and values.dtype != object
        and values.dtype.kind in ("b", "i", "u", "f")
        and not dtype.is_dictionary
    ):
        # typed numpy input: vectorized encode, no per-element Python loop
        validity = np.ones(n, dtype=bool)
        if dtype.kind is TypeKind.BOOLEAN:
            data = values.astype(bool)
        elif dtype.kind is TypeKind.DECIMAL128 and dtype.params:
            scale = dtype.params[1]
            data = np.round(values.astype(np.float64) * 10**scale).astype(np.int64)
        else:
            data = values.astype(dtype.device_dtype)
        if values.dtype.kind == "f":
            validity = ~np.isnan(values)
            data = np.where(validity, data, 0)
        return Column(
            _pad_1d(data, cap), _pad_1d(validity, cap, fill=False), dtype, None
        )
    validity = np.asarray([v is not None for v in values], dtype=bool)
    if dtype.is_dictionary:
        dictionary, codes = Dictionary.from_values(values)
        data = codes
    elif dtype.kind is TypeKind.BOOLEAN:
        data = np.asarray([bool(v) if v is not None else False for v in values])
        dictionary = None
    elif dtype.kind is TypeKind.DECIMAL128 and dtype.params:
        scale = dtype.params[1]
        data = np.asarray(
            [int(round(float(v) * 10**scale)) if v is not None else 0 for v in values],
            dtype=np.int64,
        )
        dictionary = None
    else:
        np_dtype = dtype.device_dtype
        data = np.asarray(
            [v if v is not None else 0 for v in values], dtype=np_dtype
        )
        dictionary = None
    return Column(
        _pad_1d(data, cap), _pad_1d(validity, cap, fill=False), dtype, dictionary
    )


class ColumnBatch:
    """A batch of rows in columnar device-friendly layout."""

    __slots__ = ("schema", "columns", "num_rows")

    def __init__(self, schema: Schema, columns: List[Column], num_rows: int):
        if len(schema) != len(columns):
            raise SchemaError(
                f"schema has {len(schema)} fields but {len(columns)} columns given"
            )
        caps = {c.capacity for c in columns}
        if len(caps) > 1:
            raise ExecutionError(f"ragged column capacities: {caps}")
        self.schema = schema
        self.columns = columns
        self.num_rows = int(num_rows)

    # ---- properties ----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else padded_capacity(self.num_rows)

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, i: Union[int, str]) -> Column:
        if isinstance(i, str):
            i = self.schema.index_of(i)
        return self.columns[i]

    def live_mask_np(self) -> np.ndarray:
        m = np.zeros(self.capacity, dtype=bool)
        m[: self.num_rows] = True
        return m

    # ---- constructors --------------------------------------------------
    @staticmethod
    def from_pydict(
        data: Dict[str, Sequence], schema: Optional[Schema] = None
    ) -> "ColumnBatch":
        names = list(data.keys())
        n = len(next(iter(data.values()))) if data else 0
        if schema is None:
            fields = [Field(name, _infer_type(data[name])) for name in names]
            schema = Schema(fields)
        cols = []
        for f in schema:
            vals = list(data[f.name])
            if len(vals) != n:
                raise SchemaError(f"ragged column '{f.name}'")
            cols.append(_encode_values(vals, f.data_type))
        return ColumnBatch(schema, cols, n)

    @staticmethod
    def empty(schema: Schema) -> "ColumnBatch":
        cols = []
        for f in schema:
            cap = CAPACITY_MIN
            data = np.zeros(cap, dtype=f.data_type.device_dtype)
            validity = np.zeros(cap, dtype=bool)
            d = Dictionary.empty() if f.data_type.is_dictionary else None
            cols.append(Column(data, validity, f.data_type, d))
        return ColumnBatch(schema, cols, 0)

    @staticmethod
    def from_arrow(rb) -> "ColumnBatch":
        """Ingest a pyarrow RecordBatch/Table."""
        if pa is None:
            raise ExecutionError("pyarrow unavailable")
        if isinstance(rb, pa.Table):
            rb = rb.combine_chunks()
            arrays = [
                col.chunk(0) if col.num_chunks else pa.array([], type=col.type)
                for col in rb.columns
            ]
            schema_src = rb.schema
            n = rb.num_rows
        else:
            arrays = rb.columns
            schema_src = rb.schema
            n = rb.num_rows
        schema = Schema.from_arrow(schema_src)
        cap = padded_capacity(n)
        cols = []
        for arr, f in zip(arrays, schema):
            validity = np.asarray(arr.is_valid())
            if f.data_type.is_dictionary:
                pylist = arr.to_pylist()
                dictionary, codes = Dictionary.from_values(pylist)
                data = codes
            else:
                np_dtype = f.data_type.device_dtype
                # fill nulls with 0 then cast
                if arr.null_count:
                    import pyarrow.compute as pc

                    arr = pc.fill_null(arr, 0)
                if pa.types.is_timestamp(arr.type) or pa.types.is_duration(arr.type):
                    data = arr.cast(pa.int64()).to_numpy(zero_copy_only=False)
                elif pa.types.is_date32(arr.type):
                    data = arr.cast(pa.int32()).to_numpy(zero_copy_only=False)
                elif pa.types.is_date64(arr.type):
                    data = arr.cast(pa.int64()).to_numpy(zero_copy_only=False)
                elif pa.types.is_decimal(arr.type):
                    scale = arr.type.scale
                    data = np.asarray(
                        [
                            int(round(float(x) * 10**scale)) if x is not None else 0
                            for x in arr.to_pylist()
                        ],
                        dtype=np.int64,
                    )
                else:
                    data = arr.to_numpy(zero_copy_only=False)
                data = np.ascontiguousarray(data).astype(np_dtype, copy=False)
                dictionary = None
            cols.append(
                Column(
                    _pad_1d(np.asarray(data), cap),
                    _pad_1d(validity, cap, fill=False),
                    f.data_type,
                    dictionary,
                )
            )
        return ColumnBatch(schema, cols, n)

    # ---- exporters -----------------------------------------------------
    def to_pydict(self) -> Dict[str, list]:
        return {
            f.name: c.to_pylist(self.num_rows)
            for f, c in zip(self.schema, self.columns)
        }

    def to_pylist(self) -> List[tuple]:
        cols = [c.to_pylist(self.num_rows) for c in self.columns]
        return list(zip(*cols)) if cols else []

    def to_arrow(self):
        if pa is None:
            raise ExecutionError("pyarrow unavailable")
        arrays = []
        for f, c in zip(self.schema, self.columns):
            arrays.append(pa.array(c.to_pylist(self.num_rows), type=f.data_type.to_arrow()))
        return pa.RecordBatch.from_arrays(arrays, schema=self.schema.to_arrow())

    # ---- transforms ----------------------------------------------------
    def select(self, indices: Sequence[int]) -> "ColumnBatch":
        return ColumnBatch(
            self.schema.project(indices),
            [self.columns[i] for i in indices],
            self.num_rows,
        )

    def rename(self, names: Sequence[str]) -> "ColumnBatch":
        schema = Schema(
            [f.with_name(n) for f, n in zip(self.schema, names)]
        )
        return ColumnBatch(schema, self.columns, self.num_rows)

    def slice(self, offset: int, length: int) -> "ColumnBatch":
        """Host-side row slice (LIMIT/OFFSET; reference executor.rs:299-341)."""
        offset = min(max(offset, 0), self.num_rows)
        length = min(length, self.num_rows - offset)
        idx = np.arange(offset, offset + length)
        cap = padded_capacity(length)
        cols = [c.take_host(idx, cap) for c in self.columns]
        return ColumnBatch(self.schema, cols, length)

    def take_host(self, indices: np.ndarray) -> "ColumnBatch":
        cap = padded_capacity(len(indices))
        cols = [c.take_host(indices, cap) for c in self.columns]
        return ColumnBatch(self.schema, cols, len(indices))

    @staticmethod
    def concat(batches: List["ColumnBatch"]) -> "ColumnBatch":
        """Concatenate batches of the same schema, merging dictionaries."""
        batches = [b for b in batches if b is not None]
        if not batches:
            raise ExecutionError("concat of zero batches")
        if len(batches) == 1:
            return batches[0]
        schema = batches[0].schema
        total = sum(b.num_rows for b in batches)
        cap = padded_capacity(total)
        cols: List[Column] = []
        for ci, f in enumerate(schema):
            parts_d, parts_v = [], []
            if f.data_type.is_dictionary:
                dicts = [
                    b.columns[ci].dictionary or Dictionary.empty() for b in batches
                ]
                merged, remaps = merge_many(dicts)
                for b, remap in zip(batches, remaps):
                    codes = b.columns[ci].np_data()[: b.num_rows]
                    if len(remap):
                        codes = remap[np.clip(codes, 0, len(remap) - 1)]
                    parts_d.append(codes)
                    parts_v.append(b.columns[ci].np_validity()[: b.num_rows])
                dictionary = merged
            else:
                for b in batches:
                    parts_d.append(b.columns[ci].np_data()[: b.num_rows])
                    parts_v.append(b.columns[ci].np_validity()[: b.num_rows])
                dictionary = None
            data = np.concatenate(parts_d) if parts_d else np.zeros(0, f.data_type.device_dtype)
            validity = np.concatenate(parts_v) if parts_v else np.zeros(0, bool)
            cols.append(
                Column(
                    _pad_1d(data, cap),
                    _pad_1d(validity, cap, fill=False),
                    f.data_type,
                    dictionary,
                )
            )
        return ColumnBatch(schema, cols, total)

    def __repr__(self) -> str:
        return f"ColumnBatch({self.schema}, rows={self.num_rows}, cap={self.capacity})"
