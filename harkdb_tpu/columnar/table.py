"""Device-resident columnar Table.

The reference ships the whole host matrix across the FFI on *every* query
(``FutharkContext.py:65,70``). Here ``create_table`` pads + transfers columns
to device once; queries run against resident arrays. Under a mesh, columns are
row-sharded across devices at creation (see ``harkdb_tpu.parallel``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from harkdb_tpu.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu.columnar.batch import ColumnBatch, align_capacity
from harkdb_tpu.columnar.ingest import load_table


class Table:
    """Named schema + padded device-resident columns.

    Mirrors the reference ``Table`` surface (``table.py:52-81``:
    get_schema / get_data / get_name) while storing true columnar data.
    """

    def __init__(self, table_name: str, source, config: EngineConfig = DEFAULT_CONFIG,
                 col_names: Optional[List[str]] = None, sharding=None):
        self._table_name = table_name
        self._config = config
        host_cols, headers, dicts = load_table(source, config, col_names)
        self._schema = headers
        self._host_cols = host_cols          # unpadded; kept for resharding
        self._dicts = dicts                  # string col → sorted dictionary
                                             # (host-side; device sees codes)
        self._n_rows = len(next(iter(host_cols.values()))) if host_cols else 0
        cap = align_capacity(self._n_rows, config.row_align)
        self._sharding = sharding
        cols = {}
        for name in headers:
            a = host_cols[name]
            if cap > self._n_rows:
                a = np.concatenate([a, np.zeros(cap - self._n_rows, dtype=a.dtype)])
            if sharding is not None:
                cols[name] = jax.device_put(a, sharding)
            else:
                cols[name] = jnp.asarray(a)
        self._columns = cols

    # -- reference-compatible surface (table.py:64-81) ------------------------
    def get_schema(self) -> List[str]:
        return list(self._schema)

    def get_data(self) -> np.ndarray:
        """Dense 2-D row-major matrix of live rows (reference layout)."""
        return self.batch().to_numpy()[0]

    def get_name(self) -> str:
        return self._table_name

    # -- engine surface -------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self._n_rows

    @property
    def capacity(self) -> int:
        if not self._columns:
            return 0
        return next(iter(self._columns.values())).shape[0]

    @property
    def columns(self) -> Dict[str, jax.Array]:
        return self._columns

    @property
    def host_columns(self) -> Dict[str, np.ndarray]:
        """Unpadded host copies (used for mesh resharding and native IO)."""
        return self._host_cols

    def column_dict(self, name: str):
        """Sorted string dictionary of a dictionary-encoded column, or None
        for numeric columns. Codes are lexicographic ranks, so comparisons /
        ORDER BY / MIN / MAX on the device codes match string semantics."""
        return self._dicts.get(name)

    @property
    def dicts(self) -> Dict[str, np.ndarray]:
        return self._dicts

    def column_range(self, name: str):
        """(min, max) of an integer column, cached — drives the planner's
        dense-key aggregation gate. None for float/empty columns."""
        if not hasattr(self, "_ranges"):
            self._ranges = {}
        if name not in self._ranges:
            a = self._host_cols[name]
            if a.size == 0 or not np.issubdtype(a.dtype, np.integer):
                self._ranges[name] = None
            else:
                self._ranges[name] = (int(a.min()), int(a.max()))
        return self._ranges[name]

    @property
    def sharding(self):
        return self._sharding

    def batch(self) -> ColumnBatch:
        return ColumnBatch(dict(self._columns), jnp.int32(self._n_rows))

    def nbytes(self) -> int:
        return sum(int(c.size) * c.dtype.itemsize for c in self._columns.values())

    def __repr__(self):
        return (f"Table({self._table_name!r}, rows={self._n_rows}, "
                f"cols={self._schema})")
