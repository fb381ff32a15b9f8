"""ColumnBatch — the static-shape unit of data flowing through operators.

XLA requires static shapes, but SQL operators (WHERE, JOIN, GROUP BY) produce
data-dependent row counts. The engine-wide convention: every intermediate is a
*padded* set of equal-length 1-D columns plus a scalar ``n_valid`` count. Rows
at index >= n_valid are padding and carry no meaning; operators must mask them.

This replaces the reference's per-query whole-matrix FFI shipping
(``FutharkContext.py:65,70``) with device-resident columns, and is the
engine-level answer to SURVEY §7 "hard part 1" (variable-size outputs under
XLA static shapes).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
class ColumnBatch:
    """An ordered set of named, equal-capacity 1-D device columns + valid count.

    ``columns`` preserves insertion order — column order is observable in query
    output (reference keeps requested select order, ``select.fut:17-20``).
    """

    def __init__(self, columns: Dict[str, jax.Array], n_valid: jax.Array):
        self.columns = dict(columns)
        self.n_valid = n_valid

    # -- pytree protocol ------------------------------------------------------
    def tree_flatten(self):
        names = tuple(self.columns.keys())
        children = tuple(self.columns[n] for n in names) + (self.n_valid,)
        return children, names

    @classmethod
    def tree_unflatten(cls, names, children):
        *cols, n_valid = children
        return cls(dict(zip(names, cols)), n_valid)

    # -- structure ------------------------------------------------------------
    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        return next(iter(self.columns.values())).shape[0]

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    def column(self, name: str) -> jax.Array:
        return self.columns[name]

    def valid_mask(self) -> jax.Array:
        """Boolean mask of shape (capacity,): True for live rows."""
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.n_valid

    def with_columns(self, columns: Dict[str, jax.Array]) -> "ColumnBatch":
        return ColumnBatch(columns, self.n_valid)

    def select(self, names) -> "ColumnBatch":
        """Projection: keep `names` in order. Duplicates allowed via aliasing
        at the planner level (output names must be unique in the dict)."""
        return ColumnBatch({n: self.columns[n] for n in names}, self.n_valid)

    def rename(self, mapping: Dict[str, str]) -> "ColumnBatch":
        return ColumnBatch(
            {mapping.get(n, n): c for n, c in self.columns.items()}, self.n_valid
        )

    # -- host conversion ------------------------------------------------------
    def to_numpy(self) -> Tuple[np.ndarray, List[str]]:
        """Materialize as a dense 2-D row-major matrix + header list (the
        reference's output shape, ``FutharkContext.py:66,71``). Syncs."""
        n = int(self.n_valid)
        names = self.names
        if not names:
            return np.empty((n, 0)), names
        cols = [np.asarray(self.columns[c])[:n] for c in names]
        return np.stack(cols, axis=1) if cols else np.empty((n, 0)), names

    @staticmethod
    def from_numpy(
        arrays: Dict[str, np.ndarray], capacity: int | None = None
    ) -> "ColumnBatch":
        """Build a padded device batch from host 1-D arrays."""
        if not arrays:
            return ColumnBatch({}, jnp.int32(0))
        n = len(next(iter(arrays.values())))
        cap = capacity if capacity is not None else n
        assert cap >= n, (cap, n)
        cols = {}
        for name, a in arrays.items():
            a = np.asarray(a)
            assert a.ndim == 1 and a.shape[0] == n, (name, a.shape, n)
            if cap > n:
                a = np.concatenate([a, np.zeros(cap - n, dtype=a.dtype)])
            cols[name] = jnp.asarray(a)
        return ColumnBatch(cols, jnp.int32(n))

    def __repr__(self):
        cols = ", ".join(f"{n}:{c.dtype}" for n, c in self.columns.items())
        return f"ColumnBatch(cap={self.capacity}, cols=[{cols}])"


def align_capacity(n: int, align: int) -> int:
    """Round n up to a multiple of `align` (min 1 unit) so nearby sizes share one jit shape."""
    if n <= 0:
        return align
    return ((n + align - 1) // align) * align
