"""Sort operators (ORDER BY / SORT BY and the substrate for sort-based ops).

The reference has no user-facing SORT BY at all — its radix sort exists only as
an internal groupby/join step (32 sequential single-bit passes,
``groupby.fut:8-22``, ``join.fut:9-23``). Here sorting is a first-class
operator built on ``jax.lax.sort``, which XLA lowers to an on-device sort.
The engine's sort-carry design assumes extra payload operands are cheaper
than per-column permutation gathers; not measured on the H100.

Engine conventions honored:
  * padded batches — padding rows always sort to the back, regardless of the
    junk values they carry;
  * stability — equal keys preserve input row order (required for the
    reference's observable join ordering, SURVEY §3.5);
  * multi-key lexicographic sort with per-key ASC/DESC.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from harkdb_tpu.columnar.batch import ColumnBatch

Array = jax.Array


def _descending_transform(key: Array) -> Array:
    """Order-reversing bijection so a DESC key can ride an ascending sort.

    Signed ints: bitwise-not (``~x = -x-1``) is strictly decreasing and total
    (handles INT_MIN, unlike negation). Floats: negation.
    """
    if jnp.issubdtype(key.dtype, jnp.floating):
        return -key
    return ~key


def _pad_to_max(key: Array, n_valid: Array) -> Array:
    """Replace padding rows' key values with the dtype max so they sort last
    while keeping the key array monotone after the sort (searchsorted-safe)."""
    n = key.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    if jnp.issubdtype(key.dtype, jnp.floating):
        hi = jnp.array(jnp.finfo(key.dtype).max, key.dtype)
    else:
        hi = jnp.array(jnp.iinfo(key.dtype).max, key.dtype)
    return jnp.where(idx < n_valid, key, hi)


def sort_permutation(
    keys: Sequence[Array],
    n_valid: Array,
    descending: Optional[Sequence[bool]] = None,
) -> Tuple[Array, List[Array]]:
    """Stable lexicographic sort of the live rows.

    Returns ``(perm, sorted_keys)``: ``perm[i]`` = source row of output row i.
    Live rows occupy output positions ``[0, n_valid)``; padding rows follow in
    their original relative order. ``sorted_keys`` are the transformed keys
    after permutation (pads replaced with dtype max; DESC keys transformed) —
    callers that need searchsorted monotonicity use ``sorted_keys[0]`` of a
    single ASC key.
    """
    keys = list(keys)
    if descending is None:
        descending = [False] * len(keys)
    n = keys[0].shape[0]
    eff = []
    for k, desc in zip(keys, descending):
        if desc:
            k = _descending_transform(k)
        eff.append(_pad_to_max(k, n_valid))
    iota = jnp.arange(n, dtype=jnp.int32)
    out = jax.lax.sort(eff + [iota], num_keys=len(eff), is_stable=True)
    perm = out[-1]
    return perm, list(out[:-1])


def sort_batch(
    batch: ColumnBatch,
    key_names: Sequence[str],
    descending: Optional[Sequence[bool]] = None,
    key_arrays: Optional[Sequence[Array]] = None,
    mask: Optional[Array] = None,
) -> ColumnBatch:
    """ORDER BY: reorder all columns by the sort keys.

    One stable ``lax.sort`` with every column carried as payload — no
    per-column permutation gathers. ``key_arrays``
    optionally supplies precomputed key columns (ORDER BY expressions) in
    place of ``key_names`` lookups. ``mask`` fuses a row filter (WHERE /
    HAVING predicate) into this same sort: dropped rows ride to the back as
    a leading sort key and the output count shrinks — no separate
    compaction pass.
    """
    keys = (
        list(key_arrays) if key_arrays is not None
        else [batch.column(k) for k in key_names]
    )
    if descending is None:
        descending = [False] * len(keys)
    n = batch.capacity
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < batch.n_valid
    if mask is not None:
        valid = valid & mask
    n_out = jnp.sum(valid.astype(jnp.int32))
    dropped = jnp.logical_not(valid).astype(jnp.int32)
    eff = [dropped]
    for k, desc in zip(keys, descending):
        if desc:
            k = _descending_transform(k)
        eff.append(k)
    names = batch.names
    out = jax.lax.sort(
        eff + [batch.columns[c] for c in names],
        num_keys=len(eff), is_stable=True,
    )
    cols = dict(zip(names, out[len(eff):]))
    return ColumnBatch(cols, n_out)
