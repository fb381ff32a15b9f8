"""Dense-key GROUP BY: one int32 scatter-add into a (span, C) table.

When the group key is an int column whose live values fit in a small range
``[key_min, key_min + span)``, the groups are the positions of a dense
table and the aggregation needs no sort:

    table[key - key_min, c] += value_c        (count adds a column of ones)

int32 addition wraps mod 2^32 and is commutative, so the result does not
depend on the order in which the hardware applies the updates and is
bit-identical to the sort path's telescoping cumsums (``ops/groupby.py``).
The planner admits only int keys and int sum/count aggregates here
(``QueryPlan.fast_candidate``); float sums would depend on the update order.

Excluded rows (padding, a fused WHERE mask) get an out-of-range index and
are dropped by the scatter. The result is compacted to the keys that occur,
in ascending key order — the group-by output contract.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from harkdb_tpu.columnar.batch import ColumnBatch
from harkdb_tpu.prims.compaction import compact_batch

Array = jax.Array

# Widest key span the dense path takes; wider spans take the sort path.
# ``chip_smoke.py --choices`` timed both paths at 2^24 rows on an H100: the
# dense path was 13-31x faster at every span measured (2^10 to 2^20), so the
# gate is the widest span measured (numbers in CHANGES.md).
MAX_KEY_SPAN = 1 << 20


def dense_groupby_sums(
    key: Array,
    value_cols: Sequence[Array],
    n_valid: Array,
    key_min: Array,
    span: int,
    mask: Optional[Array] = None,
) -> Tuple[Array, List[Array], Array]:
    """Per-key counts and int32 sums over a dense key range.

    Returns ``(counts, sums, keys_axis)`` where ``counts[k]`` and
    ``sums[c][k]`` aggregate the rows with ``key == key_min + k``
    (``k < span``), and ``keys_axis[k] = key_min + k``. Rows at index
    ``>= n_valid``, rows failing ``mask`` and rows whose key lies outside the
    range are excluded. Sums wrap mod 2^32 like every int32 sum in the engine.
    """
    n = key.shape[0]
    live = jnp.arange(n, dtype=jnp.int32) < n_valid
    if mask is not None:
        live = live & mask
    k0 = key - key_min
    live = live & (k0 >= 0) & (k0 < span)
    slot = jnp.where(live, k0, span)                  # span → dropped
    vals = jnp.stack(
        [c.astype(jnp.int32) for c in value_cols]
        + [jnp.ones((n,), jnp.int32)],
        axis=1,
    )
    table = jnp.zeros((span, vals.shape[1]), jnp.int32).at[slot].add(
        vals, mode="drop"
    )
    counts = table[:, -1]
    sums = [table[:, j] for j in range(len(value_cols))]
    keys_axis = key_min + jnp.arange(span, dtype=key.dtype)
    return counts, sums, keys_axis


def dense_groupby_batch(
    cols: Dict[str, Array],
    key_name: str,
    agg_specs: Sequence[Tuple[str, str, str]],
    n_valid: Array,
    key_min: Array,
    span: int,
    mask: Optional[Array] = None,
) -> ColumnBatch:
    """GROUP BY ``key_name`` with sum/count ``agg_specs`` (source, op, output
    name) on the dense path. Output: the key column, then the aggregates,
    one row per key that occurs, ascending by key."""
    sum_srcs = list(dict.fromkeys(
        src for src, op, _ in agg_specs if op == "sum"
    ))
    counts, sums, keys_axis = dense_groupby_sums(
        cols[key_name], [cols[s] for s in sum_srcs], n_valid, key_min, span,
        mask=mask,
    )
    sums_by_src = dict(zip(sum_srcs, sums))
    out = {key_name: keys_axis}
    for src, op, out_name in agg_specs:
        out[out_name] = counts if op == "count" else sums_by_src[src]
    return compact_batch(ColumnBatch(out, jnp.int32(span)), counts > 0)
