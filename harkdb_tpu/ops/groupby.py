"""GROUP BY aggregation (reference semantics: ``groupby.fut:51-62``).

Output contract matched to the reference (SURVEY §3.4): one row per distinct
key, **ascending key order**, column 0 = key, remaining columns = aggregates in
select-list order. (The reference's radix sort compares u32 bit patterns; we
default to signed-ascending — identical for the non-negative keys the
reference's homogeneous-int tables use, and strictly more sensible for
negatives. ``u32_key_order=True`` / ``EngineConfig.compat_u32_key_order``
reproduces the reference's u32 order exactly; tests/test_parity.py pins both
orders.)

Sort-based algorithm for any key type and span (small int key spans take
the dense scatter-add path instead, ``ops/dense_agg.py``). Its costs on the
H100 are not measured yet:

  1. ONE stable ``lax.sort`` on (dropped-mask, keys...) carrying every
     aggregate input column as payload — no per-column permutation gathers;
     a WHERE predicate fuses in as the leading sort key for free (the planner
     then skips its separate compaction sort);
  2. boundary flags on the sorted keys mark segment starts/ends;
  3. per-segment values are produced as *row-level scans*: integer sums and
     counts via global ``cumsum`` + telescoping differences at segment ends
     (exact under two's-complement wraparound); float sums and max/min/prod
     via a log-doubling segmented scan (``prims.segmented``) — no scatter;
  4. ONE shared compaction (``prims/compaction.py``) packs every segment-end
     row (keys + all scan results + row position) to the front in key order.

Total: one payload-carrying sort, one compaction and a few elementwise scan
passes, regardless of the number of aggregate columns. The reference instead runs 32 sequential
single-bit radix passes (``groupby.fut:22``) and one segmented reduce per
column.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from harkdb_tpu.columnar.batch import ColumnBatch
from harkdb_tpu.prims.segmented import doubling_segmented_scan

Array = jax.Array

AGG_FUNCS: Dict[str, Callable] = {
    "sum": jnp.add,
    "prod": jnp.multiply,
    "max": jnp.maximum,
    "min": jnp.minimum,
    "count": jnp.add,
    "countd": jnp.add,       # COUNT(DISTINCT x) — see groupby_aggregate
}

_SCAN_OP = {
    "sum": jnp.add,
    "prod": jnp.multiply,
    "max": jnp.maximum,
    "min": jnp.minimum,
}


def _neutral(op_name: str, dtype) -> jax.Array:
    return jnp.array(_neutral_py(op_name, dtype), dtype)


def _neutral_py(op_name: str, dtype):
    """Op-neutral element as a python scalar (static kernel argument)."""
    if op_name in ("sum", "count"):
        return 0
    if op_name == "prod":
        return 1
    if jnp.issubdtype(dtype, jnp.floating):
        info = jnp.finfo(dtype)
        return float(info.min) if op_name == "max" else float(info.max)
    info = jnp.iinfo(dtype)
    if op_name == "max":
        return int(info.min)
    if op_name == "min":
        return int(info.max)
    raise ValueError(f"Unknown aggregate {op_name!r}")


def u32_order_key(key: Array) -> Array:
    """Order-preserving signed view of an int key's u32 bit pattern.

    Flipping the sign bit maps unsigned comparison order onto signed order
    (an involution: apply again to undo). Used by the
    ``compat_u32_key_order`` mode to reproduce the reference's radix-sort
    key order (``groupby.fut:21-22``: negatives sort AFTER positives).
    """
    if not jnp.issubdtype(key.dtype, jnp.integer):
        return key
    return key ^ jnp.array(jnp.iinfo(key.dtype).min, key.dtype)


def groupby_aggregate(
    keys: Union[Array, Sequence[Array]],
    agg_cols: Sequence[Tuple[Array, str]],
    n_valid: Array,
    mask: Optional[Array] = None,
    u32_key_order: bool = False,
) -> Tuple[List[Array], List[Array], Array]:
    """Aggregate ``agg_cols`` (value, op-name) per distinct key tuple.

    ``keys`` is one array or a list (multi-key lexicographic grouping — the
    reference supports a single key only, ``parse.py:66-69``). ``mask``
    optionally restricts the aggregation to rows where it is True (a fused
    WHERE predicate — costs nothing: it rides the sort as the leading key).
    ``u32_key_order`` orders output groups by the keys' u32 bit patterns
    (reference radix order) instead of signed-ascending. Returns
    ``(keys_out, agg_outs, n_groups)`` — all padded to the input
    capacity; rows at index >= n_groups are padding.
    """
    if not isinstance(keys, (list, tuple)):
        keys = [keys]
    keys = list(keys)
    orig_dtypes = [k.dtype for k in keys]
    if u32_key_order:
        # XOR preserves equality, so segmenting logic is unchanged; only the
        # sort order differs. Undone on the output keys below.
        keys = [u32_order_key(k) for k in keys]
    nk = len(keys)
    n = keys[0].shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    valid_in = idx < n_valid
    if mask is not None:
        valid_in = valid_in & mask

    # ONE sort: dropped-mask leading (live rows pack to the front in key
    # order; no dtype-max padding tricks needed, so masks fuse exactly), then
    # the keys, with all aggregate inputs as carried payload. COUNT(DISTINCT)
    # and quantile columns do not ride as payload — each gets its own
    # auxiliary sort where it participates as a KEY (below).
    dropped = jnp.logical_not(valid_in).astype(jnp.int32)
    payload = [
        col for col, op in agg_cols
        if op not in ("count", "countd")
        and not str(op).startswith("quantile@")
    ]
    sorted_all = jax.lax.sort(
        [dropped] + keys + payload, num_keys=1 + nk, is_stable=True
    )
    sorted_keys = list(sorted_all[1:1 + nk])
    sorted_payload = list(sorted_all[1 + nk:])
    count = jnp.sum(valid_in.astype(jnp.int32))
    valid = idx < count

    # Segment starts/ends from key changes between adjacent live rows.
    changed = jnp.zeros((n,), jnp.bool_)
    for skey in sorted_keys:
        prev = jnp.concatenate([skey[:1], skey[:-1]])
        changed = changed | (skey != prev)
    is_start = valid & ((idx == 0) | changed)
    n_groups = jnp.sum(is_start.astype(jnp.int32))
    next_start = jnp.concatenate([is_start[1:], jnp.zeros((1,), jnp.bool_)])
    is_end = valid & (next_start | (idx == count - 1))

    # Row-level scan per op class (no scatters):
    #   * int sum  → global cumsum; telescoping differences at segment ends
    #     are exact under two's-complement wraparound;
    #   * float sum / max / min / prod → log-doubling segmented scan;
    #   * count → row positions; per-group counts are position differences.
    # Each class stacks its columns into one (n, k) scan.
    plans: List[Tuple[str, int]] = []          # per agg: (post-kind, slot)
    cum_cols: List[Array] = []
    scan_groups: Dict[Tuple[str, str], List[Tuple[int, Array]]] = {}
    need_pos = False
    pay_i = 0
    for ai, (_col, op) in enumerate(agg_cols):
        if op == "count":
            plans.append(("count", -1))
            need_pos = True
            continue
        if op == "countd":
            plans.append(("countd", -1))   # slot patched below
            continue
        if str(op).startswith("quantile@"):
            plans.append(("quantile", -1))  # slot patched below
            continue
        col = sorted_payload[pay_i]
        pay_i += 1
        if op == "sum" and jnp.issubdtype(col.dtype, jnp.integer):
            plans.append(("telescope", len(cum_cols)))
            cum_cols.append(col)
        else:
            key = (op, str(col.dtype))
            scan_groups.setdefault(key, []).append((ai, col))
            plans.append(("scan", -1))         # slot patched below

    end_arrays: List[Array] = []               # compaction payload
    slot_of: Dict[int, int] = {}               # agg index → end_arrays slot
    if cum_cols:
        S = jnp.cumsum(jnp.stack(cum_cols, axis=1), axis=0)
        cum_base = len(end_arrays)
        end_arrays.extend(S[:, j] for j in range(len(cum_cols)))
    sid = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    for (op, dt), members in scan_groups.items():
        member_cols = [c for _ai, c in members]
        D = doubling_segmented_scan(
            _SCAN_OP[op], sid, jnp.stack(member_cols, axis=1)
        )
        scanned = [D[:, j] for j in range(len(members))]
        for (ai, _c), col_scan in zip(members, scanned):
            slot_of[ai] = len(end_arrays)
            end_arrays.append(col_scan)

    # COUNT(DISTINCT x): one auxiliary sort per distinct column where x rides
    # as an extra trailing KEY — within each group's (identical-position)
    # segment the values are then sorted, so the distinct count is the number
    # of value-change boundaries. Group-boundary positions depend only on the
    # multiset of (dropped, keys), so the MAIN sort's is_start/is_end flags
    # apply verbatim and the cumsum telescopes at the shared segment ends.
    #
    # NULL-skipping form: the column may be a (value, valid01) PAIR — the
    # inverted valid flag rides as a key BEFORE the value, sorting a
    # group's NULL rows after its valid rows, and only valid-row value
    # boundaries count. Exact — no sentinel value to collide with data.
    for ai, (col, op) in enumerate(agg_cols):
        if op != "countd":
            continue
        if isinstance(col, tuple):
            val_col, valid_col = col
            inv = (valid_col == 0).astype(jnp.int32)
            aux = jax.lax.sort(
                [dropped] + keys + [inv, val_col], num_keys=3 + nk
            )
            x_s, inv_s = aux[-1], aux[-2]
            prev_x = jnp.concatenate([x_s[:1], x_s[:-1]])
            # valid rows are contiguous from each group's start, so a valid
            # row's predecessor (within the group) is valid too
            new_val = (inv_s == 0) & (is_start | (valid & (x_s != prev_x)))
        else:
            aux = jax.lax.sort([dropped] + keys + [col], num_keys=2 + nk)
            x_s = aux[-1]
            prev_x = jnp.concatenate([x_s[:1], x_s[:-1]])
            new_val = is_start | (valid & (x_s != prev_x))
        slot_of[ai] = len(end_arrays)
        end_arrays.append(jnp.cumsum(new_val.astype(jnp.int32)))
    # QUANTILE(x, q) / MEDIAN: one auxiliary sort per column with x as an
    # extra trailing KEY (like countd); the q-quantile (PERCENTILE_CONT
    # linear interpolation) sits at valid-local positions lo = ⌊(n-1)q⌋ and
    # hi = ⌈(n-1)q⌉ within the group — exactly those rows contribute
    # weighted values to a per-group segmented SUM (float-precise; the
    # global-cumsum telescope would lose precision), evaluated at the
    # shared segment ends. NULL-skipping form: (value, valid01) pair —
    # invalid rows sort after the group's valid rows and contribute 0.
    def _run_total(x_int):
        """Per-row total of x over the row's group run (scatter-free
        forward/backward fills — the join machinery's pattern)."""
        cum = jnp.cumsum(x_int)
        excl = cum - x_int
        base = jax.lax.cummax(jnp.where(is_start, excl, 0))
        big = jnp.int32(n + 1)
        aoa = jnp.flip(jax.lax.cummin(jnp.flip(
            jnp.where(is_start, excl, big)
        )))
        nxt = jnp.minimum(
            jnp.concatenate([aoa[1:], big[None]]), cum[-1]
        )
        return nxt - base

    for ai, (col, op) in enumerate(agg_cols):
        if not str(op).startswith("quantile@"):
            continue
        q = float(str(op).split("@", 1)[1])
        if isinstance(col, tuple):
            val_col, valid_col = col
            inv = (valid_col == 0).astype(jnp.int32)
            aux = jax.lax.sort(
                [dropped] + keys + [inv, val_col], num_keys=3 + nk
            )
            x_s, inv_s = aux[-1], aux[-2]
            row_ok = valid & (inv_s == 0)
        else:
            aux = jax.lax.sort([dropped] + keys + [col], num_keys=2 + nk)
            x_s = aux[-1]
            row_ok = valid
        gstart = jax.lax.cummax(jnp.where(is_start, idx, 0))
        glen = _run_total(row_ok.astype(jnp.int32))
        p = idx - gstart                     # valid rows are group-leading
        pos_f = (glen - 1).astype(jnp.float32) * q
        lo = jnp.floor(pos_f).astype(jnp.int32)
        hi = lo + (pos_f > lo.astype(jnp.float32)).astype(jnp.int32)
        frac = pos_f - lo.astype(jnp.float32)
        xf = x_s.astype(jnp.float32)
        z = jnp.where(row_ok & (p == lo), xf * (1.0 - frac), 0.0)
        z = z + jnp.where(row_ok & (p == hi) & (hi != lo), xf * frac, 0.0)
        sid_q = jnp.where(
            valid, jnp.cumsum(is_start.astype(jnp.int32)) - 1,
            jnp.int32(1 << 30),
        )
        scanned = doubling_segmented_scan(jnp.add, sid_q, z)
        slot_of[ai] = len(end_arrays)
        end_arrays.append(scanned)

    pos_slot = -1
    if need_pos:
        pos_slot = len(end_arrays)
        end_arrays.append(idx)

    # ONE shared compaction: pack segment-end rows (keys + every scan result)
    # to the front, in key order (prims/compaction.py).
    from harkdb_tpu.prims.compaction import compact_arrays

    packed, _cnt = compact_arrays(
        sorted_keys + end_arrays, is_end, jnp.int32(n)
    )
    packed_keys = packed[:nk]
    packed_vals = packed[nk:]

    live_out = idx < n_groups
    keys_out = []
    for j in range(nk):
        k = packed_keys[j]
        if u32_key_order:
            k = u32_order_key(k)        # involution: restore original values
        keys_out.append(jnp.where(live_out, k, 0).astype(orig_dtypes[j]))

    def _prev(arr: Array, first) -> Array:
        return jnp.concatenate(
            [jnp.full((1,), first, arr.dtype), arr[:-1]]
        )

    counts_out = None
    if need_pos:
        P = packed_vals[pos_slot]
        counts_out = P - _prev(P, -1)

    outs: List[Array] = []
    for ai, ((col, op), (kind, cum_j)) in enumerate(zip(agg_cols, plans)):
        if kind == "count":
            outs.append(
                jnp.where(live_out, counts_out, 0).astype(jnp.int32)
            )
        elif kind == "countd":
            E = packed_vals[slot_of[ai]]
            r = E - _prev(E, 0)
            outs.append(jnp.where(live_out, r, 0).astype(jnp.int32))
        elif kind == "quantile":
            r = packed_vals[slot_of[ai]]     # per-group segmented sum
            outs.append(
                jnp.where(live_out, r, 0.0).astype(jnp.float32)
            )
        elif kind == "telescope":
            E = packed_vals[cum_base + cum_j]
            r = E - _prev(E, 0)
            outs.append(jnp.where(live_out, r, 0).astype(col.dtype))
        else:
            r = packed_vals[slot_of[ai]]
            ne = _neutral(op, r.dtype)
            outs.append(jnp.where(live_out, r, ne).astype(col.dtype))
    return keys_out, outs, n_groups


def groupby_batch(
    batch: ColumnBatch,
    key_names: Union[str, Sequence[str]],
    aggs: Sequence[Tuple[str, str, str]],
    mask: Optional[Array] = None,
    u32_key_order: bool = False,
) -> ColumnBatch:
    """GROUP BY over a batch. ``aggs`` = (source column, op, output name).

    Output columns: keys first (under their own names), then aggregates in
    order — the reference's layout (``groupby.fut:45-48``: output col 0 is the
    key). ``mask`` fuses a WHERE predicate into the group-by's own sort (no
    separate compaction pass). The planner handles key-position/
    duplicate-select subtleties.
    """
    if isinstance(key_names, str):
        key_names = [key_names]
    key_arrays = [batch.column(k) for k in key_names]
    agg_inputs = [
        (tuple(batch.column(s) for s in src) if isinstance(src, tuple)
         else batch.column(src), op)
        for src, op, _ in aggs
    ]
    keys_out, agg_outs, n_groups = groupby_aggregate(
        key_arrays, agg_inputs, batch.n_valid, mask=mask,
        u32_key_order=u32_key_order,
    )
    cols = dict(zip(key_names, keys_out))
    for (_, _, out_name), arr in zip(aggs, agg_outs):
        cols[out_name] = arr
    return ColumnBatch(cols, n_groups)