"""Equi-join (reference semantics: ``join.fut:52-75``, never exported there).

Reference ordering contract (SURVEY §3.5): output sorted ascending by key;
within a key, left rows in original order, each paired with every matching
right row in original order; output columns = [left cols | right cols]
(``join.fut:74-75``). Keys present on one side only emit nothing (inner join);
LEFT JOIN keeps unmatched left rows with zero-filled right columns.

The design does ONE concat sort and keeps gathers few:

  1. **Ranges** (:func:`compute_join_ranges`): both sides concatenated and
     sorted ONCE by (key, side) with side ordering rights before lefts
     within each key run — the reference's tag-and-sort idea
     (``join.fut:55-58``) vectorized. Per sorted-left row, the match count
     is a cumsum difference and the match start ``lo`` a cummax-filled run
     base. Output columns ride the same sort as payload, and the
     sorted-left / sorted-right splits are stable compactions
     (``prims/compaction.py``). Both join totals (inner and left) come out
     of this single pass — the planner's count phase reuses the SAME device
     arrays for materialization instead of recomputing
     (count-then-materialize without the double work).
  2. **Materialization** (:func:`join_batches` / :func:`join_indices`):
     pair expansion by ``replicated_iota`` (a sorted scatter of segment
     markers + a running max), then ONE stacked gather of the left columns
     together with each segment's match count and start.

No sequential per-key loop (the reference's biggest algorithmic weakness,
``join.fut:67-68``) and no binary search. Static shapes: materialization
takes ``out_capacity`` decided by the planner from the count phase
(SURVEY §7 hard part 1).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from harkdb_tpu.columnar.batch import ColumnBatch
from harkdb_tpu.ops.sort import _pad_to_max
from harkdb_tpu.prims.compaction import compact_arrays
from harkdb_tpu.prims.segmented import replicated_iota, segmented_iota

Array = jax.Array


class JoinRanges(NamedTuple):
    """Single-pass join state, reused by count AND materialize phases.

    Arrays are in sorted coordinates: index i of the ``l_*`` arrays is the
    i-th live left row in (key, original-order) sorted order (first
    ``n_lefts`` entries live), likewise ``r_*`` for right rows.
    """

    l_orig: Array          # (nl,) original left row per sorted-left position
    counts: Array          # (nl,) right matches (0 past live)
    lo: Array              # (nl,) first matching sorted-right position
    l_payload: Tuple[Array, ...]   # carried left columns, sorted-left order
    r_orig: Array          # (nr,) original right row per sorted-right pos
    r_payload: Tuple[Array, ...]   # carried right columns, sorted-right order
    n_lefts: Array         # live left rows
    total: Array           # inner-join pair count
    total_left: Array      # LEFT-join row count (unmatched lefts emit 1)
    r_matched: object = None   # (nr,) bool: right row has a left match
    #                            (FULL-OUTER ranges only, need_full=True)
    total_full: object = None  # total_left + unmatched right rows
    total_approx: object = None  # float32 pair total — int32 wrap guard


def compute_join_ranges(
    l_key, n_l: Array, r_key, n_r: Array,
    l_cols: Sequence[Array] = (), r_cols: Sequence[Array] = (),
    l_null: Array | None = None, r_null: Array | None = None,
    need_full: bool = False,
) -> JoinRanges:
    """One concat sort + two compactions → everything a join needs.

    ``l_key``/``r_key`` may be single arrays or LISTS of equal-length key
    arrays (multi-key equi-join: rows match when every key is equal —
    lexicographic runs of the multi-operand sort; the reference kernel is
    single-key, ``join.fut:52-75``).

    ``l_null``/``r_null`` optionally mark rows whose key tuple is SQL NULL
    (three-valued logic: NULL matches nothing, not even another NULL).
    Implemented with one extra int32 sort operand: a nullcode (0 = valid,
    1 = null right, 2 = null left) that splits null rows into their own
    runs — no sentinel key values, so no collision with real data.

    ``need_full=True`` additionally computes per-right-row match flags and
    the FULL-OUTER row total (a reversed cummax fills each run's left-count
    back over its rights — scatter-free like everything else here).
    """
    l_keys = list(l_key) if isinstance(l_key, (list, tuple)) else [l_key]
    r_keys = list(r_key) if isinstance(r_key, (list, tuple)) else [r_key]
    nl, nr = l_keys[0].shape[0], r_keys[0].shape[0]
    assert nl < (1 << 30) and nr < (1 << 30), "row capacity >= 2^30"
    n = nl + nr
    # Pads → dtype max so they cluster at the back. Rights are concatenated
    # BEFORE lefts, so the stable key-only sort orders rights before lefts
    # within every key run — the explicit `side` operand of the naive
    # formulation rides for free in the concat order, one sort operand
    # fewer. Side/pad flags travel as 2 tag bits on the carried row index
    # (capacities are < 2^30).
    l_idx = jnp.arange(nl, dtype=jnp.int32)
    r_idx = jnp.arange(nr, dtype=jnp.int32)
    keys = [
        jnp.concatenate([_pad_to_max(rk, n_r), _pad_to_max(lk, n_l)])
        for lk, rk in zip(l_keys, r_keys)
    ]
    nkeys = len(keys)
    if l_null is not None or r_null is not None:
        lnc = (jnp.where(l_null, 2, 0).astype(jnp.int32)
               if l_null is not None else jnp.zeros((nl,), jnp.int32))
        rnc = (jnp.where(r_null, 1, 0).astype(jnp.int32)
               if r_null is not None else jnp.zeros((nr,), jnp.int32))
        keys.append(jnp.concatenate([rnc, lnc]))
    left_bit = jnp.int32(1 << 30)
    pad_bit = jnp.int32(-(1 << 31))            # bit 31 as int32
    l_tag = l_idx | left_bit | jnp.where(l_idx >= n_l, pad_bit, 0)
    r_tag = r_idx | jnp.where(r_idx >= n_r, pad_bit, 0)
    orig_tagged = jnp.concatenate([r_tag, l_tag])
    payload = [
        jnp.concatenate([jnp.zeros((nr,), c.dtype), c]) for c in l_cols
    ] + [
        jnp.concatenate([c, jnp.zeros((nl,), c.dtype)]) for c in r_cols
    ]

    nsort = len(keys)
    sorted_all = jax.lax.sort(
        keys + [orig_tagged] + payload, num_keys=nsort, is_stable=True
    )
    skeys = sorted_all[:nsort]
    stag = sorted_all[nsort]
    spay = sorted_all[nsort + 1:]
    # side code from the tag bits: 0 = live right, 1 = live left, else pad.
    side_code = jax.lax.shift_right_logical(
        stag.astype(jnp.uint32), jnp.uint32(30)
    ).astype(jnp.int32)
    sorig = stag & jnp.int32((1 << 30) - 1)

    pos = jnp.arange(n, dtype=jnp.int32)
    is_right = (side_code == 0).astype(jnp.int32)
    is_left = side_code == 1

    # Key-run starts (any key operand changes — the nullcode operand counts
    # too, isolating null rows in matchless runs); within-run inclusive
    # right count via cumsum difference.
    run_start = pos == 0
    for skey in skeys:
        prev = jnp.concatenate([skey[:1], skey[:-1]])
        run_start = run_start | (skey != prev)
    r_cum = jnp.cumsum(is_right)                       # inclusive rights so far
    # Base = rights before this run = r_excl at my run's start. r_excl is
    # non-decreasing, so a running max over values marked at run starts
    # forward-fills it — no scatter, no gather.
    r_excl = r_cum - is_right
    base = jax.lax.cummax(jnp.where(run_start, r_excl, 0))
    rights_in_run_so_far = r_cum - base                # incl. me if right

    # For a LEFT row, every right of its run precedes it → its match count is
    # rights_in_run_so_far and its lo is base.
    counts_sorted = jnp.where(is_left, rights_in_run_so_far, 0)
    total = jnp.sum(counts_sorted).astype(jnp.int32)
    total_left = jnp.sum(
        jnp.where(is_left, jnp.maximum(counts_sorted, 1), 0)
    ).astype(jnp.int32)
    # int32 overflow sentinel: a 65536² CROSS JOIN sums to exactly 2^32 →
    # total wraps to 0 and the planner would silently size an empty
    # result. int64 is unavailable (x64 off), so an approximate float32
    # total guards the exact one — anything near/above 2^31 pairs is
    # unmaterializable anyway and must be a clear error, not a wrap.
    total_approx = jnp.sum(counts_sorted.astype(jnp.float32))

    r_matched_sorted = None
    total_full = None
    if need_full:
        # A right row is matched iff its run contains any live left. Lefts
        # follow rights within a run, so fill each run's TOTAL left count
        # backward: reversed cummax of per-run left-exclusive prefixes.
        il = is_left.astype(jnp.int32)
        l_cum = jnp.cumsum(il)
        l_excl = l_cum - il
        lbase = jax.lax.cummax(jnp.where(run_start, l_excl, 0))
        # Lefts in MY whole run = (l_excl at the next run start strictly
        # after me) − my run's base. l_excl is non-decreasing, so a
        # reversed cummin over run-start-marked values finds the next run
        # start at-or-after each position; shift by one for "strictly
        # after", clamping the final run to the global left total.
        big = jnp.int32(n + 1)
        at_or_after = jnp.flip(jax.lax.cummin(jnp.flip(
            jnp.where(run_start, l_excl, big)
        )))
        nxt = jnp.concatenate([at_or_after[1:], big[None]])
        nxt = jnp.minimum(nxt, l_cum[-1])
        total_lefts_in_run = nxt - lbase
        r_matched_sorted = (is_right > 0) & (total_lefts_in_run > 0)
        n_r_unmatched = jnp.sum(
            ((is_right > 0) & jnp.logical_not(r_matched_sorted))
            .astype(jnp.int32)
        )
        total_full = total_left + n_r_unmatched

    # Stable compactions back to per-side coordinates. counts drives
    # expansion sizes downstream, so its tail past the live count is 0.
    nn = jnp.int32(n)
    nlc = len(l_cols)
    l_split, n_lefts = compact_arrays(
        [sorig, counts_sorted, base] + list(spay[:nlc]), is_left, nn,
    )
    l_orig, cl, lo = (a[:nl] for a in l_split[:3])
    counts = jnp.where(l_idx < n_lefts, cl, 0)
    l_payload = tuple(a[:nl] for a in l_split[3:])

    r_extra = (
        [r_matched_sorted.astype(jnp.int32)] if need_full else []
    )
    r_split, n_rights = compact_arrays(
        [sorig] + r_extra + list(spay[nlc:]), is_right > 0, nn,
    )
    r_orig = r_split[0][:nr]
    if need_full:
        r_matched = jnp.where(
            r_idx < n_rights, r_split[1][:nr] > 0, True
        )               # pads count as "matched" (never appended)
        r_payload = tuple(a[:nr] for a in r_split[2:])
    else:
        r_matched = None
        r_payload = tuple(a[:nr] for a in r_split[1:])

    return JoinRanges(
        l_orig, counts, lo, l_payload, r_orig, r_payload,
        n_lefts, total, total_left, r_matched, total_full, total_approx,
    )


def join_match_count(
    l_key, n_l: Array, r_key, n_r: Array, kind: str = "inner",
    l_null: Array | None = None, r_null: Array | None = None,
) -> Array:
    """Exact number of output rows (device scalar) — the count phase.

    LEFT JOIN emits one row for every unmatched left row, so its count is
    ``sum(max(matches, 1))`` over live left rows; FULL OUTER additionally
    counts unmatched right rows.
    """
    rng = compute_join_ranges(
        l_key, n_l, r_key, n_r,
        l_null=l_null, r_null=r_null,
        need_full=kind == "full",
    )
    if kind == "left":
        return rng.total_left
    if kind == "full":
        return rng.total_full
    return rng.total


def _stacked_gather(arrays: Sequence[Array], idx: Array,
                    indices_are_sorted: bool = False):
    """Gather k same-length columns by ONE index array: every column is
    bitcast to int32 and stacked into one gather. The stacking saves
    per-gather fixed overhead, not per-column traffic, so callers keep k
    minimal."""
    arrays = list(arrays)
    if not arrays:
        return []
    if len(arrays) == 1:
        return [arrays[0].at[idx].get(indices_are_sorted=indices_are_sorted)]
    bits = [
        a if a.dtype == jnp.int32
        else jax.lax.bitcast_convert_type(a, jnp.int32)
        for a in arrays
    ]
    g = jnp.stack(bits, axis=1).at[idx].get(
        indices_are_sorted=indices_are_sorted
    )
    out = []
    for j, a in enumerate(arrays):
        col = g[:, j]
        if a.dtype != jnp.int32:
            col = jax.lax.bitcast_convert_type(col, a.dtype)
        out.append(col)
    return out


def _pair_slots(
    rng: JoinRanges, out_capacity: int, kind: str,
    l_value_cols: Sequence[Array],
):
    """Pair expansion + the left-side value gather.

    Returns ``(l_vals, r_pos, live, matched, total)`` per output slot:
    the gathered ``l_value_cols`` (arrays in sorted-left coordinates), the
    matching sorted-right position (0 where unmatched), and flags.
    Expansion is scatter+cummax ``replicated_iota``; one stacked gather
    carries each segment's counts/lo alongside the values.

    """
    counts, n_lefts = rng.counts, rng.n_lefts
    nl = counts.shape[0]
    l_idx = jnp.arange(nl, dtype=jnp.int32)
    if kind in ("left", "full"):
        # FULL OUTER's left-preserving part IS a left join; the unmatched
        # right rows append after it (join_batches).
        emit = jnp.where(l_idx < n_lefts, jnp.maximum(counts, 1), 0)
        total = rng.total_left
    elif kind == "inner":
        emit = counts
        total = rng.total
    else:
        raise ValueError(f"Unsupported join kind {kind!r}")
    out_idx = jnp.arange(out_capacity, dtype=jnp.int32)

    seg_ids, _ = replicated_iota(emit, out_capacity)
    live = out_idx < total
    safe_seg = jnp.where(live, jnp.minimum(seg_ids, nl - 1), 0)
    starts = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), seg_ids[1:] != seg_ids[:-1]]
    )
    local = segmented_iota(starts)
    g = _stacked_gather(
        [counts, rng.lo] + list(l_value_cols), safe_seg,
        indices_are_sorted=True,
    )
    seg_counts, seg_lo = g[0], g[1]
    matched = live & (local < seg_counts)
    r_pos = jnp.where(matched, seg_lo + local, 0)
    return g[2:], r_pos, live, matched, total


def join_indices(
    l_key: Array,
    n_l: Array,
    r_key: Array,
    n_r: Array,
    out_capacity: int,
    kind: str = "inner",
) -> Tuple[Array, Array, Array, Array]:
    """Materialize pair indices ``(l_idx, r_idx, matched, total)`` padded to
    capacity.

    ``l_idx``/``r_idx`` index the *original* (unsorted) rows of each side.
    ``matched`` is False on LEFT-JOIN rows with no right match (their right
    columns are filled with 0 — the engine has no NULLs, like the reference's
    homogeneous numeric tables). Entries past ``total`` point at row 0
    (harmless gather targets). If ``total > out_capacity`` the result is
    truncated — the planner prevents this by sizing capacity from
    :func:`join_match_count`.
    """
    rng = compute_join_ranges(l_key, n_l, r_key, n_r)
    l_vals, r_pos, live, matched, total = _pair_slots(
        rng, out_capacity, kind, [rng.l_orig]
    )
    l_out = jnp.where(live, l_vals[0], 0)
    (r_out,) = _stacked_gather(
        [rng.r_orig], jnp.minimum(r_pos, rng.r_orig.shape[0] - 1)
    )
    r_out = jnp.where(matched, r_out, 0)
    return l_out, r_out, matched, total


def inner_join_indices(
    l_key: Array, n_l: Array, r_key: Array, n_r: Array, out_capacity: int
) -> Tuple[Array, Array, Array]:
    """Inner-join pair indices ``(l_idx, r_idx, total)`` (see join_indices)."""
    l_idx, r_idx, _, total = join_indices(
        l_key, n_l, r_key, n_r, out_capacity, "inner"
    )
    return l_idx, r_idx, total


def join_batches(
    left: ColumnBatch | None,
    right: ColumnBatch | None,
    l_key_name,
    r_key_name,
    out_capacity: int,
    l_out: Dict[str, str] | None = None,
    r_out: Dict[str, str] | None = None,
    kind: str = "inner",
    ranges: JoinRanges | None = None,
    matched_out: str | None = None,
    l_matched_out: str | None = None,
    l_null: Array | None = None,
    r_null: Array | None = None,
) -> ColumnBatch:
    """Equi-join of two batches (inner, left, or full outer; RIGHT JOIN is
    the planner's operand swap of LEFT).

    ``l_out``/``r_out`` map source column → output name (projection + rename,
    defaulting to all columns under their own names). Output column order is
    [left cols | right cols] per the reference (``join.fut:74-75``). Outer
    joins fill the missing side's columns with 0 and mark the rows via the
    hidden flag columns (NULL model — plan/nulls.py).

    ``ranges`` optionally supplies a precomputed :func:`compute_join_ranges`
    result WITH matching payload columns (l_out/r_out keys order) — the
    planner passes the count phase's ranges so the concat sort runs once
    per join, not twice; ``left``/``right`` may then be None (everything
    needed already rides the ranges) but ``l_out``/``r_out`` must be given
    explicitly — they define the ranges' payload column order. FULL OUTER
    requires ranges computed with ``need_full=True``.

    ``matched_out`` optionally names an extra int32 0/1 output column: 1
    where the RIGHT side is present (0 on left-preserved no-match rows) —
    the hidden NULL indicator for right-side columns. ``l_matched_out``
    (FULL OUTER) likewise marks LEFT-side presence (0 only on the appended
    unmatched right rows).
    """
    if ranges is None:
        l_out = l_out if l_out is not None else {n: n for n in left.names}
        r_out = r_out if r_out is not None else {n: n for n in right.names}
        l_keys = ([l_key_name] if isinstance(l_key_name, str)
                  else list(l_key_name))
        r_keys = ([r_key_name] if isinstance(r_key_name, str)
                  else list(r_key_name))
        ranges = compute_join_ranges(
            [left.column(k) for k in l_keys], left.n_valid,
            [right.column(k) for k in r_keys], right.n_valid,
            l_cols=[left.column(s) for s in l_out],
            r_cols=[right.column(s) for s in r_out],
            l_null=l_null, r_null=r_null,
            need_full=kind == "full",
        )
    elif l_out is None or r_out is None:
        raise ValueError(
            "join_batches: explicit l_out/r_out are required when a "
            "precomputed ranges is supplied (its payload column order is "
            "defined by them)"
        )
    l_vals, r_pos, live, matched, total = _pair_slots(
        ranges, out_capacity, kind, list(ranges.l_payload)
    )
    nr = ranges.r_orig.shape[0]
    r_gathered = _stacked_gather(
        list(ranges.r_payload), jnp.minimum(r_pos, nr - 1)
    )

    cols = {}
    for dst, col in zip(l_out.values(), l_vals):
        cols[dst] = jnp.where(live, col, 0)
    zero_right = kind in ("left", "full")
    for dst, col in zip(r_out.values(), r_gathered):
        cols[dst] = jnp.where(matched if zero_right else live, col, 0)
    if matched_out is not None:
        cols[matched_out] = matched.astype(jnp.int32)

    if kind == "full":
        # Append the unmatched right rows after the left-preserving part:
        # compact them, then blend by output position — the appended block
        # starts at the left part's total.
        if ranges.r_matched is None:
            raise ValueError(
                "FULL OUTER join requires ranges computed with "
                "need_full=True"
            )
        um = jnp.logical_not(ranges.r_matched)
        packed, n_um = compact_arrays(
            list(ranges.r_payload), um, jnp.int32(nr),
        )
        total_full = ranges.total_full
        out_idx = jnp.arange(out_capacity, dtype=jnp.int32)
        app = (out_idx >= total) & (out_idx < total_full)
        j = jnp.clip(out_idx - total, 0, nr - 1)
        app_vals = _stacked_gather(list(packed), j)
        for dst, av in zip(r_out.values(), app_vals):
            cols[dst] = jnp.where(app, av, cols[dst])
        for dst in l_out.values():
            cols[dst] = jnp.where(app, 0, cols[dst])
        if matched_out is not None:
            cols[matched_out] = jnp.where(
                app, 1, cols[matched_out]
            ).astype(jnp.int32)
        if l_matched_out is not None:
            cols[l_matched_out] = jnp.where(
                (out_idx < total_full) & jnp.logical_not(app), 1, 0
            ).astype(jnp.int32)
        return ColumnBatch(cols, total_full)

    if l_matched_out is not None:
        cols[l_matched_out] = live.astype(jnp.int32)
    return ColumnBatch(cols, total)
