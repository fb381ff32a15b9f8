"""Flag-array segmented operations — the flat-data-parallel substrate.

Same contracts as the reference's vendored diku-dk/segmented 0.3.1 library
(``futhark/lib/github.com/diku-dk/segmented/segmented.fut``):

  * ``segmented_scan``  — inclusive per-segment scan        (segmented.fut:7-13)
  * ``segmented_reduce``— one value per segment             (segmented.fut:20-37)
  * ``replicated_iota`` — [2,3,1] → [0,0,1,1,1,2]           (segmented.fut:44-50)
  * ``segmented_iota``  — per-segment restart iota          (segmented.fut:58-60)
  * ``expand``          — irregular nested flattening       (segmented.fut:70-74)

Implementation notes: a generic ``lax.associative_scan`` over (flag, value)
pairs compiled pathologically slowly when this engine was first built, so
every hot path lowers to ``cumsum``/``cummax``/scatter and elementwise
passes instead (none of these costs is measured on the H100 yet):

  * segmented add-scan = global ``cumsum`` minus a per-segment base gathered
    via the segment-id (exact under int wraparound arithmetic);
  * segmented reduce = one ``jax.ops.segment_{sum,max,min,prod}`` sorted
    scatter-reduction (identity fill matches the neutral element);
  * replicated_iota's gap fill = ``lax.cummax``.

The generic pair-scan survives only as the fallback for exotic operators.
All functions follow the engine's static-shape convention: padded arrays +
valid counts (variable-size outputs return (padded_values, n_out)).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


def _generic_segmented_scan(op: Callable, flags: Array, values: Array) -> Array:
    def combine(a, b):
        af, av = a
        bf, bv = b
        return jnp.logical_or(af, bf), jnp.where(bf, bv, op(av, bv))

    _, out = jax.lax.associative_scan(combine, (flags, values))
    return out


def doubling_segmented_scan(op: Callable, sid: Array, values: Array) -> Array:
    """Inclusive segmented scan via log-step doubling (Hillis–Steele).

    ``sid`` assigns each row a segment id; rows of a segment must be
    contiguous (the caller has sorted by key). ``values`` is ``(n,)`` or
    ``(n, k)`` — columns scan independently under the shared ``sid``.

    ceil(log2 n) elementwise passes, each streaming the columns through
    device memory once; unlike ``lax.associative_scan`` over (flag, value)
    pairs it compiles cleanly (see module docstring).
    """
    n = values.shape[0]
    out = values
    d = 1
    while d < n:
        prev_sid = jnp.concatenate(
            [jnp.full((d,), -1, sid.dtype), sid[:-d]]
        )
        zeros = jnp.zeros((d,) + out.shape[1:], out.dtype)
        prev = jnp.concatenate([zeros, out[:-d]], axis=0)
        same = sid == prev_sid
        if out.ndim > 1:
            same = same[:, None]
        out = jnp.where(same, op(out, prev), out)
        d *= 2
    return out


def _segment_ids(flags: Array) -> Array:
    """0-based segment id per row; rows before the first flag are segment 0
    (element 0 is an implicit segment start, flagged or not)."""
    f = flags.astype(jnp.int32)
    return jnp.cumsum(f.at[0].set(1)) - 1


def segmented_scan(op: Callable, ne, flags: Array, values: Array) -> Array:
    """Inclusive segmented scan. ``flags[i]`` True starts a new segment at i.

    Oblivious to validity: the caller pre-masks padding to ``ne`` if needed.
    """
    flags = flags.astype(jnp.bool_)
    n = values.shape[0]

    if op in (jnp.add,):
        # cumsum-difference: out[i] = S[i] - S[start(seg_i) - 1].
        f = flags.astype(jnp.int32)
        sid = jnp.cumsum(f)                  # id shifted by +1 after each flag
        s = jnp.cumsum(values)
        prev_s = jnp.concatenate([jnp.zeros((1,), s.dtype), s[:-1]])
        target = jnp.where(flags, sid, n + 1)
        base = (
            jnp.zeros((n + 2,), s.dtype).at[target].set(prev_s, mode="drop")
        )
        return (s - base[sid]).astype(values.dtype)

    if op in (jnp.maximum, jnp.minimum, jnp.multiply):
        # Log-doubling segmented scan (Hillis–Steele over segment ids):
        # ceil(log2 n) fused elementwise passes, compiles cleanly — unlike
        # the generic (flag, value) associative_scan, which the module
        # docstring documents as pathological to compile. Exact for any
        # associative op.
        return doubling_segmented_scan(op, _segment_ids(flags), values)

    # Exotic ops only (never hit by the engine's own operators).
    return _generic_segmented_scan(op, flags, values)


_SEGMENT_OPS = None


def _segment_op_for(op: Callable):
    global _SEGMENT_OPS
    if _SEGMENT_OPS is None:
        _SEGMENT_OPS = {
            jnp.add: jax.ops.segment_sum,
            jnp.maximum: jax.ops.segment_max,
            jnp.minimum: jax.ops.segment_min,
            jnp.multiply: jax.ops.segment_prod,
        }
    return _SEGMENT_OPS.get(op)


def segmented_reduce(
    op: Callable, ne, flags: Array, values: Array, n_valid: Array | None = None
) -> Tuple[Array, Array]:
    """Per-segment reduction.

    Returns ``(out, n_segments)``: ``out`` keeps the input capacity, with
    ``out[s]`` = reduction of segment ``s`` for ``s < n_segments`` and ``ne``
    beyond. Convention (as in segmented.fut:20-37): element 0 always opens
    segment 0, flagged or not. Padding rows (index >= n_valid) are ignored.
    """
    n = values.shape[0]
    if n_valid is None:
        n_valid = jnp.int32(n)
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < n_valid

    f = flags.astype(jnp.int32).at[0].set(1)
    f = jnp.where(valid, f, 0)
    seg_ids = jnp.cumsum(f) - 1                      # 0-based; padding → last
    n_segments = jnp.where(
        n_valid > 0, seg_ids[jnp.maximum(n_valid - 1, 0)] + 1, 0
    ).astype(jnp.int32)

    target = jnp.where(valid, seg_ids, n)            # n → dropped
    seg_fn = _segment_op_for(op)
    if seg_fn is not None:
        out = seg_fn(
            values, target, num_segments=n, indices_are_sorted=True
        )
        # Identity fill of segment_{max,min,prod,sum} equals ne for the
        # corresponding op; mask anyway for exactness beyond n_segments.
        out = jnp.where(idx < n_segments, out, jnp.asarray(ne, out.dtype))
        return out.astype(values.dtype), n_segments

    # Generic fallback: inclusive scan, pick segment ends.
    values_m = jnp.where(valid, values, ne)
    scanned = _generic_segmented_scan(op, f > 0, values_m)
    next_f = jnp.concatenate([f[1:], jnp.zeros((1,), jnp.int32)])
    is_end = valid & ((next_f > 0) | (idx == n_valid - 1))
    tgt = jnp.where(is_end, seg_ids, n)
    out = jnp.full((n,), ne, dtype=scanned.dtype).at[tgt].set(
        scanned, mode="drop"
    )
    return out, n_segments


def replicated_iota(
    reps: Array, out_capacity: int, n_valid: Array | None = None
) -> Tuple[Array, Array]:
    """[2,3,1] → [0,0,1,1,1,2]  (segmented.fut:44-50).

    ``reps`` is padded; ``n_valid`` counts live entries. Returns
    ``(ids, total)``; ids beyond ``total`` are padded with ``len(reps)``
    (a harmless gather target for pre-padded sources). Zero-length segments
    are skipped correctly (their ids never appear).
    """
    n = reps.shape[0]
    if n_valid is None:
        n_valid = jnp.int32(n)
    valid = jnp.arange(n, dtype=jnp.int32) < n_valid
    reps = jnp.where(valid, reps, 0).astype(jnp.int32)
    offsets = jnp.cumsum(reps) - reps                # exclusive scan
    total = jnp.sum(reps).astype(jnp.int32)

    # Scatter (segment_id + 1) with MAX at each segment's start offset, then
    # a running max fills the gaps. Empty segments collide on the next
    # segment's offset; max keeps the right (largest) id. Offsets are
    # monotone (cumsum), valid rows whose offset overflows the capacity
    # (the documented truncation case) clamp to the same end sentinel the
    # invalid tail targets, so the scatter indices stay sorted — declared
    # to XLA for the cheaper sorted-scatter lowering.
    seg_idx = jnp.arange(n, dtype=jnp.int32)
    target = jnp.where(
        valid, jnp.minimum(offsets, out_capacity), out_capacity
    )
    markers = (
        jnp.zeros((out_capacity,), dtype=jnp.int32)
        .at[target]
        .max(seg_idx + 1, mode="drop", indices_are_sorted=True)
    )
    ids = jax.lax.cummax(markers, axis=0) - 1
    ids = jnp.maximum(ids, 0)
    out_valid = jnp.arange(out_capacity, dtype=jnp.int32) < total
    ids = jnp.where(out_valid, ids, n)
    return ids, total


def segmented_iota(flags: Array) -> Array:
    """Per-segment restarting iota: [F,F,T,F] → [0,1,0,1] (segmented.fut:58-60).

    ``idx - cummax(flagged positions)``: segment-start positions are
    monotone, so a running max forward-fills each row's segment start — one
    cummax instead of the add-scan's scatter. Rows before the first flag restart at 0 (position 0 acts as
    an implicit start, matching the reference contract).
    """
    n = flags.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    start = jax.lax.cummax(jnp.where(flags.astype(jnp.bool_), idx, 0))
    return idx - start


def expand(
    sizes: Array,
    get: Callable[[Array, Array], Array],
    out_capacity: int,
    n_valid: Array | None = None,
) -> Tuple[Array, Array]:
    """Irregular flattening (segmented.fut:70-74).

    ``sizes[i]`` elements are produced for source row i; ``get(src_ids, locals)``
    is applied vectorized over the flat output (src index + position within its
    segment). Returns ``(out, total)`` padded to ``out_capacity``. Padding rows
    of the output call ``get`` with src index ``len(sizes)`` — callers using
    gathers should pad their source arrays by one slot or rely on clip/drop.
    """
    seg_ids, total = replicated_iota(sizes, out_capacity, n_valid)
    out_idx = jnp.arange(out_capacity, dtype=jnp.int32)
    starts = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), seg_ids[1:] != seg_ids[:-1]]
    )
    local = segmented_iota(starts)
    local = jnp.where(out_idx < total, local, 0)
    safe_ids = jnp.minimum(seg_ids, sizes.shape[0] - 1)
    out = get(safe_ids, local)
    return out, total


def expand_reduce(
    sizes: Array,
    get: Callable[[Array, Array], Array],
    op: Callable,
    ne,
    out_capacity: int,
    n_valid: Array | None = None,
) -> Tuple[Array, Array]:
    """``expand`` then reduce each source row's produced elements back to one
    value (segmented.fut:84-91): out[i] = op-fold of get(i, 0..sizes[i]-1).

    Rows with ``sizes[i] == 0`` yield ``ne`` (the reference composes
    ``expand`` with ``segmented_reduce`` the same way). Returns
    ``(out, n_rows)`` with ``out`` padded to the sizes capacity.
    """
    n = sizes.shape[0]
    if n_valid is None:
        n_valid = jnp.int32(n)
    seg_ids, total = replicated_iota(sizes, out_capacity, n_valid)
    out_idx = jnp.arange(out_capacity, dtype=jnp.int32)
    live = out_idx < total
    starts = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), seg_ids[1:] != seg_ids[:-1]]
    )
    local = jnp.where(live, segmented_iota(starts), 0)
    safe_ids = jnp.minimum(seg_ids, n - 1)
    vals = get(safe_ids, local)
    target = jnp.where(live, safe_ids, n)
    seg_fn = _segment_op_for(op)
    if seg_fn is not None:
        red = seg_fn(vals, target, num_segments=n)
    else:  # exotic op: scan fallback over the expanded array
        scanned = _generic_segmented_scan(
            op, starts, jnp.where(live, vals, ne)
        )
        next_start = jnp.concatenate(
            [starts[1:], jnp.ones((1,), jnp.bool_)]
        )
        is_end = live & next_start
        red = jnp.full((n,), ne, dtype=scanned.dtype).at[
            jnp.where(is_end, safe_ids, n)
        ].set(scanned, mode="drop")
    valid_row = jnp.arange(n, dtype=jnp.int32) < n_valid
    out = jnp.where(valid_row & (sizes > 0), red, jnp.asarray(ne, red.dtype))
    return out, n_valid


def expand_outer_reduce(
    sizes: Array,
    get: Callable[[Array, Array], Array],
    op: Callable,
    ne,
    out_capacity: int,
    n_valid: Array | None = None,
) -> Tuple[Array, Array]:
    """Like :func:`expand_reduce` but folds ``ne`` in as the initial element.

    The reference prepends ``ne`` to every segment (segmented.fut:97-103:
    ``sz' = sz+1``, ``get' x 0 = ne``), so a non-empty row yields
    ``op(ne, reduce(elems))`` — observable when ``ne`` is not a true identity
    of ``op`` — while an empty row's segment is the singleton ``[ne]``,
    i.e. ``ne`` unfolded (tests/test_prims.py pins both against the
    reference's contract).
    """
    red, nv = expand_reduce(sizes, get, op, ne, out_capacity, n_valid)
    n = sizes.shape[0]
    valid_row = jnp.arange(n, dtype=jnp.int32) < nv
    ne_arr = jnp.asarray(ne, red.dtype)
    folded = op(jnp.full_like(red, ne_arr), red)
    out = jnp.where(valid_row & (sizes > 0), folded, ne_arr)
    return out, nv
