"""Distributed GLOBAL window functions (empty PARTITION BY) — round-4
verdict item 3.

``dist_window`` handles a global window by routing every row to shard 0
(nothing to hash on), which funnels the whole table through one device.
But a global running SUM/COUNT/rank IS parallelizable — it is the
distributed analog of a sequential scan's carry chain, lifted one
level:

  1. ``dist_orderby`` puts rows in the window's global order (ORDER BY
     keys, tie-broken by the hidden row ids exactly like the single-chip
     sort); shard i then holds the i-th contiguous range, and tie runs
     never span shards (rows equal on the routing key land together).
  2. ONE ``shard_map`` pass computes each shard's LOCAL window values with
     the same machinery as the single-chip path (positional arithmetic,
     segmented scans over tie runs, reversed take-first peer broadcast),
     plus a small all_gather of per-shard scalars (row count, run count,
     value totals, first value) whose prefix over shards < i is the carry
     folded into the local values.

Per-device memory stays at ~live/D and the collective footprint is the
orderby shuffle + one (D, k)-scalar all_gather. Integer results are
bit-identical to single-chip; float running sums may differ in final bits
(the carry changes float addition order — documented in README).

Supported: row_number / rank / dense_rank / count / sum / min / max /
prod / avg / first_value / last_value, plus lag/lead via a (D, off)
edge-row halo exchange (offsets beyond 1024, and explicit bounded ROWS
frames, fall back to the shard-0 route ``dist_ops.dist_window``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from harkdb_tpu.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu.parallel.sharded import ShardedBatch
from harkdb_tpu.plan.expr import eval_expr
from harkdb_tpu.prims.segmented import doubling_segmented_scan

Array = jax.Array

GLOBAL_FUNCS = {
    "row_number", "rank", "dense_rank", "count", "sum", "min", "max",
    "prod", "avg", "first_value", "last_value", "lag", "lead",
    "ntile", "percent_rank", "cume_dist",
}

_SCAN = {"sum": jnp.add, "prod": jnp.multiply,
         "max": jnp.maximum, "min": jnp.minimum}

# lag/lead cross shard boundaries via a (D, off) halo exchange of each
# shard's edge rows; cap the halo width (larger offsets fall back).
_HALO_MAX = 1024


def supports_global(specs: Sequence[Tuple]) -> bool:
    """Carry-path eligibility: explicit ROWS frames fall back to the
    shard-0 route (a bounded frame spans shard boundaries); so do
    lag/lead offsets beyond the halo cap."""
    for s in specs:
        if s[1] not in GLOBAL_FUNCS:
            return False
        if len(s) > 7 and s[7] is not None:
            return False
        if s[1] in ("lag", "lead"):
            off = s[6][0] if s[6] else 1
            if off > _HALO_MAX:
                return False
    return True


def dist_global_window(
    work: ShardedBatch,
    specs: Sequence[Tuple],
    mesh: Mesh,
    config: EngineConfig = DEFAULT_CONFIG,
    tie_names: Sequence[str] | None = None,
    jit_cache=None,
) -> ShardedBatch:
    """Compute one empty-PARTITION BY window shape's outputs, sharded.

    ``specs`` entries are the planner's window specs
    ``(out, func, arg, parts, oexprs, descs, params)`` with ``parts`` empty
    and identical ``(oexprs, descs)`` across entries.
    """
    from harkdb_tpu.ops.sort import _descending_transform
    from harkdb_tpu.parallel.dist_ops import dist_orderby

    axis = config.mesh_axis
    D = mesh.devices.size
    cfg = config
    _out0, _f0, _a0, _p0, oexprs, descs, *_rest0 = specs[0]
    oexprs, descs = list(oexprs), list(descs)

    # ---- stage 1: global order (ORDER BY keys + deterministic tie) -------
    # default tie = hidden row ids; grouped callers pass the exec group
    # keys instead (their rows ARE groups — ids were consumed by grouping)
    rid_names = (list(tie_names) if tie_names is not None
                 else [n for n in work.names if n.startswith("#rid.")])

    if oexprs or rid_names:
        def keys_fn(cols, cap):
            ks = [eval_expr(oe, cols, cap, cfg) for oe in oexprs]
            ks += [cols[n] for n in rid_names]
            return ks

        work = dist_orderby(
            work, keys_fn, descs + [False] * len(rid_names), mesh, cfg,
            jit_cache=jit_cache, tag="gwin_ob",
        )

    # ---- stage 2: local windows + carry exchange -------------------------
    C = work.local_capacity
    win_names = [s[0] for s in specs]
    out_names = list(work.names) + [
        n for n in win_names if n not in work.names
    ]

    def body(cols, cnt):
        n_local = cnt[0]
        idx = jnp.arange(C, dtype=jnp.int32)
        valid = idx < n_local

        order_arrays = []
        for oe, d in zip(oexprs, descs):
            a = eval_expr(oe, cols, C, cfg)
            order_arrays.append(_descending_transform(a) if d else a)

        o_changed = jnp.zeros((C,), jnp.bool_)
        for k in order_arrays:
            prev = jnp.concatenate([k[:1], k[:-1]])
            o_changed = o_changed | (k != prev)
        is_tstart = valid & ((idx == 0) | o_changed)
        run_id = jnp.cumsum(is_tstart.astype(jnp.int32)) - 1
        safe_run = jnp.where(valid, run_id, jnp.int32(1 << 30))

        def peers_last(S):
            rev_sid = jnp.flip(jnp.int32(1 << 30) - safe_run)
            first = doubling_segmented_scan(
                lambda cur, prev: prev, rev_sid, jnp.flip(S)
            )
            return jnp.flip(first)

        def pscan(opname, x):
            # one segment per shard (padding isolated via safe sid)
            sid = jnp.where(valid, jnp.int32(0), jnp.int32(1))
            return doubling_segmented_scan(_SCAN[opname], sid, x)

        # Per-shard scalars → (D,) gathers; prefix over shards < me = carry.
        i = jax.lax.axis_index(axis).astype(jnp.int32)
        before = jnp.arange(D, dtype=jnp.int32) < i
        rows_g = jax.lax.all_gather(
            n_local.reshape(1), axis, axis=0, tiled=True
        )
        carry_rows = jnp.sum(jnp.where(before, rows_g, 0)).astype(jnp.int32)
        n_runs = jnp.sum(is_tstart.astype(jnp.int32))
        runs_g = jax.lax.all_gather(
            n_runs.reshape(1), axis, axis=0, tiled=True
        )
        carry_runs = jnp.sum(jnp.where(before, runs_g, 0)).astype(jnp.int32)

        from harkdb_tpu.ops.groupby import _neutral_py

        def shard_combine(x, opname, all_shards: bool):
            """op-combine of live x over shards BEFORE me (the carry) or
            over ALL shards (no-ORDER-BY totals)."""
            ne = jnp.asarray(_neutral_py(opname, x.dtype), x.dtype)
            masked = jnp.where(valid, x, ne)
            red = {"sum": jnp.sum, "prod": jnp.prod,
                   "max": jnp.max, "min": jnp.min}[opname]
            local_tot = red(masked).reshape(1)
            g = jax.lax.all_gather(local_tot, axis, axis=0, tiled=True)
            if not all_shards:
                g = jnp.where(before, g, ne)
            return red(g)

        # First/last live value across shards: gather each shard's edge
        # value, pick the first/last nonempty shard.
        def global_edge(x, last: bool):
            ev = x[jnp.maximum(n_local - 1, 0) if last else 0].reshape(1)
            eg = jax.lax.all_gather(ev, axis, axis=0, tiled=True)
            ng = (rows_g > 0).astype(jnp.int32)
            if last:
                pick = (D - 1) - jnp.argmax(jnp.flip(ng))
            else:
                pick = jnp.argmax(ng)
            return eg[pick]

        has_order = bool(oexprs)
        total_rows = jnp.sum(rows_g).astype(jnp.int32)
        out = dict(cols)
        pos = idx                                   # local 0-based position
        for (out_name, func, arg, _p, _oe, _ds, params, *_r) in specs:
            x = None
            if arg is not None:
                x = eval_expr(arg, cols, C, cfg)
            # Without ORDER BY every row is a peer of every row (the SQL
            # default frame covers the whole "partition" = the whole
            # table): values are global totals / edges, rank degenerates
            # to 1. Tie runs then DO span shards, so the carry formulas
            # below only apply when an ORDER BY exists (where dist_orderby
            # guarantees runs are shard-local).
            if func in ("lag", "lead"):
                # Cross-shard neighbor via an edge-row halo: every needed
                # global position P (within `off` of my block's boundary)
                # lies inside SOME other shard's first/last-`off` window —
                # if that shard holds fewer than `off` rows, its window IS
                # the whole shard, so coverage is complete for any off up
                # to the _HALO_MAX cap (supports_global gates larger
                # offsets to the shard-0 fallback). NEVER clamp `off` to
                # the local capacity: that silently computes a SMALLER lag
                # (round-4 advisor finding, confirmed repro at off=600 on
                # 128-row shards).
                off = int(params[0]) if params else 1
                dflt = jnp.asarray(
                    params[1] if len(params) > 1 else 0, x.dtype
                )
                t = jnp.arange(off, dtype=jnp.int32)
                prefixes = jnp.cumsum(rows_g) - rows_g          # (D,)
                gp = carry_rows + idx                 # my rows' global pos
                if func == "lag":
                    edge_idx = n_local - off + t      # my TAIL rows
                    ev = x[jnp.clip(edge_idx, 0, C - 1)]
                    evalid = edge_idx >= 0
                    pos_mat = (prefixes[:, None] + rows_g[:, None]
                               - off + t[None, :])
                    shard_ok = jnp.arange(D, dtype=jnp.int32)[:, None] < i
                    targets = carry_rows - off + t    # (off,) needed pos
                else:
                    edge_idx = t                      # my HEAD rows
                    ev = x[jnp.clip(edge_idx, 0, C - 1)]
                    evalid = edge_idx < n_local
                    pos_mat = prefixes[:, None] + t[None, :]
                    shard_ok = jnp.arange(D, dtype=jnp.int32)[:, None] > i
                    targets = carry_rows + n_local + t
                EV = jax.lax.all_gather(ev, axis, axis=0, tiled=True) \
                    .reshape(D, off)
                EVal = jax.lax.all_gather(
                    evalid, axis, axis=0, tiled=True
                ).reshape(D, off)
                ok = (EVal & shard_ok).reshape(1, -1)
                eqm = (pos_mat.reshape(1, -1) == targets[:, None]) & ok
                halo = jnp.sum(
                    jnp.where(eqm, EV.reshape(1, -1),
                              jnp.zeros((), x.dtype)),
                    axis=1,
                ).astype(x.dtype)                     # (off,) edge values
                if func == "lag":
                    # concat-then-slice is shape-correct for ANY off vs C
                    # (off ≥ C: every row's lagged value is in the halo)
                    shifted = jnp.concatenate([halo, x])[:C]
                    o = jnp.where(gp >= off, shifted, dflt)
                else:
                    base = jnp.concatenate(
                        [x, jnp.zeros((off,), x.dtype)]
                    )[off:off + C]
                    hal_idx = idx - (n_local - off)
                    hval = halo[jnp.clip(hal_idx, 0, off - 1)]
                    val = jnp.where(idx >= n_local - off, hval, base)
                    o = jnp.where(gp + off < total_rows, val, dflt)
            elif func == "row_number":
                o = carry_rows + pos + 1            # rid order = global order
            elif func == "ntile":
                # global NTILE: the bucket formula over the GLOBAL position
                # (carry) and total row count — big buckets first
                nb = int(params[0])
                gp = carry_rows + pos
                q, r = total_rows // nb, total_rows % nb
                bigb = r * (q + 1)
                o = jnp.where(
                    gp < bigb,
                    gp // jnp.maximum(q + 1, 1),
                    r + (gp - bigb) // jnp.maximum(q, 1),
                ) + 1
            elif func == "percent_rank":
                if has_order:
                    tstart_idx = jax.lax.cummax(
                        jnp.where(is_tstart, idx, 0)
                    )
                    rk0 = (carry_rows + tstart_idx).astype(jnp.float32)
                else:
                    rk0 = jnp.zeros((C,), jnp.float32)
                nf = total_rows.astype(jnp.float32)
                o = jnp.where(nf > 1.0, rk0 / jnp.maximum(nf - 1.0, 1.0),
                              0.0)
            elif func == "cume_dist":
                nf = jnp.maximum(total_rows.astype(jnp.float32), 1.0)
                if has_order:
                    lp = (carry_rows + peers_last(pos + 1)).astype(
                        jnp.float32
                    )
                else:
                    lp = nf
                o = lp / nf
            elif func == "rank":
                if has_order:
                    tstart_idx = jax.lax.cummax(
                        jnp.where(is_tstart, idx, 0)
                    )
                    o = carry_rows + tstart_idx + 1
                else:
                    o = jnp.ones((C,), jnp.int32)
            elif func == "dense_rank":
                if has_order:
                    g = jnp.cumsum(is_tstart.astype(jnp.int32))
                    o = carry_runs + g
                else:
                    o = jnp.ones((C,), jnp.int32)
            elif func == "count":
                o = (carry_rows + peers_last(pos + 1) if has_order
                     else jnp.broadcast_to(total_rows, (C,)))
            elif func == "avg":
                xf = x.astype(jnp.float32)
                if has_order:
                    s = (shard_combine(xf, "sum", False)
                         + peers_last(pscan("sum", xf)))
                    c = (carry_rows
                         + peers_last(pos + 1)).astype(jnp.float32)
                else:
                    s = jnp.broadcast_to(
                        shard_combine(xf, "sum", True), (C,)
                    )
                    c = jnp.broadcast_to(
                        total_rows.astype(jnp.float32), (C,)
                    )
                o = s / jnp.maximum(c, 1.0)
            elif func == "first_value":
                o = jnp.broadcast_to(global_edge(x, last=False), (C,))
            elif func == "last_value":
                o = (peers_last(x) if has_order
                     else jnp.broadcast_to(global_edge(x, last=True), (C,)))
            else:                               # sum / prod / min / max
                if has_order:
                    local = peers_last(pscan(func, x))
                    o = _SCAN[func](
                        jnp.asarray(shard_combine(x, func, False), x.dtype),
                        local,
                    )
                else:
                    o = jnp.broadcast_to(
                        shard_combine(x, func, True), (C,)
                    )
            out[out_name] = o
        return out, cnt

    from harkdb_tpu.parallel.dist_ops import _cached_jit

    def build():
        specs_in = ({n: P(axis) for n in work.names}, P(axis))
        specs_out = ({n: P(axis) for n in out_names}, P(axis))
        return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs_in,
                                     out_specs=specs_out))

    f = _cached_jit(
        jit_cache,
        ("gwin", C, tuple(work.names), tuple(out_names),
         tuple(s[1] for s in specs), tuple(s[6] for s in specs)),
        build,
    )
    out_cols, out_counts = f(work.columns, work.shard_counts)
    return ShardedBatch(out_cols, out_counts)
