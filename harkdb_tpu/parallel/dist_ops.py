"""Distributed operators: filter / group-by / join over a ShardedBatch.

Host-level orchestration around ``jax.shard_map`` bodies built from the same
single-chip operators (``harkdb_tpu.ops``) — the distributed layer composes,
it does not reimplement. Overflow-retry loops double shuffle bucket capacity
(powers of two, bounded jit cache) when a hash bucket exceeds its static size.

Collective footprint per operator (all over the mesh axis, NVLink between
the GPUs of one host): group-by = 1 all_to_all (+1 psum for overflow) after local
pre-aggregation; join = 2 all_to_all (both sides repartitioned) + local
build/probe; filter = none (embarrassingly row-parallel).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from harkdb_tpu.columnar.batch import ColumnBatch
from harkdb_tpu.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu.ops.dense_agg import dense_groupby_batch
from harkdb_tpu.ops.groupby import groupby_batch
from harkdb_tpu.ops.join import join_batches, join_match_count
from harkdb_tpu.ops.sort import sort_batch
from harkdb_tpu.parallel.sharded import ShardedBatch
from harkdb_tpu.parallel.shuffle import (
    hash_to_bucket, repartition_by_key, repartition_with_dest,
)
from harkdb_tpu.prims.compaction import compact_indices

Array = jax.Array

# How each aggregate op re-aggregates across shards: op on partials.
REAGG = {"sum": "sum", "count": "sum", "min": "min", "max": "max",
         "prod": "prod"}


def hash_keys(cols: Dict[str, Array], key_names: Sequence[str],
              n_shards: int, salt: int = 0) -> Array:
    """Combined bucket id for (possibly multi-) key rows."""
    dest = hash_to_bucket(cols[key_names[0]], n_shards, salt)
    for i, k in enumerate(key_names[1:], start=1):
        extra = hash_to_bucket(cols[k], n_shards, salt + 31 * i)
        dest = (dest + extra) % n_shards
    return dest


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0) if n > 1 else 1


def _cached_jit(jit_cache, key, builder):
    """Compiled-program cache for the distributed operators.

    Every operator builds its ``shard_map`` body as a fresh closure, so a
    bare ``jax.jit`` re-traces AND re-compiles on every query — measured at
    ~7 s per distributed query on the 8-device CPU mesh (the round-4
    weak-scaling bottleneck: retention 0.278 was compilation, not data
    movement). Callers thread a per-plan cache dict + a call-site tag;
    the key carries every static baked into the closure (capacities,
    bucket sizes, column names, spec tuples), so a hit is exactly a
    re-dispatch of the previously compiled executable."""
    if jit_cache is None:
        return builder()
    f = jit_cache.get(key)
    if f is None:
        f = builder()
        jit_cache[key] = f
    return f


class ShuffleOverflow(RuntimeError):
    pass


def _max_live(sb: ShardedBatch) -> int | None:
    """Largest per-shard live count (host int), or None when shard counts
    are not addressable from this process (multi-process runs)."""
    if jax.process_count() > 1:
        return None
    import numpy as _np

    c = _np.asarray(sb.shard_counts)
    return int(c.max()) if c.size else 0


def _start_bucket(sb: ShardedBatch, D: int) -> int:
    """Initial shuffle bucket capacity, sized from LIVE rows when known.

    Sizing from the block capacity instead ratchets chained shuffles: each
    shuffle's output capacity is D*bucket_cap regardless of liveness, so a
    groupby→orderby chain would grow 2-4x per stage even as live rows
    shrink. The overflow-retry loop still covers underestimates."""
    ml = _max_live(sb)
    base = -(-sb.local_capacity // D) if ml is None else -(-max(ml, 1) // D)
    return max(128, _next_pow2(base) * 2)


def shrink_sharded(
    sb: ShardedBatch, mesh: Mesh, config: EngineConfig = DEFAULT_CONFIG,
    jit_cache=None,
) -> ShardedBatch:
    """Slice every shard's block down to the live high-water mark (power of
    two, min 128) — undoes the D*bucket_cap padding a shuffle leaves behind
    so chained stages keep per-device memory at ~live/D, not ~capacity.
    No-op (and free) when counts are not host-addressable (multi-process)."""
    ml = _max_live(sb)
    if ml is None:
        return sb
    C = sb.local_capacity
    C2 = max(128, _next_pow2(max(ml, 1)))
    if C2 >= C:
        return sb
    axis = config.mesh_axis

    def build():
        def body(cols, cnt):
            return {n: c[:C2] for n, c in cols.items()}, cnt

        specs = ({n: P(axis) for n in sb.names}, P(axis))
        return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs,
                                     out_specs=specs))

    f = _cached_jit(jit_cache, ("shrink", C, C2, tuple(sb.names)), build)
    cols, cnt = f(sb.columns, sb.shard_counts)
    return ShardedBatch(cols, cnt)


def dist_filter(
    sb: ShardedBatch,
    mask_fn: Callable[[Dict[str, Array], int], Array],
    mesh: Mesh,
    config: EngineConfig = DEFAULT_CONFIG,
    jit_cache=None,
    tag: str = "",
) -> ShardedBatch:
    """Row-parallel WHERE: local masked compaction per shard, no collectives."""
    axis = config.mesh_axis
    C = sb.local_capacity

    def build():
        def body(cols: Dict[str, Array], cnt: Array):
            n_local = cnt[0]
            mask = mask_fn(cols, C).astype(jnp.bool_)
            idx, n_out = compact_indices(mask, n_local)
            out = {
                name: col.at[idx].get(mode="fill", fill_value=0)
                for name, col in cols.items()
            }
            return out, n_out.reshape(1)

        specs_in = ({n: P(axis) for n in sb.names}, P(axis))
        specs_out = ({n: P(axis) for n in sb.names}, P(axis))
        return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs_in,
                                     out_specs=specs_out))

    f = _cached_jit(
        jit_cache, ("filter", tag, C, tuple(sb.names)), build
    )
    out_cols, out_counts = f(sb.columns, sb.shard_counts)
    return ShardedBatch(out_cols, out_counts)


def dist_groupby(
    sb: ShardedBatch,
    key_names: Sequence[str],
    agg_specs: Sequence[Tuple[str, str, str]],
    mesh: Mesh,
    config: EngineConfig = DEFAULT_CONFIG,
    pre_fn: Callable[[Dict[str, Array], int], Dict[str, Array]] | None = None,
    fast: Tuple[int, int] | None = None,
    jit_cache=None,
    tag: str = "",
) -> ShardedBatch:
    """Distributed GROUP BY: local pre-aggregate → hash shuffle of partials →
    local final aggregate. Output shards hold disjoint key sets, each locally
    sorted ascending (global order restored at gather by one small sort).

    ``pre_fn`` optionally derives extra columns (aggregate-argument
    expressions) on the local block before aggregation.

    COUNT(DISTINCT x) ("countd" specs) cannot re-aggregate by summing
    partials — the same value may appear on several shards. The local
    pre-aggregate instead groups at (keys + distinct-srcs) granularity (one
    partial row per distinct value tuple; other aggregates' fine-grained
    partials re-aggregate exactly), the shuffle routes on the REAL keys'
    hash, and the final aggregate computes the exact distinct count.

    ``fast`` = ``(key_min, span)`` engages the dense-key aggregation for
    the local pre-aggregate (single int key with a planner-proven small
    span, sum/count only — the same gate as the single-chip fast path).
    """
    axis = config.mesh_axis
    D = mesh.devices.size
    C = sb.local_capacity
    key_names = list(key_names)

    if any(str(op).startswith("quantile@") for _s, op, _o in agg_specs):
        # QUANTILE/MEDIAN cannot re-aggregate from partials (a quantile of
        # quantiles is not the quantile): shuffle the RAW rows by key hash
        # — every group lands wholly on one shard — and run the full
        # group-by locally. One launch; the retry loop grows the bucket.
        out_names_q = list(key_names) + [
            s[2] for s in agg_specs if s[2] not in key_names
        ]

        def make_raw(bucket_cap: int):
            def body(cols: Dict[str, Array], cnt: Array):
                n_local = cnt[0]
                if pre_fn is not None:
                    cols = dict(cols)
                    cols.update(pre_fn(cols, C))
                rcols = dict(cols)
                rcols["#route"] = hash_keys(rcols, key_names, D)
                shuf, shuf_n, overflow = repartition_by_key(
                    rcols, "#route", n_local, axis, D, bucket_cap,
                    dest_is_bucket=True,
                )
                shuf.pop("#route", None)
                final = groupby_batch(
                    ColumnBatch(shuf, shuf_n), key_names, agg_specs
                )
                out_cols = {
                    n: c for n, c in final.columns.items()
                    if n in set(out_names_q)
                }
                return (out_cols, final.n_valid.reshape(1),
                        jax.lax.psum(overflow, axis))

            specs_in = ({n: P(axis) for n in sb.names}, P(axis))
            specs_out = ({n: P(axis) for n in out_names_q}, P(axis), P())
            return jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=specs_in, out_specs=specs_out,
                check_vma=True,
            ))

        bucket_cap = _start_bucket(sb, D)
        while True:
            f = _cached_jit(
                jit_cache,
                ("groupby_raw", tag, C, bucket_cap, tuple(sb.names),
                 tuple(key_names), tuple(map(repr, agg_specs))),
                lambda: make_raw(bucket_cap),
            )
            out_cols, out_counts, overflow = f(sb.columns, sb.shard_counts)
            if int(overflow) == 0:
                return shrink_sharded(
                    ShardedBatch(out_cols, out_counts), mesh, config,
                    jit_cache=jit_cache,
                )
            if bucket_cap >= C * 2:
                raise ShuffleOverflow("groupby shuffle bucket overflow")
            bucket_cap *= 2

    countd_srcs = []
    for src, op, _ in agg_specs:
        if op == "countd":
            # NULL-skipping countd srcs are (value, valid) pairs — both
            # ride the fine-grained pre-grouping (ops/groupby.py).
            for s in (src if isinstance(src, tuple) else (src,)):
                if s not in countd_srcs:
                    countd_srcs.append(s)
    if countd_srcs:
        # Fine-grained pre-grouping; distinct srcs ride as extra group keys.
        pre_keys = key_names + [s for s in countd_srcs if s not in key_names]
        pre_specs = [(s, op, out) for s, op, out in agg_specs
                     if op != "countd"]
        post_specs = [
            (src, "countd", out) if op == "countd"
            else (out, REAGG[op], out)
            for src, op, out in agg_specs
        ]
        route = True      # route by hash(key_names), not the fine pre-keys
    else:
        pre_keys = key_names
        pre_specs = [(src, op, out) for src, op, out in agg_specs]
        post_specs = [(out, REAGG[op], out) for _src, op, out in agg_specs]
        route = len(key_names) > 1

    use_fast = fast is not None and not countd_srcs and len(key_names) == 1
    if use_fast:
        key_min, span = fast

    def local_pre(cols: Dict[str, Array], n_local: Array) -> ColumnBatch:
        """Per-shard pre-aggregation: the dense-key path when gated, else
        the general sort path (ops/groupby.py)."""
        if use_fast:
            return dense_groupby_batch(
                cols, key_names[0], agg_specs, n_local, jnp.int32(key_min),
                span,
            )
        return groupby_batch(ColumnBatch(cols, n_local), pre_keys, pre_specs)

    def shuffle_final(pcols, pcount, bucket_cap: int):
        """Traced: route partials by key hash, all_to_all, final aggregate."""
        pcols = dict(pcols)
        if route:
            pcols["#route"] = hash_keys(pcols, key_names, D)
            shuf_cols, shuf_n, overflow = repartition_by_key(
                pcols, "#route", pcount, axis, D, bucket_cap,
                dest_is_bucket=True,
            )
            shuf_cols.pop("#route", None)
        else:
            shuf_cols, shuf_n, overflow = repartition_by_key(
                pcols, key_names[0], pcount, axis, D, bucket_cap,
            )
        received = ColumnBatch(shuf_cols, shuf_n)
        final = groupby_batch(received, key_names, post_specs)
        out_cols = {
            n: c for n, c in final.columns.items()
            if n in set(key_names) | {out for _, _, out in post_specs}
        }
        # overflow replicated via psum so the host retry loop can read
        # it in MULTI-PROCESS runs (per-shard outputs are not
        # addressable across processes).
        return (out_cols, final.n_valid.reshape(1),
                jax.lax.psum(overflow, axis))

    out_names = key_names + [
        out for _, _, out in post_specs if out not in key_names
    ]

    def make_fused(bucket_cap: int):
        def body(cols: Dict[str, Array], cnt: Array):
            n_local = cnt[0]
            if pre_fn is not None:
                cols = dict(cols)
                cols.update(pre_fn(cols, C))
            partial = local_pre(cols, n_local)
            return shuffle_final(
                dict(partial.columns), partial.n_valid, bucket_cap
            )

        specs_in = ({n: P(axis) for n in sb.names}, P(axis))
        specs_out = ({n: P(axis) for n in out_names}, P(axis), P())
        return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs_in,
                                     out_specs=specs_out, check_vma=True))

    spec_key = (tuple(key_names), tuple(map(repr, agg_specs)), use_fast,
                fast)

    if jax.process_count() == 1:
        # Two-launch count-probed path (round-5 item 4): the local
        # pre-aggregate's PARTIAL counts size the shuffle buckets, not the
        # input live counts — a 64K-rows/shard, 4K-key group-by then
        # shuffles/final-sorts ~4K-capacity buffers instead of 128K
        # (measured 8x less sort work on the weak-scaling proxy). The
        # pre-aggregate result is shrunk to its live high-water mark so the
        # bucket scatter is live-sized too.
        def make_pre():
            def body(cols: Dict[str, Array], cnt: Array):
                n_local = cnt[0]
                if pre_fn is not None:
                    cols = dict(cols)
                    cols.update(pre_fn(cols, C))
                partial = local_pre(cols, n_local)
                return dict(partial.columns), partial.n_valid.reshape(1)

            pnames = (
                [key_names[0]] + [o for _s, _op, o in agg_specs]
                if use_fast
                else list(pre_keys) + [o for _s, _op, o in pre_specs]
            )
            specs_in = ({n: P(axis) for n in sb.names}, P(axis))
            specs_out = ({n: P(axis) for n in pnames}, P(axis))
            return jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=specs_in, out_specs=specs_out,
                check_vma=True,
            ))

        fp = _cached_jit(
            jit_cache, ("groupby_pre", tag, C, tuple(sb.names)) + spec_key,
            make_pre,
        )
        p_cols, p_counts = fp(sb.columns, sb.shard_counts)
        partial_sb = shrink_sharded(
            ShardedBatch(p_cols, p_counts), mesh, config,
            jit_cache=jit_cache,
        )
        Cp = partial_sb.local_capacity
        maxp = _max_live(partial_sb) or Cp
        bucket_cap = max(128, _next_pow2(-(-max(maxp, 1) // D)) * 2)

        def make_sf(bc: int):
            def body(pcols, pcnt):
                return shuffle_final(pcols, pcnt[0], bc)

            specs_in = ({n: P(axis) for n in partial_sb.names}, P(axis))
            specs_out = ({n: P(axis) for n in out_names}, P(axis), P())
            return jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=specs_in, out_specs=specs_out,
            ))

        while True:
            f2 = _cached_jit(
                jit_cache,
                ("groupby_sf", tag, Cp, bucket_cap,
                 tuple(partial_sb.names)) + spec_key,
                lambda: make_sf(bucket_cap),
            )
            out_cols, out_counts, overflow = f2(
                partial_sb.columns, partial_sb.shard_counts
            )
            if int(overflow) == 0:
                return shrink_sharded(
                    ShardedBatch(out_cols, out_counts), mesh, config,
                    jit_cache=jit_cache,
                )
            if bucket_cap >= Cp * 2:
                raise ShuffleOverflow("groupby shuffle bucket overflow")
            bucket_cap *= 2

    # Multi-process: partial counts are not host-addressable — single
    # fused launch with input-sized buckets (the original path).
    bucket_cap = _start_bucket(sb, D)
    while True:
        f = _cached_jit(
            jit_cache,
            ("groupby", tag, C, bucket_cap, tuple(sb.names)) + spec_key,
            lambda: make_fused(bucket_cap),
        )
        out_cols, out_counts, overflow = f(sb.columns, sb.shard_counts)
        if int(overflow) == 0:
            return shrink_sharded(
                ShardedBatch(out_cols, out_counts), mesh, config,
                jit_cache=jit_cache,
            )
        if bucket_cap >= C * 2:
            raise ShuffleOverflow("groupby shuffle bucket overflow")
        bucket_cap *= 2


def dist_window(
    sb: ShardedBatch,
    part_names: Sequence[str],
    compute_fn: Callable[[ColumnBatch], ColumnBatch],
    win_names: Sequence[str],
    mesh: Mesh,
    config: EngineConfig = DEFAULT_CONFIG,
    jit_cache=None,
    tag: str = "",
) -> ShardedBatch:
    """Distributed window functions for one PARTITION BY shape.

    Rows hash-shuffle on the partition keys so every partition lands wholly
    on one shard; the single-chip window computation (``compute_fn`` =
    ``QueryPlan._compute_windows`` over this shape's specs) then runs
    per-shard and is globally correct. Previously computed window columns
    ride the shuffle as ordinary payload, so several shapes chain as
    sequential passes. Output rows stay wherever the shuffle put them — the
    executor's distributed tail restores order (rid / join-key / ORDER BY
    sort). An empty PARTITION BY routes every row to shard 0 (a global
    window has no parallelism to exploit; the retry loop grows the bucket
    capacity to fit).
    """
    axis = config.mesh_axis
    D = mesh.devices.size
    C = sb.local_capacity

    def make(bucket_cap: int):
        def body(cols: Dict[str, Array], cnt: Array):
            n_local = cnt[0]
            rcols = dict(cols)
            if part_names:
                rcols["#route"] = hash_keys(rcols, list(part_names), D)
            else:
                rcols["#route"] = jnp.zeros((C,), jnp.int32)
            shuf_cols, shuf_n, overflow = repartition_by_key(
                rcols, "#route", n_local, axis, D, bucket_cap,
                dest_is_bucket=True,
            )
            shuf_cols.pop("#route", None)
            out = compute_fn(ColumnBatch(shuf_cols, shuf_n))
            return (dict(out.columns), shuf_n.reshape(1),
                    jax.lax.psum(overflow, axis))

        out_names = list(sb.names) + [
            n for n in win_names if n not in sb.names
        ]
        specs_in = ({n: P(axis) for n in sb.names}, P(axis))
        specs_out = ({n: P(axis) for n in out_names}, P(axis), P())
        return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs_in,
                                     out_specs=specs_out, check_vma=True))

    bucket_cap = _start_bucket(sb, D)
    while True:
        f = _cached_jit(
            jit_cache,
            ("window", tag, C, bucket_cap, tuple(sb.names),
             tuple(part_names), tuple(win_names)),
            lambda: make(bucket_cap),
        )
        out_cols, out_counts, overflow = f(sb.columns, sb.shard_counts)
        if int(overflow) == 0:
            return shrink_sharded(
                ShardedBatch(out_cols, out_counts), mesh, config,
                jit_cache=jit_cache,
            )
        if bucket_cap >= C * 2:
            # a global window routes EVERYTHING to shard 0: its bucket must
            # hold all rows, which can exceed the input local capacity
            if bucket_cap >= C * D:
                raise ShuffleOverflow("window shuffle bucket overflow")
        bucket_cap *= 2


def _route_order_view(key: Array, descending: bool) -> Array:
    """Monotone integer view of a sort key for RANGE partitioning.

    Floats use the IEEE-754 total-order bit trick (sign bit flip for
    positives, full complement for negatives); DESC keys are bitwise-NOT'd
    (order-reversing, total — handles INT_MIN unlike negation). The view is
    only used for splitter comparisons, never returned to the user.
    """
    if jnp.issubdtype(key.dtype, jnp.floating):
        bits = jax.lax.bitcast_convert_type(
            key.astype(jnp.float32), jnp.int32
        )
        # Positive floats already compare correctly as signed ints; negative
        # floats' bit patterns reverse, so map b → INT_MIN - b (monotone,
        # lands below every positive; ±0.0 both map to 0). float64→float32
        # is monotone (splitters only need approximate ranges; the local
        # sort uses the real keys).
        key = jnp.where(bits < 0, jnp.int32(-0x80000000) - bits, bits)
    elif key.dtype.itemsize <= 4:
        key = key.astype(jnp.int32)
    # else: int64 keys keep their dtype — truncating to int32 would wrap
    # mod 2^32 and make the routing view non-monotone (shard ranges then
    # overlap and the concatenated output is not globally sorted).
    return ~key if descending else key


SAMPLES_PER_SHARD = 64


def dist_orderby(
    sb: ShardedBatch,
    keys_fn: Callable[[Dict[str, Array], int], Sequence[Array]],
    descending: Sequence[bool],
    mesh: Mesh,
    config: EngineConfig = DEFAULT_CONFIG,
    jit_cache=None,
    tag: str = "",
) -> ShardedBatch:
    """Distributed ORDER BY: sample-based range partition → one all_to_all →
    local multi-key sort. The output stays SHARDED — shard i holds the i-th
    contiguous range of the global order, internally sorted, so concatenating
    shard blocks yields the globally ordered result without any device ever
    materializing more than ~2/D of the rows (the round-2 verdict's
    replication fix).

    ``keys_fn(cols, capacity)`` returns the sort-key arrays (ORDER BY
    expressions evaluated on the local block — re-evaluated after the
    shuffle, so only table columns ride the exchange). Ties across the whole
    key list resolve by pre-shuffle global position (shard-major), which
    equals the single-chip stable sort's tie order — results are
    bit-identical to the gather-then-sort path.

    Routing: splitters come from ``SAMPLES_PER_SHARD`` evenly-spaced live
    rows per shard (all_gathered, sorted, D-1 quantiles). Rows EQUAL to a
    splitter all route to the same shard (strict comparison), so heavy ties
    never straddle a range boundary; a skew-overloaded range retries with
    doubled bucket capacity like every other shuffle.
    """
    axis = config.mesh_axis
    D = mesh.devices.size
    C = sb.local_capacity
    S = SAMPLES_PER_SHARD
    descending = list(descending)

    def make(bucket_cap: int):
        def body(cols: Dict[str, Array], cnt: Array):
            n_local = cnt[0]
            keys = list(keys_fn(cols, C))
            rk = _route_order_view(keys[0], descending[0])

            # Evenly-spaced live samples of the routing key.
            sidx = (jnp.arange(S, dtype=jnp.int32)
                    * jnp.maximum(n_local, 1)) // S
            samp = rk[jnp.minimum(sidx, C - 1)]
            samp_valid = jnp.broadcast_to(n_local > 0, (S,))
            G = jax.lax.all_gather(samp, axis, axis=0, tiled=True)
            GV = jax.lax.all_gather(samp_valid, axis, axis=0, tiled=True)
            hi = jnp.iinfo(jnp.int32).max
            gs = jax.lax.sort([jnp.where(GV, G, hi)], num_keys=1)[0]
            n_samp = jnp.sum(GV.astype(jnp.int32))
            pos = (jnp.arange(1, D, dtype=jnp.int32) * n_samp) // D
            splitters = gs[jnp.minimum(pos, D * S - 1)]        # (D-1,)
            dest = jnp.sum(
                (rk[:, None] > splitters[None, :]).astype(jnp.int32), axis=1
            )

            # Global pre-shuffle position = the stable-sort tiebreak.
            sid = jax.lax.axis_index(axis).astype(jnp.int32)
            scols = dict(cols)
            scols["#ord_gid"] = sid * C + jnp.arange(C, dtype=jnp.int32)
            shuf, shuf_n, overflow = repartition_with_dest(
                scols, dest, n_local, axis, D, bucket_cap
            )

            keys2 = list(keys_fn(shuf, D * bucket_cap))
            local = ColumnBatch(shuf, shuf_n)
            out = sort_batch(
                local, [], descending + [False],
                key_arrays=keys2 + [shuf["#ord_gid"]],
            )
            out_cols = dict(out.columns)
            out_cols.pop("#ord_gid", None)
            return (out_cols, out.n_valid.reshape(1),
                    jax.lax.psum(overflow, axis))

        specs_in = ({n: P(axis) for n in sb.names}, P(axis))
        specs_out = ({n: P(axis) for n in sb.names}, P(axis), P())
        return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs_in,
                                     out_specs=specs_out))

    bucket_cap = _start_bucket(sb, D)
    while True:
        f = _cached_jit(
            jit_cache,
            ("orderby", tag, C, bucket_cap, tuple(sb.names),
             tuple(descending)),
            lambda: make(bucket_cap),
        )
        out_cols, out_counts, overflow = f(sb.columns, sb.shard_counts)
        if int(overflow) == 0:
            return shrink_sharded(
                ShardedBatch(out_cols, out_counts), mesh, config,
                jit_cache=jit_cache,
            )
        if bucket_cap >= C * 2:
            raise ShuffleOverflow("orderby range-partition overflow")
        bucket_cap *= 2


def dist_head(
    sb: ShardedBatch,
    offset: int,
    limit: int | None,
    mesh: Mesh,
    config: EngineConfig = DEFAULT_CONFIG,
    jit_cache=None,
) -> ShardedBatch:
    """Distributed OFFSET/LIMIT over the global row window
    ``[offset, offset + limit)`` in shard-block order (= global order after
    :func:`dist_orderby`, or original row order otherwise). Each shard keeps
    only its slice of the window — no collectives beyond a (D,)-count
    all_gather, no row movement across shards."""
    axis = config.mesh_axis
    D = mesh.devices.size
    C = sb.local_capacity
    end_global = (offset + limit) if limit is not None else None

    def body(cols: Dict[str, Array], cnt: Array):
        n_local = cnt[0]
        gc = jax.lax.all_gather(cnt, axis, axis=0, tiled=True)   # (D,)
        i = jax.lax.axis_index(axis).astype(jnp.int32)
        prefix = jnp.sum(
            jnp.where(jnp.arange(D, dtype=jnp.int32) < i, gc, 0)
        ).astype(jnp.int32)
        start = jnp.clip(jnp.int32(offset) - prefix, 0, n_local)
        end = (
            jnp.clip(jnp.int32(end_global) - prefix, 0, n_local)
            if end_global is not None else n_local
        )
        pos = jnp.arange(C, dtype=jnp.int32)
        mask = (pos >= start) & (pos < end)
        idx, n_out = compact_indices(mask, n_local)
        out = {
            name: col.at[idx].get(mode="fill", fill_value=0)
            for name, col in cols.items()
        }
        return out, n_out.reshape(1)

    def build():
        specs = ({n: P(axis) for n in sb.names}, P(axis))
        return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs,
                                     out_specs=specs))

    f = _cached_jit(
        jit_cache,
        ("head", C, tuple(sb.names), offset, limit), build,
    )
    out_cols, out_counts = f(sb.columns, sb.shard_counts)
    return ShardedBatch(out_cols, out_counts)


def dist_map(
    sb: ShardedBatch,
    fn: Callable[[Dict[str, Array], int], Dict[str, Array]],
    out_names: Sequence[str],
    mesh: Mesh,
    config: EngineConfig = DEFAULT_CONFIG,
    jit_cache=None,
    tag: str = "",
) -> ShardedBatch:
    """Row-parallel column map (projection / expression evaluation): apply
    ``fn(cols, capacity) -> new column dict`` per shard, no collectives."""
    axis = config.mesh_axis
    C = sb.local_capacity

    def build():
        def body(cols: Dict[str, Array], cnt: Array):
            return dict(fn(cols, C)), cnt

        specs_in = ({n: P(axis) for n in sb.names}, P(axis))
        specs_out = ({n: P(axis) for n in out_names}, P(axis))
        return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs_in,
                                     out_specs=specs_out))

    f = _cached_jit(
        jit_cache,
        ("map", tag, C, tuple(sb.names), tuple(out_names)), build,
    )
    out_cols, out_counts = f(sb.columns, sb.shard_counts)
    return ShardedBatch(out_cols, out_counts)


def dist_join(
    left: ShardedBatch,
    right: ShardedBatch,
    l_key,
    r_key,
    mesh: Mesh,
    config: EngineConfig = DEFAULT_CONFIG,
    kind: str = "inner",
    matched_out: str | None = None,
    l_matched_out: str | None = None,
    l_flag_names: Sequence[str] = (),
    r_flag_names: Sequence[str] = (),
    jit_cache=None,
    tag: str = "",
) -> ShardedBatch:
    """Distributed equi-join: co-partition both sides by key hash
    (2 all_to_all), then a local sorted-probe join per shard. All rows of a
    key tuple land on one shard, so inner/left/FULL-OUTER run locally with
    the single-chip machinery (``ops.join``). ``l_key``/``r_key`` may be
    lists (multi-key: routing hashes every key; the local sort matches
    lexicographic runs). Empty key lists = CROSS JOIN (constant key — every
    row routes to one shard; the retry loop grows its bucket).

    ``matched_out`` / ``l_matched_out`` emit the per-row match-flag columns
    (the outer-join NULL indicators — see ``ops.join.join_batches``).
    ``l_flag_names`` are flag columns guarding the LEFT side's keys: rows
    with any flag 0 have a NULL key and match nothing (3VL ON semantics —
    the null rows ride the shuffle on their fill-value hash and the local
    join's nullcode operand isolates them).

    Output columns: [left | right] (reference ``join.fut:74-75``); global
    ordering is restored by the executor's gather (hidden row-id columns let
    it reproduce the reference's sorted-by-key, stable order exactly).
    """
    axis = config.mesh_axis
    D = mesh.devices.size
    l_keys = [l_key] if isinstance(l_key, str) else list(l_key)
    r_keys = [r_key] if isinstance(r_key, str) else list(r_key)
    cross = not l_keys
    if kind == "cross":
        kind = "inner"
    l_flag_names = list(l_flag_names)
    # Salting replicates hot-key BUILD rows D-fold — fine for inner/left
    # (right rows never emit on their own) but it would multiply FULL
    # OUTER's appended unmatched-right rows: a replica on a shard that got
    # no probe rows of its key counts as unmatched there.
    salted = (config.skew_salted_join and D > 1
              and len(l_keys) == 1 and not cross and kind != "full")

    def _null_of(cols, flag_names):
        if not flag_names:
            return None
        from harkdb_tpu.plan.nulls import valid_mask

        return jnp.logical_not(valid_mask(list(flag_names), cols))

    def _l_null(cols):
        return _null_of(cols, l_flag_names)

    def _r_null(cols):
        return _null_of(cols, r_flag_names)

    # ---- stage 1: co-partition + count --------------------------------------
    # With skew salting (parallel/skew.py): probe-side heavy hitters are
    # detected locally, gathered into a replicated hot set, probe rows of hot
    # keys spread round-robin over all shards, and build rows of hot keys
    # replicated D-fold so every salted shard can probe them.
    def make_stage1(l_cap: int, r_cap: int, r_exp_cap: int):
        def body(l_cols, l_cnt, r_cols, r_cnt):
            l_cols, r_cols = dict(l_cols), dict(r_cols)
            if salted:
                from harkdb_tpu.parallel.skew import (
                    detect_hot_keys, is_member, replicate_hot_build,
                    salted_probe_dest,
                )
                from harkdb_tpu.parallel.shuffle import repartition_with_dest

                lk0, rk0 = l_keys[0], r_keys[0]
                H, HV = detect_hot_keys(
                    l_cols[lk0], l_cnt[0], D, config.skew_threshold, axis
                )
                l_hot = is_member(l_cols[lk0], H, HV)
                sid = jax.lax.axis_index(axis).astype(jnp.int32)
                l_dest = salted_probe_dest(l_cols[lk0], l_hot, D, sid)
                ls, ln, lof = repartition_with_dest(
                    l_cols, l_dest, l_cnt[0], axis, D, l_cap
                )
                r_hot = is_member(r_cols[rk0], H, HV)
                exp_cols, exp_n, r_dest, r_exp_of = replicate_hot_build(
                    r_cols, rk0, r_cnt[0], r_hot, D, r_exp_cap
                )
                rs, rn, rof = repartition_with_dest(
                    exp_cols, r_dest, exp_n, axis, D, r_cap
                )
                rof = rof + jax.lax.psum(r_exp_of, axis)
            else:
                from harkdb_tpu.parallel.shuffle import repartition_with_dest

                cl = next(iter(l_cols.values())).shape[0]
                cr = next(iter(r_cols.values())).shape[0]
                l_dest = (jnp.zeros((cl,), jnp.int32) if cross
                          else hash_keys(l_cols, l_keys, D))
                r_dest = (jnp.zeros((cr,), jnp.int32) if cross
                          else hash_keys(r_cols, r_keys, D))
                ls, ln, lof = repartition_with_dest(
                    l_cols, l_dest, l_cnt[0], axis, D, l_cap
                )
                rs, rn, rof = repartition_with_dest(
                    r_cols, r_dest, r_cnt[0], axis, D, r_cap
                )
            lkc = ([ls[k] for k in l_keys] if l_keys
                   else [jnp.zeros_like(ls[next(iter(ls))], jnp.int32)])
            rkc = ([rs[k] for k in r_keys] if r_keys
                   else [jnp.zeros_like(rs[next(iter(rs))], jnp.int32)])
            from harkdb_tpu.ops.join import compute_join_ranges

            rngs = compute_join_ranges(
                lkc, ln, rkc, rn,
                l_null=_l_null(ls), r_null=_r_null(rs),
                need_full=kind == "full",
            )
            cnt = (rngs.total_left if kind == "left"
                   else rngs.total_full if kind == "full"
                   else rngs.total)
            # Replicated scalars (pmax/psum) so the multi-process host loop
            # can read them: max local join size sets the uniform static
            # capacity; overflow drives the retry; the approximate pair
            # total guards the int32-exact one against wrap (ops/join.py).
            cnt_max = jax.lax.pmax(cnt, axis)
            apx_max = jax.lax.pmax(rngs.total_approx, axis)
            overflow = jax.lax.psum(lof + rof, axis)
            return (ls, ln.reshape(1), rs, rn.reshape(1),
                    cnt_max, apx_max, overflow)

        specs_in = (
            {n: P(axis) for n in left.names}, P(axis),
            {n: P(axis) for n in right.names}, P(axis),
        )
        specs_out = (
            {n: P(axis) for n in left.names}, P(axis),
            {n: P(axis) for n in right.names}, P(axis),
            P(), P(), P(),
        )
        return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs_in,
                                     out_specs=specs_out))

    l_cap = max(128, _next_pow2(-(-left.local_capacity // D)) * 2)
    r_cap = max(128, _next_pow2(-(-right.local_capacity // D)) * 2)
    r_exp_cap = _next_pow2(right.local_capacity) * 2
    max_r_cap = _next_pow2(right.local_capacity * D) * 2
    while True:
        f = _cached_jit(
            jit_cache,
            ("join1", tag, l_cap, r_cap, r_exp_cap,
             tuple(left.names), tuple(right.names),
             left.local_capacity, right.local_capacity, kind, salted),
            lambda: make_stage1(l_cap, r_cap, r_exp_cap),
        )
        (l_shuf, l_n, r_shuf, r_n, counts, apx, overflow) = f(
            left.columns, left.shard_counts, right.columns, right.shard_counts
        )
        if float(apx) > 1.8e9:
            from harkdb_tpu.plan.errors import PlanError

            raise PlanError(
                f"Join result would exceed ~1.8e9 pairs on one shard "
                f"(≈{float(apx):.3g}) — beyond the 2^31-row capacity; "
                f"add join keys or filters"
            )
        if int(overflow) == 0:
            break
        if l_cap >= left.local_capacity * 2 and r_cap >= max_r_cap:
            raise ShuffleOverflow("join shuffle bucket overflow")
        l_cap = min(l_cap * 2, _next_pow2(left.local_capacity) * 2)
        r_cap = min(r_cap * 2, max_r_cap)
        r_exp_cap = min(r_exp_cap * 2, max_r_cap)

    l_part = ShardedBatch(l_shuf, l_n)
    r_part = ShardedBatch(r_shuf, r_n)
    out_cap = max(128, _next_pow2(int(counts)))

    # ---- stage 2: local join at uniform static capacity ---------------------
    l_names, r_names = l_part.names, r_part.names
    out_names = l_names + [n for n in r_names if n not in l_names]
    if matched_out is not None:
        out_names = out_names + [matched_out]
    if l_matched_out is not None:
        out_names = out_names + [l_matched_out]

    def body2(l_cols, l_cnt, r_cols, r_cnt):
        if cross:
            l_cols = dict(l_cols)
            r_cols = dict(r_cols)
            l_cols["#xk"] = jnp.zeros_like(
                next(iter(l_cols.values())), jnp.int32
            )
            r_cols["#xk"] = jnp.zeros_like(
                next(iter(r_cols.values())), jnp.int32
            )
        lb = ColumnBatch(l_cols, l_cnt[0])
        rb = ColumnBatch(r_cols, r_cnt[0])
        out = join_batches(
            lb, rb,
            l_keys if l_keys else ["#xk"],
            r_keys if r_keys else ["#xk"],
            out_cap,
            {n: n for n in l_names},
            {n: n for n in r_names if n not in l_names},
            kind=kind,
            matched_out=matched_out, l_matched_out=l_matched_out,
            l_null=_l_null(l_cols), r_null=_r_null(r_cols),
        )
        return dict(out.columns), out.n_valid.reshape(1)

    def build2():
        specs_in = (
            {n: P(axis) for n in l_names}, P(axis),
            {n: P(axis) for n in r_names}, P(axis),
        )
        specs_out = ({n: P(axis) for n in out_names}, P(axis))
        return jax.jit(jax.shard_map(body2, mesh=mesh, in_specs=specs_in,
                                     out_specs=specs_out))

    f2 = _cached_jit(
        jit_cache,
        ("join2", tag, out_cap, tuple(l_names), tuple(r_names),
         l_part.local_capacity, r_part.local_capacity, kind,
         matched_out, l_matched_out),
        build2,
    )
    out_cols, out_counts = f2(
        l_part.columns, l_part.shard_counts,
        r_part.columns, r_part.shard_counts,
    )
    return ShardedBatch(out_cols, out_counts)
