"""Distributed query execution over a device mesh.

Drives a planned query (``harkdb_tpu.plan.planner.QueryPlan``) across
row-sharded tables: joins and group-bys run under ``shard_map`` with
all-to-all shuffles (``dist_ops``); the small post-aggregation tail (HAVING /
projection / ORDER BY / LIMIT) runs on the gathered result via the plan's own
``run_tail`` — one code path for semantics, two for placement.

Ordering parity with the single-chip path (and hence the reference):

  * WHERE-only queries: shard blocks are contiguous original row ranges and
    local compaction is stable, so gather order == original row order
    (SURVEY §3.3).
  * GROUP BY: shards hold disjoint hash-partitioned key sets; one small sort
    of the gathered groups restores global ascending-key order (§3.4).
  * JOIN: hidden per-table row-id columns ride through the shuffle; the
    gathered result is sorted by (join keys, newest-first, then row ids in
    binding order), which reproduces the single-chip sorted-stable order
    exactly (§3.5).
"""

from __future__ import annotations

from typing import Dict, List

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from harkdb_tpu.columnar.batch import ColumnBatch
from harkdb_tpu.columnar.table import Table
from harkdb_tpu.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu.ops.sort import sort_batch
from harkdb_tpu.parallel.dist_ops import (
    dist_filter, dist_groupby, dist_head, dist_join, dist_map, dist_orderby,
)
from harkdb_tpu.parallel.sharded import ShardedBatch, shard_batch
from harkdb_tpu.plan.expr import eval_expr
from harkdb_tpu.plan.planner import QueryPlan, _null_extreme_sub


class DistExecutor:
    def __init__(self, plan: QueryPlan, mesh: Mesh,
                 config: EngineConfig = DEFAULT_CONFIG, shard_cache=None):
        self.plan = plan
        self.mesh = mesh
        self.config = config
        # (table name, binding) → resident ShardedBatch. Owned by the Context
        # so tables transfer to the mesh ONCE, not per query (the reference
        # re-ships the whole matrix across its FFI on every sql() call,
        # FutharkContext.py:65,70 — the flaw this engine exists to fix).
        self._shard_cache = shard_cache if shard_cache is not None else {}
        # Compiled-program cache for the distributed operators, attached to
        # the PLAN (its lifetime matches: the Context invalidates plans
        # whenever tables change). Without it every query re-traces and
        # re-compiles each shard_map stage — measured ~7 s/query on the
        # 8-device CPU mesh (the round-4 weak-scaling bottleneck).
        self._jit_cache = plan.__dict__.setdefault("_dist_jit_cache", {})

    # -- table sharding -------------------------------------------------------
    def _shard_table(self, tables: Dict[str, Table], binding_idx: int) -> ShardedBatch:
        b, tname, cols = self.plan.bindings[binding_idx]
        # Derived tables (FROM (SELECT ...) alias): the inner query runs
        # through the distributed path, materializes once, and reshard-
        # caches on its own source (the Context shard cache is keyed by
        # table NAME, which an alias could collide on).
        src = self.plan._source(tables, tname)
        from harkdb_tpu.plan.derived import DerivedSource

        if isinstance(src, DerivedSource):
            return src.sharded(
                tables, self.mesh, self.config, self._shard_cache, b,
                self.plan.load_remaps.get(b, {}),
            )
        # Merged-dictionary code remaps (string-key joins / cross-table
        # string comparisons) apply host-side before sharding; the cache key
        # carries the remap fingerprint so plans with different merges don't
        # alias each other's resident shards.
        remaps = self.plan.load_remaps.get(b, {})
        if remaps:
            import hashlib

            token = tuple(sorted(
                (i, hashlib.md5(l.tobytes()).hexdigest())
                for i, l in remaps.items()
            ))
        else:
            token = None
        key = (tname, b, token)
        cached = self._shard_cache.get(key)
        if cached is not None:
            return cached
        t = tables[tname]
        host = {}
        for c in cols:
            internal = f"{b}.{c}"
            a = t.host_columns[c]
            lut = remaps.get(internal)
            if lut is not None:
                a = lut[a]
            host[internal] = a
        host[f"#rid.{b}"] = np.arange(t.n_rows, dtype=np.int32)
        sb = shard_batch(host, t.n_rows, self.mesh, self.config)
        self._shard_cache[key] = sb
        return sb

    # -- execution ------------------------------------------------------------
    def _pushdown(self, sb: ShardedBatch, binding: str) -> ShardedBatch:
        expr = self.plan.pushdown.get(binding)
        if expr is None:
            return sb
        return dist_filter(
            sb, lambda cols, cap: eval_expr(expr, cols, cap, self.config),
            self.mesh, self.config,
            jit_cache=self._jit_cache, tag=f"push:{binding}",
        )

    def execute(self, tables: Dict[str, Table], deliver: bool = True):
        """Run the planned query over the mesh. ``deliver=False`` returns
        the tail's SHARDED result (projected #out/#nullflag columns, no
        gather) for composition — the UNION tail unions arms shard-wise.
        Falls back to a delivered ColumnBatch on the non-dist-tail path."""
        plan = self.plan
        self._deliver = deliver
        # Subqueries evaluate once, single-chip (their results are small
        # scalars / value sets), before the sharded pipeline reads the
        # plan's expression containers.
        plan._resolve_subqueries(tables)
        work = self._pushdown(self._shard_table(tables, 0),
                              plan.bindings[0][0])
        # Order-restoration chain (gather / dist-tail re-sort): per join,
        # newest first, the specs that reproduce the single-chip sorted-
        # stable output order; rid_order is the per-binding row-id tie
        # chain (incoming table first for RIGHT joins — its rows are the
        # preserved side of the swapped LEFT).
        restore_specs: List[tuple] = []
        rid_order: List[str] = [f"#rid.{plan.bindings[0][0]}"]
        for step_idx, (rb, lks, rks, kind) in enumerate(plan.join_steps):
            right = self._pushdown(
                self._shard_table(tables, 1 + step_idx), rb
            )
            kflags = list(plan.join_key_flags[step_idx])
            if kind == "right":
                # operand swap (same as the single-chip path): the
                # incoming table is preserved; the accumulated side's
                # columns null-fill via #lmatched
                work = dist_join(
                    right, work, rks, lks, self.mesh, self.config,
                    kind="left", matched_out=f"#lmatched.{rb}",
                    r_flag_names=kflags,
                    jit_cache=self._jit_cache, tag=f"join:{step_idx}",
                )
                restore_specs = (
                    [("asc", k) for k in rks] + restore_specs
                )
                rid_order.insert(0, f"#rid.{rb}")
                continue
            work = dist_join(
                work, right, list(lks), list(rks), self.mesh, self.config,
                kind=kind,
                matched_out=plan.null_flags.get(rb),
                l_matched_out=(f"#lmatched.{rb}" if kind == "full"
                               else None),
                l_flag_names=kflags,
                jit_cache=self._jit_cache, tag=f"join:{step_idx}",
            )
            # a nullable join key orders its NULL rows AFTER the valid
            # rows of the tying key value (the concat sort's nullcode
            # operand) — the restore chain needs the same component
            nf_entry = [("nullflags", tuple(kflags))] if kflags else []
            if kind == "full":
                # single-chip FULL = left-join part (by key) then the
                # unmatched right rows appended in key order: the flag
                # segregates the blocks, the merged key sorts within
                restore_specs = (
                    [("desc", f"#lmatched.{rb}")]
                    + [("merge", f"#lmatched.{rb}", lk, rk)
                       for lk, rk in zip(lks, rks)]
                    + nf_entry
                    + restore_specs
                )
            else:
                restore_specs = (
                    [("asc", k) for k in lks] + nf_entry + restore_specs
                )
            rid_order.append(f"#rid.{rb}")

        def restore_entries(names) -> List:
            """Per-spec array builders (count is static per column set)."""
            names = set(names)
            out = []
            for spec in restore_specs:
                if spec[0] == "merge":
                    _t, fl, ln, rn = spec
                    if {fl, ln, rn} <= names:
                        out.append(
                            lambda cols, fl=fl, ln=ln, rn=rn: jnp.where(
                                cols[fl] != 0, cols[ln], cols[rn]
                            )
                        )
                elif spec[0] == "nullflags":
                    fls = list(spec[1])
                    if set(fls) <= names:
                        def nf(cols, fls=fls):
                            from harkdb_tpu.plan.nulls import valid_mask

                            return 1 - valid_mask(fls, cols).astype(
                                jnp.int32
                            )
                        out.append(nf)
                elif spec[1] in names:
                    if spec[0] == "desc":
                        out.append(lambda cols, k=spec[1]: -cols[k])
                    else:
                        out.append(lambda cols, k=spec[1]: cols[k])
            for r in rid_order:
                if r in names:
                    out.append(lambda cols, k=r: cols[k])
            return out

        def restore_key_arrays(cols) -> List:
            return [f(cols) for f in restore_entries(cols)]

        self._restore_entries = restore_entries
        joined = bool(plan.join_steps)

        if plan.where_residual is not None:
            expr = plan.where_residual
            work = dist_filter(
                work, lambda cols, cap: eval_expr(expr, cols, cap,
                                                  self.config),
                self.mesh, self.config,
                jit_cache=self._jit_cache, tag="where",
            )

        if plan.window_specs and not plan.grouped:
            work = self._dist_windows(work)

        if plan.grouped:
            # exec keys include the hidden matched flag of any nullable
            # group key (NULL as its own group, same as single-chip)
            keys = list(plan.group_exec_keys) or ["#const"]
            agg_specs = list(plan.agg_specs)
            arg_cols = list(plan.agg_arg_cols)
            need_ones = any(src == "#ones" for src, _, _ in agg_specs)
            need_const = not plan.group_keys
            cfg = self.config

            def pre_fn(cols, cap):
                extra = {}
                for name, ge in plan.group_key_exprs:
                    extra[name] = eval_expr(ge, cols, cap, cfg)
                for name in keys:
                    dfe = plan.derived_flag_cols.get(name)
                    if dfe is not None:
                        extra[name] = eval_expr(
                            dfe, cols, cap, cfg
                        ).astype(jnp.int32)
                for internal, e in arg_cols:
                    extra[internal] = eval_expr(e, cols, cap, cfg)
                if need_ones:
                    extra["#ones"] = jnp.ones((cap,), jnp.int32)
                if need_const:
                    extra["#const"] = jnp.zeros((cap,), jnp.int32)
                return extra

            # Dense-key path distributed: the planner's gate (single
            # small-span int key, sum/count only) engages the scatter-add
            # aggregation in every shard's local pre-aggregate; partials
            # shuffle as usual. The span is either statically proven from
            # no-join table stats (plan.fast_agg) or measured by a one-time
            # distributed min/max probe over the live post-join/post-WHERE
            # rows (cached on the plan, like the single-chip probe).
            fast = None
            if plan.fast_agg is not None and not plan.join_steps:
                _key, key_min, span_p = plan.fast_agg
                fast = (key_min, span_p)
            elif plan.fast_candidate is not None:
                fast = self._probe_fast_dist(work)
            plan.last_fast_span = fast[1] if fast is not None else None

            work = dist_groupby(
                work, keys, agg_specs, self.mesh, self.config, pre_fn,
                fast=fast,
                jit_cache=self._jit_cache, tag="gb",
            )
            if not plan.group_keys:
                # SQL: an ungrouped aggregate over EMPTY input is one row
                # (count 0, sums 0), not zero rows — shard 0 fabricates it
                # when the global group count is zero (same fix as the
                # single-chip path; min/max padding is op-neutral, so slot
                # 0 zeroes explicitly).
                axis = self.config.mesh_axis
                from jax.sharding import PartitionSpec as P
                import jax as _jax

                def fix_body(cols, cnt):
                    total = _jax.lax.psum(cnt[0], axis)
                    i = _jax.lax.axis_index(axis)
                    mk = (total == 0) & (i == 0)
                    out = {}
                    for nme, cc in cols.items():
                        v0 = jnp.where(mk, jnp.zeros((), cc.dtype), cc[0])
                        out[nme] = cc.at[0].set(v0)
                    # agg_null_flags validity source for the implicit
                    # group's non-count aggregates (NULL over empty input)
                    out["#grp_has"] = jnp.broadcast_to(
                        jnp.where(total > 0, 1, 0).astype(jnp.int32),
                        (next(iter(cols.values())).shape[0],),
                    )
                    return out, jnp.where(mk, 1, cnt[0]).reshape(1)

                specs = ({n: P(axis) for n in work.names}, P(axis))
                out_specs = (
                    {n: P(axis) for n in
                     list(work.names) + ["#grp_has"]},
                    P(axis),
                )
                from harkdb_tpu.parallel.dist_ops import _cached_jit

                fx = _cached_jit(
                    self._jit_cache,
                    ("fix_empty", work.local_capacity, tuple(work.names)),
                    lambda: _jax.jit(_jax.shard_map(
                        fix_body, mesh=self.mesh, in_specs=specs,
                        out_specs=out_specs,
                    )),
                )
                cols, cnt = fx(work.columns, work.shard_counts)
                from harkdb_tpu.parallel.sharded import ShardedBatch

                work = ShardedBatch(cols, cnt)
            if self.config.dist_tail:
                # Round-4: the grouped tail stays SHARDED through HAVING /
                # ORDER BY / LIMIT (shards hold disjoint key sets) — no
                # device ever materializes the full group set.
                return self._dist_tail(work, grouped=True)
            gathered = work.to_batch_device(self.mesh, self.config.mesh_axis)
            # Disjoint key sets per shard → one global sort restores the
            # ascending-key output contract (u32 bit order under the
            # reference-compat flag — ops/groupby.py).
            if self.config.compat_u32_key_order:
                from harkdb_tpu.ops.groupby import u32_order_key

                gathered = sort_batch(
                    gathered, [],
                    key_arrays=[u32_order_key(gathered.column(k))
                                for k in keys],
                )
            else:
                gathered = sort_batch(gathered, keys)
        else:
            if self.config.dist_tail:
                return self._dist_tail(work, joined, grouped=False)
            gathered = work.to_batch_device(self.mesh, self.config.mesh_axis)
            # Window shuffles scatter rows off their original shards, so the
            # gathered result must re-sort by row id even without joins.
            if joined or plan.window_specs:
                ka = restore_key_arrays(gathered.columns)
                gathered = sort_batch(
                    gathered, [], [False] * len(ka), key_arrays=ka
                )

        return plan.run_tail(gathered)

    def _dist_windows(self, work, tie_names=None):
        """One hash-shuffle pass per distinct PARTITION BY shape: each
        partition lands wholly on one shard, the single-chip window
        computation runs locally, and already-computed window columns ride
        later passes as payload (dist_ops.dist_window). Global windows
        (empty PARTITION BY) take the carry-exchange path
        (parallel/global_window.py — lag/lead via an edge-row halo);
        bounded frames and huge lag offsets fall back to the shard-0
        route. ``tie_names`` overrides the row-id tie chain
        (grouped queries pass the exec group keys — their rows ARE
        groups)."""
        from harkdb_tpu.parallel.dist_ops import dist_window

        plan = self.plan
        by_parts: Dict[tuple, list] = {}
        for spec in plan.window_specs:
            by_parts.setdefault(spec[3], []).append(spec)
        for parts, specs in by_parts.items():
            if not parts:
                from harkdb_tpu.parallel.global_window import (
                    dist_global_window, supports_global,
                )

                by_shape: Dict[tuple, list] = {}
                for s in specs:
                    by_shape.setdefault((s[4], s[5]), []).append(s)
                rest = []
                for _shape, shp_specs in by_shape.items():
                    if supports_global(shp_specs):
                        work = dist_global_window(
                            work, shp_specs, self.mesh, self.config,
                            tie_names=tie_names,
                            jit_cache=self._jit_cache,
                        )
                    else:
                        rest.extend(shp_specs)
                if not rest:
                    continue
                specs = rest
            from harkdb_tpu.plan.windows import validity_names

            win_names = [s[0] for s in specs] + validity_names(specs)
            work = dist_window(
                work, parts,
                # [0]: per-shard local order is irrelevant — the executor's
                # distributed tail re-sorts globally (never skip-restore)
                lambda b, _s=specs: plan._compute_windows(b, _s)[0],
                win_names, self.mesh, self.config,
                jit_cache=self._jit_cache,
            )
        return work

    def _probe_fast_dist(self, work) -> tuple | None:
        """Distributed analog of QueryPlan._resolve_fast's on-device probe:
        global (min, max, any) of the group key over live rows, one small
        shard_map dispatch, cached on the plan (the Context invalidates the
        plan cache whenever its tables change)."""
        plan, cfg = self.plan, self.config
        cached = getattr(plan, "_probed_fast_dist", None)
        if cached is not None:
            return cached if cached != () else None
        from harkdb_tpu.ops.dense_agg import MAX_KEY_SPAN

        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        key_name = plan.fast_candidate
        axis = cfg.mesh_axis
        C = work.local_capacity

        def body(cols, cnt):
            k = cols[key_name]
            live = jnp.arange(C, dtype=jnp.int32) < cnt[0]
            info = jnp.iinfo(k.dtype)
            kmin = jnp.min(jnp.where(live, k, info.max))
            kmax = jnp.max(jnp.where(live, k, info.min))
            return (kmin.reshape(1), kmax.reshape(1),
                    jnp.any(live).reshape(1))

        f = jax.jit(jax.shard_map(
            body, mesh=self.mesh,
            in_specs=({n: P(axis) for n in work.names}, P(axis)),
            out_specs=(P(axis), P(axis), P(axis)),
        ))
        mins, maxs, anys = f(work.columns, work.shard_counts)
        anys = np.asarray(anys).astype(bool)
        fast = None
        if anys.any():
            kmin = int(np.asarray(mins)[anys].min())
            kmax = int(np.asarray(maxs)[anys].max())
            if not (cfg.compat_u32_key_order and kmin < 0):
                span = kmax - kmin + 1
                if span <= MAX_KEY_SPAN:
                    fast = (kmin, span)
        plan._probed_fast_dist = fast if fast is not None else ()
        return fast

    def _dist_tail(self, work, joined: bool = False,
                   grouped: bool = False) -> ColumnBatch:
        """Sharded post-pipeline tail (round-2 item 4 ungrouped; round-4
        item 1 grouped): HAVING / ORDER BY / OFFSET / LIMIT / projection all
        run per shard — no device ever materializes the full row/group set.

        Ungrouped: ORDER BY runs as a distributed range-partitioned sort
        (``dist_orderby``) whose tie chain — order keys, then join keys +
        hidden row ids, then pre-shuffle global position — makes the output
        bit-identical to the single-chip stable sort.

        Grouped: shards hold DISJOINT key sets after ``dist_groupby``, so
        HAVING is shard-local (``dist_filter``), avg/null-fix derivations
        are per-shard maps, and the ascending-key output contract (or the
        user ORDER BY, tie-broken by the exec group keys exactly like the
        single-chip stable sort over key-ordered groups) is one
        ``dist_orderby``. OFFSET/LIMIT take each shard's slice of the
        global window (``dist_head``). Final delivery: single-process runs
        STREAM shard blocks to the host (no device replication);
        multi-process runs all_gather — every process must hand the full
        result to its caller (documented trade-off, tests/test_multihost.py).
        ``last_tail_capacities`` records (stage, per-device capacity) for
        the 1/D-memory invariant tests.
        """
        plan, cfg = self.plan, self.config
        final_items = list(plan.final_items)
        caps = [("in", work.local_capacity)]
        post = list(plan.post_computes) if grouped else []

        def aug(cols, cap):
            """Post-aggregation derived columns (avg / variance /
            null-fixes) for HAVING / ORDER BY / projection expressions —
            the same shared math as run_tail (plan/aggregates.py)."""
            if not post:
                return cols
            from harkdb_tpu.plan.aggregates import apply_post_computes

            g = dict(cols)
            apply_post_computes(g, post)
            return g

        if grouped and plan.having is not None:
            hv = plan.having
            work = dist_filter(
                work,
                lambda cols, cap: eval_expr(hv, aug(cols, cap), cap, cfg),
                self.mesh, cfg,
                jit_cache=self._jit_cache, tag="having",
            )
            caps.append(("having", work.local_capacity))

        if grouped and plan.window_specs:
            # Windows over the GROUPED output (post-HAVING, standard SQL
            # order). Their arguments may reference avg/null-fix derived
            # columns — materialize those once, then the ordinary window
            # dispatch runs over the sharded groups, tie-broken by the
            # exec group keys (unique per row) like the single-chip path.
            if post:
                names2 = list(work.names) + [
                    o for o, _s in post if o not in work.names
                ]
                work = dist_map(work, aug, names2, self.mesh, cfg,
                                jit_cache=self._jit_cache, tag="aug")
                post.clear()              # aug becomes a no-op
            work = self._dist_windows(
                work,
                tie_names=[k for k in plan.group_exec_keys
                           if k in work.names],
            )
            caps.append(("windows", work.local_capacity))

        out_names = [f"#out{i}" for i in range(len(final_items))]
        # Hidden NULL indicators per nullable output — same trailing
        # columns run_tail emits single-chip. A flag may be a
        # post-compute OUTPUT (sample-variance validity), available only
        # after aug — check both sources and read flags from the
        # augmented columns.
        post_outs = {o for o, _s in post}
        nf_specs = [
            (i, flags)
            for i, flags in enumerate(plan.output_null_flags)
            if flags and plan._flags_available(
                flags, set(work.names) | post_outs
            )
        ]
        out_names = out_names + [f"#nullflag{i}" for i, _f in nf_specs]

        def project(cols, cap):
            g = aug(cols, cap)
            out = {
                f"#out{i}": eval_expr(e, g, cap, cfg)
                for i, (e, _n) in enumerate(final_items)
            }
            for i, flags in nf_specs:
                out[f"#nullflag{i}"] = plan._valid_arr(
                    flags, g, cap
                ).astype(jnp.int32)
            return out

        if plan.distinct:
            # DISTINCT = group-by over the full output tuple with no
            # aggregates: project per shard, dedupe locally, shuffle by the
            # tuple hash, dedupe again — shards end with disjoint row sets.
            # Single-chip DISTINCT output order is lexicographic by the full
            # tuple, with ORDER BY applied stably on top; the distributed
            # sort reproduces it exactly with (order outputs, full tuple) as
            # the key chain (tuples are unique, so the order is total).
            work = dist_map(work, project, out_names, self.mesh, cfg,
                            jit_cache=self._jit_cache, tag="project")
            work = dist_groupby(work, out_names, [], self.mesh, cfg,
                                jit_cache=self._jit_cache, tag="distinct")
            descs = [d for _e, d in plan.order_items]
            descs += [False] * len(out_names)

            def dkeys_fn(cols, cap):
                ks = []
                for (j, (_e, d)), nu in zip(
                    zip(plan.order_out_idx, plan.order_items),
                    plan.order_nulls,
                ):
                    a = cols[f"#out{j}"]
                    nf = cols.get(f"#nullflag{j}")
                    if nf is not None:
                        a = _null_extreme_sub(a, nf == 0, d, nu)
                    ks.append(a)
                ks += [cols[k] for k in out_names]
                return ks

            work = dist_orderby(work, dkeys_fn, descs, self.mesh, cfg,
                                jit_cache=self._jit_cache, tag="dob")
            caps.append(("distinct", work.local_capacity))
        else:
            tie_names: List[str] = []
            tie_fns: List = []
            u32_ties = False
            if grouped:
                # Shards hold disjoint key sets in hash order; one range
                # partition restores the global ascending-key contract —
                # the sharded analog of the gather-side sort. A user ORDER
                # BY leads the chain; the exec keys tie-break exactly like
                # the single-chip stable sort over key-ordered groups.
                tie_names = [
                    k for k in plan.group_exec_keys if k in work.columns
                ]
                u32_ties = cfg.compat_u32_key_order
            elif joined or plan.window_specs:
                # Windows shuffled rows off their original shards — the
                # join restore chain (keys / outer-join flags / row ids)
                # reproduces single-chip order.
                tie_fns = self._restore_entries(work.names)

            order_exprs = list(plan.order_items)
            if order_exprs or tie_names or tie_fns:
                descs = [d for _e, d in order_exprs]
                descs += [False] * (len(tie_names) + len(tie_fns))

                def keys_fn(cols, cap):
                    g = aug(cols, cap)
                    ks = [
                        plan._null_adjusted_key(e, d, nu, g, cap)
                        for (e, d), nu in zip(order_exprs,
                                              plan.order_nulls)
                    ]
                    if u32_ties:
                        from harkdb_tpu.ops.groupby import u32_order_key

                        ks += [u32_order_key(cols[k]) for k in tie_names]
                    else:
                        ks += [cols[k] for k in tie_names]
                    ks += [f(cols) for f in tie_fns]
                    return ks

                work = dist_orderby(work, keys_fn, descs, self.mesh, cfg,
                                    jit_cache=self._jit_cache, tag="tob")
                caps.append(("orderby", work.local_capacity))
            work = dist_map(work, project, out_names, self.mesh, cfg,
                            jit_cache=self._jit_cache, tag="project")

        if plan.offset or plan.limit is not None:
            work = dist_head(
                work, plan.offset or 0, plan.limit, self.mesh, cfg,
                jit_cache=self._jit_cache,
            )
            caps.append(("head", work.local_capacity))
        self.last_tail_capacities = caps

        if not getattr(self, "_deliver", True):
            return work

        import jax

        if jax.process_count() > 1:
            return work.to_batch_device(self.mesh, cfg.mesh_axis)
        return work.to_batch()
