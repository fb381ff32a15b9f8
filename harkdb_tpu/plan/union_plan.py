"""UNION / UNION ALL planning and execution (engine extension; the
reference grammar is single-SELECT only, ``parse.py:27-33``) — split out of
``plan/planner.py`` in round 4 for maintainability; behavior unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from harkdb_tpu.columnar.batch import ColumnBatch
from harkdb_tpu.columnar.table import Table
from harkdb_tpu.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu.plan.errors import PlanError
from harkdb_tpu.plan.planner import QueryPlan
from harkdb_tpu.prims.compaction import compact_batch
from harkdb_tpu.sql.ast_nodes import Col, Lit


class UnionPlan:
    """UNION / UNION ALL of SELECT arms (no reference analog — its grammar
    is single-SELECT only, ``parse.py:27-33``).

    Each arm plans independently (sharing the full planner: pushdown, dense-key
    gate, string lowering); the union itself is a small eager tail over the
    arms' packed results — concatenate live rows, dedupe at every non-ALL
    junction (left-associative, standard SQL), then the trailing
    ORDER BY / LIMIT / OFFSET over the combined rows. String outputs merge
    their dictionaries position-wise (codes remap through host LUTs so the
    merged column stays lexicographically ordered)."""

    def __init__(self, stmt, tables: Dict[str, Table],
                 config: EngineConfig = DEFAULT_CONFIG):
        self.stmt = stmt
        self.config = config
        self.arms = [QueryPlan(arm, tables, config) for arm in stmt.arms]
        n_out = len(self.arms[0].output_names)
        for p in self.arms[1:]:
            if len(p.output_names) != n_out:
                raise PlanError(
                    "UNION arms must select the same number of columns"
                )
        self.output_names = list(self.arms[0].output_names)
        self.ops = list(stmt.ops)
        self.limit = stmt.limit
        self.offset = stmt.offset

        # Position-wise string dictionary merge across arms.
        self.output_dicts = []
        self._code_remaps = []       # per position: per-arm LUT or None
        for j in range(n_out):
            ds = [p.output_dicts[j] for p in self.arms]
            if all(d is None for d in ds):
                self.output_dicts.append(None)
                self._code_remaps.append(None)
                continue
            if any(d is None for d in ds):
                raise PlanError(
                    f"UNION arms mix string and numeric values in column "
                    f"{j + 1}"
                )
            merged = ds[0]
            for d in ds[1:]:
                merged = np.union1d(merged, d)
            self.output_dicts.append(merged)
            self._code_remaps.append([
                None if np.array_equal(d, merged)
                else np.searchsorted(merged, d).astype(np.int32)
                for d in ds
            ])

        # Trailing ORDER BY resolves against output names or 1-based
        # ordinals (the arms' internal columns are out of scope by then).
        # Entries: (output position, descending, nulls placement) — NULL
        # indicators ride the union tail (round 5), so NULLS FIRST/LAST
        # and the SQL default placement both work.
        self.order_pos: List[Tuple[int, bool, object]] = []
        for o in stmt.order_by:
            e = o.expr
            if (isinstance(e, Col) and e.table is None
                    and e.name in self.output_names):
                self.order_pos.append(
                    (self.output_names.index(e.name), o.descending, o.nulls)
                )
            elif (isinstance(e, Lit) and isinstance(e.value, int)
                    and 1 <= e.value <= n_out):
                self.order_pos.append((e.value - 1, o.descending, o.nulls))
            else:
                raise PlanError(
                    "UNION ORDER BY must reference an output column name "
                    "or a 1-based column position"
                )

    def _arm_cols(self, ai: int, batch: ColumnBatch):
        """Live-row column slices of one arm's result, codes remapped into
        the merged dictionaries, plus per-position NULL-indicator slices
        (None when the arm's output is never NULL). NULL cells are zeroed
        so every NULL normalizes to the same (0, flag=0) pair — set-op
        semantics treat NULLs as equal, whatever expression produced them."""
        n = int(batch.n_valid)
        cols, flags = [], []
        outs = [nm for nm in batch.names if not nm.startswith("#nullflag")]
        for j, internal in enumerate(outs):
            col = batch.columns[internal][:n]
            remaps = self._code_remaps[j]
            if remaps is not None and remaps[ai] is not None:
                col = jnp.asarray(remaps[ai])[col]
            fl = batch.columns.get(f"#nullflag{j}")
            if fl is not None:
                fl = (fl[:n] != 0).astype(jnp.int32)
                col = jnp.where(fl != 0, col, jnp.zeros((), col.dtype))
            cols.append(col)
            flags.append(fl)
        return cols, flags

    def _dedupe(self, cols: List[jax.Array], nf: int) -> List[jax.Array]:
        """Distinct rows of a packed (no padding) column tuple. The last
        ``nf`` entries are NULL-indicator columns: they participate as keys
        (value 0 with flag 0 = the one canonical NULL row ≠ a real 0), and
        NULLs compare EQUAL to each other — SQL set-op semantics."""
        n = cols[0].shape[0]
        if n == 0:
            return cols
        sorted_cols = jax.lax.sort(cols, num_keys=len(cols), is_stable=False)
        idx = jnp.arange(n, dtype=jnp.int32)
        changed = jnp.zeros((n,), jnp.bool_)
        for c in sorted_cols:
            prev = jnp.concatenate([c[:1], c[:-1]])
            changed = changed | (c != prev)
        keep = (idx == 0) | changed
        b = compact_batch(
            ColumnBatch(
                {f"#u{j}": c for j, c in enumerate(sorted_cols)},
                jnp.int32(n),
            ),
            keep,
        )
        k = int(b.n_valid)
        return [b.columns[f"#u{j}"][:k] for j in range(len(cols))]

    def _set_combine(self, cols: List[jax.Array], tag: jax.Array,
                     op: str) -> List[jax.Array]:
        """INTERSECT / EXCEPT (distinct) of packed column tuples: rows with
        ``tag`` 0 come from the accumulated left side, 1 from the new arm.
        One sort by (tuple..., tag) groups equal tuples into runs with the
        left copies first; per-run tag counts (the join machinery's
        cummax/reversed-cummin run fills — scatter-free) decide membership,
        and the first row of each qualifying run survives. NULL indicators
        ride as ordinary key columns (NULL cells are zero-normalized), so
        NULLs compare EQUAL — SQL set-op semantics."""
        n = cols[0].shape[0]
        if n == 0:
            return cols
        sorted_all = jax.lax.sort(
            cols + [tag], num_keys=len(cols) + 1, is_stable=False
        )
        scols, stag = sorted_all[:-1], sorted_all[-1]
        idx = jnp.arange(n, dtype=jnp.int32)
        changed = jnp.zeros((n,), jnp.bool_)
        for c in scols:
            prev = jnp.concatenate([c[:1], c[:-1]])
            changed = changed | (c != prev)
        start = (idx == 0) | changed
        big = jnp.int32(n + 1)

        def run_totals(x):
            """Per-row total of x over the row's equal-tuple run."""
            cum = jnp.cumsum(x)
            excl = cum - x
            base = jax.lax.cummax(jnp.where(start, excl, 0))
            aoa = jnp.flip(jax.lax.cummin(jnp.flip(
                jnp.where(start, excl, big)
            )))
            nxt = jnp.minimum(
                jnp.concatenate([aoa[1:], big[None]]), cum[-1]
            )
            return nxt - base

        ones_in = run_totals(stag.astype(jnp.int32))
        size_in = run_totals(jnp.ones((n,), jnp.int32))
        zeros_in = size_in - ones_in
        if op == "intersect":
            keep = start & (ones_in > 0) & (zeros_in > 0)
        else:                                            # except
            keep = start & (ones_in == 0) & (zeros_in > 0)
        b = compact_batch(
            ColumnBatch(
                {f"#u{j}": c for j, c in enumerate(scols)}, jnp.int32(n)
            ),
            keep,
        )
        k = int(b.n_valid)
        return [b.columns[f"#u{j}"][:k] for j in range(len(cols))]

    def execute(self, tables: Dict[str, Table], mesh=None,
                shard_cache=None) -> ColumnBatch:
        cfg = self.config

        if (mesh is not None and mesh.devices.size > 1 and cfg.dist_tail
                and jax.process_count() == 1
                and all(op in ("union", "union all") for op in self.ops)):
            # INTERSECT/EXCEPT take the gather tail (arms still execute
            # distributed; only the small set-op combination is local)
            return self._execute_sharded(tables, mesh, shard_cache)

        def run_arm(p: QueryPlan) -> ColumnBatch:
            if mesh is not None and mesh.devices.size > 1:
                from harkdb_tpu.parallel.executor import DistExecutor

                return DistExecutor(
                    p, mesh, cfg, shard_cache=shard_cache
                ).execute(tables)
            return p.execute(tables)

        n_out = len(self.output_names)
        acc: List[jax.Array] = []
        acc_flags: List[object] = [None] * n_out
        for ai, p in enumerate(self.arms):
            cols, flags = self._arm_cols(ai, run_arm(p))
            if ai == 0:
                acc, acc_flags = cols, flags
                continue
            merged = []
            for a, c in zip(acc, cols):
                if (jnp.issubdtype(a.dtype, jnp.floating)
                        != jnp.issubdtype(c.dtype, jnp.floating)):
                    tgt = jnp.dtype(cfg.float_dtype)
                    # Integers beyond the float target's exact-integer span
                    # would silently lose precision in the cast — corrupting
                    # values AND making distinct-dedupe merge unequal rows.
                    # The union tail is eager, so a range readback is cheap.
                    span = 1 << (jnp.finfo(tgt).nmant + 1)
                    for x in (a, c):
                        if (not jnp.issubdtype(x.dtype, jnp.floating)
                                and x.shape[0]
                                and max(abs(int(jnp.min(x))),
                                        abs(int(jnp.max(x)))) > span):
                            raise PlanError(
                                f"UNION mixes int and float values in a "
                                f"column and an integer exceeds "
                                f"{tgt.name}'s exact-integer span "
                                f"(±{span}); the cast would corrupt it"
                            )
                    a, c = a.astype(tgt), c.astype(tgt)
                merged.append(jnp.concatenate([a, c]))
            # NULL indicators concatenate alongside (missing side = all-1)
            na, nc = acc[0].shape[0], cols[0].shape[0]
            mflags = []
            for fa, fc in zip(acc_flags, flags):
                if fa is None and fc is None:
                    mflags.append(None)
                    continue
                fa = fa if fa is not None else jnp.ones((na,), jnp.int32)
                fc = fc if fc is not None else jnp.ones((nc,), jnp.int32)
                mflags.append(jnp.concatenate([fa, fc]))
            acc, acc_flags = merged, mflags
            op = self.ops[ai - 1]
            if op != "union all":
                nf_idx = [j for j, f in enumerate(acc_flags)
                          if f is not None]
                packed = acc + [acc_flags[j] for j in nf_idx]
                if op == "union":
                    dd = self._dedupe(packed, len(nf_idx))
                else:                       # intersect / except
                    tag = jnp.concatenate([
                        jnp.zeros((na,), jnp.int32),
                        jnp.ones((nc,), jnp.int32),
                    ])
                    dd = self._set_combine(packed, tag, op)
                acc = dd[:n_out]
                acc_flags = list(acc_flags)
                for k, j in enumerate(nf_idx):
                    acc_flags[j] = dd[n_out + k]

        from harkdb_tpu.columnar.batch import align_capacity

        total = int(acc[0].shape[0]) if acc else 0
        cap = align_capacity(total, cfg.row_align)
        out_cols = {}

        def padded(c, fill=0):
            pad = cap - c.shape[0]
            if pad:
                c = jnp.concatenate(
                    [c, jnp.full((pad,), fill, c.dtype)]
                )
            return c

        for j, c in enumerate(acc):
            out_cols[f"#out{j}"] = padded(c)
        for j, f in enumerate(acc_flags):
            if f is not None:
                out_cols[f"#nullflag{j}"] = padded(f, 1)
        out = ColumnBatch(out_cols, jnp.int32(total))

        if self.order_pos:
            from harkdb_tpu.ops.sort import sort_batch
            from harkdb_tpu.plan.planner import _null_extreme_sub

            key_arrays = []
            for j, d, nu in self.order_pos:
                a = out.columns[f"#out{j}"]
                f = out.columns.get(f"#nullflag{j}")
                if f is not None:
                    a = _null_extreme_sub(a, f == 0, d, nu)
                key_arrays.append(a)
            out = sort_batch(
                out, [],
                [d for _j, d, _nu in self.order_pos],
                key_arrays=key_arrays,
            )
        if self.offset:
            idx = jnp.arange(out.capacity, dtype=jnp.int32)
            out = compact_batch(
                out, idx >= jnp.int32(self.offset),
            )
        if self.limit is not None:
            out = ColumnBatch(
                out.columns, jnp.minimum(out.n_valid, jnp.int32(self.limit))
            )
        return out

    def _execute_sharded(self, tables: Dict[str, Table], mesh,
                         shard_cache) -> ColumnBatch:
        """Round-4 item 5: the union tail runs SHARDED — arms execute to
        sharded projected results (``DistExecutor.execute(deliver=False)``),
        concatenate shard-wise, dedupe at non-ALL junctions via the
        tuple-hash ``dist_groupby``, and the trailing ORDER BY / OFFSET /
        LIMIT run as ``dist_orderby``/``dist_head``. Per-device memory
        stays at ~1/D of the combined rows; only the final (post-LIMIT)
        result is delivered, streamed shard-block-wise.

        Order parity with the single-chip tail: a hidden ``#upos`` column
        carries each row's arm-concatenation position (regenerated as the
        tuple rank after a dedupe, which leaves single-chip rows
        tuple-sorted); the final sort's key chain is (ORDER BY outputs,
        #upos) — bit-identical output. Single-process only (the gather
        path remains for multi-process runs)."""
        from jax.sharding import PartitionSpec as P

        from harkdb_tpu.parallel.dist_ops import (
            dist_groupby, dist_head, dist_map, dist_orderby, shrink_sharded,
        )
        from harkdb_tpu.parallel.executor import DistExecutor
        from harkdb_tpu.parallel.sharded import ShardedBatch

        cfg = self.config
        axis = cfg.mesh_axis
        D = mesh.devices.size
        n_out = len(self.output_names)
        out_names = [f"#out{j}" for j in range(n_out)]

        # First pass: run every arm sharded, note which output positions
        # carry NULL indicators anywhere (the union-wide flag set).
        arm_sbs = []
        for p in self.arms:
            arm_sbs.append(DistExecutor(
                p, mesh, cfg, shard_cache=shard_cache
            ).execute(tables, deliver=False))
        nf_idx = sorted({
            j for sb in arm_sbs for j in range(n_out)
            if f"#nullflag{j}" in sb.names
        })
        flag_names = [f"#nullflag{j}" for j in nf_idx]
        all_names = out_names + flag_names

        def positions(sb: ShardedBatch, base: int) -> ShardedBatch:
            """Append #upos = base + global live-row position (shard-block
            order)."""
            C = sb.local_capacity
            names_in = sb.names
            names2 = names_in + (
                [] if "#upos" in names_in else ["#upos"]
            )

            def body(cols, cnt):
                gc = jax.lax.all_gather(cnt, axis, axis=0, tiled=True)
                i = jax.lax.axis_index(axis).astype(jnp.int32)
                prefix = jnp.sum(jnp.where(
                    jnp.arange(D, dtype=jnp.int32) < i, gc, 0
                )).astype(jnp.int32)
                out = dict(cols)
                out["#upos"] = (jnp.int32(base) + prefix
                                + jnp.arange(C, dtype=jnp.int32))
                return out, cnt

            f = jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=({n: P(axis) for n in names_in}, P(axis)),
                out_specs=({n: P(axis) for n in names2}, P(axis)),
            ))
            cols, cnt = f(sb.columns, sb.shard_counts)
            return ShardedBatch(cols, cnt)

        def concat(a: ShardedBatch, b: ShardedBatch) -> ShardedBatch:
            """Shard-wise concatenation, repacked live-first (stable sort
            on the dropped flag — same trick as shuffle.compact_received)."""
            Ca, Cb = a.local_capacity, b.local_capacity
            names2 = a.names

            def body(ca, cnta, cb, cntb):
                na, nb = cnta[0], cntb[0]
                ia = jnp.arange(Ca, dtype=jnp.int32)
                ib = jnp.arange(Cb, dtype=jnp.int32)
                live = jnp.concatenate([ia < na, ib < nb])
                dropped = jnp.logical_not(live).astype(jnp.int32)
                ops = jax.lax.sort(
                    [dropped] + [jnp.concatenate([ca[n], cb[n]])
                                 for n in names2],
                    num_keys=1, is_stable=True,
                )
                return (dict(zip(names2, ops[1:])),
                        (na + nb).reshape(1))

            f = jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=({n: P(axis) for n in names2}, P(axis),
                          {n: P(axis) for n in names2}, P(axis)),
                out_specs=({n: P(axis) for n in names2}, P(axis)),
            ))
            cols, cnt = f(a.columns, a.shard_counts,
                          b.columns, b.shard_counts)
            return ShardedBatch(cols, cnt)

        def dedupe(sb: ShardedBatch) -> ShardedBatch:
            """Distinct tuples in global tuple order with fresh positions
            (single-chip dedupe leaves rows (values, flags)-tuple-sorted;
            NULL cells are zero-normalized, so NULLs dedupe as equal)."""
            sb = dist_groupby(
                ShardedBatch({n: sb.columns[n] for n in all_names},
                             sb.shard_counts),
                all_names, [], mesh, cfg,
            )
            sb = dist_orderby(
                sb, lambda cols, cap: [cols[n] for n in all_names],
                [False] * len(all_names), mesh, cfg,
            )
            return positions(sb, 0)

        acc = None
        base = 0
        for ai, p in enumerate(self.arms):
            sb = arm_sbs[ai]
            # Normalize to the union-wide column set: merged-dictionary
            # code remaps, all-1 flags where this arm lacks an indicator,
            # NULL cells zeroed (one canonical NULL per position).
            remaps = [
                (j, self._code_remaps[j][ai]) for j in range(n_out)
                if self._code_remaps[j] is not None
                and self._code_remaps[j][ai] is not None
            ]
            have = set(sb.names)

            def norm_fn(cols, cap, _r=remaps, _have=have):
                out = {}
                for j in range(n_out):
                    c = cols[f"#out{j}"]
                    for jj, lut in _r:
                        if jj == j:
                            c = jnp.asarray(lut)[jnp.clip(
                                c, 0, len(lut) - 1
                            )]
                    out[f"#out{j}"] = c
                for j in nf_idx:
                    fn_ = f"#nullflag{j}"
                    if fn_ in _have:
                        fl = (cols[fn_] != 0).astype(jnp.int32)
                        out[fn_] = fl
                        c = out[f"#out{j}"]
                        out[f"#out{j}"] = jnp.where(
                            fl != 0, c, jnp.zeros((), c.dtype)
                        )
                    else:
                        out[fn_] = jnp.ones((cap,), jnp.int32)
                return out

            sb = dist_map(
                ShardedBatch(
                    {n: sb.columns[n] for n in sb.names
                     if n in set(all_names)},
                    sb.shard_counts,
                ),
                norm_fn, all_names, mesh, cfg,
            )
            sb = positions(sb, base)
            base += int(np.asarray(sb.shard_counts).sum())
            if acc is None:
                acc = sb
                continue
            # dtype promotion (+ the exact-integer-span guard — padding
            # rows are zero and never trip it)
            casts = []
            for j in range(n_out):
                a_ = acc.columns[f"#out{j}"]
                c_ = sb.columns[f"#out{j}"]
                if (jnp.issubdtype(a_.dtype, jnp.floating)
                        != jnp.issubdtype(c_.dtype, jnp.floating)):
                    tgt = jnp.dtype(cfg.float_dtype)
                    span = 1 << (jnp.finfo(tgt).nmant + 1)
                    for x in (a_, c_):
                        if (not jnp.issubdtype(x.dtype, jnp.floating)
                                and max(abs(int(jnp.min(x))),
                                        abs(int(jnp.max(x)))) > span):
                            raise PlanError(
                                f"UNION mixes int and float values in a "
                                f"column and an integer exceeds "
                                f"{tgt.name}'s exact-integer span "
                                f"(±{span}); the cast would corrupt it"
                            )
                    casts.append((j, tgt))
            if casts:
                def cast_fn(cols, cap, _c=casts):
                    out = dict(cols)
                    for j, tgt in _c:
                        out[f"#out{j}"] = cols[f"#out{j}"].astype(tgt)
                    return out

                acc = dist_map(acc, cast_fn, acc.names, mesh, cfg)
                sb = dist_map(sb, cast_fn, sb.names, mesh, cfg)
            acc = shrink_sharded(concat(acc, sb), mesh, cfg)
            if self.ops[ai - 1] == "union":
                acc = dedupe(acc)
                base = int(np.asarray(acc.shard_counts).sum())

        # Final global order: trailing ORDER BY outputs (NULL placement via
        # the indicators), tie #upos — reproduces the single-chip stable
        # sort over concat/dedupe order.
        from harkdb_tpu.plan.planner import _null_extreme_sub

        order_pos = list(self.order_pos)

        def final_keys(cols, cap):
            ks = []
            for j, d, nu in order_pos:
                a = cols[f"#out{j}"]
                f = cols.get(f"#nullflag{j}")
                if f is not None:
                    a = _null_extreme_sub(a, f == 0, d, nu)
                ks.append(a)
            ks.append(cols["#upos"])
            return ks

        descs = [d for _j, d, _nu in order_pos] + [False]
        acc = dist_orderby(acc, final_keys, descs, mesh, cfg)
        if self.offset or self.limit is not None:
            acc = dist_head(acc, self.offset or 0, self.limit, mesh, cfg)
        return ShardedBatch(
            {n: acc.columns[n] for n in all_names}, acc.shard_counts
        ).to_batch()

    def explain(self) -> str:
        lines = []
        for i, p in enumerate(self.arms):
            if i:
                lines.append({
                    "union all": "Union All",
                    "union": "Union (distinct)",
                    "intersect": "Intersect (distinct)",
                    "except": "Except (distinct)",
                }[self.ops[i - 1]])
            lines.extend("  " + ln for ln in p.explain().splitlines())
        if self.order_pos:
            lines.append("Sort " + ", ".join(
                ("DESC" if d else "ASC") for _j, d, _nu in self.order_pos
            ))
        if self.offset:
            lines.append(f"Offset {self.offset}")
        if self.limit is not None:
            lines.append(f"Limit {self.limit}")
        return "\n".join(lines)


