"""The engine's data-parallel building blocks vs numpy/pandas oracles:
compaction, dense-key aggregation and its planner gate, pair expansion
(``replicated_iota``) and the doubling segmented scan."""

import numpy as np
import pandas as pd
import pytest
import jax.numpy as jnp

from harkdb_tpu import Context
from harkdb_tpu.columnar.batch import ColumnBatch
from harkdb_tpu.ops.dense_agg import MAX_KEY_SPAN, dense_groupby_sums
from harkdb_tpu.ops.groupby import groupby_aggregate
from harkdb_tpu.prims.compaction import compact_arrays, compact_batch
from harkdb_tpu.prims.segmented import (
    doubling_segmented_scan, expand, replicated_iota,
)


class TestLogShiftCompact:
    """Stable masked compaction (prims/compaction.py): kept rows packed to
    the front in order, capacity and dtypes kept, padding zeroed."""

    @pytest.mark.parametrize("n,sel", [
        (500, 0.5),            # small input
        (16384, 0.3),          # power-of-two length
        (40000, 0.9),          # mostly kept
        (33000, 0.02),         # low selectivity
        (32768, 1.0),          # keep everything
        (1000, 0.0),           # keep nothing
    ])
    def test_vs_numpy(self, rng, n, sel):
        k = rng.integers(-(10**6), 10**6, n).astype(np.int32)
        v = (rng.random(n) * 100).astype(np.float32)
        nv = max(1, int(n * 0.95))
        mask = rng.random(n) < sel
        out = compact_batch(
            ColumnBatch({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                        jnp.int32(nv)),
            jnp.asarray(mask),
        )
        m = mask.copy()
        m[nv:] = False
        c = int(m.sum())
        assert int(out.n_valid) == c
        got_k, got_v = np.asarray(out.columns["k"]), np.asarray(out.columns["v"])
        np.testing.assert_array_equal(got_k[:c], k[m])
        np.testing.assert_array_equal(got_v[:c], v[m])
        assert not got_k[c:].any() and not got_v[c:].any()   # padding is 0
        assert got_k.shape[0] == n                # capacity preserved
        assert out.columns["v"].dtype == jnp.float32   # dtype kept

    def test_matches_sort_path(self, rng):
        """compact_arrays equals a numpy stable sort on the inverted mask."""
        n = 20000
        k = rng.integers(0, 100, n).astype(np.int32)
        f = rng.standard_normal(n).astype(np.float32)
        mask = rng.random(n) < 0.4
        (ck, cf), count = compact_arrays(
            [jnp.asarray(k), jnp.asarray(f)], jnp.asarray(mask),
            jnp.int32(n - 7),
        )
        m = mask.copy()
        m[n - 7:] = False
        order = np.argsort(~m, kind="stable")
        c = int(m.sum())
        assert int(count) == c
        np.testing.assert_array_equal(np.asarray(ck)[:c], k[order][:c])
        np.testing.assert_array_equal(np.asarray(cf)[:c], f[order][:c])


class TestOnehotGroupby:
    """Dense-key scatter-add aggregation (ops/dense_agg.py)."""

    def test_vs_pandas(self, rng):
        n = 6000
        k = rng.integers(10, 200, n).astype(np.int32)
        val = rng.integers(-(10**6), 10**6, n).astype(np.int32)
        counts, sums, keys_axis = dense_groupby_sums(
            jnp.asarray(k), [jnp.asarray(val)], jnp.int32(n),
            jnp.int32(10), 191,
        )
        g = pd.DataFrame({"k": k, "v": val}).groupby("k")["v"].agg(
            ["sum", "count"]
        )
        cc, ss = np.asarray(counts), np.asarray(sums[0])
        np.testing.assert_array_equal(np.asarray(keys_axis),
                                      np.arange(10, 201))
        for key, row in g.iterrows():
            assert cc[key - 10] == row["count"]
            assert ss[key - 10] == np.int32(row["sum"])

    def test_mask_and_padding(self, rng):
        n = 3000
        k = rng.integers(0, 50, n).astype(np.int32)
        v = np.ones(n, np.int32)
        mask = rng.random(n) < 0.5
        counts, sums, _ = dense_groupby_sums(
            jnp.asarray(k), [jnp.asarray(v)], jnp.int32(2000),
            jnp.int32(0), 50, mask=jnp.asarray(mask),
        )
        live = mask[:2000]
        assert int(np.asarray(counts).sum()) == int(live.sum())
        np.testing.assert_array_equal(
            np.asarray(counts), np.bincount(k[:2000][live], minlength=50)
        )
        np.testing.assert_array_equal(np.asarray(sums[0]),
                                      np.asarray(counts))

    def test_int32_wraparound_matches_sort_path(self):
        # Sums that overflow int32 must wrap identically on both paths.
        k = np.zeros(4, np.int32)
        v = np.full(4, 2**30, np.int32)
        counts, sums, _ = dense_groupby_sums(
            jnp.asarray(k), [jnp.asarray(v)], jnp.int32(4),
            jnp.int32(0), 1,
        )
        # 4 * 2^30 = 2^32 ≡ 0 (mod 2^32)
        assert int(np.asarray(sums[0])[0]) == 0
        _keys, outs, _n = groupby_aggregate(
            jnp.asarray(k), [(jnp.asarray(v), "sum")], jnp.int32(4)
        )
        assert int(np.asarray(outs[0])[0]) == 0

    def test_applicability(self):
        """The planner takes the dense path for int sum/count over a key
        span up to MAX_KEY_SPAN, and the sort path otherwise."""
        c = Context()
        c.create_table("t", {
            "k": np.array([0, MAX_KEY_SPAN - 1], np.int32),
            "w": np.array([0, MAX_KEY_SPAN], np.int32),
            "v": np.array([1, 2], np.int32),
        })
        assert c._plan("select k, sum(v), count(*) from t group by k"
                       ).fast_agg is not None
        assert c._plan("select k, max(v) from t group by k").fast_agg is None
        assert c._plan("select w, sum(v) from t group by w").fast_agg is None


class TestDenseVsSortPath:
    """The dense path is bit-identical to the sort path (ops/groupby.py),
    wraparound and a fused WHERE mask included."""

    @pytest.mark.parametrize("span", [1, 4096, MAX_KEY_SPAN])
    def test_matches_sort_path(self, rng, span):
        n = 5000
        k = rng.integers(0, span, n).astype(np.int32) - 3
        v = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(
            np.int32)                      # large values: sums wrap
        mask = rng.random(n) < 0.6
        nv = n - 11
        counts, sums, keys_axis = dense_groupby_sums(
            jnp.asarray(k), [jnp.asarray(v)], jnp.int32(nv),
            jnp.int32(-3), span, mask=jnp.asarray(mask),
        )
        keys_s, outs, n_groups = groupby_aggregate(
            jnp.asarray(k), [(jnp.asarray(v), "sum"), (jnp.asarray(v),
                                                       "count")],
            jnp.int32(nv), mask=jnp.asarray(mask),
        )
        ng = int(n_groups)
        present = np.asarray(counts) > 0
        assert int(present.sum()) == ng
        np.testing.assert_array_equal(np.asarray(keys_axis)[present],
                                      np.asarray(keys_s[0])[:ng])
        np.testing.assert_array_equal(np.asarray(sums[0])[present],
                                      np.asarray(outs[0])[:ng])
        np.testing.assert_array_equal(np.asarray(counts)[present],
                                      np.asarray(outs[1])[:ng])


class TestPlannerFastPath:
    def test_fast_path_selected_and_correct(self, rng):
        c = Context()
        n = 4000
        df = pd.DataFrame({
            "k": rng.integers(0, 64, n).astype(np.int32),
            "v": rng.integers(-1000, 1000, n).astype(np.int32),
        })
        c.create_table("t", df)
        q = "select k, sum(v), count(*) from t group by k"
        plan = c._plan(q)
        assert plan.fast_agg is not None      # dense-key path engaged
        out = c.sql(q)
        e = df.groupby("k")["v"].agg(["sum", "count"]).reset_index()
        np.testing.assert_array_equal(out, e.to_numpy())

    def test_fast_path_with_where_and_having(self, rng):
        c = Context()
        df = pd.DataFrame({
            "k": rng.integers(0, 32, 2000).astype(np.int32),
            "v": rng.integers(0, 100, 2000).astype(np.int32),
        })
        c.create_table("t", df)
        q = ("select k, avg(v) from t where v > 10 group by k "
             "having count(*) > 20 order by k desc")
        plan = c._plan(q)
        assert plan.fast_agg is not None
        out = c.sql(q)
        f = df[df.v > 10]
        g = f.groupby("k")["v"].agg(["mean", "count"])
        g = g[g["count"] > 20].sort_index(ascending=False)
        np.testing.assert_allclose(out[:, 1], g["mean"].to_numpy(), rtol=1e-6)

    def test_max_forces_sort_path(self, rng):
        c = Context()
        df = pd.DataFrame({"k": np.arange(10, dtype=np.int32),
                           "v": np.arange(10, dtype=np.int32)})
        c.create_table("t", df)
        plan = c._plan("select k, max(v) from t group by k")
        assert plan.fast_agg is None

    def test_wide_keys_force_sort_path(self):
        c = Context()
        df = pd.DataFrame({
            "k": np.array([0, 10**8], np.int32),
            "v": np.array([1, 2], np.int32),
        })
        c.create_table("t", df)
        plan = c._plan("select k, sum(v) from t group by k")
        assert plan.fast_agg is None
        out = c.sql("select k, sum(v) from t group by k")
        np.testing.assert_array_equal(out, [[0, 1], [10**8, 2]])
        # The execute-time probe also measured the wide span and declined.
        assert plan.fast_candidate is not None
        assert plan.last_fast_span is None

    def test_post_join_keys_take_mxu_path(self, rng):
        """A join→where→groupby pipeline must reach the dense-key path via
        the on-device range probe (plan introspection)."""
        c = Context()
        n = 3000
        facts = pd.DataFrame({
            "k": rng.integers(0, 40, n).astype(np.int32),
            "v": rng.integers(-50, 50, n).astype(np.int32),
        })
        dims = pd.DataFrame({
            "j": np.arange(40, dtype=np.int32),
            "m": rng.integers(1, 5, 40).astype(np.int32),
        })
        c.create_table("facts", facts)
        c.create_table("dims", dims)
        q = ("select k, sum(v), count(*) from facts "
             "join dims on facts.k = dims.j "
             "where v > 0 group by k order by k")
        plan = c._plan(q)
        assert plan.fast_agg is None            # no static proof with a join
        assert plan.fast_candidate is not None  # but structurally eligible
        out = c.sql(q)
        assert plan.last_fast_span is not None  # probe admitted the dense path
        f = facts[facts.v > 0]
        e = f.groupby("k")["v"].agg(["sum", "count"]).reset_index()
        np.testing.assert_array_equal(out, e.to_numpy())
        # Probe result is cached on the plan: re-execution must not re-probe.
        probed = plan._probed_fast
        out2 = c.sql(q)
        assert plan._probed_fast is probed
        np.testing.assert_array_equal(out2, e.to_numpy())

    def test_where_narrows_wide_table_onto_mxu_path(self, rng):
        """Full-table stats say the span is huge, but the probe sees the
        post-WHERE range and still admits the dense-key path."""
        c = Context()
        k = np.concatenate([
            rng.integers(0, 30, 2000), np.array([10**8])
        ]).astype(np.int32)
        v = rng.integers(0, 9, k.size).astype(np.int32)
        df = pd.DataFrame({"k": k, "v": v})
        c.create_table("t", df)
        q = "select k, sum(v) from t where k < 1000 group by k"
        plan = c._plan(q)
        assert plan.fast_agg is None
        out = c.sql(q)
        assert plan.last_fast_span is not None
        f = df[df.k < 1000]
        e = f.groupby("k")["v"].sum().reset_index()
        np.testing.assert_array_equal(out, e.to_numpy())

    def test_empty_probe_falls_back(self):
        c = Context()
        df = pd.DataFrame({"k": np.array([5], np.int32),
                           "v": np.array([1], np.int32)})
        c.create_table("t", df)
        c.create_table("r", pd.DataFrame({
            "j": np.array([9], np.int32), "m": np.array([1], np.int32),
        }))
        q = ("select k, sum(v) from t join r on t.k = r.j group by k")
        out = c.sql(q)                          # join is empty → probe empty
        plan = c._plan(q)
        assert plan.last_fast_span is None
        assert out.shape[0] == 0


BLOCK = 4096      # segment layouts below are placed relative to this width


class TestExpandKernel:
    """Pair expansion (prims/segmented.py): ``replicated_iota`` segment ids
    and ``expand``'s per-segment positions vs a numpy oracle — unit and
    huge segments, segments starting exactly at block multiples, padded
    sources."""

    def _oracle(self, offsets, n_src, out_cap):
        offs = offsets[:n_src]
        seg = np.maximum(
            np.searchsorted(offs, np.arange(out_cap), side="right") - 1, 0
        )
        return seg

    @pytest.mark.parametrize("case", ["random", "unit", "one_big", "aligned"])
    def test_vs_oracle(self, rng, case):
        out_cap = 3 * BLOCK + 1000
        if case == "random":
            sizes = rng.integers(1, 9, 9000).astype(np.int32)
        elif case == "unit":
            sizes = np.ones(out_cap - 5, np.int32)
        elif case == "one_big":
            sizes = np.array([out_cap + 7], np.int32)
        else:  # segments starting exactly at block boundaries
            sizes = np.full(6, BLOCK, np.int32)
        offsets = (np.cumsum(sizes) - sizes).astype(np.int32)
        ends = (offsets + sizes).astype(np.int32)
        ends_d = jnp.asarray(ends)

        out, total = expand(
            jnp.asarray(sizes),
            lambda ids, local: jnp.stack([ids, local, ends_d[ids]]),
            out_cap,
        )
        seg, local, extra = (np.asarray(a) for a in out)
        exp_seg = self._oracle(offsets, len(sizes), out_cap)
        n_out = min(int(sizes.astype(np.int64).sum()), out_cap)
        assert int(total) == min(int(sizes.astype(np.int64).sum()),
                                 np.iinfo(np.int32).max)
        live = np.arange(out_cap) < n_out
        np.testing.assert_array_equal(seg[live], exp_seg[live], err_msg=case)
        np.testing.assert_array_equal(
            local[live], (np.arange(out_cap) - offsets[exp_seg])[live],
            err_msg=case,
        )
        np.testing.assert_array_equal(extra[live], ends[exp_seg][live],
                                      err_msg=case)

    def test_padded_source_capacity(self, rng):
        """Entries at index >= n_valid must be ignored (engine padding)."""
        sizes = rng.integers(1, 30, 500).astype(np.int32)
        offsets = (np.cumsum(sizes) - sizes).astype(np.int32)
        n_src = 300
        padded = np.concatenate([sizes, np.full(2048, 5, np.int32)])
        out_cap = int(offsets[n_src - 1] + sizes[n_src - 1]) + 77
        seg, total = replicated_iota(jnp.asarray(padded), out_cap,
                                     jnp.int32(n_src))
        exp = self._oracle(offsets, n_src, out_cap)
        n_live = int(sizes[:n_src].sum())
        assert int(total) == n_live
        live = np.arange(out_cap) < n_live
        np.testing.assert_array_equal(np.asarray(seg)[live], exp[live])
        assert (np.asarray(seg)[~live] == len(padded)).all()

    def test_bruteforce_small(self, rng):
        """Randomized small cases, zero-length segments included."""
        for trial in range(8):
            n_seg = int(rng.integers(1, 200))
            sizes = rng.integers(0, 400, n_seg).astype(np.int32)
            offsets = (np.cumsum(sizes) - sizes).astype(np.int32)
            total = int(sizes.sum())
            out_cap = total + int(rng.integers(1, 300))
            seg, t = replicated_iota(jnp.asarray(sizes), out_cap)
            exp = np.repeat(np.arange(n_seg), sizes)
            assert int(t) == total
            np.testing.assert_array_equal(
                np.asarray(seg)[:total], exp, err_msg=f"trial {trial}"
            )
            # every slot's segment contains it
            s = np.asarray(seg)[:total]
            pos = np.arange(total)
            assert ((offsets[s] <= pos) & (pos < offsets[s] + sizes[s])).all()


def _np_segscan(op, sid, v):
    """Inclusive per-segment scan, one numpy accumulate per segment."""
    out = np.empty_like(v)
    starts = np.flatnonzero(np.r_[True, sid[1:] != sid[:-1]])
    for a, b in zip(starts, np.r_[starts[1:], len(sid)]):
        out[a:b] = op.accumulate(v[a:b], axis=0)
    return out


class TestSegscanKernel:
    """Doubling segmented scan (prims/segmented.py) vs a numpy oracle: all
    four ops, int and float, several columns, one long segment."""

    @pytest.mark.parametrize("op,neutral", [
        ("max", -(2**31)), ("min", 2**31 - 1), ("add", 0), ("mul", 1),
    ])
    def test_vs_doubling(self, rng, op, neutral):
        n = 3 * 16384 + 777
        sid = np.sort(rng.integers(1, 301, n)).astype(np.int32)
        lo, hi = (-9, 9) if op == "mul" else (-1000, 1000)
        v = rng.integers(lo, hi, n).astype(np.int32)
        sid[:100] = 0                     # a segment of neutral elements
        v[:100] = neutral                 # scans to itself
        ops = {"max": (jnp.maximum, np.maximum), "min": (jnp.minimum,
                                                         np.minimum),
               "add": (jnp.add, np.add), "mul": (jnp.multiply, np.multiply)}
        got = doubling_segmented_scan(
            ops[op][0], jnp.asarray(sid), jnp.asarray(v)
        )
        with np.errstate(over="ignore"):
            exp = _np_segscan(ops[op][1], sid, v)        # int32 wraps
        np.testing.assert_array_equal(np.asarray(got), exp)
        assert (np.asarray(got)[:100] == neutral).all()

    def test_multi_column_and_float(self, rng):
        n = 2 * 16384 + 5
        sid = np.sort(rng.integers(0, 50, n)).astype(np.int32)
        a = rng.standard_normal(n).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        got = doubling_segmented_scan(
            jnp.maximum, jnp.asarray(sid), jnp.stack([a, b], axis=1),
        )
        exp = _np_segscan(np.maximum, sid, np.stack([a, b], axis=1))
        np.testing.assert_array_equal(np.asarray(got), exp)

    def test_segment_spanning_many_tiles(self):
        n = 5 * 16384
        sid = np.zeros(n, np.int32)       # ONE segment over the whole input
        v = np.ones(n, np.int32)
        got = doubling_segmented_scan(jnp.add, jnp.asarray(sid),
                                      jnp.asarray(v))
        np.testing.assert_array_equal(
            np.asarray(got), np.arange(1, n + 1, dtype=np.int32)
        )
