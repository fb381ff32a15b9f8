"""Operator tests: sort / groupby / join vs numpy+pandas oracles.

Differential testing strategy per SURVEY §4: the reference ships no asserted
tests at all, so oracles are pandas (already the reference's ingest dependency,
``table.py:6``) and numpy.
"""

import numpy as np
import pandas as pd
import jax.numpy as jnp
import pytest

from harkdb_tpu.columnar.batch import ColumnBatch
from harkdb_tpu.ops.sort import sort_permutation, sort_batch
from harkdb_tpu.ops.groupby import groupby_aggregate, groupby_batch
from harkdb_tpu.ops.join import join_match_count, inner_join_indices, join_batches


def make_batch(cols, capacity=None):
    return ColumnBatch.from_numpy(
        {k: np.asarray(v) for k, v in cols.items()}, capacity
    )


class TestSort:
    def test_single_key_asc(self):
        b = make_batch({"k": np.array([3, 1, 2], np.int32)}, capacity=8)
        out = sort_batch(b, ["k"])
        np.testing.assert_array_equal(np.asarray(out.column("k"))[:3], [1, 2, 3])
        assert int(out.n_valid) == 3

    def test_padding_stays_out(self):
        # Padding rows carry zeros — they must NOT sort into the live region.
        b = make_batch({"k": np.array([5, 4], np.int32)}, capacity=8)
        out = sort_batch(b, ["k"])
        np.testing.assert_array_equal(np.asarray(out.column("k"))[:2], [4, 5])

    def test_descending_int_min(self):
        lo = np.iinfo(np.int32).min
        b = make_batch({"k": np.array([0, lo, 5], np.int32)}, capacity=8)
        out = sort_batch(b, ["k"], descending=[True])
        np.testing.assert_array_equal(np.asarray(out.column("k"))[:3], [5, 0, lo])

    def test_multi_key_mixed_order(self):
        k1 = np.array([1, 0, 1, 0], np.int32)
        k2 = np.array([9, 8, 7, 6], np.int32)
        v = np.array([10, 20, 30, 40], np.int32)
        b = make_batch({"a": k1, "b": k2, "v": v}, capacity=8)
        out = sort_batch(b, ["a", "b"], descending=[False, True])
        df = pd.DataFrame({"a": k1, "b": k2, "v": v}).sort_values(
            ["a", "b"], ascending=[True, False], kind="stable"
        )
        np.testing.assert_array_equal(np.asarray(out.column("v"))[:4], df["v"])

    def test_stability(self):
        k = np.array([1, 1, 1, 0], np.int32)
        v = np.array([10, 20, 30, 40], np.int32)
        b = make_batch({"k": k, "v": v}, capacity=8)
        out = sort_batch(b, ["k"])
        np.testing.assert_array_equal(
            np.asarray(out.column("v"))[:4], [40, 10, 20, 30]
        )

    def test_random_vs_numpy(self, rng):
        n = 3000
        k = rng.integers(0, 50, n).astype(np.int32)
        b = make_batch({"k": k}, capacity=4096)
        perm, _ = sort_permutation([b.column("k")], b.n_valid)
        np.testing.assert_array_equal(
            np.asarray(b.column("k"))[np.asarray(perm)[:n]], np.sort(k, kind="stable")
        )

    def test_float_desc(self):
        k = np.array([1.5, -2.5, 0.0], np.float32)
        b = make_batch({"k": k}, capacity=8)
        out = sort_batch(b, ["k"], descending=[True])
        np.testing.assert_array_equal(
            np.asarray(out.column("k"))[:3], [1.5, 0.0, -2.5]
        )


class TestGroupby:
    def test_reference_example(self):
        # The reference's one real test (test.py:7): groupby col1, max(col3)
        # over data.csv. Expected from its semantics: ascending keys.
        col1 = np.array([6, 0, 0, 0, 0, 6, 1], np.int32)
        col3 = np.array([1, 4, 4, 4, 4, 770, 3], np.int32)
        keys, outs, n = groupby_aggregate(
            jnp.asarray(col1), [(jnp.asarray(col3), "max")], jnp.int32(7)
        )
        assert int(n) == 3
        np.testing.assert_array_equal(np.asarray(keys[0])[:3], [0, 1, 6])
        np.testing.assert_array_equal(np.asarray(outs[0])[:3], [4, 3, 770])

    @pytest.mark.parametrize("op", ["sum", "prod", "max", "min", "count"])
    def test_ops_vs_pandas(self, rng, op):
        n = 500
        k = rng.integers(0, 20, n).astype(np.int32)
        v = rng.integers(1, 5, n).astype(np.int32)
        b = make_batch({"k": k, "v": v}, capacity=1024)
        out = groupby_batch(b, "k", [("v", op, "agg")])
        df = pd.DataFrame({"k": k, "v": v})
        expect = df.groupby("k")["v"].agg(op if op != "prod" else "prod")
        expect = expect.sort_index()
        ng = int(out.n_valid)
        assert ng == len(expect)
        np.testing.assert_array_equal(
            np.asarray(out.column("k"))[:ng], expect.index.to_numpy()
        )
        # pandas aggregates in int64; the engine wraps at int32 (reference
        # kernels wrap at u32 likewise) — compare modulo 2^32.
        expect_wrapped = (
            expect.to_numpy().astype(np.int64).astype(np.uint32).view(np.int32)
        )
        np.testing.assert_array_equal(
            np.asarray(out.column("agg"))[:ng], expect_wrapped
        )

    def test_multiple_aggs(self):
        k = np.array([1, 2, 1, 2], np.int32)
        v = np.array([3, 4, 5, 6], np.int32)
        b = make_batch({"k": k, "v": v}, capacity=8)
        out = groupby_batch(b, "k", [("v", "sum", "s"), ("v", "min", "m")])
        assert int(out.n_valid) == 2
        np.testing.assert_array_equal(np.asarray(out.column("s"))[:2], [8, 10])
        np.testing.assert_array_equal(np.asarray(out.column("m"))[:2], [3, 4])

    def test_all_one_group(self):
        b = make_batch({"k": np.zeros(5, np.int32),
                        "v": np.arange(5, dtype=np.int32)}, capacity=8)
        out = groupby_batch(b, "k", [("v", "sum", "s")])
        assert int(out.n_valid) == 1
        assert int(np.asarray(out.column("s"))[0]) == 10

    def test_empty_input(self):
        b = ColumnBatch(
            {"k": jnp.zeros(8, jnp.int32), "v": jnp.zeros(8, jnp.int32)},
            jnp.int32(0),
        )
        out = groupby_batch(b, "k", [("v", "sum", "s")])
        assert int(out.n_valid) == 0

    def test_negative_keys_sorted_ascending(self):
        k = np.array([-5, 3, -5, 0], np.int32)
        v = np.ones(4, np.int32)
        b = make_batch({"k": k, "v": v}, capacity=8)
        out = groupby_batch(b, "k", [("v", "count", "c")])
        np.testing.assert_array_equal(np.asarray(out.column("k"))[:3], [-5, 0, 3])
        np.testing.assert_array_equal(np.asarray(out.column("c"))[:3], [2, 1, 1])


def oracle_join(lk, rk):
    """Reference-ordered pair list: sorted by key; left order then right order
    within a key (stable)."""
    pairs = []
    order = np.argsort(lk, kind="stable")
    for li in order:
        for ri in range(len(rk)):
            if rk[ri] == lk[li]:
                pairs.append((li, ri))
    return pairs


class TestJoin:
    def test_basic(self):
        lk = np.array([1, 2, 3], np.int32)
        rk = np.array([2, 3, 4], np.int32)
        total = join_match_count(
            *_keys(lk), *_keys(rk)
        )
        assert int(total) == 2
        l_idx, r_idx, t = inner_join_indices(*_keys(lk), *_keys(rk), out_capacity=8)
        got = list(zip(np.asarray(l_idx)[:2].tolist(), np.asarray(r_idx)[:2].tolist()))
        assert got == [(1, 0), (2, 1)]

    def test_duplicates_cartesian(self):
        lk = np.array([7, 7], np.int32)
        rk = np.array([7, 7, 7], np.int32)
        l_idx, r_idx, t = inner_join_indices(*_keys(lk), *_keys(rk), out_capacity=16)
        assert int(t) == 6
        got = list(zip(np.asarray(l_idx)[:6].tolist(), np.asarray(r_idx)[:6].tolist()))
        assert got == oracle_join(lk, rk)

    def test_no_matches(self):
        lk = np.array([1, 2], np.int32)
        rk = np.array([3, 4], np.int32)
        _, _, t = inner_join_indices(*_keys(lk), *_keys(rk), out_capacity=8)
        assert int(t) == 0

    def test_random_vs_oracle(self, rng):
        nl, nr = 200, 150
        lk = rng.integers(0, 40, nl).astype(np.int32)
        rk = rng.integers(0, 40, nr).astype(np.int32)
        expect = oracle_join(lk, rk)
        cap = 1 << int(np.ceil(np.log2(max(len(expect), 1) + 1)))
        l_idx, r_idx, t = inner_join_indices(*_keys(lk, 512), *_keys(rk, 512),
                                             out_capacity=cap)
        assert int(t) == len(expect)
        got = list(zip(np.asarray(l_idx)[: int(t)].tolist(),
                       np.asarray(r_idx)[: int(t)].tolist()))
        assert got == expect

    def test_int_max_key_vs_padding(self):
        # A real INT_MAX key must not match right-side padding rows.
        hi = np.iinfo(np.int32).max
        lk = np.array([hi, 1], np.int32)
        rk = np.array([hi], np.int32)
        l_idx, r_idx, t = inner_join_indices(
            *_keys(lk, 8), *_keys(rk, 8), out_capacity=8
        )
        assert int(t) == 1
        assert (int(np.asarray(l_idx)[0]), int(np.asarray(r_idx)[0])) == (0, 0)

    def test_join_batches_column_order(self):
        left = make_batch({"a": np.array([1, 2], np.int32),
                           "b": np.array([10, 20], np.int32)}, capacity=8)
        right = make_batch({"c": np.array([2, 1], np.int32),
                            "d": np.array([200, 100], np.int32)}, capacity=8)
        out = join_batches(left, right, "a", "c", out_capacity=8)
        assert out.names == ["a", "b", "c", "d"]  # [left | right], join.fut:74-75
        mat, _ = out.to_numpy()
        np.testing.assert_array_equal(mat, [[1, 10, 1, 100], [2, 20, 2, 200]])

    def test_ranges_requires_explicit_outputs(self):
        # ranges= supplied without l_out/r_out is a contract error (the
        # payload order is defined by them), not an AttributeError.
        from harkdb_tpu.ops.join import compute_join_ranges

        left = make_batch({"a": np.array([1, 2], np.int32)}, capacity=4)
        right = make_batch({"c": np.array([2, 1], np.int32)}, capacity=4)
        rng = compute_join_ranges(
            left.column("a"), left.n_valid, right.column("c"), right.n_valid,
            l_cols=[left.column("a")], r_cols=[right.column("c")],
        )
        with pytest.raises(ValueError, match="l_out/r_out"):
            join_batches(None, None, "a", "c", 4, ranges=rng)
        out = join_batches(
            None, None, "a", "c", 4,
            {"a": "a"}, {"c": "c"}, ranges=rng,
        )
        mat, _ = out.to_numpy()
        np.testing.assert_array_equal(mat, [[1, 1], [2, 2]])


def _keys(k, capacity=None):
    b = ColumnBatch.from_numpy({"k": k}, capacity)
    return b.column("k"), b.n_valid
