"""Run the engine's main path on one GPU and check every answer.

``Context.create_table`` loads a 2^24-row fact table ``t`` and a 2^19-row
dimension table ``dim`` (made from ``--seed`` with numpy), then eight queries
run through ``Context.sql_batch`` on the resident tables. Each result is
compared with a numpy-only reference computed from the same host arrays.

    python chip_smoke.py                # one GPU, full size
    python chip_smoke.py --rows 65536   # smaller tables, for a first compile
    python chip_smoke.py --choices      # timings behind two design constants
    python chip_smoke.py --four         # distributed path only, on 4 GPUs

Without a GPU the script exits non-zero before it prints any result. It
prints the card's name and power limit, one line per query (rows out, match,
first-call seconds, median of 3 warm calls), the peak device memory, and as
its last line ``{"ok": true, "device": {...}}``. Any mismatch or exception
exits non-zero. The timings are smoke timings, not benchmark numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

FULL_ROWS = 1 << 24
SEED = 0
WARM_CALLS = 3

# Float outputs are float32 sums taken in another order than the float64
# reference: their error scales with the summed terms, not the result, so a
# value is compared to rtol of itself or of its column's largest magnitude.
RTOL = 1e-4


# ---- data ------------------------------------------------------------------

def scale(rows: int) -> dict:
    """Key spaces for ``rows`` fact rows: 2^20 keys, a 4096-wide ``d`` and a
    2^19-row dimension at 2^24 rows; smaller tables shrink them in step."""
    n_keys = max(rows // 16, 16)
    return {"n_keys": n_keys, "d_span": min(4096, max(rows // 64, 2)),
            "dim_rows": n_keys // 2}


def make_data(rows: int, seed: int = SEED) -> dict:
    """Host tables ``t`` and ``dim`` as dicts of numpy arrays."""
    s = scale(rows)
    n_keys = s["n_keys"]
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, n_keys + 1, dtype=np.float64) ** 1.1
    cdf = np.cumsum(zipf)
    cdf /= cdf[-1]
    t = {
        "k": rng.integers(0, n_keys, rows, dtype=np.int32),
        "d": rng.integers(0, s["d_span"], rows, dtype=np.int32),
        "v": rng.integers(-1000, 1000, rows, dtype=np.int32),
        "f": rng.standard_normal(rows, dtype=np.float32),
        "z": np.minimum(
            np.searchsorted(cdf, rng.random(rows), side="right"), n_keys - 1
        ).astype(np.int32),
    }
    dim = {
        "j": rng.permutation(n_keys)[: s["dim_rows"]].astype(np.int32),
        "w": rng.integers(-1000, 1000, s["dim_rows"], dtype=np.int32),
    }
    return {"t": t, "dim": dim}


# ---- numpy reference -------------------------------------------------------

def _i32(a):
    """Exact int64 sums → the engine's int32 (wraps mod 2^32)."""
    return np.asarray(a).astype(np.int64).astype(np.int32)


def _group(keys):
    """(ascending distinct keys, group index per row, rows per group)."""
    uniq, inv, cnt = np.unique(keys, return_inverse=True, return_counts=True)
    return uniq, inv, cnt


def _gsum(inv, vals, n_groups):
    return np.bincount(inv, weights=vals, minlength=n_groups)


def _gmax(inv, vals, n_groups):
    out = np.full(n_groups, np.iinfo(vals.dtype).min, vals.dtype)
    np.maximum.at(out, inv, vals)
    return out


def _dim_lookup(data):
    n_keys = scale(len(data["t"]["k"]))["n_keys"]
    has = np.zeros(n_keys, bool)
    w = np.zeros(n_keys, np.int64)
    has[data["dim"]["j"]] = True
    w[data["dim"]["j"]] = data["dim"]["w"]
    return has, w


def ref_mix(data):
    t = data["t"]
    keep = t["v"] > 0
    k, v = t["k"][keep], t["v"][keep]
    uniq, inv, cnt = _group(k)
    s = _gsum(inv, v, len(uniq))
    m = _gmax(inv, v, len(uniq))
    o = np.argsort(-s, kind="stable")
    return [uniq[o], _i32(s[o]), m[o], _i32(cnt[o])]


def ref_dense(data):
    t = data["t"]
    uniq, inv, cnt = _group(t["d"])
    return [uniq, _i32(_gsum(inv, t["v"], len(uniq))), _i32(cnt)]


def ref_filter(data):
    t = data["t"]
    keep = t["v"] > 500
    return [t["k"][keep], t["v"][keep], t["f"][keep]]


def _ref_join_group(data, key):
    t = data["t"]
    has, w = _dim_lookup(data)
    hit = has[t[key]]
    uniq, inv, cnt = _group(t["d"][hit])
    return [uniq, _i32(_gsum(inv, w[t[key][hit]], len(uniq))), _i32(cnt)]


def ref_join_group(data):
    return _ref_join_group(data, "k")


def ref_zipf_join_group(data):
    return _ref_join_group(data, "z")


def ref_outer_nulls(data):
    has, _w = _dim_lookup(data)
    return [_i32([np.count_nonzero(~has[data["t"]["k"]])])]


def ref_topk(data):
    t = data["t"]
    o = np.argsort(-t["v"].astype(np.int64), kind="stable")[:10]
    return [t["k"][o], t["v"][o]]


def _row_number_v_desc_k(t):
    """row_number() over (order by v desc, k): ties keep row order."""
    n = len(t["k"])
    n_keys = scale(n)["n_keys"]
    key = (999 - t["v"].astype(np.int64)) * n_keys + t["k"]
    rn = np.empty(n, np.int32)
    rn[np.argsort(key, kind="stable")] = np.arange(1, n + 1, dtype=np.int32)
    return rn


def ref_window(data):
    t = data["t"]
    k, v = t["k"], t["v"]
    n = len(k)
    o = np.lexsort((v, k))                       # partition k, order by v
    ks, vs = k[o], v[o]
    cs = np.cumsum(vs, dtype=np.int64)
    part_start = np.r_[True, ks[1:] != ks[:-1]]
    base = (cs - vs)[np.flatnonzero(part_start)][np.cumsum(part_start) - 1]
    running = cs - base
    # RANGE frame: peers (same k, same v) all take the last peer's sum
    peer_start = part_start | np.r_[True, vs[1:] != vs[:-1]]
    peer_end = np.r_[np.flatnonzero(peer_start)[1:] - 1, n - 1]
    rs = np.empty(n, np.int64)
    rs[o] = running[peer_end[np.cumsum(peer_start) - 1]]
    return [k, _i32(rs), _row_number_v_desc_k(t)]


def ref_global_window(data):
    t = data["t"]
    return [t["k"], t["v"], _row_number_v_desc_k(t)]


def ref_float_group(data):
    t = data["t"]
    uniq, inv, cnt = _group(t["d"])
    g = len(uniq)
    f = t["f"].astype(np.float64)
    mean = _gsum(inv, f, g) / cnt
    var = _gsum(inv, (f - mean[inv]) ** 2, g) / np.maximum(cnt - 1, 1)
    std = np.where(cnt > 1, np.sqrt(var), np.nan)
    n_keys = scale(len(t["k"]))["n_keys"]
    pairs = np.unique(t["d"].astype(np.int64) * n_keys + t["k"])
    distinct = np.bincount(np.searchsorted(uniq, pairs // n_keys),
                           minlength=g)
    return [uniq, mean, std, _i32(distinct)]


QUERIES = [
    ("mix", "select k, sum(v) as s, max(v) as m, count(*) as c from t "
            "where v > 0 group by k order by s desc", ref_mix),
    ("dense_group", "select d, sum(v), count(*) from t group by d", ref_dense),
    ("filter", "select k, v, f from t where v > 500", ref_filter),
    ("join_group", "select t.d, sum(dim.w), count(*) from t join dim "
                   "on t.k = dim.j group by t.d", ref_join_group),
    ("outer_nulls", "select count(*) from t left join dim on t.k = dim.j "
                    "where w is null", ref_outer_nulls),
    ("topk", "select k, v from t order by v desc limit 10", ref_topk),
    ("window", "select k, sum(v) over (partition by k order by v) as rs, "
               "row_number() over (order by v desc, k) as rn from t",
     ref_window),
    ("float_group", "select d, avg(f), stddev(f), count(distinct k) from t "
                    "group by d", ref_float_group),
]

FOUR_QUERIES = [q for q in QUERIES
                if q[0] in ("mix", "dense_group", "join_group", "topk")] + [
    ("zipf_join_group", "select t.d, sum(dim.w), count(*) from t join dim "
                        "on t.z = dim.j group by t.d", ref_zipf_join_group),
    ("global_window", "select k, v, row_number() over (order by v desc, k) "
                      "as rn from t", ref_global_window),
]


# ---- engine side -----------------------------------------------------------

def load(ctx, data) -> None:
    for name, cols in data.items():
        ctx.create_table(name, cols)


def result_columns(batch) -> list:
    """Output columns of a result batch as numpy arrays; NULLs (hidden
    ``#nullflag{j}`` columns, as ``Context.sql_df`` decodes them) → NaN."""
    n = int(batch.n_valid)
    names = [c for c in batch.names if not c.startswith("#nullflag")]
    out = []
    for j, name in enumerate(names):
        col = np.asarray(batch.columns[name])[:n]
        flag = batch.columns.get(f"#nullflag{j}")
        if flag is not None:
            nulls = np.asarray(flag)[:n] == 0
            if nulls.any():
                col = col.astype(np.float64)
                col[nulls] = np.nan
        out.append(col)
    return out


def mismatch(got: list, want: list) -> str | None:
    """None when ``got`` matches ``want``; otherwise what differs.
    Integer columns must be bit-equal; float columns within RTOL."""
    if len(got) != len(want):
        return f"{len(got)} columns, expected {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape:
            return f"column {i}: shape {g.shape}, expected {w.shape}"
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            g64, w64 = g.astype(np.float64), w.astype(np.float64)
            top = np.nanmax(np.abs(w64)) if np.isfinite(w64).any() else 0.0
            if not np.allclose(g64, w64, rtol=RTOL, atol=RTOL * top,
                               equal_nan=True):
                bad = int(np.sum(~np.isclose(g64, w64, rtol=RTOL,
                                             atol=RTOL * top,
                                             equal_nan=True)))
                return f"column {i}: {bad} float values off"
        elif not np.array_equal(g, w):
            return (f"column {i}: {int(np.sum(g != w))} of {len(w)} "
                    f"values differ")
    return None


def run_query(ctx, sql: str):
    """(result batch, first-call seconds, median warm seconds)."""
    import jax

    t0 = time.perf_counter()
    batch, _names = ctx.sql_batch(sql)
    jax.block_until_ready(batch)
    first = time.perf_counter() - t0
    warm = []
    for _ in range(WARM_CALLS):
        t0 = time.perf_counter()
        jax.block_until_ready(ctx.sql_batch(sql)[0])
        warm.append(time.perf_counter() - t0)
    return batch, first, float(np.median(warm))


# ---- phases ----------------------------------------------------------------

def run_smoke(rows: int, seed: int) -> int:
    """The eight queries on one device. Returns the number of failures."""
    import jax

    from harkdb_tpu import Context

    t0 = time.perf_counter()
    data = make_data(rows, seed)
    ctx = Context()
    load(ctx, data)
    print(f"setup: {rows} fact rows, {len(data['dim']['j'])} dim rows, "
          f"made and loaded in {time.perf_counter() - t0:.3f} s", flush=True)
    failures = 0
    for name, sql, ref in QUERIES:
        batch, first, warm = run_query(ctx, sql)
        got = result_columns(batch)
        bad = mismatch(got, ref(data))
        failures += bad is not None
        print(f"query {name}: rows_out={len(got[0])} "
              f"{'match' if bad is None else 'MISMATCH ' + bad} "
              f"setup_first_call_s={first:.6f} warm_median_s={warm:.6f}",
              flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}", flush=True)
    return failures


def _timed(fn, *args, reps: int = 5):
    """(compile+first-call seconds, median of ``reps`` warm seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, first, float(np.median(ts))


HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet; the bound the
#                               --choices lines compare against


def run_choices(rows: int, seed: int) -> int:
    """Time the two choices behind ``prims/compaction.py`` and
    ``ops/dense_agg.MAX_KEY_SPAN``; print one line per measurement."""
    import jax
    import jax.numpy as jnp

    from harkdb_tpu.columnar.batch import ColumnBatch
    from harkdb_tpu.ops.dense_agg import dense_groupby_batch
    from harkdb_tpu.ops.groupby import groupby_batch
    from harkdb_tpu.prims.compaction import compact_indices
    from harkdb_tpu.prims.segmented import doubling_segmented_scan

    rng = np.random.default_rng(seed)
    failures = 0

    def compact_sort(cols, mask):
        idx = jnp.arange(mask.shape[0], dtype=jnp.int32)
        count = jnp.sum(mask).astype(jnp.int32)
        out = jax.lax.sort([jnp.logical_not(mask).astype(jnp.int32)]
                           + list(cols), num_keys=1, is_stable=True)
        return [jnp.where(idx < count, c, 0) for c in out[1:]], count

    def compact_scatter(cols, mask):
        ind, count = compact_indices(mask)
        return [c.at[ind].get(mode="fill", fill_value=0) for c in cols], count

    mask = jax.device_put(rng.random(rows) < 0.5)
    for n_cols in (2, 6):
        cols = [jax.device_put(rng.integers(-(1 << 30), 1 << 30, rows,
                                            dtype=np.int32))
                for _ in range(n_cols)]
        res = {}
        for label, fn in (("sort", compact_sort),
                          ("cumsum_scatter", compact_scatter)):
            out, first, warm = _timed(jax.jit(fn), cols, mask)
            res[label] = out
            nbytes = rows * (8 * n_cols + 1)
            print(f"choice compaction rows={rows} cols={n_cols} "
                  f"path={label} first_call_s={first:.6f} "
                  f"warm_median_s={warm:.6f} "
                  f"hbm_share={nbytes / HBM_BYTES_PER_S / warm:.4f}",
                  flush=True)
        same = all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(res["sort"][0], res["cumsum_scatter"][0]))
        failures += not same
        print(f"choice compaction cols={n_cols} paths_agree={same}",
              flush=True)

    specs = [("v", "sum", "s"), ("v", "count", "c")]
    vals = jax.device_put(rng.integers(-1000, 1000, rows, dtype=np.int32))
    for span in (1 << 10, 1 << 14, 1 << 18, 1 << 20):
        keys = jax.device_put(rng.integers(0, span, rows, dtype=np.int32))

        def dense(k, v, _span=span):
            return dense_groupby_batch({"k": k, "v": v}, "k", specs,
                                       jnp.int32(rows), jnp.int32(0), _span)

        def sort(k, v):
            return groupby_batch(ColumnBatch({"k": k, "v": v},
                                             jnp.int32(rows)), "k", specs)

        res = {}
        for label, fn in (("dense", dense), ("sort", sort)):
            out, first, warm = _timed(jax.jit(fn), keys, vals)
            res[label] = out
            print(f"choice group_by rows={rows} span={span} path={label} "
                  f"first_call_s={first:.6f} warm_median_s={warm:.6f}",
                  flush=True)
        a, b = res["dense"], res["sort"]
        n = int(a.n_valid)
        same = n == int(b.n_valid) and all(
            np.array_equal(np.asarray(a.columns[c])[:n],
                           np.asarray(b.columns[c])[:n])
            for c in ("k", "s", "c"))
        failures += not same
        print(f"choice group_by span={span} paths_agree={same}", flush=True)

    sid = jax.device_put(np.sort(rng.integers(0, rows // 16, rows,
                                              dtype=np.int32)))
    _out, first, warm = _timed(jax.jit(
        lambda s, v: doubling_segmented_scan(jnp.add, s, v)), sid, vals)
    print(f"choice segmented_scan rows={rows} first_call_s={first:.6f} "
          f"warm_median_s={warm:.6f} "
          f"hbm_share={rows * 12 / HBM_BYTES_PER_S / warm:.4f}", flush=True)
    return failures


def run_four(rows_per_device: int, seed: int) -> int:
    """The distributed path on ``make_engine_mesh(4)``: each query against
    the numpy reference and a one-device Context on the same data, and
    every resident table sharded over all 4 devices."""
    import jax
    from jax.sharding import PartitionSpec as P

    from harkdb_tpu import Context, EngineConfig
    from harkdb_tpu.parallel import make_engine_mesh, shard_batch
    from harkdb_tpu.parallel.skew import detect_hot_keys

    if len(jax.devices()) < 4:
        raise SystemExit(f"chip_smoke --four: needs 4 GPUs, JAX found "
                         f"{len(jax.devices())}")
    rows = 4 * rows_per_device
    t0 = time.perf_counter()
    data = make_data(rows, seed)
    cfg = EngineConfig()
    mesh = make_engine_mesh(4, cfg)
    dist, single = Context(cfg, mesh=mesh), Context(cfg)
    load(dist, data)
    load(single, data)
    print(f"setup: {rows} fact rows over 4 devices, made and loaded in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    failures = 0
    for name, sql, ref in FOUR_QUERIES:
        batch, first, warm = run_query(dist, sql)
        got = result_columns(batch)
        bad = mismatch(got, ref(data))
        one = result_columns(single.sql_batch(sql)[0])
        bad_one = mismatch(got, one)
        failures += (bad is not None) + (bad_one is not None)
        print(f"four {name}: rows_out={len(got[0])} "
              f"reference={'match' if bad is None else 'MISMATCH ' + bad} "
              f"one_device={'match' if bad_one is None else 'MISMATCH ' + bad_one} "
              f"setup_first_call_s={first:.6f} warm_median_s={warm:.6f}",
              flush=True)

    spans = sorted({len(c.sharding.device_set)
                    for sb in dist._shard_cache.values()
                    for c in sb.columns.values()})
    failures += spans != [4]
    print(f"four sharding: {len(dist._shard_cache)} resident tables, "
          f"devices per column {spans}", flush=True)

    zb = shard_batch({"z": data["t"]["z"]}, rows, mesh, cfg)
    hot = jax.jit(jax.shard_map(
        lambda cols, cnt: detect_hot_keys(cols["z"], cnt[0], 4,
                                          cfg.skew_threshold, cfg.mesh_axis),
        mesh=mesh, in_specs=({"z": P(cfg.mesh_axis)}, P(cfg.mesh_axis)),
        out_specs=(P(), P()), check_vma=False,
    ))(zb.columns, zb.shard_counts)
    n_hot = int(np.count_nonzero(np.asarray(hot[1])))
    failures += n_hot == 0
    print(f"four salting: {n_hot} hot z keys detected", flush=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=FULL_ROWS,
                    help="fact rows (per device with --four)")
    ap.add_argument("--seed", type=int, default=SEED)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--choices", action="store_true",
                      help="time compaction and dense-vs-sort group-by")
    mode.add_argument("--four", action="store_true",
                      help="run only the distributed path on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    from harkdb_tpu.utils.device import card_line, require_gpu

    require_gpu(jax.devices())
    print(f"card: {card_line()}", flush=True)
    from harkdb_tpu.utils.compile_cache import use_compile_cache

    print(f"compile cache: {use_compile_cache()}", flush=True)
    if args.four:
        failures, count = run_four(args.rows, args.seed), 4
    elif args.choices:
        failures, count = run_choices(args.rows, args.seed), 1
    else:
        failures, count = run_smoke(args.rows, args.seed), 1
    if failures:
        print(f"chip_smoke: {failures} check(s) failed", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
