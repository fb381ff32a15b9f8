"""Operator and query timings on one GPU.

Times the engine's operators on synthetic int32 tables — predicate filter
(WHERE), GROUP BY (sort path and dense-key path), inner join, ORDER BY — and
the scan→filter→group→sort mix, both hand-rolled from the operators and
driven through ``Context.sql`` on a resident table, plus a window query.
Prints ONE JSON line to stdout:

    {"metric": "query_mix_rows_per_s", "value": N, "unit": "rows/s",
     "ops": {...}, "op_ms": {...}, "rows": n, "device": {...}, "card": ...}

``value`` is the ``Context.sql`` mix; ``ops`` holds every stage's rate
(join: output pairs/s). Each stage is timed with ``jax.block_until_ready``
as the median of ``HARKDB_BENCH_ITERS`` (default 3) calls after one
compiling call. No peak rate is divided in here.

Without a GPU the script exits non-zero; a stage that fails fails the run.

Env: HARKDB_BENCH_ROWS (default 2**24), HARKDB_BENCH_ITERS (default 3).
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def median_time(fn, iters: int) -> float:
    """Seconds per call of ``fn()`` (median of ``iters`` after a compiling
    call), waiting for the device with ``jax.block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    log(f"  first call (compile) {time.perf_counter() - t0:.3f} s")
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main() -> int:
    import jax

    from harkdb_tpu.utils.device import card_line, require_gpu

    require_gpu(jax.devices())
    card = card_line()
    from harkdb_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    import jax.numpy as jnp

    from harkdb_tpu import Context
    from harkdb_tpu.columnar.batch import ColumnBatch
    from harkdb_tpu.ops.dense_agg import dense_groupby_sums
    from harkdb_tpu.ops.groupby import groupby_batch
    from harkdb_tpu.ops.join import inner_join_indices
    from harkdb_tpu.ops.sort import sort_batch
    from harkdb_tpu.prims.compaction import compact_batch

    n = int(os.environ.get("HARKDB_BENCH_ROWS", 1 << 24))
    iters = int(os.environ.get("HARKDB_BENCH_ITERS", 3))
    n_keys = 1 << 20
    dev = jax.devices()[0]
    log(f"card: {card}; device: {dev.platform} {dev.device_kind}, rows={n:,}")

    rng = np.random.default_rng(0)
    key_np = rng.integers(0, n_keys, n).astype(np.int32)
    val_np = rng.integers(-1000, 1000, n).astype(np.int32)
    key = jax.device_put(key_np)
    val = jax.device_put(val_np)
    rkey = jax.device_put(rng.permutation(n_keys).astype(np.int32))
    nv = jnp.int32(n)
    aggs = [("v", "sum", "s"), ("v", "max", "m"), ("v", "count", "c")]

    @jax.jit
    def run_filter(k, v, nv):
        b = ColumnBatch({"k": k, "v": v}, nv)
        return compact_batch(b, b.column("v") > 0)

    @jax.jit
    def run_groupby(k, v, nv):
        return groupby_batch(ColumnBatch({"k": k, "v": v}, nv), "k", aggs)

    @jax.jit
    def run_groupby_dense(k, v, nv):
        return dense_groupby_sums(k & 4095, [v], nv, jnp.int32(0), 4096)

    @jax.jit
    def run_sort(k, v, nv):
        return sort_batch(ColumnBatch({"k": k, "v": v}, nv), ["k"])

    @jax.jit
    def run_join(lk, rk, nl):
        return inner_join_indices(lk, nl, rk, jnp.int32(n_keys),
                                  out_capacity=lk.shape[0])

    # Hand-rolled mix: the planner's three-phase pipeline (filter, group at a
    # capacity bucketed to the survivors, ORDER BY at a capacity bucketed to
    # the groups), with its two host read-backs.
    @functools.lru_cache(maxsize=8)
    def mix_group_for(cap1):
        @jax.jit
        def group(fb):
            b = ColumnBatch({c: a[:cap1] for c, a in fb.columns.items()},
                            fb.n_valid)
            return groupby_batch(b, "k", aggs)
        return group

    @functools.lru_cache(maxsize=8)
    def mix_tail_for(cap2):
        @jax.jit
        def tail(g):
            b = ColumnBatch({c: a[:cap2] for c, a in g.columns.items()},
                            g.n_valid)
            return sort_batch(b, ["s"], descending=[True])
        return tail

    def run_mix():
        fb = run_filter(key, val, nv)
        cap1 = min(1 << max(10, (int(fb.n_valid) - 1).bit_length()), n)
        g = mix_group_for(cap1)(fb)
        cap2 = min(1 << max(10, (int(g.n_valid) - 1).bit_length()), cap1)
        return mix_tail_for(cap2)(g)

    ctx = Context()
    ctx.create_table("t", {"k": key_np, "v": val_np})
    q_mix = ("select k, sum(v) as s, max(v) as m, count(*) as c "
             "from t where v > 0 group by k order by s desc")
    q_window = ("select k, sum(v) over (partition by k order by v) as rs, "
                "row_number() over (order by v desc, k) as rn from t "
                "order by v desc, k")

    stages = [
        ("filter", lambda: run_filter(key, val, nv)),
        ("groupby", lambda: run_groupby(key, val, nv)),
        ("mix", run_mix),
        ("sql", lambda: ctx.sql_batch(q_mix)[0]),
        ("sort", lambda: run_sort(key, val, nv)),
        ("window", lambda: ctx.sql_batch(q_window)[0]),
        ("groupby_dense", lambda: run_groupby_dense(key, val, nv)),
        ("join", lambda: run_join(key, rkey, nv)),
    ]
    rates, times_ms = {}, {}
    for name, fn in stages:
        log(f"[stage {name}]")
        dt = median_time(fn, iters)
        rates[name] = n / dt
        times_ms[name] = dt * 1e3
        log(f"  {name}: {dt * 1e3:.3f} ms, {n / dt / 1e9:.3f} Grows/s")

    print(json.dumps({
        "metric": "query_mix_rows_per_s",
        "value": rates["sql"],
        "unit": "rows/s",
        "ops": rates,
        "op_ms": times_ms,
        "rows": n,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
