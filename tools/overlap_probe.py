"""Does XLA overlap the all_to_all exchange with independent local compute
inside one shard_map body? (round-3 stretch item; north star asks for
"exchange overlapped with probe/build compute").

Method: time three jitted shard_map programs on the 8-virtual-device CPU
mesh — (a) the exchange alone, (b) a data-independent compute chain alone,
(c) both in one body with no data dependence between them. c ≈ max(a, b)
means the scheduler overlaps them; c ≈ a + b means they serialize. CPU
collectives are memcpy-class, so this probes XLA's SCHEDULING decision, not
interconnect bandwidth.

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python tools/overlap_probe.py
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax                                    # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

D = 8
PER = 1 << 21            # rows per device for the exchange
CHAIN = 60               # elementwise rounds of independent compute


def main():
    mesh = Mesh(np.array(jax.devices()[:D]), ("s",))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, 1 << 20, D * PER).astype(np.int32))
    y = jnp.asarray(rng.integers(0, 1 << 20, D * PER).astype(np.int32))

    def exchange(xl):
        return jax.lax.all_to_all(
            xl.reshape(D, PER // D), "s", 0, 0
        ).reshape(-1)

    def compute(yl):
        def body(_, a):
            return a * 3 + (a >> 5) + 1
        return jax.lax.fori_loop(0, CHAIN, body, yl)

    def f_ex(xl, yl):
        return jnp.sum(exchange(xl)).reshape(1), jnp.sum(yl).reshape(1)

    def f_cp(xl, yl):
        return jnp.sum(xl).reshape(1), jnp.sum(compute(yl)).reshape(1)

    def f_both(xl, yl):
        return jnp.sum(exchange(xl)).reshape(1), jnp.sum(compute(yl)).reshape(1)

    out = {}
    for name, f in (("exchange", f_ex), ("compute", f_cp), ("both", f_both)):
        g = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P("s"), P("s")),
            out_specs=(P("s"), P("s")),
        ))
        _ = [int(jnp.sum(v)) for v in g(x, y)]        # compile+warm
        t0 = time.perf_counter()
        iters = 5
        for _i in range(iters):
            _ = [int(jnp.sum(v)) for v in g(x, y)]
        out[name] = round((time.perf_counter() - t0) / iters * 1e3, 2)
    a, b, c = out["exchange"], out["compute"], out["both"]
    out["overlap_ratio"] = round((a + b - c) / min(a, b), 3) if min(a, b) else 0
    out["verdict"] = (
        "overlapped" if c < 0.75 * (a + b) else "serialized"
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
