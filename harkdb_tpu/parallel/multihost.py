"""Multi-host initialization (SURVEY §5 distributed-backend slot).

The reference has no networking at all. Here multi-host runs use
``jax.distributed.initialize`` — after it, ``jax.devices()`` spans every
host's chips, ``make_engine_mesh()`` builds a global mesh, and the engine's
``all_to_all``/``psum`` collectives compile over NVLink within a host and
the network between hosts, with no operator code changes (operators only
see the mesh).

CI-testable without a pod via multi-process CPU JAX: each process forces the
CPU platform and joins the same coordinator (tests/test_multihost.py spawns
worker subprocesses running :func:`worker_demo`, which drives the engine's
actual shuffle primitive — hash repartition with all_to_all — across the
process boundary and psum-checks the result).

Result collection across processes: the executor's gather
(``ShardedBatch.to_batch_device``) all_gathers to a fully-REPLICATED
ColumnBatch, every distributed control scalar (shuffle overflow, join
capacity) is psum/pmax-replicated before the host reads it, and table
placement uses ``jax.make_array_from_callback`` under multi-process — so a
2-process run executes a full SQL query end-to-end and every process reads
the complete result (:func:`worker_sql`, exercised by
tests/test_multihost.py against the single-process answer).
"""

from __future__ import annotations

import jax


def init_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids=None,
) -> None:
    """Join a multi-process JAX cluster. Call once, before any jax use."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def worker_demo(coordinator: str, num_processes: int, process_id: int) -> str:
    """Drive the engine's shuffle across a real process boundary.

    Each process contributes one CPU device to a global mesh; rows are hash-
    repartitioned with the engine's ``repartition_by_key`` (one all_to_all),
    and two invariants are psum-verified: no rows lost, and every key's rows
    co-located on one shard. Returns "OK <total>" (checked by the test).
    """
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from harkdb_tpu.config import EngineConfig
    from harkdb_tpu.parallel.mesh import make_engine_mesh
    from harkdb_tpu.parallel.shuffle import hash_to_bucket, repartition_by_key

    init_multihost(coordinator, num_processes, process_id)
    cfg = EngineConfig()
    mesh = make_engine_mesh(config=cfg)
    D = mesh.devices.size
    axis = cfg.mesh_axis

    C = 256                                       # rows per shard
    rng = np.random.default_rng(0)                # same data everywhere
    keys_global = rng.integers(0, 40, D * C).astype(np.int32)
    vals_global = rng.integers(0, 1000, D * C).astype(np.int32)
    sharding = NamedSharding(mesh, P(axis))
    keys = jax.device_put(keys_global, sharding)
    vals = jax.device_put(vals_global, sharding)

    @jax.jit
    def run(k, v):
        def body(kl, vl):
            cols, n_out, overflow = repartition_by_key(
                {"k": kl, "v": vl}, "k", jnp.int32(C), axis, D, C * D
            )
            # invariant 1: total rows preserved
            total = jax.lax.psum(n_out, axis)
            # invariant 2: my rows' keys all hash to me
            i = jax.lax.axis_index(axis).astype(jnp.int32)
            live = jnp.arange(cols["k"].shape[0], dtype=jnp.int32) < n_out
            owned = hash_to_bucket(cols["k"], D) == i
            misrouted = jax.lax.psum(
                jnp.sum(live & jnp.logical_not(owned)).astype(jnp.int32), axis
            )
            ok = jnp.logical_and(total == D * C, misrouted == 0)
            return (ok.astype(jnp.int32).reshape(1),
                    total.reshape(1), overflow.reshape(1))

        return jax.shard_map(
            body, mesh=mesh, in_specs=(P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(axis)),
        )(k, v)

    ok, total, overflow = run(keys, vals)
    # each process reads its own (addressable) shard of the replicated-ish
    # per-shard flags
    ok_local = int(np.asarray(ok.addressable_shards[0].data)[0])
    total_local = int(np.asarray(total.addressable_shards[0].data)[0])
    of_local = int(np.asarray(overflow.addressable_shards[0].data)[0])
    assert ok_local == 1 and of_local == 0, (ok_local, of_local)
    return f"OK {total_local}"


def worker_sql(coordinator: str, num_processes: int, process_id: int) -> str:
    """End-to-end SQL across a real process boundary (SURVEY §7.5 done).

    Each process contributes one CPU device; tables are row-sharded over the
    2-process mesh; a join + WHERE + GROUP BY + HAVING + ORDER BY query runs
    through the distributed executor (all_to_all shuffles cross the process
    boundary) and EVERY process materializes the full gathered result, which
    must match a locally-computed single-device answer bit for bit.
    """
    import numpy as np

    from harkdb_tpu import Context, EngineConfig
    from harkdb_tpu.parallel.mesh import make_engine_mesh

    init_multihost(coordinator, num_processes, process_id)
    cfg = EngineConfig(row_align=64)
    mesh = make_engine_mesh(config=cfg)
    assert mesh.devices.size == num_processes

    rng = np.random.default_rng(0)                # same data everywhere
    n = 500
    facts = {
        "k": rng.integers(0, 9, n).astype(np.int32),
        "v": rng.integers(-50, 50, n).astype(np.int32),
    }
    dims = {
        "j": np.arange(9, dtype=np.int32),
        "m": rng.integers(1, 5, 9).astype(np.int32),
    }
    q = ("select k, sum(v), max(m), count(*) from facts "
         "join dims on facts.k = dims.j "
         "where v > -40 group by k having count(*) > 1 order by k")

    dc = Context(cfg, mesh=mesh)
    dc.create_table("facts", facts)
    dc.create_table("dims", dims)
    out = dc.sql(q)                               # full result, every process

    sc = Context(cfg)                             # single-device oracle
    sc.create_table("facts", facts)
    sc.create_table("dims", dims)
    expect = sc.sql(q)
    np.testing.assert_array_equal(out, expect)

    # Ungrouped distributed tail across the process boundary: the
    # range-partitioned ORDER BY's sample all_gather + row all_to_all and
    # the sharded LIMIT window all cross processes; multi-process collection
    # all_gathers (every process must return the full result).
    q2 = "select v, k from facts where v != 0 order by v desc, k limit 37"
    np.testing.assert_array_equal(dc.sql(q2), sc.sql(q2))
    q3 = "select distinct k from facts order by k desc"
    np.testing.assert_array_equal(dc.sql(q3), sc.sql(q3))
    return f"SQL OK {out.shape[0]}x{out.shape[1]}"
