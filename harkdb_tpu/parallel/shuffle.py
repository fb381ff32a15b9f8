"""Distributed hash shuffle — the engine's repartition-by-key primitive.

Everything here runs INSIDE ``jax.shard_map`` on per-device local blocks.
The exchange is a single XLA ``all_to_all`` per column over the mesh axis
(NVLink between the GPUs of one host), replacing the reference's... nothing — the
reference has no distributed layer at all (SURVEY §5); this is the mechanism
BASELINE.json's north star mandates ("distributed shuffle for joins and
aggregates using all-to-all").

Static-shape protocol (XLA cannot do variable-size sends):
  1. each shard bins its live rows into D buckets of static capacity C
     (``bucket_cap``) keyed by a multiplicative hash of the partition key;
  2. bucket buffers (D, C) are exchanged untiled — device j receives every
     shard's bucket j — alongside the (D,) bucket counts;
  3. received rows are compacted into a packed local block of capacity D*C.

If any bucket overflows C, rows would be lost — so an overflow flag is
psum-reduced across shards and returned; the host-side caller retries with a
doubled C (capacity buckets are powers of two, bounding the jit cache).
Skew handling (salted repartition of hot keys) lives in
``harkdb_tpu.parallel.skew``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from harkdb_tpu.prims.segmented import segmented_iota

Array = jax.Array

# Knuth multiplicative hash constant (2^32 / phi). Kept as a plain int —
# a module-level jnp constant would initialize the XLA backend at import
# time, breaking jax.distributed.initialize (must run before any backend
# use).
_HASH_MULT = 2654435761


def hash_to_bucket(key: Array, n_buckets: int, salt: int = 0) -> Array:
    """Multiplicative hash → bucket id in [0, n_buckets). Mixes high bits so
    consecutive keys spread; plain ``key % D`` would be skew-prone."""
    k = key.astype(jnp.uint32)
    if salt:
        k = k ^ jnp.uint32((salt * 0x9E3779B9) & 0xFFFFFFFF)
    h = (k * jnp.uint32(_HASH_MULT))
    h = h ^ (h >> 16)
    return (h % jnp.uint32(n_buckets)).astype(jnp.int32)


def bucketize(
    cols: Dict[str, Array],
    dest: Array,
    n_valid: Array,
    n_buckets: int,
    bucket_cap: int,
) -> Tuple[Dict[str, Array], Array, Array]:
    """Bin local rows by ``dest`` into (n_buckets, bucket_cap) buffers.

    Returns (buffers, counts, overflowed). Rows beyond a bucket's capacity are
    dropped from the buffer — ``overflowed`` flags that loss. Row order within
    a bucket preserves local row order (stable).
    """
    n = dest.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < n_valid
    dest = jnp.where(valid, dest, n_buckets)      # pads → sentinel bucket

    counts = jnp.bincount(
        jnp.where(valid, dest, n_buckets), length=n_buckets + 1
    )[:n_buckets].astype(jnp.int32)
    overflowed = jnp.any(counts > bucket_cap)

    # Stable sort rows by destination, carrying every column as payload (one
    # sort instead of a per-column permutation gather — see ops/groupby.py for
    # the measured rationale); position within run = local slot.
    names = list(cols.keys())
    sorted_all = jax.lax.sort(
        [dest] + [cols[c] for c in names], num_keys=1, is_stable=True
    )
    sdest = sorted_all[0]
    starts = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sdest[1:] != sdest[:-1]]
    )
    slot = segmented_iota(starts)
    svalid = jnp.arange(n, dtype=jnp.int32) < n_valid
    target = jnp.where(
        svalid & (slot < bucket_cap) & (sdest < n_buckets),
        sdest * bucket_cap + slot,
        n_buckets * bucket_cap,                   # dropped
    )
    buffers = {}
    for name, vals in zip(names, sorted_all[1:]):
        buf = jnp.zeros((n_buckets * bucket_cap,), vals.dtype)
        buffers[name] = buf.at[target].set(
            vals, mode="drop", unique_indices=True
        ).reshape(n_buckets, bucket_cap)
    return buffers, counts, overflowed


def exchange(
    buffers: Dict[str, Array], counts: Array, axis_name: str
) -> Tuple[Dict[str, Array], Array]:
    """All-to-all: device j receives bucket j of every shard (leading dim =
    mesh axis size, untiled)."""
    recv = {
        name: jax.lax.all_to_all(buf, axis_name, 0, 0)
        for name, buf in buffers.items()
    }
    recv_counts = jax.lax.all_to_all(
        counts.reshape(-1, 1), axis_name, 0, 0
    ).reshape(-1)
    return recv, recv_counts


def compact_received(
    recv: Dict[str, Array], recv_counts: Array
) -> Tuple[Dict[str, Array], Array]:
    """Pack received (D, C) buffers into contiguous local columns.

    Order: sending shard 0's rows first, then shard 1's, ... — deterministic,
    so reshuffling is reproducible (SURVEY §5 failure-detection slot: queries
    are pure and re-executable)."""
    first = next(iter(recv.values()))
    D, C = first.shape
    slot_idx = jax.lax.broadcasted_iota(jnp.int32, (D, C), 1)
    mask = (slot_idx < recv_counts[:, None]).reshape(-1)
    total = jnp.sum(mask).astype(jnp.int32)
    # Sort-carry compaction (one stable sort, no per-column gathers).
    names = list(recv.keys())
    dropped = jnp.logical_not(mask).astype(jnp.int32)
    out = jax.lax.sort(
        [dropped] + [recv[c].reshape(-1) for c in names],
        num_keys=1, is_stable=True,
    )
    live = jnp.arange(D * C, dtype=jnp.int32) < total
    cols = {
        name: jnp.where(live, col, 0) for name, col in zip(names, out[1:])
    }
    return cols, total


def repartition_by_key(
    cols: Dict[str, Array],
    key_name: str,
    n_valid: Array,
    axis_name: str,
    n_shards: int,
    bucket_cap: int,
    salt: int = 0,
    dest_is_bucket: bool = False,
) -> Tuple[Dict[str, Array], Array, Array]:
    """Full shuffle (inside shard_map): rows land on shard
    ``hash(key) % D`` (or directly on ``cols[key_name]`` when
    ``dest_is_bucket`` — used for precomputed multi-key routing). Returns
    (local_cols of capacity D*bucket_cap, local_n_valid, overflow flag
    psum-reduced over shards)."""
    if dest_is_bucket:
        dest = cols[key_name].astype(jnp.int32)
    else:
        dest = hash_to_bucket(cols[key_name], n_shards, salt)
    return repartition_with_dest(
        cols, dest, n_valid, axis_name, n_shards, bucket_cap
    )


def repartition_with_dest(
    cols: Dict[str, Array],
    dest: Array,
    n_valid: Array,
    axis_name: str,
    n_shards: int,
    bucket_cap: int,
) -> Tuple[Dict[str, Array], Array, Array]:
    """Shuffle on a precomputed per-row destination (skew-salted routing
    uses this; see ``harkdb_tpu.parallel.skew``)."""
    buffers, counts, overflowed = bucketize(
        cols, dest, n_valid, n_shards, bucket_cap
    )
    recv, recv_counts = exchange(buffers, counts, axis_name)
    out_cols, out_n = compact_received(recv, recv_counts)
    any_overflow = jax.lax.psum(overflowed.astype(jnp.int32), axis_name)
    return out_cols, out_n, any_overflow
