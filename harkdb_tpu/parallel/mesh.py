"""Device mesh construction.

The reference is strictly single-device (one ``Futhark(_main)`` context,
``FutharkContext.py:41``; no collectives anywhere — SURVEY §2 parallelism
table). Scaling here is mesh-native: a 1-D ``jax.sharding.Mesh`` over all
devices with axis ``"shards"``; tables are row-sharded over it and operators
run under ``jax.shard_map`` with XLA collectives (``all_to_all`` for the
hash shuffle, ``psum``/``all_gather`` for merges). The 1-D axis assumes no
topology: on one host the GPUs are joined all to all by NVLink.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from harkdb_tpu.config import EngineConfig, DEFAULT_CONFIG

AXIS = "shards"


def make_engine_mesh(
    n_devices: Optional[int] = None,
    config: EngineConfig = DEFAULT_CONFIG,
) -> Mesh:
    """1-D mesh over the first ``n_devices`` (default: all visible)."""
    devs = jax.devices()
    n = n_devices or config.num_shards or len(devs)
    if n > len(devs):
        raise ValueError(f"Requested {n} devices, only {len(devs)} visible")
    return jax.make_mesh((n,), (config.mesh_axis,), devices=devs[:n])


def row_spec(config: EngineConfig = DEFAULT_CONFIG) -> P:
    return P(config.mesh_axis)


def row_sharding(mesh: Mesh, config: EngineConfig = DEFAULT_CONFIG) -> NamedSharding:
    return NamedSharding(mesh, row_spec(config))
