"""Engine configuration.

The reference has no config surface at all (no CLI, no env vars — SURVEY §5;
its only knob is the Futhark compile target hardcoded in ``setup.sh:12``).
Here a small dataclass carries every tunable: dtype policy, capacity bucketing
for static-shape outputs, mesh shape, and skew handling.
Env-var overrides (``HARKDB_*``) exist for benchmark sweeps.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name: str, cast, default):
    raw = os.environ.get(f"HARKDB_{name}")
    if raw is None:
        return default
    return cast(raw)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """All engine tunables. Immutable; pass a replaced copy to change."""

    # ---- dtype policy -------------------------------------------------------
    # Reference kernels use i32 for select (select.fut:23) and u32 for groupby
    # (groupby.fut:51); we normalize to int32 + float32 with explicit casts.
    int_dtype: str = "int32"
    float_dtype: str = "float32"

    # ---- static-shape management -------------------------------------------
    # Row counts are padded up to a multiple of `row_align` so tables of
    # nearby sizes share one static shape, which bounds the jit cache.
    # Data-dependent output sizes (join) are bucketed to powers of two for
    # the same reason.
    row_align: int = 1024
    # After a filter-pushdown compaction on a single-table query, slice the
    # working capacity down to the live row count (power-of-two bucket)
    # before phase B — its sorts then run over the SURVIVORS, not the input
    # capacity (a 50%-selectivity 16M-row group-by sorts 8M rows: ~half the
    # sort time for one n_valid host readback). Engaged only at or above
    # this capacity so small queries skip the sync.
    shrink_rows_min: int = 1 << 22

    # ---- distribution -------------------------------------------------------
    # Mesh axis name for data (row) partitioning; single axis "shards".
    mesh_axis: str = "shards"
    # Number of devices to use; None = all visible devices.
    num_shards: Optional[int] = None
    # Skew handling: a key whose local count exceeds `skew_threshold` x
    # (local rows / D) is nominated hot and salted over all shards
    # (parallel/skew.py).
    skew_threshold: float = 0.25
    # Salted repartitioning for distributed joins (parallel/skew.py).
    skew_salted_join: bool = True
    # Run ungrouped tails (ORDER BY / OFFSET / LIMIT / projection) SHARDED —
    # range-partitioned distributed sort + per-shard window — instead of
    # replicating the full result on every device before run_tail
    # (parallel/executor.py _ungrouped_tail). DISTINCT still gathers (its
    # output is group-sized).
    dist_tail: bool = True

    # ---- reference-parity compat ---------------------------------------------
    # The reference's groupby orders output keys by u32 bit pattern (radix
    # sort, groupby.fut:21-22), which puts NEGATIVE keys after positive ones.
    # This engine defaults to signed-ascending order (identical for the
    # non-negative keys the reference's tables use); set True to reproduce
    # the reference's u32 order exactly (tests/test_parity.py pins both).
    compat_u32_key_order: bool = False

    # ---- observability / safety ---------------------------------------------
    collect_metrics: bool = True
    log_level: str = "WARNING"
    # Validate engine invariants (ColumnBatch capacity/n_valid) at operator
    # boundaries — jax.debug callbacks inside jit (utils/checks.py).
    debug_checks: bool = False
    # Re-execute a query once from resident tables on a transient device
    # failure (queries are pure — SURVEY §5 failure-detection slot).
    retry_on_failure: bool = True

    @staticmethod
    def from_env() -> "EngineConfig":
        base = EngineConfig()
        return dataclasses.replace(
            base,
            int_dtype=_env("INT_DTYPE", str, base.int_dtype),
            float_dtype=_env("FLOAT_DTYPE", str, base.float_dtype),
            row_align=_env("ROW_ALIGN", int, base.row_align),
            num_shards=_env("NUM_SHARDS", int, base.num_shards),
            log_level=_env("LOG_LEVEL", str, base.log_level),
        )

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = EngineConfig.from_env()
