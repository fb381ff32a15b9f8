"""hark-tpu: a vectorized SQL query-execution engine in JAX/XLA.

Built from scratch in JAX/XLA with the capabilities of philass/HarkDB
(reference: a Futhark-based GPU SQL engine). This is not a port — only the
observable contract is kept:

  * BlazingSQL-style Context API (``create_table`` / ``drop_table`` / ``sql``),
    mirroring reference ``FutharkContext.py:38-71``.
  * The full advertised SQL surface (reference ``README.md:8-15``): SELECT,
    FROM, WHERE, GROUP BY (sum/prod/max/min), HAVING, ORDER BY (SORT BY), JOIN —
    including the pieces the reference only sketches (WHERE is commented out at
    ``select.fut:18``; JOIN is never exported by ``main.fut``).
  * Output semantics: group-by results one row per distinct key, ascending key
    order (reference ``groupby.fut:21-22`` radix-sort consequence), projection
    preserving row order and duplicate columns (``select.fut:17-20``).

Underneath: resident columnar device arrays, static-shape padded batches
with valid counts, payload-carrying sorts for data movement, scans and
compactions for segment reductions, a scatter-add path for dense small-span
keys, and multi-device scaling via ``jax.sharding.Mesh`` + ``shard_map``
with all-to-all repartitioning and skew-salted shuffles. Everything is plain
XLA; the target device is an NVIDIA H100 (tests run on the CPU).
"""

from harkdb_tpu.config import EngineConfig
from harkdb_tpu.columnar.table import Table
from harkdb_tpu.api import Context

# BlazingSQL/HarkDB-compatible alias (reference FutharkContext.py:38).
FutharkContext = Context

__version__ = "0.1.0"

__all__ = ["Context", "FutharkContext", "Table", "EngineConfig", "__version__"]
