"""CLI: run SQL against CSV/parquet tables from the shell.

    python -m harkdb_tpu --table game_1=data.csv \
        "select col1, max(col3) from game_1 group by col1"

Flags: --table NAME=PATH (repeatable), --mesh (use all devices),
--explain, --profile DIR, --cpu (run on the CPU instead of the default
device; only ever chosen by the user).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="harkdb_tpu")
    ap.add_argument("sql", help="SQL statement")
    ap.add_argument("--table", action="append", default=[],
                    metavar="NAME=PATH", help="register a table (repeatable)")
    ap.add_argument("--mesh", action="store_true",
                    help="row-shard tables over all visible devices")
    ap.add_argument("--explain", action="store_true")
    ap.add_argument("--profile", metavar="DIR", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the default device")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from harkdb_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    from harkdb_tpu import Context

    mesh = None
    if args.mesh:
        from harkdb_tpu.parallel import make_engine_mesh

        mesh = make_engine_mesh()
    ctx = Context(mesh=mesh)
    for spec in args.table:
        name, _, path = spec.partition("=")
        if not path:
            ap.error(f"--table expects NAME=PATH, got {spec!r}")
        ctx.create_table(name, path)

    if args.explain:
        print(ctx.explain(args.sql))
        return 0
    if args.profile:
        out = ctx.profile(args.sql, args.profile)
        print(f"(trace written to {args.profile})", file=sys.stderr)
    else:
        df = ctx.sql_df(args.sql)
        print(df.to_string(index=False))
        m = ctx.last_metrics
        print(
            f"({m.rows_out} rows, plan {m.plan_ms:.1f} ms, "
            f"exec {m.execute_ms:.1f} ms)", file=sys.stderr,
        )
        return 0
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
