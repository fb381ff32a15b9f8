"""A tour of the engine surface beyond the reference's two smoke queries
(which live in examples/demo.py, ported 1:1 from reference test.py:1-9).

Run: python examples/tour.py    (runs on 8 virtual CPU devices so the
distributed examples work anywhere; on a GPU machine just build a Context).
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from harkdb_tpu import Context  # noqa: E402
from harkdb_tpu.parallel import make_engine_mesh  # noqa: E402

rng = np.random.default_rng(0)
n = 10_000
sales = pd.DataFrame({
    "region": rng.choice(["north", "south", "east", "west"], n),
    "product": rng.choice(["widget", "gadget", "doohickey"], n),
    "units": rng.integers(1, 50, n).astype(np.int32),
    "price": rng.uniform(5, 500, n).astype(np.float32),
})
regions = pd.DataFrame({
    "name": ["north", "south", "east", "west"],
    "manager": ["ada", "bob", "cyd", "dan"],
})

ctx = Context()
ctx.create_table("sales", sales)
ctx.create_table("regions", regions)

print("— string predicates, LIKE, aggregates —")
print(ctx.sql_df(
    "select region, product, sum(units) as total_units, "
    "avg(price) as avg_price "
    "from sales where product like '%get' and region != 'east' "
    "group by region, product order by total_units desc limit 5"
))

print("\n— string-key join (dictionaries merge at plan time) —")
print(ctx.sql_df(
    "select sales.region, regions.manager, sum(units) as u from sales "
    "join regions on sales.region = regions.name "
    "group by sales.region, regions.manager order by u desc"
))

print("\n— window functions —")
print(ctx.sql_df(
    "select region, units, "
    "row_number() over (partition by region order by units desc) as rn, "
    "sum(units) over (partition by region) as region_total "
    "from sales order by region, rn limit 8"
))

print("\n— scalar + IN subqueries —")
print(ctx.sql_df(
    "select region, count(*) as big_orders from sales "
    "where units > (select avg(units) from sales) "
    "and region in (select name from regions where manager != 'bob') "
    "group by region order by big_orders desc"
))

print("\n— UNION ALL with trailing ORDER BY —")
print(ctx.sql_df(
    "select region, units from sales where units >= 49 "
    "union all select region, units from sales where units = 1 "
    "order by units desc, region limit 6"
))

print("\n— LEFT JOIN with real NULLs (IS NULL, NaN decode, agg skip) —")
ctx.create_table("promos", pd.DataFrame({
    "prod": ["widget", "gizmo"], "discount": np.array([5, 9], np.int32),
}))
print(ctx.sql_df(
    "select sales.product, count(promos.discount) as promoted, "
    "count(*) as n from sales "
    "left join promos on sales.product = promos.prod "
    "group by sales.product order by sales.product"
))
print(ctx.sql_df(
    "select product, count(*) as no_promo from sales "
    "left join promos on sales.product = promos.prod "
    "where promos.discount is null group by product order by product"
))

print("\n— sliding-window frames (ROWS BETWEEN k PRECEDING ...) —")
print(ctx.sql_df(
    "select region, units, sum(units) over (partition by region "
    "order by units rows between 2 preceding and current row) as last3 "
    "from sales order by region, units limit 6"
))

print("\n— derived tables: aggregate of an aggregate —")
print(ctx.sql_df(
    "select count(*) as hot_products, max(d.u) as top from "
    "(select product, region, sum(units) as u from sales "
    "group by product, region) d where d.u > 2000"
))

print("\n— COALESCE defaults + CAST —")
print(ctx.sql_df(
    "select product, coalesce(promos.discount, 0) as disc, "
    "cast(price as int) as whole from sales "
    "left join promos on sales.product = promos.prod "
    "order by price desc limit 5"
))

print("\n— windows over GROUPED output —")
print(ctx.sql_df(
    "select region, sum(units) as u, "
    "rank() over (order by sum(units) desc) as rk "
    "from sales group by region order by rk"
))

print("\n— EXISTS as a semi-join —")
print(ctx.sql_df(
    "select region, count(*) as n from sales where exists "
    "(select 1 from regions where regions.name = sales.region "
    "and regions.manager != 'bob') group by region order by region"
))

print("\n— the same engine, distributed over an 8-device mesh —")
dctx = Context(mesh=make_engine_mesh(8))
dctx.create_table("sales", sales)
print(dctx.sql_df(
    "select region, units, rank() over "
    "(partition by region order by units desc) as rk "
    "from sales where units > 45 order by region, rk limit 6"
))

print("\n— round 5: three-valued logic (NULL predicates reject rows) —")
print(ctx.sql_df(
    "select product, promos.discount from sales "
    "left join promos on sales.product = promos.prod "
    "where promos.discount < 15 order by product limit 5"
))

print("\n— round 5: NULL aggregates (all-NULL group → NULL, not 0) —")
print(ctx.sql_df(
    "select region, avg(promos.discount) as d from sales "
    "left join promos on sales.product = promos.prod "
    "group by region order by d nulls last limit 5"
))

print("\n— round 5: FULL OUTER + multi-key ON —")
print(ctx.sql_df(
    "select sales.product, promos.prod from sales "
    "full outer join promos on sales.product = promos.prod "
    "order by sales.product nulls last limit 5"
))

print("\n— round 5: CTEs + correlated aggregate decorrelation —")
print(ctx.sql_df(
    "with by_region as (select region, sum(units) as u from sales "
    "group by region) "
    "select region, u from by_region "
    "where u > (select avg(s2.units) from sales s2 "
    "where s2.region = by_region.region) order by u desc limit 4"
))

print("\n— round 5: string functions + GROUP BY expressions —")
print(ctx.sql_df(
    "select upper(substr(region, 1, 3)) as r3, count(*) as n "
    "from sales group by upper(substr(region, 1, 3)) order by r3"
))

print("\n— round 5: FOLLOWING frames, NTILE, NTH_VALUE —")
print(ctx.sql_df(
    "select region, units, "
    "sum(units) over (partition by region order by units, product "
    "rows between 1 preceding and 1 following) as s3, "
    "ntile(2) over (partition by region order by units) as half, "
    "nth_value(units, 2) over (partition by region order by units, "
    "product) as second "
    "from sales order by region, units limit 6"
))
