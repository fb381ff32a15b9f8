"""chip_smoke.py's queries and references on the CPU at a small size, its
device check, the compile-cache placement, and the engine without pandas.

The script itself refuses to run without a GPU; here its query list runs
through ``Context.sql_batch`` on 4096 fact rows and is compared with the
script's own numpy reference, which checks both.
"""

import importlib
import os
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

ROWS = 4096


@pytest.fixture(scope="module")
def smoke_ctx():
    from harkdb_tpu import Context

    data = chip_smoke.make_data(ROWS, seed=0)
    ctx = Context()
    chip_smoke.load(ctx, data)
    return ctx, data


@pytest.mark.parametrize("name,sql,ref", chip_smoke.QUERIES,
                         ids=[q[0] for q in chip_smoke.QUERIES])
def test_query_matches_reference(smoke_ctx, name, sql, ref):
    ctx, data = smoke_ctx
    batch, _names = ctx.sql_batch(sql)
    got = chip_smoke.result_columns(batch)
    want = ref(data)
    assert chip_smoke.mismatch(got, want) is None, name
    assert len(got[0]) > 0


def test_device_check_refuses_cpu():
    from harkdb_tpu.utils.device import require_gpu

    with pytest.raises(SystemExit, match="needs a GPU"):
        require_gpu(jax.devices("cpu"))


@pytest.mark.parametrize("env_dir", [None, "elsewhere/cache"])
def test_compile_cache_placement(monkeypatch, env_dir):
    from harkdb_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
        assert compile_cache.use_compile_cache() == want
        assert calls == [("jax_compilation_cache_dir", want)]
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert compile_cache.use_compile_cache() == env_dir
        assert calls == []              # JAX reads the variable itself


def test_engine_runs_without_pandas(monkeypatch):
    """import, create_table from a dict of arrays and sql with pandas
    hidden: a fresh import of the package must not need it."""
    monkeypatch.setitem(sys.modules, "pandas", None)   # import → ImportError
    for name in [m for m in sys.modules
                 if m == "harkdb_tpu" or m.startswith("harkdb_tpu.")]:
        monkeypatch.delitem(sys.modules, name)
    hdb = importlib.import_module("harkdb_tpu")
    ctx = hdb.Context()
    k = np.array([3, 1, 3, 2, 1], np.int32)
    v = np.array([10, 20, 30, 40, 50], np.int32)
    ctx.create_table("t", {"k": k, "v": v})
    out = ctx.sql("select k, sum(v), count(*) from t group by k")
    np.testing.assert_array_equal(out, [[1, 70, 2], [2, 40, 1], [3, 40, 2]])
    with pytest.raises(ImportError, match="pandas"):
        ctx.sql_df("select k from t")
