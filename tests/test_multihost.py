"""Multi-process CPU test of the distributed backend (SURVEY §4d / §7.5).

Spawns 2 real OS processes that join one jax.distributed cluster over a
localhost coordinator and run the engine's all_to_all hash shuffle across the
process boundary — the closest a single machine gets to multi-host.
"""

import os
import socket
import subprocess
import sys


WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)      # exactly 1 device per process
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
from harkdb_tpu.parallel.multihost import {fn}
print({fn}({coord!r}, 2, int(sys.argv[1])), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two_process(tmp_path, fn, expect_marker):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coord = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=repo, coord=coord, fn=fn))
    # Workers get an allow-listed environment: nothing inherited may touch
    # a backend before jax.distributed.initialize runs, and no XLA_FLAGS
    # (exactly 1 CPU device per process).
    env = {k: os.environ[k] for k in ("PATH", "PYTHONPATH", "HOME")
           if k in os.environ}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed: {err[-2000:]}"
        assert expect_marker in out, (out, err[-500:])


def test_two_process_shuffle(tmp_path):
    _run_two_process(tmp_path, "worker_demo", "OK 512")


def test_two_process_sql_end_to_end(tmp_path):
    """VERDICT round-1 item 6: a 2-process cluster runs a full SQL query
    (join + where + groupby + having + order by) and EVERY process collects
    the complete result, equal to the single-process answer."""
    _run_two_process(tmp_path, "worker_sql", "SQL OK")
