"""The reference's smoke driver, ported 1:1 (reference test.py:1-9).

Run: python examples/demo.py   (any backend: the GPU when JAX finds one,
else the CPU)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from harkdb_tpu import FutharkContext

fc = FutharkContext()
fc.create_table(
    "game_1",
    os.path.join(os.path.dirname(__file__), "..", "tests", "data", "data.csv"),
)
result = fc.sql("select col1, col3 from game_1")           # test.py:6
result2 = fc.sql("select col1, max(col3) from game_1 group by col1")  # test.py:7
print(result)
print(result2)
