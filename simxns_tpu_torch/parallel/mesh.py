"""Shape helpers (own copy of ``simxns_tpu.parallel.mesh.pad_to_multiple``).

The port runs on one device; the sharded mesh waits for the multi-GPU
slice.
"""

from __future__ import annotations

import math


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)
