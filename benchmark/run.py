#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result as one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit). Without the CUDA cards the cell asks for, or when the run
has loaded JAX or the JAX package, it prints no result and exits non-zero.
See ``benchmark/lib/harness.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
