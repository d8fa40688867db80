"""Run one cell of the benchmark of lanczos_torch on the cards of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout.  It prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``check`` (each number compared with the reference, beside its limit).  It
exits 2, printing no result, with fewer CUDA devices than the cell asks
for, and 3 if a JAX module was loaded.  ``benchmark/README.md`` describes
the files it reads.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this script's directory, is where imports start
# (the program builds its kernels into lanczos_torch/_build/ there)
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
