"""Run one cell of the benchmark once (see portbench/harness.py):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port.

Python's bytecode for every module the run imports (PyTorch's too) is
cached in ``.pycache/`` at the checkout's root, written by the first run
there and read by the later ones, also where the environment turns
bytecode writing off (``PYTHONDONTWRITEBYTECODE``): without it each run
compiles PyTorch's sources anew, about 7 s of its set-up.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.pycache_prefix = os.path.join(ROOT, ".pycache")
sys.dont_write_bytecode = False

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
