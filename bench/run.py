"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's numbers compared with their limits as the last lines of
standard error, and one JSON line as the last line of standard output.  It
needs the card: without one it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the driver's CUDA JIT cache stays inside the checkout, at a fixed path
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
