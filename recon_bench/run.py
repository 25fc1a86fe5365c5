"""Run one cell of the benchmark once:

    python3 recon_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result object; see README.md.
"""
import time

T_PROCESS = time.perf_counter()     # set-up counts from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".recon_bench_cache")
# every kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
sys.path.insert(0, ROOT)

from recon_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
