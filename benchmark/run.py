"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It prints one JSON line as the last line of
standard output (``--trace 0``: the cell's end-to-end metrics; ``--trace
1``: its per-layer metrics) and exits 0; without the CUDA cards the cell
asks for it prints no result and exits 3.  The program's kernel build
(``build/textreid_torch``) and any other compile cache live in fixed
directories under the checkout's ``build/``, so only a checkout's first
run compiles."""

import os
import sys
import time
from pathlib import Path


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - process_age()
ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from benchmark.harness.runner import main

    sys.exit(main(sys.argv[1:], T0))
