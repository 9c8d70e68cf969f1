"""The benchmark of ``mmt_tpu_torch`` on NVIDIA cards.

    python3 mmtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process is one run: it builds the cell's program and inputs from the
seed (set-up, which the first run of a checkout spends compiling the CUDA
sources), measures for ``--seconds``, with ``--trace 1`` traces a short
stretch after the window, checks what the program produced against the
plain reference, and prints one JSON line last on standard output (the
numbers compared, each beside its limit, also last on standard error).
Caches stay inside the checkout.  See ``harness.py``.
"""

import argparse
import os
import sys
import time

T_START = time.perf_counter()
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(CHECKOUT, ".mmtbench_cache")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, CHECKOUT)
    from mmtbench.harness import run

    return run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
