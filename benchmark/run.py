"""The benchmark's command: ``python -m benchmark.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``, from the root of a checkout.

It runs on the machine it is started on and refuses to run (exit code 2,
no result) without as many CUDA devices as the cell asks for.
"""
import time

T_START = time.time()

import sys  # noqa: E402

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
