"""The benchmark's command: one run of one cell on the card.

    python3 -m ltebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object with
`correct`, `attempted`, `failed`, `metrics`, `device` (and with --trace 1
`breakdown`), and `check` last: each number that `correct` compared, with
its limit, which the last lines of standard error repeat.  Exits with
another code than 0, and prints no result, when the machine has fewer
CUDA devices than the cell asks for.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from ltebench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
