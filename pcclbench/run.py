"""Run one cell of the port's benchmark once and print its result line.

    python3 pcclbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout: the program under test is ``src/repro_torch``.
The last line of standard output is the result's JSON object; the numbers
that decided ``correct`` are the last lines of standard error.
"""

import sys
import time

T0 = time.time()

if __name__ == "__main__":
    from pathlib import Path

    # the checkout's root in place of this folder: its modules are
    # imported as ``pcclbench.<name>`` and shadow no other module
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from pcclbench.harness import run

    sys.exit(run(sys.argv[1:], t0=T0))
