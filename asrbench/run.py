"""Run one cell of the benchmark of thunder_tpu_torch on this machine's card(s).

    python asrbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of standard output (a JSON object) and each
compared number beside its limit as the last lines of standard error. Exits non-zero, printing no result, where
the card the cell needs is absent, where the program cannot be imported, or where the run loaded JAX or the JAX
package.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from asrbench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.entry(T0))
