"""The port's benchmark: one run of one cell on the card it is started on.

    python3 qmcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the check's numbers beside their limits as the last lines of
standard error and one JSON line of results as the last line of standard
output; exits with a code other than 0, printing no result, where the card
or the port is missing or the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from qmcbench import harness

    return harness.main(args, T_START)


if __name__ == '__main__':
    sys.exit(main())
