"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The last line of
standard output is the result as one JSON object; the numbers that decide
``correct`` are the last lines of standard error.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    return harness.main(args, START)


if __name__ == "__main__":
    sys.exit(main())
