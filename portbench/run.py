"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Prints the set-up phases and the compared numbers on standard error
and the result as the last line of standard output; exits 1 without a
result where there is no card or JAX or the JAX package was loaded.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.harness import runner, spec  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        runner.run(a.workload, a.seed, a.seconds, bool(a.trace))
    except (runner.RunError, spec.SpecError) as e:
        print(f'portbench: {e}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
