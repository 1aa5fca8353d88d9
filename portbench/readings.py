"""The readings that a cell's limits are set from: the compared numbers
of the program, of the control (the plain reference with TF32 products
in the program's place), of the faults planted in the reference and of
any witness (the mode's `readings()`), over many seeds, in one process.

    python3 portbench/readings.py --workload <cell> --seconds <s> \
        --seeds 1 2 3 ... [--out FILE]

Each seed is one run of the cell (set-up, a window of `--seconds`, the
check), whose result, with the program's and the control's numbers, goes
as one JSON line to standard output and to FILE.
"""

import argparse
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.harness import runner  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--out')
    a = p.parse_args(argv)
    for seed in a.seeds:
        res = runner.run(a.workload, seed, a.seconds, False, judge=False,
                         control=True, out=io.StringIO())
        line = json.dumps(runner.jsonable(res))
        print(f'seed {seed} {line}', flush=True)
        if a.out:
            with open(a.out, 'a') as f:
                f.write(f'{seed} {line}\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
