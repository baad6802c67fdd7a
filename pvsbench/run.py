"""Run one cell of the benchmark once.

    python3 pvsbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (also as ``python -m pvsbench.run``). The last
line of standard output is the result; the compared numbers and their
limits are the last lines of standard error. See ``README.md``.
"""
import sys
from pathlib import Path

if __name__ == '__main__':
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from pvsbench import harness
    sys.exit(harness.main())
