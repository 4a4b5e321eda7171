#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are in BENCHMARK.json at the root of the
checkout; the last line of standard output is the run's result as JSON.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import env  # noqa: E402

STARTED = env.process_start()

if __name__ == "__main__":
    from portbench.main import main

    sys.exit(main(sys.argv[1:], STARTED))
