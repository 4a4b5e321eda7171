"""One short run of each cell on the card (skips without one):
python -m pytest --noconftest -m cuda benchmark/tests -q"""

import json
import subprocess
import sys

import portbench_small as small
import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mmf_m4c.train_xe", "mmf_m4c.eval_greedy"])
def test_a_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    done = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(small.SEED), "--seconds", "3", "--trace", "0"],
                          capture_output=True, text=True, cwd=small.ROOT, timeout=1500)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
