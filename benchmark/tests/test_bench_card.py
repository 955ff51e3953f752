"""On the card: one short run of a cell through the command, whose last line
is a correct result of the card's platform (skips without a card)."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_one_eval_run_on_the_card(card):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "joint-eval",
                           "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["kind"] == card
