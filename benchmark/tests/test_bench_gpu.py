"""One short run of each cell on a CUDA card (marker ``gpu``)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["sr3.subjects"])
def test_a_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "4294967311", "--seconds", "1", "--trace", "0"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
