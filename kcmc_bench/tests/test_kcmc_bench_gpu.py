"""One cell for 10 s on the card, through the command the driver runs
(`python -m kcmc_bench`): the result line's keys, `correct`, and no JAX
module in the process. Skips without a CUDA card.

    python3 -m pytest -m gpu kcmc_bench/tests/test_kcmc_bench_gpu.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_cell_runs_on_the_card(card):
    r = subprocess.run(
        [sys.executable, "-m", "kcmc_bench", "--workload", "affine2k.rec512",
         "--seed", "2147483659", "--seconds", "10", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert line["checks"]["rmse_px"]["value"] <= line["checks"]["rmse_px"]["limit"]
    assert r.stderr.strip().splitlines()[-1].startswith("check frame_gap")
