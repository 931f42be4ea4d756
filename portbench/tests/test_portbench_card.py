"""On the card: one short run of each cell prints the contract's result
line, correct, on the device it names. Skips without a card (decided in
the test, never at import). Run on the card with
    python -m pytest portbench/tests -m cuda"""

import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["northstar.static", "rtshadows.static"])
@pytest.mark.parametrize("trace", [0, 1])
def test_run_prints_a_correct_result(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert line["correct"] and line["failed"] == 0, line["check"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert "breakdown" in line
    else:
        assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95",
                                        "peak_mem_gib", "setup_s"}


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "rtshadows.static",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
