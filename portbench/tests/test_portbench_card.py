"""On the card (marker ``card``; each test skips where there is no CUDA
card): a short run of each cell comes out correct with its metrics, and
the TF32 control and the planted faults fail the comparison at the cell's
own size."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import cells, compare

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(cell, trace):
    _need_card()
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
         str(2 ** 31 + 101), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == set(
        cells.metric_names(cells.benchmark(), bool(trace)))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    _need_card()
    from portbench import calibrate

    rows = calibrate.calibrate(cell, [2 ** 31 + 202], seconds=3.0,
                               out=open("/dev/null", "w"))
    by = {r["reading"]: r for r in rows}
    limits = cells.cell(cell)["limits"]
    assert compare.checks(by["program"], limits)[1]
    for fault in ("control", "half_batch", "lr_epoch0", "noise_epoch0"):
        assert not compare.checks(by[fault], limits)[1], fault
