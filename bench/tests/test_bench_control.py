"""The control fails the limits: on the card, a run of ``granite_moe.decode``
at its own size and load (a short window) comes out correct, while its
float8 control and a planted fault (a served token altered), judged by the
same code, come out not correct.  On the CPU, at toy widths, the float32
program draws exactly the reference's tokens (gap 0) and neither the float8
control nor the altered token does."""

import json
import subprocess
import sys
import time

import pytest
import torch

from _tiny import BENCH, ROOT, tiny_cell
from harness.runner import execute


def test_control_and_fault_depart_from_the_reference_at_toy_widths():
    means, altered = [], []
    for seed in (1, 2, 3):
        line, _, gaps, _ = execute(tiny_cell(), seed, 0.5, False, torch.device("cpu"),
                                   time.perf_counter(), control=True)
        assert line["checks"]["widest_gap"]["value"] == 0.0
        means.append(float(gaps["control"].mean()))
        altered.append(float(gaps["altered"].max()))
    assert min(means) > 0.0 and min(altered) > 1.0


@pytest.mark.cuda
def test_control_fails_the_cell_limit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's own size")
    out = subprocess.run([sys.executable, str(BENCH / "control.py"), "--workload",
                          "granite_moe.decode", "--seconds", "20", "--seeds", "17"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    reading = json.loads(out.stdout.strip().splitlines()[-1])
    assert reading["served"]["correct"], reading
    assert not reading["control"]["correct"], reading
    assert not reading["altered"]["correct"], reading
