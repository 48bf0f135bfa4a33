"""The port's examples (``examples/torch_*.py``) run as a user runs them,
with ``--device cpu`` (the kernels' plain versions), each in its own
process; their last lines are what each promises.  On the card
``chip_smoke.py`` runs ``torch_quickstart.py`` (phase 16)."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 300  # seconds an example may take here


def _run(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
                           *args], capture_output=True, text=True, env=env, cwd=str(ROOT),
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines, proc.stderr[-3000:]
    return lines


def test_torch_quickstart_ends_in_ok():
    lines = _run("torch_quickstart.py")
    assert lines[0] == "device: cpu (host)"
    assert lines[-1] == "OK"
    # the online form equals the two-pass one up to float32 rounding
    err = float(re.search(r"two-pass vs vector-pipeline: (\S+)", "\n".join(lines)).group(1))
    assert err < 1e-5


def test_torch_serve_star_serves_every_request():
    lines = _run("torch_serve_star.py", "--requests", "4", "--slots", "2")
    assert lines[0].startswith("granite_8b [dense] on cpu: 4 requests -> 2 slots")
    done = [x for x in lines if x.endswith("<done>")]
    assert len(done) == 4
    assert re.fullmatch(r"  req3: \[\d+(, \d+)*\]", lines[-1])
    assert re.search(r"all 4 requests served in \d+ decode ticks", "\n".join(lines))


def test_torch_train_lm_star_makes_progress(tmp_path):
    lines = _run("torch_train_lm_star.py", "--steps", "10", "--ckpt-dir", str(tmp_path))
    assert lines[0].startswith("model: star-lm-small  params: 5.0M  softmax: star_ste")
    m = re.fullmatch(r"loss (\S+) -> (\S+) over 10 steps \(checkpoints in (.+)\)", lines[-1])
    assert m and float(m.group(2)) < float(m.group(1)) and m.group(3) == str(tmp_path)
    assert any(tmp_path.iterdir())  # a checkpoint was written
