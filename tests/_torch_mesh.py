"""Helpers of the port's multi-rank tests: ranks of ``torch.distributed``
(gloo, on the CPU) and the JAX reference on fake XLA devices, each in
subprocesses with their own time limit, so a collective that one rank never
reaches fails the test instead of hanging it.

Ranks rendezvous through a ``FileStore`` under the test's ``tmp_path`` (no
TCP port: several test workers share the machine), run with one thread,
and print their results as one ``RESULT <json>`` line.
"""

import json
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

RANK_PREAMBLE = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
from repro_torch.launch.mesh import init_process_group, make_mesh
init_process_group("cpu", rank=RANK, world_size=WORLD,
                   store=dist.FileStore(os.environ["MESH_STORE"], WORLD), timeout_s=120)
OUT = os.environ["MESH_OUT"]

def result(obj):
    print("RESULT " + json.dumps(obj), flush=True)
"""


def _env(extra):
    env = dict(os.environ)
    env.update({"PYTHONPATH": SRC, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"})
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _result(stdout: str):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(lines[-1][len("RESULT "):]) if lines else None


def run_ranks(code: str, world: int, tmp_path, name: str, timeout: float = 200.0):
    """Run ``code`` (after :data:`RANK_PREAMBLE`) on ``world`` gloo ranks;
    returns each rank's ``RESULT`` object.  Fails with every rank's output
    tail if a rank fails or the time limit passes."""
    store = os.path.join(str(tmp_path), f"{name}.store")
    src = RANK_PREAMBLE + textwrap.dedent(code) + "\ndist.destroy_process_group()\n"
    procs = [subprocess.Popen(
        [sys.executable, "-c", src],
        env=_env({"RANK": str(r), "WORLD_SIZE": str(world), "MESH_STORE": store,
                  "MESH_OUT": str(tmp_path)}),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs, failed = [], False
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            failed = True
        outs.append((p.returncode, out, err))
        failed = failed or p.returncode != 0
    assert not failed, "\n".join(
        f"--- rank {r} rc={rc}\n{out[-2000:]}\n{err[-4000:]}" for r, (rc, out, err) in
        enumerate(outs))
    return [_result(out) for _, out, _ in outs]


def run_jax(code: str, devices: int, timeout: float = 200.0):
    """Run ``code`` under the JAX reference on ``devices`` fake CPU devices;
    returns its ``RESULT`` object."""
    src = "import json\n\ndef result(obj):\n    print('RESULT ' + json.dumps(obj), flush=True)\n"
    src += textwrap.dedent(code)
    env = _env({"XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"})
    r = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    return _result(r.stdout)
