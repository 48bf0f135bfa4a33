"""The port's dry-run on fake tensors over a fake process group, and its
accounting.

* two cells end to end, each as ``python -m repro_torch.launch.dryrun ...
  --device cpu`` in a subprocess with its own time limit: Mamba2's decode
  (the reference's own regression cell) and granite's decode over the
  "kv_seq"-sharded cache, whose record counts no all-gather of a cache
  leaf;
* the collective counter on known redistributes under a fake group of 4
  ranks: operand bytes equal to the arithmetic, counts exact;
* the FLOPs of granite's smoke train step counted on fake tensors equal to
  ``FlopCounterMode`` on the real step (exact integers);
* a kernel wrapper refuses a fake CUDA tensor (no data to launch on);
* ``report.py`` on the port's records, and on a record in the reference's
  format; the reference's ``report`` reads the port's record too.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELL_TIMEOUT = 300


def _env():
    env = dict(os.environ)
    env.update({"PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"})
    return env


def _dryrun(arch, shape, out):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--mesh", "single", "--device", "cpu", "--out", str(out), "--no-probes"],
        capture_output=True, text=True, env=_env(), timeout=CELL_TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    with open(os.path.join(out, f"{arch}_{shape}_single.json")) as f:
        rec = json.load(f)
    assert {k: rec[k] for k in summary} == summary
    return rec


def _check_record(rec):
    assert rec["ok"] and rec["chips"] == 256 and rec["step"] == "decode"
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert 0 < rec["peak_bytes_per_dev"] < 80e9  # fits the card's HBM
    assert rec["probes"] == "full_depth"
    assert rec["peak_bytes_per_dev"] == rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
    assert rec["hlo_flops_global"] == rec["flops_per_dev"] * 256


def test_mamba2_decode_cell_end_to_end(tmp_path):
    rec = _dryrun("mamba2_130m", "decode_32k", tmp_path)
    _check_record(rec)
    assert rec["cache_all_gathers"] == 0


def test_granite_decode_cell_keeps_the_cache_sharded(tmp_path):
    rec = _dryrun("granite_8b", "decode_32k", tmp_path)
    _check_record(rec)
    # the decode ran over the row-sharded cache: no rank gathered a cache leaf,
    # and the split softmax's reductions are all-reduces
    assert rec["cache_all_gathers"] == 0
    assert rec["collectives"]["count"]["all-reduce"] > 0
    # what gathering the rows would have cost: K and V of 36 layers, each
    # rank's [128 / 16, 32768 / 16, 8, 128] bf16 shard
    assert rec["kv_rows_gather"] == {"calls": 2 * 36, "bytes": 2 * 36 * 8 * 2048 * 8 * 128 * 2}
    assert rec["kv_rows_gather"]["bytes"] > 10 * rec["coll_bytes_per_dev"]


def test_collective_counter_on_known_redistributes():
    code = textwrap.dedent("""
        import json
        import torch
        import torch.distributed as dist
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed import _functional_collectives as funcol
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.roofline import CostCounter
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        out = {}
        with FakeTensorMode():
            local = torch.zeros(16, 32)  # a [64, 32] float32 tensor's shard
            x = DTensor.from_local(local, mesh, (Shard(0),), run_check=False)
            p = DTensor.from_local(torch.zeros(64, 32), mesh, (Partial(),), run_check=False)
            for name, fn in (("gather", lambda: x.redistribute(mesh, (Replicate(),))),
                             ("reduce", lambda: p.redistribute(mesh, (Replicate(),))),
                             ("scatter", lambda: p.redistribute(mesh, (Shard(0),))),
                             ("max", lambda: funcol.wait_tensor(
                                 funcol.all_reduce(local, "max", (mesh, 0))))):
                with CostCounter() as cc:
                    fn()
                out[name] = cc.collectives()
        print(json.dumps(out))
        dist.destroy_process_group()
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=_env(), timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    shard, whole = 16 * 32 * 4, 64 * 32 * 4
    assert got["gather"] == {"total": shard, "by_op": {"all-gather": shard},
                             "count": {"all-gather": 1}}
    assert got["reduce"] == {"total": whole, "by_op": {"all-reduce": whole},
                             "count": {"all-reduce": 1}}
    assert got["scatter"] == {"total": whole, "by_op": {"reduce-scatter": whole},
                              "count": {"reduce-scatter": 1}}
    assert got["max"] == {"total": shard, "by_op": {"all-reduce": shard},
                          "count": {"all-reduce": 1}}


def test_fake_step_flops_equal_the_real_step():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.roofline import CostCounter
    from repro_torch.models.param import tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state
    from repro_torch.train.step import TrainConfig, make_train_step

    cfg = get_smoke_config("granite_8b")
    model = build_model(cfg)
    step = make_train_step(model, TrainConfig())
    state = init_state(model.param_specs(), 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, batch=4, seq_len=32,
                                                           step=0).items()}
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    real = fc.get_total_flops()
    mode = FakeTensorMode(allow_non_fake_inputs=True)  # the cached STAR tables are real
    fstate, fbatch = tree_map(mode.from_tensor, state), tree_map(mode.from_tensor, batch)
    with mode, CostCounter() as cc:
        step(fstate, fbatch)
    assert real > 0
    assert cc.flops == real
    assert cc.bytes > 0 and cc.peak > 0


def _reference_format_record():
    return {
        "arch": "granite_8b", "shape": "train_4k", "mesh": "single", "step": "train",
        "chips": 256, "ok": True, "tag": "", "n_params": 8_000_000_000, "compile_s": 412.5,
        "microbatches": 1, "argument_size_in_bytes": 1_000_000_000,
        "output_size_in_bytes": 1_000_000_000, "temp_size_in_bytes": 5_000_000_000,
        "peak_bytes_per_dev": 6_000_000_000, "scanned_flops_per_dev": 1e12,
        "probe_compile_s": 12.0, "flops_per_dev": 5e14, "bytes_per_dev": 2e12,
        "coll_bytes_per_dev": 1e11,
        "collectives": {"by_op": {"all-gather": 6e10, "reduce-scatter": 4e10},
                        "count_probe_d2": {"all-gather": 10}},
        "model_flops_global": 1.2e17, "hlo_flops_global": 1.28e17, "useful_flops_ratio": 0.94,
        "t_compute_s": 2.538, "t_memory_s": 2.442, "t_collective_s": 2.0, "dominant": "compute",
        "roofline_fraction": 1.0, "wall_s": 500.0,
    }


def test_report_reads_both_packages_records(tmp_path):
    from repro_torch.launch import report

    rec = _dryrun("mamba2_130m", "decode_32k", tmp_path)
    with open(tmp_path / "granite_8b_train_4k_single.json", "w") as f:
        json.dump(_reference_format_record(), f)
    recs = report.load(str(tmp_path))
    assert len(recs) == 2
    table = report.roofline_table(recs, "single")
    assert "fits 80 GB" in table
    lines = [ln for ln in table.splitlines() if ln.startswith("| granite_8b")
             or ln.startswith("| mamba2_130m")]
    assert len(lines) == 2
    assert "| mamba2_130m | decode_32k | decode |" in table
    assert "yes" in lines[0] and "yes" in lines[1]  # both under 80 GB
    assert "under-read measured" in table
    assert "single-pod cells traced: 2 / 33" in report.summary(recs)
    assert "| mamba2_130m | decode_32k | 256 |" in report.dryrun_table(
        [dict(rec, mesh="multi")], "multi")
    # mamba2's cache has no kv_seq rows: nothing removed, so no row
    assert "| mamba2_130m |" not in report.decode_table(recs, "single")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.report", str(tmp_path)],
                       capture_output=True, text=True, env=_env(), timeout=60)
    assert r.returncode == 0 and "## Roofline (single-pod, 256 cards)" in r.stdout
    jax_report = pytest.importorskip("repro.launch.report")
    assert "| mamba2_130m | decode_32k | decode |" in jax_report.roofline_table(recs, "single")


@pytest.mark.parametrize("peak, label", [
    (10e9, "yes"),
    (56.0e9, "yes"),  # 56.0 / 0.7054 = 79.4 GB at the measured under-read
    (57.0e9, "unresolved"),  # fits as counted, 80.8 GB at the measured under-read
    (79.9e9, "unresolved"),
    (80.1e9, "NO"),
])
def test_fits_column_reads_the_peak_with_the_measured_under_read(peak, label):
    from repro_torch.launch import report

    assert report.fits(peak) == label
    rec = dict(_reference_format_record(), peak_bytes_per_dev=peak)
    row = report.roofline_table([rec], "single").splitlines()[2]
    assert f"| {label} |" in row


def test_kernels_refuse_fake_tensors():
    """A fake CUDA tensor holds no data: a wrapper refuses it rather than
    launch a kernel on it (the dry-run traces plain routes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _cuda
    from repro_torch.kernels.ssd_scan import ssd_scan

    with FakeTensorMode():
        x = torch.empty(2, 3, device="cuda")
        with pytest.raises(ValueError, match="fake tensor"):
            _cuda.on_card(x)
        with pytest.raises(ValueError, match="fake tensor"):
            ssd_scan(torch.empty(1, 8, 2, 4, device="cuda"), torch.empty(1, 8, 2, device="cuda"),
                     torch.empty(1, 8, 4, device="cuda"), torch.empty(1, 8, 4, device="cuda"))
        assert not _cuda.on_card(torch.empty(2, 3))  # a fake CPU tensor: the plain version


def test_cross_entropy_gradient_stays_on_the_shards():
    """Under a mesh the cross entropy's label gather runs on each rank's
    shard: its backward fills only the local logits' gradient, where
    DTensor's own gather backward allocated the global logits' size on every
    rank (found by the dry-run's peak)."""
    code = textwrap.dedent("""
        import json
        import torch
        import torch.distributed as dist
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.launch.dryrun import fake_mesh, _fake_placed
        from repro_torch.distributed.sharding import DEFAULT_RULES, Sharding, use_mesh_rules
        from repro_torch.launch.roofline import CostCounter
        from repro_torch.models.layers import cross_entropy

        class Largest(CostCounter):
            biggest = 0

            def _track(self, t):
                Largest.biggest = max(Largest.biggest, t.numel())
                super()._track(t)

        mesh = fake_mesh((2, 2), ("data", "model"), "cpu")
        with FakeTensorMode(allow_non_fake_inputs=True), use_mesh_rules(mesh, DEFAULT_RULES):
            sh = Sharding(mesh, None, (Shard(0), Replicate()))
            logits = _fake_placed(torch.empty(8, 16, 64, device="meta"), sh, "cpu")
            labels = _fake_placed(torch.empty(8, 16, dtype=torch.int64, device="meta"), sh, "cpu")
            logits.requires_grad_(True)
            with Largest():
                cross_entropy(logits, labels).backward()
        print(json.dumps({"biggest": Largest.biggest}))
        dist.destroy_process_group()
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=_env(), timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["biggest"] <= 4 * 16 * 64  # one rank's batch rows, never the global 8
