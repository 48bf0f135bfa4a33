"""The control of a cell's comparison, on the card.  For each seed, a run of
the cell (the window at its own load, untraced), then the reference over
the sampled requests; each reading is judged against the cell's limits by
the same code that decides a run's ``correct``.

- ``--seeds``: the reference twice, in float32 and as the float8 control.
  Prints the served tokens' readings (a sound run: ``correct`` true), the
  control's first choices' and those of a planted fault, a served token
  altered (each: ``correct`` false).
- ``--sound-seeds``: the served tokens' readings alone.
- ``--fault stale_kv``: the runs with the program broken underneath, every
  decode step leaving its K/V state as it was (``correct`` false).
- ``--dump DIR``: each seed's gaps, token by token, in ``DIR/<cell>.<seed>.npz``.

All seeds run in one process, one JSON line a seed.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def verdicts(gaps, bad: int, limits: dict) -> dict:
    """Each side's numbers judged against the cell's limits."""
    from harness import check

    out = {}
    for side, g in gaps.items():
        if g is None:
            continue
        rows = check.judge(check.readings(g, bad, limits), limits)
        out[side] = {"correct": check.correct(rows), **check.summary(g),
                     "checks": {r["name"]: r["value"] for r in rows}}
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--sound-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=("stale_kv",))
    ap.add_argument("--dump")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import faults
    from harness.runner import execute
    from harness.spec import load_cell

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    planted = faults.stale_kv() if args.fault == "stale_kv" else contextlib.nullcontext()
    t_start = T_START
    runs = [(s, True) for s in args.seeds] + [(s, False) for s in args.sound_seeds]
    with planted:
        for seed, control in runs:
            line, _, gaps, _ = execute(cell, seed, args.seconds, False, device, t_start,
                                       control=control)
            bad = line["checks"]["bad_answers"]["value"]
            out = {"workload": args.workload, "seed": seed, "fault": args.fault,
                   "limits": {k: v["limit"] for k, v in cell.limits.items()},
                   "correct": line["correct"], "bad_answers": bad}
            if gaps is not None:
                out.update(verdicts(gaps, bad, cell.limits))
                if args.dump:
                    Path(args.dump).mkdir(parents=True, exist_ok=True)
                    np.savez_compressed(
                        Path(args.dump) / f"{args.workload}.{seed}.npz",
                        **{k: g.cpu().numpy().astype(np.float32)
                           for k, g in gaps.items() if g is not None})
            print(json.dumps(out), flush=True)
            torch.cuda.empty_cache()
            t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
