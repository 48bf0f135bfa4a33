"""Render the dry-run tables from a directory of cell records (port of
``repro.launch.report``).  Reads the port's records and the reference's
alike: both carry the same keys.

    PYTHONPATH=src python -m repro_torch.launch.report build/dryrun

The port's records are accounting on fake tensors with the constants of an
NVIDIA H100 80GB HBM3 (700 W) card, not times taken on one.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List

HBM_PER_CHIP = 80e9  # NVIDIA H100 80GB HBM3

# The dry-run's peak against torch.cuda.max_memory_allocated of the same
# step: bert-base-star's 8 x 512 train step traced fake and run on an NVIDIA
# H100 80GB HBM3 at 700 W (chip_smoke.py phase 15d), 3888690208 against
# 5512841216 bytes, a count 29.5 % under the card's.  Measured on that one
# step only, so a peak that fits but would not at that gap is unresolved.
PEAK_FAKE_OVER_CARD = 3888690208 / 5512841216


def load(dirpath: str) -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def _fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def _fmt_b(x):
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6)):
        if x >= div:
            return f"{x/div:.2f}{unit}"
    return f"{x:.0f}B"


def fits(peak: float) -> str:
    """The "fits 80 GB" column: ``NO`` over the card's HBM, ``unresolved``
    where the peak fits but not once scaled by the under-read measured on
    the card (:data:`PEAK_FAKE_OVER_CARD`), else ``yes``."""
    if peak > HBM_PER_CHIP:
        return "NO"
    return "unresolved" if peak / PEAK_FAKE_OVER_CARD > HBM_PER_CHIP else "yes"


def roofline_table(recs: List[Dict], mesh: str = "single") -> str:
    rows = [r for r in recs if r["mesh"] == mesh and not r.get("tag")]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = [
        "| arch | shape | step | t_compute | t_memory | t_collective | dominant | "
        "roofline frac | peak HBM/dev | fits 80 GB | MODEL/COUNTED flops | coll breakdown |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        coll = r.get("collectives", {}).get("by_op", {})
        top = sorted(coll.items(), key=lambda kv: -kv[1])[:2]
        coll_s = ", ".join(f"{k.replace('collective-','c-')} {_fmt_b(v)}" for k, v in top) or "-"
        peak = r.get("peak_bytes_per_dev", 0)
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['step']} | "
            f"{_fmt_s(r['t_compute_s'])} | {_fmt_s(r['t_memory_s'])} | "
            f"{_fmt_s(r['t_collective_s'])} | **{r['dominant']}** | "
            f"{r['roofline_fraction']*100:.1f}% | {_fmt_b(peak)} | "
            f"{fits(peak)} | "
            f"{r['useful_flops_ratio']:.2f} | {coll_s} |"
        )
    out.append(
        f"\nfits 80 GB: `unresolved` where the peak fits but not at the "
        f"{(1 - PEAK_FAKE_OVER_CARD) * 100:.1f} % under-read measured against "
        f"`max_memory_allocated` on one step (bert-base-star 8 x 512 train, "
        f"NVIDIA H100 80GB HBM3, 700 W).")
    return "\n".join(out)


def dryrun_table(recs: List[Dict], mesh: str) -> str:
    rows = [r for r in recs if r["mesh"] == mesh and not r.get("tag")]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = [
        "| arch | shape | chips | trace | FLOPs/dev | bytes/dev | coll bytes/dev | peak HBM/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['chips']} | {r['compile_s']:.0f}s | "
            f"{r['flops_per_dev']:.3g} | {_fmt_b(r['bytes_per_dev'])} | "
            f"{_fmt_b(r['coll_bytes_per_dev'])} | {_fmt_b(r.get('peak_bytes_per_dev', 0))} |"
        )
    return "\n".join(out)


def decode_table(recs: List[Dict], mesh: str = "single") -> str:
    """The port's decode cells: the collectives a rank issued beside the
    all-gathers of the cache's rows that the split softmax removes (a cell
    with no such rows, and a record without ``kv_rows_gather``, the
    reference's among them, is left out)."""
    rows = [r for r in recs if r["mesh"] == mesh and not r.get("tag")
            and r.get("step") == "decode" and (r.get("kv_rows_gather") or {}).get("calls")]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = [
        "| arch | shape | coll bytes/dev | collectives issued | cache all-gathers | "
        "removed: calls | removed: bytes/dev |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        count = r.get("collectives", {}).get("count", {})
        issued = ", ".join(f"{k} {v}" for k, v in sorted(count.items())) or "-"
        gone = r["kv_rows_gather"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_b(r['coll_bytes_per_dev'])} | {issued} | "
            f"{r.get('cache_all_gathers', '-')} | {gone['calls']} | {_fmt_b(gone['bytes'])} |"
        )
    return "\n".join(out)


def summary(recs: List[Dict]) -> str:
    single = [r for r in recs if r["mesh"] == "single" and not r.get("tag")]
    multi = [r for r in recs if r["mesh"] == "multi" and not r.get("tag")]
    lines = [
        f"single-pod cells traced: {len(single)} / 33",
        f"multi-pod cells traced:  {len(multi)} / 33",
    ]
    by_dom: Dict[str, int] = {}
    for r in single:
        by_dom[r["dominant"]] = by_dom.get(r["dominant"], 0) + 1
    lines.append(f"dominant terms (single-pod): {by_dom}")
    worst = sorted(single, key=lambda r: r["roofline_fraction"])[:3]
    lines.append(
        "worst roofline fractions: "
        + ", ".join(f"{r['arch']}/{r['shape']} {r['roofline_fraction']*100:.1f}%" for r in worst)
    )
    most_coll = sorted(single, key=lambda r: -r["t_collective_s"])[:3]
    lines.append(
        "most collective-bound: "
        + ", ".join(f"{r['arch']}/{r['shape']} {_fmt_s(r['t_collective_s'])}" for r in most_coll)
    )
    return "\n".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else os.path.join("build", "dryrun")
    recs = load(d)
    print("## Summary\n")
    print(summary(recs))
    print("\n## Roofline (single-pod, 256 cards)\n")
    print(roofline_table(recs, "single"))
    print("\n## Decode over the kv_seq-sharded cache (single-pod)\n")
    print(decode_table(recs, "single"))
    print("\n## Dry-run (multi-pod, 512 cards)\n")
    print(dryrun_table(recs, "multi"))


if __name__ == "__main__":
    main()
