"""A cell at a size the CPU runs in seconds: the granite-8b file's layout at
toy widths, and the MoE's, under a small closed loop."""

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import Cell, Metric, load_json, reader, reference_module  # noqa: E402

TINY = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "d_ff": 128,
        "vocab_size": 300}
TINY_MOE = dict(TINY, d_ff=32, num_experts=8, top_k=2)


def tiny_config(moe: bool = False, compute_dtype: str = "float32") -> dict:
    name = "granite-moe-1b-a400m" if moe else "granite-8b"
    conf = copy.deepcopy(load_json(BENCH / "configs" / f"{name}.json"))
    conf["model"].update(TINY_MOE if moe else TINY)
    conf["model"]["compute_dtype"] = compute_dtype
    return conf


def tiny_traffic(clients: int = 3) -> dict:
    t = load_json(BENCH / "traffic" / "decode_c32.json")
    t.update(clients=clients, prompt_len=[8, 24], output_len=[4, 12], pool=64,
             warmup_steps=2, profile_steps=3, check_tokens=20, check_requests=2)
    t["engine"] = dict(t["engine"], num_slots=clients, max_len=48)
    return t


def tiny_cell(moe: bool = False, compute_dtype: str = "float32", limit: float = 0.25,
              clients: int = 3) -> Cell:
    """``limit`` holds both gaps: a float32 program draws the reference's
    tokens exactly."""
    e2e = ("output_tok_s", "itl_p95_ms", "ttft_p90_ms", "setup_s")
    conf = tiny_config(moe, compute_dtype)
    return Cell("tiny", 1, conf, reference_module(conf["reference"]), tiny_traffic(clients),
                {"mean_gap": {"limit": limit}, "widest_gap": {"limit": limit},
                 "bad_answers": {"limit": 0}},
                [Metric(n, "", reader(n)) for n in e2e], [])
