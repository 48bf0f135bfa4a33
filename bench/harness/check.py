"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed, a sample of the requests that finished in it,
drawn from the seed with the longest among them, is run through the
reference its configuration names (``bench/reference/<name>.py``) over its
prompt and served tokens.  The traffic samples at a temperature, so a
served token is judged as a draw:
the engine draws token ``argmax_j p_j / q_j`` with ``p`` the STAR softmax of
``logits / T`` and ``q ~ Exp(1)`` from the request's own generator
(``torch.Generator`` seeded ``engine_seed * 1_000_003 + uid``, one
``exponential_`` of the padded vocabulary per token).  The reference draws
the same ``q`` and scores each token ``s_j = log p_j - log q_j`` from its
own float32 logits; a served token's gap is ``max_j s_j - s_token``, 0 where
the reference would have drawn the same token.  Under greedy decoding (``q =
1`` and the exact softmax) it would be the logit gap over ``T``.  The
numbers of the sample compared with their limits are those the cell's
limits file names (:func:`readings`): the mean gap over its tokens and the
share of them whose gap passes a level, which the control has to fail, and
the widest gap, which a token altered where it is produced fails.

The control is the same reference with its products in float8 e4m3 and its
activations in bfloat16 (:data:`reference.common.FLOAT8`, one control for
every architecture), the precision below the configuration's bfloat16 where
the program computes: at every
position of the same sequences, the token it ranks first, scored by the
float32 reference.  Its readings are judged by :func:`judge` like a run's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from reference.common import FLOAT8
from reference.star import grid_index

SEED_STRIDE = 1_000_003  # the engine's per-request generator: seed * stride + uid


def finished_in(requests, t_open: float, t_close: float) -> list:
    return [r for r in requests.values()
            if r.finish_t is not None and t_open < r.finish_t <= t_close]


def sample(done: list, seed: int, min_tokens: int, min_requests: int) -> list:
    """The longest finished request (prompt and output), then others drawn
    from the seed until the sample holds ``min_tokens`` served tokens and
    ``min_requests`` requests."""
    if not done:
        return []
    done = sorted(done, key=lambda r: r.uid)
    longest = max(done, key=lambda r: r.prompt_len + len(r.tokens))
    rest = [r for r in done if r is not longest]
    picked, total = [longest], len(longest.tokens)
    for i in np.random.default_rng([int(seed), 2]).permutation(len(rest)):
        if total >= min_tokens and len(picked) >= min_requests:
            break
        picked.append(rest[i])
        total += len(rest[i].tokens)
    return picked


def bad_answers(done: list, vocab: int) -> int:
    """Finished requests whose output is not as asked: another length than
    ``max_new_tokens`` (the traffic sets no EOS), or a token outside the
    vocabulary."""
    return sum(1 for r in done
               if len(r.tokens) != r.max_new_tokens or any(t < 0 or t >= vocab for t in r.tokens))


def exponentials(engine_seed: int, uid: int, n: int, width: int, device):
    """The ``q`` the engine drew for request ``uid``'s first ``n`` tokens."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(engine_seed) * SEED_STRIDE + uid)
    return torch.stack([torch.empty(width, dtype=torch.float32, device=device)
                        .exponential_(1.0, generator=g) for _ in range(n)])


def scores(logits, q, temperature: float, fmt: Sequence[int]):
    """``log p - log q`` in float64, ``p`` the STAR softmax of ``logits / T``
    (its normaliser is left out: it cancels in every gap)."""
    import torch

    x = logits.float() / torch.tensor(temperature, dtype=torch.float32, device=logits.device)
    k = grid_index(x, fmt[0], fmt[1]).double()
    return -k / float(1 << fmt[1]) - torch.log(q.double().clamp(min=1e-300))


def _gaps(ref_s, picked):
    """Each picked token's gap below the reference's best score."""
    best = ref_s.max(dim=-1).values
    return best - ref_s.gather(-1, picked[:, None])[:, 0]


def summary(gaps) -> Dict[str, float]:
    """A few numbers of a sample's gaps, for the log."""
    return {"tokens": int(gaps.numel()), "mean": float(gaps.mean()),
            "widest": float(gaps.max()), "moved": float((gaps > 0).double().mean()),
            "over_0.25": float((gaps > 0.25).double().mean())}


def readings(gaps, bad: int, limits: Dict[str, dict]) -> Dict[str, Optional[float]]:
    """The numbers compared, named as the cell's limits name them:
    ``bad_answers``; of the gaps (None without a sample) ``mean_gap``,
    ``widest_gap``, and for a limit with ``over`` the share of tokens whose
    gap is past that level."""
    out: Dict[str, Optional[float]] = {}
    for name, lim in limits.items():
        if name == "bad_answers":
            out[name] = bad
        elif gaps is None:
            out[name] = None
        elif name == "mean_gap":
            out[name] = float(gaps.mean())
        elif name == "widest_gap":
            out[name] = float(gaps.max())
        elif "over" in lim:
            out[name] = float((gaps > lim["over"]).double().mean())
        else:
            raise ValueError(f"no reading named {name!r}")
    return out


def token_gaps(requests: list, weights: dict, conf: dict, arch, temperature: float,
               engine_seed: int, device, control: bool = False) -> Dict[str, object]:
    """The gaps of the served tokens of ``requests``, one float64 tensor
    over all their tokens, and with ``control`` those of the float8
    control's first choices and of a planted fault: each request's middle
    token altered (``+ 1`` modulo the vocabulary).  ``arch`` is the
    configuration's reference module; only its ``logits`` is called."""
    import torch

    model, sm = conf["model"], conf["softmax"]
    fmt = (sm["int_bits"], sm["frac_bits"])
    served_gaps, control_gaps, altered_gaps = [], [], []
    for r in requests:
        n = len(r.tokens)
        seq = np.concatenate([np.asarray(r.prompt, np.int64), np.asarray(r.tokens[:-1], np.int64)])
        tokens = torch.as_tensor(seq, device=device)
        rows = torch.arange(r.prompt_len - 1, r.prompt_len - 1 + n, device=device)
        served = torch.as_tensor(r.tokens, dtype=torch.int64, device=device)
        logits = arch.logits(weights, model, fmt, tokens, r.prompt_len, rows)
        q = exponentials(engine_seed, r.uid, n, logits.shape[-1], device)
        ref_s = scores(logits, q, temperature, fmt)
        del logits
        served_gaps.append(_gaps(ref_s, served))
        if control:
            mid = n // 2
            altered = served.clone()
            altered[mid] = (altered[mid] + 1) % model["vocab_size"]
            altered_gaps.append(_gaps(ref_s, altered))
            ctrl = arch.logits(weights, model, fmt, tokens, r.prompt_len, rows, prec=FLOAT8)
            pick = scores(ctrl, q, temperature, fmt).argmax(dim=-1)
            control_gaps.append(_gaps(ref_s, pick))
            del ctrl
        del ref_s, q
    return {"served": torch.cat(served_gaps),
            "control": torch.cat(control_gaps) if control else None,
            "altered": torch.cat(altered_gaps) if control else None}


def judge(values: Dict[str, Optional[float]], limits: Dict[str, dict]) -> List[dict]:
    """Each number beside its limit; a number passes at or under it."""
    return [{"name": name, "value": values[name], "limit": limits[name]["limit"],
             "ok": values[name] is not None and values[name] <= limits[name]["limit"]}
            for name in limits]


def correct(rows: List[dict]) -> bool:
    """A sample that was judged, every number within its limit."""
    return bool(rows) and all(r["ok"] for r in rows)
