"""The closed-loop traffic generator.  A traffic file gives the clients, the
ranges of prompt and output lengths and how the engine is set; this module
turns it and a seed into requests.

Every seed serves the same multiset of sizes in another order: the lengths
are the ``pool`` quantiles of a log-uniform law over each range, and the
seed shuffles them, so two seeds do the same work and differ in its order.
Client ``c``'s first request is a residual one: its output length is a
share of its drawn length, the shares being ``(i + 0.5) / clients``
shuffled, so the run starts near the steady state of a loop that has been
running.  Prompt tokens are uniform over the vocabulary, each request's
from its own stream of the seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np


def log_uniform_quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` integer lengths in ``[lo, hi]``: the quantiles ``(i + 0.5) / n``
    of a log-uniform law."""
    u = (np.arange(n) + 0.5) / n
    vals = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


@dataclasses.dataclass
class Request:
    index: int  # the request's place in the run's sequence
    client: int
    prompt: np.ndarray  # int32 token ids
    max_new_tokens: int


class ClosedLoop:
    """Requests of a closed loop of ``clients`` clients: the first wave, then
    one new request each time a client's request finishes."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        if traffic["loop"] != "closed":
            raise ValueError(f"the generator drives closed loops, not {traffic['loop']!r}")
        self.clients = int(traffic["clients"])
        self.vocab = vocab
        self.seed = int(seed)
        n = int(traffic["pool"])
        rng = np.random.default_rng([self.seed, 0])
        self.prompt_lens = rng.permutation(log_uniform_quantiles(*traffic["prompt_len"], n))
        self.output_lens = rng.permutation(log_uniform_quantiles(*traffic["output_len"], n))
        shares = (np.arange(self.clients) + 0.5) / self.clients
        self.residual = rng.permutation(shares)
        self.issued = 0

    def _make(self, client: int, residual: bool) -> Request:
        i = self.issued
        self.issued += 1
        n = len(self.prompt_lens)
        plen = int(self.prompt_lens[i % n])
        out = int(self.output_lens[i % n])
        if residual:
            out = max(1, math.ceil(out * float(self.residual[client])))
        tokens = np.random.default_rng([self.seed, 1, i]).integers(
            0, self.vocab, plen, dtype=np.int64).astype(np.int32)
        return Request(i, client, tokens, out)

    def first_wave(self) -> List[Request]:
        return [self._make(c, residual=True) for c in range(self.clients)]

    def next_for(self, client: int) -> Request:
        return self._make(client, residual=False)
