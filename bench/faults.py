"""Faults planted in the program's timed path, for the checks that have to
see them: each is a context manager that patches the port while it is
open.  Neither the benchmark's runs nor its reference use this module."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def stale_kv():
    """Every decode step leaves the paged K/V pool as it was: the step's
    row is written, attended to, and then put back as it stood, so a token
    sees its own K/V and no later token does.  Pages in the compute dtype
    and no sliding window, as the cells serve."""
    import torch

    from repro_torch.models import layers

    paged = layers._paged_decode

    def stale(q, k, v, cfg, cache, paged_cache_t, window):
        ck, cv, tables = cache["k"], cache["v"], cache["tables"]
        bs = ck.shape[1]
        idx = cache["len"].long()
        col = torch.clamp(idx // bs, 0, tables.shape[1] - 1)
        blk = tables.gather(1, col[:, None])[:, 0].long()
        row = idx % bs
        old_k, old_v = ck[blk, row].clone(), cv[blk, row].clone()
        out = paged(q, k, v, cfg, cache, paged_cache_t, window)
        ck[blk, row] = old_k
        cv[blk, row] = old_v
        return out

    layers._paged_decode = stale
    try:
        yield
    finally:
        layers._paged_decode = paged


@contextlib.contextmanager
def altered_token(slot_index: int = 0, position: int = 3):
    """The token that slot ``slot_index`` records at ``position`` of its
    output is altered (``+ 1`` modulo the vocabulary) where it is
    produced."""
    from repro_torch.serve.engine import ContinuousBatchingEngine

    record = ContinuousBatchingEngine._record

    def altered(self, slot, tok, events):
        if slot.index == slot_index and len(slot.generated) == position:
            tok = (tok + 1) % self.cfg.vocab_size
        return record(self, slot, tok, events)

    ContinuousBatchingEngine._record = altered
    try:
        yield
    finally:
        ContinuousBatchingEngine._record = record
