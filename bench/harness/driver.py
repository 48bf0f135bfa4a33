"""Drive the program: build the cell's engine (the port's
``ContinuousBatchingEngine``) on weights the benchmark draws, feed it the
closed loop and keep a client-side record of every request and step.

Every token is stamped with the host clock when the engine hands it to the
client (its ``on_token`` stream), which is after the token reached the host.
Clients whose request finished submit their next request between two
``step()`` calls, so which tokens a run serves depends only on the seed.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

from harness.traffic import ClosedLoop, Request

STEP_LABEL = "bench.engine_step"  # the profiler's name of one engine step


@dataclasses.dataclass
class RequestLog:
    uid: int
    client: int
    prompt: object  # the prompt's token ids (numpy int32)
    max_new_tokens: int
    submit_t: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    times: List[float] = dataclasses.field(default_factory=list)
    finish_t: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclasses.dataclass
class StepLog:
    t0: float
    t1: float = 0.0
    prefills: List[int] = dataclasses.field(default_factory=list)  # prompt lengths admitted
    tick_rows: List[int] = dataclasses.field(default_factory=list)  # KV rows each tick token read


def model_config(conf: dict):
    """The port's ``ModelConfig`` as the configuration file states it."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.ops.specs import AttentionSpec, SoftmaxSpec

    sm = conf["softmax"]
    softmax = SoftmaxSpec(impl=sm["impl"], kind=sm["kind"], mode=sm["mode"],
                          precision=FixedPointFormat(sm["int_bits"], sm["frac_bits"]))
    attention = AttentionSpec(impl=conf["attention"]["impl"], softmax=softmax,
                              block_k=conf["attention"]["block_k"],
                              block_kv=conf["attention"]["block_kv"])
    return ModelConfig(**conf["model"], attention=attention).validate()


def draw_weights(cfg, seed: int, device) -> dict:
    """The model's parameters in the port's layout, drawn on ``device`` from
    one seeded generator in a few large calls, in the type they are served
    in: the leaves the engine computes with in the compute dtype, the rest
    (norm scales, ones) in the parameter dtype.  A matrix ``[..., n_in,
    n_out]`` is N(0, 1 / n_in), the embedding table N(0, 0.02**2)."""
    import torch

    from repro_torch.models.param import casts_once, named_leaves, unflatten
    from repro_torch.models.registry import build_model

    specs = build_model(cfg).param_specs()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    compute = getattr(torch, cfg.compute_dtype)
    paths, leaves = [], []
    for path, spec in named_leaves(specs):
        parent = specs
        for key in path[:-1]:
            parent = parent[key]
        if spec.init == "ones":
            leaf = torch.ones(spec.shape, dtype=spec.dtype, device=device)
        elif spec.init == "zeros":
            leaf = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        else:
            dtype = compute if casts_once(path[-1], parent) else spec.dtype
            std = 0.02 if path[-1] == "table" else 1.0 / math.sqrt(spec.shape[-2])
            leaf = torch.randn(spec.shape, generator=gen, dtype=dtype, device=device)
            leaf.mul_(std)
        paths.append(path)
        leaves.append(leaf)
    return unflatten(paths, leaves)


class Loop:
    """The closed loop over one engine, with its client-side record."""

    def __init__(self, engine_factory: Callable, gen: ClosedLoop,
                 clock: Callable[[], float] = time.perf_counter):
        self.gen = gen
        self.clock = clock
        self.requests: Dict[int, RequestLog] = {}
        self.steps: List[StepLog] = []
        self.refused: List[float] = []  # submit times of requests the engine refused
        self._done_clients: List[int] = []
        self._step: Optional[StepLog] = None
        self.engine = engine_factory(self.on_token)

    def on_token(self, ev) -> None:
        t = self.clock()
        r = self.requests[ev.uid]
        r.tokens.append(int(ev.token))
        r.times.append(t)
        if self._step is not None:
            if ev.index == 0:
                self._step.prefills.append(r.prompt_len)
            else:  # the tick's query read the prompt and every earlier token
                self._step.tick_rows.append(r.prompt_len + ev.index)
        if ev.finished:
            r.finish_t = t
            self._done_clients.append(r.client)

    def submit(self, req: Request) -> None:
        t = self.clock()
        try:
            uid = self.engine.submit(req.prompt, req.max_new_tokens)
        except ValueError:
            self.refused.append(t)
            return
        self.requests[uid] = RequestLog(uid, req.client, req.prompt, req.max_new_tokens, t)

    def start(self) -> None:
        for req in self.gen.first_wave():
            self.submit(req)

    def step(self) -> StepLog:
        import torch

        rec = StepLog(self.clock())
        self._step = rec
        with torch.profiler.record_function(STEP_LABEL):
            self.engine.step()
        rec.t1 = self.clock()
        self._step = None
        self.steps.append(rec)
        done, self._done_clients = self._done_clients, []
        for client in done:
            self.submit(self.gen.next_for(client))
        return rec

    def run_until(self, t_end: float) -> float:
        """Steps until the clock reads ``t_end``; returns the last step's end."""
        while True:
            rec = self.step()
            if rec.t1 >= t_end:
                return rec.t1
