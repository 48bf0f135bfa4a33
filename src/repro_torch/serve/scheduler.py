"""Slot scheduler for continuous batching (own copy of the reference's
``repro.serve.scheduler``).

A fixed set of slots; each walks FREE -> [PREFILLING ->] ACTIVE -> FREE
(PREFILLING only under chunked prefill: bound and holding blocks, not yet
decoding).  ``submit`` appends to a FIFO pending queue (never blocks);
``admit`` binds pending requests to free slots; a request finishes on its
budget or on its ``eos_id``; ``retire`` frees a slot for immediate reuse;
``preempt`` evicts an unfinished request, keeps what it generated
(``Request.generated_prefix``) and requeues it at the *front*, so it keeps
its FIFO priority.  Pure host-side bookkeeping.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    # ``eos_id`` (optional) stops the request early; ``arrival_time`` is
    # recorded for traces and benchmarks, never read by admission (the
    # scheduler is clockless and admits in submission order)
    eos_id: Optional[int] = None
    arrival_time: float = 0.0
    # tokens generated before a preemption: re-admission re-prefills
    # prompt + generated_prefix and resumes; the budget counts them
    generated_prefix: List[int] = dataclasses.field(default_factory=list)
    submit_time: Optional[float] = None
    enqueued_at: Optional[float] = None
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D array, got {self.prompt.shape}")
        if self.max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be positive")


@dataclasses.dataclass
class Slot:
    index: int
    request: Optional[Request] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    # True while chunked prefill streams the prompt into the slot's blocks
    prefilling: bool = False

    @property
    def free(self) -> bool:
        return self.request is None

    def bind(self, request: Request) -> None:
        if not self.free:
            raise RuntimeError(f"slot {self.index} is busy")
        self.request = request
        self.generated = []
        self.prefilling = False

    def release(self) -> Request:
        req, self.request = self.request, None
        self.prefilling = False
        return req


class SlotScheduler:
    """Admission + retirement over a fixed slot pool."""

    def __init__(self, num_slots: int):
        if num_slots <= 0:
            raise ValueError("num_slots must be positive")
        self.slots: List[Slot] = [Slot(i) for i in range(num_slots)]
        self.pending: Deque[Request] = deque()
        self.finished: Dict[int, List[int]] = {}
        self._next_uid = 0

    def submit(
        self,
        prompt: Sequence[int] | np.ndarray,
        max_new_tokens: int,
        *,
        eos_id: Optional[int] = None,
        arrival_time: float = 0.0,
    ) -> int:
        uid = self._next_uid
        self._next_uid += 1
        self.pending.append(
            Request(uid, np.asarray(prompt, np.int32), max_new_tokens,
                    eos_id=eos_id, arrival_time=arrival_time)
        )
        return uid

    def free_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.free]

    def admit(self) -> List[Slot]:
        """Bind pending requests to free slots (FIFO)."""
        admitted: List[Slot] = []
        for slot in self.slots:
            if not self.pending:
                break
            if slot.free:
                slot.bind(self.pending.popleft())
                admitted.append(slot)
        return admitted

    def record_token(self, slot: Slot, token: int) -> bool:
        """Append a token; True when the request just finished: EOS sampled
        (before the budget check) or its budget spent (tokens generated
        before a preemption count)."""
        req = slot.request
        slot.generated.append(int(token))
        if req.eos_id is not None and int(token) == req.eos_id:
            return True
        return len(req.generated_prefix) + len(slot.generated) >= req.max_new_tokens

    def retire(self, slot: Slot) -> Request:
        req = slot.request
        self.finished[req.uid] = list(req.generated_prefix) + list(slot.generated)
        return slot.release()

    def preempt(self, slot: Slot) -> Request:
        """Evict an unfinished request: fold its tokens into
        ``generated_prefix`` and requeue it at the front of the pending
        queue.  The engine picks the victim and releases its KV blocks."""
        req = slot.request
        req.generated_prefix = list(req.generated_prefix) + list(slot.generated)
        slot.release()
        self.pending.appendleft(req)
        return req

    @property
    def active_slots(self) -> List[Slot]:
        """Slots in the decode batch (bound and done prefilling)."""
        return [s for s in self.slots if not s.free and not s.prefilling]

    @property
    def prefilling_slots(self) -> List[Slot]:
        """Bound slots still streaming prompt chunks."""
        return [s for s in self.slots if not s.free and s.prefilling]

    @property
    def occupied_slots(self) -> List[Slot]:
        """Every bound slot, decoding or prefilling: the preemption
        candidates (both hold KV blocks)."""
        return [s for s in self.slots if not s.free]

    def done(self) -> bool:
        return not self.pending and all(s.free for s in self.slots)
