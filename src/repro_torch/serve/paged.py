"""Paged KV-cache block pool: fixed-size token blocks + per-request tables
(own copy of the reference's ``repro.serve.paged``, allocation subset).

Logical token row ``i`` of a request lives at row ``i % block_size`` of
``table[i // block_size]``.  Block 0 is reserved as the scratch block: free
slots and unused table entries point at it.  Exhaustion raises
:class:`PoolExhausted`; the reference's preemption policy, copy-on-fork and
prefix sharing wait for their slices.
"""

from __future__ import annotations

from typing import Dict, List

SCRATCH_BLOCK = 0


def bucket_blocks(n: int, cap: int) -> int:
    """Round a block count up to the next power of two, clamped to ``cap``
    (the reference bounds its admission-write variants this way)."""
    if n <= 0:
        return min(1, cap)
    if n >= cap:
        return cap
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class PoolExhausted(RuntimeError):
    """The free list cannot satisfy an allocation."""


class BlockPool:
    """Fixed-size block allocator with per-request tables."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is the reserved "
                             f"scratch block), got {num_blocks}")
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))  # LIFO
        self._tables: Dict[int, List[int]] = {}

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.usable_blocks - len(self._free)

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def blocks_for_tokens(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def table(self, uid: int) -> List[int]:
        return list(self._tables[uid])

    def owners(self) -> List[int]:
        return sorted(self._tables)

    def allocate(self, uid: int, n: int) -> List[int]:
        """Create a table of ``n`` fresh blocks for ``uid``."""
        if uid in self._tables:
            raise ValueError(f"uid {uid} already owns a block table")
        if n > len(self._free):
            raise PoolExhausted(
                f"request {uid} needs {n} KV blocks but only {len(self._free)} of "
                f"{self.usable_blocks} are free (preemption is not ported yet: "
                "raise kv_pool_blocks)"
            )
        blocks = [self._free.pop() for _ in range(n)]
        self._tables[uid] = blocks
        return list(blocks)

    def append(self, uid: int) -> int:
        """Grow ``uid``'s table by one fresh block."""
        if uid not in self._tables:
            raise ValueError(f"uid {uid} owns no block table")
        if not self._free:
            raise PoolExhausted(
                f"request {uid} needs one more KV block but all {self.usable_blocks} "
                "are in use (preemption is not ported yet: raise kv_pool_blocks)"
            )
        b = self._free.pop()
        self._tables[uid].append(b)
        return b

    def release(self, uid: int) -> List[int]:
        """Drop ``uid``'s table; its blocks return to the free list."""
        blocks = self._tables.pop(uid)
        self._free.extend(blocks)
        return blocks
