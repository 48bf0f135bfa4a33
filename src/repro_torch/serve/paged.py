"""Paged KV-cache block pool and shared-prefix trie (own copy of the
reference's ``repro.serve.paged``).

Logical token row ``i`` of a request lives at row ``i % block_size`` of
``table[i // block_size]``, so gathering a table reproduces the request's
dense cache row.

* **Block 0 is reserved** as the scratch block: free slots and unused
  table entries point at it, so the decode step can write unconditionally.
* **Free list** — allocate/append pop from it, release pushes back.
  Exhaustion raises :class:`PoolExhausted`; the engine answers it by
  evicting prefix-trie leaves and preempting the latest-admitted slot.
* **Refcounts and copy-on-write** — ``fork`` / ``adopt`` / ``pin`` share
  blocks; ``ensure_writable`` privatizes a shared block before a write and
  returns the ``(src, dst)`` copy the device cache must make.
* **Quantized pools** keep a host mirror of the device scale pages: a block
  owns a scale row exactly while it is allocated.
* **Prefix sharing** — :class:`PrefixCache` is a radix trie keyed on
  ``block_size``-token chunks of the token-id stream.  Each node pins one
  pool block; admission adopts the blocks of the longest cached prefix and
  skips their prefill.  Eviction is LRU over leaves whose block only the
  trie holds.

Pure host-side bookkeeping.  With a :class:`MetricsRegistry` the pool
publishes ``kv.blocks.*`` and the trie ``kv.prefix.*`` metrics.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.kvquant import KV_DTYPES
from repro_torch.obs.metrics import MetricsRegistry

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
    """Fixed-size block allocator with per-request tables and refcounts."""

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        *,
        kv_dtype: str = "fp32",
        metrics: Optional[MetricsRegistry] = None,
    ):
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is the reserved "
                             f"scratch block), got {num_blocks}")
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_dtype = kv_dtype
        # host mirror of the device scale pages: one per allocated block
        self._scale_pages: set = set()
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))  # LIFO
        self._refcount: Dict[int, int] = {}
        self._tables: Dict[int, List[int]] = {}
        self._m_alloc = self._m_freed = self._m_used = None
        if metrics is not None:
            self._m_alloc = metrics.counter(
                "kv.blocks.allocated", "blocks handed out (allocate/append/CoW)")
            self._m_freed = metrics.counter(
                "kv.blocks.freed", "blocks returned to the free list")
            self._m_used = metrics.gauge(
                "kv.blocks.used", "distinct allocated blocks right now")

    def _track(self, allocated: int = 0, freed: int = 0) -> None:
        if self._m_used is None:
            return
        if allocated:
            self._m_alloc.inc(allocated)
        if freed:
            self._m_freed.inc(freed)
        self._m_used.set(self.used_blocks)

    # -- capacity ------------------------------------------------------------

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def quantized(self) -> bool:
        return self.kv_dtype != "fp32"

    def has_scale_page(self, block: int) -> bool:
        """True while the block owns a live scale page (quantized pools
        only; always False at fp32)."""
        return block in self._scale_pages

    def _page_out(self, block: int) -> None:
        if self.quantized:
            self._scale_pages.add(block)

    def _free_block(self, block: int) -> None:
        del self._refcount[block]
        self._free.append(block)
        self._scale_pages.discard(block)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Distinct allocated blocks (shared blocks counted once)."""
        return self.usable_blocks - len(self._free)

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def blocks_for_tokens(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    # -- tables --------------------------------------------------------------

    def table(self, uid: int) -> List[int]:
        return list(self._tables[uid])

    def owners(self) -> List[int]:
        return sorted(self._tables)

    def _pop(self) -> int:
        b = self._free.pop()
        self._refcount[b] = 1
        self._page_out(b)
        return b

    def allocate(self, uid: int, n: int) -> List[int]:
        """Create a table of ``n`` fresh blocks for ``uid``."""
        if uid in self._tables:
            raise ValueError(f"uid {uid} already owns a block table")
        if n > len(self._free):
            raise PoolExhausted(f"request {uid} needs {n} blocks but only "
                                f"{len(self._free)} of {self.usable_blocks} are free")
        blocks = [self._pop() for _ in range(n)]
        self._tables[uid] = blocks
        self._track(allocated=n)
        return list(blocks)

    def append(self, uid: int) -> int:
        """Grow ``uid``'s table by one fresh block; returns its id."""
        if uid not in self._tables:
            raise ValueError(f"uid {uid} owns no block table")
        if not self._free:
            raise PoolExhausted(f"request {uid} needs one more block but the pool is "
                                f"exhausted ({self.usable_blocks} blocks, all in use)")
        b = self._pop()
        self._tables[uid].append(b)
        self._track(allocated=1)
        return b

    def release(self, uid: int) -> List[int]:
        """Drop ``uid``'s table; blocks return to the free list when their
        refcount reaches zero."""
        freed = []
        for b in self._tables.pop(uid):
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                self._free_block(b)
                freed.append(b)
        self._track(freed=len(freed))
        return freed

    # -- copy-on-write -------------------------------------------------------

    def fork(self, parent_uid: int, child_uid: int) -> List[int]:
        """Share the parent's blocks with ``child_uid`` (refcount++)."""
        if child_uid in self._tables:
            raise ValueError(f"uid {child_uid} already owns a block table")
        blocks = self._tables[parent_uid]
        for b in blocks:
            self._refcount[b] += 1
        self._tables[child_uid] = list(blocks)
        return list(blocks)

    def ensure_writable(
        self, uid: int, block_index: Optional[int] = None
    ) -> Optional[Tuple[int, int]]:
        """Privatize the table entry about to be written (default: the
        last).  Returns ``(src, dst)`` when the block was shared — the
        caller copies the device rows (and scale row) ``src -> dst`` before
        writing — or None when it was already exclusive."""
        table = self._tables[uid]
        idx = len(table) - 1 if block_index is None else block_index
        src = table[idx]
        if self._refcount[src] == 1:
            return None
        if not self._free:
            raise PoolExhausted(f"request {uid} needs a private copy of shared block "
                                f"{src} but the pool is exhausted")
        dst = self._pop()
        self._refcount[src] -= 1
        table[idx] = dst
        self._track(allocated=1)
        return src, dst

    def refcount(self, block: int) -> int:
        return self._refcount.get(block, 0)

    # -- prefix sharing ------------------------------------------------------

    def adopt(self, uid: int, blocks: List[int]) -> List[int]:
        """Create ``uid``'s table from existing blocks (refcount++)."""
        if uid in self._tables:
            raise ValueError(f"uid {uid} already owns a block table")
        for b in blocks:
            if self._refcount.get(b, 0) < 1:
                raise ValueError(f"cannot adopt unallocated block {b}")
        for b in blocks:
            self._refcount[b] += 1
        self._tables[uid] = list(blocks)
        return list(blocks)

    def pin(self, block: int) -> None:
        """Take a table-less reference on an allocated block."""
        if self._refcount.get(block, 0) < 1:
            raise ValueError(f"cannot pin unallocated block {block}")
        self._refcount[block] += 1

    def unpin(self, block: int) -> bool:
        """Drop a pin; True when the block went back to the free list."""
        if self._refcount.get(block, 0) < 1:
            raise ValueError(f"cannot unpin unallocated block {block}")
        self._refcount[block] -= 1
        if self._refcount[block] == 0:
            self._free_block(block)
            self._track(freed=1)
            return True
        return False


class _TrieNode:
    """One ``block_size``-token chunk of some cached prefix -> one block."""

    __slots__ = ("chunk", "block", "parent", "children", "touch")

    def __init__(self, chunk, block, parent):
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: Dict[tuple, "_TrieNode"] = {}
        self.touch = 0


class PrefixCache:
    """Radix trie over cached prompt prefixes, one pool block per node.

    ``lookup`` walks the longest cached prefix of a request (LRU-touching
    the path); ``insert`` grafts a finished prefill's full blocks in;
    ``evict_one`` unpins the least recently touched leaf whose block only
    the trie holds."""

    def __init__(self, pool: BlockPool, *, metrics: Optional[MetricsRegistry] = None):
        self.pool = pool
        self.block_size = pool.block_size
        self.root = _TrieNode(None, -1, None)
        self.hits = 0
        self.tokens_saved = 0
        self.evicted = 0
        self._clock = 0
        self._nodes = 0
        self._m_hits = self._m_saved = self._m_evicted = None
        if metrics is not None:
            self._m_hits = metrics.counter(
                "kv.prefix.hits", "admissions that matched a cached prefix")
            self._m_saved = metrics.counter(
                "kv.prefix.tokens_saved", "prompt tokens served from cached blocks")
            self._m_evicted = metrics.counter(
                "kv.prefix.evicted", "trie nodes evicted (blocks unpinned)")

    def __len__(self) -> int:
        return self._nodes

    def _chunk(self, tokens, i: int) -> tuple:
        bs = self.block_size
        return tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def _touch(self, node: _TrieNode) -> None:
        self._clock += 1
        node.touch = self._clock

    def lookup(self, tokens) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens`` -> (block ids, rows matched).
        At most ``(len(tokens) - 1) // block_size`` chunks match, so at least
        one token always goes through prefill."""
        max_chunks = max(0, (len(tokens) - 1) // self.block_size)
        node, blocks = self.root, []
        for i in range(max_chunks):
            child = node.children.get(self._chunk(tokens, i))
            if child is None:
                break
            self._touch(child)
            blocks.append(child.block)
            node = child
        rows = len(blocks) * self.block_size
        if blocks:
            self.hits += 1
            self.tokens_saved += rows
            if self._m_hits is not None:
                self._m_hits.inc()
                self._m_saved.inc(rows)
        return blocks, rows

    def insert(self, tokens, table: List[int]) -> int:
        """Index a prefilled request's full blocks; returns nodes added.
        Chunks already present keep their (content-identical) block."""
        n = min(len(tokens) // self.block_size, len(table))
        node, added = self.root, 0
        for i in range(n):
            chunk = self._chunk(tokens, i)
            child = node.children.get(chunk)
            if child is None:
                child = _TrieNode(chunk, table[i], node)
                node.children[chunk] = child
                self.pool.pin(table[i])
                self._nodes += 1
                added += 1
            self._touch(child)
            node = child
        return added

    def evict_one(self) -> bool:
        """Unpin the LRU evictable leaf; True when a block was reclaimed."""
        best = None
        stack = list(self.root.children.values())
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children.values())
            elif self.pool.refcount(nd.block) == 1:
                if best is None or nd.touch < best.touch:
                    best = nd
        if best is None:
            return False
        del best.parent.children[best.chunk]
        self.pool.unpin(best.block)
        self._nodes -= 1
        self.evicted += 1
        if self._m_evicted is not None:
            self._m_evicted.inc()
        return True

    def clear(self) -> int:
        """Drop every node and pin (post-order); returns nodes removed."""
        removed = 0
        stack = [(self.root, iter(list(self.root.children.values())))]
        while stack:
            node, it = stack[-1]
            child = next(it, None)
            if child is not None:
                stack.append((child, iter(list(child.children.values()))))
                continue
            stack.pop()
            if node is not self.root:
                self.pool.unpin(node.block)
                removed += 1
        self.root.children.clear()
        self._nodes = 0
        return removed
