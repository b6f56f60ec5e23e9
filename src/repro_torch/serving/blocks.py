"""Paged KV-cache block pool (vLLM-style, per worker).

The allocator distinguishes **reservation** from **allocation**:

* ``allocate(n)``   — blocks that hold data *now* (prefill output, decode
  growth).  This is all pull-mode ever needs on the decode worker.
* ``reserve(n)``    — push-mode's pre-allocation (§4.3): blocks held for a
  request whose prefill hasn't finished.  They consume capacity without
  holding data — exactly the "held but idling" memory of Motivation #3.

All-or-nothing: a request either gets every block or none, which is the
paper's deadlock-avoidance argument — incremental on-demand allocation
deadlocks when concurrent requests each hold partial sets and the pool is
exhausted (§3 Motivation #3).

Contiguity: ``allocate`` hands out the longest contiguous runs available
(best-fit on run length).  Contiguous block IDs ⇒ adjacent byte ranges ⇒
coalescing opportunities in the transfer engine (§4.2: long prompts see
less fragmentation and coalesce more, Fig. 17).

Refcounts support prefix sharing (paper §7 future work — implemented here
because the decode worker can map several requests onto one pulled
prefix).

Copy of ``src/repro/serving/blocks.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["BlockPool", "OutOfBlocks"]


class OutOfBlocks(Exception):
    """Not enough free blocks; caller must queue, never spin-wait holding
    a partial allocation (deadlock — Motivation #3)."""


@dataclasses.dataclass
class PoolStats:
    capacity: int
    allocated: int = 0
    reserved: int = 0
    peak_in_use: int = 0

    @property
    def free(self) -> int:
        return self.capacity - self.allocated - self.reserved

    @property
    def in_use(self) -> int:
        return self.allocated + self.reserved


class BlockPool:
    def __init__(self, num_blocks: int, *, block_size: int = 32) -> None:
        if num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        self.block_size = block_size
        self._free: set[int] = set(range(num_blocks))
        self._refcount: dict[int, int] = {}
        self._reserved_only: set[int] = set()
        self.stats = PoolStats(capacity=num_blocks)

    # ------------------------------------------------------------ sizing
    @staticmethod
    def blocks_for_tokens(num_tokens: int, block_size: int) -> int:
        return -(-num_tokens // block_size)  # ceil div

    # ---------------------------------------------------------- allocate
    def _take(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfBlocks(f"need {n} blocks: pool {self.describe()}")
        # Find contiguous runs among free IDs; prefer the tightest run that
        # fits (best-fit) to keep long runs available for long prompts.
        runs: list[tuple[int, int]] = []  # (start, length)
        start = prev = None
        for b in sorted(self._free):
            if prev is None or b != prev + 1:
                if start is not None:
                    runs.append((start, prev - start + 1))
                start = b
            prev = b
        if start is not None:
            runs.append((start, prev - start + 1))
        fitting = [r for r in runs if r[1] >= n]
        if fitting:
            s, _ = min(fitting, key=lambda r: r[1])
            taken = list(range(s, s + n))
        else:  # stitch together the longest runs first
            taken = []
            for s, ln in sorted(runs, key=lambda r: -r[1]):
                take = min(ln, n - len(taken))
                taken.extend(range(s, s + take))
                if len(taken) == n:
                    break
        for b in taken:
            self._free.discard(b)
            self._refcount[b] = 1
        return taken

    def allocate(self, n: int) -> list[int]:
        blocks = self._take(n)
        self.stats.allocated += n
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.stats.in_use)
        return blocks

    def reserve(self, n: int) -> list[int]:
        """Push-mode pre-allocation: capacity held before data exists."""
        blocks = self._take(n)
        self._reserved_only.update(blocks)
        self.stats.reserved += n
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.stats.in_use)
        return blocks

    def commit(self, blocks: list[int]) -> None:
        """Reserved → allocated (push-mode data has landed)."""
        for b in blocks:
            if b in self._reserved_only:
                self._reserved_only.discard(b)
                self.stats.reserved -= 1
                self.stats.allocated += 1

    # -------------------------------------------------------------- free
    def share(self, blocks: list[int]) -> None:
        """Bump refcounts (prefix sharing)."""
        for b in blocks:
            if b not in self._refcount:
                raise KeyError(f"block {b} not allocated")
            self._refcount[b] += 1

    def free(self, blocks: list[int]) -> list[int]:
        """Release one reference per block; returns the blocks that were
        ACTUALLY freed (refcount reached zero) — shared blocks merely
        decrement and are not in the returned list.  Callers indexing
        block contents (e.g. the decode workers' content-hash dedup
        index) purge exactly the returned ids."""
        released: list[int] = []
        for b in blocks:
            rc = self._refcount.get(b)
            if rc is None:
                raise KeyError(f"double free of block {b}")
            if rc > 1:
                self._refcount[b] = rc - 1
                continue
            del self._refcount[b]
            if b in self._reserved_only:
                self._reserved_only.discard(b)
                self.stats.reserved -= 1
            else:
                self.stats.allocated -= 1
            self._free.add(b)
            released.append(b)
        return released

    # ------------------------------------------------------------- query
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_shared(self) -> int:
        """Blocks held by more than one reference (prefix grafts, the
        retention cache) — occupancy that frees only when every holder
        releases."""
        return sum(1 for rc in self._refcount.values() if rc > 1)

    def describe(self) -> str:
        """One-line occupancy summary (used/free/shared) — what every
        ``OutOfBlocks`` message embeds so preemption-threshold debugging
        reads the pool state straight off the exception."""
        s = self.stats
        return (f"{s.in_use}/{s.capacity} used "
                f"({len(self._free)} free, {self.num_shared} shared, "
                f"{s.reserved} reserved)")

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def check_invariants(self) -> None:
        """Used by property tests."""
        held = set(self._refcount)
        assert held.isdisjoint(self._free), "block both free and held"
        assert len(held) + len(self._free) == self.stats.capacity
        assert self.stats.allocated + self.stats.reserved == len(held)
        assert self._reserved_only <= held
        assert all(rc >= 1 for rc in self._refcount.values())
