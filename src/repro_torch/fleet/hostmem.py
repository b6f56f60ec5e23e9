"""Host-memory swap pool for memory-pressure preemption.

A decode worker near its KV-occupancy budget can ``swap_out`` a victim:
the victim's full KV pages are copied here (host DRAM standing in for
the GPU/TPU host side, exactly the paper's CPU-memory pool role) and its
slab blocks free immediately.  The entry is opaque to the pool — it
stores whatever the worker hands it (``serving.engine.SwappedKV``) plus
a byte count against the budget — so this module needs no model or
serving imports.

Insertion order is preserved: the governor resumes victims FIFO, so the
longest-swapped request gets the first shot at returning capacity.

Copy of ``src/repro/fleet/hostmem.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

__all__ = ["HostSwapPool"]


class HostSwapPool:
    def __init__(self, capacity_bytes: int | None = None) -> None:
        self.capacity_bytes = capacity_bytes
        self._entries: dict[str, object] = {}  # rid -> entry (FIFO order)
        self._nbytes: dict[str, int] = {}
        self.used_bytes = 0
        self.peak_bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, request_id: str) -> bool:
        return request_id in self._entries

    def ids(self) -> list[str]:
        """Swapped request ids, oldest first (resume order)."""
        return list(self._entries)

    def put(self, request_id: str, entry, nbytes: int) -> bool:
        """Park an entry; False (and no mutation) when the byte budget
        can't hold it — the caller falls back to park behavior."""
        if request_id in self._entries:
            raise KeyError(f"{request_id} already swapped")
        if self.capacity_bytes is not None and \
                self.used_bytes + nbytes > self.capacity_bytes:
            return False
        self._entries[request_id] = entry
        self._nbytes[request_id] = nbytes
        self.used_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)
        return True

    def get(self, request_id: str):
        return self._entries.get(request_id)

    def pop(self, request_id: str):
        """Remove and return an entry (None if absent)."""
        entry = self._entries.pop(request_id, None)
        if entry is not None:
            self.used_bytes -= self._nbytes.pop(request_id)
        return entry
