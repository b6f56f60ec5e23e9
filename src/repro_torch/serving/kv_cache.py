"""Paged KV cache backed by one byte slab on the worker's device — the
port of ``src/repro/serving/kv_cache.py``.

Each worker owns a single contiguous ``torch.uint8`` slab (on the card
when the worker runs there).  The memory order is ``[L, 2, B, bs, g, d]``
(per layer: all K blocks, then all V blocks), exactly as in the
reference, and each layer exports the same ``TensorDesc`` field for
field, so descriptor-computed reads address the same bytes.  The
transfer engine's kv_pull kernel moves pages of this slab directly.

``SlotCache`` (SSM state slots) keeps the reference's structure and
descriptors over a ``torch.uint8`` slab on its own device, registered
with one slot as the page, so a state pull lands through one ``kv_pull``
launch per tick.
"""
from __future__ import annotations

import torch

from repro_torch.core.descriptors import TensorDesc
from repro_torch.core.transfer_engine import MemoryRegion

__all__ = ["PagedKVCache", "SlotCache", "DEFAULT_DTYPE"]

DEFAULT_DTYPE = torch.bfloat16


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class PagedKVCache:
    """All-layer paged KV storage for one worker.

    Logical shape per layer: ``[B, KV, L, H, D]`` = ``[num_blocks, 2,
    block_size, kv_heads, head_dim]`` with the KV-major memory layout of
    paper Fig. 5 (stride(KV) > stride(B)): two disjoint spans per block,
    K-runs of adjacent blocks coalescable, dense K/V planes for attention.
    """

    def __init__(
        self,
        worker_id: str,
        *,
        num_layers: int,
        num_blocks: int,
        block_size: int = 32,
        kv_heads: int = 8,
        head_dim: int = 128,
        dtype: torch.dtype = DEFAULT_DTYPE,
        base_address: int = 0x7F06F40000,  # paper Fig. 5's example base
        device: str | torch.device = "cpu",
    ) -> None:
        self.worker_id = worker_id
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.itemsize = _itemsize(dtype)
        self.base_address = base_address
        self.device = torch.device(device)

        self.layer_shape = (num_blocks, 2, block_size, kv_heads, head_dim)
        self._layer_elems = num_blocks * 2 * block_size * kv_heads * head_dim
        self._slab = torch.zeros(
            self.slab_nbytes(num_layers=num_layers, num_blocks=num_blocks,
                             block_size=block_size, kv_heads=kv_heads,
                             head_dim=head_dim, dtype=dtype),
            dtype=torch.uint8, device=self.device)
        # Memory order [L, KV, B, bs, H, D]; logical [B, KV, ...] views are
        # permutations of it (strides carry the layout, per Fig. 5).
        self._mem = self._slab.view(dtype).view(
            num_layers, 2, num_blocks, block_size, kv_heads, head_dim)
        self._view = self._mem.permute(0, 2, 1, 3, 4, 5)  # [layer, B, KV, L, H, D]

    @classmethod
    def slab_nbytes(cls, *, num_layers: int, num_blocks: int, block_size: int = 32,
                    kv_heads: int = 8, head_dim: int = 128,
                    dtype: torch.dtype = DEFAULT_DTYPE) -> int:
        """Bytes a cache with these dims allocates (one K and one V span
        per block per layer)."""
        return int(num_layers * num_blocks * 2 * block_size * kv_heads
                   * head_dim * _itemsize(dtype))

    # ------------------------------------------------------- descriptors
    def desc(self, layer: int) -> TensorDesc:
        if not (0 <= layer < self.num_layers):
            raise IndexError(f"layer {layer} out of range")
        return TensorDesc(
            address=self.base_address + layer * self._layer_elems * self.itemsize,
            dims=("B", "KV", "L", "H", "D"),
            shape=self.layer_shape,
            stride=tuple(self._view[layer].stride()),  # element strides
            itemsize=self.itemsize,
            worker_id=self.worker_id,
            tensor_id=f"layer{layer}/kv",
        )

    def descriptors(self) -> list[TensorDesc]:
        return [self.desc(l) for l in range(self.num_layers)]

    def memory_region(self) -> MemoryRegion:
        return MemoryRegion(self.worker_id, self.base_address, self._slab,
                            page_nbytes=self.block_nbytes)

    # ------------------------------------------------------------ access
    def write_block(self, layer: int, block_id: int, k, v) -> None:
        """k, v: [block_size, kv_heads, head_dim] (short final blocks are
        zero-padded by the caller)."""
        self._view[layer, block_id, 0] = torch.as_tensor(k).to(self.device, self.dtype)
        self._view[layer, block_id, 1] = torch.as_tensor(v).to(self.device, self.dtype)

    def write_blocks(self, blocks: list[int], k: torch.Tensor, v: torch.Tensor) -> None:
        """All layers at once: k, v [L, len(blocks), bs, H, D]."""
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        self._mem[:, 0, idx] = k.to(self.device, self.dtype)
        self._mem[:, 1, idx] = v.to(self.device, self.dtype)

    def gather_blocks(self, blocks: list[int]) -> torch.Tensor:
        """[L, 2, len(blocks), bs, H, D] copy of the blocks' K and V."""
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        return self._mem[:, :, idx]

    def read_block(self, layer: int, block_id: int) -> tuple[torch.Tensor, torch.Tensor]:
        blk = self._view[layer, block_id]
        return blk[0].clone(), blk[1].clone()

    def layer_array(self, layer: int) -> torch.Tensor:
        """Zero-copy [B, KV, L, H, D] view for compute."""
        return self._view[layer]

    def kv_planes(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Zero-copy dense K and V planes, each [B, L, H, D]."""
        return self._mem[layer, 0], self._mem[layer, 1]

    @property
    def block_nbytes(self) -> int:
        """Bytes of one K *or* V span of a block (one read transaction)."""
        return self.block_size * self.kv_heads * self.head_dim * self.itemsize

    @property
    def block_total_nbytes(self) -> int:
        """Slab bytes one block occupies across all layers and both
        planes: the logical bytes a full pull moves for it (the basis
        ``TransferEngine._pulled_bytes`` counts, so pulled + reused sums
        to a request's whole KV footprint)."""
        return self.block_nbytes * 2 * self.num_layers

    @property
    def nbytes(self) -> int:
        return self._slab.numel()


class SlotCache:
    """Fixed-size per-request recurrent state (SSM/conv), contiguous per
    slot.  dims ("B","E"): slot id x flattened state elements — a single
    dense span per slot, so each transfer is exactly one transaction."""

    def __init__(
        self,
        worker_id: str,
        *,
        num_layers: int,
        num_slots: int,
        state_elems: int,
        dtype: torch.dtype = DEFAULT_DTYPE,
        base_address: int = 0x7F20000000,
        device: str | torch.device = "cpu",
    ) -> None:
        self.worker_id = worker_id
        self.num_layers = num_layers
        self.num_slots = num_slots
        self.state_elems = state_elems
        self.dtype = dtype
        self.itemsize = _itemsize(dtype)
        self.base_address = base_address
        self.device = torch.device(device)
        self._slab = torch.zeros(num_layers * num_slots * state_elems * self.itemsize,
                                 dtype=torch.uint8, device=self.device)
        self._view = self._slab.view(dtype).view(num_layers, num_slots, state_elems)

    def desc(self, layer: int) -> TensorDesc:
        per_layer = self.num_slots * self.state_elems
        return TensorDesc(
            address=self.base_address + layer * per_layer * self.itemsize,
            dims=("B", "E"),
            shape=(self.num_slots, self.state_elems),
            stride=(self.state_elems, 1),
            itemsize=self.itemsize,
            worker_id=self.worker_id,
            tensor_id=f"layer{layer}/state",
        )

    def descriptors(self) -> list[TensorDesc]:
        return [self.desc(l) for l in range(self.num_layers)]

    def memory_region(self) -> MemoryRegion:
        return MemoryRegion(self.worker_id, self.base_address, self._slab,
                            page_nbytes=self.state_elems * self.itemsize)

    def write_slot(self, layer: int, slot: int, state) -> None:
        self._view[layer, slot] = torch.as_tensor(state).reshape(-1).to(self.device,
                                                                         self.dtype)

    def read_slot(self, layer: int, slot: int) -> torch.Tensor:
        return self._view[layer, slot].clone()
