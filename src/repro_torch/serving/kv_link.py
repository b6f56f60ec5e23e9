"""Two workers' paged KV caches joined for a one-request pull, outside a
service: a prefill and a decode ``PagedKVCache`` on one device, a
connection and a transfer engine, composed as tests/test_pull_push.py
composes the reference's.  ``KVLink.pull`` parks a b = 1 decode state's
prompt pages in the prefill cache, pulls them with ``pull_kv`` (the
kv_pull kernel on the card) and rebuilds the state from the decode
cache, for checks that decode from pulled pages (the VLM image prompts,
which the workers do not serve, as in the reference).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.connection import (
    ChipInfo, ConnectionManager, DescriptorRegistry, WorkerInfo)
from repro_torch.core.pull_push import pull_kv
from repro_torch.core.transfer_engine import TransferEngine
from repro_torch.serving.blocks import BlockPool
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.request import Request

__all__ = ["KVLink"]


class KVLink:
    def __init__(self, cfg, num_blocks: int, *, dtype: torch.dtype, device,
                 block_size: int = 32):
        kw = dict(num_layers=cfg.num_layers, num_blocks=num_blocks, block_size=block_size,
                  kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, dtype=dtype,
                  device=device)
        self.pre = PagedKVCache("p0", base_address=0x10_0000_0000, **kw)
        self.dec = PagedKVCache("d0", base_address=0x20_0000_0000, **kw)
        self.pool = BlockPool(num_blocks, block_size=block_size)
        self.engine = TransferEngine()
        self.engine.register_memory(self.pre.memory_region())
        self.engine.register_memory(self.dec.memory_region())
        reg = DescriptorRegistry("p0")
        for d in self.pre.descriptors():
            reg.register(d)

        def info(wid, role):
            return WorkerInfo(wid, role, "10.0.0.1", (ChipInfo(0, f"ici://{wid}/0"),))

        self.conn = ConnectionManager(info("d0", "decode")).connect(info("p0", "prefill"), reg)

    def pull(self, request_id: str, state, blocks, max_new: int):
        """Park a b = 1 state's prompt pages in the prefill cache's
        ``blocks``, pull them, and return (the state rebuilt from the
        decode cache with the same page count, bytes moved)."""
        n_ctx = int(state.context_lens[0])
        n = len(blocks)
        req = Request(request_id, prompt_len=n_ctx, max_new_tokens=max_new)
        req.prefill_blocks = list(blocks)
        self.pre.write_blocks(req.prefill_blocks, state.k_pages[:, 0, :n],
                              state.v_pages[:, 0, :n])
        before = self.engine.stats.bytes_moved
        pull_kv(req, conn=self.conn, engine=self.engine, decode_pool=self.pool,
                decode_cache=self.dec)
        moved = self.engine.stats.bytes_moved - before
        idx = torch.as_tensor(req.decode_blocks, dtype=torch.long, device=state.k_pages.device)
        landed = dataclasses.replace(state, k_pages=torch.zeros_like(state.k_pages),
                                     v_pages=torch.zeros_like(state.v_pages))
        for layer in range(self.dec.num_layers):
            kplane, vplane = self.dec.kv_planes(layer)
            landed.k_pages[layer, 0, :n] = kplane[idx]
            landed.v_pages[layer, 0, :n] = vplane[idx]
        self.pool.free(req.decode_blocks)
        return landed, moved
