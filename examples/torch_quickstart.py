"""Quickstart on the PyTorch port — the KVDirect core in one file.

Builds two workers with real paged-KV address spaces on the device
(``PagedKVCache`` slabs), CONNECTs them (descriptor exchange), TRANSFERs
a request's blocks with coalesced one-sided reads (landed by the kv_pull
kernel on the GPU), COMPLETEs, and verifies the bytes.  The port of
``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py                 # on the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu    # plain paths
"""
import argparse

import numpy as np
import torch

from repro_torch.core.connection import (ChipInfo, ConnectionManager, DescriptorRegistry,
                                         WorkerInfo)
from repro_torch.core.pull_push import pull_kv
from repro_torch.core.transfer_engine import TransferEngine
from repro_torch.device import resolve_device
from repro_torch.serving.blocks import BlockPool
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.request import Request


def main(argv=None) -> str:
    """Run the quickstart; returns what it printed.  Raises if the decode
    worker's KV differs from the prefill worker's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain paths")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    lines = []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    # --- two workers, each with a registered KV slab -------------------
    pre = PagedKVCache("prefill0", num_layers=4, num_blocks=64, block_size=32,
                       kv_heads=8, head_dim=128, device=dev)
    dec = PagedKVCache("decode0", num_layers=4, num_blocks=64, block_size=32,
                       kv_heads=8, head_dim=128, base_address=0x7F80000000, device=dev)

    engine = TransferEngine(coalescing="sorted")   # beyond-paper coalescer
    engine.register_memory(pre.memory_region())
    engine.register_memory(dec.memory_region())
    engine.on_complete(lambda c: say(f"  COMPLETE({c.request_id}) → prefill frees blocks"))

    # --- CONNECT(): descriptor exchange (Fig. 5) ------------------------
    registry = DescriptorRegistry("prefill0")
    for desc in pre.descriptors():
        registry.register(desc)
    cm = ConnectionManager(WorkerInfo("decode0", "decode", "host-d0",
                                      (ChipInfo(0, "ici://d0/0"),)))
    conn = cm.connect(WorkerInfo("prefill0", "prefill", "host-p0",
                                 (ChipInfo(0, "ici://p0/0"),)), registry)
    d = conn.desc("layer0/kv")
    say(f"CONNECT: got {len(conn.descriptors)} descriptors; layer0 = "
        f"addr={d.address:#x} dims={d.dims} shape={d.shape} stride={d.stride}")

    # --- a 'prefilled' request: fill 8 blocks with known KV -------------
    pool_p, pool_d = BlockPool(64), BlockPool(64)
    req = Request("r1", prompt_len=8 * 32, max_new_tokens=16)
    req.prefill_blocks = pool_p.allocate(8)
    rng = np.random.default_rng(0)
    for layer in range(4):
        for b in req.prefill_blocks:
            pre.write_block(layer, b, rng.standard_normal((32, 8, 128)),
                            rng.standard_normal((32, 8, 128)))

    # --- TRANSFER + COMPLETE: pull-mode, one-sided ----------------------
    stats = pull_kv(req, conn=conn, engine=engine, decode_pool=pool_d,
                    decode_cache=dec)
    say(f"TRANSFER: {stats.txns_submitted} block-span transactions → "
        f"{stats.reads_posted} coalesced reads "
        f"({stats.coalesce_factor:.0f}× coalescing), "
        f"{stats.bytes_moved / 2**20:.1f} MiB moved, "
        f"modeled {stats.modeled_time_s * 1e6:.0f} µs on a 400 Gbps link")

    # --- verify ----------------------------------------------------------
    for layer in range(4):
        for pb, db in zip(req.prefill_blocks, req.decode_blocks):
            k_src, v_src = pre.read_block(layer, pb)
            k_dst, v_dst = dec.read_block(layer, db)
            if not (torch.equal(k_src, k_dst) and torch.equal(v_src, v_dst)):
                raise RuntimeError(f"layer {layer} block {pb} -> {db}: the decode "
                                   f"worker's KV differs from the prefill worker's")
    say(f"VERIFY: decode worker's KV ({dev.type}) is bit-identical. ✓")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
