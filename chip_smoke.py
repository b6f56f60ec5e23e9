#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. Build: the GPU's name and power limit; every CUDA kernel of the main
   path compiled from ``src/repro_torch/csrc`` by nvcc (sm_90a).
2. Kernels against their plain PyTorch versions on the card, at Yi-9B
   shapes and at the CPU test grid, f32 (2e-4) and bf16 (2e-2); kv_pull
   exact with untouched pages intact; the int8 round trip within
   max|plane|/127.
3. Serve through the normal entry point: ``repro_torch.launch.serve`` at
   the full Yi-9B config (48 layers, d_model 4096, random weights), once
   plain and once with ``--quantize-transfer``.
4. Serve directly: a ``DisaggService`` with 2 prefill and 1 decode
   workers on ragged prompts (96, 130, 257 tokens).  One at a time, every
   request's tokens must equal a monolithic prefill + decode_step run on
   the same card; all three decoded together (every step at b = 3) must
   equal a monolithic b = 3 decode_step run over the stacked prefill
   states; then once with ``quantize_transfer=True`` (int8 wire bytes,
   nbytes/2+4 per read, landed by kv_pull_dequant).
   Every serving run is a path of its own: the launch counts are zeroed
   just before it and read just after, and the run fails unless each
   kernel it must use launched (flash_prefill once per layer and prompt,
   paged_attention once per layer and decode step).
5. Times at the main path's shapes: each kernel, its plain version, one
   PyTorch library call computing the same function, and the bound.

Then one JSON line of kernel records, the ``nvidia-smi`` name/power line,
and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core rate
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
YI = dict(h=32, g=4, d=128, bs=32)
PROMPTS = (96, 130, 257)
MAX_NEW = 8


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


# ------------------------------------------------------------ phase 1
def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    path, compile_log = build.build()
    build.library()
    log(f"built {path.name} in {time.perf_counter() - t0:.1f}s")
    for line in compile_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")


# ------------------------------------------------------------ phase 2
def close(out, ref, tol, what):
    import torch

    out32, ref32 = out.float(), ref.float()
    err = float((out32 - ref32).abs().max()) if out.numel() else 0.0
    if not torch.isfinite(out32).all():
        raise AssertionError(f"{what}: non-finite output")
    if not torch.allclose(out32, ref32, rtol=tol, atol=tol):
        raise AssertionError(f"{what}: max |err| {err} above tolerance {tol}")
    return err


def check_paged_attention(gen, dev):
    import torch

    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    def case(b, h, g, d, per, bs, dtype, tables=None, ctx=None):
        q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
        kp = torch.randn(b, per, bs, g, d, generator=gen, device=dev).to(dtype)
        vp = torch.randn(b, per, bs, g, d, generator=gen, device=dev).to(dtype)
        if tables is None:
            tables = torch.arange(per, dtype=torch.int32, device=dev)[None].repeat(b, 1)
        if ctx is None:
            ctx = torch.randint(1, per * bs, (b,), generator=gen, device=dev,
                                dtype=torch.int32)
        out = paged_attention(q, kp, vp, tables, ctx)
        torch.cuda.synchronize()
        return close(out, paged_attention_ref(q, kp, vp, tables, ctx),
                     TOL[str(dtype).split(".")[1]],
                     f"paged_attention b={b} h={h} g={g} d={d} {dtype}")

    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 4, 2, 64, 4, 32), (3, 8, 1, 128, 3, 32), (1, 8, 8, 64, 5, 16)):
            case(*shape, dtype)
    case(1, 4, 2, 32, 4, 16, torch.float32,
         tables=torch.tensor([[2, 0, 3, 1]], dtype=torch.int32, device=dev),
         ctx=torch.tensor([64], dtype=torch.int32, device=dev))
    case(2, 2, 1, 32, 2, 16, torch.float32,
         ctx=torch.ones(2, dtype=torch.int32, device=dev))
    yi_ctx = torch.tensor([p + MAX_NEW for p in PROMPTS], dtype=torch.int32, device=dev)
    case(3, YI["h"], YI["g"], YI["d"], 11, YI["bs"], torch.float32, ctx=yi_ctx)
    return case(3, YI["h"], YI["g"], YI["d"], 11, YI["bs"], torch.bfloat16, ctx=yi_ctx)


def check_flash_prefill(gen, dev):
    import torch

    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import dense_ref

    def case(b, s, h, g, d, dtype, **kw):
        q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, s, g, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, s, g, d, generator=gen, device=dev).to(dtype)
        out = flash_prefill(q, k, v, **kw)
        torch.cuda.synchronize()
        return close(out, dense_ref(q, k, v, **kw), TOL[str(dtype).split(".")[1]],
                     f"flash_prefill s={s} h={h} g={g} d={d} {dtype} {kw}")

    for dtype in (torch.float32, torch.bfloat16):
        for s, h, g, d in ((256, 4, 2, 64), (128, 8, 8, 32), (256, 6, 1, 128)):
            case(2, s, h, g, d, dtype, causal=True)
    case(1, 256, 4, 2, 32, torch.float32, causal=True, sliding_window=64, prefix_len=16)
    case(1, 128, 4, 4, 32, torch.float32, causal=False)
    case(1, 130, 4, 2, 64, torch.float32, causal=True)  # ragged
    err = 0.0
    for s in PROMPTS:
        case(1, s, YI["h"], YI["g"], YI["d"], torch.float32, causal=True)
        err = max(err, case(1, s, YI["h"], YI["g"], YI["d"], torch.bfloat16, causal=True))
    return err


def check_kv_pull(gen, dev):
    import torch

    from repro_torch.kernels.kv_pull.ops import kv_pull
    from repro_torch.kernels.kv_pull.ref import kv_pull_ref

    def exact(out, ref, what):
        if not torch.equal(out, ref):
            raise AssertionError(f"{what}: kernel differs from the plain version")

    sid = torch.tensor([0, 5, 11, 3], dtype=torch.int32, device=dev)
    did = torch.tensor([9, 1, 4, 0], dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        src = torch.randint(-100, 100, (12, 16, 2, 32), generator=gen, device=dev).to(dtype)
        dst = torch.randint(-100, 100, (10, 16, 2, 32), generator=gen, device=dev).to(dtype)
        keep = dst.clone()
        out = kv_pull(src, dst.clone(), sid, did)
        exact(out, kv_pull_ref(src, dst.clone(), sid, did), f"kv_pull {dtype}")
        untouched = [i for i in range(10) if i not in (9, 1, 4, 0)]
        exact(out[untouched], keep[untouched], "kv_pull untouched pages")
    for run_len in (2, 4):  # coalesced runs, expanded into page ids as the engine does
        src = torch.randn(16, 8, 2, 64, generator=gen, device=dev)
        dst = torch.randn(16, 8, 2, 64, generator=gen, device=dev)
        pages = torch.arange(run_len, dtype=torch.int32, device=dev)
        ss = (torch.tensor([0, 2], dtype=torch.int32, device=dev)[:, None] * run_len
              + pages).reshape(-1)
        ds = (torch.tensor([3, 1], dtype=torch.int32, device=dev)[:, None] * run_len
              + pages).reshape(-1)
        exact(kv_pull(src, dst.clone(), ss, ds), kv_pull_ref(src, dst.clone(), ss, ds),
              f"kv_pull runs of {run_len}")
    # Yi-9B: a 257-token request's pages (9 blocks x 48 layers x K,V) on
    # uint8 slabs of 32 KiB pages, the way the transfer engine calls it
    src, dst, sids, dids = yi_pull_inputs(gen, dev)
    keep = dst.clone()
    out = kv_pull(src, dst.clone(), sids, dids)
    torch.cuda.synchronize()
    exact(out, kv_pull_ref(src, dst.clone(), sids, dids), "kv_pull yi-9b pages")
    mask = torch.ones(dst.shape[0], dtype=torch.bool, device=dev)
    mask[dids.long()] = False
    exact(out[mask], keep[mask], "kv_pull yi-9b untouched pages")
    return 0.0


def yi_pull_inputs(gen, dev, dtype=None):
    import torch

    page = YI["bs"] * YI["g"] * YI["d"] * 2
    n_src = n_dst = 256 * 2 * 48 // 8   # a slice of a 256-block, 48-layer slab
    n_txn = 9 * 48 * 2
    sids = torch.randperm(n_src, generator=gen, device=dev)[:n_txn].to(torch.int32)
    dids = torch.randperm(n_dst, generator=gen, device=dev)[:n_txn].to(torch.int32)
    if dtype is None:
        src = torch.randint(0, 256, (n_src, page), generator=gen, device=dev,
                            dtype=torch.uint8)
        dst = torch.randint(0, 256, (n_dst, page), generator=gen, device=dev,
                            dtype=torch.uint8)
    else:  # int8 wire pages -> bf16 pool pages
        src = torch.randint(-127, 128, (n_txn, page // 2), generator=gen, device=dev,
                            dtype=torch.int8)
        dst = torch.randn(n_dst, page // 2, generator=gen, device=dev).to(dtype)
        sids = torch.arange(n_txn, dtype=torch.int32, device=dev)
    return src, dst, sids, dids


def check_kv_pull_dequant(gen, dev):
    import torch

    from repro_torch.kernels.kv_pull.ops import kv_pull_dequant
    from repro_torch.kernels.kv_pull.ref import kv_pull_dequant_ref

    sid = torch.tensor([0, 5, 11, 3], dtype=torch.int32, device=dev)
    did = torch.tensor([9, 1, 4, 0], dtype=torch.int32, device=dev)
    scales = torch.tensor([0.013, 1.0, 0.5, 0.0021], dtype=torch.float32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        src = torch.randint(-127, 128, (12, 16, 2, 32), generator=gen, device=dev,
                            dtype=torch.int8)
        dst = torch.randn(10, 16, 2, 32, generator=gen, device=dev).to(dtype)
        keep = dst.clone()
        out = kv_pull_dequant(src, dst.clone(), sid, did, scales)
        ref = kv_pull_dequant_ref(src, dst.clone(), sid, did, scales)
        if not torch.equal(out, ref):
            raise AssertionError(f"kv_pull_dequant {dtype}: differs from the plain version")
        untouched = [i for i in range(10) if i not in (9, 1, 4, 0)]
        if not torch.equal(out[untouched], keep[untouched]):
            raise AssertionError("kv_pull_dequant: untouched pages changed")
    # round trip: |err| <= max|x|/127 per page
    x = torch.randn(3, 8, 2, 16, generator=gen, device=dev)
    sc = x.abs().reshape(3, -1).amax(dim=1) / 127.0
    q = torch.clamp(torch.round(x / sc[:, None, None, None]), -127, 127).to(torch.int8)
    ids = torch.arange(3, dtype=torch.int32, device=dev)
    out = kv_pull_dequant(q, torch.zeros_like(x), ids, ids, sc)
    err = (out - x).abs().reshape(3, -1).amax(dim=1)
    if not bool((err <= x.abs().reshape(3, -1).amax(dim=1) / 127.0 + 1e-7).all()):
        raise AssertionError("kv_pull_dequant: round trip beyond max|x|/127")
    src, dst, sids, dids = yi_pull_inputs(gen, dev, torch.bfloat16)
    scales = torch.rand(sids.shape[0], generator=gen, device=dev) * 0.05
    out = kv_pull_dequant(src, dst.clone(), sids, dids, scales)
    torch.cuda.synchronize()
    if not torch.equal(out, kv_pull_dequant_ref(src, dst.clone(), sids, dids, scales)):
        raise AssertionError("kv_pull_dequant yi-9b pages: differs from the plain version")
    return 0.0


# --------------------------------------------------------- phases 3-4
def greedy(model, logits):
    import torch

    return torch.argmax(logits[:, :model.cfg.vocab_size].float(), dim=-1).to(torch.int32)


def monolithic_generate(model, params, tokens, n):
    import torch

    logits, state = model.prefill(params, {"tokens": torch.as_tensor(tokens[None])})
    tok = greedy(model, logits)
    out = [int(tok[0])]
    for _ in range(n):
        logits, state = model.decode_step(params, state, tok)
        tok = greedy(model, logits)
        out.append(int(tok[0]))
    return out


def monolithic_batched(model, params, prompts, n):
    """Each prompt prefilled alone, the states stacked (pages padded to one
    per-sequence count), then ``n`` decode_steps at b = len(prompts)."""
    import dataclasses

    import torch

    bs = model.BLOCK_SIZE
    per_seq = max(-(-len(t) // bs) for t in prompts) + -(-n // bs) + 1
    firsts, states = [], []
    for t in prompts:
        logits, st = model.prefill(params, {"tokens": torch.as_tensor(t[None])},
                                   max_blocks_margin=per_seq - -(-len(t) // bs))
        firsts.append(greedy(model, logits))
        states.append(st)
    state = dataclasses.replace(
        states[0],
        context_lens=torch.cat([st.context_lens for st in states]),
        k_pages=torch.cat([st.k_pages for st in states], dim=1),
        v_pages=torch.cat([st.v_pages for st in states], dim=1),
        block_tables=torch.cat([st.block_tables for st in states]))
    del states
    tok = torch.cat(firsts)
    out = [[int(x)] for x in tok.tolist()]
    for _ in range(n):
        logits, state = model.decode_step(params, state, tok)
        tok = greedy(model, logits)
        for seq, x in zip(out, tok.tolist()):
            seq.append(int(x))
    return out


def kernel_ops():
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.kv_pull.ops import kv_pull, kv_pull_dequant
    from repro_torch.kernels.paged_attention.ops import paged_attention

    return {"paged_attention": paged_attention, "flash_prefill": flash_prefill,
            "kv_pull": kv_pull, "kv_pull_dequant": kv_pull_dequant}


def read_counts():
    return {name: op.launches for name, op in kernel_ops().items()}


def reset_counts():
    for op in kernel_ops().values():
        op.launches = 0


def expect_launches(path, got, n_layers, prompts, decode_steps, quantized):
    """Fail unless ``path`` (a run whose counts were zeroed just before it)
    went through the kernels it must use: flash_prefill once per layer and
    prompt, paged_attention once per layer and decode step, kv_pull (plain
    reads) or kv_pull_dequant (quantized reads) at least once."""
    want = {"flash_prefill": n_layers * prompts, "paged_attention": n_layers * decode_steps}
    bad = [f"{k} {got[k]} != {v}" for k, v in want.items() if got[k] != v]
    if quantized and got["kv_pull_dequant"] <= 0:
        bad.append("kv_pull_dequant never launched")
    if not quantized and (got["kv_pull"] <= 0 or got["kv_pull_dequant"] != 0):
        bad.append(f"kv_pull {got['kv_pull']}, kv_pull_dequant {got['kv_pull_dequant']}")
    if bad:
        raise AssertionError(f"{path}: launches {got}: {'; '.join(bad)}")
    log(f"{path}: launches {got}")
    return got


def phase_serve(model, params, prompts, refs):
    """Phases 3 and 4, each run a path of its own.  Returns (the launch
    counts of the two launch.serve runs, launches per request of the
    direct one-at-a-time run, and for kv_pull_dequant of the quantized
    direct run)."""
    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.serving.disagg import DisaggService

    n_layers = model.cfg.num_layers
    serve_args = ["--arch", "yi-9b", "--requests", "3", "--prompt-len", "96",
                  "--max-new", str(MAX_NEW)]
    serve_counts = {}
    for quantized in (False, True):
        path = "launch.serve" + (" --quantize-transfer" if quantized else "")
        reset_counts()
        t0 = time.perf_counter()
        serve.main(serve_args + (["--quantize-transfer"] if quantized else []))
        torch.cuda.synchronize()
        log(f"phase 3: {path} yi-9b, 3 requests in {time.perf_counter() - t0:.1f}s")
        serve_counts[quantized] = expect_launches(
            f"phase 3: {path}", read_counts(), n_layers, 3, 3 * MAX_NEW, quantized)

    svc = DisaggService(model, params, n_prefill=2, n_decode=1, num_blocks=256)
    reset_counts()
    t0 = time.perf_counter()
    for tokens, ref in zip(prompts, refs):
        h = svc.submit(tokens)
        got = svc.generate(h, max_new=MAX_NEW)
        if got != ref:
            raise AssertionError(f"{len(tokens)}-token prompt: disaggregated {got} "
                                 f"!= monolithic {ref}")
        log(f"phase 4: {len(tokens)}-token prompt via {h.request.prefill_worker}: "
            f"tokens {got} == monolithic; pulled {h.metrics.kv_bytes_pulled} B")
    torch.cuda.synchronize()
    seq = expect_launches("phase 4: one at a time", read_counts(), n_layers,
                          len(prompts), len(prompts) * MAX_NEW, False)
    per_request = {k: n / len(prompts) for k, n in seq.items()}
    log(f"phase 4: 3 requests disaggregated in {time.perf_counter() - t0:.1f}s")

    # continuous batching with every pull landed first: all three decode
    # together from the first step, so every step runs at b = 3
    reset_counts()
    hs = [svc.submit(t) for t in prompts]
    svc.admit_queued()
    svc.pump(None)
    slots = list(svc.decode.resident)
    if sorted(slots) != sorted(h.request_id for h in hs):
        raise AssertionError(f"not every pull landed before decode: resident {slots}")
    batched = svc.generate_many(hs, max_new=MAX_NEW)
    torch.cuda.synchronize()
    expect_launches("phase 4: together at b = 3", read_counts(), n_layers, len(prompts),
                    MAX_NEW, False)
    by_id = {h.request_id: t for h, t in zip(hs, prompts)}
    ref3 = dict(zip(slots, monolithic_batched(model, params, [by_id[r] for r in slots],
                                              MAX_NEW)))
    for h in hs:
        if batched[h.request_id] != ref3[h.request_id]:
            raise AssertionError(f"b = 3: {len(by_id[h.request_id])}-token prompt: "
                                 f"disaggregated {batched[h.request_id]} != monolithic "
                                 f"b = 3 {ref3[h.request_id]}")
    same_b1 = sum(batched[h.request_id] == r for h, r in zip(hs, refs))
    log(f"phase 4: together at b = 3 (slots {slots}): every stream equals the "
        f"monolithic b = 3 stream; {same_b1}/3 also equal the b = 1 streams")
    del svc, hs

    svc = DisaggService(model, params, n_prefill=2, n_decode=1, num_blocks=256,
                        quantize_transfer=True)
    reset_counts()
    hs = [svc.submit(t) for t in prompts]
    out = svc.generate_many(hs, max_new=MAX_NEW)
    torch.cuda.synchronize()
    got = read_counts()
    if got["kv_pull_dequant"] <= 0 or got["flash_prefill"] != n_layers * len(prompts):
        raise AssertionError(f"phase 4: quantized: launches {got}")
    log(f"phase 4: quantized: launches {got}")
    per_request["kv_pull_dequant"] = got["kv_pull_dequant"] / len(hs)
    stats = svc.engine.stats
    block = svc.decode.cache.block_nbytes
    if stats.bytes_moved != stats.reads_posted * (block // 2 + 4):
        raise AssertionError(f"quantized wire bytes {stats.bytes_moved} != "
                             f"{stats.reads_posted} reads x ({block}/2 + 4)")
    if any(len(out[h.request_id]) != MAX_NEW + 1 for h in hs):
        raise AssertionError("quantized run did not finish every request")
    agree = [int(np.sum(np.array(out[h.request_id]) == np.array(r)))
             for h, r in zip(hs, refs)]
    log(f"phase 4: quantized transfer: {stats.reads_posted} reads, "
        f"{stats.bytes_moved} wire bytes = reads x ({block}/2+4); tokens agreeing "
        f"with full precision per request {agree}/{MAX_NEW + 1}")
    del svc, hs
    return serve_counts, per_request


# ------------------------------------------------------------ phase 5
def time_ms(fn, iters=50, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops):
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3, \
        ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_BF16_FLOPS else "operations")


def phase_times(gen, dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import dense_ref
    from repro_torch.kernels.kv_pull.ops import kv_pull, kv_pull_dequant
    from repro_torch.kernels.kv_pull.ref import kv_pull_dequant_ref, kv_pull_ref
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    h, g, d, bs = YI["h"], YI["g"], YI["d"], YI["bs"]
    bf = torch.bfloat16
    rows = {}

    # paged_attention: the batched decode step over the three prompts
    b, per = 3, 11
    ctx_list = [p + MAX_NEW for p in PROMPTS]
    q = torch.randn(b, h, d, generator=gen, device=dev).to(bf)
    kp = torch.randn(b, per, bs, g, d, generator=gen, device=dev).to(bf)
    vp = torch.randn(b, per, bs, g, d, generator=gen, device=dev).to(bf)
    tables = torch.arange(per, dtype=torch.int32, device=dev)[None].repeat(b, 1)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
    t_max = max(ctx_list)
    kf = kp.reshape(b, per * bs, g, d)[:, :t_max].repeat_interleave(h // g, dim=2)
    vf = vp.reshape(b, per * bs, g, d)[:, :t_max].repeat_interleave(h // g, dim=2)
    kf, vf = kf.transpose(1, 2).contiguous(), vf.transpose(1, 2).contiguous()
    mask = (torch.arange(t_max, device=dev)[None] < ctx[:, None])[:, None, None, :]
    qf = q[:, :, None, :]
    kv_read = sum(ctx_list) * g * d * 2 * 2
    rows["paged_attention"] = dict(
        ms=time_ms(lambda: paged_attention(q, kp, vp, tables, ctx)),
        plain_ms=time_ms(lambda: paged_attention_ref(q, kp, vp, tables, ctx)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qf, kf, vf, attn_mask=mask)),
        bound=bound_ms(kv_read + 2 * q.numel() * 2 + tables.numel() * 4 + b * 4,
                       4 * h * d * sum(ctx_list)),
        shape=f"b={b} h={h} g={g} d={d} bs={bs} ctx={ctx_list} bf16")

    # flash_prefill: the longest prompt's prefill attention, one layer
    s = max(PROMPTS)
    qp = torch.randn(1, s, h, d, generator=gen, device=dev).to(bf)
    kk = torch.randn(1, s, g, d, generator=gen, device=dev).to(bf)
    vv = torch.randn(1, s, g, d, generator=gen, device=dev).to(bf)
    qs = qp.transpose(1, 2).contiguous()
    ks = kk.repeat_interleave(h // g, dim=2).transpose(1, 2).contiguous()
    vs = vv.repeat_interleave(h // g, dim=2).transpose(1, 2).contiguous()
    visible = s * (s + 1) // 2
    rows["flash_prefill"] = dict(
        ms=time_ms(lambda: flash_prefill(qp, kk, vv, causal=True)),
        plain_ms=time_ms(lambda: dense_ref(qp, kk, vv, causal=True)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True)),
        bound=bound_ms((2 * qp.numel() + 2 * kk.numel()) * 2, 4 * h * d * visible),
        shape=f"b=1 s={s} h={h} g={g} d={d} causal bf16")

    # kv_pull: one 257-token request's pages, uint8 slab pages of 32 KiB
    src, dst, sids, dids = yi_pull_inputs(gen, dev)
    sl, dl = sids.long(), dids.long()
    n, page = sids.shape[0], src.shape[1]
    rows["kv_pull"] = dict(
        ms=time_ms(lambda: kv_pull(src, dst, sids, dids)),
        plain_ms=time_ms(lambda: kv_pull_ref(src, dst, sids, dids)),
        library_ms=time_ms(lambda: dst.index_copy_(0, dl, src.index_select(0, sl))),
        bound=bound_ms(2 * n * page + 2 * n * 4, 0),
        shape=f"{n} pages x {page} B (9 blocks x 48 layers x K,V)")

    # kv_pull_dequant: the same request's pages, int8 wire -> bf16 pool
    src, dst, sids, dids = yi_pull_inputs(gen, dev, bf)
    scales = torch.rand(n, generator=gen, device=dev) * 0.05
    dl = dids.long()
    elems = src.shape[1]
    rows["kv_pull_dequant"] = dict(
        ms=time_ms(lambda: kv_pull_dequant(src, dst, sids, dids, scales)),
        plain_ms=time_ms(lambda: kv_pull_dequant_ref(src, dst, sids, dids, scales)),
        library_ms=time_ms(lambda: dst.index_copy_(
            0, dl, (src.float() * scales[:, None]).to(bf))),
        bound=bound_ms(n * elems * (1 + 2) + n * 12, n * elems),
        shape=f"{n} pages x {elems} int8 -> bf16")
    return rows


SOURCES = {
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:101"),
    "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill/kernel.py:103"),
    "kv_pull": ("src/repro_torch/csrc/kv_pull.cu",
                "src/repro/kernels/kv_pull/kernel.py:68"),
    "kv_pull_dequant": ("src/repro_torch/csrc/kv_pull.cu",
                        "src/repro/kernels/kv_pull/kernel.py:92"),
}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    log(f"GPU: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {
        "paged_attention": check_paged_attention(gen, dev),
        "flash_prefill": check_flash_prefill(gen, dev),
        "kv_pull": check_kv_pull(gen, dev),
        "kv_pull_dequant": check_kv_pull_dequant(gen, dev),
    }
    log(f"phase 2: every kernel matches its plain version; yi-9b bf16 max |err| {errs}")

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config("yi-9b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    log(f"{cfg.describe()}; weights in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPTS]
    refs = [monolithic_generate(model, params, t, MAX_NEW) for t in prompts]
    serve_counts, per_request = phase_serve(model, params, prompts, refs)
    del params, model
    torch.cuda.empty_cache()

    rows = phase_times(gen, dev)
    kernels = []
    for name, row in rows.items():
        src, replaces = SOURCES[name]
        bms, by = row["bound"]
        quantized = name == "kv_pull_dequant"
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": serve_counts[quantized][name],
            "launches_run": "launch.serve" + (" --quantize-transfer" if quantized else ""),
            "launches_per_request": per_request[name],
            "max_abs_err": errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": bms, "bound_by": by, "library_ms": row["library_ms"],
            "shape": row["shape"]})
        log(f"phase 5: {name} [{row['shape']}]: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound "
            f"{bms:.5f} ms by {by}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
