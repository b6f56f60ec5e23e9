#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. Build: the GPU's name and power limit; every CUDA kernel of the main
   paths compiled from ``src/repro_torch/csrc`` by nvcc (sm_90a).
2. Kernels against their plain PyTorch versions on the card, at Yi-9B
   shapes and at the CPU test grid, f32 (2e-4) and bf16 (2e-2); kv_pull
   exact with untouched pages intact; the int8 round trip within
   max|plane|/127; flash_prefill at hymba-1.5b's full shape (window 1024,
   128-token prefix, 1328 tokens); kv_pull_dequant bit-equal into f32
   and bf16 pools, on pages that are not a multiple of 16 elements, on a
   pool slice that is not 16-byte aligned and on a full Yi-9B pull;
   ssd_scan on the JAX test grid, the decay extremes (finite) and the full
   mamba2-780m / hymba-1.5b shapes at s = 1, 63, 64, 65, the prompts and
   1328, f32 (1e-3; the full mamba2 prompts within 1e-4) and bf16 x
   (2e-2); the attention kernels at the shapes of phases 8-10:
   paged_attention at granite-moe's GQA 24/8, whisper's MHA 20/20 (d 64)
   and llava's 3018-token context, flash_prefill non-causal over 1500 keys
   (s = 1500, 33, 1; d 64 and 128), at granite-moe's prompts and at
   llava's 2976 and 3010 tokens.  The training path's attention:
   flash_prefill's lse output against the plain ``_fwd_scan`` port (its
   out path unchanged, bit for bit), and the autograd Function's dq, dk,
   dv (the kernel forward, the plain-torch backward) against autograd
   through the plain version, at Yi-9B s = 257 and 2048, whisper's
   encoder and hymba's window + prefix, f32 and bf16.  Phase 1 also fails unless the SASS of
   the ssd_scan kernels that multiply holds tensor-core (HMMA)
   instructions.
3. Serve through the normal entry point: ``repro_torch.launch.serve`` at
   the full Yi-9B config (48 layers, d_model 4096, random weights), once
   plain and once with ``--quantize-transfer``.
   3b. Yi-9B once more through ``launch.serve --topology hetero_rack:0``:
   roles planned over a generated heterogeneous rack, each worker's pool
   sized by its machine's VRAM (both printed); the tokens must equal
   monolithic runs on the same weights.
4. Serve directly: a ``DisaggService`` with 2 prefill and 1 decode
   workers on ragged prompts (96, 130, 257 tokens).  One at a time, every
   request's tokens must equal a monolithic prefill + decode_step run on
   the same card; all three decoded together (every step at b = 3) must
   equal a monolithic b = 3 decode_step run over the stacked prefill
   states; then once with ``quantize_transfer=True`` (int8 wire bytes,
   nbytes/2+4 per read, landed by kv_pull_dequant).
6. mamba2-780m at full width (48 layers, d_model 1536, random weights)
   through ``launch.steps``' prefill and serve steps on the same ragged
   prompts: monolithically, then disaggregated, each request's SSM state
   written into f32 slots, pulled slot to slot by ``pull_state`` (kv_pull
   on the card, 77,414,400 bytes a request) and decoded from the pulled
   slots: the tokens must equal the monolithic ones, one at a time and
   all three together at b = 3.
7. hymba-1.5b at full width (32 layers, d_model 1600, 25/5 heads, window
   1024, 128 meta tokens) on prompts of 96, 130 and 1200 tokens (the
   last passes the window: the prefill mask and the ring's wrap run).
   With the weights in f32, the three decoded together in one ring batch
   (mixed positions) must give each one's b = 1 logits, step by step.
   For both models, prefill(p) + decode_step(t) must equal prefill(p + t)
   with the weights in f32.
   Every serving run is a path of its own: the launch counts are zeroed
   just before it and read just after, and the run fails unless each
   kernel it must use launched (flash_prefill and ssd_scan once per
   layer and prompt, paged_attention once per layer and decode step) and
   no other did.
8. granite-moe-3b-a800m at full width (32 layers, d_model 1536, 40
   experts top-8 padded to 48) served as Yi-9B in phases 3-4: launch.serve
   plain and quantized, then the DisaggService on 96/130/257 tokens, its
   tokens equal to monolithic runs one at a time and at b = 3 in the same
   row order.  Then llama4-maverick-400b-a17b at full width cut to one
   group (a dense layer, d_ff 16384, and a MoE layer of 128 experts top-1
   with the shared expert; about 37 GB): 96 tokens and 8 new ones, tokens
   in range, launch counts exact.
9. llava-next-mistral-7b at full width with 2880 seeded image embeddings
   ahead of 96 and 130 text tokens, through the steps: each prompt's pages
   parked in a PagedKVCache on the card, pulled by pull_kv (kv_pull) into
   another and decoded from there; the tokens equal the monolithic ones.
10. whisper-large-v3 at full width (32 encoder and 32 decoder layers)
   over 1500 seeded frames, decoder prompts of 4, 33 and 130 tokens, 8 new
   tokens each; flash_prefill 96 times a prefill and 32 times a step (the
   cross-attention), paged_attention 32 times a step; with the weights in
   f32, prefill(p) + decode_step(t) against prefill(p + t).
   Phases 8-10 zero and check their own launch counts, as 3-7 do, and
   free each model before the next is built.
11. Training: granite-moe-3b-a800m at its full config (every layer and
   expert) through ``launch.train``, batch 4 x 512, 6 steps, the losses
   finite and falling; then, at its full width cut to 8 layers (the full
   state's 55.7 GB checkpoint exceeds what a run may write to the
   machine's disk), 6 steps, and 3 steps with a checkpoint at step 3 and
   a ``--resume`` run: the resumed losses equal the uninterrupted run's
   bit for bit.  Then
   Yi-9B at full width cut to 16 layers through ``make_train_step``, two
   steps at s = 2048 (flash_prefill exactly layers x steps x 2 times under
   remat), and a 2-layer f32 cut's step through the kernel against one
   through the plain versions (loss 1e-5, grad norm 1e-4 relative).  Step
   times, tokens a second and peak memory beside the card's name and
   power limit.
5. Times at the main paths' shapes: each kernel, its plain version, one
   PyTorch library call computing the same function (none computes the
   SSD scan), and the bound; for ssd_scan also each of its launches'
   device time (torch.profiler); and rows at whisper's decode, encoder and
   decode cross-attention and llava's 2976-token prefill; flash_prefill's
   forward with lse at Yi-9B s = 2048 (beside the call without it) and the
   training backward (plain torch after ``_bwd_scan``) at the same shape.

Then one JSON line of kernel records, the ``nvidia-smi`` name/power line,
and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core rate
PEAK_TF32_FLOPS = 495e12           # H100 SXM dense TF32 tensor-core rate
PEAK_F32_FLOPS = 67e12             # H100 SXM f32 without tensor cores
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# the long bf16 cases also hold ||out - ref|| / ||ref|| under this: their
# outputs (about 0.02 over 4096 keys) are near the bf16 atol, while bf16
# rounding in the kernel and the plain version leaves about 4e-3 and a
# partition of 16 left out about 0.27
REL_NORM_BF16 = 1e-2
SSD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}   # the JAX package's own for ssd_scan
SSD_F32_MAMBA2 = 1e-4              # 3xTF32 at f32 accuracy; 1xTF32 would leave ~7e-4
CONSISTENCY_TOL = 1e-3             # f32 prefill(p) + decode(t) vs prefill(p + t), logits
YI = dict(h=32, g=4, d=128, bs=32)
MAMBA = dict(nh=48, hd=64, ns=128)
HYMBA = dict(h=25, g=5, d=64, nh=50, hd=64, ns=16, window=1024, meta=128)
GRANITE = dict(h=24, g=8, d=64)
MAVERICK = dict(h=40, g=8, d=128, prompt=96)   # llama4-maverick, cut to 2 layers
LLAVA = dict(h=32, g=8, d=128, vision=2880)
WHISPER = dict(h=20, g=20, d=64, frames=1500)
PROMPTS = (96, 130, 257)
HYMBA_PROMPTS = (96, 130, 1200)
LLAVA_PROMPTS = (96, 130)          # text after the 2880 image tokens
WHISPER_PROMPTS = (4, 33, 130)     # decoder prompts over 1500 frames
MAX_NEW = 8
BF16_HEAD_DIMS = (32, 64, 128)     # flash_prefill's tensor-core kernels
LONG_PROMPT = 4096                 # the longer rows of phase 5
LONG_CTX = 4096
TRAIN_SEQ = 2048                   # the Yi-9B training cut's length
# (b, s, t, h, g, d, kwargs) of the training path's attention checks: Yi-9B
# causal at a serving prompt and at TRAIN_SEQ, whisper's encoder, hymba's
# window and meta prefix
TRAIN_SHAPES = [
    (1, 257, 257, 32, 4, 128, dict(causal=True)),
    (1, TRAIN_SEQ, TRAIN_SEQ, 32, 4, 128, dict(causal=True)),
    (1, 1500, 1500, 20, 20, 64, dict(causal=False)),
    (1, 1328, 1328, 25, 5, 64, dict(causal=True, sliding_window=1024, prefix_len=128)),
]
BWD_REL = {"float32": 2e-4, "bfloat16": 1e-2}   # flash backward, ||err|| / ||ref||
GRANITE_TRAIN = ["--arch", "granite-moe-3b-a800m", "--batch", "4", "--seq", "512",
                 "--lr", "3e-3"]
GRANITE_CKPT_LAYERS = 8            # the checkpointed granite cut (17 GB on disk)
YI_TRAIN_LAYERS = 16               # Yi-9B cut in depth for its train state to fit
YI_TRAIN_BATCH = 2
TRAIN_LOSS_RTOL = 1e-5             # kernel step vs plain step, f32 2-layer Yi cut
TRAIN_GNORM_RTOL = 1e-4


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
        if any(w in line for w in ("entry function", "registers", "spill")) \
                or line.startswith("=="):
            log(f"  {line.strip()}")
    tensor_core_sass(path, build)


def tensor_core_sass(path, build):
    """Count the tensor-core instructions (HMMA, HGMMA) in each flash_prefill
    and ssd_scan kernel's SASS (``cuobjdump -sass`` of the built library);
    fail unless every bf16 flash_prefill kernel has some and the f32 one
    has none, and every ssd_scan kernel that multiplies (the chunk states,
    whose grid also takes C.B^T, and the outputs, each for f32 and bf16 x:
    TF32 HMMA) has some."""
    import pathlib as _pathlib

    tool = _pathlib.Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(path)], check=True, capture_output=True,
                          text=True).stdout
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        name = re.search(r"flash_prefill_(bf16|f32)_kernel(ILi\d+E)?"
                         r"|ssd_(state|out|pass)_kernel(I\w*?E)?",
                         chunk.split(None, 1)[0])
        if name:
            counts[name.group(0)] = sum(1 for ln in chunk.splitlines()
                                        if "HMMA" in ln or "HGMMA" in ln)
    bf16 = {n: c for n, c in counts.items() if "flash_prefill_bf16" in n}
    f32 = {n: c for n, c in counts.items() if "flash_prefill_f32" in n}
    ssd = {n: c for n, c in counts.items() if n.startswith("ssd_") and "pass" not in n}
    log(f"phase 1: tensor-core instructions (HMMA/HGMMA) in SASS: {counts}")
    if len(bf16) != len(BF16_HEAD_DIMS) or not all(bf16.values()) or any(f32.values()) \
            or not f32:
        raise AssertionError(f"flash_prefill SASS: bf16 kernels {bf16}, f32 kernel {f32}")
    kinds = {f"{k}_kernelI{d}" for k in ("state", "out") for d in ("f", "13__nv_bfloat16")}
    if not all(any(n.startswith(f"ssd_{k}") for n in ssd) for k in kinds) \
            or not all(ssd.values()):
        raise AssertionError(f"ssd_scan SASS: the multiplying kernels {ssd} must all hold HMMA")


# ------------------------------------------------------------ phase 2
def close(out, ref, tol, what, rel_norm=None):
    import torch

    out32, ref32 = out.float(), ref.float()
    err = float((out32 - ref32).abs().max()) if out.numel() else 0.0
    if not torch.isfinite(out32).all():
        raise AssertionError(f"{what}: non-finite output")
    if not torch.allclose(out32, ref32, rtol=tol, atol=tol):
        raise AssertionError(f"{what}: max |err| {err} above tolerance {tol}")
    if rel_norm is not None:
        rel = float((out32 - ref32).norm() / ref32.norm())
        log(f"phase 2: {what}: ||err|| / ||ref|| {rel:.3e} (limit {rel_norm})")
        if not rel <= rel_norm:
            raise AssertionError(f"{what}: ||err|| / ||ref|| {rel} above {rel_norm}")
    return err


def check_paged_attention(gen, dev):
    import torch

    from repro_torch.kernels.paged_attention.ops import paged_attention, partitions
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    def case(b, h, g, d, per, bs, dtype, tables=None, ctx=None, rel_norm=None):
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
                     f"paged_attention b={b} h={h} g={g} d={d} {dtype}", rel_norm)

    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 4, 2, 64, 4, 32), (3, 8, 1, 128, 3, 32), (1, 8, 8, 64, 5, 16),
                      (3, 8, 2, 8, 6, 16), (3, 8, 2, 16, 6, 16)):  # every head dim
            case(*shape, dtype)
    case(1, 4, 2, 32, 4, 16, torch.float32,
         tables=torch.tensor([[2, 0, 3, 1]], dtype=torch.int32, device=dev),
         ctx=torch.tensor([64], dtype=torch.int32, device=dev))
    case(2, 2, 1, 32, 2, 16, torch.float32,
         ctx=torch.ones(2, dtype=torch.int32, device=dev))
    # split-KV: b = 8 leaves several pages per partition; ctx = 1, on a
    # partition edge and one past it (empty trailing partitions everywhere)
    pages, n_part = partitions(8, YI["g"], YI["h"] // YI["g"], 40, sm_count(dev))
    edge = pages * 16
    for dtype in (torch.float32, torch.bfloat16):
        for ctx in ([1] * 8, [edge, 2 * edge, edge + 1, 1] * 2):
            case(8, YI["h"], YI["g"], YI["d"], 40, 16, dtype,
                 ctx=torch.tensor(ctx, dtype=torch.int32, device=dev))
    log(f"phase 2: paged_attention split at b = 8, 40 pages of 16: grid "
        f"{paged_attention.last_grid} as launched, {n_part} partitions of {pages} pages; "
        f"ctx 1, {edge}, {2 * edge}, {edge + 1}")
    yi_ctx = torch.tensor([p + MAX_NEW for p in PROMPTS], dtype=torch.int32, device=dev)
    case(3, YI["h"], YI["g"], YI["d"], 11, YI["bs"], torch.float32, ctx=yi_ctx)
    long_ctx = torch.full((8,), LONG_CTX, dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        case(8, YI["h"], YI["g"], YI["d"], LONG_CTX // YI["bs"], YI["bs"], dtype,
             ctx=long_ctx, rel_norm=REL_NORM_BF16 if dtype == torch.bfloat16 else None)
    # the new families' decode shapes: granite-moe GQA 24/8 at d = 64 (b = 3,
    # Yi's prompts), whisper MHA 20/20 (one query head a kv-head), llava
    # after its image
    whisper_ctx = torch.tensor([p + MAX_NEW for p in WHISPER_PROMPTS], dtype=torch.int32,
                               device=dev)
    llava_ctx = torch.tensor([LLAVA["vision"] + max(LLAVA_PROMPTS) + MAX_NEW],
                             dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        case(3, GRANITE["h"], GRANITE["g"], GRANITE["d"], 11, 32, dtype, ctx=yi_ctx)
        case(3, WHISPER["h"], WHISPER["g"], WHISPER["d"], 21, 32, dtype, ctx=whisper_ctx)
        # llama4-maverick: h/g = 5 at d = 128, 3 + 16 pages after its prompt
        case(1, MAVERICK["h"], MAVERICK["g"], MAVERICK["d"], 19, 32, dtype,
             ctx=torch.tensor([MAVERICK["prompt"] + MAX_NEW], dtype=torch.int32, device=dev))
    case(1, LLAVA["h"], LLAVA["g"], LLAVA["d"], 111, 32, torch.bfloat16, ctx=llava_ctx,
         rel_norm=REL_NORM_BF16)
    log("phase 2: paged_attention at granite-moe 24/8 d 64, whisper MHA 20/20 d 64, "
        f"llama4-maverick 40/8 d 128 (grid {paged_attention.last_grid} at the last), "
        f"llava 32/8 d 128 over {int(llava_ctx[0])} tokens")
    return case(3, YI["h"], YI["g"], YI["d"], 11, YI["bs"], torch.bfloat16, ctx=yi_ctx)


def sm_count(dev):
    import torch

    return torch.cuda.get_device_properties(dev).multi_processor_count


def check_flash_prefill(gen, dev):
    import torch

    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import dense_ref

    def case(b, s, h, g, d, dtype, rel_norm=None, t=None, **kw):
        t = s if t is None else t
        q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, t, g, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, t, g, d, generator=gen, device=dev).to(dtype)
        out = flash_prefill(q, k, v, **kw)
        torch.cuda.synchronize()
        return close(out, dense_ref(q, k, v, **kw), TOL[str(dtype).split(".")[1]],
                     f"flash_prefill s={s} t={t} h={h} g={g} d={d} {dtype} {kw}", rel_norm)

    for dtype in (torch.float32, torch.bfloat16):
        for s, h, g, d in ((256, 4, 2, 64), (128, 8, 8, 32), (256, 6, 1, 128)):
            case(2, s, h, g, d, dtype, causal=True)
    case(1, 256, 4, 2, 32, torch.float32, causal=True, sliding_window=64, prefix_len=16)
    case(1, 128, 4, 4, 32, torch.float32, causal=False)
    case(1, 130, 4, 2, 64, torch.float32, causal=True)  # ragged
    for d in BF16_HEAD_DIMS:  # every tensor-core kernel; one row, ragged rows
        for s in (1, 130, 257):
            case(2, s, 8, 2, d, torch.bfloat16, causal=True)
    case(1, LONG_PROMPT, YI["h"], YI["g"], YI["d"], torch.bfloat16, rel_norm=REL_NORM_BF16,
         causal=True)
    err = 0.0
    for s in PROMPTS:
        case(1, s, YI["h"], YI["g"], YI["d"], torch.float32, causal=True)
        err = max(err, case(1, s, YI["h"], YI["g"], YI["d"], torch.bfloat16, causal=True))
    # hymba-1.5b: the longest prompt with its meta prefix, window and prefix
    hy = dict(causal=True, sliding_window=HYMBA["window"], prefix_len=HYMBA["meta"])
    s = max(HYMBA_PROMPTS) + HYMBA["meta"]
    for dtype in (torch.float32, torch.bfloat16):
        case(1, s, HYMBA["h"], HYMBA["g"], HYMBA["d"], dtype, **hy)
    # whisper: the encoder (1500 x 1500) and the cross-attention of each
    # prompt and of a decode step over 1500 keys, not a multiple of the
    # 64-row tile, non-causal, at d = 64 (whisper's MHA; the d = 128 kernel
    # at its own cases); the decoder prompts causal
    t = WHISPER["frames"]
    for dtype in (torch.float32, torch.bfloat16):
        for s in (t, *WHISPER_PROMPTS, 1):
            case(1, s, WHISPER["h"], WHISPER["g"], WHISPER["d"], dtype, t=t, causal=False)
        for s in (t, 33, 1):
            case(1, s, 16, 16, 128, dtype, t=t, causal=False)
        for s in WHISPER_PROMPTS:
            case(1, s, WHISPER["h"], WHISPER["g"], WHISPER["d"], dtype, causal=True)
        for s in PROMPTS:  # granite-moe GQA 24/8 at d = 64
            case(1, s, GRANITE["h"], GRANITE["g"], GRANITE["d"], dtype, causal=True)
        # llama4-maverick's prompt: h/g = 5 at d = 128
        case(1, MAVERICK["prompt"], MAVERICK["h"], MAVERICK["g"], MAVERICK["d"], dtype,
             causal=True)
    for text in LLAVA_PROMPTS:  # llava's image + text prefill
        case(1, LLAVA["vision"] + text, LLAVA["h"], LLAVA["g"], LLAVA["d"], torch.bfloat16,
             rel_norm=REL_NORM_BF16, causal=True)
    log(f"phase 2: flash_prefill non-causal s = {t}, {WHISPER_PROMPTS}, 1 over t = {t} at "
        f"d = 64 (and {t}, 33, 1 at 128), whisper's causal prompts {WHISPER_PROMPTS}, "
        f"granite-moe 24/8 d 64, llama4-maverick 40/8 d 128, llava 32/8 d 128 at "
        f"{[LLAVA['vision'] + p for p in LLAVA_PROMPTS]} tokens")
    return err


def check_flash_training(gen, dev):
    """The training path's attention: the kernel's lse against the plain
    ``_fwd_scan`` port's (the out path unchanged, bit for bit), and the
    autograd Function's dq/dk/dv (the kernel forward, the torch backward)
    against autograd through the plain version in f32, at TRAIN_SHAPES in
    f32 and bf16.  Returns (max |lse err|, max ||grad err|| / ||ref||)."""
    import torch

    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import dense_ref
    from repro_torch.models.flash import flash_attention, flash_forward_plain

    lse_err = bwd_err = 0.0
    for b, s, t, h, g, d, kw in TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            what = f"s={s} t={t} h={h} g={g} d={d} {name} {kw}"
            q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, t, g, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(b, t, g, d, generator=gen, device=dev).to(dtype)
            out, lse = flash_prefill(q, k, v, return_lse=True, **kw)
            _, ref_lse = flash_forward_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            if not torch.equal(out, flash_prefill(q, k, v, **kw)):
                raise AssertionError(f"flash_prefill {what}: out with lse != out without")
            lse_err = max(lse_err, close(lse, ref_lse, TOL[name], f"flash_prefill lse {what}"))
            dout = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
            flash_attention(*xs, **kw).backward(dout)
            refs = [x.float().requires_grad_(True) for x in (q, k, v)]
            dense_ref(*refs, **kw).backward(dout.float())
            torch.cuda.synchronize()
            for n, x, r in zip("qkv", xs, refs):
                if not torch.isfinite(x.grad).all():
                    raise AssertionError(f"flash backward {what}: non-finite d{n}")
                rel = float((x.grad.float() - r.grad).norm() / r.grad.norm())
                if not rel <= BWD_REL[name]:
                    raise AssertionError(f"flash backward {what}: d{n} ||err|| / ||ref|| "
                                         f"{rel} above {BWD_REL[name]}")
                bwd_err = max(bwd_err, rel)
            del xs, refs
    log(f"phase 2: flash_prefill lse (f32 [b, h, s]) against the plain _fwd_scan and the "
        f"flash backward (kernel forward + torch backward) against autograd through the "
        f"plain version at {[(s, h, g, d) for _, s, _, h, g, d, _ in TRAIN_SHAPES]}, f32 "
        f"and bf16: max |lse err| {lse_err:.3e}, max ||dq,dk,dv err|| / ||ref|| "
        f"{bwd_err:.3e} (limits {BWD_REL})")
    return lse_err, bwd_err


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
    for dtype in (torch.float32, torch.bfloat16):
        # pages that are not a multiple of 16 elements (the scalar kernel),
        # and pools that start off the 16-byte grid (scalar) or on it (vector)
        for page, offset in (((5, 3), 0), ((4, 2, 33), 0), ((16, 2, 32), 1),
                             ((16, 2, 32), 16 // dtype.itemsize)):
            elems = int(torch.tensor(page).prod())
            src = torch.randint(-127, 128, (12, *page), generator=gen, device=dev,
                                dtype=torch.int8)
            pool = torch.randn(10 * elems + offset, generator=gen, device=dev).to(dtype)
            dst = pool[offset:].view(10, *page)
            keep = dst.clone()
            out = kv_pull_dequant(src, dst, sid, did, scales)
            if not torch.equal(out, kv_pull_dequant_ref(src, keep, sid, did, scales)):
                raise AssertionError(f"kv_pull_dequant {dtype} pages {page} at element "
                                     f"{offset} of the pool: differs from the plain version")
        src, dst, sids, dids = yi_pull_inputs(gen, dev, dtype)
        yi_scales = torch.rand(sids.shape[0], generator=gen, device=dev) * 0.05
        out = kv_pull_dequant(src, dst.clone(), sids, dids, yi_scales)
        torch.cuda.synchronize()
        if not torch.equal(out, kv_pull_dequant_ref(src, dst.clone(), sids, dids, yi_scales)):
            raise AssertionError(f"kv_pull_dequant yi-9b pages -> {dtype}: differs from the "
                                 f"plain version")
    log("phase 2: kv_pull_dequant bit-equal on pages of 15 and 264 elements, on pools "
        "off and on the 16-byte grid, and on the yi-9b pull, into f32 and bf16")
    return 0.0


def ssd_inputs(gen, dev, b, s, nh, hd, ns, dtype=None, dt_fill=None, a=None):
    """The inputs of tests/test_kernels.py's ssd_scan cases, drawn on the card."""
    import torch

    x = (torch.randn(b, s, nh, hd, generator=gen, device=dev) * 0.5).to(dtype or torch.float32)
    if dt_fill is None:
        dt = torch.randn(b, s, nh, generator=gen, device=dev).abs() * 0.1 + 0.01
    else:
        dt = torch.full((b, s, nh), dt_fill, device=dev)
    if a is None:
        a = -(torch.randn(nh, generator=gen, device=dev).abs() + 0.5)
    B = torch.randn(b, s, ns, generator=gen, device=dev) * 0.3
    C = torch.randn(b, s, ns, generator=gen, device=dev) * 0.3
    d_skip = torch.randn(nh, generator=gen, device=dev)
    return x, dt, a, B, C, d_skip


def check_ssd_scan(gen, dev):
    import torch

    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    def case(b, s, nh, hd, ns, chunk, dtype=torch.float32, **kw):
        args = ssd_inputs(gen, dev, b, s, nh, hd, ns, dtype, **kw)
        y, st = ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        y_ref, st_ref = ssd_scan_ref(*args, chunk=chunk)
        tol = SSD_TOL[str(dtype).split(".")[1]]
        what = f"ssd_scan b={b} s={s} nh={nh} hd={hd} ns={ns} chunk={chunk} {dtype} {kw}"
        return max(close(y, y_ref, tol, what + " y"), close(st, st_ref, tol, what + " state"))

    for s, nh, hd, ns, chunk in ((128, 4, 32, 16, 32), (64, 2, 64, 128, 64),
                                 (96, 50, 64, 16, 32)):
        case(2, s, nh, hd, ns, chunk)
    a = torch.tensor([-0.01, -8.0], device=dev)  # decay extremes: finite (close checks)
    for dt_fill in (1e-3, 5.0):
        case(1, 64, 2, 16, 8, 16, dt_fill=dt_fill, a=a)
    mamba = (MAMBA["nh"], MAMBA["hd"], MAMBA["ns"])
    hymba = (HYMBA["nh"], HYMBA["hd"], HYMBA["ns"])
    err = 0.0
    for s in PROMPTS:
        e = case(1, s, *mamba, 128)
        if not e <= SSD_F32_MAMBA2:
            raise AssertionError(f"ssd_scan mamba2-780m s={s} f32: max |err| {e} above "
                                 f"{SSD_F32_MAMBA2}")
        err = max(err, e)
    long_hymba = HYMBA_PROMPTS[-1] + HYMBA["meta"]
    for s in (HYMBA_PROMPTS[0] + HYMBA["meta"], long_hymba):
        err = max(err, case(1, s, *hymba, 128))
    case(1, max(PROMPTS), *mamba, 128, torch.bfloat16)
    # one row, a chunk less one, one chunk, one row more; hymba's 21 chunks
    for dtype in (torch.float32, torch.bfloat16):
        for s in (1, 63, 64, 65):
            case(1, s, *mamba, 128, dtype)
        case(1, long_hymba, *hymba, 128, dtype)
    log(f"phase 2: ssd_scan f32 max |err| at the full mamba2-780m / hymba-1.5b prompts "
        f"{err:.3e} (mamba2 limit {SSD_F32_MAMBA2}); s = 1, 63, 64, 65, {long_hymba} in f32 "
        f"and bf16 x")
    return err


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
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    return {"paged_attention": paged_attention, "flash_prefill": flash_prefill,
            "kv_pull": kv_pull, "kv_pull_dequant": kv_pull_dequant, "ssd_scan": ssd_scan}


def read_counts():
    return {name: op.launches for name, op in kernel_ops().items()}


def reset_counts():
    for op in kernel_ops().values():
        op.launches = 0


def expect_launches(path, got, n_layers, prompts, decode_steps, quantized):
    """Fail unless ``path`` (a run whose counts were zeroed just before it)
    went through the kernels it must use: flash_prefill once per layer and
    prompt, paged_attention once per layer and decode step, kv_pull (plain
    reads) or kv_pull_dequant (quantized reads) at least once, and never
    ssd_scan (Yi-9B has no SSM)."""
    want = {"flash_prefill": n_layers * prompts, "paged_attention": n_layers * decode_steps,
            "ssd_scan": 0}
    bad = [f"{k} {got[k]} != {v}" for k, v in want.items() if got[k] != v]
    if quantized and got["kv_pull_dequant"] <= 0:
        bad.append("kv_pull_dequant never launched")
    if not quantized and (got["kv_pull"] <= 0 or got["kv_pull_dequant"] != 0):
        bad.append(f"kv_pull {got['kv_pull']}, kv_pull_dequant {got['kv_pull_dequant']}")
    if bad:
        raise AssertionError(f"{path}: launches {got}: {'; '.join(bad)}")
    log(f"{path}: launches {got}")
    return got


def phase_serve(model, params, prompts, refs, arch="yi-9b", tags=("phase 3", "phase 4")):
    """Phases 3 and 4 (``tags``: phase 8 for granite-moe-3b-a800m), each
    run a path of its own.  Returns (the launch counts of the two
    launch.serve runs, launches per request of the direct one-at-a-time
    run, and for kv_pull_dequant of the quantized direct run)."""
    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.serving.disagg import DisaggService

    n_layers = model.cfg.num_layers
    t_serve, t_direct = tags
    serve_args = ["--arch", arch, "--requests", "3", "--prompt-len", "96",
                  "--max-new", str(MAX_NEW)]
    serve_counts = {}
    for quantized in (False, True):
        path = "launch.serve" + (" --quantize-transfer" if quantized else "")
        reset_counts()
        t0 = time.perf_counter()
        serve.main(serve_args + (["--quantize-transfer"] if quantized else []))
        torch.cuda.synchronize()
        log(f"{t_serve}: {path} {arch}, 3 requests in {time.perf_counter() - t0:.1f}s")
        serve_counts[quantized] = expect_launches(
            f"{t_serve}: {path}", read_counts(), n_layers, 3, 3 * MAX_NEW, quantized)

    svc = DisaggService(model, params, n_prefill=2, n_decode=1, num_blocks=256)
    reset_counts()
    t0 = time.perf_counter()
    for tokens, ref in zip(prompts, refs):
        h = svc.submit(tokens)
        got = svc.generate(h, max_new=MAX_NEW)
        if got != ref:
            raise AssertionError(f"{len(tokens)}-token prompt: disaggregated {got} "
                                 f"!= monolithic {ref}")
        log(f"{t_direct}: {len(tokens)}-token prompt via {h.request.prefill_worker}: "
            f"tokens {got} == monolithic; pulled {h.metrics.kv_bytes_pulled} B")
    torch.cuda.synchronize()
    seq = expect_launches(f"{t_direct}: one at a time", read_counts(), n_layers,
                          len(prompts), len(prompts) * MAX_NEW, False)
    per_request = {k: n / len(prompts) for k, n in seq.items()}
    log(f"{t_direct}: 3 requests disaggregated in {time.perf_counter() - t0:.1f}s")

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
    expect_launches(f"{t_direct}: together at b = 3", read_counts(), n_layers, len(prompts),
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
    log(f"{t_direct}: together at b = 3 (slots {slots}): every stream equals the "
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
        raise AssertionError(f"{t_direct}: quantized: launches {got}")
    log(f"{t_direct}: quantized: launches {got}")
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
    log(f"{t_direct}: quantized transfer: {stats.reads_posted} reads, "
        f"{stats.bytes_moved} wire bytes = reads x ({block}/2+4); tokens agreeing "
        f"with full precision per request {agree}/{MAX_NEW + 1}")
    del svc, hs
    return serve_counts, per_request


def phase_topology(model, params):
    """Phase 3b: Yi-9B served through ``launch.serve --topology
    hetero_rack:0`` (roles planned over a generated heterogeneous rack,
    pools sized by each machine's VRAM, links priced in the router); every
    request's tokens must equal a monolithic run on the same weights (the
    launcher's weights are this model's: seed 0 on the same card).
    Returns the run's launch counts."""
    import numpy as np
    import torch

    from repro_torch.launch import serve

    cfg = model.cfg
    rng = np.random.default_rng(0)  # the launcher's prompts, drawn the same way
    shared = rng.integers(0, cfg.vocab_size, 0).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 96).astype(np.int32)])
               for _ in range(3)]
    reset_counts()
    t0 = time.perf_counter()
    outs = serve.main(["--arch", "yi-9b", "--requests", "3", "--prompt-len", "96",
                       "--max-new", str(MAX_NEW), "--topology", "hetero_rack:0"])
    torch.cuda.synchronize()
    counts = expect_launches("phase 3b: launch.serve --topology hetero_rack:0", read_counts(),
                             cfg.num_layers, 3, 3 * MAX_NEW, False)
    for tokens, got in zip(prompts, outs):
        ref = monolithic_generate(model, params, tokens, MAX_NEW)
        if got != ref:
            raise AssertionError(f"phase 3b: topology-bound {got} != monolithic {ref}")
    log(f"phase 3b: 3 requests through the topology-bound service in "
        f"{time.perf_counter() - t0:.1f}s; tokens equal the monolithic ones")
    return counts


# --------------------------------------------------------- phases 6-7
def expect_counts(path, got, exact, at_least=None):
    """Fail unless ``path``'s launch counts (zeroed just before it) equal
    ``exact`` and reach ``at_least``, kernel by kernel."""
    bad = [f"{k} {got[k]} != {v}" for k, v in exact.items() if got[k] != v]
    bad += [f"{k} {got[k]} < {v}" for k, v in (at_least or {}).items() if got[k] < v]
    if bad:
        raise AssertionError(f"{path}: launches {got}: {'; '.join(bad)}")
    log(f"{path}: launches {got}")
    return got


def decode_greedy(serve_step, params, state, tok, n):
    """``n`` serve steps from (state, first tokens [b]) -> b token lists."""
    out = [[int(x)] for x in tok.tolist()]
    for _ in range(n):
        tok, state = serve_step(params, state, tok)
        for seq, x in zip(out, tok.tolist()):
            seq.append(int(x))
    return out


def steps_generate(model, params, prompts, n):
    """Monolithic runs through launch.steps, one prompt at a time ->
    (token lists, first tokens, prefill states)."""
    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.transformer import stack_states

    prefill_step, serve_step = make_prefill_step(model), make_serve_step(model)
    outs, firsts, states = [], [], []
    for t in prompts:
        tok, state = prefill_step(params, {"tokens": torch.as_tensor(t[None])})
        firsts.append(tok)
        states.append(state)
        # decode from a copy: decode steps write rings in place
        outs.append(decode_greedy(serve_step, params, stack_states([state]), tok, n)[0])
    return outs, firsts, states


def cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def consistency_f32(model, p32, tokens, what, extra=None):
    """prefill(p) + decode_step(t) against prefill(p + t), weights ``p32``
    in f32 (``extra``: the batch's other inputs, whisper's frames): the
    contract of tests/test_model_correctness.py:169-187."""
    import torch

    toks = torch.as_tensor(tokens[None])
    extra = extra or {}
    ref, _ = model.prefill(p32, {"tokens": toks, **extra})
    _, state = model.prefill(p32, {"tokens": toks[:, :-1], **extra})
    out, _ = model.decode_step(p32, state, toks[:, -1])
    torch.cuda.synchronize()
    diff = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not torch.isfinite(out).all() or diff > CONSISTENCY_TOL:
        raise AssertionError(f"{what}: f32 prefill+decode vs prefill max |diff| {diff} "
                             f"above {CONSISTENCY_TOL}")
    log(f"{what}: f32 prefill({len(tokens) - 1}) + decode_step vs prefill({len(tokens)}): "
        f"max |diff| {diff:.3g} (max |logit| {scale:.3g}, tolerance {CONSISTENCY_TOL})")
    return diff


def batch_f32(model, p32, prompts, n, what):
    """Each sequence decoded in one batch (b = len(prompts), mixed
    positions) against its own b = 1 run, weights ``p32`` in f32: n steps
    fed the b = 1 greedy tokens, every step's logits within
    CONSISTENCY_TOL."""
    import torch

    from repro_torch.models.transformer import stack_states

    states, singles, fed = [], [], []
    for t in prompts:
        logits, st = model.prefill(p32, {"tokens": torch.as_tensor(t[None])})
        states.append(st)
        st = stack_states([st])  # decode from a copy: steps write rings in place
        rows, toks = [], []
        for _ in range(n):
            tok = torch.argmax(logits[:, : model.cfg.vocab_size], dim=-1).to(torch.int32)
            toks.append(tok)
            logits, st = model.decode_step(p32, st, tok)
            rows.append(logits[0])
        singles.append(rows)
        fed.append(toks)
    state, diff = stack_states(states), 0.0
    for step in range(n):
        logits, state = model.decode_step(p32, state, torch.cat([f[step] for f in fed]))
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{what}: b = {len(prompts)} step {step}: non-finite logits")
        for i, rows in enumerate(singles):
            diff = max(diff, float((logits[i] - rows[step]).abs().max()))
    torch.cuda.synchronize()
    if diff > CONSISTENCY_TOL:
        raise AssertionError(f"{what}: f32 b = {len(prompts)} vs b = 1 decode logits max "
                             f"|diff| {diff} above {CONSISTENCY_TOL}")
    log(f"{what}: f32 decode at b = {len(prompts)} vs each b = 1 run, {n} steps: max |diff| "
        f"{diff:.3g} (tolerance {CONSISTENCY_TOL})")
    return diff


class StateLink:
    """A prefill and a decode worker's f32 ``SlotCache``s on the card, joined
    by a connection and a transfer engine, as tests/test_pull_push.py:133-159
    composes them.  One slot per request and layer: the SSD state
    flattened, then the conv tail cast to f32 (a bf16 slot would round the
    f32 SSD state)."""

    def __init__(self, cfg, n_slots, dev):
        import torch

        from repro_torch.core.connection import (
            ChipInfo, ConnectionManager, DescriptorRegistry, WorkerInfo)
        from repro_torch.core.transfer_engine import TransferEngine
        from repro_torch.models.ssm import ssm_slot_elems
        from repro_torch.serving.kv_cache import SlotCache

        self.cfg = cfg
        elems = ssm_slot_elems(cfg)
        kw = dict(num_layers=cfg.num_layers, num_slots=n_slots, state_elems=elems,
                  dtype=torch.float32, device=dev)
        self.pre = SlotCache("p0", base_address=0x10_0000_0000, **kw)
        self.dec = SlotCache("d0", base_address=0x20_0000_0000, **kw)
        self.engine = TransferEngine()
        self.engine.register_memory(self.pre.memory_region())
        self.engine.register_memory(self.dec.memory_region())
        reg = DescriptorRegistry("p0")
        for d in self.pre.descriptors():
            reg.register(d)

        def info(wid, role):
            return WorkerInfo(wid, role, "10.0.0.1", (ChipInfo(0, f"ici://{wid}/0"),))

        self.conn = ConnectionManager(info("d0", "decode")).connect(info("p0", "prefill"), reg)
        self.slot_nbytes = elems * 4

    def park(self, state, slot):
        """The prefill side writes one request's state (b = 1) into ``slot``."""
        from repro_torch.models.ssm import pack_ssm_slot

        for layer in range(self.pre.num_layers):
            self.pre.write_slot(layer, slot, pack_ssm_slot(state.ssd_state[layer, 0],
                                                           state.conv_state[layer, 0]))

    def pull(self, request_id, prompt_len, remote_slot, local_slot):
        """pull_state into the decode cache; returns the bytes moved."""
        from repro_torch.core.pull_push import pull_state
        from repro_torch.serving.request import Request

        before = self.engine.stats.bytes_moved
        pull_state(Request(request_id, prompt_len=prompt_len, max_new_tokens=MAX_NEW),
                   conn=self.conn, engine=self.engine, decode_cache=self.dec,
                   remote_slot=remote_slot, local_slot=local_slot)
        return self.engine.stats.bytes_moved - before

    def state(self, slots, context_lens, conv_dtype):
        """The decode side rebuilds a DecodeState (b = len(slots)) from its slots."""
        import torch

        from repro_torch.models.ssm import unpack_ssm_slots
        from repro_torch.models.transformer import DecodeState

        ssd, conv = [], []
        for layer in range(self.dec.num_layers):
            rows = torch.stack([self.dec.read_slot(layer, s) for s in slots])
            layer_ssd, layer_conv = unpack_ssm_slots(rows, self.cfg, conv_dtype)
            ssd.append(layer_ssd)
            conv.append(layer_conv)
        return DecodeState(
            context_lens=torch.tensor(context_lens, dtype=torch.int32, device=rows.device),
            ssd_state=torch.stack(ssd), conv_state=torch.stack(conv))


def phase_mamba2(dev):
    """Phase 6.  Returns (launch counts of the disaggregated run, launches
    per request, bytes pulled per request)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import stack_states

    cfg = get_config("mamba2-780m")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    log(f"phase 6: {cfg.describe()}; weights in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPTS]
    L, n = cfg.num_layers, len(prompts)
    quiet = {"flash_prefill": 0, "paged_attention": 0, "kv_pull_dequant": 0}

    reset_counts()
    t0 = time.perf_counter()
    refs, firsts, states = steps_generate(model, params, prompts, MAX_NEW)
    torch.cuda.synchronize()
    expect_counts("phase 6: monolithic", read_counts(),
                  {"ssd_scan": L * n, "kv_pull": 0, **quiet})
    log(f"phase 6: monolithic, {n} prompts in {time.perf_counter() - t0:.1f}s")

    prefill_step, serve_step = make_prefill_step(model), make_serve_step(model)
    link = StateLink(cfg, n_slots=4, dev=dev)
    local = [(i + 1) % 4 for i in range(n)]  # the decode side's slots differ
    reset_counts()
    t0 = time.perf_counter()
    pulled = []
    for i, (tokens, ref) in enumerate(zip(prompts, refs)):
        tok, state = prefill_step(params, {"tokens": torch.as_tensor(tokens[None])})
        link.park(state, slot=i)
        moved = link.pull(f"r{i}", len(tokens), remote_slot=i, local_slot=local[i])
        want = L * link.slot_nbytes
        if moved != want:
            raise AssertionError(f"phase 6: pulled {moved} B != {L} x {link.slot_nbytes}")
        landed = link.state([local[i]], [len(tokens)], state.conv_state.dtype)
        if not (torch.equal(landed.ssd_state, state.ssd_state)
                and torch.equal(landed.conv_state, state.conv_state)):
            raise AssertionError("phase 6: the pulled state differs from the prefill state")
        got = decode_greedy(serve_step, params, landed, tok, MAX_NEW)[0]
        if got != ref:
            raise AssertionError(f"phase 6: {len(tokens)}-token prompt: disaggregated "
                                 f"{got} != monolithic {ref}")
        pulled.append(moved)
        log(f"phase 6: {len(tokens)}-token prompt: slot {i} -> slot {local[i]}, pulled "
            f"{moved} B; tokens {got} == monolithic")
    torch.cuda.synchronize()
    counts = expect_counts("phase 6: disaggregated", read_counts(),
                           {"ssd_scan": L * n, **quiet}, at_least={"kv_pull": n})
    log(f"phase 6: {n} requests disaggregated in {time.perf_counter() - t0:.1f}s; engine "
        f"{link.engine.stats.txns_submitted} reads, {link.engine.stats.bytes_moved} B")

    # all three decode together from the pulled slots vs monolithic b = 3
    reset_counts()
    together = decode_greedy(serve_step, params,
                             link.state(local, [len(t) for t in prompts], torch.bfloat16),
                             torch.cat(firsts), MAX_NEW)
    expect_counts("phase 6: together at b = 3 from the pulled slots", read_counts(),
                  {"ssd_scan": 0, "kv_pull": 0, **quiet})
    mono3 = decode_greedy(serve_step, params, stack_states(states), torch.cat(firsts),
                          MAX_NEW)
    if together != mono3:
        raise AssertionError(f"phase 6: b = 3 disaggregated {together} != monolithic {mono3}")
    same_b1 = sum(a == b for a, b in zip(together, refs))
    log(f"phase 6: together at b = 3: every stream equals the monolithic b = 3 stream; "
        f"{same_b1}/{n} also equal the b = 1 streams")
    consistency_f32(model, cast_tree(params, torch.float32), prompts[-1],
                    "phase 6: mamba2-780m")
    per_request = {k: v / n for k, v in counts.items()}
    return counts, per_request, pulled[0]


def phase_hymba():
    """Phase 7.  Returns the launch counts of the monolithic run."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import stack_states

    cfg = get_config("hymba-1.5b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    log(f"phase 7: {cfg.describe()}; weights in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in HYMBA_PROMPTS]
    L, n = cfg.num_layers, len(prompts)
    reset_counts()
    t0 = time.perf_counter()
    refs, firsts, states = steps_generate(model, params, prompts, MAX_NEW)
    torch.cuda.synchronize()
    counts = expect_counts("phase 7: monolithic", read_counts(), {
        "flash_prefill": L * n, "ssd_scan": L * n, "paged_attention": 0, "kv_pull": 0,
        "kv_pull_dequant": 0})
    log(f"phase 7: {n} prompts in {time.perf_counter() - t0:.1f}s")
    cap = HYMBA["window"] + model.BLOCK_SIZE
    for tokens, st, ref in zip(prompts, states, refs):
        if st.ring_k.shape[2] != cap or st.meta_k.shape[2] != HYMBA["meta"]:
            raise AssertionError(f"phase 7: ring {tuple(st.ring_k.shape)}, meta "
                                 f"{tuple(st.meta_k.shape)}")
        filled = int((st.ring_pos >= 0).sum())
        if filled != min(cap, len(tokens)):
            raise AssertionError(f"phase 7: {filled} ring slots filled, want "
                                 f"{min(cap, len(tokens))}")
        if any(not 0 <= t < cfg.vocab_size for t in ref):
            raise AssertionError(f"phase 7: token out of range in {ref}")
        log(f"phase 7: {len(tokens)}-token prompt (+{HYMBA['meta']} meta): ring "
            f"{filled}/{cap} slots, tokens {ref}")
    together = decode_greedy(make_serve_step(model), params, stack_states(states),
                             torch.cat(firsts), MAX_NEW)
    if any(len(t) != MAX_NEW + 1 or not all(0 <= x < cfg.vocab_size for x in t)
           for t in together):
        raise AssertionError(f"phase 7: b = 3 streams {together}")
    same_b1 = sum(a == b for a, b in zip(together, refs))
    log(f"phase 7: together at b = 3 (mixed positions in one ring batch), bf16: {same_b1}/{n} "
        f"streams equal the b = 1 streams (logged; the f32 check below asserts)")
    p32 = cast_tree(params, torch.float32)
    batch_f32(model, p32, prompts, MAX_NEW, "phase 7: hymba-1.5b")
    consistency_f32(model, p32, prompts[-1], "phase 7: hymba-1.5b")
    return counts


# -------------------------------------------------------- phases 8-10
def free_model():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_moe(dev):
    """Phase 8: granite-moe-3b-a800m served through launch.serve and a
    DisaggService exactly as Yi-9B in phases 3-4 (its tokens equal to
    monolithic runs, one at a time and all three at b = 3 in the same row
    order), then llama4-maverick-400b-a17b at full width cut to one group
    of two layers.  Returns (granite's launch.serve counts, its launches
    per request, maverick's counts)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import build_model

    cfg = get_config("granite-moe-3b-a800m")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    log(f"phase 8: {cfg.describe()}; experts padded {cfg.num_experts} -> "
        f"{cfg.padded_experts}; weights in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPTS]
    refs = [monolithic_generate(model, params, t, MAX_NEW) for t in prompts]
    serve_counts, per_request = phase_serve(model, params, prompts, refs,
                                            arch="granite-moe-3b-a800m",
                                            tags=("phase 8", "phase 8"))
    del params, model
    free_model()

    # llama4-maverick: one group = one dense layer (d_ff 16384) and one MoE
    # layer (128 experts top-1 and the shared expert)
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b"),
                              num_layers=get_config("llama4-maverick-400b-a17b").moe_every)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    log(f"phase 8: {cfg.describe()} (depth cut 48 -> {cfg.num_layers}); "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card; weights in "
        f"{time.perf_counter() - t0:.1f}s")
    tokens = rng.integers(0, cfg.vocab_size, MAVERICK["prompt"]).astype(np.int32)
    reset_counts()
    tok, state = make_prefill_step(model)(params, {"tokens": torch.as_tensor(tokens[None])})
    out = decode_greedy(make_serve_step(model), params, state, tok, MAX_NEW)[0]
    torch.cuda.synchronize()
    L = cfg.num_layers
    maverick = expect_counts("phase 8: llama4-maverick 96 tokens + 8", read_counts(), {
        "flash_prefill": L, "paged_attention": L * MAX_NEW, "kv_pull": 0,
        "kv_pull_dequant": 0, "ssd_scan": 0})
    if len(out) != MAX_NEW + 1 or not all(0 <= x < cfg.vocab_size for x in out):
        raise AssertionError(f"phase 8: llama4-maverick tokens {out}")
    log(f"phase 8: llama4-maverick tokens {out}")
    del params, model, state
    free_model()
    return serve_counts, per_request, maverick


def phase_llava(dev):
    """Phase 9: llava-next-mistral-7b at full width, 2880 seeded image
    embeddings ahead of text prompts of 96 and 130 tokens, through
    launch.steps; each prompt's pages parked in a PagedKVCache, pulled
    with pull_kv (kv_pull on the card) and decoded from there: the tokens
    must equal the monolithic ones.  Returns (launch counts of the run,
    bytes pulled per request)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import build_model
    from repro_torch.serving.kv_link import KVLink

    cfg = get_config("llava-next-mistral-7b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    log(f"phase 9: {cfg.describe()}; weights in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(2)
    gen = torch.Generator(device=dev).manual_seed(2)
    prefill_step, serve_step = make_prefill_step(model), make_serve_step(model)
    link = KVLink(cfg, num_blocks=128, dtype=torch.bfloat16, device=dev)
    L, n = cfg.num_layers, len(LLAVA_PROMPTS)
    reset_counts()
    t0 = time.perf_counter()
    pulled = []
    for i, text in enumerate(LLAVA_PROMPTS):
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, text))),
                 "vision_embeds": torch.randn(1, cfg.vision_tokens, cfg.d_model, generator=gen,
                                              device=dev) * 0.02}
        tok, state = prefill_step(params, batch)
        n_ctx = int(state.context_lens[0])
        if n_ctx != cfg.vision_tokens + text:
            raise AssertionError(f"phase 9: context {n_ctx} != {cfg.vision_tokens} + {text}")
        snapshot = dataclasses.replace(state, k_pages=state.k_pages.clone(),
                                       v_pages=state.v_pages.clone())
        mono = decode_greedy(serve_step, params, state, tok, MAX_NEW)[0]
        del state
        n_pages = -(-n_ctx // model.BLOCK_SIZE)
        blocks = [(7 + 3 * j) % 128 for j in range(n_pages)]  # scattered, distinct
        landed, moved = link.pull(f"r{i}", snapshot, blocks, MAX_NEW)
        want = L * n_pages * 2 * link.dec.block_nbytes
        if moved != want or not torch.equal(landed.k_pages, snapshot.k_pages) \
                or not torch.equal(landed.v_pages, snapshot.v_pages):
            raise AssertionError(f"phase 9: pulled {moved} B (want {want}) or pages differ")
        got = decode_greedy(serve_step, params, landed, tok, MAX_NEW)[0]
        if got != mono:
            raise AssertionError(f"phase 9: {text}-token prompt: pulled {got} != monolithic "
                                 f"{mono}")
        pulled.append(moved)
        log(f"phase 9: {cfg.vision_tokens} image + {text} text tokens = {n_pages} pages a "
            f"layer, pulled {moved} B; tokens {got} == monolithic")
        del snapshot, landed
    torch.cuda.synchronize()
    counts = expect_counts("phase 9: llava prefill, pull, decode", read_counts(), {
        "flash_prefill": L * n, "paged_attention": 2 * L * MAX_NEW * n, "kv_pull": n,
        "kv_pull_dequant": 0, "ssd_scan": 0})
    log(f"phase 9: {n} requests in {time.perf_counter() - t0:.1f}s")
    del params, model, link
    free_model()
    return counts, pulled


def phase_whisper(dev):
    """Phase 10: whisper-large-v3 at full width (32 + 32 layers) over 1500
    seeded frames, decoder prompts of 4, 33 and 130 tokens, 8 new tokens
    each, through launch.steps; then with the weights in f32,
    prefill(p) + decode_step(t) against prefill(p + t).  Returns the launch
    counts of the bf16 run."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import build_model

    cfg = get_config("whisper-large-v3")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    log(f"phase 10: {cfg.describe()} + {cfg.encoder_layers} encoder layers; weights in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(3)
    frames = torch.randn(1, cfg.encoder_seq, cfg.d_model,
                         generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in WHISPER_PROMPTS]
    prefill_step, serve_step = make_prefill_step(model), make_serve_step(model)
    L, n = cfg.num_layers, len(prompts)
    reset_counts()
    t0 = time.perf_counter()
    for tokens in prompts:
        tok, state = prefill_step(params, {"frames": frames,
                                           "tokens": torch.as_tensor(tokens[None])})
        if tuple(state.cross_k.shape) != (L, 1, cfg.encoder_seq, cfg.num_kv_heads,
                                          cfg.head_dim):
            raise AssertionError(f"phase 10: cross_k {tuple(state.cross_k.shape)}")
        out = decode_greedy(serve_step, params, state, tok, MAX_NEW)[0]
        if len(out) != MAX_NEW + 1 or not all(0 <= x < cfg.vocab_size for x in out):
            raise AssertionError(f"phase 10: tokens {out}")
        log(f"phase 10: {len(tokens)}-token prompt over {cfg.encoder_seq} frames: tokens {out}")
    torch.cuda.synchronize()
    enc_and_dec = cfg.encoder_layers + 2 * L  # encoder, decoder self and cross
    counts = expect_counts("phase 10: whisper", read_counts(), {
        "flash_prefill": n * (enc_and_dec + L * MAX_NEW), "paged_attention": n * L * MAX_NEW,
        "kv_pull": 0, "kv_pull_dequant": 0, "ssd_scan": 0})
    log(f"phase 10: {n} prompts in {time.perf_counter() - t0:.1f}s")
    p32 = cast_tree(params, torch.float32)
    del params
    consistency_f32(model, p32, prompts[1], "phase 10: whisper-large-v3",
                    extra={"frames": frames})
    del p32, model
    free_model()
    return counts


# ------------------------------------------------------------ phase 11
def phase_train_granite(card):
    """Phase 11a: granite-moe-3b-a800m at its full config (32 layers, all
    48 padded experts) through ``launch.train``, 6 steps: losses finite and
    falling, flash_prefill exactly layers x steps x 2 (remat).  Then the
    checkpoint and restart, at the full width cut to GRANITE_CKPT_LAYERS
    layers (the full train state's checkpoint, 55.7 GB, is more than a
    card machine may write to its disk in one run, 45 GiB): 6 steps
    uninterrupted; 3 steps with a checkpoint at step 3 and a ``--resume``
    run of the other 3 (warmup is 10 steps, so the first steps' learning
    rates do not depend on ``--steps``).  The resumed losses must equal
    the uninterrupted run's bit for bit.  Returns the full run's launch
    counts and its numbers."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    arch = "granite-moe-3b-a800m"
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    full = train.main(GRANITE_TRAIN + ["--steps", "6"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    L = get_config(arch).num_layers
    counts = expect_counts(f"phase 11: launch.train {arch}, 6 steps", read_counts(), {
        "flash_prefill": L * 6 * 2, "paged_attention": 0, "kv_pull": 0, "kv_pull_dequant": 0,
        "ssd_scan": 0})  # remat: the forward runs twice a layer a step
    free_model()
    losses = full["losses"]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"phase 11: granite losses {losses}: not finite and falling")
    step_s = float(np.median(full["step_s"][1:]))
    tokens = 4 * 512
    log(f"phase 11: {arch} full config, batch 4 x 512, remat: losses {losses} (finite, "
        f"falling); step {step_s:.4f} s (median of steps 2-6; first {full['step_s'][0]:.4f} "
        f"s), {tokens / step_s:.0f} tokens/s, peak {peak / 1e9:.2f} GB allocated; {card}")

    cut = dataclasses.replace(get_config(arch), num_layers=GRANITE_CKPT_LAYERS)
    ckpt = ROOT / "build" / "ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    launcher_config = train.get_config
    train.get_config = lambda name: cut
    try:
        ref = train.main(GRANITE_TRAIN + ["--steps", "6"])["losses"]
        free_model()
        t0 = time.perf_counter()
        first = train.main(GRANITE_TRAIN + ["--steps", "3", "--ckpt-dir", str(ckpt),
                                            "--ckpt-every", "3"])["losses"]
        free_model()
        t_save = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
        t0 = time.perf_counter()
        rest = train.main(GRANITE_TRAIN + ["--steps", "6", "--ckpt-dir", str(ckpt),
                                           "--ckpt-every", "100", "--resume"])["losses"]
        free_model()
        t_resume = time.perf_counter() - t0
    finally:
        train.get_config = launcher_config
        shutil.rmtree(ckpt, ignore_errors=True)
    if first + rest != ref:
        raise AssertionError(f"phase 11: resumed losses {first + rest} != uninterrupted {ref}")
    log(f"phase 11: {arch} cut to {GRANITE_CKPT_LAYERS} layers: losses {ref}; 3 steps + "
        f"checkpoint ({ckpt_bytes / 1e9:.2f} GB, the run with its save {t_save:.1f} s) + "
        f"--resume (with its restore {t_resume:.1f} s) gave the same losses bit for bit")
    return counts, {"losses": losses, "step_s": step_s, "tokens_per_s": tokens / step_s,
                    "peak_gb": peak / 1e9, "checkpoint_gb": ckpt_bytes / 1e9}


def phase_train_yi(dev, card):
    """Phase 11b: Yi-9B at full width cut to YI_TRAIN_LAYERS layers, two
    make_train_step steps at s = TRAIN_SEQ, b = YI_TRAIN_BATCH (remat:
    flash_prefill exactly layers x steps x 2 times); then a 2-layer f32 cut
    of the same widths, one step through the kernel and one through the
    plain versions (flash_prefill's plain forward; the backward is plain
    torch either way) from the same state: loss within TRAIN_LOSS_RTOL and
    grad norm within TRAIN_GNORM_RTOL."""
    import dataclasses

    import numpy as np
    import torch

    import repro_torch.models.flash as flash_mod
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels.flash_prefill.ref import dense_ref
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=YI_TRAIN_LAYERS)
    ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=2)
    data = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, YI_TRAIN_BATCH)
    model = build_model(cfg)
    params = model.init_params(0)
    opt = adamw_init(params, ocfg)
    n_params = sum(p.numel() for p in leaves(params))
    state_gb = torch.cuda.memory_allocated() / 1e9
    step = make_train_step(model, ocfg, remat=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for _ in range(2):
        batch = {"tokens": torch.as_tensor(data.next_batch()["tokens"], device=dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    counts = expect_counts(
        f"phase 11: yi-9b {YI_TRAIN_LAYERS} layers, 2 train steps at s = {TRAIN_SEQ}",
        read_counts(), {"flash_prefill": YI_TRAIN_LAYERS * 2 * 2, "paged_attention": 0,
                        "kv_pull": 0, "kv_pull_dequant": 0, "ssd_scan": 0})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase 11: yi-9b cut losses {losses}")
    tokens = YI_TRAIN_BATCH * TRAIN_SEQ
    log(f"phase 11: {cfg.describe()} (depth cut 48 -> {YI_TRAIN_LAYERS}), "
        f"{n_params / 1e9:.3f}e9 params, train state {state_gb:.1f} GB before the first "
        f"step; batch {YI_TRAIN_BATCH} x {TRAIN_SEQ}: losses {losses}; step {times[1]:.4f} s "
        f"(first {times[0]:.4f} s), {tokens / times[1]:.0f} tokens/s, peak "
        f"{peak / 1e9:.2f} GB allocated; {card}")
    del params, opt, m, model, step
    free_model()

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    model = build_model(cfg2)
    batch = {"tokens": torch.as_tensor(data.next_batch()["tokens"][:1], device=dev)}
    out = {}
    kernel_fn = flash_mod.flash_prefill
    for route in ("kernel", "plain"):
        params = cast_tree(model.init_params(0), torch.float32)
        opt = adamw_init(params, ocfg)
        if route == "plain":
            flash_mod.flash_prefill = lambda q, k, v, **kw: dense_ref(q, k, v, **kw)
        reset_counts()
        try:
            _, _, m = make_train_step(model, ocfg, remat=True)(params, opt, batch)
        finally:
            flash_mod.flash_prefill = kernel_fn
        got = read_counts()["flash_prefill"]
        if got != (2 * 2 if route == "kernel" else 0):
            raise AssertionError(f"phase 11: f32 2-layer {route} step: flash_prefill {got}")
        out[route] = (float(m["loss"]), float(m["grad_norm"]))
        del params, opt, m
        free_model()
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    if abs(lk - lp) > TRAIN_LOSS_RTOL * abs(lp) or abs(gk - gp) > TRAIN_GNORM_RTOL * abs(gp):
        raise AssertionError(f"phase 11: f32 2-layer step kernel {out['kernel']} != plain "
                             f"{out['plain']}")
    log(f"phase 11: yi-9b widths, 2 layers, f32, 1 x {TRAIN_SEQ}: kernel step loss {lk!r} "
        f"grad norm {gk!r}; plain step loss {lp!r} grad norm {gp!r} (limits "
        f"{TRAIN_LOSS_RTOL} / {TRAIN_GNORM_RTOL} relative)")
    del model
    free_model()
    return counts, {"losses": losses, "step_s": times[1], "tokens_per_s": tokens / times[1],
                    "peak_gb": peak / 1e9, "state_gb": state_gb, "f32_kernel_vs_plain": out}


# ------------------------------------------------------------ phase 5
def time_ms(fn, iters=50, warmup=3):
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    replayed between two CUDA events, so that the host's cost of a call
    (Python, argument checks, the launch itself) does not count."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def call_ms(fn, iters=50, warmup=3):
    """Time of one call issued from Python, back to back: the device time or
    the host's cost of a call, whichever is larger.  The plain versions are
    timed so (some copy host values to the card, which a CUDA graph cannot
    capture), and each kernel is too, beside its device time."""
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


def bound_ms(nbytes, flops, peak=PEAK_BF16_FLOPS):
    return max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3, \
        ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak else "operations")


def ssd_flops(b, s, nh, hd, ns, chunk):
    """Operations the SSD scan needs at ``chunk`` over this run's rows (2
    per multiply-add).  B and C are shared by every head (one group), so a
    chunk of lc rows takes its lc(lc+1)/2 visible C.B dots (ns each) once;
    each head adds their decay factors (one multiply each), the scores'
    product with x (hd each), the prior state's read (lc x hd x ns) and
    the state update (hd x ns x lc).  Work the kernel repeats (the scores
    in every head and hd tile) is not counted."""
    total = 0
    for c0 in range(0, s, chunk):
        lc = min(chunk, s - c0)
        tri = lc * (lc + 1) // 2
        total += 2 * tri * ns + nh * (tri + 2 * tri * hd + 4 * lc * hd * ns)
    return b * total


def launch_us(fn, pattern, calls=20):
    """Device time of each kernel that ``fn`` launches, by name (the first
    match of ``pattern`` in the profiler's kernel name), in us a call:
    torch.profiler over ``calls`` calls.  None if the profiler shows no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        name = re.search(pattern, ev.key)
        us = getattr(ev, "device_time_total", 0)
        if name and us:
            out[name.group(0)] = out.get(name.group(0), 0.0) + us / calls
    return out or None


def ssd_time_row(gen, dev, s, nh, hd, ns, what):
    """ssd_scan's bound is the card's with tensor cores (TF32 at 495 TFLOP/s,
    the kernel's products); ``bound_f32_fma_ms`` keeps PR 12-13's figure at
    the f32 FMA rate of 67 TFLOP/s for the log line, so the rows compare."""
    from repro_torch.kernels.ssd_scan.ops import KERNEL_CHUNK, ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    x, dt, a, B, C, d_skip = ssd_inputs(gen, dev, 1, s, nh, hd, ns)
    nbytes = 2 * x.numel() * 4 + dt.numel() * 4 + 2 * B.numel() * 4 + 2 * nh * 4 \
        + nh * hd * ns * 4
    flops = ssd_flops(1, s, nh, hd, ns, KERNEL_CHUNK)
    return dict(
        ms=time_ms(lambda: ssd_scan(x, dt, a, B, C, d_skip)),
        call_ms=call_ms(lambda: ssd_scan(x, dt, a, B, C, d_skip)),
        plain_ms=call_ms(lambda: ssd_scan_ref(x, dt, a, B, C, d_skip)),
        library_ms=None,  # no single PyTorch call computes the SSD scan
        bound=bound_ms(nbytes, flops, PEAK_TF32_FLOPS),
        bound_f32_fma_ms=bound_ms(nbytes, flops, PEAK_F32_FLOPS)[0],
        launch_us=launch_us(lambda: ssd_scan(x, dt, a, B, C, d_skip), r"ssd_\w+_kernel"),
        shape=f"{what}: b=1 s={s} nh={nh} hd={hd} ns={ns} f32, chunk {KERNEL_CHUNK}; "
              f"bound at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32")


def paged_time_row(gen, dev, b, per, ctx_list, what, widths=YI):
    """paged_attention at ``widths`` (Yi-9B's by default) over ``ctx_list``
    tokens, bf16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.ops import paged_attention, partitions
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    h, g, d, bs = widths["h"], widths["g"], widths["d"], 32
    bf = torch.bfloat16
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
    pages, _ = partitions(b, g, h // g, per, sm_count(dev))
    paged_attention.last_grid = None
    row = dict(
        ms=time_ms(lambda: paged_attention(q, kp, vp, tables, ctx)),
        call_ms=call_ms(lambda: paged_attention(q, kp, vp, tables, ctx)),
        plain_ms=call_ms(lambda: paged_attention_ref(q, kp, vp, tables, ctx)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qf, kf, vf, attn_mask=mask)),
        bound=bound_ms(kv_read + 2 * q.numel() * 2 + tables.numel() * 4 + b * 4,
                       4 * h * d * sum(ctx_list)))
    grid = paged_attention.last_grid  # as the wrapper launched it in the timed calls
    row["grid"] = list(grid)
    row["blocks"] = grid[0] * grid[1] * grid[2]
    row["shape"] = (f"{what}: b={b} h={h} g={g} d={d} bs={bs} ctx={ctx_list} bf16; grid "
                    f"{grid[0]} x {grid[1]} x {grid[2]} partitions of {pages} pages = "
                    f"{row['blocks']} blocks")
    return row


def prefill_time_row(gen, dev, s, what, plain_iters=50, widths=YI, t=None, causal=True):
    """flash_prefill at ``widths`` (Yi-9B's by default), one layer's
    attention of s queries over t keys (t = s by default), bf16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import dense_ref

    h, g, d = widths["h"], widths["g"], widths["d"]
    t = s if t is None else t
    bf = torch.bfloat16
    qp = torch.randn(1, s, h, d, generator=gen, device=dev).to(bf)
    kk = torch.randn(1, t, g, d, generator=gen, device=dev).to(bf)
    vv = torch.randn(1, t, g, d, generator=gen, device=dev).to(bf)
    qs = qp.transpose(1, 2).contiguous()
    ks = kk.repeat_interleave(h // g, dim=2).transpose(1, 2).contiguous()
    vs = vv.repeat_interleave(h // g, dim=2).transpose(1, 2).contiguous()
    visible = s * (s + 1) // 2 if causal else s * t
    row = dict(
        ms=time_ms(lambda: flash_prefill(qp, kk, vv, causal=causal)),
        call_ms=call_ms(lambda: flash_prefill(qp, kk, vv, causal=causal)),
        plain_ms=call_ms(lambda: dense_ref(qp, kk, vv, causal=causal), iters=plain_iters,
                         warmup=min(3, plain_iters)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal)),
        bound=bound_ms((2 * qp.numel() + 2 * kk.numel()) * 2, 4 * h * d * visible),
        shape=f"{what}: b=1 s={s} t={t} h={h} g={g} d={d} "
              f"{'causal' if causal else 'non-causal'} bf16"
              + (f"; plain version timed over {plain_iters} calls" if plain_iters != 50 else ""))
    row["vs_library"] = row["ms"] / row["library_ms"]
    return row


def train_time_rows(gen, dev):
    """The training path's attention at Yi-9B widths and s = TRAIN_SEQ,
    bf16, one layer: flash_prefill's forward with its lse output (and
    without, the serving call), and the backward (plain torch after
    ``_bwd_scan``; no Pallas counterpart) from the saved (q, k, v, out,
    lse).  The backward's bound: 2.5x the forward's operations (dV, dP, dQ,
    dK and the recomputed S), its bytes q, k, v, out, dout, lse read and
    dq, dk, dv written.  Library calls: SDPA's forward, and its backward
    through autograd (K/V repeated to the heads outside the timing)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import dense_ref
    from repro_torch.models.flash import _Blocks, _bwd_scan, flash_forward_plain

    h, g, d, s = YI["h"], YI["g"], YI["d"], TRAIN_SEQ
    bf = torch.bfloat16
    q = torch.randn(1, s, h, d, generator=gen, device=dev).to(bf)
    k = torch.randn(1, s, g, d, generator=gen, device=dev).to(bf)
    v = torch.randn(1, s, g, d, generator=gen, device=dev).to(bf)
    dout = torch.randn(1, s, h, d, generator=gen, device=dev).to(bf)
    qs = q.transpose(1, 2).contiguous()
    ks = k.repeat_interleave(h // g, dim=2).transpose(1, 2).contiguous()
    vs = v.repeat_interleave(h // g, dim=2).transpose(1, 2).contiguous()
    flops = 4 * h * d * s * (s + 1) // 2
    io = 2 * (2 * q.numel() + 2 * k.numel())
    fwd = dict(
        ms=time_ms(lambda: flash_prefill(q, k, v, causal=True, return_lse=True)),
        ms_without_lse=time_ms(lambda: flash_prefill(q, k, v, causal=True)),
        call_ms=call_ms(lambda: flash_prefill(q, k, v, causal=True, return_lse=True)),
        plain_ms=call_ms(lambda: flash_forward_plain(q, k, v, causal=True), iters=5,
                         warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)),
        bound=bound_ms(io + 4 * h * s, flops),
        shape=f"yi-9b train forward with lse: b=1 s={s} h={h} g={g} d={d} causal bf16; "
              f"plain version (the _fwd_scan port, 1024-row blocks) over 5 calls")
    out, lse = flash_prefill(q, k, v, causal=True, return_lse=True)
    blk = _Blocks(q, k, True, 0, 0, 1024, 1024)
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    ref_out = dense_ref(qr, kr, vr, causal=True)
    qs, ks, vs = (x.requires_grad_(True) for x in (qs, ks, vs))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    dlib = dout.transpose(1, 2).contiguous()
    bwd_ms = call_ms(lambda: _bwd_scan(q, k, v, out, lse, dout, blk), iters=5, warmup=1)
    bwd = dict(
        ms=bwd_ms, call_ms=bwd_ms,
        plain_ms=call_ms(lambda: torch.autograd.grad(ref_out, (qr, kr, vr), dout,
                                                     retain_graph=True), iters=5, warmup=1),
        library_ms=call_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dlib,
                                                       retain_graph=True)),
        bound=bound_ms(2 * (2 * q.numel() + 2 * k.numel()) + 4 * h * s
                       + 2 * (q.numel() + 2 * k.numel()), 2.5 * flops),
        shape=f"yi-9b train backward (plain torch after _bwd_scan, f32 sums over 3 block "
              f"pairs of 1024; no Pallas counterpart): b=1 s={s} h={h} g={g} d={d} causal "
              f"bf16; timed from Python over 5 calls; plain = autograd through dense_ref; "
              f"library = SDPA's backward through autograd")
    return {"forward_lse": fwd, "backward": bwd}


def phase_times(gen, dev):
    rows = {}
    # paged_attention: the batched decode step over the three prompts
    rows["paged_attention"] = paged_time_row(gen, dev, 3, 11, [p + MAX_NEW for p in PROMPTS],
                                             "yi-9b decode at b = 3")
    if rows["paged_attention"]["blocks"] < 96:
        raise AssertionError(f"paged_attention at yi-9b b = 3 launched "
                             f"{rows['paged_attention']['grid']}: under 96 blocks")
    rows["paged_attention"]["also"] = [paged_time_row(
        gen, dev, 8, LONG_CTX // YI["bs"], [LONG_CTX] * 8, "long context")]
    # flash_prefill: the longest prompt's prefill attention, one layer
    rows["flash_prefill"] = prefill_time_row(gen, dev, max(PROMPTS), "yi-9b prefill")
    rows["flash_prefill"]["also"] = [prefill_time_row(gen, dev, LONG_PROMPT, "long prompt",
                                                      plain_iters=5)]
    # the shapes of phases 8-10: whisper's decode (b = 1, its longest prompt's
    # last step), encoder and cross-attention of a decode step; llava's
    # image + text prefill
    rows["paged_attention"]["also"].append(paged_time_row(
        gen, dev, 1, -(-max(WHISPER_PROMPTS) // 32) + 16, [max(WHISPER_PROMPTS) + MAX_NEW],
        "whisper-large-v3 decode", widths=WHISPER))
    frames = WHISPER["frames"]
    rows["flash_prefill"]["also"] += [
        prefill_time_row(gen, dev, frames, "whisper-large-v3 encoder", widths=WHISPER,
                         causal=False, plain_iters=5),
        prefill_time_row(gen, dev, 1, "whisper-large-v3 decode cross-attention",
                         widths=WHISPER, t=frames, causal=False),
        prefill_time_row(gen, dev, LLAVA["vision"] + LLAVA_PROMPTS[0],
                         "llava-next-mistral-7b image + text prefill", widths=LLAVA,
                         plain_iters=5)]
    rows["flash_prefill"]["training"] = train_time_rows(gen, dev)
    return rows | other_time_rows(gen, dev)


def other_time_rows(gen, dev):
    import torch

    from repro_torch.kernels.kv_pull.ops import kv_pull, kv_pull_dequant
    from repro_torch.kernels.kv_pull.ref import kv_pull_dequant_ref, kv_pull_ref

    bf = torch.bfloat16
    rows = {}

    # kv_pull: one 257-token request's pages, uint8 slab pages of 32 KiB
    src, dst, sids, dids = yi_pull_inputs(gen, dev)
    sl, dl = sids.long(), dids.long()
    n, page = sids.shape[0], src.shape[1]
    rows["kv_pull"] = dict(
        ms=time_ms(lambda: kv_pull(src, dst, sids, dids)),
        call_ms=call_ms(lambda: kv_pull(src, dst, sids, dids)),
        plain_ms=call_ms(lambda: kv_pull_ref(src, dst, sids, dids)),
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
        call_ms=call_ms(lambda: kv_pull_dequant(src, dst, sids, dids, scales)),
        plain_ms=call_ms(lambda: kv_pull_dequant_ref(src, dst, sids, dids, scales)),
        library_ms=time_ms(lambda: dst.index_copy_(
            0, dl, (src.float() * scales[:, None]).to(bf))),
        bound=bound_ms(n * elems * (1 + 2) + n * 12, n * elems),
        shape=f"{n} pages x {elems} int8 -> bf16")

    # ssd_scan: one layer's prefill scan, mamba2-780m's longest prompt, and
    # hymba-1.5b's longest prompt with its meta prefix
    rows["ssd_scan"] = ssd_time_row(gen, dev, max(PROMPTS), MAMBA["nh"], MAMBA["hd"],
                                    MAMBA["ns"], "mamba2-780m")
    rows["ssd_scan"]["also"] = [ssd_time_row(
        gen, dev, max(HYMBA_PROMPTS) + HYMBA["meta"], HYMBA["nh"], HYMBA["hd"],
        HYMBA["ns"], "hymba-1.5b")]
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
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:87"),
}


def fmt_ms(x):
    return "none" if x is None else f"{x:.4f} ms"


def timing(row):
    """A phase-5 row's numbers under the keys of the kernels line."""
    bms, by = row["bound"]
    extra = {k: row[k] for k in ("vs_library", "grid", "launch_us") if k in row}
    extra["call_ms"] = row["call_ms"]
    return {"ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": row["library_ms"], "shape": row["shape"], **extra}


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
    t_start = time.perf_counter()
    card = gpu_line()
    log(f"GPU: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {
        "paged_attention": check_paged_attention(gen, dev),
        "flash_prefill": check_flash_prefill(gen, dev),
        "kv_pull": check_kv_pull(gen, dev),
        "kv_pull_dequant": check_kv_pull_dequant(gen, dev),
        "ssd_scan": check_ssd_scan(gen, dev),
    }
    lse_err, bwd_err = check_flash_training(gen, dev)
    log(f"phase 2: every kernel matches its plain version; max |err| at full width "
        f"(bf16 for the attention kernels, f32 for ssd_scan) {errs}; "
        f"{time.perf_counter() - t0:.1f}s")

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
    topo_counts = phase_topology(model, params)
    del params, model
    torch.cuda.empty_cache()
    log(f"phases 3-4: {time.perf_counter() - t0:.1f}s with the weights and references")

    t0 = time.perf_counter()
    mamba_counts, mamba_per_request, pulled = phase_mamba2(dev)
    torch.cuda.empty_cache()
    log(f"phase 6: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    hymba_counts = phase_hymba()
    torch.cuda.empty_cache()
    log(f"phase 7: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    moe_serve, moe_per_request, maverick_counts = phase_moe(dev)
    log(f"phase 8: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    llava_counts, llava_pulled = phase_llava(dev)
    log(f"phase 9: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    whisper_counts = phase_whisper(dev)
    log(f"phase 10: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    granite_train_counts, granite_train = phase_train_granite(card)
    yi_train_counts, yi_train = phase_train_yi(dev, card)
    log(f"phase 11: {time.perf_counter() - t0:.1f}s")
    # each kernel's launches in the new phases' runs, per request where the
    # run served several
    later = {
        "phase 8 granite-moe launch.serve": moe_serve[False],
        "phase 8 granite-moe launch.serve --quantize-transfer": moe_serve[True],
        "phase 8 granite-moe per request (direct)": moe_per_request,
        "phase 8 llama4-maverick (2 layers), 96 tokens + 8": maverick_counts,
        "phase 9 llava, 2 requests": llava_counts,
        "phase 10 whisper, 3 prompts + 8 tokens each": whisper_counts,
        "phase 3b yi-9b launch.serve --topology hetero_rack:0": topo_counts,
        "phase 11 granite-moe launch.train, 6 steps": granite_train_counts,
        f"phase 11 yi-9b {YI_TRAIN_LAYERS} layers, 2 train steps": yi_train_counts,
    }

    t0 = time.perf_counter()
    rows = phase_times(gen, dev)
    log(f"phase 5: timed in {time.perf_counter() - t0:.1f}s")
    kernels = []
    for name, row in rows.items():
        src, replaces = SOURCES[name]
        extra = {"also": [timing(r) for r in row["also"]]} if "also" in row else {}
        if name == "ssd_scan":
            launches, run = mamba_counts[name], "phase 6: mamba2-780m disaggregated"
            per = mamba_per_request[name]
            extra |= {"launches_hymba": hymba_counts[name], "bytes_pulled_per_request": pulled}
        else:
            quantized = name == "kv_pull_dequant"
            launches = serve_counts[quantized][name]
            run = "launch.serve" + (" --quantize-transfer" if quantized else "")
            per = per_request[name]
        extra["launches_later_phases"] = {run: c[name] for run, c in later.items()}
        if name == "kv_pull":
            extra["bytes_pulled_llava"] = llava_pulled
        if name == "flash_prefill":
            tr = row["training"]
            extra["training"] = {
                "forward_lse": timing(tr["forward_lse"])
                | {"ms_without_lse": tr["forward_lse"]["ms_without_lse"],
                   "lse_max_abs_err": lse_err},
                "backward": timing(tr["backward"]) | {"max_rel_err": bwd_err}}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "launches_run": run, "launches_per_request": per,
            "max_abs_err": errs[name], **timing(row), **extra})
        for raw in [row] + row.get("also", []):
            r = timing(raw)
            log(f"phase 5: {name} [{r['shape']}]: {r['ms']:.4f} ms on the device "
                f"({r['call_ms']:.4f} ms a call from Python), plain {r['plain_ms']:.4f} ms, "
                f"library {fmt_ms(r['library_ms'])}, bound {r['bound_ms']:.5f} ms by "
                f"{r['bound_by']}" + (f"; {r['vs_library']:.2f}x the library call"
                                      if "vs_library" in r else "")
                + (f"; {raw['bound_f32_fma_ms']:.5f} ms at the f32 FMA rate"
                   if "bound_f32_fma_ms" in raw else "")
                + (f"; us a launch (profiler) {r['launch_us']}" if "launch_us" in r else ""))
    tr = rows["flash_prefill"]["training"]
    for what, r in (("forward with lse", tr["forward_lse"]), ("training backward",
                                                             tr["backward"])):
        log(f"phase 5: flash_prefill {what} [{r['shape']}]: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {fmt_ms(r['library_ms'])}, bound "
            f"{r['bound'][0]:.5f} ms by {r['bound'][1]}"
            + (f"; without lse {r['ms_without_lse']:.4f} ms" if "ms_without_lse" in r else ""))
    log(f"phase 11 summary ({card}): granite-moe step {granite_train['step_s']:.4f} s, "
        f"{granite_train['tokens_per_s']:.0f} tokens/s, peak {granite_train['peak_gb']:.2f} GB; "
        f"yi-9b x{YI_TRAIN_LAYERS} layers step {yi_train['step_s']:.4f} s, "
        f"{yi_train['tokens_per_s']:.0f} tokens/s, peak {yi_train['peak_gb']:.2f} GB")
    log(f"all phases in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
