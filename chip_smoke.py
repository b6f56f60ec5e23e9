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
   kv_pull_runs (one transaction a run of adjacent pages) bit-equal at
   run_len 1, 2, 4 and 8 in f32, bf16, int8 and uint8 with untouched pages
   intact, on the 1024-block request of tests/test_kernels.py in 8-block
   runs and on a Yi-9B request's slab pages in 108 runs of 8 (equal to
   kv_pull on the runs' page ids too), a run past its pool raising;
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
   encoder and hymba's window + prefix, f32 and bf16.  ssd_scan's autograd
   Function (the kernel forward, the plain-torch backward) against autograd
   through the plain version: y and the state to 1e-3, the six gradients to
   1e-4 in ||err|| / ||ref||, at mamba2-780m's training shape (2 x 4096), a
   ragged mamba2 length, hymba-1.5b's widths and the decay extremes.
   paged_attention's lse output (``return_lse``) against the plain
   version: one partition and several, contexts of 0 (out 0, lse -inf,
   no NaN) and phase 14's rank-local slice at Yi widths, f32 and bf16.
   Phase 1 also fails unless the SASS of
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
   4b. kv_pull_runs through its own entry point, a path of its own (the
   serving path expands runs into kv_pull page ids): one Yi-9B 257-token
   request's 864 uint8 slab pages pulled as 108 runs of 8, one launch,
   bit-equal to the plain version.
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
14. Serving under a ("data", "model") device mesh of 4 ranks spawned with
   ``torch.multiprocessing`` (gloo over the one card; nccl where each rank
   has a card, ``--phase 14`` alone): Yi-9B at full width cut to 16
   layers (all 48 until phase 16 joined the script) tensor
   parallel over (1, 4) on 3 x 1024 tokens (the pages split over 'model':
   the sequence-parallel paged_attention combine, a full, a partial and
   an empty slice) and 3 x 96 (pages whole), granite-moe-3b-a800m cut to 8
   layers (32 before) folded
   over (2, 2) (experts over 'data', all_to_all both ways, the FSDP
   expert shards gathered), then both at full width cut in depth in f32;
   each against a single-card run of the same seed and prompts, logits
   and tokens under the margin rule of ``repro_torch.parity``; each
   rank's launches exact; a decode step's collectives by kind.
15. Training under a ("data", "model") mesh of the same 4 spawned ranks
   (``--phase 15`` alone, as 14): FSDP over "data", TP over "model"
   (``make_train_step(mesh=)``).  First, for Yi-9B over (2, 2),
   granite-moe-3b-a800m folded over (2, 2) (capacity_factor = E / k) and
   mamba2-780m over (4, 1), each at full width cut to 2 layers in f32, one
   step under the mesh against the same step on one card (computed in
   every rank in turn): loss 1e-5, gradient norm 1e-4 relative, every
   gradient shard and updated param shard 1e-4 in ||err|| / ||ref|| (the
   param elements whose gradient lies within 100 x AdamW's eps, where its
   step g / (|g| + eps) is steep, held instead to p + lr x step equal on
   both sides, 1e-4).  Then
   bf16, 3 steps each: Yi-9B cut to 4 layers over (2, 2) at 2 x 2048,
   granite cut to 4 layers folded over (2, 2) at 4 x 512, mamba2 at full
   width cut to 16 layers (all 48 until phase 16 joined the script) over
   (4, 1) at 4 x 2048: losses finite, flash_prefill
   (ssd_scan for mamba2) exactly layers x steps x 2 on every rank, every
   step's collectives by direction and kind equal, in count and bytes, to
   the dry-run's (``repro_torch.launch.dryrun``: the same step of the
   same config, mesh and batch on meta tensors under a count-only view of
   the mesh, counted on the CPU for each rank after its runs).
   Last, Yi's f32 cut through ``launch.train.run_rank`` over (2, 2), 3
   steps with a checkpoint of the global leaves at step 2: a ``--resume``
   repeats step 3's loss bit for bit, and the checkpoint restored under
   (1, 4) gathers to the one-card restore's leaves bit for bit.  Step
   times, tokens a second, peak memory per rank and the collectives
   beside the card's name and power limit; for each bf16 run and rank, the
   dry-run's argument + temporary bytes of the same step beside the
   measured ``max_memory_allocated`` (the run's and the steps' own), their
   ratio recorded, not held to a limit.
16. The SSM, hybrid, encoder-decoder and VLM families under a mesh of the
   same 4 spawned ranks (``--phase 16`` alone, as 14).  Serving over (1, 4)
   at the full configs in bf16 against one card under the margin rule:
   mamba2-780m (3 x 130 tokens; 12 SSD heads a rank), hymba-1.5b (1200
   tokens, past its window: the ring wraps; its 50 SSD heads split by
   head_dim, 16 channels a rank), whisper-large-v3 (1500 seeded frames, 2 x
   100 decoder tokens: 5 heads a rank, the pages split, the
   sequence-parallel paged_attention combine), llava-next-mistral-7b
   (2880 seeded image embeddings + 96 tokens, 8 heads a rank); then each
   at full width cut to 4 layers in f32, mamba2 whole (every compared token
   equal).  mamba2's bf16 logits, on the prompts of two seeds, are held to
   twice the one card's own bf16 rounding (its bf16 logits against its f32
   run's), the others to phase 14's limit.
   Each rank's launches exact, each rank's collectives of the prefill and
   of a decode step equal to the dry-run's.  Training over (2, 2), each
   arch cut in depth: the f32 2-layer step against one card (loss 1e-5,
   gradient norm 1e-4 relative, every gradient and updated param shard
   1e-4 in ||err|| / ||ref||, as phase 15) and 3 bf16 steps of the 4-layer cut at 2 x
   1024 (losses finite, launches exact, every step's collectives equal to
   the dry-run's).  Phase 2 holds the kernels at these rank-local shapes
   against their plain versions, and phase 5 times them.  Phases 14 and
   15 hold their collectives against the dry-run's in the same way.
11. Training: granite-moe-3b-a800m at its full config (every layer and
   expert) through ``launch.train``, batch 4 x 512, 6 steps, the losses
   finite and falling; then, at its full width cut to 4 layers (the full
   state's 55.7 GB checkpoint exceeds what a run may write to the
   machine's disk, which phases 12 and 15 share), 6 steps, and 3 steps
   with a checkpoint at step 3 and
   a ``--resume`` run: the resumed losses equal the uninterrupted run's
   bit for bit.  Then
   Yi-9B at full width cut to 16 layers through ``make_train_step``, two
   steps at s = 2048 (flash_prefill exactly layers x steps x 2 times under
   remat), and a 2-layer f32 cut's step through the kernel against one
   through the plain versions (loss 1e-5, grad norm 1e-4 relative).  Step
   times, tokens a second and peak memory beside the card's name and
   power limit.
12. SSM and hybrid training: mamba2-780m and hymba-1.5b at their full
   configs through ``launch.train``, batch 2 x 4096, 4 steps with a
   checkpoint at step 3: losses finite, ssd_scan (and hymba's
   flash_prefill) exactly layers x steps x 2 under remat; a ``--resume``
   from the checkpoint repeats the uninterrupted run's loss bit for bit
   (hymba's at its full width cut to 8 layers: the full state's 22 GB
   checkpoint does not fit beside phases 11 and 15's in what a run may
   write);
   each model's 2-layer f32 cut, a kernel step against a plain step (loss
   1e-5, grad norm 1e-4 relative); mamba2's step timed with each SSD
   backward in this call (the one derived by hand against its first
   design, the plain version again under autograd).  Step times, tokens a
   second and peak memory beside the card's name and power limit.
13. The port's examples (``examples/torch_*.py``), each ``main`` on the
   card with its defaults, each a path of its own: their self-checks hold
   (served tokens equal monolithic greedy generation, resumed losses
   bit-equal) and each kernel they use launched.
5. Times at the main paths' shapes: each kernel, its plain version, one
   PyTorch library call computing the same function (none computes the
   SSD scan), and the bound; for ssd_scan also each of its launches'
   device time (torch.profiler); and rows at whisper's decode, encoder and
   decode cross-attention and llava's 2976-token prefill; flash_prefill's
   forward with lse at Yi-9B s = 2048 (beside the call without it) and the
   training backward (plain torch after ``_bwd_scan``) at the same shape;
   ssd_scan's forward and backward (plain torch, no Pallas counterpart) at
   mamba2-780m's training shape, 2 x 4096; paged_attention with lse at
   phase 14's rank-local slice beside the call without it; kv_pull_runs on
   the kv_pull row's 864 Yi-9B pages as 108 runs of 8, beside kv_pull on
   the runs' page ids and index_select + index_copy_.

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
RUN_LEN = 8                        # kv_pull_runs' pages a run at Yi-9B (1024-block mini too)
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
# window and meta prefix, torch_train_lm's heads of 8
TRAIN_SHAPES = [
    (1, 257, 257, 32, 4, 128, dict(causal=True)),
    (1, TRAIN_SEQ, TRAIN_SEQ, 32, 4, 128, dict(causal=True)),
    (1, 1500, 1500, 20, 20, 64, dict(causal=False)),
    (1, 1328, 1328, 25, 5, 64, dict(causal=True, sliding_window=1024, prefix_len=128)),
    (8, 128, 128, 8, 2, 8, dict(causal=True)),   # examples/torch_train_lm.py
]
BWD_REL = {"float32": 2e-4, "bfloat16": 1e-2}   # flash backward, ||err|| / ||ref||
GRANITE_TRAIN = ["--arch", "granite-moe-3b-a800m", "--batch", "4", "--seq", "512",
                 "--lr", "3e-3"]
GRANITE_CKPT_LAYERS = 4            # the checkpointed granite cut (about 9 GB on disk)
YI_TRAIN_LAYERS = 16               # Yi-9B cut in depth for its train state to fit
YI_TRAIN_BATCH = 2
TRAIN_LOSS_RTOL = 1e-5             # kernel step vs plain step, f32 2-layer Yi cut
TRAIN_GNORM_RTOL = 1e-4
SSD_GRAD_REL = 1e-4                # the SSD backward's gradients, ||err|| / ||ref||, f32
# (b, s, widths, chunk, ssd_inputs kwargs) of the SSD training checks: the
# mamba2 training shape, a ragged mamba2 length, hymba's longest serving
# prefill, and the decay extremes
SSD_TRAIN_SHAPES = [
    (2, 4096, MAMBA, 128, {}),
    (1, 4001, MAMBA, 128, {}),
    (1, 1328, HYMBA, 128, {}),
    (1, 64, dict(nh=2, hd=16, ns=8), 16, dict(dt_fill=5.0)),
]
SSM_TRAIN = ["--batch", "2", "--seq", "4096"]   # phase 12: the reference's train_4k length
SSM_TRAIN_STEPS = 4
SSM_CKPT_EVERY = 3                 # checkpoint at step 3, resume for step 4
HYMBA_CKPT_LAYERS = 8              # hymba's checkpointed cut (its full one is 22 GB)
SSD_AB_ROUNDS = 2                  # phase 12's mamba2 step, each SSD backward
MESH_RANKS = 4                     # phase 14's ranks (one card: gloo)
MESH_YI_BATCHES = ((3, 1024), (3, 96))   # (batch, tokens): 48 pages (12 a rank), then 19
MESH_GRANITE_BATCH = (4, 128)      # 512 tokens: 4 groups of 128, one a rank
MESH_F32_LAYERS = {"yi-9b": 8, "granite-moe-3b-a800m": 4}   # the f32 runs' depth cuts
MESH_BF16_LAYERS = {"yi-9b": 16, "granite-moe-3b-a800m": 8}  # the bf16 runs' depth cuts
# logits of a mesh run against the single card's, first step: in bf16 two
# computations of other shapes round at other places and random weights
# amplify it over the layers (about 0.14 at Yi's 48, 0.06 at granite's 32,
# granite folded having no tensor parallelism at all); f32 at the plain
# versions' 2e-4 scaled by the depth
MESH_LOGIT_TOL = {"bfloat16": 0.25, "float32": 2e-3}
MESH_TIMEOUT = 900.0
# phase 15: (name, arch, depth cut or None, mesh, batch, tokens) of the bf16 runs
MTRAIN_RUNS = [
    ("yi-9b x4", "yi-9b", 4, (2, 2), 2, 2048),
    ("granite-moe-3b-a800m x4", "granite-moe-3b-a800m", 4, (2, 2), 4, 512),
    ("mamba2-780m x16", "mamba2-780m", 16, (4, 1), 4, 2048),
]
MTRAIN_STEPS = 3
MTRAIN_F32_LAYERS = 2              # the f32 cuts held against one card
MTRAIN_F32 = [("yi-9b", (2, 2), 2, 512), ("granite-moe-3b-a800m", (2, 2), 4, 512),
              ("mamba2-780m", (4, 1), 4, 512)]   # (arch, mesh, batch, tokens)
MTRAIN_LOSS_RTOL = 1e-5            # mesh step vs one card, f32
MTRAIN_GNORM_RTOL = 1e-4
MTRAIN_GRAD_REL = 1e-4             # each gradient shard, ||err|| / ||ref||
MTRAIN_PARAM_REL = 1e-4            # each updated param shard, ||err|| / ||ref||
# an element whose clipped reference gradient lies within MTRAIN_AT_EPS x AdamW's
# eps: there the step g / (|g| + eps) is steep in g, and turns the gradient's
# rounding into moves of a good share of lr (whisper's zero-init biases hold a
# few such elements beside others 1e4 eps up), so its updated param is held to
# each side's own step instead (``_f32_vs_one_card``)
MTRAIN_AT_EPS = 100
MTRAIN_CKPT = ((2, 2), (1, 4))     # the Yi f32 cut's checkpoint: saved under, restored under
MTRAIN_CKPT_BATCH = (2, 512)
# phase 16: arch -> (batch, tokens) of the bf16 serving runs over (1, 4): mamba2's
# 12 SSD heads a rank; hymba past its 1024 window (1328 with the meta tokens); whisper's
# 100 decoder tokens over 1500 frames (20 pages: 5 a rank, the sequence-parallel combine,
# 5 heads a rank); llava's 2880 image tokens + 96 (8 heads a rank)
M16_SERVE = {"mamba2-780m": (3, 130), "hymba-1.5b": (1, 1200),
             "whisper-large-v3": (2, 100), "llava-next-mistral-7b": (1, 96)}
M16_F32_LAYERS = 4                 # the f32 serving cuts (whisper's encoder too)
# phase 16's bf16 logits against one card: hymba, whisper and llava at phase 14's
# MESH_LOGIT_TOL["bfloat16"].  mamba2's 48 SSM layers amplify bf16 rounding further
# (0.2598 on its first run): its limit is M16_ROUNDING times the one card's own bf16
# rounding on the same weights and prompts (the one card's bf16 first-step logits
# against its f32 run's), over the prompts of M16_MAMBA2_SEEDS; its f32 run is the
# full depth at MESH_LOGIT_TOL["float32"], the witness that no tensor-parallel fault
# grows with depth.  Two bf16 runs that round in other places differ by about the
# square root of two times either's own rounding
M16_ROUNDING = 2.0
M16_MAMBA2_SEEDS = (16, 17)
M16_TRAIN_F32 = [(a, (2, 2), 2, 256) for a in M16_SERVE]   # (arch, mesh, batch, tokens)
M16_TRAIN = [(f"{a} x4", a, 4, (2, 2), 2, 1024) for a in M16_SERVE]   # bf16, 3 steps


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
    # the serving examples' decode (deepseek-67b smoke: 8/2 heads of 8,
    # pages of 32, a 64-token prompt and its new tokens)
    for per in (4, 18):
        case(1, 8, 2, 8, per, 32, torch.bfloat16,
             ctx=torch.tensor([64 + 6], dtype=torch.int32, device=dev))
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


def close_lse(lse, ref, tol, what):
    """lse [b, h] f32 against the plain version's: -inf exactly where the
    plain version's is (a context of 0), the rest within ``tol``."""
    import torch

    empty = torch.isneginf(ref)
    if not torch.equal(torch.isneginf(lse), empty) or torch.isnan(lse).any():
        raise AssertionError(f"{what}: lse -inf at {torch.isneginf(lse).nonzero().tolist()}, "
                             f"plain version's at {empty.nonzero().tolist()}")
    return close(lse[~empty], ref[~empty], tol, what) if (~empty).any() else 0.0


def check_paged_lse(gen, dev):
    """paged_attention with ``return_lse`` against the plain version: one
    partition and several (b = 8 over 40 pages), a context of 0 (out 0,
    lse -inf, no NaN), and phase 14's rank-local slice at Yi widths (b = 3,
    12 pages of 32: a full slice, a partial one, an empty one), f32 and
    bf16; out equal to the call without lse.  Returns max |lse err|."""
    import torch

    from repro_torch.kernels.paged_attention.ops import paged_attention, partitions
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    worst = 0.0
    cases = [  # (b, h, g, d, pages, bs, contexts, what)
        (2, 8, 2, 64, 3, 32, [5, 70], "one partition"),
        (8, YI["h"], YI["g"], YI["d"], 40, 16, [1, 640, 17, 300, 0, 639, 630, 2], "split"),
        (2, 8, 2, 64, 3, 32, [0, 0], "contexts of 0"),
        (3, YI["h"], YI["g"], YI["d"], 12, 32, [384, 264, 0], "phase 14's slice"),
    ]
    for b, h, g, d, per, bs, ctx_list, what in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
            kp = torch.randn(b, per, bs, g, d, generator=gen, device=dev).to(dtype)
            vp = torch.randn(b, per, bs, g, d, generator=gen, device=dev).to(dtype)
            tables = torch.arange(per, dtype=torch.int32, device=dev)[None].repeat(b, 1)
            ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
            out, lse = paged_attention(q, kp, vp, tables, ctx, return_lse=True)
            grid = paged_attention.last_grid
            ref, ref_lse = paged_attention_ref(q, kp, vp, tables, ctx, return_lse=True)
            torch.cuda.synchronize()
            tag = f"paged_attention lse {what} b={b} h={h} g={g} d={d} ctx={ctx_list} {name}"
            if not torch.equal(out, paged_attention(q, kp, vp, tables, ctx)):
                raise AssertionError(f"{tag}: out with lse != out without")
            close(out, ref, TOL[name], tag)
            for i, c in enumerate(ctx_list):
                if c == 0 and not (torch.equal(out[i], torch.zeros_like(out[i]))
                                   and torch.isneginf(lse[i]).all()):
                    raise AssertionError(f"{tag}: sequence {i} of context 0: out not 0 or "
                                         f"lse not -inf")
            worst = max(worst, close_lse(lse, ref_lse, TOL[name], tag))
            pages, n_part = partitions(b, g, h // g, per, sm_count(dev))
            log(f"phase 2: {tag}: grid {grid}, {n_part} partition(s) of {pages} pages")
    log(f"phase 2: paged_attention's lse (f32 [b, h]) against the plain version: max |err| "
        f"{worst:.3e}")
    return worst


def check_rank_local(gen, dev):
    """The kernels at phase 16's rank-local shapes against their plain
    versions: ssd_scan at mamba2's 12 SSD heads a rank (1, 4) and 24 (2, 2),
    hymba's 50 heads by a 16-wide head_dim slice (1, 4) and 25 whole heads
    (2, 2), f32; flash_prefill at whisper's 5 heads a rank (the encoder,
    the cross-attention of the prompt and of a decode step over 1500 keys,
    the decoder's causal prompt) and 10 (training), llava's 2976 tokens on
    8 heads a rank (2 kv groups) and its training length on 16, bf16; and
    paged_attention with lse on whisper's 5-head slice of 5 pages (a full
    slice, a partial one, an empty one), f32 and bf16.  Returns the max
    |err| by kernel."""
    import torch

    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import dense_ref
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    errs = {"ssd_scan": 0.0, "flash_prefill": 0.0, "paged_attention": 0.0}
    w = WHISPER
    for b, s, nh, hd, ns, what in (
            (3, M16_SERVE["mamba2-780m"][1], 12, 64, 128, "mamba2, 12 heads a rank"),
            (3, 1, 12, 64, 128, "mamba2, 12 heads a rank, one row"),
            (1, 1024, 24, 64, 128, "mamba2 training, 24 heads a rank"),
            (1, M16_SERVE["hymba-1.5b"][1] + HYMBA["meta"], 50, 16, 16,
             "hymba, 50 heads x 16 of head_dim a rank"),
            (1, 1024 + HYMBA["meta"], 25, 64, 16, "hymba training, 25 heads a rank")):
        x, dt, a, B, C, d_skip = ssd_inputs(gen, dev, b, s, nh, hd, ns)
        y, st = ssd_scan(x, dt, a, B, C, d_skip)
        ry, rst = ssd_scan_ref(x, dt, a, B, C, d_skip)
        torch.cuda.synchronize()
        tag = f"ssd_scan {what}: b={b} s={s} nh={nh} hd={hd} ns={ns} f32"
        errs["ssd_scan"] = max(errs["ssd_scan"], close(y, ry, SSD_TOL["float32"], tag),
                               close(st, rst, SSD_TOL["float32"], tag + " state"))
    bf = torch.bfloat16
    t = w["frames"]
    n = M16_SERVE["whisper-large-v3"][1]
    for s, tk, h, g, d, causal, what, rel in (
            (t, t, 5, 5, w["d"], False, "whisper encoder, 5 heads a rank", None),
            (n, t, 5, 5, w["d"], False, "whisper prompt cross-attention, 5 heads", None),
            (1, t, 5, 5, w["d"], False, "whisper decode cross-attention, 5 heads", None),
            (n, n, 5, 5, w["d"], True, "whisper decoder prompt, 5 heads", None),
            (t, t, 10, 10, w["d"], False, "whisper encoder training, 10 heads", None),
            (LLAVA["vision"] + M16_SERVE["llava-next-mistral-7b"][1], None, 8, 2, LLAVA["d"],
             True, "llava image + text, 8 heads a rank", REL_NORM_BF16),
            (LLAVA["vision"] + 1024, None, 16, 4, LLAVA["d"], True,
             "llava training, 16 heads a rank", REL_NORM_BF16)):
        tk = s if tk is None else tk
        q = torch.randn(1, s, h, d, generator=gen, device=dev).to(bf)
        k = torch.randn(1, tk, g, d, generator=gen, device=dev).to(bf)
        v = torch.randn(1, tk, g, d, generator=gen, device=dev).to(bf)
        out = flash_prefill(q, k, v, causal=causal)
        torch.cuda.synchronize()
        errs["flash_prefill"] = max(errs["flash_prefill"], close(
            out, dense_ref(q, k, v, causal=causal), TOL["bfloat16"],
            f"flash_prefill {what}: s={s} t={tk} h={h} g={g} d={d} bf16", rel))
    per, bs = 5, 32
    for ctx_list in ([n + MAX_NEW, 0], [per * bs, 37]):
        for dtype in (torch.float32, bf):
            name = str(dtype).split(".")[1]
            q = torch.randn(2, 5, w["d"], generator=gen, device=dev).to(dtype)
            kp = torch.randn(2, per, bs, 5, w["d"], generator=gen, device=dev).to(dtype)
            vp = torch.randn(2, per, bs, 5, w["d"], generator=gen, device=dev).to(dtype)
            tables = torch.arange(per, dtype=torch.int32, device=dev)[None].repeat(2, 1)
            ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
            out, lse = paged_attention(q, kp, vp, tables, ctx, return_lse=True)
            ref, ref_lse = paged_attention_ref(q, kp, vp, tables, ctx, return_lse=True)
            torch.cuda.synchronize()
            tag = f"paged_attention lse whisper's 5-head slice, {per} pages, ctx {ctx_list} {name}"
            errs["paged_attention"] = max(errs["paged_attention"], close(out, ref, TOL[name], tag),
                                          close_lse(lse, ref_lse, TOL[name], tag))
    log(f"phase 2: the kernels at phase 16's rank-local shapes match their plain versions: "
        f"max |err| {errs}")
    return errs


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
        what = f"flash_prefill s={s} t={t} h={h} g={g} d={d} {dtype} {kw}"
        before = flash_prefill.launches
        out = flash_prefill(q, k, v, **kw)
        torch.cuda.synchronize()
        if flash_prefill.launches != before + 1:
            raise AssertionError(f"{what}: {flash_prefill.launches - before} launches, not 1")
        return close(out, dense_ref(q, k, v, **kw), TOL[str(dtype).split(".")[1]], what,
                     rel_norm)

    for dtype in (torch.float32, torch.bfloat16):
        for s, h, g, d in ((256, 4, 2, 64), (128, 8, 8, 32), (256, 6, 1, 128)):
            case(2, s, h, g, d, dtype, causal=True)
    case(1, 256, 4, 2, 32, torch.float32, causal=True, sliding_window=64, prefix_len=16)
    case(1, 128, 4, 4, 32, torch.float32, causal=False)
    case(1, 130, 4, 2, 64, torch.float32, causal=True)  # ragged
    # the examples' shapes: the serving examples' 64-token prompts on the
    # deepseek-67b smoke config (8/2 heads of 8; bf16 at a head dim without
    # a tensor-core kernel runs the f32 kernel), heads of 16 (the other
    # smoke head dim), and torch_train_lm's batch of 8 x 128
    for dtype in (torch.float32, torch.bfloat16):
        for d in (8, 16):
            case(1, 64, 8, 2, d, dtype, causal=True)
    case(8, 128, 8, 2, 8, torch.bfloat16, causal=True)
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


def yi_run_inputs(gen, dev):
    """A 257-token Yi-9B request's 864 pages (9 blocks x 48 layers x K,V)
    as 108 runs of RUN_LEN adjacent pages at random run slots of two uint8
    slabs of 32 KiB pages (``yi_pull_inputs``' pools), and the runs
    expanded into page ids, as the transfer engine would launch them
    through kv_pull: (src, dst, src starts, dst starts, src ids, dst ids)."""
    import torch

    page = YI["bs"] * YI["g"] * YI["d"] * 2
    n_pages = 256 * 2 * 48 // 8
    n_runs = 9 * 48 * 2 // RUN_LEN
    ss, ds = (torch.randperm(n_pages // RUN_LEN, generator=gen, device=dev)[:n_runs]
              .to(torch.int32) for _ in range(2))
    src, dst = (torch.randint(0, 256, (n_pages, page), generator=gen, device=dev,
                              dtype=torch.uint8) for _ in range(2))
    return (src, dst, ss, ds) + expand_runs(ss, ds, RUN_LEN)


def expand_runs(ss, ds, run_len):
    """Run starts (in run units) -> the page ids of every page of every run."""
    import torch

    pages = torch.arange(run_len, dtype=torch.int32, device=ss.device)
    return tuple((x[:, None] * run_len + pages).reshape(-1) for x in (ss, ds))


def check_kv_pull_runs(gen, dev):
    """kv_pull_runs (one transaction a run of run_len adjacent pages) bit-equal
    to its plain version at run_len 1, 2, 4, 8 in f32, bf16, int8 and uint8,
    pages no run names intact; the 1024-block request of
    tests/test_kernels.py pulled in 8 runs of 8 blocks; the Yi-9B request's
    uint8 slab pages in runs of RUN_LEN, equal to kv_pull on the runs'
    page ids too; a run past a pool raises."""
    import torch

    from repro_torch.kernels.kv_pull.ops import kv_pull, kv_pull_runs
    from repro_torch.kernels.kv_pull.ref import kv_pull_runs_ref

    def exact(out, ref, what):
        if not torch.equal(out, ref):
            raise AssertionError(f"{what}: kernel differs from the plain version")

    for run_len in (1, 2, 4, 8):
        for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.uint8):
            src = torch.randint(0, 100, (64, 16, 2, 32), generator=gen, device=dev).to(dtype)
            dst = torch.randint(0, 100, (48, 16, 2, 32), generator=gen, device=dev).to(dtype)
            ss = torch.randperm(64 // run_len, generator=gen, device=dev)[:5].to(torch.int32)
            ds = torch.randperm(48 // run_len, generator=gen, device=dev)[:5].to(torch.int32)
            keep = dst.clone()
            out = kv_pull_runs(src, dst.clone(), ss, ds, run_len=run_len)
            what = f"kv_pull_runs {dtype} runs of {run_len}"
            exact(out, kv_pull_runs_ref(src, keep.clone(), ss, ds, run_len=run_len), what)
            mask = torch.ones(48, dtype=torch.bool, device=dev)
            mask[expand_runs(ss, ds, run_len)[1].long()] = False
            exact(out[mask], keep[mask], f"{what}: untouched pages")
    src = torch.randn(64, 16, 2, 32, generator=gen, device=dev)
    starts = torch.arange(8, dtype=torch.int32, device=dev)
    out = kv_pull_runs(src, torch.zeros_like(src), starts, starts, run_len=8)
    exact(out, src, "kv_pull_runs: 1024-block request in 8-block runs")
    src, dst, ss, ds, sid, did = yi_run_inputs(gen, dev)
    out = kv_pull_runs(src, dst.clone(), ss, ds, run_len=RUN_LEN)
    exact(out, kv_pull_runs_ref(src, dst.clone(), ss, ds, run_len=RUN_LEN),
          "kv_pull_runs yi-9b slab pages")
    exact(out, kv_pull(src, dst.clone(), sid, did), "kv_pull_runs vs kv_pull on page ids")
    try:
        kv_pull_runs(src, dst, ss, ds + dst.shape[0] // RUN_LEN, run_len=RUN_LEN)
    except IndexError:
        pass
    else:
        raise AssertionError("kv_pull_runs: a run past the dst pool did not raise")
    torch.cuda.synchronize()
    log("phase 2: kv_pull_runs bit-equal at run_len 1/2/4/8 in f32/bf16/int8/uint8, the "
        "1024-block mini, the yi-9b request's 108 runs of 8 slab pages (equal to kv_pull "
        "on their page ids); a run past its pool raises")
    return 0.0


def phase_pull_runs(gen, dev):
    """Phase 4b: kv_pull_runs through its entry point, a path of its own
    (the serving path expands runs into kv_pull page ids, as the reference's
    engine never calls its run-granular kernel either): the Yi-9B
    request's 864 pages pulled as 108 runs of RUN_LEN from a prefill slab
    into a decode slab, the counts zeroed just before and read just after;
    the pages land bit-equal to the plain version, and pages no run names
    keep their bytes."""
    import torch

    from repro_torch.kernels.kv_pull.ops import kv_pull_runs
    from repro_torch.kernels.kv_pull.ref import kv_pull_runs_ref

    src, dst, ss, ds, _, did = yi_run_inputs(gen, dev)
    keep = dst.clone()
    reset_counts()
    kv_pull_runs(src, dst, ss, ds, run_len=RUN_LEN)
    torch.cuda.synchronize()
    want = dict.fromkeys(kernel_ops(), 0) | {"kv_pull_runs": 1}
    got = expect_counts(f"phase 4b: yi-9b request's {ss.shape[0]} runs of {RUN_LEN} pages "
                        f"through kv_pull_runs", read_counts(), want)
    mask = torch.ones(dst.shape[0], dtype=torch.bool, device=dev)
    mask[did.long()] = False
    if not (torch.equal(dst, kv_pull_runs_ref(src, keep.clone(), ss, ds, run_len=RUN_LEN))
            and torch.equal(dst[mask], keep[mask])):
        raise AssertionError("phase 4b: kv_pull_runs landed other bytes than the plain version")
    return got


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


def check_ssd_training(gen, dev):
    """The SSD scan's autograd Function (the kernel forward, the plain-torch
    backward) against autograd through the plain version, f32, at
    SSD_TRAIN_SHAPES: y and the state to ssd_scan's 1e-3, each of the six
    gradients to SSD_GRAD_REL in ||err|| / ||ref||, finite, one kernel
    launch a call.  Returns (max gradient error, the most device memory a
    forward and backward added, bytes: the mamba2 training shape's)."""
    import torch

    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    worst, peak = 0.0, 0
    for b, s, w, chunk, kw in SSD_TRAIN_SHAPES:
        nh, hd, ns = w["nh"], w["hd"], w["ns"]
        if "dt_fill" in kw:
            kw = kw | {"a": torch.tensor([-0.01, -8.0], device=dev)}
        args = ssd_inputs(gen, dev, b, s, nh, hd, ns, **kw)
        gy = torch.randn(b, s, nh, hd, generator=gen, device=dev)
        gs = torch.randn(b, nh, hd, ns, generator=gen, device=dev)
        what = f"ssd_scan training b={b} s={s} nh={nh} hd={hd} ns={ns} chunk={chunk} {kw}"
        xs = [t.clone().requires_grad_(True) for t in args]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = ssd_scan.launches
        y, st = ssd_scan(*xs, chunk=chunk)
        ((y * gy).sum() + (st * gs).sum()).backward()
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        if ssd_scan.launches != before + 1:
            raise AssertionError(f"{what}: {ssd_scan.launches - before} kernel launches")
        refs = [t.clone().requires_grad_(True) for t in args]
        y_ref, st_ref = ssd_scan_ref(*refs, chunk=chunk)
        ((y_ref * gy).sum() + (st_ref * gs).sum()).backward()
        close(y.detach(), y_ref.detach(), SSD_TOL["float32"], what + " y")
        close(st.detach(), st_ref.detach(), SSD_TOL["float32"], what + " state")
        for name, x, r in zip(("x", "dt", "a", "B", "C", "d_skip"), xs, refs):
            if not torch.isfinite(x.grad).all():
                raise AssertionError(f"{what}: non-finite d{name}")
            rel = float((x.grad - r.grad).norm() / r.grad.norm())
            if not rel <= SSD_GRAD_REL:
                raise AssertionError(f"{what}: d{name} ||err|| / ||ref|| {rel} above "
                                     f"{SSD_GRAD_REL}")
            worst = max(worst, rel)
        del xs, refs, y, st, y_ref, st_ref
    shapes = [(b, s, w["nh"], w["hd"], w["ns"]) for b, s, w, _, _ in SSD_TRAIN_SHAPES]
    log(f"phase 2: ssd_scan's autograd Function (kernel forward, plain backward) against "
        f"autograd through ssd_scan_ref at (b, s, nh, hd, ns) {shapes}: max ||dx, ddt, da, "
        f"dB, dC, dD err|| / ||ref|| {worst:.3e} (limit {SSD_GRAD_REL}); a forward and "
        f"backward added at most {peak / 1e9:.2f} GB at peak")
    return worst, peak


# --------------------------------------------------------- phases 3-4
def monolithic_batched(model, params, prompts, n):
    """Each prompt prefilled alone, the states stacked (pages padded to one
    per-sequence count), then ``n`` decode_steps at b = len(prompts)."""
    import dataclasses

    import torch

    from repro_torch.launch.steps import _greedy, make_serve_step

    bs = model.BLOCK_SIZE
    per_seq = max(-(-len(t) // bs) for t in prompts) + -(-n // bs) + 1
    firsts, states = [], []
    for t in prompts:
        logits, st = model.prefill(params, {"tokens": torch.as_tensor(t[None])},
                                   max_blocks_margin=per_seq - -(-len(t) // bs))
        firsts.append(_greedy(model, logits))
        states.append(st)
    state = dataclasses.replace(
        states[0],
        context_lens=torch.cat([st.context_lens for st in states]),
        k_pages=torch.cat([st.k_pages for st in states], dim=1),
        v_pages=torch.cat([st.v_pages for st in states], dim=1),
        block_tables=torch.cat([st.block_tables for st in states]))
    del states
    return decode_greedy(make_serve_step(model), params, state, torch.cat(firsts), n)


def kernel_ops():
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.kv_pull.ops import kv_pull, kv_pull_dequant, kv_pull_runs
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    return {"paged_attention": paged_attention, "flash_prefill": flash_prefill,
            "kv_pull": kv_pull, "kv_pull_runs": kv_pull_runs, "kv_pull_dequant": kv_pull_dequant,
            "ssd_scan": ssd_scan}


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
        free_model()   # the launcher's own weights and service (reference cycles) go now
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
    from repro_torch.launch.steps import greedy_generate

    cfg = model.cfg
    free_model()
    log(f"phase 3b: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the "
        f"launcher builds its own weights")
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
        ref = greedy_generate(model, params, tokens, MAX_NEW)
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
    from repro_torch.launch.steps import greedy_generate, make_prefill_step, make_serve_step
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
    refs = [greedy_generate(model, params, t, MAX_NEW) for t in prompts]
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
    flash_prefill exactly layers x steps x 2 times); then ``kernel_vs_plain``
    at the same widths and length."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
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

    out = kernel_vs_plain(dev, cfg, TRAIN_SEQ, "phase 11")
    return counts, {"losses": losses, "step_s": times[1], "tokens_per_s": tokens / times[1],
                    "peak_gb": peak / 1e9, "state_gb": state_gb, "f32_kernel_vs_plain": out}


# ------------------------------------------------------------ phase 12
def phase_train_ssm(dev, card):
    """Phase 12: mamba2-780m and hymba-1.5b at their full configs through
    ``launch.train``, batch 2 x 4096 (the reference's train_4k length; hymba
    runs 4224 rows with its 128 meta tokens, past its 1024-token window),
    SSM_TRAIN_STEPS steps with a checkpoint at step SSM_CKPT_EVERY: losses
    finite, ssd_scan (and hymba's flash_prefill) exactly layers x steps x 2
    (remat).  Then ``--resume`` from that checkpoint: the resumed step's
    loss equals the uninterrupted run's bit for bit (hymba's full state's
    checkpoint is 22 GB, more than a run may write beside phases 11 and 15's, so
    hymba's restart runs at its full width cut to HYMBA_CKPT_LAYERS
    layers).  Then each model's 2-layer f32 cut, one make_train_step step
    through the kernels and one through the plain versions (autograd
    through ``ssd_scan_ref``; ``dense_ref`` for the attention), from the
    same state: loss within TRAIN_LOSS_RTOL, grad norm within
    TRAIN_GNORM_RTOL.  Returns each model's launch counts and numbers."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    ckpt = ROOT / "build" / "ckpt"
    counts, numbers = {}, {}
    for arch, ckpt_layers in (("mamba2-780m", None), ("hymba-1.5b", HYMBA_CKPT_LAYERS)):
        cfg = get_config(arch)
        L, steps = cfg.num_layers, SSM_TRAIN_STEPS
        common = ["--arch", arch, *SSM_TRAIN]
        saving = ["--ckpt-dir", str(ckpt), "--ckpt-every", str(SSM_CKPT_EVERY)]
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        full = train.main(common + ["--steps", str(steps)] + ([] if ckpt_layers else saving))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        remat = L * steps * 2  # the forward runs twice a layer a step
        counts[arch] = expect_counts(
            f"phase 12: launch.train {arch}, {steps} steps", read_counts(),
            {"ssd_scan": remat, "flash_prefill": remat if cfg.has_attention else 0,
             "paged_attention": 0, "kv_pull": 0, "kv_pull_dequant": 0})
        free_model()
        losses = full["losses"]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"phase 12: {arch} losses {losses}")
        step_s = float(np.median(full["step_s"][1:]))
        tokens = 2 * 4096
        log(f"phase 12: {arch} full config, batch 2 x 4096, remat: losses {losses}; step "
            f"{step_s:.4f} s (median of steps 2-{steps}; first {full['step_s'][0]:.4f} s), "
            f"{tokens / step_s:.0f} tokens/s, peak {peak / 1e9:.2f} GB allocated; {card}")

        launcher_config = train.get_config
        if ckpt_layers:
            cut = dataclasses.replace(cfg, num_layers=ckpt_layers)
            train.get_config = lambda name: cut
        try:
            ref = losses
            if ckpt_layers:
                ref = train.main(common + ["--steps", str(steps)] + saving)["losses"]
                free_model()
            ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
            t0 = time.perf_counter()
            rest = train.main(common + ["--steps", str(steps), "--ckpt-dir", str(ckpt),
                                        "--ckpt-every", "100", "--resume"])["losses"]
            free_model()
            t_resume = time.perf_counter() - t0
        finally:
            train.get_config = launcher_config
            shutil.rmtree(ckpt, ignore_errors=True)
        if rest != ref[SSM_CKPT_EVERY:]:
            raise AssertionError(f"phase 12: {arch} resumed losses {rest} != uninterrupted "
                                 f"{ref[SSM_CKPT_EVERY:]}")
        depth = f"cut to {ckpt_layers} layers" if ckpt_layers else "full config"
        log(f"phase 12: {arch} {depth}: checkpoint at step {SSM_CKPT_EVERY} "
            f"({ckpt_bytes / 1e9:.2f} GB), --resume (with its restore {t_resume:.1f} s) "
            f"gave losses {rest} = the uninterrupted run's bit for bit")
        numbers[arch] = {"losses": losses, "step_s": step_s, "tokens_per_s": tokens / step_s,
                         "peak_gb": peak / 1e9, "checkpoint_gb": ckpt_bytes / 1e9,
                         "f32_kernel_vs_plain": kernel_vs_plain(dev, cfg, 4096, "phase 12")}
    numbers["mamba2-780m"]["backward_ab"] = ssd_backward_step_ab(get_config("mamba2-780m"))
    return counts, numbers


def kernel_vs_plain(dev, cfg, seq, phase):
    """``cfg`` cut to 2 layers in f32: one make_train_step step (remat) at
    1 x ``seq`` through the kernels and one through the plain versions
    (``dense_ref`` for flash_prefill's forward, autograd through
    ``ssd_scan_ref`` for the SSD scan; the flash backward is plain torch
    either way) from the same state; the losses within TRAIN_LOSS_RTOL and
    the gradient norms within TRAIN_GNORM_RTOL, the kernel step launching
    flash_prefill and ssd_scan (where the model has them) exactly 2
    layers x 2, the plain step neither."""
    import dataclasses

    import torch

    import repro_torch.models.flash as flash_mod
    import repro_torch.models.ssm as ssm_mod
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels.flash_prefill.ref import dense_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=1)
    model = build_model(cfg2)
    tokens = SyntheticLMDataset(cfg2.vocab_size, seq, 1).next_batch()["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    plain = {(flash_mod, "flash_prefill"): dense_ref,
             (ssm_mod, "ssd_scan"): lambda *a, chunk=128: ssd_scan_ref(*a, chunk=chunk)}
    kernels = {key: getattr(*key) for key in plain}
    out = {}
    for route in ("kernel", "plain"):
        params = cast_tree(model.init_params(0), torch.float32)
        opt = adamw_init(params, ocfg)
        if route == "plain":
            for (mod, attr), fn in plain.items():
                setattr(mod, attr, fn)
        reset_counts()
        try:
            _, _, m = make_train_step(model, ocfg, remat=True)(params, opt, batch)
            out[route] = (float(m["loss"]), float(m["grad_norm"]))
        finally:
            for (mod, attr), fn in kernels.items():
                setattr(mod, attr, fn)
        want = 2 * 2 if route == "kernel" else 0
        expect_counts(f"{phase}: {cfg.name} 2 layers f32, a {route} step", read_counts(),
                      {"flash_prefill": want if cfg.has_attention else 0,
                       "ssd_scan": want if cfg.has_ssm else 0})
        del params, opt, m
        free_model()
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    if abs(lk - lp) > TRAIN_LOSS_RTOL * abs(lp) or abs(gk - gp) > TRAIN_GNORM_RTOL * abs(gp):
        raise AssertionError(f"{phase}: {cfg.name} f32 2-layer step kernel {out['kernel']} "
                             f"!= plain {out['plain']}")
    log(f"{phase}: {cfg.name} widths, 2 layers, f32, 1 x {seq}: kernel step loss {lk!r} grad "
        f"norm {gk!r}; plain step loss {lp!r} grad norm {gp!r} (limits {TRAIN_LOSS_RTOL} / "
        f"{TRAIN_GNORM_RTOL} relative)")
    del model
    free_model()
    return out


def ssd_backward_autograd_recompute(inputs, dy, dstate, *, chunk=128):
    """The SSD backward's first design, kept as the reference its chosen
    design is timed against: ``ssd_scan_ref`` run again from the saved
    inputs under autograd and differentiated (``torch.autograd.grad``); the
    signature of ``ops.ssd_scan_backward``."""
    import torch

    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        outs = ssd_scan_ref(*leaves, chunk=chunk)
        read = [(o, g) for o, g in zip(outs, (dy, dstate)) if g is not None]
        return torch.autograd.grad([o for o, _ in read], leaves, [g for _, g in read])


def ssd_backward_step_ab(cfg):
    """Phase 12: launch.train's mamba2 step (``make_train_step``, remat,
    batch 2 x 4096, the full config) timed on the host's clock with each
    SSD backward in this one call: two warm-up steps (one each), then
    SSD_AB_ROUNDS rounds of chosen, recompute, recompute, chosen, the
    device synchronised around each step; each design's median step time
    and the most memory a step of it allocated."""
    import math
    import statistics

    import torch

    import repro_torch.kernels.ssd_scan.ops as ssd_ops
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    model = build_model(cfg)
    ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100,
                       fp32_master=cfg.fp32_master)
    params = model.init_params(0)
    opt = adamw_init(params, ocfg)
    tokens = SyntheticLMDataset(cfg.vocab_size, 4096, 2).next_batch()["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device=model.device)}
    step = make_train_step(model, ocfg, remat=True)
    designs = {"chosen": ssd_ops.ssd_scan_backward,
               "autograd_recompute": ssd_backward_autograd_recompute}
    order = ["chosen", "autograd_recompute"] + \
        ["chosen", "autograd_recompute", "autograd_recompute", "chosen"] * SSD_AB_ROUNDS
    times = {k: [] for k in designs}
    peaks = {k: 0 for k in designs}
    try:
        for i, name in enumerate(order):
            ssd_ops.ssd_scan_backward = designs[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            if not math.isfinite(float(m["loss"])):
                raise AssertionError(f"phase 12: backward A/B {name}: loss {m['loss']}")
            torch.cuda.synchronize()
            if i >= len(designs):  # the first step of each is its warm-up
                times[name].append(time.perf_counter() - t0)
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
    finally:
        ssd_ops.ssd_scan_backward = designs["chosen"]
    del model, params, opt, m
    free_model()
    out = {f"{k}_step_s": statistics.median(v) for k, v in times.items()}
    out |= {f"{k}_steps_s": v for k, v in times.items()}
    out |= {f"{k}_peak_gb": p / 1e9 for k, p in peaks.items()}
    log(f"phase 12: {cfg.name} step with each SSD backward, one call, "
        f"{SSD_AB_ROUNDS} rounds of chosen/recompute/recompute/chosen after a warm-up "
        f"each: chosen (derived by hand) {out['chosen_step_s']:.4f} s "
        f"{times['chosen']}, peak {out['chosen_peak_gb']:.2f} GB; autograd recompute "
        f"{out['autograd_recompute_step_s']:.4f} s {times['autograd_recompute']}, peak "
        f"{out['autograd_recompute_peak_gb']:.2f} GB")
    return out


# ------------------------------------------------------------ phase 13
EXAMPLE_RUNS = {  # example -> (arguments, kernels it must launch at least once)
    "torch_quickstart": ([], ("kv_pull",)),
    "torch_serve_disaggregated": ([], ("flash_prefill", "paged_attention", "kv_pull")),
    "torch_serve_routed": ([], ("flash_prefill", "paged_attention", "kv_pull")),
    "torch_serve_streaming": ([], ("flash_prefill", "paged_attention", "kv_pull")),
    "torch_train_lm": ([], ("flash_prefill",)),
}


def phase_examples():
    """Phase 13: each port example's ``main`` on the card with its default
    arguments (``--device cuda``), a path of its own: its self-checks hold
    (served tokens equal monolithic greedy generation, the resumed losses
    equal the uninterrupted ones), and each kernel it must use launched.
    Returns each example's launch counts."""
    import importlib.util

    import torch

    counts = {}
    for name, (argv, kernels) in EXAMPLE_RUNS.items():
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        reset_counts()
        t0 = time.perf_counter()
        mod.main(argv)
        torch.cuda.synchronize()
        counts[name] = expect_counts(f"phase 13: examples/{name}.py in "
                                     f"{time.perf_counter() - t0:.1f}s", read_counts(),
                                     {k: 0 for k in kernel_ops() if k not in kernels},
                                     at_least={k: 1 for k in kernels})
        free_model()
    return counts


# ----------------------------------------------------------- phase 14
def greedy_run(model, params, tokens, n, mesh=None):
    """Prefill + ``n`` greedy serve steps through ``launch.steps`` (under
    ``mesh`` when given) of ``tokens`` [b, s] (or a batch dict with a VLM's
    image embeddings or an encoder-decoder's frames) -> (each step's logits
    [b, V] f32 on the host, gathered whole under a mesh; each step's tokens
    [b]; the collectives by kind of the prefill and of one decode step,
    {"prefill", "decode"}; the state's layout; the prefill's and the median
    decode step's seconds, host clock ending in a token read)."""
    import torch

    from repro_torch.launch.shardings import batch_spec, spec_axes
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import sharding

    seen = []
    for fn in ("prefill", "decode_step"):
        orig = getattr(model, fn)

        def spy(*a, _orig=orig, **k):
            logits, st = _orig(*a, **k)
            seen.append(logits)
            return logits, st
        setattr(model, fn, spy)
    try:
        prefill, serve = make_prefill_step(model, mesh=mesh), make_serve_step(model, mesh=mesh)
        batch = tokens if isinstance(tokens, dict) else {"tokens": torch.as_tensor(tokens)}
        sharding.COUNTER.reset()
        t0 = time.perf_counter()
        tok, state = prefill(params, batch)
        toks = [tok.cpu()]
        times = {"prefill_s": time.perf_counter() - t0}
        step, step_s = {"prefill": sharding.COUNTER.summary()}, []
        for _ in range(n):
            sharding.COUNTER.reset()
            t0 = time.perf_counter()
            tok, state = serve(params, state, tok)
            toks.append(tok.cpu())
            step_s.append(time.perf_counter() - t0)
            step["decode"] = sharding.COUNTER.summary()
        times["step_s"] = sorted(step_s)[len(step_s) // 2]
    finally:
        del model.prefill, model.decode_step
    logits = []
    if mesh is None:
        logits = [lg.float().cpu() for lg in seen]
    else:
        cfg = model.cfg
        with sharding.mesh_context(mesh, fold_model_axis=cfg.fold_model_axis_into_dp):
            spec = batch_spec(mesh, len(batch["tokens"]), fold_model=cfg.fold_model_axis_into_dp)
            for i, lg in enumerate(seen):
                if lg.shape[-1] < cfg.padded_vocab:
                    lg = sharding.all_gather(lg, "model", 1)
                axes = (spec_axes(spec[0]) if spec else ()) if i == 0 else \
                    state.layout.batch_axes
                logits.append(sharding.all_gather(lg, axes, 0).float().cpu())
    return logits, toks, step, getattr(state, "layout", None), times


def mesh_counts():
    from repro_torch.kernels.paged_attention.ops import paged_attention

    return read_counts() | {"paged_attention_lse": paged_attention.launches_lse}


def reset_mesh_counts():
    from repro_torch.kernels.paged_attention.ops import paged_attention

    reset_counts()
    paged_attention.launches_lse = 0


def mesh_runs_spec(seed=14):
    """Phase 14's runs: (name, config, mesh shape, dtype, prompt batches,
    logits tolerance).  Yi-9B at its full config over (1, 4), bf16, on
    MESH_YI_BATCHES; granite-moe-3b-a800m at its full config folded over
    (2, 2), bf16, with a capacity that drops no (token, expert) pair (the
    reference ties a MoE group's size to the mesh's DP extent, and with
    drops a token's output depends on its group: without, the mesh run
    must give the single-card run's tokens); then each at full width in
    f32, cut in depth (MESH_F32_LAYERS), where the comparison is tight."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config

    rng = np.random.default_rng(seed)
    full_yi = get_config("yi-9b")
    full_granite = get_config("granite-moe-3b-a800m")
    # the bf16 runs at full width cut in depth (MESH_BF16_LAYERS), for the
    # script's time once phase 16 joined
    yi = dataclasses.replace(full_yi, num_layers=MESH_BF16_LAYERS["yi-9b"])
    granite = dataclasses.replace(
        full_granite, num_layers=MESH_BF16_LAYERS["granite-moe-3b-a800m"],
        capacity_factor=full_granite.num_experts / full_granite.experts_per_token)
    yi_batches = [rng.integers(0, yi.vocab_size, bs).astype(np.int32) for bs in MESH_YI_BATCHES]
    g_batch = [rng.integers(0, granite.vocab_size, MESH_GRANITE_BATCH).astype(np.int32)]
    yi_f32 = dataclasses.replace(yi, num_layers=MESH_F32_LAYERS["yi-9b"])
    granite_f32 = dataclasses.replace(granite,
                                      num_layers=MESH_F32_LAYERS["granite-moe-3b-a800m"])
    return [
        (f"yi-9b x{yi.num_layers}", yi, (1, 4), torch.bfloat16, yi_batches,
         MESH_LOGIT_TOL["bfloat16"]),
        (f"granite-moe-3b-a800m x{granite.num_layers}", granite, (2, 2), torch.bfloat16,
         g_batch, MESH_LOGIT_TOL["bfloat16"]),
        (f"yi-9b x{yi_f32.num_layers} f32", yi_f32, (1, 4), torch.float32, yi_batches,
         MESH_LOGIT_TOL["float32"]),
        (f"granite-moe-3b-a800m x{granite_f32.num_layers} f32", granite_f32, (2, 2),
         torch.float32, g_batch, MESH_LOGIT_TOL["float32"]),
    ]


def dryrun_serve(cfg, shape, rank, batch, dtype):
    """The dry-run's collectives (``launch.dryrun``: the steps on meta
    tensors under a count-only view of the mesh) of rank ``rank``'s prefill
    of ``batch`` and of one decode step after it: {"prefill", "decode"}
    by kind, count and bytes."""
    import torch

    from repro_torch.launch import dryrun

    b, n = (len(batch["tokens"]), batch["tokens"].shape[1]) if isinstance(batch, dict) \
        else batch.shape
    ctx = n + (cfg.vision_tokens if cfg.family == "vlm" else 0) + cfg.num_meta_tokens
    dt = None if dtype == torch.bfloat16 else dtype
    mesh = {"data": shape[0], "model": shape[1]}
    return {"prefill": dryrun.count(cfg, "prefill", mesh, rank, batch=b, seq=n,
                                    dtype=dt).summary(),
            "decode": dryrun.count(cfg, "decode", mesh, rank, batch=b, seq=ctx,
                                   dtype=dt).summary()}


def serve_launches(cfg, layout):
    """A mesh serving run's launches on each rank (prefill + MAX_NEW steps):
    flash_prefill once a layer at prefill (whisper: each encoder layer,
    each decoder layer's self- and cross-attention, and the cross-attention
    again every step), paged_attention once a layer a step over pages (with
    lse where they split), ssd_scan once an SSM layer at prefill."""
    want = dict.fromkeys(kernel_ops(), 0)
    L = cfg.num_layers
    if cfg.is_encoder_decoder:
        want["flash_prefill"] = cfg.encoder_layers + 2 * L + L * MAX_NEW
        want["paged_attention"] = L * MAX_NEW
    elif cfg.has_attention:
        want["flash_prefill"] = L
        want["paged_attention"] = 0 if cfg.sliding_window else L * MAX_NEW
    if cfg.has_ssm:
        want["ssd_scan"] = L
    want["paged_attention_lse"] = want["paged_attention"] if layout.seq_parallel else 0
    return want


def _mesh_rank(dev, rank, world, work, runs):
    """One rank of a serving mesh phase (14, 16): each of ``runs`` on its
    mesh, then the dry-run's collectives of this rank's steps; results to
    ``work/rank{rank}.pkl``."""
    import pickle

    import torch

    from repro_torch.launch.mesh import build_params, make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"backend": None, "runs": {}}
    for name, cfg, shape, dtype, batches, _ in runs:
        mesh = make_mesh(shape, ("data", "model"), dev)
        out["backend"] = mesh.backend
        model = build_model(cfg, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = build_params(model, mesh, fold_model=cfg.fold_model_axis_into_dp,
                              dtype=None if dtype == torch.bfloat16 else dtype)
        t_build = time.perf_counter() - t0
        for i, toks in enumerate(batches):
            reset_mesh_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, tokens, step, layout, times = greedy_run(model, params, toks, MAX_NEW,
                                                             mesh)
            torch.cuda.synchronize()
            out["runs"][f"{name} #{i}"] = dict(
                seconds=time.perf_counter() - t0, build_s=t_build, counts=mesh_counts(),
                times=times,
                logits=logits if rank == 0 else None, tokens=tokens, step=step,
                layout=layout, peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                shard_gb=sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9)
        del params, model
        free_model()
    for name, cfg, shape, dtype, batches, _ in runs:   # after the runs: CPU work only
        for i, toks in enumerate(batches):
            t0 = time.perf_counter()
            out["runs"][f"{name} #{i}"]["dryrun"] = dryrun_serve(cfg, shape, rank, toks, dtype)
            out["runs"][f"{name} #{i}"]["dryrun_s"] = time.perf_counter() - t0
    with open(f"{work}/rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)


def phase_mesh(card, runs=None, tag="phase 14"):
    """Phase 14 (``runs``: ``mesh_runs_spec``) or 16's serving runs: serving
    under a ("data", "model") mesh of MESH_RANKS ranks spawned with
    ``torch.multiprocessing`` (each its own CUDA context; gloo when they
    share the one card, nccl when each has a card of its own).  Phase 14:
    Yi-9B over (1, 4), tensor parallel 4: 3 x 1024 tokens (48 pages a
    sequence, 12 a rank: the sequence-parallel branch with rank 2's slice
    partial and rank 3's empty) and 3 x 96 (19 pages: whole on every
    rank), 8 new tokens each; granite-moe-3b-a800m folded over (2, 2):
    experts over 'data', their FSDP shards gathered over 'model' each call,
    4 x 128 tokens (4 groups of 128: the expert-parallel branch).  Each
    run against a single-card run of the same seed, prompts and dtype made
    first: the first step's logits within the run's tolerance, the tokens
    equal wherever the single-card run's top-2 margin exceeds it
    (``repro_torch.parity``); every rank's launches exact
    (``serve_launches``); every rank's collectives of the prefill and of a
    decode step equal, in count and bytes, to the dry-run's of that rank
    (``dryrun_serve``).  Returns the per-run records."""
    import pickle
    import tempfile

    import numpy as np
    import torch

    from repro_torch import parity
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.registry import build_model

    free_model()
    t_phase = time.perf_counter()
    runs = mesh_runs_spec() if runs is None else runs
    refs = {}
    t0 = time.perf_counter()
    for name, cfg, _, dtype, batches, _ in runs:
        model = build_model(cfg)
        params = model.init_params(0)
        if dtype != torch.bfloat16:
            params = cast_tree(params, dtype)
        for i, toks in enumerate(batches):
            ref = greedy_run(model, params, toks, MAX_NEW)
            refs[f"{name} #{i}"] = ref[:2] + (ref[4],)
        del params, model
        free_model()
    t_ref = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        spawn(_mesh_rank, MESH_RANKS, f"{work}/init", device="cuda", args=(work, runs),
              timeout=MESH_TIMEOUT)
        t_ranks = time.perf_counter() - t0
        ranks = [pickle.load(open(f"{work}/rank{r}.pkl", "rb")) for r in range(MESH_RANKS)]
    backend = ranks[0]["backend"]
    records = {}
    for name, cfg, shape, dtype, batches, tol in runs:
        for i in range(len(batches)):
            run = f"{name} #{i}"
            ref_logits, ref_tokens, ref_times = refs[run]
            got = ranks[0]["runs"][run]
            layout = got["layout"]
            want = serve_launches(cfg, layout)
            for r, rank in enumerate(ranks):
                mine = rank["runs"][run]
                expect_counts(f"{tag}: {run} rank {r}", mine["counts"], want)
                if any(not torch.equal(a, b) for a, b in zip(mine["tokens"], got["tokens"])):
                    raise AssertionError(f"{tag}: {run}: rank {r}'s tokens differ from "
                                         f"rank 0's")
                if mine["step"] != mine["dryrun"]:
                    raise AssertionError(f"{tag}: {run} rank {r}: collectives {mine['step']} "
                                         f"!= the dry-run's {mine['dryrun']}")
            if cfg.num_experts and not all(got["step"]["decode"].get(k, {}).get("count")
                                           for k in ("all-to-all", "all-gather")):
                raise AssertionError(f"{tag}: {run}: the expert exchange ran no all_to_all "
                                     f"or all_gather in a decode step: {got['step']}")
            rounding = None
            lim = tol
            if isinstance(tol, str):   # the one card's bf16 rounding: against its f32 run
                rounding = float((ref_logits[0] - refs[f"{tol} #{i}"][0][0]).abs().max())
                lim = M16_ROUNDING * rounding
            diff = got["logits"][0] - ref_logits[0]
            err = float(diff.abs().max())
            rel = float(diff.norm() / ref_logits[0].norm())
            if not np.isfinite(err) or not err <= lim:
                raise AssertionError(f"{tag}: {run}: first-step logits max |err| {err} "
                                     f"above {lim} (one card's own bf16 rounding {rounding})")
            agree = parity.check_greedy_tokens(ref_logits, ref_tokens, got["tokens"], lim,
                                               vocab=cfg.vocab_size)
            n_tok = len(ref_tokens) * len(ref_tokens[0])
            why = "" if rounding is None else \
                f" = {M16_ROUNDING} x the one card's bf16 rounding {rounding:.4g}"
            records[run] = dict(
                seconds=got["seconds"], build_s=got["build_s"], mesh=shape,
                dtype=str(dtype), seq_parallel=layout.seq_parallel,
                batch_axes=layout.batch_axes, logits_max_abs_err=err, logits_rel_err=rel,
                tol=lim, single_card_bf16_rounding=rounding, tokens_compared=agree["compared"], tokens=n_tok,
                first_uncompared=agree["first_uncompared_step"], counts=got["counts"],
                collectives_per_decode_step=got["step"]["decode"],
                collectives_prefill=got["step"]["prefill"], dryrun_s=got["dryrun_s"],
                peak_gb=[rank["runs"][run]["peak_gb"] for rank in ranks],
                shard_gb=got["shard_gb"], backend=backend, times=got["times"],
                single_card_times=ref_times)
            log(f"{tag} ({card}; {backend}, {MESH_RANKS} ranks): {run} on mesh "
                f"{dict(zip(('data', 'model'), shape))} {layout}: {got['seconds']:.2f}s for "
                f"prefill + {MAX_NEW} steps (prefill {got['times']['prefill_s']:.3f}s, "
                f"decode step {got['times']['step_s']:.4f}s median; one card "
                f"{ref_times['prefill_s']:.3f}s and {ref_times['step_s']:.4f}s; params built "
                f"rank by rank in {got['build_s']:.1f}s); first-step logits max |err| "
                f"{err:.4g} (limit {lim:.4g}{why}), "
                f"||err||/||ref|| {rel:.3e}; tokens compared {agree['compared']}/{n_tok} "
                f"(first uncompared step per sequence {agree['first_uncompared_step']}); "
                f"peak per rank {[round(x, 2) for x in records[run]['peak_gb']]} GB, shard "
                f"{got['shard_gb']:.2f} GB; launches per rank {got['counts']}")
            log(f"{tag}: {run}: collectives per rank, each equal to the dry-run's (counted "
                f"in {got['dryrun_s']:.1f}s): prefill {got['step']['prefill']}; one decode "
                f"step {got['step']['decode']}")
    log(f"{tag}: {time.perf_counter() - t_phase:.1f}s (single-card references "
        f"{t_ref:.1f}s, the ranks {t_ranks:.1f}s)")
    return records


# ----------------------------------------------------------- phase 15
def _mesh_train_cfg(arch, layers=None, f32=False):
    """A mesh training config: ``arch`` at full width, cut to ``layers``
    (an encoder-decoder's encoder too); for the f32 comparisons MoE at
    capacity_factor = E / k, so that the mesh's MoE groups (sized by its DP
    extent) hold the one card's tokens and no pair drops."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  **({"encoder_layers": layers} if cfg.is_encoder_decoder
                                     else {}))
    if f32 and cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    return cfg


def _train_launches(cfg, steps):
    """A mesh train run's launches on each rank under remat: flash_prefill
    and ssd_scan twice a layer a step (the forward and its recompute);
    whisper's encoder, outside the remat regions, once a layer a step.
    Nothing else."""
    want = dict.fromkeys(kernel_ops(), 0)
    L = cfg.num_layers
    if cfg.is_encoder_decoder:
        want["flash_prefill"] = (cfg.encoder_layers + 4 * L) * steps
    elif cfg.has_attention:
        want["flash_prefill"] = L * steps * 2
    if cfg.has_ssm:
        want["ssd_scan"] = L * steps * 2
    return want


def _train_batch(cfg, b, s, seed, tokens=None):
    """A training batch of ``cfg``: ``tokens`` (else drawn from ``seed``),
    and a VLM's image embeddings or an encoder-decoder's frames drawn from
    ``seed`` (``launch.mesh.prompt_batch``)."""
    import torch

    from repro_torch.launch.mesh import prompt_batch

    batch = prompt_batch(cfg, b, s, seed=seed)
    if tokens is not None:
        batch["tokens"] = torch.as_tensor(tokens)
    return batch


def dryrun_train(cfg, shape, rank, b, s):
    """The dry-run's count of rank ``rank``'s train step of ``cfg`` on a
    ("data", "model") mesh of ``shape`` over a global batch of ``b`` x
    ``s``: its collectives, {"forward"|"backward": {kind: {"count",
    "bytes"}}}, and its argument and temporary bytes."""
    from repro_torch.launch import dryrun

    got = dryrun.count(cfg, "train", {"data": shape[0], "model": shape[1]}, rank,
                       batch=b, seq=s)
    return {"collectives": {d: got.summary(d) for d in ("forward", "backward")},
            "argument_bytes": got.argument_bytes, "temp_bytes": got.temp_bytes}


def _named_leaves(tree, path=""):
    """(path, leaf) of a param tree in JAX's leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def _rel(got, ref) -> float:
    return float((got.double() - ref.double()).norm() / max(float(ref.double().norm()), 1e-30))


def _adamw_first_step(g, gnorm, ocfg):
    """AdamW's first normalised step of the gradient ``g`` without the
    weight decay, as ``adamw_update`` computes it: ``g`` clipped by the
    global norm ``gnorm``, then the bias-corrected m / (sqrt(v) + eps)."""
    import torch

    g32 = g.float() * torch.clamp(ocfg.clip_norm / (torch.as_tensor(gnorm) + 1e-9), max=1.0)
    m = (1 - ocfg.b1) * g32 / (1 - ocfg.b1)
    v = (1 - ocfg.b2) * g32 * g32 / (1 - ocfg.b2)
    return m / (torch.sqrt(v) + ocfg.eps)


def _f32_vs_one_card(dev, rank, world, arch, shape, b, s):
    """One f32 step of ``arch``'s 2-layer full-width cut under the mesh
    against the same step on one card (same seed and batch).  The one-card
    step runs in every rank, one rank at a time between barriers, each
    keeping its slices of the gradients and updated params.  Each leaf's
    gradient shard is held at MTRAIN_GRAD_REL (a leaf whose gradient is
    zero in exact arithmetic: the mesh's as near zero), its updated param
    shard at MTRAIN_PARAM_REL over the elements whose gradient is clear of
    AdamW's eps (MTRAIN_AT_EPS); the others at MTRAIN_PARAM_REL once each
    side's own step is taken out: p + lr * step is the same start on both
    sides."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import build_params, make_mesh
    from repro_torch.launch.shardings import param_sharding, shard_tensor, spec_leaves
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import leaves

    cfg = _mesh_train_cfg(arch, MTRAIN_F32_LAYERS, f32=True)
    fold = cfg.fold_model_axis_into_dp
    model = build_model(cfg, device=dev)
    mesh = make_mesh(shape, ("data", "model"), dev)
    specs = spec_leaves(param_sharding(model.param_shapes(), mesh, mode="train",
                                       fold_model=fold))
    ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=4)
    batch = {k: v.to(dev) for k, v in _train_batch(cfg, b, s, 15).items()}
    seen = {}
    update = steps.adamw_update

    def spy(params, grads, state, c, **kw):   # the gradients the step applies
        seen["grads"] = leaves(grads)
        return update(params, grads, state, c, **kw)

    steps.adamw_update = spy
    try:
        ref = None
        for r in range(world):
            if r == rank:
                params = cast_tree(model.init_params(0), torch.float32)
                opt = adamw_init(params, ocfg)
                params, opt, met = steps.make_train_step(model, ocfg, remat=True)(
                    params, opt, batch)
                ref = {"loss": float(met["loss"]), "gnorm": float(met["grad_norm"]),
                       "lr": float(met["lr"]),
                       "grads": [shard_tensor(g, sp, mesh) for g, sp in
                                 zip(seen.pop("grads"), specs)],
                       "params": [shard_tensor(p, sp, mesh) for p, sp in
                                  zip(leaves(params), specs)]}
                del params, opt, met
                free_model()
            dist.barrier()
        params = build_params(model, mesh, fold_model=fold, mode="train", dtype=torch.float32)
        opt = adamw_init(params, ocfg)
        reset_counts()
        params, opt, met = steps.make_train_step(model, ocfg, remat=True, mesh=mesh)(
            params, opt, batch)
        counts = read_counts()
    finally:
        steps.adamw_update = update
    total, lr = ref["gnorm"], float(met["lr"])
    grad_errs, param_errs, at_eps, zero_ok = [], [], [], True
    names = [n for n, _ in _named_leaves(model.param_shapes())]
    for name, g, r, p, rp in zip(names, seen["grads"], ref["grads"], leaves(params),
                                 ref["params"]):
        if float(r.norm()) <= 1e-6 * total:
            # zero in exact arithmetic (a key bias shifts a row's scores alike)
            zero_ok &= float(g.norm()) <= 1e-6 * total
        else:
            grad_errs.append((_rel(g, r), name))
        steep = r.abs() * min(1.0, ocfg.clip_norm / (total + 1e-9)) <= MTRAIN_AT_EPS * ocfg.eps
        if not bool(steep.all()):
            param_errs.append((_rel(p[~steep], rp[~steep]), name))
        if not bool(steep.any()):
            continue
        u = _adamw_first_step(g[steep], met["grad_norm"], ocfg).double()
        ru = _adamw_first_step(r[steep], total, ocfg).double()
        ps, rps = p[steep].double(), rp[steep].double()
        start = ps + lr * u - (rps + ref["lr"] * ru)
        scale = float(rps.norm()) + lr * float(u.norm()) + ref["lr"] * float(ru.norm())
        at_eps.append({"leaf": name, "elements": int(steep.sum()), "of": r.numel(),
                       "param_rel": _rel(ps, rps),
                       "start_rel": float(start.norm()) / max(scale, 1e-30)})
    out = {"loss": float(met["loss"]), "ref_loss": ref["loss"],
           "gnorm": float(met["grad_norm"]), "ref_gnorm": ref["gnorm"],
           "grad_rel": max(grad_errs)[0], "zero_ok": zero_ok, "param_rel": max(param_errs)[0],
           "worst_leaves": {"grad": max(grad_errs)[1], "param": max(param_errs)[1]},
           "at_eps": at_eps,
           "start_rel": max((x["start_rel"] for x in at_eps), default=0.0),
           "counts": counts, "layers": cfg.num_layers}
    del params, opt, ref, seen
    free_model()
    return out


def _mesh_train_run(dev, rank, arch, layers, shape, b, s):
    """``MTRAIN_STEPS`` bf16 steps of ``arch`` (full width, cut to
    ``layers``) under the mesh: losses, step times, this rank's launches
    and peak memory, each step's collectives by direction and kind, and the
    dry-run's for this rank (after the steps: CPU work only)."""
    import torch

    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.hlo_analysis import train_step_stats
    from repro_torch.launch.mesh import build_params, make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import sharding
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import leaves

    cfg = _mesh_train_cfg(arch, layers)
    model = build_model(cfg, device=dev)
    mesh = make_mesh(shape, ("data", "model"), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = build_params(model, mesh, fold_model=cfg.fold_model_axis_into_dp, mode="train")
    ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=MTRAIN_STEPS,
                       fp32_master=cfg.fp32_master)
    opt = adamw_init(params, ocfg)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    state_gb = sum(t.numel() * t.element_size() for t in leaves((params, opt))) / 1e9
    build_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)   # the steps' own peak from here
    step = make_train_step(model, ocfg, remat=True, mesh=mesh)
    data = SyntheticLMDataset(cfg.vocab_size, s, b)
    losses, times, colls = [], [], []
    reset_counts()
    for i in range(MTRAIN_STEPS):
        batch = {k: v.to(dev) for k, v in _train_batch(
            cfg, b, s, 100 + i, tokens=data.next_batch()["tokens"]).items()}
        sharding.COUNTER.reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        times.append(time.perf_counter() - t0)
        colls.append({d: sharding.COUNTER.summary(d) for d in ("forward", "backward")})
    wire = {d: st.wire_bytes for d, st in train_step_stats(sharding.COUNTER.records).items()}
    steps_peak = torch.cuda.max_memory_allocated(dev)
    out = {"losses": losses, "step_s": times, "collectives": colls, "counts": read_counts(),
           "peak_gb": max(build_peak, steps_peak) / 1e9, "steps_peak_gb": steps_peak / 1e9,
           "state_gb": state_gb,
           "build_s": build_s, "layers": cfg.num_layers, "wire_bytes": wire}
    del params, opt, model
    free_model()
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_train(cfg, shape, rank, b, s)
    out["dryrun_s"] = time.perf_counter() - t0
    return out


def _mesh_checkpoint(dev, rank, world):
    """Yi-9B's f32 2-layer cut through ``launch.train.run_rank`` under
    MTRAIN_CKPT[0]: 3 steps, checkpointed at step 2; a ``--resume`` from it
    repeats step 3's loss bit for bit.  The checkpoint restored under
    MTRAIN_CKPT[1] and whole on rank 0's card: every global leaf the
    former gathers equals the latter's, bit for bit."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import NamedSharding, train_state_shardings
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import leaves

    cfg = _mesh_train_cfg("yi-9b", MTRAIN_F32_LAYERS, f32=True)
    ckpt = ROOT / "build" / "ckpt_mesh"
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    dist.barrier()
    flags = ["--arch", "yi-9b", "--mesh", ",".join(map(str, MTRAIN_CKPT[0])), "--batch",
             str(MTRAIN_CKPT_BATCH[0]), "--seq", str(MTRAIN_CKPT_BATCH[1]), "--steps", "3",
             "--lr", "1e-3", "--ckpt-dir", str(ckpt)]
    t0 = time.perf_counter()
    full = train.run_rank(train._parse(flags + ["--ckpt-every", "2"]), cfg, dev, rank, world,
                          dtype=torch.float32)["losses"]
    t_full = time.perf_counter() - t0
    ckpt_gb = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file()) / 1e9
    free_model()
    t0 = time.perf_counter()
    rest = train.run_rank(train._parse(flags + ["--ckpt-every", "100", "--resume"]), cfg, dev,
                          rank, world, dtype=torch.float32)["losses"]
    t_resume = time.perf_counter() - t0
    free_model()
    model = build_model(cfg, device=dev)
    shapes = model.param_shapes()
    like = (shapes, adamw_init(shapes, AdamWConfig()), {"seed": 0, "step": 0})
    mesh = make_mesh(MTRAIN_CKPT[1], ("data", "model"), dev)
    p_sh, o_sh = train_state_shardings(shapes, mesh)
    d_sh = {k: NamedSharding(mesh, ()) for k in like[2]}
    t0 = time.perf_counter()
    other = restore_checkpoint(ckpt, 2, like, device=dev, shardings=(p_sh, o_sh, d_sh))
    t_other = time.perf_counter() - t0
    whole = restore_checkpoint(ckpt, 2, like, device=dev) if rank == 0 else None
    equal, n = True, 0
    for i, (x, sh) in enumerate(zip(leaves(other[:2]), leaves((p_sh, o_sh)))):
        g = sh.gather(x)
        if rank == 0:
            ref = leaves(whole[:2])[i]
            equal &= tuple(g.shape) == tuple(ref.shape) and torch.equal(g.to(ref.device), ref)
            n += 1
    del other, whole
    free_model()
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"losses": full, "resumed": rest, "checkpoint_gb": ckpt_gb, "run_s": t_full,
            "resume_s": t_resume, "restore_other_s": t_other, "leaves_equal": equal,
            "leaves": n}


def _mesh_train_rank(dev, rank, world, work, f32_runs, runs, checkpoint):
    """One rank of a training mesh phase (15, 16): the f32 comparisons, the
    bf16 runs, the checkpoint (phase 15); results to ``work/rank{rank}.pkl``."""
    import pickle

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import choose_backend

    out = {"backend": choose_backend(world, dev), "f32": {}, "runs": {}}
    for arch, shape, b, s in f32_runs:
        out["f32"][arch] = _f32_vs_one_card(dev, rank, world, arch, shape, b, s)
    for name, arch, layers, shape, b, s in runs:
        out["runs"][name] = _mesh_train_run(dev, rank, arch, layers, shape, b, s)
    if checkpoint:
        out["ckpt"] = _mesh_checkpoint(dev, rank, world)
    with open(f"{work}/rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)


def phase_mesh_train(card, f32_runs=None, runs=None, tag="phase 15"):
    """Phase 15 (or 16's training, ``f32_runs`` and ``runs`` given, no
    checkpoint): training under a ("data", "model") mesh of MESH_RANKS
    spawned ranks (gloo on one card, nccl with a card a rank), in one
    spawn: (1) for each of ``f32_runs`` (phase 15: Yi-9B over (2, 2),
    granite-moe folded over (2, 2), mamba2 over (4, 1)), the f32 2-layer
    full-width cut's step under the mesh against the same step on one card
    (loss 1e-5, gradient norm 1e-4 relative, each leaf's gradient shard and
    updated param shard 1e-4 in ||err|| / ||ref||); (2) ``runs`` in bf16,
    MTRAIN_STEPS steps each: losses finite, the kernels' launches exact on
    every rank (``_train_launches``), every step's collectives on every
    rank equal to the dry-run's of that rank (``dryrun_train``: the step on
    meta tensors under a count-only view of the mesh); (3) phase 15 only,
    the checkpoint of ``_mesh_checkpoint``.  Returns the records."""
    import pickle
    import tempfile

    import numpy as np

    from repro_torch.launch.mesh import spawn

    free_model()
    t_phase = time.perf_counter()
    checkpoint = f32_runs is None
    f32_runs = MTRAIN_F32 if f32_runs is None else f32_runs
    runs = MTRAIN_RUNS if runs is None else runs
    with tempfile.TemporaryDirectory() as work:
        spawn(_mesh_train_rank, MESH_RANKS, f"{work}/init", device="cuda",
              args=(work, f32_runs, runs, checkpoint), timeout=MESH_TIMEOUT)
        ranks = [pickle.load(open(f"{work}/rank{r}.pkl", "rb")) for r in range(MESH_RANKS)]
    backend = ranks[0]["backend"]
    records = {"backend": backend, "f32": {}, "runs": {}}
    for arch, shape, b, s, *_ in f32_runs:
        worst = {k: max(r["f32"][arch][k] for r in ranks)
                 for k in ("grad_rel", "param_rel", "start_rel")}
        rank0 = ranks[0]["f32"][arch]
        for r, rank in enumerate(ranks):
            got = rank["f32"][arch]
            what = f"{tag}: {arch} x{got['layers']} f32 over {shape}, rank {r}"
            lr = abs(got["loss"] - got["ref_loss"]) / abs(got["ref_loss"])
            gr = abs(got["gnorm"] - got["ref_gnorm"]) / abs(got["ref_gnorm"])
            if not (lr <= MTRAIN_LOSS_RTOL and gr <= MTRAIN_GNORM_RTOL
                    and got["grad_rel"] <= MTRAIN_GRAD_REL and got["zero_ok"]
                    and got["param_rel"] <= MTRAIN_PARAM_REL
                    and got["start_rel"] <= MTRAIN_PARAM_REL):
                raise AssertionError(f"{what}: loss {got['loss']!r} vs {got['ref_loss']!r}, "
                                     f"grad norm {got['gnorm']!r} vs {got['ref_gnorm']!r}, "
                                     f"grad shards {got['grad_rel']:.3e}, params "
                                     f"{got['param_rel']:.3e} (worst leaves "
                                     f"{got['worst_leaves']}), "
                                     f"zeros held {got['zero_ok']}, "
                                     f"elements at eps {got['at_eps']}")
            expect_counts(what, got["counts"],
                          _train_launches(_mesh_train_cfg(arch, got["layers"]), 1))
        records["f32"][arch] = {"mesh": shape, "batch": (b, s), **worst,
                                **{k: rank0[k] for k in ("loss", "ref_loss", "gnorm", "at_eps",
                                                         "ref_gnorm")}}
        log(f"{tag} ({card}; {backend}): {arch} x{rank0['layers']} f32 over {shape}, "
            f"{b} x {s}: one step, loss {rank0['loss']!r} (one card {rank0['ref_loss']!r}), "
            f"grad norm {rank0['gnorm']!r} (one card {rank0['ref_gnorm']!r}); worst over "
            f"ranks ||err||/||ref|| of a gradient shard {worst['grad_rel']:.3e}, of an "
            f"updated param shard {worst['param_rel']:.3e} (limits {MTRAIN_GRAD_REL}, "
            f"{MTRAIN_PARAM_REL}); {sum(x['elements'] for x in rank0['at_eps'])} elements "
            f"of {len(rank0['at_eps'])} leaves at AdamW's eps on rank 0, their start p + lr * "
            f"step within {worst['start_rel']:.3e} over ranks (limit {MTRAIN_PARAM_REL}); "
            f"those whose params differ by more: "
            + "; ".join(f"{x['leaf']} {x['elements']} of {x['of']}, params "
                        f"{x['param_rel']:.3e}, start {x['start_rel']:.3e}"
                        for x in rank0["at_eps"] if x["param_rel"] > MTRAIN_PARAM_REL))
    for name, arch, layers, shape, b, s in runs:
        got = ranks[0]["runs"][name]
        L = got["layers"]
        for r, rank in enumerate(ranks):
            run = rank["runs"][name]
            if not all(np.isfinite(run["losses"])):
                raise AssertionError(f"{tag}: {name} rank {r}: losses {run['losses']}")
            expect_counts(f"{tag}: {name} over {shape}, {MTRAIN_STEPS} steps, rank {r}",
                          run["counts"], _train_launches(_mesh_train_cfg(arch, L), MTRAIN_STEPS))
            for i, c in enumerate(run["collectives"]):
                if c != run["dryrun"]["collectives"]:
                    raise AssertionError(f"{tag}: {name} rank {r} step {i}: collectives "
                                         f"{c} != the dry-run's {run['dryrun']['collectives']}")
        step_s = sorted(got["step_s"][1:])[len(got["step_s"][1:]) // 2]
        peak = [rank["runs"][name]["peak_gb"] for rank in ranks]
        # the dry-run's arguments + temporaries of each rank's step beside the
        # card's peaks (the whole run's, and the steps' own after the state was
        # built); held to no ratio, recorded
        memory = []
        for r, rank in enumerate(ranks):
            run = rank["runs"][name]
            counted = (run["dryrun"]["argument_bytes"] + run["dryrun"]["temp_bytes"]) / 1e9
            memory.append({"rank": r, "dryrun_gb": counted,
                           "argument_gb": run["dryrun"]["argument_bytes"] / 1e9,
                           "temp_gb": run["dryrun"]["temp_bytes"] / 1e9,
                           "peak_gb": run["peak_gb"], "steps_peak_gb": run["steps_peak_gb"],
                           "peak_over_dryrun": run["peak_gb"] / counted})
            log(f"{tag} ({card}): {name} over {shape}, {b} x {s}, rank {r}: dry-run "
                f"arguments + temporaries {counted:.4f} GB "
                f"({run['dryrun']['argument_bytes']} + {run['dryrun']['temp_bytes']} B); "
                f"measured max_memory_allocated {run['peak_gb']:.4f} GB (the steps alone "
                f"{run['steps_peak_gb']:.4f} GB); peak / dry-run "
                f"{run['peak_gb'] / counted:.4f}")
        records["runs"][name] = {
            "mesh": shape, "batch": (b, s), "layers": L, "losses": got["losses"],
            "step_s": step_s, "first_step_s": got["step_s"][0], "tokens_per_s": b * s / step_s,
            "peak_gb": peak, "memory_vs_dryrun": memory, "state_gb": got["state_gb"],
            "build_s": got["build_s"],
            "counts": got["counts"], "collectives": got["collectives"][-1],
            "wire_bytes": got["wire_bytes"], "dryrun_s": got["dryrun_s"]}
        log(f"{tag} ({card}; {backend}, {MESH_RANKS} ranks): {name} over "
            f"{dict(zip(('data', 'model'), shape))}, bf16, {b} x {s}, remat: losses "
            f"{got['losses']}; step {step_s:.4f} s (median of steps 2-{MTRAIN_STEPS}; first "
            f"{got['step_s'][0]:.4f} s), {b * s / step_s:.0f} tokens/s; peak per rank "
            f"{[round(x, 2) for x in peak]} GB, train state {got['state_gb']:.2f} GB a rank "
            f"(built rank by rank in {got['build_s']:.1f} s); launches per rank "
            f"{got['counts']}; collectives of a step per rank, equal to the dry-run's "
            f"(counted in {got['dryrun_s']:.1f} s): {got['collectives'][-1]}; on the wire by "
            f"the ring model (hlo_analysis), forward {got['wire_bytes']['forward']:.0f} B, "
            f"backward {got['wire_bytes']['backward']:.0f} B")
    if checkpoint:
        ck = [rank["ckpt"] for rank in ranks]
        if ck[0]["resumed"] != ck[0]["losses"][2:] or not ck[0]["leaves_equal"]:
            raise AssertionError(f"{tag}: checkpoint: resumed {ck[0]['resumed']} vs "
                                 f"{ck[0]['losses'][2:]}, global leaves equal "
                                 f"{ck[0]['leaves_equal']}")
        records["ckpt"] = {k: ck[0][k] for k in ck[0]}
        log(f"{tag}: yi-9b x{MTRAIN_F32_LAYERS} f32 through launch.train.run_rank over "
            f"{MTRAIN_CKPT[0]}: losses {ck[0]['losses']}; checkpoint at step 2 "
            f"({ck[0]['checkpoint_gb']:.2f} GB, the run with its save {ck[0]['run_s']:.1f} s); "
            f"--resume (with its restore {ck[0]['resume_s']:.1f} s) gave {ck[0]['resumed']} = "
            f"step 3's bit for bit; restored under {MTRAIN_CKPT[1]} in "
            f"{ck[0]['restore_other_s']:.1f} s, its {ck[0]['leaves']} global leaves gathered "
            f"equal to one card's restore bit for bit")
    log(f"{tag}: {time.perf_counter() - t_phase:.1f}s")
    return records


# ----------------------------------------------------------- phase 16
def mesh16_runs_spec(seed=16):
    """Phase 16's serving runs: (name, config, mesh shape, dtype, prompt
    batches, logits tolerance).  mamba2-780m, hymba-1.5b (past its window),
    whisper-large-v3 over seeded frames and llava-next-mistral-7b with
    seeded image embeddings at their full configs over (1, 4) in bf16
    (M16_SERVE); then each at full width in f32, cut to M16_F32_LAYERS but
    mamba2 (whole).  mamba2's bf16 tolerance is the name of its f32 run:
    ``phase_mesh`` derives it from the two single-card runs (M16_ROUNDING)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import prompt_batch

    runs = []
    for f32 in (False, True):
        for arch, (b, n) in M16_SERVE.items():
            cfg = get_config(arch)
            mamba2 = arch == "mamba2-780m"
            batches = [prompt_batch(cfg, b, n, seed=s)
                       for s in (M16_MAMBA2_SEEDS if mamba2 else (seed,))]
            if f32 and not mamba2:
                cut = {"num_layers": M16_F32_LAYERS}
                if cfg.is_encoder_decoder:
                    cut["encoder_layers"] = M16_F32_LAYERS
                cfg = dataclasses.replace(cfg, **cut)
            if f32:
                tol = MESH_LOGIT_TOL["float32"]
            else:
                tol = f"{arch} x{cfg.num_layers} f32" if mamba2 else MESH_LOGIT_TOL["bfloat16"]
            runs.append((f"{arch} x{cfg.num_layers} f32" if f32 else arch, cfg, (1, 4),
                         torch.float32 if f32 else torch.bfloat16, batches, tol))
    return runs


def phase_mesh16(card):
    """Phase 16: the SSM, hybrid, encoder-decoder and VLM families under a
    mesh of MESH_RANKS spawned ranks.  Serving over (1, 4) as phase 14
    (``phase_mesh`` on ``mesh16_runs_spec``): logits and tokens against one
    card under the margin rule, each rank's launches exact, each rank's
    collectives equal to the dry-run's; the f32 cuts' compared tokens all
    equal.  Training over (2, 2) as phase 15 (``phase_mesh_train`` on
    M16_TRAIN_F32 and M16_TRAIN).  Returns both phases' records."""
    t0 = time.perf_counter()
    serve = phase_mesh(card, mesh16_runs_spec(), "phase 16 serving")
    train = phase_mesh_train(card, M16_TRAIN_F32, M16_TRAIN, "phase 16 training")
    log(f"phase 16: {time.perf_counter() - t0:.1f}s")
    return {"serve": serve, "train": train}


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
    from repro_torch.kernels.ssd_scan.ops import KERNEL_CHUNK, ssd_scan, work
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    x, dt, a, B, C, d_skip = ssd_inputs(gen, dev, 1, s, nh, hd, ns)
    flops, nbytes = work(1, s, nh, hd, ns, 4)
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


def ssd_train_rows(gen, dev):
    """The training path's SSD scan at mamba2-780m's training shape (b = 2,
    s = 4096, f32, chunk 128), one layer: the kernel forward as the
    Function runs it, and the backward (``ssd_scan_backward``: plain torch
    derived by hand, the forward's steps run again from the saved inputs;
    no Pallas counterpart), timed from Python over 5 calls, with the device
    memory it adds at peak, beside the first design
    (``ssd_backward_autograd_recompute``, ``autograd_recompute_ms``; phase
    12 times a whole step with each).  The backward's bound: its
    bytes (x, dt, a, B, C, d_skip, dy and dstate read, the six gradients
    written) at 3.35 TB/s or twice the forward's operations at 495 TFLOP/s
    TF32, whichever is larger.  Plain: autograd through ``ssd_scan_ref``'s
    kept graph (``torch.autograd.grad``).  No library call computes it."""
    import torch

    from repro_torch.kernels.ssd_scan.ops import ssd_flops, ssd_scan, ssd_scan_backward
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    b, s, nh, hd, ns, chunk = 2, 4096, MAMBA["nh"], MAMBA["hd"], MAMBA["ns"], 128
    args = ssd_inputs(gen, dev, b, s, nh, hd, ns)
    dy = torch.randn(b, s, nh, hd, generator=gen, device=dev)
    dstate = torch.randn(b, nh, hd, ns, generator=gen, device=dev)
    in_bytes = sum(t.numel() * 4 for t in args)
    flops = ssd_flops(b, s, nh, hd, ns, chunk)
    shape = f"mamba2-780m train: b={b} s={s} nh={nh} hd={hd} ns={ns} f32, chunk {chunk}"
    fwd = dict(
        ms=time_ms(lambda: ssd_scan(*args, chunk=chunk)),
        call_ms=call_ms(lambda: ssd_scan(*args, chunk=chunk)),
        plain_ms=call_ms(lambda: ssd_scan_ref(*args, chunk=chunk), iters=5, warmup=1),
        library_ms=None,
        bound=bound_ms(in_bytes + args[0].numel() * 4 + dstate.numel() * 4,
                       ssd_flops(b, s, nh, hd, ns, 64), PEAK_TF32_FLOPS),
        shape=f"{shape} (the kernel scans chunks of 64); plain over 5 calls")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bwd_ms = call_ms(lambda: ssd_scan_backward(args, dy, dstate, chunk=chunk), iters=5,
                     warmup=1)
    peak = torch.cuda.max_memory_allocated() - base
    refs = [t.clone().requires_grad_(True) for t in args]
    outs = ssd_scan_ref(*refs, chunk=chunk)
    bwd = dict(
        ms=bwd_ms, call_ms=bwd_ms,
        autograd_recompute_ms=call_ms(
            lambda: ssd_backward_autograd_recompute(args, dy, dstate, chunk=chunk), iters=5,
            warmup=1),
        plain_ms=call_ms(lambda: torch.autograd.grad(outs, refs, (dy, dstate),
                                                     retain_graph=True), iters=5, warmup=1),
        library_ms=None,
        bound=bound_ms(2 * in_bytes + dy.numel() * 4 + dstate.numel() * 4, 2 * flops,
                       PEAK_TF32_FLOPS),
        peak_gb=peak / 1e9,
        shape=f"{shape}: the SSD backward (plain torch derived by hand, the forward's "
              f"steps run again; no Pallas counterpart), timed from Python over 5 calls; "
              f"plain = autograd.grad through ssd_scan_ref's kept graph")
    return {"forward": fwd, "backward": bwd}


def paged_time_row(gen, dev, b, per, ctx_list, what, widths=YI, lse=False):
    """paged_attention at ``widths`` (Yi-9B's by default) over ``ctx_list``
    tokens, bf16; with ``lse`` the call with ``return_lse`` (the call
    without it timed beside it, ``ms_without_lse``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.ops import paged_attention, partitions, work
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
    pages, _ = partitions(b, g, h // g, per, sm_count(dev))
    paged_attention.last_grid = None
    row = dict(
        ms=time_ms(lambda: paged_attention(q, kp, vp, tables, ctx, return_lse=lse)),
        call_ms=call_ms(lambda: paged_attention(q, kp, vp, tables, ctx, return_lse=lse)),
        plain_ms=call_ms(lambda: paged_attention_ref(q, kp, vp, tables, ctx,
                                                     return_lse=lse)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qf, kf, vf, attn_mask=mask)),
        bound=bound_ms(*reversed(work(b, h, g, d, sum(ctx_list), per, 2, lse=lse))))
    if lse:
        row["ms_without_lse"] = time_ms(lambda: paged_attention(q, kp, vp, tables, ctx))
    grid = paged_attention.last_grid  # as the wrapper launched it in the timed calls
    row["grid"] = list(grid)
    row["blocks"] = grid[0] * grid[1] * grid[2]
    row["shape"] = (f"{what}: b={b} h={h} g={g} d={d} bs={bs} ctx={ctx_list} bf16"
                    f"{' with lse' if lse else ''}; grid "
                    f"{grid[0]} x {grid[1]} x {grid[2]} partitions of {pages} pages = "
                    f"{row['blocks']} blocks")
    return row


def prefill_time_row(gen, dev, s, what, plain_iters=50, widths=YI, t=None, causal=True):
    """flash_prefill at ``widths`` (Yi-9B's by default), one layer's
    attention of s queries over t keys (t = s by default), bf16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_prefill.ops import flash_prefill, work
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
    row = dict(
        ms=time_ms(lambda: flash_prefill(qp, kk, vv, causal=causal)),
        call_ms=call_ms(lambda: flash_prefill(qp, kk, vv, causal=causal)),
        plain_ms=call_ms(lambda: dense_ref(qp, kk, vv, causal=causal), iters=plain_iters,
                         warmup=min(3, plain_iters)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal)),
        bound=bound_ms(*reversed(work(1, s, t, h, g, d, 2, causal=causal))),
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
    # phase 14's rank-local slice: 12 pages of 32 a rank at the 8th step of
    # 1024-token prompts (a full slice, a partial one, an empty one)
    rows["paged_attention"]["also"].append(paged_time_row(
        gen, dev, 3, 12, [384, 264, 0], "yi-9b rank-local slice under TP 4", lse=True))
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
    # phase 16's rank-local shapes under (1, 4): whisper's 5 heads a rank (the
    # encoder, a decode step's cross-attention, the split decode with lse),
    # llava's image + text prefill on 8 heads a rank
    w5 = dict(WHISPER, h=5, g=5)
    n16 = M16_SERVE["whisper-large-v3"][1]
    rows["flash_prefill"]["also"] += [
        prefill_time_row(gen, dev, frames, "whisper-large-v3 encoder, a rank of (1, 4)",
                         widths=w5, causal=False, plain_iters=5),
        prefill_time_row(gen, dev, 1, "whisper-large-v3 decode cross-attention, a rank of "
                         "(1, 4)", widths=w5, t=frames, causal=False),
        prefill_time_row(gen, dev, LLAVA["vision"] + M16_SERVE["llava-next-mistral-7b"][1],
                         "llava-next-mistral-7b image + text prefill, a rank of (1, 4)",
                         widths=dict(LLAVA, h=8, g=2), plain_iters=5)]
    rows["paged_attention"]["also"].append(paged_time_row(
        gen, dev, 2, 5, [n16 + MAX_NEW, 0], "whisper-large-v3 rank-local slice under TP 4",
        widths=w5, lse=True))
    rows["flash_prefill"]["training"] = train_time_rows(gen, dev)
    return rows | other_time_rows(gen, dev)


def other_time_rows(gen, dev):
    import torch

    from repro_torch.kernels.kv_pull.ops import kv_pull, kv_pull_dequant, kv_pull_runs
    from repro_torch.kernels.kv_pull.ops import work as pull_work
    from repro_torch.kernels.kv_pull.ref import (
        kv_pull_dequant_ref, kv_pull_ref, kv_pull_runs_ref)

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

    # kv_pull_runs: the same request's 864 pages as 108 runs of RUN_LEN at random
    # run slots; beside it kv_pull over the runs expanded into page ids
    src, dst, ss, ds, sid, did = yi_run_inputs(gen, dev)
    sl, dl = sid.long(), did.long()
    page = src.shape[1]
    flops, nbytes = pull_work(ss.shape[0], page, page, RUN_LEN)
    rows["kv_pull_runs"] = dict(
        ms=time_ms(lambda: kv_pull_runs(src, dst, ss, ds, run_len=RUN_LEN)),
        call_ms=call_ms(lambda: kv_pull_runs(src, dst, ss, ds, run_len=RUN_LEN)),
        plain_ms=call_ms(lambda: kv_pull_runs_ref(src, dst, ss, ds, run_len=RUN_LEN)),
        library_ms=time_ms(lambda: dst.index_copy_(0, dl, src.index_select(0, sl))),
        kv_pull_expanded_ms=time_ms(lambda: kv_pull(src, dst, sid, did)),
        bound=bound_ms(nbytes, flops),
        shape=f"{ss.shape[0]} runs of {RUN_LEN} pages x {page} B (the kv_pull row's "
              f"{sid.shape[0]} pages)")

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
    # phase 16's rank-local shapes under (1, 4): mamba2's 12 heads a rank, and
    # hymba's 50 heads by 16 of head_dim
    rows["ssd_scan"]["also"] += [
        ssd_time_row(gen, dev, M16_SERVE["mamba2-780m"][1], MAMBA["nh"] // 4, MAMBA["hd"],
                     MAMBA["ns"], "mamba2-780m, a rank of (1, 4)"),
        ssd_time_row(gen, dev, M16_SERVE["hymba-1.5b"][1] + HYMBA["meta"], HYMBA["nh"],
                     HYMBA["hd"] // 4, HYMBA["ns"], "hymba-1.5b, a rank of (1, 4)")]
    rows["ssd_scan"]["training"] = ssd_train_rows(gen, dev)
    return rows


SOURCES = {
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:101"),
    "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill/kernel.py:103"),
    "kv_pull": ("src/repro_torch/csrc/kv_pull.cu",
                "src/repro/kernels/kv_pull/kernel.py:68"),
    "kv_pull_runs": ("src/repro_torch/csrc/kv_pull.cu",
                     "src/repro/kernels/kv_pull/kernel.py:128"),
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
    extra = {k: row[k] for k in ("vs_library", "grid", "launch_us", "ms_without_lse",
                                 "kv_pull_expanded_ms") if k in row}
    extra["call_ms"] = row["call_ms"]
    return {"ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": row["library_ms"], "shape": row["shape"], **extra}


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=["all", "14", "15", "16"], default="all",
                    help="14 (15, 16): the build, paged_attention's lse checks (and for 16 "
                         "the rank-local kernel checks) and that phase alone (the mesh "
                         "over every card of the machine)")
    args = ap.parse_args(argv)
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
    lse_err = check_paged_lse(gen, dev)
    if args.phase in ("14", "15", "16"):
        if args.phase == "16":
            check_rank_local(gen, dev)
        phase = {"14": phase_mesh, "15": phase_mesh_train, "16": phase_mesh16}[args.phase]
        log(f"phase {args.phase} records: {json.dumps(phase(card), default=str)}")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    errs = {
        "paged_attention": check_paged_attention(gen, dev),
        "flash_prefill": check_flash_prefill(gen, dev),
        "kv_pull": check_kv_pull(gen, dev),
        "kv_pull_runs": check_kv_pull_runs(gen, dev),
        "kv_pull_dequant": check_kv_pull_dequant(gen, dev),
        "ssd_scan": check_ssd_scan(gen, dev),
    }
    local_errs = check_rank_local(gen, dev)
    flash_lse_err, bwd_err = check_flash_training(gen, dev)
    ssd_grad_err, ssd_bwd_peak = check_ssd_training(gen, dev)
    log(f"phase 2: every kernel matches its plain version; max |err| at full width "
        f"(bf16 for the attention kernels, f32 for ssd_scan) {errs}; "
        f"{time.perf_counter() - t0:.1f}s")

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import greedy_generate
    from repro_torch.models.registry import build_model

    cfg = get_config("yi-9b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    log(f"{cfg.describe()}; weights in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPTS]
    refs = [greedy_generate(model, params, t, MAX_NEW) for t in prompts]
    serve_counts, per_request = phase_serve(model, params, prompts, refs)
    topo_counts = phase_topology(model, params)
    del params, model
    torch.cuda.empty_cache()
    log(f"phases 3-4: {time.perf_counter() - t0:.1f}s with the weights and references")
    runs_counts = phase_pull_runs(gen, dev)

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
    t0 = time.perf_counter()
    ssm_train_counts, ssm_train = phase_train_ssm(dev, card)
    log(f"phase 12: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    example_counts = phase_examples()
    log(f"phase 13: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    mesh_runs = phase_mesh(card)
    log(f"phase 14: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    mesh_train = phase_mesh_train(card)
    log(f"phase 15: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    mesh16 = phase_mesh16(card)
    log(f"phase 16: {time.perf_counter() - t0:.1f}s")
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
        **{f"phase 12 {arch} launch.train, {SSM_TRAIN_STEPS} steps": c
           for arch, c in ssm_train_counts.items()},
        **{f"phase 13 examples/{name}.py": c for name, c in example_counts.items()},
        **{f"phase 14 {run} under mesh {r['mesh']}, each of {MESH_RANKS} ranks": r["counts"]
           for run, r in mesh_runs.items()},
        **{f"phase 15 {run} train under mesh {r['mesh']}, {MTRAIN_STEPS} steps, each of "
           f"{MESH_RANKS} ranks": r["counts"] for run, r in mesh_train["runs"].items()},
        **{f"phase 16 {run} under mesh {r['mesh']}, each of {MESH_RANKS} ranks": r["counts"]
           for run, r in mesh16["serve"].items()},
        **{f"phase 16 {run} train under mesh {r['mesh']}, {MTRAIN_STEPS} steps, each of "
           f"{MESH_RANKS} ranks": r["counts"] for run, r in mesh16["train"]["runs"].items()},
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
        elif name == "kv_pull_runs":
            launches = per = runs_counts[name]
            run = "phase 4b: kv_pull_runs, one yi-9b request's pages in runs of 8"
        else:
            quantized = name == "kv_pull_dequant"
            launches = serve_counts[quantized][name]
            run = "launch.serve" + (" --quantize-transfer" if quantized else "")
            per = per_request[name]
        extra["launches_later_phases"] = {run: c[name] for run, c in later.items()}
        if name == "kv_pull":
            extra["bytes_pulled_llava"] = llava_pulled
        extra["rank_local_max_abs_err"] = local_errs.get(name)
        if name == "paged_attention":
            extra["lse_max_abs_err"] = lse_err
            extra["launches_lse_phase_14"] = {run: r["counts"]["paged_attention_lse"]
                                              for run, r in mesh_runs.items()}
        if name == "ssd_scan":
            tr = row["training"]
            extra["training"] = {
                "forward": timing(tr["forward"]),
                "backward": timing(tr["backward"]) | {
                    "max_rel_err": ssd_grad_err, "peak_gb": tr["backward"]["peak_gb"],
                    "autograd_recompute_ms": tr["backward"]["autograd_recompute_ms"],
                    "mamba2_step_ab": ssm_train["mamba2-780m"]["backward_ab"],
                    "check_peak_gb": ssd_bwd_peak / 1e9,
                    "launches_per_step": "none (plain torch); the forward launches "
                                         "layers x 2 a step under remat"}}
        if name == "flash_prefill":
            tr = row["training"]
            extra["training"] = {
                "forward_lse": timing(tr["forward_lse"])
                | {"ms_without_lse": tr["forward_lse"]["ms_without_lse"],
                   "lse_max_abs_err": flash_lse_err},
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
                + (f"; us a launch (profiler) {r['launch_us']}" if "launch_us" in r else "")
                + (f"; without lse {r['ms_without_lse']:.4f} ms" if "ms_without_lse" in r
                   else "")
                + (f"; kv_pull on the runs' page ids {r['kv_pull_expanded_ms']:.4f} ms"
                   if "kv_pull_expanded_ms" in r else ""))
    tr = rows["flash_prefill"]["training"]
    for what, r in (("forward with lse", tr["forward_lse"]), ("training backward",
                                                             tr["backward"])):
        log(f"phase 5: flash_prefill {what} [{r['shape']}]: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {fmt_ms(r['library_ms'])}, bound "
            f"{r['bound'][0]:.5f} ms by {r['bound'][1]}"
            + (f"; without lse {r['ms_without_lse']:.4f} ms" if "ms_without_lse" in r else ""))
    tr = rows["ssd_scan"]["training"]
    for what, r in (("training forward", tr["forward"]), ("training backward", tr["backward"])):
        log(f"phase 5: ssd_scan {what} [{r['shape']}]: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library none, bound {r['bound'][0]:.5f} ms by "
            f"{r['bound'][1]}" + (f"; peak {r['peak_gb']:.2f} GB above its inputs; the "
                                  f"plain forward again under autograd "
                                  f"{r['autograd_recompute_ms']:.4f} ms"
                                  if "peak_gb" in r else ""))
    for arch, n in ssm_train.items():
        log(f"phase 12 summary ({card}): {arch} step {n['step_s']:.4f} s, "
            f"{n['tokens_per_s']:.0f} tokens/s, peak {n['peak_gb']:.2f} GB")
    ab = ssm_train["mamba2-780m"]["backward_ab"]
    log(f"phase 12 summary ({card}): mamba2-780m step, SSD backward derived by hand "
        f"{ab['chosen_step_s']:.4f} s vs autograd recompute "
        f"{ab['autograd_recompute_step_s']:.4f} s (same call)")
    log(f"phase 11 summary ({card}): granite-moe step {granite_train['step_s']:.4f} s, "
        f"{granite_train['tokens_per_s']:.0f} tokens/s, peak {granite_train['peak_gb']:.2f} GB; "
        f"yi-9b x{YI_TRAIN_LAYERS} layers step {yi_train['step_s']:.4f} s, "
        f"{yi_train['tokens_per_s']:.0f} tokens/s, peak {yi_train['peak_gb']:.2f} GB")
    log(f"all phases in {time.perf_counter() - t_start:.1f}s")
    log(f"phase 14 records: {json.dumps(mesh_runs, default=str)}")
    log(f"phase 15 records: {json.dumps(mesh_train, default=str)}")
    log(f"phase 16 records: {json.dumps(mesh16, default=str)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
