"""The layer kernels (``kernels/{rmsnorm,rope,silu_mul}``, one source
``csrc/norm_rope_act.cu``) against their plain versions, on the card only
(marked ``cuda``; each test skips without a GPU):

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_layer_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
lacks; this file imports only torch and the port.)

* Each kernel within one place of the output dtype of its plain version
  at both cells' widths, decode and prefill rows, and off the 16-byte grid
  (the order of the f32 sum of squares, and libm, may differ; f32 outputs,
  whose place is finer than that order's effect, within 1e-5 relative).
  The residual sum is exact.  Dtypes the kernels lack raise.
* A decode step at Yi-9B's and granite's widths (two layers) replayed as
  CUDA graphs: the same greedy tokens and logits within 1e-2 (norm of the
  difference over the norm) as the step with the plain versions in place.
* The launch counters advance at capture and in an eager prefill; a
  replayed Yi-9B middle piece runs 4 kernels besides its GEMMs.
"""
import dataclasses
import re

import pytest
import torch

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.rmsnorm.ref import add_rmsnorm_ref, rmsnorm_ref
from repro_torch.kernels.rope import ops as rope_ops
from repro_torch.kernels.rope.ref import rope_ref
from repro_torch.kernels.silu_mul import ops as silu_ops
from repro_torch.kernels.silu_mul.ref import silu_mul_ref
from repro_torch.models import attention, layers, moe, transformer

DTYPES = [torch.bfloat16, torch.float32]
F32_RTOL = 1e-5
GEMM_NAMES = ("gemm", "gemv", "nvjet", "splitk", "cutlass", "xmma")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, dtype, scale=1.0, offset=0):
    """Values of ``shape``; with ``offset``, a view that starts ``offset``
    elements into its storage (off the 16-byte grid)."""
    n = 1
    for s in shape:
        n *= s
    flat = torch.randn(n + offset, generator=gen, device="cuda").mul(scale).to(dtype)
    return flat[offset:].view(*shape)


def places(out, ref) -> float:
    o, r = out.double(), ref.double()
    mag = torch.maximum(o.abs(), r.abs()).clamp_min(torch.finfo(out.dtype).tiny)
    ulp = torch.finfo(out.dtype).eps * torch.exp2(torch.floor(torch.log2(mag)))
    return float(((o - r).abs() / ulp).max())


def assert_within_a_place(out, ref):
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=F32_RTOL, atol=1e-6)
    else:
        assert places(out, ref) <= 1


SHAPES = [(1, 4096), (4, 4096), (32, 4096), (257, 4096), (4, 1536), (257, 1536), (2, 5, 1536),
          (3, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(gen, dtype, shape, offset):
    d = shape[-1]
    x = randn(gen, *shape, dtype=dtype, scale=3.0, offset=offset)
    res = randn(gen, *shape, dtype=dtype)
    scale = randn(gen, d, dtype=dtype)
    assert_within_a_place(rmsnorm_ops.rmsnorm(x, scale, 1e-5), rmsnorm_ref(x, scale, 1e-5))
    total, out = rmsnorm_ops.add_rmsnorm(x, res, scale, 1e-6)
    want_total, want = add_rmsnorm_ref(x, res, scale, 1e-6)
    assert torch.equal(total, want_total)
    assert_within_a_place(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(1, 1), (4, 1), (32, 1), (1, 257), (2, 70)])
@pytest.mark.parametrize("widths", [(32, 4, 128), (24, 8, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(gen, dtype, widths, lead):
    """Decode rows (a token a row, int32 positions up to 4096) and prefill
    rows (int64 positions broadcast over the batch, as ``prefill`` makes
    them)."""
    h, g, hd = widths
    q = randn(gen, *lead, h, hd, dtype=dtype)
    k = randn(gen, *lead, g, hd, dtype=dtype)
    if lead[1] == 1:
        pos = torch.randint(0, 4097, lead, generator=gen, device="cuda", dtype=torch.int32)
    else:
        pos = (torch.arange(lead[1], device="cuda") + 4096 - lead[1])[None].expand(*lead)
    for theta in (1e4, 5e6):
        rq, rk = rope_ops.rope(q, k, pos, theta)
        assert_within_a_place(rq, rope_ref(q, pos, theta))
        assert_within_a_place(rk, rope_ref(k, pos, theta))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(1, 11008), (4, 11008), (257, 11008), (48, 4, 512),
                                   (48, 32, 512), (3, 1001)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_silu_mul(gen, dtype, shape, offset):
    a = randn(gen, *shape, dtype=dtype, scale=4.0, offset=offset)
    b = randn(gen, *shape, dtype=dtype)
    assert_within_a_place(silu_ops.silu_mul(a, b), silu_mul_ref(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, "mixed"])
def test_dtypes_the_kernels_lack_raise(gen, dtype):
    """float16, float64 and a call's tensors in two dtypes raise instead of
    taking the plain version; so do float positions."""
    x, res, q, k = (randn(gen, *s, dtype=torch.bfloat16) for s in
                    ((4, 256), (4, 256), (4, 1, 8, 64), (4, 1, 2, 64)))
    scale = randn(gen, 256, dtype=torch.bfloat16)
    pos = torch.arange(4, device="cuda", dtype=torch.int32)[:, None]
    if dtype == "mixed":
        res, scale, k = res.float(), scale.float(), k.float()
    else:
        x, res, scale, q, k = (t.to(dtype) for t in (x, res, scale, q, k))
    before = counts()
    for call in (lambda: rmsnorm_ops.rmsnorm(x, scale, 1e-5),
                 lambda: rmsnorm_ops.add_rmsnorm(x, res, scale, 1e-5),
                 lambda: rope_ops.rope(q, k, pos, 1e4), lambda: silu_ops.silu_mul(x, res)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError):
        rope_ops.rope(q.bfloat16(), q.bfloat16()[:, :, :2], pos.float(), 1e4)
    assert counts() == before


# ------------------------------------------------------ in the decode step
def use_plain_versions(mp):
    mp.setattr(rmsnorm_ops, "rmsnorm", rmsnorm_ref)
    mp.setattr(rmsnorm_ops, "add_rmsnorm", add_rmsnorm_ref)
    rope_qk = (lambda q, k, pos, theta: (rope_ref(q, pos, theta), rope_ref(k, pos, theta)))
    mp.setattr(attention, "rope_qk", rope_qk)
    mp.setattr(transformer, "rope_qk", rope_qk)
    mp.setattr(layers, "silu_mul", silu_mul_ref)
    mp.setattr(moe, "silu_mul", silu_mul_ref)


def _model(arch):
    """``arch`` at its full widths cut to 2 layers (MoE at capacity_factor
    E / k, as served), its weights on the card."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    model = transformer.DecoderLM(cfg, device="cuda")
    return model, model.init_params(seed=0)


# the wrappers, kept: their counters stay readable while the plain versions
# stand in for them
WRAPPERS = {"rmsnorm": rmsnorm_ops.rmsnorm, "add_rmsnorm": rmsnorm_ops.add_rmsnorm,
            "rope": rope_ops.rope, "silu_mul": silu_ops.silu_mul}


def counts():
    return {name: op.launches for name, op in WRAPPERS.items()}


def since(before):
    return {k: v - before[k] for k, v in counts().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-3b-a800m"])
def test_a_replayed_decode_step_matches_the_plain_step(gen, arch, monkeypatch):
    """8 steps of 5 sequences (bucket 8) through ``DecodeGraphs``, with the
    kernels and with the plain versions in their place.  With the kernels
    the counters advance at the prefill (3 norms, 2 norms with their add,
    2 RoPEs, 2 activations for 2 layers) and at the capture (a warm-up and
    a capture of each piece of each of the 7 buckets), and not at a
    replay."""
    from repro_torch.models.decode_graph import BUCKETS, DecodeGraphs

    model, params = _model(arch)
    vocab = model.cfg.vocab_size
    prompts = torch.randint(0, vocab, (5, 70), generator=gen, device="cuda")

    def run(check_counts):
        before = counts()
        logits, state = model.prefill(params, {"tokens": prompts}, max_blocks_margin=2)
        if check_counts:
            assert since(before) == {"rmsnorm": 3, "add_rmsnorm": 2, "rope": 2, "silu_mul": 2}
        tok = transformer.greedy_tokens(logits, vocab)
        graphs = DecodeGraphs(model, params)
        toks, lgs = [tok.tolist()], []
        for i in range(8):
            before = counts()
            tok, state, mode = graphs.step(state, tok)
            assert mode == ("capture" if i == 0 else "replay")
            if check_counts:
                n = 2 * len(BUCKETS) if i == 0 else 0
                assert since(before) == {"rmsnorm": n, "add_rmsnorm": 4 * n, "rope": 2 * n,
                                         "silu_mul": 2 * n}
            toks.append(tok.tolist())
            lgs.append(graphs.sets[graphs.key(5)].outs[-1][0][:5].float().clone())
        torch.cuda.synchronize()
        return toks, lgs

    got = run(True)
    with monkeypatch.context() as mp:
        use_plain_versions(mp)
        before = counts()
        want = run(False)
        assert since(before) == dict.fromkeys(before, 0)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        assert float((a - b).norm() / b.norm()) < 1e-2


@pytest.mark.cuda
def test_a_replayed_middle_piece_runs_four_kernels_besides_its_gemms(gen):
    """Yi-9B's piece 1 (layer 0's o, residual and FFN, layer 1's norm, q,
    k, v and RoPE): two norms with their adds, the activation and the RoPE,
    each one launch; every other kernel a GEMM's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.decode_graph import DecodeGraphs

    model, params = _model("yi-9b")
    vocab = model.cfg.vocab_size
    prompts = torch.randint(0, vocab, (4, 40), generator=gen, device="cuda")
    logits, state = model.prefill(params, {"tokens": prompts}, max_blocks_margin=2)
    graphs = DecodeGraphs(model, params)
    graphs.step(state, transformer.greedy_tokens(logits, vocab))
    piece = graphs.sets[graphs.key(4)].graphs[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        piece.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    others = [n for n in names if not any(g in n.lower() for g in GEMM_NAMES)]
    ours = sorted(m.group(1) for n in others
                  if (m := re.search(r"(rmsnorm_kernel|rope_kernel|silu_mul_kernel)", n)))
    assert len(names) - len(others) >= 7, names       # o, gate, up, down, q, k, v
    assert len(others) == 4 and ours == ["rmsnorm_kernel", "rmsnorm_kernel", "rope_kernel",
                                         "silu_mul_kernel"], others
