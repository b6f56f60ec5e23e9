"""The port's CUDA kernels against their plain PyTorch versions, on the
card only (marked ``cuda``; each test skips without a GPU).  Run on a
machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
lacks; this file imports only torch and the port.)  Tolerances as in
tests/test_kernels.py: f32 2e-4, bf16 2e-2; the copies are exact.
"""
import pytest
import torch

from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.kernels.flash_prefill.ref import dense_ref
from repro_torch.kernels.kv_pull.ops import kv_pull, kv_pull_dequant
from repro_torch.kernels.kv_pull.ref import kv_pull_dequant_ref, kv_pull_ref
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,g,d,per,bs", [
    (2, 4, 2, 64, 4, 32), (3, 8, 1, 128, 3, 32), (1, 8, 8, 64, 5, 16), (3, 32, 4, 128, 9, 32),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention(gen, b, h, g, d, per, bs, dtype):
    q, kp, vp = randn(gen, b, h, d, dtype=dtype), randn(gen, b, per, bs, g, d, dtype=dtype), \
        randn(gen, b, per, bs, g, d, dtype=dtype)
    tbl = torch.stack([torch.randperm(per, generator=gen, device="cuda")
                       for _ in range(b)]).to(torch.int32)
    ctx = torch.randint(1, per * bs + 1, (b,), generator=gen, device="cuda").to(torch.int32)
    out = paged_attention(q, kp, vp, tbl, ctx)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), paged_attention_ref(q, kp, vp, tbl, ctx).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,g,d", [(256, 4, 2, 64), (128, 8, 8, 32), (130, 32, 4, 128),
                                     (1, 4, 2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_causal(gen, s, h, g, d, dtype):
    q, k, v = randn(gen, 2, s, h, d, dtype=dtype), randn(gen, 2, s, g, d, dtype=dtype), \
        randn(gen, 2, s, g, d, dtype=dtype)
    out = flash_prefill(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), dense_ref(q, k, v, causal=True).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(causal=True, sliding_window=64, prefix_len=16),
                                dict(causal=False)])
def test_flash_prefill_window_and_non_causal(gen, kw):
    q, k, v = randn(gen, 1, 200, 4, 32), randn(gen, 1, 200, 2, 32), randn(gen, 1, 200, 2, 32)
    torch.testing.assert_close(flash_prefill(q, k, v, **kw), dense_ref(q, k, v, **kw),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8, torch.uint8])
def test_kv_pull_exact_and_in_place(gen, dtype):
    src = torch.randint(0, 100, (12, 16, 2, 32), generator=gen, device="cuda").to(dtype)
    dst = torch.randint(0, 100, (10, 16, 2, 32), generator=gen, device="cuda").to(dtype)
    sid = torch.tensor([0, 5, 11, 3], dtype=torch.int32, device="cuda")
    did = torch.tensor([9, 1, 4, 0], dtype=torch.int32, device="cuda")
    keep = dst.clone()
    out = kv_pull(src, dst.clone(), sid, did)
    assert torch.equal(out, kv_pull_ref(src, dst.clone(), sid, did))
    untouched = [i for i in range(10) if i not in (9, 1, 4, 0)]
    assert torch.equal(out[untouched], keep[untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_pull_dequant_exact(gen, dtype):
    src = torch.randint(-127, 128, (12, 16, 2, 32), generator=gen, device="cuda",
                        dtype=torch.int8)
    dst = randn(gen, 10, 16, 2, 32, dtype=dtype)
    sid = torch.tensor([0, 5, 11, 3], dtype=torch.int32, device="cuda")
    did = torch.tensor([9, 1, 4, 0], dtype=torch.int32, device="cuda")
    sc = torch.tensor([0.013, 1.0, 0.5, 0.0021], device="cuda")
    assert torch.equal(kv_pull_dequant(src, dst.clone(), sid, did, sc),
                       kv_pull_dequant_ref(src, dst.clone(), sid, did, sc))
