"""The port's CUDA kernels against their plain PyTorch versions, on the
card only (marked ``cuda``; each test skips without a GPU).  Run on a
machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
lacks; this file imports only torch and the port.)  Tolerances as in
tests/test_kernels.py: f32 2e-4, bf16 2e-2, ssd_scan f32 1e-3; the
copies are exact.  The long bf16 cases also hold ||out - ref|| / ||ref||
under 1e-2 (their outputs, about 0.02, are near the bf16 atol).
"""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill import ops as flash_ops
from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.kernels.flash_prefill.ref import dense_ref
from repro_torch.kernels.kv_pull.ops import kv_pull, kv_pull_dequant, kv_pull_runs
from repro_torch.kernels.kv_pull.ref import kv_pull_dequant_ref, kv_pull_ref, kv_pull_runs_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ops import paged_attention, partitions
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
REL_NORM_BF16 = 1e-2


def rel_norm(out, ref):
    return float((out.float() - ref.float()).norm() / ref.float().norm())


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


def sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


def paged_case(gen, b, h, g, d, per, bs, ctx, dtype):
    q, kp, vp = randn(gen, b, h, d, dtype=dtype), randn(gen, b, per, bs, g, d, dtype=dtype), \
        randn(gen, b, per, bs, g, d, dtype=dtype)
    tbl = torch.stack([torch.randperm(per, generator=gen, device="cuda")
                       for _ in range(b)]).to(torch.int32)
    ctx = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    out = paged_attention(q, kp, vp, tbl, ctx)
    torch.cuda.synchronize()
    ref = paged_attention_ref(q, kp, vp, tbl, ctx)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["one token", "partition edge", "edge + 1", "ragged"])
def test_paged_attention_split_partitions(gen, dtype, where):
    """Several pages per partition (b = 8 leaves fewer partitions than
    pages), empty trailing partitions, ctx = 1 and ctx on a partition edge."""
    b, h, g, d, per, bs = 8, 32, 4, 128, 40, 16
    pages, n_part = partitions(b, g, h // g, per, sm_count())
    assert pages > 1 and n_part > 1
    edge = pages * bs
    ctx = {"one token": [1] * b, "partition edge": [edge, 2 * edge] * (b // 2),
           "edge + 1": [edge + 1, 1, per * bs, 2 * edge - 1] * (b // 4),
           "ragged": [1 + 73 * i % (per * bs) for i in range(b)]}[where]
    paged_case(gen, b, h, g, d, per, bs, ctx, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("h,g,d", [(10, 2, 64), (32, 2, 32), (4, 4, 128), (8, 2, 8),
                                   (8, 2, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_head_groups(gen, h, g, d, dtype):
    """h/g = 5 (a partial block of heads), 16 (two blocks of 8 heads), 1;
    the smoke configs' d = 8 and d = 16."""
    paged_case(gen, 3, h, g, d, 6, 16, [5, 96, 41], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_long_context(gen, dtype):
    """Yi-9B widths at b = 8 and 4096 tokens each (the phase-5 row)."""
    out, ref = paged_case(gen, 8, 32, 4, 128, 128, 32, [4096] * 8, dtype)
    if dtype == torch.bfloat16:
        assert rel_norm(out, ref) <= REL_NORM_BF16


@pytest.mark.cuda
def test_paged_attention_yi_grid(gen):
    """At Yi-9B b = 3 (11 pages of 32) the split kernel launches at least
    96 blocks, as the wrapper records its grid."""
    paged_case(gen, 3, 32, 4, 128, 11, 32, [104, 138, 265], torch.bfloat16)
    x, y, z = paged_attention.last_grid
    assert (x, y) == (4, 3) and x * y * z >= 96


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_whisper_mha(gen, dtype):
    """whisper-large-v3's decode: h = g = 20 (one query head a kv-head, a
    block of 8 head slots with 7 masked), d = 64; contexts of its prompts
    4, 33 and 130 after 8 steps."""
    paged_case(gen, 3, 20, 20, 64, 21, 32, [12, 41, 138], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_maverick_gqa(gen, dtype):
    """llama4-maverick's decode: h/g = 40/8 (5 query heads a kv-head) at
    d = 128, its 96-token prompt after 8 steps in 3 + 16 pages of 32."""
    paged_case(gen, 1, 40, 8, 128, 19, 32, [104], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,g,d,per,bs,ctx", [
    (2, 8, 2, 64, 3, 32, [5, 70]),                       # one partition
    (8, 32, 4, 128, 40, 16, [1, 640, 17, 300, 0, 639, 630, 2]),  # several, one empty
    (2, 8, 2, 64, 3, 32, [0, 0]),                        # contexts of 0
    (3, 32, 4, 128, 12, 32, [384, 264, 0]),              # a rank's slice under TP 4
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_lse(gen, b, h, g, d, per, bs, ctx, dtype):
    """``return_lse``: the output as without it, lse [b, h] f32 as the
    plain version's; a context of 0 gives out 0 and lse -inf, no NaN."""
    q, kp, vp = randn(gen, b, h, d, dtype=dtype), randn(gen, b, per, bs, g, d, dtype=dtype), \
        randn(gen, b, per, bs, g, d, dtype=dtype)
    tbl = torch.arange(per, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
    ctx = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    out, lse = paged_attention(q, kp, vp, tbl, ctx, return_lse=True)
    ref, ref_lse = paged_attention_ref(q, kp, vp, tbl, ctx, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, paged_attention(q, kp, vp, tbl, ctx))
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    empty = ctx == 0
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    assert torch.isneginf(lse[empty]).all() and not torch.isnan(lse).any()
    assert torch.equal(out[empty], torch.zeros_like(out[empty]))
    torch.testing.assert_close(lse[~empty], ref_lse[~empty], atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("name,design", [("paged_attention", paged_ops.DESIGN),
                                         ("flash_prefill", flash_ops.DESIGN),
                                         ("ssd_scan", ssd_ops.DESIGN)])
def test_wrappers_model_the_compiled_design(gen, name, design):
    build.check_design(name, design)


@pytest.mark.cuda
def test_paged_attention_rejects_other_head_dims(gen):
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(randn(gen, 1, 4, 48), randn(gen, 1, 2, 16, 2, 48),
                        randn(gen, 1, 2, 16, 2, 48),
                        torch.zeros(1, 2, dtype=torch.int32, device="cuda"),
                        torch.ones(1, dtype=torch.int32, device="cuda"))


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


def prefill_case(gen, b, s, h, g, d, dtype, **kw):
    q, k, v = randn(gen, b, s, h, d, dtype=dtype), randn(gen, b, s, g, d, dtype=dtype), \
        randn(gen, b, s, g, d, dtype=dtype)
    out = flash_prefill(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = dense_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 130, 257])
def test_flash_prefill_bf16_tensor_cores(gen, d, s):
    prefill_case(gen, 2, s, 8, 2, d, torch.bfloat16, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_hymba_window_prefix(gen, dtype):
    """hymba-1.5b: h/g = 25/5, window 1024, 128 meta tokens, 1200 + 128."""
    prefill_case(gen, 1, 1328, 25, 5, 64, dtype, causal=True, sliding_window=1024,
                 prefix_len=128)


@pytest.mark.cuda
def test_flash_prefill_bf16_long(gen):
    """Yi-9B widths at 4096 tokens (the phase-5 row)."""
    out, ref = prefill_case(gen, 1, 4096, 32, 4, 128, torch.bfloat16, causal=True)
    assert rel_norm(out, ref) <= REL_NORM_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(causal=False), dict(causal=True, sliding_window=100),
                                dict(causal=False, sliding_window=70, prefix_len=9)])
def test_flash_prefill_bf16_masks(gen, kw):
    prefill_case(gen, 2, 333, 4, 2, 64, torch.bfloat16, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,g,d", [(96, 40, 8, 128), (4, 20, 20, 64), (33, 20, 20, 64),
                                     (130, 20, 20, 64)])
def test_flash_prefill_main_path_prompts(gen, s, h, g, d, dtype):
    """The causal prompts of llama4-maverick (96 tokens, h/g = 40/8 at
    d = 128) and of whisper's decoder (4, 33 and 130 tokens, MHA 20/20 at
    d = 64), at b = 1 as the main path runs them."""
    prefill_case(gen, 1, s, h, g, d, dtype, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(20, 64), (16, 128)])
@pytest.mark.parametrize("s", [1500, 33, 1, 130, 4])
def test_flash_prefill_non_causal_over_1500_keys(gen, s, h, d, dtype):
    """whisper's encoder (s = t = 1500) and its cross-attention at prefill
    (s = 4, 33, 130, its decoder prompts) and at a decode step (s = 1):
    non-causal, s != t, and t = 1500 not a multiple of the 64-row tile."""
    q = randn(gen, 1, s, h, d, dtype=dtype)
    k, v = randn(gen, 1, 1500, h, d, dtype=dtype), randn(gen, 1, 1500, h, d, dtype=dtype)
    out = flash_prefill(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), dense_ref(q, k, v, causal=False).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_apply_on_the_card_matches_its_cpu_run(gen, dtype):
    """granite-moe-3b-a800m's MoE layer at full width (d 1536, 40 experts
    top-8 padded to 48, ff 512) on 96 tokens (3 groups of 32): the card's
    routing equals the CPU's, the outputs agree (f32 2e-4, bf16 2e-2)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("granite-moe-3b-a800m")
    p = moe.moe_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    p = {k: ({kk: vv.to(dtype) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dtype))
         for k, v in p.items()}
    x = randn(gen, 1, 96, cfg.d_model, dtype=dtype)
    out, aux = moe.moe_apply(p, x, cfg)
    torch.cuda.synchronize()
    p_cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
             for k, v in p.items()}
    ref, ref_aux = moe.moe_apply(p_cpu, x.cpu(), cfg)
    cap = moe.capacity(32, cfg.experts_per_token, cfg.num_experts, cfg.capacity_factor)
    r = moe.moe_route(p, x.reshape(3, 32, -1), cfg, cap)
    r_cpu = moe.moe_route(p_cpu, x.cpu().reshape(3, 32, -1), cfg, cap)
    assert torch.equal(r.top_idx.cpu(), r_cpu.top_idx) and torch.equal(r.keep.cpu(), r_cpu.keep)
    assert int(r.top_idx.max()) < cfg.num_experts
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(aux.cpu(), ref_aux, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_flash_prefill_bf16_rejects_other_head_dims(gen):
    """Head dims above 128 have no kernel (96 and the smoke configs' 8 now
    run the f32 kernel: test_flash_prefill_bf16_small_head_dims)."""
    q, k = randn(gen, 1, 16, 2, 160, dtype=torch.bfloat16), \
        randn(gen, 1, 16, 1, 160, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill(q, k, k)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 96])
def test_flash_prefill_bf16_small_head_dims(gen, d):
    """bf16 at a head dim the tensor-core kernels lack (the deepseek-67b
    smoke config's 8, which the examples serve): the f32 kernel on f32
    copies, one launch, out in bf16 and lse as the plain version's."""
    q = randn(gen, 2, 70, 8, d, dtype=torch.bfloat16)
    k, v = randn(gen, 2, 70, 2, d, dtype=torch.bfloat16), randn(gen, 2, 70, 2, d,
                                                               dtype=torch.bfloat16)
    before = flash_prefill.launches
    out, lse = flash_prefill(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1 and out.dtype == torch.bfloat16
    ref, ref_lse = dense_ref(q.float(), k.float(), v.float(), return_lse=True)
    torch.testing.assert_close(out.float(), ref, rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, rtol=TOL[torch.float32], atol=TOL[torch.float32])


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
@pytest.mark.parametrize("run_len", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8, torch.uint8])
def test_kv_pull_runs_exact_and_in_place(gen, dtype, run_len):
    """One launch a run of run_len adjacent pages, bit-equal to the plain
    version; pages no run names keep their bytes; a run past a pool raises."""
    src = torch.randint(0, 100, (64, 16, 2, 32), generator=gen, device="cuda").to(dtype)
    dst = torch.randint(0, 100, (48, 16, 2, 32), generator=gen, device="cuda").to(dtype)
    ss = torch.randperm(64 // run_len, generator=gen, device="cuda")[:5].to(torch.int32)
    ds = torch.randperm(48 // run_len, generator=gen, device="cuda")[:5].to(torch.int32)
    keep = dst.clone()
    before = kv_pull_runs.launches
    out = kv_pull_runs(src, dst, ss, ds, run_len=run_len)
    torch.cuda.synchronize()
    assert out is dst and kv_pull_runs.launches == before + 1
    assert torch.equal(out, kv_pull_runs_ref(src, keep.clone(), ss, ds, run_len=run_len))
    named = (ds.long()[:, None] * run_len + torch.arange(run_len, device="cuda")).reshape(-1)
    mask = torch.ones(48, dtype=torch.bool, device="cuda")
    mask[named] = False
    assert torch.equal(out[mask], keep[mask])
    with pytest.raises(IndexError, match="kv_pull_runs"):
        kv_pull_runs(src, dst, ss, ds + 48 // run_len, run_len=run_len)


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


def dequant_case(gen, dtype, page_shape, n_src=12, n_dst=10, offset=0):
    """kv_pull_dequant into a pool of n_dst pages that starts ``offset``
    elements into its storage (offset 1: not 16-byte aligned)."""
    elems = 1
    for d in page_shape:
        elems *= d
    src = torch.randint(-127, 128, (n_src, *page_shape), generator=gen, device="cuda",
                        dtype=torch.int8)
    storage = randn(gen, n_dst * elems + offset, dtype=dtype)
    dst = storage[offset:].view(n_dst, *page_shape)
    sid = torch.tensor([0, 5, 11, 3], dtype=torch.int32, device="cuda")
    did = torch.tensor([9, 1, 4, 0], dtype=torch.int32, device="cuda")
    sc = torch.tensor([0.013, 1.0, 0.5, 0.0021], device="cuda")
    keep = dst.clone()
    out = kv_pull_dequant(src, dst, sid, did, sc)
    torch.cuda.synchronize()
    assert torch.equal(out, kv_pull_dequant_ref(src, keep.clone(), sid, did, sc))
    untouched = [i for i in range(n_dst) if i not in (9, 1, 4, 0)]
    assert torch.equal(out[untouched], keep[untouched])
    return dst


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page_shape", [(5, 3), (4, 2, 33), (7,)])
def test_kv_pull_dequant_pages_not_a_multiple_of_16(gen, dtype, page_shape):
    """The scalar kernel takes pages whose element count is not a multiple
    of 16 (the vector kernel would cut their ends)."""
    dequant_case(gen, dtype, page_shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_pull_dequant_unaligned_pool(gen, dtype):
    """A pool slice one element into its storage: not 16-byte aligned, so
    the scalar kernel runs; an aligned slice of the same pages the vector
    one.  Both bit-equal to the plain version."""
    assert dequant_case(gen, dtype, (16, 2, 32), offset=1).data_ptr() % 16
    assert dequant_case(gen, dtype, (16, 2, 32), offset=16 // dtype.itemsize).data_ptr() % 16 == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_pull_dequant_yi_pull(gen, dtype):
    """One 257-token Yi-9B request: 864 int8 pages of 16384 -> the pool."""
    n_txn, elems, n_dst = 9 * 48 * 2, 32 * 4 * 128, 256 * 2 * 48 // 8
    src = torch.randint(-127, 128, (n_txn, elems), generator=gen, device="cuda",
                        dtype=torch.int8)
    dst = randn(gen, n_dst, elems, dtype=dtype)
    sid = torch.arange(n_txn, dtype=torch.int32, device="cuda")
    did = torch.randperm(n_dst, generator=gen, device="cuda")[:n_txn].to(torch.int32)
    sc = torch.rand(n_txn, generator=gen, device="cuda") * 0.05
    out = kv_pull_dequant(src, dst.clone(), sid, did, sc)
    torch.cuda.synchronize()
    assert torch.equal(out, kv_pull_dequant_ref(src, dst.clone(), sid, did, sc))


def ssd_inputs(gen, b, s, nh, hd, ns, dtype=torch.float32, dt_fill=None):
    x = (torch.randn(b, s, nh, hd, generator=gen, device="cuda") * 0.5).to(dtype)
    dt = (torch.randn(b, s, nh, generator=gen, device="cuda").abs() * 0.1 + 0.01
          if dt_fill is None else torch.full((b, s, nh), dt_fill, device="cuda"))
    a = -(torch.randn(nh, generator=gen, device="cuda").abs() + 0.5)
    B = torch.randn(b, s, ns, generator=gen, device="cuda") * 0.3
    C = torch.randn(b, s, ns, generator=gen, device="cuda") * 0.3
    return x, dt, a, B, C, torch.randn(nh, generator=gen, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,nh,hd,ns,chunk", [
    (2, 128, 4, 32, 16, 32), (2, 64, 2, 64, 128, 64), (2, 96, 50, 64, 16, 32),  # JAX grid
    (1, 257, 48, 64, 128, 128), (1, 130, 48, 64, 128, 128),  # mamba2-780m, ragged
    (1, 224, 50, 64, 16, 128), (2, 45, 3, 40, 8, 16),  # hymba-1.5b; ragged hd tile
])
def test_ssd_scan(gen, b, s, nh, hd, ns, chunk):
    args = ssd_inputs(gen, b, s, nh, hd, ns)
    y, st = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    y_ref, st_ref = ssd_scan_ref(*args, chunk=chunk)
    torch.testing.assert_close(y, y_ref, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(st, st_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dt_fill", [1e-3, 5.0])
def test_ssd_scan_decay_extremes_finite(gen, dt_fill):
    x, dt, _, B, C, _ = ssd_inputs(gen, 1, 64, 2, 16, 8, dt_fill=dt_fill)
    a = torch.tensor([-0.01, -8.0], device="cuda")
    d_skip = torch.zeros(2, device="cuda")
    y, st = ssd_scan(x, dt, a, B, C, d_skip, chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_ref, st_ref = ssd_scan_ref(x, dt, a, B, C, d_skip, chunk=16)
    torch.testing.assert_close(y, y_ref, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(st, st_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_ssd_scan_bf16_x(gen):
    args = ssd_inputs(gen, 1, 257, 48, 64, 128, dtype=torch.bfloat16)
    y, st = ssd_scan(*args)
    y_ref, st_ref = ssd_scan_ref(*args)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(st, st_ref, rtol=1e-3, atol=1e-3)


MAMBA2 = (48, 64, 128)  # nh, hd, ns of mamba2-780m
HYMBA = (50, 64, 16)    # of hymba-1.5b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,widths", [(1, MAMBA2), (63, MAMBA2), (64, MAMBA2), (65, MAMBA2),
                                      (1328, HYMBA)])
def test_ssd_scan_lengths(gen, s, widths, dtype):
    """One row, a chunk less one, one chunk, one more row (mamba2-780m), and
    hymba-1.5b's longest prefill (1200 tokens + 128 meta, 21 chunks)."""
    args = ssd_inputs(gen, 1, s, *widths, dtype=dtype)
    y, st = ssd_scan(*args)
    torch.cuda.synchronize()
    y_ref, st_ref = ssd_scan_ref(*args)
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(st, st_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,hd,ns,chunk", [(1, 70, 3, 18, 5, 32), (2, 45, 2, 20, 6, 16),
                                                (1, 130, 2, 66, 40, 64)])
def test_ssd_scan_widths_off_the_16_byte_grid(gen, b, s, nh, hd, ns, chunk, dtype):
    """hd or ns not a multiple of 4: the tiles load element by element (and
    hd x ns = 90 passes the states element by element); hd 66 takes a
    second, nearly empty hd tile, ns 40 the wide state tile, zero-padded."""
    args = ssd_inputs(gen, b, s, nh, hd, ns, dtype=dtype)
    y, st = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    y_ref, st_ref = ssd_scan_ref(*args, chunk=chunk)
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(st, st_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_ssd_scan_mamba2_full_width_f32_accurate(gen):
    """3xTF32 keeps f32 accuracy: the full mamba2-780m prefill of a
    257-token prompt within 1e-4 of the plain version (1xTF32 would leave
    about 7e-4, tests/test_torch_ssd_design.py)."""
    args = ssd_inputs(gen, 1, 257, *MAMBA2)
    y, st = ssd_scan(*args)
    torch.cuda.synchronize()
    y_ref, st_ref = ssd_scan_ref(*args)
    assert float((y - y_ref).abs().max()) <= 1e-4
    assert float((st - st_ref).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_state_pull_lands_through_kv_pull(gen):
    """Two f32 SlotCaches on the card: pull_state lands every layer's slot
    exactly, through kv_pull launches."""
    from repro_torch.core.connection import (
        ChipInfo, ConnectionManager, DescriptorRegistry, WorkerInfo)
    from repro_torch.core.pull_push import pull_state
    from repro_torch.core.transfer_engine import TransferEngine
    from repro_torch.serving.kv_cache import SlotCache
    from repro_torch.serving.request import Request

    kw = dict(num_layers=4, num_slots=3, state_elems=2500, dtype=torch.float32, device="cuda")
    pre = SlotCache("p0", base_address=0x3000_0000, **kw)
    dec = SlotCache("d0", base_address=0x4000_0000, **kw)
    eng = TransferEngine()
    eng.register_memory(pre.memory_region())
    eng.register_memory(dec.memory_region())
    reg = DescriptorRegistry("p0")
    for d in pre.descriptors():
        reg.register(d)

    def info(wid, role):
        return WorkerInfo(wid, role, "10.0.0.1", (ChipInfo(0, f"ici://{wid}/0"),))

    conn = ConnectionManager(info("d0", "decode")).connect(info("p0", "prefill"), reg)
    for layer in range(4):
        pre.write_slot(layer, 1, torch.randn(2500, generator=gen, device="cuda"))
    before = kv_pull.launches
    stats = pull_state(Request("r1", prompt_len=8, max_new_tokens=1), conn=conn, engine=eng,
                       decode_cache=dec, remote_slot=1, local_slot=2)
    torch.cuda.synchronize()
    assert stats.txns_submitted == 4 and kv_pull.launches > before
    for layer in range(4):
        assert torch.equal(dec.read_slot(layer, 2), pre.read_slot(layer, 1))


# ------------------------------------------- the training path (lse, backward)
# (b, s, t, h, g, d, kw): Yi-9B causal at a serving prompt and at its train
# length, whisper's encoder (non-causal over 1500 frames), hymba-1.5b's
# window and meta prefix
TRAIN_SHAPES = [
    (1, 257, 257, 32, 4, 128, dict(causal=True)),
    (1, 2048, 2048, 32, 4, 128, dict(causal=True)),
    (1, 1500, 1500, 20, 20, 64, dict(causal=False)),
    (1, 1328, 1328, 25, 5, 64, dict(causal=True, sliding_window=1024, prefix_len=128)),
    (8, 128, 128, 8, 2, 8, dict(causal=True)),   # examples/torch_train_lm.py
]
LSE_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,g,d,kw", TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_lse_matches_the_plain_fwd_scan(gen, b, s, t, h, g, d, kw, dtype):
    from repro_torch.models.flash import flash_forward_plain

    q, k, v = randn(gen, b, s, h, d, dtype=dtype), randn(gen, b, t, g, d, dtype=dtype), \
        randn(gen, b, t, g, d, dtype=dtype)
    out, lse = flash_prefill(q, k, v, return_lse=True, **kw)
    ref_out, ref_lse = flash_forward_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL[dtype], rtol=LSE_TOL[dtype])
    torch.testing.assert_close(out.float(), ref_out.float(), atol=TOL[dtype], rtol=TOL[dtype])
    # the out path is the one without lse, bit for bit
    assert torch.equal(out, flash_prefill(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,g,d,kw", TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_matches_autograd_through_the_plain_version(gen, b, s, t, h, g, d,
                                                                    kw, dtype):
    """dq, dk, dv of the autograd Function (the kernel forward, the torch
    backward) against autograd through dense_ref in f32 on the same
    (rounded) inputs; ||err|| / ||ref|| under 2e-4 (f32) and 1e-2 (bf16)."""
    from repro_torch.models.flash import flash_attention

    q, k, v = randn(gen, b, s, h, d, dtype=dtype), randn(gen, b, t, g, d, dtype=dtype), \
        randn(gen, b, t, g, d, dtype=dtype)
    dout = randn(gen, b, s, h, d, dtype=dtype)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = flash_ops.flash_prefill.launches
    flash_attention(*xs, **kw).backward(dout)
    assert flash_ops.flash_prefill.launches == before + 1  # the forward is the kernel
    refs = [x.float().requires_grad_(True) for x in (q, k, v)]
    dense_ref(*refs, **kw).backward(dout.float())
    torch.cuda.synchronize()
    limit = 2e-4 if dtype == torch.float32 else REL_NORM_BF16
    for name, x, r in zip("qkv", xs, refs):
        assert x.grad.dtype == dtype and torch.isfinite(x.grad).all()
        assert rel_norm(x.grad, r.grad) < limit, f"d{name}"


@pytest.mark.cuda
def test_ssd_scan_autograd_on_cuda_launches_the_kernel_once(gen):
    """With inputs that require grad the wrapper goes through ``SSDScan``, whose
    forward is the kernel (one launch) and whose backward is the plain
    version's gradient; under no_grad it launches the kernel alone."""
    b, s, nh, hd, ns = 1, 64, 4, 16, 8
    x = randn(gen, b, s, nh, hd).requires_grad_(True)
    dt = torch.rand(b, s, nh, generator=gen, device="cuda") * 0.1
    a = -torch.rand(nh, generator=gen, device="cuda")
    B, C = randn(gen, b, s, ns), randn(gen, b, s, ns)
    d_skip = torch.ones(nh, device="cuda")
    before = ssd_scan.launches
    y, _ = ssd_scan(x, dt, a, B, C, d_skip)
    assert ssd_scan.launches == before + 1 and y.grad_fn is not None
    y.sum().backward()
    assert ssd_scan.launches == before + 1 and torch.isfinite(x.grad).all()
    with torch.no_grad():  # inference through the kernel still runs
        y, _ = ssd_scan(x, dt, a, B, C, d_skip)
    assert torch.isfinite(y).all() and y.grad_fn is None
    assert ssd_scan.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,widths", [(1, 257, MAMBA2), (2, 1100, MAMBA2), (1, 1328, HYMBA)])
def test_ssd_scan_function_matches_autograd_through_the_plain_version(gen, b, s, widths):
    """The Function on the kernel route (the kernel forward, the plain
    backward) against torch autograd through ``ssd_scan_ref``, f32, at
    mamba2-780m and hymba-1.5b widths: y to 1e-3 (ssd_scan's tolerance),
    each of the six gradients to 1e-4 in ||err|| / ||ref|| (the backward
    is derived by hand from the same inputs: only the order of sums
    differs)."""
    args = ssd_inputs(gen, b, s, *widths)
    gy = randn(gen, *args[0].shape)
    gs = randn(gen, b, widths[0], widths[1], widths[2])
    xs = [t.clone().requires_grad_(True) for t in args]
    refs = [t.clone().requires_grad_(True) for t in args]
    before = ssd_scan.launches
    y, st = ssd_scan(*xs)
    ((y * gy).sum() + (st * gs).sum()).backward()
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    y_ref, st_ref = ssd_scan_ref(*refs)
    ((y_ref * gy).sum() + (st_ref * gs).sum()).backward()
    torch.testing.assert_close(y, y_ref, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(st, st_ref, rtol=1e-3, atol=1e-3)
    for name, x, r in zip(("x", "dt", "a", "B", "C", "d_skip"), xs, refs):
        assert torch.isfinite(x.grad).all(), name
        assert rel_norm(x.grad, r.grad) < 1e-4, name


@pytest.mark.cuda
def test_ssm_prefill_without_grad_launches_once_a_layer(gen):
    """The serving paths keep calling the kernel directly: a mamba2 smoke
    prefill under no_grad launches ssd_scan once a layer and builds no
    graph, even with parameters that require grad."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build_model
    from repro_torch.tree import leaves

    model = build_model(get_smoke_config("mamba2-780m"), device="cuda")
    params = model.init_params(0)
    for p in leaves(params):
        p.requires_grad_(True)
    tokens = torch.randint(0, 512, (1, 70), generator=gen, device="cuda")
    before = ssd_scan.launches
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": tokens})
    assert ssd_scan.launches == before + model.cfg.num_layers
    assert logits.grad_fn is None


@pytest.mark.cuda
def test_checkpoint_round_trip_on_cuda_tensors(gen, tmp_path):
    from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.tree import leaves

    tree = ({"w": randn(gen, 64, 32, dtype=torch.bfloat16), "b": randn(gen, 32)},
            {"step": torch.tensor(4, dtype=torch.int32, device="cuda")}, {"seed": 0, "step": 4})
    save_checkpoint(tmp_path, 4, tree)
    like = ({k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in tree[0].items()},
            {"step": torch.empty((), dtype=torch.int32, device="meta")}, {"seed": 0, "step": 0})
    got = restore_checkpoint(tmp_path, 4, like, device="cuda")
    for a, r in zip(leaves(got), leaves(tree)):
        r = torch.as_tensor(r)
        if r.is_cuda:
            assert a.is_cuda and a.dtype == r.dtype
        assert torch.equal(a.cpu(), r.cpu())


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(gen):
    """Two make_train_step steps of the yi-9b smoke config in f32: on the
    card (the kernel forward) and on the CPU (the plain forward), the same
    losses within 1e-5 relative and gradient norms within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import tree_map

    cfg = get_smoke_config("yi-9b")
    ocfg = AdamWConfig(lr_peak=3e-3, warmup_steps=1, total_steps=4)
    tokens = torch.randint(0, cfg.vocab_size, (2, 3, 64), generator=torch.Generator()
                           .manual_seed(0))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        params = tree_map(lambda p: p.float(), model.init_params(0, device="cpu"))
        params = tree_map(lambda p: p.to(dev), params)
        state = adamw_init(params, ocfg)
        step = make_train_step(model, ocfg, remat=True)
        runs[dev] = []
        for i in range(2):
            params, state, m = step(params, state, {"tokens": tokens[i].to(dev)})
            runs[dev].append((float(m["loss"]), float(m["grad_norm"])))
    for (lc, gc), (lg, gg) in zip(runs["cpu"], runs["cuda"]):
        assert lg == pytest.approx(lc, rel=1e-5)
        assert gg == pytest.approx(gc, rel=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,nh,hd,ns", [
    (3, 130, 12, 64, 128),      # mamba2-780m, a rank of (1, 4): 12 of 48 SSD heads
    (1, 1328, 50, 16, 16),      # hymba-1.5b, a rank of (1, 4): 16 of head_dim 64
    (1, 1328, 50, 4, 16),       # hymba-1.5b, a rank of (16, 16): 4 of head_dim 64
])
def test_ssd_scan_rank_local_shapes(gen, b, s, nh, hd, ns):
    x = randn(gen, b, s, nh, hd) * 0.5
    dt = randn(gen, b, s, nh).abs() * 0.1 + 0.01
    a = -(randn(gen, nh).abs() + 0.5)
    B, C = randn(gen, b, s, ns) * 0.3, randn(gen, b, s, ns) * 0.3
    d_skip = randn(gen, nh)
    y, st = ssd_scan(x, dt, a, B, C, d_skip)
    ry, rst = ssd_scan_ref(x, dt, a, B, C, d_skip)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ry, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(st, rst, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("s,t,h,g,d,causal", [
    (1500, 1500, 5, 5, 64, False),   # whisper's encoder, 5 heads a rank
    (1, 1500, 5, 5, 64, False),      # whisper's decode cross-attention
    (2976, 2976, 8, 2, 128, True),   # llava's image + text, 8 heads a rank
])
def test_flash_prefill_rank_local_shapes(gen, s, t, h, g, d, causal):
    q = randn(gen, 1, s, h, d, dtype=torch.bfloat16)
    k, v = (randn(gen, 1, t, g, d, dtype=torch.bfloat16) for _ in range(2))
    out = flash_prefill(q, k, v, causal=causal)
    ref = dense_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    assert rel_norm(out, ref) < REL_NORM_BF16


def _graph_model(arch):
    """``arch`` at its published widths, cut to 2 layers (granite at
    capacity_factor E / k, as served), with its weights on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import DecoderLM

    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    model = DecoderLM(cfg, device="cuda")
    return model, model.init_params(seed=0)


def _joined(state, extra):
    """``state``'s sequences, then ``extra``'s, in new page tensors (the
    worker's rebuild on a join)."""
    import dataclasses

    return dataclasses.replace(
        state, context_lens=torch.cat([state.context_lens, extra.context_lens]),
        k_pages=torch.cat([state.k_pages, extra.k_pages], dim=1),
        v_pages=torch.cat([state.v_pages, extra.v_pages], dim=1),
        block_tables=torch.cat([state.block_tables, extra.block_tables]))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-3b-a800m"])
def test_decode_graphs_replay_the_eager_step(gen, arch):
    """32 steps of 3 sequences, 2 more joining after 16 (the state rebuilt,
    3 -> 5: buckets 4 and 8): the captured replays, every bucket captured
    at the first step, give the tokens of ``decode_step`` on the unpadded
    batch; the pages they write agree."""
    import dataclasses

    from repro_torch.models.decode_graph import DecodeGraphs
    from repro_torch.models.transformer import greedy_tokens

    model, params = _graph_model(arch)
    vocab = model.cfg.vocab_size
    prompts = torch.randint(0, vocab, (5, 70), generator=gen, device="cuda")
    logits, state = model.prefill(params, {"tokens": prompts}, max_blocks_margin=2)
    first = greedy_tokens(logits, vocab)

    def rows(lo, hi):
        return dataclasses.replace(
            state, context_lens=state.context_lens[lo:hi].clone(),
            k_pages=state.k_pages[:, lo:hi].clone(), v_pages=state.v_pages[:, lo:hi].clone(),
            block_tables=state.block_tables[lo:hi].clone())

    def run(step):
        st, tok, out = rows(0, 3), first[:3], []
        for i in range(32):
            if i == 16:
                st, tok = _joined(st, rows(3, 5)), torch.cat([tok, first[3:]])
            tok, st = step(st, tok)
            out.append(tok.tolist())
        return out, st

    graphs, modes = DecodeGraphs(model, params), []

    def replayed(st, tok):
        tok, st, mode = graphs.step(st, tok)
        modes.append(mode)
        return tok, st

    def eager(st, tok):
        lg, st = model.decode_step(params, st, tok)
        return greedy_tokens(lg, vocab), st

    got, st_g = run(replayed)
    want, st_e = run(eager)
    torch.cuda.synchronize()
    assert modes == ["capture"] + ["replay"] * 31
    assert got == want
    torch.testing.assert_close(st_g.k_pages.float(), st_e.k_pages.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_decode_graph_kernels_reach_the_profiler(gen):
    """A replayed step's kernels appear in ``torch.profiler``'s CUDA events,
    every kernel the eager ``decode_step`` launches at the same batch among
    them: the device's idle share reads a replayed step as it reads an
    eager one."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.decode_graph import DecodeGraphs
    from repro_torch.models.transformer import greedy_tokens

    model, params = _graph_model("yi-9b")
    vocab = model.cfg.vocab_size
    prompts = torch.randint(0, vocab, (4, 40), generator=gen, device="cuda")
    logits, state = model.prefill(params, {"tokens": prompts}, max_blocks_margin=2)
    tok = greedy_tokens(logits, vocab)
    graphs = DecodeGraphs(model, params)

    def kernels(step):
        step()                                  # the capture, outside the profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]

    replayed = kernels(lambda: graphs.step(state, tok))
    eager = kernels(lambda: greedy_tokens(model.decode_step(params, state, tok)[0], vocab))
    names = {e.name for e in replayed}
    assert any("paged_attention" in n for n in names)
    assert {e.name for e in eager} <= names
    assert len(replayed) >= len(eager)
    assert sum(e.device_time_total for e in replayed) > 0
