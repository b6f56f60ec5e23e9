"""The port's kernel wrappers on the CPU: each plain PyTorch version
(``repro_torch/kernels/*/ref.py``, what a wrapper runs on CPU tensors)
against the JAX package's oracle on the same numpy inputs, over the case
grids of tests/test_kernels.py.  The Pallas kernels themselves do not run
on this backend, so their jnp oracles stand in for them.  Tolerances as
in tests/test_kernels.py: f32 2e-4, bf16 2e-2; the copies are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill.ref import blockwise_ref as jax_blockwise_ref
from repro.kernels.flash_prefill.ref import dense_ref as jax_dense_ref
from repro.kernels.kv_pull.kernel import kv_pull_runs as jax_runs_kernel
from repro.kernels.kv_pull.ref import (
    kv_pull_dequant_ref as jax_dequant_ref,
    kv_pull_ref as jax_pull_ref,
    kv_pull_runs_ref as jax_runs_ref,
)
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_ref
from repro.models.flash import pair_schedule as jax_pair_schedule
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.kv_pull.ops import kv_pull, kv_pull_dequant, kv_pull_runs, work
from repro_torch.kernels.kv_pull.ref import kv_pull_runs_ref
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models.flash import pair_schedule

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def both(x, dtype="float32"):
    """The same numpy values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(np.asarray(x, np.float32)).to(td)


def assert_close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


class TestPagedAttention:
    @pytest.mark.parametrize("b,h,g,d,per,bs", [
        (2, 4, 2, 64, 4, 32),
        (3, 8, 1, 128, 3, 32),   # MQA
        (1, 8, 8, 64, 5, 16),    # MHA
        (3, 32, 4, 128, 3, 32),  # yi-9b widths
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax_ref(self, b, h, g, d, per, bs, dtype):
        rng = np.random.default_rng(b * 100 + h)
        qj, qt = both(rng.standard_normal((b, h, d)), dtype)
        kj, kt = both(rng.standard_normal((b, per, bs, g, d)), dtype)
        vj, vt = both(rng.standard_normal((b, per, bs, g, d)), dtype)
        tbl = np.broadcast_to(np.arange(per, dtype=np.int32)[None], (b, per)).copy()
        ctx = rng.integers(1, per * bs, b).astype(np.int32)
        ref = jax_paged_ref(qj, kj, vj, jnp.asarray(tbl), jnp.asarray(ctx))
        out = paged_attention(qt, kt, vt, torch.from_numpy(tbl), torch.from_numpy(ctx))
        assert out.dtype == qt.dtype and out.shape == (b, h, d)
        assert_close(out, ref, TOL[dtype])

    @pytest.mark.parametrize("case", ["permuted_table", "single_token", "full_last_page"])
    def test_edge_cases(self, case):
        rng = np.random.default_rng(7)
        b, h, g, d, per, bs = 2, 4, 2, 32, 4, 16
        qj, qt = both(rng.standard_normal((b, h, d)))
        kj, kt = both(rng.standard_normal((b, per, bs, g, d)))
        vj, vt = both(rng.standard_normal((b, per, bs, g, d)))
        tbl = np.broadcast_to(np.arange(per, dtype=np.int32)[None], (b, per)).copy()
        ctx = np.full(b, per * bs, np.int32)
        if case == "permuted_table":
            tbl = np.asarray([[2, 0, 3, 1], [3, 2, 1, 0]], np.int32)
        elif case == "single_token":
            ctx = np.ones(b, np.int32)
        ref = jax_paged_ref(qj, kj, vj, jnp.asarray(tbl), jnp.asarray(ctx))
        out = paged_attention(qt, kt, vt, torch.from_numpy(tbl), torch.from_numpy(ctx))
        assert_close(out, ref, 2e-4)

    def test_rejects_mismatched_dtypes(self):
        q = torch.zeros(1, 4, 8)
        pages = torch.zeros(1, 2, 4, 2, 8, dtype=torch.bfloat16)
        tbl = torch.zeros(1, 2, dtype=torch.int32)
        with pytest.raises(TypeError):
            paged_attention(q, pages, pages, tbl, torch.ones(1, dtype=torch.int32))


class TestFlashPrefill:
    @pytest.mark.parametrize("s,h,g,d", [
        (256, 4, 2, 64),
        (128, 8, 8, 32),
        (256, 6, 1, 128),  # MQA
        (130, 4, 2, 64),   # ragged: the CUDA kernel masks it, Pallas raised
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_causal_matches_jax(self, s, h, g, d, dtype):
        rng = np.random.default_rng(s + h)
        qj, qt = both(rng.standard_normal((2, s, h, d)), dtype)
        kj, kt = both(rng.standard_normal((2, s, g, d)), dtype)
        vj, vt = both(rng.standard_normal((2, s, g, d)), dtype)
        ref = jax_dense_ref(qj, kj, vj, causal=True)
        out = flash_prefill(qt, kt, vt, causal=True)
        assert out.dtype == qt.dtype
        assert_close(out, ref, TOL[dtype])

    @pytest.mark.parametrize("kw", [
        dict(causal=True, sliding_window=64, prefix_len=16),
        dict(causal=False),
    ])
    def test_window_prefix_and_non_causal(self, kw):
        rng = np.random.default_rng(11)
        s, h, g, d = 256, 4, 2, 32
        qj, qt = both(rng.standard_normal((1, s, h, d)))
        kj, kt = both(rng.standard_normal((1, s, g, d)))
        vj, vt = both(rng.standard_normal((1, s, g, d)))
        assert_close(flash_prefill(qt, kt, vt, **kw), jax_dense_ref(qj, kj, vj, **kw), 2e-4)
        # the blockwise JAX oracle agrees too (block-aligned lengths only)
        assert_close(flash_prefill(qt, kt, vt, **kw),
                     jax_blockwise_ref(qj, kj, vj, q_chunk=32, k_chunk=32, **kw), 2e-4)

    @pytest.mark.parametrize("kw", [
        dict(s=256, t=256, q_chunk=32, k_chunk=32, causal=True),
        dict(s=256, t=256, q_chunk=32, k_chunk=32, causal=True, window=64, prefix=16),
        dict(s=128, t=256, q_chunk=64, k_chunk=32, causal=True, q_offset=128),
    ])
    def test_pair_schedule_copy_matches_reference(self, kw):
        s, t, cq, ck = kw.pop("s"), kw.pop("t"), kw.pop("q_chunk"), kw.pop("k_chunk")
        assert pair_schedule(s, t, cq, ck, **kw) == jax_pair_schedule(s, t, cq, ck, **kw)


class TestKVPull:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    def test_txn_list(self, dtype):
        rng = np.random.default_rng(1)
        src = rng.integers(-100, 100, (12, 16, 2, 32))
        dst = rng.integers(-100, 100, (10, 16, 2, 32))
        sid, did = np.asarray([0, 5, 11, 3], np.int32), np.asarray([9, 1, 4, 0], np.int32)
        jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype]
        td = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[dtype]
        ref = jax_pull_ref(jnp.asarray(src, jd), jnp.asarray(dst, jd),
                           jnp.asarray(sid), jnp.asarray(did))
        out = kv_pull(torch.from_numpy(src).to(td), torch.from_numpy(dst).to(td),
                      torch.from_numpy(sid), torch.from_numpy(did))
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))

    @pytest.mark.parametrize("run_len", [2, 4, 8])
    def test_coalesced_runs(self, run_len):
        """The reference's kv_pull_runs equals kv_pull over the runs
        expanded into page ids, as the port's transfer engine expands them."""
        rng = np.random.default_rng(run_len)
        src, dst = rng.standard_normal((16, 8, 2, 64)), rng.standard_normal((16, 8, 2, 64))
        ss, ds = np.asarray([0, 1], np.int32), np.asarray([1, 0], np.int32)
        ref = jax_runs_ref(jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32),
                           jnp.asarray(ss), jnp.asarray(ds), run_len=run_len)
        pages = np.arange(run_len, dtype=np.int32)
        sid = (ss[:, None] * run_len + pages).reshape(-1)
        did = (ds[:, None] * run_len + pages).reshape(-1)
        out = kv_pull(torch.from_numpy(src).float(), torch.from_numpy(dst).float(),
                      torch.from_numpy(sid), torch.from_numpy(did))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    # (n_src, n_dst, page shape, src starts, dst starts, zero dst): the cases
    # of tests/test_kernels.py::TestKVPull test_coalesced_runs and
    # test_full_request_transfer_shape (1024 blocks in runs of 8)
    RUN_CASES = {
        "coalesced": (16, 16, (8, 2, 64), [0, 2], [3, 1], False),
        "full_request": (64, 64, (16, 2, 32), list(range(8)), list(range(8)), True),
    }

    def _runs_inputs(self, case, run_len, dtype):
        n_src, n_dst, page, ss, ds, zero = self.RUN_CASES[case]
        rng = np.random.default_rng(run_len)
        src = rng.standard_normal((n_src,) + page)
        dst = np.zeros((n_dst,) + page) if zero else rng.standard_normal((n_dst,) + page)
        ss, ds = np.asarray(ss, np.int32), np.asarray(ds, np.int32)
        assert (max(ss.max(), ds.max()) + 1) * run_len <= min(n_src, n_dst)
        return both(src, dtype), both(dst, dtype), ss, ds

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("case,run_len", [("coalesced", 1), ("coalesced", 2),
                                              ("coalesced", 4), ("full_request", 1),
                                              ("full_request", 2), ("full_request", 4),
                                              ("full_request", 8)])
    def test_runs_match_jax_exactly(self, case, run_len, dtype):
        """The port's kv_pull_runs on the CPU equals the JAX kv_pull_runs_ref
        and the Pallas kernel in interpret mode, bit for bit; pages no run
        names keep their bytes."""
        (sj, st), (dj, dt), ss, ds = self._runs_inputs(case, run_len, dtype)
        keep = dt.clone()
        ref = jax_runs_ref(sj, dj, jnp.asarray(ss), jnp.asarray(ds), run_len=run_len)
        out = kv_pull_runs(st, dt, torch.from_numpy(ss), torch.from_numpy(ds),
                           run_len=run_len)
        assert out is dt   # in place
        ref_t = tensor_from_numpy(np.asarray(ref))
        assert torch.equal(out, ref_t)
        kernel = jax_runs_kernel(sj, dj, jnp.asarray(ss), jnp.asarray(ds), run_len=run_len,
                                 interpret=True)
        assert torch.equal(out, tensor_from_numpy(np.asarray(kernel)))
        named = {d * run_len + j for d in ds for j in range(run_len)}
        untouched = [i for i in range(len(keep)) if i not in named]
        assert torch.equal(out[untouched], keep[untouched])

    @pytest.mark.parametrize("run_len", [1, 2, 4, 8])
    def test_runs_equal_kv_pull_on_expanded_ids(self, run_len):
        """A run-granular pull moves the bytes of kv_pull over its runs
        expanded into page ids (what the transfer engine launches), on a
        uint8 slab of random runs."""
        gen = torch.Generator().manual_seed(run_len)
        src = torch.randint(0, 256, (64, 96), dtype=torch.uint8, generator=gen)
        dst = torch.randint(0, 256, (48, 96), dtype=torch.uint8, generator=gen)
        n = 4
        ss = torch.randperm(64 // run_len, generator=gen)[:n].to(torch.int32)
        ds = torch.randperm(48 // run_len, generator=gen)[:n].to(torch.int32)
        pages = torch.arange(run_len, dtype=torch.int32)
        sid = (ss[:, None] * run_len + pages).reshape(-1)
        did = (ds[:, None] * run_len + pages).reshape(-1)
        want = kv_pull(src, dst.clone(), sid, did)
        assert torch.equal(kv_pull_runs(src, dst.clone(), ss, ds, run_len=run_len), want)
        assert torch.equal(kv_pull_runs_ref(src, dst.clone(), ss, ds, run_len=run_len), want)

    @pytest.mark.parametrize("ss,ds,run_len", [
        ([0, 2], [0, 1], 8),    # src run 2: pages 16..23 of a 16-page pool
        ([0, 1], [3, 1], 4),    # dst run 3: pages 12..15 of a 12-page pool
        ([-1, 0], [0, 1], 4),
        ([0, 1], [0, -1], 2),
    ])
    def test_runs_raise_past_either_pool(self, ss, ds, run_len):
        """A run that leaves either pool raises, and moves nothing."""
        src, dst = torch.randn(16, 4), torch.randn(12, 4)
        keep = dst.clone()
        with pytest.raises(IndexError, match="kv_pull_runs"):
            kv_pull_runs(src, dst, torch.tensor(ss, dtype=torch.int32),
                         torch.tensor(ds, dtype=torch.int32), run_len=run_len)
        assert torch.equal(dst, keep)

    def test_runs_check_arguments(self):
        src = torch.zeros(8, 4)
        starts = torch.zeros(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="run_len"):
            kv_pull_runs(src, src.clone(), starts, starts, run_len=0)
        with pytest.raises(TypeError, match="int32"):
            kv_pull_runs(src, src.clone(), starts.long(), starts.long(), run_len=2)
        with pytest.raises(TypeError, match="dtype"):
            kv_pull_runs(src, src.to(torch.bfloat16), starts, starts, run_len=2)
        before = kv_pull_runs.launches
        kv_pull_runs(src, src.clone(), starts, starts, run_len=2)
        assert kv_pull_runs.launches == before  # the plain version is no launch

    @pytest.mark.parametrize("run_len", [1, 8])
    def test_runs_on_meta_count_their_work(self, run_len):
        """On meta tensors kv_pull_runs launches nothing and counts its
        bound's formula: each page of each run read and written once, a
        run's two starts read once."""
        n_runs, page = 13, (32, 4, 128)
        src = torch.empty((1024,) + page, dtype=torch.bfloat16, device="meta")
        dst = torch.empty((512,) + page, dtype=torch.bfloat16, device="meta")
        starts = torch.empty((n_runs,), dtype=torch.int32, device="meta")
        kbuild.reset_meta()
        out = kv_pull_runs(src, dst, starts, starts, run_len=run_len)
        assert out is dst
        page_bytes = 32 * 4 * 128 * 2
        assert work(n_runs, page_bytes, page_bytes, run_len) == (
            0, n_runs * (2 * run_len * page_bytes + 8))
        assert (kbuild.META_WORK["flops"], kbuild.META_WORK["bytes"]) == \
            work(n_runs, page_bytes, page_bytes, run_len)
        assert kbuild.META_WORK["calls"] == {"kv_pull_runs": 1}
        # kv_pull over the runs' page ids moves the same pages, and reads
        # two ids a page where kv_pull_runs reads two starts a run
        kbuild.reset_meta()
        ids = torch.empty((n_runs * run_len,), dtype=torch.int32, device="meta")
        kv_pull(src, dst, ids, ids)
        assert kbuild.META_WORK["bytes"] == work(n_runs * run_len, page_bytes, page_bytes)[1]
        assert kbuild.META_WORK["bytes"] - work(n_runs, page_bytes, page_bytes, run_len)[1] \
            == 8 * n_runs * (run_len - 1)

    @pytest.mark.parametrize("dst_dtype", ["float32", "bfloat16"])
    def test_dequant_matches_jax_bit_for_bit(self, dst_dtype):
        rng = np.random.default_rng(3)
        src = rng.integers(-127, 128, (12, 16, 2, 32)).astype(np.int8)
        dst = rng.standard_normal((10, 16, 2, 32))
        sid, did = np.asarray([0, 5, 11, 3], np.int32), np.asarray([9, 1, 4, 0], np.int32)
        scales = np.asarray([0.013, 1.0, 0.5, 0.0021], np.float32)
        dj, dt = both(dst, dst_dtype)
        ref = jax_dequant_ref(jnp.asarray(src), dj, jnp.asarray(sid), jnp.asarray(did),
                              jnp.asarray(scales))
        out = kv_pull_dequant(torch.from_numpy(src), dt, torch.from_numpy(sid),
                              torch.from_numpy(did), torch.from_numpy(scales))
        ref_t = tensor_from_numpy(np.asarray(ref))
        assert torch.equal(out, ref_t)
        untouched = [i for i in range(10) if i not in (9, 1, 4, 0)]
        assert torch.equal(out[untouched], both(dst, dst_dtype)[1][untouched])

    def test_dequant_roundtrip_bound(self):
        rng = np.random.default_rng(4)
        x = rng.standard_normal((3, 8, 2, 16)).astype(np.float32)
        scales = np.abs(x).reshape(3, -1).max(axis=1) / 127.0
        q = np.clip(np.round(x / scales[:, None, None, None]), -127, 127).astype(np.int8)
        ids = torch.arange(3, dtype=torch.int32)
        out = kv_pull_dequant(torch.from_numpy(q), torch.zeros(3, 8, 2, 16), ids, ids,
                              torch.from_numpy(scales.astype(np.float32)))
        err = np.max(np.abs(out.numpy() - x), axis=(1, 2, 3))
        assert (err <= np.abs(x).reshape(3, -1).max(axis=1) / 127.0 + 1e-7).all()

    def test_cpu_route_counts_no_launch_and_checks_ids(self):
        before = kv_pull.launches
        src = torch.zeros(4, 8, dtype=torch.uint8)
        ids = torch.arange(2, dtype=torch.int32)
        kv_pull(src, src.clone(), ids, ids)
        assert kv_pull.launches == before  # the plain version is no launch
        with pytest.raises(TypeError, match="int32"):
            kv_pull(src, src.clone(), ids.long(), ids.long())
