"""The design of the ssd_scan kernel, checked on the CPU.

``csrc/ssd_scan.cu`` splits the SSD scan into four steps: per chunk
CB = C.B^T once for every head; per (chunk, head, hd tile) the decay
cumsum as a warp scan and the chunk's own state; per (head, element) the
state passing over chunks; per (chunk, head, hd tile) the outputs.  A
plain-torch model of that decomposition, at the kernel's internal chunk
and with its scan order, must equal the plain version ``ssd_scan_ref``
and the JAX package's oracle (f32, 1e-5).

Every product runs on the tensor cores in TF32 with f32 accumulation.
Rounding each operand to TF32 (10 mantissa bits, to nearest) once
(1xTF32) is too coarse for the 1e-3 card tolerance and the f32
consistency checks at mamba2-780m widths; the split a ~ hi + lo (3xTF32,
hi rounded, lo = a - hi cut to TF32, as the kernel splits) must stay
within 1e-5 of a float64 run.  The emulation computes each
product exactly (float64) from the TF32 parts and rounds it to f32 once;
the tensor cores' own accumulation order is not modelled.

The wrapper holds its constants (``DESIGN``) against the compiled
kernel's ``ssd_scan_design`` before its first launch
(``build.check_design``); here a stand-in library plays the kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ops import HD_TILE, KERNEL_CHUNK, chunking
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

TOL = 1e-5


def ssd_inputs(rng, b, s, nh, hd, ns):
    """tests/test_kernels.py's ssd_scan inputs, as numpy."""
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32) * 0.5
    dt = (np.abs(rng.standard_normal((b, s, nh))) * 0.1 + 0.01).astype(np.float32)
    a = -(np.abs(rng.standard_normal(nh)) + 0.5).astype(np.float32)
    B = rng.standard_normal((b, s, ns)).astype(np.float32) * 0.3
    C = rng.standard_normal((b, s, ns)).astype(np.float32) * 0.3
    d_skip = rng.standard_normal(nh).astype(np.float32)
    return x, dt, a, B, C, d_skip


def warp_scan(v):
    """Inclusive cumsum over the last axis (<= 64 rows) as the kernel's warp
    takes it: lane r holds rows 2r and 2r + 1, scans their pair sums over
    32 lanes (Hillis-Steele), then adds its two rows to the exclusive sum."""
    pad = 2 * 32 - v.shape[-1]
    v = torch.nn.functional.pad(v, (0, pad))
    v0, v1 = v[..., 0::2], v[..., 1::2]
    incl = v0 + v1
    off = 1
    while off < 32:
        up = torch.nn.functional.pad(incl[..., :-off], (off, 0))
        incl = incl + up
        off *= 2
    excl = torch.nn.functional.pad(incl[..., :-1], (1, 0))
    c0 = excl + v0
    out = torch.stack([c0, c0 + v1], dim=-1).flatten(-2)
    return out[..., :out.shape[-1] - pad]


def tf32(t, *, cut=False):
    """f32 to TF32 as the kernel takes it: to nearest, ties away (the hi
    part, as cvt.rna.tf32.f32 rounds), or cut to 10 mantissa bits (the lo
    part)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits if cut else bits + 0x1000) & -0x2000).view(torch.float32)


def mm_tf32(a, b, *, split=True):
    """a @ b on the tensor cores: operands in TF32 (3xTF32: hi hi + hi lo +
    lo hi, lo = x - hi cut to TF32), each product exact, the sum rounded to
    f32."""
    ah, bh = tf32(a), tf32(b)
    out = ah.double() @ bh.double()
    if split:
        al, bl = tf32(a - ah, cut=True), tf32(b - bh, cut=True)
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out.float()


def kernel_model(x, dt, a, B, C, d_skip, chunk=128, mm=torch.matmul):
    """The four steps of csrc/ssd_scan.cu in plain torch, in x's float type
    (f32, or float64 for the exact reference), every product through
    ``mm``.  Rows past s count as dt = 0, x = 0 (B, C = 0)."""
    b, s, nh, hd = x.shape
    ns = B.shape[-1]
    l, nc = chunking(s, chunk)
    pad = nc * l - s
    ft = x.dtype
    xc = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)).reshape(b, nc, l, nh, hd)
    dtc = torch.nn.functional.pad(dt.to(ft), (0, 0, 0, pad)).reshape(b, nc, l, nh)
    Bc = torch.nn.functional.pad(B.to(ft), (0, 0, 0, pad)).reshape(b, nc, l, ns)
    Cc = torch.nn.functional.pad(C.to(ft), (0, 0, 0, pad)).reshape(b, nc, l, ns)

    # step 1: CB once per chunk for every head
    cb = mm(Cc, Bc.transpose(-1, -2))                               # [b, nc, l, l]
    # step 2: cum per head as a warp scan; each chunk's own state, S = (x w)^T B
    dth = dtc.movedim(-1, 2)                                        # [b, nc, nh, l]
    cum = warp_scan(dth * a.to(ft)[:, None])                        # [b, nc, nh, l]
    w = torch.exp(torch.clamp(cum[..., -1:] - cum, max=0)) * dth    # [b, nc, nh, l]
    xh = xc.movedim(3, 2)                                           # [b, nc, nh, l, hd]
    states = mm((xh * w[..., None]).transpose(-1, -2), Bc[:, :, None])  # [b, nc, nh, hd, ns]
    # step 3: state passing, the prior state written over each chunk's own
    carry = torch.zeros_like(states[:, 0])
    prior = torch.empty_like(states)
    for c in range(nc):
        prior[:, c] = carry
        carry = carry * torch.exp(torch.clamp(cum[:, c, :, -1], max=0))[..., None, None] \
            + states[:, c]
    # step 4: y = exp(cum_i) (C prior^T) + (CB o L o dt) x + D x
    off = mm(Cc[:, :, None], prior.transpose(-1, -2))                # [b, nc, nh, l, hd]
    off = off * torch.exp(torch.clamp(cum, max=0))[..., None]
    seg = cum[..., :, None] - cum[..., None, :]
    vis = torch.tril(torch.ones(l, l, dtype=torch.bool))
    L = torch.where(vis, torch.exp(torch.clamp(seg, max=0)), torch.zeros((), dtype=ft))
    m = cb[:, :, None] * L * dth[..., None, :]                      # [b, nc, nh, l, l]
    y = off + mm(m, xh) + xh * d_skip.to(ft)[:, None, None]
    y = y.movedim(2, 3).reshape(b, nc * l, nh, hd)[:, :s]
    return y, carry


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_at_kernel_chunk(args, chunk):
    """The JAX oracle at the kernel's internal chunk: it raises unless s
    divides by the chunk, so the last chunk is padded with dt = 0, x = 0
    (B, C = 0), which changes no row of y or the state, and cut off."""
    x, dt, a, B, C, d_skip = args
    s = x.shape[1]
    l, nc = chunking(s, chunk)
    pad = nc * l - s
    padded = (np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))), np.pad(dt, ((0, 0), (0, pad), (0, 0))),
              a, np.pad(B, ((0, 0), (0, pad), (0, 0))), np.pad(C, ((0, 0), (0, pad), (0, 0))),
              d_skip)
    y, state = jax_ssd_ref(*map(jnp.asarray, padded), chunk=l)
    return np.asarray(y)[:, :s], np.asarray(state)


def check_against_refs(args, chunk):
    y, state = kernel_model(*map(t, args), chunk=chunk)
    y_ref, st_ref = ssd_scan_ref(*map(t, args), chunk=chunk)
    torch.testing.assert_close(y, y_ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(state, st_ref, rtol=TOL, atol=TOL)
    y_jax, st_jax = jax_at_kernel_chunk(args, chunk)
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(state.numpy(), st_jax, rtol=TOL, atol=TOL)


def widths(cfg):
    return cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state


class TestDecomposition:
    def test_warp_scan_is_a_cumsum(self):
        v = -torch.rand(3, 64, dtype=torch.float64)
        for n in (1, 2, 31, 63, 64):
            torch.testing.assert_close(warp_scan(v[:, :n]), torch.cumsum(v[:, :n], -1))

    @pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
    @pytest.mark.parametrize("s", [64, 130])
    def test_smoke_widths(self, arch, s):
        nh, hd, ns = widths(get_smoke_config(arch))
        check_against_refs(ssd_inputs(np.random.default_rng(s), 2, s, nh, hd, ns), 128)

    @pytest.mark.parametrize("s,nh,hd,ns,chunk", [
        (128, 4, 32, 16, 32), (64, 2, 64, 128, 64), (96, 50, 64, 16, 32),  # the JAX grid
    ])
    def test_jax_test_grid(self, s, nh, hd, ns, chunk):
        check_against_refs(ssd_inputs(np.random.default_rng(nh), 2, s, nh, hd, ns), chunk)

    @pytest.mark.parametrize("s", [1, 63, 64, 65, 257])
    def test_ragged_lengths(self, s):
        """Chunk 64 (mamba2's 128 capped by the kernel), the last chunk
        ragged or a single row."""
        check_against_refs(ssd_inputs(np.random.default_rng(s), 1, s, 3, 32, 16), 128)

    @settings(max_examples=25, deadline=None)
    @given(s=st.integers(1, 200), nh=st.integers(1, 5), hd=st.sampled_from([8, 16, 40, 64, 72]),
           ns=st.sampled_from([4, 8, 16, 24, 128]), chunk=st.sampled_from([8, 16, 40, 64, 128]),
           seed=st.integers(0, 2 ** 16))
    def test_sweep(self, s, nh, hd, ns, chunk, seed):
        check_against_refs(ssd_inputs(np.random.default_rng(seed), 1, s, nh, hd, ns), chunk)

    def test_grid_fills_the_card(self):
        """Steps 2 and 4 run one block per (hd tile, chunk, head): 240 blocks
        at mamba2-780m's 257-token prompt, 1050 at hymba-1.5b's 1328 rows,
        where the first kernel ran 96 and 50 blocks that walked every chunk."""
        for arch, s, want in (("mamba2-780m", 257, 240), ("hymba-1.5b", 1328, 1050)):
            nh, hd, _ = widths(get_config(arch))
            l, nc = chunking(s, 128)
            assert l == KERNEL_CHUNK and -(-hd // HD_TILE) * nc * nh == want
        assert chunking(45, 16) == (16, 3) and chunking(1, 128) == (1, 1)


def full_width_inputs(arch, s, seed):
    nh, hd, ns = widths(get_config(arch))
    return [t(v) for v in ssd_inputs(np.random.default_rng(seed), 1, s, nh, hd, ns)]


class TestTF32Split:
    """At full width, against the float64 run of the same decomposition."""

    @pytest.mark.parametrize("arch,s", [("mamba2-780m", 256), ("hymba-1.5b", 1280)])
    def test_3xtf32_is_f32_accurate(self, arch, s):
        args = full_width_inputs(arch, s, 0)
        y64, st64 = kernel_model(*[v.double() for v in args])
        y, st = kernel_model(*args, mm=mm_tf32)
        assert float((y.double() - y64).abs().max()) <= TOL
        assert float((st.double() - st64).abs().max()) <= TOL

    def test_1xtf32_is_too_coarse(self):
        """The reason for the split: one TF32 rounding per operand leaves
        about 7e-4 in y at mamba2-780m widths, above the 1e-4 the card check
        of the full mamba2 case holds the kernel to."""
        args = full_width_inputs("mamba2-780m", 256, 0)
        y64, _ = kernel_model(*[v.double() for v in args])
        y, _ = kernel_model(*args, mm=lambda p, q: mm_tf32(p, q, split=False))
        assert float((y.double() - y64).abs().max()) > 1e-4


class FakeKernels:
    """A stand-in for the compiled library's ``ssd_scan_design`` query."""

    def __init__(self, values):
        self.values = values

    def ssd_scan_design(self, buf, n):
        for i, v in enumerate(self.values[:n]):
            buf[i] = v
        return len(self.values)


class TestDesignCheck:
    def test_design_names_the_wrapper_constants(self):
        assert ssd_ops.DESIGN == {"kernel_chunk": ssd_ops.KERNEL_CHUNK,
                                  "hd_tile": ssd_ops.HD_TILE, "threads": ssd_ops.THREADS}
        assert ssd_ops.THREADS // 32 * 16 == ssd_ops.KERNEL_CHUNK == ssd_ops.HD_TILE

    def test_matching_design_passes_once(self, monkeypatch):
        monkeypatch.setattr(build, "_DESIGN_CHECKED", set())
        build.check_design("ssd_scan", ssd_ops.DESIGN, FakeKernels(list(ssd_ops.DESIGN.values())))
        build.check_design("ssd_scan", ssd_ops.DESIGN, object())  # checked: not asked again

    @pytest.mark.parametrize("drift", ["one value", "one more value", "one value fewer"])
    def test_drifted_design_refuses(self, monkeypatch, drift):
        monkeypatch.setattr(build, "_DESIGN_CHECKED", set())
        values = list(ssd_ops.DESIGN.values())
        if drift == "one value":
            values[0] //= 2
        elif drift == "one more value":
            values.append(7)
        else:
            values.pop()
        with pytest.raises(RuntimeError, match="compiled kernel reports"):
            build.check_design("ssd_scan", ssd_ops.DESIGN, FakeKernels(values))
        assert "ssd_scan" not in build._DESIGN_CHECKED

    def test_cpu_tensors_take_the_plain_version(self, monkeypatch):
        """On CPU tensors the wrapper never asks for the library."""
        monkeypatch.setattr(build, "library", lambda: pytest.fail("library asked for"))
        args = [t(v) for v in ssd_inputs(np.random.default_rng(1), 1, 9, 2, 8, 4)]
        before = ssd_ops.ssd_scan.launches
        y, _ = ssd_ops.ssd_scan(*args, chunk=4)
        assert ssd_ops.ssd_scan.launches == before and y.shape == (1, 9, 2, 8)
