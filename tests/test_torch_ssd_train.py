"""The SSD scan's gradient in the port (``kernels/ssd_scan/ops.py::SSDScan``)
against the JAX package on the CPU, and SSM / hybrid training through it.

* The Function's y, final state and all six gradients (x, dt, a, B, C,
  d_skip) against ``jax.grad`` through ``repro.models.ssm._ssd_chunked``
  plus the D term (``repro.kernels.ssd_scan.ref``), on seeded numpy
  inputs at chunk-aligned lengths (the reference refuses others), and at
  ragged lengths against the reference run as one chunk (any length):
  the rows the port pads take no gradient and shift none.
* The decay extremes (dt 5 with a = -8, and dt 1e-3 with a = -0.01):
  finite gradients, equal to the reference's.
* Against torch autograd through the plain version ``ssd_scan_ref``
  (outputs bit-equal on the CPU, gradients to the same limit: the
  backward is derived by hand and sums in another order); a loss that
  reads only the final state, one that reads only y, and inputs of which
  only some require grad.
* Under ``torch.no_grad()`` the wrapper builds no graph.
* ``launch.train --smoke --device cpu`` for mamba2-780m and hymba-1.5b:
  ``--resume`` repeats the uninterrupted run's losses exactly.

Limits (f32 on both sides): 1e-4 in ||err|| / ||ref|| for every output and
gradient; the gradient of ``a`` ([nh], a sum over all b x s rows) is
compared whole, in the same norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref
from repro_torch.kernels.ssd_scan.ops import SSDScan, ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

REL = 1e-4
NAMES = ("x", "dt", "a", "B", "C", "d_skip")


def ssd_inputs(rng, b, s, nh, hd, ns, dt_fill=None, a=None):
    """tests/test_kernels.py's ssd_scan inputs, as numpy."""
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32) * 0.5
    if dt_fill is None:
        dt = (np.abs(rng.standard_normal((b, s, nh))) * 0.1 + 0.01).astype(np.float32)
    else:
        dt = np.full((b, s, nh), dt_fill, np.float32)
    if a is None:
        a = -(np.abs(rng.standard_normal(nh)) + 0.5).astype(np.float32)
    B = rng.standard_normal((b, s, ns)).astype(np.float32) * 0.3
    C = rng.standard_normal((b, s, ns)).astype(np.float32) * 0.3
    d_skip = rng.standard_normal(nh).astype(np.float32)
    return [x, dt, np.asarray(a, np.float32), B, C, d_skip]


def rel(got, ref) -> float:
    got, ref = (t.detach().double().numpy() if isinstance(t, torch.Tensor) else t
                for t in (got, ref))
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - ref)
                 / max(np.linalg.norm(ref), 1e-30))


def jax_value_and_grads(args, gy, gs, chunk):
    """y, state and the six gradients of sum(y * gy) + sum(state * gs)
    through the reference's oracle."""
    def loss(*xs):
        y, st = jax_ssd_ref(*xs, chunk=chunk)
        return jnp.sum(y * gy) + jnp.sum(st * gs), (y, st)

    (_, (y, st)), grads = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(
        *map(jnp.asarray, args))
    return np.asarray(y), np.asarray(st), [np.asarray(g) for g in grads]


def port_value_and_grads(args, gy, gs, chunk, fn=ssd_scan):
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    y, st = fn(*leaves, chunk=chunk)
    ((y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gs)).sum()).backward()
    return y, st, [t.grad for t in leaves]


def cotangents(rng, args):
    b, s, nh, hd = args[0].shape
    ns = args[3].shape[-1]
    return (rng.standard_normal((b, s, nh, hd)).astype(np.float32),
            rng.standard_normal((b, nh, hd, ns)).astype(np.float32))


@pytest.mark.parametrize("b,s,nh,hd,ns,chunk,kw", [
    (2, 64, 4, 16, 8, 16, {}),                                   # 4 chunks
    (1, 96, 3, 8, 16, 32, {}),                                   # 3 chunks, ns > hd
    (2, 128, 4, 32, 16, 128, {}),                                # one chunk
    (1, 64, 2, 16, 8, 16, dict(dt_fill=5.0, a=[-0.01, -8.0])),   # decays to exp(-640)
    (1, 64, 2, 16, 8, 16, dict(dt_fill=1e-3, a=[-0.01, -8.0])),  # hardly any decay
])
def test_function_matches_jax_grad(b, s, nh, hd, ns, chunk, kw):
    rng = np.random.default_rng(s + nh + hd)
    args = ssd_inputs(rng, b, s, nh, hd, ns, **kw)
    gy, gs = cotangents(rng, args)
    jy, jst, jgrads = jax_value_and_grads(args, gy, gs, chunk)
    y, st, grads = port_value_and_grads(args, gy, gs, chunk)
    assert isinstance(y.grad_fn, SSDScan._backward_cls)
    assert rel(y, jy) < REL and rel(st, jst) < REL
    for name, g, ref in zip(NAMES, grads, jgrads):
        assert g.shape == ref.shape and torch.isfinite(g).all(), name
        assert rel(g, ref) < REL, f"d{name}: {rel(g, ref)}"


@pytest.mark.parametrize("b,s,nh,hd,ns,chunk", [(2, 70, 3, 8, 5, 32), (1, 130, 4, 16, 16, 64),
                                                (1, 45, 2, 8, 4, 16)])
def test_ragged_lengths_match_jax_as_one_chunk(b, s, nh, hd, ns, chunk):
    """The port pads the last chunk with dt = 0, x = 0; the reference, run
    as one chunk of s rows, pads nothing.  Equal gradients show that the
    padded rows take none and shift none of the real rows'."""
    rng = np.random.default_rng(s)
    args = ssd_inputs(rng, b, s, nh, hd, ns)
    gy, gs = cotangents(rng, args)
    jy, jst, jgrads = jax_value_and_grads(args, gy, gs, s)
    y, st, grads = port_value_and_grads(args, gy, gs, chunk)
    assert rel(y, jy) < REL and rel(st, jst) < REL
    for name, g, ref in zip(NAMES, grads, jgrads):
        assert rel(g, ref) < REL, f"d{name}: {rel(g, ref)}"


@pytest.mark.parametrize("s,chunk,kw", [(70, 32, {}), (257, 128, {}),
                                        (50, 16, dict(dt_fill=5.0, a=[-0.01, -8.0]))])
@pytest.mark.parametrize("reads", ["both", "y", "state"])
def test_function_equals_autograd_through_the_plain_version(s, chunk, kw, reads):
    rng = np.random.default_rng(s + len(reads))
    args = ssd_inputs(rng, 2, s, 2, 8, 6, **kw)
    gy, gs = cotangents(rng, args)
    gy = gy if reads != "state" else np.zeros_like(gy)
    gs = gs if reads != "y" else np.zeros_like(gs)

    def only(fn):
        def call(*xs, chunk):
            y, st = fn(*xs, chunk=chunk)
            # an output the loss does not read gets no gradient at all
            return (y if reads != "state" else y.detach(),
                    st if reads != "y" else st.detach())
        return call

    y, st, grads = port_value_and_grads(args, gy, gs, chunk, only(ssd_scan))
    ry, rst, rgrads = port_value_and_grads(args, gy, gs, chunk, only(ssd_scan_ref))
    assert torch.equal(y, ry) and torch.equal(st, rst)
    for name, g, ref in zip(NAMES, grads, rgrads):
        assert torch.isfinite(g).all(), name
        if ref is None:  # the final state reads neither C nor d_skip
            assert reads == "state" and name in ("C", "d_skip") and not g.any(), name
        else:
            assert rel(g, ref) < REL, f"d{name}: {rel(g, ref)}"


def test_only_some_inputs_require_grad():
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a) for a in ssd_inputs(rng, 1, 40, 2, 8, 4)]
    x, a = args[0].clone().requires_grad_(True), args[2].clone().requires_grad_(True)
    y, _ = ssd_scan(x, args[1], a, *args[3:], chunk=16)
    y.sum().backward()
    xr, ar = args[0].clone().requires_grad_(True), args[2].clone().requires_grad_(True)
    ssd_scan_ref(xr, args[1], ar, *args[3:], chunk=16)[0].sum().backward()
    assert rel(x.grad, xr.grad) < REL and rel(a.grad, ar.grad) < REL
    assert all(t.grad is None for t in args)


def test_bf16_x_takes_a_bf16_gradient():
    """x in bf16 (as ``ssm_prefill`` never passes it, but the wrapper
    takes): dx comes back in bf16, within bf16 rounding of autograd
    through the plain version."""
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a) for a in ssd_inputs(rng, 1, 80, 2, 8, 4)]
    args[0] = args[0].bfloat16()
    x = args[0].clone().requires_grad_(True)
    xr = args[0].clone().requires_grad_(True)
    ssd_scan(x, *args[1:], chunk=32)[0].float().sum().backward()
    ssd_scan_ref(xr, *args[1:], chunk=32)[0].float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and rel(x.grad, xr.grad) < 1e-2


def test_no_grad_builds_no_graph():
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(a).requires_grad_(True) for a in ssd_inputs(rng, 1, 33, 2, 8, 4)]
    with torch.no_grad():
        y, st = ssd_scan(*args, chunk=16)
    assert y.grad_fn is None and st.grad_fn is None and not y.requires_grad
    plain = [t.detach() for t in args]
    y, st = ssd_scan(*plain, chunk=16)  # grad enabled, nothing requires it
    assert y.grad_fn is None and st.grad_fn is None


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_launch_train_resume_repeats_the_losses(arch, tmp_path, capsys):
    from repro_torch.launch import train

    common = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "48",
              "--lr", "3e-3"]
    full = train.main(common + ["--steps", "4"])["losses"]
    first = train.main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path),
                                 "--ckpt-every", "2"])["losses"]
    rest = train.main(common + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                                "--ckpt-every", "100", "--resume"])["losses"]
    assert first + rest == full
    assert all(np.isfinite(full))
    out = capsys.readouterr().out
    assert "[train] checkpointed step 2" in out and "[train] resumed from step 2" in out
