"""The layer kernels' plain versions and routing, on the CPU
(``kernels/{rmsnorm,rope,silu_mul}``; the kernels themselves run only on
the card, ``tests/test_torch_layer_kernels_cuda.py``).

* Each plain version, and each wrapper on CPU tensors, equals bit for bit
  the expression the model ran before the kernels (``PARENT_*`` below,
  kept here as they were), at the widths the cells run.
* Routing: CPU and meta tensors, and calls that need a gradient, take the
  plain version; on the card's route dtypes the kernels lack raise; the
  dry-run's counts are those of the parent expressions;
  a training step's gradients are the parent expressions' bit for bit,
  with the card's route made to look open (``build.on_cuda`` answering
  True and a library that records every launch), so that only the
  gradient keeps the kernels out.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.rmsnorm.ref import add_rmsnorm_ref, rmsnorm_ref
from repro_torch.kernels.rope import ops as rope_ops
from repro_torch.kernels.rope.ref import rope_ref
from repro_torch.kernels.silu_mul import ops as silu_ops
from repro_torch.kernels.silu_mul.ref import silu_mul_ref
from repro_torch.launch import dryrun
from repro_torch.models import attention, layers, moe, transformer
from repro_torch.models.registry import build_model
from repro_torch.tree import leaves

DTYPES = [torch.float32, torch.bfloat16]
ROWS = [1, 2, 3, 4, 5]
WIDTHS = [64, 128, 1536, 4096]
HEADS = [(32, 4), (24, 8)]       # Yi-9B's and granite's q heads / kv groups
HEAD_DIMS = [128, 64]


# ------------------------------------------------ the parent's expressions
def PARENT_rmsnorm(p, x, eps: float = 1e-5):
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * p["scale"].float()).to(x.dtype)


def PARENT_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def PARENT_silu_mul(a, b):
    return torch.nn.functional.silu(a) * b


def parent_add_rmsnorm(x, residual, scale, eps):
    total = x + residual
    return total, PARENT_rmsnorm({"scale": scale}, total, eps)


def use_parent_expressions(mp):
    """The model's calls of the three wrappers answered by the parent's
    expressions."""
    mp.setattr(rmsnorm_ops, "rmsnorm", lambda x, s, eps: PARENT_rmsnorm({"scale": s}, x, eps))
    mp.setattr(rmsnorm_ops, "add_rmsnorm", parent_add_rmsnorm)
    rope_qk = (lambda q, k, pos, theta: (PARENT_rope(q, pos, theta), PARENT_rope(k, pos, theta)))
    mp.setattr(attention, "rope_qk", rope_qk)
    mp.setattr(transformer, "rope_qk", rope_qk)
    mp.setattr(layers, "silu_mul", PARENT_silu_mul)
    mp.setattr(moe, "silu_mul", PARENT_silu_mul)


def draw(*shape, dtype, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale).to(dtype)


def equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ------------------------------------------------------ plain versions
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plain_is_the_parent_expression(dtype, rows, d):
    x, res = draw(rows, d, dtype=dtype, scale=3.0), draw(rows, d, dtype=dtype, seed=1)
    scale = draw(d, dtype=dtype, seed=2)
    want = PARENT_rmsnorm({"scale": scale}, x, 1e-5)
    assert equal(rmsnorm_ref(x, scale, 1e-5), want)
    assert equal(layers.rmsnorm({"scale": scale}, x, 1e-5), want)
    total = x + res
    want_sum = PARENT_rmsnorm({"scale": scale}, total, 1e-6)
    for got in (add_rmsnorm_ref(x, res, scale, 1e-6),
                layers.add_rmsnorm({"scale": scale}, x, res, 1e-6)):
        assert equal(got[0], total) and equal(got[1], want_sum)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_plain_is_the_parent_expression(dtype, rows, heads, hd):
    """Decode's shapes (a token a row at its own position, up to 4096) and
    prefill's (rows tokens of one sequence, positions broadcast)."""
    h, g = heads
    g_pos = torch.Generator().manual_seed(3)
    pos = torch.randint(0, 4097, (rows,), generator=g_pos, dtype=torch.int32)
    q, k = draw(rows, 1, h, hd, dtype=dtype), draw(rows, 1, g, hd, dtype=dtype, seed=1)
    want_q, want_k = PARENT_rope(q, pos[:, None], 1e4), PARENT_rope(k, pos[:, None], 1e4)
    assert equal(rope_ref(q, pos[:, None], 1e4), want_q)
    got_q, got_k = rope_ops.rope(q, k, pos[:, None], 1e4)
    assert equal(got_q, want_q) and equal(got_k, want_k)
    assert equal(attention.rope(q, pos[:, None], 1e4), want_q)
    # a prefill of rows tokens, the positions broadcast over a batch of 2
    qs, ks = q.reshape(1, rows, h, hd).expand(2, -1, -1, -1), k.reshape(1, rows, g, hd)
    ps = (torch.arange(rows) + 4096 - rows)[None].expand(2, rows)
    got_q, got_k = rope_ops.rope(qs, ks.expand(2, -1, -1, -1), ps, 5e5)
    assert equal(got_q, PARENT_rope(qs, ps, 5e5))
    assert equal(got_k, PARENT_rope(ks.expand(2, -1, -1, -1), ps, 5e5))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_silu_mul_plain_is_the_parent_expression(dtype, rows, d):
    a, b = draw(rows, d, dtype=dtype, scale=4.0), draw(rows, d, dtype=dtype, seed=1)
    want = PARENT_silu_mul(a, b)
    assert equal(silu_mul_ref(a, b), want) and equal(silu_ops.silu_mul(a, b), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_and_the_experts_are_the_parent_expressions(dtype):
    gen = torch.Generator().manual_seed(4)
    p = {name: layers.dense_init(gen, a, c) for name, a, c in
         (("gate", 64, 96), ("up", 64, 96), ("down", 96, 64))}
    p = {k: {"w": v["w"].to(dtype)} for k, v in p.items()}
    x = draw(3, 64, dtype=dtype)
    want = layers.dense(p["down"], PARENT_silu_mul(layers.dense(p["gate"], x),
                                                   layers.dense(p["up"], x)))
    assert equal(layers.swiglu(p, x), want)
    xe, gate, up, down = (draw(*s, dtype=dtype, seed=i, scale=0.2) for i, s in enumerate(
        [(4, 6, 64), (4, 64, 32), (4, 64, 32), (4, 32, 64)]))
    want = torch.bmm(PARENT_silu_mul(torch.bmm(xe, gate), torch.bmm(xe, up)), down)
    assert equal(moe._ffn_local(xe, gate, up, down), want)


# ------------------------------------------------------------- routing
class FakeLibrary:
    """Stands in for the kernel library: records each launch, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)
        return lambda *args: self.calls.append(name) or 0


@pytest.fixture
def card_route(monkeypatch):
    """``build.on_cuda`` answers True for CPU tensors, so that only the
    other conditions of the route decide; the launches land in a fake."""
    fake = FakeLibrary()
    real_on_cuda = build.on_cuda
    monkeypatch.setattr(build, "on_cuda", lambda name, *ts: real_on_cuda(name, *ts) or True)
    monkeypatch.setattr(build, "library", lambda: fake)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    return fake


def three_calls(x, res, scale, q, k, pos):
    return (rmsnorm_ops.rmsnorm(x, scale, 1e-5), rmsnorm_ops.add_rmsnorm(x, res, scale, 1e-5),
            rope_ops.rope(q, k, pos, 1e4), silu_ops.silu_mul(x, res))


def inputs(dtype=torch.bfloat16, device="cpu"):
    x, res, scale = (draw(3, 128, dtype=dtype, seed=i) for i in range(3))
    q, k = draw(3, 8, 64, dtype=dtype, seed=3), draw(3, 2, 64, dtype=dtype, seed=4)
    pos = torch.tensor([5, 90, 4000], dtype=torch.int32)
    ts = [x, res, scale[0], q, k, pos]
    return [t.to(device) for t in ts]


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was asked for on CPU tensors")
    monkeypatch.setattr(build, "library", refuse)
    counts = (rmsnorm_ops.rmsnorm.launches, rmsnorm_ops.add_rmsnorm.launches,
              rope_ops.rope.launches, silu_ops.silu_mul.launches)
    three_calls(*inputs())
    assert counts == (rmsnorm_ops.rmsnorm.launches, rmsnorm_ops.add_rmsnorm.launches,
                      rope_ops.rope.launches, silu_ops.silu_mul.launches)


def test_the_card_route_launches_once_a_call_without_autograd(card_route):
    """With the route open and nothing needing a gradient, each wrapper
    launches its kernel once (the routing test below is not vacuous)."""
    before = (rmsnorm_ops.rmsnorm.launches, rope_ops.rope.launches)
    with torch.no_grad():
        three_calls(*inputs())
    assert card_route.calls == ["rmsnorm_launch", "rmsnorm_launch", "rope_launch",
                                "silu_mul_launch"]
    assert (rmsnorm_ops.rmsnorm.launches, rope_ops.rope.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("case", ["float64", "float16", "mixed", "float positions"])
def test_the_card_route_refuses_dtypes_the_kernels_lack(card_route, case):
    """The kernels take float32 and bfloat16, each call's tensors in one
    dtype, and integer positions: anything else raises on the card rather
    than quietly taking the plain version."""
    x, res, scale, q, k, pos = inputs()
    if case in ("float64", "float16"):
        dt = getattr(torch, case)
        x, res, scale, q, k = (t.to(dt) for t in (x, res, scale, q, k))
        calls = [lambda: rmsnorm_ops.rmsnorm(x, scale, 1e-5),
                 lambda: rmsnorm_ops.add_rmsnorm(x, res, scale, 1e-5),
                 lambda: rope_ops.rope(q, k, pos, 1e4), lambda: silu_ops.silu_mul(x, res)]
    elif case == "mixed":
        calls = [lambda: rmsnorm_ops.rmsnorm(x, scale.float(), 1e-5),
                 lambda: rmsnorm_ops.add_rmsnorm(x, res.float(), scale, 1e-5),
                 lambda: rope_ops.rope(q, k.float(), pos, 1e4),
                 lambda: silu_ops.silu_mul(x, res.float())]
    else:
        calls = [lambda: rope_ops.rope(q, k, pos.float(), 1e4)]
    for call in calls:
        with torch.no_grad(), pytest.raises(ValueError):
            call()
    assert card_route.calls == []


def test_calls_that_need_a_gradient_take_the_plain_versions(card_route):
    x, res, scale, q, k, pos = inputs()
    for t in (x, q):
        t.requires_grad_(True)
    got = three_calls(x, res, scale, q, k, pos)
    assert card_route.calls == []
    assert equal(got[0], PARENT_rmsnorm({"scale": scale}, x))
    assert equal(got[2][0], PARENT_rope(q, pos, 1e4))
    assert got[0].requires_grad and got[2][0].requires_grad and got[3].requires_grad
    # a scale that requires grad alone also keeps the kernel out
    x2 = x.detach()
    scale.requires_grad_(True)
    rmsnorm_ops.rmsnorm(x2, scale, 1e-5)
    assert card_route.calls == []


def test_meta_tensors_take_the_plain_versions(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was asked for on meta tensors")
    monkeypatch.setattr(build, "library", refuse)
    build.reset_meta()
    x, res, scale, q, k, pos = inputs(device="meta")
    norm, (total, normed), (rq, rk), act = three_calls(x, res, scale, q, k, pos)
    assert all(t.is_meta and t.shape == w.shape and t.dtype == w.dtype
               for t, w in ((norm, x), (total, x), (normed, x), (rq, q), (rk, k), (act, x)))
    assert build.META_WORK["calls"] == {}


def _count(arch, kind):
    cfg = get_smoke_config(arch)
    kw = dict(batch=2, seq=24)
    return dryrun.count(cfg, kind, {"data": 1, "model": 1}, 0, **kw)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-3b-a800m"])
def test_the_dry_runs_counts_are_the_parent_expressions(arch, kind, monkeypatch):
    got = _count(arch, kind)
    with monkeypatch.context() as mp:
        use_parent_expressions(mp)
        want = _count(arch, kind)
    for field in ("flops", "bytes_accessed", "temp_bytes", "records", "kernel_calls",
                  "argument_bytes"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-3b-a800m"])
def test_training_gradients_are_the_parent_expressions(arch, card_route, monkeypatch):
    """A smoke model's loss and every gradient, the card's route open,
    equal bit for bit those of the parent's expressions; no kernel
    launched."""
    cfg = get_smoke_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24), generator=g)}

    def grads():
        params = model.init_params(0)
        for p in leaves(params):
            p.requires_grad_(True)
        loss, _ = model.train_loss(params, batch)
        loss.backward()
        return loss.detach(), [p.grad for p in leaves(params)]

    got = grads()
    assert card_route.calls == []
    with monkeypatch.context() as mp:
        use_parent_expressions(mp)
        want = grads()
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
