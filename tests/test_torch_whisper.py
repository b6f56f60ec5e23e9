"""The port's encoder-decoder (whisper) against the JAX package on the CPU:
same numpy frames and tokens, the JAX init cast to f32 and carried over
with ``repro_torch.bridge``; atol 1e-4 as tests/test_torch_model.py holds
the decoders (f32 matmuls summed in another order).

* ``layernorm`` and the tanh-form GELU MLP against the reference's;
* ``encode``; prefill logits, self-KV pages and cross K/V; 8 greedy
  decode steps;
* prefill(p) + decode_step(t) against prefill(p + t);
* the ``EncDecState`` bridge round trip, and the params' layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import layers as jax_layers
from repro.models.whisper import EncDecLM as JaxEncDecLM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import layers
from repro_torch.models.registry import build_model
from repro_torch.models.whisper import EncDecLM, EncDecState

ARCH = "whisper-large-v3"
ATOL = 1e-4


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 32)) * 3 + 1).astype(np.float32)
    scale, bias = rng.standard_normal(32).astype(np.float32), rng.standard_normal(32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_layers.layernorm({"scale": jnp.asarray(scale, jd), "bias": jnp.asarray(bias, jd)},
                               jnp.asarray(x, jd))
    out = layers.layernorm({"scale": t(scale).to(td), "bias": t(bias).to(td)}, t(x).to(td))
    assert out.dtype == td
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def test_gelu_mlp_is_the_tanh_form():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16)).astype(np.float32) * 3
    p = {"up": {"w": rng.standard_normal((16, 32)).astype(np.float32),
                "b": rng.standard_normal(32).astype(np.float32)},
         "down": {"w": rng.standard_normal((32, 16)).astype(np.float32),
                  "b": rng.standard_normal(16).astype(np.float32)}}
    ref = jax_layers.dense(p["down"], jax.nn.gelu(jax_layers.dense(p["up"], jnp.asarray(x))))
    out = layers.gelu_mlp(bridge.params_from_jax(p), t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)
    erf = layers.dense(bridge.params_from_jax(p)["down"], torch.nn.functional.gelu(
        layers.dense(bridge.params_from_jax(p)["up"], t(x))))
    assert float((erf - out).abs().max()) > 1e-4  # the erf form is another function


@pytest.fixture(scope="module")
def models():
    cfg = get_smoke_config(ARCH)
    # unrolled: the reference's encode casts the frames to bf16, and with f32
    # weights its first layer promotes the residual to f32, which a scan
    # carry refuses; the layers' math is the same either way
    jm = JaxEncDecLM(cfg, unroll=True)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init_params(jax.random.PRNGKey(0)))
    pm = build_model(pt_smoke_config(ARCH), device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, pm, pp


def inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def test_build_model_gives_an_encdec_lm(models):
    cfg, _, jp, pm, _ = models
    assert isinstance(pm, EncDecLM)
    pt = pm.init_params(0)
    got = {jax.tree_util.keystr(k): tuple(v.shape)
           for k, v in jax.tree_util.tree_flatten_with_path(pt)[0]}
    want = {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got == want


def test_encode_matches(models):
    cfg, jm, jp, pm, pp = models
    frames = inputs(cfg, 2, 1, seed=2)["frames"]
    ref = jm.encode(jp, jnp.asarray(frames))
    out = pm.encode(pp, torch.from_numpy(frames))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,s", [(1, 4), (2, 33), (1, 130)])
def test_prefill_and_greedy_decode_match(models, b, s):
    cfg, jm, jp, pm, pp = models
    batch = inputs(cfg, b, s, seed=s)
    jl, js = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)
    prefill_step, serve_step = make_prefill_step(pm), make_serve_step(pm)
    pl, ps = pm.prefill(pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert isinstance(ps, EncDecState)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for name in ("k_pages", "v_pages", "cross_k", "cross_v"):
        np.testing.assert_allclose(getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=ATOL, rtol=0)
    for name in ("block_tables", "context_lens"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(), np.asarray(getattr(js, name)))
    tok, state = prefill_step(pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    for _ in range(8):
        jtok = np.asarray(jnp.argmax(jl[:, : cfg.vocab_size], axis=-1), np.int32)
        assert np.array_equal(tok.numpy(), jtok)
        jl, js = jm.decode_step(jp, js, jnp.asarray(jtok))
        pl, ps = pm.decode_step(pp, ps, torch.tensor(jtok))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        tok, state = serve_step(pp, state, tok)
    np.testing.assert_allclose(ps.k_pages.numpy(), np.asarray(js.k_pages), atol=ATOL, rtol=0)
    assert ps.context_lens.tolist() == [s + 8] * b


def test_prefill_plus_decode_equals_longer_prefill(models):
    cfg, _, _, pm, pp = models
    batch = {k: torch.from_numpy(v) for k, v in inputs(cfg, 1, 33, seed=5).items()}
    ref, _ = pm.prefill(pp, batch)
    _, state = pm.prefill(pp, {"frames": batch["frames"], "tokens": batch["tokens"][:, :-1]})
    out, _ = pm.decode_step(pp, state, batch["tokens"][:, -1])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)


def test_encdec_state_bridge_round_trip(models):
    cfg, jm, jp, _, _ = models
    batch = inputs(cfg, 2, 20, seed=6)
    _, js = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)
    ps = bridge.state_from_jax(jax.tree.map(np.asarray, js))
    assert isinstance(ps, EncDecState)
    back = bridge.state_to_numpy(ps)
    assert set(back) == {"context_lens", "k_pages", "v_pages", "block_tables", "cross_k",
                         "cross_v"}
    for name, arr in back.items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(js, name)))
    bf = bridge.state_from_jax(jax.tree.map(np.asarray, js), dtype=torch.bfloat16)
    assert bf.cross_k.dtype == torch.bfloat16 and bf.block_tables.dtype == torch.int32


def test_encdec_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pt_smoke_config(ARCH)
    for make in (lambda: EncDecLM(cfg), lambda: build_model(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(0, device="cuda")
    assert model.init_params(0)["dec_pos"].device.type == "cpu"
