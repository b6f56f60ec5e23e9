"""The port's VLM path (llava, early fusion of ``vision_embeds``) against
the JAX package on the CPU: same numpy inputs, the JAX init cast to f32
and carried over with ``repro_torch.bridge``; logits and pages to atol
1e-4, as tests/test_torch_model.py holds the dense decoders.

* prefill with the image tokens in front of the text (context lengths
  and positions count them), then 8 greedy decode steps;
* a text-only prompt, which takes the dense path;
* the prompt's pages parked in a ``PagedKVCache``, pulled with
  ``pull_kv`` into another and decoded from there: the monolithic tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models.transformer import DecoderLM as JaxDecoderLM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.registry import build_model
from repro_torch.serving.kv_link import KVLink

ARCH = "llava-next-mistral-7b"
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg = get_smoke_config(ARCH)
    jm = JaxDecoderLM(cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init_params(jax.random.PRNGKey(0)))
    pm = build_model(pt_smoke_config(ARCH), device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, pm, pp


def inputs(cfg, b, s, seed, image=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if image:
        batch["vision_embeds"] = (rng.standard_normal((b, cfg.vision_tokens, cfg.d_model))
                                  * 0.02).astype(np.float32)
    return batch


@pytest.mark.parametrize("b,s,image", [(1, 96, True), (2, 45, True), (2, 45, False)])
def test_prefill_and_greedy_decode_match(models, b, s, image):
    cfg, jm, jp, pm, pp = models
    batch = inputs(cfg, b, s, seed=s, image=image)
    jl, js = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)
    pl, ps = pm.prefill(pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    n_img = cfg.vision_tokens if image else 0
    assert ps.context_lens.tolist() == [n_img + s] * b
    np.testing.assert_array_equal(ps.context_lens.numpy(), np.asarray(js.context_lens))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=ATOL, rtol=0)
    for _ in range(8):
        tok = np.asarray(jnp.argmax(jl[:, : cfg.vocab_size], axis=-1), np.int32)
        jl, js = jm.decode_step(jp, js, jnp.asarray(tok))
        pl, ps = pm.decode_step(pp, ps, torch.tensor(tok))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ps.v_pages.numpy(), np.asarray(js.v_pages), atol=ATOL, rtol=0)


def test_bf16_weights_take_f32_image_embeddings(models):
    """The embeddings are cast to the embedding table's dtype, as the
    reference's ``astype(x.dtype)``."""
    cfg, _, _, pm, _ = models
    params = pm.init_params(0)
    batch = inputs(cfg, 1, 33, seed=2)
    logits, state = pm.prefill(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.k_pages.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
    assert int(state.context_lens[0]) == cfg.vision_tokens + 33


def test_image_prompt_pulled_and_decoded_equals_monolithic(models):
    cfg, _, _, pm, pp = models
    batch = {k: torch.from_numpy(v) for k, v in inputs(cfg, 1, 70, seed=3).items()}
    prefill_step, serve_step = make_prefill_step(pm), make_serve_step(pm)
    tok, state = prefill_step(pp, batch)
    snapshot = dataclasses.replace(state, k_pages=state.k_pages.clone(),
                                   v_pages=state.v_pages.clone())
    mono, t = [int(tok[0])], tok
    for _ in range(8):
        t, state = serve_step(pp, state, t)
        mono.append(int(t[0]))

    n_ctx = int(snapshot.context_lens[0])
    n_pages = -(-n_ctx // 32)
    link = KVLink(pm.cfg, num_blocks=16, dtype=torch.float32, device="cpu")
    pulled, moved = link.pull("r0", snapshot, [11, 3, 7, 0][:n_pages], max_new=8)
    assert moved == cfg.num_layers * n_pages * 2 * link.dec.block_nbytes
    assert torch.equal(pulled.k_pages, snapshot.k_pages)
    assert torch.equal(pulled.v_pages, snapshot.v_pages)
    got, t = [int(tok[0])], tok
    for _ in range(8):
        t, pulled = serve_step(pp, pulled, t)
        got.append(int(t[0]))
    assert got == mono
