"""The port's model layers and dense decoder against the JAX package on
the CPU: same numpy inputs, same weights (JAX init cast to f32 on both
sides and carried over with ``repro_torch.bridge``).  Logits agree to
atol 1e-4 (f32 matmuls summed in another order), KV pages likewise; the
layerwise step equals the full step exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import attention as jax_attention
from repro.models.layers import rmsnorm as jax_rmsnorm
from repro.models.transformer import DecoderLM as JaxDecoderLM
from repro_torch import bridge
from repro_torch.configs import ARCHS
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.models import attention
from repro_torch.models.layers import rmsnorm
from repro_torch.models.registry import build_model

ATOL = 1e-4


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


class TestLayers:
    def test_rope_matches(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
        pos = np.arange(12)[None].repeat(2, 0) + np.asarray([[0], [5]])
        ref = jax_attention.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
        out = attention.rope(t(x), torch.from_numpy(pos), 10_000.0)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
        bf = attention.rope(t(x).to(torch.bfloat16), torch.from_numpy(pos), 10_000.0)
        assert bf.dtype == torch.bfloat16  # angles in f32, output in x.dtype

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rmsnorm_matches(self, dtype):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((3, 5, 32)).astype(np.float32)
        scale = rng.standard_normal(32).astype(np.float32)
        jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
        td = torch.float32 if dtype == "float32" else torch.bfloat16
        ref = jax_rmsnorm({"scale": jnp.asarray(scale, jd)}, jnp.asarray(x, jd))
        out = rmsnorm({"scale": t(scale).to(td)}, t(x).to(td))
        assert out.dtype == td
        tol = 1e-5 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)

    @pytest.mark.parametrize("kw", [
        dict(causal=True),
        dict(causal=True, sliding_window=8, prefix_len=2),
        dict(causal=True, q_offset=3, kv_len=np.asarray([20, 9])),
        dict(causal=False, kv_len=np.asarray([0, 7])),  # row 0 fully masked
    ])
    def test_gqa_attention_matches(self, kw):
        rng = np.random.default_rng(2)
        q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
        k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
        v = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
        jkw = {a: (jnp.asarray(b) if isinstance(b, np.ndarray) else b) for a, b in kw.items()}
        pkw = {a: (torch.from_numpy(b) if isinstance(b, np.ndarray) else b)
               for a, b in kw.items()}
        ref = jax_attention.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
        out = attention.gqa_attention(t(q), t(k), t(v), **pkw)
        assert not torch.isnan(out).any()  # fully masked rows give 0
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)

    def test_write_token_and_paged_decode_match(self):
        rng = np.random.default_rng(3)
        b, per, bs, g, d, h = 2, 3, 8, 2, 16, 4
        kp = rng.standard_normal((b, per, bs, g, d)).astype(np.float32)
        vp = rng.standard_normal((b, per, bs, g, d)).astype(np.float32)
        q = rng.standard_normal((b, h, d)).astype(np.float32)
        kn = rng.standard_normal((b, g, d)).astype(np.float32)
        vn = rng.standard_normal((b, g, d)).astype(np.float32)
        tbl = np.asarray([[1, 0, 2], [0, 2, 1]], np.int32)
        ctx = np.asarray([7, 16], np.int32)  # tokens before the write
        ref_out, ref_pages = jax_attention.paged_decode_with_write(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            jax_attention.KVPages(jnp.asarray(kp), jnp.asarray(vp)),
            jnp.asarray(tbl), jnp.asarray(ctx))
        out, pages = attention.paged_decode_with_write(
            t(q), t(kn), t(vn), attention.KVPages(t(kp), t(vp)),
            torch.from_numpy(tbl), torch.from_numpy(ctx))
        np.testing.assert_array_equal(pages.k_pages.numpy(), np.asarray(ref_pages.k_pages))
        np.testing.assert_array_equal(pages.v_pages.numpy(), np.asarray(ref_pages.v_pages))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module", params=["deepseek-67b", "yi-9b"])
def models(request):
    cfg = get_smoke_config(request.param)
    jm = JaxDecoderLM(cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init_params(jax.random.PRNGKey(0)))
    pm = build_model(pt_smoke_config(request.param), device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, pm, pp


class TestDecoderParity:
    def test_prefill_and_greedy_decode_match(self, models):
        cfg, jm, jp, pm, pp = models
        rng = np.random.default_rng(4)
        toks = rng.integers(0, cfg.vocab_size, (2, 45)).astype(np.int32)  # ragged: 45
        jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, remat=False)
        pl, ps = pm.prefill(pp, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        for name in ("k_pages", "v_pages"):
            np.testing.assert_allclose(getattr(ps, name).numpy(),
                                       np.asarray(getattr(js, name)), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(ps.block_tables.numpy(), np.asarray(js.block_tables))
        np.testing.assert_array_equal(ps.context_lens.numpy(), np.asarray(js.context_lens))
        for _ in range(4):
            tok = np.asarray(jnp.argmax(jl[:, : cfg.vocab_size], axis=-1), np.int32)
            jl, js = jm.decode_step(jp, js, jnp.asarray(tok))
            pl, ps = pm.decode_step(pp, ps, torch.tensor(tok))
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        np.testing.assert_allclose(ps.k_pages.numpy(), np.asarray(js.k_pages), atol=ATOL,
                                   rtol=0)

    def test_layerwise_step_equals_full_step(self, models):
        cfg, _, _, pm, pp = models
        rng = np.random.default_rng(5)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 40)).astype(np.int32))
        logits, state = pm.prefill(pp, {"tokens": toks}, max_blocks_margin=1)
        tok = torch.argmax(logits[:, : cfg.vocab_size], dim=-1).to(torch.int32)
        snapshot = dataclasses.replace(state, k_pages=state.k_pages.clone(),
                                       v_pages=state.v_pages.clone())
        l_lw, s_lw = pm.decode_step_layerwise(
            pp, snapshot, tok,
            lambda l: (snapshot.k_pages[l].clone(), snapshot.v_pages[l].clone()))
        l_full, s_full = pm.decode_step(pp, state, tok)
        assert torch.equal(l_full, l_lw)
        assert torch.equal(s_full.k_pages, s_lw.k_pages)
        assert torch.equal(s_full.v_pages, s_lw.v_pages)
        tok2 = torch.argmax(l_full[:, : cfg.vocab_size], dim=-1).to(torch.int32)
        assert torch.equal(pm.decode_step(pp, s_full, tok2)[0],
                           pm.decode_step(pp, s_lw, tok2)[0])

    def test_decode_state_bridge_round_trip(self, models):
        cfg, jm, jp, pm, pp = models
        toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 33)).astype(np.int32)
        _, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, remat=False)
        ps = bridge.state_from_jax(jax.tree.map(np.asarray, js))
        back = bridge.state_to_numpy(ps)
        for name in ("context_lens", "k_pages", "v_pages", "block_tables"):
            np.testing.assert_array_equal(back[name], np.asarray(getattr(js, name)))


class TestEveryArch:
    @pytest.mark.parametrize("arch", list(ARCHS))
    def test_builds_prefills_and_decodes(self, arch):
        """Every config of the port builds (none is refused) and its smoke
        size prefills and takes a decode step on the CPU."""
        cfg = pt_smoke_config(arch)
        model = build_model(cfg, device="cpu")
        params = model.init_params(0)
        rng = np.random.default_rng(7)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))}
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.from_numpy(
                rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        logits, state = model.prefill(params, batch)
        logits, state = model.decode_step(params, state, torch.argmax(logits, dim=-1))
        assert logits.shape == (2, cfg.padded_vocab) and torch.isfinite(logits.float()).all()
        assert state.context_lens.tolist() == [10 + cfg.num_meta_tokens] * 2
