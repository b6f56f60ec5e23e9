"""The port's MoE layer and MoE decoders against the JAX package on the CPU:
same numpy inputs, the JAX init cast to f32 and carried over with
``repro_torch.bridge``.  Routing is compared first (the same chosen
experts and the same kept pairs; padded experts never chosen), then the
outputs to atol 1e-4 (f32 matmuls summed in another order), as
tests/test_torch_model.py does for the dense decoders.

A MoE token's output depends on the other tokens of its group (capacity
and the cumsum order decide which pairs are dropped), so every check
runs the same rows in the same order on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models.moe import _capacity
from repro.models.moe import moe_apply as jax_moe_apply
from repro.models.moe import moe_init as jax_moe_init
from repro.models.transformer import DecoderLM as JaxDecoderLM
from repro.serving.disagg import DisaggService as JaxService
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.serving.disagg import DisaggService

ATOL = 1e-4
# tokens -> tokens a group, as moe.py:141-151 picks them on one device
GROUPS = {32: 32, 96: 32, 130: 130, 3: 3}


def f32_tree(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def jax_routing(p, x, cfg):
    """The reference's routing lines (moe.py:153-167) on grouped tokens."""
    b, s, d = x.shape
    gs = GROUPS[b * s]
    xg = x.reshape(b * s // gs, gs, d)
    e_pad, e, k = cfg.padded_experts, cfg.num_experts, cfg.experts_per_token
    logits = xg.astype(jnp.float32) @ p["router"]["w"].astype(jnp.float32)
    logits = jnp.where(jnp.arange(e_pad) < e, logits, -jnp.inf)
    top_p, top_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    cap = _capacity(gs, k, e, cfg.capacity_factor)
    onehot = jax.nn.one_hot(top_idx, e_pad, dtype=jnp.int32)
    g = xg.shape[0]
    pos = jnp.cumsum(onehot.reshape(g, gs * k, e_pad), axis=1).reshape(onehot.shape) - 1
    pos = jnp.sum(pos * onehot, axis=-1)
    return np.asarray(top_idx), np.asarray(pos < cap), cap


@pytest.fixture(scope="module", params=["granite-moe-3b-a800m", "llama4-maverick-400b-a17b"])
def moe_layer(request):
    cfg = get_smoke_config(request.param)
    jp = f32_tree(jax_moe_init(jax.random.PRNGKey(0), cfg))
    return cfg, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp))


class TestMoeLayer:
    @pytest.mark.parametrize("cf", [None, 0.5])
    @pytest.mark.parametrize("b,s", [(1, 32), (1, 96), (1, 130), (3, 1)])
    def test_routing_and_output_match(self, moe_layer, b, s, cf):
        cfg, jp, pp = moe_layer
        if cf is not None:  # the JAX and the port configs are one dataclass each
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        x = np.random.default_rng(s).standard_normal((b, s, cfg.d_model)).astype(np.float32)
        ref_idx, ref_keep, ref_cap = jax_routing(jp, jnp.asarray(x), cfg)

        gs = moe.group_size(b * s)
        assert gs == GROUPS[b * s]
        cap = moe.capacity(gs, cfg.experts_per_token, cfg.num_experts, cfg.capacity_factor)
        assert cap == ref_cap
        r = moe.moe_route(pp, torch.from_numpy(x).reshape(-1, gs, cfg.d_model), cfg, cap)
        np.testing.assert_array_equal(r.top_idx.numpy(), ref_idx)
        np.testing.assert_array_equal(r.keep.numpy(), ref_keep)
        assert int(r.top_idx.max()) < cfg.num_experts  # padded experts never chosen
        # each expert keeps its first `cap` pairs of a group and drops the rest
        per_expert = r.onehot.sum(dim=(1, 2))  # [g, e_pad]
        dropped = int((~r.keep).sum())
        assert dropped == int(torch.clamp(per_expert - cap, min=0).sum())
        if cf == 0.5 and s > 1:
            assert dropped > 0

        ref_out, ref_aux = jax_moe_apply(jp, jnp.asarray(x), cfg)
        out, aux = moe.moe_apply(pp, torch.from_numpy(x), cfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL, rtol=0)
        np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-6, rtol=1e-6)

    def test_moe_init_layout(self, moe_layer):
        cfg, jp, _ = moe_layer
        pt = moe.moe_init(cfg, torch.Generator().manual_seed(0), lead=(3,))
        flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
        want = {jax.tree_util.keystr(k): (3, *v.shape) for k, v in flat_j}
        flat_p = jax.tree_util.tree_flatten_with_path(pt)[0]
        got = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in flat_p}
        assert got == want
        assert pt["gate"].dtype == torch.bfloat16
        # the reference's scales: router 0.02, every expert matrix d^-0.5
        assert float(pt["router"]["w"].float().std()) == pytest.approx(0.02, rel=0.1)
        assert float(pt["down"].float().std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)


@pytest.fixture(scope="module", params=["granite-moe-3b-a800m", "llama4-maverick-400b-a17b"])
def models(request):
    cfg = get_smoke_config(request.param)
    jm = JaxDecoderLM(cfg)
    jp = f32_tree(jm.init_params(jax.random.PRNGKey(0)))
    pm = build_model(pt_smoke_config(request.param), device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, pm, pp


class TestMoeDecoderParity:
    @pytest.mark.parametrize("b,s", [(1, 96), (2, 45)])
    def test_prefill_and_greedy_decode_match(self, models, b, s):
        cfg, jm, jp, pm, pp = models
        toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, remat=False)
        pl, ps = pm.prefill(pp, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        for name in ("k_pages", "v_pages"):
            np.testing.assert_allclose(getattr(ps, name).numpy(),
                                       np.asarray(getattr(js, name)), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(ps.block_tables.numpy(), np.asarray(js.block_tables))
        for _ in range(8):
            tok = np.asarray(jnp.argmax(jl[:, : cfg.vocab_size], axis=-1), np.int32)
            assert np.array_equal(tok, torch.argmax(pl[:, :cfg.vocab_size], -1).numpy())
            jl, js = jm.decode_step(jp, js, jnp.asarray(tok))
            pl, ps = pm.decode_step(pp, ps, torch.tensor(tok))
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        np.testing.assert_allclose(ps.k_pages.numpy(), np.asarray(js.k_pages), atol=ATOL,
                                   rtol=0)

    def test_params_keep_the_reference_layout(self, models):
        cfg, _, jp, pm, _ = models
        pt = pm.init_params(0)
        got = {jax.tree_util.keystr(k): tuple(v.shape)
               for k, v in jax.tree_util.tree_flatten_with_path(pt)[0]}
        want = {jax.tree_util.keystr(k): tuple(v.shape)
                for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
        assert got == want
        if cfg.moe_every > 1:  # grouped: sub0 dense at d_ff_dense, sub1 MoE
            assert pm.group == cfg.moe_every and pm.n_steps == cfg.num_layers // 2
            assert pt["layers"]["sub0"]["mlp"]["up"]["w"].shape[-1] == cfg.d_ff_dense
            assert "moe" in pt["layers"]["sub1"] and "shared" in pt["layers"]["sub1"]["moe"]

    def test_layerwise_step_equals_full_step(self, models):
        """Bit for bit, as tests/test_layerwise.py:178 pins for the reference."""
        cfg, _, _, pm, pp = models
        toks = torch.from_numpy(
            np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 40)).astype(np.int32))
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

    def test_prefill_plus_decode_equals_longer_prefill_without_drops(self, models):
        """prefill(p) + decode(t) = prefill(p + t) where nothing is dropped:
        capacity_factor = num_experts / experts_per_token gives every
        expert room for every token of its group."""
        cfg, _, _, pm, pp = models
        roomy = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                                    / cfg.experts_per_token)
        model = build_model(roomy, device="cpu")
        toks = torch.from_numpy(
            np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 41)).astype(np.int32))
        ref, _ = model.prefill(pp, {"tokens": toks})
        _, state = model.prefill(pp, {"tokens": toks[:, :-1]})
        out, _ = model.decode_step(pp, state, toks[:, -1])
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)


# ------------------------------------------------------------ service
def test_granite_moe_disagg_service_matches_jax():
    arch = "granite-moe-3b-a800m"
    cfg = get_smoke_config(arch)
    jm = JaxDecoderLM(cfg)
    jp = f32_tree(jm.init_params(jax.random.PRNGKey(1)))
    pm = build_model(pt_smoke_config(arch), device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (32, 96, 70)]
    runs = {}
    for name, svc in (("port", DisaggService(pm, pp, n_prefill=2, num_blocks=64,
                                             device="cpu")),
                      ("jax", JaxService(jm, jp, n_prefill=2, num_blocks=64))):
        outs = []
        for t in prompts:
            h = svc.submit(t)
            outs.append((svc.generate(h, max_new=4), h.metrics.kv_bytes_pulled))
        runs[name] = outs
    assert runs["port"] == runs["jax"]
    assert all(pulled > 0 for _, pulled in runs["port"])


def test_launcher_serves_granite_moe_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu",
                "--requests", "3", "--prompt-len", "96", "--max-new", "2",
                "--quantize-transfer"])
    out = capsys.readouterr().out
    assert out.count("[serve] r") == 3 and "requests.finished = 3" in out
