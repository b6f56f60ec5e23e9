"""The port's SSM and hybrid path against the JAX package on the CPU: same
numpy inputs, same weights (JAX init cast to f32 on both sides and
carried over with ``repro_torch.bridge``).

* the ssd_scan wrapper's plain version (what it runs on CPU tensors)
  against ``repro.kernels.ssd_scan.ref`` on tests/test_kernels.py's cases
  at the same chunk (1e-4), and at ragged lengths against the JAX ref run
  as one chunk, which takes any length (1e-3: other chunking, other sum
  order);
* the SSM layer (prefill with and without a transferred state, the
  decode step) against ``repro.models.ssm``, and the port's own versions
  of tests/test_model_correctness.py's chunked = stepwise and
  continuation contracts;
* the mamba2 and hymba decoders (smoke): prefill logits and every state
  field (1e-4), greedy decode steps, teacher forcing, the bridge.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref
from repro.models import ssm as jax_ssm
from repro.models.transformer import DecoderLM as JaxDecoderLM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import ssm
from repro_torch.models.registry import build_model

ATOL = 1e-4


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def ssd_inputs(rng, b, s, nh, hd, ns, dt_fill=None):
    """tests/test_kernels.py's ssd_scan inputs, as numpy."""
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32) * 0.5
    if dt_fill is None:
        dt = (np.abs(rng.standard_normal((b, s, nh))) * 0.1 + 0.01).astype(np.float32)
    else:
        dt = np.full((b, s, nh), dt_fill, np.float32)
    a = -(np.abs(rng.standard_normal(nh)) + 0.5).astype(np.float32)
    B = rng.standard_normal((b, s, ns)).astype(np.float32) * 0.3
    C = rng.standard_normal((b, s, ns)).astype(np.float32) * 0.3
    d_skip = rng.standard_normal(nh).astype(np.float32)
    return x, dt, a, B, C, d_skip


def assert_close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


class TestSSDScan:
    @pytest.mark.parametrize("s,nh,hd,ns,chunk", [
        (128, 4, 32, 16, 32),
        (64, 2, 64, 128, 64),   # mamba2-780m-like dstate
        (96, 50, 64, 16, 32),   # hymba-like head count
    ])
    def test_matches_jax_ref(self, s, nh, hd, ns, chunk):
        args = ssd_inputs(np.random.default_rng(s + nh), 2, s, nh, hd, ns)
        y_ref, st_ref = jax_ssd_ref(*map(jnp.asarray, args), chunk=chunk)
        y, st = ssd_scan(*map(t, args), chunk=chunk)
        assert y.dtype == torch.float32 and st.shape == (2, nh, hd, ns)
        assert_close(y, y_ref, ATOL)
        assert_close(st, st_ref, ATOL)

    @pytest.mark.parametrize("dt_fill", [1e-3, 5.0])
    def test_decay_extremes_finite(self, dt_fill):
        """Very small dt (state persists) and large dt (state forgets)."""
        x, dt, _, B, C, _ = ssd_inputs(np.random.default_rng(9), 1, 64, 2, 16, 8, dt_fill)
        a = np.asarray([-0.01, -8.0], np.float32)
        d_skip = np.zeros(2, np.float32)
        args = (x, dt, a, B, C, d_skip)
        y, st = ssd_scan(*map(t, args), chunk=16)
        assert torch.isfinite(y).all() and torch.isfinite(st).all()
        y_ref, st_ref = jax_ssd_ref(*map(jnp.asarray, args), chunk=16)
        assert_close(y, y_ref, ATOL)
        assert_close(st, st_ref, ATOL)

    @pytest.mark.parametrize("s,chunk", [(45, 16), (130, 128), (97, 32), (1, 16)])
    def test_ragged_length_matches_one_chunk(self, s, chunk):
        """The reference raises unless s divides by the chunk; the port pads
        the last chunk with dt = 0, x = 0, which is exact."""
        args = ssd_inputs(np.random.default_rng(s), 2, s, 3, 16, 8)
        y_ref, st_ref = jax_ssd_ref(*map(jnp.asarray, args), chunk=s)
        y, st = ssd_scan(*map(t, args), chunk=chunk)
        assert y.shape == (2, s, 3, 16)
        assert_close(y, y_ref, 1e-3)
        assert_close(st, st_ref, 1e-3)

    def test_bf16_x_gives_bf16_y(self):
        args = list(map(t, ssd_inputs(np.random.default_rng(3), 1, 40, 2, 16, 8)))
        y32, st32 = ssd_scan(*args, chunk=16)
        args[0] = args[0].to(torch.bfloat16)
        y, st = ssd_scan(*args, chunk=16)
        assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
        np.testing.assert_allclose(y.float().numpy(), y32.numpy(), atol=2e-2, rtol=2e-2)

    def test_rejects_bad_inputs(self):
        x, dt, a, B, C, d_skip = map(t, ssd_inputs(np.random.default_rng(4), 1, 8, 2, 4, 4))
        with pytest.raises(TypeError, match="dt must be f32"):
            ssd_scan(x, dt.double(), a, B, C, d_skip)
        with pytest.raises(ValueError, match="batch and length"):
            ssd_scan(x, dt[:, :4], a, B, C, d_skip)


# ------------------------------------------------------------- layer
@pytest.fixture(scope="module")
def ssm_layer():
    cfg = get_smoke_config("mamba2-780m")
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jax_ssm.ssm_init(jax.random.PRNGKey(0),
                                                                         cfg))
    return cfg, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp))


class TestSSMLayer:
    def test_prefill_matches(self, ssm_layer):
        cfg, jp, pp = ssm_layer
        x = np.random.default_rng(1).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
        y_ref, (st_ref, conv_ref) = jax_ssm.ssm_prefill(jp, jnp.asarray(x), cfg, chunk=16)
        y, (st, conv) = ssm.ssm_prefill(pp, t(x), cfg, chunk=16)
        assert_close(y, y_ref, ATOL)
        assert_close(st, st_ref, ATOL)
        assert_close(conv, conv_ref, ATOL)

    def test_prefill_continuation_matches(self, ssm_layer):
        cfg, jp, pp = ssm_layer
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
        ssd0 = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state)).astype(np.float32) * 0.1
        conv0 = rng.standard_normal((2, cfg.ssm_conv - 1, cfg.ssm_inner
                                     + 2 * cfg.ssm_state)).astype(np.float32)
        y_ref, (st_ref, _) = jax_ssm.ssm_prefill(jp, jnp.asarray(x), cfg, chunk=16,
                                                 conv_state=jnp.asarray(conv0),
                                                 ssd_state=jnp.asarray(ssd0))
        y, (st, _) = ssm.ssm_prefill(pp, t(x), cfg, chunk=16, conv_state=t(conv0),
                                     ssd_state=t(ssd0))
        assert_close(y, y_ref, ATOL)
        assert_close(st, st_ref, ATOL)

    def test_step_matches(self, ssm_layer):
        cfg, jp, pp = ssm_layer
        rng = np.random.default_rng(3)
        x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
        ssd0 = rng.standard_normal((3, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state)).astype(np.float32)
        conv0 = rng.standard_normal((3, cfg.ssm_conv - 1, cfg.ssm_inner
                                     + 2 * cfg.ssm_state)).astype(np.float32)
        y_ref, (st_ref, conv_ref) = jax_ssm.ssm_step(jp, jnp.asarray(x), cfg,
                                                     (jnp.asarray(ssd0), jnp.asarray(conv0)))
        y, (st, conv) = ssm.ssm_step(pp, t(x), cfg, (t(ssd0), t(conv0)))
        assert_close(y, y_ref, ATOL)
        assert_close(st, st_ref, ATOL)
        assert_close(conv, conv_ref, 0)

    def test_chunked_equals_stepwise(self, ssm_layer):
        cfg, _, pp = ssm_layer
        b, s = 2, 64
        x = t(np.random.default_rng(3).standard_normal((b, s, cfg.d_model)))
        y_chunk, (state_chunk, conv_chunk) = ssm.ssm_prefill(pp, x, cfg, chunk=16)
        shapes = ssm.ssm_state_shapes(cfg, b)
        st = (torch.zeros(shapes[0]), torch.zeros(shapes[1]))
        ys = []
        for i in range(s):
            y_t, st = ssm.ssm_step(pp, x[:, i], cfg, st)
            ys.append(y_t)
        np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(), atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_allclose(state_chunk.numpy(), st[0].numpy(), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(conv_chunk.numpy(), st[1].numpy(), atol=ATOL, rtol=ATOL)

    def test_state_continuation(self, ssm_layer):
        """prefill(x) == prefill(x1) then prefill(x2 | state): the base of
        chunked prefill and of state transfer."""
        cfg, _, pp = ssm_layer
        x = t(np.random.default_rng(4).standard_normal((1, 64, cfg.d_model)))
        y_full, (s_full, c_full) = ssm.ssm_prefill(pp, x, cfg, chunk=16)
        _, (s1, c1) = ssm.ssm_prefill(pp, x[:, :29], cfg, chunk=16)  # ragged split
        y2, (s2, c2) = ssm.ssm_prefill(pp, x[:, 29:], cfg, chunk=16, conv_state=c1,
                                       ssd_state=s1)
        np.testing.assert_allclose(y_full[:, 29:].numpy(), y2.numpy(), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(s_full.numpy(), s2.numpy(), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(c_full.numpy(), c2.numpy(), atol=ATOL, rtol=ATOL)


# ----------------------------------------------------------- decoder
STATE_FIELDS = ("context_lens", "ring_k", "ring_v", "ring_pos", "meta_k", "meta_v",
                "ssd_state", "conv_state", "k_pages", "v_pages", "block_tables")


@pytest.fixture(scope="module", params=["mamba2-780m", "hymba-1.5b"])
def models(request):
    cfg = get_smoke_config(request.param)
    jm = JaxDecoderLM(cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init_params(jax.random.PRNGKey(0)))
    pm = build_model(pt_smoke_config(request.param), device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, pm, pp


def greedy_np(cfg, logits):
    return np.asarray(jnp.argmax(logits[:, : cfg.vocab_size], axis=-1), np.int32)


class TestDecoderParity:
    # s + meta tokens stays under 128, where the JAX SSD takes any length;
    # 100 tokens pass hymba-smoke's window (32) and wrap its ring (64 slots)
    @pytest.mark.parametrize("s", [45, 100])
    def test_prefill_state_and_greedy_decode_match(self, models, s):
        cfg, jm, jp, pm, pp = models
        toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
        jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, remat=False)
        pl, ps = pm.prefill(pp, {"tokens": torch.from_numpy(toks)})
        assert_close(pl, jl, ATOL)
        for name in STATE_FIELDS:
            got, want = getattr(ps, name), getattr(js, name)
            assert (got is None) == (want is None), name
            if got is not None:
                assert_close(got, want, ATOL if got.is_floating_point() else 0)
        for _ in range(4):
            tok = greedy_np(cfg, jl)
            jl, js = jm.decode_step(jp, js, jnp.asarray(tok))
            pl, ps = pm.decode_step(pp, ps, torch.from_numpy(tok))
            assert_close(pl, jl, ATOL)
        for name in ("ring_k", "ring_pos", "ssd_state", "conv_state"):
            if getattr(ps, name) is not None:
                assert_close(getattr(ps, name), getattr(js, name), ATOL)

    def test_teacher_forcing_equivalence(self, models):
        """prefill(prompt).decode(t) == prefill(prompt + t), in f32."""
        cfg, _, _, pm, pp = models
        toks = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab_size, (2, 65)).astype(np.int32))
        ref, _ = pm.prefill(pp, {"tokens": toks})
        _, state = pm.prefill(pp, {"tokens": toks[:, :64]})
        out, _ = pm.decode_step(pp, state, toks[:, 64])
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)

    def test_steps_match_jax_greedy(self, models):
        cfg, jm, jp, pm, pp = models
        toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 37)).astype(np.int32)
        tok, state = make_prefill_step(pm)(pp, {"tokens": torch.from_numpy(toks)})
        serve = make_serve_step(pm)
        jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, remat=False)
        for _ in range(4):
            want = greedy_np(cfg, jl)
            assert tok.dtype == torch.int32 and tok.tolist() == want.tolist()
            jl, js = jm.decode_step(jp, js, jnp.asarray(want))
            tok, state = serve(pp, state, tok)

    def test_layerwise_decode_refused(self, models):
        cfg, _, _, pm, pp = models
        toks = torch.zeros((1, 8), dtype=torch.int32)
        _, state = pm.prefill(pp, {"tokens": toks})
        with pytest.raises(NotImplementedError, match="ring/SSM"):
            pm.decode_step_layerwise(pp, state, toks[:, 0], lambda layer: None)

    def test_decode_state_bridge_round_trip(self, models):
        cfg, jm, jp, _, _ = models
        toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 33)).astype(np.int32)
        _, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, remat=False)
        ps = bridge.state_from_jax(jax.tree.map(np.asarray, js), dtype=torch.bfloat16)
        assert ps.ssd_state.dtype == torch.float32  # dtype applies to KV only
        if ps.ring_k is not None:
            assert ps.ring_k.dtype == ps.meta_k.dtype == torch.bfloat16
        exact = bridge.state_from_jax(jax.tree.map(np.asarray, js))
        back = bridge.state_to_numpy(exact)
        for f in dataclasses.fields(js):
            want = getattr(js, f.name)
            if want is None:
                assert back[f.name] is None
            else:
                np.testing.assert_array_equal(back[f.name], np.asarray(want))

    def test_init_params_keys_and_dtypes_match_jax(self, models):
        cfg, jm, _, pm, _ = models
        jp = jm.init_params(jax.random.PRNGKey(1))
        pp = pm.init_params(0)
        flat_j = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_leaves_with_path(jp)}
        flat_p = {}

        def walk(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}['{k}']")
                else:
                    flat_p[f"{prefix}['{k}']"] = v
        walk(pp)
        assert sorted(flat_p) == sorted(flat_j)
        for k, v in flat_p.items():
            assert tuple(v.shape) == tuple(flat_j[k].shape), k
            assert str(v.dtype).split(".")[1] == str(flat_j[k].dtype), k
