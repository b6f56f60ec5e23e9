"""The port's training path against the JAX package on the CPU.

* ``flash_attention``'s output and dq/dk/dv (the port's autograd Function:
  the ``_fwd_scan`` port forward, the ``_bwd_scan`` port backward) against
  the JAX custom VJP: causal, window + prefix, GQA h/g in {1, 4},
  chunk-aligned shapes, several block pairs;
* ``train_loss`` and every parameter's gradient against
  ``jax.value_and_grad`` at the smoke configs of yi-9b, granite-moe,
  llava, whisper, mamba2 and hymba, with remat on and off;
* three ``adamw_update`` steps, with ``fp32_master`` on and off, and two
  ``make_train_step`` steps (one with ``num_microbatches=2``) against
  JAX's, started from the same params and optimizer state
  (``bridge.opt_state_from_jax``);
* checkpoints both ways (the port writes, ``repro.ckpt`` restores; JAX
  writes, the port restores) and the port's payload byte-equal to
  ``msgpack.packb`` of the leaves' bytes;
* ``launch.train --smoke --device cpu --resume`` repeating the
  uninterrupted run's losses exactly; ``decode_state_shape`` and
  ``input_specs`` against JAX's shapes and dtypes.

Tolerances (f32 weights and inputs on both sides, from numpy seeds): the
loss to 1e-5 relative, each gradient, attention output and optimizer leaf
to 1e-4 in ||err|| / ||ref|| (the sums run in other orders in the two
frameworks; f32 keeps about 7 digits, and a backward through a few layers
loses one or two).  A gradient that is zero in exact arithmetic (its norm
under 1e-6 of the whole gradient's on the JAX side) must be as small on
the port's.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jax_ckpt
from repro.configs import get_smoke_config
from repro.launch import steps as jax_steps
from repro.models.flash import flash_attention as jax_flash
from repro.models.registry import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch import bridge
from repro_torch.ckpt import checkpoint as pt_ckpt
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.launch import steps as pt_steps
from repro_torch.models.flash import flash_attention
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw as pt_adamw
from repro_torch.tree import leaves

LOSS_RTOL = 1e-5
REL = 1e-4
ZERO = 1e-6  # a leaf's gradient norm below this share of the total is zero
ARCHS = ["yi-9b", "granite-moe-3b-a800m", "llava-next-mistral-7b", "whisper-large-v3",
         "mamba2-780m", "hymba-1.5b"]


def rel_err(got, ref) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def flat_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


# ------------------------------------------------------------------ flash
@pytest.mark.parametrize("b,s,h,g,d,causal,window,prefix,chunk", [
    (2, 64, 4, 4, 16, True, 0, 0, 16),     # MHA (h/g = 1), 10 block pairs
    (1, 64, 8, 2, 16, True, 0, 0, 32),     # GQA h/g = 4
    (1, 96, 4, 1, 8, True, 24, 8, 16),     # window + always-visible prefix, h/g = 4
    (1, 64, 4, 4, 16, False, 0, 0, 32),    # non-causal (the encoder's)
])
def test_flash_attention_and_grads_match_jax_custom_vjp(b, s, h, g, d, causal, window,
                                                         prefix, chunk):
    rng = np.random.default_rng(s + h + window)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, g, d)).astype(np.float32)
    v = rng.standard_normal((b, s, g, d)).astype(np.float32)
    dout = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kw = dict(causal=causal, sliding_window=window, prefix_len=prefix, q_chunk=chunk,
              k_chunk=chunk)
    out, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, **kw), q, k, v)
    grads = vjp(dout)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tout = flash_attention(tq, tk, tv, **kw)
    tout.backward(torch.tensor(dout))
    assert rel_err(tout, out) < REL
    for name, t, ref in zip("qkv", (tq, tk, tv), grads):
        assert rel_err(t.grad, ref) < REL, f"d{name}"


def test_flash_forward_lse_matches_the_wrappers_plain_version():
    """The blockwise forward's lse (the backward's input) equals the
    flash_prefill wrapper's plain lse; rows past a ragged end are masked."""
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.models.flash import flash_forward_plain

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 70, n, 16, generator=g) for n in (8, 2, 2))
    for kw in (dict(causal=True), dict(causal=True, sliding_window=20, prefix_len=4),
               dict(causal=False)):
        out, lse = flash_forward_plain(q, k, v, q_chunk=32, k_chunk=32, **kw)
        ref_out, ref_lse = flash_prefill(q, k, v, return_lse=True, **kw)
        assert lse.shape == (1, 8, 70) and torch.isfinite(lse).all()
        torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)


def test_flash_backward_without_grad_is_one_forward():
    """Without gradients flash_attention is the plain kernel call; with
    them the Function saves lse and gives finite gradients for ragged
    lengths (no exp(-inf + inf))."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 37, 4, 8, generator=g, requires_grad=True)
    k = torch.randn(1, 37, 2, 8, generator=g, requires_grad=True)
    v = torch.randn(1, 37, 2, 8, generator=g, requires_grad=True)
    out = flash_attention(q, k, v, q_chunk=16, k_chunk=16)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None


# ------------------------------------------------------------- train_loss
def make_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def jax_f32_params(jm):
    return jax.tree.map(lambda a: a.astype(jnp.float32), jm.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module", params=ARCHS)
def arch_models(request):
    arch = request.param
    cfg = get_smoke_config(arch)
    # unrolled: whisper's encode casts the frames to bf16, and with f32
    # weights the residual promotes to f32, which a scan carry refuses
    jm = jax_build_model(cfg, unroll=True)
    jp = jax_f32_params(jm)
    pm = build_model(pt_smoke_config(arch), device="cpu")
    return arch, cfg, jm, jp, pm


@pytest.mark.parametrize("remat", [False, True])
def test_train_loss_and_grads_match_jax(arch_models, remat):
    arch, cfg, jm, jp, pm = arch_models
    batch = make_batch(cfg, 2, 32, seed=7)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jm.train_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                remat=remat), has_aux=True)(jp)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    for p in leaves(pp):
        p.requires_grad_(True)
    tloss, taux = pm.train_loss(pp, {k: torch.as_tensor(v) for k, v in batch.items()},
                                remat=remat)
    tloss.backward()
    tloss = tloss.detach()
    assert abs(float(tloss) - float(loss)) <= LOSS_RTOL * abs(float(loss))
    assert abs(float(taux["nll"].detach()) - float(aux["nll"])) <= \
        LOSS_RTOL * abs(float(aux["nll"]))
    if cfg.family == "moe":
        assert float(taux["aux"].detach()) == pytest.approx(float(aux["aux"]), rel=LOSS_RTOL)
    jflat = jax.tree_util.tree_flatten_with_path(grads)[0]
    tflat = leaves(pp)
    assert len(jflat) == len(tflat)
    total = float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                              for _, g in jflat)))
    for (path, ref), t in zip(jflat, tflat):
        ref = np.asarray(ref, np.float32)
        what = f"{arch} grad {jax.tree_util.keystr(path)}"
        got = np.zeros_like(ref) if t.grad is None else t.grad.numpy()
        if np.linalg.norm(ref) <= ZERO * total:
            # zero in exact arithmetic (a key bias shifts every score of a
            # row alike; padded vocab rows; unrouted padded experts): both
            # sides must be rounding noise
            assert np.linalg.norm(got) <= ZERO * total, what
            continue
        assert rel_err(got, ref) < REL, what


def test_remat_is_exact():
    """Checkpointed layers recompute the same forward: loss and gradients
    equal the plain backward's bit for bit."""
    pm = build_model(pt_smoke_config("yi-9b"), device="cpu")
    batch = {"tokens": torch.as_tensor(make_batch(pm.cfg, 2, 32, 3)["tokens"])}
    out = []
    for remat in (False, True):
        pp = pm.init_params(0)
        for p in leaves(pp):
            p.requires_grad_(True)
        loss, _ = pm.train_loss(pp, batch, remat=remat)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in leaves(pp)]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("arch", ["yi-9b", "whisper-large-v3", "hymba-1.5b"])
def test_decode_state_shape_matches_jax(arch):
    cfg = get_smoke_config(arch)
    ref = jax_build_model(cfg).decode_state_shape(3, 100)
    got = build_model(pt_smoke_config(arch), device="cpu").decode_state_shape(3, 100)
    for f in dataclasses.fields(got):
        r, t = getattr(ref, f.name), getattr(got, f.name)
        assert (r is None) == (t is None), f.name
        if t is not None:
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(r.shape), f.name
            assert str(t.dtype).split(".")[1] == str(r.dtype), f.name


@pytest.mark.parametrize("arch,shape", [("llava-next-mistral-7b", "train_4k"),
                                        ("whisper-large-v3", "prefill_32k"),
                                        ("yi-9b", "decode_32k"), ("mamba2-780m", "long_500k")])
def test_input_specs_and_cells_match_jax(arch, shape):
    cfg, pcfg = get_smoke_config(arch), pt_smoke_config(arch)
    ref = jax_steps.input_specs(cfg, jax_steps.SHAPES[shape])
    got = pt_steps.input_specs(pcfg, pt_steps.SHAPES[shape])
    assert set(ref) == set(got)
    for k in ref:
        if k == "state":
            continue  # decode_state_shape's own test
        assert tuple(got[k].shape) == ref[k].shape
        assert str(got[k].dtype).split(".")[1] == str(ref[k].dtype)
    assert pt_steps.skip_reason(pcfg, pt_steps.SHAPES[shape]) == \
        jax_steps.skip_reason(cfg, jax_steps.SHAPES[shape])
    assert pt_steps.cell_is_runnable(arch, shape) == jax_steps.cell_is_runnable(arch, shape)


# ------------------------------------------------------------------ AdamW
def random_tree(rng, dtype=np.float32):
    return {"w": rng.standard_normal((6, 5)).astype(dtype),
            "layers": {"a": rng.standard_normal((2, 4, 3)).astype(dtype),
                       "b": rng.standard_normal((7,)).astype(dtype)}}


@pytest.mark.parametrize("fp32_master", [True, False])
def test_adamw_three_steps_match_jax(fp32_master):
    cfg_kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=5, fp32_master=fp32_master,
                  weight_decay=0.1, clip_norm=0.5)
    jcfg, pcfg = jax_adamw.AdamWConfig(**cfg_kw), pt_adamw.AdamWConfig(**cfg_kw)
    rng = np.random.default_rng(0)
    dt = jnp.float32 if fp32_master else jnp.bfloat16
    jp = jax.tree.map(lambda a: jnp.asarray(a, dt), random_tree(rng))
    js = jax_adamw.adamw_init(jp, jcfg)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    ps = pt_adamw.adamw_init(pp, pcfg)
    assert {k: v.dtype for k, v in zip("mv", (leaves(ps["m"])[0], leaves(ps["v"])[0]))} == \
        dict.fromkeys("mv", torch.float32 if fp32_master else torch.bfloat16)
    for step in range(3):
        grads = random_tree(rng)
        jg = jax.tree.map(lambda a: jnp.asarray(a, dt), grads)
        jp, js, jm = jax_adamw.adamw_update(jp, jg, js, jcfg)
        pp, ps, pm = pt_adamw.adamw_update(
            pp, bridge.params_from_jax(jax.tree.map(np.asarray, jg)), ps, pcfg)
        assert int(ps["step"]) == int(js["step"]) == step + 1
        assert float(pm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(pm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        # bf16 params and moments: one bf16 rounding apart at most
        tol = REL if fp32_master else 1e-2
        for name, jt, pt in (("params", jp, pp), ("m", js["m"], ps["m"]),
                             ("v", js["v"], ps["v"])):
            for r, t in zip(flat_np(jt), leaves(pt)):
                assert rel_err(t, r) < tol, f"step {step} {name}"
        if fp32_master:
            for r, t in zip(flat_np(js["master"]), leaves(ps["master"])):
                assert rel_err(t, r) < REL


def test_adamw_update_is_in_place_and_matches_schedule():
    cfg = pt_adamw.AdamWConfig(lr_peak=1.0, warmup_steps=4, total_steps=12)
    jcfg = jax_adamw.AdamWConfig(lr_peak=1.0, warmup_steps=4, total_steps=12)
    for step in range(0, 14):
        assert float(pt_adamw.cosine_schedule(cfg, torch.tensor(step, dtype=torch.int32))) == \
            pytest.approx(float(jax_adamw.cosine_schedule(jcfg, jnp.int32(step))), abs=1e-7)
    params = {"w": torch.ones(3)}
    state = pt_adamw.adamw_init(params, cfg)
    w, m = params["w"], state["m"]["w"]
    out, st, _ = pt_adamw.adamw_update(params, {"w": torch.full((3,), 0.5)}, state, cfg)
    assert out["w"] is w and st["m"]["w"] is m  # the same storage, updated


# --------------------------------------------------------- make_train_step
@pytest.mark.parametrize("arch,micro", [("yi-9b", 1), ("granite-moe-3b-a800m", 2)])
def test_two_train_steps_match_jax(arch, micro):
    cfg = get_smoke_config(arch)
    jm = jax_build_model(cfg, unroll=True)
    jp = jax_f32_params(jm)
    ocfg = dict(lr_peak=3e-3, warmup_steps=1, total_steps=4)
    jcfg, pcfg = jax_adamw.AdamWConfig(**ocfg), pt_adamw.AdamWConfig(**ocfg)
    js = jax_adamw.adamw_init(jp, jcfg)
    pm = build_model(pt_smoke_config(arch), device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    ps = bridge.opt_state_from_jax(jax.tree.map(np.asarray, js))
    jstep = jax_steps.make_train_step(jm, jcfg, remat=True, num_microbatches=micro)
    pstep = pt_steps.make_train_step(pm, pcfg, remat=True, num_microbatches=micro)
    for i in range(2):
        batch = make_batch(cfg, 4, 32, seed=20 + i)
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        pp, ps, pmet = pstep(pp, ps, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert float(pmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=LOSS_RTOL)
        assert float(pmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=REL)
        for r, t in zip(flat_np(jp), leaves(pp)):
            assert rel_err(t, r) < REL
        for r, t in zip(flat_np(js["v"]), leaves(ps["v"])):
            if np.any(r):
                assert rel_err(t, r) < 10 * REL  # squared gradients: twice the rel error


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("sizes", [[0, 1, 15], [300] * 17, [70000, 5], [3] * 70000])
def test_checkpoint_payload_is_byte_equal_to_msgpack(tmp_path, sizes):
    """Every header form (fixarray / array16 / array32, bin 8 / 16 / 32
    sizes below 2**32) as msgpack writes it."""
    rng = np.random.default_rng(len(sizes))
    tree = [torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)) for n in sizes]
    pt_ckpt.save_checkpoint(tmp_path, 1, tree)
    assert (tmp_path / "step_00000001/arrays.msgpack").read_bytes() == \
        msgpack.packb([t.numpy().tobytes() for t in tree])
    got = pt_ckpt.restore_checkpoint(tmp_path, 1, tree)
    assert all(torch.equal(a, b) for a, b in zip(got, tree))


def train_state_tree(seed):
    g = torch.Generator().manual_seed(seed)
    params = {"embed": {"table": torch.randn(16, 8, generator=g).to(torch.bfloat16)},
              "layers": {"w": torch.randn(2, 8, 8, generator=g)}}
    opt = pt_adamw.adamw_init(params, pt_adamw.AdamWConfig())
    opt["step"] = torch.tensor(3, dtype=torch.int32)
    return params, opt, {"seed": 0, "step": 5}


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = train_state_tree(0)
    pt_ckpt.save_checkpoint(tmp_path, 3, tree)
    like = jax.tree.map(lambda t: jnp.zeros(t.shape, str(t.dtype).split(".")[1])
                        if isinstance(t, torch.Tensor) else t, tree)
    got = jax_ckpt.restore_checkpoint(tmp_path, 3, like)
    for r, t in zip(jax.tree.leaves(got), leaves(tree)):
        t = torch.as_tensor(t)
        assert str(r.dtype) == str(t.dtype).split(".")[1] or t.dtype == torch.int64
        np.testing.assert_array_equal(np.asarray(r, np.float64),
                                      t.double().numpy())
    # JAX writes the same tree (its Python ints as int64 too) to the same bytes
    as_jax = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        str(t.dtype).split(".")[1]) if isinstance(t, torch.Tensor) else t, tree)
    jax_ckpt.save_checkpoint(tmp_path / "jax", 3, as_jax)
    assert (tmp_path / "jax/step_00000003/arrays.msgpack").read_bytes() == \
        (tmp_path / "step_00000003/arrays.msgpack").read_bytes()
    manifest = json.loads((tmp_path / "step_00000003/manifest.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]][:2] == ["bfloat16", "float32"]


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    cfg = get_smoke_config("yi-9b")
    jm = jax_build_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))  # bf16, as the launcher's
    js = jax_adamw.adamw_init(jp, jax_adamw.AdamWConfig())
    jax_ckpt.save_checkpoint(tmp_path, 7, (jp, js, {"seed": 0, "step": 7}))
    pm = build_model(pt_smoke_config("yi-9b"), device="cpu")
    pp = pm.init_params(1)
    like = (pp, pt_adamw.adamw_init(pp, pt_adamw.AdamWConfig()), {"seed": 0, "step": 0})
    assert pt_ckpt.latest_step(tmp_path) == 7
    params, opt, data = pt_ckpt.restore_checkpoint(tmp_path, 7, like)
    assert params["embed"]["table"].dtype == torch.bfloat16
    assert int(data["step"]) == 7
    for r, t in zip(flat_np((jp, js)), leaves((params, opt))):
        np.testing.assert_array_equal(t.float().numpy(), r)


def test_checkpoint_retention_and_oversized_leaf_split(tmp_path, monkeypatch):
    tree = train_state_tree(1)
    for step in (1, 2, 3, 4):
        pt_ckpt.save_checkpoint(tmp_path, step, tree, keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000003", "step_00000004"]
    assert not list(tmp_path.glob(".tmp_*"))
    # a leaf above msgpack's bin limit (made small here) splits into parts
    monkeypatch.setattr(pt_ckpt, "_BIN_MAX", 100)
    pt_ckpt.save_checkpoint(tmp_path / "big", 1, tree)
    manifest = json.loads((tmp_path / "big/step_00000001/manifest.json").read_text())
    assert manifest["leaves"][0]["parts"] == -(-16 * 8 * 2 // 100)
    got = pt_ckpt.restore_checkpoint(tmp_path / "big", 1, tree)
    assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
               for a, b in zip(leaves(got), leaves(tree)))


# -------------------------------------------------------------- launcher
def test_launch_train_resume_repeats_the_losses(tmp_path, capsys):
    from repro_torch.launch import train

    common = ["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu", "--batch", "4",
              "--seq", "32", "--lr", "3e-3"]
    full = train.main(common + ["--steps", "6"])["losses"]
    # stopped at step 3 (warmup is 10 steps, so the learning rates of the
    # first 3 steps do not depend on --steps), then resumed
    first = train.main(common + ["--steps", "3", "--ckpt-dir", str(tmp_path),
                                 "--ckpt-every", "3"])["losses"]
    rest = train.main(common + ["--steps", "6", "--ckpt-dir", str(tmp_path),
                                "--ckpt-every", "100", "--resume"])["losses"]
    assert first + rest == full
    assert all(np.isfinite(full)) and full[-1] < full[0]
    out = capsys.readouterr().out
    assert "[train] checkpointed step 3" in out and "[train] resumed from step 3" in out
