"""The SSM, hybrid, encoder-decoder and VLM (image prompt) families under a
("data", "model") device mesh, in ``gloo`` processes on the CPU (one spawn
of 4 ranks, one of 2, each joined with a time limit), against JAX on one
device, at the smoke configs in f32.

* Serving: prefill + 4 greedy decode steps through ``launch.steps`` with
  params from ``bridge.params_from_jax(..., mesh=...)``: every step's
  logits (gathered over the vocab shards and batch rows) at atol 1e-4 and
  the tokens equal, at (1, 2), (1, 4) and (2, 2).  mamba2's 8 SSD heads
  split over 'model'; hymba's ring wraps (40 prompt tokens past its
  32-token window) and its ring and meta KV are gathered whole; whisper's
  97 decoder tokens give 20 pages, which split over 'model' (the
  sequence-parallel paged_attention combine); llava's 32 image embeddings
  go in front of 8 text tokens.
* A ``dataclasses.replace`` of the hymba smoke config whose 6 SSD heads do
  not divide 4 (d_model 48, head_dim 16): the block splits ``head_dim``
  (4 channels a rank) at (1, 4), serving and training.
* Training: ``make_grad_step(mesh=)`` on the train placements (FSDP over
  'data', TP over 'model'): the loss to 1e-5 relative and every leaf's
  gradient shard to 1e-4 in ||err|| / ||ref|| against the slice of
  ``jax.value_and_grad(train_loss)`` (a shard whose JAX slice is zero in
  exact arithmetic must be as small), at (1, 4) and (2, 2).
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.launch import mesh as pt_mesh
from repro_torch.launch.shardings import param_sharding, shard_tensor, spec_leaves
from repro_torch.models import sharding
from repro_torch.models.registry import build_model

SPAWN_TIMEOUT = 300.0
ATOL = 1e-4
LOSS_RTOL = 1e-5
REL = 1e-4
ZERO = 1e-6
DECODE_STEPS = 4
HYMBA_HD = "hymba-1.5b-hd"     # the replaced config: 6 SSD heads of 16 over 4 ranks
ARCHS = ["mamba2-780m", "hymba-1.5b", "whisper-large-v3", "llava-next-mistral-7b"]
PROMPT = {"mamba2-780m": 33, "hymba-1.5b": 40, "whisper-large-v3": 97,
          "llava-next-mistral-7b": 8, HYMBA_HD: 40}
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
SERVE_CASES = {f"{a}_{m}": (a, MESHES[m]) for a in ARCHS for m in MESHES}
SERVE_CASES[f"{HYMBA_HD}_1x4"] = (HYMBA_HD, (1, 4))
TRAIN_CASES = {f"{a}_{m}": (a, MESHES[m]) for a in ARCHS for m in ("1x4", "2x2")}
TRAIN_CASES[f"{HYMBA_HD}_1x4"] = (HYMBA_HD, (1, 4))
SERVE_BATCH = 2
TRAIN_BATCH = (4, 32)


def configs(arch):
    """(JAX config, port config) of a case's arch."""
    if arch == HYMBA_HD:
        return tuple(dataclasses.replace(get("hymba-1.5b"), name=HYMBA_HD, d_model=48)
                     for get in (get_smoke_config, pt_smoke_config))
    return get_smoke_config(arch), pt_smoke_config(arch)


def inputs(cfg, b, s, seed):
    """A seeded batch: tokens, and an image or audio family's embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)
                                                   ).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)
                                            ).astype(np.float32)
    return out


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


# ------------------------------------------------------------- JAX side
def _jax_ref(arch):
    """One device, f32: the params, each serving step's logits and tokens,
    and the train loss with its gradients."""
    cfg, _ = configs(arch)
    jm = jax_build_model(cfg, unroll=True)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init_params(jax.random.PRNGKey(0)))
    serve = inputs(cfg, SERVE_BATCH, PROMPT[arch], seed=1)
    logits, state = jm.prefill(jp, {k: jnp.asarray(v) for k, v in serve.items()}, remat=False)
    all_logits, toks = [], []
    for step in range(DECODE_STEPS + 1):
        tok = np.asarray(jnp.argmax(logits[:, : cfg.vocab_size], axis=-1), np.int32)
        all_logits.append(np.asarray(logits))
        toks.append(tok)
        if step < DECODE_STEPS:
            logits, state = jm.decode_step(jp, state, jnp.asarray(tok))
    train = inputs(cfg, *TRAIN_BATCH, seed=2)
    # not jitted: under jit XLA keeps whisper's bf16 frames + positions sum
    # in f32, which the eager functions (and the port) round to bf16 first
    (loss, _), grads = jax.value_and_grad(
        lambda p: jm.train_loss(p, {k: jnp.asarray(v) for k, v in train.items()}, remat=True),
        has_aux=True)(jp)
    return {"params": np_tree(jp), "serve": serve, "logits": all_logits, "tokens": toks,
            "train": train, "loss": float(loss), "grads": np_tree(grads)}


# ------------------------------------------------------------ rank side
def _gather_logits(logits, cfg, axes):
    if logits.shape[-1] < cfg.padded_vocab:
        logits = sharding.all_gather(logits, "model", 1)
    return sharding.all_gather(logits, axes, 0)


def _serve_case(dev, arch, shape, ref):
    from repro_torch import bridge
    from repro_torch.launch.shardings import batch_spec, spec_axes
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    _, cfg = configs(arch)
    mesh = pt_mesh.make_mesh(shape, ("data", "model"), dev)
    params = bridge.params_from_jax(ref["params"], mesh=mesh)
    model = build_model(cfg, device="cpu")
    seen = []
    for fn in ("prefill", "decode_step"):
        orig = getattr(model, fn)

        def spy(*a, _orig=orig, **k):
            logits, st = _orig(*a, **k)
            seen.append(logits)
            return logits, st
        setattr(model, fn, spy)
    prefill, serve = make_prefill_step(model, mesh=mesh), make_serve_step(model, mesh=mesh)
    tok, state = prefill(params, {k: torch.from_numpy(v) for k, v in ref["serve"].items()})
    toks = [tok.numpy()]
    for _ in range(DECODE_STEPS):
        tok, state = serve(params, state, tok)
        toks.append(tok.numpy())
    with sharding.mesh_context(mesh):
        spec = batch_spec(mesh, SERVE_BATCH)
        logits = [_gather_logits(seen[0], cfg, spec_axes(spec[0]) if spec else ()).numpy()]
        logits += [_gather_logits(lg, cfg, state.layout.batch_axes).numpy()
                   for lg in seen[1:]]
    local = {f.name: tuple(getattr(state, f.name).shape)
             for f in dataclasses.fields(state)
             if isinstance(getattr(state, f.name), torch.Tensor)}
    return {"logits": logits, "tokens": toks, "layout": state.layout, "state_shapes": local}


def _train_case(dev, arch, shape, ref):
    from repro_torch import bridge
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.tree import leaves

    _, cfg = configs(arch)
    mesh = pt_mesh.make_mesh(shape, ("data", "model"), dev)
    model = build_model(cfg, device="cpu")
    params = bridge.params_from_jax(ref["params"], mesh=mesh, mode="train")
    batch = {k: torch.from_numpy(v) for k, v in ref["train"].items()}
    loss, _, grads = make_grad_step(model, mesh=mesh)(params, batch)
    return {"loss": float(loss), "grads": [g.numpy() for g in leaves(grads)]}


def _rank_main(dev, rank, world, work, serve_names, train_names):
    torch.set_num_threads(1)  # the smoke sizes; ranks share the host's cores
    refs = {}

    def ref(arch):
        if arch not in refs:
            with open(os.path.join(work, f"ref_{arch}.pkl"), "rb") as fh:
                refs[arch] = pickle.load(fh)
        return refs[arch]

    out = {"serve": {}, "train": {}}
    for name in serve_names:
        arch, shape = SERVE_CASES[name]
        out["serve"][name] = _serve_case(dev, arch, shape, ref(arch))
    for name in train_names:
        arch, shape = TRAIN_CASES[name]
        out["train"][name] = _train_case(dev, arch, shape, ref(arch))
    with open(os.path.join(work, f"rank{rank}_{world}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_families")
    refs = {}
    for arch in ARCHS + [HYMBA_HD]:
        refs[arch] = _jax_ref(arch)
        with open(d / f"ref_{arch}.pkl", "wb") as fh:
            pickle.dump(refs[arch], fh)
    return d, refs


def _spawn(work, world):
    d, _ = work
    serve = [n for n, (_, sh) in SERVE_CASES.items() if np.prod(sh) == world]
    train = [n for n, (_, sh) in TRAIN_CASES.items() if np.prod(sh) == world]
    pt_mesh.spawn(_rank_main, world, str(d / f"init{world}"), device="cpu",
                  args=(str(d), serve, train), timeout=SPAWN_TIMEOUT)
    return [pickle.load(open(d / f"rank{r}_{world}.pkl", "rb")) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(work):
    return {4: _spawn(work, 4), 2: _spawn(work, 2)}


def _slices(tree, cfg, shape, rank):
    """The leaves of a global tree (JAX's order), each cut to ``rank``'s
    train shard of a mesh of ``shape``."""
    mesh = pt_mesh.Mesh.view({"data": shape[0], "model": shape[1]}, rank)
    model = build_model(cfg, device="cpu")
    specs = spec_leaves(param_sharding(model.param_shapes(), mesh, mode="train"))
    flat = jax.tree.leaves(tree)
    assert len(flat) == len(specs)
    return [shard_tensor(torch.from_numpy(np.asarray(a)), sp, mesh).numpy()
            for a, sp in zip(flat, specs)]


# ---------------------------------------------------------------- tests
class TestServing:
    @pytest.mark.parametrize("name", list(SERVE_CASES))
    def test_logits_and_tokens_match_jax_on_one_device(self, work, ranks, name):
        arch, shape = SERVE_CASES[name]
        ref = work[1][arch]
        for r, rank in enumerate(ranks[int(np.prod(shape))]):
            got = rank["serve"][name]
            for step, (lg, want) in enumerate(zip(got["logits"], ref["logits"])):
                np.testing.assert_allclose(lg, want, atol=ATOL, rtol=0,
                                           err_msg=f"{name} rank {r} step {step}")
            for tok, want in zip(got["tokens"], ref["tokens"]):
                np.testing.assert_array_equal(tok, want)

    @pytest.mark.parametrize("name,seq_parallel", [
        ("whisper-large-v3_1x4", True), ("whisper-large-v3_1x2", True),
        ("llava-next-mistral-7b_1x2", True), ("llava-next-mistral-7b_1x4", False)])
    def test_the_pages_split_where_they_divide(self, ranks, name, seq_parallel):
        for rank in ranks[int(np.prod(SERVE_CASES[name][1]))]:
            assert rank["serve"][name]["layout"].seq_parallel is seq_parallel

    @pytest.mark.parametrize("name,field,shape", [
        # mamba2: 8 heads of 16, 2 a rank; the conv tail's 160 channels, 40 a rank
        ("mamba2-780m_1x4", "ssd_state", (2, 2, 2, 16, 16)),
        ("mamba2-780m_1x4", "conv_state", (2, 2, 3, 40)),
        # hymba at (2, 2): a row a rank; ring and meta KV whole over 'model'
        ("hymba-1.5b_2x2", "ssd_state", (2, 1, 4, 16, 8)),
        ("hymba-1.5b_2x2", "ring_k", (2, 1, 64, 2, 16)),
        ("hymba-1.5b_2x2", "meta_k", (2, 1, 8, 2, 16)),
        # the replaced hymba: 6 heads, head_dim 16 split 4 a rank
        (f"{HYMBA_HD}_1x4", "ssd_state", (2, 2, 6, 4, 8)),
        # whisper: cross KV whole over 'model', 20 pages 5 a rank
        ("whisper-large-v3_1x4", "cross_k", (2, 2, 64, 4, 16)),
        ("whisper-large-v3_1x4", "k_pages", (2, 2, 5, 32, 4, 16)),
    ])
    def test_decode_state_is_the_rule_s_shard(self, ranks, name, field, shape):
        for rank in ranks[int(np.prod(SERVE_CASES[name][1]))]:
            assert rank["serve"][name]["state_shapes"][field] == shape


class TestTraining:
    @pytest.mark.parametrize("name", list(TRAIN_CASES))
    def test_loss_and_every_gradient_shard_match_jax(self, work, ranks, name):
        arch, shape = TRAIN_CASES[name]
        ref = work[1][arch]
        _, cfg = configs(arch)
        total = float(np.sqrt(sum(np.sum(np.square(g)) for g in jax.tree.leaves(ref["grads"]))))
        for r, rank in enumerate(ranks[int(np.prod(shape))]):
            got = rank["train"][name]
            assert abs(got["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"]), name
            for i, (g, want) in enumerate(zip(got["grads"], _slices(ref["grads"], cfg, shape,
                                                                     r))):
                assert g.shape == want.shape, (name, i)
                if np.linalg.norm(want) <= ZERO * total:
                    assert np.linalg.norm(g) <= ZERO * total, (name, r, i)
                else:
                    assert rel_err(g, want) <= REL, (name, r, i, rel_err(g, want))
