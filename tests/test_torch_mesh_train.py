"""Training under a ("data", "model") device mesh, in one spawn of 4 ``gloo``
processes on the CPU (every spawn joined with a time limit), against JAX
on one device.

* The collectives' gradients (``models.sharding``): ``all_reduce``,
  ``all_gather`` over each dim, ``all_to_all`` and ``copy_to_model`` at
  (1, 4) and (2, 2), each rank's input gradient against autograd through
  the same computation written out globally in one process (every rank's
  tensors at once); the counter records the backward's collectives.
* ``sharded_nll`` against the reference's ``_sharded_nll`` at (1, 4) with
  padded vocab columns (vocab 29 of 32: rank 3 holds three padded
  columns), in value and in each rank's columns of the gradient.
* ``train_loss`` and every leaf's gradient shard against the slice of
  ``jax.value_and_grad(train_loss)`` (f32): the yi-9b smoke config (h = 8,
  g = 1: the kv groups do not divide TP) at (1, 4), (2, 2) and (4, 1);
  granite-moe folded (DP+EP) and TP+EP at (2, 2), with capacity_factor =
  E / k and 4 x 512 tokens, so that the mesh's MoE groups (sized by the
  DP extent) equal one device's and no pair drops; mamba2 at (4, 1).
  Tolerances as ``tests/test_torch_train.py``'s: the loss to 1e-5
  relative, each gradient shard to 1e-4 in ||err|| / ||ref|| (a shard
  whose JAX slice is zero in exact arithmetic must be as small).
* Two ``make_train_step`` steps (AdamW with its clip, from
  ``bridge.opt_state_from_jax``) against the reference's at
  num_microbatches 1 and 2 on yi at (2, 2), and at 1 on (1, 4) and (4, 1):
  loss 1e-5, grad norm 1e-4 relative, each param shard 1e-4.
* A checkpoint saved at (2, 2): restored at (1, 4) and on one device with
  bit-equal global leaves, and read by JAX's ``restore_checkpoint``.
* ``launch.train --smoke --device cpu --mesh 2,2``: a ``--resume`` from
  the step-3 checkpoint repeats the uninterrupted run's losses exactly.
* (The SSM, hybrid, encoder-decoder and image-prompt families train under
  'model' > 1 in ``tests/test_torch_mesh_families.py``.)
"""
import dataclasses
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jax_ckpt
from repro.configs import get_smoke_config
from repro.launch import steps as jax_steps
from repro.models.registry import build_model as jax_build_model
from repro.models.transformer import _sharded_nll
from repro.optim import adamw as jax_adamw
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.launch import mesh as pt_mesh
from repro_torch.launch.shardings import param_sharding, shard_tensor, spec_leaves
from repro_torch.models import sharding
from repro_torch.models.registry import build_model

SPAWN_TIMEOUT = 240.0
LOSS_RTOL = 1e-5
REL = 1e-4
ZERO = 1e-6        # a slice whose gradient norm is below this share of the total is zero
COLL_ATOL = 1e-5   # the collectives' gradients, f32 sums of a few terms
# name -> (arch, mesh shape, fold, batch, seq)
GRAD_CASES = {
    "yi_1x4": ("yi-9b", (1, 4), False, 4, 32),
    "yi_2x2": ("yi-9b", (2, 2), False, 4, 32),
    "yi_4x1": ("yi-9b", (4, 1), False, 4, 32),
    "granite_2x2_folded": ("granite-moe-3b-a800m", (2, 2), True, 4, 512),
    "granite_2x2_tp": ("granite-moe-3b-a800m", (2, 2), False, 4, 512),
    "mamba2_4x1": ("mamba2-780m", (4, 1), False, 4, 32),
}
# name -> (mesh shape, num_microbatches): two yi train steps
STEP_CASES = {"2x2_micro1": ((2, 2), 1), "2x2_micro2": ((2, 2), 2),
              "1x4_micro1": ((1, 4), 1), "4x1_micro1": ((4, 1), 1)}
OPT = dict(lr_peak=3e-3, warmup_steps=1, total_steps=4)
NLL = dict(b=2, s=5, vocab=29, padded=32)
COLL_MESHES = {"1x4": ((1, 4), ("model",)), "2x2": ((2, 2), ("data", "model"))}


def configs(arch, fold):
    """The case's config in both frameworks: MoE with a capacity that
    drops no pair, and its fold."""
    out = []
    for get in (get_smoke_config, pt_smoke_config):
        cfg = get(arch)
        if cfg.num_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token,
                                      fold_model_axis_into_dp=fold)
        out.append(cfg)
    return out


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------- the rank side
def _collective_cases(dev):
    """Each collective's input gradient on this rank, and the same
    computation written out globally (every rank's tensors in one process)
    with autograd's gradient for this rank's input."""
    out = {}
    for name, (shape, axes) in COLL_MESHES.items():
        mesh = pt_mesh.make_mesh(shape, ("data", "model"), dev)
        with sharding.mesh_context(mesh):
            for ax in axes:
                n, i = sharding.axis_size(ax), sharding.axis_index(ax)
                g = torch.Generator().manual_seed(11)
                X = torch.randn(2 * n, 3 * n, 4 * n, generator=g)
                W = torch.randn(n, 2 * n, 3 * n, 4 * n, generator=g)   # rank j's weights

                def check(kind, fn, simulate, x_of, replicated=False, alike=False):
                    """fn(x) -> this rank's output y; simulate(xs) -> every
                    rank's y.  The global loss is the sum over ranks of
                    W_j * y_j, each rank's term summed in with an
                    all_reduce, as the model's loss is (``alike``: y is the
                    same on every rank and the loss is W_0 * y, computed
                    alike).  ``replicated``: one x on every rank (a single
                    leaf in the global computation)."""
                    def term(j, y):
                        return (W[0 if alike else j][tuple(slice(0, k) for k in y.shape)]
                                * y).sum()

                    sharding.COUNTER.reset()
                    x = x_of(i).clone().requires_grad_(True)
                    y = fn(x)
                    loss = term(i, y) if alike else sharding.all_reduce(term(i, y), ax)
                    loss.backward()
                    xs = [x_of(j).clone().requires_grad_(True) for j in range(n)]
                    if replicated:
                        xs = [xs[0]] * n
                    ys = simulate(xs)
                    ref = term(0, ys[0]) if alike else sum(term(j, yj) for j, yj in enumerate(ys))
                    ref.backward()
                    recs = [(r.kind, r.direction) for r in sharding.COUNTER.records]
                    out[f"{name} {ax} {kind}"] = (x.grad.numpy(), xs[i].grad.numpy(),
                                                  float(loss.detach()), float(ref.detach()),
                                                  recs)

                check("all_reduce", lambda x: sharding.all_reduce(x, ax),
                      lambda xs: [sum(xs)] * n, lambda j: X.chunk(n, 0)[j], alike=True)
                for dim in range(3):
                    check(f"all_gather dim {dim}", lambda x, d=dim: sharding.all_gather(x, ax, d),
                          lambda xs, d=dim: [torch.cat(xs, d)] * n,
                          lambda j, d=dim: X.chunk(n, d)[j])
                check("all_to_all", lambda x: sharding.all_to_all(x, ax, 0, 2),
                      lambda xs: [torch.cat([xi.chunk(n, 0)[j] for xi in xs], 2)
                                  for j in range(n)],
                      lambda j: X.chunk(n, 2)[j])
                if ax == "model":
                    A = torch.randn(4 * n, 5 * n, generator=g)
                    check("copy_to_model",
                          lambda x: sharding.copy_to_model(x) @ A.chunk(n, 1)[i],
                          lambda xs: [xs[j] @ A.chunk(n, 1)[j] for j in range(n)],
                          lambda j: X[:2, :3], replicated=True)
    return out


def _nll_case(dev, ref):
    from repro_torch.models.transformer import sharded_nll

    mesh = pt_mesh.make_mesh((1, 4), ("data", "model"), dev)
    with sharding.mesh_context(mesh):
        logits = sharding.take_shard(torch.from_numpy(ref["logits"]), "model", -1)
        logits = logits.clone().requires_grad_(True)
        nll = sharded_nll(logits, torch.from_numpy(ref["labels"]), NLL["vocab"], NLL["padded"])
        nll.mean().backward()
    return nll.detach().numpy(), logits.grad.numpy()


def _grad_case(dev, name, ref):
    from repro_torch import bridge
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.tree import leaves

    arch, shape, fold, b, s = GRAD_CASES[name]
    _, cfg = configs(arch, fold)
    mesh = pt_mesh.make_mesh(shape, ("data", "model"), dev)
    model = build_model(cfg, device="cpu")
    params = bridge.params_from_jax(ref["params"], mesh=mesh, mode="train", fold_model=fold)
    sharding.COUNTER.reset()
    loss, _, grads = make_grad_step(model, mesh=mesh)(params, {"tokens": ref["tokens"]})
    return {"loss": float(loss), "grads": [g.numpy() for g in leaves(grads)],
            "records": list(sharding.COUNTER.records)}


def _step_case(dev, name, ref):
    from repro_torch import bridge
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves

    shape, micro = STEP_CASES[name]
    _, cfg = configs("yi-9b", False)
    mesh = pt_mesh.make_mesh(shape, ("data", "model"), dev)
    model = build_model(cfg, device="cpu")
    params = bridge.params_from_jax(ref["params"], mesh=mesh, mode="train")
    state = bridge.opt_state_from_jax(ref["opt_state"], mesh=mesh)
    step = make_train_step(model, AdamWConfig(**OPT), remat=True, num_microbatches=micro,
                           mesh=mesh)
    out = []
    for batch in ref["batches"]:
        params, state, met = step(params, state, {"tokens": batch})
        out.append((float(met["loss"]), float(met["grad_norm"]),
                    [p.numpy().copy() for p in leaves(params)]))
    return out, (params, state)


def _checkpoint_case(dev, work, state):
    """Save the (2, 2) train state, restore it under (1, 4) and whole; the
    (1, 4) shards must equal the whole leaves' shards and the whole leaves'
    (2, 2) shards the saved ones, bit for bit."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.shardings import train_state_shardings, NamedSharding
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import leaves

    _, cfg = configs("yi-9b", False)
    model = build_model(cfg, device="cpu")
    full = model.param_shapes()
    like = (full, adamw_init(full, AdamWConfig()), {"seed": 0, "step": 0})
    meshes = {s: pt_mesh.make_mesh(s, ("data", "model"), dev) for s in ((2, 2), (1, 4))}

    def shardings(mesh):
        p, o = train_state_shardings(full, mesh)
        return p, o, {"seed": NamedSharding(mesh, ()), "step": NamedSharding(mesh, ())}

    tree = (*state, {"seed": 0, "step": 2})
    ckpt.save_checkpoint(work / "ckpt", 2, tree, shardings=shardings(meshes[(2, 2)]))
    whole = ckpt.restore_checkpoint(work / "ckpt", 2, like, device="cpu")
    got = ckpt.restore_checkpoint(work / "ckpt", 2, like, device="cpu",
                                  shardings=shardings(meshes[(1, 4)]))
    same_1x4 = all(torch.equal(g, s.shard(w)) for g, s, w in zip(
        leaves(got[:2]), leaves(shardings(meshes[(1, 4)])[:2]), leaves(whole[:2])))
    same_2x2 = all(torch.equal(t, s.shard(w)) for t, s, w in zip(
        leaves(tree[:2]), leaves(shardings(meshes[(2, 2)])[:2]), leaves(whole[:2])))
    return {"same_1x4": same_1x4, "same_2x2": same_2x2, "n_leaves": len(leaves(whole)),
            "data_step": int(got[2]["step"])}


def _rank_main(dev, rank, world, work):
    import pathlib

    torch.set_num_threads(1)  # the smoke sizes; ranks share the host's cores
    work = pathlib.Path(work)
    with open(work / "ref.pkl", "rb") as fh:
        ref = pickle.load(fh)
    out = {"collectives": _collective_cases(dev), "nll": _nll_case(dev, ref["nll"])}
    for name in GRAD_CASES:
        out[name] = _grad_case(dev, name, ref["grad"][name])
    for name in STEP_CASES:
        out[f"step {name}"], state = _step_case(dev, name, ref["step"][name])
        if name == "2x2_micro1":
            out["checkpoint"] = _checkpoint_case(dev, work, state)
    with open(work / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)


# ------------------------------------------------------------ the JAX side
def _jax_grads(arch, fold, b, s):
    cfg, _ = configs(arch, fold)
    jm = jax_build_model(cfg, unroll=True)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init_params(jax.random.PRNGKey(0)))
    tok = tokens(cfg, b, s, seed=b + s)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, {"tokens": jnp.asarray(tok)}, remat=True), has_aux=True))(jp)
    return {"params": np_tree(jp), "tokens": tok, "loss": float(loss), "grads": np_tree(grads)}


def _jax_steps(micro):
    cfg, _ = configs("yi-9b", False)
    jm = jax_build_model(cfg, unroll=True)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init_params(jax.random.PRNGKey(0)))
    jcfg = jax_adamw.AdamWConfig(**OPT)
    js = jax_adamw.adamw_init(jp, jcfg)
    ref = {"params": np_tree(jp), "opt_state": jax.tree.map(np.asarray, js),
           "batches": [tokens(cfg, 4, 32, seed=20 + i) for i in range(2)], "out": []}
    step = jax.jit(jax_steps.make_train_step(jm, jcfg, remat=True, num_microbatches=micro))
    for batch in ref["batches"]:
        jp, js, met = step(jp, js, {"tokens": jnp.asarray(batch)})
        ref["out"].append((float(met["loss"]), float(met["grad_norm"]), np_tree(jp)))
    return ref


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train")
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((NLL["b"], NLL["s"], NLL["padded"])).astype(np.float32)
    labels = rng.integers(0, NLL["vocab"], (NLL["b"], NLL["s"])).astype(np.int32)
    nll, grad = jax.value_and_grad(
        lambda l: _sharded_nll(l, jnp.asarray(labels), NLL["vocab"]).mean())(jnp.asarray(logits))
    ref = {"nll": {"logits": logits, "labels": labels,
                   "nll": np.asarray(_sharded_nll(jnp.asarray(logits), jnp.asarray(labels),
                                                  NLL["vocab"])),
                   "mean": float(nll), "grad": np.asarray(grad)},
           "grad": {}}
    by_inputs = {}   # one device: the fold changes nothing, the mesh shape neither
    for name, (arch, _, fold, b, s) in GRAD_CASES.items():
        if (arch, b, s) not in by_inputs:
            by_inputs[arch, b, s] = _jax_grads(arch, fold, b, s)
        ref["grad"][name] = by_inputs[arch, b, s]
    by_micro = {m: _jax_steps(m) for m in {m for _, m in STEP_CASES.values()}}
    ref["step"] = {name: by_micro[m] for name, (_, m) in STEP_CASES.items()}
    with open(d / "ref.pkl", "wb") as fh:
        pickle.dump(ref, fh)
    return d, ref


@pytest.fixture(scope="module")
def ranks(work):
    d, _ = work
    pt_mesh.spawn(_rank_main, 4, str(d / "init"), device="cpu", args=(str(d),),
                  timeout=SPAWN_TIMEOUT)
    return [pickle.load(open(d / f"rank{r}.pkl", "rb")) for r in range(4)]


def _slices(tree, cfg, shape, rank):
    """The leaves of a global tree (JAX's order), each cut to ``rank``'s
    train shard of a mesh of ``shape``."""
    mesh = pt_mesh.Mesh.view({"data": shape[0], "model": shape[1]}, rank)
    model = build_model(cfg, device="cpu")
    specs = spec_leaves(param_sharding(model.param_shapes(), mesh, mode="train",
                                       fold_model=cfg.fold_model_axis_into_dp))
    flat = jax.tree.leaves(tree)
    assert len(flat) == len(specs)
    return [shard_tensor(torch.from_numpy(np.asarray(a)), sp, mesh).numpy()
            for a, sp in zip(flat, specs)]


# ------------------------------------------------------------------ tests
class TestCollectiveGradients:
    @pytest.mark.parametrize("kind", ["all_reduce", "all_gather dim 0", "all_gather dim 1",
                                      "all_gather dim 2", "all_to_all", "copy_to_model"])
    @pytest.mark.parametrize("mesh", list(COLL_MESHES))
    def test_gradient_equals_the_unsharded_functions(self, ranks, mesh, kind):
        axes = COLL_MESHES[mesh][1] if kind != "copy_to_model" else ("model",)
        for rank in ranks:
            for ax in axes:
                got, want, loss, ref_loss, _ = rank["collectives"][f"{mesh} {ax} {kind}"]
                np.testing.assert_allclose(got, want, atol=COLL_ATOL, rtol=0)
                assert loss == pytest.approx(ref_loss, rel=1e-5)

    def test_counter_records_the_backward(self, ranks):
        recs = ranks[0]["collectives"]
        back = lambda k: [r for r in recs[k][4] if r[1] == "backward"]
        assert back("2x2 data all_reduce") == []                       # the identity
        assert [r for r in recs["2x2 data all_reduce"][4]] == [("all-reduce", "forward")]
        assert back("2x2 model all_gather dim 1") == [("reduce-scatter", "backward")]
        assert back("1x4 model all_to_all") == [("all-to-all", "backward")]
        assert back("1x4 model copy_to_model") == [("all-reduce", "backward")]
        fwd = [r for r in recs["1x4 model copy_to_model"][4] if r[1] == "forward"]
        assert fwd == [("all-reduce", "forward")]                       # the loss's sum only


class TestShardedNll:
    def test_value_and_gradient_match_the_reference(self, ranks, work):
        ref = work[1]["nll"]
        n = NLL["padded"] // 4
        for r, rank in enumerate(ranks):
            nll, grad = rank["nll"]
            np.testing.assert_allclose(nll, ref["nll"], rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(grad, ref["grad"][..., r * n:(r + 1) * n], atol=1e-7,
                                       rtol=0)
        # rank 3's last three columns are padding: no gradient reaches them
        assert not ranks[3]["nll"][1][..., n - 3:].any()


class TestTrainLossAndGrads:
    @pytest.mark.parametrize("name", list(GRAD_CASES))
    def test_loss_and_every_gradient_shard_match_jax(self, ranks, work, name):
        arch, shape, fold, _, _ = GRAD_CASES[name]
        ref = work[1]["grad"][name]
        _, cfg = configs(arch, fold)
        total = float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                                  for g in jax.tree.leaves(ref["grads"]))))
        paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(ref["grads"])[0]]
        for r, rank in enumerate(ranks):
            got = rank[name]
            assert abs(got["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
            want = _slices(ref["grads"], cfg, shape, r)
            assert len(got["grads"]) == len(want)
            for path, g, w in zip(paths, got["grads"], want):
                what = f"{name} rank {r} grad {path}"
                assert g.shape == w.shape, what
                if np.linalg.norm(w) <= ZERO * total:
                    assert np.linalg.norm(g) <= ZERO * total, what
                    continue
                assert rel_err(g, w) < REL, what

    @pytest.mark.parametrize("name", list(GRAD_CASES))
    def test_a_step_runs_collectives_both_ways(self, ranks, name):
        records = ranks[0][name]["records"]
        kinds = {(r.kind, r.direction) for r in records}
        assert ("all-gather", "forward") in kinds             # FSDP gathers
        assert ("reduce-scatter", "backward") in kinds        # their gradients
        if "granite" in name:
            assert {("all-to-all", "forward"), ("all-to-all", "backward")} <= kinds
        if "_tp" in name or "1x4" in name or "yi_2x2" in name:
            assert ("all-reduce", "backward") in kinds        # copy_to_model


def test_train_step_wire_model_splits_the_directions(ranks):
    """``hlo_analysis.train_step_stats`` over a step's records: the two
    directions' counts add up to the records', a reduce-scatter's bytes
    on the wire are its slice's times the group (in_bytes)."""
    from repro_torch.launch.hlo_analysis import train_step_stats

    records = ranks[0]["yi_2x2"]["records"]
    stats = train_step_stats(records)
    assert sum(sum(st.by_kind_count.values()) for st in stats.values()) == len(records)
    rs = [r for r in records if r.kind == "reduce-scatter"]
    assert rs and all(r.direction == "backward" for r in rs)
    assert stats["backward"].by_kind_bytes["reduce-scatter"] == sum(r.nbytes for r in rs)
    rest = sum(r.nbytes * (2.0 if r.kind == "all-reduce" else 1.0) for r in records
               if r.direction == "backward" and r.kind != "reduce-scatter")
    assert stats["backward"].wire_bytes == rest + sum(r.nbytes * r.group_size for r in rs)


class TestTrainSteps:
    @pytest.mark.parametrize("name", list(STEP_CASES))
    def test_two_steps_match_the_reference(self, ranks, work, name):
        shape, _ = STEP_CASES[name]
        ref = work[1]["step"][name]
        _, cfg = configs("yi-9b", False)
        for r, rank in enumerate(ranks):
            for i, ((loss, gnorm, params), (jloss, jgnorm, jp)) in enumerate(
                    zip(rank[f"step {name}"], ref["out"])):
                assert loss == pytest.approx(jloss, rel=LOSS_RTOL), (r, i)
                assert gnorm == pytest.approx(jgnorm, rel=REL), (r, i)
                for got, want in zip(params, _slices(jp, cfg, shape, r)):
                    assert rel_err(got, want) < REL, (r, i)


class TestCheckpoint:
    def test_restored_under_another_mesh_and_whole_bit_equal(self, ranks):
        for rank in ranks:
            ck = rank["checkpoint"]
            assert ck["same_1x4"] and ck["same_2x2"] and ck["data_step"] == 2

    def test_jax_reads_what_the_mesh_wrote(self, ranks, work):
        from repro_torch.ckpt import checkpoint as pt_ckpt
        from repro_torch.optim.adamw import AdamWConfig, adamw_init
        from repro_torch.tree import leaves

        d = work[0]
        model = build_model(pt_smoke_config("yi-9b"), device="cpu")
        full = model.param_shapes()
        like = (full, adamw_init(full, AdamWConfig()), {"seed": 0, "step": 0})
        whole = pt_ckpt.restore_checkpoint(d / "ckpt", 2, like, device="cpu")
        jlike = jax.tree.map(lambda t: jnp.zeros(t.shape, str(t.dtype).split(".")[1])
                             if isinstance(t, torch.Tensor) else t, like)
        got = jax_ckpt.restore_checkpoint(d / "ckpt", 2, jlike)
        assert len(jax.tree.leaves(got)) == len(leaves(whole)) == ranks[0]["checkpoint"][
            "n_leaves"]
        for r, t in zip(jax.tree.leaves(got), leaves(whole)):
            np.testing.assert_array_equal(np.asarray(r), torch.as_tensor(t).numpy())
        # the global params are the JAX run's after its two steps, to 1e-4
        jp = work[1]["step"]["2x2_micro1"]["out"][-1][2]
        for r, t in zip(jax.tree.leaves(jp), leaves(whole[0])):
            assert rel_err(t.numpy(), r) < REL


def test_launcher_resume_under_a_mesh_repeats_the_losses(tmp_path, capfd):
    from repro_torch.launch import train

    common = ["--arch", "yi-9b", "--smoke", "--device", "cpu", "--mesh", "2,2", "--batch", "4",
              "--seq", "32", "--lr", "3e-3", "--steps", "6", "--ckpt-dir", str(tmp_path)]
    full = train.main(common + ["--ckpt-every", "3"])["losses"]
    shutil.rmtree(tmp_path / "step_00000006")   # resume from the step-3 checkpoint
    rest = train.main(common + ["--ckpt-every", "100", "--resume"])["losses"]
    assert rest == full[3:]
    assert all(np.isfinite(full)) and full[-1] < full[0]
    out = capfd.readouterr().out
    assert "4 devices" in out and "[train] resumed from step 3" in out
    assert out.count("[train] done") == 2   # rank 0 alone prints
