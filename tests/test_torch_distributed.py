"""The port under a device mesh, in ``gloo`` groups of 4 and 2 processes on
the CPU, against the JAX package.

* The branches: the sequence-parallel decode (``paged_decode_with_write``
  with the pages split over 'model') and the expert-parallel MoE against
  the reference's ``shard_map`` branches themselves, which run in a
  subprocess on 4 host devices (``XLA_FLAGS=--xla_force_host_platform_
  device_count=4``).  Its meshes are built with Auto axes: under jax 0.9
  ``jax.make_mesh`` makes Explicit axes, with which the reference's branch
  raises ("Length of device assignment 1 is not equal to the size of the
  mesh 4").  f32 at atol 2e-5 (decode) and 1e-5 (MoE); the port's counted
  collective bytes equal the reference's ``collective_bytes`` of the
  compiled HLO (XLA:CPU keeps these collectives in f32 here, as the inputs
  are).  In bf16 the EP branch equals the port's own single-device MoE, as
  the reference's EP branch equals the reference's single-device one.
* Whole steps: prefill + 4 decode steps through ``launch.steps`` with
  params from ``bridge.params_from_jax(..., mesh=...)`` against JAX on one
  device, f32 logits at atol 1e-4 and tokens equal: the yi-9b smoke config
  (h=8, g=1: the kv groups do not divide TP) at (1,4) with per_seq % 4 = 0
  (rank 2's slice partial, rank 3's empty) and != 0 (pages whole), and at
  (1,2); the granite-moe smoke config at (2,2) folded (DP+EP) and not
  (TP+EP, its 2 kv groups split over 'model').  A MoE output depends on the
  token's group, and the reference ties the group size to the mesh's DP
  extent; with a capacity that drops no (token, expert) pair
  (capacity_factor = E / k) an output is its token's own, so the mesh run
  must give the one-device run's.
* The plain versions' lse and zero-context contract, the bf16 margin rule
  of ``repro_torch.parity``, and the families refused under 'model' > 1.

Every spawn is joined with a time limit: a hung rank fails the test.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models.transformer import DecoderLM as JaxDecoderLM
from repro_torch import parity
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.launch import mesh as pt_mesh
from repro_torch.launch.hlo_analysis import collective_stats
from repro_torch.models import sharding
from repro_torch.models.registry import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 240.0
ATOL = 1e-4
SP_ATOL = 2e-5
EP_ATOL = 1e-5
# the sequence-parallel branch's inputs: b, h, g, d, bs, pages a sequence, contexts
SP = dict(b=2, h=8, g=2, d=16, bs=4, per=8, ctx=[5, 17])
EP_MESHES = {"4x1": ((4, 1), False), "2x2_folded": ((2, 2), True)}

# (name, arch, mesh shape, fold, batch, prompt length): the whole-step cases
STEP_CASES = {
    "yi_1x4_seq_parallel": ("yi-9b", (1, 4), False, 2, 512),
    "yi_1x4_pages_whole": ("yi-9b", (1, 4), False, 2, 45),
    "granite_2x2_folded": ("granite-moe-3b-a800m", (2, 2), True, 4, 40),
    "granite_2x2_tp": ("granite-moe-3b-a800m", (2, 2), False, 4, 40),
    "yi_1x2_seq_parallel": ("yi-9b", (1, 2), False, 2, 45),
    "yi_1x2_pages_whole": ("yi-9b", (1, 2), False, 3, 65),
}
WORLD = {4: [n for n, c in STEP_CASES.items() if np.prod(c[1]) == 4],
         2: [n for n, c in STEP_CASES.items() if np.prod(c[1]) == 2]}
DECODE_STEPS = 4

_JAX_BRANCHES = r'''
import json, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.launch.hlo_analysis import collective_bytes
from repro.models import moe, sharding
from repro.models.attention import KVPages, paged_decode_with_write

out_path, sp_json = sys.argv[1], sys.argv[2]
SP = json.loads(sp_json)
EP_MESHES = {"4x1": ((4, 1), False), "2x2_folded": ((2, 2), True)}


def mesh(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


res = {}
rng = np.random.default_rng(0)
b, h, g, d, bs, per = (SP[k] for k in ("b", "h", "g", "d", "bs", "per"))
sp_in = dict(q=rng.standard_normal((b, h, d)), k_new=rng.standard_normal((b, g, d)),
             v_new=rng.standard_normal((b, g, d)),
             k_pages=rng.standard_normal((b, per, bs, g, d)),
             v_pages=rng.standard_normal((b, per, bs, g, d)))
sp_in = {k: v.astype(np.float32) for k, v in sp_in.items()}
sp_in["tables"] = np.tile(np.arange(per, dtype=np.int32), (b, 1))
sp_in["ctx"] = np.asarray(SP["ctx"], np.int32)
res["sp_inputs"] = sp_in


def sp(*a):
    o, pg = paged_decode_with_write(a[0], a[1], a[2], KVPages(a[3], a[4]), a[5], a[6])
    return o, pg.k_pages, pg.v_pages


args = [sp_in[k] for k in ("q", "k_new", "v_new", "k_pages", "v_pages", "tables", "ctx")]
sharding.set_mesh(mesh((1, 4)))
f = jax.jit(lambda *a: sp(*a))
res["sp_out"] = [np.asarray(x) for x in f(*args)]
st = collective_bytes(f.lower(*args).compile().as_text())
res["sp_bytes"] = (st.by_kind_bytes, st.by_kind_count)
sharding.set_mesh(None)

cfg = get_smoke_config("granite-moe-3b-a800m")
p = jax.tree.map(lambda a: a.astype(jnp.float32), moe.moe_init(jax.random.PRNGKey(0), cfg))
x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
res["ep_params"] = jax.tree.map(np.asarray, p)
res["ep_x"] = x
for name, (shape, fold) in EP_MESHES.items():
    sharding.set_mesh(mesh(shape), fold_model_axis=fold)
    f = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg, group_size=16))
    out, aux = f(p, jnp.asarray(x))
    st = collective_bytes(f.lower(p, jnp.asarray(x)).compile().as_text())
    res[f"ep_{name}"] = (np.asarray(out), float(aux), st.by_kind_bytes, st.by_kind_count)
    sharding.set_mesh(None)
with open(out_path, "wb") as fh:
    pickle.dump(res, fh)
'''


# ------------------------------------------------------------- helpers
def _step_cfg(arch, fold):
    """The case's config in both frameworks: granite with a capacity that
    drops no pair (see the module docstring) and its fold."""
    out = []
    for get in (get_smoke_config, pt_smoke_config):
        cfg = get(arch)
        if cfg.num_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token,
                                      fold_model_axis_into_dp=fold)
        out.append(cfg)
    return out


def _prompts(cfg, b, s):
    return np.random.default_rng(s).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jax_steps(arch, fold, b, s, params):
    """JAX on one device: prefill + DECODE_STEPS greedy steps -> (logits
    per step [b, V], tokens per step)."""
    cfg, _ = _step_cfg(arch, fold)
    jm = JaxDecoderLM(cfg)
    logits, state = jm.prefill(params, {"tokens": jnp.asarray(_prompts(cfg, b, s))},
                               remat=False)
    all_logits, toks = [], []
    for step in range(DECODE_STEPS + 1):
        tok = np.asarray(jnp.argmax(logits[:, : cfg.vocab_size], axis=-1), np.int32)
        all_logits.append(np.asarray(logits))
        toks.append(tok)
        if step < DECODE_STEPS:
            logits, state = jm.decode_step(params, state, jnp.asarray(tok))
    return all_logits, toks


def _gather_logits(logits, cfg, axes):
    if logits.shape[-1] < cfg.padded_vocab:
        logits = sharding.all_gather(logits, "model", 1)
    return sharding.all_gather(logits, axes, 0)


# ------------------------------------------------------- the rank bodies
def _rank_steps(dev, rank, name, work):
    """One whole-step case on this rank: params sharded from the JAX ones,
    prefill + decode steps through launch.steps with the logits captured."""
    from repro_torch import bridge
    from repro_torch.launch.shardings import batch_spec, spec_axes
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    arch, shape, fold, b, s = STEP_CASES[name]
    _, cfg = _step_cfg(arch, fold)
    mesh = pt_mesh.make_mesh(shape, ("data", "model"), dev)
    with open(os.path.join(work, f"params_{arch}.pkl"), "rb") as fh:
        params = bridge.params_from_jax(pickle.load(fh), mesh=mesh, fold_model=fold)
    model = build_model(cfg, device="cpu")
    seen = []
    for fn in ("prefill", "decode_step"):
        orig = getattr(model, fn)

        def spy(*a, _orig=orig, **k):
            logits, st = _orig(*a, **k)
            seen.append((logits, st))
            return logits, st
        setattr(model, fn, spy)
    prefill, serve = make_prefill_step(model, mesh=mesh), make_serve_step(model, mesh=mesh)
    sharding.COUNTER.reset()
    tok, state = prefill(params, {"tokens": torch.from_numpy(_prompts(cfg, b, s))})
    toks = [tok.numpy()]
    for _ in range(DECODE_STEPS):
        tok, state = serve(params, state, tok)
        toks.append(tok.numpy())
    records = list(sharding.COUNTER.records)
    with sharding.mesh_context(mesh, fold_model_axis=fold):
        spec = batch_spec(mesh, b, fold_model=fold)
        logits = [_gather_logits(seen[0][0], cfg, spec_axes(spec[0]) if spec else ()).numpy()]
        logits += [_gather_logits(lg, cfg, state.layout.batch_axes).numpy()
                   for lg, _ in seen[1:]]
        local_ctx = (state.context_lens.long() - sharding.axis_index("model")
                     * state.k_pages.shape[2] * state.k_pages.shape[3]).clamp(min=0)
    return {"logits": logits, "tokens": toks, "layout": state.layout,
            "pages_local": tuple(state.k_pages.shape), "local_ctx": local_ctx.tolist(),
            "kinds": sorted({r.kind for r in records})}


def _rank_branches(dev, rank, work):
    """The sequence-parallel decode and the EP MoE on the reference's inputs."""
    from repro_torch import bridge
    from repro_torch.launch.shardings import shard_params, shard_tensor
    from repro_torch.models import moe
    from repro_torch.models.attention import KVPages, paged_decode_with_write
    from repro_torch.tree import tree_map

    with open(os.path.join(work, "jax_branches.pkl"), "rb") as fh:
        ref = pickle.load(fh)
    out = {}
    mesh = pt_mesh.make_mesh((1, 4), ("data", "model"), dev)
    t = {k: torch.from_numpy(v) for k, v in ref["sp_inputs"].items()}
    spec = (None, "model", None, None, None)
    pages = KVPages(shard_tensor(t["k_pages"], spec, mesh), shard_tensor(t["v_pages"], spec, mesh))
    with sharding.mesh_context(mesh):
        sharding.COUNTER.reset()
        o, pages = paged_decode_with_write(
            t["q"], t["k_new"], t["v_new"], pages,
            shard_tensor(t["tables"], (None, "model"), mesh), t["ctx"], seq_parallel=True)
        records = list(sharding.COUNTER.records)
        out["sp"] = (o.numpy(), sharding.all_gather(pages.k_pages, "model", 1).numpy(),
                     sharding.all_gather(pages.v_pages, "model", 1).numpy(), records)

    cfg = pt_smoke_config("granite-moe-3b-a800m")
    full = bridge.params_from_jax(ref["ep_params"])
    x = torch.from_numpy(ref["ep_x"])
    single = {dt: moe.moe_apply(bridge.params_from_jax(ref["ep_params"], dtype=dt),
                                x.to(dt), cfg, group_size_pref=16)[0]
              for dt in (torch.bfloat16,)}
    for name, (shape, fold) in EP_MESHES.items():
        m = pt_mesh.make_mesh(shape, ("data", "model"), dev)
        axes = ("data", "model") if fold else ("data",)
        with sharding.mesh_context(m, fold_model_axis=fold):
            res = {}
            for dt in (torch.float32, torch.bfloat16):
                p = tree_map(lambda v: v.to(dt),
                             shard_params({"moe": full}, m, fold_model=fold)["moe"])
                sharding.COUNTER.reset()
                y, aux = moe.moe_apply(p, sharding.take_shard(x.to(dt), axes, 0), cfg,
                                       group_size_pref=16, batch_axes=axes)
                records = list(sharding.COUNTER.records)
                res[str(dt)] = (sharding.all_gather(y, axes, 0).float().numpy(), float(aux),
                                records)
            res["single_bf16"] = single[torch.bfloat16].float().numpy()
            out[f"ep_{name}"] = res
    return out


def _rank_greedy_ties(dev):
    """``launch.steps._greedy`` over logits split by vocab over 2 ranks:
    each row's best value twice, on both ranks or on one, and past the real
    vocabulary (in the padding)."""
    from repro_torch.launch.steps import _greedy

    cfg = pt_smoke_config("yi-9b")      # vocab 512, padded 512: 256 columns a rank
    model = build_model(cfg, device="cpu")
    full = torch.zeros(4, cfg.padded_vocab)
    full[0, [300, 7]] = 5.0             # a tie across ranks: 7 (rank 0) wins
    full[1, [260, 400]] = 5.0           # both on rank 1: 260
    full[2, [3, 9]] = 5.0               # both on rank 0: 3
    full[3, 511] = 9.0                  # the real vocabulary ends at 511: it counts
    full[3, 100] = 2.0
    mesh = pt_mesh.make_mesh((1, 2), ("data", "model"), dev)
    with sharding.mesh_context(mesh):
        got = _greedy(model, sharding.take_shard(full, "model", 1).contiguous())
    return got.tolist(), torch.argmax(full, dim=-1).tolist()


def _rank_main(dev, rank, world, work, names, branches):
    torch.set_num_threads(1)  # the smoke sizes; ranks share the host's cores
    out = {name: _rank_steps(dev, rank, name, work) for name in names}
    if branches:
        out.update(_rank_branches(dev, rank, work))
    if world == 2:  # the refusals that need a process group, and greedy ties
        try:
            pt_mesh.make_production_mesh(device=dev)
        except ValueError as e:
            out["production_mesh_error"] = str(e)
        out["greedy_ties"] = _rank_greedy_ties(dev)
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The JAX side: the reference's branches on 4 host devices (a
    subprocess), and each whole-step arch's f32 params."""
    d = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    script = d / "jax_branches.py"
    script.write_text(_JAX_BRANCHES)
    subprocess.run([sys.executable, str(script), str(d / "jax_branches.pkl"), json.dumps(SP)],
                   check=True, env=env, timeout=300, cwd=ROOT)
    for arch in {c[0] for c in STEP_CASES.values()}:
        jp = JaxDecoderLM(get_smoke_config(arch)).init_params(jax.random.PRNGKey(0))
        with open(d / f"params_{arch}.pkl", "wb") as fh:
            pickle.dump(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), fh)
    return d


def _spawn(work, world, branches):
    names = WORLD[world]
    pt_mesh.spawn(_rank_main, world, str(work / f"init{world}"), device="cpu",
                  args=(str(work), names, branches), timeout=SPAWN_TIMEOUT)
    return [pickle.load(open(work / f"rank{r}.pkl", "rb")) for r in range(world)]


@pytest.fixture(scope="module")
def world4(work):
    return _spawn(work, 4, branches=True)


@pytest.fixture(scope="module")
def world2(work):
    return _spawn(work, 2, branches=False)


@pytest.fixture(scope="module")
def ref_branches(work):
    with open(work / "jax_branches.pkl", "rb") as fh:
        return pickle.load(fh)


# --------------------------------------------------------------- tests
class TestSequenceParallelDecode:
    def test_output_matches_reference_shard_map(self, world4, ref_branches):
        for rank in world4:
            np.testing.assert_allclose(rank["sp"][0], ref_branches["sp_out"][0], atol=SP_ATOL,
                                       rtol=0)

    def test_ownership_masked_write_matches(self, world4, ref_branches):
        _, k, v, _ = world4[0]["sp"]
        np.testing.assert_array_equal(k, ref_branches["sp_out"][1])
        np.testing.assert_array_equal(v, ref_branches["sp_out"][2])

    def test_all_reduce_bytes_equal_the_reference_hlo(self, world4, ref_branches):
        """``hlo_analysis.collective_stats`` over the counter's records
        equals the reference's ``collective_bytes`` of its compiled HLO."""
        by_bytes, by_count = ref_branches["sp_bytes"]
        b, h, d = SP["b"], SP["h"], SP["d"]
        assert by_bytes["all-reduce"] == 2 * b * h * 4 + b * h * d * 4 == 1152
        for rank in world4:
            st = collective_stats(rank["sp"][3])
            assert st.by_kind_bytes == by_bytes and st.by_kind_count == by_count
            assert st.wire_bytes == 2 * 1152 == st.f32_wire_bytes  # all-reduce counts 2x


class TestExpertParallelMoE:
    @pytest.mark.parametrize("name", list(EP_MESHES))
    def test_f32_matches_reference_shard_map(self, world4, ref_branches, name):
        ref_out, ref_aux = ref_branches[f"ep_{name}"][:2]
        for rank in world4:
            out, aux, _ = rank[f"ep_{name}"][str(torch.float32)]
            np.testing.assert_allclose(out, ref_out, atol=EP_ATOL, rtol=0)
            assert aux == pytest.approx(ref_aux, abs=EP_ATOL)

    @pytest.mark.parametrize("name", list(EP_MESHES))
    def test_all_to_all_bytes_equal_the_reference_hlo(self, world4, ref_branches, name):
        by_bytes, by_count = ref_branches[f"ep_{name}"][2:]
        for rank in world4:
            st = collective_stats(rank[f"ep_{name}"][str(torch.float32)][2])
            assert st.by_kind_count["all-to-all"] == by_count["all-to-all"] == 2
            assert st.by_kind_bytes["all-to-all"] == by_bytes["all-to-all"]

    @pytest.mark.parametrize("name", list(EP_MESHES))
    def test_bf16_equals_single_device(self, world4, name):
        res = world4[0][f"ep_{name}"]
        np.testing.assert_array_equal(res[str(torch.bfloat16)][0], res["single_bf16"])

    def test_folded_mesh_gathers_the_fsdp_expert_weights(self, world4):
        records = world4[0]["ep_2x2_folded"][str(torch.float32)][2]
        gathers = [r for r in records if r.kind == "all-gather"]
        assert [(r.axis, r.shape) for r in gathers] == \
            [("model", (8, 64, 64))] * 3  # gate, up, down: 8 experts a rank, d_ff whole


class TestWholeSteps:
    @pytest.mark.parametrize("name", list(STEP_CASES))
    def test_logits_and_tokens_match_jax_on_one_device(self, work, world4, world2, name):
        arch, shape, fold, b, s = STEP_CASES[name]
        with open(work / f"params_{arch}.pkl", "rb") as fh:
            jp = jax.tree.map(jnp.asarray, pickle.load(fh))
        ref_logits, ref_toks = _jax_steps(arch, fold, b, s, jp)
        ranks = world4 if np.prod(shape) == 4 else world2
        for rank in ranks:
            got = rank[name]
            for step, (lg, want) in enumerate(zip(got["logits"], ref_logits)):
                np.testing.assert_allclose(lg, want, atol=ATOL, rtol=0,
                                           err_msg=f"{name} step {step}")
            for tok, want in zip(got["tokens"], ref_toks):
                np.testing.assert_array_equal(tok, want)

    @pytest.mark.parametrize("name,seq_parallel", [
        ("yi_1x4_seq_parallel", True), ("yi_1x4_pages_whole", False),
        ("yi_1x2_seq_parallel", True), ("yi_1x2_pages_whole", False),
        ("granite_2x2_folded", True), ("granite_2x2_tp", True)])
    def test_the_layout_each_case_takes(self, world4, world2, name, seq_parallel):
        ranks = world4 if np.prod(STEP_CASES[name][1]) == 4 else world2
        for rank in ranks:
            assert rank[name]["layout"].seq_parallel is seq_parallel

    def test_rank_slices_full_partial_and_empty(self, world4):
        """yi at (1,4), 512 tokens + 4: 32 + 16 pages, 8 a rank (256
        tokens): ranks 0 and 1 full, rank 2 partial, rank 3 empty."""
        ctx = [r["yi_1x4_seq_parallel"]["local_ctx"] for r in world4]
        assert [c[0] for c in ctx] == [516, 260, 4, 0]
        assert world4[0]["yi_1x4_seq_parallel"]["pages_local"][2] == 8

    def test_moe_cases_exchange_experts(self, world4):
        for name in ("granite_2x2_folded", "granite_2x2_tp"):
            assert "all-to-all" in world4[0][name]["kinds"]

    def test_greedy_over_vocab_shards_breaks_ties_low(self, world2):
        for rank in world2:
            got, argmax = rank["greedy_ties"]
            assert got == argmax == [7, 260, 3, 511]

    def test_production_mesh_needs_its_ranks(self, world2):
        for rank in world2:
            msg = rank["production_mesh_error"]
            assert "256 ranks" in msg and "the world has 2" in msg


# ------------------------------------------------ plain versions, rules
class TestPlainLse:
    def test_lse_is_the_scores_log_sum_exp(self):
        rng = np.random.default_rng(3)
        b, h, g, d, per, bs = 2, 4, 2, 8, 3, 4
        q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
        kp = torch.from_numpy(rng.standard_normal((b, per, bs, g, d)).astype(np.float32))
        vp = torch.from_numpy(rng.standard_normal((b, per, bs, g, d)).astype(np.float32))
        tables = torch.tensor([[2, 0, 1], [0, 1, 2]], dtype=torch.int32)
        ctx = torch.tensor([7, 12], dtype=torch.int32)
        out, lse = paged_attention_ref(q, kp, vp, tables, ctx, return_lse=True)
        assert torch.equal(out, paged_attention_ref(q, kp, vp, tables, ctx))
        for i in range(b):
            k = kp[i, tables[i].long()].reshape(per * bs, g, d)[: ctx[i]]
            for head in range(h):
                s = (k[:, head // (h // g)] @ q[i, head]).double() * d ** -0.5
                assert float(lse[i, head]) == pytest.approx(float(torch.logsumexp(s, 0)),
                                                            abs=1e-5)

    def test_zero_context_gives_zero_and_minus_inf(self):
        q = torch.randn(2, 4, 8)
        kp, vp = torch.randn(2, 2, 4, 2, 8), torch.randn(2, 2, 4, 2, 8)
        tables = torch.zeros(2, 2, dtype=torch.int32)
        out, lse = paged_attention_ref(q, kp, vp, tables, torch.tensor([0, 3], dtype=torch.int32),
                                       return_lse=True)
        assert torch.equal(out[0], torch.zeros(4, 8)) and not torch.isnan(out).any()
        assert torch.isinf(lse[0]).all() and (lse[0] < 0).all() and torch.isfinite(lse[1]).all()

    def test_combining_slices_with_lse_is_the_whole(self):
        """Two slices of a context, combined with their lse as the
        sequence-parallel branch does, give the attention over the whole."""
        rng = np.random.default_rng(4)
        q = torch.from_numpy(rng.standard_normal((1, 4, 8)).astype(np.float32))
        kp = torch.from_numpy(rng.standard_normal((1, 4, 4, 1, 8)).astype(np.float32))
        vp = torch.from_numpy(rng.standard_normal((1, 4, 4, 1, 8)).astype(np.float32))
        whole = paged_attention_ref(q, kp, vp, torch.arange(4, dtype=torch.int32)[None],
                                    torch.tensor([11], dtype=torch.int32))
        parts = [paged_attention_ref(q, kp[:, 2 * i:2 * i + 2], vp[:, 2 * i:2 * i + 2],
                                     torch.arange(2, dtype=torch.int32)[None],
                                     torch.tensor([min(max(11 - 8 * i, 0), 8)],
                                                  dtype=torch.int32), return_lse=True)
                 for i in range(2)]
        m = torch.maximum(parts[0][1], parts[1][1])
        w = [torch.exp(lse - m) for _, lse in parts]
        got = sum(o * wi[..., None] for (o, _), wi in zip(parts, w)) / sum(w)[..., None]
        torch.testing.assert_close(got, whole, atol=1e-6, rtol=0)


class TestBf16MarginRule:
    def test_a_tie_stops_the_comparison(self):
        ref_logits = [torch.tensor([[0.0, 5.0, 1.0], [3.0, 0.0, 0.0]]),
                      torch.tensor([[2.0, 2.0, 0.0], [0.0, 0.0, 9.0]]),   # row 0: a tie
                      torch.tensor([[9.0, 0.0, 0.0], [0.0, 4.0, 0.0]])]
        ref_tokens = [[1, 0], [0, 2], [0, 1]]
        got = [[1, 0], [1, 2], [2, 1]]   # row 0 parts at the tie and after
        res = parity.check_greedy_tokens(ref_logits, ref_tokens, got, tol=0.1)
        assert res == {"compared": 4, "first_uncompared_step": [1, None]}

    def test_a_clear_margin_must_agree(self):
        with pytest.raises(AssertionError, match="sequence 1, step 0"):
            parity.check_greedy_tokens([torch.tensor([[0.0, 1.0], [5.0, 0.0]])], [[1, 0]],
                                       [[1, 1]], tol=0.5)

    def test_margin_inside_the_tolerance_is_not_compared(self):
        res = parity.check_greedy_tokens([torch.tensor([[1.0, 1.05, -3.0]])], [[1]], [[0]],
                                         tol=0.1)
        assert res == {"compared": 0, "first_uncompared_step": [0]}

    def test_margin_reads_the_real_vocabulary(self):
        # a padded column above the best real one is not the runner-up
        m = parity.top2_margin(torch.tensor([[1.0, 3.0, 9.0]]), vocab=2)
        assert float(m[0]) == 2.0


class TestRefusedUnderTensorParallel:
    @pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b", "whisper-large-v3",
                                      "llava-next-mistral-7b"])
    def test_other_families_refuse_a_model_axis(self, arch):
        cfg = pt_smoke_config(arch)
        model = build_model(cfg, device="cpu")
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.zeros((1, cfg.vision_tokens, cfg.d_model))
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.zeros((1, cfg.encoder_seq, cfg.d_model))
        with sharding.mesh_context(pt_mesh.Mesh.view({"data": 1, "model": 2}, 0)):
            with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1"):
                model.prefill(model.init_params(0), batch)
