"""The dry-run (``repro_torch.launch.dryrun``): steps on meta tensors under
a count-only view of a mesh.

* Its collectives equal a real run's: at the smoke configs of every
  family (dense yi-9b, MoE granite-moe folded, SSM mamba2, hybrid hymba,
  VLM llava with image embeddings, encoder-decoder whisper) on (2, 2) and
  (1, 4), the records (kind, dtype, shape, group, axis, direction, in
  order) of a train step, a prefill step and a decode step counted on
  meta tensors equal those of the same step run on every rank of a spawn
  of 4 ``gloo`` processes, rank by rank; and every rank's view of a
  production mesh counts alike.
* ``argument_bytes`` equals the sum of the rank's real local tensors
  (``shard_params`` of the initialised params, AdamW's state, its rows).
* Full depth equals f(1) + (units - 1)·(f(2) - f(1)) on a uniform stack,
  for the operations, the bytes and the collectives.
* A kernel wrapper on meta tensors counts its bound's formula (checked
  against the visible pairs of the plain versions' masks), and runs
  neither the kernel nor the plain version.
* The CLI writes the reference's file names and keys for two production
  cells at depth 1, and a skipped cell with the reference's reason.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from repro.launch.steps import SHAPES as JAX_SHAPES, skip_reason as jax_skip_reason
from repro.configs import get_config as jax_config
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as pt_mesh
from repro_torch.models import sharding
from repro_torch.models.registry import build_model

SPAWN_TIMEOUT = 300.0
ARCHS = ["yi-9b", "granite-moe-3b-a800m", "mamba2-780m", "hymba-1.5b", "llava-next-mistral-7b",
         "whisper-large-v3"]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
TRAIN = (4, 32)      # batch, tokens
PREFILL = (2, 40)    # batch, tokens: hymba's ring wraps, llava's 40 + 32 give 3 + 16 pages


def _records(records):
    return [(r.kind, str(r.dtype), tuple(r.shape), r.group_size, r.axis, r.direction)
            for r in records]


def _shape(mesh):
    return {"data": mesh[0], "model": mesh[1]}


# ------------------------------------------------------- the real ranks
def _real_rank(dev, rank, world, work):
    from repro_torch.launch.mesh import build_params, make_mesh, prompt_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    torch.set_num_threads(1)
    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        fold = cfg.fold_model_axis_into_dp
        for name, shape in MESHES.items():
            mesh = make_mesh(shape, ("data", "model"), dev)
            model = build_model(cfg, device="cpu")
            params = build_params(model, mesh, fold_model=fold)
            prefill, serve = make_prefill_step(model, mesh=mesh), make_serve_step(model, mesh=mesh)
            sharding.COUNTER.reset()
            tok, state = prefill(params, prompt_batch(cfg, *PREFILL))
            out[arch, name, "prefill"] = _records(sharding.COUNTER.records)
            sharding.COUNTER.reset()
            serve(params, state, tok)
            out[arch, name, "decode"] = _records(sharding.COUNTER.records)
            params = build_params(model, mesh, fold_model=fold, mode="train")
            ocfg = AdamWConfig(fp32_master=cfg.fp32_master)
            opt = adamw_init(params, ocfg)
            sharding.COUNTER.reset()
            make_train_step(model, ocfg, mesh=mesh)(params, opt, prompt_batch(cfg, *TRAIN))
            out[arch, name, "train"] = _records(sharding.COUNTER.records)
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    pt_mesh.spawn(_real_rank, 4, str(d / "init"), device="cpu", args=(str(d),),
                  timeout=SPAWN_TIMEOUT)
    return [pickle.load(open(d / f"rank{r}.pkl", "rb")) for r in range(4)]


def _counted(arch, mesh, kind, rank):
    cfg = get_smoke_config(arch)
    if kind == "train":
        got = dryrun.count(cfg, "train", _shape(mesh), rank, batch=TRAIN[0], seq=TRAIN[1])
    elif kind == "prefill":
        got = dryrun.count(cfg, "prefill", _shape(mesh), rank, batch=PREFILL[0], seq=PREFILL[1])
    else:
        seq = PREFILL[1] + (cfg.vision_tokens if cfg.family == "vlm" else 0) \
            + cfg.num_meta_tokens
        got = dryrun.count(cfg, "decode", _shape(mesh), rank, batch=PREFILL[0], seq=seq)
    return _records(got.records)


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_count_only_records_equal_a_real_run_rank_by_rank(real, arch, mesh, kind):
    for r, rank in enumerate(real):
        want = rank[arch, mesh, kind]
        assert want, (arch, mesh, kind, "a real step with no collective")
        assert _counted(arch, MESHES[mesh], kind, r) == want, (arch, mesh, kind, r)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_every_rank_of_a_production_mesh_counts_alike(kind):
    cfg = get_smoke_config("hymba-1.5b")
    shape = dryrun.PRODUCTION_MESHES["multipod"]
    kw = dict(batch=64, seq=40) if kind != "train" else dict(batch=64, seq=32)
    counts = [dryrun.count(cfg, kind, shape, rank, **kw) for rank in (0, 17, 255, 511)]
    for c in counts[1:]:
        assert _records(c.records) == _records(counts[0].records)
        assert (c.flops, c.bytes_accessed) == (counts[0].flops, counts[0].bytes_accessed)


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-780m", "whisper-large-v3"])
def test_argument_bytes_are_the_rank_s_real_shards(arch, tmp_path, monkeypatch):
    from repro_torch.data.sharded import rank_rows
    from repro_torch.launch.mesh import prompt_batch
    from repro_torch.launch.shardings import shard_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import leaves

    cfg = get_smoke_config(arch)
    monkeypatch.setattr(dryrun, "get_config", lambda a: cfg)
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        dryrun.SHAPES["train_4k"].__class__("train_4k", "train", 32, 64))
    monkeypatch.setitem(dryrun.SHAPES, "prefill_32k",
                        dryrun.SHAPES["prefill_32k"].__class__("prefill_32k", "prefill", 40, 32))
    model = build_model(cfg, device="cpu")
    full = model.init_params(0)
    mesh = pt_mesh.Mesh.view(dryrun.PRODUCTION_MESHES["pod"], 0)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    for shape, mode in (("prefill_32k", "serve"), ("train_4k", "train")):
        got = dryrun.run_cell(arch, shape, "pod", "full", str(tmp_path), num_microbatches=1)
        params = shard_params(full, mesh, mode=mode)
        want = nbytes(leaves(params))
        if mode == "train":
            want += nbytes(leaves(adamw_init(params, AdamWConfig(fp32_master=cfg.fp32_master))))
        spec = dryrun.SHAPES[shape]
        batch = prompt_batch(cfg, spec.global_batch, spec.seq_len)
        batch = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in batch.items()}
        want += nbytes(rank_rows(batch, mesh)[0].values())
        assert got["memory"]["argument_bytes"] == want, (arch, shape)


def test_full_depth_is_the_two_unit_extrapolation():
    import dataclasses

    base = get_smoke_config("yi-9b")
    shape = _shape((2, 2))
    f = {n: dryrun.count(dataclasses.replace(base, num_layers=n), "train", shape, 0,
                         batch=4, seq=32) for n in (1, 2, 5)}
    for key in ("flops", "bytes_accessed"):
        one, two, full = (getattr(f[n], key) for n in (1, 2, 5))
        assert full == one + 4 * (two - one), key
    sums = {n: f[n].summary() for n in (1, 2, 5)}
    for kind in sums[5]:
        for k in ("count", "bytes"):
            one, two = (sums[n].get(kind, {}).get(k, 0) for n in (1, 2))
            assert sums[5][kind][k] == one + 4 * (two - one), (kind, k)


def _visible(s, t, causal, window, prefix):
    """The plain versions' mask, counted: key j visible from row i."""
    i = torch.arange(s)[:, None]
    j = torch.arange(t)[None, :]
    m = torch.ones(s, t, dtype=torch.bool)
    if causal:
        m &= j <= i
    if window:
        m &= (j > i - window) | (j < prefix)
    return int(m.sum())


@pytest.mark.parametrize("s,t,causal,window,prefix", [
    (257, 257, True, 0, 0), (33, 1500, False, 0, 0), (1, 1500, False, 0, 0),
    (300, 300, True, 64, 16), (90, 90, True, 32, 8)])
def test_meta_flash_prefill_counts_its_bound_formula(s, t, causal, window, prefix):
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_prefill import ops

    b, h, g, d = 2, 8, 2, 16
    q = torch.empty(b, s, h, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, t, g, d, dtype=torch.bfloat16, device="meta")
    build.reset_meta()
    launches = ops.flash_prefill.launches
    out, lse = ops.flash_prefill(q, k, k, causal=causal, sliding_window=window,
                                 prefix_len=prefix, return_lse=True)
    assert out.shape == q.shape and out.is_meta and lse.shape == (b, h, s)
    assert ops.flash_prefill.launches == launches
    pairs = _visible(s, t, causal, window, prefix)
    assert build.META_WORK["flops"] == 4 * b * h * d * pairs
    assert build.META_WORK["bytes"] == (2 * b * s * h * d + 2 * b * t * g * d) * 2 + b * h * s * 4
    assert build.META_WORK["calls"] == {"flash_prefill": 1}


def test_meta_paged_attention_and_ssd_scan_count_their_bound_formulas():
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.ssd_scan.ops import KERNEL_CHUNK, ssd_flops, ssd_scan

    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    b, h, g, d, per, bs = 3, 32, 4, 128, 12, 32
    build.reset_meta()
    out, lse = paged_attention(meta(b, h, d, dt=torch.bfloat16),
                               meta(b, per, bs, g, d, dt=torch.bfloat16),
                               meta(b, per, bs, g, d, dt=torch.bfloat16),
                               meta(b, per, dt=torch.int32), meta(b, dt=torch.int32),
                               return_lse=True)
    keys = b * per * bs   # the contexts are not there: every page counts
    assert build.META_WORK["flops"] == 4 * h * d * keys
    assert build.META_WORK["bytes"] == keys * g * d * 2 * 2 + 2 * b * h * d * 2 + b * per * 4 \
        + b * 4 + b * h * 4
    build.reset_meta()
    bb, s, nh, hd, ns = 2, 300, 12, 64, 128
    y, st = ssd_scan(meta(bb, s, nh, hd), meta(bb, s, nh), meta(nh), meta(bb, s, ns),
                     meta(bb, s, ns), meta(nh))
    assert y.shape == (bb, s, nh, hd) and st.shape == (bb, nh, hd, ns)
    total = 0
    for c0 in range(0, s, KERNEL_CHUNK):   # the formula written out once more
        lc = min(KERNEL_CHUNK, s - c0)
        tri = lc * (lc + 1) // 2
        total += 2 * tri * ns + nh * (tri + 2 * tri * hd + 4 * lc * hd * ns)
    assert build.META_WORK["flops"] == bb * total == ssd_flops(bb, s, nh, hd, ns, KERNEL_CHUNK)
    assert build.META_WORK["bytes"] == 2 * bb * s * nh * hd * 4 + bb * s * nh * 4 \
        + 2 * bb * s * ns * 4 + 2 * nh * 4 + bb * nh * hd * ns * 4


REFERENCE_KEYS = {"arch", "shape", "mesh", "depth", "units_total", "model_params",
                  "model_params_active", "lower_s", "compile_s", "flops", "bytes_accessed",
                  "memory", "collectives", "n_devices"}


def test_cli_writes_the_reference_s_files_and_keys(tmp_path):
    failed = dryrun.main(["--arch", "mamba2-780m,yi-9b", "--shape", "decode_32k,long_500k",
                          "--mesh", "pod", "--depth", "1", "--out", str(tmp_path)])
    assert failed == []
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"{a}__{s}__pod__d1.json" for a in ("mamba2-780m", "yi-9b")
                     for s in ("decode_32k", "long_500k")]
    for name in names:
        cell = json.loads((tmp_path / name).read_text())
        reason = jax_skip_reason(jax_config(cell["arch"]), JAX_SHAPES[cell["shape"]])
        if reason:
            assert cell["skipped"] == reason
            continue
        assert REFERENCE_KEYS <= set(cell), name
        assert set(cell["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                       "generated_code_bytes"}
        assert set(cell["collectives"]) == {"bytes_by_kind", "count_by_kind", "wire_bytes",
                                            "wire_bytes_bf16_adjusted"}
        assert cell["n_devices"] == 256 and cell["compile_s"] is None
        assert cell["flops"] > 0 and cell["memory"]["argument_bytes"] > 0
        assert np.isfinite(cell["collectives"]["wire_bytes"])
