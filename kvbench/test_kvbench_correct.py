"""CPU tests of what decides ``correct``: the plain reference against the
program at small widths, and whole runs of the harness (the look for a card
skipped, everything else as on the card) that must come out correct when
the program is sound, and not correct with the float8 control in its place
or with a fault planted on the timed path.

The runs use small widths on the CPU, where the widest logit gap of sound
runs and of the control differ from the card's: each run here is judged
against limits of this size of its own, set from readings taken here, not
the cell's.  Each configuration file's ``test`` block holds that size
(``size``, ``ModelConfig`` keywords), its ``limits`` and the ``readings``
they were set from, so that a new configuration is taken as new files."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import time

import pytest
import torch

from kvbench import serve
from kvbench.bench import ROOT, load_benchmark, load_cell, load_config, metric_reader, \
    reference_module
from kvbench.flops import for_run
from kvbench.records import PEAKS, Run
from kvbench.serve import RUN_FIELDS, Program, cpu_config, import_program, program_config, \
    run_cell, run_dims
from kvbench.weights import make_weights

import_program()

from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.models.whisper import EncDecLM  # noqa: E402

BENCH = load_benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the runs' tensors are small, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(cell_name, root=ROOT):
    """The cell at its configuration's test size and limits, its drain
    waiting for every window request's last token (as a ``ttlt_`` metric
    makes it), so that the sample does not depend on how fast a busy CPU
    runs."""
    cell = load_cell(cell_name, root)
    cell.cell = dict(cell.cell, rate=6.0, lead_s=1.0, drain_max_s=600,
                     correct=dict(sample_tokens=96, limits=cell.config["test"]["limits"]))
    cell.end_to_end = cell.end_to_end + [{"name": "ttlt_p50_s", "unit": "s"}]
    cell.traffic = dict(cell.traffic, prompt=dict(mean=96, sigma=0.6, min=32, max=256),
                        output=dict(mean=12, sigma=0.6, min=4, max=32))
    return cell, cpu_config(cell.config)


def _run(cell_name, seed=2147483659, control=False, own_limits=False, root=ROOT, trace=False):
    cell, size = _small(cell_name, root)
    if own_limits:  # the limits the cell holds runs on the card to
        cell.cell["correct"] = dict(cell.cell["correct"],
                                    limits=load_cell(cell_name, root).cell["correct"]["limits"])
    return run_cell(cell, seed=seed, seconds=2.0, trace=trace, t_start=time.perf_counter(),
                    device="cpu", model_cfg=size, control=control, log=lambda m: None)


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_matches_the_program_in_float32(config):
    """Prefill, then ten decode steps of a batch of three, through the
    program's model in float32 at the configuration's test size against
    the reference its file names, over the full forward."""
    _float32_agreement(load_config(config))


def _float32_agreement(conf, root=ROOT):
    cfg = cpu_config(conf)
    ref = reference_module(conf["reference"], root)
    model = DecoderLM(cfg, device="cpu")
    w = make_weights(model.param_shapes(), seed=5, device="cpu", d_model=cfg.d_model,
                     dtype=torch.float32, rule=getattr(ref, "weight_rule", None))
    m = run_dims(conf["run"], cfg)
    toks = torch.randint(0, cfg.vocab_size, (3, 50), generator=torch.Generator().manual_seed(1))
    logits, state = model.prefill(w, {"tokens": toks}, max_blocks_margin=1, remat=False)
    seqs = toks.tolist()
    for _ in range(10):
        nxt = logits[:, : cfg.vocab_size].argmax(-1)
        for s, t in zip(seqs, nxt.tolist()):
            s.append(t)
        logits, state = model.decode_step(w, state, nxt.to(torch.int32))
    for i, s in enumerate(seqs):
        want = ref.logits(w, m, torch.tensor(s), torch.tensor([len(s) - 1]))
        assert torch.allclose(logits[i, : cfg.vocab_size], want[0], atol=1e-4, rtol=0)


@pytest.mark.parametrize("cell", ["yi9b.chat", "granite-moe.chat"])
def test_m_of_the_first_cells_is_their_run_fields(cell):
    """The two cells' run blocks state ``RUN_FIELDS`` alone, so what the
    metrics and the reference read is the dict of those fields, at the
    published size and at the test size."""
    c = load_cell(cell)
    full = program_config(c.config)
    assert run_dims(c.config["run"], full) == {k: getattr(full, k) for k in RUN_FIELDS}
    size = cpu_config(c.config)
    prog = Program.build(c, seed=3, device="cpu", model_cfg=size)
    assert prog.m == {k: getattr(size, k) for k in RUN_FIELDS}


def _parent_weights(layout, *, seed, device, d_model, dtype=None):
    """``make_weights`` as it drew before the SSM, shared-expert, bias and
    table rules: the same generator, order and calls."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def scale(path, shape):
        if path[-1] == "scale":
            return None
        if path[-1] == "table" or path[-2:] == ("router", "w"):
            return 0.02
        if len(path) >= 2 and path[-2] == "moe":
            return d_model ** -0.5
        if path[-1] == "w" and path[-3] in ("attn", "mlp"):
            return shape[-2] ** -0.5
        raise KeyError(path)

    def fill(node, path):
        if isinstance(node, dict):
            return {k: fill(v, path + (k,)) for k, v in node.items()}
        dt = dtype or node.dtype
        sc = scale(path, node.shape)
        if sc is None:
            return torch.ones(node.shape, dtype=dt, device=device)
        return torch.randn(node.shape, generator=gen, dtype=dt, device=device).mul_(sc)
    return fill(layout, ())


@pytest.mark.parametrize("dtype", [None, torch.float32], ids=["served", "float32"])
@pytest.mark.parametrize("cell", ["granite-moe.chat", "yi9b.chat"])
def test_the_first_cells_weights_are_drawn_as_before(cell, dtype):
    """The program's weights of the two first cells at a seed, built as a
    run builds them (their reference defines no rule), are bit for bit what
    the rules before the SSM and shared-expert leaves drew."""
    c = load_cell(cell)
    size = cpu_config(c.config)
    prog = Program.build(c, seed=2147483659, device="cpu", model_cfg=size, dtype=dtype)
    want = _parent_weights(prog.model.param_shapes(), seed=2147483659, device="cpu",
                           d_model=size.d_model, dtype=dtype)
    got, exp = _leaves(prog.weights), _leaves(want)
    assert len(got) == len(exp) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, exp))


# prefill_flops at prompts 1, 70, 1024, 4096 and decode_token_flops at keys
# 1, 285, 1792 of the two first configurations' run blocks, as the formulas
# read before a reference could state its own
FIRST_FLOPS = {
    "yi-9b": ((17134518272, 1165139640320, 17421314293760, 74631486636032),
              (17134518272, 17357864960, 18543017984)),
    "granite-moe-3b-a800m": ((1765745664, 113657717760, 1756624856064, 8262996993024),
                             (1765745664, 1821582336, 2117870592)),
}


@pytest.mark.parametrize("config", sorted(FIRST_FLOPS))
def test_the_first_configurations_flop_counts_are_as_before(config):
    """The counts the MFU readers take for the two first configurations
    (their reference defines none: ``kvbench/flops.py``'s) at their run
    blocks."""
    conf = load_config(config)
    run = Run("t", 0.0, 1.0, 1.0, 0.0, [], run_dims(conf["run"], program_config(conf)),
              reference=reference_module(conf["reference"]))
    pre, dec = for_run(run)
    want_pre, want_dec = FIRST_FLOPS[config]
    assert tuple(pre(run.model, p) for p in (1, 70, 1024, 4096)) == want_pre
    assert tuple(dec(run.model, k) for k in (1, 285, 1792)) == want_dec


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_arch_fills_at_its_smoke_size(arch):
    """``make_weights``'s defaults cover every leaf the program's models
    hold, in the layout's shapes and dtypes; the SSM's leaves lie in
    Mamba-2's ranges: softplus(dt_bias) in [1e-4, 1e-1], -exp(a_log) in
    [-16, -1], d_skip 1, the convolution within K^-1/2."""
    cfg = get_smoke_config(arch)
    model = (EncDecLM if cfg.is_encoder_decoder else DecoderLM)(cfg, device="cpu")
    layout = model.param_shapes()
    w = make_weights(layout, seed=2147483659, device="cpu", d_model=cfg.d_model)
    for got, meta in zip(_leaves(w), _leaves(layout)):
        assert got.shape == meta.shape and got.dtype == meta.dtype and got.isfinite().all()
    ssm = w.get("layers", {}).get("ssm")
    assert (ssm is not None) == cfg.has_ssm
    if ssm is not None:
        dt = torch.nn.functional.softplus(ssm["dt_bias"])
        assert dt.min() >= 1e-4 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
        a = -torch.exp(ssm["a_log"])
        assert a.min() >= -16 * (1 + 1e-6) and a.max() <= -1
        assert torch.equal(ssm["d_skip"], torch.ones_like(ssm["d_skip"]))
        bound = ssm["conv_w"].shape[-2] ** -0.5
        for k in ("conv_w", "conv_b"):
            assert ssm[k].float().abs().max() <= bound and ssm[k].float().std() > bound / 4
    if cfg.num_meta_tokens:
        assert w["meta"].float().std().item() == pytest.approx(0.02, rel=0.3)


def test_a_run_block_list_is_held_to_the_programs_tuple(monkeypatch):
    """A field the program holds as a tuple is compared with the JSON list
    the file states, element by element, and reaches ``m`` as the tuple."""
    import repro_torch.configs

    layered = dataclasses.make_dataclass(
        "Layered", [(k, int, 1) for k in RUN_FIELDS]
        + [("layer_kinds", tuple, ("window", "window", "full"))], frozen=True)
    monkeypatch.setattr(repro_torch.configs, "get_config", lambda arch: layered())
    run = {"arch": "layered", "overrides": {}, **{k: 1 for k in RUN_FIELDS},
           "layer_kinds": ["window", "window", "full"]}
    cfg = program_config({"run": run})
    assert run_dims(run, cfg)["layer_kinds"] == ("window", "window", "full")
    with pytest.raises(ValueError, match="layer_kinds"):
        program_config({"run": dict(run, layer_kinds=["window", "full", "window"])})
    with pytest.raises(ValueError, match="does not state"):
        program_config({"run": {k: v for k, v in run.items() if k != "d_model"}})


def _hashes(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _edit(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, old
    return src.replace(old, new)


def _windowed(kv):
    """Yi-9B stating one more ``ModelConfig`` field (``sliding_window``) in
    its run block and test size, and a reference that needs that field in
    what it reads."""
    conf = load_config("yi-9b")
    conf["run"]["sliding_window"] = 0
    conf["test"]["size"]["sliding_window"] = 0
    conf["reference"] = "decoder_windowed"
    src = (kv / "reference" / "decoder.py").read_text()
    body = '    prev = (torch.backends.cuda.matmul.allow_tf32'
    (kv / "reference" / "decoder_windowed.py").write_text(_edit(
        src, body, '    assert m["sliding_window"] == 0, sorted(m)\n' + body))
    return "yi-9b-windowed", conf, "yi9b-windowed.chat", "yi9b.chat"


# The interleaved configuration's reference: decoder.py with a dense layer
# before each MoE layer (``moe_every``, the dense width ``d_ff_dense``) and
# an always-on shared expert in each MoE layer, its own weight rule for the
# shared expert (a plain MLP's, N(0, in^-1/2)) and its own FLOP counts.
INTERLEAVED_LOOP = (
    '        for li in range(m["num_layers"]):\n'
    '            every = m["moe_every"]\n'
    '            lay, i = weights["layers"][f"sub{li % every}"], li // every\n')
INTERLEAVED_MOE = (
    '            if li % every == every - 1:\n'
    '                x = x + _moe(a, lay["moe"], i, m, fp8)\n'
    '                sh = lay["moe"]["shared"]\n'
    '                x = x + _swiglu(a, sh["gate"]["w"][i], sh["up"]["w"][i],\n'
    '                                sh["down"]["w"][i], fp8)\n')
INTERLEAVED_OWN = '''

def weight_rule(leaf):
    """The shared expert as a plain MLP: N(0, in^-1/2)."""
    if "shared" in leaf.path:
        return leaf.normal(leaf.shape[-2] ** -0.5)
    return None


def _per_token(m):
    d, hd, g, n = m["d_model"], m["head_dim"], m["moe_every"], m["num_layers"]
    attn = 2 * d * m["num_heads"] * hd + 2 * d * m["num_kv_heads"] * hd
    moe = d * m["num_experts"] + (m["experts_per_token"] + 1) * 3 * d * m["d_ff"]
    return n * attn + n // g * moe + (n - n // g) * 3 * d * m["d_ff_dense"]


def _pairs(m, pairs):
    return m["num_layers"] * 4 * m["num_heads"] * m["head_dim"] * pairs


def prefill_flops(m, prompt):
    return (2 * prompt * _per_token(m) + 2 * m["d_model"] * m["vocab_size"]
            + _pairs(m, prompt * (prompt + 1) // 2))


def decode_token_flops(m, keys):
    return 2 * (_per_token(m) + m["d_model"] * m["vocab_size"]) + _pairs(m, keys)
'''


def _interleaved(kv):
    """granite-moe with layers of two kinds (a dense SwiGLU of width
    ``d_ff_dense``, then MoE) and a shared expert, stated in the run block
    and the test size, with a reference of its own (``INTERLEAVED_*``)."""
    conf = load_config("granite-moe-3b-a800m")
    extra = {"moe_every": 2, "moe_shared_expert": True, "d_ff_dense": 1024}
    conf["run"]["overrides"].update(extra)
    conf["run"].update(extra)
    # one kv group at the CPU size, so that no name of the reference can stand
    # for both it and moe_every
    conf["test"]["size"].update(extra, num_layers=4, d_ff_dense=128, num_kv_heads=1)
    conf["reference"] = "decoder_interleaved"
    src = (kv / "reference" / "decoder.py").read_text()
    src = _edit(src, '        for i in range(m["num_layers"]):\n', INTERLEAVED_LOOP)
    src = _edit(src, '            if m["num_experts"]:\n'
                '                x = x + _moe(a, lay["moe"], i, m, fp8)\n', INTERLEAVED_MOE)
    (kv / "reference" / "decoder_interleaved.py").write_text(src + INTERLEAVED_OWN)
    return "granite-moe-interleaved", conf, "granite-interleaved.chat", "granite-moe.chat"


def _windowed_checks(cell, size, prog, out, captured):
    assert program_config(cell.config).sliding_window == 0     # Program.build's check
    for key, wrong in (("sliding_window", 1024), ("window_pattern", [3, 1])):
        bad = dict(cell.config, run=dict(cell.config["run"], **{key: wrong}))
        with pytest.raises(ValueError, match=key):
            program_config(bad)
    assert size.sliding_window == 0 and size.d_model == 128
    assert prog.m == {**{k: getattr(size, k) for k in RUN_FIELDS}, "sliding_window": 0}


def _interleaved_checks(cell, size, prog, out, captured):
    """The program holds two kinds of layer and a shared expert; the
    reference's weight rule draws the shared expert and nothing else; the
    MFU readers take the reference's counts."""
    full = program_config(cell.config)
    assert (full.moe_every, full.moe_shared_expert, full.d_ff_dense) == (2, True, 1024)
    with pytest.raises(ValueError, match="d_ff_dense"):
        program_config(dict(cell.config, run=dict(cell.config["run"], d_ff_dense=512)))
    assert prog.m["moe_every"] == 2 and prog.m["d_ff_dense"] == 128
    _float32_agreement(cell.config, cell.root)
    plain = make_weights(prog.model.param_shapes(), seed=3, device="cpu", d_model=size.d_model)
    layers, plain_layers = prog.weights["layers"], plain["layers"]
    assert sorted(layers) == ["sub0", "sub1"] and "moe" not in layers["sub0"]
    for name in ("gate", "up", "down"):
        got = layers["sub1"]["moe"]["shared"][name]["w"]
        # the defaults' expert scale is d_model^-1/2: the same for gate and up
        same = torch.equal(got, plain_layers["sub1"]["moe"]["shared"][name]["w"])
        assert same == (got.shape[-2] == size.d_model), name
        assert got.float().std().item() == pytest.approx(got.shape[-2] ** -0.5, rel=0.05)
    rest = [_leaves({k: v for k, v in w.items() if k != "shared"})
            for w in (layers["sub1"]["moe"], plain_layers["sub1"]["moe"])]
    rest += [_leaves(layers["sub0"]), _leaves(plain_layers["sub0"])]
    assert all(torch.equal(x, y) for x, y in zip(rest[0] + rest[2], rest[1] + rest[3]))

    run = captured["run"]
    pre, dec = for_run(run)
    assert pre is run.reference.prefill_flops and dec is run.reference.decode_token_flops
    prompts = [r.prompt_len for r in run.due_in_window()
               if run.lifecycle().get(r.rid, {}).get("prefill")]
    secs = sum(s.t1 - s.t0 for r in run.due_in_window()
               for s in run.lifecycle().get(r.rid, {}).get("prefill", ()))
    assert prompts and out["metrics"]["prefill_mfu"]["value"] == pytest.approx(
        100.0 * sum(pre(run.model, p) for p in prompts) / (secs * PEAKS["bf16_flops"]))
    plain_run = dataclasses.replace(run, reference=None)
    for name in ("prefill_mfu", "decode_mfu"):
        assert metric_reader(name).read(plain_run) != out["metrics"][name]["value"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


NEW_CONFIGS = {"windowed": (_windowed, _windowed_checks, False),
               "interleaved": (_interleaved, _interleaved_checks, True)}


@pytest.mark.parametrize("case", sorted(NEW_CONFIGS))
def test_a_new_configuration_is_taken_without_an_edit(case, tmp_path, monkeypatch):
    """A configuration, a reference of its own, a cell, and their entries in
    ``BENCHMARK.json``, added as new files to a copy: the harness finds them
    by name, holds the program to every field the run block states, hands
    them to the reference, gives the cell every per-layer metric without a
    ``workloads`` list, and the run comes out correct; no file that was in
    the copy changes.  ``windowed``: one more ``ModelConfig`` field;
    ``interleaved``: layers of two kinds and a shared expert, with the
    reference's own weight rule and FLOP counts (a traced run)."""
    write, checks, trace = NEW_CONFIGS[case]
    kv = tmp_path / "kvbench"
    shutil.copytree(ROOT / "kvbench", kv, ignore=shutil.ignore_patterns("__pycache__"))
    before = _hashes(kv)
    config_name, conf, cell_name, like = write(kv)
    (kv / "configs" / f"{config_name}.json").write_text(json.dumps(conf))
    (kv / "cells" / f"{cell_name}.json").write_text((kv / "cells" / f"{like}.json").read_text())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": config_name, "source": "test", "reduced": [],
                             "file": f"kvbench/configs/{config_name}.json", "why": "test"})
    bench["workloads"].append({"name": cell_name, "config": config_name,
                               "traffic": "chat", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell(cell_name, tmp_path)
    assert cell.config["reference"] == conf["reference"]
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in bench["per_layer"] if "workloads" not in m]
    size = cpu_config(cell.config)
    prog = Program.build(cell, seed=3, device="cpu", model_cfg=size)
    captured = {}

    def keep(*a, **k):
        captured["run"] = run = Run(*a, **k)
        return run
    monkeypatch.setattr(serve, "Run", keep)
    out = _run(cell_name, root=tmp_path, trace=trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["compared"]
    assert set(out["compared"]) == set(conf["test"]["limits"])
    checks(cell, size, prog, out, captured)
    after = _hashes(kv)
    assert {k: after[k] for k in before} == before
    assert sorted(set(after) - set(before)) == sorted([
        f"cells/{cell_name}.json", f"configs/{config_name}.json",
        f"reference/{conf['reference']}.py"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_is_not_correct(cell):
    """The reference in float8 in the program's place reads past the limit
    on the same sample."""
    out = _run(cell, control=True)
    got = out["readings"]["control"]
    assert any(got[k] > v for k, v in load_cell(cell).config["test"]["limits"].items()), got


def _token_altered(mp):
    from repro_torch.serving.engine import DecodeWorker

    orig = DecodeWorker._argmax_tokens

    def altered(self, logits):
        return (orig(self, logits) + 1) % self.model.cfg.vocab_size
    mp.setattr(DecodeWorker, "_argmax_tokens", altered)


def _pull_left_out(mp):
    import repro_torch.core.transfer_engine as te

    mp.setattr(te, "kv_pull", lambda src, dst, sid, did: dst)


def _state_unchanged(mp):
    orig = DecoderLM.decode_step

    def step(self, params, state, tokens):
        logits, _ = orig(self, params, state, tokens)
        return logits, state
    mp.setattr(DecoderLM, "decode_step", step)


def _half_batch(mp):
    orig = DecoderLM.decode_step

    def step(self, params, state, tokens):
        logits, new = orig(self, params, state, tokens)
        b = logits.shape[0]
        if b > 1:
            logits = logits.clone()
            logits[b // 2:] = logits[: b - b // 2].clone()
        return logits, new
    mp.setattr(DecoderLM, "decode_step", step)


FAULTS = {"token_altered": _token_altered, "pull_left_out": _pull_left_out,
          "state_unchanged": _state_unchanged, "half_batch": _half_batch}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_on_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["compared"]
    assert all(c["value"] is not None for c in out["compared"].values())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_fails_the_cells_own_limits(cell, fault, monkeypatch):
    """The numbers a cell compares on the card, at its own limits, catch
    each planted fault at the test size too (granite's ``big_gap_share``
    and ``max_logit_gap``, not the mean gap the sound runs here are held
    to)."""
    FAULTS[fault](monkeypatch)
    out = _run(cell, own_limits=True)
    assert not out["correct"], out["compared"]
