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

from kvbench.bench import ROOT, load_benchmark, load_cell, load_config, reference_module
from kvbench.serve import RUN_FIELDS, Program, cpu_config, import_program, program_config, \
    run_cell, run_dims
from kvbench.weights import make_weights

import_program()

from repro_torch.models.transformer import DecoderLM  # noqa: E402

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


def _run(cell_name, seed=2147483659, control=False, own_limits=False, root=ROOT):
    cell, size = _small(cell_name, root)
    if own_limits:  # the limits the cell holds runs on the card to
        cell.cell["correct"] = dict(cell.cell["correct"],
                                    limits=load_cell(cell_name, root).cell["correct"]["limits"])
    return run_cell(cell, seed=seed, seconds=2.0, trace=False, t_start=time.perf_counter(),
                    device="cpu", model_cfg=size, control=control, log=lambda m: None)


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_matches_the_program_in_float32(config):
    """Prefill, then ten decode steps of a batch of three, through the
    program's model in float32 at the configuration's test size against
    the reference its file names, over the full forward."""
    conf = load_config(config)
    cfg = cpu_config(conf)
    ref = reference_module(conf["reference"])
    model = DecoderLM(cfg, device="cpu")
    w = make_weights(model.param_shapes(), seed=5, device="cpu", d_model=cfg.d_model,
                     dtype=torch.float32)
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


def test_a_new_configuration_is_taken_without_an_edit(tmp_path):
    """A configuration whose run block and test size state one more
    ``ModelConfig`` field (``sliding_window``), a reference that needs that
    field in what it reads, a cell, and their entries in ``BENCHMARK.json``,
    added as new files to a copy: the harness finds them by name, holds the
    program to the new field, hands it to the reference, and the run comes
    out correct; no file that was in the copy changes."""
    kv = tmp_path / "kvbench"
    shutil.copytree(ROOT / "kvbench", kv, ignore=shutil.ignore_patterns("__pycache__"))
    before = _hashes(kv)
    conf = load_config("yi-9b")
    conf["run"]["sliding_window"] = 0
    conf["test"]["size"]["sliding_window"] = 0
    conf["reference"] = "decoder_windowed"
    (kv / "configs" / "yi-9b-windowed.json").write_text(json.dumps(conf))
    src = (kv / "reference" / "decoder.py").read_text()
    body = '    prev = (torch.backends.cuda.matmul.allow_tf32'
    assert src.count(body) == 1
    (kv / "reference" / "decoder_windowed.py").write_text(src.replace(
        body, '    assert m["sliding_window"] == 0, sorted(m)\n' + body))
    (kv / "cells" / "yi9b-windowed.chat.json").write_text(
        (kv / "cells" / "yi9b.chat.json").read_text())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "yi-9b-windowed", "source": "test", "reduced": [],
                             "file": "kvbench/configs/yi-9b-windowed.json", "why": "test"})
    bench["workloads"].append({"name": "yi9b-windowed.chat", "config": "yi-9b-windowed",
                               "traffic": "chat", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("yi9b-windowed.chat", tmp_path)
    assert cell.config["reference"] == "decoder_windowed"
    assert program_config(cell.config).sliding_window == 0     # Program.build's check
    for key, wrong in (("sliding_window", 1024), ("window_pattern", [3, 1])):
        bad = dict(cell.config, run=dict(cell.config["run"], **{key: wrong}))
        with pytest.raises(ValueError, match=key):
            program_config(bad)
    size = cpu_config(cell.config)
    assert size.sliding_window == 0 and size.d_model == 128
    prog = Program.build(cell, seed=3, device="cpu", model_cfg=size)
    assert prog.m == {**{k: getattr(size, k) for k in RUN_FIELDS}, "sliding_window": 0}
    out = _run("yi9b-windowed.chat", root=tmp_path)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["compared"]
    assert set(out["compared"]) == set(conf["test"]["limits"])
    after = _hashes(kv)
    assert {k: after[k] for k in before} == before
    assert sorted(set(after) - set(before)) == [
        "cells/yi9b-windowed.chat.json", "configs/yi-9b-windowed.json",
        "reference/decoder_windowed.py"]


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
