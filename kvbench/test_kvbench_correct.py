"""CPU tests of what decides ``correct``: the plain reference against the
program at small widths, and whole runs of the harness (the look for a card
skipped, everything else as on the card) that must come out correct when
the program is sound, and not correct with the float8 control in its place
or with a fault planted on the timed path.

The runs use small widths on the CPU, where the widest logit gap of sound
runs and of the control differ from the card's: each run here is judged
against a limit of this size of its own (``LIMIT``), set from readings
taken here (PERF.md gives them), not the cell's."""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from kvbench.bench import load_benchmark, load_cell, reference_module
from kvbench.serve import RUN_FIELDS, import_program, run_cell
from kvbench.weights import make_weights

import_program()

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402

REF = reference_module("decoder")
# A test size a CPU run holds, one a configuration's family.
SIZES = {
    "yi-9b": ModelConfig(name="yi-test", family="dense", num_layers=2, d_model=128, num_heads=4,
                         num_kv_heads=1, d_ff=256, vocab_size=1024),
    "granite-moe-3b-a800m": ModelConfig(
        name="granite-test", family="moe", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=64, vocab_size=1024, num_experts=40, experts_per_token=8,
        capacity_factor=5.0),
}
# Limits at these sizes, from CPU readings of these very runs (seeds 100-111,
# PERF.md): dense, the widest gap of sound runs at most 0.0081 and of the
# float8 control at least 0.0762; MoE, where bf16 rounding flips an expert
# now and then and the widest gap does not separate, the mean gap of sound
# runs at most 0.0017 and of the control at least 0.0065.
LIMIT = {"yi-9b": {"max_logit_gap": 0.03}, "granite-moe-3b-a800m": {"mean_logit_gap": 0.004}}
CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the runs' tensors are small, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(cell_name):
    """The cell at a test size, its drain waiting for every window
    request's last token (as a ``ttlt_`` metric makes it), so that the
    sample does not depend on how fast a busy CPU runs."""
    cell = load_cell(cell_name)
    arch = cell.config["run"]["arch"]
    cell.cell = dict(cell.cell, rate=6.0, lead_s=1.0, drain_max_s=600,
                     correct=dict(sample_tokens=96, limits=LIMIT[arch]))
    cell.end_to_end = cell.end_to_end + [{"name": "ttlt_p50_s", "unit": "s"}]
    cell.traffic = dict(cell.traffic, prompt=dict(mean=96, sigma=0.6, min=32, max=256),
                        output=dict(mean=12, sigma=0.6, min=4, max=32))
    return cell, SIZES[arch]


def _run(cell_name, seed=2147483659, control=False, own_limits=False):
    cell, size = _small(cell_name)
    if own_limits:  # the limits the cell holds runs on the card to
        cell.cell["correct"] = dict(cell.cell["correct"],
                                    limits=load_cell(cell_name).cell["correct"]["limits"])
    return run_cell(cell, seed=seed, seconds=2.0, trace=False, t_start=time.perf_counter(),
                    device="cpu", model_cfg=size, control=control, log=lambda m: None)


@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-3b-a800m"])
def test_reference_matches_the_program_in_float32(arch):
    """Prefill, then ten decode steps of a batch of three, through the
    program's model in float32 against the reference's full forward."""
    cfg = get_smoke_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    model = DecoderLM(cfg, device="cpu")
    w = make_weights(model.param_shapes(), seed=5, device="cpu", d_model=cfg.d_model,
                     dtype=torch.float32)
    m = {k: getattr(cfg, k) for k in RUN_FIELDS}
    toks = torch.randint(0, cfg.vocab_size, (3, 50), generator=torch.Generator().manual_seed(1))
    logits, state = model.prefill(w, {"tokens": toks}, max_blocks_margin=1, remat=False)
    seqs = toks.tolist()
    for _ in range(10):
        nxt = logits[:, : cfg.vocab_size].argmax(-1)
        for s, t in zip(seqs, nxt.tolist()):
            s.append(t)
        logits, state = model.decode_step(w, state, nxt.to(torch.int32))
    for i, s in enumerate(seqs):
        ref = REF.logits(w, m, torch.tensor(s), torch.tensor([len(s) - 1]))
        assert torch.allclose(logits[i, : cfg.vocab_size], ref[0], atol=1e-4, rtol=0)


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
    assert any(got[k] > v for k, v in _small(cell)[0].cell["correct"]["limits"].items()), got


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
