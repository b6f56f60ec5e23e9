"""The decode step cut into pieces at its paged attention calls
(``DecoderLM.decode_piece``) and run from static buffers, padded to a
batch bucket (``models.decode_graph.DecodeGraphs``), on the CPU: there
the pieces run eagerly where the card replays their graphs.  The
card's captures are in ``tests/test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.decode_graph import BUCKETS, DecodeGraphs
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import MeshLayout
from repro_torch.models.transformer import DecoderLM, greedy_tokens
from repro_torch.obs.trace import Tracer
from repro_torch.serving.disagg import DisaggService

BF16 = 2e-2   # the port's bf16 tolerance (tests/test_torch_cuda.py)


def smoke(arch, **overrides):
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    model = DecoderLM(cfg, device="cpu")
    return model, model.init_params(seed=0)


def no_drop(arch):
    """``arch``'s smoke config, MoE at capacity_factor E / k (no pair
    dropped, as the benchmark serves granite)."""
    cfg = get_smoke_config(arch)
    return smoke(arch, capacity_factor=cfg.num_experts / cfg.experts_per_token) \
        if cfg.num_experts else smoke(arch)


def prefilled(model, params, b, prompt=40, seed=0):
    toks = torch.randint(0, model.cfg.vocab_size, (b, prompt),
                         generator=torch.Generator().manual_seed(seed + b))
    logits, state = model.prefill(params, {"tokens": toks}, max_blocks_margin=2)
    return state, greedy_tokens(logits, model.cfg.vocab_size)


def copy(state):
    return dataclasses.replace(state, k_pages=state.k_pages.clone(),
                               v_pages=state.v_pages.clone())


def per_layer(model, params, state, tokens):
    """``decode_step``'s per-layer path, the one a mesh or a ring takes."""
    model.paged_decode = lambda st: False
    try:
        return model.decode_step(params, state, tokens)
    finally:
        del model.paged_decode


@pytest.mark.parametrize("b", [1, 3, 5])
@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-3b-a800m"])
def test_pieces_in_order_are_the_decode_step(arch, b):
    """The pieces run in order, each paged attention between two, equal
    ``decode_step`` bit for bit, and ``decode_step`` equals the per-layer
    path it took before the cut: logits, tokens, pages and contexts."""
    model, params = smoke(arch)
    state, tok = prefilled(model, params, b)
    s_p, s_d, s_l = copy(state), copy(state), copy(state)
    layers = list(model._sublayers(params))
    for _ in range(4):
        attend, ctx = model.paged_attend(s_p)
        x, q, k, v = model.decode_piece(params, layers, 0, tok, None, s_p.context_lens)
        for i in range(1, len(layers) + 1):
            out = model.decode_piece(params, layers, i, x, attend(i - 1, q, k, v),
                                     s_p.context_lens, greedy=True)
            if i < len(layers):
                x, q, k, v = out
        logits, nxt = out
        s_p = dataclasses.replace(s_p, context_lens=ctx)
        l_d, s_d = model.decode_step(params, s_d, tok)
        l_l, s_l = per_layer(model, params, s_l, tok)
        assert torch.equal(logits, l_d) and torch.equal(l_d, l_l)
        assert torch.equal(nxt, greedy_tokens(l_d, model.cfg.vocab_size))
        for st in (s_d, s_l):
            assert torch.equal(s_p.k_pages, st.k_pages) and torch.equal(s_p.v_pages, st.v_pages)
            assert torch.equal(s_p.context_lens, st.context_lens)
        tok = nxt


@pytest.mark.parametrize("b,bucket", [(3, 4), (5, 8)])
@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-3b-a800m"])
def test_a_padded_batch_gives_the_same_tokens(arch, b, bucket):
    """b sequences padded to the next bucket (granite at capacity_factor
    E / k): the tokens of ``decode_step`` on the b alone, the logits within
    the port's bf16 tolerance, the pages alike."""
    model, params = no_drop(arch)
    graphs = DecodeGraphs(model, params)
    assert not graphs.exact and graphs.key(b) == bucket
    state, tok = prefilled(model, params, b)
    s_g, s_e, t_g = copy(state), copy(state), tok
    for i in range(6):
        t_g, s_g, mode = graphs.step(s_g, t_g)
        assert mode == ("capture" if i == 0 else "replay")
        logits, s_e = model.decode_step(params, s_e, tok)
        tok = greedy_tokens(logits, model.cfg.vocab_size)
        assert torch.equal(t_g, tok)
        padded = graphs.sets[bucket].outs[-1][0]
        assert padded.shape[0] == bucket
        torch.testing.assert_close(padded[:b].float(), logits.float(), atol=BF16, rtol=BF16)
        torch.testing.assert_close(s_g.k_pages.float(), s_e.k_pages.float(), atol=BF16,
                                   rtol=BF16)
        assert torch.equal(s_g.context_lens, s_e.context_lens)
    assert sorted(graphs.sets) == list(BUCKETS)   # every bucket at the first step


def test_moe_that_can_drop_a_pair_keys_on_the_exact_batch():
    """capacity_factor x k < E (granite's smoke config: 1.25 x 2 < 5): a pad
    row could take a real pair's place, so the graphs are keyed by the
    batch itself, made as batches come, and equal ``decode_step`` bit for
    bit; at capacity_factor E / k the same batch pads to its bucket."""
    model, params = smoke("granite-moe-3b-a800m")
    cfg = model.cfg
    assert cfg.capacity_factor * cfg.experts_per_token < cfg.num_experts
    graphs = DecodeGraphs(model, params)
    assert graphs.exact and [graphs.key(b) for b in (1, 3, 5, 32)] == [1, 3, 5, 32]
    for b in (3, 5):
        state, tok = prefilled(model, params, b)
        s_g, s_e, t_g = copy(state), copy(state), tok
        for _ in range(4):
            t_g, s_g, _ = graphs.step(s_g, t_g)
            logits, s_e = model.decode_step(params, s_e, tok)
            tok = greedy_tokens(logits, cfg.vocab_size)
            assert torch.equal(graphs.sets[b].outs[-1][0], logits)
            assert torch.equal(t_g, tok) and torch.equal(s_g.k_pages, s_e.k_pages)
    assert sorted(graphs.sets) == [3, 5]
    assert DecodeGraphs(*no_drop("granite-moe-3b-a800m")).key(3) == 4


PROMPTS = (40, 64, 23)
ANSWERS = (9, 4, 70)


def serve(model, params, graphs: bool):
    """Three requests joining a running batch one by one and leaving at
    their budgets; the last decodes past its page margin (one block), so
    its state is rebuilt for room as well.  Returns the tokens and the
    decode worker's spans."""
    model.decode_graphs = DecodeGraphs(model, params) if graphs else None
    tracer = Tracer()
    svc = DisaggService(model, params, n_prefill=1, n_decode=1, num_blocks=64, device="cpu",
                        tracer=tracer)
    svc.decode.step_margin_blocks = 1
    handles = []
    for tick in range(400):
        if tick in (0, 2, 5):
            i = len(handles)
            prompt = np.random.default_rng(100 + i).integers(0, model.cfg.vocab_size,
                                                             PROMPTS[i])
            handles.append(svc.submit(prompt.astype(np.int32), max_new=ANSWERS[i],
                                      dispatch="queued"))
        if svc.handles:
            svc.loop.tick()
        elif len(handles) == 3:
            break
    assert all(h.done for h in handles)
    model.decode_graphs = None
    return [list(h.tokens) for h in handles], tracer.spans


@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-3b-a800m"])
def test_the_worker_steps_through_the_pieces_across_joins_leaves_and_rebuilds(arch):
    """``DecodeWorker.step`` through the pieces gives the eager path's tokens
    for every request, across joins, leaves and a rebuild for an exhausted
    margin; its ``step.launch`` spans say ``capture`` once, then
    ``replay``."""
    model, params = no_drop(arch)
    got, spans = serve(model, params, graphs=True)
    want, eager_spans = serve(model, params, graphs=False)
    assert got == want
    assert [len(t) for t in got] == [a + 1 for a in ANSWERS]
    modes = [s.attrs["graph"] for s in spans if s.name == "step.launch"]
    assert modes[0] == "capture" and set(modes[1:]) == {"replay"}
    assert {s.attrs["graph"] for s in eager_spans if s.name == "step.launch"} == {"eager"}
    alone = [s.attrs["per_seq"] for s in spans if s.name == "step.rebuild"
             and s.attrs.get("batch") == 1]
    assert any(b > a for a, b in zip(alone, alone[1:]))   # the margin ran out: it grew


@pytest.mark.parametrize("case", ["sliding_window", "ssm", "hybrid", "mesh_layout",
                                  "over_32"])
def test_what_the_graphs_leave_eager(case):
    """A ring (sliding window), an SSM or hybrid state, a state laid out
    over a mesh, and batches over 32 keep the eager ``decode_step``, with
    its tokens, even with the pieces' runner installed."""
    arch, overrides, b = {"sliding_window": ("yi-9b", {"sliding_window": 16}, 2),
                          "ssm": ("mamba2-780m", {}, 2), "hybrid": ("hymba-1.5b", {}, 2),
                          "mesh_layout": ("yi-9b", {}, 2), "over_32": ("yi-9b", {}, 33)}[case]
    model, params = smoke(arch, **overrides)
    state, tok = prefilled(model, params, b)
    if case == "mesh_layout":
        state = dataclasses.replace(state, layout=MeshLayout(()))
    model.decode_graphs = graphs = DecodeGraphs(model, params)
    assert not graphs.engages(state)
    want = greedy_tokens(model.decode_step(params, _fresh(state), tok)[0], model.cfg.vocab_size)
    got, _, mode = model.decode_greedy(params, _fresh(state), tok,
                                       lambda lg: greedy_tokens(lg, model.cfg.vocab_size))
    assert mode == "eager" and torch.equal(got, want) and not graphs.sets


def _fresh(state):
    """A copy of every tensor of ``state`` (the steps write in place)."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def test_the_layerwise_first_step_and_encoder_decoder_stay_eager():
    """``consume="layerwise"``: the first step, which streams its KV layer
    by layer, runs ``decode_step_layerwise`` eagerly (its span says so);
    ``EncDecLM`` has no graph path at all."""
    model, params = no_drop("yi-9b")
    model.decode_graphs = DecodeGraphs(model, params)
    tracer = Tracer()
    svc = DisaggService(model, params, n_prefill=1, n_decode=1, num_blocks=64, device="cpu",
                        consume="layerwise", tracer=tracer)
    svc.submit(np.arange(40, dtype=np.int32), max_new=5)
    svc.admit_queued()                # the pull submitted, not yet run
    assert svc.decode.inflight
    for _ in range(3):
        svc.decode.step()
    modes = [s.attrs["graph"] for s in tracer.spans if s.name == "step.launch"]
    assert modes == ["eager", "capture", "replay"]
    whisper = build_model(get_smoke_config("whisper-large-v3"), device="cpu")
    assert not hasattr(whisper, "decode_greedy")
