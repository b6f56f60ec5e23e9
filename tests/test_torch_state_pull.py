"""SSM state transfer in the port against the JAX package on the CPU.

* the port's ``SlotCache`` exports the same ``TensorDesc``s as the numpy
  one, field for field, registers one slot as its page and allocates on
  the device it is given;
* tests/test_pull_push.py's ``TestStatePull`` replayed on the port: one
  transaction per layer, the same bytes as the numpy engine lands;
* the slot format (``models.ssm.pack_ssm_slot``/``unpack_ssm_slots``)
  round-trips a state exactly, and ``stack_states`` batches states;
* mamba2 (smoke) disaggregated through f32 slots, ``pull_state`` and the
  decode side rebuilding its state gives the port's monolithic tokens and
  the JAX package's;
* the serving workers refuse SSM and sliding-window archs as the
  reference's do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.connection import ChipInfo as NpChipInfo
from repro.core.connection import ConnectionManager as NpConnectionManager
from repro.core.connection import DescriptorRegistry as NpRegistry
from repro.core.connection import WorkerInfo as NpWorkerInfo
from repro.core.pull_push import pull_state as np_pull_state
from repro.core.transfer_engine import TransferEngine as NpEngine
from repro.models.transformer import DecoderLM as JaxDecoderLM
from repro.serving.disagg import DisaggService as JaxService
from repro.serving.kv_cache import SlotCache as NpSlotCache
from repro.serving.request import Request as NpRequest
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.core.connection import ChipInfo, ConnectionManager, DescriptorRegistry, WorkerInfo
from repro_torch.core.pull_push import pull_state
from repro_torch.core.transfer_engine import TransferEngine
from repro_torch.launch import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.registry import build_model
from repro_torch.models.ssm import pack_ssm_slot, ssm_slot_elems, unpack_ssm_slots
from repro_torch.models.transformer import DecodeState, stack_states
from repro_torch.serving.disagg import DisaggService
from repro_torch.serving.engine import PrefillWorker
from repro_torch.serving.kv_cache import SlotCache
from repro_torch.serving.request import Request

@pytest.mark.parametrize("dims,dtype", [
    (dict(num_layers=4, num_slots=8, state_elems=2048), "bfloat16"),
    (dict(num_layers=3, num_slots=2, state_elems=403200), "float32"),  # mamba2-780m slot
])
def test_slot_cache_descs_equal_numpy_cache(dims, dtype):
    np_cache = NpSlotCache("w0", base_address=0x3000_0000, dtype=getattr(jnp, dtype), **dims)
    pt_cache = SlotCache("w0", base_address=0x3000_0000, dtype=getattr(torch, dtype),
                         device="cpu", **dims)
    assert [dataclasses.astuple(d) for d in pt_cache.descriptors()] == \
        [dataclasses.astuple(d) for d in np_cache.descriptors()]
    region = pt_cache.memory_region()
    assert region.page_nbytes == dims["state_elems"] * pt_cache.itemsize  # one slot
    assert region.buffer.numel() == np_cache.memory_region().buffer.nbytes
    assert region.buffer.dtype == torch.uint8 and region.buffer.device.type == "cpu"


def test_slot_cache_allocates_on_its_device():
    cache = SlotCache("w0", num_layers=2, num_slots=3, state_elems=64, dtype=torch.float32,
                      device="meta")
    assert cache.memory_region().buffer.device.type == "meta"
    assert SlotCache("w0", num_layers=1, num_slots=1, state_elems=8).device.type == "cpu"


def _np_pair():
    pre = NpSlotCache("p0", num_layers=4, num_slots=8, state_elems=2048,
                      base_address=0x3000_0000)
    dec = NpSlotCache("d0", num_layers=4, num_slots=8, state_elems=2048,
                      base_address=0x4000_0000)
    eng = NpEngine()
    eng.register_memory(pre.memory_region())
    eng.register_memory(dec.memory_region())
    reg = NpRegistry("p0")
    for d in pre.descriptors():
        reg.register(d)

    def info(wid, role):
        return NpWorkerInfo(wid, role, "10.0.0.1", (NpChipInfo(0, f"ici://{wid}/0"),))
    return pre, dec, eng, NpConnectionManager(info("d0", "decode")).connect(
        info("p0", "prefill"), reg)


def _pt_pair(**dims):
    dims = dict(num_layers=4, num_slots=8, state_elems=2048, device="cpu") | dims
    pre = SlotCache("p0", base_address=0x3000_0000, **dims)
    dec = SlotCache("d0", base_address=0x4000_0000, **dims)
    eng = TransferEngine()
    eng.register_memory(pre.memory_region())
    eng.register_memory(dec.memory_region())
    reg = DescriptorRegistry("p0")
    for d in pre.descriptors():
        reg.register(d)

    def info(wid, role):
        return WorkerInfo(wid, role, "10.0.0.1", (ChipInfo(0, f"ici://{wid}/0"),))
    return pre, dec, eng, ConnectionManager(info("d0", "decode")).connect(
        info("p0", "prefill"), reg)


def test_state_pull_replay_matches_numpy_engine():
    """tests/test_pull_push.py::TestStatePull on both packages: exactly one
    transaction per layer, the same bytes landed in the same slot."""
    rng = np.random.default_rng(7)
    states = [rng.standard_normal(2048).astype(np.float32) for _ in range(4)]
    np_pre, np_dec, np_eng, np_conn = _np_pair()
    pre, dec, eng, conn = _pt_pair()
    for layer, s in enumerate(states):
        np_pre.write_slot(layer, 5, s)
        pre.write_slot(layer, 5, torch.from_numpy(s))
    np_stats = np_pull_state(NpRequest("r1", prompt_len=128, max_new_tokens=4),
                             conn=np_conn, engine=np_eng, decode_cache=np_dec,
                             remote_slot=5, local_slot=2)
    stats = pull_state(Request("r1", prompt_len=128, max_new_tokens=4), conn=conn,
                       engine=eng, decode_cache=dec, remote_slot=5, local_slot=2)
    assert stats.txns_submitted == np_stats.txns_submitted == 4
    assert stats.bytes_moved == np_stats.bytes_moved == 4 * 2048 * 2
    for layer in range(4):
        assert torch.equal(dec.read_slot(layer, 2), pre.read_slot(layer, 5))
    landed = dec.memory_region().buffer.numpy()
    np.testing.assert_array_equal(landed, np_dec.memory_region().buffer)


@pytest.fixture(scope="module")
def mamba2():
    cfg = get_smoke_config("mamba2-780m")
    jm = JaxDecoderLM(cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init_params(jax.random.PRNGKey(0)))
    pm = build_model(pt_smoke_config("mamba2-780m"), device="cpu")
    return cfg, jm, jp, pm, bridge.params_from_jax(jax.tree.map(np.asarray, jp))


def _decode_greedy(serve_step, params, state, tok, n):
    out = [[int(x)] for x in tok.tolist()]
    for _ in range(n):
        tok, state = serve_step(params, state, tok)
        for seq, x in zip(out, tok.tolist()):
            seq.append(int(x))
    return out


def _slots_state(cache, cfg, slots, context_lens, conv_dtype):
    """The decode side's DecodeState (b = len(slots)) rebuilt from its slots."""
    ssd, conv = zip(*(unpack_ssm_slots(torch.stack([cache.read_slot(layer, s) for s in slots]),
                                       cfg, conv_dtype)
                      for layer in range(cache.num_layers)))
    return DecodeState(context_lens=torch.tensor(context_lens, dtype=torch.int32),
                       ssd_state=torch.stack(ssd), conv_state=torch.stack(conv))


def test_ssm_slot_round_trips_and_states_stack(mamba2):
    cfg, pm = mamba2[0], mamba2[3]
    g = torch.Generator().manual_seed(3)
    ssd = torch.randn(3, 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, generator=g)
    conv = torch.randn(3, 2, cfg.ssm_conv - 1, cfg.ssm_inner + 2 * cfg.ssm_state,
                       generator=g).to(torch.bfloat16)
    row = pack_ssm_slot(ssd[0, 1], conv[0, 1])
    assert row.dtype == torch.float32 and row.numel() == ssm_slot_elems(pm.cfg)
    back_ssd, back_conv = unpack_ssm_slots(torch.stack([row, row]), pm.cfg, torch.bfloat16)
    assert torch.equal(back_ssd[1], ssd[0, 1]) and torch.equal(back_conv[0], conv[0, 1])
    parts = [DecodeState(context_lens=torch.tensor([5 + i], dtype=torch.int32),
                         ssd_state=ssd[:, i : i + 1], conv_state=conv[:, i : i + 1])
             for i in range(2)]
    both = stack_states(parts)
    assert torch.equal(both.ssd_state, ssd) and torch.equal(both.conv_state, conv)
    assert both.context_lens.tolist() == [5, 6] and both.ring_k is None
    both.ssd_state.zero_()  # new tensors: the parts are untouched
    assert torch.equal(parts[0].ssd_state, ssd[:, :1])


def test_mamba2_disaggregated_equals_monolithic_and_jax(mamba2):
    cfg, jm, jp, pm, pp = mamba2
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (45, 100, 128)]
    n_new = 5
    prefill_step, serve_step = make_prefill_step(pm), make_serve_step(pm)
    mono, firsts, states = [], [], []
    for toks in prompts:
        tok, state = prefill_step(pp, {"tokens": torch.from_numpy(toks[None])})
        firsts.append(tok)
        states.append(state)
        mono.append(_decode_greedy(serve_step, pp, stack_states([state]), tok, n_new)[0])
    elems = ssm_slot_elems(pm.cfg)
    pre, dec, eng, conn = _pt_pair(num_layers=cfg.num_layers, num_slots=4, state_elems=elems,
                                   dtype=torch.float32)
    local = [3, 0, 1]
    for i, toks in enumerate(prompts):
        tok, state = prefill_step(pp, {"tokens": torch.from_numpy(toks[None])})
        for layer in range(cfg.num_layers):
            pre.write_slot(layer, i, pack_ssm_slot(state.ssd_state[layer, 0],
                                                   state.conv_state[layer, 0]))
        before = eng.stats.bytes_moved
        pull_state(Request(f"r{i}", prompt_len=len(toks), max_new_tokens=n_new), conn=conn,
                   engine=eng, decode_cache=dec, remote_slot=i, local_slot=local[i])
        assert eng.stats.bytes_moved - before == cfg.num_layers * elems * 4
        landed = _slots_state(dec, pm.cfg, [local[i]], [len(toks)], state.conv_state.dtype)
        assert torch.equal(landed.ssd_state, state.ssd_state)
        assert torch.equal(landed.conv_state, state.conv_state)
        assert _decode_greedy(serve_step, pp, landed, tok, n_new)[0] == mono[i]
        # the JAX package's own monolithic run gives the same tokens
        jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks[None])}, remat=False)
        want = []
        for _ in range(n_new + 1):
            nxt = np.asarray(jnp.argmax(jl[:, : cfg.vocab_size], axis=-1), np.int32)
            want.append(int(nxt[0]))
            jl, js = jm.decode_step(jp, js, jnp.asarray(nxt))
        assert mono[i] == want
    assert eng.stats.txns_submitted == len(prompts) * cfg.num_layers
    together = _decode_greedy(serve_step, pp,
                              _slots_state(dec, pm.cfg, local, [len(t) for t in prompts],
                                           torch.float32),
                              torch.cat(firsts), n_new)
    assert together == _decode_greedy(serve_step, pp, stack_states(states),
                                      torch.cat(firsts), n_new)


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_serving_workers_refuse_ssm_and_sliding_window(arch):
    """No SSM worker: the reference's workers refuse these archs, and the
    port's refuse them the same way."""
    jm = JaxDecoderLM(get_smoke_config(arch))
    with pytest.raises(NotImplementedError) as want:
        JaxService(jm, jm.init_params(jax.random.PRNGKey(0)))
    model = build_model(pt_smoke_config(arch), device="cpu")
    params = model.init_params(0)
    with pytest.raises(NotImplementedError) as got:
        PrefillWorker(WorkerInfo("p0", "prefill", "10.0.0.1", (ChipInfo(0, "ici://p0/0"),)),
                      model, params)
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="SlotCache"):
        DisaggService(model, params, device="cpu")
    with pytest.raises(NotImplementedError, match="SlotCache"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
