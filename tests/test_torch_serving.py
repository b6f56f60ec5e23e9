"""The port's serving stack against the JAX package on the CPU.

* the port's ``PagedKVCache`` exports the same ``TensorDesc``s as the
  numpy cache, field for field;
* the port's transfer engine lands the same bytes as the numpy engine,
  plain and int8-quantized (bit for bit);
* ``DisaggService(device="cpu")`` replays tests/test_disagg.py's
  matches-monolithic case and a shared-prefix delta-transfer case with
  the JAX service's weights (f32 on both sides): same tokens, same
  pulled and reused bytes, for ``consume="full"`` and ``"layerwise"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import descriptors as np_desc
from repro.core.transfer_engine import MemoryRegion as NpRegion
from repro.core.transfer_engine import TransferEngine as NpEngine
from repro.models.transformer import DecoderLM as JaxDecoderLM
from repro.serving.disagg import DisaggService as JaxService
from repro.serving.kv_cache import PagedKVCache as NpCache
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.core import descriptors as pt_desc
from repro_torch.core.transfer_engine import MemoryRegion, TransferEngine
from repro_torch.fleet.hostmem import HostSwapPool
from repro_torch.models.registry import build_model
from repro_torch.serving.disagg import DisaggService
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.request import RequestState

ARCH = "deepseek-67b"


@pytest.mark.parametrize("dims", [
    dict(num_layers=2, num_blocks=8, block_size=32, kv_heads=2, head_dim=8),
    dict(num_layers=3, num_blocks=5, block_size=16, kv_heads=4, head_dim=128),
])
def test_tensor_descs_equal_numpy_cache(dims):
    np_cache = NpCache("w0", base_address=0x1000_0000, **dims)
    pt_cache = PagedKVCache("w0", base_address=0x1000_0000, device="cpu", **dims)
    # one dataclass per package: compare field for field
    assert [dataclasses.astuple(d) for d in pt_cache.descriptors()] == \
        [dataclasses.astuple(d) for d in np_cache.descriptors()]
    assert pt_cache.block_nbytes == np_cache.block_nbytes
    assert pt_cache.nbytes == np_cache.nbytes
    assert PagedKVCache.slab_nbytes(**dims) == NpCache.slab_nbytes(**dims)


# -------------------------------------------------------------- engine
PAGE, NPAGES, DST = 512, 16, 1 << 20


def _engines(seed):
    """A numpy and a port engine over identical source slabs holding bf16
    values (as a KV slab does)."""
    vals = np.random.default_rng(seed).standard_normal(NPAGES * PAGE // 2).astype(np.float32)
    src_pt = torch.from_numpy(vals).to(torch.bfloat16).view(torch.uint8).clone()
    src_np = src_pt.numpy().copy()
    ne, pe = NpEngine(), TransferEngine()
    ne.register_memory(NpRegion("p0", 0, src_np))
    ne.register_memory(NpRegion("d0", DST, np.zeros(NPAGES * PAGE, np.uint8)))
    pe.register_memory(MemoryRegion("p0", 0, src_pt, page_nbytes=PAGE))
    pe.register_memory(MemoryRegion("d0", DST, torch.zeros(NPAGES * PAGE, dtype=torch.uint8),
                                    page_nbytes=PAGE))
    return ne, pe, vals


def _txns(mod, pairs, scales=None):
    """The read list in ``mod``'s descriptor classes (each engine takes its
    own package's transactions)."""
    out = [mod.ReadTxn("r0", "p0", "d0", mod.ByteRange(s * PAGE, PAGE),
                       mod.ByteRange(DST + d * PAGE, PAGE), layer=0,
                       qscale=None if scales is None else scales[i])
           for i, (s, d) in enumerate(pairs)]
    return out + [mod.CompleteTxn("r0", "p0", "d0")]


PAIRS = [(3, 0), (4, 1), (5, 2), (9, 7), (0, 15), (12, 8)]  # runs coalesce


@pytest.mark.parametrize("quantized", [False, True])
def test_engine_lands_the_numpy_engines_bytes(quantized):
    ne, pe, vals = _engines(1)
    scales = None
    if quantized:  # per-page max/127, as PrefillWorker._quant_scales computes
        pages = torch.from_numpy(vals).to(torch.bfloat16).float().reshape(NPAGES, -1)
        scales = [float(pages[s].abs().max()) / 127.0 for s, _ in PAIRS]
    ne.submit(_txns(np_desc, PAIRS, scales))
    pe.submit(_txns(pt_desc, PAIRS, scales))
    ne.drain()
    pe.drain()
    assert ne.stats.bytes_moved == pe.stats.bytes_moved
    assert ne.stats.reads_posted == pe.stats.reads_posted
    np.testing.assert_array_equal(pe._regions["d0"].buffer.numpy(), ne._regions["d0"].buffer)
    if quantized:
        assert pe.stats.bytes_moved == len(PAIRS) * (PAGE // 2 + 4)


def test_int8_codec_engine_lands_the_numpy_engines_bytes():
    ne, pe, _ = _engines(2)
    ne.codec = pe.codec = "int8_transport"
    ne.submit(_txns(np_desc, PAIRS))
    pe.submit(_txns(pt_desc, PAIRS))
    ne.drain()
    pe.drain()
    np.testing.assert_array_equal(pe._regions["d0"].buffer.numpy(), ne._regions["d0"].buffer)


def test_misaligned_span_raises():
    """A span that starts inside a page is no error: it lands the bytes the
    numpy engine's byte copy lands (the name is kept from when the port
    refused such reads)."""
    ne, pe, _ = _engines(3)
    for mod, eng in ((np_desc, ne), (pt_desc, pe)):
        eng.submit([mod.ReadTxn("r0", "p0", "d0", mod.ByteRange(PAGE // 2, PAGE),
                                mod.ByteRange(DST, PAGE), layer=0),
                    mod.CompleteTxn("r0", "p0", "d0")])
        eng.drain()
    np.testing.assert_array_equal(pe._regions["d0"].buffer.numpy(), ne._regions["d0"].buffer)
    assert pe._regions["d0"].buffer[:PAGE].any()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("case", ["unpaged 4096 B", "2048 B on 4096-byte pages",
                                  "half-page offset"])
def test_reads_off_pages_land_through_kv_pull(monkeypatch, case, quantized):
    """Every span the numpy engine's byte copy lands, the port's lands too,
    byte for byte, each read as one page of its own length through the
    kv_pull (or kv_pull_dequant) wrapper."""
    from repro_torch.kernels.kv_pull import ops

    page = 0 if case == "unpaged 4096 B" else 4096
    src_off, n = {"unpaged 4096 B": (0, 4096), "2048 B on 4096-byte pages": (4096, 2048),
                  "half-page offset": (2048, 4096)}[case]
    vals = np.random.default_rng(9).standard_normal(8192).astype(np.float32)
    src_pt = torch.from_numpy(vals).to(torch.bfloat16).view(torch.uint8).clone()
    ne, pe = NpEngine(), TransferEngine()
    ne.register_memory(NpRegion("p0", 0, src_pt.numpy().copy()))
    ne.register_memory(NpRegion("d0", DST, np.zeros(16384, np.uint8)))
    pe.register_memory(MemoryRegion("p0", 0, src_pt, page_nbytes=page))
    pe.register_memory(MemoryRegion("d0", DST, torch.zeros(16384, dtype=torch.uint8),
                                    page_nbytes=page))
    calls = []
    name = "kv_pull_dequant_ref" if quantized else "kv_pull_ref"
    ref = getattr(ops, name)
    monkeypatch.setattr(ops, name, lambda *a: calls.append(a[0].shape) or ref(*a))
    for mod, eng in ((np_desc, ne), (pt_desc, pe)):
        eng.codec = "int8_transport" if quantized else "none"
        eng.submit([mod.ReadTxn("r0", "p0", "d0", mod.ByteRange(src_off, n),
                                mod.ByteRange(DST + 4096, n), layer=0),
                    mod.CompleteTxn("r0", "p0", "d0")])
        eng.drain()
    np.testing.assert_array_equal(pe._regions["d0"].buffer.numpy(), ne._regions["d0"].buffer)
    assert pe._regions["d0"].buffer.any()
    assert calls == [(1, n // 2 if quantized else n)]  # one page of the read's length


# -------------------------------------------------------------- service
@pytest.fixture(scope="module")
def both_models():
    cfg = get_smoke_config(ARCH)
    jm = JaxDecoderLM(cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init_params(jax.random.PRNGKey(0)))
    pm = build_model(pt_smoke_config(ARCH), device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, pm, pp


def port_monolithic(model, params, tokens, n):
    logits, state = model.prefill(params, {"tokens": torch.tensor(tokens[None])})
    vocab = model.cfg.vocab_size
    out = [int(torch.argmax(logits[0, :vocab]))]
    tok = torch.tensor([out[-1]], dtype=torch.int32)
    for _ in range(n):
        logits, state = model.decode_step(params, state, tok)
        tok = torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)
        out.append(int(tok[0]))
    return out


@pytest.mark.parametrize("consume", ["full", "layerwise"])
def test_disagg_matches_monolithic_and_jax(both_models, consume):
    cfg, jm, jp, pm, pp = both_models
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, 64).astype(np.int32)
    ref = port_monolithic(pm, pp, tokens, 4)

    svc = DisaggService(pm, pp, n_prefill=1, num_blocks=64, consume=consume, device="cpu")
    req = svc.submit(tokens)
    got = svc.generate(req, max_new=4)
    assert got == ref, f"disagg {got} != monolithic {ref}"
    assert req.state == RequestState.DONE

    jsvc = JaxService(jm, jp, n_prefill=1, num_blocks=64, consume=consume)
    assert got == jsvc.generate(jsvc.submit(tokens), max_new=4)


@pytest.mark.parametrize("consume", ["full", "layerwise"])
def test_shared_prefix_delta_matches_jax(both_models, consume):
    cfg, jm, jp, pm, pp = both_models
    rng = np.random.default_rng(1)
    prefix_len = 32
    shared = rng.integers(0, cfg.vocab_size, prefix_len).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 40).astype(np.int32)])
               for _ in range(3)]
    runs = {}
    for name, svc in (
            ("port", DisaggService(pm, pp, n_prefill=1, n_decode=1, num_blocks=64,
                                   consume=consume, device="cpu")),
            ("jax", JaxService(jm, jp, n_prefill=1, n_decode=1, num_blocks=64,
                               consume=consume))):
        outs = []
        for t in prompts:  # sequential: request i warms request i+1
            h = svc.submit(t, prefix_id="sys", prefix_len=prefix_len)
            outs.append((svc.generate(h, max_new=3), h.metrics.kv_bytes_pulled,
                         h.metrics.kv_bytes_reused))
        runs[name] = outs
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][2] == 0 and runs["port"][1][2] > 0  # the prefix grafted


def test_batched_decode_matches_monolithic_batch(both_models):
    """Three ragged prompts decoded together (every pull landed first, so
    every step runs at b = 3) equal a monolithic b = 3 decode_step run over
    the stacked prefill states."""
    cfg, _, _, pm, pp = both_models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (40, 70, 33)]
    svc = DisaggService(pm, pp, n_prefill=2, num_blocks=64, device="cpu")
    hs = [svc.submit(t) for t in prompts]
    svc.admit_queued()
    svc.pump(None)
    assert list(svc.decode.resident) == [h.request_id for h in hs]
    got = svc.generate_many(hs, max_new=4)

    per_seq = max(-(-len(t) // pm.BLOCK_SIZE) for t in prompts) + 1
    firsts, states = [], []
    for t in prompts:
        logits, st = pm.prefill(pp, {"tokens": torch.tensor(t[None])},
                                max_blocks_margin=per_seq - -(-len(t) // pm.BLOCK_SIZE))
        firsts.append(torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32))
        states.append(st)
    state = dataclasses.replace(
        states[0], context_lens=torch.cat([s.context_lens for s in states]),
        k_pages=torch.cat([s.k_pages for s in states], dim=1),
        v_pages=torch.cat([s.v_pages for s in states], dim=1),
        block_tables=torch.cat([s.block_tables for s in states]))
    tok = torch.cat(firsts)
    ref = [[int(x)] for x in tok]
    for _ in range(4):
        logits, state = pm.decode_step(pp, state, tok)
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32)
        for seq, x in zip(ref, tok.tolist()):
            seq.append(x)
    assert [got[h.request_id] for h in hs] == ref


def test_quantized_service_wire_bytes(both_models):
    cfg, _, _, pm, pp = both_models
    svc = DisaggService(pm, pp, n_prefill=1, num_blocks=64, quantize_transfer=True,
                        device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, 70).astype(np.int32)
    out = svc.generate(svc.submit(tokens), max_new=3)
    assert len(out) == 4
    block = svc.decode.cache.block_nbytes
    assert svc.engine.stats.bytes_moved == svc.engine.stats.reads_posted * (block // 2 + 4)


def test_swap_out_and_in_round_trip(both_models):
    cfg, _, _, pm, pp = both_models
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, 50).astype(np.int32)
    ref = port_monolithic(pm, pp, tokens, 4)
    svc = DisaggService(pm, pp, n_prefill=1, num_blocks=64, device="cpu")
    h = svc.submit(tokens)
    svc.admit_queued()
    svc.engine.drain()
    dw = svc.decode
    dw.pump(0)
    first = [h.tokens[0]] + [dw.step()[h.request_id] for _ in range(2)]
    entry = dw.swap_out(h.request_id)
    assert entry.k_pages.device.type == "cpu" and h.request_id not in dw.resident
    assert dw.swap_in(entry)
    rest = [dw.step()[h.request_id] for _ in range(2)]
    assert first + rest == ref


def _swap_after_steps(svc, tokens, steps):
    h = svc.submit(tokens)
    svc.admit_queued()
    svc.engine.drain()
    svc.decode.pump(0)
    for _ in range(steps):
        svc.decode.step()
    return svc.decode.swap_out(h.request_id)


def test_swap_budget_counts_the_reference_bytes(both_models):
    """The port parks bf16 host pages, the reference f32 ones; a swap's
    byte count stays on the reference's basis, so one HostSwapPool budget
    admits and refuses the same swaps in both services."""
    cfg, jm, jp, pm, pp = both_models
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, 70).astype(np.int32)
    port = _swap_after_steps(DisaggService(pm, pp, n_prefill=1, num_blocks=64, device="cpu"),
                             tokens, 2)
    ref = _swap_after_steps(JaxService(jm, jp, n_prefill=1, num_blocks=64), tokens, 2)
    assert port.k_pages.dtype == torch.bfloat16
    assert port.nbytes == ref.nbytes
    for budget in (ref.nbytes, ref.nbytes - 1):
        fits = [HostSwapPool(budget).put("r", e, e.nbytes) for e in (port, ref)]
        assert fits[0] == fits[1] == (budget >= ref.nbytes)
