"""The reference's service and engine tests, replayed on the port (CPU).

Each replayed file is the JAX package's own test module, loaded here with
the serving stack swapped for the port's: the modules the port copies or
rewrites (``core``, ``sched``, ``fleet``, ``serving``, ``topo``) come from
``repro_torch``, so descriptors, enums and errors are the port's own;
``DisaggService`` and ``DecodeWorker`` take the test's JAX model and
params and run the port's model on them (``bridge.params_from_jax``, the
config copied field by field, ``device="cpu"``); ``MemoryRegion`` wraps
the test's numpy slabs as tensors that share their memory, so the test
reads the landed bytes where it wrote its expectations.  The JAX models
of the fixtures initialise in f32 (``F32DecoderLM``), so the JAX
monolithic oracles and the port service run the same f32 weights; both
services keep KV in a bf16 slab.  The files' own assertions and
tolerances are unchanged.

Replayed: ``test_serve_loop.py``, ``test_delta_transfer.py`` and
``test_async_engine.py`` (service, engine and layer-streamed cases, the
2048-byte reads on 4096-byte pages included), the service cases of
``test_fleet.py`` and of ``test_layerwise.py`` with its engine-level
``TestWaitLayer``, and ``test_sched.py`` and ``test_obs.py`` whole, with
the port's ``obs`` and ``sim`` swapped in too, but for ``test_obs.py``'s
``TestBenchTrajectory``, which tests reference-only code: the
``BENCH_*.json`` trajectory (``repro.obs.bench``), which the port leaves
out, and the reference's benchmark runner (``benchmarks.run``); the
file's import of the four trajectory names is served by the reference's
module so that the file loads.  Cases that read the slab through numpy (bf16 tensors
have no numpy form) or spy on the JAX model are re-stated below on the
port's tensors and model; the margin-exhaustion case, which decodes past
a page boundary, compares with the JAX service on the same weights (a
top-2 logit margin of 6.1e-5 at its token 23 sits between the f32
oracle's f32 KV and both services' bf16 KV).
"""
import dataclasses
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import DecoderLM as JaxDecoderLM
from repro.serving.disagg import DisaggService as JaxService
from repro_torch import bridge
from repro_torch.core import transfer_engine as pt_engine
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.registry import build_model as pt_build_model
from repro_torch.serving import disagg as pt_disagg
from repro_torch.serving import engine as pt_workers
from repro_torch.serving.request import RequestState

TESTS = pathlib.Path(__file__).resolve().parent
PORTED = ("core", "sched", "fleet", "serving", "topo")


class F32DecoderLM(JaxDecoderLM):
    """The JAX model with f32 weights (the port's f32 parity baseline)."""

    def init_params(self, rng):
        return jax.tree.map(lambda a: a.astype(jnp.float32), super().init_params(rng))


_PORT = {}


def port_of(model, params):
    """The port's model and params for a JAX (model, params) pair, built
    once per pair."""
    key = (id(model), id(params))
    if key not in _PORT:
        cfg = PortConfig(**dataclasses.asdict(model.cfg))
        _PORT[key] = (pt_build_model(cfg, device="cpu"),
                      bridge.params_from_jax(jax.tree.map(np.asarray, params)), model, params)
    return _PORT[key][:2]


class ReplayService(pt_disagg.DisaggService):
    def __init__(self, model, params, **kw):
        super().__init__(*port_of(model, params), device="cpu", **kw)


class ReplayDecodeWorker(pt_workers.DecodeWorker):
    def __init__(self, info, model, params, **kw):
        super().__init__(info, *port_of(model, params), **kw)


def replay_region(worker_id, base_address, buffer, page_nbytes=0):
    """The port's MR over a numpy slab, sharing its memory."""
    if isinstance(buffer, np.ndarray):
        buffer = torch.from_numpy(buffer)
    return pt_engine.MemoryRegion(worker_id, base_address, buffer, page_nbytes)


def load(name: str, prefix: str, classes: dict[str, dict], functions=(),
         ported=PORTED, reference: dict[str, tuple[str, ...]] | None = None,
         ) -> tuple[dict, types.ModuleType]:
    """Load ``tests/<name>.py`` with the port's modules ``ported`` (the
    serving stack by default) in place of the reference's.  Returns its
    selected test classes, each with the listed methods replaced (or, for
    None, left out), its module-level test ``functions`` and its
    module-level fixtures, all renamed with ``prefix``; and the loaded
    module.  ``reference`` maps a reference module to names the file
    imports one a line from a ported package that the port leaves out:
    they are taken from that module instead."""
    text = (TESTS / f"{name}.py").read_text()
    text = re.sub(rf"\b(from|import) repro\.({'|'.join(ported)})\b",
                  lambda m: f"{m.group(1)} repro_torch.{m.group(2)}", text)
    for module, names in (reference or {}).items():
        for n in names:
            text, k = re.subn(rf"^[ \t]+{n},\n", "", text, flags=re.M)
            assert k == 1, (name, n)
        text += f"\nfrom {module} import {', '.join(names)}\n"
    fixtures = re.findall(r"^@pytest\.fixture[^\n]*\n(?:@[^\n]*\n)*def (\w+)", text, re.M)
    for fx in fixtures:
        text = re.sub(rf"\b{fx}\b", f"{prefix}_{fx}", text)
    mod = types.ModuleType(f"replay_{name}")
    mod.__file__ = str(TESTS / f"{name}.py")
    exec(compile(text, mod.__file__, "exec"), mod.__dict__)
    mod.DisaggService = ReplayService
    mod.DecodeWorker = ReplayDecodeWorker
    mod.MemoryRegion = replay_region
    mod.DecoderLM = F32DecoderLM
    mod.build_model = lambda cfg, **kw: F32DecoderLM(cfg, **kw)
    out = {f"{prefix}_{fx}": getattr(mod, f"{prefix}_{fx}") for fx in fixtures}
    for cls_name, methods in classes.items():
        cls = getattr(mod, cls_name)
        out[f"Test{prefix}{cls_name[4:]}"] = type(cls_name, (cls,), dict(methods))
    for fn in functions:
        out[f"test_{prefix}_{fn[5:]}"] = getattr(mod, fn)
    return out, mod


def _np(t) -> np.ndarray:
    """A port tensor (bf16 included) as f32 numpy; numpy input as is."""
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------- cases re-stated on the port
def serve_loop_margin_exhaustion(self, ServeLoop_service_setup):
    """Decode far enough past the page margin to force mid-stream state
    rebuilds; the port's stream must match the JAX service's on the same
    f32 weights (both keep KV in a bf16 slab)."""
    cfg, model, params = ServeLoop_service_setup
    bs = model.BLOCK_SIZE
    n_steps = 2 * bs + 3  # crosses >= 2 page boundaries
    tokens = SERVE_LOOP._toks(cfg, 61, n=bs)
    jsvc = JaxService(model, params, n_prefill=1, n_decode=1, num_blocks=64)
    jh = jsvc.submit(tokens, max_new=n_steps)
    jsvc.loop.run_until_idle()
    svc = ReplayService(model, params, n_prefill=1, n_decode=1, num_blocks=64)
    h = svc.submit(tokens, max_new=n_steps)
    svc.loop.run_until_idle()
    assert len(h.tokens) == n_steps + 1
    assert h.tokens == jh.tokens
    assert h.metrics.kv_bytes_pulled == jh.metrics.kv_bytes_pulled


def layerwise_overlap(self, Layerwise_dense_setup):
    """The first decode step's early-layer attention runs while the pull
    still has transactions queued (the spy sits on the port's model)."""
    cfg, model, params = Layerwise_dense_setup
    svc = ReplayService(model, params, n_prefill=1, n_decode=1, num_blocks=64,
                        consume="layerwise")
    rng = np.random.default_rng(0)
    req = svc.submit(rng.integers(0, cfg.vocab_size, 64).astype(np.int32))
    svc.admit_queued()
    pending_at_layer = []
    port_model = svc.model
    orig = port_model.decode_step_layerwise

    def spy(params_, state, toks, fetch):
        return orig(params_, state, toks,
                    lambda l: (pending_at_layer.append((l, svc.engine.pending)), fetch(l))[1])

    port_model.decode_step_layerwise = spy
    try:
        out = svc.decode.decode_round(2, pump_budget=4)
    finally:
        del port_model.decode_step_layerwise
    assert req.request_id in out
    assert pending_at_layer[0][0] == 0
    assert pending_at_layer[0][1] > 0, \
        "pull fully drained before the first layer's attention — no overlap"


def delta_torn_suffix(self, Delta_setup):
    cfg, model, params = Delta_setup
    prompts, prefix_len = DELTA.shared_prefix_prompts(
        cfg, model, n=2, prompt_len=64, prefix_frac=0.5, seed=4)
    ref = DELTA.monolithic_generate(model, params, prompts[1], 3)
    svc = ReplayService(model, params, n_prefill=2, n_decode=1, num_blocks=64,
                        delta_transfer=True)
    dw = svc.decode
    h0 = svc.submit(prompts[0], prefix_id="sys", prefix_len=prefix_len)
    svc.generate(h0, max_new=3)
    graft = list(dw.prefix_cache["sys"])
    before = [[_np(x) for x in dw.cache.read_block(layer, b)]
              for layer in range(cfg.num_layers) for b in graft]
    h1 = svc.submit(prompts[1], prefix_id="sys", prefix_len=prefix_len)
    svc.admit_queued()
    assert h1.request.state is RequestState.KV_TRANSFER
    svc.engine.progress(2)  # part of the suffix lands...
    victim = h1.request.prefill_worker
    svc.fail_prefill_worker(victim)  # ...then the connection tears
    assert h1.request.prefill_worker != victim
    assert h1.request.retries == 1
    assert list(dw.prefix_cache["sys"]) == graft
    after = [[_np(x) for x in dw.cache.read_block(layer, b)]
             for layer in range(cfg.num_layers) for b in graft]
    for (bk, bv), (ak, av) in zip(before, after):
        np.testing.assert_array_equal(bk, ak)
        np.testing.assert_array_equal(bv, av)
    got = svc.generate_many([h1], max_new=3)[h1.request_id]
    assert got == ref
    full = h0.metrics.kv_bytes_pulled
    graft_bytes = full * prefix_len // 64
    assert h1.metrics.kv_bytes_reused == 2 * graft_bytes
    suffix_bytes = full - graft_bytes
    assert suffix_bytes <= h1.metrics.kv_bytes_pulled <= 2 * suffix_bytes


def delta_quantized_roundtrip(self, Delta_setup):
    cfg, model, params = Delta_setup
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, 64).astype(np.int32)
    svc = ReplayService(model, params, n_prefill=1, n_decode=1, num_blocks=64,
                        quantize_transfer=True)
    h = svc.submit(tokens)
    req = h.request
    pw = svc.prefills[req.prefill_worker]
    src = {}
    for layer in range(cfg.num_layers):
        kp, vp = pw.cache.kv_planes(layer)
        for blk in req.prefill_blocks:
            src[(layer, blk, 0)], src[(layer, blk, 1)] = _np(kp[blk]), _np(vp[blk])
    svc.admit_queued()
    svc.engine.drain()
    dw = svc.decode
    dw.pump(0)
    for layer in range(cfg.num_layers):
        kp, vp = dw.cache.kv_planes(layer)
        for pos, blk in enumerate(req.prefill_blocks):
            dst_blk = req.decode_blocks[pos]
            for plane, landed in ((0, kp[dst_blk]), (1, vp[dst_blk])):
                s = src[(layer, blk, plane)]
                tol = float(np.max(np.abs(s))) / 127.0 + 1e-6
                err = np.max(np.abs(_np(landed) - s))
                assert err <= tol, f"layer {layer} block {pos} plane {plane}: {err} > {tol}"
    logical = h.metrics.kv_bytes_pulled or svc.engine.pulled_bytes(req.request_id)
    assert svc.engine.stats.bytes_moved < 0.6 * logical


def delta_page_cache_invalidates(self, Delta_setup):
    cfg, model, params = Delta_setup
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, 64).astype(np.int32)
    svc = ReplayService(model, params, n_prefill=1, n_decode=1, num_blocks=64)
    h = svc.submit(tokens)
    svc.admit_queued()
    svc.engine.drain()
    dw = svc.decode
    dw.pump(0)
    r = dw.resident[h.request_id]
    k0, _ = dw._resident_pages(r)
    assert r.cached_from == tuple(r.blocks)
    (new_blk,) = dw.pool.allocate(1)
    marker_k = np.full((dw.block_size, cfg.num_kv_heads, cfg.head_dim), 3.0, np.float32)
    for layer in range(cfg.num_layers):
        dw.cache.write_block(layer, new_blk, marker_k, -marker_k)
    old = r.blocks[0]
    r.blocks = [new_blk] + r.blocks[1:]
    k1, v1 = (_np(x) for x in dw._resident_pages(r))
    np.testing.assert_array_equal(k1[:, 0], np.broadcast_to(
        marker_k, (cfg.num_layers,) + marker_k.shape))
    np.testing.assert_array_equal(v1[:, 0], -k1[:, 0])
    np.testing.assert_array_equal(k1[:, 1:], _np(k0)[:, 1:])
    dw.pool.free([new_blk])
    r.blocks = [old] + r.blocks[1:]


def async_layer0_first(self):
    M = ASYNC
    pre, dec, eng, conn = M.kv_setup()
    pre_pool, dec_pool = M.BlockPool(M.BLOCKS, block_size=M.BS), \
        M.BlockPool(M.BLOCKS, block_size=M.BS)
    req = M.Request("r1", prompt_len=4 * M.BS, max_new_tokens=8)
    req.prefill_blocks = pre_pool.allocate(4)
    truth = M.fill_blocks(pre, req.prefill_blocks)
    fut = M.pull_kv_async(req, conn=conn, engine=eng, decode_pool=dec_pool, decode_cache=dec)
    assert fut.layers_done == ()
    seen_layer0_before_done = False
    layer_history = []
    while eng.pending:
        eng.progress(2)
        layer_history.append(fut.layers_done)
        if 0 in fut.layers_done and not fut.done():
            for pb, db in zip(req.prefill_blocks, req.decode_blocks):
                k, v = dec.read_block(0, db)
                k_t, v_t = truth[(0, pb)]
                np.testing.assert_array_equal(_np(k), _np(k_t))
                np.testing.assert_array_equal(_np(v), _np(v_t))
            seen_layer0_before_done = True
    assert seen_layer0_before_done
    assert fut.done() and fut.layers_done == (0, 1, 2)
    for a, b in zip(layer_history, layer_history[1:]):
        assert b[: len(a)] == a


def async_build_state_cache(self, Async_service_setup):
    cfg, model, params = Async_service_setup
    svc = ReplayService(model, params, n_prefill=1, n_decode=1, num_blocks=64)
    rng = np.random.default_rng(4)
    reqs = [svc.submit(rng.integers(0, cfg.vocab_size, 64).astype(np.int32))
            for _ in range(2)]
    svc.admit_queued()
    svc.engine.drain()
    dw = svc.decode
    dw.pump(0)
    batch = list(dw.resident.values())
    cached = dw._build_state(batch, margin_blocks=1)
    for r in batch:
        assert r.k_cached is not None
        r.k_cached = r.v_cached = None
    fresh = dw._build_state(batch, margin_blocks=1)
    np.testing.assert_array_equal(_np(cached.k_pages), _np(fresh.k_pages))
    np.testing.assert_array_equal(_np(cached.v_pages), _np(fresh.v_pages))
    svc.generate_many(reqs, max_new=2)


_exports, SERVE_LOOP = load("test_serve_loop", "ServeLoop", {
    "TestHandleStreaming": {}, "TestContinuousBatching": {}, "TestHedgedPrefill": {},
    "TestPrefixAffinityRouting": {},
    "TestWorkerStep": {"test_margin_exhaustion_rebuild_is_lossless":
                       serve_loop_margin_exhaustion}})
globals().update(_exports)
_exports, _ = load("test_fleet", "Fleet", {
    "TestPreemptionCorrectness": {}, "TestFleetController": {}})
globals().update(_exports)
_exports, DELTA = load("test_delta_transfer", "Delta", {
    "TestDeltaPlan": {},
    "TestTornSuffix": {"test_torn_mid_suffix_preserves_graft_and_replays": delta_torn_suffix},
    "TestQuantizedTransfer": {"test_roundtrip_within_documented_tolerance":
                              delta_quantized_roundtrip},
    "TestResidentPageCache": {"test_cache_invalidates_when_block_list_changes":
                              delta_page_cache_invalidates},
    "TestPoolDeltaLifecycleInvariants": {}})
globals().update(_exports)
_exports, _ = load("test_layerwise", "Layerwise", {
    "TestWaitLayer": {},
    "TestServiceEquivalence": {"test_streaming_step_overlaps_the_pull": layerwise_overlap},
    "TestFaultInjectionBetweenLayers": {}})
globals().update(_exports)
_exports, ASYNC = load("test_async_engine", "Async", {
    "TestFutures": {}, "TestIncrementalProgress": {}, "TestTeardownDuringTransfer": {},
    "TestLayerStreamedPull": {"test_layers_complete_in_order_layer0_first":
                              async_layer0_first},
    "TestOverlappedService": {"test_build_state_page_cache_matches_fresh_gather":
                              async_build_state_cache}})
globals().update(_exports)
_exports, _ = load("test_sched", "Sched", {
    "TestLoadPiggyback": {}, "TestPolicies": {}, "TestRouter": {},
    "TestMemoryRegionOverlap": {}, "TestMultiWorkerService": {}, "TestSimPolicies": {}},
    ported=PORTED + ("obs", "sim"))
globals().update(_exports)
_exports, _ = load("test_obs", "Obs", {
    "TestTracer": {}, "TestMetrics": {},
    "TestStallForensics": {}, "TestLiveTracing": {}, "TestPulledBytesAccounting": {}},
    ported=PORTED + ("obs", "sim"),
    reference={"repro.obs.bench": ("BenchTrajectory", "bench_path", "load_trajectory",
                                   "validate_bench")})
globals().update(_exports)
del _exports
