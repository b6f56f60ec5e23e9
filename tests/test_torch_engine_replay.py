"""The reference's transfer-engine test modules, replayed on the port (CPU).

Each replayed file is the JAX package's own test module, loaded by
``test_torch_service_replay.load``: its imports of ``repro.core`` (and of
the other modules the port rewrites or copies: ``sched``, ``fleet``,
``serving``, ``topo``; for ``test_beyond_paper.py`` also ``sim`` and
``configs``) come from ``repro_torch``, and ``MemoryRegion`` wraps the
test's numpy slabs as tensors that share their memory
(``replay_region``), so each test reads the landed bytes where it wrote
its expectations.  The files' own assertions and tolerances are
unchanged.

Replayed whole: ``test_transfer_engine.py`` (byte movement, ordering
rules, message mode, callbacks, coalescing, the link model),
``test_properties.py`` (hypothesis: descriptor arithmetic, coalescing,
the engine against its oracle, layered interleavings, the block pool's
delta lifecycle; left out, as the reference does, where hypothesis is
missing) and ``test_beyond_paper.py`` (hedged prefill in the simulator,
the int8 transport codec).  No case is left out.
"""
import importlib.util

from test_torch_service_replay import PORTED, load

_exports, _ = load("test_transfer_engine", "Engine", {
    "TestByteMovement": {}, "TestOrderingRules": {}, "TestMessageModeBaseline": {},
    "TestCompletionCallbacks": {}, "TestCoalesceStrategies": {}, "TestLinkModel": {}})
globals().update(_exports)
if importlib.util.find_spec("hypothesis") is not None:
    _exports, _ = load("test_properties", "Properties", {}, functions=(
        "test_block_ranges_tile_numpy_truth", "test_coalescing_preserves_byte_mapping",
        "test_engine_matches_oracle", "test_build_block_reads_size_totals",
        "test_any_interleaving_matches_one_shot_drain",
        "test_pool_delta_lifecycle_never_leaks_or_double_frees"))
    globals().update(_exports)
_exports, _ = load("test_beyond_paper", "BeyondPaper", {
    "TestHedgedPrefill": {}, "TestInt8TransportCodec": {}},
    ported=PORTED + ("sim", "configs"))
globals().update(_exports)
del _exports
