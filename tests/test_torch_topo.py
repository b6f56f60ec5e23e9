"""Topology-bound serving on the port, against the JAX package on the CPU.

The four cases of ``tests/test_topo.py::TestServiceTopology`` replayed on
the port's ``DisaggService.from_cluster_spec`` (planned placement and
per-pair link prices, VRAM-scaled pools, hot-add consuming the spares
then raising ``NoSpareMachine``, the autoscaler skipping an add when no
spare is left), each beside the JAX service built from the same spec:
same placement, same pools, same prices, same tokens (f32 weights on
both sides, bridged from the JAX init).  Then ``launch.serve
--topology`` on the CPU.  Token and count comparisons are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.models.transformer import DecoderLM as JaxDecoderLM
from repro.serving.disagg import DisaggService as JaxService
from repro.topo import generate_cluster as jax_generate_cluster
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.fleet import FleetConfig
from repro_torch.models.registry import build_model
from repro_torch.serving.disagg import DisaggService
from repro_torch.topo import (
    PROFILES, ClusterSpec, MachineSpec, NoSpareMachine, Placement, PlacementPlanner,
    generate_cluster)

ARCH = "deepseek-67b"


def h100_spec(n: int) -> ClusterSpec:
    return ClusterSpec(name=f"flat{n}", machines=tuple(
        MachineSpec(f"m{i}", PROFILES["8xh100"]) for i in range(n)))


@pytest.fixture(scope="module")
def models():
    cfg = get_smoke_config(ARCH)
    jm = JaxDecoderLM(cfg, unroll=True)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init_params(jax.random.PRNGKey(0)))
    pm = build_model(pt_smoke_config(ARCH), device="cpu")
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, pm, pp


def test_from_cluster_spec_binds_and_serves(models):
    cfg, jm, jp, pm, pp = models
    spec = generate_cluster("hetero_rack", 0)
    assert spec.to_json() == jax_generate_cluster("hetero_rack", 0).to_json()
    svc = DisaggService.from_cluster_spec(pm, pp, spec, num_blocks=32, device="cpu")
    b = svc.topology
    planned = PlacementPlanner().plan(spec)
    assert (b.placement.prefill, b.placement.decode) == (planned.prefill, planned.decode)
    assert len(svc.prefills) == len(planned.prefill)
    assert len(svc.decodes) == len(planned.decode)
    assert set(svc.router.links) == {(p, d) for p in svc.prefills for d in svc.decodes}
    for (p, d), lm in svc.router.links.items():
        lk = b.pair_link(p, d)
        assert lm.bandwidth_Bps == lk.bandwidth_Bps
        assert lm.latency_s == lk.latency_s

    jsvc = JaxService.from_cluster_spec(jm, jp, jax_generate_cluster("hetero_rack", 0),
                                        num_blocks=32)
    jb = jsvc.topology
    assert (jb.placement.prefill, jb.placement.decode) == (planned.prefill, planned.decode)
    assert {w: b.machine(w).machine_id for w in (*svc.prefills, *svc.decodes)} == \
        {w: jb.machine(w).machine_id for w in (*jsvc.prefills, *jsvc.decodes)}
    assert {k: (v.bandwidth_Bps, v.latency_s) for k, v in svc.router.links.items()} == \
        {k: (v.bandwidth_Bps, v.latency_s) for k, v in jsvc.router.links.items()}
    prompt = np.arange(40, dtype=np.int32) % cfg.vocab_size
    h, jh = svc.submit(prompt), jsvc.submit(prompt)
    out = svc.generate(h, max_new=4)
    assert len(out) >= 4
    assert out == jsvc.generate(jh, max_new=4)
    assert (h.request.prefill_worker, h.request.decode_worker) == \
        (jh.request.prefill_worker, jh.request.decode_worker)


def test_vram_scales_worker_pools(models):
    cfg, jm, jp, pm, pp = models

    def spec(mod):
        return mod.ClusterSpec("t", machines=(
            mod.MachineSpec("m0", mod.PROFILES["8xh100"]),
            mod.MachineSpec("m1", mod.PROFILES["8xh100"]),
            mod.MachineSpec("m2", mod.PROFILES["8xl4"])))

    import repro.topo as jtopo
    import repro_torch.topo as ptopo

    svc = DisaggService.from_cluster_spec(
        pm, pp, spec(ptopo), placement=Placement(prefill=("m0",), decode=("m1", "m2")),
        num_blocks=40, device="cpu")
    pools = {w: svc.decodes[w].pool.stats.capacity for w in svc.decodes}
    ratio = PROFILES["8xl4"].vram_bytes / PROFILES["8xh100"].vram_bytes
    assert pools["d0"] == 40                          # m1: reference VRAM
    assert pools["d1"] == max(1, round(40 * ratio))   # m2: 0.3x VRAM
    assert svc.decodes["d1"].cache.num_blocks == pools["d1"]  # the slab follows
    jsvc = JaxService.from_cluster_spec(
        jm, jp, spec(jtopo), placement=jtopo.Placement(prefill=("m0",), decode=("m1", "m2")),
        num_blocks=40)
    assert pools == {w: jsvc.decodes[w].pool.stats.capacity for w in jsvc.decodes}


def test_hot_add_consumes_spares_then_raises(models):
    cfg, jm, jp, pm, pp = models
    svc = DisaggService.from_cluster_spec(
        pm, pp, h100_spec(3), placement=Placement(prefill=("m0",), decode=("m1",)),
        num_blocks=16, device="cpu")
    assert svc.topology.spares == ("m2",)
    wid = svc.add_prefill_worker(num_blocks=16)
    assert svc.topology.machine(wid).machine_id == "m2"
    assert (wid, "d0") in svc.router.links  # hot-add refreshed the pair map
    with pytest.raises(NoSpareMachine):
        svc.add_decode_worker(num_blocks=16)
    # the hot-added worker serves: a request routed to it lands its pull
    prompt = np.arange(33, dtype=np.int32) % cfg.vocab_size
    assert len(svc.generate(svc.submit(prompt), max_new=2)) >= 2


def test_autoscaler_skips_add_when_no_spare(models):
    cfg, jm, jp, pm, pp = models
    svc = DisaggService.from_cluster_spec(pm, pp, h100_spec(2), num_blocks=16,
                                          fleet=FleetConfig(autoscale=True), device="cpu")
    assert svc.topology.spares == ()
    assert svc.fleet._add("prefill") is None
    assert svc.metrics.counters()["fleet.autoscale_no_spare"] == 1
    assert len(svc.prefills) == 1  # nothing was conjured


def test_launch_serve_topology_prints_placement_and_pools(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--topology", "hetero_rack:0",
                "--requests", "2", "--max-new", "2"])
    out = capsys.readouterr().out
    spec = generate_cluster("hetero_rack", 0)
    planned = PlacementPlanner().plan(spec)
    line = next(l for l in out.splitlines() if l.startswith("[serve] topology"))
    assert spec.name in line
    for m in (*planned.prefill, *planned.decode):
        assert f"={m}'" in line
    pools = next(l for l in out.splitlines() if l.startswith("[serve] pools"))
    vram = {m.machine_id: m.profile.vram_bytes for m in spec.machines}
    want = [max(1, round(256 * vram[m] / spec.max_vram)) for m in planned.decode]
    assert [int(x.split("=")[1]) for x in pools.split(": ")[1].split()
            if x.startswith("d")] == want
    assert sum(l.startswith("[serve] r") for l in out.splitlines()) == 2


def test_launch_serve_topology_rejects_unknown_preset():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="not a PRESET"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--topology", "nowhere:1"])
