"""Serving driver — disaggregated KVDirect service, PyTorch port of
``src/repro/launch/serve.py`` (same flags and prints, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
        --requests 3 --prompt-len 96 --max-new 8          # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-67b \\
        --smoke --device cpu                                # plain paths

Runs the REAL pipeline: prefill workers fill registered KV slabs, the
decode worker pulls with one-sided reads through the transfer engine
(coalesced, landed by the kv_pull kernel), COMPLETE frees prefill
memory, continuous-batching decode over the paged_attention kernel.
Weights are random, from seed 0.  ``--topology PRESET[:SEED]|PATH``
plans the roles over a heterogeneous cluster (``repro_torch.topo``),
sizes each worker's pool by its machine's VRAM and prices the bound
links in the router; the workers themselves all run on the one device:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-67b \
        --smoke --device cpu --topology hetero_rack:0
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.registry import build_model
from repro_torch.obs import Tracer, all_request_breakdowns, mean_fractions
from repro_torch.serving.disagg import DisaggService


def main(argv: list[str] | None = None) -> list[list[int]]:
    """Serve ``--requests`` requests one after another; returns each one's
    tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-67b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device for model compute and KV slabs "
                         "(cuda, or cpu for the plain PyTorch paths)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prefill-workers", type=int, default=2)
    ap.add_argument("--shared-prefix-frac", type=float, default=0.0,
                    metavar="FRAC",
                    help="give every request the same first FRAC of its "
                         "prompt (tagged prefix_id) so delta transfer "
                         "grafts it after the first pull")
    ap.add_argument("--quantize-transfer", action="store_true",
                    help="int8-quantize pulled KV on the wire "
                         "(docs/transfer.md)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record lifecycle spans and write a Chrome "
                         "trace-event JSON timeline here")
    ap.add_argument("--autoscale", action="store_true",
                    help="enable the fleet autoscaler (docs/fleet.md): "
                         "grow/drain workers from LoadReport pressure")
    ap.add_argument("--preempt", default="none",
                    choices=("none", "swap", "sacrifice"),
                    help="memory-pressure preemption mode on decode "
                         "workers (victims resume via host-memory swap "
                         "or truncate-and-replay)")
    ap.add_argument("--victim-policy", default="lifo",
                    choices=("lifo", "fifo", "priority"),
                    help="preemption victim selection")
    ap.add_argument("--admission-budget", type=float, default=None,
                    metavar="FRAC",
                    help="reject dispatch when projected decode KV "
                         "occupancy exceeds FRAC of fleet capacity")
    ap.add_argument("--topology", default=None, metavar="SPEC",
                    help="serve on a heterogeneous cluster topology "
                         "(docs/topology.md): either PRESET[:SEED] for a "
                         "generated cluster (e.g. hetero_rack:3) or a "
                         "path to a ClusterSpec JSON file; the placement "
                         "planner assigns roles, per-pair link costs "
                         "drive routing (overrides --prefill-workers)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init_params(0)
    tracer = Tracer() if args.trace_out else None
    fleet = None
    if args.autoscale or args.preempt != "none" \
            or args.admission_budget is not None:
        from repro_torch.fleet import FleetConfig
        fleet = FleetConfig(autoscale=args.autoscale, preempt=args.preempt,
                            victim_policy=args.victim_policy,
                            admission_budget=args.admission_budget)
    if args.topology is not None:
        import os

        from repro_torch.topo import ClusterSpec, PRESETS, generate_cluster
        if os.path.exists(args.topology):
            with open(args.topology) as f:
                spec = ClusterSpec.from_json(f.read())
        else:
            preset, _, seed = args.topology.partition(":")
            if preset not in PRESETS:
                raise SystemExit(
                    f"--topology {args.topology!r}: no such file, and not a "
                    f"PRESET[:SEED] (presets: {sorted(PRESETS)})")
            spec = generate_cluster(preset, int(seed) if seed else 0)
        svc = DisaggService.from_cluster_spec(
            model, params, spec, num_blocks=256, tracer=tracer,
            quantize_transfer=args.quantize_transfer, fleet=fleet,
            device=args.device)
        b = svc.topology
        print(f"[serve] topology {spec.name}: "
              f"prefill={[f'{w}={b.machine(w).machine_id}' for w in sorted(svc.prefills)]} "
              f"decode={[f'{w}={b.machine(w).machine_id}' for w in sorted(svc.decodes)]}")
        workers = {**svc.prefills, **svc.decodes}
        print("[serve] pools (blocks, by machine VRAM): "
              + " ".join(f"{w}={workers[w].cache.num_blocks}" for w in sorted(workers)))
    else:
        svc = DisaggService(model, params, n_prefill=args.prefill_workers,
                            num_blocks=256, tracer=tracer,
                            quantize_transfer=args.quantize_transfer,
                            fleet=fleet, device=args.device)

    rng = np.random.default_rng(0)
    prefix_len = int(args.prompt_len * args.shared_prefix_frac)
    shared = rng.integers(0, cfg.vocab_size, prefix_len).astype(np.int32)
    t0 = time.perf_counter()
    outs = []
    for i in range(args.requests):
        suffix = rng.integers(0, cfg.vocab_size,
                              args.prompt_len - prefix_len).astype(np.int32)
        tokens = np.concatenate([shared, suffix])
        req = svc.submit(tokens,
                         prefix_id="shared" if prefix_len else None,
                         prefix_len=prefix_len)
        out = svc.generate(req, max_new=args.max_new)
        outs.append(out)
        stats = svc.engine.stats
        hm = req.metrics
        print(f"[serve] {req.request_id}: prefill@{req.prefill_worker} "
              f"tokens={out} "
              f"(engine: {stats.txns_submitted} txns → {stats.reads_posted} reads, "
              f"coalesce {stats.coalesce_factor:.1f}x, "
              f"{stats.bytes_moved/2**20:.1f} MiB; "
              f"kv pulled={hm.kv_bytes_pulled} reused={hm.kv_bytes_reused} "
              f"reuse_frac={hm.kv_reuse_frac:.2f})")
    print(f"[serve] {args.requests} requests in {time.perf_counter()-t0:.1f}s; "
          f"transfer modeled {svc.engine.stats.modeled_time_s*1e3:.2f} ms total")
    print("[serve] metrics:")
    for line in svc.metrics.format(
            prefixes=("requests.", "request.", "engine.", "loop.",
                      "fleet.")).splitlines():
        print(f"[serve]   {line}")
    if tracer is not None:
        breakdowns = all_request_breakdowns(tracer)
        if breakdowns:
            fr = mean_fractions(breakdowns.values())
            print("[serve] breakdown (mean fractions): "
                  + " ".join(f"{k}={v:.3f}" for k, v in fr.items()))
        tracer.export_chrome(args.trace_out)
        print(f"[serve] wrote Chrome trace ({len(tracer.spans)} spans) "
              f"to {args.trace_out}")
    return outs


if __name__ == "__main__":
    main()
