"""Cluster-scale what-if on the PyTorch port: pull vs push vs colocated
under load.  The port of ``examples/pull_vs_push_sim.py``.

Runs the port's copy of the calibrated discrete-event simulator
(``repro_torch.sim``, the same one behind the paper-figure benchmarks)
on the paper's model and H100 node, printing the latency, TTFT and TBT
trade-offs at a saturating QPS.  The simulator runs on the host.

    PYTHONPATH=src python examples/torch_pull_vs_push_sim.py
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.sim.costs import H100_NODE, CostModel
from repro_torch.sim.events import ClusterSim, SimConfig
from repro_torch.sim.workloads import SHAREGPT, sample_requests


def main(argv=None) -> str:
    """Run the what-if; returns what it printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=240.0, help="seconds of arrivals")
    args = ap.parse_args(argv)
    lines = []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    cfg = get_config("mistral-large-123b")
    cost = CostModel(cfg, H100_NODE)
    say(f"model: {cfg.describe()}")
    say(f"worker: {H100_NODE.name}; KV capacity "
        f"{cost.kv_capacity_tokens()/1e6:.2f}M tokens; "
        f"prefill(20K) = {cost.prefill_s(20_471):.2f}s; "
        f"KV transfer(20K) = {cost.transfer_s(20_471)*1e3:.0f} ms (KVDirect) "
        f"vs {cost.transfer_s(20_471, mode='message')*1e3:.0f} ms (message)")

    qps = 0.9
    reqs = sample_requests(SHAREGPT, qps=qps, duration_s=args.duration, seed=11)
    say(f"\nShareGPT-like workload @ {qps} QPS, {len(reqs)} requests:")
    for mode in ("pull", "push", "colocated"):
        sim = ClusterSim(cost, SimConfig(n_prefill=1, n_decode=1, mode=mode))
        s = sim.run(list(reqs)).summary()
        say(f"  {mode:10s} p50={s['p50_total_s']:6.1f}s p90={s['p90_total_s']:6.1f}s "
            f"ttft_p90={s['p90_ttft_s']:5.1f}s tbt_p90={s['p90_tbt_s']*1e3:5.1f}ms")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
