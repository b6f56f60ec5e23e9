"""End-to-end disaggregated serving on the PyTorch port (reduced config).

Prefill workers run the port's prefill (flash_prefill on the GPU); KV
blocks move through the KVDirect engine (one-sided, coalesced, landed by
kv_pull); the decode worker batch-decodes over paged KV (paged_attention).
Also demonstrates elastic scale-up and crash recovery.  Every request's
tokens must equal a monolithic greedy generation with the same weights.
The port of ``examples/serve_disaggregated.py``.

    PYTHONPATH=src python examples/torch_serve_disaggregated.py                # on the GPU
    PYTHONPATH=src python examples/torch_serve_disaggregated.py --device cpu   # plain paths
"""
import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.launch.steps import greedy_generate
from repro_torch.models.registry import build_model
from repro_torch.serving.disagg import DisaggService


def main(argv=None) -> str:
    """Run the example; returns what it printed.  Raises if a served
    request's tokens differ from the monolithic ones."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain paths")
    args = ap.parse_args(argv)
    lines = []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    cfg = get_smoke_config("deepseek-67b")
    model = build_model(cfg, device=args.device)
    params = model.init_params(0)
    svc = DisaggService(model, params, n_prefill=2, num_blocks=128, device=args.device)
    rng = np.random.default_rng(0)

    def served(req, tokens, out):
        ref = greedy_generate(model, params, tokens, 6)
        if out != ref:
            raise RuntimeError(f"{req.request_id}: served {out} != monolithic {ref}")

    say("== batched requests through the disaggregated pipeline ==")
    for _ in range(3):
        tokens = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
        req = svc.submit(tokens)
        out = svc.generate(req, max_new=6)
        served(req, tokens, out)
        say(f"  {req.request_id}: prefill@{req.prefill_worker} → tokens {out}")
    s = svc.engine.stats
    say(f"  engine: {s.txns_submitted} txns → {s.reads_posted} reads "
        f"(coalesce {s.coalesce_factor:.1f}×), {s.bytes_moved/2**20:.1f} MiB")

    say("== elastic scale-up: add a prefill worker to the RUNNING cluster ==")
    wid = svc.add_prefill_worker(num_blocks=128)
    if wid not in svc.conn_mgr.peers:
        raise RuntimeError(f"{wid} joined but the decode worker has no connection to it")
    say(f"  {wid} joined; decode worker auto-CONNECTed: peers={svc.conn_mgr.peers}")

    say("== crash recovery: kill the prefill worker mid-request ==")
    tokens = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    req = svc.submit(tokens)
    victim = req.prefill_worker
    svc.fail_prefill_worker(victim)
    if req.prefill_worker == victim or req.retries < 1:
        raise RuntimeError(f"{req.request_id} was not re-prefilled off {victim}")
    say(f"  {victim} failed after prefill; re-prefilled on {req.prefill_worker} "
        f"(retries={req.retries})")
    out = svc.generate(req, max_new=6)
    served(req, tokens, out)
    say(f"  {req.request_id}: recovered → tokens {out} (= monolithic greedy generation)")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
