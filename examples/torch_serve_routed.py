"""Routed disaggregated serving on the PyTorch port: N prefill x M decode
with pluggable scheduling policies (``repro_torch.sched``).

Demonstrates, on the real pipeline (the port's prefill, one-sided KV
pulls through the transfer engine):
  * network-aware routing: decode selection follows the modeled transfer
    cost of each request's KV over the (prefill, decode) link;
  * SLO-aware admission: requests whose projected TTFT misses their
    deadline class are rejected up front;
  * failover for both roles: prefill and decode crashes re-route
    in-flight requests.
Every served request's tokens must equal a monolithic greedy generation
with the same weights.  The port of ``examples/serve_routed.py``.

    PYTHONPATH=src python examples/torch_serve_routed.py                # on the GPU
    PYTHONPATH=src python examples/torch_serve_routed.py --device cpu   # plain paths
"""
import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.transfer_engine import LinkModel
from repro_torch.launch.steps import greedy_generate
from repro_torch.models.registry import build_model
from repro_torch.sched import AdmissionRejected
from repro_torch.serving.disagg import DisaggService


def main(argv=None) -> str:
    """Run the example; returns what it printed.  Raises if a served
    request's tokens differ from the monolithic ones, if a request crosses
    the slow links, or if admission neither admits nor rejects."""
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
    rng = np.random.default_rng(0)

    def generate(svc, req, tokens):
        out = svc.generate(req, max_new=4)
        ref = greedy_generate(model, params, tokens, 4)
        if out != ref:
            raise RuntimeError(f"{req.request_id}: served {out} != monolithic {ref}")
        return out

    say("== network-aware routing over a skewed 2P x 2D topology ==")
    # rail-aligned links are fast ICI; cross-rail links cross the DCN
    links = {
        ("p0", "d0"): LinkModel.ici(), ("p1", "d1"): LinkModel.ici(),
        ("p0", "d1"): LinkModel.dcn(), ("p1", "d0"): LinkModel.dcn(),
    }
    svc = DisaggService(model, params, n_prefill=2, n_decode=2, num_blocks=128,
                        policy="network_aware", links=links, device=args.device)
    for _ in range(4):
        tokens = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
        req = svc.submit(tokens)
        out = generate(svc, req, tokens)
        if links[(req.prefill_worker, req.decode_worker)] != LinkModel.ici():
            raise RuntimeError(f"{req.request_id} routed over the DCN: "
                               f"{req.prefill_worker} -> {req.decode_worker}")
        say(f"  {req.request_id}: prefill@{req.prefill_worker} -> "
            f"decode@{req.decode_worker} tokens {out}")
    s = svc.engine.stats
    say(f"  engine: {s.txns_submitted} txns -> {s.reads_posted} reads "
        f"(coalesce {s.coalesce_factor:.1f}x), {s.bytes_moved/2**20:.1f} MiB; "
        f"router modeled transfer {svc.router.total_transfer_cost_s*1e3:.2f} ms")

    say("== SLO-aware admission: reject what cannot meet its deadline ==")
    def slow_prefill(n):  # pretend prefill is ~100 tok/s
        return n / 100.0
    svc2 = DisaggService(model, params, n_prefill=1, n_decode=1, num_blocks=128,
                         policy="slo", prefill_time_fn=slow_prefill,
                         slo_classes={"interactive": 1.0, "batch": float("inf")},
                         device=args.device)
    admitted = rejected = 0
    for _ in range(4):
        tokens = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
        try:
            req = svc2.submit(tokens, slo_class="interactive", now=0.0)
            d = svc2.router.decisions[req.request_id]
            admitted += 1
            say(f"  {req.request_id}: admitted (projected TTFT "
                f"{d.projected_ttft_s:.2f}s <= 1.0s)")
        except AdmissionRejected as e:
            rejected += 1
            say(f"  rejected: {e}")
    if not (admitted and rejected):
        raise RuntimeError(f"SLO admission: {admitted} admitted, {rejected} rejected")

    say("== failover: decode crash mid-flight, prefill crash mid-flight ==")
    svc3 = DisaggService(model, params, n_prefill=2, n_decode=2, num_blocks=128,
                         device=args.device)
    for role in ("decode", "prefill"):
        tokens = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
        req = svc3.submit(tokens)
        attr = f"{role}_worker"
        victim = getattr(req, attr)
        getattr(svc3, f"fail_{attr}")(victim)
        if getattr(req, attr) == victim or req.retries < 1:
            raise RuntimeError(f"{req.request_id} was not re-routed off {victim}")
        verb = "re-routed to" if role == "decode" else "re-prefilled on"
        say(f"  {role} {victim} died -> {verb} {getattr(req, attr)} (retries={req.retries})")
        out = generate(svc3, req, tokens)
        say(f"  {req.request_id}: recovered -> tokens {out}")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
