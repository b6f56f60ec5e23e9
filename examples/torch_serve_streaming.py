"""Streaming disaggregated serving on the PyTorch port: per-request
handles over the event-driven ServeLoop (continuous batching).

Demonstrates, on the real pipeline (the port's prefill, one-sided KV
pulls through the transfer engine):
  * ``submit()`` returns a ``RequestHandle`` at once; tokens stream out as
    ``ServeLoop.tick()`` interleaves prefill dispatch, router admission,
    transfer progress and per-step decode, and the handle's status walks
    its states;
  * continuous batching: a request submitted mid-decode produces its
    first token before the earlier request finishes;
  * per-request metrics (TTFT, time to last token, time between tokens,
    KV bytes pulled) straight off the handle;
  * hedged prefill dispatch (``hedge=2``): twin prefills race, the
    primary's COMPLETE aborts the loser and frees its slab;
  * prefix-affinity routing: a repeat prefix lands on the decode worker
    still holding it.
Every request's tokens must equal a monolithic greedy generation with
the same weights.  The port of ``examples/serve_streaming.py``.

    PYTHONPATH=src python examples/torch_serve_streaming.py                # on the GPU
    PYTHONPATH=src python examples/torch_serve_streaming.py --device cpu   # plain paths
"""
import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.launch.steps import greedy_generate
from repro_torch.models.registry import build_model
from repro_torch.serving.disagg import DisaggService
from repro_torch.serving.handle import HandleStatus


def main(argv=None) -> str:
    """Run the example; returns what it printed.  Raises if a request's
    tokens differ from the monolithic ones or a demonstrated property does
    not hold."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain paths")
    args = ap.parse_args(argv)
    lines = []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    def require(ok: bool, what: str) -> None:
        if not ok:
            raise RuntimeError(what)

    cfg = get_smoke_config("deepseek-67b")
    model = build_model(cfg, device=args.device)
    params = model.init_params(0)
    rng = np.random.default_rng(0)

    def prompt():
        return rng.integers(0, cfg.vocab_size, 64).astype(np.int32)

    def monolithic(handle, tokens, max_new):
        ref = greedy_generate(model, params, tokens, max_new)
        require(handle.result() == ref,
                f"{handle.request_id}: served {handle.result()} != monolithic {ref}")

    say("== streaming handles: tokens as they land, not when the batch ends ==")
    svc = DisaggService(model, params, n_prefill=2, n_decode=2, num_blocks=128,
                        device=args.device)
    tokens = prompt()
    h = svc.submit(tokens, max_new=6)
    statuses = [h.status.value]
    say(f"  {h.request_id}: status={h.status.value} tokens={h.next_tokens()}")
    while not h.finished:
        svc.loop.tick()
        fresh = h.next_tokens()
        if statuses[-1] != h.status.value:
            statuses.append(h.status.value)
        if fresh:
            say(f"  {h.request_id}: status={h.status.value} +{fresh}")
    monolithic(h, tokens, 6)
    order = [st.value for st in HandleStatus]
    require(statuses == sorted(set(statuses), key=order.index) and "decoding" in statuses
            and statuses[-1] == "done", f"{h.request_id}: statuses {statuses} out of order")
    m = h.metrics
    say(f"  done: ttft={m.ttft_s*1e3:.1f}ms ttlt={m.ttlt_s*1e3:.1f}ms "
        f"tbt={m.tbt_s*1e3:.1f}ms kv_pulled={m.kv_bytes_pulled/2**10:.0f}KiB; "
        f"statuses {' -> '.join(statuses)}")

    say("== continuous batching: B joins while A is mid-decode ==")
    ta = prompt()
    ha = svc.submit(ta, max_new=8)
    while ha.decoded < 4:
        svc.loop.tick()
    tb = prompt()
    hb = svc.submit(tb, max_new=2)
    svc.loop.run_until_idle()
    joined_early = hb.metrics.token_times[1] < ha.metrics.last_token_at
    monolithic(ha, ta, 8)
    monolithic(hb, tb, 2)
    require(joined_early, "B's first decode token came after A finished")
    say(f"  A finished with {ha.decoded} tokens; B submitted mid-decode, "
        f"first decode token before A finished: {joined_early}")

    say("== hedged prefill: twin dispatched, loser freed at COMPLETE ==")
    th = prompt()
    hh = svc.submit(th, max_new=4, hedge=2)
    twin = svc.hedges.get(hh.request_id)
    say(f"  primary={hh.prefill_worker} twin={twin.worker_id if twin else None}")
    out = hh.result()
    monolithic(hh, th, 4)
    require(hh.metrics.hedged and hh.request_id not in svc.hedges,
            f"{hh.request_id}: hedged={hh.metrics.hedged}, twin still held")
    say(f"  tokens={out}; hedged={hh.metrics.hedged} "
        f"twin_freed={hh.request_id not in svc.hedges}")

    say("== prefix-affinity routing ==")
    svc2 = DisaggService(model, params, n_prefill=1, n_decode=2,
                         num_blocks=128, policy="prefix_affinity", device=args.device)
    shared = prompt()
    h1 = svc2.submit(shared, prefix_id="system-prompt", max_new=2)
    h1.result()
    h2 = svc2.submit(shared, prefix_id="system-prompt", max_new=2)
    hit = h1.decode_worker == h2.decode_worker
    say(f"  first -> decode@{h1.decode_worker}; repeat prefix -> "
        f"decode@{h2.decode_worker} (affinity hit: {hit})")
    monolithic(h1, shared, 2)
    monolithic(h2, shared, 2)
    require(hit, "the repeat prefix missed the decode worker holding it")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
