"""Model FLOPs of the decode tokens that reached their handles inside the
window, each attending over its own context (the configuration's count,
``kvbench.flops.for_run``), over the summed time of the decode steps that
ended inside it, at the card's bf16 peak, in percent."""
from kvbench.flops import for_run
from kvbench.records import PEAKS


def read(run):
    _, decode_token_flops = for_run(run)
    flops = sum(decode_token_flops(run.model, r.prompt_len + i)
                for r in run.requests for i, t in enumerate(r.times) if i and run.in_window(t))
    secs = sum(s.t1 - s.t0 for s in run.loop_spans("tick.step") if run.in_window(s.t1))
    return 100.0 * flops / (secs * PEAKS["bf16_flops"]) if secs and flops else None
