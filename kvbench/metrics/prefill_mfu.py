"""Model FLOPs of the prefills of the requests due inside the window
(the configuration's count, ``kvbench.flops.for_run``) over their summed
``prefill`` phase time at the card's bf16 peak, in percent."""
from kvbench.flops import for_run
from kvbench.records import PEAKS


def read(run):
    prefill_flops, _ = for_run(run)
    lc = run.lifecycle()
    flops = secs = 0
    for r in run.due_in_window():
        spans = lc.get(r.rid, {}).get("prefill")
        if spans:
            flops += prefill_flops(run.model, r.prompt_len)
            secs += sum(s.t1 - s.t0 for s in spans)
    return 100.0 * flops / (secs * PEAKS["bf16_flops"]) if secs else None
