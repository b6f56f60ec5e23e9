"""flash_prefill's device time in the profiled slice against its bound:
for each launch in the slice, max(operations / bf16 peak, bytes / HBM
bandwidth), with 4·d operations a visible (query, key) pair and head, and
q, k, v read once and the output written once; in percent."""
from kvbench.records import PEAKS


def visible_pairs(s, t, causal, window, prefix):
    """(query, key) pairs a query sees: query i sits at key position
    t - s + i and sees the keys up to it, within the window where there is
    one, and the always-visible prefix."""
    if not causal:
        return s * t
    if not window:
        return s * (t - s) + s * (s + 1) // 2
    n = 0
    for i in range(s):
        seen = t - s + i + 1
        n += min(window, seen) + min(prefix, max(0, seen - window))
    return n


def bound_s(c):
    pairs = visible_pairs(c["s"], c["t"], c["causal"], c["window"], c["prefix"])
    flops = 4 * c["b"] * c["h"] * c["d"] * pairs
    nbytes = (2 * c["b"] * c["s"] * c["h"] * c["d"] + 2 * c["b"] * c["t"] * c["g"] * c["d"]) \
        * c["itemsize"]
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def read(run):
    p = run.profile
    if p is None or not p.launches.get("flash_prefill"):
        return None
    dev = sum(b - a for name, a, b in p.device if "flash_prefill" in name)
    if not dev:
        return None
    return 100.0 * sum(bound_s(c) for c in p.launches["flash_prefill"]) / dev
