"""paged_attention's device time (split and combine kernels) in the
profiled slice against its bound: for each launch, each context key's k
and v read once, q read and the output written once, the block tables
and contexts read, at the HBM bandwidth (4·h·d operations a key is far
below the bf16 peak's share); in percent."""
from kvbench.records import PEAKS


def bound_s(c):
    nbytes = (c["keys"] * c["g"] * c["d"] * c["itemsize"] * 2
              + 2 * c["b"] * c["h"] * c["d"] * c["itemsize"] + c["b"] * c["per_seq"] * 4
              + c["b"] * 4)
    flops = 4 * c["h"] * c["d"] * c["keys"]
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def read(run):
    p = run.profile
    if p is None or not p.launches.get("paged_attention"):
        return None
    dev = sum(b - a for name, a, b in p.device if "paged_attention" in name)
    if not dev:
        return None
    return 100.0 * sum(bound_s(c) for c in p.launches["paged_attention"]) / dev
