"""kv_pull's device time in the profiled slice against its bound: for
each launch, every pulled page read once from the prefill slab and written
once into the decode slab, and each transaction's two page ids read, at
the HBM bandwidth; in percent."""
from kvbench.records import PEAKS


def bound_s(c):
    return c["n"] * (c["src_page_bytes"] + c["dst_page_bytes"] + 8) / PEAKS["hbm_bytes_per_s"]


def read(run):
    p = run.profile
    if p is None or not p.launches.get("kv_pull"):
        return None
    dev = sum(b - a for name, a, b in p.device if "kv_pull" in name and "dequant" not in name)
    if not dev:
        return None
    return 100.0 * sum(bound_s(c) for c in p.launches["kv_pull"]) / dev
