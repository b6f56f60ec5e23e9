"""CPU tests of the benchmark's own parts: the traffic generator, the metric
arithmetic, ``BENCHMARK.json`` against the contract, discovery by name, and
the import rules.  None needs a card or the program's kernels."""
from __future__ import annotations

import ast
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import types

import numpy as np
import pytest

from kvbench import traffic
from kvbench.bench import FORBIDDEN, ROOT, forbidden_loaded, load_benchmark, load_cell, \
    metric_reader
from kvbench.records import Req, Run, percentile

BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
MIXES = sorted(p.stem for p in (ROOT / "kvbench" / "traffic").glob("*.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# ------------------------------------------------------------------ traffic
SEGMENTS = (15.0, 45.0, 120.0)


@pytest.mark.parametrize("mix", MIXES)
def test_traffic_deterministic_by_seed(mix):
    spec = json.loads((ROOT / "kvbench" / "traffic" / f"{mix}.json").read_text())
    a = traffic.schedule(spec, rate=0.7, segments=SEGMENTS, seed=2**31 + 11, vocab=1000)
    b = traffic.schedule(spec, rate=0.7, segments=SEGMENTS, seed=2**31 + 11, vocab=1000)
    c = traffic.schedule(spec, rate=0.7, segments=SEGMENTS, seed=2**31 + 12, vocab=1000)
    assert [x.offset_s for x in a] == [x.offset_s for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [x.offset_s for x in a] != [x.offset_s for x in c]
    # another seed offers the same work in each segment, in another order
    assert len(a) == len(c)

    def window(arr):
        return [x for x in arr if 15.0 <= x.offset_s < 60.0]
    assert len(window(a)) == len(window(c)) == round(0.7 * 45)
    def pairs(arr):
        return sorted((len(x.prompt), x.output_len) for x in window(arr))
    assert pairs(a) == pairs(c)


@pytest.mark.parametrize("mix", MIXES)
def test_traffic_within_clips_and_vocab(mix):
    spec = json.loads((ROOT / "kvbench" / "traffic" / f"{mix}.json").read_text())
    arr = traffic.schedule(spec, rate=3.0, segments=(120,), seed=5, vocab=777)
    for x in arr:
        assert spec["prompt"]["min"] <= len(x.prompt) <= spec["prompt"]["max"]
        assert spec["output"]["min"] <= x.output_len <= spec["output"]["max"]
        assert x.prompt.min() >= 0 and x.prompt.max() < 777
    offs = [x.offset_s for x in arr]
    assert offs == sorted(offs) and offs[-1] < 120


@pytest.mark.parametrize("rate", [0.15, 0.6, 2.0, 7.5])
def test_traffic_at_the_stated_rate(rate):
    spec = json.loads((ROOT / "kvbench" / "traffic" / "chat.json").read_text())
    arr = traffic.schedule(spec, rate=rate, segments=SEGMENTS, seed=9, vocab=50)
    start = 0.0
    for dur in SEGMENTS:
        inside = [x.offset_s for x in arr if start <= x.offset_s < start + dur]
        assert len(inside) == max(1, round(rate * dur)) and inside[0] == start
        start += dur


@pytest.mark.parametrize("n,block", [(36, 6), (42, 6), (14, 6), (43, 6), (12, 3), (5, 9)])
def test_balanced_order_takes_one_rank_of_each_stratum_a_block(n, block):
    rng = np.random.default_rng(2**31 + 5)
    order = traffic.balanced_order(n, block, rng)
    assert sorted(order.tolist()) == list(range(n))
    assert not np.array_equal(order, traffic.balanced_order(n, block,
                                                            np.random.default_rng(7)))
    nb = -(-n // block)
    if block >= n or n % nb:
        return
    size = n // nb                 # full strata: every block takes one of each
    for start in range(0, n, size):
        strata = sorted(int(r) // nb for r in order[start:start + size])
        assert strata == list(range(size))


def test_blocks_steady_the_window_load_across_seeds():
    """With ``block`` the decode batch a window would hold (each token
    75 ms) moves less from seed to seed than with a plain permutation."""
    spec = json.loads((ROOT / "kvbench" / "traffic" / "chat.json").read_text())
    assert "block" in spec
    plain = {k: v for k, v in spec.items() if k != "block"}
    grid = np.arange(20.0, 71.0, 0.25)

    def spread(mix):
        loads = []
        for s in range(60):
            batch = np.zeros_like(grid)
            for a in traffic.schedule(mix, rate=0.7, segments=(20.0, 51.0, 120.0),
                                      seed=2**31 + s, vocab=10):
                batch += (grid >= a.offset_s) & (grid < a.offset_s + 0.075 * a.output_len)
            loads.append(batch.mean())
        q = statistics.quantiles(loads, n=4)
        return (q[2] - q[0]) / statistics.median(loads)
    assert spread(spec) < 0.75 * spread(plain)


def test_quantile_lengths_mean_and_gaps():
    spec = {"mean": 2048, "sigma": 0.6, "min": 1, "max": 10**9}
    assert traffic.quantile_lengths(spec, 1000).mean() == pytest.approx(2048, rel=0.01)
    assert traffic.quantile_gaps(4.0, 32).mean() == pytest.approx(0.25)


# ---------------------------------------------------------- metric arithmetic
def _run(reqs, *, w0=10.0, w1=20.0, deadline=40.0):
    model = load_cell("yi9b.chat").config["run"]
    return Run("t", w0, w1, deadline, 3.5, reqs, model)


def _steady(stalls=(), stall=0.0):
    """Requests due every 0.5 s from t=0 to 30, first token 0.2 s after the
    due time, then a token every 0.1 s for 20 tokens; each stall at a time
    of ``stalls`` delays every later token by ``stall`` seconds."""
    out = []
    for i in range(60):
        due = 0.5 * i
        times = [due + 0.2 + 0.1 * k for k in range(21)]
        times = [t + stall * sum(t >= s for s in stalls) for t in times]
        out.append(Req(f"r{i}", due, due, 100, 21, list(range(21)), times))
    return out


@pytest.mark.parametrize("metric,direction", [("tbt_p95_s", +1), ("output_tokens_per_s", -1),
                                              ("ttft_p95_s", +1), ("ttlt_p95_s", +1),
                                              ("ttft_p50_s", +1), ("ttlt_p50_s", +1),
                                              ("tbt_mean_s", +1)])
def test_a_stall_inside_the_window_moves_the_metric(metric, direction):
    read = metric_reader(metric).read
    base = read(_run(_steady()))
    stalled = read(_run(_steady(stalls=[11.05 + k for k in range(8)], stall=0.3)))
    assert (stalled - base) * direction > 0


def test_steady_values():
    run = _run(_steady())
    assert metric_reader("ttft_p95_s").read(run) == pytest.approx(0.2)
    assert metric_reader("tbt_p95_s").read(run) == pytest.approx(0.1)
    assert metric_reader("ttlt_p95_s").read(run) == pytest.approx(2.2)
    assert metric_reader("ttft_p50_s").read(run) == pytest.approx(0.2)
    assert metric_reader("tbt_p50_s").read(run) == pytest.approx(0.1)
    assert metric_reader("gap_p50_s").read(run) == pytest.approx(0.1)
    assert metric_reader("tbt_mean_s").read(run) == pytest.approx(0.1)
    assert metric_reader("ttlt_p50_s").read(run) == pytest.approx(2.2)
    assert metric_reader("setup_s").read(run) == 3.5
    # 20 requests a 10 s window at 21 tokens each, in steady state
    assert metric_reader("output_tokens_per_s").read(run) == pytest.approx(42.0, rel=0.03)


def test_a_request_late_at_the_close_still_counts():
    reqs = _steady()
    late = Req("late", 19.9, 19.9, 100, 21, [1], [35.0])   # first token long after the close
    lost = Req("lost", 19.95, 19.95, 100, 21, [], [], failed=True)
    base = metric_reader("ttft_p95_s").read(_run(reqs))
    run = _run(reqs + [late, lost])
    assert len(run.due_in_window()) == 22
    vals = sorted([r.times[0] - r.due for r in reqs if 10 <= r.due < 20]
                  + [35.0 - 19.9, 40.0 - 19.95])
    assert metric_reader("ttft_p95_s").read(run) == pytest.approx(percentile(vals, 95))
    assert metric_reader("ttft_p95_s").read(run) > base


def test_percentile_is_linear_between_order_statistics():
    assert percentile([1, 2, 3, 4], 50) == 2.5
    assert percentile(range(101), 95) == 95
    assert percentile([7], 95) == 7


def test_span_and_trace_readers_without_spans_read_nothing():
    run = _run(_steady())
    for m in BENCH["per_layer"]:
        if m["source"] in ("program_span", "device_trace"):
            assert metric_reader(m["name"]).read(run) is None, m["name"]


# -------------------------------------------------------- BENCHMARK.json
def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "kvbench/run.py"] and BENCH["paths"] == ["kvbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    cells = len(BENCH["workloads"])
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    assert 1 <= cells <= 24 and sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_benchmark_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cfgs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("kvbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in e2e
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_metric_and_a_layer_metric(cell):
    c = load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names, (cell, m["name"])


# The per-layer metrics each first cell reports, in the result line's order.
FIRST_PER_LAYER = ["ttft_p95_s", "tbt_p95_s", "queue_ms_mean", "prefill_ms_per_ktok",
                   "decode_step_ms", "handoff_ms_mean", "kv_pull_roofline", "prefill_mfu",
                   "decode_mfu", "flash_prefill_roofline", "paged_attention_roofline",
                   "device_idle_pct", "step_launch_ms", "step_sync_ms", "step_rebuild_ms",
                   "step_pump_ms", "pull_ms_mean", "prefill_digest_ms_per_ktok",
                   "step_launch_idle_pct", "step_graph_pct"]


@pytest.mark.parametrize("cell,extra", [("yi9b.chat", []),
                                        ("granite-moe.chat", ["gap_p50_s"])])
def test_the_first_cells_report_the_same_per_layer_metrics(cell, extra):
    """Of the per-layer metrics the two first cells had, all but
    ``gap_p50_s`` apply without a ``workloads`` list, to each cell that
    reports what it moves; the two cells report the same ones as when each
    listed them (metrics added since may come after them)."""
    known = FIRST_PER_LAYER + ["gap_p50_s"]
    names = [m["name"] for m in load_cell(cell).per_layer if m["name"] in known]
    assert names == FIRST_PER_LAYER[:2] + extra + FIRST_PER_LAYER[2:]
    listed = {m["name"]: m["workloads"] for m in BENCH["per_layer"]
              if "workloads" in m and m["name"] in known}
    assert listed == {"gap_p50_s": ["granite-moe.chat"]}


# ----------------------------------------------------------- found by name
@pytest.mark.parametrize("cell", CELLS)
def test_each_cells_files_are_found_by_name(cell):
    c = load_cell(cell)
    assert c.config["run"] and c.traffic["prompt"] and c.cell["rate"] > 0
    assert c.cell["correct"]["limits"]
    for m in c.end_to_end + c.per_layer:
        assert callable(metric_reader(m["name"]).read)
    assert (ROOT / "kvbench" / "reference" / f"{c.config['reference']}.py").is_file()


def test_new_traffic_cell_and_metric_files_are_taken_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "kvbench", tmp_path / "kvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "kvbench" / "traffic" / "bursty.json").write_text(json.dumps(
        {"arrivals": "poisson", "prompt": {"mean": 64, "sigma": 0.5, "min": 8, "max": 128},
         "output": {"mean": 8, "sigma": 0.5, "min": 2, "max": 16}}))
    (tmp_path / "kvbench" / "cells" / "yi9b.bursty.json").write_text(
        (ROOT / "kvbench" / "cells" / "yi9b.chat.json").read_text())
    (tmp_path / "kvbench" / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(sum(r.done for r in run.requests))\n")
    bench["workloads"].append({"name": "yi9b.bursty", "config": "yi-9b", "traffic": "bursty",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves": "setup_s",
                               "workloads": ["yi9b.bursty"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("yi9b.bursty", tmp_path)
    assert cell.traffic["prompt"]["max"] == 128
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in bench["per_layer"] if "workloads" not in m] + ["requests_done"]
    arr = traffic.schedule(cell.traffic, rate=4.0, segments=(10,), seed=1, vocab=10)
    assert arr and max(len(a.prompt) for a in arr) <= 128
    assert metric_reader("requests_done", tmp_path).read(_run(_steady())) == 60.0
    assert all(m["name"] != "requests_done" for m in load_cell("yi9b.chat", tmp_path).per_layer)


# ------------------------------------------------------------------ imports
def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


SOURCES = sorted((ROOT / "kvbench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(FORBIDDEN), (path, tops & set(FORBIDDEN))


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "kvbench" / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "torch"}, (path, tops)


def test_forbidden_loaded_compares_whole_top_level_names():
    mods = {"repro_torch": None, "repro_torch.serving": None, "reprox": None,
            "jaxtyping": None, "numpy": None}
    assert forbidden_loaded(mods) == []
    mods.update({"repro.serving": None, "jax": None, "ml_dtypes": None, "benchmarks.run": None})
    assert forbidden_loaded(mods) == ["benchmarks.run", "jax", "ml_dtypes", "repro.serving"]
    assert forbidden_loaded({"flax.linen": types.ModuleType("flax.linen")}) == ["flax.linen"]


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and kvbench/, a run
    prints no result and exits with a code other than 0."""
    shutil.copytree(ROOT / "kvbench", tmp_path / "kvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "kvbench/run.py", "--workload", CELLS[0], "--seed",
                        "2147483659", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_refuses_without_a_card():
    """Here, with no CUDA device: no result, a code other than 0."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "kvbench/run.py", "--workload", CELLS[0], "--seed",
                        "2147483659", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
