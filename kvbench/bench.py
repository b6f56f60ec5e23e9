"""Loading the benchmark's description: ``BENCHMARK.json`` and the files it
names.  Nothing here imports torch or the program."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from types import ModuleType

ROOT = pathlib.Path(__file__).resolve().parents[1]

# Top-level module names that no process of the benchmark may load: the JAX
# package, JAX itself and what only the JAX package uses.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "ml_dtypes")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with every file it names."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<mix>.json
    cell: dict            # cells/<workload>.json
    end_to_end: list[dict]  # the end-to-end metrics this cell reports
    per_layer: list[dict]   # the per-layer metrics this cell reports
    root: pathlib.Path


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, workload: str, reported: set[str] | None = None) -> bool:
    """A metric with a ``workloads`` key applies to those cells; a per-layer
    one without it to every cell that reports the end-to-end metric it
    moves; an end-to-end one without it to every cell."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_config(name: str, root: pathlib.Path = ROOT, bench: dict | None = None) -> dict:
    """The file of ``BENCHMARK.json``'s configuration ``name``."""
    bench = load_benchmark(root) if bench is None else bench
    cfgs = {c["name"]: c for c in bench["configs"]}
    if name not in cfgs:
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json; known: {sorted(cfgs)}")
    return json.loads((root / cfgs[name]["file"]).read_text())


def load_cell(name: str, root: pathlib.Path = ROOT, bench: dict | None = None) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(wl)}")
    w = wl[name]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    kv = root / "kvbench"
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"],
        config=load_config(w["config"], root, bench),
        traffic=json.loads((kv / "traffic" / f"{w['traffic']}.json").read_text()),
        cell=json.loads((kv / "cells" / f"{name}.json").read_text()),
        end_to_end=e2e, per_layer=layer, root=root)


def _load_file(path: pathlib.Path, modname: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: pathlib.Path = ROOT) -> ModuleType:
    """``kvbench/metrics/<name>.py``: a module with ``read(run) -> float |
    None``."""
    return _load_file(root / "kvbench" / "metrics" / f"{name}.py",
                      "kvbench_metric_" + name.replace(".", "_").replace("-", "_"))


def reference_module(name: str, root: pathlib.Path = ROOT) -> ModuleType:
    return _load_file(root / "kvbench" / "reference" / f"{name}.py",
                      "kvbench_reference_" + name)


def forbidden_loaded(modules=None) -> list[str]:
    """Names in ``sys.modules`` whose top-level part (before the first dot)
    is one of ``FORBIDDEN``, compared whole: ``repro_torch`` is allowed,
    ``repro`` is not."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
