"""``BENCH_*.json`` — the per-PR benchmark trajectory.

ROADMAP asks for kernel_bench / roofline / figure-benchmark outputs to
land in a schema-versioned artifact per PR so speed regressions are
visible ACROSS PRs: ``BENCH_6.json`` is PR 6's point, PR 7 writes
``BENCH_7.json`` with the same schema, and ``load_trajectory()`` reads
the whole series back ordered by PR number.

Writers: ``benchmarks/run.py --json`` (every figure module's rows, incl.
kernel_bench), and ``benchmarks/roofline.py --bench-out`` (per-cell
roofline terms, when dry-run artifacts exist).  Both go through
``BenchTrajectory`` so the schema has one owner.

Schema (version 1)::

    {
      "schema_version": 1,
      "pr": 6,
      "source": "benchmarks.run",
      "created_unix_s": 1754700000.0,
      "entries": [
        {"name": "fig14/arxiv/qps0.5", "value": 29358808.0, "unit": "us",
         "attrs": {"derived": "transfer_frac=0.0233;..."}},
        ...
      ]
    }

``validate_bench`` is the single checker CI's bench-smoke job and the
tests call; it raises ``ValueError`` naming the first offending field.

Copy of ``src/repro/obs/bench.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import time
from typing import Any, Iterable

__all__ = ["BENCH_SCHEMA_VERSION", "BenchEntry", "BenchTrajectory",
           "bench_path", "validate_bench", "load_trajectory"]

BENCH_SCHEMA_VERSION = 1
_BENCH_RE = re.compile(r"^BENCH_(\d+)\.json$")


def bench_path(pr: int, root: str = ".") -> pathlib.Path:
    """The repo-root artifact path for one PR's benchmark point."""
    return pathlib.Path(root) / f"BENCH_{pr}.json"


@dataclasses.dataclass
class BenchEntry:
    name: str
    value: float
    unit: str = "us"
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"name": self.name, "value": float(self.value),
                "unit": self.unit, "attrs": self.attrs}


class BenchTrajectory:
    """Accumulates benchmark entries and writes one PR's schema-versioned
    ``BENCH_<pr>.json``."""

    def __init__(self, pr: int, *, source: str = "benchmarks.run") -> None:
        self.pr = pr
        self.source = source
        self.entries: list[BenchEntry] = []

    def add(self, name: str, value: float, *, unit: str = "us",
            **attrs) -> BenchEntry:
        e = BenchEntry(name, float(value), unit, dict(attrs))
        self.entries.append(e)
        return e

    def extend_rows(self, rows: Iterable) -> None:
        """Ingest ``benchmarks.common.Row`` objects (name, us_per_call,
        derived) — the figure modules' native output."""
        for r in rows:
            self.add(r.name, r.us_per_call, unit="us", derived=r.derived)

    def to_json(self) -> dict:
        return {
            "schema_version": BENCH_SCHEMA_VERSION,
            "pr": self.pr,
            "source": self.source,
            "created_unix_s": time.time(),
            "entries": [e.to_json() for e in self.entries],
        }

    def write(self, path: str | pathlib.Path | None = None, *,
              merge: bool = True) -> pathlib.Path:
        """Write the artifact.  With ``merge=True`` (default) an existing
        file at ``path`` from the SAME pr/schema keeps its entries whose
        names this run didn't produce — so ``run.py --json`` and
        ``roofline.py --bench-out`` can both feed one file without
        clobbering each other."""
        p = pathlib.Path(path) if path is not None else bench_path(self.pr)
        doc = self.to_json()
        if merge and p.exists():
            try:
                old = json.loads(p.read_text())
                validate_bench(old)
            except (ValueError, json.JSONDecodeError):
                old = None
            if old is not None and old.get("pr") == self.pr:
                mine = {e["name"] for e in doc["entries"]}
                doc["entries"].extend(
                    e for e in old["entries"] if e["name"] not in mine)
                if old.get("source") and old["source"] != self.source:
                    doc["source"] = f"{old['source']}+{self.source}"
        p.write_text(json.dumps(doc, indent=2) + "\n")
        return p


def validate_bench(doc: dict) -> dict:
    """Validate a BENCH_*.json document; raises ``ValueError`` on the
    first schema violation, returns the document unchanged otherwise."""
    if not isinstance(doc, dict):
        raise ValueError(f"bench document must be an object, got {type(doc).__name__}")
    ver = doc.get("schema_version")
    if ver != BENCH_SCHEMA_VERSION:
        raise ValueError(
            f"schema_version must be {BENCH_SCHEMA_VERSION}, got {ver!r}")
    if not isinstance(doc.get("pr"), int):
        raise ValueError(f"pr must be an int, got {doc.get('pr')!r}")
    if not isinstance(doc.get("source"), str) or not doc["source"]:
        raise ValueError(f"source must be a non-empty string, got {doc.get('source')!r}")
    if not isinstance(doc.get("created_unix_s"), (int, float)):
        raise ValueError("created_unix_s must be a number")
    entries = doc.get("entries")
    if not isinstance(entries, list) or not entries:
        raise ValueError("entries must be a non-empty list")
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise ValueError(f"entries[{i}] must be an object")
        if not isinstance(e.get("name"), str) or not e["name"]:
            raise ValueError(f"entries[{i}].name must be a non-empty string")
        if not isinstance(e.get("value"), (int, float)):
            raise ValueError(f"entries[{i}].value must be a number "
                             f"({e.get('name')})")
        if not isinstance(e.get("unit"), str) or not e["unit"]:
            raise ValueError(f"entries[{i}].unit must be a non-empty string")
        if not isinstance(e.get("attrs"), dict):
            raise ValueError(f"entries[{i}].attrs must be an object")
    return doc


def load_trajectory(root: str = ".") -> list[dict]:
    """Every valid BENCH_*.json under ``root``, ordered by PR number —
    the regression trajectory a reviewer (or a future chaos/perf PR)
    reads to see where a number moved."""
    points = []
    for p in pathlib.Path(root).glob("BENCH_*.json"):
        m = _BENCH_RE.match(p.name)
        if not m:
            continue
        try:
            doc = validate_bench(json.loads(p.read_text()))
        except (ValueError, json.JSONDecodeError):
            continue
        points.append((int(m.group(1)), doc))
    return [doc for _, doc in sorted(points, key=lambda x: x[0])]
