"""One run of a cell: set-up, the open-loop window, the drain, the metrics
and the comparison that decides ``correct``.

The system under test is ``repro_torch``'s ``DisaggService`` with one
prefill and one decode worker on one device, fed through ``submit`` (the
prefill dispatched by the serving loop) and driven by ``loop.tick()``.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from types import ModuleType

import numpy as np

from kvbench import traffic as traffic_mod
from kvbench.bench import ROOT, Cell, metric_reader, reference_module
from kvbench.correct import gaps, sample
from kvbench.records import Req, Run
from kvbench.weights import make_weights

__all__ = ["ProgramMissing", "import_program", "run_dims", "program_config", "cpu_config",
           "Program", "drive", "run_cell"]

CLOCK = time.perf_counter
# A traced run profiles the last this many seconds of its window, the
# decode batch long in its steady state: the rest runs as untraced runs
# do, reading the slice's events stays short, and the profiler stops only
# after the drain (stopping it holds the host for seconds).
PROFILE_SLICE_S = 8.0
# the ModelConfig fields every configuration file's "run" block states; a
# block may state more, and the program is held to each of them too
RUN_FIELDS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "num_experts", "experts_per_token", "norm_eps", "rope_theta",
              "capacity_factor", "tie_embeddings", "family")
# the keys of a "run" block that say how the program is built, not what it runs
_RUN_BUILD = ("arch", "overrides")
_ABSENT = "(no such field)"


class ProgramMissing(RuntimeError):
    pass


def import_program(root=ROOT) -> None:
    """Put the program's ``src`` on the path; raise if it is not there."""
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise ProgramMissing(f"the program (src/repro_torch) is not in {root}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))


def _as_json(v):
    """A configuration value as JSON states it: tuples as lists."""
    return [_as_json(x) for x in v] if isinstance(v, (tuple, list)) else v


def _as_config(v):
    """A JSON value as a ModelConfig field holds it: lists as tuples."""
    return tuple(_as_config(x) for x in v) if isinstance(v, list) else v


def _run_keys(run: dict) -> list[str]:
    """The ModelConfig fields a ``run`` block states: ``RUN_FIELDS``, which
    it must, and any other key but ``arch`` and ``overrides``."""
    missing = [k for k in RUN_FIELDS if k not in run]
    if missing:
        raise ValueError(f"the run block does not state {missing}")
    return [k for k in run if k not in _RUN_BUILD]


def run_dims(run: dict, model_cfg) -> dict:
    """What the metrics and the reference read (``Program.m``): each field
    the ``run`` block states, valued as ``model_cfg`` holds it."""
    keys = _run_keys(run)
    unknown = [k for k in keys if not hasattr(model_cfg, k)]
    if unknown:
        raise ValueError(f"the run block states {unknown}, which are no fields of "
                         f"{type(model_cfg).__name__}")
    return {k: getattr(model_cfg, k) for k in keys}


def program_config(config: dict):
    """The program's ``ModelConfig`` for a configuration file: its ``run``
    block's ``arch`` with its ``overrides``, held to every field the block
    states (JSON lists against tuples); raises where one differs."""
    from repro_torch.configs import get_config

    run = config["run"]
    model_cfg = dataclasses.replace(get_config(run["arch"]), **run.get("overrides", {}))
    differ = {k: (run[k], _as_json(getattr(model_cfg, k, _ABSENT))) for k in _run_keys(run)
              if run[k] != _as_json(getattr(model_cfg, k, _ABSENT))}
    if differ:
        raise ValueError(f"{run['arch']}: the program's configuration differs from the "
                         f"file's (file, program): {differ}")
    return model_cfg


def cpu_config(config: dict):
    """The configuration file's CPU test size (its ``test`` block's
    ``size``, ``ModelConfig`` keywords) as a ``ModelConfig``."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**{k: _as_config(v) for k, v in config["test"]["size"].items()})


@dataclasses.dataclass
class Program:
    """The model and its weights on the device, and how to serve them."""

    cell: Cell
    model: object
    weights: dict
    m: dict          # run_dims: what the metrics and the reference read
    device: object
    reference: ModuleType  # the configuration's plain reference

    @classmethod
    def build(cls, cell: Cell, *, seed: int, device, model_cfg=None, dtype=None) -> "Program":
        """The port's model at the configuration file's ``run`` block
        (``program_config``; or at ``model_cfg``, for tests at small widths),
        weights from ``seed`` (the reference's ``weight_rule`` first, where
        it defines one)."""
        from repro_torch.models.transformer import DecoderLM

        if model_cfg is None:
            model_cfg = program_config(cell.config)
        m = run_dims(cell.config["run"], model_cfg)
        ref = reference_module(cell.config["reference"], cell.root)
        model = DecoderLM(model_cfg, device=device)
        weights = make_weights(model.param_shapes(), seed=seed, device=model.device,
                               d_model=model_cfg.d_model, dtype=dtype,
                               rule=getattr(ref, "weight_rule", None))
        return cls(cell, model, weights, m, model.device, ref)

    def service(self, tracer=None):
        from repro_torch.serving.disagg import DisaggService

        slabs = self.cell.cell["slabs"]
        svc = DisaggService(self.model, self.weights, n_prefill=0, n_decode=0,
                            device=self.device, tracer=tracer, **self.cell.config["service"])
        svc.add_decode_worker(num_blocks=slabs["decode_blocks"])
        svc.add_prefill_worker(num_blocks=slabs["prefill_blocks"])
        return svc

    def warm_up(self, svc, seed: int) -> None:
        """The mix's shortest, median and longest prompt, with the shortest
        answer, through the service to the end: every kernel, the pull and
        the batch's joins and leaves run once before the window."""
        mix = self.cell.traffic
        lens = traffic_mod.quantile_lengths(mix["prompt"], 33)
        rng = np.random.default_rng([seed, 3])
        out = int(mix["output"]["min"])
        for p in (lens[0], lens[16], lens[-1]):
            svc.submit(rng.integers(0, self.m["vocab_size"], int(p), dtype=np.int64),
                       max_new=out - 1, dispatch="queued")
        svc.loop.run_until_idle()
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()


def drive(svc, arrivals, *, t0: float, w0: float, w1: float, need_last: bool,
          drain_max_s: float, hooks=()) -> tuple[list, float]:
    """Offer ``arrivals`` at ``t0 + offset`` whether or not the service keeps
    up, tick the serving loop, and stop once every request due inside
    [w0, w1) has its first token (and, with ``need_last``, its last) or
    has failed, or at ``w1 + drain_max_s``.  Returns [(arrival, handle,
    due)] and the drain's end."""
    subs = []
    i, n = 0, len(arrivals)
    deadline = w1 + drain_max_s

    def answered(h):
        if h.error is not None or h.failed:
            return True
        if need_last:
            return len(h.tokens) >= h.max_new + 1
        return bool(h.tokens)

    while True:
        now = CLOCK()
        while i < n and t0 + arrivals[i].offset_s <= now:
            a = arrivals[i]
            subs.append((a, svc.submit(a.prompt, max_new=a.output_len - 1, dispatch="queued"),
                         t0 + a.offset_s))
            i += 1
        for hook in hooks:
            hook(now)
        if svc.handles:
            svc.loop.tick()
        else:
            nxt = t0 + arrivals[i].offset_s if i < n else deadline
            time.sleep(max(0.0, min(nxt - CLOCK(), 0.002)))
        if now >= w1 and (now >= deadline or all(
                answered(h) for _, h, due in subs if w0 <= due < w1)):
            return subs, min(CLOCK(), deadline)


def records(subs, *, w0: float, w1: float, need_last: bool) -> list[Req]:
    out = []
    for a, h, due in subs:
        toks = list(h.tokens)
        missing = (len(toks) < a.output_len) if need_last else not toks
        out.append(Req(h.request_id, due, h.metrics.submitted_at, len(a.prompt), a.output_len,
                       toks, list(h.metrics.token_times),
                       failed=h.error is not None or h.failed
                       or (w0 <= due < w1 and missing),
                       prompt=a.prompt))
    return out


class _ProfileHook:
    def __init__(self, slice_, start_at: float, stop_at: float) -> None:
        self.slice, self.start_at, self.stop_at = slice_, start_at, stop_at
        self.state = 0

    def __call__(self, now: float) -> None:
        if self.state == 0 and now >= self.start_at:
            self.slice.start()
            self.state = 1
        elif self.state == 1 and now >= self.stop_at:
            self.slice.end()
            self.state = 2


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda", model_cfg=None, dtype=None, control: bool = False,
             log=print) -> dict:
    """One run; returns the result line's object (``compared`` last), or,
    with ``control``, that object with the float8 control's reading."""
    import torch

    from kvbench import profiling

    cc = cell.cell
    prog = Program.build(cell, seed=seed, device=device, model_cfg=model_cfg, dtype=dtype)
    on_cuda = prog.device.type == "cuda"
    if on_cuda:
        from repro_torch.kernels import build

        build.library()
    tracer = None
    if trace:
        from repro_torch.obs.trace import Tracer

        tracer = Tracer(clock=CLOCK)
    svc = prog.service(tracer)
    prog.warm_up(svc, seed)
    if trace:
        tracer.clear()
        if on_cuda:
            profiling.Slice.warm()
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    need_last = any(m["name"].startswith("ttlt_") for m in cell.end_to_end + cell.per_layer)
    lead = float(cc["lead_s"])
    arrivals = traffic_mod.schedule(
        cell.traffic, rate=float(cc["rate"]), seed=seed, vocab=prog.m["vocab_size"],
        segments=(lead, seconds, float(cc["drain_max_s"])))
    setup_s = CLOCK() - t_start
    t0 = CLOCK()
    w0, w1 = t0 + lead, t0 + lead + seconds
    hooks, slice_ = (), None
    if trace and on_cuda:
        slice_ = profiling.Slice(profiling.LaunchLog())
        hooks = (_ProfileHook(slice_, w1 - min(PROFILE_SLICE_S, seconds), w1),)
    subs, deadline = drive(svc, arrivals, t0=t0, w0=w0, w1=w1, need_last=need_last,
                           drain_max_s=float(cc["drain_max_s"]), hooks=hooks)
    prog.sync()
    if hooks and hooks[0].state >= 1:
        slice_.stop()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    reqs = records(subs, w0=w0, w1=w1, need_last=need_last)
    profile = slice_.result() if slice_ is not None and slice_.t1 is not None else None
    spans = list(tracer.spans) if trace else None
    del subs, svc
    run = Run(cell.name, w0, w1, deadline, setup_s, reqs, prog.m, spans, profile,
              prog.reference)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = metric_reader(m["name"], cell.root).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    due = run.due_in_window()
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if profile is not None:
        dev["busy_s"] = profile.busy_s
        dev["window_s"] = profile.t1 - profile.t0
    out = {"correct": False, "attempted": len(due), "failed": sum(r.failed for r in due),
           "metrics": metrics, "device": dev}
    if profile is not None:
        out["breakdown"] = profiling.breakdown(profile, spans)
    lagged = [r.submitted - r.due for r in due]
    log(f"window: {len(due)} requests due, {out['failed']} failed, generator late by "
        f"{max(lagged, default=0.0):.4f} s at most; drain ended "
        f"{deadline - w1:.2f} s after the close")

    # the comparison, after the program's state is gone
    del run, spans, profile
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    picked = sample(reqs, seed, int(cc["correct"]["sample_tokens"]))
    limits = cc["correct"]["limits"]
    t_ref = CLOCK()
    g = gaps(prog.reference, prog.weights, prog.m, picked, prog.device, control=control) \
        if picked else {"served": None}
    log(f"reference: {len(picked)} finished requests, "
        f"{g['served']['positions'] if picked else 0} served tokens, {CLOCK() - t_ref:.2f} s")
    got = g["served"] or {}
    out["correct"] = bool(got) and all(got[k] <= v for k, v in limits.items())
    out["compared"] = {k: {"value": got.get(k), "limit": v} for k, v in limits.items()}
    if control:
        out["readings"] = g
    return out
