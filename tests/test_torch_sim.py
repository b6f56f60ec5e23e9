"""The port's copy of the cluster simulator (``repro_torch.sim``) against
the reference's (``repro.sim``): the same seeds through both packages'
``ClusterSim`` over the ShareGPT and arXiv workloads, in every transfer
mode and with several workers, give equal results, request by request;
and ``examples/torch_pull_vs_push_sim.py`` prints what the reference's
example prints, and runs on a machine without a card."""
import dataclasses
import importlib.util
import pathlib

import pytest

from repro.configs import get_config as jax_config
from repro.sim import costs as ref_costs, events as ref_events, workloads as ref_workloads
from repro_torch.configs import get_config
from repro_torch.sim import costs, events, workloads

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
CASES = [  # (workload, qps, seconds, seed, mode, prefill workers, decode workers)
    ("SHAREGPT", 0.9, 120, 11, "pull", 1, 1),
    ("SHAREGPT", 0.9, 120, 11, "push", 1, 1),
    ("SHAREGPT", 0.9, 120, 11, "colocated", 1, 1),
    ("SHAREGPT", 2.0, 60, 3, "pull", 2, 3),
    ("ARXIV", 0.5, 120, 5, "pull", 3, 1),
]


def _run(pkg, wl, qps, secs, seed, mode, n_p, n_d):
    config, c, e, w = pkg
    cost = c.CostModel(config("mistral-large-123b"), c.H100_NODE)
    reqs = w.sample_requests(getattr(w, wl), qps=qps, duration_s=secs, seed=seed)
    res = e.ClusterSim(cost, e.SimConfig(n_prefill=n_p, n_decode=n_d, mode=mode)).run(reqs)
    return [dataclasses.astuple(r) for r in reqs], res


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[4]}-{c[5]}x{c[6]}")
def test_same_seeds_give_the_same_results(case):
    ref_reqs, ref = _run((jax_config, ref_costs, ref_events, ref_workloads), *case)
    got_reqs, got = _run((get_config, costs, events, workloads), *case)
    assert got_reqs == ref_reqs
    assert got.summary() == ref.summary()
    assert [_request(r) for r in got.requests] == [_request(r) for r in ref.requests]
    assert len(got.rejected) == len(ref.rejected)
    assert (got.pulled_tokens, got.reused_tokens) == (ref.pulled_tokens, ref.reused_tokens)


def _request(r):
    """A finished request's fields that the two packages share (its state
    as a name: the enums are each package's own)."""
    out = {k: v for k, v in vars(r).items() if not k.startswith("_")}
    out["state"] = out["state"].name if "state" in out else None
    return out


def load(name):
    spec = importlib.util.spec_from_file_location(f"ex_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_prints_what_the_reference_prints(capsys):
    load("pull_vs_push_sim").main()
    ref = capsys.readouterr().out.strip()
    got = load("torch_pull_vs_push_sim").main([])
    assert got.strip() == ref


def test_example_runs_on_the_host_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = load("torch_pull_vs_push_sim").main(["--duration", "20"])
    assert "pull" in out and "colocated" in out
