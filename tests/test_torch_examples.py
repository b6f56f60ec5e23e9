"""The port's examples (``examples/torch_*.py``) on the CPU.

Each example's ``main([..., "--device", "cpu"])`` runs and its own checks
hold: served tokens equal the port's monolithic greedy generation with
the same weights, the routing, admission, failover, streaming, hedging
and affinity properties it demonstrates, and a resumed training run's
losses equal the uninterrupted run's bit for bit.  ``torch_quickstart``
moves no model, so its CONNECT and TRANSFER lines (descriptors,
transactions, coalesced reads, coalesce factor, bytes moved, modeled
time) must equal those the reference's ``examples/quickstart.py`` prints.
The serving examples' lines equal the reference examples' with token
lists and times masked (their random weights differ), and
``torch_train_lm``, given the reference's initial weights, prints its
config and its first and last losses.  On the GPU, ``chip_smoke.py`` runs the same
``main`` functions with the default ``--device cuda``.
"""
import ast
import importlib.util
import pathlib
import re
import sys

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("torch_*.py")), ids=lambda p: p.name)
def test_examples_import_torch_numpy_and_the_port_only(path):
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert mods - set(sys.stdlib_module_names) <= {"torch", "numpy", "repro_torch"}, mods


def test_quickstart_moves_what_the_reference_moves(capsys):
    load("quickstart").main()
    ref = capsys.readouterr().out.splitlines()
    got = load("torch_quickstart").main(["--device", "cpu"]).splitlines()

    def line(lines, head):
        (found,) = [ln for ln in lines if ln.startswith(head)]
        return found

    assert line(got, "CONNECT:") == line(ref, "CONNECT:")
    numbers = re.compile(r"(\d+) block-span transactions → (\d+) coalesced reads "
                         r"\((\d+)× coalescing\), ([\d.]+) MiB moved, modeled (\d+) µs")
    assert numbers.search(line(got, "TRANSFER:")).groups() == \
        numbers.search(line(ref, "TRANSFER:")).groups() == ("64", "8", "8", "4.0", "108")
    assert "  COMPLETE(r1) → prefill frees blocks" in got
    assert line(got, "VERIFY:").endswith("bit-identical. ✓")


def masked(line):
    """A line with its token lists and wall-clock times masked: the port's
    random weights are not the reference's, and times are the host's."""
    line = re.sub(r"\[[\d, ]*\]", "[…]", line)
    return re.sub(r"\d+\.\d+ms", "…ms", line)


@pytest.mark.parametrize("name,expect", [
    ("serve_disaggregated", ["(= monolithic greedy generation)", "p2 joined"]),
    ("serve_routed", ["rejected: r1", "decode d0 died", "prefill p0 died"]),
    ("serve_streaming", ["first decode token before A finished: True",
                         "twin_freed=True", "affinity hit: True"]),
])
def test_serving_examples_run_and_check_themselves(name, expect, capsys):
    """Each line the port prints begins with the reference's line (token
    lists and times masked): the same workers, routes, admissions, failover
    retries, engine counts and status sequence."""
    out = load(f"torch_{name}").main(["--device", "cpu"])
    for text in expect:
        assert text in out, text
    capsys.readouterr()
    load(name).main()
    ref = capsys.readouterr().out.splitlines()
    got = out.splitlines()
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert masked(g).startswith(masked(r)), (g, r)


def test_train_lm_resumes_bit_for_bit(capsys, monkeypatch):
    """With the reference's initial weights (converted from its PRNG key),
    the port's example prints the reference's config, and its first and
    last losses on the same batches to 2e-3; the resumed losses are the
    uninterrupted run's bit for bit."""
    import jax

    from repro.models.registry import build_model as jax_build_model
    from repro_torch.bridge import params_from_jax

    mod = load("torch_train_lm")
    build = mod.build_model

    def build_model(cfg, device):
        model = build(cfg, device=device)
        jax_model = jax_build_model(cfg)
        model.init_params = lambda seed: params_from_jax(
            jax_model.init_params(jax.random.PRNGKey(seed)), device=device)
        return model

    monkeypatch.setattr(mod, "build_model", build_model)
    out = mod.main(["--device", "cpu", "--steps", "4"])
    assert "resumed losses equal the uninterrupted run's bit for bit (1 steps)" in out
    assert "DECREASED ✓" in out
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "4"])
    load("train_lm").main()
    ref = capsys.readouterr().out.splitlines()

    def first(lines, head):
        return next(ln for ln in lines if ln.startswith(head))

    assert first(out.splitlines(), "config:") == first(ref, "config:")
    for head, pattern in (("step    0", r"step    0  loss ([\d.]+)"),
                          ("final loss", r"final loss ([\d.]+)")):
        got_loss = float(re.match(pattern, first(out.splitlines(), head)).group(1))
        ref_loss = float(re.match(pattern, first(ref, head)).group(1))
        assert abs(got_loss - ref_loss) <= 2e-3, (head, got_loss, ref_loss)


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("torch_*.py")), ids=lambda p: p.stem)
def test_examples_default_to_cuda_and_raise_without_it(path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(path.stem).main([])
