"""Boundaries of the PyTorch/CUDA port.

* nothing under ``src/repro_torch/``, in the port's examples
  (``examples/torch_*.py``) or in ``chip_smoke.py`` imports ``jax``, the JAX package ``repro`` or ``ml_dtypes`` (the card's
  machine has none of them);
* the verbatim copies of pure-Python modules say where they came from and
  differ from their source only in ``repro.`` -> ``repro_torch.``;
* entry points default to CUDA and raise, not fall back, without a GPU;
* the CUDA kernels do not build or load at import time.
"""
import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro", "ml_dtypes")


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


PORT_FILES = (sorted(PORT.rglob("*.py")) + sorted((ROOT / "examples").glob("torch_*.py"))
              + [ROOT / "chip_smoke.py"])


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_repro_or_ml_dtypes_imports(path):
    bad = _imports(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_no_dynamic_import_of_the_reference():
    for path in PORT_FILES:
        text = path.read_text()
        assert not re.search(r"import_module\(f?[\"'](repro|jax)\b", text), path


COPIES = (sorted((PORT / "configs").glob("*.py")) + [PORT / "models" / "config.py"]
          + [PORT / "core" / f"{n}.py" for n in
             ("descriptors", "coalesce", "connection", "cluster", "pull_push")]
          + [PORT / "serving" / f"{n}.py" for n in ("blocks", "request", "handle", "loop")]
          + sorted((PORT / "obs").glob("*.py")) + sorted((PORT / "sched").glob("*.py"))
          + sorted((PORT / "fleet").glob("*.py")) + sorted((PORT / "topo").glob("*.py"))
          + [PORT / "data" / "pipeline.py"])


@pytest.mark.parametrize("path", COPIES, ids=lambda p: str(p.relative_to(PORT)))
def test_copies_track_their_source(path):
    rel = path.relative_to(PORT)
    src = ROOT / "src" / "repro" / rel
    note = f"Copy of ``src/repro/{rel.as_posix()}``"
    text = path.read_text()
    assert note in text
    # drop the provenance sentence, undo the rename: the source remains
    lines = [l for l in text.splitlines() if note not in l]
    restored = re.sub(r"\brepro_torch\.", "repro.", "\n".join(lines))
    normalise = lambda s: re.sub(r"\s+", " ", s).strip()
    assert normalise(restored) == normalise(src.read_text())


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import build_model
    from repro_torch.serving.disagg import DisaggService

    _no_cuda(monkeypatch)
    for arch in ("mamba2-780m", "hymba-1.5b"):  # the steps run on their model's device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_prefill_step(build_model(get_smoke_config(arch)))
        ssm_model = build_model(get_smoke_config(arch), device="cpu")
        ssm_params = ssm_model.init_params(0)
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
        tok, state = make_prefill_step(ssm_model)(ssm_params, batch)
        assert tok.device.type == state.ssd_state.device.type == "cpu"
        tok, _ = make_serve_step(ssm_model)(ssm_params, state, tok)
        assert tok.dtype == torch.int32
    cfg = get_smoke_config("deepseek-67b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(0, device="cuda")
    params = model.init_params(0)
    assert params["embed"]["table"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggService(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "deepseek-67b", "--smoke", "--requests", "1"])


def test_train_launcher_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.launch import train

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "yi-9b", "--smoke", "--steps", "1"])


def test_init_params_is_seeded_and_shaped():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build_model

    cfg = get_smoke_config("yi-9b")
    model = build_model(cfg, device="cpu")
    a, b, c = model.init_params(0), model.init_params(0), model.init_params(1)
    assert torch.equal(a["layers"]["attn"]["q"]["w"], b["layers"]["attn"]["q"]["w"])
    assert not torch.equal(a["layers"]["attn"]["q"]["w"], c["layers"]["attn"]["q"]["w"])
    assert a["layers"]["mlp"]["down"]["w"].shape == (cfg.num_layers, cfg.d_ff, cfg.d_model)
    assert a["embed"]["table"].shape == (cfg.padded_vocab, cfg.d_model)
    assert a["embed"]["table"].dtype == torch.bfloat16


def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "deepseek-67b", "--smoke", "--device", "cpu", "--requests", "2",
                "--prompt-len", "40", "--max-new", "2", "--quantize-transfer"])
    out = capsys.readouterr().out
    assert out.count("[serve] r") == 2 and "requests.finished = 2" in out


def test_kernels_do_not_build_at_import():
    """A fresh interpreter imports every port module; none builds or loads
    the kernel library."""
    code = ("import pkgutil, importlib, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from repro_torch.kernels import build\n"
            "assert build.library.cache_info().currsize == 0\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
    from repro_torch.kernels import build

    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == [
        "flash_prefill.cu", "kv_pull.cu", "paged_attention.cu", "ssd_scan.cu"]


def test_wrappers_refuse_other_devices_and_mixed_placement():
    from repro_torch.kernels.kv_pull.ops import kv_pull

    src = torch.zeros(2, 16, dtype=torch.uint8, device="meta")
    ids = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        kv_pull(src, src, ids, ids)
    with pytest.raises(ValueError, match="several devices"):
        kv_pull(torch.zeros(2, 16, dtype=torch.uint8), src, ids, ids)
