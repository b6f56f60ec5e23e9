"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, bound with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The library lands in
``build/kernels/`` at the repository root, named by a hash of the sources
and flags, and is built at first use: a fresh checkout needs nothing but
``nvcc``.  The sources compile in parallel, one ``nvcc`` each, then link.

Nothing here runs at import time; ``library()`` builds on first call.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["library", "build", "check", "check_design", "on_cuda", "stream_ptr", "CSRC",
           "BUILD_DIR"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# C entry points: name -> argtypes (every entry returns a cudaError_t as int)
SIGNATURES = {
    "paged_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, ctypes.POINTER(_I), _P],
    "paged_attention_design": [ctypes.POINTER(_I), _I],
    "flash_prefill_design": [ctypes.POINTER(_I), _I],
    "flash_prefill_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                             _P],
    "kv_pull_launch": [_P, _P, _P, _P, _I, _I64, _P],
    "kv_pull_dequant_launch": [_P, _P, _P, _P, _P, _I, _I64, _I, _P],
    "ssd_scan_design": [ctypes.POINTER(_I), _I],
    "ssd_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[pathlib.Path, str]:
    """Compile (if not yet built) and return (library path, compiler log).
    The log holds ``ptxas -v``'s registers / shared memory / spills per
    kernel for a fresh build, and is empty when the library was cached."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libkvdirect_{_key()}.so"
    if lib.exists():
        return lib, ""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = pathlib.Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, "\n".join(log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


_DESIGN_CHECKED: set[str] = set()


def check_design(name: str, expected: dict[str, int], lib=None) -> None:
    """Hold a wrapper's model of its kernel (the constants its partition or
    tile choice and its CPU tests read) against the values the compiled
    kernel reports through ``<name>_design``, in ``expected``'s order.
    Raise on any difference, so that a constant changed on one side only
    stops the first launch instead of launching a grid the wrapper did not
    plan.  Checked once per kernel and process."""
    if name in _DESIGN_CHECKED:
        return
    lib = library() if lib is None else lib
    buf = (ctypes.c_int * len(expected))()
    n = getattr(lib, f"{name}_design")(buf, len(expected))
    got = dict(zip(expected, buf))
    if n != len(expected) or got != expected:
        raise RuntimeError(f"{name}: the wrapper models {expected}, the compiled kernel "
                           f"reports {got} ({n} values)")
    _DESIGN_CHECKED.add(name)


def on_cuda(name: str, *tensors) -> bool:
    """Route a wrapper call: False when every tensor lies on the CPU (the
    plain version runs), True when every tensor lies on one CUDA device
    (the kernel launches).  Anything else raises: there is no fallback."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel for device {dev}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the kernels take it."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
