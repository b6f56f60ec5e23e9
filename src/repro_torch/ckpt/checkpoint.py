"""Checkpoint save/restore — the port of ``src/repro/ckpt/checkpoint.py``,
with the reference's on-disk format, so that either framework reads the
other's checkpoints:

* ``step_XXXXXXXX/`` holding ``manifest.json`` (step, a description of
  the tree, each leaf's shape and numpy dtype name, ``bfloat16`` for
  bf16) and ``arrays.msgpack``, the MessagePack encoding of the list of the
  leaves' raw bytes, leaves in JAX's flatten order (``repro_torch.tree``);
* written into ``.tmp_step_XXXXXXXX/`` and renamed (atomic publish),
  keeping the newest ``keep`` steps.

The card's machine has no MessagePack package, so this module writes and
reads the one subset the format uses (an array header, then a bin 8/16/32
header and the bytes of each leaf) itself, streaming leaf by leaf: a
train state of a few billion parameters never exists twice in host
memory.  One extension: a MessagePack bin holds at most 2**32 - 1 bytes,
and a leaf larger than that (an f32 moment of a stacked expert weight
above 1.07e9 elements) is written as several consecutive bin items, its
manifest entry counting them in ``parts``.  Such a checkpoint is the
port's only (the reference cannot write that leaf at all); every other
checkpoint is byte for byte what the reference's writer gives.

Under a device mesh both ways take ``shardings``, a tree of
``launch.shardings.NamedSharding`` of the tree's structure (what placed
each leaf; anything for a Python scalar): ``save_checkpoint`` writes the
GLOBAL leaves, each gathered by its spec leaf by leaf, one writer (rank
0), then a barrier; ``restore_checkpoint`` reads the global leaves and
keeps this rank's shard of each under ``shardings``, which may be of
another mesh than the one that wrote them (the reference's
``restore_checkpoint(..., shardings=)``).  The files are the one-device
format, so either framework, on any mesh or none, reads them.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import shutil
import struct

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import describe, leaves, unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_MANIFEST = "manifest.json"
_DATA = "arrays.msgpack"
_BIN_MAX = (1 << 32) - 1


# -------------------------------------------------------- MessagePack subset
def _header(kind: str, n: int) -> bytes:
    """The MessagePack header of an array of ``n`` items or a bin of ``n``
    bytes, in the smallest form, as the reference's writer gives it."""
    if kind == "array":
        if n < 16:
            return bytes([0x90 | n])
        return b"\xdc" + struct.pack(">H", n) if n < 1 << 16 else b"\xdd" + struct.pack(">I", n)
    if n < 1 << 8:
        return b"\xc4" + struct.pack(">B", n)
    if n < 1 << 16:
        return b"\xc5" + struct.pack(">H", n)
    if n <= _BIN_MAX:
        return b"\xc6" + struct.pack(">I", n)
    raise ValueError(f"a MessagePack bin holds at most {_BIN_MAX} bytes, got {n}")


_ARRAY = {0xDC: (">H", "array16"), 0xDD: (">I", "array32")}
_BIN = {0xC4: (">B", "bin8"), 0xC5: (">H", "bin16"), 0xC6: (">I", "bin32")}


def _read_header(f, kinds: dict[int, tuple[str, str]], what: str) -> int:
    tag = f.read(1)
    if not tag:
        raise ValueError(f"checkpoint payload ends before {what}")
    t = tag[0]
    if what == "array" and t & 0xF0 == 0x90:
        return t & 0x0F
    if t not in kinds:
        raise ValueError(f"unexpected MessagePack tag {t:#x} where {what} was expected")
    fmt, _ = kinds[t]
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]


# ------------------------------------------------------------------- leaves
def _leaf_array(x) -> np.ndarray:
    """A leaf as a host numpy array: bf16 tensors as their 16-bit pattern
    (numpy has no bf16 type of its own)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if not isinstance(x, torch.Tensor):
        return str(np.asarray(x).dtype)
    if x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=x.dtype).numpy().dtype)


def _read_bytes(f, n: int) -> np.ndarray:
    buf = np.empty(n, dtype=np.uint8)
    if f.readinto(memoryview(buf)) != n:
        raise ValueError("checkpoint payload ends inside a leaf")
    return buf


@torch.no_grad()
def save_checkpoint(ckpt_dir: str | pathlib.Path, step: int, tree, *,
                    keep: int = 3, shardings=None) -> pathlib.Path:
    """Write ``tree`` as step ``step`` (atomic publish, the newest ``keep``
    steps kept).  ``shardings``: under a mesh, what placed each leaf; every
    rank calls this, the leaves are gathered whole one by one, rank 0
    writes, and a barrier ends the call."""
    flat = leaves(tree)
    shards = [None] * len(flat) if shardings is None else leaves(shardings)
    if len(flat) != len(shards):
        raise ValueError(f"{len(flat)} leaves, {len(shards)} shardings")
    writer = shardings is None or dist.get_rank() == 0
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"

    metas = []
    n_items = 0
    for x, sh in zip(flat, shards):
        if isinstance(x, torch.Tensor):
            shape = list(x.shape) if sh is None else sh.whole_shape(x.shape)
            nbytes = int(np.prod(shape)) * x.element_size()
        else:
            nbytes, shape = np.asarray(x).nbytes, list(np.shape(x))
        meta = {"shape": shape, "dtype": _dtype_name(x)}
        parts = max(1, -(-nbytes // _BIN_MAX))
        if parts > 1:
            meta["parts"] = parts
        metas.append(meta)
        n_items += parts
    if writer:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    with open(tmp / _DATA, "wb") if writer else contextlib.nullcontext() as f:
        if writer:
            f.write(_header("array", n_items))
        for x, sh in zip(flat, shards):
            if isinstance(x, torch.Tensor) and sh is not None:
                x = sh.gather(x)
            if not writer:
                continue
            raw = memoryview(_leaf_array(x).reshape(-1).view(np.uint8))
            for lo in range(0, max(len(raw), 1), _BIN_MAX):
                part = raw[lo:lo + _BIN_MAX]
                f.write(_header("bin", len(part)))
                f.write(part)
    if writer:
        manifest = {"step": step, "treedef": describe(tree), "leaves": metas}
        (tmp / _MANIFEST).write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish

        # retention
        steps = sorted(p for p in ckpt_dir.glob("step_*"))
        for old in steps[:-keep]:
            shutil.rmtree(old)
    if shardings is not None:
        dist.barrier()
    return final


def latest_step(ckpt_dir: str | pathlib.Path) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    steps = sorted(ckpt_dir.glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def _tensor(buf: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(buf.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(buf.view(np.dtype(dtype)))
    return t.reshape(shape).to(device)


def restore_checkpoint(ckpt_dir: str | pathlib.Path, step: int, like_tree, *,
                       device=None, shardings=None):
    """Restore into the structure of ``like_tree``: each leaf a tensor of
    its saved dtype, on ``device`` where the matching leaf of ``like_tree``
    is a tensor (default: that tensor's device; ``like_tree`` may then hold
    meta tensors, so that the state never exists twice on the card), on
    the CPU where it is a Python scalar.  ``shardings``: a tree of
    ``NamedSharding`` of ``like_tree``'s structure, whose leaves hold the
    GLOBAL shapes: each leaf is read whole and this rank's shard of it
    kept (cut on the host, then moved)."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((path / _MANIFEST).read_text())
    like = leaves(like_tree)
    metas = manifest["leaves"]
    if len(metas) != len(like):
        raise ValueError(f"checkpoint has {len(metas)} leaves, target tree {len(like)}")
    shards = leaves(shardings) if shardings is not None else [None] * len(like)
    out = []
    with open(path / _DATA, "rb") as f:
        n_items = _read_header(f, _ARRAY, "array")
        if n_items != sum(m.get("parts", 1) for m in metas):
            raise ValueError(f"checkpoint payload has {n_items} items, its manifest "
                             f"{sum(m.get('parts', 1) for m in metas)}")
        for meta, ref, sh in zip(metas, like, shards):
            chunks = [_read_bytes(f, _read_header(f, _BIN, "bin"))
                      for _ in range(meta.get("parts", 1))]
            buf = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
            shape = tuple(meta["shape"])
            like_shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) else np.shape(ref)
            if shape != tuple(like_shape):
                raise ValueError(f"shape mismatch {shape} vs {tuple(like_shape)}")
            if not isinstance(ref, torch.Tensor):
                dev = "cpu"
            else:
                dev = ref.device if device is None else device
            if sh is None or not isinstance(ref, torch.Tensor):
                out.append(_tensor(buf, meta["dtype"], shape, dev))
            else:
                out.append(sh.shard(_tensor(buf, meta["dtype"], shape, "cpu")).to(dev))
    return unflatten(like_tree, out)
