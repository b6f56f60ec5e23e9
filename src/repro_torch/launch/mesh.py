"""Device meshes over ``torch.distributed`` ranks — the port of
``src/repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
process group.

Axes, as in the reference:
  * ``model`` — tensor parallel (attention inner dim / d_ff / vocab)
  * ``data``  — batch DP + FSDP for params in training + expert parallel
  * ``pod``   — pure DP across pods; only gradient all-reduce crosses DCN

A ``Mesh`` is this rank's view of the device mesh: ``shape`` maps each
axis name to its size (as a JAX mesh's ``shape`` does, so that
``launch.shardings`` ports line for line), ``coords`` gives this rank's
index on each axis, ``groups`` the process group of each axis (the ranks
that differ from this one only on that axis), from a
``torch.distributed.device_mesh.DeviceMesh``.  ``Mesh.view`` makes the
same object for any rank of a shape without process groups, for
placement alone; with ``count_only=True`` the model code also runs on it,
every collective of ``models.sharding`` returning a result of its shape
and recording itself without moving anything (``launch.dryrun``).

The collective backend is chosen once, explicitly: ``nccl`` when each
rank has a card of its own, ``gloo`` otherwise (NCCL refuses two ranks on
one device; gloo moves host memory, so collectives over CUDA tensors go
through host copies).  The choice is printed and never changed because a
call failed.

Serving under a mesh of spawned ranks (``spawn``; params from
``build_params``, the steps of ``launch.steps`` with ``mesh=``; training
under one is ``launch.train --mesh``):

    PYTHONPATH=src python -m repro_torch.launch.mesh --arch yi-9b --smoke \
        --mesh 1,4 --device cpu                                 # gloo on the CPU
    PYTHONPATH=src python -m repro_torch.launch.mesh --arch yi-9b --mesh 1,4
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import torch
import torch.distributed as dist

__all__ = ["Mesh", "build_params", "choose_backend", "init_distributed", "make_mesh",
           "make_local_mesh", "make_production_mesh", "prompt_batch", "spawn"]


@dataclasses.dataclass
class Mesh:
    axis_names: tuple[str, ...]
    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, object] = dataclasses.field(default_factory=dict)
    backend: str | None = None
    device: torch.device = torch.device("cpu")   # where this rank computes
    device_mesh: object = None
    count_only: bool = False

    @classmethod
    def view(cls, shape: dict[str, int], rank: int, *, device="cpu",
             count_only: bool = False) -> "Mesh":
        """Rank ``rank``'s view of a mesh of ``shape`` (axis name -> size,
        row-major over the names), without process groups; ``count_only``:
        collectives over it give results of their shapes and are counted,
        not run."""
        coords, rest = {}, rank
        for name in reversed(list(shape)):
            coords[name] = rest % shape[name]
            rest //= shape[name]
        return cls(tuple(shape), dict(shape), {n: coords[n] for n in shape},
                   device=torch.device(device), count_only=count_only)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def choose_backend(world_size: int, device: str | torch.device) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed(rank: int, world_size: int, init_method: str, *,
                     device: str | torch.device = "cuda") -> torch.device:
    """Join the default process group with the backend ``choose_backend``
    picks (printed), and return this rank's compute device: its own card
    under nccl, card 0 for every rank under gloo on one card, or the CPU."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    backend = choose_backend(world_size, dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    if rank == 0:
        print(f"[mesh] backend {backend}: {world_size} ranks on "
              f"{'own cards' if backend == 'nccl' else dev}", flush=True)
    return dev


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...], device="cuda") -> Mesh:
    """A mesh of ``shape`` (row-major over ``names``) over the process
    group already initialised, this rank computing on ``device``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed (or "
                           "torch.distributed.init_process_group) first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    backend = dist.get_backend()
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                          mesh_dim_names=names)
    return Mesh(names, dict(zip(names, shape)),
                {n: dm.get_local_rank(n) for n in names},
                {n: dm.get_group(n) for n in names}, backend, torch.device(device), dm)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_local_mesh(device="cuda") -> Mesh:
    """A (1, world_size) ("data", "model") mesh over the process group
    already initialised: every rank tensor parallel."""
    return make_mesh((1, dist.get_world_size()), ("data", "model"), device)


def spawn(fn, world_size: int, init_file: str, *, device="cuda", args=(),
          timeout: float = 600.0) -> None:
    """Run ``fn(mesh_device, rank, world_size, *args)`` in ``world_size``
    spawned processes joined through ``file://init_file``; each process
    calls ``init_distributed`` first and destroys its group after.  Raises
    if a rank fails or the join outlasts ``timeout`` seconds (the ranks
    still running are killed)."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(fn, world_size, init_file, str(device), args),
                             nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def _rank_main(rank, fn, world_size, init_file, device, args):
    dev = init_distributed(rank, world_size, f"file://{init_file}", device=device)
    try:
        fn(dev, rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def build_params(model, mesh, *, seed: int = 0, dtype=None, fold_model: bool = False,
                 mode: str = "serve"):
    """This rank's shards of ``model``'s seed-``seed`` params under the
    ``mode`` placements (``serve``, or ``train``: FSDP over 'data' too;
    ``dtype``: a cast of the whole tree first).  The ranks build the full
    params one after another between barriers, so that ranks sharing one
    card hold one full copy at a time, each keeping its shard."""
    from repro_torch.launch.shardings import shard_params
    from repro_torch.tree import tree_map

    params = None
    for r in range(mesh.size):
        if r == dist.get_rank():
            full = model.init_params(seed)
            if dtype is not None:
                full = tree_map(lambda t: t.to(dtype), full)
            params = shard_params(full, mesh, mode=mode, fold_model=fold_model)
            del full
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
                torch.cuda.empty_cache()
        dist.barrier()
    return params


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int = 0) -> dict:
    """A seeded batch of random prompts for ``cfg``: tokens [batch,
    prompt_len], and a VLM's image embeddings [batch, vision_tokens, d] or
    an encoder-decoder's frames [batch, enc_seq, d] (f32, N(0, 1)), all
    from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32))}
    if cfg.family == "vlm":
        out["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
    if cfg.is_encoder_decoder:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


def _serve_rank(dev, rank, world_size, args):
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import sharding
    from repro_torch.models.registry import build_model

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    mesh = make_mesh(tuple(args.mesh), ("data", "model"), dev)
    model = build_model(cfg, device=dev)
    params = build_params(model, mesh, fold_model=cfg.fold_model_axis_into_dp)
    prefill, serve = make_prefill_step(model, mesh=mesh), make_serve_step(model, mesh=mesh)
    tok, state = prefill(params, prompt_batch(cfg, args.batch, args.prompt_len))
    out = [tok.tolist()]
    for _ in range(args.max_new):
        sharding.COUNTER.reset()
        tok, state = serve(params, state, tok)
        out.append(tok.tolist())
    if rank == 0:
        print(f"[mesh] {cfg.name} on {mesh.shape} ({mesh.backend}), {state.layout}", flush=True)
        for i, seq in enumerate(zip(*out)):
            print(f"[mesh] sequence {i}: {list(seq)}", flush=True)
        print(f"[mesh] collectives of a decode step, per rank: {sharding.COUNTER.summary()}",
              flush=True)


def main(argv: list[str] | None = None) -> None:
    """Serve a batch of random prompts greedily under a mesh of spawned
    ranks (weights random from seed 0; a VLM's image embeddings and an
    encoder-decoder's frames seeded too, ``prompt_batch``) and print each
    sequence's tokens and one decode step's collectives."""
    import os
    import tempfile

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", type=lambda v: [int(x) for x in v.split(",")], default=[1, 4],
                    help="data,model sizes (their product is the number of ranks)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=4)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_serve_rank, math.prod(args.mesh), os.path.join(tmp, "init"),
              device=args.device, args=(args,))


if __name__ == "__main__":
    main()
