"""AdamW with optional bf16 moments — the port of
``src/repro/optim/adamw.py`` as plain functions on dicts of tensors.

The state has the parameters' structure: ``m`` and ``v`` (f32, or bf16
when ``fp32_master`` is off), ``master`` (an f32 copy of the params when
``fp32_master`` is on) and ``step`` (int32).  The arithmetic is the
reference's, op for op, in f32: warmup then cosine, clipping by the
global norm, bias-corrected moments, and weight decay added to the
update.  ``torch.optim.AdamW`` is not used: it orders the update and
applies weight decay otherwise.

What differs: ``adamw_update`` updates params and state IN PLACE and
returns the same dicts.  A train state of a few billion parameters takes
most of one card, so a second copy of the moments cannot exist even for
a moment; each leaf is updated in slices of ``CHUNK`` elements, which
bounds the f32 temporaries (an elementwise update does not depend on the
slicing).

Under a device mesh the params, moments and master copy are this rank's
shards (placed alike: ``launch.shardings.opt_state_sharding``) and the
update runs on them in place; only the clip needs the whole: the global
norm sums each leaf's f32 squares over the mesh axes its spec splits it
on (one all-reduce an axis for all leaves), counting a replicated copy
once.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import sharding
from repro_torch.tree import leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule", "global_norm"]

CHUNK = 1 << 26  # elements a slice of the in-place update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    fp32_master: bool = True


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), in f32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr_peak * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def _slices(t: torch.Tensor):
    return t.view(-1).split(CHUNK)


def global_norm(tree, split=None) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX's order) of each leaf's f32 sum of
    squares.  ``split``: under a mesh, for each leaf (JAX's order) the mesh
    axes its spec splits it over (``launch.shardings.split_axes``): each
    leaf's squares are summed over those axes (the mesh context's
    collectives), a replicated leaf counted once."""
    sq = [sum(torch.sum(torch.square(c.float())) for c in _slices(x.contiguous()))
          for x in leaves(tree)]
    if split is not None and sharding.get_mesh() is not None:
        v = torch.stack(sq)
        for axis in sharding.get_mesh().axis_names:
            flags = [axis in a for a in split]
            if any(flags) and sharding.axis_size(axis) > 1:
                mask = torch.tensor(flags, device=v.device)
                v = torch.where(mask, sharding.all_reduce(torch.where(mask, v, 0.0), axis), v)
        sq = list(v.unbind(0))
    total = sq[0]
    for x in sq[1:]:
        total = total + x
    return torch.sqrt(total)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    mom_dtype = torch.float32 if cfg.fp32_master else torch.bfloat16
    dev = leaves(params)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mom_dtype, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=mom_dtype, device=p.device), params),
    }
    if cfg.fp32_master:
        state["master"] = tree_map(lambda p: p.detach().float().clone(), params)
    return state


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, *, split=None):
    """One step -> (params, state, {"grad_norm", "lr"}); params and state
    are updated in place (see the module's docstring).  ``split``: under a
    mesh, each leaf's split axes (``global_norm``)."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)

    gnorm = global_norm(grads, split)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    base = state["master"] if cfg.fp32_master else params
    for p, g, m, v, b in zip(leaves(params), leaves(grads), leaves(state["m"]),
                             leaves(state["v"]), leaves(base)):
        for ps, gs, ms, vs, bs in zip(_slices(p), _slices(g.contiguous()), _slices(m),
                                      _slices(v), _slices(b)):
            g32 = gs.float() * scale
            new_m = cfg.b1 * ms.float() + (1 - cfg.b1) * g32
            new_v = cfg.b2 * vs.float() + (1 - cfg.b2) * g32 * g32
            u = (new_m / b1c) / (torch.sqrt(new_v / b2c) + cfg.eps) \
                + cfg.weight_decay * bs.float()
            new_b = bs.float() - lr * u
            ms.copy_(new_m)
            vs.copy_(new_v)
            if cfg.fp32_master:
                bs.copy_(new_b)
            ps.copy_(new_b)  # cast to the param's dtype
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
