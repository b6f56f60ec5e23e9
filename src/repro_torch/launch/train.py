"""Training driver — the PyTorch port of ``src/repro/launch/train.py``
(same flags and prints, plus ``--device`` and ``--mesh``): real steps,
checkpoint and restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m \\
        --steps 6 --batch 4 --seq 512 --ckpt-dir build/ckpt --ckpt-every 3  # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
        --device cpu --steps 4 --batch 2 --seq 32 --ckpt-dir /tmp/ckpt --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
        --device cpu --mesh 2,2 --batch 4 --seq 32                  # 4 gloo ranks

Weights are random, from seed 0; the data is ``SyntheticLMDataset``, and
an encoder-decoder's frames are drawn beside it from (seed 0, step)
(``frames_for``).
Checkpoints carry (params, optimizer state, data state) in the
reference's format (``repro_torch.ckpt``); ``--resume`` continues from
the latest step.  ``--mesh D,M`` trains under a ("data", "model") mesh of
D x M ranks spawned by ``launch.mesh.spawn`` (gloo when they share a card
or the CPU, nccl with a card a rank): the reference's ``mode="train"``
placements (FSDP over "data", TP over "model"), the global batch split
over the ranks (``launch.steps.make_train_step(mesh=)``), checkpoints of
the global leaves written by rank 0 and restored into each rank's shards;
rank 0 prints what a one-device run prints.  ``main`` returns the
loss of every step it ran and each step's wall time (the loss read back
ends each step; under a mesh, rank 0's).
"""
from __future__ import annotations

import argparse
import math
import time

from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.tree import leaves, tree_map


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-scale)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the model and its train state "
                         "(cuda, or cpu for the plain PyTorch paths)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", type=lambda v: [int(x) for x in v.split(",")], default=None,
                    help="data,model sizes: train under a mesh of that many spawned ranks")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict[str, list[float]]:
    args = _parse(argv)
    if args.mesh:
        import json
        import os
        import tempfile

        from repro_torch.launch.mesh import spawn

        with tempfile.TemporaryDirectory() as tmp:
            spawn(_train_rank, math.prod(args.mesh), os.path.join(tmp, "init"),
                  device=args.device, args=(args, tmp))
            with open(os.path.join(tmp, "result.json")) as fh:
                return json.load(fh)

    import torch

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=10, total_steps=args.steps,
                          fp32_master=cfg.fp32_master)

    params = model.init_params(0)
    opt_state = adamw_init(params, opt_cfg)
    data = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch)

    start = 0
    if args.resume and args.ckpt_dir:
        step = latest_step(args.ckpt_dir)
        if step is not None:
            # the restored state replaces the initial one: free it first, so
            # that one copy of the train state is on the device at a time
            like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                            (params, opt_state))
            del params, opt_state
            params, opt_state, dstate = restore_checkpoint(
                args.ckpt_dir, step, (*like, data.state()), device=model.device)
            data.restore({k: int(v) for k, v in dstate.items()})
            start = step
            print(f"[train] resumed from step {step}")

    step_fn = make_train_step(model, opt_cfg, remat=True)
    n_params = sum(x.numel() for x in leaves(params))
    return _loop(args, cfg, model, params, opt_state, data, step_fn, start, n_params, 1)


def frames_for(cfg, data) -> dict:
    """``data``'s next batch, with seeded frame embeddings [b, enc_seq, d]
    (f32, drawn from (0, the batch's step)) for an encoder-decoder, whose
    loss needs them."""
    import numpy as np

    step = data.step
    batch = data.next_batch()
    if cfg.is_encoder_decoder:
        rng = np.random.default_rng((0, step))
        batch["frames"] = rng.standard_normal(
            (len(batch["tokens"]), cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _loop(args, cfg, model, params, opt_state, data, step_fn, start, n_params, n_devices,
          shardings=None, rank=0):
    """The steps from ``start``, each checkpointed every ``--ckpt-every``;
    prints on rank 0 only.  Returns the losses and step times."""
    import torch

    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
        f"{n_devices} devices, batch {args.batch}x{args.seq}")
    losses, step_s = [], []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in frames_for(cfg, data).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t_step)
        if step % 10 == 0 or step == args.steps - 1:
            say(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({(time.perf_counter()-t0):.1f}s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            kw = {} if shardings is None else {"shardings": shardings}
            save_checkpoint(args.ckpt_dir, step + 1, (params, opt_state, data.state()), **kw)
            say(f"[train] checkpointed step {step + 1}")
    if losses:
        say(f"[train] done: final loss {losses[-1]:.4f}")
    return {"losses": losses, "step_s": step_s}


def _train_rank(dev, rank, world, args, out_dir):
    """One rank of ``--mesh``: the config named by the flags, ``run_rank``,
    rank 0's result to ``out_dir``."""
    import json
    import os

    import torch

    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    out = run_rank(args, cfg, dev, rank, world)
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as fh:
            json.dump(out, fh)


def run_rank(args, cfg, dev, rank, world, *, dtype=None):
    """The ``--mesh`` run on one rank of an initialised process group:
    ``cfg`` trained under the ("data", "model") mesh ``args.mesh`` from its
    seed-0 train shards (``dtype``: a cast of the weights first) or the
    latest checkpoint (``--resume``), with the same prints as one device
    from rank 0.  Returns the losses and step times."""
    from repro_torch.launch.mesh import build_params, make_mesh
    from repro_torch.launch.shardings import NamedSharding, train_state_shardings

    mesh = make_mesh(tuple(args.mesh), ("data", "model"), dev)
    model = build_model(cfg, device=dev)
    fold = cfg.fold_model_axis_into_dp
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=10, total_steps=args.steps,
                          fp32_master=cfg.fp32_master)
    full = model.param_shapes()
    p_sh, o_sh = train_state_shardings(full, mesh, fold_model=fold,
                                       fp32_master=opt_cfg.fp32_master)
    data = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch)
    d_sh = {k: NamedSharding(mesh, ()) for k in data.state()}

    step = latest_step(args.ckpt_dir) if args.resume and args.ckpt_dir else None
    if step is None:
        params = build_params(model, mesh, fold_model=fold, mode="train", dtype=dtype)
        opt_state = adamw_init(params, opt_cfg)
        start = 0
    else:
        like = (full, adamw_init(full, opt_cfg), data.state())
        params, opt_state, dstate = restore_checkpoint(
            args.ckpt_dir, step, like, device=dev, shardings=(p_sh, o_sh, d_sh))
        data.restore({k: int(v) for k, v in dstate.items()})
        start = step
        if rank == 0:
            print(f"[train] resumed from step {step}")

    step_fn = make_train_step(model, opt_cfg, remat=True, mesh=mesh)
    n_params = sum(x.numel() for x in leaves(full))
    return _loop(args, cfg, model, params, opt_state, data, step_fn, start, n_params, world,
                 shardings=(p_sh, o_sh, d_sh), rank=rank)


if __name__ == "__main__":
    main()
