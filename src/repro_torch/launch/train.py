"""Training driver — the PyTorch port of ``src/repro/launch/train.py``
(same flags and prints, plus ``--device``): real steps, checkpoint and
restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m \\
        --steps 6 --batch 4 --seq 512 --ckpt-dir build/ckpt --ckpt-every 3  # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
        --device cpu --steps 4 --batch 2 --seq 32 --ckpt-dir /tmp/ckpt --ckpt-every 2

Weights are random, from seed 0; the data is ``SyntheticLMDataset``.
Checkpoints carry (params, optimizer state, data state) in the
reference's format (``repro_torch.ckpt``); ``--resume`` continues from
the latest step.  One device: the reference's local mesh has no
counterpart here.  ``main`` returns the loss of every step it ran and
each step's wall time (the loss read back ends each step).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.tree import leaves, tree_map


def main(argv: list[str] | None = None) -> dict[str, list[float]]:
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
    args = ap.parse_args(argv)

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
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"1 devices, batch {args.batch}x{args.seq}")
    losses, step_s = [], []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in data.next_batch().items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t_step)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.perf_counter()-t0):.1f}s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1,
                            (params, opt_state, data.state()))
            print(f"[train] checkpointed step {step + 1}")
    if losses:
        print(f"[train] done: final loss {losses[-1]:.4f}")
    return {"losses": losses, "step_s": step_s}


if __name__ == "__main__":
    main()
