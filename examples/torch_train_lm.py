"""Train a small LM on the PyTorch port, with checkpoint and crash-resume.

Uses the yi-9b family widened to 6 layers of d_model 512 with a 32768
vocabulary (the config, data and schedule of the reference's
``examples/train_lm.py``): loss descent, a checkpoint at
the middle step, and a crash-resume from it.  The run goes on from the
live state to the last step; then the "crash" rebuilds everything from
disk (fresh wrong weights, restored params, AdamW state and data
position) and replays the second half, whose losses must equal the
uninterrupted run's bit for bit.  The attention forward is the
flash_prefill kernel on the GPU (the backward plain torch).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]               # on the GPU
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 6      # plain paths
"""
import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init


def main(argv=None) -> str:
    """Run the example; returns what it printed.  Raises if the loss does
    not fall or the resumed losses differ from the uninterrupted ones."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain paths")
    args = ap.parse_args(argv)
    lines = []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    # the reference's config: the yi smoke family widened
    cfg = dataclasses.replace(
        get_smoke_config("yi-9b"),
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=2,
        d_ff=1408, vocab_size=32768,
    )
    model = build_model(cfg, device=args.device)
    say(f"config: {cfg.describe()}")

    opt_cfg = AdamWConfig(lr_peak=3e-3, warmup_steps=20, total_steps=args.steps)
    params = model.init_params(0)
    opt_state = adamw_init(params, opt_cfg)
    data = SyntheticLMDataset(cfg.vocab_size, seq_len=128, batch_size=8)
    step_fn = make_train_step(model, opt_cfg, remat=False)

    def run(steps, params, opt_state):
        losses = []
        for step in steps:
            batch = {k: torch.as_tensor(v, device=model.device)
                     for k, v in data.next_batch().items()}
            params, opt_state, m = step_fn(params, opt_state, batch)
            losses.append(float(m["loss"]))
            if step % 20 == 0:
                say(f"step {step:4d}  loss {losses[-1]:.4f}  ({time.time()-t0:.0f}s)")
        return losses, params, opt_state

    mid = args.steps // 2
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as ckpt_dir:
        losses, params, opt_state = run(range(mid + 1), params, opt_state)
        save_checkpoint(ckpt_dir, mid, (params, opt_state, data.state()))
        say(f"--- checkpointed at step {mid}; running on to step {args.steps - 1} ---")
        rest, params, opt_state = run(range(mid + 1, args.steps), params, opt_state)
        say(f"--- simulating crash+restart at step {mid} ---")
        # crash: rebuild everything from disk
        del params, opt_state
        params = model.init_params(1)  # wrong weights
        opt_state = adamw_init(params, opt_cfg)
        s = latest_step(ckpt_dir)
        params, opt_state, dstate = restore_checkpoint(
            ckpt_dir, s, (params, opt_state, data.state()))
        data.restore({k: int(v) for k, v in dstate.items()})
        say(f"--- resumed from step {s} ---")
        resumed, params, opt_state = run(range(s + 1, args.steps), params, opt_state)
    if resumed != rest:
        raise RuntimeError(f"resumed losses {resumed} != uninterrupted {rest}")
    say(f"resumed losses equal the uninterrupted run's bit for bit ({len(rest)} steps)")
    losses += resumed
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"final loss {losses[-1]:.4f} not below the first {losses[0]:.4f}")
    say(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f}) — DECREASED ✓")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
