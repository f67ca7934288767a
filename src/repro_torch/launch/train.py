"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 100 --seq 512 --batch 8 --ckpt-dir /tmp/ckpt [--full-size]

The reference's flags.  Without ``--full-size`` the config is reduced
(``repro_torch.configs.reduced``); it runs on the card unless
``--device cpu`` is given.  Every registered architecture trains: the
``Trainer`` feeds an audio model (hubert-xlarge) frame features and a
vision model (llava-next-mistral-7b) patch features before its tokens,
``--seq`` positions in all."""
from __future__ import annotations

import argparse

from repro_torch.configs import reduced
from repro_torch.core.registry import get, list_archs
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    trainer = Trainer(
        cfg, OptConfig(lr=args.lr),
        TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10,
                      microbatches=args.microbatches),
        seq_len=args.seq, global_batch=args.batch, device=args.device)
    if trainer.maybe_restore():
        print(f"[restore] resumed at step {trainer.state.step}")
    state = trainer.run()
    print(f"done: {state.step} steps, final loss "
          f"{state.losses[-1]:.4f}, stragglers={state.straggler_steps}")


if __name__ == "__main__":
    main()
