"""Serving launcher: slot-based continuous batching over a reduced model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --requests 8 --slots 4 --max-new 16 [--full-size] [--device cpu]

The reference's flags.  Without ``--full-size`` the config is reduced
(``repro_torch.configs.reduced``); it runs on the card unless
``--device cpu`` is given.  Params are drawn from a generator seeded
with 0 on that device, the prompts from numpy's seeded with 0.  An
encoder-only architecture has nothing to decode and is refused."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import reduced
from repro_torch.core.device import resolve_device
from repro_torch.core.registry import get, list_archs
from repro_torch.models.lm import init_lm_params
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None) -> list:
    """Serve ``--requests`` random prompts; returns the finished
    requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    if cfg.family in ("encoder", "audio"):
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    dev = resolve_device(args.device)
    params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    eng = ServingEngine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                        device=dev)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(
            rid=i,
            prompt=rng.integers(2, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_new=args.max_new))
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {tokens} tokens in {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s aggregate)")
    return done


if __name__ == "__main__":
    main()
