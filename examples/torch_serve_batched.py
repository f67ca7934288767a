"""Serve a small model with batched requests through the PyTorch port's
slot engine, mixing prompt lengths: batched prefill-into-slot admission
plus the fused block-decode loop (``decode_block`` tokens per host
iteration, per-slot positions, one device->host sync per block).  The
counterpart of ``examples/serve_batched.py``.

  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

On the card each decode block runs as a captured CUDA graph
(``repro_torch.serving.graphs``) through the hand-written kernels;
``--device cpu`` runs their plain versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import reduced
from repro_torch.core.device import resolve_device
from repro_torch.core.registry import get
from repro_torch.models.lm import init_lm_params
from repro_torch.serving.engine import Request, ServingEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = reduced(get("zamba2-2.7b"))
params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
eng = ServingEngine(cfg, params, slots=4, max_seq=160, decode_block=8,
                    device=dev)

rng = np.random.default_rng(7)
for i in range(10):
    plen = int(rng.integers(8, 64))
    eng.submit(Request(rid=i,
                       prompt=rng.integers(2, cfg.vocab_size,
                                           plen).astype(np.int32),
                       max_new=int(rng.integers(4, 12))))
t0 = time.perf_counter()
done = eng.run()
dt = time.perf_counter() - t0
toks = sum(len(r.out) for r in done)
print(f"{len(done)} requests, {toks} new tokens in {dt:.1f}s "
      f"({toks / dt:.1f} tok/s, block={eng.decode_block})")
for r in sorted(done, key=lambda r: r.rid)[:3]:
    print(f"  rid={r.rid} out={r.out}")
assert len(done) == 10
assert all(r.status == "ok" and len(r.out) >= r.max_new for r in done)
print("OK")
