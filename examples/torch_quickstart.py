"""Quickstart of the PyTorch port: build a model from the registry, run
forward / prefill / decode, sample a burst, and characterize it with the
paper's flow.  The counterpart of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card the model's SSD, conv1d and decode-step calls run their
hand-written kernels; ``--device cpu`` runs their plain versions.  The
characterization walks the full-size mamba2-2.7b on ``meta`` tensors
(nothing is allocated) and models each kernel on the H100.
"""
import argparse

import torch

from repro_torch.configs import reduced
from repro_torch.core.config import H100_SXM
from repro_torch.core.device import resolve_device
from repro_torch.core.op_analysis import analyze, meta_params
from repro_torch.core.registry import get, list_archs
from repro_torch.core.roofline import op_class_times
from repro_torch.models.lm import (decode_tokens, init_lm_cache,
                                   init_lm_params, lm_forward, lm_prefill,
                                   prepare_params)
from repro_torch.serving.engine import greedy_generate

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
args = ap.parse_args()
dev = resolve_device(args.device)

print("registered architectures:", ", ".join(list_archs()))

# 1. pick an arch (reduced) and run it
full = get("mamba2-2.7b")
cfg = reduced(full)
params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
tokens = torch.ones((2, 64), dtype=torch.int32, device=dev)
with torch.no_grad():
    logits = lm_forward(cfg, prepare_params(cfg, params), tokens,
                        train=False)
print(f"forward: logits {tuple(logits.shape)}")

# 2. generate with the serving path: prefill + the fused decode loop, the
# next token selected on the device (no host sync per token)
with torch.no_grad():
    out, _ = greedy_generate(cfg, params, {"tokens": tokens}, max_seq=96,
                             gen_len=8, device=dev)
print(f"generated: {tuple(out.shape)} -> {out[0].tolist()}")

# 2b. the same prompt, sampled at temperature 0.8 from a seeded generator
with torch.no_grad():
    prepared = prepare_params(cfg, params)
    lg, cache = lm_prefill(cfg, prepared, tokens,
                           init_lm_cache(cfg, 2, 96, device=dev))
    first = torch.argmax(lg[..., :cfg.vocab_size], -1).to(torch.int32)
    sampled, _ = decode_tokens(
        cfg, prepared, cache, first, 7, temperature=0.8,
        generator=torch.Generator(device=dev).manual_seed(1))
print(f"sampled (T=0.8): {sampled[0].tolist()}")
assert int(sampled.max()) < cfg.vocab_size

# 3. the paper's characterization flow: one forward of the full-size
# model walked on meta tensors -> operator-class breakdown on the H100
cost = analyze(lm_forward, full, meta_params(full),
               torch.zeros((2, 64), dtype=torch.int32, device="meta"),
               train=False)
times = op_class_times(cost, H100_SXM)
total = sum(times.values())
print(f"operator-class latency shares ({full.name}, H100 SXM time model, "
      f"{total * 1e3:.3f} ms):")
for clazz, t in sorted(times.items(), key=lambda kv: -kv[1]):
    print(f"  {clazz:12s} {100 * t / total:5.1f}%")
print("OK")
