"""The paper's end-to-end characterization flow (Fig. 4) on the PyTorch
port: sweep sequence lengths for a Transformer vs an SSM, report the
memory frontier, the TTFT model and the operator breakdown — the Fig.
1/5/7 story.  The counterpart of ``examples/characterize.py``.

  PYTHONPATH=src python examples/torch_characterize.py [--device cpu]

Each cost is a static walk (``repro_torch.core.op_analysis.analyze``)
of one full-size prefill on ``meta`` tensors: every hand-written kernel
counts as one kernel and nothing is allocated.  Times are the H100 time
model (``core.roofline``: each kernel max(compute, memory), no
overlap), the memory frontier the card's 80 GB.  A last line prefills
the reduced SSM on ``--device`` (default: the card) to show the path
runs there.
"""
import argparse

import torch

from repro_torch.configs import reduced
from repro_torch.core.config import H100_SXM
from repro_torch.core.device import resolve_device
from repro_torch.core.memmodel import inference_memory, max_seq_len
from repro_torch.core.op_analysis import analyze, meta_like, meta_params
from repro_torch.core.registry import get
from repro_torch.core.roofline import op_class_times
from repro_torch.models.lm import (init_lm_cache, init_lm_params,
                                   lm_prefill, prepare_params)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device of the last line (default: the card)")
args = ap.parse_args()
seqs = (1024, 4096, 16384, 32768)

TF, SSM = "qwen2.5-0.5b", "mamba2-780m"


def prefill_cost(model: str, seq: int, batch: int = 1):
    """The operator costs of one full-size prefill of ``seq`` tokens."""
    cfg = get(model)
    cache = meta_like(init_lm_cache(cfg, batch, seq, device="meta"))
    tokens = torch.zeros((batch, seq), dtype=torch.int32, device="meta")
    return analyze(lm_prefill, cfg, meta_params(cfg), tokens, cache)


def class_times(model: str, seq: int):
    return op_class_times(prefill_cost(model, seq), H100_SXM)


print(f"{'seq':>8} | {'TTFT ' + TF:>18} | {'TTFT ' + SSM:>18} | winner")
for seq in seqs:
    t1 = sum(class_times(TF, seq).values())
    t2 = sum(class_times(SSM, seq).values())
    w = TF if t1 < t2 else SSM
    print(f"{seq:>8} | {t1 * 1e3:>15.1f}ms | {t2 * 1e3:>15.1f}ms | {w}")

cap = H100_SXM.hbm_bytes
print("\nmemory @32K:",
      f"{TF}: {inference_memory(get(TF), 1, 32768).total / 1e9:.2f} GB,",
      f"{SSM}: {inference_memory(get(SSM), 1, 32768).total / 1e9:.2f} GB")
print(f"OOM frontier ({cap / 1e9:.0f}GB):",
      f"{TF}: {max_seq_len(get(TF), cap):,},",
      f"{SSM}: {max_seq_len(get(SSM), cap):,}")

at = seqs[-1]
print(f"\noperator-class shares for {SSM} @{at} (H100 SXM time model):")
ct = class_times(SSM, at)
tot = sum(ct.values())
for k, v in sorted(ct.items(), key=lambda kv: -kv[1]):
    print(f"  {k:12s} {100 * v / tot:5.1f}%")

dev = resolve_device(args.device)
cfg = reduced(get(SSM))
params = prepare_params(cfg, init_lm_params(
    cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
with torch.no_grad():
    logits, _ = lm_prefill(cfg, params,
                           torch.ones((1, 256), dtype=torch.int32,
                                      device=dev),
                           init_lm_cache(cfg, 1, 256, device=dev))
assert bool(torch.isfinite(logits).all())
print(f"\n{cfg.name} prefill on {dev}: logits {tuple(logits.shape)}")
print("OK")
