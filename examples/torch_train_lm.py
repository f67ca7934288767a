"""End-to-end example of the PyTorch port: train a zamba2-style hybrid LM
(Mamba-2 backbone and a shared attention block) on the synthetic
needle-retrieval stream with checkpoints, then check that a fresh
trainer restored from the mid-run checkpoint replays the rest.  The
counterpart of ``examples/train_lm.py``.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--big]
      [--device cpu]

On the card every SSD, conv1d and attention call of the step runs its
hand-written forward and backward kernels; ``--device cpu`` runs their
plain versions.  The SSD chunk is 128, the kernels' instance (the
reference's example uses 64).
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np

from repro_torch.checkpoint.ckpt import restore
from repro_torch.core.config import AttnConfig, ModelConfig, SSMConfig
from repro_torch.core.memmodel import param_count
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--big", action="store_true",
                help="~100M-param config (slower per step)")
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
args = ap.parse_args()

# 25M by default, --big the ~100M configuration; a small vocab, so the
# needle stream is learnable within a few hundred steps (the CE floor for
# random tokens is ln(vocab))
d_model = 1024 if args.big else 512
CFG = ModelConfig(
    name="hybrid-100m" if args.big else "hybrid-25m", family="hybrid",
    n_layers=12, d_model=d_model, d_ff=0, vocab_size=1024,
    ssm=SSMConfig(d_state=64, headdim=64, expand=2, chunk=128),
    layer_pattern=("mamba2", "mamba2", "mamba2+shared"),
    shared_attn=AttnConfig(n_heads=8, n_kv_heads=8, head_dim=d_model // 8),
    shared_attn_d_ff=4 * d_model, tie_embeddings=False)
print(f"params: {param_count(CFG) / 1e6:.1f}M", flush=True)

ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_lm_")
opt = OptConfig(lr=3e-3, warmup_steps=30)
half = max(1, args.steps // 2)
kw = dict(seq_len=args.seq, global_batch=args.batch,
          device=args.device)
trainer = Trainer(CFG, opt, TrainerConfig(steps=args.steps, ckpt_every=half,
                                          ckpt_dir=ckpt_dir, log_every=20),
                  **kw)
state = trainer.run(log=lambda m: print(m, flush=True))
first = float(np.mean(state.losses[:20]))
last = float(np.mean(state.losses[-20:]))
print(f"loss: first-20 mean {first:.4f} -> last-20 mean {last:.4f}; "
      f"stragglers={state.straggler_steps}")
assert last < first - 0.01, "training did not learn"

# fault tolerance: a fresh trainer restored at the mid-run checkpoint
# replays the second half of the run
again = Trainer(CFG, opt, TrainerConfig(steps=args.steps, ckpt_every=0,
                                        log_every=10 ** 9), **kw)
tree = restore(ckpt_dir, {"params": again.params, "opt": again.opt_state},
               step=half)
again.params, again.opt_state = tree["params"], tree["opt"]
again.state = dataclasses.replace(again.state, step=half)
replay = again.run(log=lambda *_: None)
np.testing.assert_allclose(replay.losses, state.losses[half:], rtol=1e-5)
print(f"[fault-tolerance] restored at step {half}, replayed "
      f"{len(replay.losses)} steps identically")
print(f"checkpoints in {ckpt_dir}: {sorted(os.listdir(ckpt_dir))}")
print("OK")
