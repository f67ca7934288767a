"""Training loop with fault tolerance.

The port of the reference's ``repro.train.trainer`` on one device:
  * checkpoint/restart: atomic checkpoints via :class:`AsyncCheckpointer`
    every ``ckpt_every`` steps and at the end; :meth:`Trainer.maybe_restore`
    resumes (params, optimizer, step), and the data stream is re-seeded
    per step, so a restart replays identically;
  * straggler watchdog: a step slower than ``straggler_factor`` times the
    running median of the last 20 is logged and counted;
  * overlap: checkpoint files are written on a background thread.
The data is the synthetic stream of the model's inputs
(:func:`repro_torch.data.synthetic.synthetic_for`: the needle tokens,
an audio model's frame features, a vision model's patch features before
tokens) unless ``data`` or ``batch_fn`` is given.
Params come from the port's seeded :func:`init_lm_params` on ``device``
(None: the card); a test may replace ``params`` and ``opt_state`` with
trees carried over from the reference (:mod:`repro_torch.convert`).

``plan`` (a :class:`~repro_torch.distributed.sharding.ShardingPlan` on a
``DeviceMesh``, every rank building the same trainer) goes to the train
step, and the trainer places its trees by it: the params by the plan's
rules, ``m`` and ``v`` by ``zero1_rules(plan)`` (ZeRO-1), each batch by
its input placements.  Checkpoints hold the global values (rank 0 writes
them) and restore onto this trainer's placements, whatever mesh wrote
them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import SyntheticLM, synthetic_for
from repro_torch.models.lm import init_lm_params
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 3.0
    microbatches: int = 1
    seed: int = 0


@dataclass
class TrainerState:
    step: int = 0
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)
    straggler_steps: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, opt: OptConfig, tcfg: TrainerConfig,
                 data: Optional[SyntheticLM] = None, plan=None,
                 batch_fn: Optional[Callable[[int], Dict[str, Any]]] = None,
                 seq_len: int = 128, global_batch: int = 8, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg, self.opt, self.tcfg, self.plan = cfg, opt, tcfg, plan
        self.device = resolve_device(device)
        self.data = data or synthetic_for(cfg, seq_len, global_batch,
                                          tcfg.seed)
        self.batch_fn = batch_fn or self.data.batch
        self.state = TrainerState()
        self.ckpt = (AsyncCheckpointer(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.params = init_lm_params(cfg, gen, device=self.device)
        self._shardings = None
        if plan is not None:
            from repro_torch.distributed.sharding import (distribute_tree,
                                                          zero1_rules)
            from repro_torch.launch.steps import param_shardings
            psh = param_shardings(cfg, plan)
            zsh = param_shardings(cfg, plan, zero1_rules(plan))
            self.params = distribute_tree(self.params, psh)
            self.opt_state = init_opt_state(self.params, opt, shardings=zsh)
            self._shardings = {"params": psh,
                               "opt": {"m": zsh, "v": zsh, "step": None}}
        else:
            self.opt_state = init_opt_state(self.params, opt)
        self._step_fn = make_train_step(cfg, opt, plan,
                                        microbatches=tcfg.microbatches)

    def _place_batch(self, batch):
        from repro_torch.distributed.sharding import place
        from repro_torch.launch.steps import input_shardings
        shs = input_shardings(self.cfg, batch, self.plan)
        return {k: place(v, shs[k]) for k, v in batch.items()}

    # -- fault tolerance -----------------------------------------------------
    def maybe_restore(self) -> bool:
        if self.ckpt is None:
            return False
        step = latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return False
        tree = {"params": self.params, "opt": self.opt_state}
        restored = restore(self.tcfg.ckpt_dir, tree, step=step,
                           shardings=self._shardings)
        self.params, self.opt_state = restored["params"], restored["opt"]
        self.state.step = step
        return True

    def _checkpoint(self) -> None:
        if self.ckpt is not None:
            self.ckpt.save(self.state.step,
                           {"params": self.params, "opt": self.opt_state})

    # -- loop ------------------------------------------------------------------
    def run(self, log: Callable[[str], None] = print) -> TrainerState:
        t = self.state
        while t.step < self.tcfg.steps:
            t0 = time.perf_counter()     # full iteration: data + step
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.batch_fn(t.step).items()}
            if self.plan is not None:
                batch = self._place_batch(batch)
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            t.step += 1
            t.losses.append(loss)
            t.step_times.append(dt)
            med = float(np.median(t.step_times[-20:]))
            if len(t.step_times) > 5 and dt > self.tcfg.straggler_factor * med:
                t.straggler_steps += 1
                log(f"[straggler] step {t.step} took {dt:.2f}s "
                    f"(median {med:.2f}s) — would trigger replacement")
            if t.step % self.tcfg.log_every == 0:
                log(f"step {t.step:5d} loss {loss:.4f} "
                    f"({dt * 1e3:.0f} ms/step)")
            if self.tcfg.ckpt_every and t.step % self.tcfg.ckpt_every == 0:
                self._checkpoint()
        if self.ckpt is not None:
            self._checkpoint()
            self.ckpt.wait()
        return t
