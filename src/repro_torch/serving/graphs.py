"""The decode burst on the card as one captured CUDA graph per burst shape.

The reference compiles :func:`decode_tokens` (a ``lax.scan`` of ``n``
steps) once per static ``(n, kv_bucket, rope_len, with_sentinel)``
(``make_decode_tokens``).  The port's counterpart, :class:`DecodeGraphs`,
captures the whole burst of ``n`` steps, every kernel of every layer, as
one ``torch.cuda.CUDAGraph`` per key and replays it, so a burst costs one
graph launch on the host instead of thousands of kernel launches.

The key is (batch, ``n``, ``kv_bucket``, ``rope_len``, ``with_sentinel``,
and the addresses and shapes of the cache's, the params' and the spare
state set's leaves): a graph reads and writes those buffers by address,
and keeps them alive.  The burst runs with a spare state set
(``lm.init_spare_states``), so its steps write their new states into the
spare and the cache's own leaves in turn and the cache's leaves keep
their addresses; KV rows are written in place as on the eager path.

* The first call at a key runs the burst eagerly, and that result is
  the call's.  It also makes whatever the burst creates lazily (the rope
  tables, the attention kernels' ticket counters), so capture, which
  executes nothing, creates none.  Then it captures.
* Every later call copies ``first_token`` and ``cache["pos"]`` (on the
  host or the card) into the graph's input buffers and replays it.  The
  outputs (tokens, ``pos``, ``ok``) are the graph's own buffers, written
  again by the next replay at that key.
* All keys share one memory pool (``torch.cuda.graph_pool_handle``): no
  two keys run at once.  Replays run in turn on the caller's stream; the
  attention kernels' ticket counters allow one stream only.
* The kernels' launch counters (``.launches`` on each wrapper) count
  Python calls.  Capture is not a launch: the counters are put back as
  they were after it, and each replay adds the launches the capture saw.
* With a profiler in trace mode (:mod:`repro_torch.serving.profiler`),
  the eager first call at a key is traced on its own and teaches the
  profiler the graph's sequence of device operations and their families;
  each replay is tagged with the graph's id, so a trace window attributes
  the replay's kernels position by position.  Operator scopes are
  suspended during capture: nothing a scope does may be captured.

A capture or replay error raises; there is no eager fallback on the card.
A CPU cache runs :func:`decode_tokens` itself (the plain path).  A
sharding plan's ``kv_repeat`` and ``moe_groups`` go to every burst, which
runs (and is captured) under ``plan.activations()``; the graph reads and
writes the runner's local buffers, as without a plan.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from repro_torch.core import scope as _scope
from repro_torch.core.config import ModelConfig
from repro_torch.distributed.sharding import activations, model_kwargs
from repro_torch.kernels.attn_decode.ops import (decode_attention,
                                                 decode_attention_partials)
from repro_torch.kernels.conv1d.ops import causal_conv1d
from repro_torch.kernels.decode_fused.ops import (mamba1_decode_conv_proj,
                                                  mamba1_decode_fused,
                                                  mamba1_decode_state,
                                                  mamba2_decode_fused,
                                                  mamba2_decode_heads)
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.kernels.scan1.ops import selective_scan
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.models.lm import decode_tokens
from repro_torch.models.params import tree_leaves
from repro_torch.serving.profiler import Profiler

# every kernel wrapper's launch counter: (wrapper, attribute)
LAUNCH_COUNTERS = ((causal_conv1d, "launches"), (ssd_chunked, "launches"),
                   (mamba2_decode_fused, "launches"),
                   (mamba1_decode_fused, "launches"),
                   (selective_scan, "launches"),
                   (flash_attention, "launches"),
                   (flash_attention, "ring_launches"),
                   (decode_attention, "launches"),
                   # the sharded decode step's modes
                   (decode_attention_partials, "launches"),
                   (mamba2_decode_heads, "launches"),
                   (mamba1_decode_conv_proj, "launches"),
                   (mamba1_decode_state, "launches"))


def _read_counters():
    return [getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS]


def _ptrs(tree):
    return tuple((t.data_ptr(), tuple(t.shape)) for t in tree_leaves(tree))


class _Burst:
    """One key's graph: its input buffers, its outputs, the launches its
    capture saw, and the buffers it reads and writes by address (kept
    alive)."""

    def __init__(self, batch: int, device: torch.device):
        self.tok = torch.empty((batch, 1), dtype=torch.int32, device=device)
        self.pos = torch.empty((batch,), dtype=torch.int32, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.launches: list = []
        self.keep = ()
        self.gid: Optional[str] = None    # the profiler's id of the graph


class DecodeGraphs:
    """``make_decode_tokens``'s ``decode_n``: see the module docstring.
    ``captures`` and ``replays`` count graphs captured and replayed,
    ``capture_ms`` the host time of each capture by key; ``profiler``
    (default: one that is off) learns each graph in trace mode."""

    def __init__(self, cfg: ModelConfig, profiler: Optional[Profiler] = None,
                 plan=None):
        self.cfg = cfg
        self.plan = plan
        self._kw = model_kwargs(plan)
        self.profiler = profiler if profiler is not None else Profiler()
        self._bursts: Dict[tuple, _Burst] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.captures = 0
        self.replays = 0
        self.capture_ms: Dict[tuple, float] = {}

    def __call__(self, params, cache, first_token: torch.Tensor, n: int,
                 kv_bucket: Optional[int] = None,
                 rope_len: Optional[int] = None,
                 with_sentinel: bool = False, *, spare=None):
        """As :func:`repro_torch.models.lm.decode_tokens`.  ``spare`` is the
        cache's spare state set (``lm.init_spare_states``), which a burst on
        the card needs; with it the burst updates the cache's state leaves
        in place."""
        dev = tree_leaves(cache["segments"])[0].device
        if dev.type != "cuda":
            with activations(self.plan):
                return decode_tokens(self.cfg, params, cache, first_token, n,
                                     kv_bucket=kv_bucket, rope_len=rope_len,
                                     with_sentinel=with_sentinel,
                                     _spare_states=spare, **self._kw)
        if spare is None:
            raise ValueError("a decode burst on the card needs the cache's "
                             "spare state set: lm.init_spare_states(cache)")
        key = (first_token.shape[0], n, kv_bucket, rope_len, with_sentinel,
               _ptrs(cache["segments"]), _ptrs(params), _ptrs(spare))
        burst = self._bursts.get(key)
        fresh = burst is None
        if fresh:
            burst = _Burst(first_token.shape[0], dev)
        burst.tok.copy_(first_token)
        burst.pos.copy_(cache["pos"])
        if not fresh:
            with self.profiler.replay(burst.gid):
                burst.graph.replay()
            self.replays += 1
            for (fn, attr), k in zip(LAUNCH_COUNTERS, burst.launches):
                setattr(fn, attr, getattr(fn, attr) + k)
            return burst.out

        def run():
            with activations(self.plan):
                return decode_tokens(self.cfg, params,
                                     dict(cache, pos=burst.pos), burst.tok, n,
                                     kv_bucket=kv_bucket, rope_len=rope_len,
                                     with_sentinel=with_sentinel,
                                     _spare_states=spare, **self._kw)
        with self.profiler.learn() as gid:
            result = run()
        burst.gid = gid
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        before = _read_counters()
        graph = torch.cuda.CUDAGraph()
        try:
            with _scope.suspended(), torch.cuda.graph(
                    graph, pool=self._pool, stream=self._stream):
                out = run()
        finally:
            after = _read_counters()
            for (fn, attr), k in zip(LAUNCH_COUNTERS, before):
                setattr(fn, attr, k)
        burst.graph, burst.out = graph, out
        burst.keep = (params, cache["segments"], spare)
        burst.launches = [a - b for a, b in zip(after, before)]
        self._bursts[key] = burst
        self.captures += 1
        self.capture_ms[key[:5]] = (time.perf_counter() - t0) * 1e3
        return result

    @property
    def keys(self):
        """The (batch, n, kv_bucket, rope_len, with_sentinel) of each
        captured graph."""
        return [k[:5] for k in self._bursts]


def make_decode_tokens(cfg: ModelConfig,
                       profiler: Optional[Profiler] = None, *,
                       plan=None) -> DecodeGraphs:
    """The reference's builder of the fused decode burst: ``decode_n(params,
    cache, first_token, n, kv_bucket=None, rope_len=None,
    with_sentinel=False)``, a CUDA graph per key on the card and
    :func:`decode_tokens` on the CPU, with ``plan``'s ``kv_repeat`` and
    ``moe_groups`` under its ``activations()``; ``profiler`` learns each
    graph in trace mode."""
    return DecodeGraphs(cfg, profiler, plan)
