"""Operator scopes: the port's counterpart of the reference's
``jax.named_scope`` tags.

``with scope("norm"): ...`` marks the ops inside as one operator of the
model, under the reference's scope names (``norm``, ``mlp``, ``rope``,
``qkv_proj``, ``attn_core``, ``o_proj``, ``ssm_in_proj``, ``ssm_gate``,
``ssm_out_proj``, ``embed``, ``lm_head``, the MoE's ``moe_route``,
``moe_dispatch``, ``moe_expert``, ``moe_combine`` and
``moe_shared_expert``, and around the kernel wrappers
``ssd_core``, ``conv1d``, ``decode_fused``, ``ssm_core`` and
``attn_core``), which the taxonomy (:mod:`repro_torch.core.classify`)
reads.

A scope does nothing unless something records.  The static walk
(:mod:`repro_torch.core.op_analysis`) reads the stack of open scopes at
every aten op.  A trace window of
:class:`repro_torch.serving.profiler.Profiler` also opens a
``torch.profiler.record_function`` of the scope's name, so the trace shows
the scopes around each kernel launch.  With neither on, ``scope`` returns
one shared empty context after a single flag read: the prefill chunk is
already bound by the host.

The state is the process's, like ``torch.profiler``'s own: one walk or
trace at a time, on the thread that runs the model.
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch

_NULL = contextlib.nullcontext()


class _State:
    __slots__ = ("on", "trace", "stack")

    def __init__(self):
        self.on = 0          # walks and trace windows recording
        self.trace = 0       # of them, trace windows
        self.stack: List[str] = []


_STATE = _State()


class _Scope:
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        _STATE.stack.append(self.name)
        if _STATE.trace:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        _STATE.stack.pop()
        return False


def scope(name: str):
    """A context that marks the ops inside as the operator ``name``."""
    if not _STATE.on:
        return _NULL
    return _Scope(name)


def current() -> Tuple[str, ...]:
    """The open scopes, outermost first."""
    return tuple(_STATE.stack)


@contextlib.contextmanager
def recording(trace: bool = False):
    """Open scopes record while inside: for a static walk, or with
    ``trace`` for a ``torch.profiler`` window (each scope also opens a
    ``record_function``)."""
    _STATE.on += 1
    _STATE.trace += int(trace)
    try:
        yield
    finally:
        _STATE.on -= 1
        _STATE.trace -= int(trace)


@contextlib.contextmanager
def suspended():
    """No scope records inside (a CUDA graph capture runs no Python on
    replay, so nothing a scope does may be captured)."""
    saved = (_STATE.on, _STATE.trace)
    _STATE.on = _STATE.trace = 0
    try:
        yield
    finally:
        _STATE.on, _STATE.trace = saved

