"""Operator taxonomy: the paper's classes, and the rule that gives an op one.

Paper Sec. II-C: GEMM | non-GEMM{memory, arith, norm} | SSM-specific, plus
collectives (a distributed-runtime class the paper's single-GPU study does
not need, reported separately).  The port's copy of the reference's
``core/classify.py`` and of the scope lists and priority rule of its HLO
parser (``core/hlo_analysis.py``).  Where the reference reads HLO opcodes,
the port reads aten op names (``aten.mm.default`` is ``"mm"``; an in-place
``"add_"`` is classed as ``"add"``): the static walk
(:mod:`repro_torch.core.op_analysis`) sees them under a
``TorchDispatchMode`` and the profiler (:mod:`repro_torch.serving.profiler`)
finds them around each kernel launch in a ``torch.profiler`` trace.  A
hand-written kernel's launch has no aten op around it; its class comes from
its scope alone.
"""
from __future__ import annotations

from typing import Iterable, Union

CLASSES = ("gemm", "ssm", "memory", "arith", "norm", "collective", "other")

# Display order mirrors the paper's stacked bars (SSM at the bottom, then
# GEMM, then non-GEMM sorted by contribution).
DISPLAY_ORDER = ("ssm", "gemm", "norm", "arith", "memory", "collective",
                 "other")

# scope -> class, in the reference's priority order.  "decode_fused" is the
# serving decode step's recurrence (conv shift + SSM state update in one
# kernel): it IS the SSM kernel on the decode path.
SSM_SCOPES = ("ssd_core", "ssm_core", "conv1d", "ssm_gate", "decode_fused")
NORM_SCOPES = ("norm",)

# every scope name the reference's ``_scope_of`` knows
KNOWN_SCOPES = SSM_SCOPES + NORM_SCOPES + (
    "attn_core", "attn_decode", "qkv_proj", "o_proj", "rope", "mlp",
    "moe_route", "moe_dispatch", "moe_expert", "moe_combine",
    "moe_shared_expert", "embed", "lm_head", "ssm_in_proj", "ssm_out_proj",
    "optimizer", "loss", "grad_compress")

GEMM_OPS = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "matmul", "linear", "mv",
    "addmv", "dot", "convolution", "_convolution", "conv1d", "conv2d",
    "_grouped_mm"})

MEMORY_OPS = frozenset({
    "copy", "clone", "contiguous", "cat", "stack", "index", "index_select",
    "gather", "take", "embedding", "scatter", "scatter_add", "index_put",
    "_index_put_impl", "index_copy", "index_add", "index_fill",
    "masked_scatter", "constant_pad_nd", "pad", "roll", "flip", "repeat",
    "repeat_interleave", "slice_scatter", "select_scatter",
    "as_strided_scatter", "fill", "zero", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "new_zeros", "new_ones", "new_full",
    "scalar_tensor", "_local_scalar_dense", "lift_fresh_copy"})

ARITH_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "true_divide", "floor_divide", "neg",
    "abs", "exp", "exp2", "expm1", "log", "log2", "log1p", "rsqrt", "sqrt",
    "pow", "reciprocal", "sigmoid", "silu", "gelu", "tanh", "relu",
    "softplus", "sin", "cos", "square", "maximum", "minimum", "max", "min",
    "amax", "amin", "clamp", "clamp_min", "clamp_max", "where",
    "masked_fill", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_not", "bitwise_xor", "isfinite", "isnan", "isinf", "sign",
    "floor", "ceil", "round", "trunc", "remainder", "fmod", "erf", "atan2",
    "sum", "mean", "prod", "cumsum", "cumprod", "all", "any", "argmax",
    "argmin", "_softmax", "softmax", "_log_softmax", "log_softmax", "var",
    "std", "norm", "linalg_vector_norm", "_to_copy", "arange", "tril",
    "triu", "lerp", "addcmul", "addcdiv", "rand", "randn", "normal",
    "uniform", "exponential", "bernoulli", "randint"})

COLLECTIVE_OPS = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "broadcast",
    "_allgather_base", "_reduce_scatter_base", "allreduce_",
    "allgather_into_tensor_coalesced", "send", "recv"})

# ops that launch no device work: allocation, metadata and aliasing
ZERO_COST_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "lift_fresh", "promote_types", "result_type", "detach",
    "alias", "_reshape_alias", "resize_", "set_", "sym_size", "sym_stride",
    "sym_numel", "is_same_size", "_has_compatible_shallow_copy_type",
    "record_stream"})


def base_op(op: str) -> str:
    """An aten op's name without its in-place underscore: ``"add_"`` ->
    ``"add"``, ``"_to_copy"`` stays."""
    return op[:-1] if op.endswith("_") and not op.endswith("__") else op


def scope_path(scopes: Union[str, Iterable[str]]) -> str:
    return scopes if isinstance(scopes, str) else "/".join(scopes)


def classify(scopes: Union[str, Iterable[str]], op: str) -> str:
    """The class of aten op ``op`` (or a kernel wrapper's name) run under
    the open scopes ``scopes`` (outermost first, or a ``/``-joined path),
    in the reference's priority order: an SSM scope, a collective, a
    product, a norm scope, a memory op, an arithmetic op, else other."""
    path = scope_path(scopes)
    name = base_op(op)
    if any(s in path for s in SSM_SCOPES):
        return "ssm"
    if name in COLLECTIVE_OPS:
        return "collective"
    if name in GEMM_OPS:
        return "gemm"
    if any(s in path for s in NORM_SCOPES):
        return "norm"
    if name in MEMORY_OPS:
        return "memory"
    if name in ARITH_OPS:
        return "arith"
    return "other"


def scope_of(scopes: Union[str, Iterable[str]]) -> str:
    """The innermost known scope of a path (the reference's
    ``_scope_of``), else its last component, else ``""``."""
    parts = [p for p in scope_path(scopes).split("/") if p]
    for p in reversed(parts):
        for k in KNOWN_SCOPES:
            if k in p:
                return k
    return parts[-1] if parts else ""
