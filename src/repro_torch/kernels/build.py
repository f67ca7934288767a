"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), linked into one shared library with a
plain C interface, and loaded with ``ctypes``.  The library lands in
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags, so an edited source is rebuilt on its next use and an
unchanged one is loaded as it is.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: name -> argtypes (pointers and the stream as void*,
# sizes and dtype codes as int, strides as long long).  Each returns
# cudaGetLastError().
SIGNATURES: Dict[str, Tuple] = {
    "repro_conv1d_fwd": (P, P, P, P, P, P, P, I, I, I, I, I, P),
    "repro_conv1d_bwd": (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P),
    "repro_ssd_fwd": (P, P, P, P, P, P, P, P, P, P,
                      I, I, I, I, I, I, I, I, P),
    "repro_ssd_bwd": (P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                      P, P, P, P, I, I, I, I, I, I, I, I, P),
    "repro_mamba2_decode_fwd": (P, P, P, P, P, P, P, P, P, P, P, P,
                                I, I, I, I, I, I, I, I, I, P),
    "repro_flash_fwd": (P, P, P, P, P, P, I, I, I, I, I, I,
                        L, L, L, L, L, L, L, L, L, L, L, L, I, I, I,
                        I, I, I, P, P, P, P, I, P),
    "repro_flash_bwd": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                        P),
    "repro_decode_attn_fwd": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                              I, I, L, L, L, L, L, L, L, L, I, P),
    "repro_scan1_fwd": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P),
    "repro_scan1_bwd": (P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I,
                        I, I, I, P),
    "repro_mamba1_decode_fwd": (P, P, P, P, P, P, P, P, P, P, P, P, P,
                                I, I, I, I, I, I, P),
    "repro_mamba1_decode_conv_proj_fwd": (P, P, P, P, P, P, P, P, I, I, I,
                                          I, I, P),
    "repro_mamba1_decode_state_fwd": (P, P, P, P, P, P, P, P, P, I, I, I,
                                      I, I, P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> str:
    """Compile every source in parallel, then link ``out``.  Returns the
    compilers' output (register and shared-memory use per kernel)."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + "\n" + "\n".join(log))
        tmp_so = Path(tmp) / out.name
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp_so),
                *[str(obj) for _, obj, _ in procs]]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError("nvcc link failed\n" + res.stdout + res.stderr)
        os.replace(tmp_so, out)
    return "\n".join(log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if not so.exists():
        (BUILD_DIR / "ptxas.log").write_text(_compile(so))
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def dtype_code(dtype) -> int:
    """The kernels' element-type code: 0 = float32, 1 = bfloat16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return codes[dtype]


def dtype_size(dtype) -> int:
    """Bytes of one element of a type the kernels take."""
    return 4 if dtype_code(dtype) == 0 else 2


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the memory spans of ``a`` and ``b`` meet."""
    if a.numel() == 0 or b.numel() == 0:
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + _span(b) * b.element_size()
            and b0 < a0 + _span(a) * a.element_size())


def _span(t: torch.Tensor) -> int:
    """Elements from ``t``'s first to one past its last."""
    if t.is_contiguous():
        return t.numel()
    return 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))


def destination(out, like: torch.Tensor, name: str, inputs=(),
                align: int = 16) -> torch.Tensor:
    """``out`` checked as a destination a kernel may write (contiguous,
    ``align``-byte aligned, ``like``'s shape, type and device, apart from
    every tensor of ``inputs``: those a kernel could read after another
    of its blocks wrote the destination), or a new tensor like ``like``
    when None."""
    if out is None:
        return torch.empty_like(like)
    if (out.shape != like.shape or out.dtype != like.dtype
            or out.device != like.device or not out.is_contiguous()
            or out.data_ptr() % align):
        raise ValueError(f"{name} must be a contiguous, {align}-byte "
                         f"aligned {like.dtype} {tuple(like.shape)} on "
                         f"{like.device}")
    if any(_overlap(out, t) for t in inputs):
        raise ValueError(f"{name} overlaps an input of the kernel")
    return out


@functools.lru_cache(maxsize=None)
def sm_count() -> int:
    """Streaming multiprocessors of the card the kernels launch on (the
    current CUDA device), read once; 132, an H100 SXM's, where there is no
    card, so launch plans worked out on the CPU are the H100's."""
    if not torch.cuda.is_available():
        return 132
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
