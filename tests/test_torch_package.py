"""Package rules of the PyTorch port.

* Nothing under ``src/repro_torch/``, nor ``chip_smoke.py`` nor an
  ``examples/torch_*.py``, imports ``jax`` or the reference package
  ``repro``, and the port reads no ``REPRO_*`` environment variable.
* Entry points default to the card and raise where there is none.
* A kernel op on a CPU tensor runs its plain version; on a ``meta`` tensor
  (the static walk's stand-in for the card) it returns empty outputs of
  the plain version's shapes and types, launches nothing and never calls
  the plain version; its kernel path takes only CUDA tensors.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _sources():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) >= 4
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(ROOT)} imports {name}"


def test_no_repro_environment_variables():
    for path in PORT.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".cu", ".cuh"):
            assert "REPRO_" not in path.read_text(), path


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b",
                                  "llama3-8b", "mamba-130m", "gemma3-1b"])
def test_entry_points_need_cuda_by_default(arch, monkeypatch):
    from repro_torch.configs import reduced
    from repro_torch.core.registry import get
    from repro_torch.models.lm import init_lm_cache, init_lm_params
    from repro_torch.serving.engine import ServingEngine, greedy_generate
    cfg = reduced(get(arch))
    params = init_lm_params(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_lm_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_lm_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, params, slots=1, max_seq=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        greedy_generate(cfg, params, {"tokens": torch.zeros(1, 4, dtype=int)},
                        max_seq=16, gen_len=2)


def _op_inputs(device):
    b, s, h, p, g, n, k = 1, 16, 2, 16, 1, 16, 4
    c = h * p + 2 * g * n
    di, r = h * p, 4
    z = lambda *shape: torch.zeros(shape, device=device)  # noqa: E731
    return {
        "scan1": ((z(b, s, di), z(b, s, di), z(di, n), z(b, s, n),
                   z(b, s, n), z(di)), {"initial_state": z(b, di, n)}),
        "mamba1_decode": ((z(b, k - 1, di), z(b, di, n), z(b, di), z(di, k),
                           z(di), z(di, r + 2 * n), z(r, di), z(di),
                           z(di, n), z(di)), {"d_state": n, "dt_rank": r}),
        "conv1d": ((z(b, s, c), z(c, k), z(c)), {"initial_state": z(b, 3, c)}),
        "ssd": ((z(b, s, h, p), z(b, s, h), z(h), z(b, s, g, n),
                 z(b, s, g, n), z(h)), {"chunk": 16}),
        "decode": ((z(b, k - 1, c), z(b, h, p, n), z(b, c), z(c, k), z(c),
                    z(b, h), z(h), z(h), z(h)),
                   {"n_groups": g, "d_state": n, "headdim": p}),
        "flash": ((z(b, 4, s, 16), z(b, 2, s, 16), z(b, 2, s, 16)),
                  {"q_offset": 0}),
        "flash_ring": ((z(b, 4, s, 16), z(b, 2, s + 8, 16),
                        z(b, 2, s + 8, 16)),
                       {"window": 8, "q_offset": 5, "kv_wrap": 5,
                        "ring_len": 8}),
        "attn_decode": ((z(b, 4, 16), z(b, 2, s, 16), z(b, 2, s, 16)),
                        {"valid_len": 3}),
    }


def _ops():
    from repro_torch.kernels.attn_decode import ops as attn_dec_ops
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.kernels.decode_fused import ops as dec_ops
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.scan1 import ops as scan_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {
        "scan1": (scan_ops.selective_scan, scan_ops._ref,
                  "selective_scan_ref", scan_ops.selective_scan_cuda),
        "mamba1_decode": (dec_ops.mamba1_decode_fused, dec_ops._ref,
                          "mamba1_decode_fused_ref",
                          dec_ops.mamba1_decode_fused_cuda),
        "flash": (flash_ops.flash_attention, flash_ops._ref,
                  "attention_ref", flash_ops.flash_attention_cuda),
        "flash_ring": (flash_ops.flash_attention, flash_ops._ref,
                       "attention_ref", flash_ops.flash_attention_cuda),
        "attn_decode": (attn_dec_ops.decode_attention, attn_dec_ops._ref,
                        "decode_attention_ref",
                        attn_dec_ops.decode_attention_cuda),
        "conv1d": (conv_ops.causal_conv1d, conv_ops._ref,
                   "causal_conv1d_ref", conv_ops.causal_conv1d_cuda),
        "ssd": (ssd_ops.ssd_chunked, ssd_ops._ref, "ssd_chunked_ref",
                ssd_ops.ssd_chunked_cuda),
        "decode": (dec_ops.mamba2_decode_fused, dec_ops._ref,
                   "mamba2_decode_fused_ref",
                   dec_ops.mamba2_decode_fused_cuda),
    }


@pytest.mark.parametrize("name", ["conv1d", "ssd", "decode", "flash",
                                  "flash_ring", "attn_decode", "scan1",
                                  "mamba1_decode"])
def test_device_picks_the_path(name, monkeypatch):
    op, ref_mod, ref_name, kernel_path = _ops()[name]
    args, kw = _op_inputs("cpu")[name]
    before = op.launches
    plain = getattr(ref_mod, ref_name)(*args, **kw)
    got = op(*args, **kw)
    if isinstance(plain, torch.Tensor):
        got, plain = [got], [plain]
    for g, want in zip(got, plain):
        assert torch.equal(g, want)
    assert op.launches == before          # the CPU path launched nothing
    ring = getattr(op, "ring_launches", None)

    def refuse(*a, **k):
        raise AssertionError("plain version called for a device tensor")
    monkeypatch.setattr(ref_mod, ref_name, refuse)
    args, kw = _op_inputs("meta")[name]
    meta = op(*args, **kw)
    if isinstance(meta, torch.Tensor):
        meta = [meta]
    assert [(m.device.type, m.shape, m.dtype) for m in meta] == \
        [("meta", p.shape, p.dtype) for p in plain]
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel_path(*args, **kw)
    assert op.launches == before
    assert getattr(op, "ring_launches", None) == ring


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No card: exit code 1 and no result line (the driver relies on it)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert res.returncode == 1
    assert '"ok"' not in res.stdout
