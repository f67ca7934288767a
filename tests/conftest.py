import os

import pytest

# Smoke tests and benches must see exactly 1 device (the dry-run sets its
# own 512-device flag in its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "float32")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight kernel-parity sweep — skipped in tier-1 unless "
        "REPRO_RUN_SLOW=1 (scripts/verify.sh sets it)")
    config.addinivalue_line(
        "markers",
        "cuda: runs a CUDA kernel of the PyTorch port on an NVIDIA card; "
        "skips where torch.cuda.is_available() is false")


def pytest_collection_modifyitems(config, items):
    """Tier-1 (`python -m pytest -x -q`) must stay under the CI container's
    5-minute budget: the exhaustive kernel-parity sweeps run only when
    REPRO_RUN_SLOW=1 (scripts/verify.sh); a thin parity smoke per kernel
    stays unmarked so tier-1 still exercises every code path."""
    if os.environ.get("REPRO_RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow sweep; REPRO_RUN_SLOW=1 enables")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
