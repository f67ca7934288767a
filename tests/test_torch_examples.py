"""The port's serving launcher and examples, on the CPU.

* ``repro_torch.launch.serve.main`` serves every request of a reduced
  model with ``--max-new`` tokens each, and refuses an encoder-only
  architecture, as the reference's launcher does.
* ``examples/torch_quickstart.py``, ``torch_serve_batched.py`` and
  ``torch_characterize.py`` each run under ``--device cpu`` and exit 0,
  printing ``OK``.
"""
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen2.5-0.5b"])
def test_serve_launcher_serves_every_request(arch, capsys):
    done = serve.main(["--arch", arch, "--requests", "5", "--slots", "2",
                       "--prompt-len", "12", "--max-new", "6",
                       "--max-seq", "48", "--device", "cpu"])
    assert sorted(r.rid for r in done) == list(range(5))
    for r in done:
        assert r.status == "ok" and len(r.out) == 6, r
        assert all(0 <= t < 256 for t in r.out)
    assert "served 5 requests / 30 tokens" in capsys.readouterr().out


def test_serve_launcher_refuses_encoder_only():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])


@pytest.mark.parametrize("script", ["torch_quickstart.py",
                                    "torch_serve_batched.py",
                                    "torch_characterize.py"])
def test_example_runs_on_the_cpu(script):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.rstrip().endswith("OK"), res.stdout
