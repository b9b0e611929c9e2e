"""The port's package boundary: it needs torch, numpy and the standard
library, never jax, aware_tpu or (on the default path) yaml, and its
entry points run on the CUDA card unless asked for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "aware_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_and_load_pull_in_no_jax_no_aware_tpu_no_yaml():
    code = (
        "import sys, aware_tpu_torch\n"
        "emb, det = aware_tpu_torch.load(device='cpu')\n"
        "import aware_tpu_torch.ops.kernels.build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'aware_tpu', 'yaml'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_file_imports_jax_or_aware_tpu(path):
    for name in _imports(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "aware_tpu"), f"{path}: {name}"
    assert "import jax" not in path.read_text()


def test_load_without_a_device_needs_cuda():
    import aware_tpu_torch

    if torch.cuda.is_available():
        emb, _ = aware_tpu_torch.load()
        assert emb.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            aware_tpu_torch.load()


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
