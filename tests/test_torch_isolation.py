"""The PyTorch port stands alone: it imports neither ``jax`` nor anything of
the ``repro`` package, and ``chip_smoke.py`` neither needs nor accepts a
machine without a card."""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    mods = list(_modules())
    assert "repro_torch.serve.scheduler" in mods and "repro_torch.weights" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported: {out.stdout.strip()}"


def test_no_source_imports_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if FORBIDDEN.search(p.read_text())]
    assert offenders == []
    assert sorted(p.name for p in (PKG / "kernels" / "csrc").glob("*.cu")) == \
        ["flash_attention.cu", "moe_backward.cu", "moe_experts.cu", "paged_attention.cu",
         "rglru_scan.cu", "ssd_scan.cu"]


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          cwd=cwd, timeout=120)


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """No result line and a non-zero exit where there is no CUDA device, and
    in a directory holding chip_smoke.py and nothing else of the repo."""
    import torch

    if not torch.cuda.is_available():
        out = _run_smoke(ROOT)
        assert out.returncode != 0 and '"ok": true' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0 and '"ok": true' not in out.stdout
