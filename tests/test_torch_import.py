"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and `chip_smoke.py` refuses to report without a CUDA device.

The suite's conftest imports jax into every test process, so the import
check runs in a fresh interpreter."""

import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "accelerate_tpu_torch"

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import accelerate_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "accelerate_tpu" or m.startswith("accelerate_tpu."))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "accelerate_tpu_torch.serving.engine" in out["modules"]
    assert "accelerate_tpu_torch.csrc" in out["modules"]
    for name in ("accelerator", "training", "optimizers", "state", "data",
                 "utils.dataclasses", "ops.flash_attention"):
        assert f"accelerate_tpu_torch.{name}" in out["modules"]
    assert out["leaked"] == []


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_the_jax_package(path):
    """Function-level imports included, which a plain import never runs."""
    assert not _imported_roots(path) & {"jax", "jaxlib", "accelerate_tpu"}


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_checkout", "script_alone"])
def test_chip_smoke_fails_without_cuda_or_without_the_repo(alone, tmp_path):
    """Here there is no card; alone it also has no package to import.
    Either way: a non-zero exit and no result line."""
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
