"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, nor the `safetensors` package (the card's machine has none; the
port reads and writes the format itself), nor `transformers` (HF import
takes a config object or a dict and a state dict), nor a tracker backend
(each imports its package when it is constructed), and `chip_smoke.py`
refuses to report without a CUDA device.

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
# the bundled launch-and-assert scripts, each imported by the check
SCRIPTS = sorted((PORT / "test_utils" / "scripts").glob("test_*.py")) + \
    [PORT / "test_utils" / "scripts" / "train_llama_dp.py"]
EXTERNAL = sorted((PORT / "test_utils" / "scripts" / "external_deps")
                  .glob("test_*.py"))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import accelerate_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
banned = ("jax", "safetensors", "transformers", "accelerate_tpu",
          "tensorboard", "tensorboardX", "torch.utils.tensorboard", "wandb",
          "mlflow", "comet_ml", "aim", "clearml", "dvclive")
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in banned))
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
                 "utils.dataclasses", "ops.flash_attention", "profiler",
                 "server", "server.config", "server.http",
                 "server.protocol", "server.service", "server.tokenizer",
                 "telemetry.trace", "telemetry.export", "commands.serve",
                 "checkpointing", "hooks_registry", "utils.constants",
                 "utils.manifest", "utils.other", "utils.safetensors",
                 "telemetry.aggregate", "telemetry.straggler",
                 "models.gpt2", "models.gptj", "models.gpt_neox",
                 "models.opt", "models.mixtral", "models.bert", "models.t5",
                 "models.hf_import", "parallel.moe", "utils.modeling",
                 "big_modeling", "inference", "ops.quant", "utils.offload",
                 "utils.memory", "commands.estimate", "optimizer",
                 "scheduler", "utils.operations", "native", "tracking",
                 "logging", "utils.random", "utils.imports",
                 "telemetry.cost", "telemetry.watchdog",
                 "telemetry.lockwatch", "commands.incident",
                 "utils.environment", "utils.launch", "launchers",
                 "local_sgd", "commands.launch", "commands.pod",
                 "serving.pod", "serving.pod.transfer", "serving.pod.router",
                 "serving.pod.distributed", "serving.pod.distributed.wire",
                 "serving.pod.distributed.transport",
                 "serving.pod.distributed.worker",
                 "serving.pod.distributed.droute", "serving.pod.mesh",
                 "sharding", "sharding.planner", "sharding.rules",
                 "models.tensor_parallel",
                 "commands.config.config_args", "test_utils",
                 "test_utils.training", "test_utils.worlds",
                 *(f"test_utils.scripts.{p.stem}" for p in SCRIPTS),
                 *(f"test_utils.scripts.external_deps.{p.stem}"
                   for p in EXTERNAL)):
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
    assert not _imported_roots(path) & {"jax", "jaxlib", "accelerate_tpu",
                                        "safetensors", "transformers"}


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
