"""Every bundled launch-and-assert script of the port
(`accelerate_tpu_torch/test_utils/scripts/`) in this process, as a
world of one on the CPU (the launcher's `--cpu` variable set), as
`tests/test_launched_scripts.py` runs the JAX package's in its process.
The same scripts run as real two-process worlds in
`tests/test_torch_launched_world*.py`. Each script asserts on every
rank and prints "ALL CHECKS PASSED"."""

import importlib.util

import pytest

from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.test_utils import bundled_script_path
from accelerate_tpu_torch.utils.constants import ENV_CPU

SCRIPTS = [
    "test_ops.py",
    "test_sync.py",
    "test_script.py",
    "test_distributed_data_loop.py",
    "test_uneven_inputs.py",
    "test_grad_parity.py",
    "test_cli.py",
    "test_notebook.py",
    "test_elastic_restart.py",
    "external_deps/test_checkpointing.py",
    "external_deps/test_metrics.py",
]


@pytest.fixture(autouse=True)
def _one_process_on_the_cpu(monkeypatch):
    monkeypatch.setenv(ENV_CPU, "1")
    PartialState._reset_state()
    yield
    PartialState._reset_state()


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        "bundled_" + name.removesuffix(".py").replace("/", "_"),
        bundled_script_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_in_process(script, capsys):
    _load(script).main()
    out = capsys.readouterr().out
    if script != "test_cli.py":
        assert "ALL CHECKS PASSED" in out, out
    else:
        assert "process 0 of 1" in out, out


def test_dp_training_script_in_process():
    """`train_llama_dp.py` at the tiny width: a world of one runs the
    whole batch, its replica is rank 0's, no flash launch on the CPU."""
    res = _load("train_llama_dp.py").main(
        ["--config", "tiny", "--steps", "3", "--rows", "4", "--seq", "33"])
    assert res["world"] == 1 and res["batch_rows"] == 4
    assert res["identical_to_rank0"] and res["mesh"] == {"data": 1}
    assert res["losses"][-1] < res["losses"][0]


def test_capability_markers_skip_by_hardware():
    """`require_*` skip, never mock: here there is no card and no world."""
    import torch

    from accelerate_tpu_torch.test_utils import require_cuda, \
        require_multi_gpu, require_multi_process

    for marker, present in ((require_cuda, torch.cuda.is_available()),
                            (require_multi_gpu,
                             torch.cuda.device_count() > 1),
                            (require_multi_process, False)):
        marked = marker(lambda: None)
        assert getattr(marked, "__unittest_skip__", False) is not present
