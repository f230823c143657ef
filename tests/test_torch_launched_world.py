"""Bundled launch-and-assert scripts as real two-process worlds on the
CPU, through the port's launcher (`python -m
accelerate_tpu_torch.commands.launch --cpu --num_processes 2`): gloo
process groups, every rank asserting. The rest of the smoke set is in
`tests/test_torch_launched_world_b.py`; every script also runs in one
process in `tests/test_torch_launched_scripts.py`."""

import pytest

from accelerate_tpu_torch.test_utils import bundled_script_path, \
    execute_subprocess, launch_command_for

SCRIPTS = ["test_ops.py", "test_sync.py", "test_uneven_inputs.py",
           "test_script.py"]


def run_two(script: str) -> str:
    return execute_subprocess(launch_command_for(
        bundled_script_path(script), 2, ["--cpu"]), timeout=300)


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_two_process_world(script):
    assert "ALL CHECKS PASSED" in run_two(script)
