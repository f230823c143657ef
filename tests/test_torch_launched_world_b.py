"""More of the smoke set as real two-process worlds on the CPU through
the port's launcher (see `tests/test_torch_launched_world.py`), and
`notebook_launcher` forking a world of two."""

import os
import subprocess
import sys

import pytest

from accelerate_tpu_torch.test_utils import bundled_script_path, \
    execute_subprocess, launch_command_for
from accelerate_tpu_torch.utils.constants import ENV_CPU

SCRIPTS = ["external_deps/test_checkpointing.py",
           "external_deps/test_metrics.py", "test_distributed_data_loop.py"]


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_two_process_world(script):
    out = execute_subprocess(launch_command_for(
        bundled_script_path(script), 2, ["--cpu"]), timeout=300)
    assert "ALL CHECKS PASSED" in out


def test_notebook_launcher_forks_a_world_of_two():
    """The script's `notebook_launcher(..., num_processes=2)` forks two
    ranks that join one group, then refuses once the state exists."""
    env = dict(os.environ, NOTEBOOK_NUM_PROCESSES="2", **{ENV_CPU: "1"})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    proc = subprocess.run([sys.executable,
                           bundled_script_path("test_notebook.py")],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("num_processes=2") == 2, proc.stdout
    assert "test_notebook: ALL CHECKS PASSED" in proc.stdout
