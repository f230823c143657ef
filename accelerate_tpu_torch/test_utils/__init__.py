"""The shipped test harness (port of `accelerate_tpu/test_utils/`).

The launch-and-assert scripts under `scripts/` carry rank-level asserts
and run in any world: in one process (import the script and call its
`main()`), or as N processes through the launcher
(`launch_command_for(bundled_script_path("test_ops.py"), 2,
["--cpu"])`). Capability markers skip by hardware, never mock.
"""

from __future__ import annotations

import os
import subprocess
import sys
import unittest
from pathlib import Path

import numpy as np
import torch

# the package's parent directory, put on a child's path so a source
# checkout runs without an install
_PKG_ROOT = str(Path(__file__).resolve().parents[2])


def require_cuda(test_case):
    """Skip unless a CUDA device is present."""
    return unittest.skipUnless(torch.cuda.is_available(),
                               "test requires a CUDA device")(test_case)


def require_multi_gpu(test_case):
    """Skip unless more than one CUDA device is present."""
    return unittest.skipUnless(torch.cuda.device_count() > 1,
                               "test requires several CUDA devices")(
        test_case)


def require_multi_process(test_case):
    """Skip unless this process is one of a world of several."""
    from ..state import PartialState

    return unittest.skipUnless(PartialState.num_processes > 1,
                               "test requires a multi-process world")(
        test_case)


def are_the_same_tensors(tensor) -> bool:
    """True iff every process holds the same values."""
    from ..utils.operations import gather

    stacked = gather(tensor[None])
    return bool((stacked == stacked[0:1]).all())


def host_values(tree):
    """The tree's tensors as numpy on the host (0-d leaves as numpy
    scalars' arrays)."""
    from ..utils.operations import recursively_apply

    return recursively_apply(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x), tree)


def execute_subprocess(cmd: list[str], env: dict | None = None,
                       timeout: int = 600) -> str:
    """Run a launch command and return its standard output; raise with
    both outputs on a non-zero exit, or after `timeout` seconds (the
    whole process group is killed: a world that lost a rank blocks
    forever)."""
    import signal

    merged = dict(os.environ)
    merged["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PKG_ROOT, merged.get("PYTHONPATH", "")) if p)
    if env:
        merged.update(env)
    popen = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=merged,
                             start_new_session=True)
    try:
        out, err = popen.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(popen.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        out, err = popen.communicate()
        raise RuntimeError(
            f"command {' '.join(cmd)} hung >{timeout}s\n--- stdout ---\n"
            f"{out}\n--- stderr ---\n{err}") from None
    if popen.returncode != 0:
        raise RuntimeError(
            f"command {' '.join(cmd)} failed with code {popen.returncode}\n"
            f"--- stdout ---\n{out}\n--- stderr ---\n{err}")
    return out


def launch_command_for(script: str, num_processes: int = 1,
                       extra: list[str] | None = None) -> list[str]:
    """The launcher's command line for `script` in a world of
    `num_processes` (`extra` flags before the script)."""
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.launch"]
    if num_processes > 1:
        cmd += ["--num_processes", str(num_processes)]
    if extra:
        cmd += extra
    cmd.append(script)
    return cmd


def bundled_script_path(name: str) -> str:
    """The path of a bundled launch-and-assert script under scripts/."""
    return str(Path(__file__).parent / "scripts" / name)


def run_world(function, num_processes: int = 2, args: tuple = (),
              out_dir: str | None = None,
              timeout_s: float | None = None) -> list:
    """`function(out_dir, *args)` in a `debug_launcher` world of
    `num_processes` CPU processes (killed, raising, after `timeout_s`);
    each rank's pickled results (see `test_utils.worlds`), in rank
    order. `out_dir` defaults to a temporary directory, removed
    afterwards."""
    import pickle
    import tempfile

    from ..launchers import debug_launcher

    if out_dir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_world(function, num_processes, args, tmp, timeout_s)
    debug_launcher(function, (out_dir, *args), num_processes,
                   timeout_s=timeout_s)
    results = []
    for rank in range(num_processes):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    log = os.path.join(out_dir, "log.txt")
    if os.path.exists(log):
        with open(log) as f:
            results[0]["log"] = f.read().splitlines()
    return results
