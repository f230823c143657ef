"""Launch environment and command assembly (port of
`accelerate_tpu/utils/launch.py`).

The protocol: topology in torchrun's variables (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`), which
`PartialState` reads; the launcher's config flags under the port's
`ACCELERATE_TORCH_*` prefix (`utils/constants.py`), read where the
reference reads its own. The reference's TPU-pod ssh builders belong to
a later slice (ROADMAP.md, queue 1 item 8d).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Callable

from .constants import (
    ENV_CPU,
    ENV_DEBUG_MODE,
    ENV_GRAD_ACCUM_STEPS,
    ENV_LOCAL_RANK,
    ENV_LOCAL_WORLD_SIZE,
    ENV_MASTER_ADDR,
    ENV_MASTER_PORT,
    ENV_MESH_SHAPE,
    ENV_MIXED_PRECISION,
    ENV_RANK,
    ENV_WORLD_SIZE,
)


def _flag(args: Any, name: str, default: Any = None) -> Any:
    value = getattr(args, name, None)
    return default if value is None else value


def prepare_launch_env(args: Any) -> dict[str, str]:
    """The variables every launched process gets from the config flags;
    only flags the user set are emitted, so a child's defaults apply."""
    env: dict[str, str] = {}
    mixed_precision = _flag(args, "mixed_precision")
    if mixed_precision is not None:
        env[ENV_MIXED_PRECISION] = str(mixed_precision)
    mesh_shape = _flag(args, "mesh_shape")
    if mesh_shape:
        env[ENV_MESH_SHAPE] = str(mesh_shape)
    grad_accum = _flag(args, "gradient_accumulation_steps")
    if grad_accum is not None:
        env[ENV_GRAD_ACCUM_STEPS] = str(grad_accum)
    if _flag(args, "debug", False):
        env[ENV_DEBUG_MODE] = "1"
    if _flag(args, "cpu", False):
        env[ENV_CPU] = "1"
    return env


def rank_env(rank: int, world: int, local_rank: int, local_world: int,
             master_addr: str, master_port: int) -> dict[str, str]:
    """torchrun's variables for one process of a world."""
    return {
        ENV_RANK: str(rank),
        ENV_WORLD_SIZE: str(world),
        ENV_LOCAL_RANK: str(local_rank),
        ENV_LOCAL_WORLD_SIZE: str(local_world),
        ENV_MASTER_ADDR: master_addr,
        ENV_MASTER_PORT: str(master_port),
    }


def build_script_cmd(args: Any, extra_args: list[str] | None = None
                     ) -> list[str]:
    """[python, script, ...], honouring `--module` and `--no_python`."""
    script = args.training_script
    script_args = list(getattr(args, "training_script_args", []) or [])
    if extra_args:
        script_args += extra_args
    if getattr(args, "module", False):
        return [sys.executable, "-m", script, *script_args]
    if getattr(args, "no_python", False):
        return [script, *script_args]
    return [sys.executable, script, *script_args]


def merged_child_env(extra: dict[str, str]) -> dict[str, str]:
    env = dict(os.environ)
    env.update(extra)
    return env


def monitor_world(procs, *, is_alive: Callable, exitcode: Callable,
                  terminate: Callable, grace_s: float = 1.0,
                  poll_s: float = 0.05):
    """Watch a world of processes; at the first failure give the others
    `grace_s` to finish, then terminate the survivors (a rank that died
    leaves its peers blocked in a collective). Takes accessors, so
    `multiprocessing.Process` and `subprocess.Popen` both fit. Returns
    (failed, the ranks it terminated): those are casualties of the
    clean-up, not causes of the failure."""
    failed = False
    terminated: set[int] = set()
    while any(is_alive(p) for p in procs):
        if any(exitcode(p) not in (0, None) for p in procs):
            failed = True
            time.sleep(grace_s)
            for rank, p in enumerate(procs):
                if is_alive(p):
                    terminated.add(rank)
                    terminate(p)
            break
        time.sleep(poll_s)
    return failed, terminated
