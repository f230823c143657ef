"""Launch a function as a world of processes from Python (port of
`accelerate_tpu/launchers.py`).

- `debug_launcher(function, args, num_processes)` starts N real
  processes on the CPU, joined in a gloo group through a `file://`
  rendezvous in a temporary directory (no port is chosen, so launches
  that run side by side cannot race for one), and runs `function(*args)`
  in each: real multi-process semantics with no device.
- `notebook_launcher(function, args, num_processes)` runs `function` in
  this process for one process, else forks N processes (so a function
  defined in a notebook cell reaches them) joined through a rendezvous
  store this process hosts (`MASTER_ADDR`/`MASTER_PORT`, torchrun's
  agent store): one card each where CUDA is present
  (NCCL), else on the CPU (gloo). Forking after CUDA or the process
  state was initialised in the caller is refused, as in the reference.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import traceback
from typing import Any, Callable

import torch

from .state import AcceleratorState, PartialState
from .utils.constants import ENV_CPU, ENV_MIXED_PRECISION
from .utils.launch import monitor_world, rank_env


def _run_worker(rank: int, env: dict, init: dict | None, function: Callable,
                args: tuple, error_queue) -> None:
    """A child's entry point: its rank's variables, the group (when
    `init` names a rendezvous), a fresh process state, `function`."""
    try:
        os.environ.update(env)
        if init is not None:
            torch.distributed.init_process_group(**init, rank=rank)
        PartialState._reset_state()
        function(*args)
    except Exception:
        # the worker's boundary: the traceback goes to the parent
        error_queue.put((rank, traceback.format_exc()))
        sys.exit(1)
    if torch.distributed.is_initialized():
        try:
            # every rank done with the store before any leaves it; a
            # peer that failed reports itself
            torch.distributed.barrier()
            torch.distributed.destroy_process_group()
        except RuntimeError:
            pass


def _run_world(ctx, envs: list[dict], init: dict | None, function: Callable,
               args: tuple) -> None:
    """Start one process a rank, wait for the world, and raise with every
    failed rank's traceback if any failed."""
    error_queue = ctx.SimpleQueue()
    procs = []
    try:
        for rank, env in enumerate(envs):
            p = ctx.Process(target=_run_worker,
                            args=(rank, env, init, function, args,
                                  error_queue))
            p.start()
            procs.append(p)
        failed, terminated = monitor_world(
            procs, is_alive=lambda p: p.is_alive(),
            exitcode=lambda p: p.exitcode,
            terminate=lambda p: p.terminate())
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = failed or any(p.exitcode != 0 for p in procs)
    if not failed:
        return
    msgs, failed_ranks = [], set()
    while not error_queue.empty():
        rank, tb = error_queue.get()
        failed_ranks.add(rank)
        msgs.append(f"--- process {rank} ---\n{tb}")
    # ranks the clean-up terminated are casualties, not causes
    own = {rank for rank, p in enumerate(procs)
           if p.exitcode not in (0, None) and rank not in terminated}
    raise RuntimeError(f"{len(failed_ranks | own)}/{len(procs)} launched "
                       "processes failed:\n" + "\n".join(msgs))


def debug_launcher(function: Callable, args: tuple = (),
                   num_processes: int = 2,
                   start_method: str = "spawn") -> None:
    """Run `function(*args)` in an N-process gloo world on the CPU.

    With the default "spawn" start method `function` must be importable
    (defined at a module's top level); "fork" takes closures, and needs
    a caller that has not initialised CUDA."""
    import multiprocessing

    ctx = multiprocessing.get_context(start_method)
    tmp = tempfile.mkdtemp(prefix="accelerate_torch_debug_")
    try:
        init = {"backend": "gloo",
                "init_method": "file://" + os.path.join(tmp, "rendezvous"),
                "world_size": num_processes}
        envs = []
        for rank in range(num_processes):
            env = rank_env(rank, num_processes, rank, num_processes,
                           "127.0.0.1", 0)
            env[ENV_CPU] = "1"
            envs.append(env)
        _run_world(ctx, envs, init, function, args)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def notebook_launcher(function: Callable, args: tuple = (),
                      num_processes: int | None = None,
                      mixed_precision: str | None = None,
                      use_port: str | int | None = None,
                      master_addr: str | None = None,
                      node_rank: int = 0, num_nodes: int = 1) -> Any:
    """Run a training function from a notebook: in this process for one
    process (returning its result), else in `num_processes` forked
    processes on this node (`node_rank` of `num_nodes`), meeting at
    `master_addr:use_port` (default 127.0.0.1 and a free port, the store
    hosted by node 0's caller)."""
    multi = num_processes not in (None, 0, 1)
    if multi and (AcceleratorState._shared_state
                  or PartialState._shared_state
                  or torch.cuda.is_initialized()):
        raise RuntimeError(
            "CUDA or the accelerator state is already initialized in this "
            "process; restart the kernel (or create no Accelerator or "
            "PartialState before notebook_launcher) to launch a "
            "multi-process world.")
    if mixed_precision is not None:
        os.environ[ENV_MIXED_PRECISION] = str(mixed_precision)
    if not multi:
        return function(*args)
    import multiprocessing

    world = num_processes * num_nodes
    addr = master_addr or "127.0.0.1"
    port = int(use_port) if use_port is not None else 0
    store = None
    if node_rank == 0:
        # this process hosts the rendezvous store (torchrun's agent
        # store): port 0 takes a free port no other launch can race for
        store = torch.distributed.TCPStore(addr, port, is_master=True,
                                           wait_for_workers=False)
        port = store.port
    envs = []
    for local in range(num_processes):
        env = rank_env(node_rank * num_processes + local, world, local,
                       num_processes, addr, port)
        env["TORCHELASTIC_USE_AGENT_STORE"] = "True"
        if not torch.cuda.is_available():
            env[ENV_CPU] = "1"
        envs.append(env)
    # PartialState joins the group in each child from these variables
    try:
        _run_world(multiprocessing.get_context("fork"), envs, None,
                   function, args)
    finally:
        del store
    return None
