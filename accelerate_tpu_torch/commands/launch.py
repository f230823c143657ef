"""Launch a training script as one process or a world of processes
(port of `accelerate_tpu/commands/launch.py`):

    python -m accelerate_tpu_torch.commands.launch [flags] script.py [args]

- **simple**: `--num_processes` 1 (the default): the script runs once,
  a world of one (it joins no process group);
- **local world**: `--num_processes N` starts N processes on this host,
  each with torchrun's variables (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
  `LOCAL_WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`), one device each;
  with `--num_machines M` the N processes split over M hosts, this one
  being `--machine_rank`, meeting at `--main_process_ip`/`_port`. As
  under torchrun, machine 0's launcher hosts the rendezvous store (on a
  free port unless one is given) and each process gets
  `OMP_NUM_THREADS=1` unless it is set.

The config flags reach the children as `ACCELERATE_TORCH_*` variables
(`utils/launch.py`); a rank that fails tears the world down, and the
launcher exits with that rank's code. `--max_restarts N` relaunches a
failed world up to N times (two failures inside 10 s each stop early).
Explicit flags win over `--config_file`.

Refused, with the slice that brings them: `--zero_stage`,
`--fsdp_sharding_strategy`, `--context_parallel_*` and a `--mesh_shape`
with an axis other than `data` above 1 (sharded parallelism, queue 1
item 6b); `--tpu_name`, `--tpu_zone`, `--tpu_project` (pods, item 8d).
`--num_virtual_devices` has no meaning here: each process owns one
device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from ..utils.environment import parse_mesh_shape
from ..utils.launch import (
    build_script_cmd,
    merged_child_env,
    monitor_world,
    prepare_launch_env,
    rank_env,
)
from .config.config_args import load_config

# the package's parent directory: a child imports the same port as the
# launcher, wherever its script lies
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class LaunchRefused(ValueError):
    """A flag the port does not run (`main` exits 2 with the reason)."""


def add_launch_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config_file", default=None,
                        help="YAML/JSON launch config (default: "
                             "~/.cache/accelerate_tpu_torch/)")
    parser.add_argument("--num_machines", type=int, default=None,
                        help="Hosts in the world")
    parser.add_argument("--machine_rank", type=int, default=None,
                        help="Rank of this host")
    parser.add_argument("--main_process_ip", default=None)
    parser.add_argument("--main_process_port", type=int, default=None)
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Processes in the world (one device each)")
    parser.add_argument("--num_virtual_devices", type=int, default=None,
                        help="Refused: each process owns one device")
    parser.add_argument("--mixed_precision", default=None,
                        choices=["no", "bf16", "fp16", "fp8"])
    parser.add_argument("--mesh_shape", default=None,
                        help="e.g. 'data=-1'")
    parser.add_argument("--gradient_accumulation_steps", type=int,
                        default=None)
    parser.add_argument("--zero_stage", type=int, default=None,
                        choices=[0, 1, 2, 3])
    parser.add_argument("--fsdp_sharding_strategy", default=None,
                        choices=["FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD",
                                 "HYBRID_SHARD"])
    parser.add_argument("--context_parallel_mode", default=None,
                        choices=["none", "ring", "ulysses"])
    parser.add_argument("--context_parallel_degree", type=int, default=None)
    parser.add_argument("--cpu", "--use_cpu", dest="cpu",
                        action="store_true", default=None,
                        help="Run every process on the CPU (gloo)")
    parser.add_argument("--max_restarts", type=int, default=None,
                        help="Relaunch a failed world up to N times")
    parser.add_argument("--debug", action="store_true", default=None,
                        help="Check collective shapes across processes")
    parser.add_argument("--tpu_name", default=None)
    parser.add_argument("--tpu_zone", default=None)
    parser.add_argument("--tpu_project", default=None)
    parser.add_argument("--module", "-m", action="store_true",
                        help="Treat the script as an importable module")
    parser.add_argument("--no_python", action="store_true",
                        help="The script is an executable, not Python")
    parser.add_argument("training_script",
                        help="Script (or module with -m) to launch")
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER,
                        help="Arguments passed to the script")


_CONFIG_FIELDS = (
    "num_machines", "machine_rank", "main_process_ip", "main_process_port",
    "num_processes", "mixed_precision", "mesh_shape",
    "gradient_accumulation_steps", "num_virtual_devices", "debug",
    "max_restarts", "tpu_name", "tpu_zone", "tpu_project", "zero_stage",
    "fsdp_sharding_strategy", "context_parallel_mode",
    "context_parallel_degree",
)


def _merge_config(args: argparse.Namespace) -> argparse.Namespace:
    """The config file fills every flag the command line left unset."""
    config = load_config(args.config_file)
    if config is None:
        return args
    for name in _CONFIG_FIELDS:
        if getattr(args, name, None) is None:
            setattr(args, name, getattr(config, name, None))
    if args.cpu is None and config.use_cpu:
        args.cpu = True
    return args


def check_supported(args: argparse.Namespace) -> None:
    """Raise `LaunchRefused` for a flag the port does not run."""
    for name in ("tpu_name", "tpu_zone", "tpu_project"):
        if getattr(args, name, None):
            raise LaunchRefused(
                f"--{name}: launching on a TPU pod over ssh is not ported; "
                "it arrives with the port's CLI slice (ROADMAP.md, queue 1 "
                "item 8d)")
    if getattr(args, "num_virtual_devices", None) is not None:
        raise LaunchRefused(
            "--num_virtual_devices has no meaning in the port: each process "
            "owns one device (use --num_processes N, with --cpu for a CPU "
            "world)")
    sharded = [f"--{n}" for n in ("zero_stage", "fsdp_sharding_strategy",
                                  "context_parallel_degree")
               if getattr(args, n, None) is not None]
    if getattr(args, "context_parallel_mode", None) not in (None, "none"):
        sharded.append("--context_parallel_mode")
    if args.mesh_shape:
        axes = parse_mesh_shape(args.mesh_shape)
        if any(a != "data" and s not in (0, 1) for a, s in axes.items()):
            sharded.append(f"--mesh_shape {args.mesh_shape}")
    if sharded:
        raise LaunchRefused(
            f"{', '.join(sharded)}: sharded parallelism is not ported; it "
            "arrives with the port's sharded-parallelism slice (ROADMAP.md, "
            "queue 1 item 6b). The port runs data parallelism.")


def _child_env(extra: dict[str, str]) -> dict[str, str]:
    env = merged_child_env(extra)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PKG_ROOT, env.get("PYTHONPATH", "")) if p)
    return env


def simple_launcher(args: argparse.Namespace) -> int:
    """The script once, as a world of one."""
    proc = subprocess.run(build_script_cmd(args),
                          env=_child_env(prepare_launch_env(args)))
    return proc.returncode


def local_world_launcher(args: argparse.Namespace) -> int:
    """This host's share of an N-process world, each process with its
    rank's variables; a failed rank tears the others down."""
    machines = args.num_machines or 1
    world = args.num_processes
    if world % machines:
        raise LaunchRefused(f"--num_processes {world} does not split over "
                            f"--num_machines {machines}")
    local_world = world // machines
    machine = args.machine_rank or 0
    addr = args.main_process_ip or "127.0.0.1"
    port = args.main_process_port or 0
    store = None
    if machine == 0:
        # the launcher hosts the rendezvous store, as torchrun's agent
        # does, so port 0 takes a free port with no window in which a
        # launch beside this one can take it too; every rank joins it
        # as a client (torch's TORCHELASTIC_USE_AGENT_STORE)
        import torch.distributed as dist

        store = dist.TCPStore(addr, port, is_master=True,
                              wait_for_workers=False)
        port = store.port
    base = prepare_launch_env(args)
    base["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    # torchrun's default: one OpenMP thread a process unless the caller
    # set a count, so N processes do not oversubscribe the host's cores
    if "OMP_NUM_THREADS" not in os.environ:
        base["OMP_NUM_THREADS"] = "1"
    cmd = build_script_cmd(args)
    procs = []
    try:
        for local in range(local_world):
            env = dict(base)
            env.update(rank_env(machine * local_world + local, world, local,
                                local_world, addr, port))
            procs.append(subprocess.Popen(cmd, env=_child_env(env)))
        failed_first: list = []

        def exitcode(p):
            # polled, in the order failures are seen: the first is the
            # cause, a peer that fails in a collective after it a casualty
            code = p.poll()
            if code not in (0, None) and p not in failed_first:
                failed_first.append(p)
            return code

        monitor_world(procs, is_alive=lambda p: p.poll() is None,
                      exitcode=exitcode, terminate=lambda p: p.terminate())
        for p in procs:
            p.wait()
        if failed_first:
            return failed_first[0].returncode
        return next((p.returncode for p in procs if p.returncode != 0), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store


def launch_command(args: argparse.Namespace) -> int:
    args = _merge_config(args)
    check_supported(args)

    def run_once() -> int:
        if args.num_processes and args.num_processes > 1:
            return local_world_launcher(args)
        return simple_launcher(args)

    max_restarts = args.max_restarts or 0
    rc = 1
    # a deterministic failure (bad arguments, an import error) fails
    # again at once: two failures inside this many seconds stop the loop
    fast_fail_s = 10.0
    fast_fails = 0
    for attempt in range(max_restarts + 1):
        if attempt:
            print(f"accelerate_tpu_torch launch: world failed (exit {rc}); "
                  f"restart {attempt}/{max_restarts}", file=sys.stderr)
        t0 = time.monotonic()
        rc = run_once()
        if rc == 0:
            return 0
        if time.monotonic() - t0 < fast_fail_s:
            fast_fails += 1
            if fast_fails >= 2 and attempt < max_restarts:
                print("accelerate_tpu_torch launch: two failures within "
                      f"{fast_fail_s:.0f}s look deterministic; stopping the "
                      "restarts", file=sys.stderr)
                return rc
        else:
            fast_fails = 0
    return rc


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("accelerate_tpu_torch.commands.launch")
    add_launch_arguments(parser)
    args = parser.parse_args(argv)
    try:
        return launch_command(args)
    except LaunchRefused as e:
        print(f"accelerate_tpu_torch launch: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
