"""The port's launch stack against the JAX package's: the environment
and command assembly (`utils/launch.py`), the world monitor, the config
reader (`commands/config/config_args.py`), the flags the port refuses
(with the slice that brings them), and real worlds on the CPU: `python
-m accelerate_tpu_torch.commands.launch --cpu --num_processes 2`, a rank
that fails, `--max_restarts` with a resume, `debug_launcher` and
`notebook_launcher`.

The reference's variables are `ACCELERATE_TPU_*`; the port's are
`ACCELERATE_TORCH_*` (it reads none of the reference's), so the two
environments are compared name by name after the prefix."""

import argparse
import os
import sys
import time
import types

import pytest

from accelerate_tpu.commands import launch as jlaunch
from accelerate_tpu.commands.config import config_args as jconfig
from accelerate_tpu.utils import environment as jenv
from accelerate_tpu.utils import launch as jul
from accelerate_tpu_torch.commands import launch as tlaunch
from accelerate_tpu_torch.commands.config import config_args as tconfig
from accelerate_tpu_torch.launchers import debug_launcher, \
    notebook_launcher
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.test_utils import bundled_script_path, \
    execute_subprocess, launch_command_for
from accelerate_tpu_torch.utils import constants as tc
from accelerate_tpu_torch.utils import environment as tenv
from accelerate_tpu_torch.utils import launch as tul


@pytest.fixture(autouse=True)
def _fresh_state():
    PartialState._reset_state()
    yield
    PartialState._reset_state()


def _args(argv):
    parser = argparse.ArgumentParser()
    tlaunch.add_launch_arguments(parser)
    return parser.parse_args(argv)


@pytest.mark.parametrize("argv", [
    ["s.py"], ["--mixed_precision", "bf16", "s.py"],
    ["--mesh_shape", "data=-1", "--gradient_accumulation_steps", "4",
     "--debug", "--cpu", "s.py", "--lr", "3"],
    ["--mixed_precision", "fp8", "-m", "pkg.train"],
    ["--no_python", "./run.sh", "a"]],
    ids=["bare", "precision", "all", "module", "no_python"])
def test_env_and_command_like_jax(argv):
    targs = _args(argv)
    jparser = argparse.ArgumentParser()
    jlaunch.add_launch_arguments(jparser)
    jargs = jparser.parse_args(argv)

    def suffixes(env, prefix):
        assert all(k.startswith(prefix) for k in env), env
        return {k[len(prefix):]: v for k, v in env.items()}

    assert suffixes(tul.prepare_launch_env(targs), tc.ENV_PREFIX) == \
        suffixes(jul.prepare_launch_env(jargs), "ACCELERATE_TPU_")
    assert tul.build_script_cmd(targs, ["--x"]) == \
        jul.build_script_cmd(jargs, ["--x"])


def test_rank_env_is_torchruns():
    env = tul.rank_env(3, 4, 1, 2, "10.0.0.1", 29500)
    assert env == {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
                   "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "10.0.0.1",
                   "MASTER_PORT": "29500"}
    assert not any(k.startswith("ACCELERATE_TPU_") for k in env)


def test_environment_helpers_like_jax(monkeypatch):
    for text in ("1", "true", "Yes", "on", "0", "false", "", "n"):
        assert tenv.str_to_bool(text) == jenv.str_to_bool(text)
    with pytest.raises(ValueError):
        tenv.str_to_bool("maybe")
    monkeypatch.setenv("PORT_FLAG", "yes")
    monkeypatch.setenv("PORT_INT", "7")
    for mod in (tenv, jenv):
        assert mod.parse_flag_from_env("PORT_FLAG")
        assert mod.parse_int_from_env("PORT_INT") == 7
        assert mod.get_int_from_env(("NOPE", "PORT_INT")) == 7
        assert mod.get_int_from_env(("NOPE",), 3) == 3
    with tenv.patch_environment(port_flag=None, port_new="x"):
        assert "PORT_FLAG" not in os.environ
        assert os.environ["PORT_NEW"] == "x"
    assert os.environ["PORT_FLAG"] == "yes" and "PORT_NEW" not in os.environ
    for spec in ("data=8,model=4", "8x4", "data=-1", " "):
        assert tenv.parse_mesh_shape(spec) == jenv.parse_mesh_shape(spec)
    axes = {"data": 2, "fsdp": 1}
    assert tenv.format_mesh_shape(axes) == jenv.format_mesh_shape(axes)


def test_monitor_world_tears_down_after_a_failure_like_jax():
    def world():
        return [types.SimpleNamespace(alive=True, code=None),
                types.SimpleNamespace(alive=False, code=5),
                types.SimpleNamespace(alive=True, code=None)]

    outs = []
    for mod in (tul, jul):
        procs = world()
        killed = []

        def terminate(p):
            killed.append(p)
            p.alive, p.code = False, -15

        outs.append(mod.monitor_world(
            procs, is_alive=lambda p: p.alive, exitcode=lambda p: p.code,
            terminate=terminate, grace_s=0.0, poll_s=0.0))
        assert killed == [procs[0], procs[2]]
    assert outs[0] == outs[1] == (True, {0, 2})


def test_config_file_fills_unset_flags_like_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("mixed_precision: fp16\ngradient_accumulation_steps: 2\n"
                    "use_cpu: true\nmesh_shape: data=-1\n")
    for mod, cfgmod in ((tlaunch, tconfig), (jlaunch, jconfig)):
        parser = argparse.ArgumentParser()
        mod.add_launch_arguments(parser)
        args = mod._merge_config(parser.parse_args(
            ["--config_file", str(path), "--mixed_precision", "bf16",
             "s.py"]))
        # explicit flags win; the file fills the rest
        assert (args.mixed_precision, args.gradient_accumulation_steps,
                args.cpu, args.mesh_shape) == ("bf16", 2, True, "data=-1")
        assert cfgmod.load_config(path).use_cpu
    (tmp_path / "bad.yaml").write_text("nonsense_key: 1\n")
    with pytest.raises(ValueError, match="Unknown config keys"):
        tconfig.load_config(tmp_path / "bad.yaml")
    (tmp_path / "c.json").write_text('{"num_processes": 2, "use_cpu": true}')
    assert tconfig.load_config(tmp_path / "c.json").num_processes == 2
    with pytest.raises(FileNotFoundError):
        tconfig.load_config(tmp_path / "missing.yaml")
    ref = {f for f in jconfig.LaunchConfig.__dataclass_fields__}
    port = {f for f in tconfig.LaunchConfig.__dataclass_fields__}
    # the reference's fields, plus the process count of a local world
    assert port - ref == {"num_processes"} and ref <= port


@pytest.mark.parametrize("flags, says", [
    (["--tpu_name", "pod"], "item 8d"), (["--tpu_zone", "z"], "item 8d"),
    (["--tpu_project", "p"], "item 8d"),
    (["--num_virtual_devices", "8"], "no meaning in the port"),
    (["--zero_stage", "3"], "item 6b"),
    (["--fsdp_sharding_strategy", "FULL_SHARD"], "item 6b"),
    (["--context_parallel_mode", "ring"], "item 6b"),
    (["--context_parallel_degree", "2"], "item 6b"),
    (["--mesh_shape", "data=1,model=2"], "item 6b")],
    ids=["tpu_name", "tpu_zone", "tpu_project", "num_virtual_devices",
         "zero_stage", "fsdp", "cp_mode", "cp_degree", "mesh_model"])
def test_refused_flags_exit_2_naming_their_slice(flags, says, capsys):
    assert tlaunch.main([*flags, "never_run.py"]) == 2
    assert says in capsys.readouterr().err


def test_launch_cpu_world_of_two_runs_every_rank():
    out = execute_subprocess(launch_command_for(
        bundled_script_path("test_cli.py"), 2, ["--cpu"]), timeout=240)
    assert sorted(line for line in out.splitlines()
                  if line.startswith("Successfully")) == [
        f"Successfully ran on cpu as process {r} of 2 process(es)"
        for r in (0, 1)]


_FAILING_RANK = """
import os, time
from accelerate_tpu_torch.state import PartialState
st = PartialState()
if st.process_index == 1:
    os._exit(3)   # dies at once; rank 0 then fails in its barrier
st.wait_for_everyone()   # rank 1 never arrives
time.sleep(600)
"""


def test_a_failed_rank_tears_the_world_down_with_its_code(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(_FAILING_RANK)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed with code 3"):
        execute_subprocess(launch_command_for(str(script), 2, ["--cpu"]),
                           timeout=240)
    assert time.monotonic() - t0 < 120


def test_max_restarts_relaunches_and_resumes(tmp_path):
    out = execute_subprocess(
        [*launch_command_for(bundled_script_path("test_elastic_restart.py"),
                             2, ["--cpu", "--max_restarts", "1"]),
         str(tmp_path)], timeout=400)
    assert "test_elastic_restart: ALL CHECKS PASSED" in out
    assert os.path.exists(tmp_path / "crashed_once")


def test_debug_launcher_world_and_its_failures():
    from accelerate_tpu_torch.test_utils.worlds import fail_on_rank_1, \
        world_check

    debug_launcher(world_check, ("x",), num_processes=2)
    with pytest.raises(RuntimeError, match="1/2 launched processes failed"
                       "(.|\\n)*rank one fails"):
        debug_launcher(fail_on_rank_1, num_processes=2)


def test_notebook_launcher_in_process_and_refusal():
    assert notebook_launcher(lambda a: a + 1, (2,)) == 3
    PartialState(cpu=True)
    with pytest.raises(RuntimeError, match="already initialized"):
        notebook_launcher(lambda: None, num_processes=2)


def test_launcher_module_runs_as_main():
    out = execute_subprocess(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.launch",
         "--help"], timeout=120)
    assert "--num_processes" in out and "--max_restarts" in out


def test_launch_variables_are_read_where_the_reference_reads_its_own(
        monkeypatch):
    """The launcher's precision, accumulation, debug and CPU flags reach
    the process state and the Accelerator through the port's variables,
    as the reference's through its own."""
    import accelerate_tpu as at
    from accelerate_tpu_torch.accelerator import Accelerator

    env = {"MIXED_PRECISION": "bf16", "GRADIENT_ACCUMULATION_STEPS": "3",
           "DEBUG": "1"}
    for key, value in env.items():
        monkeypatch.setenv(tc.ENV_PREFIX + key, value)
        monkeypatch.setenv("ACCELERATE_TPU_" + key, value)
    monkeypatch.setenv(tc.ENV_CPU, "1")
    at.PartialState._reset_state()
    try:
        acc, jacc = Accelerator(), at.Accelerator()
        assert acc.device.type == "cpu"
        for a in (acc, jacc):
            assert a.mixed_precision == "bf16"
            assert a.gradient_accumulation_steps == 3
            assert a.state.debug
    finally:
        at.PartialState._reset_state()
