"""SIGKILL mid-save, then auto-resume: the crash matrix of the commit
protocol (`docs/checkpointing.md`, "The commit protocol") in the port.

The victims come from this file run as a script (`python
tests/test_torch_crash_resume.py DIR`): one fresh interpreter that forks
a victim per crash point, before it has run anything (so one torch
import serves them all). Each victim runs a deterministic toy loop,
commits one complete async checkpoint at step 4 (enqueue, drain), runs
two more steps, and dies by SIGKILL around the async save of step 6, at
the point its mode names:

- `before_stage`: before the save begins: nothing new on disk;
- `mid_write`: inside the writer thread, with step 6's file half written
  and no manifest (bytes partial);
- `mid_manifest`: with the manifest written to its temp name, before the
  rename that commits it;
- `after_commit`: after step 6's drain: step 6 is complete.

For each, the test checks what the dead process left (the torn step 6
invisible, the newest complete manifest the resume target), resumes
in-process from it and steps on: the losses equal the unfaulted run's
bit for bit."""

from __future__ import annotations

import functools
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import checkpointing as ckpt
from accelerate_tpu_torch import optimizers as to
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.training import TrainState
from accelerate_tpu_torch.utils import safetensors as st

_W = 64
NUM_STEPS = 8
COMMIT_STEP = 4
TORN_STEP = 6
MODES = {"before_stage": COMMIT_STEP, "mid_write": COMMIT_STEP,
         "mid_manifest": COMMIT_STEP, "after_commit": TORN_STEP}


def make_state():
    return TrainState.create(apply_fn=None,
                             params={"w": torch.eye(_W) * 0.5},
                             tx=to.adam(1e-2))


def batch_fn(i):
    x = np.random.RandomState(0).randn(8, _W).astype("float32")
    y = np.random.RandomState(1).randn(8, _W).astype("float32")
    return {"x": torch.tensor(x), "y": torch.tensor(y)}


def step_fn(state, batch):
    return Accelerator(cpu=True).train_step(
        lambda p, b: torch.mean((b["x"] @ p["w"] - b["y"]) ** 2))(
            state, batch)


def _die():
    os.kill(os.getpid(), signal.SIGKILL)


def _victim(mode: str, base: str) -> None:
    torch.set_num_threads(1)
    torn = os.path.join(base, f"step_{TORN_STEP:08d}")
    real_save, real_replace = st.save_file, os.replace

    def save_file(tensors, path, metadata=None):
        real_save(tensors, path, metadata)
        if mode == "mid_write" and path.startswith(torn):
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)
            _die()

    def replace(src, dst):
        if mode == "mid_manifest" and dst.startswith(torn):
            _die()
        real_replace(src, dst)

    st.save_file, os.replace = save_file, replace
    state = make_state()
    for i in range(TORN_STEP):
        state, _ = step_fn(state, batch_fn(i))
        if i + 1 == COMMIT_STEP:
            ckpt.save_accelerator_state(
                os.path.join(base, f"step_{COMMIT_STEP:08d}"),
                train_states=[state], step=COMMIT_STEP, async_save=True)
            ckpt.wait_for_checkpoints()  # drain: step 4 COMMITS
    if mode == "before_stage":
        _die()
    ckpt.save_accelerator_state(torn, train_states=[state], step=TORN_STEP,
                                async_save=True)
    ckpt.wait_for_checkpoints()
    if mode == "after_commit":
        _die()
    raise SystemExit(f"{mode}: the victim outlived its save")


def _victims(base: str) -> None:
    """Fork one victim per mode, each into its own directory, and print
    {mode: the signal that ended it}."""
    ended = {}
    for mode in MODES:
        os.makedirs(os.path.join(base, mode))
        pid = os.fork()
        if pid == 0:
            try:
                _victim(mode, os.path.join(base, mode))
            finally:
                os._exit(1)
        _, status = os.waitpid(pid, 0)
        ended[mode] = os.WTERMSIG(status) if os.WIFSIGNALED(status) else None
    print(json.dumps(ended), flush=True)


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def crashed(tmp_path_factory):
    """The base directory the victims left, and how each one ended."""
    base = str(tmp_path_factory.mktemp("crash"))
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ,
           "PYTHONPATH": _ROOT + (os.pathsep + path if path else "")}
    out = subprocess.run([sys.executable, os.path.abspath(__file__), base],
                         env=env, capture_output=True, text=True,
                         timeout=120, cwd=_ROOT)
    assert out.returncode == 0, out.stderr
    return base, json.loads(out.stdout.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def _unfaulted() -> tuple:
    state, out = make_state(), []
    for i in range(NUM_STEPS):
        state, m = step_fn(state, batch_fn(i))
        out.append(float(m["loss"]))
    return tuple(out)


@pytest.mark.parametrize("mode", list(MODES))
def test_sigkill_mid_save_resumes_loss_curve_exact(mode, crashed):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reference = _unfaulted()
        base, ended = os.path.join(crashed[0], mode), crashed[1]
        assert ended[mode] == signal.SIGKILL
        committed = os.path.join(base, f"step_{COMMIT_STEP:08d}")
        torn = os.path.join(base, f"step_{TORN_STEP:08d}")
        assert ckpt.is_complete_checkpoint(committed)
        assert ckpt.is_complete_checkpoint(torn) == (mode == "after_commit")
        if mode == "mid_write":       # bytes landed, no commit
            assert os.path.getsize(
                os.path.join(torn, "model_0.safetensors")) > 0
            with pytest.raises(ValueError):
                st.load_file(os.path.join(torn, "model_0.safetensors"))
        if mode == "mid_manifest":    # the temp name only
            assert os.path.exists(os.path.join(
                torn, ckpt.MANIFEST_NAME + ".tmp"))
        resume_step = MODES[mode]
        assert ckpt.latest_complete_checkpoint(base) == os.path.join(
            base, f"step_{resume_step:08d}")
        state = make_state()
        restored = ckpt.resume_latest(base, train_states=[state])
        assert restored["step"] == resume_step
        state = restored["train_states"][0]
        assert state.step == resume_step
        for i in range(resume_step, NUM_STEPS):
            state, metrics = step_fn(state, batch_fn(i))
            assert float(metrics["loss"]) == reference[i], i
    finally:
        torch.set_num_threads(threads)
        PartialState._reset_state()


if __name__ == "__main__":
    _victims(sys.argv[1])
