"""Launch-and-assert: checkpoint save and resume. Every rank asserts:

- train 4 steps, `save_state`, train 4 more: P_direct; a fresh run that
  `load_state`s and trains the same 4 lands on P_direct bit for bit (the
  optimizer moments and the step round-trip);
- the same on a model whose weight the ZeRO plan cuts (a [64, 64]
  matrix): under `--zero_stage 1|2` its moments are each rank's block,
  gathered whole into the checkpoint and cut again on load;
- `skip_first_batches` replays exactly the batches not yet seen;
- `total_limit` keeps the newest checkpoints only.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def _make_world(tmpdir: str, total_limit: int | None = None):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.optimizers import adam
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.test_utils.training import RegressionDataset, \
        regression_loss, regression_params
    from accelerate_tpu_torch.training import TrainState
    from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration

    PartialState._reset_state()
    acc = Accelerator(project_dir=tmpdir, project_config=ProjectConfiguration(
        project_dir=tmpdir, automatic_checkpoint_naming=True,
        total_limit=total_limit))
    # every process still sees 8 batches a pass
    n = 64 * acc.num_processes
    ds = RegressionDataset(length=n, seed=7)
    loader = acc.prepare([{"x": ds.x[i:i + 8], "y": ds.y[i:i + 8]}
                          for i in range(0, n, 8)])
    ts = acc.prepare(TrainState.create(
        apply_fn=None, params=regression_params(), tx=adam(0.05)))
    return acc, loader, ts, acc.train_step(regression_loss)


def check_save_resume_equivalence(tmpdir: str):
    from accelerate_tpu_torch.test_utils import host_values

    acc, loader, ts, step = _make_world(tmpdir)
    it = iter(loader)
    for _ in range(4):
        ts, _ = step(ts, next(it))
    ckpt = acc.save_state(state=ts)
    assert os.path.isdir(ckpt), ckpt
    for _ in range(4):
        ts, _ = step(ts, next(it))
    direct = host_values(ts.params)

    acc2, loader2, ts2, step2 = _make_world(tmpdir)
    acc2.load_state(ckpt, state=ts2)
    it2 = iter(loader2)
    for _ in range(4):
        next(it2)
    for _ in range(4):
        ts2, _ = step2(ts2, next(it2))
    resumed = host_values(ts2.params)
    assert direct["a"].tobytes() == resumed["a"].tobytes(), (direct, resumed)
    assert direct["b"].tobytes() == resumed["b"].tobytes(), (direct, resumed)


def _make_matrix_world():
    import torch

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.optimizers import adamw
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState

    PartialState._reset_state()
    acc = Accelerator()
    rng = np.random.default_rng(11)
    w = rng.standard_normal((64, 64)).astype(np.float32) * 0.1
    x = rng.standard_normal((64 * acc.num_processes, 64)).astype(np.float32)
    y = (x @ rng.standard_normal((64, 64)).astype(np.float32)) * 0.1
    loader = acc.prepare([{"x": x[i:i + 8], "y": y[i:i + 8]}
                          for i in range(0, len(x), 8)])
    ts = acc.prepare(TrainState.create(
        apply_fn=None, params={"w": torch.from_numpy(w)}, tx=adamw(0.01)))

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    return acc, loader, ts, acc.train_step(loss)


def check_blocks_resume_equivalence(tmpdir: str) -> bool:
    """`check_save_resume_equivalence` on the [64, 64] model; returns
    whether its moments were this rank's blocks."""
    from accelerate_tpu_torch.sharding import holds_blocks
    from accelerate_tpu_torch.test_utils import host_values

    ckpt = os.path.join(tmpdir, "matrix")
    acc, loader, ts, step = _make_matrix_world()
    it = iter(loader)
    for _ in range(2):
        ts, _ = step(ts, next(it))
    acc.save_state(ckpt, state=ts)
    for _ in range(2):
        ts, _ = step(ts, next(it))
    direct = host_values(ts.params)["w"]
    blocks = holds_blocks(ts.opt_state)

    acc2, loader2, ts2, step2 = _make_matrix_world()
    acc2.load_state(ckpt, state=ts2)
    it2 = iter(loader2)
    for _ in range(2):
        next(it2)
    for _ in range(2):
        ts2, _ = step2(ts2, next(it2))
    assert direct.tobytes() == host_values(ts2.params)["w"].tobytes()
    return blocks


def check_skip_first_batches(tmpdir: str):
    from accelerate_tpu_torch.test_utils import host_values

    acc, loader, _, _ = _make_world(tmpdir)
    every = [host_values(b["x"]) for b in loader]
    tail = [host_values(b["x"]) for b in acc.skip_first_batches(loader, 3)]
    assert len(tail) == len(every) - 3
    for got, want in zip(tail, every[3:]):
        assert np.array_equal(got, want)


def check_total_limit(tmpdir: str):
    from accelerate_tpu_torch.utils.constants import CHECKPOINT_DIR_PREFIX

    acc, loader, ts, step = _make_world(tmpdir, total_limit=2)
    it = iter(loader)
    for _ in range(3):
        ts, _ = step(ts, next(it))
        acc.save_state(state=ts)
    base = os.path.join(tmpdir, "checkpoints")
    kept = sorted(d for d in os.listdir(base)
                  if d.startswith(CHECKPOINT_DIR_PREFIX))
    assert kept == [f"{CHECKPOINT_DIR_PREFIX}_1",
                    f"{CHECKPOINT_DIR_PREFIX}_2"], kept


def main() -> None:
    import shutil

    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils.operations import broadcast_object_list

    state = PartialState()
    # one set of directories every process agrees on: the main process
    # makes them and broadcasts the paths
    dirs = ([tempfile.mkdtemp() for _ in range(3)] if state.is_main_process
            else [None, None, None])
    dirs = broadcast_object_list(dirs)
    check_save_resume_equivalence(dirs[0])
    blocks = check_blocks_resume_equivalence(dirs[0])
    check_skip_first_batches(dirs[1])
    check_total_limit(dirs[2])
    state = PartialState()
    state.wait_for_everyone()
    if state.is_main_process:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
        print("test_checkpointing: ALL CHECKS PASSED "
              f"({state.num_processes} process(es))"
              + (", moments as blocks" if blocks else ""))


if __name__ == "__main__":
    main()
