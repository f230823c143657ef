"""Functions that run inside a `launchers.debug_launcher` world and
pickle what this rank saw to `<out_dir>/rank<i>.pkl`, for tests that
hold the forms across processes against their definitions:

    debug_launcher(collective_forms, (out_dir,), num_processes=2)

Each takes rank-stamped inputs, so a rank's results show whose data it
received."""

from __future__ import annotations

import logging
import os
import pickle
import random

import numpy as np
import torch


def _dump(out_dir: str, results: dict) -> None:
    from ..state import PartialState

    path = os.path.join(out_dir, f"rank{PartialState.process_index}.pkl")
    with open(path, "wb") as f:
        pickle.dump(results, f)


def collective_forms(out_dir: str) -> None:
    """`utils.operations`' collectives on rank-stamped tensors."""
    from ..state import PartialState
    from ..utils import operations as ops

    r = PartialState().process_index
    res = {
        "gather": ops.gather({"t": torch.full((2,), float(r)),
                              "n": np.full((1, 2), r, np.int32),
                              "s": torch.tensor(float(r))}),
        "gather_object": ops.gather_object({"rank": r}),
        "broadcast": ops.broadcast(torch.full((3,), float(r)), 1),
        "broadcast_object_list": ops.broadcast_object_list([r, f"s{r}"]),
        "reduce": {red: ops.reduce(torch.full((2,), float(r + 1)), red,
                                   scale=2.0)
                   for red in ("sum", "mean")},
        "pad_across_processes": [
            ops.pad_across_processes(torch.ones(r + 1, 2), pad_index=-1),
            ops.pad_across_processes(torch.ones(r + 1), pad_index=-1,
                                     pad_first=True)],
    }
    try:
        ops.verify_operation({"x": torch.ones(r + 1)}, "gather")
        res["verify_operation"] = "agreed"
    except ops.DistributedOperationException as e:
        res["verify_operation"] = str(e)
    grads = [torch.full((3, 5), float(r)), torch.arange(7.0) * (r + 1)]
    # buckets of 4 elements, so leaves split across buckets
    full, ops._BUCKET_ELEMENTS = ops._BUCKET_ELEMENTS, 4
    try:
        ops.all_reduce_mean_(grads)
    finally:
        ops._BUCKET_ELEMENTS = full
    res["all_reduce_mean_"] = grads
    _dump(out_dir, res)


def data_forms(out_dir: str) -> None:
    """The dispatcher and the sharded loader over rank-stamped batches,
    with the state's world and mesh."""
    from ..data import DataLoaderDispatcher, prepare_data_loader
    from ..state import AcceleratorState

    mesh = AcceleratorState(cpu=True).mesh
    batches = [{"x": np.arange(8 * i, 8 * i + 8, dtype=np.float32)
                .reshape(4, 2)} for i in range(3)]
    res = {
        "dispatcher": [b["x"] for b in DataLoaderDispatcher(
            batches, mesh=mesh, put_on_device=False)],
        "dispatcher_split": [b["x"] for b in DataLoaderDispatcher(
            batches, mesh=mesh, split_batches=True, put_on_device=False)],
        "shard": [b["x"] for b in prepare_data_loader(
            batches, mesh=mesh, put_on_device=False)],
        "mesh": mesh.shape,
    }
    _dump(out_dir, res)


def random_forms(out_dir: str) -> None:
    """Each host stream diverged by rank, then synchronised."""
    from ..state import PartialState
    from ..utils.random import synchronize_rng_state

    r = PartialState().process_index
    random.seed(10 + r)
    np.random.seed(20 + r)
    torch.manual_seed(30 + r)
    gen = torch.Generator().manual_seed(40 + r)
    res = {"before": (random.random(), float(np.random.rand()),
                      float(torch.rand(())),
                      float(torch.rand((), generator=gen)))}
    for kind in ("python", "numpy", "torch", "jax"):
        synchronize_rng_state(kind)
    synchronize_rng_state("generator", generator=gen)
    res["after"] = (random.random(), float(np.random.rand()),
                    float(torch.rand(())),
                    float(torch.rand((), generator=gen)))
    _dump(out_dir, res)


class _Lines(logging.Handler):
    def __init__(self, path: str):
        super().__init__()
        self.path = path

    def emit(self, record):
        with open(self.path, "a") as f:
            f.write(record.getMessage() + "\n")


def logging_forms(out_dir: str) -> None:
    """`get_logger(...).info(..., in_order=True)` into one shared file,
    rank after rank; main-process-only records once."""
    from ..logging import get_logger
    from ..state import PartialState

    r = PartialState().process_index
    log = get_logger("world_forms", log_level="INFO")
    log.logger.addHandler(_Lines(os.path.join(out_dir, "log.txt")))
    log.logger.propagate = False
    for i in range(2):
        log.info(f"ordered {i} from {r}", in_order=True)
    log.info(f"main only from {r}")
    PartialState().wait_for_everyone()
    _dump(out_dir, {"rank": r})


def local_sgd_forms(out_dir: str) -> None:
    """`LocalSGD` over rank-stamped params: steps 1 and 2 keep each
    rank's own values, step 3 (k = 3) averages them, and `flush` after a
    fourth step averages again; a TrainState's params average too."""
    from ..local_sgd import LocalSGD
    from ..optimizers import sgd
    from ..state import PartialState
    from ..training import TrainState

    r = PartialState().process_index
    params = {"w": torch.full((2, 3), float(r)), "b": torch.tensor(float(r))}
    seen = []
    with LocalSGD(local_sgd_steps=3) as lsgd:
        for _ in range(3):
            params["w"].add_(1.0)
            params = lsgd.step(params)
            seen.append(params["w"].clone())
        params["b"].add_(float(r))
        params = lsgd.flush(lsgd.step(params))
    ts = TrainState.create(apply_fn=None,
                           params={"w": torch.full((2,), float(r))},
                           tx=sgd(0.1))
    ts = LocalSGD(local_sgd_steps=1).step(ts)
    _dump(out_dir, {"seen": seen, "b": params["b"], "ts_w": ts.params["w"]})


def checkpoint_forms(out_dir: str) -> None:
    """A world's `save_state` of a trained regression into `out_dir/ckpt`
    (automatic naming, two saves, `total_limit=1`): which files exist,
    and this rank's params after a `load_state` in the same world."""
    from ..accelerator import Accelerator
    from ..optimizers import adam
    from ..test_utils.training import RegressionDataset, regression_loss, \
        regression_params
    from ..training import TrainState
    from ..utils.dataclasses import ProjectConfiguration

    project = os.path.join(out_dir, "ckpt")
    acc = Accelerator(project_config=ProjectConfiguration(
        project_dir=project, automatic_checkpoint_naming=True,
        total_limit=1))
    ds = RegressionDataset(length=32, seed=5)
    loader = acc.prepare([{"x": ds.x[i:i + 4], "y": ds.y[i:i + 4]}
                          for i in range(0, 32, 4)])
    ts = acc.prepare(TrainState.create(apply_fn=None,
                                       params=regression_params(),
                                       tx=adam(0.05)))
    step = acc.train_step(regression_loss)
    it = iter(loader)
    ts, _ = step(ts, next(it))
    acc.save_state(state=ts)
    ts, _ = step(ts, next(it))
    path = acc.save_state(state=ts)
    saved = {k: v.clone() for k, v in ts.params.items()}
    ts, _ = step(ts, next(it))
    acc.load_state(path, state=ts)
    acc.wait_for_everyone()
    _dump(out_dir, {"path": path, "files": sorted(os.listdir(path)),
                    "dirs": sorted(os.listdir(os.path.dirname(path))),
                    "saved": saved, "loaded": dict(ts.params),
                    "step": int(ts.step)})


def fp8_forms(out_dir: str, inputs_path: str) -> None:
    """fp8 steps of the tiny llama (AdamW 3e-3, clip 1.0) from the
    pickled (numpy params, global batches) at `inputs_path`, each rank
    on its rows of every batch: the loss and this rank's fp8 state after
    each step, and its params after the last."""
    from .. import optimizers
    from ..accelerator import Accelerator
    from ..models import llama
    from ..models.convert import params_from_numpy, params_to_numpy
    from ..training import TrainState, clone_tree

    with open(inputs_path, "rb") as f:
        params, batches = pickle.load(f)
    cfg = llama.LlamaConfig.tiny()
    acc = Accelerator(mixed_precision="fp8", gradient_clipping=1.0)
    ts = acc.prepare(TrainState.create(
        apply_fn=None, params=params_from_numpy(params, device="cpu"),
        tx=optimizers.adamw(3e-3),
        fp8_state=llama.init_fp8_state(cfg, device="cpu")))
    step = acc.train_step(lambda p, b, fp8_state=None: llama.causal_lm_loss(
        cfg, p, b, fp8_state=fp8_state))
    r, n = acc.process_index, acc.num_processes
    steps = []
    for b in batches:
        rows = len(b) // n
        ts, m = step(ts, {"input_ids": torch.from_numpy(
            b[r * rows:(r + 1) * rows])})
        steps.append((float(m["loss"]),
                      params_to_numpy(clone_tree(ts.fp8_state))))
    _dump(out_dir, {"steps": steps,
                    "params": params_to_numpy(clone_tree(ts.params))})


def fp8_grad_forms(out_dir: str) -> None:
    """The gradients of one fp8 projection, each rank on its rows of a
    seeded global batch `x [8, 32] @ w [32, 16]` under the mean of the
    squared outputs: this rank's dX and the dW averaged across ranks."""
    from ..ops import fp8
    from ..state import PartialState
    from ..utils.operations import all_reduce_mean_

    st = PartialState()
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    rows = 8 // st.num_processes
    x = x[st.process_index * rows:(st.process_index + 1) * rows]
    x.requires_grad_(True)
    w.requires_grad_(True)
    meta = {"x": fp8.Fp8Meta.init(device="cpu"),
            "w": fp8.Fp8Meta.init(device="cpu")}
    out, _ = fp8.fp8_dense(x, w, meta)
    (out.float() ** 2).mean().backward()
    dw = w.grad.clone()
    all_reduce_mean_([dw])
    _dump(out_dir, {"dx": x.grad, "dw": dw})


def teardown_forms(out_dir: str) -> None:
    """The mesh's group while the world lives and after
    `destroy_process_group` with the mesh still held, and the names of
    this process's threads then (gloo's end with the group)."""
    import gc

    from ..state import PartialState

    mesh = PartialState().mesh
    live = mesh.groups["data"] is torch.distributed.group.WORLD
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    gc.collect()
    task = f"/proc/{os.getpid()}/task"
    threads = []
    for t in os.listdir(task):
        with open(os.path.join(task, t, "comm")) as f:
            threads.append(f.read().strip())
    _dump(out_dir, {"live": live,
                    "after": {a: g is not None
                              for a, g in mesh.groups.items()},
                    "threads": sorted(threads)})


def world_check(tag) -> None:
    """Assert this is a two-process gloo world on the CPU, and that a
    gathered object comes back from each rank in order."""
    from ..state import PartialState
    from ..utils.operations import gather_object

    st = PartialState()
    assert st.num_processes == 2 and st.device.type == "cpu"
    assert st.backend == "gloo" and st.mesh.shape == {"data": 2}
    assert gather_object((st.process_index, tag)) == [(0, tag), (1, tag)]


def fail_on_rank_1() -> None:
    """Raise on rank 1 only."""
    from ..state import PartialState

    if PartialState().process_index == 1:
        raise ValueError("rank one fails")
