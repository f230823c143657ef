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


def _serving_trace(engine, vocab: int, trace: dict) -> list:
    """The reference's seeded staggered trace (`tests/test_pod.py`
    `_run_trace`), with optional per-request deadlines and TTFT SLOs:
    one request, three steps, the rest, then run until idle."""
    rng = np.random.default_rng(trace.get("seed", 7))
    lens = trace.get("lens", (5, 11, 3, 17))
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]
    budgets = trace.get("budgets", (6, 6, 4, 4))
    temps = trace.get("temps", (0.0, 0.7, 0.0, 1.1))
    extra = dict(deadline_s=trace.get("deadline_s"),
                 slo_ttft_s=trace.get("slo_ttft_s"))
    reqs = [engine.submit(prompts[0], max_new_tokens=budgets[0],
                          temperature=temps[0], **extra)]
    for _ in range(3):
        engine.step()
    for p, b, t in zip(prompts[1:], budgets[1:], temps[1:]):
        reqs.append(engine.submit(p, max_new_tokens=b, temperature=t,
                                  **extra))
    engine.run_until_idle()
    return reqs


class StepClock:
    """A fake clock that advances `step` seconds at every read."""

    def __init__(self, step: float):
        self.step, self.t = step, 0.0

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def serve_job(job: dict, rank: int = 0):
    """Build and drive one engine of a job description (see
    `tensor_parallel_serving`); returns (engine, requests)."""
    import importlib

    from ..models.convert import params_from_numpy
    from ..serving import Engine, EngineConfig
    from ..serving.pod import PodConfig, PodEngine, sharded_engine

    family = importlib.import_module(
        f"accelerate_tpu_torch.models.{job['family']}")
    cfg_cls = {"gpt2": "GPT2Config", "llama": "LlamaConfig"}[job["family"]]
    cfg = getattr(family, cfg_cls).tiny(**job.get("config", {}))
    params = params_from_numpy(job["params"], device="cpu")
    ec = EngineConfig(**dict(job.get("engine", {}),
                             cache_dtype=torch.float32))
    steps = job.get("clock_steps")
    kw = {} if steps is None else {"clock": StepClock(steps[rank])}
    kind, tp = job["kind"], job.get("tp", 1)
    if kind == "single":
        eng = Engine(family, cfg, params, ec, device="cpu", **kw)
    elif kind == "sharded":
        eng = sharded_engine(family, cfg, params, ec, tensor_parallel=tp,
                             device="cpu", **kw)
    else:
        eng = PodEngine(family, cfg, params, ec, PodConfig(
            prefill_workers=1, decode_workers=1, tensor_parallel=tp),
            device="cpu", **kw)
    return eng, _serving_trace(eng, cfg.vocab_size, job.get("trace", {}))


def tensor_parallel_serving(out_dir: str, jobs: list) -> None:
    """Serve each job on this rank and record what it gave. A job is a
    dict: `family` ("gpt2" or "llama", the tiny config with `config`
    overrides), `params` (a numpy tree, `models.convert`'s layout),
    `engine` (`EngineConfig` fields; f32 pools), `kind` ("sharded",
    "pod" or "single"), `tp` (the model axis), `trace` (see
    `_serving_trace`), `clock_steps` (a fake clock's step per rank, for
    the lockstep check) and `name`."""
    from ..serving.sanitizer import check_engine, check_router
    from ..state import PartialState

    torch.set_num_threads(1)
    st = PartialState(cpu=True)
    out = {}
    for job in jobs:
        eng, reqs = serve_job(job, st.process_index)
        res = {"tokens": [list(r.tokens) for r in reqs],
               "status": [r.status.value for r in reqs],
               "shed": [r.shed_code for r in reqs],
               "compile_stats": eng.compile_stats()}
        engines = getattr(eng, "decode_workers", [eng])
        inner = engines[0]
        res["mesh"] = inner.engine_config.mesh is not None
        res["graphs_captured"] = inner.graphs_captured
        if inner.cache_shardings is not None:
            res["pool_spec"] = tuple(inner.cache_shardings[0].k.spec)
            res["scale_spec"] = (
                None if inner.cache_shardings[0].k_scale is None
                else tuple(inner.cache_shardings[0].k_scale.spec))
        res["pool_shape"] = tuple(inner.cache.k.shape)
        res["scale_shape"] = (None if inner.cache.k_scale is None
                              else tuple(inner.cache.k_scale.shape))
        for e in engines:
            check_engine(e)
        if hasattr(eng, "decode_workers"):
            check_router(eng)
        if hasattr(eng, "metrics_summary"):
            summ = eng.metrics_summary()
            res["shipments"] = summ.get("pod_shipments")
        out[job["name"]] = res
    _dump(out_dir, out)


def shard_forms(out_dir: str, cases: dict) -> None:
    """This rank's `sharding.shard_pytree` shard of each case's numpy tree
    ({name: (mesh axes, tree)}), as numpy, with the plan's specs."""
    from ..sharding import plan_sharding, shard_pytree
    from ..state import PartialState, ProcessMesh

    PartialState(cpu=True)
    out = {}
    for name, (axes, tree) in cases.items():
        mesh = ProcessMesh(axes, device="cpu")
        plan = plan_sharding(tree, mesh)
        shards = shard_pytree(tree, plan)
        out[name] = {
            "shards": _numpy_tree(shards),
            "groups": {a: g is not None for a, g in mesh.groups.items()},
            "axis_index": {a: mesh.axis_index(a) for a in mesh.axis_names},
        }
    _dump(out_dir, out)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


# -- pipelines and sharded inference ------------------------------------------

# stage and layer bodies of the pipeline cases, by name (a spawned world
# imports them; the reference tests' `tests/test_parallel.py` and
# `tests/test_inference.py` bodies)
_STAGE_FNS = {
    # one layer a stage, `w`/`b` stacked [1, ...] in the stage's slice
    "tanh_wb": lambda p, x: torch.tanh(x @ p["w"][0] + p["b"][0]),
    "tanh_w": lambda p, x: torch.tanh(x @ p["w"][0]),
    # a residual MLP over the stage's (or chunk's) layers
    "residual_mlp": lambda p, x: _residual_mlp(p, x),
}
_LAYER_FNS = {
    "tanh_affine": lambda layer, x: torch.tanh(x @ layer["w"] + layer["b"]),
    "residual_tanh": lambda layer, x: x + torch.tanh(
        x @ layer["kernel"] + layer["bias"]),
}
_EDGE_FNS = {"double": lambda h: h * 2.0, "plus_one": lambda h: h + 1.0}


def _residual_mlp(params, x):
    for i in range(params["w"].shape[0]):
        x = x + torch.tanh(x @ params["w"][i]) * 0.5
    return x


def _mse(y, t):
    return torch.mean((y - t) ** 2)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _stats(st) -> dict:
    return {"max_saved_inputs": st.max_saved_inputs, "ticks": st.ticks,
            "handoffs": st.handoffs, "handoff_bytes": st.handoff_bytes}


def _llama(case):
    from ..models import llama

    return llama, llama.LlamaConfig(**case["config"])


def _llama_layer_fn(cfg):
    """One llama layer on x [b, S, h] (positions 0..S-1, no mask)."""
    from ..models import llama
    from ..models.common import rope_frequencies

    def layer_fn(layer, x):
        cos, sin = rope_frequencies(cfg.head_dim, x.shape[1], cfg.rope_theta,
                                    device=x.device)
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
        return llama._layer_body(cfg, x, layer, cos, sin, positions,
                                 None)[0]

    return layer_fn


def _case_apply(case, mesh):
    """`pipeline_apply` forward on the whole stacked tree; with `grad`,
    the gradients of sum(y**2) through the rank's block and `x`."""
    from ..parallel import pipeline_apply, stage_block

    fn = _STAGE_FNS[case["stage_fn"]]
    V = case.get("virtual_stages", 1)
    params, x = _tensors(case["params"]), _tensors(case["x"])
    out = {}
    for M in case["micro"]:
        out[f"y_{M}"] = pipeline_apply(fn, params, x, M, mesh=mesh,
                                       virtual_stages=V).numpy()
    if case.get("grad"):
        block = stage_block(params, mesh)
        leaves = {k: v.requires_grad_() for k, v in block.items()}
        xg = x.clone().requires_grad_()
        with torch.enable_grad():
            y = pipeline_apply(fn, leaves, xg, case["micro"][0], mesh=mesh)
            loss = (y ** 2).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()) + [xg])
        out["grads"] = {k: g.numpy() for k, g in zip(leaves, grads)}
        out["x_grad"] = grads[-1].numpy()
    return out


def _case_value_and_grad(case, mesh):
    """`pipeline_value_and_grad` per micro count and schedule, with the
    run's stats."""
    from ..parallel import ScheduleStats, pipeline_value_and_grad

    if case["stage_fn"] == "llama":
        from ..inference import make_stage_fn

        fn = make_stage_fn(_llama_layer_fn(_llama(case)[1]))
    else:
        fn = _STAGE_FNS[case["stage_fn"]]
    params = _tensors(case["params"])
    x, t = _tensors(case["x"]), _tensors(case["targets"])
    out = {}
    for M in case["micro"]:
        for schedule in case["schedules"]:
            st = ScheduleStats()
            loss, grads = pipeline_value_and_grad(
                fn, _mse, params, x, t, M, mesh=mesh, schedule=schedule,
                virtual_stages=case.get("virtual_stages", 1), stats=st)
            out[f"{schedule}_{M}"] = {"loss": float(loss),
                                     "grads": _numpy(grads),
                                     "stats": _stats(st)}
    return out


def _case_errors(case, mesh):
    """The validation errors, as (type name, message)."""
    from ..inference import prepare_pipeline
    from ..parallel import pipeline_apply, pipeline_value_and_grad
    from ..state import ProcessMesh

    flat = ProcessMesh({"data": mesh.size})
    w = {"w": torch.zeros((4, 4, 4))}
    x = torch.zeros((4, 4))
    calls = {
        "apply_no_stage": lambda: pipeline_apply(
            lambda p, h: h, {"w": torch.zeros((2, 1))}, torch.zeros((4, 1)),
            2, mesh=flat),
        "schedule": lambda: pipeline_value_and_grad(
            _STAGE_FNS["tanh_wb"], _mse, {}, x, x, 2, mesh=mesh,
            schedule="2f2b"),
        "interleaved_one_chunk": lambda: pipeline_value_and_grad(
            _STAGE_FNS["residual_mlp"], _mse, w, x, x, 2, mesh=mesh,
            schedule="interleaved", virtual_stages=1),
        "gpipe_chunks": lambda: pipeline_value_and_grad(
            _STAGE_FNS["residual_mlp"], _mse, w, x, x, 2, mesh=mesh,
            schedule="gpipe", virtual_stages=2),
        "vg_no_stage": lambda: pipeline_value_and_grad(
            _STAGE_FNS["residual_mlp"], _mse, w, x, x, 2, mesh=flat),
        "batch": lambda: pipeline_apply(
            _STAGE_FNS["residual_mlp"], w, torch.zeros((3, 4)), 2,
            mesh=mesh),
        "stage_dim": lambda: pipeline_apply(
            _STAGE_FNS["residual_mlp"], {"w": torch.zeros((3, 4, 4))}, x, 2,
            mesh=mesh),
        "prepare_no_stage": lambda: prepare_pipeline(
            _LAYER_FNS["tanh_affine"], {"w": torch.zeros((8, 4, 4)),
                                        "b": torch.zeros((8, 4))},
            mesh=flat, device="cpu"),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def _case_prepare(case, mesh):
    """`prepare_pipeline` over a layer body and optional edges, for each
    chunk count (None: the default)."""
    from ..inference import prepare_pipeline

    out = {}
    if case["layer_fn"] == "llama":
        llama, cfg = _llama(case)
        from ..models.common import rms_norm

        params = _tensors(case["params"])
        layer_fn = _llama_layer_fn(cfg)

        def pre(ids):
            return params["embed_tokens"]["embedding"][ids.long()]

        def post(h):
            h = rms_norm(h, params["norm"]["scale"], cfg.rms_norm_eps)
            return llama._project_out(cfg, params, h)

        layers, edges = params["layers"], (pre, post)
    else:
        layer_fn = _LAYER_FNS[case["layer_fn"]]
        layers = _tensors(case["params"])
        edges = tuple(_EDGE_FNS.get(case.get(k)) for k in ("pre", "post"))
    for chunks in case["chunks"]:
        model = prepare_pipeline(layer_fn, layers, num_chunks=chunks,
                                 mesh=mesh, pre_fn=edges[0],
                                 post_fn=edges[1], device="cpu")
        out[f"y_{chunks}"] = model(case["x"]).numpy()
        out[f"num_chunks_{chunks}"] = model.num_chunks
        out[f"stats_{chunks}"] = _stats(model.stats)
    out["num_stages"] = model.num_stages
    out["block_shapes"] = {
        k: tuple(v.shape) for k, v in _flat(model.stage_params).items()}
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def _leaf_bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in _flat(tree).values())


def _mlp_scan_forward(params, x):
    """The reference test's forward: tanh(x @ up) @ down over the
    stacked layers."""
    for i in range(params["layers"]["mlp"]["up_proj"]["kernel"].shape[0]):
        mlp = params["layers"]["mlp"]
        x = torch.tanh(x @ mlp["up_proj"]["kernel"][i])
        x = x @ mlp["down_proj"]["kernel"][i]
    return x


def _case_sharded(case, mesh):
    """`prepare_sharded_inference`: the route, this rank's shard bytes
    and the output."""
    import functools

    from ..inference import prepare_sharded_inference

    params = _tensors(case["params"])
    if case["forward"] == "llama":
        llama, cfg = _llama(case)
        forward = functools.partial(llama.forward, cfg)
    else:
        forward = _mlp_scan_forward
    fn, sharded = prepare_sharded_inference(forward, params, mesh=mesh,
                                            device="cpu")
    return {"route": fn.route, "y": fn(sharded, _tensors(case["x"])).numpy(),
            "bytes": _leaf_bytes(sharded), "whole_bytes": _leaf_bytes(params)}


def _case_dispatch(case, mesh):
    """`dispatch_model(params, "sharded")` and
    `load_checkpoint_and_dispatch(device_map="sharded")` across the world,
    then the family's forward on the shards."""
    from ..big_modeling import dispatch_model, init_empty_weights, \
        load_checkpoint_and_dispatch

    llama, cfg = _llama(case)
    params = _tensors(case["params"])
    ids = _tensors(case["x"])
    out = {}
    for mode in ("sharded", None):
        placed = dispatch_model(params, mode, device="cpu")
        out[f"y_{mode}"] = llama.forward(cfg, placed, ids).numpy()
        out[f"bytes_{mode}"] = _leaf_bytes(placed)
        out[f"mesh_{mode}"] = dict(placed.mesh.shape)
    out["whole_bytes"] = _leaf_bytes(params)
    try:
        dispatch_model(params, "sharded", mesh_axis="fsdp", device="cpu")
        out["fsdp_axis"] = None
    except NotImplementedError as e:
        out["fsdp_axis"] = str(e)
    abstract = init_empty_weights(llama.init_params, cfg, 0)
    loaded = load_checkpoint_and_dispatch(
        abstract, case["checkpoint"], device_map="sharded", device="cpu")
    out["y_checkpoint"] = llama.forward(cfg, loaded, ids).numpy()
    out["bytes_checkpoint"] = _leaf_bytes(loaded)
    return out


def _case_accelerator(case, mesh):
    """An Accelerator on a `data` x `stage` mesh: its mesh, a pipeline on
    it, a 1F1B step on its stage lines, and the training calls
    (`_training_calls`); then a `model` axis's refusal."""
    from ..accelerator import Accelerator
    from ..inference import prepare_pipeline
    from ..parallel import pipeline_value_and_grad
    from ..state import PartialState
    from ..utils.dataclasses import MeshConfig

    PartialState._reset_state()
    acc = Accelerator(cpu=True, mesh_config=MeshConfig(axes=case["axes"]))
    out = {"mesh": dict(acc.mesh.shape),
           "stage_index": acc.mesh.axis_index("stage"),
           "stage_line": acc.mesh.axis_ranks("stage")}
    layers = _tensors(case["params"])
    model = prepare_pipeline(_LAYER_FNS["tanh_affine"], layers,
                             mesh=acc.mesh, device="cpu")
    out["y"] = model(case["x"]).numpy()
    staged = {k: v.reshape((2, -1) + tuple(v.shape[1:]))
              for k, v in layers.items()}
    loss, grads = pipeline_value_and_grad(
        _tanh_affine_stage, _mse, staged,
        _tensors(case["x"]), _tensors(case["x"]) * 0.5, 4, mesh=acc.mesh)
    out["loss"], out["grads"] = float(loss), _numpy(grads)
    out["trained"] = _training_calls(acc)
    w = {"w": torch.zeros((2, 2))}
    out["params_prepared"] = acc.prepare(w)["w"].shape == (2, 2)
    for axes in case["refused_axes"]:
        PartialState._reset_state()
        try:
            Accelerator(cpu=True, mesh_config=MeshConfig(axes=axes))
            out.setdefault("model_axis", []).append(None)
        except NotImplementedError as e:
            out.setdefault("model_axis", []).append(str(e))
    PartialState._reset_state()
    PartialState(cpu=True)
    return out


def _tanh_affine_stage(p, x):
    for i in range(p["w"].shape[0]):
        x = _LAYER_FNS["tanh_affine"]({"w": p["w"][i], "b": p["b"][i]}, x)
    return x


def _case_p2p(case, mesh):
    """`axis_ppermute` around the stage line (f32 and bf16, both ways),
    one edge alone, and `axis_broadcast` from the last rank, on
    rank-stamped tensors."""
    from ..utils import operations as ops

    group, n = mesh.group("stage"), mesh.shape["stage"]
    r = mesh.axis_index("stage")
    mine = torch.full((3,), float(r))
    half = torch.full((2, 2), r + 0.5, dtype=torch.bfloat16)
    edge = ops.axis_ppermute(mine if r == 0 else None, group,
                             recv_like=mine if r == 1 else None)
    return {
        "next": ops.axis_ppermute(mine, group, 1, recv_like=mine).numpy(),
        "prev": ops.axis_ppermute(mine, group, -1, recv_like=mine).numpy(),
        "bf16": ops.axis_ppermute(half, group, 1, recv_like=half)
        .float().numpy(),
        "bf16_dtype": str(ops.axis_ppermute(half, group, 1,
                                            recv_like=half).dtype),
        "edge": None if edge is None else edge.numpy(),
        "broadcast": ops.axis_broadcast(half, group, n - 1).float().numpy(),
        "mine_after": mine.numpy(),
    }


_PIPELINE_CASES = {
    "p2p": _case_p2p,
    "apply": _case_apply,
    "value_and_grad": _case_value_and_grad,
    "errors": _case_errors,
    "prepare": _case_prepare,
    "sharded": _case_sharded,
    "dispatch": _case_dispatch,
    "accelerator": _case_accelerator,
}


def pipeline_forms(out_dir: str, cases: list) -> None:
    """Run each pipeline or sharded-inference case on this rank and
    record what it gave. A case is a dict: `name`, `kind` (a key of
    `_PIPELINE_CASES`), `mesh` ({axis: size} over the world), numpy
    inputs (`params`, `x`, `targets`, ...) and the kind's options."""
    from ..state import PartialState, ProcessMesh

    torch.set_num_threads(1)
    PartialState(cpu=True)
    out = {}
    for case in cases:
        mesh = ProcessMesh(case.get("mesh", {"stage": PartialState
                                             .num_processes}), device="cpu")
        out[case["name"]] = _PIPELINE_CASES[case["kind"]](case, mesh)
    _dump(out_dir, out)


# -- sequence and expert parallelism ------------------------------------------


class _Counting:
    """Counts the calls of module functions, patched for the rest of the
    world's run (each rank's own counts)."""

    def __init__(self):
        self.counts: dict[str, int] = {}

    def patch(self, module, name: str, tag: str) -> None:
        fn = getattr(module, name)

        def counted(*a, **kw):
            self.counts[tag] = self.counts.get(tag, 0) + 1
            return fn(*a, **kw)

        setattr(module, name, counted)

    def take(self) -> dict:
        out, self.counts = self.counts, {}
        return out


def _cp_attention_fn(case, mesh):
    from ..parallel import context_attention, ring_attention, \
        ulysses_attention

    kw = {"mesh": mesh}
    if case.get("window") is not None:
        kw["window"] = case["window"]
    if case["fn"] == "ring":
        return lambda q, k, v, m: ring_attention(
            q, k, v, causal=case["causal"], mask=m, **kw)
    if case["fn"] == "ulysses":
        return lambda q, k, v, m: ulysses_attention(
            q, k, v, causal=case["causal"], mask=m, **kw)
    return lambda q, k, v, m: context_attention(
        q, k, v, causal=case["causal"], mode=case.get("mode"), **kw)


def _case_cp_attention(case, mesh, counter):
    """Ring, Ulysses or `context_attention` on the whole q/k/v (every rank
    the same); with `grad`, the gradients of sum((out * w)**2), w the key
    mask on the query rows (or 1)."""
    fn = _cp_attention_fn(case, mesh)
    q, k, v = (_tensors(case[n]) for n in ("q", "k", "v"))
    mask = None if case.get("mask") is None else _tensors(case["mask"])
    out = {}
    if not case.get("grad"):
        with torch.no_grad():
            out["out"] = fn(q, k, v, mask).numpy()
        out["calls"] = counter.take()
        return out
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    w = torch.ones(q.shape[:2]) if mask is None else mask.float()
    with torch.enable_grad():
        y = fn(*leaves, mask)
        loss = ((y * w[:, :, None, None]) ** 2).sum()
    grads = torch.autograd.grad(loss, leaves)
    out["out"] = y.detach().numpy()
    out["grads"] = [g.numpy() for g in grads]
    out["calls"] = counter.take()
    return out


def _case_cp_errors(case, mesh, counter):
    from ..parallel import ring_attention, ulysses_attention

    q = torch.zeros((1, 8, 4, 4))
    calls = {
        "ring_window_noncausal": lambda: ring_attention(
            q, q, q, causal=False, window=4, mesh=mesh),
        "ulysses_window_noncausal": lambda: ulysses_attention(
            q, q, q, causal=False, window=4, mesh=mesh),
        "ring_mask_shape": lambda: ring_attention(
            q, q, q, mask=torch.ones((1, 4)), mesh=mesh),
        "ulysses_mask_shape": lambda: ulysses_attention(
            q, q, q, mask=torch.ones((1, 4)), mesh=mesh),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    counter.take()
    return out


def _case_cp_llama(case, mesh, counter):
    """llama's logits with each attention backend on the whole batch (the
    process state's mesh is `mesh`); with `loss_backend`, the causal-LM
    loss and its gradients through that backend."""
    import dataclasses

    from ..models import llama
    from ..state import PartialState

    cfg = llama.LlamaConfig(**case["config"])
    params = _tensors(case["params"])
    ids = torch.from_numpy(np.asarray(case["ids"])).long()
    mask = None if case.get("mask") is None else \
        torch.from_numpy(np.asarray(case["mask"]))
    PartialState().set_mesh(mesh)
    out = {}
    try:
        for backend in case["backends"]:
            c = dataclasses.replace(
                cfg, attention_backend=backend,
                sequence_parallel=case.get("sequence_parallel", False))
            with torch.no_grad():
                out[f"logits_{backend}"] = llama.forward(
                    c, params, ids, attention_mask=mask).numpy()
            out[f"calls_{backend}"] = counter.take()
        if case.get("loss_backend"):
            c = dataclasses.replace(cfg,
                                    attention_backend=case["loss_backend"])
            leaves = {k: v.clone().requires_grad_()
                      for k, v in _flat(params).items()}
            tree = _unflat(leaves)
            batch = {"input_ids": ids}
            if mask is not None:
                batch["attention_mask"] = mask
            with torch.enable_grad():
                loss = llama.causal_lm_loss(c, tree, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            out["loss"] = float(loss.detach())
            out["grads"] = {k: g.numpy() for k, g in zip(leaves, grads)}
            out["calls_loss"] = counter.take()
    finally:
        PartialState().set_mesh(None)
    return out


def _unflat(flat: dict):
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return tree


def _line(acc) -> tuple:
    """(size, index) of this rank's batch line."""
    line = acc._data_line()
    return line.size, line.index


def _training_calls(acc) -> dict:
    """Each training call of the Accelerator on its mesh, on a linear
    least-squares model over a global batch of two batches of 4 rows:
    `errors` (each call's error, None where it ran), the batch-line
    index and the rows this rank's loader gave, the fused step's loss and
    updated `w`, and the grads and loss of `compute_gradients` (through
    `backward` into a prepared optimizer's buffer)."""
    from .. import optimizers
    from ..training import TrainState

    x = (np.arange(16, dtype=np.float32).reshape(8, 2) - 7.5) / 8
    y = np.stack([x[:, 0] * 2 - x[:, 1], x[:, 1] * 0.5 + 1], axis=1)
    batches = [{"x": x[:4], "y": y[:4]}, {"x": x[4:], "y": y[4:]}]

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    def fresh():
        return {"w": torch.zeros((2, 2))}

    out = {"global_x": x, "global_y": y, "line": _line(acc),
           "errors": {}}
    got = {}
    calls = {
        "train_state": lambda: got.update(state=acc.prepare(
            TrainState.create(apply_fn=None, params=fresh(),
                              tx=optimizers.adamw(1e-3)))),
        "optimizer": lambda: got.update(opt=acc.prepare_optimizer(
            optimizers.adamw(1e-3), params=fresh())),
        "data_loader": lambda: got.update(rows=list(acc.prepare(batches))),
        "train_step": lambda: got.update(step=acc.train_step(loss_fn)(
            got["state"], got["rows"][0])),
        "compute_gradients": lambda: got.update(grads=acc.compute_gradients(
            loss_fn, got["opt"].params, got["rows"][0])),
        "backward": lambda: acc.backward(got["grads"][1]),
    }
    for name, call in calls.items():
        try:
            call()
            out["errors"][name] = None
        except Exception as e:  # recorded: the test names the call
            out["errors"][name] = f"{type(e).__name__}: {e}"
    if "rows" in got:
        out["rows"] = [_numpy(b) for b in got["rows"]]
    if "step" in got:
        state, m = got["step"]
        out["step_loss"] = float(m["loss"])
        out["step_w"] = state.params["w"].numpy()
    if "grads" in got:
        loss, grads = got["grads"]
        out["loss"], out["grads"] = float(loss), grads["w"].numpy()
        out["buffer"] = got["opt"].gradients["w"].numpy()
    return out


def _case_cp_accelerator(case, mesh, counter):
    """The context-parallel plugin (given, then from the launcher's
    variables), the mesh it resolves, `Accelerator.context_attention` by
    mode, and the training calls on `seq` and `expert` meshes
    (`_training_calls`)."""
    from ..accelerator import Accelerator
    from ..state import PartialState
    from ..utils.constants import ENV_CP_DEGREE, ENV_CP_MODE
    from ..utils.dataclasses import ContextParallelPlugin, MeshConfig

    q, k, v = (_tensors(case[n]) for n in ("q", "k", "v"))
    out = {}
    PartialState._reset_state()
    acc = Accelerator(cpu=True, context_parallel_plugin=ContextParallelPlugin(
        seq_degree=2, mode="ulysses"))
    out["plugin_mesh"] = dict(acc.mesh.shape)
    with torch.no_grad():
        out["plugin_out"] = acc.context_attention(q, k, v).numpy()
    out["plugin_calls"] = counter.take()
    out["trained_seq"] = _training_calls(acc)
    out["params_prepared"] = tuple(acc.prepare(
        {"w": torch.zeros((2, 2))})["w"].shape)
    PartialState._reset_state()
    os.environ[ENV_CP_MODE] = "ring"
    os.environ[ENV_CP_DEGREE] = str(PartialState.num_processes)
    try:
        acc = Accelerator(cpu=True)
        out["env_plugin"] = (acc.context_parallel_plugin.mode,
                             acc.context_parallel_plugin.seq_degree)
        out["env_mesh"] = dict(acc.mesh.shape)
        with torch.no_grad():
            out["env_out"] = acc.context_attention(q, k, v).numpy()
        out["env_calls"] = counter.take()
    finally:
        del os.environ[ENV_CP_MODE], os.environ[ENV_CP_DEGREE]
    PartialState._reset_state()
    acc = Accelerator(cpu=True, mesh_config=MeshConfig(
        axes={"data": -1, "expert": 2}))
    out["expert_mesh"] = dict(acc.mesh.shape)
    out["trained_expert"] = _training_calls(acc)
    PartialState._reset_state()
    PartialState(cpu=True)
    return out


_CP_CASES = {
    "attention": _case_cp_attention,
    "errors": _case_cp_errors,
    "llama": _case_cp_llama,
    "accelerator": _case_cp_accelerator,
}


def context_parallel_forms(out_dir: str, cases: list) -> None:
    """Run each sequence-parallel case on this rank and record what it
    gave, with the calls of the flash entry points (K1a `fwd`, K1b+K1c
    `bwd`) this rank made in it. A case is a dict: `name`, `kind` (a key
    of `_CP_CASES`), `mesh` ({axis: size} over the world) and numpy
    inputs."""
    import importlib

    from ..state import PartialState, ProcessMesh

    # the modules (the package's `ring_attention` is the function)
    ring_mod = importlib.import_module(
        "accelerate_tpu_torch.parallel.ring_attention")
    ulysses_mod = importlib.import_module(
        "accelerate_tpu_torch.parallel.ulysses")

    torch.set_num_threads(1)
    PartialState(cpu=True)
    counter = _Counting()
    for mod, tag in ((ring_mod, "ring"), (ulysses_mod, "ulysses")):
        counter.patch(mod, "flash_forward", f"{tag}_fwd")
        counter.patch(mod, "flash_backward", f"{tag}_bwd")
    out = {}
    for case in cases:
        mesh = ProcessMesh(case["mesh"], device="cpu")
        out[case["name"]] = _CP_CASES[case["kind"]](case, mesh, counter)
    _dump(out_dir, out)


_EXPERT_FNS = {
    "tanh": lambda p, xs: torch.tanh(xs @ p["w"]),
    "identity": lambda p, xs: xs @ p["w"],
}


def _case_ep_moe(case, mesh):
    """`expert_parallel_moe_a2a` or `expert_parallel_moe` on the whole
    tokens (every rank the same), for each top-k; with `grad`, the
    gradients of sum(y**2) through the params and x. `shard` passes this
    rank's block of the experts (`sharding.plan_sharding`'s placement)
    instead of the whole stack."""
    from ..parallel import expert_parallel_moe, expert_parallel_moe_a2a
    from ..sharding import ShardingRules, plan_sharding, shard_pytree

    impl = {"a2a": expert_parallel_moe_a2a,
            "replicated": expert_parallel_moe}[case["impl"]]
    fn = _EXPERT_FNS[case.get("expert_fn", "tanh")]
    x, logits = _tensors(case["x"]), _tensors(case["logits"])
    params = _tensors(case["params"])
    if case.get("shard"):
        rules = ShardingRules.from_pairs([("w$", ("expert", None, None))],
                                         min_weight_size=0)
        params = shard_pytree(params, plan_sharding(params, mesh, rules))
    kw = dict(mesh=mesh, capacity_factor=case["capacity_factor"],
              return_stats=case.get("stats", False))
    out = {"param_shapes": {k: tuple(v.shape) for k, v in params.items()}}
    for k in case["top_k"]:
        with torch.no_grad():
            res = impl(x, logits, params, fn, top_k=k, **kw)
        y, extras = res if isinstance(res, tuple) else (res, {})
        out[f"y_{k}"] = y.numpy()
        if "moe_dropped_fraction" in extras:
            out[f"dropped_{k}"] = float(extras["moe_dropped_fraction"])
    if case.get("grad"):
        leaves = {n: t.clone().requires_grad_() for n, t in params.items()}
        xg = x.clone().requires_grad_()
        with torch.enable_grad():
            y = impl(xg, logits, leaves, fn, top_k=case["top_k"][0], **kw)
            y = y[0] if isinstance(y, tuple) else y
            loss = (y ** 2).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()) + [xg])
        out["grads"] = {n: g.numpy() for n, g in zip(leaves, grads)}
        out["x_grad"] = grads[-1].numpy()
    return out


def _case_ep_fallback(case, mesh):
    """The divisibility fallback: its warning, `strict`, and a clean call
    that warns nothing."""
    import warnings

    from ..parallel import MoEFallbackWarning, expert_parallel_moe, \
        expert_parallel_moe_a2a

    fn = _EXPERT_FNS["tanh"]
    x, p6, l6 = (_tensors(case[n]) for n in ("x", "p6", "l6"))
    p8, l8 = _tensors(case["p8"]), _tensors(case["l8"])
    out = {}

    def record(name, call):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            try:
                res = call()
                out[name] = {"shape": tuple(res.shape)}
            except ValueError as e:
                out[name] = {"error": str(e)}
        out[name]["warned"] = [str(w.message) for w in seen
                               if issubclass(w.category, MoEFallbackWarning)]

    record("a2a_6", lambda: expert_parallel_moe_a2a(
        x, l6, p6, fn, mesh=mesh, top_k=2))
    record("a2a_6_strict", lambda: expert_parallel_moe_a2a(
        x, l6, p6, fn, mesh=mesh, top_k=2, strict=True))
    record("a2a_tokens_strict", lambda: expert_parallel_moe_a2a(
        x[:case["odd_tokens"]], l8[:case["odd_tokens"]], p8, fn, mesh=mesh,
        top_k=2, strict=True))
    record("a2a_clean", lambda: expert_parallel_moe_a2a(
        x, l8, p8, fn, mesh=mesh, top_k=2, strict=True))
    record("replicated_6", lambda: expert_parallel_moe(
        x, l6, p6, fn, mesh=mesh, top_k=2))
    try:
        expert_parallel_moe_a2a(x, l8, p8, fn, mesh=mesh, top_k=2,
                                expert_aux={"a": torch.zeros(())})
        out["aux_without_topk"] = None
    except ValueError as e:
        out["aux_without_topk"] = str(e)
    return out


def _case_ep_mixtral(case, mesh):
    """Mixtral's logits and aux loss with `moe_impl="a2a"` on the process
    state's mesh (the whole expert stack, or each rank's block), with
    fp8 (`fp8`: the logits and the new moe metas' scales), and the
    causal-LM loss's gradients on `loss_ids`. Where the mesh's batch line
    is longer than one, each rank takes its line's share of the rows of
    `ids` and `loss_ids`, as a loader gives them (`line`: its size,
    index and ranks)."""
    import dataclasses

    from ..models import mixtral
    from ..sharding import plan_sharding, shard_pytree
    from ..state import PartialState

    cfg = mixtral.MixtralConfig(**case["config"])
    params = _tensors(case["params"])
    line = mesh.data_line()

    def rows(x):
        x = torch.from_numpy(np.asarray(x)).long()
        b = x.shape[0] // line.size
        return x[line.index * b:(line.index + 1) * b]

    ids = rows(case["ids"])
    PartialState().set_mesh(mesh)
    out = {"line": (line.size, line.index,
                    tuple(mesh.line_ranks(line.axes)) if line.size > 1
                    else (mesh.rank,))}
    try:
        with torch.no_grad():
            logits, aux = mixtral.forward(cfg, params, ids)
            out["logits"], out["aux"] = logits.numpy(), float(aux)
            sharded = shard_pytree(params, plan_sharding(params, mesh))
            out["expert_shape"] = tuple(
                sharded["layers"]["moe"]["experts"]["gate_proj"]["kernel"]
                .shape)
            out["logits_sharded"] = mixtral.forward(cfg, sharded,
                                                    ids)[0].numpy()
            out["logits_sp"] = mixtral.forward(
                dataclasses.replace(cfg, sequence_parallel=True), params,
                ids)[0].numpy()
            if case.get("fp8"):
                f_logits, _, new = mixtral.forward(
                    cfg, params, ids,
                    fp8_state=mixtral.init_fp8_state(cfg, device="cpu"))
                out["fp8_logits"] = f_logits.numpy()
                out["fp8_scales"] = {
                    n: (new["layers"]["moe"][n]["x"].scale.numpy(),
                        new["layers"]["moe"][n]["w"].scale.numpy())
                    for n in ("gate_proj", "up_proj", "down_proj")}
        leaves = {k: v.clone().requires_grad_()
                  for k, v in _flat(params).items()}
        loss_ids = rows(case["loss_ids"])
        with torch.enable_grad():
            loss = mixtral.causal_lm_loss(cfg, _unflat(leaves),
                                          {"input_ids": loss_ids})
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out["loss"] = float(loss.detach())
        out["grads"] = {k: g.numpy() for k, g in zip(leaves, grads)}
    finally:
        PartialState().set_mesh(None)
    return out


_EP_CASES = {
    "moe": _case_ep_moe,
    "fallback": _case_ep_fallback,
    "mixtral": _case_ep_mixtral,
}


def expert_parallel_forms(out_dir: str, cases: list) -> None:
    """Run each expert-parallel case on this rank and record what it
    gave. A case is a dict: `name`, `kind` (a key of `_EP_CASES`),
    `mesh` ({axis: size} over the world) and numpy inputs."""
    from ..state import PartialState, ProcessMesh

    torch.set_num_threads(1)
    PartialState(cpu=True)
    out = {}
    for case in cases:
        mesh = ProcessMesh(case["mesh"], device="cpu")
        out[case["name"]] = _EP_CASES[case["kind"]](case, mesh)
    _dump(out_dir, out)


# -- training on `stage`, `seq` and `expert` meshes ----------------------------


def _whole_numpy(tree):
    """A params tree as host arrays, each block (`sharding.placement_of`)
    gathered over its line into the whole leaf (`sharding.whole_pytree`):
    a collective, called by every rank of the mesh."""
    from ..sharding.planner import whole_pytree

    return _numpy(whole_pytree(tree))


def _train_loop(acc, state, loader, loss_fn, steps):
    """`steps` passes of the fused step over `loader`: the state, each
    step's loss and the rows each step trained on."""
    step = acc.train_step(loss_fn)
    losses, rows = [], []
    for _ in range(steps):
        for batch in loader:
            rows.append(_numpy(batch))
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return state, losses, rows


def _refusal(call):
    try:
        call()
    except NotImplementedError as e:
        return str(e)
    return None


def _save_reload(acc, path, state=None) -> bool:
    """`save_state` into `path` (of `state`, and the prepared eager
    optimizers), then every saved tensor wiped in place and `load_state`
    from `path`: whether each came back bit for bit (the blocks a rank
    holds included)."""
    from ..optimizers import tree_leaves
    from ..training import clone_tree

    trees = [] if state is None else [state.params, state.opt_state]
    trees += [t for opt in acc._optimizers
              for t in (opt.params, opt.opt_state) if t is not None]
    acc.save_state(path, state=state)
    saved = clone_tree(trees)
    with torch.no_grad():
        for leaf in tree_leaves(trees):
            leaf.zero_()
    acc.load_state(path, state=state)
    return all(torch.equal(a, b) for a, b in zip(tree_leaves(trees),
                                                tree_leaves(saved)))


def _state_dict_is_whole(acc, state) -> bool:
    """Whether `get_state_dict` gives the params whole (each block
    gathered over its line), as `_whole_numpy` gathers them."""
    got = {k: v.numpy() for k, v in _flat(acc.get_state_dict(state)).items()}
    want = _flat(_whole_numpy(state.params))
    return set(got) == set(want) and all(
        np.array_equal(got[k], want[k]) for k in want)


def _case_train_cp(case):
    """The long-context example's loop: the plugin's mesh, a prepared
    `TrainState` and loader, `train_step` of llama with the ring or
    Ulysses backend."""
    from .. import optimizers
    from ..accelerator import Accelerator
    from ..models import llama
    from ..state import PartialState
    from ..training import TrainState
    from ..utils.dataclasses import ContextParallelPlugin, \
        DataLoaderConfiguration

    PartialState._reset_state()
    acc = Accelerator(
        cpu=True, gradient_clipping=1.0,
        context_parallel_plugin=ContextParallelPlugin(
            mode=case["mode"], seq_degree=case["seq_degree"]),
        dataloader_config=DataLoaderConfiguration(split_batches=True))
    cfg = llama.LlamaConfig.tiny(**case["config"],
                                 attention_backend=case["mode"])
    state = acc.prepare(TrainState.create(
        apply_fn=None, params=_tensors(case["params"]),
        tx=optimizers.adamw(case["lr"])))
    loader = acc.prepare([{"input_ids": case["ids"]}])
    state, losses, rows = _train_loop(
        acc, state, loader, lambda p, b: llama.causal_lm_loss(cfg, p, b),
        case["steps"])
    return {"mesh": dict(acc.mesh.shape), "line": _line(acc),
            "losses": losses, "rows": rows,
            "params": _whole_numpy(state.params)}


def _case_train_moe(case):
    """Mixtral on a `data` x `expert` mesh: the prepared state's expert
    blocks, the fused steps, the params gathered whole, one eager step's
    pre-clip norm, the forward on blocks against the forward on the
    whole experts, and the checkpoints of the blocks (a save and reload
    of the trained state, `get_state_dict`, an eager optimizer's save
    and reload)."""
    from .. import optimizers
    from ..accelerator import Accelerator
    from ..models import mixtral
    from ..state import PartialState
    from ..training import TrainState
    from ..utils.dataclasses import DataLoaderConfiguration, MeshConfig

    PartialState._reset_state()
    fp8 = case["mixed_precision"] == "fp8"
    acc = Accelerator(
        cpu=True, mixed_precision=case["mixed_precision"],
        gradient_clipping=1.0, mesh_config=MeshConfig(axes=case["axes"]),
        dataloader_config=DataLoaderConfiguration(split_batches=True))
    cfg = mixtral.MixtralConfig.tiny(**case["config"],
                                     moe_impl=case["impl"])
    state = acc.prepare(TrainState.create(
        apply_fn=None, params=_tensors(case["params"]),
        tx=optimizers.adamw(case["lr"]),
        fp8_state=mixtral.init_fp8_state(cfg, device="cpu") if fp8
        else None))
    experts = state.params["layers"]["moe"]["experts"]
    out = {"mesh": dict(acc.mesh.shape),
           "line": _line(acc),
           "expert_shapes": {n: tuple(p["kernel"].shape)
                             for n, p in experts.items()},
           "moment_shapes": {
               k: tuple(getattr(state.opt_state, k)["layers"]["moe"][
                   "experts"]["gate_proj"]["kernel"].shape)
               for k in ("mu", "nu")}}
    if fp8:
        def loss_fn(p, b, fp8_state=None):
            return mixtral.causal_lm_loss(cfg, p, b, fp8_state=fp8_state)
    else:
        def loss_fn(p, b):
            return mixtral.causal_lm_loss(cfg, p, b)
    loader = acc.prepare([{"input_ids": case["ids"]}])
    (batch,) = list(loader)
    if not fp8:
        # the forward on the blocks against the whole experts' (one
        # process's values), before any step
        whole = _tensors(case["params"])
        with torch.no_grad():
            out["loss_blocks"] = float(loss_fn(state.params, batch))
            out["loss_whole"] = float(loss_fn(whole, batch))
    state, out["losses"], out["rows"] = _train_loop(
        acc, state, loader, loss_fn, case["steps"])
    out["params"] = _whole_numpy(state.params)
    out["saved"] = os.path.join(case["tmp"], f"moe_{case['name']}")
    out["save_state"] = _save_reload(acc, out["saved"], state)
    out["get_state_dict"] = _state_dict_is_whole(acc, state)
    if not fp8:
        # the eager path's pre-clip norm on fresh params
        params = acc.prepare(_tensors(case["params"]))
        opt = acc.prepare_optimizer(optimizers.adamw(case["lr"]),
                                    params=params)
        loss, grads = acc.compute_gradients(loss_fn, opt.params, batch)
        acc.backward(grads)
        out["eager_loss"] = float(loss)
        out["pre_clip_norm"] = float(acc.clip_grad_norm_(max_norm=1.0))
        out["optimizer_save"] = _save_reload(
            acc, os.path.join(case["tmp"], f"eager_{case['name']}"))
    return out


def _case_train_moe_copies(case):
    """Mixtral's experts as blocks on a `data` x `expert` mesh, trained
    through copies: `train_step(donate=False)`, whose every step takes
    the copy the last one returned, with each step's pre-clip norm (the
    clip's own return); then the global batch's pre-clip norm at a copy
    of the final params through `compute_gradients`, `backward` into an
    optimizer prepared without params, and `clip_grad_norm_`; and the
    checkpoints of the copied state's blocks."""
    import dataclasses
    from unittest import mock

    from .. import accelerator as acc_mod
    from .. import optimizers
    from ..accelerator import Accelerator
    from ..models import mixtral
    from ..state import PartialState
    from ..training import TrainState, clone_tree
    from ..utils.dataclasses import DataLoaderConfiguration, MeshConfig

    PartialState._reset_state()
    acc = Accelerator(
        cpu=True, gradient_clipping=1.0,
        mesh_config=MeshConfig(axes=case["axes"]),
        dataloader_config=DataLoaderConfiguration(split_batches=True))
    cfg = mixtral.MixtralConfig.tiny(moe_impl="dense")

    def loss_fn(p, b):
        return mixtral.causal_lm_loss(cfg, p, b)

    state = acc.prepare(TrainState.create(
        apply_fn=None, params=_tensors(case["params"]),
        tx=optimizers.adamw(case["lr"])))
    (batch,) = list(acc.prepare([{"input_ids": case["ids"]}]))
    step = acc.train_step(loss_fn, donate=False)
    norms, losses, copied = [], [], []
    clip = acc_mod._clip_by_global_norm_

    def recorded(*a, **kw):
        norms.append(float(clip(*a, **kw)))
        return norms[-1]

    with mock.patch.object(acc_mod, "_clip_by_global_norm_", recorded):
        for _ in range(case["steps"]):
            new, m = step(state, batch)
            copied.append(new.params["layers"]["moe"]["experts"][
                "gate_proj"]["kernel"] is not state.params["layers"]["moe"][
                "experts"]["gate_proj"]["kernel"])
            state = new
            losses.append(float(m["loss"]))
    copy = dataclasses.replace(state, params=clone_tree(state.params),
                               opt_state=clone_tree(state.opt_state))
    opt = acc.prepare_optimizer(optimizers.adamw(case["lr"]))
    _, grads = acc.compute_gradients(loss_fn, copy.params, batch)
    acc.backward(grads)
    return {"line": _line(acc), "losses": losses, "step_norms": norms,
            "copied": copied, "params": _whole_numpy(state.params),
            "no_params": opt.params is None,
            "pre_clip_norm": float(acc.clip_grad_norm_(max_norm=1.0)),
            "save_state": _save_reload(
                acc, os.path.join(case["tmp"], "moe_copy"), copy),
            "get_state_dict": _state_dict_is_whole(acc, copy)}


def _case_train_padded(case):
    """llama's fused step on a `data` x `stage` mesh over a padded batch
    (`attention_mask`) whose batch lines hold different counts of real
    tokens: each step's loss and pre-clip norm (the clip's own return),
    and the params."""
    from unittest import mock

    from .. import accelerator as acc_mod
    from .. import optimizers
    from ..accelerator import Accelerator
    from ..models import llama
    from ..state import PartialState
    from ..training import TrainState
    from ..utils.dataclasses import DataLoaderConfiguration, MeshConfig

    PartialState._reset_state()
    acc = Accelerator(
        cpu=True, gradient_clipping=1.0,
        mesh_config=MeshConfig(axes=case["axes"]),
        dataloader_config=DataLoaderConfiguration(split_batches=True))
    cfg = llama.LlamaConfig.tiny()
    state = acc.prepare(TrainState.create(
        apply_fn=None, params=_tensors(case["params"]),
        tx=optimizers.adamw(case["lr"])))
    loader = acc.prepare([{"input_ids": case["ids"],
                           "attention_mask": case["mask"]}])
    norms = []
    clip = acc_mod._clip_by_global_norm_

    def recorded(*a, **kw):
        norms.append(float(clip(*a, **kw)))
        return norms[-1]

    with mock.patch.object(acc_mod, "_clip_by_global_norm_", recorded):
        state, losses, rows = _train_loop(
            acc, state, loader, lambda p, b: llama.causal_lm_loss(cfg, p, b),
            case["steps"])
    return {"line": _line(acc), "losses": losses, "norms": norms,
            "real_tokens": int(rows[0]["attention_mask"].sum()),
            "params": _numpy(state.params)}


def _case_train_moe_drop(case):
    """The a2a dispatch at a capacity that drops tokens, on a `data` x
    `expert` mesh: layer 0's MoE block (its experts this rank's block,
    as `prepare` places them) on this batch line's rows of `x`, with the
    dropped fraction of its dispatch (`return_stats`)."""
    from unittest import mock

    from ..accelerator import Accelerator
    from ..models import mixtral
    from ..optimizers import tree_map
    from ..state import PartialState
    from ..utils.dataclasses import MeshConfig

    PartialState._reset_state()
    acc = Accelerator(cpu=True, mesh_config=MeshConfig(axes=case["axes"]))
    cfg = mixtral.MixtralConfig.tiny(**case["config"], moe_impl="a2a")
    params = acc.prepare(_tensors(case["params"]))
    moe = tree_map(lambda p: p[0], params["layers"]["moe"])
    size, index = _line(acc)
    x = torch.from_numpy(np.asarray(case["x"]))
    rows = x.shape[0] // size
    dropped = []
    dispatch = mixtral.expert_parallel_moe_a2a

    def with_stats(*a, **kw):
        out, stats = dispatch(*a, return_stats=True, **kw)
        dropped.append(float(stats["moe_dropped_fraction"]))
        return out

    with torch.no_grad(), mock.patch.object(
            mixtral, "expert_parallel_moe_a2a", with_stats):
        y, aux, _ = mixtral.moe_block(
            cfg, moe, x[index * rows:(index + 1) * rows])
    return {"line": (size, index), "out": y.numpy(), "aux": float(aux),
            "dropped": dropped,
            "expert_shape": tuple(moe["experts"]["gate_proj"][
                "kernel"].shape)}


def _case_train_stage(case):
    """A `data` x `stage` mesh: `train_step` with `stage` as a replica
    axis, a save of its state, then `pipeline_value_and_grad`'s block
    gradients through `backward` and the clip into an optimizer prepared
    over `parallel.stage_block`."""
    from .. import optimizers
    from ..accelerator import Accelerator
    from ..parallel import pipeline_value_and_grad, stage_block
    from ..state import PartialState
    from ..training import TrainState
    from ..utils.dataclasses import DataLoaderConfiguration, MeshConfig

    PartialState._reset_state()
    acc = Accelerator(
        cpu=True, gradient_clipping=1.0,
        mesh_config=MeshConfig(axes=case["axes"]),
        dataloader_config=DataLoaderConfiguration(split_batches=True))

    def mlp_loss(p, b):
        return _mse(torch.tanh(b["x"] @ p["w"] + p["b"]), b["t"])

    state = acc.prepare(TrainState.create(
        apply_fn=None, params=_tensors(case["mlp"]),
        tx=optimizers.adamw(case["lr"])))
    loader = acc.prepare([{"x": case["x"], "t": case["t"]}])
    state, losses, rows = _train_loop(acc, state, loader, mlp_loss,
                                      case["steps"])
    out = {"mesh": dict(acc.mesh.shape),
           "line": _line(acc), "losses": losses,
           "rows": rows, "params": _numpy(state.params)}
    out["save_state"] = _refusal(lambda: acc.save_state(
        os.path.join(case["tmp"], "stage_checkpoint"), state=state))
    opt = acc.prepare_optimizer(
        optimizers.adamw(case["lr"]),
        params=stage_block(_tensors(case["staged"]), acc.mesh))
    x, t = _tensors(case["x"]), _tensors(case["t"])
    out["pipe_losses"], out["pipe_norms"] = [], []
    for _ in range(case["steps"]):
        loss, grads = pipeline_value_and_grad(
            _STAGE_FNS["tanh_wb"], _mse, opt.params, x, t,
            case["micro"], mesh=acc.mesh)
        acc.backward(grads)
        out["pipe_norms"].append(float(acc.clip_grad_norm_(max_norm=1.0)))
        opt.step()
        opt.zero_grad()
        out["pipe_losses"].append(float(loss))
    out["stage_index"] = acc.mesh.axis_index("stage")
    out["pipe_params"] = _numpy(opt.params)
    return out


def _case_train_loader(case):
    """A loader on a `data` x `seq` mesh: the rows each rank sees, and
    `gather_for_metrics` over an uneven epoch."""
    from ..accelerator import Accelerator
    from ..state import PartialState
    from ..utils.dataclasses import ContextParallelPlugin

    PartialState._reset_state()
    acc = Accelerator(cpu=True, context_parallel_plugin=ContextParallelPlugin(
        seq_degree=case["seq_degree"]))
    loader = acc.prepare([{"x": b} for b in case["batches"]])
    seen, gathered = [], []
    for batch in loader:
        seen.append(batch["x"].numpy())
        gathered.append(acc.gather_for_metrics(batch["x"]).numpy())
    return {"mesh": dict(acc.mesh.shape),
            "line": _line(acc),
            "seen": seen, "gathered": gathered}


_TRAIN_CASES = {
    "cp": _case_train_cp,
    "moe": _case_train_moe,
    "moe_copies": _case_train_moe_copies,
    "moe_drop": _case_train_moe_drop,
    "padded": _case_train_padded,
    "stage": _case_train_stage,
    "loader": _case_train_loader,
}


def sharded_training_forms(out_dir: str, cases: list) -> None:
    """Run each training case on this rank and record what it gave. A
    case is a dict: `name`, `kind` (a key of `_TRAIN_CASES`) and its
    numpy inputs; the Accelerator of each builds its own mesh over the
    world."""
    from ..state import PartialState

    torch.set_num_threads(1)
    out = {}
    for case in cases:
        out[case["name"]] = _TRAIN_CASES[case["kind"]](
            dict(case, tmp=out_dir))
    PartialState._reset_state()
    PartialState(cpu=True)
    _dump(out_dir, out)


# -- ZeRO-1/2 on the `fsdp` axis ------------------------------------------------


def _zero_accelerator(case):
    """An Accelerator with the case's DeepSpeed stage, mesh, precision,
    accumulation and clip, its loaders taking the source's batch as the
    global batch."""
    from ..accelerator import Accelerator
    from ..state import PartialState
    from ..utils.dataclasses import DataLoaderConfiguration, \
        DeepSpeedPlugin, MeshConfig

    PartialState._reset_state()
    return Accelerator(
        cpu=True, mixed_precision=case.get("mixed_precision", "no"),
        gradient_clipping=case.get("clip"),
        gradient_accumulation_steps=case.get("k", 1),
        deepspeed_plugin=DeepSpeedPlugin(zero_stage=case["zero_stage"]),
        mesh_config=MeshConfig(axes=case["axes"]),
        dataloader_config=DataLoaderConfiguration(split_batches=True))


def _zero_state(acc, case):
    """The case's tiny llama `TrainState` through `prepare` (with the
    case's fp16 loss scale, if any), and its loss function."""
    import dataclasses

    from .. import optimizers
    from ..models import llama
    from ..training import DynamicLossScale, TrainState

    cfg = llama.LlamaConfig.tiny()
    ts = TrainState.create(apply_fn=None, params=_tensors(case["params"]),
                           tx=optimizers.adamw(case["lr"]),
                           use_grad_accum_buffer=case.get("k", 1) > 1)
    if "loss_scale" in case:
        init, backoff = case["loss_scale"]
        ts = dataclasses.replace(ts, loss_scale=DynamicLossScale(
            scale=torch.tensor(init, dtype=torch.float32),
            growth_tracker=torch.tensor(0, dtype=torch.int32),
            backoff_factor=backoff))
    return acc.prepare(ts), lambda p, b: llama.causal_lm_loss(cfg, p, b)


def _moment_blocks(opt_state) -> dict:
    """{path: mu and nu block} of an AdamW state, as host arrays."""
    from ..sharding.planner import leaves_with_path

    return {f"{k}/{path}": leaf.detach().numpy()
            for k in ("mu", "nu")
            for path, leaf in leaves_with_path(getattr(opt_state, k))}


def _spied(names):
    """A context that records each call of `utils.operations`' `names`
    (the collective, its group's size, each tensor's element count), and
    the list it records into."""
    import contextlib
    from unittest import mock

    from ..utils import operations as ops

    calls = []

    def spy(name, fn):
        def wrapped(tensors, *a, **kw):
            group = kw.get("group", a[-1] if a else None)
            size = torch.distributed.get_world_size(group) \
                if group is not None else 1
            calls.append((name, size, [int(t.numel()) for t in tensors
                                       if t is not None]))
            return fn(tensors, *a, **kw)
        return wrapped

    stack = contextlib.ExitStack()
    for name in names:
        stack.enter_context(mock.patch.object(
            ops, name, spy(name, getattr(ops, name))))
    return stack, calls


def _case_zero_fused(case):
    """The fused step under the case's ZeRO stage: `prepare`, each
    step's loss and pre-clip norm (the clip's own return), the loss
    scale after each step, the params (whole on every rank), this rank's
    moment and buffer blocks, each leaf's cut dim, the collectives of
    step 1 (`_spied`), and with `save` a `save_state` of the final state
    into the case's directory with the moments gathered whole."""
    from unittest import mock

    from .. import accelerator as acc_mod
    from ..sharding.planner import leaves_with_path, whole_pytree

    acc = _zero_accelerator(case)
    state, loss_fn = _zero_state(acc, case)
    loader = acc.prepare([{"input_ids": ids} for ids in case["ids"]])
    step = acc.train_step(loss_fn)
    zero = acc._zero_layout(state.params)
    out = {"mesh": dict(acc.mesh.shape), "line": _line(acc),
           "fsdp": (acc.mesh.shape.get("fsdp", 1),
                    acc.mesh.coords(acc.mesh.rank).get("fsdp", 0)),
           "dims": None if zero is None else {
               path: d for (path, _), d in
               zip(leaves_with_path(state.params), _sorted_dims(
                   state.params, zero.dims))},
           "losses": [], "norms": [], "scales": [], "collectives": None}
    clip = acc_mod._clip_by_global_norm_

    def recorded(*a, **kw):
        out["norms"].append(float(clip(*a, **kw)))
        return out["norms"][-1]

    with mock.patch.object(acc_mod, "_clip_by_global_norm_", recorded):
        for _ in range(case["steps"]):
            for batch in loader:
                if out["collectives"] is None:
                    stack, calls = _spied(("reduce_scatter_mean_",
                                           "all_gather_blocks_",
                                           "all_reduce_mean_"))
                    with stack:
                        state, m = step(state, batch)
                    out["collectives"] = calls
                else:
                    state, m = step(state, batch)
                out["losses"].append(float(m["loss"]))
                if state.loss_scale is not None:
                    out["scales"].append(float(state.loss_scale.scale))
    out["params"] = _numpy(state.params)
    out["moments"] = _moment_blocks(state.opt_state)
    if state.grad_accum is not None:
        out["buffer_shapes"] = {path: tuple(leaf.shape) for path, leaf in
                                leaves_with_path(state.grad_accum)}
    if case.get("save"):
        path = os.path.join(case["tmp"], case["save"])
        acc.save_state(path, state=state)
        out["saved"] = path
        out["whole_moments"] = _moment_blocks(whole_pytree(state.opt_state))
        # the same directory back into a fresh prepared state
        fresh, _ = _zero_state(acc, case)
        acc.load_state(path, state=fresh)
        out["reloaded"] = all(
            torch.equal(a, b) for a, b in zip(
                [leaf for _, leaf in leaves_with_path(
                    (fresh.params, fresh.opt_state))],
                [leaf for _, leaf in leaves_with_path(
                    (state.params, state.opt_state))]))
        out["state_dict"] = _numpy(acc.get_state_dict(state))
    return out


def _sorted_dims(params, dims):
    """`dims` (in `tree_leaves` order) in `leaves_with_path` order."""
    from ..optimizers import tree_leaves
    from ..sharding.planner import leaves_with_path

    by_id = {id(leaf): d for leaf, d in zip(tree_leaves(params), dims)}
    return [by_id[id(leaf)] for _, leaf in leaves_with_path(params)]


def _case_zero_eager(case):
    """The eager loop under ZeRO: `prepare` the params (whole),
    `prepare_optimizer` (its moments this rank's blocks), then each
    step `compute_gradients`, `backward`, `clip_grad_norm_`,
    `opt.step()`, `zero_grad()`."""
    from .. import optimizers
    from ..models import llama
    from ..sharding.planner import leaves_with_path

    acc = _zero_accelerator(case)
    cfg = llama.LlamaConfig.tiny()
    params = acc.prepare(_tensors(case["params"]))
    opt = acc.prepare_optimizer(optimizers.adamw(case["lr"]), params=params)
    dims = {path: d for (path, _), d in zip(
        leaves_with_path(params), _sorted_dims(params, opt.zero.dims))}
    loader = acc.prepare([{"input_ids": ids} for ids in case["ids"]])
    losses, norms = [], []
    for _ in range(case["steps"]):
        for batch in loader:
            with acc.accumulate():
                loss, grads = acc.compute_gradients(
                    lambda p, b: llama.causal_lm_loss(cfg, p, b),
                    opt.params, batch)
                acc.backward(grads)
                norms.append(float(acc.clip_grad_norm_(max_norm=1.0)))
                opt.step()
                opt.zero_grad()
            losses.append(float(loss))
    return {"losses": losses, "norms": norms, "params": _numpy(opt.params),
            "same_params": opt.params is params, "dims": dims,
            "fsdp": (acc.mesh.shape["fsdp"], acc.mesh.axis_index("fsdp")),
            "moments": _moment_blocks(opt.opt_state)}


def _case_zero_resume(case):
    """A one-process checkpoint (`case["checkpoint"]`) loaded into a
    ZeRO state, then one more step: its loss and params."""
    acc = _zero_accelerator(case)
    state, loss_fn = _zero_state(acc, case)
    acc.load_state(case["checkpoint"], state=state)
    (batch,) = list(acc.prepare([{"input_ids": case["ids"][0]}]))
    state, m = acc.train_step(loss_fn)(state, batch)
    return {"loss": float(m["loss"]), "params": _numpy(state.params),
            "step": state.step}


def _case_zero_refusals(case):
    """The Accelerator on meshes the world resolves: a bare `fsdp` mesh
    (no plugin), and ZeRO beside a `seq` axis: each refusal's text."""
    from ..accelerator import Accelerator
    from ..state import PartialState
    from ..utils.dataclasses import DeepSpeedPlugin, MeshConfig

    out = {}
    for name, kwargs in (
            ("bare_fsdp", {"mesh_config": MeshConfig(axes={"fsdp": -1})}),
            ("zero_beside_seq", {
                "deepspeed_plugin": DeepSpeedPlugin(zero_stage=2),
                "mesh_config": MeshConfig(axes={"fsdp": -1, "seq": 2})})):
        PartialState._reset_state()
        out[name] = _refusal(lambda: Accelerator(cpu=True, **kwargs))
    return out


_ZERO_CASES = {
    "fused": _case_zero_fused,
    "eager": _case_zero_eager,
    "resume": _case_zero_resume,
    "refusals": _case_zero_refusals,
}


def zero_forms(out_dir: str, cases: list) -> None:
    """Run each ZeRO case on this rank and record what it gave. A case
    is a dict: `name`, `kind` (a key of `_ZERO_CASES`) and its numpy
    inputs; the Accelerator of each builds its own mesh over the
    world."""
    from ..state import PartialState

    torch.set_num_threads(1)
    out = {}
    for case in cases:
        out[case["name"]] = _ZERO_CASES[case["kind"]](
            dict(case, tmp=out_dir))
    PartialState._reset_state()
    PartialState(cpu=True)
    _dump(out_dir, out)
