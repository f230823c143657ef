"""The training slice as a whole: `Accelerator(cpu=True)` + `prepare` +
`train_step(causal_lm_loss)` in the port against the JAX `Accelerator`
from one numpy init, 5 AdamW steps of `LlamaConfig.tiny()` with
`gradient_clipping=1.0`; plus the device rule, the fp16 skip, unported
arguments and the batch loader.

Tolerances, with their reasons:
- f32: loss curves within 1e-5 and final params within 1e-4. Adam
  divides by sqrt(v), so a 1e-6 relative difference in the gradient of
  an element whose gradient is near zero moves its step by more than
  the gradient's own error.
- bf16: loss curves within 2e-3 (bf16 rounds at other places in the two
  frameworks, relative 2^-8 per rounding), and each param leaf's change
  over the 5 steps within 0.25 relative L2 of the JAX change: Adam
  normalises every element's step to about the learning rate, so
  elements with near-zero gradients take steps of either sign, decided
  by rounding. A wrong clip, learning rate or decay moves this by 1 or
  more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import accelerate_tpu as at
from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch import optimizers as to
from accelerate_tpu_torch import training as tt
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.data import DataLoaderShard
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_numpy, \
    params_to_numpy
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.utils.dataclasses import InitProcessGroupKwargs, \
    JitConfig, MeshConfig

STEPS = 5
LR = 3e-3


@pytest.fixture(autouse=True)
def _fresh_port_state():
    PartialState._reset_state()
    yield
    PartialState._reset_state()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(seed=0, n=STEPS, b=8, s=17):
    # batch 8: the JAX Accelerator shards it over the suite's 8 CPU devices
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (b, s)).astype(np.int32) for _ in range(n)]


def _run_jax(mp, k, backend, pn, batches, loss_mult=None):
    cfg = jl.LlamaConfig.tiny(attention_backend=backend)
    at.PartialState._reset_state()
    acc = at.Accelerator(mixed_precision=mp, gradient_clipping=1.0,
                         gradient_accumulation_steps=k)
    state = acc.prepare(at.TrainState.create(
        apply_fn=None, params=jax.tree_util.tree_map(jnp.asarray, pn),
        tx=optax.adamw(LR), use_grad_accum_buffer=k > 1))
    step = acc.train_step(_loss(jl.causal_lm_loss, cfg, loss_mult))
    losses = []
    for b in batches:
        batch = {"input_ids": jnp.asarray(b)}
        if loss_mult is not None:
            batch["mult"] = jnp.full((8,), loss_mult.pop(0), jnp.float32)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    at.PartialState._reset_state()
    return state, losses


def _run_port(mp, k, backend, pn, batches, loss_mult=None):
    cfg = tl.LlamaConfig.tiny(attention_backend=backend)
    acc = Accelerator(mixed_precision=mp, gradient_clipping=1.0,
                      gradient_accumulation_steps=k, cpu=True)
    state = acc.prepare(tt.TrainState.create(
        apply_fn=None, params=params_from_numpy(pn, device="cpu"),
        tx=to.adamw(LR), use_grad_accum_buffer=k > 1))
    step = acc.train_step(_loss(tl.causal_lm_loss, cfg, loss_mult))
    losses = []
    for b in batches:
        batch = {"input_ids": torch.tensor(b)}
        if loss_mult is not None:
            batch["mult"] = torch.full((8,), loss_mult.pop(0))
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return state, losses


def _loss(causal_lm_loss, cfg, loss_mult):
    if loss_mult is None:
        return lambda p, b: causal_lm_loss(cfg, p, b)
    # a per-step multiplier riding in the batch: inf makes a step overflow
    return lambda p, b: causal_lm_loss(
        cfg, p, {"input_ids": b["input_ids"]}) * b["mult"][0]


def _init():
    pj = jl.init_params(jl.LlamaConfig.tiny(), jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, pj)


def _flat(tree):
    return [np.asarray(x, np.float32) for _, x in sorted(
        jax.tree_util.tree_leaves_with_path(tree),
        key=lambda kv: jax.tree_util.keystr(kv[0]))]


@pytest.mark.parametrize("backend", ["einsum", "flash"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mp", ["no", "bf16"])
def test_train_step_matches_jax(mp, k, backend):
    pn = _init()
    batches = _batches()
    sj, lj = _run_jax(mp, k, backend, pn, batches)
    st, lt = _run_port(mp, k, backend, pn, batches)
    assert st.step == int(sj.step) == STEPS
    start = _flat(pn)
    pj, pt = _flat(sj.params), _flat(params_to_numpy(st.params))
    assert all(p.dtype == torch.float32 for p in to.tree_leaves(st.params))
    if mp == "no":
        np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0)
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(lt, lj, atol=2e-3, rtol=0)
        for a, b, s in zip(pt, pj, start):
            moved = np.linalg.norm(b - s)
            if moved:
                assert np.linalg.norm((a - s) - (b - s)) / moved < 0.25


def test_fp16_overflowing_step_is_skipped_like_jax():
    """Step 2's loss is multiplied by inf: both frameworks skip its
    update, halve the loss scale, and carry on from the same params."""
    pn = _init()
    batches = _batches(n=4)
    mult = [1.0, 1.0, float("inf"), 1.0]
    sj, lj = _run_jax("fp16", 1, "einsum", pn, batches, list(mult))
    st, lt = _run_port("fp16", 1, "einsum", pn, batches, list(mult))
    assert st.step == int(sj.step) == 4
    assert float(st.loss_scale.scale) == float(sj.loss_scale.scale) == 2**15
    assert not np.isfinite(lt[2]) and not np.isfinite(lj[2])
    fin = [0, 1, 3]
    np.testing.assert_allclose(np.array(lt)[fin], np.array(lj)[fin],
                               atol=5e-3, rtol=0)
    # the port alone: the skipped step leaves the params as they were
    pre, _ = _run_port("fp16", 1, "einsum", pn, batches[:2], [1.0, 1.0])
    PartialState._reset_state()
    skip, _ = _run_port("fp16", 1, "einsum", pn, batches[:3],
                        [1.0, 1.0, float("inf")])
    for a, b in zip(to.tree_leaves(pre.params), to.tree_leaves(skip.params)):
        assert torch.equal(a, b)


def test_accelerator_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Accelerator()
    PartialState._reset_state()
    acc = Accelerator(cpu=True)
    assert acc.device == torch.device("cpu")
    assert acc.compute_dtype == torch.float32


@pytest.mark.parametrize("kwargs", [
    # a mesh with an axis other than `data` is sharded parallelism (6b)
    {"mesh_config": MeshConfig(axes={"model": 2})},
    {"fsdp_plugin": "a plugin"},
    {"metrics_port": 0}, {"strict": "error"},
    # log_with is ported; a device-cost sampler beside it is too
    {"log_with": "jsonl", "cost_sample_every": 16},
    {"stall_timeout_s": 10.0}, {"split_batches": True},
    # fp8 is ported; a process group's options beside it are too
    {"mixed_precision": "fp8",
     "kwargs_handlers": [InitProcessGroupKwargs()]}],
    ids=lambda kw: next(iter(kw)))
def test_unported_arguments_raise_and_name_their_slice(kwargs):
    """The sharded-parallelism and analysis arguments still raise,
    naming their slice; the telemetry ones (`metrics_port`,
    `cost_sample_every`, `stall_timeout_s`), `split_batches` and the
    process group's options (a world of one joins no group) construct,
    and `end_training` stops their threads."""
    ported = {"metrics_port", "cost_sample_every", "stall_timeout_s",
              "split_batches", "kwargs_handlers"}
    if not ported & set(kwargs):
        with pytest.raises(NotImplementedError, match="slice"):
            Accelerator(cpu=True, **kwargs)
        return
    acc = Accelerator(cpu=True, **kwargs)
    try:
        if "metrics_port" in kwargs:
            assert acc.metrics_server.port > 0
        if "cost_sample_every" in kwargs:
            assert acc.cost_table.sample_every == 16
        if "stall_timeout_s" in kwargs:
            assert acc.stall_watchdog.timeout_s == 10.0
        if "split_batches" in kwargs:
            assert acc.dataloader_config.split_batches
        if "kwargs_handlers" in kwargs:
            assert acc.num_processes == 1
            assert not torch.distributed.is_initialized()
    finally:
        acc.end_training()
    assert acc.metrics_server is None and acc.stall_watchdog is None


def test_defaults_of_unported_arguments_are_accepted():
    acc = Accelerator(cpu=True, mesh_config=None, metrics_port=None,
                      device_placement=True, split_batches=False,
                      mixed_precision="bf16")
    assert acc.compute_dtype == torch.bfloat16
    PartialState._reset_state()
    acc = Accelerator(cpu=True, jit_config=JitConfig(),
                      device_placement=False)
    assert acc.jit_config == JitConfig() and not acc.device_placement
    with pytest.raises(TypeError, match="unexpected"):
        Accelerator(cpu=True, no_such_argument=1)


def test_prepare_places_batches_one_ahead_and_flags_the_last():
    acc = Accelerator(cpu=True)
    batches = [{"input_ids": np.full((2, 3), i, np.int32)} for i in range(3)]
    loader = acc.prepare(batches)
    assert isinstance(loader, DataLoaderShard)
    seen = []
    for b in loader:
        assert isinstance(b["input_ids"], torch.Tensor)
        seen.append((int(b["input_ids"][0, 0]), loader.end_of_dataloader))
    assert seen == [(0, False), (1, False), (2, True)]
    assert not acc.gradient_state.in_dataloader
    params = acc.prepare({"w": torch.ones(2)})
    assert params["w"].device.type == "cpu"
    # an object of no known kind comes back unchanged, as in the reference
    at.PartialState._reset_state()
    assert acc.prepare(3) == at.Accelerator().prepare(3) == 3


def test_accumulation_applies_every_kth_call_and_tracks_sync():
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
    w = torch.tensor([1.0, -2.0])
    state = acc.prepare(tt.TrainState.create(
        apply_fn=None, params={"w": w}, tx=to.sgd(0.5),
        use_grad_accum_buffer=True))
    step = acc.train_step(lambda p, b: torch.sum(p["w"] * b))
    state, _ = step(state, torch.tensor([1.0, 1.0]))
    assert not acc.sync_gradients and state.step == 1
    assert torch.equal(state.params["w"], torch.tensor([1.0, -2.0]))
    state, _ = step(state, torch.tensor([3.0, 1.0]))
    assert acc.sync_gradients and state.step == 2
    # mean grad (2, 1) times lr 0.5, applied once
    assert torch.equal(state.params["w"], torch.tensor([0.0, -2.5]))
    assert not any(a.abs().sum() for a in to.tree_leaves(state.grad_accum))


@pytest.mark.parametrize("mp", ["no", "fp16"])
def test_clip_takes_the_expanded_gradient_of_a_sum_like_jax(mp):
    """Autograd hands back the gradient of a sum as an expanded view; the
    in-place unscale and clip must still apply (the JAX step's result)."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    x = rng.normal(size=(8, 4)).astype(np.float32)

    def loss(xp):
        def f(p, batch):
            return (xp.mean(p["w"] ** 2) + 3.0 * p["b"].sum()) \
                * batch.mean()
        return f

    at.PartialState._reset_state()
    jacc = at.Accelerator(mixed_precision=mp, gradient_clipping=1.0)
    js = jacc.prepare(at.TrainState.create(
        apply_fn=None, params={"w": jnp.asarray(w), "b": jnp.asarray(b)},
        tx=optax.adamw(LR)))
    js, jm = jacc.train_step(loss(jnp))(js, jnp.asarray(x))
    at.PartialState._reset_state()
    acc = Accelerator(mixed_precision=mp, gradient_clipping=1.0, cpu=True)
    ts = acc.prepare(tt.TrainState.create(
        apply_fn=None, params={"w": torch.tensor(w), "b": torch.tensor(b)},
        tx=to.adamw(LR)))
    ts, tm = acc.train_step(loss(torch))(ts, torch.tensor(x))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-5, rtol=0)
    for k in ("w", "b"):
        np.testing.assert_allclose(ts.params[k].numpy(),
                                   np.asarray(js.params[k]), atol=1e-6,
                                   rtol=0)
