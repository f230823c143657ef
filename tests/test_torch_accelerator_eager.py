"""The Accelerator's eager user API in the port against the JAX
`Accelerator`, on the CPU, from one numpy init of `LlamaConfig.tiny()`:

    with acc.accumulate():
        loss, grads = acc.compute_gradients(loss_fn, opt.params, batch)
        acc.backward(grads); acc.clip_grad_norm_(max_norm=1.0)
        opt.step(); sched.step()
        if acc.sync_gradients: opt.zero_grad()

(The reference's `zero_grad` drops the buffer whatever the boundary, so
an accumulating loop calls it at the sync boundary.) Covered: the loop
at k=1 and k=2 in f32 and bf16 against the JAX loop and, bit for bit,
against the port's own fused `train_step`; accumulation skipping steps;
the scheduler's count and last lr (the JAX side built with
`split_batches=True`, which ticks once an optimizer step as one device
does: its 8 virtual devices would tick 8); `clip_grad_norm_`'s returned
and post-clip norms over two optimizers as one group, and
`clip_grad_value_`; the fp16 overflow skip; `backward` of a loss
raising; `compute_gradients` under fp8 raising; `gather_for_metrics`,
the trigger round trip and the rest of the surface at world size 1;
`device_placement` on the Accelerator, per object and per loader;
`prepare()` of a transformation, a schedule, an unknown object and a
torch object.

Tolerances, with their reasons (those of tests/test_torch_train_step.py):
- f32: losses within 1e-5, params after 5 steps within 1e-4 (Adam
  divides by sqrt(v): a 1e-6 relative gradient difference in an element
  whose gradient is near zero moves its step by more than that).
- bf16: losses within 2e-3 (bf16 rounds at other places in the two
  frameworks), and each param leaf's change over the 5 steps within
  0.25 relative L2 of the JAX change (Adam normalises every step to
  about the learning rate, so near-zero gradients step with a sign
  decided by rounding).
- fp16: the finite losses within 5e-3.
- The port's eager loop against its own fused step: exact (one gradient
  function and one clip).
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
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_numpy, \
    params_to_numpy
from accelerate_tpu_torch.optimizer import AcceleratedOptimizer
from accelerate_tpu_torch.scheduler import AcceleratedScheduler
from accelerate_tpu_torch.state import PartialState

STEPS = 5
LR = 3e-3


@pytest.fixture(autouse=True)
def _fresh_state():
    PartialState._reset_state()
    at.PartialState._reset_state()
    yield
    PartialState._reset_state()
    at.PartialState._reset_state()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init():
    pj = jl.init_params(jl.LlamaConfig.tiny(), jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, pj)


def _batches(seed=0, n=STEPS, b=8, s=17):
    # batch 8: the JAX Accelerator shards it over the suite's 8 CPU devices
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (b, s)).astype(np.int32) for _ in range(n)]


def _flat(tree):
    return [np.asarray(x, np.float32) for _, x in sorted(
        jax.tree_util.tree_leaves_with_path(tree),
        key=lambda kv: jax.tree_util.keystr(kv[0]))]


def _loss(causal_lm_loss, cfg, with_mult=False):
    if not with_mult:
        return lambda p, b: causal_lm_loss(cfg, p, b)
    # a per-step multiplier riding in the batch: inf makes a step overflow
    return lambda p, b: causal_lm_loss(
        cfg, p, {"input_ids": b["input_ids"]}) * b["mult"][0]


def _eager(acc, opt, sched, loss_fn, batch):
    with acc.accumulate():
        loss, grads = acc.compute_gradients(loss_fn, opt.params, batch)
        acc.backward(grads)
        acc.clip_grad_norm_(max_norm=1.0)
        opt.step()
        if sched is not None:
            sched.step()
        if acc.sync_gradients:
            opt.zero_grad()
    return float(loss)


def _run_jax(mp, k, pn, batches, mults=None, **kw):
    cfg = jl.LlamaConfig.tiny()
    at.PartialState._reset_state()
    acc = at.Accelerator(mixed_precision=mp, gradient_accumulation_steps=k,
                         split_batches=True, **kw)
    params = acc.prepare(jax.tree_util.tree_map(jnp.asarray, pn))
    opt = acc.prepare_optimizer(optax.adamw(LR), params=params)
    sched = acc.prepare(optax.linear_schedule(1.0, 0.0, 100))
    loader = acc.prepare([
        {"input_ids": b} if mults is None else
        {"input_ids": b, "mult": np.full((8,), m, np.float32)}
        for b, m in zip(batches, mults or [None] * len(batches))])
    fn = _loss(jl.causal_lm_loss, cfg, mults is not None)
    losses, skipped = [], []
    for batch in loader:
        losses.append(_eager(acc, opt, sched, fn, batch))
        skipped.append(opt.step_was_skipped)
    out = (opt.params, losses, sched, skipped)
    at.PartialState._reset_state()
    return out


def _run_port(mp, k, pn, batches, mults=None, **kw):
    cfg = tl.LlamaConfig.tiny()
    acc = Accelerator(mixed_precision=mp, gradient_accumulation_steps=k,
                      cpu=True, **kw)
    params = acc.prepare(params_from_numpy(pn, device="cpu"))
    opt = acc.prepare_optimizer(to.adamw(LR), params=params)
    sched = acc.prepare(lambda count: 1.0 - count / 100)
    loader = acc.prepare([
        {"input_ids": b} if mults is None else
        {"input_ids": b, "mult": np.full((8,), m, np.float32)}
        for b, m in zip(batches, mults or [None] * len(batches))])
    fn = _loss(tl.causal_lm_loss, cfg, mults is not None)
    losses, skipped = [], []
    for batch in loader:
        losses.append(_eager(acc, opt, sched, fn, batch))
        skipped.append(opt.step_was_skipped)
    assert opt.params is params
    return params, losses, sched, skipped


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mp", ["no", "bf16"])
def test_eager_loop_matches_jax(mp, k):
    pn = _init()
    batches = _batches()
    pj, lj, sj, _ = _run_jax(mp, k, pn, batches)
    pt, lt, st, _ = _run_port(mp, k, pn, batches)
    # syncs at every k-th step and at the loader's end: 5, or 2, 4, 5
    assert st.count == sj.count == (5 if k == 1 else 3)
    assert st.last_lr == pytest.approx(sj.last_lr, abs=1e-7)
    assert st.get_last_lr() == [st.last_lr]
    start = _flat(pn)
    a, b = _flat(params_to_numpy(pt)), _flat(pj)
    assert all(p.dtype == torch.float32 for p in to.tree_leaves(pt))
    if mp == "no":
        np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(lt, lj, atol=2e-3, rtol=0)
        for x, y, s in zip(a, b, start):
            moved = np.linalg.norm(y - s)
            if moved:
                assert np.linalg.norm((x - s) - (y - s)) / moved < 0.25


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mp", ["no", "bf16"])
def test_eager_loop_is_the_fused_step_bit_for_bit(mp, k):
    pn = _init()
    batches = _batches(seed=1, n=4)
    cfg = tl.LlamaConfig.tiny()
    acc = Accelerator(mixed_precision=mp, gradient_clipping=1.0,
                      gradient_accumulation_steps=k, cpu=True)
    state = acc.prepare(tt.TrainState.create(
        apply_fn=None, params=params_from_numpy(pn, device="cpu"),
        tx=to.adamw(LR), use_grad_accum_buffer=k > 1))
    step = acc.train_step(_loss(tl.causal_lm_loss, cfg))
    fused = []
    for b in batches:
        state, m = step(state, {"input_ids": torch.tensor(b)})
        fused.append(float(m["loss"]))
    PartialState._reset_state()
    pt, eager, _, _ = _run_port(mp, k, pn, batches)
    assert eager == fused
    for x, y in zip(to.tree_leaves(pt), to.tree_leaves(state.params)):
        assert torch.equal(x, y)
    # eval_step's forward is the first step's forward
    evaluated = Accelerator(cpu=True).eval_step(_loss(tl.causal_lm_loss,
                                                      cfg))(
        params_from_numpy(pn, device="cpu"), {"input_ids": batches[0]})
    assert float(evaluated) == fused[0] and not evaluated.requires_grad


def _sgd_pair(k=1, **kw):
    """A port and a JAX eager loop on the tiny llama with sgd(0.1)."""
    pn = _init()
    acc = Accelerator(cpu=True, gradient_accumulation_steps=k, **kw)
    opt = acc.prepare_optimizer(
        to.sgd(0.1), params=acc.prepare(params_from_numpy(pn, device="cpu")))
    at.PartialState._reset_state()
    jacc = at.Accelerator(gradient_accumulation_steps=k, split_batches=True,
                          **kw)
    jopt = jacc.prepare_optimizer(optax.sgd(0.1), params=jacc.prepare(
        jax.tree_util.tree_map(jnp.asarray, pn)))
    return (acc, opt, _loss(tl.causal_lm_loss, tl.LlamaConfig.tiny())), \
        (jacc, jopt, _loss(jl.causal_lm_loss, jl.LlamaConfig.tiny()))


def test_accumulation_skips_steps_like_jax():
    port, ref = _sgd_pair(k=2)
    batch = {"input_ids": _batches(n=1)[0]}
    for acc, opt, fn in (port, ref):
        p0 = np.asarray(opt.params["embed_tokens"]["embedding"]).copy()
        with acc.accumulate():
            _, grads = acc.compute_gradients(fn, opt.params, batch)
            acc.backward(grads)
            assert acc.clip_grad_norm_(max_norm=1.0) is None
            opt.step()                       # accumulating: skipped
        np.testing.assert_array_equal(np.asarray(opt.params["embed_tokens"]["embedding"]), p0)
        assert not acc.sync_gradients
        with acc.accumulate():
            _, grads = acc.compute_gradients(fn, opt.params, batch)
            acc.backward(grads)
            opt.step()                       # the sync boundary: applied
        assert acc.sync_gradients
        assert not np.array_equal(np.asarray(opt.params["embed_tokens"]["embedding"]), p0)
    np.testing.assert_allclose(np.asarray(port[1].params["embed_tokens"]["embedding"]),
                               np.asarray(ref[1].params["embed_tokens"]["embedding"]),
                               atol=1e-6, rtol=0)


def test_no_sync_and_sync_each_batch():
    from accelerate_tpu_torch.utils.dataclasses import \
        GradientAccumulationPlugin

    acc = Accelerator(cpu=True, gradient_accumulation_plugin=
                      GradientAccumulationPlugin(num_steps=4,
                                                 sync_each_batch=True))
    with acc.accumulate():
        assert acc.sync_gradients
        with acc.no_sync():
            assert not acc.sync_gradients
        assert acc.sync_gradients
    assert acc.step == 1


def test_scheduler_ticks_with_the_optimizer_like_jax():
    port, ref = _sgd_pair(k=2)
    batch = {"input_ids": _batches(n=1)[0]}
    scheds = [port[0].prepare(lambda count: 1.0 - count / 100),
              ref[0].prepare(optax.linear_schedule(1.0, 0.0, 100))]
    assert isinstance(scheds[0], AcceleratedScheduler)
    for (acc, opt, fn), sched in zip((port, ref), scheds):
        for _ in range(4):
            with acc.accumulate():
                _, grads = acc.compute_gradients(fn, opt.params, batch)
                acc.backward(grads)
                opt.step()
                sched.step()
                if acc.sync_gradients:
                    opt.zero_grad()
        assert sched.count == 2
        assert sched.last_lr == pytest.approx(0.98, abs=1e-7)
    sd = scheds[0].state_dict()
    assert sd == {"count": 2, "last_lr": scheds[0].last_lr}
    scheds[0].load_state_dict({"count": 7, "last_lr": 0.5})
    assert (scheds[0].count, scheds[0].get_last_lr()) == (7, [0.5])


def test_scheduler_apart_from_the_optimizer_ticks_every_call_like_jax():
    port, ref = _sgd_pair(k=2, step_scheduler_with_optimizer=False)
    assert port[0].step_scheduler_with_optimizer is False
    for acc in (port[0], ref[0]):
        sched = acc.prepare(lambda count: 1.0 - count / 100)
        for _ in range(3):
            with acc.accumulate():
                sched.step()
        assert sched.count == 3 and sched.last_lr == pytest.approx(0.97)


def test_clip_grad_norm_over_two_optimizers_like_jax():
    pn = _init()
    batch = {"input_ids": _batches(n=1)[0]}
    norms = []
    for side in ("port", "jax"):
        if side == "port":
            acc = Accelerator(cpu=True)
            make = (lambda: acc.prepare_optimizer(to.sgd(0.1), params=(
                params_from_numpy(pn, device="cpu"))))
            fn, gnorm = _loss(tl.causal_lm_loss, tl.LlamaConfig.tiny()), \
                tt.global_norm
        else:
            at.PartialState._reset_state()
            acc = at.Accelerator()
            make = (lambda: acc.prepare_optimizer(optax.sgd(0.1), params=(
                jax.tree_util.tree_map(jnp.asarray, pn))))
            fn, gnorm = _loss(jl.causal_lm_loss, jl.LlamaConfig.tiny()), \
                optax.global_norm
        opts = [make(), make()]
        with acc.accumulate():
            _, grads = acc.compute_gradients(fn, opts[0].params, batch)
            acc.backward(grads)
            pre = float(gnorm([o.gradients for o in opts]))
            returned = float(acc.clip_grad_norm_(max_norm=pre / 2))
            post = float(gnorm([o.gradients for o in opts]))
        assert abs(returned - pre) < 1e-5 * max(1.0, pre)
        assert post <= pre / 2 * 1.001
        # a max_norm above the norm leaves the grads as they were
        for o in opts:
            o.zero_grad()
        acc.backward(grads)
        before = np.asarray(opts[1].gradients["embed_tokens"]["embedding"]).copy()
        acc.clip_grad_norm_(max_norm=1e9)
        np.testing.assert_allclose(np.asarray(opts[1].gradients["embed_tokens"]["embedding"]),
                                   before, rtol=1e-6)
        acc.clip_grad_value_(clip_value=1e-4)
        clipped = np.asarray(opts[0].gradients["embed_tokens"]["embedding"])
        assert np.abs(clipped).max() <= 1e-4
        norms.append((pre, returned, post, clipped.copy()))
    for a, b in zip(norms[0][:3], norms[1][:3]):
        assert a == pytest.approx(b, rel=1e-5)
    np.testing.assert_allclose(norms[0][3], norms[1][3], atol=1e-7, rtol=0)
    with pytest.raises(NotImplementedError, match="L2"):
        Accelerator(cpu=True).clip_grad_norm_(norm_type=1)


def test_fp16_overflowing_step_is_skipped_like_jax():
    """Step 2's loss is multiplied by inf: both optimizers skip it, the
    schedulers do not tick, and the finite steps agree."""
    pn = _init()
    batches = _batches(n=4)
    mults = [1.0, 1.0, float("inf"), 1.0]
    pj, lj, sj, kj = _run_jax("fp16", 1, pn, batches, list(mults))
    pt, lt, st, kt = _run_port("fp16", 1, pn, batches, list(mults))
    assert kt == kj == [False, False, True, False]
    assert st.count == sj.count == 3
    fin = [0, 1, 3]
    np.testing.assert_allclose(np.array(lt)[fin], np.array(lj)[fin],
                               atol=5e-3, rtol=0)
    # the port alone: the skipped step leaves the params as they were
    PartialState._reset_state()
    pre, _, _, _ = _run_port("fp16", 1, pn, batches[:2], mults[:2])
    PartialState._reset_state()
    skip, _, _, _ = _run_port("fp16", 1, pn, batches[:3], mults[:3])
    for a, b in zip(to.tree_leaves(pre), to.tree_leaves(skip)):
        assert torch.equal(a, b)


def test_backward_takes_gradients_not_a_loss_like_jax():
    acc, jacc = Accelerator(cpu=True), at.Accelerator()
    for a, scalar in ((acc, torch.tensor(1.0)), (jacc, jnp.float32(1.0))):
        with pytest.raises(ValueError, match="backward tape"):
            a.backward(scalar)
        for empty in (None, {}):
            with pytest.raises(ValueError, match="needs gradients"):
                a.backward(empty)
    opt = acc.prepare_optimizer(to.sgd(0.1), params={"w": torch.ones(2)})
    with pytest.raises(ValueError, match="No gradients"):
        opt.step()


def test_compute_gradients_under_fp8_raises_like_jax():
    acc = Accelerator(cpu=True, mixed_precision="fp8")
    at.PartialState._reset_state()
    jacc = at.Accelerator(mixed_precision="fp8")
    for a, p in ((acc, {"w": torch.ones(2)}), (jacc, {"w": jnp.ones(2)})):
        with pytest.raises(NotImplementedError, match="requires the fused"):
            a.compute_gradients(lambda q, b: (q["w"] * b).sum(), p,
                                p["w"])


def test_compute_gradients_with_aux_and_eval_step():
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    w = torch.tensor([1.0, -2.0, 3.0])

    def fn(p, x):
        # the params are cast, the batch is not (as in the reference)
        return ((p["w"] * x) ** 2).sum(), {"dtype": p["w"].dtype}

    (loss, aux), grads = acc.compute_gradients(fn, {"w": w}, torch.ones(3),
                                               has_aux=True)
    assert aux["dtype"] == torch.bfloat16 and not loss.requires_grad
    assert grads["w"].dtype == torch.float32
    assert torch.equal(grads["w"], 2 * w)
    out, _ = acc.eval_step(fn)({"w": w}, torch.ones(3))
    assert torch.equal(out, loss) and not out.requires_grad
    # a param that the loss does not use gets zeros
    _, g = acc.compute_gradients(lambda p, x: (p["a"] * x).sum(),
                                 {"a": w, "b": w}, torch.ones(3))
    assert torch.equal(g["b"], torch.zeros(3))


def test_gather_for_metrics_and_world_size_1_surface():
    acc, jacc = Accelerator(cpu=True), at.Accelerator()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(20, 4)).astype(np.float32)
    for a in (acc, jacc):
        loader = a.prepare([{"x": x[i:i + 8]} for i in range(0, 20, 8)])
        seen = sum(np.asarray(a.gather_for_metrics(b["x"])).shape[0]
                   for b in loader)
        assert seen == 20
        assert a.gather_for_metrics("label") == ["label"]
        assert a.gather_for_metrics(["a", "b"], use_gather_object=True) == \
            ["a", "b"]
    # the final short batch comes back whole: one process pads no tail
    loader = acc.prepare([{"x": x[i:i + 8]} for i in range(0, 20, 8)])
    rows = [acc.gather_for_metrics({"x": b["x"]})["x"] for b in loader]
    torch.testing.assert_close(torch.cat(rows), torch.from_numpy(x))
    t = torch.arange(4.0)
    assert acc.gather(t) is t and acc.broadcast(t) is t
    torch.testing.assert_close(acc.reduce(t, scale=0.5), t * 0.5)
    assert acc.pad_across_processes(t) is t
    assert (acc.num_processes, acc.process_index, acc.local_process_index,
            acc.is_main_process, acc.is_local_main_process,
            acc.is_last_process, acc.use_distributed) == \
        (1, 0, 0, True, True, True, False)
    with acc.split_between_processes([1, 2, 3], apply_padding=True) as part:
        assert part == [1, 2, 3]
    assert acc.on_main_process(lambda: 1)() == 1
    assert acc.on_local_main_process(lambda: 2)() == 2
    assert acc.on_process(lambda: 3, 1)() is None
    with acc.main_process_first(), acc.local_main_process_first():
        acc.wait_for_everyone()
    assert acc.unwrap_model(t) is t


def test_trigger_round_trip_like_jax():
    for a in (Accelerator(cpu=True), at.Accelerator()):
        assert not a.check_trigger()
        a.set_trigger()
        assert a.check_trigger()
        assert not a.check_trigger()


def test_mesh_and_context_attention_raise_and_name_item_6():
    """The mesh is the reference's data-parallel mesh over the processes
    (its axis names; one process: `{"data": 1}`, where the suite's 8 JAX
    devices give the reference `{"data": 8}`). Context attention is
    ported (queue 1 item 6b, part 2): with no `seq` axis it is plain
    causal attention, as the reference's is on its data mesh."""
    acc = Accelerator(cpu=True)
    jacc = at.Accelerator()
    assert acc.mesh.axis_names == tuple(jacc.mesh.axis_names) == ("data",)
    assert acc.mesh.shape == {"data": 1} and acc.state.dp_size == 1
    assert dict(jacc.mesh.shape) == {"data": jax.device_count()}
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
               for _ in range(3))
    got = acc.context_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    want = jacc.context_attention(*(jnp.asarray(t) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_device_placement_like_jax():
    pn = {"w": np.ones((8, 2), np.float32)}
    batches = [{"x": np.ones((8, 2), np.float32)}]
    acc = Accelerator(cpu=True, device_placement=False)
    jacc = at.Accelerator(device_placement=False)
    for a, params in ((acc, params_from_numpy(pn, device="cpu")),
                      (jacc, jax.tree_util.tree_map(jnp.asarray, pn))):
        assert a.prepare_params(params) is params
        assert a.prepare(params) is params
        # prepare_model takes the flag and, as the reference, reads none
        assert a.prepare_model(params, device_placement=True) is params
        with pytest.raises(ValueError, match="device_placement has 1 "
                                             "entries for 2 objects"):
            a.prepare(params, batches, device_placement=[True])
        # the Accelerator's flag, then the loader's own, which wins
        (b,) = list(a.prepare_data_loader(batches))
        assert isinstance(b["x"], np.ndarray)
        (b,) = list(a.prepare_data_loader(batches, device_placement=True))
        assert not isinstance(b["x"], np.ndarray)
        # a list of the right length is taken; placement follows the
        # Accelerator's flag, as in the reference
        out, loader = a.prepare(params, batches,
                                device_placement=[True, True])
        assert out is params
        assert isinstance(next(iter(loader))["x"], np.ndarray)
    PartialState._reset_state()
    acc = Accelerator(cpu=True)
    params = {"w": torch.ones(2)}
    out, loader = acc.prepare(params, batches, device_placement=[False,
                                                                 False])
    assert isinstance(next(iter(loader))["x"], torch.Tensor)


def test_prepare_by_kind_like_jax():
    pn = {"w": np.ones((8, 2), np.float32)}
    acc, jacc = Accelerator(cpu=True), at.Accelerator()
    marker = object()
    for a, params, tx, kinds in (
            (acc, params_from_numpy(pn, device="cpu"), to.adamw(LR),
             (AcceleratedOptimizer, AcceleratedScheduler)),
            (jacc, jax.tree_util.tree_map(jnp.asarray, pn), optax.adamw(LR),
             (at.AcceleratedOptimizer, at.AcceleratedScheduler))):
        p, opt, sched, unknown, number = a.prepare(
            params, tx, lambda count: 0.1, marker, 3)
        assert isinstance(opt, kinds[0]) and isinstance(sched, kinds[1])
        assert opt.params is p and sched.optimizers == [opt]
        assert unknown is marker and number == 3
        assert a.prepare_model(marker) is marker and a._models == [marker]
        assert a.prepare(opt) is opt and a.prepare(sched) is sched
        a.free_memory()
        assert (a._optimizers, a._schedulers, a._models, a.step) == \
            ([], [], [], 0)
    for torch_object in (torch.optim.SGD([torch.zeros(1,
                                                      requires_grad=True)],
                                         lr=0.1),
                         torch.nn.Linear(2, 2)):
        with pytest.raises(TypeError, match="GradientTransformation"):
            acc.prepare(torch_object)


def test_join_uneven_inputs_overrides_even_batches():
    acc = Accelerator(cpu=True)
    loader = acc.prepare([{"x": np.zeros(2, np.float32)}])
    loader.even_batches = False
    with acc.join_uneven_inputs([None], even_batches=True):
        assert loader.even_batches is True
    assert loader.even_batches is False
    with acc.join_uneven_inputs([None]):
        assert loader.even_batches is False


def test_profile_and_step_timer(tmp_path):
    acc = Accelerator(cpu=True)
    with acc.profile(str(tmp_path)):
        torch.ones(4).sum()
    assert (tmp_path / "trace.json").exists()
    timer = acc.step_timer(tokens_per_step=8, warmup_steps=0)
    timer.tick()
    timer.tick()
    assert timer.summary()["steps_recorded"] == 1
    # the series are shared by name: fresh=False continues them
    assert acc.step_timer(fresh=False, warmup_steps=0).summary()[
        "steps_recorded"] == 1
    assert acc.step_timer(warmup_steps=0).summary()["steps_recorded"] == 0
