"""The port's checkpointing against the JAX package and the
`safetensors` package, on the CPU:

- the port's safetensors writer and reader against the `safetensors`
  package both ways, every dtype the port writes, 0-d and empty tensors;
- `save_model` of one package read by the other's `load_model`, sharded
  by the index into 3 files; f32 values equal exactly;
- a `TrainState` round trip in place (params, AdamW count/mu/nu, the loss
  scale, the step): the same tensor objects after the load, and a shape
  or dtype mismatch raising with the flattened key;
- custom objects, the sampler's epoch and the host RNG streams;
- the eager loop's optimizer (params and AdamW state) and scheduler
  round trip, sync and async, and a JAX eager checkpoint continued by
  the port's eager loop;
- async saves invisible until the drain, a failing writer re-raising at
  `wait_for_checkpoints` and dropping its commit, torn saves skipped, and
  the stage ordered before the next in-place step;
- `ProjectConfiguration(automatic_checkpoint_naming=True, total_limit=2)`
  naming and pruning directories as the JAX `Accelerator` does, and
  retention waiting for a manifest the writer thread is publishing;
- `train_step(donate=False)` leaving its input state untouched;
- fp8 metas in `model_0_fp8.safetensors` (read by the `safetensors`
  package) with the window's length beside them, restored in place,
  sync and async, and across a change of window length as the JAX
  package restores them.

Tolerance: exact (bytes are copied, not computed), except where the
JAX eager loop and the port's compute: f32 losses within 1e-5."""

from __future__ import annotations

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

import accelerate_tpu as at
from accelerate_tpu import checkpointing as jckpt
from accelerate_tpu.ops import fp8 as jf
from accelerate_tpu_torch import checkpointing as ckpt
from accelerate_tpu_torch import optimizers as to
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.data import skip_first_batches
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.training import DynamicLossScale, TrainState
from accelerate_tpu_torch.utils import safetensors as st
from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration
from accelerate_tpu_torch.utils.other import flatten_dict


@pytest.fixture(autouse=True)
def _fresh_state():
    PartialState._reset_state()
    yield
    ckpt.wait_for_checkpoints()
    PartialState._reset_state()


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "f64": torch.randn(2, 3, generator=g, dtype=torch.float64),
        "f32": torch.randn(3, 4, generator=g),
        "f16": torch.randn(5, generator=g).half(),
        "bf16": torch.randn(2, 3, generator=g).bfloat16(),
        "i64": torch.arange(6).reshape(2, 3) - 3,
        "i32": torch.arange(3, dtype=torch.int32),
        "i16": torch.tensor([-7, 300], dtype=torch.int16),
        "i8": torch.tensor([-3, 4], dtype=torch.int8),
        "u8": torch.tensor([250, 1], dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "scalar_i32": torch.tensor(7, dtype=torch.int32),
        "empty": torch.zeros(0, 3),
        "empty_bf16": torch.zeros(2, 0, dtype=torch.bfloat16),
    }


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


# --- the file format --------------------------------------------------------


@pytest.mark.parametrize("direction", ["port_writes", "package_writes"])
def test_safetensors_both_ways_with_the_package(direction, tmp_path):
    t = _tensors()
    path = str(tmp_path / "x.safetensors")
    if direction == "port_writes":
        st.save_file(t, path, metadata={"format": "pt"})
        got = safetensors.torch.load_file(path)
    else:
        safetensors.torch.save_file(t, path, metadata={"format": "pt"})
        got = st.load_file(path)
    assert set(got) == set(t)
    for k in t:
        _same(got[k], t[k])
    assert st.read_header(path)[0]["__metadata__"] == {"format": "pt"}


def test_safetensors_layout_is_the_packages_byte_for_byte(tmp_path):
    """Same header order, padding and data layout as the package."""
    t = _tensors(1)
    st.save_file(t, str(tmp_path / "a"), metadata={"format": "pt"})
    safetensors.torch.save_file(t, str(tmp_path / "b"),
                                metadata={"format": "pt"})
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def test_safetensors_numpy_package_reads_the_port(tmp_path):
    t = {k: v for k, v in _tensors(2).items() if v.dtype != torch.bfloat16}
    st.save_file(t, str(tmp_path / "x"))
    got = safetensors.numpy.load_file(str(tmp_path / "x"))
    for k, v in t.items():
        np.testing.assert_array_equal(got[k], v.numpy())
        assert got[k].dtype == v.numpy().dtype


@pytest.mark.parametrize("damage", ["short", "header_length", "gap",
                                    "size", "dtype"])
def test_safetensors_reader_refuses_damaged_files(damage, tmp_path):
    path = tmp_path / "x"
    st.save_file({"a": torch.ones(4), "b": torch.zeros(2)}, str(path))
    raw = bytearray(path.read_bytes())
    n = int.from_bytes(raw[:8], "little")
    header = raw[8:8 + n].decode()
    if damage == "short":
        raw = raw[:-3]
    elif damage == "header_length":
        raw[:8] = (len(raw)).to_bytes(8, "little")
    elif damage == "gap":
        header = header.replace('"data_offsets":[16,24]',
                                '"data_offsets":[17,25]')
    elif damage == "size":
        header = header.replace('"shape":[2]', '"shape":[3]')
    else:
        header = header.replace('"F32"', '"F33"', 1)
    if damage in ("gap", "size", "dtype"):
        assert len(header) == n
        raw[8:8 + n] = header.encode()
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        st.load_file(str(path))


# --- weights export ---------------------------------------------------------


def _params_np(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.normal(size=(64, 32)).astype(np.float32),
        "layers": {"wq": rng.normal(size=(2, 32, 32)).astype(np.float32),
                   "ln": rng.normal(size=(2, 32)).astype(np.float32)},
        "lm_head": rng.normal(size=(32, 64)).astype(np.float32),
    }


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_np(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _shards(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))


def test_save_model_port_to_jax_load_model_sharded(tmp_path):
    pn = _params_np()
    params = {k: (torch.tensor(v) if not isinstance(v, dict) else
                  {kk: torch.tensor(vv) for kk, vv in v.items()})
              for k, v in pn.items()}
    ckpt.save_model(params, str(tmp_path), max_shard_size=9000)
    assert _shards(tmp_path) == [f"model-0000{i}-of-00003.safetensors"
                                 for i in (1, 2, 3)]
    got = jckpt.load_model(str(tmp_path))
    want, have = _flat_np(pn), _flat_np(got)
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k])


def test_save_model_jax_to_port_load_model_sharded(tmp_path):
    at.PartialState._reset_state()
    pn = _params_np(1)
    jckpt.save_model(jax.tree_util.tree_map(jnp.asarray, pn), str(tmp_path),
                     max_shard_size=9000)
    at.PartialState._reset_state()
    assert len(_shards(tmp_path)) == 3
    got = ckpt.load_model(str(tmp_path), device="cpu")
    want = _flat_np(pn)
    have = flatten_dict(got)
    assert set(have) == set(want)
    for k in want:
        assert have[k].dtype == torch.float32 and have[k].device.type == "cpu"
        np.testing.assert_array_equal(have[k].numpy(), want[k])


def test_save_model_unsharded_and_pickled(tmp_path):
    params = {"a": torch.arange(4.0), "b": {"c": torch.ones(2, 2).bfloat16()}}
    ckpt.save_model(params, str(tmp_path / "one"))
    assert _shards(tmp_path / "one") == ["model.safetensors"]
    got = ckpt.load_model(str(tmp_path / "one"), device="cpu")
    _same(got["a"], params["a"])
    _same(got["b"]["c"], params["b"]["c"])
    ckpt.save_model(params, str(tmp_path / "pkl"), safe_serialization=False)
    assert os.listdir(tmp_path / "pkl") == ["model.pkl"]
    with pytest.raises(FileNotFoundError):
        ckpt.load_model(str(tmp_path / "pkl"), device="cpu")


def test_shard_checkpoint_matches_jax():
    flat = _flat_np(_params_np())
    jfiles, jindex = jckpt.shard_checkpoint(flat, "10KB")
    tfiles, tindex = ckpt.shard_checkpoint(
        {k: torch.tensor(v) for k, v in flat.items()}, "10KB")
    assert {f: sorted(s) for f, s in tfiles.items()} == \
        {f: sorted(s) for f, s in jfiles.items()}
    assert tindex == jindex


# --- train state round trip --------------------------------------------------


def _state(seed=0, loss_scale=True):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(8, 4, generator=g),
              "blk": {"b": torch.randn(4, generator=g),
                      "h": torch.randn(2, 3, generator=g).bfloat16()}}
    ts = TrainState.create(apply_fn=None, params=params,
                           tx=to.adamw(1e-2), use_loss_scale=loss_scale)
    return ts


def _perturb(ts, seed):
    g = torch.Generator().manual_seed(seed)
    for t in [*flatten_dict(ts.params).values(),
              *flatten_dict(ts.opt_state.mu).values(),
              *flatten_dict(ts.opt_state.nu).values()]:
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    ts.opt_state.count.fill_(seed)
    ts.loss_scale.scale.fill_(2.0 ** seed)
    ts.loss_scale.growth_tracker.fill_(seed + 1)
    ts.step = seed * 10


def _leaves(ts):
    return {"step": ts.step,
            **{f"p.{k}": v for k, v in flatten_dict(ts.params).items()},
            **{f"o.{k}": v for k, v in
               flatten_dict(ts.opt_state).items()},
            "scale": ts.loss_scale.scale,
            "tracker": ts.loss_scale.growth_tracker}


def test_train_state_round_trip_in_place(tmp_path):
    ts = _state()
    _perturb(ts, 3)
    saved = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in _leaves(ts).items()}
    ckpt.save_accelerator_state(str(tmp_path), train_states=[ts], step=30)
    assert sorted(os.listdir(tmp_path)) == sorted([
        "model_0.safetensors", "accelerator_state.json",
        "random_states_0.pkl", ckpt.MANIFEST_NAME])
    keys = set(st.read_header(str(tmp_path / "model_0.safetensors"))[0])
    assert {"step", "params.w", "params.blk.h", "opt_state.count",
            "opt_state.mu.w", "opt_state.nu.blk.b", "loss_scale.scale",
            "loss_scale.growth_tracker"} <= keys
    _perturb(ts, 5)
    before = {k: v for k, v in _leaves(ts).items()
              if isinstance(v, torch.Tensor)}
    ptrs = {k: v.data_ptr() for k, v in before.items()}
    out = ckpt.load_accelerator_state(str(tmp_path), train_states=[ts])
    assert out["step"] == 30 and out["train_states"] == [ts]
    after = _leaves(ts)
    assert after["step"] == 30 and isinstance(ts.step, int)
    for k, v in before.items():
        assert after[k] is v and v.data_ptr() == ptrs[k], k
        _same(v, saved[k])


def test_train_state_mismatch_raises_with_the_key(tmp_path):
    ts = _state()
    ckpt.save_accelerator_state(str(tmp_path), train_states=[ts])
    wide = _state()
    wide.params["blk"]["b"] = torch.zeros(5)
    wide.opt_state = wide.tx.init(wide.params)
    with pytest.raises(ValueError, match=r"'params\.blk\.b'.*\[4\].*\[5\]"):
        ckpt.load_accelerator_state(str(tmp_path), train_states=[wide])
    half = _state()
    half.params["w"] = half.params["w"].half()
    with pytest.raises(ValueError, match=r"'params\.w' is F32"):
        ckpt.load_accelerator_state(str(tmp_path), train_states=[half])
    extra = _state()
    extra.params["new"] = torch.zeros(1)
    extra.opt_state = extra.tx.init(extra.params)
    with pytest.raises(ValueError, match=r"missing \['opt_state.mu.new'"):
        ckpt.load_accelerator_state(str(tmp_path), train_states=[extra])
    no_scale = _state(loss_scale=False)
    with pytest.raises(ValueError, match="unexpected.*loss_scale"):
        ckpt.load_accelerator_state(str(tmp_path), train_states=[no_scale])


class _Counter:
    def __init__(self, n=0):
        self.n = n

    def state_dict(self):
        return {"n": self.n}

    def load_state_dict(self, sd):
        self.n = sd["n"]


def test_custom_objects_sampler_epoch_and_rng_streams(tmp_path):
    acc = Accelerator(cpu=True)
    loader = acc.prepare([{"x": np.zeros(2, np.float32)}] * 3)
    for _ in range(2):
        list(loader)
    assert loader.epoch == 2
    counter = _Counter(41)
    acc.register_for_checkpointing(counter)
    with pytest.raises(ValueError, match="state_dict"):
        acc.register_for_checkpointing(object())
    random.seed(5)
    np.random.seed(6)
    torch.manual_seed(7)
    acc.save_state(str(tmp_path))
    draws = (random.random(), np.random.rand(), torch.rand(()).item())
    counter.n = 0
    loader.set_epoch(0)
    random.seed(1)
    np.random.seed(1)
    torch.manual_seed(1)
    acc.load_state(str(tmp_path))
    assert counter.n == 41 and loader.epoch == 2
    assert (random.random(), np.random.rand(), torch.rand(()).item()) == draws
    names = os.listdir(tmp_path)
    assert "custom_checkpoint_0.pkl" in names and "sampler_0.bin" in names


def test_skip_first_batches_resumes_mid_epoch():
    acc = Accelerator(cpu=True)
    batches = [{"x": np.full(2, i, np.float32)} for i in range(5)]
    loader = acc.prepare(batches)
    rest = acc.skip_first_batches(loader, 3)
    assert len(rest) == 2
    assert [float(b["x"][0]) for b in rest] == [3.0, 4.0]
    assert [b["x"] for b in skip_first_batches(batches, 4)] == \
        [batches[4]["x"]]


def test_hooks_run_before_save_and_load_and_remove(tmp_path):
    acc = Accelerator(cpu=True)
    calls = []
    h1 = acc.register_save_state_pre_hook(
        lambda models, weights, d: calls.append(("save", d)))
    acc.register_load_state_pre_hook(lambda models, d: calls.append(
        ("load", d)))
    acc.save_state(str(tmp_path))
    acc.load_state(str(tmp_path))
    h1.remove()
    acc.save_state(str(tmp_path))
    assert calls == [("save", str(tmp_path)), ("load", str(tmp_path))]




# --- the eager loop's optimizers and schedulers --------------------------------


def _eager_setup(pn, cpu_acc=True):
    """The port's eager loop on the tiny llama: (acc, opt, sched, step)
    with `step(batch) -> loss` one micro-step of the reference's loop."""
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.models.convert import params_from_numpy

    cfg = tl.LlamaConfig.tiny()
    acc = Accelerator(cpu=cpu_acc)
    opt = acc.prepare_optimizer(to.adamw(3e-3), params=acc.prepare(
        params_from_numpy(pn, device="cpu")))
    sched = acc.prepare(lambda count: 1.0 - count / 100)

    def step(batch):
        with acc.accumulate():
            loss, grads = acc.compute_gradients(
                lambda p, b: tl.causal_lm_loss(cfg, p, b), opt.params,
                {"input_ids": torch.tensor(batch)})
            acc.backward(grads)
            acc.clip_grad_norm_(max_norm=1.0)
            opt.step()
            sched.step()
            opt.zero_grad()
        return float(loss)

    return acc, opt, sched, step


def _tiny_init():
    from accelerate_tpu.models import llama as jl

    return jax.tree_util.tree_map(np.asarray, jl.init_params(
        jl.LlamaConfig.tiny(), jax.random.key(0)))


def _eager_batches(n):
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, (8, 17)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_eager_optimizer_and_scheduler_round_trip(async_save, tmp_path):
    """save_state writes the eager optimizer's params and AdamW state to
    `optimizer_0.safetensors` and the scheduler's count to
    `scheduler_0.bin`; load_state restores them in place (the same
    tensors), and the loop then continues to the losses of a run that
    never stopped."""
    pn = _tiny_init()
    batches = _eager_batches(5)
    acc, opt, sched, step = _eager_setup(pn)
    for b in batches[:2]:
        step(b)
    def live():
        return {k: v for k, v in flatten_dict(
            {"opt_state": opt.opt_state, "params": opt.params}).items()
            if v is not None}

    acc.save_state(str(tmp_path), async_save=async_save)
    saved = {k: v.clone() for k, v in live().items()}
    rest = [step(b) for b in batches[2:]]
    assert sched.count == 5
    acc.wait_for_checkpoints()
    keys = set(st.read_header(str(tmp_path / "optimizer_0.safetensors"))[0])
    assert {"opt_state.count", "opt_state.mu.embed_tokens.embedding",
            "params.lm_head.kernel"} <= keys
    before = live()
    acc.load_state(str(tmp_path))
    assert acc.step == 2 and sched.count == 2
    for k, v in live().items():
        assert v is before[k]
        _same(v, saved[k])
    assert [step(b) for b in batches[2:]] == rest


def test_checkpoint_without_the_optimizers_file_raises(tmp_path):
    """A prepared eager optimizer with no `optimizer_{i}.safetensors` in
    the checkpoint raises, as a train state with no file does, before
    the step or the scheduler moves."""
    acc, opt, sched, step = _eager_setup(_tiny_init())
    step(_eager_batches(1)[0])
    acc.save_state(str(tmp_path))
    os.remove(tmp_path / "optimizer_0.safetensors")
    with pytest.raises(FileNotFoundError, match="prepared optimizer 0"):
        acc.load_state(str(tmp_path))
    assert acc.step == 1 and sched.count == 1


def test_jax_eager_checkpoint_continues_in_the_port(tmp_path):
    """The JAX eager loop trains 3 steps and saves; the port's eager loop
    takes that checkpoint and both continue 2 steps to the same losses
    (f32, within 1e-5 as the loop parity tests). The arrays are orbax
    files (`optimizer_0/`) the port does not read, so the port's
    `load_state` raises rather than leave the weights at init; they
    cross through numpy into `AcceleratedOptimizer.load_state_dict` and
    the params. The scheduler's count and the step come through the
    port's `load_accelerator_state` from the JAX package's
    `scheduler_0.bin` and `accelerator_state.json`."""
    import optax

    from accelerate_tpu.models import llama as jl
    from accelerate_tpu_torch.models.convert import params_from_numpy

    pn = _tiny_init()
    batches = _eager_batches(5)
    cfg = jl.LlamaConfig.tiny()
    at.PartialState._reset_state()
    jacc = at.Accelerator(split_batches=True)
    jopt = jacc.prepare_optimizer(optax.adamw(3e-3), params=jacc.prepare(
        jax.tree_util.tree_map(jnp.asarray, pn)))
    jsched = jacc.prepare(optax.linear_schedule(1.0, 0.0, 100))

    def jstep(batch):
        with jacc.accumulate():
            loss, grads = jacc.compute_gradients(
                lambda p, b: jl.causal_lm_loss(cfg, p, b), jopt.params,
                {"input_ids": jnp.asarray(batch)})
            jacc.backward(grads)
            jacc.clip_grad_norm_(max_norm=1.0)
            jopt.step()
            jsched.step()
            jopt.zero_grad()
        return float(loss)

    for b in batches[:3]:
        jstep(b)
    jacc.save_state(str(tmp_path))
    jacc.wait_for_checkpoints()
    want = [jstep(b) for b in batches[3:]]
    # restore the JAX checkpoint with the JAX package, for its arrays
    at.PartialState._reset_state()
    jacc2 = at.Accelerator(split_batches=True)
    jopt2 = jacc2.prepare_optimizer(optax.adamw(3e-3), params=jacc2.prepare(
        jax.tree_util.tree_map(jnp.zeros_like, pn)))
    jacc2.load_state(str(tmp_path))
    adam = jopt2.opt_state[0]
    at.PartialState._reset_state()

    acc, opt, sched, step = _eager_setup(pn)
    with pytest.raises(ValueError, match="reads no orbax arrays"):
        acc.load_state(str(tmp_path))
    assert acc.step == 0 and sched.count == 0
    out = ckpt.load_accelerator_state(str(tmp_path), schedulers=[sched])
    acc.step = out["step"]
    assert out["step"] == 3 and sched.count == 3
    assert sched.last_lr == pytest.approx(0.97, abs=1e-7)
    host = lambda tree: params_from_numpy(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")
    opt.load_state_dict({"opt_state": to.ScaleByAdamState(
        torch.tensor(int(adam.count), dtype=torch.int32), host(adam.mu),
        host(adam.nu))})
    with torch.no_grad():
        for p, v in zip(to.tree_leaves(opt.params),
                        to.tree_leaves(host(jopt2.params))):
            p.copy_(v)
    got = [step(b) for b in batches[3:]]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert sched.count == 5


# --- async saves, failures and torn saves ------------------------------------


def test_async_save_invisible_until_the_drain(tmp_path, monkeypatch):
    import threading

    gate = threading.Event()
    real = st.save_file

    def slow(*a, **kw):
        gate.wait(30)
        return real(*a, **kw)

    monkeypatch.setattr(st, "save_file", slow)
    ts = _state()
    target = str(tmp_path / "step_00000001")
    ckpt.save_accelerator_state(target, train_states=[ts], step=1,
                                async_save=True)
    assert not ckpt.is_complete_checkpoint(target)
    assert ckpt.latest_complete_checkpoint(str(tmp_path)) is None
    assert ckpt.prune_checkpoints(str(tmp_path), 1) == []
    gate.set()
    assert ckpt.wait_for_checkpoints() == 1
    assert ckpt.is_complete_checkpoint(target)
    assert ckpt.wait_for_checkpoints() == 0


def test_failing_writer_reraises_at_the_drain(tmp_path, monkeypatch):
    ts = _state()
    good = str(tmp_path / "step_00000001")
    ckpt.save_accelerator_state(good, train_states=[ts], step=1,
                                async_save=True)
    ckpt.wait_for_checkpoints()

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(st, "save_file", boom)
    bad = [str(tmp_path / f"step_0000000{i}") for i in (2, 3)]
    for i, d in enumerate(bad):
        ckpt.save_accelerator_state(d, train_states=[ts], step=2 + i,
                                    async_save=True)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_checkpoints()
    # neither the failed save nor the one after it committed
    assert not any(ckpt.is_complete_checkpoint(d) for d in bad)
    assert ckpt.latest_complete_checkpoint(str(tmp_path)) == good
    monkeypatch.undo()
    # the writer starts from a clean slate
    ckpt.save_accelerator_state(bad[0], train_states=[ts], step=2,
                                async_save=True)
    assert ckpt.wait_for_checkpoints() == 1
    assert ckpt.is_complete_checkpoint(bad[0])


def test_torn_save_is_skipped_by_resume(tmp_path):
    acc = Accelerator(cpu=True)
    ts = _state()
    _perturb(ts, 2)
    want = ts.params["w"].clone()
    acc.step = 2
    good = acc.save_state(str(tmp_path / "step_00000002"), state=ts)
    _perturb(ts, 4)
    acc.step = 4
    torn = acc.save_state(str(tmp_path / "step_00000004"), state=ts,
                          async_save=True)
    acc.wait_for_checkpoints()
    os.remove(os.path.join(torn, ckpt.MANIFEST_NAME))   # died before commit
    out = acc.resume_latest(str(tmp_path), state=ts)
    assert out["checkpoint_dir"] == good and out["step"] == 2
    assert acc.step == 2 and ts.step == 20
    _same(ts.params["w"], want)


def test_async_stage_is_ordered_before_the_next_in_place_step(tmp_path):
    acc = Accelerator(cpu=True)
    ts = acc.prepare(_state(loss_scale=False))
    step = acc.train_step(lambda p, b: (p["w"].sum() * b).square())
    ts, _ = step(ts, torch.tensor(0.5))
    want = {k: v.clone() for k, v in flatten_dict(ts.params).items()}
    acc.save_state(str(tmp_path), state=ts, async_save=True)
    for _ in range(3):
        ts, _ = step(ts, torch.tensor(0.5))
    acc.wait_for_checkpoints()
    got = st.load_file(str(tmp_path / "model_0.safetensors"))
    for k, v in want.items():
        _same(got[f"params.{k}"], v)
    assert not torch.equal(got["params.w"], ts.params["w"])


# --- versioned directories ---------------------------------------------------


def test_automatic_naming_and_total_limit_match_jax(tmp_path):
    at.PartialState._reset_state()
    jacc = at.Accelerator(project_config=at.ProjectConfiguration(
        project_dir=str(tmp_path / "jax"), automatic_checkpoint_naming=True,
        total_limit=2))
    tacc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path / "port"), automatic_checkpoint_naming=True,
        total_limit=2))
    ts = _state()
    for i in range(4):
        jout = jacc.save_state()
        tout = tacc.save_state(state=ts)
        assert os.path.basename(jout) == os.path.basename(tout)
        assert sorted(os.listdir(tmp_path / "jax" / "checkpoints")) == \
            sorted(os.listdir(tmp_path / "port" / "checkpoints"))
        assert jacc.project_configuration.iteration == \
            tacc.project_configuration.iteration == i
    assert sorted(os.listdir(tmp_path / "port" / "checkpoints")) == [
        "checkpoint_2", "checkpoint_3"]
    assert os.path.basename(jacc._checkpoint_dir(new=False)) == \
        os.path.basename(tacc._checkpoint_dir(new=False)) == "checkpoint_3"
    assert tacc.load_state(state=ts)["step"] == 0
    at.PartialState._reset_state()


@pytest.mark.parametrize("limit", [1, 2])
def test_automatic_naming_with_async_saves_keeps_every_commit(limit,
                                                              tmp_path):
    """With total_limit=1 the prune would hit the one directory an async
    save may still be writing: save_state drains first. Every directory
    left is a complete commit."""
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True,
        total_limit=limit))
    ts = _state()
    for i in range(4):
        acc.step = i
        acc.save_state(state=ts, async_save=True)
        acc.save_state(async_save=True)      # no train state: commits now
    acc.wait_for_checkpoints()
    base = tmp_path / "checkpoints"
    names = sorted(os.listdir(base))
    assert names == [f"checkpoint_{i}" for i in range(8 - limit, 8)]
    assert all(ckpt.is_complete_checkpoint(str(base / n)) for n in names)


def test_retention_waits_for_a_manifest_being_published(tmp_path,
                                                        monkeypatch):
    """The writer thread publishes a sealed commit at the end of its job.
    While that manifest is being written, the directory must still count
    as sealing: with total_limit=1 the next save's retention drains
    instead of deleting it under the writer."""
    import threading

    sealed, entered, release, draining = (threading.Event()
                                          for _ in range(4))
    real_manifest, real_save = ckpt.write_manifest, st.save_file

    def held(*a, **kw):
        if threading.current_thread().name.startswith("ckpt-writer") \
                and not release.is_set():
            entered.set()
            release.wait(30)
        return real_manifest(*a, **kw)

    def after_seal(*a, **kw):
        # the job's write waits until its save is sealed, so the job's
        # own flush publishes it
        sealed.wait(30)
        return real_save(*a, **kw)

    monkeypatch.setattr(ckpt, "write_manifest", held)
    monkeypatch.setattr(st, "save_file", after_seal)
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True,
        total_limit=1))
    drain = acc.wait_for_checkpoints

    def watched_drain():
        draining.set()
        return drain()

    acc.wait_for_checkpoints = watched_drain
    ts = _state()
    first = acc.save_state(state=ts, async_save=True)
    sealed.set()
    assert entered.wait(30), "the writer never reached its manifest"
    assert first in ckpt.sealing_checkpoint_dirs()
    out = {}
    second = threading.Thread(
        target=lambda: out.setdefault("dir", acc.save_state(
            state=ts, async_save=True)))
    second.start()
    while not draining.is_set() and second.is_alive():
        draining.wait(0.01)
    # the manifest is still pending: the directory must be there
    assert os.path.isdir(first) and not ckpt.is_complete_checkpoint(first)
    release.set()
    second.join(30)
    assert not second.is_alive() and draining.is_set()
    ckpt.wait_for_checkpoints()
    base = tmp_path / "checkpoints"
    assert sorted(os.listdir(base)) == ["checkpoint_1"]
    assert out["dir"] == str(base / "checkpoint_1")
    assert all(ckpt.is_complete_checkpoint(str(base / n))
               for n in os.listdir(base))


def test_project_dir_and_default_resume_dir(tmp_path):
    acc = Accelerator(cpu=True, project_dir=str(tmp_path))
    assert acc.project_configuration.project_dir == str(tmp_path)
    ts = _state()
    acc.step = 3
    acc.save_state(str(tmp_path / "checkpoints" / "step_3"), state=ts)
    acc.step = 0
    out = acc.resume_latest(state=ts)
    assert out["step"] == 3 and acc.step == 3
    with pytest.raises(FileNotFoundError):
        Accelerator(cpu=True, project_config=ProjectConfiguration(
            project_dir=str(tmp_path / "none"),
            automatic_checkpoint_naming=True)).load_state()


def test_get_state_dict_is_host_tensors():
    acc = Accelerator(cpu=True)
    ts = _state()
    sd = acc.get_state_dict(ts)
    assert set(sd) == {"w", "blk"} and sd["blk"]["h"].dtype == torch.bfloat16
    _same(sd["w"], ts.params["w"])


# --- train_step(donate=False) -------------------------------------------------


def test_train_step_without_donation_leaves_the_input(tmp_path):
    acc = Accelerator(cpu=True, gradient_clipping=1.0)

    def loss(p, b):
        return ((b @ p["w"]).square().mean() + p["blk"]["b"].sum()
                + p["blk"]["h"].float().sum())

    g = torch.Generator().manual_seed(3)
    batch = torch.randn(5, 8, generator=g)
    donated = acc.prepare(_state(loss_scale=False))
    kept = acc.prepare(_state(loss_scale=False))
    before = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in _leaves_no_scale(kept).items()}
    ptrs = {k: v.data_ptr() for k, v in _leaves_no_scale(kept).items()
            if isinstance(v, torch.Tensor)}
    new, m_new = acc.train_step(loss, donate=False)(kept, batch)
    old, m_old = acc.train_step(loss)(donated, batch)
    for k, v in _leaves_no_scale(kept).items():
        if isinstance(v, torch.Tensor):
            _same(v, before[k])
            assert v.data_ptr() == ptrs[k]
    assert kept.step == 0 and new.step == 1
    _same(m_new["loss"], m_old["loss"])
    a, b = _leaves_no_scale(new), _leaves_no_scale(old)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            _same(a[k], b[k])
            if k.startswith(("p.", "o.mu", "o.nu")):
                assert a[k].data_ptr() != ptrs[k]
    assert not torch.equal(new.params["w"], kept.params["w"])


def _leaves_no_scale(ts):
    return {"step": ts.step,
            **{f"p.{k}": v for k, v in flatten_dict(ts.params).items()},
            **{f"o.{k}": v for k, v in
               flatten_dict(ts.opt_state).items()}}


def test_loss_scale_state_saves_without_rebinding(tmp_path):
    ts = _state()
    ts.loss_scale = DynamicLossScale.create(init_scale=8.0)
    ckpt.save_accelerator_state(str(tmp_path), train_states=[ts])
    scale = ts.loss_scale.scale
    scale.fill_(1.0)
    ckpt.load_accelerator_state(str(tmp_path), train_states=[ts])
    assert ts.loss_scale.scale is scale and float(scale) == 8.0


# --- fp8 metas ---------------------------------------------------------------


def _fp8_state(seed=0):
    from accelerate_tpu_torch.models import llama as tl

    ts = _state(seed)
    ts.fp8_state = tl.init_fp8_state(tl.LlamaConfig.tiny(), device="cpu")
    g = torch.Generator().manual_seed(seed)
    for t in flatten_dict(ts.fp8_state).values():
        t.copy_(torch.rand(t.shape, generator=g) * 100)
    return ts


@pytest.mark.parametrize("async_save", [False, True])
def test_fp8_state_round_trip_in_place(async_save, tmp_path):
    ts = _fp8_state(1)
    saved = {k: v.clone() for k, v in flatten_dict(ts.fp8_state).items()}
    ckpt.save_accelerator_state(str(tmp_path), train_states=[ts], step=3,
                                async_save=async_save)
    ckpt.wait_for_checkpoints()
    assert ckpt.is_complete_checkpoint(str(tmp_path))
    manifest = ckpt.read_manifest(str(tmp_path))
    assert {"model_0_fp8.safetensors", "model_0_fp8.json"} <= \
        set(manifest["files"])
    with open(tmp_path / "model_0_fp8.json") as f:
        assert f.read() == '{"amax_history_len": 16}'
    # the safetensors package reads the file, keyed by flatten_dict paths
    got = safetensors.torch.load_file(str(tmp_path / "model_0_fp8.safetensors"))
    assert set(got) == {f"fp8_state.{k}" for k in saved}
    for k, v in saved.items():
        _same(got[f"fp8_state.{k}"], v)
    live = flatten_dict(ts.fp8_state)
    for t in live.values():
        t.zero_()
    ckpt.load_accelerator_state(str(tmp_path), train_states=[ts])
    for k, v in flatten_dict(ts.fp8_state).items():
        assert v is live[k]
        _same(v, saved[k])


def test_fp8_checkpoint_restores_across_history_len_change(tmp_path):
    """A checkpoint written under a 1024-long amax window restores into a
    16-long one by keeping the newest entries (and a 4-long one back into
    16 by padding with zeros), as the JAX package does."""
    from accelerate_tpu_torch.ops import fp8 as tf

    params = {"w": torch.ones(8, 8)}
    old = tf.adapt_history_len(tf.init_fp8_state(params), 1024)
    old = {"w": {r: tf.Fp8Meta(m.scale * 2,
                               m.amax_history.index_fill(-1,
                                                         torch.tensor(0), 7.0))
                 for r, m in old["w"].items()}}
    ts = TrainState.create(apply_fn=None, params=params, tx=to.sgd(1e-3),
                           fp8_state=old)
    ckpt.save_accelerator_state(str(tmp_path / "long"), train_states=[ts])
    ts2 = TrainState.create(apply_fn=None, params=params, tx=to.sgd(1e-3),
                            fp8_state=tf.init_fp8_state(params))
    hist = ts2.fp8_state["w"]["x"].amax_history
    ckpt.load_accelerator_state(str(tmp_path / "long"), train_states=[ts2])
    assert tf.fp8_state_history_len(ts2.fp8_state) == 16
    meta = ts2.fp8_state["w"]["x"]
    assert meta.amax_history is hist
    assert float(meta.amax_history[0]) == 7.0
    assert float(meta.amax_history[1:].abs().sum()) == 0.0
    assert float(meta.scale) == 2.0
    # the JAX package restores its own long checkpoint the same way
    jp = {"w": jnp.ones((8, 8))}
    jold = jax.tree_util.tree_map(
        lambda m: jf.Fp8Meta(scale=m.scale * 2,
                             amax_history=m.amax_history.at[..., 0].set(7.0)),
        jf.adapt_history_len(jf.init_fp8_state(jp), 1024),
        is_leaf=lambda x: isinstance(x, jf.Fp8Meta))
    import optax

    jts = at.TrainState.create(apply_fn=None, params=jp, tx=optax.sgd(1e-3),
                               fp8_state=jold)
    jckpt.save_accelerator_state(str(tmp_path / "jax"), train_states=[jts])
    jts2 = at.TrainState.create(apply_fn=None, params=jp, tx=optax.sgd(1e-3),
                                fp8_state=jf.init_fp8_state(jp))
    jckpt.load_accelerator_state(str(tmp_path / "jax"), train_states=[jts2])
    jmeta = jts2.fp8_state["w"]["x"]
    np.testing.assert_array_equal(np.asarray(jmeta.amax_history),
                                  meta.amax_history.numpy())
    assert float(jmeta.scale) == float(meta.scale)
    # a short window pads with zeros
    short = TrainState.create(
        apply_fn=None, params=params, tx=to.sgd(1e-3),
        fp8_state=tf.adapt_history_len(ts2.fp8_state, 4))
    ckpt.save_accelerator_state(str(tmp_path / "short"),
                                train_states=[short])
    ts2.fp8_state["w"]["x"].amax_history.fill_(5.0)
    ckpt.load_accelerator_state(str(tmp_path / "short"), train_states=[ts2])
    assert ts2.fp8_state["w"]["x"].amax_history.tolist() == \
        [7.0] + [0.0] * 15


def test_fp8_state_through_resume_latest_and_async_saves(tmp_path):
    acc = Accelerator(cpu=True)
    ts = _fp8_state(2)
    want = {k: v.clone() for k, v in flatten_dict(ts.fp8_state).items()}
    acc.step = 4
    acc.save_state(str(tmp_path / "step_00000004"), state=ts,
                   async_save=True)
    for t in flatten_dict(ts.fp8_state).values():   # the next steps
        t.add_(1.0)
    out = acc.resume_latest(str(tmp_path), state=ts)
    assert out["step"] == 4
    for k, v in flatten_dict(ts.fp8_state).items():
        _same(v, want[k])
