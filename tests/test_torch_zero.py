"""ZeRO-1/2 on the `fsdp` axis (`DeepSpeedPlugin(zero_stage=1|2)`: params
whole on every rank, the AdamW moments and the accumulation buffer each
rank's block) against the JAX Accelerator with the same plugin, at the
tiny llama width, on the same numpy weights and global batches.

One 4-rank `debug_launcher` world on the CPU (gloo) runs every port case
(`test_utils.worlds.zero_forms`): ZeRO-2 and ZeRO-1 on `{fsdp: 4}` and
`{data: 2, fsdp: 2}` with the clip active, ZeRO-1 under fp16 with a
loss scale that makes step 1 overflow (beside stage 0, data
parallelism, under the same fp16), ZeRO-2 with two accumulation steps
and its sharded buffer, the eager loop, a save and reload of a ZeRO-2
state, a one-process checkpoint resumed under ZeRO-2, and the meshes
the world resolves that are refused. The JAX side runs in the pytest
process on the conftest's 8 CPU devices with the same plugin, `fsdp`
the port's size and `data` filling the rest.

Tolerances, those of `test_torch_sharded_training.py` (f32 on both
sides, the products and the reductions in another order): losses rtol 1e-5, params after three
AdamW steps atol 2e-5 (about 0.02 of an update of lr 1e-3), pre-clip
norms rtol 1e-5, each moment leaf within 1e-4 of its largest magnitude
(the gradient rule of `test_torch_expert_parallel.py`: the moments are
sums of gradients and their squares, and an element near zero takes the
rounding of the reductions whole, up to 6e-4 of itself). fp16: losses atol 5e-3
against the JAX Accelerator (the fp16 skip test's, `test_torch_train_
step.py`: both sides round to f16 at other places); the ZeRO-1 params
atol 2e-5 against the port's own stage 0 under the same fp16, the
reductions alone differing.
"""

import argparse
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import TrainState as JTrainState
from accelerate_tpu.accelerator import Accelerator as JAccelerator
from accelerate_tpu.models import llama as jl
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu.training import DynamicLossScale as JLossScale
from accelerate_tpu.utils import ContextParallelPlugin as JCPPlugin
from accelerate_tpu.utils import DeepSpeedPlugin as JDeepSpeedPlugin
from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JFSDP
from accelerate_tpu.utils import MeshConfig as JMeshConfig
from accelerate_tpu_torch.test_utils import bundled_script_path, \
    execute_subprocess, launch_command_for, run_world
from accelerate_tpu_torch.test_utils.worlds import zero_forms

WORLD = 4
WORLD_TIMEOUT_S = 300
LR = 1e-3
STEPS = 3
LOSS_RTOL, PARAM_ATOL, NORM_RTOL = 1e-5, 2e-5, 1e-5
MOMENT_SCALE = 1e-4
FP16_LOSS_ATOL = 5e-3
STEP_2B, STEP_2C = "queue 1 item 6b, step 2b", "queue 1 item 6b, step 2c"

IDS = np.random.default_rng(0).integers(0, 256, (8, 33)).astype(np.int32)
IDS_2 = np.random.default_rng(1).integers(0, 256, (8, 33)).astype(np.int32)
# step 1 overflows f16 at 2^30 and backs off to 2^10, which does not
FP16_SCALE = (2.0 ** 30, 2.0 ** -20)
F4, D2F2 = {"fsdp": 4}, {"data": 2, "fsdp": 2}
# the JAX mesh of each port mesh: the same `fsdp`, `data` the rest of 8
JAX_AXES = {"f4": {"data": 2, "fsdp": 4}, "d2f2": {"data": 4, "fsdp": 2}}
FUSED = {  # name: (stage, port mesh, JAX mesh key)
    "zero2_f4": (2, F4, "f4"), "zero2_d2f2": (2, D2F2, "d2f2"),
    "zero1_f4": (1, F4, "f4"), "zero1_d2f2": (1, D2F2, "d2f2")}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            out.update(_flat(sub, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(sub)
    return out


@pytest.fixture(scope="module")
def weights():
    return _numpy(jl.init_params(jl.LlamaConfig.tiny(), jax.random.key(0)))


# -- a one-process checkpoint, and the unbroken run it resumes ----------------


def _port_one_process(weights, steps, save=None):
    """The port's one-process fused step (clip 1.0, adamw) over IDS:
    each step's loss and the final params; with `save`, `save_state`
    after the first step."""
    from accelerate_tpu_torch import optimizers
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_numpy
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState

    PartialState._reset_state()
    try:
        acc = Accelerator(cpu=True, gradient_clipping=1.0)
        cfg = llama.LlamaConfig.tiny()
        state = acc.prepare(TrainState.create(
            apply_fn=None, params=params_from_numpy(weights, device="cpu"),
            tx=optimizers.adamw(LR)))
        step = acc.train_step(lambda p, b: llama.causal_lm_loss(cfg, p, b))
        losses = []
        for i in range(steps):
            state, m = step(state, {"input_ids": torch.tensor(IDS)})
            losses.append(float(m["loss"]))
            if i == 0 and save:
                acc.save_state(save, state=state)
        return losses, _flat(_numpy(jax.tree_util.tree_map(
            lambda t: t.numpy(), state.params)))
    finally:
        PartialState._reset_state()


@pytest.fixture(scope="module")
def one_process(weights, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("one_process") / "ckpt")
    losses, params = _port_one_process(weights, 2, save=path)
    return {"checkpoint": path, "losses": losses, "params": params}


# -- the world ---------------------------------------------------------------


def _cases(weights, one_process):
    base = dict(kind="fused", params=weights, lr=LR, clip=1.0, steps=STEPS,
                ids=[IDS])
    fused = [dict(base, name=name, zero_stage=stage, axes=axes)
             for name, (stage, axes, _) in FUSED.items()]
    fused[0]["save"] = "zero2_checkpoint"
    fp16 = dict(base, mixed_precision="fp16", loss_scale=FP16_SCALE, axes=F4)
    return [
        *fused,
        dict(fp16, name="zero1_fp16", zero_stage=1),
        dict(fp16, name="zero0_fp16", zero_stage=0, axes={"data": 4}),
        dict(base, name="zero2_accum", zero_stage=2, axes=F4, k=2,
             ids=[IDS, IDS_2]),
        dict(base, name="eager", kind="eager", zero_stage=2, axes=F4),
        dict(base, name="resume", kind="resume", zero_stage=2, axes=F4,
             checkpoint=one_process["checkpoint"]),
        dict(name="refusals", kind="refusals"),
    ]


@pytest.fixture(scope="module")
def world(weights, one_process, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("zero_world"))
    ranks = run_world(zero_forms, WORLD, (_cases(weights, one_process),),
                      out_dir=out_dir, timeout_s=WORLD_TIMEOUT_S)
    return {name: [r[name] for r in ranks] for name in ranks[0]
            if name != "log"}


# -- the JAX side ----------------------------------------------------------------


def _jax_run(weights, stage, axes, *, mp="no", k=1, batches=(IDS,),
             loss_scale=None, norms=True):
    """The JAX Accelerator with `DeepSpeedPlugin(zero_stage=stage)` on
    `axes`, clip 1.0, `optax.adamw(LR)`: STEPS passes over `batches`,
    each step's loss (and, with `norms`, the pre-clip norm of the global
    batch's gradient before it), the loss scale after each step, the
    final params and the moments."""
    JPartialState._reset_state()
    try:
        acc = JAccelerator(
            gradient_clipping=1.0, mixed_precision=mp,
            gradient_accumulation_steps=k,
            deepspeed_plugin=JDeepSpeedPlugin(zero_stage=stage),
            mesh_config=JMeshConfig(axes=axes))
        cfg = jl.LlamaConfig.tiny()
        ts = JTrainState.create(apply_fn=None, params=_j(weights),
                                tx=optax.adamw(LR),
                                use_grad_accum_buffer=k > 1)
        if loss_scale is not None:
            ts = dataclasses.replace(ts, loss_scale=JLossScale(
                scale=jnp.asarray(loss_scale[0], jnp.float32),
                growth_tracker=jnp.asarray(0, jnp.int32),
                backoff_factor=loss_scale[1]))
        state = acc.prepare(ts)

        def loss_fn(p, b):
            return jl.causal_lm_loss(cfg, p, b)

        loader = acc.prepare([{"input_ids": b} for b in batches])
        step = acc.train_step(loss_fn)
        out = {"losses": [], "norms": [], "scales": []}
        for _ in range(STEPS):
            for batch in loader:
                if norms:
                    _, grads = acc.compute_gradients(loss_fn, state.params,
                                                     batch)
                    out["norms"].append(float(optax.global_norm(grads)))
                state, m = step(state, batch)
                out["losses"].append(float(m["loss"]))
                if state.loss_scale is not None:
                    out["scales"].append(float(state.loss_scale.scale))
        adam = next(s for s in state.opt_state if hasattr(s, "mu"))
        out["params"] = _flat(_numpy(state.params))
        out["moments"] = {**{f"mu/{p}": v for p, v in
                             _flat(_numpy(adam.mu)).items()},
                          **{f"nu/{p}": v for p, v in
                             _flat(_numpy(adam.nu)).items()}}
        return out
    finally:
        JPartialState._reset_state()


@pytest.fixture(scope="module")
def jax_fused(weights):
    return {name: _jax_run(weights, stage, JAX_AXES[key])
            for name, (stage, _, key) in FUSED.items()}


@pytest.fixture(scope="module")
def jax_fp16(weights):
    return _jax_run(weights, 1, JAX_AXES["f4"], mp="fp16",
                    loss_scale=FP16_SCALE, norms=False)


@pytest.fixture(scope="module")
def jax_accum(weights):
    return _jax_run(weights, 2, JAX_AXES["f4"], k=2, batches=(IDS, IDS_2),
                    norms=False)


# -- checks ------------------------------------------------------------------------


def _close_params(got, want):
    got = _flat(got)
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf, want[path], rtol=0,
                                   atol=PARAM_ATOL, err_msg=path)


def _same_on_every_rank(ranks):
    """Every rank's losses and params equal rank 0's bit for bit."""
    first = _flat(ranks[0]["params"])
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        for path, leaf in _flat(r["params"]).items():
            np.testing.assert_array_equal(leaf, first[path], err_msg=path)


def _moments_are_blocks(r, want):
    """Each moment block equals the reference's moment sliced by the
    rank's `fsdp` index along the leaf's cut dim; a leaf the plan keeps
    whole has whole moments."""
    size, index = r["fsdp"]
    cut = 0
    for path, got in r["moments"].items():
        full = want["moments"][path]
        dim = r["dims"][path.split("/", 1)[1]]
        if dim is None:
            assert got.shape == full.shape, path
            block = full
        else:
            cut += 1
            b = full.shape[dim] // size
            block = np.take(full, range(index * b, (index + 1) * b),
                            axis=dim)
        scale = max(float(np.abs(full).max()), 1e-30)
        assert got.shape == block.shape, path
        assert np.abs(got - block).max() <= MOMENT_SCALE * scale, path
    assert cut > 0


@pytest.mark.parametrize("name", list(FUSED))
def test_zero_fused_step_matches_jax(world, jax_fused, name):
    """The fused step with the clip active: the losses, each step's
    pre-clip norm (each block's squares counted once across the `fsdp`
    line) and the params equal the JAX Accelerator's with the same
    plugin; the params are whole and bit-identical on every rank, and
    each rank's moments are its block of the reference's."""
    ranks, want = world[name], jax_fused[name]
    stage, axes, _ = FUSED[name]
    for r in ranks:
        assert r["mesh"] == axes
        assert r["line"][0] == 4
        np.testing.assert_allclose(r["norms"], want["norms"],
                                   rtol=NORM_RTOL)
        _close_params(r["params"], want["params"])
        _moments_are_blocks(r, want)
    _same_on_every_rank(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


@pytest.mark.parametrize("name", ["zero2_f4", "zero2_d2f2"])
def test_zero_collectives_like_the_reference(world, name):
    """The collectives of one ZeRO-2 step, as the reference's compiled
    contract pins them (`tests/test_compiled_contracts.py`
    `TestZeroCollectiveStructure`): the gradients reduce-scatter over
    `fsdp` into moment blocks, only the params' blocks all-gather over
    `fsdp`, and no all-reduce carries a gradient leaf that the plan
    cuts: on `{data: 2, fsdp: 2}` the blocks average over `data`, the
    whole leaves (norm scales, below the planner's minimum size) over
    the batch line, and the loss over the line."""
    r = world[name][0]
    fsdp = r["mesh"]["fsdp"]
    numel = {p: leaf.size for p, leaf in _flat(r["params"]).items()}
    cut = sum(n for p, n in numel.items() if r["dims"][p] is not None)
    whole = sum(n for p, n in numel.items() if r["dims"][p] is None)
    calls = r["collectives"]
    scatters = [c for c in calls if c[0] == "reduce_scatter_mean_"]
    gathers = [c for c in calls if c[0] == "all_gather_blocks_"]
    reduces = [c for c in calls if c[0] == "all_reduce_mean_"]
    assert [(size, sum(n)) for _, size, n in scatters] == [(fsdp, cut)]
    assert [(size, sum(n)) for _, size, n in gathers] == [(fsdp, cut)]
    want = [(4, whole), (4, 1)]
    if fsdp < 4:
        want = [(4 // fsdp, cut // fsdp)] + want
    assert [(size, sum(n)) for _, size, n in reduces] == want


def test_zero1_fp16_skips_and_scales_like_jax(world, jax_fp16):
    """ZeRO-1 under fp16: step 1 overflows (its loss scale 2^30) and is
    skipped on every rank, the scale backs off to 2^10 and steps 2-3
    update, as the JAX Accelerator's do; the losses within the fp16
    tolerance of the reference's, the params those of the port's own
    stage 0 under the same fp16 (only the reductions differ)."""
    ranks, ddp = world["zero1_fp16"], world["zero0_fp16"]
    assert jax_fp16["scales"] == [2.0 ** 10] * STEPS
    for r in ranks:
        assert r["scales"] == jax_fp16["scales"]
        assert r["dims"] is not None
        _close_params(r["params"], _flat(ddp[0]["params"]))
    assert ddp[0]["dims"] is None and ddp[0]["scales"] == jax_fp16["scales"]
    _same_on_every_rank(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], jax_fp16["losses"],
                               rtol=0, atol=FP16_LOSS_ATOL)
    # the skipped step left the params: step 2's loss is the same batch's
    # loss at the same params
    assert ranks[0]["losses"][1] == ranks[0]["losses"][0]


def test_zero2_accumulation_shards_the_buffer(world, jax_accum):
    """Two accumulation steps: the buffer holds each rank's block of
    every cut leaf (each micro-step's reduce-scatter adds into it), and
    the three updates' losses and params equal the JAX Accelerator's."""
    ranks = world["zero2_accum"]
    for r in ranks:
        params = _flat(r["params"])
        for path, shape in r["buffer_shapes"].items():
            dim = r["dims"][path]
            want = list(params[path].shape)
            if dim is not None:
                want[dim] //= 4
            assert shape == tuple(want), path
        _close_params(r["params"], jax_accum["params"])
    _same_on_every_rank(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], jax_accum["losses"],
                               rtol=LOSS_RTOL)


def test_zero_eager_loop_matches_jax(world, jax_fused):
    """`prepare_optimizer`, `compute_gradients`, `backward`,
    `clip_grad_norm_` and `opt.step()` under ZeRO-2 on `{fsdp: 4}`: the
    optimizer updates the caller's whole params, its moments are blocks,
    and the losses, norms and params equal the JAX fused step's."""
    want = jax_fused["zero2_f4"]
    ranks = world["eager"]
    for r in ranks:
        assert r["same_params"]
        np.testing.assert_allclose(r["norms"], want["norms"], rtol=NORM_RTOL)
        _close_params(r["params"], want["params"])
        _moments_are_blocks(r, want)
    _same_on_every_rank(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"],
                               rtol=LOSS_RTOL)


def test_zero_checkpoint_loads_in_one_process(world, weights):
    """A ZeRO-2 `save_state` holds the same files and keys as a
    one-process save, its tensors whole: it loads into a one-process
    state whose params and moments equal the world's gathered ones; the
    world reloads it into its blocks bit for bit, and `get_state_dict`
    gives the whole params."""
    from accelerate_tpu_torch import optimizers
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_numpy
    from accelerate_tpu_torch.sharding.planner import leaves_with_path
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState
    from accelerate_tpu_torch.utils import safetensors as st

    ranks = world["zero2_f4"]
    for r in ranks:
        assert r["reloaded"]
        for path, leaf in _flat(r["state_dict"]).items():
            np.testing.assert_array_equal(leaf, _flat(r["params"])[path])
    path = ranks[0]["saved"]
    PartialState._reset_state()
    try:
        acc = Accelerator(cpu=True)
        state = acc.prepare(TrainState.create(
            apply_fn=None, params=params_from_numpy(weights, device="cpu"),
            tx=optimizers.adamw(LR)))
        acc.load_state(path, state=state)
        one = os.path.join(os.path.dirname(path), "one_process_save")
        acc.save_state(one, state=state)
    finally:
        PartialState._reset_state()
    assert state.step == STEPS
    for p, leaf in _flat(jax.tree_util.tree_map(
            lambda t: t.numpy(), state.params)).items():
        np.testing.assert_array_equal(leaf, _flat(ranks[0]["params"])[p])
    for k in ("mu", "nu"):
        for p, leaf in leaves_with_path(getattr(state.opt_state, k)):
            np.testing.assert_array_equal(
                leaf.numpy(), ranks[0]["whole_moments"][f"{k}/{p}"])
    name = "model_0.safetensors"
    got, _ = st.read_header(os.path.join(path, name))
    want, _ = st.read_header(os.path.join(one, name))
    assert {k: v for k, v in got.items() if k != "__metadata__"} == \
        {k: v for k, v in want.items() if k != "__metadata__"}
    assert {f for f in os.listdir(path) if f.endswith(".safetensors")} \
        == {f for f in os.listdir(one) if f.endswith(".safetensors")}


def test_one_process_checkpoint_resumes_under_zero(world, one_process):
    """A one-process checkpoint after step 1 loads into ZeRO-2's blocks
    on `{fsdp: 4}`, and the next step's loss and params equal the
    unbroken one-process run's step 2."""
    for r in world["resume"]:
        assert r["step"] == 2
        np.testing.assert_allclose(r["loss"], one_process["losses"][1],
                                   rtol=LOSS_RTOL)
        _close_params(r["params"], one_process["params"])


def test_world_meshes_that_shard_params_are_refused(world):
    """Resolved over the world: a bare `fsdp` mesh (the reference would
    shard params there) and ZeRO beside a `seq` axis raise, naming step
    2b."""
    for r in world["refusals"]:
        for name in ("bare_fsdp", "zero_beside_seq"):
            assert r[name] is not None and STEP_2B in r[name], r[name]


# -- one process -------------------------------------------------------------


@pytest.mark.parametrize("plugin", [
    ("fsdp", "FULL_SHARD"), ("fsdp", "SHARD_GRAD_OP"), ("fsdp", "NO_SHARD"),
    ("fsdp", "HYBRID_SHARD"), ("ds", 0), ("ds", 1), ("ds", 2), ("ds", 3),
    ("ds_moe", 2)], ids=lambda p: f"{p[0]}-{p[1]}")
def test_plugins_like_jax(plugin):
    """The plugins' mesh axes and their ZeRO flags equal the reference
    dataclasses', and constructing any choice works."""
    from accelerate_tpu_torch.utils.dataclasses import DeepSpeedPlugin, \
        FullyShardedDataParallelPlugin

    kind, value = plugin
    if kind == "fsdp":
        pairs = [(FullyShardedDataParallelPlugin(sharding_strategy=value),
                  JFSDP(sharding_strategy=value))]
    else:
        kw = {"zero_stage": value}
        if kind == "ds_moe":
            kw["moe_expert_parallel_size"] = 2
        pairs = [(DeepSpeedPlugin(**kw), JDeepSpeedPlugin(**kw))]
    for port, ref in pairs:
        assert port.to_mesh_axes() == ref.to_mesh_axes()
        assert port.shard_params == ref.shard_params
        if hasattr(ref, "shard_optimizer_state"):
            assert port.shard_optimizer_state == ref.shard_optimizer_state
        assert set(dataclasses.asdict(port)) == set(dataclasses.asdict(ref))


@pytest.mark.parametrize("plugins", [
    {"deepspeed_plugin": ("ds", 2)},
    {"deepspeed_plugin": ("ds", 0)},
    {"fsdp_plugin": ("fsdp", "SHARD_GRAD_OP")},
    {"fsdp_plugin": ("fsdp", "NO_SHARD")},
    {"fsdp_plugin": ("fsdp", "SHARD_GRAD_OP"),
     "context_parallel_plugin": ("cp", -1)}],
    ids=["zero2", "zero0", "shard_grad_op", "no_shard", "two_wildcards"])
def test_plugin_mesh_resolution_like_jax(plugins):
    """The mesh the plugins ask for, by the reference's rule (each
    plugin's axes, the first of several fill-the-rest axes kept with a
    warning, `data` filling the rest): over 8 processes the port's mesh
    is the JAX Accelerator's over its 8 devices."""
    import warnings

    from accelerate_tpu_torch.accelerator import _plugin_mesh
    from accelerate_tpu_torch.utils.dataclasses import \
        ContextParallelPlugin, DeepSpeedPlugin, \
        FullyShardedDataParallelPlugin

    makers = {
        "ds": (lambda v: DeepSpeedPlugin(zero_stage=v),
               lambda v: JDeepSpeedPlugin(zero_stage=v)),
        "fsdp": (lambda v: FullyShardedDataParallelPlugin(
            sharding_strategy=v), lambda v: JFSDP(sharding_strategy=v)),
        "cp": (lambda v: ContextParallelPlugin(seq_degree=v),
               lambda v: JCPPlugin(seq_degree=v))}
    port = {k: makers[m][0](v) for k, (m, v) in plugins.items()}
    ref = {k: makers[m][1](v) for k, (m, v) in plugins.items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = _plugin_mesh(port.get("fsdp_plugin"),
                            port.get("deepspeed_plugin"),
                            port.get("context_parallel_plugin"))
    JPartialState._reset_state()
    try:
        with warnings.catch_warnings(record=True) as jcaught:
            warnings.simplefilter("always")
            jacc = JAccelerator(**ref)
        want = dict(jacc.mesh.shape)
    finally:
        JPartialState._reset_state()
    assert mesh.resolved_axes(8) == {a: s for a, s in want.items()}
    said = [str(w.message) for w in caught if "fill-the-rest" in
            str(w.message)]
    jsaid = [str(w.message) for w in jcaught if "fill-the-rest" in
             str(w.message)]
    assert len(said) == len(jsaid) == (len(plugins) == 2)


def test_accelerator_reads_the_launchers_zero_variables(monkeypatch):
    """`ACCELERATE_TORCH_ZERO_STAGE` and
    `ACCELERATE_TORCH_FSDP_SHARDING_STRATEGY` make the plugins, as the
    reference reads its own; the DeepSpeed plugin's clip is the
    Accelerator's where it sets none; custom `sharding_rules` are
    taken."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.sharding import ShardingRules
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils.dataclasses import DeepSpeedPlugin

    PartialState._reset_state()
    try:
        monkeypatch.setenv("ACCELERATE_TORCH_ZERO_STAGE", "1")
        acc = Accelerator(cpu=True)
        assert acc.deepspeed_plugin.zero_stage == 1
        assert acc.mesh.shape == {"fsdp": 1}
        monkeypatch.delenv("ACCELERATE_TORCH_ZERO_STAGE")
        monkeypatch.setenv("ACCELERATE_TORCH_FSDP_SHARDING_STRATEGY",
                           "SHARD_GRAD_OP")
        PartialState._reset_state()
        acc = Accelerator(cpu=True)
        assert acc.fsdp_plugin.sharding_strategy == "SHARD_GRAD_OP"
        monkeypatch.delenv("ACCELERATE_TORCH_FSDP_SHARDING_STRATEGY")
        PartialState._reset_state()
        rules = ShardingRules.from_pairs([("w$", ("fsdp",))])
        acc = Accelerator(cpu=True, sharding_rules=rules,
                          deepspeed_plugin=DeepSpeedPlugin(
                              zero_stage=2, gradient_clipping=0.5))
        assert acc.gradient_clipping == 0.5 and acc.sharding_rules is rules
    finally:
        PartialState._reset_state()


@pytest.mark.parametrize("kwargs, step", [
    ({"deepspeed_plugin": ("ds", {"zero_stage": 3})}, STEP_2B),
    ({"fsdp_plugin": ("fsdp", {"sharding_strategy": "FULL_SHARD"})},
     STEP_2B),
    ({"fsdp_plugin": ("fsdp", {"sharding_strategy": "HYBRID_SHARD"})},
     STEP_2B),
    ({"fsdp_plugin": ("fsdp", {"sharding_strategy": "SHARD_GRAD_OP",
                               "cpu_offload": True})}, STEP_2B),
    ({"deepspeed_plugin": ("ds", {"offload_optimizer_device": "cpu"})},
     STEP_2B),
    ({"deepspeed_plugin": ("ds", {"offload_param_device": "cpu"})},
     STEP_2B),
    ({"mesh_config": ("mesh", {"fsdp": 2})}, STEP_2B),
    ({"mesh_config": ("mesh", {"fsdp": 2, "seq": 2}),
      "deepspeed_plugin": ("ds", {"zero_stage": 2})}, STEP_2B),
    ({"mesh_config": ("mesh", {"model": 2}),
      "deepspeed_plugin": ("ds", {"zero_stage": 2})}, STEP_2C),
    ({"megatron_lm_plugin": ("megatron", {})}, STEP_2C)],
    ids=["zero3", "full_shard", "hybrid_shard", "cpu_offload",
         "offload_optimizer", "offload_param", "bare_fsdp",
         "zero_beside_seq", "model_axis", "megatron"])
def test_refusals_name_their_step(kwargs, step):
    """Every choice that shards params, offloads, or needs the `model`
    axis raises `NotImplementedError` when the Accelerator takes it,
    naming the step of queue 1 item 6b that brings it."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils.dataclasses import DeepSpeedPlugin, \
        FullyShardedDataParallelPlugin, MeshConfig

    make = {"ds": DeepSpeedPlugin, "fsdp": FullyShardedDataParallelPlugin,
            "mesh": lambda **axes: MeshConfig(axes=axes),
            # the port has no Megatron record: any value is the plugin
            "megatron": lambda: object()}
    args = {k: make[m](**v) for k, (m, v) in kwargs.items()}
    PartialState._reset_state()
    try:
        with pytest.raises(NotImplementedError, match=step):
            Accelerator(cpu=True, **args)
    finally:
        PartialState._reset_state()


def test_zero_plan_keeps_leaves_that_do_not_divide_whole():
    """The moments' plan on `{fsdp: 4}` cuts the largest dim that
    divides; a leaf no dim of which divides, and a leaf below the
    planner's minimum size, stay whole (`ZeroLayout.dims` None), as the
    reference's `auto_fsdp_spec` keeps them."""
    from accelerate_tpu_torch.sharding import plan_sharding
    from accelerate_tpu_torch.sharding.zero import ZeroLayout
    from accelerate_tpu_torch.state import ProcessMesh

    mesh = ProcessMesh({"fsdp": 4})
    params = {"w": torch.zeros(64, 96), "odd": torch.zeros(67, 71),
              "scale": torch.zeros(8)}
    layout = ZeroLayout(params, plan_sharding(params, mesh, shard_params=True),
                        mesh)
    assert layout.dims == [1, None, None] and layout.cut
    blocks = layout.blocks(params)
    assert {k: tuple(v.shape) for k, v in blocks.items()} == {
        "w": (64, 24), "odd": (67, 71), "scale": (8,)}


@pytest.mark.parametrize("flags, code, env", [
    (["--zero_stage", "2"], 0, {"ACCELERATE_TORCH_ZERO_STAGE": "2"}),
    (["--zero_stage", "1", "--mesh_shape", "data=2,fsdp=2"], 0,
     {"ACCELERATE_TORCH_ZERO_STAGE": "1",
      "ACCELERATE_TORCH_MESH_SHAPE": "data=2,fsdp=2"}),
    (["--zero_stage", "0"], 0, {"ACCELERATE_TORCH_ZERO_STAGE": "0"}),
    (["--fsdp_sharding_strategy", "SHARD_GRAD_OP"], 0,
     {"ACCELERATE_TORCH_FSDP_SHARDING_STRATEGY": "SHARD_GRAD_OP"}),
    (["--fsdp_sharding_strategy", "NO_SHARD"], 0,
     {"ACCELERATE_TORCH_FSDP_SHARDING_STRATEGY": "NO_SHARD"}),
    (["--zero_stage", "3"], 2, STEP_2B),
    (["--fsdp_sharding_strategy", "FULL_SHARD"], 2, STEP_2B),
    (["--fsdp_sharding_strategy", "HYBRID_SHARD"], 2, STEP_2B),
    (["--mesh_shape", "fsdp=2"], 2, STEP_2B),
    (["--zero_stage", "2", "--mesh_shape", "fsdp=2,model=2"], 2, STEP_2C)],
    ids=["zero2", "zero1_mesh", "zero0", "shard_grad_op", "no_shard",
         "zero3", "full_shard", "hybrid_shard", "bare_fsdp", "model"])
def test_launcher_zero_flags(flags, code, env, capsys):
    """The launcher's ZeRO flags: stages 0-2, `SHARD_GRAD_OP` and
    `NO_SHARD` (with an `fsdp` mesh) reach the children's variables;
    parameter sharding and the `model` axis exit 2, naming their step."""
    from accelerate_tpu_torch.commands import launch as tlaunch
    from accelerate_tpu_torch.utils.launch import prepare_launch_env

    if code == 2:
        assert tlaunch.main([*flags, "never_run.py"]) == 2
        assert env in capsys.readouterr().err
        return
    parser = argparse.ArgumentParser()
    tlaunch.add_launch_arguments(parser)
    args = parser.parse_args([*flags, "script.py"])
    tlaunch.check_supported(args)
    got = {k: v for k, v in prepare_launch_env(args).items()
           if "ZERO" in k or "FSDP" in k or "MESH" in k}
    assert got == env


def test_launched_checkpoint_script_resumes_bitwise_under_zero2():
    """The bundled `external_deps/test_checkpointing.py` launched as two
    CPU processes with `--zero_stage 2`: its save/resume checks, bitwise,
    pass with the moments as blocks."""
    out = execute_subprocess(launch_command_for(
        bundled_script_path("external_deps/test_checkpointing.py"), 2,
        ["--cpu", "--zero_stage", "2"]), timeout=240)
    assert "ALL CHECKS PASSED (2 process(es))" in out
    assert "moments as blocks" in out
