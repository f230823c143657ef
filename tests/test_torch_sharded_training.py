"""The port's Accelerator training on `seq`, `expert` and `stage` meshes
against the JAX package's Accelerator on the same mesh sizes, at tiny
widths, on the same numpy weights and batches.

One 4-rank `debug_launcher` world on the CPU (gloo) runs every port
case (`test_utils.worlds.sharded_training_forms`): each builds its
Accelerator over the world, `{data: 2, seq: 2}`, `{data: 2, expert: 2}`
or `{data: 2, stage: 2}`, prepares a `TrainState` and a loader
(`split_batches=True`, so the global batch is the source's batch, as
the reference's one-process loader hands it out), and trains. A rank's
loader takes its batch line's share (the ranks over `data`), and the
gradients average over that line alone.

The JAX side runs in the pytest process on the conftest's 8 CPU
devices, with the same `seq`, `expert` or `stage` size and `data`
filling the rest (4): the reference example's loop
(`examples/by_feature/long_context_ring_attention.py`) for the ring and
Ulysses, `tests/test_models.py`'s expert-parallel and a2a Mixtral steps,
`tests/test_quant_fp8.py`'s fp8 a2a step (the a2a routes at a capacity
that drops nothing, see `MOE_CONFIGS`), and `pipeline_value_and_grad`
with `optax.adamw` for the stage blocks. Every global batch holds 8
rows, so no loader pads. Two cases hold the port to the reference's
global batch where its ranks see different rows: a padded batch whose
batch lines hold different counts of real tokens (the loss is the
global masked sum over the global count), and the a2a dispatch at a
capacity that drops tokens (it runs on the global batch's tokens, so
it drops the reference's).

Tolerances (f32 on both sides, the products in another order): losses
rtol 1e-5, params after three AdamW steps atol 2e-5 (about 0.02 of an
update of lr 1e-3), pre-clip norms rtol 1e-5; the fp8 a2a losses rtol
2e-3 (both sides quantise to E4M3/E5M2 and a few elements round to the
neighbouring code); one MoE block's outputs atol 1e-5.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from accelerate_tpu import TrainState as JTrainState
from accelerate_tpu.accelerator import Accelerator as JAccelerator
from accelerate_tpu.models import llama as jl
from accelerate_tpu.models import mixtral as jm
from accelerate_tpu.parallel import moe as jmoe
from accelerate_tpu.parallel import pipeline as jpp
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu.utils import ContextParallelPlugin, MeshConfig
from accelerate_tpu_torch.test_utils import run_world
from accelerate_tpu_torch.test_utils.worlds import sharded_training_forms

WORLD = 4
WORLD_TIMEOUT_S = 240
LR = 1e-3
STEPS = 3
LOSS_RTOL, PARAM_ATOL, NORM_RTOL = 1e-5, 2e-5, 1e-5
FP8_LOSS_RTOL = 2e-3
BLOCK_ATOL = 1e-5
COPY_STEPS = 2

LLAMA_IDS = np.random.default_rng(0).integers(0, 256, (8, 33)).astype(
    np.int32)
MOE_IDS = np.random.default_rng(1).integers(0, 256, (8, 17)).astype(
    np.int32)
FP8_IDS = np.random.default_rng(5).integers(0, 256, (8, 33)).astype(
    np.int32)
FP8_MOE = {"num_local_experts": 8}
# the a2a routes at a capacity that drops nothing (E / k): the
# reference's dispatch groups its sources over the whole global batch,
# the port's over each batch line, and only an undropped dispatch is the
# same function of the batch in both
MOE_CONFIGS = {"dense": {}, "sparse": {}, "a2a": {"capacity_factor": 2.0},
               "fp8_a2a": dict(FP8_MOE, capacity_factor=4.0)}
# the a2a dispatch at a capacity that drops tokens on both sides, on the
# global batch and on each half (at the default 1.25 the global batch
# drops nothing here)
DROP_CONFIG = {"capacity_factor": 1.0}
# a padded global batch: the first batch line's rows are all real, the
# second line's rows end in 12, 20, 5 and 0 pads
PAD_IDS = np.random.default_rng(9).integers(0, 256, (8, 33)).astype(
    np.int32)
PAD_MASK = np.ones((8, 33), np.int32)
for _row, _pads in zip(range(4, 8), (12, 20, 5, 0)):
    PAD_MASK[_row, 33 - _pads:] = 0
DROP_X = np.random.default_rng(8).standard_normal((8, 17, 64)).astype(
    np.float32)
H = 16
MLP = {"w": np.random.default_rng(2).standard_normal((H, H)).astype(
    np.float32) * 0.3, "b": np.zeros(H, np.float32)}
STAGED = {"w": np.random.default_rng(3).standard_normal(
    (2, 1, H, H)).astype(np.float32) * 0.3,
    "b": np.random.default_rng(4).standard_normal((2, 1, H)).astype(
        np.float32) * 0.1}
X = np.random.default_rng(6).standard_normal((8, H)).astype(np.float32)
T = np.random.default_rng(7).standard_normal((8, H)).astype(np.float32)
LOADER_BATCHES = [np.arange(4 * i, 4 * i + 4)[:, None] for i in range(3)]


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    return {
        "llama": _numpy(jl.init_params(jl.LlamaConfig.tiny(),
                                       jax.random.key(0))),
        "moe": _numpy(jm.init_params(jm.MixtralConfig.tiny(),
                                     jax.random.key(0))),
        "fp8": _numpy(jm.init_params(jm.MixtralConfig.tiny(**FP8_MOE),
                                     jax.random.key(5))),
    }


def _cases(weights):
    moe = dict(kind="moe", axes={"data": 2, "expert": 2}, ids=MOE_IDS,
               params=weights["moe"], steps=STEPS, lr=LR,
               mixed_precision="no")
    return [
        *[dict(name=m, kind="cp", mode=m, seq_degree=2, config={},
               params=weights["llama"], ids=LLAMA_IDS, steps=STEPS, lr=LR)
          for m in ("ring", "ulysses")],
        *[dict(moe, name=impl, impl=impl, config=MOE_CONFIGS[impl])
          for impl in ("dense", "sparse", "a2a")],
        dict(moe, name="fp8_a2a", impl="a2a", mixed_precision="fp8",
             params=weights["fp8"], config=MOE_CONFIGS["fp8_a2a"],
             ids=FP8_IDS),
        dict(moe, name="copies", kind="moe_copies", steps=COPY_STEPS),
        dict(name="a2a_drop", kind="moe_drop", axes={"data": 2, "expert": 2},
             params=weights["moe"], config=DROP_CONFIG, x=DROP_X),
        dict(name="padded", kind="padded", axes={"data": 2, "stage": 2},
             params=weights["llama"], ids=PAD_IDS, mask=PAD_MASK,
             steps=STEPS, lr=LR),
        dict(name="stage", kind="stage", axes={"data": 2, "stage": 2},
             mlp=MLP, staged=STAGED, x=X, t=T, micro=4, steps=STEPS,
             lr=LR),
        dict(name="loader", kind="loader", seq_degree=2,
             batches=LOADER_BATCHES),
    ]


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    ranks = run_world(sharded_training_forms, WORLD, (_cases(weights),),
                      out_dir=str(tmp_path_factory.mktemp("sharded")),
                      timeout_s=WORLD_TIMEOUT_S)
    return {name: [r[name] for r in ranks] for name in ranks[0]
            if name != "log"}


# -- the JAX side ----------------------------------------------------------------


def _jax_accelerator(**kwargs):
    JPartialState._reset_state()
    return JAccelerator(gradient_clipping=1.0, **kwargs)


def _jax_steps(acc, state, loader, loss_fn):
    step = acc.train_step(loss_fn)
    losses = []
    for _ in range(STEPS):
        for batch in loader:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return state, losses


@pytest.fixture(scope="module")
def jax_cp(weights):
    """The reference example's loop in both modes."""
    out = {}
    try:
        for mode in ("ring", "ulysses"):
            acc = _jax_accelerator(context_parallel_plugin=(
                ContextParallelPlugin(mode=mode, seq_degree=2)))
            cfg = jl.LlamaConfig.tiny(attention_backend=mode)
            state = acc.prepare(JTrainState.create(
                apply_fn=None, params=_j(weights["llama"]),
                tx=optax.adamw(LR)))
            loader = acc.prepare([{"input_ids": LLAMA_IDS}])
            state, losses = _jax_steps(
                acc, state, loader,
                lambda p, b, cfg=cfg: jl.causal_lm_loss(cfg, p, b))
            out[mode] = {"mesh": dict(acc.mesh.shape), "losses": losses,
                         "params": _numpy(state.params)}
    finally:
        JPartialState._reset_state()
    return out


@pytest.fixture(scope="module")
def jax_moe(weights):
    """The expert-parallel steps on `{data: 4, expert: 2}`, and the
    pre-clip norm of the global batch's gradient."""
    out = {}
    try:
        for name, impl, mp in (("dense", "dense", "no"),
                               ("a2a", "a2a", "no"),
                               ("fp8_a2a", "a2a", "fp8")):
            fp8 = mp == "fp8"
            acc = _jax_accelerator(
                mixed_precision=mp,
                mesh_config=MeshConfig(axes={"data": 4, "expert": 2}))
            cfg = jm.MixtralConfig.tiny(**MOE_CONFIGS[name], moe_impl=impl)
            params = weights["fp8" if fp8 else "moe"]
            ids = FP8_IDS if fp8 else MOE_IDS
            state = acc.prepare(JTrainState.create(
                apply_fn=None, params=_j(params), tx=optax.adamw(LR),
                fp8_state=jm.init_fp8_state(cfg) if fp8 else None))
            spec = state.params["layers"]["moe"]["experts"]["gate_proj"][
                "kernel"].sharding.spec
            if fp8:
                def loss_fn(p, b, fp8_state=None, cfg=cfg):
                    return jm.causal_lm_loss(cfg, p, b, fp8_state=fp8_state)
            else:
                def loss_fn(p, b, cfg=cfg):
                    return jm.causal_lm_loss(cfg, p, b)
            norm = None
            if not fp8:
                _, grads = acc.compute_gradients(
                    loss_fn, acc.prepare(_j(params)), {"input_ids": ids})
                norm = float(optax.global_norm(grads))
            loader = acc.prepare([{"input_ids": ids}])
            state, losses = _jax_steps(acc, state, loader, loss_fn)
            out[name] = {"spec": tuple(spec), "losses": losses,
                         "params": _numpy(state.params), "norm": norm}
    finally:
        JPartialState._reset_state()
    return out


@pytest.fixture(scope="module")
def jax_moe_copies(weights):
    """The dense expert-parallel steps on `{data: 4, expert: 2}`, with
    the pre-clip norm of the global batch's gradient before each step
    and at the final params."""
    try:
        acc = _jax_accelerator(
            mesh_config=MeshConfig(axes={"data": 4, "expert": 2}))
        cfg = jm.MixtralConfig.tiny(moe_impl="dense")

        def loss_fn(p, b):
            return jm.causal_lm_loss(cfg, p, b)

        state = acc.prepare(JTrainState.create(
            apply_fn=None, params=_j(weights["moe"]), tx=optax.adamw(LR)))
        batch = {"input_ids": MOE_IDS}
        step = acc.train_step(loss_fn)
        norms, losses = [], []
        for _ in range(COPY_STEPS + 1):
            _, grads = acc.compute_gradients(loss_fn, state.params, batch)
            norms.append(float(optax.global_norm(grads)))
            if len(losses) < COPY_STEPS:
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
        return {"losses": losses, "norms": norms,
                "params": _numpy(state.params)}
    finally:
        JPartialState._reset_state()


@pytest.fixture(scope="module")
def jax_padded(weights):
    """llama's fused step on `{data: 4, stage: 2}` over the padded global
    batch: each step's loss, the pre-clip norm of the global batch's
    gradient before it, and the params."""
    try:
        acc = _jax_accelerator(mesh_config=MeshConfig(
            axes={"data": 4, "stage": 2}))
        cfg = jl.LlamaConfig.tiny()

        def loss_fn(p, b):
            return jl.causal_lm_loss(cfg, p, b)

        state = acc.prepare(JTrainState.create(
            apply_fn=None, params=_j(weights["llama"]), tx=optax.adamw(LR)))
        (batch,) = list(acc.prepare([{"input_ids": PAD_IDS,
                                      "attention_mask": PAD_MASK}]))
        step = acc.train_step(loss_fn)
        out = {"losses": [], "norms": []}
        for _ in range(STEPS):
            _, grads = acc.compute_gradients(loss_fn, state.params, batch)
            out["norms"].append(float(optax.global_norm(grads)))
            state, m = step(state, batch)
            out["losses"].append(float(m["loss"]))
        out["params"] = _numpy(state.params)
        return out
    finally:
        JPartialState._reset_state()


@pytest.fixture(scope="module")
def jax_moe_drop(weights):
    """Layer 0's a2a MoE block on `{data: 4, expert: 2}` at the dropping
    capacity on the whole of `DROP_X`, with its dispatch's dropped
    fraction."""
    out, dropped = {}, []
    dispatch = jmoe.expert_parallel_moe_a2a

    def with_stats(*a, **kw):
        y, stats = dispatch(*a, return_stats=True, **kw)
        dropped.append(float(stats["moe_dropped_fraction"]))
        return y

    try:
        _jax_accelerator(
            mesh_config=MeshConfig(axes={"data": 4, "expert": 2}))
        cfg = jm.MixtralConfig.tiny(**DROP_CONFIG, moe_impl="a2a")
        moe = jax.tree_util.tree_map(lambda p: jnp.asarray(p[0]),
                                     weights["moe"]["layers"]["moe"])
        with mock.patch.object(jmoe, "expert_parallel_moe_a2a",
                               with_stats):
            for name, x in (("whole", DROP_X),):
                y, aux, _ = jm.moe_block(cfg, moe, jnp.asarray(x))
                out[name] = {"out": np.asarray(y), "aux": float(aux),
                             "dropped": dropped.pop()}
    finally:
        JPartialState._reset_state()
    return out


def _j_mse(y, t):
    return jnp.mean((y - t) ** 2)


def _j_tanh_wb(p, x):
    return jnp.tanh(x @ p["w"][0] + p["b"][0])


@pytest.fixture(scope="module")
def jax_stage():
    """`{data: 4, stage: 2}`: the MLP's `train_step` with `stage` as a
    replica axis; then `pipeline_value_and_grad` on the whole batch, the
    reference's clip and `optax.adamw`."""
    try:
        acc = _jax_accelerator(mesh_config=MeshConfig(
            axes={"data": 4, "stage": 2}))
        state = acc.prepare(JTrainState.create(
            apply_fn=None, params=_j(MLP), tx=optax.adamw(LR)))
        loader = acc.prepare([{"x": X, "t": T}])
        state, losses = _jax_steps(
            acc, state, loader,
            lambda p, b: _j_mse(jnp.tanh(b["x"] @ p["w"] + p["b"]), b["t"]))
        out = {"losses": losses, "params": _numpy(state.params)}
        tx = optax.adamw(LR)
        params = _j(STAGED)
        opt_state = tx.init(params)
        out["pipe_losses"], out["pipe_norms"] = [], []
        for _ in range(STEPS):
            loss, grads = jpp.pipeline_value_and_grad(
                _j_tanh_wb, _j_mse, params, jnp.asarray(X), jnp.asarray(T),
                4, mesh=acc.mesh)
            norm = optax.global_norm(grads)
            factor = jnp.minimum(1.0, 1.0 / (norm + 1e-6))
            grads = jax.tree_util.tree_map(lambda g: g * factor, grads)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            out["pipe_losses"].append(float(loss))
            out["pipe_norms"].append(float(norm))
        out["pipe_params"] = _numpy(params)
    finally:
        JPartialState._reset_state()
    return out


# -- checks ------------------------------------------------------------------------


def _same_losses(ranks):
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]


def _close_params(got, want):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_allclose(leaf, flat_want[path], rtol=0,
                                   atol=PARAM_ATOL, err_msg=str(path))


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_context_parallel_training_matches_jax(world, jax_cp, mode):
    """The long-context example on `{data: 2, seq: 2}` (the plugin's
    `seq` of 2, `data` filling the rest): every rank reports the global
    batch's loss, and the losses and final params equal the JAX
    Accelerator's on `{data: 4, seq: 2}`."""
    ranks = world[mode]
    assert jax_cp[mode]["mesh"] == {"data": 4, "seq": 2}
    for r in ranks:
        assert r["mesh"] == {"data": 2, "seq": 2}
    _same_losses(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], jax_cp[mode]["losses"],
                               rtol=LOSS_RTOL)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    for r in ranks:
        _close_params(r["params"], jax_cp[mode]["params"])


def test_seq_line_ranks_see_the_same_rows(world):
    """Each rank of a `seq` line trains on the same rows, the two batch
    lines on the two halves of the global batch (the loader shards over
    `data` alone)."""
    for mode in ("ring", "ulysses"):
        ranks = world[mode]
        lines = {}
        for r in ranks:
            size, index = r["line"]
            assert size == 2
            lines.setdefault(index, []).append(r["rows"])
        assert sorted(lines) == [0, 1]
        for index, seen in lines.items():
            assert len(seen) == 2
            for a, b in zip(*seen):
                np.testing.assert_array_equal(a["input_ids"],
                                              b["input_ids"])
            for rows in seen[0]:
                np.testing.assert_array_equal(
                    rows["input_ids"], LLAMA_IDS[4 * index:4 * index + 4])


@pytest.mark.parametrize("impl", ["dense", "a2a"])
def test_mixtral_expert_blocks_train_like_jax(world, jax_moe, impl):
    """`{data: 2, expert: 2}`: each rank holds the experts and their
    moments as its [L, E/2, ...] block, as the reference's plan places
    them on `expert`; the losses, the params gathered whole and the
    eager path's pre-clip norm (each block's squares counted once
    across the `expert` line) equal the JAX Accelerator's on `{data: 4,
    expert: 2}`."""
    ranks, want = world[impl], jax_moe[impl]
    assert want["spec"][1] == "expert"
    L, E = 2, 4
    for r in ranks:
        assert r["mesh"] == {"data": 2, "expert": 2}
        assert r["expert_shapes"] == {"gate_proj": (L, E // 2, 64, 128),
                                      "up_proj": (L, E // 2, 64, 128),
                                      "down_proj": (L, E // 2, 128, 64)}
        assert r["moment_shapes"] == {"mu": (L, E // 2, 64, 128),
                                      "nu": (L, E // 2, 64, 128)}
        _close_params(r["params"], want["params"])
        np.testing.assert_allclose(r["pre_clip_norm"], want["norm"],
                                   rtol=NORM_RTOL)
        np.testing.assert_allclose(r["eager_loss"], want["losses"][0],
                                   rtol=LOSS_RTOL)
    _same_losses(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_mixtral_block_routes_equal_one_process(world, impl):
    """The dense and sparse routes gather a layer's blocks over the
    `expert` line before they run, so the loss on blocks is exactly the
    loss on the whole experts; both ranks of an `expert` line then train
    alike."""
    for r in world[impl]:
        assert r["loss_blocks"] == r["loss_whole"]
        assert all(np.isfinite(r["losses"]))
    _same_losses(world[impl])


def test_mixtral_fp8_a2a_trains_like_jax(world, jax_moe):
    """The fp8 a2a step (per-expert E5M2 scales, the delayed scales on
    `expert_aux`) with the experts as blocks, three steps against the
    JAX Accelerator's."""
    ranks, want = world["fp8_a2a"], jax_moe["fp8_a2a"]
    for r in ranks:
        assert r["expert_shapes"]["gate_proj"] == (2, 4, 64, 128)
    _same_losses(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"],
                               rtol=FP8_LOSS_RTOL)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


def test_stage_replica_axis_trains_like_jax(world, jax_stage):
    """`train_step` on `{data: 2, stage: 2}` with nothing staged: the two
    ranks of a `stage` line see the same rows and make the same update,
    equal to the JAX Accelerator's on `{data: 4, stage: 2}`."""
    ranks = world["stage"]
    _same_losses(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], jax_stage["losses"],
                               rtol=LOSS_RTOL)
    for r in ranks:
        assert r["mesh"] == {"data": 2, "stage": 2}
        _close_params(r["params"], jax_stage["params"])


def test_pipeline_block_grads_through_backward(world, jax_stage):
    """`pipeline_value_and_grad`'s block gradients through `backward`,
    `clip_grad_norm_` (a stage block's squares counted once across the
    `stage` line) and an optimizer prepared over `stage_block`: the
    losses, norms and each rank's block equal the JAX schedule's with
    the reference's clip and `optax.adamw`."""
    for r in world["stage"]:
        np.testing.assert_allclose(r["pipe_losses"],
                                   jax_stage["pipe_losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["pipe_norms"], jax_stage["pipe_norms"],
                                   rtol=NORM_RTOL)
        d = r["stage_index"]
        for k in ("w", "b"):
            np.testing.assert_allclose(
                r["pipe_params"][k], jax_stage["pipe_params"][k][d:d + 1],
                rtol=0, atol=PARAM_ATOL)


def test_gather_for_metrics_returns_each_sample_once(world):
    """Three batches of four on `{data: 2, seq: 2}`: the ranks of a `seq`
    line see the same batches, and `gather_for_metrics` over the batch
    line returns every sample once, the recycled tail dropped."""
    ranks = world["loader"]
    want = np.arange(12)[:, None]
    for r in ranks:
        assert r["line"][0] == 2
        np.testing.assert_array_equal(np.concatenate(r["gathered"]), want)
    by_line = {}
    for r in ranks:
        by_line.setdefault(r["line"][1], []).append(r["seen"])
    for seen in by_line.values():
        for a, b in zip(*seen):
            np.testing.assert_array_equal(a, b)


def test_copied_expert_blocks_clip_like_jax(world, jax_moe_copies):
    """`train_step(donate=False)` on `{data: 2, expert: 2}`: each step
    returns new tensors and takes the last one's copy, and the clip of
    every step still counts each block's squares once across the
    `expert` line, so the pre-clip norms, losses and params equal the
    JAX Accelerator's; the eager norm at a copy of the params, through
    an optimizer prepared without params, too."""
    ranks, want = world["copies"], jax_moe_copies
    for r in ranks:
        assert r["copied"] == [True] * COPY_STEPS and r["no_params"]
        np.testing.assert_allclose(r["step_norms"],
                                   want["norms"][:COPY_STEPS],
                                   rtol=NORM_RTOL)
        np.testing.assert_allclose(r["pre_clip_norm"], want["norms"][-1],
                                   rtol=NORM_RTOL)
        _close_params(r["params"], want["params"])
    _same_losses(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"],
                               rtol=LOSS_RTOL)


def test_a2a_dropping_capacity_matches_jax_on_the_global_batch(
        world, jax_moe_drop):
    """At a capacity that drops tokens, each batch line's a2a block output
    (its rows of the global batch) and the dropped fraction equal the
    reference's on the global batch: the port gathers the line's tokens
    and dispatches the global batch over `expert`, as the reference's
    `shard_map` does; the load-balancing loss is the global batch's."""
    want = jax_moe_drop["whole"]
    assert want["dropped"] > 0
    for r in world["a2a_drop"]:
        size, index = r["line"]
        assert size == 2 and r["expert_shape"] == (2, 64, 128)
        np.testing.assert_allclose(
            r["out"], want["out"][4 * index:4 * index + 4], rtol=0,
            atol=BLOCK_ATOL)
        np.testing.assert_allclose(r["dropped"], [want["dropped"]],
                                   rtol=1e-6)
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=LOSS_RTOL)


def test_padded_batch_loss_is_the_global_mean_like_jax(world, jax_padded):
    """A padded batch on `{data: 2, stage: 2}` whose batch lines hold 132
    and 95 real tokens (128 and 91 counted labels): each rank divides its masked sum by the line's
    count over the line's size, so the losses, each step's pre-clip norm
    and the params equal the JAX Accelerator's on the global batch
    (`{data: 4, stage: 2}`), the global masked sum over the global
    count."""
    ranks = world["padded"]
    assert sorted({r["real_tokens"] for r in ranks}) == [95, 132]
    _same_losses(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], jax_padded["losses"],
                               rtol=LOSS_RTOL)
    for r in ranks:
        np.testing.assert_allclose(r["norms"], jax_padded["norms"],
                                   rtol=NORM_RTOL)
        _close_params(r["params"], jax_padded["params"])


@pytest.mark.parametrize("call", ["save_state", "get_state_dict",
                                  "optimizer_save"])
def test_checkpoints_of_blocks_refused(world, weights, call):
    """A state or an optimizer that holds expert blocks saves and loads:
    every rank gathers its blocks whole
    into the one-process format, and a reload cuts each rank's block
    back out bit for bit, for a copy of a state after
    `train_step(donate=False)` too; `get_state_dict` gives the whole
    params; the dense case's checkpoint loads in one process, its
    experts whole; the `stage` mesh's state, which holds no block, saves
    as before."""
    for r in world["dense"] + (world["copies"] if call != "optimizer_save"
                               else []):
        assert r[call] is True, r[call]
    for r in world["stage"]:
        assert r["save_state"] is None
    if call != "save_state":
        return
    from accelerate_tpu_torch import optimizers
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.convert import params_from_numpy
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState

    PartialState._reset_state()
    try:
        acc = Accelerator(cpu=True)
        state = acc.prepare(TrainState.create(
            apply_fn=None,
            params=params_from_numpy(weights["moe"], device="cpu"),
            tx=optimizers.adamw(LR)))
        acc.load_state(world["dense"][0]["saved"], state=state)
    finally:
        PartialState._reset_state()
    got = jax.tree_util.tree_map(lambda t: t.numpy(), state.params)
    _close_params(got, world["dense"][0]["params"])
    experts = got["layers"]["moe"]["experts"]["gate_proj"]["kernel"]
    assert experts.shape == (2, 4, 64, 128)
