"""The port's pipeline schedules (`accelerate_tpu_torch.parallel.pipeline`)
against the JAX package's (`accelerate_tpu.parallel.pipeline`), on the
same numpy inputs from seeds.

One 4-rank `debug_launcher` world on the CPU (gloo) holds every
multi-rank check (`test_utils.worlds.pipeline_forms`): the counterparts
of the reference's pipeline tests (`tests/test_parallel.py`) on a
`stage` axis of 4, one process a stage: GPipe forward and its gradient,
validation, 1F1B at M in {2, 4, 8}, 1F1B against GPipe, llama layers
through 1F1B, the interleaved forward and `value_and_grad`, interleaved
1F1B with 2 and 3 chunks, the 1F1B saved-input bound; and
`prepare_pipeline` on a stage axis of 4, `prepare_sharded_inference`
on `model` x `fsdp`, an Accelerator on a `data` x `stage` mesh.

The JAX side runs in the pytest process on its 8 CPU devices: the JAX
package's own schedules (`pipeline_apply` with its gradient, 1F1B,
interleaved 1F1B with 2 and 3 chunks) where named, elsewhere the
reference tests' sequential functions on the JAX package's models.

Tolerances (f32 on both sides, products in another order): outputs and
losses atol 1e-5 (rtol 1e-5 for losses), gradients atol 1e-5, 1e-4
through the interleaved schedules and the gradient of sum(y**2), 2e-5
through llama layers: the reference tests' own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from accelerate_tpu.inference import make_stage_fn as j_make_stage_fn
from accelerate_tpu.models import llama as jl
from accelerate_tpu.models.common import rope_frequencies as j_rope
from accelerate_tpu.parallel import pipeline as jpp
from accelerate_tpu.utils import MeshConfig
from accelerate_tpu_torch.parallel import pipeline as tpp
from accelerate_tpu_torch.test_utils import run_world
from accelerate_tpu_torch.test_utils.worlds import pipeline_forms

S = 4
WORLD_TIMEOUT_S = 240


def jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return MeshConfig(axes=dict(axes)).build(devices=jax.devices()[:n])


def _normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _staged(tree, n=S):
    return jax.tree_util.tree_map(
        lambda v: v.reshape((n, -1) + v.shape[1:]), tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# -- inputs ----------------------------------------------------------------------

H = 16
MLP_LAYERS = {"w": _normal(0, (S, H, H), 0.3), "b": _normal(1, (S, H), 0.1)}
MLP_X = _normal(2, (16, H))
MLP_T = _normal(3, (16, H))
FEW_X, FEW_T = _normal(4, (4, H)), _normal(5, (4, H))
GRAD_LAYERS = {"w": _normal(6, (S, 8, 8), 0.3)}
GRAD_X = _normal(7, (8, 8))
RES_LAYERS = {"w": _normal(8, (16, H, H), 0.3)}    # 16 = V*S*2
RES_X = _normal(9, (12, H))
IL_LAYERS = {"w": _normal(10, (8, H, H), 0.3)}
IL_X, IL_T = _normal(11, (8, H)), _normal(12, (8, H))
IL1_X, IL1_T = _normal(13, (24, H)), _normal(14, (24, H))
V3_LAYERS = {"w": _normal(15, (S * 3, 8, 8), 0.3)}
V3_X, V3_T = _normal(16, (8, 8)), _normal(17, (8, 8))
INF_LAYERS = {"w": _normal(18, (8, H, H), 0.3), "b": _normal(19, (8, H), 0.1)}
INF_X = _normal(20, (8, H))
LLAMA = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
             num_hidden_layers=4, num_attention_heads=2,
             num_key_value_heads=2, max_position_embeddings=16,
             attention_backend="einsum")
LLAMA_X = _normal(21, (8, 16, 32))
LLAMA_T = _normal(22, (8, 16, 32))
D = 32
SHARD_PARAMS = {"layers": {"mlp": {
    "up_proj": {"kernel": _normal(23, (4, D, D * 4), 0.1)},
    "down_proj": {"kernel": _normal(24, (4, D * 4, D), 0.1)}}}}
SHARD_X = _normal(25, (4, D))
ACC_LAYERS = {"w": _normal(26, (4, 8, 8), 0.3), "b": _normal(27, (4, 8), 0.1)}
ACC_X = _normal(28, (8, 8))


@pytest.fixture(scope="module")
def llama_layers():
    cfg = jl.LlamaConfig(**LLAMA)
    params = jl.init_params(cfg, jax.random.key(0))
    return cfg, jax.tree_util.tree_map(np.asarray, params["layers"])


def _cases(llama_layers):
    _, layers = llama_layers
    vg = dict(kind="value_and_grad", stage_fn="tanh_wb",
              params=_staged(MLP_LAYERS), x=MLP_X, targets=MLP_T)
    return [
        dict(name="apply", kind="apply", stage_fn="tanh_wb",
             params=_staged(MLP_LAYERS), x=MLP_X[:8], micro=[4, 2]),
        dict(name="apply_grad", kind="apply", stage_fn="tanh_w",
             params=_staged(GRAD_LAYERS), x=GRAD_X, micro=[4], grad=True),
        dict(name="errors", kind="errors"),
        dict(vg, name="1f1b", micro=[4, 8], schedules=["1f1b", "gpipe"]),
        dict(vg, name="few", x=FEW_X, targets=FEW_T, micro=[2],
             schedules=["1f1b"]),
        dict(name="llama", kind="value_and_grad", stage_fn="llama",
             config=LLAMA, params=_staged(layers), x=LLAMA_X,
             targets=LLAMA_T, micro=[4], schedules=["1f1b"]),
        dict(name="il_forward", kind="apply", stage_fn="residual_mlp",
             params=jpp_virtual(RES_LAYERS, 2), x=RES_X, micro=[4, 6, 12],
             virtual_stages=2),
        dict(name="il_vg", kind="value_and_grad", stage_fn="residual_mlp",
             params=jpp_virtual(IL_LAYERS, 2), x=IL_X, targets=IL_T,
             micro=[4], schedules=["interleaved", "1f1b"], virtual_stages=2),
        dict(name="il_vg_1f1b_ref", kind="value_and_grad",
             stage_fn="residual_mlp", params=_staged(IL_LAYERS), x=IL_X,
             targets=IL_T, micro=[4], schedules=["1f1b"]),
        dict(name="il_1f1b", kind="value_and_grad", stage_fn="residual_mlp",
             params=jpp_virtual(IL_LAYERS, 2), x=IL1_X, targets=IL1_T,
             micro=[6, 8], schedules=["1f1b", "interleaved"],
             virtual_stages=2),
        dict(name="v3", kind="value_and_grad", stage_fn="residual_mlp",
             params=jpp_virtual(V3_LAYERS, 3), x=V3_X, targets=V3_T,
             micro=[4], schedules=["1f1b"], virtual_stages=3),
        dict(name="prepare", kind="prepare", layer_fn="tanh_affine",
             params=INF_LAYERS, x=INF_X, chunks=[None, 2, 8]),
        dict(name="sharded", kind="sharded", forward="mlp_scan",
             mesh={"model": 2, "fsdp": 2}, params=SHARD_PARAMS, x=SHARD_X),
        dict(name="accelerator", kind="accelerator",
             axes={"data": 2, "stage": 2}, params=ACC_LAYERS, x=ACC_X,
             refused_axes=[{"data": 2, "model": 2}, {"fsdp": 4},
                           {"stage": 2, "model": 2},
                           {"expert": 2, "fsdp": 2}]),
    ]


def jpp_virtual(layers, V):
    return jax.tree_util.tree_map(
        lambda v: v.reshape((V, S, -1) + v.shape[1:]), layers)


@pytest.fixture(scope="module")
def world(llama_layers):
    ranks = run_world(pipeline_forms, 4, (_cases(llama_layers),),
                      timeout_s=WORLD_TIMEOUT_S)
    return {name: [r[name] for r in ranks] for name in ranks[0]
            if name != "log"}


def _blocks(ranks, key_path, V=1):
    """Every rank's block of a gradient tree, concatenated over the
    stage dim (rank r is stage r on the `stage` axis of 4)."""
    parts = []
    for r in ranks:
        g = r
        for k in key_path:
            g = g[k]
        parts.append(g)
    return np.concatenate(parts, axis=1 if V > 1 else 0)


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])


# -- the JAX side -------------------------------------------------------------------


def _j_tanh_wb(p, x):
    return jnp.tanh(x @ p["w"][0] + p["b"][0])


def _j_mse(y, t):
    return jnp.mean((y - t) ** 2)


def _j_residual(params, x):
    def body(carry, layer):
        return carry + jnp.tanh(carry @ layer["w"]) * 0.5, None

    y, _ = jax.lax.scan(body, x, params)
    return y


def _j_mlp_ref(layers, x, targets, M):
    """The reference tests' `_pipeline_ref`: mean over micro-batches of
    the per-micro MSE of the sequential tanh layers."""
    mb = x.shape[0] // M

    def total(params):
        losses = []
        for m in range(M):
            y = x[m * mb:(m + 1) * mb]
            for i in range(params["w"].shape[0]):
                y = jnp.tanh(y @ params["w"][i] + params["b"][i])
            losses.append(_j_mse(y, targets[m * mb:(m + 1) * mb]))
        return jnp.mean(jnp.stack(losses))

    return jax.value_and_grad(total)(_j(layers))


def _j_residual_ref(layers, x, tgt, M):
    def loss(layers):
        ym = _j_residual(layers, x)
        per = jax.vmap(_j_mse)(ym.reshape((M, -1) + ym.shape[1:]),
                               tgt.reshape((M, -1) + tgt.shape[1:]))
        return jnp.mean(per)

    return jax.value_and_grad(loss)(_j(layers))


# -- stacking (one process) ----------------------------------------------------------


def test_stack_layers_into_stages():
    import torch

    params = {"w": torch.arange(8.0).reshape(8, 1)}
    staged = tpp.stack_layers_into_stages(params, 4)
    want = jpp.stack_layers_into_stages({"w": jnp.arange(8.0).reshape(8, 1)},
                                        4)
    assert staged["w"].shape == (4, 2, 1)
    np.testing.assert_array_equal(staged["w"].numpy(), np.asarray(want["w"]))
    virt = tpp.stack_layers_into_virtual_stages(
        {"w": torch.arange(24.0).reshape(12, 2)}, 2, 3)
    jvirt = jpp.stack_layers_into_virtual_stages(
        {"w": jnp.arange(24.0).reshape(12, 2)}, 2, 3)
    np.testing.assert_array_equal(virt["w"].numpy(), np.asarray(jvirt["w"]))
    with pytest.raises(ValueError, match="not divisible"):
        tpp.stack_layers_into_stages({"w": torch.zeros((6, 1))}, 4)
    with pytest.raises(ValueError, match="virtual chunks"):
        tpp.stack_layers_into_virtual_stages({"w": torch.zeros((6, 1))}, 2, 2)


# -- GPipe -----------------------------------------------------------------------------


def test_pipeline_apply_matches_jax_pipeline(world):
    """4-stage MLP pipeline (the whole stacked tree on every rank) ==
    the JAX package's `pipeline_apply`, at 4 and 2 micro-batches, on
    every rank."""
    x = MLP_X[:8]
    want = np.asarray(jpp.pipeline_apply(
        _j_tanh_wb, _j(_staged(MLP_LAYERS)), jnp.asarray(x), 4,
        mesh=jmesh({"stage": 4, "data": 2})))
    for M in (4, 2):
        _same_on_every_rank(world["apply"], f"y_{M}")
        np.testing.assert_allclose(world["apply"][0][f"y_{M}"], want,
                                   atol=1e-5)


def test_pipeline_apply_gradient_scale_matches_jax(world):
    """The gradient of sum(y**2) through the final broadcast: each
    rank's block and x's gradient equal the JAX package's gradient of
    its `pipeline_apply` (not S times it: only the last stage's output
    cotangent is read)."""
    mesh = jmesh({"stage": 4, "data": 2})

    def loss(staged, x):
        y = jpp.pipeline_apply(lambda p, h: jnp.tanh(h @ p["w"][0]),
                               staged, x, 4, mesh=mesh)
        return jnp.sum(y ** 2)

    g, gx = jax.grad(loss, argnums=(0, 1))(_j(_staged(GRAD_LAYERS)),
                                           jnp.asarray(GRAD_X))
    ranks = world["apply_grad"]
    np.testing.assert_allclose(_blocks(ranks, ("grads", "w")),
                               np.asarray(g["w"]), atol=1e-4)
    _same_on_every_rank(ranks, "x_grad")
    np.testing.assert_allclose(ranks[0]["x_grad"], np.asarray(gx), atol=1e-4)


def test_pipeline_apply_validates(world):
    for r in world["errors"]:
        assert r["apply_no_stage"][0] == "ValueError"
        assert "stage" in r["apply_no_stage"][1]
        assert "not divisible by 2 micro-batches" in r["batch"][1]
        assert "stage dim" in r["stage_dim"][1]


def test_pipeline_value_and_grad_validates_schedule(world):
    for r in world["errors"]:
        assert r["schedule"][0] == "ValueError"
        assert "schedule" in r["schedule"][1]
        assert "virtual_stages" in r["interleaved_one_chunk"][1]
        assert "virtual_stages=2 requires" in r["gpipe_chunks"][1]
        assert "stage" in r["vg_no_stage"][1]


# -- 1F1B ------------------------------------------------------------------------------


@pytest.mark.parametrize("M", [4, 8])
def test_pipeline_1f1b_matches_sequential(world, M):
    loss_ref, grads_ref = _j_mlp_ref(MLP_LAYERS, MLP_X, MLP_T, M)
    ranks = world["1f1b"]
    for r in ranks:
        np.testing.assert_allclose(r[f"1f1b_{M}"]["loss"], float(loss_ref),
                                   rtol=1e-5)
    for k in ("w", "b"):
        got = _blocks(ranks, (f"1f1b_{M}", "grads", k))
        np.testing.assert_allclose(got.reshape(grads_ref[k].shape),
                                   np.asarray(grads_ref[k]), atol=1e-5)


def test_pipeline_1f1b_matches_jax_1f1b(world):
    """M=4 against the JAX package's 1F1B schedule itself."""
    loss, grads = jpp.pipeline_value_and_grad(
        _j_tanh_wb, _j_mse, _j(_staged(MLP_LAYERS)), jnp.asarray(MLP_X),
        jnp.asarray(MLP_T), 4, mesh=jmesh({"stage": 4, "data": 2}),
        schedule="1f1b")
    ranks = world["1f1b"]
    np.testing.assert_allclose(ranks[0]["1f1b_4"]["loss"], float(loss),
                               rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(_blocks(ranks, ("1f1b_4", "grads", k)),
                                   np.asarray(grads[k]), atol=1e-5)


def test_pipeline_1f1b_matches_gpipe(world):
    ranks = world["1f1b"]
    for r in ranks:
        np.testing.assert_allclose(r["1f1b_4"]["loss"], r["gpipe_4"]["loss"],
                                   rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(_blocks(ranks, ("1f1b_4", "grads", k)),
                                   _blocks(ranks, ("gpipe_4", "grads", k)),
                                   atol=1e-5)


def test_pipeline_1f1b_micro_fewer_than_stages(world):
    """M < S is still exact (warm-up and drain ticks idle)."""
    loss_ref, grads_ref = _j_mlp_ref(MLP_LAYERS, FEW_X, FEW_T, 2)
    ranks = world["few"]
    np.testing.assert_allclose(ranks[0]["1f1b_2"]["loss"], float(loss_ref),
                               rtol=1e-5)
    got = _blocks(ranks, ("1f1b_2", "grads", "w"))
    np.testing.assert_allclose(got.reshape(grads_ref["w"].shape),
                               np.asarray(grads_ref["w"]), atol=1e-5)


@pytest.mark.parametrize("case,M", [("1f1b", 4), ("1f1b", 8), ("few", 2)])
def test_1f1b_saved_inputs_within_bound(world, case, M):
    """Stage s never holds more than 2(S-1-s)+1 saved stage inputs, and
    holds that many once M reaches it; GPipe holds all M."""
    for s, r in enumerate(world[case]):
        bound = 2 * (S - 1 - s) + 1
        got = r[f"1f1b_{M}"]["stats"]["max_saved_inputs"]
        assert got == min(bound, M) == _clock_max_saved(1, M, s), \
            (s, got, bound)
        assert r[f"1f1b_{M}"]["stats"]["ticks"] == M + 2 * (S - 1)
        if case == "1f1b":
            assert r[f"gpipe_{M}"]["stats"]["max_saved_inputs"] == M


def test_pipeline_1f1b_llama_layers_match_sequential(world, llama_layers):
    """llama layer stacks as the stage body through 1F1B: loss and grads
    equal to the JAX package's unpipelined layers."""
    cfg, layers = llama_layers
    B, L, M = 8, 16, 4
    cos, sin = j_rope(cfg.head_dim, L, cfg.rope_theta)
    positions = jnp.broadcast_to(jnp.arange(L), (B, L))
    x, tgt = jnp.asarray(LLAMA_X), jnp.asarray(LLAMA_T)

    def ref(layers):
        def body(carry, layer):
            y, _, _ = jl._layer_body(cfg, carry, layer, cos, sin, positions,
                                     None)
            return y, None

        out, _ = jax.lax.scan(body, x, layers)
        return jnp.mean((out - tgt) ** 2)

    loss_ref, grads_ref = jax.value_and_grad(ref)(_j(layers))
    ranks = world["llama"]
    np.testing.assert_allclose(ranks[0]["1f1b_4"]["loss"], float(loss_ref),
                               rtol=1e-5)
    for path in (("attn", "q_proj", "kernel"), ("mlp", "down_proj", "kernel"),
                 ("input_layernorm", "scale")):
        want = grads_ref
        for k in path:
            want = want[k]
        got = _blocks(ranks, ("1f1b_4", "grads") + path)
        np.testing.assert_allclose(got.reshape(want.shape), np.asarray(want),
                                   atol=2e-5)


# -- interleaved -------------------------------------------------------------------------


def test_interleaved_forward_matches_sequential(world):
    """V=2 chunks a device reproduce the sequential layers for every
    micro count, M not a multiple of S included."""
    ref = np.asarray(_j_residual(_j(RES_LAYERS), jnp.asarray(RES_X)))
    for M in (4, 6, 12):
        _same_on_every_rank(world["il_forward"], f"y_{M}")
        np.testing.assert_allclose(world["il_forward"][0][f"y_{M}"], ref,
                                   atol=1e-5, err_msg=f"M={M}")


def test_interleaved_value_and_grad_matches_1f1b_and_sequential(world):
    ref_l, ref_g = _j_residual_ref(IL_LAYERS, IL_X, IL_T, 4)
    ranks = world["il_vg"]
    np.testing.assert_allclose(ranks[0]["interleaved_4"]["loss"],
                               float(ref_l), atol=1e-5)
    got = _blocks(ranks, ("interleaved_4", "grads", "w"), V=2)
    np.testing.assert_allclose(got.reshape(8, H, H), np.asarray(ref_g["w"]),
                               atol=1e-4)
    np.testing.assert_allclose(ranks[0]["interleaved_4"]["loss"],
                               world["il_vg_1f1b_ref"][0]["1f1b_4"]["loss"],
                               atol=1e-5)


@pytest.mark.parametrize("M", [6, 8])
def test_1f1b_interleaved_matches_autodiff_and_sequential(world, M):
    """The memory-bounded interleaved 1F1B equals the autodiff
    interleaved path and the sequential layers, M a multiple of S and
    not."""
    ref_l, ref_g = _j_residual_ref(IL_LAYERS, IL1_X, IL1_T, M)
    ranks = world["il_1f1b"]
    one = _blocks(ranks, (f"1f1b_{M}", "grads", "w"), V=2)
    auto = _blocks(ranks, (f"interleaved_{M}", "grads", "w"), V=2)
    np.testing.assert_allclose(ranks[0][f"1f1b_{M}"]["loss"], float(ref_l),
                               atol=1e-5)
    np.testing.assert_allclose(one.reshape(8, H, H), np.asarray(ref_g["w"]),
                               atol=1e-4)
    np.testing.assert_allclose(ranks[0][f"1f1b_{M}"]["loss"],
                               ranks[0][f"interleaved_{M}"]["loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(one, auto, atol=1e-5)


def test_1f1b_interleaved_matches_jax_schedule(world):
    """M=6 (not a multiple of S) against the JAX package's interleaved
    1F1B itself."""
    loss, grads = jpp.pipeline_value_and_grad(
        _j_residual, _j_mse, _j(jpp_virtual(IL_LAYERS, 2)),
        jnp.asarray(IL1_X), jnp.asarray(IL1_T), 6,
        mesh=jmesh({"stage": 4, "data": 2}), schedule="1f1b",
        virtual_stages=2)
    ranks = world["il_1f1b"]
    np.testing.assert_allclose(ranks[0]["1f1b_6"]["loss"], float(loss),
                               atol=1e-5)
    np.testing.assert_allclose(_blocks(ranks, ("1f1b_6", "grads", "w"), V=2),
                               np.asarray(grads["w"]), atol=1e-4)


def test_1f1b_interleaved_three_chunks(world):
    """V=3 against the JAX package's interleaved 1F1B and the sequential
    layers."""
    loss, grads = jpp.pipeline_value_and_grad(
        _j_residual, _j_mse, _j(jpp_virtual(V3_LAYERS, 3)),
        jnp.asarray(V3_X), jnp.asarray(V3_T), 4,
        mesh=jmesh({"stage": 4, "data": 2}), schedule="1f1b",
        virtual_stages=3)
    ref_l, ref_g = _j_residual_ref(V3_LAYERS, V3_X, V3_T, 4)
    ranks = world["v3"]
    got = _blocks(ranks, ("1f1b_4", "grads", "w"), V=3)
    np.testing.assert_allclose(ranks[0]["1f1b_4"]["loss"], float(loss),
                               atol=1e-5)
    np.testing.assert_allclose(ranks[0]["1f1b_4"]["loss"], float(ref_l),
                               atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(grads["w"]), atol=1e-4)
    np.testing.assert_allclose(got.reshape(S * 3, 8, 8),
                               np.asarray(ref_g["w"]), atol=1e-4)


def _clock_max_saved(V, M, d):
    """The most stage inputs device d holds at once under the reference's
    interleaved 1F1B clocks (`_pipeline_1f1b_interleaved_local`): micro
    m's input to virtual stage j = c*S + d is held from its forward at
    phi(m) + j through its backward at phi(m) + 2(S*V - 1) - j."""
    SV = S * V

    def phi(m):
        return (m % S) + SV * (m // S)

    spans = [(phi(m) + c * S + d, phi(m) + 2 * (SV - 1) - (c * S + d))
             for m in range(M) for c in range(V)]
    last = max(b for _, b in spans)
    return max(sum(f <= t <= b for f, b in spans) for t in range(last + 1))


@pytest.mark.parametrize("case,V,M", [("il_1f1b", 2, 6), ("il_1f1b", 2, 8),
                                      ("v3", 3, 4)])
def test_interleaved_1f1b_saved_inputs_bounded(world, case, V, M):
    """The interleaved 1F1B holds what the reference's clocks hold, and
    O(S*V): within its 3S a chunk, while the autodiff path holds all
    M*V."""
    for d, r in enumerate(world[case]):
        got = r[f"1f1b_{M}"]["stats"]["max_saved_inputs"]
        assert got == _clock_max_saved(V, M, d) <= 3 * S * V, (d, got)
        if f"interleaved_{M}" in r:
            assert r[f"interleaved_{M}"]["stats"]["max_saved_inputs"] == \
                M * V


# -- inference and the Accelerator on the 4-rank world -----------------------------------


def _j_tanh_affine_seq(layers, x):
    for i in range(layers["w"].shape[0]):
        x = jnp.tanh(x @ layers["w"][i] + layers["b"][i])
    return x


def test_prepare_pipeline_four_stages_matches_sequential(world):
    """The reference's `test_pipeline_matches_sequential`: 8 layers over
    4 stages, num_chunks defaulting to 4; each rank keeps 2 layers."""
    ranks = world["prepare"]
    want = np.asarray(j_make_stage_fn(
        lambda layer, x: jnp.tanh(x @ layer["w"] + layer["b"]))(
        _j(INF_LAYERS), jnp.asarray(INF_X)))
    for r in ranks:
        assert r["num_stages"] == 4 and r["num_chunks_None"] == 4
        assert r["block_shapes"] == {"w": (1, 2, H, H), "b": (1, 2, H)}
        for chunks in (None, 2, 8):
            np.testing.assert_allclose(r[f"y_{chunks}"], want, atol=1e-5)
    # GPipe hands each micro-batch on once a stage boundary
    assert [r["stats_8"]["handoffs"] for r in ranks] == [8, 8, 8, 0]


def test_sharded_inference_model_fsdp_gathers_on_use(world):
    """The reference's `test_sharded_inference_matches_unsharded` on a
    `model` 2 x `fsdp` 2 mesh: a function with no tensor-parallel path
    gathers its shards at the call; each rank keeps a quarter."""
    want = np.asarray(jax.jit(lambda p, x: jax.lax.scan(
        lambda h, layer: (jnp.tanh(h @ layer["mlp"]["up_proj"]["kernel"])
                          @ layer["mlp"]["down_proj"]["kernel"], None),
        x, p["layers"])[0])(_j(SHARD_PARAMS), jnp.asarray(SHARD_X)))
    for r in world["sharded"]:
        assert r["route"] == "gather"
        assert r["bytes"] * 4 == r["whole_bytes"]
        np.testing.assert_allclose(r["y"], want, atol=1e-5)


def _check_training_calls(r):
    """A rank's `worlds._training_calls`: every call ran; its loader gave
    its batch line's half of the global batch; the fused step's loss and
    `compute_gradients`' loss and grads are the global batch's, and the
    first AdamW update (lr 1e-3) follows the global gradient's sign."""
    assert r["errors"] == {n: None for n in r["errors"]}, r["errors"]
    x, y = r["global_x"].astype(np.float64), r["global_y"].astype(np.float64)
    size, index = r["line"]
    assert size == 2
    np.testing.assert_array_equal(r["rows"][0]["x"],
                                  r["global_x"][4 * index:4 * index + 4])
    loss = np.mean(y ** 2)
    grad = -(2 / y.size) * x.T @ y
    np.testing.assert_allclose(r["step_loss"], loss, rtol=1e-6)
    np.testing.assert_allclose(r["loss"], loss, rtol=1e-6)
    np.testing.assert_allclose(r["grads"], grad, rtol=1e-5)
    np.testing.assert_array_equal(r["buffer"], r["grads"])
    np.testing.assert_allclose(r["step_w"], -1e-3 * np.sign(grad),
                               rtol=1e-5)


def test_accelerator_data_by_stage_mesh(world):
    """`Accelerator(mesh_config=MeshConfig(axes={"data": 2, "stage":
    2}))` builds; its mesh reaches `prepare_pipeline` and the 1F1B
    schedule over each data replica's stage line (a subgroup); the
    training calls, which raised there until the loaders and the
    gradient average ran over the batch line, now train with `stage` as
    a replica axis: each rank's loader gives its batch line's rows and
    the loss, grads and update are the global batch's (the `model`
    axis still raises, naming item 6b)."""
    ranks = world["accelerator"]
    want = np.asarray(_j_tanh_affine_seq(_j(ACC_LAYERS), jnp.asarray(ACC_X)))
    loss_ref, grads_ref = jax.value_and_grad(
        lambda p: jnp.mean(jnp.stack([
            _j_mse(_j_tanh_affine_seq(p, x), x * 0.5)
            for x in jnp.split(jnp.asarray(ACC_X), 4)])))(_j(ACC_LAYERS))
    for rank, r in enumerate(ranks):
        assert r["mesh"] == {"data": 2, "stage": 2}
        assert r["stage_index"] == rank % 2
        assert r["stage_line"] == [rank - rank % 2, rank - rank % 2 + 1]
        np.testing.assert_allclose(r["y"], want, atol=1e-5)
        np.testing.assert_allclose(r["loss"], float(loss_ref), rtol=1e-5)
        _check_training_calls(r["trained"])
        np.testing.assert_array_equal(r["trained"]["step_w"],
                                      ranks[0]["trained"]["step_w"])
        assert r["params_prepared"]
        assert len(r["model_axis"]) == 4
        assert all(m is not None and "queue 1 item 6b" in m
                   for m in r["model_axis"])
    for k in ("w", "b"):
        got = np.concatenate([ranks[0]["grads"][k], ranks[1]["grads"][k]])
        np.testing.assert_allclose(got.reshape(grads_ref[k].shape),
                                   np.asarray(grads_ref[k]), atol=1e-5)
        np.testing.assert_array_equal(ranks[2]["grads"][k],
                                      ranks[0]["grads"][k])
