"""The port's distributed inference (`accelerate_tpu_torch.inference`,
`big_modeling.dispatch_model("sharded")`) and the point-to-point axis
operations (`utils.operations.axis_ppermute`, `axis_broadcast`) against
the JAX package, on the same numpy inputs and converted weights.

One 2-rank `debug_launcher` world on the CPU (gloo) holds the
multi-rank checks (`test_utils.worlds.pipeline_forms`): the reference's
`tests/test_inference.py` cases on a `stage` (or `model`) axis of 2,
the tiny llama through `prepare_pipeline` with an embedding `pre_fn`
and a norm-and-head `post_fn`, through `prepare_sharded_inference`
(its tensor-parallel route) and through `dispatch_model` and
`load_checkpoint_and_dispatch` with `"sharded"`; the launched
`test_pipeline_inference.py` is the second world. The JAX side runs in
the pytest process (its forward and the reference tests' sequential
functions).

Tolerances: f32 on both sides, products in another order; outputs atol
1e-5 (the reference tests'), llama logits atol 1e-4 (logits of a few
units, f32 sums over 64 to 128 terms in other orders, the port's
tensor-parallel sums split over 2 ranks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.checkpointing import save_model as jsave_model
from accelerate_tpu.inference import make_stage_fn as j_make_stage_fn
from accelerate_tpu.models import llama as jl
from accelerate_tpu.utils.dataclasses import MeshConfig as JMesh
from accelerate_tpu_torch.inference import make_stage_fn
from accelerate_tpu_torch.test_utils import (
    bundled_script_path,
    execute_subprocess,
    launch_command_for,
    run_world,
)
from accelerate_tpu_torch.test_utils.worlds import pipeline_forms
from accelerate_tpu_torch.utils.dataclasses import MeshConfig

WORLD_TIMEOUT_S = 180
LLAMA_ATOL = 1e-4


def _normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


LAYERS = {"w": _normal(0, (4, 16, 16), 0.3), "b": _normal(1, (4, 16), 0.1)}
X = _normal(2, (4, 16))
LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128,
             attention_backend="einsum")
IDS = np.random.default_rng(3).integers(0, 256, (4, 24)).astype(np.int32)
D = 32
MLP = {"layers": {"mlp": {
    "up_proj": {"kernel": _normal(4, (2, D, D * 4), 0.1)},
    "down_proj": {"kernel": _normal(5, (2, D * 4, D), 0.1)}}}}
MLP_X = _normal(6, (4, D))


def _j_seq(layers, x):
    for i in range(layers["w"].shape[0]):
        x = jnp.tanh(x @ layers["w"][i] + layers["b"][i])
    return x


@pytest.fixture(scope="module")
def llama_weights(tmp_path_factory):
    cfg = jl.LlamaConfig(**LLAMA)
    params = jl.init_params(cfg, jax.random.key(0))
    folder = str(tmp_path_factory.mktemp("llama_ckpt"))
    jsave_model(params, folder)
    logits = np.asarray(jl.forward(cfg, params, jnp.asarray(IDS)))
    return jax.tree_util.tree_map(np.asarray, params), folder, logits


@pytest.fixture(scope="module")
def world(llama_weights):
    params, folder, _ = llama_weights
    cases = [
        dict(name="p2p", kind="p2p"),
        dict(name="errors", kind="errors"),
        dict(name="pre_post", kind="prepare", layer_fn="tanh_affine",
             params=LAYERS, x=X, chunks=[2], pre="double", post="plus_one"),
        dict(name="llama_pipeline", kind="prepare", layer_fn="llama",
             config=LLAMA, params=params, x=IDS, chunks=[None, 4]),
        dict(name="llama_sharded", kind="sharded", forward="llama",
             config=LLAMA, mesh={"model": 2}, params=params, x=IDS),
        dict(name="mlp_sharded", kind="sharded", forward="mlp_scan",
             mesh={"model": 2}, params=MLP, x=MLP_X),
        dict(name="dispatch", kind="dispatch", config=LLAMA, params=params,
             x=IDS, checkpoint=folder),
    ]
    ranks = run_world(pipeline_forms, 2, (cases,), timeout_s=WORLD_TIMEOUT_S)
    return {name: [r[name] for r in ranks] for name in ranks[0]
            if name != "log"}


# -- one process -------------------------------------------------------------------


def test_make_stage_fn_scans_layers():
    """The port's stage body over [L, ...] layers equals the JAX
    package's `make_stage_fn` scan."""
    layers = {k: v[:3] for k, v in LAYERS.items()}
    want = np.asarray(j_make_stage_fn(
        lambda layer, x: jnp.tanh(x @ layer["w"] + layer["b"]))(
        jax.tree_util.tree_map(jnp.asarray, layers), jnp.asarray(X)))
    got = make_stage_fn(lambda layer, x: torch.tanh(x @ layer["w"] +
                                                    layer["b"]))(
        {k: torch.from_numpy(v) for k, v in layers.items()},
        torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("axes", [{"data": -1}, {"data": 2, "stage": 2},
                                  {"stage": 2, "data": -1},
                                  {"model": 2, "fsdp": -1}])
def test_mesh_config_build_lays_out_the_processes(axes):
    """`MeshConfig.build()` is the reference's `build()` over processes:
    the same axes and sizes as the reference's mesh over as many
    devices, ranks row-major over them."""
    n = 4
    want = JMesh(axes=dict(axes)).build(devices=jax.devices()[:n])
    mesh = MeshConfig(axes=dict(axes)).build(num_processes=n)
    assert mesh.shape == dict(want.shape)
    assert mesh.axis_names == want.axis_names
    ids = np.vectorize(lambda d: d.id)(want.devices)
    for rank in range(n):
        coords = mesh.coords(rank)
        assert ids[tuple(coords[a] for a in mesh.axis_names)] == rank
    assert MeshConfig(axes={"data": -1}).build().shape == {"data": 1}


# -- the 2-rank world ----------------------------------------------------------------


def test_axis_ppermute_and_broadcast(world):
    """Around a line of 2 each rank gets the other's tensor (f32, and
    bf16 as bf16), one edge moves one tensor, and the broadcast from
    the last rank reaches both; the inputs are left as they were."""
    for r, got in enumerate(world["p2p"]):
        other = 1 - r
        np.testing.assert_array_equal(got["next"], np.full(3, other))
        np.testing.assert_array_equal(got["prev"], np.full(3, other))
        np.testing.assert_array_equal(got["bf16"],
                                      np.full((2, 2), other + 0.5))
        assert got["bf16_dtype"] == "torch.bfloat16"
        assert (got["edge"] is None) == (r == 0)
        if r == 1:
            np.testing.assert_array_equal(got["edge"], np.zeros(3))
        np.testing.assert_array_equal(got["broadcast"],
                                      np.full((2, 2), 1.5))
        np.testing.assert_array_equal(got["mine_after"], np.full(3, r))


def test_pipeline_requires_stage_axis(world):
    for r in world["errors"]:
        kind, msg = r["prepare_no_stage"]
        assert kind == "ValueError" and "stage" in msg


def test_pipeline_pre_post_fns(world):
    """The reference's `test_pipeline_pre_post_fns`: 4 layers over 2
    stages, 2 chunks, pre and post outside the pipelined body."""
    want = np.asarray(_j_seq(jax.tree_util.tree_map(jnp.asarray, LAYERS),
                             jnp.asarray(X) * 2.0) + 1.0)
    for r in world["pre_post"]:
        assert r["num_stages"] == 2 and r["num_chunks_2"] == 2
        np.testing.assert_allclose(r["y_2"], want, atol=1e-5)


def test_llama_pipeline_matches_jax_forward(world, llama_weights):
    """The tiny llama (4 layers) split over 2 stages with the embedding
    as `pre_fn` and the norm and head as `post_fn` gives the JAX
    forward's logits on both ranks, at 2 (the default) and 4 chunks;
    each rank keeps 2 layers and hands on one micro-batch a chunk."""
    _, _, want = llama_weights
    ranks = world["llama_pipeline"]
    for r in ranks:
        assert r["block_shapes"]["attn/q_proj/kernel"] == (1, 2, 64, 64)
        for chunks in (None, 4):
            np.testing.assert_allclose(r[f"y_{chunks}"], want,
                                       atol=LLAMA_ATOL)
    assert [r["stats_4"]["handoffs"] for r in ranks] == [4, 0]
    assert ranks[0]["stats_4"]["handoff_bytes"] == 4 * 24 * 64 * 4


def test_sharded_inference_llama_runs_tensor_parallel(world, llama_weights):
    """`prepare_sharded_inference(partial(llama.forward, cfg))` on a
    `model` axis of 2 takes the tensor-parallel route and gives the JAX
    forward's logits; each rank keeps about half the bytes."""
    _, _, want = llama_weights
    for r in world["llama_sharded"]:
        assert r["route"] == "tensor_parallel"
        assert 0.49 <= r["bytes"] / r["whole_bytes"] <= 0.52
        np.testing.assert_allclose(r["y"], want, atol=LLAMA_ATOL)


def test_sharded_inference_other_function_gathers(world):
    """A function with no tensor-parallel path gathers its `model`
    shards at the call and equals the sequential JAX function."""
    mlp = jax.tree_util.tree_map(jnp.asarray, MLP)["layers"]["mlp"]
    h = jnp.asarray(MLP_X)
    for i in range(2):
        h = jnp.tanh(h @ mlp["up_proj"]["kernel"][i]) @ \
            mlp["down_proj"]["kernel"][i]
    for r in world["mlp_sharded"]:
        assert r["route"] == "gather"
        assert r["bytes"] * 2 == r["whole_bytes"]
        np.testing.assert_allclose(r["y"], np.asarray(h), atol=1e-5)


def test_dispatch_model_sharded_across_ranks(world, llama_weights):
    """`dispatch_model(params, "sharded")` (and None) in a world of 2
    plans a `model` axis over the world with the transformer rules:
    each rank keeps about half the bytes, and the family's forward on
    the shards gives the JAX forward's logits; so does
    `load_checkpoint_and_dispatch(device_map="sharded")` from a
    checkpoint the JAX package wrote. Another `mesh_axis` raises: no
    forward reads its shards."""
    _, _, want = llama_weights
    for r in world["dispatch"]:
        for mode in ("sharded", None):
            assert r[f"mesh_{mode}"] == {"model": 2}
            assert 0.49 <= r[f"bytes_{mode}"] / r["whole_bytes"] <= 0.52
            np.testing.assert_allclose(r[f"y_{mode}"], want,
                                       atol=LLAMA_ATOL)
        assert r["bytes_checkpoint"] == r["bytes_sharded"]
        assert "queue 1 item 6b" in r["fsdp_axis"]
        np.testing.assert_allclose(r["y_checkpoint"], want, atol=LLAMA_ATOL)


def test_launched_pipeline_inference_script():
    """The launch-and-assert script in a 2-process CPU world: every rank
    asserts, the main process prints its line."""
    out = execute_subprocess(launch_command_for(
        bundled_script_path("external_deps/test_pipeline_inference.py"), 2,
        ["--cpu"]), timeout=WORLD_TIMEOUT_S)
    assert "test_pipeline_inference: ALL CHECKS PASSED (2 process(es))" \
        in out


def test_pipeline_inference_script_in_one_process(monkeypatch):
    """In a world of one the script's stage checks step aside (no stage
    axis fits) and its sharded path still runs."""
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.test_utils.scripts.external_deps import \
        test_pipeline_inference as script
    from accelerate_tpu_torch.utils.constants import ENV_CPU

    monkeypatch.setenv(ENV_CPU, "1")
    PartialState._reset_state()
    try:
        with torch.no_grad():
            script.check_pipeline_matches_sequential()
            script.check_sharded_serving_path()
    finally:
        PartialState._reset_state()

