"""The port's sharding planner (`accelerate_tpu_torch.sharding`) against
the JAX package's (`accelerate_tpu.sharding`).

On every zoo family's tiny params and on the meshes below, the port's
`plan_sharding` gives the JAX plan's `PartitionSpec` leaf for leaf, with
`shard_params` True and False (the port plans its own `init_params`
tree, which therefore has the reference's paths and shapes). The same
holds for `auto_fsdp_spec`, `batch_spec`, the fused-qkv rules and
`plan_optimizer_sharding` on the port's AdamW state. In 2- and 4-rank
`debug_launcher` worlds each rank's `shard_pytree` shard equals, bit for
bit, the JAX array's shard on device r (JAX runs on the suite's 8 CPU
devices)."""

import importlib

import jax
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import sharding as jsh
from accelerate_tpu.utils import MeshConfig
from accelerate_tpu_torch import optimizers
from accelerate_tpu_torch import sharding as tsh
from accelerate_tpu_torch.sharding.planner import leaves_with_path
from accelerate_tpu_torch.state import ProcessMesh
from accelerate_tpu_torch.test_utils import run_world
from accelerate_tpu_torch.test_utils.worlds import shard_forms

ZOO = {"llama": "LlamaConfig", "gpt2": "GPT2Config", "gptj": "GPTJConfig",
       "gpt_neox": "GPTNeoXConfig", "opt": "OPTConfig",
       "mixtral": "MixtralConfig", "bert": "BertConfig", "t5": "T5Config"}
MESHES = {"model2": {"model": 2}, "model3": {"model": 3},
          "model4": {"model": 4}, "fsdp2": {"fsdp": 2}, "fsdp4": {"fsdp": 4},
          "fsdp2_model2": {"fsdp": 2, "model": 2},
          "expert2_model2": {"expert": 2, "model": 2}}


def jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return MeshConfig(axes=dict(axes)).build(devices=jax.devices()[:n])


def _leaf_specs(plan, named):
    return [(path, tuple(s.spec)) for path, s in leaves_with_path(
        plan, is_leaf=lambda x: isinstance(x, named))]


def _jax_specs(plan):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(s.spec))
            for path, s in jax.tree_util.tree_leaves_with_path(
                plan, is_leaf=lambda x: isinstance(
                    x, jax.sharding.NamedSharding))]


_PARAMS: dict = {}


def _zoo_params(name):
    """(JAX params, the port's own init_params) of a family's tiny
    config."""
    if name not in _PARAMS:
        jm = importlib.import_module(f"accelerate_tpu.models.{name}")
        tm = importlib.import_module(f"accelerate_tpu_torch.models.{name}")
        jp = jm.init_params(getattr(jm, ZOO[name]).tiny(), jax.random.key(0))
        tp = tm.init_params(getattr(tm, ZOO[name]).tiny(), 0, device="cpu")
        _PARAMS[name] = (jp, tp)
    return _PARAMS[name]


@pytest.mark.parametrize("shard", [True, False], ids=["sharded", "replicated"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("family", list(ZOO))
def test_plan_sharding_equals_jax_on_every_zoo_family(family, mesh, shard):
    jp, tp = _zoo_params(family)
    axes = MESHES[mesh]
    want = _jax_specs(jsh.plan_sharding(jp, jmesh(axes), shard_params=shard))
    got = _leaf_specs(tsh.plan_sharding(tp, ProcessMesh(axes),
                                        shard_params=shard),
                      tsh.NamedSharding)
    assert got == want
    if mesh == "model2" and shard:
        assert jsh.describe_plan(jsh.plan_sharding(jp, jmesh(axes))) == \
            tsh.describe_plan(tsh.plan_sharding(tp, ProcessMesh(axes)))


@pytest.mark.parametrize("axes,shape", [
    ({"fsdp": 8}, (100, 64)), ({"fsdp": 8}, (100, 30)),
    ({"fsdp": 8}, (64, 128)), ({"fsdp": 4}, (8, 8)), ({"fsdp": 4}, ()),
    ({"model": 4}, (64, 64)), ({"fsdp": 2, "model": 2}, (6, 4, 2)),
])
def test_auto_fsdp_spec_equals_jax(axes, shape):
    assert tuple(tsh.auto_fsdp_spec(shape, ProcessMesh(axes))) == \
        tuple(jsh.auto_fsdp_spec(shape, jmesh(axes)))


@pytest.mark.parametrize("axes,extra", [
    ({"data": 2, "fsdp": 4}, 0), ({"data": 8}, 1), ({"model": 8}, 0),
    ({"fsdp": 2, "model": 4}, 2), ({"data": 2, "model": 2}, 1)])
def test_batch_spec_equals_jax(axes, extra):
    want = jsh.batch_spec(jmesh(axes), extra_dims=extra)
    assert tuple(tsh.batch_spec(ProcessMesh(axes), extra_dims=extra)) == \
        tuple(want)
    assert tuple(tsh.batch_sharding(ProcessMesh(axes)).spec) == \
        tuple(jsh.batch_sharding(jmesh(axes)).spec)


@pytest.mark.parametrize("axes", [{"fsdp": 2, "model": 4}, {"model": 4},
                                  {"model": 2}, {"model": 3}])
def test_fused_qkv_rules_equal_jax(axes):
    """gpt2's `c_attn` and neox's `query_key_value` ([in, 3h]) are
    column-parallel by name, in the port as in the reference."""
    shape = (2, 64, 192)
    jparams = {"layers": {"attn": {
        "c_attn": {"kernel": np.zeros(shape, np.float32)},
        "query_key_value": {"kernel": np.zeros(shape, np.float32)}}}}
    tparams = {"layers": {"attn": {
        "c_attn": {"kernel": torch.zeros(shape)},
        "query_key_value": {"kernel": torch.zeros(shape)}}}}
    want = _jax_specs(jsh.plan_sharding(jparams, jmesh(axes)))
    got = _leaf_specs(tsh.plan_sharding(tparams, ProcessMesh(axes)),
                      tsh.NamedSharding)
    assert got == want
    if axes == {"model": 4}:
        assert dict(got)["layers/attn/c_attn/kernel"] == (None, None,
                                                          "model")


@pytest.mark.parametrize("axes", [{"fsdp": 8}, {"fsdp": 2, "model": 2},
                                  {"model": 4}])
def test_optimizer_plan_equals_jax_on_adamw_state(axes):
    """mu/nu adopt the param plan, the step count replicates."""
    jp, tp = _zoo_params("llama")
    jplan = jsh.plan_sharding(jp, jmesh(axes))
    jopt = optax.adamw(1e-3)
    jstate = jopt.init(jp)
    jo = jsh.plan_optimizer_sharding(jopt, jstate, jplan, jmesh(axes))
    mesh = ProcessMesh(axes)
    tplan = tsh.plan_sharding(tp, mesh)
    topt = optimizers.adamw(1e-3)
    to = tsh.plan_optimizer_sharding(topt, topt.init(tp), tplan, mesh)
    for field in ("mu", "nu"):
        assert _leaf_specs(getattr(to, field), tsh.NamedSharding) == \
            _jax_specs(getattr(jo[0], field))
    assert tuple(to.count.spec) == tuple(jo[0].count.spec) == ()
    # SGD with momentum: its trace adopts the plan too
    sgd = optimizers.sgd(0.1, momentum=0.9)
    so = tsh.plan_optimizer_sharding(sgd, sgd.init(tp), tplan, mesh)
    assert _leaf_specs(so.trace, tsh.NamedSharding) == \
        _leaf_specs(tplan, tsh.NamedSharding)


def test_plan_reads_meta_tensors_and_passes_static_leaves():
    """Planning materialises nothing (meta tensors plan like real ones);
    a leaf without a shape passes through shard_pytree untouched."""
    from accelerate_tpu_torch.big_modeling import init_empty_weights
    from accelerate_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()
    mesh = ProcessMesh({"fsdp": 2})
    meta = init_empty_weights(llama.init_params, cfg, 0)
    real = llama.init_params(cfg, 0, device="cpu")
    assert _leaf_specs(tsh.plan_sharding(meta, mesh), tsh.NamedSharding) \
        == _leaf_specs(tsh.plan_sharding(real, mesh), tsh.NamedSharding)
    out = tsh.shard_pytree({"n": 3, "a": torch.ones(4, 2)},
                           {"n": None, "a": tsh.NamedSharding(
                               mesh, tsh.PartitionSpec("fsdp", None))},
                           rank=1)
    assert out["n"] == 3 and out["a"].shape == (2, 2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


SHARD_CASES = {
    2: {"llama_model2": ("llama", {"model": 2}),
        "gpt2_model2": ("gpt2", {"model": 2}),
        "mixtral_fsdp2": ("mixtral", {"fsdp": 2})},
    4: {"llama_model4": ("llama", {"model": 4}),
        "llama_fsdp2_model2": ("llama", {"fsdp": 2, "model": 2}),
        "gpt2_fsdp4": ("gpt2", {"fsdp": 4}),
        "mixtral_expert2_model2": ("mixtral", {"expert": 2, "model": 2})},
}


@pytest.fixture(scope="module")
def shard_worlds():
    out = {}
    for n, cases in SHARD_CASES.items():
        args = {name: (axes, _np(_zoo_params(fam)[0]))
                for name, (fam, axes) in cases.items()}
        out[n] = run_world(shard_forms, n, (args,))
    return out


@pytest.mark.parametrize("n,case", [(n, c) for n, cs in SHARD_CASES.items()
                                    for c in cs])
def test_shard_pytree_equals_jax_addressable_shards(shard_worlds, n, case):
    fam, axes = SHARD_CASES[n][case]
    jp = _zoo_params(fam)[0]
    mesh = jmesh(axes)
    placed = jsh.shard_pytree(jp, jsh.plan_sharding(jp, mesh))
    jleaves = jax.tree_util.tree_leaves_with_path(placed)
    for rank, res in enumerate(shard_worlds[n]):
        got = dict(leaves_with_path(res[case]["shards"]))
        assert len(got) == len(jleaves)
        for path, leaf in jleaves:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            want = [s.data for s in leaf.addressable_shards
                    if s.device.id == rank][0]
            assert got[key].shape == want.shape, key
            assert np.array_equal(got[key].view(np.uint32),
                                  np.asarray(want).view(np.uint32)), key
        # the mesh's groups: an axis of size > 1 has one in the world
        assert res[case]["groups"] == {a: s > 1 for a, s in axes.items()}
