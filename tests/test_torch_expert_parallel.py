"""The port's expert parallelism (`parallel/moe.py`:
`expert_parallel_moe`, `expert_parallel_moe_a2a`; Mixtral
`moe_impl="a2a"`) against the JAX package's, on the same numpy inputs
from seeds.

One 4-rank `debug_launcher` world on the CPU (gloo) holds every
multi-rank check (`test_utils.worlds.expert_parallel_forms`) on an
`expert` line of 4 (`{"expert": 4}`) and on two lines of 2
(`{"expert": 2, "data": 2}`); each rank passes the whole tokens and
gets the whole output. The JAX side runs in the pytest process on the
conftest's 8 CPU devices, on a mesh with the same `expert` size (so the
per-source capacity is the same), jitted as `tests/test_parallel.py`
runs it.

Tolerances: outputs atol 1e-5 and gradients atol 1e-4, f32 products in
another order (the reference tests' own); the dropped fraction exact
(index arithmetic); Mixtral logits atol 1e-4, aux loss and loss rtol
1e-5, gradients within 1e-4 of each leaf's largest element; fp8 Mixtral
logits atol 5e-3 and the new scales rtol 1e-5 (the E4M3 casts round the
same values; the products' sums in another order).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from accelerate_tpu.models import mixtral as jm
from accelerate_tpu.parallel import expert_parallel_moe as j_moe
from accelerate_tpu.parallel import expert_parallel_moe_a2a as j_a2a
from accelerate_tpu.utils import MeshConfig
from accelerate_tpu_torch.test_utils import run_world
from accelerate_tpu_torch.test_utils.worlds import expert_parallel_forms

WORLD = 4
WORLD_TIMEOUT_S = 240
E4 = {"expert": 4}
E2 = {"expert": 2, "data": 2}
OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


T, H, E = 32, 8, 8
X = _normal(0, (T, H))
LOGITS = _normal(1, (T, E))
PARAMS = {"w": _normal(2, (E, H, H), 0.3)}
FLOOD = np.full((T, E), -20.0, np.float32)
FLOOD[:, 0] = 20.0
IDENTITY = {"w": np.stack([np.eye(H, dtype=np.float32)] * E)}
P6 = {"w": _normal(3, (6, H, H), 0.3)}
L6 = _normal(4, (T, 6))
MIXTRAL = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, num_local_experts=4,
               num_experts_per_tok=2, max_position_embeddings=32,
               moe_impl="a2a", attention_backend="einsum")
MIXTRAL_IDS = np.random.default_rng(5).integers(0, 64, (2, 16))
# 17 tokens: the loss's forward sees 2 x 16, which splits over the line
LOSS_IDS = np.random.default_rng(8).integers(0, 64, (2, 17))


def jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return MeshConfig(axes=dict(axes)).build(devices=jax.devices()[:n])


def _j(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _j_tanh(p, xs):
    return jnp.tanh(xs @ p["w"])


def _j_identity(p, xs):
    return xs @ p["w"]


@pytest.fixture(scope="module")
def mixtral_params():
    cfg = jm.MixtralConfig(**MIXTRAL)
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(cfg, jax.random.key(6)))


def _cases(mixtral_params):
    moe = dict(kind="moe", x=X, logits=LOGITS, params=PARAMS)
    return [
        dict(moe, name="a2a", impl="a2a", mesh=E4, capacity_factor=8.0,
             top_k=[1, 2], grad=True, stats=True),
        dict(moe, name="a2a_sharded", impl="a2a", mesh=E2,
             capacity_factor=8.0, top_k=[2], grad=True, shard=True),
        dict(moe, name="replicated", impl="replicated", mesh=E4,
             capacity_factor=8.0, top_k=[1, 2], grad=True),
        dict(name="flood_a2a", kind="moe", impl="a2a", mesh=E4, x=X,
             logits=FLOOD, params=IDENTITY, expert_fn="identity",
             capacity_factor=1.0, top_k=[1], stats=True),
        dict(name="flood_replicated", kind="moe", impl="replicated",
             mesh=E4, x=X, logits=FLOOD, params=IDENTITY,
             expert_fn="identity", capacity_factor=1.0, top_k=[1],
             stats=True),
        dict(name="fallback", kind="fallback", mesh=E4, x=X, p6=P6, l6=L6,
             p8=PARAMS, l8=LOGITS, odd_tokens=30),
        dict(name="mixtral", kind="mixtral", mesh=E4, config=MIXTRAL,
             params=mixtral_params, ids=MIXTRAL_IDS, loss_ids=LOSS_IDS,
             fp8=True),
        dict(name="mixtral_e2", kind="mixtral", mesh=E2, config=MIXTRAL,
             params=mixtral_params, ids=MIXTRAL_IDS, loss_ids=LOSS_IDS),
    ]


@pytest.fixture(scope="module")
def world(mixtral_params):
    ranks = run_world(expert_parallel_forms, WORLD,
                      (_cases(mixtral_params),), timeout_s=WORLD_TIMEOUT_S)
    return {name: [r[name] for r in ranks] for name in ranks[0]
            if name != "log"}


def _jax_moe(impl, axes, k, cf, x=X, logits=LOGITS, params=PARAMS,
             fn=_j_tanh, stats=False):
    mesh = jmesh(axes)
    return jax.jit(lambda x, l, p: impl(
        x, l, p, fn, mesh=mesh, capacity_factor=cf, top_k=k,
        return_stats=stats))(jnp.asarray(x), jnp.asarray(logits),
                             _j(params))


def _jax_moe_grads(impl, axes, k, cf):
    mesh = jmesh(axes)

    def loss(p, x):
        y = impl(x, jnp.asarray(LOGITS), p, _j_tanh, mesh=mesh,
                 capacity_factor=cf, top_k=k)
        return jnp.sum(y ** 2)

    g, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(_j(PARAMS),
                                                    jnp.asarray(X))
    return np.asarray(g["w"]), np.asarray(gx)


# -- the dispatches -----------------------------------------------------------


def test_moe_a2a_matches_replicated_dispatch(world):
    """At generous capacity the token-sharded all-to-all dispatch on a
    line of 4 == the JAX package's a2a and replicated dispatches, top-1
    and top-2, on every rank; nothing drops."""
    for k in (1, 2):
        want = np.asarray(_jax_moe(j_a2a, {"expert": 4, "data": 2}, k, 8.0))
        rep = np.asarray(_jax_moe(j_moe, {"expert": 4, "data": 2}, k, 8.0))
        np.testing.assert_allclose(want, rep, atol=OUT_ATOL)
        for r in world["a2a"]:
            np.testing.assert_allclose(r[f"y_{k}"], want, atol=OUT_ATOL)
            assert r[f"dropped_{k}"] == 0.0


def test_moe_a2a_differentiable(world):
    """The gradients of sum(y**2) through the two all-to-alls: the whole
    expert stack's (each rank's block all-gathered) and the tokens' ==
    the JAX package's a2a gradients."""
    gw, gx = _jax_moe_grads(j_a2a, {"expert": 4, "data": 2}, 1, 8.0)
    for r in world["a2a"]:
        np.testing.assert_allclose(r["grads"]["w"], gw, atol=GRAD_ATOL)
        np.testing.assert_allclose(r["x_grad"], gx, atol=GRAD_ATOL)


def test_moe_a2a_on_planner_shards(world):
    """Each rank holding only its block of the experts (the planner's
    placement, the leading E over `expert`) on lines of 2: the output ==
    the JAX package's, and each rank's block gradient is its block of
    the JAX gradient."""
    want = np.asarray(_jax_moe(j_a2a, {"expert": 2, "data": 4}, 2, 8.0))
    gw, gx = _jax_moe_grads(j_a2a, {"expert": 2, "data": 4}, 2, 8.0)
    for rank, r in enumerate(world["a2a_sharded"]):
        assert r["param_shapes"] == {"w": (E // 2, H, H)}
        np.testing.assert_allclose(r["y_2"], want, atol=OUT_ATOL)
        block = rank // 2            # E2 lays ranks out expert-major
        np.testing.assert_allclose(
            r["grads"]["w"], gw[block * E // 2:(block + 1) * E // 2],
            atol=GRAD_ATOL)
        np.testing.assert_allclose(r["x_grad"], gx, atol=GRAD_ATOL)


def test_moe_a2a_per_source_capacity_drops(world):
    """Every token floods expert 0 at capacity 1 a source: each rank's
    first token survives (its identity expert returns it), the rest drop
    to zero, as in the JAX package's a2a."""
    want = np.asarray(_jax_moe(j_a2a, {"expert": 4, "data": 2}, 1, 1.0,
                               logits=FLOOD, params=IDENTITY,
                               fn=_j_identity))
    for r in world["flood_a2a"]:
        y = r["y_1"]
        np.testing.assert_allclose(y, want, atol=OUT_ATOL)
        for src in range(4):
            first = src * (T // 4)
            np.testing.assert_allclose(y[first], X[first], atol=1e-3)
            assert np.abs(y[first + 1:first + T // 4]).max() < 1e-6


def test_moe_dropped_fraction_stats(world):
    """The dropped fraction: 0 at generous capacity; 7/8 with the flooded
    expert in both dispatches (the a2a's the mean over sources), equal
    to the JAX package's."""
    for impl, name in ((j_a2a, "flood_a2a"), (j_moe, "flood_replicated")):
        _, stats = _jax_moe(impl, {"expert": 4, "data": 2}, 1, 1.0,
                            logits=FLOOD, params=IDENTITY, fn=_j_identity,
                            stats=True)
        want = float(stats["moe_dropped_fraction"])
        assert want == pytest.approx(7 / 8)
        for r in world[name]:
            assert r["dropped_1"] == pytest.approx(want, abs=1e-6)


def test_ep_moe_top2_matches_replicated_reference(world):
    """The replicated-buffer dispatch over the `expert` axis (each rank
    its experts' rows, one all-gather) == the JAX package's, top-1 and
    top-2 (which differ), with its gradients."""
    for k in (1, 2):
        want = np.asarray(_jax_moe(j_moe, {"expert": 4, "data": 2}, k, 8.0))
        for r in world["replicated"]:
            np.testing.assert_allclose(r[f"y_{k}"], want, atol=OUT_ATOL)
    assert not np.allclose(world["replicated"][0]["y_1"],
                           world["replicated"][0]["y_2"], atol=1e-3)
    gw, gx = _jax_moe_grads(j_moe, {"expert": 4, "data": 2}, 1, 8.0)
    for r in world["replicated"]:
        np.testing.assert_allclose(r["grads"]["w"], gw, atol=GRAD_ATOL)
        np.testing.assert_allclose(r["x_grad"], gx, atol=GRAD_ATOL)


def test_moe_a2a_fallback_warns_and_strict_raises(world):
    """6 experts on a line of 4: the a2a falls back to the replicated
    dispatch with a `MoEFallbackWarning` (the JAX package's words), or
    raises under `strict`; 30 tokens trip it too; a clean call warns
    nothing; the replicated dispatch warns that experts replicate."""
    mesh = jmesh({"expert": 4, "data": 2})
    from accelerate_tpu.parallel import MoEFallbackWarning as JWarning

    with pytest.warns(JWarning) as jw:
        j_a2a(jnp.asarray(X), jnp.asarray(L6), _j(P6), _j_tanh, mesh=mesh,
              top_k=2)
    for r in world["fallback"]:
        assert r["a2a_6"]["shape"] == (T, H)
        # the fallback's warning, then the replicated dispatch's; the JAX
        # package's words up to its "device", which is a rank here
        assert len(r["a2a_6"]["warned"]) == len(jw) == 2
        for got, want in zip(r["a2a_6"]["warned"], jw):
            head = str(want.message).split(" (full")[0]
            assert got.startswith(head.split(" on every device")[0])
        assert "preconditions failed" in r["a2a_6_strict"]["error"]
        assert "tokens=30" in r["a2a_tokens_strict"]["error"]
        assert r["a2a_clean"] == {"shape": (T, H), "warned": []}
        assert len(r["replicated_6"]["warned"]) == 1
        assert "replicate" in r["replicated_6"]["warned"][0]
        assert "requires precomputed `topk`" in r["aux_without_topk"]


# -- Mixtral ------------------------------------------------------------------


def _jax_mixtral(params, axes, fp8=False):
    """The JAX Mixtral with moe_impl="a2a" on an `expert` mesh (its
    process state's), then its loss gradients."""
    from accelerate_tpu.state import PartialState as JState

    cfg = jm.MixtralConfig(**MIXTRAL)
    JState._reset_state()
    JState().set_mesh(jmesh(axes))
    try:
        ids = jnp.asarray(MIXTRAL_IDS)
        p = _j(params)
        logits, aux = jm.forward(cfg, p, ids)
        loss, grads = jax.value_and_grad(
            lambda p: jm.causal_lm_loss(cfg, p, {"input_ids": jnp.asarray(
                LOSS_IDS)}))(p)
        out = {"logits": np.asarray(logits), "aux": float(aux),
               "loss": float(loss), "grads": grads}
        if fp8:
            f_logits, _, new = jm.forward(cfg, p, ids,
                                          fp8_state=jm.init_fp8_state(cfg))
            out["fp8_logits"] = np.asarray(f_logits)
            out["fp8_scales"] = {
                n: (np.asarray(new["layers"]["moe"][n]["x"].scale),
                    np.asarray(new["layers"]["moe"][n]["w"].scale))
                for n in ("gate_proj", "up_proj", "down_proj")}
        return out
    finally:
        JState._reset_state()


def _flat(tree, prefix=""):
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            out.update(_flat(sub, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(sub)
    return out


@pytest.mark.parametrize("mesh", ["expert4", "expert2"])
def test_mixtral_a2a_matches_jax_mixtral(world, mixtral_params, mesh):
    """Mixtral with moe_impl="a2a" on an `expert` line of 4 and on lines
    of 2, at the default capacity (per-source drops included): logits,
    aux loss, loss and every gradient == the JAX Mixtral's a2a on a mesh
    with the same `expert` size; with each rank's block of the experts
    (the planner's) and with `sequence_parallel`, the same logits. On
    `{expert: 2, data: 2}` each batch line (the two `data` ranks of an
    `expert` index) holds one row of the global batch: a rank's logits
    are the JAX logits' rows, and the line's mean of the ranks' losses
    and gradients is the JAX loss and gradient of the global batch."""
    axes, name = {"expert4": ({"expert": 4, "data": 2}, "mixtral"),
                  "expert2": ({"expert": 2, "data": 4}, "mixtral_e2")}[mesh]
    want = _jax_mixtral(mixtral_params, axes)
    flat = _flat(want["grads"])
    n = axes["expert"]
    ranks = world[name]
    for r in ranks:
        size, index, line = r["line"]
        b = want["logits"].shape[0] // size
        np.testing.assert_allclose(r["logits"],
                                   want["logits"][index * b:(index + 1) * b],
                                   atol=1e-4)
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=1e-5)
        np.testing.assert_allclose(r["logits_sharded"], r["logits"],
                                   atol=1e-6)
        np.testing.assert_allclose(r["logits_sp"], r["logits"], atol=0)
        assert r["expert_shape"] == (MIXTRAL["num_hidden_layers"],
                                     MIXTRAL["num_local_experts"] // n,
                                     MIXTRAL["hidden_size"],
                                     MIXTRAL["intermediate_size"])
        # the batch line's mean: the train step's average over the line
        np.testing.assert_allclose(
            np.mean([ranks[q]["loss"] for q in line]), want["loss"],
            rtol=1e-5)
        assert set(r["grads"]) == set(flat)
        for leaf, g in flat.items():
            mean = np.mean([ranks[q]["grads"][leaf] for q in line], axis=0)
            scale = max(float(np.abs(g).max()), 1e-30)
            assert np.abs(mean - g).max() <= 1e-4 * scale, leaf


def test_mixtral_fp8_a2a_matches_jax(world, mixtral_params):
    """fp8 through the a2a dispatch on a line of 4: logits and the expert
    metas' new scales (amaxes maxed over experts, then ranks) == the JAX
    Mixtral's."""
    want = _jax_mixtral(mixtral_params, {"expert": 4, "data": 2}, fp8=True)
    for r in world["mixtral"]:
        np.testing.assert_allclose(r["fp8_logits"], want["fp8_logits"],
                                   atol=5e-3)
        for n, (xs, ws) in want["fp8_scales"].items():
            np.testing.assert_allclose(r["fp8_scales"][n][0], xs, rtol=1e-5)
            np.testing.assert_allclose(r["fp8_scales"][n][1], ws, rtol=1e-5)


# -- one process --------------------------------------------------------------


def test_off_mesh_a2a_is_the_sort_dispatch():
    """With no `expert` axis, the a2a entry point runs the replicated
    sort dispatch over every expert, as the JAX package's does, and
    warns nothing."""
    import torch

    from accelerate_tpu_torch.parallel import expert_parallel_moe_a2a
    from accelerate_tpu_torch.state import ProcessMesh

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = expert_parallel_moe_a2a(
            torch.from_numpy(X), torch.from_numpy(LOGITS),
            {"w": torch.from_numpy(PARAMS["w"])},
            lambda p, xs: torch.tanh(xs @ p["w"]),
            mesh=ProcessMesh({"data": 1}), capacity_factor=1.25, top_k=2)
    want = _jax_moe(j_a2a, {"data": 8}, 2, 1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL)
