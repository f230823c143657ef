"""The port's MoE (`parallel/moe.py`'s sort dispatch, `models/mixtral.py`)
against the JAX package's, on the same seeded numpy inputs.

Tolerances, with their reasons:
- the sort dispatch's buffers, destinations and valid flags, the top-k
  ids (ties included) and the dropped fraction: equal (index arithmetic
  and gathers are exact);
- the combine: rtol 1e-6 (a k-term f32 sum);
- Mixtral logits: atol 1e-4, aux loss rtol 1e-5, loss rtol 1e-5,
  gradients within 1e-4 of each leaf's largest element (f32 products in
  another summation order through two layers);
- fp8 losses: atol 5e-3 (tests/test_torch_fp8.py gives the reason).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import mixtral as jm
from accelerate_tpu.parallel import moe as jmoe
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models import mixtral as tm
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.optimizers import adamw
from accelerate_tpu_torch.parallel import moe as tmoe
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.training import TrainState

IMPLS = {"dense": {"moe_impl": "dense"},
         "sparse_onehot": {"moe_impl": "sparse", "capacity_factor": 1.0},
         "sparse_sort": {"moe_impl": "sparse", "capacity_factor": 1.0}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assignments(rng, T, k, E, hot=None):
    """[T, k] distinct expert ids per token; with `hot`, most tokens pick
    that expert first, so it overflows a small capacity."""
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    if hot is not None:
        rows = rng.random(T) < 0.7
        for t in np.nonzero(rows)[0]:
            if hot not in idx[t]:
                idx[t, 0] = hot
    return idx.astype(np.int32)


@pytest.mark.parametrize("capacity", [2, 5, 40], ids=["drops", "some",
                                                      "ample"])
def test_sort_dispatch_and_combine_equal_jax(capacity):
    rng = np.random.default_rng(0)
    T, H, E, k = 20, 8, 4, 2
    x = rng.normal(size=(T, H)).astype(np.float32)
    idx = _assignments(rng, T, k, E, hot=1)
    gate = rng.random((T, k)).astype(np.float32)
    bj, ij = jmoe.sort_dispatch(jnp.asarray(x), jnp.asarray(idx),
                                jnp.asarray(gate), E, capacity)
    bt, it = tmoe.sort_dispatch(torch.tensor(x), torch.tensor(idx),
                                torch.tensor(gate), E, capacity)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(it[0].numpy(), np.asarray(ij[0]))
    np.testing.assert_array_equal(it[1].numpy(), np.asarray(ij[1]))
    y = rng.normal(size=(E, capacity, H)).astype(np.float32)
    np.testing.assert_allclose(
        tmoe.sort_combine(torch.tensor(y), it).numpy(),
        np.asarray(jmoe.sort_combine(jnp.asarray(y), ij)), rtol=1e-6)
    np.testing.assert_array_equal(
        float(tmoe._dropped_fraction(it)),
        float(jmoe._dropped_fraction(ij)))
    if capacity == 2:
        assert float(tmoe._dropped_fraction(it)) > 0


def test_route_topk_orders_ties_as_jax():
    """Exact ties keep the lower expert index first, as `lax.top_k`."""
    logits = np.array([[0.5, 2.0, 2.0, 1.0, 2.0],
                       [1.0, 1.0, 1.0, 1.0, 1.0],
                       [3.0, -1.0, 3.0, 0.0, 0.0]], np.float32)
    gj, ij = jmoe._route_topk(jnp.asarray(logits), 3)
    gt, it = tmoe._route_topk(torch.tensor(logits), 3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


def _models(seed=0, **overrides):
    cj = jm.MixtralConfig.tiny(**overrides)
    ct = tm.MixtralConfig.tiny(**overrides)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(cj, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    tree["layers"]["input_layernorm"]["scale"] = (
        1 + rng.normal(size=tree["layers"]["input_layernorm"]["scale"].shape)
        * 0.1).astype(np.float32)
    return (cj, ct, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def _force_sort(monkeypatch, impl):
    if impl == "sparse_sort":
        monkeypatch.setattr(jm, "_ONEHOT_DISPATCH_MAX_ELEMENTS", 0)
        monkeypatch.setattr(tm, "_ONEHOT_DISPATCH_MAX_ELEMENTS", 0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("impl", list(IMPLS))
def test_mixtral_logits_and_aux_match_jax(impl, monkeypatch):
    _force_sort(monkeypatch, impl)
    cj, ct, pj, pt = _models(**IMPLS[impl])
    ids = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32)
    lj, aj = jm.forward(cj, pj, jnp.asarray(ids))
    lt, at = tm.forward(ct, pt, torch.tensor(ids))
    assert lt.dtype == torch.float32 and lt.shape == (2, 16, 256)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    assert float(at) > 0


@pytest.mark.parametrize("impl", list(IMPLS))
def test_mixtral_loss_and_gradients_match_jax(impl, monkeypatch):
    _force_sort(monkeypatch, impl)
    cj, ct, pj, pt = _models(seed=2, remat=impl == "dense", **IMPLS[impl])
    ids = np.random.default_rng(2).integers(0, 256, (2, 13)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    batch_j = {"input_ids": jnp.asarray(ids),
               "attention_mask": jnp.asarray(mask)}
    lj, gj = jax.value_and_grad(lambda p: jm.causal_lm_loss(cj, p,
                                                            batch_j))(pj)
    leaves = dict(_flat(pt))
    for t in leaves.values():
        t.requires_grad_(True)
    lt = tm.causal_lm_loss(ct, pt, {"input_ids": torch.tensor(ids),
                                    "attention_mask": torch.tensor(mask)})
    grads = dict(zip(leaves, torch.autograd.grad(lt, list(leaves.values()))))
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    for path, g in _flat(jax.tree_util.tree_map(np.asarray, gj)):
        scale = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(grads[path].numpy(), g, rtol=0,
                                   atol=1e-4 * scale, err_msg=path)


def test_onehot_and_sort_dispatch_agree(monkeypatch):
    """Both sparse dispatches give the same output (same assignment
    priority, so the same drops): the size-based switch never changes
    results (test_models' case, on the port)."""
    _, ct, _, pt = _models(moe_impl="sparse", capacity_factor=1.0)
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                        .manual_seed(1))
    onehot, aux1 = tm.forward(ct, pt, ids)
    monkeypatch.setattr(tm, "_ONEHOT_DISPATCH_MAX_ELEMENTS", 0)
    sort, aux2 = tm.forward(ct, pt, ids)
    np.testing.assert_allclose(onehot.numpy(), sort.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(aux1), float(aux2), rtol=1e-6)


@pytest.mark.parametrize("sort", [False, True], ids=["onehot", "sort"])
def test_sparse_at_full_capacity_equals_dense(sort, monkeypatch):
    """With a capacity that drops nothing, sparse == dense."""
    if sort:
        monkeypatch.setattr(tm, "_ONEHOT_DISPATCH_MAX_ELEMENTS", 0)
    _, dense_cfg, _, pt = _models(moe_impl="dense")
    sparse_cfg = dataclasses.replace(dense_cfg, moe_impl="sparse",
                                     capacity_factor=4.0)
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                        .manual_seed(3))
    d_logits, d_aux = tm.forward(dense_cfg, pt, ids)
    s_logits, s_aux = tm.forward(sparse_cfg, pt, ids)
    np.testing.assert_allclose(s_logits.numpy(), d_logits.numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(s_aux), float(d_aux), rtol=1e-5)


def test_sparse_drops_over_capacity_gracefully():
    _, ct, _, pt = _models(seed=1, moe_impl="sparse", capacity_factor=0.5)
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                        .manual_seed(1))
    logits, aux = tm.forward(ct, pt, ids)
    dense, _ = tm.forward(dataclasses.replace(ct, moe_impl="dense"), pt, ids)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)
    assert not torch.allclose(logits, dense, atol=1e-4)


@pytest.mark.parametrize("impl", ["dense", "sparse_sort"])
def test_mixtral_fp8_loss_matches_jax(impl, monkeypatch):
    _force_sort(monkeypatch, impl)
    cj, ct, pj, pt = _models(seed=4, **IMPLS[impl])
    ids = np.random.default_rng(4).integers(0, 256, (2, 9)).astype(np.int32)
    lj, new_j = jm.causal_lm_loss(cj, pj, {"input_ids": jnp.asarray(ids)},
                                  fp8_state=jm.init_fp8_state(cj))
    lt, new_t = tm.causal_lm_loss(ct, pt, {"input_ids": torch.tensor(ids)},
                                  fp8_state=tm.init_fp8_state(
                                      ct, device="cpu"))
    np.testing.assert_allclose(float(lt), float(lj), rtol=0, atol=5e-3)
    for role in ("gate_proj", "up_proj", "down_proj"):
        a = new_j["layers"]["moe"][role]["w"]
        b = new_t["layers"]["moe"][role]["w"]
        np.testing.assert_array_equal(b.amax_history.numpy(),
                                      np.asarray(a.amax_history))


def test_sparse_mixtral_trains():
    PartialState._reset_state()
    try:
        cfg = tm.MixtralConfig.tiny(moe_impl="sparse")
        acc = Accelerator(cpu=True)
        state = acc.prepare(TrainState.create(
            apply_fn=None, params=tm.init_params(cfg, 2, device="cpu"),
            tx=adamw(1e-2, weight_decay=0.0)))
        ids = torch.randint(0, 256, (4, 17), generator=torch.Generator()
                            .manual_seed(2))
        step = acc.train_step(lambda p, b: tm.causal_lm_loss(cfg, p, b))
        losses = []
        for _ in range(5):
            state, m = step(state, {"input_ids": ids})
            losses.append(float(m["loss"]))
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    finally:
        PartialState._reset_state()


def test_unported_moe_surface_raises_and_names_its_item():
    """Mixtral's a2a dispatch, `sequence_parallel` and the
    expert-parallel entry points are ported (queue 1 item 6b, part 2;
    `tests/test_torch_expert_parallel.py` runs them on `expert` lines).
    In a process with no `expert` axis the a2a dispatch is the sort
    dispatch over every expert, as the JAX package's is, and
    `sequence_parallel` changes no value."""
    cfg = tm.MixtralConfig.tiny(moe_impl="a2a")
    jcfg = jm.MixtralConfig.tiny(moe_impl="a2a")
    jp = jm.init_params(jcfg, jax.random.key(3))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8))
    got, aux = tm.forward(cfg, params, torch.from_numpy(ids))
    want, jaux = jm.forward(jcfg, jp, jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    sp, _ = tm.forward(dataclasses.replace(cfg, moe_impl="dense",
                                           sequence_parallel=True),
                       params, torch.from_numpy(ids))
    dense, _ = tm.forward(dataclasses.replace(cfg, moe_impl="dense"),
                          params, torch.from_numpy(ids))
    torch.testing.assert_close(sp, dense, atol=0, rtol=0)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (8, 4)).astype(np.float32))
    logits = torch.zeros((8, 2))
    w = {"w": torch.stack([torch.eye(4), 2 * torch.eye(4)])}
    for fn in (tmoe.expert_parallel_moe, tmoe.expert_parallel_moe_a2a):
        out = fn(x, logits, w, lambda p, xs: xs @ p["w"],
                 capacity_factor=8.0)
        # equal logits: top-1 keeps the lower expert (the identity)
        torch.testing.assert_close(out, x * 0.5, atol=1e-6, rtol=0)


def test_init_params_has_the_reference_tree():
    cj, ct = jm.MixtralConfig.tiny(), tm.MixtralConfig.tiny()
    ref = {p: np.shape(v) for p, v in _flat(jax.tree_util.tree_map(
        np.asarray, jm.init_params(cj, jax.random.key(0))))}
    got = {p: tuple(v.shape) for p, v in _flat(tm.init_params(
        ct, 0, device="cpu"))}
    assert got == ref
    assert tm.MixtralConfig.mixtral_8x7b(num_hidden_layers=2)._as_llama() \
        .head_dim == 128


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    cfg = tm.MixtralConfig.tiny()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tm.init_params(cfg, 0),
                 lambda: tm.init_fp8_state(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
