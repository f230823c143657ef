"""The training half of the port against the JAX package, on the same
numpy inputs: the loss functions, `causal_lm_loss` values and gradients
(full and chunked paths, with and without a padding mask, einsum and
flash backends), remat, the optimizers against optax, and the clip.

Tolerances: f32 throughout; 1e-5 absolute on losses and gradients (two
f32 summation orders over a tiny model), 1e-6 on optimizer updates."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import training as jt
from accelerate_tpu.models import common as jc
from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch import optimizers as to
from accelerate_tpu_torch import training as tt
from accelerate_tpu_torch.models import common as tc
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.ops import flash_attention as tf

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


# --- loss functions ---------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_token_nll_matches_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    _close(tc.token_nll(torch.tensor(logits), torch.tensor(labels),
                        smoothing),
           jc.token_nll(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    # bf16 logits are upcast before the softmax in both
    _close(tc.token_nll(torch.tensor(logits).bfloat16(),
                        torch.tensor(labels), smoothing),
           jc.token_nll(jnp.asarray(logits, jnp.bfloat16),
                        jnp.asarray(labels), smoothing))


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_and_shifted_masks_match_jax(with_mask):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 6, 9)).astype(np.float32)
    labels = rng.integers(0, 9, (3, 6)).astype(np.int32)
    pad = np.ones((3, 7), np.int32)
    pad[1, :2] = 0
    pad[2, 5:] = 0
    am_t, w_t = tc.shifted_padding_masks(torch.tensor(pad)
                                         if with_mask else None)
    am_j, w_j = jc.shifted_padding_masks(jnp.asarray(pad)
                                         if with_mask else None)
    if with_mask:
        np.testing.assert_array_equal(am_t.numpy(), np.asarray(am_j))
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
        assert w_t.dtype == torch.float32
    else:
        assert am_t is None and w_t is None and am_j is None
    _close(tc.cross_entropy_loss(torch.tensor(logits), torch.tensor(labels),
                                 w_t, 0.05),
           jc.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                 w_j, 0.05))


def test_layer_norm_and_count_params_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32) * 4 + 1
    s = rng.normal(size=(16,)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    _close(tc.layer_norm(torch.tensor(x), torch.tensor(s), torch.tensor(b)),
           jc.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    cfg = jl.LlamaConfig.tiny()
    pj = jl.init_params(cfg, jax.random.key(0))
    pt = tl.init_params(tl.LlamaConfig.tiny(), 0, device="cpu")
    assert tc.count_params(pt) == jc.count_params(pj)


# --- causal_lm_loss ---------------------------------------------------------


def _setup(backend="einsum", seed=0, **overrides):
    cfg_j = jl.LlamaConfig.tiny(attention_backend=backend, **overrides)
    cfg_t = tl.LlamaConfig.tiny(attention_backend=backend, **overrides)
    pj = jl.init_params(cfg_j, jax.random.key(seed))
    pn = jax.tree_util.tree_map(np.asarray, pj)
    return cfg_j, cfg_t, pj, pn


def _leaves_t(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_t(tree[k])]
    return [tree]


def _torch_loss_and_grads(cfg_t, pn, batch, **kw):
    pt = params_from_numpy(pn, device="cpu")
    leaves = _leaves_t(pt)
    for p in leaves:
        p.requires_grad_(True)
    loss = tl.causal_lm_loss(cfg_t, pt, batch, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss, grads


def _batch(seed, with_mask, b=2, s=17):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, s)).astype(np.int32)
    batch = {"input_ids": ids}
    if with_mask:
        m = np.ones((b, s), np.int32)
        m[1, :3] = 0      # a left-padded row: its first queries see nothing
        m[0, 14:] = 0     # a right-padded row
        batch["attention_mask"] = m
    return batch


@pytest.mark.parametrize("backend", ["einsum", "flash"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("chunk", [None, 4], ids=["full", "chunked"])
def test_causal_lm_loss_and_grads_match_jax(backend, with_mask, chunk):
    """Value and every parameter's gradient; `chunk=4` runs the chunked
    path (16 labels in 4 checkpointed chunks)."""
    cfg_j, cfg_t, pj, pn = _setup(backend)
    batch = _batch(3, with_mask)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: torch.tensor(v) for k, v in batch.items()}
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jl.causal_lm_loss(cfg_j, p, bj, loss_chunk_size=chunk))(pj)
    loss_t, grads_t = _torch_loss_and_grads(cfg_t, pn, bt,
                                            loss_chunk_size=chunk)
    _close(loss_t, loss_j)
    flat_j = [np.asarray(x) for _, x in sorted(
        jax.tree_util.tree_leaves_with_path(grads_j),
        key=lambda kv: jax.tree_util.keystr(kv[0]))]
    assert len(flat_j) == len(grads_t)
    for gt, gj in zip(grads_t, flat_j):
        _close(gt, gj)


def test_pick_chunk_matches_jax():
    for S, target in ((2048, 261), (16, 4), (17, 4), (100, 7), (8, 9),
                      (97, 50)):
        assert tl._pick_chunk(S, target) == jl._pick_chunk(S, target)
    # the slice's shapes: batch 2 at llama3's vocabulary -> 256-row chunks
    assert tl._pick_chunk(2048, 2**26 // (2 * 128256)) == 256


def test_head_cotangent_splits_exactly_into_bf16_parts():
    """The bf16 head's backward on the card (`_HeadF32`) multiplies the
    three bf16 parts of the f32 cotangent. They sum to it exactly, so
    their products (exact in f32, taken here on the CPU) give the
    reference's transpose of the bf16 head, `jax.vjp` of a bf16 dot with
    f32 output: dx and dw bit-equal after the rounding to bf16 but where
    f32 summation order tips a rounding (at least 99% of elements)."""
    rng = np.random.default_rng(0)
    n, h, v = 14, 128, 512
    g = (rng.normal(size=(n, v))
         * np.exp2(rng.integers(-60, 10, (n, v)))).astype(np.float32)
    parts = tl._split_bf16(torch.tensor(g))
    assert parts.dtype == torch.bfloat16 and parts.shape == (3 * n, v)
    assert torch.equal(parts.double().view(3, n, v).sum(0),
                       torch.tensor(g).double())
    g = rng.normal(size=(n, v)).astype(np.float32)
    parts = tl._split_bf16(torch.tensor(g)).float()
    x = jnp.asarray(rng.normal(size=(n, h)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(h, v)) * 0.05, jnp.bfloat16)
    _, vjp = jax.vjp(
        lambda x, w: jnp.dot(x, w, preferred_element_type=jnp.float32), x, w)
    dx_j, dw_j = (np.asarray(t.astype(jnp.float32))
                  for t in vjp(jnp.asarray(g)))
    xt, wt = (torch.tensor(np.asarray(t.astype(jnp.float32))) for t in (x, w))
    dx = (parts @ wt.t()).view(3, n, h).sum(0).bfloat16().float().numpy()
    dw = (xt.t().repeat(1, 3) @ parts).bfloat16().float().numpy()
    assert (dx == dx_j).mean() >= 0.99 and (dw == dw_j).mean() >= 0.99


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("backend", ["einsum", "flash"])
def test_remat_equals_no_remat(policy, backend, monkeypatch):
    """Same loss and grads; under remat the attention forward reruns in
    backward (twice per layer), which is what the flash kernel's launch
    count on the card shows."""
    calls = []
    plain = tf.flash_forward_reference

    def counting(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(tf, "flash_forward_reference", counting)
    _, cfg_t, _, pn = _setup(backend)
    batch = {k: torch.tensor(v) for k, v in _batch(4, True).items()}
    loss0, g0 = _torch_loss_and_grads(cfg_t, pn, batch)
    n0 = len(calls)
    cfg_r = tl.LlamaConfig.tiny(attention_backend=backend, remat=True,
                                remat_policy=policy)
    loss1, g1 = _torch_loss_and_grads(cfg_r, pn, batch)
    torch.testing.assert_close(loss1, loss0, atol=1e-6, rtol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    layers = cfg_t.num_hidden_layers
    if backend == "flash":
        assert n0 == layers and len(calls) - n0 == 2 * layers


def test_remat_policy_and_unported_features_raise():
    _, _, _, pn = _setup()
    pt = params_from_numpy(pn, device="cpu")
    ids = {"input_ids": torch.zeros((1, 5), dtype=torch.int64)}
    with pytest.raises(ValueError, match="remat_policy"):
        tl.causal_lm_loss(tl.LlamaConfig.tiny(remat=True,
                                              remat_policy="nothing"),
                          pt, ids)
    with pytest.raises(NotImplementedError, match="parallelism slice"):
        tl.causal_lm_loss(tl.LlamaConfig.tiny(sequence_parallel=True), pt,
                          ids)
    with pytest.raises(NotImplementedError, match="fp8 slice"):
        tl.causal_lm_loss(tl.LlamaConfig.tiny(), pt, ids, fp8_state={})


def test_attention_backend_rule_is_the_references():
    for on_cuda in (False, True):
        for decoding in (False, True):
            for s in (512, 1023, 1024, 4096):
                got = tl.select_attention_backend(
                    "auto", on_cuda=on_cuda, decoding=decoding, seq_len=s)
                want = jl.select_attention_backend(
                    "auto", on_tpu=on_cuda, decoding=decoding, seq_len=s)
                assert got == want
    assert tl.select_attention_backend("flash", on_cuda=False,
                                       decoding=False, seq_len=8) == "flash"
    with pytest.raises(ValueError, match="unknown"):
        tl.select_attention_backend("nope", on_cuda=False, decoding=False,
                                    seq_len=8)


# --- optimizers and the clip ------------------------------------------------


def _toy_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "inner": {"b": rng.normal(size=(3,)).astype(np.float32),
                      "s": rng.normal(size=()).astype(np.float32)}}


OPTIMIZERS = {
    "adamw": (lambda m: m.adamw(3e-2), lambda: optax.adamw(3e-2)),
    "adamw_decay_0.1": (lambda m: m.adamw(3e-2, weight_decay=0.1),
                        lambda: optax.adamw(3e-2, weight_decay=0.1)),
    "adamw_schedule": (lambda m: m.adamw(lambda c: 1e-2 * (c + 1)),
                       lambda: optax.adamw(lambda c: 1e-2 * (c + 1))),
    "adam": (lambda m: m.adam(1e-2, b1=0.8, eps=1e-6),
             lambda: optax.adam(1e-2, b1=0.8, eps=1e-6)),
    "sgd": (lambda m: m.sgd(0.1), lambda: optax.sgd(0.1)),
    "sgd_nesterov": (lambda m: m.sgd(0.1, momentum=0.9, nesterov=True),
                     lambda: optax.sgd(0.1, momentum=0.9, nesterov=True)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax_over_five_updates(name):
    make_t, make_j = OPTIMIZERS[name]
    tx_t, tx_j = make_t(to), make_j()
    p_np = _toy_tree(0)
    pj = jax.tree_util.tree_map(jnp.asarray, p_np)
    pt = params_from_numpy(p_np, device="cpu")
    sj, st = tx_j.init(pj), tx_t.init(pt)
    for i in range(5):
        g_np = _toy_tree(10 + i)
        uj, sj = tx_j.update(jax.tree_util.tree_map(jnp.asarray, g_np), sj,
                             pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = tx_t.update(params_from_numpy(g_np, device="cpu"), st, pt)
        pt = to.apply_updates(pt, ut)
    flat_t = {"w": pt["w"], "b": pt["inner"]["b"], "s": pt["inner"]["s"]}
    flat_j = {"w": pj["w"], "b": pj["inner"]["b"], "s": pj["inner"]["s"]}
    for k in flat_t:
        _close(flat_t[k], flat_j[k], atol=1e-6)


def test_adamw_matches_torch_adamw_with_optax_decay():
    """Bias correction and the place of eps agree with torch.optim.AdamW
    when its weight decay is set to optax's 1e-4 (torch's default is
    1e-2). Within 5e-6: torch folds the bias corrections into a step size
    and the denominator, another rounding order (a few f32 ulps of these
    O(1) params per update)."""
    p_np = _toy_tree(1)
    pt = params_from_numpy(p_np, device="cpu")
    ref = [torch.tensor(p_np["w"], requires_grad=True)]
    opt = torch.optim.AdamW(ref, lr=3e-2, weight_decay=1e-4)
    tx = to.adamw(3e-2)
    state = tx.init(pt)
    for i in range(5):
        g = _toy_tree(20 + i)
        ref[0].grad = torch.tensor(g["w"])
        opt.step()
        u, state = tx.update(params_from_numpy(g, device="cpu"), state, pt)
        to.apply_updates(pt, u)
    torch.testing.assert_close(pt["w"], ref[0].detach(), atol=5e-6, rtol=0)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g_np = _toy_tree(3)
    ct, nt = tt.clip_by_global_norm(params_from_numpy(g_np, device="cpu"),
                                    max_norm)
    cj, nj = jt.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g_np), max_norm)
    _close(nt, nj)
    _close(tt.global_norm(ct), optax.global_norm(cj))
    _close(ct["w"], cj["w"])


def test_cast_floating_keeps_int_leaves_and_grads_flow_to_f32():
    p = torch.ones(3, requires_grad=True)
    tree = {"p": p, "ids": torch.arange(3), "n": 5}
    cast = tt.cast_floating(tree, torch.bfloat16)
    assert cast["p"].dtype == torch.bfloat16
    assert cast["ids"].dtype == torch.int64 and cast["n"] == 5
    (g,) = torch.autograd.grad(cast["p"].float().sum() * 3, p)
    assert g.dtype == torch.float32 and torch.equal(g, torch.full((3,), 3.0))


@pytest.mark.parametrize("finite", [True, False])
def test_dynamic_loss_scale_matches_jax(finite):
    j = jt.DynamicLossScale.create()
    t = tt.DynamicLossScale.create()
    j = dataclasses.replace(j, growth_interval=2)
    t = dataclasses.replace(t, growth_interval=2)
    for _ in range(3):
        j = j.update(jnp.bool_(finite))
        t = t.update(torch.tensor(finite))
        assert float(t.scale) == float(j.scale)
        assert int(t.growth_tracker) == int(j.growth_tracker)

