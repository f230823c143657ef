"""The port's fp8 training path (`ops/fp8.py`, the llama fp8 forward, the
Accelerator's fp8 step and kwargs handlers) against the JAX package on
the CPU, from the same numpy inputs (seeded). The products run through
`fp8_gemm_reference`, the plain version the card's `_scaled_mm` is held
to.

Tolerances, with their reasons:
- the e4m3 and e5m2 casts, `update_meta`, the metas' windows and scales:
  bit-equal (a clip, a round-to-nearest-even conversion, a max and a
  true division are exact in both frameworks);
- `fp8_dot`/`fp8_dense` outputs and gradients: the fp8 operands are the
  same bits and their products are exact in f32, so only the order of
  the f32 accumulation differs: f32 results within 1e-5 of the largest
  element, bf16 results within one bf16 rounding (2^-8 relative) of it;
- the llama step, 3 AdamW steps: after step 1 every w meta and layer 0's
  x metas of q/k/v/o/gate/up are bit-equal; layer 0's down_proj x meta
  (the amax of silu(gate) * up) within 2e-2, because the JAX package's
  bf16 silu rounds otherwise than torch's (XLA's logistic); losses
  within 5e-3: a bf16 rounding that differs moves an fp8 element across
  a rounding boundary by a whole fp8 step (2^-3 relative for e4m3), so
  the two runs part faster than bf16 runs do (tests/test_torch_train_step.py
  allows 2e-3 there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import accelerate_tpu as at
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import fp8 as jf
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu_torch import optimizers as to
from accelerate_tpu_torch import training as tt
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_numpy, \
    params_to_numpy
from accelerate_tpu_torch.ops import fp8 as tf
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.utils import dataclasses as tdc

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


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _meta_pair(jm, tm):
    """Whether a JAX and a port Fp8Meta hold the same bits."""
    return (np.array_equal(np.asarray(jm.scale), tm.scale.numpy())
            and np.array_equal(np.asarray(jm.amax_history),
                               tm.amax_history.numpy()))


def _both(a: np.ndarray, dtype):
    """One numpy array as a JAX array and a CPU tensor of `dtype`."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.tensor(np.asarray(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else t.dtype)


# --- casts and metas ---------------------------------------------------------


@pytest.mark.parametrize("fmt", ["E4M3", "E5M2"])
def test_casts_are_bit_equal_to_jax(fmt):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4096)
         * 10.0 ** rng.uniform(-9, 5, size=4096)).astype(np.float32)
    x[:6] = [0.0, -0.0, 448.0, -57344.0, 1e-12, 3e38]
    for scale in (1.0, 448.0 / 3.7, 0.013, 57344.0 / 123.0, 2.0 ** -20):
        jm = jf.Fp8Meta(jnp.float32(scale), jnp.zeros(4))
        tm = tf.Fp8Meta(torch.tensor(scale, dtype=torch.float32),
                        torch.zeros(4))
        for dtype in (jnp.float32, jnp.bfloat16):
            xj, xt = _both(x, dtype)
            a = jf.fp8_cast(xj, jm, fmt)
            b = tf.fp8_cast(xt, tm, fmt)
            assert b.dtype == (torch.float8_e4m3fn if fmt == "E4M3"
                               else torch.float8_e5m2)
            np.testing.assert_array_equal(_bits(b), _bits(a))


@pytest.mark.parametrize("margin", [0, 2])
@pytest.mark.parametrize("fmt", ["E4M3", "E5M2"])
def test_update_meta_is_bit_equal_to_jax(fmt, margin):
    jm, tm = jf.Fp8Meta.init(4), tf.Fp8Meta.init(4, device="cpu")
    for amax in (2.0, 8.0, 0.0, 3.3, 1e-30, 7e4, 0.1):
        jm = jf.update_meta(jm, jnp.float32(amax), fmt, margin)
        tm = tf.update_meta(tm, torch.tensor(amax), fmt, margin)
        assert _meta_pair(jm, tm)
    assert float(tm.amax_history[0]) == pytest.approx(0.1)
    # an empty window keeps the unit scale
    empty = tf.update_meta(tf.Fp8Meta.init(3, device="cpu"), 0.0)
    assert float(empty.scale) == 1.0


def test_fp8_dot_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    jm = (jf.Fp8Meta.init(), jf.Fp8Meta.init())
    tm = (tf.Fp8Meta.init(device="cpu"), tf.Fp8Meta.init(device="cpu"))
    for _ in range(2):      # the second call uses the delayed scales
        oj, *jm = jf.fp8_dot(jnp.asarray(x), jnp.asarray(w), *jm,
                             out_dtype=jnp.float32)
        ot, *tm = tf.fp8_dot(torch.tensor(x), torch.tensor(w), *tm,
                             out_dtype=torch.float32)
        assert ot.dtype == torch.float32 and ot.shape == (8, 32)
        np.testing.assert_allclose(_np(ot), _np(oj), rtol=0,
                                   atol=1e-5 * np.abs(_np(oj)).max())
        assert all(_meta_pair(a, b) for a, b in zip(jm, tm))
    assert float(tm[0].scale) != 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_dense_forward_and_gradients_match_jax(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    w = (rng.normal(size=(48, 40)) * 0.1).astype(np.float32)
    c = rng.normal(size=(3, 5, 40)).astype(np.float32)
    # delayed scales of an earlier step: not 1, so the division matters
    jmeta = {"x": jf.update_meta(jf.Fp8Meta.init(), jnp.float32(3.1)),
             "w": jf.update_meta(jf.Fp8Meta.init(), jnp.float32(0.27))}
    tmeta = {"x": tf.update_meta(tf.Fp8Meta.init(device="cpu"),
                                 torch.tensor(3.1)),
             "w": tf.update_meta(tf.Fp8Meta.init(device="cpu"),
                                 torch.tensor(0.27))}
    xj, xt = _both(x, jdt)
    wj, wt = _both(w, jdt)

    def jloss(x, w):
        out, new = jf.fp8_dense(x, w, jmeta)
        return jnp.sum(out.astype(jnp.float32) * c), (out, new)

    (_, (oj, newj)), gj = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(xj, wj)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    ot, newt = tf.fp8_dense(xt, wt, tmeta)
    gt = torch.autograd.grad((ot.float() * torch.tensor(c)).sum(), (xt, wt))
    assert ot.dtype == torch.bfloat16
    assert [g.dtype for g in gt] == [xt.dtype, wt.dtype]
    for a, b in zip(gj, gt):
        assert np.asarray(a).dtype == jdt
    rel = 1e-5 if dtype == "float32" else 2.0 ** -8
    for j, t, r in ((oj, ot, 2.0 ** -8), (gj[0], gt[0], rel),
                    (gj[1], gt[1], rel)):
        np.testing.assert_allclose(_np(t), _np(j), rtol=0,
                                   atol=r * np.abs(_np(j)).max())
    assert _meta_pair(newj["x"], newt["x"])
    assert _meta_pair(newj["w"], newt["w"])


@pytest.mark.parametrize("xdim", [2, 3])
def test_fp8_expert_dense_matches_jax(xdim):
    rng = np.random.default_rng(3)
    E, T, H, F = 3, 6, 32, 24
    x = rng.normal(size=(E, T, H) if xdim == 3 else (T, H)).astype(
        np.float32)
    w = (rng.normal(size=(E, H, F)) * 0.1).astype(np.float32)
    c = rng.normal(size=(E, T, F)).astype(np.float32)
    jmeta = {"x": jf.Fp8Meta.init(), "w": jf.Fp8Meta.init()}
    tmeta = {"x": tf.Fp8Meta.init(device="cpu"),
             "w": tf.Fp8Meta.init(device="cpu")}

    def jloss(x, w):
        out, new = jf.fp8_expert_dense(x, w, jmeta)
        return jnp.sum(out.astype(jnp.float32) * c), (out, new)

    (_, (oj, newj)), gj = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    ot, newt = tf.fp8_expert_dense(xt, wt, tmeta)
    gt = torch.autograd.grad((ot.float() * torch.tensor(c)).sum(), (xt, wt))
    assert ot.shape == (E, T, F)
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=0,
                               atol=2.0 ** -8 * np.abs(_np(oj)).max())
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0,
                                   atol=1e-5 * np.abs(_np(a)).max())
    assert _meta_pair(newj["x"], newt["x"])
    assert _meta_pair(newj["w"], newt["w"])


class _ScaledMmStandIn:
    """`torch._scaled_mm`'s contract on the CPU: A row-major, B
    column-major, K and N multiples of 16, never e5m2 by e5m2, scales
    that multiply; records the shapes it was given."""

    def __init__(self):
        self.shapes = []

    def __call__(self, a, b, scale_a, scale_b, out_dtype):
        assert a.stride(1) == 1 and b.stride(0) == 1
        assert a.shape[1] % 16 == 0 and b.shape[1] % 16 == 0
        assert not (a.dtype == b.dtype == torch.float8_e5m2)
        self.shapes.append((tuple(a.shape), tuple(b.shape)))
        out = (a.float() @ b.float()) * scale_a * scale_b
        return out.to(out_dtype)


@pytest.mark.parametrize("shape", [(5, 24, 40), (16, 32, 48), (7, 3, 1)])
def test_card_gemm_pads_to_sixteen_and_slices_off(shape):
    """The card's wrapper around `_scaled_mm`, with a stand-in for it:
    K and N zero-padded to multiples of 16, the padded columns sliced
    off; the result is the plain version's up to the rounding of the
    reciprocal scales."""
    M, K, N = shape
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.normal(size=(M, K)), dtype=torch.float32).to(
        torch.float8_e5m2)
    b_t = torch.tensor(rng.normal(size=(N, K)), dtype=torch.float32).to(
        torch.float8_e4m3fn)
    sa, sb = torch.tensor(3.0), torch.tensor(0.7)
    mm = _ScaledMmStandIn()
    got = tf._scaled_gemm(a, b_t, sa, sb, torch.float32, mm=mm)
    want = tf.fp8_gemm_reference(a, b_t, sa, sb, torch.float32)
    assert got.shape == (M, N)
    assert mm.shapes == [((M, -(-K // 16) * 16),
                          (-(-K // 16) * 16, -(-N // 16) * 16))]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# --- state trees, recipes, handlers -------------------------------------------


def _tree_pairs(jtree, ttree):
    """(path, JAX leaf, port leaf) over two fp8 state trees of the same
    keys."""
    if isinstance(ttree, dict):
        assert set(jtree) == set(ttree)
        for k in ttree:
            yield from ((f"{k}.{p}", a, b)
                        for p, a, b in _tree_pairs(jtree[k], ttree[k]))
    elif ttree is None:
        assert jtree is None
    else:
        assert isinstance(ttree, tf.Fp8Meta)
        yield "scale", jtree.scale, ttree.scale
        yield "amax_history", jtree.amax_history, ttree.amax_history


def test_stacked_and_init_fp8_state_trees_match_jax():
    jcfg, tcfg = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    pairs = list(_tree_pairs(jl.init_fp8_state(jcfg),
                             tl.init_fp8_state(tcfg, device="cpu")))
    assert len(pairs) == 7 * 2 * 2
    for _, a, b in pairs:
        assert b.device.type == "cpu" and b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert pairs[1][2].shape == (tcfg.num_hidden_layers, 16)
    params = {"w": np.ones((4, 4), np.float32), "b": np.ones(4, np.float32),
              "blk": {"k": np.ones((2, 3, 5), np.float32)}}
    jstate = jf.init_fp8_state(jax.tree_util.tree_map(jnp.asarray, params))
    tstate = tf.init_fp8_state(params_from_numpy(params, device="cpu"))
    assert tstate["b"] is None
    for _, a, b in _tree_pairs(jstate, tstate):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the numpy bridge carries a JAX fp8 state across and back
    bridged = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    for _, a, b in _tree_pairs(jstate, bridged):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    back = params_to_numpy(bridged)
    for _, a, b in _tree_pairs(jstate, back):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_fp8_recipe_history_len_reaches_the_state_through_accelerator():
    jacc = at.Accelerator(kwargs_handlers=[
        jdc.FP8RecipeKwargs(amax_history_len=32)])
    acc = Accelerator(cpu=True, kwargs_handlers=[
        tdc.FP8RecipeKwargs(amax_history_len=32)])
    assert acc.fp8_recipe_handler.amax_history_len == \
        jacc.fp8_recipe_handler.amax_history_len == 32
    assert acc.state.fp8_recipe_handler is acc.fp8_recipe_handler
    cfg = tl.LlamaConfig.tiny()
    jst = jl.init_fp8_state(jl.LlamaConfig.tiny())
    tst = tl.init_fp8_state(cfg, device="cpu")
    for _, a, b in _tree_pairs(jst, tst):
        assert b.shape == a.shape
    assert tst["layers"]["mlp"]["up_proj"]["w"].amax_history.shape == (2, 32)
    # an explicit window wins; a generic init takes the recipe too
    assert tl.init_fp8_state(cfg, history_len=8, device="cpu")[
        "layers"]["attn"]["q_proj"]["x"].amax_history.shape == (2, 8)
    assert tf.init_fp8_state({"w": torch.ones(2, 2)})["w"][
        "x"].amax_history.shape == (32,)
    assert tf.resolve_history_len() == jf.resolve_history_len() == 32
    PartialState._reset_state()
    at.PartialState._reset_state()
    assert tf.resolve_history_len() == jf.resolve_history_len() == 16


def test_handler_records_keep_the_references_fields_and_defaults():
    for name in ("AutocastKwargs", "InitProcessGroupKwargs",
                 "FP8RecipeKwargs"):
        j, t = getattr(jdc, name)(), getattr(tdc, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert isinstance(t, tdc.KwargsHandler)
    assert tdc.FP8RecipeKwargs(margin=2).to_kwargs() == \
        jdc.FP8RecipeKwargs(margin=2).to_kwargs() == {"margin": 2}


def test_kwargs_handlers_errors_and_autocast_like_jax():
    acc = Accelerator(cpu=True, mixed_precision="bf16",
                      kwargs_handlers=[tdc.AutocastKwargs(enabled=False)])
    assert acc.compute_dtype == torch.float32
    assert acc.mixed_precision == "bf16"
    with acc.autocast():
        pass
    PartialState._reset_state()
    assert Accelerator(cpu=True, mixed_precision="fp8").compute_dtype == \
        torch.bfloat16
    for bad, match in (([object()], "Unsupported kwargs handler"),
                       ([type("Mystery", (tdc.KwargsHandler,), {})()],
                        "Unsupported kwargs handler type"),
                       ([tdc.AutocastKwargs(), tdc.AutocastKwargs()],
                        "only pass one")):
        PartialState._reset_state()
        with pytest.raises(ValueError, match=match):
            Accelerator(cpu=True, kwargs_handlers=bad)
    PartialState._reset_state()
    with pytest.raises(NotImplementedError, match="parallelism slice"):
        Accelerator(cpu=True,
                    kwargs_handlers=[tdc.InitProcessGroupKwargs()])
    PartialState._reset_state()
    acc = Accelerator(cpu=True, kwargs_handlers=[
        tdc.InitProcessGroupKwargs(timeout=None)])
    assert acc.init_handler.timeout is None


def test_adapt_history_len_truncates_newest_first_and_pads_like_jax():
    hist = np.arange(8, dtype=np.float32)
    jtree = {"w": {"x": jf.Fp8Meta(jnp.float32(3.0), jnp.asarray(hist))}}
    ttree = {"w": {"x": tf.Fp8Meta(torch.tensor(3.0), torch.tensor(hist))}}
    for n in (4, 6, 8, 11):
        j = jf.adapt_history_len(jtree, n)
        t = tf.adapt_history_len(ttree, n)
        assert tf.fp8_state_history_len(t) == jf.fp8_state_history_len(j) \
            == n
        assert _meta_pair(j["w"]["x"], t["w"]["x"])
    small = tf.adapt_history_len(ttree, 4)
    grown = tf.adapt_history_len(small, 6)
    assert grown["w"]["x"].amax_history.tolist() == [0, 1, 2, 3, 0, 0]
    # "meta" tensors (a restore's like-tree) resize too
    abstract = {"w": {"x": tf.Fp8Meta(
        torch.empty((), device="meta"), torch.empty((2, 8), device="meta"))}}
    res = tf.adapt_history_len(abstract, 16)
    assert res["w"]["x"].amax_history.shape == (2, 16)
    assert res["w"]["x"].amax_history.is_meta
    assert tf.fp8_state_history_len({"b": None}) is None


# --- the llama fp8 train step ----------------------------------------------------


def _llama_runs(remat, backend, steps=3):
    kw = {"attention_backend": backend}
    if remat is not None:
        kw.update(remat=True, remat_policy=remat)
    jcfg, tcfg = jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)
    pn = jax.tree_util.tree_map(np.asarray,
                                jl.init_params(jcfg, jax.random.key(0)))
    batches = [np.random.default_rng(i).integers(0, 256, (8, 17)).astype(
        np.int32) for i in range(steps)]
    jacc = at.Accelerator(mixed_precision="fp8", gradient_clipping=1.0)
    js = at.TrainState.create(
        apply_fn=None, params=jax.tree_util.tree_map(jnp.asarray, pn),
        tx=optax.adamw(LR), fp8_state=jl.init_fp8_state(jcfg))
    jstep = jacc.train_step(lambda p, b, fp8_state=None: jl.causal_lm_loss(
        jcfg, p, b, fp8_state=fp8_state))
    acc = Accelerator(mixed_precision="fp8", gradient_clipping=1.0, cpu=True)
    ts = acc.prepare(tt.TrainState.create(
        apply_fn=None, params=params_from_numpy(pn, device="cpu"),
        tx=to.adamw(LR), fp8_state=tl.init_fp8_state(tcfg, device="cpu")))
    live = [m for _, _, m in _tree_pairs(js.fp8_state, ts.fp8_state)]
    tstep = acc.train_step(lambda p, b, fp8_state=None: tl.causal_lm_loss(
        tcfg, p, b, fp8_state=fp8_state))
    out = []
    for b in batches:
        js, jm = jstep(js, {"input_ids": jnp.asarray(b)})
        ts, tm = tstep(ts, {"input_ids": torch.tensor(b)})
        out.append((float(jm["loss"]), float(tm["loss"]),
                    jax.tree_util.tree_map(np.asarray, js.fp8_state),
                    params_to_numpy(tt.clone_tree(ts.fp8_state))))
    # the step writes the new metas into the state's own tensors
    assert all(a is b for a, (_, _, b) in zip(
        live, _tree_pairs(js.fp8_state, ts.fp8_state)))
    return out, ts


@pytest.mark.parametrize("remat,backend", [(None, "einsum"),
                                           ("dots", "einsum"),
                                           ("dots", "flash")])
def test_llama_fp8_train_step_matches_jax(remat, backend):
    runs, ts = _llama_runs(remat, backend)
    jloss, tloss = [r[0] for r in runs], [r[1] for r in runs]
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=5e-3)
    _, _, j1, t1 = runs[0]
    for group, names in (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                         ("mlp", ("gate_proj", "up_proj", "down_proj"))):
        for name in names:
            jp, tp = j1["layers"][group][name], t1["layers"][group][name]
            np.testing.assert_array_equal(tp["w"].scale, jp["w"].scale)
            np.testing.assert_array_equal(tp["w"].amax_history,
                                          jp["w"].amax_history)
            x0 = (tp["x"].scale[0], jp["x"].scale[0])
            h0 = (tp["x"].amax_history[0], jp["x"].amax_history[0])
            if name == "down_proj":
                np.testing.assert_allclose(*x0, rtol=2e-2)
                np.testing.assert_allclose(*h0, rtol=2e-2)
            else:
                np.testing.assert_array_equal(*x0)
                np.testing.assert_array_equal(*h0)
    # three steps filled three window slots; the scales moved off 1
    q = ts.fp8_state["layers"]["attn"]["q_proj"]["x"]
    assert bool((q.amax_history[:, :3] > 0).all())
    assert bool((q.amax_history[:, 3:] == 0).all())
    assert not torch.allclose(q.scale, torch.ones_like(q.scale))


def test_llama_fp8_train_step_converges():
    """The reference's convergence case: 12 AdamW(5e-3) steps on one
    batch lower the loss by more than 0.5, and the delayed scales move."""
    cfg = tl.LlamaConfig.tiny()
    acc = Accelerator(mixed_precision="fp8", cpu=True)
    ts = acc.prepare(tt.TrainState.create(
        apply_fn=None, params=tl.init_params(cfg, 0, device="cpu"),
        tx=to.adamw(5e-3), fp8_state=tl.init_fp8_state(cfg, device="cpu")))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 33))
    batch = {"input_ids": torch.tensor(ids.astype(np.int32))}
    step = acc.train_step(lambda p, b, fp8_state=None: tl.causal_lm_loss(
        cfg, p, b, fp8_state=fp8_state))
    losses = []
    for _ in range(12):
        ts, m = step(ts, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses
    scale = ts.fp8_state["layers"]["attn"]["q_proj"]["x"].scale
    assert scale.shape == (cfg.num_hidden_layers,)
    assert not torch.allclose(scale, torch.ones_like(scale))


def test_chunked_loss_and_accumulation_thread_the_metas():
    """The chunked loss path returns the new metas too, and under
    gradient accumulation the metas move on every micro-step, as in the
    reference; train_step(donate=False) leaves the input's metas."""
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, 0, device="cpu")
    ids = torch.tensor(np.random.default_rng(1).integers(0, 256, (2, 17)))
    fp8 = tl.init_fp8_state(cfg, device="cpu")
    full, nf = tl.causal_lm_loss(cfg, params, {"input_ids": ids},
                                 fp8_state=fp8)
    chunked, nc = tl.causal_lm_loss(cfg, params, {"input_ids": ids},
                                    loss_chunk_size=4, fp8_state=fp8)
    torch.testing.assert_close(chunked, full, rtol=1e-5, atol=1e-6)
    for (_, a, b) in _tree_pairs(nf, nc):
        assert torch.equal(a, b)
    acc = Accelerator(mixed_precision="fp8", cpu=True,
                      gradient_accumulation_steps=2)
    ts = acc.prepare(tt.TrainState.create(
        apply_fn=None, params=params, tx=to.adamw(LR),
        use_grad_accum_buffer=True, fp8_state=fp8))
    step = acc.train_step(lambda p, b, **kw: tl.causal_lm_loss(
        cfg, p, b, **kw))
    hist = ts.fp8_state["layers"]["mlp"]["up_proj"]["x"].amax_history
    ts, _ = step(ts, {"input_ids": ids})
    assert not acc.sync_gradients and bool((hist[:, 0] > 0).all())
    ts, _ = step(ts, {"input_ids": ids})
    assert acc.sync_gradients and bool((hist[:, 1] > 0).all())
    before = hist.clone()
    kept = acc.train_step(lambda p, b, fp8_state=None: tl.causal_lm_loss(
        cfg, p, b, fp8_state=fp8_state), donate=False)
    new, _ = kept(ts, {"input_ids": ids})
    assert torch.equal(hist, before)
    assert not torch.equal(
        new.fp8_state["layers"]["mlp"]["up_proj"]["x"].amax_history, before)


# --- the reference's hard errors -----------------------------------------------


def test_fp8_without_state_hard_errors():
    cfg = tl.LlamaConfig.tiny()
    acc = Accelerator(mixed_precision="fp8", cpu=True)
    ts = tt.TrainState.create(apply_fn=None,
                              params=tl.init_params(cfg, 0, device="cpu"),
                              tx=to.sgd(1e-3))
    step = acc.train_step(lambda p, b, fp8_state=None: tl.causal_lm_loss(
        cfg, p, b, fp8_state=fp8_state))
    with pytest.raises(ValueError, match="fp8"):
        step(ts, {"input_ids": torch.zeros((2, 9), dtype=torch.int32)})


def test_fp8_loss_fn_without_kwarg_hard_errors():
    acc = Accelerator(mixed_precision="fp8", cpu=True)
    with pytest.raises(ValueError, match="fp8"):
        acc.train_step(lambda p, b: torch.zeros(()))
    # **kwargs counts as taking the keyword
    acc.train_step(lambda p, b, **kw: torch.zeros(()))


def test_fp8_decode_is_refused_like_jax():
    jcfg, tcfg = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    ids = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="fp8"):
        jl.forward(jcfg, jl.init_params(jcfg, jax.random.key(0)),
                   jnp.asarray(ids),
                   kv_caches=jl.init_kv_caches(jcfg, 1, 8),
                   fp8_state=jl.init_fp8_state(jcfg))
    with pytest.raises(ValueError, match="fp8"):
        tl.forward(tcfg, tl.init_params(tcfg, 0, device="cpu"),
                   torch.tensor(ids),
                   kv_caches=tl.init_kv_caches(tcfg, 1, 8, device="cpu"),
                   fp8_state=tl.init_fp8_state(tcfg, device="cpu"))


def test_run_resilient_restores_the_metas_after_a_crash(tmp_path):
    """The fp8 step through `run_resilient` with async saves every 2
    steps and a crash after step 3: the resume copies the step-2 commit,
    fp8 metas included, back into the live state, and the run ends bit
    for bit where an unfaulted run ends."""
    from accelerate_tpu_torch.training import run_resilient
    from accelerate_tpu_torch.utils.other import flatten_dict

    cfg = tl.LlamaConfig.tiny()
    ids = [torch.tensor(np.random.default_rng(i).integers(0, 256, (2, 9)))
           for i in range(6)]

    def run(crash, path):
        PartialState._reset_state()
        acc = Accelerator(mixed_precision="fp8", cpu=True)
        ts = acc.prepare(tt.TrainState.create(
            apply_fn=None, params=tl.init_params(cfg, 0, device="cpu"),
            tx=to.adamw(LR), fp8_state=tl.init_fp8_state(cfg, device="cpu")))
        step = acc.train_step(lambda p, b, fp8_state=None: tl.causal_lm_loss(
            cfg, p, b, fp8_state=fp8_state))
        crashed = []

        def on_step(i, state, metrics):
            if crash and i == 3 and not crashed:
                crashed.append(i)
                raise RuntimeError("crash after step 3")

        rep = run_resilient(acc, ts, step, lambda i: {"input_ids": ids[i]},
                            6, str(path), save_every=2, keep_last_n=1,
                            install_signal_handlers=False, on_step=on_step)
        assert rep.resumes == (1 if crash else 0)
        return flatten_dict({"p": rep.state.params,
                             "f": rep.state.fp8_state})

    clean, faulted = run(False, tmp_path / "a"), run(True, tmp_path / "b")
    assert set(clean) == set(faulted)
    for k, v in clean.items():
        assert torch.equal(v, faulted[k]), k
