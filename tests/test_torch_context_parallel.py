"""The port's sequence parallelism (`accelerate_tpu_torch.parallel`: ring
and Ulysses attention, `context_attention`, llama's "ring"/"ulysses"
backends, the context-parallel plugin) against the JAX package's, on the
same numpy inputs from seeds.

One 4-rank `debug_launcher` world on the CPU (gloo) holds every
multi-rank check (`test_utils.worlds.context_parallel_forms`): `seq`
lines of 4 (`{"seq": 4}`) and of 2 (`{"seq": 2, "data": 2}`, two lines),
where each rank passes the whole tensors and gets the whole output; the
flash entry points run their plain versions on CPU tensors, and the
world counts this rank's calls of them (K1a `fwd`, K1b + K1c `bwd`).

The JAX side runs in the pytest process as `tests/test_parallel.py` runs
it, on the conftest's 8 CPU devices, its flash kernel in interpret mode:
the JAX package's `ring_attention`/`ulysses_attention` on a mesh with
the same `seq` size, and its llama on the same params.

Tolerances (f32 on both sides; the products in another order, and the
ring's chunks folded by their log-sum-exp where JAX folds its own way):
outputs atol 2e-5, gradients atol 1e-4 against the JAX package's ring
and Ulysses; llama logits atol 1e-4, its loss rtol 1e-5 and gradients
within 1e-4 of each leaf's largest element against the JAX llama.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.parallel import ring_attention as j_ring
from accelerate_tpu.parallel import ulysses_attention as j_ulysses
from accelerate_tpu.utils import MeshConfig
from accelerate_tpu.utils.dataclasses import \
    ContextParallelPlugin as JContextParallelPlugin
from accelerate_tpu_torch.test_utils import run_world
from accelerate_tpu_torch.test_utils.worlds import context_parallel_forms

WORLD = 4
WORLD_TIMEOUT_S = 240
OUT_ATOL, GRAD_ATOL = 2e-5, 1e-4
SEQ4 = {"seq": 4}
SEQ2 = {"seq": 2, "data": 2}


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(seed, b, s, h, d, kv=None):
    kv = kv or h
    return {"q": _normal(seed, (b, s, h, d)),
            "k": _normal(seed + 1, (b, s, kv, d)),
            "v": _normal(seed + 2, (b, s, kv, d))}


def _pad_mask(b, s, lens):
    m = np.zeros((b, s), np.int32)
    for i, n in enumerate(lens):
        m[i, :n] = 1
    return m


CAUSAL = _qkv(0, 2, 64, 4, 16)
GQA = _qkv(10, 1, 64, 4, 16, kv=2)
NONCAUSAL = _qkv(20, 1, 32, 2, 16)
MASKED = _qkv(30, 2, 32, 2, 16)
MASK32 = _pad_mask(2, 32, [20, 32])
# row 0's second chunk (keys 16..31 on a line of 2) is fully masked
MASK_CHUNK = _pad_mask(2, 32, [12, 32])
WINDOWED = _qkv(40, 2, 64, 4, 16, kv=2)
ULY_MASKED = _qkv(50, 2, 64, 4, 16)
MASK64 = _pad_mask(2, 64, [40, 64])
ULY_GQA = _qkv(60, 1, 32, 8, 16, kv=4)
WINDOWS = (5, 24, 64)
LLAMA = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)
LLAMA_IDS = np.random.default_rng(70).integers(0, 64, (2, 32))
LLAMA_MASK = _pad_mask(2, 32, [24, 32])
LOSS_IDS = np.random.default_rng(71).integers(0, 64, (2, 33))


def jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return MeshConfig(axes=dict(axes)).build(devices=jax.devices()[:n])


def _j(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


@pytest.fixture(scope="module")
def llama_params():
    cfg = jl.LlamaConfig(**LLAMA, attention_backend="einsum")
    return jax.tree_util.tree_map(
        np.asarray, jl.init_params(cfg, jax.random.key(7)))


def _cases(llama_params):
    att = dict(kind="attention")
    return [
        dict(att, name="causal", fn="ring", causal=True, mesh=SEQ4,
             grad=True, **CAUSAL),
        dict(att, name="gqa", fn="ring", causal=True, mesh=SEQ4, grad=True,
             **GQA),
        dict(att, name="noncausal", fn="ring", causal=False, mesh=SEQ2,
             **NONCAUSAL),
        dict(att, name="masked", fn="ring", causal=True, mesh=SEQ2,
             mask=MASK32, grad=True, **MASKED),
        dict(att, name="masked_chunk", fn="ring", causal=False, mesh=SEQ2,
             mask=MASK_CHUNK, grad=True, **MASKED),
        *[dict(att, name=f"window_{w}", fn="ring", causal=True, mesh=SEQ4,
               window=w, **WINDOWED) for w in WINDOWS],
        dict(att, name="window_grad", fn="ring", causal=True, mesh=SEQ4,
             window=16, grad=True, mask=MASK64, **WINDOWED),
        dict(att, name="uly_masked", fn="ulysses", causal=True, mesh=SEQ4,
             mask=MASK64, **ULY_MASKED),
        dict(att, name="uly_gqa", fn="ulysses", causal=True, mesh=SEQ2,
             grad=True, **ULY_GQA),
        dict(att, name="uly_window", fn="ulysses", causal=True, mesh=SEQ2,
             window=9, **NONCAUSAL),
        dict(att, name="context_default", fn="context", causal=True,
             mesh=SEQ2, **NONCAUSAL),
        dict(att, name="context_ulysses", fn="context", mode="ulysses",
             causal=True, mesh=SEQ2, **NONCAUSAL),
        dict(name="errors", kind="errors", mesh=SEQ4),
        dict(name="llama", kind="llama", mesh=SEQ4, config=LLAMA,
             params=llama_params, ids=LLAMA_IDS, mask=LLAMA_MASK,
             backends=["ring", "ulysses", "einsum"]),
        dict(name="llama_sp", kind="llama", mesh=SEQ2, config=LLAMA,
             params=llama_params, ids=LLAMA_IDS, backends=["ring"],
             sequence_parallel=True),
        dict(name="llama_loss", kind="llama", mesh=SEQ2, config=LLAMA,
             params=llama_params, ids=LOSS_IDS, backends=[],
             loss_backend="ring"),
        dict(name="accelerator", kind="accelerator", mesh=SEQ4,
             **NONCAUSAL),
    ]


@pytest.fixture(scope="module")
def world(llama_params):
    ranks = run_world(context_parallel_forms, WORLD, (_cases(llama_params),),
                      timeout_s=WORLD_TIMEOUT_S)
    return {name: [r[name] for r in ranks] for name in ranks[0]
            if name != "log"}


# -- the JAX side -------------------------------------------------------------


def _loss_weight(q, mask):
    if mask is None:
        return jnp.ones(q.shape[:2], jnp.float32)
    return jnp.asarray(mask, jnp.float32)


def _jax_attention(fn, inputs, axes, causal=True, mask=None, window=None,
                   grad=False):
    """The JAX package's schedule on `inputs`: its output, and with
    `grad` its gradients of sum((out * w)**2), w the mask on the query
    rows."""
    mesh = jmesh(axes)
    q, k, v = (jnp.asarray(inputs[n]) for n in ("q", "k", "v"))
    m = None if mask is None else jnp.asarray(mask)
    kw = {} if window is None else {"window": window}

    def run(q, k, v):
        return fn(q, k, v, causal=causal, mask=m, mesh=mesh, **kw)

    if not grad:
        return np.asarray(jax.jit(run)(q, k, v)), None
    w = _loss_weight(q, mask)[:, :, None, None]

    def loss(q, k, v):
        out = run(q, k, v)
        return jnp.sum((out * w) ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _check_ranks(ranks, want_out, want_grads=None, rows=None):
    """Every rank's whole output (and gradients) against the JAX
    package's; `rows` keeps the real (unpadded) query rows."""
    for r in ranks:
        got = r["out"] if rows is None else r["out"][rows]
        want = want_out if rows is None else want_out[rows]
        np.testing.assert_allclose(got, want, atol=OUT_ATOL)
        if want_grads is not None:
            for g, wg in zip(r["grads"], want_grads):
                assert g.shape == wg.shape
                np.testing.assert_allclose(g, wg, atol=GRAD_ATOL)


def _seq_index(rank, mesh):
    """A rank's index on its `seq` line (the mesh lays ranks out
    row-major over its axes in order: SEQ2 is seq-major)."""
    return rank if mesh is SEQ4 else rank // 2


def _ring_calls(ranks, mesh, kind="ring", bwd=False):
    """Each rank's K1a (and K1b+K1c) calls against the causal ring's
    count: rank i of a line runs its diagonal chunk and the i chunks
    before it."""
    for rank, r in enumerate(ranks):
        want = _seq_index(rank, mesh) + 1
        assert r["calls"].get(f"{kind}_fwd") == want, (rank, r["calls"])
        if bwd:
            assert r["calls"].get(f"{kind}_bwd") == want, (rank, r["calls"])


# -- ring ---------------------------------------------------------------------


def test_ring_attention_matches_reference(world):
    """Causal ring on a `seq` line of 4 == the JAX package's ring; every
    rank returns the whole output; chunks from later ranks are skipped
    (rank i runs i + 1 chunk attentions)."""
    want, _ = _jax_attention(j_ring, CAUSAL, {"seq": 4, "data": 2})
    _check_ranks(world["causal"], want)
    _ring_calls(world["causal"], SEQ4, bwd=True)


def test_ring_attention_noncausal(world):
    """Non-causal ring on two `seq` lines of 2: every chunk is live."""
    want, _ = _jax_attention(j_ring, NONCAUSAL, {"seq": 2, "data": 4},
                             causal=False)
    _check_ranks(world["noncausal"], want)
    for r in world["noncausal"]:
        assert r["calls"] == {"ring_fwd": 2}


def test_ring_attention_differentiable(world):
    """dQ, dK, dV through the ring backward (global LSE, dK/dV riding the
    ring home) == the JAX package's, whole on every rank."""
    want, grads = _jax_attention(j_ring, CAUSAL, {"seq": 4, "data": 2},
                                 grad=True)
    _check_ranks(world["causal"], want, grads)


def test_ring_flash_gqa_unrepeated_kv(world):
    """K/V ring with their 2 kv heads; output and kv-headed gradients
    == the JAX package's."""
    want, grads = _jax_attention(j_ring, GQA, {"seq": 4, "data": 2},
                                 grad=True)
    _check_ranks(world["gqa"], want, grads)
    assert world["gqa"][0]["grads"][1].shape == GQA["k"].shape


def test_ring_flash_masked_gradients_match(world):
    """A padded batch on `seq` lines of 2: the mask's chunks ride the ring;
    output on the real rows and the gradients of the mask-weighted loss
    == the JAX package's, causal; and non-causal with row 0's second
    chunk fully masked, which every query of row 0 folds as -inf (the
    kernel pins such a row's LSE to 0, which would count the chunk)."""
    want, grads = _jax_attention(j_ring, MASKED, {"seq": 2, "data": 4},
                                 mask=MASK32, grad=True)
    _check_ranks(world["masked"], want, grads, rows=MASK32.astype(bool))
    _ring_calls(world["masked"], SEQ2, bwd=True)
    want, grads = _jax_attention(j_ring, MASKED, {"seq": 2, "data": 4},
                                 causal=False, mask=MASK_CHUNK, grad=True)
    _check_ranks(world["masked_chunk"], want, grads,
                 rows=MASK_CHUNK.astype(bool))


def test_ring_attention_sliding_window_matches_reference(world):
    """The windowed (einsum) ring with global-position banding: windows
    inside a chunk, across chunks with GQA, and the full reach == the
    JAX package's; its gradients with a padded batch; a window without
    causality raises before any fallback, on and off a mesh."""
    for w in WINDOWS:
        want, _ = _jax_attention(j_ring, WINDOWED, {"seq": 4, "data": 2},
                                 window=w)
        _check_ranks(world[f"window_{w}"], want)
        for r in world[f"window_{w}"]:
            assert r["calls"] == {}, "the windowed ring ran the kernels"
    want, grads = _jax_attention(j_ring, WINDOWED, {"seq": 4, "data": 2},
                                 window=16, mask=MASK64, grad=True)
    _check_ranks(world["window_grad"], want, grads,
                 rows=MASK64.astype(bool))
    for r in world["errors"]:
        for name in ("ring_window_noncausal", "ulysses_window_noncausal"):
            assert r[name][0] == "ValueError" and "causal" in r[name][1]
        assert "key-padding mask" in r["ring_mask_shape"][1]
        assert "key-padding mask" in r["ulysses_mask_shape"][1]
    from accelerate_tpu_torch.parallel import ring_attention

    q = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="causal"):
        ring_attention(q, q, q, causal=False, window=4,
                       mesh=_port_mesh({"data": 1}))


# -- Ulysses ------------------------------------------------------------------


def test_ulysses_masked_matches_reference(world):
    """Head scatter on a `seq` line of 4 with a padded batch (the mask's
    chunks all-gathered): the real rows == the JAX package's; one
    full-sequence flash call a rank."""
    want, _ = _jax_attention(j_ulysses, ULY_MASKED, {"seq": 4, "data": 2},
                             mask=MASK64)
    _check_ranks(world["uly_masked"], want, rows=MASK64.astype(bool))
    for r in world["uly_masked"]:
        assert r["calls"] == {"ulysses_fwd": 1}


def test_ulysses_gqa_unrepeated_wire(world):
    """4 kv heads divide a line of 2, so K/V scatter un-repeated: output
    and kv-headed gradients == the JAX package's."""
    want, grads = _jax_attention(j_ulysses, ULY_GQA, {"seq": 2, "data": 4},
                                 grad=True)
    _check_ranks(world["uly_gqa"], want, grads)
    assert world["uly_gqa"][0]["grads"][1].shape == ULY_GQA["k"].shape
    for r in world["uly_gqa"]:
        assert r["calls"] == {"ulysses_fwd": 1, "ulysses_bwd": 1}


def test_ulysses_sliding_window_matches_reference(world):
    want, _ = _jax_attention(j_ulysses, NONCAUSAL, {"seq": 2, "data": 4},
                             window=9)
    _check_ranks(world["uly_window"], want)


# -- context_attention, the plugin and the Accelerator ------------------------


def test_context_attention_dispatches_by_mode(world):
    """No mode and no plugin: the ring; mode "ulysses": Ulysses; both
    equal the JAX package's `context_attention` in the same modes."""
    from accelerate_tpu.parallel import context_attention as j_ctx

    mesh = jmesh({"seq": 2, "data": 4})
    q, k, v = (jnp.asarray(NONCAUSAL[n]) for n in ("q", "k", "v"))
    for name, mode in (("context_default", None),
                       ("context_ulysses", "ulysses")):
        want = np.asarray(j_ctx(q, k, v, causal=True, mode=mode, mesh=mesh))
        _check_ranks(world[name], want)
    for r in world["context_default"]:
        assert set(r["calls"]) == {"ring_fwd"}
    for r in world["context_ulysses"]:
        assert r["calls"] == {"ulysses_fwd": 1}


def test_context_parallel_plugin_and_env(world):
    """`Accelerator(context_parallel_plugin=...)` resolves `seq` 2 with
    `data` filling the rest and runs its mode through
    `Accelerator.context_attention`; the launcher's variables make the
    plugin (ring over the whole world); both outputs equal the plain
    attention of the JAX package."""
    from accelerate_tpu.models.common import dot_product_attention

    q, k, v = (jnp.asarray(NONCAUSAL[n]) for n in ("q", "k", "v"))
    want = np.asarray(dot_product_attention(q, k, v, causal=True))
    for r in world["accelerator"]:
        assert r["plugin_mesh"] == {"data": 2, "seq": 2}
        assert r["plugin_calls"] == {"ulysses_fwd": 1}
        np.testing.assert_allclose(r["plugin_out"], want, atol=OUT_ATOL)
        assert r["env_plugin"] == ("ring", WORLD)
        assert r["env_mesh"] == {"data": 1, "seq": WORLD}
        assert set(r["env_calls"]) == {"ring_fwd"}
        np.testing.assert_allclose(r["env_out"], want, atol=OUT_ATOL)
        assert r["params_prepared"] == (2, 2)


def test_training_calls_refused_on_seq_and_expert_meshes(world):
    """The training calls, which raised on a `seq` and an `expert` mesh
    until the loaders and the gradient average ran over the batch line,
    now train there: `prepare` of a `TrainState`, an optimizer and a
    loader, `train_step`, `compute_gradients` and `backward` run on
    `{data: 2, seq: 2}` and `{data: 2, expert: 2}`, each rank's loader
    gives its batch line's rows, and the loss, the grads and the update
    are the global batch's on every rank."""
    ranks = world["accelerator"]
    for r in ranks:
        assert r["expert_mesh"] == {"data": 2, "expert": 2}
        for key in ("trained_seq", "trained_expert"):
            _check_training_calls(r[key])
    for key in ("trained_seq", "trained_expert"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key]["step_w"],
                                          ranks[0][key]["step_w"])


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


def test_context_parallel_plugin_like_jax():
    from accelerate_tpu_torch.utils.dataclasses import ContextParallelPlugin

    for kw in ({}, {"seq_degree": 4, "mode": "ulysses"}):
        assert ContextParallelPlugin(**kw).to_mesh_axes() == \
            JContextParallelPlugin(**kw).to_mesh_axes()
    with pytest.raises(ValueError, match="ring' or 'ulysses"):
        ContextParallelPlugin(mode="tree")
    with pytest.raises(ValueError, match="ring' or 'ulysses"):
        JContextParallelPlugin(mode="tree")
    # the reference takes `chunk_size` and reads it nowhere; the port
    # takes it too, and warns that it changes nothing
    with pytest.warns(UserWarning, match="chunk_size=512 is ignored"):
        ContextParallelPlugin(chunk_size=512)


# -- llama --------------------------------------------------------------------


def _jax_llama_logits(params, ids, mask=None):
    cfg = jl.LlamaConfig(**LLAMA, attention_backend="einsum")
    return np.asarray(jl.forward(cfg, _j(params), jnp.asarray(ids),
                                 attention_mask=None if mask is None
                                 else jnp.asarray(mask)))


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_llama_padded_batch_keeps_context_backend(world, llama_params,
                                                  backend):
    """A padded batch through `attention_backend` ring or Ulysses on a
    `seq` line of 4 keeps that schedule (one call a layer, with the
    mask) and its logits on the real rows == the JAX llama's."""
    want = _jax_llama_logits(llama_params, LLAMA_IDS, LLAMA_MASK)
    rows = LLAMA_MASK.astype(bool)
    layers = LLAMA["num_hidden_layers"]
    for rank, r in enumerate(world["llama"]):
        np.testing.assert_allclose(r[f"logits_{backend}"][rows], want[rows],
                                   atol=1e-4)
        calls = r[f"calls_{backend}"]
        fwd = layers * ((rank + 1) if backend == "ring" else 1)
        assert calls == {f"{backend}_fwd": fwd}, calls
        np.testing.assert_allclose(r["logits_einsum"][rows], want[rows],
                                   atol=1e-4)


def test_llama_sequence_parallel_changes_no_value(world, llama_params):
    """`sequence_parallel=True` (the reference's layout hint) with the
    ring on lines of 2 == the JAX llama's logits."""
    want = _jax_llama_logits(llama_params, LLAMA_IDS)
    for rank, r in enumerate(world["llama_sp"]):
        np.testing.assert_allclose(r["logits_ring"], want, atol=1e-4)
        assert r["calls_ring"] == {"ring_fwd": LLAMA[
            "num_hidden_layers"] * (1 + _seq_index(rank, SEQ2))}


def test_llama_ring_loss_and_grads_match_jax(world, llama_params):
    """The causal-LM loss of 33 tokens (32 through the ring on lines of
    2) and every parameter's gradient == the JAX llama's."""
    cfg = jl.LlamaConfig(**LLAMA, attention_backend="einsum")
    loss, grads = jax.value_and_grad(
        lambda p: jl.causal_lm_loss(cfg, p, {"input_ids": jnp.asarray(
            LOSS_IDS)}))(_j(llama_params))
    flat = {}

    def walk(tree, prefix=""):
        for key, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, f"{prefix}{key}/")
            else:
                flat[prefix + key] = np.asarray(sub)

    walk(grads)
    for rank, r in enumerate(world["llama_loss"]):
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        assert set(r["grads"]) == set(flat)
        for name, want in flat.items():
            scale = max(float(np.abs(want).max()), 1e-30)
            assert np.abs(r["grads"][name] - want).max() <= 1e-4 * scale, \
                name
        layers = LLAMA["num_hidden_layers"]
        want = layers * (_seq_index(rank, SEQ2) + 1)
        assert r["calls_loss"] == {"ring_fwd": want, "ring_bwd": want}


# -- one process --------------------------------------------------------------


def _port_mesh(axes):
    from accelerate_tpu_torch.state import ProcessMesh

    return ProcessMesh(axes)


@pytest.mark.parametrize("fn", ["ring", "ulysses"])
def test_off_mesh_falls_back_like_jax(fn, monkeypatch):
    """Without a `seq` axis above 1 both schedules are one process's
    attention, as the JAX package's are (GQA repeated, mask and window
    applied): the port's `flash_attention`, whose forward runs K1a on
    the card and here its plain version, once a call."""
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.parallel import ring_attention, \
        ulysses_attention

    calls = []
    plain = fa.flash_forward_reference
    monkeypatch.setattr(fa, "flash_forward_reference",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    port = {"ring": ring_attention, "ulysses": ulysses_attention}[fn]
    ref = {"ring": j_ring, "ulysses": j_ulysses}[fn]
    x = WINDOWED
    got = port(*(torch.from_numpy(x[n]) for n in ("q", "k", "v")),
               causal=True, mask=torch.from_numpy(MASK64), window=24,
               mesh=_port_mesh({"data": 1}))
    assert calls == [1]
    want = ref(*(jnp.asarray(x[n]) for n in ("q", "k", "v")), causal=True,
               mask=jnp.asarray(MASK64), window=24,
               mesh=jmesh({"data": 8}))
    rows = MASK64.astype(bool)
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               atol=OUT_ATOL)


def test_select_attention_backend_like_jax():
    from accelerate_tpu_torch.models import llama as tl

    for backend in ("ring", "ulysses", "einsum", "flash"):
        assert tl.select_attention_backend(
            backend, on_cuda=False, decoding=False, seq_len=8) == \
            jl.select_attention_backend(backend, on_tpu=False,
                                        decoding=False, seq_len=8)
    with pytest.raises(ValueError, match="unknown attention_backend"):
        tl.select_attention_backend("tree", on_cuda=False, decoding=False,
                                    seq_len=8)


def test_sp_constrain_returns_its_input():
    from accelerate_tpu_torch.models.common import sp_constrain

    x = torch.arange(24.0).reshape(2, 3, 4)
    assert sp_constrain(x) is x and sp_constrain(x, "seq") is x


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_context_backend_on_tensor_parallel_shards_raises(backend):
    """The ring and Ulysses backends over tensor-parallel shards are not
    ported: they raise, naming their item, instead of running plain
    attention."""
    from accelerate_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig.tiny(attention_backend=backend)
    params = tl.init_params(cfg, 0, device="cpu")
    layer = {"attn": {k: {"kernel": v["kernel"][0]} for k, v in
                      params["layers"]["attn"].items()}}
    with pytest.raises(NotImplementedError, match="queue 1 item 6b"):
        tl._attention(cfg, layer, torch.zeros((1, 4, cfg.hidden_size)),
                      None, None, None, None, tp=object())
