"""The port's llama against the JAX package's on the same converted
weights: no-cache logits, cached prefill + decode logits (f32, atol
1e-4), greedy `generate`, and the param-tree bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import (
    params_from_numpy,
    params_to_numpy,
)

ATOL = 1e-4
LLAMA3_SCALING = {"rope_type": "llama3", "factor": 8.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 32}
VARIANTS = {
    "gqa": {},
    "sliding_window": {"sliding_window": 5},
    "bias_llama3_rope_tied": {"attention_bias": True,
                              "rope_scaling": LLAMA3_SCALING,
                              "tie_word_embeddings": True},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's thread pool costs more than it saves here,
    most of all with several test workers sharing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(**overrides):
    cfg_j = jl.LlamaConfig.tiny(**overrides)
    cfg_t = tl.LlamaConfig.tiny(**overrides)
    pj = jl.init_params(cfg_j, jax.random.key(0))
    if overrides.get("attention_bias"):
        # non-zero biases, so the test sees them applied
        rng = np.random.default_rng(9)
        for name in ("q_proj", "k_proj", "v_proj"):
            b = pj["layers"]["attn"][name]["bias"]
            pj["layers"]["attn"][name]["bias"] = jnp.asarray(
                rng.normal(size=b.shape) * 0.1, jnp.float32)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return cfg_j, cfg_t, pj, pt


def _ids(rng, b, s, vocab=256):
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_no_cache_logits_match_jax(variant):
    cfg_j, cfg_t, pj, pt = _models(**VARIANTS[variant])
    ids = _ids(np.random.default_rng(0), 2, 11)
    mask = np.ones((2, 11), np.int32)
    mask[1, :3] = 0
    out_t = tl.forward(cfg_t, pt, torch.tensor(ids),
                       attention_mask=torch.tensor(mask))
    out_j = jl.forward(cfg_j, pj, jnp.asarray(ids),
                       attention_mask=jnp.asarray(mask))
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cached_prefill_and_decode_logits_match_jax(variant):
    """A prompt prefilled into f32 caches, then three one-token steps."""
    cfg_j, cfg_t, pj, pt = _models(**VARIANTS[variant])
    rng = np.random.default_rng(1)
    ids = _ids(rng, 2, 9)
    cj = jl.init_kv_caches(cfg_j, 2, 32, dtype=jnp.float32)
    ct = tl.init_kv_caches(cfg_t, 2, 32, dtype=torch.float32, device="cpu")
    lj, cj = jl.forward(cfg_j, pj, jnp.asarray(ids), kv_caches=cj)
    lt, ct = tl.forward(cfg_t, pt, torch.tensor(ids), kv_caches=ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    for step in range(3):
        nxt = _ids(rng, 2, 1)
        pos = np.full((2, 1), 9 + step, np.int32)
        lj, cj = jl.forward(cfg_j, pj, jnp.asarray(nxt),
                            positions=jnp.asarray(pos), kv_caches=cj)
        lt, ct = tl.forward(cfg_t, pt, torch.tensor(nxt),
                            positions=torch.tensor(pos), kv_caches=ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0)
    assert ct[2] == int(cj[2]) == 12


def test_per_row_cache_lengths_match_one_row_at_a_time():
    """The dense decode path's [B] cache_len form (the port's counterpart
    of the reference engine's per-slot vmap) equals running each row
    alone at its own depth."""
    cfg = tl.LlamaConfig.tiny(sliding_window=6)
    pt = tl.init_params(cfg, 3, device="cpu")
    rng = np.random.default_rng(2)
    lens = [4, 11]
    ck, cv, _ = tl.init_kv_caches(cfg, 2, 16, torch.float32, device="cpu")
    singles = []
    for b, n in enumerate(lens):
        c = tl.init_kv_caches(cfg, 1, 16, torch.float32, device="cpu")
        _, c = tl.forward(cfg, pt, torch.tensor(_ids(rng, 1, n)),
                          kv_caches=c)
        ck[:, b], cv[:, b] = c[0][:, 0], c[1][:, 0]
        singles.append(c)
    tok = torch.tensor(_ids(rng, 2, 1))
    lengths = torch.tensor(lens, dtype=torch.int32)
    batched, _ = tl.forward(cfg, pt, tok, positions=lengths[:, None].long(),
                            kv_caches=(ck, cv, lengths))
    for b, n in enumerate(lens):
        alone, _ = tl.forward(cfg, pt, tok[b:b + 1],
                              positions=torch.tensor([[n]]),
                              kv_caches=singles[b])
        torch.testing.assert_close(batched[b:b + 1], alone, atol=1e-5,
                                   rtol=0)


def test_greedy_generate_matches_jax():
    cfg_j, cfg_t, pj, pt = _models()
    ids = _ids(np.random.default_rng(3), 2, 7)
    out_j = jl.generate(cfg_j, pj, jnp.asarray(ids), max_new_tokens=8)
    out_t = tl.generate(cfg_t, pt, torch.tensor(ids), max_new_tokens=8)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_sampled_generate_is_a_function_of_key_and_position():
    cfg_j, cfg_t, pj, pt = _models()
    ids = torch.tensor(_ids(np.random.default_rng(4), 2, 5))
    a = tl.generate(cfg_t, pt, ids, max_new_tokens=6, temperature=0.9, key=7)
    b = tl.generate(cfg_t, pt, ids, max_new_tokens=6, temperature=0.9, key=7)
    c = tl.generate(cfg_t, pt, ids, max_new_tokens=6, temperature=0.9, key=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # each row's stream is its own: row 0 alone samples what it did in
    # the batch
    alone = tl.generate(cfg_t, pt, ids[:1], max_new_tokens=6,
                        temperature=0.9, key=7)
    assert torch.equal(alone, a[:1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip(dtype):
    cfg = jl.LlamaConfig.tiny(attention_bias=True)
    tree = jax.tree_util.tree_map(
        np.asarray,
        jl.init_params(cfg, jax.random.key(1), dtype=getattr(jnp, dtype)))
    pt = params_from_numpy(tree, device="cpu")
    back = params_to_numpy(pt)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int16) if dtype ==
                                      "bfloat16" else a,
                                      b.view(np.int16) if dtype ==
                                      "bfloat16" else b)
    assert pt["layers"]["mlp"]["up_proj"]["kernel"].dtype == getattr(
        torch, dtype)
    if dtype == "bfloat16":
        assert back["norm"]["scale"].dtype == ml_dtypes.bfloat16


def test_init_params_has_the_reference_tree():
    for tie in (False, True):
        cfg_j = jl.LlamaConfig.tiny(tie_word_embeddings=tie)
        cfg_t = tl.LlamaConfig.tiny(tie_word_embeddings=tie)
        pj = jl.init_params(cfg_j, jax.random.key(0))
        pt = tl.init_params(cfg_t, 0, device="cpu")
        shapes_j = jax.tree_util.tree_map(lambda a: tuple(a.shape), pj)
        shapes_t = jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                          params_to_numpy(pt))
        assert shapes_t == shapes_j


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init_params(tl.LlamaConfig.tiny(), 0)
    assert tl.init_params(tl.LlamaConfig.tiny(), 0, device="cpu")[
        "norm"]["scale"].device.type == "cpu"


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_unported_attention_backends_raise(backend):
    cfg = tl.LlamaConfig.tiny(attention_backend=backend)
    pt = tl.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        tl.forward(cfg, pt, torch.zeros((1, 4), dtype=torch.int64))


@pytest.mark.parametrize("variant", ["gqa", "sliding_window"])
def test_flash_backend_on_cpu_equals_einsum(variant):
    """On CPU tensors "flash" runs the kernels' plain versions: the same
    logits as the einsum path (f32, atol 1e-5), padding mask included."""
    cfg = tl.LlamaConfig.tiny(**VARIANTS[variant])
    pt = tl.init_params(cfg, 0, device="cpu")
    ids = torch.tensor(_ids(np.random.default_rng(5), 2, 13))
    mask = torch.ones((2, 13), dtype=torch.int32)
    mask[0, 10:] = 0
    out = {b: tl.forward(dataclasses.replace(cfg, attention_backend=b), pt,
                         ids, attention_mask=mask)
           for b in ("flash", "einsum")}
    torch.testing.assert_close(out["flash"], out["einsum"], atol=1e-5,
                               rtol=0)
