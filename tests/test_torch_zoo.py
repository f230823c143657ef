"""The port's causal model zoo (GPT-2, GPT-J, GPT-NeoX, OPT) against the
JAX package's, on the same seeded weights moved across with
`models.convert` (biases and norm parameters perturbed off their zero
and one inits, so a missed bias shows).

Tolerances, with their reasons (f32 throughout unless stated):
- logits, cached logits: atol 1e-4 (f32 products in another summation
  order, through a few layers);
- losses: rtol 1e-5; gradients: within 1e-4 of each leaf's largest
  element (the same sums, differentiated), and at least 1e-7: the key
  bias's gradient is zero in exact arithmetic (softmax ignores a shift of
  a row's scores), so both hold f32 noise there;
- greedy token streams (`generate`, the serving engine): equal;
- the GPT-2 fp8 loss: atol 5e-3; every w meta and layer 0's c_attn x
  meta bit-equal (exact casts of the same bits); the other x metas
  within 2e-2: an fp8 product's output is bf16, as in the reference, and
  its f32 sum taken in another order rounds to a neighbouring bf16 now
  and then (tests/test_torch_fp8.py).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.serving import Engine as JEngine
from accelerate_tpu.serving import EngineConfig as JConfig
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.serving import Engine, EngineConfig

FAMILIES = ["gpt2", "gptj", "gpt_neox", "opt"]
CONFIG = {"gpt2": "GPT2Config", "gptj": "GPTJConfig",
          "gpt_neox": "GPTNeoXConfig", "opt": "OPTConfig"}
# the families, plus NeoX with its sequential residual and full rotary
VARIANTS = {name: (name, {}) for name in FAMILIES}
VARIANTS["gpt_neox_sequential"] = ("gpt_neox", {
    "use_parallel_residual": False, "rotary_pct": 1.0})
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mods(name):
    return (importlib.import_module(f"accelerate_tpu.models.{name}"),
            importlib.import_module(f"accelerate_tpu_torch.models.{name}"))


def _perturbed(tree, rng):
    """Biases and norm parameters off their zero and one inits."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k in ("bias", "scale"):
            out[k] = (v + rng.normal(size=v.shape) * 0.1).astype(v.dtype)
        else:
            out[k] = v
    return out


def _models(name, seed=0, **overrides):
    """(JAX module, port module, JAX config, port config, JAX params, port
    params): one numpy tree for both."""
    jm, tm = _mods(name)
    cfg_j = getattr(jm, CONFIG[name]).tiny(**overrides)
    cfg_t = getattr(tm, CONFIG[name]).tiny(**overrides)
    tree = _perturbed(jax.tree_util.tree_map(
        np.asarray, jm.init_params(cfg_j, jax.random.key(seed))),
        np.random.default_rng(seed))
    return (jm, tm, cfg_j, cfg_t, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def _ids(rng, b, s, vocab=256):
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_match_jax(variant):
    name, over = VARIANTS[variant]
    jm, tm, cj, ct, pj, pt = _models(name, **over)
    ids = _ids(np.random.default_rng(0), 2, 11)
    mask = np.ones((2, 11), np.int32)
    mask[1, 8:] = 0
    out_t = tm.forward(ct, pt, torch.tensor(ids),
                       attention_mask=torch.tensor(mask))
    out_j = jm.forward(cj, pj, jnp.asarray(ids),
                       attention_mask=jnp.asarray(mask))
    assert out_t.dtype == torch.float32 and out_t.shape == (2, 11, 256)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_gradients_match_jax(variant):
    name, over = VARIANTS[variant]
    jm, tm, cj, ct, pj, pt = _models(name, seed=1, **over)
    ids = _ids(np.random.default_rng(1), 2, 13)
    mask = np.ones_like(ids)
    mask[0, 10:] = 0
    lj, gj = jax.value_and_grad(lambda p: jm.causal_lm_loss(
        cj, p, {"input_ids": jnp.asarray(ids),
                "attention_mask": jnp.asarray(mask)}))(pj)
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


@pytest.mark.parametrize("name", FAMILIES)
def test_cached_prefill_and_decode_match_jax_and_the_forward(name):
    """The port's cached prefill and one-token steps against the JAX
    package's and against its own full forward (test_models'
    decode-matches-forward case)."""
    jm, tm, cj, ct, pj, pt = _models(name, seed=3)
    ids = _ids(np.random.default_rng(4), 2, 10)
    full = tm.forward(ct, pt, torch.tensor(ids))
    ck = tm.init_kv_caches(ct, 2, 16, dtype=torch.float32, device="cpu")
    cjk = jm.init_kv_caches(cj, 2, 16, dtype=jnp.float32)
    pre_t, ck = tm.forward(ct, pt, torch.tensor(ids[:, :5]), kv_caches=ck)
    pre_j, cjk = jm.forward(cj, pj, jnp.asarray(ids[:, :5]), kv_caches=cjk)
    np.testing.assert_allclose(pre_t.numpy(), np.asarray(pre_j), atol=ATOL)
    np.testing.assert_allclose(pre_t.numpy(), full[:, :5].numpy(), atol=ATOL)
    for t in range(5, 10):
        pos = np.full((2, 1), t, np.int32)
        st, ck = tm.forward(ct, pt, torch.tensor(ids[:, t:t + 1]),
                            positions=torch.tensor(pos), kv_caches=ck)
        sj, cjk = jm.forward(cj, pj, jnp.asarray(ids[:, t:t + 1]),
                             positions=jnp.asarray(pos), kv_caches=cjk)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
        np.testing.assert_allclose(st[:, 0].numpy(), full[:, t].numpy(),
                                   atol=ATOL)
    assert ck[2] == 10


@pytest.mark.parametrize("name", FAMILIES)
def test_greedy_generate_matches_jax(name):
    jm, tm, cj, ct, pj, pt = _models(name, seed=5)
    ids = _ids(np.random.default_rng(5), 2, 6)
    out_j = jm.generate(cj, pj, jnp.asarray(ids), max_new_tokens=8)
    out_t = tm.generate(ct, pt, torch.tensor(ids), max_new_tokens=8)
    assert out_t.shape == (2, 14)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(
        tm.generate(ct, pt, torch.tensor(ids), max_new_tokens=8).numpy(),
        out_t.numpy())


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_generate_keeps_the_dtype(name):
    """bf16 weights run forward and decode without dtype drift (the
    reference's regression: GPT-J's rotary once upcast the residual)."""
    _, tm = _mods(name)
    cfg = getattr(tm, CONFIG[name]).tiny()
    params = tm.init_params(cfg, 7, dtype=torch.bfloat16, device="cpu")
    out = tm.generate(cfg, params, torch.ones((1, 8), dtype=torch.int32),
                      max_new_tokens=3)
    assert out.shape == (1, 11)


@pytest.mark.parametrize("name", ["gptj", "gpt_neox"])
def test_decode_past_max_position_embeddings(name):
    """Rotary tables extend to the cache's reach (test_models' case)."""
    jm, tm, cj, ct, pj, pt = _models(name, seed=9,
                                     max_position_embeddings=16)
    long_cfg = dataclasses.replace(ct, max_position_embeddings=24)
    ids = _ids(np.random.default_rng(10), 1, 12)
    seq = np.concatenate([ids, ids[:, :8]], axis=1)
    full = tm.forward(long_cfg, pt, torch.tensor(seq))
    caches = tm.init_kv_caches(ct, 1, 20, dtype=torch.float32, device="cpu")
    _, caches = tm.forward(ct, pt, torch.tensor(ids), kv_caches=caches)
    for t in range(12, 20):
        lg, caches = tm.forward(ct, pt, torch.tensor(seq[:, t:t + 1]),
                                positions=torch.full((1, 1), t),
                                kv_caches=caches)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   atol=ATOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_masked_loss_ignores_pads(name):
    """Right-padded rows score the real tokens only (test_models')."""
    _, tm = _mods(name)
    cfg = getattr(tm, CONFIG[name]).tiny()
    params = tm.init_params(cfg, 0, device="cpu")
    ids = torch.tensor(_ids(np.random.default_rng(0), 2, 17))
    mask = torch.ones_like(ids)
    mask[:, 12:] = 0
    padded = ids.clone()
    padded[:, 12:] = 0
    masked = tm.causal_lm_loss(cfg, params, {"input_ids": padded,
                                             "attention_mask": mask})
    short = tm.causal_lm_loss(cfg, params, {"input_ids": ids[:, :12]})
    np.testing.assert_allclose(float(masked), float(short), rtol=2e-3)


def test_opt_left_padding_takes_positions_from_the_mask():
    jm, tm, cj, ct, pj, pt = _models("opt", seed=11)
    ids = _ids(np.random.default_rng(11), 2, 9)
    mask = np.ones_like(ids)
    mask[0, :4] = 0
    out_t = tm.forward(ct, pt, torch.tensor(ids),
                       attention_mask=torch.tensor(mask))
    out_j = jm.forward(cj, pj, jnp.asarray(ids),
                       attention_mask=jnp.asarray(mask))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    # row 0's real tokens sit at positions 0..4, as in an unpadded row
    alone = tm.forward(ct, pt, torch.tensor(ids[:1, 4:]))
    np.testing.assert_allclose(out_t[0, 4:].numpy(), alone[0].numpy(),
                               atol=ATOL)
    caches = tm.init_kv_caches(ct, 2, 16, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="explicit `positions`"):
        tm.forward(ct, pt, torch.tensor(ids), kv_caches=caches,
                   attention_mask=torch.ones((2, 16), dtype=torch.int32))


def test_gpt2_fp8_loss_and_metas_match_jax():
    jm, tm, cj, ct, pj, pt = _models("gpt2", seed=12)
    ids = _ids(np.random.default_rng(12), 2, 9)
    lj, new_j = jm.causal_lm_loss(cj, pj, {"input_ids": jnp.asarray(ids)},
                                  fp8_state=jm.init_fp8_state(cj))
    lt, new_t = tm.causal_lm_loss(ct, pt, {"input_ids": torch.tensor(ids)},
                                  fp8_state=tm.init_fp8_state(
                                      ct, device="cpu"))
    np.testing.assert_allclose(float(lt), float(lj), rtol=0, atol=5e-3)
    jl_, tl_ = new_j["layers"], new_t["layers"]
    for group, names in (("attn", ("c_attn", "c_proj")),
                         ("mlp", ("c_fc", "c_proj"))):
        for n in names:
            for side in ("x", "w"):
                a, b = jl_[group][n][side], tl_[group][n][side]
                np.testing.assert_allclose(b.scale.numpy(),
                                           np.asarray(a.scale), rtol=2e-2)
                rows = (slice(None) if side == "w" else
                        slice(0, 1) if n == "c_attn" else slice(0, 0))
                np.testing.assert_array_equal(b.scale[rows].numpy(),
                                              np.asarray(a.scale)[rows])
                np.testing.assert_array_equal(
                    b.amax_history[rows].numpy(),
                    np.asarray(a.amax_history)[rows])
    assert float(tl_["attn"]["c_attn"]["w"].amax_history[0, 0]) > 0


BASE = dict(num_slots=2, max_len=64, prefill_chunk=8, page_size=8)


def _waves(vocab=256):
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n in (6, 13, 9, 4, 11)]
    shared = rng.integers(0, vocab, (12,)).astype(np.int32)
    a, b = (np.concatenate([shared, rng.integers(0, vocab, (n,)).astype(
        np.int32)]) for n in (3, 5))
    return [prompts + [a], [b]]


def _run(engine, waves, budget=6):
    out = []
    for wave in waves:
        reqs = [engine.submit(p, max_new_tokens=budget) for p in wave]
        engine.run_until_idle()
        assert all(r.status.value == "finished" for r in reqs)
        out += reqs
    return out


@pytest.mark.parametrize("paged_attention", [True, False],
                         ids=["paged", "dense"])
@pytest.mark.parametrize("name", FAMILIES)
def test_engine_greedy_streams_equal_the_jax_engine(name, paged_attention):
    """The serving engine on each family: paged=True runs K2's plain
    version on the CPU."""
    jm, tm, cj, ct, pj, pt = _models(name, seed=13)
    kw = dict(BASE, paged_attention=paged_attention)
    jeng = JEngine(jm, cj, pj, JConfig(cache_dtype=jnp.float32, **kw))
    teng = Engine(tm, ct, pt, EngineConfig(cache_dtype=torch.float32, **kw),
                  device="cpu")
    jr, tr = _run(jeng, _waves()), _run(teng, _waves())
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-5)
    assert teng.metrics_summary()["prefix_hit_rate"] > 0
    path = "kernel" if paged_attention else "dense"
    assert teng.registry.counter(
        "serving_decode_path_total", path=path).value == \
        teng.metrics_summary()["decode_steps"]


@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_has_the_reference_tree(name):
    jm, tm = _mods(name)
    cj = getattr(jm, CONFIG[name]).tiny()
    ct = getattr(tm, CONFIG[name]).tiny()
    ref = {p: np.shape(v) for p, v in _flat(jax.tree_util.tree_map(
        np.asarray, jm.init_params(cj, jax.random.key(0))))}
    got = {p: tuple(v.shape) for p, v in _flat(tm.init_params(
        ct, 0, device="cpu"))}
    assert got == ref
    assert ct == getattr(tm, CONFIG[name]).tiny()
    if name == "gptj":
        full = tm.GPTJConfig()
        assert (full.head_dim, full.rotary_dim, full.num_hidden_layers,
                full.vocab_size) == (256, 64, 28, 50400)


@pytest.mark.parametrize("name", FAMILIES)
def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(name, monkeypatch):
    _, tm = _mods(name)
    cfg = getattr(tm, CONFIG[name]).tiny()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tm.init_params(cfg, 0),
                 lambda: tm.init_kv_caches(cfg, 1, 8),
                 lambda: tm.init_fp8_state(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("name", FAMILIES)
def test_streamed_generate_raises_and_names_its_item(name, monkeypatch):
    """The streamed decode runs over the one-device "sharded" dispatch
    (every leaf on device 0) and decodes `generate`'s tokens; over
    several cards that dispatch needs the sharding planner, and raises
    naming queue 1 item 6."""
    from accelerate_tpu_torch import big_modeling as tbm

    _, tm = _mods(name)
    cfg = getattr(tm, CONFIG[name]).tiny()
    params = tm.init_params(cfg, 0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 5)))
    placed = tbm.dispatch_model(params, "sharded", device="cpu")
    assert torch.equal(
        tm.streamed_generate(cfg, placed, ids, max_new_tokens=4,
                             dtype=torch.float32, device="cpu"),
        tm.generate(cfg, params, ids, max_new_tokens=4))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        tbm.dispatch_model(params, "sharded", device="cpu")
