"""The port's T5 and BERT against the JAX package's, on the same seeded
weights moved across with `models.convert`.

Tolerances, with their reasons (f32):
- T5's relative position buckets: equal, for every relative position in
  -512..512, bidirectional and causal (integer results of an f32 log);
- logits and cached decode logits: atol 1e-4 (f32 products in another
  summation order); greedy `generate`: equal tokens;
- losses rtol 1e-5; gradients within 1e-4 of each leaf's largest
  element, and at least 1e-7 (a gradient that is zero in exact
  arithmetic holds f32 noise in both);
- fp8 losses: atol 5e-3 (tests/test_torch_fp8.py gives the reason).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import bert as jb
from accelerate_tpu.models import t5 as jt
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models import bert as tb
from accelerate_tpu_torch.models import t5 as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.optimizers import adamw
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.training import TrainState

T5_VARIANTS = {"gated_untied": {},
               "relu_tied": {"is_gated_act": False,
                             "tie_word_embeddings": True}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _perturbed(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k in ("bias", "scale"):
            out[k] = (v + rng.normal(size=v.shape) * 0.1).astype(v.dtype)
        else:
            out[k] = v
    return out


def _pair(jmod, tmod, cfg_name, seed, **overrides):
    cj = getattr(jmod, cfg_name).tiny(**overrides)
    ct = getattr(tmod, cfg_name).tiny(**overrides)
    tree = _perturbed(jax.tree_util.tree_map(
        np.asarray, jmod.init_params(cj, jax.random.key(seed))),
        np.random.default_rng(seed))
    return (cj, ct, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def _grads_match(jax_loss, torch_loss, pj, pt):
    lj, gj = jax.value_and_grad(jax_loss)(pj)
    leaves = dict(_flat(pt))
    for t in leaves.values():
        t.requires_grad_(True)
    lt = torch_loss(pt)
    grads = dict(zip(leaves, torch.autograd.grad(lt, list(leaves.values()))))
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    for path, g in _flat(jax.tree_util.tree_map(np.asarray, gj)):
        scale = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(grads[path].numpy(), g, rtol=0,
                                   atol=1e-4 * scale, err_msg=path)


# --- T5 ---------------------------------------------------------------------


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidirectional", "causal"])
@pytest.mark.parametrize("buckets,distance", [(32, 128), (32, 64),
                                              (16, 256)])
def test_relative_buckets_equal_jax_exactly(bidirectional, buckets,
                                            distance):
    rel = np.arange(-512, 513, dtype=np.int32)
    ref = np.asarray(jt._relative_buckets(jnp.asarray(rel), bidirectional,
                                          buckets, distance))
    got = tt._relative_buckets(torch.tensor(rel), bidirectional, buckets,
                               distance).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("variant", list(T5_VARIANTS))
def test_t5_logits_match_jax(variant):
    cj, ct, pj, pt = _pair(jt, tt, "T5Config", 0, **T5_VARIANTS[variant])
    rng = np.random.default_rng(0)
    enc = rng.integers(0, 256, (2, 9)).astype(np.int32)
    dec = rng.integers(0, 256, (2, 6)).astype(np.int32)
    mask = np.ones_like(enc)
    mask[1, 6:] = 0
    lj = jt.forward(cj, pj, jnp.asarray(enc), jnp.asarray(dec),
                    jnp.asarray(mask))
    lt = tt.forward(ct, pt, torch.tensor(enc), torch.tensor(dec),
                    torch.tensor(mask))
    assert lt.dtype == torch.float32 and lt.shape == (2, 6, 256)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", list(T5_VARIANTS))
def test_t5_loss_and_gradients_match_jax(variant):
    cj, ct, pj, pt = _pair(jt, tt, "T5Config", 1, **T5_VARIANTS[variant])
    rng = np.random.default_rng(1)
    enc = rng.integers(0, 256, (2, 8)).astype(np.int32)
    dec = rng.integers(0, 256, (2, 5)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 5)).astype(np.int32)
    lmask = np.ones_like(labels)
    lmask[0, 3:] = 0
    emask = np.ones_like(enc)
    emask[1, 5:] = 0
    arrays = {"input_ids": enc, "decoder_input_ids": dec, "labels": labels,
              "labels_mask": lmask, "attention_mask": emask}
    bj = {k: jnp.asarray(v) for k, v in arrays.items()}
    bt = {k: torch.tensor(v) for k, v in arrays.items()}
    _grads_match(lambda p: jt.seq2seq_loss(cj, p, bj),
                 lambda p: tt.seq2seq_loss(ct, p, bt), pj, pt)


def test_t5_decode_matches_jax_and_the_forward():
    """Incremental decode (self caches + precomputed cross K/V) against
    the JAX package's steps and the teacher-forced forward, with the
    encoder's padding honoured (test_models' cases)."""
    cj, ct, pj, pt = _pair(jt, tt, "T5Config", 6)
    rng = np.random.default_rng(7)
    enc = rng.integers(0, 256, (2, 9)).astype(np.int32)
    dec = np.concatenate([np.zeros((2, 1), np.int32),
                          rng.integers(0, 256, (2, 6)).astype(np.int32)],
                         axis=1)
    mask = np.ones_like(enc)
    mask[0, 5:] = 0
    full = tt.forward(ct, pt, torch.tensor(enc), torch.tensor(dec),
                      torch.tensor(mask))
    st = tt.init_decode_state(ct, pt, torch.tensor(enc), max_new_tokens=7,
                              attention_mask=torch.tensor(mask))
    sj = jt.init_decode_state(cj, pj, jnp.asarray(enc), max_new_tokens=7,
                              attention_mask=jnp.asarray(mask))
    for t in range(7):
        pos = np.full((2, 1), t, np.int32)
        lt, st = tt.decode_step(ct, pt, torch.tensor(dec[:, t:t + 1]),
                                torch.tensor(pos), st)
        lj, sj = jt.decode_step(cj, pj, jnp.asarray(dec[:, t:t + 1]),
                                jnp.asarray(pos), sj)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(),
                                   atol=1e-4)
    assert st["cache_len"] == 7


@pytest.mark.parametrize("variant", list(T5_VARIANTS))
def test_t5_greedy_generate_matches_jax(variant):
    cj, ct, pj, pt = _pair(jt, tt, "T5Config", 10, **T5_VARIANTS[variant])
    enc = np.random.default_rng(10).integers(0, 256, (2, 5)).astype(np.int32)
    oj = jt.generate(cj, pj, jnp.asarray(enc), max_new_tokens=6)
    ot = tt.generate(ct, pt, torch.tensor(enc), max_new_tokens=6)
    assert ot.shape == (2, 7) and ot[:, 0].tolist() == [0, 0]
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_t5_fp8_loss_matches_jax():
    cj, ct, pj, pt = _pair(jt, tt, "T5Config", 12)
    rng = np.random.default_rng(12)
    arrays = {"input_ids": rng.integers(0, 256, (2, 8)),
              "decoder_input_ids": rng.integers(0, 256, (2, 5)),
              "labels": rng.integers(0, 256, (2, 5))}
    lj, nj = jt.seq2seq_loss(cj, pj, {k: jnp.asarray(v, jnp.int32)
                                      for k, v in arrays.items()},
                             fp8_state=jt.init_fp8_state(cj))
    lt, nt = tt.seq2seq_loss(ct, pt, {k: torch.tensor(v)
                                      for k, v in arrays.items()},
                             fp8_state=tt.init_fp8_state(ct, device="cpu"))
    np.testing.assert_allclose(float(lt), float(lj), rtol=0, atol=5e-3)
    a = nj["decoder"]["layers"]["cross_attn"]["k"]["w"]
    b = nt["decoder"]["layers"]["cross_attn"]["k"]["w"]
    np.testing.assert_array_equal(b.amax_history.numpy(),
                                  np.asarray(a.amax_history))
    assert set(nt) == {"encoder", "decoder"}


def test_t5_streamed_generate_raises_and_names_its_item(monkeypatch):
    """The hybrid streamed decode runs over the one-device "sharded"
    dispatch and decodes `generate`'s tokens; over several cards that
    dispatch needs the sharding planner, and raises naming queue 1
    item 6."""
    from accelerate_tpu_torch import big_modeling as tbm

    cfg = tt.T5Config.tiny()
    params = tt.init_params(cfg, 0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 6)))
    placed = tbm.dispatch_model(params, "sharded", device="cpu")
    assert torch.equal(
        tt.streamed_generate(cfg, placed, ids, max_new_tokens=4,
                             dtype=torch.float32, device="cpu"),
        tt.generate(cfg, params, ids, max_new_tokens=4))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        tbm.dispatch_model(params, "sharded", device="cpu")


# --- BERT -------------------------------------------------------------------


def _bert_batch(rng, b=3, s=12):
    mask = np.ones((b, s), np.int32)
    mask[1, 8:] = 0
    mask[2, 4:] = 0
    return {"input_ids": rng.integers(0, 512, (b, s)).astype(np.int32),
            "attention_mask": mask,
            "token_type_ids": (np.arange(s)[None] >= s // 2).repeat(
                b, 0).astype(np.int32),
            "labels": rng.integers(0, 2, (b,)).astype(np.int32)}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_bert_logits_loss_and_gradients_match_jax(remat):
    cj, ct, pj, pt = _pair(jb, tb, "BertConfig", 0, remat=remat)
    batch = _bert_batch(np.random.default_rng(0))
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: torch.tensor(v) for k, v in batch.items()}
    lj = jb.forward(cj, pj, bj["input_ids"], bj["attention_mask"],
                    bj["token_type_ids"])
    lt = tb.forward(ct, pt, bt["input_ids"], bt["attention_mask"],
                    bt["token_type_ids"])
    assert lt.shape == (3, 2)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    _grads_match(lambda p: jb.classification_loss(cj, p, bj),
                 lambda p: tb.classification_loss(ct, p, bt), pj, pt)


def test_bert_padding_mask_ignores_pad_tokens():
    cfg = tb.BertConfig.tiny()
    params = tb.init_params(cfg, 0, device="cpu")
    ids = torch.ones((1, 8), dtype=torch.int64)
    mask = torch.tensor([[1, 1, 1, 1, 0, 0, 0, 0]])
    l1 = tb.forward(cfg, params, ids, mask)
    ids2 = ids.clone()
    ids2[0, 5] = 77   # a padded position's content must not matter
    np.testing.assert_allclose(l1.numpy(),
                               tb.forward(cfg, params, ids2, mask).numpy(),
                               atol=1e-5)


def test_bert_fp8_loss_matches_jax():
    cj, ct, pj, pt = _pair(jb, tb, "BertConfig", 3)
    batch = _bert_batch(np.random.default_rng(3))
    lj, _ = jb.classification_loss(
        cj, pj, {k: jnp.asarray(v) for k, v in batch.items()},
        fp8_state=jb.init_fp8_state(cj))
    lt, nt = tb.classification_loss(
        ct, pt, {k: torch.tensor(v) for k, v in batch.items()},
        fp8_state=tb.init_fp8_state(ct, device="cpu"))
    np.testing.assert_allclose(float(lt), float(lj), rtol=0, atol=5e-3)
    assert float(nt["layers"]["attn"]["q_proj"]["w"].scale[0]) != 1.0


def test_bert_trains_on_the_cpu():
    PartialState._reset_state()
    try:
        cfg = tb.BertConfig.tiny()
        acc = Accelerator(cpu=True)
        state = acc.prepare(TrainState.create(
            apply_fn=None, params=tb.init_params(cfg, 0, device="cpu"),
            tx=adamw(1e-3, weight_decay=0.0)))
        batch = {k: torch.tensor(v) for k, v in
                 _bert_batch(np.random.default_rng(0), b=8, s=16).items()}
        step = acc.train_step(lambda p, b: tb.classification_loss(cfg, p, b))
        state, m = step(state, batch)
        first = float(m["loss"])
        for _ in range(15):
            state, m = step(state, batch)
        assert float(m["loss"]) < first
    finally:
        PartialState._reset_state()


@pytest.mark.parametrize("mod,cfg_name", [(tt, "T5Config"),
                                          (tb, "BertConfig")],
                         ids=["t5", "bert"])
def test_init_params_has_the_reference_tree(mod, cfg_name):
    jmod = {tt: jt, tb: jb}[mod]
    ref = {p: np.shape(v) for p, v in _flat(jax.tree_util.tree_map(
        np.asarray, jmod.init_params(getattr(jmod, cfg_name).tiny(),
                                     jax.random.key(0))))}
    got = {p: tuple(v.shape) for p, v in _flat(mod.init_params(
        getattr(mod, cfg_name).tiny(), 0, device="cpu"))}
    assert got == ref
    assert dataclasses.asdict(getattr(mod, cfg_name)()) == \
        dataclasses.asdict(getattr(jmod, cfg_name)())


@pytest.mark.parametrize("mod,cfg_name", [(tt, "T5Config"),
                                          (tb, "BertConfig")],
                         ids=["t5", "bert"])
def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(mod, cfg_name,
                                                          monkeypatch):
    cfg = getattr(mod, cfg_name).tiny()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: mod.init_params(cfg, 0),
                 lambda: mod.init_fp8_state(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
