"""The port's native token loader (`accelerate_tpu_torch/native`) against
the JAX package's (`accelerate_tpu/native`): the cases of
`tests/test_native_loader.py`, and batch orders equal to the reference's
bit for bit for the native path and the numpy fallback, in uint16, int32
and uint32, over seeds, epochs and shards. `g++` builds the library
here as it does on the card's machine.

The slice as a whole: a prepared `TokenCorpusLoader` feeding
`Accelerator(cpu=True, mixed_precision="bf16", gradient_clipping=1.0)`'s
`train_step` on `LlamaConfig.tiny()` for 3 steps, against the JAX
Accelerator fed by the JAX loader from the same weights. Tolerances are
`tests/test_torch_train_step.py`'s for bf16, for its reasons: losses
within 2e-3 (bf16 rounds at other places in the two frameworks), and
each param leaf's change within 0.25 relative L2 of the JAX change
(Adam's steps of elements with near-zero gradients take either sign by
rounding). The batches themselves are equal, bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import accelerate_tpu as at
from accelerate_tpu import native as jn
from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch import native as tn
from accelerate_tpu_torch import optimizers as to
from accelerate_tpu_torch import training as tt
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.data import DataLoaderShard, prepare_data_loader
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_numpy, \
    params_to_numpy
from accelerate_tpu_torch.state import PartialState


@pytest.fixture(autouse=True)
def _fresh_port_state():
    PartialState._reset_state()
    yield
    PartialState._reset_state()


@pytest.fixture
def token_file(tmp_path):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 1000, size=10_000, dtype=np.int32)
    path = str(tmp_path / "corpus.bin")
    tn.write_token_file(path, tokens)
    return path, tokens


def _collect(loader):
    return [b["input_ids"] for b in loader]


def _windows(tokens, n, L):
    return {tokens[i * L:(i + 1) * L].tobytes() for i in range(n)}


def test_native_builds_into_the_port_and_iterates(token_file):
    assert tn.is_available(), tn.build_error()
    assert tn.build_error() is None
    so = tn.build_info["path"]
    assert os.path.dirname(so) == str(tn.BUILD_DIR)
    assert str(tn.BUILD_DIR).endswith(os.path.join(
        "accelerate_tpu_torch", "_native", "_build"))
    path, _ = token_file
    loader = tn.TokenCorpusLoader(path, sample_len=128, batch_size=4, seed=3)
    assert loader.native
    batches = _collect(loader)
    assert len(batches) == len(loader) == (10_000 // 128) // 4
    assert all(b.shape == (4, 128) and b.dtype == np.int32 for b in batches)
    loader.close()
    assert not loader.native


def test_build_is_keyed_on_the_source_and_renamed_into_place(
        tmp_path, monkeypatch):
    """A build directory of its own: g++ writes a temporary file that is
    renamed into place, under a name that hashes the source and flags."""
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tn, "build_info", {})
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_build_error", None)
    assert tn.is_available(), tn.build_error()
    built = sorted(os.listdir(tmp_path / "build"))
    assert len(built) == 1 and built[0] == tn._lib_path().name
    assert tn.build_info["seconds"] > 0
    monkeypatch.setattr(tn, "CXX_FLAGS", tn.CXX_FLAGS + ("-DATL_KEY=1",))
    assert tn._lib_path().name != built[0]
    # a directory others can write is refused, and the loader falls back
    shared = tmp_path / "shared"
    shared.mkdir(mode=0o777)
    os.chmod(shared, 0o777)
    monkeypatch.setattr(tn, "BUILD_DIR", shared)
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_build_error", None)
    assert not tn.is_available() and "not private" in tn.build_error()


def test_native_covers_each_sample_once(token_file):
    path, tokens = token_file
    rows = np.concatenate(_collect(tn.TokenCorpusLoader(
        path, sample_len=128, batch_size=1, seed=7, drop_last=False)))
    assert len(rows) == 10_000 // 128
    assert {r.tobytes() for r in rows} == _windows(tokens, 78, 128)


def test_native_deterministic_and_reshuffles(token_file):
    path, _ = token_file
    a = _collect(tn.TokenCorpusLoader(path, 128, 4, seed=11))
    b = _collect(tn.TokenCorpusLoader(path, 128, 4, seed=11))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    loader = tn.TokenCorpusLoader(path, 128, 4, seed=11)
    first, second = _collect(loader), _collect(loader)
    assert loader.epoch == 2
    assert any(not np.array_equal(x, y) for x, y in zip(first, second))


def test_native_sharding_partitions(token_file):
    path, tokens = token_file
    shards = [np.concatenate(_collect(tn.TokenCorpusLoader(
        path, 128, 2, seed=5, rank=r, world=2, drop_last=False)))
        for r in range(2)]
    assert shards[0].shape == shards[1].shape
    assert {r.tobytes() for s in shards for r in s} == \
        _windows(tokens, 78, 128)


def test_native_threads_keep_batch_order(token_file):
    path, _ = token_file
    a = _collect(tn.TokenCorpusLoader(path, 64, 4, seed=2, threads=1))
    b = _collect(tn.TokenCorpusLoader(path, 64, 4, seed=2, threads=4,
                                      prefetch_depth=8))
    assert len(a) == len(b)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", ["uint16", "int32", "uint32"])
@pytest.mark.parametrize("fallback", [False, True],
                         ids=["native", "fallback"])
def test_orders_equal_the_reference_bit_for_bit(tmp_path, dtype, fallback):
    """Both packages' loaders, native and fallback, on one file: the same
    batches, for several seeds, epochs, shards and tails."""
    rng = np.random.default_rng(1)
    top = 60_000 if dtype == "uint16" else 2**31 - 1
    tokens = rng.integers(0, top, 64 * 37 + 5).astype(dtype)
    path = str(tmp_path / f"{dtype}.bin")
    tn.write_token_file(path, tokens)
    for seed, world, drop_last, shuffle in ((0, 1, True, True),
                                            (9, 2, False, True),
                                            (2**40 + 3, 3, True, True),
                                            (5, 1, False, False)):
        for rank in range(world):
            kw = dict(sample_len=37, batch_size=5, dtype=dtype, seed=seed,
                      rank=rank, world=world, drop_last=drop_last,
                      shuffle=shuffle)
            t = tn.TokenCorpusLoader(path, force_fallback=fallback, **kw)
            j = jn.TokenCorpusLoader(path, force_fallback=fallback, **kw)
            assert t.native is not fallback
            assert (j._loader is None) is fallback
            assert (len(t), t.remainder, t.tail_layout,
                    t.is_host_sharded) == (len(j), j.remainder,
                                           j.tail_layout, j.is_host_sharded)
            for epoch in (0, 1, 4):
                t.set_epoch(epoch)
                j.set_epoch(epoch)
                got, want = _collect(t), _collect(j)
                assert len(got) == len(want) == len(t)
                for x, y in zip(got, want):
                    assert x.dtype == y.dtype == np.int32
                    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 9, 123456789])
def test_epoch_order_and_draws_equal_the_reference(seed):
    for epoch in (0, 3):
        np.testing.assert_array_equal(
            tn._splitmix64_draws(seed, epoch, 50),
            jn._splitmix64_draws(seed, epoch, 50))
        for n, rank, world in ((1, 0, 1), (50, 1, 3), (7, 0, 2)):
            np.testing.assert_array_equal(
                tn._epoch_order(n, seed, epoch, True, rank, world),
                jn._epoch_order(n, seed, epoch, True, rank, world))


def test_large_corpus_fallback_shuffle_warns_and_matches_the_reference(
        monkeypatch):
    monkeypatch.setattr(tn, "EXACT_SHUFFLE_MAX", 10)
    monkeypatch.setattr(jn, "_EXACT_SHUFFLE_MAX", 10)
    with pytest.warns(UserWarning, match="EXACT_SHUFFLE_MAX"):
        got = tn._epoch_order(40, 3, 1, True, 0, 1)
    with pytest.warns(UserWarning):
        want = jn._epoch_order(40, 3, 1, True, 0, 1)
    np.testing.assert_array_equal(got, want)


def test_uint16_widens(tmp_path):
    path = str(tmp_path / "u16.bin")
    tn.write_token_file(path, np.arange(4096, dtype=np.uint16))
    first = next(iter(tn.TokenCorpusLoader(path, 64, 2, dtype=np.uint16,
                                           shuffle=False)))["input_ids"]
    assert first.dtype == np.int32
    np.testing.assert_array_equal(first[1], np.arange(64, 128))


def test_fallback_same_coverage(token_file):
    path, tokens = token_file
    fb = tn.TokenCorpusLoader(path, 128, 4, seed=3, force_fallback=True,
                              drop_last=False)
    assert not fb.native
    rows = np.concatenate(_collect(fb))
    assert {r.tobytes() for r in rows} == _windows(tokens, 78, 128)


def test_feeds_the_accelerator_loader(token_file):
    path, _ = token_file
    acc = Accelerator(cpu=True)
    loader = acc.prepare(tn.TokenCorpusLoader(path, sample_len=64,
                                              batch_size=8, seed=1))
    assert isinstance(loader, DataLoaderShard)
    batch = next(iter(loader))
    assert isinstance(batch["input_ids"], torch.Tensor)
    assert batch["input_ids"].shape == (8, 64)
    assert batch["input_ids"].dtype == torch.int32


def test_invalid_shard_raises(token_file):
    path, _ = token_file
    for kw in ({"rank": 2, "world": 2}, {"batch_size": 0},
               {"dtype": "int64"}):
        args = {"sample_len": 128, "batch_size": 8, **kw}
        with pytest.raises(ValueError):
            tn.TokenCorpusLoader(path, **args)
    with pytest.raises(FileNotFoundError):
        tn.TokenCorpusLoader(path + ".missing", 128, 8)


def test_host_sharded_source_not_resharded(token_file):
    path, _ = token_file
    for fallback in (False, True):
        src = tn.TokenCorpusLoader(path, 128, 4, seed=1, rank=0, world=2,
                                   force_fallback=fallback)
        assert src.is_host_sharded
        loader = prepare_data_loader(src, num_processes=2, process_index=0,
                                     put_on_device=False)
        assert len(list(loader)) == len(src)


def test_drop_last_false_reports_remainder_through_the_loader(token_file):
    path, _ = token_file
    src = tn.TokenCorpusLoader(path, 128, 5, seed=1, drop_last=False)
    assert src.remainder == 78 - 15 * 5 and src.tail_layout == (1, 5, 3)
    assert tn.TokenCorpusLoader(path, 128, 6, drop_last=True).remainder == -1
    loader = DataLoaderShard(src, device="cpu")
    sizes = [b["input_ids"].shape[0] for b in loader]
    assert sizes == [5] * 16 and loader.remainder == 3
    assert loader.tail_layout == (1, 5, 3) and src.epoch == 1


def test_break_mid_epoch_then_a_full_pass(token_file):
    """A loop that breaks leaves the native producers mid-epoch; the next
    pass restarts them at the same epoch (the break finished no pass),
    and its batches equal the fallback's."""
    path, _ = token_file
    nat = tn.TokenCorpusLoader(path, 64, 4, seed=4)
    want = _collect(tn.TokenCorpusLoader(path, 64, 4, seed=4,
                                         force_fallback=True))
    loader = DataLoaderShard(nat, device="cpu")
    for i, batch in enumerate(loader):
        np.testing.assert_array_equal(batch["input_ids"].numpy(), want[i])
        if i == 2:
            break
    assert nat.epoch == 0 and loader.epoch == 0
    got = [b["input_ids"].numpy() for b in loader]
    assert len(got) == len(want) == len(nat)
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    assert nat.epoch == 1 and loader.epoch == 1


# --- the slice as a whole ---------------------------------------------------

STEPS = 3
LR = 3e-3


def _corpus(tmp_path):
    cfg = tl.LlamaConfig.tiny()
    path = str(tmp_path / "tiny.bin")
    tn.write_token_file(path, np.random.default_rng(0).integers(
        0, cfg.vocab_size, 40 * 17, dtype=np.int32))
    return path


def _flat(tree):
    return [np.asarray(x, np.float32) for _, x in sorted(
        jax.tree_util.tree_leaves_with_path(tree),
        key=lambda kv: jax.tree_util.keystr(kv[0]))]


def test_token_loader_feeds_train_step_like_jax(tmp_path):
    path = _corpus(tmp_path)
    cfg_j, cfg_t = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    pn = jax.tree_util.tree_map(np.asarray,
                                jl.init_params(cfg_j, jax.random.key(0)))

    at.PartialState._reset_state()
    jacc = at.Accelerator(mixed_precision="bf16", gradient_clipping=1.0)
    jstate = jacc.prepare(at.TrainState.create(
        apply_fn=None, params=jax.tree_util.tree_map(jnp.asarray, pn),
        tx=optax.adamw(LR)))
    jloader = jacc.prepare(jn.TokenCorpusLoader(path, 17, 8, seed=0))
    jstep = jacc.train_step(lambda p, b: jl.causal_lm_loss(cfg_j, p, b))
    jlosses, jbatches = [], []
    for batch in jloader:
        if len(jlosses) == STEPS:
            break
        jbatches.append(np.asarray(batch["input_ids"]))
        jstate, m = jstep(jstate, batch)
        jlosses.append(float(m["loss"]))
    at.PartialState._reset_state()

    acc = Accelerator(cpu=True, mixed_precision="bf16", gradient_clipping=1.0)
    state = acc.prepare(tt.TrainState.create(
        apply_fn=None, params=params_from_numpy(pn, device="cpu"),
        tx=to.adamw(LR)))
    loader = acc.prepare(tn.TokenCorpusLoader(path, 17, 8, seed=0))
    step = acc.train_step(lambda p, b: tl.causal_lm_loss(cfg_t, p, b))
    losses, batches = [], []
    for batch in loader:
        if len(losses) == STEPS:
            break
        batches.append(batch["input_ids"].numpy())
        state, m = step(state, batch)
        losses.append(float(m["loss"]))

    assert len(batches) == STEPS
    for a, b in zip(batches, jbatches):
        np.testing.assert_array_equal(a, b)
    assert state.step == int(jstate.step) == STEPS
    np.testing.assert_allclose(losses, jlosses, atol=2e-3, rtol=0)
    start = _flat(pn)
    for a, b, s in zip(_flat(params_to_numpy(state.params)),
                       _flat(jstate.params), start):
        moved = np.linalg.norm(b - s)
        if moved:
            assert np.linalg.norm((a - s) - (b - s)) / moved < 0.25
