"""The port's data layer (`accelerate_tpu_torch/data.py`) against the JAX
package's (`accelerate_tpu/data.py`): the cases of
`tests/test_data_loader.py`, each fed the same numpy batches through both
and held to equal batches, orders, lengths and remainders (host
sharding is exact, so equality is exact; placed batches are compared by
value, since the JAX side without x64 stores int64 as int32).

One difference is the reference's own rule, not a port fault: a loader
pads a batch of `n` rows where `n` is not a multiple of the process's
data-parallel devices. The suite gives JAX 8 CPU devices, so it pads a
batch of 4 to 8; the port drives one card, so it pads nothing
(`test_uneven_final_batch_padded_only_where_devices_need_it`).
"""

import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu as at
from accelerate_tpu import data as jd
from accelerate_tpu.utils import random as jrandom
from accelerate_tpu_torch import data as td
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.state import GradientState, PartialState
from accelerate_tpu_torch.utils import random as trandom


@pytest.fixture(autouse=True)
def _cpu_state():
    PartialState._reset_state()
    PartialState(cpu=True)
    yield
    PartialState._reset_state()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, jax.Array):
        return np.asarray(tree)
    return tree


def _same(a, b, dtype=True):
    """Equal trees: the same structure (dict keys in any order), equal
    leaves; arrays equal in value, and in dtype unless `dtype=False`."""
    a, b = _np(a), _np(b)
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (a, b)
        for k in a:
            _same(a[k], b[k], dtype)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y, dtype)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if dtype:
            assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


class SimpleBatchSampler:
    def __init__(self, n, batch_size, drop_last=False):
        self.indices = list(range(n))
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for i in self.indices:
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return len(self.indices) // self.batch_size
        return -(-len(self.indices) // self.batch_size)


def make_batches(n, batch_size):
    data = np.arange(n)
    return [{"x": data[i:i + batch_size].reshape(-1, 1).astype(np.float32),
             "y": data[i:i + batch_size].astype(np.int32)}
            for i in range(0, n, batch_size)]


# --- samplers ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_seedable_sampler_like_jax(seed):
    for n in (1, 10, 37):
        j, t = jd.SeedableRandomSampler(n, seed=seed), \
            td.SeedableRandomSampler(n, seed=seed)
        for epoch in range(3):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            assert list(t) == list(j) and len(t) == len(j) == n
    s = td.SeedableRandomSampler(10, seed=seed)
    first = list(s)
    assert sorted(first) == list(range(10)) and list(s) == first
    s.set_epoch(1)
    assert list(s) != first


@pytest.mark.parametrize("n,bs,P,kw", [
    (16, 2, 2, {}),                          # stride, even
    (10, 2, 2, {}),                          # uneven tail: wraparound
    (10, 2, 2, {"even_batches": False}),
    (16, 4, 2, {"split_batches": True}),
    (17, 3, 4, {}),
    (17, 3, 4, {"drop_last": True}),
    (5, 4, 4, {}),
], ids=["stride_even", "uneven_wraparound", "uneven_no_even_batches",
        "split_batches", "short_tail_world4", "drop_last", "fewer_batches"])
def test_batch_sampler_shard_like_jax(n, bs, P, kw):
    drop_last = kw.pop("drop_last", False)
    got, want = [], []
    for rank in range(P):
        t = td.BatchSamplerShard(SimpleBatchSampler(n, bs, drop_last), P,
                                 rank, **kw)
        j = jd.BatchSamplerShard(SimpleBatchSampler(n, bs, drop_last), P,
                                 rank, **kw)
        got.append(list(t))
        want.append(list(j))
        assert len(t) == len(j)
    assert got == want


def test_batch_sampler_shard_reference_cases():
    base = SimpleBatchSampler(16, 2)
    shards = [list(td.BatchSamplerShard(base, num_processes=2,
                                        process_index=i)) for i in range(2)]
    assert shards[0][0] == [0, 1] and shards[1][0] == [2, 3]
    assert sorted(i for s in shards for b in s for i in b) == list(range(16))
    s1 = list(td.BatchSamplerShard(SimpleBatchSampler(10, 2), 2, 1))
    assert len(s1) == 3 and all(i < 4 for i in s1[-1])
    with pytest.raises(ValueError):
        list(td.BatchSamplerShard(SimpleBatchSampler(9, 3), 2, 0,
                                  split_batches=True))
    # checked lazily: a one-shot iterator keeps its first batch
    gen = iter(SimpleBatchSampler(16, 4))
    assert list(td.BatchSamplerShard(gen, 2, 0,
                                     split_batches=True))[0] == [0, 1]


@pytest.mark.parametrize("kw", [{}, {"drop_last": True},
                                {"split_batches": True}],
                         ids=["pad", "drop_last", "split"])
def test_iterable_dataset_shard_like_jax(kw):
    for rank in range(2):
        got = list(td.IterableDatasetShard(range(10), batch_size=2,
                                           num_processes=2,
                                           process_index=rank, **kw))
        assert got == list(jd.IterableDatasetShard(
            range(10), batch_size=2, num_processes=2, process_index=rank,
            **kw))
    assert list(td.IterableDatasetShard(range(10), 2, 2, 1)) == \
        [2, 3, 6, 7, 0, 1]


def test_even_batches_property_like_jax():
    """The reference's 120 pinned configurations: every rank the same
    count, every real sample on some rank, and the port's shards equal
    to the JAX package's."""
    rng = random.Random(7)
    for _ in range(120):
        n = rng.randint(1, 50)
        bs = rng.randint(1, 8)
        world = rng.choice([2, 4])
        drop_last = rng.random() < 0.5
        base = [list(range(i, min(i + bs, n))) for i in range(0, n, bs)]
        if drop_last and base and len(base[-1]) < bs:
            base = base[:-1]
        shards = [[list(b) for b in td.BatchSamplerShard(
            base, num_processes=world, process_index=rank)]
            for rank in range(world)]
        assert shards == [[list(b) for b in jd.BatchSamplerShard(
            base, num_processes=world, process_index=rank)]
            for rank in range(world)]
        assert len({len(s) for s in shards}) == 1
        if base:
            assert {x for b in base for x in b} <= \
                {x for s in shards for b in s for x in b}


# --- host conversion and padding ---------------------------------------------


def test_pad_batch_to_like_jax():
    for batch, target, rows in (
            ({"x": np.arange(3)}, 8, None),
            ({"x": np.arange(10, dtype=np.float32),
              "ids": [np.asarray([1, 2, 3]), np.asarray([4, 5])] * 5},
             12, 10),
            ({"x": np.arange(10, dtype=np.float32),
              "ids": [np.asarray([1, 2, 3]), np.asarray([4, 5])] * 5},
             12, None),
            ({"w": np.ones(3), "x": np.ones((5, 2)), "n": ["a", "b"]}, 8, 5),
            ((torch.arange(4), ["a", "b", "c", "d"]), 6, 4)):
        _same(td.pad_batch_to(batch, target, rows),
              jd.pad_batch_to(batch, target, rows))
    out = td.pad_batch_to({"x": np.arange(3)}, 8)
    np.testing.assert_array_equal(out["x"], [0, 1, 2, 0, 1, 2, 0, 1])


def test_ragged_rows_padded_by_row_not_token():
    batch = {"x": np.arange(10, dtype=np.float32),
             "ids": [np.asarray([1, 2, 3]), np.asarray([4, 5])] * 5}
    out = td.pad_batch_to(batch, 12, rows=10)
    assert len(out["ids"]) == 12 and out["ids"][0].tolist() == [1, 2, 3]
    assert out["x"].shape[0] == 12
    out2 = td.pad_batch_to(batch, 12)
    assert len(out2["ids"]) == 10 and out2["ids"][1].tolist() == [4, 5]


@pytest.mark.parametrize("batch", [
    {"a_weights": np.ones((3,)), "x": np.ones((8, 2)), "y": np.ones((8,))},
    {"ids": [[1, 2], [3]], "x": np.ones((2, 4))},
    {"class_names": ["pos", "neg"], "x": np.zeros((8, 2))},
    [np.arange(8), np.arange(8)],
    {"empty": [], "x": torch.zeros(4, 3)},
    ["a", "b", "c"],
    {"s": 3},
], ids=["majority_dim", "ragged", "metadata_list", "field_list",
        "empty_container", "strings", "unsized"])
def test_batch_size_like_jax(batch):
    assert td._batch_size(batch) == jd._batch_size(batch)


def test_batch_to_numpy_like_jax_and_keeps_device_tensors():
    batch = {"t": torch.arange(6).reshape(2, 3), "g": np.float32(2.0),
             "l": [1, 2], "s": "name", "n": None}
    _same(td.batch_to_numpy(batch), jd.batch_to_numpy(batch))
    assert isinstance(td.batch_to_numpy(batch)["t"], np.ndarray)
    # a host tensor becomes numpy; only a tensor on a card stays a tensor
    kept = td.batch_to_numpy(batch, keep_device_arrays=True)
    assert isinstance(kept["t"], np.ndarray)
    meta = torch.empty(2, device="meta")
    assert td.batch_to_numpy({"m": meta}, keep_device_arrays=True)["m"] \
        is meta


# --- loaders ----------------------------------------------------------------


def test_dataloader_shard_end_detection_like_jax():
    gs, jgs = GradientState(), at.GradientState()
    for mod, state in ((td, gs), (jd, jgs)):
        ends = []
        for batch in mod.DataLoaderShard(make_batches(32, 8)):
            ends.append(state.end_of_dataloader)
        assert ends == [False, False, False, True]
        assert not state.in_dataloader
    got = list(td.DataLoaderShard(make_batches(32, 8)))
    assert all(isinstance(b["x"], torch.Tensor) for b in got)
    _same(got, list(jd.DataLoaderShard(make_batches(32, 8))), dtype=False)


def test_uneven_final_batch_padded_only_where_devices_need_it():
    """The reference's per_host rule: JAX's 8 suite devices pad a batch of
    4 to 8 and record remainder 4; one card pads nothing."""
    jl = jd.DataLoaderShard(make_batches(20, 8))
    jb = list(jl)
    assert jb[-1]["x"].shape[0] == 8 and jl.remainder == 4
    tl = td.DataLoaderShard(make_batches(20, 8))
    tb = list(tl)
    assert tb[-1]["x"].shape[0] == 4 and tl.remainder == -1
    # host batches (no placement) are the same in both
    _same(list(td.DataLoaderShard(make_batches(20, 8), put_on_device=False)),
          list(jd.DataLoaderShard(make_batches(20, 8), put_on_device=False)))


def test_dataloader_shard_epoch_advances_the_source():
    class EpochAware:
        epoch = None

        def __init__(self):
            self.batches = make_batches(8, 4)

        def set_epoch(self, e):
            EpochAware.epoch = e

        def __iter__(self):
            return iter(self.batches)

        def __len__(self):
            return len(self.batches)

    loader = td.DataLoaderShard(EpochAware())
    list(loader)
    assert EpochAware.epoch == 1 and loader.epoch == 1
    list(loader)
    assert EpochAware.epoch == 2


def test_dataloader_dispatcher_single_process_like_jax():
    got = list(td.DataLoaderDispatcher(make_batches(16, 4)))
    want = list(jd.DataLoaderDispatcher(make_batches(16, 4)))
    assert len(got) == 4 and isinstance(got[0]["x"], torch.Tensor)
    _same(got, want, dtype=False)
    np.testing.assert_array_equal(
        np.concatenate([b["y"].numpy() for b in got]), np.arange(16))
    names = [f"n{i}" for i in range(10)]
    src = [{"x": np.arange(10, dtype=np.float32), "names": names}]
    (batch,) = list(td.DataLoaderDispatcher(src))
    assert batch["names"] == names


def test_dispatcher_slices_ragged_rows_by_row(monkeypatch):
    ids = [np.asarray([1, 2, 3]), np.asarray([4, 5]), np.asarray([6]),
           np.asarray([7, 8, 9]), np.asarray([10]), np.asarray([11, 12])]
    batch = {"ids": ids, "x": np.arange(6, dtype=np.float32)}

    class FakeState:
        num_processes = 2
        process_index = 1
        is_main_process = True

    def fake_fetch(source):
        item = next(source, None)
        return (item, item is None)

    outs = []
    for mod in (td, jd):
        loader = mod.DataLoaderDispatcher([batch], put_on_device=False)
        monkeypatch.setattr(loader, "state", FakeState())
        monkeypatch.setattr(loader, "_fetch_and_broadcast", fake_fetch)
        (got,) = list(loader)
        outs.append(got)
    assert [t.tolist() for t in outs[0]["ids"]] == [[7, 8, 9], [10], [11, 12]]
    _same(outs[0], outs[1])


def test_dispatcher_across_processes_raises(monkeypatch):
    loader = td.DataLoaderDispatcher(make_batches(8, 4))
    monkeypatch.setattr(PartialState, "num_processes", 2)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        list(loader)


def test_skip_first_batches_like_jax():
    loader = td.DataLoaderShard(make_batches(32, 8))
    batches = list(td.skip_first_batches(loader, 2))
    assert len(batches) == 2
    np.testing.assert_array_equal(batches[0]["y"].numpy(), np.arange(16, 24))
    _same(batches, list(jd.skip_first_batches(
        jd.DataLoaderShard(make_batches(32, 8)), 2)), dtype=False)
    assert len(list(loader)) == 4   # the original loader is untouched
    assert list(td.SkipDataLoader(list(range(5)), 3)) == [3, 4]
    disp = td.skip_first_batches(td.DataLoaderDispatcher(make_batches(16, 4)),
                                 3)
    assert isinstance(disp, td.DataLoaderDispatcher) and len(disp) == 1


def test_prepare_data_loader_kinds_like_jax():
    loader = td.prepare_data_loader(make_batches(16, 4))
    assert isinstance(loader, td.DataLoaderShard) and len(list(loader)) == 4
    with pytest.warns(UserWarning, match="no effect"):
        loader = td.prepare_data_loader(make_batches(16, 4),
                                        dispatch_batches=True,
                                        prefetch_size=3)
    assert isinstance(loader, td.DataLoaderDispatcher)
    assert len(list(loader)) == 4


def _torch_loader(shuffle=False):
    import torch.utils.data as tud

    class DS(tud.Dataset):
        def __len__(self):
            return 16

        def __getitem__(self, i):
            return {"x": np.float32(i)}

    return tud.DataLoader(DS(), batch_size=2, shuffle=shuffle)


@pytest.mark.parametrize("kw", [
    {}, {"split_batches": True}, {"even_batches": False},
    {"shuffle": True}], ids=["stride", "split", "uneven", "seedable"])
def test_prepare_torch_loader_resharded_like_jax(kw):
    shuffle = kw.pop("shuffle", False)
    for rank in range(2):
        got = list(td.prepare_data_loader(
            _torch_loader(shuffle), num_processes=2, process_index=rank,
            put_on_device=False, **kw))
        want = list(jd.prepare_data_loader(
            _torch_loader(shuffle), num_processes=2, process_index=rank,
            put_on_device=False, **kw))
        _same(got, want)
    got = list(td.prepare_data_loader(_torch_loader(), num_processes=2,
                                      process_index=0, put_on_device=False))
    assert len(got) == 4
    np.testing.assert_array_equal(got[1]["x"], [4.0, 5.0])


def test_prepare_unsized_iterable_and_host_sharded_source_like_jax():
    def stream():
        yield from ({"x": np.full((2,), i, np.float32)} for i in range(5))

    for rank in range(2):
        _same(list(td.prepare_data_loader(stream(), num_processes=2,
                                          process_index=rank,
                                          put_on_device=False)),
              list(jd.prepare_data_loader(stream(), num_processes=2,
                                          process_index=rank,
                                          put_on_device=False)))

    class Sharded:
        is_host_sharded = True

        def __len__(self):
            return 3

        def __iter__(self):
            return iter(make_batches(6, 2))

    assert len(list(td.prepare_data_loader(
        Sharded(), num_processes=2, process_index=0,
        put_on_device=False))) == 3


def test_prepare_split_batches_plain_iterable():
    batches = [{"x": np.arange(8, dtype=np.float32)}]
    (got,) = list(td.prepare_data_loader(batches, num_processes=2,
                                         process_index=1, split_batches=True,
                                         put_on_device=False))
    np.testing.assert_array_equal(got["x"], np.arange(4, 8))


# --- ShardedBatchIterable: every case of the reference ---------------------


def _shard(mod, batches, P, **kw):
    its = [mod.ShardedBatchIterable(batches, P, r, **kw) for r in range(P)]
    return [list(it) for it in its], [it.remainder for it in its], \
        [len(it) for it in its]


_SHARD_CASES = {
    "lockstep_shapes": ([{"x": np.arange(8, dtype=np.float32)},
                         {"x": np.arange(8, 16, dtype=np.float32)},
                         {"x": np.arange(16, 22, dtype=np.float32)}], {}),
    "uneven_no_even_batches": (
        [{"x": np.full((4,), i, np.float32)} for i in range(5)],
        {"even_batches": False}),
    "short_tail_divisible_count": (
        [{"x": np.arange(4 * i, 4 * i + 4, dtype=np.float32)}
         for i in range(3)] + [{"x": np.arange(12, 14, dtype=np.float32)}],
        {}),
    "full_final_round": ([{"x": np.full((4,), i, np.float32)}
                          for i in range(4)], {}),
    "split_mode": ([{"x": np.arange(8, dtype=np.float32)},
                    {"x": np.arange(8, 16, dtype=np.float32)},
                    {"x": np.arange(16, 22, dtype=np.float32)}],
                   {"split_batches": True}),
    "split_scalar_leaf": ([{"x": np.arange(8, dtype=np.float32),
                            "w": np.float32(0.5)}], {"split_batches": True}),
    "split_string_list": ([{"x": np.arange(4, dtype=np.float32),
                            "text": ["a", "b", "c", "d"]}],
                          {"split_batches": True}),
    "split_tuple_batch": ([(np.arange(8, dtype=np.float32),
                            np.arange(100, 108, dtype=np.int64))],
                          {"split_batches": True}),
    "split_top_level_strings": ([["a", "b", "c", "d"]],
                                {"split_batches": True}),
    "split_row_container_short_tail": ([["a", "b", "c", "d"], ["e", "f"]],
                                       {"split_batches": True}),
    "stride_variable_sizes_no_even": (
        [{"x": np.arange(4, dtype=np.float32)},
         {"x": np.arange(6, dtype=np.float32)},
         {"x": np.arange(4, dtype=np.float32)}], {"even_batches": False}),
    "split_numpy_scalar_rows": ([[np.int64(1), np.int64(2), np.int64(3),
                                  np.int64(4)]], {"split_batches": True}),
    "split_zero_d_rows": ([{"x": np.arange(4, dtype=np.float32),
                            "y": [np.asarray(i) for i in range(1, 5)]}],
                          {"split_batches": True}),
    "split_ragged_token_lists": ([{"x": np.arange(4, dtype=np.float32),
                                   "y": [[1, 2], [3, 4, 5], [6], [7, 8]]}],
                                 {"split_batches": True}),
    "split_ragged_arrays": ([[np.asarray([1, 2]), np.asarray([3, 4, 5]),
                              np.asarray([6]), np.asarray([7, 8])]],
                            {"split_batches": True}),
    "split_collate_field_list": ([[np.arange(8, dtype=np.float32),
                                   np.arange(100, 108)]],
                                 {"split_batches": True}),
    "split_equal_length_rows_with_context": (
        [{"x": np.arange(4, dtype=np.float32),
          "y": [np.asarray([1, 2]), np.asarray([3, 4]), np.asarray([5, 6]),
                np.asarray([7, 8])]}], {"split_batches": True}),
    "split_square_collate_pair": ([[np.arange(2, dtype=np.float32),
                                    np.arange(100, 102)]],
                                  {"split_batches": True}),
    "split_torch_ragged_rows": ([{"x": np.arange(2, dtype=np.float32),
                                  "y": [torch.tensor([1, 2, 3]),
                                        torch.tensor([4, 5])]}],
                                {"split_batches": True}),
    "split_ragged_key_sorts_first": (
        [{"ids": [np.asarray([1, 2, 3, 4]), np.asarray([5]),
                  np.asarray([6, 7]), np.asarray([8, 9, 10]),
                  np.asarray([11]), np.asarray([12, 13])],
          "x": np.arange(6, dtype=np.float32)}], {"split_batches": True}),
    "split_equal_length_tail": (
        [{"x": np.arange(4, dtype=np.float32),
          "y": [[1, 2], [3, 4, 5], [6], [7, 8]]},
         {"x": np.arange(2, dtype=np.float32),
          "y": [np.asarray([1, 2, 3, 4]), np.asarray([5, 6, 7, 8])]}],
        {"split_batches": True}),
    "split_ambiguous_list_key_order": (
        [{"a_ids": [np.asarray([1, 2]), np.asarray([3, 4]),
                    np.asarray([5, 6]), np.asarray([7, 8])],
          "z": np.arange(4, dtype=np.float32)}], {"split_batches": True}),
    "split_empty_container": ([{"empty": [],
                                "x": np.arange(4, dtype=np.float32)}],
                              {"split_batches": True}),
    "split_short_metadata_list": ([{"class_names": ["pos", "neg"],
                                    "x": np.zeros((8, 2), np.float32)}],
                                  {"split_batches": True}),
    "stride_short_array_with_metadata_list": (
        [{"x": np.arange(8, dtype=np.float32), "names": ["a"] * 8},
         {"x": np.arange(4, dtype=np.float32), "names": ["a"] * 8}], {}),
    "split_aux_array": ([{"a_x": np.zeros((8, 2), np.float32),
                          "z_w": np.asarray([0.2, 0.3, 0.5], np.float32)}],
                        {"split_batches": True}),
    "split_torch_array_leaves": ([{"x": torch.arange(8).reshape(8, 1)}],
                                 {"split_batches": True}),
}


@pytest.mark.parametrize("name", sorted(_SHARD_CASES))
def test_sharded_batch_iterable_like_jax(name):
    batches, kw = _SHARD_CASES[name]
    got, rem, lens = _shard(td, batches, 2, **kw)
    want, jrem, jlens = _shard(jd, batches, 2, **kw)
    _same(got, want)
    assert rem == jrem and lens == jlens


def test_sharded_batch_iterable_reference_values():
    got, rem, _ = _shard(td, *_SHARD_CASES["lockstep_shapes"][:1], 2)
    assert [len(h) for h in got] == [2, 2]
    assert all(b["x"].shape == (8,) for h in got for b in h)
    np.testing.assert_array_equal(got[0][1]["x"][:6], np.arange(16, 22))
    got, rem, _ = _shard(td, _SHARD_CASES["short_tail_divisible_count"][0], 2)
    assert rem == [6, 6]
    got, rem, _ = _shard(td, _SHARD_CASES["split_mode"][0], 2,
                         split_batches=True)
    tail = np.concatenate([got[0][2]["x"], got[1][2]["x"]])
    np.testing.assert_array_equal(tail[:6], np.arange(16, 22))
    assert rem == [6, 6]
    got, rem, _ = _shard(td, _SHARD_CASES["split_row_container_short_tail"][0],
                         2, split_batches=True)
    assert got[0][1] == ["e", "f"] and (got[0][1] + got[1][1])[:rem[0]] == \
        ["e", "f"]
    got, _, _ = _shard(td, _SHARD_CASES["split_torch_ragged_rows"][0], 2,
                       split_batches=True)
    assert [list(map(int, t)) for t in got[1][0]["y"]] == [[4, 5]]


@pytest.mark.parametrize("batches,kw,match", [
    ([{"x": np.arange(8, dtype=np.float32)},
      {"x": np.arange(8, 13, dtype=np.float32)}],
     {"even_batches": False, "split_batches": True}, "short final batch"),
    ([{"x": np.arange(4, dtype=np.float32)},
      {"x": np.arange(2, dtype=np.float32)},
      {"x": np.arange(4, dtype=np.float32)}], {}, "only the final batch"),
    ([{"x": np.arange(4, dtype=np.float32)},
      {"x": np.arange(12, dtype=np.float32)}],
     {"split_batches": True}, "may not grow"),
    ([{"x": np.arange(4, dtype=np.float32)},
      {"x": np.arange(6, dtype=np.float32)}], {}, "may not grow"),
], ids=["split_short_tail_no_even", "stride_short_midstream",
        "split_oversized", "stride_oversized_final"])
def test_sharded_batch_iterable_raises_like_jax(batches, kw, match):
    for mod in (td, jd):
        with pytest.raises(ValueError, match=match):
            list(mod.ShardedBatchIterable(batches, 2, 0, **kw))


# --- the host prefetch thread -------------------------------------------------


def test_prefetch_iterator_close_reaps_worker_mid_epoch():
    produced = []

    def source():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = td._PrefetchIterator(source(), prepare=lambda x: x * 2, depth=1)
    assert next(it) == 0
    assert it._thread.is_alive()
    it.close()
    assert not it._thread.is_alive()
    assert len(produced) < 10, produced
    it.close()                         # idempotent


def test_prefetch_iterator_close_unparks_blocked_worker():
    it = td._PrefetchIterator(iter(range(100)), prepare=lambda x: x, depth=1)
    deadline = time.monotonic() + 5
    while it._queue.qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    it.close()
    assert not it._thread.is_alive()


def test_prefetch_iterator_raises_the_source_error_on_the_consumer():
    def source():
        yield 1
        raise KeyError("bad sample")

    it = td._PrefetchIterator(source(), prepare=lambda x: x, depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="bad sample"):
        next(it)
    it.close()


@pytest.mark.parametrize("put_on_device", [False, True],
                         ids=["host", "placed"])
def test_loader_break_mid_epoch_leaves_no_thread_and_no_registration(
        put_on_device):
    before = {t.ident for t in threading.enumerate()}
    gs = GradientState()
    loader = td.DataLoaderShard(make_batches(64, 4),
                                put_on_device=put_on_device)
    for i, _batch in enumerate(loader):
        assert gs.active_dataloader is loader
        if i == 1:
            break
    leaked = [t for t in threading.enumerate()
              if t.ident not in before and t.is_alive()]
    assert leaked == []
    assert not gs.in_dataloader and loader not in gs.dataloader_references


# --- the Accelerator's loader --------------------------------------------------


def test_mesh_raises_naming_the_parallelism_slice():
    for cls in (td.DataLoaderShard, td.DataLoaderDispatcher):
        with pytest.raises(NotImplementedError, match="queue 1 item 6"):
            cls(make_batches(8, 4), mesh="a mesh")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        td.prepare_data_loader(make_batches(8, 4), mesh="a mesh")


def test_rng_types_synchronised_at_iter(monkeypatch):
    calls = []
    monkeypatch.setattr(td, "synchronize_rng_states",
                        lambda types, gen=None: calls.append(list(types)))
    loader = td.DataLoaderShard(make_batches(8, 4), rng_types=["torch"])
    list(loader)
    list(loader)
    assert calls == [["torch"], ["torch"]]


def test_accelerator_prepares_through_prepare_data_loader():
    from accelerate_tpu_torch.utils.dataclasses import \
        DataLoaderConfiguration

    acc = Accelerator(cpu=True, rng_types=["python", "numpy"],
                      dataloader_config=DataLoaderConfiguration(
                          prefetch_size=3, device_prefetch_depth=0))
    loader = acc.prepare(make_batches(16, 4))
    assert isinstance(loader, td.DataLoaderShard)
    assert (loader.prefetch_size, loader.device_prefetch_depth,
            loader.rng_types) == (3, 0, ["python", "numpy"])
    assert [b["y"][0].item() for b in loader] == [0, 4, 8, 12]
    assert acc._dataloaders == [loader]
    PartialState._reset_state()
    acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(
        dispatch_batches=True))
    assert isinstance(acc.prepare(make_batches(8, 4)),
                      td.DataLoaderDispatcher)


def test_join_uneven_inputs_reaches_the_batch_sampler_shard():
    """DataLoaderShard -> torch DataLoader -> BatchSamplerShard: the
    override reaches every even_batches on the chain and restores it."""
    acc = Accelerator(cpu=True)
    loader = td.prepare_data_loader(_torch_loader(), num_processes=2,
                                    process_index=0, put_on_device=False)
    acc._dataloaders.append(loader)
    shard = loader.loader.batch_sampler
    assert isinstance(shard, td.BatchSamplerShard) and shard.even_batches
    with acc.join_uneven_inputs([], even_batches=False):
        assert not loader.even_batches and not shard.even_batches
    assert loader.even_batches and shard.even_batches


def test_gather_for_metrics_keeps_every_row_at_world_size_one():
    """One process never gets a padded loader, so nothing is trimmed (the
    padded-tail trim arrives with the parallelism slice)."""
    acc = Accelerator(cpu=True)
    loader = acc.prepare(make_batches(20, 8))
    seen = [acc.gather_for_metrics(b["y"]) for b in loader]
    assert [len(s) for s in seen] == [8, 8, 4] and loader.remainder == -1
    assert torch.equal(torch.cat(seen), torch.arange(20, dtype=torch.int32))


# --- utils/random ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 42, 2**40 + 7])
def test_set_seed_draws_like_jax(seed):
    def draws():
        return (random.random(), np.random.rand(3).tolist(),
                torch.rand(3).tolist(), torch.randint(0, 1000, (4,)).tolist())

    assert trandom.set_seed(seed) == seed
    got = draws()
    assert jrandom.set_seed(seed) == seed
    assert draws() == got
    assert trandom.set_seed(seed, device_specific=True) == seed


def test_rng_keys_fold_in_deterministically():
    key = trandom.rng_key(7)
    assert key == (7, 0) and trandom.rng_key(2**33 + 1) == (1, 2)
    steps = [trandom.fold_in_step(key, s) for s in range(64)]
    assert len(set(steps)) == 64 and steps[3] == trandom.fold_in_step(key, 3)
    assert trandom.fold_in_process(key) == trandom.fold_in_process(key, 0)
    assert trandom.fold_in_process(key, 1) != trandom.fold_in_process(key, 0)
    # a folded key draws through the sampling hash like any other
    from accelerate_tpu_torch.models.decode import uniform

    keys = torch.tensor([steps[0], steps[1]], dtype=torch.int64)
    u = uniform(keys, torch.zeros(2, dtype=torch.int64))
    assert u.shape == (2,) and u[0] != u[1]


def test_synchronize_rng_states_one_process_and_across(monkeypatch):
    trandom.synchronize_rng_states(["torch", "numpy", "python", "generator",
                                    "jax"])
    monkeypatch.setattr(PartialState, "num_processes", 2)
    trandom.synchronize_rng_state("jax")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        trandom.synchronize_rng_state("torch")
