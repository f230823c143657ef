"""The port's two-stage input prefetch against the JAX package's: the
loader cases of `tests/test_prefetch.py` (`DevicePrefetchIterator`, and
`DataLoaderShard` with the device buffer), each run through both
packages on the same batches. Batches have 8 rows, a multiple of the
suite's 8 JAX CPU devices, so neither side pads. On the CPU the port's
placement makes no stream; the side-stream copy is held on the card
(`tests/test_torch_cuda.py::test_side_stream_prefetch_matches_host_batches_behind_a_long_kernel`).
"""

import threading

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu as at
from accelerate_tpu import data as jd
from accelerate_tpu.utils.dataclasses import DataLoaderConfiguration as \
    JConfig
from accelerate_tpu.utils.dataclasses import MeshConfig
from accelerate_tpu_torch import data as td
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration


@pytest.fixture(autouse=True)
def _cpu_state():
    PartialState._reset_state()
    PartialState(cpu=True)
    yield
    PartialState._reset_state()


def _mesh():
    return MeshConfig.data_parallel().build(jax.devices())


def _dict_batches(n_batches, rows=8, start=0):
    return [{"x": np.arange(start + i * rows, start + (i + 1) * rows,
                            dtype=np.float32).reshape(rows, 1)}
            for i in range(n_batches)]


def _loaders(batches, depth, **kw):
    return (td.DataLoaderShard(batches, device_prefetch_depth=depth, **kw),
            jd.DataLoaderShard(batches, mesh=_mesh(),
                               device_prefetch_depth=depth, **kw))


def _values(batches):
    return [np.asarray(b["x"])[:, 0].tolist() for b in batches]


# ---------------------------------------------------------------------------
# DevicePrefetchIterator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [td, jd], ids=["torch", "jax"])
class TestDevicePrefetchIterator:
    def test_ordering_preserved(self, mod):
        out = list(mod.DevicePrefetchIterator(range(10), lambda x: x * 10,
                                              depth=3))
        assert out == [i * 10 for i in range(10)]

    def test_transfers_stay_within_depth_ahead(self, mod):
        placed = []
        it = mod.DevicePrefetchIterator(
            range(10), lambda x: placed.append(x) or x, depth=2)
        consumed = 0
        for _ in it:
            consumed += 1
            assert len(placed) <= consumed + 2
        assert consumed == 10 and len(placed) == 10

    def test_prefetch_is_eager_after_first_next(self, mod):
        placed = []
        it = mod.DevicePrefetchIterator(
            range(10), lambda x: placed.append(x) or x, depth=3)
        assert next(it) == 0
        assert len(placed) == 4

    def test_empty_and_exhaustion(self, mod):
        it = mod.DevicePrefetchIterator([], lambda x: x, depth=2)
        with pytest.raises(StopIteration):
            next(it)
        it = mod.DevicePrefetchIterator([1], lambda x: x, depth=4)
        assert next(it) == 1
        with pytest.raises(StopIteration):
            next(it)

    def test_depth_floor_is_one(self, mod):
        assert list(mod.DevicePrefetchIterator(range(3), lambda x: x,
                                               depth=0)) == [0, 1, 2]


def test_cpu_device_makes_no_stream():
    it = td.DevicePrefetchIterator(range(3), lambda x: x, depth=2,
                                   device="cpu")
    assert it._stream is None and list(it) == [0, 1, 2]


# ---------------------------------------------------------------------------
# DataLoaderShard with the device buffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_ordering_and_placement_like_jax(depth):
    tl, jl = _loaders(_dict_batches(5), depth)
    got = list(tl)
    assert _values(got) == _values(list(jl))
    assert np.concatenate(_values(got)).tolist() == list(range(40))
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type ==
               "cpu" for b in got)


def test_epoch_boundary_bumps_epoch_and_reiterates():
    tl, jl = _loaders(_dict_batches(4), 2)
    for loader in (tl, jl):
        first = _values(loader)
        assert loader.epoch == 1
        second = _values(loader)
        assert loader.epoch == 2 and first == second and len(first) == 4


def test_end_detection_and_source_remainder_survive_prefetch():
    """One-batch-ahead end detection and the tail bookkeeping of a source
    that pads its own final round (a sharding iterable, or a token loader
    with drop_last=False) come through the device buffer."""
    class Source(list):
        remainder = 3
        tail_layout = (1, 8, 3)

    for depth in (0, 2):
        loader = td.DataLoaderShard(Source(_dict_batches(4)),
                                    device_prefetch_depth=depth)
        ends = []
        for _ in loader:
            ends.append(loader.end_of_dataloader)
        assert ends == [False, False, False, True]
        assert (loader.remainder, loader.tail_layout) == (3, (1, 8, 3))


def test_drop_last_style_source_not_padded_like_jax():
    tl, jl = _loaders(_dict_batches(3), 2)
    assert [int(b["x"].shape[0]) for b in tl] == [8, 8, 8]
    list(jl)
    assert tl.remainder == jl.remainder == -1


def test_uneven_tail_pads_only_where_devices_need_it():
    """The reference's test pads 3 rows to 8 over JAX's 8 suite devices
    and records remainder 3; the port's one card pads nothing."""
    batches = _dict_batches(3) + [
        {"x": np.arange(24, 27, dtype=np.float32).reshape(3, 1)}]
    tl, jl = _loaders(batches, 2)
    assert [int(b["x"].shape[0]) for b in jl][-1] == 8 and jl.remainder == 3
    assert [int(b["x"].shape[0]) for b in tl][-1] == 3 and tl.remainder == -1
    assert tl.end_of_dataloader and jl.end_of_dataloader


def test_config_threads_depth_through_prepare_like_jax():
    acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(
        device_prefetch_depth=5, prefetch_size=3))
    jacc = at.Accelerator(dataloader_config=JConfig(device_prefetch_depth=5,
                                                    prefetch_size=3))
    for a, cls in ((acc, td.DataLoaderShard), (jacc, jd.DataLoaderShard)):
        loader = a.prepare(_dict_batches(2))
        assert isinstance(loader, cls)
        assert (loader.device_prefetch_depth, loader.prefetch_size) == (5, 3)


def test_explicit_kwarg_beats_config_like_jax():
    for mod, cfg, kw in ((td, DataLoaderConfiguration(), {}),
                         (jd, JConfig(), {"mesh": _mesh()})):
        loader = mod.prepare_data_loader(
            _dict_batches(2), config=cfg, device_prefetch_depth=0,
            prefetch_size=7, **kw)
        assert (loader.device_prefetch_depth, loader.prefetch_size) == (0, 7)
        loader = mod.prepare_data_loader(
            _dict_batches(2), config=cfg.__class__(prefetch_size=4), **kw)
        assert (loader.device_prefetch_depth, loader.prefetch_size) == (2, 4)


def test_host_prep_on_the_worker_and_placement_on_the_consumer(monkeypatch):
    """The host thread converts and pads; the copy to the device (where a
    card's loader pins and issues it on the side stream) runs on the
    consuming thread."""
    where = {"host": set(), "place": set()}
    host, place = td.DataLoaderShard._prepare_host, td.to_device

    def spy_host(self, batch):
        where["host"].add(threading.get_ident())
        out = host(self, batch)
        assert isinstance(out[0]["x"], np.ndarray)
        return out

    def spy_place(*args, **kw):
        where["place"].add(threading.get_ident())
        return place(*args, **kw)

    monkeypatch.setattr(td.DataLoaderShard, "_prepare_host", spy_host)
    monkeypatch.setattr(td, "to_device", spy_place)
    for depth in (0, 2):
        where["host"].clear()
        where["place"].clear()
        got = list(td.DataLoaderShard(_dict_batches(4),
                                      device_prefetch_depth=depth))
        assert len(got) == 4
        assert where["place"] == {threading.get_ident()}
        assert threading.get_ident() not in where["host"]


def test_host_batches_are_numpy_without_placement_like_jax():
    batches = [{"x": torch.arange(8.0).reshape(8, 1), "n": ["a"] * 8}]
    (got,) = list(td.DataLoaderShard(batches, put_on_device=False))
    (want,) = list(jd.DataLoaderShard(batches, put_on_device=False))
    assert isinstance(got["x"], np.ndarray) and got["n"] == want["n"]
    np.testing.assert_array_equal(got["x"], want["x"])
