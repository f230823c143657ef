"""The port's process surface (`accelerate_tpu_torch/state.py`) against
`accelerate_tpu.state` at one process, on the same inputs:

- the topology of one process (rank 0: main, local main and last);
- `split_between_processes` on lists, dicts of lists and arrays, with
  and without `apply_padding`, at world size 1, and with both packages'
  `num_processes` and `process_index` patched to every rank of a world
  of 2 or 3;
- the `on_*_process` decorators, `main_process_first`, `print`;
- `GradientState`'s sync flag, plugin fields, and the active loader's
  `remainder`/`tail_layout` with their defaults.

The JAX suite runs on 8 virtual CPU devices, so the device counts and
`use_distributed` differ by construction: the port drives one device.
Tolerance: exact (one process gets its input as it is)."""

from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from accelerate_tpu import state as jstate
from accelerate_tpu.utils.dataclasses import \
    GradientAccumulationPlugin as JPlugin
from accelerate_tpu_torch import state as tstate
from accelerate_tpu_torch.utils.dataclasses import GradientAccumulationPlugin


@pytest.fixture(autouse=True)
def _fresh_state():
    tstate.PartialState._reset_state()
    jstate.PartialState._reset_state()
    yield
    tstate.PartialState._reset_state()
    jstate.PartialState._reset_state()


def _pair():
    return tstate.PartialState(cpu=True), jstate.PartialState()


def _values(x):
    if isinstance(x, dict):
        return {k: _values(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.numpy().tolist()
    if hasattr(x, "shape"):
        return np.asarray(x).tolist()
    return list(x)


def test_one_process_topology_matches_jax():
    port, ref = _pair()
    for name in ("num_processes", "process_index", "local_process_index",
                 "is_main_process", "is_local_main_process",
                 "is_last_process"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.device == torch.device("cpu") and port.devices == [port.device]
    assert port.device_count == port.local_device_count == 1
    assert not port.use_distributed
    acc_state = tstate.AcceleratorState(cpu=True)
    assert acc_state.dp_size == 1 and acc_state.num_processes == 1
    port.wait_for_everyone()
    port.destroy_process_group()


def _inputs():
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(7, 3)).astype(np.float32)
    return [("list", list(range(7)), list(range(7))),
            ("dict", {"a": list(range(7)), "b": list("abcdefg")},
             {"a": list(range(7)), "b": list("abcdefg")}),
            ("array", torch.tensor(arr), arr)]


@pytest.mark.parametrize("pad", [False, True])
def test_split_between_processes_matches_jax(pad):
    port, ref = _pair()
    for name, tin, jin in _inputs():
        with port.split_between_processes(tin, apply_padding=pad) as a, \
                ref.split_between_processes(jin, apply_padding=pad) as b:
            assert _values(a) == _values(b), name
            assert a is tin


@pytest.mark.parametrize("world", [2, 3])
def test_split_across_processes_raises_and_names_item_6(world, monkeypatch):
    """Across processes each rank's share (and its padding) is the
    reference's, rank by rank, on lists, dicts and arrays (the name is
    kept from when these forms raised)."""
    port, ref = _pair()
    monkeypatch.setattr(tstate.PartialState, "num_processes", world)
    monkeypatch.setattr(jstate.PartialState, "num_processes",
                        property(lambda self: world))
    for rank in range(world):
        monkeypatch.setattr(tstate.PartialState, "process_index", rank)
        monkeypatch.setattr(jstate.PartialState, "process_index",
                            property(lambda self, r=rank: r))
        for pad in (False, True):
            for name, tin, jin in _inputs():
                with port.split_between_processes(tin, pad) as a, \
                        ref.split_between_processes(jin, pad) as b:
                    assert _values(a) == _values(b), (name, rank, pad)


def test_process_decorators_main_first_and_print_match_jax(capsys):
    port, ref = _pair()
    for st in (port, ref):
        assert st.on_main_process(lambda: "main")() == "main"
        assert st.on_local_main_process(lambda: "local")() == "local"
        assert st.on_last_process(lambda: "last")() == "last"
        assert st.on_process(lambda: "zero", 0)() == "zero"
        assert st.on_process(lambda: "one", 1)() is None
        ran = []
        with st.main_process_first():
            ran.append(1)
        with st.local_main_process_first():
            ran.append(2)
        assert ran == [1, 2]
        st.print("hello", 3)
    assert capsys.readouterr().out == "hello 3\nhello 3\n"


@pytest.mark.parametrize("plugin", [
    dict(num_steps=2), dict(num_steps=3, adjust_scheduler=False,
                            sync_with_dataloader=False)],
    ids=["defaults", "off"])
def test_gradient_state_matches_jax(plugin):
    port = tstate.GradientState(GradientAccumulationPlugin(**plugin))
    ref = jstate.GradientState(JPlugin(**plugin))
    for gs in (port, ref):
        assert gs.remainder == -1 and gs.tail_layout is None
        assert not gs.end_of_dataloader
        gs._set_sync_gradients(False)
    for name in ("num_steps", "adjust_scheduler", "sync_with_dataloader",
                 "sync_gradients"):
        assert getattr(port, name) == getattr(ref, name), name
    loader = SimpleNamespace(end_of_dataloader=True, remainder=3,
                             tail_layout=(1, 4, 3))
    bare = SimpleNamespace()
    for gs in (port, ref):
        gs._add_dataloader(loader)
        assert (gs.end_of_dataloader, gs.remainder, gs.tail_layout) == \
            (True, 3, (1, 4, 3))
        gs._add_dataloader(bare)
        assert (gs.end_of_dataloader, gs.remainder, gs.tail_layout) == \
            (False, -1, None)
        gs._remove_dataloader(bare)
        gs._remove_dataloader(loader)
        assert not gs.in_dataloader


def test_options_of_a_process_group_raise_and_name_item_6():
    """The process group's options are taken; a world of one joins no
    group (as the reference's `_maybe_init_jax_distributed` returns
    False), and an unknown option is a TypeError (the name is kept from
    when the options raised)."""
    st = tstate.PartialState(cpu=True, backend="gloo",
                             timeout=timedelta(seconds=5))
    assert st.num_processes == 1 and not st.use_distributed
    assert not torch.distributed.is_initialized()
    assert st.mesh.shape == {"data": 1}
    tstate.PartialState._reset_state()
    with pytest.raises(TypeError):
        tstate.PartialState(cpu=True, bogus=1)


@pytest.mark.parametrize("backend, device, local_world, count, want", [
    (None, "cpu", 2, 0, "gloo"), ("gloo", "cpu", 4, 0, "gloo"),
    (None, "cuda", 2, 2, "nccl"), ("nccl", "cuda", 1, 1, "nccl"),
    ("gloo", "cuda", 2, 1, "gloo"), ("GLOO", "cuda", 8, 1, "gloo")],
    ids=["cpu", "cpu_gloo", "cuda_one_each", "cuda_nccl", "shared_gloo",
         "shared_gloo_upper"])
def test_backend_rule_by_device(backend, device, local_world, count, want,
                                monkeypatch):
    """NCCL on cards, gloo on the CPU; ranks share a card only under an
    explicit gloo. Decided from the device and the counts alone."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert tstate._resolve_backend(backend, torch.device(device),
                                   local_world) == want


def test_backend_rule_refuses_before_joining(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match='backend="gloo"'):
        tstate._resolve_backend(None, torch.device("cuda"), 2)
    with pytest.raises(ValueError, match="needs CUDA"):
        tstate._resolve_backend("nccl", torch.device("cpu"), 2)
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        tstate._resolve_backend("mpi", torch.device("cpu"), 2)
    assert not torch.distributed.is_initialized()


def test_mesh_resolution_like_jax(monkeypatch):
    """Explicit `mesh_config`, then the launcher's variable, then every
    process on `data`; an axis other than `data` above 1 raises naming
    item 6b. Shapes as the reference resolves them over as many devices
    (the port's devices are its processes)."""
    from accelerate_tpu.utils.dataclasses import MeshConfig as JMesh
    from accelerate_tpu_torch.utils.constants import ENV_MESH_SHAPE
    from accelerate_tpu_torch.utils.dataclasses import MeshConfig

    for axes in ({"data": -1}, {"data": 1, "fsdp": 1}, {"data": 2}, {}):
        for n in (1, 2, 4):
            try:
                want = JMesh(axes=dict(axes)).resolved_axes(n)
            except ValueError:
                with pytest.raises(ValueError, match="devices"):
                    MeshConfig(axes=dict(axes)).resolved_axes(n)
                continue
            assert MeshConfig(axes=dict(axes)).resolved_axes(n) == want
    st = tstate.AcceleratorState(cpu=True)
    assert st.mesh.shape == {"data": 1} and st.mesh.groups == {"data": None}
    tstate.PartialState._reset_state()
    monkeypatch.setenv(ENV_MESH_SHAPE, "data=1,fsdp=1")
    assert tstate.AcceleratorState(cpu=True).mesh.shape == \
        {"data": 1, "fsdp": 1}
    tstate.PartialState._reset_state()
    assert tstate.AcceleratorState(
        cpu=True, mesh_config=MeshConfig(axes={"data": -1})).mesh.shape == \
        {"data": 1}
    for axes in ({"model": 2}, {"fsdp": 2}, {"data": 1, "seq": 4}):
        tstate.PartialState._reset_state()
        with pytest.raises(NotImplementedError, match="queue 1 item 6b"):
            tstate.AcceleratorState(cpu=True,
                                    mesh_config=MeshConfig(axes=axes))
    with pytest.raises(ValueError, match="unknown mesh axes"):
        MeshConfig(axes={"tensor": 2})


def test_mesh_does_not_keep_the_group_alive():
    """`destroy_process_group` ends the group's threads though the mesh
    is still held: a mesh that kept the group left gloo's threads running
    at exit, where a process could abort after its work was done."""
    from accelerate_tpu_torch.test_utils import run_world
    from accelerate_tpu_torch.test_utils.worlds import teardown_forms

    for r in run_world(teardown_forms, 2):
        assert r["live"] and r["after"] == {"data": False}
        assert not [t for t in r["threads"] if "gloo" in t], r["threads"]
