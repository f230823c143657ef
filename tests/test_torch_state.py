"""The port's process surface (`accelerate_tpu_torch/state.py`) against
`accelerate_tpu.state` at one process, on the same inputs:

- the topology of one process (rank 0: main, local main and last);
- `split_between_processes` on lists, dicts of lists and arrays, with
  and without `apply_padding`, at world size 1; with `num_processes`
  patched to 2 or 3 it raises and names queue 1 item 6;
- the `on_*_process` decorators, `main_process_first`, `print`;
- `GradientState`'s sync flag, plugin fields, and the active loader's
  `remainder`/`tail_layout` with their defaults.

The JAX suite runs on 8 virtual CPU devices, so the device counts and
`use_distributed` differ by construction: the port drives one device.
Tolerance: exact (one process gets its input as it is)."""

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
    port = tstate.PartialState(cpu=True)
    monkeypatch.setattr(tstate.PartialState, "num_processes", world)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        with port.split_between_processes(list(range(7))):
            pass


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
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        tstate.PartialState(cpu=True, timeout=5)
