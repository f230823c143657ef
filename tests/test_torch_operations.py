"""The port's tree utilities and one-process collectives
(`accelerate_tpu_torch/utils/operations.py`) against
`accelerate_tpu.utils.operations` on the same numpy inputs.

The reference hands back numpy arrays; the port keeps torch tensors on
their device, so values are compared, not types (and the port's tensors
are checked to stay tensors). The forms across processes raise in the
port, naming queue 1 item 6. Tolerance: exact (the operations copy,
slice, pad or scale by a power of two)."""

from collections import namedtuple

import numpy as np
import pytest
import torch

from accelerate_tpu import state as jstate
from accelerate_tpu.utils import operations as jops
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.utils import operations as ops

Pair = namedtuple("Pair", ["first", "second"])


@pytest.fixture(autouse=True)
def _fresh_state():
    PartialState._reset_state()
    jstate.PartialState._reset_state()
    yield
    PartialState._reset_state()
    jstate.PartialState._reset_state()


def _tree(seed=0, wide=np.float64):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(5, 3)).astype(np.float32),
            "nested": [rng.integers(0, 9, (5,)).astype(np.int32),
                       Pair(rng.normal(size=(5, 2)).astype(np.float16),
                            rng.normal(size=(5,)).astype(wide))],
            "label": "keep"}


def _torch(tree):
    return ops.recursively_apply(torch.from_numpy, tree,
                                 test_type=lambda x: isinstance(
                                     x, np.ndarray))


def _np(tree):
    """Values only: int * float promotes to f32 in torch, f64 in numpy."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.numpy().tolist()
    if isinstance(tree, (np.ndarray, np.generic)) or hasattr(tree, "dtype"):
        return np.asarray(tree).tolist()
    return tree


def _same(port, ref):
    assert _np(port) == _np(ref)


def test_recursively_apply_and_honor_type_match_jax():
    tree = _tree()
    _same(ops.recursively_apply(lambda x: x * 2, _torch(tree)),
          jops.recursively_apply(lambda x: x * 2, tree))
    out = ops.recursively_apply(lambda x: x + 1, _torch(tree))
    assert isinstance(out["nested"][1], Pair)
    assert isinstance(out["x"], torch.Tensor) and out["label"] == "keep"
    for mod, t in ((ops, _torch(tree)), (jops, tree)):
        with pytest.raises(TypeError, match="unsupported type"):
            mod.recursively_apply(lambda x: x, t, error_on_other_type=True)
    gen = (i * 2 for i in range(2))
    assert ops.honor_type(Pair(0, 0), gen) == Pair(0, 2) == \
        jops.honor_type(Pair(0, 0), iter([0, 2]))


def test_send_to_device_and_skip_keys():
    # no f64 leaf: JAX without x64 puts f64 on the device as f32
    tree = _tree(wide=np.float32)
    moved = ops.send_to_device(tree, "cpu")
    assert isinstance(moved["x"], torch.Tensor)
    _same(moved, jops.send_to_device(tree))
    skipped = ops.send_to_device({"a": tree["x"], "b": tree["x"]}, "cpu",
                                 skip_keys=["b"])
    assert isinstance(skipped["a"], torch.Tensor)
    assert skipped["b"] is tree["x"]
    PartialState(cpu=True)
    assert ops.send_to_device(tree, None)["x"].device.type == "cpu"


def test_structure_helpers_match_jax():
    tree = _tree()
    t = _torch(tree)
    assert ops.find_batch_size(t) == jops.find_batch_size(tree) == 5
    assert ops.find_batch_size({"s": torch.tensor(1.0)}) is None
    _same(ops.slice_tensors(t, slice(1, 3)),
          jops.slice_tensors(tree, slice(1, 3)))
    assert ops.listify(t) == jops.listify(tree)
    fp32 = ops.convert_to_fp32(t)
    _same(fp32, jops.convert_to_fp32(tree))
    assert fp32["nested"][1].first.dtype == torch.float32
    assert fp32["nested"][0].dtype == torch.int32
    assert ops.convert_to_fp32(torch.ones(2, dtype=torch.bfloat16)).dtype \
        == torch.float32


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_one_process_collectives_match_jax(reduction):
    tree = _tree()
    t = _torch(tree)
    gathered = ops.gather(t)
    assert gathered["x"] is t["x"]
    _same(gathered, jops.gather(tree))
    assert ops.gather_object({"k": 1}) == jops.gather_object({"k": 1}) == \
        [{"k": 1}]
    _same(ops.broadcast(t), jops.broadcast(tree))
    objs = [1, "two"]
    assert ops.broadcast_object_list(objs) is objs
    assert jops.broadcast_object_list([1, "two"]) == objs
    _same(ops.reduce(t, reduction, scale=0.5),
          jops.reduce(tree, reduction, scale=0.5))
    with pytest.raises(ValueError, match="mean|sum|none"):
        ops.reduce(t, "max")
    _same(ops.pad_across_processes(t, dim=1, pad_index=-1),
          jops.pad_across_processes(tree, dim=1, pad_index=-1))


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("batch_size", [5, 8])
def test_pad_input_tensors_matches_jax(batch_size, dim):
    x = np.arange(30, dtype=np.float32).reshape(5, 6)
    for n in (1, 3, 4):
        _same(ops.pad_input_tensors({"x": torch.tensor(x)}, batch_size, n,
                                    dim=dim),
              jops.pad_input_tensors({"x": x}, batch_size, n, dim=dim))


def test_concatenate_matches_jax():
    parts = [{k: v for k, v in _tree(s).items() if k != "label"}
             for s in range(3)]
    port = ops.concatenate([_torch(p) for p in parts])
    assert isinstance(port["x"], torch.Tensor) and port["x"].shape == (15, 3)
    assert isinstance(port["nested"][1], Pair)
    _same(port, jops.concatenate(parts))
    _same(ops.concatenate([_torch(p) for p in parts], dim=-1)["x"],
          jops.concatenate(parts, dim=-1)["x"])
    assert ops.concatenate([]) == []


def test_debug_verification_passes_with_one_process():
    st = PartialState(cpu=True)
    st.debug = True
    assert ops.PartialStateDebug.enabled()
    x = torch.arange(4.0)
    assert ops.gather(x) is x and ops.reduce(x, "sum") is not x
    assert ops.verify_operation(x, "gather") is None


@pytest.mark.parametrize("call", [
    lambda: ops.gather(torch.ones(2)),
    lambda: ops.gather_object(1),
    lambda: ops.broadcast(torch.ones(2)),
    lambda: ops.broadcast_object_list([1]),
    lambda: ops.reduce(torch.ones(2), "sum"),
    lambda: ops.pad_across_processes(torch.ones(2)),
    lambda: ops.verify_operation(torch.ones(2), "gather")],
    ids=["gather", "gather_object", "broadcast", "broadcast_object_list",
         "reduce", "pad_across_processes", "verify_operation"])
def test_forms_across_processes_raise_and_name_item_6(call, monkeypatch):
    monkeypatch.setattr(PartialState, "num_processes", 2)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        call()
