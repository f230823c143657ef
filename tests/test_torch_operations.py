"""The port's tree utilities and one-process collectives
(`accelerate_tpu_torch/utils/operations.py`) against
`accelerate_tpu.utils.operations` on the same numpy inputs.

The reference hands back numpy arrays; the port keeps torch tensors on
their device, so values are compared, not types (and the port's tensors
are checked to stay tensors). The forms across processes run in a real
two-process gloo world on the CPU and are held against the reference's
definitions. Tolerance: exact (the operations copy, slice, pad, sum two
small integers or scale by a power of two)."""

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


@pytest.fixture(scope="module")
def two_ranks():
    """Every collective in one real two-process gloo world on the CPU
    (`test_utils.worlds.collective_forms`), each rank's results."""
    from accelerate_tpu_torch.test_utils import run_world
    from accelerate_tpu_torch.test_utils.worlds import collective_forms

    return run_world(collective_forms, 2)


def _arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_gather(res):
    for r in res:
        got = r["gather"]
        assert isinstance(got["t"], torch.Tensor) and \
            isinstance(got["n"], np.ndarray)
        # the reference's process_allgather(tiled=True): rank blocks in
        # order along dim 0 (a 0-d leaf one row a rank)
        np.testing.assert_array_equal(_arr(got["t"]), [0, 0, 1, 1])
        np.testing.assert_array_equal(got["n"], [[0, 0], [1, 1]])
        np.testing.assert_array_equal(_arr(got["s"]), [0.0, 1.0])


def _check_gather_object(res):
    assert [r["gather_object"] for r in res] == [[{"rank": 0},
                                                  {"rank": 1}]] * 2


def _check_broadcast(res):
    for r in res:
        np.testing.assert_array_equal(_arr(r["broadcast"]), [1.0] * 3)


def _check_broadcast_object_list(res):
    assert [r["broadcast_object_list"] for r in res] == [[0, "s0"]] * 2


def _check_reduce(res):
    # rank r holds r + 1: sum 3, mean 1.5, both times scale 2
    for r in res:
        np.testing.assert_array_equal(_arr(r["reduce"]["sum"]), [6.0, 6.0])
        np.testing.assert_array_equal(_arr(r["reduce"]["mean"]), [3.0, 3.0])


def _check_pad_across_processes(res):
    rows, first = res[0]["pad_across_processes"]
    np.testing.assert_array_equal(_arr(rows), [[1, 1], [-1, -1]])
    np.testing.assert_array_equal(_arr(first), [-1, 1])
    rows, first = res[1]["pad_across_processes"]
    np.testing.assert_array_equal(_arr(rows), np.ones((2, 2)))
    np.testing.assert_array_equal(_arr(first), [1, 1])


def _check_verify_operation(res):
    for r in res:
        msg = r["verify_operation"]
        assert "Mismatched operand structure for `gather`" in msg, msg
        assert "rank 0: {'x': ((1,)" in msg and "rank 1: {'x': ((2,)" in msg


def _check_all_reduce_mean_(res):
    for r in res:
        a, b = r["all_reduce_mean_"]
        np.testing.assert_array_equal(_arr(a), np.full((3, 5), 0.5))
        np.testing.assert_array_equal(_arr(b), np.arange(7.0) * 1.5)
    assert all(torch.equal(x, y) for x, y in zip(
        res[0]["all_reduce_mean_"], res[1]["all_reduce_mean_"]))


@pytest.mark.parametrize("check", [
    _check_gather, _check_gather_object, _check_broadcast,
    _check_broadcast_object_list, _check_reduce, _check_pad_across_processes,
    _check_verify_operation],
    ids=["gather", "gather_object", "broadcast", "broadcast_object_list",
         "reduce", "pad_across_processes", "verify_operation"])
def test_forms_across_processes_raise_and_name_item_6(check, two_ranks):
    """Each collective across two processes gives the reference's values
    (its definitions: rank blocks in order, rank 1's broadcast, the sum
    and mean times scale, padding to the largest, a table of mismatched
    operands). The name is kept from when these forms raised."""
    check(two_ranks)


def test_all_reduce_mean_in_buckets_gives_every_rank_the_mean(two_ranks):
    """Buckets smaller than a leaf split it; every rank ends with the
    same bits."""
    _check_all_reduce_mean_(two_ranks)
