"""Launch-and-assert: the collectives on nested trees, with shapes that
differ by rank, and the object collectives. Every rank asserts."""

from __future__ import annotations

import numpy as np
import torch


def check_gather_tree(state):
    from accelerate_tpu_torch.utils.operations import gather

    rank, world, dev = state.process_index, state.num_processes, state.device
    tree = {"a": torch.full((2, 3), float(rank), device=dev),
            "nested": [torch.arange(4, dtype=torch.float32, device=dev)
                       + rank],
            "host": np.full((1,), rank, dtype=np.int64)}
    out = gather(tree)
    a = out["a"]
    assert a.shape == (2 * world, 3) and a.device == dev, (a.shape, a.device)
    assert set(torch.unique(a).tolist()) == {float(r) for r in range(world)}
    assert out["nested"][0].shape == (4 * world,)
    assert isinstance(out["host"], np.ndarray)
    assert out["host"].tolist() == list(range(world))


def check_reduce(state):
    from accelerate_tpu_torch.utils.operations import reduce

    world = state.num_processes
    tree = {"x": torch.tensor([float(state.process_index + 1)],
                              device=state.device)}
    total = reduce(tree, reduction="sum")["x"]
    assert total.tolist() == [world * (world + 1) / 2], total
    mean = reduce(tree, reduction="mean")["x"]
    assert mean.tolist() == [(world + 1) / 2], mean
    scaled = reduce(tree, reduction="sum", scale=2.0)["x"]
    assert scaled.tolist() == [world * (world + 1)], scaled


def check_broadcast(state):
    from accelerate_tpu_torch.utils.operations import broadcast, \
        broadcast_object_list

    rank, dev = state.process_index, state.device
    tree = {"w": torch.full((3,), float(rank), device=dev),
            "b": torch.tensor([float(rank) * 2], device=dev)}
    out = broadcast(tree, from_process=0)
    assert out["w"].tolist() == [0.0] * 3 and out["b"].tolist() == [0.0]
    last = state.num_processes - 1
    out = broadcast(tree, from_process=last)
    assert out["w"].tolist() == [float(last)] * 3
    objs = broadcast_object_list([{"rank": rank}, rank * 10])
    assert objs == [{"rank": 0}, 0], objs


def check_pad_across_processes(state):
    from accelerate_tpu_torch.utils.operations import gather, \
        pad_across_processes

    rank, world = state.process_index, state.num_processes
    # rank r holds r + 1 rows
    local = torch.full((rank + 1, 2), float(rank), device=state.device)
    padded = pad_across_processes(local, dim=0, pad_index=-1)
    assert padded.shape[0] == world, padded.shape
    blocks = gather(padded).reshape(world, world, 2)
    for r in range(world):
        assert (blocks[r, : r + 1] == float(r)).all()
        assert (blocks[r, r + 1:] == -1.0).all()
    first = pad_across_processes(local, dim=0, pad_index=-1, pad_first=True)
    assert (first[: world - (rank + 1)] == -1.0).all()
    assert (first[world - (rank + 1):] == float(rank)).all()


def check_same_tensors(state):
    from accelerate_tpu_torch.test_utils import are_the_same_tensors

    assert are_the_same_tensors(torch.ones(3, device=state.device))
    mine = torch.full((3,), float(state.process_index), device=state.device)
    assert are_the_same_tensors(mine) == (state.num_processes == 1)


def check_gather_object(state):
    from accelerate_tpu_torch.utils.operations import gather_object

    rank, world = state.process_index, state.num_processes
    objs = gather_object({"rank": rank, "msg": f"hello-{rank}"})
    assert [o["rank"] for o in objs] == list(range(world)), objs


def check_verify_operation(state):
    from accelerate_tpu_torch.utils.operations import \
        DistributedOperationException, verify_operation

    rank = state.process_index
    verify_operation({"x": torch.zeros(2)}, "gather")
    if state.num_processes == 1:
        return
    try:
        verify_operation({"x": torch.zeros(rank + 1)}, "gather")
    except DistributedOperationException as e:
        assert "rank 1" in str(e), e
    else:
        raise AssertionError("shapes that differ by rank were accepted")


def main() -> None:
    from accelerate_tpu_torch.state import PartialState

    state = PartialState()
    check_gather_tree(state)
    check_reduce(state)
    check_broadcast(state)
    check_pad_across_processes(state)
    check_gather_object(state)
    check_same_tensors(state)
    check_verify_operation(state)
    state.wait_for_everyone()
    if state.is_main_process:
        print(f"test_ops: ALL CHECKS PASSED ({state.num_processes} "
              "process(es))")


if __name__ == "__main__":
    main()
