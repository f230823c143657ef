"""Launch-and-assert: `gather_for_metrics` gives every sample exactly
once, for dataset lengths that do and do not divide over the processes,
through the tensor path and the object path."""

from __future__ import annotations

import numpy as np


def _world():
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.state import PartialState

    PartialState._reset_state()
    return Accelerator()


def check_exact_sample_count(length: int, batch_size: int):
    acc = _world()
    data = np.arange(length, dtype=np.float32)
    loader = acc.prepare([{"x": data[i:i + batch_size]}
                          for i in range(0, length, batch_size)])
    got = np.concatenate([acc.gather_for_metrics(b["x"]).cpu().numpy()
                          .reshape(-1) for b in loader])
    assert got.shape[0] == length, (
        f"length={length} bs={batch_size}: gathered {got.shape[0]}")
    assert np.array_equal(np.sort(got), data)


def check_object_gather_path():
    acc = _world()
    everyone = acc.gather_for_metrics([{"rank": acc.process_index}],
                                      use_gather_object=True)
    assert sorted(d["rank"] for d in everyone) == \
        list(range(acc.num_processes)), everyone


def check_tree_gather():
    acc = _world()
    n = 24
    loader = acc.prepare([{"logits": np.full((8, 2), i, np.float32),
                           "labels": np.full((8,), i, np.int32)}
                          for i in range(n // 8)])
    logits, labels = [], []
    for batch in loader:
        g = acc.gather_for_metrics(batch)
        logits.append(g["logits"].cpu().numpy())
        labels.append(g["labels"].cpu().numpy())
    assert sum(x.shape[0] for x in logits) == n
    assert sum(x.shape[0] for x in labels) == n
    for lg, lb in zip(logits, labels):
        assert np.array_equal(lg[:, 0].astype(np.int32), lb)


def main() -> None:
    from accelerate_tpu_torch.state import PartialState

    # exact division, a short tail, a tail spread over processes
    for length, bs in [(64, 8), (60, 8), (99, 8), (16, 16)]:
        check_exact_sample_count(length, bs)
    check_object_gather_path()
    check_tree_gather()
    state = PartialState()
    state.wait_for_everyone()
    if state.is_main_process:
        print(f"test_metrics: ALL CHECKS PASSED ({state.num_processes} "
              "process(es))")


if __name__ == "__main__":
    main()
