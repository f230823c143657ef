"""Launch-and-assert: inputs that do not divide over the processes.
Every rank asserts that `even_batches=True` gives every process the same
number of iterations (a collective in each step would hang otherwise),
that `gather_for_metrics` keeps exactly the real samples, and that
`join_uneven_inputs(even_batches=True)` evens out a loader built with
`even_batches=False`."""

from __future__ import annotations

import numpy as np


def _batches(n_batches: int, rows: int = 8):
    return [{"x": (np.arange(rows, dtype=np.float32)
                   + 100 * i).reshape(rows, 1)} for i in range(n_batches)]


def check_even_batches_equalizes_iterations(accelerator):
    from accelerate_tpu_torch.utils.operations import gather_object

    n = 2 * accelerator.num_processes + 1
    steps = 0
    for batch in accelerator.prepare(_batches(n)):
        counts = gather_object(int(batch["x"].shape[0]))
        assert len(set(counts)) == 1, counts
        steps += 1
    all_steps = gather_object(steps)
    assert len(set(all_steps)) == 1, f"uneven loop counts: {all_steps}"


def check_gather_for_metrics_drops_recycled(accelerator):
    n, rows = 2 * accelerator.num_processes + 1, 8
    seen = [accelerator.gather_for_metrics(b["x"]).cpu().numpy()
            for b in accelerator.prepare(_batches(n, rows))]
    got = np.concatenate(seen)
    assert got.shape[0] == n * rows, (got.shape, n * rows)
    want = np.sort(np.concatenate([b["x"] for b in
                                   _batches(n, rows)]).ravel())
    assert np.array_equal(np.sort(got.ravel()), want)


def check_join_uneven_inputs_rescues_uneven_loader(accelerator):
    from accelerate_tpu_torch.data import prepare_data_loader
    from accelerate_tpu_torch.utils.operations import gather_object

    world = accelerator.num_processes
    if world == 1:
        return
    n = 2 * world + 1
    loader = prepare_data_loader(_batches(n), even_batches=False,
                                 mesh=accelerator.mesh)
    accelerator._dataloaders.append(loader)
    lens = gather_object(len(list(loader)))
    assert len(set(lens)) > 1, f"expected uneven counts, got {lens}"
    with accelerator.join_uneven_inputs([None], even_batches=True):
        steps = 0
        for _ in loader:
            gather_object(steps)
            steps += 1
        all_steps = gather_object(steps)
        assert len(set(all_steps)) == 1, all_steps
    assert gather_object(len(list(loader))) == lens


def main():
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.state import PartialState

    accelerator = Accelerator()
    for check in (check_even_batches_equalizes_iterations,
                  check_gather_for_metrics_drops_recycled,
                  check_join_uneven_inputs_rescues_uneven_loader):
        accelerator.free_memory()
        check(accelerator)
        PartialState().wait_for_everyone()
    accelerator.print("test_uneven_inputs: ALL CHECKS PASSED")


if __name__ == "__main__":
    main()
