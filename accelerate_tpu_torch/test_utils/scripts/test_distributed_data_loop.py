"""Launch-and-assert: the data loader's sharding. Every rank asserts
`BatchSamplerShard`'s coverage, `even_batches` wraparound against an
uneven tail, `skip_first_batches`, the dispatcher against per-rank
sharding, and `gather_for_metrics`'s exact sample count."""

from __future__ import annotations

import numpy as np


class _Batches:
    """A plain batch-index sampler: `n` samples in batches of `bs`."""

    def __init__(self, n, bs, drop_last=False):
        self.n, self.batch_size, self.drop_last = n, bs, drop_last

    def __len__(self):
        q, r = divmod(self.n, self.batch_size)
        return q if (self.drop_last or r == 0) else q + 1

    def __iter__(self):
        batch = []
        for i in range(self.n):
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch


def check_sampler_shard_coverage(state):
    from accelerate_tpu_torch.data import BatchSamplerShard
    from accelerate_tpu_torch.utils.operations import gather_object

    world, rank = state.num_processes, state.process_index
    shard = BatchSamplerShard(_Batches(8 * world, 4), world, rank)
    mine = [i for b in shard for i in b]
    everyone = sorted(i for sub in gather_object(mine) for i in sub)
    assert everyone == list(range(8 * world)), everyone


def check_even_batches_wraparound(state):
    from accelerate_tpu_torch.data import BatchSamplerShard
    from accelerate_tpu_torch.utils.operations import gather_object

    world, rank = state.num_processes, state.process_index
    if world == 1:
        for even in (True, False):
            batches = list(BatchSamplerShard(_Batches(10, 4), 1, 0,
                                             even_batches=even))
            assert [len(b) for b in batches] == [4, 4, 2], batches
            assert [i for b in batches for i in b] == list(range(10))
        return
    n = 4 * world + 2
    mine = list(BatchSamplerShard(_Batches(n, 2), world, rank,
                                  even_batches=True))
    assert all(len(b) == 2 for b in mine), mine
    counts = gather_object(len(mine))
    assert len(set(counts)) == 1, f"ranks yielded different counts: {counts}"
    flat = [i for sub in gather_object([i for b in mine for i in b])
            for i in sub]
    assert set(flat) == set(range(n)), (sorted(set(flat)), n)


def check_skip_first_batches(state):
    from accelerate_tpu_torch.data import prepare_data_loader, \
        skip_first_batches

    data = [{"v": np.full((2,), i, dtype=np.int32)} for i in range(6)]
    loader = prepare_data_loader(data, put_on_device=False)
    full = [int(np.asarray(b["v"])[0]) for b in loader]
    rest = [int(np.asarray(b["v"])[0])
            for b in skip_first_batches(loader, 2)]
    assert rest == full[2:], (full, rest)
    assert [int(np.asarray(b["v"])[0]) for b in loader] == full


def check_dispatcher_matches_shard(state):
    from accelerate_tpu_torch.data import prepare_data_loader
    from accelerate_tpu_torch.utils.operations import gather_object

    world = state.num_processes
    n, bs = 8 * world, world
    data = [{"idx": np.arange(i, i + bs, dtype=np.int32)}
            for i in range(0, n, bs)]
    shard = np.concatenate([np.asarray(b["idx"]).ravel() for b in
                            prepare_data_loader(data, put_on_device=False)])
    disp = np.concatenate([np.asarray(b["idx"]).ravel() for b in
                           prepare_data_loader(data, put_on_device=False,
                                               dispatch_batches=True)])
    all_shard = np.sort(np.concatenate(gather_object(shard)))
    all_disp = np.sort(np.concatenate(gather_object(disp)))
    assert np.array_equal(all_shard, np.arange(n))
    assert np.array_equal(np.unique(all_disp), np.arange(n))


def check_gather_for_metrics_exact_count(state):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data import prepare_data_loader
    from accelerate_tpu_torch.state import PartialState

    PartialState._reset_state()
    acc = Accelerator()
    world = acc.num_processes
    # 2 * world + 1 rows in batches of 2 leave a short tail at every size
    n, bs = 2 * world + 1, 2
    data = [{"idx": np.arange(i, min(i + bs, n), dtype=np.int32)}
            for i in range(0, n, bs)]
    if world == 1:
        loader = acc.prepare_data_loader(data, device_placement=False)
    else:
        # the dispatcher pads the short global tail and records the count
        loader = prepare_data_loader(data, put_on_device=False,
                                     dispatch_batches=True)
        acc._dataloaders.append(loader)
    seen = []
    for batch in loader:
        out = acc.gather_for_metrics(batch)
        seen.append(np.asarray(out["idx"]).ravel())
    got = np.sort(np.concatenate(seen))
    assert np.array_equal(got, np.arange(n)), got


def main() -> None:
    from accelerate_tpu_torch.state import PartialState

    state = PartialState()
    world = state.num_processes
    check_sampler_shard_coverage(state)
    check_even_batches_wraparound(state)
    check_skip_first_batches(state)
    check_dispatcher_matches_shard(state)
    check_gather_for_metrics_exact_count(state)
    state = PartialState()
    state.wait_for_everyone()
    if state.is_main_process:
        print("test_distributed_data_loop: ALL CHECKS PASSED "
              f"({world} process(es))")


if __name__ == "__main__":
    main()
