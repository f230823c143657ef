"""The bundled launch-and-assert script: run in any world (one process,
or N through the launcher), every rank asserts the process state, the
collectives, the RNG synchronisation, exactly-once coverage of a sharded
loader, and that a short training run converges to the same parameters
on every process."""

from __future__ import annotations

import numpy as np
import torch


def check_state():
    from accelerate_tpu_torch.state import PartialState

    state = PartialState()
    assert state.num_processes >= 1
    assert 0 <= state.process_index < state.num_processes
    state.wait_for_everyone()
    return state


def check_collectives(state):
    from accelerate_tpu_torch.utils.operations import broadcast_object_list, \
        gather, gather_object, reduce

    rank, world = state.process_index, state.num_processes
    gathered = gather(torch.full((2,), float(rank), device=state.device))
    expect = np.repeat(np.arange(world, dtype=np.float32), 2)
    assert np.array_equal(np.sort(gathered.cpu().numpy()), expect)
    total = float(reduce(torch.tensor(1.0, device=state.device), "sum"))
    assert total == world, (total, world)
    objs = gather_object({"rank": rank})
    assert sorted(o["rank"] for o in objs) == list(range(world))
    assert broadcast_object_list([f"rank-{rank}"]) == ["rank-0"]


def check_rng_sync(state):
    from accelerate_tpu_torch.utils.operations import gather_object
    from accelerate_tpu_torch.utils.random import synchronize_rng_states

    np.random.seed(1234 + state.process_index)  # diverge on purpose
    torch.manual_seed(99 + state.process_index)
    synchronize_rng_states(["numpy", "python", "torch"])
    draws = gather_object((float(np.random.random()),
                           float(torch.rand(()))))
    assert len(set(draws)) == 1, f"RNG not synced: {draws}"


def check_dataloader(state):
    from accelerate_tpu_torch.data import prepare_data_loader
    from accelerate_tpu_torch.utils.operations import gather_object

    n, bs = 32, 4
    data = [{"idx": np.arange(i, i + bs, dtype=np.int32)}
            for i in range(0, n, bs)]
    loader = prepare_data_loader(data, put_on_device=False)
    local = np.concatenate([np.asarray(b["idx"]) for b in loader]).ravel()
    everyone = np.sort(np.concatenate(gather_object(local)))
    assert everyone.tolist() == list(range(n)), everyone


def check_training(state):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.optimizers import sgd
    from accelerate_tpu_torch.test_utils import host_values
    from accelerate_tpu_torch.test_utils.training import RegressionDataset, \
        regression_loss, regression_params
    from accelerate_tpu_torch.training import TrainState
    from accelerate_tpu_torch.utils.operations import gather_object

    acc = Accelerator(gradient_accumulation_steps=2)
    ds = RegressionDataset(length=64)
    loader = acc.prepare([{"x": ds.x[i:i + 8], "y": ds.y[i:i + 8]}
                          for i in range(0, 64, 8)])
    ts = acc.prepare(TrainState.create(
        apply_fn=None, params=regression_params(), tx=sgd(0.1),
        use_grad_accum_buffer=True))
    step = acc.train_step(regression_loss)
    first = last = None
    for _ in range(8):
        for batch in loader:
            ts, metrics = step(ts, batch)
            last = float(metrics["loss"])
            first = last if first is None else first
    assert last < first, f"loss did not decrease: {first} -> {last}"
    a_values = gather_object(float(host_values(ts.params["a"])))
    assert len(set(a_values)) == 1, f"params diverged: {a_values}"
    assert abs(a_values[0] - 2.0) < 0.5, f"did not approach a=2: {a_values}"


def main() -> None:
    state = check_state()
    check_collectives(state)
    check_rng_sync(state)
    check_dataloader(state)
    check_training(state)
    state.wait_for_everyone()
    if state.is_main_process:
        print(f"test_script: ALL CHECKS PASSED ({state.num_processes} "
              "process(es))")


if __name__ == "__main__":
    main()
