"""Launch-and-assert: gradient synchronisation and accumulation. Every
rank asserts:

- `accumulate()` sets `sync_gradients` at the accumulation boundaries,
  `no_sync()` clears it, `sync_each_batch` sets it on every step;
- k accumulated micro-batches give the update of one k-times larger
  batch;
- after the steps every process holds bit-identical parameters;
- the eager chain (compute_gradients, backward, clip_grad_norm_, step)
  lands on the fused train_step's parameters, on every rank.
"""

from __future__ import annotations


def _fresh(**kwargs):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.state import PartialState

    PartialState._reset_state()
    return Accelerator(**kwargs)


def check_sync_flag_schedule():
    from accelerate_tpu_torch.utils.dataclasses import \
        GradientAccumulationPlugin

    acc = _fresh(gradient_accumulation_steps=3)
    flags = []
    for _ in range(6):
        with acc.accumulate():
            flags.append(acc.sync_gradients)
    assert flags == [False, False, True, False, False, True], flags
    with acc.no_sync():
        assert not acc.sync_gradients
    assert acc.sync_gradients
    acc = _fresh(gradient_accumulation_plugin=GradientAccumulationPlugin(
        num_steps=4, sync_each_batch=True))
    flags = []
    for _ in range(4):
        with acc.accumulate():
            flags.append(acc.sync_gradients)
    assert flags == [True] * 4, flags


def check_accumulation_equivalence():
    from accelerate_tpu_torch.optimizers import sgd
    from accelerate_tpu_torch.test_utils import host_values
    from accelerate_tpu_torch.test_utils.training import RegressionDataset, \
        regression_loss, regression_params
    from accelerate_tpu_torch.training import TrainState

    k, bs = 4, 8
    ds = RegressionDataset(length=k * bs, seed=11)

    def run(steps):
        acc = _fresh(gradient_accumulation_steps=steps)
        ts = TrainState.create(apply_fn=None, params=regression_params(),
                               tx=sgd(0.1), use_grad_accum_buffer=steps > 1)
        step = acc.train_step(regression_loss)
        if steps > 1:
            for i in range(k):
                sl = slice(i * bs, (i + 1) * bs)
                ts, _ = step(ts, {"x": ds.x[sl], "y": ds.y[sl]})
        else:
            ts, _ = step(ts, {"x": ds.x, "y": ds.y})
        return host_values(ts.params)

    accum, big = run(k), run(1)
    for key in ("a", "b"):
        assert abs(float(accum[key]) - float(big[key])) <= \
            1e-5 * abs(float(big[key])) + 1e-7, (key, accum, big)


def check_params_identical_across_ranks():
    from accelerate_tpu_torch.optimizers import sgd
    from accelerate_tpu_torch.test_utils import host_values
    from accelerate_tpu_torch.test_utils.training import RegressionDataset, \
        regression_loss, regression_params
    from accelerate_tpu_torch.training import TrainState
    from accelerate_tpu_torch.utils.operations import gather_object

    acc = _fresh(gradient_accumulation_steps=2)
    ds = RegressionDataset(length=32, seed=3)
    loader = acc.prepare([{"x": ds.x[i:i + 4], "y": ds.y[i:i + 4]}
                          for i in range(0, 32, 4)])
    ts = acc.prepare(TrainState.create(
        apply_fn=None, params=regression_params(), tx=sgd(0.05),
        use_grad_accum_buffer=True))
    step = acc.train_step(regression_loss)
    for batch in loader:
        ts, _ = step(ts, batch)
    values = host_values(ts.params)
    mine = (values["a"].tobytes(), values["b"].tobytes())
    everyone = gather_object(mine)
    assert len(set(everyone)) == 1, f"params diverged across ranks: {everyone}"


def check_eager_chain_matches_fused():
    from accelerate_tpu_torch.optimizers import sgd
    from accelerate_tpu_torch.test_utils import host_values
    from accelerate_tpu_torch.test_utils.training import RegressionDataset, \
        regression_loss, regression_params
    from accelerate_tpu_torch.training import TrainState
    from accelerate_tpu_torch.utils.operations import gather_object

    ds = RegressionDataset(length=32, seed=7)
    raw = [{"x": ds.x[i:i + 8], "y": ds.y[i:i + 8]} for i in range(0, 32, 8)]

    acc = _fresh(gradient_clipping=0.5)
    loader = acc.prepare(raw)
    ts = acc.prepare(TrainState.create(
        apply_fn=None, params=regression_params(), tx=sgd(0.1)))
    step = acc.train_step(regression_loss)
    for batch in loader:
        ts, _ = step(ts, batch)
    fused = {k: float(v) for k, v in host_values(ts.params).items()}

    acc = _fresh()
    loader = acc.prepare(raw)
    opt = acc.prepare_optimizer(sgd(0.1),
                                params=acc.prepare(regression_params()))
    for batch in loader:
        with acc.accumulate():
            _, grads = acc.compute_gradients(regression_loss, opt.params,
                                             batch)
            acc.backward(grads)
            acc.clip_grad_norm_(max_norm=0.5)
            opt.step()
            opt.zero_grad()
    eager = {k: float(v) for k, v in host_values(opt.params).items()}
    for k in fused:
        assert abs(fused[k] - eager[k]) < 1e-5, (k, fused[k], eager[k])
    everyone = gather_object(tuple(sorted(eager.items())))
    assert len(set(everyone)) == 1, f"eager params diverged: {everyone}"


def main() -> None:
    from accelerate_tpu_torch.state import PartialState

    world = PartialState().num_processes
    check_sync_flag_schedule()
    check_accumulation_equivalence()
    check_params_identical_across_ranks()
    check_eager_chain_matches_fused()
    state = PartialState()
    state.wait_for_everyone()
    if state.is_main_process:
        print(f"test_sync: ALL CHECKS PASSED ({world} process(es))")


if __name__ == "__main__":
    main()
