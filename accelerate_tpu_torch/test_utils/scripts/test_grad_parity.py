"""Launch-and-assert: data-parallel gradient parity. One SGD step of
`LlamaConfig.tiny()` on a fixed global batch, split across the
processes (`split_batches=True`) with the gradients averaged by the
train step, must land on the parameters of one process stepping on the
whole batch with plain `torch.autograd.grad` (rtol 1e-4, atol 1e-6, in
f32).

Options: `--params FILE.npz` takes the initial weights (flat keys, as
`utils.other.flatten_dict` names them) instead of `init_params(cfg, 0)`;
`--save FILE.npz` makes process 0 write the stepped weights there, so a
test can hold them against another implementation."""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

LR = 0.1


def fixed_batch(vocab_size: int, rows: int) -> np.ndarray:
    rng = np.random.default_rng(1234)
    return rng.integers(0, vocab_size, (rows, 33)).astype(np.int32)


def _initial(cfg, path, device):
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_numpy
    from accelerate_tpu_torch.utils.other import unflatten_dict

    if path is None:
        return llama.init_params(cfg, 0, device=device)
    with np.load(path) as f:
        return params_from_numpy(unflatten_dict(dict(f)), device=device)


def check_one_step_parity(state, params_path=None, save_path=None):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.optimizers import sgd, tree_leaves, tree_map
    from accelerate_tpu_torch.training import TrainState
    from accelerate_tpu_torch.utils.other import flatten_dict

    cfg = llama.LlamaConfig.tiny()
    acc = Accelerator(mixed_precision="no", split_batches=True)
    ids = fixed_batch(cfg.vocab_size, 2 * state.num_processes)
    ts = acc.prepare(TrainState.create(
        apply_fn=None, params=_initial(cfg, params_path, acc.device),
        tx=sgd(LR)))
    (batch,) = list(acc.prepare([{"input_ids": ids}]))
    assert batch["input_ids"].shape[0] == 2, batch["input_ids"].shape
    step = acc.train_step(lambda p, b: llama.causal_lm_loss(cfg, p, b))
    ts, metrics = step(ts, batch)

    # one process, the whole batch, plain autograd
    ref = _initial(cfg, params_path, acc.device)
    leaves = [p.requires_grad_(True) for p in tree_leaves(ref)]
    loss = llama.causal_lm_loss(
        cfg, ref, {"input_ids": torch.as_tensor(ids, device=acc.device)})
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    want = tree_map(lambda p: (p - LR * next(it)).detach(), ref)
    for key, got in flatten_dict(ts.params).items():
        np.testing.assert_allclose(
            got.cpu().numpy(), flatten_dict(want)[key].cpu().numpy(),
            rtol=1e-4, atol=1e-6,
            err_msg=f"grad parity broken at {key} "
                    f"({state.num_processes} process(es))")
    loss = float(loss.detach())
    assert abs(float(metrics["loss"]) - loss) <= 1e-5 * loss
    if save_path is not None and state.is_main_process:
        np.savez(save_path, **{k: v.detach().cpu().numpy()
                               for k, v in flatten_dict(ts.params).items()})
    state.wait_for_everyone()


def main(argv: list[str] | None = None) -> None:
    from accelerate_tpu_torch.state import PartialState

    parser = argparse.ArgumentParser()
    parser.add_argument("--params", default=None)
    parser.add_argument("--save", default=None)
    args = parser.parse_args(argv or [])
    state = PartialState()
    check_one_step_parity(state, args.params, args.save)
    if state.is_main_process:
        print("test_grad_parity: ALL CHECKS PASSED "
              f"({state.num_processes} process(es))")


if __name__ == "__main__":
    main(sys.argv[1:])
