"""Launch-and-assert: data-parallel llama training, as a user runs it.

    python -m accelerate_tpu_torch.commands.launch --num_processes 2 \\
        train_llama_dp.py [--config llama3_8b] [--layers 2] [--steps 5]

Every process builds `Accelerator(mixed_precision="bf16",
gradient_clipping=1.0, split_batches=True)` with a gloo process group
(`InitProcessGroupKwargs(backend="gloo")`, so ranks may share a card),
the same llama weights from seed 0 and `adamw(3e-4)`, prepares the
global batch of `--rows` x 2049 tokens from seed 0 (each process takes
its rows), and takes `--steps` fused steps (remat "dots"). Each then
times the gradient all-reduce alone on a gradient-sized tree (CUDA
events on a card), checks that its parameters equal process 0's bit for
bit (broadcast leaf by leaf), and prints one line `DP_RESULT {json}`
with its losses, step times, flash-kernel launches, peak memory and
that check. A world of one process runs the whole batch, the baseline
the losses are held against. With `--update-sample PATH` process 0 also
saves step 1's update (parameters after it minus before) at every
leaf's elements `0, s, 2s, ...` (s = max(1, numel // 2**18)), as one
f32 `.npy`, so two worlds' first updates can be held against each
other. `--config tiny` runs `LlamaConfig.tiny()`
(with `--cpu` on the launcher, on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _config(name: str, layers: int):
    from accelerate_tpu_torch.models import llama

    if name == "tiny":
        return llama.LlamaConfig.tiny(num_hidden_layers=layers, remat=True,
                                      remat_policy="dots")
    return llama.LlamaConfig.llama3_8b(num_hidden_layers=layers, remat=True,
                                       remat_policy="dots")


class _Clock:
    """CUDA events on a card, the host clock on the CPU (ms)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3


def _sample(params) -> np.ndarray:
    """Every leaf's elements 0, s, 2s, ... (s = max(1, numel // 2**18))
    as one f32 host array."""
    from accelerate_tpu_torch.optimizers import tree_leaves

    parts = []
    for p in tree_leaves(params):
        flat = p.detach().reshape(-1)
        parts.append(flat[::max(1, flat.numel() // (1 << 18))].float().cpu())
    return torch.cat(parts).numpy()


def main(argv: list[str] | None = None) -> dict:
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.optimizers import adamw, tree_leaves
    from accelerate_tpu_torch.training import TrainState
    from accelerate_tpu_torch.utils import operations as ops
    from accelerate_tpu_torch.utils.dataclasses import \
        InitProcessGroupKwargs

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="llama3_8b",
                        choices=["llama3_8b", "tiny"])
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--rows", type=int, default=2)
    parser.add_argument("--seq", type=int, default=2049)
    parser.add_argument("--update-sample", default=None)
    args = parser.parse_args(argv or [])

    acc = Accelerator(mixed_precision="bf16", gradient_clipping=1.0,
                      split_batches=True, kwargs_handlers=[
                          InitProcessGroupKwargs(backend="gloo")])
    dev = acc.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = _config(args.config, args.layers)
    state = acc.prepare(TrainState.create(
        apply_fn=None, params=llama.init_params(cfg, 0, device=dev),
        tx=adamw(3e-4)))
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.rows, args.seq)).astype(np.int32)
    (batch,) = list(acc.prepare([{"input_ids": ids}]))
    step = acc.train_step(lambda p, b: llama.causal_lm_loss(cfg, p, b))
    clock = _Clock(dev)

    # the main path's run: the launch counts at 0 just before, read after
    kernels = {"flash_fwd": fa.flash_forward,
               "flash_bwd_dq": fa.flash_backward_dq,
               "flash_bwd_dkv": fa.flash_backward_dkv}
    for fn in kernels.values():
        fn.launches = 0
    losses, step_ms = [], []
    before = _sample(state.params) if args.update_sample else None
    for i in range(args.steps):
        t0 = clock.mark()
        state, m = step(state, batch)
        t1 = clock.mark()
        step_ms.append(clock.ms(t0, t1))
        losses.append(float(m["loss"]))
        if i == 0 and args.update_sample and acc.is_main_process:
            np.save(args.update_sample, _sample(state.params) - before)
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else None)

    # the gradient all-reduce alone, on a tree of the gradients' shapes
    leaves = tree_leaves(state.params)
    grads = [torch.ones_like(p) for p in leaves]
    acc.wait_for_everyone()
    t0 = clock.mark()
    ops.all_reduce_mean_(grads)
    t1 = clock.mark()
    allreduce_ms = clock.ms(t0, t1)
    grad_elems = sum(g.numel() for g in grads)
    del grads

    # the replicas: process 0's parameters, broadcast leaf by leaf
    identical = all(torch.equal(ops.broadcast(p.detach().clone(), 0), p)
                    for p in leaves)
    result = {"rank": acc.process_index, "world": acc.num_processes,
              "device": str(dev), "backend": acc.state.backend,
              "batch_rows": int(batch["input_ids"].shape[0]),
              "losses": losses, "step_ms": step_ms,
              "launches": launches, "max_memory_allocated_gb": peak_gb,
              "allreduce_ms": allreduce_ms, "grad_elements": grad_elems,
              "identical_to_rank0": identical,
              "mesh": acc.mesh.shape}
    # one write of the whole line: the ranks share the launcher's stdout
    sys.stdout.write("DP_RESULT " + json.dumps(result) + "\n")
    sys.stdout.flush()
    acc.wait_for_everyone()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
