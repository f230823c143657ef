"""Launch-and-assert: long-context training on a `seq` axis, and Mixtral
training with block-held experts on an `expert` axis, as a user runs
them. The port of `examples/by_feature/long_context_ring_attention.py`.

    python -m accelerate_tpu_torch.commands.launch --num_processes 2 \\
        --context_parallel_mode ring --context_parallel_degree 2 \\
        train_llama_cp.py [--layers 2] [--seq_len 4096] [--steps 3]
    python -m accelerate_tpu_torch.commands.launch --num_processes 2 \\
        --mesh_shape data=-1,expert=2 \\
        train_llama_cp.py --family mixtral [--layers 1] [--capacity_factor 4]

Every process builds `Accelerator(mixed_precision=..., gradient_clipping=
1.0)` with a gloo process group (`InitProcessGroupKwargs(backend=
"gloo")`, so ranks may share a card). Its mesh comes from the launcher:
`--context_parallel_{mode,degree}` make the plugin and a `seq` axis
(the reference's environment protocol), `--mesh_shape` an `expert`
axis; `--cp_mode`/`--cp_degree` pass the plugin in code instead, as the
example does. Each process builds the same weights from `--seed` on its
device, prepares `TrainState.create(apply_fn=None, params=...,
tx=adamw(--lr))` (on an `expert` axis the experts and their moments
become this rank's [L, E/P, ...] block) and the loader of one global
batch of `--batch_size` rows of `--seq_len` + 1 tokens from `--seed`,
and takes `--steps` fused steps of `causal_lm_loss`: llama at llama3-8B
width (or `LlamaConfig.tiny` with `--tiny`) with the plugin's mode as
its attention backend, or Mixtral-8x7B width (`MixtralConfig.tiny`)
with `moe_impl="a2a"` at `--capacity_factor`.

Each process prints one line `CPT_RESULT {json}`: its losses, step
times (the host clock around each step, which ends by reading its
loss; after a synchronize on a card), the flash kernels' launches over the
steps (the counts set to 0 just before them), the params' digest after
each step (float64 sums of the whole model: a block's sums are added
over its line, so every rank's digest covers the same tensors), each
step's pre-clip norm as the clip took it and the norm of the rank's own
gradients alone (`clip_norms`), the shapes of its expert leaves and
their moments, and its memory after `prepare`. With `--update-sample PATH` process 0 saves step 1's update
at a strided sample of its leaves (`update_sample`) as one f32 `.npy`.
With `--cpu` on the launcher it runs on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch


def model_config(family: str, tiny: bool, layers: int, mode: str | None,
                 capacity_factor: float):
    """(family module, config): llama with `mode` as its attention
    backend (flash without one), or Mixtral with the a2a dispatch."""
    from accelerate_tpu_torch.models import llama, mixtral

    if family == "mixtral":
        make = mixtral.MixtralConfig.tiny if tiny else \
            mixtral.MixtralConfig.mixtral_8x7b
        return mixtral, make(num_hidden_layers=layers, moe_impl="a2a",
                             capacity_factor=capacity_factor)
    make = llama.LlamaConfig.tiny if tiny else llama.LlamaConfig.llama3_8b
    return llama, make(num_hidden_layers=layers,
                       attention_backend=mode or "flash")


def batch_ids(vocab: int, rows: int, seq_len: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, seq_len + 1)).astype(np.int32)


def update_sample(params) -> np.ndarray:
    """Every leaf's elements 0, s, 2s, ... (s = max(1, numel // 2**18))
    as one f32 host array, leaves in tree order."""
    from accelerate_tpu_torch.optimizers import tree_leaves

    parts = []
    for p in tree_leaves(params):
        flat = p.detach().reshape(-1)
        parts.append(flat[::max(1, flat.numel() // (1 << 18))].float().cpu())
    return torch.cat(parts).numpy()


def digest(params) -> list:
    """float64 sums of the whole model's elements and of their squares:
    a block's (`sharding.placement_of`) summed over its line."""
    from accelerate_tpu_torch.sharding.planner import leaves_with_path, \
        placement_of
    from accelerate_tpu_torch.state import mesh_or_state
    from accelerate_tpu_torch.utils import operations as ops

    leaves = leaves_with_path(params)
    placement = placement_of(params) or [None] * len(leaves)
    total = torch.zeros(2, dtype=torch.float64)
    for (_, p), spec in zip(leaves, placement):
        d = torch.zeros(2, dtype=torch.float64, device=p.device)
        # in chunks: a float64 copy of a whole leaf would cost gigabytes
        for chunk in p.detach().reshape(-1).split(1 << 24):
            c = chunk.double()
            d += torch.stack([c.sum(), (c * c).sum()])
        d = d.cpu()
        if spec is not None:
            d = ops.axis_all_reduce(
                d, mesh_or_state(None).group_over(spec.axes()))
        total += d
    return [float(x) for x in total]


@contextlib.contextmanager
def clip_norms(norms: list, local: list):
    """Inside, each clip of the fused step appends the pre-clip norm it
    returns to `norms` (a block's squares summed over its line) and the
    norm of this rank's own gradients alone to `local` (what a clip that
    left out the blocks' lines would read)."""
    from unittest import mock

    from accelerate_tpu_torch import accelerator as acc_mod
    from accelerate_tpu_torch.optimizers import tree_leaves

    clip = acc_mod._clip_by_global_norm_

    def recorded(trees, *args, **kwargs):
        local.append(float(torch.sqrt(sum(
            torch.sum(torch.square(g.float())) for g in tree_leaves(trees)))))
        norm = clip(trees, *args, **kwargs)
        norms.append(float(norm))
        return norm

    with mock.patch.object(acc_mod, "_clip_by_global_norm_", recorded):
        yield


def flash_counters():
    from accelerate_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_forward,
            "flash_bwd_dq": fa.flash_backward_dq,
            "flash_bwd_dkv": fa.flash_backward_dkv}


def _expert_shapes(tree) -> dict:
    experts = tree["layers"]["moe"]["experts"]
    return {n: list(p["kernel"].shape) for n, p in experts.items()}


def main(argv: list[str] | None = None) -> dict:
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.optimizers import adamw
    from accelerate_tpu_torch.training import TrainState
    from accelerate_tpu_torch.utils.dataclasses import \
        ContextParallelPlugin, InitProcessGroupKwargs

    parser = argparse.ArgumentParser()
    parser.add_argument("--family", default="llama",
                        choices=["llama", "mixtral"])
    parser.add_argument("--cp_mode", choices=["ring", "ulysses"],
                        default=None)
    parser.add_argument("--cp_degree", type=int, default=2)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--seq_len", type=int, default=4096)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mixed_precision", default="bf16",
                        choices=["no", "bf16", "fp16"])
    parser.add_argument("--capacity_factor", type=float, default=1.25)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--update-sample", default=None)
    args = parser.parse_args(argv or [])

    plugin = (ContextParallelPlugin(mode=args.cp_mode,
                                    seq_degree=args.cp_degree)
              if args.cp_mode else None)
    acc = Accelerator(mixed_precision=args.mixed_precision,
                      gradient_clipping=1.0, context_parallel_plugin=plugin,
                      kwargs_handlers=[InitProcessGroupKwargs(
                          backend="gloo")])
    dev = acc.device
    mode = (acc.context_parallel_plugin.mode
            if acc.context_parallel_plugin is not None else None)
    family, cfg = model_config(args.family, args.tiny, args.layers, mode,
                               args.capacity_factor)
    state = acc.prepare(TrainState.create(
        apply_fn=None, params=family.init_params(cfg, args.seed, device=dev),
        tx=adamw(args.lr)))
    memory_gb = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        memory_gb = torch.cuda.memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
    ids = batch_ids(cfg.vocab_size, args.batch_size, args.seq_len, args.seed)
    (batch,) = list(acc.prepare([{"input_ids": ids}]))
    step = acc.train_step(lambda p, b: family.causal_lm_loss(cfg, p, b))

    # the main path's run: the launch counts at 0 just before, read after
    counters = flash_counters()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms, digests, norms, local_norms = [], [], [], [], []
    before = update_sample(state.params) if args.update_sample else None
    with clip_norms(norms, local_norms):
        for i in range(args.steps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            digests.append(digest(state.params))
            if i == 0 and args.update_sample and acc.is_main_process:
                np.save(args.update_sample,
                        update_sample(state.params) - before)
    launches = {name: fn.launches for name, fn in counters.items()}
    line = acc._data_line()
    result = {"rank": acc.process_index, "world": acc.num_processes,
              "family": args.family, "device": str(dev),
              "backend": acc.state.backend, "mesh": acc.mesh.shape,
              "line": [line.size, line.index],
              "attention_backend": getattr(cfg, "attention_backend", None),
              "batch_rows": int(batch["input_ids"].shape[0]),
              "losses": losses, "step_ms": step_ms, "digests": digests,
              "pre_clip_norms": norms, "local_norms": local_norms,
              "launches": launches,
              "memory_after_prepare_gb": memory_gb,
              "max_memory_allocated_gb": (
                  torch.cuda.max_memory_allocated(dev) / 1e9
                  if dev.type == "cuda" else None)}
    if args.family == "mixtral":
        result["expert_shapes"] = _expert_shapes(state.params)
        result["moment_shapes"] = {
            k: _expert_shapes(getattr(state.opt_state, k))
            for k in ("mu", "nu")}
    # one write of the whole line: the ranks share the launcher's stdout
    sys.stdout.write("CPT_RESULT " + json.dumps(result) + "\n")
    sys.stdout.flush()
    acc.wait_for_everyone()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
