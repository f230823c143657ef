"""Launch-and-assert: pipeline-parallel and sharded llama inference, as a
user runs it.

    python -m accelerate_tpu_torch.commands.launch --num_processes 2 \\
        infer_llama_pp.py [--config llama3_8b] [--parts a,b,c]

Every process joins a gloo group (`PartialState(backend="gloo")`, so
ranks may share a card), builds llama weights from seed 0 itself and
prints one line `PP_RESULT {json}` a part. Logits are compared by each
prompt's relative L2 against process 0's one-process forward (rank 0
holds that forward), and across ranks by a digest (float64 sums, a
weighted one included) that equal tensors share.

- part a (f32, `--layers-a` layers, einsum attention): 4 prompts of
  2048 tokens through `prepare_pipeline` (embedding `pre_fn`, norm and
  head `post_fn`) on a `stage` axis of 2 with 2 and 4 chunks, through
  `prepare_sharded_inference(partial(llama.forward, cfg))` on a `model`
  axis of 2, and through `dispatch_model(params, "sharded")`, with each
  rank's parameter bytes under the last.
- part b (bf16, `--layers-b` layers, "auto" attention: the flash
  kernels on the card): 2 prompts through `prepare_pipeline` with 2
  chunks, called twice; of the second call: the flash forward's
  launches, the handoffs and their bytes and times and the rank's peak
  memory; both calls' times; the rank's layer bytes and the whole's.
- part c (bf16, `--layers-c` layers): `pipeline_value_and_grad(
  schedule="1f1b")` of an MSE loss over 4 micro-batches of [1, 2048]
  hidden states against targets, on a `stage` axis of 2, beside one
  process's autograd over the same layers and micro-batches, called
  twice; of the second call: the flash kernels' launches, the
  saved-input count, the handoffs; both calls' times.

`--config tiny` runs `LlamaConfig.tiny()` widths (with `--cpu` on the
launcher, on the CPU, with 64-token prompts).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np
import torch


def _emit(result: dict) -> None:
    # one write of the whole line: the ranks share the launcher's stdout
    sys.stdout.write("PP_RESULT " + json.dumps(result) + "\n")
    sys.stdout.flush()


def _config(name: str, layers: int, **kw):
    from accelerate_tpu_torch.models import llama

    if name == "tiny":
        return llama.LlamaConfig.tiny(num_hidden_layers=layers, **kw)
    return llama.LlamaConfig.llama3_8b(num_hidden_layers=layers, **kw)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _digest(x: torch.Tensor) -> list:
    """float64 sums of x, of its squares and of x weighted along its
    last dim by a fixed ramp: equal tensors give equal digests."""
    ramp = torch.linspace(-1.0, 1.0, x.shape[-1], dtype=x.dtype,
                          device=x.device)
    return [float(v.sum(dtype=torch.float64)) for v in (x, x * x, x * ramp)]


def _peak_gb(dev):
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)


def _timed(dev, fn):
    """(fn(), its wall ms between two device synchronises)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def _edges(cfg, params):
    """The embedding (`pre_fn`), one layer (`layer_fn`) and the norm and
    head (`post_fn`) of llama's forward."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.common import rms_norm, \
        rope_frequencies

    def pre(ids):
        return params["embed_tokens"]["embedding"][ids.long()]

    def layer(p, x):
        cos, sin = rope_frequencies(cfg.head_dim, x.shape[1], cfg.rope_theta,
                                    scaling=cfg.rope_scaling_dict,
                                    device=x.device)
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
        return llama._layer_body(cfg, x, p, cos, sin, positions, None)[0]

    def post(h):
        h = rms_norm(h, params["norm"]["scale"], cfg.rms_norm_eps)
        return llama._project_out(cfg, params, h)

    return pre, layer, post


class _Reference:
    """Process 0's one-process forward, a prompt at a time."""

    def __init__(self, cfg, params, ids, rank):
        self.cfg, self.params, self.ids, self.rank = cfg, params, ids, rank

    def rel(self, got: torch.Tensor) -> list | None:
        from accelerate_tpu_torch.models import llama

        if self.rank != 0:
            return None
        out = []
        for i in range(self.ids.shape[0]):
            want = llama.forward(self.cfg, self.params, self.ids[i:i + 1])
            out.append(_rel_l2(got[i:i + 1], want))
            del want
        return out


def _prompts(args, vocab, n, dev):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (n, args.seq)).astype(np.int64)
    return torch.from_numpy(ids).to(dev)


def part_a(args, st, dev):
    from accelerate_tpu_torch.big_modeling import dispatch_model
    from accelerate_tpu_torch.inference import prepare_pipeline, \
        prepare_sharded_inference
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.state import ProcessMesh

    n = st.num_processes
    cfg = _config(args.config, args.layers_a, attention_backend="einsum")
    params = llama.init_params(cfg, 0, dtype=torch.float32, device=dev)
    ids = _prompts(args, cfg.vocab_size, 4, dev)
    ref = _Reference(cfg, params, ids, st.process_index)
    out = {"part": "a", "rank": st.process_index, "world": n,
           "layers": cfg.num_hidden_layers, "prompts": list(ids.shape),
           "results": {}}
    pre, layer, post = _edges(cfg, params)
    for chunks in (2, 4):
        model = prepare_pipeline(layer, params["layers"], num_chunks=chunks,
                                 mesh=ProcessMesh({"stage": n}, device=dev),
                                 pre_fn=pre, post_fn=post, device=dev)
        got = model(ids)
        out["results"][f"pipeline_{chunks}"] = {
            "digest": _digest(got), "rel_l2": ref.rel(got),
            "handoffs": model.stats.handoffs}
        del model, got
    fn, sharded = prepare_sharded_inference(
        functools.partial(llama.forward, cfg), params,
        mesh=ProcessMesh({"model": n}, device=dev), device=dev)
    got = fn(sharded, ids)
    out["results"]["sharded_inference"] = {
        "digest": _digest(got), "rel_l2": ref.rel(got), "route": fn.route}
    del fn, sharded, got
    placed = dispatch_model(params, "sharded", device=dev)
    got = llama.forward(cfg, placed, ids)
    out["results"]["dispatch_model"] = {
        "digest": _digest(got), "rel_l2": ref.rel(got)}
    out["param_bytes"] = _bytes(placed)
    out["param_bytes_whole"] = _bytes(params)
    del placed, got, params, ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _emit(out)


def _flash_counts():
    from accelerate_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_forward.launches,
            "flash_bwd_dq": fa.flash_backward_dq.launches,
            "flash_bwd_dkv": fa.flash_backward_dkv.launches}


def _zero_flash_counts():
    from accelerate_tpu_torch.ops import flash_attention as fa

    fa.flash_forward.launches = 0
    fa.flash_backward_dq.launches = 0
    fa.flash_backward_dkv.launches = 0


def part_b(args, st, dev):
    from accelerate_tpu_torch.inference import prepare_pipeline
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.state import ProcessMesh

    n = st.num_processes
    cfg = _config(args.config, args.layers_b)
    full = llama.init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    ids = _prompts(args, cfg.vocab_size, 2, dev)
    # process 0's one-process forward first, while it holds every layer
    wants = None
    if st.process_index == 0:
        wants = [llama.forward(cfg, full, ids[i:i + 1])
                 for i in range(ids.shape[0])]
    layer_bytes_whole = _bytes(full["layers"])
    pre, layer, post = _edges(cfg, full)
    model = prepare_pipeline(layer, full["layers"], num_chunks=2,
                             mesh=ProcessMesh({"stage": n}, device=dev),
                             pre_fn=pre, post_fn=post, device=dev)
    del full["layers"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    st.wait_for_everyone()
    first_ms = _timed(dev, lambda: model(ids))[1]
    # the main path's run: the kernels' counts at 0 just before, read after
    _zero_flash_counts()
    got, call_ms = _timed(dev, lambda: model(ids))
    launches = _flash_counts()
    peak = _peak_gb(dev)
    out = {"part": "b", "rank": st.process_index, "world": n,
           "layers": cfg.num_hidden_layers, "prompts": list(ids.shape),
           "num_chunks": model.num_chunks, "launches": launches,
           "layer_bytes": _bytes(model.stage_params),
           "layer_bytes_whole": layer_bytes_whole,
           "handoffs": model.stats.handoffs,
           "handoff_bytes": model.stats.handoff_bytes,
           "exchange_ms": model.stats.exchange_ms,
           "broadcast_bytes": model.stats.broadcast_bytes,
           "ticks": model.stats.ticks, "call_ms": [first_ms, call_ms],
           "digest": _digest(got),
           "finite": bool(torch.isfinite(got).all()),
           "logits_rel_l2": (None if wants is None else
                             [_rel_l2(got[i:i + 1], w)
                              for i, w in enumerate(wants)]),
           "max_memory_allocated_gb": peak}
    del model, got, wants, full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _emit(out)


def part_c(args, st, dev):
    from accelerate_tpu_torch.inference import make_stage_fn
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.parallel import ScheduleStats, \
        pipeline_value_and_grad, stack_layers_into_stages, stage_block
    from accelerate_tpu_torch.state import ProcessMesh

    n, M = st.num_processes, 4
    cfg = _config(args.config, args.layers_c)
    layers = llama.init_params(cfg, 0, dtype=torch.bfloat16,
                               device=dev)["layers"]
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((M, args.seq, cfg.hidden_size), generator=g,
                    device=dev).to(torch.bfloat16)
    tgt = torch.randn((M, args.seq, cfg.hidden_size), generator=g,
                      device=dev).to(torch.bfloat16)
    _, layer, _ = _edges(cfg, {})
    stage_fn = make_stage_fn(layer)

    def mse(y, t):
        return torch.mean((y - t) ** 2)

    mesh = ProcessMesh({"stage": n}, device=dev)
    staged = stack_layers_into_stages(layers, n)
    # one process's autograd over the same layers and micro-batches, for
    # this rank's block of the gradients
    leaves = {k: v for k, v in _flat(layers).items()}
    wrt = [v.detach().requires_grad_() for v in leaves.values()]
    tree = _unflat(dict(zip(leaves, wrt)))
    with torch.enable_grad():
        ref_loss = torch.stack([mse(stage_fn(tree, x[m:m + 1]),
                                    tgt[m:m + 1]).float()
                                for m in range(M)]).mean()
        ref_grads = torch.autograd.grad(ref_loss, wrt)
    per = cfg.num_hidden_layers // n
    s = mesh.axis_index("stage")
    ref_block = {k: gr[s * per:(s + 1) * per]
                 for k, gr in zip(leaves, ref_grads)}
    del ref_grads, wrt, tree
    block = stage_block(staged, mesh)
    del layers, staged, leaves
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    st.wait_for_everyone()

    def step(stats=None):
        return pipeline_value_and_grad(stage_fn, mse, block, x, tgt, M,
                                       mesh=mesh, schedule="1f1b",
                                       stats=stats)

    first_ms = _timed(dev, step)[1]
    stats = ScheduleStats()
    _zero_flash_counts()
    (loss, grads), call_ms = _timed(dev, lambda: step(stats))
    launches = _flash_counts()
    peak = _peak_gb(dev)
    rel = {k: _rel_l2(g[0], ref_block[k]) for k, g in _flat(grads).items()}
    out = {"part": "c", "rank": st.process_index, "world": n,
           "layers": cfg.num_hidden_layers, "micro_batches": M,
           "micro_shape": [1, args.seq, cfg.hidden_size],
           "launches": launches, "loss": float(loss),
           "ref_loss": float(ref_loss),
           "grad_rel_l2": rel,
           "grads_finite": all(bool(torch.isfinite(g).all())
                               for g in _flat(grads).values()),
           "max_saved_inputs": stats.max_saved_inputs,
           "saved_bound": 2 * (n - 1 - s) + 1,
           "handoffs": stats.handoffs, "handoff_bytes": stats.handoff_bytes,
           "exchange_ms": stats.exchange_ms, "ticks": stats.ticks,
           "call_ms": [first_ms, call_ms], "max_memory_allocated_gb": peak}
    del grads, block
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _emit(out)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def main(argv: list[str] | None = None) -> None:
    from accelerate_tpu_torch.state import PartialState

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="llama3_8b",
                        choices=["llama3_8b", "tiny"])
    parser.add_argument("--parts", default="a,b,c")
    parser.add_argument("--layers-a", type=int, default=4)
    parser.add_argument("--layers-b", type=int, default=32)
    parser.add_argument("--layers-c", type=int, default=4)
    parser.add_argument("--seq", type=int, default=None)
    args = parser.parse_args(argv or [])
    if args.seq is None:
        args.seq = 64 if args.config == "tiny" else 2048

    st = PartialState(backend="gloo")
    dev = st.device
    torch.set_grad_enabled(False)
    parts = args.parts.split(",")
    if "a" in parts:
        part_a(args, st, dev)
    if "b" in parts:
        part_b(args, st, dev)
    if "c" in parts:
        part_c(args, st, dev)
    st.wait_for_everyone()


if __name__ == "__main__":
    main(sys.argv[1:])
