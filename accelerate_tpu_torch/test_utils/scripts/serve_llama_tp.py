"""Launch-and-assert: tensor-parallel llama serving, as a user runs it.

    python -m accelerate_tpu_torch.commands.launch --num_processes 2 \\
        serve_llama_tp.py [--config llama3_8b] [--parts a,b]

Every process joins a gloo group (`PartialState(backend="gloo")`, so
ranks may share a card), builds llama weights from seed 0 itself, and
serves 12 requests (100-1500 tokens, four sharing a 512-token prefix;
greedy and temperature 0.8 alternating; 32 new tokens each) through a
tensor-parallel engine over all processes (`serving.pod.tensor_mesh`).
Each prints one line `TP_RESULT {json}` a part.

- part a (f32, `--layers-a` layers): process 0 first serves the requests
  on a one-process engine over the whole weights (dense decode, as the
  meshed engine's); then every process serves them through
  `sharded_engine` and through `PodRouter(PodConfig(tensor_parallel=N))`
  with a prefill and a decode worker. The streams of all three.
- part b (bf16, `--layers-b` layers): the shard's parameter bytes and
  the whole model's, the shard's KV pool bytes and a one-process pool's,
  each prompt's logits through the tensor-parallel forward against
  process 0's one-process forward (relative L2), then the streams of
  `sharded_engine`, the paged-decode kernel's launches (none: a meshed
  engine decodes on the dense path), the decode step and prefill chunk
  times, and the collectives a decode step makes and their host time.

`--config tiny` serves `LlamaConfig.tiny()` (with `--cpu` on the
launcher, on the CPU, with 128-token prompts)."""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

ENGINE = dict(num_slots=8, max_len=2048, prefill_chunk=128, page_size=16)


def _prompts(rng, vocab, low=100, high=1501, shared=512):
    """12 prompts; four (at 0 and 9-11) share a `shared`-token prefix."""
    prefix = rng.integers(0, vocab, shared)
    out = []
    for i in range(12):
        if i in (0, 9, 10, 11):
            n = int(rng.integers(max(low, shared + 1), high))
            p = np.concatenate([prefix, rng.integers(0, vocab, n - shared)])
        else:
            p = rng.integers(0, vocab, int(rng.integers(low, high)))
        out.append(p.astype(np.int32))
    return out


class _Collectives:
    """Counts the tensor-parallel collectives (`utils.operations`'
    axis ops) and their host seconds, through wrappers on the module."""

    NAMES = ("axis_all_reduce", "axis_all_gather", "axis_broadcast_float")

    def __init__(self):
        from accelerate_tpu_torch.utils import operations as ops

        self.calls = {n: 0 for n in self.NAMES}
        self.seconds = {n: 0.0 for n in self.NAMES}
        for name in self.NAMES:
            setattr(ops, name, self._wrap(name, getattr(ops, name)))

    def _wrap(self, name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.calls[name] += 1
                self.seconds[name] += time.perf_counter() - t0
        return run

    def snapshot(self):
        return dict(self.calls), dict(self.seconds)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _drive(eng, prompts, temps, dev, counter=None, max_new=32):
    """Submit every request, step to idle; (streams, decode step ms,
    prefill step ms, collectives per decode step, their host ms)."""
    reqs = [eng.submit(p, max_new_tokens=max_new, temperature=t,
                       key=1000 + i)
            for i, (p, t) in enumerate(zip(prompts, temps))]
    decode_ms, prefill_ms, coll, coll_ms = [], [], [], []
    metrics = getattr(eng, "metrics", None)
    while True:
        steps = metrics.decode_steps if metrics is not None else 0
        before = counter.snapshot() if counter is not None else None
        _sync(dev)
        t = time.perf_counter()
        if not eng.step():
            break
        _sync(dev)
        ms = (time.perf_counter() - t) * 1e3
        decoded = metrics is not None and metrics.decode_steps > steps
        (decode_ms if decoded else prefill_ms).append(ms)
        if decoded and counter is not None:
            after = counter.snapshot()
            coll.append(sum(after[0].values()) - sum(before[0].values()))
            coll_ms.append((sum(after[1].values())
                            - sum(before[1].values())) * 1e3)
    return [list(r.tokens) for r in reqs], decode_ms, prefill_ms, coll, \
        coll_ms


def _median(xs):
    return float(sorted(xs)[len(xs) // 2]) if xs else None


def _emit(result: dict) -> None:
    # one write of the whole line: the ranks share the launcher's stdout
    sys.stdout.write("TP_RESULT " + json.dumps(result) + "\n")
    sys.stdout.flush()


def _config(name: str, layers: int):
    from accelerate_tpu_torch.models import llama

    if name == "tiny":
        return llama.LlamaConfig.tiny(num_hidden_layers=layers)
    return llama.LlamaConfig.llama3_8b(num_hidden_layers=layers)


def part_a(args, st, dev, prompts, temps):
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.serving import Engine, EngineConfig
    from accelerate_tpu_torch.serving.pod import (
        PodConfig,
        PodRouter,
        sharded_engine,
        tensor_mesh,
    )

    cfg = _config(args.config, args.layers_a)
    full = llama.init_params(cfg, 0, dtype=torch.float32, device=dev)
    ec = EngineConfig(cache_dtype=torch.float32, paged_attention=False,
                      **ENGINE)
    out = {"part": "a", "rank": st.process_index,
           "world": st.num_processes, "layers": cfg.num_hidden_layers}
    if st.process_index == 0:
        single = Engine(llama, cfg, full, ec, device=dev)
        out["single"] = _drive(single, prompts, temps, dev)[0]
        del single
    mesh = tensor_mesh(st.num_processes, device=dev)
    eng = sharded_engine(llama, cfg, full, ec, mesh=mesh, device=dev)
    out["sharded"], dms, pms, _, _ = _drive(eng, prompts, temps, dev)
    out["compile_stats"] = eng.compile_stats()
    out["graphs_captured"] = eng.graphs_captured
    out["decode_step_ms_median"] = _median(dms)
    out["prefill_chunk_ms_median"] = _median(pms)
    del eng
    pod = PodRouter(llama, cfg, full, ec, PodConfig(
        prefill_workers=1, decode_workers=1,
        tensor_parallel=st.num_processes), device=dev)
    out["pod"] = _drive(pod, prompts, temps, dev)[0]
    out["pod_shipments"] = pod.metrics_summary()["pod_shipments"]
    out["pod_page_bytes_per_page"] = \
        pod.decode_workers[0].cache.page_nbytes
    pod.close()
    del pod, full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _emit(out)


def _leaf_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def part_b(args, st, dev, prompts, temps, counter):
    from accelerate_tpu_torch.device import meta_init
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import \
        paged_decode_attention
    from accelerate_tpu_torch.serving import Engine, EngineConfig
    from accelerate_tpu_torch.serving.cache import PagedKVCache
    from accelerate_tpu_torch.serving.pod import shard_params, tensor_mesh

    cfg = _config(args.config, args.layers_b)
    full = llama.init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    whole_bytes = _leaf_bytes(full)
    mesh = tensor_mesh(st.num_processes, device=dev)
    placed = shard_params(full, mesh)
    if st.process_index != 0:
        del full
        full = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # each prompt's logits: the tensor-parallel forward on every rank,
    # process 0's one-process forward beside it
    rel = []
    for p in prompts:
        ids = torch.as_tensor(p, device=dev)[None]
        got = llama.forward(cfg, placed, ids)
        if full is not None:
            want = llama.forward(cfg, full, ids)
            rel.append(float(torch.linalg.vector_norm(got - want)
                             / torch.linalg.vector_norm(want)))
            del want
        del got
    del full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ec = EngineConfig(cache_dtype=torch.bfloat16, **ENGINE)
    eng = Engine(llama, cfg, placed, dataclasses.replace(ec, mesh=mesh),
                 device=dev)
    with meta_init():
        one = PagedKVCache.create(
            cfg.num_hidden_layers, ec.num_slots, ec.max_len,
            cfg.num_key_value_heads, cfg.head_dim, dtype=ec.cache_dtype,
            page_size=ec.page_size, pad_slack=ec.prefill_chunk)
    # the main path's run: the kernel's count at 0 just before, read after
    paged_decode_attention.launches = 0
    streams, dms, pms, coll, coll_ms = _drive(eng, prompts, temps, dev,
                                              counter)
    out = {"part": "b", "rank": st.process_index,
           "world": st.num_processes, "layers": cfg.num_hidden_layers,
           "streams": streams,
           "paged_kernel_launches": paged_decode_attention.launches,
           "param_bytes": _leaf_bytes(placed),
           "param_bytes_whole": whole_bytes,
           "pool_bytes": eng.cache.nbytes(),
           "pool_bytes_one_process": one.nbytes(),
           "pool_spec": list(eng.cache_shardings[0].k.spec),
           "logits_rel_l2": rel,
           "compile_stats": eng.compile_stats(),
           "graphs_captured": eng.graphs_captured,
           "decode_step_ms_median": _median(dms),
           "prefill_chunk_ms_median": _median(pms),
           "decode_steps": len(dms), "prefill_steps": len(pms),
           "collectives_per_decode_step": _median(coll),
           "collective_host_ms_per_decode_step_median": _median(coll_ms),
           "max_memory_allocated_gb": (
               torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else None)}
    del eng, placed
    _emit(out)


def main(argv: list[str] | None = None) -> None:
    from accelerate_tpu_torch.state import PartialState

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="llama3_8b",
                        choices=["llama3_8b", "tiny"])
    parser.add_argument("--parts", default="a,b")
    parser.add_argument("--layers-a", type=int, default=4)
    parser.add_argument("--layers-b", type=int, default=32)
    args = parser.parse_args(argv or [])

    st = PartialState(backend="gloo")
    dev = st.device
    torch.set_grad_enabled(False)
    counter = _Collectives()
    vocab = _config(args.config, 1).vocab_size
    if args.config == "tiny":
        prompts = _prompts(np.random.default_rng(0), vocab, 20, 100, 40)
    else:
        prompts = _prompts(np.random.default_rng(0), vocab)
    temps = [0.0 if i % 2 == 0 else 0.8 for i in range(12)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    parts = args.parts.split(",")
    if "a" in parts:
        part_a(args, st, dev, prompts, temps)
    if "b" in parts:
        part_b(args, st, dev, prompts, temps, counter)
    st.wait_for_everyone()


if __name__ == "__main__":
    main(sys.argv[1:])
