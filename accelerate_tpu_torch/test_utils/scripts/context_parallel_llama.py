"""Launch-and-assert: sequence and expert parallelism, as a user runs it.

    python -m accelerate_tpu_torch.commands.launch --num_processes 2 \\
        context_parallel_llama.py [--config llama3_8b] [--parts a,b,c,d]

Every process builds `Accelerator(context_parallel_plugin=
ContextParallelPlugin(seq_degree=2))` with a gloo process group
(`InitProcessGroupKwargs(backend="gloo")`, so ranks may share a card):
its mesh is a `seq` axis of 2. Each builds llama weights in bf16 from
seed 0 itself, takes the same batch of one row of `--seq` + 1 tokens
from seed 1, and prints one line `CP_RESULT {json}` a part. Rank 0 also
runs one process's `attention_backend="flash"` on the same weights and
batch, and each part's loss and gradients are held against it:
relative L2 per parameter, and a digest (float64 sums) that equal
tensors share across ranks.

- part a: `causal_lm_loss` with `attention_backend="ring"` and its
  gradients through `torch.autograd.grad`; the flash kernels' launches
  of that call (K1a once a layer on rank 0, twice on rank 1; K1b and
  K1c the same). Then the same call with a planted fault, the backward
  fed each chunk's own output and LSE in place of the global ones
  (`_chunk_delta_bwd`): its gradients' relative L2, the reading the
  gate has to tell apart from a sound ring's. Then the ring alone at
  layer shapes ([1, S, 32, 128] queries, [1, S, 8, 128] keys and
  values, bf16, random from a seed) through the kernels and through
  their plain versions in f32 on the same chunks
  (`parallel.ring_attention.PLAIN`), forward and backward: the max abs
  error of the output (K1a), dQ (K1b) and dK/dV (K1c). And the ring
  alone with a left pad past the first chunk (S/2 + S/8 keys), against
  one process's flash over the whole sequence: rank 0's queries see no
  key (their LSE pinned back to 0) and rank 1's first chunk is fully
  masked (folded as -inf).
- part b: part a's call with a key-padding mask (the last `--pad` keys
  padded).
- part c: the same with `attention_backend="ulysses"`: 16 heads and 4
  KV heads a rank after the scatter, K1a once a layer on each rank (and
  K1b/K1c once).
- part d: one Mixtral-width MoE block (`MixtralConfig` widths, E=8,
  top-2) on `--moe-tokens` tokens, `moe_impl="a2a"` on an `expert` axis
  of 2 (each rank holding its 4 experts, `sharding.plan_sharding`'s
  block) at a capacity that drops nothing, forward and backward in
  bf16, against rank 0's one-process sort dispatch (`moe_impl="sparse"`
  at the same capacity); the dropped fraction of the compared call
  (its `expert_parallel_moe_a2a` run with `return_stats=True`), the
  call's time and the rank's peak memory.

`--config tiny` runs `LlamaConfig.tiny()`/`MixtralConfig.tiny()` widths
(with `--cpu` on the launcher, on the CPU).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from unittest import mock

import torch


def _emit(result: dict) -> None:
    # one write of the whole line: the ranks share the launcher's stdout
    sys.stdout.write("CP_RESULT " + json.dumps(result) + "\n")
    sys.stdout.flush()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev):
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    den = torch.linalg.vector_norm(b.double())
    return float(torch.linalg.vector_norm((a - b).double())
                 / max(float(den), 1e-30))


def _digest(tensors) -> list:
    """float64 sums of every tensor and of its squares."""
    return [float(sum(t.double().sum() for t in tensors)),
            float(sum((t.double() ** 2).sum() for t in tensors))]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(_flat(sub, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: tree}


def _unflat(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return tree


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


def _loss_and_grads(cfg, params, batch, dev):
    """(loss, {path: grad}, wall ms) of `causal_lm_loss` through
    `torch.autograd.grad` at every parameter."""
    from accelerate_tpu_torch.models import llama

    leaves = {k: v.detach().requires_grad_() for k, v in
              _flat(params).items()}
    _sync(dev)
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss = llama.causal_lm_loss(cfg, _unflat(leaves), batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    return float(loss.detach()), dict(zip(leaves, grads)), ms


def _llama_part(name, cfg, params, batch, ref, st, dev, layers):
    """One sequence-parallel call (launches counted from 0), timed twice,
    held against rank 0's one-process flash reference `ref`."""
    _zero_flash_counts()
    loss, grads, ms = _loss_and_grads(cfg, params, batch, dev)
    launches = _flash_counts()
    _, _, ms2 = _loss_and_grads(cfg, params, batch, dev)
    out = {"part": name, "rank": st.process_index,
           "backend": cfg.attention_backend, "layers": layers,
           "tokens": int(batch["input_ids"].shape[1]) - 1,
           "launches": launches, "loss": loss, "call_ms": [ms, ms2],
           "grad_digest": _digest(grads.values()),
           "grads_finite": all(bool(torch.isfinite(g.float()).all())
                               for g in grads.values()),
           "max_memory_allocated_gb": _peak_gb(dev)}
    if ref is not None:
        ref_loss, ref_grads = ref
        out["ref_loss"] = ref_loss
        out["grad_rel_l2"] = {k: _rel_l2(grads[k].float(),
                                         ref_grads[k].float())
                              for k in grads}
    return out


def _chunk_delta_bwd(q, k, v, o, lse, do, causal, mask):
    """A planted fault: a ring chunk's backward from the chunk's own
    output and LSE (recomputed by K1a) instead of the global ones."""
    from accelerate_tpu_torch.ops.flash_attention import flash_backward, \
        flash_forward

    o_i, lse_i = flash_forward(q, k, v, causal, mask, save_residuals=True)
    return flash_backward(q, k, v, o_i, lse_i, do, causal, mask)


def _fault_reading(cfg, params, batch, ref, dev):
    """The ring's loss gradients with `_chunk_delta_bwd` in place of the
    kernels' backward: each leaf's relative L2 against `ref` (rank 0),
    else None."""
    # the module (the package exports its function under the same name)
    ra = importlib.import_module("accelerate_tpu_torch.parallel."
                                 "ring_attention")
    with mock.patch.object(ra, "KERNELS", (ra.KERNELS[0],
                                           _chunk_delta_bwd)):
        _, grads, _ = _loss_and_grads(cfg, params, batch, dev)
    if ref is None:
        return None
    return {k: _rel_l2(grads[k].float(), ref[1][k].float()) for k in grads}


def _ring_kernel_check(cfg, st, dev, seq):
    """The ring alone at the layer's shapes, through the kernels and
    through their plain versions in f32 on the same chunks: the max abs
    error of the output (K1a), dQ (K1b) and dK/dV (K1c). Then through
    the kernels with a left pad past the first chunk, against one
    process's flash over the whole sequence."""
    from accelerate_tpu_torch.models.common import repeat_kv
    from accelerate_tpu_torch.ops.flash_attention import flash_backward, \
        flash_forward
    from accelerate_tpu_torch.parallel.ring_attention import KERNELS, \
        PLAIN, _Line, _reduce_heads, _ring_backward, _ring_forward

    group = st_mesh_group(st)
    n = torch.distributed.get_world_size(group)
    my = torch.distributed.get_rank(group)
    g = torch.Generator(device=dev).manual_seed(5)
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    q, do = (torch.randn((1, seq, nh, hd), generator=g, device=dev)
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((1, seq, nkv, hd), generator=g, device=dev)
            .bfloat16() for _ in range(2))
    s = seq // n
    qc, kc, vc, doc = (t[:, my * s:(my + 1) * s].contiguous()
                       for t in (q, k, v, do))
    errs = {}
    for tag, kernels, cast in (("kernel", KERNELS, lambda t: t),
                               ("plain", PLAIN, lambda t: t.float())):
        line = _Line(group, True, nh // nkv, kernels=kernels)
        o, lse = _ring_forward(line, cast(qc), cast(kc), cast(vc), None)
        dq, dk, dv = _ring_backward(line, cast(qc), cast(kc), cast(vc), o,
                                    lse, cast(doc), None)
        errs[tag] = (o, dq, dk, dv)
    _sync(dev)
    (o, dq, dk, dv), (ro, rdq, rdk, rdv) = errs["kernel"], errs["plain"]

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def finite(*ts):
        return all(bool(torch.isfinite(t.float()).all()) for t in ts)

    out = {"flash_fwd": err(o, ro), "flash_bwd_dq": err(dq, rdq),
           "flash_bwd_dkv": max(err(dk, rdk), err(dv, rdv)),
           "rel_l2": {"o": _rel_l2(o.float(), ro), "dq": _rel_l2(
               dq.float(), rdq), "dk": _rel_l2(dk.float(), rdk),
               "dv": _rel_l2(dv.float(), rdv)},
           "finite": finite(o, dq, dk, dv),
           "shape_q": [1, seq, nh, hd], "shape_kv": [1, seq, nkv, hd]}
    # a left pad past the first chunk: rank 0's queries see no key and
    # rank 1's first chunk is fully masked
    pad = seq // 2 + seq // 8
    mask = torch.ones((1, seq), dtype=torch.uint8, device=dev)
    mask[:, :pad] = 0
    mc = mask[:, my * s:(my + 1) * s].contiguous()
    line = _Line(group, True, nh // nkv)
    o, lse = _ring_forward(line, qc, kc, vc, mc)
    dq, dk, dv = _ring_backward(line, qc, kc, vc, o, lse, doc, mc)
    kr, vr = (repeat_kv(t, nh // nkv).contiguous() for t in (k, v))
    fo, flse = flash_forward(q, kr, vr, True, mask, save_residuals=True)
    fdq, fdk, fdv = flash_backward(q, kr, vr, fo, flse, do, True, mask)
    fdk, fdv = (_reduce_heads(t, nh // nkv) for t in (fdk, fdv))
    _sync(dev)
    mine = slice(my * s, (my + 1) * s)
    out["left_pad"] = {
        "pad": pad, "o": err(o, fo[:, mine]),
        "rel_l2": {"dq": _rel_l2(dq.float(), fdq[:, mine].float()),
                   "dk": _rel_l2(dk.float(), fdk[:, mine]),
                   "dv": _rel_l2(dv.float(), fdv[:, mine])},
        "finite": finite(o, dq, dk, dv)}
    return out


def st_mesh_group(st):
    from accelerate_tpu_torch.state import PartialState

    return PartialState().mesh.group("seq")


def parts_abc(args, acc, st, dev):
    import dataclasses

    from accelerate_tpu_torch.models import llama

    base = (llama.LlamaConfig.tiny(num_hidden_layers=args.layers)
            if args.config == "tiny" else
            llama.LlamaConfig.llama3_8b(num_hidden_layers=args.layers))
    params = llama.init_params(base, 0, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, base.vocab_size, (1, args.seq + 1), generator=g,
                        device=dev)
    mask = torch.ones_like(ids)
    mask[:, args.seq + 1 - args.pad:] = 0
    batches = {"a": {"input_ids": ids},
               "b": {"input_ids": ids, "attention_mask": mask},
               "c": {"input_ids": ids}}
    backends = {"a": "ring", "b": "ring", "c": "ulysses"}
    flash = dataclasses.replace(base, attention_backend="flash")
    refs = {}
    for part in args.parts:
        if part not in backends:
            continue
        ref = None
        if st.process_index == 0:
            key = "b" if part == "b" else "a"
            if key not in refs:
                loss, grads, _ = _loss_and_grads(flash, params,
                                                 batches[key], dev)
                refs[key] = (loss, grads)
            ref = refs[key]
        st.wait_for_everyone()
        cfg = dataclasses.replace(base, attention_backend=backends[part])
        out = _llama_part(part, cfg, params, batches[part], ref, st, dev,
                          args.layers)
        if part == "a":
            out["fault_grad_rel_l2"] = _fault_reading(
                cfg, params, batches["a"], ref, dev)
            out["ring_check"] = _ring_kernel_check(base, st, dev, args.seq)
        if part == "b":
            out["pad"] = args.pad
        _emit(out)
        st.wait_for_everyone()
    refs.clear()


def part_d(args, st, dev):
    """Expert parallelism: one Mixtral-width MoE block on an `expert`
    axis of 2 against one process's sort dispatch."""
    import dataclasses

    from accelerate_tpu_torch.models import mixtral
    from accelerate_tpu_torch.parallel import expert_parallel_moe_a2a
    from accelerate_tpu_torch.sharding import plan_sharding, shard_pytree
    from accelerate_tpu_torch.state import PartialState, ProcessMesh

    base = (mixtral.MixtralConfig.tiny(num_local_experts=8)
            if args.config == "tiny" else mixtral.MixtralConfig())
    h, f, E, k = (base.hidden_size, base.intermediate_size,
                  base.num_local_experts, base.num_experts_per_tok)
    # capacity that drops nothing: every source's tokens fit one expert
    cf = E / k
    a2a = dataclasses.replace(base, moe_impl="a2a", capacity_factor=cf)
    sparse = dataclasses.replace(base, moe_impl="sparse", capacity_factor=cf)
    g = torch.Generator(device=dev).manual_seed(3)

    def normal(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.02).bfloat16()

    moe = {"router": {"kernel": normal(h, E)},
           "experts": {"gate_proj": {"kernel": normal(E, h, f)},
                       "up_proj": {"kernel": normal(E, h, f)},
                       "down_proj": {"kernel": normal(E, f, h)}}}
    x = torch.randn((1, args.moe_tokens, h), generator=g,
                    device=dev).bfloat16()
    dy = torch.randn((1, args.moe_tokens, h), generator=g,
                     device=dev).bfloat16()
    mesh = ProcessMesh({"expert": PartialState.num_processes})
    mine = shard_pytree(moe, plan_sharding(moe, mesh))

    # the compared call's dropped fraction: its dispatch run with stats
    dropped = []

    def with_stats(*a, **kw):
        out, stats = expert_parallel_moe_a2a(*a, **kw, return_stats=True)
        dropped.append(float(stats["moe_dropped_fraction"]))
        return out

    def run(cfg, params):
        leaves = {p: t.detach().requires_grad_() for p, t in
                  _flat(params).items()}
        xg = x.detach().requires_grad_()
        _sync(dev)
        t0 = time.perf_counter()
        with torch.enable_grad():
            y, aux, _ = mixtral.moe_block(cfg, _unflat(leaves), xg)
            grads = torch.autograd.grad(
                (y.float() * dy.float()).sum() + aux,
                [xg, *leaves.values()])
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        return y.detach(), dict(zip(["x", *leaves], grads)), ms

    ref = None
    if st.process_index == 0:
        ref = run(sparse, moe)
    st.wait_for_everyone()
    PartialState().set_mesh(mesh)
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with mock.patch.object(mixtral, "expert_parallel_moe_a2a",
                               with_stats):
            y, grads, ms = run(a2a, mine)
        _, _, ms2 = run(a2a, mine)
    finally:
        PartialState().set_mesh(None)
    r = st.process_index
    out = {"part": "d", "rank": r, "tokens": args.moe_tokens,
           "experts": E, "experts_here": int(
               mine["experts"]["gate_proj"]["kernel"].shape[0]),
           "top_k": k, "capacity_factor": cf,
           "dropped_fraction": dropped[0], "dispatch_calls": len(dropped),
           "call_ms": [ms, ms2], "max_memory_allocated_gb": _peak_gb(dev),
           "out_digest": _digest([y]),
           "finite": bool(torch.isfinite(y.float()).all()) and all(
               bool(torch.isfinite(t.float()).all())
               for t in grads.values())}
    if ref is not None:
        ry, rgrads, rms = ref
        out["ref_call_ms"] = rms
        out["out_rel_l2"] = _rel_l2(y.float(), ry.float())
        per = {"x": _rel_l2(grads["x"].float(), rgrads["x"].float()),
               "router/kernel": _rel_l2(grads["router/kernel"].float(),
                                        rgrads["router/kernel"].float())}
        e = out["experts_here"]
        for name in ("gate_proj", "up_proj", "down_proj"):
            path = f"experts/{name}/kernel"
            per[path] = _rel_l2(grads[path].float(),
                                rgrads[path][r * e:(r + 1) * e].float())
        out["grad_rel_l2"] = per
    _emit(out)


def main(argv: list[str] | None = None) -> None:
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.utils.dataclasses import \
        ContextParallelPlugin, InitProcessGroupKwargs

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="llama3_8b",
                        choices=["llama3_8b", "tiny"])
    parser.add_argument("--parts", default="a,b,c,d")
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--seq", type=int, default=None)
    parser.add_argument("--pad", type=int, default=None)
    parser.add_argument("--moe-tokens", type=int, default=None)
    args = parser.parse_args(argv or [])
    tiny = args.config == "tiny"
    args.seq = args.seq or (64 if tiny else 4096)
    args.pad = args.pad or (8 if tiny else 512)
    args.moe_tokens = args.moe_tokens or (64 if tiny else 2048)
    args.parts = args.parts.split(",")

    acc = Accelerator(
        context_parallel_plugin=ContextParallelPlugin(seq_degree=2),
        kwargs_handlers=[InitProcessGroupKwargs(backend="gloo")])
    st = acc.state
    dev = acc.device
    torch.set_grad_enabled(False)
    parts_abc(args, acc, st, dev)
    if "d" in args.parts:
        part_d(args, st, dev)
    st.wait_for_everyone()


if __name__ == "__main__":
    main(sys.argv[1:])
