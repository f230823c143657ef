#!/usr/bin/env python3
"""Drive the PyTorch port (`accelerate_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line; a failing phase raises and the
script exits non-zero:

1. device: the card's name, count, and nvidia-smi name + power limit;
2. build: every CUDA source of the port, one nvcc each, all at once;
3. kernel: each kernel against its plain PyTorch version at the serving
   path's shapes, with its time, its bound and a library yardstick;
4. engine: the serving engine at llama3-8B width and depth (random bf16
   weights from a seed), 12 requests through the paged-decode kernel;
5. parity: one decode step through the kernel path and the dense-gather
   path from the same pool state, logits compared.

The line before the last is the kernel table; the last line is
{"ok": true, "device": {...}}. With no CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory, data sheet
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back launches."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("device", **info)
    print(smi, flush=True)  # the card's name and power limit, verbatim
    return info


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def phase_build():
    from accelerate_tpu_torch import csrc

    names = csrc.sources()
    t0 = time.perf_counter()
    csrc.build(names)
    wall = time.perf_counter() - t0
    for name in names:
        info = csrc.build_info[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        emit("build", source=f"accelerate_tpu_torch/csrc/{name}.cu",
             arch="sm_90a", seconds=info["seconds"], ptxas=ptxas)
    emit("build_all", sources=names, wall_seconds=wall)


# ---------------------------------------------------------------------------
# phase 3: paged decode kernel (K2) against its plain version
# ---------------------------------------------------------------------------


def _paged_inputs(pool_dtype, S=8, Hkv=8, G=4, D=128, ps=16, P=136,
                  seed=0):
    """Pool, page table and lengths at the serving path's shapes, with
    the engine's corner cases: empty, sub-page, page-boundary and full
    slots, stale rows past every length, pages shared between two slots,
    trash-padded table rows."""
    import torch

    from accelerate_tpu_torch.ops.paged_attention import (
        PagedDecodeMeta, PagedKV)
    from accelerate_tpu_torch.ops.quant import kv_quantize_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = [0, 1, 15, 16, 17, 1000, P * ps - 1, 600]
    num_pages = S * P
    trash = num_pages
    table = torch.full((S, P), trash, dtype=torch.int32)
    nxt = 0
    for s, n in enumerate(lengths):
        live = -(-n // ps)
        table[s, :live] = torch.arange(nxt, nxt + live)
        nxt += live
    # slot 7 reuses slot 5's first 20 pages (a shared prompt prefix)
    table[7, :20] = table[5, :20]
    shape = (num_pages + 1, ps, Hkv, D)
    k = torch.randn(shape, generator=g, device=dev)
    v = torch.randn(shape, generator=g, device=dev)
    q_dtype = torch.float32 if pool_dtype == torch.float32 else torch.bfloat16
    q = torch.randn((S, 1, Hkv * G, D), generator=g, device=dev).to(q_dtype)
    kn = torch.randn((S, 1, Hkv, D), generator=g, device=dev).to(q_dtype)
    vn = torch.randn((S, 1, Hkv, D), generator=g, device=dev).to(q_dtype)
    if pool_dtype == torch.int8:
        ck, sk = kv_quantize_rows(k)
        cv, sv = kv_quantize_rows(v)
        pk = PagedKV(ck, sk, compute_dtype=torch.bfloat16)
        pv = PagedKV(cv, sv, compute_dtype=torch.bfloat16)
    else:
        pk, pv = PagedKV(k.to(pool_dtype)), PagedKV(v.to(pool_dtype))
    meta = PagedDecodeMeta(table.to(dev), torch.tensor(
        lengths, dtype=torch.int32, device=dev), rows=P * ps)
    return q, kn, vn, pk, pv, meta, lengths


def _paged_bound(q, pk, lengths, ps, G):
    """Least time for the call on this data: the live pages' bytes (K
    and V, plus scales) and q/out/new-row bytes over HBM bandwidth, or
    its f32 flops over the f32 peak, whichever is larger."""
    import torch

    S, _, H, D = q.shape
    Hkv = H // G
    elt = pk.data.element_size()
    page = ps * Hkv * D * elt + (ps * Hkv * 2 if pk.quantized else 0)
    live_pages = sum(-(-n // ps) for n in lengths)
    qe = q.element_size()
    row_e = torch.empty((), dtype=pk.row_dtype).element_size()
    nbytes = (2 * live_pages * page + 2 * S * H * D * qe
              + 2 * S * Hkv * D * row_e)
    flops = sum(4 * H * D * (n + 1) for n in lengths)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _sdpa_yardstick(q, kn, vn, pk, pv, meta, lengths):
    """One PyTorch call computing the same function (never called by the
    port): scaled_dot_product_attention over the K/V gathered dense
    beforehand, the new row overlaid, a boolean visibility mask."""
    import torch
    import torch.nn.functional as F

    S, _, H, D = q.shape
    Hkv = kn.shape[2]
    table = meta.table.long()
    R = meta.rows
    k = pk.data[table].reshape(S, R, Hkv, D)
    v = pv.data[table].reshape(S, R, Hkv, D)
    if pk.quantized:
        k = (k.float() * pk.scales[table].reshape(S, R, Hkv, 1).float())
        v = (v.float() * pv.scales[table].reshape(S, R, Hkv, 1).float())
    k = k.to(q.dtype).clone()
    v = v.to(q.dtype).clone()
    ln = meta.lengths.long()
    idx = torch.arange(S, device=q.device)
    k[idx, ln.clamp(max=R - 1)] = kn[:, 0].to(q.dtype)
    v[idx, ln.clamp(max=R - 1)] = vn[:, 0].to(q.dtype)
    rows = torch.arange(R, device=q.device)
    mask = (rows[None, :] <= ln[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    return call


def phase_paged_kernel():
    import torch

    from accelerate_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_reference)

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.int8: 2e-2}
    ps, G = 16, 4
    timing = None
    for pool_dtype in (torch.float32, torch.bfloat16, torch.int8):
        q, kn, vn, pk, pv, meta, lengths = _paged_inputs(pool_dtype)
        for window in (None, 300):
            out, (kr, vr) = paged_decode_attention(q, kn, vn, pk, pv, meta,
                                                   window=window)
            ref, (rk, rv) = paged_decode_reference(q, kn, vn, pk, pv, meta,
                                                   window=window)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            rows_equal = bool(torch.equal(kr, rk) and torch.equal(vr, rv))
            ok = err <= tol[pool_dtype] and rows_equal and bool(
                torch.isfinite(out.float()).all())
            emit("kernel_check", kernel="paged_decode",
                 pool=str(pool_dtype).replace("torch.", ""),
                 window=window, max_abs_err=err, tol=tol[pool_dtype],
                 rows_identical=rows_equal, ok=ok)
            if not ok:
                raise AssertionError(
                    f"paged_decode disagrees with its plain version: pool "
                    f"{pool_dtype} window {window} err {err}")
            if pool_dtype == torch.bfloat16 and window is None:
                timing = (q, kn, vn, pk, pv, meta, lengths, err)
    # timed at the engine's configuration: bf16 pool, no window
    q, kn, vn, pk, pv, meta, lengths, err = timing
    ms = cuda_time_ms(
        lambda: paged_decode_attention(q, kn, vn, pk, pv, meta), iters=200)
    plain_ms = cuda_time_ms(
        lambda: paged_decode_reference(q, kn, vn, pk, pv, meta), iters=20)
    library_ms = cuda_time_ms(
        _sdpa_yardstick(q, kn, vn, pk, pv, meta, lengths), iters=200)
    bound_ms, bound_by = _paged_bound(q, pk, lengths, ps, G)
    row = {"name": "paged_decode", "route": "cuda",
           "source": "accelerate_tpu_torch/csrc/paged_decode.cu",
           "replaces": "accelerate_tpu/ops/paged_attention.py:157",
           "launches": None, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    emit("kernel_time", **row)
    return [row]


# ---------------------------------------------------------------------------
# phase 4a: the engine on the card against the engine on the CPU, tiny
# ---------------------------------------------------------------------------


def _serve(engine, prompts, temps, max_new, keys):
    reqs = [engine.submit(p, max_new_tokens=max_new, temperature=t, key=k)
            for p, t, k in zip(prompts, temps, keys)]
    engine.run_until_idle()
    return reqs


def phase_small_parity():
    """Greedy streams of a tiny llama (f32): the card's engine through
    the kernel against the CPU engine through the dense-gather path."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to_numpy, \
        params_from_numpy
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    # head_dim 32: the kernel takes multiples of 32
    cfg = llama.LlamaConfig.tiny(hidden_size=256, num_attention_heads=8,
                                 num_key_value_heads=2)
    params = llama.init_params(cfg, 0, device="cuda")
    cpu_params = params_from_numpy(params_to_numpy(params), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 13, 9, 40, 21)]
    temps, keys = [0.0] * len(prompts), list(range(len(prompts)))
    kw = dict(num_slots=3, max_len=96, prefill_chunk=8, page_size=16,
              cache_dtype=torch.float32)
    card = _serve(Engine(llama, cfg, params, EngineConfig(
        paged_attention=True, **kw)), prompts, temps, 8, keys)
    host = _serve(Engine(llama, cfg, cpu_params, EngineConfig(
        paged_attention=False, **kw), device="cpu"), prompts, temps, 8, keys)
    same = [a.tokens for a in card] == [b.tokens for b in host]
    lp_err = max(abs(x - y) for a, b in zip(card, host)
                 for x, y in zip(a.logprobs, b.logprobs))
    emit("small_parity", head_dim=cfg.head_dim, tokens_identical=same,
         logprob_max_abs_err=lp_err)
    if not same or lp_err > 1e-3:
        raise AssertionError("card engine disagrees with the CPU engine")


# ---------------------------------------------------------------------------
# phase 4b: the engine at llama3-8B width and depth
# ---------------------------------------------------------------------------


def _prompts(rng, vocab):
    """12 prompts of 100-1500 tokens; four (600-1500 tokens) share a
    512-token prefix. Sharers sit at 0 and 9-11: the late three admit
    once slots free up, after the first retired into the prefix cache."""
    import numpy as np

    prefix = rng.integers(0, vocab, 512)
    out = []
    for i in range(12):
        if i in (0, 9, 10, 11):
            n = int(rng.integers(600, 1501))
            p = np.concatenate([prefix, rng.integers(0, vocab, n - 512)])
        else:
            p = rng.integers(0, vocab, int(rng.integers(100, 1501)))
        out.append(p.astype(np.int32))
    return out


def phase_engine(kernel_rows):
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import \
        paged_decode_attention
    from accelerate_tpu_torch.serving import Engine, EngineConfig, \
        RequestStatus

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, 0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ec = EngineConfig(num_slots=8, max_len=2048, prefill_chunk=128,
                      page_size=16, cache_dtype=torch.bfloat16,
                      paged_attention=True)
    eng = Engine(llama, cfg, params, ec)
    prompts = _prompts(np.random.default_rng(0), cfg.vocab_size)
    temps = [0.0 if i % 2 == 0 else 0.8 for i in range(12)]
    torch.cuda.reset_peak_memory_stats()
    decode_s, prefill_s = [], []
    # the main path's run: every count at 0 just before, read just after
    paged_decode_attention.launches = 0
    t_run = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32, temperature=t, key=1000 + i)
            for i, (p, t) in enumerate(zip(prompts, temps))]
    while True:
        steps = eng.metrics.decode_steps
        torch.cuda.synchronize()
        t = time.perf_counter()
        if not eng.step():
            break
        torch.cuda.synchronize()
        (decode_s if eng.metrics.decode_steps > steps
         else prefill_s).append(time.perf_counter() - t)
    run_s = time.perf_counter() - t_run
    launches = paged_decode_attention.launches
    summary = eng.metrics_summary()
    steps = eng.metrics.decode_steps
    decode_tokens = sum(len(r.tokens) for r in reqs) - len(reqs)
    emit("engine", config="llama3_8b", layers=cfg.num_hidden_layers,
         params_init_s=init_s, requests=len(reqs),
         prompt_tokens=int(sum(len(p) for p in prompts)),
         finished=sum(r.status is RequestStatus.FINISHED for r in reqs),
         tokens=[len(r.tokens) for r in reqs], decode_steps=steps,
         paged_decode_launches=launches,
         prefill_chunks=summary["prefill_chunks"],
         prefix_hit_rate=summary.get("prefix_hit_rate"),
         ttft_p50_ms=summary.get("ttft_p50_ms"),
         ttft_p99_ms=summary.get("ttft_p99_ms"),
         decode_step_ms_median=float(np.median(decode_s)) * 1e3,
         decode_step_ms_mean=float(np.mean(decode_s)) * 1e3,
         prefill_chunk_ms_median=float(np.median(prefill_s)) * 1e3,
         decode_tokens_per_s=decode_tokens / sum(decode_s),
         tokens_per_s=sum(len(r.tokens) for r in reqs) / run_s,
         run_s=run_s,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    bad = [i for i, r in enumerate(reqs)
           if r.status is not RequestStatus.FINISHED or len(r.tokens) != 32
           or not all(0 <= t < cfg.vocab_size for t in r.tokens)
           or not all(math.isfinite(x) for x in r.logprobs)]
    if bad:
        raise AssertionError(f"requests {bad} did not finish with 32 tokens")
    if not summary.get("prefix_hit_rate", 0.0) > 0:
        raise AssertionError("no prefix-cache hit on the shared prefix")
    if launches != steps * cfg.num_hidden_layers or launches == 0:
        raise AssertionError(f"paged_decode launched {launches} times for "
                             f"{steps} decode steps x 32 layers")
    for row in kernel_rows:
        row["launches"] = launches
    return cfg, params, eng


def _rel_l2(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def phase_kernel_vs_dense(cfg, params, eng):
    """From one pool state (8 slots at 265-1800 rows), one decode step
    through the kernel path and through the dense-gather path.

    Gated: the step with f32 activations (the bf16 weights and the bf16
    pool unchanged, upcast as they are read), so the distance measures
    the two attention paths. Reported: the same in bf16 activations,
    beside the kernel against its own plain version through the same
    forward — at this depth a bf16 step's rounding, amplified by 32
    random layers, dominates any two implementations' distance."""
    import numpy as np
    import torch

    import accelerate_tpu_torch.ops.paged_attention as paged
    from accelerate_tpu_torch.serving import SlotState

    rng = np.random.default_rng(1)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                       max_new_tokens=200)
            for n in (200, 400, 700, 900, 1100, 1300, 1500, 1800)]
    while not all(s.state is SlotState.DECODE for s in eng.scheduler.slots):
        eng.step()
    table = eng._upload(eng._table)
    kern, _, _ = eng._decode_forward(True, table)
    dense, _, _ = eng._decode_forward(False, table)
    launch = paged.paged_decode_attention
    try:
        paged.paged_decode_attention = paged.paged_decode_reference
        plain, _, _ = eng._decode_forward(True, table)
    finally:
        paged.paged_decode_attention = launch
    # f32 activations: an f32 embedding makes every later product f32
    eng.params = {**params, "embed_tokens": {
        "embedding": params["embed_tokens"]["embedding"].float()}}
    try:
        kern32, _, _ = eng._decode_forward(True, table)
        dense32, _, _ = eng._decode_forward(False, table)
    finally:
        eng.params = params
    rel = _rel_l2(kern32, dense32)
    finite = bool(torch.isfinite(kern32).all() and torch.isfinite(kern).all())
    emit("kernel_vs_dense", lengths=eng.cache.lengths.tolist(),
         logits_rel_l2=rel, tol=2e-2, activations="float32",
         bf16_logits_rel_l2=_rel_l2(kern, dense),
         bf16_kernel_vs_plain_rel_l2=_rel_l2(kern, plain),
         bf16_kernel_vs_plain_by_depth=_drift_by_depth(eng, cfg, table),
         greedy_agree_bf16=int((kern.argmax(-1) == dense.argmax(-1)).sum()),
         finite=finite)
    if not rel <= 2e-2 or not finite:
        raise AssertionError(f"kernel path logits off the dense path: {rel}")
    _decode_breakdown(eng, table)
    for r in reqs:
        eng.cancel(r)


def _drift_by_depth(eng, cfg, table):
    """bf16 logits distance, kernel against its plain version, when the
    step stops after the first L layers (the pool's first L layers are
    exactly an L-layer model's): how the rounding distance grows."""
    import dataclasses

    import accelerate_tpu_torch.ops.paged_attention as paged

    launch = paged.paged_decode_attention
    out = {}
    try:
        for depth in (d for d in (1, 2, 4, 8, 16)
                      if d < cfg.num_hidden_layers):
            eng.config = dataclasses.replace(cfg, num_hidden_layers=depth)
            kern, _, _ = eng._decode_forward(True, table)
            paged.paged_decode_attention = paged.paged_decode_reference
            plain, _, _ = eng._decode_forward(True, table)
            paged.paged_decode_attention = launch
            out[depth] = _rel_l2(kern, plain)
    finally:
        paged.paged_decode_attention = launch
        eng.config = cfg
    return out


def _decode_breakdown(eng, table):
    """Where one decode step's device time goes at this pool state: the
    whole forward through each path, and the kernel alone on layer 0's
    inputs (it runs once per layer)."""
    import accelerate_tpu_torch.ops.paged_attention as paged

    launch = paged.paged_decode_attention
    captured = []

    def capture(*args, **kw):
        if not captured:
            captured.append((args, kw))
        return launch(*args, **kw)

    capture.launches = 0  # the wrapper counts into whatever holds its name
    paged.paged_decode_attention = capture
    try:
        eng._decode_forward(True, table)
    finally:
        paged.paged_decode_attention = launch
    args, kw = captured[0]
    kern, _ = launch(*args, **kw)
    plain, _ = paged.paged_decode_reference(*args, **kw)
    emit("layer0_attention", rel_l2=_rel_l2(kern.float(), plain.float()),
         elements_differing=int((kern != plain).sum()),
         elements=kern.numel(),
         max_abs_err=float((kern.float() - plain.float()).abs().max()))
    lengths = eng.cache.lengths.tolist()
    G = args[0].shape[2] // args[1].shape[2]
    bound_ms, bound_by = _paged_bound(args[0], args[3], lengths,
                                      eng.cache.page_size, G)
    emit("decode_breakdown", lengths=lengths,
         forward_kernel_path_ms=cuda_time_ms(
             lambda: eng._decode_forward(True, table), iters=5, warmup=1),
         forward_dense_path_ms=cuda_time_ms(
             lambda: eng._decode_forward(False, table), iters=5, warmup=1),
         paged_decode_ms=cuda_time_ms(lambda: launch(*args, **kw), iters=50),
         paged_decode_bound_ms=bound_ms, bound_by=bound_by,
         layers=eng.cache.num_layers, profile=_profile_step(eng, table))


def _profile_step(eng, table):
    """Device time of one kernel-path decode forward by kernel class,
    from torch.profiler (ms), with the eight costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng._decode_forward(True, table)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._decode_forward(True, table)
        torch.cuda.synchronize()
    classes = {"paged_decode": 0.0, "gemm": 0.0, "other": 0.0}
    kernels = []
    for ev in prof.key_averages():
        if str(ev.device_type) != "DeviceType.CUDA":
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0))
        name = ev.key
        low = name.lower()
        cls = ("paged_decode" if "paged_decode" in low else
               "gemm" if any(t in low for t in ("gemm", "nvjet", "xmma",
                                                "cutlass", "splitk"))
               else "other")
        classes[cls] += us / 1e3
        kernels.append((us / 1e3, ev.count, name[:90]))
    kernels.sort(reverse=True)
    return {"device_ms_by_class": classes,
            "device_ms_total": sum(classes.values()),
            "top_kernels": kernels[:8]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    info = phase_device()
    phase_build()
    kernels = phase_paged_kernel()
    phase_small_parity()
    cfg, params, eng = phase_engine(kernels)
    phase_kernel_vs_dense(cfg, params, eng)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
