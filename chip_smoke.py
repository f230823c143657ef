#!/usr/bin/env python3
"""Drive the PyTorch port (`accelerate_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line; a failing phase raises and the
script exits non-zero:

1. device: the card's name, count, and nvidia-smi name + power limit;
2. build: every CUDA source of the port, one nvcc each, all at once,
   with each kernel's registers and spills (ptxas) and the wgmma flash
   kernels' shared memory; a kernel that spills fails the phase;
3. kernel checks: the paged-decode kernels (K2, split and combine) at
   the serving path's shapes, split boundaries, a window that drops
   whole splits and head dims 32 and 96, and the flash-attention kernels
   (K1a forward, K1b dQ, K1c dK/dV) at the training path's shapes and a
   matrix of masks, windows, lengths and head dims, each against its
   plain PyTorch version, with its time, its bound and a library
   yardstick;
4. engine: the serving engine at llama3-8B width and depth (random bf16
   weights from a seed), 12 requests through the paged-decode kernel;
5. parity: one decode step through the kernel path and the dense-gather
   path from the same pool state, logits compared;
6. train: the bf16 training step at llama3-8B width, 4 layers, remat
   "dots": 10 steps through the flash kernels, with the launch counts,
   step time, tokens/s, MFU, peak memory and a profiler split;
7. train_flash_vs_einsum: one step's loss and grads through the flash
   and einsum attention paths, 2 layers, f32 activations;
8. head_grad: the bf16 head's gradient at the slice's shapes against
   the exact products with the f32 cotangent, with its time.

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
    """Builds every CUDA source and reports, per kernel, what ptxas
    says of it (registers, spills) and the dynamic shared memory of the
    wgmma flash kernels. Fails if any kernel spills."""
    from accelerate_tpu_torch import csrc

    names = csrc.sources()
    t0 = time.perf_counter()
    csrc.build(names)
    wall = time.perf_counter() - t0
    smem = _flash_sm90_smem()
    spilled = []
    for name in names:
        info = csrc.build_info[name]
        kernels = _ptxas_kernels(info["log"])
        for kern in kernels:
            if kern["name"] in smem:
                kern["dynamic_smem_bytes"] = smem[kern["name"]]
            if kern["spill_stores"] or kern["spill_loads"]:
                spilled.append(kern["name"])
        warnings = [ln.strip() for ln in info["log"].splitlines()
                    if "warning" in ln.lower()]
        emit("build", source=f"accelerate_tpu_torch/csrc/{name}.cu",
             arch="sm_90a", seconds=info["seconds"], kernels=kernels,
             warnings=warnings)
    emit("build_all", sources=names, wall_seconds=wall)
    if spilled:
        raise AssertionError(f"ptxas spills registers in {spilled}")


def _ptxas_kernels(log: str) -> list:
    """One entry per kernel of `nvcc -Xptxas -v`'s output: its name
    (demangled by c++filt where the toolkit's host has it), registers,
    and spill stores and loads in bytes. An entry is only filled in when
    its build reports it (a cache hit reports nothing)."""
    import re

    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = {"name": m.group(1), "registers": None,
                   "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(k["name"] for k in out),
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [k["name"] for k in out]
    for kern, name in zip(out, names):
        # "void (anonymous namespace)::flash_dkv_kernel_sm90<128>(...)"
        name = name.replace("(anonymous namespace)::", "").split("(")[0]
        kern["name"] = name[5:] if name.startswith("void ") else name
    return out


def _flash_sm90_smem() -> dict:
    """Dynamic shared memory in bytes of each wgmma flash kernel
    instance, as its launcher requests it."""
    from accelerate_tpu_torch.csrc import load

    lib = load("flash_attention")
    return {f"{kernel}<{dp}>": lib.flash_sm90_smem(i, dp)
            for i, kernel in enumerate(("flash_fwd_kernel_sm90",
                                        "flash_dq_kernel_sm90",
                                        "flash_dkv_kernel_sm90"))
            for dp in (64, 128)}


# ---------------------------------------------------------------------------
# phase 3: paged decode kernel (K2) against its plain version
# ---------------------------------------------------------------------------


# lengths at the split kernel's corners (a split is 128 rows of 16-row
# pages): exactly one, two and three splits, one row either side of a
# boundary, a slot filling its table
SPLIT_LENGTHS = [0, 128, 256, 384, 129, 127, 1024, 2175]


def _paged_inputs(pool_dtype, S=8, Hkv=8, G=4, D=128, ps=16, P=136,
                  seed=0, lengths=None):
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
    lengths = lengths or [0, 1, 15, 16, 17, 1000, P * ps - 1, 600]
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
    """K2 against its plain version: the serving shapes in each pool
    dtype, with and without a window (300 rows leave the first 14 splits
    of the 2175-row slot empty), then lengths at split boundaries, a
    window of 129 that drops whole splits of every long slot, and head
    dims 32 and 96."""
    import torch

    from accelerate_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_reference)

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.int8: 2e-2}
    ps, G = 16, 4
    timing = None
    bf16 = torch.bfloat16
    cases = [("serving", dt, window, {})
             for dt in (torch.float32, bf16, torch.int8)
             for window in (None, 300)]
    cases += [("split_boundary", bf16, None, {"lengths": SPLIT_LENGTHS}),
              ("split_boundary", torch.float32, 128,
               {"lengths": SPLIT_LENGTHS}),
              ("window_drops_splits", bf16, 129, {}),
              ("head_dim_32", bf16, None, {"D": 32}),
              ("head_dim_96", bf16, 300, {"D": 96})]
    for case, pool_dtype, window, kw in cases:
        q, kn, vn, pk, pv, meta, lengths = _paged_inputs(pool_dtype, **kw)
        out, (kr, vr) = paged_decode_attention(q, kn, vn, pk, pv, meta,
                                               window=window)
        ref, (rk, rv) = paged_decode_reference(q, kn, vn, pk, pv, meta,
                                               window=window)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rows_equal = bool(torch.equal(kr, rk) and torch.equal(vr, rv))
        ok = err <= tol[pool_dtype] and rows_equal and bool(
            torch.isfinite(out.float()).all())
        emit("kernel_check", kernel="paged_decode", case=case,
             pool=str(pool_dtype).replace("torch.", ""), D=q.shape[-1],
             lengths=lengths, window=window, max_abs_err=err,
             tol=tol[pool_dtype], rows_identical=rows_equal, ok=ok)
        if not ok:
            raise AssertionError(
                f"paged_decode disagrees with its plain version: {case} "
                f"pool {pool_dtype} window {window} err {err}")
        if case == "serving" and pool_dtype == bf16 and window is None:
            timing = (q, kn, vn, pk, pv, meta, lengths, err)
    # timed at the engine's configuration: bf16 pool, no window
    q, kn, vn, pk, pv, meta, lengths, err = timing
    ms = cuda_time_ms(
        lambda: paged_decode_attention(q, kn, vn, pk, pv, meta), iters=200)
    # back to back, a call costs the larger of the wrapper's host time and
    # the kernels' device time: both are reported beside it
    device_ms = _device_ms(
        lambda: paged_decode_attention(q, kn, vn, pk, pv, meta),
        "paged_decode", calls=20)
    host_us = _host_us(
        lambda: paged_decode_attention(q, kn, vn, pk, pv, meta), calls=200)
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
           "library_ms": library_ms,
           "library_scope": "scaled_dot_product_attention over K/V "
                            "gathered from the pages beforehand",
           "device_ms": device_ms, "wrapper_host_us": host_us}
    emit("kernel_time", **row)
    return [row]


def _device_ms(fn, substring, calls):
    """Device time per call of the kernels whose names hold `substring`
    (every kernel, memset and copy that `fn` puts on the device for ""),
    from torch.profiler over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(ev, "self_device_time_total", 0.0))
             for ev in prof.key_averages()
             if str(ev.device_type) == "DeviceType.CUDA"
             and substring in ev.key)
    return us / calls / 1e3


def _host_us(fn, calls):
    """Host time per call, the device left to run behind."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


# ---------------------------------------------------------------------------
# phase 3b: flash-attention kernels (K1a, K1b, K1c) against their plain
# versions
# ---------------------------------------------------------------------------

BF16_FLOPS = 989e12         # H100 SXM bf16 dense tensor cores, data sheet

# (name, B, S, H, D, causal, key-mask kind, window); the first is the
# training slice's shape: q, k, v after repeat_kv at llama3-8B width
FLASH_CASES = [
    ("slice", 2, 2048, 32, 128, True, None, None),
    ("noncausal_1024", 1, 1024, 4, 128, False, None, None),
    ("key_mask", 2, 256, 4, 64, False, "row", None),
    ("window_512", 1, 2048, 4, 128, True, None, 512),
    ("irregular_1000", 1, 1000, 4, 128, True, None, None),
    ("s_12", 2, 12, 4, 64, True, None, None),
    ("head_dim_32", 1, 1000, 4, 32, True, None, None),
    ("head_dim_96", 2, 2048, 4, 96, True, "row", 300),
]


def _flash_inputs(B, S, H, D, mask_kind, dtype, seed):
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    mask = None
    if mask_kind == "row":
        # batch row 0 masks its first 40 keys; batch row 1 masks every key,
        # so all of its query rows see nothing
        mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        mask[0, :40] = 0
        mask[1] = 0
    return q, k, v, do, mask


def _flash_pairs(S, causal, window):
    """Visible (query, key) pairs of one head: the work that this data
    needs (the kernels skip dead tiles)."""
    if not causal:
        return S * S
    w = S if window is None else min(window, S)
    return sum(min(i + 1, w) for i in range(S))


def _flash_bounds(B, S, H, D, causal, window, elt):
    """Least time of K1a, K1b, K1c at these shapes: operations (4, 6, 8
    flops per visible pair and head dim: QK^T and PV; QK^T, dO V^T and
    dS K; QK^T, dO V^T, P^T dO and dS^T Q) over the bf16 peak, or the
    bytes each must move over HBM bandwidth, whichever is larger."""
    pairs = B * H * _flash_pairs(S, causal, window)
    tile = B * S * H * D * elt       # one [B, S, H, D] operand
    row = B * H * S * 4              # one [B, H, S] f32 vector
    work = {"flash_fwd": (4 * pairs * D, 4 * tile + row),
            "flash_bwd_dq": (6 * pairs * D, 6 * tile + 2 * row),
            "flash_bwd_dkv": (8 * pairs * D, 6 * tile + 2 * row)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_flash_kernel():
    """Each case in bf16 and f32: kernel outputs (o, lse) and gradients
    (dq, dk, dv, one random dO) against the plain versions run in f32 on
    the same inputs. Then the slice's shape is timed."""
    import torch

    from accelerate_tpu_torch.ops import flash_attention as fa

    torch.cuda.reset_peak_memory_stats()
    failures = []
    timing = None
    for ci, (name, B, S, H, D, causal, mk, window) in enumerate(FLASH_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do, mask = _flash_inputs(B, S, H, D, mk, dtype, ci)
            o, lse = fa.flash_forward(q, k, v, causal, mask, window,
                                      save_residuals=True)
            dq, dk, dv = fa.flash_backward(q, k, v, o, lse, do, causal,
                                           mask, window)
            ro, rlse = fa.flash_forward_reference(
                q.float(), k.float(), v.float(), causal, mask, window)
            rdq, rdk, rdv = fa.flash_backward_reference(
                q.float(), k.float(), v.float(), ro, rlse, do.float(),
                causal, mask, window)
            torch.cuda.synchronize()
            err = {"o": _max_abs(o, ro), "lse": _max_abs(lse, rlse)}
            for n, a, b in (("dq", dq, rdq), ("dk", dk, rdk),
                            ("dv", dv, rdv)):
                err[n] = _max_abs(a, b)
                err[n + "_rel_l2"] = _rel_l2(a.float(), b)
            if dtype == torch.float32:
                tol = {n: 1e-4 for n in ("o", "lse", "dq", "dk", "dv")}
            else:
                tol = {"o": 2e-2, "lse": 1e-3, "dq_rel_l2": 2e-2,
                       "dk_rel_l2": 2e-2, "dv_rel_l2": 2e-2}
            finite = all(bool(torch.isfinite(t.float()).all())
                         for t in (o, lse, dq, dk, dv))
            ok = finite and all(err[n] <= t for n, t in tol.items())
            emit("flash_check", case=name, dtype=str(dtype)[6:], B=B, S=S,
                 H=H, D=D, causal=causal, key_mask=mk, window=window,
                 err=err, tol=tol, finite=finite, ok=ok)
            if not ok:
                failures.append(f"{name}/{dtype}")
            if ci == 0 and dtype == torch.bfloat16:
                timing = (q, k, v, do, o, lse, err)
            del q, k, v, do, o, lse, dq, dk, dv, ro, rlse, rdq, rdk, rdv
    if failures:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions: {failures}")
    return _flash_times(*timing)


def _flash_times(q, k, v, do, o, lse, err):
    """Per-launch times of the three kernels at the slice's shape, their
    plain versions, and scaled_dot_product_attention as the yardstick
    (forward; backward alone), which the port never calls. The kernels
    are timed back to back with CUDA events (`ms`) and by the profiler
    (`device_ms`); SDPA's backward call by the profiler as the device
    time of every kernel it launches, whichever backend it picks
    (`library_ms`), with the CUDA-event time around the autograd call,
    host and autograd included, beside it."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    B, S, H, D = q.shape
    _, delta = fa.flash_backward_dq(q, k, v, o, lse, do, True)
    calls = {"flash_fwd": (lambda: fa.flash_forward(
                 q, k, v, True, save_residuals=True), "flash_fwd_kernel"),
             "flash_bwd_dq": (lambda: fa.flash_backward_dq(
                 q, k, v, o, lse, do, True), "flash_dq_kernel"),
             "flash_bwd_dkv": (lambda: fa.flash_backward_dkv(
                 q, k, v, do, lse, delta, True), "flash_dkv_kernel")}
    ms = {n: cuda_time_ms(fn, iters=20) for n, (fn, _) in calls.items()}
    device_ms = {n: _device_ms(fn, kernel, calls=10)
                 for n, (fn, kernel) in calls.items()}
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    plain_fwd = cuda_time_ms(
        lambda: fa.flash_forward_reference(qf, kf, vf, True), iters=3,
        warmup=1)
    plain_bwd = cuda_time_ms(
        lambda: fa.flash_backward_reference(qf, kf, vf, of, lse, dof, True),
        iters=3, warmup=1)
    del qf, kf, vf, of, dof
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa_fwd = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        iters=20)
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        def sdpa_backward():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        sdpa_bwd_host = cuda_time_ms(sdpa_backward, iters=20)
        sdpa_bwd = _device_ms(sdpa_backward, "", calls=10)
    del out
    bounds = _flash_bounds(B, S, H, D, True, None, q.element_size())
    bwd_pair_ms = ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]
    emit("flash_time", shape=[B, S, H, D], causal=True, dtype="bfloat16",
         ms=ms, device_ms=device_ms, bwd_pair_ms=bwd_pair_ms,
         plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
         sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_device_ms=sdpa_bwd,
         sdpa_bwd_host_clock_ms=sdpa_bwd_host,
         sdpa_fwd_bwd_ms=sdpa_fwd + sdpa_bwd,
         bounds={n: b[0] for n, b in bounds.items()},
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    replaces = {"flash_fwd": "accelerate_tpu/ops/flash_attention.py:87",
                "flash_bwd_dq": "accelerate_tpu/ops/flash_attention.py:204",
                "flash_bwd_dkv": "accelerate_tpu/ops/flash_attention.py:250"}
    errs = {"flash_fwd": err["o"], "flash_bwd_dq": err["dq"],
            "flash_bwd_dkv": max(err["dk"], err["dv"])}
    # the backward's plain version and its library call each compute dq,
    # dk and dv together, so K1b's and K1c's rows share them: they are to
    # be read against K1b + K1c, not against one kernel
    bwd_pair = "dq, dk and dv together (K1b + K1c)"
    scopes = {"flash_fwd": ("o and lse", "scaled_dot_product_attention "
                            "forward, is_causal"),
              "flash_bwd_dq": (bwd_pair, "scaled_dot_product_attention "
                               "backward: " + bwd_pair),
              "flash_bwd_dkv": (bwd_pair, "scaled_dot_product_attention "
                                "backward: " + bwd_pair)}
    rows = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        fwd = name == "flash_fwd"
        rows.append({
            "name": name, "route": "cuda",
            "source": "accelerate_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces[name], "launches": None,
            "max_abs_err": errs[name], "ms": ms[name],
            "plain_ms": plain_fwd if fwd else plain_bwd,
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": sdpa_fwd if fwd else sdpa_bwd,
            "plain_scope": scopes[name][0],
            "library_scope": scopes[name][1] + ("" if fwd else
                                                ", device time"),
            "device_ms": device_ms[name],
            "bwd_pair_ms": None if fwd else bwd_pair_ms,
            "library_host_clock_ms": None if fwd else sdpa_bwd_host,
            "library_fwd_bwd_ms": sdpa_fwd + sdpa_bwd})
    return rows


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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
            "kernel_launches": sum(n for _, n, _ in kernels),
            "top_kernels": kernels[:8]}


# ---------------------------------------------------------------------------
# phase 6: the bf16 training step at llama3-8B width
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4      # full width; 32 layers' f32 state would need 128 GB
TRAIN_STEPS = 10


def _train_config(layers, **kw):
    from accelerate_tpu_torch.models import llama

    return llama.LlamaConfig.llama3_8b(num_hidden_layers=layers, **kw)


def _train_batch(cfg):
    import numpy as np

    # labels shift by one, so attention runs at S = 2048
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2049)).astype(np.int32)


def phase_train(kernel_rows):
    """Accelerator(bf16, clip 1.0) + prepare(TrainState(adamw(3e-4))) +
    train_step(causal_lm_loss) at llama3-8B width with 4 layers, remat
    "dots": 1 warm-up step, then 10 steps on the same batch, timed with
    CUDA events. Under remat the attention forward reruns in backward, so
    K1a launches twice per layer and step, K1b and K1c once."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.common import count_params
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.optimizers import adamw, tree_leaves
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState

    cfg = _train_config(TRAIN_LAYERS, remat=True, remat_policy="dots")
    PartialState._reset_state()
    torch.cuda.reset_peak_memory_stats()
    acc = Accelerator(mixed_precision="bf16", gradient_clipping=1.0)
    state = acc.prepare(TrainState.create(
        apply_fn=None, params=llama.init_params(cfg, 0), tx=adamw(3e-4)))
    n_params = count_params(state.params)
    loader = acc.prepare([{"input_ids": _train_batch(cfg)}])
    (batch,) = list(loader)
    step = acc.train_step(lambda p, b: llama.causal_lm_loss(cfg, p, b))
    state, m = step(state, batch)                     # warm-up
    losses = [m["loss"]]
    # the main path's run: every count at 0 just before, read just after
    fa.flash_forward.launches = 0
    fa.flash_backward_dq.launches = 0
    fa.flash_backward_dkv.launches = 0
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TRAIN_STEPS + 1)]
    marks[0].record()
    for i in range(TRAIN_STEPS):
        state, m = step(state, batch)
        marks[i + 1].record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = {"flash_fwd": fa.flash_forward.launches,
                "flash_bwd_dq": fa.flash_backward_dq.launches,
                "flash_bwd_dkv": fa.flash_backward_dkv.launches}
    step_ms = [marks[i].elapsed_time(marks[i + 1])
               for i in range(TRAIN_STEPS)]
    losses = [float(x) for x in losses]
    med = float(np.median(step_ms))
    tokens = 2 * 2048
    tok_s = tokens / (med / 1e3)
    # bench.py's reckoning: 6 N + 12 L h s flops per token
    flops_per_token = 6 * n_params + 12 * cfg.num_hidden_layers * \
        cfg.hidden_size * 2048
    masters_f32 = all(t.dtype == torch.float32 for t in
                      tree_leaves(state.params))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split = _profile_train_step(step, state, batch)
    emit("train", config="llama3_8b", layers=cfg.num_hidden_layers,
         remat=cfg.remat_policy, params=n_params, batch=[2, 2049],
         mixed_precision="bf16", steps=TRAIN_STEPS, losses=losses,
         step_ms=step_ms, step_ms_median=med, tokens_per_s=tok_s,
         mfu=flops_per_token * tok_s / BF16_FLOPS,
         max_memory_allocated_gb=peak_gb, master_params_f32=masters_f32,
         launches=launches, profile=split)
    want = {"flash_fwd": 2 * TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dq": TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dkv": TRAIN_LAYERS * TRAIN_STEPS}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    if not masters_f32:
        raise AssertionError("master params left float32")
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected {want}")
    for row in kernel_rows:
        if row["name"] in launches:
            row["launches"] = launches[row["name"]]
    del state, step, loader, batch


def _profile_train_step(step, state, batch):
    """Device time of one training step by kernel class (ms), from
    torch.profiler, with the eight costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    classes = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
               "gemm": 0.0, "other": 0.0}
    kernels = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if str(ev.device_type) != "DeviceType.CUDA":
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0))
        low = ev.key.lower()
        cls = ("flash_fwd" if "flash_fwd_kernel" in low else
               "flash_bwd_dq" if "flash_dq_kernel" in low else
               "flash_bwd_dkv" if "flash_dkv_kernel" in low else
               "gemm" if any(t in low for t in ("gemm", "nvjet", "xmma",
                                                "cutlass", "splitk"))
               else "other")
        classes[cls] += us / 1e3
        kernels.append((us / 1e3, ev.count, ev.key[:90]))
    kernels.sort(reverse=True)
    return {"device_ms_by_class": classes,
            "device_ms_total": sum(classes.values()),
            "top_kernels": kernels[:8]}


# ---------------------------------------------------------------------------
# phase 7: flash against einsum through the whole step, f32 activations
# ---------------------------------------------------------------------------


def phase_train_flash_vs_einsum():
    """One step's loss and grads at llama3-8B width, 2 layers, with
    attention_backend "flash" and "einsum" from the same params and
    batch. Gated in f32 activations; the same in bf16 (params cast as
    the bf16 step casts them) is printed beside it."""
    import dataclasses

    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.optimizers import tree_leaves, tree_map
    from accelerate_tpu_torch.training import cast_floating

    cfg = _train_config(2)
    torch.cuda.reset_peak_memory_stats()
    params = llama.init_params(cfg, 1)
    ids = torch.from_numpy(_train_batch(cfg)).cuda()
    leaves = tree_leaves(params)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for backend in ("flash", "einsum"):
            c = dataclasses.replace(cfg, attention_backend=backend)
            masters = [p.detach().requires_grad_() for p in leaves]
            it = iter(masters)
            tree = tree_map(lambda _: next(it), params)
            with torch.enable_grad():
                loss = llama.causal_lm_loss(
                    c, cast_floating(tree, dtype), {"input_ids": ids})
                grads = torch.autograd.grad(loss, masters)
            out[(dtype, backend)] = (float(loss), grads)
            del masters, tree, loss
    res = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        lf, gf = out[(dtype, "flash")]
        le, ge = out[(dtype, "einsum")]
        res[name] = {"loss_flash": lf, "loss_einsum": le,
                     "loss_rel_err": abs(lf - le) / abs(le),
                     "grad_rel_l2_max": max(_rel_l2(a, b)
                                            for a, b in zip(gf, ge))}
    emit("train_flash_vs_einsum", layers=2, **res, loss_tol=1e-5,
         grad_tol=1e-3, gated="f32",
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    f32 = res["f32"]
    if not (f32["loss_rel_err"] <= 1e-5 and f32["grad_rel_l2_max"] <= 1e-3):
        raise AssertionError(f"flash step off the einsum step: {f32}")


def phase_head_grad():
    """The bf16 head's gradient (`llama._HeadF32`) at the slice's shapes:
    one loss chunk, 2 x 256 rows at hidden 4096 against the 128256-wide
    head. Its dx and dw against the exact products with the f32
    cotangent (f64 GEMMs) rounded once to bf16, the reference's rule,
    gated on the share of bit-equal elements. Beside it, the same for
    f32 GEMMs and for products against the cotangent rounded to bf16
    first, with the time of each variant."""
    import torch

    from accelerate_tpu_torch.models import llama

    n, h, v = 512, 4096, 128256
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, h), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((h, v), generator=gen, device="cuda") * 0.02).bfloat16()
    g = torch.randn((n, v), generator=gen, device="cuda") * 1e-6
    with torch.enable_grad():
        xg, wg = x.requires_grad_(), w.requires_grad_()
        out = llama._HeadF32.apply(xg, wg)

        def port():
            return torch.autograd.grad(out, (xg, wg), g, retain_graph=True)

        dx, dw = port()
        ms = cuda_time_ms(port, iters=10)
    x, w = x.detach(), w.detach()

    def f32_gemm():
        return (g @ w.float().t()).bfloat16(), (x.float().t() @ g).bfloat16()

    def rounded_cotangent():
        return g.bfloat16() @ w.t(), x.t() @ g.bfloat16()

    # the exact products, from f64 GEMMs, rounded once to bf16
    exact = ((g.double() @ w.double().t()).bfloat16(),
             (x.double().t() @ g.double()).bfloat16())
    res = {}
    for name, pair in (("port", (dx, dw)), ("f32_gemm", f32_gemm()),
                       ("rounded_cotangent", rounded_cotangent())):
        for d, a, b in zip(("dx", "dw"), pair, exact):
            res[f"{name}_{d}_equal"] = float((a == b).float().mean())
            res[f"{name}_{d}_rel_l2"] = _rel_l2(a.float(), b.float())
        del pair
    f32_ms = cuda_time_ms(f32_gemm, iters=3)
    rounded_ms = cuda_time_ms(rounded_cotangent, iters=10)
    # the tensor cores' f32 accumulation over dx's 128256-long
    # contraction tips about 5% of its roundings (an f32 GEMM's, about
    # 0.3%); rounding the cotangent first leaves about 57% equal
    tol = 0.9
    emit("head_grad", rows=n, hidden=h, vocab=v, **res, ms=ms,
         f32_gemm_ms=f32_ms, rounded_cotangent_ms=rounded_ms,
         equal_tol=tol)
    if not (res["port_dx_equal"] >= tol and res["port_dw_equal"] >= tol):
        raise AssertionError(f"head gradient off the exact products: {res}")


def _drop():
    """Free the device memory of a finished phase."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    info = phase_device()
    phase_build()
    kernels = phase_paged_kernel()
    kernels += phase_flash_kernel()
    phase_small_parity()
    cfg, params, eng = phase_engine(kernels[:1])
    phase_kernel_vs_dense(cfg, params, eng)
    del params, eng
    _drop()
    phase_train(kernels)
    _drop()
    phase_train_flash_vs_einsum()
    _drop()
    phase_head_grad()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
