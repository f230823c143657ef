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
   whole splits, head dims 8, 16, 32, 80, 96 and 256 with GQA groups 1,
   3 and 32 in bf16, f16 and int8 pools, and the flash-attention kernels
   (K1a forward, K1b dQ, K1c dK/dV) at the training path's shapes and a
   matrix of masks, windows, lengths and head dims 8 to 256 in bf16, f32
   and f16, each against its plain PyTorch version, with its time, its
   bound and a library yardstick (also at the new shapes);
3b. small_parity: the default engine (paged kernel "auto") on
   `LlamaConfig.tiny()` (head_dim 16) on the card against the CPU
   engine: greedy streams identical; zoo_small_parity: the same for the
   tiny GPT-2, GPT-J, GPT-NeoX and OPT;
4. engine: the serving engine at llama3-8B width and depth (random bf16
   weights from a seed), its programs captured as CUDA graphs, 12
   requests through the paged-decode kernel (launches counted through
   replays), then the same 12 with the programs eager: greedy streams
   identical, every program captured once;
5. parity: one decode step through the kernel path and the dense-gather
   path from the same pool state, logits compared; the eager forward's
   device time beside the captured decode step's;
5a. server: that engine behind the HTTP front door (`InferenceService`
   + `HttpFrontDoor` on 127.0.0.1): streamed and unary greedy
   completions equal to the engine driven directly, TTFT and decode
   tokens/s over HTTP beside engine-direct, an n=2 fan-out through
   `fork`, a `traceparent` whose id comes back as x-request-id with its
   spans recorded, /healthz and /metrics in both expositions, and a
   drain during which new work gets 503; K2's launches in the HTTP run;
5a'. serve_cli: `python -m accelerate_tpu_torch.commands.serve` with
   `--dry-run`, then serving for real on the card: one request over
   HTTP through K2, then SIGTERM: it drains and exits 0; for `--family
   llama` and `--family gpt2`;
5a''. telemetry: phase engine's llama3-8B engine and 12 requests with
   the exporter on, a 5 s stall watchdog, device-time sampling at every
   call and an incident directory: greedy streams equal phase engine's,
   captures flat, K2's launches through replays, the reference's
   roofline and goodput keys on the H100's peaks, the sampled decode
   time against the profiled forward, both expositions of /metrics;
   then the engine left unstepped: the watchdog fires, /healthz 503,
   the bundle's files, `python -m accelerate_tpu_torch.commands.incident
   list/show` on it, no thread left after close();
5b. speculative: a 2-layer draft, draft_k 4: greedy streams equal to
   the plain engine's in f32 at 4 layers, then the bf16 32-layer engine
   with its accept rate and the draft and verify programs' times;
5c. host_tier: a pool too small for the traffic swaps a 512-token
   prefix out to host memory and back in, bf16 and int8 pools, streams
   equal to an ample pool's;
5c1. pod: `PodRouter` with a prefill and a decode worker sharing phase
   engine's params (llama3-8B, bf16, graphs, `paged_attention=True`):
   its 12 requests, streams equal phase engine's (greedy and sampled),
   K2's launches = the decode worker's steps x 32 through replays, the
   shipment extract/install captured once, 12 shipments whose host
   bytes are their `page_bytes`; TTFT, the decode step and one
   shipment's extract, copy to the host and install times;
5c2. pod_distributed: the same over `build_local_distributed_pod`
   (every message through the wire codec, shipments as bf16 words),
   streams equal phase engine's; then a decode worker killed mid-run
   (f32, 4 layers): every flight recovers with a single engine's tokens;
5c3. pod_cli: `python -m accelerate_tpu_torch.commands.pod pod-router`
   spawning a `pod-worker` per role on the card (tiny llama spec): 4
   completions over HTTP equal to the single engine's, the workers'
   merged K2 decode steps on /metrics, SIGTERM: every process exits 0;
5c4. pod_tp: tensor-parallel serving through the launcher
   (`serve_llama_tp.py`, two processes on the one card over gloo, each
   building its weights from the seed): (a) f32, llama3-8B width, 2
   layers: phase engine's 12 requests through `sharded_engine` and
   through `PodRouter(PodConfig(tensor_parallel=2))` give, on both
   ranks, the streams of a one-process f32 engine; (b) bf16, llama3-8B
   width at 16 layers: both ranks' streams identical, each rank's parameter
   bytes 0.49-0.52 of the whole (only the norms replicate), its KV pool
   half of one process's (8 KV heads over 2), no paged-decode launch (a
   meshed engine decodes on the dense path), each prompt's logits within
   0.1 relative L2 of one process's; the decode step, the prefill chunk
   and the collectives a step makes, reported as two ranks sharing one
   card through the host, not as tensor-parallel speed;
5c5. pipeline: pipeline-parallel and sharded inference through the
   launcher (`infer_llama_pp.py`, two processes on the one card over
   gloo, each building its weights from the seed): (a) f32, llama3-8B
   width, 4 layers, einsum attention, 4 prompts of 2048 tokens through
   `prepare_pipeline` (embedding `pre_fn`, norm and head `post_fn`) on a
   `stage` axis of 2 with 2 and 4 chunks, `prepare_sharded_inference`
   on a `model` axis of 2 and `dispatch_model(..., "sharded")`: every
   result's logits within PP_A_REL_L2 of process 0's one-process forward
   and the same on both ranks, each rank's parameter bytes 0.49-0.52 of
   the whole under `dispatch_model`; (b) bf16, llama3-8B width at 16
   layers, 8 a stage, 2 prompts, 2 chunks: both ranks' logits
   identical, each prompt's within 0.1 relative L2 of one process's, 16
   K1a launches a rank, a rank's layer bytes half of the whole, the
   handoffs, their bytes and times and each rank's peak memory; (c)
   `pipeline_value_and_grad(schedule="1f1b")` at llama3-8B width, bf16,
   2 stages of 2 layers, 4 micro-batches of [1, 2048] hidden states, an
   MSE loss: loss and each stage's gradients against one process's
   autograd, K1a/K1b/K1c 16/8/8 a rank, the saved inputs within the
   1F1B bound; then K1a/b/c at the path's shape against their plain
   versions, timed; all times as two ranks sharing one card through the
   host, not as pipeline speed;
5c6. context_parallel: sequence and expert parallelism through the
   launcher (`context_parallel_llama.py`, two processes on the one card
   over gloo, `Accelerator(context_parallel_plugin=...)`, each building
   its weights from the seed): llama3-8B width, 2 layers, bf16, one row
   of 4096 tokens, `causal_lm_loss` and its gradients through
   `torch.autograd` with (a) the ring, (b) the ring with the last 512
   keys padded, (c) Ulysses, each against one process's flash; K1a/K1b/
   K1c launches of a call L(r+1) on rank r for the ring, L a rank for
   Ulysses; the ring alone through the kernels against their plain
   versions; (d) one Mixtral-width MoE block through the token-sharded
   a2a dispatch on an `expert` axis of 2 against one process's sort
   dispatch; then K1a/b/c at each of the phase's shapes (the ring's
   off-diagonal chunk, non-causal, and diagonal chunk, causal; Ulysses'
   [1, 4096, 16, 128], causal) against their plain versions, timed;
   every time as two ranks sharing one card through the host;
5d. gptj_engine: GPT-J-6B at full width and depth (random bf16 weights
   from a seed) served like phase engine's 12 requests through K2 at
   head dim 256 with no GQA, graphs against eager, K2's launches through
   replays, a 4-layer kernel-against-dense step in f32 activations, and
   K2 at these shapes against its plain version, timed;
6. train: the bf16 training step at llama3-8B width, 4 layers, remat
   "dots": 10 steps through the flash kernels, with the launch counts,
   step time, tokens/s, MFU, peak memory and a profiler split;
6'. eager_train: the reference's eager loop (prepare of params, an
   optimizer and a schedule; accumulate, compute_gradients, backward,
   clip_grad_norm_, the optimizer's and the scheduler's step, zero_grad)
   on phase train's config, init and batch: its 11 losses equal to phase
   train's bit for bit, the same flash launches, its step time, tokens/s,
   MFU and peak memory beside phase train's, each call's device time;
   4 micro-steps at gradient_accumulation_steps=2 (2 layers) through
   the eager loop and the fused step: losses and params equal;
6''. data_train: phase train's step fed by the input pipeline as a user
   builds it: a token file written from a seed, the native
   `TokenCorpusLoader` (built with g++ here), an Accelerator with
   `dataloader_config` (host prep 2 ahead, 2 copies in flight on a side
   stream), `rng_types` and the JSONL tracker; 11 steps under a
   `StepTimer`: losses equal, bit for bit, to the same step on the numpy
   fallback's batches copied synchronously, the flash launches, the batch
   copy on a side stream (a profiled step), the tracker file, the input
   stall per step, and the stall behind a source that sleeps 100 ms a
   batch;
6t. telemetry_train: phase train's step with `cost_sample_every=1`,
   `stall_timeout_s=60` and `metrics_port=0`: its 11 losses equal phase
   train's bit for bit, the flash launches, the cost table's analytic
   FLOPs equal to bench.py's reckoning and its MFU within 10% of phase
   train's, `program_mfu` on the exporter;
6a. fp8_train: the same step with mixed_precision="fp8": every layer
   projection through `_scaled_mm`, the flash kernels, its launch
   counts, step time, tokens/s, MFU, peak memory and a profiler split
   beside phase train's; losses within a stated tolerance of phase
   train's, the delayed scales moved and the windows filled; the
   `_scaled_mm` products at the flagship shapes against their plain
   version; a tiny fp8 step against the same step with the plain
   products on the card;
6b. resilient: that step at 2 layers through `run_resilient` with
   async saves every 3 steps (`keep_last_n=1`), a crash at step 5 and
   SIGTERM at step 6, then a relaunch: every loss equal to an unfaulted
   run's, bit for bit; the checkpoint's bytes, the stage, write, drain
   and resume times, and goodput beside the same schedule with blocking
   saves;
7. train_flash_vs_einsum: one step's loss and grads through the flash
   and einsum attention paths, 2 layers, f32 activations;
8. head_grad: the bf16 head's gradient at the slice's shapes against
   the exact products with the f32 cotangent, with its time;
9. mixtral_train: Mixtral-8x7B's width at 2 layers, bf16, remat,
   trained through the flash kernels with the dense and then the sparse
   (sort) expert dispatch: launch counts, step time, tokens/s, MFU over
   the active parameters, peak memory and losses; a tiny Mixtral step
   on the card against the CPU; sparse at full capacity against dense
   in f32; K1a/b/c at this path's shape against their plain versions,
   timed;
9b. dp_train: data parallelism through the launcher
   (`python -m accelerate_tpu_torch.commands.launch --num_processes 2`):
   two processes on the one card (gloo), each training llama3-8B width
   at 2 layers through K1a/b/c on its half of phase train's batch, the
   gradients averaged across them; then one process on the whole batch.
   Gates: bit-identical replicas, step 1's update (a strided sample)
   and the losses of steps 1-3 (all it takes) against the one
   process's within stated tolerances, 12/6/6 flash launches a rank;
   step times, the all-reduce's CUDA-event time and each rank's peak
   memory;
9c. zero_train: ZeRO-2 through the launcher (`--zero_stage 2`, the mesh
   `{fsdp: 2}`): the same two processes and batch with params whole and
   the AdamW moments each rank's block; gates against dp_train's one
   process as there, each rank's moment bytes half of whole moments',
   12/6/6 flash launches a rank; each rank's memory after `prepare` and
   at its peak beside dp_train's, the reduce-scatter and all-gather
   alone;
10. big_model: llama3-8B at full width and depth (bf16, random weights
   from a seed) written as a sharded safetensors checkpoint, planned
   for an 8 GiB card and 6 GiB of host memory, loaded onto the card,
   pinned host memory and disk, and decoded with the layers streamed
   to the card: tokens identical to the resident `generate`, the
   streamed forward at 2048 tokens (K1a once a layer) against the
   resident one, int8 and int4 quantized loading, an out-of-memory
   recovery, and every family's tiny streamed decode (see
   `phase_big_model`).

Every line carries `wall_s`, the seconds since its phase began, and the
line `phase_walls` before the kernel table holds each phase's wall
seconds and the script's total.

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


# the phase running now (`_run`) and each finished phase's wall seconds
_PHASE = {"name": None, "t0": None}
_WALLS: dict = {}


def emit(phase: str, **fields) -> None:
    """One JSON line; `wall_s` is the seconds since the running phase
    began, so a phase's last line carries its wall time."""
    if _PHASE["t0"] is not None:
        fields["wall_s"] = time.perf_counter() - _PHASE["t0"]
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _run(fn, *args):
    """Run a phase function, recording its wall seconds in `_WALLS`."""
    _PHASE["name"], _PHASE["t0"] = fn.__name__[len("phase_"):], \
        time.perf_counter()
    try:
        return fn(*args)
    finally:
        _WALLS[_PHASE["name"]] = time.perf_counter() - _PHASE["t0"]
        _PHASE["t0"] = None


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
    # activations in the pool's dtype (bf16 beside an int8 pool)
    q_dtype = pool_dtype if pool_dtype.is_floating_point else torch.bfloat16
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
    window of 129 that drops whole splits of every long slot, head dims
    32 and 96, and head dims 8, 16, 80 and 256 with groups 1, 3 and 32
    (two tiles of 16) in bf16 and f16 pools and activations, and int8
    pools at head dim 8 (8-byte rows). Timed at the serving shape, and
    at head dims 16 and 256 with a group of 32."""
    import torch

    from accelerate_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_reference)

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.int8: 2e-2,
           torch.float16: 4e-3}
    ps = 16
    timing = None
    shapes = {}
    bf16, f16 = torch.bfloat16, torch.float16
    cases = [("serving", dt, window, {})
             for dt in (torch.float32, bf16, torch.int8)
             for window in (None, 300)]
    cases += [("split_boundary", bf16, None, {"lengths": SPLIT_LENGTHS}),
              ("split_boundary", torch.float32, 128,
               {"lengths": SPLIT_LENGTHS}),
              ("window_drops_splits", bf16, 129, {}),
              ("head_dim_32", bf16, None, {"D": 32}),
              ("head_dim_96", bf16, 300, {"D": 96})]
    cases += [(f"D{D}_G{g}", dt, 300 if g == 3 else None,
               {"D": D, "G": g, "Hkv": 2})
              for D in (8, 16, 80, 256) for g in (1, 3, 32)
              for dt in (bf16, f16)]
    cases += [(f"D8_G{g}", torch.int8, None, {"D": 8, "G": g, "Hkv": 2})
              for g in (1, 3, 32)]
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
             G=q.shape[2] // kn.shape[2], q_dtype=str(q.dtype)[6:],
             lengths=lengths, window=window, max_abs_err=err,
             tol=tol[pool_dtype], rows_identical=rows_equal, ok=ok)
        if not ok:
            raise AssertionError(
                f"paged_decode disagrees with its plain version: {case} "
                f"pool {pool_dtype} window {window} err {err}")
        if case == "serving" and pool_dtype == bf16 and window is None:
            timing = (q, kn, vn, pk, pv, meta, lengths, err)
        if case in ("D16_G32", "D256_G32") and pool_dtype == bf16:
            shapes[case] = (q, kn, vn, pk, pv, meta, lengths, err)
    # timed at the engine's configuration: bf16 pool, no window
    q, kn, vn, pk, pv, meta, lengths, err = timing
    row = {"name": "paged_decode", "route": "cuda",
           "source": "accelerate_tpu_torch/csrc/paged_decode.cu",
           "replaces": "accelerate_tpu/ops/paged_attention.py:157",
           "launches": None, "max_abs_err": err,
           **_paged_times(q, kn, vn, pk, pv, meta, lengths),
           "library_scope": "scaled_dot_product_attention over K/V "
                            "gathered from the pages beforehand"}
    emit("kernel_time", **row)
    for case, (q, kn, vn, pk, pv, meta, lengths, err) in shapes.items():
        g = q.shape[2] // kn.shape[2]
        emit("kernel_time_shape", name="paged_decode", case=case,
             shape={"S": q.shape[0], "Hkv": kn.shape[2], "G": g,
                    "D": q.shape[-1], "page_size": ps, "pool": "bfloat16"},
             max_abs_err=err,
             **_paged_times(q, kn, vn, pk, pv, meta, lengths))
    return [row]


def _paged_times(q, kn, vn, pk, pv, meta, lengths) -> dict:
    """K2 on these inputs: back to back (`ms`: the larger of the
    wrapper's host time and the kernels' device time, both reported
    beside it), its plain version, SDPA over the K/V gathered
    beforehand (never called by the port), and its bound."""
    from accelerate_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_reference)

    def call():
        return paged_decode_attention(q, kn, vn, pk, pv, meta)

    bound_ms, bound_by = _paged_bound(q, pk, lengths, pk.data.shape[1],
                                      q.shape[2] // kn.shape[2])
    return {"ms": cuda_time_ms(call, iters=200),
            "device_ms": _device_ms(call, "paged_decode", calls=20),
            "wrapper_host_us": _host_us(call, calls=200),
            "plain_ms": cuda_time_ms(lambda: paged_decode_reference(
                q, kn, vn, pk, pv, meta), iters=20),
            "library_ms": cuda_time_ms(_sdpa_yardstick(
                q, kn, vn, pk, pv, meta, lengths), iters=200),
            "bound_ms": bound_ms, "bound_by": bound_by}


def _device_ms(fn, substring, calls, tries=3):
    """Device time per call of the kernels whose names hold `substring`
    (every kernel, memset and copy that `fn` puts on the device for ""),
    from torch.profiler over `calls` calls. A capture that records none
    of them (late in a long run the profiler has been seen to drop a
    capture's device events) is taken again; None when `tries` captures
    recorded nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(float(getattr(ev, "self_device_time_total", 0.0))
                 for ev in prof.key_averages()
                 if str(ev.device_type) == "DeviceType.CUDA"
                 and substring in ev.key)
        if us > 0:
            return us / calls / 1e3
    return None


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
    ("head_dim_8", 1, 1000, 4, 8, True, None, None),
    ("head_dim_80", 2, 1024, 4, 80, True, "row", 300),
    ("head_dim_256", 1, 1024, 4, 256, True, None, None),
    ("head_dim_256_noncausal", 2, 300, 2, 256, False, "row", None),
]

# the flash checks' tolerances against the plain version in f32: f32 in
# another summation order; bf16 and f16 with one rounding of o and of P
# and dS before their products
FLASH_TOL = {
    "float32": {n: 1e-4 for n in ("o", "lse", "dq", "dk", "dv")},
    "bfloat16": {"o": 2e-2, "lse": 1e-3, "dq_rel_l2": 2e-2,
                 "dk_rel_l2": 2e-2, "dv_rel_l2": 2e-2},
    "float16": {"o": 5e-3, "lse": 1e-3, "dq_rel_l2": 5e-3,
                "dk_rel_l2": 5e-3, "dv_rel_l2": 5e-3},
}


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
    """Each case in bf16, f32 and f16: kernel outputs (o, lse) and
    gradients (dq, dk, dv, one random dO) against the plain versions run
    in f32 on the same inputs. Then the slice's shape is timed, and head
    dim 256 in bf16 and head dim 128 in f16 (the CUDA-core kernels)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    failures = []
    timing = None
    for ci, (name, B, S, H, D, causal, mk, window) in enumerate(FLASH_CASES):
        for dtype in (torch.bfloat16, torch.float32, torch.float16):
            q, k, v, do, mask = _flash_inputs(B, S, H, D, mk, dtype, ci)
            o, lse, err, finite = _flash_errors(q, k, v, do, causal, mask,
                                                window)
            tol = FLASH_TOL[str(dtype)[6:]]
            ok = finite and all(err[n] <= t for n, t in tol.items())
            emit("flash_check", case=name, dtype=str(dtype)[6:], B=B, S=S,
                 H=H, D=D, causal=causal, key_mask=mk, window=window,
                 err=err, tol=tol, finite=finite, ok=ok)
            if not ok:
                failures.append(f"{name}/{dtype}")
            if ci == 0 and dtype == torch.bfloat16:
                timing = (q, k, v, do, o, lse, err)
            del q, k, v, do, o, lse
    if failures:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions: {failures}")
    rows = _flash_times(*timing)
    for B, S, H, D, dtype in ((1, 2048, 8, 256, torch.bfloat16),
                              (1, 2048, 8, 128, torch.float16)):
        _flash_shape_times(B, S, H, D, dtype)
    return rows


def _flash_errors(q, k, v, do, causal, mask=None, window=None):
    """K1a/b/c's outputs (o, lse) and gradients (dq, dk, dv, from `do`)
    against the plain versions in f32 on the same inputs: (o, lse, the
    errors by name, whether every output is finite)."""
    import torch

    from accelerate_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_forward(q, k, v, causal, mask, window,
                              save_residuals=True)
    dq, dk, dv = fa.flash_backward(q, k, v, o, lse, do, causal, mask,
                                   window)
    ro, rlse = fa.flash_forward_reference(q.float(), k.float(), v.float(),
                                          causal, mask, window)
    rdq, rdk, rdv = fa.flash_backward_reference(
        q.float(), k.float(), v.float(), ro, rlse, do.float(), causal, mask,
        window)
    torch.cuda.synchronize()
    err = {"o": _max_abs(o, ro), "lse": _max_abs(lse, rlse)}
    for n, a, b in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        err[n] = _max_abs(a, b)
        err[n + "_rel_l2"] = _rel_l2(a.float(), b)
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (o, lse, dq, dk, dv))
    return o, lse, err, finite


def _flash_shape_times(B, S, H, D, dtype):
    """K1a, K1b and K1c at one causal shape off the wgmma instances (the
    CUDA-core kernels), beside their plain versions, their bounds and
    scaled_dot_product_attention (forward; backward by device time)."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    q, k, v, do, _ = _flash_inputs(B, S, H, D, None, dtype, 99)
    o, lse = fa.flash_forward(q, k, v, True, save_residuals=True)
    _, delta = fa.flash_backward_dq(q, k, v, o, lse, do, True)
    ms = {"flash_fwd": cuda_time_ms(lambda: fa.flash_forward(
              q, k, v, True, save_residuals=True), iters=5, warmup=1),
          "flash_bwd_dq": cuda_time_ms(lambda: fa.flash_backward_dq(
              q, k, v, o, lse, do, True), iters=5, warmup=1),
          "flash_bwd_dkv": cuda_time_ms(lambda: fa.flash_backward_dkv(
              q, k, v, do, lse, delta, True), iters=5, warmup=1)}
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
    sdpa_fwd = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        iters=20)
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        sdpa_bwd = _device_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), "",
            calls=5)
    bounds = _flash_bounds(B, S, H, D, True, None, q.element_size())
    emit("flash_time_shape", shape=[B, S, H, D], causal=True,
         dtype=str(dtype)[6:], ms=ms,
         bwd_pair_ms=ms["flash_bwd_dq"] + ms["flash_bwd_dkv"],
         plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
         sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_device_ms=sdpa_bwd,
         bounds={n: b[0] for n, b in bounds.items()},
         bound_by={n: b[1] for n, b in bounds.items()})


def _flash_times(q, k, v, do, o, lse, err, causal=True):
    """Per-launch times of the three kernels at the slice's shape, their
    plain versions, and scaled_dot_product_attention as the yardstick
    (forward; backward alone), which the port never calls. The kernels
    are timed back to back with CUDA events (`ms`) and by the profiler
    (`device_ms`); SDPA's backward call with CUDA events around the
    autograd call (`library_ms`), with the profiler's device time of
    every kernel it launches beside it (`library_device_ms`: late in a
    long run the profiler has been seen to drop some of a capture's
    device events, so it is not the row's number)."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    B, S, H, D = q.shape
    _, delta = fa.flash_backward_dq(q, k, v, o, lse, do, causal)
    calls = {"flash_fwd": (lambda: fa.flash_forward(
                 q, k, v, causal, save_residuals=True), "flash_fwd_kernel"),
             "flash_bwd_dq": (lambda: fa.flash_backward_dq(
                 q, k, v, o, lse, do, causal), "flash_dq_kernel"),
             "flash_bwd_dkv": (lambda: fa.flash_backward_dkv(
                 q, k, v, do, lse, delta, causal), "flash_dkv_kernel")}
    ms = {n: cuda_time_ms(fn, iters=20) for n, (fn, _) in calls.items()}
    device_ms = {n: _device_ms(fn, kernel, calls=10)
                 for n, (fn, kernel) in calls.items()}
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    plain_fwd = cuda_time_ms(
        lambda: fa.flash_forward_reference(qf, kf, vf, causal), iters=3,
        warmup=1)
    plain_bwd = cuda_time_ms(
        lambda: fa.flash_backward_reference(qf, kf, vf, of, lse, dof,
                                            causal),
        iters=3, warmup=1)
    del qf, kf, vf, of, dof
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa_fwd = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                               is_causal=causal),
        iters=20)
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        def sdpa_backward():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        sdpa_bwd_host = cuda_time_ms(sdpa_backward, iters=20)
        sdpa_bwd = _device_ms(sdpa_backward, "", calls=10)
    del out
    bounds = _flash_bounds(B, S, H, D, causal, None, q.element_size())
    bwd_pair_ms = ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]
    emit("flash_time", shape=[B, S, H, D], causal=causal, dtype="bfloat16",
         ms=ms, device_ms=device_ms, bwd_pair_ms=bwd_pair_ms,
         plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
         sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_device_ms=sdpa_bwd,
         sdpa_bwd_host_clock_ms=sdpa_bwd_host,
         sdpa_fwd_bwd_ms=sdpa_fwd + sdpa_bwd_host,
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
                            "forward" + (", is_causal" if causal else "")),
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
            "library_ms": sdpa_fwd if fwd else sdpa_bwd_host,
            "plain_scope": scopes[name][0],
            "library_scope": scopes[name][1] + ("" if fwd else
                                                ", CUDA events around "
                                                "the call"),
            "device_ms": device_ms[name],
            "bwd_pair_ms": None if fwd else bwd_pair_ms,
            "library_device_ms": None if fwd else sdpa_bwd,
            "library_fwd_bwd_ms": sdpa_fwd + sdpa_bwd_host})
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
    """Greedy streams of `LlamaConfig.tiny()` (head_dim 16, f32) under the
    default engine config: on the card "auto" runs the paged kernel, on
    the CPU the dense-gather path; the streams must be identical."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_to_numpy, \
        params_from_numpy
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    from accelerate_tpu_torch.ops.paged_attention import \
        paged_decode_attention

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, 0, device="cuda")
    cpu_params = params_from_numpy(params_to_numpy(params), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 13, 9, 40, 21)]
    temps, keys = [0.0] * len(prompts), list(range(len(prompts)))
    kw = dict(num_slots=3, max_len=96, prefill_chunk=8, page_size=16,
              cache_dtype=torch.float32)
    before = paged_decode_attention.launches
    card = _serve(Engine(llama, cfg, params, EngineConfig(**kw)), prompts,
                  temps, 8, keys)
    launches = paged_decode_attention.launches - before
    host = _serve(Engine(llama, cfg, cpu_params, EngineConfig(**kw),
                         device="cpu"), prompts, temps, 8, keys)
    same = [a.tokens for a in card] == [b.tokens for b in host]
    lp_err = max(abs(x - y) for a, b in zip(card, host)
                 for x, y in zip(a.logprobs, b.logprobs))
    emit("small_parity", head_dim=cfg.head_dim, paged_attention="auto",
         paged_decode_launches=launches, tokens_identical=same,
         logprob_max_abs_err=lp_err)
    if not same or lp_err > 1e-3 or launches == 0:
        raise AssertionError("card engine disagrees with the CPU engine, "
                             f"or ran no paged kernel ({launches})")


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


ENGINE_CONFIG = dict(num_slots=8, max_len=2048, prefill_chunk=128,
                     page_size=16)


def _drive(eng, prompts, temps, max_new=32):
    """Submit every request, then step the engine to idle with a
    synchronise around each step: (requests, decode step seconds,
    prefill step seconds, run seconds)."""
    import torch

    t_run = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=max_new, temperature=t, key=1000 + i)
            for i, (p, t) in enumerate(zip(prompts, temps))]
    decode_s, prefill_s = [], []
    while True:
        steps = eng.metrics.decode_steps
        torch.cuda.synchronize()
        t = time.perf_counter()
        if not eng.step():
            break
        torch.cuda.synchronize()
        (decode_s if eng.metrics.decode_steps > steps
         else prefill_s).append(time.perf_counter() - t)
    return reqs, decode_s, prefill_s, time.perf_counter() - t_run


def _finished(reqs, vocab, max_new=32) -> list:
    """Indices of requests that did not finish with `max_new` valid
    tokens and finite logprobs."""
    from accelerate_tpu_torch.serving import RequestStatus

    return [i for i, r in enumerate(reqs)
            if r.status is not RequestStatus.FINISHED
            or len(r.tokens) != max_new
            or not all(0 <= t < vocab for t in r.tokens)
            or not all(math.isfinite(x) for x in r.logprobs)]


def phase_engine(kernel_rows):
    """The serving engine at llama3-8B width and depth with its programs
    captured as CUDA graphs: 12 requests through the paged-decode kernel,
    then the same 12 on an engine whose programs stay eager. Gated:
    every request finishes, a prefix hit, the kernel's launches equal
    decode steps x layers (counted through replays), every program
    captured once, and greedy streams identical between the two runs
    (the same kernels see the same data)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import \
        paged_decode_attention
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, 0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ec = EngineConfig(cache_dtype=torch.bfloat16, paged_attention=True,
                      **ENGINE_CONFIG)
    eng = Engine(llama, cfg, params, ec)
    prompts = _prompts(np.random.default_rng(0), cfg.vocab_size)
    temps = [0.0 if i % 2 == 0 else 0.8 for i in range(12)]
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: every count at 0 just before, read just after
    paged_decode_attention.launches = 0
    reqs, decode_s, prefill_s, run_s = _drive(eng, prompts, temps)
    launches = paged_decode_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = eng.metrics_summary()
    steps = eng.metrics.decode_steps
    stats = eng.compile_stats()
    eager = Engine(llama, cfg, params, ec, _graphs=False)
    ereqs, edecode_s, eprefill_s, erun_s = _drive(eager, prompts, temps)
    prefill_profile = _profile_prefill(eager, cfg.vocab_size)
    del eager
    greedy = [i for i, t in enumerate(temps) if t == 0.0]
    greedy_same = all(reqs[i].tokens == ereqs[i].tokens for i in greedy)
    all_same = all(a.tokens == b.tokens for a, b in zip(reqs, ereqs))
    lp_diff = max(abs(x - y) for a, b in zip(reqs, ereqs)
                  for x, y in zip(a.logprobs, b.logprobs))
    decode_tokens = sum(len(r.tokens) for r in reqs) - len(reqs)
    emit("engine", config="llama3_8b", layers=cfg.num_hidden_layers,
         graphs=True, params_init_s=init_s, requests=len(reqs),
         prompt_tokens=int(sum(len(p) for p in prompts)),
         finished=len(reqs) - len(_finished(reqs, cfg.vocab_size)),
         tokens=[len(r.tokens) for r in reqs], decode_steps=steps,
         paged_decode_launches=launches, compile_stats=stats,
         capture_s=eng._graphs.capture_seconds(),
         prefill_chunks=summary["prefill_chunks"],
         prefix_hit_rate=summary.get("prefix_hit_rate"),
         ttft_p50_ms=summary.get("ttft_p50_ms"),
         ttft_p99_ms=summary.get("ttft_p99_ms"),
         decode_step_ms_median=float(np.median(decode_s)) * 1e3,
         decode_step_ms_mean=float(np.mean(decode_s)) * 1e3,
         first_decode_step_ms=decode_s[0] * 1e3,
         prefill_chunk_ms_median=float(np.median(prefill_s)) * 1e3,
         decode_tokens_per_s=decode_tokens / sum(decode_s),
         tokens_per_s=sum(len(r.tokens) for r in reqs) / run_s,
         run_s=run_s,
         eager_decode_step_ms_median=float(np.median(edecode_s)) * 1e3,
         eager_prefill_chunk_ms_median=float(np.median(eprefill_s)) * 1e3,
         eager_decode_tokens_per_s=decode_tokens / sum(edecode_s),
         eager_run_s=erun_s,
         prefill_profile=prefill_profile,
         greedy_streams_identical=greedy_same,
         all_streams_identical=all_same,
         logprob_max_abs_diff=lp_diff,
         max_memory_allocated_gb=peak_gb)
    bad = _finished(reqs, cfg.vocab_size) + _finished(ereqs, cfg.vocab_size)
    if bad:
        raise AssertionError(f"requests {bad} did not finish with 32 tokens")
    if not summary.get("prefix_hit_rate", 0.0) > 0:
        raise AssertionError("no prefix-cache hit on the shared prefix")
    if launches != steps * cfg.num_hidden_layers or launches == 0:
        raise AssertionError(f"paged_decode launched {launches} times for "
                             f"{steps} decode steps x 32 layers")
    if stats != {"admit": 1, "prefill": 1, "decode": 1}:
        raise AssertionError(f"programs not captured once each: {stats}")
    if not greedy_same:
        raise AssertionError("graphed greedy streams differ from eager")
    for row in kernel_rows:
        row["launches"] = launches
    engine_numbers = {"decode_step_ms_median":
                      float(np.median(decode_s)) * 1e3,
                      "prefill_chunk_ms_median":
                      float(np.median(prefill_s)) * 1e3,
                      "greedy": {i: reqs[i].tokens for i in greedy},
                      "streams": [r.tokens for r in reqs]}
    return cfg, params, eng, prompts, temps, engine_numbers


def _profile_prefill(eng, vocab):
    """Device time of one eager 128-token prefill chunk (the fifth of a
    1000-token prompt) by kernel class, from torch.profiler (ms): the
    bf16 GEMMs, the f32 GEMMs of the einsum attention over the slot's
    view, copies and casts, the softmax, the rest."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    prompt = np.random.default_rng(3).integers(0, vocab, 1000)
    req = eng.submit(prompt.astype(np.int32), max_new_tokens=1)
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    eng.cancel(req)
    classes = {"gemm_bf16": 0.0, "gemm_f32": 0.0, "copy": 0.0,
               "softmax": 0.0, "other": 0.0}
    launches = 0
    for ev in prof.key_averages():
        if str(ev.device_type) != "DeviceType.CUDA":
            continue
        ms = float(getattr(ev, "self_device_time_total", 0.0)) / 1e3
        low = ev.key.lower()
        cls = ("gemm_f32" if "f32f32" in low else
               "gemm_bf16" if any(t in low for t in ("gemm", "nvjet",
                                                     "splitk")) else
               "copy" if "copy" in low else
               "softmax" if "softmax" in low else "other")
        classes[cls] += ms
        launches += ev.count
    return {"device_ms_by_class": classes,
            "device_ms_total": sum(classes.values()),
            "kernel_launches": launches}


def _device_table(eng):
    """The engine's host page table as a device tensor."""
    import torch

    return torch.from_numpy(eng._table).to(eng.device)


def _rel_l2(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def phase_kernel_vs_dense(cfg, params, eng, engine_numbers):
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
    table = _device_table(eng)
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
    _decode_breakdown(eng, table, engine_numbers, reqs)
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


def _decode_breakdown(eng, table, engine_numbers, reqs):
    """Where one decode step's device time goes at this pool state: the
    whole eager forward through each path, the kernel alone on layer 0's
    inputs (it runs once per layer), and the captured decode step (the
    forward, sampling and the append) replayed back to back, beside the
    engine phase's decode step by the host clock. Gated: one profiled
    replay runs the K2 split and combine kernels once per layer each,
    and the runner books as many launches for it."""
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
    profile = _profile_step(eng, table)
    forward_device_ms = profile["device_ms_total"]
    engine_numbers["decode_forward_device_ms"] = forward_device_ms
    # the captured decode program, replayed back to back: each replay is
    # a real step for the 8 live lanes (lengths advance by one)
    eng._upload_step([s for s in eng.scheduler.slots
                      if s.request in reqs])
    graph_ms = cuda_time_ms(lambda: eng._graphs("decode"), iters=5,
                            warmup=1)
    replay = _replay_kernels(eng)
    host_ms = engine_numbers["decode_step_ms_median"]
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
         layers=eng.cache.num_layers, profile=profile,
         graph_decode_step_ms=graph_ms, replay_kernels=replay,
         engine_decode_step_ms_median=host_ms,
         step_over_forward_device=host_ms / forward_device_ms)
    layers = eng.cache.num_layers
    if set(replay.values()) != {layers}:
        raise AssertionError(f"one decode replay ran {replay}, not "
                             f"{layers} of each")


def _replay_kernels(eng) -> dict:
    """One replay of the captured decode program under torch.profiler:
    the K2 split and combine kernels the device ran, beside the launches
    the runner books for the replay (the wrapper, the counting site,
    does not run in a replay: the runner adds what the capture
    counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import accelerate_tpu_torch.ops.paged_attention as paged

    torch.cuda.synchronize()
    before = paged.paged_decode_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng._graphs("decode")
        torch.cuda.synchronize()
    ran = {"paged_decode_split_kernel": 0, "paged_decode_combine_kernel": 0}
    for ev in prof.key_averages():
        if str(ev.device_type) != "DeviceType.CUDA":
            continue
        for name in ran:
            if name in ev.key:
                ran[name] += ev.count
    return {"booked": paged.paged_decode_attention.launches - before, **ran}


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
# phase 5a: the HTTP front door over the llama3-8B engine
# ---------------------------------------------------------------------------


async def _http(port, path, body=None, headers=None, method=None):
    """One HTTP/1.1 exchange with the front door: (status, head, body)."""
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    method = method or ("POST" if body is not None else "GET")
    hdr = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: smoke\r\n{hdr}"
                 f"Content-Length: {len(payload)}\r\n\r\n".encode()
                 + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, out = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), head, out


def _header(head: bytes, name: bytes):
    for line in head.split(b"\r\n"):
        key, _, value = line.partition(b":")
        if key.strip().lower() == name:
            return value.strip().decode()
    return None


async def _stream(port, body, on_first=None):
    """A streamed completion, read frame by frame as the server flushes
    them: (status, send time, [arrival time per token], token ids)."""
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(dict(body, stream=True)).encode()
    t0 = time.perf_counter()
    writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                 + f"Content-Length: {len(payload)}\r\n\r\n".encode()
                 + payload)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    status = int(head.split(b" ")[1])
    times, ids = [], []
    while status == 200:
        try:
            frame = await reader.readuntil(b"\n\n")
        except asyncio.IncompleteReadError:
            break
        if frame.startswith(b"data: [DONE]"):
            break
        new = json.loads(frame[len(b"data: "):])["choices"][0].get(
            "token_ids") or []
        if new and not ids and on_first is not None:
            on_first()
        now = time.perf_counter()
        times += [now] * len(new)
        ids += new
    writer.close()
    return status, t0, times, ids


def _rates(t0s, times, counts):
    """TTFT per request (ms) and the decode tokens/s of the whole batch:
    tokens after each request's first, over the span from the first
    first token to the last token."""
    ttft = [(ts[0] - t0) * 1e3 for t0, ts in zip(t0s, times)]
    start = min(ts[0] for ts in times)
    end = max(ts[-1] for ts in times)
    return ttft, (sum(counts) - len(counts)) / (end - start)


def _direct(eng, prompts, max_new):
    """The prompts submitted together to the engine, stepped to idle with
    each token's host arrival time recorded: (requests, submit time,
    arrival times per request)."""
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    times = [[] for _ in reqs]
    while eng.step():
        now = time.perf_counter()
        for r, ts in zip(reqs, times):
            ts += [now] * (len(r.tokens) - len(ts))
    return reqs, t0, times


def phase_server(cfg, eng):
    """The llama3-8B engine of phase `engine` (32 layers, bf16) behind
    `InferenceService` + `HttpFrontDoor` on 127.0.0.1, an ephemeral port.

    Prompt pages are not reused during the phase (the allocator's prefix
    cache is off, then restored), so the HTTP run and the engine-direct
    run prefill the same cold prompts the same way. Gated: the SSE token
    ids and a unary completion equal the greedy streams of the engine
    driven directly; an n=2 fan-out (one submission, one fork) gives two
    distinct 8-token choices; a request carrying `traceparent` gets its
    trace id back as x-request-id and its spans in the flight recorder;
    /healthz answers 200 and /metrics both expositions; during a drain
    new work gets 503 and /healthz 503 while the stream in flight
    finishes; K2 launched in the HTTP run. Reported: TTFT and decode
    tokens/s over HTTP beside engine-direct, 5 prompts at once on the 8
    slots."""
    import asyncio

    import numpy as np

    from accelerate_tpu_torch.ops.paged_attention import \
        paged_decode_attention
    from accelerate_tpu_torch.server import (
        HttpFrontDoor, InferenceService, ServerConfig, get_tokenizer)
    from accelerate_tpu_torch.telemetry import trace

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (200, 350, 500, 640, 260)]
    max_new = 32
    eng.allocator.prefix_cache = False
    try:
        direct, t0, dtimes = _direct(eng, prompts, max_new)
        want = [r.tokens for r in direct]
        d_ttft, d_rate = _rates([t0] * len(direct), dtimes,
                                [len(t) for t in want])
        door = HttpFrontDoor(InferenceService(
            eng, get_tokenizer("auto", cfg.vocab_size),
            ServerConfig(port=0, default_max_tokens=max_new)))
        paged_decode_attention.launches = 0
        out = asyncio.run(_server_scenario(door, prompts, max_new, want,
                                           trace))
        launches = paged_decode_attention.launches
    finally:
        eng.allocator.prefix_cache = True
        trace.configure_tracing(enabled=False)
        trace.clear_flight_recorder()
    h_ttft, h_rate = _rates(out["t0"], out["times"],
                            [len(i) for i in out["ids"]])
    emit("server", config="llama3_8b", layers=cfg.num_hidden_layers,
         requests=len(prompts), prompt_tokens=[len(p) for p in prompts],
         max_tokens=max_new, num_slots=eng.engine_config.num_slots,
         sse_streams_equal_engine=out["ids"] == want,
         unary_equal_engine=out["unary"] == want[0],
         fan_out=out["fan_out"], traceparent=out["traceparent"],
         healthz=out["healthz"], metrics=out["metrics"],
         drain=out["drain"], paged_decode_launches=launches,
         http_ttft_ms=h_ttft, engine_ttft_ms=d_ttft,
         http_ttft_ms_median=float(np.median(h_ttft)),
         engine_ttft_ms_median=float(np.median(d_ttft)),
         http_decode_tokens_per_s=h_rate,
         engine_decode_tokens_per_s=d_rate)
    failed = [k for k, ok in (
        ("sse_streams", out["ids"] == want),
        ("unary", out["unary"] == want[0]),
        ("fan_out", out["fan_out"]["ok"]),
        ("traceparent", out["traceparent"]["ok"]),
        ("healthz", out["healthz"] == 200),
        ("metrics", out["metrics"]["ok"]),
        ("drain", out["drain"]["ok"]),
        ("paged_decode_launches", launches > 0)) if not ok]
    if failed:
        raise AssertionError(f"server phase failed: {failed}")


async def _server_scenario(door, prompts, max_new, want, trace):
    import asyncio

    await door.start()
    port = door.port
    try:
        streams = await asyncio.gather(*[
            _stream(port, {"prompt": p.tolist(), "max_tokens": max_new,
                           "temperature": 0}) for p in prompts])
        out = {"t0": [s[1] for s in streams],
               "times": [s[2] for s in streams],
               "ids": [s[3] for s in streams]}
        st, _, body = await _http(port, "/v1/completions", {
            "prompt": prompts[0].tolist(), "max_tokens": max_new,
            "temperature": 0})
        out["unary"] = (json.loads(body)["choices"][0]["token_ids"]
                        if st == 200 else None)
        st, _, body = await _http(port, "/v1/completions", {
            "prompt": prompts[1][:100].tolist(), "max_tokens": 8, "n": 2,
            "temperature": 0.8, "seed": 11})
        choices = json.loads(body)["choices"] if st == 200 else []
        ids = [c["token_ids"] for c in choices]
        out["fan_out"] = {"status": st, "choices": len(ids),
                          "ok": st == 200 and len(ids) == 2
                          and all(len(i) == 8 for i in ids)
                          and ids[0] != ids[1]}
        trace.configure_tracing(enabled=True, annotate=False)
        tid = "5e" * 16
        st, head, _ = await _http(
            port, "/v1/completions",
            {"prompt": prompts[2][:64].tolist(), "max_tokens": 4,
             "temperature": 0},
            headers={"traceparent": f"00-{tid}-{'ab' * 8}-01"})
        trace.configure_tracing(enabled=False)
        names = sorted({e["name"] for e in trace.trace_events(tid)})
        needed = {"serving.request", "serving.queue_wait", "serving.admit",
                  "serving.prefill", "serving.decode_lifetime"}
        out["traceparent"] = {
            "status": st, "x_request_id": _header(head, b"x-request-id"),
            "spans": names,
            "ok": st == 200 and _header(head, b"x-request-id") == tid
            and needed <= set(names)}
        st, _, _ = await _http(port, "/healthz")
        out["healthz"] = st
        st1, head1, body1 = await _http(port, "/metrics")
        st2, head2, body2 = await _http(
            port, "/metrics",
            headers={"Accept": "application/openmetrics-text"})
        ctype1 = _header(head1, b"content-type") or ""
        ctype2 = _header(head2, b"content-type") or ""
        out["metrics"] = {
            "prometheus": ctype1, "openmetrics": ctype2,
            "ok": st1 == st2 == 200 and ctype1.startswith("text/plain")
            and ctype2.startswith("application/openmetrics-text")
            and b"serving_ttft_seconds" in body1
            and body2.rstrip().endswith(b"# EOF")}
        # a drain while a stream is in flight: new work 503, the stream
        # still finishes
        first = asyncio.Event()
        inflight = asyncio.get_running_loop().create_task(_stream(
            port, {"prompt": prompts[3].tolist(), "max_tokens": 64,
                   "temperature": 0}, on_first=first.set))
        await asyncio.wait_for(first.wait(), 300)
        drain = asyncio.get_running_loop().create_task(
            door.service.drain(timeout_s=300))
        await asyncio.sleep(0)
        st_new, _, body_new = await _http(
            port, "/v1/completions",
            {"prompt": prompts[4][:32].tolist(), "max_tokens": 4})
        st_health, _, _ = await _http(port, "/healthz")
        st_stream, _, _, got = await inflight
        await drain
        code = (json.loads(body_new)["error"].get("code")
                if st_new == 503 else None)
        out["drain"] = {"new_request": st_new, "code": code,
                        "healthz": st_health, "in_flight": st_stream,
                        "in_flight_tokens": len(got),
                        "ok": st_new == 503 and code == "draining"
                        and st_health == 503 and st_stream == 200
                        and len(got) == 64}
        return out
    finally:
        await door.stop()


def phase_serve_cli():
    """`python -m accelerate_tpu_torch.commands.serve`, `--family llama`
    and `--family gpt2`: each one's --dry-run JSON, then its tiny config
    served on the card (port 0), one greedy request over HTTP, the decode
    path's counter read from /metrics
    (`serving_decode_path_total{path="kernel"}`: K2 served the steps),
    then SIGTERM: the process drains and exits 0."""
    for family in ("llama", "gpt2"):
        _serve_cli_family(family)


def _serve_cli_family(family):
    import http.client
    import queue
    import re
    import signal
    import threading

    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.serve",
           "--family", family]
    dry = subprocess.run(cmd + ["--dry-run"], capture_output=True,
                         text=True, timeout=300, check=True)
    conf = json.loads(dry.stdout.strip().splitlines()[-1])
    proc = subprocess.Popen(cmd + ["--port", "0"], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stderr], daemon=True)
    reader.start()
    try:
        line = lines.get(timeout=300)
        m = re.search(r"serving \S+ on 127\.0\.0\.1:(\d+)", line)
        if m is None:
            raise AssertionError(f"serve did not start: {line!r}")
        port = int(m.group(1))
        t = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": [1, 2, 3, 4, 5], "max_tokens": 8,
             "temperature": 0}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        request_s = time.perf_counter() - t
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/metrics")
        metrics = conn.getresponse().read().decode()
        conn.close()
        m = re.search(r'serving_decode_path_total\{path="kernel"\} (\S+)',
                      metrics)
        kernel_steps = float(m.group(1)) if m else 0.0
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    reader.join(timeout=60)
    rest = []
    while not lines.empty():
        rest.append(lines.get().strip())
    tokens = body["choices"][0]["token_ids"]
    emit("serve_cli", family=family, dry_run=conf, status=resp.status,
         tokens=tokens, request_s=request_s,
         kernel_decode_steps=kernel_steps, exit_code=rc, log=rest[-3:])
    if not (conf.get("dry_run") and conf.get("family") == family
            and resp.status == 200 and len(tokens) == 8
            and kernel_steps > 0 and rc == 0
            and any("drained" in ln for ln in rest)):
        raise AssertionError(f"serve_cli --family {family} failed: see "
                             "the serve_cli line")


# ---------------------------------------------------------------------------
# phase 5a'': telemetry on the serving path
# ---------------------------------------------------------------------------

# the keys the reference's default engine reports and the port's did not
TELEMETRY_KEYS = ("decode_device_time_mean_ms", "decode_device_time_p99_ms",
                  "prefill_device_time_mean_ms", "prefill_device_time_p99_ms",
                  "decode_mfu", "decode_hbm_bw_util",
                  "decode_mxu_idle_fraction", "decode_arith_intensity",
                  "goodput", "host_dispatch_us_mean")
TELEMETRY_WATCHDOG_S = 5.0
# the sampled decode program (forward, sampling, append, host launch)
# against the eager forward's profiled device time at phase engine's
# pool state: the pool state differs, so the band is wide
TELEMETRY_DECODE_BAND = 0.20
BUNDLE_FILES = ("report.json", "stacks.txt", "trace.json", "metrics.json",
                "metrics.prom", "device_memory.json", "cost_table.json")


def _scrape(port, accept=None) -> str:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/metrics",
                                 headers={"Accept": accept} if accept
                                 else {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read().decode()


async def _healthz_on_stall(door, eng):
    """/healthz of a door over the stalled engine, then after a tick.
    An idle door ticks the watchdog itself (idle is progress), so the
    door starts with the watchdog set aside and gets it back once its
    drive loop waits for work, as the reference's test does."""
    import asyncio

    wd, eng.watchdog = eng.watchdog, None
    await door.start()
    try:
        await asyncio.sleep(0.1)
        eng.watchdog = wd
        st, _, body = await _http(door.port, "/healthz")
        wd.tick()
        st_after, _, _ = await _http(door.port, "/healthz")
        return {"stalled": st, "reason": json.loads(body),
                "after_tick": st_after}
    finally:
        await door.stop()


def phase_telemetry(cfg, params, prompts, temps, engine_numbers,
                    kernel_rows):
    """Phase engine's llama3-8B engine (32 layers, bf16, 8 slots, 12
    requests) with every telemetry knob on: the exporter on an ephemeral
    port, a 5 s stall watchdog, device-time sampling at every call and
    an incident directory. Gated: greedy streams equal phase engine's,
    each program captured once, K2's launches through replays, every
    telemetry key of the reference's summary with non-nominal peaks,
    `decode_mfu` and `decode_hbm_bw_util` in (0, 1.05], the sampled
    decode time within 20% of the eager forward's profiled device time,
    both expositions of /metrics carrying the decode device time and
    goodput; then, left unstepped, the watchdog fires, /healthz answers
    503 (200 after a tick), the bundle holds the reference's files and
    the incident CLI lists and shows it; close() leaves no thread.
    Reported beside phase engine's (sampling every 16th call): the
    decode step and prefill chunk medians."""
    import asyncio
    import os
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import \
        paged_decode_attention
    from accelerate_tpu_torch.server import (
        HttpFrontDoor, InferenceService, ServerConfig, get_tokenizer)
    from accelerate_tpu_torch.serving import Engine, EngineConfig
    from accelerate_tpu_torch.telemetry import list_incident_bundles

    incidents = tempfile.mkdtemp(prefix="chip_smoke_incidents_")
    ec = EngineConfig(cache_dtype=torch.bfloat16, paged_attention=True,
                      metrics_port=0,
                      watchdog_timeout_s=TELEMETRY_WATCHDOG_S,
                      cost_sample_every=1, incident_dir=incidents,
                      **ENGINE_CONFIG)
    eng = Engine(llama, cfg, params, ec)
    port = eng.metrics_server.port
    # the main path's run: every count at 0 just before, read just after
    paged_decode_attention.launches = 0
    reqs, decode_s, prefill_s, run_s = _drive(eng, prompts, temps)
    launches = paged_decode_attention.launches
    steps = eng.metrics.decode_steps
    stats = eng.compile_stats()
    summary = eng.metrics_summary()
    sheets = {p: eng.cost.roofline(p) for p in ("admit", "prefill",
                                                "decode")}
    stalls_while_driven = eng.watchdog.stall_count
    scrapes = {"prometheus": _scrape(port),
               "openmetrics": _scrape(port, "application/openmetrics-text")}
    scrape_ok = {k: 'program_device_time_seconds{program="decode"' in v
                 and "serving_goodput" in v for k, v in scrapes.items()}
    greedy = engine_numbers["greedy"]
    greedy_same = all(reqs[i].tokens == toks for i, toks in greedy.items())
    # left unstepped past the timeout: the watchdog's own thread fires
    t0 = time.perf_counter()
    while not eng.watchdog.stalled and \
            time.perf_counter() - t0 < 4 * TELEMETRY_WATCHDOG_S:
        time.sleep(0.25)
    fired_after_s = time.perf_counter() - t0
    # the watchdog's thread writes the bundle after it flips `stalled`,
    # its manifest last: read the bundle once the manifest is there
    bundles: list = []
    while time.perf_counter() - t0 < 8 * TELEMETRY_WATCHDOG_S:
        bundles = list_incident_bundles(incidents)
        if bundles and "created_at" in bundles[0]:   # a read manifest
            break
        time.sleep(0.25)
    bundle = bundles[0]["path"] if bundles else None
    files = sorted(os.listdir(bundle)) if bundle else []
    door = HttpFrontDoor(InferenceService(
        eng, get_tokenizer("auto", cfg.vocab_size), ServerConfig(port=0)))
    health = asyncio.run(_healthz_on_stall(door, eng))
    cli = {}
    for args in (["list"], ["show", bundle or "0"]):
        proc = subprocess.run(
            [sys.executable, "-m", "accelerate_tpu_torch.commands.incident",
             *args, "--dir", incidents],
            capture_output=True, text=True, timeout=120)
        cli[args[0]] = {"rc": proc.returncode,
                        "names_bundle": bool(bundle) and
                        os.path.basename(bundle) in proc.stdout,
                        "cost_block": "device cost (per call)" in proc.stdout}
    eng.close()
    shutil.rmtree(incidents, ignore_errors=True)
    left = [t.name for t in threading.enumerate()
            if t.is_alive() and ("watchdog" in t.name
                                 or t.name == "accelerate-tpu-metrics")]
    forward_ms = engine_numbers["decode_forward_device_ms"]
    decode_ms = summary.get("decode_device_time_mean_ms", float("nan"))
    missing = [k for k in TELEMETRY_KEYS if k not in summary]
    emit("telemetry", config="llama3_8b", layers=cfg.num_hidden_layers,
         cost_sample_every=1, watchdog_timeout_s=TELEMETRY_WATCHDOG_S,
         requests=len(reqs),
         finished=len(reqs) - len(_finished(reqs, cfg.vocab_size)),
         decode_steps=steps, paged_decode_launches=launches,
         compile_stats=stats, greedy_streams_equal_engine=greedy_same,
         summary={k: summary.get(k) for k in TELEMETRY_KEYS},
         rooflines=sheets, missing_keys=missing,
         decode_forward_device_ms=forward_ms,
         sampled_decode_over_forward=decode_ms / forward_ms,
         decode_step_ms_median=float(np.median(decode_s)) * 1e3,
         engine_decode_step_ms_median=engine_numbers[
             "decode_step_ms_median"],
         prefill_chunk_ms_median=float(np.median(prefill_s)) * 1e3,
         engine_prefill_chunk_ms_median=engine_numbers[
             "prefill_chunk_ms_median"],
         run_s=run_s, scrape_ok=scrape_ok,
         stalls_while_driven=stalls_while_driven,
         watchdog_fired_after_s=fired_after_s, healthz=health,
         bundle=bundle, bundle_files=files, incident_cli=cli,
         threads_left=left)
    failed = [k for k, ok in (
        ("finished", not _finished(reqs, cfg.vocab_size)),
        ("greedy_streams", greedy_same),
        ("captures", stats == {"admit": 1, "prefill": 1, "decode": 1}),
        ("launches", launches == steps * cfg.num_hidden_layers > 0),
        ("summary_keys", not missing),
        ("peaks_nominal", sheets["decode"].get("peaks_nominal") == 0.0),
        ("decode_mfu", 0.0 < summary.get("decode_mfu", 0.0) <= 1.05),
        ("decode_hbm_bw_util",
         0.0 < summary.get("decode_hbm_bw_util", 0.0) <= 1.05),
        ("decode_time", abs(decode_ms / forward_ms - 1.0)
         <= TELEMETRY_DECODE_BAND),
        ("scrape", all(scrape_ok.values())),
        ("watchdog_fired", health["stalled"] == 503
         and health["after_tick"] == 200),
        ("bundle", set(BUNDLE_FILES) <= set(files)),
        ("incident_cli", all(c["rc"] == 0 and c["names_bundle"]
                             for c in cli.values())
         and cli["show"]["cost_block"]),
        ("threads", not left)) if not ok]
    if failed:
        raise AssertionError(f"telemetry phase failed: {failed}")
    kernel_rows.append(_paged_row("telemetry", launches))


# ---------------------------------------------------------------------------
# phase 5b: speculative decoding
# ---------------------------------------------------------------------------


class _TimedPrograms:
    """Stands in for an engine's GraphRunner: CUDA events around every
    run of the named programs, every other attribute the runner's own."""

    def __init__(self, runner, names):
        self._runner, self._names = runner, names
        self.events = {n: [] for n in names}

    def __call__(self, name, *args):
        import torch

        if name not in self._names:
            return self._runner(name, *args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._runner(name, *args)
        end.record()
        self.events[name].append((start, end))
        return out

    def __getattr__(self, attr):
        return getattr(self._runner, attr)

    def medians_ms(self) -> dict:
        """Median ms of each program's runs after its first (capture)."""
        import numpy as np
        import torch

        torch.cuda.synchronize()
        return {n: float(np.median([a.elapsed_time(b) for a, b in ev[1:]]))
                for n, ev in self.events.items() if len(ev) > 1}


SPEC_PROGRAMS = {"admit": 1, "prefill": 1, "draft_prefill": 1, "draft": 1,
                 "verify": 1}


def _truncated(params, layers):
    """A draft that is the target cut after its first `layers` layers:
    the same embedding, final norm and head, and the stacked layer
    weights sliced (views, nothing copied)."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:layers]

    return {**params, "layers": cut(params["layers"])}


def phase_speculative(cfg, params, prompts, temps, engine_numbers):
    """Speculative decoding at llama3-8B width, draft_k 4, 8 slots, the
    engine phase's 12 prompts. Gated in f32 activations at 4 layers
    (bf16 paths drift apart at depth, as kernel_vs_dense shows), with
    two drafts: the target's truncated 2-layer sibling (its embedding,
    first 2 layers and head), and the target drafting for itself, which
    is accepted, so the captured verify commits accepted windows. Gates:
    greedy streams identical to the plain engine's for both drafts, and
    a self-draft accept rate above 0. Then the bf16 32-layer target of
    the engine phase with a 2-layer draft of its own seed: every request
    finishes; reported are the accept rate, tokens per verify step, the
    draft and verify programs' device times, and the share of greedy
    tokens equal to the plain engine's."""
    import dataclasses

    import numpy as np
    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    cfg4 = dataclasses.replace(cfg, num_hidden_layers=4)
    dcfg = dataclasses.replace(cfg, num_hidden_layers=2)
    p4 = llama.init_params(cfg4, 0, dtype=torch.float32)
    ec = EngineConfig(cache_dtype=torch.float32, **ENGINE_CONFIG)
    greedy_temps = [0.0] * len(prompts)
    plain, *_ = _drive(Engine(llama, cfg4, p4, ec), prompts, greedy_temps)
    bad = _finished(plain, cfg.vocab_size)
    f32 = {}
    for name, draft in (("truncated", (llama, dcfg, _truncated(p4, 2))),
                        ("self", (llama, cfg4, p4))):
        spec_eng = Engine(llama, cfg4, p4, dataclasses.replace(
            ec, speculative=draft, draft_k=4))
        spec, *_ = _drive(spec_eng, prompts, greedy_temps)
        f32[name] = dict(
            same=[a.tokens == b.tokens for a, b in zip(spec, plain)],
            stats=spec_eng.compile_stats(),
            accept=spec_eng.metrics_summary().get("spec_accept_rate"))
        bad += _finished(spec, cfg.vocab_size)
        del spec_eng, spec
    f32_same = [all(pair) for pair in zip(*(r["same"] for r in f32.values()))]
    del p4, plain
    _drop()

    draft = llama.init_params(dcfg, 1, dtype=torch.bfloat16)
    eng = Engine(llama, cfg, params, EngineConfig(
        cache_dtype=torch.bfloat16, speculative=(llama, dcfg, draft),
        draft_k=4, **ENGINE_CONFIG))
    timed = _TimedPrograms(eng._graphs, ("draft", "verify"))
    eng._graphs = timed
    reqs, decode_s, prefill_s, run_s = _drive(eng, prompts, temps)
    summary = eng.metrics_summary()
    stats = eng.compile_stats()
    # committed tokens per live slot and verify step (each request's
    # first token comes from its prefill)
    decode_tokens = sum(len(r.tokens) for r in reqs) - len(reqs)
    slot_steps = eng.metrics.spec_drafted_tokens / 4
    ref = engine_numbers["greedy"]
    agree = sum(sum(a == b for a, b in zip(reqs[i].tokens, toks))
                for i, toks in ref.items())
    total = sum(len(t) for t in ref.values())
    emit("speculative", config="llama3_8b", draft_layers=2, draft_k=4,
         f32_layers=4, f32_greedy_streams_identical=all(f32_same),
         f32_identical_per_request=f32_same,
         f32_compile_stats={n: r["stats"] for n, r in f32.items()},
         f32_accept_rate={n: r["accept"] for n, r in f32.items()},
         layers=cfg.num_hidden_layers, compile_stats=stats,
         finished=len(reqs) - len(_finished(reqs, cfg.vocab_size)),
         accept_rate=summary.get("spec_accept_rate"),
         tokens_per_decode_step=summary.get("tokens_per_decode_step"),
         tokens_per_slot_step=decode_tokens / slot_steps,
         verify_steps=eng.metrics.decode_steps,
         program_ms_median=timed.medians_ms(),
         capture_s=timed.capture_seconds(),
         spec_step_ms_median=float(np.median(decode_s)) * 1e3,
         prefill_step_ms_median=float(np.median(prefill_s)) * 1e3,
         decode_tokens_per_s=decode_tokens / sum(decode_s),
         run_s=run_s, greedy_tokens_equal_to_plain=agree,
         greedy_tokens=total, greedy_agreement=agree / total)
    bad += _finished(reqs, cfg.vocab_size)
    if bad:
        raise AssertionError(f"speculative requests {bad} did not finish")
    if not all(f32_same):
        raise AssertionError("f32 speculative greedy streams differ from "
                             f"the plain engine's: {f32_same}")
    if not f32["self"]["accept"]:
        raise AssertionError("the f32 self-draft had no proposal accepted")
    if any(r["stats"] != SPEC_PROGRAMS for r in f32.values()) \
            or stats != SPEC_PROGRAMS:
        raise AssertionError(f"programs not captured once: {stats}, "
                             f"{f32}")


# ---------------------------------------------------------------------------
# phase 5c: the host KV tier
# ---------------------------------------------------------------------------


def phase_host_tier(cfg, params):
    """The host KV tier at llama3-8B width and depth: 2 slots and a pool
    of one slot's pages (136), too small for the traffic: a request on
    the 512-token shared prefix, two 1500-token requests that evict its
    pages to host memory, then a second request on the prefix, which
    swaps them back in. Gated, in a bf16 and an int8 pool: swap-ins, and
    greedy streams identical to an engine whose pool holds everything.
    Reported: pages and bytes each way, and the transfer times."""
    import dataclasses

    import numpy as np
    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    rng = np.random.default_rng(2)
    prefix = rng.integers(0, cfg.vocab_size, 512)
    waves = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 100)]),
             rng.integers(0, cfg.vocab_size, 1500),
             rng.integers(0, cfg.vocab_size, 1500),
             np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 100)])]
    waves = [w.astype(np.int32) for w in waves]
    base = EngineConfig(num_slots=2, max_len=2048, prefill_chunk=128,
                        page_size=16, cache_dtype=torch.bfloat16)
    rows, failed = [], []
    for kv_dtype in (None, "int8"):
        streams = {}
        for name, kw in (("tier", dict(num_pages=136,
                                       host_tier_bytes=1 << 30)),
                         ("ample", {})):
            eng = Engine(llama, cfg, params, dataclasses.replace(
                base, kv_dtype=kv_dtype, **kw))
            out = []
            t0 = time.perf_counter()
            for w in waves:
                r = eng.submit(w, max_new_tokens=32)
                eng.run_until_idle()
                out.append(r)
            run_s = time.perf_counter() - t0
            streams[name] = [r.tokens for r in out]
            if name == "tier":
                tier_eng, tier_run_s = eng, run_s
                bad = _finished(out, cfg.vocab_size)
            else:
                del eng
        m = tier_eng.metrics
        nbytes = tier_eng.cache.page_nbytes
        row = dict(kv_dtype=kv_dtype or "bfloat16",
                   swap_out_pages=m.swap_out_pages,
                   swap_in_pages=m.swap_in_pages,
                   swap_out_bytes=m.swap_out_pages * nbytes,
                   swap_in_bytes=m.swap_in_pages * nbytes,
                   prefix_hits_host=m.prefix_hits_host,
                   # one host hit a run: its swap-in includes the
                   # install program's warm-up and capture
                   first_swap_in_host_ms=m.swap_in_s.mean * 1e3,
                   compile_stats=tier_eng.compile_stats(),
                   streams_identical=streams["tier"] == streams["ample"],
                   run_s=tier_run_s, **_transfer_times(tier_eng))
        tier_eng.close()
        del tier_eng
        _drop()
        emit("host_tier", config="llama3_8b", layers=cfg.num_hidden_layers,
             page_nbytes=nbytes, **row)
        rows.append(row)
        if bad or not row["swap_in_pages"] or not row["streams_identical"] \
                or set(row["compile_stats"].values()) != {1}:
            failed.append(row["kv_dtype"])
    if failed:
        raise AssertionError(f"host tier failed its gates in {failed}")


def _transfer_times(eng) -> dict:
    """The transport's two directions on this engine, by the host clock
    around work that ends in a synchronise: one page out (extract, then
    the copy to pinned host memory) and a 32-page block in (staging,
    copy to the device, install)."""
    import numpy as np
    import torch

    tp, cache = eng._swap_transport, eng.cache
    torch.cuda.synchronize()
    out_s = []
    for page in range(8):
        t0 = time.perf_counter()
        host, done = tp.copy_out(tp.extract(page))
        done.synchronize()
        out_s.append(time.perf_counter() - t0)
    pages = [{name: t[0] for name, t in host.items()}] * 32
    rows = np.full((cache.pages_per_slot,), cache.trash_page, np.int32)
    in_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tp.install(rows, pages)   # every page to the trash page
        torch.cuda.synchronize()
        in_s.append(time.perf_counter() - t0)
    nbytes = cache.page_nbytes
    return {"swap_out_ms_per_page": float(np.median(out_s)) * 1e3,
            "swap_out_gb_per_s": nbytes / float(np.median(out_s)) / 1e9,
            "swap_in_32_pages_ms": float(np.median(in_s)) * 1e3,
            "swap_in_gb_per_s": 32 * nbytes / float(np.median(in_s)) / 1e9}


# ---------------------------------------------------------------------------
# phase 5c1: the disaggregated pod (prefill worker -> KV pages -> decode
# worker) at llama3-8B width and depth
# ---------------------------------------------------------------------------

POD_PROGRAMS = {"admit": 1, "prefill": 1, "decode": 1, "extract": 1,
                "install": 1}


def _time_engine_steps(engine):
    """Wrap `engine.step` so each call is timed between synchronises;
    returns the list the times land in."""
    import torch

    times, step = [], engine.step

    def timed():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    engine.step = timed
    return times


def _count_shipments(transport):
    """Wrap a prefill worker's transport: record each shipment's
    `page_bytes` and the bytes its copy to the host actually moved."""
    page_bytes, host_bytes = [], []
    to_host, extract = transport.to_host, transport.extract_shipment

    def counted_to_host(block, n):
        out = to_host(block, n)
        host_bytes.append(sum(a.nbytes for a in out.values()))
        return out

    def counted_extract(*args, **kwargs):
        ship = extract(*args, **kwargs)
        page_bytes.append(ship.page_bytes)
        return ship

    transport.to_host = counted_to_host
    transport.extract_shipment = counted_extract
    return page_bytes, host_bytes


def _pinned_d2h_gb_per_s(nbytes, reps=5) -> float:
    """The card-to-host rate of one pinned copy of `nbytes`, CUDA events
    around `reps` copies."""
    import torch

    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    ms = cuda_time_ms(lambda: dst.copy_(src, non_blocking=True), iters=reps,
                      warmup=1)
    return nbytes / ms / 1e6


def _shipment_times(pod, prompt, key, reps=3) -> dict:
    """One shipment of `prompt` timed part by part on the pod's workers
    (programs already captured): the extract program, the slice and copy
    of the prompt pages to pinned host memory, and the install (copy to
    the card, the install program, admit). Host clock between
    synchronises; medians of `reps`."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.serving.pod import place_shipment

    pre, dec = pod.prefill_workers[0], pod.decode_workers[0]
    tp, td = pod._transports_p[0], pod._transports_d[0]
    hook, pages = pre.on_admit, {}
    pre.on_admit = lambda slot, req: pages.__setitem__(
        id(req), list(slot.alloc.pages))
    out = {"extract": [], "d2h": [], "install": []}
    try:
        for _ in range(reps):
            r = pre.submit(prompt, max_new_tokens=2, key=key)
            while not r.tokens:
                pre.step()
            n = -(-r.prompt_len // pre.cache.page_size)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            block = tp.extract_block(pages[id(r)])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            host = tp.to_host(block, n)
            t2 = time.perf_counter()
            ship = tp.extract_shipment(pages.pop(id(r)), r)
            pre.finish(r)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            placed = place_shipment(dec, td, ship, dec._clock())
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            if placed is None:
                raise AssertionError("the timed shipment found no slot")
            dec.cancel(placed[0])
            out["extract"].append(t1 - t0)
            out["d2h"].append(t2 - t1)
            out["install"].append(t4 - t3)
    finally:
        pre.on_admit = hook
    nbytes = sum(a.nbytes for a in host.values())
    d2h = float(np.median(out["d2h"]))
    return {"timed_shipment_pages": n, "timed_shipment_bytes": nbytes,
            "extract_ms": float(np.median(out["extract"])) * 1e3,
            "d2h_ms": d2h * 1e3, "d2h_gb_per_s": nbytes / d2h / 1e9,
            "pinned_d2h_gb_per_s": _pinned_d2h_gb_per_s(nbytes),
            "install_ms": float(np.median(out["install"])) * 1e3}


def phase_pod(cfg, params, prompts, temps, engine_numbers, kernel_rows):
    """`PodRouter(PodConfig(prefill_workers=1, decode_workers=1))` over
    phase engine's params (one copy, shared by both workers), its
    `ENGINE_CONFIG`, bf16 pool, `paged_attention=True`, graphs on, and its
    12 requests and keys. Gated: every request finishes, all 12 streams
    (greedy and sampled) equal phase engine's, K2's launches equal the
    decode worker's decode steps x 32 (through replays; the prefill
    worker decodes nothing), each program captured once (the shipment
    extract on the prefill worker, the install on the decode worker), 12
    shipments whose host bytes are the sum of their `page_bytes`.
    Reported: TTFT, the decode worker's step time, one shipment's extract,
    copy to the host and install times beside a plain pinned copy's
    rate."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import \
        paged_decode_attention
    from accelerate_tpu_torch.serving import EngineConfig
    from accelerate_tpu_torch.serving.pod import PodConfig, PodRouter

    ec = EngineConfig(cache_dtype=torch.bfloat16, paged_attention=True,
                      **ENGINE_CONFIG)
    pod = PodRouter(llama, cfg, params, ec,
                    PodConfig(prefill_workers=1, decode_workers=1))
    pre, dec = pod.prefill_workers[0], pod.decode_workers[0]
    page_bytes, host_bytes = _count_shipments(pod._transports_p[0])
    decode_s = _time_engine_steps(dec)
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: every count at 0 just before, read just after
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    reqs = [pod.submit(p, max_new_tokens=32, temperature=t, key=1000 + i)
            for i, (p, t) in enumerate(zip(prompts, temps))]
    pod.run_until_idle()
    run_s = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = pod.metrics_summary()
    steps = dec.metrics.decode_steps
    stats = pod.compile_stats()
    roles = {"prefill": pod._transports_p[0].compile_stats(),
             "decode": pod._transports_d[0].compile_stats()}
    want = engine_numbers["streams"]
    same = [r.tokens == w for r, w in zip(reqs, want)]
    shipped = (len(page_bytes), sum(page_bytes), sum(host_bytes))
    del dec.step
    times = _shipment_times(pod, max(prompts, key=len), 2000)
    emit("pod", config="llama3_8b", layers=cfg.num_hidden_layers,
         workers={"prefill": 1, "decode": 1}, requests=len(reqs),
         finished=len(reqs) - len(_finished(reqs, cfg.vocab_size)),
         streams_equal_engine=sum(same),
         greedy_equal=all(same[i] for i, t in enumerate(temps) if t == 0),
         decode_steps=steps, prefill_worker_decode_steps=(
             pre.metrics.decode_steps),
         paged_decode_launches=launches, compile_stats=stats,
         role_transport_stats=roles,
         shipments=summary.get("pod_shipments"),
         pages_shipped=summary.get("pod_pages_shipped"),
         backpressure_stalls=summary.get("pod_backpressure_stalls"),
         shipment_page_bytes=shipped[1], shipment_host_bytes=shipped[2],
         ttft_p50_ms=summary.get("ttft_p50_ms"),
         ttft_p99_ms=summary.get("ttft_p99_ms"),
         decode_step_ms_median=float(np.median(decode_s)) * 1e3,
         engine_decode_step_ms_median=engine_numbers[
             "decode_step_ms_median"],
         run_s=run_s, max_memory_allocated_gb=peak_gb, **times)
    kernel_rows.append(_paged_row("pod", launches))
    bad = _finished(reqs, cfg.vocab_size)
    if bad:
        raise AssertionError(f"pod requests {bad} did not finish")
    if not all(same):
        raise AssertionError("pod streams differ from phase engine's at "
                             f"{[i for i, s in enumerate(same) if not s]}")
    if launches != steps * cfg.num_hidden_layers or launches == 0 \
            or pre.metrics.decode_steps:
        raise AssertionError(f"paged_decode launched {launches} times for "
                             f"{steps} decode steps x 32 layers")
    if stats != POD_PROGRAMS or roles != {
            "prefill": {"extract": 1, "install": 0},
            "decode": {"extract": 0, "install": 1}}:
        raise AssertionError(f"pod programs not captured once: {stats} "
                             f"{roles}")
    if summary.get("pod_shipments") != 12 or shipped[0] != 12 \
            or shipped[2] != shipped[1]:
        raise AssertionError(f"{summary.get('pod_shipments')} shipments, "
                             f"host bytes {shipped[2]} against page_bytes "
                             f"{shipped[1]}")
    pod.close()


# the kill-and-recover run compares the pod with the single engine at
# f32: a replay recomputes delivered tokens' K/V in a prefill chunk,
# which rounds differently from the decode step that first wrote them,
# and in bf16 at depth that difference flips tokens; in f32 it does not
POD_KILL_LAYERS = 4


def _pod_dist_run(cfg, params, ec, prompts, temps, dec, kill):
    """The in-process distributed pod (workers behind `LocalChannel`s,
    every message through the wire codec) over `prompts`; with `kill`,
    the decode worker holding the most live streams loses its link once
    it has delivered tokens. Returns (requests, router, shipment wire
    dtypes, killed worker)."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.serving.pod.distributed import (
        DistributedPodConfig,
        FlakyTransport,
        build_local_distributed_pod,
    )

    links, dtypes = {}, set()

    def wrap(wid, role, ch):
        links[wid] = FlakyTransport(ch)
        send = ch.send

        def watched(msg):
            if msg.kind == "shipment":
                dtypes.update(b.dtype.metadata["dtype"]
                              if b.dtype.metadata else b.dtype.name
                              for b in msg.buffers[1:3])
            send(msg)

        ch.send = watched
        return links[wid]

    router, _ = build_local_distributed_pod(
        llama, cfg, params, engine_config=ec,
        pod_config=DistributedPodConfig(
            prefill_workers=1, decode_workers=dec, rebalance=False,
            heartbeat_interval_s=0.05, heartbeat_timeout_s=600.0,
            flight_timeout_s=600.0),
        channel_wrap=wrap)
    reqs = [router.submit(p, max_new_tokens=32, temperature=t, key=1000 + i)
            for i, (p, t) in enumerate(zip(prompts, temps))]
    victim = None
    deadline = time.monotonic() + 600
    while not all(r.done for r in reqs):
        router.step()
        if kill and victim is None:
            live = {}
            for f in router._flights.values():
                if f.phase == "decode" and len(f.user.tokens) > 2:
                    live[f.worker] = live.get(f.worker, 0) + 1
            if live and sum(live.values()) >= 2:
                victim = max(live, key=live.get)
                links[victim].kill()
        if time.monotonic() > deadline:
            raise AssertionError(f"distributed pod wedged: "
                                 f"{router.debug_pod()}")
    return reqs, router, dtypes, victim


def phase_pod_distributed(cfg, params, prompts, temps, engine_numbers):
    """`build_local_distributed_pod` at llama3-8B width: a prefill and a
    decode worker behind in-process channels, every message (the KV
    shipments as bf16 words) through the wire codec. Gated at full
    depth on phase engine's 12 requests: streams equal phase engine's,
    K2 launched on the decode worker, programs captured once. Then the
    decode worker is killed mid-run (1 prefill + 2 decode workers, f32 at
    `POD_KILL_LAYERS` layers, the first 8 requests): every flight
    recovers with the tokens of a single engine of that config, at
    least one replayed."""
    import dataclasses

    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.paged_attention import \
        paged_decode_attention
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    ec = EngineConfig(cache_dtype=torch.bfloat16, paged_attention=True,
                      **ENGINE_CONFIG)
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    reqs, router, dtypes, _ = _pod_dist_run(cfg, params, ec, prompts, temps,
                                            dec=1, kill=False)
    run_s = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    same = [r.tokens == w for r, w in zip(reqs, engine_numbers["streams"])]
    summary = router.metrics_summary()
    for _ in range(40):   # the heartbeats that report the last programs
        router.step()
        time.sleep(0.01)
    stats = router.compile_stats()
    router.close()
    del router
    _drop()

    kcfg = dataclasses.replace(cfg, num_hidden_layers=POD_KILL_LAYERS)
    kparams = llama.init_params(kcfg, 0, dtype=torch.float32)
    kec = EngineConfig(cache_dtype=torch.float32, paged_attention=True,
                       **ENGINE_CONFIG)
    single = Engine(llama, kcfg, kparams, kec)
    kp, kt = prompts[:8], temps[:8]
    ref = [single.submit(p, max_new_tokens=32, temperature=t, key=1000 + i)
           for i, (p, t) in enumerate(zip(kp, kt))]
    single.run_until_idle()
    del single
    kreqs, krouter, _, victim = _pod_dist_run(kcfg, kparams, kec, kp, kt,
                                              dec=2, kill=True)
    ksummary = krouter.metrics_summary()
    reasons = sorted({e["recovery_reason"] for e in krouter.recovery_log})
    krouter.close()
    recovered = [a.tokens == b.tokens for a, b in zip(kreqs, ref)]
    emit("pod_distributed", config="llama3_8b",
         layers=cfg.num_hidden_layers, requests=len(reqs),
         finished=len(reqs) - len(_finished(reqs, cfg.vocab_size)),
         streams_equal_engine=sum(same), paged_decode_launches=launches,
         compile_stats=stats, shipments=summary.get("pod_shipments"),
         shipment_wire_dtypes=sorted(dtypes),
         ttft_p50_ms=summary.get("ttft_p50_ms"),
         ttft_p99_ms=summary.get("ttft_p99_ms"), run_s=run_s,
         kill_layers=POD_KILL_LAYERS, kill_dtype="float32",
         kill_requests=len(kreqs), killed_worker=victim,
         kill_finished=len(kreqs) - len(_finished(kreqs, kcfg.vocab_size)),
         kill_streams_equal_single=sum(recovered),
         workers_lost=ksummary.get("pod_workers_lost"),
         requests_replayed=ksummary.get("pod_requests_replayed"),
         recovery_reasons=reasons,
         recovery_latency_p50_ms=ksummary.get("pod_recovery_latency_p50_ms"))
    if _finished(reqs, cfg.vocab_size) or not all(same):
        raise AssertionError("distributed pod streams differ from phase "
                             "engine's")
    if launches == 0 or stats != POD_PROGRAMS or dtypes != {"bfloat16"}:
        raise AssertionError(f"distributed pod: {launches} K2 launches, "
                             f"programs {stats}, wire dtypes {dtypes}")
    if victim is None or _finished(kreqs, kcfg.vocab_size) \
            or not all(recovered) \
            or not ksummary.get("pod_requests_replayed") \
            or ksummary.get("pod_workers_lost") != 1.0:
        raise AssertionError("the killed decode worker's flights did not "
                             "all recover exactly: see pod_distributed")


def phase_pod_cli():
    """`python -m accelerate_tpu_torch.commands.pod pod-router` with
    `--family llama` (the reference's tiny spec): its --dry-run JSON,
    then for real on port 0, spawning a `pod-worker` process per role on
    the card; 4 greedy completions over HTTP, each equal to the same
    spec's single engine on the card; the merged /metrics shows the
    workers' `serving_decode_path_total{path="kernel"}` > 0 (K2 served
    their decode steps); then SIGTERM: the router drains its workers,
    each exits 0, and so does the router."""
    import http.client
    import queue
    import re
    import signal
    import threading

    import numpy as np

    from accelerate_tpu_torch.serving.pod.distributed.worker import \
        build_worker_engine

    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.pod",
           "pod-router", "--family", "llama", "--tokenizer", "numeric"]
    dry = subprocess.run(cmd + ["--dry-run"], capture_output=True,
                         text=True, timeout=300, check=True)
    conf = json.loads(dry.stdout.strip().splitlines()[-1])
    prompts = [[1 + i, 2, 3, 4, 5, 6 + i] for i in range(4)]
    spec = conf["engine"]
    _fam, _cfg, _params, ref = build_worker_engine(spec)
    want = []
    for p in prompts:
        r = ref.submit(np.asarray(p, np.int32), max_new_tokens=8)
        ref.run_until_idle()
        want.append(r.tokens)
    del ref, _params
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd + ["--port", "0"], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stderr], daemon=True)
    reader.start()
    log, port = [], None
    try:
        while port is None:
            line = lines.get(timeout=300)
            log.append(line.strip())
            m = re.search(r"serving \S+ on 127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        ready_s = time.perf_counter() - t0
        got, request_s = [], []
        for p in prompts:
            t = time.perf_counter()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            conn.request("POST", "/v1/completions", json.dumps(
                {"prompt": p, "max_tokens": 8, "temperature": 0}),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            request_s.append(time.perf_counter() - t)
            got.append(body["choices"][0]["token_ids"]
                       if resp.status == 200 else None)
        seen, deadline = [], time.monotonic() + 60
        while time.monotonic() < deadline and not (
                len(seen) > 2 and seen[-1] > 0 and seen[-1] == seen[-3]):
            # the workers' counters reach the router in their heartbeats
            # (every 0.25 s): scrape until two heartbeats agree
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/metrics")
            metrics = conn.getresponse().read().decode()
            conn.close()
            m = re.search(r'serving_decode_path_total\{origin="workers",'
                          r'path="kernel"\} (\S+)', metrics)
            seen.append(float(m.group(1)) if m else 0.0)
            time.sleep(0.25)
        kernel_steps = seen[-1] if seen else 0.0
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    reader.join(timeout=60)
    while not lines.empty():
        log.append(lines.get().strip())
    m = [re.search(r"worker exit codes \[([^\]]*)\]", ln) for ln in log]
    worker_rcs = next(([int(x) for x in g.group(1).split(",")]
                       for g in m if g), None)
    emit("pod_cli", dry_run=conf, ready_s=ready_s, tokens=got,
         tokens_equal_engine=got == want, request_s=request_s,
         kernel_decode_steps=kernel_steps, exit_code=rc,
         worker_exit_codes=worker_rcs, log=log[-4:])
    if not (conf.get("dry_run") and conf.get("workers") == ["prefill",
                                                            "decode"]
            and got == want and kernel_steps > 0 and rc == 0
            and worker_rcs == [0, 0]
            and any("drained and stopped" in ln for ln in log)):
        raise AssertionError("pod_cli failed: see the pod_cli line")


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


def _timed_steps(step, state, batch, n):
    """n steps of `step` timed with CUDA events, the flash kernels' launch
    counts set to 0 just before them and read just after: (state, the
    losses as tensors, step ms, launches by kernel)."""
    import torch

    from accelerate_tpu_torch.ops import flash_attention as fa

    kernels = {"flash_fwd": fa.flash_forward,
               "flash_bwd_dq": fa.flash_backward_dq,
               "flash_bwd_dkv": fa.flash_backward_dkv}
    for fn in kernels.values():
        fn.launches = 0
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    losses = []
    marks[0].record()
    for i in range(n):
        state, m = step(state, batch)
        marks[i + 1].record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    return state, losses, [marks[i].elapsed_time(marks[i + 1])
                           for i in range(n)], launches


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
    # the main path's run: every count at 0 just before, read just after
    state, timed, step_ms, launches = _timed_steps(step, state, batch,
                                                   TRAIN_STEPS)
    losses = [float(x) for x in [m["loss"], *timed]]
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
    return {"losses": losses, "step_ms_median": med, "tokens_per_s": tok_s,
            "mfu_bf16_peak": flops_per_token * tok_s / BF16_FLOPS,
            "max_memory_allocated_gb": peak_gb,
            "device_ms_total": split["device_ms_total"]}


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
# phase 6': the Accelerator's eager loop at llama3-8B width
# ---------------------------------------------------------------------------

EAGER_ACCUM_LAYERS = 2    # the accumulation check: 4 micro-steps at k=2
EAGER_ACCUM_STEPS = 4


def _eager_step(acc, opt, sched, loss_fn):
    """The reference's eager loop as a `_timed_steps` step: one
    micro-step of accumulate -> compute_gradients -> backward ->
    clip_grad_norm_ -> optimizer step -> scheduler step -> zero_grad at
    the sync boundary (the reference's `zero_grad` drops the buffer
    whatever the boundary). It returns its params argument unchanged:
    the optimizer updates the params in place."""
    def step(params, batch):
        with acc.accumulate():
            loss, grads = acc.compute_gradients(loss_fn, opt.params, batch)
            acc.backward(grads)
            acc.clip_grad_norm_(max_norm=1.0)
            opt.step()
            sched.step()
            if acc.sync_gradients:
                opt.zero_grad()
        return params, {"loss": loss}

    return step


def _eager_call_ms(acc, opt, sched, loss_fn, batch):
    """One eager step with CUDA events between its calls: the device
    time of each (the host issues ahead of the card, so each interval is
    the card's work for that call)."""
    import torch

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    torch.cuda.synchronize()
    with acc.accumulate():
        marks[0].record()
        _, grads = acc.compute_gradients(loss_fn, opt.params, batch)
        marks[1].record()
        acc.backward(grads)                  # buffer fill + in-place add
        marks[2].record()
        acc.clip_grad_norm_(max_norm=1.0)
        marks[3].record()
        opt.step()
        marks[4].record()
        sched.step()
        opt.zero_grad()
        marks[5].record()
    torch.cuda.synchronize()
    names = ("compute_gradients", "backward", "clip_grad_norm_",
             "optimizer_step", "scheduler_step_zero_grad")
    return {n: marks[i].elapsed_time(marks[i + 1])
            for i, n in enumerate(names)}


def _eager_accumulation_check():
    """4 micro-steps at gradient_accumulation_steps=2 (2 layers, bf16,
    clip 1.0, four batches from seed 1) through the fused
    `train_step(use_grad_accum_buffer=True)` and through the eager loop:
    the losses and the final params must be equal, bit for bit."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.optimizers import adamw, constant_schedule, \
        tree_leaves
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState

    cfg = _train_config(EAGER_ACCUM_LAYERS, remat=True, remat_policy="dots")
    rng = np.random.default_rng(1)
    batches = [{"input_ids": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 2049)).astype(np.int32))}
        for _ in range(EAGER_ACCUM_STEPS)]

    def loss_fn(p, b):
        return llama.causal_lm_loss(cfg, p, b)

    PartialState._reset_state()
    acc = Accelerator(mixed_precision="bf16", gradient_clipping=1.0,
                      gradient_accumulation_steps=2)
    state = acc.prepare(TrainState.create(
        apply_fn=None, params=llama.init_params(cfg, 0), tx=adamw(3e-4),
        use_grad_accum_buffer=True))
    step = acc.train_step(loss_fn)
    fused = []
    for b in batches:
        state, m = step(state, b)
        fused.append(float(m["loss"]))
    fused_params = state.params
    del state, step, acc
    _drop()
    PartialState._reset_state()
    acc = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2)
    params = acc.prepare(llama.init_params(cfg, 0))
    opt = acc.prepare_optimizer(adamw(3e-4), params=params)
    sched = acc.prepare(constant_schedule(3e-4))
    step = _eager_step(acc, opt, sched, loss_fn)
    eager = [float(step(params, b)[1]["loss"]) for b in batches]
    params_equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(fused_params), tree_leaves(params)))
    out = {"layers": EAGER_ACCUM_LAYERS, "micro_steps": EAGER_ACCUM_STEPS,
           "gradient_accumulation_steps": 2, "fused_losses": fused,
           "eager_losses": eager, "losses_equal": fused == eager,
           "params_equal": params_equal, "scheduler_count": sched.count,
           "ok": fused == eager and params_equal and sched.count == 2}
    del fused_params, params, opt, sched, step, acc
    _drop()
    return out


def phase_eager_train(kernel_rows, train):
    """The reference's headline loop on phase `train`'s config, init and
    batch (llama3-8B width, 4 layers, remat "dots", bf16, seed 0,
    `[2, 2049]`): Accelerator(bf16), prepare(params),
    prepare_optimizer(adamw(3e-4), params), prepare(a constant
    schedule), then 1 warm-up and 10 timed eager steps (`_eager_step`).
    Gates: the 11 losses equal to phase `train`'s bit for bit (the same
    kernels in the same order on the same data), the scheduler's count
    11, `eval_step(loss_fn)(params0, batch)` equal to the first loss,
    the flash launches of phase `train`, and the accumulation check."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.common import count_params
    from accelerate_tpu_torch.optimizers import adamw, constant_schedule, \
        tree_leaves
    from accelerate_tpu_torch.state import PartialState

    cfg = _train_config(TRAIN_LAYERS, remat=True, remat_policy="dots")
    PartialState._reset_state()
    torch.cuda.reset_peak_memory_stats()
    acc = Accelerator(mixed_precision="bf16")
    params = acc.prepare(llama.init_params(cfg, 0))
    n_params = count_params(params)
    opt = acc.prepare_optimizer(adamw(3e-4), params=params)
    sched = acc.prepare(constant_schedule(3e-4))
    loader = acc.prepare([{"input_ids": _train_batch(cfg)}])
    (batch,) = list(loader)

    def loss_fn(p, b):
        return llama.causal_lm_loss(cfg, p, b)

    eval0 = float(acc.eval_step(loss_fn)(params, batch))
    step = _eager_step(acc, opt, sched, loss_fn)
    _, m = step(params, batch)                        # warm-up
    # the main path's run: every count at 0 just before, read just after
    _, timed, step_ms, launches = _timed_steps(step, params, batch,
                                               TRAIN_STEPS)
    losses = [float(x) for x in [m["loss"], *timed]]
    count = sched.count
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = float(np.median(step_ms))
    tok_s = 2 * 2048 / (med / 1e3)
    flops_per_token = 6 * n_params + 12 * cfg.num_hidden_layers * \
        cfg.hidden_size * 2048
    masters_f32 = all(t.dtype == torch.float32 for t in tree_leaves(params))
    split = _profile_train_step(step, params, batch)
    calls = [_eager_call_ms(acc, opt, sched, loss_fn, batch)
             for _ in range(3)]
    del params, opt, sched, step, loader, batch, acc
    _drop()
    accum = _eager_accumulation_check()
    first_diff = next((i for i, (a, b) in enumerate(zip(losses,
                                                        train["losses"]))
                       if a != b), None)
    emit("eager_train", config="llama3_8b", layers=cfg.num_hidden_layers,
         remat=cfg.remat_policy, params=n_params, batch=[2, 2049],
         mixed_precision="bf16", steps=TRAIN_STEPS, losses=losses,
         train_losses=train["losses"], losses_bit_equal=first_diff is None,
         first_differing_step=first_diff, eval_step_loss=eval0,
         scheduler_count=count, step_ms=step_ms, step_ms_median=med,
         train_step_ms_median=train["step_ms_median"], tokens_per_s=tok_s,
         train_tokens_per_s=train["tokens_per_s"],
         mfu=flops_per_token * tok_s / BF16_FLOPS,
         train_mfu=train["mfu_bf16_peak"], max_memory_allocated_gb=peak_gb,
         train_max_memory_allocated_gb=train["max_memory_allocated_gb"],
         master_params_f32=masters_f32, launches=launches, profile=split,
         train_device_ms_total=train["device_ms_total"],
         call_ms=calls, accumulation=accum)
    want = {"flash_fwd": 2 * TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dq": TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dkv": TRAIN_LAYERS * TRAIN_STEPS}
    if first_diff is not None:
        raise AssertionError(
            f"eager losses differ from phase train's from step "
            f"{first_diff}: {losses} against {train['losses']}")
    if count != TRAIN_STEPS + 1:
        raise AssertionError(f"scheduler count {count}, expected "
                             f"{TRAIN_STEPS + 1}")
    if eval0 != losses[0]:
        raise AssertionError(f"eval_step loss {eval0} against the first "
                             f"training loss {losses[0]}")
    if not masters_f32:
        raise AssertionError("master params left float32")
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected {want}")
    if not accum["ok"]:
        raise AssertionError(f"eager accumulation off the fused step: "
                             f"{accum}")
    # the kernels ran at phase train's shape, [2, 2048, 32, 128] bf16
    # causal: their checks and times are the main rows', measured in this
    # run; the launches are this path's
    for row in [r for r in kernel_rows if r["name"] in want]:
        kernel_rows.append(dict(row, name=f"{row['name']}[eager_train]",
                                launches=launches[row["name"]]))


# ---------------------------------------------------------------------------
# phase 6'': the data pipeline feeding the training step
# ---------------------------------------------------------------------------

DATA_SAMPLES = 64         # samples of 2049 int32 tokens in the corpus file
DATA_SLOW_PREP_S = 0.1    # the slow source's host prep per batch
DATA_SLOW_STEPS = (3, 5)  # its warm-up and measured steps
DATA_STALL_MAX_MS = 10.0  # its input stall per step after the first
DATA_RESIDENT_STEPS = 5   # the loop's steps on a resident batch
BATCH_BYTES = 2 * 2049 * 4


class _SlowSource:
    """A sized batch source whose host prep sleeps `delay` seconds per
    batch (on the loader's prefetch thread, which iterates it)."""

    def __init__(self, source, delay):
        self.source, self.delay = source, delay

    def __len__(self):
        return len(self.source)

    def __iter__(self):
        for batch in self.source:
            time.sleep(self.delay)
            yield batch


def _token_corpus(folder, vocab):
    """The token file: DATA_SAMPLES x 2049 int32 ids below `vocab` from
    `np.random.default_rng(0)` (uint16 cannot hold llama3's 128,256)."""
    import os

    import numpy as np

    from accelerate_tpu_torch import native

    path = os.path.join(folder, "corpus.bin")
    native.write_token_file(path, np.random.default_rng(0).integers(
        0, vocab, DATA_SAMPLES * 2049, dtype=np.int32))
    return path


def _data_reference_losses(cfg, path, n):
    """Phase data_train's step on the first `n` batches of the numpy
    fallback loader, each moved with a plain synchronous `.to("cuda")`,
    from the same init: its losses as floats."""
    import itertools

    import torch

    from accelerate_tpu_torch import native
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.optimizers import adamw
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState

    src = native.TokenCorpusLoader(path, sample_len=2049, batch_size=2,
                                   shuffle=True, seed=0, force_fallback=True)
    batches = [b["input_ids"] for b in itertools.islice(iter(src), n)]
    PartialState._reset_state()
    acc = Accelerator(mixed_precision="bf16", gradient_clipping=1.0)
    state = acc.prepare(TrainState.create(
        apply_fn=None, params=llama.init_params(cfg, 0), tx=adamw(3e-4)))
    step = acc.train_step(lambda p, b: llama.causal_lm_loss(cfg, p, b))
    losses = []
    for ids in batches:
        state, m = step(state, {"input_ids": torch.from_numpy(ids).to(
            "cuda")})
        losses.append(m["loss"])
    out = [float(x) for x in losses]
    del state, step, acc
    _drop()
    return batches, out


def _synced_steps(step, state, batch, n):
    """The loop's step without the loader: `n` steps on one resident
    batch, each followed by the card-wide wait and the loss read the
    loop makes (`StepTimer.tick`, the logged loss), timed with CUDA
    events: what the loop costs before any input stall."""
    import torch

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    marks[0].record()
    for i in range(n):
        state, m = step(state, batch)
        marks[i + 1].record()
        torch.cuda.synchronize()
        float(m["loss"])
    return [marks[i].elapsed_time(marks[i + 1]) for i in range(n)]


def _copy_streams(loader_iter, step, state, tries=3):
    """One step under torch.profiler (device activity only), the next
    batch taken from the prefetching loader while the step runs (so the
    loader issues a copy then, as in training): the CUDA streams of the
    batch-sized host-to-device copies in the window and of the flash
    kernels, with every copy the trace holds. The copy comes after the
    step's first kernels: late in this script, a window that took its
    batch first held the step's own copies in its trace but not the
    batch copy at its very start. A window whose trace holds no batch
    copy is profiled again, up to `tries` windows."""
    import json as _json
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    copies, kernels, seen = set(), set(), []
    batch = next(loader_iter)
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(state, batch)
            batch = next(loader_iter)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = _json.load(f).get("traceEvents", [])
        for ev in events:
            args = ev.get("args") or {}
            name = str(ev.get("name", ""))
            if ev.get("cat") == "gpu_memcpy":
                seen.append([attempt, name, args.get("bytes"),
                             args.get("stream")])
                if "HtoD" in name and args.get("bytes") == BATCH_BYTES:
                    copies.add(args.get("stream"))
            elif ev.get("cat") == "kernel" and "flash_" in name:
                kernels.add(args.get("stream"))
        if copies:
            break
    return {"htod_batch_streams": sorted(copies, key=str),
            "flash_kernel_streams": sorted(kernels, key=str),
            "windows": attempt, "memcpy_events": seen[:24]}


def phase_data_train(kernel_rows, train):
    """The training step of phase `train` (llama3-8B width, 4 layers,
    remat "dots", bf16, clip 1.0, adamw(3e-4), seed 0) fed by the input
    pipeline as a user builds it: a token file, the native
    `TokenCorpusLoader(sample_len=2049, batch_size=2, shuffle=True,
    seed=0)`, `Accelerator(dataloader_config=DataLoaderConfiguration(
    prefetch_size=2, device_prefetch_depth=2), rng_types=["torch"],
    log_with="jsonl")`, `init_trackers`, `prepare` of the state and the
    loader; 1 warm-up and 10 timed steps under a `StepTimer`, each loss
    logged, then `log_telemetry` and `end_training`.

    Gates: the native library built; the 11 losses equal, bit for bit,
    the same step's on the numpy fallback's batches copied synchronously
    (`_data_reference_losses`); flash launches 80/40/40; one profiled
    step's batch copy on a stream other than the flash kernels'; the
    JSONL file's config line, 11 losses and telemetry line with the
    timer's input-stall series; and a second run on a source that sleeps
    DATA_SLOW_PREP_S per batch whose input stall after its first step
    stays under DATA_STALL_MAX_MS. Beside them it times the step on a
    resident batch with the loop's per-step waits and no loader
    (`_synced_steps`), the loop's cost before any input stall."""
    import itertools
    import json as _json
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from accelerate_tpu_torch import native
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.common import count_params
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.optimizers import adamw
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState
    from accelerate_tpu_torch.utils.dataclasses import \
        DataLoaderConfiguration

    cfg = _train_config(TRAIN_LAYERS, remat=True, remat_policy="dots")
    built = native.is_available()
    if not built:
        print(native.build_error(), file=sys.stderr, flush=True)
        raise AssertionError("the native token loader did not build")
    build_s = native.build_info["seconds"]
    folder = tempfile.mkdtemp(prefix="data_train_")
    path = _token_corpus(folder, cfg.vocab_size)
    n = 1 + TRAIN_STEPS
    ref_batches, ref_losses = _data_reference_losses(cfg, path, n)
    orders_equal = all(np.array_equal(a["input_ids"], b) for a, b in zip(
        itertools.islice(iter(native.TokenCorpusLoader(
            path, 2049, 2, shuffle=True, seed=0)), n), ref_batches))

    src = native.TokenCorpusLoader(path, sample_len=2049, batch_size=2,
                                   shuffle=True, seed=0)
    if not src.native:
        raise AssertionError("TokenCorpusLoader fell back to numpy")
    PartialState._reset_state()
    torch.cuda.reset_peak_memory_stats()
    acc = Accelerator(
        mixed_precision="bf16", gradient_clipping=1.0,
        dataloader_config=DataLoaderConfiguration(prefetch_size=2,
                                                  device_prefetch_depth=2),
        rng_types=["torch"], log_with="jsonl", project_dir=folder)
    acc.init_trackers("data_train", config={
        "config": "llama3_8b", "layers": TRAIN_LAYERS, "batch": [2, 2049],
        "corpus_samples": DATA_SAMPLES})
    state = acc.prepare(TrainState.create(
        apply_fn=None, params=llama.init_params(cfg, 0), tx=adamw(3e-4)))
    n_params = count_params(state.params)
    loader = acc.prepare(src)
    step = acc.train_step(lambda p, b: llama.causal_lm_loss(cfg, p, b))
    flops_per_token = 6 * n_params + 12 * cfg.num_hidden_layers * \
        cfg.hidden_size * 2048
    timer = acc.step_timer(flops_per_step=flops_per_token * 4096,
                           tokens_per_step=4096)
    kernels = {"flash_fwd": fa.flash_forward,
               "flash_bwd_dq": fa.flash_backward_dq,
               "flash_bwd_dkv": fa.flash_backward_dkv}
    it = iter(loader)
    losses, stall_ms = [], []
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for i in range(n):
        if i == 1:
            # the main path's run: every count at 0 just before, read
            # just after
            for fn in kernels.values():
                fn.launches = 0
            marks[0].record()
        t0 = time.perf_counter()
        with timer.input_stall():
            batch = next(it)
        stall_ms.append((time.perf_counter() - t0) * 1e3)
        state, m = step(state, batch)
        if i >= 1:
            marks[i].record()
        timer.tick(state)
        acc.log({"loss": m["loss"]}, step=i)
        losses.append(float(m["loss"]))
    launches = {name: fn.launches for name, fn in kernels.items()}
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(n - 1)]
    flat = acc.log_telemetry(step=TRAIN_STEPS)
    acc.end_training()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    resident_ms = _synced_steps(step, state, batch, DATA_RESIDENT_STEPS)
    streams = _copy_streams(it, step, state)
    del it, batch

    slow = acc.prepare(_SlowSource(native.TokenCorpusLoader(
        path, sample_len=2049, batch_size=2, shuffle=True, seed=1),
        DATA_SLOW_PREP_S))
    slow_it = iter(slow)
    slow_stall_ms = []
    for i in range(sum(DATA_SLOW_STEPS)):
        t0 = time.perf_counter()
        batch = next(slow_it)
        slow_stall_ms.append((time.perf_counter() - t0) * 1e3)
        state, m = step(state, batch)
        torch.cuda.synchronize()
    del slow_it, batch, state, step, loader, acc
    _drop()

    with open(os.path.join(folder, "data_train", "metrics.jsonl")) as f:
        lines = [_json.loads(line) for line in f]
    shutil.rmtree(folder, ignore_errors=True)
    configs = [x for x in lines if x["event"] == "config"]
    logged = [x for x in lines if x["event"] == "log" and "loss" in x]
    tele = [x for x in lines if x["event"] == "log"
            and any(k.startswith("telemetry/") for k in x)]
    stall_keys = sorted(k for k in (tele[0] if tele else {})
                        if "input_stall" in k)
    jsonl_ok = (len(configs) == 1 and len(tele) == 1 and
                [x["loss"] for x in logged] == losses and
                [x["step"] for x in logged] == list(range(n)) and
                bool(stall_keys))
    med = float(np.median(step_ms))
    tok_s = 4096 / (med / 1e3)
    first_diff = next((i for i, (a, b) in enumerate(zip(losses, ref_losses))
                       if a != b), None)
    copy_off_stream = bool(streams["htod_batch_streams"]) and not (
        set(streams["htod_batch_streams"]) &
        set(streams["flash_kernel_streams"]))
    slow_after = slow_stall_ms[1:]
    emit("data_train", config="llama3_8b", layers=cfg.num_hidden_layers,
         remat=cfg.remat_policy, params=n_params, batch=[2, 2049],
         corpus=[DATA_SAMPLES, 2049], native_built=built,
         native_build_s=build_s, native_fallback_orders_equal=orders_equal,
         losses=losses, reference_losses=ref_losses,
         losses_bit_equal=first_diff is None,
         first_differing_step=first_diff, train_losses=train["losses"],
         step_ms=step_ms, step_ms_median=med,
         train_step_ms_median=train["step_ms_median"],
         resident_synced_step_ms=resident_ms,
         resident_synced_step_ms_median=float(np.median(resident_ms)),
         tokens_per_s=tok_s, train_tokens_per_s=train["tokens_per_s"],
         mfu=flops_per_token * tok_s / BF16_FLOPS,
         train_mfu=train["mfu_bf16_peak"], input_stall_ms=stall_ms,
         input_stall_ms_mean=float(np.mean(stall_ms[1:])),
         input_stall_ms_max=float(np.max(stall_ms[1:])),
         timer=timer.summary(), max_memory_allocated_gb=peak_gb,
         train_max_memory_allocated_gb=train["max_memory_allocated_gb"],
         launches=launches, streams=streams,
         copy_off_step_stream=copy_off_stream,
         jsonl={"config_lines": len(configs), "loss_lines": len(logged),
                "telemetry_lines": len(tele), "input_stall_keys": stall_keys,
                "ok": jsonl_ok},
         telemetry_keys=len(flat),
         slow_source={"prep_s": DATA_SLOW_PREP_S,
                      "steps": list(DATA_SLOW_STEPS),
                      "input_stall_ms": slow_stall_ms,
                      "input_stall_ms_mean_after_first":
                          float(np.mean(slow_after)),
                      "input_stall_ms_max_after_first":
                          float(np.max(slow_after))})
    want = {"flash_fwd": 2 * TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dq": TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dkv": TRAIN_LAYERS * TRAIN_STEPS}
    if not orders_equal:
        raise AssertionError("native and fallback batches differ")
    if first_diff is not None:
        raise AssertionError(
            f"losses through the loader differ from synchronous feeding from "
            f"step {first_diff}: {losses} against {ref_losses}")
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected {want}")
    if not copy_off_stream:
        raise AssertionError(f"the batch copy is not on a side stream: "
                             f"{streams}")
    if not jsonl_ok:
        raise AssertionError(f"tracker file off: {len(configs)} config, "
                             f"{len(logged)} loss, {len(tele)} telemetry "
                             f"lines, stall keys {stall_keys}")
    if max(slow_after) >= DATA_STALL_MAX_MS:
        raise AssertionError(f"input stall behind a slow source "
                             f"{slow_stall_ms} ms")
    # the kernels ran at phase train's shape, [2, 2048, 32, 128] bf16
    # causal: their checks and times are the main rows', measured in this
    # run; the launches are this path's
    for row in [r for r in kernel_rows if r["name"] in want]:
        kernel_rows.append(dict(row, name=f"{row['name']}[data_train]",
                                launches=launches[row["name"]]))


# ---------------------------------------------------------------------------
# phase 6t: telemetry on the training path
# ---------------------------------------------------------------------------

TELEMETRY_MFU_BAND = 0.10   # cost-table MFU against phase train's


def phase_telemetry_train(kernel_rows, train):
    """Phase train's step (llama3-8B width, 4 layers, remat "dots", bf16,
    clip 1.0, adamw(3e-4), one [2, 2049] batch from seed 0) on an
    Accelerator with `cost_sample_every=1`, `stall_timeout_s=60` and
    `metrics_port=0`: every step after the warm-up is fenced and timed
    into the cost table. Gated: the 11 losses equal phase train's bit for
    bit (a fence changes no arithmetic), the flash launches, the
    analytic cost's FLOPs equal to bench.py's reckoning, the cost-table
    MFU within 10% of phase train's (the fenced step exposes the host's
    issue, so it reads low), and `program_mfu{program="train_step"}` on
    the exporter. Reported: the step time beside phase train's."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.common import count_params
    from accelerate_tpu_torch.optimizers import adamw
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState

    cfg = _train_config(TRAIN_LAYERS, remat=True, remat_policy="dots")
    PartialState._reset_state()
    acc = Accelerator(mixed_precision="bf16", gradient_clipping=1.0,
                      cost_sample_every=1, stall_timeout_s=60,
                      metrics_port=0)
    # the cost table lives on the process registry, where phase train's
    # step (sampled at its call 2) left a `train_step` sample: start the
    # series empty
    acc.telemetry.reset()
    try:
        state = acc.prepare(TrainState.create(
            apply_fn=None, params=llama.init_params(cfg, 0),
            tx=adamw(3e-4)))
        n_params = count_params(state.params)
        (batch,) = list(acc.prepare([{"input_ids": _train_batch(cfg)}]))
        step = acc.train_step(lambda p, b: llama.causal_lm_loss(cfg, p, b))
        state, m = step(state, batch)                     # warm-up
        # the main path's run: every count at 0 just before, read just
        # after
        state, timed, step_ms, launches = _timed_steps(step, state, batch,
                                                       TRAIN_STEPS)
        losses = [float(x) for x in [m["loss"], *timed]]
        sheet = acc.cost_table.roofline("train_step")
        scrape = _scrape(acc.metrics_server.port)
        stalls = acc.stall_watchdog.stall_count
    finally:
        acc.end_training()
    del state, step, batch
    bench_flops = (6 * n_params + 12 * cfg.num_hidden_layers
                   * cfg.hidden_size * 2048) * 2 * 2048
    med = float(np.median(step_ms))
    first_diff = next((i for i, (a, b) in enumerate(zip(losses,
                                                        train["losses"]))
                       if a != b), None)
    emit("telemetry_train", config="llama3_8b",
         layers=cfg.num_hidden_layers, cost_sample_every=1,
         losses=losses, train_losses=train["losses"],
         losses_bit_equal=first_diff is None, launches=launches,
         roofline=sheet, bench_flops=bench_flops,
         cost_table_mfu=sheet.get("mfu"), train_mfu=train["mfu_bf16_peak"],
         cost_table_step_ms_mean=sheet.get("device_time_mean_s", 0.0) * 1e3,
         step_ms=step_ms, step_ms_median=med,
         train_step_ms_median=train["step_ms_median"],
         exporter_has_program_mfu='program_mfu{program="train_step"}'
         in scrape, stalls=stalls)
    want = {"flash_fwd": 2 * TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dq": TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dkv": TRAIN_LAYERS * TRAIN_STEPS}
    failed = [k for k, ok in (
        ("losses", first_diff is None),
        ("launches", launches == want),
        ("cost_source", sheet.get("cost_source") == "analytic"),
        ("flops", sheet.get("flops") == bench_flops),
        ("samples", sheet.get("device_time_samples") == TRAIN_STEPS),
        ("mfu", abs(sheet.get("mfu", 0.0) / train["mfu_bf16_peak"] - 1.0)
         <= TELEMETRY_MFU_BAND),
        ("exporter", 'program_mfu{program="train_step"}' in scrape))
        if not ok]
    if failed:
        raise AssertionError(f"telemetry_train phase failed: {failed}")
    # the kernels ran at phase train's shape, [2, 2048, 32, 128] bf16
    # causal: their checks and times are the main rows', measured in this
    # run; the launches are this path's
    for row in [r for r in kernel_rows if r["name"] in want]:
        kernel_rows.append(dict(row, name=f"{row['name']}[telemetry]",
                                launches=launches[row["name"]]))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 6a: the fp8 training step at llama3-8B width
# ---------------------------------------------------------------------------

FP8_FLOPS = 1979e12         # H100 SXM fp8 dense tensor cores, data sheet
# fp8 against bf16 losses on one batch from one init. Before any update
# (step 0) only the forward differs: the fp8 products' noise moves the
# 12.5-nat loss by thousandths (1.7e-3 on an H100), gated at 0.01. The
# first update takes the loss from 12.5 to a few tenths of a nat on this
# one batch, and the E5M2 gradients (2 mantissa bits) make that update,
# and the curve after it, differ by up to 0.1 nats (0.099 on an H100):
# every later step is gated at 2% of the starting loss (0.25 nats)
FP8_LOSS0_TOL = 0.01
FP8_LOSS_TOL = 0.02
# the tiny step on the card against the same step with the plain
# products on the card, as in tests/test_torch_cuda.py
FP8_TINY_TOL = 5e-3
# the projections of one layer: (name, d_in, d_out) at llama3-8B width
_FP8_PROJ = (("q_proj", 4096, 4096), ("k_proj", 4096, 1024),
             ("v_proj", 4096, 1024), ("o_proj", 4096, 4096),
             ("gate_proj", 4096, 14336), ("up_proj", 4096, 14336),
             ("down_proj", 14336, 4096))


def phase_fp8_train(kernel_rows, bf16):
    """Accelerator(mixed_precision="fp8", clip 1.0) +
    prepare(TrainState(adamw(3e-4), fp8_state=llama.init_fp8_state(cfg)))
    + train_step(causal_lm_loss with fp8_state) at the config, batch and
    init of phase `train`: 1 warm-up step, then 10 timed with CUDA
    events. Every layer projection goes through `_scaled_mm` (forward,
    dX, dW); remat "dots" keeps the forward products, so each launches
    once a step. Then a profiled step by class, the `_scaled_mm` rows of
    the kernel table at the flagship shapes, and a tiny step against the
    plain products on the card."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.common import count_params
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.optimizers import adamw
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState

    cfg = _train_config(TRAIN_LAYERS, remat=True, remat_policy="dots")
    PartialState._reset_state()
    torch.cuda.reset_peak_memory_stats()
    acc = Accelerator(mixed_precision="fp8", gradient_clipping=1.0)
    state = acc.prepare(TrainState.create(
        apply_fn=None, params=llama.init_params(cfg, 0), tx=adamw(3e-4),
        fp8_state=llama.init_fp8_state(cfg)))
    n_params = count_params(state.params)
    loader = acc.prepare([{"input_ids": _train_batch(cfg)}])
    (batch,) = list(loader)
    step = acc.train_step(lambda p, b, fp8_state=None: llama.causal_lm_loss(
        cfg, p, b, fp8_state=fp8_state))
    state, m = step(state, batch)                     # warm-up
    # the main path's run: every count at 0 just before, read just after
    fp8.fp8_gemm.launches.update(fwd=0, dx=0, dw=0)
    state, timed, step_ms, launches = _timed_steps(step, state, batch,
                                                   TRAIN_STEPS)
    launches.update({f"fp8_gemm_{r}": n
                     for r, n in fp8.fp8_gemm.launches.items()})
    losses = [float(x) for x in [m["loss"], *timed]]
    med = float(np.median(step_ms))
    tok_s = 2 * 2048 / (med / 1e3)
    flops_per_token = 6 * n_params + 12 * cfg.num_hidden_layers * \
        cfg.hidden_size * 2048
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    q = state.fp8_state["layers"]["attn"]["q_proj"]["x"]
    hist = state.fp8_state["layers"]["mlp"]["down_proj"]["w"].amax_history
    filled = 1 + TRAIN_STEPS
    metas = {"q_proj_x_scale": q.scale.tolist(),
             "history_shape": list(hist.shape),
             "history_slots_filled": int((hist[0] > 0).sum()),
             "every_window_filled_per_step": all(
                 bool((t.amax_history[:, :filled] > 0).all()
                      and (t.amax_history[:, filled:] == 0).all())
                 for g in state.fp8_state["layers"].values()
                 for pair in g.values() for t in pair.values()),
             "every_scale_moved": all(
                 not bool((t.scale == 1.0).any())
                 for g in state.fp8_state["layers"].values()
                 for pair in g.values() for t in pair.values())}
    split = _profile_fp8_step(step, state, batch)
    del state, step, loader, batch
    _drop()
    rows = _fp8_gemm_rows()
    tiny = _fp8_tiny_parity()
    diffs = [abs(a - b) for a, b in zip(losses, bf16["losses"])]
    loss_tol = FP8_LOSS_TOL * bf16["losses"][0]
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    emit("fp8_train", config="llama3_8b", layers=cfg.num_hidden_layers,
         remat=cfg.remat_policy, params=n_params, batch=[2, 2049],
         mixed_precision="fp8", steps=TRAIN_STEPS, losses=losses,
         bf16_losses=bf16["losses"], loss_diff_step0=diffs[0],
         loss_diff_max=max(diffs), loss_tol_step0=FP8_LOSS0_TOL,
         loss_tol=loss_tol, step_ms=step_ms, step_ms_median=med,
         bf16_step_ms_median=bf16["step_ms_median"], tokens_per_s=tok_s,
         bf16_tokens_per_s=bf16["tokens_per_s"],
         mfu_bf16_peak=flops_per_token * tok_s / BF16_FLOPS,
         bf16_mfu_bf16_peak=bf16["mfu_bf16_peak"],
         max_memory_allocated_gb=peak_gb,
         bf16_max_memory_allocated_gb=bf16["max_memory_allocated_gb"],
         launches=launches, launches_per_step=per_step, metas=metas,
         profile=split, tiny_parity=tiny,
         scaled_mm_rows={r["name"]: {k: r[k] for k in (
             "ms", "library_ms", "plain_ms", "bound_ms", "tflops",
             "max_abs_err")} for r in rows})
    want = {"flash_fwd": 2 * TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dq": TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dkv": TRAIN_LAYERS * TRAIN_STEPS,
            **{f"fp8_gemm_{r}": 7 * TRAIN_LAYERS * TRAIN_STEPS
               for r in ("fwd", "dx", "dw")}}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite fp8 training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"fp8 training loss did not fall: {losses}")
    if diffs[0] > FP8_LOSS0_TOL or max(diffs) > loss_tol:
        raise AssertionError(
            f"fp8 losses {losses} off the bf16 losses {bf16['losses']}")
    if launches != want:
        raise AssertionError(f"fp8 step launches {launches}, expected {want}")
    if not (metas["every_scale_moved"]
            and metas["every_window_filled_per_step"]):
        raise AssertionError(f"fp8 metas did not move: {metas}")
    if split["scaled_mm_calls"] != 3 * 7 * TRAIN_LAYERS:
        raise AssertionError(f"profiled step ran {split['scaled_mm_calls']}"
                             " _scaled_mm kernels")
    if tiny["loss_diff_max"] > FP8_TINY_TOL or not tiny["w_metas_equal"]:
        raise AssertionError(f"tiny fp8 step off its plain version: {tiny}")
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["max_abs_err"] > row["tol"]:
            raise AssertionError(f"{row['name']} off its plain version: "
                                 f"{row}")
    kernel_rows.extend(rows)


def _profile_fp8_step(step, state, batch):
    """Device time of one fp8 step by class (ms), from torch.profiler:
    `_scaled_mm` (fp8 GEMMs), the other GEMMs (the bf16 head), the flash
    kernels, the fp8 casts, amaxes, transposes and meta updates (their
    helpers wrapped in a `record_function` range for this step only),
    and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from accelerate_tpu_torch.ops import fp8

    names = ("_cast8", "_amax", "_transposed", "_padded", "update_meta")
    real = {n: getattr(fp8, n) for n in names}

    def ranged(fn):
        def call(*a, **kw):
            with record_function("fp8.cast_amax"):
                return fn(*a, **kw)
        return call

    torch.cuda.synchronize()
    try:
        for n in names:
            setattr(fp8, n, ranged(real[n]))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, batch)
            torch.cuda.synchronize()
    finally:
        for n in names:
            setattr(fp8, n, real[n])
    total, flash, kernels = 0.0, 0.0, []
    by_op = {}
    for ev in prof.key_averages():
        if ev.key == "fp8.cast_amax":
            # the range, and its span on the device's timeline: kernels
            # are counted by their own rows
            if str(ev.device_type) != "DeviceType.CUDA":
                by_op[ev.key] = (float(ev.device_time_total) / 1e3,
                                 ev.count)
            continue
        if str(ev.device_type) == "DeviceType.CUDA":
            us = float(getattr(ev, "self_device_time_total", 0.0))
            total += us / 1e3
            if "flash_" in ev.key and "_kernel" in ev.key:
                flash += us / 1e3
            kernels.append((us / 1e3, ev.count, ev.key[:90]))
        else:
            by_op[ev.key] = (float(getattr(ev, "device_time_total", 0.0))
                             / 1e3, ev.count)
    kernels.sort(reverse=True)
    scaled = by_op.get("aten::_scaled_mm", (0.0, 0))
    gemm = sum(by_op.get(k, (0.0, 0))[0]
               for k in ("aten::mm", "aten::addmm", "aten::bmm"))
    casts = by_op.get("fp8.cast_amax", (0.0, 0))[0]
    classes = {"fp8_gemm": scaled[0], "bf16_gemm": gemm, "flash": flash,
               "casts_amaxes": casts,
               "rest": total - scaled[0] - gemm - flash - casts}
    return {"device_ms_by_class": classes, "device_ms_total": total,
            "scaled_mm_calls": scaled[1], "top_kernels": kernels[:10]}


def _fp8_gemm_rows():
    """The `_scaled_mm` rows of the kernel table: each product (forward,
    dX, dW) over the seven projections of one layer at the flagship
    shapes (4096 tokens), through the port's wrapper (`ms`), the plain
    version on the card (`plain_ms`), and one bare `torch._scaled_mm` call
    per projection on operands already in its layout (`library_ms`); the
    bound is the larger of the products' operations at the fp8 peak and
    their bytes (fp8 operands read once, bf16 output written once) over
    3.35 TB/s. The error is the wrapper's against the plain version, in
    the largest element's share (bf16 outputs: one rounding, 2^-7)."""
    import torch

    from accelerate_tpu_torch.ops import fp8

    T = 2 * 2048
    gen = torch.Generator(device="cuda").manual_seed(0)

    def cast(shape, fmt, scale):
        t = torch.randn(shape, generator=gen, device="cuda") * scale
        return t.to(fmt)

    one = torch.ones((), device="cuda")
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    # (a [M, K], b_t [N, K]) of each product and projection
    cases = {"fp8_gemm_fwd": [], "fp8_gemm_dx": [], "fp8_gemm_dw": []}
    for _, d, o in _FP8_PROJ:
        cases["fp8_gemm_fwd"].append((cast((T, d), e4, 64.0),
                                      cast((o, d), e4, 64.0)))
        cases["fp8_gemm_dx"].append((cast((T, o), e5, 1e3),
                                     cast((d, o), e4, 64.0)))
        cases["fp8_gemm_dw"].append((cast((d, T), e4, 64.0),
                                     cast((o, T), e5, 1e3)))
    replaces = {"fp8_gemm_fwd": "accelerate_tpu/ops/fp8.py:102",
                "fp8_gemm_dx": "accelerate_tpu/ops/fp8.py:118",
                "fp8_gemm_dw": "accelerate_tpu/ops/fp8.py:123"}
    rows = []
    for name, pairs in cases.items():
        role = name.rsplit("_", 1)[1]
        saved = dict(fp8.fp8_gemm.launches)

        def port(pairs=pairs, role=role):
            return [fp8.fp8_gemm(a, b, one, one, torch.bfloat16, role)
                    for a, b in pairs]

        def plain(pairs=pairs):
            return [fp8.fp8_gemm_reference(a, b, one, one, torch.bfloat16)
                    for a, b in pairs]

        def library(pairs=pairs):
            return [torch._scaled_mm(a, b.t(), scale_a=one, scale_b=one,
                                     out_dtype=torch.bfloat16,
                                     use_fast_accum=False)
                    for a, b in pairs]

        err = 0.0
        for got, want in zip(port(), plain()):
            err = max(err, float((got.float() - want.float()).abs().max()
                                 / want.float().abs().max()))
        ms = cuda_time_ms(port, iters=10)
        plain_ms = cuda_time_ms(plain, iters=2, warmup=1)
        library_ms = cuda_time_ms(library, iters=10)
        fp8.fp8_gemm.launches.update(saved)
        flops = sum(2 * a.shape[0] * a.shape[1] * b.shape[0]
                    for a, b in pairs)
        nbytes = sum(a.numel() + b.numel() + 2 * a.shape[0] * b.shape[0]
                     for a, b in pairs)
        t_ops, t_bytes = flops / FP8_FLOPS, nbytes / HBM_BYTES_PER_S
        rows.append({
            "name": name, "route": "cuda",
            "source": "accelerate_tpu_torch/ops/fp8.py",
            "replaces": replaces[name], "launches": None,
            "max_abs_err": err, "tol": 2.0 ** -7, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
            "scope": "the seven projections of one layer, 4096 tokens; "
                     "max_abs_err in the largest element's share",
            "library_scope": "torch._scaled_mm on operands in its layout",
            "tflops": flops / (ms / 1e3) / 1e12})
    del cases
    return rows


def _fp8_tiny_parity():
    """Three fp8 steps of a tiny llama (head_dim 32, flash attention,
    remat "dots") on the card, with `_scaled_mm` and then with the plain
    products (`fp8_gemm_reference`) on the same card: losses within
    FP8_TINY_TOL, the first step's w metas bit-equal."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.optimizers import adamw
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState, clone_tree

    cfg = llama.LlamaConfig.tiny(hidden_size=128, attention_backend="flash",
                                 remat=True, remat_policy="dots")
    ids = np.random.default_rng(0).integers(0, 256, (4, 33)).astype(np.int32)
    runs = []
    real = fp8.fp8_gemm
    try:
        for plain in (False, True):
            if plain:
                fp8.fp8_gemm = (lambda a, b, sa, sb, dt, role="fwd":
                                fp8.fp8_gemm_reference(a, b, sa, sb, dt))
            PartialState._reset_state()
            acc = Accelerator(mixed_precision="fp8", gradient_clipping=1.0)
            state = acc.prepare(TrainState.create(
                apply_fn=None, params=llama.init_params(cfg, 0),
                tx=adamw(1e-3), fp8_state=llama.init_fp8_state(cfg)))
            step = acc.train_step(
                lambda p, b, fp8_state=None: llama.causal_lm_loss(
                    cfg, p, b, fp8_state=fp8_state))
            losses, first = [], None
            for i in range(3):
                state, m = step(state, {"input_ids": ids})
                losses.append(float(m["loss"]))
                if i == 0:
                    first = clone_tree(state.fp8_state)
            runs.append((losses, first))
    finally:
        fp8.fp8_gemm = real
    (lk, mk), (lp, mp) = runs
    w_equal = all(
        torch.equal(mk["layers"][g][n]["w"].amax_history,
                    mp["layers"][g][n]["w"].amax_history)
        for g in mk["layers"] for n in mk["layers"][g])
    return {"losses_kernel": lk, "losses_plain": lp,
            "loss_diff_max": max(abs(a - b) for a, b in zip(lk, lp)),
            "tol": FP8_TINY_TOL, "w_metas_equal": w_equal}


# ---------------------------------------------------------------------------
# phase 6b: resilient training: save, crash, SIGTERM, resume
# ---------------------------------------------------------------------------

# f32 params at llama3-8B width by depth: a checkpoint (params and two
# AdamW moments) is 12 bytes a param, 17.8 GB at 2 layers, 15.2 GB at 1
RESILIENT_PARAMS = {2: 1.487e9, 1: 1.269e9}
_RAM_FS = "/dev/shm"
RESILIENT_STEPS = 8
RESILIENT_SAVE_EVERY = 3
CRASH_STEP = 5
SIGTERM_STEP = 6


def _meminfo_gb(key: str) -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024 / 1e9
    raise KeyError(key)


def _resilient_place():
    """(layers, directory root, the depth cut or None). Two checkpoints sit
    on disk at once (keep_last_n=1). They go to a RAM filesystem when the
    host's free memory holds them beside the pinned staging copy: the
    card's machine takes at most 45 GiB of disk writes in one run, and
    the phase writes seven checkpoints. Else to TMPDIR. Two layers if
    either holds them, else one, else the phase fails."""
    import os
    import shutil
    import tempfile

    mem = _meminfo_gb("MemAvailable") * 1e9
    for layers in (2, 1):
        ckpt = 12 * RESILIENT_PARAMS[layers]
        cut = None if layers == 2 else (
            "neither RAM nor TMPDIR holds two 2-layer checkpoints")
        if os.path.isdir(_RAM_FS) and mem >= 4 * ckpt and \
                shutil.disk_usage(_RAM_FS).free >= 2 * ckpt:
            return layers, _RAM_FS, cut
        if shutil.disk_usage(tempfile.gettempdir()).free >= 2 * ckpt:
            return layers, tempfile.gettempdir(), cut
    raise AssertionError(
        f"neither {_RAM_FS} with {mem / 1e9:.1f} GB of free memory nor "
        f"{tempfile.gettempdir()} holds two 1-layer checkpoints")


class _ResilientKit:
    """The flagship step of phase `train` at `layers` layers, its state
    made afresh from seed 0 for each run (as a relaunched process would),
    and the one batch of seed 0 at every step."""

    def __init__(self, layers: int):
        from accelerate_tpu_torch.accelerator import Accelerator
        from accelerate_tpu_torch.models import llama
        from accelerate_tpu_torch.state import PartialState

        self.cfg = _train_config(layers, remat=True, remat_policy="dots")
        PartialState._reset_state()
        self.acc = Accelerator(mixed_precision="bf16", gradient_clipping=1.0)
        (self.batch,) = list(self.acc.prepare(
            [{"input_ids": _train_batch(self.cfg)}]))
        step = self.acc.train_step(
            lambda p, b: llama.causal_lm_loss(self.cfg, p, b))
        self.executed = 0

        def step_fn(state, batch):
            self.executed += 1
            return step(state, batch)

        self.step_fn = step_fn

    def state(self):
        from accelerate_tpu_torch.models import llama
        from accelerate_tpu_torch.optimizers import adamw
        from accelerate_tpu_torch.training import TrainState

        _drop()
        return self.acc.prepare(TrainState.create(
            apply_fn=None, params=llama.init_params(self.cfg, 0),
            tx=adamw(3e-4)))

    def batch_fn(self, i):
        return self.batch

    def unfaulted(self) -> list:
        state, losses = self.state(), []
        for i in range(RESILIENT_STEPS):
            state, m = self.step_fn(state, self.batch)
            losses.append(float(m["loss"]))
        del state
        return losses


def _faulted(kit, base: str, blocking: bool):
    """run_resilient with a RuntimeError at step CRASH_STEP (once), SIGTERM
    from on_step at step SIGTERM_STEP, then (async saves only) the
    relaunch to the end. Every loss recorded (re-run steps too),
    per-save stage seconds, the reports."""
    import os
    import signal

    from accelerate_tpu_torch.profiler import StepTimer
    from accelerate_tpu_torch.telemetry import get_registry
    from accelerate_tpu_torch.training import run_resilient

    stage = get_registry().histogram("checkpoint_stage_seconds")
    recorded, stages, armed = [], [], {"crash": True, "term": True}
    seen = {"count": stage.count, "sum": stage.sum}

    def on_step(i, state, metrics):
        if stage.count != seen["count"]:    # a save staged since the last
            stages.append(stage.sum - seen["sum"])
            seen.update(count=stage.count, sum=stage.sum)
        if armed["crash"] and i == CRASH_STEP:
            armed["crash"] = False
            raise RuntimeError("injected step-time fault")
        recorded.append((i, float(metrics["loss"])))
        if armed["term"] and i == SIGTERM_STEP:
            armed["term"] = False
            os.kill(os.getpid(), signal.SIGTERM)

    reports = []
    # the run, then its relaunch; with blocking saves the run alone: its
    # goodput is the comparison, and at 1 GB/s a relaunch's restore and
    # final save would add half a minute that measures nothing new
    for _ in range(1 if blocking else 2):
        timer = StepTimer(warmup_steps=1, name="resilient_step")
        rep = run_resilient(
            kit.acc, kit.state(), kit.step_fn, kit.batch_fn,
            RESILIENT_STEPS, base, save_every=RESILIENT_SAVE_EVERY,
            keep_last_n=1, timer=timer, blocking_saves=blocking,
            on_step=on_step)
        rep.state = None    # 17.8 GB on the card: the next run makes its own
        reports.append(rep)
        _drop()
    return recorded, stages, reports


def phase_resilient():
    """Checkpointing and resilient training on the card: the flagship bf16
    step (phase `train`'s) at llama3-8B width, 2 layers, through
    `run_resilient` with async saves every 3 steps and `keep_last_n=1`:
    a crash at step 5 rolls back to the step-3 commit, SIGTERM at step 6
    drains and commits, and a relaunch resumes there and finishes. Gates:
    two unfaulted runs agree bit for bit, and every loss the faulted runs
    record equals the unfaulted run's for its step; one resume and a
    preemption in the first call, a complete manifest at the end; K1a,
    K1b and K1c launched 2·L, L and L times per executed step (re-run
    steps counted). Then the same schedule with blocking saves, up to
    the drain commit, for goodput."""
    import os
    import shutil
    import tempfile

    from accelerate_tpu_torch import checkpointing as ckpt
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.telemetry import get_registry

    layers, root, cut = _resilient_place()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resilient_", dir=root)
    try:
        disk = shutil.disk_usage(tmp)
        emit("resilient_setup", dir=tmp, ram_backed=root == _RAM_FS,
             disk_total_gb=disk.total / 1e9, disk_free_gb=disk.free / 1e9,
             mem_total_gb=_meminfo_gb("MemTotal"),
             mem_available_gb=_meminfo_gb("MemAvailable"), layers=layers,
             depth_cut=cut)
        kit = _ResilientKit(layers)
        t0 = time.perf_counter()
        unfaulted = [kit.unfaulted(), kit.unfaulted()]
        spread = max(abs(a - b) for a, b in zip(*unfaulted))
        reg = get_registry()
        reg.reset()
        out = {}
        for label, blocking in (("async", False), ("blocking", True)):
            base = os.path.join(tmp, label)
            fa.flash_forward.launches = 0
            fa.flash_backward_dq.launches = 0
            fa.flash_backward_dkv.launches = 0
            kit.executed = 0
            recorded, stages, reports = _faulted(kit, base, blocking)
            rep, relaunch = reports[0], reports[-1]
            launches = {"flash_fwd": fa.flash_forward.launches,
                        "flash_bwd_dq": fa.flash_backward_dq.launches,
                        "flash_bwd_dkv": fa.flash_backward_dkv.launches}
            final = ckpt.latest_complete_checkpoint(base)
            ckpt_bytes = os.path.getsize(
                os.path.join(final, "model_0.safetensors"))
            out[label] = dict(
                recorded=recorded, stage_s=stages, launches=launches,
                executed_steps=kit.executed, report=rep,
                relaunch=relaunch, final=final, ckpt_bytes=ckpt_bytes,
                saves=sum(r.saves for r in reports),
                snapshot=reg.snapshot())
            reg.reset()
            shutil.rmtree(base)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def hist(snap, name):
        h = snap["histograms"].get(name, {})
        return {k: h.get(k) for k in ("count", "sum", "mean", "min", "max")}

    rows = {}
    for label, r in out.items():
        snap = r["snapshot"]
        write = hist(snap, "checkpoint_write_seconds")
        rows[label] = {
            "losses": r["recorded"], "executed_steps": r["executed_steps"],
            "launches": r["launches"],
            "resumes": r["report"].resumes, "saves": r["saves"],
            "preempted": r["report"].preempted,
            "relaunched": r["relaunch"] is not r["report"],
            "final_commit": os.path.basename(r["final"]),
            "checkpoint_bytes": r["ckpt_bytes"],
            "stage_s_per_save": r["stage_s"],
            "checkpoint_stage_seconds": hist(snap,
                                             "checkpoint_stage_seconds"),
            "checkpoint_write_seconds": write,
            "write_gb_per_s": (write["count"] * r["ckpt_bytes"] / 1e9
                               / write["sum"]) if write["count"] else None,
            "checkpoint_drain_seconds": hist(snap,
                                             "checkpoint_drain_seconds"),
            "checkpoint_save_seconds": hist(snap, "checkpoint_save_seconds"),
            "resume_latency_seconds": hist(snap, "resume_latency_seconds"),
            "goodput": r["report"].goodput,
            "stall_taxonomy": r["report"].taxonomy,
        }
    emit("resilient", config="llama3_8b", layers=layers,
         ram_backed=root == _RAM_FS,
         remat="dots", batch=[2, 2049], mixed_precision="bf16",
         steps=RESILIENT_STEPS, save_every=RESILIENT_SAVE_EVERY,
         keep_last_n=1, crash_step=CRASH_STEP, sigterm_step=SIGTERM_STEP,
         unfaulted_losses=unfaulted[0], run_to_run_max_abs=spread,
         deterministic=spread == 0.0, wall_s=wall, **rows)

    for label, r in out.items():
        # the run executes steps 0..CRASH_STEP, re-runs from the commit at
        # SAVE_EVERY through SIGTERM_STEP; the relaunch runs the rest
        last = RESILIENT_STEPS if label == "async" else SIGTERM_STEP + 1
        want_steps = last + (CRASH_STEP + 1 - RESILIENT_SAVE_EVERY)
        for i, loss in r["recorded"]:
            if abs(loss - unfaulted[0][i]) > spread:
                raise AssertionError(
                    f"{label}: step {i} loss {loss!r}, unfaulted "
                    f"{unfaulted[0][i]!r} (run-to-run spread {spread})")
        if sorted({i for i, _ in r["recorded"]}) != list(range(last)):
            raise AssertionError(f"{label}: steps recorded {r['recorded']}")
        rep, relaunch = r["report"], r["relaunch"]
        if rep.resumes != 1 or not rep.preempted or \
                rep.steps_completed != SIGTERM_STEP + 1:
            raise AssertionError(f"{label}: report {rep}")
        if label == "async" and (
                relaunch.start_step != SIGTERM_STEP + 1
                or relaunch.steps_completed != RESILIENT_STEPS):
            raise AssertionError(f"{label}: relaunch {relaunch}")
        if os.path.basename(r["final"]) != f"step_{last:08d}":
            raise AssertionError(f"{label}: final commit {r['final']}")
        want = {"flash_fwd": 2 * layers * want_steps,
                "flash_bwd_dq": layers * want_steps,
                "flash_bwd_dkv": layers * want_steps}
        if r["executed_steps"] != want_steps or r["launches"] != want:
            raise AssertionError(
                f"{label}: {r['executed_steps']} steps, launches "
                f"{r['launches']}, expected {want_steps} and {want}")
    if not unfaulted[0][-1] < unfaulted[0][0]:
        raise AssertionError(f"training loss did not fall: {unfaulted[0]}")


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


# ---------------------------------------------------------------------------
# the model zoo: tiny engines of every causal family, GPT-J-6B served,
# Mixtral-8x7B width trained
# ---------------------------------------------------------------------------

ZOO = {"gpt2": "GPT2Config", "gptj": "GPTJConfig",
       "gpt_neox": "GPTNeoXConfig", "opt": "OPTConfig"}


def phase_zoo_small_parity():
    """Each causal family's tiny config (head dims 16, G=1) under the
    default engine config: on the card "auto" runs the paged kernel, on
    the CPU the dense-gather path, from the same f32 weights; greedy
    streams identical, logprobs within 1e-3."""
    import importlib

    import numpy as np
    import torch

    from accelerate_tpu_torch.models.convert import params_from_numpy, \
        params_to_numpy
    from accelerate_tpu_torch.ops.paged_attention import \
        paged_decode_attention
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    results, bad = {}, []
    kw = dict(num_slots=3, max_len=96, prefill_chunk=8, page_size=16,
              cache_dtype=torch.float32)
    for name, cfg_name in ZOO.items():
        mod = importlib.import_module(f"accelerate_tpu_torch.models.{name}")
        cfg = getattr(mod, cfg_name).tiny()
        params = mod.init_params(cfg, 0)
        cpu_params = params_from_numpy(params_to_numpy(params), device="cpu")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (6, 13, 9, 40, 21)]
        temps, keys = [0.0] * len(prompts), list(range(len(prompts)))
        before = paged_decode_attention.launches
        card = _serve(Engine(mod, cfg, params, EngineConfig(**kw)), prompts,
                      temps, 8, keys)
        launches = paged_decode_attention.launches - before
        host = _serve(Engine(mod, cfg, cpu_params, EngineConfig(**kw),
                             device="cpu"), prompts, temps, 8, keys)
        same = [a.tokens for a in card] == [b.tokens for b in host]
        lp_err = max(abs(x - y) for a, b in zip(card, host)
                     for x, y in zip(a.logprobs, b.logprobs))
        results[name] = {"head_dim": cfg.head_dim,
                         "paged_decode_launches": launches,
                         "tokens_identical": same,
                         "logprob_max_abs_err": lp_err}
        if not same or lp_err > 1e-3 or launches == 0:
            bad.append(name)
    emit("zoo_small_parity", paged_attention="auto", families=results,
         logprob_tol=1e-3)
    if bad:
        raise AssertionError(f"card engines off the CPU engines, or no "
                             f"paged kernel ran: {bad}")


def _paged_row(path, launches, **shape):
    """K2 at one path's shapes (bf16 pool, no window, the serving
    lengths): checked against its plain version, then timed beside its
    plain version, its bound and SDPA over pre-gathered K/V."""
    import torch

    from accelerate_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_reference)

    q, kn, vn, pk, pv, meta, lengths = _paged_inputs(torch.bfloat16,
                                                     **shape)
    out, (kr, vr) = paged_decode_attention(q, kn, vn, pk, pv, meta)
    ref, (rk, rv) = paged_decode_reference(q, kn, vn, pk, pv, meta)
    torch.cuda.synchronize()
    err = _max_abs(out, ref)
    if not (err <= 2e-2 and torch.equal(kr, rk) and torch.equal(vr, rv)):
        raise AssertionError(f"paged_decode off its plain version at "
                             f"{path}'s shapes: {err}")
    row = {"name": f"paged_decode[{path}]", "route": "cuda",
           "source": "accelerate_tpu_torch/csrc/paged_decode.cu",
           "replaces": "accelerate_tpu/ops/paged_attention.py:157",
           "launches": launches, "max_abs_err": err,
           **_paged_times(q, kn, vn, pk, pv, meta, lengths),
           "library_scope": "scaled_dot_product_attention over K/V "
                            "gathered from the pages beforehand",
           "shape": {"S": q.shape[0], "Hkv": kn.shape[2],
                     "G": q.shape[2] // kn.shape[2], "D": q.shape[-1],
                     "page_size": pk.data.shape[1], "pool": "bfloat16",
                     "lengths": lengths}}
    emit("kernel_time_path", **row)
    return row


GPTJ_CHECK_LAYERS = 4


def phase_gptj_engine(kernel_rows):
    """GPT-J-6B as published (28 layers, hidden 4096, 16 heads of 256, no
    GQA, rotary 64, vocab 50400), random bf16 weights from seed 0, served
    by the engine with its programs as CUDA graphs through the paged
    kernel at D=256, G=1: phase `engine`'s 12 requests and config. Gated:
    every request finishes, a prefix hit, K2's launches equal decode
    steps x 28 (counted through replays), every program captured once,
    greedy streams identical to the eager engine's; then one decode step
    through the kernel and the dense-gather path at 4 layers in f32
    activations, and K2 at these shapes against its plain version."""
    import dataclasses

    import numpy as np
    import torch

    from accelerate_tpu_torch.models import gptj
    from accelerate_tpu_torch.models.common import count_params
    from accelerate_tpu_torch.ops.paged_attention import \
        paged_decode_attention
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    cfg = gptj.GPTJConfig()
    t0 = time.perf_counter()
    params = gptj.init_params(cfg, 0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ec = EngineConfig(cache_dtype=torch.bfloat16, paged_attention=True,
                      **ENGINE_CONFIG)
    eng = Engine(gptj, cfg, params, ec)
    prompts = _prompts(np.random.default_rng(0), cfg.vocab_size)
    temps = [0.0 if i % 2 == 0 else 0.8 for i in range(12)]
    torch.cuda.reset_peak_memory_stats()
    # the path's run: the count at 0 just before, read just after
    paged_decode_attention.launches = 0
    reqs, decode_s, prefill_s, run_s = _drive(eng, prompts, temps)
    launches = paged_decode_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = eng.metrics_summary()
    steps = eng.metrics.decode_steps
    stats = eng.compile_stats()
    capture_s = eng._graphs.capture_seconds()
    del eng
    eager = Engine(gptj, cfg, params, ec, _graphs=False)
    ereqs, edecode_s, _, erun_s = _drive(eager, prompts, temps)
    del eager
    _drop()
    greedy = [i for i, t in enumerate(temps) if t == 0.0]
    greedy_same = all(reqs[i].tokens == ereqs[i].tokens for i in greedy)
    decode_tokens = sum(len(r.tokens) for r in reqs) - len(reqs)
    kvd = _gptj_kernel_vs_dense(dataclasses.replace(
        cfg, num_hidden_layers=GPTJ_CHECK_LAYERS),
        _truncated(params, GPTJ_CHECK_LAYERS))
    emit("gptj_engine", config="GPTJConfig() (GPT-J-6B)",
         layers=cfg.num_hidden_layers, head_dim=cfg.head_dim,
         params=count_params(params), params_init_s=init_s, graphs=True,
         requests=len(reqs),
         prompt_tokens=int(sum(len(p) for p in prompts)),
         finished=len(reqs) - len(_finished(reqs, cfg.vocab_size)),
         decode_steps=steps, paged_decode_launches=launches,
         compile_stats=stats, capture_s=capture_s,
         prefill_chunks=summary["prefill_chunks"],
         prefix_hit_rate=summary.get("prefix_hit_rate"),
         ttft_p50_ms=summary.get("ttft_p50_ms"),
         ttft_p99_ms=summary.get("ttft_p99_ms"),
         decode_step_ms_median=float(np.median(decode_s)) * 1e3,
         decode_step_ms_mean=float(np.mean(decode_s)) * 1e3,
         prefill_chunk_ms_median=float(np.median(prefill_s)) * 1e3,
         decode_tokens_per_s=decode_tokens / sum(decode_s),
         tokens_per_s=sum(len(r.tokens) for r in reqs) / run_s, run_s=run_s,
         eager_decode_step_ms_median=float(np.median(edecode_s)) * 1e3,
         eager_run_s=erun_s, greedy_streams_identical=greedy_same,
         kernel_vs_dense=kvd, max_memory_allocated_gb=peak_gb)
    bad = _finished(reqs, cfg.vocab_size) + _finished(ereqs, cfg.vocab_size)
    if bad:
        raise AssertionError(f"requests {bad} did not finish with 32 tokens")
    if not summary.get("prefix_hit_rate", 0.0) > 0:
        raise AssertionError("no prefix-cache hit on the shared prefix")
    if launches != steps * cfg.num_hidden_layers or launches == 0:
        raise AssertionError(f"paged_decode launched {launches} times for "
                             f"{steps} decode steps x 28 layers")
    if stats != {"admit": 1, "prefill": 1, "decode": 1}:
        raise AssertionError(f"programs not captured once each: {stats}")
    if not greedy_same:
        raise AssertionError("graphed greedy streams differ from eager")
    if not (kvd["logits_rel_l2"] <= 2e-2 and kvd["finite"]):
        raise AssertionError(f"kernel path logits off the dense path: {kvd}")
    del params
    _drop()
    kernel_rows.append(_paged_row("gptj_engine", launches, Hkv=16, G=1,
                                  D=256))


def _gptj_kernel_vs_dense(cfg, params):
    """From one pool state (8 slots at 200-1800 rows) of a GPT-J engine
    cut to its first layers, one decode step through the kernel path and
    the dense-gather path: the logits' distance in f32 activations (an
    f32 embedding; bf16 weights and pool, upcast as read), gated by the
    caller, and in bf16 beside it."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import gptj
    from accelerate_tpu_torch.serving import Engine, EngineConfig, SlotState

    eng = Engine(gptj, cfg, params, EngineConfig(
        cache_dtype=torch.bfloat16, paged_attention=True, **ENGINE_CONFIG),
        _graphs=False)
    rng = np.random.default_rng(1)
    for n in (200, 400, 700, 900, 1100, 1300, 1500, 1800):
        eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=200)
    while not all(s.state is SlotState.DECODE for s in eng.scheduler.slots):
        eng.step()
    table = _device_table(eng)
    kern, _, _ = eng._decode_forward(True, table)
    dense, _, _ = eng._decode_forward(False, table)
    eng.params = {**params, "wte": {
        "embedding": params["wte"]["embedding"].float()}}
    kern32, _, _ = eng._decode_forward(True, table)
    dense32, _, _ = eng._decode_forward(False, table)
    out = {"layers": cfg.num_hidden_layers,
           "lengths": eng.cache.lengths.tolist(),
           "logits_rel_l2": _rel_l2(kern32, dense32), "tol": 2e-2,
           "activations": "float32",
           "bf16_logits_rel_l2": _rel_l2(kern, dense),
           "greedy_agree_bf16": int((kern.argmax(-1)
                                     == dense.argmax(-1)).sum()),
           "finite": bool(torch.isfinite(kern32).all()
                          and torch.isfinite(kern).all())}
    del eng
    _drop()
    return out


MIXTRAL_LAYERS = 2    # full width; 2 layers' f32 state is about 51 GB
MIXTRAL_STEPS = 5


def _mixtral_run(cfg, batch):
    """One Accelerator(bf16, clip 1.0) + adamw(3e-4, weight_decay=1e-4)
    training run of `cfg` on `batch` from seed 0: a warm-up step, then
    MIXTRAL_STEPS timed with CUDA events, the flash launch counts at 0
    just before them and read just after."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import mixtral
    from accelerate_tpu_torch.models.common import count_params
    from accelerate_tpu_torch.optimizers import adamw
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState

    PartialState._reset_state()
    torch.cuda.reset_peak_memory_stats()
    acc = Accelerator(mixed_precision="bf16", gradient_clipping=1.0)
    state = acc.prepare(TrainState.create(
        apply_fn=None, params=mixtral.init_params(cfg, 0),
        tx=adamw(3e-4, weight_decay=1e-4)))
    n_params = count_params(state.params)
    (b,) = list(acc.prepare([{"input_ids": batch}]))
    step = acc.train_step(lambda p, bt: mixtral.causal_lm_loss(cfg, p, bt))
    state, m = step(state, b)                          # warm-up
    state, timed, step_ms, launches = _timed_steps(step, state, b,
                                                   MIXTRAL_STEPS)
    losses = [m["loss"], *timed]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split = _profile_train_step(step, state, b)
    del state, step, b
    med = float(np.median(step_ms))
    S = batch.shape[1] - 1
    tok_s = batch.shape[0] * S / (med / 1e3)
    L, E, k = (cfg.num_hidden_layers, cfg.num_local_experts,
               cfg.num_experts_per_tok)
    # the parameters one token passes through: all but the E - k experts
    # it is not routed to, in each layer
    n_active = n_params - L * (E - k) * 3 * cfg.hidden_size * \
        cfg.intermediate_size
    flops_per_token = 6 * n_active + 12 * L * cfg.hidden_size * S
    return {"moe_impl": cfg.moe_impl, "params": n_params,
            "active_params": n_active, "losses": [float(x) for x in losses],
            "step_ms": step_ms, "step_ms_median": med, "tokens_per_s": tok_s,
            "mfu_active_params": flops_per_token * tok_s / BF16_FLOPS,
            "max_memory_allocated_gb": peak_gb, "launches": launches,
            "profile": split}


def phase_mixtral_train(kernel_rows):
    """`MixtralConfig.mixtral_8x7b(num_hidden_layers=2, remat=True)`
    trained at full width through the Accelerator (bf16, clip 1.0,
    adamw(3e-4) with weight_decay=1e-4), batch [1, 2049] from seed 0:
    attention through the flash kernels ("auto" at S=2048), the experts
    with moe_impl "dense", then "sparse" (at S=2048 the one-hot would be
    2048*2*8*640 = 21 M elements, over the reference's 16 Mi threshold,
    so the sort dispatch runs). Gated: losses finite and falling, K1a/b/c
    2L/L/L launches a step (remat reruns the forward). Then a tiny
    Mixtral step on the card against the CPU, sparse at full capacity
    against dense in f32 (the sort path), and K1a/b/c at this path's
    shape against their plain versions, timed."""
    import dataclasses

    import numpy as np

    from accelerate_tpu_torch.models import mixtral

    cfg = mixtral.MixtralConfig.mixtral_8x7b(
        num_hidden_layers=MIXTRAL_LAYERS, remat=True)
    batch = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 2049)).astype(np.int32)
    runs = []
    for impl in ("dense", "sparse"):
        runs.append(_mixtral_run(dataclasses.replace(cfg, moe_impl=impl),
                                 batch))
        _drop()
    want = {"flash_fwd": 2 * MIXTRAL_LAYERS * MIXTRAL_STEPS,
            "flash_bwd_dq": MIXTRAL_LAYERS * MIXTRAL_STEPS,
            "flash_bwd_dkv": MIXTRAL_LAYERS * MIXTRAL_STEPS}
    tiny = _mixtral_tiny_parity()
    svd = _mixtral_sparse_vs_dense()
    emit("mixtral_train", config="mixtral_8x7b", layers=MIXTRAL_LAYERS,
         remat="full", batch=[1, 2049], mixed_precision="bf16",
         steps=MIXTRAL_STEPS, runs=runs, launches_per_run_expected=want,
         mfu_note="6 x active params (attention, router, embeddings, head "
                  "and 2 of 8 experts a layer) + 12 L h s, over the bf16 "
                  "peak; the dense path computes all 8 experts",
         tiny_card_vs_cpu=tiny, sparse_vs_dense_f32=svd)
    for r in runs:
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"non-finite loss: {r['losses']}")
        if not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"loss did not fall: {r['losses']}")
        if r["launches"] != want:
            raise AssertionError(f"flash launches {r['launches']} for "
                                 f"{r['moe_impl']}, expected {want}")
    if not tiny["ok"]:
        raise AssertionError(f"tiny Mixtral step off the CPU: {tiny}")
    if not svd["ok"]:
        raise AssertionError(f"sparse at full capacity off dense: {svd}")
    launches = {n: sum(r["launches"][n] for r in runs) for n in want}
    kernel_rows.extend(_flash_rows_at("mixtral_train", launches,
                                      1, 2048, 32, 128))


def _flash_rows_at(path, launches, B, S, H, D, causal=True):
    """K1a/b/c at one path's bf16 shape: outputs and gradients against
    the plain versions in f32 (the flash checks' tolerances), then timed
    (`_flash_times`), as rows named for the path."""
    import torch

    q, k, v, do, _ = _flash_inputs(B, S, H, D, None, torch.bfloat16, 77)
    o, lse, err, finite = _flash_errors(q, k, v, do, causal)
    tol = FLASH_TOL["bfloat16"]
    ok = finite and all(err[n] <= t for n, t in tol.items())
    emit("flash_check", case=path, dtype="bfloat16", B=B, S=S, H=H, D=D,
         causal=causal, key_mask=None, window=None, err=err, tol=tol,
         finite=finite, ok=ok)
    if not ok:
        raise AssertionError(f"flash kernels off their plain versions at "
                             f"{path}'s shape: {err}")
    rows = _flash_times(q, k, v, do, o, lse, err, causal)
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["name"] = f"{row['name']}[{path}]"
        row["shape"] = [B, S, H, D]
        row["causal"] = causal
    return rows


def _mixtral_tiny_parity():
    """Two f32 steps of a tiny Mixtral (the flash backend, sparse
    dispatch) through the Accelerator on the card and with cpu=True:
    losses within 1e-5, params within 1e-4 (tests/test_torch_cuda.py)."""
    import numpy as np

    from accelerate_tpu_torch import optimizers as to
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import mixtral
    from accelerate_tpu_torch.models.convert import params_from_numpy, \
        params_to_numpy
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState

    cfg = mixtral.MixtralConfig.tiny(hidden_size=128, moe_impl="sparse",
                                     attention_backend="flash", remat=True)
    init = params_to_numpy(mixtral.init_params(cfg, 0, device="cpu"))
    ids = np.random.default_rng(0).integers(0, 256, (2, 65)).astype(np.int32)
    results = []
    for cpu in (False, True):
        PartialState._reset_state()
        acc = Accelerator(gradient_clipping=1.0, cpu=cpu)
        state = acc.prepare(TrainState.create(
            apply_fn=None, params=params_from_numpy(init, device=acc.device),
            tx=to.adamw(1e-3, weight_decay=0.0)))
        step = acc.train_step(lambda p, b: mixtral.causal_lm_loss(cfg, p, b))
        losses = []
        for _ in range(2):
            state, m = step(state, {"input_ids": ids})
            losses.append(float(m["loss"]))
        results.append((losses, to.tree_leaves(
            params_to_numpy(state.params))))
    PartialState._reset_state()
    (l_gpu, p_gpu), (l_cpu, p_cpu) = results
    loss_err = max(abs(a - b) for a, b in zip(l_gpu, l_cpu))
    param_err = max(float(np.abs(a - b).max()) for a, b in zip(p_gpu, p_cpu))
    return {"losses_card": l_gpu, "losses_cpu": l_cpu,
            "loss_max_abs_err": loss_err, "param_max_abs_err": param_err,
            "loss_tol": 1e-5, "param_tol": 1e-4,
            "ok": loss_err <= 1e-5 and param_err <= 1e-4}


def _mixtral_sparse_vs_dense():
    """Narrow Mixtral (8 experts, top 2) at S=2048 in f32 on the card:
    moe_impl "sparse" with capacity_factor 8 (C = S k: nothing drops;
    the sort dispatch) against "dense", from the same params. Gated as
    tests/test_torch_moe.py: logits rtol 2e-4 atol 2e-5, aux rtol 1e-5."""
    import dataclasses

    import torch

    from accelerate_tpu_torch.models import mixtral

    dense_cfg = mixtral.MixtralConfig.tiny(
        hidden_size=256, intermediate_size=512, num_local_experts=8,
        max_position_embeddings=2048, attention_backend="einsum")
    sparse_cfg = dataclasses.replace(dense_cfg, moe_impl="sparse",
                                     capacity_factor=8.0)
    params = mixtral.init_params(dense_cfg, 1)
    ids = torch.randint(0, 256, (1, 2048), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
    cap = 2 * 2048
    sort_path = 2048 * 2 * 8 * cap > mixtral._ONEHOT_DISPATCH_MAX_ELEMENTS
    d_logits, d_aux = mixtral.forward(dense_cfg, params, ids)
    s_logits, s_aux = mixtral.forward(sparse_cfg, params, ids)
    ok_logits = bool(torch.allclose(s_logits, d_logits, rtol=2e-4,
                                    atol=2e-5))
    aux_rel = abs(float(s_aux) - float(d_aux)) / abs(float(d_aux))
    return {"S": 2048, "capacity": cap, "sort_dispatch": sort_path,
            "logits_max_abs_err": _max_abs(s_logits, d_logits),
            "aux_rel_err": aux_rel,
            "ok": ok_logits and aux_rel <= 1e-5 and sort_path}


# ---------------------------------------------------------------------------
# phase 10: big_model
# ---------------------------------------------------------------------------

# the planner's budgets: the card and host memory hold only part of
# llama3-8B (16.1 GB in bf16), so its layer rows land on all three tiers
BIG_MODEL_MAX_MEMORY = {0: "8GiB", "cpu": "6GiB"}
BIG_MODEL_DISK_BYTES = 24e9   # the checkpoint, the offload files, headroom
# loading may hold the pinned CPU tier, one checkpoint tensor, and the
# 64 MiB staging buffers and allocator slack around them: not the
# 16.1 GB checkpoint
BIG_MODEL_RSS_SLACK = 1e9
BIG_MODEL_NEW_TOKENS = 16
BIG_MODEL_PROMPT = 128
BIG_MODEL_FORWARD = 2048
# the streamed forward runs the resident forward's kernels on the same
# bf16 weights in the same order: the logits should agree to the bit
BIG_MODEL_LOGITS_TOL = 1e-3   # relative L2
# dequantized weights against bf16: the rounding error of one block of
# 128 N(0, s) values is about absmax / qmax / sqrt(12), 0.6% (int8) and
# 11% (int4) of s; logits after one full-width layer (embedding and
# layer quantized, head not) are gated, the 32-layer logits printed:
# random weights amplify a small change layer by layer until the logits
# of any two models decorrelate (a narrow CPU model: 0.05 and 0.7 after
# one layer, 0.2 and 1.1 after eight)
BIG_MODEL_QUANT_WEIGHT_TOL = {8: 0.01, 4: 0.15}
BIG_MODEL_QUANT_LOGITS_TOL = {8: 0.1, 4: 0.9}
# a real out-of-memory error: the first attempt asks for 128 GiB
BIG_MODEL_OOM_START = 128


class _RssPeak:
    """The host's resident set of this process, sampled every 5 ms on a
    thread while the block runs: `base` before, `peak` during (bytes);
    with the smallest MemAvailable seen beside the starting one."""

    def __enter__(self):
        import os
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self.base = self.peak = self._rss()
        self.avail_base = self.avail_min = _meminfo_gb("MemAvailable")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())
            self.avail_min = min(self.avail_min,
                                 _meminfo_gb("MemAvailable"))

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        self.peak = max(self.peak, self._rss())
        return False


def _tier_bytes(tree) -> dict:
    """Bytes of a dispatched tree by tier ("device", "cpu", "disk")."""
    import torch

    from accelerate_tpu_torch.big_modeling import RowGroups

    out = {"device": 0, "cpu": 0, "disk": 0}

    def add(leaf):
        if isinstance(leaf, dict):
            for v in leaf.values():
                add(v)
        elif isinstance(leaf, RowGroups):
            for (_, _, t), tier in zip(leaf.groups, leaf.tiers):
                out[tier] += t.numel() * t.element_size()
        elif isinstance(leaf, torch.Tensor):
            tier = "device" if leaf.is_cuda else (
                "cpu" if leaf.is_pinned() else "disk")
            out[tier] += leaf.numel() * leaf.element_size()

    add(tree)
    return out


def _pinned_h2d_gb_per_s(nbytes=1 << 30, reps=5) -> float:
    """The host-to-card rate of one pinned copy of `nbytes`, CUDA events
    around `reps` copies."""
    import torch

    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_time_ms(lambda: dst.copy_(src, non_blocking=True), iters=reps,
                      warmup=1)
    return nbytes / ms / 1e6


def phase_big_model(kernel_rows):
    """Big-model inference at llama3-8B width and depth (bf16, random
    weights from seed 0) through `big_modeling`: a sharded safetensors
    checkpoint written by the port's writer (on TMPDIR's disk, checked
    for room first), `init_empty_weights` (no bytes on the card), a
    device map planned for {0: 8 GiB, cpu: 6 GiB} (device, pinned host
    and disk rows), `load_checkpoint_and_dispatch` (load time, peak host
    RSS), greedy `llama.streamed_generate` (prompt 128, 16 new tokens;
    twice, the second call the steady one) against the resident
    `generate` (tokens identical; s/token, GB/token,
    H2D rate beside a pinned copy's, share of the copying hidden under
    compute), `llama.forward_offloaded` at 2048 tokens against the
    resident forward (K1a once per streamed layer), int8 and int4
    `load_and_quantize_params` (sizes, codes bit-equal to the host's
    `quantize`, dequantized weights and logits against bf16),
    `find_executable_batch_size` recovering from a real out-of-memory
    error, and every family's tiny `streamed_generate` against its
    `generate`."""
    import shutil
    import tempfile

    root = tempfile.gettempdir()
    free = shutil.disk_usage(root).free
    if free < BIG_MODEL_DISK_BYTES:
        raise AssertionError(
            f"phase big_model needs {BIG_MODEL_DISK_BYTES / 1e9:.0f} GB of "
            f"free disk under {root} for the llama3-8B checkpoint and its "
            f"offload files; {free / 1e9:.1f} GB free")
    work = tempfile.mkdtemp(prefix="big_model_", dir=root)
    try:
        _big_model(kernel_rows, work, free)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _big_model(kernel_rows, work, disk_free):
    import os

    import numpy as np
    import torch

    from accelerate_tpu_torch import big_modeling as bm
    from accelerate_tpu_torch.checkpointing import save_model
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.optimizers import tree_leaves

    t_phase = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b()
    bf16 = torch.bfloat16
    ckpt, offload = os.path.join(work, "ckpt"), os.path.join(work, "offload")
    params = llama.init_params(cfg, 0, dtype=bf16)
    t0 = time.perf_counter()
    save_model(params, ckpt, max_shard_size="5GB")
    save_s = time.perf_counter() - t0
    shards = sorted(f for f in os.listdir(ckpt) if f.endswith(".safetensors"))
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in shards)
    _drop()

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    abstract = bm.init_empty_weights(llama.init_params, cfg, 0, dtype=bf16)
    meta_moved = torch.cuda.memory_allocated() - before
    leaves = tree_leaves(abstract)
    all_meta = all(t.is_meta for t in leaves)

    dmap = bm.infer_auto_device_map(abstract, max_memory=BIG_MODEL_MAX_MEMORY,
                                    dtype=bf16)
    rows = {"device": 0, "cpu": 0, "disk": 0}
    for key, target in dmap.items():
        if key.startswith("layers."):
            rows["device" if isinstance(target, int) else target] += 1

    with _RssPeak() as rss:
        t0 = time.perf_counter()
        off = bm.load_checkpoint_and_dispatch(
            abstract, ckpt, device_map=dmap, offload_folder=offload,
            dtype=bf16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    tiers = _tier_bytes(off)
    largest = max(t.numel() * t.element_size() for t in leaves)
    rss_bound = tiers["cpu"] + largest + BIG_MODEL_RSS_SLACK
    card_after_load = torch.cuda.memory_allocated() - before
    load = {"seconds": load_s, "checkpoint_gb": ckpt_bytes / 1e9,
            "read_gb_per_s": ckpt_bytes / load_s / 1e9,
            "tier_gb": {k: v / 1e9 for k, v in tiers.items()},
            "rss_base_gb": rss.base / 1e9, "rss_peak_gb": rss.peak / 1e9,
            "rss_rise_gb": (rss.peak - rss.base) / 1e9,
            "rss_rise_bound_gb": rss_bound / 1e9,
            "largest_tensor_gb": largest / 1e9,
            "mem_available_drop_gb": rss.avail_base - rss.avail_min,
            "card_allocated_gb": card_after_load / 1e9,
            "card_allocated_before_gb": before / 1e9}

    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, BIG_MODEL_PROMPT))).cuda()
    pinned_rate = _pinned_h2d_gb_per_s()
    want = llama.generate(cfg, params, prompt,
                          max_new_tokens=BIG_MODEL_NEW_TOKENS)
    runs = []
    for _ in range(2):    # the first call also warms up cuBLAS and the
        stats = bm.StreamStats()   # allocator: the second is the steady one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = llama.streamed_generate(cfg, off, prompt,
                                      max_new_tokens=BIG_MODEL_NEW_TOKENS,
                                      stats=stats)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, stats.summary(),
                     bool(torch.equal(got, want))))
    (first_s, _, first_same), (gen_s, s, same) = runs
    passes = BIG_MODEL_NEW_TOKENS      # the prefill and 15 decode steps
    decode = {"prompt": BIG_MODEL_PROMPT, "new_tokens": BIG_MODEL_NEW_TOKENS,
              "tokens_identical": first_same and same,
              "s_per_token_first_call": first_s / passes,
              "seconds": gen_s, "s_per_token": gen_s / passes,
              "gb_per_token": s["bytes"] / passes / 1e9,
              "h2d_gb_per_s": s["gb_per_s"],
              "pinned_copy_gb_per_s": pinned_rate,
              "copy_hidden_share": s["hidden"],
              "copy_ms": s["copy_ms"], "compute_ms": s["compute_ms"],
              "layers_streamed": s["layers"],
              "pinned_rate_again_gb_per_s": _pinned_h2d_gb_per_s()}

    ids = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, BIG_MODEL_FORWARD))).cuda()
    fstats = bm.StreamStats()
    fa.flash_forward.launches = 0
    logits = llama.forward_offloaded(cfg, off, ids, stats=fstats)
    torch.cuda.synchronize()
    k1a = fa.flash_forward.launches
    resident = llama.forward(cfg, params, ids)
    fs = fstats.summary()
    forward = {"tokens": BIG_MODEL_FORWARD, "flash_fwd_launches": k1a,
               "max_abs_err": _max_abs(logits, resident),
               "rel_l2": _rel_l2(logits, resident),
               "rel_l2_tol": BIG_MODEL_LOGITS_TOL,
               "finite": bool(torch.isfinite(logits).all()),
               "copy_hidden_share": fs["hidden"],
               "h2d_gb_per_s": fs["gb_per_s"]}
    del logits, resident, off
    _drop()

    quant = {}
    for bits in (8, 4):
        quant[bits] = _big_model_quant(cfg, params, abstract, ckpt, bits,
                                       ids[:, :BIG_MODEL_PROMPT])
        _drop()
    del params
    _drop()

    oom = _big_model_oom()
    zoo = _big_model_zoo(os.path.join(work, "zoo"))
    emit("big_model", config="llama3_8b", layers=cfg.num_hidden_layers,
         dtype="bfloat16", max_memory=BIG_MODEL_MAX_MEMORY,
         disk_free_gb=disk_free / 1e9, save_seconds=save_s,
         shards=len(shards), init_empty_weights={
             "card_bytes_moved": meta_moved, "all_meta": all_meta},
         layer_rows=rows, load=load, streamed_generate=decode,
         forward_offloaded=forward, quantized=quant, oom=oom, zoo=zoo,
         seconds=time.perf_counter() - t_phase)
    bad = []
    if meta_moved or not all_meta:
        bad.append("init_empty_weights allocated on the card")
    if min(rows.values()) < 1:
        bad.append(f"a tier holds no layer row: {rows}")
    if load["rss_rise_gb"] > load["rss_rise_bound_gb"]:
        bad.append("loading held more host memory than the CPU tier, "
                   "one tensor and the slack")
    if not decode["tokens_identical"]:
        bad.append("streamed tokens differ from the resident generate's")
    if not (forward["finite"] and forward["rel_l2"] <= BIG_MODEL_LOGITS_TOL):
        bad.append("streamed forward off the resident forward")
    if k1a != cfg.num_hidden_layers:
        bad.append(f"{k1a} K1a launches, expected {cfg.num_hidden_layers}")
    bad += [f"int{b}: {q['failed']}" for b, q in quant.items()
            if q["failed"]]
    if not oom["recovered"]:
        bad.append("no out-of-memory recovery")
    bad += [f"zoo {n} streamed tokens differ" for n, z in zoo.items()
            if not z["tokens_identical"]]
    if bad:
        raise AssertionError(f"phase big_model: {bad}")
    row = _flash_rows_at("big_model", {"flash_fwd": k1a, "flash_bwd_dq": 0,
                                       "flash_bwd_dkv": 0},
                         1, BIG_MODEL_FORWARD, cfg.num_attention_heads,
                         cfg.head_dim)[0]
    row["scope"] = ("K1a in llama.forward_offloaded, once per streamed "
                    "layer (k/v repeated to 32 heads)")
    kernel_rows.append(row)


def _big_model_quant(cfg, params, abstract, ckpt, bits, ids):
    """`load_and_quantize_params` at `bits` from the checkpoint: time,
    `quantized_nbytes`, the card's memory; two leaves' codes and scales
    against the host `quantize` of the same weights; every dequantized
    weight's relative L2 against bf16; logits after one layer (gated)
    and after all 32 (printed) against bf16's."""
    import dataclasses

    import torch

    from accelerate_tpu_torch import big_modeling as bm
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import quant
    from accelerate_tpu_torch.optimizers import tree_map
    from accelerate_tpu_torch.utils.dataclasses import QuantizationConfig
    from accelerate_tpu_torch.utils.other import flatten_dict

    qc = QuantizationConfig(load_in_8bit=bits == 8, load_in_4bit=bits == 4)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    q = bm.load_and_quantize_params(abstract, ckpt, qc, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    card = torch.cuda.memory_allocated() - before
    nbytes = quant.quantized_nbytes(q)
    flat_q, flat_p = flatten_dict(q), flatten_dict(params)
    bit_equal = {}
    for name in ("layers.attn.k_proj.kernel", "embed_tokens.embedding"):
        host = quant.quantize(flat_p[name].cpu(), bits=bits,
                              block_size=qc.block_size)
        bit_equal[name] = bool(
            torch.equal(flat_q[name].data.cpu(), host.data)
            and torch.equal(flat_q[name].scales.cpu().view(torch.int16),
                            host.scales.view(torch.int16)))
    weight_err = {
        name: _rel_l2(quant.dequantize(flat_q[name], torch.float32),
                      flat_p[name].float())
        for name in flat_q
        if isinstance(flat_q[name], quant.QuantizedTensor)}
    deq = quant.dequantize_params(q, dtype=torch.bfloat16)
    del q, flat_q
    logits = {}
    for layers in (1, cfg.num_hidden_layers):
        c = dataclasses.replace(cfg, num_hidden_layers=layers)

        def cut(tree):
            return {**tree, "layers": tree_map(lambda t: t[:layers],
                                               tree["layers"])}

        a = llama.forward(c, cut(deq), ids)
        b = llama.forward(c, cut(params), ids)
        logits[layers] = {"rel_l2": _rel_l2(a, b),
                          "finite": bool(torch.isfinite(a).all())}
        del a, b
    del deq
    worst = max(weight_err.values())
    failed = []
    if not all(bit_equal.values()):
        failed.append(f"codes or scales off the host quantize: {bit_equal}")
    if worst > BIG_MODEL_QUANT_WEIGHT_TOL[bits]:
        failed.append(f"a dequantized weight {worst} off bf16")
    if not all(v["finite"] for v in logits.values()) or \
            logits[1]["rel_l2"] > BIG_MODEL_QUANT_LOGITS_TOL[bits]:
        failed.append(f"logits off bf16: {logits}")
    return {"seconds": load_s,
            "quantized_nbytes_gb": nbytes / 1e9,
            "card_allocated_gb": card / 1e9,
            "codes_bit_equal": bit_equal,
            "weight_rel_l2_max": worst,
            "weight_rel_l2_tol": BIG_MODEL_QUANT_WEIGHT_TOL[bits],
            "logits_rel_l2": {str(k): v["rel_l2"] for k, v in logits.items()},
            "logits_rel_l2_tol_at_1_layer": BIG_MODEL_QUANT_LOGITS_TOL[bits],
            "failed": failed}


def _big_model_oom():
    """`find_executable_batch_size` from 128 GiB: each attempt allocates
    and writes `batch` GiB on the card, the ones that do not fit raise
    torch.cuda.OutOfMemoryError, and the batch halves until one fits."""
    import torch

    from accelerate_tpu_torch.utils.memory import find_executable_batch_size

    attempts, errors = [], []

    @find_executable_batch_size(starting_batch_size=BIG_MODEL_OOM_START)
    def fill(batch_size):
        attempts.append(batch_size)
        try:
            x = torch.empty((batch_size, 1 << 30), dtype=torch.uint8,
                            device="cuda")
        except torch.cuda.OutOfMemoryError as e:
            errors.append(type(e).__name__)
            raise
        x.fill_(1)
        torch.cuda.synchronize()
        del x
        return batch_size

    settled = fill()
    _drop()
    return {"start_gib": BIG_MODEL_OOM_START, "attempts_gib": attempts,
            "errors": errors, "settled_gib": settled,
            "recovered": bool(errors) and settled < BIG_MODEL_OOM_START
            and len(errors) == len(attempts) - 1}


def _big_model_zoo(folder):
    """Every family's tiny config (f32, 4 layers) on the card:
    `streamed_generate` against the family's resident `generate`, greedy
    and sampled. The causal families stream layer rows from the card,
    pinned host memory and disk; T5 from `cpu_offload` (its encoder
    streams, its decoder is fetched whole)."""
    import importlib
    import os

    import numpy as np
    import torch

    from accelerate_tpu_torch import big_modeling as bm

    families = {"llama": "LlamaConfig", **ZOO, "t5": "T5Config"}
    out = {}
    for name, cfg_name in families.items():
        mod = importlib.import_module(f"accelerate_tpu_torch.models.{name}")
        if name == "t5":
            cfg = mod.T5Config.tiny(num_layers=4, num_decoder_layers=4)
            params = mod.init_params(cfg, 0)
            off = bm.cpu_offload(params)
        else:
            cfg = getattr(mod, cfg_name).tiny(num_hidden_layers=4)
            params = mod.init_params(cfg, 0)
            dmap = {k: 0 for k in params if k != "layers"}
            dmap.update({f"layers.{i}": 0 if i == 0 else (
                "cpu" if i < 3 else "disk") for i in range(4)})
            off = bm.dispatch_model(params, dmap,
                                    offload_folder=os.path.join(folder, name))
        ids = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, 7))).cuda()
        same = []
        for kw in ({}, {"temperature": 0.8, "key": 5}):
            got = mod.streamed_generate(cfg, off, ids, max_new_tokens=8,
                                        dtype=torch.float32, **kw)
            same.append(bool(torch.equal(
                got, mod.generate(cfg, params, ids, max_new_tokens=8, **kw))))
        out[name] = {"tier_bytes": _tier_bytes(off),
                     "tokens_identical": all(same)}
    return out


DP_LAYERS = 2       # full width; two ranks' f32 state share the card
# the three gated steps: steps 4-5 were reported, not gated (below),
# at 6-10 s of gloo all-reduce each
DP_STEPS = 3
DP_LR = 3e-4              # the script's adamw
DP_STEP1_RTOL = 1e-5      # step 1: the same weights, the global mean
# steps 2-3, each relative to one process's loss at that step: AdamW on
# gradients rounded apart (readings 1.0e-3 and 1.6e-3, three runs).
# Later steps are not run: the run memorises its one batch and steps 4-5
# had losses of ~1e-3 and ~4e-4, where the same readings put the gap at
# 2.2% and 0.12%, set by which weights rounding sent the other way, so
# no limit there would tell a fault from rounding
DP_EARLY_RTOL = 1e-2
# step 1's update, rank 0 of two against one process, on a strided
# sample of every leaf: AdamW's first update is about +-lr an element
# whatever the gradient's size, so an element whose averaged gradient
# rounds to the other sign moves 2 lr apart. Gated: the share of
# elements more than lr apart (opposite directions), and the share more
# than lr / 100 apart
DP_UPDATE_FLIP_MAX = 1e-2
DP_UPDATE_OFF_MAX = 5e-2
DP_TIMEOUT_S = 420


def _dp_world(n: int, update_sample: str, flags=()) -> list:
    """The bundled `train_llama_dp.py` as a user launches it:
    `python -m accelerate_tpu_torch.commands.launch --num_processes n`
    with the launcher's `flags`, the launcher's exit code checked; each
    rank's `DP_RESULT` line. Process 0 saves its sample of step 1's
    update to `update_sample`."""
    import os

    script = os.path.join("accelerate_tpu_torch", "test_utils", "scripts",
                          "train_llama_dp.py")
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.launch",
           "--num_processes", str(n), *flags, script, "--config",
           "llama3_8b",
           "--layers", str(DP_LAYERS), "--steps", str(DP_STEPS),
           "--update-sample", update_sample]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=DP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    results = [json.loads(line.split(" ", 1)[1])
               for line in proc.stdout.splitlines()
               if line.startswith("DP_RESULT {")]
    if proc.returncode != 0 or len(results) != n:
        raise AssertionError(
            f"launch of {n} process(es) exited {proc.returncode} with "
            f"{len(results)} result(s):\n{proc.stdout[-4000:]}\n"
            f"{proc.stderr[-8000:]}")
    for r in results:
        r["launcher_wall_s"] = wall
    return sorted(results, key=lambda r: r["rank"])


def phase_dp_train(kernel_rows):
    """Data parallelism on the one card: `train_llama_dp.py` launched as
    two processes (gloo, both on card 0), each training llama3-8B width
    at 2 layers (bf16, clip 1.0, adamw(3e-4), remat "dots") on its
    [1, 2049] half of phase train's [2, 2049] batch for 3 steps, the
    gradients averaged in buckets through the host; then the same script
    as one process on the whole batch. Gates: the launcher exits 0 both
    times; both ranks' parameters equal rank 0's bit for bit; the same
    losses on both ranks; step 1's update of rank 0 against the one
    process's (DP_UPDATE_FLIP_MAX, DP_UPDATE_OFF_MAX); step 1's loss
    within DP_STEP1_RTOL of the one process's, steps 2-3 within
    DP_EARLY_RTOL; K1a 12 and K1b/K1c 6 launches on each rank; then
    K1a/b/c at the path's shape against their plain
    versions, timed."""
    import os
    import tempfile

    import numpy as np

    with tempfile.TemporaryDirectory(prefix="dp_train_") as tmp:
        paths = [os.path.join(tmp, f"update_{n}.npy") for n in (2, 1)]
        two = _dp_world(2, paths[0])
        one = _dp_world(1, paths[1])[0]
        u2, u1 = (np.load(p) for p in paths)
    gap = np.abs(u2 - u1)
    update = {"elements": int(gap.size),
              "share_over_lr": float((gap > DP_LR).mean()),
              "share_over_lr_100": float((gap > DP_LR / 100).mean()),
              "max_abs_over_lr": float(gap.max() / DP_LR),
              "median_abs_update_over_lr": float(
                  np.median(np.abs(u1)) / DP_LR)}
    rel = [abs(a - b) / abs(b)
           for a, b in zip(two[0]["losses"], one["losses"])]
    want = {"flash_fwd": 2 * DP_LAYERS * DP_STEPS,
            "flash_bwd_dq": DP_LAYERS * DP_STEPS,
            "flash_bwd_dkv": DP_LAYERS * DP_STEPS}
    emit("dp_train", config="llama3_8b", layers=DP_LAYERS, steps=DP_STEPS,
         global_batch=[2, 2049], backend=two[0]["backend"],
         world2=two, world1=one, loss_rel_diff=rel,
         step1_rtol=DP_STEP1_RTOL, steps_2_3_rtol=DP_EARLY_RTOL,
         step1_update=update, update_flip_max=DP_UPDATE_FLIP_MAX,
         update_off_max=DP_UPDATE_OFF_MAX,
         launches_per_rank_expected=want,
         step_ms_median={"world2": [float(sorted(r["step_ms"][1:])[
             len(r["step_ms"][1:]) // 2]) for r in two],
             "world1": float(sorted(one["step_ms"][1:])[
                 len(one["step_ms"][1:]) // 2])})
    failed = []
    if not all(r["identical_to_rank0"] for r in two):
        failed.append("replicas differ from rank 0")
    if two[0]["losses"] != two[1]["losses"]:
        failed.append(f"ranks' losses differ: {two[0]['losses']} "
                      f"{two[1]['losses']}")
    if not all(math.isfinite(x) for x in two[0]["losses"]):
        failed.append(f"non-finite loss: {two[0]['losses']}")
    if rel[0] > DP_STEP1_RTOL:
        failed.append(f"step 1 loss {rel[0]} off one process's")
    if any(x > DP_EARLY_RTOL for x in rel[1:3]):
        failed.append(f"steps 2-3 losses off one process's: {rel}")
    if update["share_over_lr"] > DP_UPDATE_FLIP_MAX or \
            update["share_over_lr_100"] > DP_UPDATE_OFF_MAX:
        failed.append(f"step 1's update off one process's: {update}")
    for r in two + [one]:
        if r["launches"] != want:
            failed.append(f"rank {r['rank']} of {r['world']}: flash "
                          f"launches {r['launches']}, expected {want}")
    if failed:
        raise AssertionError("; ".join(failed))
    launches = {n: sum(r["launches"][n] for r in two) for n in want}
    kernel_rows.extend(_flash_rows_at("dp_train", launches,
                                      1, 2048, 32, 128))
    return {"world2": two, "world1": one, "update1": u1}


# a rank's moment bytes over those of whole moments: half, and the norm
# scales the plan keeps whole (ZeRO on `fsdp` 2)
ZERO_MOMENT_SHARE = (0.49, 0.52)


def phase_zero_train(kernel_rows, dp):
    """ZeRO-2 on the one card: `train_llama_dp.py` launched with
    `--zero_stage 2` as two processes (gloo, both on card 0), the mesh
    `{fsdp: 2}`: each rank trains llama3-8B width at 2 layers (bf16, clip
    1.0, adamw(3e-4), remat "dots") on its [1, 2049] half of phase
    train's batch for 3 steps with params whole and the AdamW moments its
    block; phase dp_train's one-process run on the same seed and batch
    is the reference (not run again). Gates: the launcher exits 0; both
    ranks' params equal rank 0's bit for bit; the same losses on both
    ranks; step 1's loss within DP_STEP1_RTOL of the one process's,
    steps 2-3 within DP_EARLY_RTOL; step 1's update of rank 0 against
    the one process's (DP_UPDATE_FLIP_MAX, DP_UPDATE_OFF_MAX); each
    rank's moment bytes a ZERO_MOMENT_SHARE of whole moments'; K1a 12
    and K1b/K1c 6 launches on each rank; then K1a/b/c at the path's
    shape against their plain versions, timed. Reported, not gated: each
    rank's memory after `prepare` and at its peak beside dp_train's, and
    the reduce-scatter and all-gather alone."""
    import os
    import tempfile

    import numpy as np

    one, u1 = dp["world1"], dp["update1"]
    with tempfile.TemporaryDirectory(prefix="zero_train_") as tmp:
        path = os.path.join(tmp, "update_zero.npy")
        two = _dp_world(2, path, flags=("--zero_stage", "2"))
        u2 = np.load(path)
    gap = np.abs(u2 - u1)
    update = {"elements": int(gap.size),
              "share_over_lr": float((gap > DP_LR).mean()),
              "share_over_lr_100": float((gap > DP_LR / 100).mean()),
              "max_abs_over_lr": float(gap.max() / DP_LR)}
    rel = [abs(a - b) / abs(b)
           for a, b in zip(two[0]["losses"], one["losses"])]
    shares = [r["moment_bytes"] / r["whole_moment_bytes"] for r in two]
    want = {"flash_fwd": 2 * DP_LAYERS * DP_STEPS,
            "flash_bwd_dq": DP_LAYERS * DP_STEPS,
            "flash_bwd_dkv": DP_LAYERS * DP_STEPS}
    emit("zero_train", config="llama3_8b", layers=DP_LAYERS, steps=DP_STEPS,
         zero_stage=2, global_batch=[2, 2049], backend=two[0]["backend"],
         mesh=two[0]["mesh"], world2=two, loss_rel_diff=rel,
         step1_rtol=DP_STEP1_RTOL, steps_2_3_rtol=DP_EARLY_RTOL,
         step1_update=update, update_flip_max=DP_UPDATE_FLIP_MAX,
         update_off_max=DP_UPDATE_OFF_MAX, moment_share=shares,
         moment_share_band=ZERO_MOMENT_SHARE,
         launches_per_rank_expected=want,
         memory_after_prepare_gb={
             "zero_train": [r["memory_after_prepare_gb"] for r in two],
             "dp_train": [r["memory_after_prepare_gb"]
                          for r in dp["world2"]]},
         max_memory_allocated_gb={
             "zero_train": [r["max_memory_allocated_gb"] for r in two],
             "dp_train": [r["max_memory_allocated_gb"]
                          for r in dp["world2"]]},
         reduce_scatter_ms=[r["reduce_scatter_ms"] for r in two],
         all_gather_ms=[r["all_gather_ms"] for r in two],
         allreduce_ms_dp_train=[r["allreduce_ms"] for r in dp["world2"]],
         step_ms_median=[float(sorted(r["step_ms"][1:])[
             len(r["step_ms"][1:]) // 2]) for r in two])
    failed = []
    if not all(r["zero"] and r["mesh"] == {"fsdp": 2} for r in two):
        failed.append(f"not ZeRO on fsdp 2: {[r['mesh'] for r in two]}")
    if not all(r["identical_to_rank0"] for r in two):
        failed.append("ranks' params differ from rank 0's")
    if two[0]["losses"] != two[1]["losses"]:
        failed.append(f"ranks' losses differ: {two[0]['losses']} "
                      f"{two[1]['losses']}")
    if not all(math.isfinite(x) for x in two[0]["losses"]):
        failed.append(f"non-finite loss: {two[0]['losses']}")
    if rel[0] > DP_STEP1_RTOL:
        failed.append(f"step 1 loss {rel[0]} off one process's")
    if any(x > DP_EARLY_RTOL for x in rel[1:3]):
        failed.append(f"steps 2-3 losses off one process's: {rel}")
    if update["share_over_lr"] > DP_UPDATE_FLIP_MAX or \
            update["share_over_lr_100"] > DP_UPDATE_OFF_MAX:
        failed.append(f"step 1's update off one process's: {update}")
    lo, hi = ZERO_MOMENT_SHARE
    if not all(lo < x < hi for x in shares):
        failed.append(f"moment share {shares} outside {ZERO_MOMENT_SHARE}")
    for r in two:
        if r["launches"] != want:
            failed.append(f"rank {r['rank']}: flash launches "
                          f"{r['launches']}, expected {want}")
    if failed:
        raise AssertionError("; ".join(failed))
    launches = {n: sum(r["launches"][n] for r in two) for n in want}
    kernel_rows.extend(_flash_rows_at("zero_train", launches,
                                      1, 2048, 32, 128))
    return {"world2": two}


# part (a): f32 at full width, the exactness gate; part (b): bf16. Cut
# from 4 and 32 layers to make room for phases context_parallel and
# cp_train (b: 16 then 4): no gate of either part depends on the depth
TP_LAYERS_A = 2
TP_LAYERS_B = 4
TP_PARAM_SHARE = (0.49, 0.52)   # a rank's parameter bytes / the whole
TP_LOGITS_REL_L2 = 0.1          # bf16 at depth: two correct paths drift
                                # 0.03-0.05 (ROADMAP.md parity hazards)
TP_TIMEOUT_S = 600


def phase_pod_tp():
    """Tensor-parallel serving on the one card: `serve_llama_tp.py`
    launched as two processes (gloo, both on card 0), each building
    llama3-8B weights from seed 0 and serving phase engine's 12 requests
    on its shards. Gates: the launcher exits 0; (a) in f32 at
    TP_LAYERS_A layers both ranks' `sharded_engine` and
    `PodRouter(tensor_parallel=2)` streams equal process 0's one-process
    engine's, greedy and sampled; (b) in bf16 at TP_LAYERS_B layers both
    ranks' streams identical, each rank's parameter bytes within
    TP_PARAM_SHARE of the whole, its KV pool half of one process's, no
    paged-decode launch, each prompt's logits within TP_LOGITS_REL_L2 of
    one process's. The step times and collectives are reported, not
    gated: two ranks share one card through the host."""
    import os

    script = os.path.join("accelerate_tpu_torch", "test_utils", "scripts",
                          "serve_llama_tp.py")
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.launch",
           "--num_processes", "2", script, "--config", "llama3_8b",
           "--layers-a", str(TP_LAYERS_A), "--layers-b", str(TP_LAYERS_B)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=TP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    rows = [json.loads(line.split(" ", 1)[1])
            for line in proc.stdout.splitlines()
            if line.startswith("TP_RESULT {")]
    a = sorted((r for r in rows if r["part"] == "a"),
               key=lambda r: r["rank"])
    b = sorted((r for r in rows if r["part"] == "b"),
               key=lambda r: r["rank"])
    if proc.returncode != 0 or len(a) != 2 or len(b) != 2:
        raise AssertionError(
            f"launch exited {proc.returncode} with {len(rows)} result(s):"
            f"\n{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    single = a[0]["single"]
    same_a = {f"rank{r['rank']}_{kind}": r[kind] == single
              for r in a for kind in ("sharded", "pod")}
    shares = [r["param_bytes"] / r["param_bytes_whole"] for r in b]
    pool_half = [2 * r["pool_bytes"] == r["pool_bytes_one_process"]
                 for r in b]
    rel = b[0]["logits_rel_l2"]
    emit("pod_tp", config="llama3_8b", launcher_wall_s=wall,
         backend="gloo", ranks_share_one_card=True,
         part_a={"layers": a[0]["layers"], "dtype": "float32",
                 "streams_equal_one_process": same_a,
                 "requests": len(single),
                 **{k: a[0][k] for k in (
                     "compile_stats", "graphs_captured",
                     "decode_step_ms_median", "prefill_chunk_ms_median",
                     "pod_shipments", "pod_page_bytes_per_page")}},
         part_b={"layers": b[0]["layers"], "dtype": "bfloat16",
                 "streams_identical": b[0]["streams"] == b[1]["streams"],
                 "param_share": shares, "pool_half": pool_half,
                 "logits_rel_l2": rel,
                 **{k: [r[k] for r in b] for k in (
                     "param_bytes", "param_bytes_whole", "pool_bytes",
                     "pool_bytes_one_process", "paged_kernel_launches",
                     "decode_step_ms_median", "prefill_chunk_ms_median",
                     "decode_steps", "prefill_steps",
                     "collectives_per_decode_step",
                     "collective_host_ms_per_decode_step_median",
                     "max_memory_allocated_gb")},
                 "pool_spec": b[0]["pool_spec"],
                 "compile_stats": b[0]["compile_stats"],
                 "graphs_captured": b[0]["graphs_captured"]},
         note="two ranks share one card through the host (gloo): these "
              "times are not tensor-parallel speed")
    failed = []
    if not all(same_a.values()):
        failed.append(f"(a) streams differ from one process's: {same_a}")
    if b[0]["streams"] != b[1]["streams"]:
        failed.append("(b) the ranks' streams differ")
    if not all(TP_PARAM_SHARE[0] <= x <= TP_PARAM_SHARE[1]
               for x in shares):
        failed.append(f"(b) parameter share {shares}")
    if not all(pool_half):
        failed.append("(b) a rank's pool is not half of one process's: "
                      f"{[r['pool_bytes'] for r in b]}")
    if any(r["paged_kernel_launches"] != 0 for r in b):
        failed.append("(b) the meshed engine launched the paged kernel")
    if len(rel) != 12 or not all(math.isfinite(x) and x <= TP_LOGITS_REL_L2
                                 for x in rel):
        failed.append(f"(b) logits relative L2 {rel}")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"a": a, "b": b}


# (b)'s depth, cut from 32 (16, then 8) to make room for phases
# context_parallel and cp_train: its gates (logits, K1a launches a rank,
# half the layer bytes) follow it
PP_LAYERS_B = 8
PP_A_REL_L2 = 1e-4      # (a) f32: products in another order only
PP_B_REL_L2 = 0.1       # (b) bf16 at depth (ROADMAP.md parity hazards)
PP_C_LOSS_RTOL = 1e-4   # (c) the same per-micro losses summed in f32
PP_C_GRAD_REL_L2 = 2e-2  # (c) bf16 gradients of 4 micro-batches summed
                         # in another order (3.5e-3 on the CPU)
PP_PARAM_SHARE = (0.49, 0.52)
PP_TIMEOUT_S = 420


def _pp_rows(rows, part):
    return sorted((r for r in rows if r["part"] == part),
                  key=lambda r: r["rank"])


def phase_pipeline(kernel_rows):
    """Pipeline-parallel and sharded inference on the one card:
    `infer_llama_pp.py` launched as two processes (gloo, both on card
    0), each building llama3-8B weights from seed 0. Gates: the launcher
    exits 0; (a) f32 at 4 layers: the pipeline at 2 and 4 chunks, the
    tensor-parallel route of `prepare_sharded_inference` and
    `dispatch_model("sharded")` each give logits within PP_A_REL_L2 of
    process 0's one-process forward, prompt by prompt, and the same
    digest on both ranks; a rank's parameter bytes within PP_PARAM_SHARE
    of the whole; (b) bf16 at PP_LAYERS_B layers: both ranks' logits
    identical, each prompt's within PP_B_REL_L2 of one process's, 16 K1a
    launches a rank, a rank's layer bytes exactly half of the whole; (c)
    1F1B:
    the loss within PP_C_LOSS_RTOL and every gradient leaf within
    PP_C_GRAD_REL_L2 of one process's autograd, K1a/K1b/K1c 16/8/8 a
    rank, the saved inputs within 2(S-1-s)+1. The times are reported,
    not gated: two ranks share one card through the host."""
    import os

    script = os.path.join("accelerate_tpu_torch", "test_utils", "scripts",
                          "infer_llama_pp.py")
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.launch",
           "--num_processes", "2", script, "--config", "llama3_8b",
           "--layers-b", str(PP_LAYERS_B)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=PP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    rows = [json.loads(line.split(" ", 1)[1])
            for line in proc.stdout.splitlines()
            if line.startswith("PP_RESULT {")]
    a, b, c = (_pp_rows(rows, p) for p in "abc")
    if proc.returncode != 0 or not len(a) == len(b) == len(c) == 2:
        raise AssertionError(
            f"launch exited {proc.returncode} with {len(rows)} result(s):"
            f"\n{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    failed = []
    a_rel = {name: res["rel_l2"] for name, res in a[0]["results"].items()}
    a_same = {name: a[0]["results"][name]["digest"] ==
              a[1]["results"][name]["digest"] for name in a_rel}
    for name, rel in a_rel.items():
        if len(rel) != 4 or not all(math.isfinite(x) and x <= PP_A_REL_L2
                                    for x in rel):
            failed.append(f"(a) {name}: logits relative L2 {rel}")
        if not a_same[name]:
            failed.append(f"(a) {name}: the ranks' logits differ")
    route = a[0]["results"]["sharded_inference"]["route"]
    if route != "tensor_parallel":
        failed.append(f"(a) prepare_sharded_inference took route {route}")
    a_share = [r["param_bytes"] / r["param_bytes_whole"] for r in a]
    if not all(PP_PARAM_SHARE[0] <= x <= PP_PARAM_SHARE[1]
               for x in a_share):
        failed.append(f"(a) dispatch_model parameter share {a_share}")
    b_rel = b[0]["logits_rel_l2"]
    if b[0]["digest"] != b[1]["digest"]:
        failed.append("(b) the ranks' logits differ")
    if not all(r["finite"] for r in b):
        failed.append("(b) non-finite logits")
    if len(b_rel) != 2 or not all(math.isfinite(x) and x <= PP_B_REL_L2
                                  for x in b_rel):
        failed.append(f"(b) logits relative L2 {b_rel}")
    b_want = b[0]["layers"] // 2 * b[0]["num_chunks"]
    for r in b:
        if r["launches"]["flash_fwd"] != b_want:
            failed.append(f"(b) rank {r['rank']}: K1a launches "
                          f"{r['launches']['flash_fwd']}, expected {b_want}")
        if 2 * r["layer_bytes"] != r["layer_bytes_whole"]:
            failed.append(f"(b) rank {r['rank']}: layer bytes "
                          f"{r['layer_bytes']} of {r['layer_bytes_whole']}")
    c_want = {"flash_fwd": 2 * 4 * c[0]["layers"] // 2,
              "flash_bwd_dq": 4 * c[0]["layers"] // 2,
              "flash_bwd_dkv": 4 * c[0]["layers"] // 2}
    for r in c:
        if abs(r["loss"] - r["ref_loss"]) > PP_C_LOSS_RTOL * abs(
                r["ref_loss"]) or not math.isfinite(r["loss"]):
            failed.append(f"(c) rank {r['rank']}: loss {r['loss']} against "
                          f"{r['ref_loss']}")
        worst = max(r["grad_rel_l2"].values())
        if not r["grads_finite"] or not worst <= PP_C_GRAD_REL_L2:
            failed.append(f"(c) rank {r['rank']}: gradient relative L2 "
                          f"{r['grad_rel_l2']}")
        if r["launches"] != c_want:
            failed.append(f"(c) rank {r['rank']}: flash launches "
                          f"{r['launches']}, expected {c_want}")
        if r["max_saved_inputs"] > r["saved_bound"]:
            failed.append(f"(c) rank {r['rank']}: {r['max_saved_inputs']} "
                          f"saved inputs, bound {r['saved_bound']}")
    emit("pipeline", config="llama3_8b", launcher_wall_s=wall,
         backend="gloo", ranks_share_one_card=True,
         part_a={"layers": a[0]["layers"], "dtype": "float32",
                 "prompts": a[0]["prompts"], "logits_rel_l2": a_rel,
                 "ranks_equal": a_same, "route": route,
                 "param_share": a_share,
                 "handoffs": {n: [r["results"][n]["handoffs"] for r in a]
                              for n in ("pipeline_2", "pipeline_4")}},
         part_b={"layers": b[0]["layers"], "dtype": "bfloat16",
                 "prompts": b[0]["prompts"],
                 "ranks_equal": b[0]["digest"] == b[1]["digest"],
                 "logits_rel_l2": b_rel,
                 **{k: [r[k] for r in b] for k in (
                     "launches", "layer_bytes", "layer_bytes_whole",
                     "handoffs", "handoff_bytes", "exchange_ms",
                     "broadcast_bytes", "ticks", "call_ms",
                     "max_memory_allocated_gb")}},
         part_c={"layers": c[0]["layers"], "dtype": "bfloat16",
                 "micro_batches": c[0]["micro_batches"],
                 "micro_shape": c[0]["micro_shape"],
                 "launches_expected": c_want,
                 **{k: [r[k] for r in c] for k in (
                     "launches", "loss", "ref_loss", "grad_rel_l2",
                     "max_saved_inputs", "saved_bound", "handoffs",
                     "handoff_bytes", "exchange_ms", "ticks", "call_ms",
                     "max_memory_allocated_gb")}},
         tolerances={"a_rel_l2": PP_A_REL_L2, "b_rel_l2": PP_B_REL_L2,
                     "c_loss_rtol": PP_C_LOSS_RTOL,
                     "c_grad_rel_l2": PP_C_GRAD_REL_L2},
         note="two ranks share one card through the host (gloo): these "
              "times are not pipeline speed")
    if failed:
        raise AssertionError("; ".join(failed))
    launches = {n: sum(r["launches"][n] for r in b + c) for n in c_want}
    kernel_rows.extend(_flash_rows_at("pipeline", launches,
                                      1, 2048, 32, 128))
    return {"a": a, "b": b, "c": c}


CP_LAYERS = 2            # llama3-8B width; each rank holds the whole model
CP_SEQ = 4096            # 2048 tokens a rank on the `seq` axis of 2
CP_LOSS_RTOL = 1e-3      # the loss against one process's flash, bf16
# bf16 gradients through the ring's fold (its output rounded per chunk
# and the chunks' sums in another order) against one process's flash,
# the worst leaf: 5.7e-3 at the tiny width on the CPU; 5.4e-3 to 1.13e-2
# at this width on an H100 80GB HBM3 at 700 W. The planted fault that
# looks right (each chunk's backward from its own output and LSE, not
# the global ones) reads 1.51 at the tiny width on the CPU and 1.41 at
# this width on the card (0.12 even on the MLP's kernels); the phase
# fails unless it reads above this limit.
CP_GRAD_REL_L2 = 2e-2
CP_MOE_REL_L2 = 2e-2     # (d) a2a against the sort dispatch, bf16
CP_TIMEOUT_S = 480


def _cp_rows(rows, part):
    return sorted((r for r in rows if r["part"] == part),
                  key=lambda r: r["rank"])


def phase_context_parallel(kernel_rows):
    """Sequence and expert parallelism on the one card:
    `context_parallel_llama.py` launched as two processes (gloo, both on
    card 0) on a `seq` axis of 2, each building llama3-8B weights (bf16,
    CP_LAYERS layers) from seed 0 and one row of CP_SEQ + 1 tokens.
    Gates, parts (a) ring, (b) ring with the last 512 keys padded, (c)
    Ulysses: the launcher exits 0; both ranks' loss and gradient digests
    equal; the loss within CP_LOSS_RTOL and every gradient leaf within
    CP_GRAD_REL_L2 of rank 0's one-process flash; K1a/K1b/K1c launches of
    the call L(r+1) on rank r for the ring (causal: a rank skips later
    chunks) and L on each rank for Ulysses; (a) the ring alone through
    the kernels against their plain versions within the flash checks'
    bf16 tolerances; the planted chunk-delta fault's gradients beyond
    CP_GRAD_REL_L2 (the gate can see it); the ring alone with a left pad
    past its first chunk (rank 0's queries see no key, rank 1's first
    chunk is fully masked) within the same tolerances of one process's
    flash. (d) one Mixtral-width MoE block through the a2a dispatch on
    an `expert` axis of 2 at a capacity that drops nothing: dropped
    fraction 0 in the compared call, output and gradients within
    CP_MOE_REL_L2 of one process's sort dispatch, digests equal on both
    ranks. Then K1a/b/c at each shape the phase launched them at (the
    ring's off-diagonal chunk, non-causal; its diagonal chunk, causal;
    Ulysses' whole sequence on half the heads, causal) against their
    plain versions, timed, each row with the launches at its shape. The
    times are reported, not gated: two ranks share one card through the
    host."""
    import os

    script = os.path.join("accelerate_tpu_torch", "test_utils", "scripts",
                          "context_parallel_llama.py")
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.launch",
           "--num_processes", "2", script, "--config", "llama3_8b",
           "--layers", str(CP_LAYERS), "--seq", str(CP_SEQ)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=CP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    rows = [json.loads(line.split(" ", 1)[1])
            for line in proc.stdout.splitlines()
            if line.startswith("CP_RESULT {")]
    parts = {p: _cp_rows(rows, p) for p in "abcd"}
    if proc.returncode != 0 or any(len(v) != 2 for v in parts.values()):
        raise AssertionError(
            f"launch exited {proc.returncode} with {len(rows)} result(s):"
            f"\n{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    failed = []
    L = CP_LAYERS
    tol = FLASH_TOL["bfloat16"]
    for p in "abc":
        r0, r1 = parts[p]
        if r0["grad_digest"] != r1["grad_digest"] or r0["loss"] != r1["loss"]:
            failed.append(f"({p}) the ranks' loss or gradients differ")
        for r in (r0, r1):
            per = L * (r["rank"] + 1) if p in "ab" else L
            want = {"flash_fwd": per, "flash_bwd_dq": per,
                    "flash_bwd_dkv": per}
            if r["launches"] != want:
                failed.append(f"({p}) rank {r['rank']}: flash launches "
                              f"{r['launches']}, expected {want}")
            if not r["grads_finite"] or not math.isfinite(r["loss"]):
                failed.append(f"({p}) rank {r['rank']}: non-finite")
        if abs(r0["loss"] - r0["ref_loss"]) > CP_LOSS_RTOL * abs(
                r0["ref_loss"]):
            failed.append(f"({p}) loss {r0['loss']} against one process's "
                          f"{r0['ref_loss']}")
        worst = max(r0["grad_rel_l2"].values())
        if not worst <= CP_GRAD_REL_L2:
            failed.append(f"({p}) gradient relative L2 "
                          f"{r0['grad_rel_l2']}")
    checks = [r["ring_check"] for r in parts["a"]]
    for r, c in zip(parts["a"], checks):
        ok = (c["finite"] and c["flash_fwd"] <= tol["o"]
              and all(c["rel_l2"][n] <= tol[f"{n}_rel_l2"]
                      for n in ("dq", "dk", "dv")))
        if not ok:
            failed.append(f"(a) rank {r['rank']}: the ring's kernels off "
                          f"their plain versions: {c}")
        lp = c["left_pad"]
        if not (lp["finite"] and lp["o"] <= tol["o"]
                and all(lp["rel_l2"][n] <= tol[f"{n}_rel_l2"]
                        for n in ("dq", "dk", "dv"))):
            failed.append(f"(a) rank {r['rank']}: the ring with a pad past "
                          f"its first chunk off one process's flash: {lp}")
    fault = max(parts["a"][0]["fault_grad_rel_l2"].values())
    if not fault > CP_GRAD_REL_L2:
        failed.append(f"(a) the planted chunk-delta fault reads {fault}, "
                      f"within the gradient gate {CP_GRAD_REL_L2}")
    d0, d1 = parts["d"]
    if d0["out_digest"] != d1["out_digest"]:
        failed.append("(d) the ranks' outputs differ")
    for r in (d0, d1):
        if (r["dropped_fraction"] != 0.0 or r["dispatch_calls"] != 1
                or not r["finite"]):
            failed.append(f"(d) rank {r['rank']}: dropped "
                          f"{r['dropped_fraction']}, finite {r['finite']}")
    worst_d = max([d0["out_rel_l2"], *d0["grad_rel_l2"].values()])
    if not worst_d <= CP_MOE_REL_L2:
        failed.append(f"(d) against the sort dispatch: out "
                      f"{d0['out_rel_l2']}, grads {d0['grad_rel_l2']}")
    keys = ("launches", "loss", "ref_loss", "call_ms", "grad_digest",
            "max_memory_allocated_gb")
    emit("context_parallel", config="llama3_8b", layers=L, seq=CP_SEQ,
         launcher_wall_s=wall, backend="gloo", ranks_share_one_card=True,
         **{f"part_{p}": {"backend": parts[p][0]["backend"],
                          **{k: [r.get(k) for r in parts[p]] for k in keys},
                          "grad_rel_l2": parts[p][0]["grad_rel_l2"],
                          **({"pad": parts[p][0]["pad"]} if p == "b"
                             else {})}
            for p in "abc"},
         ring_check=checks, fault_grad_rel_l2=parts["a"][0][
             "fault_grad_rel_l2"],
         part_d={k: [r.get(k) for r in parts["d"]] for k in (
             "tokens", "experts", "experts_here", "top_k",
             "capacity_factor", "dropped_fraction", "call_ms",
             "max_memory_allocated_gb", "out_digest")}
         | {"out_rel_l2": d0["out_rel_l2"],
            "grad_rel_l2": d0["grad_rel_l2"],
            "ref_call_ms": d0["ref_call_ms"]},
         tolerances={"loss_rtol": CP_LOSS_RTOL,
                     "grad_rel_l2": CP_GRAD_REL_L2,
                     "moe_rel_l2": CP_MOE_REL_L2, "ring_check": tol},
         note="two ranks share one card through the host (gloo): these "
              "times are not sequence- or expert-parallel speed")
    if failed:
        raise AssertionError("; ".join(failed))
    # the launches by shape: the ring runs its diagonal chunk (causal)
    # once a layer on every rank and the rest off the diagonal (the gate
    # above holds the totals); Ulysses runs the whole sequence
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    ring = [r for p in "ab" for r in parts[p]]
    diagonal = {n: L * len(ring) for n in names}
    off = {n: sum(r["launches"][n] for r in ring) - diagonal[n]
           for n in names}
    ulysses = {n: sum(r["launches"][n] for r in parts["c"]) for n in names}
    S, H = CP_SEQ // 2, 32
    rows = _flash_rows_at("context_parallel", off, 1, S, H, 128,
                          causal=False)
    for row in rows:
        row["ring_max_abs_err"] = max(c[row["name"].split("[")[0]]
                                      for c in checks)
    rows += _flash_rows_at("context_parallel_diagonal", diagonal, 1, S, H,
                           128)
    rows += _flash_rows_at("context_parallel_ulysses", ulysses, 1, CP_SEQ,
                           H // 2, 128)
    kernel_rows.extend(rows)
    return parts


# phase cp_train: (e) llama3-8B width on a `seq` axis of 2 through the
# ring, (f) Mixtral-8x7B width on an `expert` axis of 2, experts as blocks
CPT_LAYERS = 2
CPT_SEQ = 4096           # 2048 tokens a rank on the `seq` axis
CPT_STEPS = 3
CPT_MOE_LAYERS = 1
CPT_MOE_SEQ = 2048
CPT_MOE_STEPS = 2
CPT_MOE_CAPACITY = 4.0   # E / k: the a2a dispatch drops nothing
CPT_LR = 3e-4            # the script's adamw
# step 1's update on a strided sample, rank 0 against one process: the
# share of elements more than lr apart (AdamW's first update is about
# +-lr an element, so those moved the other way) and the share more than
# lr / 100 apart. Both bf16 paths round their gradients apart (the ring
# folds its chunks in another order; the a2a sums an expert's rows in
# another order), so an element whose gradient is near zero can flip;
# the phase also reads the same step on other rows, the fault of a
# loader that sharded over the world, which the limits must reject
CPT_UPDATE_FLIP_MAX = 2e-2
CPT_UPDATE_OFF_MAX = 1e-1
# each step's pre-clip norm (as the clip took it) against one process's
# same step, relative: AdamW's update hardly moves with the clip's
# factor, so this is the gate that sees a norm over the wrong tensors.
# (e): the ring's rounding compounds while the model learns its one row
# (loss 12.6, 0.26, 0.0074), so step 3's small norm read 1.6e-2 off in
# run BD (steps 1-2: 0.0, 2.4e-4); (f): the a2a that drops nothing sums
# as the sort does (0.0, 3.2e-5), and the norm of a rank's own gradients
# alone (a clip that left out the expert blocks' line), the planted
# fault it must reject, read 2.6e-2. Each step's loss is held to
# CP_LOSS_RTOL of max(|loss|, 1 nat): a loss near 0 to 1e-3 nats (BD's
# (e) steps 2-3: 4.1e-4, 1.5e-4 nats)
CPT_NORM_RTOL = {"e": 5e-2, "f": 1e-2}
CPT_TIMEOUT_S = 480


def _cpt_reference(family, layers, seq, capacity, sample_tree, runs):
    """One process's steps (bf16, clip 1.0, adamw(CPT_LR)) from the
    script's seeded weights, for each (seed, steps) of `runs` on the
    script's batch from that seed: each step's loss and pre-clip norm
    (`clip_norms`), step 1's update on `sample_tree(params)` (the
    script's strided sample), step 1's time and the flash launches, a
    dict per run. The state is built anew from the seed for each run."""
    import torch

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.optimizers import adamw
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.test_utils.scripts import train_llama_cp as sc
    from accelerate_tpu_torch.training import TrainState

    PartialState._reset_state()
    acc = Accelerator(mixed_precision="bf16", gradient_clipping=1.0)
    fam, cfg = sc.model_config(family, False, layers, None, capacity)
    if family == "llama":
        # the same backend as the ranks': off a `seq` axis the ring is
        # `flash_attention`
        import dataclasses

        cfg = dataclasses.replace(cfg, attention_backend="ring")
    step = acc.train_step(lambda p, b: fam.causal_lm_loss(cfg, p, b))
    out = []
    for seed, steps in runs:
        state = acc.prepare(TrainState.create(
            apply_fn=None, params=fam.init_params(cfg, 0, device=acc.device),
            tx=adamw(CPT_LR)))
        batch = {"input_ids": sc.batch_ids(cfg.vocab_size, 1, seq, seed)}
        counters = sc.flash_counters()
        for fn in counters.values():
            fn.launches = 0
        before = sc.update_sample(sample_tree(state.params))
        losses, norms, local = [], [], []
        with sc.clip_norms(norms, local):
            for i in range(steps):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                if i == 0:
                    ms = (time.perf_counter() - t0) * 1e3
                    update = sc.update_sample(sample_tree(state.params)) \
                        - before
        out.append({"seed": seed, "loss": losses[0], "losses": losses,
                    "norms": norms, "update": update,
                    "step_ms": ms, "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9,
                    "launches": {n: fn.launches
                                 for n, fn in counters.items()}})
        del state, m
        _drop()
    del step, acc
    PartialState._reset_state()
    _drop()
    return out


def _cpt_world(launcher_args, script_args, update_sample):
    """`train_llama_cp.py` launched as two processes (gloo, both on card
    0) with the launcher's `launcher_args`; the launcher's exit code
    checked; each rank's `CPT_RESULT`, and rank 0's step-1 update."""
    import os

    import numpy as np

    script = os.path.join("accelerate_tpu_torch", "test_utils", "scripts",
                          "train_llama_cp.py")
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.launch",
           "--num_processes", "2", *launcher_args, script, *script_args,
           "--update-sample", update_sample]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=CPT_TIMEOUT_S)
    wall = time.perf_counter() - t0
    rows = sorted((json.loads(line.split(" ", 1)[1])
                   for line in proc.stdout.splitlines()
                   if line.startswith("CPT_RESULT {")),
                  key=lambda r: r["rank"])
    if proc.returncode != 0 or len(rows) != 2:
        raise AssertionError(
            f"launch {launcher_args} exited {proc.returncode} with "
            f"{len(rows)} result(s):\n{proc.stdout[-4000:]}\n"
            f"{proc.stderr[-8000:]}")
    return rows, np.load(update_sample), wall


def _update_gap(update, ref, lr=CPT_LR) -> dict:
    import numpy as np

    gap = np.abs(update - ref)
    return {"elements": int(gap.size),
            "share_over_lr": float((gap > lr).mean()),
            "share_over_lr_100": float((gap > lr / 100).mean()),
            "max_abs_over_lr": float(gap.max() / lr)}


def _cpt_gates(part, rows, ref, fault, want, failed, blocks) -> dict:
    """The gates shared by (e) and (f): both ranks' losses, pre-clip
    norms and digests equal at every step, finite; every step's loss
    within CP_LOSS_RTOL (of max(|loss|, 1)) and pre-clip norm within
    CPT_NORM_RTOL[part] of one process's same step, and step 1's update
    within the CPT_UPDATE limits of one process's (where the other
    rows' update must fall outside them); with `blocks` the ranks' own
    gradients' norm outside the norm limit; each rank's flash launches
    `want[rank]`."""
    r0, r1 = rows
    if r0["losses"] != r1["losses"] or r0["digests"] != r1["digests"] \
            or r0["pre_clip_norms"] != r1["pre_clip_norms"]:
        failed.append(f"({part}) the ranks' losses, norms or digests "
                      f"differ: {r0['losses']} {r1['losses']} "
                      f"{r0['pre_clip_norms']} {r1['pre_clip_norms']}")
    if not all(math.isfinite(x) for x in r0["losses"]):
        failed.append(f"({part}) non-finite loss: {r0['losses']}")
    rel = abs(r0["losses"][0] - ref["loss"]) / abs(ref["loss"])
    loss_gaps = [abs(a - b) / max(abs(b), 1.0)
                 for a, b in zip(r0["losses"], ref["losses"])]
    if len(r0["losses"]) != len(ref["losses"]) or \
            max(loss_gaps) > CP_LOSS_RTOL:
        failed.append(f"({part}) losses {r0['losses']} against one "
                      f"process's {ref['losses']}")

    def norm_rel(norm, i=0):
        return abs(norm - ref["norms"][i]) / ref["norms"][i]

    norm_rtol = CPT_NORM_RTOL[part]
    norm_rels = [norm_rel(n, i) for i, n in enumerate(r0["pre_clip_norms"])]
    if len(norm_rels) != len(ref["norms"]) or max(norm_rels) > norm_rtol:
        failed.append(f"({part}) pre-clip norms {r0['pre_clip_norms']} "
                      f"against one process's {ref['norms']}")
    local_rel = max(norm_rel(r["local_norms"][0]) for r in rows)
    if blocks and local_rel <= norm_rtol:
        failed.append(f"({part}) a rank's own gradients' norm reads "
                      f"{local_rel} off one process's, within the norm "
                      "limit")
    gap, fault_gap = ref["gap"], fault["gap"]

    def within(g):
        return (g["share_over_lr"] <= CPT_UPDATE_FLIP_MAX
                and g["share_over_lr_100"] <= CPT_UPDATE_OFF_MAX)

    if not within(gap):
        failed.append(f"({part}) step 1's update off one process's: {gap}")
    if within(fault_gap):
        failed.append(f"({part}) the update on other rows reads "
                      f"{fault_gap}, within the update limits")
    for r in rows:
        if r["launches"] != want[r["rank"]]:
            failed.append(f"({part}) rank {r['rank']}: flash launches "
                          f"{r['launches']}, expected {want[r['rank']]}")
    return {"step1_loss_rel_diff": rel, "ref_loss": ref["loss"],
            "loss_gaps": loss_gaps, "ref_losses": ref["losses"],
            "pre_clip_norms": r0["pre_clip_norms"],
            "ref_norms": ref["norms"], "norm_rel_diffs": norm_rels,
            "own_gradients_norm_rel_diff": local_rel,
            "other_rows_norm_rel_diff": norm_rel(fault["norms"][0]),
            "other_rows_loss": fault["loss"], "update": gap,
            "other_rows_update": fault_gap}


def phase_cp_train(kernel_rows):
    """Training on the `seq` and `expert` axes through the Accelerator,
    `train_llama_cp.py` launched as two processes sharing card 0 over
    gloo. (e) the launcher's `--context_parallel_mode ring
    --context_parallel_degree 2` (mesh {data: 1, seq: 2}):
    llama3-8B width at CPT_LAYERS layers with the ring backend, bf16,
    clip 1.0, one row of CPT_SEQ + 1 tokens, CPT_STEPS steps. (f)
    `--mesh_shape data=-1,expert=2`: Mixtral-8x7B width at
    CPT_MOE_LAYERS layer, `moe_impl="a2a"` at a capacity that drops
    nothing, each rank holding its [L, 4, ...] block of the experts and
    their moments, one row of CPT_MOE_SEQ + 1 tokens, CPT_MOE_STEPS
    steps. Before each launch, in this process and freed first, one
    process's first step on the same seeded weights and batch, and on
    other rows (the fault of a loader that sharded over the world).
    The reference runs as many steps as the ranks on that batch, one on
    the other rows. Gates: the launcher exits 0; both ranks' losses,
    pre-clip norms and whole-model digests equal at every step; every
    step's loss and pre-clip norm within CP_LOSS_RTOL (of max(|loss|,
    1)) and CPT_NORM_RTOL of one process's same step, and step 1's
    update within the CPT_UPDATE limits of one process's, and the other
    rows' update outside them; in (f) the norm of a rank's own
    gradients alone outside the norm limit; the flash launches of the
    steps
    L(r+1) a step on rank r for the ring (causal: a rank skips later
    chunks) and L a step on each rank for Mixtral; in (f) the expert
    leaves and moments [1, 4, ...] on each rank. Then K1a/b/c at each
    shape the phase launched them at against their plain versions,
    timed. The times are reported, not gated: two ranks share one card
    through the host."""
    import os
    import tempfile

    import torch

    from accelerate_tpu_torch.models import mixtral
    from accelerate_tpu_torch.sharding import plan_sharding, shard_pytree
    from accelerate_tpu_torch.state import ProcessMesh

    failed = []
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    with tempfile.TemporaryDirectory(prefix="cp_train_") as tmp:
        ref_e, fault_e = _cpt_reference("llama", CPT_LAYERS, CPT_SEQ, 1.25,
                                        lambda p: p,
                                        ((0, CPT_STEPS), (1, 1)))
        rows_e, update_e, wall_e = _cpt_world(
            ["--context_parallel_mode", "ring",
             "--context_parallel_degree", "2"],
            ["--layers", str(CPT_LAYERS), "--seq_len", str(CPT_SEQ),
             "--steps", str(CPT_STEPS), "--lr", str(CPT_LR)],
            os.path.join(tmp, "update_e.npy"))
        _drop()
        mesh = ProcessMesh({"data": 1, "expert": 2})

        def rank0_block(params):
            # rank 0's leaves: its block of the experts, the rest whole
            return shard_pytree(params, plan_sharding(params, mesh), rank=0)

        ref_f, fault_f = _cpt_reference("mixtral", CPT_MOE_LAYERS,
                                        CPT_MOE_SEQ, CPT_MOE_CAPACITY,
                                        rank0_block,
                                        ((0, CPT_MOE_STEPS), (1, 1)))
        rows_f, update_f, wall_f = _cpt_world(
            ["--mesh_shape", "data=-1,expert=2"],
            ["--family", "mixtral", "--layers", str(CPT_MOE_LAYERS),
             "--seq_len", str(CPT_MOE_SEQ), "--steps", str(CPT_MOE_STEPS),
             "--lr", str(CPT_LR), "--capacity_factor",
             str(CPT_MOE_CAPACITY)],
            os.path.join(tmp, "update_f.npy"))
    for ref, fault, update in ((ref_e, fault_e, update_e),
                               (ref_f, fault_f, update_f)):
        ref["gap"] = _update_gap(update, ref["update"])
        fault["gap"] = _update_gap(fault["update"], ref["update"])
    L, Lm = CPT_LAYERS, CPT_MOE_LAYERS
    want_e = {r: {n: L * (r + 1) * CPT_STEPS for n in names} for r in (0, 1)}
    want_f = {r: {n: Lm * CPT_MOE_STEPS for n in names} for r in (0, 1)}
    gates_e = _cpt_gates("e", rows_e, ref_e, fault_e, want_e, failed,
                         blocks=False)
    gates_f = _cpt_gates("f", rows_f, ref_f, fault_f, want_f, failed,
                         blocks=True)
    cfg = mixtral.MixtralConfig.mixtral_8x7b(num_hidden_layers=Lm)
    h, f, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts
    block = [Lm, E // 2, h, f]
    want_shapes = {"gate_proj": block, "up_proj": block,
                   "down_proj": [Lm, E // 2, f, h]}
    for r in rows_f:
        if r["expert_shapes"] != want_shapes or any(
                r["moment_shapes"][k] != want_shapes for k in ("mu", "nu")):
            failed.append(f"(f) rank {r['rank']}: experts "
                          f"{r['expert_shapes']}, moments "
                          f"{r['moment_shapes']}, expected {want_shapes}")
    n_expert = Lm * E * 3 * h * f
    n_whole = n_expert + (cfg.vocab_size * h * 2 + h + Lm * (
        2 * h + h * E + 2 * h * h + 2 * h * (cfg.num_key_value_heads
                                             * cfg.head_dim)))
    n_rank = n_whole - n_expert // 2
    reckoning = {"params_whole": n_whole, "params_rank": n_rank,
                 "state_after_prepare_gb": {"rank": 12 * n_rank / 1e9,
                                            "whole": 12 * n_whole / 1e9},
                 "with_grads_gb": {"rank": 16 * n_rank / 1e9,
                                   "whole": 16 * n_whole / 1e9},
                 "note": "f32 params and two AdamW moments (12 B a param) "
                         "after prepare; 16 B a param with the gradients"}
    keys = ("losses", "step_ms", "launches", "memory_after_prepare_gb",
            "max_memory_allocated_gb", "line", "mesh")
    emit("cp_train", backend="gloo", ranks_share_one_card=True,
         part_e={"config": "llama3_8b", "layers": L, "seq": CPT_SEQ,
                 "steps": CPT_STEPS, "attention_backend": "ring",
                 "launcher_wall_s": wall_e,
                 **{k: [r[k] for r in rows_e] for k in keys},
                 "digests_rank0": rows_e[0]["digests"],
                 "reference": {k: v for k, v in ref_e.items()
                               if k != "update"},
                 **gates_e},
         part_f={"config": "mixtral_8x7b", "layers": Lm,
                 "seq": CPT_MOE_SEQ, "steps": CPT_MOE_STEPS,
                 "moe_impl": "a2a", "capacity_factor": CPT_MOE_CAPACITY,
                 "launcher_wall_s": wall_f,
                 **{k: [r[k] for r in rows_f] for k in keys},
                 "expert_shapes": rows_f[0]["expert_shapes"],
                 "digests_rank0": rows_f[0]["digests"],
                 "reference": {k: v for k, v in ref_f.items()
                               if k != "update"},
                 "memory_reckoning": reckoning, **gates_f},
         tolerances={"loss_rtol": CP_LOSS_RTOL,
                     "norm_rtol": CPT_NORM_RTOL,
                     "update_flip_max": CPT_UPDATE_FLIP_MAX,
                     "update_off_max": CPT_UPDATE_OFF_MAX},
         note="two ranks share one card through the host (gloo): these "
              "times are not sequence- or expert-parallel speed")
    if failed:
        raise AssertionError("; ".join(failed))
    # the launches by shape: each ring rank runs its diagonal chunk
    # (causal) once a layer a step, rank 1 its off-diagonal chunk too;
    # Mixtral's attention is the whole sequence, causal, on each rank
    diagonal = {n: L * CPT_STEPS * 2 for n in names}
    off = {n: sum(r["launches"][n] for r in rows_e) - diagonal[n]
           for n in names}
    causal = {n: diagonal[n] + sum(r["launches"][n] for r in rows_f)
              for n in names}
    torch.cuda.reset_peak_memory_stats()
    kernel_rows.extend(_flash_rows_at("cp_train", off, 1, CPT_SEQ // 2, 32,
                                      128, causal=False))
    kernel_rows.extend(_flash_rows_at("cp_train_causal", causal, 1,
                                      CPT_SEQ // 2, 32, 128))
    return {"e": rows_e, "f": rows_f}


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
    t_start = time.perf_counter()
    info = _run(phase_device)
    _run(phase_build)
    kernels = _run(phase_paged_kernel)
    kernels += _run(phase_flash_kernel)
    _run(phase_small_parity)
    _run(phase_zoo_small_parity)
    cfg, params, eng, prompts, temps, numbers = _run(phase_engine,
                                                     kernels[:1])
    _run(phase_kernel_vs_dense, cfg, params, eng, numbers)
    _run(phase_server, cfg, eng)
    del eng
    _drop()
    _run(phase_telemetry, cfg, params, prompts, temps, numbers, kernels)
    _drop()
    _run(phase_serve_cli)
    _run(phase_speculative, cfg, params, prompts, temps, numbers)
    _drop()
    _run(phase_host_tier, cfg, params)
    _drop()
    _run(phase_pod, cfg, params, prompts, temps, numbers, kernels)
    _drop()
    _run(phase_pod_distributed, cfg, params, prompts, temps, numbers)
    del params
    _drop()
    _run(phase_pod_cli)
    _run(phase_pod_tp)
    _run(phase_pipeline, kernels)
    _drop()
    _run(phase_context_parallel, kernels)
    _drop()
    _run(phase_cp_train, kernels)
    _drop()
    _run(phase_gptj_engine, kernels)
    _drop()
    bf16 = _run(phase_train, kernels)
    _drop()
    _run(phase_eager_train, kernels, bf16)
    _drop()
    _run(phase_data_train, kernels, bf16)
    _drop()
    _run(phase_telemetry_train, kernels, bf16)
    _drop()
    _run(phase_fp8_train, kernels, bf16)
    _drop()
    _run(phase_resilient)
    _drop()
    _run(phase_train_flash_vs_einsum)
    _drop()
    _run(phase_head_grad)
    _drop()
    _run(phase_mixtral_train, kernels)
    _drop()
    dp = _run(phase_dp_train, kernels)
    _drop()
    _run(phase_zero_train, kernels, dp)
    del dp
    _drop()
    _run(phase_big_model, kernels)
    emit("phase_walls", walls=_WALLS,
         total_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
