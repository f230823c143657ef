"""Shared pure-function model components (port of
`accelerate_tpu/models/common.py`).

Same functions, same layouts ([B, S, H, D] activations, [d_in, d_out]
kernels), same numerics contract: matmuls accumulate in f32 and cast to
the input dtype, norms and softmax run in f32, and dtype promotion follows
JAX's (a bf16 result times an f32 scale is f32).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import resolve_device
from ..ops.fp8 import SCALED_MM_OP, fp8_dense

NEG_INF = -1e30


def sp_constrain(x, axis=None):
    """Megatron sequence parallelism's activation constraint. It needs a
    sharded mesh: it arrives with the sharded-parallelism slice."""
    raise NotImplementedError(
        "sequence parallelism (sp_constrain) arrives with the port's "
        "sharded-parallelism slice (ROADMAP.md, queue 1 item 6b)")


def dense(x: torch.Tensor, kernel: torch.Tensor,
          bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ kernel with f32 accumulation, cast back to x's dtype. For a
    bf16 product cuBLAS (and the CPU GEMM) accumulate in f32 and round the
    result once, which is the reference's `preferred_element_type=f32`
    followed by `.astype(x.dtype)`."""
    ct = torch.promote_types(x.dtype, kernel.dtype)
    out = torch.matmul(x.to(ct), kernel.to(ct)).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out


def dense_maybe_fp8(x, kernel, meta, bias=None):
    """The models' fp8 swap point: with an Fp8Meta pair the projection
    runs in fp8 (`ops.fp8.fp8_dense`), else the ordinary `dense`. Returns
    (out, new_meta or None); a bias adds in the output dtype after the
    product."""
    if meta is None:
        return dense(x, kernel, bias), None
    out, new_meta = fp8_dense(x, kernel, meta)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out, new_meta


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * scale


# --- rotary embeddings ------------------------------------------------------


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     scaling: dict | None = None, device=None) -> tuple:
    """Rotary cos/sin tables [max_len, head_dim/2] f32, optionally
    frequency-scaled (`scaling` is the HF `rope_scaling` dict: "linear" or
    "llama3"). Computed in float64 numpy and cast to f32, exactly as the
    reference does; cached per (shape, scaling, device), so callers must
    not write into the returned tensors."""
    items = tuple(sorted(scaling.items())) if scaling else None
    return _rope_tables(head_dim, max_len, float(theta), items,
                        str(torch.device("cpu" if device is None else device)))


# never evicted: a captured CUDA graph (serving/graphs.py) reads the
# tables by address, so they must outlive every graph that captured them;
# one entry per (head_dim, table length, theta, scaling, device)
@functools.cache
def _rope_tables(head_dim: int, max_len: int, theta: float, items,
                 device: str) -> tuple:
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    if items:
        scaling = dict(items)
        rope_type = scaling.get("rope_type", scaling.get("type", "default"))
        if rope_type == "llama3":
            factor = scaling["factor"]
            low = scaling["low_freq_factor"]
            high = scaling["high_freq_factor"]
            old_len = scaling["original_max_position_embeddings"]
            wavelen = 2 * np.pi / inv_freq
            scaled = np.where(wavelen > old_len / low, inv_freq / factor,
                              inv_freq)
            smooth = (old_len / wavelen - low) / (high - low)
            smoothed = (1 - smooth) * scaled / factor + smooth * scaled
            medium = (wavelen <= old_len / low) & (wavelen >= old_len / high)
            inv_freq = np.where(medium, smoothed, scaled)
        elif rope_type == "linear":
            inv_freq = inv_freq / scaling["factor"]
        elif rope_type not in ("default", None):
            raise ValueError(f"unsupported rope_scaling type {rope_type!r}")
    freqs = np.outer(np.arange(max_len), inv_freq)
    return (torch.tensor(np.cos(freqs), dtype=torch.float32, device=device),
            torch.tensor(np.sin(freqs), dtype=torch.float32, device=device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S]."""
    dtype = x.dtype
    positions = positions.long()
    c = cos[positions][:, :, None, :]  # [B, S, 1, D/2]
    s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


# --- attention --------------------------------------------------------------


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: repeat kv heads [B,S,Hkv,D] -> [B,S,Hkv*n_rep,D]."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    causal: bool = False,
    window: int | None = None,
) -> torch.Tensor:
    """[B, S, H, D] attention with an f32 softmax. Both products take the
    inputs upcast to f32 (exact for bf16) and accumulate in f32, as the
    reference's `preferred_element_type=f32` einsums do. `window` limits
    causal reach to q - key < window (HF sliding-window convention)."""
    depth = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(depth)
    if causal or window is not None:
        s_q, s_k = q.shape[1], k.shape[1]
        q_pos = (torch.arange(s_q, device=q.device)[:, None]
                 + (s_k - s_q))  # bottom-aligned
        k_pos = torch.arange(s_k, device=q.device)[None, :]
        keep = (q_pos >= k_pos if causal
                else torch.ones((s_q, s_k), dtype=torch.bool, device=q.device))
        if window is not None:
            keep = keep & (q_pos - k_pos < window)
        scores = torch.where(keep[None, None], scores, NEG_INF)
    if mask is not None:
        # mask: [B, S_k] padding, [B, S_q, S_k], or [B, H|1, S_q, S_k]
        if mask.ndim == 2:
            mask = mask[:, None, None, :]
        elif mask.ndim == 3:
            mask = mask[:, None, :, :]
        scores = torch.where(mask.bool(), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return out.to(dtype) * scale + bias


# --- initializers -----------------------------------------------------------


class _MetaGenerator:
    """The generator of an `init_params` under `device.meta_init`: torch
    has no generator on the meta device, and a draw there needs none."""

    device = torch.device("meta")


def make_generator(generator, device=None):
    """(device, generator) for an `init_params`: `device` resolved (CUDA
    unless "cpu"; meta under `device.meta_init`), and `generator` as given
    or, for a seed, a new `torch.Generator` on that device seeded with
    it."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return dev, _MetaGenerator()
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    elif torch.device(generator.device).type != dev.type:
        raise ValueError(f"a generator on {generator.device} cannot draw "
                         f"params on {dev}")
    return dev, generator


def normal_init(generator: torch.Generator, shape, stddev: float = 0.02,
                dtype=torch.float32) -> torch.Tensor:
    """N(0, stddev) of `shape` from `generator`, on its device (on the
    meta device: the shape and dtype alone)."""
    if generator.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=generator.device).mul_(stddev)


def init_dense(generator: torch.Generator, d_in: int, d_out: int,
               stddev: float = 0.02, bias: bool = False,
               dtype=torch.float32) -> dict:
    params = {"kernel": normal_init(generator, (d_in, d_out), stddev, dtype)}
    if bias:
        params["bias"] = torch.zeros((d_out,), dtype=dtype,
                                     device=generator.device)
    return params


def learned_positions(table: torch.Tensor, positions: torch.Tensor):
    """Rows of a learned position table, indices past its end clamped to
    the last row (the reference's gather clamps; torch would raise)."""
    return table[positions.long().clamp(max=table.shape[0] - 1)]


# --- the stacked layer loop -------------------------------------------------


def layer_view(tree, i: int):
    """Layer i of a stacked [L, ...] param tree, as views."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    return tree[i]


def unstack_layers(tree, n: int) -> list:
    """The first n layers of a stacked [L, ...] param (or fp8 meta) tree,
    as views, by one `unbind` per leaf. Its backward writes each leaf's
    gradient once; indexing layer by layer would add a zero-padded
    full-size gradient per layer (L times the traffic)."""
    if isinstance(tree, dict):
        parts = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    if isinstance(tree, tuple):     # an Fp8Meta
        parts = [unstack_layers(v, n) for v in tree]
        return [type(tree)(*(p[i] for p in parts)) for i in range(n)]
    return list(torch.unbind(tree)[:n])


def stack_layers(trees: list):
    """Per-layer trees of one structure stacked on a new layer dim."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):    # an Fp8Meta
        return type(first)(*(stack_layers([t[j] for t in trees])
                             for j in range(len(first))))
    return torch.stack(trees)


def save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat "dots": keep the outputs of
    products without batch dims (the projections, bf16 or fp8), as the
    reference's `dots_with_no_batch_dims_saveable`; recompute everything
    else, attention and the fp8 casts included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.aten._scaled_mm.default, SCALED_MM_OP):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def rematted(body, remat: bool, policy: str = "full"):
    """`body` under `torch.utils.checkpoint` when `remat`: "full"
    recomputes all of it in backward (the reference's `jax.checkpoint`
    of the layer), "dots" keeps the projections' outputs."""
    if not remat:
        return body
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {policy!r}; use 'full' or "
                         "'dots'")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, save_matmuls)

    def run(*args):
        return checkpoint(body, *args, use_reentrant=False, **kw)

    return run


def run_layers(body, x, layers, n: int, fp8_layers=None):
    """x through the n stacked layers: `body(x, layer, metas)` returns
    (x, new metas or None). Returns (x, None), or with `fp8_layers` (the
    stacked per-layer metas) (x, {"layers": the new metas, stacked})."""
    if fp8_layers is None:
        for layer in unstack_layers(layers, n):
            x, _ = body(x, layer, None)
        return x, None
    new = []
    for layer, metas in zip(unstack_layers(layers, n),
                            unstack_layers(fp8_layers, n)):
        x, m = body(x, layer, metas)
        new.append(m)
    return x, {"layers": stack_layers(new)}


def _split_bf16(g: torch.Tensor) -> torch.Tensor:
    """An f32 tensor [N, V] as three bf16 parts stacked to [3N, V] whose
    sum is g exactly: each part takes the next 8 significant bits of
    what the earlier parts left, and three hold all 24 of an f32 (for
    |g| above 2^-110, where the third part is still a normal bf16)."""
    parts, rest = [], g
    for _ in range(3):
        part = rest.to(torch.bfloat16)
        parts.append(part)
        rest = rest - part.float()
    return torch.cat(parts)


class _HeadF32(torch.autograd.Function):
    """x2 [N, H] @ w [H, V] in bf16 or f16 with f32 logits out (cuBLAS's
    GEMM with an f32 output: exact products, f32 accumulation, no
    rounding of the logits), differentiable.

    The backward follows the reference's transpose rule: the products are
    taken against the f32 cotangent and rounded once, at the end, to the
    operand's dtype. In bf16 that stays on the tensor cores: the cotangent
    splits exactly into three bf16 parts (`_split_bf16`), whose products
    with bf16 operands are exact and accumulate in f32, so dx and dw are
    the f32-cotangent products up to the rounding of that accumulation
    (the same as in any bf16 GEMM), at three times a bf16 GEMM's work.
    f16's range cannot hold the parts, so f16 operands are upcast and
    multiplied in f32."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.float()
        dx = dw = None
        if x2.dtype != torch.bfloat16:
            if ctx.needs_input_grad[0]:
                dx = (g @ w.float().t()).to(x2.dtype)
            if ctx.needs_input_grad[1]:
                dw = (x2.float().t() @ g).to(w.dtype)
            return dx, dw
        parts = _split_bf16(g)
        if ctx.needs_input_grad[0]:
            # one GEMM over the stacked parts, f32 out, the three summed
            dx = torch.mm(parts, w.t(), out_dtype=torch.float32).view(
                3, *x2.shape).sum(0).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            # the parts stacked along the contraction: one bf16 GEMM,
            # f32 accumulation, rounded once to bf16
            dw = torch.mm(x2.t().repeat(1, 3), parts)
        return dx, dw


def logits_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., H] @ w [H, V] in x's dtype with f32 logits out, the
    reference's `einsum(..., preferred_element_type=f32)` of a head:
    bf16 inputs give exact products accumulated in f32 and are NOT
    rounded to bf16 first (a bf16 matmul followed by `.float()` would
    round, and flip near-tie argmaxes). On CUDA that is `_HeadF32`
    (cuBLAS's bf16 GEMM with an f32 output, no upcast copy of the head);
    on the CPU the inputs are upcast, which is exact, and autograd
    differentiates the upcast."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = x2 @ w
    elif x.is_cuda:
        out = _HeadF32.apply(x2, w)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*x.shape[:-1], w.shape[-1])


# --- losses -----------------------------------------------------------------


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-token negative log-likelihood in f32 (stable under bf16
    logits). Shared by the full and chunked loss paths."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(log_probs, -1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0:
        smooth = -torch.mean(log_probs, dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    return nll


def shifted_padding_masks(mask):
    """(attention_mask, label_weights) for a next-token loss over
    `input_ids` with a [B, S] padding mask (1 = real): the key mask for
    the forward over input_ids[:, :-1], and f32 label weights that count
    a label only when it AND its predicting token are real."""
    if mask is None:
        return None, None
    return mask[:, :-1], (mask[:, 1:] * mask[:, :-1]).float()


def causal_lm_loss_of(forward_fn, config, params: dict, batch: dict,
                      fp8_state=None):
    """The zoo's next-token loss over {input_ids, attention_mask?}
    through `forward_fn`: the mask keys the forward and weights the loss
    (`shifted_padding_masks`)."""
    input_ids = batch["input_ids"]
    labels = input_ids[:, 1:]
    attn_mask, mask = shifted_padding_masks(batch.get("attention_mask"))
    out = forward_fn(config, params, input_ids[:, :-1],
                     attention_mask=attn_mask, fp8_state=fp8_state)
    if fp8_state is not None:
        logits, new_fp8 = out
        return cross_entropy_loss(logits, labels, mask), new_fp8
    return cross_entropy_loss(out, labels, mask)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in f32."""
    nll = token_nll(logits, labels, label_smoothing)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(np.prod(params.shape))
