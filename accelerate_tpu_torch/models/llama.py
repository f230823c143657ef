"""Llama-family causal LM (port of `accelerate_tpu/models/llama.py`).

Params are a nested dict with the reference tree's keys and its stacked
`[L, ...]` layer shapes (`models/convert.py` moves a JAX tree across
unchanged). The forward loops over layers, indexing views of the stacked
tensors. Ported: the cached decode/prefill forward and `generate`
(serving), and the training half: the no-cache forward on the einsum or
flash attention path (`ops/flash_attention.py`, CUDA kernels on the card),
per-layer remat, and `causal_lm_loss` with its chunked path. The
sequence-parallel backends ("ring", "ulysses", `sequence_parallel`) and
fp8 state come with later slices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from .common import (
    apply_rope,
    cross_entropy_loss,
    dense,
    dot_product_attention,
    repeat_kv,
    rms_norm,
    rope_frequencies,
    shifted_padding_masks,
    token_nll,
)
from .decode import build_generate, decode_attention, make_kv_caches, \
    rope_table_len


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    # HF-style dict, e.g. {"rope_type": "llama3", ...}; normalized to a
    # sorted item tuple so the config stays hashable
    rope_scaling: Any = None
    rms_norm_eps: float = 1e-6
    # q/k/v projection biases (the Qwen2 layout); the forward applies
    # whichever biases the param tree holds
    attention_bias: bool = False
    # sliding-window attention: keys visible iff q - key < window
    sliding_window: int | None = None
    tie_word_embeddings: bool = False
    attention_backend: str = "auto"  # auto | einsum | flash | ring | ulysses
    sequence_parallel: bool = False
    remat: bool = False
    remat_policy: str = "full"

    def __post_init__(self):
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(
                self, "rope_scaling", tuple(sorted(self.rope_scaling.items()))
            )

    @property
    def rope_scaling_dict(self) -> dict | None:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama3_8b(cls, **overrides) -> "LlamaConfig":
        """Llama-3-8B's widths; any field, depth included, may be
        overridden."""
        fields = dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            max_position_embeddings=8192, rope_theta=500000.0,
        )
        fields.update(overrides)
        return cls(**fields)

    @classmethod
    def tiny(cls, **overrides) -> "LlamaConfig":
        """Test/debug size."""
        defaults = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128,
        )
        defaults.update(overrides)
        return cls(**defaults)


def select_attention_backend(backend: str, *, on_cuda: bool, decoding: bool,
                             seq_len: int) -> str:
    """Resolve the no-cache attention backend, by the reference's rule:
    "auto" is "flash" on the card when not decoding and from 1024 tokens
    up, else "einsum" (the threshold is the reference's, not retuned
    here). "flash" on a CPU tensor runs the kernels' plain versions; the
    sequence-parallel backends raise until their slice lands."""
    if backend == "auto":
        return ("flash" if on_cuda and not decoding and seq_len >= 1024
                else "einsum")
    if backend in ("einsum", "flash"):
        return backend
    if backend in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention_backend={backend!r} arrives with the port's "
            "parallelism slice")
    raise ValueError(f"unknown attention_backend {backend!r}")


def init_params(config: LlamaConfig, generator: torch.Generator | int = 0,
                dtype=torch.float32, device=None) -> dict:
    """Stacked-layer params, N(0, 0.02) kernels and unit norm scales,
    drawn from `generator` (or a seed) on `device` (CUDA unless "cpu")."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    h, kv = config.hidden_size, config.num_key_value_heads * config.head_dim
    L = config.num_hidden_layers

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev).mul_(0.02)

    def stack(d_in, d_out, bias=False):
        out = {"kernel": normal(L, d_in, d_out)}
        if bias:
            out["bias"] = torch.zeros((L, d_out), dtype=dtype, device=dev)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    ab = config.attention_bias
    params = {
        "embed_tokens": {"embedding": normal(config.vocab_size, h)},
        "layers": {
            "input_layernorm": {"scale": ones(L, h)},
            "attn": {
                "q_proj": stack(h, h, bias=ab),
                "k_proj": stack(h, kv, bias=ab),
                "v_proj": stack(h, kv, bias=ab),
                "o_proj": stack(h, h),
            },
            "post_attention_layernorm": {"scale": ones(L, h)},
            "mlp": {
                "gate_proj": stack(h, config.intermediate_size),
                "up_proj": stack(h, config.intermediate_size),
                "down_proj": stack(config.intermediate_size, h),
            },
        },
        "norm": {"scale": ones(h)},
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = {"kernel": normal(h, config.vocab_size)}
    return params


def _layer_view(tree, i: int):
    """Layer i of a stacked [L, ...] param tree, as views."""
    if isinstance(tree, dict):
        return {k: _layer_view(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The first n layers of a stacked [L, ...] param tree, as views, by
    one `unbind` per leaf. Its backward writes each leaf's gradient once;
    indexing layer by layer would add a zero-padded full-size gradient
    per layer (L times the traffic)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return list(torch.unbind(tree)[:n])


def _attention(config: LlamaConfig, layer: dict, x, cos, sin, positions,
               mask, kv_cache=None):
    b, s, _ = x.shape
    nh, nkv, hd = (config.num_attention_heads, config.num_key_value_heads,
                   config.head_dim)
    attn = layer["attn"]
    q = dense(x, attn["q_proj"]["kernel"])
    k = dense(x, attn["k_proj"]["kernel"])
    v = dense(x, attn["v_proj"]["kernel"])
    if "bias" in attn["q_proj"]:
        q = q + attn["q_proj"]["bias"].to(q.dtype)
    if "bias" in attn["k_proj"]:
        k = k + attn["k_proj"]["bias"].to(k.dtype)
    if "bias" in attn["v_proj"]:
        v = v + attn["v_proj"]["bias"].to(v.dtype)
    q = apply_rope(q.reshape(b, s, nh, hd), cos, sin, positions)
    k = apply_rope(k.reshape(b, s, nkv, hd), cos, sin, positions)
    v = v.reshape(b, s, nkv, hd)
    new_cache = None
    if kv_cache is not None:
        # the shared cache-attend step (models/decode.py): dense stacked
        # caches take the extend/mask/einsum path; the serving engine's
        # paged pool goes through the paged decode kernel
        out, new_cache = decode_attention(
            q, k, v, kv_cache, positions, mask=mask,
            window=config.sliding_window, n_rep=nh // nkv)
    else:
        backend = select_attention_backend(
            config.attention_backend, on_cuda=x.is_cuda, decoding=False,
            seq_len=s)
        k, v = repeat_kv(k, nh // nkv), repeat_kv(v, nh // nkv)
        if backend == "flash" and (mask is None or mask.ndim == 2):
            out = flash_attention(q, k, v, causal=True, mask=mask,
                                  window=config.sliding_window)
        else:
            out = dot_product_attention(q, k, v, mask=mask, causal=True,
                                        window=config.sliding_window)
    o = dense(out.reshape(b, s, nh * hd), attn["o_proj"]["kernel"])
    if "bias" in attn["o_proj"]:
        o = o + attn["o_proj"]["bias"].to(o.dtype)
    return o, new_cache


def _mlp(layer: dict, x):
    mlp = layer["mlp"]
    gate = dense(x, mlp["gate_proj"]["kernel"])
    up = dense(x, mlp["up_proj"]["kernel"])
    return dense(F.silu(gate) * up, mlp["down_proj"]["kernel"])


def _layer_body(config: LlamaConfig, x, layer, cos, sin, positions, mask,
                kv_cache=None):
    attn_out, new_cache = _attention(
        config, layer,
        rms_norm(x, layer["input_layernorm"]["scale"], config.rms_norm_eps),
        cos, sin, positions, mask, kv_cache,
    )
    x = x + attn_out
    x = x + _mlp(layer, rms_norm(x, layer["post_attention_layernorm"]["scale"],
                                 config.rms_norm_eps))
    return x, new_cache


def forward(
    config: LlamaConfig,
    params: dict,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    kv_caches: Any = None,
    return_hidden: bool = False,
):
    """Logits [B, S, V] (f32); with kv_caches, (logits, new_caches); with
    `return_hidden`, the final normed hidden states instead of logits.

    kv_caches is (k, v, cache_len) of stacked [L, B, M, Hkv, D] buffers
    (written in place; cache_len an int or an int tensor, 0-dim or [B]),
    or the serving pool's (PagedKV, PagedKV, PagedDecodeMeta), for which
    new_caches carries this step's K/V rows stacked as [L, B, 1, Hkv, D]."""
    if return_hidden and kv_caches is not None:
        raise ValueError("return_hidden is not supported on the decode "
                         "(kv_caches) path")
    if config.sequence_parallel:
        raise NotImplementedError(
            "sequence_parallel arrives with the port's parallelism slice")
    x = params["embed_tokens"]["embedding"][input_ids.long()]
    if positions is None:
        positions = torch.arange(input_ids.shape[1],
                                 device=x.device).expand(input_ids.shape)
    cos, sin = rope_frequencies(
        config.head_dim,
        rope_table_len(config.max_position_embeddings, kv_caches),
        config.rope_theta, scaling=config.rope_scaling_dict, device=x.device)
    layers = params["layers"]

    if kv_caches is not None:
        ck, cv, cache_len = kv_caches
        rows_k, rows_v = [], []
        for i in range(config.num_hidden_layers):
            x, (nk, nv, _) = _layer_body(
                config, x, _layer_view(layers, i), cos, sin, positions,
                attention_mask, (ck[i], cv[i], cache_len))
            rows_k.append(nk)
            rows_v.append(nv)
        x = rms_norm(x, params["norm"]["scale"], config.rms_norm_eps)
        logits = _project_out(config, params, x)
        if getattr(ck, "is_paged_kv", False):
            return logits, (torch.stack(rows_k), torch.stack(rows_v),
                            cache_len)
        # dense caches were extended in place
        return logits, (ck, cv, cache_len + input_ids.shape[1])

    body = _remat_body(config)
    for layer in _unstack(layers, config.num_hidden_layers):
        x = body(x, layer, cos, sin, positions, attention_mask)
    x = rms_norm(x, params["norm"]["scale"], config.rms_norm_eps)
    if return_hidden:
        return x
    return _project_out(config, params, x)


def _layer_step(x, layer, cos, sin, positions, mask, *, config):
    return _layer_body(config, x, layer, cos, sin, positions, mask)[0]


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat "dots": keep the outputs of
    products without batch dims (the projections), as the reference's
    `dots_with_no_batch_dims_saveable`; recompute everything else,
    attention included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_body(config: LlamaConfig):
    """The per-layer step `(x, layer, cos, sin, positions, mask) -> x`,
    under `torch.utils.checkpoint` when `config.remat`: "full" recomputes
    the whole layer in backward, "dots" keeps the projections' outputs.
    Either way the attention forward reruns in backward (with the flash
    backend: K1a launches twice per layer and step), as under the
    reference's policies."""
    body = functools.partial(_layer_step, config=config)
    if not config.remat:
        return body
    if config.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {config.remat_policy!r}; "
                         "use 'full' or 'dots'")
    kw = {}
    if config.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)

    def remat(*args):
        return checkpoint(body, *args, use_reentrant=False, **kw)

    return remat


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


def _project_out(config: LlamaConfig, params: dict, x):
    """f32 logits from the head's product in x's dtype: bf16 inputs give
    exact products accumulated in f32 and are NOT rounded to bf16 first
    (a bf16 matmul followed by `.float()` would round, and flip near-tie
    argmaxes). On CUDA that is `_HeadF32` (cuBLAS's bf16 GEMM with an f32
    output, no upcast copy of the head); on the CPU the inputs are
    upcast, which is exact, and autograd differentiates the upcast."""
    if config.tie_word_embeddings:
        w = params["embed_tokens"]["embedding"].to(x.dtype).t()
    else:
        w = params["lm_head"]["kernel"].to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = x2 @ w
    elif x.is_cuda:
        out = _HeadF32.apply(x2, w)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*x.shape[:-1], w.shape[-1])


def causal_lm_loss(config: LlamaConfig, params: dict, batch: dict,
                   loss_chunk_size: int | None = None,
                   fp8_state: Any = None) -> torch.Tensor:
    """Next-token loss over a batch {input_ids, attention_mask?}.

    The [B, S, V] f32 logits are the largest buffer of a step, so when S
    divides into chunks (auto-picked so a chunk's logits stay ~256 MB)
    the projection and cross-entropy run per chunk under a checkpoint,
    and the full logits never exist. The attention_mask is a key-padding
    mask for the forward AND weights the loss (`shifted_padding_masks`);
    positions stay 0..S-1, so batches should be right-padded."""
    if fp8_state is not None:
        raise NotImplementedError(
            "fp8_state (mixed_precision='fp8') arrives with the port's fp8 "
            "slice")
    input_ids = batch["input_ids"]
    labels = input_ids[:, 1:]
    attn_mask, mask = shifted_padding_masks(batch.get("attention_mask"))
    B, S = labels.shape

    if loss_chunk_size is None:
        budget = 256 * 2**20 // 4  # f32 elements per chunk of logits
        loss_chunk_size = max(1, budget // max(1, B * config.vocab_size))
    chunk = _pick_chunk(S, loss_chunk_size)
    if chunk is None or chunk >= S:
        logits = forward(config, params, input_ids[:, :-1],
                         attention_mask=attn_mask)
        return cross_entropy_loss(logits, labels, mask)

    hidden = forward(config, params, input_ids[:, :-1],
                     attention_mask=attn_mask, return_hidden=True)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)

    def body(h, lab, m):
        nll = token_nll(_project_out(config, params, h), lab)
        return torch.sum(nll * m), torch.sum(m)

    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, S, chunk):
        # checkpointed: backward recomputes a chunk's logits instead of
        # keeping every chunk's, which would rebuild the full buffer
        part, n = checkpoint(body, hidden[:, c:c + chunk],
                             labels[:, c:c + chunk], mask[:, c:c + chunk],
                             use_reentrant=False)
        loss_sum = loss_sum + part
        count = count + n
    return loss_sum / torch.clamp(count, min=1)


def _pick_chunk(S: int, target: int) -> int | None:
    """Largest divisor of S that is <= target; None when chunking is not
    worthwhile (S already small, or the best divisor so far below the
    target that the loop would degenerate into per-token products)."""
    if S <= target:
        return None
    best = None
    for c in range(min(target, S - 1), 0, -1):
        if S % c == 0:
            best = c
            break
    if best is None or best < max(1, target // 8):
        return None
    return best


def init_kv_caches(config: LlamaConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    """Stacked decode caches: (k [L, B, M, KV, D], v [L, B, M, KV, D],
    cache_len 0)."""
    return make_kv_caches(config.num_hidden_layers, batch, max_len,
                          config.num_key_value_heads, config.head_dim, dtype,
                          device=device)


# Greedy/temperature decode with a KV cache: one prefill, then a python
# loop of one-token decode steps.
generate = build_generate(forward, init_kv_caches)
