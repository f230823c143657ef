"""Llama-family causal LM (port of `accelerate_tpu/models/llama.py`).

Params are a nested dict with the reference tree's keys and its stacked
`[L, ...]` layer shapes (`models/convert.py` moves a JAX tree across
unchanged). The forward loops over layers, indexing views of the stacked
tensors. This slice ports what serving runs: the cached decode/prefill
forward, the no-cache forward on the einsum attention path, and
`generate`. Training (remat, the flash kernels, the loss) and the
parallel attention backends come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .common import (
    apply_rope,
    dense,
    dot_product_attention,
    repeat_kv,
    rms_norm,
    rope_frequencies,
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
        return cls(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            max_position_embeddings=8192, rope_theta=500000.0, **overrides,
        )

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


def select_attention_backend(backend: str) -> str:
    """Resolve the no-cache attention backend. "auto" is the einsum path
    until the flash kernel (K1) is ported; "flash" and the sequence-
    parallel backends raise until their slices land."""
    if backend in ("auto", "einsum"):
        return "einsum"
    if backend == "flash":
        raise NotImplementedError(
            "attention_backend='flash' needs the flash-attention kernels "
            "(K1a-c), which the port gains with its training slice")
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
        # one backend so far: this raises for the ones not ported yet
        select_attention_backend(config.attention_backend)
        out = dot_product_attention(q, repeat_kv(k, nh // nkv),
                                    repeat_kv(v, nh // nkv), mask=mask,
                                    causal=True, window=config.sliding_window)
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
    if config.remat or config.sequence_parallel:
        raise NotImplementedError(
            "remat and sequence_parallel are training features; they arrive "
            "with the port's training and parallelism slices")
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

    for i in range(config.num_hidden_layers):
        x, _ = _layer_body(config, x, _layer_view(layers, i), cos, sin,
                           positions, attention_mask)
    x = rms_norm(x, params["norm"]["scale"], config.rms_norm_eps)
    if return_hidden:
        return x
    return _project_out(config, params, x)


def _project_out(config: LlamaConfig, params: dict, x):
    """f32 logits from the head's product in x's dtype: bf16 inputs give
    exact products accumulated in f32 and are NOT rounded to bf16 first
    (a bf16 matmul followed by `.float()` would round, and flip near-tie
    argmaxes). On CUDA that is cuBLAS's bf16 GEMM with an f32 output
    (`out_dtype`), no upcast copy of the head; on the CPU the inputs are
    upcast, which is exact."""
    if config.tie_word_embeddings:
        w = params["embed_tokens"]["embedding"].to(x.dtype).t()
    else:
        w = params["lm_head"]["kernel"].to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = x2 @ w
    elif x.is_cuda:
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*x.shape[:-1], w.shape[-1])


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
