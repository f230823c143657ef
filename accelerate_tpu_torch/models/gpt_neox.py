"""GPT-NeoX causal LM (port of `accelerate_tpu/models/gpt_neox.py`).

NeoX specifics, as the reference has them: a fused qkv projection packed
per head (its output is [head][q|k|v][head_dim], so it reshapes to
[B, S, H, 3, D], not split in thirds), rotate-half rotary on the first
`rotary_pct` of each head's dims, LayerNorms with biases, the parallel
residual (`use_parallel_residual`, both ways), an exact (erf) GELU in
f32, and an untied `embed_out` head.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.fp8 import stacked_fp8_metas
from .common import (
    apply_rope,
    causal_lm_loss_of,
    dense_maybe_fp8,
    dot_product_attention,
    layer_norm,
    logits_f32,
    make_generator,
    normal_init,
    rope_frequencies,
    run_layers,
)
from .decode import (
    build_generate,
    build_streamed_generate,
    cached_layers,
    decode_attention,
    make_kv_caches,
    rope_table_len,
)


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig:
    vocab_size: int = 50432
    hidden_size: int = 6144
    intermediate_size: int = 24576
    num_hidden_layers: int = 44
    num_attention_heads: int = 64
    max_position_embeddings: int = 2048
    rotary_pct: float = 0.25
    rotary_emb_base: float = 10000.0
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_ndims(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    @classmethod
    def tiny(cls, **overrides) -> "GPTNeoXConfig":
        defaults = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=128,
        )
        defaults.update(overrides)
        return cls(**defaults)


def init_params(config: GPTNeoXConfig, generator: torch.Generator | int = 0,
                dtype=torch.float32, device=None) -> dict:
    """The reference's tree: N(0, 0.02) kernels, zero biases, unit norm
    scales, drawn from `generator` (or a seed) on `device` (CUDA unless
    "cpu")."""
    dev, g = make_generator(generator, device)
    h, L, f = (config.hidden_size, config.num_hidden_layers,
               config.intermediate_size)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def lin(d_in, d_out):
        return {"kernel": normal_init(g, (L, d_in, d_out), 0.02, dtype),
                "bias": zeros(L, d_out)}

    def ln():
        return {"scale": torch.ones((L, h), dtype=dtype, device=dev),
                "bias": zeros(L, h)}

    return {
        "embed_in": {"embedding": normal_init(g, (config.vocab_size, h),
                                              0.02, dtype)},
        "layers": {
            "input_layernorm": ln(),
            "attn": {"query_key_value": lin(h, 3 * h), "dense": lin(h, h)},
            "post_attention_layernorm": ln(),
            "mlp": {"dense_h_to_4h": lin(h, f), "dense_4h_to_h": lin(f, h)},
        },
        "final_layer_norm": {
            "scale": torch.ones((h,), dtype=dtype, device=dev),
            "bias": zeros(h)},
        "embed_out": {"kernel": normal_init(g, (h, config.vocab_size), 0.02,
                                            dtype)},
    }


def _partial_rope(x, cos, sin, positions, rotary_ndims: int):
    """Rotate only the first `rotary_ndims` of each head's dims."""
    return torch.cat([apply_rope(x[..., :rotary_ndims], cos, sin, positions),
                      x[..., rotary_ndims:]], dim=-1)


def _layer_body(config: GPTNeoXConfig, x, layer, cos, sin, positions, mask,
                kv_cache=None, fp8=None):
    b, s, h = x.shape
    nh, hd = config.num_attention_heads, config.head_dim
    eps = config.layer_norm_eps
    fa = fp8["attn"] if fp8 is not None else {}
    fm = fp8["mlp"] if fp8 is not None else {}
    attn, mlp = layer["attn"], layer["mlp"]
    post = layer["post_attention_layernorm"]

    attn_in = layer_norm(x, layer["input_layernorm"]["scale"],
                         layer["input_layernorm"]["bias"], eps)
    qkv, m_qkv = dense_maybe_fp8(attn_in, attn["query_key_value"]["kernel"],
                                 fa.get("query_key_value"),
                                 attn["query_key_value"]["bias"])
    qkv = qkv.reshape(b, s, nh, 3, hd)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    q = _partial_rope(q, cos, sin, positions, config.rotary_ndims)
    k = _partial_rope(k, cos, sin, positions, config.rotary_ndims)
    new_cache = None
    if kv_cache is not None:
        # the shared cache-attend step: dense stacked caches, or the
        # serving pool through the paged decode kernel
        out, new_cache = decode_attention(q, k, v, kv_cache, positions,
                                          mask=mask)
    else:
        out = dot_product_attention(q, k, v, mask=mask, causal=True)
    attn_out, m_ad = dense_maybe_fp8(out.reshape(b, s, h),
                                     attn["dense"]["kernel"], fa.get("dense"),
                                     attn["dense"]["bias"])
    # the parallel residual's MLP reads x; the sequential one x + attn
    mlp_in = layer_norm(x if config.use_parallel_residual else x + attn_out,
                        post["scale"], post["bias"], eps)
    y, m_up = dense_maybe_fp8(mlp_in, mlp["dense_h_to_4h"]["kernel"],
                              fm.get("dense_h_to_4h"),
                              mlp["dense_h_to_4h"]["bias"])
    y = F.gelu(y.float()).to(x.dtype)
    mlp_out, m_dn = dense_maybe_fp8(y, mlp["dense_4h_to_h"]["kernel"],
                                    fm.get("dense_4h_to_h"),
                                    mlp["dense_4h_to_h"]["bias"])
    new_fp8 = ({"attn": {"query_key_value": m_qkv, "dense": m_ad},
                "mlp": {"dense_h_to_4h": m_up, "dense_4h_to_h": m_dn}}
               if fp8 is not None else None)
    # both residual modes add the same three terms
    return x + attn_out + mlp_out, new_cache, new_fp8


def _project_out(config: GPTNeoXConfig, params: dict, x):
    x = layer_norm(x, params["final_layer_norm"]["scale"],
                   params["final_layer_norm"]["bias"], config.layer_norm_eps)
    return logits_f32(x, params["embed_out"]["kernel"].to(x.dtype))


def forward(config: GPTNeoXConfig, params: dict, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, kv_caches=None,
            fp8_state=None):
    """Logits [B, S, V] (f32) through the untied embed_out head. With
    `kv_caches` (see `init_kv_caches`, or the serving pool), returns
    (logits, new_caches). With `fp8_state` (see `init_fp8_state`) the
    layer projections run fp8 and the result is (logits,
    new_fp8_state)."""
    if fp8_state is not None and kv_caches is not None:
        raise ValueError("fp8 is a training-path feature; decode "
                         "(kv_caches) runs bf16")
    x = params["embed_in"]["embedding"][input_ids.long()]
    if positions is None:
        positions = torch.arange(input_ids.shape[1],
                                 device=x.device).expand(input_ids.shape)
    cos, sin = rope_frequencies(
        config.rotary_ndims,
        rope_table_len(config.max_position_embeddings, kv_caches),
        config.rotary_emb_base, device=x.device)
    layers, n = params["layers"], config.num_hidden_layers
    if kv_caches is not None:
        x, new_caches = cached_layers(
            n, layers, x, kv_caches, lambda x, layer, cache: _layer_body(
                config, x, layer, cos, sin, positions, attention_mask,
                cache)[:2])
        return _project_out(config, params, x), new_caches
    x, new_fp8 = run_layers(
        lambda x, layer, f: _layer_body(config, x, layer, cos, sin,
                                        positions, attention_mask,
                                        fp8=f)[::2],
        x, layers, n, None if fp8_state is None else fp8_state["layers"])
    logits = _project_out(config, params, x)
    return logits if fp8_state is None else (logits, new_fp8)


def init_kv_caches(config: GPTNeoXConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    return make_kv_caches(config.num_hidden_layers, batch, max_len,
                          config.num_attention_heads, config.head_dim, dtype,
                          device=device)


generate = build_generate(forward, init_kv_caches)


def causal_lm_loss(config: GPTNeoXConfig, params: dict, batch: dict,
                   fp8_state=None):
    """Next-token loss; with `fp8_state` (mixed_precision="fp8") returns
    (loss, new_fp8_state)."""
    return causal_lm_loss_of(forward, config, params, batch, fp8_state)


def init_fp8_state(config: GPTNeoXConfig, history_len: int | None = None,
                   device=None) -> dict:
    """Per-layer delayed-scaling metas of the four layer projections on
    `device` (CUDA unless "cpu")."""
    return stacked_fp8_metas(config.num_hidden_layers, {
        "attn": ("query_key_value", "dense"),
        "mlp": ("dense_h_to_4h", "dense_4h_to_h"),
    }, history_len, device=device)


def make_decode_layer_step(config: GPTNeoXConfig):
    """The single-layer decode body `(layer, x, positions, kv_cache) ->
    (x, new_cache)` of `streamed_generate`. The rotary table covers the
    cache reach too: decoding past max_position_embeddings extends the
    angles."""

    def step(layer, x, positions, kv_cache):
        max_len = max(config.max_position_embeddings, kv_cache[0].shape[1])
        cos, sin = rope_frequencies(config.rotary_ndims, max_len,
                                    config.rotary_emb_base, device=x.device)
        y, cache, _ = _layer_body(config, x, layer, cos, sin, positions,
                                  None, kv_cache)
        return y, cache

    return step


# weights streamed to the device layer by layer (`big_modeling`);
# _project_out includes the final layer norm
streamed_generate = build_streamed_generate(
    make_decode_layer_step,
    embed_fn=lambda config, res, ids, pos: res["embed_in"]["embedding"][
        ids.long()],
    project_fn=_project_out,
    cache_dims=lambda c: (c.num_attention_heads, c.head_dim),
)
