"""GPT-J causal LM (port of `accelerate_tpu/models/gptj.py`).

GPT-J specifics, as the reference has them: ONE LayerNorm per layer
feeding attention and the MLP in parallel (x + attn + mlp), rotary
embeddings on the first `rotary_dim` dims of each head in the
interleaved "rotate every two" convention (pairs 0&1, 2&3, ...), no
attention biases, a tanh-GELU MLP in f32, and an untied LM head WITH a
bias, whose logits are f32. GPT-J-6B's head dim is 256 with no GQA
(one query head per KV head): served, it runs the paged decode kernel
at D=256, G=1.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.fp8 import stacked_fp8_metas
from .common import (
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
class GPTJConfig:
    """Defaults are GPT-J-6B as published."""
    vocab_size: int = 50400
    hidden_size: int = 4096          # n_embd
    num_hidden_layers: int = 28      # n_layer
    num_attention_heads: int = 16    # n_head
    max_position_embeddings: int = 2048  # n_positions
    rotary_dim: int = 64
    layer_norm_epsilon: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **overrides) -> "GPTJConfig":
        defaults = dict(
            vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=128, rotary_dim=8,
        )
        defaults.update(overrides)
        return cls(**defaults)


def init_params(config: GPTJConfig, generator: torch.Generator | int = 0,
                dtype=torch.float32, device=None) -> dict:
    """The reference's tree: N(0, 0.02) kernels, zero biases, unit norm
    scales, drawn from `generator` (or a seed) on `device` (CUDA unless
    "cpu")."""
    dev, g = make_generator(generator, device)
    h, L = config.hidden_size, config.num_hidden_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def lin(d_in, d_out, bias=True):
        out = {"kernel": normal_init(g, (L, d_in, d_out), 0.02, dtype)}
        if bias:
            out["bias"] = zeros(L, d_out)
        return out

    return {
        "wte": {"embedding": normal_init(g, (config.vocab_size, h), 0.02,
                                         dtype)},
        "layers": {
            "ln_1": {"scale": torch.ones((L, h), dtype=dtype, device=dev),
                     "bias": zeros(L, h)},
            "attn": {name: lin(h, h, bias=False)
                     for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "mlp": {"fc_in": lin(h, 4 * h), "fc_out": lin(4 * h, h)},
        },
        "ln_f": {"scale": torch.ones((h,), dtype=dtype, device=dev),
                 "bias": zeros(h)},
        "lm_head": {"kernel": normal_init(g, (h, config.vocab_size), 0.02,
                                          dtype),
                    "bias": zeros(config.vocab_size)},
    }


def _rotate_every_two(x):
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    return torch.stack((-x[..., 1::2], x[..., ::2]), dim=-1).reshape(x.shape)


def _apply_interleaved_rope(x, sin, cos, positions):
    """GPT-J rotary on x [B, S, H, rot]: the pairs are interleaved and the
    [T, rot/2] tables repeat per pair. The rotation runs in f32; the
    result keeps x's dtype."""
    positions = positions.long()
    sin_p = sin[positions].repeat_interleave(2, dim=-1)[:, :, None, :]
    cos_p = cos[positions].repeat_interleave(2, dim=-1)[:, :, None, :]
    xf = x.float()
    return (xf * cos_p + _rotate_every_two(xf) * sin_p).to(x.dtype)


def _rotary(x, sin, cos, positions, rot: int):
    return torch.cat([_apply_interleaved_rope(x[..., :rot], sin, cos,
                                              positions), x[..., rot:]],
                     dim=-1)


def _layer_body(config: GPTJConfig, x, layer, sin, cos, positions, mask,
                kv_cache=None, fp8=None):
    b, s, h = x.shape
    nh, hd, rot = config.num_attention_heads, config.head_dim, \
        config.rotary_dim
    fa = fp8["attn"] if fp8 is not None else {}
    fm = fp8["mlp"] if fp8 is not None else {}
    attn, mlp = layer["attn"], layer["mlp"]

    y = layer_norm(x, layer["ln_1"]["scale"], layer["ln_1"]["bias"],
                   config.layer_norm_epsilon)
    q, m_q = dense_maybe_fp8(y, attn["q_proj"]["kernel"], fa.get("q_proj"))
    k, m_k = dense_maybe_fp8(y, attn["k_proj"]["kernel"], fa.get("k_proj"))
    v, m_v = dense_maybe_fp8(y, attn["v_proj"]["kernel"], fa.get("v_proj"))
    q, k, v = (t.reshape(b, s, nh, hd) for t in (q, k, v))
    q = _rotary(q, sin, cos, positions, rot)
    k = _rotary(k, sin, cos, positions, rot)
    new_cache = None
    if kv_cache is not None:
        # the shared cache-attend step: dense stacked caches, or the
        # serving pool through the paged decode kernel
        out, new_cache = decode_attention(q, k, v, kv_cache, positions,
                                          mask=mask)
    else:
        out = dot_product_attention(q, k, v, mask=mask, causal=True)
    attn_out, m_o = dense_maybe_fp8(out.reshape(b, s, h),
                                    attn["out_proj"]["kernel"],
                                    fa.get("out_proj"))

    # the parallel residual: the MLP reads the SAME ln_1 output
    m, m_fi = dense_maybe_fp8(y, mlp["fc_in"]["kernel"], fm.get("fc_in"),
                              mlp["fc_in"]["bias"])
    m = F.gelu(m.float(), approximate="tanh").to(x.dtype)
    mlp_out, m_fo = dense_maybe_fp8(m, mlp["fc_out"]["kernel"],
                                    fm.get("fc_out"), mlp["fc_out"]["bias"])
    new_fp8 = ({"attn": {"q_proj": m_q, "k_proj": m_k, "v_proj": m_v,
                         "out_proj": m_o},
                "mlp": {"fc_in": m_fi, "fc_out": m_fo}}
               if fp8 is not None else None)
    return x + attn_out + mlp_out, new_cache, new_fp8


def _project_out(config: GPTJConfig, params: dict, x):
    """ln_f, then the head and its bias: f32 logits."""
    x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"],
                   config.layer_norm_epsilon)
    return (logits_f32(x, params["lm_head"]["kernel"].to(x.dtype))
            + params["lm_head"]["bias"].float())


def _tables(config: GPTJConfig, max_len: int, device):
    """The interleaved rotary's (sin, cos) [max_len, rotary_dim / 2] f32,
    cached for the process (a captured graph reads them by address)."""
    cos, sin = rope_frequencies(config.rotary_dim, max_len, 10000.0,
                                device=device)
    return sin, cos


def forward(config: GPTJConfig, params: dict, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, kv_caches=None,
            fp8_state=None):
    """Logits [B, S, V] (f32). With `kv_caches` (see `init_kv_caches`, or
    the serving pool), returns (logits, new_caches). With `fp8_state`
    (see `init_fp8_state`) the layer projections run fp8 and the result
    is (logits, new_fp8_state)."""
    if fp8_state is not None and kv_caches is not None:
        raise ValueError("fp8 is a training-path feature; decode "
                         "(kv_caches) runs bf16")
    x = params["wte"]["embedding"][input_ids.long()]
    if positions is None:
        positions = torch.arange(input_ids.shape[1],
                                 device=x.device).expand(input_ids.shape)
    sin, cos = _tables(config, rope_table_len(config.max_position_embeddings,
                                              kv_caches), x.device)
    layers, n = params["layers"], config.num_hidden_layers
    if kv_caches is not None:
        x, new_caches = cached_layers(
            n, layers, x, kv_caches, lambda x, layer, cache: _layer_body(
                config, x, layer, sin, cos, positions, attention_mask,
                cache)[:2])
        return _project_out(config, params, x), new_caches
    x, new_fp8 = run_layers(
        lambda x, layer, f: _layer_body(config, x, layer, sin, cos,
                                        positions, attention_mask,
                                        fp8=f)[::2],
        x, layers, n, None if fp8_state is None else fp8_state["layers"])
    logits = _project_out(config, params, x)
    return logits if fp8_state is None else (logits, new_fp8)


def init_kv_caches(config: GPTJConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    return make_kv_caches(config.num_hidden_layers, batch, max_len,
                          config.num_attention_heads, config.head_dim, dtype,
                          device=device)


generate = build_generate(forward, init_kv_caches)


def causal_lm_loss(config: GPTJConfig, params: dict, batch: dict,
                   fp8_state=None):
    """Next-token loss; with `fp8_state` (mixed_precision="fp8") returns
    (loss, new_fp8_state)."""
    return causal_lm_loss_of(forward, config, params, batch, fp8_state)


def init_fp8_state(config: GPTJConfig, history_len: int | None = None,
                   device=None) -> dict:
    """Per-layer delayed-scaling metas of the six layer projections on
    `device` (CUDA unless "cpu")."""
    return stacked_fp8_metas(config.num_hidden_layers, {
        "attn": ("q_proj", "k_proj", "v_proj", "out_proj"),
        "mlp": ("fc_in", "fc_out"),
    }, history_len, device=device)


# weights streamed from the host (`big_modeling`): raises until that slice
streamed_generate = build_streamed_generate()
