"""OPT causal LM (port of `accelerate_tpu/models/opt.py`).

OPT specifics, as the reference has them: learned position embeddings
with fairseq's +2 offset (every OPT checkpoint bakes it in), positions
from the mask's cumsum when a no-cache batch is left-padded, pre-LN
decoder layers (post-LN configs are refused at import, as the reference
refuses them), a ReLU MLP, biases everywhere and an LM head tied to the
token embedding.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.fp8 import stacked_fp8_metas
from .common import (
    causal_lm_loss_of,
    dense_maybe_fp8,
    dot_product_attention,
    layer_norm,
    learned_positions,
    logits_f32,
    make_generator,
    normal_init,
    run_layers,
)
from .decode import (
    build_generate,
    build_streamed_generate,
    cached_layers,
    decode_attention,
    make_kv_caches,
)


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 7168
    ffn_dim: int = 28672
    num_hidden_layers: int = 48
    num_attention_heads: int = 56
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **overrides) -> "OPTConfig":
        defaults = dict(
            vocab_size=256, hidden_size=64, ffn_dim=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=128,
        )
        defaults.update(overrides)
        return cls(**defaults)


_POSITION_OFFSET = 2  # fairseq convention baked into every OPT checkpoint


def init_params(config: OPTConfig, generator: torch.Generator | int = 0,
                dtype=torch.float32, device=None) -> dict:
    """The reference's tree: N(0, 0.02) kernels, zero biases, unit norm
    scales, drawn from `generator` (or a seed) on `device` (CUDA unless
    "cpu")."""
    dev, g = make_generator(generator, device)
    h, L, f = config.hidden_size, config.num_hidden_layers, config.ffn_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def lin(d_in, d_out):
        return {"kernel": normal_init(g, (L, d_in, d_out), 0.02, dtype),
                "bias": zeros(L, d_out)}

    def ln():
        return {"scale": torch.ones((L, h), dtype=dtype, device=dev),
                "bias": zeros(L, h)}

    return {
        "embed_tokens": {"embedding": normal_init(
            g, (config.vocab_size, h), 0.02, dtype)},
        "embed_positions": {"embedding": normal_init(
            g, (config.max_position_embeddings + _POSITION_OFFSET, h), 0.02,
            dtype)},
        "layers": {
            "self_attn_layer_norm": ln(),
            "attn": {name: lin(h, h)
                     for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "final_layer_norm": ln(),
            "mlp": {"fc1": lin(h, f), "fc2": lin(f, h)},
        },
        "final_layer_norm": {
            "scale": torch.ones((h,), dtype=dtype, device=dev),
            "bias": zeros(h)},
    }


def _layer_body(config: OPTConfig, x, layer, mask, positions=None,
                kv_cache=None, fp8=None):
    b, s, h = x.shape
    nh, hd = config.num_attention_heads, config.head_dim
    eps = config.layer_norm_eps
    fa = fp8["attn"] if fp8 is not None else {}
    fm = fp8["mlp"] if fp8 is not None else {}
    a, mlp = layer["attn"], layer["mlp"]

    y = layer_norm(x, layer["self_attn_layer_norm"]["scale"],
                   layer["self_attn_layer_norm"]["bias"], eps)
    q, m_q = dense_maybe_fp8(y, a["q_proj"]["kernel"], fa.get("q_proj"),
                             a["q_proj"]["bias"])
    k, m_k = dense_maybe_fp8(y, a["k_proj"]["kernel"], fa.get("k_proj"),
                             a["k_proj"]["bias"])
    v, m_v = dense_maybe_fp8(y, a["v_proj"]["kernel"], fa.get("v_proj"),
                             a["v_proj"]["bias"])
    q, k, v = (t.reshape(b, s, nh, hd) for t in (q, k, v))
    new_cache = None
    if kv_cache is not None:
        # the shared cache-attend step: dense stacked caches, or the
        # serving pool through the paged decode kernel
        out, new_cache = decode_attention(q, k, v, kv_cache, positions,
                                          mask=mask)
    else:
        out = dot_product_attention(q, k, v, mask=mask, causal=True)
    o, m_o = dense_maybe_fp8(out.reshape(b, s, h), a["out_proj"]["kernel"],
                             fa.get("out_proj"), a["out_proj"]["bias"])
    x = x + o

    y = layer_norm(x, layer["final_layer_norm"]["scale"],
                   layer["final_layer_norm"]["bias"], eps)
    y, m_f1 = dense_maybe_fp8(y, mlp["fc1"]["kernel"], fm.get("fc1"),
                              mlp["fc1"]["bias"])
    y, m_f2 = dense_maybe_fp8(torch.relu(y), mlp["fc2"]["kernel"],
                              fm.get("fc2"), mlp["fc2"]["bias"])
    new_fp8 = ({"attn": {"q_proj": m_q, "k_proj": m_k, "v_proj": m_v,
                         "out_proj": m_o},
                "mlp": {"fc1": m_f1, "fc2": m_f2}}
               if fp8 is not None else None)
    return x + y, new_cache, new_fp8


def _project_out(config: OPTConfig, params: dict, x):
    x = layer_norm(x, params["final_layer_norm"]["scale"],
                   params["final_layer_norm"]["bias"], config.layer_norm_eps)
    return logits_f32(x, params["embed_tokens"]["embedding"].to(x.dtype).t())


def _positions(input_ids, attention_mask, kv_caches):
    """Logical 0-based positions when the caller gives none: from the
    mask's cumsum on a no-cache forward (left pads sit at -1, which lands
    on fairseq's padding row 1 after the +2 offset), else 0..S-1."""
    if attention_mask is not None and kv_caches is None:
        m = attention_mask.long()
        return torch.cumsum(m, dim=1) * m - 1
    if attention_mask is not None:
        # a masked CACHED prefill cannot infer positions: the mask spans
        # the whole cache, not the prompt
        raise ValueError(
            "opt.forward with kv_caches and attention_mask needs "
            "explicit `positions`: derive them from the prompt's real "
            "tokens (left pads would otherwise get shifted embeddings)")
    return torch.arange(input_ids.shape[1],
                        device=input_ids.device).expand(input_ids.shape)


def forward(config: OPTConfig, params: dict, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, kv_caches=None,
            fp8_state=None):
    """Logits [B, S, V] (f32; the head is tied to embed_tokens). With
    `kv_caches` (see `init_kv_caches`, or the serving pool), returns
    (logits, new_caches). `positions` are logical 0-based positions: the
    +2 offset applies at the lookup. With `fp8_state` (see
    `init_fp8_state`) the layer projections run fp8 and the result is
    (logits, new_fp8_state)."""
    if fp8_state is not None and kv_caches is not None:
        raise ValueError("fp8 is a training-path feature; decode "
                         "(kv_caches) runs bf16")
    if positions is None:
        positions = _positions(input_ids, attention_mask, kv_caches)
    x = (params["embed_tokens"]["embedding"][input_ids.long()]
         + learned_positions(params["embed_positions"]["embedding"],
                             positions + _POSITION_OFFSET))
    layers, n = params["layers"], config.num_hidden_layers
    if kv_caches is not None:
        x, new_caches = cached_layers(
            n, layers, x, kv_caches, lambda x, layer, cache: _layer_body(
                config, x, layer, attention_mask, positions, cache)[:2])
        return _project_out(config, params, x), new_caches
    x, new_fp8 = run_layers(
        lambda x, layer, f: _layer_body(config, x, layer, attention_mask,
                                        fp8=f)[::2],
        x, layers, n, None if fp8_state is None else fp8_state["layers"])
    logits = _project_out(config, params, x)
    return logits if fp8_state is None else (logits, new_fp8)


def init_kv_caches(config: OPTConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    return make_kv_caches(config.num_hidden_layers, batch, max_len,
                          config.num_attention_heads, config.head_dim, dtype,
                          device=device)


generate = build_generate(forward, init_kv_caches)


def causal_lm_loss(config: OPTConfig, params: dict, batch: dict,
                   fp8_state=None):
    """Next-token loss; with `fp8_state` (mixed_precision="fp8") returns
    (loss, new_fp8_state)."""
    return causal_lm_loss_of(forward, config, params, batch, fp8_state)


def init_fp8_state(config: OPTConfig, history_len: int | None = None,
                   device=None) -> dict:
    """Per-layer delayed-scaling metas of the six layer projections on
    `device` (CUDA unless "cpu")."""
    return stacked_fp8_metas(config.num_hidden_layers, {
        "attn": ("q_proj", "k_proj", "v_proj", "out_proj"),
        "mlp": ("fc1", "fc2"),
    }, history_len, device=device)


def make_decode_layer_step(config: OPTConfig):
    """The single-layer decode body `(layer, x, positions, kv_cache) ->
    (x, new_cache)` of `streamed_generate`."""

    def step(layer, x, positions, kv_cache):
        y, cache, _ = _layer_body(config, x, layer, None, positions, kv_cache)
        return y, cache

    return step


def _embed_decode(config: OPTConfig, res: dict, ids, pos):
    return (res["embed_tokens"]["embedding"][ids.long()]
            + learned_positions(res["embed_positions"]["embedding"],
                                pos + _POSITION_OFFSET))


# weights streamed to the device layer by layer (`big_modeling`);
# _project_out includes the final layer norm
streamed_generate = build_streamed_generate(
    make_decode_layer_step,
    embed_fn=_embed_decode,
    project_fn=_project_out,
    cache_dims=lambda c: (c.num_attention_heads, c.head_dim),
)
