"""BERT-style encoder and sequence classifier (port of
`accelerate_tpu/models/bert.py`).

Bidirectional attention with a [B, S] key-padding mask, learned
positions and token types, post-LN layers (`layer_norm_eps` 1e-12), an
exact (erf) GELU MLP, then the tanh pooler over the first token and the
classifier. Layers stack on a leading L dim, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.fp8 import stacked_fp8_metas
from .common import (
    cross_entropy_loss,
    dense,
    dense_maybe_fp8,
    dot_product_attention,
    init_dense,
    layer_norm,
    make_generator,
    normal_init,
    rematted,
    run_layers,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    num_labels: int = 2
    layer_norm_eps: float = 1e-12
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def base(cls, **overrides) -> "BertConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "BertConfig":
        defaults = dict(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=128,
        )
        defaults.update(overrides)
        return cls(**defaults)


def init_params(config: BertConfig, generator: torch.Generator | int = 0,
                dtype=torch.float32, device=None) -> dict:
    """The reference's tree: N(0, 0.02) kernels, zero biases, unit norm
    scales, drawn from `generator` (or a seed) on `device` (CUDA unless
    "cpu")."""
    dev, g = make_generator(generator, device)
    h, L = config.hidden_size, config.num_hidden_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def stack(d_in, d_out):
        return {"kernel": normal_init(g, (L, d_in, d_out), 0.02, dtype),
                "bias": zeros(L, d_out)}

    def ln(*lead):
        return {"scale": torch.ones((*lead, h), dtype=dtype, device=dev),
                "bias": zeros(*lead, h)}

    return {
        "embed_tokens": {"embedding": normal_init(
            g, (config.vocab_size, h), 0.02, dtype)},
        "position_embeddings": {"embedding": normal_init(
            g, (config.max_position_embeddings, h), 0.02, dtype)},
        "token_type_embeddings": {"embedding": normal_init(
            g, (config.type_vocab_size, h), 0.02, dtype)},
        "embeddings_layernorm": ln(),
        "layers": {
            "attn": {name: stack(h, h)
                     for name in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "attention_layernorm": ln(L),
            "mlp": {"up_proj": stack(h, config.intermediate_size),
                    "down_proj": stack(config.intermediate_size, h)},
            "output_layernorm": ln(L),
        },
        "pooler": init_dense(g, h, h, 0.02, bias=True, dtype=dtype),
        "classifier": init_dense(g, h, config.num_labels, 0.02, bias=True,
                                 dtype=dtype),
    }


def _layer_body(config: BertConfig, x, layer, mask, fp8=None):
    b, s, h = x.shape
    nh, hd = config.num_attention_heads, config.head_dim
    eps = config.layer_norm_eps
    a, m = layer["attn"], layer["mlp"]
    fa = fp8["attn"] if fp8 is not None else {}
    fm = fp8["mlp"] if fp8 is not None else {}
    q, m_q = dense_maybe_fp8(x, a["q_proj"]["kernel"], fa.get("q_proj"),
                             a["q_proj"]["bias"])
    k, m_k = dense_maybe_fp8(x, a["k_proj"]["kernel"], fa.get("k_proj"),
                             a["k_proj"]["bias"])
    v, m_v = dense_maybe_fp8(x, a["v_proj"]["kernel"], fa.get("v_proj"),
                             a["v_proj"]["bias"])
    q, k, v = (t.reshape(b, s, nh, hd) for t in (q, k, v))
    attn = dot_product_attention(q, k, v, mask=mask).reshape(b, s, h)
    attn, m_o = dense_maybe_fp8(attn, a["o_proj"]["kernel"],
                                fa.get("o_proj"), a["o_proj"]["bias"])
    x = layer_norm(x + attn, layer["attention_layernorm"]["scale"],
                   layer["attention_layernorm"]["bias"], eps)
    # the exact (erf) GELU BERT checkpoints were trained with
    hmid, m_up = dense_maybe_fp8(x, m["up_proj"]["kernel"],
                                 fm.get("up_proj"), m["up_proj"]["bias"])
    out, m_dn = dense_maybe_fp8(F.gelu(hmid), m["down_proj"]["kernel"],
                                fm.get("down_proj"), m["down_proj"]["bias"])
    new_fp8 = ({"attn": {"q_proj": m_q, "k_proj": m_k, "v_proj": m_v,
                         "o_proj": m_o},
                "mlp": {"up_proj": m_up, "down_proj": m_dn}}
               if fp8 is not None else None)
    return layer_norm(x + out, layer["output_layernorm"]["scale"],
                      layer["output_layernorm"]["bias"], eps), new_fp8


def forward(config: BertConfig, params: dict, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            token_type_ids: torch.Tensor | None = None, fp8_state=None):
    """Pooled logits [B, num_labels]; with `fp8_state` (see
    `init_fp8_state`) the layer projections run fp8 and the result is
    (logits, new_fp8_state)."""
    s = input_ids.shape[1]
    ids = input_ids.long()
    x = params["embed_tokens"]["embedding"][ids]
    x = x + params["position_embeddings"]["embedding"][:s][None]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(ids)
    x = x + params["token_type_embeddings"]["embedding"][
        token_type_ids.long()]
    x = layer_norm(x, params["embeddings_layernorm"]["scale"],
                   params["embeddings_layernorm"]["bias"],
                   config.layer_norm_eps)
    mask = attention_mask.bool() if attention_mask is not None else None
    body = rematted(lambda x, layer, f: _layer_body(config, x, layer, mask,
                                                    fp8=f), config.remat)
    x, new_fp8 = run_layers(
        body, x, params["layers"], config.num_hidden_layers,
        None if fp8_state is None else fp8_state["layers"])
    pooled = torch.tanh(dense(x[:, 0], params["pooler"]["kernel"],
                              params["pooler"]["bias"]))
    logits = dense(pooled, params["classifier"]["kernel"],
                   params["classifier"]["bias"])
    return logits if fp8_state is None else (logits, new_fp8)


def init_fp8_state(config: BertConfig, history_len: int | None = None,
                   device=None) -> dict:
    """Per-layer delayed-scaling metas of the six layer projections on
    `device` (CUDA unless "cpu"); the pooler and classifier stay in full
    precision."""
    return stacked_fp8_metas(config.num_hidden_layers, {
        "attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
        "mlp": ("up_proj", "down_proj"),
    }, history_len, device=device)


def classification_loss(config: BertConfig, params: dict, batch: dict,
                        fp8_state=None):
    """Cross-entropy over the pooled logits; with `fp8_state`
    (mixed_precision="fp8") returns (loss, new_fp8_state)."""
    out = forward(config, params, batch["input_ids"],
                  attention_mask=batch.get("attention_mask"),
                  token_type_ids=batch.get("token_type_ids"),
                  fp8_state=fp8_state)
    if fp8_state is not None:
        logits, new_fp8 = out
        return cross_entropy_loss(logits, batch["labels"]), new_fp8
    return cross_entropy_loss(out, batch["labels"])
