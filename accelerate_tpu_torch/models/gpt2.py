"""GPT-2 causal LM (port of `accelerate_tpu/models/gpt2.py`).

The reference's layout and numerics: layers stack on a leading L dim,
pre-LN with biases, a fused qkv (`c_attn`), learned position embeddings,
a tanh-GELU MLP in f32, and an LM head tied to `wte`. HF stores these as
Conv1D, whose kernels are already [in, out] (no transpose on import).
Positions past the learned table read its last row, as the reference's
clamped gather does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.fp8 import stacked_fp8_metas
from . import tensor_parallel as tpm
from .common import (
    causal_lm_loss_of,
    dense_maybe_fp8,
    dot_product_attention,
    layer_norm,
    learned_positions,
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


# a tensor-parallel forward over params placed on a mesh's model axis
# (`models/tensor_parallel.py`)
TENSOR_PARALLEL = True


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768          # n_embd
    num_hidden_layers: int = 12     # n_layer
    num_attention_heads: int = 12   # n_head
    max_position_embeddings: int = 1024  # n_positions
    layer_norm_epsilon: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **overrides) -> "GPT2Config":
        defaults = dict(
            vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=128,
        )
        defaults.update(overrides)
        return cls(**defaults)


def init_params(config: GPT2Config, generator: torch.Generator | int = 0,
                dtype=torch.float32, device=None) -> dict:
    """The reference's tree: N(0, 0.02) kernels (wpe 0.01), zero biases,
    unit norm scales, drawn from `generator` (or a seed) on `device`
    (CUDA unless "cpu")."""
    dev, g = make_generator(generator, device)
    h, L = config.hidden_size, config.num_hidden_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def lin(d_in, d_out):
        return {"kernel": normal_init(g, (L, d_in, d_out), 0.02, dtype),
                "bias": zeros(L, d_out)}

    def ln():
        return {"scale": torch.ones((L, h), dtype=dtype, device=dev),
                "bias": zeros(L, h)}

    return {
        "wte": {"embedding": normal_init(g, (config.vocab_size, h), 0.02,
                                         dtype)},
        "wpe": {"embedding": normal_init(
            g, (config.max_position_embeddings, h), 0.01, dtype)},
        "layers": {
            "ln_1": ln(),
            "attn": {"c_attn": lin(h, 3 * h), "c_proj": lin(h, h)},
            "ln_2": ln(),
            "mlp": {"c_fc": lin(h, 4 * h), "c_proj": lin(4 * h, h)},
        },
        "ln_f": {"scale": torch.ones((h,), dtype=dtype, device=dev),
                 "bias": zeros(h)},
    }


def _layer_body_tp(config: GPT2Config, x, layer, mask, positions, kv_cache,
                   tp):
    """`_layer_body` over this rank's shards (`models/tensor_parallel.py`).
    The fused `c_attn` kernel [h, 3h] is column-sharded on its out dim,
    whose slices do not fall on the q/k/v boundaries (at 2 ranks rank 0
    holds all of q and half of k), so its output is gathered, split into
    q, k and v, and, when the heads divide the axis, cut to this rank's
    heads (the cache then holds those only)."""
    b, s, h = x.shape
    nh, hd = config.num_attention_heads, config.head_dim
    eps = config.layer_norm_epsilon
    attn, mlp = layer["attn"], layer["mlp"]
    heads_split = nh % tp.n == 0

    y = layer_norm(x, layer["ln_1"]["scale"], layer["ln_1"]["bias"], eps)
    qkv, local = tpm.project(tp, "layers/attn/c_attn/kernel", y,
                             attn["c_attn"]["kernel"], attn["c_attn"]["bias"],
                             "layers/attn/c_attn/bias")
    qkv = tp.to_full(qkv, local)
    q, k, v = (tp.local(t) if heads_split else t
               for t in qkv.chunk(3, dim=-1))
    q, k, v = (t.reshape(b, s, -1, hd) for t in (q, k, v))
    new_cache = None
    if kv_cache is not None:
        out, new_cache = decode_attention(q, k, v, kv_cache, positions,
                                          mask=mask)
    else:
        out = dot_product_attention(q, k, v, mask=mask, causal=True)
    a_out, _ = tpm.project(tp, "layers/attn/c_proj/kernel",
                           out.reshape(b, s, -1), attn["c_proj"]["kernel"],
                           attn["c_proj"]["bias"], "layers/attn/c_proj/bias",
                           x_local=heads_split)
    x = x + a_out

    y = layer_norm(x, layer["ln_2"]["scale"], layer["ln_2"]["bias"], eps)
    y, local = tpm.project(tp, "layers/mlp/c_fc/kernel", y,
                           mlp["c_fc"]["kernel"], mlp["c_fc"]["bias"],
                           "layers/mlp/c_fc/bias")
    y = F.gelu(y.float(), approximate="tanh").to(x.dtype)
    m_out, _ = tpm.project(tp, "layers/mlp/c_proj/kernel", y,
                           mlp["c_proj"]["kernel"], mlp["c_proj"]["bias"],
                           "layers/mlp/c_proj/bias", x_local=local)
    return x + m_out, new_cache, None


def _layer_body(config: GPT2Config, x, layer, mask, positions=None,
                kv_cache=None, fp8=None, tp=None):
    if tp is not None:
        return _layer_body_tp(config, x, layer, mask, positions, kv_cache,
                              tp)
    b, s, h = x.shape
    nh, hd = config.num_attention_heads, config.head_dim
    eps = config.layer_norm_epsilon
    fa = fp8["attn"] if fp8 is not None else {}
    fm = fp8["mlp"] if fp8 is not None else {}
    attn, mlp = layer["attn"], layer["mlp"]

    y = layer_norm(x, layer["ln_1"]["scale"], layer["ln_1"]["bias"], eps)
    qkv, m_qkv = dense_maybe_fp8(y, attn["c_attn"]["kernel"],
                                 fa.get("c_attn"), attn["c_attn"]["bias"])
    q, k, v = (t.reshape(b, s, nh, hd) for t in qkv.chunk(3, dim=-1))
    new_cache = None
    if kv_cache is not None:
        # the shared cache-attend step: dense stacked caches, or the
        # serving pool through the paged decode kernel
        out, new_cache = decode_attention(q, k, v, kv_cache, positions,
                                          mask=mask)
    else:
        out = dot_product_attention(q, k, v, mask=mask, causal=True)
    a_out, m_ap = dense_maybe_fp8(out.reshape(b, s, h),
                                  attn["c_proj"]["kernel"], fa.get("c_proj"),
                                  attn["c_proj"]["bias"])
    x = x + a_out

    y = layer_norm(x, layer["ln_2"]["scale"], layer["ln_2"]["bias"], eps)
    y, m_fc = dense_maybe_fp8(y, mlp["c_fc"]["kernel"], fm.get("c_fc"),
                              mlp["c_fc"]["bias"])
    y = F.gelu(y.float(), approximate="tanh").to(x.dtype)
    m_out, m_mp = dense_maybe_fp8(y, mlp["c_proj"]["kernel"],
                                  fm.get("c_proj"), mlp["c_proj"]["bias"])
    new_fp8 = ({"attn": {"c_attn": m_qkv, "c_proj": m_ap},
                "mlp": {"c_fc": m_fc, "c_proj": m_mp}}
               if fp8 is not None else None)
    return x + m_out, new_cache, new_fp8


def _embed(params: dict, input_ids, positions):
    tp = tpm.tensor_parallel_of(params)
    return (tpm.embed(tp, "wte/embedding", params["wte"]["embedding"],
                      input_ids)
            + learned_positions(params["wpe"]["embedding"], positions))


def _project_decode(config: GPT2Config, res: dict, x):
    """The final ln_f and the tied-wte head: f32 logits (gathered from a
    vocab-sharded wte)."""
    x = layer_norm(x, res["ln_f"]["scale"], res["ln_f"]["bias"],
                   config.layer_norm_epsilon)
    return tpm.head_logits(tpm.tensor_parallel_of(res), "wte/embedding", x,
                           res["wte"]["embedding"].to(x.dtype).t(), -2)


def forward(config: GPT2Config, params: dict, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, kv_caches=None,
            fp8_state=None):
    """Logits [B, S, V] (f32); the LM head is tied to wte. With
    `kv_caches` (see `init_kv_caches`, or the serving pool), returns
    (logits, new_caches). With `fp8_state` (see `init_fp8_state`) the
    layer projections run fp8 and the result is (logits,
    new_fp8_state)."""
    if fp8_state is not None and kv_caches is not None:
        raise ValueError("fp8 is a training-path feature; decode "
                         "(kv_caches) runs bf16")
    if positions is None:
        positions = torch.arange(input_ids.shape[1],
                                 device=input_ids.device).expand(
                                     input_ids.shape)
    tp = tpm.tensor_parallel_of(params)
    if tp is not None and fp8_state is not None:
        raise NotImplementedError(
            "fp8 over tensor-parallel params arrives with queue 1 item 6b "
            "(training half)")
    x = _embed(params, input_ids, positions)
    layers, n = params["layers"], config.num_hidden_layers
    if kv_caches is not None:
        x, new_caches = cached_layers(
            n, layers, x, kv_caches, lambda x, layer, cache: _layer_body(
                config, x, layer, attention_mask, positions, cache,
                tp=tp)[:2])
        return _project_decode(config, params, x), new_caches
    x, new_fp8 = run_layers(
        lambda x, layer, f: _layer_body(config, x, layer, attention_mask,
                                        positions, fp8=f, tp=tp)[::2],
        x, layers, n, None if fp8_state is None else fp8_state["layers"])
    logits = _project_decode(config, params, x)
    return logits if fp8_state is None else (logits, new_fp8)


def init_kv_caches(config: GPT2Config, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    return make_kv_caches(config.num_hidden_layers, batch, max_len,
                          config.num_attention_heads, config.head_dim, dtype,
                          device=device)


generate = build_generate(forward, init_kv_caches)


def causal_lm_loss(config: GPT2Config, params: dict, batch: dict,
                   fp8_state=None):
    """Next-token loss; with `fp8_state` (mixed_precision="fp8") returns
    (loss, new_fp8_state)."""
    return causal_lm_loss_of(forward, config, params, batch, fp8_state)


def init_fp8_state(config: GPT2Config, history_len: int | None = None,
                   device=None) -> dict:
    """Per-layer delayed-scaling metas of the four layer projections on
    `device` (CUDA unless "cpu")."""
    return stacked_fp8_metas(config.num_hidden_layers, {
        "attn": ("c_attn", "c_proj"),
        "mlp": ("c_fc", "c_proj"),
    }, history_len, device=device)


def make_decode_layer_step(config: GPT2Config):
    """The single-layer decode body `(layer, x, positions, kv_cache) ->
    (x, new_cache)` (the reference's streamed path runs it per layer)."""

    def step(layer, x, positions, kv_cache):
        y, cache, _ = _layer_body(config, x, layer, None, positions, kv_cache)
        return y, cache

    return step


# weights streamed to the device layer by layer (`big_modeling`)
streamed_generate = build_streamed_generate(
    make_decode_layer_step,
    embed_fn=lambda config, res, ids, pos: _embed(res, ids, pos),
    project_fn=_project_decode,
    cache_dims=lambda c: (c.num_attention_heads, c.head_dim),
)
