"""Llama-family causal LM (port of `accelerate_tpu/models/llama.py`).

Params are a nested dict with the reference tree's keys and its stacked
`[L, ...]` layer shapes (`models/convert.py` moves a JAX tree across
unchanged). The forward loops over layers, indexing views of the stacked
tensors. Ported: the cached decode/prefill forward and `generate`
(serving), and the training half: the no-cache forward on the einsum or
flash attention path (`ops/flash_attention.py`, CUDA kernels on the card),
per-layer remat, and `causal_lm_loss` with its chunked path; and fp8
training (`fp8_state`, `init_fp8_state`): every layer projection through
`ops.fp8.fp8_dense` with per-layer metas, views of the stacked `[L]` and
`[L, h]` tensors, and the new metas stacked back on the layer dim. And
big-model inference: `forward_offloaded` and `streamed_generate` over
params laid out by `big_modeling` across device, host and disk. The
sequence-parallel backends ("ring", "ulysses", `sequence_parallel`) come
with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..ops.fp8 import stacked_fp8_metas
from .common import (  # noqa: F401  (_HeadF32, _split_bf16: tests)
    _HeadF32,
    _split_bf16,
    apply_rope,
    cross_entropy_loss,
    dense_maybe_fp8,
    dot_product_attention,
    logits_f32,
    make_generator,
    normal_init,
    rematted,
    repeat_kv,
    rms_norm,
    rope_frequencies,
    run_layers,
    shifted_padding_masks,
    token_nll,
)
from ..device import resolve_device
from .decode import build_generate, build_streamed_generate, \
    cached_layers, decode_attention, make_kv_caches, rope_table_len


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
            "sharded-parallelism slice (ROADMAP.md, queue 1 item 6b)")
    raise ValueError(f"unknown attention_backend {backend!r}")


def init_params(config: LlamaConfig, generator: torch.Generator | int = 0,
                dtype=torch.float32, device=None) -> dict:
    """Stacked-layer params, N(0, 0.02) kernels and unit norm scales,
    drawn from `generator` (or a seed) on `device` (CUDA unless "cpu")."""
    dev, g = make_generator(generator, device)
    h, kv = config.hidden_size, config.num_key_value_heads * config.head_dim
    L = config.num_hidden_layers

    def normal(*shape):
        return normal_init(g, shape, 0.02, dtype)

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


def _attention(config: LlamaConfig, layer: dict, x, cos, sin, positions,
               mask, kv_cache=None, fp8=None):
    b, s, _ = x.shape
    nh, nkv, hd = (config.num_attention_heads, config.num_key_value_heads,
                   config.head_dim)
    attn = layer["attn"]
    fa = fp8["attn"] if fp8 is not None else {}
    q, mq = dense_maybe_fp8(x, attn["q_proj"]["kernel"], fa.get("q_proj"))
    k, mk = dense_maybe_fp8(x, attn["k_proj"]["kernel"], fa.get("k_proj"))
    v, mv = dense_maybe_fp8(x, attn["v_proj"]["kernel"], fa.get("v_proj"))
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
    o, mo = dense_maybe_fp8(out.reshape(b, s, nh * hd),
                            attn["o_proj"]["kernel"], fa.get("o_proj"))
    if "bias" in attn["o_proj"]:
        o = o + attn["o_proj"]["bias"].to(o.dtype)
    new_fp8 = ({"q_proj": mq, "k_proj": mk, "v_proj": mv, "o_proj": mo}
               if fp8 is not None else None)
    return o, new_cache, new_fp8


def _mlp(layer: dict, x, fp8=None):
    mlp = layer["mlp"]
    fm = fp8["mlp"] if fp8 is not None else {}
    gate, mg = dense_maybe_fp8(x, mlp["gate_proj"]["kernel"],
                               fm.get("gate_proj"))
    up, mu = dense_maybe_fp8(x, mlp["up_proj"]["kernel"], fm.get("up_proj"))
    down, md = dense_maybe_fp8(F.silu(gate) * up, mlp["down_proj"]["kernel"],
                               fm.get("down_proj"))
    new_fp8 = ({"gate_proj": mg, "up_proj": mu, "down_proj": md}
               if fp8 is not None else None)
    return down, new_fp8


def _layer_body(config: LlamaConfig, x, layer, cos, sin, positions, mask,
                kv_cache=None, fp8=None):
    """One layer: (x, new_cache, new_fp8); the new metas are None without
    `fp8`, this layer's meta tree."""
    attn_out, new_cache, fp8_attn = _attention(
        config, layer,
        rms_norm(x, layer["input_layernorm"]["scale"], config.rms_norm_eps),
        cos, sin, positions, mask, kv_cache, fp8,
    )
    x = x + attn_out
    mlp_out, fp8_mlp = _mlp(
        layer, rms_norm(x, layer["post_attention_layernorm"]["scale"],
                        config.rms_norm_eps), fp8)
    new_fp8 = ({"attn": fp8_attn, "mlp": fp8_mlp} if fp8 is not None
               else None)
    return x + mlp_out, new_cache, new_fp8


def forward(
    config: LlamaConfig,
    params: dict,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    kv_caches: Any = None,
    return_hidden: bool = False,
    fp8_state: Any = None,
):
    """Logits [B, S, V] (f32); with kv_caches, (logits, new_caches); with
    `return_hidden`, the final normed hidden states instead of logits.
    With `fp8_state` (see `init_fp8_state`) the layer projections run in
    fp8 and the result is (out, new_fp8_state).

    kv_caches is (k, v, cache_len) of stacked [L, B, M, Hkv, D] buffers
    (written in place; cache_len an int or an int tensor, 0-dim or [B]),
    or the serving pool's (PagedKV, PagedKV, PagedDecodeMeta), for which
    new_caches carries this step's K/V rows stacked as [L, B, 1, Hkv, D]."""
    if return_hidden and kv_caches is not None:
        raise ValueError("return_hidden is not supported on the decode "
                         "(kv_caches) path")
    if fp8_state is not None and kv_caches is not None:
        raise ValueError("fp8 is a training-path feature; decode "
                         "(kv_caches) runs bf16")
    if config.sequence_parallel:
        raise NotImplementedError(
            "sequence_parallel arrives with the port's sharded-parallelism "
            "slice (ROADMAP.md, queue 1 item 6b)")
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
        x, new_caches = cached_layers(
            config.num_hidden_layers, layers, x, kv_caches,
            lambda x, layer, cache: _layer_body(
                config, x, layer, cos, sin, positions, attention_mask,
                cache)[:2])
        x = rms_norm(x, params["norm"]["scale"], config.rms_norm_eps)
        return _project_out(config, params, x), new_caches

    # under `config.remat` the attention forward reruns in backward (with
    # the flash backend: K1a launches twice per layer and step), as under
    # the reference's policies
    body = rematted(
        lambda x, layer, f: _layer_body(config, x, layer, cos, sin,
                                        positions, attention_mask,
                                        fp8=f)[::2],
        config.remat, config.remat_policy)
    x, new_fp8_state = run_layers(
        body, x, layers, config.num_hidden_layers,
        None if fp8_state is None else fp8_state["layers"])
    x = rms_norm(x, params["norm"]["scale"], config.rms_norm_eps)
    out = x if return_hidden else _project_out(config, params, x)
    return out if fp8_state is None else (out, new_fp8_state)


def _project_out(config: LlamaConfig, params: dict, x):
    """f32 logits from the head's product in x's dtype
    (`common.logits_f32`)."""
    if config.tie_word_embeddings:
        w = params["embed_tokens"]["embedding"].to(x.dtype).t()
    else:
        w = params["lm_head"]["kernel"].to(x.dtype)
    return logits_f32(x, w)


def causal_lm_loss(config: LlamaConfig, params: dict, batch: dict,
                   loss_chunk_size: int | None = None,
                   fp8_state: Any = None) -> torch.Tensor:
    """Next-token loss over a batch {input_ids, attention_mask?}.

    The [B, S, V] f32 logits are the largest buffer of a step, so when S
    divides into chunks (auto-picked so a chunk's logits stay ~256 MB)
    the projection and cross-entropy run per chunk under a checkpoint,
    and the full logits never exist. The attention_mask is a key-padding
    mask for the forward AND weights the loss (`shifted_padding_masks`);
    positions stay 0..S-1, so batches should be right-padded.

    With `fp8_state` (mixed_precision="fp8") the layer projections run in
    fp8 and the result is (loss, new_fp8_state); the head stays bf16."""
    input_ids = batch["input_ids"]
    labels = input_ids[:, 1:]
    attn_mask, mask = shifted_padding_masks(batch.get("attention_mask"))
    B, S = labels.shape

    if loss_chunk_size is None:
        budget = 256 * 2**20 // 4  # f32 elements per chunk of logits
        loss_chunk_size = max(1, budget // max(1, B * config.vocab_size))
    chunk = _pick_chunk(S, loss_chunk_size)
    if chunk is None or chunk >= S:
        out = forward(config, params, input_ids[:, :-1],
                      attention_mask=attn_mask, fp8_state=fp8_state)
        if fp8_state is None:
            return cross_entropy_loss(out, labels, mask)
        return cross_entropy_loss(out[0], labels, mask), out[1]

    out = forward(config, params, input_ids[:, :-1],
                  attention_mask=attn_mask, return_hidden=True,
                  fp8_state=fp8_state)
    hidden, new_fp8 = out if fp8_state is not None else (out, None)
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
    loss = loss_sum / torch.clamp(count, min=1)
    return loss if fp8_state is None else (loss, new_fp8)


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


def init_fp8_state(config: LlamaConfig, history_len: int | None = None,
                   device=None) -> dict:
    """Per-layer delayed-scaling metas of every layer projection on
    `device` (CUDA unless "cpu"); the window follows the Accelerator's
    `FP8RecipeKwargs` unless `history_len` is given. Pass to
    `TrainState.create(fp8_state=...)` and train with
    `Accelerator(mixed_precision="fp8")`."""
    return stacked_fp8_metas(config.num_hidden_layers, {
        "attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
        "mlp": ("gate_proj", "up_proj", "down_proj"),
    }, history_len, device=device)


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


def forward_offloaded(config: LlamaConfig, dispatched_params: dict,
                      input_ids: torch.Tensor,
                      attention_mask: torch.Tensor | None = None,
                      dtype=torch.bfloat16, device=None, stats=None):
    """`forward`'s logits for params laid out by
    `big_modeling.dispatch_model` (or `load_checkpoint_and_dispatch`)
    over device, host and disk: each layer streams to the device while the
    one before computes (`big_modeling.streamed_forward`), in `dtype`.
    Attention resolves as in `forward`: "auto" is the flash kernel on the
    card from 1024 tokens up."""
    from ..big_modeling import streamed_forward

    dev = resolve_device(device)
    ids = input_ids.to(dev)
    positions = torch.arange(ids.shape[1], device=dev).expand(ids.shape)
    cos, sin = rope_frequencies(
        config.head_dim, config.max_position_embeddings, config.rope_theta,
        scaling=config.rope_scaling_dict, device=dev)
    mask = None if attention_mask is None else attention_mask.to(dev)
    return streamed_forward(
        dispatched_params, ids,
        embed_fn=lambda res, ids: res["embed_tokens"]["embedding"][
            ids.long()],
        layer_fn=lambda layer, x, i: _layer_body(
            config, x, layer, cos, sin, positions, mask)[0],
        final_fn=lambda res, x: _norm_project(config, res, x),
        device=dev, dtype=dtype, stats=stats)


def make_decode_layer_step(config: LlamaConfig):
    """The single-layer decode body `(layer, x, positions, kv_cache) ->
    (x, new_cache)` of `streamed_generate`; the rotary table is as long
    as `forward`'s on the same cache."""

    def step(layer, x, positions, kv_cache):
        cos, sin = rope_frequencies(
            config.head_dim,
            max(config.max_position_embeddings, kv_cache[0].shape[1]),
            config.rope_theta, scaling=config.rope_scaling_dict,
            device=x.device)
        y, cache, _ = _layer_body(config, x, layer, cos, sin, positions,
                                  None, kv_cache)
        return y, cache

    return step


def _norm_project(config: LlamaConfig, resident: dict, x):
    # the full forward norms before projecting; the streamed paths must
    # too, or real checkpoints (norm.scale != 1) decode wrong
    x = rms_norm(x, resident["norm"]["scale"], config.rms_norm_eps)
    return _project_out(config, resident, x)


# weights streamed to the device layer by layer (`big_modeling`)
streamed_generate = build_streamed_generate(
    make_decode_layer_step,
    embed_fn=lambda config, res, ids, pos: res["embed_tokens"]["embedding"][
        ids.long()],
    project_fn=_norm_project,
    cache_dims=lambda c: (c.num_key_value_heads, c.head_dim),
)
