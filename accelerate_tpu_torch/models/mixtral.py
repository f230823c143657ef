"""Mixtral-style MoE causal LM (port of `accelerate_tpu/models/mixtral.py`).

Attention is llama's (`llama._attention` through `_as_llama()`), so
`attention_backend="auto"` runs the flash kernels (K1a/b/c) on the card
from 1024 tokens. The MLP is a top-k routed mixture of SwiGLU experts
stacked on an E dim ([L, E, in, out] kernels), with the Switch-style
load-balancing loss. `moe_impl` picks the dispatch, as in the reference:

- "dense": every expert sees every token and a [B, S, E] combine weight
  zeroes what was not routed: exact, E/k times the needed MLP work;
- "sparse": capacity-bounded, C = min(ceil(k S / E * capacity_factor),
  S k) tokens an expert; short sequences gather with a GShard one-hot
  einsum, long ones with the stable sort of `parallel/moe.py` (the
  switch is the reference's element count, kept so both packages take
  the same path at every shape). Assignments over capacity drop and
  their tokens ride the residual.

`moe_impl="a2a"` (token-sharded expert parallelism) and
`sequence_parallel=True` need a sharded mesh and raise until the port's
sharded-parallelism slice (queue 1 item 6b).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops.fp8 import fp8_expert_dense, stacked_fp8_metas
from ..parallel.moe import sort_combine, sort_dispatch, \
    topk_lower_index_first
from .common import (
    cross_entropy_loss,
    logits_f32,
    make_generator,
    normal_init,
    rematted,
    rms_norm,
    rope_frequencies,
    shifted_padding_masks,
    stack_layers,
    unstack_layers,
)
from .llama import LlamaConfig, _attention


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    """Defaults are Mixtral-8x7B's widths and depth."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    max_position_embeddings: int = 4096
    rope_theta: float = 1000000.0
    # HF-style dict, normalized to a sorted item tuple (hashable config)
    rope_scaling: object = None
    rms_norm_eps: float = 1e-5
    router_aux_loss_coef: float = 0.02
    remat: bool = False
    attention_backend: str = "auto"
    sequence_parallel: bool = False
    moe_impl: str = "dense"        # dense | sparse | a2a (raises)
    capacity_factor: float = 1.25  # sparse: C = ceil(k*S/E * factor)

    def __post_init__(self):
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(
                self, "rope_scaling", tuple(sorted(self.rope_scaling.items())))

    @property
    def rope_scaling_dict(self) -> dict | None:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def mixtral_8x7b(cls, **overrides) -> "MixtralConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "MixtralConfig":
        defaults = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            num_local_experts=4, num_experts_per_tok=2,
            max_position_embeddings=128,
        )
        defaults.update(overrides)
        return cls(**defaults)

    def _as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rope_theta=self.rope_theta, rope_scaling=self.rope_scaling_dict,
            rms_norm_eps=self.rms_norm_eps,
            attention_backend=self.attention_backend,
        )


def init_params(config: MixtralConfig, generator: torch.Generator | int = 0,
                dtype=torch.float32, device=None) -> dict:
    """The reference's tree: N(0, 0.02) kernels and unit norm scales,
    drawn from `generator` (or a seed) on `device` (CUDA unless
    "cpu")."""
    dev, g = make_generator(generator, device)
    h, L, E = (config.hidden_size, config.num_hidden_layers,
               config.num_local_experts)
    f = config.intermediate_size
    kv = config.num_key_value_heads * config.head_dim

    def stack(d_in, d_out):
        return {"kernel": normal_init(g, (L, d_in, d_out), 0.02, dtype)}

    def estack(d_in, d_out):
        return {"kernel": normal_init(g, (L, E, d_in, d_out), 0.02, dtype)}

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "embed_tokens": {"embedding": normal_init(
            g, (config.vocab_size, h), 0.02, dtype)},
        "layers": {
            "input_layernorm": {"scale": ones(L, h)},
            "attn": {"q_proj": stack(h, h), "k_proj": stack(h, kv),
                     "v_proj": stack(h, kv), "o_proj": stack(h, h)},
            "post_attention_layernorm": {"scale": ones(L, h)},
            "moe": {
                "router": stack(h, E),
                "experts": {"gate_proj": estack(h, f),
                            "up_proj": estack(h, f),
                            "down_proj": estack(f, h)},
            },
        },
        "norm": {"scale": ones(h)},
        "lm_head": {"kernel": normal_init(g, (h, config.vocab_size), 0.02,
                                          dtype)},
    }


def _ein(eq: str, a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """einsum with f32 accumulation, cast to `dtype` (the reference's
    `preferred_element_type=f32` then `.astype`)."""
    ct = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(ct), b.to(ct)).to(dtype)


def _route(config: MixtralConfig, moe: dict, x: torch.Tensor):
    """(probs [B, S, E], top-k probs renormalised, top-k ids, aux loss)."""
    E, k = config.num_local_experts, config.num_experts_per_tok
    kernel = moe["router"]["kernel"]
    ct = torch.promote_types(x.dtype, kernel.dtype)
    probs = torch.softmax(logits_f32(x.to(ct), kernel.to(ct)), dim=-1)
    topk_probs, topk_idx = topk_lower_index_first(probs, k)
    topk_probs = topk_probs / torch.sum(topk_probs, dim=-1, keepdim=True)
    # the Switch-style load-balancing loss
    token_frac = torch.mean(F.one_hot(topk_idx, E).float().sum(dim=2),
                            dim=(0, 1)) / k
    prob_frac = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(token_frac * prob_frac)
    return probs, topk_probs, topk_idx, aux


def moe_block(config: MixtralConfig, moe: dict, x: torch.Tensor,
              fp8: dict | None = None) -> tuple:
    """The top-k routed expert MLP: (out, router aux loss, new metas or
    None). With `fp8` (per-role {gate,up,down}_proj meta pairs) the expert
    projections run through `ops.fp8.fp8_expert_dense`; the router stays
    in full precision."""
    if config.moe_impl == "sparse":
        return moe_block_sparse(config, moe, x, fp8)
    if config.moe_impl == "a2a":
        raise NotImplementedError(
            "moe_impl='a2a' (token-sharded expert parallelism) arrives "
            "with the port's sharded-parallelism slice (ROADMAP.md, queue 1 "
            "item 6b); use 'dense' or 'sparse'")
    if config.moe_impl != "dense":
        raise ValueError(f"unknown moe_impl {config.moe_impl!r}; use "
                         "'dense', 'sparse', or 'a2a'")
    E = config.num_local_experts
    b, s, h = x.shape
    _, topk_probs, topk_idx, aux = _route(config, moe, x)
    combine = torch.sum(F.one_hot(topk_idx, E).to(x.dtype)
                        * topk_probs[..., None].to(x.dtype), dim=2)
    experts = moe["experts"]
    if fp8 is not None:
        x2 = x.reshape(b * s, h)
        g8, mg = fp8_expert_dense(x2, experts["gate_proj"]["kernel"],
                                  fp8["gate_proj"])
        u8, mu = fp8_expert_dense(x2, experts["up_proj"]["kernel"],
                                  fp8["up_proj"])
        gate = F.silu(g8.float()).to(x.dtype)
        d8, md = fp8_expert_dense(gate * u8.to(x.dtype),
                                  experts["down_proj"]["kernel"],
                                  fp8["down_proj"])
        expert_out = d8.reshape(E, b, s, h).permute(1, 0, 2, 3).to(x.dtype)
        new_fp8 = {"gate_proj": mg, "up_proj": mu, "down_proj": md}
    else:
        gate = F.silu(_ein("bsh,ehf->besf", x,
                           experts["gate_proj"]["kernel"], x.dtype))
        up = _ein("bsh,ehf->besf", x, experts["up_proj"]["kernel"], x.dtype)
        expert_out = _ein("besf,efh->besh", gate * up,
                          experts["down_proj"]["kernel"], x.dtype)
        new_fp8 = None
    out = torch.einsum("besh,bse->bsh", expert_out, combine)
    return out, aux, new_fp8


# the reference's crossover, set from v5e timings (one-hot einsum dispatch
# up to ~2k context, the sort beyond); kept so both packages dispatch
# alike, not measured on the card
_ONEHOT_DISPATCH_MAX_ELEMENTS = 16 * 2**20


def moe_block_sparse(config: MixtralConfig, moe: dict, x: torch.Tensor,
                     fp8: dict | None = None) -> tuple:
    """Capacity-bounded dispatch: an expert computes C tokens, not S; the
    one-hot dispatch while its [S k, E, C] tensor stays under the
    reference's threshold (and without fp8), else the sort."""
    b, s, h = x.shape
    E, k = config.num_local_experts, config.num_experts_per_tok
    cap = min(int(math.ceil(k * s / E * config.capacity_factor)), s * k)
    _, topk_probs, topk_idx, aux = _route(config, moe, x)
    if fp8 is None and s * k * E * cap <= _ONEHOT_DISPATCH_MAX_ELEMENTS:
        expert_out, combine = _dispatch_onehot(config, moe, x, topk_idx,
                                               topk_probs, cap)
        return _combine_onehot(expert_out, combine, b, s, k, h), aux, None
    rows = [sort_dispatch(x[i], topk_idx[i], topk_probs[i].to(x.dtype), E,
                          cap) for i in range(b)]
    buffers = torch.stack([buf for buf, _ in rows])          # [B, E, C, H]
    expert_out, new_fp8 = _expert_mlp(moe, buffers, x.dtype, fp8)
    out = torch.stack([sort_combine(expert_out[i], info)
                       for i, (_, info) in enumerate(rows)])
    return out, aux, new_fp8


def _expert_mlp(moe: dict, buffers: torch.Tensor, dtype,
                fp8: dict | None = None):
    """The SwiGLU experts over [B, E, C, H] capacity buffers: (out
    [B, E, C, H], new metas or None)."""
    experts = moe["experts"]
    if fp8 is not None:
        b, e, c, h = buffers.shape
        xb = buffers.permute(1, 0, 2, 3).reshape(e, b * c, h)
        g8, mg = fp8_expert_dense(xb, experts["gate_proj"]["kernel"],
                                  fp8["gate_proj"])
        u8, mu = fp8_expert_dense(xb, experts["up_proj"]["kernel"],
                                  fp8["up_proj"])
        gate = F.silu(g8.float()).to(dtype)
        d8, md = fp8_expert_dense(gate * u8.to(dtype),
                                  experts["down_proj"]["kernel"],
                                  fp8["down_proj"])
        out = d8.reshape(e, b, c, h).permute(1, 0, 2, 3).to(dtype)
        return out, {"gate_proj": mg, "up_proj": mu, "down_proj": md}
    gate = F.silu(_ein("bech,ehf->becf", buffers,
                       experts["gate_proj"]["kernel"], dtype))
    up = _ein("bech,ehf->becf", buffers, experts["up_proj"]["kernel"], dtype)
    out = _ein("becf,efh->bech", gate * up, experts["down_proj"]["kernel"],
               dtype)
    return out, None


def _dispatch_onehot(config, moe, x, topk_idx, topk_probs, cap):
    """GShard one-hot einsum dispatch: (expert_out, combine)."""
    b, s, _ = x.shape
    E, k = config.num_local_experts, config.num_experts_per_tok
    flat_idx = topk_idx.reshape(b, s * k)                      # [B, S*k]
    flat_prob = topk_probs.reshape(b, s * k).float()
    onehot = F.one_hot(flat_idx, E)                            # [B, S*k, E]
    slot = torch.amax(torch.cumsum(onehot, dim=1) * onehot - 1, dim=-1)
    keep = slot < cap
    # dispatch one-hots [B, S*k, E, C]; a dropped assignment is all zero
    d = (F.one_hot(flat_idx, E).to(x.dtype)[..., None]
         * F.one_hot(torch.where(keep, slot, cap), cap + 1).to(
             x.dtype)[..., None, :])[..., :cap]
    x_rep = x.repeat_interleave(k, dim=1)                     # [B, S*k, H]
    expert_in = torch.einsum("btec,bth->bech", d, x_rep)      # gather
    expert_out, _ = _expert_mlp(moe, expert_in, x.dtype)
    combine = d * flat_prob[..., None, None].to(x.dtype)
    return expert_out, combine


def _combine_onehot(expert_out, combine, b, s, k, h):
    out_flat = torch.einsum("btec,bech->bth", combine, expert_out)
    return out_flat.reshape(b, s, k, h).sum(dim=2)


def forward(config: MixtralConfig, params: dict, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            fp8_state: dict | None = None) -> tuple:
    """(logits [B, S, V] f32, the router aux loss averaged over layers);
    with `fp8_state` (see `init_fp8_state`) the attention and expert
    projections run fp8 and the result is (logits, aux,
    new_fp8_state)."""
    if config.sequence_parallel:
        raise NotImplementedError(
            "sequence_parallel arrives with the port's sharded-parallelism "
            "slice (ROADMAP.md, queue 1 item 6b)")
    lcfg = config._as_llama()
    x = params["embed_tokens"]["embedding"][input_ids.long()]
    positions = torch.arange(input_ids.shape[1],
                             device=x.device).expand(input_ids.shape)
    cos, sin = rope_frequencies(
        config.head_dim, config.max_position_embeddings, config.rope_theta,
        scaling=config.rope_scaling_dict, device=x.device)
    eps = config.rms_norm_eps

    def layer_step(x, layer, f):
        attn_out, _, fp8_attn = _attention(
            lcfg, layer, rms_norm(x, layer["input_layernorm"]["scale"], eps),
            cos, sin, positions, attention_mask,
            fp8=None if f is None else {"attn": f["attn"]})
        x = x + attn_out
        moe_out, aux, fp8_moe = moe_block(
            config, layer["moe"],
            rms_norm(x, layer["post_attention_layernorm"]["scale"], eps),
            None if f is None else f["moe"])
        new = None if f is None else {"attn": fp8_attn, "moe": fp8_moe}
        return x + moe_out, aux, new

    body = rematted(layer_step, config.remat)
    n = config.num_hidden_layers
    metas = ([None] * n if fp8_state is None
             else unstack_layers(fp8_state["layers"], n))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_metas = []
    for layer, f in zip(unstack_layers(params["layers"], n), metas):
        x, aux, new = body(x, layer, f)
        aux_total = aux_total + aux
        new_metas.append(new)
    x = rms_norm(x, params["norm"]["scale"], eps)
    logits = logits_f32(x, params["lm_head"]["kernel"].to(x.dtype))
    aux_total = aux_total / n
    if fp8_state is not None:
        return logits, aux_total, {"layers": stack_layers(new_metas)}
    return logits, aux_total


def init_fp8_state(config: MixtralConfig, history_len: int | None = None,
                   device=None) -> dict:
    """Per-layer delayed-scaling metas of the attention projections and
    the expert MLPs on `device` (CUDA unless "cpu"); the router is not
    converted."""
    return stacked_fp8_metas(config.num_hidden_layers, {
        "attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
        "moe": ("gate_proj", "up_proj", "down_proj"),
    }, history_len, device=device)


def causal_lm_loss(config: MixtralConfig, params: dict, batch: dict,
                   fp8_state: dict | None = None):
    """Next-token loss plus `router_aux_loss_coef` times the aux loss;
    with `fp8_state` (mixed_precision="fp8") returns (loss,
    new_fp8_state)."""
    input_ids = batch["input_ids"]
    attn_mask, mask = shifted_padding_masks(batch.get("attention_mask"))
    out = forward(config, params, input_ids[:, :-1],
                  attention_mask=attn_mask, fp8_state=fp8_state)
    loss = cross_entropy_loss(out[0], input_ids[:, 1:], mask)
    loss = loss + config.router_aux_loss_coef * out[1]
    return (loss, out[2]) if fp8_state is not None else loss
