"""HuggingFace checkpoint import (port of `accelerate_tpu/models/hf_import.py`).

A HF state dict (names -> tensors or numpy arrays) becomes the port's
stacked param tree in three transforms per weight, as in the reference:

- the name map (`model.layers.{i}.self_attn.q_proj.weight` ->
  `layers/attn/q_proj`);
- the layout: `nn.Linear` stores [out, in], the port's kernels are
  [in, out], so those transpose (GPT-2's Conv1D is already [in, out]);
- stacking: per-layer tensors stack on a leading [L] dim.

As the reference does, a torch bf16 tensor in a state dict converts to
f32; arrays keep their dtype, and so does a checkpoint read from files by
`load_hf_checkpoint` (then cast to `dtype` if given). Configs come from a
transformers config object or a plain dict. The module imports neither
`transformers` nor `safetensors`. Every converter returns the tree on
`device` (CUDA unless "cpu").
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping

import numpy as np
import torch

from ..device import resolve_device
from .bert import BertConfig
from .gpt2 import GPT2Config
from .gpt_neox import GPTNeoXConfig
from .gptj import GPTJConfig
from .llama import LlamaConfig
from .mixtral import MixtralConfig
from .opt import OPTConfig
from .t5 import T5Config


class _FromFile:
    """A tensor read from a checkpoint file: it keeps its dtype (the
    reference reads files to numpy, bf16 included)."""

    __slots__ = ("tensor",)

    def __init__(self, tensor):
        self.tensor = tensor


def _t(x) -> torch.Tensor:
    """A state-dict entry as a host tensor: torch bf16 upcast to f32 (the
    reference's `_np`), arrays and file tensors as they are."""
    if isinstance(x, _FromFile):
        return x.tensor
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float() if x.dtype == torch.bfloat16 else x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _T(x) -> torch.Tensor:
    """A transposed [out, in] weight, contiguous."""
    return _t(x).T.contiguous()


def _getter(hf_config):
    """One accessor over a transformers config object or a plain dict."""
    if isinstance(hf_config, dict):
        return lambda k, d=None: hf_config.get(k, d)
    return lambda k, d=None: getattr(hf_config, k, d)


def _stack(sd: Mapping[str, Any], template: str, n: int,
           transpose: bool) -> torch.Tensor:
    """Per-layer tensors `template.format(i)` stacked into [n, ...]."""
    return torch.stack([_T(sd[template.format(i)]) if transpose
                        else _t(sd[template.format(i)]) for i in range(n)])


def _placed(convert):
    """A converter that takes `device=` (CUDA unless "cpu") and returns
    its tree there."""

    @functools.wraps(convert)
    def wrapper(config, sd: Mapping[str, Any], device=None) -> dict:
        dev = resolve_device(device)
        return _map(lambda t: t.to(dev), convert(config, sd))

    return wrapper


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# --- llama, mistral, qwen2 --------------------------------------------------


def llama_config_from_hf(hf_config) -> LlamaConfig:
    get = _getter(hf_config)
    explicit_hd = get("head_dim")
    derived_hd = get("hidden_size") // get("num_attention_heads")
    if explicit_hd and explicit_hd != derived_hd:
        raise ValueError(
            f"unsupported: checkpoint sets head_dim={explicit_hd} but "
            f"hidden_size/num_heads={derived_hd}; decoupled head dims "
            "(e.g. Mistral-Nemo) are not implemented yet")
    return LlamaConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=(get("num_key_value_heads")
                             or get("num_attention_heads")),
        max_position_embeddings=get("max_position_embeddings", 2048),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=(dict(get("rope_scaling")) if get("rope_scaling")
                      else None),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
        attention_bias=bool(get("attention_bias", False)),
        # Qwen2 ships a sliding_window it gates off with
        # use_sliding_window=False: only an applied window restricts
        sliding_window=(get("sliding_window")
                        if get("use_sliding_window", True) else None),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
    )


def mistral_config_from_hf(hf_config) -> LlamaConfig:
    """Mistral is llama-shaped; its `sliding_window` imports onto the
    config."""
    return llama_config_from_hf(hf_config)


def qwen2_config_from_hf(hf_config) -> LlamaConfig:
    """Qwen2 is llama-shaped with qkv projection biases."""
    return dataclasses.replace(llama_config_from_hf(hf_config),
                               attention_bias=True)


@_placed
def llama_params_from_hf(config: LlamaConfig, sd: Mapping[str, Any]) -> dict:
    """A `LlamaForCausalLM`-shaped state dict: Llama 1/2/3, Mistral, and
    Qwen2 (whose qkv biases import when the checkpoint has them)."""
    L = config.num_hidden_layers
    p = "model."
    if f"{p}embed_tokens.weight" not in sd and "embed_tokens.weight" in sd:
        p = ""  # a bare LlamaModel export

    def attn_proj(name: str) -> dict:
        out = {"kernel": _stack(sd, p + "layers.{}.self_attn." + name
                                + ".weight", L, transpose=True)}
        # follow the checkpoint: HF llama's attention_bias puts a bias on
        # all four projections, Qwen2 only on q/k/v
        if p + "layers.0.self_attn." + name + ".bias" in sd:
            out["bias"] = _stack(sd, p + "layers.{}.self_attn." + name
                                 + ".bias", L, transpose=False)
        return out

    params = {
        "embed_tokens": {"embedding": _t(sd[f"{p}embed_tokens.weight"])},
        "layers": {
            "input_layernorm": {"scale": _stack(
                sd, p + "layers.{}.input_layernorm.weight", L, False)},
            "attn": {name: attn_proj(name)
                     for name in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "post_attention_layernorm": {"scale": _stack(
                sd, p + "layers.{}.post_attention_layernorm.weight", L,
                False)},
            "mlp": {name: {"kernel": _stack(
                sd, p + "layers.{}.mlp." + name + ".weight", L, True)}
                for name in ("gate_proj", "up_proj", "down_proj")},
        },
        "norm": {"scale": _t(sd[f"{p}norm.weight"])},
    }
    if not config.tie_word_embeddings:
        if "lm_head.weight" in sd:
            params["lm_head"] = {"kernel": _T(sd["lm_head.weight"])}
        else:  # the checkpoint tied though the config says untied
            params["lm_head"] = {
                "kernel": params["embed_tokens"]["embedding"].T.contiguous()}
    return params


# --- mixtral ----------------------------------------------------------------


def mixtral_config_from_hf(hf_config) -> MixtralConfig:
    get = _getter(hf_config)
    return MixtralConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=(get("num_key_value_heads")
                             or get("num_attention_heads")),
        num_local_experts=get("num_local_experts", 8),
        num_experts_per_tok=get("num_experts_per_tok", 2),
        max_position_embeddings=get("max_position_embeddings", 2048),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=(dict(get("rope_scaling")) if get("rope_scaling")
                      else None),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
    )


@_placed
def mixtral_params_from_hf(config: MixtralConfig,
                           sd: Mapping[str, Any]) -> dict:
    """A `MixtralForCausalLM` state dict; the experts' w1/w3/w2 are
    gate/up/down."""
    L, E = config.num_hidden_layers, config.num_local_experts
    p = "model."

    def estack(w: str) -> torch.Tensor:   # [L, E, in, out]
        return torch.stack([torch.stack([
            _T(sd[f"{p}layers.{i}.block_sparse_moe.experts.{e}.{w}.weight"])
            for e in range(E)]) for i in range(L)])

    return {
        "embed_tokens": {"embedding": _t(sd[f"{p}embed_tokens.weight"])},
        "layers": {
            "input_layernorm": {"scale": _stack(
                sd, p + "layers.{}.input_layernorm.weight", L, False)},
            "attn": {name: {"kernel": _stack(
                sd, p + "layers.{}.self_attn." + name + ".weight", L, True)}
                for name in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "post_attention_layernorm": {"scale": _stack(
                sd, p + "layers.{}.post_attention_layernorm.weight", L,
                False)},
            "moe": {
                "router": {"kernel": _stack(
                    sd, p + "layers.{}.block_sparse_moe.gate.weight", L,
                    True)},
                "experts": {"gate_proj": {"kernel": estack("w1")},
                            "up_proj": {"kernel": estack("w3")},
                            "down_proj": {"kernel": estack("w2")}},
            },
        },
        "norm": {"scale": _t(sd[f"{p}norm.weight"])},
        "lm_head": {"kernel": _T(sd["lm_head.weight"])},
    }


# --- bert -------------------------------------------------------------------


def bert_config_from_hf(hf_config, num_labels: int | None = None
                        ) -> BertConfig:
    get = _getter(hf_config)
    return BertConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        max_position_embeddings=get("max_position_embeddings", 512),
        type_vocab_size=get("type_vocab_size", 2),
        layer_norm_eps=get("layer_norm_eps", 1e-12),
        num_labels=num_labels or len(get("id2label", None) or {0: 0, 1: 1}),
    )


@_placed
def bert_params_from_hf(config: BertConfig, sd: Mapping[str, Any]) -> dict:
    """A `BertForSequenceClassification` (or bare `BertModel`) state
    dict."""
    L = config.num_hidden_layers
    p = "bert." if any(k.startswith("bert.") for k in sd) else ""
    emb = f"{p}embeddings."
    enc = p + "encoder.layer.{}."

    def lin(template: str) -> dict:
        return {"kernel": _stack(sd, template + ".weight", L, True),
                "bias": _stack(sd, template + ".bias", L, False)}

    def ln(template: str) -> dict:
        return {"scale": _stack(sd, template + ".weight", L, False),
                "bias": _stack(sd, template + ".bias", L, False)}

    params = {
        "embed_tokens": {"embedding": _t(sd[emb + "word_embeddings.weight"])},
        "position_embeddings": {"embedding": _t(
            sd[emb + "position_embeddings.weight"])},
        "token_type_embeddings": {"embedding": _t(
            sd[emb + "token_type_embeddings.weight"])},
        "embeddings_layernorm": {"scale": _t(sd[emb + "LayerNorm.weight"]),
                                 "bias": _t(sd[emb + "LayerNorm.bias"])},
        "layers": {
            "attn": {"q_proj": lin(enc + "attention.self.query"),
                     "k_proj": lin(enc + "attention.self.key"),
                     "v_proj": lin(enc + "attention.self.value"),
                     "o_proj": lin(enc + "attention.output.dense")},
            "attention_layernorm": ln(enc + "attention.output.LayerNorm"),
            "mlp": {"up_proj": lin(enc + "intermediate.dense"),
                    "down_proj": lin(enc + "output.dense")},
            "output_layernorm": ln(enc + "output.LayerNorm"),
        },
        "pooler": {"kernel": _T(sd[p + "pooler.dense.weight"]),
                   "bias": _t(sd[p + "pooler.dense.bias"])},
    }
    if "classifier.weight" in sd:
        params["classifier"] = {"kernel": _T(sd["classifier.weight"]),
                                "bias": _t(sd["classifier.bias"])}
    else:  # a bare BertModel: a zero head, so the forward still runs
        params["classifier"] = {
            "kernel": torch.zeros((config.hidden_size, config.num_labels)),
            "bias": torch.zeros((config.num_labels,))}
    return params


# --- gpt2 -------------------------------------------------------------------


def gpt2_config_from_hf(hf_config) -> GPT2Config:
    get = _getter(hf_config)
    return GPT2Config(
        vocab_size=get("vocab_size"),
        hidden_size=get("n_embd") or get("hidden_size"),
        num_hidden_layers=get("n_layer") or get("num_hidden_layers"),
        num_attention_heads=get("n_head") or get("num_attention_heads"),
        max_position_embeddings=(get("n_positions")
                                 or get("max_position_embeddings", 1024)),
        layer_norm_epsilon=get("layer_norm_epsilon", 1e-5),
    )


@_placed
def gpt2_params_from_hf(config: GPT2Config, sd: Mapping[str, Any]) -> dict:
    """A `GPT2LMHeadModel` state dict: Conv1D kernels are already
    [in, out], so nothing transposes."""
    L = config.num_hidden_layers
    p = "transformer." if any(k.startswith("transformer.") for k in sd) \
        else ""
    hl = p + "h.{}."

    def conv1d(template: str) -> dict:
        return {"kernel": _stack(sd, template + ".weight", L, False),
                "bias": _stack(sd, template + ".bias", L, False)}

    def ln(template: str) -> dict:
        return {"scale": _stack(sd, template + ".weight", L, False),
                "bias": _stack(sd, template + ".bias", L, False)}

    return {
        "wte": {"embedding": _t(sd[p + "wte.weight"])},
        "wpe": {"embedding": _t(sd[p + "wpe.weight"])},
        "layers": {
            "ln_1": ln(hl + "ln_1"),
            "attn": {"c_attn": conv1d(hl + "attn.c_attn"),
                     "c_proj": conv1d(hl + "attn.c_proj")},
            "ln_2": ln(hl + "ln_2"),
            "mlp": {"c_fc": conv1d(hl + "mlp.c_fc"),
                    "c_proj": conv1d(hl + "mlp.c_proj")},
        },
        "ln_f": {"scale": _t(sd[p + "ln_f.weight"]),
                 "bias": _t(sd[p + "ln_f.bias"])},
    }


# --- gpt-neox ---------------------------------------------------------------


def gpt_neox_config_from_hf(hf_config) -> GPTNeoXConfig:
    get = _getter(hf_config)
    return GPTNeoXConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        max_position_embeddings=get("max_position_embeddings", 2048),
        rotary_pct=get("rotary_pct", 0.25),
        rotary_emb_base=get("rotary_emb_base", 10000.0),
        layer_norm_eps=get("layer_norm_eps", 1e-5),
        use_parallel_residual=bool(get("use_parallel_residual", True)),
    )


@_placed
def gpt_neox_params_from_hf(config: GPTNeoXConfig,
                            sd: Mapping[str, Any]) -> dict:
    """A `GPTNeoXForCausalLM` state dict; the fused qkv keeps HF's
    per-head packing ([head][q|k|v][head_dim]), which the forward
    unpacks."""
    L = config.num_hidden_layers
    p = "gpt_neox." if any(k.startswith("gpt_neox.") for k in sd) else ""
    hl = p + "layers.{}."

    def lin(template: str) -> dict:
        return {"kernel": _stack(sd, template + ".weight", L, True),
                "bias": _stack(sd, template + ".bias", L, False)}

    def ln(template: str) -> dict:
        return {"scale": _stack(sd, template + ".weight", L, False),
                "bias": _stack(sd, template + ".bias", L, False)}

    return {
        "embed_in": {"embedding": _t(sd[p + "embed_in.weight"])},
        "layers": {
            "input_layernorm": ln(hl + "input_layernorm"),
            "attn": {"query_key_value": lin(hl + "attention.query_key_value"),
                     "dense": lin(hl + "attention.dense")},
            "post_attention_layernorm": ln(hl + "post_attention_layernorm"),
            "mlp": {"dense_h_to_4h": lin(hl + "mlp.dense_h_to_4h"),
                    "dense_4h_to_h": lin(hl + "mlp.dense_4h_to_h")},
        },
        "final_layer_norm": {"scale": _t(sd[p + "final_layer_norm.weight"]),
                             "bias": _t(sd[p + "final_layer_norm.bias"])},
        "embed_out": {"kernel": _T(sd["embed_out.weight"])},
    }


# --- gpt-j ------------------------------------------------------------------


def gptj_config_from_hf(hf_config) -> GPTJConfig:
    get = _getter(hf_config)
    hidden = get("n_embd") or get("hidden_size")
    heads = get("n_head") or get("num_attention_heads")
    rotary = get("rotary_dim", 64)
    return GPTJConfig(
        vocab_size=get("vocab_size"),
        hidden_size=hidden,
        num_hidden_layers=get("n_layer") or get("num_hidden_layers"),
        num_attention_heads=heads,
        max_position_embeddings=(get("n_positions")
                                 or get("max_position_embeddings", 2048)),
        # HF's rotary_dim=None rotates the whole head
        rotary_dim=rotary if rotary is not None else hidden // heads,
        layer_norm_epsilon=get("layer_norm_epsilon", 1e-5),
    )


@_placed
def gptj_params_from_hf(config: GPTJConfig, sd: Mapping[str, Any]) -> dict:
    """A `GPTJForCausalLM` state dict (nn.Linear: transposed)."""
    L = config.num_hidden_layers
    p = "transformer." if any(k.startswith("transformer.") for k in sd) \
        else ""
    hl = p + "h.{}."

    def lin(template: str, bias: bool = True) -> dict:
        out = {"kernel": _stack(sd, template + ".weight", L, True)}
        if bias:
            out["bias"] = _stack(sd, template + ".bias", L, False)
        return out

    return {
        "wte": {"embedding": _t(sd[p + "wte.weight"])},
        "layers": {
            "ln_1": {"scale": _stack(sd, hl + "ln_1.weight", L, False),
                     "bias": _stack(sd, hl + "ln_1.bias", L, False)},
            "attn": {name: lin(hl + "attn." + name, bias=False)
                     for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "mlp": {"fc_in": lin(hl + "mlp.fc_in"),
                    "fc_out": lin(hl + "mlp.fc_out")},
        },
        "ln_f": {"scale": _t(sd[p + "ln_f.weight"]),
                 "bias": _t(sd[p + "ln_f.bias"])},
        "lm_head": {"kernel": _T(sd["lm_head.weight"]),
                    "bias": _t(sd["lm_head.bias"])},
    }


# --- opt --------------------------------------------------------------------


def opt_config_from_hf(hf_config) -> OPTConfig:
    get = _getter(hf_config)
    if get("do_layer_norm_before") is False:
        raise ValueError(
            "unsupported: OPT-350M-style post-LN (do_layer_norm_before="
            "False); all other published OPT sizes are pre-LN and import")
    if (get("word_embed_proj_dim")
            and get("word_embed_proj_dim") != get("hidden_size")):
        raise ValueError(
            "unsupported: OPT word_embed_proj_dim != hidden_size "
            "(projection layers of the 350M checkpoint)")
    return OPTConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        ffn_dim=get("ffn_dim"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        max_position_embeddings=get("max_position_embeddings", 2048),
    )


@_placed
def opt_params_from_hf(config: OPTConfig, sd: Mapping[str, Any]) -> dict:
    """An `OPTForCausalLM` state dict."""
    L = config.num_hidden_layers
    p = ("model.decoder." if any(k.startswith("model.decoder.") for k in sd)
         else "decoder.")
    hl = p + "layers.{}."

    def lin(template: str) -> dict:
        return {"kernel": _stack(sd, template + ".weight", L, True),
                "bias": _stack(sd, template + ".bias", L, False)}

    def ln(template: str) -> dict:
        return {"scale": _stack(sd, template + ".weight", L, False),
                "bias": _stack(sd, template + ".bias", L, False)}

    return {
        "embed_tokens": {"embedding": _t(sd[p + "embed_tokens.weight"])},
        "embed_positions": {"embedding": _t(
            sd[p + "embed_positions.weight"])},
        "layers": {
            "self_attn_layer_norm": ln(hl + "self_attn_layer_norm"),
            "attn": {name: lin(hl + "self_attn." + name)
                     for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "final_layer_norm": ln(hl + "final_layer_norm"),
            "mlp": {"fc1": lin(hl + "fc1"), "fc2": lin(hl + "fc2")},
        },
        "final_layer_norm": {"scale": _t(sd[p + "final_layer_norm.weight"]),
                             "bias": _t(sd[p + "final_layer_norm.bias"])},
    }


# --- t5 ---------------------------------------------------------------------


def t5_config_from_hf(hf_config) -> T5Config:
    get = _getter(hf_config)
    ff_proj = get("feed_forward_proj", "relu") or "relu"
    if ff_proj not in ("relu", "gated-gelu"):
        raise ValueError(
            f"unsupported T5 feed_forward_proj={ff_proj!r}; only 'relu' "
            "(t5) and 'gated-gelu' (v1.1/T0) are implemented: importing "
            "would silently run the wrong activation")
    return T5Config(
        vocab_size=get("vocab_size"),
        d_model=get("d_model"),
        d_kv=get("d_kv", 64),
        d_ff=get("d_ff"),
        num_layers=get("num_layers"),
        num_decoder_layers=get("num_decoder_layers") or get("num_layers"),
        num_heads=get("num_heads"),
        relative_attention_num_buckets=get("relative_attention_num_buckets",
                                           32),
        relative_attention_max_distance=get(
            "relative_attention_max_distance", 128),
        layer_norm_epsilon=get("layer_norm_epsilon", 1e-6),
        is_gated_act=("gated" in ff_proj) or bool(get("is_gated_act", False)),
        tie_word_embeddings=bool(get("tie_word_embeddings", True)),
    )


@_placed
def t5_params_from_hf(config: T5Config, sd: Mapping[str, Any]) -> dict:
    """A `T5ForConditionalGeneration` state dict."""

    def lin(template: str, n: int) -> dict:
        return {"kernel": _stack(sd, template + ".weight", n, True)}

    def ln_scale(template: str, n: int) -> dict:
        return {"scale": _stack(sd, template + ".weight", n, False)}

    def mlp(prefix: str, n: int) -> dict:
        out = {"wo": lin(prefix + ".DenseReluDense.wo", n)}
        if config.is_gated_act:
            out["wi_0"] = lin(prefix + ".DenseReluDense.wi_0", n)
            out["wi_1"] = lin(prefix + ".DenseReluDense.wi_1", n)
        else:
            out["wi"] = lin(prefix + ".DenseReluDense.wi", n)
        return out

    Le, Ld = config.num_layers, config.num_decoder_layers
    e, d = "encoder.block.{}.layer.", "decoder.block.{}.layer."
    params = {
        "shared": {"embedding": _t(sd["shared.weight"])},
        "encoder": {
            "rel_bias": {"embedding": _t(sd[
                "encoder.block.0.layer.0.SelfAttention"
                ".relative_attention_bias.weight"])},
            "layers": {
                "ln_attn": ln_scale(e + "0.layer_norm", Le),
                "attn": {n: lin(e + "0.SelfAttention." + n, Le)
                         for n in ("q", "k", "v", "o")},
                "ln_mlp": ln_scale(e + "1.layer_norm", Le),
                "mlp": mlp(e + "1", Le),
            },
            "final_ln": {"scale": _t(sd["encoder.final_layer_norm.weight"])},
        },
        "decoder": {
            "rel_bias": {"embedding": _t(sd[
                "decoder.block.0.layer.0.SelfAttention"
                ".relative_attention_bias.weight"])},
            "layers": {
                "ln_self": ln_scale(d + "0.layer_norm", Ld),
                "self_attn": {n: lin(d + "0.SelfAttention." + n, Ld)
                              for n in ("q", "k", "v", "o")},
                "ln_cross": ln_scale(d + "1.layer_norm", Ld),
                "cross_attn": {n: lin(d + "1.EncDecAttention." + n, Ld)
                               for n in ("q", "k", "v", "o")},
                "ln_mlp": ln_scale(d + "2.layer_norm", Ld),
                "mlp": mlp(d + "2", Ld),
            },
            "final_ln": {"scale": _t(sd["decoder.final_layer_norm.weight"])},
        },
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = {"kernel": _T(sd["lm_head.weight"])}
    return params


# --- entry points -----------------------------------------------------------

_FAMILIES = {
    "llama": (llama_config_from_hf, llama_params_from_hf),
    "mistral": (mistral_config_from_hf, llama_params_from_hf),
    "qwen2": (qwen2_config_from_hf, llama_params_from_hf),
    "mixtral": (mixtral_config_from_hf, mixtral_params_from_hf),
    "gpt2": (gpt2_config_from_hf, gpt2_params_from_hf),
    "gptj": (gptj_config_from_hf, gptj_params_from_hf),
    "gpt_neox": (gpt_neox_config_from_hf, gpt_neox_params_from_hf),
    "opt": (opt_config_from_hf, opt_params_from_hf),
    "t5": (t5_config_from_hf, t5_params_from_hf),
    "bert": (bert_config_from_hf, bert_params_from_hf),
}


def _family(family: str):
    if family not in _FAMILIES:
        raise ValueError(f"unknown family {family!r}; known: "
                         f"{sorted(_FAMILIES)}")
    return _FAMILIES[family]


def params_from_hf(family: str, config, state_dict: Mapping[str, Any],
                   device=None) -> dict:
    return _family(family)[1](config, state_dict, device=device)


def config_from_hf(family: str, hf_config):
    return _family(family)[0](hf_config)


def load_hf_checkpoint(family: str, config, checkpoint: str, dtype=None,
                       device=None) -> dict:
    """A HF checkpoint (a file, an index, or a directory of sharded
    safetensors or torch .bin files) read into the family's param tree on
    `device` (CUDA unless "cpu"), cast to `dtype` if given."""
    from ..utils.modeling import load_state_dict, resolve_checkpoint_files

    sd: dict[str, _FromFile] = {}
    for f in resolve_checkpoint_files(checkpoint):
        sd.update({k: _FromFile(v) for k, v in load_state_dict(f).items()})
    params = params_from_hf(family, config, sd, device=device)
    if dtype is not None:
        params = _map(lambda t: t.to(dtype), params)
    return params
