"""T5 encoder-decoder LM (port of `accelerate_tpu/models/t5.py`).

T5 specifics, as the reference has them: RMSNorm without bias, NO
attention score scaling (the 1/sqrt(d) is folded into the init),
bias-free projections, relative position buckets added to the scores
(one table per self-attention stack; cross-attention has none), a ReLU
or gated tanh-GELU MLP (v1.1/T0), and a tied head scaled by
d_model**-0.5 or an untied one. Two stacked-layer stacks, encoder and
decoder.

The reference runs T5 under f32 matmul precision (its unscaled attention
amplifies bf16-input rounding); torch's f32 matmuls are f32 on the CPU,
and on the card while TF32 stays off, which is torch's default.
Incremental decode precomputes every decoder layer's cross-attention
K/V once and keeps stacked self-attention caches. `streamed_generate` is
the hybrid big-model decode: the encoder's layers stream to the device
through `big_modeling`, the decoder stays resident.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fp8 import stacked_fp8_metas
from .common import (
    dense,
    dense_maybe_fp8,
    logits_f32,
    make_generator,
    masked_mean,
    normal_init,
    rms_norm,
    run_layers,
    token_nll,
    unstack_layers,
)
from ..device import resolve_device
from .decode import (
    cached_attention_mask,
    derive_key,
    extend_cache,
    make_kv_caches,
    sample_token,
)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24            # encoder
    num_decoder_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    is_gated_act: bool = True       # v1.1/T0 gated-gelu; False = relu (t5)
    tie_word_embeddings: bool = False  # v1.1/T0 untie

    @classmethod
    def tiny(cls, **overrides) -> "T5Config":
        defaults = dict(
            vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2,
            num_decoder_layers=2, num_heads=4,
        )
        defaults.update(overrides)
        return cls(**defaults)


def init_params(config: T5Config, generator: torch.Generator | int = 0,
                dtype=torch.float32, device=None) -> dict:
    """The reference's tree: N(0, 0.02) kernels and bias tables, unit norm
    scales, drawn from `generator` (or a seed) on `device` (CUDA unless
    "cpu")."""
    dev, g = make_generator(generator, device)
    h, kv = config.d_model, config.num_heads * config.d_kv

    def normal(*shape):
        return normal_init(g, shape, 0.02, dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def attn(L):
        return {"q": {"kernel": normal(L, h, kv)},
                "k": {"kernel": normal(L, h, kv)},
                "v": {"kernel": normal(L, h, kv)},
                "o": {"kernel": normal(L, kv, h)}}

    def mlp(L):
        out = {"wo": {"kernel": normal(L, config.d_ff, h)}}
        if config.is_gated_act:
            out["wi_0"] = {"kernel": normal(L, h, config.d_ff)}
            out["wi_1"] = {"kernel": normal(L, h, config.d_ff)}
        else:
            out["wi"] = {"kernel": normal(L, h, config.d_ff)}
        return out

    def rel_bias():
        return {"embedding": normal(config.relative_attention_num_buckets,
                                    config.num_heads)}

    Le, Ld = config.num_layers, config.num_decoder_layers
    params = {
        "shared": {"embedding": normal(config.vocab_size, h)},
        "encoder": {
            "rel_bias": rel_bias(),
            "layers": {"ln_attn": {"scale": ones(Le, h)}, "attn": attn(Le),
                       "ln_mlp": {"scale": ones(Le, h)}, "mlp": mlp(Le)},
            "final_ln": {"scale": ones(h)},
        },
        "decoder": {
            "rel_bias": rel_bias(),
            "layers": {"ln_self": {"scale": ones(Ld, h)},
                       "self_attn": attn(Ld),
                       "ln_cross": {"scale": ones(Ld, h)},
                       "cross_attn": attn(Ld),
                       "ln_mlp": {"scale": ones(Ld, h)}, "mlp": mlp(Ld)},
            "final_ln": {"scale": ones(h)},
        },
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = {"kernel": normal(h, config.vocab_size)}
    return params


def _relative_buckets(rel_pos: torch.Tensor, bidirectional: bool,
                      num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF T5's relative_position_bucket, as the reference computes it:
    the log-spaced buckets take an f32 log divided by the f32 rounding of
    log(max_distance / max_exact)."""
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + torch.where(n < 0, num_buckets, 0)
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    denom = torch.tensor(np.float32(np.log(max_distance / max_exact)),
                         device=rel_pos.device)
    val_large = max_exact + (
        torch.log(n.clamp(min=1).float() / max_exact) / denom
        * (num_buckets - max_exact)).to(rel_pos.dtype)
    val_large = val_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def _position_bias(rel_embedding, q_len: int, k_len: int,
                   bidirectional: bool, num_buckets: int, max_distance: int):
    """[H, q_len, k_len] additive attention bias."""
    dev = rel_embedding.device
    ctx = torch.arange(q_len, device=dev)[:, None]
    mem = torch.arange(k_len, device=dev)[None, :]
    buckets = _relative_buckets(mem - ctx, bidirectional, num_buckets,
                                max_distance)
    return rel_embedding[buckets].permute(2, 0, 1)


def _attend(q, k, v, bias, mask, dtype):
    """Unscaled attention of q [B, Sq, H, D] over k, v [B, Sk, H, D]:
    f32 scores plus the additive bias, masked, f32 softmax."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = torch.where(mask.bool(), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(dtype)


def _t5_attention(config: T5Config, proj, x, kv_src, bias, mask, fp8=None):
    """(out, new metas or None); with `fp8` ({q,k,v,o} meta pairs) the
    projections run the delayed-scaled swap point."""
    b, sq, _ = x.shape
    sk = kv_src.shape[1]
    nh, dk = config.num_heads, config.d_kv
    f = fp8 or {}
    q, m_q = dense_maybe_fp8(x, proj["q"]["kernel"], f.get("q"))
    k, m_k = dense_maybe_fp8(kv_src, proj["k"]["kernel"], f.get("k"))
    v, m_v = dense_maybe_fp8(kv_src, proj["v"]["kernel"], f.get("v"))
    out = _attend(q.reshape(b, sq, nh, dk), k.reshape(b, sk, nh, dk),
                  v.reshape(b, sk, nh, dk), None if bias is None
                  else bias[None], mask, x.dtype)
    o, m_o = dense_maybe_fp8(out.reshape(b, sq, nh * dk),
                             proj["o"]["kernel"], f.get("o"))
    new = {"q": m_q, "k": m_k, "v": m_v, "o": m_o} if fp8 is not None \
        else None
    return o, new


def _t5_mlp(config: T5Config, layer, x, fp8=None):
    f = fp8 or {}
    if config.is_gated_act:
        g0, m_0 = dense_maybe_fp8(x, layer["wi_0"]["kernel"], f.get("wi_0"))
        g = F.gelu(g0.float(), approximate="tanh").to(x.dtype)
        u, m_1 = dense_maybe_fp8(x, layer["wi_1"]["kernel"], f.get("wi_1"))
        y = g * u.to(x.dtype)
        new = {"wi_0": m_0, "wi_1": m_1} if fp8 is not None else None
    else:
        y0, m_i = dense_maybe_fp8(x, layer["wi"]["kernel"], f.get("wi"))
        y = torch.relu(y0)
        new = {"wi": m_i} if fp8 is not None else None
    o, m_o = dense_maybe_fp8(y, layer["wo"]["kernel"], f.get("wo"))
    if fp8 is not None:
        new["wo"] = m_o
    return o, new


def _encoder(config: T5Config, params, input_ids, enc_mask, fp8=None):
    """The encoded states; with `fp8` (the "encoder" subtree of
    `init_fp8_state`) returns (enc, new_fp8)."""
    eps = config.layer_norm_epsilon
    x = params["shared"]["embedding"][input_ids.long()]
    s = input_ids.shape[1]
    bias = _position_bias(params["encoder"]["rel_bias"]["embedding"], s, s,
                          True, config.relative_attention_num_buckets,
                          config.relative_attention_max_distance)
    pad = enc_mask[:, None, None, :] if enc_mask is not None else None

    def body(x, layer, f):
        h = rms_norm(x, layer["ln_attn"]["scale"], eps)
        a, m_a = _t5_attention(config, layer["attn"], h, h, bias, pad,
                               fp8=None if f is None else f["attn"])
        x = x + a
        m, m_m = _t5_mlp(config, layer["mlp"],
                         rms_norm(x, layer["ln_mlp"]["scale"], eps),
                         fp8=None if f is None else f["mlp"])
        return x + m, None if f is None else {"attn": m_a, "mlp": m_m}

    x, new_fp8 = run_layers(body, x, params["encoder"]["layers"],
                            config.num_layers,
                            None if fp8 is None else fp8["layers"])
    out = rms_norm(x, params["encoder"]["final_ln"]["scale"], eps)
    return (out, new_fp8) if fp8 is not None else out


def _head(config: T5Config, params, x):
    """f32 logits: the tied head scales the hidden by d_model**-0.5 (HF
    T5's convention)."""
    if config.tie_word_embeddings:
        x = x * (config.d_model ** -0.5)
        return logits_f32(x, params["shared"]["embedding"].to(x.dtype).t())
    return logits_f32(x, params["lm_head"]["kernel"].to(x.dtype))


def forward(config: T5Config, params: dict, input_ids: torch.Tensor,
            decoder_input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            fp8_state: dict | None = None):
    """Logits [B, S_dec, V] (f32) of the decoder given the encoder's
    inputs. With `fp8_state` (see `init_fp8_state`) the encoder and
    decoder projections run fp8 and the result is (logits,
    new_fp8_state)."""
    eps = config.layer_norm_epsilon
    enc_out = _encoder(config, params, input_ids, attention_mask,
                       fp8=None if fp8_state is None else fp8_state["encoder"])
    enc, enc_fp8 = enc_out if fp8_state is not None else (enc_out, None)
    x = params["shared"]["embedding"][decoder_input_ids.long()]
    sd = decoder_input_ids.shape[1]
    self_bias = _position_bias(
        params["decoder"]["rel_bias"]["embedding"], sd, sd, False,
        config.relative_attention_num_buckets,
        config.relative_attention_max_distance)
    causal = torch.tril(torch.ones((sd, sd), dtype=torch.bool,
                                   device=x.device))[None, None]
    cross_mask = (attention_mask[:, None, None, :]
                  if attention_mask is not None else None)

    def body(x, layer, f):
        def sub(k):
            return None if f is None else f[k]

        h = rms_norm(x, layer["ln_self"]["scale"], eps)
        a, m_s = _t5_attention(config, layer["self_attn"], h, h, self_bias,
                               causal, fp8=sub("self_attn"))
        x = x + a
        h = rms_norm(x, layer["ln_cross"]["scale"], eps)
        c, m_c = _t5_attention(config, layer["cross_attn"], h, enc, None,
                               cross_mask, fp8=sub("cross_attn"))
        x = x + c
        m, m_m = _t5_mlp(config, layer["mlp"],
                         rms_norm(x, layer["ln_mlp"]["scale"], eps),
                         fp8=sub("mlp"))
        new = (None if f is None else
               {"self_attn": m_s, "cross_attn": m_c, "mlp": m_m})
        return x + m, new

    x, dec_fp8 = run_layers(
        body, x, params["decoder"]["layers"], config.num_decoder_layers,
        None if fp8_state is None else fp8_state["decoder"]["layers"])
    x = rms_norm(x, params["decoder"]["final_ln"]["scale"], eps)
    logits = _head(config, params, x)
    if fp8_state is not None:
        return logits, {"encoder": enc_fp8, "decoder": dec_fp8}
    return logits


# --- incremental decode -----------------------------------------------------


def _position_bias_at(rel_embedding, positions, k_len: int,
                      num_buckets: int, max_distance: int):
    """Decoder self-attention bias for queries at `positions` [B, S_q]
    over cached keys 0..k_len-1: [B, H, S_q, k_len]."""
    mem = torch.arange(k_len, device=positions.device)[None, None, :]
    buckets = _relative_buckets(mem - positions.long()[:, :, None], False,
                                num_buckets, max_distance)
    return rel_embedding[buckets].permute(0, 3, 1, 2)


def _qo_attention(config: T5Config, proj, x, k, v, mask, bias=None):
    """T5 attention against precomputed or cached K, V [B, S_k, H, D]:
    only the q and o projections run."""
    b, sq, _ = x.shape
    nh, dk = config.num_heads, config.d_kv
    q = dense(x, proj["q"]["kernel"]).reshape(b, sq, nh, dk)
    out = _attend(q, k, v, bias, mask, x.dtype)
    return dense(out.reshape(b, sq, nh * dk), proj["o"]["kernel"])


def init_decode_state(config: T5Config, params: dict, input_ids,
                      max_new_tokens: int, attention_mask=None,
                      dtype=torch.float32) -> dict:
    """Run the encoder ONCE and project every decoder layer's
    cross-attention K/V from it; the self-attention caches stack on the
    layer dim like the causal families'."""
    enc = _encoder(config, params, input_ids, attention_mask)
    return _state_from_encoded(config, params, enc, max_new_tokens,
                               attention_mask, dtype)


def _state_from_encoded(config: T5Config, params: dict, enc,
                        max_new_tokens: int, attention_mask, dtype) -> dict:
    nh, dk = config.num_heads, config.d_kv
    Ld = config.num_decoder_layers
    b, s_enc = enc.shape[:2]
    cross = params["decoder"]["layers"]["cross_attn"]
    # one einsum over the stacked layer dim projects every layer at once
    cross_k = torch.einsum("bsh,lhf->lbsf", enc, cross["k"]["kernel"]
                           ).reshape(Ld, b, s_enc, nh, dk).to(dtype)
    cross_v = torch.einsum("bsh,lhf->lbsf", enc, cross["v"]["kernel"]
                           ).reshape(Ld, b, s_enc, nh, dk).to(dtype)
    self_k, self_v, cache_len = make_kv_caches(
        Ld, b, 1 + max_new_tokens, nh, dk, dtype, device=enc.device)
    return {"cross_k": cross_k, "cross_v": cross_v, "self_k": self_k,
            "self_v": self_v, "cache_len": cache_len,
            "enc_mask": attention_mask}


def decode_step(config: T5Config, params: dict, decoder_ids, positions,
                state: dict):
    """One incremental decoder step: (logits [B, S, V], the new state).
    `decoder_ids`/`positions` are [B, S] (S=1 in `generate`); the self
    caches are written in place."""
    eps = config.layer_norm_epsilon
    x = params["shared"]["embedding"][decoder_ids.long()]
    m = state["self_k"].shape[2]
    self_bias = _position_bias_at(
        params["decoder"]["rel_bias"]["embedding"], positions, m,
        config.relative_attention_num_buckets,
        config.relative_attention_max_distance)
    self_mask = cached_attention_mask(m, positions)[:, None]
    cross_mask = (state["enc_mask"][:, None, None, :]
                  if state["enc_mask"] is not None else None)
    cache_len = state["cache_len"]
    nh, dk = config.num_heads, config.d_kv
    Ld = config.num_decoder_layers
    for i, layer in enumerate(unstack_layers(params["decoder"]["layers"],
                                             Ld)):
        h = rms_norm(x, layer["ln_self"]["scale"], eps)
        b, sq, _ = h.shape
        k = dense(h, layer["self_attn"]["k"]["kernel"]).reshape(b, sq, nh, dk)
        v = dense(h, layer["self_attn"]["v"]["kernel"]).reshape(b, sq, nh, dk)
        k_full, v_full, _ = extend_cache(
            (state["self_k"][i], state["self_v"][i], cache_len), k, v)
        x = x + _qo_attention(config, layer["self_attn"], h, k_full, v_full,
                              self_mask, self_bias)
        h = rms_norm(x, layer["ln_cross"]["scale"], eps)
        x = x + _qo_attention(config, layer["cross_attn"], h,
                              state["cross_k"][i].to(h.dtype),
                              state["cross_v"][i].to(h.dtype), cross_mask)
        x = x + _t5_mlp(config, layer["mlp"],
                        rms_norm(x, layer["ln_mlp"]["scale"], eps))[0]
    x = rms_norm(x, params["decoder"]["final_ln"]["scale"], eps)
    return _head(config, params, x), dict(
        state, cache_len=cache_len + decoder_ids.shape[1])


def generate(config: T5Config, params: dict, input_ids,
             max_new_tokens: int = 32, temperature: float = 0.0,
             key: int = 0, attention_mask=None,
             decoder_start_token_id: int = 0):
    """Encoder-decoder greedy/temperature decode: the decoder ids WITH
    the start token, [B, 1 + max_new_tokens] (HF's generate layout). Row
    b samples with the stream `derive_key(key, b)`."""
    state = init_decode_state(config, params, input_ids, max_new_tokens,
                              attention_mask)
    return _decode_tokens(config, params, state, input_ids, max_new_tokens,
                          temperature, key, decoder_start_token_id)


def _decode_tokens(config: T5Config, params: dict, state: dict, input_ids,
                   max_new_tokens: int, temperature: float, key: int,
                   decoder_start_token_id: int):
    """The decoder's token loop from the encoded state."""
    b = input_ids.shape[0]
    dev = input_ids.device
    keys = torch.tensor([derive_key(key, i) for i in range(b)],
                        dtype=torch.int64, device=dev)
    last = torch.full((b,), decoder_start_token_id, dtype=torch.int64,
                      device=dev)
    out = [last]
    for step in range(max_new_tokens):
        pos = torch.full((b, 1), step, dtype=torch.int64, device=dev)
        logits, state = decode_step(config, params, last[:, None], pos,
                                    state)
        last = sample_token(logits, keys, temperature, pos[:, 0] + 1)
        out.append(last)
    return torch.stack(out, dim=1).to(input_ids.dtype)


def streamed_generate(config: T5Config, params: dict, input_ids,
                      max_new_tokens: int = 32, temperature: float = 0.0,
                      key: int = 0, attention_mask=None,
                      decoder_start_token_id: int = 0, dtype=torch.bfloat16,
                      device=None, stats=None):
    """The hybrid big-model decode, for params laid out by
    `big_modeling` (e.g. `cpu_offload`): the ENCODER layers stream to the
    device once (the encoder runs once a prompt), while the decoder, which
    runs every token, is fetched whole and stays, with the cross-attention
    K/V computed once. Streaming costs where compute happens once; the
    token loop runs at the device's memory rate. Same layout and tokens
    as `generate`."""
    from ..big_modeling import fetch_resident, make_layer_slicer, \
        stream_layers

    dev = resolve_device(device)
    ids = torch.as_tensor(input_ids).to(dev)
    mask = None if attention_mask is None else attention_mask.to(dev)
    s_enc = ids.shape[1]
    eps = config.layer_norm_epsilon

    # the streamed encoder (runs once)
    enc_res = fetch_resident(
        {"shared": params["shared"],
         "rel_bias": params["encoder"]["rel_bias"],
         "final_ln": params["encoder"]["final_ln"]},
        stacked_module="", device=dev, dtype=dtype)
    n_layers, layer_slice = make_layer_slicer(
        params["encoder"]["layers"], dev, dtype, stats)
    bias = _position_bias(
        enc_res["rel_bias"]["embedding"].float(), s_enc, s_enc, True,
        config.relative_attention_num_buckets,
        config.relative_attention_max_distance)
    pad = mask[:, None, None, :] if mask is not None else None

    def enc_layer(layer, i, x):
        h = rms_norm(x, layer["ln_attn"]["scale"], eps)
        x = x + _t5_attention(config, layer["attn"], h, h, bias, pad)[0]
        return x + _t5_mlp(config, layer["mlp"],
                           rms_norm(x, layer["ln_mlp"]["scale"], eps))[0]

    x = stream_layers(layer_slice, n_layers, enc_layer,
                      enc_res["shared"]["embedding"][ids.long()])
    enc = rms_norm(x, enc_res["final_ln"]["scale"], eps)

    # the resident decoder's token loop
    dec_params = {"shared": enc_res["shared"],
                  "decoder": fetch_resident(params["decoder"], "", dev,
                                            dtype)}
    if "lm_head" in params:
        dec_params.update(fetch_resident({"lm_head": params["lm_head"]}, "",
                                         dev, dtype))
    state = _state_from_encoded(config, dec_params, enc, max_new_tokens,
                                mask, dtype)
    return _decode_tokens(config, dec_params, state, ids, max_new_tokens,
                          temperature, key, decoder_start_token_id)


def init_fp8_state(config: T5Config, history_len: int | None = None,
                   device=None) -> dict:
    """Per-layer delayed-scaling metas of every encoder and decoder
    projection on `device` (CUDA unless "cpu"), in the params' layout:
    {"encoder": {"layers": ...}, "decoder": {"layers": ...}}."""
    attn = ("q", "k", "v", "o")
    mlp = ("wi_0", "wi_1", "wo") if config.is_gated_act else ("wi", "wo")
    return {
        "encoder": stacked_fp8_metas(config.num_layers,
                                     {"attn": attn, "mlp": mlp},
                                     history_len, device=device),
        "decoder": stacked_fp8_metas(
            config.num_decoder_layers,
            {"self_attn": attn, "cross_attn": attn, "mlp": mlp},
            history_len, device=device),
    }


def seq2seq_loss(config: T5Config, params: dict, batch: dict,
                 fp8_state: dict | None = None):
    """batch: input_ids, decoder_input_ids, labels, attention_mask?,
    labels_mask?; with `fp8_state` (mixed_precision="fp8") returns (loss,
    new_fp8_state)."""
    out = forward(config, params, batch["input_ids"],
                  batch["decoder_input_ids"], batch.get("attention_mask"),
                  fp8_state=fp8_state)
    logits, new_fp8 = out if fp8_state is not None else (out, None)
    nll = token_nll(logits, batch["labels"])
    mask = batch.get("labels_mask")
    if mask is None:
        loss = torch.mean(nll)
    else:
        m = mask.float()
        loss = masked_mean(torch.sum(nll * m), torch.sum(m))
    return (loss, new_fp8) if fp8_state is not None else loss
