"""The port's HF import (`models/hf_import.py`, `utils/modeling.py`)
against the JAX package's converter and against `transformers` models
built from in-code configs (nothing is downloaded).

Tolerances, with their reasons:
- converted params: equal to the JAX converter's, bit for bit and dtype
  for dtype, from one state dict (transposes, stacks and casts are
  exact); configs: equal field for field;
- logits against `transformers`: rtol and atol 3e-4 (the JAX package's
  own import tests hold the same; f32 in another summation order, and
  HF's own attention kernels).
"""

import dataclasses
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from accelerate_tpu.models import hf_import as jh
from accelerate_tpu_torch.models import bert, gpt2, gpt_neox, gptj, llama, \
    mixtral, opt, t5
from accelerate_tpu_torch.models import hf_import as th
from accelerate_tpu_torch.utils import safetensors as tsf

transformers = pytest.importorskip("transformers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hf(family):
    """(transformers config, model, the port's forward giving f32
    logits) for one family at a tiny in-code size."""
    T = transformers
    drop = dict(attention_dropout=0.0)
    if family in ("llama", "mistral", "qwen2"):
        cls, model = {"llama": (T.LlamaConfig, T.LlamaForCausalLM),
                      "mistral": (T.MistralConfig, T.MistralForCausalLM),
                      "qwen2": (T.Qwen2Config, T.Qwen2ForCausalLM)}[family]
        cfg = cls(vocab_size=128, hidden_size=64, intermediate_size=144,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=64,
                  tie_word_embeddings=False, **drop)
        fwd = llama.forward
    elif family == "mixtral":
        cfg = T.MixtralConfig(vocab_size=96, hidden_size=32,
                              intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2,
                              num_local_experts=4, num_experts_per_tok=2,
                              max_position_embeddings=64,
                              router_jitter_noise=0.0, **drop)
        model = T.MixtralForCausalLM

        def fwd(c, p, ids):
            return mixtral.forward(c, p, ids)[0]
    elif family == "bert":
        cfg = T.BertConfig(vocab_size=200, hidden_size=48,
                           intermediate_size=96, num_hidden_layers=2,
                           num_attention_heads=4, max_position_embeddings=64,
                           num_labels=3, hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
        model = T.BertForSequenceClassification
        fwd = bert.forward
    elif family == "gpt2":
        cfg = T.GPT2Config(vocab_size=160, n_embd=64, n_layer=2, n_head=4,
                           n_positions=64, resid_pdrop=0.0, embd_pdrop=0.0,
                           attn_pdrop=0.0)
        model, fwd = T.GPT2LMHeadModel, gpt2.forward
    elif family == "gpt_neox":
        cfg = T.GPTNeoXConfig(vocab_size=160, hidden_size=64,
                              intermediate_size=128, num_hidden_layers=2,
                              num_attention_heads=4,
                              max_position_embeddings=64, rotary_pct=0.25,
                              hidden_dropout=0.0, **drop)
        model, fwd = T.GPTNeoXForCausalLM, gpt_neox.forward
    elif family == "gptj":
        cfg = T.GPTJConfig(vocab_size=160, n_embd=64, n_layer=2, n_head=4,
                           n_positions=64, rotary_dim=8, resid_pdrop=0.0,
                           embd_pdrop=0.0, attn_pdrop=0.0)
        model, fwd = T.GPTJForCausalLM, gptj.forward
    elif family == "opt":
        cfg = T.OPTConfig(vocab_size=160, hidden_size=64, ffn_dim=128,
                          num_hidden_layers=2, num_attention_heads=4,
                          max_position_embeddings=64,
                          do_layer_norm_before=True, dropout=0.0,
                          word_embed_proj_dim=64, **drop)
        model, fwd = T.OPTForCausalLM, opt.forward
    else:
        cfg = T.T5Config(vocab_size=160, d_model=64, d_kv=16, d_ff=128,
                         num_layers=2, num_decoder_layers=2, num_heads=4,
                         dropout_rate=0.0, feed_forward_proj="gated-gelu",
                         tie_word_embeddings=False, decoder_start_token_id=0)
        model = T.T5ForConditionalGeneration

        def fwd(c, p, ids):
            return t5.forward(c, p, ids, ids[:, :7])
    torch.manual_seed(sorted(th._FAMILIES).index(family))
    return cfg, model(cfg).eval(), fwd


FAMILIES = sorted(th._FAMILIES)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _same_tree(port: dict, ref: dict):
    got, want = dict(_flat(port)), dict(_flat(ref))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = _as_numpy(got[path])
        w = np.asarray(w)
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("family", FAMILIES)
def test_converted_params_equal_the_jax_converters_bit_for_bit(family):
    hf_cfg, model, _ = _hf(family)
    sd = model.state_dict()
    cj, ct = jh.config_from_hf(family, hf_cfg), th.config_from_hf(family,
                                                                   hf_cfg)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    _same_tree(th.params_from_hf(family, ct, sd, device="cpu"),
               jh.params_from_hf(family, cj, sd))


def test_bf16_state_dict_converts_to_f32_like_jax():
    hf_cfg, model, _ = _hf("gpt2")
    sd = {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}
    cfg = th.config_from_hf("gpt2", hf_cfg)
    port = th.params_from_hf("gpt2", cfg, sd, device="cpu")
    _same_tree(port, jh.params_from_hf("gpt2", jh.config_from_hf(
        "gpt2", hf_cfg), sd))
    assert port["wte"]["embedding"].dtype == torch.float32


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_transformers(family):
    hf_cfg, model, fwd = _hf(family)
    cfg = th.config_from_hf(family, hf_cfg)
    params = th.params_from_hf(family, cfg, model.state_dict(),
                               device="cpu")
    ids = torch.tensor(np.random.default_rng(1).integers(
        0, min(hf_cfg.vocab_size, 96), (2, 15)))
    with torch.no_grad():
        if family == "t5":
            want = model(input_ids=ids, decoder_input_ids=ids[:, :7]).logits
        else:
            want = model(ids).logits
        got = fwd(cfg, params, ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4,
                               atol=3e-4)


def _write_sharded(tmp_path, sd):
    """Two safetensors shards and an HF-style index, by the port's
    writer."""
    keys = sorted(sd)
    half = len(keys) // 2
    weight_map = {}
    for i, chunk in enumerate((keys[:half], keys[half:])):
        name = f"model-{i + 1:05d}-of-00002.safetensors"
        tsf.save_file({k: sd[k].contiguous() for k in chunk},
                      str(tmp_path / name))
        weight_map.update({k: name for k in chunk})
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_load_hf_checkpoint_from_sharded_safetensors(tmp_path, dtype):
    """A directory of shards written by the port's writer reads back to
    the JAX package's tree (which reads it with the `safetensors`
    package); a bf16 checkpoint stays bf16 in both."""
    hf_cfg, model, fwd = _hf("llama")
    sd = {k: v.to(dtype) for k, v in model.state_dict().items()}
    _write_sharded(tmp_path, sd)
    cj = jh.config_from_hf("llama", hf_cfg)
    ct = th.config_from_hf("llama", hf_cfg)
    port = th.load_hf_checkpoint("llama", ct, str(tmp_path), device="cpu")
    _same_tree(port, jh.load_hf_checkpoint("llama", cj, str(tmp_path)))
    assert port["embed_tokens"]["embedding"].dtype == dtype
    if dtype == torch.float32:
        ids = torch.tensor(np.random.default_rng(8).integers(0, 128, (1, 9)))
        with torch.no_grad():
            want = model(ids).logits
        np.testing.assert_allclose(fwd(ct, port, ids).numpy(),
                                   want.numpy(), rtol=2e-4, atol=2e-4)


def test_load_hf_checkpoint_from_a_bin_file_with_a_cast(tmp_path):
    hf_cfg, model, _ = _hf("opt")
    torch.save(model.state_dict(), tmp_path / "pytorch_model.bin")
    cj = jh.config_from_hf("opt", hf_cfg)
    ct = th.config_from_hf("opt", hf_cfg)
    port = th.load_hf_checkpoint("opt", ct, str(tmp_path),
                                 dtype=torch.bfloat16, device="cpu")
    ref = jh.load_hf_checkpoint("opt", cj, str(tmp_path),
                                dtype=jax.numpy.bfloat16)
    _same_tree(port, jax.tree_util.tree_map(np.asarray, ref))
    # the file alone, and by its name
    assert th.load_hf_checkpoint(
        "opt", ct, str(tmp_path / "pytorch_model.bin"),
        device="cpu")["layers"]["mlp"]["fc1"]["kernel"].dtype == torch.float32


@pytest.mark.parametrize("family,hf_dict,match", [
    ("opt", {"vocab_size": 64, "hidden_size": 32, "ffn_dim": 64,
             "num_hidden_layers": 1, "num_attention_heads": 2,
             "do_layer_norm_before": False}, "post-LN"),
    ("t5", {"vocab_size": 64, "d_model": 32, "d_ff": 64, "num_layers": 1,
            "num_heads": 2, "feed_forward_proj": "gated-silu"},
     "feed_forward_proj"),
    ("mistral", {"vocab_size": 64, "hidden_size": 5120,
                 "intermediate_size": 64, "num_hidden_layers": 1,
                 "num_attention_heads": 32, "head_dim": 128}, "head_dim"),
], ids=["opt_post_ln", "t5_activation", "decoupled_head_dim"])
def test_unsupported_configs_are_refused_like_jax(family, hf_dict, match):
    for mod in (jh, th):
        with pytest.raises(ValueError, match=match):
            mod.config_from_hf(family, hf_dict)


def test_config_corner_cases_match_jax():
    gj = {"vocab_size": 64, "n_embd": 32, "n_layer": 1, "n_head": 2,
          "n_positions": 32, "rotary_dim": None}
    assert th.config_from_hf("gptj", gj).rotary_dim == 16
    qw = {"vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
          "num_hidden_layers": 1, "num_attention_heads": 2,
          "num_key_value_heads": 2, "max_position_embeddings": 128,
          "sliding_window": 16, "use_sliding_window": False}
    for family, d in (("gptj", gj), ("qwen2", qw)):
        assert dataclasses.asdict(th.config_from_hf(family, d)) == \
            dataclasses.asdict(jh.config_from_hf(family, d))
    with pytest.raises(ValueError, match="unknown family"):
        th.params_from_hf("bloom", None, {})


def test_converters_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    hf_cfg, model, _ = _hf("gpt2")
    cfg = th.config_from_hf("gpt2", hf_cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        th.params_from_hf("gpt2", cfg, model.state_dict())
