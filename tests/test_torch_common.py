"""The port's shared model functions and KV quantization against the JAX
package's, on the same numpy inputs (f32, atol 1e-5 unless stated)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accelerate_tpu.models import common as jc
from accelerate_tpu.ops.quant import kv_quantize_rows as j_quantize
from accelerate_tpu_torch.models import common as tc
from accelerate_tpu_torch.ops.quant import (
    kv_dequantize_rows as t_dequantize,
    kv_quantize_rows as t_quantize,
)

ATOL = 1e-5
LLAMA3_SCALING = {"rope_type": "llama3", "factor": 8.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 64}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


def test_dense_f32_accumulation_with_bias():
    rng = _rng()
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    _close(tc.dense(torch.tensor(x), torch.tensor(w), torch.tensor(b)),
           jc.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_rms_norm_values_and_promotion(scale_dtype):
    """bf16 x times an f32 scale promotes to f32 in both frameworks; a
    bf16 scale keeps bf16."""
    rng = _rng(1)
    x = rng.normal(size=(3, 4, 32)).astype(np.float32)
    s = rng.normal(size=(32,)).astype(np.float32)
    _close(tc.rms_norm(torch.tensor(x), torch.tensor(s)),
           jc.rms_norm(jnp.asarray(x), jnp.asarray(s)))
    tdt = getattr(torch, scale_dtype)
    out_t = tc.rms_norm(torch.tensor(x).bfloat16(), torch.tensor(s).to(tdt))
    out_j = jc.rms_norm(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(s, getattr(jnp, scale_dtype)))
    assert str(out_t.dtype).replace("torch.", "") == str(out_j.dtype)
    _close(out_t, out_j.astype(jnp.float32), atol=0.0)


@pytest.mark.parametrize("scaling", [None, {"rope_type": "linear",
                                            "factor": 4.0}, LLAMA3_SCALING],
                         ids=["default", "linear", "llama3"])
def test_rope_frequencies_and_apply(scaling):
    cos_t, sin_t = tc.rope_frequencies(32, 128, 500000.0, scaling)
    cos_j, sin_j = jc.rope_frequencies(32, 128, 500000.0, scaling)
    _close(cos_t, cos_j, atol=0.0)
    _close(sin_t, sin_j, atol=0.0)
    rng = _rng(2)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 128, (2, 7)).astype(np.int32)
    _close(tc.apply_rope(torch.tensor(x), cos_t, sin_t, torch.tensor(pos)),
           jc.apply_rope(jnp.asarray(x), cos_j, sin_j, jnp.asarray(pos)))


def test_rope_rejects_unknown_scaling():
    with pytest.raises(ValueError, match="unsupported rope_scaling"):
        tc.rope_frequencies(8, 4, scaling={"rope_type": "yarn"})


def test_repeat_kv():
    x = _rng(3).normal(size=(2, 5, 3, 8)).astype(np.float32)
    _close(tc.repeat_kv(torch.tensor(x), 4),
           jc.repeat_kv(jnp.asarray(x), 4), atol=0.0)


@pytest.mark.parametrize("causal,window,mask_kind", [
    (True, None, None), (True, 3, None), (False, None, "keys"),
    (True, None, "keys"), (False, 4, "full"), (True, 2, "full"),
])
def test_dot_product_attention(causal, window, mask_kind):
    rng = _rng(4)
    q = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    mask = None
    if mask_kind == "keys":
        mask = (rng.random((2, 9)) > 0.3).astype(np.int32)
    elif mask_kind == "full":
        mask = rng.random((2, 6, 9)) > 0.3
    out_t = tc.dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        mask=None if mask is None else torch.tensor(mask), causal=causal,
        window=window)
    out_j = jc.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask), causal=causal,
        window=window)
    _close(out_t, out_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_rows_bit_exact(dtype):
    """Codes and scales equal the reference's bit for bit, including
    all-zero rows (the 1e-12 floor) and exact .5 ties."""
    rng = _rng(5)
    x = rng.normal(size=(3, 7, 2, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[1, 2, 1, :4] = [127.0, 0.5, -0.5, 1.5]
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    codes_t, scales_t = t_quantize(torch.tensor(x).to(tdt))
    codes_j, scales_j = j_quantize(jnp.asarray(x, jdt))
    assert codes_t.dtype == torch.int8 and scales_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(
        scales_t.view(torch.int16).numpy(),
        np.asarray(scales_j).view(np.int16))


def test_kv_dequantize_rows_round_trip():
    x = _rng(6).normal(size=(4, 2, 32)).astype(np.float32)
    codes, scales = t_quantize(torch.tensor(x))
    back = t_dequantize(codes, scales, torch.float32)
    assert back.dtype == torch.float32
    # half a step of absmax / 127 from rounding, plus up to 127 codes
    # times the bf16 scale's relative error (2**-9): under 0.8 steps
    step = np.abs(x).max(-1, keepdims=True) / 127
    assert np.all(np.abs(back.numpy() - x) <= step * 0.8)
