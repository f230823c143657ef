"""The port's block-wise weight quantization (`accelerate_tpu_torch.ops.
quant`) against the JAX package's, on the same numpy inputs.

Codes, int4 nibble packing and bf16 scales are compared bit for bit: the
semantics are integer (round half to even of an f32 quotient, a clip, a
pack) and one bf16 rounding of `absmax / qmax`. Dequantized weights are
compared exactly too (an f32 product of the same bits). The reference's
own cases (tests/test_quant_fp8.py) run against the port with their
tolerances: round-trip error below 2% of the largest weight at int8 and
20% at int4 (25% at an odd width), a quantized product within 5%."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jllama
from accelerate_tpu.ops import quant as jq
from accelerate_tpu.utils.dataclasses import QuantizationConfig as JConfig
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.ops import quant as tq
from accelerate_tpu_torch.utils.dataclasses import QuantizationConfig

CASES = [  # (shape, bits, block_size)
    ((64, 256), 8, 64),
    ((64, 256), 4, 64),
    ((8, 128), 4, 64),
    ((4, 7), 4, 128),       # odd width: one block a row, a pad nibble
    ((4, 7), 8, 128),
    ((16, 32), 8, 16),
    ((3, 5, 130), 8, 128),  # 130 % 128: one block a row
    ((3, 5, 130), 4, 128),
    ((2, 3, 96), 4, 32),
    ((1, 1), 8, 128),
]


def _scale_bits(scales) -> np.ndarray:
    if isinstance(scales, torch.Tensor):
        return scales.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(scales).view(np.uint16)


def _weights(shape, seed):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    w.reshape(-1)[:3] = 0.0          # an all-zero start of a block
    w.reshape(-1)[-1] = 1e-30        # a tiny block max
    return w


@pytest.mark.parametrize("shape,bits,block", CASES)
@pytest.mark.parametrize("source", ["device", "numpy"])
def test_quantize_matches_reference_bit_for_bit(shape, bits, block, source):
    w = _weights(shape, 7)
    if source == "numpy":    # the reference's host path (an offload memmap)
        ref = jq.quantize(w, bits=bits, block_size=block)
        got = tq.quantize(w, bits=bits, block_size=block)
    else:
        ref = jq.quantize(jnp.asarray(w), bits=bits, block_size=block)
        got = tq.quantize(torch.from_numpy(w), bits=bits, block_size=block)
    assert got.data.dtype == (torch.uint8 if bits == 4 else torch.int8)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(_scale_bits(got.scales),
                                  _scale_bits(ref.scales))
    assert got.shape == tuple(shape) and got.bits == bits
    np.testing.assert_array_equal(tq.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(ref)))


@pytest.mark.parametrize("width", [1, 2, 7, 8, 31])
def test_int4_packing_matches_reference(width):
    codes = np.random.default_rng(width).integers(
        -8, 8, (3, width)).astype(np.int8)
    packed = tq._pack_int4(torch.from_numpy(codes))
    ref = np.asarray(jq._pack_int4(jnp.asarray(codes)))
    np.testing.assert_array_equal(packed.numpy(), ref)
    np.testing.assert_array_equal(
        tq._unpack_int4(packed)[..., :width].numpy(), codes)


def test_quantize_keeps_a_bf16_source_bit_exact():
    w = _weights((32, 64), 3)
    w16 = torch.from_numpy(w).to(torch.bfloat16)
    ref = jq.quantize(jnp.asarray(w16.float().numpy()).astype(jnp.bfloat16),
                      bits=8, block_size=32)
    got = tq.quantize(w16, bits=8, block_size=32)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(_scale_bits(got.scales),
                                  _scale_bits(ref.scales))
    assert got.dtype == torch.bfloat16
    assert tq.dequantize(got).dtype == torch.bfloat16


def test_rejects_other_bit_widths():
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        tq.quantize(torch.ones(4, 8), bits=2)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_roundtrip_error_bounded(bits):
    w = torch.from_numpy(_weights((64, 256), 0))
    back = tq.dequantize(tq.quantize(w, bits=bits, block_size=64))
    rel = float((back - w).abs().max() / w.abs().max())
    assert rel < (0.02 if bits == 8 else 0.2), rel


def test_quantize_int4_packs_nibbles():
    w = torch.from_numpy(_weights((8, 128), 1))
    qt = tq.quantize(w, bits=4, block_size=64)
    assert qt.data.shape == (8, 64)
    assert qt.nbytes < w.numel() * 4 / 3.5


def test_quantize_int4_odd_width_roundtrip():
    w = torch.from_numpy(_weights((4, 7), 5))
    back = tq.dequantize(tq.quantize(w, bits=4))
    assert back.shape == w.shape
    assert float((back - w).abs().max() / w.abs().max()) < 0.25


def test_quantize_numpy_host_side():
    w = _weights((16, 32), 0)
    qt = tq.quantize(w, bits=8, block_size=16)
    assert qt.data.device.type == "cpu" and qt.device.type == "cpu"
    back = tq.dequantize(qt).numpy()
    assert float(np.abs(back - w).max() / np.abs(w).max()) < 0.02


def test_quantized_matmul_matches_reference():
    x = np.random.default_rng(2).normal(size=(4, 64)).astype(np.float32)
    w = _weights((64, 32), 3)
    ref = np.asarray(jq.quantized_matmul(
        jnp.asarray(x), jq.quantize(jnp.asarray(w), bits=8, block_size=32)))
    got = tq.quantized_matmul(torch.from_numpy(x),
                              tq.quantize(torch.from_numpy(w), bits=8,
                                          block_size=32)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert float(np.abs(got - x @ w).max() / np.abs(x @ w).max()) < 0.05


def _tree():
    cfg = jllama.LlamaConfig.tiny()
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(cfg, jax.random.key(0)))
    return tree, params_from_numpy(tree, device="cpu")


def _paths(tree, cls, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, cls, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


@pytest.mark.parametrize("bits,skip", [
    (8, ("lm_head",)), (4, ("lm_head",)), (8, ()), (4, ("mlp", "embed")),
])
def test_quantize_params_quantizes_the_same_leaves(bits, skip):
    jtree, ttree = _tree()
    jcfg = JConfig(load_in_8bit=bits == 8, load_in_4bit=bits == 4,
                   block_size=32, skip_modules=skip)
    tcfg = QuantizationConfig(load_in_8bit=bits == 8,
                              load_in_4bit=bits == 4, block_size=32,
                              skip_modules=skip)
    jq_tree = jq.quantize_params(jtree, jcfg)
    tq_tree = tq.quantize_params(ttree, tcfg)
    jleaves = _paths(jq_tree, jq.QuantizedTensor)
    tleaves = _paths(tq_tree, tq.QuantizedTensor)
    assert jleaves.keys() == tleaves.keys()
    quantized = {k for k, v in jleaves.items()
                 if isinstance(v, jq.QuantizedTensor)}
    assert quantized == {k for k, v in tleaves.items()
                         if isinstance(v, tq.QuantizedTensor)}
    assert quantized
    for k in quantized:
        np.testing.assert_array_equal(tleaves[k].data.numpy(),
                                      np.asarray(jleaves[k].data))
        np.testing.assert_array_equal(_scale_bits(tleaves[k].scales),
                                      _scale_bits(jleaves[k].scales))
    assert tq.quantized_nbytes(tq_tree) == jq.quantized_nbytes(jq_tree)
    back = _paths(tq.dequantize_params(tq_tree), None)
    jback = _paths(jq.dequantize_params(jq_tree), None)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jback[k]))


def test_quantize_params_at_16_bits_is_the_identity():
    _, ttree = _tree()
    assert tq.quantize_params(ttree, QuantizationConfig()) is ttree
    assert QuantizationConfig(load_in_4bit=True).bits == 4


def test_quantized_tensor_moves_as_one():
    qt = tq.quantize(torch.ones(4, 8), bits=8)
    moved = qt.to("cpu")
    assert isinstance(moved, tq.QuantizedTensor)
    assert moved.shape == (4, 8) and moved.bits == 8
    assert "bits=8" in repr(moved)
