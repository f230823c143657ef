"""Block-wise int8/int4 weight quantization and per-row int8 quantization
of KV-cache rows (port of `accelerate_tpu/ops/quant.py`).

Weights: symmetric quantization over the last axis in blocks of
`block_size` (a row whose width it does not divide is one block), int8
codes (int4 codes packed two to a byte, low nibble first, an odd width
padded with a zero nibble) and bf16 scales, one per (row..., block).
Codes and scales match the reference bit for bit: the scale is stored as
bf16 of `absmax / qmax`, but the codes divide by the f32 `max(absmax,
1e-12) / qmax`, never by the rounded scale, and rounding is half to even
(`torch.round`, as `np.round` and `jnp.round`). A host tensor (or numpy
array, a memmap of an offload store included) is quantized on the host,
so the card only ever holds the compressed weight; a CUDA tensor on the
card.

`quantized_matmul` is `dequantize` followed by `torch.matmul`: the
reference computes this product outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.dataclasses import QuantizationConfig


class QuantizedTensor:
    """Block-quantized weight: `data` int8 codes (uint8 nibble pairs for
    int4), `scales` bf16 per (row..., block), and the original `shape`
    and `dtype`."""

    def __init__(self, data, scales, bits: int, shape: tuple, dtype):
        self.data = data
        self.scales = scales
        self.bits = bits
        self.shape = tuple(shape)
        self.dtype = dtype

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scales.numel() * self.scales.element_size())

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device=None, non_blocking: bool = False):
        """The same codes and scales on `device`."""
        return QuantizedTensor(
            self.data.to(device, non_blocking=non_blocking),
            self.scales.to(device, non_blocking=non_blocking),
            self.bits, self.shape, self.dtype)

    def __repr__(self) -> str:
        return (f"QuantizedTensor(bits={self.bits}, shape={self.shape}, "
                f"dtype={self.dtype})")


def _pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[-8, 7] int8 codes -> two nibbles per byte along the last axis
    (an odd width gets a zero nibble of padding; unpacking slices it
    off)."""
    u = (codes.to(torch.int16) + 8).to(torch.uint8)
    if u.shape[-1] % 2:
        u = F.pad(u, (0, 1))
    return u[..., 0::2] | (u[..., 1::2] << 4)


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)


def _as_tensor(w) -> torch.Tensor:
    """A tensor as it is; a numpy array (a memmap too) as a host tensor,
    copied (a memmap may be read-only)."""
    if isinstance(w, torch.Tensor):
        return w
    arr = np.array(w)
    if arr.dtype.name == "bfloat16":    # ml_dtypes: the same 16 bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def quantize(w, bits: int = 8, block_size: int = 128) -> QuantizedTensor:
    """Symmetric block-wise quantization of `w` over its last axis, on
    the device `w` lives on (numpy input: on the host)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    w = _as_tensor(w)
    *lead, n = w.shape
    if n % block_size != 0:
        block_size = n     # degenerate: one block per row
    nb = n // block_size
    wf = w.float().reshape(*lead, nb, block_size)
    absmax = wf.abs().amax(dim=-1)
    qmax = 127.0 if bits == 8 else 7.0
    scales = (absmax / qmax).to(torch.bfloat16)
    safe = torch.clamp(absmax, min=1e-12) / qmax
    q = wf / safe[..., None]
    codes = torch.clamp(torch.round(q, out=q), -qmax - 1, qmax,
                        out=q).to(torch.int8).reshape(*lead, n)
    if bits == 4:
        codes = _pack_int4(codes)
    return QuantizedTensor(codes, scales, bits, w.shape, w.dtype)


def dequantize(qt: QuantizedTensor, dtype=None) -> torch.Tensor:
    """The weight back in `dtype` (default its own): codes times their
    block's scale, multiplied in f32."""
    codes = qt.data
    if qt.bits == 4:
        codes = _unpack_int4(codes)[..., :qt.shape[-1]]   # drop the pad
    *lead, n = qt.shape
    nb = qt.scales.shape[-1]
    wf = codes.float().reshape(*lead, nb, n // nb)
    wf = wf * qt.scales[..., None].float()
    return wf.reshape(qt.shape).to(dtype or qt.dtype)


def kv_quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: x [..., D] -> (codes int8
    [..., D], scales bf16 [...]), one scale per (row, head): `quantize`'s
    rule with block_size == D. Per-row scales keep appends independent:
    writing a new row never re-scales its page neighbours, so shared
    (copy-on-write) pages stay bit-stable."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scales = (absmax / 127.0).to(torch.bfloat16)
    safe = torch.clamp(absmax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(xf / safe[..., None]), -128, 127).to(
        torch.int8)
    return codes, scales


def kv_dequantize_rows(codes: torch.Tensor, scales: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of `kv_quantize_rows`: codes [..., D] * scales [...] ->
    [..., D] in `dtype` (the multiply runs in f32)."""
    return (codes.float() * scales.float()[..., None]).to(dtype)


def quantized_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """x @ w with w quantized: dequantized to x's dtype, then one
    `torch.matmul`."""
    return torch.matmul(x, dequantize(qt, dtype=x.dtype))


def _map_leaves(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def should_quantize(name: str, leaf, config: QuantizationConfig) -> bool:
    """A weight matrix (ndim >= 2) whose "/"-joined path holds none of
    `config.skip_modules`."""
    return (getattr(leaf, "ndim", 0) >= 2
            and not any(skip in name for skip in config.skip_modules))


def quantize_params(params: Any,
                    config: QuantizationConfig | None = None) -> Any:
    """Quantize every weight matrix of a nested dict of tensors (see
    `should_quantize`); the rest stays as it is. The reference keeps
    `lm_head` in full precision by default, for output quality."""
    config = config or QuantizationConfig(load_in_8bit=True)
    if config.bits >= 16:
        return params

    def one(path, leaf):
        if not should_quantize("/".join(path), leaf, config):
            return leaf
        return quantize(leaf, bits=config.bits, block_size=config.block_size)

    return _map_leaves(params, one)


def dequantize_params(params: Any, dtype=None) -> Any:
    return _map_leaves(params, lambda _, leaf: dequantize(leaf, dtype=dtype)
                       if isinstance(leaf, QuantizedTensor) else leaf)


def quantized_nbytes(params: Any) -> int:
    """Bytes of a (partly) quantized tree: codes and scales of each
    quantized weight, and every other tensor as it is."""
    total = 0

    def add(_, leaf):
        nonlocal total
        if isinstance(leaf, QuantizedTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
        return leaf

    _map_leaves(params, add)
    return total
