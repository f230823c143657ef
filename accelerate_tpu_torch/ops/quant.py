"""Per-row int8 quantization of KV-cache rows (port of the KV half of
`accelerate_tpu/ops/quant.py`). Codes and scales match the reference bit
for bit: both round half to even, and both divide by the f32
`max(absmax, 1e-12) / 127`."""

from __future__ import annotations

import torch


def kv_quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: x [..., D] -> (codes int8
    [..., D], scales bf16 [...]), one scale per (row, head). Per-row
    scales keep appends independent: writing a new row never re-scales
    its page neighbours, so shared (copy-on-write) pages stay bit-stable."""
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
