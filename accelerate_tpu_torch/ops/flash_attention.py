"""Flash attention: blockwise attention with an online softmax, fused
forward and FlashAttention-2 backward.

Port of `accelerate_tpu/ops/flash_attention.py`. On a CUDA tensor the
three entry points launch the hand-written Hopper kernels of
`csrc/flash_attention.cu` (or raise):

- `flash_forward`: K1a, output and per-row log-sum-exp;
- `flash_backward_dq`: K1b, dQ and delta = rowsum(dO * O);
- `flash_backward_dkv`: K1c, dK and dV, from that delta;
- `flash_backward` launches the two in turn, from the saved output and
  LSE.

bf16 head dims up to 128 run the `wgmma` kernels; f32, f16 and bf16 head
dims up to 256 run the CUDA-core kernels of the same semantics. Any head
dim whose rows are whole 16-byte pieces (a multiple of 4 in f32, of 8 in
bf16/f16) up to 256 launches a kernel: that covers every head dim the
reference's tests give its kernels.

On a CPU tensor they run `flash_forward_reference` and
`flash_backward_reference`, the plain versions with identical semantics
(dense, one S x S matrix). `flash_attention` wraps them in an autograd
Function with the reference's `[B, S, H, D]` contract.

Layout of the entry points: q, o, dO, dQ are [B, Sq, H, D]; k, v, dK, dV
[B, Sk, H, D], heads already repeated (GQA callers use `repeat_kv`
first); the LSE is [B, H, Sq] f32; a key mask is [B, Sk] (1 = attend).
Causal attention is top-aligned (key visible iff key <= query), as in
the TPU kernel; `flash_attention` sends causal `sq != sk` to the einsum
path, as the reference does. Lengths need not be tile multiples: the
kernels mask ragged tiles themselves, so nothing is padded.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

__all__ = [
    "flash_attention",
    "flash_forward",
    "flash_backward",
    "flash_backward_dq",
    "flash_backward_dkv",
    "flash_forward_reference",
    "flash_backward_reference",
]

# the kernels' dtype codes (csrc/flash_attention.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_D = 256
_ELT = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


def _lib():
    from ..csrc import load

    lib = load("flash_attention")
    if lib.flash_fwd.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [ci] * 7 + [cf, vp]   # B H Sq Sk D causal window, scale, stream
        lib.flash_fwd.argtypes = [ci] + [vp] * 6 + tail
        lib.flash_bwd_dq.argtypes = [ci] + [vp] * 9 + tail
        lib.flash_bwd_dkv.argtypes = [ci] + [vp] * 9 + tail
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = ci
    return lib


def _window(window, sk: int):
    """The kernels' window argument: 0 for none (also for a band as wide
    as the keys, which is plain causal)."""
    return 0 if window is None or window >= sk else int(window)


def _check(tensors: dict, D: int) -> None:
    """Device, dtype, layout and alignment checks before a launch."""
    dev = next(iter(tensors.values())).device
    dtype = None
    for what, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned")
        if what in ("lse", "delta"):
            if t.dtype != torch.float32:
                raise ValueError(f"{what} must be float32")
            continue
        if what == "mask":
            continue
        if dtype is None:
            dtype = t.dtype
        if t.dtype != dtype or t.dtype not in _DTYPE_CODE:
            raise ValueError(
                f"{what} dtype {t.dtype}: the kernels take float32, "
                "bfloat16 or float16, the same for every operand")
    # rows are copied in 16-byte pieces: 4 f32 or 8 bf16/f16 columns
    if (D * _ELT[dtype]) % 16 or not 1 <= D <= _MAX_D:
        raise ValueError(
            f"the kernels take a head_dim up to {_MAX_D} that is a multiple "
            f"of {16 // _ELT[dtype]} in {dtype}; got {D}")


def _key_mask_u8(mask, b: int, sk: int, device):
    if mask is None:
        return None
    if tuple(mask.shape) != (b, sk):
        raise ValueError(f"key mask must be [B, Sk] = {(b, sk)}, got "
                         f"{tuple(mask.shape)}")
    return (mask.to(device) > 0).to(torch.uint8).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_forward(q, k, v, causal: bool = False, mask=None, window=None,
                  save_residuals: bool = False):
    """Attention output [B, Sq, H, D] in q's dtype; with
    `save_residuals`, (output, lse [B, H, Sq] f32) with the LSE pinned to
    0 on rows that see no key.

    A CUDA tensor launches K1a (`flash_forward.launches` counts it); a
    CPU tensor runs `flash_forward_reference`."""
    if q.device.type == "cpu":
        o, lse = flash_forward_reference(q, k, v, causal, mask, window)
        return (o, lse) if save_residuals else o
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    km = _key_mask_u8(mask, B, Sk, q.device)
    tensors = {"q": q, "k": k, "v": v}
    if km is not None:
        tensors["mask"] = km
    _check(tensors, D)
    _check_kv(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _lib().flash_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(km), o.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D,
        int(bool(causal)), _window(window, Sk), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: error {rc}")
    flash_forward.launches += 1
    return (o, lse) if save_residuals else o


flash_forward.launches = 0


def flash_backward(q, k, v, o, lse, do, causal: bool = False, mask=None,
                   window=None):
    """(dq, dk, dv) of `flash_forward` from its output and LSE and the
    output's cotangent `do`, in the inputs' dtype.

    A CUDA tensor launches K1b (`flash_backward_dq`) then K1c
    (`flash_backward_dkv`); a CPU tensor runs `flash_backward_reference`."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, o, lse, do, causal, mask,
                                        window)
    do = do.to(q.dtype).contiguous()
    dq, delta = flash_backward_dq(q, k, v, o, lse, do, causal, mask, window)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, causal, mask,
                                window)
    return dq, dk, dv


def _bwd_setup(q, k, v, do, lse, mask, causal, window, extra: dict):
    """Checks shared by the two backward launches; returns the uint8 key
    mask and the trailing launch arguments."""
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    km = _key_mask_u8(mask, B, Sk, q.device)
    tensors = {"q": q, "k": k, "v": v, "do": do, "lse": lse, **extra}
    if km is not None:
        tensors["mask"] = km
    _check(tensors, D)
    _check_kv(q, k, v)
    if do.shape != q.shape or tuple(lse.shape) != (B, H, Sq):
        raise ValueError("do must be shaped like q, lse [B, H, Sq]")
    args = (B, H, Sq, Sk, D, int(bool(causal)), _window(window, Sk),
            1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    return km, args


def flash_backward_dq(q, k, v, o, lse, do, causal: bool = False, mask=None,
                      window=None):
    """K1b on a CUDA tensor: (dq, delta [B, H, Sq] f32), delta being
    rowsum(dO * O), which `flash_backward_dkv` takes. Counts its launches
    in `flash_backward_dq.launches`."""
    if o.shape != q.shape:
        raise ValueError("o must be shaped like q")
    km, args = _bwd_setup(q, k, v, do, lse, mask, causal, window, {"o": o})
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    rc = _lib().flash_bwd_dq(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), _ptr(km),
        dq.data_ptr(), delta.data_ptr(), *args)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: error {rc}")
    flash_backward_dq.launches += 1
    return dq, delta


flash_backward_dq.launches = 0


def flash_backward_dkv(q, k, v, do, lse, delta, causal: bool = False,
                       mask=None, window=None):
    """K1c on a CUDA tensor: (dk, dv), from the delta that
    `flash_backward_dq` wrote (launch it first, on the same stream).
    Counts its launches in `flash_backward_dkv.launches`."""
    if delta.shape != lse.shape:
        raise ValueError("delta must be shaped like lse")
    km, args = _bwd_setup(q, k, v, do, lse, mask, causal, window,
                          {"delta": delta})
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _lib().flash_bwd_dkv(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(km),
        dk.data_ptr(), dv.data_ptr(), *args)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: error {rc}")
    flash_backward_dkv.launches += 1
    return dk, dv


flash_backward_dkv.launches = 0


def _check_kv(q, k, v):
    B, _, H, D = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[2:] != (H, D) or \
            v.shape != k.shape:
        raise ValueError(
            f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q "
            f"{tuple(q.shape)} as [B, Sk, H, D] (repeat GQA heads first)")


def _keep(sq: int, sk: int, causal: bool, mask, window, device):
    """[B|1, 1, Sq, Sk] visibility: top-aligned causal, the window band
    (key visible iff q - key < window) and the key mask."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    keep = (q_pos >= k_pos if causal
            else torch.ones((sq, sk), dtype=torch.bool, device=device))
    if window is not None and window < sk:
        keep = keep & (q_pos - k_pos < window)
    keep = keep[None, None]
    if mask is not None:
        keep = keep & (mask.to(device) > 0)[:, None, None, :]
    return keep


def flash_forward_reference(q, k, v, causal: bool = False, mask=None,
                            window=None):
    """Plain version of K1a: (o [B, Sq, H, D] in q's dtype, lse
    [B, H, Sq] f32), dense, in f32. P is rounded to the input dtype before
    P.V as in the kernel; rows that see no key give 0 and an LSE of 0."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _keep(q.shape[1], k.shape[1], causal, mask, window, q.device)
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    o = o / l.clamp_min(1e-30).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), 0.0)
    return o.to(q.dtype), lse[..., 0]


def flash_backward_reference(q, k, v, o, lse, do, causal: bool = False,
                             mask=None, window=None):
    """Plain version of K1b and K1c: P recomputed from the LSE, delta =
    rowsum(dO * O), dS = P (dP - delta), with P and dS rounded to the
    input dtype before their products, as in the kernels."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    keep = _keep(q.shape[1], k.shape[1], causal, mask, window, q.device)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta)).to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


class _FlashFn(torch.autograd.Function):
    """Forward saves (q, k, v, o, lse); backward runs `flash_backward`.
    The key mask is data: its cotangent is None (zero)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, window):
        o, lse = flash_forward(q, k, v, causal, mask, window,
                               save_residuals=True)
        ctx.save_for_backward(q, k, v, o, lse, mask)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mask = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.causal, mask,
                                    ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False, mask=None, window=None):
    """[B, S, H, D] flash attention, differentiable, with the reference's
    contract: heads already repeated; `mask` a key-padding mask [B, S_k]
    (or squeezable to it, e.g. [B, 1, 1, S_k]; 1 = attend) applied in the
    kernels, fully masked rows giving zero; `window` a causal sliding
    window (key visible iff q - key < window), wider than S_k meaning
    plain causal. Full per-position masks and causal `sq != sk` take the
    einsum path (`models.common.dot_product_attention`), as in the
    reference."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (sliding-window "
                             "attention is a causal-LM feature)")
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        if window >= sk:
            window = None
    key_mask = None
    if mask is not None:
        m = mask
        while m.ndim > 2 and m.shape[1] == 1:
            m = m[:, 0]
        if m.ndim == 2 and tuple(m.shape) == (b, sk):
            key_mask = m
        else:
            from ..models.common import dot_product_attention

            return dot_product_attention(q, k, v, mask=mask, causal=causal,
                                         window=window)
    if causal and sq != sk:
        from ..models.common import dot_product_attention

        return dot_product_attention(q, k, v, mask=key_mask, causal=causal,
                                     window=window)
    return _FlashFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                          key_mask, causal, window)
