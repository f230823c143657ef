"""Ring attention: sequence (context) parallelism over a mesh's `seq`
axis (port of `accelerate_tpu/parallel/ring_attention.py`).

Each rank of the `seq` line holds one sequence chunk of Q, K and V. The
K/V chunks rotate around the line (`utils.operations.axis_ppermute`,
one rank on a step) while each rank folds its chunk outputs by their
log-sum-exp, so no rank ever holds the S x S scores.

Compute: every ring step runs the flash kernels through their entry
points (`ops/flash_attention.py`). The forward's step 0 is the diagonal
chunk, causal (K1a with `save_residuals=True`); each later step is one
non-causal K1a on the chunk pair, and under `causal` a chunk from a
later rank (src > my) is skipped with no launch. The backward is the
ring form of FlashAttention-2: K1b (dQ and delta = rowsum(dO * O)) and
K1c (dK, dV) run on each chunk pair against the GLOBAL output and
log-sum-exp, dQ accumulates in f32 on its rank, and the f32 dK/dV
accumulators ride the ring with K/V until one last rotation brings them
home.

GQA: K/V ring un-repeated (kv heads only); heads repeat per chunk right
before the kernel, and dK/dV are summed back over the repeat groups.

Masks: a [B, S] key-padding mask rotates with its K/V chunk. A batch
row whose chunk is fully masked folds as -inf (the kernel pins such a
row's LSE to 0), and the final LSE of a row that saw no key anywhere is
pinned back to 0, the kernel's own convention, so the backward computes
exp(-inf) = 0 there.

Every unwindowed ring runs the kernels whatever the chunk length: the
port's kernels mask ragged tiles themselves. The reference's rule that a
chunk under one 16-row block takes the einsum ring is a TPU tiling limit
and does not carry over. A `window` (Mistral's sliding band) runs the
einsum ring, the same schedule on plain-torch chunk functions with exact
global-position banding, because the kernels take no cross-chunk band
offsets, as in the reference.

Layout (the port's SPMD contract): the caller on a `seq` line passes the
whole [B, S, H, D] tensors, the same on every rank of the line, as the
reference's callers pass global arrays to its `shard_map`. Each rank
takes its chunk, runs the ring, and all-gathers the output along the
line, so every rank returns the whole output. The backward is the
transpose: each rank's chunk gradients are all-gathered, so a
replicated input gets its full gradient on every rank. Each schedule is
one `torch.autograd.Function`, so every rank makes the same collectives
in the same order whichever chunks it skips.
"""

from __future__ import annotations

import math

import torch

from ..models.common import repeat_kv
from ..ops.flash_attention import (
    flash_attention,
    flash_backward,
    flash_backward_reference,
    flash_forward,
    flash_forward_reference,
)
from ..state import line_group, mesh_or_state
from ..utils import operations as ops
from ..utils.constants import AXIS_SEQ

__all__ = ["ring_attention"]

NEG_INF = -1e30


def _kernel_fwd(q, k, v, causal, mask):
    return flash_forward(q, k, v, causal, mask, save_residuals=True)


def _kernel_bwd(q, k, v, o, lse, do, causal, mask):
    return flash_backward(q, k, v, o, lse, do, causal, mask)


# the chunk functions of the kernel ring: the flash entry points (K1a;
# K1b then K1c), and their plain versions, which the card checks hold
# the ring against
KERNELS = (_kernel_fwd, _kernel_bwd)
PLAIN = (flash_forward_reference, flash_backward_reference)


def _repeated(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """kv heads repeated for the kernels, which take contiguous rows (one
    kv head repeated is a view with a zero stride)."""
    return repeat_kv(x, n_rep).contiguous()


def _reduce_heads(full: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Gradients [B, S, H, D] summed over the repeat groups back to the
    kv heads, in f32."""
    full = full.float()
    if n_rep == 1:
        return full
    b, s, h, d = full.shape
    return full.reshape(b, s, h // n_rep, n_rep, d).sum(dim=3)


def _fold(out, lse, o_i, lse_i):
    """Streaming log-sum-exp combine of per-chunk normalised outputs:
    out [B, S, H, D] f32, lse [B, H, S] f32."""
    new_lse = torch.logaddexp(lse, lse_i)
    safe = new_lse.clamp_min(NEG_INF / 2)
    w_old = torch.exp(lse - safe).permute(0, 2, 1)[..., None]
    w_new = torch.exp(lse_i - safe).permute(0, 2, 1)[..., None]
    return out * w_old + o_i.float() * w_new, new_lse


class _Line:
    """A rank's place on the `seq` line and the chunk functions of the
    schedule it runs."""

    def __init__(self, group, causal: bool, n_rep: int, window=None,
                 kernels=None):
        self.group = group
        self.n = torch.distributed.get_world_size(group)
        self.my = torch.distributed.get_rank(group)
        self.causal, self.n_rep, self.window = causal, n_rep, window
        self.kernels = KERNELS if kernels is None else kernels

    def visible(self, src: int, s_local: int) -> bool:
        """Whether the chunk from rank `src` has any visible pair for
        this rank's queries (a dead chunk is skipped, no launch)."""
        if self.causal and src > self.my:
            return False
        if self.window is not None:
            # the closest pair is (my - src) * s - (s - 1) apart
            return (self.my - src) * s_local < self.window + s_local - 1
        return True

    def rotate(self, t):
        return ops.axis_ppermute(t, self.group, 1, recv_like=t)

    # -- the chunk functions ------------------------------------------------

    def chunk_fwd(self, q, k, v, mask, src):
        """(o, lse [B, H, s] f32) of this rank's queries against the K/V
        chunk of rank `src` (heads repeated here); a row with nothing
        visible has lse = -inf for the fold."""
        k, v = _repeated(k, self.n_rep), _repeated(v, self.n_rep)
        if self.window is not None:
            return _einsum_chunk_fwd(q, k, v, self._offsets(q, src),
                                     self.causal, self.window, mask)
        o, lse = self.kernels[0](q, k, v, self.causal and src == self.my,
                                 mask)
        if mask is not None:
            # the kernel zeroes a fully masked row's output and pins its
            # lse to 0; the fold must see it as no contribution
            any_key = (mask > 0).any(dim=-1)
            lse = torch.where(any_key[:, None, None], lse, NEG_INF)
        return o, lse

    def chunk_bwd(self, q, k, v, o, lse, do, mask, src):
        """(dq, dk, dv) of one chunk pair against the global output and
        lse; dk/dv summed back to the kv heads, all in f32."""
        kr, vr = _repeated(k, self.n_rep), _repeated(v, self.n_rep)
        if self.window is not None:
            dq, dk, dv = _einsum_chunk_bwd(q, kr, vr, o, lse, do,
                                           self._offsets(q, src),
                                           self.causal, self.window, mask)
        else:
            dq, dk, dv = self.kernels[1](q, kr, vr, o, lse, do,
                                         self.causal and src == self.my,
                                         mask)
        return (dq.float(), _reduce_heads(dk, self.n_rep),
                _reduce_heads(dv, self.n_rep))

    def _offsets(self, q, src):
        s = q.shape[1]
        return self.my * s, src * s


def _ring_forward(line: _Line, q, k, v, mask):
    """This rank's (output chunk in q's dtype, global lse [B, H, s] f32)
    from its chunks q [B, s, H, D], k/v [B, s, Hkv, D] and key mask
    [B, s] (or None)."""
    s = q.shape[1]
    o0, lse = line.chunk_fwd(q, k, v, mask, line.my)
    out = o0.float()
    kv, m_cur = torch.stack([k, v]), mask
    for t in range(1, line.n):
        kv = line.rotate(kv)
        if m_cur is not None:
            m_cur = line.rotate(m_cur)
        src = (line.my - t) % line.n
        if not line.visible(src, s):
            continue
        o_i, lse_i = line.chunk_fwd(q, kv[0], kv[1], m_cur, src)
        out, lse = _fold(out, lse, o_i, lse_i)
    # rows that saw no key anywhere folded to -inf: pin them to 0, the
    # kernel's convention, so the backward's exp(s - lse) is 0 there
    lse = torch.where(lse <= NEG_INF / 2, torch.zeros_like(lse), lse)
    return out.to(q.dtype), lse.contiguous()


def _ring_backward(line: _Line, q, k, v, o, lse, do, mask):
    """This rank's (dq, dk, dv) chunks: dQ accumulated here, the dK/dV
    accumulators riding the ring in f32 and one last rotation bringing
    them home."""
    s = q.shape[1]
    dq, dk, dv = line.chunk_bwd(q, k, v, o, lse, do, mask, line.my)
    dkv = torch.stack([dk, dv])
    kv, m_cur = torch.stack([k, v]), mask
    for t in range(1, line.n):
        kv = line.rotate(kv)
        if m_cur is not None:
            m_cur = line.rotate(m_cur)
        dkv = line.rotate(dkv)
        src = (line.my - t) % line.n
        if not line.visible(src, s):
            continue
        dq_i, dk_i, dv_i = line.chunk_bwd(q, kv[0], kv[1], o, lse, do,
                                          m_cur, src)
        dq = dq + dq_i
        dkv = dkv + torch.stack([dk_i, dv_i])
    if line.n > 1:
        dkv = line.rotate(dkv)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


def _chunks(line: _Line, *tensors):
    s = tensors[0].shape[1] // line.n
    lo = line.my * s
    return [None if t is None else t[:, lo:lo + s].contiguous()
            for t in tensors]


class _Ring(torch.autograd.Function):
    """The whole ring, from the replicated inputs to the replicated
    output; the backward runs the ring backward and all-gathers each
    chunk gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, line):
        qc, kc, vc, mc = _chunks(line, q, k, v, mask)
        out_c, lse = _ring_forward(line, qc, kc, vc, mc)
        ctx.save_for_backward(qc, kc, vc, out_c, lse, mc)
        ctx.line = line
        return ops.axis_all_gather(out_c, 1, line.group)

    @staticmethod
    def backward(ctx, dout):
        qc, kc, vc, out_c, lse, mc = ctx.saved_tensors
        line = ctx.line
        (do_c,) = _chunks(line, dout)
        dq, dk, dv = _ring_backward(line, qc, kc, vc, out_c, lse,
                                    do_c.to(qc.dtype), mc)
        gather = [ops.axis_all_gather(g, 1, line.group)
                  for g in (dq, dk, dv)]
        return (*gather, None, None)


# -- the einsum ring's chunk functions (windowed calls) -----------------------


def _band(offsets, sq, sk, causal, window, mask, device):
    """[B|1, 1, sq, sk] visibility at GLOBAL positions: the query chunk
    starts at offsets[0], the key chunk at offsets[1]."""
    q_pos = offsets[0] + torch.arange(sq, device=device)[:, None]
    k_pos = offsets[1] + torch.arange(sk, device=device)[None, :]
    keep = (q_pos >= k_pos) if causal else \
        torch.ones((sq, sk), dtype=torch.bool, device=device)
    if window is not None:
        keep = keep & (q_pos - k_pos < window)
    keep = keep[None, None]
    if mask is not None:
        keep = keep & (mask > 0)[:, None, None, :]
    return keep


def _einsum_chunk_fwd(q, k, v, offsets, causal, window, mask):
    """One chunk pair of the einsum ring in f32: (o, lse), lse = -inf on
    a row with nothing visible."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _band(offsets, q.shape[1], k.shape[1], causal, window, mask,
                 q.device)
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / l.clamp_min(1e-30).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), NEG_INF)
    return o, lse[..., 0]


def _einsum_chunk_bwd(q, k, v, o, lse, do, offsets, causal, window, mask):
    """(dq, dk, dv) in f32 of one chunk pair against the global output
    and lse: P = exp(S - lse) on the visible pairs."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    keep = _band(offsets, q.shape[1], k.shape[1], causal, window, mask,
                 q.device)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq, dk, dv


# -- the entry point ---------------------------------------------------------


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, mask: torch.Tensor | None = None,
                   mesh=None, axis_name: str = AXIS_SEQ,
                   window: int | None = None) -> torch.Tensor:
    """[B, S, H, D] attention with S split over the mesh's `seq` axis
    (`mesh` defaults to the process state's).

    Falls back to one process's attention when the mesh has no such
    axis above 1, or when S does not divide over it (e.g. the S-1 tokens
    of a causal-LM loss), as the reference does: `flash_attention`, the
    kernels on the card and their plain versions on the CPU. K/V may carry fewer heads (GQA): they ring un-repeated.
    `mask` is a [B, S] key-padding mask (1 = attend) whose chunks rotate
    with K/V, so padded batches keep the kernel ring. `window` is
    Mistral's sliding window (keys visible iff q - key < window; needs
    `causal=True`), which runs the einsum ring. Every rank of the line
    passes the same whole tensors and gets the whole output (see the
    module docstring)."""
    if window is not None and not causal:
        # validated before the off-mesh fallback, so a one-process run
        # fails the same way as a ring does
        raise ValueError("ring_attention window requires causal=True "
                         "(Mistral sliding-window semantics)")
    mesh = mesh_or_state(mesh)
    n_rep = q.shape[2] // k.shape[2]
    if (mesh is None or axis_name not in mesh.axis_names
            or mesh.shape[axis_name] == 1
            or q.shape[1] % mesh.shape[axis_name] != 0
            or k.shape[1] % mesh.shape[axis_name] != 0):
        return flash_attention(q, _repeated(k, n_rep), _repeated(v, n_rep),
                               causal=causal, mask=mask, window=window)
    if mask is not None and tuple(mask.shape) != (q.shape[0], k.shape[1]):
        raise ValueError(
            f"ring_attention mask must be a [B, S_k] key-padding mask; got "
            f"{tuple(mask.shape)} for B={q.shape[0]}, S_k={k.shape[1]}")
    line = _Line(line_group(mesh, axis_name, "ring_attention"), causal,
                 n_rep, window)
    if mask is not None:
        mask = (mask > 0).to(torch.uint8)
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                       line)
