"""fp8 training: E4M3 forward with delayed scaling, E5M2 backward with
current scaling (port of `accelerate_tpu/ops/fp8.py`).

The recipe is the reference's (transformer-engine's): every projection
casts its input and its weight to float8_e4m3fn with per-tensor scales
taken from a rolling window of past amaxes (`Fp8Meta`, threaded through
the train step like optimizer state), multiplies them with f32
accumulation, and divides by the scales. The backward casts the incoming
gradient to float8_e5m2 with a scale from its own amax, so no gradient
state crosses steps. A cast is `clip(t.float() * scale, +-max)` and then
the round-to-nearest-even conversion, as the reference's `_cast8`.

Across processes every amax is the global batch's, as the reference's
`jnp.max` over a batch sharded by GSPMD: the backward's gradient amax
is the max across processes before its scale is taken, and
`all_reduce_metas_` makes each step's new windows and scales the
global batch's, so every process holds the same metas.

The products. The reference's is `jnp.dot` on fp8 operands outside any
Pallas kernel, so its counterpart here is a library GEMM: on a CUDA
tensor `fp8_gemm` calls `torch._scaled_mm` (cuBLASLt's fp8 GEMM on
Hopper's tensor cores, 1,979 TFLOP/s dense on an H100 SXM) with the
reciprocal scales as f32 device tensors (no host sync) and
`use_fast_accum=False`, which keeps the reference's f32 accumulation.
It runs `_scaled_mm` inside an op of the port's own
(`SCALED_MM_OP`), which is what remat "dots" saves, and which counts
its launches by product in `fp8_gemm.launches`: a recompute served from
the saved output launches nothing and counts nothing. On a CPU
tensor it runs `fp8_gemm_reference`: the fp8 operands upcast to f32,
multiplied, divided by the scale product and cast, as the reference.

`_scaled_mm` takes both operands contiguous along the contracted
dimension (A row-major, B column-major), never e5m2 by e5m2, and the
contracted and output dimensions in multiples of 16. So `fp8_gemm`
takes `a [M, K]` and `b_t [N, K]`, both K-contiguous, and pads K and N
with zeros (exact) where they are not multiples of 16, slicing the
padded columns off. The three products of a projection `x [T, D] @ w
[D, O]` get their operands in that layout:

- forward `x8 @ w8`: x8 as cast; w8 transposed to `[O, D]`;
- dX `g8 @ w8ᵀ`: g8 as cast; w8 in w's own `[D, O]` layout;
- dW `x8ᵀ @ g8`: x8 and g8 transposed to `[D, T]` and `[O, T]`.

Each transpose is one pass over 1-byte elements. The casts, amaxes and
transposes are plain PyTorch ops.
"""

from __future__ import annotations

import contextlib
import contextvars

from typing import Any, NamedTuple

import torch

from ..device import resolve_device
from ..utils.dataclasses import FP8RecipeKwargs

__all__ = [
    "E4M3_MAX",
    "E5M2_MAX",
    "Fp8Meta",
    "update_meta",
    "fp8_cast",
    "fp8_dot",
    "fp8_gemm",
    "fp8_gemm_reference",
    "fp8_dense",
    "fp8_expert_dense",
    "fp8_state_history_len",
    "adapt_history_len",
    "resolve_history_len",
    "stacked_fp8_metas",
    "init_fp8_state",
    "all_reduce_metas_",
]

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


class Fp8Meta(NamedTuple):
    """Delayed-scaling state of one tensor role (x or w): the multiplier
    applied before the cast, and the rolling window of raw amaxes (index
    0 the newest)."""

    scale: torch.Tensor
    amax_history: torch.Tensor

    @classmethod
    def init(cls, history_len: int = 16, device=None) -> "Fp8Meta":
        """Scale 1, an empty window, on `device` (CUDA unless "cpu")."""
        dev = resolve_device(device)
        return cls(
            scale=torch.ones((), dtype=torch.float32, device=dev),
            amax_history=torch.zeros((history_len,), dtype=torch.float32,
                                     device=dev),
        )


def _fmt(fmt: str) -> tuple[torch.dtype, float]:
    if fmt.upper() == "E4M3":
        return torch.float8_e4m3fn, E4M3_MAX
    return torch.float8_e5m2, E5M2_MAX


def _ratio(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den in f32 where den > 0, else 1. A true division of two
    tensors: `num / tensor` would take the reciprocal and multiply, one
    rounding more than the reference's."""
    return torch.where(den > 0.0, torch.full_like(den, num) / den,
                       torch.ones_like(den))


def update_meta(meta: Fp8Meta, amax, fmt: str = "E4M3",
                margin: int = 0) -> Fp8Meta:
    """Roll the window, put `amax` first, and derive the next step's
    scale from the window's max (transformer-engine's delayed scaling)."""
    hist = meta.amax_history
    amax = torch.as_tensor(amax, dtype=torch.float32, device=hist.device)
    rolled = torch.roll(hist, 1)
    first = amax.reshape((1,) * hist.ndim).expand(1, *hist.shape[1:])
    history = torch.cat([first, rolled[1:]])
    scale = _ratio(_fmt(fmt)[1] / (2.0 ** margin), history.max())
    return Fp8Meta(scale=scale, amax_history=history)


def _cast8(t: torch.Tensor, scale: torch.Tensor, dtype,
           fmax: float) -> torch.Tensor:
    return torch.clamp(t.float() * scale, -fmax, fmax).to(dtype)


def fp8_cast(x: torch.Tensor, meta: Fp8Meta, fmt: str = "E4M3"):
    """`x` scaled by the meta's current scale, clipped and cast to fp8."""
    dtype, fmax = _fmt(fmt)
    return _cast8(x, meta.scale, dtype, fmax)


def _amax(t: torch.Tensor) -> torch.Tensor:
    return t.detach().abs().amax().float()


def _transposed(t8: torch.Tensor) -> torch.Tensor:
    """A 2-D fp8 tensor transposed into a contiguous one (through uint8:
    one byte-copy pass)."""
    return t8.view(torch.uint8).t().contiguous().view(t8.dtype)


def _padded(t8: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """A 2-D fp8 tensor inside a zero [rows, cols] one (fp8 zero is byte
    0 in both formats); itself when it already has that shape."""
    if tuple(t8.shape) == (rows, cols):
        return t8
    out = torch.zeros((rows, cols), dtype=torch.uint8, device=t8.device)
    out[:t8.shape[0], :t8.shape[1]] = t8.view(torch.uint8)
    return out.view(t8.dtype)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def fp8_gemm_reference(a: torch.Tensor, b_t: torch.Tensor,
                       a_scale: torch.Tensor, b_scale: torch.Tensor,
                       out_dtype) -> torch.Tensor:
    """The plain version of `fp8_gemm`: the operands upcast (exactly) to
    f32, multiplied, divided by the scale product and cast."""
    out = a.float() @ b_t.float().t()
    return (out / (a_scale * b_scale)).to(out_dtype)


@torch.library.custom_op(
    "accelerate_tpu_torch::fp8_scaled_mm", mutates_args=(),
    schema="(Tensor a, Tensor b, Tensor scale_a, Tensor scale_b, "
           "ScalarType out_dtype, str role) -> Tensor")
def _fp8_scaled_mm(a: torch.Tensor, b: torch.Tensor, scale_a: torch.Tensor,
                   scale_b: torch.Tensor, out_dtype: torch.dtype,
                   role: str) -> torch.Tensor:
    """`torch._scaled_mm` with f32 accumulation, as one op that remat
    "dots" can save and that counts the launches that run."""
    fp8_gemm.launches[role] += 1
    return torch._scaled_mm(a, b, scale_a=scale_a, scale_b=scale_b,
                            out_dtype=out_dtype, use_fast_accum=False)


SCALED_MM_OP = torch.ops.accelerate_tpu_torch.fp8_scaled_mm.default


def _scaled_gemm(a, b_t, a_scale, b_scale, out_dtype, role="fwd", mm=None):
    """`fp8_gemm` on the card: `_scaled_mm` with K and N padded to
    multiples of 16 (`mm(a, b, scale_a, scale_b, out_dtype)` stands in
    for the op in the CPU tests of the padding). e5m2 by e5m2, which
    `_scaled_mm` refuses, multiplies the operands upcast to f16 (exact)
    with f32 accumulation."""
    M, K = a.shape
    N = b_t.shape[0]
    if a.dtype == b_t.dtype == torch.float8_e5m2:
        fp8_gemm.launches[role] += 1
        out = torch.mm(a.half(), b_t.half().t(), out_dtype=torch.float32)
        return (out / (a_scale * b_scale)).to(out_dtype)
    kp, np_ = _round16(K), _round16(N)
    a = _padded(a.contiguous(), M, kp)
    b_t = _padded(b_t.contiguous(), np_, kp)
    sa = torch.reciprocal(a_scale.float())
    sb = torch.reciprocal(b_scale.float())
    if mm is None:
        out = _fp8_scaled_mm(a, b_t.t(), sa, sb, out_dtype, role)
    else:
        out = mm(a, b_t.t(), sa, sb, out_dtype)
    return out[:, :N] if np_ != N else out


def fp8_gemm(a: torch.Tensor, b_t: torch.Tensor, a_scale: torch.Tensor,
             b_scale: torch.Tensor, out_dtype, role: str = "fwd"
             ) -> torch.Tensor:
    """`a [M, K] @ b_t [N, K]ᵀ` of fp8 operands with f32 accumulation,
    divided by `a_scale * b_scale` and cast to `out_dtype`: [M, N]. On a
    CUDA tensor `torch._scaled_mm` (each launch adds one to
    `fp8_gemm.launches[role]`, role "fwd", "dx" or "dw"); on a CPU
    tensor `fp8_gemm_reference`."""
    if a.is_cuda:
        return _scaled_gemm(a, b_t, a_scale, b_scale, out_dtype, role)
    return fp8_gemm_reference(a, b_t, a_scale, b_scale, out_dtype)


fp8_gemm.launches = {"fwd": 0, "dx": 0, "dw": 0}


def fp8_dot(x: torch.Tensor, w: torch.Tensor, x_meta: Fp8Meta,
            w_meta: Fp8Meta, out_dtype=torch.bfloat16, fmt: str = "E4M3",
            margin: int = 0) -> tuple[torch.Tensor, Fp8Meta, Fp8Meta]:
    """x [..., D] @ w [D, O] in fp8 with per-tensor delayed scaling.
    Returns (out, new_x_meta, new_w_meta); thread the metas through the
    train step as optimizer state."""
    x8 = fp8_cast(x, x_meta, fmt).reshape(-1, x.shape[-1])
    w8 = fp8_cast(w, w_meta, fmt)
    out = fp8_gemm(x8, _transposed(w8), x_meta.scale, w_meta.scale,
                   out_dtype, "fwd").reshape(*x.shape[:-1], w.shape[-1])
    with torch.no_grad():
        x_meta = update_meta(x_meta, _amax(x), fmt, margin)
        w_meta = update_meta(w_meta, _amax(w), fmt, margin)
    return out, x_meta, w_meta


# whether a backward's E5M2 gradient scale takes the max across
# processes (the global batch's, under data parallelism) or this
# process's own amax (`local_grad_scales`)
_GRAD_AMAX_ACROSS_PROCESSES = contextvars.ContextVar(
    "fp8_grad_amax_across_processes", default=True)


@contextlib.contextmanager
def local_grad_scales():
    """Products made inside take their backward's E5M2 gradient scale
    from this process's own gradient amax. The expert-parallel dispatch
    runs its experts so: an expert's rows from every rank meet on its
    owner, so its own amax is the one the reference's `shard_map`
    computes, and the ranks' experts differ."""
    token = _GRAD_AMAX_ACROSS_PROCESSES.set(False)
    try:
        yield
    finally:
        _GRAD_AMAX_ACROSS_PROCESSES.reset(token)


class _Fp8Matmul(torch.autograd.Function):
    """x [..., D] @ w [D, O]: E4M3 forward with the given delayed scales,
    bf16 out; E5M2 backward with the gradient's scale from its own amax
    (the max across processes, unless made under
    `local_grad_scales`). dX and dW take the primals' dtypes (f32
    primals get f32 gradients)."""

    @staticmethod
    def forward(ctx, x, w, x_scale, w_scale):
        ctx.across = _GRAD_AMAX_ACROSS_PROCESSES.get()
        x8 = _cast8(x.reshape(-1, x.shape[-1]), x_scale,
                    torch.float8_e4m3fn, E4M3_MAX)
        w8 = _cast8(w, w_scale, torch.float8_e4m3fn, E4M3_MAX)
        out = fp8_gemm(x8, _transposed(w8), x_scale, w_scale,
                       torch.bfloat16, "fwd")
        ctx.save_for_backward(x8, w8, x_scale, w_scale)
        ctx.shapes = (x.shape, x.dtype, w.dtype)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        from ..utils.operations import all_reduce_max_

        x8, w8, x_scale, w_scale = ctx.saved_tensors
        x_shape, x_dtype, w_dtype = ctx.shapes
        g2 = g.reshape(-1, g.shape[-1])
        g_amax = _amax(g2)
        if ctx.across:
            all_reduce_max_([g_amax])
        g_scale = _ratio(E5M2_MAX, g_amax)
        g8 = _cast8(g2, g_scale, torch.float8_e5m2, E5M2_MAX)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = fp8_gemm(g8, w8, g_scale, w_scale, x_dtype,
                          "dx").reshape(x_shape)
        if ctx.needs_input_grad[1]:
            dw = fp8_gemm(_transposed(x8), _transposed(g8), x_scale,
                          g_scale, w_dtype, "dw")
        return dx, dw, None, None


def _new_metas(meta: dict, x, kernel, margin: int) -> dict:
    with torch.no_grad():
        return {"x": update_meta(meta["x"], _amax(x), "E4M3", margin),
                "w": update_meta(meta["w"], _amax(kernel), "E4M3", margin)}


def fp8_dense(x: torch.Tensor, kernel: torch.Tensor, meta: dict,
              margin: int = 0) -> tuple[torch.Tensor, dict]:
    """The models' fp8 projection: x @ kernel with E4M3 delayed scaling on
    both operands, bf16 out, E5M2 current-scaled backward. Takes and
    returns {'x': Fp8Meta, 'w': Fp8Meta}; the new metas come from the
    amaxes of the un-cast operands, with no gradient."""
    out = _Fp8Matmul.apply(x, kernel, meta["x"].scale, meta["w"].scale)
    return out, _new_metas(meta, x, kernel, margin)


def fp8_expert_dense(x: torch.Tensor, kernel: torch.Tensor, meta: dict,
                     margin: int = 0) -> tuple[torch.Tensor, dict]:
    """Per-expert fp8 projection: x [E, T, H] (or [T, H], shared by the
    experts) @ kernel [E, H, F] -> [E, T, F]. One delayed-scale pair
    covers the stacked tensors; each expert's product is the dense
    path's, so each expert's gradient takes its own E5M2 scale, as under
    the reference's vmap. On the card: one `_scaled_mm` per expert."""
    xs, ws = meta["x"].scale, meta["w"].scale
    out = torch.stack([
        _Fp8Matmul.apply(x[e] if x.ndim == 3 else x, kernel[e], xs, ws)
        for e in range(kernel.shape[0])])
    return out, _new_metas(meta, x, kernel, margin)


# --- state trees ------------------------------------------------------------


def _map_metas(fn, tree):
    """`tree` with every Fp8Meta replaced by fn(meta); dicts, lists and
    tuples rebuilt, other leaves kept."""
    if isinstance(tree, Fp8Meta):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_metas(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_metas(fn, v) for v in tree)
    return tree


def _metas(tree):
    if isinstance(tree, Fp8Meta):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _metas(v)
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for v in tree:
            yield from _metas(v)


def fp8_state_history_len(fp8_state) -> int | None:
    """The amax window length of a state tree (from its first Fp8Meta),
    or None when it holds none."""
    for meta in _metas(fp8_state):
        return int(meta.amax_history.shape[-1])
    return None


def adapt_history_len(fp8_state, history_len: int):
    """Every window resized (last dim) to `history_len`: truncation keeps
    the newest entries (index 0 is the newest), padding appends zeros (a
    zero amax never wins the max). Scales pass through. Tensors on the
    "meta" device resize too, so a checkpoint restore can build a
    like-tree of the window on disk."""

    def adapt(meta: Fp8Meta) -> Fp8Meta:
        hist = meta.amax_history
        h = int(hist.shape[-1])
        if h == history_len:
            return meta
        if hist.is_meta:
            new = torch.empty((*hist.shape[:-1], history_len),
                              dtype=hist.dtype, device="meta")
        elif h > history_len:
            new = hist[..., :history_len].clone()
        else:
            new = torch.nn.functional.pad(hist, (0, history_len - h))
        return Fp8Meta(scale=meta.scale, amax_history=new)

    return _map_metas(adapt, fp8_state)


def resolve_history_len(explicit: int | None = None) -> int:
    """The amax window: `explicit` > the live Accelerator's
    `FP8RecipeKwargs.amax_history_len` > 16."""
    if explicit is not None:
        return explicit
    from ..state import AcceleratorState

    recipe = AcceleratorState._shared_state.get("fp8_recipe_handler")
    if recipe is not None and recipe.amax_history_len is not None:
        return recipe.amax_history_len
    return 16


def all_reduce_metas_(fp8_state) -> None:
    """Every Fp8Meta of `fp8_state` made the global batch's, in place:
    each amax window takes its elementwise max across processes (one
    `all_reduce` for them all) and its scale is derived again from it,
    as `update_meta` derives it for the models' projections (E4M3,
    margin 0), one scale a window. The windows before the step are the
    same on every process, so only the newest entry changes: the max of
    the processes' amaxes, the global batch's. With one process, nothing
    happens."""
    from ..utils.operations import all_reduce_max_

    metas = list(_metas(fp8_state))
    all_reduce_max_([m.amax_history for m in metas])
    with torch.no_grad():
        for m in metas:
            m.scale.copy_(_ratio(E4M3_MAX, m.amax_history.amax(dim=-1)))


def stacked_fp8_metas(num_layers: int, groups: dict[str, tuple],
                      history_len: int | None = None,
                      device=None) -> dict:
    """Per-layer meta pairs for every projection, stacked on the layer
    dim (scale [L], amax_history [L, h]), on `device` (CUDA unless
    "cpu"). `groups` maps a module group to its projection names, e.g.
    {"attn": ("q_proj", ...), "mlp": ("gate_proj", ...)}; the window
    resolves through `resolve_history_len`."""
    h = resolve_history_len(history_len)
    dev = resolve_device(device)

    def meta():
        return Fp8Meta(
            scale=torch.ones((num_layers,), dtype=torch.float32, device=dev),
            amax_history=torch.zeros((num_layers, h), dtype=torch.float32,
                                     device=dev))

    return {"layers": {group: {name: {"x": meta(), "w": meta()}
                               for name in names}
                       for group, names in groups.items()}}


def init_fp8_state(params: Any, recipe: FP8RecipeKwargs | None = None):
    """One (x, w) meta pair per weight of 2 or more dims, on its device,
    in the params' tree structure (None for the other leaves)."""
    recipe = recipe or FP8RecipeKwargs()
    h = (recipe.amax_history_len if recipe.amax_history_len is not None
         else resolve_history_len())

    def leaf(p):
        if isinstance(p, dict):
            return {k: leaf(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(leaf(v) for v in p)
        if isinstance(p, torch.Tensor) and p.ndim >= 2:
            return {"x": Fp8Meta.init(h, device=p.device),
                    "w": Fp8Meta.init(h, device=p.device)}
        return None

    return leaf(params)
