"""Tests of the PyTorch port that need an NVIDIA GPU: each CUDA kernel
against its plain PyTorch version, the engine on the card against the
engine on the CPU, the bf16 head's gradient, and a training step on the
card against the same step on the CPU.

Without a card every test here skips with a reason. The file imports
neither jax nor the JAX package, so it also runs where those are not
installed (the suite's conftest imports jax, hence `--noconftest`):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import optimizers as to
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models import llama
from accelerate_tpu_torch.models.convert import params_from_numpy, \
    params_to_numpy
from accelerate_tpu_torch.ops import flash_attention as tf
from accelerate_tpu_torch.ops import paged_attention as tp
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.training import TrainState
from accelerate_tpu_torch.ops.quant import kv_quantize_rows
from accelerate_tpu_torch.serving import Engine, EngineConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, pool_dtype=torch.float32, S=3, P=4, ps=8, Hkv=2, G=3,
            D=32, num_pages=12, seed=0):
    """Mid-page, page-boundary and nearly empty slots; trash-padded
    table rows; stale rows past every length."""
    g = torch.Generator().manual_seed(seed)
    shape = (num_pages + 1, ps, Hkv, D)
    k = torch.randn(shape, generator=g)
    v = torch.randn(shape, generator=g)
    table = torch.full((S, P), num_pages, dtype=torch.int32)
    for s, fill in enumerate(([0, 1, 2], [3, 4], [5])[:S]):
        table[s, :len(fill)] = torch.tensor(fill[:P])
    lengths = torch.tensor([ps + 5, 2 * ps, 2][:S], dtype=torch.int32)
    q_dtype = torch.float32 if pool_dtype == torch.float32 else \
        torch.bfloat16
    q = torch.randn((S, 1, Hkv * G, D), generator=g).to(q_dtype)
    kn = torch.randn((S, 1, Hkv, D), generator=g).to(q_dtype)
    vn = torch.randn((S, 1, Hkv, D), generator=g).to(q_dtype)
    if pool_dtype == torch.int8:
        (ck, sk), (cv, sv) = kv_quantize_rows(k), kv_quantize_rows(v)
        pk = tp.PagedKV(ck.to(dev), sk.to(dev), compute_dtype=q_dtype)
        pv = tp.PagedKV(cv.to(dev), sv.to(dev), compute_dtype=q_dtype)
    else:
        pk = tp.PagedKV(k.to(dev, pool_dtype))
        pv = tp.PagedKV(v.to(dev, pool_dtype))
    meta = tp.PagedDecodeMeta(table.to(dev), lengths.to(dev), rows=P * ps)
    return q.to(dev), kn.to(dev), vn.to(dev), pk, pv, meta


# f32 pools: f32 arithmetic in another order (1e-5); bf16 outputs: one
# bf16 rounding of values below 4 (2**-7 relative, atol 2e-2)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.int8: 2e-2}


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16,
                                        torch.int8], ids=str)
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("G,D", [(3, 32), (1, 64), (4, 128)])
def test_paged_decode_kernel_matches_plain_version(cuda, pool_dtype, window,
                                                   G, D):
    args = _inputs(cuda, pool_dtype, G=G, D=D)
    before = tp.paged_decode_attention.launches
    out, rows = tp.paged_decode_attention(*args, window=window)
    ref, ref_rows = tp.paged_decode_reference(*args, window=window)
    torch.cuda.synchronize()
    assert tp.paged_decode_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=TOL[pool_dtype], rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(rows, ref_rows))


def _split_inputs(dev, pool_dtype, G, ps, D=64, Hkv=2, seed=0):
    """Slots at the split kernel's corners (a split is 128 rows here):
    empty; exactly one and two splits; one row past a split boundary; a
    short slot; and a long slot whose first pages a last slot shares."""
    g = torch.Generator().manual_seed(seed)
    P = -(-1024 // ps)
    lengths = [0, 128, 256, 129, 5, 700, 700]
    S = len(lengths)
    num_pages = S * P
    table = torch.full((S, P), num_pages, dtype=torch.int32)
    nxt = 0
    for s, n in enumerate(lengths):
        live = -(-n // ps)
        table[s, :live] = torch.arange(nxt, nxt + live)
        nxt += live
    table[6, :300 // ps] = table[5, :300 // ps]   # a shared prompt prefix
    shape = (num_pages + 1, ps, Hkv, D)
    k = torch.randn(shape, generator=g)
    v = torch.randn(shape, generator=g)
    q_dtype = torch.float32 if pool_dtype == torch.float32 else \
        torch.bfloat16
    q = torch.randn((S, 1, Hkv * G, D), generator=g).to(q_dtype)
    kn = torch.randn((S, 1, Hkv, D), generator=g).to(q_dtype)
    vn = torch.randn((S, 1, Hkv, D), generator=g).to(q_dtype)
    if pool_dtype == torch.int8:
        (ck, sk), (cv, sv) = kv_quantize_rows(k), kv_quantize_rows(v)
        pk = tp.PagedKV(ck.to(dev), sk.to(dev), compute_dtype=q_dtype)
        pv = tp.PagedKV(cv.to(dev), sv.to(dev), compute_dtype=q_dtype)
    else:
        pk = tp.PagedKV(k.to(dev, pool_dtype))
        pv = tp.PagedKV(v.to(dev, pool_dtype))
    meta = tp.PagedDecodeMeta(table.to(dev), torch.tensor(
        lengths, dtype=torch.int32, device=dev), rows=P * ps)
    return q.to(dev), kn.to(dev), vn.to(dev), pk, pv, meta


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16,
                                        torch.int8], ids=str)
@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
def test_paged_decode_splits_match_plain_version(cuda, pool_dtype, window,
                                                 ps, G):
    """The split kernel and its combine at the corners: a length-0 slot
    (only the new token counts), lengths exactly at a split boundary and
    one past it, a window of 200 that leaves whole splits of the 700-row
    slots empty, and pages shared between two slots."""
    args = _split_inputs(cuda, pool_dtype, G, ps)
    before = tp.paged_decode_attention.launches
    out, rows = tp.paged_decode_attention(*args, window=window)
    ref, ref_rows = tp.paged_decode_reference(*args, window=window)
    torch.cuda.synchronize()
    assert tp.paged_decode_attention.launches == before + 1
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=TOL[pool_dtype], rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(rows, ref_rows))


@pytest.mark.parametrize("D", [32, 96, 128, 256, 512])
def test_paged_decode_splits_head_dims(cuda, D):
    args = _split_inputs(cuda, torch.bfloat16, 4, 16, D=D)
    out, _ = tp.paged_decode_attention(*args, window=200)
    ref, _ = tp.paged_decode_reference(*args, window=200)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)


def test_paged_decode_kernel_length_zero_slot(cuda):
    q, kn, vn, pk, pv, meta = _inputs(cuda)
    meta = tp.PagedDecodeMeta(meta.table, torch.zeros_like(meta.lengths),
                              meta.rows)
    out, _ = tp.paged_decode_attention(q, kn, vn, pk, pv, meta)
    S, _, H, D = q.shape
    expect = vn[:, 0].repeat_interleave(H // vn.shape[2], dim=1)
    torch.testing.assert_close(out.reshape(S, H, D), expect, atol=1e-6,
                               rtol=0)


def test_paged_decode_kernel_rejects_bad_inputs(cuda):
    q, kn, vn, pk, pv, meta = _inputs(cuda)
    bad_table = tp.PagedDecodeMeta(meta.table.long(), meta.lengths, meta.rows)
    with pytest.raises(ValueError, match="int32"):
        tp.paged_decode_attention(q, kn, vn, pk, pv, bad_table)
    with pytest.raises(ValueError, match="multiple of 32"):
        tp.paged_decode_attention(*_inputs(cuda, D=16))
    strided = tp.PagedKV(pk.data.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        tp.paged_decode_attention(q, kn, vn, strided, pv, meta)
    cpu_meta = tp.PagedDecodeMeta(meta.table.cpu(), meta.lengths, meta.rows)
    with pytest.raises(ValueError, match="page table is on cpu"):
        tp.paged_decode_attention(q, kn, vn, pk, pv, cpu_meta)


def test_engine_on_the_card_matches_the_cpu_engine(cuda):
    """A tiny f32 llama: the card's engine through the kernel gives the
    CPU engine's greedy streams (dense-gather path)."""
    cfg = llama.LlamaConfig.tiny(hidden_size=128, num_attention_heads=4,
                                 num_key_value_heads=2)
    params = llama.init_params(cfg, 0)
    assert params["norm"]["scale"].is_cuda
    host_params = params_from_numpy(params_to_numpy(params), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 13, 9, 30)]
    kw = dict(num_slots=2, max_len=64, prefill_chunk=8, page_size=8,
              cache_dtype=torch.float32)
    streams = []
    for ps, pa, dev in ((params, True, None),
                        (host_params, False, "cpu")):
        eng = Engine(llama, cfg, ps, EngineConfig(paged_attention=pa, **kw),
                     device=dev)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_idle()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


# --- flash attention (K1a, K1b, K1c) ----------------------------------------


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("S,causal,masked,window", [
    (64, True, False, None), (100, False, False, None),
    (96, False, True, None), (130, True, False, 17), (12, True, True, None)])
def test_flash_kernels_match_plain_versions(cuda, dtype, S, causal, masked,
                                            window):
    """f32: within 1e-4 everywhere (another f32 summation order); bf16
    against the plain version in f32 on the same inputs: output within
    2e-2, LSE within 1e-3, gradients within 2e-2 relative L2 (P and dS
    are rounded to bf16 before their products)."""
    g = torch.Generator(device=cuda).manual_seed(S)
    B, H, D = 2, 3, 64
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=cuda)
                   .to(dtype) for _ in range(4))
    mask = None
    if masked:
        mask = torch.ones((B, S), dtype=torch.int32, device=cuda)
        mask[0, : S // 3] = 0
        mask[1] = 0                       # a batch row that sees nothing
    launches = (tf.flash_forward.launches, tf.flash_backward_dq.launches,
                tf.flash_backward_dkv.launches)
    o, lse = tf.flash_forward(q, k, v, causal, mask, window,
                              save_residuals=True)
    dq, dk, dv = tf.flash_backward(q, k, v, o, lse, do, causal, mask,
                                   window)
    torch.cuda.synchronize()
    assert (tf.flash_forward.launches, tf.flash_backward_dq.launches,
            tf.flash_backward_dkv.launches) == tuple(n + 1 for n in launches)
    ro, rlse = tf.flash_forward_reference(q.float(), k.float(), v.float(),
                                          causal, mask, window)
    grads = tf.flash_backward_reference(q.float(), k.float(), v.float(), ro,
                                        rlse, do.float(), causal, mask,
                                        window)
    if dtype == torch.float32:
        for a, b in zip((o, lse, dq, dk, dv), (ro, rlse, *grads)):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(o.float(), ro, atol=2e-2, rtol=0)
        torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
        for a, b in zip((dq, dk, dv), grads):
            assert _rel_l2(a, b) <= 2e-2
    if masked:
        assert not o[1].abs().max() and not lse[1].abs().max()


@pytest.mark.parametrize("mode", ["causal", "noncausal", "window",
                                  "key_mask"])
@pytest.mark.parametrize("S", [12, 1000, 2048])
@pytest.mark.parametrize("D", list(range(16, 129, 16)))
def test_flash_forward_bf16_every_head_dim(cuda, D, S, mode):
    """The bf16 forward (wgmma) at every head dim it takes, ragged and
    tile-multiple lengths: o within 2e-2 and the LSE within 1e-3 of the
    plain version in f32 on the same inputs (P is rounded to bf16 before
    P.V in both)."""
    g = torch.Generator(device=cuda).manual_seed(D * 10000 + S)
    B, H = 2, 2
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=cuda)
               .bfloat16() for _ in range(3))
    causal = mode != "noncausal"
    window = 100 if mode == "window" else None
    mask = None
    if mode == "key_mask":
        mask = torch.ones((B, S), dtype=torch.int32, device=cuda)
        mask[0, : S // 3] = 0
        mask[1] = 0                       # a batch row that sees nothing
    before = tf.flash_forward.launches
    o, lse = tf.flash_forward(q, k, v, causal, mask, window,
                              save_residuals=True)
    ro, rlse = tf.flash_forward_reference(q.float(), k.float(), v.float(),
                                          causal, mask, window)
    torch.cuda.synchronize()
    assert tf.flash_forward.launches == before + 1
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), ro, atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    if mask is not None:
        assert not o[1].abs().max() and not lse[1].abs().max()


@pytest.mark.parametrize("Sq,Sk", [(100, 300), (300, 100)])
def test_flash_forward_bf16_cross_lengths(cuda, Sq, Sk):
    """Non-causal attention with more or fewer keys than queries."""
    g = torch.Generator(device=cuda).manual_seed(Sq)
    q = torch.randn((2, Sq, 3, 128), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((2, Sk, 3, 128), generator=g, device=cuda)
            .bfloat16() for _ in range(2))
    o, lse = tf.flash_forward(q, k, v, False, save_residuals=True)
    ro, rlse = tf.flash_forward_reference(q.float(), k.float(), v.float(),
                                          False)
    torch.testing.assert_close(o.float(), ro, atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)


def _flash_grads(q, k, v, do, causal, mask, window):
    """Kernel forward and backward on the card, and the plain versions in
    f32 on the same inputs: ((dq, dk, dv), (rdq, rdk, rdv))."""
    o, lse = tf.flash_forward(q, k, v, causal, mask, window,
                              save_residuals=True)
    grads = tf.flash_backward(q, k, v, o, lse, do, causal, mask, window)
    ro, rlse = tf.flash_forward_reference(q.float(), k.float(), v.float(),
                                          causal, mask, window)
    ref = tf.flash_backward_reference(q.float(), k.float(), v.float(), ro,
                                      rlse, do.float(), causal, mask, window)
    torch.cuda.synchronize()
    return grads, ref


@pytest.mark.parametrize("mode", ["causal", "noncausal", "window",
                                  "key_mask"])
@pytest.mark.parametrize("S", [12, 1000, 2048])
@pytest.mark.parametrize("D", list(range(16, 129, 16)))
def test_flash_backward_bf16_every_head_dim(cuda, D, S, mode):
    """The bf16 backward (wgmma dQ and dK/dV) at every head dim it takes,
    ragged and tile-multiple lengths: dq, dk and dv within 2e-2 relative
    L2 of the plain version in f32 on the same inputs (P and dS are
    rounded to bf16 before their products in both); a batch row that
    sees no key gets zero gradients."""
    g = torch.Generator(device=cuda).manual_seed(D * 10000 + S + 7)
    B, H = 2, 2
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=cuda)
                   .bfloat16() for _ in range(4))
    causal = mode != "noncausal"
    window = 100 if mode == "window" else None
    mask = None
    if mode == "key_mask":
        mask = torch.ones((B, S), dtype=torch.int32, device=cuda)
        mask[0, : S // 3] = 0
        mask[1] = 0                       # a batch row that sees nothing
    grads, ref = _flash_grads(q, k, v, do, causal, mask, window)
    for a, b in zip(grads, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert bool(torch.isfinite(a.float()).all())
        assert _rel_l2(a, b) <= 2e-2
    if mask is not None:
        assert not any(t[1].abs().max() for t in grads)


@pytest.mark.parametrize("Sq,Sk", [(100, 300), (300, 100), (1000, 130)])
def test_flash_backward_bf16_cross_lengths(cuda, Sq, Sk):
    """Non-causal gradients with more or fewer keys than queries."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk)
    q, do = (torch.randn((2, Sq, 3, 128), generator=g, device=cuda)
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((2, Sk, 3, 128), generator=g, device=cuda)
            .bfloat16() for _ in range(2))
    grads, ref = _flash_grads(q, k, v, do, False, None, None)
    for a, b in zip(grads, ref):
        assert a.shape == b.shape
        assert _rel_l2(a, b) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_backward_is_deterministic_and_counts_launches(cuda, dtype):
    """The FA-2 split has no atomics: two calls on the same inputs give
    bit-identical dq, dk and dv; each call adds one launch to K1b's and
    one to K1c's counter."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn((2, 1000, 4, 128), generator=g, device=cuda)
                   .to(dtype) for _ in range(4))
    o, lse = tf.flash_forward(q, k, v, True, save_residuals=True)
    runs = []
    for _ in range(2):
        before = (tf.flash_backward_dq.launches,
                  tf.flash_backward_dkv.launches)
        runs.append(tf.flash_backward(q, k, v, o, lse, do, True))
        assert (tf.flash_backward_dq.launches,
                tf.flash_backward_dkv.launches) == (before[0] + 1,
                                                    before[1] + 1)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_backward_row_that_sees_no_key_has_zero_gradients(cuda):
    """A key mask that hides every key of one batch row pins that row's
    LSE to 0 in the forward; the backward gives it zero dq, and zero dk
    and dv for its (hidden) keys, in both dtypes, with a window."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn((2, 300, 2, 64), generator=g,
                                   device=cuda).to(dtype) for _ in range(4))
        mask = torch.ones((2, 300), dtype=torch.int32, device=cuda)
        mask[1] = 0
        (dq, dk, dv), ref = _flash_grads(q, k, v, do, True, mask, 64)
        for t in (dq, dk, dv):
            assert not t[1].abs().max()
            assert t[0].abs().max() > 0
        for a, b in zip((dq, dk, dv), ref):
            assert _rel_l2(a, b) <= 2e-2


def test_flash_attention_autograd_on_the_card_matches_the_cpu(cuda):
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((1, 80, 2, 32), generator=g)
                   for _ in range(4))
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        out = tf.flash_attention(*leaves, causal=True, window=30)
        out.backward(do.to(dev))
        grads.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def test_flash_kernels_reject_bad_inputs(cuda):
    q = torch.zeros((1, 16, 2, 24), device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        tf.flash_forward(q, q, q, True)
    q = torch.zeros((1, 16, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tf.flash_forward(q.half(), q.half(), q.half(), True)
    with pytest.raises(ValueError, match="contiguous"):
        tf.flash_forward(q.transpose(1, 2), q.transpose(1, 2),
                         q.transpose(1, 2), False)


# --- the bf16 head and a training step ---------------------------------------


def test_bf16_head_gradient_on_the_card_matches_the_cpu_upcast(cuda):
    """`_project_out` in bf16 (and f16) is differentiable on the card,
    and its grads are the CPU upcast path's: products against the f32
    cotangent, rounded once to the operands' dtype. At least 98% of dx
    and dw are bit-equal (f32 summation order may tip a rounding);
    rounding the cotangent to bf16 before the products would leave about
    56% equal at these shapes."""
    cfg = llama.LlamaConfig.tiny(hidden_size=128, vocab_size=512)
    for dtype in (torch.bfloat16, torch.float16):
        g = torch.Generator().manual_seed(0)
        x = torch.randn((2, 7, 128), generator=g).to(dtype)
        w = (torch.randn((128, 512), generator=g) * 0.05).to(dtype)
        cot = torch.randn((2, 7, 512), generator=g)
        grads = []
        for dev in ("cpu", cuda):
            xd, wd = (t.detach().to(dev).requires_grad_() for t in (x, w))
            out = llama._project_out(cfg, {"lm_head": {"kernel": wd}}, xd)
            assert out.dtype == torch.float32
            out.backward(cot.to(dev))
            grads.append((out.detach().cpu(), xd.grad.cpu(), wd.grad.cpu()))
        (o_c, dx_c, dw_c), (o_g, dx_g, dw_g) = grads
        torch.testing.assert_close(o_g, o_c, atol=1e-4, rtol=1e-4)
        assert dx_g.dtype == dtype and dw_g.dtype == dtype
        assert (dx_g == dx_c).float().mean() >= 0.98
        assert (dw_g == dw_c).float().mean() >= 0.98


@pytest.mark.parametrize("backend", ["flash", "einsum"])
def test_train_step_on_the_card_matches_cpu(cuda, backend):
    """Two f32 steps of a tiny llama (head_dim 32) through the Accelerator
    on the card and with cpu=True: losses within 1e-5, params within
    1e-4 (Adam's division by sqrt(v), as in the CPU parity tests)."""
    cfg = llama.LlamaConfig.tiny(hidden_size=128, attention_backend=backend)
    init = params_to_numpy(llama.init_params(cfg, 0, device="cpu"))
    ids = np.random.default_rng(0).integers(0, 256, (4, 33)).astype(np.int32)
    results = []
    for cpu in (False, True):
        PartialState._reset_state()
        acc = Accelerator(gradient_clipping=1.0, cpu=cpu)
        state = acc.prepare(TrainState.create(
            apply_fn=None, params=params_from_numpy(init, device=acc.device),
            tx=to.adamw(1e-3)))
        step = acc.train_step(lambda p, b: llama.causal_lm_loss(cfg, p, b))
        losses = []
        for _ in range(2):
            state, m = step(state, {"input_ids": ids})
            losses.append(float(m["loss"]))
        results.append((losses, to.tree_leaves(
            params_to_numpy(state.params))))
    PartialState._reset_state()
    (l_gpu, p_gpu), (l_cpu, p_cpu) = results
    np.testing.assert_allclose(l_gpu, l_cpu, atol=1e-5, rtol=0)
    for a, b in zip(p_gpu, p_cpu):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
