"""The port's flash attention (on the CPU: the kernels' plain versions)
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs, in f32: outputs within atol 2e-5 and gradients within
1e-4 (two f32 summation orders over at most 64 keys); the LSE and the
backward entry points against `_flash_forward(save_residuals=True)` and
`_flash_backward` directly, with the same tolerances."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.common import dot_product_attention as j_dpa
from accelerate_tpu_torch.ops import flash_attention as tf

jf = importlib.import_module("accelerate_tpu.ops.flash_attention")

ATOL_OUT = 2e-5
ATOL_GRAD = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as the sibling port tests pin it: the plain
    versions' f32 GEMMs then take the same path in every test worker,
    whatever thread count the files run before left behind. On causal
    rows dominated by a few keys, a reordered f32 score (32 products
    summing to about 20 in magnitude) moves an output by up to about
    3e-5, over ATOL_OUT."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, b, sq, h, d, sk=None):
    rng = np.random.default_rng(seed)
    sk = sk or sq
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    do = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _mask_with_empty_row(b, s):
    """Batch row 0 masks its first 5 keys; batch row 1 masks every key,
    so all its query rows see nothing (zero output, zero grads)."""
    m = np.ones((b, s), np.int32)
    m[0, :5] = 0
    m[1] = 0
    return m


CASES = {
    # name: (batch, sq, heads, d, causal, mask?, window, sk)
    "causal": (2, 64, 2, 32, True, False, None, None),
    "noncausal": (2, 64, 2, 32, False, False, None, None),
    "key_mask_empty_row": (2, 64, 2, 32, False, True, None, None),
    "causal_key_mask": (2, 64, 2, 32, True, True, None, None),
    "window_9": (1, 64, 2, 32, True, False, 9, None),
    "window_10": (1, 64, 2, 32, True, False, 10, None),
    "window_wider_than_s": (1, 64, 2, 32, True, False, 64, None),
    "s_50": (1, 50, 2, 32, True, False, None, None),
    "s_12": (2, 12, 2, 16, True, False, None, None),
    "causal_sq_ne_sk": (1, 16, 2, 16, True, False, None, 48),
}


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_matches_jax(name):
    b, sq, h, d, causal, with_mask, window, sk = CASES[name]
    q, k, v, do = _inputs(list(CASES).index(name), b, sq, h, d, sk)
    mask = _mask_with_empty_row(b, k.shape[1]) if with_mask else None

    def f(q, k, v):
        return jf.flash_attention(
            q, k, v, causal=causal, window=window, interpret=True,
            mask=None if mask is None else jnp.asarray(mask))

    out_j, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out_t = tf.flash_attention(
        qt, kt, vt, causal=causal, window=window,
        mask=None if mask is None else torch.tensor(mask))
    out_t.backward(torch.tensor(do))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=ATOL_OUT, rtol=0)
    for t, g in zip((qt, kt, vt), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=ATOL_GRAD, rtol=0)
    if with_mask:
        # the fully masked batch row: zero output and zero dq
        assert not out_t[1].detach().abs().max()
        assert not qt.grad[1].abs().max()


def _bh(x):
    """[B, S, H, D] -> the Pallas kernels' [B*H, S, D]."""
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _bshd(x, b, h):
    bh, s, d = x.shape
    return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal,with_mask,window", [
    (True, False, None), (False, True, None), (True, False, 20)])
def test_entry_points_match_the_pallas_forward_and_backward(causal,
                                                            with_mask,
                                                            window):
    """`flash_forward(save_residuals=True)` and `flash_backward` against
    `_flash_forward`/`_flash_backward` called as ring attention calls
    them: the LSE (pinned to 0 on empty rows) and dq, dk, dv."""
    b, s, h, d = 2, 64, 2, 32
    q, k, v, do = _inputs(7, b, s, h, d)
    mask = _mask_with_empty_row(b, s) if with_mask else None
    jmask = None
    if mask is not None:
        jmask = jnp.broadcast_to(jnp.asarray(mask, jnp.float32)[:, None, :],
                                 (b, 8, s))
    o_j, lse_j = jf._flash_forward(
        _bh(q), _bh(k), _bh(v), causal, 16, 16, True, save_residuals=True,
        mask=jmask, heads=h, window=window)
    dq_j, dk_j, dv_j = jf._flash_backward(
        _bh(q), _bh(k), _bh(v), o_j, lse_j[..., 0], _bh(do), causal, 16, 16,
        True, mask=jmask, heads=h, window=window)
    tmask = None if mask is None else torch.tensor(mask)
    o_t, lse_t = tf.flash_forward(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), causal, tmask, window,
                                  save_residuals=True)
    np.testing.assert_allclose(o_t.numpy(), _bshd(o_j, b, h),
                               atol=ATOL_OUT, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(),
                               np.asarray(lse_j[..., 0]).reshape(b, h, s),
                               atol=ATOL_OUT, rtol=0)
    if with_mask:
        assert not lse_t[1].abs().max()   # pinned to 0 on empty rows
    grads_t = tf.flash_backward(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), o_t, lse_t,
                                torch.tensor(do), causal, tmask, window)
    for t, g in zip(grads_t, (dq_j, dk_j, dv_j)):
        np.testing.assert_allclose(t.numpy(), _bshd(g, b, h),
                                   atol=ATOL_GRAD, rtol=0)


def test_full_per_position_mask_takes_the_einsum_path():
    b, s, h, d = 1, 16, 2, 16
    q, k, v, _ = _inputs(3, b, s, h, d)
    full = np.tril(np.ones((b, 1, s, s), np.int32))
    out_t = tf.flash_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), causal=False,
                               mask=torch.tensor(full))
    out_j = j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  mask=jnp.asarray(full).astype(bool))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=ATOL_OUT, rtol=0)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    q, k, v, do = (torch.tensor(x) for x in _inputs(4, 1, 16, 2, 16))
    before = (tf.flash_forward.launches, tf.flash_backward_dq.launches,
              tf.flash_backward_dkv.launches)
    o, lse = tf.flash_forward(q, k, v, True, save_residuals=True)
    ro, rlse = tf.flash_forward_reference(q, k, v, True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    tf.flash_backward(q, k, v, o, lse, do, True)
    assert (tf.flash_forward.launches, tf.flash_backward_dq.launches,
            tf.flash_backward_dkv.launches) == before


def test_bf16_plain_version_rounds_p_like_the_kernel():
    """bf16 inputs: the output is bf16, and P is rounded to bf16 before
    P.V, so it differs from the f32-probability result by bf16 rounding
    only (relative 2^-8)."""
    q, k, v, _ = (torch.tensor(x).bfloat16()
                  for x in _inputs(5, 1, 32, 2, 16))
    o, _ = tf.flash_forward_reference(q, k, v, True)
    assert o.dtype == torch.bfloat16
    ref = j_dpa(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                causal=True)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(ref),
                               atol=2e-2, rtol=0)


def test_wrapper_value_errors():
    q, k, v, _ = (torch.tensor(x) for x in _inputs(6, 1, 16, 2, 16))
    with pytest.raises(ValueError, match="causal=True"):
        tf.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="positive"):
        tf.flash_attention(q, k, v, causal=True, window=0)
    with pytest.raises(ValueError, match="no flash kernel"):
        tf.flash_forward(q.to("meta"), k.to("meta"), v.to("meta"), True)
    with pytest.raises(ValueError, match="no flash kernel"):
        tf.flash_backward_dq(q.to("meta"), k.to("meta"), v.to("meta"),
                             q.to("meta"), torch.zeros(1, 2, 16,
                                                       device="meta"),
                             q.to("meta"), True)
