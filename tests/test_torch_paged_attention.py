"""The port's paged decode attention against the JAX package's.

On the CPU the port's wrapper runs its plain version
(`paged_decode_reference`); it is held here to the JAX Pallas kernel run
in interpret mode, over the page geometry of
tests/test_paged_attention.py (mid-page and page-boundary lengths, GQA
groups, trash-padded tables, windows, int8 pools, length-0 slots, stale
rows), f32, atol 2e-5. The CUDA kernel itself is held to the same plain
version by tests/test_torch_cuda.py, which needs a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops import paged_attention as jp
from accelerate_tpu.ops.quant import kv_quantize_rows as j_quantize
from accelerate_tpu_torch.ops import paged_attention as tp
from accelerate_tpu_torch.ops.quant import kv_quantize_rows as t_quantize

ATOL = 2e-5


def _geometry(seed=0, S=3, P=4, ps=8, Hkv=2, G=3, D=16, num_pages=12):
    """Numpy inputs: slot 0 mid-page, slot 1 at a page boundary, slot 2
    nearly empty with a trash-padded table row."""
    rng = np.random.default_rng(seed)
    shape = (num_pages + 1, ps, Hkv, D)
    pool_k = rng.normal(size=shape).astype(np.float32)
    pool_v = rng.normal(size=shape).astype(np.float32)
    table = np.full((S, P), num_pages, np.int32)
    fills = ([0, 1, 2], [3, 4], [5])
    for s in range(S):
        f = fills[s % 3][:P]
        table[s, :len(f)] = f
    lengths = np.asarray([min(ps + 5, P * ps - 1), min(2 * ps, P * ps), 2][:S],
                         np.int32)
    q = rng.normal(size=(S, 1, Hkv * G, D)).astype(np.float32)
    kn = rng.normal(size=(S, 1, Hkv, D)).astype(np.float32)
    vn = rng.normal(size=(S, 1, Hkv, D)).astype(np.float32)
    return dict(q=q, kn=kn, vn=vn, pool_k=pool_k, pool_v=pool_v,
                table=table, lengths=lengths, rows=P * ps)


def _jax(g, window=None, quantized=False):
    if quantized:
        ck, sk = j_quantize(jnp.asarray(g["pool_k"]))
        cv, sv = j_quantize(jnp.asarray(g["pool_v"]))
        pk = jp.PagedKV(ck, sk, compute_dtype=jnp.float32)
        pv = jp.PagedKV(cv, sv, compute_dtype=jnp.float32)
    else:
        pk = jp.PagedKV(jnp.asarray(g["pool_k"]))
        pv = jp.PagedKV(jnp.asarray(g["pool_v"]))
    meta = jp.PagedDecodeMeta(jnp.asarray(g["table"]),
                              jnp.asarray(g["lengths"]), rows=g["rows"])
    return jp.paged_decode_attention(
        jnp.asarray(g["q"]), jnp.asarray(g["kn"]), jnp.asarray(g["vn"]),
        pk, pv, meta, window=window, interpret=True)


def _torch_inputs(g, quantized=False, device="cpu"):
    def t(a):
        return torch.tensor(a, device=device)

    if quantized:
        ck, sk = t_quantize(t(g["pool_k"]))
        cv, sv = t_quantize(t(g["pool_v"]))
        pk = tp.PagedKV(ck, sk, compute_dtype=torch.float32)
        pv = tp.PagedKV(cv, sv, compute_dtype=torch.float32)
    else:
        pk, pv = tp.PagedKV(t(g["pool_k"])), tp.PagedKV(t(g["pool_v"]))
    meta = tp.PagedDecodeMeta(t(g["table"]), t(g["lengths"]), rows=g["rows"])
    return t(g["q"]), t(g["kn"]), t(g["vn"]), pk, pv, meta


def _torch(g, window=None, quantized=False):
    return tp.paged_decode_attention(*_torch_inputs(g, quantized),
                                     window=window)


def _check(out_t, rows_t, out_j, rows_j, atol=ATOL):
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=atol,
                               rtol=0)
    for a, b in zip(rows_t, rows_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("window", [None, 5, 1000])
def test_geometry_matrix_matches_jax(window):
    g = _geometry()
    out_t, rows_t = _torch(g, window)
    out_j, rows_j = _jax(g, window)
    _check(out_t, rows_t, out_j, rows_j)


def test_single_page_single_head_matches_jax():
    """Degenerate geometry: one page per slot, MHA (group 1)."""
    g = _geometry(S=2, P=1, ps=4, Hkv=3, G=1, D=8, num_pages=4)
    g["table"] = g["table"][:2, :1]
    g["lengths"] = np.asarray([3, 0], np.int32)
    g["rows"] = 4
    out_t, rows_t = _torch(g)
    out_j, rows_j = _jax(g)
    _check(out_t, rows_t, out_j, rows_j)


def test_length_zero_slots_attend_only_new_token():
    g = _geometry()
    g["lengths"] = np.zeros_like(g["lengths"])
    out_t, _ = _torch(g)
    out_j, _ = _jax(g)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    S, _, H, D = g["q"].shape
    expect = np.repeat(g["vn"][:, 0], H // g["vn"].shape[2], axis=1)
    np.testing.assert_allclose(out_t.numpy().reshape(S, -1, D), expect,
                               atol=1e-6)


def test_stale_rows_past_length_never_leak():
    """Poisoning every row at or past a slot's length changes nothing."""
    g = _geometry()
    out0, _ = _torch(g)
    ps = g["pool_k"].shape[1]
    for s, row in enumerate(g["table"]):
        for j, page in enumerate(row):
            for r in range(ps):
                if j * ps + r >= g["lengths"][s]:
                    g["pool_k"][page, r] = 900.0
                    g["pool_v"][page, r] = -900.0
    out1, _ = _torch(g)
    out_j, _ = _jax(g)
    np.testing.assert_allclose(out1.numpy(), out0.numpy(), atol=1e-6)
    np.testing.assert_allclose(out1.numpy(), np.asarray(out_j), atol=ATOL)


@pytest.mark.parametrize("window", [None, 5])
def test_int8_pool_matches_jax(window):
    g = _geometry(seed=1)
    out_t, rows_t = _torch(g, window, quantized=True)
    out_j, rows_j = _jax(g, window, quantized=True)
    _check(out_t, rows_t, out_j, rows_j)
    assert rows_t[0].dtype == torch.float32


def test_meta_add_is_a_noop_and_layer_view():
    meta = tp.PagedDecodeMeta(torch.zeros((2, 3), dtype=torch.int32),
                              torch.zeros(2, dtype=torch.int32), rows=12)
    assert (meta + 5) is meta
    data = torch.zeros((4, 3, 2, 2, 8), dtype=torch.int8)
    pk = tp.PagedKV(data, torch.ones((4, 3, 2, 2), dtype=torch.bfloat16))
    layer = pk[2]
    assert layer.data.shape == (3, 2, 2, 8) and layer.quantized
    assert layer.row_dtype == torch.bfloat16
    assert layer.data.data_ptr() == data[2].data_ptr()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    g = _geometry()
    before = tp.paged_decode_attention.launches
    out, _ = _torch(g)
    ref, _ = tp.paged_decode_reference(*_torch_inputs(g))
    assert tp.paged_decode_attention.launches == before
    assert torch.equal(out, ref)


def test_rejects_multi_token_queries():
    q, kn, vn, pk, pv, meta = _torch_inputs(_geometry())
    with pytest.raises(ValueError, match="one token per slot"):
        tp.paged_decode_attention(q.repeat(1, 2, 1, 1), kn, vn, pk, pv, meta)


@pytest.mark.parametrize("P,ps", [(136, 16), (64, 8), (32, 32), (5, 256),
                                  (1, 16), (9, 16)])
def test_split_plan_covers_every_table_column_once(P, ps):
    """The kernel's splits: runs of about 128 rows (at least one page)
    that tile the table row with no split wholly past it, sized from
    shapes alone (the scratch is allocated without reading lengths)."""
    pps, nsplit = tp._split_plan(P, ps)
    assert pps * ps == max(128, ps) and pps >= 1
    assert (nsplit - 1) * pps < P <= nsplit * pps


def test_kernel_checks_follow_the_split_kernels_shared_memory():
    """Page sizes the engine uses pass the checks (up to the card's 227 KB
    per block, opted into above 48 KB); a page too large for a two-page
    ring is refused before any launch."""
    S, Hkv, G, D, P = 2, 2, 16, 128, 4

    def check(ps, dtype=torch.float32):
        q4 = torch.zeros(S, Hkv, G, D)
        pool = torch.zeros(9, ps, Hkv, D, dtype=dtype)
        meta = tp.PagedDecodeMeta(torch.zeros(S, P, dtype=torch.int32),
                                  torch.zeros(S, dtype=torch.int32), P * ps)
        tp._check_kernel_inputs(q4, torch.zeros(S, Hkv, D), tp.PagedKV(pool),
                                tp.PagedKV(pool.clone()), meta)

    for ps in (8, 16, 32, 64):    # 64 f32 rows need the opt-in
        check(ps)
    assert tp._split_smem(64, D, 4, G) > 48 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        check(256)
