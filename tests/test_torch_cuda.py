"""Tests of the PyTorch port that need an NVIDIA GPU: each CUDA kernel
against its plain PyTorch version, and the engine on the card against
the engine on the CPU.

Without a card every test here skips with a reason. The file imports
neither jax nor the JAX package, so it also runs where those are not
installed (the suite's conftest imports jax, hence `--noconftest`):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.models import llama
from accelerate_tpu_torch.models.convert import params_from_numpy, \
    params_to_numpy
from accelerate_tpu_torch.ops import paged_attention as tp
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
