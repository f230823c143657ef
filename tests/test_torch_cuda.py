"""Tests of the PyTorch port that need an NVIDIA GPU: each CUDA kernel
against its plain PyTorch version, the engine on the card against the
engine on the CPU, the engine's programs as CUDA graphs against the same
programs run eagerly (plain, speculative, with the host KV tier), the
bf16 head's gradient, a training step on the card against the same
step on the CPU (fused, and the eager loop), the fp8 path: the `_scaled_mm` products against
their plain version, an fp8 training step and an fp8 checkpoint, and
the model zoo: a GPT-J engine at head dim 256 (K2 at D=256, G=1) and a
Mixtral step through the flash kernels, each against the CPU; the
data pipeline: the loader's side-stream copies against the host's
batches, and a tracker's log of card scalars; and the pod's KV page
shipments (extract, copy to the host, install) against the CPU
programs; and tensor-parallel serving by two ranks sharing the card
against one process; and two pipeline stages of llama layers run in
turn through the flash kernels against the plain attention; and the
ring's chunk pair (a causal and a non-causal K1a folded into the global
output, K1b/K1c from the global LSE) and Ulysses' full-sequence
attention at phase context_parallel's shapes against the plain
versions, the ring and Ulysses backends in one process through the
flash kernels, and that phase's two ranks at the tiny width; and a
training step on a `seq` line of one, whose ring falls back to the
flash kernels.

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
from accelerate_tpu_torch.models import gptj, llama, mixtral
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
    q_dtype = _Q_DTYPE.get(pool_dtype, torch.bfloat16)
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


# the activations' dtype beside each pool dtype (bf16 beside int8)
_Q_DTYPE = {torch.float32: torch.float32, torch.float16: torch.float16}

# f32 pools: f32 arithmetic in another order (1e-5); bf16 outputs: one
# bf16 rounding of values below 4 (2**-7 relative, atol 2e-2); f16
# outputs: one f16 rounding of values below 4 (2**-10 relative, 4e-3)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.int8: 2e-2,
       torch.float16: 4e-3}


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


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16,
                                        torch.float16], ids=str)
@pytest.mark.parametrize("G", [1, 3, 32])
@pytest.mark.parametrize("D", [8, 16, 80, 256])
def test_paged_decode_kernel_every_head_dim_and_group(cuda, pool_dtype, G,
                                                      D):
    """Head dims under 32 and between multiples of 32, the widest (256),
    and groups of one, three and two tiles of 16, in f32, bf16 and f16
    pools and activations: the kernel within its dtype's rounding of the
    plain version, and the new rows handed back unchanged."""
    args = _inputs(cuda, pool_dtype, G=G, D=D, seed=D + G)
    before = tp.paged_decode_attention.launches
    out, rows = tp.paged_decode_attention(*args, window=5)
    ref, ref_rows = tp.paged_decode_reference(*args, window=5)
    torch.cuda.synchronize()
    assert tp.paged_decode_attention.launches == before + 1
    assert out.dtype == args[0].dtype
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=TOL[pool_dtype], rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(rows, ref_rows))


@pytest.mark.parametrize("D", [4, 8, 12])
def test_paged_decode_kernel_int8_rows_under_16_bytes(cuda, D):
    """int8 pools whose rows are 4, 8 and 12 bytes: copied in 4- and
    8-byte pieces."""
    args = _inputs(cuda, torch.int8, G=3, D=D, seed=D)
    out, _ = tp.paged_decode_attention(*args)
    ref, _ = tp.paged_decode_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)


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
    with pytest.raises(ValueError, match="4-byte words"):
        tp.paged_decode_attention(*_inputs(cuda, D=300))
    with pytest.raises(ValueError, match="4-byte words"):
        tp.paged_decode_attention(*_inputs(cuda, torch.int8, D=6))
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


# --- the engine's programs as CUDA graphs -------------------------------------


def test_default_engine_on_tiny_llama_matches_the_cpu_engine(cuda):
    """`LlamaConfig.tiny()` (head_dim 16) under the default engine config
    ("auto" runs the paged kernel on the card, the dense path on the CPU;
    f32 weights and pool): the same greedy streams."""
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, 0)
    host_params = params_from_numpy(params_to_numpy(params), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 33, 12)]
    streams = []
    for ps, dev in ((params, None), (host_params, "cpu")):
        eng = Engine(llama, cfg, ps, EngineConfig(cache_dtype=torch.float32),
                     device=dev)
        assert eng._use_paged_kernel == (dev is None)
        before = tp.paged_decode_attention.launches
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_idle()
        assert (tp.paged_decode_attention.launches > before) == (dev is None)
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


def _graph_cfg():
    return llama.LlamaConfig.tiny()


def _serve_mix(eng, seed=0, forks=True, cancel=True):
    """Cold prompts, a prefix hit, a fork, a cancel mid-decode, greedy
    and sampled: every request's (tokens, logprobs)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, 20).astype(np.int32)
    reqs = [eng.submit(rng.integers(0, 256, n).astype(np.int32),
                       max_new_tokens=6, temperature=t, key=i)
            for i, (n, t) in enumerate(((6, 0.0), (13, 0.8), (9, 0.0)))]
    reqs.append(eng.submit(shared, max_new_tokens=5))
    victim = eng.submit(rng.integers(0, 256, 7).astype(np.int32),
                        max_new_tokens=40)
    if forks:
        reqs.append(eng.fork(reqs[-1], key=99))
    for _ in range(8):
        eng.step()
    if cancel:
        eng.cancel(victim)
    eng.run_until_idle()
    late = eng.submit(np.concatenate([shared, [1, 2, 3]]).astype(np.int32),
                      max_new_tokens=6)
    eng.run_until_idle()
    reqs.append(late)
    assert all(r.status.value == "finished" for r in reqs)
    return [(r.tokens, r.logprobs) for r in reqs]


def _graph_engine(params, cfg, graphs, **kw):
    ec = dict(num_slots=3, max_len=96, prefill_chunk=8, page_size=8,
              cache_dtype=torch.float32, sanitize=True)
    ec.update(kw)
    return Engine(llama, cfg, params, EngineConfig(**ec), _graphs=graphs)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("paged_attention", [True, False])
def test_graph_engine_matches_the_eager_engine(cuda, paged_attention,
                                               kv_dtype):
    """Captured programs replay the eager engine's work: the same
    streams, the same logprobs, each program captured once whatever the
    mix (forks, a cancel, prefix hits, int8 pages)."""
    cfg = _graph_cfg()
    params = llama.init_params(cfg, 0)
    out = {}
    for graphs in (True, False):
        eng = _graph_engine(params, cfg, graphs, kv_dtype=kv_dtype,
                            paged_attention=paged_attention)
        out[graphs] = _serve_mix(eng)
        assert eng.compile_stats() == {"admit": 1, "prefill": 1,
                                       "decode": 1}
    assert [t for t, _ in out[True]] == [t for t, _ in out[False]]
    for (_, a), (_, b) in zip(out[True], out[False]):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_kernel_launches_count_through_replays(cuda):
    """The wrapper is the only counting site and never runs in a replay:
    the runner adds each replay's launches, so the count is the decode
    steps times the layers, as an eager engine counts it."""
    cfg = _graph_cfg()
    params = llama.init_params(cfg, 0)
    counts = {}
    for graphs in (True, False):
        eng = _graph_engine(params, cfg, graphs, paged_attention=True)
        tp.paged_decode_attention.launches = 0
        _serve_mix(eng, seed=1)
        steps = eng.metrics.decode_steps
        counts[graphs] = tp.paged_decode_attention.launches
        assert counts[graphs] == steps * cfg.num_hidden_layers > 0
    assert counts[True] == counts[False]


def _moved(target, other, frac=0.1):
    """`target`'s weights moved `frac` of the way toward `other`'s."""
    if isinstance(target, dict):
        return {k: _moved(target[k], other[k], frac) for k in target}
    return target + frac * (other - target)


def test_speculative_engine_on_graphs_matches_eager_and_plain(cuda):
    """The draft is the target moved a tenth of the way toward another
    seed's weights: it is accepted about half the time, so the captured
    verify commits accepted windows of several rows as well as lone
    corrections."""
    cfg = _graph_cfg()
    params = llama.init_params(cfg, 0)
    draft = _moved(params, llama.init_params(cfg, 7))
    out, rate = {}, {}
    for graphs in (True, False):
        eng = _graph_engine(params, cfg, graphs,
                            speculative=(llama, cfg, draft), draft_k=3)
        out[graphs] = _serve_mix(eng, seed=2)
        assert eng.compile_stats() == {"admit": 1, "prefill": 1,
                                       "draft_prefill": 1, "draft": 1,
                                       "verify": 1}
        rate[graphs] = eng.metrics_summary()["spec_accept_rate"]
        assert 0.0 < rate[graphs] < 1.0
    plain = _serve_mix(_graph_engine(params, cfg, True), seed=2)
    assert [t for t, _ in out[True]] == [t for t, _ in out[False]]
    assert rate[True] == rate[False]
    greedy = [i for i in (0, 2, 3, 5)]
    assert [out[True][i][0] for i in greedy] == [plain[i][0] for i in greedy]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_host_tier_on_graphs_swaps_back_the_cold_tokens(cuda, kv_dtype):
    cfg = _graph_cfg()
    params = llama.init_params(cfg, 0)
    eng = _graph_engine(params, cfg, True, num_slots=2, max_len=64,
                        page_size=4, num_pages=18, host_tier_bytes=1 << 28,
                        kv_dtype=kv_dtype)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, 33).astype(np.int32)

    def serve(p):
        r = eng.submit(p, max_new_tokens=6)
        eng.run_until_idle()
        return r.tokens

    cold = serve(prompt)
    for _ in range(3):
        serve(rng.integers(0, 256, 33).astype(np.int32))
    assert eng.allocator.index.host_pages > 0
    assert serve(prompt) == cold
    assert eng.metrics.swap_in_pages > 0
    assert eng.compile_stats() == {"admit": 1, "prefill": 1, "decode": 1,
                                   "extract": 1, "install": 1}
    eng.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pod_shipments_on_the_card_match_the_cpu_programs(cuda, kv_dtype):
    """The pod's shipment path on the card: the captured extract, the
    device-side slice of the prompt pages and their copy to pinned host
    memory, then the captured install into a second card engine, against
    the same programs on the CPU over the same pool bytes: the host pages
    (bf16 as raw words; int8 codes and scales) and the installed pools,
    token registers and lengths are identical, and the host bytes are
    `page_bytes`. Each program captured once."""
    from accelerate_tpu_torch.serving.pod import PageTransport, \
        place_shipment

    cfg = _graph_cfg()
    params = llama.init_params(cfg, 0)
    cpu_params = params_from_numpy(params_to_numpy(params), device="cpu")
    kw = dict(num_slots=2, max_len=96, prefill_chunk=8, page_size=8,
              cache_dtype=torch.bfloat16, kv_dtype=kv_dtype)

    def engine(p, device):
        return Engine(llama, cfg, p, EngineConfig(**kw), device=device)

    card, host = engine(params, None), engine(cpu_params, "cpu")
    pages = {}
    card.on_admit = lambda slot, req: pages.__setitem__(
        req.request_id, list(slot.alloc.pages))
    rng = np.random.default_rng(4)
    reqs = [card.submit(rng.integers(0, 256, n).astype(np.int32),
                        max_new_tokens=2, key=7 + i)
            for i, n in enumerate((21, 37))]
    while not all(r.tokens for r in reqs):
        card.step()
    names = ("k", "v", "k_scale", "v_scale") if kv_dtype else ("k", "v")
    for name in names:
        getattr(host.cache, name).copy_(getattr(card.cache, name).cpu())
    dec_card, dec_host = engine(params, None), engine(cpu_params, "cpu")
    t_card, t_host = PageTransport(card), PageTransport(host)
    i_card, i_host = PageTransport(dec_card), PageTransport(dec_host)
    fields = ("k_pages", "v_pages", "k_scales", "v_scales")
    landed = []
    for r in reqs:
        ship = t_card.extract_shipment(pages[r.request_id], r)
        want = t_host.extract_shipment(pages[r.request_id], r)
        for f in fields:
            a, b = getattr(ship, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape, f
                assert a.tobytes() == b.tobytes(), f
        assert ship.page_bytes == sum(getattr(ship, f).nbytes
                                      for f in fields
                                      if getattr(ship, f) is not None)
        placed = place_shipment(dec_card, i_card, ship, 0.0)
        assert placed is not None
        landed.append(placed[0])
        assert place_shipment(dec_host, i_host, want, 0.0) is not None
    for name in names + ("lengths",):
        assert torch.equal(getattr(dec_card.cache, name).cpu(),
                           getattr(dec_host.cache, name)), name
    assert torch.equal(dec_card._tokens.cpu(), dec_host._tokens)
    assert torch.equal(dec_card._slot_keys.cpu(), dec_host._slot_keys)
    assert t_card.compile_stats() == {"extract": 1, "install": 0}
    assert i_card.compile_stats() == {"extract": 0, "install": 1}
    assert dec_card._graphs.capture_seconds().keys() >= {"ship_install"}
    dec_card.run_until_idle()
    assert [(r.status.value, len(r.tokens)) for r in landed] == \
        [("finished", 2)] * 2


def test_a_capture_that_fails_raises(cuda):
    """A program that reads a device value on the host cannot be
    captured: the runner raises naming it, and does not fall back."""
    from accelerate_tpu_torch.serving import GraphRunner

    runner = GraphRunner(cuda)
    x = runner.buffer("x", (4,), torch.float32)
    runner.upload("x", np.arange(4, dtype=np.float32))
    runner.add("syncs", lambda: x * float(x.sum()))
    with pytest.raises(RuntimeError, match="syncs"):
        runner("syncs")
    assert runner.captures() == {"syncs": 0}


def test_graph_runner_replays_on_fresh_inputs(cuda):
    from accelerate_tpu_torch.serving import GraphRunner

    runner = GraphRunner(cuda)
    x = runner.buffer("x", (3,), torch.int64)
    state = torch.zeros(3, dtype=torch.int64, device=cuda)

    def body():
        state.add_(x)
        return state * 2

    runner.add("acc", body)
    seen = []
    for i in range(4):
        runner.upload("x", np.full(3, i + 1, np.int64))
        seen.append(runner("acc").tolist())
    assert seen == [[2] * 3, [6] * 3, [12] * 3, [20] * 3]
    assert runner.captures() == {"acc": 1}


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


# f32: another f32 summation order; bf16/f16 against the plain version in
# f32: one rounding of the output and of P and dS before their products
_FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2),
              torch.float16: (4e-3, 4e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("S,mode", [(12, "causal"), (300, "window"),
                                    (200, "noncausal")])
@pytest.mark.parametrize("D", [8, 80, 256])
def test_flash_kernels_narrow_wide_and_f16_head_dims(cuda, dtype, S, mode,
                                                     D):
    """Head dims under 16, between the wgmma instances, and 256 (the
    CUDA-core path in every dtype), in f32, bf16 and f16: forward,
    LSE and gradients against the plain versions in f32."""
    g = torch.Generator(device=cuda).manual_seed(D * 1000 + S)
    B, H = 2, 2
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=cuda)
                   .to(dtype) for _ in range(4))
    causal = mode != "noncausal"
    window = 40 if mode == "window" else None
    launches = (tf.flash_forward.launches, tf.flash_backward_dq.launches,
                tf.flash_backward_dkv.launches)
    o, lse = tf.flash_forward(q, k, v, causal, None, window,
                              save_residuals=True)
    grads = tf.flash_backward(q, k, v, o, lse, do, causal, None, window)
    ro, rlse = tf.flash_forward_reference(q.float(), k.float(), v.float(),
                                          causal, None, window)
    ref = tf.flash_backward_reference(q.float(), k.float(), v.float(), ro,
                                      rlse, do.float(), causal, None, window)
    torch.cuda.synchronize()
    assert (tf.flash_forward.launches, tf.flash_backward_dq.launches,
            tf.flash_backward_dkv.launches) == tuple(n + 1 for n in launches)
    o_tol, g_tol = _FLASH_TOL[dtype]
    assert o.dtype == dtype
    torch.testing.assert_close(o.float(), ro, atol=o_tol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    for a, b in zip(grads, ref):
        assert a.dtype == dtype and bool(torch.isfinite(a.float()).all())
        assert _rel_l2(a, b) <= g_tol


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
    q = torch.zeros((1, 16, 2, 264), device=cuda)
    with pytest.raises(ValueError, match="up to 256"):
        tf.flash_forward(q, q, q, True)
    q = torch.zeros((1, 16, 2, 12), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="multiple of 8"):
        tf.flash_forward(q, q, q, True)
    q = torch.zeros((1, 16, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tf.flash_forward(q.double(), q.double(), q.double(), True)
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


def test_eager_loop_on_the_card_matches_cpu(cuda):
    """Three f32 steps of the reference's eager loop (prepare of params,
    adamw and a schedule; accumulate, compute_gradients, backward,
    clip_grad_norm_, the optimizer's and scheduler's step, zero_grad) on
    a tiny llama (head_dim 32, the flash kernels) on the card and with
    cpu=True: losses within 1e-5, params within 1e-4 (as the fused
    step's card test), and the flash kernels launched on the card."""
    cfg = llama.LlamaConfig.tiny(hidden_size=128, attention_backend="flash")
    init = params_to_numpy(llama.init_params(cfg, 0, device="cpu"))
    ids = np.random.default_rng(0).integers(0, 256, (4, 33)).astype(np.int32)
    results = []
    for cpu in (False, True):
        PartialState._reset_state()
        acc = Accelerator(cpu=cpu)
        params = acc.prepare(params_from_numpy(init, device="cpu"))
        opt = acc.prepare_optimizer(to.adamw(1e-3), params=params)
        sched = acc.prepare(to.constant_schedule(1e-3))
        launches = tf.flash_forward.launches
        losses = []
        for _ in range(3):
            with acc.accumulate():
                loss, grads = acc.compute_gradients(
                    lambda p, b: llama.causal_lm_loss(cfg, p, b),
                    opt.params, {"input_ids": ids})
                acc.backward(grads)
                acc.clip_grad_norm_(max_norm=1.0)
                opt.step()
                sched.step()
                opt.zero_grad()
            losses.append(float(loss))
        assert params["lm_head"]["kernel"].device.type == acc.device.type
        assert sched.count == 3
        if not cpu:
            assert tf.flash_forward.launches - launches == \
                3 * cfg.num_hidden_layers
        results.append((losses, to.tree_leaves(params_to_numpy(params))))
    PartialState._reset_state()
    (l_gpu, p_gpu), (l_cpu, p_cpu) = results
    np.testing.assert_allclose(l_gpu, l_cpu, atol=1e-5, rtol=0)
    for a, b in zip(p_gpu, p_cpu):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


# --- the model zoo -----------------------------------------------------------


def test_gptj_engine_at_head_dim_256_matches_the_cpu_engine(cuda):
    """GPT-J tiny widened to head dim 256 (GPT-J-6B's; one query head per
    KV head) under the default engine config: the paged kernel at D=256,
    G=1 on the card, the dense path on the CPU (f32 weights and pool):
    the same greedy streams."""
    cfg = gptj.GPTJConfig.tiny(hidden_size=1024, rotary_dim=64)
    assert cfg.head_dim == 256
    params = gptj.init_params(cfg, 0)
    host_params = params_from_numpy(params_to_numpy(params), device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 33, 12)]
    streams = []
    for ps, dev in ((params, None), (host_params, "cpu")):
        eng = Engine(gptj, cfg, ps, EngineConfig(cache_dtype=torch.float32),
                     device=dev)
        before = tp.paged_decode_attention.launches
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_idle()
        assert (tp.paged_decode_attention.launches > before) == (dev is None)
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.parametrize("moe_impl", ["dense", "sparse"])
def test_mixtral_step_on_the_card_matches_cpu(cuda, moe_impl):
    """Two f32 steps of a tiny Mixtral (head dim 32, the flash backend:
    K1a/b/c on the card, their plain versions on the CPU) through the
    Accelerator: losses within 1e-5, params within 1e-4 (as the llama
    step's test)."""
    cfg = mixtral.MixtralConfig.tiny(hidden_size=128, moe_impl=moe_impl,
                                     attention_backend="flash", remat=True)
    init = params_to_numpy(mixtral.init_params(cfg, 0, device="cpu"))
    ids = np.random.default_rng(0).integers(0, 256, (2, 65)).astype(np.int32)
    results = []
    for cpu in (False, True):
        PartialState._reset_state()
        acc = Accelerator(gradient_clipping=1.0, cpu=cpu)
        state = acc.prepare(TrainState.create(
            apply_fn=None, params=params_from_numpy(init, device=acc.device),
            tx=to.adamw(1e-3, weight_decay=0.0)))
        step = acc.train_step(lambda p, b: mixtral.causal_lm_loss(cfg, p, b))
        before = tf.flash_forward.launches
        losses = []
        for _ in range(2):
            state, m = step(state, {"input_ids": ids})
            losses.append(float(m["loss"]))
        assert (tf.flash_forward.launches > before) == (not cpu)
        results.append((losses, to.tree_leaves(
            params_to_numpy(state.params))))
    PartialState._reset_state()
    (l_gpu, p_gpu), (l_cpu, p_cpu) = results
    np.testing.assert_allclose(l_gpu, l_cpu, atol=1e-5, rtol=0)
    for a, b in zip(p_gpu, p_cpu):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


# --- checkpoints of a state on the card --------------------------------------


def _cuda_state(dev, n=1 << 16, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(n, generator=g).to(dev),
              "blk": {"h": torch.randn(64, 32, generator=g).bfloat16()
                      .to(dev)}}
    return TrainState.create(apply_fn=None, params=params,
                             tx=to.adamw(1e-3), use_loss_scale=True)


def _state_tensors(ts):
    from accelerate_tpu_torch.utils.other import flatten_dict

    return {**flatten_dict({"params": ts.params, "opt": ts.opt_state}),
            "scale": ts.loss_scale.scale,
            "tracker": ts.loss_scale.growth_tracker}


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_of_a_cuda_state_restores_in_place(cuda, async_save,
                                                      tmp_path):
    """A save and load of a TrainState on the card: every tensor comes
    back on the card, into the same storage, with the saved values."""
    from accelerate_tpu_torch import checkpointing as ckpt

    ts = _cuda_state(cuda)
    for t in _state_tensors(ts).values():
        t.copy_((torch.rand(t.shape, device=cuda) * 7).to(t.dtype))
    ts.step = 11
    saved = {k: v.clone() for k, v in _state_tensors(ts).items()}
    ckpt.save_accelerator_state(str(tmp_path), train_states=[ts], step=11,
                                async_save=async_save)
    ckpt.wait_for_checkpoints()
    for t in _state_tensors(ts).values():
        t.zero_()
    ts.step = 0
    live = _state_tensors(ts)
    ptrs = {k: v.data_ptr() for k, v in live.items()}
    out = ckpt.load_accelerator_state(str(tmp_path), train_states=[ts])
    assert out["step"] == 11 and ts.step == 11
    for k, v in _state_tensors(ts).items():
        assert v is live[k] and v.data_ptr() == ptrs[k]
        assert v.device.type == "cuda"
        assert torch.equal(v, saved[k]), k


def test_async_save_then_an_in_place_step_writes_the_pre_step_values(
        cuda, tmp_path):
    """The stage is ordered before the next step's writes: an async save
    followed at once by in-place steps (on a 1 GiB state, so the copy to
    the host takes milliseconds) still writes the values of the save's
    step."""
    from accelerate_tpu_torch import checkpointing as ckpt
    from accelerate_tpu_torch.utils import safetensors as st

    PartialState._reset_state()
    acc = Accelerator()
    ts = acc.prepare(TrainState.create(
        apply_fn=None, params={"w": torch.ones(1 << 26, device=cuda)},
        tx=to.adamw(1e-2)))
    step = acc.train_step(lambda p, b: (p["w"] * b).sum())
    b = torch.linspace(-1, 1, 1 << 26, device=cuda)
    ts, _ = step(ts, b)
    want = {k: v.cpu() for k, v in _state_tensors_plain(ts).items()}
    acc.save_state(str(tmp_path), state=ts, async_save=True)
    for _ in range(3):
        ts, _ = step(ts, b)
    acc.wait_for_checkpoints()
    got = st.load_file(str(tmp_path / "model_0.safetensors"))
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert not torch.equal(got["params.w"], ts.params["w"].cpu())
    PartialState._reset_state()


def _state_tensors_plain(ts):
    from accelerate_tpu_torch.utils.other import flatten_dict

    return flatten_dict({"params": ts.params, "opt_state": ts.opt_state})


def test_save_model_round_trip_at_full_width_is_bit_exact(cuda, tmp_path):
    """llama3-8B width, 2 layers: every param through save_model (index
    sharded at 2 GB) and load_model back onto the card, bit for bit."""
    from accelerate_tpu_torch import checkpointing as ckpt

    cfg = llama.LlamaConfig.llama3_8b(num_hidden_layers=2)
    params = llama.init_params(cfg, 0)
    from accelerate_tpu_torch.utils.other import flatten_dict

    ckpt.save_model(params, str(tmp_path), max_shard_size="2GB")
    back = flatten_dict(ckpt.load_model(str(tmp_path)))
    flat = flatten_dict(params)
    assert set(back) == set(flat)
    for key, a in flat.items():
        b = back[key]
        assert b.device.type == "cuda" and b.dtype == a.dtype, key
        assert torch.equal(a, b), key


def test_step_timer_tick_waits_for_the_card(cuda):
    """`tick(state)` returns only after the card has finished the work
    queued on the state's tensors."""
    from accelerate_tpu_torch.profiler import StepTimer

    x = torch.randn(4096, 4096, device=cuda)
    timer = StepTimer(warmup_steps=0)
    timer.tick()
    for _ in range(20):
        x = x @ x / 64
    timer.tick({"x": x})
    assert torch.cuda.current_stream().query()


# --- fp8 on the card -----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("T,D,O", [(64, 128, 96), (17, 40, 24), (3, 8, 5)])
def test_scaled_mm_products_match_the_plain_version(cuda, dtype, T, D, O):
    """`fp8_dense` forward, dX and dW through `_scaled_mm` on the card
    against the plain version on the same inputs (on the CPU), shapes that
    are not multiples of 16 included (T is dW's contracted dimension).
    The fp8 operands are the same bits and their products exact, but
    Hopper's fp8 tensor cores keep fewer bits in their partial sums than
    f32 between cuBLAS's promotions to f32 (measured on an H100: up to
    2e-4 of the largest element): f32 results within 1e-3 of the largest
    element, bf16 results within one bf16 rounding (2^-7 of it). One
    launch of each product."""
    from accelerate_tpu_torch.ops import fp8

    g = torch.Generator().manual_seed(T)
    x = torch.randn((T, D), generator=g).to(cuda, dtype)
    w = (torch.randn((D, O), generator=g) * 0.1).to(cuda, dtype)
    c = torch.randn((T, O), generator=g).to(cuda)
    meta = {r: fp8.update_meta(fp8.Fp8Meta.init(4, device=cuda),
                               torch.tensor(a, device=cuda))
            for r, a in (("x", 3.1), ("w", 0.27))}

    def run(dev):
        xg = x.to(dev).requires_grad_()
        wg = w.to(dev).requires_grad_()
        m = {r: fp8.Fp8Meta(*(t.to(dev) for t in v)) for r, v in meta.items()}
        with torch.enable_grad():
            out, new = fp8.fp8_dense(xg, wg, m)
            grads = torch.autograd.grad((out.float() * c.to(dev)).sum(),
                                        (xg, wg))
        return [t.detach().cpu() for t in (out, *grads)], new

    fp8.fp8_gemm.launches.update(fwd=0, dx=0, dw=0)
    card, new_card = run(cuda)
    assert fp8.fp8_gemm.launches == {"fwd": 1, "dx": 1, "dw": 1}
    plain, new_plain = run(torch.device("cpu"))
    assert [t.dtype for t in card] == [torch.bfloat16, dtype, dtype]
    for a, b, rel in zip(card, plain, (2.0 ** -7,) + (
            (1e-3,) * 2 if dtype == torch.float32 else (2.0 ** -7,) * 2)):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=rel * float(b.abs().max()))
    for r in ("x", "w"):
        assert torch.equal(new_card[r].scale.cpu(), new_plain[r].scale)


def test_fp8_dot_e5m2_and_expert_dense_on_the_card(cuda):
    """e5m2 by e5m2 (which `_scaled_mm` refuses; an f16 product with f32
    accumulation, 1e-5 of the largest element) and the per-expert loop
    (bf16 out, one bf16 rounding) on the card against the CPU's plain
    version."""
    from accelerate_tpu_torch.ops import fp8

    g = torch.Generator().manual_seed(0)
    x = torch.randn((20, 48), generator=g)
    w = torch.randn((48, 24), generator=g)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        m = (fp8.Fp8Meta.init(device=dev), fp8.Fp8Meta.init(device=dev))
        out, *_ = fp8.fp8_dot(x.to(dev), w.to(dev), *m,
                              out_dtype=torch.float32, fmt="E5M2")
        outs.append(out.cpu())
    torch.testing.assert_close(outs[0], outs[1], rtol=0,
                               atol=1e-5 * float(outs[1].abs().max()))
    xe = torch.randn((3, 20, 48), generator=g)
    we = torch.randn((3, 48, 24), generator=g) * 0.1
    outs = []
    for dev in (cuda, torch.device("cpu")):
        meta = {r: fp8.Fp8Meta.init(device=dev) for r in ("x", "w")}
        out, _ = fp8.fp8_expert_dense(xe.to(dev), we.to(dev), meta)
        outs.append(out.float().cpu())
    torch.testing.assert_close(outs[0], outs[1], rtol=0,
                               atol=2.0 ** -7 * float(outs[1].abs().max()))


@pytest.mark.parametrize("remat", [None, "dots", "full"])
def test_fp8_train_step_on_the_card_matches_cpu(cuda, remat):
    """Three fp8 steps of a tiny llama (head_dim 32, flash attention)
    through the Accelerator on the card and with cpu=True: losses within
    5e-3 (an fp8 rounding boundary turns an accumulation-order difference
    into a whole fp8 step), the first step's w metas bit-equal. On the
    card every projection goes through `_scaled_mm`: per step 7 products
    x 2 layers each of forward, dX and dW, plus the forward again under
    remat "full" (remat "dots" keeps its output)."""
    from accelerate_tpu_torch.ops import fp8

    kw = {} if remat is None else {"remat": True, "remat_policy": remat}
    cfg = llama.LlamaConfig.tiny(hidden_size=128, attention_backend="flash",
                                 **kw)
    init = params_to_numpy(llama.init_params(cfg, 0, device="cpu"))
    ids = np.random.default_rng(0).integers(0, 256, (4, 33)).astype(np.int32)
    results = []
    for cpu in (False, True):
        PartialState._reset_state()
        acc = Accelerator(mixed_precision="fp8", gradient_clipping=1.0,
                          cpu=cpu)
        state = acc.prepare(TrainState.create(
            apply_fn=None, params=params_from_numpy(init, device=acc.device),
            tx=to.adamw(1e-3),
            fp8_state=llama.init_fp8_state(cfg, device=acc.device)))
        step = acc.train_step(
            lambda p, b, fp8_state=None: llama.causal_lm_loss(
                cfg, p, b, fp8_state=fp8_state))
        fp8.fp8_gemm.launches.update(fwd=0, dx=0, dw=0)
        losses, metas = [], None
        for i in range(3):
            state, m = step(state, {"input_ids": ids})
            losses.append(float(m["loss"]))
            if i == 0:
                metas = params_to_numpy(_clone(state.fp8_state))
        results.append((losses, metas, dict(fp8.fp8_gemm.launches)))
    PartialState._reset_state()
    (l_gpu, m_gpu, n_gpu), (l_cpu, m_cpu, n_cpu) = results
    assert all(np.isfinite(l_gpu))
    np.testing.assert_allclose(l_gpu, l_cpu, atol=5e-3, rtol=0)
    per = 7 * cfg.num_hidden_layers * 3
    fwd = 2 * per if remat == "full" else per
    assert n_gpu == {"fwd": fwd, "dx": per, "dw": per}
    assert n_cpu == {"fwd": 0, "dx": 0, "dw": 0}
    for group in ("attn", "mlp"):
        for name, pair in m_gpu["layers"][group].items():
            other = m_cpu["layers"][group][name]["w"]
            np.testing.assert_array_equal(pair["w"].scale, other.scale)
            np.testing.assert_array_equal(pair["w"].amax_history,
                                          other.amax_history)


def _clone(tree):
    from accelerate_tpu_torch.training import clone_tree

    return clone_tree(tree)


@pytest.mark.parametrize("async_save", [False, True])
def test_fp8_checkpoint_of_a_cuda_state_restores_in_place(cuda, async_save,
                                                          tmp_path):
    """The fp8 metas of a state on the card save and load back into the
    same storage on the card."""
    from accelerate_tpu_torch import checkpointing as ckpt
    from accelerate_tpu_torch.utils.other import flatten_dict

    ts = _cuda_state(cuda)
    ts.fp8_state = llama.init_fp8_state(llama.LlamaConfig.tiny(),
                                        device=cuda)
    live = flatten_dict(ts.fp8_state)
    for t in live.values():
        t.copy_(torch.rand(t.shape, device=cuda) * 100)
    saved = {k: v.clone() for k, v in live.items()}
    ckpt.save_accelerator_state(str(tmp_path), train_states=[ts],
                                async_save=async_save)
    ckpt.wait_for_checkpoints()
    ptrs = {k: v.data_ptr() for k, v in live.items()}
    for t in live.values():
        t.zero_()
    ckpt.load_accelerator_state(str(tmp_path), train_states=[ts])
    for k, v in flatten_dict(ts.fp8_state).items():
        assert v is live[k] and v.data_ptr() == ptrs[k]
        assert v.device.type == "cuda" and torch.equal(v, saved[k]), k


# --- big-model inference ----------------------------------------------------


def _tiered_llama(dev, tmp_path, layers=4):
    """A tiny llama (f32, norm scales off one) and its dispatch over the
    card (embeddings, head, the first rows), pinned host memory and
    disk."""
    from accelerate_tpu_torch import big_modeling as bm

    cfg = llama.LlamaConfig.tiny(num_hidden_layers=layers)
    params = llama.init_params(cfg, 3, device=dev)
    params["norm"]["scale"].uniform_(0.5, 1.5)
    dmap = {"embed_tokens": 0, "norm": 0, "lm_head": 0}
    dmap.update({f"layers.{i}": 0 if i == 0 else (
        "cpu" if i < layers - 1 else "disk") for i in range(layers)})
    return cfg, params, bm.dispatch_model(params, dmap,
                                          offload_folder=str(tmp_path))


def test_row_groups_on_all_three_tiers(cuda, tmp_path):
    _, params, off = _tiered_llama(cuda, tmp_path)
    rg = off["layers"]["mlp"]["up_proj"]["kernel"]
    assert rg.tiers == ["device", "cpu", "disk"]
    (_, _, dev_rows), (_, _, host_rows), (_, _, disk_rows) = rg.groups
    assert dev_rows.is_cuda
    assert host_rows.device.type == "cpu" and host_rows.is_pinned()
    assert disk_rows.device.type == "cpu" and not disk_rows.is_pinned()
    for i in range(4):
        assert torch.equal(rg.row(i).to(cuda),
                           params["layers"]["mlp"]["up_proj"]["kernel"][i])


def test_streamed_forward_from_pinned_and_disk_rows_equals_resident(
        cuda, tmp_path):
    """The same products in the same order, the copies on a side stream:
    equal logits, and every streamed byte accounted for."""
    from accelerate_tpu_torch import big_modeling as bm

    cfg, params, off = _tiered_llama(cuda, tmp_path)
    ids = torch.randint(0, cfg.vocab_size, (2, 33), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    stats = bm.StreamStats()
    got = llama.forward_offloaded(cfg, off, ids, dtype=torch.float32,
                                  stats=stats)
    torch.testing.assert_close(got, llama.forward(cfg, params, ids),
                               rtol=0, atol=0)
    s = stats.summary()
    per_layer = sum(t[0].numel() * t.element_size() for t in
                    [v for v in _leaves(params["layers"])])
    assert s["layers"] == 4 and s["bytes"] == 3 * per_layer
    want = llama.generate(cfg, params, ids[:, :9], max_new_tokens=6)
    assert torch.equal(llama.streamed_generate(
        cfg, off, ids[:, :9], max_new_tokens=6, dtype=torch.float32), want)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_init_empty_weights_allocates_nothing_on_the_card(cuda):
    from accelerate_tpu_torch import big_modeling as bm

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tree = bm.init_empty_weights(llama.init_params,
                                 llama.LlamaConfig.llama3_8b(), 0)
    assert torch.cuda.memory_allocated() == before
    assert all(t.is_meta for t in _leaves(tree))


def test_quantized_load_on_the_card_matches_the_host(cuda, tmp_path):
    """The codes quantized on the host and moved to the card equal those
    of the same weights quantized on the card."""
    from accelerate_tpu_torch import big_modeling as bm
    from accelerate_tpu_torch.checkpointing import save_model
    from accelerate_tpu_torch.ops import quant
    from accelerate_tpu_torch.utils.dataclasses import QuantizationConfig

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, 1, device=cuda)
    save_model(params, str(tmp_path))
    got = bm.load_and_quantize_params(
        bm.init_empty_weights(llama.init_params, cfg, 0), str(tmp_path),
        QuantizationConfig(load_in_4bit=True, block_size=32))
    w = params["layers"]["mlp"]["down_proj"]["kernel"]
    on_card = quant.quantize(w, bits=4, block_size=32)
    have = got["layers"]["mlp"]["down_proj"]["kernel"]
    assert have.data.is_cuda
    assert torch.equal(have.data, on_card.data)
    assert torch.equal(have.scales.view(torch.int16),
                       on_card.scales.view(torch.int16))


def test_side_stream_prefetch_matches_host_batches_behind_a_long_kernel(
        cuda):
    """The prepared loader's copies run on a side stream. Depth 1 with
    32 MB batches read at once: a consumer that did not wait on a batch's
    event would read it half-copied. Depth 2 with a long kernel queued on
    the consumer stream before each read: without `record_stream`, the
    allocator could give a handed-out batch's memory to a later batch's
    copy, which runs at once on the idle side stream, before the queued
    read. Every batch read on the card equals the host's."""
    from accelerate_tpu_torch.data import DataLoaderShard

    PartialState._reset_state()
    rng = np.random.default_rng(0)
    host = [{"x": rng.integers(0, 1 << 30, (2048, 4096)).astype(np.int32)}
            for _ in range(6)]
    for depth, sleep_cycles in ((1, 0), (2, 50_000_000)):
        loader = DataLoaderShard(host, device=cuda,
                                 device_prefetch_depth=depth)
        got = []
        for batch in loader:
            assert batch["x"].is_cuda
            if sleep_cycles:
                torch.cuda._sleep(sleep_cycles)
            got.append(batch["x"].clone())
            del batch
        torch.cuda.synchronize()
        assert len(got) == len(host)
        for g, h in zip(got, host):
            np.testing.assert_array_equal(g.cpu().numpy(), h["x"])


def test_tracker_log_moves_card_scalars_in_one_transfer_per_dtype(cuda):
    from accelerate_tpu_torch import tracking

    values = {"loss": torch.tensor(0.5, device=cuda),
              "norm": torch.tensor(2.25, device=cuda),
              "bf": torch.tensor(1.5, device=cuda, dtype=torch.bfloat16),
              "step": torch.tensor(7, device=cuda), "host": 3.0}
    calls = []
    stack = torch.stack

    def spy(tensors, *a, **kw):
        calls.append(len(tensors))
        return stack(tensors, *a, **kw)

    torch.stack = spy
    try:
        out = tracking._scalarize_all(values)
    finally:
        torch.stack = stack
    assert out == {"loss": 0.5, "norm": 2.25, "bf": 1.5, "step": 7,
                   "host": 3.0}
    assert sorted(calls) == [1, 1, 2]


def test_tensor_parallel_serving_two_ranks_share_the_card(cuda):
    """Phase pod_tp's part (a) at the tiny width: `serve_llama_tp.py`
    launched as two processes sharing the card over gloo; both ranks'
    `sharded_engine` and `PodRouter(tensor_parallel=2)` streams equal
    process 0's one-process f32 engine's, greedy and sampled, and the
    meshed programs run uncaptured (their collectives pass through the
    host)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "accelerate_tpu_torch", "test_utils",
                          "scripts", "serve_llama_tp.py")
    proc = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.launch",
         "--num_processes", "2", script, "--config", "tiny", "--parts",
         "a", "--layers-a", "2"],
        capture_output=True, text=True, timeout=600, cwd=root)
    rows = sorted((json.loads(line.split(" ", 1)[1])
                   for line in proc.stdout.splitlines()
                   if line.startswith("TP_RESULT {")),
                  key=lambda r: r["rank"])
    assert proc.returncode == 0 and len(rows) == 2, proc.stderr[-4000:]
    single = rows[0]["single"]
    for r in rows:
        assert r["sharded"] == single and r["pod"] == single
        assert r["graphs_captured"] is False
        assert r["compile_stats"] == {"admit": 1, "prefill": 1, "decode": 1}


def _pipeline_stage_grads(stage_fn, blocks, x, dy):
    """Two stages run in turn as the 1F1B schedule runs them: the
    forwards without a tape, then each stage's forward recomputed from
    its input and pulled back, the last first. Returns (output, each
    stage's leaf gradients)."""
    with torch.no_grad():
        inputs = [x]
        for block in blocks[:-1]:
            inputs.append(stage_fn(block, inputs[-1]))
        y = stage_fn(blocks[-1], inputs[-1])
    grads = [None] * len(blocks)
    for s in reversed(range(len(blocks))):
        leaves = {k: v.detach().requires_grad_() for k, v in
                  _flat_leaves(blocks[s]).items()}
        xin = inputs[s].detach().requires_grad_(s > 0)
        with torch.enable_grad():
            out = stage_fn(_unflat_leaves(leaves), xin)
            got = torch.autograd.grad(
                out, list(leaves.values()) + ([xin] if s > 0 else []), dy)
        grads[s] = dict(zip(leaves, got[:len(leaves)]))
        if s > 0:
            dy = got[-1]
    return y, grads


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat_leaves(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def _unflat_leaves(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def test_pipeline_stages_through_flash_kernels(cuda):
    """Phase pipeline's stage body at its attention shape [1, 2048, 32,
    128] in bf16: two one-layer llama stages (llama3-8B's attention, a
    narrow MLP) run in turn, forward then the recomputing backward, with
    `attention_backend="flash"` launch K1a 4 times and K1b and K1c twice
    each, and give the output and every gradient of the same stages with
    the plain attention on the card (relative L2 2e-2: two bf16
    attention paths)."""
    import dataclasses

    from accelerate_tpu_torch.inference import make_stage_fn
    from accelerate_tpu_torch.models.common import rope_frequencies
    from accelerate_tpu_torch.parallel import stack_layers_into_stages

    base = llama.LlamaConfig.llama3_8b(num_hidden_layers=2,
                                       intermediate_size=1024,
                                       vocab_size=256)
    layers = llama.init_params(base, 0, dtype=torch.bfloat16,
                               device=cuda)["layers"]
    staged = stack_layers_into_stages(layers, 2)
    blocks = [{k: _sub(v, s) for k, v in staged.items()} for s in range(2)]
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1, 2048, 4096), generator=g, device=cuda).to(
        torch.bfloat16)
    dy = torch.randn((1, 2048, 4096), generator=g, device=cuda).to(
        torch.bfloat16)

    def stage_fn_for(backend):
        cfg = dataclasses.replace(base, attention_backend=backend)

        def layer(p, h):
            cos, sin = rope_frequencies(cfg.head_dim, h.shape[1],
                                        cfg.rope_theta, device=h.device)
            pos = torch.arange(h.shape[1], device=h.device)[None]
            return llama._layer_body(cfg, h, p, cos, sin, pos, None)[0]

        return make_stage_fn(layer)

    before = (tf.flash_forward.launches, tf.flash_backward_dq.launches,
              tf.flash_backward_dkv.launches)
    y, grads = _pipeline_stage_grads(stage_fn_for("flash"), blocks, x, dy)
    torch.cuda.synchronize()
    after = (tf.flash_forward.launches, tf.flash_backward_dq.launches,
             tf.flash_backward_dkv.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (4, 2, 2)
    y_ref, grads_ref = _pipeline_stage_grads(stage_fn_for("einsum"), blocks,
                                             x, dy)

    def rel(a, b):
        return float(torch.linalg.vector_norm((a - b).float())
                     / torch.linalg.vector_norm(b.float()))

    assert torch.isfinite(y).all() and rel(y, y_ref) <= 2e-2
    for s in range(2):
        for k, gr in grads[s].items():
            assert torch.isfinite(gr).all()
            assert rel(gr, grads_ref[s][k]) <= 2e-2, (s, k)


def _sub(tree, s):
    if isinstance(tree, dict):
        return {k: _sub(v, s) for k, v in tree.items()}
    return tree[s]


def _rand_bf16(g, dev, *shape):
    return torch.randn(shape, generator=g, device=dev).bfloat16()


def test_context_parallel_ring_chunk_pair_with_global_lse(cuda):
    """Phase context_parallel's ring at its chunk shape ([1, 2048, 32,
    128] bf16, two chunks): rank 1's diagonal chunk (causal K1a) and
    its off-diagonal chunk (non-causal K1a) folded by their log-sum-exp
    into the global output, within bf16 rounding of the plain attention
    over both chunks; then K1b and K1c on the off-diagonal pair from
    that GLOBAL output and LSE against their plain versions in f32 on
    the same inputs (within 2e-2 relative L2, the flash checks' bf16
    tolerance)."""
    from accelerate_tpu_torch.parallel.ring_attention import _fold

    g = torch.Generator(device=cuda).manual_seed(20)
    B, S, H, D = 1, 2048, 32, 128
    q1, k0, v0, k1, v1, do = (_rand_bf16(g, cuda, B, S, H, D)
                              for _ in range(6))
    o_d, lse_d = tf.flash_forward(q1, k1, v1, True, save_residuals=True)
    o_o, lse_o = tf.flash_forward(q1, k0, v0, False, save_residuals=True)
    ro_o, rlse_o = tf.flash_forward_reference(q1.float(), k0.float(),
                                              v0.float(), False)
    torch.testing.assert_close(o_o.float(), ro_o, atol=2e-2, rtol=0)
    torch.testing.assert_close(lse_o, rlse_o, atol=1e-3, rtol=0)
    out, lse = _fold(o_d.float(), lse_d, o_o, lse_o)
    # the plain attention of rank 1's queries over both chunks: every key
    # of chunk 0, chunk 1's causally
    keep = torch.ones((S, 2 * S), dtype=torch.bool, device=cuda)
    keep[:, S:] = torch.ones((S, S), device=cuda).tril().bool()
    scores = torch.einsum("bqhd,bkhd->bhqk", q1.float(),
                          torch.cat([k0, k1], 1).float()) / D ** 0.5
    scores = scores.masked_fill(~keep, -1e30)
    want = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1),
                        torch.cat([v0, v1], 1).float())
    assert _rel_l2(out, want) <= 1e-2
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1), atol=1e-3,
                               rtol=0)
    o = out.bfloat16()
    dq, delta = tf.flash_backward_dq(q1, k0, v0, o, lse.contiguous(), do,
                                     False)
    dk, dv = tf.flash_backward_dkv(q1, k0, v0, do, lse.contiguous(), delta,
                                   False)
    rdq, rdk, rdv = tf.flash_backward_reference(
        q1.float(), k0.float(), v0.float(), o.float(), lse, do.float(),
        False)
    for a, b in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert bool(torch.isfinite(a.float()).all())
        assert _rel_l2(a, b) <= 2e-2


def test_context_parallel_ulysses_shape_through_the_kernels(cuda):
    """Ulysses' full-sequence attention at phase context_parallel's
    shape after the head scatter ([1, 4096, 16, 128] bf16, causal): K1a
    and K1b/K1c against their plain versions in f32."""
    g = torch.Generator(device=cuda).manual_seed(21)
    q, k, v, do = (_rand_bf16(g, cuda, 1, 4096, 16, 128) for _ in range(4))
    o, lse = tf.flash_forward(q, k, v, True, save_residuals=True)
    ro, rlse = tf.flash_forward_reference(q.float(), k.float(), v.float(),
                                          True)
    torch.testing.assert_close(o.float(), ro, atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    grads, ref = _flash_grads(q, k, v, do, True, None, None)
    for a, b in zip(grads, ref):
        assert _rel_l2(a, b) <= 2e-2


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_context_parallel_one_process_runs_the_kernels(cuda, backend):
    """`attention_backend` ring or Ulysses in one process (no `seq`
    axis) at S=4096, head dim 128, GQA: each layer's attention is one
    K1a forward and one K1b + K1c backward, and the loss and gradients
    equal the flash backend's on the same params and batch."""
    import dataclasses

    cfg = llama.LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                                 num_key_value_heads=1,
                                 max_position_embeddings=4096,
                                 attention_backend=backend)
    params = llama.init_params(cfg, 0, dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(22)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (1, 4097),
                                        generator=g, device=cuda)}
    attn = params["layers"]["attn"]
    out = {}
    for name, c in ((backend, cfg), ("flash", dataclasses.replace(
            cfg, attention_backend="flash"))):
        for fn in (tf.flash_forward, tf.flash_backward_dq,
                   tf.flash_backward_dkv):
            fn.launches = 0
        with torch.enable_grad():
            # the gradients of the queries' and the keys' projections
            ws = [attn[n]["kernel"].detach().requires_grad_()
                  for n in ("q_proj", "k_proj")]
            ps = {**params, "layers": {**params["layers"], "attn": {
                **attn, "q_proj": {"kernel": ws[0]},
                "k_proj": {"kernel": ws[1]}}}}
            loss = llama.causal_lm_loss(c, ps, batch)
            grads = torch.autograd.grad(loss, ws)
        out[name] = (loss.detach(), grads, (tf.flash_forward.launches,
                                   tf.flash_backward_dq.launches,
                                   tf.flash_backward_dkv.launches))
    L = cfg.num_hidden_layers
    assert out[backend][2] == (L, L, L), out[backend][2]
    assert out["flash"][2] == (L, L, L)
    assert float(out[backend][0]) == float(out["flash"][0])
    for a, b in zip(out[backend][1], out["flash"][1]):
        assert torch.equal(a, b)


def test_train_step_on_a_seq_line_of_one_runs_the_kernels(cuda):
    """`Accelerator(context_parallel_plugin=ContextParallelPlugin(
    seq_degree=1))` in one process: a `seq` line of one, where the ring
    falls back to `flash_attention`. One fused bf16 `train_step` of
    llama with `attention_backend="ring"` launches K1a, K1b and K1c once
    a layer, and its loss and updated params equal the flash backend's
    step from the same state, bit for bit."""
    import dataclasses

    from accelerate_tpu_torch.utils.dataclasses import ContextParallelPlugin

    cfg = llama.LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                                 num_key_value_heads=1,
                                 max_position_embeddings=2048,
                                 attention_backend="ring")
    init = params_to_numpy(llama.init_params(cfg, 0, device=cuda))
    ids = np.random.default_rng(23).integers(0, cfg.vocab_size, (1, 2049))
    PartialState._reset_state()
    try:
        acc = Accelerator(mixed_precision="bf16", gradient_clipping=1.0,
                          context_parallel_plugin=ContextParallelPlugin(
                              seq_degree=1))
        assert acc.mesh.shape == {"data": 1, "seq": 1}
        out = {}
        for name, c in (("ring", cfg), ("flash", dataclasses.replace(
                cfg, attention_backend="flash"))):
            state = acc.prepare(TrainState.create(
                apply_fn=None, params=params_from_numpy(init, device=cuda),
                tx=to.adamw(1e-3)))
            step = acc.train_step(
                lambda p, b, c=c: llama.causal_lm_loss(c, p, b))
            for fn in (tf.flash_forward, tf.flash_backward_dq,
                       tf.flash_backward_dkv):
                fn.launches = 0
            state, m = step(state, {"input_ids": ids})
            out[name] = (float(m["loss"]), params_to_numpy(state.params),
                         (tf.flash_forward.launches,
                          tf.flash_backward_dq.launches,
                          tf.flash_backward_dkv.launches))
    finally:
        PartialState._reset_state()
    L = cfg.num_hidden_layers
    assert out["ring"][2] == (L, L, L), out["ring"][2]
    assert out["ring"][0] == out["flash"][0]
    for a, b in zip(to.tree_leaves(out["ring"][1]),
                    to.tree_leaves(out["flash"][1])):
        np.testing.assert_array_equal(a, b)


def test_context_parallel_two_ranks_share_the_card(cuda):
    """Phase context_parallel at the tiny width: `context_parallel_llama.py`
    launched as two processes sharing the card over gloo; the ring, the
    masked ring and Ulysses give both ranks the same loss and gradients,
    within bf16 rounding of one process's flash, with the ring's
    launches L(r+1) on rank r; the a2a MoE block drops nothing and
    matches one process's sort dispatch; the ring's planted chunk-delta
    fault reads beyond the gradient gate, and the ring with a pad past
    its first chunk matches one process's flash."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "accelerate_tpu_torch", "test_utils",
                          "scripts", "context_parallel_llama.py")
    proc = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.launch",
         "--num_processes", "2", script, "--config", "tiny"],
        capture_output=True, text=True, timeout=600, cwd=root)
    rows = [json.loads(line.split(" ", 1)[1])
            for line in proc.stdout.splitlines()
            if line.startswith("CP_RESULT {")]
    assert proc.returncode == 0 and len(rows) == 8, proc.stderr[-4000:]
    by = {(r["part"], r["rank"]): r for r in rows}
    for p in "abc":
        r0, r1 = by[(p, 0)], by[(p, 1)]
        assert r0["grad_digest"] == r1["grad_digest"]
        assert max(r0["grad_rel_l2"].values()) <= 2e-2
        assert abs(r0["loss"] - r0["ref_loss"]) <= 1e-3 * abs(r0["ref_loss"])
        for r in (r0, r1):
            per = r["layers"] * ((r["rank"] + 1) if p in "ab" else 1)
            assert r["launches"] == {"flash_fwd": per, "flash_bwd_dq": per,
                                     "flash_bwd_dkv": per}
    # the planted chunk-delta fault reads beyond the gradient gate; the
    # ring with a pad past its first chunk matches one process's flash
    assert max(by[("a", 0)]["fault_grad_rel_l2"].values()) > 2e-2
    for r in (by[("a", 0)], by[("a", 1)]):
        lp = r["ring_check"]["left_pad"]
        assert lp["finite"] and lp["o"] <= 2e-2
        assert max(lp["rel_l2"].values()) <= 2e-2
    d0 = by[("d", 0)]
    assert d0["dropped_fraction"] == 0.0 and d0["dispatch_calls"] == 1
    assert d0["finite"]
    assert max([d0["out_rel_l2"], *d0["grad_rel_l2"].values()]) <= 2e-2
