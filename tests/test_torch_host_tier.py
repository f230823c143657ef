"""The host KV tier in the port's engine against the JAX engine.

A pool too small for the traffic evicts a finished prompt's pages; the
tier keeps them in host memory and a later hit swaps them back in. On
the same converted f32 tiny-llama weights and the same request sequence
the port's engine swaps out and in the same number of pages, counts the
same host-tier hits, and returns the JAX engine's greedy tokens, which
are also those of an engine whose pool never evicts. int8 pools move
codes and scales verbatim: a page's bytes survive swap cycles unchanged.
Every port engine here runs with the sanitizer on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import Engine as JEngine
from accelerate_tpu.serving import EngineConfig as JConfig
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.serving import Engine, EngineConfig
from accelerate_tpu_torch.serving.scheduler import Request

BASE = dict(num_slots=2, max_len=64, prefill_chunk=8, page_size=4)
SMALL = dict(num_pages=18, host_tier_bytes=1 << 28)
PROGRAMS = {"admit": 1, "prefill": 1, "decode": 1, "extract": 1,
            "install": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    cfg_j = jl.LlamaConfig.tiny()
    pj = jl.init_params(cfg_j, jax.random.key(0))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return cfg_j, tl.LlamaConfig.tiny(), pj, pt


def _port(weights, **kw):
    _, cfg, _, pt = weights
    ec = dict(BASE, cache_dtype=torch.float32, sanitize=True, **SMALL)
    ec.update(kw)
    return Engine(tl, cfg, pt, EngineConfig(**ec), device="cpu")


def _jax(weights, **kw):
    cfg, _, pj, _ = weights
    ec = dict(BASE, cache_dtype=jnp.float32, **SMALL)
    ec.update(kw)
    return JEngine(jl, cfg, pj, JConfig(**ec))


def _prompt(rng, n, vocab=256):
    return rng.integers(0, vocab, (n,)).astype(np.int32)


def _serve(eng, prompt, budget=4):
    r = eng.submit(prompt, max_new_tokens=budget)
    eng.run_until_idle()
    assert r.status.value == "finished"
    return list(r.tokens)


def _round_trip(eng, seed=0, rounds=2):
    """Cold prompt, `rounds` fresh prompts that churn its pages out of
    the pool, the first prompt again: every request's tokens."""
    rng = np.random.default_rng(seed)
    prompt = _prompt(rng, 33)
    out = [_serve(eng, prompt, 6)]
    out += [_serve(eng, _prompt(rng, 33)) for _ in range(rounds)]
    out.append(_serve(eng, prompt, 6))
    return out


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_swap_round_trip_matches_jax_and_an_ample_pool(weights, kv_dtype):
    teng = _port(weights, kv_dtype=kv_dtype)
    jeng = _jax(weights, kv_dtype=kv_dtype)
    t, j = _round_trip(teng), _round_trip(jeng)
    ample = _round_trip(_port(weights, kv_dtype=kv_dtype, num_pages=None,
                              host_tier_bytes=0))
    assert t == j == ample
    assert t[-1] == t[0]
    tm, jm = teng.metrics, jeng.metrics
    assert (tm.swap_out_pages, tm.swap_in_pages, tm.prefix_hits_host,
            tm.prefix_hits) == (jm.swap_out_pages, jm.swap_in_pages,
                                jm.prefix_hits_host, jm.prefix_hits)
    assert tm.swap_in_pages > 0 and tm.prefix_hits_host >= 1
    assert tm.swap_out_pages >= tm.swap_in_pages
    assert teng.compile_stats() == PROGRAMS == jeng.compile_stats()
    teng.close()
    jeng.close()


def test_programs_built_once_across_swap_mixes(weights):
    """Cold miss, HBM hit, host hit, partial host hit: the same five
    programs, each built once."""
    eng = _port(weights)
    rng = np.random.default_rng(1)
    shared = _prompt(rng, 28)
    _serve(eng, shared, 3)                                    # cold
    _serve(eng, np.concatenate([shared, _prompt(rng, 5)]), 3)  # HBM hit
    for _ in range(3):
        _serve(eng, _prompt(rng, 33))
    _serve(eng, shared, 3)                                    # host hit
    for _ in range(3):
        _serve(eng, _prompt(rng, 33))
    _serve(eng, np.concatenate([shared, _prompt(rng, 5)]), 3)  # partial
    assert eng.metrics.swap_in_pages > 0
    assert eng.compile_stats() == PROGRAMS
    eng.close()


def _pages_bytes(eng, pages):
    c = eng.cache
    out = [c.k[:, pages].clone(), c.v[:, pages].clone()]
    if c.quantized:
        out += [c.k_scale[:, pages].clone(), c.v_scale[:, pages].clone()]
    return out


def test_int8_pages_are_bit_stable_over_swap_cycles(weights):
    """A prompt's full pages, swapped out and back in three times, land
    with exactly the codes and scales its cold prefill wrote."""
    eng = _port(weights, kv_dtype="int8", cache_dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    prompt = _prompt(rng, 33)
    cold = _serve(eng, prompt, 4)
    nodes = eng.allocator.index.match(prompt)
    assert len(nodes) == 8            # (33 - 1) // 4 full pages
    before = _pages_bytes(eng, [n.page for n in nodes])
    for _ in range(3):
        for _ in range(2):
            _serve(eng, _prompt(rng, 33))
        assert all(n.residency == "host" for n in eng.allocator.index.match(
            prompt))
        r = eng.submit(prompt, max_new_tokens=4)
        slot = next(s for s in eng.scheduler.slots if s.request is r)
        pages = slot.alloc.pages[:len(nodes)]
        after = _pages_bytes(eng, pages)
        for a, b in zip(after, before):
            assert torch.equal(a, b)
        eng.run_until_idle()
        assert list(r.tokens) == cold
    assert eng.metrics.swap_in_pages >= 3 * len(nodes)
    eng.close()


def test_full_tier_falls_back_to_destructive_eviction(weights):
    eng = _port(weights, host_tier_bytes=1)     # under one page: capacity 0
    assert eng._host_tier.capacity_pages == 0
    toks = _round_trip(eng, seed=3)
    assert eng._host_tier.rejected_pages > 0
    assert eng.allocator.index.host_pages == 0
    assert toks[-1] == toks[0]
    assert eng.metrics.swap_in_pages == 0
    assert eng.metrics.prefix_hits_host == 0
    eng.close()


def test_swap_in_racing_its_swap_out_waits_out_the_copy(weights):
    """With the drain thread stopped, no entry is ever materialized in
    the background: a swap-in finds its copy pending and waits it out
    itself, and still decodes the cold tokens."""
    eng = _port(weights)
    eng._host_tier._queue.put(None)
    eng._host_tier._drain.join(timeout=5.0)
    assert not eng._host_tier._drain.is_alive()
    rng = np.random.default_rng(4)
    prompt = _prompt(rng, 33)
    cold = _serve(eng, prompt)
    for _ in range(2):
        _serve(eng, _prompt(rng, 33))
    assert eng.allocator.index.host_pages > 0
    assert all(e.data is None for e in eng._host_tier._entries.values())
    assert _serve(eng, prompt) == cold
    assert eng.metrics.swap_in_pages > 0
    eng.close()


def test_backpressure_stalls_admission_not_eviction(weights):
    """When the drain queue cannot absorb an eviction's offers,
    allocate() returns None BEFORE evicting anything."""
    eng = _port(weights)
    rng = np.random.default_rng(5)
    _serve(eng, _prompt(rng, 33))
    alloc = eng.allocator
    cached = alloc.index.cached_pages
    assert cached > 0
    alloc.swap_stall = lambda need: True
    assert alloc.allocate(Request(prompt=_prompt(rng, 33),
                                  max_new_tokens=30)) is None
    assert alloc.index.cached_pages == cached
    assert eng._host_tier.swapped_out_pages == 0
    eng.close()


def test_rollback_reverts_swap_ins(weights):
    """An allocation that re-homed host-resident chunks but never
    admitted puts them back: residency host again, mirrors kept, pages
    returned; a later admission still swaps in the cold tokens."""
    eng = _port(weights)
    rng = np.random.default_rng(6)
    prompt = _prompt(rng, 33)
    cold = _serve(eng, prompt)
    for _ in range(2):
        _serve(eng, _prompt(rng, 33))
    alloc, tier = eng.allocator, eng._host_tier
    host_before, free_before = alloc.index.host_pages, alloc.pages_free
    out_before = tier.swapped_out_pages
    a = alloc.allocate(Request(prompt=prompt, max_new_tokens=4))
    new_out = tier.swapped_out_pages - out_before
    assert a is not None and a.swap_ins
    assert alloc.index.host_pages == host_before + new_out - len(a.swap_ins)
    alloc.rollback(a)
    assert alloc.index.host_pages == host_before + new_out
    assert alloc.pages_free >= free_before
    assert len(tier._entries) == alloc.index.host_pages
    assert _serve(eng, prompt) == cold
    eng.close()


def test_identical_prompts_cost_one_full_prefill_like_jax(weights):
    """In-flight dedup under the tier: four identical prompts pay one
    full prefill plus a final partial page each, as the JAX engine."""
    prompt = _prompt(np.random.default_rng(7), 17)

    def run(eng):
        reqs = [eng.submit(prompt.copy(), max_new_tokens=4)
                for _ in range(4)]
        eng.run_until_idle()
        return ([list(r.tokens) for r in reqs], eng.metrics.prefill_chunks,
                eng.metrics.prefix_dedup_hits)

    t = run(_port(weights, num_slots=4, num_pages=96))
    assert t == run(_jax(weights, num_slots=4, num_pages=96))
    assert t[1] == 6 and t[2] >= 1


def test_close_stops_the_drain_thread_and_later_evictions_destroy(weights):
    eng = _port(weights)
    eng.close()
    eng.close()                                   # idempotent
    assert not eng._host_tier._drain.is_alive()
    toks = _round_trip(eng, seed=8)
    assert toks[-1] == toks[0]
    assert eng.metrics.swap_out_pages == 0
    assert eng.debug_pages()["host_tier"]["rejected_pages"] > 0
