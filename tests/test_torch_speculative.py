"""Speculative decoding in the port's engine against the JAX engine.

A tiny Llama target and a tiny Llama draft that disagrees with it about
one time in four (so the rejection and correction paths run), the same
converted f32 weights in both packages. Greedy streams are byte-identical
to the JAX speculative engine's and to the port's plain engine's, the
accept count of every slot in every verify step equals the JAX engine's,
and logprobs agree within 1e-5 (f32 sums in another order). Sampled
acceptance cannot match JAX's threefry bits; the port's own rule is
pinned by the property it exists for: with a known target distribution
and a skewed draft, the committed tokens follow the target. Also here:
the tagged draws speculation takes from the port's counter hash."""

import dataclasses

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
from accelerate_tpu_torch.models.decode import derive_key, gumbel_noise, \
    uniform
from accelerate_tpu_torch.serving import Engine, EngineConfig, \
    RequestStatus

SPEC_PROGRAMS = {"admit": 1, "prefill": 1, "draft_prefill": 1, "draft": 1,
                 "verify": 1}
BASE = dict(num_slots=2, max_len=64, prefill_chunk=8, page_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """(jax config, torch config, {name: (jax params, torch params)}) for
    the target (seed 0) and the draft. Two independent tiny random
    models agree on almost no token (a seed-99 draft is accepted 0 times
    here), so the draft's weights are the target's moved a tenth of the
    way toward seed 99's: it agrees about three times in four, and both
    the accept and the correction paths run."""
    cfg_j = jl.LlamaConfig.tiny()
    target = jl.init_params(cfg_j, jax.random.key(0))
    other = jl.init_params(cfg_j, jax.random.key(99))
    draft = jax.tree_util.tree_map(lambda t, o: t + 0.1 * (o - t), target,
                                   other)
    out = {}
    for name, pj in (("target", target), ("draft", draft)):
        pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                               device="cpu")
        out[name] = (pj, pt)
    return cfg_j, tl.LlamaConfig.tiny(), out


def _port(models, draft="draft", **kw):
    _, cfg, w = models
    ec = dict(BASE, cache_dtype=torch.float32, sanitize=True)
    if draft is not None:
        ec.update(speculative=(tl, cfg, w[draft][1]), draft_k=4)
    ec.update(kw)
    return Engine(tl, cfg, w["target"][1], EngineConfig(**ec), device="cpu")


def _jax(models, draft="draft", **kw):
    cfg, _, w = models
    ec = dict(BASE, cache_dtype=jnp.float32)
    if draft is not None:
        ec.update(speculative=(jl, cfg, w[draft][0]), draft_k=4)
    ec.update(kw)
    return JEngine(jl, cfg, w["target"][0], JConfig(**ec))


def _record_accepts(engine):
    """Every slot's accept count, in order, as the engine reports them."""
    seen = []
    note = engine.metrics.note_speculation

    def spy(drafted, accepted):
        seen.append(int(accepted))
        note(drafted, accepted)

    engine.metrics.note_speculation = spy
    return seen


def _prompt(rng, n, vocab=256):
    return rng.integers(0, vocab, (n,)).astype(np.int32)


def _waves():
    """Staggered traffic: four prompts, then two sharing an 18-token
    prefix with the first wave's last, so they admit as prefix hits and
    the draft runs its catch-up chunks."""
    rng = np.random.default_rng(0)
    shared = _prompt(rng, 18)
    first = [_prompt(rng, n) for n in (5, 13, 9)]
    first.append(np.concatenate([shared, _prompt(rng, 3)]))
    return [first, [np.concatenate([shared, _prompt(rng, 4)])]]


def _run(engine, waves, budget=7, temps=None):
    out = []
    for wave in waves:
        reqs = [engine.submit(p, max_new_tokens=budget,
                              temperature=0.0 if temps is None else temps[i])
                for i, p in enumerate(wave)]
        engine.run_until_idle()
        assert all(r.status.value == "finished" for r in reqs)
        out += reqs
    return out


def test_greedy_speculation_matches_jax_and_the_plain_engine(models):
    teng, jeng = _port(models), _jax(models)
    t_acc, j_acc = _record_accepts(teng), _record_accepts(jeng)
    tr, jr = _run(teng, _waves()), _run(jeng, _waves())
    plain = _run(_port(models, draft=None), _waves())
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert [r.tokens for r in tr] == [r.tokens for r in plain]
    assert t_acc == j_acc
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-5)
    assert teng.compile_stats() == SPEC_PROGRAMS == jeng.compile_stats()
    ts, js = teng.metrics_summary(), jeng.metrics_summary()
    for key in ("prefill_chunks", "decode_steps", "tokens_out",
                "prefix_hit_rate", "spec_drafted_tokens",
                "spec_accepted_tokens"):
        assert ts[key] == js[key], key
    assert teng.metrics.prefix_hits >= 1
    # the disagreeing draft must disagree, or the correction never ran
    assert 0.0 < ts["spec_accept_rate"] < 1.0


def test_self_draft_accepts_everything(models):
    """The target drafting for itself: every proposal is accepted, more
    than 1.5 tokens land per verify step, and the stream is the plain
    engine's."""
    rng = np.random.default_rng(1)
    waves = [[_prompt(rng, n) for n in (5, 12)]]
    plain = _run(_port(models, draft=None), waves, budget=10)
    eng = _port(models, draft="target", draft_k=3)
    spec = _run(eng, waves, budget=10)
    assert [r.tokens for r in spec] == [r.tokens for r in plain]
    m = eng.metrics_summary()
    assert m["spec_accept_rate"] == 1.0
    assert m["tokens_per_decode_step"] > 1.5


def test_speculative_logprobs_match_the_plain_engine(models):
    rng = np.random.default_rng(14)
    wave = [[_prompt(rng, 7)]]
    plain = _run(_port(models, draft=None), wave, budget=6)[0]
    spec = _run(_port(models), wave, budget=6)[0]
    assert spec.tokens == plain.tokens
    np.testing.assert_allclose(spec.logprobs, plain.logprobs, atol=1e-5)


def _const_logits_forward(bias):
    """The port's llama forward with its logits replaced by a constant:
    the cache plumbing stays real, every draw is i.i.d. softmax(bias)."""
    bias = torch.tensor(bias, dtype=torch.float32)

    def fwd(config, params, input_ids, positions=None, kv_caches=None):
        logits, caches = tl.forward(config, params, input_ids,
                                    positions=positions, kv_caches=kv_caches)
        return bias.expand(logits.shape), caches

    return fwd


def test_sampled_accept_rule_preserves_the_target_distribution(models):
    """With a known constant target distribution and a draft skewed to a
    token the target (almost) never emits, the committed tokens still
    follow the target: accepted proposals plus residual corrections. A
    rule that commits proposals unconditionally floods token 0. Thresholds
    as the reference's test: 192 samples."""
    _, cfg, w = models
    V = cfg.vocab_size
    target_p = np.full((V,), 1e-12)
    target_p[1:5] = [0.4, 0.3, 0.2, 0.1]
    draft_p = np.full((V,), 1e-12)
    draft_p[0] = 0.5
    draft_p[1:5] = 0.125
    params = w["target"][1]
    eng = Engine(
        _const_logits_forward(np.log(target_p / target_p.sum())), cfg,
        params, EngineConfig(
            num_slots=4, max_len=32, prefill_chunk=8,
            cache_dtype=torch.float32, sanitize=True, draft_k=4,
            speculative=(_const_logits_forward(
                np.log(draft_p / draft_p.sum())), cfg, params)),
        device="cpu")
    rng = np.random.default_rng(2)
    samples = []
    for wave in range(4):
        reqs = [eng.submit(_prompt(rng, 4), max_new_tokens=12,
                           temperature=1.0, key=wave * 16 + i)
                for i in range(4)]
        eng.run_until_idle()
        assert all(r.status is RequestStatus.FINISHED for r in reqs)
        for r in reqs:
            samples.extend(r.tokens)
    counts = np.bincount(samples, minlength=V)
    freq = counts / counts.sum()
    assert freq[0] < 0.04, freq[:6]
    for tok, p in ((1, 0.4), (2, 0.3), (3, 0.2), (4, 0.1)):
        assert abs(freq[tok] - p) < 0.12, (tok, freq[tok], p)
    assert counts[5:].sum() == 0
    assert eng.metrics_summary()["spec_accept_rate"] < 0.8
    assert eng.compile_stats() == SPEC_PROGRAMS


@pytest.mark.parametrize("kv_dtype,draft_k", [(None, 3), ("int8", 3),
                                              ("int8", 2)])
def test_programs_built_once_across_int8_and_draft_k(models, kv_dtype,
                                                     draft_k):
    """Waves of other prompt lengths, budgets, temperatures and prefix
    hits, on a bf16 or int8 pool: the five programs, each built once."""
    rng = np.random.default_rng(3)
    shared = _prompt(rng, 18)
    eng = _port(models, max_len=48, cache_dtype=torch.bfloat16,
                kv_dtype=kv_dtype, draft_k=draft_k)
    for plen, budget, temp in ((3, 2, 0.0), (13, 1, 1.0),
                               ("shared", 2, 0.5)):
        if plen == "shared":
            prompts = [np.concatenate([shared, _prompt(rng, 2 + i)])
                       for i in range(2)]
        else:
            prompts = [_prompt(rng, plen) for _ in range(2)]
        reqs = [eng.submit(p, max_new_tokens=budget, temperature=temp)
                for p in prompts]
        eng.run_until_idle()
        assert all(r.status is RequestStatus.FINISHED for r in reqs)
        assert eng.compile_stats() == SPEC_PROGRAMS


def test_speculative_config_validation(models):
    _, cfg, w = models
    with pytest.raises(ValueError, match="draft_k"):
        _port(models, draft_k=0)
    with pytest.raises(ValueError, match="triple"):
        _port(models, speculative=tl)
    bad = dataclasses.replace(cfg, vocab_size=cfg.vocab_size + 1)
    with pytest.raises(ValueError, match="vocab_size"):
        _port(models, speculative=(tl, bad, w["draft"][1]))
    with pytest.raises(ValueError, match="paged_attention"):
        _port(models, paged_attention=True)
    # speculation on a tensor-parallel mesh: the reference's refusal
    from accelerate_tpu_torch.state import ProcessMesh

    with pytest.raises(ValueError, match="meshed engine"):
        _port(models, mesh=ProcessMesh({"model": 2}, device="cpu"))
    # "auto" resolves to the dense verify path instead of erroring
    assert not _port(models, paged_attention="auto")._use_paged_kernel


def test_fork_through_a_speculative_engine(models):
    """The verify commit writes only PRIVATE pages, so greedy forks
    through a speculative engine match the plain engine's and the JAX
    speculative engine's fork streams."""

    def run(eng):
        prompt = _prompt(np.random.default_rng(12), 24)
        parent = eng.submit(prompt, max_new_tokens=6)
        forks = [eng.fork(parent) for _ in range(2)]
        eng.run_until_idle()
        return [r.tokens for r in [parent] + forks], \
            eng.metrics.prefill_chunks

    spec, spec_chunks = run(_port(models, max_len=96, draft_k=3))
    plain, _ = run(_port(models, draft=None, max_len=96))
    ref, ref_chunks = run(_jax(models, max_len=96, draft_k=3))
    assert spec == plain == ref
    assert spec_chunks == ref_chunks


def test_catch_up_draft_length_survives_interleaved_decode(models):
    """A speculative step for OTHER slots must not clobber a
    mid-catch-up slot's draft length with the target's reused length:
    while a slot prefills, its draft length on the device IS its
    host-tracked draft_done (the sanitizer checks it every step too)."""
    eng = _port(models, draft="target", max_len=96)
    rng = np.random.default_rng(15)
    shared = _prompt(rng, 24)
    eng.submit(np.concatenate([shared, _prompt(rng, 4)]), max_new_tokens=4)
    eng.run_until_idle()          # retires: shared prefix pages cached
    r2 = eng.submit(_prompt(rng, 5), max_new_tokens=40)
    for _ in range(6):
        eng.step()                # r2 decoding when the hit arrives
    assert not r2.done
    r3 = eng.submit(np.concatenate([shared, _prompt(rng, 6)]),
                    max_new_tokens=12)
    slot3 = next(s for s in eng.scheduler.slots if s.request is r3)
    assert slot3.alloc.reused_len > 0
    checked = 0
    while slot3.request is r3 and slot3.prompt_done < r3.prompt_len:
        eng.step()                # alternates r3 catch-up / r2 decode
        if slot3.request is r3 and slot3.draft_done < slot3.prompt_done:
            assert int(eng._draft_cache.lengths[slot3.index]) \
                == slot3.draft_done
            checked += 1
    assert checked > 0
    eng.run_until_idle()
    assert r3.status is RequestStatus.FINISHED
    # a self-draft over uncorrupted state accepts everything
    assert eng.metrics_summary()["spec_accept_rate"] == 1.0


# ---------------------------------------------------------------------------
# tagged draws (models/decode.py)
# ---------------------------------------------------------------------------


def _keys():
    return torch.tensor([derive_key(0, 1), derive_key(7, 3), [0, 0]],
                        dtype=torch.int64)


def test_untagged_draws_keep_their_bits():
    """The values the untagged hash gave before tags existed: every
    greedy and sampled stream of the plain engine stays as it was. (rtol
    1e-6 covers libm's log on another CPU; a changed hash moves every
    value by order 1.)"""
    g = gumbel_noise(_keys(), torch.tensor([0, 5, 123456]), 8)[:, :4]
    want = [[-1.3462584018707275, 1.196282148361206, -1.3711553812026978,
             2.7044239044189453],
            [0.05585901439189911, 0.9719964861869812, 1.2728650569915771,
             -0.20623524487018585],
            [-1.352966547012329, -0.3780585825443268, 0.688340425491333,
             0.563310980796814]]
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6)
    assert torch.equal(gumbel_noise(_keys(), torch.tensor([0, 5, 123456]),
                                    8, tag=None)[:, :4], g)


def test_tags_give_independent_streams():
    """Each tag is its own stream at the same (key, position): no two of
    untagged/1/2/3 agree anywhere, their uniforms are uncorrelated, and a
    uniform is a pure function of (key, position, tag) with a uniform
    histogram."""
    keys = torch.tensor([derive_key(5, i) for i in range(64)],
                        dtype=torch.int64)
    pos = torch.arange(64)[:, None] + torch.arange(32)[None]
    draws = [uniform(keys, pos, tag) for tag in (None, 1, 2, 3)]
    for a in range(4):
        assert bool(((draws[a] > 0) & (draws[a] < 1)).all())
        for b in range(a):
            assert not bool((draws[a] == draws[b]).any())
            corr = np.corrcoef(draws[a].flatten(), draws[b].flatten())[0, 1]
            assert abs(corr) < 0.05, (a, b, corr)
    assert torch.equal(uniform(keys, pos, 2), draws[2])
    hist = np.histogram(draws[2].numpy(), bins=8, range=(0, 1))[0]
    assert hist.min() > 0.8 * hist.mean()
    noise = [gumbel_noise(keys[:4], pos[:4, 0], 4096, tag) for tag in (1, 3)]
    assert not bool((noise[0] == noise[1]).any())
