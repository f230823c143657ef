"""The port's serving engine against the JAX package's `Engine`.

The slice as a whole: on the same converted fp32 tiny-llama weights and
the same prompts, the port's `Engine(device="cpu")` gives greedy token
streams byte-identical to the JAX engine's, in both decode modes
(paged-decode op and dense gather), with logprobs within 1e-5 and equal
prefill-chunk and prefix-hit counts. Sampling cannot match JAX's
threefry bits; it is pinned by the property serving relies on instead:
a request's tokens are a function of (key, position) alone."""

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
from accelerate_tpu_torch.serving import (
    Engine,
    EngineConfig,
    RequestStatus,
)

BASE = dict(num_slots=2, max_len=64, prefill_chunk=8, page_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's thread pool costs more than it saves here,
    most of all with several test workers sharing the cores."""
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


def _waves(vocab=256):
    """The prompts of test_serving's GQA kernel test, plus two prompts
    sharing a 12-token prefix (longer than one 8-token page); the second
    arrives after the first retired, so it admits as a prefix hit."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n in (6, 13, 9, 4, 11)]
    shared = rng.integers(0, vocab, (12,)).astype(np.int32)
    a, b = (np.concatenate([shared, rng.integers(0, vocab, (n,)).astype(
        np.int32)]) for n in (3, 5))
    return [prompts + [a], [b]]


def _run(engine, waves, budget=6):
    out = []
    for wave in waves:
        reqs = [engine.submit(p, max_new_tokens=budget) for p in wave]
        engine.run_until_idle()
        assert all(r.status.value == "finished" for r in reqs)
        out += reqs
    return out


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("paged_attention", [True, False])
def test_greedy_streams_byte_identical_to_jax(weights, paged_attention,
                                              kv_dtype):
    cfg_j, cfg_t, pj, pt = weights
    kw = dict(BASE, paged_attention=paged_attention, kv_dtype=kv_dtype)
    jeng = JEngine(jl, cfg_j, pj, JConfig(cache_dtype=jnp.float32, **kw))
    teng = Engine(tl, cfg_t, pt, EngineConfig(cache_dtype=torch.float32,
                                              **kw), device="cpu")
    jr, tr = _run(jeng, _waves()), _run(teng, _waves())
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-5)
    js, ts = jeng.metrics_summary(), teng.metrics_summary()
    for key in ("prefill_chunks", "prefix_hit_rate", "decode_steps",
                "tokens_out", "prefix_tokens_reused"):
        assert ts[key] == js[key], key
    assert ts["prefix_hit_rate"] > 0
    path = "kernel" if paged_attention else "dense"
    assert teng.registry.counter("serving_decode_path_total",
                                 path=path).value == ts["decode_steps"]


def test_fork_shares_prompt_pages_like_jax(weights):
    cfg_j, cfg_t, pj, pt = weights
    prompt = np.random.default_rng(3).integers(0, 256, (30,)).astype(
        np.int32)

    def run(engine):
        parent = engine.submit(prompt, max_new_tokens=4)
        kids = [engine.fork(parent) for _ in range(2)]
        engine.run_until_idle()
        return [r.tokens for r in [parent, *kids]], \
            engine.metrics.prefill_chunks

    jt, jc = run(JEngine(jl, cfg_j, pj, JConfig(cache_dtype=jnp.float32,
                                                **BASE)))
    tt, tc = run(Engine(tl, cfg_t, pt, EngineConfig(
        cache_dtype=torch.float32, **BASE), device="cpu"))
    assert tt == jt and tc == jc
    assert tc < 3 * 4  # three cold prefills of 30 tokens would be 12


def _sampled(engine, prompts, keys, order, together):
    reqs = {}
    if together:
        for i in order:
            reqs[i] = engine.submit(prompts[i], max_new_tokens=8,
                                    temperature=0.8, key=keys[i])
        engine.run_until_idle()
    else:
        for i in order:
            reqs[i] = engine.submit(prompts[i], max_new_tokens=8,
                                    temperature=0.8, key=keys[i])
            engine.run_until_idle()
    return [reqs[i].tokens for i in sorted(reqs)]


@pytest.mark.parametrize("paged_attention", [True, False])
def test_sampled_streams_depend_only_on_key_and_position(weights,
                                                         paged_attention):
    """The same keyed requests run interleaved in one engine, or one at
    a time in another order, sample the same tokens; another key samples
    another stream."""
    _, cfg_t, _, pt = weights
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 17, 9)]
    keys = [101, 202, 303]

    def engine(**kw):
        return Engine(tl, cfg_t, pt, EngineConfig(
            cache_dtype=torch.float32, **dict(BASE, num_slots=3, **kw)),
            device="cpu")

    together = _sampled(engine(paged_attention=paged_attention), prompts,
                        keys, [0, 1, 2], together=True)
    alone = _sampled(engine(paged_attention=paged_attention), prompts, keys,
                     [2, 0, 1], together=False)
    assert together == alone
    other = _sampled(engine(), prompts, [7, 8, 9], [0, 1, 2], together=True)
    assert other != together


def test_engine_needs_a_gpu_unless_asked_for_the_cpu(weights, monkeypatch):
    _, cfg_t, _, pt = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(tl, cfg_t, pt, EngineConfig(**BASE))


def test_engine_rejects_params_on_another_device(weights):
    _, cfg_t, _, pt = weights
    with pytest.raises(ValueError, match="params live on"):
        Engine(tl, cfg_t, {"x": torch.empty(1, device="meta")},
               EngineConfig(**BASE), device="cpu")


def test_auto_decode_path_is_dense_on_the_cpu(weights):
    _, cfg_t, _, pt = weights
    eng = Engine(tl, cfg_t, pt, EngineConfig(cache_dtype=torch.float32,
                                             **BASE), device="cpu")
    _run(eng, [[np.arange(5, dtype=np.int32)]], budget=3)
    assert eng.registry.counter("serving_decode_path_total",
                                path="dense").value == 2


def test_metrics_summary_keys_like_jax(weights):
    """The default engine of each package (sampling every 16th program
    call, a serving StepTimer) serves the same requests with the same
    weights: the port's summary holds every key of the reference's, the
    device times, rooflines, goodput and host dispatch included. Values
    are clock readings and are not compared."""
    cfg_j, cfg_t, pj, pt = weights
    jeng = JEngine(jl, cfg_j, pj, JConfig(cache_dtype=jnp.float32, **BASE))
    teng = Engine(tl, cfg_t, pt, EngineConfig(cache_dtype=torch.float32,
                                              **BASE), device="cpu")
    for eng in (jeng, teng):
        _run(eng, _waves(), budget=6)
    want = set(jeng.metrics_summary())
    assert {"decode_device_time_mean_ms", "decode_mfu", "goodput",
            "host_dispatch_us_mean"} <= want
    assert want <= set(teng.metrics_summary())
    jeng.close()
    teng.close()


@pytest.mark.parametrize("field,value", [
    ("mesh", object()),
    ("strict", "error"),
    ("contracts", {}),
    ("metrics_port", 0),
    ("watchdog_timeout_s", 30.0),
    ("cost_sample_every", 4),
    ("incident_dir", "incidents"),
])
def test_unported_config_fields_raise(weights, field, value):
    """`strict` and `contracts` still raise, naming themselves. `mesh`
    is taken: an object with no `size` is a mesh of one, which is
    single-device serving (normalised to None, as the reference does;
    tensor-parallel meshes are tests/test_torch_pod_mesh.py's). The
    telemetry fields construct: the exporter binds an ephemeral port,
    the watchdog runs, the cost table takes the cadence, the incident
    directory is kept; `close()` stops the threads."""
    _, cfg_t, _, pt = weights
    if field == "mesh":
        eng = Engine(tl, cfg_t, pt, EngineConfig(**BASE, mesh=value),
                     device="cpu")
        assert eng.engine_config.mesh is None
        assert eng.cache_shardings is None
        return
    if field in ("strict", "contracts"):
        with pytest.raises(NotImplementedError, match=field):
            Engine(tl, cfg_t, pt, EngineConfig(**BASE, **{field: value}),
                   device="cpu")
        return
    eng = Engine(tl, cfg_t, pt, EngineConfig(**BASE, **{field: value}),
                 device="cpu")
    try:
        if field == "metrics_port":
            assert eng.metrics_server.port > 0
        elif field == "watchdog_timeout_s":
            assert eng.watchdog.timeout_s == value
            assert eng.watchdog._thread.is_alive()
        elif field == "cost_sample_every":
            assert eng.cost.sample_every == value
        else:
            assert eng.watchdog is None
            assert eng.engine_config.incident_dir == value
    finally:
        eng.close()
    assert eng.metrics_server is None and eng.watchdog is None


def test_overload_rejects_and_cancel_and_finish(weights):
    _, cfg_t, _, pt = weights
    eng = Engine(tl, cfg_t, pt, EngineConfig(
        cache_dtype=torch.float32, max_queue=1, **BASE), device="cpu")
    too_long = eng.submit(np.zeros(70, np.int32), max_new_tokens=2)
    assert too_long.status is RequestStatus.REJECTED
    running = [eng.submit(np.arange(9, dtype=np.int32) + i,
                          max_new_tokens=20) for i in range(2)]
    queued = eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)
    shed = eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)
    assert shed.status is RequestStatus.REJECTED and shed.shed_code
    for _ in range(4):
        eng.step()
    assert eng.cancel(queued) and queued.status is RequestStatus.CANCELLED
    assert eng.finish(running[0])
    eng.run_until_idle()
    assert running[0].status is RequestStatus.FINISHED
    assert len(running[1].tokens) == 20
    summary = eng.metrics_summary()
    assert summary["requests_rejected"] == 2
    assert summary["requests_cancelled"] == 1
    assert summary["pages_capacity"] == eng.cache.num_pages


# ---------------------------------------------------------------------------
# the engine's programs and surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("paged_attention", [True, False])
def test_programs_built_once_across_a_request_mix_like_jax(
        weights, paged_attention, kv_dtype):
    """Cold and hit admissions, forks, a cancel mid-decode, greedy and
    sampled: admit, prefill and decode are each built once, as the JAX
    engine compiles each once."""
    cfg_j, cfg_t, pj, pt = weights
    kw = dict(BASE, paged_attention=paged_attention, kv_dtype=kv_dtype)

    def drive(eng):
        rng = np.random.default_rng(21)
        parent = eng.submit(rng.integers(0, 256, 20).astype(np.int32),
                            max_new_tokens=5)
        kid = eng.fork(parent, temperature=0.7)
        victim = eng.submit(rng.integers(0, 256, 9).astype(np.int32),
                            max_new_tokens=30)
        for _ in range(6):
            eng.step()
        eng.cancel(victim)
        eng.run_until_idle()
        return [parent.tokens, len(kid.tokens)], eng.compile_stats()

    (jt, js), (tt, ts) = (
        drive(JEngine(jl, cfg_j, pj, JConfig(cache_dtype=jnp.float32, **kw))),
        drive(Engine(tl, cfg_t, pt, EngineConfig(
            cache_dtype=torch.float32, sanitize=True, **kw), device="cpu")))
    assert tt == jt
    assert ts == js == {"admit": 1, "prefill": 1, "decode": 1}


def test_astream_interleaves_two_requests_like_stream(weights):
    import asyncio

    _, cfg_t, _, pt = weights
    prompts = [np.arange(5, dtype=np.int32), np.arange(11, dtype=np.int32)]

    def engine():
        return Engine(tl, cfg_t, pt, EngineConfig(
            cache_dtype=torch.float32, sanitize=True, **BASE), device="cpu")

    eng = engine()
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]

    async def collect(req):
        return [tok async for tok in eng.astream(req)]

    async def both():
        return await asyncio.gather(*(collect(r) for r in reqs))

    streamed = asyncio.run(both())
    ref = engine()
    want = [ref.submit(p, max_new_tokens=6) for p in prompts]
    ref.run_until_idle()
    assert streamed == [r.tokens for r in want]
    assert all(len(t) == 6 for t in streamed)


def test_debug_views_match_jax(weights):
    """debug_requests/slots/pages/scheduler mid-flight, after the same
    steps: the JAX engine's entries, less the request ages."""
    cfg_j, cfg_t, pj, pt = weights
    prompt = np.random.default_rng(11).integers(0, 256, 24).astype(np.int32)

    def views(eng):
        parent = eng.submit(prompt, max_new_tokens=8)
        fork = eng.fork(parent)
        eng.step()
        out = (eng.debug_requests(), eng.debug_slots(), eng.debug_pages(),
               eng.debug_scheduler())
        by_id = {e["request_id"]: e
                 for e in out[0]["running"] + out[0]["queued"]}
        assert by_id[parent.request_id]["fork_parent"] is True
        assert by_id[fork.request_id]["forked_from"] == parent.request_id
        eng.run_until_idle()
        for entry in out[0]["running"] + out[0]["queued"]:
            entry.pop("age_s")
            entry.pop("trace_id")
            entry.pop("request_id")
            entry.pop("forked_from", None)
        for entry in out[1]:
            entry.pop("trace_id", None)
            entry.pop("request_id", None)
        return out

    kw = dict(BASE, max_len=96)
    j = views(JEngine(jl, cfg_j, pj, JConfig(cache_dtype=jnp.float32, **kw)))
    t = views(Engine(tl, cfg_t, pt, EngineConfig(cache_dtype=torch.float32,
                                                 **kw), device="cpu"))
    assert t[0] == j[0] and t[1] == j[1] and t[2] == j[2]
    assert t[3].keys() == j[3].keys()


def test_reset_metrics_keeps_programs_pages_and_requests(weights):
    _, cfg_t, _, pt = weights
    eng = Engine(tl, cfg_t, pt, EngineConfig(
        cache_dtype=torch.float32, sanitize=True, **BASE), device="cpu")
    first = eng.submit(np.arange(12, dtype=np.int32), max_new_tokens=3)
    eng.run_until_idle()
    live = eng.submit(np.arange(7, dtype=np.int32), max_new_tokens=5)
    eng.step()
    before = eng.compile_stats()
    eng.reset_metrics()
    summary = eng.metrics_summary()
    assert summary["requests_finished"] == 0
    assert summary["prefill_chunks"] == 0
    assert eng.scheduler.step_time_ema == 0.0
    assert eng.registry.gauge("serving_pages_in_use").value \
        == eng.allocator.pages_in_use > 0
    eng.run_until_idle()
    assert live.status is RequestStatus.FINISHED and len(live.tokens) == 5
    assert first.status is RequestStatus.FINISHED
    assert eng.compile_stats() == before
    assert eng.metrics_summary()["requests_finished"] == 1
    assert eng.metrics_summary()["compiles_decode"] == 1.0
    eng.close()
