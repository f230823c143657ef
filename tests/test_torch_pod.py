"""The port's disaggregated pod (`accelerate_tpu_torch.serving.pod`)
against the JAX package's `PodRouter` and against the port's single
engine.

On the same converted fp32 tiny weights (gpt2 and llama), the port's pod
gives greedy streams byte-identical to the JAX pod's, and greedy and
sampled streams byte-identical to the port's single engine (a request
keeps the single engine's key, and a draw depends only on key and
position). The reference's pod contracts run on the port as they run on
the JAX package: budget-one and EOS finishing at prefill, the worker-drop
shed code, backpressure stalling the router, cancel/finish in every
phase, rejects and sheds, int8 shipments, logprobs riding shipments, the
HTTP front door over a pod; its debug views, span names and metric
series equal the JAX router's; layer 1 (mesh serving) refuses naming
queue 1 item 6b; `check_router` catches corrupted books."""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import gpt2 as jg
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import EngineConfig as JConfig
from accelerate_tpu.serving.pod import KVPageShipment as JShipment
from accelerate_tpu.serving.pod import PodConfig as JPodConfig
from accelerate_tpu.serving.pod import PodEngine as JPod
from accelerate_tpu_torch.models import gpt2 as tg
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.serving import Engine, EngineConfig, RequestStatus
from accelerate_tpu_torch.serving.pod import (
    KVPageShipment,
    PodConfig,
    PodEngine,
    PodRouter,
    cache_state_shardings,
    shard_params,
    sharded_engine,
    tensor_mesh,
)
from accelerate_tpu_torch.serving.pod.transfer import BF16_WORDS
from accelerate_tpu_torch.serving.sanitizer import (
    SanitizerViolation,
    check_router,
)
from accelerate_tpu_torch.serving.scheduler import SHED_WORKER_DROP

BASE = dict(num_slots=3, max_len=64, prefill_chunk=8)
FAMILIES = {"gpt2": (jg, tg, "GPT2Config"), "llama": (jl, tl, "LlamaConfig")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(name):
    jm, tm, cname = FAMILIES[name]
    cfg_j = getattr(jm, cname).tiny()
    pj = jm.init_params(cfg_j, jax.random.key(0))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return jm, tm, cfg_j, getattr(tm, cname).tiny(), pj, pt


@pytest.fixture(scope="module")
def gpt2_setup():
    _jm, _tm, _cj, cfg, _pj, params = _weights("gpt2")
    return cfg, params


def _ec(**overrides):
    return EngineConfig(**dict(BASE, cache_dtype=torch.float32,
                               sanitize=True, **overrides))


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in (5, 11, 3, 17)]


def _run_trace(engine, vocab, budgets=(6, 6, 4, 4),
               temps=(0.0, 0.7, 0.0, 1.1)):
    """Seeded staggered mix, identical for every engine flavor (the
    reference's test trace)."""
    prompts = _prompts(vocab)
    reqs = [engine.submit(prompts[0], max_new_tokens=budgets[0],
                          temperature=temps[0])]
    for _ in range(3):
        engine.step()
    for p, b, t in zip(prompts[1:], budgets[1:], temps[1:]):
        reqs.append(engine.submit(p, max_new_tokens=b, temperature=t))
    engine.run_until_idle()
    return reqs


def _series(registry):
    return {(name, dict(labels).get("role"))
            for _kind, name, labels, _m in registry.items()
            if name.startswith("serving_pod_")}


def _shape(tree):
    """Keys (recursively) of a JSON-like debug view, values dropped."""
    if isinstance(tree, dict):
        return {k: _shape(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shape(tree[0])] if tree else []
    return None


def _views(pod):
    return {"pod": pod.debug_pod(), "slots": pod.debug_slots(),
            "pages": pod.debug_pages(), "scheduler": pod.debug_scheduler(),
            "requests": pod.debug_requests()}


def _traced_run(pod_cls, trace_mod, engine_config, pod_config, family, cfg,
                params, **kw):
    """One greedy request through a fresh pod with tracing on: (tokens,
    span names of its trace, the page_transfer span's attrs, pod)."""
    trace_mod.configure_tracing(enabled=True, annotate=False,
                                default_sample_rate=1.0)
    try:
        pod = pod_cls(family, cfg, params, engine_config, pod_config, **kw)
        prompt = np.random.default_rng(23).integers(
            0, cfg.vocab_size, (9,)).astype(np.int32)
        r = pod.submit(prompt, max_new_tokens=4)
        pod.run_until_idle()
        names = sorted({e["name"] for e in trace_mod.trace_events(
            r.trace_id)})
        hop = next(e for e in trace_mod.trace_events(r.trace_id)
                   if e["name"] == "serving.page_transfer")
        return r.tokens, names, hop["attrs"], pod
    finally:
        trace_mod.configure_tracing(enabled=False, sample_rates={},
                                    default_sample_rate=1.0)
        trace_mod.clear_flight_recorder()


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX pod run the tests compare against, run once: greedy
    traces for gpt2 and llama, plus the gpt2 pod's debug views, metric
    series and one traced request's span names."""
    from accelerate_tpu.telemetry import trace as jtrace

    out = {}
    for name in FAMILIES:
        jm, tm, cfg_j, cfg_t, pj, pt = _weights(name)
        pod = JPod(jm, cfg_j, pj, JConfig(cache_dtype=jnp.float32, **BASE),
                   JPodConfig(prefill_workers=1, decode_workers=2))
        reqs = _run_trace(pod, cfg_j.vocab_size, temps=(0.0,) * 4)
        out[name] = {"tokens": [r.tokens for r in reqs],
                     "logprobs": [r.logprobs for r in reqs],
                     "weights": (tm, cfg_t, pt)}
        if name == "gpt2":
            out["views"] = _views(pod)
            out["series"] = _series(pod.registry)
            out["compile_stats"] = pod.compile_stats()
            out["summary_keys"] = set(pod.metrics_summary())
    _jm, _tm, cfg_j, _ct, pj, _pt = _weights("gpt2")
    jtok, jnames, jhop, _ = _traced_run(
        JPod, jtrace, JConfig(cache_dtype=jnp.float32, **BASE),
        JPodConfig(), jg, cfg_j, pj)
    out["traced"] = (jtok, jnames, jhop)
    return out


# ---------------------------------------------------------------------------
# config and shipment units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs,match", [
    (dict(prefill_workers=0), "at least one worker"),
    (dict(decode_workers=0), "at least one worker"),
    (dict(tensor_parallel=0), "tensor_parallel"),
])
def test_pod_config_validates_like_jax(kwargs, match):
    with pytest.raises(ValueError, match=match) as theirs:
        JPodConfig(**kwargs)
    with pytest.raises(ValueError, match=match) as ours:
        PodConfig(**kwargs)
    assert str(ours.value) == str(theirs.value)
    assert PodConfig() == PodConfig(prefill_workers=1, decode_workers=1,
                                    prefill_slots=None, tensor_parallel=1,
                                    max_pending_shipments=None)


def _ship_kwargs():
    return dict(prompt=np.arange(20, dtype=np.int32), first_token=1,
                n_prompt_pages=2, key_raw=np.zeros((2,), np.uint32),
                temperature=0.0, max_new_tokens=4, eos_token_id=None)


def test_shipment_page_bytes_counts_prompt_pages_only():
    pages = np.zeros((1, 5, 8, 2, 4), np.float32)
    ours = KVPageShipment(k_pages=pages, v_pages=pages, **_ship_kwargs())
    theirs = JShipment(k_pages=pages, v_pages=pages, **_ship_kwargs())
    assert ours.page_bytes == theirs.page_bytes == 2 * (2 * 8 * 2 * 4 * 4)
    # the port ships only the prompt pages: the same count either way
    trimmed = KVPageShipment(k_pages=pages[:, :2], v_pages=pages[:, :2],
                             **_ship_kwargs())
    assert trimmed.page_bytes == ours.page_bytes


def test_shipment_page_bytes_halve_under_int8():
    """int8 page bytes are the codes (half of bf16) plus the scale
    blocks, (D+2)/2D of a bf16 shipment, as in the JAX package (whose
    bf16 is an ml_dtypes array; the port's is raw 16-bit words)."""
    import ml_dtypes

    L, P, ps, H, D = 1, 5, 8, 2, 4
    words = np.zeros((L, P, ps, H, D), np.uint16).view(BF16_WORDS)
    sc = np.zeros((L, P, ps, H), np.uint16).view(BF16_WORDS)
    i8 = np.zeros((L, P, ps, H, D), np.int8)
    bf = KVPageShipment(k_pages=words, v_pages=words, **_ship_kwargs())
    q = KVPageShipment(k_pages=i8, v_pages=i8, k_scales=sc, v_scales=sc,
                       **_ship_kwargs())
    assert q.page_bytes / bf.page_bytes == (D + 2) / (2 * D)
    jw = np.zeros((L, P, ps, H, D), ml_dtypes.bfloat16)
    js = np.zeros((L, P, ps, H), ml_dtypes.bfloat16)
    assert JShipment(k_pages=jw, v_pages=jw,
                     **_ship_kwargs()).page_bytes == bf.page_bytes
    assert JShipment(k_pages=i8, v_pages=i8, k_scales=js, v_scales=js,
                     **_ship_kwargs()).page_bytes == q.page_bytes


# ---------------------------------------------------------------------------
# streams: the JAX pod and the port's single engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(FAMILIES))
def test_greedy_pod_streams_byte_identical_to_jax_pod(jax_side, name):
    tm, cfg, params = jax_side[name]["weights"]
    pod = PodEngine(tm, cfg, params, _ec(),
                    PodConfig(prefill_workers=1, decode_workers=2),
                    device="cpu")
    reqs = _run_trace(pod, cfg.vocab_size, temps=(0.0,) * 4)
    assert [r.tokens for r in reqs] == jax_side[name]["tokens"]
    for a, b in zip(reqs, jax_side[name]["logprobs"]):
        np.testing.assert_allclose(a.logprobs, b, atol=1e-5)
    assert pod.compile_stats() == jax_side["compile_stats"]


def test_pod_streams_byte_identical_to_single_engine(gpt2_setup):
    """2 prefill + 2 decode workers shipping KV pages reproduce the
    single engine's streams, greedy and sampled, and its logprobs, with
    every program captured (here: first built) once per role."""
    cfg, params = gpt2_setup
    ref = _run_trace(Engine(tg, cfg, params, _ec(), device="cpu"),
                     cfg.vocab_size)
    pod = PodEngine(tg, cfg, params, _ec(),
                    PodConfig(prefill_workers=2, decode_workers=2),
                    device="cpu")
    reqs = _run_trace(pod, cfg.vocab_size)
    assert [r.tokens for r in reqs] == [r.tokens for r in ref]
    assert [r.logprobs for r in reqs] == [r.logprobs for r in ref]
    assert all(r.status is RequestStatus.FINISHED for r in reqs)
    assert pod.compile_stats() == {"admit": 1, "prefill": 1, "decode": 1,
                                   "extract": 1, "install": 1}
    s = pod.metrics_summary()
    assert s["pod_shipments"] == 4.0
    assert s["pod_pages_shipped"] >= 4.0
    assert s["requests_finished"] == 4.0


def test_pod_explicit_keys_follow_the_request(gpt2_setup):
    """A request's own key fixes its stream in the pod as in the single
    engine, whatever its position in the trace."""
    cfg, params = gpt2_setup
    prompts = _prompts(cfg.vocab_size)

    def run(engine, order):
        reqs = {i: engine.submit(prompts[i], max_new_tokens=5,
                                 temperature=0.9, key=100 + i)
                for i in order}
        engine.run_until_idle()
        return {i: r.tokens for i, r in reqs.items()}

    ref = run(Engine(tg, cfg, params, _ec(), device="cpu"), [0, 1, 2, 3])
    got = run(PodEngine(tg, cfg, params, _ec(), device="cpu"), [3, 1, 0, 2])
    assert got == ref


def test_pod_int8_shipments_byte_identical_to_single_engine(gpt2_setup):
    """int8 pools ship codes and scales verbatim: the pod equals the
    single int8 engine with the dense and the paged decode path."""
    cfg, params = gpt2_setup
    ref = [r.tokens for r in _run_trace(
        Engine(tg, cfg, params, _ec(kv_dtype="int8"), device="cpu"),
        cfg.vocab_size)]
    for pa in (False, True):
        pod = PodEngine(tg, cfg, params,
                        _ec(kv_dtype="int8", paged_attention=pa),
                        PodConfig(prefill_workers=1, decode_workers=1),
                        device="cpu")
        reqs = _run_trace(pod, cfg.vocab_size)
        assert [r.tokens for r in reqs] == ref, f"paged_attention={pa}"
        assert pod.metrics_summary()["pod_shipments"] == 4.0


def test_pod_logprobs_ride_shipments(gpt2_setup):
    cfg, params = gpt2_setup
    ref = _run_trace(Engine(tg, cfg, params, _ec(), device="cpu"),
                     cfg.vocab_size)
    pod = PodEngine(tg, cfg, params, _ec(), device="cpu")
    for r_ref, r_pod in zip(ref, _run_trace(pod, cfg.vocab_size)):
        assert r_pod.tokens == r_ref.tokens
        assert len(r_pod.logprobs) == len(r_pod.tokens)
        assert r_pod.logprobs == pytest.approx(r_ref.logprobs, abs=1e-5)


# ---------------------------------------------------------------------------
# the reference's router contracts
# ---------------------------------------------------------------------------


def test_pod_budget_one_and_eos_finish_at_prefill(gpt2_setup):
    cfg, params = gpt2_setup
    ref_eng = Engine(tg, cfg, params, _ec(), device="cpu")
    p = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                          (9,)).astype(np.int32)
    r_ref = ref_eng.submit(p, max_new_tokens=1)
    ref_eng.run_until_idle()
    pod = PodEngine(tg, cfg, params, _ec(), device="cpu")
    r = pod.submit(p, max_new_tokens=1)
    pod.run_until_idle()
    assert r.status is RequestStatus.FINISHED
    assert r.tokens == r_ref.tokens
    assert pod.metrics_summary()["pod_shipments"] == 0.0
    r2 = pod.submit(p, max_new_tokens=8, eos_token_id=r_ref.tokens[0])
    pod.run_until_idle()
    assert r2.status is RequestStatus.FINISHED
    assert r2.tokens == r_ref.tokens
    assert pod.metrics_summary()["pod_shipments"] == 0.0


def test_pod_worker_drop_carries_shed_code(gpt2_setup):
    cfg, params = gpt2_setup
    pod = PodEngine(tg, cfg, params, _ec(prefill_chunk=4), device="cpu")
    p = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                           (17,)).astype(np.int32)
    user = pod.submit(p, max_new_tokens=6)
    flight = pod._flights[id(user)]
    assert flight.phase == "prefill"
    assert pod.prefill_workers[flight.worker].cancel(flight.internal)
    pod.step()
    assert user.status is RequestStatus.EXPIRED
    assert user.shed_code == SHED_WORKER_DROP
    assert user.retry_after_s is not None
    assert pod.metrics_summary()["requests_expired"] == 1.0
    assert id(user) not in pod._flights
    r2 = pod.submit(p, max_new_tokens=3)
    pod.run_until_idle()
    assert r2.status is RequestStatus.FINISHED


def test_pod_backpressure_stalls_router_not_prefill(gpt2_setup):
    cfg, params = gpt2_setup
    ec = _ec(num_slots=1, max_queue=16)
    ref_eng = Engine(tg, cfg, params, dataclasses.replace(ec, num_slots=3),
                     device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (6, 9, 4, 11)]
    ref = []
    for p in prompts:
        r = ref_eng.submit(p, max_new_tokens=5)
        ref_eng.run_until_idle()
        ref.append(r.tokens)
    pod = PodEngine(tg, cfg, params, ec,
                    PodConfig(prefill_workers=1, decode_workers=1,
                              prefill_slots=3, max_pending_shipments=1),
                    device="cpu")
    reqs = [pod.submit(p, max_new_tokens=5) for p in prompts]
    pod.run_until_idle()
    assert [r.tokens for r in reqs] == ref
    assert pod.metrics_summary()["pod_backpressure_stalls"] > 0
    assert pod.metrics_summary()["pod_shipments"] == 4.0


def test_pod_cancel_everywhere(gpt2_setup):
    cfg, params = gpt2_setup
    pod = PodEngine(tg, cfg, params, _ec(num_slots=1, max_queue=8),
                    PodConfig(prefill_workers=1, decode_workers=1),
                    device="cpu")
    rng = np.random.default_rng(9)
    a, b, c = (pod.submit(rng.integers(0, cfg.vocab_size, (n,)).astype(
        np.int32), max_new_tokens=16) for n in (6, 7, 8))
    for _ in range(40):
        pod.step()
        if a.tokens:
            break
    assert a.tokens, "a never reached decode"
    assert pod.cancel(c)
    assert pod.cancel(a)
    assert not pod.cancel(a)
    pod.run_until_idle()
    assert a.status is RequestStatus.CANCELLED
    assert c.status is RequestStatus.CANCELLED
    assert b.status is RequestStatus.FINISHED and len(b.tokens) == 16
    for w in pod.decode_workers + pod.prefill_workers:
        assert w.scheduler.live_slots == 0
    s = pod.metrics_summary()
    assert s["requests_cancelled"] == 2.0
    assert s["requests_finished"] == 1.0


def test_pod_finish_early_is_finished(gpt2_setup):
    cfg, params = gpt2_setup
    pod = PodEngine(tg, cfg, params, _ec(), device="cpu")
    p = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                           (6,)).astype(np.int32)
    r = pod.submit(p, max_new_tokens=24)
    for _ in range(60):
        pod.step()
        if len(r.tokens) >= 3:
            break
    assert len(r.tokens) >= 3
    assert pod.finish(r)
    assert r.status is RequestStatus.FINISHED
    assert pod.metrics_summary()["requests_finished"] == 1.0
    pod.run_until_idle()


def test_pod_stream_matches_handle(gpt2_setup):
    cfg, params = gpt2_setup
    ref_eng = Engine(tg, cfg, params, _ec(), device="cpu")
    p = np.random.default_rng(13).integers(0, cfg.vocab_size,
                                           (7,)).astype(np.int32)
    r_ref = ref_eng.submit(p, max_new_tokens=6)
    ref_eng.run_until_idle()
    pod = PodEngine(tg, cfg, params, _ec(), device="cpu")
    r = pod.submit(p, max_new_tokens=6)
    assert list(pod.stream(r)) == r.tokens == r_ref.tokens

    async def collect():
        r2 = pod.submit(p, max_new_tokens=6)
        return [t async for t in pod.astream(r2)]

    assert asyncio.run(collect()) == r_ref.tokens


def test_pod_rejects_and_sheds_like_an_engine(gpt2_setup):
    cfg, params = gpt2_setup
    pod = PodEngine(tg, cfg, params, _ec(max_queue=1, num_slots=1),
                    PodConfig(prefill_workers=1, decode_workers=1,
                              prefill_slots=1, max_pending_shipments=1),
                    device="cpu")
    too_long = pod.submit(np.arange(60, dtype=np.int32) % cfg.vocab_size,
                          max_new_tokens=32)
    assert too_long.status is RequestStatus.REJECTED
    assert too_long.shed_code == "too_long"
    rng = np.random.default_rng(17)
    keep, rejected = [], []
    for _ in range(8):
        r = pod.submit(rng.integers(0, cfg.vocab_size, (6,)).astype(
            np.int32), max_new_tokens=8)
        (rejected if r.status is RequestStatus.REJECTED else keep).append(r)
    assert rejected, "queue bound never bit"
    assert all(r.shed_code == "queue_full" for r in rejected)
    assert all(r.retry_after_s is not None for r in rejected)
    pod.run_until_idle()
    assert all(r.status is RequestStatus.FINISHED for r in keep)


# ---------------------------------------------------------------------------
# observability: the JAX router's names and shapes
# ---------------------------------------------------------------------------


def test_pod_debug_views_metrics_and_summary_match_jax(jax_side):
    tm, cfg, params = jax_side["gpt2"]["weights"]
    pod = PodEngine(tm, cfg, params, _ec(),
                    PodConfig(prefill_workers=1, decode_workers=2),
                    device="cpu")
    _run_trace(pod, cfg.vocab_size, temps=(0.0,) * 4)
    ours, theirs = _views(pod), jax_side["views"]
    assert _shape(ours) == _shape(theirs)
    assert ours["pod"]["shipments_total"] == theirs["pod"]["shipments_total"]
    assert ours["pod"]["pages_shipped_total"] == \
        theirs["pod"]["pages_shipped_total"]
    assert ours["pod"]["in_flight"] == {} == theirs["pod"]["in_flight"]
    assert [w["worker"] for w in ours["pod"]["roles"]["decode"]] == [0, 1]
    assert {e["role"] for e in ours["slots"]} == {"prefill", "decode"}
    assert len(ours["pages"]["workers"]) == 3
    assert ours["scheduler"]["pod"]["in_flight"] == 0
    json.dumps(ours)
    assert _series(pod.registry) == jax_side["series"]
    assert ("serving_pod_role_occupancy", "decode") in jax_side["series"]
    # the JAX summary's keys the port's lacks are its XLA compile keys
    assert jax_side["summary_keys"] <= set(pod.metrics_summary())


def test_pod_page_transfer_span_matches_jax(jax_side):
    from accelerate_tpu_torch.telemetry import trace as ttrace

    jtok, jnames, jhop = jax_side["traced"]
    _jm, tm, _cj, cfg, _pj, params = _weights("gpt2")
    tok, names, hop, pod = _traced_run(
        PodEngine, ttrace, _ec(), PodConfig(), tm, cfg, params,
        device="cpu")
    assert tok == jtok
    assert names == jnames
    assert {"serving.page_transfer", "serving.queue_wait",
            "serving.request"} <= set(names)
    assert {k: hop[k] for k in ("pages", "bytes", "src_worker",
                                "dst_worker")} == \
        {k: jhop[k] for k in ("pages", "bytes", "src_worker", "dst_worker")}


def test_http_front_door_over_pod_engine(gpt2_setup):
    """The port's server stack drives a PodEngine like a single engine:
    one streamed completion returns the pod's stream, /debug/pod serves
    router state when gated on and 404s for every method when off."""
    from accelerate_tpu_torch.server.config import ServerConfig
    from accelerate_tpu_torch.server.http import HttpFrontDoor
    from accelerate_tpu_torch.server.service import InferenceService
    from accelerate_tpu_torch.server.tokenizer import get_tokenizer

    cfg, params = gpt2_setup
    ref_eng = Engine(tg, cfg, params, _ec(), device="cpu")
    prompt = list(range(1, 8))
    r_ref = ref_eng.submit(np.asarray(prompt, np.int32), max_new_tokens=5)
    ref_eng.run_until_idle()
    pod = PodEngine(tg, cfg, params, _ec(), device="cpu")

    async def req(port, verb, path, body=None):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        payload = json.dumps(body).encode() if body is not None else b""
        writer.write(
            f"{verb} {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        status = int(head.split(b" ")[1])
        data = await reader.read()
        writer.close()
        return status, data

    def door(debug):
        scfg = ServerConfig(port=0, model_id="pod-test", tokenizer="numeric",
                            debug_endpoints=debug)
        return HttpFrontDoor(InferenceService(
            pod, get_tokenizer("numeric", cfg.vocab_size), scfg), scfg)

    async def drive(d):
        await d.start()
        status, data = await req(
            d.port, "POST", "/v1/completions",
            {"prompt": prompt, "max_tokens": 5, "temperature": 0,
             "stream": True})
        assert status == 200
        ids = []
        for frame in data.split(b"\n\n"):
            if frame.startswith(b"data: ") and b"[DONE]" not in frame:
                row = json.loads(frame[len(b"data: "):])
                ids += row["choices"][0].get("token_ids", [])
        status, body = await req(d.port, "GET", "/debug/pod")
        assert status == 200
        await d.stop()
        return ids, json.loads(body)

    ids, dbg = asyncio.run(drive(door(True)))
    assert ids == r_ref.tokens
    assert dbg["shipments_total"] >= 1 and "roles" in dbg

    async def gate(d):
        await d.start()
        out = [(await req(d.port, verb, "/debug/pod"))[0]
               for verb in ("GET", "POST", "HEAD")]
        await d.stop()
        return out

    assert asyncio.run(gate(door(False))) == [404, 404, 404]
    pod.close()


# ---------------------------------------------------------------------------
# layer 1 refuses; the router sanitizer
# ---------------------------------------------------------------------------


def test_mesh_serving_refuses_naming_item_6b(gpt2_setup):
    cfg, params = gpt2_setup
    with pytest.raises(NotImplementedError, match="queue 1 item 6b"):
        PodRouter(tg, cfg, params, _ec(), PodConfig(tensor_parallel=2),
                  device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 6b"):
        PodRouter(tg, cfg, params, _ec(mesh=object()), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 6b"):
        Engine(tg, cfg, params, _ec(mesh=object()), device="cpu")
    for fn in (tensor_mesh, shard_params, cache_state_shardings,
               sharded_engine):
        with pytest.raises(NotImplementedError, match="queue 1 item 6b"):
            fn(2)


def test_check_router_catches_corrupted_books(gpt2_setup):
    cfg, params = gpt2_setup
    pod = PodEngine(tg, cfg, params, _ec(prefill_chunk=4), device="cpu")
    p = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                          (17,)).astype(np.int32)
    user = pod.submit(p, max_new_tokens=6)
    pod.step()
    check_router(pod)
    flight = pod._flights[id(user)]
    flight.phase = "teleporting"
    with pytest.raises(SanitizerViolation, match="unknown flight phase"):
        check_router(pod)
    flight.phase = "prefill"
    pod._admit_pages[12345] = [1]
    with pytest.raises(SanitizerViolation, match="snapshots outlive"):
        check_router(pod)
    del pod._admit_pages[12345]
    pod._pending.append(flight)
    with pytest.raises(SanitizerViolation, match="pending-buffer"):
        check_router(pod)
    pod._pending.pop()
    check_router(pod)
    pod.run_until_idle()
    assert user.status is RequestStatus.FINISHED
