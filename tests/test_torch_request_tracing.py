"""The port's request tracing against the JAX package's.

The same request sequence — greedy requests with multi-chunk prompts, a
fork, a cancel mid-decode, a deadline shed, an int-keyed and a
uint32[2]-keyed sampled request — through the JAX engine and the port's
(CPU, converted fp32 `LlamaConfig.tiny()` weights) gives the same span
names, the same parent links and the same terminal attributes in the two
flight recorders, and the same number of batched decode steps linking
each trace. The rest mirrors `tests/test_request_tracing.py` on the
port's engine: the full span chain under one trace id, captures flat
with tracing on, cancelled and shed requests closing their root spans,
sampling at 0 still minting ids, exemplars carrying the trace id, the
incident dumps, and the span recorder's own copy (`drain_spans`,
`ingest_spans`, the chrome export)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import Engine as JEngine
from accelerate_tpu.serving import EngineConfig as JConfig
from accelerate_tpu.telemetry import trace as jtrace
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.serving import Engine, EngineConfig, \
    RequestStatus
from accelerate_tpu_torch.telemetry import trace as ttrace

BASE = dict(num_slots=2, max_len=64, prefill_chunk=8, page_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _tracing_reset():
    for mod in (jtrace, ttrace):
        mod.configure_tracing(enabled=False, sample_rates={},
                              default_sample_rate=1.0)
        mod.clear_flight_recorder()
    yield
    for mod in (jtrace, ttrace):
        mod.configure_tracing(enabled=False, sample_rates={},
                              default_sample_rate=1.0)
        mod.clear_flight_recorder()


@pytest.fixture(scope="module")
def weights():
    cfg_j = jl.LlamaConfig.tiny()
    pj = jl.init_params(cfg_j, jax.random.key(0))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return cfg_j, tl.LlamaConfig.tiny(), pj, pt


def _engine(weights, pkg="torch", **overrides):
    cfg_j, cfg_t, pj, pt = weights
    kw = dict(BASE, **overrides)
    if pkg == "jax":
        return JEngine(jl, cfg_j, pj, JConfig(cache_dtype=jnp.float32, **kw))
    return Engine(tl, cfg_t, pt, EngineConfig(cache_dtype=torch.float32,
                                              **kw), device="cpu")


def _sequence(eng):
    """The request mix, driven identically on either engine; returns the
    requests in submission order."""
    rng = np.random.default_rng(3)
    p = [rng.integers(0, 256, n).astype(np.int32) for n in (11, 5, 19, 7)]
    a = eng.submit(p[0], max_new_tokens=4)
    b = eng.submit(p[1], max_new_tokens=6, tenant="gold")
    eng.step()
    fork = eng.fork(a, max_new_tokens=3)
    victim = eng.submit(p[2], max_new_tokens=30)
    doomed = eng.submit(p[3], max_new_tokens=4, deadline_s=0.0)
    for _ in range(6):
        eng.step()
    eng.cancel(victim)
    eng.run_until_idle()
    keyed = eng.submit(p[1], max_new_tokens=3, temperature=0.7, key=5)
    pair = eng.submit(p[1], max_new_tokens=3, temperature=0.7,
                      key=np.array([5, 1], np.uint32))
    eng.run_until_idle()
    return [a, b, fork, victim, doomed, keyed, pair]


# attributes that are the same function of the request sequence in both
# engines (times and engine-global request ids are not)
_ATTRS = ("status", "tenant", "prompt_len", "tokens", "shed_code", "slot",
          "chunk_start", "chunk_tokens", "reused_len")


def _tree(mod, reqs):
    """Per request: its spans as sorted (name, relation to the request's
    root, attrs) with the relation one of root/child/other, whether the
    root names a fork parent, and how many batched decode steps link the
    trace."""
    out = []
    steps = [e for e in mod.flight_recorder() if e["name"] == "serving.decode"]
    ids = {r.request_id: i for i, r in enumerate(reqs)}
    for r in reqs:
        spans = []
        for e in mod.trace_events(r.trace_id):
            rel = ("root" if e["span_id"] == r.span_id else
                   "child" if e["parent_id"] == r.span_id else "other")
            attrs = e.get("attrs", {})
            kept = tuple((k, attrs[k]) for k in _ATTRS if k in attrs)
            if "forked_from" in attrs:
                kept += (("forked_from", ids[attrs["forked_from"]]),)
            spans.append((e["name"], rel, kept))
        linked = sum(r.trace_id in e.get("links", ()) for e in steps)
        out.append((sorted(spans), linked, r.status.value))
    return out


def test_span_trees_equal_the_jax_engines(weights):
    """Acceptance: the same request sequence gives the same span trees,
    parent links and terminal attributes in both flight recorders."""
    trees = []
    for pkg, mod in (("jax", jtrace), ("torch", ttrace)):
        mod.configure_tracing(enabled=True, annotate=False)
        reqs = _sequence(_engine(weights, pkg))
        trees.append(_tree(mod, reqs))
        mod.configure_tracing(enabled=False)
    assert trees[1] == trees[0]
    statuses = [t[2] for t in trees[1]]
    assert statuses == ["finished", "finished", "finished", "cancelled",
                        "expired", "finished", "finished"]
    root = dict(next(s for s in trees[1][4][0]
                     if s[0] == "serving.request")[2])
    assert root["shed_code"] == "deadline"


def test_sampled_at_zero_both_engines_mint_ids_and_record_nothing(weights):
    for pkg, mod in (("jax", jtrace), ("torch", ttrace)):
        mod.configure_tracing(enabled=True, annotate=False,
                              default_sample_rate=0.0)
        eng = _engine(weights, pkg)
        r = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
        s = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2,
                       trace_id="ee" * 16)
        eng.run_until_idle()
        assert r.trace_id is not None and len(r.trace_id) == 32
        assert s.trace_id == "ee" * 16
        assert not r.trace_sampled and not s.trace_sampled
        assert mod.trace_events(r.trace_id) == []
        assert mod.trace_events(s.trace_id) == []


class TestEngineRequestTrace:
    def test_full_span_chain_shares_the_trace(self, weights):
        ttrace.configure_tracing(enabled=True, annotate=False)
        eng = _engine(weights)
        r = eng.submit(np.arange(1, 12, dtype=np.int32), max_new_tokens=4)
        assert r.trace_sampled and len(r.trace_id) == 32
        toks = list(eng.stream(r))
        assert len(toks) == 4
        events = ttrace.trace_events(r.trace_id)
        names = [e["name"] for e in events]
        assert "serving.queue_wait" in names
        assert "serving.admit" in names
        assert names.count("serving.prefill") == 2  # 11 tokens / chunk 8
        assert "serving.decode_lifetime" in names
        assert "serving.request" in names
        root = next(e for e in events if e["name"] == "serving.request")
        assert root["span_id"] == r.span_id
        assert root["attrs"]["status"] == "finished"
        assert root["attrs"]["tokens"] == 4
        children = [e for e in events if e["name"] != "serving.request"]
        assert all(e["trace_id"] == r.trace_id for e in events)
        assert all(e["parent_id"] == r.span_id for e in children)
        doc = ttrace.export_chrome_trace(trace_id=r.trace_id)
        assert {e["name"] for e in doc["traceEvents"]} == set(names)
        decode_steps = [e for e in ttrace.flight_recorder()
                        if e["name"] == "serving.decode"]
        assert any(r.trace_id in e.get("links", []) for e in decode_steps)

    def test_compile_counts_flat_with_tracing_on(self, weights):
        ttrace.configure_tracing(enabled=True, annotate=True)
        eng = _engine(weights)
        for n in (3, 11, 7):
            r = eng.submit(np.arange(1, n + 1, dtype=np.int32),
                           max_new_tokens=3, trace_id=None)
            list(eng.stream(r))
        assert eng.compile_stats() == {"admit": 1, "prefill": 1,
                                       "decode": 1}

    def test_cancelled_request_closes_its_span_with_reason(self, weights):
        ttrace.configure_tracing(enabled=True, annotate=False)
        eng = _engine(weights)
        r = eng.submit(np.arange(1, 10, dtype=np.int32), max_new_tokens=16)
        eng.step()
        assert eng.cancel(r)
        root = next(e for e in ttrace.trace_events(r.trace_id)
                    if e["name"] == "serving.request")
        assert root["attrs"]["status"] == "cancelled"

    def test_shed_request_closes_its_span_with_shed_code(self, weights):
        ttrace.configure_tracing(enabled=True, annotate=False)
        eng = _engine(weights, num_slots=1)
        blocker = eng.submit(np.arange(1, 10, dtype=np.int32),
                             max_new_tokens=32)
        doomed = eng.submit(np.arange(1, 6, dtype=np.int32),
                            max_new_tokens=4, deadline_s=0.0)
        eng.step()
        assert doomed.status is RequestStatus.EXPIRED
        root = next(e for e in ttrace.trace_events(doomed.trace_id)
                    if e["name"] == "serving.request")
        assert root["attrs"]["status"] == "expired"
        assert root["attrs"]["shed_code"] == "deadline"
        assert "reason" in root["attrs"]
        eng.cancel(blocker)

    def test_tracing_disabled_requests_carry_no_trace(self, weights):
        eng = _engine(weights)
        r = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
        list(eng.stream(r))
        assert r.trace_id is None and not r.trace_sampled
        assert ttrace.flight_recorder() == []

    def test_ttft_exemplar_carries_the_trace_id(self, weights):
        ttrace.configure_tracing(enabled=True, annotate=False)
        eng = _engine(weights)
        r = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
        list(eng.stream(r))
        exemplars = eng.metrics.ttft_s.exemplars()
        assert any(label == str(r.trace_id)
                   for _, label, _ in exemplars.values())

    def test_fork_root_names_its_parent(self, weights):
        ttrace.configure_tracing(enabled=True, annotate=False)
        eng = _engine(weights, num_slots=3)
        parent = eng.submit(np.arange(1, 20, dtype=np.int32),
                            max_new_tokens=3)
        child = eng.fork(parent, trace_id="cd" * 16, trace_parent=7)
        eng.run_until_idle()
        root = next(e for e in ttrace.trace_events("cd" * 16)
                    if e["name"] == "serving.request")
        assert root["attrs"]["forked_from"] == parent.request_id
        assert root["parent_id"] == 7
        assert child.tokens == parent.tokens  # greedy: the same stream

    def test_speculative_steps_link_their_traces(self, weights):
        ttrace.configure_tracing(enabled=True, annotate=False)
        cfg_j, cfg_t, pj, pt = weights
        eng = _engine(weights, speculative=(tl, cfg_t, pt), draft_k=2)
        r = eng.submit(np.arange(1, 12, dtype=np.int32), max_new_tokens=4)
        eng.run_until_idle()
        names = [e["name"] for e in ttrace.trace_events(r.trace_id)]
        assert names.count("serving.draft_prefill") == 2
        steps = [e for e in ttrace.flight_recorder()
                 if e["name"] in ("serving.draft", "serving.verify")]
        assert steps and all(r.trace_id in e["links"] for e in steps)


class TestEngineIntrospection:
    def test_debug_views_reflect_live_state(self, weights):
        eng = _engine(weights, num_slots=1)
        running = eng.submit(np.arange(1, 10, dtype=np.int32),
                             max_new_tokens=32)
        queued = eng.submit(np.arange(1, 5, dtype=np.int32),
                            max_new_tokens=4)
        eng.step()
        dbg = eng.debug_requests()
        assert [q["request_id"] for q in dbg["queued"]] == [
            queued.request_id]
        assert [q["request_id"] for q in dbg["running"]] == [
            running.request_id]
        slots = eng.debug_slots()
        assert slots[0]["request_id"] == running.request_id
        assert slots[0]["pages"] > 0
        sched = eng.debug_scheduler()
        assert sched["queue_depth"] == 1 and sched["live_slots"] == 1
        eng.cancel(running)
        eng.cancel(queued)
        eng.run_until_idle()
        dbg = eng.debug_requests()
        assert dbg["queued"] == [] and dbg["running"] == []

    def test_incident_dumps_match_the_reference_sections(self, weights):
        """The reference's sections, each equal in shape to the
        reference's for the same state; the device-cost table has the
        same programs, calls and cadence (its costs are the port's
        analytic ones, the reference's from XLA)."""
        dumps = {}
        for pkg in ("jax", "torch"):
            eng = _engine(weights, pkg)
            r = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
            eng.run_until_idle()
            assert r.status.value == "finished"
            dumps[pkg] = eng.incident_dumps()
        assert set(dumps["torch"]) == set(dumps["jax"]) == {
            "requests", "slots", "pages", "scheduler", "compile_stats",
            "cost_table"}
        for section in ("requests", "slots", "pages", "compile_stats"):
            assert dumps["torch"][section] == dumps["jax"][section]
        tables = {pkg: d["cost_table"] for pkg, d in dumps.items()}
        assert tables["torch"]["sample_every"] == tables["jax"][
            "sample_every"] == 16
        assert {n: p["calls"] for n, p in tables["torch"]["programs"].items()
                } == {n: p["calls"]
                      for n, p in tables["jax"]["programs"].items()}


class TestStreamKeys:
    def test_uint32_pair_is_the_int_of_its_two_words(self, weights):
        eng = _engine(weights)
        prompt = np.arange(1, 8, dtype=np.int32)
        kw = dict(max_new_tokens=8, temperature=0.9)
        a = eng.submit(prompt, key=5 + (3 << 32), **kw)
        b = eng.submit(prompt, key=np.array([5, 3], np.uint32), **kw)
        c = eng.submit(prompt, key=np.array([5, 4], np.uint32), **kw)
        eng.run_until_idle()
        assert a.tokens == b.tokens
        assert a.tokens != c.tokens, "distinct words, distinct streams"

    @pytest.mark.parametrize("bad", [np.array([1, 2, 3], np.uint32),
                                     np.array([1.0, 2.0]), "key"])
    def test_malformed_keys_are_refused_at_submit(self, weights, bad):
        eng = _engine(weights)
        with pytest.raises(ValueError, match="sampling key"):
            eng.submit(np.arange(1, 4, dtype=np.int32), key=bad)
        assert eng.scheduler.queue_depth == 0


class TestRecorderCopy:
    @pytest.mark.parametrize("mod", [jtrace, ttrace], ids=["jax", "torch"])
    def test_drain_and_ingest_round_trip(self, mod):
        mod.configure_tracing(enabled=True, annotate=False)
        with mod.span("local"):
            pass
        mod.record_span("serving.request", 1.0, 2.0, trace="ab" * 16)
        mod.record_span("serving.decode", 1.5, 1.6, links=["ab" * 16])
        events, cursor = mod.drain_spans(0)
        assert [e["name"] for e in events] == ["serving.decode",
                                               "serving.request"]
        assert mod.drain_spans(cursor) == ([], cursor)
        mod.clear_flight_recorder()
        assert mod.ingest_spans(events + [{"bad": 1}], offset_s=1.0,
                                pid=9, worker=2) == 2
        got = mod.flight_recorder()
        assert {e["pid"] for e in got} == {9}
        assert all(e["attrs"]["worker"] == 2 for e in got)
        assert mod.trace_events("ab" * 16)[0]["start_ns"] == int(2e9)

    def test_ring_bound_and_index_prune_like_the_reference(self):
        results = []
        for mod in (jtrace, ttrace):
            mod.configure_tracing(enabled=True, annotate=False, ring_size=4)
            for i in range(6):
                mod.record_span(f"s{i}", i, i + 0.5, trace=f"t{i % 2}")
            results.append(([e["name"] for e in mod.flight_recorder()],
                             [e["name"] for e in mod.trace_events("t0")],
                             mod.export_chrome_trace(trace_id="t1")[
                                 "traceEvents"][0]["name"]))
            mod.configure_tracing(enabled=False, ring_size=4096)
        assert results[0] == results[1]

    def test_span_annotates_the_torch_profiler(self):
        """A span's name appears on the torch.profiler timeline, where the
        reference's enters a jax TraceAnnotation."""
        from torch.profiler import ProfilerActivity, profile

        ttrace.configure_tracing(enabled=True, annotate=True)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with ttrace.span("serving.prefill", slot=0):
                torch.ones(4).sum()
        assert any(e.key == "serving.prefill"
                   for e in prof.key_averages())
