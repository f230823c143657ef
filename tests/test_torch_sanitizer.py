"""The serving-state sanitizer in the port's engine against the JAX
engine's.

Each invariant the reference's sanitizer tests corrupt is corrupted the
same way in a port engine and a JAX engine on the same tiny-llama
weights; the next step raises `SanitizerViolation` with the same named
check (page-conservation, refcount, table, lengths, scheduler-books) and
the same message and details in both. With the checks on, the programs
are still built once each, and forks, cancels and speculation run clean.
`sanitize=None` is off in the port: it reads no environment variable."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import Engine as JEngine
from accelerate_tpu.serving import EngineConfig as JConfig
from accelerate_tpu.serving import SanitizerViolation as JViolation
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.serving import (
    Engine,
    EngineConfig,
    RequestStatus,
    SanitizerViolation,
)
from accelerate_tpu_torch.serving.sanitizer import resolve_sanitize

BASE = dict(num_slots=2, max_len=64, prefill_chunk=8, page_size=8,
            sanitize=True)
HOST = dict(page_size=4, num_pages=18, host_tier_bytes=1 << 28)


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
    return Engine(tl, cfg, pt, EngineConfig(
        **dict(BASE, cache_dtype=torch.float32, **kw)), device="cpu")


def _jax(weights, **kw):
    cfg, _, pj, _ = weights
    return JEngine(jl, cfg, pj, JConfig(
        **dict(BASE, cache_dtype=jnp.float32, **kw)))


def _prompt(rng, n, vocab=256):
    return rng.integers(0, vocab, (n,)).astype(np.int32)


def _serve(eng, n=9, seed=0, budget=3):
    r = eng.submit(_prompt(np.random.default_rng(seed), n),
                   max_new_tokens=budget)
    eng.run_until_idle()
    assert r.status.value == "finished"


def _host_resident(eng, serves=2, seed=20):
    """Serves that churn earlier prompts out to the host tier; three
    leave a host-resident parent->child chain."""
    rng = np.random.default_rng(seed)
    for _ in range(serves):
        r = eng.submit(_prompt(rng, 33), max_new_tokens=2)
        eng.run_until_idle()
        assert r.status.value == "finished"
    assert eng.allocator.index.host_pages > 0


# --- corruptions: (engine kwargs, set-up, corruption, check, fragment) ---


def _stale_idle_row(eng):
    _serve(eng)
    eng._table[0, 0] = 0             # a retired lane's row names page 0


def _free_list_duplicate(eng):
    _serve(eng)
    free = eng.allocator.pool._free
    free.append(free[0])


def _phantom_refcount(eng):
    _serve(eng, n=17)                # retirement caches 2 full pages
    node = next(iter(eng.allocator.index.root.children.values()))
    node.refcount += 1
    return {"page": node.page}


def _lost_page(eng):
    _serve(eng)
    eng.allocator.pool._free.pop()


def _queued_claims_running(eng):
    rng = np.random.default_rng(3)
    eng.submit(_prompt(rng, 9), max_new_tokens=20)
    r2 = eng.submit(_prompt(rng, 9), max_new_tokens=2)
    assert r2.status.value == "queued"
    r2.status = type(r2.status).RUNNING
    return {"request_id": r2.request_id}


def _length_escapes_its_pages(eng):
    """A decoding slot's length a page past the rows it reserved, still
    inside its view (72 rows), so the step runs and the check sees it."""
    rng = np.random.default_rng(4)
    eng.submit(_prompt(rng, 9), max_new_tokens=20)
    while eng.scheduler.slots[0].state.value != "decode":
        eng.step()
    bad = len(eng.scheduler.slots[0].alloc.pages) * 8 + 8
    assert bad + 1 < 72
    lengths = eng.cache.lengths
    if isinstance(lengths, torch.Tensor):
        lengths[0] = bad
    else:
        eng.cache = type(eng.cache)(**{
            **eng.cache.__dict__, "lengths": lengths.at[0].set(bad)})
    return {"slot": 0, "length": bad + 1}


def _host_node_without_mirror(eng):
    _host_resident(eng)
    del eng._host_tier._entries[next(iter(eng._host_tier._entries))]


def _host_node_names_a_page(eng):
    _host_resident(eng, seed=21)
    next(iter(eng._host_tier._entries)).page = 0


def _host_pages_counter_drift(eng):
    _host_resident(eng, seed=22)
    eng.allocator.index.host_pages += 1


def _hbm_child_under_host_parent(eng):
    _host_resident(eng, serves=3, seed=23)
    node = next(n for n in eng._host_tier._entries if n.children)
    child = next(iter(node.children.values()))
    assert child.residency == "host"
    eng._host_tier.discard(child)
    child.residency = "hbm"
    child.page = eng.allocator.pool._free[0]


CORRUPTIONS = {
    "stale_idle_table_row": ({}, _stale_idle_row, "table", "trash"),
    "free_list_duplicate": ({}, _free_list_duplicate, "page-conservation",
                            "duplicate"),
    "phantom_refcount": ({}, _phantom_refcount, "refcount", "refcount"),
    "lost_page": ({}, _lost_page, "page-conservation",
                  "lost or double-counted"),
    "queued_claims_running": (dict(num_slots=1, max_queue=4),
                              _queued_claims_running, "scheduler-books",
                              "QUEUED"),
    "length_escapes_its_pages": ({}, _length_escapes_its_pages, "lengths",
                                 "escaped"),
    "host_node_without_mirror": (HOST, _host_node_without_mirror,
                                 "page-conservation", "mirror"),
    "host_node_names_a_page": (HOST, _host_node_names_a_page,
                               "page-conservation", "host-resident"),
    "host_pages_counter_drift": (HOST, _host_pages_counter_drift,
                                 "page-conservation", "host_pages"),
    "hbm_child_under_host_parent": (HOST, _hbm_child_under_host_parent,
                                    "page-conservation", "HBM"),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_corruption_raises_the_reference_check(weights, case):
    kw, corrupt, check, fragment = CORRUPTIONS[case]
    raised = {}
    for name, make, violation in (("port", _port, SanitizerViolation),
                                  ("jax", _jax, JViolation)):
        eng = make(weights, **kw)
        want = corrupt(eng) or {}
        with pytest.raises(violation) as ei:
            eng.step()
        raised[name] = ei.value
        for key, value in want.items():
            assert ei.value.details[key] == value, (name, key)
        if kw.get("host_tier_bytes"):
            eng.close()
    port, ref = raised["port"], raised["jax"]
    assert port.check == ref.check == check
    assert fragment in str(port)
    assert str(port) == str(ref)


def test_draft_length_disagreeing_with_its_progress_raises(weights):
    """The speculative half of the lengths check: a prefilling slot's
    draft length must be its host-tracked draft progress."""
    _, cfg, _, pt = weights
    eng = _port(weights, max_len=96, speculative=(tl, cfg, pt), draft_k=3)
    eng.submit(_prompt(np.random.default_rng(5), 40), max_new_tokens=4)
    eng.step()
    slot = eng.scheduler.slots[0]
    assert slot.state.value == "prefill" and slot.draft_done > 0
    eng._draft_cache.lengths[0] += 1
    with pytest.raises(SanitizerViolation) as ei:
        eng.step()
    assert ei.value.check == "lengths"
    assert ei.value.details["draft_done"] == slot.draft_done


def test_resolve_sanitize_reads_no_environment(monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_SANITIZE", "1")
    assert resolve_sanitize(None) is False
    assert resolve_sanitize(True) is True
    assert resolve_sanitize(False) is False


def test_sanitize_off_really_disables(weights):
    eng = _port(weights, sanitize=False)
    _serve(eng)
    eng._table[0, 0] = 0
    assert eng.step() is False
    eng = _port(weights, sanitize=None)
    _serve(eng)
    eng._table[0, 0] = 0
    assert eng.step() is False


def test_programs_built_once_with_the_sanitizer_on(weights):
    eng = _port(weights)
    rng = np.random.default_rng(5)
    shared = _prompt(rng, 18)
    for temp in (0.0, 0.9):
        reqs = [eng.submit(np.concatenate([shared, _prompt(rng, 2 + i)]),
                           max_new_tokens=3, temperature=temp)
                for i in range(2)]
        eng.run_until_idle()
        assert all(r.status is RequestStatus.FINISHED for r in reqs)
    assert eng.compile_stats() == {"admit": 1, "prefill": 1, "decode": 1}
    assert eng.metrics.prefix_hits >= 1


def test_fork_cancel_and_speculation_run_sanitized(weights):
    """A COW fork fan-out with the parent cancelled mid-decode, and a
    speculative engine's accept and rollback paths, complete with the
    checks on after every step."""
    _, cfg, _, pt = weights
    eng = _port(weights, max_len=96)
    rng = np.random.default_rng(6)
    prompt = _prompt(rng, 24)
    parent = eng.submit(prompt, max_new_tokens=6, temperature=0.7, key=1)
    forks = [eng.fork(parent, key=10 + i) for i in (1, 2)]
    while len(parent.tokens) < 2:
        eng.step()
    assert eng.cancel(parent)
    eng.run_until_idle()
    assert all(f.status is RequestStatus.FINISHED for f in forks)
    assert eng.allocator.index.mapped_pages == 0

    spec = _port(weights, speculative=(tl, cfg, pt), draft_k=3)
    r = spec.submit(_prompt(rng, 9), max_new_tokens=6)
    spec.run_until_idle()
    assert r.status is RequestStatus.FINISHED and len(r.tokens) == 6
