"""The port's multi-process pod (`accelerate_tpu_torch.serving.pod.
distributed`) against the JAX package's and the port's single engine.

The wire: the port's frames are byte-identical to the reference
encoder's on the same messages, bfloat16 included (the port writes raw
16-bit words under the reference's "bfloat16" tag), and each side
decodes the other's frames. The channels: local and socket round trips,
the bounded send queue, close joining the IO threads, the deterministic
fault injector. The pod: the in-process distributed pod (`LocalChannel`
pairs through the codec, a fake clock) is byte-identical to the port's
single engine, greedy and sampled, and its greedy streams to the JAX
distributed pod's; dropped, duplicated, killed and hung workers recover
exactly; a flake storm loses nothing; rebalancing converts once per
window; worker snapshots merge into the router's exposition; the fleet
bundle, clock sync and span ingest hold on a fake clock; the sanitizer
catches corrupted books. One test runs two real `pod-worker` processes
over TCP, exact and recovering from a SIGKILL."""

import dataclasses
import json
import os
import signal
import socket as socketlib
import sys
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accelerate_tpu.models import gpt2 as jg
from accelerate_tpu.serving import EngineConfig as JConfig
from accelerate_tpu.serving.pod import KVPageShipment as JShipment
from accelerate_tpu.serving.pod.distributed import (
    DistributedPodConfig as JDPodConfig,
)
from accelerate_tpu.serving.pod.distributed import (
    build_local_distributed_pod as jbuild,
)
from accelerate_tpu.serving.pod.distributed import wire as jwire
from accelerate_tpu_torch.models import gpt2
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.serving import Engine, EngineConfig
from accelerate_tpu_torch.serving.pod import KVPageShipment
from accelerate_tpu_torch.serving.pod.distributed import (
    ChannelListener,
    DistributedPodConfig,
    DistributedPodRouter,
    FlakyTransport,
    LocalChannel,
    Message,
    SocketChannel,
    build_local_distributed_pod,
    decode_message,
    encode_message,
    shipment_from_message,
    shipment_to_message,
)
from accelerate_tpu_torch.serving.pod.distributed.wire import WireError
from accelerate_tpu_torch.serving.pod.transfer import BF16_WORDS, to_tensor
from accelerate_tpu_torch.serving.sanitizer import (
    SanitizerViolation,
    check_distributed_router,
)

TWO_PROCESS_DEADLINE_S = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    cfg_j = jg.GPT2Config.tiny()
    pj = jg.init_params(cfg_j, jax.random.key(0))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return cfg_j, gpt2.GPT2Config.tiny(), pj, pt


@pytest.fixture(scope="module")
def gpt2_setup(weights):
    return weights[1], weights[3]


_BASE = dict(num_slots=3, max_len=64, prefill_chunk=8, page_size=8)


def _ec(**overrides):
    return EngineConfig(**dict(_BASE, cache_dtype=torch.float32,
                               sanitize=True, **overrides))


def _traffic(vocab, temps=(0.0, 0.7, 0.0, 1.1)):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, vocab, size=n).tolist()
               for n in (5, 11, 3, 17)]
    return prompts, (6, 6, 4, 4), temps


@pytest.fixture(scope="module")
def ref_outputs(gpt2_setup):
    """The port's single engine on the seeded trace: tokens and
    logprobs any pod submitting the same trace in the same order must
    reproduce."""
    cfg, params = gpt2_setup
    engine = Engine(gpt2, cfg, params, _ec(), device="cpu")
    prompts, budgets, temps = _traffic(cfg.vocab_size)
    reqs = [engine.submit(p, max_new_tokens=b, temperature=t)
            for p, b, t in zip(prompts, budgets, temps)]
    engine.run_until_idle()
    assert all(r.status.value == "finished" for r in reqs)
    return ([list(r.tokens) for r in reqs],
            [list(r.logprobs) for r in reqs])


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 0.01
        return t[0]

    return clock


def _build_pod(cfg, params, pf=1, dec=1, wrap=None, engine_config=None,
               clock=None, **pc_kwargs):
    pc_kwargs.setdefault("heartbeat_interval_s", 0.0)
    pc_kwargs.setdefault("rebalance", False)
    return build_local_distributed_pod(
        gpt2, cfg, params, engine_config=engine_config or _ec(),
        pod_config=DistributedPodConfig(
            prefill_workers=pf, decode_workers=dec, **pc_kwargs),
        clock=clock or _fake_clock(), channel_wrap=wrap, device="cpu")


def _drive(router, reqs, max_steps=5000):
    for _ in range(max_steps):
        router.step()
        if all(r.done for r in reqs):
            return
    raise AssertionError(f"pod wedged: {router.debug_pod()}")


def _submit_traffic(router, cfg, temps=(0.0, 0.7, 0.0, 1.1)):
    prompts, budgets, temps = _traffic(cfg.vocab_size, temps)
    return [router.submit(p, max_new_tokens=b, temperature=t)
            for p, b, t in zip(prompts, budgets, temps)]


def _wrap_capture(flaky_by_wid, **flaky_kwargs):
    def wrap(wid, role, ch):
        flaky_by_wid[wid] = FlakyTransport(ch, **flaky_kwargs)
        return flaky_by_wid[wid]

    return wrap


# ---------------------------------------------------------------------------
# the wire against the reference encoder
# ---------------------------------------------------------------------------


def _bf16_pair(shape, seed):
    """The same bf16 values as the reference holds them (ml_dtypes) and
    as the port does (raw words)."""
    vals = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32).astype(ml_dtypes.bfloat16)
    return vals, vals.view(np.uint16).view(BF16_WORDS)


def _message_pairs():
    bf_j, bf_t = _bf16_pair((3, 4), 0)
    plain = [np.arange(12, dtype=np.float32).reshape(3, 4),
             np.array([7, 8, 9], dtype=np.int32),
             np.array([1, 2], dtype=np.uint32),
             np.arange(6, dtype=np.int8), np.ones((2, 2), np.float16)]
    meta = {"flight_id": 3, "attempt": 2, "nested": {"a": [1, 2]},
            "traceparent": None}
    return [
        ("control", (jwire.Message("tokens", meta, plain),
                     Message("tokens", meta, plain))),
        ("bfloat16", (jwire.Message("x", {}, [bf_j, plain[0]]),
                      Message("x", {}, [bf_t, plain[0]]))),
        ("empty", (jwire.Message("hb_ack", {"router_t": 1.5}),
                   Message("hb_ack", {"router_t": 1.5}))),
    ]


@pytest.mark.parametrize("name,pair", _message_pairs(),
                         ids=[n for n, _ in _message_pairs()])
def test_frames_byte_identical_to_reference_and_cross_decode(name, pair):
    jmsg, tmsg = pair
    frame = encode_message(tmsg)
    assert frame == jwire.encode_message(jmsg)
    # each side decodes the other's frame to the same bytes
    ours = decode_message(jwire.encode_message(jmsg))
    theirs = jwire.decode_message(frame)
    assert ours.kind == theirs.kind == tmsg.kind
    assert ours.meta == theirs.meta == tmsg.meta
    for a, b, want in zip(ours.buffers, theirs.buffers, tmsg.buffers):
        assert a.tobytes() == b.tobytes() == np.asarray(want).tobytes()
        assert a.shape == b.shape == want.shape
    # the round trip is bit-stable on both sides
    assert encode_message(ours) == frame == jwire.encode_message(theirs)


def test_bf16_words_view_back_as_bfloat16():
    bf_j, bf_t = _bf16_pair((4, 5), 1)
    got = decode_message(encode_message(Message("x", {}, [bf_t])))
    words = got.buffers[0]
    assert words.dtype == np.uint16
    assert (words.dtype.metadata or {}).get("dtype") == "bfloat16"
    t = to_tensor(words, torch.bfloat16)
    assert torch.equal(t.float(), torch.from_numpy(
        bf_j.astype(np.float32)))


def _shipments(quantized, bf16=False):
    """The same shipment as the reference and the port hold it."""
    L, pages, ps, H, D = 2, 5, 8, 2, 4
    rng = np.random.default_rng(3)
    common = dict(prompt=np.arange(20, dtype=np.int32), first_token=17,
                  n_prompt_pages=3, key_raw=np.array([123, 456], np.uint32),
                  temperature=0.7, max_new_tokens=9, eos_token_id=None,
                  src_worker=2, extracted_at=1.25, first_logprob=-0.5)
    j, t = dict(common), dict(common)
    if quantized:
        for k in ("k_pages", "v_pages"):
            j[k] = t[k] = rng.integers(-128, 128, (L, pages, ps, H, D)
                                       ).astype(np.int8)
        for i, k in enumerate(("k_scales", "v_scales")):
            j[k], t[k] = _bf16_pair((L, pages, ps, H), 10 + i)
    elif bf16:
        for i, k in enumerate(("k_pages", "v_pages")):
            j[k], t[k] = _bf16_pair((L, pages, ps, H, D), 20 + i)
    else:
        for k in ("k_pages", "v_pages"):
            j[k] = t[k] = rng.random((L, pages, ps, H, D)).astype(np.float32)
    return JShipment(**j), KVPageShipment(**t)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_shipment_frames_match_reference_and_round_trip(kind):
    jship, tship = _shipments(kind == "int8", bf16=kind == "bf16")
    frame = encode_message(shipment_to_message(
        tship, flight_id=5, attempt=1, worker_id=2))
    assert frame == jwire.encode_message(jwire.shipment_to_message(
        jship, flight_id=5, attempt=1, worker_id=2))
    msg = decode_message(frame)
    assert msg.meta["flight_id"] == 5 and msg.meta["attempt"] == 1
    got = shipment_from_message(msg)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(got, name), getattr(tship, name)
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert got.prompt.tolist() == tship.prompt.tolist()
    assert got.key_raw.tolist() == tship.key_raw.tolist()
    for name in ("first_token", "n_prompt_pages", "temperature",
                 "max_new_tokens", "eos_token_id", "src_worker",
                 "extracted_at", "first_logprob"):
        assert getattr(got, name) == getattr(tship, name), name
    assert got.page_bytes == tship.page_bytes == jship.page_bytes
    # the reference decodes the port's frame into its own shipment
    jgot = jwire.shipment_from_message(jwire.decode_message(frame))
    assert jgot.k_pages.tobytes() == tship.k_pages.tobytes()


def test_malformed_frames_raise_wire_error():
    frame = encode_message(Message("x", {"a": 1},
                                   [np.arange(4, dtype=np.float32)]))
    for bad in (frame[:8], frame[:-3], frame + b"JUNK", b"NOPE" + frame[4:]):
        with pytest.raises(WireError):
            decode_message(bad)
    broken = bytearray(frame)
    broken[16] ^= 0xFF
    with pytest.raises(WireError):
        decode_message(bytes(broken))
    big = Message("x", {}, [np.arange(100, dtype=np.float32)])
    small = encode_message(Message("x", {}, [np.arange(2, dtype=np.float32)]))
    with pytest.raises(WireError):
        decode_message(encode_message(big)[:16] + small[16:])
    ship_msg = shipment_to_message(_shipments(True)[1])
    ship_msg.buffers = ship_msg.buffers[:3]
    with pytest.raises(WireError):
        shipment_from_message(ship_msg)


# ---------------------------------------------------------------------------
# channels
# ---------------------------------------------------------------------------


def _wait(pred, tries=500):
    for _ in range(tries):
        if pred():
            return True
        time.sleep(0.01)
    return False


def _socket_pair(listener, **kw):
    client = SocketChannel.connect("127.0.0.1", listener.port, **kw)
    got = []
    assert _wait(lambda: got.extend(listener.accept_all()) or got)
    return client, got[0]


def test_local_channel_pair_crosses_the_codec():
    a, b = LocalChannel.pair()
    a.send(Message("ping", {"n": 1}, [np.arange(3, dtype=np.int32)]))
    b.send(Message("pong", {"n": 2}))
    got_b, got_a = b.poll(), a.poll()
    assert [m.kind for m in got_b] == ["ping"]
    assert got_b[0].buffers[0].tolist() == [0, 1, 2]
    assert [m.kind for m in got_a] == ["pong"]
    assert a.bytes_sent > 0 and b.bytes_received == a.bytes_sent
    b.close()
    assert a.closed and b.closed
    with pytest.raises(ConnectionError):
        a.send(Message("ping", {}))


def test_socket_channel_roundtrip_and_close_detection():
    listener = ChannelListener("127.0.0.1", 0)
    try:
        client, server = _socket_pair(listener)
        client.send(Message("hello", {"worker_id": 7},
                            [np.arange(5, dtype=np.uint32)]))
        msgs = []
        assert _wait(lambda: msgs.extend(server.poll()) or msgs)
        assert msgs[0].kind == "hello" and msgs[0].meta["worker_id"] == 7
        assert msgs[0].buffers[0].tolist() == [0, 1, 2, 3, 4]
        server.close()
        assert _wait(lambda: client.closed)
        with pytest.raises(ConnectionError):
            client.send(Message("x", {}))
        client.close()
    finally:
        listener.close()


def test_socket_send_queue_bounded_backpressure():
    """With the writer stopped and the bounded queue full, `send` blocks
    until space frees, then completes."""
    listener = ChannelListener("127.0.0.1", 0)
    try:
        raw = socketlib.create_connection(("127.0.0.1", listener.port))
        ch = SocketChannel(raw, send_queue_depth=1)
        ch._sendq.put(None)
        ch._writer.join(timeout=5)
        ch._sendq.put(b"filler")
        done = threading.Event()

        def sender():
            ch.send(Message("shipment", {"flight_id": 1}))
            done.set()

        t = threading.Thread(target=sender, daemon=True)
        t.start()
        time.sleep(0.25)
        assert not done.is_set(), "send returned despite a full queue"
        assert ch._sendq.get() == b"filler"
        assert done.wait(timeout=5), "send never unblocked"
        ch.close()
        with pytest.raises(ConnectionError):
            ch.send(Message("x", {}))
        for c in listener.accept_all():
            c.close()
    finally:
        listener.close()


def test_socket_close_joins_io_threads():
    listener = ChannelListener("127.0.0.1", 0)
    try:
        client, server = _socket_pair(listener)
        assert client._reader.is_alive() and client._writer.is_alive()
        client.close()
        assert not client._reader.is_alive(), "reader leaked past close()"
        assert not client._writer.is_alive(), "writer leaked past close()"
        # the peer's reader closes the channel from its own thread
        assert _wait(lambda: server.closed)
        server.close()
        assert _wait(lambda: not (server._reader.is_alive()
                                  or server._writer.is_alive()))
    finally:
        listener.close()


def test_flaky_transport_is_deterministic_and_injects_all_faults():
    def run_once():
        a, b = LocalChannel.pair()
        flaky = FlakyTransport(a, flake_rate=0.5, seed=42, delay_ticks=1)
        for i in range(20):
            b.send(Message("m", {"i": i}))
            flaky.send(Message("r", {"i": i}))
        seen = [m.meta["i"] for m in flaky.poll()]
        for _ in range(5):
            seen += [m.meta["i"] for m in flaky.poll()]
        return seen, dict(flaky.faults), [m.meta["i"] for m in b.poll()]

    first, second = run_once(), run_once()
    assert first == second, "seeded fault plan must replay identically"
    seen, faults, _ = first
    assert faults
    assert seen != list(range(20))
    a, b = LocalChannel.pair()
    flaky = FlakyTransport(
        a, rules=lambda d, kind, seq: {1: "drop", 2: "dup"}.get(seq, "ok"))
    for i in range(4):
        b.send(Message("m", {"i": i}))
    assert [m.meta["i"] for m in flaky.poll()] == [0, 2, 2, 3]
    assert flaky.faults == {"recv:drop": 1, "recv:dup": 1}


def test_flaky_transport_hang_and_kill():
    a, b = LocalChannel.pair()
    flaky = FlakyTransport(a)
    flaky.hang()
    flaky.send(Message("m", {}))
    assert b.poll() == []
    b.send(Message("m", {}))
    assert flaky.poll() == []
    assert not flaky.closed
    flaky.kill()
    assert flaky.closed
    with pytest.raises(ConnectionError):
        flaky.send(Message("m", {}))


# ---------------------------------------------------------------------------
# the in-process distributed pod: exactness
# ---------------------------------------------------------------------------


def test_distributed_pod_byte_identical_to_single_engine(
        gpt2_setup, ref_outputs):
    cfg, params = gpt2_setup
    router, _ = _build_pod(cfg, params, pf=1, dec=2)
    reqs = _submit_traffic(router, cfg)
    _drive(router, reqs)
    assert [list(r.tokens) for r in reqs] == ref_outputs[0]
    assert [list(r.logprobs) for r in reqs] == ref_outputs[1]
    assert router.compile_stats() == {
        "admit": 1, "prefill": 1, "decode": 1, "extract": 1, "install": 1}
    ms = router.metrics_summary()
    assert ms["pod_shipments"] == 4.0
    assert ms["pod_workers_lost"] == 0.0
    assert ms["pod_requests_replayed"] == 0.0
    req = router.submit(_traffic(cfg.vocab_size)[0][0], max_new_tokens=6)
    assert list(router.stream(req)) == req.tokens
    router.close()


def test_distributed_pod_greedy_equals_jax_distributed_pod(weights):
    cfg_j, cfg, pj, params = weights
    greedy = (0.0,) * 4
    jrouter, _ = jbuild(
        jg, cfg_j, pj, engine_config=JConfig(cache_dtype=jnp.float32,
                                             **_BASE),
        pod_config=JDPodConfig(prefill_workers=1, decode_workers=2,
                               heartbeat_interval_s=0.0, rebalance=False),
        clock=_fake_clock())
    jreqs = _submit_traffic(jrouter, cfg_j, greedy)
    _drive(jrouter, jreqs)
    jrouter.close()
    router, _ = _build_pod(cfg, params, pf=1, dec=2)
    reqs = _submit_traffic(router, cfg, greedy)
    _drive(router, reqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    for a, b in zip(reqs, jreqs):
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-5)
    assert router.metrics_summary()["pod_shipments"] == \
        jrouter.metrics_summary()["pod_shipments"]
    router.close()


def test_step_never_sleeps_on_the_callers_thread(gpt2_setup, monkeypatch):
    import accelerate_tpu_torch.serving.pod.distributed.droute as droute_mod

    cfg, params = gpt2_setup
    router, _ = _build_pod(cfg, params)
    main = threading.current_thread()
    slept = []
    real_sleep = time.sleep

    def spy(seconds):
        if threading.current_thread() is main:
            slept.append(seconds)
        real_sleep(seconds)

    monkeypatch.setattr(droute_mod.time, "sleep", spy)
    for _ in range(20):
        router.step()
    assert router.last_step_worked is False
    assert slept == [], "idle step() slept on the caller's thread"
    reqs = _submit_traffic(router, cfg)
    _drive(router, reqs)
    assert slept == [], "busy step() slept on the caller's thread"
    router.close()


# ---------------------------------------------------------------------------
# failure recovery: exact, nothing lost or duplicated
# ---------------------------------------------------------------------------


def _faulty_run(gpt2_setup, fault, **kw):
    """Drive the trace through a 1-prefill pod whose links `fault`
    wraps; returns (router, requests, injected faults)."""
    cfg, params = gpt2_setup
    flaky = {}
    router, _ = _build_pod(cfg, params, wrap=fault(flaky), **kw)
    reqs = _submit_traffic(router, cfg)
    return router, reqs, flaky


def _prefill_rules(rules):
    def fault(flaky):
        def wrap(wid, role, ch):
            if role != "prefill":
                return ch
            flaky[wid] = FlakyTransport(ch, rules=rules)
            return flaky[wid]

        return wrap

    return fault


def test_dropped_shipment_recovers_via_stalled_replay(
        gpt2_setup, ref_outputs):
    state = {"dropped": 0}

    def rules(direction, kind, seq):
        if direction == "recv" and kind == "shipment" \
                and state["dropped"] == 0:
            state["dropped"] += 1
            return "drop"
        return "ok"

    router, reqs, _ = _faulty_run(gpt2_setup, _prefill_rules(rules),
                                  flight_timeout_s=1.0)
    _drive(router, reqs)
    assert [list(r.tokens) for r in reqs] == ref_outputs[0]
    assert state["dropped"] == 1
    ms = router.metrics_summary()
    assert ms["pod_requests_replayed"] >= 1.0
    assert ms["pod_workers_lost"] == 0.0
    assert any(e["recovery_reason"] == "stalled"
               for e in router.recovery_log)
    router.close()


def test_duplicated_shipment_is_dropped_as_stale(gpt2_setup, ref_outputs):
    def rules(direction, kind, seq):
        return "dup" if direction == "recv" and kind == "shipment" else "ok"

    router, reqs, _ = _faulty_run(gpt2_setup, _prefill_rules(rules))
    _drive(router, reqs)
    assert [list(r.tokens) for r in reqs] == ref_outputs[0]
    ms = router.metrics_summary()
    assert ms["pod_stale_messages"] >= 1.0
    assert ms["pod_requests_replayed"] == 0.0
    router.close()


def _decode_victim(router, steps=6):
    for _ in range(steps):
        router.step()
    victims = {f.worker for f in router._flights.values()
               if f.phase == "decode"}
    assert victims, f"no decode flight landed in {steps} steps"
    return victims.pop()


def test_killed_decode_worker_recovers_all_flights_exactly(
        gpt2_setup, ref_outputs):
    router, reqs, flaky = _faulty_run(gpt2_setup, _wrap_capture_factory(),
                                      dec=2)
    victim = _decode_victim(router)
    assert any(0 < len(f.user.tokens) for f in router._flights.values()
               if f.phase == "decode" and f.worker == victim)
    flaky[victim].kill()
    _drive(router, reqs)
    assert [list(r.tokens) for r in reqs] == ref_outputs[0]
    # a replayed token's logprob comes from the chunked prefill program
    # instead of the decode step: same math, another reduction order
    for got_lp, ref_lp in zip((list(r.logprobs) for r in reqs),
                              ref_outputs[1]):
        assert np.allclose(got_lp, ref_lp, rtol=0, atol=1e-5)
    ms = router.metrics_summary()
    assert ms["pod_workers_lost"] == 1.0
    assert ms["pod_requests_replayed"] >= 1.0
    assert all(e["recovery_reason"] == "channel_drop"
               for e in router.recovery_log)
    assert not router.workers[victim].alive
    router.close()


def _wrap_capture_factory(**flaky_kwargs):
    return lambda flaky: _wrap_capture(flaky, **flaky_kwargs)


def test_killed_prefill_worker_requeues_flights(gpt2_setup, ref_outputs):
    router, reqs, flaky = _faulty_run(gpt2_setup, _wrap_capture_factory())
    router.step()
    assert any(f.phase == "prefill" for f in router._flights.values())
    flaky[0].kill()   # worker 0 is the prefill worker
    _drive(router, reqs)
    assert [list(r.tokens) for r in reqs] == ref_outputs[0]
    assert router.metrics_summary()["pod_workers_lost"] == 1.0
    assert any(e["recovery_reason"] == "channel_drop"
               for e in router.recovery_log)
    router.close()


def test_hung_worker_detected_by_heartbeat_timeout(gpt2_setup, ref_outputs):
    router, reqs, flaky = _faulty_run(
        gpt2_setup, _wrap_capture_factory(), dec=2,
        heartbeat_timeout_s=1.0, flight_timeout_s=30.0,
        busy_heartbeat_timeout_s=1.0)
    flaky[_decode_victim(router)].hang()
    _drive(router, reqs)
    assert [list(r.tokens) for r in reqs] == ref_outputs[0]
    assert router.metrics_summary()["pod_workers_lost"] == 1.0
    assert any(e["recovery_reason"] == "heartbeat_timeout"
               for e in router.recovery_log)
    router.close()


def test_no_lost_requests_under_flake_storm(gpt2_setup, ref_outputs):
    router, reqs, flaky = _faulty_run(
        gpt2_setup,
        _wrap_capture_factory(flake_rate=0.05, seed=11, delay_ticks=2),
        dec=2, flight_timeout_s=1.0, max_attempts=10)
    _drive(router, reqs, max_steps=20000)
    assert all(r.status.value == "finished" for r in reqs), \
        [(r.status.value, r.reject_reason) for r in reqs]
    assert [list(r.tokens) for r in reqs] == ref_outputs[0]
    assert sum(f.faults.total() for f in flaky.values()) > 0
    router.close()


# ---------------------------------------------------------------------------
# elastic rebalancing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0.2, 1e9])
def test_rebalance_converts_once_per_window(gpt2_setup, window):
    """2 prefill + 1 decode with decode saturated: one idle prefill
    worker converts to decode, once per window; a window longer than
    the run converts nothing, whatever the startup pressure."""
    cfg, params = gpt2_setup
    router, _ = _build_pod(cfg, params, pf=2, dec=1, rebalance=True,
                           rebalance_window_s=window,
                           occupancy_high=0.5, occupancy_low=0.1)
    prompts, _, _ = _traffic(cfg.vocab_size)
    reqs = [router.submit(p, max_new_tokens=8)
            for p in prompts + prompts[:2]]
    _drive(router, reqs)
    ptd = router._c_conversions["prefill_to_decode"].value
    assert router._c_conversions["decode_to_prefill"].value == 0.0
    roles = sorted(w.role for w in router.workers.values())
    if window < 1:
        assert ptd == 1.0, (ptd, router.debug_pod())
        assert roles == ["decode", "decode", "prefill"]
    else:
        assert ptd == 0.0
        assert roles == ["decode", "prefill", "prefill"]
    assert all(r.status.value == "finished" for r in reqs)
    router.close()


# ---------------------------------------------------------------------------
# telemetry merge, tracing, fleet bundles, sanitizer
# ---------------------------------------------------------------------------


def test_worker_snapshots_merge_into_router_exposition(gpt2_setup):
    from accelerate_tpu_torch.telemetry.export import render_prometheus

    cfg, params = gpt2_setup
    router, _ = _build_pod(cfg, params)
    reqs = _submit_traffic(router, cfg)
    _drive(router, reqs)
    for _ in range(3):   # the heartbeats after the last tokens
        router.step()
    assert all(w.snapshot for w in router.workers.values())
    reg = router.exposition_registry()
    rows = {(kind, name, labels): metric
            for kind, name, labels, metric in reg.items()}
    assert any(name == "serving_pod_shipments_total" and not labels
               for (_k, name, labels) in rows)
    merged = {name: m.value for (kind, name, labels), m in rows.items()
              if kind == "counter"
              and dict(labels).get("origin") == "workers"}
    assert merged.get("serving_tokens_out_total", 0) > 0
    assert any(name.endswith("__slowest_host_mean")
               for (_k, name, _l) in rows)
    text = render_prometheus(reg)
    assert 'serving_decode_path_total{origin="workers",path="dense"}' in text
    router.close()


def test_sanitizer_catches_corrupted_router_books(gpt2_setup):
    cfg, params = gpt2_setup
    router, _ = _build_pod(cfg, params)
    reqs = _submit_traffic(router, cfg)
    for _ in range(4):
        router.step()
    check_distributed_router(router)
    flight = next(iter(router._flights.values()))
    orig_phase = flight.phase
    flight.phase = "teleporting"
    with pytest.raises(SanitizerViolation):
        check_distributed_router(router)
    flight.phase = orig_phase
    handle = router.workers[flight.worker] if flight.worker >= 0 else None
    if handle is not None:
        handle.alive, handle.lost = False, True
        with pytest.raises(SanitizerViolation, match="LOST worker"):
            check_distributed_router(router)
        handle.alive, handle.lost = True, False
    router._pending.append(flight.flight_id)
    with pytest.raises(SanitizerViolation):
        check_distributed_router(router)
    router._pending.pop()
    key, val = next(iter(router._by_user.items()))
    del router._by_user[key]
    with pytest.raises(SanitizerViolation, match="user-index"):
        check_distributed_router(router)
    router._by_user[key] = val
    check_distributed_router(router)
    _drive(router, reqs)
    router.close()


@pytest.fixture
def _traced():
    from accelerate_tpu_torch.telemetry.trace import (
        clear_flight_recorder,
        configure_tracing,
    )

    configure_tracing(enabled=True, annotate=False, default_sample_rate=1.0)
    yield
    configure_tracing(enabled=False, default_sample_rate=0.0)
    clear_flight_recorder()


def test_tracing_staleness_and_fleet_bundle(gpt2_setup, ref_outputs,
                                            _traced, tmp_path, capsys):
    """One pod and one kill: every request's router and worker spans in
    one ordered trace, the replay span linked to the failed dispatch, the
    lost worker's snapshot served stale then dropped past the horizon,
    one fleet bundle with an honest hole for the dead worker, rendered by
    `python -m accelerate_tpu_torch.commands.incident show`."""
    from accelerate_tpu_torch.commands.incident import _run_show
    from accelerate_tpu_torch.telemetry.trace import trace_events

    cfg, params = gpt2_setup
    flaky = {}
    # a real clock: worker spans are rebased by the NTP offset estimate
    router, _ = _build_pod(cfg, params, dec=2, wrap=_wrap_capture(flaky),
                           engine_config=_ec(incident_dir=str(tmp_path)),
                           clock=time.monotonic,
                           fleet_bundle_min_interval_s=0.0)
    reqs = _submit_traffic(router, cfg)
    victim = _decode_victim(router)
    flaky[victim].kill()
    _drive(router, reqs)
    assert [list(r.tokens) for r in reqs] == ref_outputs[0]
    assert router.workers[victim].lost

    legs = ("serving.pod.prefill", "serving.page_transfer",
            "serving.pod.install")
    for r in reqs:
        assert r.trace_sampled and isinstance(r.trace_id, str)
        by_name = {}
        for e in trace_events(r.trace_id):
            by_name.setdefault(e["name"], []).append(e)
        assert {"serving.pod.dispatch", *legs} <= set(by_name), \
            sorted(by_name)
        ends: dict = {}
        for name in legs:
            for e in by_name[name]:
                by = ends.setdefault(e["attrs"]["attempt"], {})
                by[name] = max(by.get(name, 0), e["start_ns"] + e["dur_ns"])
        full = [by for by in ends.values() if len(by) == len(legs)]
        assert full, ends
        for by in full:
            assert by[legs[0]] <= by[legs[1]] <= by[legs[2]], ends

    replayed = {e["request_id"] for e in router.recovery_log
                if e["recovery_reason"] == "channel_drop"}
    assert replayed
    for r in reqs:
        if r.request_id not in replayed:
            continue
        events = trace_events(r.trace_id)
        dispatch_ids = {e["span_id"] for e in events
                        if e["name"] == "serving.pod.dispatch"}
        replays = [e for e in events if e["name"] == "serving.replay"]
        assert replays
        for ev in replays:
            assert ev["attrs"]["recovery_reason"] == "channel_drop"
            assert set(ev.get("links") or ()) & dispatch_ids

    rows = [(name, dict(labels))
            for _k, name, labels, _m in router.exposition_registry().items()]
    ages = {lab["worker"] for n, lab in rows
            if n == "serving_pod_worker_snapshot_age_seconds"}
    assert str(victim) in ages and len(ages) >= 2
    assert any(lab.get("stale") == "true" for _n, lab in rows)
    router.pod_config = dataclasses.replace(router.pod_config,
                                            snapshot_stale_after_s=0.0)
    rows2 = [dict(labels)
             for _k, _n, labels, _m in router.exposition_registry().items()]
    assert not any(lab.get("stale") == "true" for lab in rows2)
    assert any(lab.get("origin") == "workers" for lab in rows2)

    fleet = [p for p in tmp_path.iterdir()
             if f"fleet-loss-w{victim}" in p.name]
    assert fleet, [p.name for p in tmp_path.iterdir()]
    bundle = fleet[0]
    report = json.loads((bundle / "report.json").read_text())
    assert report["kind"] == "fleet_incident"
    assert report["reason"] == "channel_drop"
    offsets = json.loads((bundle / "clock_offsets.json").read_text())
    assert offsets[str(victim)]["lost"]
    dead = json.loads((bundle / f"worker_{victim}.json").read_text())
    assert "worker_error" in dead
    alive = [json.loads(p.read_text()) for p in bundle.glob("worker_*.json")
             if p.name != f"worker_{victim}.json"]
    assert alive and "jobs" in alive[0] and "engine" in alive[0]
    assert _run_show(str(tmp_path), bundle.name, "text") == 0
    out = capsys.readouterr().out
    assert "fleet clock offsets" in out
    assert f"worker {victim}: UNREACHABLE" in out
    router.close()


def test_clock_sync_span_ingest_and_busy_deferral(gpt2_setup, _traced):
    from accelerate_tpu_torch.telemetry.trace import trace_events

    cfg, params = gpt2_setup
    now = [0.0]
    router, _ = _build_pod(cfg, params, clock=lambda: now[0],
                           heartbeat_interval_s=1e9, heartbeat_timeout_s=0.5,
                           busy_heartbeat_timeout_s=5.0)
    handle = next(iter(router.workers.values()))
    # NTP estimate: mask `local` so the handle counts as remote
    handle.local = None
    handle.clock_offset_s = handle.clock_rtt_s = None
    router._sync_worker_clock(handle, {"t": 95.0}, 100.0)
    assert handle.clock_offset_s == pytest.approx(5.0)
    assert handle.clock_rtt_s is None
    router._sync_worker_clock(
        handle, {"t": 96.0, "ack": {"router_t": 100.5,
                                    "worker_recv_t": 95.6}}, 101.0)
    assert handle.clock_rtt_s == pytest.approx(0.1)
    assert handle.clock_offset_s == pytest.approx(4.9875)
    router._sync_worker_clock(
        handle, {"t": 200.0, "ack": {"router_t": 100.9,
                                     "worker_recv_t": 95.9}}, 101.0)
    assert handle.clock_offset_s == pytest.approx(4.9875)
    router._sync_worker_clock(handle, {"t": 90.0}, 102.0)
    assert handle.clock_offset_s == pytest.approx(4.9875)
    gauges = {labels: m.value
              for kind, name, labels, m in router.registry.items()
              if name == "serving_pod_worker_clock_offset_seconds"}
    assert gauges[(("worker", str(handle.worker_id)),)] \
        == pytest.approx(4.9875)

    handle.clock_offset_s = 2.0
    before = router._c_spans.value
    ev = {"name": "w-side", "trace_id": "req-dedup",
          "start_ns": 1_000, "dur_ns": 5}
    router._ingest_worker_spans(handle, {"spans": [ev], "span_seq": 5}, 1.0)
    got = trace_events("req-dedup")
    assert len(got) == 1
    assert got[0]["start_ns"] == 1_000 + int(2.0 * 1e9)
    router._ingest_worker_spans(handle, {"spans": [ev], "span_seq": 5}, 2.0)
    assert len(trace_events("req-dedup")) == 1
    router._ingest_worker_spans(
        handle, {"spans": [dict(ev, span_id=9)], "span_seq": 6}, 3.0)
    assert len(trace_events("req-dedup")) == 2
    assert router._c_spans.value == before + 2

    for h in router.workers.values():
        h.alive, h.last_heartbeat, h.busy = True, 0.0, True
    handle, other = list(router.workers.values())[:2]
    now[0] = 2.0
    router._detect_failures()
    assert not handle.lost and not other.lost, \
        "busy-not-dead became a phantom loss"
    handle.busy = False
    router._detect_failures()
    assert handle.lost and not other.lost
    now[0] = 6.0
    router._detect_failures()
    assert other.lost
    router.close()


# ---------------------------------------------------------------------------
# two real worker processes over TCP
# ---------------------------------------------------------------------------

SPEC = {"family": "gpt2", "seed": 0, "num_slots": 3, "max_len": 64,
        "prefill_chunk": 8, "page_size": 8, "cache_dtype": "float32"}


def test_socket_pod_two_worker_processes_exact_and_recovering(tmp_path):
    """`pod-worker` processes (`python -m accelerate_tpu_torch.commands.
    pod`, on the CPU) dial a `ChannelListener`: greedy and sampled
    streams equal a single engine built from the same spec, programs
    built once; then the decode worker's process is SIGKILLed
    mid-stream and every request finishes byte-identical on the
    survivor. Every wait has a deadline inside this test's own limit."""
    from accelerate_tpu_torch.commands.pod import spawn_socket_workers
    from accelerate_tpu_torch.serving.pod.distributed.worker import (
        build_worker_engine,
        engine_config_from_spec,
    )

    t_end = time.monotonic() + TWO_PROCESS_DEADLINE_S
    listener = ChannelListener("127.0.0.1", 0)
    log = open(tmp_path / "workers.log", "w")
    procs = spawn_socket_workers(
        listener.port, SPEC, ["prefill", "decode"],
        heartbeat_interval_s=0.05, device="cpu",
        env=dict(os.environ, OMP_NUM_THREADS="1"), stderr=log)
    router = None
    try:
        _fam, cfg, _params, ref = build_worker_engine(SPEC, device="cpu")
        rng = np.random.default_rng(7)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                   for n in (5, 11, 3, 9)]
        temps = [0.0, 0.7, 0.0, 1.1]
        batches = ([8, 8, 6, 6], [24, 24, 16, 16])
        want = []
        for budgets in batches:
            rs = [ref.submit(np.asarray(p, np.int32), max_new_tokens=b,
                             temperature=t)
                  for p, b, t in zip(prompts, budgets, temps)]
            ref.run_until_idle()
            want.append([list(r.tokens) for r in rs])
        router = DistributedPodRouter(
            engine_config=engine_config_from_spec(SPEC),
            pod_config=DistributedPodConfig(
                heartbeat_interval_s=0.05, heartbeat_timeout_s=120.0,
                flight_timeout_s=300.0, rebalance=False),
            listener=listener)

        def pump(until, what):
            while not until():
                router.step()
                assert all(p.poll() is None for p in procs
                           if p is not victim_proc), \
                    [p.returncode for p in procs]
                assert time.monotonic() < t_end, (what, router.debug_pod())
                time.sleep(0.002)

        victim_proc = None
        pump(lambda: sum(w.alive for w in router.workers.values()) == 2,
             "workers never joined")
        reqs = [router.submit(p, max_new_tokens=b, temperature=t)
                for p, b, t in zip(prompts, batches[0], temps)]
        pump(lambda: all(r.done for r in reqs), "phase 1 wedged")
        assert [list(r.tokens) for r in reqs] == want[0]
        pump(lambda: router.compile_stats() == {
            "admit": 1, "prefill": 1, "decode": 1, "extract": 1,
            "install": 1}, "compile stats never reported")

        reqs = [router.submit(p, max_new_tokens=b, temperature=t)
                for p, b, t in zip(prompts, batches[1], temps)]
        victim = next(w for w in router.workers.values()
                      if w.role == "decode")
        pump(lambda: any(f.phase == "decode" and f.worker ==
                         victim.worker_id and 0 < len(f.user.tokens) <
                         f.user.max_new_tokens - 2
                         for f in router._flights.values()),
             "no decode flight to kill")
        victim_proc = procs[victim.worker_id]
        os.kill(victim_proc.pid, signal.SIGKILL)
        pump(lambda: all(r.done for r in reqs), "recovery wedged")
        assert [list(r.tokens) for r in reqs] == want[1]
        assert router.metrics_summary()["pod_workers_lost"] == 1.0
    finally:
        if router is not None:
            router.close()
        listener.close()
        for p in procs:
            try:
                p.wait(timeout=max(1.0, t_end - time.monotonic()))
            except Exception:
                p.kill()
                p.wait()
        log.close()
    survivor = [p for p in procs if p.pid != victim_proc.pid]
    assert [p.returncode for p in survivor] == [0], \
        (tmp_path / "workers.log").read_text()[-2000:]
