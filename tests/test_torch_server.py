"""The port's HTTP front door (`accelerate_tpu_torch.server`) against the
JAX package's.

The slice as a whole: the same greedy request through the reference's
stack (`HttpFrontDoor` over the JAX llama engine) and through the port's
(over the port's engine on the CPU), on the same converted fp32
`LlamaConfig.tiny()` weights, gives the same SSE `token_ids` and the
same unary text; `--dry-run` prints the same JSON line for the same
flags. The framework-free modules (protocol, tokenizer, tenant config,
stop sequences) run their reference cases on both packages. The rest
mirrors `tests/test_server.py` on the port's server: routes, 4xx at the
door, 413, 429 with Retry-After and the shed reason, 503 while
draining, a disconnect freeing its slot, the drive loop's death
answering 500, `traceparent` and `x-request-id`, `/metrics` in both
expositions, the `/debug` routes and the `/debug/profile` capture.
Sampled streams cannot match the reference's threefry bits; they are
pinned within the port (HTTP against the engine driven directly, with
the documented seed-to-key rule)."""

import argparse
import asyncio
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_numpy

BASE = dict(num_slots=2, max_len=64, prefill_chunk=8, page_size=8)
PACKAGES = ("jax", "torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's thread pool costs more than it saves here,
    most of all with several test workers sharing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mods(pkg: str) -> argparse.Namespace:
    """One package's server modules, by name."""
    if pkg == "jax":
        from accelerate_tpu.server import config, http, protocol, service
        from accelerate_tpu.server import tokenizer
        from accelerate_tpu.telemetry import trace
    else:
        from accelerate_tpu_torch.server import config, http, protocol
        from accelerate_tpu_torch.server import service, tokenizer
        from accelerate_tpu_torch.telemetry import trace
    return argparse.Namespace(config=config, http=http, protocol=protocol,
                              service=service, tokenizer=tokenizer,
                              trace=trace)


@pytest.fixture(scope="module")
def weights():
    cfg_j = jl.LlamaConfig.tiny()
    pj = jl.init_params(cfg_j, jax.random.key(0))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return cfg_j, tl.LlamaConfig.tiny(), pj, pt


def _make_engine(pkg, weights, **overrides):
    cfg_j, cfg_t, pj, pt = weights
    kw = dict(BASE, **overrides)
    if pkg == "jax":
        from accelerate_tpu.serving import Engine, EngineConfig

        return Engine(jl, cfg_j, pj, EngineConfig(cache_dtype=jnp.float32,
                                                  **kw)), cfg_j
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    return Engine(tl, cfg_t, pt, EngineConfig(cache_dtype=torch.float32,
                                              **kw), device="cpu"), cfg_t


def _stack(weights, server_cfg=None, pkg="torch", **engine_overrides):
    m = _mods(pkg)
    engine, cfg = _make_engine(pkg, weights, **engine_overrides)
    tok = m.tokenizer.get_tokenizer(
        server_cfg.tokenizer if server_cfg else "auto", cfg.vocab_size)
    service = m.service.InferenceService(
        engine, tok, server_cfg or m.config.ServerConfig(port=0))
    return m.http.HttpFrontDoor(service), engine, cfg


def _config(**kw):
    from accelerate_tpu_torch.server.config import ServerConfig

    return ServerConfig(port=0, **kw)


async def _raw(port, data: bytes) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(data)
    await writer.drain()
    out = await reader.read()
    writer.close()
    return out


async def _call(port, path, body=None, headers=None):
    payload = json.dumps(body).encode() if body is not None else b""
    method = b"POST" if body is not None else b"GET"
    hdr = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    raw = await _raw(port, b"%s %s HTTP/1.1\r\nHost: t\r\n%s"
                     b"Content-Length: %d\r\n\r\n%s"
                     % (method, path.encode(), hdr.encode(), len(payload),
                        payload))
    head, _, body_out = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), head, body_out


def _sse_token_ids(stream_body: bytes) -> list[int]:
    ids = []
    for frame in stream_body.split(b"\n\n"):
        if not frame.startswith(b"data: ") or frame.startswith(b"data: [DONE]"):
            continue
        choice = json.loads(frame[len(b"data: "):])["choices"][0]
        ids.extend(choice.get("token_ids")
                   or choice.get("delta", {}).get("token_ids") or [])
    return ids


def _header(head: bytes, name: bytes) -> bytes | None:
    for line in head.split(b"\r\n"):
        key, _, value = line.partition(b":")
        if key.strip().lower() == name:
            return value.strip()
    return None


def _run(door, coro):
    """Start the stack, run the test coroutine, always stop cleanly."""
    async def wrapper():
        await door.start()
        try:
            return await coro(door.port)
        finally:
            await door.stop()

    return asyncio.run(wrapper())


@pytest.fixture
def port_tracing():
    """The port's tracing state reset around a test."""
    from accelerate_tpu_torch.telemetry import trace

    trace.configure_tracing(enabled=False, sample_rates={},
                            default_sample_rate=1.0)
    trace.clear_flight_recorder()
    yield trace
    trace.configure_tracing(enabled=False, sample_rates={},
                            default_sample_rate=1.0)
    trace.clear_flight_recorder()


# ---------------------------------------------------------------------------
# the slice against the reference: same weights, same requests
# ---------------------------------------------------------------------------


PROMPTS = ([5, 9, 2, 11, 4], list(range(1, 14)), [200, 3, 77],
           [17] * 9)


def _greedy_over_http(weights, pkg):
    door, engine, cfg = _stack(weights, pkg=pkg)

    async def scenario(port):
        out = []
        for prompt in PROMPTS:
            st, _, body = await _call(
                port, "/v1/completions",
                {"prompt": prompt, "max_tokens": 6, "stream": True,
                 "temperature": 0})
            assert st == 200 and body.rstrip().endswith(b"data: [DONE]")
            streamed = _sse_token_ids(body)
            st, _, body = await _call(
                port, "/v1/completions",
                {"prompt": prompt, "max_tokens": 6, "temperature": 0})
            assert st == 200
            choice = json.loads(body)["choices"][0]
            out.append((streamed, choice["token_ids"], choice["text"],
                        choice["finish_reason"]))
        st, _, body = await _call(
            port, "/v1/chat/completions",
            {"messages": [{"role": "user", "content": "héllo"}],
             "max_tokens": 5, "temperature": 0})
        assert st == 200
        out.append(json.loads(body)["choices"][0]["message"]["content"])
        return out

    return _run(door, scenario)


def test_greedy_sse_token_ids_and_text_equal_the_jax_server(weights):
    """Acceptance: the same greedy requests through the JAX server and
    the port's give the same SSE token ids, the same unary token ids and
    text, and the same chat reply."""
    ref = _greedy_over_http(weights, "jax")
    got = _greedy_over_http(weights, "torch")
    assert got == ref
    for streamed, unary, _, reason in got[:-1]:
        assert streamed == unary and len(unary) == 6 and reason == "length"


def _dry_run(pkg, flags, capsys) -> dict:
    if pkg == "jax":
        from accelerate_tpu.commands.serve import register_subcommand

        parser = argparse.ArgumentParser()
        register_subcommand(parser.add_subparsers())
        args = parser.parse_args(["serve", "--dry-run", *flags])
        rc = args.func(args)
    else:
        from accelerate_tpu_torch.commands.serve import main

        rc = main(["--dry-run", *flags])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    [],
    ["--family", "gpt2"],
    ["--slots", "8", "--max-len", "256", "--prefill-chunk", "16",
     "--port", "0", "--model-id", "m", "--debug-endpoints", "--trace"],
    ["--tenants", "gold:priority=0,weight=4,slo=0.25;bronze:weight=1",
     "--reject-unknown-tenants", "--no-prefix-cache", "--tokenizer",
     "byte", "--seed", "3", "--page-size", "8"],
], ids=["defaults", "family_gpt2", "capacity_debug_trace",
        "tenants_policy"])
def test_dry_run_json_equals_the_reference(flags, capsys):
    assert _dry_run("torch", flags, capsys) == _dry_run("jax", flags,
                                                        capsys)


@pytest.mark.parametrize("flags,needs", [
    (["--watchdog-timeout-s", "5"], None),
    (["--strict", "warn"], "static-analysis"),
    (["--incident-dir", "x"], None),
], ids=["watchdog", "strict", "incident_dir"])
def test_serve_refuses_what_the_port_lacks(flags, needs, capsys):
    """`--strict` is still refused (exit 2, naming its slice); the
    watchdog and incident-dir flags pass the dry run with the
    reference's JSON line."""
    from accelerate_tpu_torch.commands.serve import main

    if needs is None:
        assert _dry_run("torch", flags, capsys) == _dry_run("jax", flags,
                                                            capsys)
        return
    assert main(["--dry-run", *flags]) == 2
    assert needs in capsys.readouterr().err


# ---------------------------------------------------------------------------
# framework-free modules: the reference's cases on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
class TestProtocol:
    def test_minimal_completion_parses(self, pkg):
        p = _mods(pkg).protocol.parse_completion_request(
            {"prompt": "hi", "max_tokens": 3}, 64)
        assert p.prompt_text == "hi" and p.max_tokens == 3
        assert p.n == 1 and p.best_of == 1 and not p.stream

    def test_prompt_as_token_ids(self, pkg):
        p = _mods(pkg).protocol.parse_completion_request(
            {"prompt": [1, 2, 3]}, 64)
        assert p.prompt_ids == [1, 2, 3] and p.prompt_text is None

    @pytest.mark.parametrize("body,frag", [
        ("notadict", "JSON object"),
        ({}, "'prompt' is required"),
        ({"prompt": ""}, "empty"),
        ({"prompt": []}, "empty"),
        ({"prompt": [1, -2]}, "nonnegative"),
        ({"prompt": {"x": 1}}, "string or an array"),
        ({"prompt": "x", "max_tokens": 0}, "max_tokens"),
        ({"prompt": "x", "max_tokens": "4"}, "integer"),
        ({"prompt": "x", "temperature": -1}, "temperature"),
        ({"prompt": "x", "n": 99}, "'n'"),
        ({"prompt": "x", "best_of": 2, "n": 3}, "best_of"),
        ({"prompt": "x", "stream": "yes"}, "stream"),
        ({"prompt": "x", "stop": ["a"] * 5}, "stop"),
        ({"prompt": "x", "seed": 1.5}, "seed"),
    ])
    def test_rejects_malformed(self, pkg, body, frag):
        proto = _mods(pkg).protocol
        with pytest.raises(proto.ProtocolError) as ei:
            proto.parse_completion_request(body, 64)
        assert ei.value.status == 400 and frag in str(ei.value)

    def test_best_of_cannot_stream(self, pkg):
        proto = _mods(pkg).protocol
        with pytest.raises(proto.ProtocolError, match="streamed"):
            proto.parse_completion_request(
                {"prompt": "x", "n": 1, "best_of": 3, "stream": True}, 64)

    def test_chat_renders_deterministic_template(self, pkg):
        proto = _mods(pkg).protocol
        msgs = [{"role": "system", "content": "s"},
                {"role": "user", "content": "u"}]
        a = proto.parse_chat_request({"messages": msgs}, 64)
        b = proto.parse_chat_request({"messages": msgs}, 64)
        assert a.prompt_text == b.prompt_text
        assert a.prompt_text.endswith("<|assistant|>\n")

    def test_chat_rejects_bad_messages(self, pkg):
        proto = _mods(pkg).protocol
        for bad in ([], [{"role": "alien", "content": "x"}],
                    [{"role": "user"}]):
            with pytest.raises(proto.ProtocolError):
                proto.parse_chat_request({"messages": bad}, 64)

    def test_envelopes_and_sse_frames_agree(self, pkg):
        """The response builders give the reference's bytes."""
        ref, got = _mods("jax").protocol, _mods(pkg).protocol
        choices = [{"index": 0, "text": "a", "token_ids": [1],
                    "logprobs": None, "finish_reason": "stop"}]
        for name, args in (
                ("completion_response", ("id", "m", 1, choices,
                                         {"prompt_tokens": 1})),
                ("completion_chunk", ("id", "m", 1, 0, "a", [1], None)),
                ("error_body", ("boom",)),
                ("usage_block", (2, 3)),
                ("logprobs_block", ([1, 2], [-0.5, -1.5]))):
            assert getattr(got, name)(*args) == getattr(ref, name)(*args)
        payload = got.completion_chunk("id", "m", 1, 0, "a", [1], None)
        assert got.sse_event(payload) == ref.sse_event(payload)
        assert got.SSE_DONE == ref.SSE_DONE


@pytest.mark.parametrize("pkg", PACKAGES)
class TestTokenizers:
    def test_byte_roundtrip(self, pkg):
        tok = _mods(pkg).tokenizer.ByteTokenizer(256)
        s = "héllo ⊕ wörld"
        assert tok.decode(tok.encode(s)) == s

    def test_byte_incremental_never_tears_codepoints(self, pkg):
        tok = _mods(pkg).tokenizer.ByteTokenizer(256)
        ids = tok.encode("a⊕b")  # ⊕ is 3 UTF-8 bytes
        inc = tok.incremental()
        pieces = [inc.push([i]) for i in ids]
        # no piece may contain a replacement char; concatenation is exact
        assert "�" not in "".join(pieces)
        assert "".join(pieces) + inc.flush() == "a⊕b"

    def test_byte_requires_vocab(self, pkg):
        with pytest.raises(ValueError, match="256"):
            _mods(pkg).tokenizer.ByteTokenizer(100)

    def test_numeric_roundtrip_and_reject(self, pkg):
        tok = _mods(pkg).tokenizer.NumericTokenizer(50)
        assert tok.encode(tok.decode([3, 14, 1])) == [3, 14, 1]
        with pytest.raises(ValueError, match="token ids"):
            tok.encode("plain text")

    def test_auto_selects_by_vocab(self, pkg):
        get = _mods(pkg).tokenizer.get_tokenizer
        assert get("auto", 256).name == "byte"
        assert get("auto", 64).name == "numeric"


@pytest.mark.parametrize("pkg", PACKAGES)
class TestTenantConfig:
    def test_parse_roundtrip(self, pkg):
        c = _mods(pkg).config
        arg = "gold:priority=0,weight=4,slo=0.25;bronze:priority=1,weight=1"
        specs = c.parse_tenants_arg(arg)
        assert [s.name for s in specs] == ["gold", "bronze"]
        assert specs[0].ttft_slo_s == 0.25 and specs[0].weight == 4.0
        assert c.parse_tenants_arg(c.format_tenants(specs)) == specs

    def test_parse_extra_keys(self, pkg):
        specs, extras = _mods(pkg).config.parse_tenants_arg(
            "a:rate=5,priority=0;b:concurrency=3",
            extra_keys={"rate": float, "concurrency": int})
        assert extras["a"] == {"rate": 5.0}
        assert extras["b"] == {"concurrency": 3}
        assert specs[0].priority == 0

    @pytest.mark.parametrize("bad", [
        "x:unknown=1", "x:weight=abc", "a:;a:", ":weight=1"])
    def test_parse_rejects(self, pkg, bad):
        with pytest.raises(ValueError):
            _mods(pkg).config.parse_tenants_arg(bad)

    def test_server_config_validates(self, pkg):
        with pytest.raises(ValueError, match="unknown_tenants"):
            _mods(pkg).config.ServerConfig(unknown_tenants="whatever")


@pytest.mark.parametrize("pkg", PACKAGES)
class TestStopSequences:
    """_Choice: stop strings match across chunk boundaries and are never
    half-emitted (the holdback buffer)."""

    def _choice(self, pkg, stops):
        m = _mods(pkg)
        return m.http._Choice(m.tokenizer.ByteTokenizer(256), stops), \
            m.tokenizer.ByteTokenizer(256)

    def test_stop_across_chunks_truncates(self, pkg):
        ch, tok = self._choice(pkg, ["END"])
        out = ch.push(tok.encode("abcE"))
        out += ch.push(tok.encode("ND tail"))
        out += ch.finish()
        assert out == "abc" and ch.stopped

    def test_holdback_never_emits_stop_prefix_early(self, pkg):
        ch, tok = self._choice(pkg, ["XY"])
        first = ch.push(tok.encode("aX"))
        assert "X" not in first, "possible stop prefix must be held back"
        rest = ch.push(tok.encode("Yb"))
        assert ch.stopped and first + rest + ch.finish() == "a"

    def test_no_stop_flushes_everything(self, pkg):
        ch, tok = self._choice(pkg, [])
        out = ch.push(tok.encode("hello")) + ch.finish()
        assert out == "hello" and not ch.stopped


@pytest.mark.parametrize("pkg", PACKAGES)
def test_traceparent_parse_and_format_agree(pkg):
    ref, got = _mods("jax").trace, _mods(pkg).trace
    for header in (f"00-{'ab' * 16}-{'cd' * 8}-01", "garbage",
                   "00-xyz-abc-01", f"00-{'0' * 32}-{'cd' * 8}-01",
                   f"ff-{'ab' * 16}-{'cd' * 8}-01", None,
                   f" 00-{'AB' * 16}-{'CD' * 8}-00 "):
        assert got.parse_traceparent(header) == ref.parse_traceparent(header)
    for span_id in (0, 7, 2 ** 70 + 3, "abc", "f" * 20):
        for sampled in (True, False):
            assert got.format_traceparent("ab" * 16, span_id, sampled) == \
                ref.format_traceparent("ab" * 16, span_id, sampled)
    tid = got.new_trace_id()
    assert len(tid) == 32 and int(tid, 16) >= 0


# ---------------------------------------------------------------------------
# the port's server end to end (tiny llama, CPU engine)
# ---------------------------------------------------------------------------


class TestHttpEndToEnd:
    def test_routes_and_unary_completion(self, weights):
        door, engine, cfg = _stack(weights)

        async def scenario(port):
            st, _, body = await _call(port, "/healthz")
            assert st == 200 and json.loads(body)["status"] == "ok"
            st, _, body = await _call(port, "/v1/models")
            assert st == 200
            assert json.loads(body)["data"][0]["object"] == "model"
            st, _, body = await _call(port, "/404/nope")
            assert st == 404 and b"error" in body
            st, _, _ = await _call(port, "/v1/completions", headers={})
            assert st == 405  # GET on a POST route
            st, _, body = await _call(
                port, "/v1/completions",
                {"prompt": [1, 2, 3], "max_tokens": 4, "temperature": 0})
            assert st == 200, body
            out = json.loads(body)
            choice = out["choices"][0]
            assert len(choice["token_ids"]) == 4
            assert out["usage"]["completion_tokens"] == 4
            assert choice["finish_reason"] == "length"
            st, _, body = await _call(
                port, "/v1/chat/completions",
                {"messages": [{"role": "user", "content": "hi"}],
                 "max_tokens": 2, "temperature": 0})
            assert st == 200, body
            assert json.loads(body)["choices"][0]["message"]["role"] \
                == "assistant"
            st, _, body = await _call(port, "/metrics")
            assert st == 200 and b"serving_ttft_seconds" in body

        _run(door, scenario)
        assert engine.compile_stats() == {"admit": 1, "prefill": 1,
                                          "decode": 1}

    def test_malformed_and_oversized_never_touch_scheduler(self, weights):
        door, engine, cfg = _stack(weights)

        async def scenario(port):
            raw = await _raw(port, b"POST /v1/completions HTTP/1.1\r\n"
                             b"Host: t\r\nContent-Length: 5\r\n\r\n{bad}")
            assert b" 400 " in raw and b"invalid JSON" in raw
            # oversized prompt: validated at the door, 400 with the
            # OpenAI envelope
            st, _, body = await _call(
                port, "/v1/completions",
                {"prompt": list(range(1, 60)), "max_tokens": 30})
            assert st == 400
            assert json.loads(body)["error"]["code"] \
                == "context_length_exceeded"
            # oversized BODY: refused before it is even read
            st, _, body = await _call(
                port, "/v1/completions",
                {"prompt": [1], "pad": "x" * (3 * 1024 * 1024)})
            assert st == 413
            # giant token id rejected against the vocab
            st, _, body = await _call(
                port, "/v1/completions", {"prompt": [10 ** 6]})
            assert st == 400 and b"out of range" in body

        _run(door, scenario)
        sch = engine.scheduler
        assert (sch.queue_depth, sch.live_slots) == (0, 0)
        assert sch.rejected_full == sch.rejected_too_long == 0
        assert engine.metrics.finished == 0  # nothing ever submitted

    def test_oversized_headers_answer_413(self, weights):
        door, engine, cfg = _stack(weights)

        async def scenario(port):
            big = "X-Pad: " + "a" * (100 * 1024)
            raw = await _raw(port, f"GET /healthz HTTP/1.1\r\nHost: t\r\n"
                             f"{big}\r\n\r\n".encode())
            assert b" 413 " in raw and b"headers too large" in raw

        _run(door, scenario)

    def test_seeded_streams_equal_the_engine_driven_directly(self, weights):
        """Sampled SSE streams equal the same engine's `stream()` with the
        key the server documents (uint32[2] [seed, candidate]); two seeds
        give two streams."""
        door, engine, cfg = _stack(weights)
        prompt = [5, 9, 2, 11, 4]

        async def scenario(port):
            results = {}
            for seed in (0, 7):
                st, _, body = await _call(
                    port, "/v1/completions",
                    {"prompt": prompt, "max_tokens": 6, "stream": True,
                     "temperature": 0.8, "seed": seed})
                assert st == 200
                assert body.rstrip().endswith(b"data: [DONE]")
                results[seed] = _sse_token_ids(body)
            return results

        via_http = _run(door, scenario)
        ref_engine, _ = _make_engine("torch", weights)
        for seed, got in via_http.items():
            req = ref_engine.submit(
                np.asarray(prompt, np.int32), max_new_tokens=6,
                temperature=0.8,
                key=np.array([seed & 0xFFFFFFFF, 0], np.uint32))
            want = list(ref_engine.stream(req))
            assert got == want, (seed, got, want)
        assert via_http[0] != via_http[7], "seeds must differ"

    def test_seeded_n2_fan_out_gives_two_distinct_streams(self, weights):
        """A seeded n=2 request: one submission plus one fork, each with
        its own [seed, i] key, so the two choices are distinct."""
        door, engine, cfg = _stack(weights, num_slots=3)

        async def scenario(port):
            st, _, body = await _call(
                port, "/v1/completions",
                {"prompt": [3, 1, 4], "max_tokens": 8, "n": 2,
                 "temperature": 0.9, "seed": 3})
            assert st == 200
            return json.loads(body)["choices"]

        choices = _run(door, scenario)
        assert [c["index"] for c in choices] == [0, 1]
        assert all(len(c["token_ids"]) == 8 for c in choices)
        assert choices[0]["token_ids"] != choices[1]["token_ids"], \
            "per-candidate keys must decorrelate the samples"
        assert engine.metrics.finished == 2

    def test_best_of_returns_n_ranked(self, weights):
        door, engine, cfg = _stack(weights, num_slots=3)

        async def scenario(port):
            st, _, body = await _call(
                port, "/v1/completions",
                {"prompt": [3, 1, 4], "max_tokens": 5, "n": 1, "best_of": 3,
                 "temperature": 0.9, "seed": 1})
            assert st == 200
            return json.loads(body)["choices"]

        choices = _run(door, scenario)
        assert len(choices) == 1

    def test_client_disconnect_mid_stream_frees_the_slot(self, weights):
        door, engine, cfg = _stack(weights)

        async def scenario(port):
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            body = json.dumps({"prompt": [1, 2, 3], "max_tokens": 40,
                               "stream": True, "temperature": 0}).encode()
            writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                         + f"Content-Length: {len(body)}\r\n\r\n".encode()
                         + body)
            await writer.drain()
            await reader.readuntil(b"\n\n")   # headers
            await reader.readuntil(b"\n\n")   # first SSE frame: running now
            assert engine.scheduler.live_slots == 1
            writer.close()                     # client walks away
            await writer.wait_closed()
            # the engine must notice at the next flush and retire the slot
            for _ in range(400):
                if engine.scheduler.live_slots == 0:
                    break
                await asyncio.sleep(0.01)
            assert engine.scheduler.live_slots == 0, "slot leaked"

        _run(door, scenario)
        assert engine.allocator.pool.free_count > 0
        assert engine.metrics.cancelled == 1

    def test_draining_rejects_new_work_with_503(self, weights):
        door, engine, cfg = _stack(weights)

        async def scenario(port):
            door.service.draining = True
            st, _, body = await _call(port, "/v1/completions",
                                      {"prompt": [1], "max_tokens": 2})
            assert st == 503
            assert json.loads(body)["error"]["code"] == "draining"
            st, _, _ = await _call(port, "/healthz")
            assert st == 503

        _run(door, scenario)

    def test_unknown_tenant_rejected_in_strict_mode(self, weights):
        from accelerate_tpu_torch.server.config import parse_tenants_arg

        door, engine, cfg = _stack(weights, server_cfg=_config(
            unknown_tenants="reject",
            tenants=parse_tenants_arg("gold:priority=0")))

        async def scenario(port):
            st, _, body = await _call(
                port, "/v1/completions", {"prompt": [1], "max_tokens": 2},
                headers={"X-Tenant": "nosuch"})
            assert st == 401
            assert json.loads(body)["error"]["code"] == "unknown_tenant"

        _run(door, scenario)

    def test_dead_drive_loop_fails_requests_instead_of_hanging(self,
                                                               weights):
        door, engine, cfg = _stack(weights)
        engine.step = lambda: (_ for _ in ()).throw(
            RuntimeError("engine exploded"))

        async def scenario(port):
            st, _, body = await _call(
                port, "/v1/completions",
                {"prompt": [1, 2, 3], "max_tokens": 4, "temperature": 0})
            assert st == 500, body
            assert json.loads(body)["error"]["code"] == "engine_failure"
            st, _, body = await _call(port, "/healthz")
            assert st == 503 and b"drive loop failed" in body

        async def bounded():
            await door.start()
            try:
                return await scenario(door.port)
            finally:
                await door.stop()

        # bounded: the whole scenario must finish quickly, not hang
        asyncio.run(asyncio.wait_for(bounded(), 30))

    def test_stream_stop_hit_counts_finished_not_cancelled(self, weights):
        """A stop string taken from the greedy stream itself (numeric
        tokenizer: each id renders as its decimal and a space) ends the
        stream with finish_reason "stop", and the request retires as
        finished."""
        probe, _ = _make_engine("torch", weights)
        req = probe.submit(np.asarray([1, 2, 3], np.int32),
                           max_new_tokens=8)
        toks = list(probe.stream(req))
        stop = f"{toks[2]} {toks[3]}"
        door, engine, cfg = _stack(weights,
                                   server_cfg=_config(tokenizer="numeric"))

        async def scenario(port):
            st, _, body = await _call(
                port, "/v1/completions",
                {"prompt": [1, 2, 3], "max_tokens": 8, "stream": True,
                 "temperature": 0, "stop": [stop]})
            assert st == 200
            frames = [f for f in body.split(b"\n\n") if
                      f.startswith(b"data: {")]
            last = json.loads(frames[-1][len(b"data: "):])
            assert last["choices"][0]["finish_reason"] == "stop"

        _run(door, scenario)
        assert engine.metrics.finished == 1
        assert engine.metrics.cancelled == 0
        assert engine.metrics.ttft_s.count == 1  # latency samples kept

    def test_queued_stream_times_out_with_504_not_a_held_socket(self,
                                                                weights):
        door, engine, cfg = _stack(
            weights, server_cfg=_config(request_timeout_s=0.3),
            num_slots=1, max_queue=4, max_len=4096)
        # occupy the only slot far beyond the timeout window
        blocker = engine.submit(np.asarray([1, 2, 3], np.int32),
                                max_new_tokens=4000)

        async def scenario(port):
            st, _, body = await _call(
                port, "/v1/completions",
                {"prompt": [4, 5, 6], "max_tokens": 4, "stream": True,
                 "temperature": 0})
            assert st == 504, body
            assert json.loads(body)["error"]["code"] == "timeout"
            engine.cancel(blocker)

        _run(door, scenario)

    def test_shed_429_carries_trace_id_and_shed_reason(self, weights):
        """Overload is an answer: a full queue gives 429 with Retry-After,
        the machine-readable shed reason and the request's trace id."""
        door, engine, cfg = _stack(weights, num_slots=1, max_queue=1,
                                   max_len=4096)
        blocker = engine.submit(np.asarray([1, 2, 3], np.int32),
                                max_new_tokens=4000)
        queued = engine.submit(np.asarray([4, 5], np.int32),
                               max_new_tokens=4)

        async def scenario(port):
            st, head, body = await _call(
                port, "/v1/completions",
                {"prompt": [6, 7], "max_tokens": 2})
            assert st == 429, body
            rid = _header(head, b"x-request-id")
            assert rid is not None
            assert _header(head, b"retry-after") is not None
            env = json.loads(body)["error"]
            assert env["request_id"] == rid.decode()
            assert env["shed_reason"] == "queue_full"
            engine.cancel(blocker)
            engine.cancel(queued)

        _run(door, scenario)

    def test_stop_closes_engine_off_the_event_loop(self):
        """`InferenceService.stop()` runs `engine.close()` (which joins
        the host tier's thread) in the default executor, so the serving
        loop keeps beating during teardown."""
        from accelerate_tpu_torch.server.service import InferenceService
        from accelerate_tpu_torch.server.tokenizer import get_tokenizer

        class _Sched:
            queue = ()

            def has_work(self):
                return False

            def running(self):
                return ()

        class _Engine:
            watchdog = None
            scheduler = _Sched()
            closed_on = None

            def cancel(self, req):
                pass

            def close(self):
                self.closed_on = threading.current_thread()
                time.sleep(0.15)

        engine = _Engine()
        service = InferenceService(engine, get_tokenizer("auto", 256),
                                   _config(drain_timeout_s=0.1))

        async def scenario():
            await service.start()
            beats = []

            async def heartbeat():
                while True:
                    beats.append(time.monotonic())
                    await asyncio.sleep(0.01)

            hb = asyncio.get_running_loop().create_task(heartbeat())
            before = len(beats)
            await service.stop()
            hb.cancel()
            return threading.current_thread(), len(beats) - before

        loop_thread, beats = asyncio.run(scenario())
        assert engine.closed_on is not None
        assert engine.closed_on is not loop_thread
        assert beats >= 5, "event loop starved during engine teardown"


class TestRequestTracingHttp:
    def test_x_request_id_on_success_and_errors(self, weights,
                                               port_tracing):
        """Every generate response — 200, 4xx — carries x-request-id, and
        error envelopes repeat it in-band."""
        door, engine, cfg = _stack(weights)

        async def scenario(port):
            st, head, _ = await _call(
                port, "/v1/completions",
                {"prompt": [1, 2, 3], "max_tokens": 2, "temperature": 0})
            assert st == 200
            rid = _header(head, b"x-request-id")
            assert rid is not None and len(rid) == 32
            int(rid, 16)  # 32 lowercase hex chars
            st, head, body = await _call(
                port, "/v1/completions",
                {"prompt": [1], "max_tokens": 100000})
            assert st == 400
            rid = _header(head, b"x-request-id")
            assert rid is not None
            env = json.loads(body)["error"]
            assert env["request_id"] == rid.decode()

        _run(door, scenario)

    def test_inbound_traceparent_is_honored(self, weights, port_tracing):
        """The trace id of a valid `traceparent` comes back as
        x-request-id, and with tracing on the request's spans land in the
        flight recorder under it, parented on the caller's span."""
        port_tracing.configure_tracing(enabled=True, annotate=False)
        door, engine, cfg = _stack(weights)
        tid = "ab" * 16

        async def scenario(port):
            st, head, _ = await _call(
                port, "/v1/completions",
                {"prompt": [1, 2], "max_tokens": 2, "temperature": 0},
                headers={"traceparent": f"00-{tid}-{'cd' * 8}-01"})
            assert st == 200
            assert _header(head, b"x-request-id") == tid.encode()

        _run(door, scenario)
        events = port_tracing.trace_events(tid)
        root = next(e for e in events if e["name"] == "serving.request")
        assert root["parent_id"] == "cd" * 8
        assert {"serving.queue_wait", "serving.admit", "serving.prefill",
                "serving.decode_lifetime"} <= {e["name"] for e in events}

    def test_malformed_traceparent_mints_fresh_id(self, weights,
                                                  port_tracing):
        door, engine, cfg = _stack(weights)

        async def scenario(port):
            for bad in ("garbage", "00-xyz-abc-01",
                        "00-" + "0" * 32 + "-" + "cd" * 8 + "-01"):
                st, head, _ = await _call(
                    port, "/v1/completions",
                    {"prompt": [1, 2], "max_tokens": 2, "temperature": 0},
                    headers={"traceparent": bad})
                assert st == 200
                rid = _header(head, b"x-request-id")
                assert rid is not None and len(rid) == 32
                assert rid.decode() not in bad
                int(rid, 16)

        _run(door, scenario)

    def test_http_request_yields_linked_trace(self, weights, port_tracing):
        port_tracing.configure_tracing(enabled=True, annotate=False)
        door, engine, cfg = _stack(weights)

        async def scenario(port):
            st, head, _ = await _call(
                port, "/v1/completions",
                {"prompt": list(range(1, 12)), "max_tokens": 3,
                 "temperature": 0})
            assert st == 200
            return _header(head, b"x-request-id").decode()

        rid = _run(door, scenario)
        names = [e["name"] for e in port_tracing.trace_events(rid)]
        assert "serving.queue_wait" in names
        assert "serving.admit" in names
        assert names.count("serving.prefill") == 2  # 11 tokens / chunk 8
        assert "serving.decode_lifetime" in names
        assert "serving.request" in names
        doc = port_tracing.export_chrome_trace(trace_id=rid)
        assert all(e["args"]["trace_id"] == rid
                   for e in doc["traceEvents"])
        assert engine.compile_stats() == {"admit": 1, "prefill": 1,
                                          "decode": 1}

    def test_sampling_zero_still_returns_x_request_id(self, weights,
                                                      port_tracing):
        port_tracing.configure_tracing(enabled=True, annotate=False,
                                       default_sample_rate=0.0)
        door, engine, cfg = _stack(weights)

        async def scenario(port):
            st, head, _ = await _call(
                port, "/v1/completions",
                {"prompt": [1, 2], "max_tokens": 2, "temperature": 0})
            assert st == 200
            return _header(head, b"x-request-id").decode()

        rid = _run(door, scenario)
        assert len(rid) == 32
        assert port_tracing.trace_events(rid) == []

    def test_metrics_route_negotiates_openmetrics_exemplars(self, weights,
                                                            port_tracing):
        port_tracing.configure_tracing(enabled=True, annotate=False)
        door, engine, cfg = _stack(weights)

        async def scenario(port):
            st, head, _ = await _call(
                port, "/v1/completions",
                {"prompt": [1, 2, 3], "max_tokens": 2, "temperature": 0})
            assert st == 200
            st, head, body = await _call(port, "/metrics")
            assert st == 200
            assert _header(head, b"content-type").startswith(
                b"text/plain; version=0.0.4")
            assert b"trace_id" not in body
            st, head, body = await _call(
                port, "/metrics",
                headers={"Accept": "application/openmetrics-text"})
            assert st == 200
            assert _header(head, b"content-type").startswith(
                b"application/openmetrics-text")
            assert b'serving_ttft_seconds_bucket' in body
            assert b"trace_id=" in body
            assert body.rstrip().endswith(b"# EOF")
            raw = await _raw(port, b"HEAD /metrics HTTP/1.1\r\nHost: t\r\n"
                             b"Content-Length: 0\r\n\r\n")
            head, _, body = raw.partition(b"\r\n\r\n")
            assert b" 200 " in head and body == b""
            assert int(_header(head, b"content-length")) > 0

        _run(door, scenario)

    def test_exposition_equals_the_reference_rendering(self):
        """The port's `render_prometheus` renders a registry exactly as
        the reference's does, in both flavours."""
        from accelerate_tpu.telemetry.export import render_prometheus as ref
        from accelerate_tpu.telemetry.registry import MetricsRegistry as RR
        from accelerate_tpu_torch.telemetry.export import render_prometheus
        from accelerate_tpu_torch.telemetry.registry import MetricsRegistry

        out = []
        for registry in (RR(), MetricsRegistry()):
            registry.counter("reqs_total", tenant="a").inc(3)
            registry.gauge("depth").set(2.5)
            h = registry.histogram("lat_seconds")
            for i, v in enumerate((0.01, 0.2, 0.03, 1.5)):
                h.record(v, exemplar=f"t{i}")
            registry.histogram("plain_seconds").record(0.5)
            out.append(registry)
        for om in (False, True):
            got = render_prometheus(out[1], openmetrics=om)
            want = ref(out[0], openmetrics=om)
            strip = (lambda s: [ln.rsplit(" ", 1)[0] if "# {" in ln else ln
                                for ln in s.splitlines()])
            assert strip(got) == strip(want)  # exemplar timestamps differ


class TestDebugEndpoints:
    def test_gated_off_by_default(self, weights):
        door, engine, cfg = _stack(weights)

        async def scenario(port):
            for section in ("requests", "slots", "pages", "scheduler",
                            "profile"):
                st, _, _ = await _call(port, f"/debug/{section}")
                assert st == 404
            st, _, _ = await _call(port, "/debug/requests", body={})
            assert st == 404

        _run(door, scenario)

    def test_fan_out_samples_once_per_http_request(self, weights,
                                                   port_tracing,
                                                   monkeypatch):
        """n/best_of siblings share one trace, so the head-sampling
        decision is made once in the service."""
        from accelerate_tpu_torch.server.protocol import \
            parse_completion_request
        from accelerate_tpu_torch.server.service import InferenceService
        from accelerate_tpu_torch.server.tokenizer import get_tokenizer

        engine, cfg = _make_engine("torch", weights, num_slots=4)
        service = InferenceService(
            engine, get_tokenizer("auto", cfg.vocab_size), _config())
        port_tracing.configure_tracing(enabled=True, annotate=False)
        draws = []
        flip = [True, False, True, False]

        def fake_sample(tenant="default"):
            draws.append(tenant)
            return flip[len(draws) - 1]

        monkeypatch.setattr(port_tracing, "head_sample", fake_sample)
        params = parse_completion_request(
            {"prompt": [1, 2], "max_tokens": 2, "n": 3,
             "temperature": 0.5, "seed": 7}, 64)
        reqs = service.submit(params, "default", trace_id="ab" * 16)
        assert len(draws) == 1, "one decision per HTTP request"
        assert [r.trace_sampled for r in reqs] == [True] * 3
        assert all(r.trace_id == "ab" * 16 for r in reqs)
        for r in reqs:
            engine.cancel(r)

    def test_debug_views_over_http(self, weights):
        door, engine, cfg = _stack(
            weights, server_cfg=_config(debug_endpoints=True), num_slots=1,
            max_len=4096)
        running = engine.submit(np.asarray([1, 2, 3], np.int32),
                                max_new_tokens=4000)
        queued = engine.submit(np.asarray([4, 5], np.int32),
                               max_new_tokens=4)

        async def scenario(port):
            st, _, body = await _call(port, "/debug/requests")
            assert st == 200
            dbg = json.loads(body)
            assert [r["request_id"] for r in dbg["running"]] == [
                running.request_id]
            assert [r["request_id"] for r in dbg["queued"]] == [
                queued.request_id]
            assert dbg["service"]["healthy"] is True
            st, _, body = await _call(port, "/debug/slots")
            assert st == 200
            slots = json.loads(body)["slots"]
            assert slots[0]["request_id"] == running.request_id
            st, _, body = await _call(port, "/debug/pages")
            assert st == 200
            assert json.loads(body)["pages_in_use"] > 0
            st, _, body = await _call(port, "/debug/scheduler")
            assert st == 200
            sched = json.loads(body)
            assert sched["queue_depth"] == 1
            assert "default" in sched["tenants"]
            st, _, _ = await _call(port, "/debug/nonsense")
            assert st == 404
            st, _, _ = await _call(port, "/debug/pod")
            assert st == 404  # a single engine has no pod state
            engine.cancel(running)
            engine.cancel(queued)

        _run(door, scenario)

    def test_profile_capture_writes_a_trace_and_refuses_a_second(
            self, weights, tmp_path):
        """`/debug/profile` records a torch.profiler trace of the live
        engine into the log directory; a capture started while one runs
        answers 409; HEAD and bad durations are refused."""
        door, engine, cfg = _stack(
            weights, server_cfg=_config(debug_endpoints=True))
        logdir = str(tmp_path / "prof")

        async def scenario(port):
            first = asyncio.get_running_loop().create_task(_call(
                port, f"/debug/profile?duration_s=1.0&logdir={logdir}"))
            for _ in range(1000):  # until the first capture holds the slot
                if door._profiling:
                    break
                await asyncio.sleep(0.01)
            assert door._profiling
            st, _, body = await _call(port, "/debug/profile?duration_s=0.1")
            assert st == 409, body
            st, _, _ = await _call(
                port, "/v1/completions",
                {"prompt": [1, 2, 3], "max_tokens": 3, "temperature": 0})
            assert st == 200  # the engine keeps serving during a capture
            st, _, body = await first
            assert st == 200, body
            assert json.loads(body)["profile"]["logdir"] == logdir
            st, _, _ = await _call(port, "/debug/profile?duration_s=99")
            assert st == 400
            raw = await _raw(port, b"HEAD /debug/profile HTTP/1.1\r\n"
                             b"Host: t\r\nContent-Length: 0\r\n\r\n")
            assert b" 405 " in raw

        _run(door, scenario)
        with open(os.path.join(logdir, "trace.json")) as f:
            doc = json.load(f)
        assert doc["traceEvents"], "the capture recorded nothing"


def _serve_cli_once(flags, family, request):
    """Run `python -m accelerate_tpu_torch.commands.serve --device cpu
    --port 0 *flags`, send `request` to /v1/completions, then SIGTERM:
    (status, body, the process's exit code, its later stderr lines)."""
    import queue
    import re
    import signal
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.serve",
         "--device", "cpu", "--port", "0", *flags],
        cwd=root, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stderr], daemon=True)
    reader.start()
    try:
        port = None
        while port is None:  # the first line that names the bound port
            m = re.match(rf"serving {family} on 127\.0\.0\.1:(\d+)",
                         lines.get(timeout=120))
            port = int(m.group(1)) if m else None
        st, _, body = asyncio.run(_call(port, "/v1/completions", request))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        reader.join(timeout=30)
        rest = []
        while not lines.empty():
            rest.append(lines.get())
        return st, json.loads(body), rc, rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_port_server_drains_on_sigterm_and_exits_zero(tmp_path):
    """`python -m accelerate_tpu_torch.commands.serve --device cpu` serves
    one request, then SIGTERM drains it and the process exits 0."""
    st, body, rc, rest = _serve_cli_once(
        ["--slots", "2", "--max-len", "64", "--prefill-chunk", "8"],
        "llama", {"prompt": [1, 2, 3], "max_tokens": 3, "temperature": 0})
    assert st == 200 and len(body["choices"][0]["token_ids"]) == 3
    assert rc == 0
    assert any("drained and stopped" in ln for ln in rest), rest


def test_port_serves_family_gpt2_on_the_cpu():
    """`--family gpt2` serves `GPT2Config.tiny()` with the weights of
    `--seed`: the greedy tokens over HTTP equal the port's engine driven
    directly on the same weights and pool, and SIGTERM drains to 0."""
    from accelerate_tpu_torch.models import gpt2
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    prompt = [5, 17, 3, 250, 9]
    st, body, rc, rest = _serve_cli_once(
        ["--family", "gpt2", "--seed", "3", "--slots", "2", "--max-len",
         "64", "--prefill-chunk", "8"], "gpt2",
        {"prompt": prompt, "max_tokens": 6, "temperature": 0})
    assert st == 200 and rc == 0
    assert any("drained and stopped" in ln for ln in rest), rest
    cfg = gpt2.GPT2Config.tiny()
    engine = Engine(gpt2, cfg, gpt2.init_params(cfg, 3, device="cpu"),
                    EngineConfig(cache_dtype=torch.bfloat16, num_slots=2,
                                 max_len=64, prefill_chunk=8),
                    device="cpu")
    req = engine.submit(np.asarray(prompt, np.int32), max_new_tokens=6)
    engine.run_until_idle()
    assert body["choices"][0]["token_ids"] == req.tokens


def test_unported_engine_surface_stays_refused(weights):
    """The service reads `engine.watchdog`: None unless armed, a running
    watchdog when armed. `incident_dumps()` carries the reference's
    sections, the cost table included. `strict` is still refused,
    naming what brings it."""
    engine, _ = _make_engine("torch", weights)
    assert engine.watchdog is None
    ref, _ = _make_engine("jax", weights)
    assert set(engine.incident_dumps()) == set(ref.incident_dumps()) == {
        "requests", "slots", "pages", "scheduler", "compile_stats",
        "cost_table"}
    ref.close()
    armed, _ = _make_engine("torch", weights, watchdog_timeout_s=1.0)
    try:
        assert armed.watchdog is not None and not armed.watchdog.stalled
    finally:
        armed.close()
    with pytest.raises(NotImplementedError, match="static-analysis"):
        _make_engine("torch", weights, strict="warn")
