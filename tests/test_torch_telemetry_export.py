"""The port's metrics exporter against the JAX package's exposition.

An ephemeral exporter on 127.0.0.1 serves `render_prometheus` of its
registry, in the 0.0.4 text format by default and in OpenMetrics when
the Accept header asks; the body equals the JAX package's
`render_prometheus` of a registry holding the same series (the
rendering is host text: equal exactly). HEAD answers with headers only,
an unknown path 404s, an explicit port that is taken raises, and no
port means no exporter. The engine's and the Accelerator's exporters
serve their own registries and stop on close.
"""

from __future__ import annotations

import socket
import urllib.error
import urllib.request

import pytest
import torch

from accelerate_tpu.telemetry import export as jexport
from accelerate_tpu.telemetry.registry import MetricsRegistry as JRegistry
from accelerate_tpu_torch.telemetry import export as texport
from accelerate_tpu_torch.telemetry.registry import \
    MetricsRegistry as TRegistry

OM = "application/openmetrics-text"


def _fill(reg):
    reg.counter("up_total").inc()
    reg.counter("serving_requests_total", tenant="gold").inc(3)
    reg.gauge("program_mfu", program="decode").set(0.25)
    h = reg.histogram("serving_ttft_seconds")
    for v in (0.05, 0.07, 0.3):
        h.record(v, exemplar="ee" * 16)
    d = reg.histogram("program_device_time_seconds", program="decode")
    for v in (0.010, 0.011):
        d.record(v)
    return reg


def _get(port, accept=None, method="GET", path="/metrics"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers={"Accept": accept} if accept
                                 else {}, method=method)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, resp.headers, resp.read().decode()


@pytest.fixture
def server():
    reg = _fill(TRegistry())
    srv = texport.start_metrics_server(0, registry=reg)
    try:
        yield srv, reg
    finally:
        srv.stop()


@pytest.mark.parametrize("accept,openmetrics,ctype", [
    (None, False, "text/plain; version=0.0.4"),
    (OM, True, OM)], ids=["prometheus", "openmetrics"])
def test_scrape_equals_the_reference_rendering(server, accept, openmetrics,
                                               ctype):
    srv, reg = server
    assert srv.port > 0 and srv._httpd.server_address[0] == "127.0.0.1"
    status, headers, body = _get(srv.port, accept)
    assert status == 200 and headers["Content-Type"].startswith(ctype)
    assert body == texport.render_prometheus(reg, openmetrics=openmetrics)
    # the exemplar timestamps are the time of each record: the reference
    # registry gets the same series, then the same stamps
    ref = _fill(JRegistry())
    ref_h = ref.histogram("serving_ttft_seconds")
    got_h = reg.histogram("serving_ttft_seconds")
    ref_h._exemplars = dict(got_h._exemplars)
    assert body == jexport.render_prometheus(ref, openmetrics=openmetrics)
    assert 'program_device_time_seconds{program="decode"' in body


def test_head_and_unknown_path(server):
    srv, _ = server
    _, _, body = _get(srv.port)
    status, headers, head_body = _get(srv.port, method="HEAD")
    assert status == 200 and head_body == ""
    assert int(headers["Content-Length"]) == len(body.encode())
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(srv.port, path="/nope")
    assert err.value.code == 404


def test_taken_port_raises_and_no_port_means_no_exporter(server):
    srv, _ = server
    with pytest.raises(OSError):
        texport.start_metrics_server(srv.port, registry=TRegistry())
    assert texport.start_metrics_server(None) is None
    assert texport.resolve_metrics_port(None) is None
    assert texport.resolve_metrics_port(0) == 0


def test_the_port_reads_no_metrics_port_variable(monkeypatch):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    monkeypatch.setenv("ACCELERATE_TPU_METRICS_PORT", str(free))
    assert jexport.resolve_metrics_port(None) == free
    assert texport.resolve_metrics_port(None) is None
    assert texport.start_metrics_server(None) is None


def test_stop_closes_the_socket():
    srv = texport.MetricsServer(registry=TRegistry(), port=0).start()
    port = srv.port
    srv.stop()
    with pytest.raises(urllib.error.URLError):
        _get(port)


def test_engine_and_accelerator_exporters_serve_their_registries():
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.serving import Engine, EngineConfig
    from accelerate_tpu_torch.state import PartialState

    cfg = llama.LlamaConfig.tiny()
    eng = Engine(llama, cfg, llama.init_params(cfg, 0, device="cpu"),
                 EngineConfig(cache_dtype=torch.float32, num_slots=2,
                              max_len=64, prefill_chunk=8, metrics_port=0,
                              cost_sample_every=1), device="cpu")
    try:
        eng.submit(list(range(1, 10)), max_new_tokens=4)
        eng.run_until_idle()
        for accept in (None, OM):
            _, _, body = _get(eng.metrics_server.port, accept)
            assert 'program_device_time_seconds{program="decode"' in body
            assert "serving_goodput" in body
    finally:
        eng.close()
    assert eng.metrics_server is None
    PartialState._reset_state()
    acc = Accelerator(cpu=True, metrics_port=0)
    try:
        acc.telemetry.counter("accelerator_log_calls_total").inc()
        _, _, body = _get(acc.metrics_server.port)
        assert "accelerator_log_calls_total" in body
    finally:
        acc.end_training()
        PartialState._reset_state()
    assert acc.metrics_server is None
