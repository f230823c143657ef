"""The port's device-cost table against the JAX package's.

- `CostTable` semantics: the reference's `tests/test_cost.py` cases run
  against both packages' tables with injected peaks and an injected
  clock. Registration, cadence, rooflines, gauges, summaries and
  snapshots are host arithmetic: equal exactly.
- The engines' analytic costs (`Engine._analytic_cost`) of the JAX and
  the port's engines on `LlamaConfig.tiny()` for every program, and
  `causal_lm_infer_flops`: equal exactly.
- The tiny port engine's summary keys and live goodput gauge, sampling
  without a recapture, the train step's analytic registration and its
  sampling, all on the CPU.
- The peaks: each H100 part by its own name; a name the table lacks gets
  the reference's nominal placeholders.
- On the card only (`cuda` marker, skipped here): the fence waits on a
  CUDA tree, and a graphed engine samples every call with its captures
  flat.
"""

from __future__ import annotations

import json
import math

import jax
import numpy as np
import pytest
import torch

from accelerate_tpu.telemetry import cost as jcost
from accelerate_tpu.telemetry.registry import MetricsRegistry as JRegistry
from accelerate_tpu_torch.telemetry import cost as tcost
from accelerate_tpu_torch.telemetry.registry import \
    MetricsRegistry as TRegistry

# injected peaks: 1 TFLOP/s + 100 GB/s, non-nominal so the math is exact
PEAKS = (1e12, 100e9, False)
PKGS = {"jax": (jcost, JRegistry), "torch": (tcost, TRegistry)}


class FakeClock:
    def __init__(self, step=0.01):
        self.now, self.step = 0.0, step

    def __call__(self):
        self.now += self.step
        return self.now


def make_table(pkg, sample_every=1, registry=None, clock=None, **kw):
    mod, reg = PKGS[pkg]
    return mod.CostTable(registry=registry or reg(),
                         sample_every=sample_every, peaks=PEAKS,
                         clock=clock or FakeClock(), **kw)


def both(fn):
    """fn(pkg) on each package; the two results, asserted equal."""
    got = {pkg: fn(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    return got["torch"]


# ---------------------------------------------------------------------------
# CostTable: the reference's cases on both packages
# ---------------------------------------------------------------------------


def test_register_explicit_and_gauges():
    def run(pkg):
        t = make_table(pkg)
        e = t.register("decode", flops=2e9, bytes_accessed=1e9)
        return (e.source, e.flops, e.bytes_accessed, e.arith_intensity,
                t.registry.snapshot()["gauges"])

    out = both(run)
    assert out[0] == "explicit" and out[3] == 2.0
    assert out[4]['program_flops{program="decode"}'] == 2e9


@pytest.mark.parametrize("source,fallback,want", [
    ({"flops": 5.0, "bytes accessed": 10.0}, None,
     ("cost_analysis", 5.0, 10.0)),
    ({"no": "flops"}, lambda: (7.0, 3.0), ("analytic", 7.0, 3.0)),
    (None, None, None),
], ids=["cost_analysis_dict", "fallback", "nothing"])
def test_register_resolution_order(source, fallback, want):
    def run(pkg):
        t = make_table(pkg)
        e = t.register("p", source, fallback=fallback)
        return None if e is None else (e.source, e.flops, e.bytes_accessed)

    assert both(run) == want


def test_register_once_unless_replace():
    def run(pkg):
        t = make_table(pkg)
        t.register("p", flops=1.0, bytes_accessed=1.0)
        t.register("p", flops=99.0, bytes_accessed=1.0)
        once = t.entries["p"].flops
        t.register("p", flops=99.0, bytes_accessed=1.0, replace=True)
        return once, t.entries["p"].flops

    assert both(run) == (1.0, 99.0)


class _Boom:
    def cost_analysis(self):
        raise RuntimeError("backend says no")


@pytest.mark.parametrize("value", [
    {"flops": 2.0}, [{"flops": 2.0, "bytes accessed": 4.0}], [],
    {"flops": 0.0}, "garbage", _Boom()],
    ids=["dict", "list", "empty", "zero", "garbage", "raises"])
def test_extract_cost_analysis_shapes(value):
    both(lambda pkg: PKGS[pkg][0].extract_cost_analysis(value))


@pytest.mark.parametrize("every", [0, 1, 4, 16])
def test_sampling_cadence_skips_the_first_call(every):
    def run(pkg):
        t = make_table(pkg, every)
        return [t.sample_due("p") for _ in range(40)]

    due = both(run)
    assert due[0] is False
    assert any(due) == (every > 0)


def test_roofline_math_and_gauges():
    def run(pkg):
        t = make_table(pkg)
        t.register("p", flops=1e9, bytes_accessed=5e9)
        t.record_device_time("p", 0.01)
        return t.roofline("p"), t.registry.snapshot()["gauges"]

    sheet, gauges = both(run)
    assert sheet["mfu"] == pytest.approx(0.1)
    assert sheet["mxu_idle_fraction"] == pytest.approx(0.9)
    assert sheet["hbm_bw_util"] == pytest.approx(5.0)
    assert sheet["peaks_nominal"] == 0.0
    assert gauges['program_mfu{program="p"}'] == pytest.approx(0.1)


def test_maybe_sample_times_the_window_on_the_injected_clock():
    """Call 1 is never sampled; a due call reads the clock after the
    entry fence and after the exit fence (a CPU tensor: no wait)."""
    def run(pkg):
        t = make_table(pkg, sample_every=1, clock=FakeClock(0.004))
        t.register("p", flops=1.0, bytes_accessed=1.0)
        out = torch.ones(3) if pkg == "torch" else None
        for _ in range(3):
            with t.maybe_sample("p", fence_in=out) as sample:
                sample(out)
                sample(out)  # a second call records nothing
        return t.device_time("p").count, t.roofline("p")

    count, sheet = both(run)
    assert count == 2 and sheet["device_time_mean_s"] == pytest.approx(0.004)


def test_republish_after_registry_reset():
    def run(pkg):
        t = make_table(pkg)
        t.register("p", flops=3.0, bytes_accessed=1.0)
        t.registry.reset()
        zeroed = t.registry.snapshot()["gauges"]['program_flops{program="p"}']
        t.republish()
        return zeroed, t.registry.snapshot()["gauges"][
            'program_flops{program="p"}']

    assert both(run) == (0.0, 3.0)


def test_snapshot_and_summary_json_equal():
    def run(pkg):
        t = make_table(pkg, num_chips=2)
        t.register("p", flops=1e6, bytes_accessed=2e6)
        t.register("q", flops=5e6, bytes_accessed=1e6)
        t.sample_due("p"), t.sample_due("p")
        t.record_device_time("p", 0.001)
        t.record_device_time("q", 0.003)
        return json.dumps(t.snapshot(), sort_keys=True), t.summary()

    snap, summary = both(run)
    snap = json.loads(snap)
    assert snap["programs"]["p"]["calls"] == 2
    assert snap["peaks"]["num_chips"] == 2
    assert "mfu" in summary["q"]


def test_num_chips_scales_the_peak_denominator():
    def run(pkg):
        t = make_table(pkg, num_chips=4)
        t.register("p", flops=1e9, bytes_accessed=5e9)
        t.record_device_time("p", 0.01)
        lazy = make_table(pkg, num_chips=lambda: 2)
        return t.roofline("p"), lazy.num_chips

    sheet, chips = both(run)
    assert sheet["mfu"] == pytest.approx(0.025) and chips == 2


def test_program_cost_nan_intensity():
    assert math.isnan(tcost.ProgramCost("p", 1.0, 0.0).arith_intensity)
    assert math.isnan(jcost.ProgramCost("p", 1.0, 0.0).arith_intensity)


def test_resolve_sample_every_reads_no_environment(monkeypatch):
    monkeypatch.delenv("ACCELERATE_TPU_COST_SAMPLE_EVERY", raising=False)
    assert tcost.resolve_sample_every(None) == \
        jcost.resolve_sample_every(None) == 16
    assert tcost.resolve_sample_every(3) == 3
    assert tcost.resolve_sample_every(0) == 0
    monkeypatch.setenv("ACCELERATE_TPU_COST_SAMPLE_EVERY", "7")
    assert jcost.resolve_sample_every(None) == 7
    assert tcost.resolve_sample_every(None) == 16


def test_cadence_loses_no_call_across_threads():
    """Many threads counting one program's calls (a server's engine and
    a scraper, say): no count is lost, and exactly the due calls are
    due."""
    import sys
    import threading

    t = tcost.CostTable(registry=TRegistry(), sample_every=4, peaks=PEAKS)
    due = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def count():
            due.append(sum(t.sample_due("p") for _ in range(2000)))

        threads = [threading.Thread(target=count) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    n = 16 * 2000
    assert t.calls("p") == n
    assert sum(due) == len(range(2, n + 1, 4))


# ---------------------------------------------------------------------------
# peaks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12, False)),
    ("NVIDIA H100 PCIe", (756e12, 2.0e12, False)),
    ("NVIDIA H100 NVL", (1e12, 100e9, True)),
    ("NVIDIA A100-SXM4-80GB", (1e12, 100e9, True)),
], ids=["h100_sxm", "h100_pcie", "h100_nvl", "a100"])
def test_each_gpu_part_gets_its_own_peaks(monkeypatch, name, want):
    """The H100 PCIe part is not read with the SXM part's peaks (the old
    table matched any "h100"); a part the table lacks gets the
    reference's nominal placeholders, marked nominal."""
    from accelerate_tpu_torch import profiler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: name)
    assert tcost.device_peaks() == want
    assert profiler.peak_flops_per_chip() == (0.0 if want[2] else want[0])
    assert (tcost.NOMINAL_PEAK_FLOPS, tcost.NOMINAL_PEAK_HBM_BYTES) == (
        jcost.NOMINAL_PEAK_FLOPS, jcost.NOMINAL_PEAK_HBM_BYTES)


def test_a_cpu_device_gets_nominal_peaks():
    assert tcost.device_peaks("cpu") == (1e12, 100e9, True)


# ---------------------------------------------------------------------------
# the engines' analytic costs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_params=100, tokens=3, attention=False),
    dict(n_params=100, tokens=3, num_layers=2, hidden_size=8, kv_len=10),
    dict(n_params=8_030_000_000, tokens=8, num_layers=32, hidden_size=4096,
         kv_len=1024),
], ids=["weights_only", "with_attention", "llama3_8b_decode"])
def test_causal_lm_infer_flops_matches_jax(kw):
    from accelerate_tpu import profiler as jp
    from accelerate_tpu_torch import profiler as tp

    assert tp.causal_lm_infer_flops(**kw) == jp.causal_lm_infer_flops(**kw)


@pytest.fixture(scope="module")
def tiny():
    from accelerate_tpu.models import llama as jl
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.models.convert import params_from_numpy

    cfg = jl.LlamaConfig.tiny()
    pj = jl.init_params(cfg, jax.random.key(0))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return jl, tl, cfg, tl.LlamaConfig.tiny(), pj, pt


BASE = dict(num_slots=2, max_len=64, prefill_chunk=8, page_size=8)


def test_analytic_costs_equal_the_jax_engines(tiny):
    """Every program of a classic and a speculative engine (the draft is
    the target's own weights): the same (flops, bytes) from both."""
    from accelerate_tpu.serving import Engine as JEngine
    from accelerate_tpu.serving import EngineConfig as JConfig
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    jl, tl, cj, ct, pj, pt = tiny
    for spec in (False, True):
        jkw = dict(BASE, speculative=(jl, cj, pj), draft_k=3) if spec \
            else BASE
        tkw = dict(BASE, speculative=(tl, ct, pt), draft_k=3) if spec \
            else BASE
        je = JEngine(jl, cj, pj, JConfig(**jkw))
        te = Engine(tl, ct, pt, EngineConfig(cache_dtype=torch.float32,
                                             **tkw), device="cpu")
        names = (["admit", "prefill", "draft_prefill", "draft", "verify"]
                 if spec else ["admit", "prefill", "decode"])
        for name in names:
            assert te._analytic_cost(name) == je._analytic_cost(name), name
        je.close()
        te.close()


@pytest.fixture(scope="module")
def tiny_run(tiny):
    """One tiny port engine through a short request wave at sampling 2."""
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    _, tl, _, ct, _, pt = tiny
    eng = Engine(tl, ct, pt, EngineConfig(cache_dtype=torch.float32,
                                          cost_sample_every=2, **BASE),
                 device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(4):
        eng.submit(rng.integers(0, ct.vocab_size, (8,)).astype(np.int32),
                   max_new_tokens=6)
    eng.run_until_idle()
    yield eng
    eng.close()


def test_summary_reports_rooflines_and_goodput(tiny_run):
    s = tiny_run.metrics_summary()
    for key in ("decode_mfu", "decode_mxu_idle_fraction",
                "decode_hbm_bw_util", "decode_arith_intensity",
                "decode_device_time_mean_ms", "decode_device_time_p99_ms",
                "prefill_device_time_mean_ms", "goodput",
                "host_dispatch_us_mean"):
        assert key in s and s[key] == s[key], key
    assert 0.0 < s["goodput"] <= 1.0
    assert tiny_run.cost.roofline("decode")["peaks_nominal"] == 1.0


def test_sampling_builds_each_program_once(tiny_run):
    assert tiny_run.compile_stats() == {"admit": 1, "prefill": 1,
                                        "decode": 1}
    assert tiny_run.cost.device_time("decode").count > 0
    assert tiny_run.cost.device_time("prefill").count > 0
    entries = tiny_run.cost.entries
    assert {e.source for e in entries.values()} == {"analytic"}
    assert entries["prefill"].flops > entries["decode"].flops > 0


def test_goodput_gauge_live_and_cost_table_in_dumps(tiny_run):
    snap = tiny_run.registry.snapshot()
    assert 0.0 < snap["gauges"]["serving_goodput"] <= 1.0
    table = tiny_run.incident_dumps()["cost_table"]
    json.dumps(table)
    assert set(table["programs"]) >= {"admit", "prefill", "decode"}
    assert "device_time_mean_s" in table["rooflines"]["decode"]


def test_reset_metrics_keeps_static_costs(tiny):
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    _, tl, _, ct, _, pt = tiny
    eng = Engine(tl, ct, pt, EngineConfig(cache_dtype=torch.float32,
                                          cost_sample_every=2, **BASE),
                 device="cpu")
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=4)
    eng.run_until_idle()
    assert eng.cost.device_time("decode").count > 0
    eng.reset_metrics()
    assert eng.cost.device_time("decode").count == 0
    assert eng.registry.snapshot()["gauges"][
        'program_flops{program="decode"}'] > 0
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=8)
    eng.run_until_idle()
    assert eng.cost.device_time("decode").count > 0
    assert eng.metrics_summary()["goodput"] > 0
    eng.close()


def test_sampling_disabled_keeps_static_table(tiny):
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    _, tl, _, ct, _, pt = tiny
    eng = Engine(tl, ct, pt, EngineConfig(cache_dtype=torch.float32,
                                          cost_sample_every=0, **BASE),
                 device="cpu")
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=4)
    eng.run_until_idle()
    assert eng.cost.entries["decode"].flops > 0
    assert eng.cost.device_time("decode").count == 0
    s = eng.metrics_summary()
    assert "decode_mfu" not in s and "goodput" not in s
    eng.close()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def test_train_step_registers_its_analytic_cost_and_samples():
    """Each built step has its own entry; its FLOPs are bench.py's
    reckoning, 6N + 12*L*h*S a token; samples land at call 2 and every
    2nd after."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.common import count_params
    from accelerate_tpu_torch.optimizers import adamw
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.training import TrainState

    PartialState._reset_state()
    cfg = llama.LlamaConfig.tiny()
    acc = Accelerator(cpu=True, mixed_precision="bf16",
                      cost_sample_every=2)
    state = acc.prepare(TrainState.create(
        apply_fn=None, params=llama.init_params(cfg, 0, device="cpu"),
        tx=adamw(1e-3)))
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    step = acc.train_step(lambda p, b: llama.causal_lm_loss(cfg, p, b))
    for _ in range(6):
        state, m = step(state, {"input_ids": ids})
    n = count_params(state.params)
    sheet = acc.cost_table.roofline("train_step")
    assert sheet["cost_source"] == "analytic"
    assert sheet["flops"] == (6 * n + 12 * cfg.num_hidden_layers
                              * cfg.hidden_size * 16) * 2 * 16
    assert sheet["bytes_accessed"] == n * (28 + 3 * 2)
    assert sheet["device_time_samples"] == 3.0  # calls 2, 4 and 6
    assert 0.0 < sheet["mfu"] and sheet["peaks_nominal"] == 1.0
    assert acc.telemetry.counter("accelerator_train_steps_total").value >= 6
    step2 = acc.train_step(lambda p, b: llama.causal_lm_loss(cfg, p, b))
    assert (step._cost_name, step2._cost_name) == ("train_step",
                                                   "train_step_2")
    acc.end_training()
    PartialState._reset_state()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fence waits on CUDA work")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fence_waits_for_the_work_on_a_cuda_tree(cuda):
    a = torch.randn(2048, 2048, device=cuda)
    for _ in range(8):
        a = a @ a / 64.0
    done = torch.cuda.Event()
    done.record()
    tcost.fence({"x": [a]})
    assert done.query()


@pytest.mark.cuda
def test_graphed_engine_samples_every_call_with_captures_flat(cuda):
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    cfg = llama.LlamaConfig.tiny()
    eng = Engine(llama, cfg, llama.init_params(cfg, 0),
                 EngineConfig(cache_dtype=torch.float32,
                              cost_sample_every=1, **BASE))
    for n in (5, 9, 13):
        eng.submit(np.arange(1, n + 1, dtype=np.int32), max_new_tokens=6)
    eng.run_until_idle()
    assert eng.compile_stats() == {"admit": 1, "prefill": 1, "decode": 1}
    assert eng.cost.device_time("decode").count == \
        eng.cost.calls("decode") - 1
    assert 0.0 < eng.metrics_summary()["decode_mfu"]
    eng.close()
