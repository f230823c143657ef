"""The port's `StepTimer` against the JAX package's on the same fake
clock (`time.perf_counter` patched, which both modules read), the same
schedule of ticks, dispatches, input stalls, tagged overheads and
attributed losses: goodput, the stall taxonomy, the means and the
summary agree exactly (one float arithmetic on the same inputs).
`causal_lm_train_flops` is equal; without a GPU the peak is 0 and the
memory stats are empty, as the reference reports on a backend without
them."""

from __future__ import annotations

import math
import time

import pytest

from accelerate_tpu import profiler as jp
from accelerate_tpu_torch import profiler as tp
from accelerate_tpu_torch.telemetry.registry import MetricsRegistry


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _drive(mod, clock, warmup, registry=None):
    timer = mod.StepTimer(flops_per_step=3.0e12, tokens_per_step=4096,
                          warmup_steps=warmup, peak_flops=989e12,
                          num_chips=1, registry=registry, name="parity")
    timer.tick()
    for i in range(9):
        with timer.input_stall():
            clock.advance(0.001 * (i % 3))
        with timer.dispatch():
            clock.advance(0.0004 + 0.0001 * i)
        clock.advance(0.150 + 0.002 * (i % 4))
        timer.tick()
        if i % 3 == 2:
            with timer.overhead("checkpoint_stage"):
                clock.advance(0.020)
        if i == 5:
            with timer.overhead():
                clock.advance(0.005)
    timer.note_lost("straggler", 0.25)
    return timer


@pytest.mark.parametrize("warmup", [0, 1, 2])
def test_step_timer_matches_jax_on_the_same_clock(warmup, monkeypatch):
    results = []
    for mod in (tp, jp):
        clock = _Clock()
        monkeypatch.setattr(time, "perf_counter", clock)
        timer = _drive(mod, clock, warmup)
        results.append((timer.goodput, timer.stall_taxonomy(),
                        timer.mean_step_time, timer.host_dispatch_us,
                        timer.input_stall_us, timer.steps_recorded,
                        timer.mfu(), timer.summary()))
    port, ref = results
    assert port == ref
    assert 0.0 < port[0] < 1.0
    assert set(port[1]) == {"step", "input", "checkpoint_stage", "other",
                            "compile", "straggler"} - (
        {"compile"} if warmup == 0 else set())


def test_step_timer_registry_series_match_jax(monkeypatch):
    from accelerate_tpu.telemetry.registry import MetricsRegistry as JReg

    snaps = []
    for mod, reg in ((tp, MetricsRegistry()), (jp, JReg())):
        clock = _Clock()
        monkeypatch.setattr(time, "perf_counter", clock)
        _drive(mod, clock, 1, registry=reg)
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["histograms"]["parity_time_seconds"]["count"] == 8


def test_step_timer_empty_and_reset_match_jax():
    for mod in (tp, jp):
        timer = mod.StepTimer(warmup_steps=0)
        assert math.isnan(timer.goodput)
        assert timer.stall_taxonomy() == {}
        timer.tick()
        timer.tick()
        assert timer.steps_recorded == 1
        timer.reset()
        assert timer.steps_recorded == 0 and timer.stall_taxonomy() == {}


@pytest.mark.parametrize("kw", [
    dict(n_params=1_487_000_000, tokens=4096),
    dict(n_params=1_487_000_000, tokens=4096, num_layers=2,
         hidden_size=4096, seq_len=2048),
    dict(n_params=8_030_000_000, tokens=4096, num_layers=32,
         hidden_size=4096, seq_len=2048, attention=False),
], ids=["dense_only", "with_attention", "attention_off"])
def test_causal_lm_train_flops_matches_jax(kw):
    assert tp.causal_lm_train_flops(**kw) == jp.causal_lm_train_flops(**kw)


def test_peak_and_memory_without_a_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tp.peak_flops_per_chip() == 0.0
    assert tp.device_memory_stats() == {}
    # the H100 entry of the table, by name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert tp.peak_flops_per_chip() == 989e12
