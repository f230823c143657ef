"""The port's trackers, logging and telemetry snapshots against the JAX
package's: the cases of `tests/test_tracking.py`, every backend driven
through a stub module (the card's machine has none of their packages)
with the calls each package's tracker makes compared, the JSONL lines of
both packages' trackers and Accelerators compared (minus their `ts`),
`logging.get_logger`'s records, and `snapshot_for_tracking` /
`write_snapshot` on registries fed the same series.
"""

import json
import logging
import sys
import types

import numpy as np
import pytest
import torch

import accelerate_tpu as at
from accelerate_tpu import logging as jlogging
from accelerate_tpu import tracking as jt
from accelerate_tpu.telemetry import export as jexport
from accelerate_tpu.telemetry import registry as jregistry
from accelerate_tpu.utils import imports as jimports
from accelerate_tpu.utils.dataclasses import LoggerType as JLoggerType
from accelerate_tpu_torch import logging as tlogging
from accelerate_tpu_torch import tracking as tt
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.telemetry import export as texport
from accelerate_tpu_torch.telemetry import registry as tregistry
from accelerate_tpu_torch.utils import imports as timports
from accelerate_tpu_torch.utils.dataclasses import LoggerType


@pytest.fixture(autouse=True)
def _fresh_port_state():
    PartialState._reset_state()
    yield
    PartialState._reset_state()


def _lines(path, drop=("ts",)):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in drop}
                for line in f]


def test_logger_types_and_registry_like_jax():
    assert LoggerType.list() == JLoggerType.list()
    names = {str(t) for t in LoggerType if t != LoggerType.ALL}
    assert names == set(tt.LOGGER_TYPE_TO_CLASS) == \
        set(jt.LOGGER_TYPE_TO_CLASS)


def test_availability_checks_like_jax():
    for name in ("tensorboard", "wandb", "mlflow", "comet_ml", "aim",
                 "clearml", "dvclive"):
        fn = f"is_{name}_available"
        assert getattr(timports, fn)() == getattr(jimports, fn)()


_VALUES = [
    {"loss": 0.5, "acc": np.float32(0.25), "n": np.int64(3),
     "nested": {"a": np.asarray(1.5), "b": [np.float32(2.0), "x"]},
     "note": "text", "none": None},
    {"loss": 0.125, "lr": 3e-4},
]


def test_jsonl_tracker_lines_like_jax(tmp_path):
    out = []
    for mod, d in ((tt, tmp_path / "t"), (jt, tmp_path / "j")):
        t = mod.JSONLTracker("run", logging_dir=str(d))
        t.store_init_configuration({"lr": 1e-3, "layers": 2,
                                    "sizes": (1, 2), "obj": object})
        for step, values in enumerate(_VALUES):
            t.log(values, step=step)
        t.log({"loss": 1.0})
        t.finish()
        out.append(_lines(t.path))
    assert out[0] == out[1]
    assert out[0][0]["event"] == "config" and out[0][0]["config"]["lr"] == 1e-3
    assert out[0][2]["loss"] == 0.125 and out[0][2]["step"] == 1


def test_jsonl_tracker_takes_torch_scalars(tmp_path):
    t = tt.JSONLTracker("run", logging_dir=str(tmp_path))
    t.log({"loss": torch.tensor(0.5), "bf": torch.tensor(1.5,
                                                        dtype=torch.bfloat16),
           "step_t": torch.tensor(7), "vec": torch.zeros(2)}, step=3)
    t.finish()
    (line,) = _lines(t.path)
    assert (line["loss"], line["bf"], line["step_t"]) == (0.5, 1.5, 7)
    assert isinstance(line["vec"], str)


def test_scalarize_all_like_jax():
    values = {"a": np.float32(1.5), "b": np.asarray(2), "c": "s", "d": 4,
              "e": np.ones(2)}
    got = tt._scalarize_all(values)
    want = jt._scalarize_all(values)
    assert got.keys() == want.keys()
    for k in "abcd":
        assert got[k] == want[k] and type(got[k]) is type(want[k])
    assert tt._scalarize_all({"t": torch.tensor(0.25)})["t"] == 0.25


@pytest.mark.parametrize("names", [["jsonl"], ["jsonl", "aim"],
                                   ["JSONL", LoggerType.JSONL], ["all"]],
                         ids=["jsonl", "unavailable_skipped", "dedup", "all"])
def test_filter_trackers_like_jax(tmp_path, names):
    got = tt.filter_trackers(names, logging_dir=str(tmp_path / "t"))
    jnames = [JLoggerType(str(n).lower()) if isinstance(n, LoggerType)
              else n for n in names]
    want = jt.filter_trackers(jnames, logging_dir=str(tmp_path / "j"))
    assert [type(t).__name__ for t in got] == \
        [type(t).__name__ for t in want]
    assert any(isinstance(t, tt.JSONLTracker) for t in got)
    for t in got + want:
        t.finish()


def test_filter_trackers_rejects_unknown_and_passes_instances(tmp_path):
    with pytest.raises(ValueError):
        tt.filter_trackers(["not_a_tracker"], logging_dir=str(tmp_path))
    inst = tt.JSONLTracker("run", logging_dir=str(tmp_path))
    assert tt.filter_trackers([inst]) == [inst]
    inst.finish()


# --- every backend through a stub ------------------------------------------


class _Recorder:
    """A stand-in for a backend object: every attribute is a method that
    records its call; attribute writes and item writes are recorded too."""

    def __init__(self, calls, name):
        object.__setattr__(self, "_calls", calls)
        object.__setattr__(self, "_name", name)

    def __getattr__(self, attr):
        if attr == "config":
            return _Recorder(self._calls, f"{self._name}.config")

        def method(*args, **kwargs):
            self._calls.append((f"{self._name}.{attr}", args,
                                tuple(sorted(kwargs.items()))))
            if attr in ("get_logger", "init", "start_run"):
                return _Recorder(self._calls, f"{self._name}.{attr}()")
            return None
        return method

    def __setattr__(self, attr, value):
        self._calls.append((f"{self._name}.{attr}=", (value,), ()))

    def __setitem__(self, key, value):
        self._calls.append((f"{self._name}[{key}]=", (value,), ()))


def _stub_modules(calls):
    def factory(name):
        return lambda *a, **kw: (calls.append((name, a, tuple(
            sorted(kw.items())))) or _Recorder(calls, name))

    wandb = types.SimpleNamespace(init=factory("wandb.init"),
                                  config=_Recorder(calls, "wandb.config"))
    return {
        "torch.utils.tensorboard": types.SimpleNamespace(
            SummaryWriter=factory("SummaryWriter")),
        "wandb": wandb,
        "mlflow": _Recorder(calls, "mlflow"),
        "comet_ml": types.SimpleNamespace(Experiment=factory("Experiment")),
        "aim": types.SimpleNamespace(Run=factory("Run")),
        "clearml": types.SimpleNamespace(Task=types.SimpleNamespace(
            init=factory("Task.init"))),
    }


def _drive(cls, tmp_path, calls):
    kw = {"logging_dir": str(tmp_path)} if cls.requires_logging_directory \
        else {}
    t = cls("run", **kw)
    t.store_init_configuration({"lr": 0.1, "opt": {"b1": 0.9}})
    t.log({"loss": 1.5, "acc": np.float32(0.5), "note": "x"}, step=3)
    t.log({"loss": 1.25}, step=None)
    t.finish()
    out = [(name, tuple(str(tmp_path) if a == str(tmp_path) else a
                        for a in args), kw) for name, args, kw in calls]
    calls.clear()
    return out


@pytest.mark.parametrize("name", ["tensorboard", "wandb", "mlflow",
                                  "comet_ml", "aim", "clearml"])
def test_backend_calls_like_jax(monkeypatch, tmp_path, name):
    calls = []
    for mod_name, stub in _stub_modules(calls).items():
        monkeypatch.setitem(sys.modules, mod_name, stub)
    monkeypatch.setattr(torch.utils, "tensorboard",
                        sys.modules["torch.utils.tensorboard"], raising=False)
    got = _drive(tt.LOGGER_TYPE_TO_CLASS[name], tmp_path, calls)
    want = _drive(jt.LOGGER_TYPE_TO_CLASS[name], tmp_path, calls)
    assert got == want and got


class _FakeLive:
    def __init__(self, **kwargs):
        self.params = None
        self.metrics = []
        self.step = None
        self.ended = False

    def log_params(self, values):
        self.params = values

    def log_metric(self, k, v):
        self.metrics.append((self.step, k, v))

    def next_step(self):
        pass

    def end(self):
        self.ended = True


def test_dvclive_tracker_with_stub_like_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "dvclive",
                        types.SimpleNamespace(Live=_FakeLive))
    lives = []
    for mod in (tt, jt):
        t = mod.DVCLiveTracker("run")
        t.store_init_configuration({"lr": 0.1})
        t.log({"loss": 1.5, "note": "skipped-non-scalar"}, step=3)
        t.log({"loss": np.float32(1.5), "acc": np.asarray(0.5)}, step=4)
        t.finish()
        lives.append(t.live)
    assert lives[0].metrics == lives[1].metrics == [
        (3, "loss", 1.5), (4, "loss", 1.5), (4, "acc", 0.5)]
    assert lives[0].params == {"lr": 0.1} and lives[0].ended
    t = tt.DVCLiveTracker("run")
    t.log({"loss": torch.tensor(2.5)}, step=0)
    assert t.live.metrics == [(0, "loss", 2.5)]


# --- the Accelerator's tracker surface ----------------------------------------


def _accelerator_run(acc, project):
    acc.init_trackers(project, config={"lr": 3e-4, "layers": 2})
    acc.log({"loss": 2.0, "lr": np.float32(3e-4)}, step=0)
    acc.log({"loss": 1.0}, step=1, log_kwargs={"jsonl": {}})
    tracker = acc.get_tracker("jsonl")
    assert acc.get_tracker("jsonl", unwrap=True) is tracker.tracker
    with pytest.raises(ValueError, match="init_trackers"):
        acc.get_tracker("wandb")
    flat = acc.log_telemetry(step=2)
    acc.end_training()
    return tracker.path, flat


def test_accelerator_trackers_like_jax(tmp_path):
    tregistry.get_registry().reset()
    jregistry.get_registry().reset()
    acc = Accelerator(cpu=True, log_with="jsonl",
                      project_dir=str(tmp_path / "t"))
    tpath, tflat = _accelerator_run(acc, "run")
    at.PartialState._reset_state()
    jacc = at.Accelerator(log_with="jsonl", project_dir=str(tmp_path / "j"))
    jpath, jflat = _accelerator_run(jacc, "run")
    tlines, jlines = _lines(tpath), _lines(jpath)
    assert tpath.endswith("t/run/metrics.jsonl")
    # config and log lines equal; the telemetry line holds each package's
    # own registry, whose log counter agrees
    assert tlines[:3] == jlines[:3]
    key = "telemetry/accelerator_log_calls_total"
    assert tlines[3][key] == jlines[3][key] == tflat[key] == jflat[key] == 2
    assert tlines[3]["step"] == 2 and all(k.startswith("telemetry/")
                                          for k in tflat)
    assert tracker_closed(acc)


def tracker_closed(acc):
    return acc.get_tracker("jsonl", unwrap=True).closed


def test_accelerator_log_telemetry_carries_the_step_timer(tmp_path):
    tregistry.get_registry().reset()
    acc = Accelerator(cpu=True, log_with=["jsonl"],
                      project_dir=str(tmp_path))
    acc.init_trackers("timed")
    timer = acc.step_timer(tokens_per_step=8, warmup_steps=0)
    for _ in range(3):
        with timer.input_stall():
            pass
        timer.tick()
    flat = acc.log_telemetry()
    assert flat["telemetry/step_input_stall_seconds_count"] == 3
    assert flat["telemetry/step_time_seconds_count"] == 2
    acc.end_training()
    (line,) = _lines(acc.get_tracker("jsonl").path)
    assert line["telemetry/step_input_stall_seconds_count"] == 3


def test_accelerator_without_trackers_logs_nothing():
    acc = Accelerator(cpu=True)
    acc.init_trackers("none")
    acc.log({"loss": 1.0})
    assert acc.trackers == [] and acc.log_with == []
    acc.end_training()


def test_end_training_finishes_trackers_when_a_save_failed(monkeypatch,
                                                           tmp_path):
    from accelerate_tpu_torch import checkpointing

    acc = Accelerator(cpu=True, log_with="jsonl", project_dir=str(tmp_path))
    acc.init_trackers("run")

    def fail():
        raise OSError("disk full")

    monkeypatch.setattr(checkpointing, "wait_for_checkpoints", fail)
    with pytest.raises(OSError, match="disk full"):
        acc.end_training()
    assert tracker_closed(acc)


# --- telemetry snapshots --------------------------------------------------------


def _feed(reg):
    reg.counter("steps_total").inc(3)
    reg.gauge("hbm_bytes").set_max(7.0)
    h = reg.histogram("step_seconds")
    for v in (0.1, 0.2, 0.4):
        h.record(v)
    return reg


def test_snapshot_for_tracking_and_write_snapshot_like_jax(tmp_path):
    treg = _feed(tregistry.MetricsRegistry())
    jreg = _feed(jregistry.MetricsRegistry())
    assert texport.snapshot_for_tracking(treg) == \
        jexport.snapshot_for_tracking(jreg)
    assert texport.snapshot_for_tracking(treg, prefix="x/") == \
        jexport.snapshot_for_tracking(jreg, prefix="x/")
    texport.write_snapshot(str(tmp_path / "t.jsonl"), treg)
    jexport.write_snapshot(str(tmp_path / "j.jsonl"), jreg)
    assert _lines(tmp_path / "t.jsonl") == _lines(tmp_path / "j.jsonl")


# --- logging ------------------------------------------------------------------


def _records(caplog, mod, name):
    caplog.clear()
    log = mod.get_logger(name, log_level="INFO")
    log.info("plain")
    log.info("everywhere", main_process_only=False)
    log.warning("ordered %d", 7, in_order=True)
    log.warning_once("once")
    log.warning_once("once")
    log.debug("hidden")
    return [(r.levelname, r.getMessage()) for r in caplog.records
            if r.name == name]


def test_logger_records_like_jax(caplog):
    caplog.set_level(logging.DEBUG)
    got = _records(caplog, tlogging, "port_logger")
    want = _records(caplog, jlogging, "port_logger")
    assert got == want == [("INFO", "plain"), ("INFO", "everywhere"),
                           ("WARNING", "[rank 0] ordered 7"),
                           ("WARNING", "once")]
    logging.getLogger("port_logger").setLevel(logging.NOTSET)
    logging.getLogger().setLevel(logging.WARNING)


def test_logger_in_order_across_processes_raises():
    """In a real two-process gloo world `in_order=True` logs rank by
    rank, each record prefixed with its rank, and a main-process record
    once. (The name is kept from when this raised.)"""
    from accelerate_tpu_torch.test_utils import run_world
    from accelerate_tpu_torch.test_utils.worlds import logging_forms

    lines = run_world(logging_forms, 2)[0]["log"]
    assert lines == ["[rank 0] ordered 0 from 0", "[rank 1] ordered 0 from 1",
                     "[rank 0] ordered 1 from 0", "[rank 1] ordered 1 from 1",
                     "main only from 0"]
