"""The port's utils (``whisper_tpu_torch/utils/``): the stage timer against
``whisper_tpu/utils/profiling.py`` under the same clock, the profiler
trace, and the logger against ``whisper_tpu/utils/logging.py``."""

import itertools
import json
import logging
import time

import pytest
import torch

from whisper_tpu.utils import logging as jax_logging
from whisper_tpu.utils import profiling as jax_profiling
from whisper_tpu_torch.utils import logging as port_logging
from whisper_tpu_torch.utils import profiling as port_profiling


def _timed(mod, clock, monkeypatch):
    """A StageTimer of ``mod`` through a fixed sequence of stages, with
    ``time.perf_counter`` stepping through ``clock``."""
    ticks = iter(clock)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    t = mod.StageTimer()
    for name in ("mel", "decode", "decode", "encode", "decode"):
        with t.stage(name):
            pass
    t.add_audio(10.0)
    t.add_audio(2.5)
    monkeypatch.undo()
    return t


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_timer_report_equals_jax(seed, monkeypatch):
    """The same stages on the same clock give the same report: keys, order
    (by total), rounding, shares, rtf."""
    steps = [0.0123456, 0.0200001, 0.005, 0.3333333, 0.0000007][seed:] + [0.01] * seed
    clock = list(itertools.accumulate(x for s in steps for x in (1.0, s)))
    port = _timed(port_profiling, clock, monkeypatch)
    ref = _timed(jax_profiling, clock, monkeypatch)
    assert port.report() == ref.report()
    rep = port.report()
    assert list(rep["stages"]) == list(ref.report()["stages"])
    assert rep["stages"]["decode"]["calls"] == 3 and rep["audio_seconds"] == 12.5
    assert json.loads(port.dump()) == json.loads(ref.dump())


def test_stage_timer_empty_report_equals_jax():
    assert port_profiling.StageTimer().report() == jax_profiling.StageTimer().report()


def test_stage_timer_dump_writes(tmp_path):
    t = port_profiling.StageTimer()
    with t.stage("x"):
        pass
    path = tmp_path / "r.json"
    t.dump(str(path))
    assert json.loads(path.read_text())["stages"]["x"]["calls"] == 1


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    """The trace context yields its file's path and writes it at the end:
    Chrome-trace JSON holding the block's ops."""
    with port_profiling.profiler_trace(str(tmp_path / "tr")) as path:
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    assert path.startswith(str(tmp_path / "tr")) and path.endswith(".pt.trace.json")
    trace = json.loads(open(path).read())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("matmul" in n or "mm" in n for n in names), sorted(names)[:20]


def test_get_logger_idempotent_as_jax(monkeypatch):
    monkeypatch.setenv("WHISPER_TPU_LOG", "debug")
    a = port_logging.get_logger("whisper_tpu_torch.test_idem")
    b = port_logging.get_logger("whisper_tpu_torch.test_idem")
    ref = jax_logging.get_logger("whisper_tpu.test_idem_ref")
    assert a is b and len(a.handlers) == 1 == len(ref.handlers)
    assert a.level == ref.level == logging.DEBUG
    assert a.propagate is ref.propagate is False
    a.info("hello")
    assert port_logging.get_logger().name == "whisper_tpu_torch"


def test_logger_format_equals_jax():
    rec = logging.LogRecord("n", logging.WARNING, __file__, 1, "msg %d", (3,), None)
    port = port_logging.get_logger("whisper_tpu_torch.test_fmt").handlers[0].formatter
    ref = jax_logging.get_logger("whisper_tpu.test_fmt").handlers[0].formatter
    assert port.format(rec) == ref.format(rec) == "[W n] msg 3"
