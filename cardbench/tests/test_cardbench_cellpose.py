"""The Cellpose-SAM cell (``cpsam-evaluate-card``) rehearsed on the CPU at
a tiny size (``tiny_cellpose.py``): a sound run is correct, a traced run
reads its per-layer metrics, and each fault planted in the timed path
after set-up (the attention's bias left out, half the Euler steps, the
flow check skipped) and the fp8 control are caught. Then the readers of
the program's counters, and the label matching of ``labels_gap``. On a
card, at the cell's own size, the same faults and the control fail while
the package passes (marker ``cuda``)."""

import collections
import json
import time

import numpy as np
import pytest
import torch

from cardbench.harness import env, program_counters
from cardbench.harness.cell import Bench, Context, read_metric, run
from cardbench.harness.entries.evaluate_movie_cellpose import match_gap
from cardbench.harness.trace import Spans, Trace
from cardbench.tests.tiny_cellpose import CELL, run_tiny
from deepcalcium_torch.utils import profiling

SEED = 11
METRICS = [m["name"] for m in json.loads(
    (env.ROOT / "BENCHMARK.json").read_text())["per_layer"]
    if CELL in m["workloads"]]


def _no_bias(monkeypatch):
    """The relative-position bias left out of every block's attention."""
    from deepcalcium_torch.ops import attention as mod

    real = mod.rel_pos_terms

    def zero(q, rh, rw):
        return tuple(torch.zeros_like(t) for t in real(q, rh, rw))

    monkeypatch.setattr(mod, "rel_pos_terms", zero)


def _half_steps(monkeypatch):
    """100 Euler steps instead of 200."""
    from deepcalcium_torch.ops import flows as mod

    real = mod.follow_flows
    monkeypatch.setattr(mod, "follow_flows",
                        lambda dP, inds, niter=200: real(dP, inds, niter // 2))


def _no_flow_check(monkeypatch):
    """The flow check skipped: every mask kept."""
    from deepcalcium_torch.ops import flows as mod

    monkeypatch.setattr(mod, "remove_bad_flow_masks",
                        lambda labels, dP, threshold=0.4: (labels, 0, 0))


FAULTS = [_no_bias, _half_steps, _no_flow_check]


def _planted(fault, monkeypatch):
    def patch(entry):
        real_setup = entry.setup

        def setup():
            real_setup()
            fault(monkeypatch)
            # A net captured as CUDA graphs in the warm-up would replay
            # without the fault: capture it anew.
            entry.wrapper._graphs.clear()

        entry.setup = setup

    return patch


@pytest.mark.parametrize("seed", [SEED, 7])
def test_sound_run_is_correct(seed):
    result, entry = run_tiny(seed=seed)
    assert result["correct"], result["compared"]
    assert set(result["compared"]) == {"flow_gap", "fg_unexplained",
                                       "labels_gap"}
    assert set(result["metrics"]) == {"movie_ms", "setup_s"}
    assert list(result)[-1] == "compared"
    # The calibrated readout gives the dynamics masks to make.
    assert max(int(labels.max()) for _, labels, _ in entry.outputs) > 0


def test_traced_run_reads_the_window():
    """On the CPU the profiler sees no device: the idle and roofline
    readers find nothing; the span, counter and host-clock ones read."""
    result, _ = run_tiny(seed=SEED, traced=True)
    assert result["correct"], result["compared"]
    assert set(result["metrics"]) == {"cpsam.mfu", "cpsam.net_ms",
                                      "cpsam.dynamics_ms",
                                      "cpsam.follow_ns_per_px"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_fault_is_caught(fault, monkeypatch):
    result, _ = run_tiny(seed=SEED, patch=_planted(fault, monkeypatch))
    assert not result["correct"], result["compared"]


def test_control_is_caught():
    result, entry = run_tiny(seed=SEED)
    limits = entry.limits
    numbers = entry.control()
    assert any(numbers[k] > v for k, v in limits.items() if k in numbers), \
        numbers


def _ctx(counts, spans, monkeypatch):
    monkeypatch.setattr(profiling, "_spans",
                        collections.deque(spans + counts, maxlen=100))
    return Context({"name": CELL}, {}, {}, {}, Trace(0, 1000), Spans())


def test_counter_readers(monkeypatch):
    ms = 1_000_000
    spans = [profiling.Span("cellpose.follow_flows", 10 * ms, 13 * ms, 1,
                            None, 1, 1),
             profiling.Span("cellpose.follow_flows", 20 * ms, 21 * ms, 2,
                            None, 2, 1)]
    counts = [profiling.Count("cellpose.fg_px", 1000.0, 11 * ms, 1, 1, 1),
              profiling.Count("cellpose.fg_px", 3000.0, 21 * ms, 2, 2, 1),
              profiling.Count("cellpose.seeds", 7.0, 21 * ms, 2, 2, 1)]
    ctx = _ctx(counts, spans, monkeypatch)
    ctx.trace = Trace(0, 100 * ms)
    assert program_counters.total(ctx, "cellpose.fg_px") == 4000.0
    assert program_counters.total(ctx, "cellpose.masks") is None
    # 4 ms over 4,000 pixels.
    assert read_metric("cpsam.follow_ns_per_px", ctx) == pytest.approx(1000.0)


@pytest.mark.parametrize("name", METRICS)
def test_reader_finds_nothing_without_spans(name, monkeypatch):
    """An untraced run, a trace with nothing recorded, and a program
    without ``recorded`` and ``counted``: None, and no exception."""
    assert read_metric(name, Context({"name": CELL}, {}, {}, {}, None,
                                     Spans())) is None
    ctx = _ctx([], [], monkeypatch)
    assert read_metric(name, ctx) is None
    monkeypatch.delattr(profiling, "recorded")
    monkeypatch.delattr(profiling, "counted")
    assert read_metric(name, ctx) is None


def test_match_gap():
    a = np.array([[1, 1, 0], [2, 2, 0], [0, 3, 3]])
    assert match_gap(a, a) == 0
    # Renumbered: the same instances.
    assert match_gap(a, np.where(a > 0, 4 - a, 0)) == 0
    # Two instances merged: the smaller one's pixels differ.
    b = np.where(a == 2, 1, a)
    assert match_gap(a, b) == 2
    # One pixel lost to the background.
    c = a.copy()
    c[2, 2] = 0
    assert match_gap(a, c) == 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env.prepare()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 102])
def test_faults_and_control_fail_on_the_card(card, seed, monkeypatch,
                                             capsys):
    """At the cell's own size: the package passes, and the fp8 control and
    each planted fault fail one of the compared numbers."""
    bench = Bench(env.ROOT / "BENCHMARK.json")
    limits = bench.limits(CELL)
    readings = {}
    result, entry = run(bench, CELL, seed, 3.0, False, "cuda",
                        time.perf_counter())
    readings["package"] = entry.numbers
    assert result["correct"], result["compared"]
    readings["fp8"] = entry.control()
    del entry
    for fault in FAULTS:
        with monkeypatch.context() as m:
            result, entry = run(bench, CELL, seed, 3.0, False, "cuda",
                                time.perf_counter(),
                                patch=_planted(fault, m))
        readings[fault.__name__[1:]] = entry.numbers
        del entry
    with capsys.disabled():
        print(f"\ncpsam readings seed {seed}: {json.dumps(readings)}")
    for name, numbers in readings.items():
        fails = any(numbers[k] > v for k, v in limits.items() if k in numbers)
        assert fails == (name != "package"), (name, numbers)
