"""The readers of the per-layer metrics that read the program's own spans
(``harness/program_spans.py`` and the ``metrics/`` files that use it): the
number each gives on a hand-made trace and span list, the window they keep
to, the sweep that splits the idle time against ``Trace.idle_by_span``,
and a tiny traced run of each cell on the CPU."""

import collections
import json
import random

import numpy as np
import pytest

from cardbench.harness import env, program_spans
from cardbench.harness.cell import Context, read_metric
from cardbench.harness.trace import Spans, Trace, _merge
from cardbench.tests.tiny import run_tiny
from deepcalcium_torch.utils import profiling
from deepcalcium_torch.utils.profiling import Span

MS = 1_000_000
SPEC = json.loads((env.ROOT / "BENCHMARK.json").read_text())
NEW = {m["name"]: m for m in SPEC["per_layer"]
       if m["source"] == "program_span" or "unattributed" in m["name"]}
CELL = {"nf-evaluate-card": "eval.", "nf-fit": "fit.",
        "spikes-predict": "spikes."}


class Tree:
    """Hand-made spans, in milliseconds from the window's start."""

    def __init__(self):
        self.spans, self.ids = [], 0

    def add(self, name, a, b, parent=None, thread=1):
        self.ids += 1
        root = self.ids if parent is None else parent.root
        s = Span(name, a * MS, b * MS, self.ids,
                 None if parent is None else parent.id, root, thread)
        self.spans.append(s)
        return s


def _trace(busy_ms, t1_ms):
    tr = Trace(0, t1_ms * MS)
    iv = np.asarray([(a * MS, b * MS) for a, b in busy_ms], np.int64)
    tr.intervals = _merge(iv.reshape(-1, 2))
    return tr


def _ctx(tr, spans, monkeypatch, workload="nf-evaluate-card"):
    monkeypatch.setattr(profiling, "_spans",
                        collections.deque(spans, maxlen=100))
    return Context({"name": workload}, {}, {}, {}, tr, Spans())


def _evaluate_tree(t):
    """Two evaluate calls of 100 ms, from 10 ms into the window."""
    for c in range(2):
        r = t.add("evaluate_movie", 10 + 100 * c, 110 + 100 * c)
        b = t.add("evaluate_movie.build", r.t0 / MS, r.t0 / MS + 60, r)
        t.add("net.init", r.t0 / MS, r.t0 / MS + 30 + 10 * c, b)
        t.add("net.load", r.t0 / MS + 30 + 10 * c, r.t0 / MS + 50, b)
        t.add("evaluate_movie.evaluate", r.t0 / MS + 60, r.t0 / MS + 90, r)
        t.add("evaluate_movie.fetch", r.t0 / MS + 90, r.t0 / MS + 98, r)
    return t


def test_evaluate_readers(monkeypatch):
    t = _evaluate_tree(Tree())
    before = t.add("evaluate_movie", -50, -1)
    t.add("evaluate_movie.build", -50, -2, before)
    after = t.add("evaluate_movie", 215, 400)
    t.add("evaluate_movie.build", 215, 390, after)
    # Busy: 10 ms inside each evaluate, 5 ms inside the first build.
    tr = _trace([(75, 85), (175, 185), (15, 20)], 220)
    ctx = _ctx(tr, t.spans, monkeypatch)
    assert read_metric("eval.build_ms", ctx) == pytest.approx(60.0)
    assert read_metric("eval.net_init_ms", ctx) == pytest.approx(35.0)
    # Idle 195 ms; no span below a root covers 0-10, each call's last
    # 2 ms (after its fetch) and 210-220.
    idle = 220 - 25
    unattributed = 10 + 2 + 2 + 10
    assert read_metric("eval.idle_unattributed_pct", ctx) == pytest.approx(
        100 * unattributed / idle)


def test_fit_readers(monkeypatch):
    t = Tree()
    r = t.add("fit", 0, 1000)
    t.add("fit.summaries", 0, 100, r)
    t.add("fit.setup", 100, 200, r)
    steps = [(200, 5, 40), (245, 1, 10), (256, 2, 12), (270, 3, 11),
             (284, 1, 9)]
    for a, wait, step in steps:
        t.add("fit.prefetch_wait", a, a + wait, r)
        t.add("fit.step", a + wait, a + wait + step, r)
    for e, e0 in enumerate((300, 600)):
        t.add("fit.metrics_sync", e0, e0 + 10, r)
        v = t.add("fit.validate", e0 + 10, e0 + 200, r)
        t.add("fit.validate.forward", e0 + 10, e0 + 50 + 10 * e, v)
        t.add("fit.validate.score", e0 + 50 + 10 * e, e0 + 200, v)
        t.add("fit.checkpoint", e0 + 200, e0 + 230 + 20 * e, r)
    tr = _trace([(0, 1)], 1000)
    ctx = _ctx(tr, t.spans, monkeypatch, "nf-fit")
    got = {name: read_metric(name, ctx) for name in NEW if
           name.startswith("fit.")}
    assert got["fit.summaries_ms"] == pytest.approx(100)
    assert got["fit.dispatch_ms"] == pytest.approx(11)
    assert got["fit.prefetch_wait_ms"] == pytest.approx(2)
    assert got["fit.val_forward_ms"] == pytest.approx(45)
    assert got["fit.val_score_ms"] == pytest.approx(145)
    assert got["fit.ckpt_ms"] == pytest.approx(40)
    # Idle 999 ms; no span below the root covers 294-300, 530-600 and
    # 850-1000.
    assert got["fit.idle_unattributed_pct"] == pytest.approx(
        100 * (6 + 70 + 150) / 999)


def test_spike_readers(monkeypatch):
    t = Tree()
    for c in range(4):
        r = t.add("predict", 100 * c, 100 * c + 90)
        t.add("predict.ckpt_read", 100 * c, 100 * c + 10 + c, r)
        b = t.add("predict.build", 100 * c + 20, 100 * c + 50, r)
        t.add("net.fold", 100 * c + 40, 100 * c + 50, b)
    tr = _trace([(0, 5)], 400)
    ctx = _ctx(tr, t.spans, monkeypatch, "spikes-predict")
    assert read_metric("spikes.ckpt_read_ms", ctx) == pytest.approx(11.5)
    assert read_metric("spikes.build_ms", ctx) == pytest.approx(30)
    covered = sum(10 + c for c in range(4)) - 5 + 4 * 30
    assert read_metric("spikes.idle_unattributed_pct", ctx) == pytest.approx(
        100 * (395 - covered) / 395)


def test_spans_outside_the_window_are_ignored(monkeypatch):
    t = Tree()
    r = t.add("predict", -10, 50)  # starts before the window
    t.add("predict.ckpt_read", -10, 5, r)
    t.add("predict.build", 10, 20, r)
    late = t.add("predict", 90, 130)  # ends after it
    t.add("predict.build", 95, 125, late)
    ctx = _ctx(_trace([(0, 1)], 100), t.spans, monkeypatch,
               "spikes-predict")
    assert read_metric("spikes.ckpt_read_ms", ctx) is None
    assert read_metric("spikes.build_ms", ctx) == pytest.approx(10)


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_finds_nothing_without_spans(name, monkeypatch):
    """An untraced run, a trace with no spans, and a program that records
    none (one without ``recorded``): None, and no exception."""
    ctx = Context({"name": "x"}, {}, {}, {}, None, Spans())
    assert read_metric(name, ctx) is None
    ctx = _ctx(_trace([(0, 1)], 10), [], monkeypatch)
    assert read_metric(name, ctx) is None
    t = _evaluate_tree(Tree())
    ctx = _ctx(_trace([(0, 1)], 220), t.spans, monkeypatch)
    monkeypatch.delattr(profiling, "recorded")
    assert read_metric(name, ctx) is None


@pytest.mark.parametrize("seed", range(20))
def test_idle_split_is_idle_by_span(seed):
    """The sweep against ``Trace.idle_by_span`` on random busy intervals
    and random spans, nested, overlapping, equal in length and sticking
    out of the window."""
    rng = random.Random(seed)
    t1 = 10_000
    busy = []
    for _ in range(rng.randint(0, 60)):
        a = rng.randint(-100, t1 + 50)
        busy.append((a, a + rng.randint(1, 300)))
    tr = Trace(0, t1)
    iv = np.clip(np.asarray(busy, np.int64).reshape(-1, 2), 0, t1)
    tr.intervals = _merge(iv[iv[:, 1] > iv[:, 0]])
    items = []
    for k in range(rng.randint(0, 40)):
        a = rng.randint(-500, t1)
        items.append((f"s{rng.randint(0, 6)}", a, a + rng.randint(0, 3000)))
    if items:
        items.append(("twin", items[0][1], items[0][2]))
    want = Spans()
    want.items = items
    expect = dict(tr.idle_by_span(want, n=None))
    got = program_spans.idle_split(tr, items)
    assert set(got) == {k for k, v in expect.items() if v > 0}
    for k, v in got.items():
        assert v == pytest.approx(expect[k], abs=1e-12)


def test_no_reader_changes_the_harness_spans(monkeypatch):
    t = _evaluate_tree(Tree())
    ctx = _ctx(_trace([(75, 85)], 220), t.spans, monkeypatch)
    ctx.spans.add("evaluate_movie", 10, 110)
    before = list(ctx.spans.items)
    for name in NEW:
        read_metric(name, ctx)
    assert ctx.spans.items == before


@pytest.mark.parametrize("cell", sorted(CELL))
def test_traced_tiny_run_reports_the_span_metrics(cell):
    """On the CPU the profiler sees no device, so the idle readers find
    nothing; every reader of a program span reads a number."""
    result, _ = run_tiny(cell, traced=True)
    assert result["correct"], result["compared"]
    mine = {n for n, m in NEW.items() if cell in m["workloads"]}
    assert {n for n in mine if NEW[n]["source"] == "program_span"} == \
        set(result["metrics"]) & mine
    assert all(result["metrics"][n]["value"] > 0
               for n in set(result["metrics"]) & mine)
    assert all(n.startswith(CELL[cell]) for n in mine) and len(mine) >= 3
