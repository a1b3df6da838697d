"""The program's spans (``deepcalcium_torch.utils.profiling.span``): off
outside a profiler, their ids, clock and threads inside one, and
the span tree that ``UNet2DSummary.evaluate_movie``, ``UNet2DSummary.fit``
and ``UNet1DSegmentation.predict`` record, on the CPU at a tiny size."""

import collections
import functools
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepcalcium_torch.models import unet1d, unet2d
from deepcalcium_torch.models.unet_1d_segmentation import UNet1DSegmentation
from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary
from deepcalcium_torch.train.checkpoints import save_checkpoint
from deepcalcium_torch.utils import profiling as tprof

torch.set_num_threads(1)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _recorded_in(block):
    """The spans recorded while ``block()`` runs under a CPU profile."""
    t0 = time.time_ns()
    with _cpu_profile():
        block()
    return tprof.recorded(t0, time.time_ns())


def _tree(spans):
    """{root id: Counter of (parent name, name)} with the root's own edge
    as (None, name); asserts every child lies inside its parent and
    shares its parent's root."""
    by_id = {s.id: s for s in spans}
    trees = collections.defaultdict(collections.Counter)
    for s in spans:
        assert s.t0 <= s.t1
        if s.parent is None:
            assert s.root == s.id
            trees[s.id][(None, s.name)] += 1
            continue
        parent = by_id[s.parent]
        assert parent.t0 <= s.t0 and s.t1 <= parent.t1, (s, parent)
        assert s.root == parent.root and s.thread == parent.thread
        trees[s.root][(parent.name, s.name)] += 1
    return list(trees.values())


# --- the primitive -------------------------------------------------------------

def test_span_names_a_span_in_a_trace():
    with _cpu_profile() as prof:
        with tprof.span("stencil-span"):
            torch.ones(4).sum()
    assert any(e.key == "stencil-span" for e in prof.key_averages())
    # Outside a trace it is a no-op that still runs its block.
    ran = []
    with tprof.span("idle"):
        ran.append(1)
    assert ran == [1]


def test_no_span_is_recorded_outside_a_profiler():
    t0 = time.time_ns()
    with tprof.span("off"):
        with tprof.span("off.inner"):
            torch.ones(2).sum()
    assert tprof.recorded(t0, time.time_ns()) == []
    # One shared no-op context, whatever the name.
    assert tprof.span("a") is tprof.span("b")


def test_nested_spans_carry_parent_root_and_the_profilers_clock():
    t0 = time.time_ns()
    with _cpu_profile() as prof:
        with tprof.span("outer"):
            with tprof.span("outer.a"):
                torch.ones(8).sum()
            with tprof.span("outer.b"):
                with tprof.span("outer.b.c"):
                    torch.ones(8).sum()
        with tprof.span("second"):
            pass
    got = {s.name: s for s in tprof.recorded(t0, time.time_ns())}
    assert set(got) == {"outer", "outer.a", "outer.b", "outer.b.c", "second"}
    outer = got["outer"]
    assert outer.parent is None and outer.root == outer.id
    assert got["outer.a"].parent == outer.id == got["outer.b"].parent
    assert got["outer.b.c"].parent == got["outer.b"].id
    assert {got[n].root for n in ("outer.a", "outer.b", "outer.b.c")} == {
        outer.id}
    assert got["second"].parent is None and got["second"].root != outer.id
    assert len({s.id for s in got.values()}) == 5
    # Each span's record_function event lies on the same clock, within 1 ms.
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in got}
    assert set(events) == set(got)
    for name, s in got.items():
        e = events[name]
        assert abs(e.start_ns() - s.t0) < 1_000_000, name
        assert abs(e.start_ns() + e.duration_ns() - s.t1) < 1_000_000, name


def test_span_on_another_thread_has_its_own_root():
    seen = {}

    def worker():
        with tprof.span("worker"):
            seen["thread"] = threading.get_ident()

    t0 = time.time_ns()
    with _cpu_profile():
        with tprof.span("main"):
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    got = {s.name: s for s in tprof.recorded(t0, time.time_ns())}
    assert got["worker"].thread == seen["thread"] != got["main"].thread
    assert got["main"].thread == threading.get_ident()
    assert got["worker"].parent is None
    assert got["worker"].root == got["worker"].id != got["main"].id


def test_spans_from_many_threads_are_all_kept(monkeypatch):
    """Appends from more threads than cores, switching often: none lost,
    and every span's parent is on its own thread."""
    monkeypatch.setattr(tprof, "_spans", collections.deque(maxlen=10_000))
    nthreads, each = 2 * (os.cpu_count() or 2), 50

    def worker():
        for _ in range(each):
            with tprof.span("w"):
                with tprof.span("w.inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            threads = [threading.Thread(target=worker)
                       for _ in range(nthreads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    spans = tprof.recorded(0, time.time_ns())
    assert len(spans) == 2 * nthreads * each
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s.name == "w.inner":
            assert by_id[s.parent].name == "w"
            assert by_id[s.parent].thread == s.thread


def test_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(tprof, "_spans", collections.deque(maxlen=3))
    t0 = time.time_ns()
    with _cpu_profile():
        for i in range(5):
            with tprof.span(f"s{i}"):
                pass
    assert [s.name for s in tprof.recorded(t0, time.time_ns())] == [
        "s2", "s3", "s4"]


def test_recorded_keeps_only_the_window():
    with _cpu_profile():
        with tprof.span("before"):
            pass
        t0 = time.time_ns()
        with tprof.span("inside"):
            pass
        t1 = time.time_ns()
        with tprof.span("after"):
            pass
    assert [s.name for s in tprof.recorded(t0, t1)] == ["inside"]


# --- the wrappers' span trees ---------------------------------------------------

NET_BUILD = {"net.init": 1, "net.load": 1, "net.upload": 1, "net.fold": 1}


def _under(parent, names):
    return {(parent, n): c for n, c in names.items()}


@pytest.fixture(scope="module")
def net2d(tmp_path_factory):
    params, state = unet2d.to_jax_params(
        unet2d.UNet2DS(4, generator=torch.Generator().manual_seed(0)))
    path = str(tmp_path_factory.mktemp("ev") / "m2d.ckpt")
    save_checkpoint(path, params, state)
    return params, state, path


def test_evaluate_movie_span_tree(net2d, tmp_path):
    params, state, path = net2d
    movie = np.random.default_rng(0).integers(
        0, 900, (6, 32, 32)).astype(np.int16)
    model = UNet2DSummary(cpdir=str(tmp_path), device="cpu")
    kw = dict(window_shape=(32, 32), tta=True)
    out = {}

    def calls():
        out["params"] = model.evaluate_movie(movie, params=params,
                                             state=state, **kw)
        out["path"] = model.evaluate_movie(torch.from_numpy(movie),
                                           model_path=path, **kw)

    trees = _tree(_recorded_in(calls))
    body = {(None, "evaluate_movie"): 1,
            **_under("evaluate_movie", {"evaluate_movie.build": 1,
                                        "evaluate_movie.upload": 1,
                                        "evaluate_movie.evaluate": 1,
                                        "evaluate_movie.fetch": 1}),
            **_under("evaluate_movie.build", NET_BUILD)}
    assert trees == [body, {**body, ("evaluate_movie",
                                     "evaluate_movie.load"): 1}]
    # Spans change nothing of the answer.
    plain = model.evaluate_movie(movie, params=params, state=state, **kw)
    for got in out.values():
        np.testing.assert_array_equal(got[0], plain[0])
        np.testing.assert_array_equal(got[1], plain[1])


def _summaries(n, hw=96):
    rng = np.random.default_rng(3)
    S, M = {}, {}
    for i in range(n):
        m = np.zeros((hw, hw), np.uint8)
        for _ in range(6):
            y, x = rng.integers(4, hw - 12, 2)
            m[y:y + 7, x:x + 7] = 1
        S[f"ds{i}"] = (m * 2.0 + rng.normal(0, 0.5, m.shape)).astype(
            np.float32)
        M[f"ds{i}"] = m
    return S, M


def test_fit_span_tree(tmp_path):
    S, M = _summaries(2)
    model = UNet2DSummary(
        cpdir=str(tmp_path), device="cpu", dataset_name_func=lambda n: n,
        series_summary_func=S.__getitem__, mask_summary_func=M.__getitem__,
        net_func=functools.partial(unet2d.UNet2DS, nfb=4, drp=0.0))
    seen = []

    def call():
        model.fit(list(S), shape_trn=(32, 32), shape_val=(96, 96),
                  batch_size_trn=4, nb_steps_trn=2, nb_epochs=1,
                  epoch_callbacks=[lambda e, logs: seen.append(e)])

    trees = _tree(_recorded_in(call))
    assert seen == [0]
    assert trees == [{
        (None, "fit"): 1,
        **_under("fit", {"fit.summaries": 1, "fit.setup": 1,
                         "fit.prefetch_wait": 2, "fit.step": 2,
                         "fit.metrics_sync": 1, "fit.validate": 1,
                         "fit.log": 1, "fit.checkpoint": 1,
                         "fit.callbacks": 1}),
        **_under("fit.validate", {"fit.validate.forward": 1,
                                  "fit.validate.score": 1})}]


def test_fit_profile_dir_trace_shows_the_phases(tmp_path):
    S, M = _summaries(1)
    model = UNet2DSummary(
        cpdir=str(tmp_path), device="cpu", dataset_name_func=lambda n: n,
        series_summary_func=S.__getitem__, mask_summary_func=M.__getitem__,
        net_func=functools.partial(unet2d.UNet2DS, nfb=4, drp=0.0))
    model.fit(list(S), shape_trn=(32, 32), shape_val=(96, 96),
              batch_size_trn=4, nb_steps_trn=2, nb_epochs=1,
              profile_dir=str(tmp_path / "prof"))
    (name,) = [f for f in os.listdir(tmp_path / "prof")
               if f.endswith(".pt.trace.json")]
    with open(tmp_path / "prof" / name) as fp:
        names = {e.get("name") for e in json.load(fp)["traceEvents"]}
    assert {"fit.prefetch_wait", "fit.step"} <= names


def test_spike_predict_span_tree(tmp_path):
    params, state = unet1d.to_jax_params(
        unet1d.UNet1D(4, generator=torch.Generator().manual_seed(0)))
    ckpt = str(tmp_path / "m1d.ckpt")
    save_checkpoint(ckpt, params, state)
    rng = np.random.default_rng(0)
    traces = {"a": rng.normal(size=(5, 100)).astype(np.float32),
              "b": rng.normal(size=(3, 150)).astype(np.float32)}
    model = UNet1DSegmentation(
        cpdir=str(tmp_path), device="cpu",
        dataset_attrs_func=lambda n: {"name": n},
        dataset_traces_func=traces.__getitem__,
        dataset_spikes_func=lambda n: None)
    out = {}

    def call():
        out["masks"], out["names"] = model.predict(list(traces), ckpt,
                                                   batch=2)

    trees = _tree(_recorded_in(call))
    per_dataset = {"predict.traces": 2, "predict.upload": 2,
                   "predict.forward": 2, "predict.fetch": 2}
    assert trees == [{
        (None, "predict"): 1,
        **_under("predict", {"predict.ckpt_read": 1, "predict.build": 1,
                             **per_dataset}),
        **_under("predict.build", NET_BUILD)}]
    assert out["names"] == ["a", "b"]
    assert [m.shape for m in out["masks"]] == [(5, 100), (3, 150)]
