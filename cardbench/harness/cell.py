"""One run of one cell: set-up, the measured window (traced or not), the
comparison with the reference, and the result line's fields. Everything a
cell is, is found by name: its configuration in ``configs/``, its traffic
in ``traffic/``, the limits of its compared numbers in ``limits/``, its
per-layer metrics' readers in ``metrics/``."""

import gc
import importlib.util
import json
import time
from pathlib import Path

import torch

from cardbench.harness import entries, yardstick
from cardbench.harness.trace import Spans, Trace, profiled

HERE = Path(__file__).resolve().parents[1]


def load_json(path):
    with open(path) as fp:
        return json.load(fp)


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, path):
        self.spec = load_json(path)
        self.root = Path(path).resolve().parent

    def workload(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    @staticmethod
    def traffic(name):
        return load_json(HERE / "traffic" / f"{name}.json")

    @staticmethod
    def limits(workload):
        return load_json(HERE / "limits" / f"{workload}.json")

    def metrics(self, kind, workload):
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or workload in m["workloads"]]


def read_metric(name, ctx):
    """The reader ``metrics/<name>.py``'s ``read(ctx)``: a number, or None
    where it finds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cardbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


class Context:
    """What a per-layer metric's reader reads."""

    def __init__(self, workload, config, traffic, counts, trace, spans):
        self.workload, self.config, self.traffic = workload, config, traffic
        self.counts, self.trace, self.spans = counts, trace, spans
        self.yard = yardstick


def run(bench, workload_name, seed, seconds, traced, device, t_start,
        patch=None):
    """One run of a cell: (the result line's dict, its last key
    ``compared``; the cell's entry, whose ``numbers`` hold every number
    the comparison worked out). ``patch(entry)``, called before set-up,
    lets the tests break the timed path underneath."""
    w = bench.workload(workload_name)
    config = bench.config(w["config"])
    traffic = bench.traffic(w["traffic"])
    limits = bench.limits(workload_name)
    Entry = entries.load(traffic["entry"])
    entry = Entry(config, traffic, seed, device, seconds)
    if patch is not None:
        patch(entry)
    on_card = torch.device(device).type == "cuda"
    entry.setup()
    if on_card:
        torch.cuda.synchronize()
        # The peak of the window: the inputs set-up made stay counted, the
        # set-up's own scratch (the reference's calibration forward) not.
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    spans = Spans()
    with profiled(traced, on_card) as held:
        t0 = time.time_ns()
        readings = entry.window(seconds, spans)
        if on_card:
            torch.cuda.synchronize()
        t1 = time.time_ns()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    trace = Trace.from_profiler(held.prof, t0, t1) if traced else None
    del held

    entry.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    entry.limits = limits
    entry.numbers = entry.compare()
    checks = {k: {"value": float(entry.numbers[k]), "limit": float(v)}
              for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    readings["setup_s"] = setup_s
    if not traced:
        metrics = {}
        for m in bench.metrics("end_to_end", workload_name):
            if m["name"] not in readings:
                raise KeyError(f"cell {workload_name} reports no "
                               f"{m['name']}")
            metrics[m["name"]] = {"value": float(readings[m["name"]]),
                                  "unit": m["unit"]}
    else:
        ctx = Context(w, config, traffic, entry.counts, trace, spans)
        metrics = {}
        for m in bench.metrics("per_layer", workload_name):
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name() if on_card
                            else "cpu"),
                   "count": 1 if on_card else 0,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(entry.counts.get(
        "attempted", entry.counts.get("calls", 0))), "failed": 0,
        "metrics": metrics, "device": device_info}
    if traced:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_by_span(spans)}
    result["compared"] = checks
    return result, entry
