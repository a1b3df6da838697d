"""``BENCHMARK.json`` against the benchmark's contract, the files it names,
the frozen yardstick, and what the benchmark's modules import."""

import ast
import json
import re
import subprocess
import sys

import pytest

from cardbench.harness import env, yardstick
from cardbench.harness.cell import Bench

ROOT = env.ROOT
HERE = ROOT / "cardbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "cardbench/run.py"]
    assert SPEC["paths"] == ["cardbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_configs():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cardbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == [] == cfg["reduced"]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads_find_their_files():
    bench = Bench(ROOT / "BENCHMARK.json")
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        bench.config(w["config"])
        tr = bench.traffic(w["traffic"])
        assert (HERE / "harness" / "entries" / f"{tr['entry']}.py").exists()
        limits = bench.limits(w["name"])
        assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("path", sorted((HERE / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_traffic_has_its_entry_and_limits(path):
    """Also a mix no cell lists yet: a later cell adds data only."""
    tr = json.loads(path.read_text())
    assert (HERE / "harness" / "entries" / f"{tr['entry']}.py").exists()
    assert (HERE / "limits" / f"{path.stem}.json").exists()
    assert _line(tr["why"])


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = [n for n, m in e2e.items()
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(cell in m["workloads"] for m in SPEC["per_layer"]), cell
    for m in SPEC["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_frozen_flops():
    cfg2 = Bench(ROOT / "BENCHMARK.json").config("unet2ds-nfb32")
    cfg1 = Bench(ROOT / "BENCHMARK.json").config("unet1d-nfb32")
    assert round(8 * yardstick.forward_flops(cfg2, 512, 512) / 1e9, 2) == 770.28
    assert round(yardstick.forward_flops(cfg2, 128, 128) / 1e9, 3) == 6.018
    assert round(yardstick.forward_flops(cfg1, 4096) / 1e9, 3) == 4.448


def test_frozen_flops_match_the_package():
    from deepcalcium_torch.models import unet1d, unet2d

    cfg2 = Bench(ROOT / "BENCHMARK.json").config("unet2ds-nfb32")
    cfg1 = Bench(ROOT / "BENCHMARK.json").config("unet1d-nfb32")
    assert yardstick.forward_flops(cfg2, 512, 512) == unet2d.forward_flops(512, 512)
    assert yardstick.forward_flops(cfg1, 4096) == unet1d.forward_flops(4096)
    assert cfg2["params"] == unet2d.param_count(unet2d.UNet2DS(32))
    assert cfg1["params"] == unet1d.param_count(unet1d.UNet1D(32))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & set(env.FORBIDDEN), path
    text = path.read_text()
    assert "chip_smoke" not in {n.split(".")[0] for n in _imports(path)}
    for old in ("BASELINE" + ".json", "BENCH_r" + "0", "bench" + ".py"):
        assert old not in text, (path, old)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    allowed = {"torch", "numpy", "itertools", "math", "contextlib",
               "cardbench"}
    for name in _imports(path):
        top = name.split(".", 1)[0]
        assert top in allowed, (path.name, name)
        if top == "cardbench":
            assert name.startswith("cardbench.reference"), (path.name, name)


def test_no_card_no_result(tmp_path):
    """Outside a checkout (only BENCHMARK.json and cardbench/), or without
    a card, a run exits with another code than 0 and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", "nf-evaluate-card",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
