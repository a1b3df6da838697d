"""``PARITY_TORCH.md`` against the repository: every file, function, test
and ``chip_smoke.py`` phase it names exists; it has a line for every row of
``PARITY.md`` (1-34, every "Extra capabilities" row, every point of
"Parallelism accounting"); and it carries none of ``PARITY.md``'s figures
taken on a TPU."""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# What PARITY.md says of the JAX package's speed on a TPU.
TPU_FIGURES = ("705 GB/s", "v5e", "2.1x", "219", "227k", "28.5", "29.6",
               "2.6×", "1.21", "9.07", "20.2%", "10.65", "5.65", "6.69",
               "13.8", "11.6 ms", "11×", "MFU")


def _read(name):
    with open(os.path.join(REPO, name), encoding="utf-8") as fp:
        return fp.read()


def _rows(text, heading):
    """The cells of each row of the table under ``heading`` (up to the next
    heading), without its header and separator rows."""
    section = text.split(heading, 1)[1].split("\n## ", 1)[0]
    rows = [[c.strip() for c in line.strip().strip("|").split("|")]
            for line in section.splitlines() if line.startswith("|")]
    assert set(rows[1][0]) <= set("-: ")
    return rows[2:]


@pytest.fixture(scope="module")
def table():
    return _read("PARITY_TORCH.md")


@pytest.fixture(scope="module")
def parity():
    return _read("PARITY.md")


def _references(text):
    """(path, name or None) of every backticked ``path.ext`` or
    ``path.ext::name`` that names a file of the repository by its path."""
    refs = set()
    for token in re.findall(r"`([^`\n]+)`", text):
        m = re.fullmatch(r"([\w./-]+\.(?:py|cu|md|toml))(?:::([\w.]+))?", token)
        if m and "/" in m.group(1) or m and os.path.exists(
                os.path.join(REPO, m.group(1))):
            refs.add((m.group(1), m.group(2)))
    return sorted(refs, key=str)


def _defines(source, name):
    """Whether ``source`` defines ``name`` (``Class.method`` too) as a
    function, a class or a module-level value."""
    for part in name.split("."):
        if not re.search(rf"^\s*(?:def|class)\s+{re.escape(part)}\b"
                         rf"|^{re.escape(part)}\s*[:=]", source, re.M):
            return False
    return True


def test_every_named_file_function_and_test_exists(table):
    refs = _references(table)
    assert len(refs) > 150
    missing = []
    for path, name in refs:
        # Files of the JAX package named as not ported are given by their
        # path inside it.
        candidates = [path, os.path.join("deepcalcium_tpu", path),
                      os.path.join("examples", "analysis", path)]
        found = [c for c in candidates if os.path.exists(os.path.join(REPO, c))]
        if not found:
            missing.append(path)
        elif name and not _defines(_read(found[0]), name):
            missing.append(f"{path}::{name}")
    assert not missing, missing


def test_every_named_test_is_a_torch_test_and_every_phase_a_phase(table):
    tests = re.findall(r"`(tests/[\w.]+\.py)::(\w+)`", table)
    assert len(tests) > 100
    for path, name in tests:
        assert os.path.basename(path).startswith("test_torch_"), path
        assert name.startswith("test_"), name
    phases = set(re.findall(r"`chip_smoke\.py::(\w+)`", table))
    assert len(phases) >= 15 and all(p.startswith("phase_") for p in phases)
    smoke = _read("chip_smoke.py")
    main_body = smoke.split("def main(argv=None):", 1)[1]
    for phase in phases:
        assert f"{phase}," in main_body, f"{phase} is not run by main()"


def test_a_line_for_every_row_of_parity_md(table, parity):
    want = _rows(parity, "# PARITY")
    assert [r[0] for r in want] == [str(n) for n in range(1, 35)]
    got = _rows(table, "## Component inventory")
    assert [r[0] for r in got] == [str(n) for n in range(1, 35)]
    for row in got:
        assert "`deepcalcium_torch/" in row[2] or "`examples_torch/" in row[2] \
            or "`pyproject.toml`" in row[2], row[0]
        assert "`tests/test_torch_" in row[3], row[0]

    extras = _rows(parity, "## Extra capabilities")
    got = _rows(table, "## Extra capabilities")
    assert len(extras) == 29
    assert [r[0] for r in got] == [f"E{n}" for n in range(1, len(extras) + 1)]
    for row in got:
        ported = "`deepcalcium_torch/" in row[2] or "`tests/" in row[2]
        assert ported or (row[2] == "none" and "**not ported**" in row[4]), row[0]
        held = row[3] + row[4]
        assert "`tests/test_torch_" in held or "`chip_smoke.py::" in held, row[0]

    points = re.findall(r"^- \*\*(.+?)\*\*", parity.split(
        "## Parallelism accounting", 1)[1], re.M)
    got = _rows(table, "## Parallelism accounting")
    assert [r[1] for r in got] == points and len(points) == 5
    assert [r[0] for r in got] == [f"P{n}" for n in range(1, 6)]


def test_what_is_not_ported_gives_its_reason(table):
    """The decided list of ROADMAP.md, each with a reason beside it."""
    for name in ("apply_fast_w", "apply_fast_t", "apply_fast_w_train",
                 "make_multi_step", "rbg", "_up_dilated", "DROPOUT_REMAT_BWD",
                 "DROPOUT_FUSED_DRAW", "BN_STATS_F32", "tpu_microbench.py",
                 "auto_backend", "_wait_for_device", "slope_timing.py",
                 "enable_compile_cache"):
        assert name in table, name
    # The part of benchtools.py that stays unported, with its reason.
    assert re.search(r"\*\*not ported\*\*: `enable_compile_cache`[^|]*"
                     r"no XLA cache on the card", table)
    assert table.count("**not ported**") >= 9
    analysis = os.path.join(REPO, "examples", "analysis")
    ported = {"activation_maps.py", "dataset_stats.py", "spike_stats.py",
              "hyperparam_marginals.py", "evaluator_stage_bench.py",
              "unet_layer_bench.py", "unet1d_roofline.py",
              "train_step_profile.py", "train_mfu_sweep.py"}
    for name in sorted(os.listdir(analysis)):
        if name.endswith(".py") and name != "__init__.py":
            assert f"{name}" in table, name
            if name not in ported:
                assert not os.path.exists(os.path.join(
                    REPO, "examples_torch", "analysis", name)), name


def test_no_tpu_figure_is_carried_over(table, parity):
    for figure in TPU_FIGURES:
        assert figure not in table, figure
    # The check has teeth: PARITY.md does carry them.
    assert all(f in parity for f in ("705 GB/s", "9.07", "5.65", "13.8"))
    # The port's own numbers name their card.
    for line in table.splitlines():
        if re.search(r"\d ms|frames/s|views/s", line):
            assert "NVIDIA H100 80GB HBM3, 700 W" in line, line[:80]
