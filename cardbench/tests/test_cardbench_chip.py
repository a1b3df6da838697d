"""On the card, at the cells' own sizes: the fp8 control (the reference in
the next precision below bf16, put in the package's place) fails one of
each cell's compared numbers on three seeds, and so does the half-batch
fault of the training cell, while the package passes them all. Run on a
machine with a card:

    python -m pytest cardbench/tests/test_cardbench_chip.py -q
"""

import json
import time

import pytest
import torch

from cardbench.harness import env

CELLS = [w["name"] for w in json.loads(
    (env.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = [101, 102, 103]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env.prepare()


def _fails(numbers, limits):
    """Whether one of the compared numbers (those with a limit) fails;
    a control or fault reads no sampling gap, its windows being the
    reference's own."""
    return any(numbers[k] > v for k, v in limits.items() if k in numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_the_package_passes(card, cell, seed):
    from cardbench.harness.cell import Bench, run

    bench = Bench(env.ROOT / "BENCHMARK.json")
    limits = bench.limits(cell)
    # A training cell's readings need no window: its fit ends after the
    # steps the comparison observes.
    result, entry = run(bench, cell, seed, 3.0, False, "cuda",
                        time.perf_counter(),
                        patch=lambda e: setattr(e, "quick", True))
    assert result["correct"], result["compared"]
    assert _fails(entry.control(), limits)
    if hasattr(entry, "half_batch"):
        assert _fails(entry.half_batch(), limits)
