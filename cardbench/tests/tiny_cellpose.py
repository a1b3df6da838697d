"""The Cellpose-SAM cell at a size the CPU runs in seconds, beside
``tiny.py``: the configuration at width 64, 4 blocks (two with 27-entry
tables, two with 127-entry ones), 4 heads, a patch of 4 on 32 x 32 tiles,
float32; the pool cut to three 64 x 64 movies. Nothing here is a number
of the card."""

import copy
import time

from cardbench.harness import env
from cardbench.harness.cell import Bench, run

TINY_CONFIG = {"width": 64, "depth": 4, "heads": 4, "head_dim": 16,
               "mlp_dim": 256, "patch": 4, "tile": 32, "grid": 8,
               "neck_dim": 128, "global_blocks": [1, 3],
               "compute_dtype": "float32"}
TINY_TRAFFIC = {"frame": [64, 64], "lengths": [5, 7, 9],
                "neurons": [8, 10, 12]}
CELL = "cpsam-evaluate-card"
# The tiny net runs in float32 on both sides, where the card's runs in
# bfloat16: its flows agree with the reference's to about 1e-5, and the
# card's flow limit holds (without the bias they move by 0.87-1.46, seeds
# 7, 8, 11, 12). Its labels agree exactly (0 pixels: the same Euler steps
# on the same device), and half the steps move 5-25 pixels of seeds 7, 8
# and 11, under the card's label limit: the tiny bench has its own.
TINY_LIMITS = {"labels_gap": 2}
# The tiny net's flows carry every pixel of a 64 x 64 frame to its sink
# within 50 Euler steps, where the card's leave 145-371 pixels elsewhere
# after 100 steps than after 200: the tiny bench runs 20 steps, so that
# the fault of half the steps changes labels here too.
TINY_NITER = 20


class TinyCellposeBench(Bench):
    def __init__(self):
        super().__init__(env.ROOT / "BENCHMARK.json")

    def config(self, name):
        cfg = copy.deepcopy(super().config(name))
        cfg.update(TINY_CONFIG)
        cfg["eval"]["niter"] = TINY_NITER
        return cfg

    @staticmethod
    def limits(workload):
        return {**Bench.limits(workload), **TINY_LIMITS}

    @staticmethod
    def traffic(name):
        tr = copy.deepcopy(Bench.traffic(name))
        tr.update(TINY_TRAFFIC)
        return tr


def run_tiny(seed=7, seconds=0.5, traced=False, patch=None):
    env.prepare()
    return run(TinyCellposeBench(), CELL, seed, seconds, traced, "cpu",
               time.perf_counter(), patch=patch)
