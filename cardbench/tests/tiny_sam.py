"""The Segment Anything cell at a size the CPU runs in seconds, beside
``tiny_cellpose.py``: width 32, 3 blocks (one global over a 10 x 10 grid,
two in 4 x 4 windows of the grid padded to 12 x 12), 2 heads, a patch of 4
on 40 x 40 images, a decoder of width 32 with 2 heads, a 4 x 4 grid of
prompts in batches of 8, float32; the pool cut to three 48 x 48 movies.
Nothing here is a number of the card."""

import copy
import time

from cardbench.harness import env
from cardbench.harness.cell import Bench, run

TINY_CONFIG = {"width": 32, "depth": 3, "heads": 2, "head_dim": 16,
               "mlp_dim": 64, "patch": 4, "image_size": 40, "grid": 10,
               "neck_dim": 128, "global_blocks": [1], "window_size": 4,
               "rel_pos_window": 7, "rel_pos_global": 19,
               "decoder_heads": 2, "decoder_mlp_dim": 64,
               "iou_head_hidden": 32, "compute_dtype": "float32"}
TINY_AMG = {"points_per_side": 4, "points_per_batch": 8}
# A mask of the card's median share (0.2%) would be a few pixels of a 48 x
# 48 frame, with boxes of no area, which NMS keeps whatever its threshold.
TINY_COVERAGE = 0.05
TINY_TRAFFIC = {"frame": [48, 48], "lengths": [5, 7, 9],
                "neurons": [6, 8, 10]}
CELL = "sam-amg-evaluate-card"


class TinySamBench(Bench):
    def __init__(self):
        super().__init__(env.ROOT / "BENCHMARK.json")

    def config(self, name):
        cfg = copy.deepcopy(super().config(name))
        cfg.update(TINY_CONFIG)
        cfg["amg"].update(TINY_AMG)
        cfg["calibration"]["coverage"] = TINY_COVERAGE
        return cfg

    @staticmethod
    def traffic(name):
        tr = copy.deepcopy(Bench.traffic(name))
        tr.update(TINY_TRAFFIC)
        return tr


def run_tiny(seed=7, seconds=0.5, traced=False, patch=None):
    env.prepare()
    return run(TinySamBench(), CELL, seed, seconds, traced, "cpu",
               time.perf_counter(), patch=patch)
