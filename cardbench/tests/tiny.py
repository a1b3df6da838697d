"""A benchmark of the same cells at a size the CPU runs in seconds: the
configurations at nfb=4 and every traffic cut to a few small inputs. The
measured package runs its CPU paths and the reference its float32 ones;
nothing here is a number of the card."""

import copy
import time

from cardbench.harness import env
from cardbench.harness.cell import Bench, run

TINY_TRAFFIC = {
    "nf-evaluate-card": {"frame": [32, 32], "window": [32, 32],
                         "lengths": [5, 7, 9], "neurons": [3, 4, 5]},
    "nf-fit": {"frame": [64, 64], "neurons": [4, 5, 6], "frames": 50,
               "train_window": [32, 32], "val_window": [64, 64],
               "batch": 4, "steps": 4, "epoch_s": 1.0},
    "spikes-fit": {"traces": 20, "length": 300, "window": 64, "batch": 4,
                   "epoch_s": 1.0},
    "spikes-predict": {"pool": 2, "traces": 16, "length": 4011, "batch": 4},
}


# Cells whose files the benchmark keeps but ``BENCHMARK.json`` does not
# list (PERF.md says why), rehearsed all the same.
UNLISTED = {"spikes-fit": "unet1d-nfb32"}


class TinyBench(Bench):
    def __init__(self):
        super().__init__(env.ROOT / "BENCHMARK.json")

    def workload(self, name):
        if name in UNLISTED:
            return {"name": name, "config": UNLISTED[name], "traffic": name,
                    "chips": 1}
        return super().workload(name)

    def config(self, name):
        cfg = copy.deepcopy(super().config(name))
        cfg["nfb"] = 4
        cfg["compute_dtype"] = "float32"
        return cfg

    @staticmethod
    def traffic(name):
        tr = copy.deepcopy(Bench.traffic(name))
        tr.update(TINY_TRAFFIC[name])
        return tr


def run_tiny(workload, seed=7, seconds=0.5, traced=False, patch=None):
    env.prepare()
    return run(TinyBench(), workload, seed, seconds, traced, "cpu",
               time.perf_counter(), patch=patch)
