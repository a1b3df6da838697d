"""Run one cell of the card benchmark of ``deepcalcium_torch`` once.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It sets up the cell (inputs and weights from
the seed, the wrapper, a warm-up of every shape the cell uses), measures
for ``--seconds``, compares what the timed path produced with the plain
reference, and prints one JSON line last on standard output. With
``--trace 0`` its metrics are the cell's end-to-end metrics; with
``--trace 1`` the window runs under ``torch.profiler`` and its metrics are
the cell's per-layer metrics. It exits with another code than 0, and
prints no result, without a CUDA card, or if JAX or the JAX package was
loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from cardbench.harness import env

    env.prepare()
    import torch

    from cardbench.harness.cell import Bench, run

    bench = Bench(env.ROOT / "BENCHMARK.json")
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: the cell needs {chips} CUDA card(s); this "
              f"process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import deepcalcium_torch  # noqa: F401  (fails outside a checkout)

    result, entry = run(bench, args.workload, args.seed % 2**32, args.seconds,
                    bool(args.trace), "cuda", T_START)
    bad = env.forbidden_loaded()
    if bad:
        print(f"cardbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print("counts " + json.dumps({k: v for k, v in entry.counts.items()
                                  if not isinstance(v, list)}),
          file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
