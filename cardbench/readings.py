"""Readings that set the limits of ``correct``: for each seed, one run of
the cell with a short window (the program's numbers), the reference in
fp8 put in the program's place (the control's numbers) and, for a
training cell, the reference with half of each batch left out of the loss
(a fault's numbers). One process serves every seed, so set-up is paid
once.

    python3 cardbench/readings.py --workload <name> --seeds 1,2,3 \
        --seconds 5 [--out readings.jsonl]

It prints one JSON line a seed. The benchmark's own runs never run this."""

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
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--quick", type=int, default=1,
                   help="training cells: no warm fit, and the fit ends "
                        "after the observed steps")
    args = p.parse_args(argv)

    from cardbench.harness import env

    env.prepare()
    import torch

    from cardbench.harness.cell import Bench, run

    bench = Bench(env.ROOT / "BENCHMARK.json")
    out = open(args.out, "a") if args.out else None
    for s in args.seeds.split(","):
        seed = int(s) % 2**32
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        result, entry = run(bench, args.workload, seed, args.seconds,
                            bool(args.trace), "cuda", t0,
                            patch=lambda e: setattr(e, "quick", args.quick))
        line = {"workload": args.workload, "seed": int(s),
                "program": entry.numbers,
                "metrics": {k: m["value"] for k, m in
                            result["metrics"].items()},
                "device": result["device"]}
        leaves = {"program": getattr(entry, "leaves", None)}
        line["control"] = entry.control()
        leaves["control"] = getattr(entry, "leaves", None)
        if hasattr(entry, "half_batch"):
            line["half_batch"] = entry.half_batch()
            leaves["half_batch"] = getattr(entry, "leaves", None)
        if leaves["program"] is not None:
            line["leaves"] = leaves
        if "breakdown" in result:
            line["breakdown"] = result["breakdown"]
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del entry, result
        import gc

        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
