"""Attribute the device time of one production train dispatch by kind of
work.

Counterpart of ``examples/analysis/train_step_profile.py``. Profiles one
``make_multi_step(nsteps=k)`` dispatch of either net (on the card one CUDA
graph of K steps) with ``torch.profiler`` on the CUDA activity only
(``benchtools.kernel_table``), and sorts each kernel into the JAX
script's buckets by its name (:data:`BUCKETS`): conv / dropout-rng / bn /
pool / copy-reshape / other. Prints the ms a step and the share of each
bucket, then the top name prefixes and kernels, in the JAX script's CSV
columns (``what,name,ms_per_step,count,pct_of_device``).

The nets, batches and optimizer are those of ``benchtools.train_step_time``
and ``train1d_step_time``: the seed-0 net at nfb=32 and bf16 with its
default dropout, K batches of ``np.random.default_rng(0)``. The JAX
script's ``--prng`` (the rbg PRNG) and ``--fused-dropout`` are not ported:
dropout draws from torch's Philox stream. On the CPU the rows are the
operators' self time on the host.

Usage: python examples_torch/analysis/train_step_profile.py
           [--net unet2d|unet1d] [--batch 20] [--win 128 (4096 for unet1d)]
           [--k 8] [--csv out.csv] [--top 40] [--device {cuda,cpu}]
"""

import argparse
import collections
import re
import sys

sys.path.append(".")

import torch

# (bucket, pattern) in the order tried; the first match wins. The patterns
# read CUDA kernel names and, on the CPU, operator names. Layout copies
# come first: cuDNN's own transposes (cudnn::...nchwToNhwcKernel) would
# read as conv work. "bn" holds every reduction kernel of the step: the
# hand-written BN's var_mean (Welford) and the sums of its backward, which
# are most of them, and the bias gradients' and the loss's sums.
BUCKETS = [
    ("copy-reshape", re.compile(
        r"nchwToNhwc|nhwcToNchw|copy|transpose|permute|CatArray|aten::cat|"
        r"Memcpy|Memset|index", re.I)),
    ("dropout-rng", re.compile(
        r"distribution|uniform|bernoulli|philox|dropout|aten::rand", re.I)),
    ("pool", re.compile(r"max_pool|pool", re.I)),
    ("conv", re.compile(
        r"conv(?!ert)|xmma|implicit_gemm|cutlass|wgrad|dgrad|fprop|gemm|"
        r"winograd|cudnn", re.I)),
    ("bn", re.compile(
        r"Welford|var_mean|batch_norm|reduce_kernel|aten::sum|aten::mean",
        re.I)),
]


def bucket_of(name):
    """The bucket of a kernel (or, on the CPU, an operator) by its name."""
    for bucket, pattern in BUCKETS:
        if pattern.search(name):
            return bucket
    return "other"


def prefix_of(name):
    """A kernel's name without its template and call arguments (and
    without ``(anonymous namespace)::``, whose parenthesis would end it)."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def build_dispatch(net, batch, win, k, nfb=32, device="cuda"):
    """``run()``: one dispatch of K production train steps of ``net``
    ("unet2d" or "unet1d"), as ``benchtools`` sets it up."""
    from deepcalcium_torch.utils import benchtools as bt

    if net == "unet1d":
        run, _, _ = bt.train1d_step_setup(batch, win, k, nfb, 2e-3, 4, None,
                                           torch.bfloat16, device)
    else:
        run, _, _ = bt.train_step_setup(batch, win, k, nfb, 2e-3,
                                         "binary_crossentropy", None,
                                         torch.bfloat16, device)
    return run


COLUMNS = ("what", "name", "ms_per_step", "count", "pct_of_device")


def aggregate(kernels, k):
    """Rows (dicts of :data:`COLUMNS`, the JAX script's CSV columns) of a
    ``kernel_table`` of one K-step dispatch: the buckets, then the name
    prefixes above 0.5% of the device time, then every kernel, the most
    time first."""
    total = sum(ms for _, ms, _ in kernels) or 1.0
    buckets = collections.defaultdict(float)
    prefixes = collections.defaultdict(float)
    for name, ms, _ in kernels:
        buckets[bucket_of(name)] += ms
        prefixes[prefix_of(name)] += ms
    rows = [("bucket", b, ms / k, None, 100 * ms / total)
            for b, ms in sorted(buckets.items(), key=lambda kv: -kv[1])]
    rows += [("prefix", p, ms / k, None, 100 * ms / total)
             for p, ms in sorted(prefixes.items(), key=lambda kv: -kv[1])
             if ms / total >= 0.005]
    rows += [("op", name, ms / k, n / k, 100 * ms / total)
             for name, ms, n in kernels]
    return [dict(zip(COLUMNS, r)) for r in rows]


def main(argv=None):
    """Print and return ``{"card", "step_ms", "device_ms", "rows"}`` (rows
    as :func:`aggregate`; ``--top`` bounds the printed kernels only)."""
    from deepcalcium_torch.utils.benchtools import (card, kernel_table,
                                                    timed_ms)

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--net", default="unet2d", choices=["unet2d", "unet1d"])
    ap.add_argument("--batch", type=int, default=20)
    ap.add_argument("--win", type=int, default=None,
                    help="window: 128 for unet2d, 4096 samples for unet1d")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--nfb", type=int, default=32)
    ap.add_argument("--csv", default="")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the default fails without a CUDA card")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from deepcalcium_torch.utils.device import require_cuda

        device = require_cuda()
    else:
        device = torch.device("cpu")
    win = args.win or (4096 if args.net == "unet1d" else 128)

    run = build_dispatch(args.net, args.batch, win, args.k, args.nfb, device)
    run()  # on a card: the capture
    step_ms = timed_ms(run, 3, device) / args.k
    kernels = kernel_table(run, 1, device=device)
    device_ms = sum(ms for _, ms, _ in kernels) / args.k
    rows = aggregate(kernels, args.k)
    where = card(device)
    shape = f"{win}^2" if args.net == "unet2d" else f"x {win}"
    print(f"# train_step_profile: {args.net} nfb {args.nfb} bf16, batch "
          f"{args.batch} {shape}, one dispatch of {args.k} steps on {where}: "
          f"{step_ms:.3f} ms a step, of which {device_ms:.3f} ms in "
          f"{sum(n for _, _, n in kernels) / args.k:.0f} "
          f"{'kernels' if device.type == 'cuda' else 'operators'} a step",
          flush=True)
    lines = [",".join(COLUMNS)]
    ops = [r for r in rows if r["what"] == "op"]
    for r in [r for r in rows if r["what"] != "op"] + ops[:args.top]:
        cnt = "" if r["count"] is None else f"{r['count']:g}"
        lines.append(f"{r['what']},{r['name'].replace(',', ';')},"
                     f"{r['ms_per_step']:.4f},{cnt},{r['pct_of_device']:.1f}")
    print("\n".join(lines), flush=True)
    if args.csv:
        with open(args.csv, "w") as fp:
            fp.write("\n".join(lines) + "\n")
    return {"card": where, "step_ms": step_ms, "device_ms": device_ms,
            "rows": rows}


if __name__ == "__main__":
    main()
