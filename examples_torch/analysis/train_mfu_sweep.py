"""Training throughput against the batch, and the cost of dropout, on the
card.

Counterpart of ``examples/analysis/train_mfu_sweep.py``:

1. batch 20 -> 32 -> 64 -> 128 at a fixed 128x128 window, nfb=32, bf16,
   the net's default dropout: larger batches spread the per-step fixed
   costs;
2. the drp=0 row at batch 64: the upper bound of what the dropout draw and
   mask cost.

Each point is ``benchtools.train_step_time(k=K)``: the production step, K
steps a ``make_multi_step`` dispatch (one CUDA graph on the card), K=4 by
default as ``preset="perf"`` and ``chip_smoke.py::phase_multistep`` take
it; CUDA events, with the kernel time and idle share from
``torch.profiler``. TFLOP/s counts the JAX script's
``3 * batch * forward_flops(win, win, nfb)`` against the dense bf16 peak of
``benchtools.PEAK_CARD``.

Not ported: the PRNG ablation (threefry against rbg) and the BN-stats
dtype ablation (``blocks.BN_STATS_F32``): the rbg PRNG and that knob are
TPU experiments that the port does not carry ("Not to port" in
``ROADMAP.md``).

Usage: python examples_torch/analysis/train_mfu_sweep.py [--k 4]
           [--win 128] [--batches 20 32 64 128] [--device {cuda,cpu}]
"""

import argparse
import sys

sys.path.append(".")

import torch


def report(tag, r, batch, win, nfb, on_card):
    """Print one point and return it as a row."""
    from deepcalcium_torch.models.unet2d import forward_flops
    from deepcalcium_torch.utils.benchtools import BF16_FLOPS_PER_S

    flops = 3 * batch * forward_flops(win, win, nfb)
    tflops = flops / r["step_ms"] / 1e9
    row = {"row": tag, "batch": batch, "win": win, "step_ms": r["step_ms"],
           "windows_per_s": batch / r["step_ms"] * 1e3, "tflops": tflops,
           "peak_share": tflops * 1e12 / BF16_FLOPS_PER_S if on_card else None,
           "device_ms": r["device_ms"], "kernels": r["kernels"],
           "idle": r["idle"]}
    line = (f"{tag:28s} {r['step_ms']:8.3f} ms/step {row['windows_per_s']:8.1f}"
            f" win/s {tflops:6.2f} TFLOP/s")
    if on_card:
        line += (f" = {row['peak_share']:6.2%} of the bf16 peak; "
                 f"{r['device_ms']:.3f} device ms, {r['kernels']:.0f} "
                 f"kernels a step, idle {r['idle']:.1%}")
    print(line, flush=True)
    return row


def main(argv=None):
    """Print and return ``{"card", "rows"}``, a row a point."""
    from deepcalcium_torch.utils.benchtools import card, train_step_time

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=4,
                    help="steps a dispatch (one CUDA graph on the card)")
    ap.add_argument("--win", type=int, default=128)
    ap.add_argument("--batches", type=int, nargs="*",
                    default=[20, 32, 64, 128])
    ap.add_argument("--drp0-batch", type=int, default=64,
                    help="batch of the drp=0 row")
    ap.add_argument("--nfb", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5,
                    help="dispatches timed a point")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the default fails without a CUDA card")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from deepcalcium_torch.utils.device import require_cuda

        device = require_cuda()
    else:
        device = torch.device("cpu")
    on_card = device.type == "cuda"
    kw = dict(k=args.k, nfb=args.nfb, device=device, iters=args.iters)

    where = card(device)
    print(f"# train_mfu_sweep (UNet2DS nfb {args.nfb} bf16, K={args.k} "
          f"steps a dispatch) on {where}", flush=True)
    print(f"== batch scaling (default dropout 0.25, win {args.win}) ==",
          flush=True)
    rows = [report(f"batch {b} win {args.win}",
                   train_step_time(b, args.win, **kw), b, args.win,
                   args.nfb, on_card)
            for b in args.batches]
    print(f"== dropout off (drp=0, batch {args.drp0_batch}): the upper bound "
          f"of the draw and the mask ==", flush=True)
    b = args.drp0_batch
    rows.append(report(f"drp=0 batch {b}",
                       train_step_time(b, args.win, drp=0.0, **kw), b,
                       args.win, args.nfb, on_card))
    return {"card": where, "rows": rows}


if __name__ == "__main__":
    main()
