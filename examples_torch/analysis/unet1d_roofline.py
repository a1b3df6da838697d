"""Per-layer roofline of the UNet1D training step on the card.

Counterpart of ``examples/analysis/unet1d_roofline.py``: host arithmetic,
no device. For every conv of ``deepcalcium_torch/models/unet1d.py`` at the
bench recipe (batch 20, T=4096, nfb=32) it prints the FLOPs, the bytes
(bf16 input and output and the kernel, once each) and a 3-pass (forward,
input gradient, weight gradient) floor of

    max(flops / 989 TFLOP/s, bytes / 3.35 TB/s) * 3

with the H100 SXM data sheet's dense bf16 and HBM3 rates
(``deepcalcium_torch.utils.benchtools``). The JAX script's ``mxu_eff``
column models the TPU's 128-lane matrix unit and is not carried over: on
the card the thin-channel rows' floor is a lower bound, with no model of
how well cuDNN fills the tensor cores at few channels.

The sum of the census's FLOPs is ``batch * unet1d.forward_flops(t, f)``,
the forward that ``chip_smoke.py`` counts a train step as three of.

Usage: python examples_torch/analysis/unet1d_roofline.py [--batch 20]
           [--t 4096] [--nfb 32] [--step-ms MS]
"""

import argparse
import sys

sys.path.append(".")


def census(batch, t, f):
    """(name, t, cin, cout, k) for every conv of the UNet1D, the JAX
    script's census (``batch`` is unused there too)."""
    layers = []
    tt, cin = t, 1
    for i, mult in enumerate([1, 2, 4, 8]):
        cout = f * mult
        layers += [(f"enc{i}a", tt, cin, cout, 5),
                   (f"enc{i}b", tt, cout, cout, 5)]
        cin = cout
        tt //= 2
    layers += [("mida", tt, cin, 16 * f, 5),
               ("midb", tt, 16 * f, 16 * f, 5)]
    cup = 16 * f
    for i, mult in zip([3, 2, 1, 0], [8, 4, 2, 1]):
        tt *= 2
        cout = f * mult
        layers += [(f"dec{i}a", tt, cup + cout, cout, 5),
                   (f"dec{i}b", tt, cout, cout, 5)]
        cup = cout
    layers.append(("head", tt, f, 2, 1))
    return layers


def main(argv=None):
    """Print and return ``{"rows", "useful_flops", "floor_ms"[,
    "step_ms"]}``, a row a conv."""
    from deepcalcium_torch.utils.benchtools import (BF16_FLOPS_PER_S,
                                                    PEAK_CARD, roofline_ms)

    pa = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    pa.add_argument("--batch", type=int, default=20)
    pa.add_argument("--t", type=int, default=4096)
    pa.add_argument("--nfb", type=int, default=32)
    pa.add_argument("--step-ms", type=float, default=None,
                    help="a measured step (ms) to hold against the floor, "
                         "e.g. chip_smoke.py's train1d_step_ms")
    args = pa.parse_args(argv)

    print(f"# unet1d_roofline (batch {args.batch} x {args.t}, nfb "
          f"{args.nfb}, bf16): host arithmetic against {PEAK_CARD}",
          flush=True)
    print(f"{'layer':8s} {'t':>5s} {'cin':>4s} {'cout':>4s} {'GFLOP':>7s} "
          f"{'MB':>8s} {'floor_ms(3p)':>12s} bound", flush=True)
    rows = []
    for name, tt, ci, co, k in census(args.batch, args.t, args.nfb):
        fl = 2 * args.batch * tt * k * ci * co
        nbytes = (args.batch * tt * (ci + co) + k * ci * co) * 2
        ms, bound = roofline_ms(fl, nbytes)
        rows.append({"layer": name, "t": tt, "cin": ci, "cout": co,
                     "flops": fl, "bytes": nbytes, "floor_ms": 3 * ms,
                     "bound": bound})
        print(f"{name:8s} {tt:5d} {ci:4d} {co:4d} {fl / 1e9:7.2f} "
              f"{nbytes / 1e6:8.3f} {3 * ms:12.5f} {bound}", flush=True)
    useful = 3 * sum(r["flops"] for r in rows)
    floor = sum(r["floor_ms"] for r in rows)
    ideal = useful / BF16_FLOPS_PER_S * 1e3
    out = {"rows": rows, "useful_flops": useful, "floor_ms": floor}
    print(f"\nuseful 3x-forward FLOPs a step: {useful / 1e9:.1f} G", flush=True)
    print(f"conv floor: {floor:.4f} ms (all at the bf16 peak: {ideal:.4f} "
          f"ms; the byte-bound rows add {floor - ideal:.4f} ms)", flush=True)
    if args.step_ms:
        out["step_ms"] = args.step_ms
        print(f"measured {args.step_ms:.3f} ms a step -> "
              f"{args.step_ms / floor:.2f}x the conv floor; "
              f"{useful / (args.step_ms * 1e-3) / 1e12:.1f} TFLOP/s = "
              f"{useful / (args.step_ms * 1e-3) / BF16_FLOPS_PER_S:.2%} of "
              f"the bf16 peak", flush=True)
    return out


if __name__ == "__main__":
    main()
