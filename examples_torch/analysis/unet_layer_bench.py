"""Per-block roofline of the UNet2DS 8-view TTA evaluate forward on the card.

Counterpart of ``examples/analysis/unet_layer_bench.py``. Times every
distinct conv, transpose-conv and pool block of the (8, 512, 512) TTA
batch alone (nfb=32, bf16), then kernel K1 on the 3000x512x512 int16
movie and the FULL ``make_movie_evaluator``, and holds each block against
its roofline on the card:

    t_roofline = max(flops / 989 TFLOP/s, bytes / 3.35 TB/s)

(the H100 SXM data sheet's dense bf16 and HBM3 rates,
``deepcalcium_torch.utils.benchtools``). Bytes count the bf16 input and
output once each, as the JAX script counts them.

The census has the JAX script's 21 rows, names, order, FLOP and byte counts
(shapes in NCHW); the kernels are drawn from ``np.random.default_rng(0)`` in
its order, so the two scripts time the same weights. The JAX script's
``lane_util`` models the 128-lane matrix unit of a TPU v5e and is not
carried over: on the card a thin-channel row's roofline is a lower bound,
with no model of how well cuDNN fills the tensor cores at few channels.

Forms:
- default: the parity form of each block (``blocks.conv2d`` ->
  inference ``blocks.batch_norm`` -> ReLU; ``tconv2x2`` and ``maxpool2``
  alone, as in the JAX census), then the K1 row and a FULL evaluate row
  with the unfolded net;
- ``--fast``: the form the port runs at inference (``UNet2DS.fold()``, what
  ``evaluate_movie(fast="auto")`` runs): each conv with its BN folded into
  weights and bias (``blocks.fold_bn``), then ReLU; the census's transpose
  convs carry no BN, so they and the pools are the same calls; then a
  FULL evaluate row with the folded net. (The folded net's up blocks add a
  ReLU pass after the transpose conv, which neither census row times.)

Usage: python examples_torch/analysis/unet_layer_bench.py [--fast]
           [--csv out.csv] [--iters 20] [--device {cuda,cpu}]
"""

import argparse
import sys

sys.path.append(".")

import numpy as np
import torch

FRAMES, SIZE, BATCH, NFB = 3000, 512, 8, 32


def census(batch=BATCH, size=SIZE, nfb=NFB):
    """Every distinct block of the (``batch``, ``size``, ``size``) eval
    forward at ``nfb``, as dicts: name, kind ("cbr", "tconv" or "pool"),
    x_shape (NCHW), flops, bytes, cin, cout and k. At the defaults the
    names, order, counts and couts are those of the JAX script's
    ``block_fns()``."""
    rows = []

    def cbr(name, lvl, cin, cout, k=3):
        res = size >> lvl
        rows.append(dict(
            name=f"{name} {cin}->{cout}@{res}", kind="cbr",
            x_shape=(batch, cin, res, res),
            flops=2 * k * k * cin * cout * res * res * batch,
            bytes=res * res * (cin + cout) * batch * 2,
            cin=cin, cout=cout, k=k))

    def tconv(name, lvl, cin, cout):
        res = size >> lvl
        rows.append(dict(
            name=f"{name} {cin}->{cout}@{res}", kind="tconv",
            x_shape=(batch, cin, res, res),
            flops=2 * 4 * cin * cout * res * res * batch,
            bytes=(res * res * cin + 4 * res * res * cout) * batch * 2,
            cin=cin, cout=cout, k=2))

    def pool(name, lvl, c):
        res = size >> lvl
        rows.append(dict(
            name=f"{name} {c}@{res}", kind="pool", x_shape=(batch, c, res, res),
            flops=0, bytes=(res * res + (res // 2) ** 2) * c * batch * 2,
            cin=c, cout=c, k=2))

    f = nfb
    cbr("enc0a", 0, 1, f)
    cbr("enc0b", 0, f, f)
    cbr("enc1a", 1, f, 2 * f)
    cbr("enc1b", 1, 2 * f, 2 * f)
    cbr("enc2a", 2, 2 * f, 4 * f)
    cbr("enc2b", 2, 4 * f, 4 * f)
    cbr("enc3a", 3, 4 * f, 8 * f)
    cbr("enc3b", 3, 8 * f, 8 * f)
    cbr("mida", 4, 8 * f, 16 * f)
    cbr("midb", 4, 16 * f, 16 * f)
    tconv("up3", 4, 16 * f, 8 * f)
    cbr("dec3a", 3, 16 * f, 8 * f)
    tconv("up2", 3, 8 * f, 4 * f)
    cbr("dec2a", 2, 8 * f, 4 * f)
    tconv("up1", 2, 4 * f, 2 * f)
    cbr("dec1a", 1, 4 * f, 2 * f)
    tconv("up0", 1, 2 * f, f)
    cbr("dec0a", 0, 2 * f, f)
    cbr("head", 0, f, 2, k=1)
    pool("pool0", 0, f)
    pool("pool1", 1, 2 * f)
    return rows


def block_fns(rows, device, dtype=torch.bfloat16, fold=False):
    """``[(row, fn)]``: each census row with its block, ``fn(x)`` on an
    NCHW input. Kernels are drawn from ``np.random.default_rng(0)`` in the
    census order and in the JAX script's layouts (HWIO, and (p, q, o, c)
    for the transpose convs), biases and BN statistics as the JAX script
    sets them (bias 0, gamma 1, beta 0, mean 0, var 1). ``fold`` gives the
    folded form (see the module docstring); ``dtype`` None computes in the
    input's dtype."""
    from deepcalcium_torch.models import blocks as B

    rng = np.random.default_rng(0)
    out = []

    def draw(shape, perm):
        w = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(w).permute(perm).contiguous().to(device)

    for row in rows:
        kind, cin, cout, k = row["kind"], row["cin"], row["cout"], row["k"]
        bias = torch.zeros(cout, device=device)
        if kind == "cbr":
            weight = draw((k, k, cin, cout), (3, 2, 0, 1))
            bn = B.BatchNorm(cout).to(device)
            if fold:
                fw, fb = B.fold_bn(weight, bias, bn)
                fn = (lambda x, w=fw, b=fb:
                      torch.relu(B.conv2d(x, w, b, dtype)))
            else:
                fn = (lambda x, w=weight, b=bias, bn=bn: torch.relu(
                    B.batch_norm(B.conv2d(x, w, b, dtype), bn.weight,
                                 bn.bias, bn.running_mean, bn.running_var)))
        elif kind == "tconv":
            weight = draw((2, 2, cout, cin), (3, 2, 0, 1))
            fn = lambda x, w=weight, b=bias: B.tconv2x2(x, w, b, dtype)
        else:
            fn = B.maxpool2
        out.append((row, torch.inference_mode()(fn)))
    return out


def fold_diffs(rows, device, dtype=torch.bfloat16, seed=1):
    """``{name: (max |folded - parity|, max |parity|)}`` of each block's two
    forms on one standard-normal input (``torch.Generator`` seeded with
    ``seed`` on ``device``, cast to ``dtype``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    parity = block_fns(rows, device, dtype)
    folded = block_fns(rows, device, dtype, fold=True)
    out = {}
    for (row, fn), (_, ffn) in zip(parity, folded):
        x = torch.randn(row["x_shape"], generator=g, device=device)
        x = x.to(dtype or torch.float32)
        y, yf = fn(x).float(), ffn(x).float()
        out[row["name"]] = (float((yf - y).abs().max()), float(y.abs().max()))
    return out


def _net(nfb, device, fold):
    from deepcalcium_torch.models.unet2d import UNet2DS

    net = UNet2DS(nfb=nfb, compute_dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(0)).to(device).eval()
    return net.fold() if fold else net


def _movie(frames, size, device):
    """The 3000x512x512 int16 movie of the JAX script: uniform in [0, 2000),
    made on the device from seed 0."""
    g = torch.Generator(device=device).manual_seed(0)
    return torch.randint(0, 2000, (frames, size, size), generator=g,
                         device=device, dtype=torch.int16)


def _row(name, ms, roof=None, flops=None, nbytes=None, bound=None):
    return {"block": name, "ms": ms, "roof_ms": roof,
            "x": None if roof is None else ms / roof,
            "tflops": None if not flops else flops / ms / 1e9,
            "gbs": None if nbytes is None else nbytes / ms / 1e6,
            "flops": flops, "bytes": nbytes, "bound": bound}


def _print_row(r):
    def cell(v, fmt, width):
        return f"{'':>{width}s}" if v is None else f"{v:{width}{fmt}}"

    print(f"{r['block']:26s} {r['ms']:8.4f} {cell(r['roof_ms'], '.4f', 8)} "
          f"{cell(r['x'], '.2f', 6)} {cell(r['tflops'], '.1f', 8)} "
          f"{cell(r['gbs'], '.0f', 7)}", flush=True)


def main(argv=None, movie=None):
    """Print and return the table: ``{"card", "form", "rows", "summary"}``,
    ``summary`` the mean image of the K1 row's call (None with ``--fast``).
    ``movie`` replaces the generated (``--frames``, ``--size``, ``--size``)
    int16 movie of the K1 and FULL rows."""
    from deepcalcium_torch.ops.summary import movie_summary_fast
    from deepcalcium_torch.train.evaluate import make_movie_evaluator
    from deepcalcium_torch.utils.benchtools import (PEAK_CARD, card,
                                                    roofline_ms, timed_ms)

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csv")
    ap.add_argument("--fast", action="store_true",
                    help="profile the folded blocks the port's inference "
                         "runs instead of the parity blocks")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--nfb", type=int, default=NFB)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the default fails without a CUDA card")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from deepcalcium_torch.utils.device import require_cuda

        device = require_cuda()
    else:
        device = torch.device("cpu")

    where = card(device)
    form = "folded" if args.fast else "parity"
    print(f"# unet_layer_bench ({form} blocks, batch {args.batch} @ "
          f"{args.size}^2, nfb {args.nfb}, bf16) on {where}; roofline of "
          f"{PEAK_CARD}", flush=True)
    print(f"{'block':26s} {'ms':>8s} {'roof_ms':>8s} {'x':>6s} "
          f"{'TFLOP/s':>8s} {'GB/s':>7s}", flush=True)
    g = torch.Generator(device=device).manual_seed(1)
    rows = []
    total_ms = total_roof = 0.0
    for row, fn in block_fns(census(args.batch, args.size, args.nfb), device,
                             fold=args.fast):
        x = torch.randn(row["x_shape"], generator=g, device=device).to(
            torch.bfloat16)
        ms = timed_ms(lambda: fn(x), args.iters, device)
        roof, bound = roofline_ms(row["flops"], row["bytes"])
        r = _row(row["name"], ms, roof, row["flops"], row["bytes"], bound)
        rows.append(r)
        total_ms += ms
        total_roof += roof
        _print_row(r)
        del x

    if movie is None:
        movie = _movie(args.frames, args.size, device)
    t, h, w = movie.shape
    summary = None
    if not args.fast:
        nbytes = movie.numel() * movie.element_size() + 2 * h * w * 4
        summary = movie_summary_fast(movie)[0]
        ms = timed_ms(lambda: movie_summary_fast(movie), args.iters, device)
        roof, bound = roofline_ms(0, nbytes)
        r = _row("summary (K1)", ms, roof, None, nbytes, bound)
        rows.append(r)
        _print_row(r)
    ev = make_movie_evaluator(_net(args.nfb, device, args.fast), (t, h, w),
                              window=(h, w))
    r = _row(f"FULL evaluate ({form})", timed_ms(lambda: ev(movie),
                                                 args.iters, device))
    rows.append(r)
    _print_row(r)
    print(f"single-count block sum: measured={total_ms:.3f} ms "
          f"roofline={total_roof:.3f} ms ({where})", flush=True)

    if args.csv:
        import csv

        with open(args.csv, "w", newline="") as fp:
            wr = csv.writer(fp)
            wr.writerow(["block", "ms", "roof_ms", "flops", "bytes"])
            wr.writerows([r["block"], r["ms"], r["roof_ms"], r["flops"],
                          r["bytes"]] for r in rows)
    return {"card": where, "form": form, "rows": rows, "summary": summary}


if __name__ == "__main__":
    main()
