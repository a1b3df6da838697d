"""Stage-by-stage timing of the movie evaluator on the card.

Counterpart of ``examples/analysis/evaluator_stage_bench.py``: the FULL
``make_movie_evaluator`` against the sum of its stages, each timed alone on
the 3000x512x512 int16 movie at nfb=32 and bf16, to find where the time
between the forward and the whole hides:

1. summary: ``movie_summary_fast``, kernel K1 on the card;
2. z-norm: mean and population std of the mean image, and the reflect-pad
   to the window;
3. tta_expand: the 8 dihedral views;
4. forward: the net that ``evaluate_movie(fast="auto")`` runs,
   ``UNet2DS.fold()`` (the port's counterpart of ``apply_fast_w``);
5. tta_collapse: each view inverted, the 8 averaged, the crop;
6. threshold.

Each stage is fed the previous stage's real output (the JAX script feeds
random arrays of the same shapes), so the stages chained give the FULL
evaluator's mask and prob bit for bit. The readings are taken round-robin
(``benchtools.interleaved_ms``), stages and FULL alike.

Usage: python examples_torch/analysis/evaluator_stage_bench.py
           [--iters 10] [--rounds 3] [--device {cuda,cpu}]
"""

import argparse
import statistics
import sys

sys.path.append(".")

import torch

FRAMES, SIZE, NFB = 3000, 512, 32


def stages(model, movie_shape, window=None, threshold=0.5):
    """``[(name, fn)]``: the six stages of ``make_movie_evaluator(model,
    movie_shape, window, tta=True, threshold=threshold)``, each ``fn``
    taking the previous stage's output (the first the movie)."""
    from deepcalcium_torch.ops.augment import tta_collapse, tta_expand
    from deepcalcium_torch.ops.summary import movie_summary_fast
    from deepcalcium_torch.train.evaluate import reflect_pad_to

    _, h, w = movie_shape
    hw, ww = window or (h, w)

    def znorm(mean):
        std = mean.std(correction=0).clamp_min(1e-12)
        return reflect_pad_to((mean - mean.mean()) / std, hw, ww)

    return [
        ("summary", lambda movie: movie_summary_fast(movie)[0]),
        ("z-norm", znorm),
        ("tta_expand", lambda z: tta_expand(z[None]).reshape(8, hw, ww)),
        ("forward bf16 (folded)", model),
        ("tta_collapse", lambda probs: tta_collapse(
            probs.reshape(8, 1, hw, ww))[0][:h, :w]),
        ("threshold", lambda prob: (prob > threshold).to(torch.uint8)),
    ]


@torch.inference_mode()
def chain(stage_list, movie):
    """Each stage's output, the stages run in order from ``movie``: the last
    is the mask, the one before it the prob."""
    outs, x = [], movie
    for _, fn in stage_list:
        x = fn(x)
        outs.append(x)
    return outs


def main(argv=None, movie=None):
    """Print and return ``{"card", "rows", "stage_sum_ms", "full_ms",
    "chained", "full"}``: a row a stage and one for FULL (ms the median of
    the rounds, with their least and most), and the (mask, prob) of the
    chained stages and of the FULL evaluator. ``movie`` replaces the
    generated (``--frames``, ``--size``, ``--size``) int16 movie."""
    from deepcalcium_torch.models.unet2d import UNet2DS
    from deepcalcium_torch.train.evaluate import make_movie_evaluator
    from deepcalcium_torch.utils.benchtools import card, interleaved_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--nfb", type=int, default=NFB)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the default fails without a CUDA card")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from deepcalcium_torch.utils.device import require_cuda

        device = require_cuda()
    else:
        device = torch.device("cpu")

    model = UNet2DS(nfb=args.nfb, compute_dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0))
    model = model.to(device).eval().fold()
    if movie is None:
        g = torch.Generator(device=device).manual_seed(0)
        movie = torch.randint(0, 2000, (args.frames, args.size, args.size),
                              generator=g, device=device, dtype=torch.int16)
    t, h, w = movie.shape
    st = stages(model, movie.shape)
    outs = chain(st, movie)
    inputs = [movie] + outs[:-1]
    evaluate = make_movie_evaluator(model, movie.shape, window=(h, w))
    fmask, fprob, _ = evaluate(movie)
    fns = {name: (lambda fn=fn, x=x: fn(x))
           for (name, fn), x in zip(st, inputs)}
    fns["FULL evaluator"] = lambda: evaluate(movie)
    with torch.inference_mode():
        readings = interleaved_ms(fns, args.iters, args.rounds, device)

    where = card(device)
    print(f"# evaluator_stage_bench ({t}x{h}x{w} int16, nfb {args.nfb}, "
          f"bf16, 8x TTA; {args.rounds} rounds of {args.iters} calls, "
          f"round-robin) on {where}", flush=True)
    print(f"{'stage':24s} {'ms':>9s} {'min':>9s} {'max':>9s}", flush=True)
    rows = []
    for name, ms in readings.items():
        rows.append({"stage": name, "ms": statistics.median(ms),
                     "min_ms": min(ms), "max_ms": max(ms)})
    stage_sum = sum(r["ms"] for r in rows[:-1])
    for r in rows[:-1] + [{"stage": "stage sum", "ms": stage_sum,
                           "min_ms": None, "max_ms": None}] + rows[-1:]:
        lo = "" if r["min_ms"] is None else f"{r['min_ms']:9.4f}"
        hi = "" if r["max_ms"] is None else f"{r['max_ms']:9.4f}"
        print(f"{r['stage']:24s} {r['ms']:9.4f} {lo:>9s} {hi:>9s}",
              flush=True)
    same = (torch.equal(outs[-1], fmask) and torch.equal(outs[-2], fprob))
    print(f"chained stages give the FULL evaluator's mask and prob bit for "
          f"bit: {same}; FULL / stage sum = {rows[-1]['ms'] / stage_sum:.3f} "
          f"({where})", flush=True)
    return {"card": where, "rows": rows, "stage_sum_ms": stage_sum,
            "full_ms": rows[-1]["ms"], "chained": (outs[-1], outs[-2]),
            "full": (fmask, fprob)}


if __name__ == "__main__":
    main()
