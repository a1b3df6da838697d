"""Smoke run of the PyTorch port (``deepcalcium_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, one line each, in order:
1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles the CUDA kernels from ``deepcalcium_torch/csrc``;
3. K1 (``movie_summary_cuda``) against the plain ``movie_summary`` on the
   card, at the main path's shape and at ragged ones, with both times;
4. the golden tiny net at float32 (TF32 off) against ``golden_io.npz``;
5. the main path at full width: ``UNet2DSummary.evaluate_movie`` with
   nfb=32 random weights from a seed, bfloat16, 8x TTA and a 512x512
   window, on a synthetic 3000x512x512 int16 movie made on the card; the
   result is held against the same evaluator fed the plain summary, scored
   against the movie's ground truth, and timed.
Then one JSON line with each kernel's record, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises, so the exit code is
non-zero and no ``"ok"`` line is printed. Without a CUDA card it fails.
"""

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FRAMES = 3000  # the movie of bench.py
WINDOW = 512
NFB = 32


def _timed_ms(fn, iters):
    """Mean ms per call of ``fn`` from CUDA events, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    from deepcalcium_torch.utils.device import require_cuda

    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[dev.index if dev.index is not None else 0]
    print(f"device: {card}", flush=True)
    return dev, card


def phase_build():
    from deepcalcium_torch.ops._build import build_library, load_library

    so, seconds = build_library()
    load_library()
    log = so.with_suffix(".log")
    regs = [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln] if log.exists() else []
    print(f"build: {seconds:.2f} s -> {so.relative_to(REPO)}; ptxas: "
          f"{' | '.join(regs) or 'cached build'}", flush=True)


def _k1_cases(dev, g, t_full):
    """(label, movie) pairs: the main path's shape first, then uint16,
    float32 past 2**31 bytes, and ragged or misaligned cases."""
    import torch

    def ints(lo, hi, shape, dtype=torch.int16):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32).to(dtype)

    def misaligned(m):
        # A contiguous view 2 bytes past a 16-byte boundary: scalar path.
        flat = torch.empty(m.numel() + 1, dtype=m.dtype, device=dev)
        flat[1:] = m.reshape(-1)
        return flat[1:].view(m.shape)

    full = torch.randint(0, 2000, (t_full, WINDOW, WINDOW), generator=g,
                         device=dev, dtype=torch.int16)
    yield "int16 main", full
    del full
    yield "uint16", ints(0, 65536, (1000, WINDOW, WINDOW), torch.uint16)
    yield "float32 >2^31 B", torch.rand((t_full, WINDOW, WINDOW),
                                        generator=g, device=dev) * 2000
    yield "int16 prime T, ragged H W", ints(-100, 3000, (31, 19, 137))
    yield "int16 all negative", ints(-5000, -10, (7, 8, 130))
    yield "int16 T=1", ints(0, 2000, (1, 40, 44))
    yield "int16 T>32768 full range", ints(-32768, 32768, (40000, 4, 64))
    yield "uint16 ragged", ints(0, 65536, (13, 509, 511), torch.uint16)
    yield "float32 ragged", torch.randn((10, 8, 130), generator=g,
                                        device=dev) - 5
    yield "int16 misaligned", misaligned(ints(0, 2000, (37, 24, 40)))


def phase_k1(dev, seed, t_full):
    import torch

    from deepcalcium_torch.ops.summary import movie_summary, movie_summary_cuda

    g = torch.Generator(device=dev).manual_seed(seed)
    worst, timing = 0.0, None
    for label, movie in _k1_cases(dev, g, t_full):
        mean, mx = movie_summary_cuda(movie)
        pmean, pmx = movie_summary(movie)
        torch.cuda.synchronize()
        if not torch.equal(mx, pmx.to(torch.float32)):
            raise AssertionError(f"K1 max differs from the plain max: {label}")
        err = (mean - pmean).abs().max().item()
        if movie.dtype.is_floating_point:
            # rtol=1e-6: float sums are formed in another order.
            if not torch.allclose(mean, pmean, rtol=1e-6, atol=0):
                raise AssertionError(f"K1 mean off by {err}: {label}")
        elif not torch.equal(mean, pmean):
            # Integer sums are exact on both sides, so the means are equal.
            raise AssertionError(f"K1 mean not bitwise equal: {label}")
        worst = max(worst, err)
        if timing is None:
            nbytes = movie.numel() * movie.element_size()
            # Alternate plain and kernel on the same card.
            p1 = _timed_ms(lambda: movie_summary(movie), 5)
            k1 = _timed_ms(lambda: movie_summary_cuda(movie), 20)
            k2 = _timed_ms(lambda: movie_summary_cuda(movie), 20)
            p2 = _timed_ms(lambda: movie_summary(movie), 5)
            timing = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                      "gbps": nbytes / min(k1, k2) / 1e6,
                      "plain_gbps": nbytes / min(p1, p2) / 1e6,
                      "shape": list(movie.shape)}
        print(f"K1 {label} {tuple(movie.shape)} {movie.dtype}: max bitwise "
              f"equal, mean max_abs_err {err:.3g}", flush=True)
        del movie, mean, mx, pmean, pmx
        torch.cuda.empty_cache()
    print(f"K1 time at {timing['shape']} int16: {timing['ms']:.4f} ms "
          f"({timing['gbps']:.1f} GB/s); plain {timing['plain_ms']:.4f} ms "
          f"({timing['plain_gbps']:.1f} GB/s)", flush=True)
    return worst, timing


def phase_golden(dev):
    import numpy as np
    import torch

    from deepcalcium_torch.models.unet2d import from_jax_params
    from deepcalcium_torch.train.checkpoints import load_npz_params

    gold = REPO / "tests" / "golden"
    data = np.load(gold / "golden_io.npz")
    params, state = load_npz_params(gold / "unet2d_tiny_params.npz")
    # Full float32 on the card: cuDNN would run f32 convs in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = from_jax_params(params, state, device=dev).eval()
        with torch.inference_mode():
            x = torch.from_numpy(data["x2"]).to(dev)
            y = model(x).cpu().numpy()
            yf = model.fold()(x).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    for name, out in (("plain", y), ("folded", yf)):
        np.testing.assert_allclose(out, data["y2"], rtol=1e-4, atol=1e-5,
                                   err_msg=f"golden y2, {name} forward")
    print(f"golden tiny net, f32 with TF32 off: max_abs_err "
          f"{np.abs(y - data['y2']).max():.3g} (folded "
          f"{np.abs(yf - data['y2']).max():.3g}), rtol=1e-4 atol=1e-5",
          flush=True)


def _neuron_masks(rng, shape, nb_neurons, r_lo=3, r_hi=7):
    """Disk neurons of varied radii, touching pairs allowed: the recipe of
    ``deepcalcium_tpu.data.fixtures.realistic_neurons`` (that module needs
    h5py). Returns (N, H, W) int8."""
    import numpy as np

    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    masks, centers = [], []
    attempts = 0
    while len(masks) < nb_neurons and attempts < 5000:
        attempts += 1
        r = int(rng.integers(r_lo, r_hi + 1))
        cy = int(rng.integers(r + 1, h - r - 1))
        cx = int(rng.integers(r + 1, w - r - 1))
        if any((cy - y) ** 2 + (cx - x) ** 2 < (r + rr) ** 2 * 0.5
               for y, x, rr in centers):
            continue
        masks.append((((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r)
                     .astype(np.int8))
        centers.append((cy, cx, r))
    return np.stack(masks)


def _synthetic_movie(dev, masks, t, seed, base=120.0, amp_lo=80.0,
                     amp_hi=300.0, decay=8.0, spike_rate=0.05, chunk=500):
    """Calcium-imaging-like int16 movie made on the card, as
    ``fixtures.realistic_movie`` makes it on the host: per-neuron spike
    trains through an exponential calcium kernel, slow drift, shot noise."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)
    n = masks.shape[0]
    klen = int(decay * 4)
    kernel = torch.exp(-torch.arange(klen, device=dev) / decay)
    spikes = (torch.rand((n, 1, t), generator=g, device=dev) < spike_rate)
    act = F.conv1d(F.pad(spikes.float(), (klen - 1, 0)),
                   kernel.flip(0)[None, None])[:, 0]            # (n, t)
    amps = amp_lo + (amp_hi - amp_lo) * torch.rand(n, generator=g, device=dev)
    footprint = torch.from_numpy(masks).to(dev).reshape(n, -1).float()
    footprint *= amps[:, None]
    drift = 1.0 + 0.1 * torch.sin(torch.linspace(0, 3 * math.pi, t, device=dev))
    movie = torch.empty((t,) + masks.shape[1:], dtype=torch.int16, device=dev)
    for i in range(0, t, chunk):
        lam = act[:, i:i + chunk].T @ footprint + base * drift[i:i + chunk, None]
        lam = lam.clamp_min(1.0).reshape((-1,) + masks.shape[1:])
        movie[i:i + chunk] = torch.poisson(lam, generator=g).to(torch.int16)
    return movie


def phase_main(dev, seed, t):
    import numpy as np
    import torch

    from deepcalcium_torch.models.unet2d import (UNet2DS, forward_flops,
                                                 from_jax_params,
                                                 to_jax_params)
    from deepcalcium_torch.metrics.neurofinder import nf_mask_metrics
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary
    from deepcalcium_torch.ops.mask_summary import mask_summary_exact
    from deepcalcium_torch.ops.summary import movie_summary, movie_summary_cuda
    from deepcalcium_torch.train.evaluate import (make_movie_evaluator,
                                                  make_summary_evaluator)

    rng = np.random.default_rng(seed)
    masks = _neuron_masks(rng, (WINDOW, WINDOW), 100)
    movie = _synthetic_movie(dev, masks, t, seed)
    truth = mask_summary_exact(masks)
    params, state = to_jax_params(
        UNet2DS(nfb=NFB, generator=torch.Generator().manual_seed(seed)))
    torch.cuda.synchronize()

    # Deterministic cuDNN for the runs that are compared with each other.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    wrapper = UNet2DSummary(compute_dtype=torch.bfloat16)
    movie_summary_cuda.launches = 0
    mask, prob = wrapper.evaluate_movie(
        movie, params=params, state=state, window_shape=(WINDOW, WINDOW),
        tta=True, fast="auto")
    launches = movie_summary_cuda.launches
    if launches < 1:
        raise AssertionError("the main path did not launch K1")
    if mask.shape != (WINDOW, WINDOW) or prob.shape != (WINDOW, WINDOW):
        raise AssertionError(f"bad output shapes {mask.shape} {prob.shape}")
    if not (np.isfinite(prob).all() and set(np.unique(mask)) <= {0, 1}):
        raise AssertionError("non-finite prob or non-binary mask")

    model = from_jax_params(params, state, torch.bfloat16, dev).eval().fold()
    plain_mean, _ = movie_summary(movie)
    pmask, pprob = make_summary_evaluator(model, (WINDOW, WINDOW))(plain_mean)
    if not (np.array_equal(pprob.cpu().numpy(), prob)
            and np.array_equal(pmask.cpu().numpy(), mask)):
        raise AssertionError("prob/mask differ from the plain-summary run")
    p, r, inc, exc, f1 = nf_mask_metrics(truth, mask)
    print(f"main path: evaluate_movie nfb={NFB} bf16 8xTTA window "
          f"{WINDOW}^2 on {tuple(movie.shape)} int16: K1 launches "
          f"{launches}, mask/prob equal to the plain-summary run; "
          f"untrained score vs {masks.shape[0]} neurons: precision {p:.4f} "
          f"recall {r:.4f} F1 {f1:.4f}; mask fraction {mask.mean():.4f}",
          flush=True)

    # Timing with cuDNN's default settings.
    torch.backends.cudnn.deterministic = False
    evaluate = make_movie_evaluator(model, movie.shape)
    views = torch.zeros((8, WINDOW, WINDOW), device=dev)
    with torch.inference_mode():
        ms = _timed_ms(lambda: evaluate(movie), 10)
        fwd_ms = _timed_ms(lambda: model(views), 10)
    k1_ms = _timed_ms(lambda: movie_summary_cuda(movie), 10)
    flops = 8 * forward_flops(WINDOW, WINDOW, NFB)
    print(f"main path time: evaluate {ms:.3f} ms ({t / ms * 1e3:.1f} "
          f"frames/s); of which K1 alone {k1_ms:.3f} ms and the 8-view "
          f"forward alone {fwd_ms:.3f} ms ({flops / fwd_ms / 1e9:.1f} "
          f"TFLOP/s bf16); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches, ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    t0 = time.perf_counter()
    dev, card = phase_device()
    phase_build()
    err, timing = phase_k1(dev, args.seed, FRAMES)
    phase_golden(dev)
    launches, eval_ms = phase_main(dev, args.seed, FRAMES)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "K1 movie_summary_cuda", "route": "cuda",
        "source": "deepcalcium_torch/csrc/summary.cu",
        "replaces": "deepcalcium_tpu/ops/summary.py:94",
        "launches": launches, "max_abs_err": err, "ms": timing["ms"],
        "plain_ms": timing["plain_ms"]}],
        "evaluate_ms": eval_ms, "seconds": time.perf_counter() - t0}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
