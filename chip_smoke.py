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
   against the movie's ground truth, and timed;
6. train step vs JAX: the golden tiny net takes 3 Adam steps at float32
   (TF32 off) and is held against ``unet2d_tiny_train_step.npz``, which the
   JAX package wrote; and 2x2 max-pool gradients on tied windows, float32
   and bfloat16, go to the first maximum in row-major order;
7. the training path at full width: ``UNet2DSummary.fit`` at nfb=32,
   bfloat16, batch 20 of 128x128 windows, 2 epochs of 10 steps with 512x512
   validation, on two synthetic movies whose summaries K1 makes; then the
   best checkpoint is read back and evaluated, and the train step is timed.
Then one JSON line with each kernel's record and the paths' numbers, the
card's name and power limit, and as the last line ``{"ok": true,
"device": {...}}``. Any failure raises, so the exit code is non-zero and no
``"ok"`` line is printed. Without a CUDA card it fails.
"""

import argparse
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FRAMES = 3000  # the movie of bench.py
WINDOW = 512
NFB = 32
# The training recipe of bench.py: batch 20 of 128x128 windows.
TRAIN_BATCH, TRAIN_WINDOW = 20, 128
FIT_FRAMES, FIT_EPOCHS, FIT_STEPS = 1000, 2, 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


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


def _device_time_per_call(fn, calls):
    """Kernel time and kernel launches per call of ``fn`` from
    ``torch.profiler``, and the 5 kernels that take the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # Device events, without the annotation ranges (such as the optimizer
    # step's) that span kernels already counted.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    total_ms = sum(e.self_device_time_total for e in kernels) / calls / 1e3
    launches = sum(e.count for e in kernels) / calls
    top = [(e.key[:60], e.self_device_time_total / calls / 1e3)
           for e in kernels[:5]]
    return total_ms, launches, top


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


def assert_matches_golden(gold, metrics, grads, params, state):
    """The train-step golden's tolerances (``tests/test_torch_train.py``
    holds the CPU to them too):
    - loss and dicesq (unrounded): rtol 1e-4;
    - the rounded metrics: atol 2e-3, one pixel of the 2048 crossing 0.5;
    - step-1 gradients: rtol 1e-4 plus 1e-5 of the largest gradient (sums
      in another order; the BN-fed biases are zero up to rounding);
    - params after 3 steps: atol 6e-5 = 3 steps * lr * 1e-6 / eps, the most
      a gradient noise of 1e-6 can move a weight;
    - BN state after 3 steps: rtol 1e-4, atol 1e-5.
    ``metrics`` is one dict per step; ``grads``, ``params`` and ``state``
    are trees in the JAX package's layout. Returns the largest absolute
    error of each group."""
    import numpy as np

    def flat(prefix, tree):
        return {f"{prefix}/{k}/{leaf}": np.asarray(v, np.float32)
                for k in sorted(tree) for leaf, v in sorted(tree[k].items())}

    errs = {}
    for k in ("loss", "dicesq", "F1", "prec", "reca", "dice", "posyt", "posyp"):
        got = np.array([m[k] for m in metrics], np.float32)
        exact = k in ("loss", "dicesq")
        np.testing.assert_allclose(got, gold[f"metrics/{k}"],
                                   rtol=1e-4 if exact else 0,
                                   atol=0 if exact else 2e-3, err_msg=k)
        errs[k] = float(np.abs(got - gold[f"metrics/{k}"]).max())
    flat_g = flat("grads", grads)
    gmax = max(np.abs(gold[k]).max() for k in flat_g)
    for group, tree, rtol, atol in (("grads", flat_g, 1e-4, 1e-5 * gmax),
                                    ("params", flat("params", params), 0, 6e-5),
                                    ("state", flat("state", state), 1e-4, 1e-5)):
        for k, v in tree.items():
            np.testing.assert_allclose(v, gold[k], rtol=rtol, atol=atol,
                                       err_msg=k)
        errs[group] = float(max(np.abs(v - gold[k]).max()
                                for k, v in tree.items()))
    return errs


def first_max_grad(z, ct):
    """Numpy oracle of the 2x2 max-pool gradient on NCHW ``z``: each
    window's cotangent goes to its first maximum in row-major order."""
    import numpy as np

    n, c, h, w = z.shape
    win = (z.reshape(n, c, h // 2, 2, w // 2, 2).transpose(0, 1, 2, 4, 3, 5)
           .reshape(n, c, h // 2, w // 2, 4))
    first = np.argmax(win == win.max(axis=-1, keepdims=True), axis=-1)
    g = np.zeros_like(win)
    np.put_along_axis(g, first[..., None], ct[..., None], axis=-1)
    return (g.reshape(n, c, h // 2, w // 2, 2, 2).transpose(0, 1, 2, 4, 3, 5)
            .reshape(n, c, h, w))


def phase_train_golden(dev):
    import numpy as np
    import torch

    from deepcalcium_torch.models import blocks
    from deepcalcium_torch.models.unet2d import (from_jax_params, jax_tree,
                                                 to_jax_params)
    from deepcalcium_torch.ops.losses import binary_crossentropy
    from deepcalcium_torch.train import trainer
    from deepcalcium_torch.train.checkpoints import load_npz_params

    gold_dir = REPO / "tests" / "golden"
    with np.load(gold_dir / "unet2d_tiny_train_step.npz") as f:
        gold = dict(f)
    params, state = load_npz_params(gold_dir / "unet2d_tiny_params.npz")
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = from_jax_params(params, state, device=dev, drp=0.0)
        opt = trainer.make_optimizer(model, float(gold["lr"]))
        for group in opt.param_groups:
            group["eps"] = float(gold["adam_eps"])
        step = trainer.make_train_step(model, binary_crossentropy, opt)
        x = torch.from_numpy(gold["x"]).to(dev)
        y = torch.from_numpy(gold["y"]).to(dev)
        metrics, grads = [], None
        for _ in range(3):
            met = step(x, y)
            metrics.append({k: v.item() for k, v in met.items()})
            if grads is None:
                grads = jax_tree(model, {n: p.grad for n, p in
                                         model.named_parameters()})
        params3, state3 = to_jax_params(model)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    errs = assert_matches_golden(gold, metrics, grads, params3, state3)
    print("train step vs JAX golden (tiny net, f32, TF32 off, 3 Adam steps): "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()), flush=True)

    # 2x2 max-pool ties: all-equal windows and a (1, 2; 2, 0) window.
    rng = np.random.default_rng(5)
    z = np.maximum(rng.standard_normal((2, 3, 8, 8)), 0).astype(np.float32)
    z[0, 0, 0:2, 0:2] = [[1.0, 2.0], [2.0, 0.0]]
    z[1, 2, 4:8, 2:6] = 3.0
    ct = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        zt = torch.from_numpy(z).to(dev, dtype).requires_grad_()
        blocks.maxpool2(zt).backward(torch.from_numpy(ct).to(dev, dtype))
        want = first_max_grad(z, torch.from_numpy(ct).to(dtype).float().numpy())
        if not np.array_equal(zt.grad.float().cpu().numpy(), want):
            raise AssertionError(f"max-pool gradient routing differs from the "
                                 f"first row-major maximum at {dtype}")
    print("max-pool tie routing on the card (f32, bf16): first row-major "
          "maximum, as the JAX package's dense vjp", flush=True)
    return errs


def phase_fit(dev, seed):
    """``UNet2DSummary.fit`` at the published width on two synthetic movies
    whose summaries come from K1; returns (K1 launches, numbers)."""
    import numpy as np
    import torch

    from deepcalcium_torch.models.unet2d import (UNet2DS, forward_flops,
                                                 to_jax_params)
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary
    from deepcalcium_torch.ops.losses import binary_crossentropy
    from deepcalcium_torch.ops.mask_summary import mask_summary_exact
    from deepcalcium_torch.ops.summary import movie_summary_cuda
    from deepcalcium_torch.train import trainer
    from deepcalcium_torch.train.checkpoints import read_checkpoint
    from deepcalcium_torch.train.sampler import WindowSampler

    rng = np.random.default_rng(seed + 1)
    masks, movies = {}, {}
    for i, name in enumerate(("synthetic.fit.a", "synthetic.fit.b")):
        masks[name] = _neuron_masks(rng, (WINDOW, WINDOW), 100)
        movies[name] = _synthetic_movie(dev, masks[name], FIT_FRAMES,
                                        seed + 10 + i)

    def series_summary(name):
        mean, _ = movie_summary_cuda(movies[name])
        return ((mean - mean.mean()) / mean.std(correction=0)).cpu().numpy()

    nets, snapshots = [], {}

    def net_func(**kw):
        nets.append(UNet2DS(nfb=NFB, **kw))
        snapshots["init"] = to_jax_params(nets[-1])
        return nets[-1]

    cpdir = REPO / "build" / "chip_smoke_fit"
    shutil.rmtree(cpdir, ignore_errors=True)
    wrapper = UNet2DSummary(
        cpdir=str(cpdir), dataset_name_func=lambda name: name,
        series_summary_func=series_summary,
        mask_summary_func=lambda name: mask_summary_exact(masks[name]),
        net_func=net_func, compute_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        movie_summary_cuda.launches = 0
        t0 = time.perf_counter()
        history, best = wrapper.fit(
            list(movies), shape_trn=(TRAIN_WINDOW, TRAIN_WINDOW),
            shape_val=(WINDOW, WINDOW), batch_size_trn=TRAIN_BATCH,
            nb_steps_trn=FIT_STEPS, nb_epochs=FIT_EPOCHS, seed=seed,
            epoch_callbacks=[lambda e, logs: snapshots.__setitem__(
                e, to_jax_params(nets[-1]))])
        fit_s = time.perf_counter() - t0
        launches = movie_summary_cuda.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if launches < 1:
            raise AssertionError("the training path did not launch K1")
        if not np.isfinite(history["loss"]).all():
            raise AssertionError(f"non-finite loss {history['loss']}")
        (p0, s0), (p1, s1) = snapshots["init"], snapshots[FIT_EPOCHS - 1]
        if all(np.array_equal(p0[k][l], p1[k][l]) for k in p0 for l in p0[k]):
            raise AssertionError("fit changed no weight")
        if all(np.array_equal(s0[k][l], s1[k][l]) for k in s0 for l in s0[k]):
            raise AssertionError("fit changed no BN running statistic")
        ckpt = read_checkpoint(best)
        want_p, want_s = snapshots[int(ckpt["meta"]["epoch"])]
        for tree, want in ((ckpt["params"], want_p), (ckpt["state"], want_s)):
            for k in want:
                for leaf in want[k]:
                    if not np.array_equal(tree[k][leaf], want[k][leaf]):
                        raise AssertionError(f"best checkpoint {k}/{leaf} is "
                                             f"not the trained weight")
        if int(ckpt["opt_state"]["count"]) != FIT_STEPS * (int(ckpt["meta"]["epoch"]) + 1):
            raise AssertionError("best checkpoint has the wrong Adam count")
        name = list(movies)[0]
        mask, prob = wrapper.evaluate_movie(movies[name], model_path=best,
                                            window_shape=(WINDOW, WINDOW))
        if mask.shape != (WINDOW, WINDOW) or not np.isfinite(prob).all():
            raise AssertionError("evaluate_movie of the best checkpoint failed")

        # Steady state of the same train step, with CUDA events, and the
        # validation alone on the summaries fit used.
        net = nets[-1]
        S = [series_summary(n) for n in movies]
        M = [mask_summary_exact(masks[n]) for n in movies]
        sampler = WindowSampler(S, M, list(movies),
                                [(0, WINDOW * 3 // 4)] * 2,
                                (TRAIN_WINDOW, TRAIN_WINDOW),
                                nb_max_augment=15, seed=seed)
        xb, yb = (torch.from_numpy(a).to(dev) for a in
                  sampler.sample_batch(TRAIN_BATCH))
        step = trainer.make_train_step(
            net, binary_crossentropy, trainer.make_optimizer(net, 1e-4))
        gen = torch.Generator(device=dev).manual_seed(seed)
        for _ in range(3):
            step(xb, yb, gen)
        step_ms = _timed_ms(lambda: step(xb, yb, gen), 20)
        device_ms, step_kernels, top = _device_time_per_call(
            lambda: step(xb, yb, gen), 5)
        fwd = trainer.make_eval_forward(net)
        val_args = (S, M, list(movies), [(WINDOW * 3 // 4, WINDOW)] * 2,
                    (WINDOW, WINDOW), 0)
        wrapper._validate(fwd, *val_args)
        t1 = time.perf_counter()
        wrapper._validate(fwd, *val_args)
        val_ms = (time.perf_counter() - t1) * 1e3
    finally:
        shutil.rmtree(cpdir, ignore_errors=True)
    flops = 3 * TRAIN_BATCH * forward_flops(TRAIN_WINDOW, TRAIN_WINDOW, NFB)
    numbers = {
        "loss_per_epoch": history["loss"],
        "val_nf_f1_mean_per_epoch": history["val_nf_f1_mean"],
        "epoch_seconds": history["epoch_seconds"], "fit_seconds": fit_s,
        "train_step_ms": step_ms, "train_step_device_ms": device_ms,
        "train_step_kernels": step_kernels,
        "train_step_device_idle": 1.0 - device_ms / step_ms,
        "windows_per_sec": TRAIN_BATCH / step_ms * 1e3,
        "train_tflops": flops / step_ms / 1e9,
        "validate_ms": val_ms, "peak_gib": peak_gib,
        "best": Path(best).name}
    print(f"fit nfb={NFB} bf16, batch {TRAIN_BATCH} @ {TRAIN_WINDOW}^2, "
          f"{FIT_EPOCHS}x{FIT_STEPS} steps, validation 6 views x 2 at "
          f"{WINDOW}^2: K1 launches {launches}; loss per epoch "
          f"{[round(v, 4) for v in history['loss']]}; epoch wall "
          f"{[round(v, 2) for v in history['epoch_seconds']]} s; best "
          f"{Path(best).name} read back equal to the trained weights and "
          f"evaluated", flush=True)
    print(f"train step {step_ms:.3f} ms ({numbers['windows_per_sec']:.1f} "
          f"windows/s, {numbers['train_tflops']:.1f} TFLOP/s bf16 at "
          f"3x forward FLOPs); validation {val_ms:.1f} ms; peak memory "
          f"{peak_gib:.2f} GiB", flush=True)
    print(f"train step on the device: {step_kernels:.0f} kernels, "
          f"{device_ms:.3f} ms of them a step, so the card idles "
          f"{1 - device_ms / step_ms:.1%} of it; most "
          f"device time: " + "; ".join(f"{n} {ms:.3f} ms" for n, ms in top),
          flush=True)
    return launches, numbers


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
    eval_launches, eval_ms = phase_main(dev, args.seed, FRAMES)
    golden_errs = phase_train_golden(dev)
    fit_launches, fit = phase_fit(dev, args.seed)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    # K1's least time at the main path's shape: it must read the int16 movie
    # once and write two float32 images; its adds and compares are far
    # below the card's rate.
    k1_bytes = FRAMES * WINDOW * WINDOW * 2 + 2 * WINDOW * WINDOW * 4
    print(json.dumps({"kernels": [{
        "name": "K1 movie_summary_cuda", "route": "cuda",
        "source": "deepcalcium_torch/csrc/summary.cu",
        "replaces": "deepcalcium_tpu/ops/summary.py:94",
        "launches": eval_launches + fit_launches,
        "launches_by_path": {"evaluate": eval_launches, "fit": fit_launches},
        "max_abs_err": err, "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None}],
        "evaluate_ms": eval_ms, "train_golden_max_abs_err": golden_errs,
        "fit": fit, "seconds": time.perf_counter() - t0}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
