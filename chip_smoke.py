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
   best checkpoint is read back and evaluated, and the train step is timed;
8. K1's fold (``movie_fold_cuda``) against the plain fold and one K1 call,
   through staging buffers poisoned past ``n_valid``, and its time;
9. the streaming evaluate of the phase-5 movie held as a host array;
10. the tiled evaluate of a host 1000x1024x1024 movie, checked at float32
    against the fused path and a straightforward composition;
11. ``UNet2DSummary.predict`` through the injection points, and
    ``nf_submit`` read back;
12. the golden tiny UNet1D at float32 (TF32 off) against ``golden_io.npz``
    ``y1``;
13. 1-D train step vs JAX: the tiny UNet1D takes 3 Adam steps at float32
    (TF32 off) and is held against ``unet1d_tiny_train_step.npz``; and the
    window-2 pool and the margin head route tied gradients as the JAX
    package does, float32 and bfloat16;
14. the spike path at full width: ``UNet1DSegmentation.fit`` at nfb=32,
    bfloat16, batch 20 of 4096-sample windows, margin 4, 2 epochs on 200
    synthetic calcium traces of 30,011 samples; then the train step is
    timed and profiled;
    then K steps a dispatch: ``trainer.make_multi_step`` as one CUDA graph of
    4 steps for both nets at the published widths, bit for bit 4 eager steps
    and near the default path, timed and profiled beside the K=1 step, and
    one ``fit(preset="perf")`` of each wrapper (``phase_multistep``);
15. ``UNet1DSegmentation.predict`` of the 200 full-length traces from the
    best checkpoint at batch 32, bf16: the default (the folded net,
    ``UNet1D.fold``) and ``fast=False`` (the unfolded eval net) timed in
    turns, each with its device profile; at float32 (TF32 off) the folded
    masks equal the unfolded ones, and batch 8 gives batch 32's, away from
    the threshold;
16. ``GLMSegmentation`` fit, predict and ``predict_rates`` for the GLM and
    the STM on the same traces, with the ms of a full-batch epoch;
17. per-frame segmentation at full width: ``segment_movie`` on a host
    1024x512x512 int16 movie at nfb=32, bfloat16, slab 64, held bit for bit
    against a plain slab-by-slab loop; a ragged 70x500x470 call at float32
    (TF32 off) against a straightforward per-frame composition through the
    unfolded net; then frames/s over two calls, device time and idle share;
18. the stencil mask summary of 300 neurons on 512x512 on the card, equal
    bit for bit to the CPU's, a subset of the exact walk's, and equal to it
    on separated neurons; then Cellpose's two flow kernels
    (``ops/flows.py``: 200 Euler steps of ~28,000 pixels on a 512x512
    field, the diffusion of ~160 masks) bit for bit their plain steps on
    the card, each timed beside its bound and the plain steps' time; then
    Cellpose-SAM's attention kernel (``ops/attention.py``) at the cell's
    shapes against the float32 attention with the bias built whole, timed
    beside its bound, the plain version and cuDNN's flash call alone
    (``phase_attention``);
19. the command line, ``deepcalcium_torch.cli.main([...])`` with no
    ``--device``: ``evaluate-movie``, ``segment``, ``parity-golden``,
    ``predict``, ``spikes-train --arch glm``, ``spikes-predict --arch glm``
    and ``spikes-predict --arch unet1d`` of the phase-14 checkpoint. This
    machine has no h5py, so the four private functions the commands get
    their wrappers and movies through are replaced with ones that hand over
    in-memory arrays through the wrappers' injection points;
20. the multi-device paths over an NCCL group of one rank on the card:
    ``movie_summary_sharded`` of the phase-5 movie bit for bit K1's; one
    UNet2DS and one UNet1D train step at full width with ``mesh=`` against
    without, from the same weights at drp=0, with both times; one meshed
    4-step CUDA graph of UNet2DS (its collectives captured) bit for bit the
    unmeshed one;
    ``make_movie_evaluator(mesh=)`` and ``segment_movie(mesh=)`` bit for
    bit the plain ones; and, where the machine has several cards,
    ``deepcalcium_torch/parallel/dryrun.py`` with one rank a card, rank 0
    held against one process;
21. the example scripts, ``examples_torch/**/main([...])`` with no
    ``--device``, at nfb=32: the hyperparameter search (2 trials of one
    10-step epoch with 512x512 validation on phase 7's movies, their
    summaries from K1, then ``--resume`` to a third row), ``dataset_stats
    --throughput`` on the phase-5 movie as a host array (its mask bit for
    bit phase 9's), ``activation_maps`` on one 512x512 summary (18 captured
    blocks, the probabilities bit for bit those without ``capture``), and
    the four ``init_scheme``s (each kernel inside its bound, the large
    ones' std within 2%, one train step to a finite loss). In-memory
    arrays take the place of HDF5 files through each script's private
    functions, as in phase 19;
22. the measuring scripts of ``examples_torch/analysis/`` through their
    ``main([...])`` at full width (``phase_analysis``): the evaluator's
    stages on the phase-5 movie, chained bit for bit into the FULL
    evaluator and within 2x of its time; the UNet2DS per-block roofline in
    the parity and the folded form (no row over its roofline, K1's mean
    bit for bit the plain summary, each folded block within bf16 rounding
    of its parity block); the UNet1D roofline against phase 14's step; the
    kernel time of a 4-step dispatch of each net by kind of work; the
    batch sweep of the 2-D train step.
Then one JSON line with each kernel's record and the paths' numbers, the
card's name and power limit, and as the last line ``{"ok": true,
"device": {...}}``. Any failure raises, so the exit code is non-zero and no
``"ok"`` line is printed. Without a CUDA card it fails.
"""

import argparse
import copy
import json
import math
import shutil
import sys
import time
from pathlib import Path

from deepcalcium_torch.utils.benchtools import (BF16_FLOPS_PER_S,
                                                HBM_BYTES_PER_S,
                                                card as card_line,
                                                device_time_per_call,
                                                kernel_table, timed_ms)

REPO = Path(__file__).resolve().parent
FRAMES = 3000  # the movie of bench.py
WINDOW = 512
NFB = 32
# The training recipe of bench.py: batch 20 of 128x128 windows.
TRAIN_BATCH, TRAIN_WINDOW = 20, 128
FIT_FRAMES, FIT_EPOCHS, FIT_STEPS = 1000, 2, 10
# The 1-D training recipe of bench.py: batch 20 of 4096-sample windows,
# margin 4; the traces of the spike phases.
SPIKE_BATCH, SPIKE_WINDOW, SPIKE_MARGIN = 20, 4096, 4
SPIKE_TRACES, SPIKE_LEN, SPIKE_EPOCHS = 200, 30011, 2
GLM_EPOCHS = 300
# The flow kernels' latency bounds (csrc/flows.cu) at the H100's 1.98 GHz
# boost clock: a dependent L2 hit, about 260 cycles in published
# microbenchmarks, for each Euler step; a barrier, a shared-memory read and
# nine dependent float64 adds, about 200 cycles, for each diffusion step.
L2_HIT_S = 260 / 1.98e9
DIFFUSE_STEP_S = 200 / 1.98e9


class _LogArgs:
    """Collect the arguments of a logger's records inside a ``with``."""

    def __init__(self, name):
        import logging

        self.logger = logging.getLogger(name)
        self.records = []
        self.handler = logging.Handler()
        self.handler.emit = self.records.append

    def __enter__(self):
        import logging

        self.level = self.logger.level
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def phase_device():
    from deepcalcium_torch.utils.device import require_cuda

    dev = require_cuda()
    name = card_line(dev)
    print(f"device: {name}", flush=True)
    return dev, name


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
            p1 = timed_ms(lambda: movie_summary(movie), 5)
            k1 = timed_ms(lambda: movie_summary_cuda(movie), 20)
            k2 = timed_ms(lambda: movie_summary_cuda(movie), 20)
            p2 = timed_ms(lambda: movie_summary(movie), 5)
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
    pmask, pprob = make_summary_evaluator(model, (WINDOW, WINDOW),
                                          window=(WINDOW, WINDOW))(plain_mean)
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
    evaluate = make_movie_evaluator(model, movie.shape, window=(WINDOW, WINDOW))
    views = torch.zeros((8, WINDOW, WINDOW), device=dev)
    with torch.inference_mode():
        ms = timed_ms(lambda: evaluate(movie), 10)
        fwd_ms = timed_ms(lambda: model(views), 10)
    k1_ms = timed_ms(lambda: movie_summary_cuda(movie), 10)
    flops = 8 * forward_flops(WINDOW, WINDOW, NFB)
    print(f"main path time: evaluate {ms:.3f} ms ({t / ms * 1e3:.1f} "
          f"frames/s); of which K1 alone {k1_ms:.3f} ms and the 8-view "
          f"forward alone {fwd_ms:.3f} ms ({flops / fwd_ms / 1e9:.1f} "
          f"TFLOP/s bf16); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches, ms, {"movie": movie, "params": params, "state": state,
                          "mask": mask, "prob": prob, "truth": truth}


# Metrics of the train-step goldens that round no prediction.
UNROUNDED_METRICS = ("loss", "dicesq", "ytspks")


def assert_matches_golden(gold, metrics, grads, params, state,
                          rounded_atol=2e-3):
    """The train-step goldens' tolerances (``tests/test_torch_train.py`` and
    ``tests/test_torch_unet1d.py`` hold the CPU to them too):
    - the unrounded metrics (loss, dicesq, ytspks): rtol 1e-4;
    - the rounded metrics: atol ``rounded_atol``; 2e-3 for the 2-D golden,
      one pixel of the 2048 crossing 0.5; 0 for the 1-D golden, whose
      probabilities stay off 0.5 (its writer checks);
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
    names = sorted(k.split("/", 1)[1] for k in gold if k.startswith("metrics/"))
    if names != sorted(metrics[0]):
        raise AssertionError(f"metrics {sorted(metrics[0])} != golden {names}")
    for k in names:
        got = np.array([m[k] for m in metrics], np.float32)
        exact = k in UNROUNDED_METRICS
        np.testing.assert_allclose(got, gold[f"metrics/{k}"],
                                   rtol=1e-4 if exact else 0,
                                   atol=0 if exact else rounded_atol, err_msg=k)
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

    truths = {name: mask_summary_exact(masks[name]) for name in movies}

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
        mask_summary_func=truths.__getitem__,
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
        # The trained net, before evaluate_movie builds its own inference
        # net through the same net_func.
        net = nets[-1]
        name = list(movies)[0]
        mask, prob = wrapper.evaluate_movie(movies[name], model_path=best,
                                            window_shape=(WINDOW, WINDOW))
        if mask.shape != (WINDOW, WINDOW) or not np.isfinite(prob).all():
            raise AssertionError("evaluate_movie of the best checkpoint failed")

        if len(nets) != 2 or nets[-1] is net:
            raise AssertionError("evaluate_movie did not build its net "
                                 "through net_func")
        # Steady state of the same train step, with CUDA events, and the
        # validation alone on the summaries fit used.
        S = [series_summary(n) for n in movies]
        M = [truths[n] for n in movies]
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
        step_ms = timed_ms(lambda: step(xb, yb, gen), 20)
        device_ms, step_kernels, top = device_time_per_call(
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
    return launches, numbers, {"movies": movies, "masks": masks,
                               "truths": truths}


# --- The dataset-file inference path: fold, streaming, tiled, predict ------

FOLD_CHUNK = 256      # the default chunk of the streaming and tiled evaluates
TILED_FRAMES, TILED_SIDE = 1000, 1024


def _poison(dtype):
    import torch

    return (torch.finfo(dtype).max if dtype.is_floating_point
            else torch.iinfo(dtype).max)


def check_fold(dev, movie, chunk, misaligned=False):
    """Fold ``movie`` (on the card) through one fixed-size staging buffer
    whose frames past n_valid hold the dtype's maximum, with K1's fold and
    with the plain fold, and hold both against one K1 call. Integer movies:
    totals equal and the mean bitwise K1's; float32: within 1 ulp. Maxima
    equal. Returns the largest absolute error of the mean."""
    import numpy as np
    import torch

    from deepcalcium_torch.ops.summary import (finalise_fold,
                                               fold_accumulators, movie_fold,
                                               movie_fold_cuda,
                                               movie_summary_cuda)

    t = movie.shape[0]
    shape = (chunk,) + tuple(movie.shape[1:])
    if misaligned:
        # A contiguous view 2 bytes past a 16-byte boundary: scalar loads.
        flat = torch.empty(math.prod(shape) + 1, dtype=movie.dtype, device=dev)
        stage = flat[1:].view(shape)
    else:
        stage = torch.empty(shape, dtype=movie.dtype, device=dev)
    k_total, k_max = fold_accumulators(shape[1:], movie.dtype, dev)
    p_total, p_max = fold_accumulators(shape[1:], movie.dtype, dev)
    for i in range(0, t, chunk):
        n = min(chunk, t - i)
        stage[:n].copy_(movie[i:i + n])
        stage[n:].fill_(_poison(movie.dtype))
        movie_fold_cuda(stage, n, k_total, k_max)
        movie_fold(stage, n, p_total, p_max)
    mean = finalise_fold(k_total, t)
    ref_mean, ref_max = movie_summary_cuda(movie)
    torch.cuda.synchronize()
    if not (torch.equal(k_max, p_max) and torch.equal(k_max, ref_max)):
        raise AssertionError(f"fold max differs: {movie.dtype} {tuple(movie.shape)}")
    if movie.dtype.is_floating_point:
        np.testing.assert_array_max_ulp(mean.cpu().numpy(),
                                        ref_mean.cpu().numpy(), maxulp=1)
        np.testing.assert_array_max_ulp(
            finalise_fold(p_total, t).cpu().numpy(), ref_mean.cpu().numpy(),
            maxulp=1)
    elif not (torch.equal(k_total, p_total) and torch.equal(mean, ref_mean)):
        raise AssertionError(f"fold not bitwise K1's: {movie.dtype} "
                             f"{tuple(movie.shape)}")
    return (mean - ref_mean).abs().max().item()


def phase_fold(dev, seed):
    """K1's fold against the plain fold and one K1 call; then its time on
    one 256x512^2 int16 chunk beside the plain fold's and its bound."""
    import torch

    from deepcalcium_torch.ops.summary import (fold_accumulators, movie_fold,
                                               movie_fold_cuda)

    g = torch.Generator(device=dev).manual_seed(seed + 8)

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32).to(dtype)

    cases = [
        ("int16", lambda: ints(-2000, 30000, (FRAMES, WINDOW, WINDOW), torch.int16), FOLD_CHUNK, False),
        ("uint16", lambda: ints(0, 65536, (FRAMES, WINDOW, WINDOW), torch.uint16), FOLD_CHUNK, False),
        ("float32", lambda: torch.rand((FRAMES, WINDOW, WINDOW), generator=g,
                                       device=dev) * 4000 - 2000, FOLD_CHUNK, False),
        ("int16 misaligned base", lambda: ints(-100, 3000, (301, 64, 72), torch.int16), 64, True),
        ("int16 H*W tail", lambda: ints(-100, 3000, (77, 19, 137), torch.int16), 16, False),
        ("uint16 H*W tail, misaligned", lambda: ints(0, 65536, (45, 9, 131), torch.uint16), 8, True),
        ("float32 H*W tail", lambda: torch.randn((33, 13, 29), generator=g, device=dev) * 100, 7, False),
    ]
    worst = 0.0
    for label, make, chunk, misaligned in cases:
        movie = make()
        err = check_fold(dev, movie, chunk, misaligned)
        worst = max(worst, err)
        print(f"fold {label} {tuple(movie.shape)} in chunks of {chunk} "
              f"(tail {movie.shape[0] % chunk or chunk}, staging poisoned past "
              f"n_valid): K1 fold = plain fold = one K1 call "
              f"({'1 ulp' if movie.dtype.is_floating_point else 'bitwise'}), "
              f"mean max_abs_err {err:.3g}", flush=True)
        del movie
        torch.cuda.empty_cache()

    chunk = ints(0, 2000, (FOLD_CHUNK, WINDOW, WINDOW), torch.int16)
    total, mx = fold_accumulators((WINDOW, WINDOW), torch.int16, dev)
    p1 = timed_ms(lambda: movie_fold(chunk, FOLD_CHUNK, total, mx), 10)
    k1 = timed_ms(lambda: movie_fold_cuda(chunk, FOLD_CHUNK, total, mx), 50)
    k2 = timed_ms(lambda: movie_fold_cuda(chunk, FOLD_CHUNK, total, mx), 50)
    p2 = timed_ms(lambda: movie_fold(chunk, FOLD_CHUNK, total, mx), 10)
    # The chunk read once; the int64 totals and the f32 max read and written.
    nbytes = chunk.numel() * 2 + WINDOW * WINDOW * 2 * (8 + 4)
    timing = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
              "shape": list(chunk.shape)}
    print(f"fold time, one {tuple(chunk.shape)} int16 chunk: K1 fold "
          f"{timing['ms']:.4f} ms ({nbytes / timing['ms'] / 1e6:.1f} GB/s), "
          f"plain {timing['plain_ms']:.4f} ms; bound {timing['bound_ms']:.4f} "
          f"ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s)", flush=True)
    return worst, timing


def phase_stream(dev, main):
    """``evaluate_movie_streaming`` of the phase-5 movie held as a host
    array: its mean bitwise K1's, its mask and prob equal to
    ``evaluate_movie`` on the device copy; then its time, and the times of
    its copies alone."""
    import numpy as np
    import torch

    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary
    from deepcalcium_torch.ops.summary import (fold_accumulators,
                                               movie_fold_cuda,
                                               movie_summary_cuda)
    from deepcalcium_torch.train.evaluate import evaluate_movie_streaming

    host = main["host"] = main["movie"].cpu().numpy()
    model = UNet2DSummary(compute_dtype=torch.bfloat16)._inference_net(
        main["params"], main["state"], (WINDOW, WINDOW), "auto")
    torch.backends.cudnn.deterministic = True
    movie_fold_cuda.launches = movie_summary_cuda.launches = 0
    mask, prob, mean = evaluate_movie_streaming(
        model, host, window=(WINDOW, WINDOW), chunk=FOLD_CHUNK, device=dev)
    launches = movie_fold_cuda.launches
    if launches != math.ceil(FRAMES / FOLD_CHUNK) or movie_summary_cuda.launches:
        raise AssertionError(f"streaming evaluate launched K1's fold "
                             f"{launches} times")
    k1_mean, _ = movie_summary_cuda(main["movie"])
    if not np.array_equal(mean, k1_mean.cpu().numpy()):
        raise AssertionError("streaming mean is not K1's, bit for bit")
    if not (np.array_equal(mask, main["mask"]) and np.array_equal(prob, main["prob"])):
        raise AssertionError("streaming mask/prob differ from evaluate_movie")
    torch.backends.cudnn.deterministic = False

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_movie_streaming(model, host, window=(WINDOW, WINDOW),
                                 chunk=FOLD_CHUNK, device=dev)
        runs.append((time.perf_counter() - t0) * 1e3)
    # Its copies alone: pageable -> pinned on the host clock, pinned ->
    # device and the folds by CUDA events.
    chunk_shape = (FOLD_CHUNK, WINDOW, WINDOW)
    pinned = torch.empty(chunk_shape, dtype=torch.int16, pin_memory=True)
    staged = torch.empty(chunk_shape, dtype=torch.int16, device=dev)
    src = torch.from_numpy(host)
    t0 = time.perf_counter()
    for i in range(0, FRAMES, FOLD_CHUNK):
        n = min(FOLD_CHUNK, FRAMES - i)
        pinned[:n].copy_(src[i:i + n])
    stage_ms = (time.perf_counter() - t0) * 1e3
    h2d_ms = timed_ms(lambda: [staged.copy_(pinned, non_blocking=True)
                                for _ in range(0, FRAMES, FOLD_CHUNK)], 3)
    total, _ = fold_accumulators((WINDOW, WINDOW), torch.int16, dev,
                                 track_max=False)
    fold_ms = timed_ms(lambda: [movie_fold_cuda(staged, FOLD_CHUNK, total)
                                 for _ in range(0, FRAMES, FOLD_CHUNK)], 3)
    numbers = {"ms": runs, "pageable_to_pinned_ms": stage_ms,
               "host_to_device_ms": h2d_ms, "folds_ms": fold_ms,
               "host_bytes": host.nbytes}
    print(f"streaming evaluate of the phase-5 movie as a host array, chunk "
          f"{FOLD_CHUNK}: K1 fold launches {launches}; mean bitwise K1's, "
          f"mask/prob equal to evaluate_movie on the device copy; "
          f"{', '.join(f'{r:.1f}' for r in runs)} ms; alone: pageable->pinned "
          f"{stage_ms:.1f} ms ({host.nbytes / stage_ms / 1e6:.1f} GB/s), "
          f"pinned->device {h2d_ms:.1f} ms ({host.nbytes / h2d_ms / 1e6:.1f} "
          f"GB/s), {math.ceil(FRAMES / FOLD_CHUNK)} folds {fold_ms:.3f} ms",
          flush=True)
    return launches, numbers


def straightforward_tiled_prob(model, movie, window):
    """The tiled evaluate written out plainly: the plain summary, the
    host z-norm, each window tile's 8 dihedral views through the net one
    tile at a time, each view inverted, the 8 averaged, and the tiles'
    overlaps averaged."""
    import numpy as np
    import torch

    from deepcalcium_torch.ops.summary import movie_summary

    m = movie_summary(movie)[0].cpu().numpy()
    z = (m - np.mean(m)) / max(float(np.std(m)), 1e-12)
    h, w = z.shape
    overlap = min(64, window // 2)

    def starts(n):
        return sorted(set(range(0, n - window + 1, window - overlap)) | {n - window})

    acc = np.zeros((h, w))
    cnt = np.zeros((h, w))
    for y in starts(h):
        for x in starts(w):
            tile = z[y:y + window, x:x + window]
            views = ([np.rot90(tile, k) for k in range(4)]
                     + [np.rot90(tile.T, k) for k in range(4)])
            with torch.inference_mode():
                p = model(torch.from_numpy(np.ascontiguousarray(views)).to(movie.device))
            p = p.cpu().numpy()
            back = ([np.rot90(p[k], -k) for k in range(4)]
                    + [np.rot90(p[4 + k], -k).T for k in range(4)])
            acc[y:y + window, x:x + window] += np.mean(back, axis=0)
            cnt[y:y + window, x:x + window] += 1
    return (acc / cnt).astype(np.float32)


def phase_tiled(dev, main, seed):
    """``UNet2DSummary.evaluate_movie`` on a host int16 movie of
    1000x1024x1024: a 3x3 grid of 512^2 tiles at overlap 64, 72 views.
    Checked at float32 with TF32 off against the fused path on a 512^2
    movie and against a straightforward composition on the 1024^2 one;
    timed at bfloat16."""
    import numpy as np
    import torch

    from deepcalcium_torch.models.unet2d import from_jax_params
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary
    from deepcalcium_torch.ops.summary import movie_fold_cuda, movie_summary_cuda
    from deepcalcium_torch.train.evaluate import (evaluate_movie_tiled,
                                                  make_movie_evaluator,
                                                  tile_grid)

    m5 = main["movie"][:TILED_FRAMES]
    top = torch.cat([m5, m5.flip(2)], dim=2)
    movie = torch.cat([top, top.flip(1)], dim=1).contiguous()   # 1000x1024^2
    host = movie.cpu().numpy()
    params, state = main["params"], main["state"]
    ys, xs = tile_grid((TILED_SIDE, TILED_SIDE), (WINDOW, WINDOW))
    nviews = 8 * len(ys) * len(xs)

    wrapper = UNet2DSummary(compute_dtype=torch.bfloat16)
    movie_fold_cuda.launches = movie_summary_cuda.launches = 0
    mask, prob = wrapper.evaluate_movie(host, params=params, state=state,
                                        window_shape=(WINDOW, WINDOW))
    launches = movie_fold_cuda.launches
    if launches != math.ceil(TILED_FRAMES / FOLD_CHUNK) or movie_summary_cuda.launches:
        raise AssertionError(f"tiled evaluate launched K1's fold {launches} times")
    if mask.shape != (TILED_SIDE, TILED_SIDE) or not np.isfinite(prob).all() \
            or not set(np.unique(mask)) <= {0, 1}:
        raise AssertionError("tiled evaluate: bad shape, non-finite prob or "
                             "non-binary mask")
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wrapper.evaluate_movie(host, params=params, state=state,
                               window_shape=(WINDOW, WINDOW))
        runs.append((time.perf_counter() - t0) * 1e3)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        f32 = from_jax_params(params, state, device=dev).eval().fold()
        # (a) one tile: the tiled path on the 512^2 movie = the fused path.
        tmask, tprob, _ = evaluate_movie_tiled(
            f32, main["movie"], window=(WINDOW, WINDOW), chunk=FOLD_CHUNK,
            device=dev)
        fmask, fprob, _ = make_movie_evaluator(
            f32, main["movie"].shape, window=(WINDOW, WINDOW))(main["movie"])
        fprob = fprob.cpu().numpy()
        # rtol 1e-4, atol 1e-5: float32 sums in another order (another
        # batch, so other cuDNN algorithms).
        np.testing.assert_allclose(tprob, fprob, rtol=1e-4, atol=1e-5,
                                   err_msg="tiled vs fused at 512^2")
        far = np.abs(fprob - 0.5) >= 1e-4
        if not np.array_equal(tmask[far], fmask.cpu().numpy()[far]):
            raise AssertionError("tiled mask differs from the fused one at 512^2")
        # (b) 1024^2: the tiled path = the straightforward composition.
        _, tprob2, _ = evaluate_movie_tiled(f32, host, window=(WINDOW, WINDOW),
                                            chunk=FOLD_CHUNK, device=dev)
        want = straightforward_tiled_prob(f32, movie, WINDOW)
        np.testing.assert_allclose(tprob2, want, rtol=1e-4, atol=1e-5,
                                   err_msg="tiled vs straightforward at 1024^2")
        err = (float(np.abs(tprob - fprob).max()),
               float(np.abs(tprob2 - want).max()))
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.deterministic = False
    numbers = {"ms": runs, "views": nviews, "grid": [len(ys), len(xs)],
               "f32_max_abs_err_vs_fused_512": err[0],
               "f32_max_abs_err_vs_straightforward_1024": err[1],
               "mask_fraction": float(mask.mean())}
    print(f"tiled evaluate, host int16 {tuple(host.shape)}, {len(ys)}x{len(xs)} "
          f"tiles, {nviews} views, bf16: K1 fold launches {launches}; "
          f"{', '.join(f'{r:.1f}' for r in runs)} ms; f32 TF32 off: tiled = "
          f"fused at 512^2 (prob max_abs_err {err[0]:.3g}), tiled = "
          f"straightforward at 1024^2 ({err[1]:.3g}), rtol 1e-4 atol 1e-5",
          flush=True)
    return launches, numbers, movie


def phase_predict(dev, main, tiled_movie):
    """``UNet2DSummary.predict(augmentation=True)`` through the injection
    points, from a checkpoint of the phase-5 weights: eight 512^2
    summaries, one 498x467 (reflect-padded) and one 1024^2 (tiled); then
    ``nf_submit`` and its file read back. The random net puts nearly every
    pixel above 0.5, so predict thresholds at the 98th percentile of phase
    5's prob: the masks then hold many regions, and the submission stays
    small. Then ``check_custom_net``."""
    import re

    import numpy as np
    import torch

    from deepcalcium_torch.data.nf import nf_submit
    from deepcalcium_torch.metrics.neurofinder import label_mask
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary
    from deepcalcium_torch.ops.summary import movie_summary_cuda
    from deepcalcium_torch.train.checkpoints import save_checkpoint

    def znorm(mean):
        z = (mean - mean.mean()) / mean.std(correction=0).clamp_min(1e-12)
        return z.cpu().numpy()

    base = znorm(movie_summary_cuda(main["movie"])[0])
    S = {f"neurofinder.0{k}.00": np.ascontiguousarray(
        np.rot90(base, k % 4) if k < 4 else np.rot90(base.T, k % 4))
        for k in range(8)}
    S["neurofinder.08.00"] = np.ascontiguousarray(base[7:505, 31:498])
    S["neurofinder.09.00.test"] = znorm(movie_summary_cuda(tiled_movie)[0])

    out = REPO / "build" / "chip_smoke_predict"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ckpt = str(out / "unet2ds_random.ckpt")
    save_checkpoint(ckpt, main["params"], main["state"])
    threshold = float(np.quantile(main["prob"], 0.98))
    with _LogArgs("predict_forward") as records:
        wrapper = UNet2DSummary(cpdir=str(out), compute_dtype=torch.bfloat16,
                                dataset_name_func=lambda n: n,
                                series_summary_func=lambda n: S[n])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Mp, names = wrapper.predict(list(S), ckpt, window_shape=(WINDOW, WINDOW),
                                    augmentation=True, threshold=threshold)
        predict_s = time.perf_counter() - t0
    views_per_s = float(re.search(r"\(([\d.]+) views/s\)",
                                  records[-1].getMessage()).group(1))
    if names != list(S) or [m.shape for m in Mp] != [s.shape for s in S.values()]:
        raise AssertionError("predict returned the wrong names or shapes")
    # The identity view of the phase-5 summary against phase 5's own
    # evaluate: bf16 forwards at another batch size (other cuDNN
    # algorithms), so pixels may differ only where phase 5's prob lies
    # within 0.02 (5 bf16 steps near 0.5) of the threshold.
    differ = Mp[0] != (main["prob"] > threshold)
    if (differ & (np.abs(main["prob"] - threshold) >= 0.02)).any():
        raise AssertionError("predict's mask differs from evaluate_movie's "
                             "away from the threshold")

    sub_path = out / "submission.json"
    nf_submit(Mp, names, str(sub_path))
    with open(sub_path) as fp:
        sub = json.load(fp)
    if [e["dataset"] for e in sub] != [n.split(".", 1)[1] for n in names]:
        raise AssertionError("submission datasets differ")
    regions = []
    for e, mp in zip(sub, Mp):
        nb = int(label_mask(mp).max())
        want = nb if nb else 1
        if len(e["regions"]) != want or (nb == 0 and e["regions"] != [{"coordinates": [[0, 0]]}]):
            raise AssertionError(f"submission {e['dataset']}: "
                                 f"{len(e['regions'])} regions, want {want}")
        regions.append(len(e["regions"]))
    custom = check_custom_net(dev, main, S, ckpt, out, threshold)
    views = 8 * 9 + 8 * 9
    lo, hi = np.quantile(main["prob"], [0.05, 0.95])
    print(f"predict 8x TTA through the injection points, 8 summaries at "
          f"512^2 + 498x467 + 1024^2 tiled ({views} views), threshold "
          f"{threshold:.4f} (phase 5's prob spans {lo:.4f}-{hi:.4f}, 5th-95th "
          f"percentile): {views_per_s:.1f} views/s in its forward, "
          f"{predict_s:.2f} s the call; submission of {len(sub)} datasets "
          f"read back, regions {regions}; mask differs from evaluate_movie's "
          f"on {differ.mean():.4%} of pixels, all within 0.02 of the "
          f"threshold", flush=True)
    return {"views_per_s": views_per_s, "views": views,
            "seconds": predict_s, "threshold": threshold, "regions": regions,
            "mask_differs_from_evaluate": float(differ.mean()),
            "custom_net": custom}


def check_custom_net(dev, main, S, ckpt, out, threshold, band=0.02):
    """A ``UNet2DS`` subclass that counts its forwards, passed as
    ``net_func``, runs in ``predict(augmentation=True)`` and in
    ``evaluate_movie`` of the phase-5 movie: unfolded under "auto", its
    masks the stock wrapper's ``fast=False`` masks except within ``band``
    of the threshold; folded at ``fast=True``."""
    import functools

    import numpy as np
    import torch

    from deepcalcium_torch.models import unet_2d_summary as summ
    from deepcalcium_torch.models.unet2d import UNet2DS

    class CountingUNet2DS(UNet2DS):
        calls = 0

        def forward(self, x, *a, **kw):
            type(self).calls += 1
            return super().forward(x, *a, **kw)

    def wrapper(net_func):
        return summ.UNet2DSummary(
            cpdir=str(out), compute_dtype=torch.bfloat16,
            dataset_name_func=lambda n: n, series_summary_func=lambda n: S[n],
            net_func=net_func, device=dev)

    window = (WINDOW, WINDOW)
    custom = wrapper(functools.partial(CountingUNet2DS, nfb=NFB))
    stock = wrapper(UNet2DS)

    def predict(model, thr, fast):
        return model.predict(list(S), ckpt, window_shape=window,
                             augmentation=True, threshold=thr, fast=fast)[0]

    def evaluate(model, fast):
        return model.evaluate_movie(main["movie"], model_path=ckpt,
                                    window_shape=window, threshold=threshold,
                                    fast=fast)

    calls, folds, got = {}, {}, {}
    for fast in ("auto", True):
        CountingUNet2DS.calls = 0
        with _LogArgs(summ.__name__) as records:
            got[fast] = (predict(custom, threshold, fast),
                         evaluate(custom, fast))
        calls[fast] = CountingUNet2DS.calls
        folds[fast] = sum("folded inference forward" in r.getMessage()
                          for r in records)
    if calls["auto"] < 2 or folds["auto"] or calls[True] < 2 \
            or folds[True] != 2:
        raise AssertionError(f"custom net: forwards {calls}, fold logs "
                             f"{folds}; want unfolded under 'auto' and "
                             f"folded at fast=True, counted in both")
    # The stock unfolded net's masks at the threshold and at the band's
    # edges: pixels above threshold + band and below threshold - band in
    # the stock masks must be so in the custom net's.
    want = predict(stock, threshold, False)
    above = predict(stock, threshold + band, False)
    below = predict(stock, threshold - band, False)
    mp = got["auto"][0]
    if any(((a > m) | (m > b)).any() for m, a, b in zip(mp, above, below)):
        raise AssertionError("custom-net predict masks differ from the stock "
                             "unfolded net's away from the threshold")
    wmask, wprob = evaluate(stock, False)
    mask, prob = got["auto"][1]
    ev_differ = mask != wmask
    if (ev_differ & (np.abs(wprob - threshold) >= band)).any():
        raise AssertionError("custom-net evaluate_movie mask differs from "
                             "the stock unfolded net's away from the "
                             "threshold")
    numbers = {
        "forwards": calls, "fold_logs": folds,
        "predict_differ": sum(int((m != w).sum()) for m, w in zip(mp, want)),
        "evaluate_differ": int(ev_differ.sum()),
        "evaluate_max_prob_diff": float(np.abs(prob - wprob).max()),
        "fast_true_predict_differ_fraction": float(np.mean(
            [(m != w).mean() for m, w in zip(got[True][0], want)]))}
    print(f"custom net_func (a counting UNet2DS subclass, nfb={NFB} bf16): "
          f"predict 8x TTA and evaluate_movie under 'auto' ran it unfolded "
          f"({calls['auto']} forwards, no fold log), at fast=True folded "
          f"({calls[True]} forwards, {folds[True]} fold logs); against the "
          f"stock fast=False net {numbers['predict_differ']} predict pixels "
          f"and {numbers['evaluate_differ']} evaluate pixels differ, none "
          f"outside {band} of the threshold, largest evaluate prob "
          f"difference {numbers['evaluate_max_prob_diff']:.3g}; folded masks "
          f"differ from those on "
          f"{numbers['fast_true_predict_differ_fraction']:.4%}", flush=True)
    return numbers


# --- The spike path: UNet1D, its wrapper, the GLM/STM baselines ------------

def phase_golden1d(dev):
    import numpy as np
    import torch

    from deepcalcium_torch.models.unet1d import from_jax_params
    from deepcalcium_torch.train.checkpoints import read_checkpoint

    gold = REPO / "tests" / "golden"
    data = np.load(gold / "golden_io.npz")
    raw = read_checkpoint(str(gold / "unet1d_tiny.ckpt"))
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = from_jax_params(raw["params"], raw["state"], device=dev,
                                margin=4).eval()
        with torch.inference_mode():
            y = model(torch.from_numpy(data["x1"]).to(dev)).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    np.testing.assert_allclose(y, data["y1"], rtol=1e-4, atol=1e-6,
                               err_msg="golden y1")
    err = float(np.abs(y - data["y1"]).max())
    print(f"golden tiny UNet1D, f32 with TF32 off: max_abs_err {err:.3g}, "
          f"rtol=1e-4 atol=1e-6", flush=True)
    return err


def first_max_grad_1d(z, ct, window, stride, pad_lo=0, pad_hi=0):
    """Numpy oracle of a 1-D max-pool's gradient on (B, C, T) ``z``: each
    output's cotangent goes to the first maximum of its window (the
    padding holds -inf), and overlapping windows add up in float32 in
    output order, as PyTorch's max-pool backward sums them."""
    import numpy as np

    zp = np.pad(z, ((0, 0), (0, 0), (pad_lo, pad_hi)),
                constant_values=-np.inf)
    win = np.lib.stride_tricks.sliding_window_view(zp, window, axis=-1)
    win = win[..., ::stride, :]
    first = np.argmax(win == win.max(axis=-1, keepdims=True), axis=-1)
    g = np.zeros(zp.shape, np.float32)
    b, c, n = first.shape
    for j in range(n):
        bi, ci = np.meshgrid(np.arange(b), np.arange(c), indexing="ij")
        np.add.at(g, (bi, ci, j * stride + first[:, :, j]), ct[:, :, j])
    return g[:, :, pad_lo:zp.shape[-1] - pad_hi]


def tied_1d_input(rng, shape):
    """ReLU'd (B, C, T) activations with forced equal pairs, a constant
    stretch and a zero-filled tail (as the batch generator writes for a
    trace shorter than the window)."""
    import numpy as np

    z = np.maximum(rng.standard_normal(shape), 0).astype(np.float32)
    z[..., 0::4] = z[..., 1::4]
    z[0, :, 5:20] = 1.5
    z[-1, :, -12:] = 0.0
    return z


def check_1d_tie_routing(dev, dtype):
    """pool2 and the margin head (windows 1..8) route tied gradients to
    each window's first maximum, as the JAX package does (held there on
    the CPU by ``tests/test_torch_unet1d.py``)."""
    import numpy as np
    import torch

    from deepcalcium_torch.models import blocks

    rng = np.random.default_rng(7)
    z = tied_1d_input(rng, (3, 4, 64))
    cases = [("pool2", blocks.pool2, 2, 2, 0, 0)]
    for w in (1, 2, 3, 4, 5, 8):
        lo = (w - 1) // 2
        cases.append((f"head w={w}", lambda t, w=w: blocks.maxpool1d_same(t, w),
                      w, 1, lo, w - 1 - lo))
    for label, fn, window, stride, lo, hi in cases:
        zt = torch.from_numpy(z).to(dev, dtype).requires_grad_()
        out = fn(zt)
        # Nonzero small integers: every sum of them is exact in any order
        # and precision, so only the routing is compared.
        ct = torch.from_numpy((rng.integers(1, 4, tuple(out.shape)) * rng.choice(
            [-1, 1], tuple(out.shape))).astype(np.float32)).to(dtype)
        out.backward(ct.to(dev))
        zr = zt.detach().float().cpu().numpy()
        want = torch.from_numpy(first_max_grad_1d(
            zr, ct.float().numpy(), window, stride, lo, hi)).to(dtype)
        if not np.array_equal(zt.grad.float().cpu().numpy(),
                              want.float().numpy()):
            raise AssertionError(f"1-D max-pool gradient routing differs from "
                                 f"the first maximum: {label}, {dtype}")


def phase_train_golden1d(dev):
    import numpy as np
    import torch

    from deepcalcium_torch.models.unet1d import (from_jax_params, jax_tree,
                                                 to_jax_params)
    from deepcalcium_torch.ops import losses
    from deepcalcium_torch.train import trainer
    from deepcalcium_torch.train.checkpoints import read_checkpoint

    gold_dir = REPO / "tests" / "golden"
    with np.load(gold_dir / "unet1d_tiny_train_step.npz") as f:
        gold = dict(f)
    raw = read_checkpoint(str(gold_dir / "unet1d_tiny.ckpt"))
    params = dict(raw["params"], head_conv={
        "kernel": raw["params"]["head_conv"]["kernel"], "bias": gold["head_bias"]})
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = from_jax_params(params, raw["state"], device=dev, drp=0.0,
                                margin=int(gold["margin"]))
        opt = trainer.make_optimizer(model, float(gold["lr"]))
        for group in opt.param_groups:
            group["eps"] = float(gold["adam_eps"])
        loss = lambda yt, yp: losses.weighted_binary_crossentropy(yt, yp, 2.0)
        step = trainer.make_train_step(model, loss, opt,
                                       dict(losses.SPIKE_METRICS))
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
    errs = assert_matches_golden(gold, metrics, grads, params3, state3,
                                 rounded_atol=0)
    print("1-D train step vs JAX golden (tiny UNet1D, f32, TF32 off, 3 Adam "
          "steps): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()),
          flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        check_1d_tie_routing(dev, dtype)
    print("1-D tie routing on the card (f32, bf16): pool2 and the margin "
          "head (windows 1-8) send each gradient to its window's first "
          "maximum, as the JAX package", flush=True)
    return errs


def synthetic_spike_traces(seed, rate=0.02):
    """Calcium-like traces, the recipe of ``data/fixtures.make_spikes_hdf5``
    (that module needs h5py): spikes at ``rate`` through an exponential
    decay (tau 8 samples), times 3, plus noise of std 0.15; z-normalised
    per trace as ``get_dataset_traces`` does. Returns (traces float64,
    spikes uint8), both (SPIKE_TRACES, SPIKE_LEN)."""
    import numpy as np

    n, t = SPIKE_TRACES, SPIKE_LEN
    rng = np.random.default_rng(seed)
    spikes = (rng.random((n, t)) < rate).astype(np.uint8)
    kernel = np.exp(-np.arange(40) / 8.0)
    traces = np.stack([np.convolve(s, kernel)[:t] for s in spikes]) * 3.0
    traces += rng.standard_normal((n, t)) * 0.15
    traces = (traces - traces.mean(axis=1, keepdims=True)) / traces.std(
        axis=1, keepdims=True)
    return traces, spikes


def phase_fit1d(dev, seed, card):
    """``UNet1DSegmentation.fit`` at the published width through the
    injection points; then the train step alone, timed and profiled."""
    import numpy as np
    import torch

    from deepcalcium_torch.models.unet1d import (UNet1D, forward_flops,
                                                 from_jax_params,
                                                 param_count, to_jax_params)
    from deepcalcium_torch.models import unet_1d_segmentation as seg
    from deepcalcium_torch.ops import losses
    from deepcalcium_torch.ops.summary import movie_fold_cuda, movie_summary_cuda
    from deepcalcium_torch.train import trainer
    from deepcalcium_torch.train.checkpoints import read_checkpoint

    traces, spikes = synthetic_spike_traces(seed + 20)
    name = "synthetic.spikes"
    nets = []

    def net_func(**kw):
        nets.append(UNet1D(nfb=NFB, **kw))
        return nets[-1]

    cpdir = REPO / "build" / "chip_smoke_fit1d"
    shutil.rmtree(cpdir, ignore_errors=True)
    wrapper = seg.UNet1DSegmentation(
        cpdir=str(cpdir), dataset_attrs_func=lambda n: {"name": n},
        dataset_traces_func=lambda n: traces,
        dataset_spikes_func=lambda n: spikes, net_func=net_func,
        compute_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by earlier phases
    movie_summary_cuda.launches = movie_fold_cuda.launches = 0
    t0 = time.perf_counter()
    with _LogArgs(seg.__name__) as records:
        mt, mv, best = wrapper.fit(
            [name], shape=(SPIKE_WINDOW,), error_margin=SPIKE_MARGIN,
            batch=SPIKE_BATCH, nb_epochs=SPIKE_EPOCHS, learning_rate=2e-3,
            seed=seed)
    fit_s = time.perf_counter() - t0
    k1_launches = movie_summary_cuda.launches + movie_fold_cuda.launches
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    epochs = [r for r in records if r.getMessage().startswith("epoch ")]
    epoch_s = [float(r.args[-1]) for r in epochs]
    losses_per_epoch = [float(r.args[1]) for r in epochs]
    n_trn = int(SPIKE_TRACES * 0.8)
    steps = -(-n_trn // SPIKE_BATCH)
    if len(epochs) != SPIKE_EPOCHS or not np.isfinite(losses_per_epoch).all():
        raise AssertionError(f"fit logged {len(epochs)} epochs, losses "
                             f"{losses_per_epoch}")
    if sorted(mt) != sorted(losses.SPIKE_METRICS) or not all(
            np.isfinite(v) for v in list(mt.values()) + list(mv.values())):
        raise AssertionError(f"bad fit metrics {mt} {mv}")
    ckpt = read_checkpoint(best)
    if int(ckpt["opt_state"]["count"]) != steps * (int(ckpt["meta"]["epoch"]) + 1):
        raise AssertionError("best checkpoint has the wrong Adam count")
    init, _ = to_jax_params(UNet1D(nfb=NFB, generator=torch.Generator().manual_seed(seed)))
    if any(np.array_equal(ckpt["params"][k]["kernel"], init[k]["kernel"])
           for k in init if "kernel" in init[k]):
        raise AssertionError("fit left a kernel at its initial value")
    if abs(ckpt["meta"]["val_F2"] - mv["F2"]) > 1e-6:
        raise AssertionError("the reloaded best net does not score its "
                             "checkpoint's val_F2")

    # The train step alone, on one batch of the generator, from the best
    # weights (dropout on, bf16).
    net = from_jax_params(ckpt["params"], ckpt["state"], torch.bfloat16, dev,
                          margin=SPIKE_MARGIN)
    gen = wrapper._batch_gen(list(traces[:n_trn]), list(spikes[:n_trn]),
                             (SPIKE_WINDOW,), SPIKE_BATCH, SPIKE_MARGIN, seed)
    xb, yb = (torch.from_numpy(a).to(dev) for a in next(gen))
    loss = lambda yt, yp: losses.weighted_binary_crossentropy(yt, yp, 2.0)
    step = trainer.make_train_step(net, loss, trainer.make_optimizer(net, 1e-4),
                                   dict(losses.SPIKE_METRICS))
    g = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(3):
        step(xb, yb, g)
    step_ms = timed_ms(lambda: step(xb, yb, g), 20)
    device_ms, step_kernels, top = device_time_per_call(
        lambda: step(xb, yb, g), 5)
    flops = 3 * SPIKE_BATCH * forward_flops(SPIKE_WINDOW, NFB)
    numbers = {
        "params": param_count(net), "val_F2": mv["F2"], "trn_F2": mt["F2"],
        "loss_per_epoch": losses_per_epoch, "epoch_seconds": epoch_s,
        "fit_seconds": fit_s, "train1d_step_ms": step_ms,
        "train1d_step_device_ms": device_ms,
        "train1d_step_kernels": step_kernels,
        "train1d_device_idle": 1.0 - device_ms / step_ms,
        "train1d_tflops": flops / step_ms / 1e9,
        "train1d_mfu": flops / step_ms * 1e3 / BF16_FLOPS_PER_S,
        "windows_per_sec": SPIKE_BATCH / step_ms * 1e3, "peak_gib": peak_gib,
        "k1_launches": k1_launches, "best": Path(best).name}
    print(f"spike fit nfb={NFB} ({numbers['params']} weights) bf16, batch "
          f"{SPIKE_BATCH} x {SPIKE_WINDOW}, margin {SPIKE_MARGIN}, "
          f"{SPIKE_EPOCHS} epochs of {steps} steps on {SPIKE_TRACES} traces "
          f"of {SPIKE_LEN}: loss per epoch "
          f"{[round(v, 4) for v in losses_per_epoch]}; val F2 {mv['F2']:.4f}; "
          f"epoch wall {[round(v, 3) for v in epoch_s]} s; fit "
          f"{fit_s:.2f} s; peak memory {peak_gib:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB earlier phases hold; K1 launches "
          f"{k1_launches}; {card}", flush=True)
    print(f"train1d_step_ms {step_ms:.3f} ({numbers['windows_per_sec']:.1f} "
          f"windows/s, {numbers['train1d_tflops']:.1f} TFLOP/s bf16 at 3x "
          f"forward FLOPs = {numbers['train1d_mfu']:.2%} of 989 TFLOP/s); "
          f"on the device: {step_kernels:.0f} kernels, {device_ms:.3f} ms a "
          f"step, so the card idles {numbers['train1d_device_idle']:.1%}; "
          f"most device time: " + "; ".join(f"{n} {ms:.3f} ms" for n, ms in top)
          + f"; {card}", flush=True)
    shutil.rmtree(cpdir, ignore_errors=True)
    return numbers, {"traces": traces, "spikes": spikes, "ckpt": ckpt,
                     "name": name}


# --- K steps a dispatch: trainer.make_multi_step as one CUDA graph ----------

K_DISPATCH = 4          # steps a dispatch in the checks and the timing
K_EMA = 0.99            # the average the 2-D checks carry
# Steps an epoch of the 2-D perf-preset fit: 20 takes K=4, as 8 steps of
# the 1-D fit (160 training traces at batch 20) do.
PERF_STEPS = 20
# Loss of the graph against the default path over 2 dispatches: see
# phase_multistep.
DEFAULT_PATH_RTOL = 2e-2


def _k_step_case(kind, dev, seed):
    """A net at the published width (bf16, its default dropout) from
    weights drawn from ``seed``, its loss and metrics, and two (K, B, ...)
    slabs of random batches: UNet2DS at 20 @ 128^2, UNet1D at 20 x 4096.
    Its forward reads the rate from ``net.drp``."""
    import functools

    import numpy as np
    import torch

    from deepcalcium_torch.models.unet1d import UNet1D
    from deepcalcium_torch.models.unet2d import UNet2DS
    from deepcalcium_torch.ops import losses as L

    gen = torch.Generator().manual_seed(seed)
    if kind == "2d":
        net = UNet2DS(nfb=NFB, compute_dtype=torch.bfloat16, generator=gen)
        shape = (TRAIN_BATCH, TRAIN_WINDOW, TRAIN_WINDOW)
        loss_fn, metric_fns = L.binary_crossentropy, None
    else:
        net = UNet1D(nfb=NFB, margin=SPIKE_MARGIN, compute_dtype=torch.bfloat16,
                     generator=gen)
        shape = (SPIKE_BATCH, SPIKE_WINDOW)
        loss_fn = functools.partial(L.weighted_binary_crossentropy,
                                    weightpos=2.0)
        metric_fns = dict(L.SPIKE_METRICS)
    rng = np.random.default_rng(seed + 30)
    slabs = []
    for _ in range(2):
        x = rng.standard_normal((K_DISPATCH,) + shape).astype(np.float32)
        y = (rng.random((K_DISPATCH,) + shape) < 0.1).astype(np.float32)
        slabs.append((torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)))
    return net.to(dev), loss_fn, metric_fns, slabs


def _train_state(net, opt, ema):
    """Every tensor a train step changes, by name."""
    out = {f"param.{n}": p for n, p in net.named_parameters()}
    out.update({f"buffer.{n}": b for n, b in net.named_buffers()})
    for n, p in net.named_parameters():
        out.update({f"adam.{n}.{k}": v for k, v in opt.state[p].items()})
    if ema is not None:
        out.update({f"ema.{n}": p for n, p in ema.named_parameters()})
    return out


def _bitwise_diffs(a, b):
    """Names whose tensors differ by a bit."""
    import torch

    return [k for k in a if not torch.equal(a[k].detach(), b[k].detach())]


def phase_multistep(dev, card, seed, fit_ctx, fit_numbers, fit1d_ctx,
                    fit1d_numbers):
    """``trainer.make_multi_step`` at K=4 as one CUDA graph, for both nets at
    the published widths (bf16):

    (a) two dispatches against 8 eager steps of ``make_train_step`` with the
        same capturable optimizer (``make_capturable_``) from the same start,
        cuDNN deterministic, at drp=0 and at the net's default dropout from
        a device generator in the same state: weights, BN buffers, Adam's
        state, the average (2-D, decay 0.99), the (K,) metrics and the
        generator's state equal bit for bit; an lr of 0 set between
        dispatches reaches the graph;
    (b) the same 8 steps through the default K=1 path (the default Adam):
        step 1's loss bit for bit (its forward precedes any update), the
        others within rtol ``DEFAULT_PATH_RTOL``. Capturable Adam forms its
        bias corrections in float32 on the card where the default forms
        them in float64 on the host, and divides in another order: its
        updates differ by a few float32 ulps, so step 2's forward differs
        from the default's by rounding. Its gradients then differ by
        rounding too, and for the conv biases that feed a BN the gradient
        is nothing but rounding: Adam at eps 1e-8 moves each of them by up
        to lr (2e-3) in a direction that rounding sets
        (``tests/test_torch_train.py``). A shift that size moves bf16
        activations of order 1 by about an ulp (2^-8), so from step 2 on
        the losses part at bf16's precision and grow apart with the steps
        (on an NVIDIA H100 80GB HBM3 at 700 W: up to 1e-3 at step 2 and
        8e-3 at step 8). 2e-2
        allows five bf16 ulps; a skipped, repeated or wrong step moves the
        loss by more, as it falls 5-13% a step over these 8;
    (c) the ms a step of the graphed dispatch (CUDA events over 5
        dispatches after warm-up, divided by 4), its device ms and the card's
        idle share from ``torch.profiler`` over one dispatch, the capture's
        seconds (with the first replay) and the
        peak memory of the first dispatch beside the K=1 step's;
    (d) ``fit(preset="perf")`` of each wrapper, 2 epochs: the 2-D fit on
        phase 7's movies (summaries from K1, whose launches it counts), the
        1-D on phase 14's traces; the K each chose and the epoch wall s.
    """
    import gc

    import numpy as np
    import torch

    from deepcalcium_torch.models import unet_1d_segmentation as seg
    from deepcalcium_torch.models import unet_2d_summary as summ
    from deepcalcium_torch.models.unet2d import UNet2DS
    from deepcalcium_torch.models.unet1d import UNet1D
    from deepcalcium_torch.ops.summary import movie_fold_cuda, movie_summary_cuda
    from deepcalcium_torch.train import trainer as T
    from deepcalcium_torch.train.checkpoints import read_checkpoint

    t0 = time.perf_counter()
    K = K_DISPATCH
    numbers, parts = {}, {}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for kind in ("2d", "1d"):
            base, loss_fn, metric_fns, slabs = _k_step_case(kind, dev, seed)
            for drp in (0.0, None):
                t2 = time.perf_counter()
                tag = f"{kind}.{'drp0' if drp == 0.0 else 'dropout'}"
                ema_decay = K_EMA if kind == "2d" else None
                # Graph, eager with the capturable Adam, default path: the
                # same weights (and the same rate) three times.
                nets = [copy.deepcopy(base) for _ in range(3)]
                for n in nets:
                    n.drp = base.drp if drp is None else drp
                emas = [copy.deepcopy(n) if ema_decay else None for n in nets]
                gens = [torch.Generator(device=dev).manual_seed(seed + 7)
                        for _ in nets]
                opts = [T.make_optimizer(n) for n in nets]
                # The graph.
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                multi = T.make_multi_step(nets[0], loss_fn, opts[0], K,
                                          metric_fns, ema=emas[0],
                                          ema_decay=ema_decay)
                t1 = time.perf_counter()
                rows_a = [multi(*slabs[0], gens[0])]
                torch.cuda.synchronize()
                capture_s = time.perf_counter() - t1
                peak_k = (torch.cuda.max_memory_allocated() - held) / 2**30
                rows_a.append(multi(*slabs[1], gens[0]))
                keys = sorted(rows_a[0])
                rows_a = T.metric_rows(rows_a, keys)
                # Eager steps with the same capturable optimizer.
                T.make_capturable_(opts[1])
                eager = T.make_train_step(nets[1], loss_fn, opts[1], metric_fns)
                # The default path.
                plain = T.make_train_step(nets[2], loss_fn, opts[2], metric_fns)
                rows_b, rows_c, peak_1 = [], [], None
                for xs, ys in slabs:
                    for k in range(K):
                        rows_b.append(eager(xs[k], ys[k], gens[1]))
                        if ema_decay:
                            T.ema_update(emas[1].parameters(),
                                         nets[1].parameters(), ema_decay)
                        if peak_1 is None:
                            torch.cuda.synchronize()
                            held = torch.cuda.memory_allocated()
                            torch.cuda.reset_peak_memory_stats()
                        rows_c.append(plain(xs[k], ys[k], gens[2]))
                        if peak_1 is None:
                            torch.cuda.synchronize()
                            peak_1 = (torch.cuda.max_memory_allocated()
                                      - held) / 2**30
                rows_b = T.metric_rows(rows_b, keys)
                rows_c = T.metric_rows(rows_c, keys)
                state_a = _train_state(nets[0], opts[0], emas[0])
                state_b = _train_state(nets[1], opts[1], emas[1])
                diffs = _bitwise_diffs(state_a, state_b)
                if not torch.equal(rows_a, rows_b):
                    diffs.append("metrics")
                if not torch.equal(gens[0].get_state(), gens[1].get_state()):
                    diffs.append("generator")
                if diffs:
                    raise AssertionError(f"{tag}: the graph of {K} steps "
                                         f"differs from eager steps in {diffs}")
                loss_a = rows_a[:, keys.index("loss")].cpu().numpy()
                loss_c = rows_c[:, keys.index("loss")].cpu().numpy()
                rels = np.abs(loss_a - loss_c) / np.abs(loss_c)
                rel = float(rels.max())
                if not (loss_a[0] == loss_c[0] and rel <= DEFAULT_PATH_RTOL
                        and np.isfinite(loss_a).all()):
                    raise AssertionError(f"{tag}: graph losses {loss_a} against "
                                         f"the default path's {loss_c}")
                # An lr set between dispatches reaches the graph.
                T.set_lr(opts[0], 0.0)
                before = {k: v.clone() for k, v in state_a.items()
                          if k.startswith("param.")}
                multi(*slabs[0], gens[0])
                if _bitwise_diffs(before, state_a):
                    raise AssertionError(f"{tag}: lr 0 moved a weight")
                T.set_lr(opts[0], 2e-3)
                rec = {"bitwise": True, "default_path_loss_rtol": rel,
                       "default_path_loss_rel_per_step": rels.tolist(),
                       "capture_s": capture_s, "peak_gib_k4": peak_k,
                       "peak_gib_k1": peak_1}
                if drp is None:
                    # (c) the timing, at the net's default dropout.
                    ms = timed_ms(lambda: multi(*slabs[0], gens[0]), 5) / K
                    # One dispatch: its 6,000-8,000 kernel records take
                    # the profiler seconds to sort.
                    dev_ms, kernels, top = device_time_per_call(
                        lambda: multi(*slabs[0], gens[0]), 1)
                    rec.update(step_ms=ms, device_ms=dev_ms / K,
                               kernels=kernels / K,
                               idle=1.0 - dev_ms / K / ms if kernels else None,
                               top=top)
                numbers[tag] = rec
                del multi, eager, plain, nets, emas, opts, gens
                del state_a, state_b, before
                gc.collect()
                torch.cuda.empty_cache()
                parts[tag] = round(time.perf_counter() - t2, 2)
            del base, slabs
    finally:
        torch.backends.cudnn.deterministic = False
    checks_s = time.perf_counter() - t0

    # (d) fit(preset="perf") of each wrapper.
    movies, truths = fit_ctx["movies"], fit_ctx["truths"]

    def series_summary(name):
        mean, _ = movie_summary_cuda(movies[name])
        return ((mean - mean.mean()) / mean.std(correction=0)).cpu().numpy()

    cpdir = REPO / "build" / "chip_smoke_fit_perf"
    shutil.rmtree(cpdir, ignore_errors=True)
    try:
        wrapper = summ.UNet2DSummary(
            cpdir=str(cpdir / "2d"), dataset_name_func=lambda name: name,
            series_summary_func=series_summary,
            mask_summary_func=truths.__getitem__,
            net_func=lambda **kw: UNet2DS(nfb=NFB, **kw),
            compute_dtype=torch.bfloat16, device=dev)
        movie_summary_cuda.launches = movie_fold_cuda.launches = 0
        t1 = time.perf_counter()
        with _LogArgs(summ.__name__) as records:
            history, best = wrapper.fit(
                list(movies), shape_trn=(TRAIN_WINDOW, TRAIN_WINDOW),
                shape_val=(WINDOW, WINDOW), batch_size_trn=TRAIN_BATCH,
                nb_steps_trn=PERF_STEPS, nb_epochs=FIT_EPOCHS, seed=seed,
                preset="perf")
        fit_s = parts["fit_perf"] = time.perf_counter() - t1
        k1_launches = movie_summary_cuda.launches + movie_fold_cuda.launches
        (k2,) = [r.args[0] for r in records
                 if r.getMessage().startswith("preset='perf'")]
        ckpt = read_checkpoint(best)
        if (k2 != K or k1_launches < 1 or not np.isfinite(history["loss"]).all()
                or int(ckpt["opt_state"]["count"])
                != PERF_STEPS * (int(ckpt["meta"]["epoch"]) + 1)):
            raise AssertionError(f"fit(preset='perf'): K {k2}, K1 launches "
                                 f"{k1_launches}, losses {history['loss']}, "
                                 f"Adam count {ckpt['opt_state']['count']}")
        numbers["fit_perf"] = {"k": k2, "epoch_seconds": history["epoch_seconds"],
                               "loss_per_epoch": history["loss"],
                               "fit_seconds": fit_s, "k1_launches": k1_launches}

        traces, spikes = fit1d_ctx["traces"], fit1d_ctx["spikes"]
        wrapper = seg.UNet1DSegmentation(
            cpdir=str(cpdir / "1d"), dataset_attrs_func=lambda n: {"name": n},
            dataset_traces_func=lambda n: traces,
            dataset_spikes_func=lambda n: spikes,
            net_func=lambda **kw: UNet1D(nfb=NFB, **kw),
            compute_dtype=torch.bfloat16, device=dev)
        t1 = time.perf_counter()
        with _LogArgs(seg.__name__) as records:
            mt, mv, best = wrapper.fit(
                [fit1d_ctx["name"]], shape=(SPIKE_WINDOW,),
                error_margin=SPIKE_MARGIN, batch=SPIKE_BATCH,
                nb_epochs=SPIKE_EPOCHS, seed=seed, preset="perf")
        fit1d_s = parts["fit1d_perf"] = time.perf_counter() - t1
        (k1,) = [r.args[0] for r in records
                 if r.getMessage().startswith(
                     "preset='perf': steps_per_dispatch=")]
        epochs = [r for r in records if r.getMessage().startswith("epoch ")]
        steps = -(-int(SPIKE_TRACES * 0.8) // SPIKE_BATCH)
        ckpt = read_checkpoint(best)
        if (k1 != K or len(epochs) != SPIKE_EPOCHS
                or not all(np.isfinite(v) for v in mt.values())
                or int(ckpt["opt_state"]["count"])
                != steps * (int(ckpt["meta"]["epoch"]) + 1)):
            raise AssertionError(f"spike fit(preset='perf'): K {k1}, {mt}")
        numbers["fit1d_perf"] = {"k": k1, "epoch_seconds": [
            float(r.args[-1]) for r in epochs], "fit_seconds": fit1d_s,
            "val_F2": mv["F2"]}
    finally:
        shutil.rmtree(cpdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    numbers.update(seconds=seconds, checks_seconds=checks_s,
                   part_seconds=parts)
    for kind, k1n, key in (("2d", fit_numbers, "train_step"),
                           ("1d", fit1d_numbers, "train1d_step")):
        r = numbers[f"{kind}.dropout"]
        numbers[f"{key}_k4_ms"] = r["step_ms"]
        k1_ms = k1n[f"{key}_ms"]
        k1_dev = k1n[f"{key}_device_ms"]
        idle = ("not measured" if r["idle"] is None else
                f"{r['idle']:.1%}")
        print(f"{key}_k4_ms {r['step_ms']:.3f} (one CUDA graph of {K} steps: "
              f"{r['device_ms']:.3f} device ms and {r['kernels']:.0f} "
              f"kernels a step, card idle {idle}; capture "
              f"{r['capture_s']:.2f} s; peak {r['peak_gib_k4']:.2f} GiB for "
              f"the first dispatch) against {key}_ms {k1_ms:.3f} "
              f"({k1_dev:.3f} device ms; peak {r['peak_gib_k1']:.2f} GiB a "
              f"step) in this run; {card}", flush=True)
    print(f"multi-step: graph of {K} steps bitwise {K} eager steps (weights, "
          f"BN buffers, Adam, EMA, metrics, generator) for "
          + ", ".join(k for k in numbers if "." in k)
          + "; against the default path, loss within "
          + ", ".join(f"{numbers[k]['default_path_loss_rtol']:.2e}"
                      for k in numbers if "." in k)
          + f" (rtol {DEFAULT_PATH_RTOL}); lr changes reach the graph; "
          f"fit(preset='perf') chose K={numbers['fit_perf']['k']} (2-D, "
          f"epoch wall {[round(v, 2) for v in numbers['fit_perf']['epoch_seconds']]}"
          f" s, K1 launches {numbers['fit_perf']['k1_launches']}) and "
          f"K={numbers['fit1d_perf']['k']} (1-D, epoch wall "
          f"{[round(v, 3) for v in numbers['fit1d_perf']['epoch_seconds']]} s);"
          f" {seconds:.1f} s ({', '.join(f'{k} {v:.2f}' for k, v in parts.items())});"
          f" {card}", flush=True)
    return numbers


# Calls of each spike predict, folded and unfolded in turns: the host's
# share of a call varies from call to call.
PREDICT1D_TURNS = 5


def _is_elementwise(name):
    """PyTorch's pointwise kernels (a bias add, an eval BN pass, a ReLU, a
    cast): ``elementwise_kernel`` and its vectorized and unrolled kin."""
    return "elementwise_kernel" in name


SPLIT_TRACES = 32  # the first slab of the float64 split


def float64_split(net, folded, traces, t, dev):
    """Largest probability difference of (a) the unfolded float32 net, (b)
    the folded float32 net and (c) the folded net cast to float64 from the
    unfolded net's float64 forward, on ``traces`` (padded, (B, T')) on the
    card, cropped to ``t``: once with cuDNN's flags as they stand and once
    with ``cudnn.deterministic``, which is restored after. (c) is the
    fold's own float32 rounding of the weights; (a) and (b) add the float32
    convs."""
    import copy

    import torch

    x32 = torch.from_numpy(traces[:SPLIT_TRACES]).to(dev)
    x64 = x32.double()
    net64, fold64 = (copy.deepcopy(m).double() for m in (net, folded))

    def run():
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = net64(x64)[:, :t]
            torch.cuda.synchronize()
            f64_ms = (time.perf_counter() - t0) * 1e3
            unf, fol = (m(x32)[:, :t].double() for m in (net, folded))
            return {
                "unfolded_f32": (unf - ref).abs().max().item(),
                "folded_f32": (fol - ref).abs().max().item(),
                "folded_f64": (fold64(x64)[:, :t] - ref).abs().max().item(),
                "folded_vs_unfolded_f32": (fol - unf).abs().max().item(),
                "f64_forward_ms": f64_ms}

    deterministic = torch.backends.cudnn.deterministic
    out = {"as_set": run()}
    torch.backends.cudnn.deterministic = True
    try:
        out["deterministic"] = run()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def phase_predict1d(dev, fit_ctx, card, band=1e-4):
    """``UNet1DSegmentation.predict`` of the full-length traces from the
    best checkpoint, bf16 at batch 32: the default (``fast="auto"``, the
    folded net) and ``fast=False`` (the unfolded eval net) timed in turns,
    each with its device profile. At float32 (TF32 off) the folded masks
    equal the unfolded net's, and batch 8 gives batch 32's masks, except
    within ``band`` of the threshold; ``float64_split`` tells what parts
    the two float32 nets' probabilities."""
    import numpy as np
    import torch

    from deepcalcium_torch.models import unet_1d_segmentation as seg
    from deepcalcium_torch.models.unet1d import forward_flops, from_jax_params
    from deepcalcium_torch.ops.summary import movie_fold_cuda, movie_summary_cuda
    from deepcalcium_torch.train.checkpoints import save_checkpoint

    traces, name = fit_ctx["traces"], fit_ctx["name"]
    out = REPO / "build" / "chip_smoke_predict1d"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ckpt = str(out / "unet1d_best.ckpt")
    save_checkpoint(ckpt, fit_ctx["ckpt"]["params"], fit_ctx["ckpt"]["state"])
    padded, t = seg._pad_to_multiple(traces.astype(np.float32), 16)
    if padded.shape != (SPIKE_TRACES, -(-SPIKE_LEN // 16) * 16) or t != SPIKE_LEN:
        raise AssertionError(f"reflect pad gave {padded.shape}")

    def wrapper(dtype):
        return seg.UNet1DSegmentation(
            cpdir=str(out), dataset_attrs_func=lambda n: {"name": n},
            dataset_traces_func=lambda n: traces,
            dataset_spikes_func=lambda n: fit_ctx["spikes"],
            compute_dtype=dtype, device=dev)

    bf16 = wrapper(torch.bfloat16)
    modes = {"folded": "auto", "unfolded": False}
    runs = {m: [] for m in modes}
    masks = {}
    movie_summary_cuda.launches = movie_fold_cuda.launches = 0
    with _LogArgs(seg.__name__) as records:
        for _ in range(PREDICT1D_TURNS):
            for mode, fast in modes.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got, names = bf16.predict([name], ckpt, batch=32, fast=fast)
                runs[mode].append(time.perf_counter() - t0)
                masks[mode] = got[0]
                if names != [name]:
                    raise AssertionError(f"predict returned {names}")
    k1_launches = movie_summary_cuda.launches + movie_fold_cuda.launches
    fold_logs = sum("folded inference forward" in r.getMessage()
                    for r in records)
    if fold_logs != PREDICT1D_TURNS:
        raise AssertionError(f"the default predict folded {fold_logs} of "
                             f"{PREDICT1D_TURNS} times")
    for m in masks.values():
        if m.shape != traces.shape or m.dtype != np.uint8 \
                or not set(np.unique(m)) <= {0, 1}:
            raise AssertionError(f"predict returned {m.shape} {m.dtype}")
    prof = {}
    for mode, fast in modes.items():
        kernels = kernel_table(
            lambda: bf16.predict([name], ckpt, batch=32, fast=fast), 1)
        prof[mode] = {
            "seconds": runs[mode],
            "wall_ms_best": min(runs[mode]) * 1e3,
            "wall_ms_median": float(np.median(runs[mode])) * 1e3,
            "device_ms": sum(ms for _, ms, _ in kernels),
            "kernels": sum(n for _, _, n in kernels),
            "elementwise_ms": sum(ms for k, ms, _ in kernels
                                  if _is_elementwise(k)),
            "elementwise_kernels": sum(n for k, _, n in kernels
                                       if _is_elementwise(k)),
            "top": [(k[:60], ms) for k, ms, _ in kernels[:5]]}
        prof[mode]["device_idle"] = 1.0 - prof[mode]["device_ms"] / prof[
            mode]["wall_ms_best"]

    torch.backends.cudnn.allow_tf32 = False
    try:
        f32 = wrapper(None)
        m8 = f32.predict([name], ckpt, batch=8)[0][0]
        m32 = f32.predict([name], ckpt, batch=32)[0][0]
        mu = f32.predict([name], ckpt, batch=32, fast=False)[0][0]
        net = from_jax_params(fit_ctx["ckpt"]["params"], fit_ctx["ckpt"]["state"],
                              device=dev, margin=SPIKE_MARGIN).eval()
        folded = net.fold()
        with torch.inference_mode():
            probs, probs_f = (torch.cat([
                m(torch.from_numpy(padded[i:i + 32]).to(dev))
                for i in range(0, len(padded), 32)])[:, :t].cpu().numpy()
                for m in (net, folded))
        split = float64_split(net, folded, padded, t, dev)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    near = (np.abs(probs - 0.5) < band) | (np.abs(probs_f - 0.5) < band)
    differ = m8 != m32
    fold_differ = m32 != mu
    if (differ & ~near).any() or (fold_differ & ~near).any() \
            or not np.array_equal(m32[~near], (probs_f > 0.5)[~near]) \
            or not np.array_equal(mu[~near], (probs > 0.5)[~near]):
        raise AssertionError("f32 predict masks differ between batch 8 and "
                             "32 or between the folded and unfolded nets "
                             "away from the threshold")
    max_prob_diff = float(np.abs(probs_f - probs).max())
    m, mu16 = masks["folded"], masks["unfolded"]
    samples = traces.size
    numbers = {"samples_per_sec": [samples / r for r in runs["folded"]],
               "traces": list(traces.shape), "padded_to": padded.shape[1],
               "folded": prof["folded"], "unfolded": prof["unfolded"],
               "f32_batch8_vs_32_differ": int(differ.sum()),
               "f32_fold_vs_unfolded_differ": int(fold_differ.sum()),
               "f32_fold_max_prob_diff": max_prob_diff,
               "f32_within_band": int(near.sum()), "band": band,
               "f64_split": split,
               "bf16_fold_vs_unfolded_differ_fraction": float((m != mu16).mean()),
               "bf16_vs_f32_differ_fraction": float((m != m32).mean()),
               "spike_fraction": float(m.mean()), "k1_launches": k1_launches,
               "tflops": SPIKE_TRACES * forward_flops(
                   padded.shape[1], NFB) / min(runs["folded"]) / 1e12}
    print(f"spike predict bf16 batch 32, {traces.shape[0]} traces of "
          f"{traces.shape[1]} (reflect-padded to {padded.shape[1]}), in "
          f"turns: folded (the default) "
          f"{', '.join(f'{r * 1e3:.1f}' for r in runs['folded'])} ms, "
          f"unfolded (fast=False) "
          f"{', '.join(f'{r * 1e3:.1f}' for r in runs['unfolded'])} ms; "
          f"{max(numbers['samples_per_sec']):.4g} trace-samples/s folded; "
          f"f32 TF32 off: folded vs unfolded {int(fold_differ.sum())} "
          f"samples differ and batch 8 vs 32 {int(differ.sum())}, all within "
          f"{band} of 0.5 ({int(near.sum())} samples there), largest "
          f"probability difference {max_prob_diff:.3g}; bf16 masks folded vs "
          f"unfolded differ on "
          f"{numbers['bf16_fold_vs_unfolded_differ_fraction']:.4%}, folded bf16 "
          f"vs f32 on {numbers['bf16_vs_f32_differ_fraction']:.4%}; K1 "
          f"launches {k1_launches}; {card}", flush=True)
    for flags, d in split.items():
        print(f"spike f32 gap split ({flags}), first {SPLIT_TRACES} padded "
              f"traces against the unfolded net's float64 forward on the "
              f"card: (a) unfolded f32 {d['unfolded_f32']:.3g}, (b) folded "
              f"f32 {d['folded_f32']:.3g}, (c) folded net in float64 (the "
              f"fold's own float32 rounding) {d['folded_f64']:.3g}; folded "
              f"vs unfolded f32 {d['folded_vs_unfolded_f32']:.3g}; the float64 "
              f"forward {d['f64_forward_ms']:.1f} ms; {card}",
              flush=True)
    for mode in modes:
        p = prof[mode]
        print(f"spike predict {mode} on the device: {p['kernels']:.0f} "
              f"kernels, {p['device_ms']:.1f} ms of them a call "
              f"({p['elementwise_ms']:.1f} ms in {p['elementwise_kernels']:.0f} "
              f"elementwise kernels), fastest call {p['wall_ms_best']:.1f} ms "
              f"(median {p['wall_ms_median']:.1f}), "
              f"so the card idles {p['device_idle']:.1%}; most device time: "
              + "; ".join(f"{n} {ms:.2f} ms" for n, ms in p["top"])
              + f"; {card}", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return numbers


def phase_glm(dev, fit_ctx, card):
    """``GLMSegmentation`` fit, predict and ``predict_rates`` for both
    archs on the spike phase's traces; the card's outputs held against the
    same params on the CPU over 4 traces."""
    import numpy as np
    import torch

    from deepcalcium_torch.models import glm_spikes as glm
    from deepcalcium_torch.ops.summary import movie_fold_cuda, movie_summary_cuda
    from deepcalcium_torch.train.checkpoints import read_checkpoint

    traces, spikes, name = fit_ctx["traces"], fit_ctx["spikes"], fit_ctx["name"]
    out = REPO / "build" / "chip_smoke_glm"
    shutil.rmtree(out, ignore_errors=True)
    numbers = {}
    movie_summary_cuda.launches = movie_fold_cuda.launches = 0
    for arch in ("glm", "stm"):
        model = glm.GLMSegmentation(
            cpdir=str(out / arch), arch=arch, dataset_attrs_func=lambda n: {"name": n},
            dataset_traces_func=lambda n: traces,
            dataset_spikes_func=lambda n: spikes, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _LogArgs(glm.__name__) as records:
            mt, mv, path = model.fit([name], nb_epochs=GLM_EPOCHS,
                                     error_margin=SPIKE_MARGIN)
        fit_s = time.perf_counter() - t0
        epoch_ms = [float(r.args[-1]) for r in records
                    if "full-batch epoch" in r.getMessage()]
        if len(epoch_ms) != 1 or not all(np.isfinite(v) for v in mv.values()):
            raise AssertionError(f"{arch} fit: {mv}, {epoch_ms}")
        masks, names = model.predict([name], path)
        if names != [name] or masks[0].shape != traces.shape \
                or masks[0].dtype != np.uint8:
            raise AssertionError(f"{arch} predict returned the wrong output")
        params = {k: torch.from_numpy(np.asarray(v, np.float32))
                  for k, v in read_checkpoint(path)["params"].items()}
        x4 = torch.from_numpy(traces[:4].astype(np.float32))
        if arch == "stm":
            rates = model.predict_rates([name], path)[0][0]
            want = torch.exp(torch.clamp(glm.stm_log_rate(params, x4),
                                         -30.0, 15.0)).numpy()
            if not (np.isfinite(rates).all() and (rates >= 0).all()):
                raise AssertionError("STM rates not finite and >= 0")
            np.testing.assert_allclose(rates[:4], want, rtol=1e-4, atol=1e-7,
                                       err_msg="STM rates, card vs CPU")
            probs = glm.stm_apply(params, x4).numpy()
        else:
            try:
                model.predict_rates([name], path)
            except ValueError:
                pass
            else:
                raise AssertionError("predict_rates accepted a GLM")
            probs = glm.glm_apply(params, x4).numpy()
        far = np.abs(probs - 0.5) >= 1e-4
        if not np.array_equal(masks[0][:4][far], (probs > 0.5)[far]):
            raise AssertionError(f"{arch} masks differ from the CPU's")
        # Where an epoch's time goes: a profile of a 20-epoch fit.
        device_ms, kernels, top = device_time_per_call(
            lambda: model.fit([name], nb_epochs=20, error_margin=SPIKE_MARGIN), 1)
        numbers[arch] = {"epoch_ms": epoch_ms[0], "fit_seconds": fit_s,
                         "val_F2": mv["F2"], "trn_F2": mt["F2"],
                         "spike_fraction": float(masks[0].mean()),
                         "fit20_device_ms": device_ms, "fit20_kernels": kernels,
                         "fit20_top": top}
    k1_launches = movie_summary_cuda.launches + movie_fold_cuda.launches
    numbers["k1_launches"] = k1_launches
    print(f"GLM/STM full-batch fits on {int(SPIKE_TRACES * 0.8)} traces of "
          f"{SPIKE_LEN}, {GLM_EPOCHS} epochs: "
          + "; ".join(f"{a} {numbers[a]['epoch_ms']:.3f} ms an epoch, val F2 "
                      f"{numbers[a]['val_F2']:.4f}" for a in ("glm", "stm"))
          + f"; predict and predict_rates agree with the CPU on 4 traces; "
          f"K1 launches {k1_launches}; {card}", flush=True)
    for a in ("glm", "stm"):
        n = numbers[a]
        print(f"{a} fit of 20 epochs on the device: {n['fit20_kernels']:.0f} "
              f"kernels, {n['fit20_device_ms']:.2f} ms; most device time: "
              + "; ".join(f"{k} {ms:.3f} ms" for k, ms in n["fit20_top"])
              + f"; {card}", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return numbers


# --- Per-frame segmentation, the stencil, the command line ------------------

SEG_FRAMES, SEG_SLAB = 1024, 64
# Timed calls of the 1024-frame movie; two leave time for the K-step phase.
SEG_TIMED_CALLS = 2
SEG_RAGGED = (70, 500, 470)   # T % slab != 0; H, W % 16 != 0


def _znorm_pad16(x):
    """Per-frame z-norm (population std plus 1e-6) of (B, H, W) float32
    frames, reflect-padded on the high sides to multiples of 16."""
    import torch.nn.functional as F

    mean = x.mean(dim=(1, 2), keepdim=True)
    std = x.std(dim=(1, 2), correction=0, keepdim=True) + 1e-6
    x = (x - mean) / std
    h, w = x.shape[1:]
    return F.pad(x[:, None], (0, -w % 16, 0, -h % 16), mode="reflect")[:, 0]


def straightforward_segment(net, host, dev, batch, threshold=0.5):
    """``segment_movie`` written out plainly, one batch at a time with
    nothing in flight: copy, z-norm, pad, net, crop, threshold, copy back.
    Returns (masks uint8, probs float32) on the host."""
    import numpy as np
    import torch

    t, h, w = host.shape
    masks = np.empty((t, h, w), np.uint8)
    probs = np.empty((t, h, w), np.float32)
    with torch.inference_mode():
        for i in range(0, t, batch):
            x = torch.from_numpy(host[i:i + batch]).to(dev).to(torch.float32)
            p = net(_znorm_pad16(x))[:, :h, :w]
            probs[i:i + batch] = p.cpu().numpy()
            masks[i:i + batch] = (p > threshold).to(torch.uint8).cpu().numpy()
    return masks, probs


def phase_segment(dev, main, card):
    """``segment_movie`` at the published width on a host int16 movie."""
    import numpy as np
    import torch

    from deepcalcium_torch.models.movie_segmentation import segment_movie
    from deepcalcium_torch.models.unet2d import forward_flops, from_jax_params
    from deepcalcium_torch.ops.summary import movie_fold_cuda, movie_summary_cuda

    params, state = main["params"], main["state"]
    host = np.ascontiguousarray(main["host"][:SEG_FRAMES])
    t, h, w = SEG_RAGGED
    ragged = np.ascontiguousarray(main["host"][-t:, :h, :w])
    movie_summary_cuda.launches = movie_fold_cuda.launches = 0

    # (a) Full size, bf16: the pipelined call against the plain loop at the
    # same slab size, under deterministic cuDNN: bit for bit.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        masks = segment_movie(params, state, host, slab=SEG_SLAB)  # warm-up too
        folded = from_jax_params(params, state, torch.bfloat16, dev).eval().fold()
        want, _ = straightforward_segment(folded, host, dev, SEG_SLAB)
        if masks.shape != host.shape or masks.dtype != np.uint8:
            raise AssertionError(f"segment_movie returned {masks.shape} {masks.dtype}")
        if not np.array_equal(masks, want):
            raise AssertionError(
                f"pipelined segment_movie differs from the plain loop on "
                f"{(masks != want).mean():.4%} of pixels")
        rmasks_bf16 = segment_movie(params, state, ragged, slab=SEG_SLAB)
        # (b) Ragged, float32 with TF32 off, against the unfolded net frame
        # by frame (batches of 25: another batch size than the slab's).
        torch.backends.cudnn.allow_tf32 = False
        rmasks = segment_movie(params, state, ragged, slab=SEG_SLAB,
                               compute_dtype=None)
        plain = from_jax_params(params, state, device=dev).eval()
        rwant, rprobs = straightforward_segment(plain, ragged, dev, 25)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.deterministic = False
    differ = rmasks != rwant
    dist = np.abs(rprobs - 0.5)
    if rmasks.shape != ragged.shape or (differ & (dist >= 1e-5)).any():
        raise AssertionError(
            f"ragged f32 segment_movie differs from the straightforward "
            f"composition on {int(differ.sum())} pixels, the farthest "
            f"{dist[differ].max():.3g} from the threshold")
    bf16_share = float((rmasks_bf16 != rmasks).mean())
    # bf16 convs move a probability by about 1e-2: only pixels that near
    # the threshold may flip.
    if ((rmasks_bf16 != rmasks) & (dist > 0.1)).any():
        raise AssertionError("bf16 masks differ from f32 far from the threshold")

    # (c) Time, cuDNN's default settings: host clock over whole calls.
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(SEG_TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        segment_movie(params, state, host, slab=SEG_SLAB)
        runs.append(time.perf_counter() - t0)
    # What a call spends before its first slab: building the folded net.
    t0 = time.perf_counter()
    from_jax_params(params, state, torch.bfloat16, dev).eval().fold()
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    t0 = time.perf_counter()
    device_ms, kernels, top = device_time_per_call(
        lambda: segment_movie(params, state, host, slab=SEG_SLAB), 1,
        skip=("Memcpy", "Memset"))
    profiled_s = time.perf_counter() - t0
    k1_launches = movie_summary_cuda.launches + movie_fold_cuda.launches
    flops = forward_flops(WINDOW, WINDOW, NFB)
    best = min(runs)
    numbers = {
        "frames": SEG_FRAMES, "slab": SEG_SLAB, "seconds": runs,
        "frames_per_s": [SEG_FRAMES / r for r in runs],
        "ms_per_slab": [r * 1e3 / (SEG_FRAMES / SEG_SLAB) for r in runs],
        "tflops": SEG_FRAMES * flops / best / 1e12,
        "device_ms": device_ms, "kernels": kernels,
        "profiled_call_seconds": profiled_s,
        "device_idle": 1.0 - device_ms / (best * 1e3),
        "net_setup_ms": setup_ms,
        "peak_gib": peak_gib, "mask_fraction": float(masks.mean()),
        "ragged": list(SEG_RAGGED),
        "ragged_f32_mismatches": int(differ.sum()),
        "ragged_f32_within_1e-5": int((dist < 1e-5).sum()),
        "ragged_bf16_vs_f32_differ_fraction": bf16_share,
        "k1_launches": k1_launches}
    print(f"segment_movie nfb={NFB} bf16 slab {SEG_SLAB} on a host int16 "
          f"{tuple(host.shape)} movie: masks bitwise equal to the plain "
          f"slab loop; ragged {SEG_RAGGED} at f32 TF32 off against the "
          f"unfolded net frame by frame: {int(differ.sum())} pixels differ, "
          f"all within 1e-5 of the threshold ({int((dist < 1e-5).sum())} "
          f"pixels there); bf16 differs from f32 on {bf16_share:.4%}; K1 "
          f"launches {k1_launches}; {card}", flush=True)
    print(f"segment.frames_per_s "
          f"{', '.join(f'{v:.1f}' for v in numbers['frames_per_s'])} "
          f"({', '.join(f'{v:.2f}' for v in numbers['ms_per_slab'])} ms a "
          f"slab, {numbers['tflops']:.1f} TFLOP/s bf16 over the fastest "
          f"call); on the device: {kernels:.0f} kernels, {device_ms:.1f} ms "
          f"of them a call, so the card idles {numbers['device_idle']:.1%} "
          f"(building the folded net alone takes {setup_ms:.1f} ms of a "
          f"call); peak memory {peak_gib:.2f} GiB; most device time: "
          + "; ".join(f"{n} {ms:.1f} ms" for n, ms in top) + f"; {card}",
          flush=True)
    return numbers


def phase_stencil(dev, seed, card):
    """``mask_summary_stencil`` on the card against the CPU and the exact
    walk."""
    import numpy as np
    import torch

    from deepcalcium_torch.ops.mask_summary import (id_map_from_stack,
                                                    mask_summary_exact,
                                                    mask_summary_stencil)

    rng = np.random.default_rng(seed + 18)
    masks = _neuron_masks(rng, (WINDOW, WINDOW), 300)
    on_card = mask_summary_stencil(masks)
    if on_card.device.type != "cuda" or on_card.dtype != torch.float32:
        raise AssertionError(f"stencil returned {on_card.device} {on_card.dtype}")
    got = on_card.cpu().numpy()
    if not np.array_equal(got, mask_summary_stencil(masks, device="cpu").numpy()):
        raise AssertionError("stencil on the card differs from the CPU's")
    for a, b in zip(id_map_from_stack(masks), id_map_from_stack(masks, "cpu")):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("id_map_from_stack differs from the CPU's")
    exact = mask_summary_exact(masks)
    if ((got == 1) & (exact == 0)).any():
        raise AssertionError("the stencil kept a pixel the exact walk deleted")
    # Separated neurons: disks of radius 5 on a 32-pixel grid.
    yy, xx = np.mgrid[0:WINDOW, 0:WINDOW]
    apart = np.stack([((yy - cy) ** 2 + (xx - cx) ** 2 <= 25).astype(np.int8)
                      for cy in range(16, WINDOW, 32)
                      for cx in range(16, WINDOW, 32)])
    if not np.array_equal(mask_summary_stencil(apart).cpu().numpy(),
                          mask_summary_exact(apart)):
        raise AssertionError("stencil differs from the exact walk on "
                             "separated neurons")
    on_dev = torch.from_numpy(masks).to(dev)
    ms = timed_ms(lambda: mask_summary_stencil(on_dev), 10)
    numbers = {"neurons": int(masks.shape[0]), "ms": ms,
               "kept": int(got.sum()), "exact_kept": int(exact.sum())}
    print(f"stencil mask summary, {masks.shape[0]} neurons on {WINDOW}^2: "
          f"card = CPU bit for bit; keeps {int(got.sum())} of the exact "
          f"walk's {int(exact.sum())} pixels and none besides; equal to the "
          f"walk on {apart.shape[0]} separated neurons; {ms:.3f} ms a call "
          f"from a stack on the card; {card}", flush=True)
    return numbers


def phase_flows(dev, seed, card):
    """Cellpose's two step loops (``ops/flows.py``) at the Cellpose cell's
    shapes: the Euler kernel on the foreground of ~160 neurons of 75-300
    pixels on a 512x512 field for 200 steps, and the diffusion kernel on
    those neurons' masks; each bit for bit its plain version on the card,
    and each timed alone beside its bound and the plain version's time."""
    import numpy as np
    import torch

    from deepcalcium_torch.ops import flows

    rng = np.random.default_rng(seed + 23)
    masks = _neuron_masks(rng, (WINDOW, WINDOW), 160, r_lo=5, r_hi=10)
    labels = (masks.astype(np.int64)
              * np.arange(1, len(masks) + 1)[:, None, None]).max(axis=0)
    lab = torch.from_numpy(labels).to(dev)
    # Cellpose's training targets of the masks (5 x the diffused flows)
    # plus noise: the flows the cell's readout is fit to.
    mu, y, x, _, _ = flows.masks_to_flows(lab)
    dP = torch.zeros((2, WINDOW, WINDOW), device=dev)
    dP[:, y - 1, x - 1] = 5 * mu.float()
    gen = torch.Generator(device=dev).manual_seed(seed)
    dP += torch.randn(dP.shape, generator=gen, device=dev)
    inds = torch.nonzero(lab > 0).contiguous()
    im = flows.euler_field(dP * (lab > 0) / 5.0)
    d = flows.diffusion_inputs(lab)
    got = flows.euler_steps_cuda(im, inds, 200)
    if not torch.equal(got, flows.euler_steps(im, inds, 200)):
        raise AssertionError("the Euler kernel's end points differ from the "
                             "plain steps'")
    t = flows.diffuse_cuda(d)
    if not torch.equal(t, flows.diffuse(d)):
        raise AssertionError("the diffusion kernel's T differs from the "
                             "plain steps'")
    sizes = np.bincount(labels.ravel())[1:]
    numbers = {
        "pixels": int(inds.shape[0]), "niter": 200,
        "masks": int((sizes > 0).sum()), "mask_px": [int(sizes.min()),
                                                     int(sizes.max())],
        "steps": d.steps,
        "euler_ms": timed_ms(lambda: flows.euler_steps_cuda(im, inds, 200),
                             50),
        "euler_plain_ms": timed_ms(lambda: flows.euler_steps(im, inds, 200),
                                   3),
        "euler_bound_ms": 200 * L2_HIT_S * 1e3,
        "diffuse_ms": timed_ms(lambda: flows.diffuse_cuda(d), 50),
        "diffuse_plain_ms": timed_ms(lambda: flows.diffuse(d), 3),
        "diffuse_bound_ms": d.steps * DIFFUSE_STEP_S * 1e3}
    # Each kernel's own device time, without its wrapper's other kernels.
    for key, fn, kernel in (
            ("euler_kernel_ms", lambda: flows.euler_steps_cuda(im, inds, 200),
             "euler_kernel"),
            ("diffuse_kernel_ms", lambda: flows.diffuse_cuda(d),
             "diffuse_kernel")):
        numbers[key] = sum(ms for name, ms, _ in kernel_table(fn, 10)
                           if kernel in name)
    print(f"flow kernels, {numbers['pixels']} pixels x 200 Euler steps on "
          f"{WINDOW}^2 and {numbers['masks']} masks of "
          f"{numbers['mask_px'][0]}-{numbers['mask_px'][1]} px x {d.steps} "
          f"diffusion steps: both bit for bit their plain steps; Euler "
          f"{numbers['euler_ms']:.4f} ms a call, kernel "
          f"{numbers['euler_kernel_ms']:.4f} (bound "
          f"{numbers['euler_bound_ms']:.4f}, plain "
          f"{numbers['euler_plain_ms']:.3f}), diffusion "
          f"{numbers['diffuse_ms']:.4f} ms a call, kernel "
          f"{numbers['diffuse_kernel_ms']:.4f} (bound "
          f"{numbers['diffuse_bound_ms']:.4f}, plain "
          f"{numbers['diffuse_plain_ms']:.3f}); {card}", flush=True)
    return numbers


def _explicit_attention(qkv, th, tw, grid, heads):
    """float32 ``softmax(q k^T / sqrt(d) + B) v`` with B built whole from
    the tables (``ops/attention.py``'s formula), (B, N, heads d)."""
    import torch

    from deepcalcium_torch.ops import attention as att

    b, n, c3 = qkv.shape
    d = c3 // (3 * heads)
    gh, gw = grid
    q, k, v = qkv.float().view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    rel_h, rel_w = att.rel_pos_terms(
        q.reshape(b, heads, gh, gw, d), att.rel_pos_index(th.float(), gh),
        att.rel_pos_index(tw.float(), gw))
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(b, heads, n, n)
    p = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5 + bias, -1)
    return (p @ v).transpose(1, 2).reshape(b, n, heads * d)


def phase_attention(dev, seed, card):
    """Cellpose-SAM's attention kernel (``ops/attention.py``) at the cell's
    shapes: a block's qkv of 9 tiles in batches of 8 and 1, a 32 x 32 grid,
    16 heads of 64, bf16, tables N(0, 0.2). Each batch's kernel against
    the float32 attention with the bias built whole, no farther from it
    than 1.25 times the plain version (the padded route, which rounds the
    bias to bf16); then the kernel timed alone beside its FLOP bound, the
    plain version from qkv to the projection's layout (``attention`` on
    the card: split, bias terms, cats and pads, cuDNN's flash at head dim
    128, slice and transpose), and that flash call alone as the library's
    yardstick (``library_ms``; the port never calls it on a card)."""
    import torch
    import torch.nn.functional as F

    from deepcalcium_torch.ops import attention as att

    grid, heads, d = (32, 32), 16, 64
    n = grid[0] * grid[1]
    numbers = {"grid": list(grid), "heads": heads, "head_dim": d,
               "by_batch": {}}
    for b in (8, 1):
        gen = torch.Generator(device=dev).manual_seed(seed + b)
        qkv = torch.randn((b, n, 3 * heads * d), generator=gen,
                          device=dev).bfloat16()
        th, tw = (torch.randn((2 * g - 1, d), generator=gen, device=dev)
                  .mul(0.2).bfloat16() for g in grid)
        want = _explicit_attention(qkv, th, tw, grid, heads)
        got = att.attention_qkv_cuda(qkv, th, tw, grid, heads)

        def plain():
            q, k, v = qkv.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
            return att.attention(q, k, v, att.rel_pos_index(th, grid[0]),
                                 att.rel_pos_index(tw, grid[1]), grid
                                 ).transpose(1, 2).reshape(b, n, heads * d)

        err = float((got.float() - want).abs().max())
        plain_err = float((plain().float() - want).abs().max())
        if not err <= 1.25 * plain_err:
            raise AssertionError(f"the attention kernel at batch {b} is "
                                 f"{err} from the float32 attention, the "
                                 f"plain version {plain_err}")
        q, k, v = qkv.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        rel_h, rel_w = att.rel_pos_terms(
            q.reshape(b, heads, grid[0], grid[1], d),
            att.rel_pos_index(th, grid[0]), att.rel_pos_index(tw, grid[1]))
        qa = torch.cat([q * d ** -0.5, rel_h, rel_w], -1)
        ka = torch.cat([k, att._one_hot_keys(grid, k).expand(
            b, heads, n, sum(grid))], -1)
        va = F.pad(v, (0, sum(grid)))
        flops = 4 * b * heads * n * n * d + 2 * b * heads * n * sum(grid) * d

        def kernel():
            return att.attention_qkv_cuda(qkv, th, tw, grid, heads)

        numbers["by_batch"][b] = {
            "max_abs_err": err, "plain_max_abs_err": plain_err,
            "ms": timed_ms(kernel, 50),
            "kernel_ms": sum(ms for name, ms, _ in kernel_table(kernel, 10)
                             if "attention_bf16_kernel" in name),
            "bound_ms": flops / BF16_FLOPS_PER_S * 1e3, "bound_by": "flops",
            "plain_ms": timed_ms(plain, 20),
            "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
                qa, ka, va, scale=1.0), 20)}
    by = numbers["by_batch"]
    print(f"attention kernel, 32x32 grid, 16 heads of 64, bf16: batch 8 "
          f"{by[8]['kernel_ms']:.4f} ms (bound {by[8]['bound_ms']:.4f}, "
          f"plain {by[8]['plain_ms']:.3f}, flash alone "
          f"{by[8]['library_ms']:.4f}; error {by[8]['max_abs_err']:.4g} "
          f"against the plain version's {by[8]['plain_max_abs_err']:.4g}), "
          f"batch 1 {by[1]['kernel_ms']:.4f} ms (bound "
          f"{by[1]['bound_ms']:.4f}, plain {by[1]['plain_ms']:.3f}, flash "
          f"alone {by[1]['library_ms']:.4f}); {card}", flush=True)
    return numbers


class _HostMovie:
    """An in-memory stand-in for an open HDF5 dataset: a shape, a dtype and
    slicing, so that a command takes the path it takes for a file."""

    def __init__(self, array):
        self._array = array
        self.shape, self.dtype = array.shape, array.dtype

    def __getitem__(self, key):
        return self._array[key]


def phase_cli(dev, main, spikes_ctx, card):
    """The command line on the card, through ``cli.main([...])``."""
    import contextlib
    import io
    import os

    import numpy as np
    import torch

    from deepcalcium_torch import cli
    from deepcalcium_torch.models.glm_spikes import GLMSegmentation
    from deepcalcium_torch.models.movie_segmentation import segment_movie
    from deepcalcium_torch.models.unet_1d_segmentation import (
        UNet1DSegmentation)
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary
    from deepcalcium_torch.ops.summary import movie_fold_cuda, movie_summary_cuda
    from deepcalcium_torch.train.checkpoints import save_checkpoint

    out = REPO / "build" / "chip_smoke_cli"
    shutil.rmtree(out, ignore_errors=True)
    (out / "cp").mkdir(parents=True)
    ckpt = str(out / "unet2ds_random.ckpt")
    save_checkpoint(ckpt, main["params"], main["state"])
    ckpt1d = str(out / "unet1d_best.ckpt")
    save_checkpoint(ckpt1d, spikes_ctx["ckpt"]["params"],
                    spikes_ctx["ckpt"]["state"])

    movies = {"full.hdf5": main["host"], "short.hdf5": main["host"][:100]}
    mean = movie_summary_cuda(main["movie"])[0]
    z = ((mean - mean.mean()) / mean.std(correction=0)).cpu().numpy()
    names = ["neurofinder.00.00", "neurofinder.01.00"]
    summaries, truths = {}, {}
    for k, name in enumerate(names):
        # The datasets directory the registry looks in: a placeholder file
        # marks each dataset as downloaded and ingested.
        ds = out / "dc" / "datasets" / "neurons_nf" / name / "dataset.hdf5"
        ds.parent.mkdir(parents=True)
        ds.touch()
        # A 256x256 quarter each (reflect-padded to the window): the random
        # net marks nearly every pixel, and scoring and writing one region
        # of that many pixels is host time that shows nothing here.
        summaries[str(ds)] = np.ascontiguousarray(np.rot90(z, k)[:256, :256])
        truths[str(ds)] = np.ascontiguousarray(
            np.rot90(main["truth"], k)[:256, :256])
    written = {}
    devices = []

    def neuron_wrapper(args, **kw):
        devices.append(args.device)
        return UNet2DSummary(
            cpdir=cli._neurons_cpdir(args.checkpoints_dir), device=args.device,
            dataset_name_func=lambda p: Path(p).parent.name,
            series_summary_func=summaries.__getitem__,
            mask_summary_func=truths.__getitem__, **kw)

    spike_io = dict(dataset_attrs_func=lambda n: {"name": n},
                    dataset_traces_func=lambda n: spikes_ctx["traces"][:40],
                    dataset_spikes_func=lambda n: spikes_ctx["spikes"][:40])

    def spike_wrapper(args):
        devices.append(args.device)
        if args.arch == "unet1d":
            return UNet1DSegmentation(cpdir=args.checkpoints_dir,
                                      device=args.device, **spike_io)
        return GLMSegmentation(cpdir=args.checkpoints_dir, arch=args.arch,
                               device=args.device, **spike_io)

    @contextlib.contextmanager
    def open_raw(path):
        yield _HostMovie(movies[path])

    def run(argv):
        """``cli.main(argv)`` with its printed lines returned, and shown."""
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
        finally:
            print(buf.getvalue(), end="", flush=True)
        return buf.getvalue()

    seams = {"_neuron_wrapper": neuron_wrapper, "_spike_wrapper": spike_wrapper,
             "_open_raw": open_raw,
             "_write_masks": lambda path, masks: written.__setitem__(path, masks)}
    saved = {k: getattr(cli, k) for k in seams}
    old_dir = os.environ.get("DEEPCALCIUM_TPU_DIR")
    os.environ["DEEPCALCIUM_TPU_DIR"] = str(out / "dc")
    for k, fn in seams.items():
        setattr(cli, k, fn)
    torch.backends.cudnn.deterministic = True
    movie_summary_cuda.launches = movie_fold_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        # evaluate-movie: bf16, 8x TTA, the streaming fold.
        npz = str(out / "ev.npz")
        run(["evaluate-movie", "full.hdf5", "-m", ckpt, "--dtype", "bfloat16",
             "-c", str(out / "cp"), "--out", npz])
        fold_launches = movie_fold_cuda.launches
        with np.load(npz) as f:
            if not (np.array_equal(f["mask"], main["mask"])
                    and np.array_equal(f["prob"], main["prob"])):
                raise AssertionError("evaluate-movie's mask/prob differ from "
                                     "the streaming evaluate's")
        if fold_launches != math.ceil(FRAMES / FOLD_CHUNK) or movie_summary_cuda.launches:
            raise AssertionError(f"evaluate-movie launched K1's fold "
                                 f"{fold_launches} times")
        # segment: the default dtype (bf16), masks handed to the writer.
        run(["segment", "short.hdf5", "-m", ckpt, "--slab", "32",
             "-c", str(out / "cp")])
        want = segment_movie(main["params"], main["state"], movies["short.hdf5"],
                             slab=32)
        if list(written) != ["short_masks.hdf5"] or not np.array_equal(
                written["short_masks.hdf5"], want):
            raise AssertionError("segment wrote other masks than segment_movie's")
        # parity-golden: passes at a wide tolerance, exit code 1 otherwise.
        paths = list(summaries)
        common = ["-m", ckpt, "--dtype", "bfloat16", "-c", str(out / "cp")]
        text = run(["parity-golden", "--paths", *paths, *common, "--tta",
                    "both", "--tol", "1.0"])
        if "parity-golden: PASS" not in text or text.count(" -> ok") != 6:
            raise AssertionError(f"parity-golden did not pass: {text}")
        try:
            run(["parity-golden", "--paths", paths[1], *common, "--tta", "on",
                 "--tol", "0.000001", "--expect-tta", "9", "9", "9"])
        except SystemExit as e:
            if e.code != 1:
                raise AssertionError(f"parity-golden exit code {e.code}")
        else:
            raise AssertionError("parity-golden passed an impossible expectation")
        # predict: both passes, the timestamped and the latest submissions.
        run(["predict", names[1], "-m", ckpt, "--dtype", "bfloat16",
             "-c", str(out / "cp")])
        subs = sorted(p.name for p in (out / "cp").glob("submission_*.json"))
        if len(subs) != 4 or not {"submission_latest.json",
                                  "submission_latest_TTA.json"} <= set(subs):
            raise AssertionError(f"predict wrote {subs}")
        with open(out / "cp" / "submission_latest_TTA.json") as fp:
            sub = json.load(fp)
        if [e["dataset"] for e in sub] != ["01.00"] or not all(
                e["regions"] for e in sub):
            raise AssertionError("bad submission")
        # One spike command each way.
        text = run(["spikes-train", "synthetic.spikes", "--arch", "glm", "-e",
                    "50", "-c", str(out / "glm")])
        best = text.strip().splitlines()[-1].split()[1]
        text = run(["spikes-predict", "synthetic.spikes", "--arch", "glm", "-m",
                    best, "-c", str(out / "glm")])
        if not text.startswith("synthetic.spikes: (40, 30011), "):
            raise AssertionError(f"spikes-predict printed {text!r}")
        # spikes-predict of the phase-14 checkpoint, the stock UNet1D:
        # the folded net, the masks of the wrapper's own default predict.
        text = run(["spikes-predict", "synthetic.spikes", "--arch", "unet1d",
                    "-m", ckpt1d, "-c", str(out / "unet1d")])
        want1d = UNet1DSegmentation(cpdir=str(out / "unet1d"), device=dev,
                                  **spike_io).predict(["synthetic.spikes"],
                                                      ckpt1d)[0][0]
        if text.strip() != (f"synthetic.spikes: (40, 30011), "
                            f"{int(want1d.sum())} spike samples"):
            raise AssertionError(f"spikes-predict --arch unet1d printed "
                                 f"{text!r}, the wrapper marks "
                                 f"{int(want1d.sum())} samples")
    finally:
        torch.backends.cudnn.deterministic = False
        for k, fn in saved.items():
            setattr(cli, k, fn)
        if old_dir is None:
            del os.environ["DEEPCALCIUM_TPU_DIR"]
        else:
            os.environ["DEEPCALCIUM_TPU_DIR"] = old_dir
    seconds = time.perf_counter() - t0
    launches = movie_fold_cuda.launches + movie_summary_cuda.launches
    if set(devices) != {"cuda"}:
        raise AssertionError(f"commands ran on {set(devices)}")
    shutil.rmtree(out, ignore_errors=True)
    print(f"cli through main([...]) with in-memory movies and summaries in "
          f"place of HDF5 files (no h5py here), no --device: evaluate-movie "
          f"= the streaming evaluate bit for bit, K1 fold launches "
          f"{fold_launches}; segment = segment_movie; parity-golden PASS at "
          f"tol 1.0 and exit code 1 at an impossible expectation; predict "
          f"wrote {len(subs)} submissions; spikes-train glm and "
          f"spikes-predict (glm; unet1d on the folded net, "
          f"{int(want1d.sum())} spike samples as the wrapper's predict) ran; "
          f"{seconds:.1f} s; {card}", flush=True)
    return launches, {"seconds": seconds, "fold_launches": fold_launches,
                      "submissions": subs}


PAR_SEG_FRAMES = 256  # frames of the meshed segment_movie call


def _one_step(kind, dev, seed, mesh):
    """One train step at the published width from weights drawn from
    ``seed``, at drp=0: UNet2DS at batch 20 @ 128^2 with bce and the neuron
    metrics, or UNet1D at batch 20 x 4096 with wbce(pos=2) and the spike
    metrics; bf16. Returns (step, x, y, net)."""
    import functools

    import numpy as np
    import torch

    from deepcalcium_torch.models.unet1d import UNet1D
    from deepcalcium_torch.models.unet2d import UNet2DS
    from deepcalcium_torch.ops import losses as L
    from deepcalcium_torch.train import trainer

    rng = np.random.default_rng(seed + 20)
    gen = torch.Generator().manual_seed(seed)
    if kind == "2d":
        net = UNet2DS(nfb=NFB, compute_dtype=torch.bfloat16, generator=gen,
                      drp=0.0).to(dev)
        shape = (TRAIN_BATCH, TRAIN_WINDOW, TRAIN_WINDOW)
        loss_fn, metric_fns = L.binary_crossentropy, None
    else:
        net = UNet1D(nfb=NFB, margin=SPIKE_MARGIN,
                     compute_dtype=torch.bfloat16, generator=gen,
                     drp=0.0).to(dev)
        shape = (SPIKE_BATCH, SPIKE_WINDOW)
        loss_fn = functools.partial(L.weighted_binary_crossentropy,
                                    weightpos=2.0)
        metric_fns = dict(L.SPIKE_METRICS)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.random(shape) < 0.1).astype(np.float32)).to(dev)
    step = trainer.make_train_step(net, loss_fn, trainer.make_optimizer(net),
                                   metric_fns, mesh=mesh)
    return step, x, y, net


def phase_parallel(dev, main, card, seed):
    """The multi-device paths over an NCCL group on the card: one rank here
    (and one rank a card through ``parallel/dryrun.py`` where there are
    several). Every meshed path is held against its plain one."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from deepcalcium_torch.models.movie_segmentation import segment_movie
    from deepcalcium_torch.models.unet2d import from_jax_params
    from deepcalcium_torch.ops.summary import (movie_fold_cuda,
                                               movie_summary_cuda,
                                               movie_summary_sharded)
    from deepcalcium_torch.parallel import dryrun
    from deepcalcium_torch.parallel.distributed import (_free_port, initialize,
                                                        pod_mesh, shutdown)
    from deepcalcium_torch.train import trainer
    from deepcalcium_torch.train.evaluate import make_movie_evaluator

    t0 = time.perf_counter()
    initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    mesh = pod_mesh()
    if dist.get_backend() != "nccl" or mesh.device.type != "cuda":
        raise AssertionError(f"the group on the card is {dist.get_backend()} "
                             f"on {mesh.device}, not NCCL")
    mesh.barrier()  # the first collective builds NCCL's communicator
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    parts = {"nccl_setup": setup_s}

    def lap(name, since):
        torch.cuda.synchronize()
        parts[name] = round(time.perf_counter() - since, 2)
        return time.perf_counter()

    movie, params, state = main["movie"], main["params"], main["state"]
    host = np.ascontiguousarray(main["host"][:PAR_SEG_FRAMES])
    model = from_jax_params(params, state, torch.bfloat16, dev).eval().fold()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        # The meshed paths first, with K1's counts read right after them.
        t1 = time.perf_counter()
        movie_summary_cuda.launches = movie_fold_cuda.launches = 0
        mean, mx = movie_summary_sharded(movie, mesh)
        summary_launches = movie_fold_cuda.launches
        mask, prob, emean = make_movie_evaluator(
            model, movie.shape, window=(WINDOW, WINDOW), mesh=mesh)(movie)
        masks = segment_movie(params, state, host, slab=SEG_SLAB, mesh=mesh)
        launches = movie_fold_cuda.launches
        t1 = lap("meshed_paths", t1)
        if movie_summary_cuda.launches or summary_launches != math.ceil(
                FRAMES / FOLD_CHUNK) or launches != 2 * summary_launches:
            raise AssertionError(
                f"the sharded paths launched K1's fold {launches} times and "
                f"its whole-movie entry {movie_summary_cuda.launches} times")
        # Their plain versions.
        k1_mean, k1_max = movie_summary_cuda(movie)
        if not (torch.equal(mean, k1_mean) and torch.equal(mx, k1_max)
                and torch.equal(emean, k1_mean)):
            raise AssertionError("the sharded summary differs from K1's")
        pmask, pprob, _ = make_movie_evaluator(
            model, movie.shape, window=(WINDOW, WINDOW))(movie)
        if not (torch.equal(mask, pmask) and torch.equal(prob, pprob)):
            raise AssertionError("the meshed movie evaluator differs from "
                                 "the plain one")
        want = segment_movie(params, state, host, slab=SEG_SLAB)
        if masks.shape != host.shape or not np.array_equal(masks, want):
            raise AssertionError("the meshed segment_movie differs from the "
                                 "plain one")
        t1 = lap("plain_paths", t1)

        # One train step of each net with the mesh against without, from
        # the same weights. Tolerance: loss rtol 1e-5; gradients and BN
        # buffers within 1e-3 of the tensor's largest entry (bf16 convs; the
        # global statistics and the gradient combine may round elsewhere).
        steps = {}
        for kind in ("2d", "1d"):
            plain_step, x, y, plain_net = _one_step(kind, dev, seed, None)
            mesh_step, _, _, mesh_net = _one_step(kind, dev, seed, mesh)
            t1 = lap(f"{kind}_nets", t1)
            pm, mm = plain_step(x, y), mesh_step(x, y)
            loss, mloss = float(pm["loss"]), float(mm["loss"])
            if not (math.isfinite(loss) and abs(mloss - loss) <= 1e-5 * abs(loss)):
                raise AssertionError(f"{kind}: meshed loss {mloss}, plain {loss}")
            worst, bitwise = 0.0, mloss == loss
            named = (list(zip(plain_net.named_parameters(), mesh_net.parameters()))
                     + list(zip(plain_net.named_buffers(), mesh_net.buffers())))
            for (name, a), b in named:
                pairs = [(a, b)] if a.grad is None else [(a, b), (a.grad, b.grad)]
                for u, v in pairs:
                    u, v = u.detach(), v.detach()
                    err = float((u - v).abs().max() / u.abs().max().clamp_min(1e-30))
                    worst = max(worst, err)
                    bitwise = bitwise and torch.equal(u, v)
                    if not err <= 1e-3:
                        raise AssertionError(f"{kind} {name}: meshed step off "
                                             f"by {err:.3g} of the largest entry")
            steps[kind] = {"loss": loss, "bitwise": bool(bitwise),
                           "worst_relative": worst}
            t1 = lap(f"{kind}_compare", t1)
            # Time, plain, mesh, mesh, plain: what the collectives of one
            # rank cost a step.
            torch.backends.cudnn.deterministic = False
            ms = [timed_ms(lambda: s(x, y), 5)
                  for s in (plain_step, mesh_step, mesh_step, plain_step)]
            torch.backends.cudnn.deterministic = True
            steps[kind].update(plain_ms=[ms[0], ms[3]], mesh_ms=[ms[1], ms[2]])
            t1 = lap(f"{kind}_timing", t1)

        # One K-step dispatch of UNet2DS with the mesh (its collectives
        # inside the CUDA graph) against without, from the same weights at
        # drp=0: bit for bit.
        runs = []
        base, loss_fn, metric_fns, slabs = _k_step_case("2d", dev, seed)
        base.drp = 0.0
        for m in (mesh, None):
            net = copy.deepcopy(base)
            opt = trainer.make_optimizer(net)
            multi = trainer.make_multi_step(net, loss_fn, opt, K_DISPATCH,
                                            metric_fns, mesh=m)
            rows = multi(*slabs[0])
            keys = sorted(rows)
            runs.append((_train_state(net, opt, None),
                         trainer.metric_rows([rows], keys)))
        diffs = _bitwise_diffs(runs[0][0], runs[1][0])
        if not torch.equal(runs[0][1], runs[1][1]):
            diffs.append("metrics")
        if diffs:
            raise AssertionError(f"the meshed {K_DISPATCH}-step graph differs "
                                 f"from the unmeshed one in {diffs}")
        multi_loss = runs[0][1][:, keys.index("loss")].tolist()
        del runs, multi, net, opt, base, slabs
        t1 = lap("multi_step", t1)
    finally:
        torch.backends.cudnn.deterministic = False

    # Several cards: one rank a card through the dry run, rank 0 against
    # one process on this card (float32, TF32 off in the ranks and here).
    cards = torch.cuda.device_count()
    multi = None
    if cards > 1:
        out = REPO / "build" / "chip_smoke_dryrun"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        files, runs = dryrun.spawn(cards, "cuda", str(out), timeout=300)
        if any(rc != 0 for rc, _, _ in runs):
            raise AssertionError("a rank of the multi-card dry run failed:\n"
                                 + "\n".join(se[-2000:] for _, _, se in runs))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            one = dryrun.dryrun_multichip(None, device=dev)
        finally:
            torch.backends.cudnn.allow_tf32 = True
        with np.load(files[0]) as z:
            rank0 = {k: z[k] for k in z.files}
        multi = {}
        for k, want in one.items():
            got = rank0[k].astype(np.float64)
            tol = 1e-4 * max(float(np.abs(want).max()), 1e-3)
            err = float(np.abs(got - want).max())
            if k.startswith(("summary.", "evaluator.mean")) and "f32" not in k:
                tol = 0.0
            if k in ("segment", "evaluator.mask"):
                err, tol = float((got != want).mean()), 0.01
            if err > tol:
                raise AssertionError(f"multi-card dry run: {k} off by {err} "
                                     f"(tolerance {tol})")
            multi[k.split(".")[0]] = max(multi.get(k.split(".")[0], 0.0), err)
        shutil.rmtree(out, ignore_errors=True)
    shutdown()
    seconds = time.perf_counter() - t0
    print(f"parallel: NCCL group of 1 rank on {mesh.device} formed in "
          f"{setup_s:.2f} s; movie_summary_sharded of {tuple(movie.shape)} "
          f"bitwise K1 ({summary_launches} fold launches); "
          f"make_movie_evaluator(mesh=) and segment_movie(mesh=) on "
          f"{PAR_SEG_FRAMES} frames bitwise the plain ones; "
          + "; ".join(
              f"{k} step with mesh against without: loss {v['loss']:.6f}, "
              f"{'bitwise equal' if v['bitwise'] else 'not bitwise'}, worst "
              f"{v['worst_relative']:.3g} of the largest entry; "
              f"{min(v['plain_ms']):.2f} ms plain, {min(v['mesh_ms']):.2f} "
              f"ms meshed" for k, v in steps.items())
          + f"; a meshed {K_DISPATCH}-step graph of UNet2DS bitwise the "
          f"unmeshed one (losses {[round(v, 5) for v in multi_loss]})"
          + (f"; multi-card dry run on {cards} cards: rank 0 within "
             f"tolerance of one process" if multi is not None else
             "; one card: the multi-card dry run was not possible and did "
             "not run") + f"; {seconds:.1f} s; {card}", flush=True)
    return launches, {"seconds": seconds, "nccl_setup_s": setup_s,
                      "part_seconds": parts,
                      "fold_launches": launches, "steps": steps,
                      "multi_step_losses": multi_loss,
                      "cards": cards, "multi_card": multi}


# --- The example scripts -----------------------------------------------------

SEARCH_TRIALS, SEARCH_STEPS = 2, 10
# Post-ReLU blocks that ``UNet2DS.forward(capture=)`` fills, with their
# channels as multiples of nfb and their side as a fraction of the input's.
CAPTURE_BLOCKS = (
    [(f"enc{l}{ab}", 2 ** l, 2 ** l) for l in range(4) for ab in "ab"]
    + [("mida", 16, 16), ("midb", 16, 16)]
    + [(f"dec{l}{ab}", 2 ** l, 2 ** l) for l in (3, 2, 1, 0) for ab in "ab"])
# Kernels with at least this many weights have their std checked: the
# estimate of 65,536 draws has a relative error of 0.3%.
INIT_STD_MIN_WEIGHTS = 65536


def _init_scale(scheme, fan_in, fan_out):
    """(bound on |w|, std) of an init scheme: a +-2 sigma truncated normal
    has std 0.8796 sigma, a uniform draw in [-lim, lim] has lim / sqrt(3)."""
    fan = fan_in if scheme.startswith("he") else fan_in + fan_out
    if scheme.endswith("normal"):
        sigma = math.sqrt(2.0 / fan)
        return 2 * sigma, 0.8796 * sigma
    lim = math.sqrt(6.0 / fan)
    return lim, lim / math.sqrt(3)


def phase_examples(dev, main, fit_ctx, card, seed):
    """The example scripts on the card, through their ``main([...])``;
    returns (K1 launches, numbers)."""
    import contextlib
    import importlib.util
    import io
    import os

    import numpy as np
    import torch

    from deepcalcium_torch.models import blocks
    from deepcalcium_torch.models.unet2d import (UNet2DS, from_jax_params,
                                                 layer_order)
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary
    from deepcalcium_torch.ops.losses import binary_crossentropy
    from deepcalcium_torch.ops.summary import movie_fold_cuda, movie_summary_cuda
    from deepcalcium_torch.train import trainer
    from deepcalcium_torch.train.checkpoints import save_checkpoint
    from examples_torch.analysis import activation_maps as maps
    from examples_torch.analysis import dataset_stats as stats
    from examples_torch.neurons import unet2ds_hyperparam_search as search

    out = REPO / "build" / "chip_smoke_examples"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ckpt = str(out / "unet2ds_random.ckpt")
    save_checkpoint(ckpt, main["params"], main["state"])
    movies, masks, truths = (fit_ctx[k] for k in ("movies", "masks", "truths"))
    names = list(movies)
    devices = []

    def series_summary(name):
        mean, _ = movie_summary_cuda(movies[name])
        return ((mean - mean.mean()) / mean.std(correction=0)).cpu().numpy()

    def run(fn, argv, **kw):
        """``fn(argv)`` with its printed lines returned, and shown."""
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                result = fn(argv, **kw)
        finally:
            print(buf.getvalue(), end="", flush=True)
        return result, buf.getvalue()

    # The search: full width, so nfb is pinned to 32; every other axis is
    # sampled from the script's own space.
    space = {**search.SPACE, "nfb": [NFB]}
    trial_launches = []

    def search_wrapper(cfg, cpdir, device):
        devices.append(device)
        trial_launches.append(movie_summary_cuda.launches)
        return UNet2DSummary(
            cpdir=cpdir, dataset_name_func=lambda name: name,
            series_summary_func=search.scaled_summary_func(
                cfg["scale_mode"], series_summary),
            mask_summary_func=truths.__getitem__,
            net_func=search.net_func(cfg), compute_dtype=torch.bfloat16,
            device=device)

    def stats_wrapper(device):
        devices.append(device)
        return UNet2DSummary(mask_summary_func=truths.__getitem__,
                             compute_dtype=torch.bfloat16, device=device)

    sink = {}
    seams = [(search, "_wrapper", search_wrapper),
             (stats, "_wrapper", stats_wrapper),
             (stats, "_dataset_info", lambda n: (
                 n, tuple(movies[n].shape), masks[n].shape[0])),
             (stats, "_throughput_movie", lambda t, hw: main["host"]),
             (maps, "_summary", lambda path: series_summary(path))]
    if importlib.util.find_spec("PIL") is None:
        seams.append((maps, "_save_png", lambda path, arr: sink.__setitem__(
            os.path.basename(path), np.asarray(arr))))
    saved = [(mod, k, getattr(mod, k)) for mod, k, _ in seams]
    old_dir = os.environ.get("DEEPCALCIUM_TPU_DIR")
    os.environ["DEEPCALCIUM_TPU_DIR"] = str(out / "dc")
    for mod, k, fn in seams:
        setattr(mod, k, fn)
    movie_summary_cuda.launches = movie_fold_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        csv_path = str(out / "search.csv")
        argv = ["fixtures", "--paths", *names, "--epochs", "1", "--steps",
                str(SEARCH_STEPS), "--val-shape", str(WINDOW), "--out",
                csv_path, "--seed", str(seed)]
        run(search.main, argv + ["--trials", str(SEARCH_TRIALS)], space=space)
        rows = search.load_rows(csv_path)
        trial_launches.append(movie_summary_cuda.launches)
        per_trial = np.diff(trial_launches).tolist()
        rng = np.random.default_rng(seed)
        want = [search.sample(rng, space) for _ in range(SEARCH_TRIALS + 1)]
        if len(rows) != SEARCH_TRIALS or min(per_trial) < 1:
            raise AssertionError(f"search: {len(rows)} rows, K1 launches a "
                                 f"trial {per_trial}")
        run(search.main, argv + ["--trials", str(SEARCH_TRIALS + 1),
                                 "--resume"], space=space)
        rows3 = search.load_rows(csv_path)
        if len(rows3) != SEARCH_TRIALS + 1 or rows3[:SEARCH_TRIALS] != rows:
            raise AssertionError(f"--resume left {len(rows3)} rows")
        for row, cfg in zip(rows3, want):
            if {k: str(v) for k, v in cfg.items()} != {k: row[k] for k in cfg}:
                raise AssertionError(f"trial {row['trial']} ran {row}, the "
                                     f"stream gives {cfg}")
            if not math.isfinite(float(row["val_nf_f1_mean"])):
                raise AssertionError(f"trial {row['trial']} failed: {row}")
        search_launches = movie_summary_cuda.launches
        trial_s = [float(r["seconds"]) for r in rows3]
        search_s = time.perf_counter() - t0

        # dataset_stats --throughput, under deterministic cuDNN so that its
        # mask compares bit for bit with phase 9's (the forward's algorithms
        # are deterministic either way; the time is the script's own third
        # call).
        stats_argv = ["fixtures", "--paths", *names, "--throughput", "--model",
                      ckpt, "--throughput-frames", str(FRAMES),
                      "--throughput-size", str(WINDOW)]
        torch.backends.cudnn.deterministic = True
        timed, text = run(stats.main, stats_argv)
        torch.backends.cudnn.deterministic = False
        if not (np.array_equal(timed["mask"], main["mask"])
                and np.array_equal(timed["prob"], main["prob"])):
            raise AssertionError("dataset_stats: mask/prob differ from the "
                                 "streaming evaluate's")
        name = torch.cuda.get_device_name(dev)
        if f"warm, on {name}): " not in text or f"totals: {2 * FIT_FRAMES} " \
                f"frames, {sum(m.shape[0] for m in masks.values())} neurons" \
                not in text:
            raise AssertionError(f"dataset_stats printed {text!r}")
        stats_launches = movie_summary_cuda.launches - search_launches
        if stats_launches != 3:
            raise AssertionError(f"dataset_stats launched K1 "
                                 f"{stats_launches} times in 3 evaluates")
        # What an array costs before K1 sees it: the one pageable copy.
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.from_numpy(main["host"]).to(dev)
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t1) * 1e3

        # activation_maps on the phase-5 movie's summary.
        movies["main"] = main["movie"]
        z = series_summary("main")
        maps_dir = out / "maps"
        _, text = run(maps.main, ["main", ckpt, str(maps_dir)])
        wrote = sorted(sink) if sink else sorted(os.listdir(maps_dir))
        if wrote != sorted([n + ".png" for n, _, _ in CAPTURE_BLOCKS]
                           + ["prediction.png"]) or \
                "wrote 19 activation maps" not in text:
            raise AssertionError(f"activation_maps wrote {wrote}")
        for png, arr in sink.items():
            if arr.shape != (WINDOW, WINDOW) or not (
                    np.isfinite(arr).all() and 0 <= arr.min() <= arr.max() <= 1):
                raise AssertionError(f"bad activation map {png}")
        torch.backends.cudnn.deterministic = True
        probs, acts = maps.activation_maps(main["params"], main["state"], z, dev)
        with torch.inference_mode():
            plain = from_jax_params(main["params"], main["state"],
                                    device=dev).eval()(
                torch.from_numpy(z).to(dev)[None])[0]
        torch.backends.cudnn.deterministic = False
        if not torch.equal(probs, plain):
            raise AssertionError("capture changed the probabilities")
        got = [(n, a.shape[0] // NFB, WINDOW // a.shape[1]) for n, a in acts.items()]
        if got != CAPTURE_BLOCKS or any(
                a.shape[1] != a.shape[2] or not torch.isfinite(a).all()
                or a.min() < 0 for a in acts.values()):
            raise AssertionError(f"captured {got}")
        maps_launches = (movie_summary_cuda.launches - search_launches
                         - stats_launches)
    finally:
        torch.backends.cudnn.deterministic = False
        movies.pop("main", None)
        for mod, k, fn in saved:
            setattr(mod, k, fn)
        if old_dir is None:
            del os.environ["DEEPCALCIUM_TPU_DIR"]
        else:
            os.environ["DEEPCALCIUM_TPU_DIR"] = old_dir
    launches = movie_summary_cuda.launches + movie_fold_cuda.launches
    shutil.rmtree(out, ignore_errors=True)

    # The four init schemes at full width: bounds, stds, one train step.
    g = torch.Generator(device=dev).manual_seed(seed)
    xb = torch.randn((TRAIN_BATCH, TRAIN_WINDOW, TRAIN_WINDOW), generator=g,
                     device=dev)
    yb = (torch.rand(xb.shape, generator=g, device=dev) < 0.126).float()
    init = {}
    for scheme in blocks.INIT_SCHEMES:
        net = UNet2DS(nfb=NFB, compute_dtype=torch.bfloat16,
                      init_scheme=scheme,
                      generator=torch.Generator().manual_seed(seed)).to(dev)
        worst_bound, worst_std, checked = 0.0, 0.0, 0
        for lname, kind, _ in layer_order(NFB):
            if kind == "bn":
                continue
            w = getattr(net, lname).weight.detach()
            if kind == "tconv":
                fans = (4 * w.shape[1], 4 * w.shape[0])
            else:
                k = w.shape[-1]
                fans = (k * k * w.shape[1], k * k * w.shape[0])
            bound, std = _init_scale(scheme, *fans)
            worst_bound = max(worst_bound, w.abs().max().item() / bound)
            if w.numel() >= INIT_STD_MIN_WEIGHTS:
                checked += 1
                worst_std = max(worst_std, abs(w.std().item() / std - 1))
        if worst_bound > 1 + 1e-6 or worst_std > 0.02:
            raise AssertionError(f"{scheme}: max |w| / bound {worst_bound}, "
                                 f"std off by {worst_std}")
        step = trainer.make_train_step(net, binary_crossentropy,
                                       trainer.make_optimizer(net, 1e-3))
        loss = float(step(xb, yb, g)["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"{scheme}: loss {loss} after one step")
        init[scheme] = {"max_over_bound": worst_bound, "std_off": worst_std,
                        "std_checked_kernels": checked, "loss": loss}
    if set(devices) != {"cuda"}:
        raise AssertionError(f"scripts ran on {set(devices)}")
    seconds = time.perf_counter() - t0
    numbers = {
        "seconds": seconds, "search_seconds": search_s,
        "search_trial_seconds": trial_s,
        "search_f1": [float(r["val_nf_f1_mean"]) for r in rows3],
        "search_configs": want, "search_k1_launches_per_trial": per_trial,
        "stats_seconds_per_call": timed["seconds"],
        "stats_frames_per_s": timed["frames_per_s"],
        "stats_pageable_copy_ms": copy_ms,
        "k1_launches": {"search": search_launches, "dataset_stats":
                        stats_launches, "activation_maps": maps_launches},
        "init": init}
    print(f"examples through main([...]) with in-memory movies and "
          f"summaries in place of HDF5 files, no --device: search nfb={NFB} "
          f"bf16, {SEARCH_TRIALS} trials + 1 resumed of {SEARCH_STEPS} steps, "
          f"validation at {WINDOW}^2: {trial_s} s a trial, val F1 "
          f"{[round(v, 4) for v in numbers['search_f1']]}, K1 launches a "
          f"trial {per_trial}; dataset_stats --throughput on the phase-5 "
          f"movie as a host array: mask/prob bit for bit phase 9's, "
          f"{timed['seconds'] * 1e3:.1f} ms a call = "
          f"{timed['frames_per_s']:.1f} frames/s, of which the pageable copy "
          f"of the movie alone {copy_ms:.1f} ms; activation_maps: 19 maps, "
          f"18 blocks, probabilities bit for bit those without capture; "
          f"init schemes "
          + ", ".join(f"{k} loss {v['loss']:.4f}" for k, v in init.items())
          + f" (max |w| / bound <= {max(v['max_over_bound'] for v in init.values()):.6f}, "
          f"std within {max(v['std_off'] for v in init.values()):.2%}); "
          f"{seconds:.1f} s; {card}", flush=True)
    return launches, numbers


# A folded block against its parity block, in bf16 on the card, as a share
# of the block's largest output. The two forms round differently (the fold
# rounds each scaled kernel value, the parity form the conv's output and
# the BN's product), so an output may land one bf16 ulp apart, and one ulp
# is at most 2^-7 of the largest output: two ulps.
FOLD_BF16_RTOL = 2.0 ** -6


def phase_analysis(dev, main, fit1d, multistep, card):
    """The measuring scripts of ``examples_torch/analysis/`` through their
    ``main([...])`` at full width, with fewer iterations: the evaluator's
    stages on the phase-5 movie, the UNet2DS per-block roofline (parity and
    folded forms), the UNet1D roofline against phase 14's step, the
    attribution of a 4-step dispatch of each net and the batch sweep.
    Fails if a row reads over 105% of its roofline, the stage sum and the
    FULL evaluator differ by more than 2x, the chained stages' mask or prob
    differ from the evaluator's, the K1 row's mean is not the plain
    summary's bit for bit, or a folded block parts from its parity block
    beyond ``FOLD_BF16_RTOL`` of its largest output. Returns (K1 launches,
    numbers)."""
    import torch

    from deepcalcium_torch.ops.summary import (movie_fold_cuda, movie_summary,
                                               movie_summary_cuda)
    from examples_torch.analysis import evaluator_stage_bench as stage_bench
    from examples_torch.analysis import train_mfu_sweep as sweep
    from examples_torch.analysis import train_step_profile as profile
    from examples_torch.analysis import unet1d_roofline as roof1d
    from examples_torch.analysis import unet_layer_bench as layer_bench

    t0 = time.perf_counter()
    movie = main["movie"]
    parts = {}

    def timed_part(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        parts[name] = round(time.perf_counter() - t, 2)
        return out

    movie_summary_cuda.launches = movie_fold_cuda.launches = 0
    stages = timed_part("stages", stage_bench.main, ["--iters", "10"],
                        movie=movie)
    parity = timed_part("layers", layer_bench.main, ["--iters", "10"],
                        movie=movie)
    folded = timed_part("layers_fast", layer_bench.main,
                        ["--fast", "--iters", "10"], movie=movie)
    launches = movie_summary_cuda.launches + movie_fold_cuda.launches

    (cmask, cprob), (fmask, fprob) = stages["chained"], stages["full"]
    if not (torch.equal(cmask, fmask) and torch.equal(cprob, fprob)):
        raise AssertionError("the chained stages differ from "
                             "make_movie_evaluator")
    ratio = stages["full_ms"] / stages["stage_sum_ms"]
    if not 0.5 <= ratio <= 2.0:
        raise AssertionError(f"FULL evaluate {stages['full_ms']:.3f} ms "
                             f"against a stage sum of "
                             f"{stages['stage_sum_ms']:.3f} ms")
    over = [(r["block"], r["roof_ms"] / r["ms"])
            for r in parity["rows"] + folded["rows"]
            if r["roof_ms"] is not None and r["roof_ms"] > 1.05 * r["ms"]]
    if over:
        raise AssertionError(f"rows faster than their roofline: {over}")
    if not torch.equal(parity["summary"], movie_summary(movie)[0]):
        raise AssertionError("the K1 row's mean differs from movie_summary")
    diffs = timed_part("fold_check", layer_bench.fold_diffs,
                       layer_bench.census(), dev)
    fold_rel = {k: d / y for k, (d, y) in diffs.items()}
    worst = max(fold_rel.items(), key=lambda kv: kv[1])
    if worst[1] > FOLD_BF16_RTOL:
        raise AssertionError(f"folded block {worst[0]} parts from its parity "
                             f"block by {worst[1]:.3e} of its largest output")

    floor1d = timed_part("roofline1d", roof1d.main,
                         ["--step-ms", str(fit1d["train1d_step_ms"])])
    prof = {net: timed_part(f"profile_{net}", profile.main,
                            ["--net", net, "--k", "4", "--top", "10"])
            for net in ("unet2d", "unet1d")}
    sweep_rows = timed_part("sweep", sweep.main, ["--k", "4"])["rows"]
    seconds = time.perf_counter() - t0
    step1d_k4 = multistep["train1d_step_k4_ms"]
    print(f"analysis: chained stages bit for bit make_movie_evaluator, FULL "
          f"{stages['full_ms']:.3f} ms against a stage sum of "
          f"{stages['stage_sum_ms']:.3f} ms; no row over its roofline; the "
          f"K1 row's mean bit for bit movie_summary; folded blocks within "
          f"{worst[1]:.2e} of their parity blocks' largest output (worst "
          f"{worst[0]}); the 1-D conv floor {floor1d['floor_ms']:.4f} ms a "
          f"step against {fit1d['train1d_step_ms']:.3f} ms (K=1) and "
          f"{step1d_k4:.3f} ms (K=4); K1 launches {launches}; {seconds:.1f} s "
          f"({', '.join(f'{k} {v:.2f}' for k, v in parts.items())}); {card}",
          flush=True)

    def slim(rows, keys):
        return [{k: r[k] for k in keys} for r in rows]

    numbers = {
        "stages": slim(stages["rows"], ("stage", "ms", "min_ms", "max_ms")),
        "stage_sum_ms": stages["stage_sum_ms"], "full_ms": stages["full_ms"],
        "layers": slim(parity["rows"], ("block", "ms", "roof_ms")),
        "layers_fast": slim(folded["rows"], ("block", "ms", "roof_ms")),
        "fold_max_rel": fold_rel,
        "floor1d_ms": floor1d["floor_ms"],
        "profile": {net: {"step_ms": p["step_ms"], "device_ms": p["device_ms"],
                          "buckets": {r["name"]: r["ms_per_step"]
                                      for r in p["rows"]
                                      if r["what"] == "bucket"}}
                    for net, p in prof.items()},
        "sweep": slim(sweep_rows, ("row", "step_ms", "tflops", "device_ms",
                                   "kernels", "idle")),
        "seconds": seconds, "part_seconds": parts}
    return launches, numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    t0 = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = round(time.perf_counter() - t, 2)
        return out

    dev, card = timed("device", phase_device)
    timed("build", phase_build)
    err, timing = timed("k1", phase_k1, dev, args.seed, FRAMES)
    timed("golden", phase_golden, dev)
    eval_launches, eval_ms, main_ctx = timed("evaluate", phase_main, dev,
                                             args.seed, FRAMES)
    golden_errs = timed("train_golden", phase_train_golden, dev)
    fit_launches, fit, fit_ctx = timed("fit", phase_fit, dev, args.seed)
    fold_err, fold = timed("fold", phase_fold, dev, args.seed)
    stream_launches, stream = timed("stream", phase_stream, dev, main_ctx)
    tiled_launches, tiled, tiled_movie = timed("tiled", phase_tiled, dev,
                                               main_ctx, args.seed)
    predict = timed("predict", phase_predict, dev, main_ctx, tiled_movie)
    golden1d_err = timed("golden1d", phase_golden1d, dev)
    golden1d_errs = timed("train_golden1d", phase_train_golden1d, dev)
    fit1d, fit1d_ctx = timed("fit1d", phase_fit1d, dev, args.seed, card)
    multistep = timed("multistep", phase_multistep, dev, card, args.seed,
                      fit_ctx, fit, fit1d_ctx, fit1d)
    predict1d = timed("predict1d", phase_predict1d, dev, fit1d_ctx, card)
    glm = timed("glm", phase_glm, dev, fit1d_ctx, card)
    segment = timed("segment", phase_segment, dev, main_ctx, card)
    stencil = timed("stencil", phase_stencil, dev, args.seed, card)
    flow_kernels = timed("flows", phase_flows, dev, args.seed, card)
    attention = timed("attention", phase_attention, dev, args.seed, card)
    cli_launches, cli = timed("cli", phase_cli, dev, main_ctx, fit1d_ctx, card)
    par_launches, parallel = timed("parallel", phase_parallel, dev, main_ctx,
                                   card, args.seed)
    ex_launches, examples = timed("examples", phase_examples, dev, main_ctx,
                                  fit_ctx, card, args.seed)
    an_launches, analysis = timed("analysis", phase_analysis, dev, main_ctx,
                                  fit1d, multistep, card)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "deepcalcium_tpu"))
    if bad:
        raise AssertionError(f"the port imported {bad}")
    # K1's least time at the main path's shape: it must read the int16 movie
    # once and write two float32 images; its adds and compares are far
    # below the card's rate.
    k1_bytes = FRAMES * WINDOW * WINDOW * 2 + 2 * WINDOW * WINDOW * 4
    by_path = {"evaluate": eval_launches, "fit": fit_launches,
               "stream": stream_launches, "tiled": tiled_launches,
               "fit1d": fit1d["k1_launches"],
               "fit_perf": multistep["fit_perf"]["k1_launches"],
               "predict1d": predict1d["k1_launches"],
               "glm": glm["k1_launches"],
               "segment": segment["k1_launches"], "cli": cli_launches,
               "parallel": par_launches, "examples": ex_launches,
               "analysis": an_launches}
    print(json.dumps({"kernels": [{
        "name": "K1 movie_summary_cuda (+ fold entry movie_fold_cuda)",
        "route": "cuda",
        "source": "deepcalcium_torch/csrc/summary.cu",
        "replaces": "deepcalcium_tpu/ops/summary.py:94",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(err, fold_err), "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "fold_ms": fold["ms"], "fold_plain_ms": fold["plain_ms"],
        "fold_bound_ms": fold["bound_ms"], "fold_shape": fold["shape"]}, {
        "name": "Euler steps euler_steps_cuda, diffusion diffuse_cuda",
        "route": "cuda", "source": "deepcalcium_torch/csrc/flows.cu",
        "replaces": None, **flow_kernels}, {
        "name": "Cellpose-SAM attention attention_qkv_cuda",
        "route": "cuda", "source": "deepcalcium_torch/csrc/attention.cu",
        "replaces": None, **attention}],
        "evaluate_ms": eval_ms, "train_golden_max_abs_err": golden_errs,
        "fit": fit, "stream": stream, "tiled": tiled, "predict": predict,
        "golden1d_max_abs_err": golden1d_err,
        "train_golden1d_max_abs_err": golden1d_errs, "fit1d": fit1d,
        "multistep": multistep,
        "predict1d": predict1d, "glm": glm, "segment": segment,
        "stencil": stencil, "cli": cli, "parallel": parallel, "examples": examples,
        "analysis": analysis,
        "card": card,
        "phase_seconds": phase_s, "seconds": time.perf_counter() - t0}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
