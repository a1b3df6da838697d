"""Full-image prediction from a movie or a mean image: z-norm, reflect-pad
to the window, 8x test-time augmentation in one batched forward, threshold.

Port of ``deepcalcium_tpu.train.evaluate`` (``_image_eval_body``,
``make_movie_evaluator``, ``make_summary_evaluator``, ``reflect_pad_to``,
``predict_batched``, ``predict_tta``, ``tile_grid``, ``predict_tiled``,
``evaluate_movie_streaming``, ``evaluate_movie_tiled``). The JAX package
compiles each evaluator into one graph; here the same steps run eagerly on
the device of the tensors they are given, so the builders only check shapes
and close over the model.

A movie that lives on the host (an array, an open HDF5 dataset) is
evaluated without copying it to the device whole: its frames fold chunk by
chunk through ``StreamingSummary`` (K1's fold on the card), and only the
mean image, or its tiles, reach the net.

Every entry point takes ``mesh`` (a ``parallel.mesh.Mesh``): every rank
calls it with the same arguments and gets the whole result. The movie's
time axis is split over the ranks for the summary
(``ops.summary.movie_summary_sharded``), and each slab of views, images or
tiles is split over them for the forward and gathered (``_run_batched``).
"""

import numpy as np
import torch

from deepcalcium_torch.ops.augment import tta_collapse, tta_expand
from deepcalcium_torch.ops.summary import (StreamingSummary,
                                           movie_summary_fast,
                                           movie_summary_sharded)
from deepcalcium_torch.parallel.mesh import all_gather, check_mesh

__all__ = ["reflect_pad_to", "make_movie_evaluator", "make_summary_evaluator",
           "predict_batched", "predict_tta", "tile_grid", "predict_tiled",
           "evaluate_movie_streaming", "evaluate_movie_tiled"]


def _reflect_index(n: int, size: int, device) -> torch.Tensor:
    """Indices into a length-``n`` axis that extend it to ``size`` by
    reflection about the last element without repeating it, continued
    periodically with period 2(n - 1) when the pad reaches past n - 1, as
    ``np.pad(mode="reflect")`` does. A length-1 axis repeats its element,
    as numpy's does."""
    i = torch.arange(size, device=device)
    if n == 1:
        return torch.zeros_like(i)
    j = i % (2 * (n - 1))
    return torch.where(j < n, j, 2 * (n - 1) - j)


def reflect_pad_to(img: torch.Tensor, hw: int, ww: int) -> torch.Tensor:
    """Pad (H, W) -> (hw, ww) at the bottom and right by reflection, with
    ``np.pad(mode="reflect")`` semantics also when a pad is as large as the
    image or larger (``torch.nn.functional.pad`` refuses that)."""
    h, w = img.shape
    if h > hw or w > ww:
        raise ValueError(f"image {tuple(img.shape)} larger than window "
                         f"{(hw, ww)}")
    if (h, w) == (hw, ww):
        return img
    rows = _reflect_index(h, hw, img.device)
    cols = _reflect_index(w, ww, img.device)
    return img[rows[:, None], cols[None, :]]


def _image_eval_body(forward, image_shape, window, tta, threshold, mesh=None):
    """z-norm -> reflect-pad -> (8x TTA) forward -> invert and average ->
    threshold, from a mean image. ``forward`` maps (B, H, W) to (B, H, W)
    probabilities; under a ``mesh`` the views are split over the ranks."""
    if check_mesh(mesh) is not None:
        plain = forward
        forward = lambda views: _run_batched(plain, views, mesh=mesh)
    h, w = image_shape
    hw, ww = window
    if h > hw or w > ww:
        raise ValueError(f"image {(h, w)} larger than window {tuple(window)}")
    if tta and hw != ww:
        raise ValueError(f"TTA needs a square window (rot90 views); "
                         f"got {tuple(window)}")

    def body(mean):
        # Population std with a subnormal-scale floor: a constant image
        # gives z = 0 and finite probabilities instead of NaN.
        std = mean.std(correction=0).clamp_min(1e-12)
        z = reflect_pad_to((mean - mean.mean()) / std, hw, ww)
        if tta:
            probs = forward(tta_expand(z[None]).reshape(8, hw, ww))
            prob = tta_collapse(probs.reshape(8, 1, hw, ww))[0]
        else:
            prob = forward(z[None])[0]
        prob = prob[:h, :w]
        return (prob > threshold).to(torch.uint8), prob

    return body


def make_summary_evaluator(forward, image_shape, window=(512, 512), tta=True,
                           threshold=0.5, mesh=None):
    """Evaluator from a mean image; with a ``mesh`` the views of the
    forward are split over its ranks.

    # Returns
        evaluate(mean (H, W) float32) -> (mask uint8 (H, W),
        prob float32 (H, W)), on the mean's device.
    """
    body = _image_eval_body(forward, tuple(image_shape), tuple(window),
                            bool(tta), float(threshold), mesh)

    @torch.inference_mode()
    def evaluate(mean):
        return body(mean)

    return evaluate


def make_movie_evaluator(forward, movie_shape, window=(512, 512), tta=True,
                         threshold=0.5, mesh=None):
    """Evaluator from a movie: summary (K1 on a CUDA movie) -> z-norm ->
    reflect-pad -> (8x TTA) forward -> invert and average -> threshold.
    ``UNet2DSummary.evaluate_movie`` runs through here.

    # Arguments
        forward: (B, H, W) -> (B, H, W) probabilities, e.g. a ``UNet2DS``.
        movie_shape: (T, H, W) of the movies this evaluator serves.
        window: inference window (at least the frame, multiples of 16).
        tta: run the 8 dihedral views as one batch and average them.
        mesh: the movie's time axis is split over its ranks for the summary
            (each rank folds its frames of the movie, which every rank
            holds) and the views for the forward.

    # Returns
        evaluate(movie) -> (mask uint8 (H, W), prob float32 (H, W),
        mean float32 (H, W)), on the movie's device.
    """
    t, h, w = movie_shape
    body = _image_eval_body(forward, (h, w), tuple(window), bool(tta),
                            float(threshold), mesh)

    @torch.inference_mode()
    def evaluate(movie):
        if tuple(movie.shape) != (t, h, w):
            raise ValueError(f"evaluator built for {(t, h, w)}, got "
                             f"{tuple(movie.shape)}")
        if mesh is not None:
            mean, _ = movie_summary_sharded(movie, mesh)
        else:
            mean, _ = movie_summary_fast(movie)
        mask, prob = body(mean)
        return mask, prob, mean

    return evaluate


def _run_batched(fwd, batch: torch.Tensor, max_batch=None,
                 mesh=None) -> torch.Tensor:
    """Run ``fwd`` over a (N, H, W) batch in slabs of ``max_batch`` (all at
    once by default). Unlike the JAX package, the last slab is not
    zero-padded to ``max_batch``: there is no compiled shape to keep, and
    eval-mode BN does not depend on the batch.

    Under a ``mesh`` every rank holds the whole batch; each slab is
    zero-padded to a multiple of ``mesh.size``, each rank runs its part, an
    all-gather returns the whole slab on every rank, and the pad is cut."""
    def run(slab):
        if mesh is None:
            return fwd(slab)
        n = slab.shape[0]
        per = -(-n // mesh.size)
        lo = min(mesh.rank * per, n)
        mine = slab[lo:min(lo + per, n)]
        if mine.shape[0] < per:
            mine = torch.cat([mine, mine.new_zeros(
                (per - mine.shape[0],) + tuple(slab.shape[1:]))])
        return all_gather(fwd(mine), mesh)[:n]

    check_mesh(mesh)
    step = max_batch or batch.shape[0]
    with torch.inference_mode():
        return torch.cat([run(batch[i:i + step])
                          for i in range(0, batch.shape[0], step)])


def _padded_stack(images, device, window):
    hw, ww = window
    return torch.stack([reflect_pad_to(torch.as_tensor(
        np.ascontiguousarray(s, np.float32), device=device), hw, ww)
        for s in images])


def predict_batched(fwd, images, device, window=(512, 512), max_batch=None,
                    mesh=None):
    """Predict a list of (H_i, W_i) images; returns same-shaped float32
    numpy probability maps.

    Each image is copied to ``device``, where ``fwd``'s net lives, and
    reflect-padded to ``window`` at the bottom and right; the stack runs
    through ``fwd`` ((B, H, W) -> (B, H, W)) in slabs of ``max_batch``,
    each slab split over the ranks of ``mesh`` where one is given; each map
    is cropped back to its image.
    """
    probs = _run_batched(fwd, _padded_stack(images, device, window),
                         max_batch, mesh).cpu().numpy()
    return [p[: s.shape[0], : s.shape[1]] for p, s in zip(probs, images)]


def predict_tta(fwd, images, device, window=(512, 512), max_batch=None,
                mesh=None):
    """8x TTA prediction of a list of images as one batch of views; returns
    per-image float32 numpy maps. The views are expanded and collapsed on
    the device (the JAX package moves that to the host only to spare its
    link to a remote chip)."""
    hw, ww = window
    batch = _padded_stack(images, device, window)
    n = batch.shape[0]
    views = tta_expand(batch).reshape(8 * n, hw, ww)
    probs = _run_batched(fwd, views, max_batch, mesh)
    merged = tta_collapse(probs.reshape(8, n, hw, ww)).cpu().numpy()
    return [p[: s.shape[0], : s.shape[1]] for p, s in zip(merged, images)]


def tile_grid(shape, window=(512, 512), overlap=None):
    """(ys, xs) top-left corners of the sliding-window tiling of a
    ``shape`` = (H, W) image by ``window`` tiles.

    The single source of the tiling geometry: :func:`predict_tiled` builds
    its tiles from this grid, and ``UNet2DSummary.predict``'s views/s
    accounting counts ``len(ys) * len(xs)``.

    ``overlap``: pixels shared by adjacent tiles; None (default) picks
    ``min(64, min(window) // 2)`` so any window size works. Dimensions not
    exceeding the window produce a single row/column at corner 0.
    """
    hw, ww = window
    if overlap is None:
        overlap = min(64, min(hw, ww) // 2)
    if not (0 <= overlap < min(hw, ww)):
        raise ValueError(
            f"overlap must be in [0, min(window)) = [0, {min(hw, ww)}); "
            f"got {overlap}")
    h, w = shape
    ph, pw = max(h, hw), max(w, ww)
    stride_y = hw - overlap if ph > hw else hw
    stride_x = ww - overlap if pw > ww else ww
    ys = list(range(0, max(ph - hw, 0) + 1, stride_y))
    xs = list(range(0, max(pw - ww, 0) + 1, stride_x))
    if ys[-1] != ph - hw:
        ys.append(ph - hw)
    if xs[-1] != pw - ww:
        xs.append(pw - ww)
    return ys, xs


def predict_tiled(fwd, img, device, window=(512, 512), overlap=None,
                  max_batch=None, tta=False, mesh=None):
    """Sliding-window prediction of one (H, W) image that may exceed the
    window: tiles from :func:`tile_grid` (a dimension below the window is
    reflect-padded), run through ``fwd`` on ``device`` in slabs of
    ``max_batch`` windows, blended by averaging the overlaps in float64 on
    the host.

    ``tta``: 8x TTA per tile (views expand and collapse per tile: a rot90
    of the whole field of view would change which pixels share a window).
    ``max_batch`` (16 by default) bounds the device memory of one slab;
    under a ``mesh`` each slab is split over the ranks.

    # Returns
        (H, W) float32 numpy probability map.
    """
    img = np.asarray(img, np.float32)
    hw, ww = window
    max_batch = max_batch or 16
    if tta and hw != ww:
        raise ValueError(f"TTA needs a square window (rot90 views); "
                         f"got {window}")
    h, w = img.shape
    ph, pw = max(h, hw), max(w, ww)
    padded = np.pad(img, ((0, ph - h), (0, pw - w)), mode="reflect") \
        if (ph > h or pw > w) else img

    ys, xs = tile_grid((h, w), window, overlap)
    tiles = torch.from_numpy(np.stack(
        [padded[y:y + hw, x:x + ww] for y in ys for x in xs])).to(device)
    n = tiles.shape[0]
    if tta:
        views = tta_expand(tiles).reshape(8 * n, hw, ww)
        probs = tta_collapse(_run_batched(fwd, views, max_batch, mesh)
                             .reshape(8, n, hw, ww))
    else:
        probs = _run_batched(fwd, tiles, max_batch, mesh)
    probs = probs.cpu().numpy()

    acc = np.zeros((ph, pw), np.float64)
    cnt = np.zeros((ph, pw), np.float64)
    i = 0
    for y in ys:
        for x in xs:
            acc[y:y + hw, x:x + ww] += probs[i]
            cnt[y:y + hw, x:x + ww] += 1.0
            i += 1
    return (acc / cnt)[:h, :w].astype(np.float32)


def _streaming_mean(movie, chunk, device, mesh=None):
    """The float32 mean image of a (T, H, W) movie (an array, a tensor or
    an open HDF5 dataset), folded ``chunk`` frames at a time on
    ``device``. Only the mean is folded: the evaluate paths need no max.
    Under a ``mesh`` each rank folds its range of frames, on
    ``mesh.device``."""
    if check_mesh(mesh) is not None:
        return movie_summary_sharded(movie, mesh, chunk)[0].cpu().numpy()
    t, h, w = movie.shape
    ss = StreamingSummary((h, w), dtype=movie.dtype, device=device,
                          track_max=False)
    for i in range(0, t, chunk):
        ss.update(movie[i:i + chunk])
    mean, _ = ss.result()
    return mean


def evaluate_movie_streaming(fwd, movie, window=(512, 512), tta=True,
                             threshold=0.5, chunk=256, device="cuda",
                             mesh=None):
    """Evaluate a host-resident (T, H, W) movie (a numpy array or any
    sliceable, e.g. an open h5py dataset) without copying it to the device
    whole: its frames fold through :class:`StreamingSummary` in
    ``chunk``-frame slabs on ``device``, then the mean image runs the
    z-norm -> reflect-pad -> (8x TTA) forward -> threshold of the summary
    evaluator through ``fwd``, whose net lives on ``device``. Under a
    ``mesh`` each rank reads and folds only its range of frames, and the
    views are split over the ranks.

    # Returns
        (mask uint8 (H, W), prob float32 (H, W), mean float32 (H, W)) as
        host numpy arrays.
    """
    mean = _streaming_mean(movie, chunk, device, mesh)
    ev = make_summary_evaluator(fwd, mean.shape, window=window, tta=tta,
                                threshold=threshold, mesh=mesh)
    mask, prob = ev(torch.from_numpy(mean).to(device))
    return mask.cpu().numpy(), prob.cpu().numpy(), mean


def evaluate_movie_tiled(fwd, movie, window=(512, 512), tta=True,
                         threshold=0.5, overlap=None, max_batch=None,
                         chunk=256, device="cuda", mesh=None):
    """Evaluate a movie whose frames exceed the window: streaming mean on
    ``device`` -> z-norm on the host (population std with a 1e-12 floor, so
    a constant movie gives z = 0) -> :func:`predict_tiled` with per-tile
    TTA -> threshold. A ``mesh`` splits the frames of the fold and the
    tiles of each slab over its ranks.

    # Returns
        (mask uint8 (H, W), prob float32 (H, W), mean float32 (H, W)) as
        host numpy arrays.
    """
    mean = _streaming_mean(movie, chunk, device, mesh)
    z = (mean - np.mean(mean)) / max(float(np.std(mean)), 1e-12)
    prob = predict_tiled(fwd, z, device, window=window, overlap=overlap,
                         max_batch=max_batch, tta=tta, mesh=mesh)
    return (prob > threshold).astype(np.uint8), prob, mean
