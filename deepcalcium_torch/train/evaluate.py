"""Full-image prediction from a movie or a mean image: z-norm, reflect-pad
to the window, 8x test-time augmentation in one batched forward, threshold.

Port of ``deepcalcium_tpu.train.evaluate`` (``_image_eval_body``,
``make_movie_evaluator``, ``make_summary_evaluator``, ``reflect_pad_to``,
``predict_batched``). The JAX package compiles each evaluator into one
graph; here the same steps run eagerly on the device of the tensors they are
given, so the builders only check shapes and close over the model.
"""

import numpy as np
import torch

from deepcalcium_torch.ops.augment import tta_collapse, tta_expand
from deepcalcium_torch.ops.summary import movie_summary_fast

__all__ = ["reflect_pad_to", "make_movie_evaluator", "make_summary_evaluator",
           "predict_batched"]


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


def _image_eval_body(forward, image_shape, window, tta, threshold):
    """z-norm -> reflect-pad -> (8x TTA) forward -> invert and average ->
    threshold, from a mean image. ``forward`` maps (B, H, W) to (B, H, W)
    probabilities."""
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
                           threshold=0.5):
    """Evaluator from a mean image.

    # Returns
        evaluate(mean (H, W) float32) -> (mask uint8 (H, W),
        prob float32 (H, W)), on the mean's device.
    """
    body = _image_eval_body(forward, tuple(image_shape), tuple(window),
                            bool(tta), float(threshold))

    @torch.inference_mode()
    def evaluate(mean):
        return body(mean)

    return evaluate


def make_movie_evaluator(forward, movie_shape, window=(512, 512), tta=True,
                         threshold=0.5):
    """Evaluator from a movie: summary (K1 on a CUDA movie) -> z-norm ->
    reflect-pad -> (8x TTA) forward -> invert and average -> threshold.
    ``UNet2DSummary.evaluate_movie`` runs through here.

    # Arguments
        forward: (B, H, W) -> (B, H, W) probabilities, e.g. a ``UNet2DS``.
        movie_shape: (T, H, W) of the movies this evaluator serves.
        window: inference window (at least the frame, multiples of 16).
        tta: run the 8 dihedral views as one batch and average them.

    # Returns
        evaluate(movie) -> (mask uint8 (H, W), prob float32 (H, W),
        mean float32 (H, W)), on the movie's device.
    """
    t, h, w = movie_shape
    body = _image_eval_body(forward, (h, w), tuple(window), bool(tta),
                            float(threshold))

    @torch.inference_mode()
    def evaluate(movie):
        if tuple(movie.shape) != (t, h, w):
            raise ValueError(f"evaluator built for {(t, h, w)}, got "
                             f"{tuple(movie.shape)}")
        mean, _ = movie_summary_fast(movie)
        mask, prob = body(mean)
        return mask, prob, mean

    return evaluate


def predict_batched(fwd, images, device, window=(512, 512), max_batch=None):
    """Predict a list of (H_i, W_i) images; returns same-shaped float32
    numpy probability maps.

    Each image is copied to ``device``, where ``fwd``'s net lives, and
    reflect-padded to ``window`` at the bottom and right; the stack runs
    through ``fwd`` ((B, H, W) -> (B, H, W)) in slabs of ``max_batch`` (all at once by default); each map
    is cropped back to its image. Unlike the JAX package, the last slab is
    not zero-padded to ``max_batch``: there is no compiled shape to keep.
    """
    hw, ww = window
    batch = torch.stack([reflect_pad_to(torch.as_tensor(
        np.ascontiguousarray(s, np.float32), device=device), hw, ww)
        for s in images])
    step = max_batch or len(images)
    probs = torch.cat([fwd(batch[i:i + step])
                       for i in range(0, len(images), step)]).cpu().numpy()
    return [p[: s.shape[0], : s.shape[1]] for p, s in zip(probs, images)]
