"""The steps of Segment Anything's automatic mask generator around the net
(``segment_anything/automatic_mask_generator.py`` and ``utils/amg.py``), on
the device of their tensors, for one crop of the whole image.

- :func:`point_grid`: ``build_point_grid``, n x n points at the centres of
  an n x n partition of [0, 1]^2, x fastest;
- :func:`preprocess_shape`, :func:`prompt_points`: ``ResizeLongestSide``'s
  size and ``apply_coords``, the grid scaled to the image and then to the
  encoder's frame;
- :func:`postprocess_masks`: ``Sam.postprocess_masks``, logits bilinearly
  to the encoder's square, cropped to the resized image, bilinearly to the
  image (``align_corners=False``);
- :func:`stability_score`: ``calculate_stability_score``, the share of the
  pixels above ``threshold - offset`` that lie above ``threshold +
  offset``;
- :func:`mask_to_box`: ``batched_mask_to_box``, XYXY boxes with inclusive
  maxima, zeros for an empty mask;
- :func:`box_nms`: ``torchvision.ops.batched_nms`` with one category (no
  torchvision here): greedy, in order of decreasing score with ties taken
  in index order, a box dropped where its IoU with a kept box exceeds the
  threshold; IoU = intersection / (area + area - intersection) of the
  boxes' corner differences, as torchvision computes it;
- :func:`paint_labels`: a label image of kept masks, painted largest
  first so that smaller masks lie on top, labels 1...n in that order, and
  that order (the generator itself returns run-length encodings, which are
  left out).
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["point_grid", "preprocess_shape", "prompt_points",
           "postprocess_masks", "stability_score", "mask_to_box", "box_nms",
           "paint_labels"]


def point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) float64 points (x, y) in [0, 1]: the centres of an n x n
    grid, row by row."""
    offset = 1 / (2 * n_per_side)
    side = np.linspace(offset, 1 - offset, n_per_side)
    xs = np.tile(side[None, :], (n_per_side, 1))
    ys = np.tile(side[:, None], (1, n_per_side))
    return np.stack([xs, ys], axis=-1).reshape(-1, 2)


def preprocess_shape(h: int, w: int, long_side: int):
    """(new h, new w) of an h x w image whose longer side is resized to
    ``long_side``."""
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def prompt_points(n_per_side: int, h: int, w: int, long_side: int):
    """The grid's points (x, y) in the frame of the resized h x w image,
    float64: scaled to the image, then by the resize's factors."""
    nh, nw = preprocess_shape(h, w, long_side)
    pts = point_grid(n_per_side) * np.array([w, h], dtype=np.float64)
    return pts * np.array([nw / w, nh / h])


def postprocess_masks(logits: torch.Tensor, input_size, original_size,
                      image_size: int) -> torch.Tensor:
    """(..., H, W) float32 logits of (..., h, w) low-resolution ones: to
    ``image_size`` square, cropped to ``input_size``, to ``original_size``."""
    lead = logits.shape[:-2]
    x = logits.reshape((-1, 1) + logits.shape[-2:]).float()
    x = F.interpolate(x, (image_size, image_size), mode="bilinear",
                      align_corners=False)
    x = x[..., :input_size[0], :input_size[1]]
    x = F.interpolate(x, tuple(original_size), mode="bilinear",
                      align_corners=False)
    return x.reshape(lead + x.shape[-2:])


def stability_score(masks: torch.Tensor, threshold: float,
                    offset: float) -> torch.Tensor:
    """#(logit > threshold + offset) / #(logit > threshold - offset) of
    each (H, W) mask of logits, float32 (NaN where the second is 0)."""
    hi = (masks > threshold + offset).sum((-1, -2), dtype=torch.int32)
    lo = (masks > threshold - offset).sum((-1, -2), dtype=torch.int32)
    return hi / lo


def mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """(..., 4) int64 boxes (x0, y0, x1, y1), inclusive, of boolean (...,
    H, W) masks; (0, 0, 0, 0) for an empty mask."""
    h, w = masks.shape[-2:]
    rows = masks.any(-1)
    cols = masks.any(-2)
    iy = torch.arange(h, device=masks.device)
    ix = torch.arange(w, device=masks.device)
    bottom = torch.where(rows, iy, -1).amax(-1)
    top = torch.where(rows, iy, h).amin(-1)
    right = torch.where(cols, ix, -1).amax(-1)
    left = torch.where(cols, ix, w).amin(-1)
    box = torch.stack([left, top, right, bottom], dim=-1)
    return box * (bottom >= top)[..., None]


def box_nms(boxes: torch.Tensor, scores: torch.Tensor,
            iou_threshold: float) -> torch.Tensor:
    """Indices of the boxes kept, in order of decreasing score (ties in
    index order): greedy non-maximum suppression. Every box's IoU with
    every later one is computed at once; the greedy sweep, "kept unless a
    kept earlier box overlaps it above the threshold", is then reached as
    the fixed point of that rule applied to every box at once, which holds
    once the first k boxes are settled after k rounds and stops as soon as
    a round changes nothing."""
    n = boxes.shape[0]
    order = torch.sort(scores, descending=True, stable=True).indices
    if n == 0:
        return order
    b = boxes[order].float()
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(b[:, None, :2], b[None, :, :2])
    rb = torch.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    over = (inter / (area[:, None] + area[None, :] - inter) > iou_threshold)
    over = over.triu(1)
    keep = torch.ones(n, dtype=torch.bool, device=boxes.device)
    while True:
        new = ~(over & keep[:, None]).any(0)
        if torch.equal(new, keep):
            return order[keep]
        keep = new


def paint_labels(masks: torch.Tensor):
    """(the (H, W) int32 label image, the paint order) of boolean (n, H, W)
    masks: the masks sorted by area, largest first (ties in index order),
    labelled 1...n in that order, each painted over the ones before it;
    the order is the masks' indices, label by label."""
    area = masks.sum((1, 2))
    order = torch.sort(area, descending=True, stable=True).indices
    if masks.shape[0] == 0:
        return torch.zeros(masks.shape[1:], dtype=torch.int32,
                           device=masks.device), order
    label = torch.arange(1, masks.shape[0] + 1, dtype=torch.int32,
                         device=masks.device)
    return torch.where(masks[order], label[:, None, None], 0).amax(0), order
