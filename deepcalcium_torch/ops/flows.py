"""Cellpose's flow dynamics: from blended flows (dY, dX) and a cell
probability to instance labels, on the flows' device; the hole filling of
the last step runs on the host.

The steps, as ``cellpose/dynamics.py`` runs them (each a span of the
program, under ``cellpose.dynamics``):

- ``follow_flows``: every pixel of ``cellprob > threshold`` moves 200
  Euler steps (on a card replays of a one-step CUDA graph) through
  ``dP * fg / 5``, bilinear (``grid_sample``, zero
  padding, ``align_corners=False``) on positions normalised as
  ``2 p / (L - 1) - 1`` and clamped to [-1, 1] (Cellpose's own mix of the
  two conventions); end points are truncated to integers.
- ``get_masks``: a histogram of the end points on the image padded by 20;
  seeds where it is a 5 x 5 maximum and above 10, by count ascending (ties
  in raster order); each grows 5 times by a 3 x 3 dilation inside its
  11 x 11 patch where the histogram is above 2, later seeds over earlier;
  each pixel takes the label at its end point; labels over
  ``max_size_fraction`` of the image are dropped; labels are renumbered in
  the raster order of their first pixel.
- ``flow_qc``: flows rebuilt from the masks by diffusion (float64) from
  each mask's pixel nearest its mean, for twice the largest bounding-box
  rows + 1 plus columns + 1 steps, ``log(1 + T)``, central differences,
  normalised; a mask whose mean squared gap to ``dP / 5`` exceeds
  ``flow_threshold`` is dropped.
- ``fill``: masks under ``min_size`` pixels dropped; each mask's holes
  filled (``ndimage.binary_fill_holes`` on its bounding box, in label
  order: on the host, all boxes at once unless a hole holds another mask);
  labels renumbered 1..n.

Every step counts what it handled (``profiling.count``): ``cellpose.seeds``,
``cellpose.qc_iters``, ``cellpose.masks`` and ``cellpose.masks_dropped``.
"""

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from deepcalcium_torch.utils.profiling import count, span

__all__ = ["follow_flows", "get_masks", "masks_to_flows",
           "remove_bad_flow_masks", "fill_holes_and_remove_small_masks",
           "compute_masks"]

RPAD = 20  # the histogram's padding
# Neighbours of a pixel as Cellpose lists them: itself, then (dy, dx).
_NY = (0, -1, 1, 0, 0, -1, -1, 1, 1)
_NX = (0, 0, 0, -1, 1, -1, 1, -1, 1)


def _repeat(step, times: int, device) -> None:
    """``step()`` ``times`` times. On a card the first runs as it is and
    the others as replays of a CUDA graph of one step, captured for this
    call: a step is a few small kernels, whose launches from the host
    would take longer than the card takes to run them."""
    if times <= 0:
        return
    step()
    if torch.device(device).type != "cuda":
        for _ in range(times - 1):
            step()
        return
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        graph.capture_begin()
        step()
        graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    for _ in range(times - 1):
        graph.replay()


def follow_flows(dP: torch.Tensor, inds: torch.Tensor,
                 niter: int = 200) -> torch.Tensor:
    """End points (n, 2) int64 (y, x) of the pixels ``inds`` (n, 2) after
    ``niter`` steps through ``dP`` (2, H, W), which is zero outside the
    foreground and already divided by 5."""
    h, w = dP.shape[1:]
    # Channel 0 moves x and channel 1 y, as grid_sample's grid is (x, y).
    im = torch.stack((dP[1] * (2.0 / (w - 1)), dP[0] * (2.0 / (h - 1))))[None]
    pt = torch.stack((inds[:, 1].float() / (w - 1),
                      inds[:, 0].float() / (h - 1)), dim=-1)
    pt = (pt * 2 - 1)[None, None].contiguous()

    def step():
        d = F.grid_sample(im, pt, align_corners=False)
        pt.add_(d.permute(0, 2, 3, 1)).clamp_(-1.0, 1.0)

    _repeat(step, niter, dP.device)
    p = (pt[0, 0] + 1) * 0.5
    return torch.stack((p[:, 1] * (h - 1), p[:, 0] * (w - 1)), dim=1).long()


def get_masks(p: torch.Tensor, inds: torch.Tensor, shape,
              max_size_fraction: float = 0.4):
    """(labels (H, W) int64 on the device, seeds, dropped): the masks of
    the end points ``p`` of the pixels ``inds``."""
    h, w = shape
    hp, wp = h + 2 * RPAD, w + 2 * RPAD
    dev = p.device
    flat = (p[:, 0] + RPAD) * wp + (p[:, 1] + RPAD)
    hist = torch.bincount(flat, minlength=hp * wp).view(hp, wp)
    hf = hist.float()
    hmax = F.max_pool2d(hf[None, None], 5, 1, 2)[0, 0]
    seeds = torch.nonzero((hf - hmax > -1e-6) & (hist > 10))
    labels = torch.zeros(h * w, dtype=torch.int64, device=dev)
    n_seeds = seeds.shape[0]
    if n_seeds == 0:
        return labels.view(h, w), 0, 0
    seeds = seeds[torch.sort(hist[seeds[:, 0], seeds[:, 1]],
                             stable=True).indices]
    off = torch.arange(-5, 6, device=dev)
    yy = seeds[:, 0, None, None] + off[None, :, None]
    xx = seeds[:, 1, None, None] + off[None, None, :]
    keep = (hist[yy, xx] > 2)[:, None].float()
    grown = torch.zeros((n_seeds, 1, 11, 11), device=dev)
    grown[:, 0, 5, 5] = 1.0
    for _ in range(5):
        grown = F.max_pool2d(grown, 3, 1, 1) * keep
    on = grown[:, 0] > 0
    at = (yy * wp + xx)[on]
    k = torch.arange(1, n_seeds + 1, device=dev)[:, None, None].expand(
        n_seeds, 11, 11)[on]
    seeded = torch.zeros(hp * wp, dtype=torch.int64, device=dev)
    # Later (larger) seeds over earlier: the largest index wins.
    seeded.scatter_reduce_(0, at, k, "amax")
    lab = seeded[flat]
    sizes = torch.bincount(lab, minlength=n_seeds + 1)
    big = sizes > max_size_fraction * h * w
    big[0] = False
    lab = torch.where(big[lab], 0, lab)
    # Renumber in the raster order of each label's first pixel.
    pix = inds[:, 0] * w + inds[:, 1]
    first = torch.full((n_seeds + 1,), h * w, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, lab, pix, "amin")
    first[0] = h * w
    order = torch.argsort(first, stable=True)
    new = torch.zeros(n_seeds + 1, dtype=torch.int64, device=dev)
    new[order] = torch.arange(1, n_seeds + 2, device=dev)
    new = torch.where(first < h * w, new, 0)
    labels[pix] = new[lab]
    dropped = int(((sizes > 0) & big).sum())
    return labels.view(h, w), n_seeds, dropped


def masks_to_flows(labels: torch.Tensor):
    """(mu (2, P) float64, y, x (P,) of the mask pixels, padded by one,
    their labels, steps): the unit flows that diffusion from each mask's
    centre gives, in float64, at every mask pixel."""
    h, w = labels.shape
    wp = w + 2
    lp = F.pad(labels, (1, 1, 1, 1))
    y, x = torch.nonzero(lp, as_tuple=True)
    lab = lp[y, x]
    n = int(lab.max())
    big = torch.iinfo(torch.int64).max
    ymin = torch.full((n + 1,), big, device=lab.device).scatter_reduce_(
        0, lab, y, "amin")
    xmin = torch.full((n + 1,), big, device=lab.device).scatter_reduce_(
        0, lab, x, "amin")
    ymax = torch.zeros(n + 1, dtype=torch.int64, device=lab.device
                       ).scatter_reduce_(0, lab, y, "amax")
    xmax = torch.zeros(n + 1, dtype=torch.int64, device=lab.device
                       ).scatter_reduce_(0, lab, x, "amax")
    present = ymax[1:] > 0
    steps = 2 * int(((ymax - ymin + 2) + (xmax - xmin + 2))[1:][present].max())
    # The centre: the pixel nearest the mean of the bounding box's local
    # coordinates, the first in raster order of equals.
    yl, xl = y - ymin[lab], x - xmin[lab]
    npx = torch.bincount(lab, minlength=n + 1).double()
    ym = torch.zeros(n + 1, dtype=torch.int64, device=lab.device
                     ).index_add_(0, lab, yl).double() / npx
    xm = torch.zeros(n + 1, dtype=torch.int64, device=lab.device
                     ).index_add_(0, lab, xl).double() / npx
    dist = (xl - xm[lab]) ** 2 + (yl - ym[lab]) ** 2
    dmin = torch.full((n + 1,), float("inf"), dtype=torch.float64,
                      device=lab.device).scatter_reduce_(0, lab, dist, "amin")
    rank = torch.arange(lab.numel(), device=lab.device)
    pick = torch.full((n + 1,), lab.numel(), dtype=torch.int64,
                      device=lab.device).scatter_reduce_(
        0, lab, torch.where(dist == dmin[lab], rank, lab.numel()), "amin")
    pick = pick[1:][present]
    centres = y[pick] * wp + x[pick]
    nb = torch.stack([(y + dy) * wp + (x + dx) for dy, dx in zip(_NY, _NX)])
    # T is held for the mask pixels alone, in nonzero's order, with one
    # slot more that stays 0: a neighbour outside the pixel's mask reads it.
    npix = lab.numel()
    slot = torch.full((lp.numel(),), npix, dtype=torch.int64,
                      device=lab.device)
    slot[nb[0]] = torch.arange(npix, device=lab.device)
    nbs = torch.where(lp.view(-1)[nb] == lab[None], slot[nb], npix)
    tc = torch.zeros(npix + 1, dtype=torch.float64, device=lab.device)
    at, ones = slot[centres], torch.ones_like(centres, dtype=torch.float64)

    def step():
        tc.index_add_(0, at, ones)
        # The 9 terms summed in Cellpose's neighbour order (a scan down the
        # first axis adds them one after another), then / 9: the result
        # does not hang on a reduction's order, which at a symmetric pixel
        # decides the sign of a central difference that is 0 exactly.
        torch.div(torch.cumsum(tc[nbs], dim=0)[-1], 9, out=tc[:npix])

    _repeat(step, steps, lab.device)
    t = torch.zeros(lp.numel(), dtype=torch.float64, device=lab.device)
    t[nb[0]] = tc[:npix]
    t = torch.log(1.0 + t)
    mu = torch.stack((t[nb[2]] - t[nb[1]], t[nb[4]] - t[nb[3]]))
    mu = mu / (1e-60 + (mu ** 2).sum(dim=0) ** 0.5)
    return mu, y, x, lab, steps


def remove_bad_flow_masks(labels: torch.Tensor, dP: torch.Tensor,
                          threshold: float = 0.4):
    """(labels with the masks whose flow error exceeds ``threshold`` set to
    0, steps, dropped). A mask's flow error is the mean over its pixels of
    the squared gap between its rebuilt flows and ``dP / 5``, summed over
    the two components."""
    mu, y, x, lab, steps = masks_to_flows(labels)
    n = int(lab.max())
    net = (dP / 5.0)[:, y - 1, x - 1].double()
    npx = torch.bincount(lab, minlength=n + 1).double().clamp_min(1)
    err = torch.zeros(n + 1, dtype=torch.float64, device=lab.device)
    for c in range(2):
        err += torch.zeros(n + 1, dtype=torch.float64, device=lab.device
                           ).index_add_(0, lab, (mu[c] - net[c]) ** 2) / npx
    bad = err > threshold
    bad[0] = False
    return torch.where(bad[labels], 0, labels), steps, int(bad.sum())


# In-plane 4-connectivity, no link across the stack's first axis.
_PLANE4 = np.zeros((3, 3, 3), bool)
_PLANE4[1] = ndimage.generate_binary_structure(2, 1)


def _box_holes(labels, boxes):
    """(label, y, x) arrays of every mask's holes, from one hole filling of
    the stack of the masks' bounding boxes; None where a hole holds
    another mask's pixels, whose filling order then matters."""
    lab = np.array([i for i, _ in boxes])
    y0, y1, x0, x1 = (np.array([getattr(s[a], b) for _, s in boxes])
                      for a, b in ((0, "start"), (0, "stop"), (1, "start"),
                                   (1, "stop")))
    h, w = labels.shape
    yy = y0[:, None] + np.arange((y1 - y0).max())
    xx = x0[:, None] + np.arange((x1 - x0).max())
    inside = (yy < y1[:, None])[:, :, None] & (xx < x1[:, None])[:, None, :]
    yy, xx = np.minimum(yy, h - 1), np.minimum(xx, w - 1)
    crop = labels[yy[:, :, None], xx[:, None, :]]
    msk = (crop == lab[:, None, None]) & inside
    hole = ndimage.binary_fill_holes(np.pad(msk, ((0, 0), (1, 1), (1, 1))),
                                     structure=_PLANE4)[:, 1:-1, 1:-1] & ~msk
    if crop[hole].any():
        return None
    k, a, b = np.nonzero(hole)
    return lab[k], yy[k, a], xx[k, b]


def fill_holes_and_remove_small_masks(labels: np.ndarray, min_size: int = 15):
    """(labels int32 renumbered 1..n, dropped): masks under ``min_size``
    pixels dropped, then each mask's holes (the pixels of its bounding box
    not 4-connected to its outside) given its label, in label order. The
    holes of every mask come from one filling of the stack of their boxes;
    where a hole holds another mask, the masks are filled one by one."""
    labels = np.array(labels, np.int32)
    sizes = np.bincount(labels.ravel())
    small = sizes < min_size
    small[0] = False
    if small.any():
        labels[small[labels]] = 0
    boxes = [(i + 1, s) for i, s in enumerate(ndimage.find_objects(labels))
             if s is not None]
    holes = _box_holes(labels, boxes) if boxes else None
    if holes is not None:
        lab, y, x = holes
        labels[y, x] = lab
    else:
        for i, slc in boxes:
            part = labels[slc]
            part[ndimage.binary_fill_holes(part == i, _PLANE4[1])] = i
    present = np.bincount(labels.ravel(), minlength=1) > 0
    present[0] = False
    renum = np.cumsum(present).astype(np.int32) * present
    return renum[labels], int((small & (sizes > 0)).sum())


def compute_masks(dP: torch.Tensor, inds: torch.Tensor, niter: int = 200,
                  flow_threshold: float = 0.4, min_size: int = 15,
                  max_size_fraction: float = 0.4) -> np.ndarray:
    """Host int32 (H, W) labels of the flows ``dP`` (2, H, W) and the
    foreground pixels ``inds`` (n, 2) (``cellprob > threshold``, found by
    the caller)."""
    shape = dP.shape[1:]
    dropped = 0
    labels = torch.zeros(shape, dtype=torch.int64, device=dP.device)
    if inds.shape[0]:
        with span("cellpose.follow_flows"):
            fg = torch.zeros(shape, dtype=dP.dtype, device=dP.device)
            fg[inds[:, 0], inds[:, 1]] = 1.0
            p = follow_flows(dP * fg / 5.0, inds, niter)
        with span("cellpose.get_masks"):
            labels, n_seeds, dropped = get_masks(p, inds, shape,
                                                 max_size_fraction)
            count("cellpose.seeds", n_seeds)
        with span("cellpose.flow_qc"):
            steps = 0
            if flow_threshold is not None and flow_threshold > 0 and \
                    n_seeds and int(labels.max()) > 0:
                labels, steps, bad = remove_bad_flow_masks(labels, dP,
                                                           flow_threshold)
                dropped += bad
            count("cellpose.qc_iters", steps)
    with span("cellpose.fill"):
        out, small = fill_holes_and_remove_small_masks(labels.cpu().numpy(),
                                                       min_size)
    count("cellpose.masks", int(out.max()))
    count("cellpose.masks_dropped", dropped + small)
    return out
