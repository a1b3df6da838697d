"""Mask summary: flatten N per-neuron masks to one 2-D mask, erasing pixels
where different neurons touch or overlap.

Port of ``deepcalcium_tpu.ops.mask_summary``:

- :func:`mask_summary_exact`, a numpy copy of the sequential walk. It runs
  once per dataset on the host, for training targets and scoring.
- :func:`mask_summary_stencil`, the vectorised parallel approximation, in
  PyTorch ops on the device the caller names: a pixel survives iff it is
  covered by exactly one neuron, no single-covered 8-neighbour carries
  another id, and no neighbour is conflicted (conflicts dilated by 3x3). It
  only ever deletes more than the walk, never adds a pixel. All of it is
  int32 arithmetic, so every device gives the same bits. It is a tested
  alternative behind the ``mask_summary_func`` injection point, on no hot
  path; no kernel is written for it.
"""

import numpy as np
import torch

from deepcalcium_torch.utils.device import require_cuda

__all__ = ["mask_summary_exact", "mask_summary_stencil", "id_map_from_stack"]

_NBRS = [(-1, 0), (1, 0), (0, -1), (0, 1), (1, 1), (-1, -1), (1, -1), (-1, 1)]


def mask_summary_exact(msks: np.ndarray) -> np.ndarray:
    """Sequential mask summary, in the reference's iteration order.

    1. Keep only pixels covered by exactly one neuron.
    2. Walk those pixels in z-major discovery order; where a pixel's
       surviving 3x3 neighbourhood holds more than one neuron id, delete the
       whole surviving neighbourhood. Deletions are seen by later steps.

    # Arguments
        msks: (N, H, W) stack of binary per-neuron masks.

    # Returns
        (H, W) float64 array with 1.0 at surviving pixels.
    """
    msks = np.asarray(msks)
    zz, yy, xx = np.where(msks == 1)

    counts: dict = {}
    for z, y, x in zip(zz.tolist(), yy.tolist(), xx.tolist()):
        counts.setdefault((y, x), []).append(z)
    yx_z = {k: v[0] for k, v in counts.items() if len(v) == 1}

    for y, x in list(yx_z.keys()):
        nbrs = [(y + dy, x + dx) for dy, dx in _NBRS + [(0, 0)]
                if (y + dy, x + dx) in yx_z]
        if not nbrs:
            continue
        if len({yx_z[k] for k in nbrs}) > 1:
            for k in nbrs:
                del yx_z[k]

    summ = np.zeros(msks.shape[1:], dtype=np.float64)
    if yx_z:
        ys, xs = zip(*yx_z.keys())
        summ[list(ys), list(xs)] = 1.0
    return summ


def _stack_on(msks, device) -> torch.Tensor:
    """The (N, H, W) stack as an int32 tensor on ``device`` ("cuda" raises
    without a card)."""
    device = torch.device(device)
    if device.type == "cuda":
        require_cuda()
    if not isinstance(msks, torch.Tensor):
        msks = torch.from_numpy(np.ascontiguousarray(msks))
    return msks.to(device).to(torch.int32)


def id_map_from_stack(msks, device="cuda"):
    """(N, H, W) binary stack -> (cover_count, id_map), both (H, W) int32
    tensors on ``device``. ``id_map`` holds the 1-based neuron id at
    single-covered pixels, 0 elsewhere."""
    m = _stack_on(msks, device)
    ids = torch.arange(1, m.shape[0] + 1, dtype=torch.int32,
                       device=m.device)[:, None, None]
    cover = m.sum(dim=0, dtype=torch.int32)
    idsum = (m * ids).sum(dim=0, dtype=torch.int32)
    return cover, torch.where(cover == 1, idsum, torch.zeros_like(idsum))


def _edge_mask(shape, dy, dx, device):
    h, w = shape
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    return (((rows >= dy) & (rows < h + dy))
            & ((cols >= dx) & (cols < w + dx))).to(torch.int32)


def _shift2d(x, dy, dx):
    """Shift an (H, W) map by (dy, dx), zero-filling: a stencil tap."""
    return (torch.roll(x, (dy, dx), dims=(0, 1))
            * _edge_mask(x.shape, dy, dx, x.device))


def mask_summary_stencil(msks, device="cuda") -> torch.Tensor:
    """Vectorised (parallel-semantics) mask summary; see the module
    docstring.

    # Arguments
        msks: (N, H, W) binary stack, a numpy array or a tensor of any
            numeric dtype.
        device: where it runs; "cuda" (the default) raises without a card.

    # Returns
        (H, W) float32 tensor on ``device`` with 1.0 at surviving pixels.
    """
    _, id_map = id_map_from_stack(msks, device)
    present = (id_map > 0).to(torch.int32)

    # conflict[p] = any 8-neighbour present with a different id.
    conflict = torch.zeros_like(present)
    for dy, dx in _NBRS:
        nid = _shift2d(id_map, dy, dx)
        npres = _shift2d(present, dy, dx)
        conflict |= ((npres == 1) & (nid != id_map)).to(torch.int32)
    conflict *= present

    # Deleting a conflicted pixel removes its whole present neighbourhood:
    # dilate the conflicts by the 3x3 window.
    deleted = conflict.clone()
    for dy, dx in _NBRS:
        deleted |= _shift2d(conflict, dy, dx)

    return ((present == 1) & (deleted == 0)).to(torch.float32)
