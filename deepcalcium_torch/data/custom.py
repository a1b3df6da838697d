"""Custom data: arbitrary TIFF stacks and annotations -> contract HDF5.

Port of ``deepcalcium_tpu.data.custom``:

- a TIFF glob -> ``series/{raw,mean,max}``, the summaries folded on the
  device the caller names;
- corrupted or missing TIFFs zero-fill with a warning;
- masks from explicit per-neuron binary masks, or from centres and a box
  radius (square masks, clipped at the border);
- idempotent: an existing dataset path is returned untouched.
"""

import logging
import os
from glob import glob

import numpy as np

from deepcalcium_torch.utils.runtime import funcname

__all__ = ["make_dataset_from_tiffs", "bbox_masks"]


def bbox_masks(centers, radius: int, shape) -> np.ndarray:
    """(x, y) centres and a radius -> (N, H, W) int8 square masks of side
    2 * radius, clipped at the image border."""
    h, w = shape
    masks = np.zeros((len(centers), h, w), np.int8)
    for idx, (x, y) in enumerate(centers):
        y0, y1 = max(0, y - radius), min(h, y + radius)
        x0, x1 = max(0, x - radius), min(w, x + radius)
        masks[idx, y0:y1, x0:x1] = 1
    return masks


def make_dataset_from_tiffs(name: str, tiffglob: str, dataset_path: str,
                            masks: np.ndarray | None = None,
                            centers=None, radius: int | None = None,
                            chunk: int = 64, device="cuda") -> str:
    """TIFF stack (and optional annotations) -> contract HDF5.

    # Arguments
        name: dataset name (stored as the file attr).
        tiffglob: glob for the TIFF frames, e.g. '/data/frames/*.tif'.
        dataset_path: output HDF5 path; returned untouched if it exists.
        masks: optional (N, H, W) binary neuron masks.
        centers, radius: the other annotation form -> square box masks.
        device: where the summaries fold; "cuda" without a card raises.
    """
    import h5py
    import torch

    from deepcalcium_torch.data._ingest import read_tiff, write_series
    from deepcalcium_torch.utils.device import require_cuda

    logger = logging.getLogger(funcname())
    if os.path.exists(dataset_path):
        logger.info("%s already exists.", dataset_path)
        return dataset_path
    if torch.device(device).type == "cuda":
        require_cuda()
    if masks is None and centers is not None and radius is None:
        raise ValueError("centers require a radius")

    paths = sorted(glob(tiffglob))
    if not paths:
        raise FileNotFoundError(f"no TIFFs match {tiffglob}")
    h, w = read_tiff(paths[0]).shape

    tmp = dataset_path + ".tmp"
    with h5py.File(tmp, "w") as fp:
        fp.attrs["name"] = name
        write_series(fp, paths, (h, w), chunk, device=device)

        if masks is None and centers is not None:
            masks = bbox_masks(centers, int(radius), (h, w))
        if masks is not None:
            fp.create_dataset("masks/raw", data=np.asarray(masks, np.int8),
                              dtype="int8")
            fp.create_dataset("masks/max", data=np.asarray(masks).max(axis=0),
                              dtype="int8")

    os.replace(tmp, dataset_path)
    logger.info("Done. File is %.2f GB on disk.",
                os.path.getsize(dataset_path) / 1024**3)
    return dataset_path
