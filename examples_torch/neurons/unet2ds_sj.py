"""New-data workflow: ingest a custom TIFF dataset and predict with UNet2DS.

Counterpart of ``examples/neurons/unet2ds_sj.py`` (the St. Jude workflow):
TIFF glob + Matlab annotation export -> contract HDF5 (square bbox masks
from center coordinates + radius, corrupted-TIFF tolerance), then
test-time-augmented prediction with a pretrained model.

    python examples_torch/neurons/unet2ds_sj.py <name> '<tiffglob>' <mat_path> \
        --model model.ckpt [--dataset-path out.hdf5] [--device cpu]
"""

import argparse
import logging
import os
import sys

sys.path.append(".")

from deepcalcium_torch.data.custom import make_dataset_from_tiffs
from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary
from deepcalcium_torch.utils.config import checkpoints_dir, datasets_dir
from deepcalcium_torch.utils.device import require_cuda


def load_matlab_centers(mat_path):
    """Extract (centers, radius) from a Matlab annotation export.

    Two schemas are accepted:
    1. Flat (recommended for new data): top-level ``centers`` (2, N) array of
       (x, y) coordinates and scalar ``radius``.
    2. Legacy St. Jude export (the reference's structure):
       appStateData.mainAppVars -> point coords (pcx, pcy) and bbox radius.
    """
    import numpy as np
    from scipy.io import loadmat

    mat = loadmat(mat_path)
    if "centers" in mat and "radius" in mat:
        xy = np.asarray(mat["centers"], dtype=float)
        centers = [(int(round(x)), int(round(y))) for x, y in zip(xy[0], xy[1])]
        return centers, int(np.ravel(mat["radius"])[0])

    main_vars = mat["appStateData"]["mainAppVars"]
    pcx = np.ravel(main_vars[0][0][0][0][0][0])
    pcy = np.ravel(main_vars[0][0][0][0][0][1])
    centers = [(int(round(x)), int(round(y))) for x, y in zip(pcx, pcy)]
    radius = int(main_vars[0][0][0][0][2][0][0])
    return centers, radius


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("name")
    ap.add_argument("tiffglob")
    ap.add_argument("mat_path", nargs="?")
    ap.add_argument("--model", required=True, help="checkpoint path (.ckpt)")
    ap.add_argument("--dataset-path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the summaries fold and the model runs; the "
                         "default fails without a CUDA card")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        require_cuda()  # before any file is read or written

    ds_dir = os.path.join(datasets_dir(), "neurons_sj")
    os.makedirs(ds_dir, exist_ok=True)
    ds_path = args.dataset_path or os.path.join(ds_dir, f"{args.name}.hdf5")

    centers = radius = None
    if args.mat_path:
        centers, radius = load_matlab_centers(args.mat_path)
    make_dataset_from_tiffs(args.name, args.tiffglob, ds_path,
                            centers=centers, radius=radius,
                            device=args.device)

    cpdir = os.path.join(checkpoints_dir(), "neurons_unet2ds_sj")
    model = UNet2DSummary(cpdir=cpdir, device=args.device)
    return model.predict([ds_path], model_path=args.model,
                         window_shape=(512, 512), augmentation=True,
                         save=True, print_scores=centers is not None)


if __name__ == "__main__":
    main()
