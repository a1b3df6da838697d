"""Export Neurofinder datasets as movies with neuron outlines.

Counterpart of ``examples/neurons/nf_videos.py``. No model runs; a dataset
that still has to be ingested folds its summaries on ``--device``.

    python examples_torch/neurons/nf_videos.py neurofinder.00.00 [out_dir] \
        [--device cpu]
"""

import argparse
import logging
import os
import sys

sys.path.append(".")

from deepcalcium_torch.data.nf import nf_load_hdf5
from deepcalcium_torch.utils.device import require_cuda
from deepcalcium_torch.utils.visualization import dataset_to_mp4


def main(argv=None):
    import h5py

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("names", nargs="?", default="all_train")
    ap.add_argument("out_dir", nargs="?", default=".")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where an ingest folds the summaries; the default "
                         "fails without a CUDA card")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        require_cuda()  # before any file is read or written
    for p in nf_load_hdf5(args.names, device=args.device):
        with h5py.File(p, "r") as fp:
            name = fp.attrs["name"]
            s = fp["series/raw"][...]
            m = fp["masks/raw"][...] if "masks" in fp else None
        dataset_to_mp4(s, m, os.path.join(args.out_dir, f"{name}.mp4"))


if __name__ == "__main__":
    main()
