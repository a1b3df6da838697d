"""Spike segmentation with UNet1D on HDF5 trace datasets.

Counterpart of ``examples/spikes/unet1d_spikes.py``. Expects HDF5 files with
``traces`` (R, T), ``spikes`` (R, T), attr ``name``.

    python examples_torch/spikes/unet1d_spikes.py train data1.hdf5 data2.hdf5
    python examples_torch/spikes/unet1d_spikes.py crossval data.hdf5
    python examples_torch/spikes/unet1d_spikes.py predict data.hdf5 -m best.ckpt

Every command runs on the CUDA card; add ``--device cpu`` to run on the CPU
on purpose.
"""

import sys

sys.path.append(".")

from deepcalcium_torch import cli


def main(argv=None):
    """Translate ``train`` / ``crossval`` / ``predict`` into the command
    line's ``spikes-train`` / ``spikes-predict``; anything else prints the
    usage."""
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "train":
        cli.main(["spikes-train"] + args[1:])
    elif args and args[0] == "crossval":
        cli.main(["spikes-train", "--val_type", "cross_validate"] + args[1:])
    elif args and args[0] == "predict":
        cli.main(["spikes-predict"] + args[1:])
    else:
        print(__doc__)


if __name__ == "__main__":
    main()
