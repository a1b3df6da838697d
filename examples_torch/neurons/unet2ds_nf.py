"""Neurofinder training and prediction using UNet2DS: example entry point.

Counterpart of ``examples/neurons/unet2ds_nf.py``. The argparse surface
lives in :mod:`deepcalcium_torch.cli`; this shim keeps the familiar
invocation:

    python examples_torch/neurons/unet2ds_nf.py train all_train
    python examples_torch/neurons/unet2ds_nf.py evaluate neurofinder.00.00 -m m.ckpt
    python examples_torch/neurons/unet2ds_nf.py predict all_test -m m.ckpt

Every command runs on the CUDA card; add ``--device cpu`` to run on the CPU
on purpose.
"""

import sys

sys.path.append(".")

from deepcalcium_torch.cli import main

if __name__ == "__main__":
    main()
