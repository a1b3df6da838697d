"""Layer-activation visualization for UNet2DS.

Counterpart of ``examples/analysis/activation_maps.py``: renders per-block
mean activation maps for a checkpoint on a dataset's summary image.

    python examples_torch/analysis/activation_maps.py dataset.hdf5 model.ckpt out/
        [--device cpu]
"""

import argparse
import os
import sys

sys.path.append(".")

import numpy as np


def _summary(ds_path):
    """The z-scored summary image of a dataset file. Private: a machine
    without h5py replaces it with one that hands over an in-memory image."""
    from deepcalcium_torch.models.unet_2d_summary import summarize_series

    return summarize_series(ds_path)


def _save_png(path, arr):
    from deepcalcium_torch.utils.visualization import save_png

    save_png(path, arr)


def activation_maps(params, state, img, device):
    """(probs (H', W') tensor, {block: (C, H'', W'') tensor}) of the net on
    ``img`` reflect-padded to a square of the next multiple of 16: the 18
    conv-BN-ReLU blocks that ``UNet2DS.forward(capture=)`` fills."""
    import torch

    from deepcalcium_torch.models.unet2d import from_jax_params
    from deepcalcium_torch.train.evaluate import reflect_pad_to

    net = from_jax_params(params, state, device=device).eval()
    hw = max(-(-d // 16) * 16 for d in img.shape)
    x = reflect_pad_to(torch.as_tensor(np.asarray(img), dtype=torch.float32,
                                       device=device), hw, hw)[None]
    acts: dict = {}
    with torch.inference_mode():
        probs = net(x, capture=acts)
    return probs[0], {name: a[0] for name, a in acts.items()}


def main(argv=None):
    from deepcalcium_torch.train.checkpoints import load_checkpoint

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ds_path")
    ap.add_argument("ckpt")
    ap.add_argument("out_dir")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the net runs; the default fails without a "
                         "CUDA card")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from deepcalcium_torch.utils.device import require_cuda

        require_cuda()  # before any file is read or written
    os.makedirs(args.out_dir, exist_ok=True)

    params, state, _ = load_checkpoint(args.ckpt)
    probs, acts = activation_maps(params, state, _summary(args.ds_path),
                                  args.device)
    _save_png(os.path.join(args.out_dir, "prediction.png"),
              probs.cpu().numpy())

    for name, a in acts.items():
        m = a.float().mean(dim=0).cpu().numpy()  # mean over channels
        rng = m.max() - m.min()
        _save_png(os.path.join(args.out_dir, f"{name}.png"),
                  (m - m.min()) / (rng if rng > 0 else 1.0))
    print(f"wrote {len(acts) + 1} activation maps to {args.out_dir}")


if __name__ == "__main__":
    main()
