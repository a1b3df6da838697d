"""Dataset statistics and throughput report.

Counterpart of ``examples/analysis/dataset_stats.py``: per-dataset
frame/neuron counts, positive-pixel proportion of the mask summaries
(the reference reported mean 0.126 across Neurofinder train), and an
end-to-end evaluate-throughput measurement through
``UNet2DSummary.evaluate_movie``.

    python examples_torch/analysis/dataset_stats.py all_train [--model m.ckpt]
        [--throughput] [--device cpu]
"""

import argparse
import logging
import sys
import time

sys.path.append(".")

import numpy as np


def _dataset_info(path):
    """(name, (T, H, W), number of neurons) of a contract HDF5. Private: a
    machine without h5py replaces it, and the wrapper's ``mask_summary_func``,
    with functions that read in-memory arrays."""
    import h5py

    with h5py.File(path, "r") as fp:
        name = fp.attrs["name"]
        shape = tuple(fp["series/raw"].shape)
        n = fp["masks/raw"].shape[0] if "masks" in fp else 0
    return (name if isinstance(name, str) else name.decode()), shape, n


def _wrapper(device):
    """The wrapper the report reads mask summaries and evaluates through."""
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary

    return UNet2DSummary(device=device)


def _throughput_movie(t, hw):
    """The movie of the throughput cell: incompressible int16 frames in one
    movie-sized host buffer (about 1.5 GB at the defaults)."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 2000, (t, hw, hw), dtype=np.int16)


def main(argv=None):
    import torch

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset_name", default="all_train")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="local contract-HDF5 dataset paths (skips download)")
    ap.add_argument("--model", help="checkpoint for the throughput cell "
                    "(default: fresh init; throughput is weight-agnostic)")
    ap.add_argument("--throughput", action="store_true",
                    help="run the evaluate-throughput cell through the "
                    "library's movie evaluator at realistic T")
    ap.add_argument("--throughput-frames", type=int, default=3000)
    ap.add_argument("--throughput-size", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the throughput cell runs; the default fails "
                         "without a CUDA card")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from deepcalcium_torch.utils.device import require_cuda

        require_cuda()  # before any download or dataset IO

    if args.paths:
        paths = args.paths
    else:
        from deepcalcium_torch.data.nf import nf_load_hdf5

        paths = nf_load_hdf5(args.dataset_name, device=args.device)
    model = _wrapper(args.device)

    total_frames = total_neurons = 0
    pos_props = []
    print(f"{'dataset':28s} {'frames':>7s} {'neurons':>8s} {'HxW':>10s} {'pos%':>6s}")
    for p in paths:
        name, (t, h, w), n = _dataset_info(p)
        total_frames += t
        total_neurons += n
        pos = np.nan
        if n:
            summ = model.mask_summary_func(p)
            pos = float(np.mean(summ))
            pos_props.append(pos)
        print(f"{name:28s} {t:7d} {n:8d} {h:5d}x{w:<4d} {pos:6.3f}")

    print(f"\ntotals: {total_frames} frames, {total_neurons} neurons, "
          f"mean positive-pixel proportion "
          f"{np.mean(pos_props) if pos_props else float('nan'):.3f}")

    result = {"frames": total_frames, "neurons": total_neurons}
    if args.throughput or args.model:
        # The library path users get on realistic movie lengths:
        # UNet2DSummary.evaluate_movie on a host movie (one copy to the
        # device, the summary kernel, the 8-view forward, the threshold).
        from deepcalcium_torch.models.unet2d import UNet2DS, to_jax_params

        t, hw = args.throughput_frames, args.throughput_size
        movie = _throughput_movie(t, hw)

        if args.model:
            params, state = model._load_params(args.model)
        else:
            params, state = to_jax_params(
                UNet2DS(nfb=32, generator=torch.Generator().manual_seed(0)))

        # Warm: the kernel's build and cuDNN's first calls, two calls at the
        # full movie length.
        for _ in range(2):
            model.evaluate_movie(movie, params=params, state=state,
                                 window_shape=(hw, hw))
        tic = time.time()
        mask, prob = model.evaluate_movie(movie, params=params, state=state,
                                          window_shape=(hw, hw))
        dt = time.time() - tic
        where = (torch.cuda.get_device_name(model.device)
                 if model.device.type == "cuda" else "the CPU")
        print(f"\nevaluate throughput (evaluate_movie, {t} frames @ "
              f"{hw}x{hw}, warm, on {where}): {t / dt * 60:,.0f} frames/min "
              f"= {t / dt:,.1f} frames/s")
        result.update(mask=mask, prob=prob, seconds=dt,
                      frames_per_s=t / dt)
    return result


if __name__ == "__main__":
    main()
