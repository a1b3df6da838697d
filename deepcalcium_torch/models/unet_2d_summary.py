"""UNet2DSummary: the neuron-segmentation wrapper, inference side.

Port of ``deepcalcium_tpu.models.unet_2d_summary.UNet2DSummary``: the
constructor, checkpoint loading, and ``evaluate_movie`` for a movie held as
a tensor or a numpy array. Training (``fit``), ``predict`` over dataset
files, Keras HDF5 weights, HDF5 movie paths and frames larger than the
window are later parts of the port (ROADMAP, Queue 1).
"""

import logging
import os

import numpy as np
import torch

from deepcalcium_torch.models.unet2d import from_jax_params
from deepcalcium_torch.train.checkpoints import (latest_checkpoint,
                                                 load_checkpoint)
from deepcalcium_torch.train.evaluate import make_movie_evaluator
from deepcalcium_torch.utils.config import checkpoints_dir
from deepcalcium_torch.utils.device import require_cuda

__all__ = ["UNet2DSummary"]


class UNet2DSummary:
    """Neuron-segmentation wrapper around ``UNet2DS``.

    # Arguments
        cpdir: checkpoint directory that ``model_path="latest"`` reads;
            None means ``<checkpoints_dir>/neurons_unet2ds``, resolved (and
            created) only when "latest" is asked for.
        compute_dtype: e.g. ``torch.bfloat16`` for the convs; None = float32.
        device: where movies are evaluated. The default, "cuda", raises when
            no card is present: the port never falls back to the CPU by
            itself. Pass "cpu" to run on the CPU on purpose.
    """

    def __init__(self, cpdir=None, compute_dtype=None, device="cuda"):
        self.cpdir = cpdir
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        if self.device.type == "cuda":
            require_cuda()

    def _load_params(self, model_path):
        """(params, state) in the JAX package's layout, from a ``.ckpt``
        written by either package, or the newest one in ``cpdir`` when
        ``model_path == "latest"``."""
        if model_path == "latest":
            cpdir = self.cpdir or os.path.join(checkpoints_dir(),
                                               "neurons_unet2ds")
            resolved = latest_checkpoint(cpdir)
            if resolved is None:
                raise FileNotFoundError(
                    f"model_path='latest' but no checkpoint exists in {cpdir}")
            model_path = resolved
        logging.getLogger(__name__).info("loading params from %s", model_path)
        if str(model_path).endswith((".hdf5", ".h5")):
            raise NotImplementedError(
                "Keras HDF5 weights are not ported yet (ROADMAP Queue 1 "
                "item 5: Keras import)")
        params, state, _ = load_checkpoint(model_path)
        return params, state

    def evaluate_movie(self, movie, model_path=None, params=None, state=None,
                       window_shape=(512, 512), tta=True, threshold=0.5,
                       fast="auto"):
        """Segment a raw movie: mean summary (kernel K1 on the card) ->
        z-norm -> reflect-pad -> (8x TTA) forward -> threshold.

        # Arguments
            movie: (T, H, W) tensor or numpy array; it is copied to
                ``self.device`` once if it is elsewhere.
            model_path: a ``.ckpt`` (or "latest"); or pass ``params`` and
                ``state`` in the JAX package's layout.
            window_shape: inference window; frames reflect-pad up to it.
            tta: run the 8 dihedral views as one batch.
            fast: fold BN into the convs and use the sigmoid head (exact up
                to float rounding). "auto" folds for a transpose-mode net
                and a window of multiples of 16; True/False forces.

        # Returns
            (mask uint8 (H, W), prob float32 (H, W)) as host numpy arrays.
        """
        if params is None:
            if model_path is None:
                raise ValueError("need model_path or params+state")
            params, state = self._load_params(model_path)
        elif state is None:
            raise ValueError("params given without state: pass both (state "
                             "carries the BN moving statistics)")
        if isinstance(movie, (str, os.PathLike)):
            raise NotImplementedError(
                "HDF5 movie paths are not ported yet (ROADMAP Queue 1 item "
                "5: streaming evaluate)")
        if movie.shape[1] > window_shape[0] or movie.shape[2] > window_shape[1]:
            raise NotImplementedError(
                f"frames {tuple(movie.shape[1:])} exceed the window "
                f"{tuple(window_shape)}; tiled evaluate is not ported yet "
                f"(ROADMAP Queue 1 item 5)")

        model = from_jax_params(params, state, self.compute_dtype,
                                self.device).eval()
        use_fold = fast is True or (
            fast == "auto" and "up0_tconv" in params
            and all(s % 16 == 0 for s in window_shape))
        if use_fold:
            model = model.fold()

        if isinstance(movie, np.ndarray):
            movie = torch.from_numpy(np.ascontiguousarray(movie))
        movie = movie.to(self.device)
        evaluate = make_movie_evaluator(model, movie.shape,
                                        window=window_shape, tta=tta,
                                        threshold=threshold)
        mask, prob, _ = evaluate(movie)
        return mask.cpu().numpy(), prob.cpu().numpy()
