"""Released-model download helper.

Copy of ``deepcalcium_tpu.utils.model_downloads``: an idempotent
``urlretrieve`` of the reference's released weights. The URLs point at Keras
HDF5 files; load them through :mod:`deepcalcium_torch.interop.keras_import`
(``model_path="....hdf5"`` does so).
"""

import logging
import os
from urllib import request

from deepcalcium_torch.utils.runtime import funcname

__all__ = ["UNET2DS_MODEL_URL", "UNET1D_MODEL_URL", "download_model"]

UNET2DS_MODEL_URL = (
    "https://github.com/alexklibisz/deep-calcium/releases/download/"
    "v0.0.1-weights/unet2ds_model.hdf5")
UNET1D_MODEL_URL = (
    "https://github.com/alexklibisz/deep-calcium/releases/download/"
    "v0.0.1-weights/unet1d_model.hdf5")


def download_model(url: str, save_path: str) -> str:
    """Idempotent model download; returns ``save_path``."""
    logger = logging.getLogger(funcname())
    if os.path.exists(save_path):
        logger.info("Model already downloaded at %s", save_path)
        return save_path
    logger.info("Downloading model from %s to %s", url, save_path)
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    # tmp + rename: a file at save_path counts as complete for ever after,
    # so a partial download must never land there.
    tmp = save_path + ".tmp"
    request.urlretrieve(url, tmp)
    os.replace(tmp, save_path)
    logger.info("Download complete.")
    return save_path
