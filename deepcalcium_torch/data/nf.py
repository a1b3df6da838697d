"""Neurofinder dataset layer: registry, download, HDF5 ingest, submissions.

Port of ``deepcalcium_tpu.data.nf``:

- the 28-dataset registry and S3 URL map, the special names ``all`` /
  ``all_train`` / ``all_test`` and comma-splitting;
- the idempotent download -> unzip -> delete flow;
- the HDF5 contract: ``series/{raw,mean,max}``, ``masks/{raw,max}``, attr
  ``name``; mean stored float16, raw and max int16;
- ingest from a TIFF tree, the summaries folded on the device the caller
  names (K1's fold on the card; "cuda" without a card raises before any
  file is read);
- ``nf_submit``, which emits every labelled region (the reference drops
  the last one, ``nf.py:205``), as the JAX package does.

``h5py`` and ``requests`` are imported inside the functions that need them.
"""

import json
import logging
import os
import shutil
import zipfile
from glob import glob

import numpy as np
import torch

from deepcalcium_torch.metrics.neurofinder import label_mask, mask_to_regions  # noqa: F401 (re-export)
from deepcalcium_torch.utils.config import datasets_dir
from deepcalcium_torch.utils.device import require_cuda
from deepcalcium_torch.utils.runtime import funcname

__all__ = ["NEUROFINDER_NAMES", "NAME_TO_URL", "nf_load_hdf5", "nf_submit",
           "ingest_tiff_dataset"]

NEUROFINDER_NAMES = sorted([
    "neurofinder.00.00", "neurofinder.00.01", "neurofinder.00.02",
    "neurofinder.00.03", "neurofinder.00.04", "neurofinder.00.05",
    "neurofinder.00.06", "neurofinder.00.07", "neurofinder.00.08",
    "neurofinder.00.09", "neurofinder.00.10", "neurofinder.00.11",
    "neurofinder.01.00", "neurofinder.01.01", "neurofinder.02.00",
    "neurofinder.02.01", "neurofinder.03.00", "neurofinder.04.00",
    "neurofinder.04.01", "neurofinder.00.00.test", "neurofinder.00.01.test",
    "neurofinder.01.00.test", "neurofinder.01.01.test", "neurofinder.02.00.test",
    "neurofinder.02.01.test", "neurofinder.03.00.test", "neurofinder.04.00.test",
    "neurofinder.04.01.test"])

NAME_TO_URL = {
    name: f"https://s3.amazonaws.com/neuro.datasets/challenges/neurofinder/{name}.zip"
    for name in NEUROFINDER_NAMES
}


def _resolve_names(names):
    """Special names and comma-splitting (reference nf.py:57-67)."""
    if isinstance(names, str) and names.lower() == "all":
        return list(NEUROFINDER_NAMES)
    if isinstance(names, str) and names.lower() == "all_train":
        return sorted(n for n in NEUROFINDER_NAMES if ".test" not in n)
    if isinstance(names, str) and names.lower() == "all_test":
        return sorted(n for n in NEUROFINDER_NAMES if ".test" in n)
    if isinstance(names, str):
        return names.split(",")
    return list(names)


def _download_and_unzip(name: str, ddir: str) -> None:
    """Idempotent fetch of one dataset archive into ``ddir/name``."""
    logger = logging.getLogger(funcname())
    unzip_path = os.path.join(ddir, name)
    if os.path.exists(unzip_path):
        logger.info("%s already downloaded.", name)
        return
    import requests

    url = NAME_TO_URL[name]
    zip_path = unzip_path + ".zip"
    logger.info("Downloading %s.", url)
    # Streamed to disk: the archives are several GB.
    with requests.get(url, timeout=600, stream=True) as resp:
        resp.raise_for_status()
        with open(zip_path, "wb") as fp:
            for block in resp.iter_content(chunk_size=1 << 22):
                fp.write(block)
    logger.info("Unzipping %s.", zip_path)
    # Extract into a temporary directory and rename it into place: an
    # interrupted extraction must not pass for a finished one.
    tmp_dir = unzip_path + ".extract_tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    with zipfile.ZipFile(zip_path, "r") as z:
        z.extractall(tmp_dir)
    extracted = os.path.join(tmp_dir, name)
    if not os.path.isdir(extracted):  # archive without the top-level dir
        extracted = tmp_dir
        tmp_dir = None
    os.replace(extracted, unzip_path)
    if tmp_dir is not None and os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.remove(zip_path)


def ingest_tiff_dataset(ds_dir: str, ds_path: str, name: str,
                        chunk: int = 64, device="cuda") -> str:
    """TIFF tree (``images/*.tiff``, ``regions/regions.json`` unless a test
    set) -> contract HDF5 at ``ds_path``, written to a temporary file and
    renamed into place. The summaries fold on ``device``."""
    import h5py

    from deepcalcium_torch.data._ingest import read_tiff, write_series

    if torch.device(device).type == "cuda":
        require_cuda()
    logger = logging.getLogger(funcname())
    s_paths = sorted(glob(os.path.join(ds_dir, "images", "*.tiff"))) or \
        sorted(glob(os.path.join(ds_dir, "images", "*.tif")))
    if not s_paths:
        raise FileNotFoundError(f"no TIFF frames under {ds_dir}/images")
    i_shape = read_tiff(s_paths[0]).shape

    tmp_path = ds_path + ".tmp"
    with h5py.File(tmp_path, "w") as dsf:
        dsf.attrs["name"] = name
        write_series(dsf, s_paths, i_shape, chunk, device=device)

        regions_path = os.path.join(ds_dir, "regions", "regions.json")
        if os.path.exists(regions_path):
            with open(regions_path) as fp:
                regions = json.load(fp)
            m_raw = dsf.create_dataset(
                "masks/raw", (len(regions),) + i_shape, dtype="int8")
            m_max = np.zeros(i_shape, np.int8)
            for idx, r in enumerate(regions):
                msk = np.zeros(i_shape, np.int8)
                coords = np.asarray(r["coordinates"], np.int64)
                msk[coords[:, 0], coords[:, 1]] = 1
                m_raw[idx] = msk
                np.maximum(m_max, msk, out=m_max)
            dsf.create_dataset("masks/max", data=m_max, dtype="int8")

    os.replace(tmp_path, ds_path)
    logger.info("Populated %s (%d frames).", ds_path, len(s_paths))
    return ds_path


def nf_load_hdf5(names, datasets_dir_override=None, device="cuda"):
    """Download and ingest Neurofinder datasets; returns their HDF5 paths.
    Idempotent at both steps."""
    logger = logging.getLogger(funcname())
    ddir = datasets_dir_override or os.path.join(datasets_dir(), "neurons_nf")
    os.makedirs(ddir, exist_ok=True)

    paths = []
    for name in _resolve_names(names):
        _download_and_unzip(name, ddir)
        ds_path = os.path.join(ddir, name, "dataset.hdf5")
        if not os.path.exists(ds_path):
            logger.info("Populating %s.", ds_path)
            ingest_tiff_dataset(os.path.join(ddir, name), ds_path, name,
                                device=device)
        paths.append(ds_path)
    return paths


def nf_submit(Mp, names, json_path) -> None:
    """Write a Neurofinder challenge submission JSON: one entry a dataset
    (the ``neurofinder.`` prefix dropped), one region a connected component
    of its mask, or a single placeholder region at (0, 0) for an empty
    mask. Coordinates are ``np.where``'s (row, col) pairs, the layout of
    the reference's submissions."""
    logger = logging.getLogger(funcname())
    submission = []
    for mp, name in zip(Mp, names):
        if name.startswith("neurofinder."):
            name = ".".join(name.split(".")[1:])
        # One walk over each region's bounding box, in label order and
        # row-major within it: the JAX package's np.where per label gives
        # the same pairs in the same order at the cost of a whole-image
        # pass per region.
        regions = [{"coordinates": r.tolist()} for r in mask_to_regions(mp)]
        submission.append({"dataset": name,
                           "regions": regions or [{"coordinates": [[0, 0]]}]})

    with open(json_path, "w") as fp:
        json.dump(submission, fp)
    logger.info("Saved submission to %s.", json_path)
