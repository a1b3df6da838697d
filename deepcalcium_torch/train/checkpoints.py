"""Checkpoint reading without flax: the msgpack layout of
``deepcalcium_tpu.train.checkpoints`` parsed with plain ``msgpack``.

A checkpoint is one msgpack map ``{"params", "state", "opt_state", "meta"}``
whose array leaves are msgpack extension type 1: the payload is itself a
msgpack triple ``(shape, dtype_name, buffer)`` of a C-ordered array. Arrays
larger than flax's chunk size are stored as ``{"__msgpack_chunked_array__",
"shape", "chunks"}`` maps and are joined back here. One file serves both
packages.
"""

import os

import numpy as np

__all__ = ["load_checkpoint", "load_npz_params", "latest_checkpoint"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        raise ValueError("bfloat16 checkpoint leaves are not supported: "
                         "numpy has no bfloat16 dtype")
    # Copy: np.frombuffer over the msgpack bytes is read-only.
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()


def _ext_hook(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack extension type {code}")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        chunks = tree["chunks"]
        parts = [chunks[str(i)] for i in range(len(chunks))]
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        return np.concatenate(parts).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_checkpoint(path: str):
    """Read a checkpoint written by either package.

    # Returns
        (params, state, meta): nested dicts of numpy arrays keyed as in
        ``deepcalcium_tpu.models.unet2d.LAYER_ORDER`` (params, state) and the
        checkpoint's free-form ``meta`` dict.
    """
    import msgpack

    with open(path, "rb") as fp:
        raw = msgpack.unpackb(fp.read(), ext_hook=_ext_hook, raw=False)
    raw = _unchunk(raw)
    return raw["params"], raw["state"], raw.get("meta", {})


def load_npz_params(path: str):
    """(params, state) from an ``.npz`` whose keys are
    ``params/<layer>/<leaf>`` and ``state/<layer>/<leaf>``: the same weights
    as a checkpoint, readable with numpy alone."""
    out = {"params": {}, "state": {}}
    with np.load(path) as data:
        for key in data.files:
            tree, layer, leaf = key.split("/")
            out[tree].setdefault(layer, {})[leaf] = data[key]
    return out["params"], out["state"]


def latest_checkpoint(cpdir: str, prefix: str = "") -> str | None:
    """Newest ``*.ckpt`` in ``cpdir`` by mtime, as the JAX package picks it."""
    if not os.path.isdir(cpdir):
        return None
    cands = [os.path.join(cpdir, f) for f in os.listdir(cpdir)
             if f.startswith(prefix) and f.endswith(".ckpt")]
    return max(cands, key=os.path.getmtime) if cands else None
