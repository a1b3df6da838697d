"""Checkpoints without flax: the msgpack layout of
``deepcalcium_tpu.train.checkpoints``, written and read with plain
``msgpack``.

A checkpoint is one msgpack map ``{"params", "state", "opt_state", "meta"}``
whose array leaves are msgpack extension type 1: the payload is itself a
msgpack triple ``(shape, dtype_name, buffer)`` of a C-ordered array (type 3
for a numpy scalar). Arrays larger than flax's chunk size are stored as
``{"__msgpack_chunked_array__", "shape", "chunks"}`` maps. ``opt_state`` is
optax's state dict of ``inject_hyperparams(adam)`` (see
``trainer.optax_state``). The writer emits the bytes flax's ``to_bytes``
emits for the same trees, with the keys of ``params``, ``state`` and
``opt_state`` sorted at every level as the JAX package's ``jax.tree.map``
leaves them, so one file serves both packages.
"""

import os
import tempfile

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "read_checkpoint",
           "load_npz_params", "latest_checkpoint"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2**30  # bytes; flax.serialization.MAX_CHUNK_SIZE


def _ndarray_bytes(a: np.ndarray) -> bytes:
    import msgpack

    return msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    import msgpack

    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    raise TypeError(f"cannot serialize {type(x).__name__} into a checkpoint")


def _chunk(a: np.ndarray):
    """flax's chunked form of an array above ``MAX_CHUNK_SIZE`` bytes."""
    if a.nbytes <= MAX_CHUNK_SIZE:
        return a
    n = max(1, MAX_CHUNK_SIZE // a.dtype.itemsize)
    flat = a.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(a.shape)},
            "chunks": {str(i): flat[j:j + n]
                       for i, j in enumerate(range(0, flat.size, n))}}


def _host_tree(tree):
    """Sorted-key dicts with every leaf a host ndarray (tensors copied off
    their device), as ``_to_host`` leaves a tree in the JAX package."""
    if isinstance(tree, dict):
        return {str(k): _host_tree(tree[k]) for k in sorted(tree, key=str)}
    if hasattr(tree, "detach"):
        tree = tree.detach().cpu().numpy()
    return _chunk(np.asarray(tree))


def _meta_tree(tree):
    if isinstance(tree, dict):
        return {str(k): _meta_tree(v) for k, v in tree.items()}
    return _chunk(tree) if isinstance(tree, np.ndarray) else tree


def save_checkpoint(path: str, params, state, opt_state=None,
                    meta: dict | None = None) -> str:
    """Atomically write a training snapshot to ``path`` (tmp + rename).

    ``params`` and ``state`` are trees in the JAX package's layout (see
    ``models.unet2d.to_jax_params``), ``opt_state`` optax's state dict or
    None; leaves may be numpy arrays or tensors on any device."""
    import msgpack

    payload = {"params": _host_tree(params), "state": _host_tree(state),
               "opt_state": _host_tree(opt_state) if opt_state is not None else {},
               "meta": _meta_tree(meta or {})}
    blob = msgpack.packb(payload, default=_ext_pack, strict_types=True)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fp:
            fp.write(blob)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


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


def read_checkpoint(path: str) -> dict:
    """Read a checkpoint written by either package.

    # Returns
        ``{"params", "state", "opt_state", "meta"}``: nested dicts of numpy
        arrays keyed as in ``deepcalcium_tpu.models.unet2d.LAYER_ORDER``
        (params, state), optax's state dict (``{}`` when the file has none)
        and the free-form ``meta`` dict.
    """
    import msgpack

    with open(path, "rb") as fp:
        raw = msgpack.unpackb(fp.read(), ext_hook=_ext_hook, raw=False)
    raw = _unchunk(raw)
    return {"params": raw["params"], "state": raw["state"],
            "opt_state": raw.get("opt_state") or {},
            "meta": raw.get("meta", {})}


def load_checkpoint(path: str):
    """(params, state, meta) of a checkpoint (see :func:`read_checkpoint`)."""
    raw = read_checkpoint(path)
    return raw["params"], raw["state"], raw["meta"]


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
