"""The port's flax-free checkpoint reader against the JAX package's
``load_checkpoint``: the same arrays, bit for bit."""

import os

import jax
import numpy as np
import pytest
import torch

from deepcalcium_tpu.models import unet1d, unet2d
from deepcalcium_tpu.train import checkpoints as jck
from deepcalcium_torch.train import checkpoints as tck

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def _assert_same_tree(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_tree(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,net", [("unet2d_tiny.ckpt", unet2d),
                                      ("unet1d_tiny.ckpt", unet1d)])
def test_reader_matches_jax_on_golden_checkpoints(name, net):
    path = os.path.join(GOLD, name)
    p0, s0 = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), nfb=4))
    jp, js, _, jmeta = jck.load_checkpoint(path, p0, s0)
    tp, ts, tmeta = tck.load_checkpoint(path)
    _assert_same_tree(tp, jax.tree.map(np.asarray, jp))
    _assert_same_tree(ts, jax.tree.map(np.asarray, js))
    assert tmeta == jmeta


def test_tiny_params_npz_equals_checkpoint():
    p, s, _ = tck.load_checkpoint(os.path.join(GOLD, "unet2d_tiny.ckpt"))
    np_p, np_s = tck.load_npz_params(os.path.join(GOLD,
                                                  "unet2d_tiny_params.npz"))
    _assert_same_tree(np_p, p)
    _assert_same_tree(np_s, s)


def test_reader_round_trip_with_meta_and_chunked_leaves(tmp_path, monkeypatch):
    """Meta scalars and leaves that flax splits into chunks read back."""
    from flax import serialization

    rng = np.random.default_rng(0)
    params = {"a_conv": {"kernel": rng.standard_normal((3, 3, 2, 5)).astype(
        np.float32), "bias": np.arange(5, dtype=np.float32)}}
    state = {"a_bn": {"mean": rng.standard_normal(5).astype(np.float32)}}
    meta = {"epoch": 3, "lr": 2e-3, "name": "x", "best": np.float32(0.5)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    path = jck.save_checkpoint(str(tmp_path / "c.ckpt"), params, state,
                               meta=meta)
    tp, ts, tmeta = tck.load_checkpoint(path)
    _assert_same_tree(tp, params)
    _assert_same_tree(ts, state)
    assert tmeta["epoch"] == 3 and tmeta["name"] == "x"
    assert tmeta["lr"] == 2e-3 and tmeta["best"] == np.float32(0.5)


def test_latest_checkpoint(tmp_path):
    assert tck.latest_checkpoint(str(tmp_path / "missing")) is None
    assert tck.latest_checkpoint(str(tmp_path)) is None
    for i, name in enumerate(("a.ckpt", "b.ckpt", "c.txt")):
        (tmp_path / name).write_bytes(b"")
        os.utime(tmp_path / name, (1000 + i, 1000 + i))
    assert tck.latest_checkpoint(str(tmp_path)) == str(tmp_path / "b.ckpt")
    assert (tck.latest_checkpoint(str(tmp_path))
            == jck.latest_checkpoint(str(tmp_path)))
