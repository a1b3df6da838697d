"""The port's flax-free checkpoint reader and writer against the JAX
package's: the same arrays bit for bit, the same file bytes, and optimizer
state that resumes in either package."""

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


def _opt_tree(weight_decay, params, steps=2):
    """An optax state after ``steps`` updates, and its state dict."""
    from flax import serialization

    from deepcalcium_tpu.train import trainer as jtrainer

    opt = jtrainer.make_optimizer(2e-3, weight_decay=weight_decay)
    state = opt.init(params)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        _, state = opt.update(g, state, params)
    return opt, state, serialization.to_state_dict(
        jax.tree.map(np.asarray, state))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
def test_writer_bytes_equal_flax(tmp_path, monkeypatch, weight_decay):
    """The port's writer emits the bytes the JAX package's flax writer
    emits for the same params, state, optax state and meta, chunked leaves
    included."""
    from flax import serialization

    from deepcalcium_torch.models.unet2d import UNet2DS, to_jax_params

    params, state = to_jax_params(UNet2DS(nfb=2))
    _, opt_state, opt_dict = _opt_tree(weight_decay, params)
    meta = {"epoch": 3, "loss": 0.25, "name": "x", "best": np.float32(0.5),
            "hist": np.arange(40, dtype=np.float32)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tck, "MAX_CHUNK_SIZE", 64)
    jpath = jck.save_checkpoint(str(tmp_path / "j.ckpt"), params, state,
                                opt_state, meta=meta)
    tpath = tck.save_checkpoint(str(tmp_path / "t.ckpt"), params,
                                {k: {n: torch.from_numpy(v) for n, v in d.items()}
                                 for k, d in state.items()}, opt_dict, meta=meta)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
def test_port_optimizer_state_resumes_in_jax_and_back(tmp_path, weight_decay):
    """A port-written file with the port's Adam state loads through the JAX
    package's ``load_checkpoint(path, params, state, optimizer.init(params))``
    and steps there; a JAX-written one restores the port's Adam moments,
    step count and learning rate."""
    from deepcalcium_tpu.train import trainer as jtrainer
    from deepcalcium_torch.models.unet2d import (UNet2DS, jax_tree,
                                                 to_jax_params)
    from deepcalcium_torch.train import trainer as ttrainer

    model = UNet2DS(nfb=2, generator=torch.Generator().manual_seed(2))
    opt = ttrainer.make_optimizer(model, 2e-3, weight_decay=weight_decay)
    for _ in range(2):
        model(torch.randn(2, 16, 16), train=True,
              generator=torch.Generator().manual_seed(0)).mean().backward()
        opt.step()
    ttrainer.set_lr(opt, 5e-4)
    params, state = to_jax_params(model)
    path = tck.save_checkpoint(str(tmp_path / "p.ckpt"), params, state,
                               ttrainer.optax_state(model, opt), {"epoch": 1})
    jopt = jtrainer.make_optimizer(2e-3, weight_decay=weight_decay)
    jp, js, jo, _ = jck.load_checkpoint(path, params, state, jopt.init(params))
    assert int(jo.count) == 2 and jtrainer.current_lr(jo) == np.float32(5e-4)
    _assert_same_tree(jax.tree.map(np.asarray, jo.inner_state[0].mu),
                      jax_tree(model, {n: opt.state[p]["exp_avg"]
                                       for n, p in model.named_parameters()}))
    grads = jax.tree.map(np.ones_like, jp)
    jax.block_until_ready(jopt.update(grads, jo, jp))

    _, jo2, jdict = _opt_tree(weight_decay, params, steps=3)
    jpath = jck.save_checkpoint(str(tmp_path / "j.ckpt"), params, state, jo2)
    fresh = UNet2DS(nfb=2)
    fopt = ttrainer.make_optimizer(fresh, 2e-3, weight_decay=weight_decay)
    ttrainer.load_optax_state_(fresh, fopt, tck.read_checkpoint(jpath)["opt_state"])
    back = ttrainer.optax_state(fresh, fopt)
    assert int(back["count"]) == 3
    assert ttrainer.current_lr(fopt) == float(np.float32(2e-3))
    for key in ("mu", "nu"):
        _assert_same_tree(back["inner_state"]["0"][key],
                          jdict["inner_state"]["0"][key])
    with pytest.raises(ValueError, match="weight decay"):
        ttrainer.load_optax_state_(
            fresh, ttrainer.make_optimizer(fresh, 2e-3,
                                           0.0 if weight_decay else 0.1), jdict)
