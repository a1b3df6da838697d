"""The port's UNet2DS (blocks, forward, folds, weight bridge) against the JAX
package's ``unet2d`` on the same weights and inputs, on the CPU.

Tolerances: float32 forwards at rtol=1e-4, atol=1e-6 (the golden test's,
``tests/test_golden.py``), which allows for sums over channels taken in
another order; the fold at atol=1e-6 (it rescales weights, which rounds);
bf16 at atol=2e-2 (bf16 keeps 8 bits of mantissa, and the two frameworks'
convs round their partial sums at other places).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcalcium_tpu.models import blocks as jblocks
from deepcalcium_tpu.models import unet2d as junet
from deepcalcium_tpu.models.unet2d_fast import apply_fast_w
from deepcalcium_torch.models import blocks as tblocks
from deepcalcium_torch.models import unet2d as tunet
from deepcalcium_torch.train.checkpoints import load_checkpoint

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
HIGHEST = jax.lax.Precision.HIGHEST


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _random_net(seed, nfb=4, up_mode="transpose"):
    """Params in the JAX layout, with every BN and bias made non-trivial.
    Drawn by the port (no JAX compile) and by numpy; both packages then run
    the same arrays."""
    params, state = tunet.to_jax_params(tunet.UNet2DS(
        nfb, up_mode, generator=torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    for name in params:
        if name.endswith("_bn"):
            c = params[name]["gamma"].shape
            params[name] = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                            "beta": rng.normal(0, 0.2, c).astype(np.float32)}
            state[name] = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
                           "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        else:
            params[name]["bias"] = rng.normal(
                0, 0.1, params[name]["bias"].shape).astype(np.float32)
    return params, state


@pytest.fixture
def rng():
    return np.random.default_rng(865)


@pytest.mark.parametrize("k", [3, 1])
def test_conv2d_block(rng, k):
    x = rng.standard_normal((2, 12, 16, 5)).astype(np.float32)
    p = {"kernel": rng.standard_normal((k, k, 5, 7)).astype(np.float32),
         "bias": rng.standard_normal(7).astype(np.float32)}
    ref = np.asarray(jblocks.conv2d(x, p, precision=HIGHEST))
    out = tblocks.conv2d(_nchw(x), torch.from_numpy(p["kernel"]).permute(3, 2, 0, 1),
                         torch.from_numpy(p["bias"]))
    np.testing.assert_allclose(_nhwc(out), ref, rtol=1e-4, atol=1e-5)


def test_tconv2x2_block(rng):
    x = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    p = {"kernel": rng.standard_normal((2, 2, 3, 8)).astype(np.float32),
         "bias": rng.standard_normal(3).astype(np.float32)}
    ref = np.asarray(jblocks.tconv2x2(x, p, precision=HIGHEST))
    out = tblocks.tconv2x2(_nchw(x), torch.from_numpy(p["kernel"]).permute(3, 2, 0, 1),
                           torch.from_numpy(p["bias"]))
    np.testing.assert_allclose(_nhwc(out), ref, rtol=1e-4, atol=1e-5)


def test_maxpool2_block(rng):
    x = rng.standard_normal((2, 8, 10, 3)).astype(np.float32)
    ref = np.asarray(jblocks.maxpool2(x))
    np.testing.assert_array_equal(_nhwc(tblocks.maxpool2(_nchw(x))), ref)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_batch_norm_block(rng, dtype):
    x = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    p = {"gamma": rng.uniform(0.5, 1.5, 5).astype(np.float32),
         "beta": rng.normal(0, 0.3, 5).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.3, 5).astype(np.float32),
         "var": rng.uniform(0.5, 2, 5).astype(np.float32)}
    jx = x if dtype is None else jnp.asarray(x, jnp.bfloat16)
    ref, _ = jblocks.batch_norm(jx, p, s, train=False, momentum=0.99)
    tx = _nchw(x) if dtype is None else _nchw(x).to(torch.bfloat16)
    out = tblocks.batch_norm(tx, *(torch.from_numpy(v) for v in
                                   (p["gamma"], p["beta"], s["mean"], s["var"])))
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_nhwc(out.float()), np.asarray(ref, np.float32),
                               rtol=1e-6 if dtype is None else 1e-2,
                               atol=1e-6 if dtype is None else 1e-2)


@pytest.mark.parametrize("up_mode", ["transpose", "upsampling"])
def test_forward_matches_jax(rng, up_mode):
    params, state = _random_net(1, up_mode=up_mode)
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    ref, _ = junet.apply(params, state, x, precision=HIGHEST, up_mode=up_mode)
    model = tunet.from_jax_params(params, state).eval()
    assert model.up_mode == up_mode and model.nfb == 4
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-6)


def test_golden_through_msgpack_reader():
    data = np.load(os.path.join(GOLD, "golden_io.npz"))
    params, state, _ = load_checkpoint(os.path.join(GOLD, "unet2d_tiny.ckpt"))
    model = tunet.from_jax_params(params, state).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(data["x2"])).numpy()
    np.testing.assert_allclose(out, data["y2"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("up_mode", ["transpose", "upsampling"])
def test_fold_matches_unfolded(rng, up_mode):
    params, state = _random_net(2, up_mode=up_mode)
    model = tunet.from_jax_params(params, state).eval()
    folded = model.fold()
    assert folded.folded and not model.folded
    assert not any(n.endswith("_bn") for n, _ in folded.named_children())
    x = torch.from_numpy(rng.standard_normal((2, 32, 32)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(folded(x).numpy(), model(x).numpy(),
                                   rtol=0, atol=1e-6)


def test_fold_matches_jax_fast_path(rng):
    """``fast="auto"`` in the port (folds only) against the JAX package's
    ``apply_fast_w`` (folds plus TPU lane packing) at float32."""
    params, state = _random_net(3)
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    ref, _ = apply_fast_w(params, state, x, compute_dtype=jnp.float32)
    folded = tunet.from_jax_params(params, state).eval().fold()
    with torch.no_grad():
        out = folded(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("up_mode", ["transpose", "upsampling"])
def test_weight_bridge_round_trip_exact(up_mode):
    params, state = _random_net(4, up_mode=up_mode)
    back_p, back_s = tunet.to_jax_params(tunet.from_jax_params(params, state))
    for tree, back in ((params, back_p), (state, back_s)):
        assert tree.keys() == back.keys()
        for name in tree:
            for leaf in tree[name]:
                np.testing.assert_array_equal(back[name][leaf], tree[name][leaf])
    with pytest.raises(ValueError, match="folded"):
        tunet.to_jax_params(tunet.from_jax_params(params, state).fold())


def test_bf16_forward_matches_jax_bf16(rng):
    params, state = _random_net(5)
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    ref, _ = junet.apply(params, state, x, compute_dtype=jnp.bfloat16)
    model = tunet.from_jax_params(params, state, torch.bfloat16).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-2)


@pytest.mark.parametrize("up_mode", ["transpose", "upsampling"])
def test_layer_order_params_and_flops_match_jax(up_mode):
    assert tunet.layer_order(8, up_mode) == junet.layer_order(8, up_mode)
    assert tunet.LAYER_ORDER == junet.LAYER_ORDER
    model = tunet.UNet2DS(nfb=8, up_mode=up_mode)
    jparams, _ = jax.eval_shape(
        lambda: junet.init(jax.random.PRNGKey(0), nfb=8, up_mode=up_mode))
    assert (sum(p.numel() for p in model.parameters())
            == junet.param_count(jparams))
    for hw in [(32, 32), (512, 512), (64, 48)]:
        assert (tunet.forward_flops(*hw, nfb=8, up_mode=up_mode)
                == junet.forward_flops(*hw, nfb=8, up_mode=up_mode))


def test_he_normal_init_is_seeded_and_truncated():
    a = tunet.UNet2DS(nfb=8, generator=torch.Generator().manual_seed(7))
    b = tunet.UNet2DS(nfb=8, generator=torch.Generator().manual_seed(7))
    c = tunet.UNet2DS(nfb=8, generator=torch.Generator().manual_seed(8))
    for name in ("enc1a_conv", "up2_tconv", "dec0a_conv"):
        assert torch.equal(getattr(a, name).weight, getattr(b, name).weight)
        assert not torch.equal(getattr(a, name).weight, getattr(c, name).weight)
    w = a.dec2a_conv.weight  # fan-in of the concatenation: 3 * 3 * 64
    sigma = (2.0 / (9 * 64)) ** 0.5
    assert w.abs().max() <= 2 * sigma + 1e-7
    # A +-2 sigma truncated normal has std 0.88 sigma (no correction).
    assert abs(w.std().item() / sigma - 0.88) < 0.03
    t = a.up1_tconv.weight  # Keras fan quirk: fan_in = 4 * cout
    assert t.abs().max() <= 2 * (2.0 / (4 * 16)) ** 0.5 + 1e-7
    assert torch.equal(a.enc0a_bn.running_var, torch.ones(8))
