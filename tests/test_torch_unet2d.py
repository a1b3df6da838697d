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


# --- init_scheme ------------------------------------------------------------

def _param_hash(model):
    import hashlib

    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


# sha256 over (name, float32 bytes) of every parameter of
# UNet2DS(nfb=4, generator=manual_seed(3)), taken before ``init_scheme``
# existed: the default must draw the same bits from the same generator.
DEFAULT_INIT_HASHES = {
    "transpose":
        "518650d32b98f52c0fb77c732380bd8191c7187c06da9bd98a59beeffad6731f",
    "upsampling":
        "8e3747fe0f4f1ff972001497bc333b777dc27c8ec773f9f8096a0e813f4b063f",
}


@pytest.mark.parametrize("up_mode", ["transpose", "upsampling"])
def test_default_init_draws_the_same_bits_as_before(up_mode):
    for kw in ({}, {"init_scheme": "he_normal"}):
        model = tunet.UNet2DS(nfb=4, up_mode=up_mode,
                              generator=torch.Generator().manual_seed(3), **kw)
        assert _param_hash(model) == DEFAULT_INIT_HASHES[up_mode]
        assert model.init_scheme == "he_normal"


def _scheme_scale(scheme, fan_in, fan_out):
    """(bound on |w|, expected std) of a scheme. A +-2 sigma truncated
    normal has std 0.8796 sigma (no correction); a uniform draw in
    [-lim, lim] has std lim / sqrt(3)."""
    fan = fan_in if scheme.startswith("he") else fan_in + fan_out
    if scheme.endswith("normal"):
        sigma = (2.0 / fan) ** 0.5
        return 2 * sigma, 0.8796 * sigma
    lim = (6.0 / fan) ** 0.5
    return lim, lim / 3 ** 0.5


@pytest.mark.parametrize("scheme", tblocks.INIT_SCHEMES)
def test_kernel_init_bound_and_std(scheme):
    """The bound holds exactly (plus float32 rounding of the scale); the std
    of 262,144 draws lies within 3% of the scheme's."""
    fan_in, fan_out = 9 * 64, 9 * 32
    w = tblocks.kernel_init_(torch.empty(512, 512), fan_in, fan_out, scheme,
                             torch.Generator().manual_seed(11))
    bound, std = _scheme_scale(scheme, fan_in, fan_out)
    assert w.abs().max().item() <= bound * (1 + 1e-6)
    assert w.abs().max().item() > 0.98 * bound
    assert abs(w.std().item() / std - 1) < 0.03
    assert abs(w.mean().item()) < 0.01 * std * 3


@pytest.mark.parametrize("scheme", tblocks.INIT_SCHEMES)
def test_init_scheme_fans_match_jax(scheme):
    """The conv and transpose-conv fans are the JAX package's: a uniform
    draw's limit and a normal draw's std agree with ``blocks.init_conv`` /
    ``init_tconv`` draws of the same shapes (the two PRNGs differ, so the
    statistics are compared: max-abs within 1% and std within 3% on
    kernels of 36,864 and 32,768 weights), and with the formula exactly in
    the bound."""
    g = torch.Generator().manual_seed(5)
    key = jax.random.PRNGKey(5)
    cin, cout = 64, 64
    conv = tblocks.Conv2d(cin, cout, 3, g, scheme).weight.detach()
    jconv = np.asarray(jblocks.init_conv(key, (3, 3), cin, cout, scheme)["kernel"])
    assert tuple(conv.shape) == (cout, cin, 3, 3) and jconv.shape == (3, 3, cin, cout)
    # Unequal channels, so that swapped transpose-conv fans would show.
    tcin, tcout = 256, 32
    tconv = tblocks.ConvTranspose2x2(tcin, tcout, g, scheme).weight.detach()
    jtconv = np.asarray(jblocks.init_tconv(key, tcin, tcout, scheme)["kernel"])
    assert tuple(tconv.shape) == (tcin, tcout, 2, 2) and jtconv.shape == (2, 2, tcout, tcin)
    for w, jw, fans in ((conv, jconv, (9 * cin, 9 * cout)),
                        (tconv, jtconv, (4 * tcout, 4 * tcin))):
        bound, std = _scheme_scale(scheme, *fans)
        assert w.abs().max().item() <= bound * (1 + 1e-6)
        assert np.abs(jw).max() <= bound * (1 + 1e-6)
        assert abs(w.abs().max().item() / np.abs(jw).max() - 1) < 0.01
        assert abs(w.std().item() / jw.std() - 1) < 0.03
        assert abs(w.std().item() / std - 1) < 0.03


@pytest.mark.parametrize("scheme", tblocks.INIT_SCHEMES)
def test_unet2ds_passes_init_scheme_to_every_kernel(scheme):
    """Every conv, the head and the transpose convs, as ``unet2d.init``
    does; biases stay zero and the BNs at gamma 1, beta 0."""
    nfb = 8
    model = tunet.UNet2DS(nfb=nfb, init_scheme=scheme,
                          generator=torch.Generator().manual_seed(2))
    jparams, _ = junet.init(jax.random.PRNGKey(2), nfb=nfb, init_scheme=scheme)
    for name, kind, cout in tunet.layer_order(nfb):
        layer = getattr(model, name)
        if kind == "bn":
            assert torch.equal(layer.weight, torch.ones(cout))
            continue
        assert torch.equal(layer.bias, torch.zeros(cout))
        w = layer.weight.detach()
        if kind == "tconv":
            fans = (4 * w.shape[1], 4 * w.shape[0])
        else:
            k = w.shape[-1]
            fans = (k * k * w.shape[1], k * k * w.shape[0])
        bound, std = _scheme_scale(scheme, *fans)
        assert w.abs().max().item() <= bound * (1 + 1e-6), name
        jw = np.asarray(jparams[name]["kernel"])
        assert np.abs(jw).max() <= bound * (1 + 1e-6), name
        if w.numel() >= 4096:
            assert abs(w.std().item() / std - 1) < 0.05, name
            assert abs(jw.std() / std - 1) < 0.05, name
    if scheme != "he_normal":
        default = tunet.UNet2DS(nfb=nfb, generator=torch.Generator().manual_seed(2))
        assert not torch.equal(default.head_conv.weight, model.head_conv.weight)


def test_unknown_init_scheme_raises_the_jax_message():
    with pytest.raises(ValueError) as jexc:
        jblocks.kernel_init(jax.random.PRNGKey(0), (3, 3, 1, 4), 9, 36, "lecun")
    with pytest.raises(ValueError) as texc:
        tblocks.kernel_init_(torch.empty(4, 1, 3, 3), 9, 36, "lecun",
                             torch.Generator().manual_seed(0))
    assert str(texc.value) == str(jexc.value) == "unknown init scheme: 'lecun'"
    with pytest.raises(ValueError, match="unknown init scheme"):
        tunet.UNet2DS(nfb=4, init_scheme="lecun")


# --- capture ----------------------------------------------------------------

CAPTURE_KEYS = ["enc0a", "enc0b", "enc1a", "enc1b", "enc2a", "enc2b", "enc3a",
                "enc3b", "mida", "midb", "dec3a", "dec3b", "dec2a", "dec2b",
                "dec1a", "dec1b", "dec0a", "dec0b"]


@pytest.mark.parametrize("up_mode", ["transpose", "upsampling"])
def test_capture_matches_jax(rng, up_mode):
    """The 18 keys in the order the JAX ``apply`` fills them; each
    activation within atol 1e-5 (rtol 1e-4) of the JAX one in float32 after
    NHWC -> NCHW; the probabilities bitwise those without ``capture``."""
    params, state = _random_net(6, up_mode=up_mode)
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    jacts: dict = {}
    ref, _ = junet.apply(params, state, x, precision=HIGHEST, up_mode=up_mode,
                         capture=jacts)
    model = tunet.from_jax_params(params, state).eval()
    acts: dict = {}
    with torch.no_grad():
        out = model(torch.from_numpy(x), capture=acts)
        plain = model(torch.from_numpy(x))
    assert list(acts) == list(jacts) == CAPTURE_KEYS
    assert torch.equal(out, plain)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)
    for name in CAPTURE_KEYS:
        a, ja = acts[name], np.asarray(jacts[name])
        assert a.dim() == 4 and a.dtype == torch.float32
        assert tuple(a.shape) == (ja.shape[0], ja.shape[3], ja.shape[1], ja.shape[2])
        assert (a >= 0).all()  # post-ReLU
        np.testing.assert_allclose(_nhwc(a), ja, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert acts["mida"].shape == (2, 64, 2, 2)
    assert acts["dec0b"].shape == (2, 4, 32, 32)


def test_capture_in_training_and_bf16(rng):
    """``capture`` changes no bit of the training forward either, nor the
    running statistics; under a compute dtype the tensors are in it."""
    params, state = _random_net(7)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32)).astype(np.float32))
    outs, stats = [], []
    for capture in (None, {}):
        model = tunet.from_jax_params(params, state, drp=0.0)
        outs.append(model(x, train=True, capture=capture))
        stats.append(model.enc1a_bn.running_mean.clone())
        if capture is not None:
            assert list(capture) == CAPTURE_KEYS
            outs[-1].sum().backward()  # the captured tensors are the graph's
            assert capture["dec0b"].requires_grad
    assert torch.equal(outs[0], outs[1]) and torch.equal(stats[0], stats[1])
    acts: dict = {}
    with torch.no_grad():
        tunet.from_jax_params(params, state, torch.bfloat16).eval()(x, capture=acts)
    assert all(a.dtype == torch.bfloat16 for a in acts.values())


def test_capture_on_a_folded_net(rng):
    """A folded net captures too: the fold is exact, so its blocks hold the
    unfolded net's activations up to float rounding (atol 1e-5), and its
    output is bitwise its own without ``capture``."""
    params, state = _random_net(8)
    model = tunet.from_jax_params(params, state).eval()
    folded = model.fold()
    x = torch.from_numpy(rng.standard_normal((1, 32, 32)).astype(np.float32))
    acts, facts = {}, {}
    with torch.no_grad():
        model(x, capture=acts)
        out = folded(x, capture=facts)
        assert torch.equal(out, folded(x))
    assert list(facts) == CAPTURE_KEYS
    for name in CAPTURE_KEYS:
        np.testing.assert_allclose(facts[name].numpy(), acts[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
