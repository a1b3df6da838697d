"""The port's UNet1D and its 1-D blocks against the JAX package, on the
same numpy-seeded inputs, on the CPU: the 1-D conv, train-mode BN on NCW,
the window-2 pool and the margin head with their tie routing, the forward at
even and odd margin windows, the golden ``y1``, params and FLOPs, the train
forward with its gradients (dropout through injected masks), Adam steps,
and checkpoints with Adam's state read across both packages.

It also holds the frozen golden ``tests/golden/unet1d_tiny_train_step.npz``,
which ``chip_smoke.py`` checks on the card: the JAX package regenerates it
here and must still agree with it, and the port on the CPU must match it.
Write it anew (only on purpose) with::

    PYTHONPATH=. python tests/test_torch_unet1d.py --write-golden

Adam steps are compared at eps 1e-4, for the reason
``tests/test_torch_train.py`` gives: at eps 1e-8 the conv biases that feed
a BN, whose gradient is zero up to rounding, move by up to lr in a
direction set by that rounding.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcalcium_tpu.models import blocks as jblocks
from deepcalcium_tpu.models import unet1d as junet
from deepcalcium_tpu.models.unet_1d_segmentation import maxpool_labels
from deepcalcium_tpu.ops import losses as jlosses
from deepcalcium_tpu.train import checkpoints as jck
from deepcalcium_tpu.train import trainer as jtrainer
from deepcalcium_torch.models import blocks as tblocks
from deepcalcium_torch.models import unet1d as tunet
from deepcalcium_torch.ops import losses as tlosses
from deepcalcium_torch.train import checkpoints as tck
from deepcalcium_torch.train import trainer as ttrainer

# The card's tolerances for the golden and its tied inputs, shared so both
# hold the same ones.
from chip_smoke import assert_matches_golden, tied_1d_input

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_STEP = os.path.join(GOLD, "unet1d_tiny_train_step.npz")
HIGHEST = jax.lax.Precision.HIGHEST
LR = 2e-3
ADAM_EPS = 1e-4  # see the module docstring
STEPS = 3
MARGIN = 4
# The 1-D golden's probabilities stay at least this far from 0.5, so its
# rounded metrics are compared exactly (``assert_matches_golden``).
HALF_CLEARANCE = 1e-4
HEAD_BIAS = np.array([0.1, -0.1], np.float32)  # see _tiny_train


def _ncw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _flat(prefix, tree):
    return {f"{prefix}/{k}/{leaf}": np.asarray(v, np.float32)
            for k in sorted(tree) for leaf, v in sorted(tree[k].items())}


def _tiny():
    raw = tck.read_checkpoint(os.path.join(GOLD, "unet1d_tiny.ckpt"))
    return raw["params"], raw["state"]


def _tiny_train():
    """The tiny golden net with head biases (0.1, -0.1): with the file's
    zero biases, a window whose head inputs are all ReLU zeros gives both
    logits 0 and a probability of exactly 0.5, which a last-bit difference
    can round either way."""
    params, state = _tiny()
    params = dict(params, head_conv={"kernel": params["head_conv"]["kernel"],
                                     "bias": HEAD_BIAS})
    return params, state


def _spike_batch(seed=14, rows=4, t=128):
    """Calcium-like z-normed traces (spikes through an exponential decay,
    plus noise) and their margin-pooled spike labels."""
    rng = np.random.default_rng(seed)
    spikes = (rng.random((rows, t)) < 0.03).astype(np.float32)
    kernel = np.exp(-np.arange(40) / 8.0)
    x = np.stack([np.convolve(s, kernel)[:t] for s in spikes]) * 3.0
    x = x + rng.standard_normal((rows, t)) * 0.15
    x = (x - x.mean(axis=1, keepdims=True)) / x.std(axis=1, keepdims=True)
    return x.astype(np.float32), maxpool_labels(spikes, MARGIN)


def _wbce(lib):
    return functools.partial(lib.weighted_binary_crossentropy, weightpos=2.0)


def _jax_reference(params, state, x, y, steps=STEPS, weight_decay=0.0,
                   eps=ADAM_EPS):
    """``steps`` JAX train steps (drp=0, float32 at HIGHEST, wbce pos=2, the
    spike metrics) with the JAX package's make_optimizer, eps raised
    through inject_hyperparams, as a flat dict: the metrics of each step,
    the gradients of step 1, the params and BN state after the last step,
    and the least distance of any step's probabilities from 0.5."""
    return _jax_reference_runs(params, state, x, y, steps, weight_decay,
                               eps)[-1]


def _jax_reference_runs(params, state, x, y, steps, weight_decay, eps):
    """The flat dict of :func:`_jax_reference` after each of 1..``steps``
    steps, from one run."""
    opt = jtrainer.make_optimizer(LR, weight_decay=weight_decay)
    opt_state = opt.init(params)
    opt_state.hyperparams["eps"] = jnp.asarray(eps, jnp.float32)
    apply = functools.partial(junet.apply, drp=0.0, margin=MARGIN,
                              precision=HIGHEST)

    @jax.jit
    def probs_of(p, s):
        return apply(p, s, x, train=True, rng=jax.random.PRNGKey(0))[0]

    def loss(p):
        return jnp.mean(_wbce(jlosses)(y, probs_of(p, state)))

    out = _flat("grads", jax.jit(jax.grad(loss))(params))
    step = jtrainer.make_train_step(apply, _wbce(jlosses), opt,
                                    metric_fns=dict(jlosses.SPIKE_METRICS))
    params = jax.tree.map(jnp.array, params)
    state = jax.tree.map(jnp.array, state)
    metrics, clearance, runs = [], np.inf, []
    for i in range(steps):
        probs = np.asarray(probs_of(params, state))
        clearance = min(clearance, float(np.abs(probs - 0.5).min()))
        params, state, opt_state, met = step(params, state, opt_state, x, y,
                                             jax.random.PRNGKey(i))
        metrics.append(met)
        run = dict(out)
        for k in metrics[0]:
            run[f"metrics/{k}"] = np.array([m[k] for m in metrics], np.float32)
        run.update(_flat("params", params))
        run.update(_flat("state", state))
        run["half_clearance"] = np.float32(clearance)
        runs.append(run)
    return runs


@functools.lru_cache(maxsize=None)
def _reference_runs(weight_decay):
    """One 3-step JAX run per optimizer, shared by the 1- and 3-step
    comparisons."""
    params, state = _tiny_train()
    x, y = _spike_batch(seed=11)
    return (params, state, x, y), _jax_reference_runs(
        params, state, x, y, STEPS, weight_decay, ADAM_EPS)


def _port_steps(params, state, x, y, steps=STEPS, weight_decay=0.0,
                eps=ADAM_EPS):
    model = tunet.from_jax_params(params, state, drp=0.0, margin=MARGIN)
    opt = ttrainer.make_optimizer(model, LR, weight_decay=weight_decay)
    for group in opt.param_groups:
        group["eps"] = eps
    step = ttrainer.make_train_step(model, _wbce(tlosses), opt,
                                    dict(tlosses.SPIKE_METRICS))
    metrics, grads = [], None
    for _ in range(steps):
        met = step(torch.from_numpy(x), torch.from_numpy(y))
        metrics.append({k: v.item() for k, v in met.items()})
        if grads is None:
            grads = tunet.jax_tree(model, {n: p.grad for n, p in
                                           model.named_parameters()})
    params, state = tunet.to_jax_params(model)
    return params, state, metrics, grads, model, opt


def jax_golden_train_step() -> dict:
    """The golden of ``unet1d_tiny_train_step.npz``, from the JAX package:
    the tiny golden UNet1D (``unet1d_tiny.ckpt``, nfb=4, head biases 0.1
    and -0.1) on 4 calcium-like traces of 128 samples with margin-pooled
    labels (margin 4), 3 Adam steps at lr 2e-3 and eps 1e-4 (drp=0,
    float32, wbce pos=2): the loss and spike metrics of each step, the
    gradients of step 1, and the params and BN state after step 3."""
    params, state = _tiny_train()
    x, y = _spike_batch()
    out = {"x": x, "y": y, "lr": np.float32(LR), "adam_eps": np.float32(ADAM_EPS),
           "margin": np.int32(MARGIN), "head_bias": HEAD_BIAS}
    out.update(_jax_reference(params, state, x, y))
    assert out["half_clearance"] >= HALF_CLEARANCE, out["half_clearance"]
    return out


# --- blocks ----------------------------------------------------------------

@pytest.mark.parametrize("k", [5, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_matches_jax(k, dtype):
    """SAME conv with the bias added in the compute dtype. float32: rtol
    1e-5, atol 1e-5 (sums in another order); bfloat16: atol 0.0625, one
    bf16 ulp at |y| < 16, and the bias added in bf16 on both sides."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    p = {"kernel": rng.standard_normal((k, 6, 3)).astype(np.float32),
         "bias": rng.standard_normal(3).astype(np.float32)}
    jdt = None if dtype == "float32" else jnp.bfloat16
    ref = jblocks.conv1d(x, p, dtype=jdt, precision=HIGHEST)
    conv = tblocks.Conv1d(6, 3, k, torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(p["kernel"].transpose(2, 1, 0).copy()))
        conv.bias.copy_(torch.from_numpy(p["bias"]))
    out = conv(_ncw(x), None if dtype == "float32" else torch.bfloat16)
    assert out.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 0.0625
    np.testing.assert_allclose(_nwc(out), np.asarray(ref, np.float32),
                               rtol=tol if dtype == "float32" else 0, atol=tol)


def test_conv1d_init_is_he_normal_fan_in_k_cin():
    """he_normal over fan_in k * Cin, truncated at 2 sigma: the std of a
    large draw is 0.8796 * sqrt(2 / (5 * 64)) within 2%."""
    w = tblocks.Conv1d(64, 256, 5, torch.Generator().manual_seed(0)).weight
    assert tuple(w.shape) == (256, 64, 5)
    want = 0.8796 * (2.0 / (5 * 64)) ** 0.5
    assert abs(w.std().item() / want - 1) < 0.02
    assert w.abs().max().item() <= 2 * (2.0 / (5 * 64)) ** 0.5 + 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batch_norm_on_ncw_matches_jax(dtype):
    """The rank-generic BN on a (B, C, T) tensor: output float32 rtol 1e-5
    atol 1e-5, bfloat16 atol 3.2e-2 (one bf16 ulp at |y| < 8); the running
    state rtol 1e-6."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 50, 7)) * 2 + 0.5).astype(np.float32)
    p = {"gamma": rng.uniform(0.5, 1.5, 7).astype(np.float32),
         "beta": rng.normal(0, 0.3, 7).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.3, 7).astype(np.float32),
         "var": rng.uniform(0.5, 2, 7).astype(np.float32)}
    jx = x if dtype == "float32" else jnp.asarray(x, jnp.bfloat16)
    ref, ref_s = jblocks.batch_norm(jx, p, s, train=True, momentum=0.99)
    bn = tblocks.BatchNorm(7, 0.99)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["gamma"]))
        bn.bias.copy_(torch.from_numpy(p["beta"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
    out = bn(_ncw(x).to(getattr(torch, dtype)), train=True)
    tol = 1e-5 if dtype == "float32" else 3.2e-2
    np.testing.assert_allclose(_nwc(out), np.asarray(ref, np.float32),
                               rtol=tol if dtype == "float32" else 0, atol=tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), ref_s["mean"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), ref_s["var"], rtol=1e-6)
    # Eval mode on the same tensor reads the running state.
    ev, _ = jblocks.batch_norm(x, p, ref_s, train=False, momentum=0.99)
    np.testing.assert_allclose(_nwc(bn(_ncw(x), train=False)), np.asarray(ev),
                               rtol=1e-6, atol=1e-6)


def _tied_pool_input(rng, shape):
    """``chip_smoke.tied_1d_input`` (ReLU zeros, forced equal pairs, a
    constant stretch, a zero-filled tail) in the JAX package's (B, T, C)."""
    b, t, c = shape
    return np.ascontiguousarray(np.moveaxis(tied_1d_input(rng, (b, c, t)), 1, -1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool2_grad_ties_match_jax(dtype):
    """Forward and gradient equal to ``blocks.pool2_axis`` and its dense
    vjp bit for bit: a tied pair's gradient goes to its first element."""
    rng = np.random.default_rng(7)
    z = _tied_pool_input(rng, (3, 32, 4))
    jz = jnp.asarray(z, getattr(jnp, dtype))
    out, vjp = jax.vjp(lambda h: jblocks.pool2_axis(h, 1), jz)
    ct = rng.standard_normal(out.shape).astype(np.float32)
    (gref,) = vjp(jnp.asarray(ct, getattr(jnp, dtype)))
    tz = _ncw(z).to(getattr(torch, dtype)).requires_grad_()
    tout = tblocks.pool2(tz)
    tout.backward(_ncw(ct).to(tz.dtype))
    np.testing.assert_array_equal(_nwc(tout), np.asarray(out, np.float32))
    np.testing.assert_array_equal(_nwc(tz.grad), np.asarray(gref, np.float32))
    g = _nwc(tz.grad)
    assert (g[:, 0::4] != 0).any() and not (g[:, 1::4][z[:, 0::4] == z[:, 1::4]]).any()


@pytest.mark.parametrize("window", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_margin_head_grad_ties_match_jax(window, dtype):
    """The SAME max-pool of the head (odd and even windows, XLA's uneven
    padding) against ``blocks.maxpool1d`` and the transpose of XLA's
    ``reduce_window``, on tied inputs: forward and gradient bit for bit."""
    rng = np.random.default_rng(window)
    z = _tied_pool_input(rng, (2, 40, 2))
    z[1, :, 1] = np.round(z[1, :, 1])
    jz = jnp.asarray(z, getattr(jnp, dtype))
    out, vjp = jax.vjp(lambda h: jblocks.maxpool1d(h, window, 1, "SAME"), jz)
    ct = rng.standard_normal(out.shape).astype(np.float32)
    (gref,) = vjp(jnp.asarray(ct, getattr(jnp, dtype)))
    tz = _ncw(z).to(getattr(torch, dtype)).requires_grad_()
    tout = tblocks.maxpool1d_same(tz, window)
    tout.backward(_ncw(ct).to(tz.dtype))
    np.testing.assert_array_equal(_nwc(tout), np.asarray(out, np.float32))
    np.testing.assert_array_equal(_nwc(tz.grad), np.asarray(gref, np.float32))


def test_upsample1d_matches_jax():
    x = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    np.testing.assert_array_equal(_nwc(tblocks.upsample1d(_ncw(x))),
                                  np.asarray(jblocks.upsample1d(x)))


# --- the forward -------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_random():
    """The tiny golden net's kernels with random BN parameters and
    statistics and random conv biases."""
    params, state = _tiny()
    rng = np.random.default_rng(4)
    state = {k: {"mean": rng.normal(0, 0.2, v["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
             for k, v in state.items()}
    params = {k: ({"gamma": rng.uniform(0.5, 1.5, v["gamma"].shape).astype(np.float32),
                   "beta": rng.normal(0, 0.2, v["beta"].shape).astype(np.float32)}
                  if "gamma" in v else
                  {"kernel": v["kernel"],
                   "bias": rng.normal(0, 0.1, v["bias"].shape).astype(np.float32)})
              for k, v in params.items()}
    return params, state


@pytest.mark.parametrize("t", [64, 128, 272])
@pytest.mark.parametrize("margin", [0, 1, 3, 4, 7])
def test_forward_matches_jax(tiny_random, margin, t):
    """Eval forward at even and odd margin windows: float32 rtol 1e-4,
    atol 1e-6 (``tests/test_golden.py``'s tolerance)."""
    params, state = tiny_random
    x = np.random.default_rng(t + margin).standard_normal((3, t)).astype(np.float32)
    ref, _ = junet.apply(params, state, x, margin=margin, precision=HIGHEST)
    model = tunet.from_jax_params(params, state, margin=margin).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.shape == (3, t) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)


def test_bf16_forward_matches_jax(tiny_random):
    """bfloat16 compute with float32 BN statistics and a float32 head:
    probabilities within atol 0.03 of the JAX bf16 forward (convs summed in
    another order round to other bf16 values; 11 layers deep) and within
    0.05 of the float32 forward."""
    params, state = tiny_random
    x = np.random.default_rng(9).standard_normal((3, 128)).astype(np.float32)
    ref, _ = junet.apply(params, state, x, margin=4, compute_dtype=jnp.bfloat16)
    ref32, _ = junet.apply(params, state, x, margin=4, precision=HIGHEST)
    model = tunet.from_jax_params(params, state, torch.bfloat16).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=0.03)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref32), rtol=0, atol=0.05)


def test_golden_y1():
    """``unet1d_tiny.ckpt`` read by the port's reader reproduces
    ``golden_io.npz`` y1: rtol 1e-4, atol 1e-6 (``tests/test_golden.py``)."""
    data = np.load(os.path.join(GOLD, "golden_io.npz"))
    model = tunet.from_jax_params(*_tiny(), margin=4).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(data["x1"])).numpy()
    np.testing.assert_allclose(out, data["y1"], rtol=1e-4, atol=1e-6)


def test_params_round_trip_and_counts():
    """JAX layout -> port -> JAX layout bit for bit (kernels, BN, state),
    the layer list; the shapes of every param at nfb=32 and
    ``param_count`` equal JAX's init (4.37M weights); ``forward_flops``
    equals JAX's."""
    params, state = _tiny()
    model = tunet.from_jax_params(params, state)
    p2, s2 = tunet.to_jax_params(model)
    for tree, ref in ((p2, params), (s2, state)):
        assert sorted(tree) == sorted(ref)
        for k in ref:
            for leaf in ref[k]:
                np.testing.assert_array_equal(tree[k][leaf], np.asarray(ref[k][leaf]))
    assert tunet.layer_order(4) == junet.layer_order(4)
    assert tunet.LAYER_ORDER == junet.LAYER_ORDER
    big = tunet.UNet1D(nfb=32)
    jp, _ = jax.eval_shape(junet.init, jax.random.PRNGKey(0))
    assert tunet.param_count(big) == junet.param_count(jp) == 4366178
    tp, _ = tunet.to_jax_params(big)
    assert {k: {l: v.shape for l, v in d.items()} for k, d in tp.items()} == \
        {k: {l: v.shape for l, v in d.items()} for k, d in jp.items()}
    for t, nfb in ((4096, 32), (64, 4), (30016, 32)):
        assert tunet.forward_flops(t, nfb) == junet.forward_flops(t, nfb)
    with pytest.raises(ValueError, match="multiple of 16"):
        tunet.forward_flops(100)


# --- the train forward and its gradients ------------------------------------

def _train_loss_and_grads(params, state, x, y, drp):
    """One jitted JAX training forward and backward (compiled once: faster
    here than op-by-op dispatch)."""
    def loss(p):
        probs, new_state = junet.apply(p, state, x, train=True,
                                       rng=jax.random.PRNGKey(0), drp=drp,
                                       margin=MARGIN, precision=HIGHEST)
        return jnp.mean(_wbce(jlosses)(y, probs)), (probs, new_state)

    (_, (probs, new_state)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    return probs, new_state, grads


def _check_train_forward(model, x, y, probs, new_state, grads):
    out = model(torch.from_numpy(x), train=True,
                generator=torch.Generator().manual_seed(0))
    _wbce(tlosses)(torch.from_numpy(y), out).mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(probs),
                               rtol=0, atol=1e-5)
    _, tstate = tunet.to_jax_params(model)
    ref_state = _flat("state", new_state)
    for k, v in _flat("state", tstate).items():
        np.testing.assert_allclose(v, ref_state[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    tgrads = _flat("g", tunet.jax_tree(model, {n: p.grad for n, p in
                                               model.named_parameters()}))
    ref = _flat("g", grads)
    gmax = max(np.abs(v).max() for v in ref.values())
    for k, v in tgrads.items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-4, atol=1e-5 * gmax,
                                   err_msg=k)


def test_train_forward_and_grads_match_jax():
    """The tiny golden net at drp=0, float32: probs atol 1e-5 (batch
    statistics over as few as 32 values at the bottleneck), new BN state
    rtol 1e-5 atol 1e-6, gradients rtol 1e-4 plus 1e-5 of the largest."""
    params, state = _tiny_train()
    x, y = _spike_batch()
    probs, new_state, grads = _train_loss_and_grads(params, state, x, y, 0.0)
    model = tunet.from_jax_params(params, state, drp=0.0, margin=MARGIN)
    _check_train_forward(model, x, y, probs, new_state, grads)


def test_train_forward_with_injected_dropout_masks(monkeypatch):
    """drp=0.05: both packages' ``blocks.dropout`` replaced by the same
    recorded keep-masks, site by site in call order (the 7 sites of
    ``apply``, at rates drp and 2 drp), so the forward, BN state and
    gradients are held as at drp=0."""
    params, state = _tiny_train()
    x, y = _spike_batch(seed=12)
    rng = np.random.default_rng(5)
    masks, rates = [], []

    def jax_dropout(h, rate, train, key):
        if not train or rate == 0.0:
            return h
        masks.append(rng.random(h.shape) < 1 - rate)
        rates.append(rate)
        return jblocks.dropout_with_mask(h, rate, masks[-1])

    monkeypatch.setattr(jblocks, "dropout", jax_dropout)
    probs, new_state, grads = _train_loss_and_grads(params, state, x, y, 0.05)
    assert len(masks) == 7
    np.testing.assert_allclose(sorted(rates), [0.05] * 2 + [0.1] * 5)
    recorded = iter(zip(masks, rates))

    def port_dropout(h, rate, train, generator=None):
        if not train or rate == 0.0:
            return h
        mask, want = next(recorded)
        assert rate == pytest.approx(want) and tuple(h.shape) == np.moveaxis(
            mask, -1, 1).shape
        return tblocks.dropout_with_mask(h, rate, _ncw(mask))

    monkeypatch.setattr(tblocks, "dropout", port_dropout)
    model = tunet.from_jax_params(params, state, drp=0.05, margin=MARGIN)
    _check_train_forward(model, x, y, probs, new_state, grads)
    assert next(recorded, None) is None


def test_train_forward_needs_a_generator_for_dropout():
    model = tunet.UNet1D(nfb=2)
    x = torch.zeros(2, 32)
    with pytest.raises(ValueError, match="generator"):
        model(x, train=True)
    a = model(x + 1, train=True, generator=torch.Generator().manual_seed(0))
    b = model(x + 1, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


# --- Adam steps ----------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
def test_train_steps_match_jax(steps, weight_decay):
    """One and three steps of ``make_train_step`` with each package's
    ``make_optimizer`` at eps 1e-4, wbce pos=2 and the 5 spike metrics:
    metrics, step-1 gradients, params and BN state as
    ``assert_matches_golden`` holds them, rounded metrics exactly."""
    (params, state, x, y), runs = _reference_runs(weight_decay)
    ref = runs[steps - 1]
    assert ref["half_clearance"] >= HALF_CLEARANCE
    tp, ts, tmet, tgrads, _, _ = _port_steps(params, state, x, y, steps,
                                             weight_decay)
    assert_matches_golden(ref, tmet, tgrads, tp, ts, rounded_atol=0)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
def test_adam_checkpoint_reads_across_packages(tmp_path, weight_decay):
    """A UNet1D checkpoint with Adam's state, both ways: the port's file
    through the JAX package's ``load_checkpoint`` with ``opt.init(params)``
    as the template gives the port's moments bit for bit, and optax's own
    after the same 2 steps within the gradients' tolerance (rtol 1e-4 plus
    1e-5 of the largest; nu, a square, rtol 2e-4), counts and lr equal; the
    JAX package's file through the port's reader into
    ``load_optax_state_`` gives back its moments, step and lr bit for
    bit."""
    params, state = _tiny_train()
    x, y = _spike_batch(seed=12)
    ref_opt = jtrainer.make_optimizer(LR, weight_decay=weight_decay)
    jopt_state = ref_opt.init(params)
    jopt_state.hyperparams["eps"] = jnp.asarray(ADAM_EPS, jnp.float32)
    apply = functools.partial(junet.apply, drp=0.0, margin=MARGIN,
                              precision=HIGHEST)
    jstep = jtrainer.make_train_step(apply, _wbce(jlosses), ref_opt,
                                     metric_fns=dict(jlosses.SPIKE_METRICS))
    jp, js = jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, state)
    for i in range(2):
        jp, js, jopt_state, _ = jstep(jp, js, jopt_state, x, y,
                                      jax.random.PRNGKey(i))
    tp, ts, _, _, model, opt = _port_steps(params, state, x, y, 2, weight_decay)

    # Port -> JAX.
    path = str(tmp_path / "port.ckpt")
    written = ttrainer.optax_state(model, opt)
    tck.save_checkpoint(path, tp, ts, written, meta={"epoch": 1})
    p0, s0 = _tiny()
    _, _, got, meta = jck.load_checkpoint(path, p0, s0, ref_opt.init(p0))
    assert int(got.count) == 2 and meta["epoch"] == 1
    assert jtrainer.current_lr(got) == pytest.approx(LR, rel=1e-6)
    for key, rtol in (("mu", 1e-4), ("nu", 2e-4)):
        g = _flat(key, getattr(got.inner_state[0], key))
        mine = _flat(key, written["inner_state"]["0"][key])
        w = _flat(key, getattr(jopt_state.inner_state[0], key))
        top = max(np.abs(v).max() for v in w.values())
        for k in w:
            np.testing.assert_array_equal(g[k], mine[k], err_msg=k)
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-5 * top,
                                       err_msg=k)

    # JAX -> port.
    jpath = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint(jpath, jp, js, jopt_state, meta={"epoch": 1})
    raw = tck.read_checkpoint(jpath)
    model2 = tunet.from_jax_params(raw["params"], raw["state"], drp=0.0)
    opt2 = ttrainer.make_optimizer(model2, 1.0, weight_decay=weight_decay)
    ttrainer.load_optax_state_(model2, opt2, raw["opt_state"])
    assert ttrainer.current_lr(opt2) == pytest.approx(LR, rel=1e-6)
    back = ttrainer.optax_state(model2, opt2)
    assert int(back["count"]) == 2
    for key in ("mu", "nu"):
        g = _flat(key, back["inner_state"]["0"][key])
        w = _flat(key, raw["opt_state"]["inner_state"]["0"][key])
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# --- the frozen golden ------------------------------------------------------

def test_golden_train_step_is_current():
    """The JAX package still produces the frozen golden: rtol 1e-5, atol
    1e-6 (XLA's CPU threads may split sums differently on another box)."""
    fresh = jax_golden_train_step()
    with np.load(GOLDEN_STEP) as gold:
        assert sorted(gold.files) == sorted(fresh)
        for k in gold.files:
            np.testing.assert_allclose(fresh[k], gold[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_port_train_step_matches_golden_on_cpu():
    with np.load(GOLDEN_STEP) as f:
        gold = dict(f)
    params, state = _tiny_train()
    x, y = _spike_batch()
    np.testing.assert_array_equal(gold["x"], x)
    np.testing.assert_array_equal(gold["y"], y)
    tp, ts, tmet, tgrads, _, _ = _port_steps(params, state, x, y,
                                             eps=float(gold["adam_eps"]))
    assert_matches_golden(gold, tmet, tgrads, tp, ts, rounded_atol=0)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_unet1d.py "
                 "--write-golden")
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(GOLDEN_STEP, **jax_golden_train_step())
    print("wrote", GOLDEN_STEP)
