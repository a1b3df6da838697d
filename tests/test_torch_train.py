"""The port's training slice below ``fit`` against the JAX package, on the
same numpy-seeded inputs, on the CPU: losses and metrics, train-mode BN,
max-pool routing, dropout, the train forward and its gradients, Adam and
AdamW steps, LR schedules, EMA and the window sampler.

It also holds the frozen golden ``tests/golden/unet2d_tiny_train_step.npz``,
which ``chip_smoke.py`` checks on the card: the JAX package regenerates it
here and must still agree with it, and the port on the CPU must match it.
Write it anew (only on purpose) with::

    PYTHONPATH=. python tests/test_torch_train.py --write-golden

Why the Adam steps that are compared run with eps = 1e-4: with optax's
default eps = 1e-8 Adam's first step moves every weight by about
lr * sign(g). The conv biases that feed a BN have a gradient that is zero
up to rounding (1e-9 here), so each package moves them by up to lr in a
direction set by its rounding, and the two trajectories part after one step
(3 steps: weights apart by up to 8.6e-3, loss by 8e-5 relative). eps = 1e-4
damps exactly that, and the steps then agree to 4e-6. Both packages raise
eps through their own hyperparameter mechanism. The default eps is held on
identical gradients (``test_optimizer_matches_optax_on_same_grads``) and by
the loss over 3 steps.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcalcium_tpu.data.fixtures import realistic_neurons
from deepcalcium_tpu.models import blocks as jblocks
from deepcalcium_tpu.models import unet2d as junet
from deepcalcium_tpu.ops import augment as jaug
from deepcalcium_tpu.ops import losses as jlosses
from deepcalcium_tpu.train import sampler as jsampler
from deepcalcium_tpu.train import trainer as jtrainer
from deepcalcium_torch.models import blocks as tblocks
from deepcalcium_torch.models import unet2d as tunet
from deepcalcium_torch.ops import augment as taug
from deepcalcium_torch.ops import losses as tlosses
from deepcalcium_torch.train import sampler as tsampler
from deepcalcium_torch.train import trainer as ttrainer
from deepcalcium_torch.train.checkpoints import load_npz_params

# The card's tolerances for the golden, shared so both hold the same ones.
from chip_smoke import assert_matches_golden

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_STEP = os.path.join(GOLD, "unet2d_tiny_train_step.npz")
HIGHEST = jax.lax.Precision.HIGHEST
LR = 2e-3
ADAM_EPS = 1e-4  # see the module docstring
STEPS = 3


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _flat(prefix, tree):
    return {f"{prefix}/{k}/{leaf}": np.asarray(v, np.float32)
            for k in sorted(tree) for leaf, v in sorted(tree[k].items())}


def _golden_inputs():
    params, state = load_npz_params(os.path.join(GOLD, "unet2d_tiny_params.npz"))
    x = np.load(os.path.join(GOLD, "golden_io.npz"))["x2"]
    y = (x > 0.5).astype(np.float32)
    return params, state, x, y


def _jax_reference(params, state, x, y, weight_decay=0.0, eps=ADAM_EPS):
    """``STEPS`` JAX train steps (drp=0, float32 at HIGHEST) with the JAX
    package's make_optimizer, eps raised through inject_hyperparams, as a
    flat dict: the metrics of each step, the gradients of step 1, and the
    params and BN state after the last step."""
    opt = jtrainer.make_optimizer(LR, weight_decay=weight_decay)
    opt_state = opt.init(params)
    opt_state.hyperparams["eps"] = jnp.asarray(eps, jnp.float32)
    apply = functools.partial(junet.apply, drp=0.0, precision=HIGHEST)

    def loss(p):
        probs, _ = apply(p, state, x, train=True, rng=jax.random.PRNGKey(0))
        return jnp.mean(jlosses.binary_crossentropy(y, probs))

    out = _flat("grads", jax.grad(loss)(jax.tree.map(jnp.asarray, params)))
    step = jtrainer.make_train_step(apply, jlosses.binary_crossentropy, opt)
    params = jax.tree.map(jnp.array, params)
    state = jax.tree.map(jnp.array, state)
    metrics = []
    for i in range(STEPS):
        params, state, opt_state, met = step(params, state, opt_state, x, y,
                                             jax.random.PRNGKey(i))
        metrics.append(met)
    for k in metrics[0]:
        out[f"metrics/{k}"] = np.array([m[k] for m in metrics], np.float32)
    out.update(_flat("params", params))
    out.update(_flat("state", state))
    return out


def _port_steps(params, state, x, y, weight_decay=0.0, eps=ADAM_EPS):
    model = tunet.from_jax_params(params, state, drp=0.0)
    opt = ttrainer.make_optimizer(model, LR, weight_decay=weight_decay)
    for group in opt.param_groups:
        group["eps"] = eps
    step = ttrainer.make_train_step(model, tlosses.binary_crossentropy, opt)
    metrics, grads = [], None
    for _ in range(STEPS):
        met = step(torch.from_numpy(x), torch.from_numpy(y))
        metrics.append({k: v.item() for k, v in met.items()})
        if grads is None:
            grads = tunet.jax_tree(model, {n: p.grad for n, p in
                                           model.named_parameters()})
    params, state = tunet.to_jax_params(model)
    return params, state, metrics, grads


def jax_golden_train_step() -> dict:
    """The golden of ``unet2d_tiny_train_step.npz``, from the JAX package:
    the tiny golden net on ``golden_io.npz`` x2 with the target x2 > 0.5,
    3 Adam steps at lr 2e-3 and eps 1e-4 (drp=0, float32): the loss and
    metrics of each step, the gradients of step 1, and the params and BN
    state after step 3."""
    params, state, x, y = _golden_inputs()
    out = {"x": x, "y": y, "lr": np.float32(LR), "adam_eps": np.float32(ADAM_EPS)}
    out.update(_jax_reference(params, state, x, y))
    return out


# --- losses and metrics ----------------------------------------------------

def _loss_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    yt = (rng.random(shape) > 0.7).astype(np.float32)
    yp = rng.random(shape).astype(np.float32)
    flat = yp.reshape(-1)
    flat[:7] = 0.5      # exactly half: both packages round it to 0 (even)
    flat[7:9] = (0.0, 1.0)
    return yt, yp


_REGISTRY = ([("LOSSES", k) for k in jlosses.LOSSES]
             + [("NEURON_METRICS", k) for k in jlosses.NEURON_METRICS]
             + [("SPIKE_METRICS", k) for k in jlosses.SPIKE_METRICS])


@pytest.mark.parametrize("registry,name", _REGISTRY)
def test_losses_and_metrics_match_jax(registry, name):
    """Every registry entry on (B, H, W) and (B, T) inputs holding exact
    0, 0.5 and 1: rtol 1e-6, atol 1e-7 (float32 sums in another order)."""
    assert list(getattr(tlosses, registry)) == list(getattr(jlosses, registry))
    for shape in ((4, 16, 16), (4, 64)):
        yt, yp = _loss_inputs(shape)
        ref = np.asarray(getattr(jlosses, registry)[name](yt, yp))
        out = getattr(tlosses, registry)[name](torch.from_numpy(yt),
                                               torch.from_numpy(yp))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_round_half_to_even_pinned():
    """0.5 rounds to 0 in both packages, so a pixel at exactly 0.5 is
    negative; 1.5 and 2.5 show the half-to-even rule."""
    v = np.array([0.5, 1.5, 2.5, 0.49999997, 0.50000006], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(v)).numpy(),
                                  np.asarray(jnp.round(v)))
    np.testing.assert_array_equal(np.asarray(jnp.round(v)), [0, 2, 2, 0, 1])
    yt = np.zeros((1, 4), np.float32)
    yp = np.full((1, 4), 0.5, np.float32)
    assert tlosses.posyp(torch.from_numpy(yt), torch.from_numpy(yp)).item() == 0.0
    assert float(jlosses.posyp(yt, yp)) == 0.0


# --- blocks ----------------------------------------------------------------

@pytest.mark.parametrize("momentum", [0.99, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batch_norm_matches_jax(momentum, dtype):
    """Output and new running state. float32: rtol 1e-5, atol 1e-5 (batch
    variance summed in another order); bfloat16 output: atol 3.2e-2, one
    bf16 ulp at |y| < 8. The running state is float32 in both: rtol 1e-6."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 6, 7)) * 2 + 0.5).astype(np.float32)
    p = {"gamma": rng.uniform(0.5, 1.5, 7).astype(np.float32),
         "beta": rng.normal(0, 0.3, 7).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.3, 7).astype(np.float32),
         "var": rng.uniform(0.5, 2, 7).astype(np.float32)}
    jx = x if dtype == "float32" else jnp.asarray(x, jnp.bfloat16)
    ref, ref_s = jblocks.batch_norm(jx, p, s, train=True, momentum=momentum)
    bn = tblocks.BatchNorm(7, momentum)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["gamma"]))
        bn.bias.copy_(torch.from_numpy(p["beta"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
    tx = _nchw(x).to(getattr(torch, dtype))
    out = bn(tx, train=True)
    assert out.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 3.2e-2
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref, np.float32),
                               rtol=tol if dtype == "float32" else 0, atol=tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), ref_s["mean"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), ref_s["var"], rtol=1e-6)
    # Eval mode reads the running state and leaves it alone.
    before = bn.running_mean.clone()
    bn(tx, train=False)
    assert torch.equal(bn.running_mean, before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool2_grad_ties_match_jax(dtype):
    """ReLU'd activations (many exact-zero ties), an all-equal window and a
    (1, 2; 2, 0) window: forward and gradient equal to ``blocks.maxpool2``
    and its dense custom_vjp, bit for bit."""
    rng = np.random.default_rng(5)
    z = np.maximum(rng.standard_normal((2, 8, 8, 3)), 0).astype(np.float32)
    z[0, 0:2, 0:2, 0] = [[1.0, 2.0], [2.0, 0.0]]
    z[1, 2:4, 4:6, 2] = 3.0
    ct = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    jz = jnp.asarray(z, getattr(jnp, dtype))
    out, vjp = jax.vjp(jblocks.maxpool2, jz)
    (gref,) = vjp(jnp.asarray(ct, getattr(jnp, dtype)))
    tz = _nchw(z).to(getattr(torch, dtype)).requires_grad_()
    tout = tblocks.maxpool2(tz)
    tout.backward(_nchw(ct).to(tz.dtype))
    np.testing.assert_array_equal(_nhwc(tout), np.asarray(out, np.float32))
    np.testing.assert_array_equal(_nhwc(tz.grad), np.asarray(gref, np.float32))
    assert _nhwc(tz.grad)[0, 0, 1, 0] != 0 and _nhwc(tz.grad)[0, 1, 0, 0] == 0
    assert (_nhwc(tz.grad)[1, 2:4, 4:6, 2] != 0).sum() == 1


@pytest.mark.parametrize("rate", [0.25, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_with_mask_matches_jax(rate, dtype):
    """An injected keep-mask gives the JAX package's ``dropout_with_mask``
    bit for bit."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 6, 4)).astype(np.float32)
    mask = rng.random(x.shape) < 1 - rate
    ref = jblocks.dropout_with_mask(jnp.asarray(x, getattr(jnp, dtype)), rate,
                                    mask)
    out = tblocks.dropout_with_mask(_nchw(x).to(getattr(torch, dtype)), rate,
                                    _nchw(mask))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_nhwc(out), np.asarray(ref, np.float32))


def test_dropout_draws_from_its_generator():
    x = torch.ones(64, 32, 32)
    assert tblocks.dropout(x, 0.25, train=False) is x
    a = tblocks.dropout(x, 0.25, True, torch.Generator().manual_seed(4))
    b = tblocks.dropout(x, 0.25, True, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, float(np.float32(1.0 / 0.75))}
    assert abs((a > 0).float().mean().item() - 0.75) < 0.01


# --- the train forward, gradients and optimizer ----------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_train_forward_and_grads_match_jax(remat):
    """The tiny golden net at drp=0, float32: probs atol 1e-5 (batch
    statistics over as few as 8 values at the bottleneck), new BN state
    rtol 1e-5 atol 1e-6, gradients rtol 1e-4 plus 1e-5 of the largest.
    ``remat`` recomputes the blocks and must change nothing, the running
    state included (it is folded in once)."""
    params, state, x, y = _golden_inputs()

    def loss(p):
        probs, new_state = junet.apply(p, state, x, train=True,
                                       rng=jax.random.PRNGKey(0), drp=0.0,
                                       precision=HIGHEST)
        return jnp.mean(jlosses.binary_crossentropy(y, probs)), (probs, new_state)

    (_, (probs, new_state)), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    model = tunet.from_jax_params(params, state, drp=0.0, remat=remat)
    out = model(torch.from_numpy(x), train=True)
    tlosses.binary_crossentropy(torch.from_numpy(y), out).mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(probs),
                               rtol=0, atol=1e-5)
    _, tstate = tunet.to_jax_params(model)
    for k, v in _flat("state", tstate).items():
        np.testing.assert_allclose(v, _flat("state", new_state)[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    tgrads = _flat("g", tunet.jax_tree(model, {n: p.grad for n, p in
                                               model.named_parameters()}))
    ref = _flat("g", grads)
    gmax = max(np.abs(v).max() for v in ref.values())
    for k, v in tgrads.items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-4, atol=1e-5 * gmax,
                                   err_msg=k)


def test_train_forward_needs_a_generator_for_dropout():
    model = tunet.UNet2DS(nfb=2)
    x = torch.zeros(1, 16, 16)
    with pytest.raises(ValueError, match="generator"):
        model(x, train=True)
    with pytest.raises(ValueError, match="folded"):
        model.eval().fold()(x, train=True)
    # Dropout on: two draws from one seed agree, another seed differs.
    a = model(x + 1, train=True, generator=torch.Generator().manual_seed(0))
    b = model(x + 1, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
def test_train_steps_match_jax(weight_decay):
    """3 steps of ``make_train_step`` with each package's ``make_optimizer``
    (Adam, or AdamW decaying kernels only) at eps 1e-4: the metrics, step-1
    gradients, params and BN state, held as ``assert_matches_golden`` holds
    them."""
    params, state, x, y = _golden_inputs()
    ref = _jax_reference(params, state, x, y, weight_decay)
    tp, ts, tmet, tgrads = _port_steps(params, state, x, y, weight_decay)
    assert_matches_golden(ref, tmet, tgrads, tp, ts)


def test_default_adam_loss_trajectory_matches_jax():
    """At optax's eps = 1e-8 the weights part (module docstring), but the
    loss of each of 3 steps agrees to rtol 1e-3."""
    params, state, x, y = _golden_inputs()
    ref = _jax_reference(params, state, x, y, eps=1e-8)
    _, _, tmet, _ = _port_steps(params, state, x, y, eps=1e-8)
    np.testing.assert_allclose([m["loss"] for m in tmet], ref["metrics/loss"],
                               rtol=1e-3)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
def test_optimizer_matches_optax_on_same_grads(weight_decay):
    """Both ``make_optimizer``s at their defaults (eps 1e-8) fed the same
    random gradients for 4 steps: params rtol 1e-5 atol 1e-7, and
    ``optax_state`` equal to optax's own state dict in layout and to rtol
    2e-5 atol 1e-7 in value (a first moment that nearly cancels is held to
    a few float32 ulps of its terms). optax keeps its hyperparameters in float32: its 1 - b2 is
    1.3e-5 off 1e-3, and so is its second moment."""
    from flax import serialization

    model = tunet.UNet2DS(nfb=2, generator=torch.Generator().manual_seed(1))
    params, _ = tunet.to_jax_params(model)
    jopt = jtrainer.make_optimizer(LR, weight_decay=weight_decay)
    jstate = jopt.init(params)
    topt = ttrainer.make_optimizer(model, LR, weight_decay=weight_decay)
    rng = np.random.default_rng(0)
    for _ in range(4):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        updates, jstate = jopt.update(g, jstate, params)
        params = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)
        for name, t in tunet.torch_tensors(model, g).items():
            model.get_parameter(name).grad = t
        topt.step()
    tparams, _ = tunet.to_jax_params(model)
    for k, v in _flat("p", tparams).items():
        np.testing.assert_allclose(v, _flat("p", params)[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    ref = serialization.to_state_dict(jax.tree.map(np.asarray, jstate))
    out = ttrainer.optax_state(model, topt)

    def same(a, b, path):
        assert isinstance(a, dict) == isinstance(b, dict), path
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype, path
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-7, err_msg=path)

    same(out, ref, "opt_state")
    assert int(out["count"]) == 4


def test_set_lr_reaches_every_param_group():
    opt = ttrainer.make_optimizer(tunet.UNet2DS(nfb=2), LR, weight_decay=0.1)
    assert ttrainer.current_lr(opt) == LR
    ttrainer.set_lr(opt, 5e-4)
    assert ttrainer.current_lr(opt) == 5e-4
    assert [g["lr"] for g in opt.param_groups] == [5e-4, 5e-4]


def test_adamw_decays_kernels_only():
    model = tunet.UNet2DS(nfb=2)
    opt = ttrainer.make_optimizer(model, LR, weight_decay=0.1)
    ids = {id(p) for p in opt.param_groups[0]["params"]}
    decayed = sorted(n for n, p in model.named_parameters() if id(p) in ids)
    assert decayed == sorted(f"{name}.weight" for name, kind, _ in
                             tunet.layer_order(2) if kind != "bn")
    assert opt.param_groups[1]["weight_decay"] == 0.0


def test_lr_schedules_match_jax():
    values = [0.1, 0.2, 0.2, 0.19, 0.2, 0.15, 0.2, 0.1, 0.1, 0.3, 0.1, 0.1,
              0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1]
    jp, tp = jtrainer.ReduceLROnPlateau(), ttrainer.ReduceLROnPlateau()
    jlr = tlr = 2e-3
    for v in values:
        jlr, tlr = jp.update(v, jlr), tp.update(v, tlr)
        assert jlr == tlr
    assert tlr < 2e-3
    jc, tc = jtrainer.CosineDecay(2e-3, 7), ttrainer.CosineDecay(2e-3, 7)
    assert [jc.lr_at(e) for e in range(-1, 9)] == [tc.lr_at(e) for e in range(-1, 9)]
    with pytest.raises(ValueError):
        ttrainer.CosineDecay(1e-3, 0)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(3)
    ema = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2)]
    new = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2)]
    ref = jtrainer.ema_update(ema, new, 0.9)
    tema = [torch.from_numpy(e.copy()) for e in ema]
    ttrainer.ema_update(tema, [torch.from_numpy(n) for n in new], 0.9)
    for a, b in zip(tema, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


# --- sampler ---------------------------------------------------------------

def test_random_walk_and_d4_match_jax():
    np.testing.assert_array_equal(taug.GENERATOR_CODES, jaug.GENERATOR_CODES)
    ja, ta = np.random.default_rng(9), np.random.default_rng(9)
    assert ([jaug.compose_random_walk(ja, 15) for _ in range(200)]
            == [taug.compose_random_walk(ta, 15) for _ in range(200)])
    img = np.arange(20.0).reshape(4, 5)
    for code in range(8):
        np.testing.assert_array_equal(tsampler.apply_d4_numpy(img, code),
                                      jsampler.apply_d4_numpy(img, code))


def test_window_sampler_batches_bitwise_equal():
    """Two datasets of different sizes and bands, the full augmentation
    walk, and a re-weighting: the same seed gives the same batches."""
    rng = np.random.default_rng(0)
    S, M = [], []
    for shape in ((64, 72), (80, 48)):
        masks = realistic_neurons(rng, shape, nb_neurons=6, r_lo=2, r_hi=4)
        M.append(masks.max(axis=0).astype(np.float64))
        S.append(rng.standard_normal(shape).astype(np.float32))
    args = (S, M, ["a", "b"], [(0, 48), (0, 60)], (32, 32))
    js = jsampler.WindowSampler(*args, nb_max_augment=15, seed=865)
    ts = tsampler.WindowSampler(*args, nb_max_augment=15, seed=865)
    for i in range(4):
        if i == 2:
            js.reweight({"a": [0.9], "b": [0.2]})
            ts.reweight({"a": [0.9], "b": [0.2]})
        for a, b in zip(js.sample_batch(6), ts.sample_batch(6)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_prefetcher_puts_and_surfaces_errors():
    def gen():
        for i in range(3):
            yield np.full((2, 4), i, np.float32), np.zeros((2, 4), np.float32)
        raise RuntimeError("producer failed")

    pf = tsampler.Prefetcher(gen(), put_fn=tsampler.make_put_fn("cpu"))
    got = [next(pf) for _ in range(3)]
    assert all(isinstance(t, torch.Tensor) for b in got for t in b)
    assert [b[0][0, 0].item() for b in got] == [0.0, 1.0, 2.0]
    with pytest.raises(RuntimeError, match="producer failed"):
        next(pf)
    pf.close()
    endless = tsampler.Prefetcher(iter(lambda: (np.zeros(1),), None))
    next(endless)
    endless.close()
    with pytest.raises(StopIteration):
        next(endless)


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
    params, state, x, y = _golden_inputs()
    with np.load(GOLDEN_STEP) as f:
        gold = dict(f)
    np.testing.assert_array_equal(gold["x"], x)
    np.testing.assert_array_equal(gold["y"], y)
    tp, ts, tmet, tgrads = _port_steps(params, state, x, y,
                                       eps=float(gold["adam_eps"]))
    assert_matches_golden(gold, tmet, tgrads, tp, ts)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_train.py "
                 "--write-golden")
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(GOLDEN_STEP, **jax_golden_train_step())
    print("wrote", GOLDEN_STEP)
