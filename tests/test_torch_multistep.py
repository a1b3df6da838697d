"""K train steps per call (``trainer.make_multi_step``) and the fits'
``steps_per_dispatch`` and ``preset="perf"``, on the CPU, where the K steps
run as a loop (on the card they are one CUDA graph: ``test_torch_cuda.py``
and ``chip_smoke.py``).

- Against the JAX package's ``make_multi_step`` (a K-step ``lax.scan``),
  K=3, drp=0, float32, Adam at eps 1e-4, from the tiny golden nets, with
  the tolerances of ``test_torch_train.py::test_train_steps_match_jax``
  (``chip_smoke.assert_matches_golden``): unrounded metrics rtol 1e-4,
  rounded ones atol 2e-3 (2-D: one pixel of the 2048 a step holds crossing
  0.5) and 0 (1-D); params and the EMA atol 6e-5; BN state rtol 1e-4 atol
  1e-5.
- Against K calls of the port's own ``make_train_step``: bit for bit, with
  and without dropout drawn from one generator.
- ``fit(steps_per_dispatch=2)`` of both wrappers bit for bit their K=1 fit;
  ``preset="perf"`` picks the JAX package's K (per split for the spikes).
"""

import copy
import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcalcium_tpu.models import unet1d as junet1
from deepcalcium_tpu.models import unet2d as junet2
from deepcalcium_tpu.models import unet_1d_segmentation as jseg
from deepcalcium_tpu.models import unet_2d_summary as jsummary
from deepcalcium_tpu.ops import losses as jlosses
from deepcalcium_tpu.train import checkpoints as jck
from deepcalcium_tpu.train import sampler as jsampler
from deepcalcium_tpu.train import trainer as jtrainer
from deepcalcium_torch.models import unet1d as tunet1
from deepcalcium_torch.models import unet2d as tunet2
from deepcalcium_torch.models import unet_1d_segmentation as tseg
from deepcalcium_torch.models import unet_2d_summary as tsummary
from deepcalcium_torch.ops import losses as tlosses
from deepcalcium_torch.train import checkpoints as tck
from deepcalcium_torch.train import sampler as tsampler
from deepcalcium_torch.train import trainer as T
from deepcalcium_torch.train.checkpoints import load_npz_params

from chip_smoke import UNROUNDED_METRICS
from test_torch_unet1d import MARGIN, _spike_batch, _tiny_train

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
HIGHEST = jax.lax.Precision.HIGHEST
LR = 2e-3
ADAM_EPS = 1e-4
K = 3
EMA = 0.9


def _flat(prefix, tree):
    return {f"{prefix}/{k}/{leaf}": np.asarray(v, np.float32)
            for k in sorted(tree) for leaf, v in sorted(tree[k].items())}


def _case(net):
    """(params, state, xs, ys, port loss, JAX loss, port metrics, JAX
    metrics, JAX apply, port net constructor, rounded-metric atol, ema_decay)
    of the tiny golden net ``net``: K slabs of 2x32x32 (the golden's x2
    and two flips of it) or K batches of 4 calcium-like traces."""
    if net == "u2d":
        params, state = load_npz_params(os.path.join(GOLD, "unet2d_tiny_params.npz"))
        x = np.load(os.path.join(GOLD, "golden_io.npz"))["x2"]
        xs = np.stack([x, x[:, ::-1], x[:, :, ::-1]]).astype(np.float32)
        ys = (xs > 0.5).astype(np.float32)
        return dict(params=params, state=state, xs=xs, ys=ys,
                    tloss=tlosses.binary_crossentropy,
                    jloss=jlosses.binary_crossentropy, tmet=None, jmet=None,
                    apply=functools.partial(junet2.apply, drp=0.0,
                                            precision=HIGHEST),
                    build=lambda p, s, **kw: tunet2.from_jax_params(p, s, **kw),
                    rounded_atol=2e-3, ema_decay=EMA)
    params, state = _tiny_train()
    batches = [_spike_batch(seed=11 + k) for k in range(K)]
    return dict(params=params, state=state,
                xs=np.stack([b[0] for b in batches]),
                ys=np.stack([b[1] for b in batches]).astype(np.float32),
                tloss=functools.partial(tlosses.weighted_binary_crossentropy,
                                        weightpos=2.0),
                jloss=functools.partial(jlosses.weighted_binary_crossentropy,
                                        weightpos=2.0),
                tmet=dict(tlosses.SPIKE_METRICS),
                jmet=dict(jlosses.SPIKE_METRICS),
                apply=functools.partial(junet1.apply, drp=0.0, margin=MARGIN,
                                        precision=HIGHEST),
                build=lambda p, s, **kw: tunet1.from_jax_params(
                    p, s, margin=MARGIN, **kw),
                rounded_atol=0.0, ema_decay=None)


def _port_optimizer(model):
    opt = T.make_optimizer(model, LR)
    for group in opt.param_groups:
        group["eps"] = ADAM_EPS
    return opt


@pytest.mark.parametrize("net", ["u2d", "u1d"])
def test_multi_step_matches_jax(net):
    c = _case(net)
    opt = jtrainer.make_optimizer(LR)
    opt_state = opt.init(c["params"])
    opt_state.hyperparams["eps"] = jnp.asarray(ADAM_EPS, jnp.float32)
    multi = jtrainer.make_multi_step(c["apply"], c["jloss"], opt, K,
                                     metric_fns=c["jmet"],
                                     ema_decay=c["ema_decay"])
    params = jax.tree.map(jnp.array, c["params"])
    ema = jax.tree.map(jnp.array, c["params"]) if c["ema_decay"] else None
    jp, js, _, jema, jmet = multi(params, jax.tree.map(jnp.array, c["state"]),
                                  opt_state, ema, c["xs"], c["ys"],
                                  jax.random.PRNGKey(0))

    model = c["build"](c["params"], c["state"], drp=0.0)
    tema = copy.deepcopy(model) if c["ema_decay"] else None
    step = T.make_multi_step(model, c["tloss"], _port_optimizer(model), K,
                             c["tmet"], ema=tema, ema_decay=c["ema_decay"])
    tmet = step(torch.from_numpy(c["xs"]), torch.from_numpy(c["ys"]))

    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        got, want = tmet[k].numpy(), np.asarray(jmet[k])
        assert got.shape == want.shape == (K,) and got.dtype == np.float32
        exact = k in UNROUNDED_METRICS
        np.testing.assert_allclose(got, want, rtol=1e-4 if exact else 0,
                                   atol=0 if exact else c["rounded_atol"],
                                   err_msg=k)
    tp, ts = (tunet2 if net == "u2d" else tunet1).to_jax_params(model)
    groups = [("params", tp, jp, 0, 6e-5), ("state", ts, js, 1e-4, 1e-5)]
    if tema is not None:
        tep, _ = tunet2.to_jax_params(tema)
        groups.append(("ema", tep, jema, 0, 6e-5))
    for prefix, got, want, rtol, atol in groups:
        got, want = _flat(prefix, got), _flat(prefix, want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                       err_msg=k)


def _snapshot(model, opt, ema):
    out = {f"p.{n}": t.detach().clone() for n, t in model.named_parameters()}
    out.update({f"b.{n}": t.clone() for n, t in model.named_buffers()})
    for n, p in model.named_parameters():
        for key, v in opt.state[p].items():
            out[f"opt.{n}.{key}"] = v.clone()
    if ema is not None:
        out.update({f"ema.{n}": t.detach().clone()
                    for n, t in ema.named_parameters()})
    return out


@pytest.mark.parametrize("drp", [0.0, 0.1])
@pytest.mark.parametrize("net", ["u2d", "u1d"])
def test_multi_step_is_k_train_steps_bitwise(net, drp):
    """Two calls of K steps against 2K calls of ``make_train_step`` (and
    ``ema_update``) from the same start, dropout from one generator each in
    the same state: weights, buffers, Adam's state, the average, the
    metrics and the generator's state equal bit for bit."""
    c = _case(net)
    runs = []
    for multi in (True, False):
        model = c["build"](c["params"], c["state"], drp=drp)
        ema = copy.deepcopy(model)
        opt = _port_optimizer(model)
        gen = torch.Generator().manual_seed(5)
        xs, ys = torch.from_numpy(c["xs"]), torch.from_numpy(c["ys"])
        if multi:
            step = T.make_multi_step(model, c["tloss"], opt, K, c["tmet"],
                                     ema=ema, ema_decay=0.5)
            mets = [step(xs, ys, gen) for _ in range(2)]
            rows = T.metric_rows(mets, sorted(mets[0]))
        else:
            step = T.make_train_step(model, c["tloss"], opt, c["tmet"])
            mets = []
            for _ in range(2):
                for k in range(K):
                    mets.append(step(xs[k], ys[k], gen))
                    T.ema_update(ema.parameters(), model.parameters(), 0.5)
            rows = T.metric_rows(mets, sorted(mets[0]))
        runs.append((_snapshot(model, opt, ema), rows, gen.get_state()))
    (sa, ra, ga), (sb, rb, gb) = runs
    assert ra.shape == (2 * K, len(c["tmet"] or tlosses.NEURON_METRICS) + 1)
    assert torch.equal(ra, rb)
    assert torch.equal(ga, gb)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_multi_step_checks_its_arguments():
    model = tunet2.UNet2DS(nfb=2, drp=0.0)
    opt = T.make_optimizer(model)
    with pytest.raises(ValueError, match="nsteps"):
        T.make_multi_step(model, tlosses.binary_crossentropy, opt, 0)
    with pytest.raises(ValueError, match="together"):
        T.make_multi_step(model, tlosses.binary_crossentropy, opt, 2,
                          ema_decay=0.9)
    step = T.make_multi_step(model, tlosses.binary_crossentropy, opt, 2)
    with pytest.raises(ValueError, match="3 and 3 batches for 2 steps"):
        step(torch.zeros(3, 1, 16, 16), torch.zeros(3, 1, 16, 16))


def test_lr_change_reaches_the_multi_step():
    """``set_lr`` between calls: at lr 0 a call moves no weight (the BN
    running statistics still move), and the next rate is the one Adam
    takes."""
    c = _case("u2d")
    model = c["build"](c["params"], c["state"], drp=0.0)
    opt = _port_optimizer(model)
    step = T.make_multi_step(model, c["tloss"], opt, K)
    xs, ys = torch.from_numpy(c["xs"]), torch.from_numpy(c["ys"])
    step(xs, ys)
    before = _snapshot(model, opt, None)
    T.set_lr(opt, 0.0)
    step(xs, ys)
    after = _snapshot(model, opt, None)
    assert all(torch.equal(before[k], after[k]) for k in before
               if k.startswith("p."))
    assert not all(torch.equal(before[k], after[k]) for k in before
                   if k.startswith("b."))
    T.set_lr(opt, 1e-3)
    assert T.current_lr(opt) == 1e-3
    step(xs, ys)
    assert not all(torch.equal(after[k], p.detach()) for k, p in
                   ((f"p.{n}", p) for n, p in model.named_parameters()))


def test_capturable_optimizer_state_round_trips():
    """``make_capturable_`` gives every group a tensor rate and every
    parameter Adam's fresh state; ``optax_state``, ``set_lr`` and
    ``load_optax_state_`` take it as they take the default."""
    model = tunet2.UNet2DS(nfb=2)
    opt = T.make_optimizer(model, LR, weight_decay=0.1)
    plain = T.optax_state(model, opt)
    T.make_capturable_(opt)
    assert all(g["capturable"] and torch.is_tensor(g["lr"])
               for g in opt.param_groups)
    assert all(float(s["step"]) == 0.0 and not s["exp_avg"].any()
               for s in opt.state.values())
    state = T.optax_state(model, opt)
    assert jax.tree.map(np.asarray, state).keys() == plain.keys()
    np.testing.assert_array_equal(state["hyperparams"]["learning_rate"],
                                  plain["hyperparams"]["learning_rate"])
    lr = opt.param_groups[0]["lr"]
    T.set_lr(opt, 5e-4)
    assert opt.param_groups[0]["lr"] is lr and T.current_lr(opt) == np.float32(5e-4)
    T.load_optax_state_(model, opt, plain)
    assert T.current_lr(opt) == np.float32(LR)
    assert all(s["step"].device == p.device
               for p, s in opt.state.items())


def test_stack_batches_matches_jax():
    rng = np.random.default_rng(3)
    batches = [(rng.standard_normal((4, 8, 8)).astype(np.float32),
                (rng.random((4, 8, 8)) > 0.5).astype(np.float32))
               for _ in range(6)]
    got = tsampler.stack_batches(iter(batches), 3)
    want = jsampler.stack_batches(iter(batches), 3)
    for _ in range(2):
        (gx, gy), (wx, wy) = next(got), next(want)
        assert gx.shape == (3, 4, 8, 8)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


# --- The wrappers --------------------------------------------------------------

def _summaries():
    gen = np.random.default_rng(1)
    S, M = {}, {}
    for name in ("a", "b"):
        M[name] = np.zeros((64, 64), np.uint8)
        for cy, cx in gen.integers(6, 58, (8, 2)):
            M[name][cy - 3:cy + 4, cx - 3:cx + 4] = 1
        S[name] = (gen.standard_normal((64, 64)) + 2.0 * M[name]).astype(np.float32)
    return S, M


def _traces(n=10, t=200):
    gen = np.random.default_rng(2)
    spikes = (gen.random((n, t)) < 0.05).astype(np.float32)
    return (spikes * 3.0 + 0.2 * gen.standard_normal(spikes.shape)
            ).astype(np.float32), spikes


def _wrapper2d(cpdir, **kw):
    S, M = _summaries()
    return tsummary.UNet2DSummary(
        cpdir=str(cpdir), device="cpu", dataset_name_func=lambda n: n,
        series_summary_func=S.__getitem__, mask_summary_func=M.__getitem__,
        net_func=functools.partial(tunet2.UNet2DS, nfb=4), **kw), list(S)


def _wrapper1d(cpdir):
    traces, spikes = _traces()
    return tseg.UNet1DSegmentation(
        cpdir=str(cpdir), device="cpu", dataset_attrs_func=lambda n: {"name": n},
        dataset_traces_func=lambda n: traces,
        dataset_spikes_func=lambda n: spikes,
        net_func=functools.partial(tunet1.UNet1D, nfb=4)), ["t"]


FIT2D = dict(shape_trn=(32, 32), shape_val=(64, 64), batch_size_trn=4,
             nb_steps_trn=4, nb_epochs=2, seed=2, ema_decay=0.5)
FIT1D = dict(shape=(64,), batch=2, nb_epochs=2, seed=2)


def _ckpt_equal(a, b):
    ra, rb = tck.read_checkpoint(a), tck.read_checkpoint(b)
    for key in ("params", "state", "opt_state"):
        la = jax.tree_util.tree_leaves_with_path(ra[key])
        lb = jax.tree_util.tree_leaves_with_path(rb[key])
        assert [p for p, _ in la] == [p for p, _ in lb], key
        for (path, u), (_, v) in zip(la, lb):
            np.testing.assert_array_equal(u, v, err_msg=f"{key}{path}")


@pytest.mark.parametrize("wrapper", ["2d", "1d"])
def test_fit_k2_is_bitwise_k1(wrapper, tmp_path):
    """Both fits at K=2 against K=1, with dropout (and the 2-D fit's EMA):
    the same per-epoch metrics and the same best checkpoint, bit for bit.
    The 2-D checkpoint loads in the JAX package."""
    outs = []
    for k in (1, 2):
        if wrapper == "2d":
            model, names = _wrapper2d(tmp_path / f"k{k}")
            hist, best = model.fit(names, steps_per_dispatch=k, **FIT2D)
            hist = {n: v for n, v in hist.items() if n != "epoch_seconds"}
            outs.append((hist, best))
        else:
            model, names = _wrapper1d(tmp_path / f"k{k}")
            mt, mv, best = model.fit(names, steps_per_dispatch=k, **FIT1D)
            outs.append(((mt, mv), best))
    (ha, ba), (hb, bb) = outs
    assert ha == hb
    assert os.path.basename(ba).split("_", 1)[1] == \
        os.path.basename(bb).split("_", 1)[1]
    _ckpt_equal(ba, bb)
    if wrapper == "2d":
        like, state_like = junet2.init(jax.random.PRNGKey(0), nfb=4)
        _, _, opt, meta = jck.load_checkpoint(
            bb, like, state_like, jtrainer.make_optimizer(2e-3).init(like))
        assert int(opt.count) == FIT2D["nb_steps_trn"] * (int(meta["epoch"]) + 1)


class _Stop(Exception):
    pass


def _record_k(monkeypatch, trainer_module, seen):
    """Make both step factories record K and stop the fit there."""

    def multi(*a, **kw):
        seen.append(int(a[3]))
        raise _Stop

    def single(*a, **kw):
        seen.append(1)
        raise _Stop

    monkeypatch.setattr(trainer_module, "make_multi_step", multi)
    monkeypatch.setattr(trainer_module, "make_train_step", single)


@pytest.mark.parametrize("steps,k", [(8, 4), (6, 2), (5, 1)])
def test_perf_preset_picks_the_jax_k(steps, k, tmp_path, monkeypatch):
    S, M = _summaries()
    kw = dict(shape_trn=(32, 32), shape_val=(64, 64), batch_size_trn=4,
              nb_steps_trn=steps, nb_epochs=1, preset="perf")
    jseen, tseen = [], []
    _record_k(monkeypatch, jtrainer, jseen)
    _record_k(monkeypatch, T, tseen)
    jmodel = jsummary.UNet2DSummary(
        cpdir=str(tmp_path / "j"), dataset_name_func=lambda n: n,
        series_summary_func=S.__getitem__, mask_summary_func=M.__getitem__,
        net_init_func=functools.partial(junet2.init, nfb=2),
        net_apply_func=functools.partial(junet2.apply, drp=0.0))
    for model in (jmodel, _wrapper2d(tmp_path / "t")[0]):
        with pytest.raises(_Stop):
            model.fit(list(S), fast_train=False, **kw)
    assert jseen == tseen == [k]


def test_perf_preset_picks_the_jax_k_per_split(tmp_path, monkeypatch, caplog):
    """Cross-validation over 3 folds of 10 traces: 6, 7 and 7 training
    traces at batch 2 are 3, 4 and 4 steps, so K is 1, 4 and 4."""
    traces, spikes = _traces()
    seen = {"j": [], "t": []}

    for tag, mod, tmod in (("j", jseg, jtrainer), ("t", tseg, T)):
        _record_k(monkeypatch, tmod, seen[tag])
        single = mod.UNet1DSegmentation._fit_single

        def fit_single(self, *a, _single=single, **kw):
            try:
                return _single(self, *a, **kw)
            except _Stop:
                zero = {m: 0.0 for m in tlosses.SPIKE_METRICS}
                return zero, dict(zero), None

        monkeypatch.setattr(mod.UNet1DSegmentation, "_fit_single", fit_single)
    jmodel = jseg.UNet1DSegmentation(
        cpdir=str(tmp_path / "j"), dataset_attrs_func=lambda n: {"name": n},
        dataset_traces_func=lambda n: traces,
        dataset_spikes_func=lambda n: spikes,
        net_init_func=functools.partial(junet1.init, nfb=2),
        net_apply_func=functools.partial(junet1.apply, drp=0.0))
    tmodel, names = _wrapper1d(tmp_path / "t")
    kw = dict(shape=(64,), batch=2, nb_epochs=1, val_type="cross_validate",
              nb_folds=3, preset="perf")
    jmodel.fit(names, **kw)
    with caplog.at_level(logging.INFO, logger=tseg.__name__):
        tmodel.fit(names, **kw)
    assert seen["j"] == seen["t"] == [1, 4, 4]
    assert "no counterpart" in caplog.text


@pytest.mark.parametrize("wrapper", ["2d", "1d"])
def test_steps_per_dispatch_must_divide_the_steps(wrapper, tmp_path):
    """Before any dataset is read for the 2-D fit, after the split for the
    spikes (as in the JAX package)."""
    if wrapper == "2d":
        model, names = _wrapper2d(tmp_path)
        with pytest.raises(ValueError, match="divide nb_steps_trn=4"):
            model.fit(["/nonexistent"], steps_per_dispatch=3,
                      **dict(FIT2D, nb_epochs=1))
    else:
        model, names = _wrapper1d(tmp_path)
        with pytest.raises(ValueError, match=r"count ceil\(n_train_traces/batch\)=4"):
            model.fit(names, steps_per_dispatch=3, **FIT1D)
