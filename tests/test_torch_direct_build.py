"""The inference builds straight off (params, state), ``unet2d.inference_net``
and ``unet1d.inference_net`` (and ``from_jax_params``, their unfolded form),
against the route they replace: a drawn net, ``load_jax_params_``, ``.to``,
``.eval()`` and ``.fold()``. On the CPU at nfb=4.

Every parameter and buffer must be bitwise the old route's, and so must a
forward; the wrappers must take the direct route for the stock nets only
(one ``net.pack`` span a build), read the caller's arrays on every call
without changing them, and draw no weight."""

import functools
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepcalcium_torch.models import blocks, netweights, unet1d, unet2d
from deepcalcium_torch.models.movie_segmentation import segment_movie
from deepcalcium_torch.models.unet_1d_segmentation import UNet1DSegmentation
from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary
from deepcalcium_torch.train.checkpoints import save_checkpoint
from deepcalcium_torch.utils import profiling

torch.set_num_threads(1)


def _randomised(params, state, seed):
    """Copies of (params, state) with every BN and bias made non-trivial,
    so that the folds move every weight."""
    rng = np.random.default_rng(seed)
    params = {k: dict(v) for k, v in params.items()}
    state = {k: dict(v) for k, v in state.items()}
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


def _net2d(up_mode="transpose", seed=1, nfb=4):
    return _randomised(*unet2d.to_jax_params(unet2d.UNet2DS(
        nfb, up_mode, generator=torch.Generator().manual_seed(seed))), seed)


def _net1d(seed=1, nfb=4):
    return _randomised(*unet1d.to_jax_params(unet1d.UNet1D(
        nfb, generator=torch.Generator().manual_seed(seed))), seed)


def _as(leaves, tree):
    if leaves == "numpy":
        return tree
    return {k: {leaf: torch.from_numpy(np.array(a)) for leaf, a in v.items()}
            for k, v in tree.items()}


def _attrs(net):
    return {k: v for k, v in vars(net).items() if not k.startswith("_")}


def _assert_same_net(new, old):
    """Bitwise the same parameters and buffers, under the same names, in
    the same layouts, with the same module attributes."""
    assert type(new) is type(old)
    assert _attrs(new) == _attrs(old)
    for (na, ma), (nb, mb) in zip(new.named_modules(), old.named_modules(),
                                  strict=True):
        assert na == nb and type(ma) is type(mb)
        assert _attrs(ma) == _attrs(mb), na
    a = dict(new.named_parameters())
    b = dict(old.named_parameters())
    assert list(a) == list(b)
    for k in a:
        assert a[k].requires_grad == b[k].requires_grad, k
    sa, sb = new.state_dict(), old.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype == torch.float32, k
        assert sa[k].is_contiguous() and sb[k].is_contiguous(), k
        assert torch.equal(sa[k], sb[k]), k


DTYPES = {"f32": None, "bf16": torch.bfloat16}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("leaves", ["numpy", "tensor"])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("up_mode", ["transpose", "upsampling"])
def test_unet2d_direct_build_is_bitwise_the_old_route(up_mode, fold, leaves,
                                                      dtype):
    params, state = _net2d(up_mode)
    cdt = DTYPES[dtype]
    old = unet2d.load_jax_params_(unet2d.UNet2DS(4, up_mode, cdt), params,
                                  state).to("cpu").eval()
    old = old.fold() if fold else old
    new = unet2d.inference_net(_as(leaves, params), _as(leaves, state), cdt,
                               "cpu", fold=fold)
    assert new.folded == fold and not new.training
    _assert_same_net(new, old)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 32, 48)).astype(np.float32))
    assert torch.equal(new(x), old(x))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("leaves", ["numpy", "tensor"])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("margin", [4, 0])
def test_unet1d_direct_build_is_bitwise_the_old_route(margin, fold, leaves,
                                                      dtype):
    params, state = _net1d()
    cdt = DTYPES[dtype]
    old = unet1d.load_jax_params_(
        unet1d.UNet1D(4, margin=margin, compute_dtype=cdt), params,
        state).to("cpu").eval()
    old = old.fold() if fold else old
    new = unet1d.inference_net(_as(leaves, params), _as(leaves, state), cdt,
                               "cpu", fold=fold, margin=margin)
    assert new.folded == fold and not new.training
    _assert_same_net(new, old)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 96)).astype(np.float32))
    assert torch.equal(new(x), old(x))


@pytest.mark.parametrize("net", ["unet2d", "unet1d"])
def test_from_jax_params_is_bitwise_the_drawn_net(net):
    """The unfolded form, with the constructor's keywords, trains as the
    drawn net does: one step of SGD gives the same weights."""
    if net == "unet2d":
        params, state = _net2d()
        old = unet2d.load_jax_params_(unet2d.UNet2DS(4, drp=0.0), params,
                                      state)
        new = unet2d.from_jax_params(params, state, drp=0.0)
        x = torch.ones(2, 32, 32)
    else:
        params, state = _net1d()
        old = unet1d.load_jax_params_(unet1d.UNet1D(4, margin=2, drp=0.0),
                                      params, state)
        new = unet1d.from_jax_params(params, state, drp=0.0, margin=2)
        x = torch.ones(2, 64)
    assert new.training
    _assert_same_net(new, old)
    for m in (new, old):
        opt = torch.optim.SGD(m.parameters(), lr=0.1)
        m(x, train=True).sum().backward()
        opt.step()
    _assert_same_net(new, old)


def test_a_leaf_of_another_shape_raises():
    params, state = _net2d()
    params["enc1a_conv"] = dict(params["enc1a_conv"],
                                kernel=np.zeros((3, 3, 4, 4), np.float32))
    with pytest.raises(ValueError, match="enc1a_conv.kernel"):
        unet2d.inference_net(params, state)


def test_staging_buffer_is_reused_and_overwritten():
    """The host buffer grows for a larger net and is kept; a smaller net
    packed after it is still bitwise its own."""
    big = _net2d(nfb=8, seed=5)
    unet2d.inference_net(*big)
    stage = netweights._staging[False]
    params, state = _net2d(seed=6)
    new = unet2d.inference_net(params, state, fold=True)
    assert netweights._staging[False] is stage
    old = unet2d.load_jax_params_(unet2d.UNet2DS(4), params,
                                  state).eval().fold()
    _assert_same_net(new, old)


# --- no weights kept or drawn ------------------------------------------------

# module, class, (params, state) maker, a forward's input shape
NETS = {"unet2d": (unet2d, unet2d.UNet2DS, _net2d, (2, 32, 32)),
        "unet1d": (unet1d, unet1d.UNet1D, _net1d, (2, 1024))}


def _arrays(params, state):
    return [a for tree in (params, state) for v in tree.values()
            for a in v.values()]


@pytest.mark.parametrize("net", list(NETS))
def test_every_build_reads_the_callers_arrays(net):
    """Nothing is cached across calls: other params give another output,
    an array changed in place between calls changes the result, and the
    caller's arrays are left as they were."""
    mod, _, make, shape = NETS[net]
    x = torch.linspace(-1, 1, int(np.prod(shape))).reshape(shape)

    def forward(params, state):
        return mod.inference_net(params, state)(x)

    params, state = make(seed=1)
    before = [a.copy() for a in _arrays(params, state)]
    y1 = forward(params, state)
    assert not torch.equal(y1, forward(*make(seed=2)))
    for a, b in zip(_arrays(params, state), before, strict=True):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(forward(params, state), y1)
    params["enc0a_conv"]["kernel"] *= 2.0
    state["enc0a_bn"]["mean"] += 0.5
    assert not torch.equal(forward(params, state), y1)


def test_evaluate_movie_reads_new_params_every_call(tmp_path):
    movie = np.random.default_rng(0).integers(0, 900, (4, 32, 32)).astype(
        np.int16)
    model = UNet2DSummary(cpdir=str(tmp_path), device="cpu")
    params, state = _net2d(seed=1)
    kw = dict(window_shape=(32, 32), tta=False)
    p1 = model.evaluate_movie(movie, params=params, state=state, **kw)[1]
    p2 = model.evaluate_movie(movie, params=_net2d(seed=2)[0], state=state,
                              **kw)[1]
    assert not np.array_equal(p1, p2)
    params["head_conv"]["bias"][1] += np.float32(0.25)
    p3 = model.evaluate_movie(movie, params=params, state=state, **kw)[1]
    assert not np.array_equal(p1, p3)


@pytest.mark.parametrize("net", list(NETS))
def test_inference_builds_draw_nothing(net, monkeypatch):
    """With the truncated-normal draw that every kernel init goes through
    made to raise, the inference builds still succeed and a net made by
    its constructor still raises: the training draw is untouched."""
    mod, cls, make, _ = NETS[net]
    params, state = make()

    def no_draw(*a, **k):
        raise AssertionError("a weight was drawn")

    monkeypatch.setattr(blocks, "_truncated_normal_", no_draw)
    for fold in (False, True):
        mod.inference_net(params, state, fold=fold)
    mod.from_jax_params(params, state)
    with pytest.raises(AssertionError, match="drawn"):
        cls(4)


# --- the wrappers' route -------------------------------------------------------


class _Sub2D(unet2d.UNet2DS):
    pass


class _Sub1D(unet1d.UNet1D):
    pass


def _spans_of(call):
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    spans = profiling.recorded(t0, time.time_ns())
    by_id = {s.id: s for s in spans}
    return spans, by_id


@pytest.mark.parametrize("fast", ["auto", True])
@pytest.mark.parametrize("kind", ["stock", "partial", "subclass"])
def test_evaluate_movie_takes_the_direct_route_for_the_stock_net(
        tmp_path, kind, fast):
    net_func = {"stock": unet2d.UNet2DS,
                "partial": functools.partial(unet2d.UNet2DS, drp=0.0),
                "subclass": functools.partial(_Sub2D, nfb=4)}[kind]
    model = UNet2DSummary(cpdir=str(tmp_path), device="cpu",
                          net_func=net_func)
    params, state = _net2d()
    movie = np.random.default_rng(0).integers(0, 900, (3, 32, 32)).astype(
        np.int16)
    spans, by_id = _spans_of(lambda: [model.evaluate_movie(
        movie, params=params, state=state, window_shape=(32, 32),
        tta=False, fast=fast) for _ in range(2)])
    names = [s.name for s in spans]
    assert names.count("evaluate_movie.build") == 2
    folds = 2 if kind != "subclass" or fast is True else 0
    assert names.count("net.fold") == folds
    if kind == "subclass":
        assert "net.pack" not in names
        return
    for name in ("net.pack", "net.upload", "net.load", "net.init"):
        assert names.count(name) == 2, name
    for s in spans:
        if s.name.startswith("net."):
            assert by_id[s.parent].name == "evaluate_movie.build"


@pytest.mark.parametrize("fast", ["auto", True, False])
@pytest.mark.parametrize("kind", ["stock", "partial", "subclass"])
def test_spike_predict_takes_the_direct_route_for_the_stock_net(
        tmp_path, kind, fast):
    params, state = _net1d()
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, params, state)
    traces = {"a": np.random.default_rng(0).normal(size=(3, 80)).astype(
        np.float32)}
    net_func = {"stock": unet1d.UNet1D,
                "partial": functools.partial(unet1d.UNet1D, drp=0.0),
                "subclass": functools.partial(_Sub1D, nfb=4)}[kind]
    model = UNet1DSegmentation(
        cpdir=str(tmp_path), device="cpu", net_func=net_func,
        dataset_attrs_func=lambda n: {"name": n},
        dataset_traces_func=traces.__getitem__,
        dataset_spikes_func=lambda n: None)
    out = []
    spans, by_id = _spans_of(lambda: out.extend(
        model.predict(["a"], ckpt, batch=2, fast=fast)[0][0]
        for _ in range(2)))
    names = [s.name for s in spans]
    assert names.count("predict.build") == 2
    folds = 2 if fast is True or (fast == "auto" and kind != "subclass") else 0
    assert names.count("net.fold") == folds
    if kind == "subclass":
        assert "net.pack" not in names
    else:
        for name in ("net.pack", "net.upload", "net.load", "net.init"):
            assert names.count(name) == 2, name
        for s in spans:
            if s.name.startswith("net."):
                assert by_id[s.parent].name == "predict.build"
    old = unet1d.load_jax_params_(unet1d.UNet1D(4), params, state).eval()
    with torch.no_grad():
        prob = (old.fold() if folds else old)(torch.from_numpy(traces["a"]))
    sure = (prob - 0.5).abs().numpy() > 1e-4
    for got in out:
        np.testing.assert_array_equal(got[sure], (prob.numpy() > 0.5)[sure])


@pytest.mark.parametrize("up_mode", ["transpose", "upsampling"])
def test_segment_movie_takes_the_direct_route(up_mode):
    """``segment_movie`` builds the stock net through the same route: one
    ``net.pack`` a call, folded exactly for a transpose-mode checkpoint,
    and its masks those of the drawn net's per-frame forward."""
    params, state = _net2d(up_mode)
    movie = np.random.default_rng(0).integers(0, 900, (3, 32, 32)).astype(
        np.int16)
    out = []
    spans, _ = _spans_of(lambda: out.extend(segment_movie(
        params, state, movie, slab=2, compute_dtype=None, device="cpu")
        for _ in range(2)))
    names = [s.name for s in spans]
    for name in ("net.pack", "net.upload", "net.load", "net.init"):
        assert names.count(name) == 2, name
    assert names.count("net.fold") == (2 if up_mode == "transpose" else 0)
    old = unet2d.load_jax_params_(unet2d.UNet2DS(4, up_mode), params,
                                  state).eval()
    old = old.fold() if up_mode == "transpose" else old
    x = torch.from_numpy(movie.astype(np.float32))
    x = (x - x.mean(dim=(1, 2), keepdim=True)) / (
        x.std(dim=(1, 2), correction=0, keepdim=True) + 1e-6)
    with torch.no_grad():
        prob = old(x)
    sure = (prob - 0.5).abs().numpy() > 1e-4
    for got in out:
        np.testing.assert_array_equal(got[sure], (prob.numpy() > 0.5)[sure])
