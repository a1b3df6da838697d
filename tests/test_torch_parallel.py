"""The port's multi-device paths on the CPU: two gloo ranks against one
process and against the JAX package, and one-rank meshes in process.

A module-scoped fixture starts ``python -m deepcalcium_torch.parallel.dryrun``
once with 2 ranks (1 thread each); every case reads the ranks' files. The
run is skipped only if the group never forms (port binding depends on the
environment); a rank that dies or hangs after ``MESH_OK`` fails.

Tolerances, against ``dryrun_multichip(None)`` in this process (float32, the
same inputs from ``make_inputs``) unless said otherwise:
- the two ranks' files are equal bit for bit;
- train-step loss and metrics: rtol 2e-5 (the JAX two-process test's), also
  against the JAX package's step from the same weights;
- gradients: 1e-5 of the net's largest gradient entry. The shards' sums are
  taken in another order, and the conv biases that feed a BN have a
  gradient that is zero up to rounding, so a relative tolerance per entry
  means nothing there. A combine that is off by ``mesh.size`` is off by the
  whole gradient;
- BN buffers rtol 1e-5 and atol 1e-7; weights after one Adam step (eps 1e-4)
  atol 1e-5: Adam divides a rounding-size gradient by eps;
- the sharded summary: int16 and uint16 equal to ``movie_summary`` bit for
  bit at every split; float32 within 1 ulp; all within 1 ulp of the JAX
  package's ``movie_summary_sharded`` on its 8-device CPU mesh where the
  mesh divides T, and within 2 ulp on its ragged path (which combines a
  head mean and a tail mean in float32);
- sharded evaluation: probabilities atol 1e-5 (a rank's batch is another
  size than one process's, and the CPU conv may then sum in another order);
  masks equal wherever the one-process probability lies 1e-5 or more from
  the threshold.
A mesh of one rank gives the bits of no mesh, everywhere.
"""

import functools
import logging
import os

import jax
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from deepcalcium_tpu.models import unet1d as junet1
from deepcalcium_tpu.models import unet2d as junet2
from deepcalcium_tpu.ops import losses as JL
from deepcalcium_tpu.ops import summary as jsummary
from deepcalcium_tpu.parallel import mesh as jmesh
from deepcalcium_tpu.train import trainer as jtrainer
from deepcalcium_torch.data.fixtures import make_neurons_hdf5, make_spikes_hdf5
from deepcalcium_torch.models import movie_segmentation as tseg
from deepcalcium_torch.models import unet1d as tunet1
from deepcalcium_torch.models import unet2d as tunet2
from deepcalcium_torch.models.unet_1d_segmentation import UNet1DSegmentation
from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary
from deepcalcium_torch.ops import losses as TL
from deepcalcium_torch.ops.summary import movie_summary, movie_summary_sharded
from deepcalcium_torch.parallel import distributed as tdist
from deepcalcium_torch.parallel import dryrun
from deepcalcium_torch.parallel import mesh as tmesh
from deepcalcium_torch.train import trainer as T
from deepcalcium_torch.train.checkpoints import read_checkpoint
from deepcalcium_torch.train.evaluate import _run_batched
from deepcalcium_torch.train.sampler import make_put_fn

torch.set_num_threads(1)

BAND = 1e-5
NETS = {"u2d": 0, "u1d": 1}
SUMMARY = {case: (key, t) for case, key, t in dryrun.SUMMARY_CASES}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' output files as dicts."""
    files, runs = dryrun.spawn(2, "cpu", str(tmp_path_factory.mktemp("ranks")),
                               timeout=240)
    if any(rc != 0 for rc, _, _ in runs):
        msgs = "\n".join(se[-2000:] for _, _, se in runs)
        if not all("MESH_OK" in so for _, so, _ in runs):
            pytest.skip(f"the process group did not form here:\n{msgs[-500:]}")
        raise AssertionError(f"a rank failed after the group had formed "
                             f"(codes {[rc for rc, _, _ in runs]}):\n{msgs}")
    out = []
    for f in files:
        with np.load(f) as z:
            out.append({k: z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    return dryrun.dryrun_multichip(
        None, workdir=str(tmp_path_factory.mktemp("single")))


@pytest.fixture(scope="module")
def inputs():
    return dryrun.make_inputs()


@pytest.fixture
def mesh1(monkeypatch):
    """A gloo group of one rank in this process, left at the end."""
    assert not dist.is_initialized()
    tdist.initialize(f"127.0.0.1:{tdist._free_port()}", 1, 0, backend="gloo")
    yield tdist.pod_mesh()
    tdist.shutdown()
    assert not dist.is_initialized()


def _keys(d, prefix):
    return sorted(k for k in d if k.startswith(prefix))


# --- Two ranks against one process -------------------------------------------

def test_both_ranks_are_bitwise_alike(ranks, single):
    r0, r1 = ranks
    assert sorted(r0) == sorted(r1)
    assert set(single) | {"segment.slab_refused"} == set(r0)
    assert sum(k.startswith("fit") for k in r0) == 9
    assert int(r0["world"]) == 2
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("net", list(NETS))
def test_train_step_loss_and_metrics_match_one_process(ranks, single, net):
    keys = _keys(single, f"{net}.metric.")
    assert f"{net}.metric.loss" in keys and len(keys) >= 6
    for k in keys:
        np.testing.assert_allclose(ranks[0][k], single[k], rtol=2e-5,
                                   atol=2e-5, err_msg=k)
    if net == "u2d":  # the step fed through global_batch_from_local
        np.testing.assert_allclose(ranks[0]["u2d.loss_local_feed"],
                                   single["u2d.loss_local_feed"], rtol=2e-5)
        assert (single["u2d.loss_local_feed"] != single["u2d.metric.loss"])


@pytest.mark.parametrize("net", list(NETS))
def test_train_step_gradients_match_one_process(ranks, single, net):
    """``.grad`` itself: Adam would hide a factor of ``mesh.size``."""
    keys = _keys(single, f"{net}.grad.")
    scale = max(np.abs(single[k]).max() for k in keys)
    for k in keys:
        np.testing.assert_allclose(ranks[0][k], single[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    got = np.sqrt(sum((ranks[0][k].astype(np.float64) ** 2).sum() for k in keys))
    want = np.sqrt(sum((single[k].astype(np.float64) ** 2).sum() for k in keys))
    assert got / want == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("net", list(NETS))
def test_train_step_buffers_and_weights_match_one_process(ranks, single, net):
    bufs, params = _keys(single, f"{net}.buf."), _keys(single, f"{net}.param.")
    assert bufs and params
    fresh = dict(dryrun.tiny_nets()[NETS[net]].named_buffers())
    moved = 0
    for k in bufs:
        np.testing.assert_allclose(ranks[0][k], single[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        moved += not np.array_equal(
            single[k], fresh[k.split(".buf.")[1]].numpy())
    assert moved == len(bufs)  # the step did update the running statistics
    for k in params:
        np.testing.assert_allclose(ranks[0][k], single[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def _jax_step_metrics(net, inputs):
    """One step of the JAX package from the dry run's weights and batch."""
    tnet = dryrun.tiny_nets()[NETS[net]]
    if net == "u2d":
        params, state = tunet2.to_jax_params(tnet)
        apply_fn = functools.partial(junet2.apply, drp=0.0)
        loss_fn, metric_fns = JL.LOSSES["binary_crossentropy"], None
        x, y = inputs["x2"], inputs["y2"]
    else:
        params, state = tunet1.to_jax_params(tnet)
        apply_fn = functools.partial(junet1.apply, margin=4, drp=0.0)
        loss_fn = functools.partial(JL.weighted_binary_crossentropy,
                                    weightpos=2.0)
        metric_fns = dict(JL.SPIKE_METRICS)
        x, y = inputs["x1"], inputs["y1"]
    optimizer = optax.adam(2e-3, eps=1e-4)
    step = jtrainer.make_train_step(apply_fn, loss_fn, optimizer, metric_fns)
    params, state = jax.tree.map(np.array, (params, state))
    _, _, _, met = step(params, state, optimizer.init(params), x, y,
                        jax.random.PRNGKey(1))
    return {k: float(v) for k, v in met.items()}


@pytest.mark.parametrize("part", ["loss", "param", "buf", "grad"])
def test_multi_step_on_two_ranks(ranks, single, part):
    """Two UNet2DS steps in one meshed ``make_multi_step`` call: on each rank
    bit for bit the same two steps through ``make_train_step(mesh=)``, and
    within the one-step tolerances of one process (the weights after two
    Adam steps at eps 1e-4: atol 2e-5; the last step's gradients 1e-5 of
    the largest)."""
    keys = _keys(single, f"k2.multi.{part}")
    assert keys
    for r in (*ranks, single):
        for k in keys:
            np.testing.assert_array_equal(r[k], r[k.replace(".multi.", ".steps.")],
                                          err_msg=k)
    scale = max(np.abs(single[k]).max() for k in keys)
    for k in keys:
        if part == "loss":
            np.testing.assert_allclose(ranks[0][k], single[k], rtol=2e-5)
        elif part == "buf":
            np.testing.assert_allclose(ranks[0][k], single[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        else:
            atol = 2e-5 if part == "param" else 1e-5 * scale
            np.testing.assert_allclose(ranks[0][k], single[k], rtol=0,
                                       atol=atol, err_msg=k)


@pytest.mark.parametrize("net", list(NETS))
def test_train_step_loss_matches_jax(ranks, inputs, net):
    met = _jax_step_metrics(net, inputs)
    np.testing.assert_allclose(ranks[0][f"{net}.metric.loss"], met["loss"],
                               rtol=2e-5, atol=2e-5)
    for k in ("ytspks",) if net == "u1d" else ("posyt", "dicesq"):
        np.testing.assert_allclose(ranks[0][f"{net}.metric.{k}"], met[k],
                                   rtol=2e-5, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("name", ["jacc", "dice", "dicesq"])
def test_nonlinear_losses_are_global(ranks, single, inputs, name):
    """Equal to one process, and not the mean of the ranks' own losses."""
    np.testing.assert_allclose(ranks[0][f"loss.{name}"],
                               single[f"loss.{name}"], rtol=1e-6)
    g = single[f"loss.{name}.grad"]
    np.testing.assert_allclose(ranks[0][f"loss.{name}.grad"], g, rtol=1e-5,
                               atol=1e-6 * np.abs(g).max())
    fn = getattr(TL, f"{name}_loss")
    yt, yp = torch.from_numpy(inputs["yl"]), torch.from_numpy(inputs["yp"])
    halves = np.mean([float(fn(yt[i:i + 4], yp[i:i + 4])) for i in (0, 4)])
    assert abs(halves - float(single[f"loss.{name}"])) > 1e-3


@pytest.mark.parametrize("case", list(SUMMARY))
def test_sharded_summary_matches_the_plain_summary(ranks, inputs, case):
    key, t = SUMMARY[case]
    mean, mx = movie_summary(torch.from_numpy(inputs[key][:t]))
    got_mean, got_max = ranks[0][f"summary.{case}.mean"], ranks[0][f"summary.{case}.max"]
    assert got_mean.dtype == got_max.dtype == np.float32
    np.testing.assert_array_equal(got_max, mx.to(torch.float32).numpy())
    if key == "movie_f32":
        np.testing.assert_array_max_ulp(got_mean, mean.numpy(), maxulp=1)
    else:
        np.testing.assert_array_equal(got_mean, mean.numpy())


@pytest.mark.parametrize("case", list(SUMMARY))
def test_sharded_summary_matches_jax_sharded(ranks, inputs, case):
    key, t = SUMMARY[case]
    mesh = jmesh.get_mesh()
    assert mesh.devices.size == 8
    jmean, jmax = jsummary.movie_summary_sharded(inputs[key][:t], mesh, chunk=2)
    ragged = 8 < t and t % 8
    np.testing.assert_array_max_ulp(ranks[0][f"summary.{case}.mean"],
                                    np.asarray(jmean, np.float32),
                                    maxulp=2 if ragged else 1)
    np.testing.assert_array_equal(ranks[0][f"summary.{case}.max"],
                                  np.asarray(jmax, np.float32))


@pytest.mark.parametrize("key", ["run_batched", "tta.0", "tta.1",
                                 "evaluator.prob", "evaluator.mean"])
def test_sharded_evaluation_matches_unsharded(ranks, single, key):
    assert ranks[0][key].shape == single[key].shape
    np.testing.assert_allclose(ranks[0][key], single[key], rtol=0, atol=BAND)
    if key == "evaluator.prob":
        differ = ranks[0]["evaluator.mask"] != single["evaluator.mask"]
        assert not (differ & (np.abs(single[key] - 0.5) >= BAND)).any()
        assert set(np.unique(single["evaluator.mask"])) == {0, 1}
    if key == "evaluator.mean":  # the sharded summary inside the evaluator
        np.testing.assert_array_equal(ranks[0][key], single[key])


def test_sharded_segment_movie_matches_unsharded(ranks, single, inputs):
    """Slab 4 split 2 + 2, then a slab of one frame padded to two."""
    net = dryrun.tiny_nets()[0].eval()
    params, state = tunet2.to_jax_params(net)
    probs = []

    def recording(x):
        probs.append(net(x))
        return probs[-1]

    movie = inputs["movie_i16"][:5]
    want = tseg.segment_movie(params, state, movie, slab=4, apply_fn=recording,
                              device="cpu")
    np.testing.assert_array_equal(want, single["segment"])
    got = ranks[0]["segment"]
    assert got.shape == want.shape == (5, 32, 32) and got.dtype == np.uint8
    far = np.abs(torch.cat(probs).numpy() - 0.5) >= BAND
    assert not ((got != want) & far).any()
    assert 0.02 < want.mean() < 0.98
    # slab % mesh.size != 0 was refused on both ranks, before any work.
    assert int(ranks[0]["segment.slab_refused"]) == 1
    assert int(ranks[1]["segment.slab_refused"]) == 1


@pytest.mark.parametrize("net", ["fit2d", "fit1d"])
def test_wrapper_fit_on_two_ranks(ranks, single, net):
    """Rank 0 alone writes; both ranks return the same checkpoint name and
    see the file; the train metrics are one process's. (The validation
    numbers turn on thresholded pixels of a barely trained net, and Adam at
    eps 1e-8 walks the conv biases that feed a BN by rounding: they are
    held to be equal across the ranks, not to one process.)"""
    r0, r1 = ranks
    assert str(r0[f"{net}.best"]) == str(r1[f"{net}.best"])
    assert int(r0[f"{net}.best_exists"]) == int(r1[f"{net}.best_exists"]) == 1
    if net == "fit2d":
        assert r0["fit2d.loss"].shape == (2,)
        np.testing.assert_allclose(r0["fit2d.loss"], single["fit2d.loss"],
                                   rtol=1e-4)
        assert np.isfinite(r0["fit2d.val"]).all()
    else:
        np.testing.assert_allclose(r0["fit1d.trn_ytspks"],
                                   single["fit1d.trn_ytspks"], rtol=1e-6)
        assert r0["fit1d.predict"].shape == single["fit1d.predict"].shape
        assert np.isfinite(r0["fit1d.val_F2"])


# --- In this process ---------------------------------------------------------

@pytest.mark.parametrize("shape,multiple", [((5, 3, 2), 4), ((8, 2), 4),
                                            ((1,), 8), ((7, 1, 1, 2), 2)])
def test_pad_batch_to_equals_jax(shape, multiple):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got, n = tmesh.pad_batch_to(x, multiple)
    want, jn = jmesh.pad_batch_to(x, multiple)
    assert n == jn == shape[0] and got.shape[0] % multiple == 0
    np.testing.assert_array_equal(got, want)


def test_initialize_with_nothing_configured_warns(monkeypatch, caplog):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.get_mesh()
    with caplog.at_level(logging.WARNING):
        tdist.initialize(backend="gloo")
    try:
        assert any("group of ONE rank" in r.getMessage() and
                   r.levelno == logging.WARNING for r in caplog.records)
        mesh = tdist.pod_mesh()
        assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))
        tdist.initialize(backend="gloo")  # a group exists: returns
        with pytest.raises(ValueError, match="go together"):
            tdist.initialize("127.0.0.1:1", backend="gloo")
    finally:
        tdist.shutdown()
    assert not dist.is_initialized()


def test_mesh_helpers(mesh1):
    assert tmesh.get_mesh(1).size == 1 and "size=1" in repr(mesh1)
    with pytest.raises(ValueError, match="n_devices"):
        tmesh.get_mesh(2)
    x = np.arange(12).reshape(4, 3)
    fake = type("Two", (), {"size": 2, "rank": 1})()
    got = tmesh.shard_batch(fake, {"x": x, "s": np.float32(3), "t": (x[:2],)})
    np.testing.assert_array_equal(got["x"], x[2:])
    np.testing.assert_array_equal(got["t"][0], x[1:2])
    assert got["s"] == 3  # a 0-d leaf is kept whole
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(fake, x[:3])
    xl, = tdist.global_batch_from_local(mesh1, (x,))
    assert isinstance(xl, tmesh.LocalShard)
    assert type(tmesh.local_shard(fake, xl)) is torch.Tensor
    assert tmesh.local_shard(fake, xl).shape[0] == 4  # not sliced again
    assert tmesh.local_shard(fake, torch.from_numpy(x)).shape[0] == 2
    put = make_put_fn("cpu", mesh1)((x.astype(np.float32),))
    assert isinstance(put[0], tmesh.LocalShard) and put[0].shape == (4, 3)
    g = tmesh.all_gather(torch.from_numpy(x), mesh1)
    np.testing.assert_array_equal(g.numpy(), x)
    assert tmesh.agree(mesh1, 41) == 41
    assert tmesh.check_mesh(None) is None and tmesh.check_mesh(mesh1) is mesh1


def test_a_mesh_of_one_rank_is_bitwise_no_mesh(mesh1, single):
    """Every path of the dry run, the global-BN and global-loss code
    included: the combines of one rank change no bit."""
    got = dryrun.dryrun_multichip(mesh1)
    assert sorted(got) == sorted(k for k in single if not k.startswith("fit"))
    for k in got:
        np.testing.assert_array_equal(got[k], single[k], err_msg=k)


def test_one_rank_sharded_summary_is_the_plain_one(mesh1, inputs):
    for key in ("movie_i16", "movie_u16", "movie_f32"):
        movie = torch.from_numpy(inputs[key])
        mean, mx = movie_summary_sharded(movie, mesh1, chunk=5)
        wmean, wmax = movie_summary(movie)
        np.testing.assert_array_equal(mean.numpy(), wmean.numpy())
        np.testing.assert_array_equal(mx.numpy(), wmax.to(torch.float32).numpy())
    with pytest.raises(TypeError, match="Mesh"):
        movie_summary_sharded(movie, None)
    with pytest.raises(ValueError, match="non-empty"):
        movie_summary_sharded(movie[:0], mesh1)


def test_user_loss_without_mesh_argument_is_per_sample(mesh1):
    plain = lambda yt, yp: (yt - yp) ** 2
    assert TL.with_mesh(plain, mesh1) is plain
    assert TL.with_mesh(TL.dice_loss, None) is TL.dice_loss
    bound = TL.with_mesh(functools.partial(TL.F2, beta=1.0), mesh1)
    assert bound.keywords == {"beta": 1.0, "mesh": mesh1}
    assert TL.with_mesh(TL.SPIKE_METRICS["ytspks"], mesh1) is TL.SPIKE_METRICS["ytspks"]


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_unet2dsummary_fit_with_a_one_rank_mesh_writes_the_same_weights(
        mesh1, tmp_path, monkeypatch):
    paths = [make_neurons_hdf5(str(tmp_path / f"ds{i}" / "dataset.hdf5"),
                               name=f"synthetic.00.0{i}", shape=(64, 64),
                               nb_frames=16, nb_neurons=6, seed=i)
             for i in range(2)]
    import deepcalcium_torch.models.unet_2d_summary as mod

    monkeypatch.setattr(mod, "plot_metrics_grid", lambda *a, **k: None)
    kw = dict(shape_trn=(32, 32), shape_val=(64, 64), batch_size_trn=4,
              nb_steps_trn=3, nb_epochs=2, seed=5)
    best = {}
    for name, mesh in (("plain", None), ("mesh", mesh1)):
        model = UNet2DSummary(cpdir=str(tmp_path / name), device="cpu",
                              net_func=functools.partial(tunet2.UNet2DS, nfb=4))
        hist, best[name] = model.fit(paths, mesh=mesh, **kw)
        assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    a, b = (read_checkpoint(best[k]) for k in ("plain", "mesh"))
    assert (os.path.basename(best["plain"]).split("_", 1)[1]
            == os.path.basename(best["mesh"]).split("_", 1)[1])
    for part in ("params", "state", "opt_state"):
        _tree_equal(a[part], b[part], part)
    for k in a["meta"]:
        if k != "epoch_seconds":
            assert a["meta"][k] == b["meta"][k], k
    with pytest.raises(ValueError, match="mesh size"):
        fake = tmesh.Mesh()
        fake.size = 3
        model.fit(["/nonexistent.hdf5"], mesh=fake, **kw)


def test_unet1dsegmentation_fit_with_a_one_rank_mesh_writes_the_same_bytes(
        mesh1, tmp_path, monkeypatch):
    import deepcalcium_torch.models.unet_1d_segmentation as mod
    import deepcalcium_torch.utils.visualization as vis

    monkeypatch.setattr(mod, "plot_metrics_grid", lambda *a, **k: None)
    monkeypatch.setattr(vis, "plot_traces_spikes", lambda *a, **k: None)
    path = make_spikes_hdf5(str(tmp_path / "spikes.hdf5"), nb_traces=12,
                            trace_len=300, seed=1)
    kw = dict(shape=(64,), batch=4, nb_epochs=2, seed=3)
    out = {}
    for name, mesh in (("plain", None), ("mesh", mesh1)):
        model = UNet1DSegmentation(
            cpdir=str(tmp_path / name), device="cpu",
            net_func=functools.partial(tunet1.UNet1D, nfb=4))
        out[name] = model.fit([path], mesh=mesh, **kw)
    (mt, mv, best), (mt1, mv1, best1) = out["plain"], out["mesh"]
    assert mt == mt1 and mv == mv1
    with open(best, "rb") as fa, open(best1, "rb") as fb:
        assert fa.read() == fb.read()
    pred, names = model.predict([path], best1, batch=5, mesh=mesh1)
    want, _ = model.predict([path], best1, batch=5)
    np.testing.assert_array_equal(pred[0], want[0])


@pytest.mark.parametrize("wrapper", ["2d", "1d"])
def test_fit_of_k_steps_a_call_with_a_one_rank_mesh_is_k1_without(
        mesh1, tmp_path, monkeypatch, wrapper):
    """Both fits at 3 steps a call over a one-rank mesh (their slabs fed as
    this rank's rows, ``make_put_fn(device, mesh, 3)``), dropout on, write
    the bytes of the K=1 fit without a mesh."""
    import deepcalcium_torch.models.unet_1d_segmentation as seg
    import deepcalcium_torch.models.unet_2d_summary as summ
    import deepcalcium_torch.utils.visualization as vis

    for mod in (seg, summ):
        monkeypatch.setattr(mod, "plot_metrics_grid", lambda *a, **k: None)
    monkeypatch.setattr(vis, "plot_traces_spikes", lambda *a, **k: None)
    best = {}
    for name, mesh, k in (("plain", None, 1), ("mesh", mesh1, 3)):
        cpdir = str(tmp_path / name)
        if wrapper == "2d":
            paths = [make_neurons_hdf5(str(tmp_path / f"ds{i}" / "dataset.hdf5"),
                                       name=f"synthetic.00.0{i}", shape=(64, 64),
                                       nb_frames=16, nb_neurons=6, seed=i)
                     for i in range(2)]
            model = UNet2DSummary(cpdir=cpdir, device="cpu",
                                  net_func=functools.partial(tunet2.UNet2DS, nfb=4))
            _, best[name] = model.fit(paths, mesh=mesh, steps_per_dispatch=k,
                                      shape_trn=(32, 32), shape_val=(64, 64),
                                      batch_size_trn=4, nb_steps_trn=3,
                                      nb_epochs=2, seed=5, ema_decay=0.5)
        else:
            path = make_spikes_hdf5(str(tmp_path / "spikes.hdf5"), nb_traces=12,
                                    trace_len=300, seed=1)
            model = UNet1DSegmentation(
                cpdir=cpdir, device="cpu",
                net_func=functools.partial(tunet1.UNet1D, nfb=4))
            _, _, best[name] = model.fit([path], mesh=mesh, steps_per_dispatch=k,
                                         shape=(64,), batch=4, nb_epochs=2,
                                         seed=3)
    a, b = (read_checkpoint(best[k]) for k in ("plain", "mesh"))
    for part in ("params", "state", "opt_state"):
        _tree_equal(a[part], b[part], part)


def test_run_batched_pads_each_slab_to_the_mesh(mesh1):
    """On one rank no pad is needed; a mesh of two would pad 3 to 4: the
    split is checked through a stand-in all-gather."""
    seen = []

    def fwd(x):
        seen.append(tuple(x.shape))
        return x * 2

    batch = torch.arange(5 * 4, dtype=torch.float32).reshape(5, 2, 2)
    out = _run_batched(fwd, batch, max_batch=3, mesh=mesh1)
    np.testing.assert_array_equal(out.numpy(), batch.numpy() * 2)
    assert seen == [(3, 2, 2), (2, 2, 2)]
    with pytest.raises(TypeError, match="Mesh"):
        _run_batched(fwd, batch, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        T.make_train_step(None, None, None, mesh="gloo")
    with pytest.raises(TypeError, match="Mesh"):
        T.make_eval_forward(None, mesh=0)
