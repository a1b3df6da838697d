"""Cellpose-SAM in the port (``models/cellpose_sam.py``,
``ops/attention.py``, ``ops/flows.py``, ``models/cellpose_summary.py``) on
the CPU at a small size: width 64, 4 blocks (two with 27-entry and two with
127-entry tables, re-sampled to the 8 x 8 grid's 15), 4 heads, a patch of
4 on 32 x 32 tiles, 64 x 64 frames, seeded random weights. The JAX package
has no such model: everything is held against the plain reference in
``cardbench/reference/`` (``cellpose_sam.py``, ``flows.py``), in float32.

Also the published sizes' pinned counts, the counter primitive, instance
labels in the Neurofinder metrics and submissions, and
``evaluate-movie --arch cellpose-sam``."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from cardbench.reference import cellpose_sam as ref
from cardbench.reference import flows as ref_flows
from deepcalcium_torch.models import cellpose_sam as cs
from deepcalcium_torch.models.cellpose_summary import (CellposeSummary,
                                                       normalize99, taper,
                                                       tile_starts)
from deepcalcium_torch.ops import attention as att
from deepcalcium_torch.ops import flows
from deepcalcium_torch.utils import profiling

torch.set_num_threads(2)

SMALL = {"width": 64, "depth": 4, "heads": 4, "mlp_dim": 256, "patch": 4,
         "tile": 32, "neck_dim": 32, "out_channels": 3, "global_blocks": [1, 3],
         "rel_pos_window": 27, "rel_pos_global": 127, "ln_eps": 1e-6}
CFG = cs.Config.from_dict(SMALL)


def _weights(seed=0, cfg=SMALL):
    """Published-layout float32 weights: kernels N(0, 1/fan_in), biases,
    tables and the positional table N(0, 0.02), LayerNorms 1 + N(0, 0.1)
    and N(0, 0.1)."""
    g = torch.Generator().manual_seed(seed)
    W = {}
    for k, s in ref.leaves(cfg):
        z = torch.randn(s, generator=g)
        if "norm" in k or k.startswith(("encoder.neck.1", "encoder.neck.3")):
            W[k] = z * 0.1 + (1.0 if k.endswith("weight") else 0.0)
        elif "rel_pos" in k or "pos_embed" in k or k.endswith("bias"):
            W[k] = z * 0.02
        else:
            W[k] = z / np.sqrt(np.prod(s[1:]))
    return W


def test_published_counts_are_pinned():
    """304,592,064 weights and 727.02 GFLOP a 256 x 256 tile, the same as
    the reference's yardstick counts."""
    pub = cs.Config()
    cfg = {**SMALL, **{f: getattr(pub, f) for f in SMALL}}
    assert cs.param_count() == ref.param_count(cfg) == 304_592_064
    assert cs.forward_flops() == ref.forward_flops(cfg) == 727_023_878_144
    assert cs.param_count(CFG) == ref.param_count(SMALL)
    assert cs.forward_flops(CFG) == ref.forward_flops(SMALL)
    assert [s for k, s in cs.leaf_shapes(pub) if "rel_pos_h" in k] == \
        [(127 if i in (5, 11, 17, 23) else 27, 64) for i in range(24)]


def test_net_matches_reference():
    """Tolerance 1e-5 of the output's largest value: float32 on both
    sides, but SDPA's fused softmax and ``F.layer_norm`` sum in other
    orders than the reference's materialised scores and written-out
    LayerNorm, through 4 blocks (the largest gap reads about 6e-7 of it)."""
    W = _weights()
    net = cs.inference_net(W, CFG, None, "cpu")
    x = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    want = torch.cat([ref.forward(W, x[i:i + 1], SMALL) for i in range(3)])
    got = net(x)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 32, 32)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # The bias matters at this size: leaving it out moves the output.
    nobias = torch.cat([ref.forward(W, x[i:i + 1], SMALL, bias=False)
                        for i in range(3)])
    assert (nobias - want).abs().max() > 1e-3 * want.abs().max()


@pytest.mark.parametrize("stored", [27, 127, 7])
def test_rel_pos_tables_resample_as_sam(stored):
    """A stored table re-sampled to 2 x 4 - 1 = 7 entries by linear
    interpolation (``align_corners=False``), or kept where it already has
    them, then indexed by i - k + 3."""
    t = torch.randn(stored, 5)
    got = att.rel_pos_index(att.resample_rel_pos(t, 4), 4)
    want = ref.rel_table(t, 4)
    assert torch.equal(got, want)
    if stored == 7:
        assert torch.equal(got[2, 0], t[5])


def test_attention_matches_an_explicit_bias():
    """Against B[(i, j), (k, l)] = q_ij . Rh[i - k + gh - 1] +
    q_ij . Rw[j - l + gw - 1] built entry by entry on a 3 x 4 grid, and
    softmax(q k^T / sqrt(d) + B) v written out; float32 rounding only."""
    g = torch.Generator().manual_seed(2)
    gh, gw, d, heads = 3, 4, 8, 2
    q, k, v = (torch.randn(2, heads, gh * gw, d, generator=g)
               for _ in range(3))
    th, tw = torch.randn(2 * gh - 1, d, generator=g), torch.randn(
        2 * gw - 1, d, generator=g)
    rh, rw = att.rel_pos_index(th, gh), att.rel_pos_index(tw, gw)
    B = torch.zeros(2, heads, gh * gw, gh * gw)
    for b in range(2):
        for h in range(heads):
            for i in range(gh):
                for j in range(gw):
                    for kk in range(gh):
                        for ll in range(gw):
                            qq = q[b, h, i * gw + j]
                            B[b, h, i * gw + j, kk * gw + ll] = (
                                qq @ th[i - kk + gh - 1]
                                + qq @ tw[j - ll + gw - 1])
    rel_h, rel_w = att.rel_pos_terms(q.view(2, heads, gh, gw, d), rh, rw)
    got = (rel_h[..., :, None] + rel_w[..., None, :]).flatten(-2)
    torch.testing.assert_close(got, B, rtol=1e-5, atol=1e-5)
    want = torch.softmax(q @ k.transpose(-1, -2) / d ** 0.5 + B, -1) @ v
    torch.testing.assert_close(att.attention(q, k, v, rh, rw, (gh, gw)),
                               want, rtol=1e-5, atol=1e-5)


def test_readout_pixel_shuffle_is_the_conv_transpose():
    """Cellpose-SAM's ``conv_transpose2d(x, eye(192).reshape(192, 3, 8,
    8), stride 8)`` is ``pixel_shuffle(x, 8)``, bit for bit."""
    x = torch.randn(2, 192, 5, 6)
    w2 = torch.eye(192).reshape(192, 3, 8, 8)
    assert torch.equal(F.pixel_shuffle(x, 8),
                       F.conv_transpose2d(x, w2, stride=8))


def test_tiles_and_taper_match_reference():
    assert tile_starts(512, 256, 0.1) == [0, 128, 256]
    assert tile_starts(256, 256, 0.1) == [0]
    for side in (32, 64, 100):
        assert tile_starts(side, 32, 0.1) == ref.tile_starts(side, 32, 0.1)
    for t in (32, 256):
        assert np.array_equal(taper(t), ref.taper(t))
    w = taper(256)[127]
    want = 1 / (1 + np.exp((np.abs(np.arange(256) - 127.5) - 108) / 7.5))
    np.testing.assert_allclose(w / w.max(), want / want.max(), rtol=1e-6)


def test_blend_and_normalisation_match_reference():
    """The wrapper's tiles and taper blend against the reference's, with
    the reference net in the program's place; float32 sums in the same
    order on both sides."""
    W = _weights()
    model = CellposeSummary(params=W, config=SMALL, compute_dtype=None,
                            device="cpu")
    mean = torch.rand(64, 64, generator=torch.Generator().manual_seed(3))
    img = normalize99(mean)
    torch.testing.assert_close(img, ref.normalize99(mean), rtol=0, atol=1e-6)
    model.net = lambda x: torch.cat([ref.forward(W, x[i:i + 1], SMALL)
                                     for i in range(len(x))])
    got, n = model._flows(img, 0.1, 4)
    assert n == 9
    corners, x = ref.tiles(img, SMALL, 0.1)
    outs = torch.cat([ref.forward(W, x[i:i + 1], SMALL) for i in range(9)])
    assert torch.equal(got, ref.blend(outs, corners, (64, 64), SMALL))


# --- the dynamics ----------------------------------------------------------

def _disc(shape, cy, cx, r):
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _target_flows(labels, scale=5.0, noise=0.0, seed=0):
    """Cellpose's training targets of ``labels``: ``scale`` x the diffused
    unit flows and cellprob +3 / -3, plus Gaussian noise on the flows."""
    mu, _ = ref_flows.masks_to_flows(labels)
    fl = np.concatenate([scale * mu, np.where(labels > 0, 3.0, -3.0)[None]])
    fl[:2] += noise * np.random.default_rng(seed).standard_normal(
        (2,) + labels.shape)
    return fl.astype(np.float32)


def _program(fl, **kw):
    t = torch.from_numpy(fl)
    return flows.compute_masks(t[:2], torch.nonzero(t[2] > 0), **kw)


def _neurons(seed, n=14, shape=(64, 64)):
    from cardbench.harness import synth

    m = synth.neuron_masks(np.random.default_rng(seed), shape, n)
    return (m.astype(np.int64) * np.arange(1, len(m) + 1)[:, None, None]
            ).max(axis=0)


@pytest.mark.parametrize("seed", range(4))
def test_dynamics_match_reference(seed):
    """Identical labels from the program's and the reference's dynamics
    on the same noisy flows of touching neurons."""
    fl = _target_flows(_neurons(seed), noise=0.5 + 0.5 * seed, seed=seed)
    got = _program(fl)
    want = ref_flows.compute_masks(fl)
    assert got.dtype == np.int32 and want.max() > 0
    assert np.array_equal(got, want)


def test_flow_check_rebuilds_the_reference_flows():
    """The program's diffusion (gathers of 9 neighbours) against the
    reference's (dense shifts), float64, bit for bit: the same steps and
    centres, the 9 terms added in the same order. At a mask's centre the
    central differences are 0 in exact arithmetic, so the direction there
    is rounding's, and another order of the sum gives another one."""
    labels = _neurons(5)
    mu, y, x, lab, steps = flows.masks_to_flows(torch.from_numpy(labels))
    want, want_steps = ref_flows.masks_to_flows(labels)
    assert steps == want_steps
    assert np.array_equal(mu.numpy(), want[:, y - 1, x - 1])


def test_two_discs_give_two_masks():
    shape = (48, 48)
    labels = _disc(shape, 14, 14, 6) * 1 + _disc(shape, 32, 31, 7) * 2
    got = _program(_target_flows(labels))
    assert got.max() == 2
    assert (got[labels == 1] > 0).mean() > 0.9
    assert (got[labels == 2] > 0).mean() > 0.9


def test_reversed_flows_are_dropped_by_the_check():
    """A disc whose flows point at its top edge, against the centre-bound
    flows the check rebuilds (reversed over half the disc): its pixels
    still gather into a mask, which the check drops."""
    shape = (48, 48)
    labels = _disc(shape, 14, 14, 6) * 1 + _disc(shape, 32, 31, 7) * 2
    fl = _target_flows(labels)
    yy, xx = np.mgrid[:48, :48]
    dy, dx = 25 - yy, 31 - xx
    norm = np.sqrt(dy ** 2 + dx ** 2) + 1e-9
    two = labels == 2
    fl[0, two], fl[1, two] = (5 * dy / norm)[two], (5 * dx / norm)[two]
    got = _program(fl)
    assert got.max() == 1 and not got[two].any()
    kept = _program(fl, flow_threshold=0.0)
    assert kept.max() == 2 and kept[two].any()
    assert np.array_equal(got, ref_flows.compute_masks(fl))


@pytest.mark.parametrize("fill", [flows.fill_holes_and_remove_small_masks,
                                  ref_flows.fill_and_renumber],
                         ids=["program", "reference"])
def test_small_masks_dropped_and_holes_filled(fill):
    labels = np.zeros((30, 30), np.int64)
    labels[2:4, 2:7] = 5                       # 10 pixels
    ring = _disc((30, 30), 15, 15, 6) & ~_disc((30, 30), 15, 15, 2)
    labels[ring] = 9
    out = fill(labels, 15)
    out = out[0] if isinstance(out, tuple) else out
    assert out.max() == 1 and not out[2:4, 2:7].any()
    assert (out == 1).sum() == _disc((30, 30), 15, 15, 6).sum()


def test_fewer_steps_change_slow_flows():
    """On a large cell whose flows move a pixel 0.1 px a step, 100 Euler
    steps leave other end points, and other labels, than 200; program and
    reference agree at each count (the flow check is off: such slow flows
    fail it)."""
    labels = _disc((80, 80), 40, 40, 20).astype(np.int64)
    fl = _target_flows(labels, scale=0.5)
    t = torch.from_numpy(fl)
    inds = torch.nonzero(t[2] > 0)
    dP = t[:2] * (t[2] > 0) / 5.0
    p100, p200 = (flows.follow_flows(dP, inds, n) for n in (100, 200))
    assert not torch.equal(p100, p200)
    got = {n: _program(fl, niter=n, flow_threshold=0.0) for n in (100, 200)}
    assert (got[100] > 0).sum() < (got[200] > 0).sum() == labels.sum()
    for n in (100, 200):
        assert np.array_equal(got[n], ref_flows.compute_masks(
            fl, niter=n, flow_threshold=0.0))


# --- state dict, counters, wrapper -----------------------------------------

def test_state_dict_loads_strictly(tmp_path):
    """A state dict saved under the published names (with ``W2`` and the
    two diameters) loads and runs; a missing key, an unknown one, a wrong
    shape or a ``W2`` that is not the identity is refused."""
    W = _weights()
    c = 3 * 4 * 4
    sd = {**W, "W2": torch.eye(c).reshape(c, 3, 4, 4),
          "diam_labels": torch.tensor([30.0]), "diam_mean": torch.tensor([30.0])}
    path = tmp_path / "cpsam_small.pt"
    torch.save(sd, path)
    model = CellposeSummary(model_path=str(path), config=SMALL,
                            compute_dtype=None, device="cpu")
    for k, v in W.items():
        assert torch.equal(model.net.weights[k], v)
    x = torch.randn(1, 3, 32, 32)
    torch.testing.assert_close(model.net(x), ref.forward(W, x, SMALL),
                               rtol=0, atol=1e-5)
    with pytest.raises(KeyError):
        cs.check_state_dict({k: v for k, v in sd.items() if k != "out.bias"},
                            CFG)
    with pytest.raises(KeyError):
        cs.check_state_dict({**sd, "encoder.extra": torch.zeros(1)}, CFG)
    with pytest.raises(ValueError):
        cs.check_state_dict({**sd, "out.bias": torch.zeros(5)}, CFG)
    with pytest.raises(ValueError):
        cs.check_state_dict({**sd, "W2": sd["W2"] * 2}, CFG)
    with pytest.raises(ValueError, match="need model_path or params"):
        CellposeSummary(device="cpu")


def test_count_records_only_under_a_profiler():
    import time

    t0 = time.time_ns()
    profiling.count("off", 3)
    assert profiling.counted(t0, time.time_ns()) == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            profiling.count("cellpose.fg_px", 12)
        profiling.count("loose", 1)
    t1 = time.time_ns()
    got = profiling.counted(t0, t1)
    assert [(c.name, c.value) for c in got] == [("cellpose.fg_px", 12.0),
                                                ("loose", 1.0)]
    (outer,) = [s for s in profiling.recorded(t0, t1) if s.name == "outer"]
    assert got[0].parent == outer.id == got[0].root
    assert got[1].parent is None and got[1].root is None
    # Spans and counts share one buffer; each reader sees its own kind.
    assert all(type(s) is profiling.Span for s in profiling.recorded(t0, t1))


def _movie(seed=0, t=9, shape=(64, 64), n=10):
    from cardbench.harness import synth

    rng = np.random.default_rng(seed)
    masks = synth.neuron_masks(rng, shape, n)
    gen = torch.Generator().manual_seed(seed)
    return synth.calcium_movie(masks, t, gen, "cpu"), masks


def test_evaluate_movie_matches_reference():
    """End to end on a 64 x 64 movie: the flows within 1e-5 of the
    output's range of the float32 reference's (the net's tolerance), the
    labels those of the reference's dynamics on the program's own flows,
    the spans and counters recorded under a profiler."""
    import time

    W = _weights(4)
    W["out.weight"] = W["out.weight"] * 4
    model = CellposeSummary(params=W, config=SMALL, compute_dtype=None,
                            device="cpu")
    movie, _ = _movie()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        labels, fl = model.evaluate_movie(movie, tile=32)
    t1 = time.time_ns()
    assert labels.dtype == np.int32 and labels.shape == (64, 64)
    assert fl.dtype == np.float32 and fl.shape == (3, 64, 64)
    from cardbench.reference.unet2ds import movie_mean

    want = ref.evaluate_flows(W, movie_mean(movie), SMALL).numpy()
    assert np.abs(fl - want).max() <= 1e-5 * np.abs(want).max()
    assert np.array_equal(labels, ref_flows.compute_masks(fl))
    names = {s.name for s in profiling.recorded(t0, t1)}
    assert {"evaluate_movie", "evaluate_movie.upload", "cellpose.summary",
            "cellpose.net", "cellpose.dynamics",
            "evaluate_movie.fetch"} <= names
    counts = {c.name: c.value for c in profiling.counted(t0, t1)}
    assert counts["cellpose.tiles"] == 9
    assert counts["cellpose.fg_px"] == (fl[2] > 0).sum()
    assert counts["cellpose.masks"] == labels.max()
    # An array and an open dataset's slices give the same answer.
    got, _ = model.evaluate_movie(movie.numpy())
    assert np.array_equal(got, labels)

    class Lazy:
        shape, dtype = movie.shape, movie.numpy().dtype

        def __getitem__(self, sl):
            return movie.numpy()[sl]

    got, fl2 = model.evaluate_movie(Lazy())
    assert np.array_equal(got, labels) and np.array_equal(fl2, fl)


def test_build_records_the_packed_route():
    import time

    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        CellposeSummary(params=_weights(), config=SMALL, device="cpu")
    spans = profiling.recorded(t0, time.time_ns())
    by = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.name == "cellpose.build"]
    kids = {s.name for s in spans if s.parent == root.id}
    assert {"net.pack", "net.upload", "net.load", "net.init"} <= kids
    assert all(by[s.parent].name == "cellpose.build" for s in spans
               if s.name.startswith("net."))


# --- the normal path for users ----------------------------------------------

def test_instance_labels_in_metrics_and_submissions(tmp_path):
    """Two touching neurons stay two regions as instance labels, where a
    binary mask's components merge them."""
    from deepcalcium_torch.data.nf import nf_submit
    from deepcalcium_torch.metrics.neurofinder import (label_mask,
                                                       labels_to_regions,
                                                       mask_to_regions,
                                                       nf_mask_metrics)

    labels = np.zeros((20, 20), np.int32)
    labels[5:10, 3:8] = 1
    labels[5:10, 8:12] = 2
    labels[15:18, 15:18] = 4
    regions = labels_to_regions(labels)
    assert len(regions) == 3 and len(mask_to_regions(labels > 0)) == 2
    assert [len(r) for r in regions] == [25, 20, 9]
    assert nf_mask_metrics(labels, labels, instances=True) == (
        1.0, 1.0, 1.0, 1.0, 1.0)
    merged = nf_mask_metrics(labels, label_mask(labels > 0), instances=True)
    assert merged[0] == 1.0 and merged[1] == pytest.approx(2 / 3)
    assert nf_mask_metrics(labels, np.zeros_like(labels),
                           instances=True) == (0.0,) * 5
    path = tmp_path / "sub.json"
    nf_submit([labels], ["neurofinder.00.00"], str(path), instances=True)
    sub = json.loads(path.read_text())
    assert sub[0]["dataset"] == "00.00" and len(sub[0]["regions"]) == 3


def test_cli_evaluate_movie_cellpose(tmp_path, monkeypatch, capsys):
    """``evaluate-movie --arch cellpose-sam`` on a state dict file: the
    wrapper's labels and flows in the ``.npz``; ``--window`` and
    ``--threshold`` refused with a message."""
    from deepcalcium_torch import cli

    W = _weights(4)
    W["out.weight"] = W["out.weight"] * 4
    path = tmp_path / "cpsam.pt"
    torch.save(W, path)
    movie, _ = _movie()
    monkeypatch.setattr(
        cli, "_cellpose_wrapper", lambda args: CellposeSummary(
            model_path=args.model_path, config=SMALL, device=args.device,
            compute_dtype=cli._DTYPES[args.dtype]))

    class Raw:
        def __init__(self, path):
            pass

        def __enter__(self):
            return movie.numpy()

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(cli, "_open_raw", Raw)
    out = tmp_path / "o.npz"
    cli.main(["evaluate-movie", "mv.hdf5", "-m", str(path), "--arch",
              "cellpose-sam", "--device", "cpu", "--out", str(out)])
    assert "cells" in capsys.readouterr().out
    got = np.load(out)
    want, fl = CellposeSummary(params=W, config=SMALL, compute_dtype=None,
                               device="cpu").evaluate_movie(movie)
    assert np.array_equal(got["labels"], want)
    assert np.array_equal(got["flows"], fl)
    for flag in (["--window", "64"], ["--threshold", "0.2"]):
        with pytest.raises(SystemExit, match="takes no"):
            cli.main(["evaluate-movie", "mv.hdf5", "-m", str(path), "--arch",
                      "cellpose-sam", "--device", "cpu"] + flag)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_graph_replay_is_the_eager_net_on_card(card):
    """Each batch size's CUDA graph gives the eager net's output bit for
    bit, for inputs after the one it was captured on too."""
    model = CellposeSummary(params=_weights(), config=SMALL, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for b in (8, 1, 8):
        x = torch.rand((b, 3, 32, 32), generator=g, device="cuda")
        assert torch.equal(model._forward(x).clone(), model.net(x))
    assert sorted(model._graphs) == [1, 8]


@pytest.mark.cuda
def test_dynamics_on_card_match_reference(card):
    """On the card the Euler steps and the diffusion run as replays of
    one-step CUDA graphs: the end points, the rebuilt flows and the labels
    are bit for bit the reference's eager steps on the card."""
    labels = _neurons(2, n=40, shape=(128, 128))
    fl = _target_flows(labels, noise=1.0, seed=2)
    t = torch.from_numpy(fl).cuda()
    inds = torch.nonzero(t[2] > 0)
    p = flows.follow_flows(t[:2] * (t[2] > 0) / 5.0, inds, 200)
    assert np.array_equal(p.cpu().numpy(), ref_flows.follow_flows(
        fl[:2], fl[2] > 0, 200, "cuda"))
    mu, y, x, _, _ = flows.masks_to_flows(torch.from_numpy(labels).cuda())
    want, _ = ref_flows.masks_to_flows(labels, "cuda")
    assert np.array_equal(mu.cpu().numpy(),
                          want[:, y.cpu().numpy() - 1, x.cpu().numpy() - 1])
    got = flows.compute_masks(t[:2], inds)
    assert got.max() > 0
    assert np.array_equal(got, ref_flows.compute_masks(fl, device="cuda"))
