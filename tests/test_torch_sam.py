"""Segment Anything in the port (``models/sam.py``, ``models/sam_vit.py``,
``ops/amg.py``, ``models/sam_summary.py``) on the CPU at a tiny size: width
32, 3 blocks (one global over a 10 x 10 grid, two in 4 x 4 windows of the
grid padded to 12 x 12), 2 heads, a patch of 4 on 40 x 40 images; a decoder
of width 64 with 2 heads; 16 point prompts in batches of 8; seeded random
weights. The JAX package has no such model: everything is held against the
plain reference ``cardbench/reference/sam.py`` in float32.

Also the published sizes' pinned counts, the shared encoder against
Cellpose-SAM's forward as it was before the encoder was shared, and
``evaluate-movie --arch sam-vit-h``. On the card (marker ``cuda``): the
attention kernel at SAM's two shapes, and the call's attention launches."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cardbench.harness.entries.evaluate_movie_sam import (IOU_BIAS, Entry,
                                                      make_weights)
from cardbench.reference import sam as ref
from cardbench.reference.unet2ds import movie_mean
from deepcalcium_torch.models import cellpose_sam as cs
from deepcalcium_torch.models import sam, sam_vit
from deepcalcium_torch.models.sam_summary import SamSummary, sam_image
from deepcalcium_torch.ops import amg
from deepcalcium_torch.ops import attention as att
from deepcalcium_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = {"width": 32, "depth": 3, "heads": 2, "mlp_dim": 64, "patch": 4,
        "image_size": 40, "neck_dim": 64, "global_blocks": [1],
        "window_size": 4, "rel_pos_window": 7, "rel_pos_global": 19,
        "ln_eps": 1e-6, "decoder_depth": 2, "decoder_heads": 2,
        "decoder_mlp_dim": 64, "attention_downsample": 2,
        "multimask_outputs": 3, "iou_head_hidden": 32, "iou_head_depth": 3,
        "decoder_ln_eps": 1e-5, "pixel_mean": [123.675, 116.28, 103.53],
        "pixel_std": [58.395, 57.12, 57.375],
        "init_std": {"rel_pos_window": 0.2, "rel_pos_global": 0.2},
        "amg": {"points_per_side": 4, "points_per_batch": 8,
                "pred_iou_thresh": 0.88, "stability_score_thresh": 0.95,
                "stability_score_offset": 1.0, "box_nms_thresh": 0.7,
                "mask_threshold": 0.0}}
CFG = sam.Config.from_dict(TINY)
PUBLISHED = json.loads((ROOT / "cardbench/configs/sam-vit-h-amg.json")
                       .read_text())


def _weights(seed=0):
    """The cell's draw, but with the decoder's transposed-conv kernels
    drawn anew at each of their 2 x 2 positions (the cell ties them, for
    masks of neurons' size), so that the tests tell the positions apart."""
    W = make_weights(TINY, seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in W.items():
        if "output_upscaling" in k and v.dim() == 4:
            W[k] = torch.randn(v.shape, generator=g) * v.shape[0] ** -0.5
    return W


def _calibrated(seed, movie):
    """The tiny weights calibrated on ``movie`` as the cell calibrates its
    own (``evaluate_movie_sam.Entry._calibrate``): 5% of the frame
    covered by the median mask, 40% of the predictions past each filter."""
    e = Entry({**TINY, "calibration": {"iou_pass": 0.4, "stable_pass": 0.4,
                                       "coverage": 0.05}}, {}, seed, "cpu", 1)
    e.movies, e.W, e._embeddings = [movie], _weights(seed), {}
    e._calibrate()
    return e.W


def _movie(seed=0, t=6, shape=(48, 48), n=6):
    from cardbench.harness import synth

    rng = np.random.default_rng(seed)
    masks = synth.neuron_masks(rng, shape, n)
    gen = torch.Generator().manual_seed(seed)
    return synth.calcium_movie(masks, t, gen, "cpu")


def test_published_counts_are_pinned():
    """641,086,180 weights read (637,026,048 of them the encoder's); 5.961
    TFLOP for the encoder (window padding included) and 3.623 GFLOP a
    prompt for the decoder: the package's, the reference's and the
    configuration file's counts agree."""
    pub = sam.Config()
    assert sam.param_count() == ref.param_count(PUBLISHED) == 641_086_180
    assert sam_vit.param_count(pub) == PUBLISHED["encoder_params"] \
        == 637_026_048
    assert sam_vit.forward_flops(pub) == ref.encoder_flops(PUBLISHED) \
        == PUBLISHED["encoder_flops"] == 5_961_082_830_848
    assert sam.decoder_flops() == ref.decoder_flops(PUBLISHED) \
        == PUBLISHED["decoder_flops_per_prompt"] == 3_622_604_800
    assert sam.forward_flops() == ref.forward_flops(PUBLISHED) \
        == PUBLISHED["flops_per_call"]
    assert sam.param_count(CFG) == ref.param_count(TINY)
    assert sam.forward_flops(CFG, 16) == ref.forward_flops(TINY)
    assert sam.Config.from_dict(PUBLISHED) == pub
    assert [sam_vit.block_window(pub, i) for i in range(32)] == \
        [0 if i in (7, 15, 23, 31) else 14 for i in range(32)]
    assert [s for k, s in sam.leaf_shapes() if "rel_pos_h" in k] == \
        [(127 if i in (7, 15, 23, 31) else 27, 80) for i in range(32)]


def test_config_takes_the_prompt_grid_and_holds_the_thresholds():
    """A configuration file's ``amg`` block sets the prompt grid; its
    thresholds are the generator's constants, and one that differs is
    refused rather than ignored."""
    assert (CFG.points_per_side, CFG.points_per_batch) == (4, 8)
    pub = sam.Config.from_dict(PUBLISHED)
    assert (pub.points_per_side, pub.points_per_batch) == (32, 64)
    for k in ("pred_iou_thresh", "stability_score_thresh",
              "stability_score_offset", "box_nms_thresh", "mask_threshold"):
        assert getattr(pub, k) == PUBLISHED["amg"][k]
        with pytest.raises(ValueError, match=k):
            sam.Config.from_dict({"amg": {**PUBLISHED["amg"], k: 0.5}})


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_cellpose_forward_is_the_parent_bitwise(dtype):
    """Cellpose-SAM through the shared encoder gives, bit for bit, the
    forward its own block loop gave before the encoder was shared
    (``tests/golden/cellpose_sam_tiny_forward.npz``, written by that code:
    width 64, 4 blocks, tables N(0, 0.2), two 2 x 3 x 32 x 32 tiles)."""
    from cardbench.reference import cellpose_sam as cref

    small = {"width": 64, "depth": 4, "heads": 4, "mlp_dim": 256, "patch": 4,
             "tile": 32, "neck_dim": 32, "out_channels": 3,
             "global_blocks": [1, 3], "rel_pos_window": 27,
             "rel_pos_global": 127, "ln_eps": 1e-6}
    g = torch.Generator().manual_seed(3)
    W = {}
    for k, s in cref.leaves(small):
        z = torch.randn(s, generator=g)
        if "norm" in k or k.startswith(("encoder.neck.1", "encoder.neck.3")):
            W[k] = z * 0.1 + (1.0 if k.endswith("weight") else 0.0)
        elif "rel_pos" in k:
            W[k] = z * 0.2
        elif "pos_embed" in k or k.endswith("bias"):
            W[k] = z * 0.02
        else:
            W[k] = z / np.sqrt(np.prod(s[1:]))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(4))
    net = cs.inference_net(W, cs.Config.from_dict(small), dtype, "cpu")
    want = np.load(ROOT / "tests/golden/cellpose_sam_tiny_forward.npz")
    assert np.array_equal(net(x).numpy(),
                          want["float32" if dtype is None else "bfloat16"])


def test_encoder_matches_reference():
    """The window blocks (the 10 x 10 grid padded to 12 x 12, the padded
    keys kept) and the global block against SAM's ``window_partition``,
    ``Attention`` with its bias materialised and ``window_unpartition``:
    float32 on both sides, within 1e-5 of the largest value (SDPA and
    ``F.layer_norm`` sum in other orders than the written-out reference)."""
    W = _weights()
    net = sam.inference_net(W, CFG, None, "cpu")
    x = torch.randn(1, 3, 40, 40, generator=torch.Generator().manual_seed(1))
    want = ref.encoder(W, x, TINY)
    got = net.encode(x)
    assert got.shape == (1, 64, 10, 10)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # The window blocks' bias is in: their tables zeroed move the answer.
    masked = dict(W)
    for i in (0, 2):
        for a in "hw":
            masked[f"image_encoder.blocks.{i}.attn.rel_pos_{a}"] = torch.zeros(
                7, 16)
    assert (ref.encoder(masked, x, TINY) - want).abs().max() > 1e-3


def test_window_attention_is_sams_partition():
    """One window block's attention against the reference's partition,
    attention and un-partition on a 10 x 10 grid in 4 x 4 windows."""
    W = _weights(2)
    net = sam.inference_net(W, CFG, None, "cpu")
    blk = net.compute["blocks"][0]
    assert blk["window"] == 4 and net.compute["blocks"][1]["window"] == 0
    h = torch.randn(2, 100, 32, generator=torch.Generator().manual_seed(3))
    got = sam_vit.window_attention(h, blk, (10, 10), 4, 2)
    win, pad = ref.window_partition(h.view(2, 10, 10, 32), 4)
    assert win.shape == (18, 4, 4, 32) and pad == (12, 12)
    want = ref.window_unpartition(ref._encoder_attention(
        W, "image_encoder.blocks.0.attn.", win, TINY, None), 4, pad,
        (10, 10)).reshape(2, 100, 32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_prompt_encoder_matches_reference():
    """The points' encodings (each with the padding point) bit for bit and
    the image's positional encoding."""
    W = _weights()
    net = sam.inference_net(W, CFG, None, "cpu")
    pts = ref.prompt_points(TINY, 48, 40)
    assert np.array_equal(pts, amg.prompt_points(4, 48, 40, 40))
    got = net.embed_points(torch.from_numpy(pts))
    assert torch.equal(got, ref.sparse_embeddings(W, pts, TINY))
    pe = net.compute["image_pe"].reshape(1, 10, 10, 64).permute(0, 3, 1, 2)
    torch.testing.assert_close(pe, ref.image_pe(W, TINY), rtol=0, atol=1e-6)


def test_decoder_matches_reference():
    """The low-resolution logits and IoUs of 8 prompts, float32 on both
    sides, within 1e-3 of the largest logit: the decoder's LayerNorms over
    few channels amplify float32 rounding (the reference itself lies about
    2e-4 of it from float64 at this size). Block 1's skipped positional
    encoding matters."""
    W = _weights(1)
    net = sam.inference_net(W, CFG, None, "cpu")
    emb = ref.encoder(W, torch.randn(1, 3, 40, 40), TINY)
    sparse = ref.sparse_embeddings(W, ref.prompt_points(TINY, 40, 40)[:8],
                                   TINY)
    want, iou_want = ref.decoder(W, emb, sparse, TINY)
    got, iou = net.decode(emb, sparse)
    assert got.shape == (8, 3, 40, 40) and iou.shape == (8, 3)
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()
    assert (iou - iou_want).abs().max() <= 1e-4
    net.compute["layers"][0]["skip_pe"] = False
    moved, _ = net.decode(emb, sparse)
    assert (moved - want).abs().max() > 1e-2 * want.abs().max()
    # Each transposed conv's 2 x 2 positions are told apart.
    net.compute["layers"][0]["skip_pe"] = True
    for key in ("up0.w", "up3.w"):
        w = net.compute[key]
        net.compute[key] = w.transpose(2, 3)
        moved, _ = net.decode(emb, sparse)
        net.compute[key] = w
        assert (moved - want).abs().max() > 1e-2 * want.abs().max(), key


def test_sam_image_matches_reference():
    """The encoder input: the 8-bit values of the float32 and float64
    percentile scalings differ by at most one level at a few pixels."""
    mean = movie_mean(_movie(1))
    got, size = sam_image(mean, CFG)
    want, size_ref = ref.image(mean, TINY)
    assert size == size_ref == (40, 40) and got.shape == want.shape
    diff = (got - want).abs()
    assert diff.max() <= 1.0001 / 57.12
    assert (diff > 1e-5).float().mean() <= 0.01


@pytest.mark.parametrize("hw", [(48, 48), (48, 30)])
def test_postprocess_matches_reference(hw):
    """Logits to the encoder's square, cropped to the resized image, to the
    frame: bit for bit, a square frame and one that needs the crop."""
    low = torch.randn(2, 3, 40, 40)
    size = amg.preprocess_shape(*hw, 40)
    assert size == ref.resized_shape(*hw, 40)
    got = amg.postprocess_masks(low, size, hw, 40)
    assert torch.equal(got, ref.postprocess(low, size, hw, TINY))


def test_stability_and_boxes_match_reference():
    """Stability scores bit for bit (NaN where no pixel is above the lower
    threshold); boxes of random masks, an empty one and a one-pixel one."""
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(6, 24, 20, generator=g) * 3
    logits[2] = -5.0
    got = amg.stability_score(logits, 0.0, 1.0)
    want = ref.stability_score(logits, 0.0, 1.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(got[2])
    masks = torch.rand(5, 24, 20, generator=g) > 0.97
    masks[1] = False
    masks[2] = False
    masks[2, 7, 3] = True
    boxes = amg.mask_to_box(masks)
    assert torch.equal(boxes, ref.mask_to_box(masks))
    assert boxes[1].tolist() == [0, 0, 0, 0]
    assert boxes[2].tolist() == [3, 7, 3, 7]


NMS_CASES = {
    # random boxes of many overlaps
    "random": None,
    # equal scores: the lower index wins
    "ties": ([[0, 0, 10, 10], [0, 0, 10, 10], [1, 1, 10, 10],
              [20, 20, 30, 30]],
             [0.9, 0.9, 0.9, 0.5], [0, 3]),
    # one box over all others
    "all_suppressed": ([[0, 0, 10, 10]] * 5, [0.1, 0.5, 0.3, 0.9, 0.2], [3]),
    # nothing given
    "none": (np.zeros((0, 4)), [], []),
    # boxes of no area have an IoU of 0 / 0 and are all kept
    "no_area": ([[3, 3, 3, 3], [3, 3, 3, 3]], [0.9, 0.8], [0, 1]),
    # a chain: 1 drops 2, so 3, which only 2 overlaps, stays
    "chain": ([[0, 0, 10, 10], [1, 0, 11, 10], [2, 0, 12, 10]],
              [0.9, 0.8, 0.7], [0, 2]),
}


@pytest.mark.parametrize("case", list(NMS_CASES))
def test_box_nms_matches_reference(case):
    """The fixed-point NMS against the reference's greedy loop (both keep
    the same boxes in the same order) and against the answers by hand."""
    if NMS_CASES[case] is None:
        g = torch.Generator().manual_seed(6)
        xy = torch.randint(0, 40, (60, 2), generator=g)
        wh = torch.randint(1, 20, (60, 2), generator=g)
        boxes = torch.cat([xy, xy + wh], 1)
        scores = torch.rand(60, generator=g).round(decimals=1)
        want = None
    else:
        b, s, want = NMS_CASES[case]
        boxes = torch.tensor(np.asarray(b), dtype=torch.int64).reshape(-1, 4)
        scores = torch.tensor(s, dtype=torch.float32)
    got = amg.box_nms(boxes, scores, 0.7).tolist()
    assert got == ref.nms(boxes, scores, 0.7)
    if want is not None:
        assert got == want
    if case == "random":
        assert 5 < len(got) < 60
        assert amg.box_nms(boxes, scores, 0.35).tolist() == ref.nms(
            boxes, scores, 0.35) != got


def test_paint_labels_matches_reference():
    """Largest first, the smaller masks on top, labels 1...n by area."""
    m = torch.zeros(3, 8, 8, dtype=torch.bool)
    m[0, 2:4, 2:4] = True       # 4 px
    m[1, :, :] = True           # 64 px
    m[2, 3:6, 3:6] = True       # 9 px
    got, order = amg.paint_labels(m)
    assert torch.equal(got, ref.paint(m)) and order.tolist() == [1, 2, 0]
    assert got[0, 0] == 1 and got[2, 2] == 3 and got[3, 3] == 3 \
        and got[5, 5] == 2
    got, order = amg.paint_labels(m[:0])
    assert got.sum() == 0 and len(order) == 0 and ref.paint(m[:0]).sum() == 0


def test_state_dict_loads_strictly(tmp_path):
    """A state dict saved under the published names (with the mask
    prompt's encoder, which is not read) loads and runs; a missing key, an
    unknown one or a wrong shape is refused."""
    W = _weights()
    sd = {**W, "prompt_encoder.mask_downscaling.0.weight": torch.zeros(
        4, 1, 2, 2)}
    path = tmp_path / "sam_tiny.pth"
    torch.save(sd, path)
    model = SamSummary(model_path=str(path), config=TINY, compute_dtype=None,
                       device="cpu")
    for k, v in W.items():
        assert torch.equal(model.net.weights[k], v)
    with pytest.raises(KeyError):
        sam.check_state_dict({k: v for k, v in W.items()
                              if k != IOU_BIAS}, CFG)
    with pytest.raises(KeyError):
        sam.check_state_dict({**W, "mask_decoder.extra": torch.zeros(1)},
                             CFG)
    with pytest.raises(ValueError):
        sam.check_state_dict({**W, IOU_BIAS: torch.zeros(5)}, CFG)
    with pytest.raises(ValueError, match="need model_path or params"):
        SamSummary(device="cpu")


def _generate(W, movie):
    return ref.generate(W, movie_mean(movie), TINY)


def test_evaluate_movie_matches_reference():
    """End to end on a 48 x 48 movie, float32: the logits and IoUs within
    the decoder's tolerance, the same predictions past both filters, the
    same kept masks and the same label image as the reference's generator;
    the spans and counters recorded under a profiler."""
    movie = _movie(2)
    W = _calibrated(3, movie)
    model = SamSummary(params=W, config=TINY, compute_dtype=None,
                       device="cpu")
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        got = model.evaluate_movie(movie)
    t1 = time.time_ns()
    want = _generate(W, movie)
    assert got.labels.dtype == np.int32 and got.labels.shape == (48, 48)
    low = want["low_res"]
    assert (got.low_res - low).abs().max() <= 1e-3 * low.abs().max()
    assert np.abs(got.iou_preds - want["iou"].numpy()).max() <= 1e-4
    assert np.array_equal(got.candidates, want["candidates"].numpy())
    assert 0 < len(got.candidates) < 48
    assert np.array_equal(got.candidate_boxes, want["boxes"].numpy())
    assert sorted(got.keep) == sorted(want["kept"])
    assert np.array_equal(got.labels, want["labels"].numpy())
    assert got.masks.shape == (len(got.keep), 48, 48)
    assert np.array_equal(got.boxes, amg.mask_to_box(got.masks).numpy())
    assert all(np.diff(got.masks.sum((1, 2)).numpy()) <= 0)
    names = {s.name for s in profiling.recorded(t0, t1)}
    assert {"evaluate_movie", "evaluate_movie.upload", "sam.summary",
            "sam.encoder", "sam.decoder", "sam.postprocess", "sam.nms",
            "sam.labels", "evaluate_movie.fetch"} <= names
    counts = {c.name: c.value for c in profiling.counted(t0, t1)}
    stages = ("summary", "encoder", "decoder", "postprocess", "nms",
              "labels")
    for stage in stages:
        assert counts.pop(f"sam.{stage}.device_ms") > 0
    assert counts == {"sam.attn_launches": 0, "sam.prompts": 16,
                      "sam.decoder_batches": 2, "sam.masks": 48,
                      "sam.masks_iou_kept": float((got.iou_preds
                                                   > 0.88).sum()),
                      "sam.masks_stable_kept": len(got.candidates),
                      "sam.masks_nms_kept": len(got.keep)}
    # An array and an open dataset's slices give the same answer.
    assert np.array_equal(model.evaluate_movie(movie.numpy()).labels,
                          got.labels)

    class Lazy:
        shape, dtype = movie.shape, movie.numpy().dtype

        def __getitem__(self, sl):
            return movie.numpy()[sl]

    assert np.array_equal(model.evaluate_movie(Lazy()).labels, got.labels)


def test_build_records_the_packed_route():
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        SamSummary(params=_weights(), config=TINY, device="cpu")
    spans = profiling.recorded(t0, time.time_ns())
    (root,) = [s for s in spans if s.name == "sam.build"]
    kids = {s.name for s in spans if s.parent == root.id}
    assert {"net.pack", "net.upload", "net.load", "net.init"} <= kids


def test_importing_the_package_loads_no_sam_code():
    import subprocess
    import sys

    code = ("import sys, deepcalcium_torch, deepcalcium_torch.cli; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('deepcalcium_torch') and 'sam' in m))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out


def test_cli_evaluate_movie_sam(tmp_path, monkeypatch, capsys):
    """``evaluate-movie --arch sam-vit-h`` on a state dict file: the
    wrapper's labels, masks, scores and boxes in the ``.npz``; ``--window``
    and ``--threshold`` refused with a message."""
    from deepcalcium_torch import cli

    movie = _movie(2)
    W = _calibrated(3, movie)
    path = tmp_path / "sam.pth"
    torch.save(W, path)
    monkeypatch.setattr(
        cli, "_sam_wrapper", lambda args: SamSummary(
            model_path=args.model_path, config=TINY, device=args.device,
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
              "sam-vit-h", "--device", "cpu", "--out", str(out)])
    assert "masks" in capsys.readouterr().out
    got = np.load(out)
    want = SamSummary(params=W, config=TINY, compute_dtype=None,
                      device="cpu").evaluate_movie(movie)
    assert np.array_equal(got["labels"], want.labels)
    assert np.array_equal(got["masks"], want.masks.numpy())
    assert np.array_equal(got["boxes"], want.boxes)
    assert np.array_equal(got["scores"], want.scores)
    for flag in (["--window", "64"], ["--threshold", "0.2"]):
        with pytest.raises(SystemExit, match="takes no"):
            cli.main(["evaluate-movie", "mv.hdf5", "-m", str(path), "--arch",
                      "sam-vit-h", "--device", "cpu"] + flag)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _explicit_attention(qkv, th, tw, grid, heads, dtype=torch.float32):
    """``softmax(q k^T / sqrt(d) + B) v`` in ``dtype`` with B built whole."""
    b, n, c3 = qkv.shape
    d = c3 // (3 * heads)
    gh, gw = grid
    q, k, v = qkv.to(dtype).view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    rel_h, rel_w = att.rel_pos_terms(
        q.reshape(b, heads, gh, gw, d), att.rel_pos_index(th.to(dtype), gh),
        att.rel_pos_index(tw.to(dtype), gw))
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(b, heads, n, n)
    p = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5 + bias, -1)
    return (p @ v).transpose(1, 2).reshape(b, n, heads * d)


# (batch, grid): a window block's 25 windows of 14 x 14 tokens and a global
# block's 64 x 64 grid, 16 heads of 80 (SAM ViT-H).
SAM_SHAPES = {"windows_25x14x14": (25, (14, 14)),
              "global_64x64": (1, (64, 64))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "float32"])
@pytest.mark.parametrize("case", list(SAM_SHAPES))
def test_attention_kernel_at_sams_shapes_on_card(card, case, dtype):
    """The kernel at head dim 80 against the attention with B built whole
    on the same inputs; one launch. bf16: against float32, its largest
    error at most 1.25 times that of the plain padded route (SDPA at head
    dim d + gh + gw, which also rounds both bias terms to bf16). float32
    (the command line's default dtype, the kernel's float32 entry: one
    thread a query, the keys summed one after another): against float64,
    within float32's bound for such a sum over the N keys, N 2^-24
    max|v|. On the card it reads 4.6e-6 at the windows and 3.8e-5 at the
    64 x 64 grid, 1.3 and 12 times the padded route's blocked SDPA, whose
    error does not grow so with N."""
    b, grid = SAM_SHAPES[case]
    g = torch.Generator(device="cuda").manual_seed(5)
    gh, gw = grid
    qkv = torch.randn((b, gh * gw, 3 * 16 * 80), generator=g,
                      device="cuda").to(dtype)
    th = (torch.randn((2 * gh - 1, 80), generator=g, device="cuda")
          * 0.2).to(dtype)
    tw = (torch.randn((2 * gw - 1, 80), generator=g, device="cuda")
          * 0.2).to(dtype)
    exact = torch.float64 if dtype == torch.float32 else torch.float32
    want = _explicit_attention(qkv, th, tw, grid, 16, exact)
    n0 = att.attention_qkv_cuda.launches
    got = att.attention_qkv(qkv, th, tw, grid, 16)
    assert att.attention_qkv_cuda.launches - n0 == 1
    assert got.dtype == dtype
    err = (got.to(exact) - want).abs().max()
    q, k, v = qkv.view(b, gh * gw, 3, 16, 80).permute(2, 0, 3, 1, 4)
    padded = att.attention(q, k, v, att.rel_pos_index(th, gh),
                           att.rel_pos_index(tw, gw), grid)
    padded = padded.transpose(1, 2).reshape(b, gh * gw, -1)
    padded_err = (padded.to(exact) - want).abs().max()
    if dtype == torch.bfloat16:
        assert err <= 1.25 * padded_err, (float(err), float(padded_err))
    else:
        bound = gh * gw * 2.0 ** -24 * v.abs().max()
        assert err <= bound, (float(err), float(bound), float(padded_err))
    nobias = _explicit_attention(qkv, th * 0, tw * 0, grid, 16, exact)
    assert (nobias - want).abs().max() > 20 * err


@pytest.mark.cuda
def test_card_call_counts_attention_launches(card):
    """A call on the card launches the kernel once a block (3 at this
    size: two window blocks, one global) and records it; the window
    blocks' kernel sees the padded grid's windows. A traced call counts
    each stage's time on the card."""
    movie = _movie(2)
    model = SamSummary(params=_calibrated(3, movie), config=TINY,
                       device="cuda")
    movie = movie.cuda()
    model.evaluate_movie(movie)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        got = model.evaluate_movie(movie)
    counts = {c.name: c.value for c in profiling.counted(t0, time.time_ns())}
    assert counts["sam.attn_launches"] == CFG.depth
    assert got.labels.shape == (48, 48)
    # The traced call's stages are timed on the card, and it computes what
    # an untraced call does.
    assert all(counts[f"sam.{stage}.device_ms"] > 0 for stage in (
        "summary", "encoder", "decoder", "postprocess", "nms", "labels"))
    assert np.array_equal(model.evaluate_movie(movie).iou_preds,
                          got.iou_preds)
