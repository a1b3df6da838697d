"""The Segment Anything cell (``sam-amg-evaluate-card``) rehearsed on the CPU
at a tiny size (``tiny_sam.py``): a sound run is correct, a traced run reads
its per-layer metrics, and each fault planted in the timed path after
set-up (the window blocks' padded keys masked out, the global blocks'
tables zeroed, block 1's positional encoding not skipped, NMS at 0.35) and
the fp8 control are caught. Then the readers. On a card, at the cell's own
size, the same faults and the control fail while the package passes
(marker ``cuda``)."""

import json
import time

import pytest
import torch
import torch.nn.functional as F

from cardbench.harness import env
from cardbench.harness.cell import Bench, Context, read_metric, run
from cardbench.harness.trace import Spans, Trace
from cardbench.reference import sam as ref
from cardbench.tests.tiny_sam import CELL, run_tiny

SEED = 11
METRICS = [m["name"] for m in json.loads(
    (env.ROOT / "BENCHMARK.json").read_text())["per_layer"]
    if CELL in m["workloads"]]


def _masked_window_attention(h, blk, grid, window, heads):
    """A window block's attention with the padded keys masked out of every
    window (SAM keeps them): float32 scores with the bias built whole."""
    from deepcalcium_torch.ops import attention as att

    b, _, w = h.shape
    gh, gw = grid
    hp, wp = gh + (-gh) % window, gw + (-gw) % window
    nh, nw = hp // window, wp // window
    n, d = window * window, w // heads
    x = F.pad(h.view(b, gh, gw, w), (0, 0, 0, wp - gw, 0, hp - gh))
    x = x.view(b, nh, window, nw, window, w).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(-1, n, w)
    real = torch.zeros(hp, wp, dtype=torch.bool, device=h.device)
    real[:gh, :gw] = True
    real = real.view(nh, window, nw, window).permute(0, 2, 1, 3).reshape(
        1, nh * nw, n).expand(b, -1, -1).reshape(-1, 1, 1, n)
    qkv = F.linear(x, blk["qkv.w"], blk["qkv.b"]).float()
    q, k, v = qkv.view(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    rel_h, rel_w = att.rel_pos_terms(
        q.reshape(-1, heads, window, window, d),
        att.rel_pos_index(blk["rh"].float(), window),
        att.rel_pos_index(blk["rw"].float(), window))
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(-1, heads, n, n)
    s = (q @ k.transpose(-1, -2) * d ** -0.5 + bias).masked_fill(
        ~real, float("-inf"))
    a = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(-1, n, w)
    a = F.linear(a.to(h.dtype), blk["proj.w"], blk["proj.b"])
    a = a.view(b, nh, nw, window, window, w).permute(0, 1, 3, 2, 4, 5)
    return a.reshape(b, hp, wp, w)[:, :gh, :gw].reshape(b, gh * gw, w)


def _masked_padding(entry, monkeypatch):
    """The padded keys of the window blocks masked out."""
    from deepcalcium_torch.models import sam_vit

    monkeypatch.setattr(sam_vit, "window_attention", _masked_window_attention)


def _no_global_bias(entry, monkeypatch):
    """The global blocks' tables zeroed in the built net, so that the
    kernel (or the CPU's plain attention) runs without their bias."""
    for blk in entry.wrapper.net.compute["blocks"]:
        if not blk["window"]:
            blk["rh"].zero_()
            blk["rw"].zero_()


def _pe_not_skipped(entry, monkeypatch):
    """Block 1 of the two-way transformer adds the tokens' positional
    encoding and a residual to its self-attention, as block 2 does."""
    entry.wrapper.net.compute["layers"][0]["skip_pe"] = False


def _nms_035(entry, monkeypatch):
    """Box NMS at an IoU of 0.35 in place of 0.7."""
    from deepcalcium_torch.ops import amg

    real = amg.box_nms
    monkeypatch.setattr(amg, "box_nms", lambda b, s, t: real(b, s, 0.35))


FAULTS = [_masked_padding, _no_global_bias, _pe_not_skipped, _nms_035]


def _planted(fault, monkeypatch):
    def patch(entry):
        real_setup = entry.setup

        def setup():
            real_setup()
            fault(entry, monkeypatch)

        entry.setup = setup

    return patch


@pytest.mark.parametrize("seed", [SEED, 7])
def test_sound_run_is_correct(seed):
    result, entry = run_tiny(seed=seed)
    assert result["correct"], result["compared"]
    assert set(result["compared"]) == {
        "embed_gap", "embed_rms_gap", "logit_gap", "iou_gap",
        "keep_unexplained",
        "mask_unexplained", "nms_gap", "labels_gap"}
    assert set(result["metrics"]) == {"movie_ms", "setup_s"}
    assert list(result)[-1] == "compared"
    # The calibration gives NMS boxes of more than one size to tell apart.
    assert max(len(r.candidates) for _, r in entry.kept) > 1
    assert len({tuple(b) for _, r in entry.kept
                for b in r.candidate_boxes}) > 2


def test_traced_run_reads_the_window():
    """On the CPU the profiler sees no device: the idle and roofline
    readers find nothing; the span and host-clock ones read."""
    result, _ = run_tiny(seed=SEED, traced=True)
    assert result["correct"], result["compared"]
    assert set(result["metrics"]) == {"sam.mfu", "sam.encoder_ms",
                                      "sam.decoder_ms", "sam.post_ms"}
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_fault_is_caught(fault, monkeypatch):
    result, _ = run_tiny(seed=SEED, patch=_planted(fault, monkeypatch))
    assert not result["correct"], result["compared"]


def test_control_is_caught():
    _, entry = run_tiny(seed=SEED)
    numbers = entry.control()
    assert any(numbers[k] > v for k, v in entry.limits.items()
               if k in numbers), numbers


def test_attention_roofline_reader():
    """Every call's attention FLOPs at the bf16 peak over the kernel's
    device time; None where the trace holds no such kernel."""
    cfg = Bench(env.ROOT / "BENCHMARK.json").config("sam-vit-h-amg")
    tr = Trace(0, 10 ** 9)
    ctx = Context({"name": CELL}, cfg, {}, {"calls": 10}, tr, Spans())
    assert read_metric("sam.attn_roofline", ctx) is None
    tr.by_name["void (anonymous namespace)::attention_bf16_kernel<128>"] = 0.01
    bound = ref.attention_flops(cfg) / 989e12
    assert read_metric("sam.attn_roofline", ctx) == pytest.approx(
        100 * 10 * bound / 0.01)
    # 88 us a global block and 5.3 us a window block's 25 windows.
    assert bound == pytest.approx(4 * 88.2e-6 + 28 * 5.33e-6, rel=0.01)


@pytest.mark.parametrize("name", METRICS)
def test_reader_finds_nothing_without_spans(name, monkeypatch):
    """An untraced run, and a program without ``recorded`` and
    ``counted`` (the parent's): None, and no exception."""
    from deepcalcium_torch.utils import profiling

    cfg = Bench(env.ROOT / "BENCHMARK.json").config("sam-vit-h-amg")
    assert read_metric(name, Context({"name": CELL}, cfg, {}, {}, None,
                                     Spans())) is None
    monkeypatch.delattr(profiling, "recorded")
    monkeypatch.delattr(profiling, "counted")
    ctx = Context({"name": CELL}, cfg, {}, {}, Trace(0, 1000), Spans())
    assert read_metric(name, ctx) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env.prepare()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 102])
def test_faults_and_control_fail_on_the_card(card, seed, monkeypatch,
                                             capsys):
    """At the cell's own size: the package passes, and the fp8 control and
    each planted fault fail one of the compared numbers."""
    bench = Bench(env.ROOT / "BENCHMARK.json")
    limits = bench.limits(CELL)
    readings = {}
    result, entry = run(bench, CELL, seed, 3.0, False, "cuda",
                        time.perf_counter())
    readings["package"] = entry.numbers
    assert result["correct"], result["compared"]
    readings["fp8"] = entry.control()
    del entry
    for fault in FAULTS:
        with monkeypatch.context() as m:
            result, entry = run(bench, CELL, seed, 3.0, False, "cuda",
                                time.perf_counter(),
                                patch=_planted(fault, m))
        readings[fault.__name__[1:]] = entry.numbers
        del entry
    with capsys.disabled():
        print(f"\nsam readings seed {seed}: {json.dumps(readings)}")
    for name, numbers in readings.items():
        fails = any(numbers[k] > v for k, v in limits.items() if k in numbers)
        assert fails == (name != "package"), (name, numbers)
