"""``CellposeSummary.evaluate_movie`` in a closed loop with one caller: a
movie on the card to Cellpose-SAM's instance labels, one movie after
another, as a lab runs Cellpose on the mean image of every recording.

Set-up makes the pool of ``evaluate_movie``'s cell (the traffic's lengths
and neuron counts, in an order and with a content of the seed's), the
weights (random from the seed; the readout calibrated, below), and the
wrapper, which builds the net on the card once; it warms every movie
once. The window calls ``evaluate_movie(movie)`` on the pool in an order
of the seed's in which no movie follows itself, until ``seconds`` have
passed, and keeps every call's labels and flows.

The readout ``out`` is the float32 reference's ridge least-squares fit,
on every tile of the pool, from the neck's features to Cellpose's own
training targets of the pool's neurons (5 x the diffused flows, cellprob
+3 inside a neuron, -3 outside), so that the dynamics run on flows that
point into neurons, at a realistic foreground share.

The comparison holds every call's blended flows against the reference's
float32 net on the same tiles (``flow_gap``, and ``fg_unexplained``, the
foreground pixels that differ where the reference's cellprob lies farther
than the ``flow_gap`` limit from 0), and the call's labels against the
reference's dynamics on the call's own flows (``labels_gap``: pixels
whose labels differ after a one-to-one matching of the labels). Calls of
one movie with bitwise equal outputs are compared once."""

import time

import numpy as np
import torch
import torch.nn.functional as F

from cardbench.harness import synth
from cardbench.harness.entries.evaluate_movie import call_order
from cardbench.reference import cellpose_sam as ref
from cardbench.reference import flows as ref_flows
from cardbench.reference.precision import QUANT, exact_fp32
from cardbench.reference.unet2ds import movie_mean

RIDGE = 1e-2  # the ridge over the mean diagonal of the features' Gram
# The relative-position tables' std. At 0.02 the bias moved the float32
# reference's flows by at most 0.08 on the card (seed 101), under the
# bf16 package's own gap of 0.25, so that a net without it could not be
# told apart; at 0.2 it moves them by 0.99.
REL_POS_STD = 0.2


def make_weights(cfg, seed, device):
    """The published state dict's float32 tensors on ``device`` from the
    seed, the readout left at zero (the calibration sets it): kernels
    N(0, 1/fan_in) clipped at 2 sigma, ``attn.proj`` and ``mlp.lin2``
    scaled by 1/sqrt(2 depth), biases and the positional table
    N(0, 0.02), the tables N(0, ``REL_POS_STD``), LayerNorms 1 + N(0, 0.1)
    and N(0, 0.1)."""
    shapes = ref.leaves(cfg)
    total = sum(int(np.prod(s)) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    scale_out = (2 * cfg["depth"]) ** -0.5
    W, i = {}, 0
    for key, shape in shapes:
        n = int(np.prod(shape))
        v = z[i:i + n].view(shape)
        i += n
        norm = "norm" in key or key.startswith(("encoder.neck.1",
                                                "encoder.neck.3"))
        if key.startswith("out."):
            v = torch.zeros_like(v)
        elif norm:
            v = v * 0.1 + (1.0 if key.endswith("weight") else 0.0)
        elif "rel_pos" in key:
            v = v * REL_POS_STD
        elif "pos_embed" in key or key.endswith("bias"):
            v = v * 0.02
        else:
            v = v * (np.prod(shape[1:]) ** -0.5)
            if key.endswith(("attn.proj.weight", "mlp.lin2.weight")):
                v = v * scale_out
        W[key] = v.contiguous()
    return W


def instance_labels(masks):
    """(H, W) int64 labels of (n, H, W) neuron masks, a later neuron over
    an earlier where they overlap."""
    k = np.arange(1, masks.shape[0] + 1)[:, None, None]
    return (masks.astype(np.int64) * k).max(axis=0)


def targets(labels, device="cpu"):
    """Cellpose's training targets of an instance image: (3, H, W) float32
    5 x the diffused flows and cellprob +3 inside, -3 outside."""
    mu, _ = ref_flows.masks_to_flows(labels, device)
    prob = np.where(labels > 0, 3.0, -3.0)[None]
    return np.concatenate([5 * mu, prob]).astype(np.float32)


def match_gap(a, b):
    """Pixels whose labels differ between two label images after a
    one-to-one matching of their labels, greatest overlap first."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    both = (a > 0) & (b > 0)
    pairs, counts = np.unique(np.stack([a[both], b[both]]), axis=1,
                              return_counts=True)
    used_a, used_b, agree = set(), set(), 0
    for k in np.argsort(-counts, kind="stable"):
        i, j = int(pairs[0, k]), int(pairs[1, k])
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            agree += int(counts[k])
    agree += int(np.count_nonzero((a == 0) & (b == 0)))
    return a.size - agree


class Entry:
    def __init__(self, config, traffic, seed, device, seconds):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.counts = {}

    def setup(self):
        from deepcalcium_torch.models.cellpose_summary import CellposeSummary

        cfg, tr, dev = self.config, self.traffic, self.device
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        lengths = synth.spread(tr["lengths"], rng)
        neurons = synth.spread(tr["neurons"], rng)
        self.movies, self.labels = [], []
        for t, n in zip(lengths, neurons):
            masks = synth.neuron_masks(rng, tr["frame"], n)
            self.movies.append(synth.calcium_movie(masks, t, gen, dev))
            self.labels.append(instance_labels(masks))
        self.W = make_weights(cfg, self.seed, dev)
        self._calibrate()
        self.wrapper = CellposeSummary(
            params={k: v.cpu().numpy() for k, v in self.W.items()},
            config=cfg, compute_dtype=getattr(torch, cfg["compute_dtype"]),
            device=dev)
        self.tiles_per_call = len(self._feats[0][0])
        self.order = call_order(len(self.movies), rng)
        for i in range(len(self.movies)):
            self._call(i)

    def _features(self, quant=None):
        """Per movie (corners, the reference's neck features of each tile)."""
        cfg, ev = self.config, self.config["eval"]
        out = []
        with torch.no_grad(), exact_fp32():
            for movie in self.movies:
                img = ref.normalize99(movie_mean(movie))
                corners, x = ref.tiles(img, cfg, ev["tile_overlap"])
                out.append((corners, [ref.features(self.W, x[i:i + 1], cfg,
                                                   quant)
                                      for i in range(len(corners))]))
        return out

    def _calibrate(self):
        """``out`` fitted by ridge least squares, in float64, from every
        tile's neck features to the pool's targets."""
        cfg, p = self.config, self.config["patch"]
        t = cfg["tile"]
        self._feats = self._features()
        gram = xty = None
        for (corners, feats), labels in zip(self._feats, self.labels):
            target = torch.from_numpy(targets(labels, self.device)).to(
                self.device)
            for (y, x), f in zip(corners, feats):
                xs = f[0].flatten(1).T.double()
                xs = torch.cat([xs, torch.ones_like(xs[:, :1])], dim=1)
                ys = F.pixel_unshuffle(target[None, :, y:y + t, x:x + t], p)
                ys = ys[0].flatten(1).T.double()
                gram = xs.T @ xs if gram is None else gram + xs.T @ xs
                xty = xs.T @ ys if xty is None else xty + xs.T @ ys
        d = gram.shape[0] - 1
        reg = torch.zeros_like(gram)
        reg[:d, :d] = torch.eye(d, dtype=gram.dtype, device=gram.device) * (
            RIDGE * gram.diagonal()[:d].mean())
        fit = torch.linalg.solve(gram + reg, xty)
        self.W["out.weight"] = fit[:d].T.float().reshape(-1, d, 1, 1
                                                        ).contiguous()
        self.W["out.bias"] = fit[d].float().contiguous()

    def _call(self, i):
        ev = self.config["eval"]
        return self.wrapper.evaluate_movie(
            self.movies[i], tile=self.config["tile"],
            tile_overlap=ev["tile_overlap"], batch_size=ev["batch_size"],
            niter=ev["niter"], cellprob_threshold=ev["cellprob_threshold"],
            flow_threshold=ev["flow_threshold"], min_size=ev["min_size"],
            max_size_fraction=ev["max_size_fraction"])

    def window(self, seconds, spans):
        self.outputs, lat = [], []
        t0 = time.perf_counter()
        while True:
            i = next(self.order)
            t = time.perf_counter()
            with spans("evaluate_movie"):
                labels, flows = self._call(i)
            lat.append(time.perf_counter() - t)
            self.outputs.append((i, labels, flows))
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        n = len(lat)
        self.counts = {"calls": n, "window_s": window_s,
                       "frames": [self.movies[i].shape[0]
                                  for i, _, _ in self.outputs],
                       "frame_hw": list(self.traffic["frame"]),
                       "tiles": n * self.tiles_per_call}
        return {"movie_ms": window_s * 1e3 / n,
                "movie_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def release(self):
        self.wrapper = None

    def _reference_flows(self, feats, quant=None):
        """Per movie the reference's blended flows from its features."""
        cfg = self.config
        out = []
        with torch.no_grad(), exact_fp32():
            for movie, (corners, fs) in zip(self.movies, feats):
                outs = torch.cat([ref.readout(self.W, f, cfg, quant)
                                  for f in fs])
                out.append(ref.blend(outs, corners, movie.shape[1:], cfg)
                           .cpu().numpy())
        return out

    def compare(self):
        """Every call's flows and labels against the reference."""
        self._want = self._reference_flows(self._feats)
        distinct = []
        for i, labels, flows in self.outputs:
            if not any(j == i and np.array_equal(labels, la)
                       and np.array_equal(flows, fl)
                       for j, la, fl in distinct):
                distinct.append((i, labels, flows))
        nums = self._numbers([(i, fl) for i, _, fl in distinct])
        ev = self.config["eval"]
        nums["labels_gap"] = max(match_gap(labels, ref_flows.compute_masks(
            flows, ev["niter"], ev["cellprob_threshold"],
            ev["flow_threshold"], ev["min_size"], ev["max_size_fraction"],
            self.device)) for _, labels, flows in distinct)
        return nums

    def _numbers(self, outputs):
        """``flow_gap`` and ``fg_unexplained`` of (pool index, flows)
        pairs against the reference's flows of their movies."""
        margin = self.limits["flow_gap"]
        gap, unexplained = 0.0, 0
        for i, fl in outputs:
            want = self._want[i]
            gap = max(gap, float(np.max(np.abs(fl.astype(np.float64)
                                               - want))))
            off = (fl[2] > 0) != (want[2] > 0)
            unexplained += int(np.count_nonzero(off & (np.abs(want[2])
                                                       > margin)))
        return {"flow_gap": gap, "fg_unexplained": unexplained}

    def control(self):
        """The numbers of the reference in fp8 put in the package's place."""
        fp8 = QUANT["fp8"]
        low = self._reference_flows(self._features(fp8), fp8)
        return self._numbers(list(enumerate(low)))
