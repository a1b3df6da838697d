"""``UNet2DSummary.evaluate_movie`` in a closed loop with one caller: a
movie on the card to its mask, one movie after another, as a lab runs the
main path.

Set-up makes a pool of int16 movies on the card (the traffic's fixed set
of lengths and neuron counts, in an order and with a content of the
seed's), the weights, and the wrapper; it warms every movie once. The
window calls ``evaluate_movie(movie, params=, state=, ...)`` on the pool
in an order of the seed's in which no movie follows itself, until
``seconds`` have passed, and keeps every call's mask and probability map.
The comparison holds every call's output against the reference's
evaluation of its movie."""

import time

import numpy as np
import torch

from cardbench.harness import compare, synth, weights
from cardbench.reference import unet2ds as ref
from cardbench.reference.precision import QUANT, exact_fp32


def call_order(n, rng):
    """Endless pool indices: permutation after permutation, no index
    twice in a row."""
    last = None
    while True:
        perm = list(rng.permutation(n))
        if perm[0] == last and n > 1:
            perm[0], perm[1] = perm[1], perm[0]
        yield from perm
        last = perm[-1]


class Entry:
    def __init__(self, config, traffic, seed, device, seconds):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.counts = {}

    def setup(self):
        from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary

        tr, dev = self.traffic, self.device
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        lengths = synth.spread(tr["lengths"], rng)
        neurons = synth.spread(tr["neurons"], rng)
        self.movies = []
        for t, n in zip(lengths, neurons):
            masks = synth.neuron_masks(rng, tr["frame"], n)
            self.movies.append(synth.calcium_movie(masks, t, gen, dev))
        calib = []
        for movie in self.movies[:2]:
            m = ref.movie_mean(movie).double()
            z = ((m - m.mean()) / m.std(correction=0)).float()
            calib += [fwd(z) for fwd, _ in ref.VIEWS]
        self.params, self.state, self.W = weights.make(
            self.config, self.seed, dev, torch.stack(calib))
        self.wrapper = UNet2DSummary(compute_dtype=getattr(
            torch, self.config["compute_dtype"]), device=dev)
        self.order = call_order(len(self.movies), rng)
        for i in range(len(self.movies)):
            self._call(i)

    def _call(self, i):
        tr = self.traffic
        return self.wrapper.evaluate_movie(
            self.movies[i], params=self.params, state=self.state,
            window_shape=tuple(tr["window"]), tta=tr["tta"],
            threshold=tr["threshold"], fast=tr["fast"])

    def window(self, seconds, spans):
        self.outputs, lat = [], []
        t0 = time.perf_counter()
        while True:
            i = next(self.order)
            t = time.perf_counter()
            with spans("evaluate_movie"):
                mask, prob = self._call(i)
            lat.append(time.perf_counter() - t)
            self.outputs.append((i, mask, prob))
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        n = len(lat)
        self.counts = {"calls": n, "window_s": window_s,
                       "frames": [self.movies[i].shape[0]
                                  for i, _, _ in self.outputs],
                       "frame_hw": list(self.traffic["frame"])}
        return {"movie_ms": window_s * 1e3 / n,
                "movie_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def release(self):
        self.wrapper = None

    def _reference(self, quant=None, views=8):
        tr = self.traffic
        out = []
        with exact_fp32():
            for movie in self.movies:
                mask, prob = ref.evaluate_mean(
                    self.W, ref.movie_mean(movie), tr["window"],
                    tr["threshold"], tr["tta"], quant=QUANT[quant],
                    drp=self.config["drp"], views=views)
                out.append((mask.cpu().numpy(), prob.cpu().numpy()))
        return out

    def compare(self):
        """Every call's probability map and mask against the reference's
        evaluation of its movie."""
        self._want = self._reference()
        return self._numbers([(m, p, i) for i, m, p in self.outputs])

    def _numbers(self, outputs):
        """(mask, prob, pool index) of each answer against the reference's
        answer for its movie."""
        want, thr = self._want, self.traffic["threshold"]
        margin = self.limits["prob_gap"]
        return {"prob_gap": max(compare.prob_gap(p, want[i][1])
                                for m, p, i in outputs),
                "mask_unexplained": sum(compare.unexplained_flips(
                    m, want[i][1], thr, margin) for m, p, i in outputs),
                "mask_flip": max(compare.flip_margin(m, want[i][1], thr)
                                 for m, p, i in outputs)}

    def control(self):
        """The numbers of the reference in fp8 put in the package's place."""
        return self._against(self._reference("fp8"))

    def half_batch(self):
        """The numbers of the reference that averages half of the views."""
        return self._against(self._reference(views=4))

    def _against(self, low):
        return self._numbers([(m, p, i) for i, (m, p) in enumerate(low)])
