"""What the two ``fit`` entries share: the warm fit of set-up, the timed
``fit`` call, and the comparison of its first steps with the reference.

Set-up makes the data and weights from the seed, builds the wrapper with a
``net_func`` that builds the stock net and loads the benchmark's weights
into it, and runs one epoch of the cell's own shapes (training, validation
and a checkpoint) to warm them. The window is one ``fit`` call of
``max(1, round(seconds / epoch_s))`` epochs, ``epoch_s`` being the
traffic's nominal epoch on the card, so that every run does the same work;
its rate counts every window trained over the whole call, its own set-up,
validation and checkpoints included. The first three steps of that call
are observed (:mod:`cardbench.harness.capture`) and followed by the
reference from the same weights, on the windows the reference samples
itself from the seed, with the keep-masks the program drew."""

import shutil
import time

import torch

from cardbench.harness import compare, env
from cardbench.harness.capture import StepCapture, Stop
from cardbench.reference import train as ref_train
from cardbench.reference.precision import QUANT

NSTEPS = 3
# A leaf counts among the large ones from this share of all the weights.
# The norm of a small leaf (the first conv's 160 weights, a BN vector of
# 32) carries the rounding of a few hundred bf16 numbers, and the worst of
# all leaves was such a leaf on most seeds, in the program's runs as in
# the control's; over the large leaves the gap is steady (PERF.md).
LARGE_LEAF = 0.02


class FitEntry:
    ref = None          # the reference module of the net
    scratch_name = None
    quick = False       # readings only: no warm fit, stop after the steps

    def __init__(self, config, traffic, seed, device, seconds):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.fit_seed = seed % 2**31
        self.nb_epochs = max(1, round(seconds / traffic["epoch_s"]))
        self.cpdir = env.scratch(self.scratch_name)
        self.capture = None
        self.counts = {}

    def net_func(self, **kw):
        """The stock net with the benchmark's weights, hooked in the timed
        call."""
        net = self.build_net(**kw)
        if self.capture is not None:
            self.capture.attach(net)
        return net

    def _clear(self):
        shutil.rmtree(self.cpdir, ignore_errors=True)
        self.cpdir.mkdir(parents=True, exist_ok=True)

    def window(self, seconds, spans):
        self._clear()
        self.capture = StepCapture(self.config["nfb"], NSTEPS, self.quick)
        t0 = time.perf_counter()
        try:
            with spans("fit"):
                self.fit(self.nb_epochs, spans)
        except Stop:
            pass
        window_s = time.perf_counter() - t0
        self.capture.remove()
        windows = self.nb_epochs * self.steps_per_epoch * self.traffic["batch"]
        self.counts = {"windows": windows, "attempted": windows,
                       "window_s": window_s,
                       "window_shape": self.window_shape,
                       "checkpoints": len(list(self.cpdir.glob("*.ckpt")))}
        return {"fit_windows_per_s": windows / window_s}

    def release(self):
        self.wrapper = None
        self._clear()

    # The reference side ------------------------------------------------
    def _reference(self, quant=None, rows=None):
        return ref_train.steps(
            self.ref.forward, self.W, self.ref_batches(), self.capture.masks,
            self.loss, self.traffic["lr"], self.config["drp"], quant=QUANT[quant],
            rows=rows, **self.fwd_kw)

    def _numbers(self, losses, grad1, change, want):
        """The compared numbers of a run (losses, first gradient, change)
        against the reference's (``want``)."""
        w_losses, w_grad1, w_change = want
        keep = compare.moving_leaves(w_grad1)
        grads = compare.leaf_gaps(grad1, w_grad1, keep)
        changes = compare.leaf_gaps(change, w_change, keep)
        self.leaves = {"grad": grads, "change": changes}
        total = sum(w_grad1[k].numel() for k in keep)
        large = [k for k in keep if w_grad1[k].numel() >= LARGE_LEAF * total]
        return {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, w_losses)),
            "grad_gap": max(grads.values()),
            "grad_gap_large": max(grads[k] for k in large),
            "change_gap": max(changes.values())}

    def compare(self):
        cap = self.capture
        if cap.step < NSTEPS or cap.params is None:
            raise RuntimeError(f"the fit ran {cap.step} observed steps, "
                               f"fewer than {NSTEPS}")
        batches = self.ref_batches()
        self._want = self._reference()
        x_gap = max(float((cap.x[s] - x).abs().max())
                    for s, (x, _) in enumerate(batches))
        losses = [float(self.loss(y, cap.probs[s]))
                  for s, (_, y) in enumerate(batches)]
        change = {k: cap.params[k] - self.W[k].float() for k in cap.params}
        out = {"window_gap": x_gap}
        out.update(self._numbers(losses, cap.grad1, change, self._want))
        return out

    def control(self):
        """The reference in fp8 put in the program's place."""
        return self._numbers(*self._reference(quant="fp8"), self._want)

    def half_batch(self):
        """The reference with half of each batch left out of the mean."""
        return self._numbers(
            *self._reference(rows=self.traffic["batch"] // 2), self._want)

    def ref_batches(self):
        if getattr(self, "_batches", None) is None:
            self._batches = [
                (torch.from_numpy(x).to(self.device),
                 torch.from_numpy(y).to(self.device))
                for x, y in self.sample_batches(NSTEPS)]
        return self._batches
