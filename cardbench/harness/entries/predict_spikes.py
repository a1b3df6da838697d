"""``UNet1DSegmentation.predict([dataset], model_path, batch=)`` in a
closed loop with one caller: full-length spike masks of every trace of a
dataset, one dataset after another, from a checkpoint on disk, as a lab
runs spike inference.

Set-up makes a pool of host datasets (z-normalised traces, as the default
accessor returns them) and writes the weights as a ``.ckpt`` under
``$TMPDIR``; it warms every dataset once. The window calls ``predict`` on
the pool in an order of the seed's in which no dataset follows itself,
until ``seconds`` have passed, and keeps every call's masks (bit-packed).
The comparison holds every call's masks against the reference's
prediction of its dataset."""

import time

import numpy as np
import torch

from cardbench.harness import compare, env, synth, weights
from cardbench.harness.entries.evaluate_movie import call_order
from cardbench.reference import unet1d as ref
from cardbench.reference.precision import QUANT, exact_fp32


class Entry:
    def __init__(self, config, traffic, seed, device, seconds):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.counts = {}

    def setup(self):
        from deepcalcium_torch.models.unet_1d_segmentation import \
            UNet1DSegmentation
        from deepcalcium_torch.train.checkpoints import save_checkpoint

        tr, dev = self.traffic, self.device
        rng = np.random.default_rng(self.seed)
        self.names = [f"spikes{i}" for i in range(tr["pool"])]
        self.pool = {n: synth.spike_traces(rng, tr["traces"], tr["length"])[0]
                     for n in self.names}
        w = min(self.config["window"], tr["length"] // 16 * 16)
        calib = torch.from_numpy(self.pool[self.names[0]][:64, :w]).to(dev)
        params, state, self.W = weights.make(self.config, self.seed, dev,
                                             calib)
        scratch = env.scratch("predict_spikes")
        self.ckpt = str(scratch / "model.ckpt")
        save_checkpoint(self.ckpt, params, state)
        self.wrapper = UNet1DSegmentation(
            cpdir=str(scratch), dataset_attrs_func=lambda n: {"name": n},
            dataset_traces_func=self.pool.__getitem__,
            dataset_spikes_func=lambda n: None,
            compute_dtype=getattr(torch, self.config["compute_dtype"]),
            device=dev)
        self.order = call_order(len(self.names), rng)
        for i in range(len(self.names)):
            self._call(i)

    def _call(self, i):
        tr = self.traffic
        masks, _ = self.wrapper.predict(
            [self.names[i]], self.ckpt, batch=tr["batch"],
            threshold=tr["threshold"], error_margin=self.config["margin"],
            fast=tr["fast"])
        return masks[0]

    def window(self, seconds, spans):
        self.outputs = []
        t0 = time.perf_counter()
        while True:
            i = next(self.order)
            with spans("predict"):
                mask = self._call(i)
            self.outputs.append((i, np.packbits(mask.astype(bool), axis=-1)))
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        n = len(self.outputs)
        samples = n * self.traffic["traces"] * self.traffic["length"]
        self.counts = {"calls": n, "samples": samples, "window_s": window_s}
        return {"spike_samples_per_s": samples / window_s}

    def release(self):
        self.wrapper = None

    def _reference(self, quant=None):
        out = []
        with exact_fp32():
            for name in self.names:
                x = torch.from_numpy(self.pool[name]).to(self.device)
                mask, z = ref.predict(self.W, x, margin=self.config["margin"],
                                      threshold=self.traffic["threshold"],
                                      quant=QUANT[quant])
                out.append((mask.cpu().numpy(), z.cpu().numpy()))
        return out

    def compare(self):
        """Every call's masks against the reference's prediction of its
        dataset."""
        self._want = self._reference()
        t = self.traffic["length"]
        return self._numbers([(np.unpackbits(m, axis=-1, count=t), i)
                              for i, m in self.outputs])

    def _numbers(self, outputs):
        """Each (mask, pool index) against the reference's prediction: the
        share of samples that disagree, and the widest distance from the
        threshold, in logit units, of the reference at a sample that
        disagrees."""
        thr = self.traffic["threshold"]
        z_thr = float(np.log(thr / (1.0 - thr)))
        return {"spike_flip_share": max(
                    compare.flip_share(m, self._want[i][0], 0.5)
                    for m, i in outputs),
                "spike_flip_logit": max(
                    compare.flip_margin(m, self._want[i][1] - z_thr, 0.0)
                    for m, i in outputs)}

    def control(self):
        """The numbers of the reference in fp8 put in the program's place."""
        return self._numbers([(m, i) for i, (m, _) in
                              enumerate(self._reference("fp8"))])
