"""``UNet2DSummary.fit`` at its default dispatch (one step a dispatch),
on synthetic Neurofinder-like datasets fed through the wrapper's
``series_summary_func`` and ``mask_summary_func``: z-normalised mean
images made from the seed (as the default accessor reads a stored mean),
and the neuron mask stacks, which the package's exact mask summary turns
into targets inside every ``fit`` call, as the default accessor does."""

import time

import numpy as np
import torch

from cardbench.harness import synth, weights
from cardbench.harness.fitbase import FitEntry
from cardbench.reference import data, unet2ds


class Entry(FitEntry):
    ref = unet2ds
    scratch_name = "fit_neurons"

    def setup(self):
        from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary
        from deepcalcium_torch.ops.mask_summary import mask_summary_exact

        tr, dev = self.traffic, self.device
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.names = [f"nf{i:02d}" for i in range(len(tr["neurons"]))]
        self.masks, self.series = {}, {}
        for name, n in zip(self.names, synth.spread(tr["neurons"], rng)):
            self.masks[name] = synth.neuron_masks(rng, tr["frame"], n)
            self.series[name] = synth.summary_image(self.masks[name],
                                                    tr["frames"], gen, dev)
        calib = [fwd(torch.from_numpy(self.series[n]).to(dev))
                 for n in self.names[:2] for fwd, _ in unet2ds.VIEWS]
        self.params, self.state, self.W = weights.make(
            self.config, self.seed, dev, torch.stack(calib))
        self.window_shape = tuple(tr["train_window"])
        self.steps_per_epoch = tr["steps"]
        self.loss = unet2ds.bce
        self.fwd_kw = {}
        self.wrapper = UNet2DSummary(
            cpdir=str(self.cpdir), dataset_name_func=lambda n: n,
            series_summary_func=self.series.__getitem__,
            mask_summary_func=lambda n: mask_summary_exact(self.masks[n]),
            net_func=self.net_func,
            compute_dtype=getattr(torch, self.config["compute_dtype"]),
            device=dev)
        if not self.quick:
            self.fit(1, None)

    def build_net(self, **kw):
        from deepcalcium_torch.models.unet2d import UNet2DS, load_jax_params_

        return load_jax_params_(UNet2DS(nfb=self.config["nfb"], **kw),
                                self.params, self.state)

    def fit(self, nb_epochs, spans):
        tr = self.traffic
        marks = []

        def epoch_end(epoch, logs):
            if spans is not None:
                now = time.time_ns()
                spans.add("fit.epoch", marks[-1] if marks else t0, now)
                marks.append(now)

        t0 = time.time_ns()
        self.wrapper.fit(
            self.names, shape_trn=self.window_shape,
            shape_val=tuple(tr["val_window"]), batch_size_trn=tr["batch"],
            nb_steps_trn=tr["steps"], nb_epochs=nb_epochs,
            prop_trn=tr["prop_trn"], prop_val=tr["prop_val"],
            learning_rate=tr["lr"], seed=self.fit_seed,
            epoch_callbacks=[epoch_end])

    def sample_batches(self, n):
        tr = self.traffic
        S = [self.series[k] for k in self.names]
        M = [data.mask_summary(self.masks[k]) for k in self.names]
        bands = [(0, int(s.shape[0] * tr["prop_trn"])) for s in S]
        return data.neuron_windows(S, M, bands, self.window_shape,
                                   tr["batch"], n, tr["nb_max_augment"],
                                   self.fit_seed)
