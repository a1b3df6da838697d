"""``UNet1DSegmentation.fit`` at its defaults (one step a dispatch,
random split 80/20, wbce with pos=2, margin 4), on synthetic spike traces
fed through the wrapper's accessors."""

import numpy as np
import torch

from cardbench.harness import synth, weights
from cardbench.harness.fitbase import FitEntry
from cardbench.reference import data, unet1d


class Entry(FitEntry):
    ref = unet1d
    scratch_name = "fit_spikes"

    def setup(self):
        from deepcalcium_torch.models.unet_1d_segmentation import \
            UNet1DSegmentation

        tr, dev = self.traffic, self.device
        rng = np.random.default_rng(self.seed)
        self.traces, self.spikes = synth.spike_traces(rng, tr["traces"],
                                                      tr["length"])
        w = tr["window"]
        calib = torch.from_numpy(self.traces[:64, :w]).to(dev)
        self.params, self.state, self.W = weights.make(
            self.config, self.seed, dev, calib)
        self.window_shape = (w,)
        n_trn = int(tr["traces"] * tr["prop_trn"])
        self.steps_per_epoch = -(-n_trn // tr["batch"])
        self.loss = unet1d.wbce
        self.fwd_kw = {"margin": self.config["margin"]}
        self.wrapper = UNet1DSegmentation(
            cpdir=str(self.cpdir), dataset_attrs_func=lambda n: {"name": n},
            dataset_traces_func=lambda n: self.traces,
            dataset_spikes_func=lambda n: self.spikes,
            net_func=self.net_func,
            compute_dtype=getattr(torch, self.config["compute_dtype"]),
            init_params=(self.params, self.state), device=dev)
        if not self.quick:
            self.fit(1, None)

    def build_net(self, **kw):
        from deepcalcium_torch.models.unet1d import UNet1D

        return UNet1D(nfb=self.config["nfb"], **kw)

    def fit(self, nb_epochs, spans):
        tr = self.traffic
        self.wrapper.fit(
            ["spikes"], shape=self.window_shape,
            error_margin=self.config["margin"], batch=tr["batch"],
            nb_epochs=nb_epochs, prop_trn=tr["prop_trn"],
            prop_val=round(1.0 - tr["prop_trn"], 12),
            learning_rate=tr["lr"], seed=self.fit_seed)

    def sample_batches(self, n):
        tr = self.traffic
        trn, _ = data.spike_split(tr["traces"], tr["prop_trn"], self.fit_seed)
        return data.spike_windows([self.traces[i] for i in trn],
                                  [self.spikes[i] for i in trn],
                                  self.window_shape[0], tr["batch"],
                                  self.config["margin"], n, self.fit_seed)
