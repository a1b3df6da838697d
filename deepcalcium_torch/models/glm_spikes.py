"""GLM/STM spike inference: the classical baselines that take the C2S slot.

Port of ``deepcalcium_tpu.models.glm_spikes``. Two models infer spikes from
calcium traces without a deep net:

- ``arch="glm"``: a convolutional generalized linear model,
  ``p(spike_t) = sigmoid(w . x[t-k..t+k] + b)``: one temporal filter, a
  SAME cross-correlation, weighted logistic regression (wbce, pos=2);
- ``arch="stm"``: the Spike-Triggered Mixture of c2s: K shared quadratic
  features and L components with an exponential nonlinearity,

      log-rate(x_t) = logsumexp_l [ sum_k beta_lk (u_k . x_t)^2 + w_l . x_t + a_l ]

  trained by Poisson maximum likelihood on the margin-pooled spike bins;
  ``stm_apply`` gives P(>= 1 spike) = 1 - exp(-rate), ``predict_rates``
  the rates.

Parameters are dicts of float32 tensors keyed as the JAX package's
(``w``, ``b`` with ``b`` 0-d; ``U``, ``W``, ``beta``, ``a``), so
checkpoints are the same files in both packages. Training is full-batch
Adam on the device, every trace padded to the longest and the loss masked.
"""

import logging
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from deepcalcium_torch.models.unet_1d_segmentation import (
    get_dataset_attrs, get_dataset_spikes, get_dataset_traces, maxpool_labels)
from deepcalcium_torch.ops import losses as L
from deepcalcium_torch.train.checkpoints import read_checkpoint, save_checkpoint
from deepcalcium_torch.train.trainer import ADAM_BETAS, ADAM_EPS
from deepcalcium_torch.utils.config import checkpoints_dir
from deepcalcium_torch.utils.device import require_cuda

__all__ = ["GLMSegmentation", "glm_init", "glm_apply", "stm_init",
           "stm_apply", "stm_log_rate", "stm_poisson_nll"]

_LOG_RATE_CLIP = (-30.0, 15.0)


def glm_init(generator: torch.Generator, filter_len: int = 41):
    """GLM params drawn on the CPU: ``w`` ~ N(0, 0.01^2), ``b`` = 0 (0-d)."""
    if filter_len % 2 != 1:
        raise ValueError("temporal filter length must be odd")
    return {"w": torch.randn(filter_len, generator=generator) * 0.01,
            "b": torch.zeros(())}


def _conv_filters(traces, filters):
    """(R, T) traces x (K, F) filter bank -> (R, F, T) SAME
    cross-correlation, float32."""
    w = filters.float().T[:, None, :]                        # (F, 1, K)
    return F.conv1d(traces.float()[:, None], w, padding=w.shape[-1] // 2)


def glm_apply(params, traces):
    """(R, T) traces -> (R, T) spike probabilities."""
    y = _conv_filters(traces, params["w"][:, None])[:, 0]
    return torch.sigmoid(y + params["b"])


def stm_init(generator: torch.Generator, filter_len: int = 41,
             nb_quad: int = 2, nb_components: int = 3):
    """STM params drawn on the CPU: quadratic features ``U`` (K, F=nb_quad),
    linear filters ``W`` (K, L=nb_components), quadratic weights ``beta``
    (F, L), biases ``a`` (L,) = -2."""
    if filter_len % 2 != 1:
        raise ValueError("temporal filter length must be odd")
    return {
        "U": torch.randn(filter_len, nb_quad, generator=generator) * 0.05,
        "W": torch.randn(filter_len, nb_components, generator=generator) * 0.05,
        "beta": torch.randn(nb_quad, nb_components, generator=generator) * 0.05,
        "a": torch.full((nb_components,), -2.0),
    }


def stm_log_rate(params, traces):
    """(R, T) traces -> (R, T) log Poisson rate."""
    qu = _conv_filters(traces, params["U"])                 # (R, F, T)
    li = _conv_filters(traces, params["W"])                 # (R, L, T)
    z = (torch.einsum("rkt,kl->rlt", qu * qu, params["beta"]) + li
         + params["a"][:, None])
    return torch.logsumexp(z, dim=1)


def _rate(log_rate):
    return torch.exp(torch.clamp(log_rate, *_LOG_RATE_CLIP))


def stm_apply(params, traces):
    """(R, T) traces -> (R, T) P(>= 1 spike) = 1 - exp(-rate)."""
    return 1.0 - torch.exp(-_rate(stm_log_rate(params, traces)))


def stm_poisson_nll(params, traces, spikes):
    """Mean Poisson negative log-likelihood, rate - y * log(rate)."""
    lr = stm_log_rate(params, traces)
    return torch.mean(_rate(lr) - spikes * lr)


class GLMSegmentation:
    """Classical spike-inference wrapper (fit / predict), the C2S slot.

    # Arguments
        cpdir: checkpoint directory (created); None means
            ``<checkpoints_dir>/spikes_<arch>``.
        filter_len: odd temporal filter length.
        arch: "glm" (the one-filter logistic model) or "stm" (the quadratic
            mixture with a Poisson likelihood).
        nb_quad, nb_components: the STM's quadratic features and mixture
            components.
        dataset_attrs_func, dataset_traces_func, dataset_spikes_func: as in
            ``UNet1DSegmentation``.
        device: where the model trains and predicts; "cuda" (the default)
            raises without a card. Pass "cpu" to run on the CPU on purpose.
    """

    def __init__(self, cpdir=None, filter_len: int = 41, arch: str = "glm",
                 nb_quad: int = 2, nb_components: int = 3,
                 dataset_attrs_func=get_dataset_attrs,
                 dataset_traces_func=get_dataset_traces,
                 dataset_spikes_func=get_dataset_spikes, device="cuda"):
        if arch not in ("glm", "stm"):
            raise ValueError(f"arch={arch!r}: expected 'glm' or 'stm'")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            require_cuda()
        self.cpdir = cpdir or os.path.join(checkpoints_dir(), f"spikes_{arch}")
        os.makedirs(self.cpdir, exist_ok=True)
        self.filter_len = filter_len
        self.arch = arch
        self.nb_quad = nb_quad
        self.nb_components = nb_components
        self.dataset_attrs_func = dataset_attrs_func
        self.dataset_traces_func = dataset_traces_func
        self.dataset_spikes_func = dataset_spikes_func

    def _init(self, seed: int):
        """Fresh params from ``seed``, drawn on the CPU."""
        g = torch.Generator().manual_seed(seed)
        if self.arch == "stm":
            return stm_init(g, self.filter_len, self.nb_quad, self.nb_components)
        return glm_init(g, self.filter_len)

    def _apply(self, params, traces):
        return (stm_apply if self.arch == "stm" else glm_apply)(params, traces)

    def _to_device(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def fit(self, dataset_paths, error_margin=4, nb_epochs=200,
            learning_rate=1e-2, prop_trn=0.8, seed=865):
        """Full-batch Adam on the device; returns (metrics_trn,
        metrics_val, checkpoint_path). Datasets may hold traces of
        different lengths: all are padded to the longest, and a mask keeps
        the padding out of the loss and the metrics."""
        logger = logging.getLogger(__name__)
        if nb_epochs < 1:
            raise ValueError(f"nb_epochs={nb_epochs} must be >= 1")
        tr_list = [self.dataset_traces_func(p) for p in dataset_paths]
        sp_list = [self.dataset_spikes_func(p) for p in dataset_paths]
        tmax = max(t.shape[1] for t in tr_list)

        def padT(a):
            return np.pad(a, ((0, 0), (0, tmax - a.shape[1])))

        traces = np.concatenate([padT(t) for t in tr_list])
        spikes = np.concatenate([padT(s) for s in sp_list])
        mask = np.concatenate(
            [np.pad(np.ones(t.shape, np.float32),
                    ((0, 0), (0, tmax - t.shape[1]))) for t in tr_list])
        spikes = maxpool_labels(spikes, int(error_margin))

        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(traces))
        n_trn = int(len(idx) * prop_trn)
        if n_trn == 0 or n_trn == len(idx):
            raise ValueError(
                f"prop_trn={prop_trn} with {len(idx)} traces leaves an "
                f"empty split (train={n_trn}, val={len(idx) - n_trn}) — "
                f"training on a (0, T) batch yields NaN silently")
        trn, val = idx[:n_trn], idx[n_trn:]
        xt, yt, mt_ = (self._to_device(a[trn]) for a in (traces, spikes, mask))

        params = {k: v.to(self.device).requires_grad_()
                  for k, v in self._init(seed).items()}
        opt = torch.optim.Adam(params.values(), lr=learning_rate,
                               betas=ADAM_BETAS, eps=ADAM_EPS)
        arch = self.arch
        msum = mt_.sum()
        loss = None
        t0 = time.perf_counter()
        for _ in range(nb_epochs):
            if arch == "stm":
                lr = stm_log_rate(params, xt)
                elt = _rate(lr) - yt * lr
            else:
                elt = L.weighted_binary_crossentropy(yt, glm_apply(params, xt),
                                                     weightpos=2.0)
            loss = torch.sum(elt * mt_) / msum
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        loss = float(loss.detach())  # waits for the device
        epoch_ms = (time.perf_counter() - t0) * 1e3 / nb_epochs
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"{arch} training diverged: final loss {loss} "
                f"(same NaN sanitizer contract as the deep fits)")
        logger.info("%s trained: final loss %.4f, %.3f ms a full-batch epoch",
                    arch.upper(), loss, epoch_ms)
        params = {k: v.detach() for k, v in params.items()}

        @torch.no_grad()
        def metrics(rows):
            x, y, m = (self._to_device(a[rows]) for a in (traces, spikes, mask))
            probs = self._apply(params, x)
            # Zero label and prediction in the padding: true negatives,
            # which none of the spike metrics count.
            return {k: float(fn(y * m, probs * m).mean())
                    for k, fn in L.SPIKE_METRICS.items()}

        mt, mv = metrics(trn), metrics(val)
        path = os.path.join(self.cpdir, f"{int(time.time())}_{arch}.ckpt")
        save_checkpoint(path, params, {},
                        meta={"val_F2": mv["F2"], "arch": arch})
        for k in sorted(mt):
            logger.info("%-10s trn=%-9.4f val=%-9.4f", k, mt[k], mv[k])
        return mt, mv, path

    def _load(self, model_path):
        ckpt = read_checkpoint(model_path)
        meta = ckpt["meta"]
        if meta.get("arch", self.arch) != self.arch:
            raise ValueError(
                f"checkpoint arch {meta['arch']!r} != wrapper arch "
                f"{self.arch!r} — construct GLMSegmentation(arch=...) to "
                f"match")
        want = self._init(0)
        if set(ckpt["params"]) != set(want):
            raise ValueError(f"checkpoint params {sorted(ckpt['params'])} are "
                             f"not the {self.arch} params {sorted(want)}")
        return {k: torch.from_numpy(np.asarray(v, np.float32)).to(self.device)
                for k, v in ckpt["params"].items()}

    @torch.no_grad()
    def predict(self, dataset_paths, model_path, threshold=0.5):
        """(list of (R, T) uint8 spike masks, names)."""
        params = self._load(model_path)
        preds, names = [], []
        for p in dataset_paths:
            names.append(self.dataset_attrs_func(p)["name"])
            probs = self._apply(params, self._to_device(
                self.dataset_traces_func(p))).cpu().numpy()
            preds.append((probs > threshold).astype(np.uint8))
        return preds, names

    @torch.no_grad()
    def predict_rates(self, dataset_paths, model_path):
        """STM only: (list of (R, T) float32 Poisson spike rates, names),
        the c2s prediction contract (expected spikes per time bin)."""
        if self.arch != "stm":
            raise ValueError("predict_rates needs arch='stm' (the GLM is a "
                             "probability model, use predict)")
        params = self._load(model_path)
        rates, names = [], []
        for p in dataset_paths:
            names.append(self.dataset_attrs_func(p)["name"])
            lr = stm_log_rate(params, self._to_device(self.dataset_traces_func(p)))
            rates.append(_rate(lr).cpu().numpy())
        return rates, names
