"""UNet1DSegmentation: the spike-segmentation wrapper (fit, predict).

Port of ``deepcalcium_tpu.models.unet_1d_segmentation``: the HDF5 contract
(``traces`` / ``spikes`` and the attribute ``name``), per-trace
z-normalisation, margin max-pooling of the labels, random-split and k-fold
fits with wbce(pos=2) and the 5 spike metrics, best-on-val_F2 checkpoints,
and full-length prediction (traces reflect-padded to a multiple of 16 and
cropped back). Weights come from a ``.ckpt`` of either package or a Keras
``.hdf5``.

The default accessors read the contract with ``h5py``, imported inside each
function: a machine without ``h5py`` trains and predicts from traces passed
through the injection points.

``fit`` and ``predict`` take ``mesh`` (a ``parallel.mesh.Mesh``): every rank
calls them with the same arguments and gets the same result; rank 0 alone
writes checkpoints, the CSV and plots, and a barrier stands before any rank
reads the best checkpoint back.
"""

import functools
import logging
import os
import time
from itertools import cycle
from math import ceil

import numpy as np
import torch

from deepcalcium_torch.models.unet1d import (UNet1D, from_jax_params,
                                             load_jax_params_, to_jax_params)
from deepcalcium_torch.ops import losses as L
from deepcalcium_torch.parallel.mesh import agree, check_mesh
from deepcalcium_torch.train import trainer as T
from deepcalcium_torch.train.callbacks import CSVMetricsLogger, plot_metrics_grid
from deepcalcium_torch.train.checkpoints import read_checkpoint, save_checkpoint
from deepcalcium_torch.train.evaluate import _run_batched
from deepcalcium_torch.train.sampler import (Prefetcher, make_put_fn,
                                             stack_batches)
from deepcalcium_torch.utils.config import checkpoints_dir
from deepcalcium_torch.utils.device import require_cuda
from deepcalcium_torch.utils.profiling import span

__all__ = ["UNet1DSegmentation", "get_dataset_attrs", "get_dataset_traces",
           "get_dataset_spikes", "maxpool_labels", "margin_metrics"]


# --- Dataset accessors (the spike HDF5 contract) ----------------------------

def get_dataset_attrs(dspath: str) -> dict:
    import h5py

    with h5py.File(dspath, "r") as fp:
        return {k: v for k, v in fp.attrs.items()}


def get_dataset_traces(dspath: str) -> np.ndarray:
    """Per-trace z-normalised traces, with the reference's sanity checks on
    their overall mean and std."""
    import h5py

    with h5py.File(dspath, "r") as fp:
        traces = fp["traces"][...]
    m = np.mean(traces, axis=1, keepdims=True)
    s = np.std(traces, axis=1, keepdims=True)
    traces = (traces - m) / s
    assert -5 < np.mean(traces) < 5, np.mean(traces)
    assert -5 < np.std(traces) < 5, np.std(traces)
    return traces


def get_dataset_spikes(dspath: str) -> np.ndarray:
    import h5py

    with h5py.File(dspath, "r") as fp:
        return fp["spikes"][...]


def maxpool_labels(spikes: np.ndarray, margin: int) -> np.ndarray:
    """The error margin applied to labels: a max-pool of window margin+1,
    stride 1, with XLA's SAME placement (``(w - 1) // 2`` samples of -inf
    padding low, the rest high), as float32 on the host."""
    x = np.asarray(spikes, np.float32)
    if margin <= 0:
        return x
    w = int(margin) + 1
    lo = (w - 1) // 2
    pad = [(0, 0)] * (x.ndim - 1) + [(lo, w - 1 - lo)]
    xp = np.pad(x, pad, constant_values=-np.inf)
    return np.lib.stride_tricks.sliding_window_view(
        xp, w, axis=-1).max(axis=-1)


def margin_metrics(spikes_true, spikes_pred, margin: int = 4) -> dict:
    """The spike metrics of a prediction against true spikes widened by the
    error margin (``maxpool_labels``), as host floats."""
    yt = torch.from_numpy(maxpool_labels(np.asarray(spikes_true, np.float32),
                                         int(margin)))
    yp = torch.from_numpy(np.asarray(spikes_pred, np.float32))
    return {k: float(fn(yt, yp).mean()) for k, fn in L.SPIKE_METRICS.items()}


def _pad_to_multiple(x: np.ndarray, mult: int):
    t = x.shape[-1]
    pad = (-t) % mult
    if pad == 0:
        return x, t
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)], mode="reflect"), t


class UNet1DSegmentation:
    """Trace -> binary spike segmentation wrapper around ``UNet1D``.

    # Arguments
        cpdir: checkpoint directory (created); None means
            ``<checkpoints_dir>/spikes_unet1d``.
        dataset_attrs_func, dataset_traces_func, dataset_spikes_func: map a
            dataset reference (a path for the defaults) to its attributes
            (with ``"name"``), its (R, T) z-normalised traces and its (R, T)
            binary spikes.
        net_func: builds the net; called as ``net_func(compute_dtype=...,
            generator=..., margin=...)``, e.g.
            ``functools.partial(UNet1D, nfb=4, drp=0.0)``.
        compute_dtype: e.g. ``torch.bfloat16`` for the convs; None = float32.
        init_params: (params, state) in the JAX package's layout; when
            given, every fit starts from them instead of a draw from the
            seed (so both packages can start from the same weights).
        device: where the net runs. The default, "cuda", raises when no card
            is present: the port never falls back to the CPU by itself.
            Pass "cpu" to run on the CPU on purpose.
    """

    def __init__(self, cpdir=None, dataset_attrs_func=get_dataset_attrs,
                 dataset_traces_func=get_dataset_traces,
                 dataset_spikes_func=get_dataset_spikes, net_func=UNet1D,
                 compute_dtype=None, init_params=None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            require_cuda()
        self.cpdir = cpdir or os.path.join(checkpoints_dir(), "spikes_unet1d")
        os.makedirs(self.cpdir, exist_ok=True)
        self.dataset_attrs_func = dataset_attrs_func
        self.dataset_traces_func = dataset_traces_func
        self.dataset_spikes_func = dataset_spikes_func
        self.net_func = net_func
        self.compute_dtype = compute_dtype
        self.init_params = init_params

    # ------------------------------------------------------------------ fit

    def fit(self, dataset_paths, shape=(4096,), error_margin=4, batch=20,
            nb_epochs=20, val_type="random_split", prop_trn=0.8, prop_val=0.2,
            nb_folds=5, learning_rate=2e-3, seed=865, mesh=None,
            steps_per_dispatch=1, weight_decay=0.0,
            prng_impl="threefry2x32", preset=None):
        """Train; returns (metrics_trn, metrics_val, best_model_path) for
        random_split, or ``{metric: {trn_mean, trn_std, val_mean,
        val_std}}`` over the folds for cross_validate.

        The JAX package's ``fit``: loss wbce(pos=2), metrics
        F2/prec/reca/ytspks/ypspks, one epoch = one random window from
        every training trace (``ceil(n / batch)`` steps), validation on a
        fixed batch of two windows per validation trace, the best val_F2
        checkpointed. Every knob is checked before any dataset is read.
        ``weight_decay`` > 0 trains with AdamW on the conv kernels.

        ``steps_per_dispatch`` (K): run K train steps per dispatch
        (``train.trainer.make_multi_step``; on the card one CUDA graph
        replay of K steps), as in the 2-D ``fit``. Must divide the
        per-epoch step count ``ceil(n_train_traces / batch)``.
        ``preset="perf"`` takes, for each split, the first of (4, 2, 1)
        that divides that split's step count, as the JAX package does
        (cross-validation folds may differ); its ``rbg`` PRNG has no
        counterpart: dropout stays the torch Philox stream. ``prng_impl``
        is checked and logged, and changes nothing here.

        ``mesh``: data-parallel training over the mesh's ranks
        (``train.trainer.make_train_step``): every rank draws the same
        batches and trains on its rows, so ``batch`` must divide by
        ``mesh.size``; validation batches are split over the ranks. Rank 0
        alone writes to ``cpdir``, which every rank must see to read the
        best checkpoint back. Dropout masks are drawn from a stream seeded
        with ``seed + 2 + mesh.rank``: at ``drp > 0`` the run is not the
        one-process run.
        """
        logger = logging.getLogger(__name__)
        if len(shape) != 1:
            raise ValueError(f"shape must be (window_len,), got {shape}")
        if shape[0] < 16 or shape[0] % 16:
            raise ValueError(f"shape={shape}: window length must be a "
                             f"multiple of 16 (4 2x pools)")
        if not (0 < prop_trn < 1 and 0 < prop_val < 1):
            raise ValueError(f"prop_trn={prop_trn}, prop_val={prop_val} "
                             f"must lie in (0, 1)")
        if val_type not in ("random_split", "cross_validate"):
            raise ValueError(f"unknown val_type {val_type!r}")
        if nb_folds <= 1:
            raise ValueError(f"nb_folds={nb_folds} must be > 1")
        if abs(prop_trn + prop_val - 1.0) > 1e-9:
            raise ValueError(f"prop_trn + prop_val must be 1, got "
                             f"{prop_trn} + {prop_val}")
        if preset not in (None, "parity", "perf"):
            raise ValueError(f"preset={preset!r}: expected None, 'parity' "
                             f"or 'perf'")
        if prng_impl not in T.PRNG_IMPLS:
            raise ValueError(f"prng_impl={prng_impl!r}: expected one of "
                             f"{T.PRNG_IMPLS}")
        kdisp = None if preset == "perf" else int(steps_per_dispatch)
        if kdisp is not None and kdisp < 1:
            raise ValueError(f"steps_per_dispatch={kdisp} must be >= 1")
        if check_mesh(mesh) is not None and batch % mesh.size:
            raise ValueError(f"batch={batch} must divide by the mesh size "
                             f"{mesh.size} (multi-device training)")
        if preset == "perf":
            logger.info("preset='perf': steps_per_dispatch chosen per split; "
                        "dropout stays the torch Philox stream (the JAX "
                        "package's 'rbg' has no counterpart here)")
        if prng_impl != "threefry2x32":
            logger.info("prng_impl=%r: the JAX package's PRNG lever; a no-op "
                        "here (the torch Philox stream)", prng_impl)

        traces = [t for p in dataset_paths for t in self.dataset_traces_func(p)]
        spikes = [s for p in dataset_paths for s in self.dataset_spikes_func(p)]
        if len(traces) != len(spikes):
            raise ValueError(f"datasets yield {len(traces)} traces but "
                             f"{len(spikes)} spike rows")
        if not traces:
            raise ValueError(f"no traces in {list(dataset_paths)}")
        rng = np.random.default_rng(seed)

        if val_type == "random_split":
            idxs = rng.permutation(len(traces))
            n_trn = int(len(idxs) * prop_trn)
            idxs_trn, idxs_val = idxs[:n_trn], idxs[n_trn:]
            mt, mv, bmp = self._fit_single(
                traces, spikes, idxs_trn, idxs_val, shape, error_margin,
                batch, nb_epochs, learning_rate, seed, kdisp, weight_decay,
                mesh)
            for k in sorted(mt.keys()):
                logger.info("%-20s trn=%-9.4f val=%-9.4f", k, mt[k], mv[k])
            logger.info("Best model path: %s", bmp)
            return mt, mv, bmp

        # K-fold: array_split spreads the remainder over the first folds.
        idxs = rng.permutation(len(traces))
        folds = np.array_split(idxs, nb_folds)
        metrics_trn, metrics_val = [], []
        for val_idx in range(nb_folds):
            idxs_trn = np.concatenate(
                [f for i, f in enumerate(folds) if i != val_idx])
            logger.info("Cross validation fold = %d", val_idx)
            mt, mv, _ = self._fit_single(
                traces, spikes, idxs_trn, folds[val_idx], shape,
                error_margin, batch, nb_epochs, learning_rate,
                seed + val_idx, kdisp, weight_decay, mesh)
            metrics_trn.append(mt)
            metrics_val.append(mv)
        agg = {}
        for k in sorted(metrics_trn[0].keys()):
            vt = [m[k] for m in metrics_trn]
            vv = [m[k] for m in metrics_val]
            agg[k] = {"trn_mean": float(np.mean(vt)), "trn_std": float(np.std(vt)),
                      "val_mean": float(np.mean(vv)), "val_std": float(np.std(vv))}
            logger.info("%-20s trn=%-9.4f (%.4f) val=%-9.4f (%.4f)", k,
                        agg[k]["trn_mean"], agg[k]["trn_std"],
                        agg[k]["val_mean"], agg[k]["val_std"])
        return agg

    def _new_net(self, seed, margin):
        """The net on ``self.device``: drawn on the CPU from ``seed`` (the
        same weights on every device), or ``init_params`` when given."""
        net = self.net_func(compute_dtype=self.compute_dtype,
                            generator=torch.Generator().manual_seed(seed),
                            margin=int(margin))
        if self.init_params is not None:
            load_jax_params_(net, *self.init_params)
        return net.to(self.device)

    def _metrics(self, metric_fns, y, probs):
        """{name: 0-d float32 tensor} on the device, each metric's mean."""
        return {k: fn(y, probs).float().mean() for k, fn in metric_fns.items()}

    def _fit_single(self, traces, spikes, idxs_trn, idxs_val, shape, margin,
                    batch, nb_epochs, learning_rate, seed, kdisp=1,
                    weight_decay=0.0, mesh=None):
        loss_fn = functools.partial(L.weighted_binary_crossentropy,
                                    weightpos=2.0)
        metric_fns = dict(L.SPIKE_METRICS)
        tr_trn = [traces[i] for i in idxs_trn]
        sp_trn = [spikes[i] for i in idxs_trn]
        tr_val = [traces[i] for i in idxs_val]
        sp_val = [spikes[i] for i in idxs_val]
        steps_trn = int(ceil(len(tr_trn) / batch))
        if kdisp is None:
            # preset='perf': per split, since folds may differ in size.
            kdisp = next(k for k in (4, 2, 1) if steps_trn % k == 0)
            logging.getLogger(__name__).info(
                "preset='perf': steps_per_dispatch=%d (steps_trn=%d)",
                kdisp, steps_trn)
        if steps_trn % kdisp != 0:
            raise ValueError(
                f"steps_per_dispatch={kdisp} must divide the per-epoch step "
                f"count ceil(n_train_traces/batch)={steps_trn}")

        net = self._new_net(seed, margin)
        optimizer = T.make_optimizer(net, learning_rate,
                                     weight_decay=weight_decay)
        if kdisp > 1:
            step = T.make_multi_step(net, loss_fn, optimizer, kdisp,
                                     metric_fns, mesh=mesh)
        else:
            step = T.make_train_step(net, loss_fn, optimizer, metric_fns, mesh)
        fwd = T.make_eval_forward(net, mesh)
        # Validation batches are split over the mesh's ranks and gathered.
        eval_fwd = lambda x: _run_batched(fwd, x, mesh=mesh)

        gen = self._batch_gen(tr_trn, sp_trn, shape, batch, margin, seed)
        if kdisp > 1:
            gen = stack_batches(gen, kdisp)  # one (K, B, T) slab a dispatch
        prefetch = Prefetcher(gen, put_fn=make_put_fn(self.device, mesh, kdisp))
        # Fixed validation batch: two windows from every validation trace.
        x_val, y_val = next(self._batch_gen(
            tr_val, sp_val, shape, len(tr_val) * 2, margin, seed + 1))

        tic = int(time.time())
        writes = mesh is None or mesh.rank == 0
        if mesh is not None:
            tic = agree(mesh, tic)  # one name for the files on every rank
        csvlog = (CSVMetricsLogger(os.path.join(self.cpdir, f"{tic}_metrics.csv"))
                  if writes else None)
        # Dropout keep-masks are drawn on the device from their own stream.
        dropout_gen = torch.Generator(device=self.device).manual_seed(
            seed + 2 + (mesh.rank if mesh is not None else 0))
        nb_plot = min(8, x_val.shape[0])
        try:
            best_path = self._epoch_loop(
                nb_epochs, steps_trn // kdisp, step, eval_fwd, prefetch,
                metric_fns,
                x_val, y_val, nb_plot, csvlog, tic, dropout_gen, net,
                optimizer)
        finally:
            prefetch.close()

        # Reload the best checkpoint and evaluate train (steps_trn batches
        # from a fresh generator) and validation again.
        if mesh is not None:
            mesh.barrier()  # rank 0 has written what every rank now reads
        ckpt = read_checkpoint(best_path)
        load_jax_params_(net, ckpt["params"], ckpt["state"])
        gen_eval = self._batch_gen(tr_trn, sp_trn, shape, batch, margin,
                                   seed + 3)
        rows = []
        for _ in range(steps_trn):
            xb, yb = (torch.from_numpy(a).to(self.device) for a in next(gen_eval))
            met = self._metrics(metric_fns, yb, eval_fwd(xb))
            rows.append(torch.stack(list(met.values())))
        fetched = torch.stack(rows).cpu().numpy()
        sums = {k: sum(float(v) for v in fetched[:, i])
                for i, k in enumerate(metric_fns)}
        mt = {k: v / steps_trn for k, v in sums.items()}
        yv = torch.from_numpy(y_val).to(self.device)
        out_val = eval_fwd(torch.from_numpy(x_val).to(self.device))
        mv = {k: float(v) for k, v in
              self._metrics(metric_fns, yv, out_val).items()}
        return mt, mv, best_path

    def _epoch_loop(self, nb_epochs, dispatches, step, eval_fwd, prefetch,
                    metric_fns, x_val, y_val, nb_plot, csvlog, tic,
                    dropout_gen, net, optimizer):
        logger = logging.getLogger(__name__)
        xv = torch.from_numpy(x_val).to(self.device)
        yv = torch.from_numpy(y_val).to(self.device)
        best_f2, best_path = -1.0, None
        writes = csvlog is not None
        for epoch in range(nb_epochs):
            t0 = time.time()
            # Metrics stay on the device; one sync per epoch, keys in sorted
            # order, as the JAX package's device_get of a dict returns them.
            step_metrics: list[dict] = []
            for _ in range(dispatches):
                xb, yb = next(prefetch)
                step_metrics.append(step(xb, yb, dropout_gen))
            keys = sorted(step_metrics[0])
            probs = eval_fwd(xv)
            val = self._metrics(metric_fns, yv, probs)
            trn = T.metric_rows(step_metrics, keys)  # a row a step
            fetched = torch.cat([trn.flatten(), torch.stack(list(val.values()))]
                                ).cpu().numpy()
            trn_h = fetched[:trn.numel()].reshape(trn.shape)
            agg: dict[str, float] = {
                k: float(np.mean(trn_h[:, i])) for i, k in enumerate(keys)}
            agg.update({f"val_{k}": float(v) for k, v in
                        zip(val, fetched[trn.numel():])})
            if writes:
                csvlog.append(epoch, agg)
                plot_metrics_grid(csvlog.history,
                                  os.path.join(self.cpdir, f"{tic}_metrics.png"))
            # Sample predictions on fixed validation windows.
            try:
                from deepcalcium_torch.utils.visualization import plot_traces_spikes

                if writes:
                    plot_traces_spikes(
                        x_val[:nb_plot], spikes_true=y_val[:nb_plot],
                        spikes_pred=probs[:nb_plot].cpu().numpy(),
                        title=f"Epoch {epoch} val_F2={agg['val_F2']:.3f}",
                        save_path=os.path.join(
                            self.cpdir, f"{tic}_samples_{epoch:03d}_val.png"))
            except Exception as e:  # a plot must never end training
                logger.warning("sample plot failed: %s", e)
            logger.info("epoch %d: loss=%.4f F2=%.4f val_F2=%.4f (%.3fs)",
                        epoch, agg["loss"], agg["F2"], agg["val_F2"],
                        time.time() - t0)

            if not np.isfinite(agg["loss"]) or not np.isfinite(agg["val_F2"]):
                raise FloatingPointError(
                    f"non-finite training loss/val_F2 at epoch {epoch}: "
                    f"loss={agg['loss']}, val_F2={agg['val_F2']}")

            if agg["val_F2"] > best_f2:
                best_f2 = agg["val_F2"]
                best_path = os.path.join(
                    self.cpdir, f"{tic}_model_val_F2_{best_f2:.3f}_{epoch:03d}.ckpt")
                if writes:
                    params, state = to_jax_params(net)
                    save_checkpoint(best_path, params, state,
                                    T.optax_state(net, optimizer),
                                    meta={"epoch": epoch, "val_F2": best_f2})
        return best_path

    def _batch_gen(self, traces, spikes, shape, batch_size, margin, seed):
        """Random fixed-length windows cycling a shuffled trace order; the
        labels are margin-pooled once up front. The same numpy stream as
        the JAX package's."""
        rng = np.random.default_rng(seed)
        spikes = [np.asarray(maxpool_labels(s[None], margin))[0] for s in spikes]
        wlen = shape[0]
        while True:
            order = cycle(rng.permutation(len(traces)))
            for _ in range(max(1, int(ceil(len(traces) / batch_size)))):
                tb = np.zeros((batch_size, wlen), np.float32)
                sb = np.zeros((batch_size, wlen), np.float32)
                for b in range(batch_size):
                    idx = next(order)
                    t, s = traces[idx], spikes[idx]
                    if len(t) <= wlen:
                        tb[b, : len(t)] = t
                        sb[b, : len(s)] = s
                    else:
                        x0 = int(rng.integers(0, len(t) - wlen))
                        tb[b] = t[x0 : x0 + wlen]
                        sb[b] = s[x0 : x0 + wlen]
                yield tb, sb

    # -------------------------------------------------------------- predict

    def predict(self, dataset_paths, model_path, batch=32, threshold=0.5,
                error_margin=4, mesh=None, fast="auto"):
        """Full-length spike masks of every trace: (list of (R, T) uint8
        arrays, names).

        Traces are reflect-padded to a multiple of 16 and cropped back, and
        run through the eval-mode net in slabs of ``batch``.
        ``model_path``: a ``.ckpt`` of either package or a Keras
        ``.hdf5``/``.h5``. The net is ``net_func``'s, with the weights
        loaded; the stock ``UNet1D`` reads its width off the weights.
        ``fast``: True, or "auto" when the built net is a ``UNet1D`` itself
        (not a subclass), runs ``UNet1D.fold()``, BN folded into the convs
        and the sigmoid head (exact up to float rounding), as the JAX
        package dispatches ``apply_fast_t``; any other value runs the
        unfolded eval net. ``mesh``: each slab of traces is split over the
        mesh's ranks and gathered; every rank gets every mask.
        """
        check_mesh(mesh)
        with span("predict"):
            with span("predict.ckpt_read"):
                if str(model_path).endswith((".hdf5", ".h5")):
                    from deepcalcium_torch.interop.keras_import import \
                        load_unet1d_keras

                    params, state = load_unet1d_keras(model_path)
                else:
                    ckpt = read_checkpoint(model_path)
                    params, state = ckpt["params"], ckpt["state"]
            with span("predict.build"):
                if self.net_func is UNet1D:
                    net = from_jax_params(params, state, self.compute_dtype,
                                          self.device,
                                          margin=int(error_margin))
                else:
                    net = load_jax_params_(self.net_func(
                        compute_dtype=self.compute_dtype,
                        generator=torch.Generator().manual_seed(0),
                        margin=int(error_margin)), params, state).to(
                            self.device)
                net = net.eval()
                if fast is True or (fast == "auto" and type(net) is UNet1D):
                    logging.getLogger(__name__).info(
                        "fast=%r: running the folded inference forward "
                        "(UNet1D.fold: BN folded into the convs, the sigmoid "
                        "head)", fast)
                    with span("net.fold"):
                        net = net.fold()
                fwd = T.make_eval_forward(net, mesh)

            spikes_pred_all, names_all = [], []
            for p in dataset_paths:
                with span("predict.traces"):
                    names_all.append(self.dataset_attrs_func(p)["name"])
                    traces = np.asarray(self.dataset_traces_func(p),
                                        np.float32)
                    padded, t = _pad_to_multiple(traces, 16)
                with span("predict.upload"):
                    x = torch.from_numpy(padded).to(self.device)
                with span("predict.forward"):
                    out = _run_batched(fwd, x, max_batch=batch, mesh=mesh)
                with span("predict.fetch"):
                    spikes_pred = out[:, :t].cpu().numpy()
                    spikes_pred_all.append(
                        (spikes_pred > threshold).astype(np.uint8))
            return spikes_pred_all, names_all
