"""UNet2DSummary: the neuron-segmentation wrapper (fit, evaluate_movie,
predict).

Port of ``deepcalcium_tpu.models.unet_2d_summary.UNet2DSummary``: the
constructor with its injection points, ``fit``, ``evaluate_movie`` (a
tensor, an array or a contract-HDF5 path; frames larger than the window
run tiled) and ``predict`` over datasets. Weights come from a ``.ckpt`` of
either package or a Keras ``.hdf5``.

``fit``, ``evaluate_movie`` and ``predict`` take ``mesh`` (a
``parallel.mesh.Mesh``): every rank calls them with the same arguments and
gets the same result. Rank 0 alone writes checkpoints, the CSV, plots and
images; every decision (plateau, best epoch) comes from metrics that are
identical on every rank.

The default dataset accessors read the neurofinder HDF5 contract with
``h5py``, imported inside each function: a machine without ``h5py`` can
still train and predict from summaries passed through the injection points.
"""

import copy
import functools
import logging
import os
import time

import numpy as np
import torch

from deepcalcium_torch.metrics.neurofinder import nf_mask_metrics
from deepcalcium_torch.models.unet2d import (UNet2DS, from_jax_params,
                                             load_jax_params_, to_jax_params)
from deepcalcium_torch.ops import losses as L
from deepcalcium_torch.ops.mask_summary import (mask_summary_exact,
                                                mask_summary_stencil)
from deepcalcium_torch.parallel.mesh import agree, check_mesh
from deepcalcium_torch.train import trainer as T
from deepcalcium_torch.train.callbacks import CSVMetricsLogger, plot_metrics_grid
from deepcalcium_torch.train.checkpoints import (latest_checkpoint,
                                                 load_checkpoint,
                                                 read_checkpoint,
                                                 save_checkpoint)
from deepcalcium_torch.train.evaluate import (evaluate_movie_streaming,
                                              evaluate_movie_tiled,
                                              make_movie_evaluator,
                                              predict_batched, predict_tiled,
                                              predict_tta, tile_grid)
from deepcalcium_torch.train.sampler import (Prefetcher, WindowSampler,
                                             make_put_fn, stack_batches)
from deepcalcium_torch.utils.config import checkpoints_dir
from deepcalcium_torch.utils.device import require_cuda
from deepcalcium_torch.utils.profiling import span, trace
from deepcalcium_torch.utils.runtime import funcname, phase_timer

__all__ = ["UNet2DSummary", "summarize_series", "summarize_mask",
           "summarize_mask_stencil", "name_dataset"]

# --- Default dataset accessors (neurofinder HDF5 contract) ------------------

def summarize_series(dspath: str) -> np.ndarray:
    """z-normalised mean summary image of a dataset file."""
    import h5py

    with h5py.File(dspath, "r") as fp:
        summ = fp["series/mean"][...].astype(np.float32)
    return (summ - np.mean(summ)) / np.std(summ)


def _read_masks(dspath: str) -> np.ndarray:
    import h5py

    with h5py.File(dspath, "r") as fp:
        if "masks" not in fp:
            raise KeyError(
                f"{dspath} has no ground-truth masks (a .test set?) — "
                f"scoring/outlines against ground truth need masks/raw")
        return fp["masks/raw"][...]


def summarize_mask(dspath: str) -> np.ndarray:
    """Flattened, conflict-eroded mask summary of a dataset file (the exact
    sequential walk, ``ops.mask_summary.mask_summary_exact``)."""
    return mask_summary_exact(_read_masks(dspath))


def summarize_mask_stencil(dspath: str, device="cuda") -> np.ndarray:
    """Mask summary of a dataset file by the vectorised stencil
    approximation (``ops.mask_summary.mask_summary_stencil``) on ``device``:
    a tested alternative, not a default. Opt in through the injection point,

        UNet2DSummary(mask_summary_func=summarize_mask_stencil).fit(...)

    (``functools.partial(summarize_mask_stencil, device="cpu")`` without a
    card). Its targets may lack a few pixels of the exact walk's on chains
    of touching neurons and never hold a pixel more; scoring and golden
    comparisons need the exact default. Returns (H, W) float64."""
    return mask_summary_stencil(_read_masks(dspath), device).cpu().numpy() \
        .astype(np.float64)


def _is_keras(model_path) -> bool:
    return str(model_path).endswith((".hdf5", ".h5"))


def name_dataset(dspath: str) -> str:
    import h5py

    with h5py.File(dspath, "r") as fp:
        name = fp.attrs["name"]
    return name if isinstance(name, str) else name.decode()


class UNet2DSummary:
    """Neuron-segmentation wrapper around ``UNet2DS``.

    # Arguments
        cpdir: checkpoint directory that ``fit`` writes to and
            ``model_path="latest"`` reads; None means
            ``<checkpoints_dir>/neurons_unet2ds``, resolved (and created)
            when first needed.
        dataset_name_func, series_summary_func, mask_summary_func: map a
            dataset reference (a path for the defaults) to its name, its
            (H, W) summary image and its (H, W) binary mask.
        net_func: builds the net that ``fit`` trains and that
            ``evaluate_movie`` and ``predict`` run; called as
            ``net_func(compute_dtype=..., generator=..., remat=...)``, e.g.
            ``functools.partial(UNet2DS, nfb=4, drp=0.0)``. ``UNet2DS`` or a
            partial of it is the stock net, which inference builds off the
            weights.
        compute_dtype: e.g. ``torch.bfloat16`` for the convs; None = float32.
        remat: recompute conv blocks in the backward pass of ``fit``.
        device: where the net runs. The default, "cuda", raises when no card
            is present: the port never falls back to the CPU by itself.
            Pass "cpu" to run on the CPU on purpose.
    """

    def __init__(self, cpdir=None, dataset_name_func=name_dataset,
                 series_summary_func=summarize_series,
                 mask_summary_func=summarize_mask, net_func=UNet2DS,
                 compute_dtype=None, remat=False, device="cuda"):
        self.cpdir = cpdir
        self.dataset_name_func = dataset_name_func
        self.series_summary_func = series_summary_func
        self.mask_summary_func = mask_summary_func
        self.net_func = net_func
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.device = torch.device(device)
        if self.device.type == "cuda":
            require_cuda()

    def _cpdir(self) -> str:
        if self.cpdir is None:
            self.cpdir = os.path.join(checkpoints_dir(), "neurons_unet2ds")
        os.makedirs(self.cpdir, exist_ok=True)
        return self.cpdir

    def _resolve(self, model_path):
        """``model_path``, with "latest" resolved to the newest checkpoint
        in ``cpdir``."""
        if model_path == "latest":
            cpdir = self._cpdir()
            resolved = latest_checkpoint(cpdir)
            if resolved is None:
                raise FileNotFoundError(
                    f"model_path='latest' but no checkpoint exists in {cpdir}")
            model_path = resolved
        return model_path

    def _load_params(self, model_path):
        """(params, state) in the JAX package's layout, from a ``.ckpt``
        written by either package, a Keras ``.hdf5``/``.h5``, or the newest
        checkpoint in ``cpdir`` when ``model_path == "latest"``."""
        model_path = self._resolve(model_path)
        logging.getLogger(__name__).info("loading params from %s", model_path)
        if _is_keras(model_path):
            from deepcalcium_torch.interop.keras_import import load_unet2ds_keras

            return load_unet2ds_keras(model_path)
        params, state, _ = load_checkpoint(model_path)
        return params, state

    def _inference_net(self, params, state, window_shape, fast):
        """The eval-mode net on ``self.device``, as the JAX package's
        ``_resolve_apply_fn`` picks its forward. The stock net (``UNet2DS``
        or a ``functools.partial`` of it) is built off the weights, which
        give its width and up mode; any other ``net_func`` is built as
        ``fit`` builds it, and the weights are loaded into it. ``fast=True``
        folds BN into the convs with the sigmoid head (``UNet2DS.fold``,
        exact up to float rounding) whatever the net is; "auto" folds only
        a net whose type is ``UNet2DS`` itself, with a transpose-mode
        checkpoint and a window of multiples of 16; anything else runs the
        unfolded net."""
        stock = self.net_func is UNet2DS or (
            isinstance(self.net_func, functools.partial)
            and self.net_func.func is UNet2DS)
        if stock:
            net = from_jax_params(params, state, self.compute_dtype,
                                  self.device)
        else:
            net = load_jax_params_(self.net_func(
                compute_dtype=self.compute_dtype,
                generator=torch.Generator().manual_seed(0), remat=False),
                params, state).to(self.device)
        net = net.eval()
        if fast is True or (
                fast == "auto" and type(net) is UNet2DS
                and "up0_tconv" in params
                and all(s % 16 == 0 for s in window_shape)):
            logging.getLogger(__name__).info(
                "fast=%r: running the folded inference forward (UNet2DS.fold: "
                "BN folded into the convs, the sigmoid head)", fast)
            with span("net.fold"):
                net = net.fold()
        return net

    # ------------------------------------------------------------------ fit

    def fit(self, dataset_paths, model_path=None, proceed=False,
            shape_trn=(96, 96), shape_val=(512, 512), batch_size_trn=32,
            nb_steps_trn=200, nb_epochs=20, prop_trn=0.75, prop_val=0.25,
            learning_rate=2e-3, loss="binary_crossentropy", seed=865,
            mesh=None, adaptive_sampling=False, nb_max_augment=15,
            epoch_callbacks=(), profile_dir=None, ema_decay=None,
            lr_schedule="plateau", steps_per_dispatch=1, fast_train="auto",
            weight_decay=0.0, prng_impl="threefry2x32", preset=None):
        """Train; returns (history dict, best checkpoint path).

        The JAX package's ``fit``: row-split train/validation bands per
        dataset, neuron-centred augmented training windows, per-epoch
        Neurofinder validation on 6 dihedral full-image views, a checkpoint
        every epoch named by val F1, and ReduceLROnPlateau on train F1.
        Every knob is checked before any dataset is read.

        ``epoch_callbacks``: callables ``f(epoch, logs_dict)`` run at the
        end of every epoch. ``adaptive_sampling``: re-weight datasets by
        1 - val F1. ``ema_decay``: validate and checkpoint a Polyak average
        of the weights. ``lr_schedule``: "plateau", "cosine" (to 1e-4 over
        ``nb_epochs``) or a callable ``f(next_epoch) -> lr``.
        ``weight_decay`` > 0 trains with AdamW. ``profile_dir``: a
        ``torch.profiler`` trace of epoch 1 (epoch 0 if it is the only one),
        which shows the phases as the program's spans
        (``utils.profiling.span``: ``fit.prefetch_wait``, ``fit.step``,
        ``fit.metrics_sync``, ``fit.validate``, ``fit.log``,
        ``fit.checkpoint``, ``fit.callbacks``).
        ``model_path`` (a ``.ckpt`` of either package, a Keras ``.hdf5``,
        or "latest") warm starts; with ``proceed=True`` Adam's moments, step
        count and learning rate resume too from a ``.ckpt`` (a Keras file
        carries no optimizer state that is translated: Adam starts fresh).

        ``steps_per_dispatch`` (K): run K train steps per dispatch
        (``train.trainer.make_multi_step``) on (K, B, ...) slabs that the
        prefetch thread stacks: on the card one CUDA graph replay of K
        steps, on the CPU a loop. Must divide ``nb_steps_trn``. The steps,
        the per-step EMA and the per-step metrics are those of K=1.
        ``preset="perf"`` takes the first of (4, 2, 1) that divides
        ``nb_steps_trn``, as the JAX package does; ``None``/``"parity"``
        keep ``steps_per_dispatch``. The preset's other lever, the JAX
        package's ``rbg`` PRNG, has no counterpart: dropout stays the torch
        Philox stream. ``prng_impl`` and ``fast_train`` (the JAX package's
        PRNG and lane-packing levers) are checked and logged, and change
        nothing here.

        ``mesh``: data-parallel training over the mesh's ranks
        (``train.trainer.make_train_step``). Every rank runs the same
        sampler from the same seed and trains on its rows of each batch, so
        ``batch_size_trn`` must divide by ``mesh.size``; the validation
        views are split over the ranks. Rank 0 alone writes to ``cpdir``,
        which every rank must see if it is to read the returned
        checkpoint. Dropout masks are drawn from a stream seeded with
        ``seed + 1 + mesh.rank``: at ``drp > 0`` the run is not the
        one-process run.
        """
        logger = logging.getLogger(__name__)
        if shape_trn[0] != shape_trn[1] or shape_val[0] != shape_val[1]:
            raise ValueError(f"square windows required: {shape_trn}, "
                             f"{shape_val}")
        for nm, shp in (("shape_trn", shape_trn), ("shape_val", shape_val)):
            if shp[0] < 16 or shp[0] % 16:
                raise ValueError(f"{nm}={shp}: window sides must be "
                                 f"multiples of 16 (4 2x pools)")
        if not (0 < prop_trn < 1 and 0 < prop_val < 1):
            raise ValueError(f"prop_trn={prop_trn}, prop_val={prop_val} "
                             f"must lie in (0, 1)")
        if proceed and not model_path:
            raise ValueError("proceed=True requires model_path")
        if preset not in (None, "parity", "perf"):
            raise ValueError(f"preset={preset!r}: expected None, 'parity' "
                             f"or 'perf'")
        if preset == "perf":
            steps_per_dispatch = next(
                k for k in (4, 2, 1) if nb_steps_trn % k == 0)
        kdisp = int(steps_per_dispatch)
        if kdisp < 1 or nb_steps_trn % kdisp != 0:
            raise ValueError(
                f"steps_per_dispatch={kdisp} must be >= 1 and divide "
                f"nb_steps_trn={nb_steps_trn}")
        if prng_impl not in T.PRNG_IMPLS:
            raise ValueError(f"prng_impl={prng_impl!r}: expected one of "
                             f"{T.PRNG_IMPLS}")
        if fast_train not in ("auto", True, False):
            raise ValueError(f"fast_train={fast_train!r}: expected 'auto', "
                             f"True or False")
        if not (lr_schedule in ("plateau", "cosine") or callable(lr_schedule)):
            raise ValueError(f"unknown lr_schedule: {lr_schedule!r}")
        if check_mesh(mesh) is not None and batch_size_trn % mesh.size:
            raise ValueError(f"batch_size_trn={batch_size_trn} must divide "
                             f"by the mesh size {mesh.size}")
        writes = mesh is None or mesh.rank == 0
        if preset == "perf":
            logger.info(
                "preset='perf': steps_per_dispatch=%d (%s); dropout stays "
                "the torch Philox stream (the JAX package's 'rbg' has no "
                "counterpart here)", kdisp,
                "one CUDA graph of K steps" if self.device.type == "cuda"
                else "K steps a call")
        if prng_impl != "threefry2x32" or fast_train != "auto":
            logger.info(
                "prng_impl=%r, fast_train=%r: PRNG and lane-packing levers "
                "of the JAX package; no-ops here (the torch Philox stream, "
                "the plain forward)", prng_impl, fast_train)
        with span("fit"):
            loss_fn = L.LOSSES[loss] if isinstance(loss, str) else loss
            if model_path:
                model_path = self._resolve(model_path)
                if not os.path.exists(model_path):
                    raise FileNotFoundError(f"model_path {model_path} does not exist")
                logger.info("starting from checkpoint %s", model_path)
            cpdir = self._cpdir()

            with span("fit.summaries"):
                names = [self.dataset_name_func(p) for p in dataset_paths]
                S = [np.asarray(self.series_summary_func(p))
                     for p in dataset_paths]
                M = [np.asarray(self.mask_summary_func(p))
                     for p in dataset_paths]

            with span("fit.setup"):
                # Row bands: train from the top, validate at the bottom.
                yctrn = [(0, int(s.shape[0] * prop_trn)) for s in S]
                ycval = [(s.shape[0] - int(s.shape[0] * prop_val), s.shape[0])
                         for s in S]
                for nm, s_ in zip(names, S):
                    if (int(s_.shape[0] * prop_val) < 1
                            or int(s_.shape[0] * prop_trn) < 1):
                        raise ValueError(
                            f"{nm}: prop_trn={prop_trn}/prop_val={prop_val} round "
                            f"to an empty row band on a {s_.shape[0]}-row image")

                # Model + optimizer. The initial weights are drawn on the CPU from
                # the seed, so a seed gives the same net on every device.
                net = self.net_func(compute_dtype=self.compute_dtype,
                                    generator=torch.Generator().manual_seed(seed),
                                    remat=self.remat)
                opt_state = None
                if model_path and _is_keras(model_path):
                    load_jax_params_(net, *self._load_params(model_path))
                    if proceed:
                        logger.info("proceed=True with a Keras checkpoint: weights "
                                    "resume, Adam starts fresh")
                elif model_path:
                    ckpt = read_checkpoint(model_path)
                    load_jax_params_(net, ckpt["params"], ckpt["state"])
                    opt_state = ckpt["opt_state"]
                net.to(self.device)
                optimizer = T.make_optimizer(net, learning_rate,
                                             weight_decay=weight_decay)
                if proceed and opt_state:
                    T.load_optax_state_(net, optimizer, opt_state)

                sampler = WindowSampler(S, M, names, yctrn, shape_trn,
                                        nb_max_augment=nb_max_augment, seed=seed)
                batches = sampler.batches(batch_size_trn)
                if kdisp > 1:
                    # The producer thread stacks K batches into one slab a dispatch.
                    batches = stack_batches(batches, kdisp)
                prefetch = Prefetcher(batches,
                                      put_fn=make_put_fn(self.device, mesh, kdisp))

                tic = int(time.time())
                if mesh is not None:
                    tic = agree(mesh, tic)  # one name for the files on every rank
                csvlog = (CSVMetricsLogger(os.path.join(cpdir, f"{tic}_metrics.csv"))
                          if writes else None)
                if lr_schedule == "plateau":
                    plateau = T.ReduceLROnPlateau(factor=0.5, patience=5, min_lr=1e-4)
                    next_lr = lambda epoch, agg, lr: plateau.update(agg.get("F1", 0.0), lr)
                elif lr_schedule == "cosine":
                    cosine = T.CosineDecay(learning_rate, nb_epochs, min_lr=1e-4)
                    next_lr = lambda epoch, agg, lr: cosine.lr_at(epoch + 1)
                else:
                    next_lr = lambda epoch, agg, lr: float(lr_schedule(epoch + 1))
                # Dropout keep-masks are drawn on the device from their own stream.
                dropout_gen = torch.Generator(device=self.device).manual_seed(
                    seed + 1 + (mesh.rank if mesh is not None else 0))

                best_f1, best_path = -1.0, None
                history: dict[str, list] = {}
                eval_net = net
                if ema_decay:
                    eval_net = copy.deepcopy(net)
                    w0 = float(ema_decay) ** (nb_steps_trn * nb_epochs)
                    if w0 > 0.05:
                        logger.warning(
                            "ema_decay=%s over %d total steps keeps %.0f%% of the "
                            "INIT weights in the average; use decay <= %.4f or more "
                            "steps, or expect near-zero validation metrics.",
                            ema_decay, nb_steps_trn * nb_epochs, 100 * w0,
                            0.05 ** (1.0 / max(1, nb_steps_trn * nb_epochs)))
                if kdisp > 1:
                    # The average rides inside the K steps, as in the JAX scan.
                    step = T.make_multi_step(
                        net, loss_fn, optimizer, kdisp,
                        ema=eval_net if ema_decay else None,
                        ema_decay=ema_decay or None, mesh=mesh)
                else:
                    step = T.make_train_step(net, loss_fn, optimizer, mesh=mesh)
                eval_fwd = T.make_eval_forward(eval_net, mesh)
            # Profile the first epoch after cuDNN's first calls.
            profile_epoch = 1 if nb_epochs > 1 else 0

            try:
                for epoch in range(nb_epochs):
                    t0 = time.time()
                    # Metrics stay on the device until the epoch ends.
                    step_metrics: list[dict] = []
                    with trace(profile_dir if epoch == profile_epoch else None):
                        for _ in range(nb_steps_trn // kdisp):
                            with span("fit.prefetch_wait"):
                                sb, mb = next(prefetch)
                            with span("fit.step"):
                                step_metrics.append(step(sb, mb, dropout_gen))
                                if ema_decay and kdisp == 1:
                                    T.ema_update(eval_net.parameters(),
                                                 net.parameters(), ema_decay)
                    # One sync per epoch, one row a step; keys in sorted order,
                    # as the JAX package's device_get of a dict returns them.
                    with span("fit.metrics_sync"):
                        keys = sorted(step_metrics[0])
                        fetched = T.metric_rows(step_metrics,
                                                keys).cpu().numpy()
                        agg: dict[str, float] = {
                            k: float(np.mean(fetched[:, i]))
                            for i, k in enumerate(keys)}

                    with span("fit.validate"):
                        if ema_decay:
                            # The average covers the parameters; the BN
                            # running statistics are the trained net's.
                            for b_avg, b in zip(eval_net.buffers(),
                                                net.buffers()):
                                b_avg.copy_(b)
                        vmet, name_to_f1 = self._validate(
                            eval_fwd, S, M, names, ycval, shape_val, epoch,
                            mesh)
                    agg.update(vmet)
                    if not np.isfinite(agg["loss"]):
                        raise FloatingPointError(
                            f"non-finite training loss at epoch {epoch}: "
                            f"{agg['loss']} (lr={T.current_lr(optimizer)})")
                    agg["lr"] = T.current_lr(optimizer)
                    agg["epoch_seconds"] = time.time() - t0
                    for k, v in agg.items():
                        history.setdefault(k, []).append(v)
                    with span("fit.log"):
                        if writes:
                            csvlog.append(epoch, agg)
                            plot_metrics_grid(
                                csvlog.history,
                                os.path.join(cpdir, f"{tic}_metrics.png"),
                                title=f"epoch {epoch}")
                        logger.info(
                            "epoch %d: loss=%.4f F1=%.4f val_nf_f1_mean=%.4f "
                            "(%.1fs)", epoch, agg["loss"], agg.get("F1", 0.0),
                            agg["val_nf_f1_mean"], agg["epoch_seconds"])

                    cp = os.path.join(
                        cpdir,
                        f"{tic}_model_{epoch:02d}_{agg['val_nf_f1_mean']:.3f}.ckpt")
                    with span("fit.checkpoint"):
                        if writes:
                            params, state = to_jax_params(eval_net)
                            save_checkpoint(
                                cp, params, state,
                                T.optax_state(net, optimizer),
                                meta={"epoch": epoch,
                                      **{k: float(v) for k, v in agg.items()}})
                    if agg["val_nf_f1_mean"] > best_f1:
                        best_f1, best_path = agg["val_nf_f1_mean"], cp

                    T.set_lr(optimizer,
                             next_lr(epoch, agg, T.current_lr(optimizer)))
                    if adaptive_sampling:
                        sampler.reweight(name_to_f1)
                    with span("fit.callbacks"):
                        for cb in epoch_callbacks:
                            cb(epoch, agg)
            finally:
                prefetch.close()
            if mesh is not None:
                # No rank returns before rank 0 has written the last checkpoint.
                mesh.barrier()
            return history, best_path

    def _validate(self, eval_fwd, S, M, names, ycval, shape_val, epoch,
                  mesh=None):
        """Neurofinder metrics on 6 dihedral full-image views per dataset
        ({identity, fliplr, flipud, rot90 x3}), on the validation rows only,
        all views in one batched forward. The band's crop drops its last row
        and column (``max()`` as an exclusive bound), as the reference does,
        and epoch ``e`` adds ``1e-4 * e`` to the F1 summaries to break ties
        toward later checkpoints."""
        views, view_meta = [], []
        for s, m, name, (y0, y1) in zip(S, M, names, ycval):
            vm = np.zeros(s.shape, np.uint8)
            vm[y0:y1, :] = 1
            for f in (lambda x: x, np.fliplr, np.flipud,
                      lambda x: np.rot90(x, 1), lambda x: np.rot90(x, 2),
                      lambda x: np.rot90(x, 3)):
                fs, fm, fv = f(s), f(m), f(vm)
                yy, xx = np.where(fv == 1)
                views.append(fs)
                view_meta.append((fm, name, (yy.min(), yy.max(), xx.min(), xx.max())))

        with span("fit.validate.forward"):
            probs = predict_batched(eval_fwd, views, self.device,
                                    window=shape_val, mesh=mesh)
        pp, rr, ff = [], [], []
        name_to_f1: dict[str, list] = {}
        with span("fit.validate.score"):
            for mp, (m, name, (y0, y1, x0, x1)) in zip(probs, view_meta):
                p, r, _, _, f = nf_mask_metrics(
                    m[y0:y1, x0:x1], np.round(mp[y0:y1, x0:x1]))
                pp.append(p)
                rr.append(r)
                ff.append(f)
                name_to_f1.setdefault(name, []).append(f)

        eps = 1e-4 * epoch if epoch else 0.0
        return {
            "val_nf_f1_mean": float(np.mean(ff) + eps),
            "val_nf_f1_median": float(np.median(ff) + eps),
            "val_nf_f1_min": float(np.min(ff) + eps),
            "val_nf_f1_adj": float(np.mean(ff) * np.min(ff) + eps),
            "val_nf_prec": float(np.mean(pp)),
            "val_nf_reca": float(np.mean(rr)),
        }, name_to_f1

    # -------------------------------------------------------------- evaluate

    def evaluate_movie(self, movie, model_path=None, params=None, state=None,
                       window_shape=(512, 512), tta=True, threshold=0.5,
                       mesh=None, fast="auto"):
        """Segment a raw movie: mean summary (kernel K1 on the card) ->
        z-norm -> reflect-pad -> (8x TTA) forward -> threshold.

        # Arguments
            movie: (T, H, W) tensor or numpy array, a contract-HDF5 path
                or an open dataset such as its ``series/raw`` (read 256
                frames at a time and folded by
                :func:`evaluate_movie_streaming`, K1's fold on the card;
                the movie is never held whole). A tensor or array
                whose frames fit the window is copied to ``self.device``
                once and summarised by one K1 call; frames larger than the
                window run :func:`evaluate_movie_tiled` (streaming fold,
                overlapping window tiles, per-tile TTA).
            model_path: a ``.ckpt``, a Keras ``.hdf5`` or "latest"; or pass
                ``params`` and ``state`` in the JAX package's layout.
            window_shape: inference window; frames reflect-pad up to it.
            tta: run the 8 dihedral views as one batch.
            mesh: the time axis of the summary is split over the mesh's
                ranks (each reads and folds only its frames), and the
                views or tiles of the forward too; every rank passes the
                same movie and gets the same result.
            fast: fold BN into the convs and use the sigmoid head (exact up
                to float rounding). "auto" folds only the stock net (a
                ``UNet2DS`` itself, not a subclass) with a transpose-mode
                checkpoint and a window of multiples of 16, as the JAX
                package takes its fast path only for ``unet2d.apply``;
                True folds whatever net ``net_func`` builds; False runs it
                unfolded.

        # Returns
            (mask uint8 (H, W), prob float32 (H, W)) as host numpy arrays.
        """
        check_mesh(mesh)
        if params is None:
            if model_path is None:
                raise ValueError("need model_path or params+state")
        elif state is None:
            raise ValueError("params given without state: pass both (state "
                             "carries the BN moving statistics)")
        with span("evaluate_movie"):
            if params is None:
                with span("evaluate_movie.load"):
                    params, state = self._load_params(model_path)
            with span("evaluate_movie.build"):
                model = self._inference_net(params, state, window_shape, fast)
            kw = dict(window=window_shape, tta=tta, threshold=threshold,
                      device=self.device, mesh=mesh)

            def oversized(h, w):
                return h > window_shape[0] or w > window_shape[1]

            if isinstance(movie, (str, os.PathLike)):
                import h5py

                with h5py.File(movie, "r") as fp:
                    raw = fp["series/raw"]
                    ev = (evaluate_movie_tiled if oversized(*raw.shape[1:])
                          else evaluate_movie_streaming)
                    mask, prob, _ = ev(model, raw, **kw)
                return mask, prob
            if oversized(*movie.shape[1:]):
                mask, prob, _ = evaluate_movie_tiled(model, movie, **kw)
                return mask, prob
            if not isinstance(movie, (np.ndarray, torch.Tensor)):
                # An open dataset, sliced lazily: never held whole.
                mask, prob, _ = evaluate_movie_streaming(model, movie, **kw)
                return mask, prob

            with span("evaluate_movie.upload"):
                if isinstance(movie, np.ndarray):
                    movie = torch.from_numpy(np.ascontiguousarray(movie))
                movie = movie.to(self.device)
            with span("evaluate_movie.evaluate"):
                evaluate = make_movie_evaluator(model, movie.shape,
                                                window=window_shape, tta=tta,
                                                threshold=threshold, mesh=mesh)
                mask, prob, _ = evaluate(movie)
            with span("evaluate_movie.fetch"):
                return mask.cpu().numpy(), prob.cpu().numpy()

    # --------------------------------------------------------------- predict

    def predict(self, dataset_paths, model_path, window_shape=(512, 512),
                print_scores=False, save=False, augmentation=False,
                threshold=0.5, mesh=None, max_batch=None, fast="auto"):
        """Predict masks of datasets from their summary images; returns
        (Mp, names) like the reference (``unet_2d_summary.py:532-625``).

        Images that fit the window run as one batch (8x TTA views with
        ``augmentation=True``), in slabs of ``max_batch``; larger ones run
        tiled (:func:`predict_tiled`, per-tile TTA). The views/s of the
        forward is logged through ``phase_timer``. ``print_scores`` logs
        the Neurofinder scores against each dataset's mask summary;
        ``save`` writes ``<cpdir>/<name>_mp.png`` with the predicted
        outlines in red (and the true ones in blue when the file has
        masks). Mask summaries are computed at most once a dataset.

        ``model_path``: a ``.ckpt`` of either package, a Keras ``.hdf5``
        (e.g. the reference's released ``unet2ds_model.hdf5``) or
        "latest". ``fast``: True folds the net, "auto" folds only the
        stock net with a transpose-mode checkpoint and a window of
        multiples of 16, False never (:meth:`evaluate_movie`). ``mesh``: each
        slab of views or tiles is split over the mesh's ranks; every rank
        gets every mask, and rank 0 alone saves the images.
        """
        check_mesh(mesh)
        logger = logging.getLogger(funcname())
        params, state = self._load_params(model_path)
        logger.info("Loaded model from %s.", model_path)
        fwd = T.make_eval_forward(
            self._inference_net(params, state, window_shape, fast), mesh)

        names = [self.dataset_name_func(p) for p in dataset_paths]
        S = [np.asarray(self.series_summary_func(p)) for p in dataset_paths]

        hw, ww = window_shape
        fits = [s.shape[0] <= hw and s.shape[1] <= ww for s in S]
        predictor = predict_tta if augmentation else predict_batched

        def ntiles(s, fit):
            """Window-sized forwards an image costs, from the geometry
            predict_tiled tiles with."""
            if fit:
                return 1
            ys, xs = tile_grid(s.shape, window_shape)
            return len(ys) * len(xs)

        nviews = sum(ntiles(s, f) for s, f in zip(S, fits)) * (
            8 if augmentation else 1)
        with phase_timer("predict_forward", items=nviews, unit="views"):
            small = [s for s, f in zip(S, fits) if f]
            small_probs = iter(
                predictor(fwd, small, self.device, window=window_shape,
                          max_batch=max_batch, mesh=mesh) if small else [])
            probs = [next(small_probs) if f else
                     predict_tiled(fwd, s, self.device, window=window_shape,
                                   max_batch=max_batch,
                                   tta=augmentation, mesh=mesh)
                     for s, f in zip(S, fits)]
        Mp = [(p > threshold).astype(np.uint8) for p in probs]

        mask_cache: dict = {}

        def mask_for(dsp):
            if dsp not in mask_cache:
                mask_cache[dsp] = self.mask_summary_func(dsp)
            return mask_cache[dsp]

        if print_scores:
            mean_p = mean_r = mean_c = 0.0
            for dsp, name, mp in zip(dataset_paths, names, Mp):
                p, r, i, e, c = nf_mask_metrics(mask_for(dsp), np.round(mp))
                logger.info(
                    "%s: prec=%.3f, reca=%.3f, incl=%.3f, excl=%.3f, comb=%.3f",
                    name, p, r, i, e, c)
                mean_p += p / len(dataset_paths)
                mean_r += r / len(dataset_paths)
                mean_c += c / len(dataset_paths)
            logger.info("Mean prec=%.3f, reca=%.3f, comb=%.3f",
                        mean_p, mean_r, mean_c)

        if save and (mesh is None or mesh.rank == 0):
            import h5py

            from deepcalcium_torch.utils.visualization import (mask_outlines,
                                                               save_png)

            cpdir = self._cpdir()
            for dsp, name, s, mp in zip(dataset_paths, names, S, Mp):
                with h5py.File(dsp, "r") as fp:
                    has_masks = "masks" in fp
                if has_masks:
                    outlined = mask_outlines(s, [mask_for(dsp), np.round(mp)],
                                             ["blue", "red"])
                else:
                    outlined = mask_outlines(s, [np.round(mp)], ["red"])
                out = os.path.join(cpdir, f"{name}_mp.png")
                save_png(out, outlined)
                logger.info("Saved %s", out)

        return Mp, names
