"""Training step and epoch-loop utilities.

Port of ``deepcalcium_tpu.train.trainer``:

- the optimizer is ``torch.optim.Adam`` with optax's defaults (Adam(2e-3),
  betas (0.9, 0.999), eps 1e-8), or ``AdamW`` whose decay falls on conv and
  transpose-conv weights only, as the JAX package masks it to ``kernel``
  leaves;
- the learning rate is read and set through ``param_groups`` between
  epochs, where the JAX package injects it through
  ``optax.inject_hyperparams``;
- one train step is a training forward, the mean loss, a backward and an
  optimizer step; its metrics (the 7 neuron metrics, or the 5 spike ones)
  and the loss stay on the device as float32 scalars until the caller
  fetches them once per epoch;
- :func:`make_multi_step` runs K such steps per call, as the JAX package's
  K-step ``lax.scan`` does. On a CUDA device the K steps are one CUDA graph,
  captured at the first call and replayed once per call: the eager step
  spends most of its time in the host's launches (the card idles 34-81% of
  a step at the published widths), and a replay launches them all at once.

With a mesh (``parallel.mesh.Mesh``) the step is data parallel: each rank
runs its slice of the global batch, and the BN statistics, the loss, the
metrics and the gradients are those of the global batch.

The JAX package's ``stable_apply_fn`` works around jit caches that PyTorch's
eager execution does not have, and is not ported.
"""

import numpy as np
import torch
import torch.distributed as dist

from deepcalcium_torch.ops import losses as L
from deepcalcium_torch.parallel.mesh import (LocalShard, check_mesh,
                                             local_shard, psum, shard_batch)

__all__ = ["make_optimizer", "current_lr", "set_lr", "ReduceLROnPlateau",
           "CosineDecay", "make_train_step", "make_multi_step",
           "make_capturable_", "metric_rows", "ema_update",
           "make_eval_forward",
           "optax_state", "load_optax_state_"]

# optax.adam's defaults.
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# PRNG implementations the JAX package's ``fit(prng_impl=...)`` accepts; the
# port checks the knob and draws dropout from the torch Philox stream.
PRNG_IMPLS = ("threefry2x32", "rbg", "unsafe_rbg")


def make_optimizer(model, learning_rate: float = 2e-3,
                   weight_decay: float = 0.0):
    """Adam(``learning_rate``) over ``model``'s parameters, or AdamW with
    decoupled decay when ``weight_decay`` > 0. Like the JAX package's
    kernels-only mask, the decay group holds the conv and transpose-conv
    weights (the head's included); biases and BN gamma/beta are never
    decayed."""
    if not weight_decay:
        return torch.optim.Adam(model.parameters(), lr=learning_rate,
                                betas=ADAM_BETAS, eps=ADAM_EPS)
    decay, rest = [], []
    for name, p in model.named_parameters():
        layer, attr = name.rsplit(".", 1)
        is_kernel = attr == "weight" and not layer.endswith("_bn")
        (decay if is_kernel else rest).append(p)
    return torch.optim.AdamW(
        [{"params": decay, "weight_decay": weight_decay},
         {"params": rest, "weight_decay": 0.0}],
        lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS)


def _f32(v):
    return np.asarray(v, np.float32)


def optax_state(model, optimizer) -> dict:
    """The optimizer's state in optax's state-dict layout of
    ``inject_hyperparams(adam)`` (or ``adamw``) over ``model``'s params in
    the JAX package's layout, as the JAX package checkpoints it. The model
    carries its own map to that layout: ``model.jax_tree(tensors)`` (a
    ``UNet2DS`` or a ``UNet1D``)::

        {"count": int32, "hyperparams": {"b1", "b2", "eps", "eps_root",
         "learning_rate"[, "weight_decay"]}, "hyperparams_states": {},
         "inner_state": {"0": {"count", "mu", "nu"}, "1": {}[, "2": {}]}}

    AdamW's chain (adam, masked decay, lr scale) has the masked state
    ``{"inner_state": {}}`` at "1" and an empty one at "2"."""
    named = dict(model.named_parameters())
    states = {n: optimizer.state.get(p, {}) for n, p in named.items()}
    steps = {int(s["step"]) for s in states.values() if s}
    if len(steps) > 1:
        raise ValueError(f"parameters are at different Adam steps: {steps}")
    count = np.asarray(steps.pop() if steps else 0, np.int32)

    def moments(key):
        return model.jax_tree({n: s[key] if s else torch.zeros_like(named[n])
                               for n, s in states.items()})

    group = optimizer.param_groups[0]
    b1, b2 = group["betas"]
    hyper = {"b1": _f32(b1), "b2": _f32(b2), "eps": _f32(group["eps"]),
             "eps_root": _f32(0.0), "learning_rate": _f32(current_lr(optimizer))}
    adam = {"count": count, "mu": moments("exp_avg"),
            "nu": moments("exp_avg_sq")}
    if isinstance(optimizer, torch.optim.AdamW):
        hyper["weight_decay"] = _f32(max(g["weight_decay"]
                                         for g in optimizer.param_groups))
        inner = {"0": adam, "1": {"inner_state": {}}, "2": {}}
    else:
        inner = {"0": adam, "1": {}}
    return {"count": count, "hyperparams": hyper, "hyperparams_states": {},
            "inner_state": inner}


@torch.no_grad()
def load_optax_state_(model, optimizer, opt_state: dict):
    """Restore Adam's moments, step count and learning rate from optax's
    state dict (the inverse of :func:`optax_state`), in place, through the
    model's ``torch_tensors(tree)``. The step count of a capturable group
    (:func:`make_capturable_`) lives on the parameter's device. Load before
    the first call of a :func:`make_multi_step` on the card: its graph holds
    the state tensors it was captured with."""
    if ("weight_decay" in opt_state["hyperparams"]) != isinstance(
            optimizer, torch.optim.AdamW):
        raise ValueError("the checkpoint's optimizer and this one differ in "
                         "weight decay (Adam against AdamW)")
    adam = opt_state["inner_state"]["0"]
    mu = model.torch_tensors(adam["mu"])
    nu = model.torch_tensors(adam["nu"])
    step = float(adam["count"])
    capturable = {p: g.get("capturable", False)
                  for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32,
                                 device=p.device if capturable[p] else "cpu"),
            "exp_avg": mu[name].to(p.device),
            "exp_avg_sq": nu[name].to(p.device)}
    set_lr(optimizer, float(opt_state["hyperparams"]["learning_rate"]))
    return optimizer


def current_lr(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer, lr: float):
    """Set every group's learning rate. A tensor rate (a capturable group's,
    :func:`make_capturable_`) is filled in place, so that a captured graph
    reads the new value at its next replay."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)
    return optimizer


class ReduceLROnPlateau:
    """Host-side LR plateau policy: monitor a metric in max mode, halve the
    LR after ``patience`` epochs without improvement, floor at ``min_lr``."""

    def __init__(self, factor=0.5, patience=5, min_lr=1e-4, mode="max"):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.sign = 1.0 if mode == "max" else -1.0
        self.best = -np.inf
        self.wait = 0

    def update(self, value: float, lr: float) -> float:
        if self.sign * value > self.best:
            self.best = self.sign * value
            self.wait = 0
            return lr
        self.wait += 1
        if self.wait >= self.patience:
            self.wait = 0
            return max(self.min_lr, lr * self.factor)
        return lr


class CosineDecay:
    """Host-side cosine decay from ``base_lr`` to ``min_lr`` along half a
    cosine over ``total_epochs``."""

    def __init__(self, base_lr: float, total_epochs: int, min_lr: float = 1e-4):
        if total_epochs < 1:
            raise ValueError(f"total_epochs={total_epochs} must be >= 1")
        self.base_lr = base_lr
        self.total_epochs = total_epochs
        self.min_lr = min_lr

    def lr_at(self, epoch: int) -> float:
        """LR to use *for* ``epoch`` (epoch 0 -> base_lr)."""
        frac = min(max(epoch, 0), self.total_epochs) / self.total_epochs
        return self.min_lr + 0.5 * (self.base_lr - self.min_lr) * (
            1.0 + float(np.cos(np.pi * frac)))


def make_train_step(model, loss_fn, optimizer, metric_fns=None, mesh=None):
    """Build the train step of ``model`` (a ``UNet2DS`` or a ``UNet1D``).

    # Arguments
        loss_fn: f(yt, yp) -> tensor of any shape; its mean is the loss.
        optimizer: e.g. :func:`make_optimizer` over ``model``.
        metric_fns: {name: f(yt, yp) -> scalar}; the 7 neuron metrics by
            default.
        mesh: a ``parallel.mesh.Mesh`` for data parallelism. Every rank
            calls the step with the same global batch and takes its slice
            of it (a batch from ``make_put_fn(device, mesh)`` or
            ``global_batch_from_local`` is this rank's slice already). The
            BN statistics, the loss and the metrics are the global batch's
            (``losses.with_mesh`` binds the mesh to the functions that sum
            over the batch), and the gradients are combined before the
            optimizer step, so that parameters, BN buffers and optimizer
            state stay identical on every rank with no broadcast. Dropout
            masks are each rank's own: one process is reproduced only at
            ``drp=0``.

    # Returns
        step(x, y, generator=None) -> {name: float32 0-d tensor} on the
        device: the metrics of the forward taken before the update, and
        ``"loss"``. The parameters, BN running buffers and optimizer state
        are updated in place; each ``.grad`` holds this step's gradient.
    """
    metric_fns = metric_fns if metric_fns is not None else dict(L.NEURON_METRICS)
    if check_mesh(mesh) is not None:
        return _make_mesh_step(model, loss_fn, optimizer, metric_fns, mesh)

    def step(x, y, generator=None):
        probs = model(x, train=True, generator=generator)
        loss = loss_fn(y, probs).mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            p = probs.detach()
            metrics = {k: fn(y, p).mean().float() for k, fn in metric_fns.items()}
            metrics["loss"] = loss.detach().float()
        return metrics

    return step


def _make_mesh_step(model, loss_fn, optimizer, metric_fns, mesh):
    """The data-parallel train step. The mean over the global batch of a
    per-rank mean is ``psum(mean) / mesh.size``: the shards are equally
    large."""
    loss_fn = L.with_mesh(loss_fn, mesh)
    metric_fns = {k: L.with_mesh(fn, mesh) for k, fn in metric_fns.items()}
    params = [p for p in model.parameters() if p.requires_grad]

    def combine_gradients():
        """One all-reduce of every gradient. ``psum`` in the forward makes
        each rank's ``.grad`` ``mesh.size`` times its share of the global
        gradient (see ``parallel.mesh.psum``): their sum over the ranks,
        divided by ``mesh.size``, is the gradient of the global loss."""
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        flat /= mesh.size
        for g, combined in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(combined.view_as(g))

    def step(x, y, generator=None):
        x, y = local_shard(mesh, x), local_shard(mesh, y)
        probs = model(x, train=True, generator=generator, mesh=mesh)
        loss = psum(loss_fn(y, probs).mean(), mesh) / mesh.size
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        combine_gradients()
        optimizer.step()
        with torch.no_grad():
            p = probs.detach()
            keys = list(metric_fns)
            # One all-reduce for the global means of all the metrics.
            vals = torch.stack([metric_fns[k](y, p).mean().float()
                                for k in keys])
            dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=mesh.group)
            vals /= mesh.size
            metrics = dict(zip(keys, vals.unbind()))
            metrics["loss"] = loss.detach().float()
        return metrics

    return step


def make_multi_step(model, loss_fn, optimizer, nsteps: int, metric_fns=None,
                    ema=None, ema_decay=None, mesh=None):
    """K = ``nsteps`` train steps per call, the JAX package's
    ``make_multi_step``.

    The K steps are those of K calls of :func:`make_train_step` on
    ``xs[k], ys[k]`` (each one's metrics from the forward before its
    update), each followed by :func:`ema_update` of ``ema``'s parameters
    when ``ema_decay`` is set, as the JAX package's scan carries the
    average.

    On the CPU the steps run as a Python loop. On a CUDA device they are one
    CUDA graph: the first call captures the K steps (after one warm-up run
    of them, whose changes to the weights, BN buffers, Adam's state, the
    average and the dropout generator are undone), and every call copies
    its slab into the graph's static buffers and replays it once. The
    optimizer is made capturable first (:func:`make_capturable_`). A
    capture or replay that fails raises; no eager step takes its place.
    The graph holds the tensors it was captured with: the parameters, the
    buffers, Adam's state and the rate tensor of ``optimizer``'s groups
    (:func:`set_lr` fills it in place) must not be replaced afterwards, and
    every call passes the same dropout generator (or None, at drp=0) and
    slabs of one shape.

    # Arguments
        nsteps: K, the steps of one call.
        ema: a copy of ``model`` whose parameters hold the average, with
            ``ema_decay``.
        mesh: data parallelism as in :func:`make_train_step`; the slabs'
            dim 1 is the batch, and a ``LocalShard`` slab is this rank's
            rows already (``sampler.make_put_fn(device, mesh, kdisp)``).
        (the rest as in :func:`make_train_step`.)

    # Returns
        step(xs, ys, generator=None) -> {name: (K,) float32 tensor} on the
        device, for (K, B, ...) slabs ``xs`` and ``ys``.
    """
    nsteps = int(nsteps)
    if nsteps < 1:
        raise ValueError(f"nsteps={nsteps} must be >= 1")
    if (ema is None) != (ema_decay is None):
        raise ValueError("ema and ema_decay go together")
    one = make_train_step(model, loss_fn, optimizer, metric_fns, mesh)
    params = list(model.parameters())
    averaged = list(ema.parameters()) if ema is not None else None

    def rows(a):
        """This rank's rows of a slab, marked for the step."""
        if mesh is None:
            return a
        if not isinstance(a, LocalShard):
            a = shard_batch(mesh, a.transpose(0, 1)).transpose(0, 1)
        return a.as_subclass(LocalShard)

    def steps(xs, ys, generator=None):
        if xs.shape[0] != nsteps or ys.shape[0] != nsteps:
            raise ValueError(f"slabs of {xs.shape[0]} and {ys.shape[0]} "
                             f"batches for {nsteps} steps")
        xs, ys = rows(xs), rows(ys)
        out = []
        for k in range(nsteps):
            out.append(one(xs[k], ys[k], generator))
            if averaged is not None:
                ema_update(averaged, params, ema_decay)
        return {key: torch.stack([m[key] for m in out]) for key in out[0]}

    if params[0].device.type != "cuda":
        return steps
    make_capturable_(optimizer)
    return _GraphedSteps(steps, model, optimizer, ema)


@torch.no_grad()
def make_capturable_(optimizer):
    """Ready an Adam or AdamW over CUDA parameters for CUDA graph capture,
    in place: every group ``capturable=True`` with its learning rate as a
    0-d float32 tensor on the parameters' device, and every parameter's
    state present, its step count a device tensor. A missing state is
    Adam's fresh one (zero moments, step 0). Capturable Adam forms its bias
    corrections on the device in float32, where the default forms them on
    the host in float64: its updates differ from the default's by a few
    float32 ulps. Idempotent."""
    for group in optimizer.param_groups:
        dev = group["params"][0].device
        group["capturable"] = True
        if not torch.is_tensor(group["lr"]):
            group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32,
                                       device=dev)
        for p in group["params"]:
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32, device=dev)
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            else:
                state["step"] = state["step"].to(dev, torch.float32)
    return optimizer


class _GraphedSteps:
    """The K steps of :func:`make_multi_step` as one CUDA graph."""

    def __init__(self, steps, model, optimizer, ema):
        self.steps = steps
        self.model, self.optimizer, self.ema = model, optimizer, ema
        self.graph = None

    def _state(self):
        """Every tensor the steps change, but the gradients."""
        ts = list(self.model.parameters()) + list(self.model.buffers())
        for state in self.optimizer.state.values():
            ts += [v for v in state.values() if torch.is_tensor(v)]
        if self.ema is not None:
            ts += list(self.ema.parameters())
        return ts

    def _capture(self, xs, ys, generator):
        self.xs, self.ys = torch.empty_like(xs), torch.empty_like(ys)
        self.xs.copy_(xs)
        self.ys.copy_(ys)
        self.generator = generator
        # Warm up on a side stream (cuDNN, cuBLAS and the optimizer's first
        # calls must not happen inside the capture), then undo what the
        # warm-up changed, so that the first replay starts where K eager
        # steps would.
        tensors = self._state()
        saved = [t.detach().clone() for t in tensors]
        rng = generator.get_state() if generator is not None else None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.steps(self.xs, self.ys, generator)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        if generator is not None:
            generator.set_state(rng)
        del saved
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            # Each replay then draws the masks K eager steps would, and
            # advances the generator as far.
            graph.register_generator_state(generator)
        # thread_local: the prefetch thread may pin and copy meanwhile.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self.steps(self.xs, self.ys, generator)
            self.keys = list(out)
            self.out = torch.stack([out[k] for k in self.keys])
        self.graph = graph

    def __call__(self, xs, ys, generator=None):
        if self.graph is None:
            self._capture(xs, ys, generator)
        elif generator is not self.generator:
            raise ValueError("the graph replays the dropout generator it was "
                             "captured with; pass that one")
        elif xs.shape != self.xs.shape or ys.shape != self.ys.shape:
            raise ValueError(f"slabs of {tuple(xs.shape)} and "
                             f"{tuple(ys.shape)}; the graph was captured for "
                             f"{tuple(self.xs.shape)} and "
                             f"{tuple(self.ys.shape)}")
        else:
            self.xs.copy_(xs)
            self.ys.copy_(ys)
        self.graph.replay()
        # A copy: the next replay overwrites the graph's outputs.
        return dict(zip(self.keys, self.out.clone().unbind()))


def metric_rows(step_metrics, keys):
    """One (steps, len(keys)) tensor from the dicts that :func:`make_train_step`
    (0-d values) or :func:`make_multi_step` ((K,) values) return: a row a
    step, in order, so that K steps a call give K=1's rows."""
    return torch.cat([torch.stack([m[k] for k in keys], -1).reshape(-1, len(keys))
                      for m in step_metrics])


@torch.no_grad()
def ema_update(ema, params, decay: float):
    """Polyak averaging in place over parameters only:
    ``ema <- decay * ema + (1 - decay) * params``."""
    for e, p in zip(ema, params):
        e.mul_(decay).add_(p.detach(), alpha=1.0 - decay)


def make_eval_forward(model, mesh=None):
    """Inference forward: (B, H, W) -> (B, H, W) probabilities (or (B, T)
    -> (B, T) for a ``UNet1D``) with the BN running statistics. Eval-mode
    BN needs nothing of the other ranks, so the forward is the same under a
    ``mesh``: the callers in ``train.evaluate`` split each slab over the
    ranks and gather the results (``_run_batched``)."""
    check_mesh(mesh)

    @torch.inference_mode()
    def fwd(x):
        return model(x, train=False)

    return fwd
