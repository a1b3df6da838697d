"""The weight layer of ``UNet2DS`` and ``UNet1D``: their weights between the
JAX package's (params, state) layout and PyTorch's, the direct build of a
net from them, the BN fold, and the choice of an inference net's route.

Each function takes a net or its class and reads of it what differs
between the two nets: ``_layers``, ``_kernel_perm``, ``_kernel``,
``_momentum``, ``_fold_head``, ``_arch`` and ``_configure`` (which the
constructor calls too). ``unet2d`` and ``unet1d`` export these functions
under their old names, bound to their class where one is needed.
"""

import copy
import functools
import itertools
import threading

import numpy as np
import torch
from torch import nn

from deepcalcium_torch.models import blocks as B
from deepcalcium_torch.utils.profiling import span

__all__ = ["jax_tree", "torch_tensors", "load_jax_params_", "to_jax_params",
           "param_count", "from_jax_params", "inference_net", "fold",
           "inference_route", "upload_packed", "holding"]


def _leaves(kind):
    """(torch attribute, JAX leaf) pairs of a layer's parameters."""
    if kind == "bn":
        return (("weight", "gamma"), ("bias", "beta"))
    return (("weight", "kernel"), ("bias", "bias"))


def jax_tree(model, tensors=None):
    """``{layer: {leaf: float32 ndarray}}`` in the JAX package's params
    layout: of the model's parameters, or of ``tensors``, a map from each
    parameter's name (``"enc0a_conv.weight"``) to a tensor of its shape,
    such as Adam's moments. Kernels are PyTorch's permuted by the inverse
    of ``_kernel_perm``. Arrays are copies."""
    if model.folded:
        raise ValueError("a folded model has no BN layers to export")
    inverse = tuple(np.argsort(model._kernel_perm))
    out = {}
    for name, kind, _, _ in model._layers():
        layer = getattr(model, name)
        for attr, leaf in _leaves(kind):
            t = (getattr(layer, attr) if tensors is None
                 else tensors[f"{name}.{attr}"])
            a = t.detach().to("cpu", torch.float32).numpy()
            a = a.transpose(inverse) if leaf == "kernel" else a
            out.setdefault(name, {})[leaf] = np.array(a, order="C")
    return out


def torch_tensors(model, tree):
    """The inverse of :func:`jax_tree`: ``{parameter name: float32 CPU
    tensor}`` in PyTorch's layouts from a tree in the JAX params layout."""
    out = {}
    for name, kind, _, _ in model._layers():
        for attr, leaf in _leaves(kind):
            t = torch.from_numpy(np.array(tree[name][leaf], dtype=np.float32))
            out[f"{name}.{attr}"] = (
                t.permute(*model._kernel_perm).contiguous()
                if leaf == "kernel" else t)
    return out


@torch.no_grad()
def load_jax_params_(model, params, state):
    """Copy (params, state) in the JAX package's layout into ``model`` in
    place, on whatever device it lives."""
    sd = torch_tensors(model, params)
    for name, kind, _, _ in model._layers():
        if kind == "bn":
            sd[f"{name}.running_mean"] = torch.from_numpy(
                np.array(state[name]["mean"], dtype=np.float32))
            sd[f"{name}.running_var"] = torch.from_numpy(
                np.array(state[name]["var"], dtype=np.float32))
    model.load_state_dict(sd)
    return model


def to_jax_params(model):
    """The inverse of :func:`from_jax_params`: (params, state) dicts of
    float32 numpy arrays in the JAX package's layout (copies)."""
    params = jax_tree(model)
    state = {}
    for name, kind, _, _ in model._layers():
        if kind == "bn":
            bn = getattr(model, name)
            state[name] = {"mean": bn.running_mean.detach().cpu().numpy().copy(),
                           "var": bn.running_var.detach().cpu().numpy().copy()}
    return params, state


def param_count(model) -> int:
    """Weights of the net, as the JAX package counts its params leaves."""
    return sum(p.numel() for p in model.parameters())


# --- the BN fold ---------------------------------------------------------------


def _fold(net, t):
    """Fold in place every BN of ``t`` (layer name to a (weight, bias)
    pair, or to a ``BatchNorm`` or ``blocks.BNTensors`` for a BN) into the
    layer before it (:func:`blocks.fold_bn`), and rewrite the head by the
    net's ``_fold_head``. The BNs leave ``t``."""
    for (a, kind, cin, cout), (b, nxt, _, _) in itertools.pairwise(
            net._layers()):
        if nxt == "bn":
            t[a] = B.fold_bn(*t[a], t.pop(b),
                             out_dim=net._kernel(kind, cin, cout)[0].out_dim)
    t["head_conv"] = net._fold_head(*t["head_conv"])


@torch.no_grad()
def fold(model):
    """A copy with every BN folded into the conv or transpose conv before
    it and the head rewritten for inference (exact up to float rounding);
    ``model`` is left as it is. The copy runs inference only."""
    if model.folded:
        return model
    m = copy.deepcopy(model)
    t = {}
    for name, kind, _, _ in m._layers():
        layer = getattr(m, name)
        t[name] = layer if kind == "bn" else (layer.weight, layer.bias)
    _fold(m, t)
    for name, _, _, _ in m._layers():
        if name in t:
            layer = getattr(m, name)
            layer.weight, layer.bias = (nn.Parameter(x) for x in t[name])
        else:
            delattr(m, name)
    m.folded = True
    return m


# --- the direct build ------------------------------------------------------------

# The host buffers that ``upload_packed`` packs into, page-locked (True) or
# not: kept across calls, grown when a larger net needs more, overwritten by
# every call. A staging buffer, not a cache: nothing of a call is read back.
_staging: dict = {}
_staging_lock = threading.Lock()


def upload_packed(leaves, device):
    """``leaves``, (label, array, shape) triples, as float32 views of one
    buffer on ``device``, in their order.

    Each array (numpy or JAX, or a CPU tensor) is cast to float32 as
    ``np.array(a, dtype=np.float32)`` casts it and copied into a host
    staging buffer, page-locked for a CUDA device (the span ``net.pack``);
    the buffer then goes to ``device`` in one synchronous copy
    (``net.upload``), so that the next call may overwrite it. An array of
    another shape than its triple's raises ``ValueError``."""
    device = torch.device(device)
    pinned = device.type == "cuda"
    with _staging_lock:
        with span("net.pack"):
            arrays = []
            for label, a, shape in leaves:
                a = np.asarray(a)
                if a.shape != tuple(shape):
                    raise ValueError(f"{label}: shape {a.shape}, expected "
                                     f"{tuple(shape)}")
                arrays.append(a)
            n = sum(a.size for a in arrays)
            stage = _staging.get(pinned)
            if stage is None or stage.numel() < n:
                stage = _staging[pinned] = torch.empty(
                    n, dtype=torch.float32, pin_memory=pinned)
            host = stage.numpy()
            o = 0
            for a in arrays:
                np.copyto(host[o:o + a.size].reshape(a.shape), a,
                          casting="unsafe")
                o += a.size
        with span("net.upload"):
            buf = torch.empty(n, dtype=torch.float32, device=device)
            buf.copy_(stage[:n])
    out, o = [], 0
    for a in arrays:
        out.append(buf[o:o + a.size].view(a.shape))
        o += a.size
    return out


def holding(cls, params, buffers=None, **attrs):
    """A ``cls`` module made without its constructor, so that nothing is
    drawn: its attributes are ``attrs``, its parameters the tensors of
    ``params`` and its buffers those of ``buffers`` (name to tensor, in
    order)."""
    m = cls.__new__(cls)
    nn.Module.__init__(m)
    m.__dict__.update(attrs)
    for name, t in params.items():
        m.register_parameter(name, nn.Parameter(t))
    for name, t in (buffers or {}).items():
        m.register_buffer(name, t)
    return m


@torch.no_grad()
def _build(cls, params, state, compute_dtype, device, fold, kwargs):
    """A ``cls`` net on ``device`` straight from (params, state), no weight
    drawn: every leaf packed into one buffer and copied to the device at
    once (:func:`upload_packed`), the kernels permuted to PyTorch's layouts
    there (``net.load``), BN folded there when ``fold`` (``net.fold``, as
    :func:`fold` computes it), and the module assembled around the tensors
    (``net.init``). The weights are bitwise those of the drawn, loaded,
    moved (and folded) net."""
    net = holding(cls, {})
    net._configure(**cls._arch(params), compute_dtype=compute_dtype,
                   **kwargs)
    net.folded = fold
    layers = list(net._layers())
    leaves = []
    for name, kind, cin, cout in layers:
        if kind == "bn":
            leaves += [(f"{name}.{leaf}", tree[name][leaf], (cout,))
                       for tree, leaf in ((params, "gamma"), (params, "beta"),
                                          (state, "mean"), (state, "var"))]
        else:
            leaves += [(f"{name}.kernel", params[name]["kernel"],
                        cls._kernel(kind, cin, cout)[1]),
                       (f"{name}.bias", params[name]["bias"], (cout,))]
    flat = iter(upload_packed(leaves, "cpu" if device is None else device))
    # Unfolded, each bias and BN tensor gets storage of its own: views of
    # one buffer share its autograd version, so a training forward's
    # in-place BN update would void what its backward saved.
    own = (lambda x: x) if fold else torch.clone
    t = {}
    with span("net.load"):
        for name, kind, _, _ in layers:
            if kind == "bn":
                t[name] = B.BNTensors(*(own(next(flat)) for _ in range(4)))
            else:
                t[name] = (next(flat).permute(*cls._kernel_perm).contiguous(),
                           own(next(flat)))
    if fold:
        with span("net.fold"):
            _fold(net, t)
    with span("net.init"):
        for name, kind, cin, cout in layers:
            if name not in t:
                continue
            if kind == "bn":
                bn = t[name]
                layer = holding(
                    B.BatchNorm, {"weight": bn.weight, "bias": bn.bias},
                    {"running_mean": bn.running_mean,
                     "running_var": bn.running_var},
                    momentum=net._momentum(name))
            else:
                w, b = t[name]
                layer = holding(cls._kernel(kind, cin, cout)[0],
                                {"weight": w, "bias": b})
            net.add_module(name, layer)
    return net


def from_jax_params(cls, params, state, compute_dtype=None, device=None,
                    **kwargs):
    """Build a ``cls`` net from the JAX package's (params, state) dicts
    (numpy or JAX arrays, or CPU tensors) on ``device`` (None: the CPU);
    its width (and up mode) are read off the shapes. ``kwargs`` go where
    ``cls`` takes them (``drp``, ``remat``, ``margin``). No weight is
    drawn: the net is bitwise ``cls(...)`` with :func:`load_jax_params_`
    and ``.to(device)``."""
    return _build(cls, params, state, compute_dtype, device, False, kwargs)


def inference_net(cls, params, state, compute_dtype=None, device=None,
                  fold=True, **kwargs):
    """The eval-mode net of (params, state) on ``device``, folded
    (bitwise ``from_jax_params(...).eval().fold()``) when ``fold``: no
    unfolded net is built, nothing is drawn or deep-copied, and every
    call reads the arrays it is given."""
    return _build(cls, params, state, compute_dtype, device, fold,
                  kwargs).eval()


# --- the inference route -----------------------------------------------------------


def inference_route(cls, net_func, params, state, compute_dtype, device,
                    fast, auto, **kwargs):
    """The eval-mode net an inference entry runs, as the JAX package's
    wrappers pick their forward.

    The stock net, ``net_func`` None, ``cls`` or a ``functools.partial`` of
    it, is built straight off the weights (:func:`inference_net`: one
    packed upload, nothing drawn), which give its width; any other
    ``net_func`` is called as ``fit`` calls it, with a generator seeded
    with 0, and the weights are loaded into it. ``kwargs`` go to both.
    ``fast=True`` folds BN into the convs with the net's head
    (:func:`fold`, exact up to float rounding) whatever the net is;
    ``fast="auto"`` folds a net whose type is ``cls`` itself when ``auto``,
    the net's own condition, holds; anything else runs the unfolded net.
    ``net.folded`` tells which ran."""
    stock = net_func is None or net_func is cls or (
        isinstance(net_func, functools.partial) and net_func.func is cls)
    if stock:
        return inference_net(cls, params, state, compute_dtype, device,
                             fold=fast is True or (fast == "auto" and auto),
                             **kwargs)
    net = load_jax_params_(net_func(
        compute_dtype=compute_dtype,
        generator=torch.Generator().manual_seed(0), **kwargs),
        params, state).to(device).eval()
    if fast is True or (fast == "auto" and type(net) is cls and auto):
        with span("net.fold"):
            net = net.fold()
    return net
