"""UNet2DS: the 2-D summary-image segmentation U-Net as an ``nn.Module``.

Port of ``deepcalcium_tpu.models.unet2d`` (the forward in both modes) and of
the exact inference folds of ``deepcalcium_tpu.models.unet2d_fast`` (folded
BN and the sigmoid head). The public forward takes (B, H, W) and returns
(B, H, W) foreground probabilities as the JAX ``apply`` does; inside it runs
NCHW. Sub-modules are named by the JAX package's ``LAYER_ORDER`` keys, so
``from_jax_params`` / ``to_jax_params`` move weights between the packages
layer by layer, and :func:`jax_tree` / :func:`torch_tensors` move any
per-parameter tensors (Adam's moments) the same way.

The TPU lane-packing rewrites of ``unet2d_fast`` (``apply_fast_w`` and its
kin) are not ported: they reshape tensors for the TPU's 128-lane matrix
unit. ``fold()`` gives the folds alone, which is what ``fast="auto"`` runs.
"""

import copy

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepcalcium_torch.models import blocks as B
from deepcalcium_torch.models.blocks import fold_bn
from deepcalcium_torch.utils.profiling import span

__all__ = ["layer_order", "LAYER_ORDER", "UNet2DS", "fold_bn",
           "from_jax_params", "to_jax_params", "load_jax_params_",
           "jax_tree", "torch_tensors", "param_count", "forward_flops"]

_F = 32
_DEC_IN = {"dec3a_conv": 8, "dec2a_conv": 4, "dec1a_conv": 2, "dec0a_conv": 1}


def layer_order(nfb: int = _F, up_mode: str = "transpose"):
    """Weight-bearing layers as (name, kind, cout) in Keras build order;
    kind is conv3 | conv1 | tconv | bn. Same list as the JAX package's."""
    if up_mode not in ("transpose", "upsampling"):
        raise ValueError(f"unknown up_mode {up_mode!r}")
    f = nfb
    order = []

    def cbr(name, cout):
        order.append((f"{name}_conv", "conv3", cout))
        order.append((f"{name}_bn", "bn", cout))

    def up(name, cout):
        if up_mode == "transpose":
            order.append((f"{name}_tconv", "tconv", cout))
            order.append((f"{name}_bn", "bn", cout))

    for lvl, mul in enumerate((1, 2, 4, 8)):
        cbr(f"enc{lvl}a", f * mul)
        cbr(f"enc{lvl}b", f * mul)
    cbr("mida", f * 16)
    cbr("midb", f * 16)
    for lvl, mul in ((3, 8), (2, 4), (1, 2), (0, 1)):
        up(f"up{lvl}", f * mul)
        cbr(f"dec{lvl}a", f * mul)
        cbr(f"dec{lvl}b", f * mul)
    order.append(("head_conv", "conv1", 2))
    return order


LAYER_ORDER = layer_order()


class UNet2DS(nn.Module):
    """UNet2DS forward (``deepcalcium_tpu.models.unet2d.apply``).

    # Arguments
        nfb: filters of the first block (32 is the published width).
        up_mode: 'transpose' (Conv2DTranspose + BN, the published recipe) or
            'upsampling' (nearest-neighbour repeat, no weights).
        compute_dtype: e.g. ``torch.bfloat16``; None computes in the input's
            dtype. Parameters and BN statistics stay float32 and the softmax
            runs in float32.
        generator: CPU ``torch.Generator`` for the he_normal kernels; None
            draws from a generator seeded with 0. Kernels are drawn on the
            CPU, so a seed gives the same weights on every device; move
            the module with ``.to(device)``.
        drp: base dropout rate of the training forward (0.25 published).
        remat: recompute each conv-BN-ReLU block in the backward pass
            (``torch.utils.checkpoint``) instead of keeping its activations.
        init_scheme: how every conv, transpose-conv and head kernel is
            drawn: 'he_normal' (the published default), 'he_uniform',
            'glorot_uniform' or 'glorot_normal' (``blocks.kernel_init_``),
            the init axis of the hyperparameter search.
    """

    def __init__(self, nfb: int = _F, up_mode: str = "transpose",
                 compute_dtype=None, generator=None, drp: float = 0.25,
                 remat: bool = False, init_scheme: str = "he_normal"):
        super().__init__()
        self.nfb, self.up_mode = nfb, up_mode
        self.compute_dtype = compute_dtype
        self.drp, self.remat = drp, remat
        self.init_scheme = init_scheme
        self.folded = False
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        mult = 2 if up_mode == "transpose" else 3
        cin = 1
        for name, kind, cout in layer_order(nfb, up_mode):
            if kind == "conv3":
                cin = nfb * _DEC_IN[name] * mult if name in _DEC_IN else cin
                self.add_module(name, B.Conv2d(cin, cout, 3, generator,
                                                 init_scheme))
            elif kind == "conv1":
                self.add_module(name, B.Conv2d(cin, cout, 1, generator,
                                                 init_scheme))
            elif kind == "tconv":
                self.add_module(name, B.ConvTranspose2x2(
                    cin, cout, generator, init_scheme))
            else:
                # Keras momentum: 0.5 after the transpose convs, else 0.99.
                momentum = 0.5 if name.startswith("up") else 0.99
                self.add_module(name, B.BatchNorm(cout, momentum))
            cin = cout

    def jax_tree(self, tensors=None):
        return jax_tree(self, tensors)

    def torch_tensors(self, tree):
        return torch_tensors(self, tree)

    def _cbr_train(self, conv, bn, h, mesh=None):
        y = conv(h, self.compute_dtype)
        mean, var = B.batch_stats(y, mesh)
        return torch.relu(B.batch_norm(y, bn.weight, bn.bias, mean, var)), mean, var

    def _cbr(self, name, h, train, mesh=None):
        conv = getattr(self, f"{name}_conv")
        if self.folded:
            return torch.relu(conv(h, self.compute_dtype))
        bn = getattr(self, f"{name}_bn")
        if not train:
            return torch.relu(bn(conv(h, self.compute_dtype)))
        if self.remat:
            # The block draws no random numbers: no RNG state to keep
            # (reading it would also break a CUDA graph's capture).
            y, mean, var = checkpoint(self._cbr_train, conv, bn, h, mesh,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            y, mean, var = self._cbr_train(conv, bn, h, mesh)
        # Outside the checkpointed block, so the recompute in the backward
        # pass does not fold the batch statistics in a second time.
        bn.update_running(mean.detach(), var.detach())
        return y

    def _up(self, name, h, train, mesh=None):
        if self.up_mode == "upsampling":
            return h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        y = getattr(self, f"{name}_tconv")(h, self.compute_dtype)
        if not self.folded:
            y = getattr(self, f"{name}_bn")(y, train, mesh)
        return torch.relu(y)

    def forward(self, x, train: bool = False, generator=None, mesh=None,
                capture=None):
        """(B, H, W) -> (B, H, W) float32 probabilities; H, W % 16 == 0.

        ``train=True`` normalises by batch statistics, updates the BN
        running buffers in place, and applies dropout with keep-masks drawn
        from ``generator`` (a ``torch.Generator`` on the input's device).
        Skips are taken after dropout, as in the JAX package. With a
        ``mesh``, ``x`` is this rank's shard of the batch and the training
        statistics are the global batch's (``blocks.batch_stats``).

        ``capture``: an optional dict that each conv-BN-ReLU block fills
        with its post-ReLU activation, (B, C, H', W') in the compute dtype,
        under the JAX package's names in the order its ``apply`` fills them:
        ``enc0a`` ... ``enc3b``, ``mida``, ``midb``, ``dec3a`` ... ``dec0b``
        (18 entries; the ``up*`` blocks are not captured, as there). The
        tensors are the forward's own, not copies, and the output does not
        change by a bit. A folded net captures too: its blocks compute the
        same activations up to float rounding, since the fold is exact."""
        if train and self.folded:
            raise ValueError("a folded model has no BN to train")
        if train and self.drp and generator is None:
            raise ValueError("the training forward needs a generator for "
                             "dropout (or drp=0)")
        d = self.drp
        h = x[:, None].to(self.compute_dtype or x.dtype)
        skips = []

        def cbr(name, h):
            y = self._cbr(name, h, train, mesh)
            if capture is not None:
                capture[name] = y
            return y

        for lvl, rate in enumerate((0.0, d, 2 * d, 2 * d)):
            h = cbr(f"enc{lvl}b", cbr(f"enc{lvl}a", h))
            h = B.dropout(h, rate, train, generator)
            skips.append(h)
            h = B.maxpool2(h)
        h = cbr("midb", cbr("mida", h))
        for lvl in (3, 2, 1, 0):
            h = B.dropout(self._up(f"up{lvl}", h, train, mesh),
                          d if lvl == 0 else 2 * d, train, generator)
            # Channel order [up, skip], as the Keras builder concatenates.
            h = torch.cat([h, skips[lvl]], dim=1)
            h = cbr(f"dec{lvl}b", cbr(f"dec{lvl}a", h))
        head = self.head_conv
        if self.folded:
            # softmax([a, b])[1] == sigmoid(b - a), in float32.
            return torch.sigmoid(B.conv2d(h.float(), head.weight,
                                          head.bias)[:, 0])
        logits = head(h, self.compute_dtype)
        return torch.softmax(logits.float(), dim=1)[:, -1]

    @torch.no_grad()
    def fold(self) -> "UNet2DS":
        """A copy with every BN folded into its conv and the 2-channel
        softmax head turned into one sigmoid channel (exact up to float
        rounding; ``unet2d_fast.fold_bn`` and its sigmoid head)."""
        if self.folded:
            return self
        m = copy.deepcopy(self)
        prev = None
        for name, kind, _ in layer_order(self.nfb, self.up_mode):
            if kind == "bn":
                layer = getattr(m, prev)
                w, b = fold_bn(layer.weight, layer.bias, getattr(m, name),
                               out_dim=1 if prev.endswith("_tconv") else 0)
                layer.weight.copy_(w)
                layer.bias.copy_(b)
                delattr(m, name)
            prev = name
        head = m.head_conv
        head.weight = nn.Parameter(head.weight[1:] - head.weight[:1])
        head.bias = nn.Parameter(head.bias[1:] - head.bias[:1])
        m.folded = True
        return m


def _leaves(kind):
    """(torch attribute, JAX leaf) pairs of a layer's parameters."""
    if kind == "bn":
        return (("weight", "gamma"), ("bias", "beta"))
    return (("weight", "kernel"), ("bias", "bias"))


def jax_tree(model: UNet2DS, tensors=None):
    """``{layer: {leaf: float32 ndarray}}`` in the JAX package's params
    layout: of the model's parameters, or of ``tensors``, a map from each
    parameter's name (``"enc0a_conv.weight"``) to a tensor of its shape,
    such as Adam's moments. Arrays are copies.

    HWIO conv kernels and (p, q, o, c) transpose-conv kernels are PyTorch's
    OIHW and (c, o, p, q) permuted by ``(2, 3, 1, 0)``; at k = s = 2 the
    transpose conv needs no flip."""
    if model.folded:
        raise ValueError("a folded model has no BN layers to export")
    out = {}
    for name, kind, _ in layer_order(model.nfb, model.up_mode):
        layer = getattr(model, name)
        for attr, leaf in _leaves(kind):
            t = (getattr(layer, attr) if tensors is None
                 else tensors[f"{name}.{attr}"])
            a = t.detach().to("cpu", torch.float32).numpy()
            a = a.transpose(2, 3, 1, 0) if leaf == "kernel" else a
            out.setdefault(name, {})[leaf] = np.array(a, order="C")
    return out


def torch_tensors(model: UNet2DS, tree):
    """The inverse of :func:`jax_tree`: ``{parameter name: float32 CPU
    tensor}`` in PyTorch's layouts from a tree in the JAX params layout."""
    out = {}
    for name, kind, _ in layer_order(model.nfb, model.up_mode):
        for attr, leaf in _leaves(kind):
            t = torch.from_numpy(np.array(tree[name][leaf], dtype=np.float32))
            out[f"{name}.{attr}"] = (t.permute(3, 2, 0, 1).contiguous()
                                     if leaf == "kernel" else t)
    return out


@torch.no_grad()
def load_jax_params_(model: UNet2DS, params, state) -> UNet2DS:
    """Copy (params, state) in the JAX package's layout into ``model`` in
    place, on whatever device it lives."""
    sd = torch_tensors(model, params)
    for name, kind, _ in layer_order(model.nfb, model.up_mode):
        if kind == "bn":
            sd[f"{name}.running_mean"] = torch.from_numpy(
                np.array(state[name]["mean"], dtype=np.float32))
            sd[f"{name}.running_var"] = torch.from_numpy(
                np.array(state[name]["var"], dtype=np.float32))
    model.load_state_dict(sd)
    return model


def from_jax_params(params, state, compute_dtype=None, device=None,
                    **kwargs) -> UNet2DS:
    """Build a ``UNet2DS`` from the JAX package's (params, state) dicts
    (numpy or JAX arrays, or CPU tensors); nfb and up_mode are read off the
    shapes. ``kwargs`` go to ``UNet2DS`` (``drp``, ``remat``)."""
    nfb = int(np.shape(params["enc0a_conv"]["kernel"])[-1])
    up_mode = "transpose" if "up0_tconv" in params else "upsampling"
    with span("net.init"):
        model = UNet2DS(nfb, up_mode, compute_dtype, **kwargs)
    with span("net.load"):
        load_jax_params_(model, params, state)
    if device is None:
        return model
    with span("net.upload"):
        return model.to(device)


def to_jax_params(model: UNet2DS):
    """The inverse of :func:`from_jax_params`: (params, state) dicts of
    float32 numpy arrays in the JAX package's layout (copies)."""
    params = jax_tree(model)
    state = {}
    for name, kind, _ in layer_order(model.nfb, model.up_mode):
        if kind == "bn":
            bn = getattr(model, name)
            state[name] = {"mean": bn.running_mean.detach().cpu().numpy().copy(),
                           "var": bn.running_var.detach().cpu().numpy().copy()}
    return params, state


def param_count(model: UNet2DS) -> int:
    """Weights of the net, as the JAX package counts its params leaves."""
    return sum(p.numel() for p in model.parameters())


def forward_flops(h: int, w: int, nfb: int = _F,
                  up_mode: str = "transpose") -> int:
    """Analytic FLOPs (2 * MACs) of one forward on one (h, w) image, convs
    and transpose convs only (``deepcalcium_tpu.models.unet2d.forward_flops``)."""
    if h % 16 or w % 16:
        raise ValueError(f"H and W must be multiples of 16, got {(h, w)}")
    f = nfb
    fl = 0
    hh, ww = h, w
    enc = [(1, f), (f, 2 * f), (2 * f, 4 * f), (4 * f, 8 * f), (8 * f, 16 * f)]
    for i, (cin, cout) in enumerate(enc):
        fl += 2 * 9 * (cin + cout) * cout * hh * ww
        if i < len(enc) - 1:
            hh, ww = hh // 2, ww // 2
    cup = 16 * f
    for cout in (8 * f, 4 * f, 2 * f, f):
        if up_mode == "transpose":
            fl += 2 * 4 * cup * cout * hh * ww
            cat = cout + cout
        else:
            cat = cup + cout
        hh, ww = hh * 2, ww * 2
        fl += 2 * 9 * (cat + cout) * cout * hh * ww
        cup = cout
    fl += 2 * f * 2 * hh * ww
    return fl
