"""UNet1D: the 1-D spike-segmentation U-Net as an ``nn.Module``.

Port of ``deepcalcium_tpu.models.unet1d``. The public forward takes (B, T)
calcium traces and returns (B, T) spike probabilities as the JAX ``apply``
does; inside it runs NCW. The net:

- conv block = Conv1D(k=5, SAME) -> BN (momentum 0.99) -> ReLU; filters
  nfb..16 nfb with a window-2 max-pool on the way down;
- weight-free UpSampling1D (repeat x2) on the way up, concatenated as
  [up, skip], so the post-concat convs see (up + skip) channels;
- dropout at ``drp`` and ``2 drp`` where ``apply`` puts them;
- head: Conv1D(2, 1), cast to float32, a SAME max-pool of width
  ``margin + 1`` (the +-margin/2 temporal tolerance) and a 2-channel
  softmax whose last channel is the output.

Sub-modules are named by the JAX package's ``LAYER_ORDER`` keys, so
``from_jax_params`` / ``to_jax_params`` move weights between the packages
and :func:`jax_tree` / :func:`torch_tensors` move any per-parameter tensors
(Adam's moments) the same way.

``fold()`` ports the exact rewrites of ``unet1d_fast.apply_fast_t``: BN
folded into every conv, and the head as float32 logits, the margin
max-pool, then the sigmoid of their difference. Its T-packing is not
ported: it packs time into channels to fill the TPU's 128-lane matrix
unit, and on Hopper it would only multiply the thin levels' FLOPs.
"""

import copy

import numpy as np
import torch
from torch import nn

from deepcalcium_torch.models import blocks as B
from deepcalcium_torch.utils.profiling import span

__all__ = ["layer_order", "LAYER_ORDER", "UNet1D", "from_jax_params",
           "to_jax_params", "load_jax_params_", "jax_tree", "torch_tensors",
           "param_count", "forward_flops"]

_F = 32

# Channel counts arriving at each post-concat conv, in units of nfb:
# [up, skip], the up branch not reduced (UpSampling keeps channels).
_CONCAT_CIN = {
    "dec3a_conv": (16, 8),
    "dec2a_conv": (8, 4),
    "dec1a_conv": (4, 2),
    "dec0a_conv": (2, 1),
}


def layer_order(nfb: int = _F):
    """Weight-bearing layers as (name, kind, cout) in Keras build order;
    kind is conv5 | conv1 | bn. Same list as the JAX package's."""
    f = nfb
    order = []

    def cbr(name, cout):
        order.append((f"{name}_conv", "conv5", cout))
        order.append((f"{name}_bn", "bn", cout))

    for lvl, mul in enumerate((1, 2, 4, 8)):
        cbr(f"enc{lvl}a", f * mul)
        cbr(f"enc{lvl}b", f * mul)
    cbr("mida", f * 16)
    cbr("midb", f * 16)
    for lvl, mul in ((3, 8), (2, 4), (1, 2), (0, 1)):
        cbr(f"dec{lvl}a", f * mul)
        cbr(f"dec{lvl}b", f * mul)
    order.append(("head_conv", "conv1", 2))
    return order


LAYER_ORDER = layer_order()


class UNet1D(nn.Module):
    """UNet1D forward (``deepcalcium_tpu.models.unet1d.apply``).

    # Arguments
        nfb: filters of the first block (32 is the published width, 4.37M
            weights).
        margin: the head's max-pool covers ``margin + 1`` samples (the
            error margin of the labels); 0 turns it off.
        compute_dtype: e.g. ``torch.bfloat16``; None computes in the
            input's dtype. Parameters and BN statistics stay float32; the
            head's max-pool and softmax run in the parameters' dtype, so
            float32, and float64 in a net cast with ``.double()`` that is
            given float64 traces.
        generator: CPU ``torch.Generator`` for the he_normal kernels; None
            draws from a generator seeded with 0. Move the module with
            ``.to(device)``.
        drp: base dropout rate of the training forward (0.05 published).
    """

    def __init__(self, nfb: int = _F, margin: int = 4, compute_dtype=None,
                 generator=None, drp: float = 0.05):
        super().__init__()
        self.nfb, self.margin = nfb, int(margin)
        self.compute_dtype, self.drp = compute_dtype, drp
        self.folded = False
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cin = 1
        for name, kind, cout in layer_order(nfb):
            if kind == "bn":
                self.add_module(name, B.BatchNorm(cout, 0.99))
                continue
            if name in _CONCAT_CIN:
                cin = sum(_CONCAT_CIN[name]) * nfb
            k = 5 if kind == "conv5" else 1
            self.add_module(name, B.Conv1d(cin, cout, k, generator))
            cin = cout

    def jax_tree(self, tensors=None):
        return jax_tree(self, tensors)

    def torch_tensors(self, tree):
        return torch_tensors(self, tree)

    def _cbr(self, name, h, train, mesh=None):
        y = getattr(self, f"{name}_conv")(h, self.compute_dtype)
        if self.folded:
            return torch.relu(y)
        bn = getattr(self, f"{name}_bn")
        return torch.relu(bn(y, train, mesh))

    def forward(self, x, train: bool = False, generator=None, mesh=None):
        """(B, T) -> (B, T) float32 probabilities; T % 16 == 0.

        ``train=True`` normalises by batch statistics, updates the BN
        running buffers in place, and applies dropout with keep-masks drawn
        from ``generator`` (a ``torch.Generator`` on the input's device).
        Skips are taken after dropout, as in the JAX package. With a
        ``mesh``, ``x`` is this rank's shard of the batch and the training
        statistics are the global batch's (``blocks.batch_stats``)."""
        if train and self.folded:
            raise ValueError("a folded model has no BN to train")
        if train and self.drp and generator is None:
            raise ValueError("the training forward needs a generator for "
                             "dropout (or drp=0)")
        d = self.drp
        h = x[:, None].to(self.compute_dtype or x.dtype)
        skips = []
        for lvl, rate in enumerate((0.0, d, 2 * d, 2 * d)):
            h = self._cbr(f"enc{lvl}b",
                          self._cbr(f"enc{lvl}a", h, train, mesh), train, mesh)
            h = B.dropout(h, rate, train, generator)
            skips.append(h)
            h = B.pool2(h)
        h = self._cbr("midb", self._cbr("mida", h, train, mesh), train, mesh)
        for lvl in (3, 2, 1, 0):
            h = B.dropout(B.upsample1d(h), d if lvl == 0 else 2 * d, train,
                          generator)
            h = torch.cat([h, skips[lvl]], dim=1)
            h = self._cbr(f"dec{lvl}b",
                          self._cbr(f"dec{lvl}a", h, train, mesh), train, mesh)
        head = self.head_conv
        if self.folded:
            # Logits in the parameters' dtype, pooled before the difference
            # (the pool does not commute with it):
            # softmax([a, b])[1] == sigmoid(b - a).
            logits = B.maxpool1d_same(
                B.conv1d(h.to(head.weight.dtype), head.weight, head.bias),
                self.margin + 1)
            return torch.sigmoid(logits[:, 1] - logits[:, 0])
        logits = head(h, self.compute_dtype).to(head.weight.dtype)
        logits = B.maxpool1d_same(logits, self.margin + 1)
        return torch.softmax(logits, dim=1)[:, -1]

    @torch.no_grad()
    def fold(self) -> "UNet1D":
        """A copy with every BN folded into its conv, in float32, and the
        head of ``unet1d_fast.apply_fast_t`` (exact up to float rounding).
        It runs inference only."""
        if self.folded:
            return self
        m = copy.deepcopy(self)
        for name, kind, _ in layer_order(self.nfb):
            if kind == "bn":
                conv = getattr(m, name.replace("_bn", "_conv"))
                w, b = B.fold_bn(conv.weight, conv.bias, getattr(m, name))
                conv.weight.copy_(w)
                conv.bias.copy_(b)
                delattr(m, name)
        m.folded = True
        return m


def _leaves(kind):
    """(torch attribute, JAX leaf) pairs of a layer's parameters."""
    if kind == "bn":
        return (("weight", "gamma"), ("bias", "beta"))
    return (("weight", "kernel"), ("bias", "bias"))


def jax_tree(model: UNet1D, tensors=None):
    """``{layer: {leaf: float32 ndarray}}`` in the JAX package's params
    layout: of the model's parameters, or of ``tensors``, a map from each
    parameter's name (``"enc0a_conv.weight"``) to a tensor of its shape,
    such as Adam's moments. WIO kernels are PyTorch's OIW permuted by
    (2, 1, 0). Arrays are copies."""
    if model.folded:
        raise ValueError("a folded model has no BN layers to export")
    out = {}
    for name, kind, _ in layer_order(model.nfb):
        layer = getattr(model, name)
        for attr, leaf in _leaves(kind):
            t = (getattr(layer, attr) if tensors is None
                 else tensors[f"{name}.{attr}"])
            a = t.detach().to("cpu", torch.float32).numpy()
            a = a.transpose(2, 1, 0) if leaf == "kernel" else a
            out.setdefault(name, {})[leaf] = np.array(a, order="C")
    return out


def torch_tensors(model: UNet1D, tree):
    """The inverse of :func:`jax_tree`: ``{parameter name: float32 CPU
    tensor}`` in PyTorch's layouts from a tree in the JAX params layout."""
    out = {}
    for name, kind, _ in layer_order(model.nfb):
        for attr, leaf in _leaves(kind):
            t = torch.from_numpy(np.array(tree[name][leaf], dtype=np.float32))
            out[f"{name}.{attr}"] = (t.permute(2, 1, 0).contiguous()
                                     if leaf == "kernel" else t)
    return out


@torch.no_grad()
def load_jax_params_(model: UNet1D, params, state) -> UNet1D:
    """Copy (params, state) in the JAX package's layout into ``model`` in
    place, on whatever device it lives."""
    sd = torch_tensors(model, params)
    for name, kind, _ in layer_order(model.nfb):
        if kind == "bn":
            sd[f"{name}.running_mean"] = torch.from_numpy(
                np.array(state[name]["mean"], dtype=np.float32))
            sd[f"{name}.running_var"] = torch.from_numpy(
                np.array(state[name]["var"], dtype=np.float32))
    model.load_state_dict(sd)
    return model


def from_jax_params(params, state, compute_dtype=None, device=None,
                    **kwargs) -> UNet1D:
    """Build a ``UNet1D`` from the JAX package's (params, state) dicts
    (numpy or JAX arrays, or CPU tensors); nfb is read off the shapes.
    ``kwargs`` go to ``UNet1D`` (``margin``, ``drp``)."""
    nfb = int(np.shape(params["enc0a_conv"]["kernel"])[-1])
    with span("net.init"):
        model = UNet1D(nfb, compute_dtype=compute_dtype, **kwargs)
    with span("net.load"):
        load_jax_params_(model, params, state)
    if device is None:
        return model
    with span("net.upload"):
        return model.to(device)


def to_jax_params(model: UNet1D):
    """The inverse of :func:`from_jax_params`: (params, state) dicts of
    float32 numpy arrays in the JAX package's layout (copies)."""
    params = jax_tree(model)
    state = {}
    for name, kind, _ in layer_order(model.nfb):
        if kind == "bn":
            bn = getattr(model, name)
            state[name] = {"mean": bn.running_mean.detach().cpu().numpy().copy(),
                           "var": bn.running_var.detach().cpu().numpy().copy()}
    return params, state


def param_count(model: UNet1D) -> int:
    """Weights of the net, as the JAX package counts its params leaves."""
    return sum(p.numel() for p in model.parameters())


def forward_flops(t: int, nfb: int = _F) -> int:
    """Analytic FLOPs (2 * MACs) of one forward on one length-``t`` trace,
    convs only (``deepcalcium_tpu.models.unet1d.forward_flops``)."""
    if t % 16:
        raise ValueError(f"T must be a multiple of 16, got {t}")
    f = nfb
    fl = 0
    tt = t
    enc = [(1, f), (f, 2 * f), (2 * f, 4 * f), (4 * f, 8 * f), (8 * f, 16 * f)]
    for i, (cin, cout) in enumerate(enc):
        fl += 2 * 5 * (cin + cout) * cout * tt
        if i < len(enc) - 1:
            tt //= 2
    cup = 16 * f
    for cout in (8 * f, 4 * f, 2 * f, f):
        tt *= 2
        fl += 2 * 5 * (cup + cout + cout) * cout * tt
        cup = cout
    fl += 2 * f * 2 * t
    return fl
