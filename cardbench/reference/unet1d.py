"""UNet1D, the published 1-D spike-segmentation U-Net of deep-calcium
(``deepcalcium/models/spikes/unet_1d_segmentation.py``), in plain PyTorch.

Four levels of two k=5 SAME conv -> BN -> ReLU blocks with window-2
max-pools, a middle pair at 16 nfb, and on the way up a repeat x2 (no
weights) concatenated as [up, skip] before two more blocks; dropout at
(0, d, 2d, 2d) after the encoder levels and (2d, 2d, 2d, d) after the
upsamplings of levels 3..0; a 1x1 conv to 2 channels in float32, a SAME
max-pool over ``margin + 1`` samples (``(w - 1) // 2`` of -inf padding
before, the rest after), and a softmax whose last channel is the spike
probability. Weights as in :mod:`.unet2ds` (OIW convs)."""

import numpy as np
import torch
import torch.nn.functional as F

from cardbench.reference.unet2ds import BN_EPS

DROP_SITES = (("enc1", 1), ("enc2", 2), ("enc3", 2),
              ("up3", 2), ("up2", 2), ("up1", 2), ("up0", 1))


def layers(nfb=32):
    """(name, kind, cin, cout) of every weight-bearing layer in build
    order; kind is conv5 | conv1 | bn."""
    f, out = nfb, []
    cin = 1

    def cbr(name, ci, co):
        out.append((f"{name}_conv", "conv5", ci, co))
        out.append((f"{name}_bn", "bn", co, co))

    for lvl, mul in enumerate((1, 2, 4, 8)):
        cbr(f"enc{lvl}a", cin, f * mul)
        cbr(f"enc{lvl}b", f * mul, f * mul)
        cin = f * mul
    cbr("mida", 8 * f, 16 * f)
    cbr("midb", 16 * f, 16 * f)
    cin = 16 * f
    for lvl, mul in ((3, 8), (2, 4), (1, 2), (0, 1)):
        cbr(f"dec{lvl}a", cin + f * mul, f * mul)
        cbr(f"dec{lvl}b", f * mul, f * mul)
        cin = f * mul
    out.append(("head_conv", "conv1", f, 2))
    return out


def param_count(nfb=32):
    n = 0
    for _, kind, ci, co in layers(nfb):
        k = {"conv5": 5, "conv1": 1, "bn": 0}[kind]
        n += ci * co * k + co if kind != "bn" else 2 * co
    return n


def forward_flops(t, nfb=32):
    """2 x multiply-adds of the convs of one forward on one length-t
    trace."""
    fl = 0
    for name, kind, ci, co in layers(nfb):
        if kind == "bn":
            continue
        lvl = (4 if name.startswith("mid") else
               int(name[3]) if name.startswith(("enc", "dec")) else 0)
        fl += 2 * (5 if kind == "conv5" else 1) * ci * co * (t >> lvl)
    return fl


def from_jax_layout(params, state, device, dtype=torch.float32):
    """The weight dict from the checkpoint format's trees (WIO kernels)."""
    W = {}
    for name, leaves in params.items():
        for leaf, a in leaves.items():
            t = torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
            if leaf == "kernel":
                W[f"{name}.weight"] = t.permute(2, 1, 0).contiguous()
            elif leaf in ("bias", "beta"):
                W[f"{name}.bias"] = t
            elif leaf == "gamma":
                W[f"{name}.weight"] = t
    for name, st in state.items():
        W[f"{name}.mean"] = torch.as_tensor(np.asarray(st["mean"]), dtype=dtype,
                                            device=device)
        W[f"{name}.var"] = torch.as_tensor(np.asarray(st["var"]), dtype=dtype,
                                           device=device)
    return W


def forward(W, x, *, margin=4, train=False, drp=0.05, drop=None, quant=None,
            stats=None, logits=False):
    """(B, T) float -> (B, T) spike probabilities, or with ``logits`` the
    pooled logit difference whose sigmoid they are; the other arguments
    as :func:`cardbench.reference.unet2ds.forward`."""
    q = quant or (lambda t: t)

    def conv(name, h):
        w, b = W[f"{name}.weight"], W[f"{name}.bias"]
        return F.conv1d(q(h), q(w), padding=w.shape[-1] // 2) + b[:, None]

    def bn(name, y):
        if train:
            var, mean = torch.var_mean(y, dim=(0, 2), correction=0)
            if stats is not None:
                stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = W[f"{name}.mean"], W[f"{name}.var"]
        scale = torch.rsqrt(var + BN_EPS) * W[f"{name}.weight"]
        return (y - mean[:, None]) * scale[:, None] + W[f"{name}.bias"][:, None]

    def cbr(name, h):
        return torch.relu(bn(f"{name}_bn", conv(f"{name}_conv", h)))

    def dropout(site, h, rate):
        if not train or drop is None or rate == 0:
            return h
        return drop(site, h, rate)

    rates = dict(DROP_SITES)
    h = x[:, None]
    skips = []
    for lvl in range(4):
        h = cbr(f"enc{lvl}b", cbr(f"enc{lvl}a", h))
        if lvl:
            h = dropout(f"enc{lvl}", h, rates[f"enc{lvl}"] * drp)
        skips.append(h)
        h = F.max_pool1d(h, 2)
    h = cbr("midb", cbr("mida", h))
    for lvl in (3, 2, 1, 0):
        h = dropout(f"up{lvl}", h.repeat_interleave(2, dim=2),
                    rates[f"up{lvl}"] * drp)
        h = torch.cat([h, skips[lvl]], dim=1)
        h = cbr(f"dec{lvl}b", cbr(f"dec{lvl}a", h))
    out = conv("head_conv", h)
    w = margin + 1
    if w > 1:
        lo = (w - 1) // 2
        out = F.max_pool1d(F.pad(out, (lo, w - 1 - lo), value=float("-inf")),
                           w, stride=1)
    if logits:
        return out[:, 1] - out[:, 0]
    return torch.softmax(out, dim=1)[:, -1]


@torch.no_grad()
def predict(W, traces, *, margin=4, threshold=0.5, rows=32, quant=None):
    """(R, T) float traces -> (masks bool (R, T), logit differences
    float32 (R, T)): reflect-pad to a multiple of 16 at the end, the eval
    forward in blocks of ``rows``, crop, ``sigmoid(z) > threshold``."""
    r, t = traces.shape
    pad = (-t) % 16
    idx = torch.arange(t + pad, device=traces.device)
    idx = torch.where(idx < t, idx, 2 * (t - 1) - idx)
    x = traces[:, idx]
    z = torch.cat([forward(W, x[i:i + rows], margin=margin, quant=quant,
                           logits=True) for i in range(0, r, rows)])[:, :t]
    return torch.sigmoid(z) > threshold, z


def wbce(y, p, pos=2.0):
    """Class-weighted binary cross-entropy with ``log(p + 1e-7)``,
    averaged over every element."""
    return -(pos * y * torch.log(p + 1e-7)
             + (1.0 - y) * torch.log(1.0 - p + 1e-7)).mean()
