"""UNet2DS, the published 2-D summary-image U-Net of deep-calcium
(``deepcalcium/models/neurons/unet_2d_summary.py``), in plain PyTorch.

Four levels of two 3x3 conv -> BN -> ReLU blocks with 2x2 max-pools, a
middle pair at 16 nfb, and on the way up a 2x2 stride-2 transpose conv ->
BN -> ReLU, concatenated as [up, skip] before two more blocks; dropout at
(0, d, 2d, 2d) after the encoder levels and (2d, 2d, 2d, d) after the up
convs of levels 3..0; a 1x1 conv to 2 channels and a softmax whose last
channel is the foreground probability. BN is Keras' (eps 1e-3, biased batch
variance in training).

Weights are a dict ``{"<layer>.weight": tensor, "<layer>.bias": tensor}``
in PyTorch layouts (OIHW convs, (Cin, Cout, 2, 2) transpose convs; a BN
layer's weight and bias are gamma and beta) and ``{"<layer>.mean",
"<layer>.var"}`` for the BN statistics. :func:`from_jax_layout` builds it
from the (params, state) trees of the checkpoint format (HWIO kernels)."""

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3

# The 8 dihedral views of test-time augmentation, each with its inverse, in
# the order the wrappers stack them.
def _rot(x, k):
    return torch.rot90(x, k, dims=(-2, -1))


VIEWS = [
    (lambda x: x, lambda x: x),
    (lambda x: x.flip(-2), lambda x: x.flip(-2)),
    (lambda x: x.flip(-1), lambda x: x.flip(-1)),
    (lambda x: _rot(x, 1), lambda x: _rot(x, -1)),
    (lambda x: _rot(x, 2), lambda x: _rot(x, -2)),
    (lambda x: _rot(x, 3), lambda x: _rot(x, -3)),
    (lambda x: _rot(x, 1).flip(-2), lambda x: _rot(x.flip(-2), -1)),
    (lambda x: _rot(x, 1).flip(-1), lambda x: _rot(x.flip(-1), -1)),
]

# Dropout sites: (name, rate in units of drp).
DROP_SITES = (("enc1", 1), ("enc2", 2), ("enc3", 2),
              ("up3", 2), ("up2", 2), ("up1", 2), ("up0", 1))


def layers(nfb=32):
    """(name, kind, cin, cout) of every weight-bearing layer in build
    order; kind is conv3 | conv1 | tconv | bn."""
    f, out = nfb, []
    cin = 1

    def cbr(name, ci, co):
        out.append((f"{name}_conv", "conv3", ci, co))
        out.append((f"{name}_bn", "bn", co, co))

    for lvl, mul in enumerate((1, 2, 4, 8)):
        cbr(f"enc{lvl}a", cin, f * mul)
        cbr(f"enc{lvl}b", f * mul, f * mul)
        cin = f * mul
    cbr("mida", 8 * f, 16 * f)
    cbr("midb", 16 * f, 16 * f)
    cin = 16 * f
    for lvl, mul in ((3, 8), (2, 4), (1, 2), (0, 1)):
        out.append((f"up{lvl}_tconv", "tconv", cin, f * mul))
        out.append((f"up{lvl}_bn", "bn", f * mul, f * mul))
        cbr(f"dec{lvl}a", 2 * f * mul, f * mul)
        cbr(f"dec{lvl}b", f * mul, f * mul)
        cin = f * mul
    out.append(("head_conv", "conv1", f, 2))
    return out


def param_count(nfb=32):
    n = 0
    for _, kind, ci, co in layers(nfb):
        k = {"conv3": 9, "conv1": 1, "tconv": 4, "bn": 0}[kind]
        n += ci * co * k + co if kind != "bn" else 2 * co
    return n


def forward_flops(h, w, nfb=32):
    """2 x multiply-adds of the convs and transpose convs of one forward on
    one (h, w) image."""
    fl = 0
    for name, kind, ci, co in layers(nfb):
        if kind == "bn":
            continue
        if name.startswith(("enc", "mid", "dec")):
            lvl = 4 if name.startswith("mid") else int(name[3])
        elif name.startswith("up"):
            lvl = int(name[2]) + 1  # reads the level below
        else:
            lvl = 0
        pix = (h >> lvl) * (w >> lvl)
        k = {"conv3": 9, "conv1": 1, "tconv": 4}[kind]
        fl += 2 * k * ci * co * pix
    return fl


def from_jax_layout(params, state, device, dtype=torch.float32):
    """The weight dict from the checkpoint format's trees: HWIO kernels and
    (p, q, Cout, Cin) transpose-conv kernels."""
    W = {}
    for name, leaves in params.items():
        for leaf, a in leaves.items():
            t = torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
            if leaf == "kernel":
                W[f"{name}.weight"] = t.permute(3, 2, 0, 1).contiguous()
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


def forward(W, x, *, train=False, drp=0.25, drop=None, quant=None,
            stats=None):
    """(B, H, W) float -> (B, H, W) foreground probabilities.

    ``train``: BN by batch statistics (recorded into ``stats`` when given,
    as ``{"<bn layer>": (mean, var)}``). ``drop(site, h, rate)`` applies a
    site's dropout in training, None for none. ``quant`` rounds every conv's
    input and weight (the control's precision)."""
    q = quant or (lambda t: t)

    def conv(name, h):
        w, b = W[f"{name}.weight"], W[f"{name}.bias"]
        return F.conv2d(q(h), q(w), padding=w.shape[-1] // 2) + b[:, None, None]

    def tconv(name, h):
        w, b = W[f"{name}.weight"], W[f"{name}.bias"]
        return F.conv_transpose2d(q(h), q(w), stride=2) + b[:, None, None]

    def bn(name, y):
        if train:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
            if stats is not None:
                stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = W[f"{name}.mean"], W[f"{name}.var"]
        scale = torch.rsqrt(var + BN_EPS) * W[f"{name}.weight"]
        return ((y - mean[:, None, None]) * scale[:, None, None]
                + W[f"{name}.bias"][:, None, None])

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
        h = F.max_pool2d(h, 2)
    h = cbr("midb", cbr("mida", h))
    for lvl in (3, 2, 1, 0):
        h = torch.relu(bn(f"up{lvl}_bn", tconv(f"up{lvl}_tconv", h)))
        h = dropout(f"up{lvl}", h, rates[f"up{lvl}"] * drp)
        h = torch.cat([h, skips[lvl]], dim=1)
        h = cbr(f"dec{lvl}b", cbr(f"dec{lvl}a", h))
    logits = conv("head_conv", h)
    return torch.softmax(logits, dim=1)[:, -1]


def movie_mean(movie, chunk=64):
    """The float32 mean over time of an integer (T, H, W) movie: the exact
    integer sum, divided in float64, rounded once."""
    total = torch.zeros(movie.shape[1:], dtype=torch.int64,
                        device=movie.device)
    for i in range(0, movie.shape[0], chunk):
        total += movie[i:i + chunk].to(torch.int64).sum(dim=0)
    return (total.double() / movie.shape[0]).float()


def reflect_index(n, size, device):
    """Indices extending a length-n axis to ``size`` as numpy's
    ``np.pad(mode="reflect")`` does (period 2(n - 1))."""
    i = torch.arange(size, device=device)
    if n == 1:
        return torch.zeros_like(i)
    j = i % (2 * (n - 1))
    return torch.where(j < n, j, 2 * (n - 1) - j)


@torch.no_grad()
def evaluate_mean(W, mean, window, threshold=0.5, tta=True, quant=None,
                  drp=0.25, views=8):
    """A mean image -> (mask bool (H, W), prob float32 (H, W)): z-norm
    (population std) -> reflect-pad at the bottom and right to the window
    -> the 8 views in one batch -> the inverse views' mean -> crop ->
    ``prob > threshold``. ``views`` < 8 averages the first ``views`` only
    (a fault's reading)."""
    h, w = mean.shape
    m = mean.double()
    z = ((m - m.mean()) / m.std(correction=0).clamp_min(1e-12)).float()
    rows = reflect_index(h, window[0], z.device)
    cols = reflect_index(w, window[1], z.device)
    z = z[rows[:, None], cols[None, :]]
    if tta:
        batch = torch.stack([fwd(z) for fwd, _ in VIEWS[:views]])
        probs = forward(W, batch, quant=quant, drp=drp)
        prob = torch.stack([inv(p) for (_, inv), p in zip(VIEWS, probs)]
                           ).mean(dim=0)
    else:
        prob = forward(W, z[None], quant=quant, drp=drp)[0]
    prob = prob[:h, :w]
    return prob > threshold, prob


def bce(y, p):
    """Keras binary cross-entropy of probabilities clipped to
    [1e-7, 1 - 1e-7], averaged over every element."""
    pc = p.clamp(1e-7, 1.0 - 1e-7)
    return -(y * torch.log(pc) + (1.0 - y) * torch.log(1.0 - pc)).mean()
