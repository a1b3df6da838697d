"""The plain reference of Cellpose-SAM's net and of its tiled evaluation of
a mean image, in float32 (with TF32 off around it): plain PyTorch, one
tile at a time, the attention bias and the scores materialised, written
from ``cellpose/vit_sam.py::Transformer`` and SAM's
``image_encoder.py`` (``Attention``, ``add_decomposed_rel_pos``,
``get_rel_pos``, ``LayerNorm2d``), with the readout as Cellpose-SAM writes
it (``conv_transpose2d`` with ``W2 = eye(192)``). It holds the yardstick's
operation and byte counts of the net.

Weights are a dict by the published state dict's key names.
``quant`` rounds the input and weight of every linear and conv (the fp8
control); ``bias=False`` leaves the relative-position bias out."""

import math

import numpy as np
import torch
import torch.nn.functional as F


def leaves(cfg):
    """(key, shape) of every weight the forward reads, published names."""
    w, m, n, p = cfg["width"], cfg["mlp_dim"], cfg["neck_dim"], cfg["patch"]
    g, hd = cfg["tile"] // p, cfg["width"] // cfg["heads"]
    out = [("encoder.patch_embed.proj.weight", (w, 3, p, p)),
           ("encoder.patch_embed.proj.bias", (w,)),
           ("encoder.pos_embed", (1, g, g, w))]
    for i in range(cfg["depth"]):
        b = f"encoder.blocks.{i}."
        r = (cfg["rel_pos_global"] if i in cfg["global_blocks"]
             else cfg["rel_pos_window"])
        out += [(b + "norm1.weight", (w,)), (b + "norm1.bias", (w,)),
                (b + "attn.qkv.weight", (3 * w, w)),
                (b + "attn.qkv.bias", (3 * w,)),
                (b + "attn.proj.weight", (w, w)), (b + "attn.proj.bias", (w,)),
                (b + "attn.rel_pos_h", (r, hd)),
                (b + "attn.rel_pos_w", (r, hd)),
                (b + "norm2.weight", (w,)), (b + "norm2.bias", (w,)),
                (b + "mlp.lin1.weight", (m, w)), (b + "mlp.lin1.bias", (m,)),
                (b + "mlp.lin2.weight", (w, m)), (b + "mlp.lin2.bias", (w,))]
    c = cfg["out_channels"] * p * p
    out += [("encoder.neck.0.weight", (n, w, 1, 1)),
            ("encoder.neck.1.weight", (n,)), ("encoder.neck.1.bias", (n,)),
            ("encoder.neck.2.weight", (n, n, 3, 3)),
            ("encoder.neck.3.weight", (n,)), ("encoder.neck.3.bias", (n,)),
            ("out.weight", (c, n, 1, 1)), ("out.bias", (c,))]
    return out


def param_count(cfg):
    return sum(math.prod(s) for _, s in leaves(cfg))


def forward_flops(cfg):
    """2 x the multiply-adds of one tile's forward: the patch embedding,
    per block the qkv, the scores, the bias contractions q.Rh and q.Rw
    (a grid row or column of entries a query and channel), the weighted
    sum, the projection and the MLP, then the neck and the readout."""
    g = cfg["tile"] // cfg["patch"]
    n, w, nk = g * g, cfg["width"], cfg["neck_dim"]
    block = (2 * n * w * 3 * w + 2 * n * n * w + 2 * 2 * n * g * w
             + 2 * n * n * w + 2 * n * w * w + 2 * 2 * n * w * cfg["mlp_dim"])
    return (2 * n * w * 3 * cfg["patch"] ** 2 + cfg["depth"] * block
            + 2 * n * w * nk + 2 * n * nk * nk * 9
            + 2 * n * nk * cfg["out_channels"] * cfg["patch"] ** 2)


def forward_bytes(cfg, tiles):
    """Bytes the net has to move for ``tiles`` tiles: the weights read once
    in bfloat16, each float32 input tile read and each float32 output
    tile written once."""
    t = cfg["tile"]
    return 2 * param_count(cfg) + tiles * 2 * 3 * t * t * 4


def _lin(x, w, b, quant):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.linear(x, w, b)


def _conv(x, w, b, quant, **kw):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, **kw)


def _ln(x, w, b, eps):
    """LayerNorm over the last axis, written out."""
    u = x.mean(-1, keepdim=True)
    s = ((x - u) ** 2).mean(-1, keepdim=True)
    return (x - u) / torch.sqrt(s + eps) * w + b


def rel_table(rel_pos, size):
    """SAM's ``get_rel_pos`` for a query and key axis of ``size``: the
    stored table linearly re-sampled to 2 size - 1 entries
    (``align_corners=False``) when its length differs, indexed by
    ``i - k + size - 1``: (size, size, d)."""
    n = 2 * size - 1
    if rel_pos.shape[0] != n:
        rel_pos = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1)
                                .permute(0, 2, 1), size=n, mode="linear")
        rel_pos = rel_pos.reshape(-1, n).permute(1, 0)
    q = torch.arange(size)[:, None]
    k = torch.arange(size)[None, :]
    return rel_pos[(q - k + size - 1).to(rel_pos.device)]


def _attention(W, p, x, cfg, quant, bias):
    """SAM's ``Attention.forward`` on one (1, g, g, w) input, the scores
    and the bias materialised in float32."""
    _, g, _, w = x.shape
    nh = cfg["heads"]
    qkv = _lin(x, W[p + "qkv.weight"], W[p + "qkv.bias"], quant)
    qkv = qkv.reshape(1, g * g, 3, nh, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, nh, g * g, -1).unbind(0)
    attn = (q * (w // nh) ** -0.5) @ k.transpose(-2, -1)
    if bias:
        rh = rel_table(W[p + "rel_pos_h"], g)
        rw = rel_table(W[p + "rel_pos_w"], g)
        r_q = q.reshape(nh, g, g, -1)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = (attn.view(nh, g, g, g, g) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(nh, g * g, g * g)
    attn = attn.softmax(dim=-1)
    x = (attn @ v).view(1, nh, g, g, -1).permute(0, 2, 3, 1, 4).reshape(
        1, g, g, -1)
    return _lin(x, W[p + "proj.weight"], W[p + "proj.bias"], quant)


def features(W, x, cfg, quant=None, bias=True):
    """The neck's (1, neck_dim, g, g) output of one (1, 3, tile, tile)
    tile."""
    eps = cfg["ln_eps"]
    x = _conv(x, W["encoder.patch_embed.proj.weight"],
              W["encoder.patch_embed.proj.bias"], quant, stride=cfg["patch"])
    x = x.permute(0, 2, 3, 1) + W["encoder.pos_embed"]
    for i in range(cfg["depth"]):
        p = f"encoder.blocks.{i}."
        x = x + _attention(W, p + "attn.", _ln(x, W[p + "norm1.weight"],
                                               W[p + "norm1.bias"], eps),
                           cfg, quant, bias)
        h = _ln(x, W[p + "norm2.weight"], W[p + "norm2.bias"], eps)
        h = F.gelu(_lin(h, W[p + "mlp.lin1.weight"], W[p + "mlp.lin1.bias"],
                        quant))
        x = x + _lin(h, W[p + "mlp.lin2.weight"], W[p + "mlp.lin2.bias"],
                     quant)
    x = x.permute(0, 3, 1, 2)
    x = _conv(x, W["encoder.neck.0.weight"], None, quant)
    x = _ln(x.permute(0, 2, 3, 1), W["encoder.neck.1.weight"],
            W["encoder.neck.1.bias"], eps).permute(0, 3, 1, 2)
    x = _conv(x, W["encoder.neck.2.weight"], None, quant, padding=1)
    return _ln(x.permute(0, 2, 3, 1), W["encoder.neck.3.weight"],
               W["encoder.neck.3.bias"], eps).permute(0, 3, 1, 2)


def readout(W, feats, cfg, quant=None):
    """Cellpose-SAM's readout of neck features: the 1 x 1 conv, then
    ``conv_transpose2d`` with ``W2 = eye(3 p^2)``: (1, 3, tile, tile)."""
    p, c = cfg["patch"], cfg["out_channels"]
    w2 = torch.eye(c * p * p, device=feats.device).reshape(c * p * p, c, p, p)
    x = _conv(feats, W["out.weight"], W["out.bias"], quant)
    return F.conv_transpose2d(x, w2, stride=p)


def forward(W, x, cfg, quant=None, bias=True):
    """(1, 3, tile, tile) dY, dX, cellprob of one tile."""
    return readout(W, features(W, x, cfg, quant, bias), cfg, quant)


def tile_starts(side, tile, overlap):
    """Cellpose's ``make_tiles`` along one axis."""
    n = 1 if side <= tile else int(np.ceil((1.0 + 2 * overlap) * side / tile))
    return np.linspace(0, side - tile, n).astype(int).tolist()


def taper(tile, sig=7.5):
    """Cellpose's ``_taper_mask`` for a square tile."""
    b = max(224, tile)
    xm = np.arange(b)
    xm = np.abs(xm - xm.mean())
    m = 1 / (1 + np.exp((xm - (b / 2 - 20)) / sig))
    m = m * m[:, np.newaxis]
    lo = b // 2 - tile // 2
    return m[lo:lo + tile, lo:lo + tile].astype(np.float32)


def normalize99(mean):
    """Cellpose's ``normalize99`` of an (H, W) image, in float64, back in
    float32."""
    x = mean.double()
    lo = torch.quantile(x.reshape(-1), 0.01)
    hi = torch.quantile(x.reshape(-1), 0.99)
    return ((x - lo) / (hi - lo)).float()


def tiles(img, cfg, overlap):
    """(corners, (n, 3, tile, tile) tiles) of a normalised (H, W) image in
    channel 0."""
    t = cfg["tile"]
    ys = tile_starts(img.shape[0], t, overlap)
    xs = tile_starts(img.shape[1], t, overlap)
    corners = [(y, x) for y in ys for x in xs]
    out = torch.zeros((len(corners), 3, t, t), device=img.device)
    for i, (y, x) in enumerate(corners):
        out[i, 0] = img[y:y + t, x:x + t]
    return corners, out


def blend(outs, corners, shape, cfg):
    """Cellpose's ``average_tiles``: each tile weighted by the taper, the
    sum over the summed weights; (3, H, W) float32."""
    t = cfg["tile"]
    mask = torch.from_numpy(taper(t)).to(outs.device)
    acc = torch.zeros((outs.shape[1],) + tuple(shape), device=outs.device)
    navg = torch.zeros(tuple(shape), device=outs.device)
    for o, (y, x) in zip(outs, corners):
        acc[:, y:y + t, x:x + t] += o * mask
        navg[y:y + t, x:x + t] += mask
    return acc / navg


def evaluate_flows(W, mean, cfg, overlap=0.1, quant=None, bias=True):
    """The blended (3, H, W) flows of a mean image, tile by tile."""
    corners, x = tiles(normalize99(mean), cfg, overlap)
    outs = torch.cat([forward(W, x[i:i + 1], cfg, quant, bias)
                      for i in range(len(corners))])
    return blend(outs, corners, mean.shape, cfg)
