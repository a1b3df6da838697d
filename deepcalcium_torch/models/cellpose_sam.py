"""Cellpose-SAM: SAM's ViT-L image encoder with Cellpose-SAM's changes (a
patch of 8 on 256 x 256 tiles, global attention in every block) and its
readout of flows and cell probability.

Published model: Pachitariu, Rariden & Stringer, "Cellpose-SAM" (2025);
``cellpose/vit_sam.py::Transformer`` of MouseLand/cellpose, whose encoder is
``segment_anything.modeling.image_encoder.ImageEncoderViT`` (ViT-L). On one
(B, 3, 256, 256) tile:

- patch embedding ``Conv2d(3, 1024, 8, stride 8)`` to a 32 x 32 grid, plus
  the learned (1, 32, 32, 1024) positional table;
- 24 pre-LN blocks, LayerNorm eps 1e-6: ``x + proj(attn(LN1(x)))``, then
  ``x + lin2(GELU(lin1(LN2(x))))`` (1024 -> 4096 -> 1024, exact GELU);
  attention is global over the 1,024 tokens, 16 heads of 64, with SAM's
  decomposed relative-position bias (:mod:`deepcalcium_torch.ops.attention`);
  the stored tables are 127 long in blocks 5, 11, 17 and 23 and 27 in the
  others (SAM's shapes) and are re-sampled to 63 once, at the build;
- the neck ``Conv2d(1024, 256, 1)``, LayerNorm over channels,
  ``Conv2d(256, 256, 3, padding 1)``, LayerNorm over channels (no biases);
- the readout ``Conv2d(256, 192, 1)`` and ``pixel_shuffle(8)``, which is
  Cellpose-SAM's ``conv_transpose2d`` with ``W2 = eye(192)`` exactly, to
  (B, 3, 256, 256): dY, dX and cellprob.

The weights load by the published state dict's own key names and are held
in float32; the build (:func:`inference_net`) packs them into one upload
to the card, re-samples the tables and makes compute-dtype copies of the
rest there, once. The forward runs in that dtype (bfloat16 as Cellpose 4
runs by default); LayerNorm and softmax keep float32 statistics.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from deepcalcium_torch.models.blocks import upload_packed
from deepcalcium_torch.ops.attention import (attention, rel_pos_index,
                                             resample_rel_pos)
from deepcalcium_torch.utils.profiling import span

__all__ = ["Config", "CellposeSAM", "leaf_shapes", "check_state_dict",
           "inference_net", "param_count", "forward_flops"]

# Keys of the published state dict that the forward does not read: the
# fixed readout kernel (checked to be the identity) and two diameters.
EXTRA_KEYS = ("W2", "diam_labels", "diam_mean")


@dataclasses.dataclass(frozen=True)
class Config:
    """Widths of the net; the defaults are Cellpose-SAM's published ones."""
    width: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_dim: int = 4096
    patch: int = 8
    tile: int = 256
    neck_dim: int = 256
    out_channels: int = 3
    global_blocks: tuple = (5, 11, 17, 23)
    rel_pos_window: int = 27
    rel_pos_global: int = 127
    ln_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.tile // self.patch

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    def rel_pos_len(self, block: int) -> int:
        """Length of a block's stored tables (SAM's 64-token global blocks
        or its 14-token windows)."""
        return (self.rel_pos_global if block in self.global_blocks
                else self.rel_pos_window)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """The fields of ``d`` that name one (a configuration file holds
        more)."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in d.items() if k in names}
        return cls(**kw)


def leaf_shapes(cfg: Config = Config()) -> list:
    """(key, shape) of every weight the forward reads, by the published
    state dict's names, in its order."""
    w, m, n, p = cfg.width, cfg.mlp_dim, cfg.neck_dim, cfg.patch
    out = [("encoder.patch_embed.proj.weight", (w, 3, p, p)),
           ("encoder.patch_embed.proj.bias", (w,)),
           ("encoder.pos_embed", (1, cfg.grid, cfg.grid, w))]
    for i in range(cfg.depth):
        b = f"encoder.blocks.{i}."
        r = cfg.rel_pos_len(i)
        out += [(b + "norm1.weight", (w,)), (b + "norm1.bias", (w,)),
                (b + "attn.qkv.weight", (3 * w, w)),
                (b + "attn.qkv.bias", (3 * w,)),
                (b + "attn.proj.weight", (w, w)), (b + "attn.proj.bias", (w,)),
                (b + "attn.rel_pos_h", (r, cfg.head_dim)),
                (b + "attn.rel_pos_w", (r, cfg.head_dim)),
                (b + "norm2.weight", (w,)), (b + "norm2.bias", (w,)),
                (b + "mlp.lin1.weight", (m, w)), (b + "mlp.lin1.bias", (m,)),
                (b + "mlp.lin2.weight", (w, m)), (b + "mlp.lin2.bias", (w,))]
    c = cfg.out_channels * p * p
    out += [("encoder.neck.0.weight", (n, w, 1, 1)),
            ("encoder.neck.1.weight", (n,)), ("encoder.neck.1.bias", (n,)),
            ("encoder.neck.2.weight", (n, n, 3, 3)),
            ("encoder.neck.3.weight", (n,)), ("encoder.neck.3.bias", (n,)),
            ("out.weight", (c, n, 1, 1)), ("out.bias", (c,))]
    return out


def param_count(cfg: Config = Config()) -> int:
    """Weights the forward reads (``W2`` and the diameters left out)."""
    return sum(int(np.prod(s)) for _, s in leaf_shapes(cfg))


def forward_flops(cfg: Config = Config()) -> int:
    """FLOPs (2 x multiply-adds) of one forward on one tile: every linear,
    conv and attention product, the two bias contractions included."""
    n, w, g = cfg.grid ** 2, cfg.width, cfg.grid
    block = (2 * n * w * 3 * w + 2 * n * w * w + 2 * 2 * n * w * cfg.mlp_dim
             + 2 * 2 * n * n * w + 2 * 2 * n * g * w)
    nk = cfg.neck_dim
    return (2 * n * w * 3 * cfg.patch ** 2 + cfg.depth * block
            + 2 * n * w * nk + 2 * n * nk * nk * 9
            + 2 * n * nk * cfg.out_channels * cfg.patch ** 2)


def check_state_dict(state_dict, cfg: Config = Config()) -> None:
    """Raise ``KeyError`` on a missing or unknown key and ``ValueError`` on
    a shape that is not the configuration's or a ``W2`` that is not the
    pixel shuffle's identity."""
    want = dict(leaf_shapes(cfg))
    have = set(state_dict)
    missing = sorted(set(want) - have)
    unknown = sorted(have - set(want) - set(EXTRA_KEYS))
    if missing or unknown:
        raise KeyError(f"Cellpose-SAM state dict: missing {missing[:4]}, "
                       f"unknown {unknown[:4]}")
    for k, shape in want.items():
        if tuple(np.shape(state_dict[k])) != shape:
            raise ValueError(f"{k}: shape {tuple(np.shape(state_dict[k]))}, "
                             f"expected {shape}")
    if "W2" in state_dict:
        c = cfg.out_channels * cfg.patch ** 2
        eye = np.eye(c, dtype=np.float32).reshape(c, cfg.out_channels,
                                                  cfg.patch, cfg.patch)
        if not np.array_equal(np.asarray(state_dict["W2"], np.float32), eye):
            raise ValueError("W2 is not the identity of the pixel shuffle")


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


class CellposeSAM:
    """The eval-time net on one device: ``weights`` (published key to
    float32 tensor) and what the forward reads of them in the compute
    dtype. Made by :func:`inference_net`; ``net(x)`` maps (B, 3, tile,
    tile) images to (B, 3, tile, tile) float32 dY, dX, cellprob."""

    def __init__(self, cfg, weights, compute, compute_dtype):
        self.config, self.weights = cfg, weights
        self.compute, self.compute_dtype = compute, compute_dtype

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        cfg, t = self.config, self.compute
        g, w, eps = cfg.grid, cfg.width, cfg.ln_eps
        b = x.shape[0]
        x = F.conv2d(x.to(self.compute_dtype), t["patch.w"], t["patch.b"],
                     stride=cfg.patch)
        x = (x.permute(0, 2, 3, 1) + t["pos"]).reshape(b, g * g, w)
        for blk in t["blocks"]:
            h = F.layer_norm(x, (w,), blk["n1.w"], blk["n1.b"], eps)
            qkv = F.linear(h, blk["qkv.w"], blk["qkv.b"]).view(
                b, g * g, 3, cfg.heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
            a = attention(qkv[0], qkv[1], qkv[2], blk["rh"], blk["rw"], (g, g))
            x = x + F.linear(a.transpose(1, 2).reshape(b, g * g, w),
                             blk["proj.w"], blk["proj.b"])
            h = F.layer_norm(x, (w,), blk["n2.w"], blk["n2.b"], eps)
            x = x + F.linear(F.gelu(F.linear(h, blk["lin1.w"], blk["lin1.b"])),
                             blk["lin2.w"], blk["lin2.b"])
        x = x.view(b, g, g, w).permute(0, 3, 1, 2)
        x = _ln2d(F.conv2d(x, t["neck0"]), t["neck1.w"], t["neck1.b"], eps)
        x = _ln2d(F.conv2d(x, t["neck2"], padding=1), t["neck3.w"],
                  t["neck3.b"], eps)
        x = F.conv2d(x, t["out.w"], t["out.b"])
        return F.pixel_shuffle(x, cfg.patch).float()


def _ln2d(x, weight, bias, eps):
    """LayerNorm over the channels of an NCHW tensor (SAM's LayerNorm2d)."""
    return F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), weight, bias,
                        eps).permute(0, 3, 1, 2)


def inference_net(state_dict, cfg: Config = Config(),
                  compute_dtype=torch.bfloat16, device=None) -> CellposeSAM:
    """The net of a published-layout state dict (tensors or arrays) on
    ``device``: every weight packed into one buffer and copied at once
    (:func:`blocks.upload_packed`: ``net.pack``, ``net.upload``), the
    tables re-sampled and indexed and the compute-dtype copies made there
    (``net.load``), the net assembled round them (``net.init``)."""
    check_state_dict(state_dict, cfg)
    shapes = leaf_shapes(cfg)
    flat = upload_packed([(k, _host(state_dict[k]), s) for k, s in shapes],
                         "cpu" if device is None else device)
    weights = dict(zip((k for k, _ in shapes), flat))
    dt = compute_dtype or torch.float32
    with span("net.load"):
        cast = {k: v.to(dt) for k, v in weights.items()
                if "rel_pos" not in k}
        blocks = []
        for i in range(cfg.depth):
            p = f"encoder.blocks.{i}."
            rh, rw = (rel_pos_index(resample_rel_pos(
                weights[p + f"attn.rel_pos_{a}"], cfg.grid), cfg.grid).to(dt)
                for a in "hw")
            blocks.append({
                "n1.w": cast[p + "norm1.weight"],
                "n1.b": cast[p + "norm1.bias"],
                "qkv.w": cast[p + "attn.qkv.weight"],
                "qkv.b": cast[p + "attn.qkv.bias"],
                "proj.w": cast[p + "attn.proj.weight"],
                "proj.b": cast[p + "attn.proj.bias"], "rh": rh, "rw": rw,
                "n2.w": cast[p + "norm2.weight"],
                "n2.b": cast[p + "norm2.bias"],
                "lin1.w": cast[p + "mlp.lin1.weight"],
                "lin1.b": cast[p + "mlp.lin1.bias"],
                "lin2.w": cast[p + "mlp.lin2.weight"],
                "lin2.b": cast[p + "mlp.lin2.bias"]})
        e = "encoder."
        compute = {
            "patch.w": cast[e + "patch_embed.proj.weight"],
            "patch.b": cast[e + "patch_embed.proj.bias"],
            "pos": cast[e + "pos_embed"][0], "blocks": blocks,
            "neck0": cast[e + "neck.0.weight"],
            "neck1.w": cast[e + "neck.1.weight"],
            "neck1.b": cast[e + "neck.1.bias"],
            "neck2": cast[e + "neck.2.weight"],
            "neck3.w": cast[e + "neck.3.weight"],
            "neck3.b": cast[e + "neck.3.bias"],
            "out.w": cast["out.weight"], "out.b": cast["out.bias"]}
    with span("net.init"):
        return CellposeSAM(cfg, weights, compute, dt)
