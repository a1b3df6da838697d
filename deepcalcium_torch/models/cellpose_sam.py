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

The encoder is the block loop shared with Segment Anything
(:mod:`deepcalcium_torch.models.sam_vit`), every block global. The weights
load by the published state dict's own key names and are held in float32;
the build (:func:`inference_net`) packs them into one upload to the card,
re-samples the tables and makes compute-dtype copies of the rest there,
once. The forward runs in that dtype (bfloat16 as Cellpose 4
runs by default); LayerNorm and softmax keep float32 statistics.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from deepcalcium_torch.models import sam_vit
from deepcalcium_torch.models.netweights import upload_packed
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

    @property
    def window_size(self) -> int:
        """0: every block attends over the whole grid (SAM's ViT-L attends
        in 14-token windows in all blocks but four)."""
        return 0

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
    c = cfg.out_channels * cfg.patch ** 2
    return sam_vit.leaf_shapes(cfg, "encoder.") + [
        ("out.weight", (c, cfg.neck_dim, 1, 1)), ("out.bias", (c,))]


def param_count(cfg: Config = Config()) -> int:
    """Weights the forward reads (``W2`` and the diameters left out)."""
    return sum(int(np.prod(s)) for _, s in leaf_shapes(cfg))


def forward_flops(cfg: Config = Config()) -> int:
    """FLOPs (2 x multiply-adds) of one forward on one tile: every linear,
    conv and attention product, the two bias contractions included."""
    return (sam_vit.forward_flops(cfg) + 2 * cfg.grid ** 2 * cfg.neck_dim
            * cfg.out_channels * cfg.patch ** 2)


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
        t = self.compute
        x = sam_vit.encode(t, x.to(self.compute_dtype), self.config)
        x = F.conv2d(x, t["out.w"], t["out.b"])
        return F.pixel_shuffle(x, self.config.patch).float()


def inference_net(state_dict, cfg: Config = Config(),
                  compute_dtype=torch.bfloat16, device=None) -> CellposeSAM:
    """The net of a published-layout state dict (tensors or arrays) on
    ``device``: every weight packed into one buffer and copied at once
    (:func:`netweights.upload_packed`: ``net.pack``, ``net.upload``), the
    tables re-sampled and the compute-dtype copies made there
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
        compute = sam_vit.build(weights, cast, cfg, "encoder.", dt)
        compute.update({"out.w": cast["out.weight"],
                        "out.b": cast["out.bias"]})
    with span("net.init"):
        return CellposeSAM(cfg, weights, compute, dt)
