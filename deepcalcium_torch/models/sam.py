"""Segment Anything, ViT-H: the image encoder, the prompt encoder of points
and the mask decoder, the net of the automatic mask generator
(:mod:`deepcalcium_torch.ops.amg`,
:mod:`deepcalcium_torch.models.sam_summary`).

Published model: Kirillov et al., "Segment Anything" (ICCV 2023);
facebookresearch/segment-anything, ``build_sam.py::build_sam_vit_h`` with
``modeling/image_encoder.py``, ``prompt_encoder.py``, ``mask_decoder.py`` and
``transformer.py``. On one (1, 3, 1024, 1024) normalised image:

- the encoder (:mod:`deepcalcium_torch.models.sam_vit`): a patch of 16 to a
  64 x 64 grid, 32 blocks of width 1,280 (16 heads of 80, MLP 5,120), blocks
  7, 15, 23 and 31 global, the others in 14 x 14 windows of the grid padded
  to 70 x 70, each with SAM's decomposed relative-position bias; the neck to
  (1, 256, 64, 64);
- the prompt encoder of a point (x, y) in the 1024 frame: ``c = (p + 0.5) /
  1024``, ``[sin, cos](2 pi (2 c - 1) @ G)`` with the (2, 128) random
  Fourier matrix G, plus ``point_embeddings[1]`` (a foreground point); a
  padding point (label -1, no box given) whose encoding is zeroed and
  ``not_a_point_embed`` added; the dense embedding ``no_mask_embed`` on
  every cell of the grid, and ``image_pe``, the same encoding of the cell
  centres ``(i + 0.5) / 64``;
- the mask decoder: tokens ``[iou_token, 4 mask_tokens, 2 sparse]``
  through a two-way transformer of 2 blocks (width 256, 8 heads, ReLU MLP
  2,048; token-to-image and image-to-token attention at half width, 8
  heads of 16; LayerNorm eps 1e-5 after each step; block 1 attends over its
  tokens without their positional encoding and without a residual) and a
  final token-to-image attention; the image side upscaled by
  ``ConvTranspose(256, 64, 2, 2)``, LayerNorm2d, GELU,
  ``ConvTranspose(64, 32, 2, 2)``, GELU; four hypernetwork MLPs (256-256-32,
  ReLU) whose outputs weigh the upscaled channels into 4 mask logits of
  256 x 256, and an IoU MLP (256-256-4). Multimask output keeps masks 1-3.

The weights load by the published state dict's key names
(``image_encoder.*``, ``prompt_encoder.*``, ``mask_decoder.*``;
``prompt_encoder.mask_downscaling.*``, for mask prompts, is accepted and
not read) and are held in float32; the build (:func:`inference_net`)
packs them into one upload to the card and makes compute-dtype copies
there, once. The forward runs in that dtype
(bfloat16 by default); LayerNorm and softmax keep float32 statistics, and
the point encodings are computed in float32.
"""

import dataclasses
import math
from typing import ClassVar

import numpy as np
import torch
import torch.nn.functional as F

from deepcalcium_torch.models import sam_vit
from deepcalcium_torch.models.netweights import upload_packed
from deepcalcium_torch.utils.profiling import span

__all__ = ["Config", "Sam", "leaf_shapes", "check_state_dict",
           "inference_net", "param_count", "forward_flops", "decoder_flops"]

# Published keys the forward does not read: the mask prompt's encoder.
EXTRA_PREFIXES = ("prompt_encoder.mask_downscaling.",)


@dataclasses.dataclass(frozen=True)
class Config:
    """Widths of the net and the prompt grid of the automatic mask
    generator; the defaults are SAM ViT-H's and ``SamAutomaticMaskGenerator``'s
    published ones. The generator's thresholds are constants."""
    width: int = 1280
    depth: int = 32
    heads: int = 16
    mlp_dim: int = 5120
    patch: int = 16
    image_size: int = 1024
    neck_dim: int = 256
    global_blocks: tuple = (7, 15, 23, 31)
    window_size: int = 14
    rel_pos_window: int = 27
    rel_pos_global: int = 127
    ln_eps: float = 1e-6
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample: int = 2
    multimask_outputs: int = 3
    iou_head_hidden: int = 256
    iou_head_depth: int = 3
    decoder_ln_eps: float = 1e-5
    pixel_mean: tuple = (123.675, 116.28, 103.53)
    pixel_std: tuple = (58.395, 57.12, 57.375)
    points_per_side: int = 32
    points_per_batch: int = 64
    # SamAutomaticMaskGenerator's defaults (one crop, no small-region
    # removal).
    pred_iou_thresh: ClassVar[float] = 0.88
    stability_score_thresh: ClassVar[float] = 0.95
    stability_score_offset: ClassVar[float] = 1.0
    box_nms_thresh: ClassVar[float] = 0.7
    mask_threshold: ClassVar[float] = 0.0

    @property
    def grid(self) -> int:
        return self.image_size // self.patch

    @property
    def mask_tokens(self) -> int:
        return self.multimask_outputs + 1

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """The fields of ``d`` and of its ``amg`` block that name one (a
        configuration file holds more); a threshold there that is not the
        constant raises."""
        names = {f.name for f in dataclasses.fields(cls)}
        amg = d.get("amg", {})
        for k, v in amg.items():
            if k not in names and hasattr(cls, k) and getattr(cls, k) != v:
                raise ValueError(f"{k} is {getattr(cls, k)}, not {v}")
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in {**d, **amg}.items() if k in names}
        return cls(**kw)


def _linear(key, n_out, n_in):
    return [(key + ".weight", (n_out, n_in)), (key + ".bias", (n_out,))]


def _norm(key, n):
    return [(key + ".weight", (n,)), (key + ".bias", (n,))]


def _attention(key, dim, inner):
    return (_linear(key + ".q_proj", inner, dim)
            + _linear(key + ".k_proj", inner, dim)
            + _linear(key + ".v_proj", inner, dim)
            + _linear(key + ".out_proj", dim, inner))


def _mlp(key, dims):
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += _linear(f"{key}.layers.{i}", b, a)
    return out


def leaf_shapes(cfg: Config = Config()) -> list:
    """(key, shape) of every weight the forward reads, by the published
    state dict's names."""
    c, t = cfg.neck_dim, "mask_decoder.transformer."
    inner = c // cfg.attention_downsample
    out = sam_vit.leaf_shapes(cfg, "image_encoder.")
    out += [("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
             (2, c // 2))]
    out += [(f"prompt_encoder.point_embeddings.{i}.weight", (1, c))
            for i in range(4)]
    out += [("prompt_encoder.not_a_point_embed.weight", (1, c)),
            ("prompt_encoder.no_mask_embed.weight", (1, c))]
    for i in range(cfg.decoder_depth):
        b = f"{t}layers.{i}."
        out += (_attention(b + "self_attn", c, c) + _norm(b + "norm1", c)
                + _attention(b + "cross_attn_token_to_image", c, inner)
                + _norm(b + "norm2", c)
                + _linear(b + "mlp.lin1", cfg.decoder_mlp_dim, c)
                + _linear(b + "mlp.lin2", c, cfg.decoder_mlp_dim)
                + _norm(b + "norm3", c) + _norm(b + "norm4", c)
                + _attention(b + "cross_attn_image_to_token", c, inner))
    out += (_attention(t + "final_attn_token_to_image", c, inner)
            + _norm(t + "norm_final_attn", c))
    d = "mask_decoder."
    out += [(d + "iou_token.weight", (1, c)),
            (d + "mask_tokens.weight", (cfg.mask_tokens, c)),
            (d + "output_upscaling.0.weight", (c, c // 4, 2, 2)),
            (d + "output_upscaling.0.bias", (c // 4,)),
            (d + "output_upscaling.1.weight", (c // 4,)),
            (d + "output_upscaling.1.bias", (c // 4,)),
            (d + "output_upscaling.3.weight", (c // 4, c // 8, 2, 2)),
            (d + "output_upscaling.3.bias", (c // 8,))]
    for i in range(cfg.mask_tokens):
        out += _mlp(f"{d}output_hypernetworks_mlps.{i}", (c, c, c, c // 8))
    hid = [cfg.iou_head_hidden] * (cfg.iou_head_depth - 1)
    out += _mlp(d + "iou_prediction_head", [c] + hid + [cfg.mask_tokens])
    return out


def param_count(cfg: Config = Config()) -> int:
    """Weights the forward reads (the mask prompt's encoder left out)."""
    return sum(math.prod(s) for _, s in leaf_shapes(cfg))


def decoder_flops(cfg: Config = Config()) -> int:
    """FLOPs (2 x multiply-adds) of the mask decoder for one point prompt:
    the two-way transformer's projections and attention products, the
    upscaling's transposed convs, the hypernetworks, the mask products and
    the IoU head."""
    c, n = cfg.neck_dim, cfg.grid ** 2
    t = 1 + cfg.mask_tokens + 2
    inner = c // cfg.attention_downsample
    t2i = 2 * t * c * inner + 2 * 2 * n * c * inner + 2 * 2 * t * n * inner \
        + 2 * t * inner * c
    i2t = 2 * n * c * inner + 2 * 2 * t * c * inner + 2 * 2 * n * t * inner \
        + 2 * n * inner * c
    block = (4 * 2 * t * c * c + 2 * 2 * t * t * c + t2i
             + 2 * 2 * t * c * cfg.decoder_mlp_dim + i2t)
    up = 2 * 4 * n * c * (c // 4) + 2 * 16 * n * (c // 4) * (c // 8)
    hyper = cfg.mask_tokens * 2 * (c * c + c * c + c * (c // 8))
    dims = [c] + [cfg.iou_head_hidden] * (cfg.iou_head_depth - 1) + [
        cfg.mask_tokens]
    iou = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    masks = 2 * cfg.mask_tokens * (c // 8) * 16 * n
    return cfg.decoder_depth * block + t2i + up + hyper + iou + masks


def forward_flops(cfg: Config = Config(), prompts: int = 1024) -> int:
    """FLOPs of one image's encoder and ``prompts`` point prompts' decoder
    (1,024: the mask generator's 32 x 32 grid)."""
    return sam_vit.forward_flops(cfg) + prompts * decoder_flops(cfg)


def check_state_dict(state_dict, cfg: Config = Config()) -> None:
    """Raise ``KeyError`` on a missing or unknown key and ``ValueError`` on
    a shape that is not the configuration's."""
    want = dict(leaf_shapes(cfg))
    have = set(state_dict)
    missing = sorted(set(want) - have)
    unknown = sorted(k for k in have - set(want)
                     if not k.startswith(EXTRA_PREFIXES))
    if missing or unknown:
        raise KeyError(f"SAM state dict: missing {missing[:4]}, unknown "
                       f"{unknown[:4]}")
    for k, shape in want.items():
        if tuple(np.shape(state_dict[k])) != shape:
            raise ValueError(f"{k}: shape {tuple(np.shape(state_dict[k]))}, "
                             f"expected {shape}")


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def _fourier(coords, gauss):
    """SAM's ``PositionEmbeddingRandom._pe_encoding`` of coordinates in
    [0, 1] (last axis x, y), float32."""
    c = (2 * coords - 1) @ gauss
    c = 2 * np.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def _ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p[0], p[1], eps)


class Sam:
    """The eval-time net on one device: ``weights`` (published key to
    float32 tensor) and what the forward reads of them in the compute
    dtype. Made by :func:`inference_net`. ``encode`` maps (B, 3, 1024,
    1024) normalised images to their (B, 256, 64, 64) embeddings,
    ``embed_points`` point coordinates to sparse prompt embeddings, and
    ``decode`` one embedding and a batch of prompts to low-resolution mask
    logits and predicted IoUs."""

    def __init__(self, cfg, weights, compute, compute_dtype):
        self.config, self.weights = cfg, weights
        self.compute, self.compute_dtype = compute, compute_dtype

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return sam_vit.encode(self.compute, x.to(self.compute_dtype),
                              self.config)

    @torch.no_grad()
    def embed_points(self, coords: torch.Tensor) -> torch.Tensor:
        """(P, 2, 256) sparse embeddings, in the compute dtype, of P
        foreground points (P, 2) given as (x, y) in the frame of the
        encoder's input, each with the padding point."""
        t, s = self.compute, self.config.image_size
        c = (coords.to(torch.float64) + 0.5) / s
        pe = _fourier(c.to(torch.float32), t["pe.gauss"]) + t["point.fg"]
        pad = t["point.pad"].expand_as(pe)
        return torch.stack([pe, pad], dim=1).to(self.compute_dtype)

    def _attend(self, p, q, k, v):
        """SAM's decoder ``Attention``: projections to the inner width, one
        attention a head, the output projection."""
        h = self.config.decoder_heads
        q = F.linear(q, p["q.w"], p["q.b"])
        k = F.linear(k, p["k.w"], p["k.b"])
        v = F.linear(v, p["v.w"], p["v.b"])
        b, nq, inner = q.shape
        q, k, v = (a.view(b, -1, h, inner // h).transpose(1, 2)
                   for a in (q, k, v))
        o = F.scaled_dot_product_attention(q, k, v)
        o = o.transpose(1, 2).reshape(b, nq, inner)
        return F.linear(o, p["out.w"], p["out.b"])

    @torch.no_grad()
    def decode(self, embedding: torch.Tensor, sparse: torch.Tensor):
        """(low-res mask logits (P, 3, 4 g, 4 g), IoU predictions (P, 3)),
        both in the compute dtype, of one image's (1, 256, g, g)
        ``embedding`` and the (P, 2, 256) ``sparse`` embeddings of P point
        prompts: SAM's ``MaskDecoder.predict_masks`` with the embedding
        copied for each prompt, and its multimask slice."""
        cfg, t = self.config, self.compute
        eps = cfg.decoder_ln_eps
        p_n, c = sparse.shape[0], cfg.neck_dim
        g = cfg.grid
        tokens = torch.cat([t["tokens"].expand(p_n, -1, -1), sparse], dim=1)
        src = (embedding + t["dense"]).flatten(2).transpose(1, 2)
        keys = src.repeat_interleave(p_n, dim=0)
        key_pe = t["image_pe"]
        queries = tokens
        for blk in t["layers"]:
            if blk["skip_pe"]:
                queries = self._attend(blk["self"], queries, queries, queries)
            else:
                q = queries + tokens
                queries = queries + self._attend(blk["self"], q, q, queries)
            queries = _ln(queries, blk["norm1"], eps)
            k = keys + key_pe
            queries = _ln(queries + self._attend(blk["t2i"], queries + tokens,
                                                 k, keys), blk["norm2"], eps)
            mlp = F.linear(F.relu(F.linear(queries, *blk["lin1"])),
                           *blk["lin2"])
            queries = _ln(queries + mlp, blk["norm3"], eps)
            keys = _ln(keys + self._attend(blk["i2t"], k, queries + tokens,
                                           queries), blk["norm4"], eps)
        queries = _ln(queries + self._attend(t["final"], queries + tokens,
                                             keys + key_pe, keys),
                      t["norm_final"], eps)
        src = keys.transpose(1, 2).reshape(p_n, c, g, g)
        up = F.conv_transpose2d(src, t["up0.w"], t["up0.b"], stride=2)
        up = F.gelu(sam_vit.ln2d(up, t["up1.w"], t["up1.b"], 1e-6))
        up = F.gelu(F.conv_transpose2d(up, t["up3.w"], t["up3.b"], stride=2))
        # The four hypernetworks at once: weights stacked (4, out, in).
        hyper = queries[:, 1:1 + cfg.mask_tokens].transpose(0, 1)
        for i, (w, b) in enumerate(t["hyper"]):
            hyper = torch.baddbmm(b, hyper, w.transpose(1, 2))
            if i < len(t["hyper"]) - 1:
                hyper = F.relu(hyper)
        hyper = hyper.transpose(0, 1)                   # (P, 4, c / 8)
        side = up.shape[-1]
        masks = torch.bmm(hyper, up.flatten(2)).view(p_n, -1, side, side)
        iou = queries[:, 0]
        for i, (w, b) in enumerate(t["iou"]):
            iou = F.linear(iou, w, b)
            if i < len(t["iou"]) - 1:
                iou = F.relu(iou)
        return masks[:, 1:], iou[:, 1:]


def _decoder_tensors(weights, cast, cfg):
    """What :meth:`Sam.decode` and :meth:`Sam.embed_points` read."""
    def attn(key):
        return {f"{n}.{a}": cast[f"{key}.{n}_proj.{w}"]
                for n in ("q", "k", "v", "out")
                for a, w in (("w", "weight"), ("b", "bias"))}

    def pair(key):
        return (cast[key + ".weight"], cast[key + ".bias"])

    t, d, p = "mask_decoder.transformer.", "mask_decoder.", "prompt_encoder."
    layers = []
    for i in range(cfg.decoder_depth):
        b = f"{t}layers.{i}."
        layers.append({
            "skip_pe": i == 0, "self": attn(b + "self_attn"),
            "norm1": pair(b + "norm1"),
            "t2i": attn(b + "cross_attn_token_to_image"),
            "norm2": pair(b + "norm2"), "lin1": pair(b + "mlp.lin1"),
            "lin2": pair(b + "mlp.lin2"), "norm3": pair(b + "norm3"),
            "norm4": pair(b + "norm4"),
            "i2t": attn(b + "cross_attn_image_to_token")})
    gauss = weights[p + "pe_layer.positional_encoding_gaussian_matrix"]
    g = cfg.grid
    centres = (torch.arange(g, dtype=torch.float32, device=gauss.device)
               + 0.5) / g
    cells = torch.stack([centres.expand(g, g), centres[:, None].expand(g, g)],
                        dim=-1)
    dt = cast[d + "iou_token.weight"].dtype
    hyper = [(torch.stack([cast[f"{d}output_hypernetworks_mlps.{m}.layers."
                                f"{i}.weight"]
                           for m in range(cfg.mask_tokens)]),
              torch.stack([cast[f"{d}output_hypernetworks_mlps.{m}.layers."
                                f"{i}.bias"]
                           for m in range(cfg.mask_tokens)])[:, None])
             for i in range(3)]
    return {
        "layers": layers, "final": attn(t + "final_attn_token_to_image"),
        "norm_final": pair(t + "norm_final_attn"),
        "tokens": torch.cat([cast[d + "iou_token.weight"],
                             cast[d + "mask_tokens.weight"]])[None],
        "pe.gauss": gauss,
        "point.fg": weights[p + "point_embeddings.1.weight"][0],
        "point.pad": weights[p + "not_a_point_embed.weight"][0],
        "dense": cast[p + "no_mask_embed.weight"].reshape(1, -1, 1, 1),
        "image_pe": _fourier(cells, gauss).reshape(1, g * g, -1).to(dt),
        "up0.w": cast[d + "output_upscaling.0.weight"],
        "up0.b": cast[d + "output_upscaling.0.bias"],
        "up1.w": cast[d + "output_upscaling.1.weight"],
        "up1.b": cast[d + "output_upscaling.1.bias"],
        "up3.w": cast[d + "output_upscaling.3.weight"],
        "up3.b": cast[d + "output_upscaling.3.bias"],
        "hyper": hyper,
        "iou": [pair(f"{d}iou_prediction_head.layers.{i}")
                for i in range(cfg.iou_head_depth)]}


def inference_net(state_dict, cfg: Config = Config(),
                  compute_dtype=torch.bfloat16, device=None) -> Sam:
    """The net of a published-layout state dict (tensors or arrays) on
    ``device``: every weight it reads packed into one buffer and copied at
    once (:func:`netweights.upload_packed`: ``net.pack``, ``net.upload``),
    the compute-dtype copies, the stacked hypernetworks and the image's
    positional encoding made there (``net.load``), the net assembled round
    them (``net.init``)."""
    check_state_dict(state_dict, cfg)
    shapes = leaf_shapes(cfg)
    flat = upload_packed([(k, _host(state_dict[k]), s) for k, s in shapes],
                         "cpu" if device is None else device)
    weights = dict(zip((k for k, _ in shapes), flat))
    dt = compute_dtype or torch.float32
    with span("net.load"):
        cast = {k: v.to(dt) for k, v in weights.items()
                if "rel_pos" not in k}
        compute = sam_vit.build(weights, cast, cfg, "image_encoder.", dt)
        compute.update(_decoder_tensors(weights, cast, cfg))
    with span("net.init"):
        return Sam(cfg, weights, compute, dt)
