"""SAM's ViT image encoder (``segment_anything.modeling.image_encoder.
ImageEncoderViT``), the one block loop of Cellpose-SAM and Segment Anything.

On a (B, 3, S, S) image, with a grid of g = S / patch tokens a side:

- the patch embedding ``Conv2d(3, width, patch, stride patch)`` plus the
  learned (1, g, g, width) positional table;
- ``depth`` pre-LN blocks, LayerNorm eps ``ln_eps``: ``x + attn(LN1(x))``,
  then ``x + lin2(GELU(lin1(LN2(x))))`` (exact GELU). The attention is
  :func:`deepcalcium_torch.ops.attention.attention_qkv` with SAM's decomposed
  relative-position bias. A block listed in ``global_blocks``, and every
  block where ``window_size`` is 0, attends over the whole grid. The others
  attend in windows of ``window_size`` tokens a side
  (:func:`window_attention`): the grid is padded with zeros after LN1 to a multiple of the window, the
  padded tokens stay in as keys, and the output is cropped back;
- the neck ``Conv2d(width, neck, 1)``, LayerNorm over channels,
  ``Conv2d(neck, neck, 3, padding 1)``, LayerNorm over channels (no biases):
  (B, neck, g, g).

A block's stored tables are ``rel_pos_global`` entries long in the global
blocks and ``rel_pos_window`` in the others; the build re-samples each to the
axis it attends over (2 g - 1 in a global block, 2 window - 1 in a window
block) where its length differs, as SAM's ``get_rel_pos`` does.

The configuration is any object with the fields ``width``, ``depth``,
``heads``, ``mlp_dim``, ``patch``, ``grid``, ``neck_dim``, ``global_blocks``,
``window_size``, ``rel_pos_window``, ``rel_pos_global`` and ``ln_eps``.
"""

import math

import torch
import torch.nn.functional as F

from deepcalcium_torch.ops.attention import attention_qkv, resample_rel_pos

__all__ = ["block_window", "leaf_shapes", "param_count", "forward_flops",
           "build", "encode", "window_attention", "ln2d"]


def block_window(cfg, block: int) -> int:
    """The window a block attends in: 0 (the whole grid) for a global block
    or where the configuration has no windows."""
    if not cfg.window_size or block in cfg.global_blocks:
        return 0
    return cfg.window_size


def _rel_pos_len(cfg, block: int) -> int:
    return (cfg.rel_pos_global if block in cfg.global_blocks
            else cfg.rel_pos_window)


def leaf_shapes(cfg, prefix: str) -> list:
    """(key, shape) of every encoder weight, by the published state dict's
    names under ``prefix`` ("encoder." or "image_encoder.")."""
    w, m, n, p = cfg.width, cfg.mlp_dim, cfg.neck_dim, cfg.patch
    hd = w // cfg.heads
    out = [(prefix + "patch_embed.proj.weight", (w, 3, p, p)),
           (prefix + "patch_embed.proj.bias", (w,)),
           (prefix + "pos_embed", (1, cfg.grid, cfg.grid, w))]
    for i in range(cfg.depth):
        b = f"{prefix}blocks.{i}."
        r = _rel_pos_len(cfg, i)
        out += [(b + "norm1.weight", (w,)), (b + "norm1.bias", (w,)),
                (b + "attn.qkv.weight", (3 * w, w)),
                (b + "attn.qkv.bias", (3 * w,)),
                (b + "attn.proj.weight", (w, w)), (b + "attn.proj.bias", (w,)),
                (b + "attn.rel_pos_h", (r, hd)),
                (b + "attn.rel_pos_w", (r, hd)),
                (b + "norm2.weight", (w,)), (b + "norm2.bias", (w,)),
                (b + "mlp.lin1.weight", (m, w)), (b + "mlp.lin1.bias", (m,)),
                (b + "mlp.lin2.weight", (w, m)), (b + "mlp.lin2.bias", (w,))]
    out += [(prefix + "neck.0.weight", (n, w, 1, 1)),
            (prefix + "neck.1.weight", (n,)), (prefix + "neck.1.bias", (n,)),
            (prefix + "neck.2.weight", (n, n, 3, 3)),
            (prefix + "neck.3.weight", (n,)), (prefix + "neck.3.bias", (n,))]
    return out


def param_count(cfg) -> int:
    return sum(math.prod(s) for _, s in leaf_shapes(cfg, ""))


def forward_flops(cfg) -> int:
    """FLOPs (2 x multiply-adds) of the encoder on one image: the patch
    embedding; per block the qkv and output projections over every token a
    window holds (the padded ones too), the attention's two products and
    its two bias contractions over each window or the grid, the MLP; the
    neck."""
    g, w, nk = cfg.grid, cfg.width, cfg.neck_dim
    n = g * g
    total = 2 * n * w * 3 * cfg.patch ** 2
    for i in range(cfg.depth):
        win = block_window(cfg, i)
        side = win or g
        windows = (-(-g // win)) ** 2 if win else 1
        tokens = windows * side * side
        total += (2 * tokens * w * 3 * w + 2 * tokens * w * w
                  + windows * (2 * 2 * side ** 4 * w + 2 * 2 * side ** 3 * w)
                  + 2 * 2 * n * w * cfg.mlp_dim)
    return total + 2 * n * w * nk + 2 * n * nk * nk * 9


def build(weights: dict, cast: dict, cfg, prefix: str, dtype) -> dict:
    """What :func:`encode` reads: ``cast`` holds the compute-dtype copies of
    ``weights`` (the float32 tensors by published name) but the tables,
    which are re-sampled here from ``weights``."""
    blocks = []
    for i in range(cfg.depth):
        p = f"{prefix}blocks.{i}."
        win = block_window(cfg, i)
        rh, rw = (resample_rel_pos(weights[p + f"attn.rel_pos_{a}"],
                                   win or cfg.grid).to(dtype).contiguous()
                  for a in "hw")
        blocks.append({
            "window": win,
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
    return {"patch.w": cast[prefix + "patch_embed.proj.weight"],
            "patch.b": cast[prefix + "patch_embed.proj.bias"],
            "pos": cast[prefix + "pos_embed"][0], "blocks": blocks,
            "neck0": cast[prefix + "neck.0.weight"],
            "neck1.w": cast[prefix + "neck.1.weight"],
            "neck1.b": cast[prefix + "neck.1.bias"],
            "neck2": cast[prefix + "neck.2.weight"],
            "neck3.w": cast[prefix + "neck.3.weight"],
            "neck3.b": cast[prefix + "neck.3.bias"]}


def window_attention(h, blk, grid, window, heads):
    """A window block's attention of the normalised tokens ``h`` (B, g g, w):
    the (gh, gw) grid padded with zeros to a multiple of ``window`` a side,
    cut into windows, each attended over whole (its padded tokens are keys
    like the others), projected, and put back and cropped, as SAM's
    ``window_partition`` and ``window_unpartition``."""
    b, _, w = h.shape
    gh, gw = grid
    hp, wp = gh + (-gh) % window, gw + (-gw) % window
    nh, nw = hp // window, wp // window
    x = F.pad(h.view(b, gh, gw, w), (0, 0, 0, wp - gw, 0, hp - gh))
    x = x.view(b, nh, window, nw, window, w).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b * nh * nw, window * window, w)
    a = attention_qkv(F.linear(x, blk["qkv.w"], blk["qkv.b"]), blk["rh"],
                      blk["rw"], (window, window), heads)
    a = F.linear(a, blk["proj.w"], blk["proj.b"])
    a = a.view(b, nh, nw, window, window, w).permute(0, 1, 3, 2, 4, 5)
    return a.reshape(b, hp, wp, w)[:, :gh, :gw].reshape(b, gh * gw, w)


@torch.no_grad()
def encode(t: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The neck's (B, neck, g, g) output of (B, 3, S, S) images ``x`` in the
    compute dtype of the built tensors ``t``."""
    g, w, eps = cfg.grid, cfg.width, cfg.ln_eps
    b = x.shape[0]
    x = F.conv2d(x, t["patch.w"], t["patch.b"], stride=cfg.patch)
    x = (x.permute(0, 2, 3, 1) + t["pos"]).reshape(b, g * g, w)
    for blk in t["blocks"]:
        h = F.layer_norm(x, (w,), blk["n1.w"], blk["n1.b"], eps)
        if blk["window"]:
            x = x + window_attention(h, blk, (g, g), blk["window"], cfg.heads)
        else:
            a = attention_qkv(F.linear(h, blk["qkv.w"], blk["qkv.b"]),
                              blk["rh"], blk["rw"], (g, g), cfg.heads)
            x = x + F.linear(a, blk["proj.w"], blk["proj.b"])
        h = F.layer_norm(x, (w,), blk["n2.w"], blk["n2.b"], eps)
        x = x + F.linear(F.gelu(F.linear(h, blk["lin1.w"], blk["lin1.b"])),
                         blk["lin2.w"], blk["lin2.b"])
    x = x.view(b, g, g, w).permute(0, 3, 1, 2)
    x = ln2d(F.conv2d(x, t["neck0"]), t["neck1.w"], t["neck1.b"], eps)
    return ln2d(F.conv2d(x, t["neck2"], padding=1), t["neck3.w"],
                t["neck3.b"], eps)


def ln2d(x, weight, bias, eps):
    """LayerNorm over the channels of an NCHW tensor (SAM's LayerNorm2d)."""
    return F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), weight, bias,
                        eps).permute(0, 3, 1, 2)
