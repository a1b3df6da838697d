"""The plain reference of Segment Anything ViT-H and of its automatic mask
generator on a mean image, in float32 (with TF32 off around it): plain
PyTorch, the attention scores and the relative-position bias materialised,
written from facebookresearch/segment-anything (``modeling/image_encoder.py``:
``Block``, ``Attention``, ``window_partition``, ``window_unpartition``,
``add_decomposed_rel_pos``; ``prompt_encoder.py``; ``mask_decoder.py``;
``transformer.py``; ``automatic_mask_generator.py``; ``utils/amg.py``;
``utils/transforms.py``). It holds the yardstick's operation counts.

Departures from the published code, each marked where it is made:

- the input: the mean image's ``normalize99`` clipped to [0, 1], times 255
  and rounded, resized by ``F.interpolate`` (``apply_image_torch``) where
  ``SamPredictor.set_image`` takes a uint8 image through PIL;
- NMS is written out (no torchvision here), with ties in index order;
- the kept masks are painted into a label image where the generator
  returns run-length encodings.

Weights are a dict by the published state dict's key names; a config is a
dict of the widths (``cardbench/configs/sam-vit-h-amg.json``). ``quant``
rounds the input and weight of every linear and conv (the fp8 control)."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from cardbench.reference.cellpose_sam import _conv, _lin, _ln, normalize99
from cardbench.reference.cellpose_sam import rel_table


def _window(cfg, block):
    """The window a block attends in, 0 for the whole grid."""
    return 0 if block in cfg["global_blocks"] else cfg["window_size"]


def _lin_leaves(key, n_out, n_in):
    return [(key + ".weight", (n_out, n_in)), (key + ".bias", (n_out,))]


def _attn_leaves(key, dim, inner):
    return [leaf for n, (a, b) in (("q", (inner, dim)), ("k", (inner, dim)),
                                   ("v", (inner, dim)), ("out", (dim, inner)))
            for leaf in _lin_leaves(f"{key}.{n}_proj", a, b)]


def leaves(cfg):
    """(key, shape) of every weight the forward reads, published names."""
    w, m, n, p = cfg["width"], cfg["mlp_dim"], cfg["neck_dim"], cfg["patch"]
    g, hd = cfg["image_size"] // p, cfg["width"] // cfg["heads"]
    e = "image_encoder."
    out = [(e + "patch_embed.proj.weight", (w, 3, p, p)),
           (e + "patch_embed.proj.bias", (w,)),
           (e + "pos_embed", (1, g, g, w))]
    for i in range(cfg["depth"]):
        b = f"{e}blocks.{i}."
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
    out += [(e + "neck.0.weight", (n, w, 1, 1)),
            (e + "neck.1.weight", (n,)), (e + "neck.1.bias", (n,)),
            (e + "neck.2.weight", (n, n, 3, 3)),
            (e + "neck.3.weight", (n,)), (e + "neck.3.bias", (n,))]
    pe = "prompt_encoder."
    out += [(pe + "pe_layer.positional_encoding_gaussian_matrix", (2, n // 2))]
    out += [(f"{pe}point_embeddings.{i}.weight", (1, n)) for i in range(4)]
    out += [(pe + "not_a_point_embed.weight", (1, n)),
            (pe + "no_mask_embed.weight", (1, n))]
    t, inner, dm = ("mask_decoder.transformer.",
                    n // cfg["attention_downsample"], cfg["decoder_mlp_dim"])
    for i in range(cfg["decoder_depth"]):
        b = f"{t}layers.{i}."
        out += _attn_leaves(b + "self_attn", n, n)
        out += [(b + "norm1.weight", (n,)), (b + "norm1.bias", (n,))]
        out += _attn_leaves(b + "cross_attn_token_to_image", n, inner)
        out += [(b + "norm2.weight", (n,)), (b + "norm2.bias", (n,))]
        out += _lin_leaves(b + "mlp.lin1", dm, n)
        out += _lin_leaves(b + "mlp.lin2", n, dm)
        out += [(b + f"norm{k}.{a}", (n,)) for k in (3, 4)
                for a in ("weight", "bias")]
        out += _attn_leaves(b + "cross_attn_image_to_token", n, inner)
    out += _attn_leaves(t + "final_attn_token_to_image", n, inner)
    out += [(t + "norm_final_attn.weight", (n,)),
            (t + "norm_final_attn.bias", (n,))]
    d, k = "mask_decoder.", cfg["multimask_outputs"] + 1
    out += [(d + "iou_token.weight", (1, n)),
            (d + "mask_tokens.weight", (k, n)),
            (d + "output_upscaling.0.weight", (n, n // 4, 2, 2)),
            (d + "output_upscaling.0.bias", (n // 4,)),
            (d + "output_upscaling.1.weight", (n // 4,)),
            (d + "output_upscaling.1.bias", (n // 4,)),
            (d + "output_upscaling.3.weight", (n // 4, n // 8, 2, 2)),
            (d + "output_upscaling.3.bias", (n // 8,))]
    for i in range(k):
        for j, (a, b) in enumerate([(n, n), (n, n), (n, n // 8)]):
            out += _lin_leaves(f"{d}output_hypernetworks_mlps.{i}.layers.{j}",
                               b, a)
    dims = ([n] + [cfg["iou_head_hidden"]] * (cfg["iou_head_depth"] - 1)
            + [k])
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += _lin_leaves(f"{d}iou_prediction_head.layers.{j}", b, a)
    return out


def param_count(cfg):
    return sum(math.prod(s) for _, s in leaves(cfg))


# --- the yardstick -----------------------------------------------------------

def _attention_terms(cfg):
    """Per block (windows, tokens a side of one): the whole grid or the
    windows of the grid padded to a multiple of the window."""
    g = cfg["image_size"] // cfg["patch"]
    out = []
    for i in range(cfg["depth"]):
        win = _window(cfg, i)
        out.append(((-(-g // win)) ** 2, win) if win else (1, g))
    return out


def attention_flops(cfg):
    """FLOPs of every block's attention on one image, the bound of the
    attention kernel: per head and window or grid of s x s tokens,
    4 (s^2)^2 d for the two products and 2 s^2 (2 s) d for the two bias
    contractions."""
    d = cfg["width"] // cfg["heads"]
    return sum(cfg["heads"] * nw * (4 * s ** 4 * d + 2 * s * s * 2 * s * d)
               for nw, s in _attention_terms(cfg))


def encoder_flops(cfg):
    """2 x the multiply-adds of the encoder on one image: the patch
    embedding; per block the qkv and output projections over every token of
    its windows (the padding too), the attention (:func:`attention_flops`)
    and the MLP; the neck."""
    g = cfg["image_size"] // cfg["patch"]
    n, w, nk = g * g, cfg["width"], cfg["neck_dim"]
    total = 2 * n * w * 3 * cfg["patch"] ** 2 + attention_flops(cfg)
    for nw, s in _attention_terms(cfg):
        t = nw * s * s
        total += 2 * t * w * 3 * w + 2 * t * w * w + 2 * 2 * n * w * cfg[
            "mlp_dim"]
    return total + 2 * n * w * nk + 2 * n * nk * nk * 9


def decoder_flops(cfg):
    """2 x the multiply-adds of the mask decoder for one point prompt: the
    two-way transformer's projections and products, the transposed convs,
    the hypernetworks, the mask products, the IoU head."""
    c = cfg["neck_dim"]
    n = (cfg["image_size"] // cfg["patch"]) ** 2
    k = cfg["multimask_outputs"] + 1
    t = 1 + k + 2
    ci = c // cfg["attention_downsample"]
    cross = 2 * (t * c * ci + 2 * n * c * ci + 2 * t * n * ci + t * ci * c)
    back = 2 * (n * c * ci + 2 * t * c * ci + 2 * n * t * ci + n * ci * c)
    block = (8 * t * c * c + 4 * t * t * c + cross
             + 4 * t * c * cfg["decoder_mlp_dim"] + back)
    up = 8 * n * c * (c // 4) + 32 * n * (c // 4) * (c // 8)
    hyper = k * 2 * (2 * c * c + c * (c // 8))
    dims = [c] + [cfg["iou_head_hidden"]] * (cfg["iou_head_depth"] - 1) + [k]
    iou = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    return (cfg["decoder_depth"] * block + cross + up + hyper + iou
            + 2 * k * (c // 8) * 16 * n)


def forward_flops(cfg, prompts=None):
    """One call's FLOPs: the encoder once and the decoder for every point
    prompt of the grid (``points_per_side`` squared)."""
    if prompts is None:
        prompts = cfg["amg"]["points_per_side"] ** 2
    return encoder_flops(cfg) + prompts * decoder_flops(cfg)


# --- the image ---------------------------------------------------------------

def resized_shape(h, w, long_side):
    """``ResizeLongestSide.get_preprocess_shape``."""
    scale = long_side * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def image(mean, cfg):
    """(the (1, 3, S, S) encoder input, the resized (h, w)) of an (H, W)
    mean image. Departure: the 8-bit image is made by ``normalize99``,
    clipping, x 255 and rounding, and resized by ``apply_image_torch``
    (bilinear, antialiased, on its float values) in place of PIL."""
    img = torch.round(normalize99(mean).clamp(0, 1) * 255)
    s = cfg["image_size"]
    size = resized_shape(img.shape[0], img.shape[1], s)
    x = img[None, None].repeat(1, 3, 1, 1)
    x = F.interpolate(x, size, mode="bilinear", align_corners=False,
                      antialias=True)
    mean_px = torch.tensor(cfg["pixel_mean"], device=x.device).view(-1, 1, 1)
    std_px = torch.tensor(cfg["pixel_std"], device=x.device).view(-1, 1, 1)
    x = (x - mean_px) / std_px
    return F.pad(x, (0, s - size[1], 0, s - size[0])), size


# --- the image encoder -------------------------------------------------------

def window_partition(x, win):
    b, h, w, c = x.shape
    ph, pw = (win - h % win) % win, (win - w % win) % win
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // win, win, wp // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, win, win, c), \
        (hp, wp)


def window_unpartition(windows, win, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // win // win)
    x = windows.view(b, hp // win, wp // win, win, win, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    return x[:, :h, :w, :].contiguous()


def _encoder_attention(W, p, x, cfg, quant):
    """SAM's image encoder ``Attention.forward`` on (B, h, w, c), the
    scores and the bias materialised in float32."""
    b, h, w, _ = x.shape
    nh = cfg["heads"]
    qkv = _lin(x, W[p + "qkv.weight"], W[p + "qkv.bias"], quant)
    qkv = qkv.reshape(b, h * w, 3, nh, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, b * nh, h * w, -1).unbind(0)
    attn = (q * (cfg["width"] // nh) ** -0.5) @ k.transpose(-2, -1)
    rh = rel_table(W[p + "rel_pos_h"], h)
    rw = rel_table(W[p + "rel_pos_w"], w)
    r_q = q.reshape(b * nh, h, w, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = (attn.view(b * nh, h, w, h, w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(b * nh, h * w, h * w)
    attn = attn.softmax(dim=-1)
    x = (attn @ v).view(b, nh, h, w, -1).permute(0, 2, 3, 1, 4).reshape(
        b, h, w, -1)
    return _lin(x, W[p + "proj.weight"], W[p + "proj.bias"], quant)


def encoder(W, x, cfg, quant=None):
    """The neck's (1, 256, g, g) image embedding of a (1, 3, S, S) input."""
    eps, e = cfg["ln_eps"], "image_encoder."
    x = _conv(x, W[e + "patch_embed.proj.weight"],
              W[e + "patch_embed.proj.bias"], quant, stride=cfg["patch"])
    x = x.permute(0, 2, 3, 1) + W[e + "pos_embed"]
    for i in range(cfg["depth"]):
        p = f"{e}blocks.{i}."
        shortcut = x
        x = _ln(x, W[p + "norm1.weight"], W[p + "norm1.bias"], eps)
        win = _window(cfg, i)
        if win:
            hw = x.shape[1:3]
            x, pad_hw = window_partition(x, win)
        x = _encoder_attention(W, p + "attn.", x, cfg, quant)
        if win:
            x = window_unpartition(x, win, pad_hw, hw)
        x = shortcut + x
        h = _ln(x, W[p + "norm2.weight"], W[p + "norm2.bias"], eps)
        h = F.gelu(_lin(h, W[p + "mlp.lin1.weight"], W[p + "mlp.lin1.bias"],
                        quant))
        x = x + _lin(h, W[p + "mlp.lin2.weight"], W[p + "mlp.lin2.bias"],
                     quant)
    x = x.permute(0, 3, 1, 2)
    x = _conv(x, W[e + "neck.0.weight"], None, quant)
    x = _ln2d(x, W[e + "neck.1.weight"], W[e + "neck.1.bias"], eps)
    x = _conv(x, W[e + "neck.2.weight"], None, quant, padding=1)
    return _ln2d(x, W[e + "neck.3.weight"], W[e + "neck.3.bias"], eps)


def _ln2d(x, w, b, eps):
    """SAM's ``LayerNorm2d``, written out."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return w[:, None, None] * x + b[:, None, None]


# --- the prompt encoder ------------------------------------------------------

def _pe_encoding(W, coords):
    g = W["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    coords = 2 * coords - 1
    coords = coords @ g
    coords = 2 * np.pi * coords
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def point_grid(n):
    """``build_point_grid``: (n^2, 2) float64 (x, y) in [0, 1]."""
    offset = 1 / (2 * n)
    side = np.linspace(offset, 1 - offset, n)
    xs = np.tile(side[None, :], (n, 1))
    ys = np.tile(side[:, None], (1, n))
    return np.stack([xs, ys], axis=-1).reshape(-1, 2)


def prompt_points(cfg, h, w):
    """The grid scaled to the h x w image, then by ``apply_coords`` to the
    resized image's frame: (P, 2) float64."""
    nh, nw = resized_shape(h, w, cfg["image_size"])
    pts = point_grid(cfg["amg"]["points_per_side"]) * np.array([w, h])[None]
    pts = pts.astype(float)
    pts[..., 0] = pts[..., 0] * (nw / w)
    pts[..., 1] = pts[..., 1] * (nh / h)
    return pts


def sparse_embeddings(W, points, cfg):
    """``PromptEncoder._embed_points`` of P foreground points (P, 2),
    float64 (x, y), each with the padding point: (P, 2, 256)."""
    dev = W["prompt_encoder.no_mask_embed.weight"].device
    points = torch.as_tensor(points, dtype=torch.float64, device=dev)
    points = points[:, None, :] + 0.5
    labels = torch.ones(points.shape[0], 1, device=dev)
    points = torch.cat([points, torch.zeros_like(points)], dim=1)
    labels = torch.cat([labels, -torch.ones_like(labels)], dim=1)
    s = cfg["image_size"]
    coords = points.clone()
    coords[:, :, 0] = coords[:, :, 0] / s
    coords[:, :, 1] = coords[:, :, 1] / s
    emb = _pe_encoding(W, coords.to(torch.float))
    pe = "prompt_encoder."
    emb[labels == -1] = 0.0
    emb[labels == -1] += W[pe + "not_a_point_embed.weight"][0]
    emb[labels == 1] += W[pe + "point_embeddings.1.weight"][0]
    return emb


def image_pe(W, cfg):
    """``PromptEncoder.get_dense_pe``: (1, 256, g, g)."""
    g = cfg["image_size"] // cfg["patch"]
    grid = torch.ones((g, g), device=W["prompt_encoder.no_mask_embed.weight"]
                      .device)
    y = (grid.cumsum(dim=0) - 0.5) / g
    x = (grid.cumsum(dim=1) - 0.5) / g
    return _pe_encoding(W, torch.stack([x, y], dim=-1)).permute(2, 0, 1)[None]


# --- the mask decoder --------------------------------------------------------

def _attention(W, p, q, k, v, heads, quant):
    """The decoder's ``Attention``: projections, heads, softmax written
    out, recombined heads, the output projection."""
    q = _lin(q, W[p + "q_proj.weight"], W[p + "q_proj.bias"], quant)
    k = _lin(k, W[p + "k_proj.weight"], W[p + "k_proj.bias"], quant)
    v = _lin(v, W[p + "v_proj.weight"], W[p + "v_proj.bias"], quant)

    def heads_of(x):
        b, n, c = x.shape
        return x.reshape(b, n, heads, c // heads).transpose(1, 2)

    q, k, v = heads_of(q), heads_of(k), heads_of(v)
    attn = q @ k.permute(0, 1, 3, 2) / math.sqrt(q.shape[-1])
    out = torch.softmax(attn, dim=-1) @ v
    b, h, n, c = out.shape
    out = out.transpose(1, 2).reshape(b, n, h * c)
    return _lin(out, W[p + "out_proj.weight"], W[p + "out_proj.bias"], quant)


def _norm(W, key, x, eps=1e-5):
    return _ln(x, W[key + ".weight"], W[key + ".bias"], eps)


def _mlp(W, key, x, layers, quant):
    for i in range(layers):
        x = _lin(x, W[f"{key}.layers.{i}.weight"], W[f"{key}.layers.{i}.bias"],
                 quant)
        if i < layers - 1:
            x = F.relu(x)
    return x


def decoder(W, embedding, sparse, cfg, quant=None, pe=None):
    """``MaskDecoder.predict_masks`` and its multimask slice for one image's
    (1, 256, g, g) embedding and P prompts' (P, 2, 256) sparse embeddings:
    (low-res logits (P, 3, 4 g, 4 g), predicted IoUs (P, 3))."""
    return decoder_heads(W, *decoder_features(W, embedding, sparse, cfg,
                                              quant, pe), cfg, quant)


def decoder_features(W, embedding, sparse, cfg, quant=None, pe=None):
    """The two-way transformer's output tokens (P, 7, 256) and the upscaled
    image side (P, 32, 4 g, 4 g) of :func:`decoder`."""
    t, d, h = ("mask_decoder.transformer.", "mask_decoder.",
               cfg["decoder_heads"])
    pe = image_pe(W, cfg) if pe is None else pe
    out_tokens = torch.cat([W[d + "iou_token.weight"],
                            W[d + "mask_tokens.weight"]], dim=0)
    tokens = torch.cat([out_tokens[None].expand(sparse.shape[0], -1, -1),
                        sparse], dim=1)
    dense = W["prompt_encoder.no_mask_embed.weight"].reshape(1, -1, 1, 1)
    src = torch.repeat_interleave(embedding, tokens.shape[0], dim=0) + dense
    pos = torch.repeat_interleave(pe, tokens.shape[0], dim=0)
    b, c, gh, gw = src.shape
    keys = src.flatten(2).permute(0, 2, 1)
    key_pe = pos.flatten(2).permute(0, 2, 1)
    queries = tokens
    for i in range(cfg["decoder_depth"]):
        p = f"{t}layers.{i}."
        if i == 0:      # skip_first_layer_pe
            queries = _attention(W, p + "self_attn.", queries, queries,
                                 queries, h, quant)
        else:
            q = queries + tokens
            queries = queries + _attention(W, p + "self_attn.", q, q, queries,
                                           h, quant)
        queries = _norm(W, p + "norm1", queries)
        q, k = queries + tokens, keys + key_pe
        queries = queries + _attention(W, p + "cross_attn_token_to_image.",
                                       q, k, keys, h, quant)
        queries = _norm(W, p + "norm2", queries)
        mlp = _lin(F.relu(_lin(queries, W[p + "mlp.lin1.weight"],
                               W[p + "mlp.lin1.bias"], quant)),
                   W[p + "mlp.lin2.weight"], W[p + "mlp.lin2.bias"], quant)
        queries = _norm(W, p + "norm3", queries + mlp)
        q, k = queries + tokens, keys + key_pe
        keys = keys + _attention(W, p + "cross_attn_image_to_token.", k, q,
                                 queries, h, quant)
        keys = _norm(W, p + "norm4", keys)
    q, k = queries + tokens, keys + key_pe
    queries = queries + _attention(W, t + "final_attn_token_to_image.", q, k,
                                   keys, h, quant)
    queries = _norm(W, t + "norm_final_attn", queries)
    src = keys.transpose(1, 2).reshape(b, c, gh, gw)
    u0, u3 = d + "output_upscaling.0.", d + "output_upscaling.3."
    up = F.conv_transpose2d(_q(src, quant), _q(W[u0 + "weight"], quant),
                            W[u0 + "bias"], stride=2)
    up = F.gelu(_ln2d(up, W[d + "output_upscaling.1.weight"],
                      W[d + "output_upscaling.1.bias"], 1e-6))
    up = F.gelu(F.conv_transpose2d(_q(up, quant), _q(W[u3 + "weight"], quant),
                                   W[u3 + "bias"], stride=2))
    return queries, up


def hypernetworks(W, queries, cfg, quant=None):
    """The four hypernetworks' (P, 4, 32) outputs of the output tokens."""
    d = "mask_decoder."
    return torch.stack([_mlp(W, f"{d}output_hypernetworks_mlps.{i}",
                             queries[:, 1 + i], 3, quant)
                        for i in range(cfg["multimask_outputs"] + 1)], dim=1)


def decoder_heads(W, queries, up, cfg, quant=None):
    """The mask logits and IoUs of :func:`decoder` from its features."""
    d = "mask_decoder."
    hyper = hypernetworks(W, queries, cfg, quant)
    b, c, hh, ww = up.shape
    masks = (_q(hyper, quant) @ _q(up, quant).view(b, c, hh * ww)).view(
        b, -1, hh, ww)
    iou = _mlp(W, d + "iou_prediction_head", queries[:, 0],
               cfg["iou_head_depth"], quant)
    return masks[:, 1:], iou[:, 1:]


def _q(x, quant):
    return x if quant is None else quant(x)


# --- the generator's steps ---------------------------------------------------

def postprocess(low_res, input_size, original_size, cfg):
    """``Sam.postprocess_masks``: (B, C, H, W) logits."""
    s = cfg["image_size"]
    masks = F.interpolate(low_res, (s, s), mode="bilinear",
                          align_corners=False)
    masks = masks[..., :input_size[0], :input_size[1]]
    return F.interpolate(masks, original_size, mode="bilinear",
                         align_corners=False)


def stability_score(masks, threshold, offset):
    """``calculate_stability_score``."""
    inter = (masks > (threshold + offset)).sum(-1, dtype=torch.int16).sum(
        -1, dtype=torch.int32)
    union = (masks > (threshold - offset)).sum(-1, dtype=torch.int16).sum(
        -1, dtype=torch.int32)
    return inter / union


def mask_to_box(masks):
    """``batched_mask_to_box`` of (N, H, W) boolean masks: (N, 4) int64."""
    if masks.numel() == 0:
        return torch.zeros(*masks.shape[:-2], 4, device=masks.device,
                           dtype=torch.int64)
    h, w = masks.shape[-2:]
    in_height, _ = torch.max(masks, dim=-1)
    coords = in_height * torch.arange(h, device=masks.device)[None, :]
    bottom, _ = torch.max(coords, dim=-1)
    coords = coords + h * (~in_height)
    top, _ = torch.min(coords, dim=-1)
    in_width, _ = torch.max(masks, dim=-2)
    coords = in_width * torch.arange(w, device=masks.device)[None, :]
    right, _ = torch.max(coords, dim=-1)
    coords = coords + w * (~in_width)
    left, _ = torch.min(coords, dim=-1)
    empty = (right < left) | (bottom < top)
    out = torch.stack([left, top, right, bottom], dim=-1)
    return out * (~empty).unsqueeze(-1)


def nms(boxes, scores, iou_threshold):
    """Indices kept by greedy NMS, in order of decreasing score. Departure:
    written out (torchvision's ``nms`` semantics in float32: IoU of the
    corner differences, a box dropped where its IoU with a kept one is
    above the threshold), ties taken in index order."""
    boxes = boxes.float().cpu().numpy()
    scores = scores.float().cpu().tolist()
    order = sorted(range(len(scores)), key=lambda i: (-scores[i], i))
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    thr = np.float32(iou_threshold)
    keep, alive = [], np.ones(len(order), bool)
    for a, i in enumerate(order):
        if not alive[a]:
            continue
        keep.append(i)
        rest = np.array(order[a + 1:], dtype=np.int64)
        w = np.maximum(np.minimum(boxes[i, 2], boxes[rest, 2])
                       - np.maximum(boxes[i, 0], boxes[rest, 0]),
                       np.float32(0))
        h = np.maximum(np.minimum(boxes[i, 3], boxes[rest, 3])
                       - np.maximum(boxes[i, 1], boxes[rest, 1]),
                       np.float32(0))
        inter = w * h
        with np.errstate(invalid="ignore", divide="ignore"):
            iou = inter / (area[i] + area[rest] - inter)
        alive[a + 1:] &= ~(iou > thr)
    return keep


def paint(masks):
    """The label image of boolean (n, H, W) kept masks. Departure: the
    generator returns run-length encodings; here the masks are painted by
    area, largest first (ties in index order), labels 1...n in that order,
    a later mask over an earlier one."""
    labels = torch.zeros(masks.shape[1:], dtype=torch.int32)
    area = masks.flatten(1).sum(1).tolist()
    order = sorted(range(len(area)), key=lambda i: (-area[i], i))
    for n, i in enumerate(order, start=1):
        labels[masks[i].cpu()] = n
    return labels


def generate(W, mean, cfg, quant=None):
    """The automatic mask generator on one (H, W) mean image, one crop:
    every intermediate as a dict (float32; ``masks`` the upscaled logits
    of all 3 P predictions, prompt by prompt)."""
    a = cfg["amg"]
    x, size = image(mean, cfg)
    emb = encoder(W, x, cfg, quant)
    hw = tuple(mean.shape)
    pts = prompt_points(cfg, *hw)
    pe = image_pe(W, cfg)
    low, iou, masks = [], [], []
    for i in range(0, len(pts), a["points_per_batch"]):
        sparse = sparse_embeddings(W, pts[i:i + a["points_per_batch"]], cfg)
        m, q = decoder(W, emb, sparse.to(emb.device), cfg, quant, pe)
        low.append(m)
        iou.append(q)
        masks.append(postprocess(m, size, hw, cfg).flatten(0, 1))
    low, iou = torch.cat(low), torch.cat(iou).flatten()
    masks = torch.cat(masks)
    stab = stability_score(masks, a["mask_threshold"],
                           a["stability_score_offset"])
    passed = ((iou > a["pred_iou_thresh"])
              & (stab >= a["stability_score_thresh"]))
    cand = torch.nonzero(passed).flatten()
    binary = masks[cand] > a["mask_threshold"]
    boxes = mask_to_box(binary)
    kept = [int(cand[k]) for k in nms(boxes, iou[cand], a["box_nms_thresh"])]
    return {"embedding": emb, "low_res": low, "iou": iou, "masks": masks,
            "stability": stab, "candidates": cand, "boxes": boxes,
            "kept": kept, "labels": paint(masks[kept] > a["mask_threshold"])}
