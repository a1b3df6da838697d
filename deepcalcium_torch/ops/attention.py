"""Global attention with SAM's decomposed relative-position bias, the
attention of every block of Cellpose-SAM's ViT encoder.

For a (gh, gw) grid of tokens, query token (i, j) and key token (k, l) of
one head, the bias is

    B[(i, j), (k, l)] = q_ij . Rh[i - k + gh - 1] + q_ij . Rw[j - l + gw - 1]

with q the head's unscaled query and ``Rh`` (2 gh - 1, d), ``Rw``
(2 gw - 1, d) the block's tables, shared by its heads, re-sampled from
their stored length as SAM's ``get_rel_pos`` does. The attention is
``softmax(q k^T / sqrt(d) + B) v``.

:func:`attention_qkv` takes the qkv projection's output (B, N, 3 heads d)
as ``F.linear`` gives it and returns (B, N, heads d), the layout the output
projection reads. On a card it is one launch of a hand-written CUDA kernel
(:func:`attention_qkv_cuda`, ``csrc/attention.cu``, whose header gives its
design and bound); on the CPU it is the plain version, :func:`attention`.

The plain version never holds B. Its two terms are small contractions,
``rel_h = q . Rh`` (a grid row of entries a query) and ``rel_w = q . Rw``
(a grid column), and B is their product with one-hot rows of the key's
grid row and column:

    q k^T s + B = [q s, rel_h, rel_w] . [k, onehot(k), onehot(l)]^T

so it runs as plain attention without a mask on queries and keys of
d + gh + gw channels, with v padded to the same width. The kernel instead
takes both terms in float32 into its scores, at head dim d.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from deepcalcium_torch.ops._build import load_library, raise_on

__all__ = ["resample_rel_pos", "rel_pos_index", "rel_pos_terms",
           "attention", "attention_qkv", "attention_qkv_cuda"]

LOG2E = math.log2(math.e)


def resample_rel_pos(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """A stored (L, d) table as the (2 size - 1, d) one a ``size``-token
    axis uses: linearly re-sampled along L (``align_corners=False``) when
    L differs, as SAM's ``get_rel_pos``; the table itself otherwise."""
    n = 2 * size - 1
    if rel_pos.shape[0] == n:
        return rel_pos
    return F.interpolate(rel_pos.t()[None], size=n, mode="linear")[0].t()


def rel_pos_index(table: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size, d): entry [i, k] is ``table[i - k + size - 1]``."""
    i = torch.arange(size, device=table.device)
    return table[i[:, None] - i[None, :] + size - 1]


def rel_pos_terms(q: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor):
    """(rel_h (B, heads, N, gh), rel_w (B, heads, N, gw)) of the unscaled
    queries ``q`` (B, heads, gh, gw, d) with the indexed tables ``rh``
    (gh, gh, d) and ``rw`` (gw, gw, d) of :func:`rel_pos_index`, in
    ``q``'s dtype: B[m, (k, l)] = rel_h[m, k] + rel_w[m, l]."""
    b, h, gh, gw, _ = q.shape
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", q, rh.to(q.dtype))
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", q, rw.to(q.dtype))
    return rel_h.reshape(b, h, gh * gw, gh), rel_w.reshape(b, h, gh * gw, gw)


def _one_hot_keys(grid, like):
    """(N, gh + gw): each key's grid row and column, one-hot."""
    gh, gw = grid
    eye_h = torch.eye(gh, dtype=like.dtype, device=like.device)
    eye_w = torch.eye(gw, dtype=like.dtype, device=like.device)
    return torch.cat([eye_h.repeat_interleave(gw, 0), eye_w.repeat(gh, 1)], 1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              rh: torch.Tensor, rw: torch.Tensor, grid) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d) + B) v`` over every token of the grid,
    with B as in the module's docstring; q, k, v are (B, heads, N, d)
    with N the tokens of ``grid`` (gh, gw) in row-major order, ``rh`` and
    ``rw`` the indexed tables of :func:`rel_pos_index`. The plain
    version."""
    b, h, n, d = q.shape
    rel_h, rel_w = rel_pos_terms(q.reshape(b, h, grid[0], grid[1], d), rh, rw)
    extra = grid[0] + grid[1]
    qa = torch.cat([q * d ** -0.5, rel_h, rel_w], dim=-1)
    ka = torch.cat([k, _one_hot_keys(grid, k).expand(b, h, n, extra)], dim=-1)
    va = F.pad(v, (0, extra))
    return F.scaled_dot_product_attention(qa, ka, va, scale=1.0)[..., :d]


def attention_qkv(qkv: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor,
                  grid, heads: int) -> torch.Tensor:
    """The attention of the qkv projection's output ``qkv`` (B, N, 3 heads
    d), with the re-sampled tables ``rh`` (2 gh - 1, d) and ``rw``
    (2 gw - 1, d): (B, N, heads d), the layout the output projection
    reads. A CUDA tensor takes the kernel (:func:`attention_qkv_cuda`),
    which raises on what it does not take; a CPU tensor the plain
    :func:`attention`."""
    if qkv.is_cuda:
        return attention_qkv_cuda(qkv, rh, rw, grid, heads)
    if qkv.device.type != "cpu":
        raise ValueError(f"attention_qkv runs on a CUDA card or the CPU, "
                         f"not on {qkv.device}")
    b, n, c3 = qkv.shape
    d = c3 // (3 * heads)
    q, k, v = qkv.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    out = attention(q, k, v, rel_pos_index(rh, grid[0]),
                    rel_pos_index(rw, grid[1]), grid)
    return out.transpose(1, 2).reshape(b, n, heads * d)


def attention_qkv_cuda(qkv: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor,
                       grid, heads: int) -> torch.Tensor:
    """:func:`attention_qkv` as one launch of ``csrc/attention.cu``'s
    kernel on the current stream: a contiguous bfloat16 (or float32)
    ``qkv`` (B, N, 3 heads d) of a (gh, gw) grid, N = gh gw, up to 64 x 64,
    d a multiple of 16 up to 128, and contiguous tables ``rh`` (2 gh - 1,
    d), ``rw`` (2 gw - 1, d) of its dtype, on one card, each 16-byte
    aligned. It allocates only its output and does not synchronise, so it
    runs inside a CUDA graph."""
    tensors = (qkv, rh, rw)
    if len({t.device for t in tensors}) != 1 or not qkv.is_cuda:
        raise ValueError(f"attention_qkv_cuda needs CUDA tensors on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if qkv.dtype not in (torch.bfloat16, torch.float32) or \
            rh.dtype != qkv.dtype or rw.dtype != qkv.dtype:
        raise TypeError(f"attention_qkv_cuda takes bfloat16 or float32 "
                        f"tensors of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention_qkv_cuda needs contiguous qkv, rh, rw")
    gh, gw = grid
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"attention_qkv_cuda takes qkv (B, N, 3 x {heads} "
                         f"heads x d), got {tuple(qkv.shape)}")
    b, n, c3 = qkv.shape
    d = c3 // (3 * heads)
    if not (1 <= gh <= 64 and 1 <= gw <= 64) or n != gh * gw or \
            d % 16 or not 16 <= d <= 128 or b * heads > 65535:
        raise ValueError(f"attention_qkv_cuda takes a grid up to 64 x 64 of "
                         f"N = gh gw tokens, a head dim of a multiple of 16 "
                         f"up to 128 and at most 65535 (batch, head) pairs, "
                         f"got grid {tuple(grid)}, N {n}, d {d}, {b} x "
                         f"{heads}")
    if tuple(rh.shape) != (2 * gh - 1, d) or \
            tuple(rw.shape) != (2 * gw - 1, d):
        raise ValueError(f"attention_qkv_cuda takes rh ({2 * gh - 1}, {d}) "
                         f"and rw ({2 * gw - 1}, {d}), got {tuple(rh.shape)} "
                         f"and {tuple(rw.shape)}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("attention_qkv_cuda needs 16-byte aligned qkv, rh, "
                         "rw")
    out = torch.empty((b, n, heads * d), dtype=qkv.dtype, device=qkv.device)
    lib = load_library()
    with torch.cuda.device(qkv.device):
        err = lib.dc_rel_pos_attention(
            *(ctypes.c_void_p(t.data_ptr()) for t in (qkv, rh, rw, out)),
            b, gh, gw, heads, d, int(qkv.dtype == torch.float32),
            d ** -0.5 * LOG2E,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    raise_on(err, "attention kernel")
    attention_qkv_cuda.launches += 1
    return out


attention_qkv_cuda.launches = 0
