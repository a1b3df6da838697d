"""Global attention with SAM's decomposed relative-position bias, the
attention of every block of Cellpose-SAM's ViT encoder.

For a (gh, gw) grid of tokens, query token (i, j) and key token (k, l) of
one head, the bias is

    B[(i, j), (k, l)] = q_ij . Rh[i - k + gh - 1] + q_ij . Rw[j - l + gw - 1]

with q the head's unscaled query and ``Rh`` (2 gh - 1, d), ``Rw``
(2 gw - 1, d) the block's tables, shared by its heads, re-sampled from
their stored length as SAM's ``get_rel_pos`` does. The attention is
``softmax(q k^T / sqrt(d) + B) v``.

B is never held. Its two terms are small contractions, ``rel_h = q . Rh``
(a grid row of entries a query) and ``rel_w = q . Rw`` (a grid column),
and B is their product with one-hot rows of the key's grid row and column:

    q k^T s + B = [q s, rel_h, rel_w] . [k, onehot(k), onehot(l)]^T

So the attention runs as plain attention without a mask (flash) on queries
and keys of d + gh + gw channels, with v padded to the same width; the
bias terms add in the kernel's float32 accumulator. PERF.md gives its time
on the card against the bias built and passed as SDPA's additive mask.
"""

import torch
import torch.nn.functional as F

__all__ = ["resample_rel_pos", "rel_pos_index", "rel_pos_terms",
           "attention"]


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
    with N the tokens of ``grid`` (gh, gw) in row-major order."""
    b, h, n, d = q.shape
    rel_h, rel_w = rel_pos_terms(q.reshape(b, h, grid[0], grid[1], d), rh, rw)
    extra = grid[0] + grid[1]
    qa = torch.cat([q * d ** -0.5, rel_h, rel_w], dim=-1)
    ka = torch.cat([k, _one_hot_keys(grid, k).expand(b, h, n, extra)], dim=-1)
    va = F.pad(v, (0, extra))
    return F.scaled_dot_product_attention(qa, ka, va, scale=1.0)[..., :d]
