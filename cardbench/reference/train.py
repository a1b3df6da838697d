"""The first training steps of a fit, worked out plainly: the training
forward (BN by batch statistics, dropout by given keep-masks), the mean
loss, its gradient by autograd, and Adam."""

import torch

from cardbench.reference.adam import Adam
from cardbench.reference.precision import exact_fp32


def param_keys(W):
    """The trainable leaves of a weight dict (not the BN statistics)."""
    return [k for k in W if not k.endswith((".mean", ".var"))]


def steps(forward, W0, batches, masks, loss, lr, drp, quant=None,
          rows=None, **fwd_kw):
    """Run len(batches) steps from the weights ``W0``.

    ``forward(W, x, train=True, drp=, drop=, quant=, **fwd_kw)`` is the
    net's training forward; ``masks[s]`` the keep-masks of step s by
    dropout site; ``rows``, when given, the rows of each batch that the
    loss averages (a fault's half batch).

    Returns (losses, first gradient by leaf, change of each leaf after the
    last step)."""
    keys = param_keys(W0)
    P = {k: W0[k].detach().clone().float() for k in keys}
    opt = Adam(P, lr=lr)
    losses, grad1 = [], None
    with exact_fp32():
        for s, (x, y) in enumerate(batches):
            leaves = {k: P[k].detach().requires_grad_() for k in keys}

            def drop(site, h, rate, m=masks[s]):
                return torch.where(m[site], h / (1.0 - rate),
                                   torch.zeros_like(h))

            probs = forward(leaves, x, train=True, drp=drp, drop=drop,
                            quant=quant, **fwd_kw)
            if rows is not None:
                probs, yy = probs[:rows], y[:rows]
            else:
                yy = y
            value = loss(yy, probs)
            grads = torch.autograd.grad(value, [leaves[k] for k in keys])
            g = {k: gk.detach() for k, gk in zip(keys, grads)}
            if s == 0:
                grad1 = g
            losses.append(float(value.detach()))
            opt.step(g)
    change = {k: P[k] - W0[k].float() for k in keys}
    return losses, grad1, change
