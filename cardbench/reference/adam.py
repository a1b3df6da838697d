"""Adam as published (Kingma and Ba), with the defaults the wrappers
document: betas (0.9, 0.999), eps 1e-8 added to the square root of the
bias-corrected second moment."""

import torch


class Adam:
    def __init__(self, params: dict, lr=2e-3, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            self.params[k] -= self.lr * (self.m[k] / c1) / (
                (self.v[k] / c2).sqrt() + self.eps)
