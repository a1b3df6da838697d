"""What the first training steps of a ``fit`` did, read without touching
the measured package: hooks on the net that ``fit`` builds (through the
wrappers' ``net_func`` injection point) and PyTorch's global optimizer
step hook. All of them are removed after the last observed step, before
the epoch's validation, so that the rest of the window runs bare.

For each of the first ``nsteps`` steps it keeps the net's input (the
sampled windows), its output (the probabilities the loss was taken of)
and each dropout site's keep-mask, read off the input of the conv that
follows the concatenation [up, skip] of each level (a dropped element is
0 there; where the activation is 0 anyway the mask does not matter). From
the optimizer it keeps Adam's first moment after step 1, which is
(1 - beta1) x the first gradient, and the parameters after the last
observed step."""

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook


class Stop(Exception):
    """Ends a ``fit`` after the observed steps (``stop=True``): the
    readings of the limits need no more of it."""


class StepCapture:
    def __init__(self, nfb, nsteps=3, stop=False):
        self.nfb, self.nsteps, self.stop = nfb, nsteps, stop
        self.x, self.probs, self.masks = [], [], []
        self.grad1 = self.params = None
        self.step = 0
        self.handles = []
        self.net = None

    def attach(self, net):
        """Hook ``net``, the net a ``fit`` is about to train."""
        self.net = net
        self.names = {p: n for n, p in net.named_parameters()}
        self.handles.append(net.register_forward_pre_hook(self._input))
        self.handles.append(net.register_forward_hook(self._output))
        for lvl in range(4):
            conv = getattr(net, f"dec{lvl}a_conv")
            self.handles.append(conv.register_forward_pre_hook(
                self._concat_hook(lvl)))
        self.handles.append(register_optimizer_step_post_hook(self._stepped))
        return net

    def _input(self, module, args):
        self.x.append(args[0].detach().float().clone())
        self.masks.append({})

    def _output(self, module, args, out):
        self.probs.append(out.detach().float().clone())

    def _concat_hook(self, lvl):
        skip = self.nfb * 2 ** lvl

        def hook(module, args):
            h = args[0]
            up = h.shape[1] - skip
            self.masks[-1][f"up{lvl}"] = (h[:, :up] != 0)
            if lvl:
                self.masks[-1][f"enc{lvl}"] = (h[:, up:] != 0)

        return hook

    def _stepped(self, optimizer, args, kwargs):
        self.step += 1
        if self.step == 1:
            b1 = optimizer.param_groups[0]["betas"][0]
            # A step that kept no moment moved nothing: a zero gradient.
            self.grad1 = {self.names[p]: optimizer.state[p].get(
                "exp_avg", torch.zeros_like(p)).detach().float() / (1 - b1)
                for p in self.names}
        if self.step == self.nsteps:
            self.params = {n: p.detach().float().clone()
                           for p, n in self.names.items()}
            self.remove()
            if self.stop:
                raise Stop

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []
