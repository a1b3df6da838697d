"""The yardstick: the card's published peaks and the operations and bytes
of each measured piece of work, frozen here so that a change to the
measured package cannot move them.

Peaks: NVIDIA's data sheet for the H100 SXM, dense bf16 on the tensor
cores and HBM3 bandwidth, at its full power limit of 700 W. Operations:
2 x the multiply-adds of the convs and transpose convs, from the
published layer widths (:mod:`cardbench.reference`)."""

from cardbench.reference import unet1d, unet2ds

PEAK_CARD = "NVIDIA H100 SXM (80 GB HBM3), 700 W"
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def forward_flops(config, *shape):
    """FLOPs of one forward of ``config``'s net on one window of
    ``shape`` ((h, w) for the 2-D net, (t,) for the 1-D one)."""
    if config["arch"] == "unet2ds":
        return unet2ds.forward_flops(*shape, nfb=config["nfb"])
    return unet1d.forward_flops(*shape, nfb=config["nfb"])


def k1_bytes(t, h, w, itemsize=2):
    """Bytes kernel K1 has to move for one summary: the movie read once,
    the float32 mean and max written once."""
    return t * h * w * itemsize + 2 * h * w * 4


def eval_net_bound_s(config, window, views):
    """Least seconds of the net and glue of one evaluate call on the card:
    the larger of the forward's FLOPs over the bf16 peak and its
    irreducible bytes (the float32 mean read, the weights read once in
    bf16, the float32 probabilities and the uint8 mask written) over the
    bandwidth."""
    h, w = window
    flops = views * forward_flops(config, h, w)
    nbytes = h * w * 4 + 2 * unet2ds.param_count(config["nfb"]) + h * w * 5
    return max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
