"""C2S spike-inference baseline: deprecated, kept for inventory parity.

Port of ``deepcalcium_tpu.models.c2s_segmentation``. The reference's
``C2SSegmentation`` (``models/spikes/c2s_segmentation.py``) wraps the
external ``c2s`` package (C++ CMT/liblbfgs STM models) and does not work in
the reference itself: it imports metrics that do not exist
(``c2s_segmentation.py:14`` against ``utils/spikes.py``), holds two live
``pdb.set_trace()`` calls (``:102-103, :140-141``), and its ``predict`` is a
stub (``:143-157``). So both packages document it as deprecated.

The spike-inference paths of this package:
- deep: :class:`deepcalcium_torch.models.unet_1d_segmentation.UNet1DSegmentation`;
- classical (the capability C2S provided): the convolutional GLM and the
  STM of :class:`deepcalcium_torch.models.glm_spikes.GLMSegmentation`.
"""


class C2SSegmentation:
    """Deprecated. See the module docstring; use UNet1DSegmentation (deep)
    or GLMSegmentation (classical) instead."""

    DEPRECATION_REASON = (
        "The reference C2S wrapper is broken upstream (nonexistent metric "
        "imports, live pdb breakpoints, stub predict). Use "
        "UNet1DSegmentation, or GLMSegmentation for a classical baseline "
        "(models/glm_spikes.py)."
    )

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(self.DEPRECATION_REASON)
