"""The port's host-side scoring modules against the JAX package's:
``mask_summary_exact``, the Neurofinder metrics and the checkpoint
directory. These are numpy code on both sides, so results must be equal."""

import numpy as np
import pytest
import torch

from deepcalcium_tpu.data.fixtures import realistic_neurons
from deepcalcium_tpu.metrics import neurofinder as jnf
from deepcalcium_tpu.ops.mask_summary import mask_summary_exact as jmask_summary
from deepcalcium_tpu.utils import config as jconfig
from deepcalcium_torch.metrics import neurofinder as tnf
from deepcalcium_torch.ops.mask_summary import mask_summary_exact
from deepcalcium_torch.utils import config as tconfig

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_summary_exact_matches_jax(seed):
    """Touching and overlapping neurons: the order-dependent erosion."""
    rng = np.random.default_rng(seed)
    masks = realistic_neurons(rng, (64, 64), nb_neurons=25, r_lo=2, r_hi=6)
    masks[0] |= masks[1]  # an overlap as well as touching pairs
    out = mask_summary_exact(masks)
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, jmask_summary(masks))


def _mask_pair(seed):
    rng = np.random.default_rng(seed)
    truth = mask_summary_exact(realistic_neurons(rng, (96, 96), nb_neurons=20))
    pred = np.roll(truth, (int(rng.integers(-2, 3)), int(rng.integers(-2, 3))),
                   axis=(0, 1))
    pred[rng.random(pred.shape) < 0.01] = 1          # specks
    pred[:, int(rng.integers(0, 96)):][:, :10] = 0  # a missed band
    return truth, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [np.inf, 3.0])
def test_nf_mask_metrics_matches_jax(seed, threshold):
    truth, pred = _mask_pair(seed)
    got = tnf.nf_mask_metrics(truth, pred, threshold)
    assert got == jnf.nf_mask_metrics(truth, pred, threshold)
    assert 0.0 < got[4] < 1.0


def test_nf_mask_metrics_edge_cases():
    truth, _ = _mask_pair(3)
    empty = np.zeros_like(truth)
    assert tnf.nf_mask_metrics(truth, empty) == (0.0,) * 5
    assert tnf.nf_mask_metrics(truth, truth) == (1.0,) * 5
    # A probability map rounds at 0.5, as in the JAX package.
    prob = truth * 0.6 + 0.3
    assert (tnf.nf_mask_metrics(truth, prob)
            == jnf.nf_mask_metrics(truth, prob))


def test_checkpoints_dir_is_shared_with_jax_package():
    assert tconfig.checkpoints_dir() == jconfig.checkpoints_dir()


def test_latest_resolves_in_shared_checkpoints_dir(tmp_path):
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary

    model = UNet2DSummary(device="cpu")
    assert model.cpdir is None  # nothing created until "latest" is asked for
    with pytest.raises(FileNotFoundError, match="neurons_unet2ds"):
        model.evaluate_movie(np.zeros((2, 16, 16), np.int16),
                             model_path="latest", window_shape=(16, 16))
