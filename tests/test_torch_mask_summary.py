"""The stencil mask summary of the port against the JAX package's, on the
CPU. Both are int32 arithmetic throughout, so every comparison is bitwise.
"""

import h5py
import numpy as np
import pytest
import torch

from deepcalcium_tpu.data.fixtures import make_neurons_hdf5, realistic_neurons
from deepcalcium_tpu.models import unet_2d_summary as jsummary
from deepcalcium_tpu.ops import mask_summary as jms
from deepcalcium_torch.models import unet_2d_summary as tsummary
from deepcalcium_torch.ops import mask_summary as tms

torch.set_num_threads(1)


def random_stack(rng, n=12, h=48, w=48, r=3):
    """The stack of ``tests/test_mask_summary.py``: n squares that may
    touch and overlap."""
    msks = np.zeros((n, h, w), np.int8)
    for i in range(n):
        cy, cx = rng.integers(r, h - r), rng.integers(r, w - r)
        msks[i, cy - r: cy + r + 1, cx - r: cx + r + 1] = 1
    return msks


def _stacks():
    rng = np.random.default_rng(3)
    yield "squares", random_stack(rng)
    yield "dense squares", random_stack(rng, n=16)
    yield "ragged", random_stack(rng, n=7, h=33, w=41)
    yield "one neuron", random_stack(rng, n=1, h=16, w=16)
    yield "noise", (rng.random((9, 21, 30)) < 0.2).astype(np.int8)
    yield "touching disks", realistic_neurons(rng, (64, 64), 20)
    yield "float", (rng.random((5, 17, 19)) < 0.3).astype(np.float32)
    yield "bool", rng.random((5, 17, 19)) < 0.3
    yield "at the borders", np.pad(np.ones((2, 3, 3), np.int8),
                                   ((0, 0), (0, 5), (0, 5)))


STACKS = dict(_stacks())


@pytest.mark.parametrize("label", list(STACKS))
def test_stencil_matches_jax_bitwise(label):
    msks = STACKS[label]
    want = np.asarray(jms.mask_summary_stencil(msks))
    got = tms.mask_summary_stencil(msks, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().dtype == want.dtype
    # A tensor is taken as well as an array.
    np.testing.assert_array_equal(
        tms.mask_summary_stencil(torch.from_numpy(np.asarray(msks)),
                                 device="cpu").numpy(), want)


@pytest.mark.parametrize("label", list(STACKS))
def test_id_map_matches_jax_bitwise(label):
    msks = STACKS[label]
    jcover, jid = jms.id_map_from_stack(msks)
    cover, id_map = tms.id_map_from_stack(msks, device="cpu")
    assert cover.dtype == id_map.dtype == torch.int32
    np.testing.assert_array_equal(cover.numpy(), np.asarray(jcover))
    np.testing.assert_array_equal(id_map.numpy(), np.asarray(jid))


def test_stencil_matches_exact_on_separated():
    """With 2 px or more between neurons, the sequential walk and the
    parallel stencil coincide."""
    msks = np.zeros((4, 40, 40), np.int8)
    for i, (cy, cx) in enumerate([(5, 5), (5, 30), (30, 5), (30, 30)]):
        msks[i, cy - 3: cy + 4, cx - 3: cx + 4] = 1
    np.testing.assert_array_equal(
        tms.mask_summary_stencil(msks, device="cpu").numpy(),
        tms.mask_summary_exact(msks))


def test_stencil_close_to_exact_on_random():
    """On touching chains the stencil may delete more than the walk, never
    less, and under 10% of the positive pixels even on stacks far denser
    than a Neurofinder dataset."""
    rng = np.random.default_rng(1)
    total = diff = 0
    for _ in range(10):
        msks = random_stack(rng, n=16)
        ex = tms.mask_summary_exact(msks)
        st = tms.mask_summary_stencil(msks, device="cpu").numpy()
        assert not np.any((st == 1) & (ex == 0))
        total += ex.sum()
        diff += np.abs(ex - st).sum()
    assert diff <= 0.10 * total


def test_stencil_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this pins the behaviour "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tms.mask_summary_stencil(STACKS["squares"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tms.id_map_from_stack(STACKS["squares"])


def test_summarize_mask_stencil_matches_jax(tmp_path):
    ds = make_neurons_hdf5(str(tmp_path / "dataset.hdf5"), shape=(48, 48),
                           nb_frames=4, nb_neurons=6)
    want = jsummary.summarize_mask_stencil(ds)
    got = tsummary.summarize_mask_stencil(ds, device="cpu")
    assert got.dtype == want.dtype == np.float64 and got.sum() > 0
    np.testing.assert_array_equal(got, want)

    # A dataset without masks (a test set): the same KeyError.
    with h5py.File(ds, "a") as fp:
        del fp["masks"]
    for fn in (jsummary.summarize_mask_stencil,
               lambda p: tsummary.summarize_mask_stencil(p, device="cpu"),
               tsummary.summarize_mask):
        with pytest.raises(KeyError, match="no ground-truth masks"):
            fn(ds)
