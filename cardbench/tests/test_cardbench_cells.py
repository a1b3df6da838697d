"""Each cell rehearsed on the CPU at a tiny size (``tiny.py``): its
set-up, a short window through the wrappers' own entry points, and the
comparison with the reference, which a sound run passes; then the same run
with the timed path broken underneath, once for each fault the cell can
have, which the comparison has to catch."""

import pytest
import torch

from cardbench.tests.tiny import run_tiny

CELLS = ["nf-evaluate-card", "spikes-fit", "nf-fit", "spikes-predict"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, _ = run_tiny(cell)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0
    assert "setup_s" in result["metrics"]
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("cell", ["nf-evaluate-card", "spikes-predict"])
def test_traced_run_reads_the_window(cell):
    result, _ = run_tiny(cell, traced=True)
    assert result["correct"]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _evaluate_altered(monkeypatch):
    """An answer altered where it is produced: one row of the probability
    map and the mask inverted."""
    from deepcalcium_torch.models import unet_2d_summary as mod

    real = mod.make_movie_evaluator

    def make(*a, **k):
        ev = real(*a, **k)

        def evaluate(movie):
            mask, prob, mean = ev(movie)
            mask, prob = mask.clone(), prob.clone()
            r = prob.shape[0] // 2
            prob[r] = 1.0 - prob[r]
            mask[r] = 1 - mask[r]
            return mask, prob, mean

        return evaluate

    monkeypatch.setattr(mod, "make_movie_evaluator", make)


def _evaluate_half_views(monkeypatch):
    """Half of the batch of views left out, the mean taken over the rest."""
    from deepcalcium_torch.train import evaluate as mod

    real = mod.tta_collapse
    monkeypatch.setattr(mod, "tta_collapse", lambda p: real(
        torch.cat([p[:4], p[:4]])))


def _fit_unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _fit_half_batch(monkeypatch):
    """Half of the batch left out of the loss, the mean taken over the
    rest."""
    from deepcalcium_torch.ops import losses as L

    bce, wbce = L.binary_crossentropy, L.weighted_binary_crossentropy
    half = lambda yt: yt.shape[0] // 2  # noqa: E731
    monkeypatch.setitem(L.LOSSES, "binary_crossentropy",
                        lambda yt, yp: bce(yt[:half(yt)], yp[:half(yt)]))
    monkeypatch.setattr(L, "weighted_binary_crossentropy",
                        lambda yt, yp, **k: wbce(yt[:half(yt)], yp[:half(yt)],
                                                 **k))


def _predict_altered(monkeypatch):
    """An answer altered where it is produced: one trace's probabilities
    inverted."""
    from deepcalcium_torch.models import unet_1d_segmentation as mod

    real = mod._run_batched

    def run(*a, **k):
        out = real(*a, **k).clone()
        out[0] = 1.0 - out[0]
        return out

    monkeypatch.setattr(mod, "_run_batched", run)


def _predict_half_rows(monkeypatch):
    """Half of the batch left out: the second half of the traces never
    predicted."""
    from deepcalcium_torch.models import unet_1d_segmentation as mod

    real = mod._run_batched

    def run(fwd, batch, *a, **k):
        out = real(fwd, batch, *a, **k).clone()
        out[out.shape[0] // 2:] = 0.0
        return out

    monkeypatch.setattr(mod, "_run_batched", run)


FAULTS = [
    ("nf-evaluate-card", _evaluate_altered),
    ("nf-evaluate-card", _evaluate_half_views),
    ("spikes-fit", _fit_unchanged),
    ("spikes-fit", _fit_half_batch),
    ("nf-fit", _fit_unchanged),
    ("nf-fit", _fit_half_batch),
    ("spikes-predict", _predict_altered),
    ("spikes-predict", _predict_half_rows),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_caught(cell, fault, monkeypatch):
    """The fault is planted after set-up, so that it breaks the timed path
    alone."""
    def patch(entry):
        real_setup = entry.setup

        def setup():
            real_setup()
            fault(monkeypatch)

        entry.setup = setup

    result, _ = run_tiny(cell, patch=patch)
    assert not result["correct"], result["compared"]
