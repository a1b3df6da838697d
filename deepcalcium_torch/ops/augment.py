"""Invertible 2-D augmentations (the dihedral group D4) for test-time and
train-time augmentation.

Port of ``deepcalcium_tpu.ops.augment``: the same 8 named (forward, inverse)
pairs in the same order over axes (1, 2) of a (B, H, W) or (B, H, W, C)
tensor, and the same D4 group tables. ``torch.rot90(x, k, dims=(1, 2))`` and
``torch.flip`` follow numpy's (and so JAX's) conventions. TTA runs as one
batched forward: :func:`tta_expand` stacks the 8 views, the net runs once
on them, and :func:`tta_collapse` inverts and averages. Train-time
augmentation composes the reference's random walk over generators into one
D4 element on the host (:func:`compose_random_walk`, numpy only).
"""

import numpy as np
import torch

__all__ = ["AUGMENTATION_NAMES", "INVERTIBLE_2D_AUGMENTATIONS", "D4_TABLE",
           "D4_INVERSE", "GENERATOR_CODES", "tta_expand", "tta_collapse",
           "tta_expand_np", "tta_collapse_np", "apply_d4", "apply_d4_batch",
           "compose_random_walk"]


def _rot90(x, k):
    return torch.rot90(x, k, dims=(1, 2))


def _vflip(x):
    return torch.flip(x, dims=(1,))


def _hflip(x):
    return torch.flip(x, dims=(2,))


INVERTIBLE_2D_AUGMENTATIONS = [
    ("identity", lambda x: x, lambda x: x),
    ("vflip", _vflip, _vflip),
    ("hflip", _hflip, _hflip),
    ("rot90", lambda x: _rot90(x, 1), lambda x: _rot90(x, -1)),
    ("rot180", lambda x: _rot90(x, 2), lambda x: _rot90(x, -2)),
    ("rot270", lambda x: _rot90(x, 3), lambda x: _rot90(x, -3)),
    ("rot90vflip", lambda x: _vflip(_rot90(x, 1)), lambda x: _vflip(_rot90(x, 1))),
    ("rot90hflip", lambda x: _hflip(_rot90(x, 1)), lambda x: _hflip(_rot90(x, 1))),
]

AUGMENTATION_NAMES = [name for name, _, _ in INVERTIBLE_2D_AUGMENTATIONS]

# D4_TABLE[a, b] = code of fwd[a] o fwd[b]; code i is
# INVERTIBLE_2D_AUGMENTATIONS[i]. Copied from the JAX package.
D4_TABLE = np.array(
    [
        [0, 1, 2, 3, 4, 5, 6, 7],
        [1, 0, 4, 6, 2, 7, 3, 5],
        [2, 4, 0, 7, 1, 6, 5, 3],
        [3, 7, 6, 4, 5, 0, 1, 2],
        [4, 2, 1, 5, 0, 3, 7, 6],
        [5, 6, 7, 0, 3, 4, 2, 1],
        [6, 5, 3, 2, 7, 1, 0, 4],
        [7, 3, 5, 1, 6, 2, 4, 0],
    ],
    dtype=np.int32,
)

# D4_INVERSE[a] = code of the inverse of augmentation a.
D4_INVERSE = np.array([0, 1, 2, 5, 4, 3, 6, 7], dtype=np.int32)

# Codes of the 6 train-time generators in the reference's order: identity,
# hflip, vflip, rot90, rot180, rot270.
GENERATOR_CODES = np.array([0, 2, 1, 3, 4, 5], dtype=np.int32)


def tta_expand(batch: torch.Tensor) -> torch.Tensor:
    """All 8 views of a (B, H, W) batch: (8, B, H, W). Needs H == W."""
    return torch.stack([fwd(batch) for _, fwd, _ in INVERTIBLE_2D_AUGMENTATIONS])


def tta_collapse(preds: torch.Tensor) -> torch.Tensor:
    """Invert each of the 8 views and average: (8, B, H, W) -> (B, H, W)."""
    inverted = [inv(preds[i])
                for i, (_, _, inv) in enumerate(INVERTIBLE_2D_AUGMENTATIONS)]
    return torch.stack(inverted).mean(dim=0)


# Host-side twins over numpy arrays, same names, order and axes.
_NP_AUGS = [
    ("identity", lambda x: x, lambda x: x),
    ("vflip", lambda x: np.flip(x, 1), lambda x: np.flip(x, 1)),
    ("hflip", lambda x: np.flip(x, 2), lambda x: np.flip(x, 2)),
    ("rot90", lambda x: np.rot90(x, 1, (1, 2)), lambda x: np.rot90(x, -1, (1, 2))),
    ("rot180", lambda x: np.rot90(x, 2, (1, 2)), lambda x: np.rot90(x, -2, (1, 2))),
    ("rot270", lambda x: np.rot90(x, 3, (1, 2)), lambda x: np.rot90(x, -3, (1, 2))),
    ("rot90vflip", lambda x: np.flip(np.rot90(x, 1, (1, 2)), 1),
     lambda x: np.flip(np.rot90(x, 1, (1, 2)), 1)),
    ("rot90hflip", lambda x: np.flip(np.rot90(x, 1, (1, 2)), 2),
     lambda x: np.flip(np.rot90(x, 1, (1, 2)), 2)),
]


def tta_expand_np(batch):
    """Host-side :func:`tta_expand`: (B, H, W) numpy -> (8, B, H, W)."""
    return np.stack([fwd(batch) for _, fwd, _ in _NP_AUGS])


def tta_collapse_np(preds):
    """Host-side :func:`tta_collapse`: (8, B, H, W) numpy -> (B, H, W)."""
    inverted = [inv(preds[i]) for i, (_, _, inv) in enumerate(_NP_AUGS)]
    return np.mean(np.stack(inverted), axis=0)


def apply_d4(img2d: torch.Tensor, code) -> torch.Tensor:
    """Apply D4 element ``code`` to one (H, W) image on its device."""
    return INVERTIBLE_2D_AUGMENTATIONS[int(code)][1](img2d[None])[0]


def apply_d4_batch(batch: torch.Tensor, codes) -> torch.Tensor:
    """Apply a per-sample D4 element: (B, H, W), (B,) ints -> (B, H, W)."""
    return torch.stack([apply_d4(img, code)
                        for img, code in zip(batch, codes)])


def compose_random_walk(rng: np.random.Generator, nb_max_augment: int) -> int:
    """The reference's train-time augmentation walk as ONE D4 code: draw
    ``k ~ U{0..nb_max_augment}`` generators and compose them in the group
    table, each applied after the composite so far. Same draws from ``rng``
    as the JAX package's ``compose_random_walk``."""
    k = int(rng.integers(0, nb_max_augment + 1))
    code = 0
    for _ in range(k):
        g = GENERATOR_CODES[int(rng.integers(0, len(GENERATOR_CODES)))]
        code = int(D4_TABLE[g, code])
    return code
