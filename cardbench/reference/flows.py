"""The plain reference of Cellpose's flow dynamics, in numpy and plain
PyTorch: the Euler steps in float32 as the rule states them (through
``grid_sample``, on any device), the histogram and its seeds, each seed
grown in its own patch and written in order, the flow check's diffusion
in float64 on dense padded tensors (on any device), and the holes filled
by a 4-connected flood written out. It follows the rule
``deepcalcium_torch.ops.flows`` states, step for step, with none of its
code. ``masks_to_flows`` also makes Cellpose's training targets of the
benchmark's calibration."""

import numpy as np
import torch

RPAD = 20
NEIGHBOURS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1),
              (1, -1), (1, 1))


def follow_flows(dP, fg, niter=200, device="cpu"):
    """End points (n, 2) int64 (y, x) of the pixels of ``fg`` (raster
    order) after ``niter`` Euler steps through ``dP * fg / 5``, in float32
    on ``device``; numpy in and out. The step is the rule's own:
    ``p <- clamp(p + grid_sample(flow, p, bilinear, zeros,
    align_corners=False), -1, 1)`` on positions ``2 p / (L - 1) - 1``."""
    h, w = fg.shape
    ys, xs = np.nonzero(fg)
    d = torch.from_numpy(np.asarray(dP, np.float32) * fg / np.float32(5)
                         ).to(device)
    flow = torch.stack([d[1] * (2.0 / (w - 1)), d[0] * (2.0 / (h - 1))])
    px = torch.from_numpy(xs).to(device).float() / (w - 1) * 2 - 1
    py = torch.from_numpy(ys).to(device).float() / (h - 1) * 2 - 1
    grid = torch.stack([px, py], dim=-1)[None, None]
    for _ in range(niter):
        step = torch.nn.functional.grid_sample(flow[None], grid,
                                               align_corners=False)
        grid = (grid + step.permute(0, 2, 3, 1)).clamp(-1, 1)
    x = (grid[0, 0, :, 0] + 1) * 0.5 * (w - 1)
    y = (grid[0, 0, :, 1] + 1) * 0.5 * (h - 1)
    return torch.stack([y, x], dim=1).long().cpu().numpy()


def _maxpool(a, r):
    """Max over each (2r + 1)^2 neighbourhood, nothing beyond the edges."""
    h, w = a.shape
    p = np.pad(a, r, constant_values=-np.inf)
    out = np.full(a.shape, -np.inf)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            out = np.maximum(out, p[dy:dy + h, dx:dx + w])
    return out


def get_masks(p, fg, max_size_fraction=0.4):
    """(H, W) int64 labels from the end points ``p`` of the pixels of
    ``fg``: seeds of the histogram grown in order, each pixel the label at
    its end point, large labels dropped, renumbered by first pixel."""
    h, w = fg.shape
    hist = np.zeros((h + 2 * RPAD, w + 2 * RPAD), np.int64)
    np.add.at(hist, (p[:, 0] + RPAD, p[:, 1] + RPAD), 1)
    hmax = _maxpool(hist.astype(np.float64), 2)
    sy, sx = np.nonzero((hist - hmax > -1e-6) & (hist > 10))
    order = np.argsort(hist[sy, sx], kind="stable")
    seeded = np.zeros(hist.shape, np.int64)
    for k, s in enumerate(order):
        y, x = sy[s], sx[s]
        patch = hist[y - 5:y + 6, x - 5:x + 6] > 2
        m = np.zeros((11, 11), bool)
        m[5, 5] = True
        for _ in range(5):
            m = (_maxpool(m.astype(np.float64), 1) > 0) & patch
        seeded[y - 5:y + 6, x - 5:x + 6][m] = k + 1
    lab = seeded[p[:, 0] + RPAD, p[:, 1] + RPAD]
    sizes = np.bincount(lab, minlength=len(order) + 1)
    big = sizes > max_size_fraction * h * w
    big[0] = False
    lab[big[lab]] = 0
    labels = np.zeros((h, w), np.int64)
    labels[fg] = lab
    uniq, first = np.unique(labels.ravel(), return_index=True)
    renum = np.zeros(uniq.max() + 1 if len(uniq) else 1, np.int64)
    keep = uniq > 0
    ranked = uniq[keep][np.argsort(first[keep], kind="stable")]
    renum[ranked] = np.arange(1, len(ranked) + 1)
    return renum[labels]


def masks_to_flows(labels, device="cpu"):
    """((2, H, W) float64 unit flows, steps): diffusion from each mask's
    pixel nearest its mean for 2 x the largest (rows + 1 + columns + 1) of
    a bounding box steps, each mask pixel the mean of its 3 x 3 pixels of
    the same mask (summed in the order of ``NEIGHBOURS``, then / 9),
    ``log(1 + T)``, central differences, normalised; 0 outside the masks.
    The diffusion runs in float64 on ``device``; numpy in and out."""
    labels = np.asarray(labels, np.int64)
    h, w = labels.shape
    lp = np.pad(labels, 1)
    n = int(labels.max())
    if n == 0:
        return np.zeros((2, h, w)), 0
    ys, xs = np.nonzero(lp)
    lab = lp[ys, xs]
    order = np.argsort(lab, kind="stable")   # raster order within a label
    starts = np.searchsorted(lab[order], np.arange(1, n + 2))
    centres, ext = [], 0
    for a, b in zip(starts[:-1], starts[1:]):
        if a == b:
            continue
        yy, xx = ys[order[a:b]], xs[order[a:b]]
        y0, x0 = yy.min(), xx.min()
        ext = max(ext, (yy.max() - y0 + 2) + (xx.max() - x0 + 2))
        yi, xi = yy - y0, xx - x0
        i = np.argmin((xi - xi.mean()) ** 2 + (yi - yi.mean()) ** 2)
        centres.append((yy[i], xx[i]))
    cy, cx = (torch.from_numpy(v).to(device) for v in np.array(centres).T)
    steps = 2 * int(ext)
    lt = torch.from_numpy(lp).to(device)
    inner = lt[1:-1, 1:-1]
    same = [(lt[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx] == inner).double()
            for dy, dx in NEIGHBOURS]
    inside = inner > 0
    t = torch.zeros(lt.shape, dtype=torch.float64, device=device)
    for _ in range(steps):
        t[cy, cx] += 1
        acc = t[1:-1, 1:-1] * same[0]
        for (dy, dx), s in zip(NEIGHBOURS[1:], same[1:]):
            acc = acc + t[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx] * s
        t[1:-1, 1:-1] = torch.where(inside, acc / 9, t[1:-1, 1:-1])
    t = torch.log(1.0 + t)
    mu = torch.stack([t[2:, 1:-1] - t[:-2, 1:-1], t[1:-1, 2:] - t[1:-1, :-2]])
    mu = mu / (1e-60 + (mu ** 2).sum(dim=0) ** 0.5)
    return (mu * inside).cpu().numpy(), steps


def remove_bad_flow_masks(labels, dP, threshold=0.4, device="cpu"):
    """``labels`` without the masks whose mean squared gap between their
    rebuilt flows and ``dP / 5`` (float32, then float64) exceeds
    ``threshold``."""
    mu, _ = masks_to_flows(labels, device)
    n = int(labels.max())
    net = (np.asarray(dP, np.float32) / np.float32(5)).astype(np.float64)
    cnt = np.maximum(np.bincount(labels.ravel(), minlength=n + 1), 1)
    err = np.zeros(n + 1)
    for c in range(2):
        err += np.bincount(labels.ravel(), ((mu[c] - net[c]) ** 2).ravel(),
                           minlength=n + 1) / cnt
    bad = err > threshold
    bad[0] = False
    return np.where(bad[labels], 0, labels)


def _enclosed(msk):
    """Pixels of a box not in ``msk`` and not 4-connected, outside
    ``msk``, to the box's padding."""
    m = np.pad(msk, 1)
    out = np.zeros(m.shape, bool)
    out[0, :] = out[-1, :] = out[:, 0] = out[:, -1] = True
    while True:
        grow = out.copy()
        grow[1:] |= out[:-1]
        grow[:-1] |= out[1:]
        grow[:, 1:] |= out[:, :-1]
        grow[:, :-1] |= out[:, 1:]
        grow &= ~m
        if (grow == out).all():
            break
        out = grow
    return (~out & ~m)[1:-1, 1:-1]


def fill_and_renumber(labels, min_size=15):
    """Masks under ``min_size`` pixels dropped, each mask's holes filled
    in label order, labels renumbered 1..n; int32."""
    labels = np.array(labels, np.int64)
    sizes = np.bincount(labels.ravel())
    small = sizes < min_size
    small[0] = False
    labels[small[labels]] = 0
    ys, xs = np.nonzero(labels)
    lab = labels[ys, xs]
    boxes = {}
    for v in np.unique(lab):
        yy, xx = ys[lab == v], xs[lab == v]
        boxes[int(v)] = (yy.min(), yy.max() + 1, xx.min(), xx.max() + 1)
    for lab, (y0, y1, x0, x1) in boxes.items():
        part = labels[y0:y1, x0:x1]
        part[_enclosed(part == lab)] = lab
    uniq = np.unique(labels)
    renum = np.zeros(int(uniq.max()) + 1, np.int64)
    renum[uniq[uniq > 0]] = np.arange(1, int((uniq > 0).sum()) + 1)
    return renum[labels].astype(np.int32)


def compute_masks(flows, niter=200, cellprob_threshold=0.0,
                  flow_threshold=0.4, min_size=15, max_size_fraction=0.4,
                  device="cpu"):
    """Host int32 (H, W) labels of blended (3, H, W) flows: dY, dX,
    cellprob; the Euler steps and the diffusion run on ``device``."""
    flows = np.asarray(flows, np.float32)
    dP, fg = flows[:2], flows[2] > cellprob_threshold
    labels = np.zeros(fg.shape, np.int64)
    if fg.any():
        labels = get_masks(follow_flows(dP, fg, niter, device), fg,
                           max_size_fraction)
        if flow_threshold is not None and flow_threshold > 0 and labels.max():
            labels = remove_bad_flow_masks(labels, dP, flow_threshold,
                                           device)
    return fill_and_renumber(labels, min_size)
