"""CellposeSummary: Cellpose-SAM on the mean image of a calcium movie, as
Suite2p's anatomical detection hands it to Cellpose, from a movie to
instance labels.

``evaluate_movie`` has the shape of ``UNet2DSummary.evaluate_movie``: the
mean image by kernel K1, Cellpose's percentile normalisation into channel 0
(channels 1 and 2 zero, as Cellpose pads a one-channel image), the net
(:mod:`deepcalcium_torch.models.cellpose_sam`) on overlapping 256 x 256
tiles blended by Cellpose's taper, and Cellpose's flow dynamics
(:mod:`deepcalcium_torch.ops.flows`). The net is built on the card once,
at construction; every call reuses it.
"""

import math

import numpy as np
import torch

from deepcalcium_torch.models import cellpose_sam
from deepcalcium_torch.ops import flows
from deepcalcium_torch.ops.attention import attention_qkv_cuda
from deepcalcium_torch.ops.summary import movie_summary_fast
from deepcalcium_torch.train.evaluate import _streaming_mean
from deepcalcium_torch.utils.device import require_cuda
from deepcalcium_torch.utils.profiling import count, span

__all__ = ["CellposeSummary", "tile_starts", "taper", "normalize99"]


def tile_starts(side: int, tile: int = 256, overlap: float = 0.1) -> list:
    """Cellpose's tile starts along one axis: one tile if the side fits,
    else ``ceil((1 + 2 overlap) side / tile)`` tiles spread evenly from 0
    to ``side - tile``, truncated to int."""
    if side < tile:
        raise ValueError(f"a side of {side} px is smaller than the "
                         f"{tile} px tile")
    n = 1 if side <= tile else int(math.ceil((1 + 2 * overlap) * side / tile))
    return [int(s) for s in np.linspace(0, side - tile, n)]


def taper(tile: int = 256, sig: float = 7.5) -> np.ndarray:
    """Cellpose's (tile, tile) float32 tile weight ``w(y) w(x)``, with
    ``w(t) = 1 / (1 + exp((|t - c| - (b / 2 - 20)) / sig))`` on an axis of
    ``b = max(224, tile)`` centred on the tile."""
    b = max(224, tile)
    t = np.arange(b)
    w = 1 / (1 + np.exp((np.abs(t - t.mean()) - (b / 2 - 20)) / sig))
    w = (w * w[:, None])[b // 2 - tile // 2:b // 2 + tile // 2 + tile % 2,
                         b // 2 - tile // 2:b // 2 + tile // 2 + tile % 2]
    return w.astype(np.float32)


def normalize99(img: torch.Tensor) -> torch.Tensor:
    """``(img - p1) / (p99 - p1)`` with the 1st and 99th percentiles
    (linear interpolation, as ``np.percentile``); an image without range
    stays as it is."""
    p1, p99 = torch.quantile(img.reshape(-1).float(),
                             torch.tensor([0.01, 0.99], device=img.device))
    if float(p99 - p1) <= 0:
        return img
    return (img - p1) / (p99 - p1)


class CellposeSummary:
    """Cellpose-SAM segmentation of the mean image of a movie.

    # Arguments
        model_path: a Cellpose-SAM state dict saved by ``torch.save`` (the
            published ``cpsam`` file); or pass ``params``.
        params: the state dict (tensors or arrays) by the published key
            names.
        config: the widths, a :class:`cellpose_sam.Config` or a dict;
            Cellpose-SAM's published ones by default.
        compute_dtype: the net's compute dtype (bfloat16, as Cellpose 4
            runs by default); None = float32.
        device: "cuda" by default, which raises without a card; "cpu" on
            purpose.
    """

    def __init__(self, model_path=None, params=None, config=None,
                 compute_dtype=torch.bfloat16, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            require_cuda()
        if params is None:
            if model_path is None:
                raise ValueError("need model_path or params: no Cellpose-SAM "
                                 "weights are downloaded")
            params = torch.load(model_path, map_location="cpu",
                                weights_only=True)
        if isinstance(config, dict):
            config = cellpose_sam.Config.from_dict(config)
        self.config = config or cellpose_sam.Config()
        with span("cellpose.build"):
            self.net = cellpose_sam.inference_net(
                params, self.config, compute_dtype, self.device)
        self._taper = torch.from_numpy(taper(self.config.tile)).to(
            self.device)
        # batch size -> (graph, its input, its output, attention launches)
        self._graphs = {}

    def _forward(self, x):
        """The net on a batch of tiles. On a card, each batch size runs as
        one CUDA graph, captured at its first call (a call before the
        capture warms the kernels' plans and builds or loads the kernel
        library on a side stream) and replayed after: a tile's forward launches
        some 400 kernels, whose host time would exceed the card's at a
        batch of one. Each forward counts the attention kernel's launches
        it ran (``cellpose.attn_launches``): those its graph's capture
        recorded, none on the CPU."""
        if self.device.type != "cuda":
            count("cellpose.attn_launches", 0)
            return self.net(x)
        held = self._graphs.get(x.shape[0])
        if held is None:
            x_in = x.clone()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.net(x_in)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            launched = attention_qkv_cuda.launches
            with torch.cuda.graph(graph):
                y_out = self.net(x_in)
            held = self._graphs[x.shape[0]] = (
                graph, x_in, y_out, attention_qkv_cuda.launches - launched)
        graph, x_in, y_out, launches = held
        x_in.copy_(x)
        graph.replay()
        count("cellpose.attn_launches", launches)
        return y_out

    def _flows(self, img, tile_overlap, batch_size):
        """The blended (3, H, W) float32 net output of the normalised (H, W)
        image, and the number of tiles."""
        tile = self.config.tile
        h, w = img.shape
        ys = tile_starts(h, tile, tile_overlap)
        xs = tile_starts(w, tile, tile_overlap)
        corners = [(y, x) for y in ys for x in xs]
        x3 = torch.zeros((len(corners), 3, tile, tile), dtype=torch.float32,
                         device=self.device)
        for i, (y, x) in enumerate(corners):
            x3[i, 0] = img[y:y + tile, x:x + tile]
        out = torch.empty_like(x3)
        for i in range(0, len(corners), batch_size):
            out[i:i + batch_size] = self._forward(x3[i:i + batch_size])
        acc = torch.zeros((3, h, w), dtype=torch.float32, device=self.device)
        norm = torch.zeros((h, w), dtype=torch.float32, device=self.device)
        for i, (y, x) in enumerate(corners):
            acc[:, y:y + tile, x:x + tile] += out[i] * self._taper
            norm[y:y + tile, x:x + tile] += self._taper
        return acc / norm, len(corners)

    @torch.no_grad()
    def evaluate_movie(self, movie, tile=None, tile_overlap=0.1, batch_size=8,
                       niter=200, cellprob_threshold=0.0, flow_threshold=0.4,
                       min_size=15, max_size_fraction=0.4):
        """Segment a raw (T, H, W) movie into instances: a tensor or an
        array is copied to the device whole and summarised by K1; an open
        dataset (an HDF5 ``series/raw``) is folded 256 frames at a time.

        ``tile`` is the net's (256 for the published net); the other
        arguments are Cellpose 4's ``eval`` defaults.

        # Returns
            (labels int32 (H, W), flows float32 (3, H, W): dY, dX and
            cellprob after blending), host numpy arrays.
        """
        if tile not in (None, self.config.tile):
            raise ValueError(f"tile {tile}: the net was built for "
                             f"{self.config.tile} px tiles")
        with span("evaluate_movie"):
            held = isinstance(movie, (np.ndarray, torch.Tensor))
            if held:
                with span("evaluate_movie.upload"):
                    if isinstance(movie, np.ndarray):
                        movie = torch.from_numpy(np.ascontiguousarray(movie))
                    movie = movie.to(self.device)
            with span("cellpose.summary"):
                if held:
                    mean, _ = movie_summary_fast(movie)
                else:
                    # An open dataset, sliced lazily: never held whole.
                    mean = torch.from_numpy(_streaming_mean(
                        movie, 256, self.device)).to(self.device)
                img = normalize99(mean)
            with span("cellpose.net"):
                fl, n_tiles = self._flows(img, tile_overlap, batch_size)
                inds = torch.nonzero(fl[2] > cellprob_threshold)
            count("cellpose.tiles", n_tiles)
            count("cellpose.fg_px", inds.shape[0])
            with span("cellpose.dynamics"):
                labels = flows.compute_masks(
                    fl[:2], inds, niter=niter,
                    flow_threshold=flow_threshold, min_size=min_size,
                    max_size_fraction=max_size_fraction)
            with span("evaluate_movie.fetch"):
                return labels, fl.cpu().numpy()
