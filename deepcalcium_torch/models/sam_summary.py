"""SamSummary: Segment Anything's automatic mask generator on the mean image
of a calcium movie, from a movie to instance masks, as a lab points SAM (or
micro-sam's models of the same architecture) at a session's mean image to
find neuron candidates.

``evaluate_movie`` has the shape of ``CellposeSummary.evaluate_movie``: the
mean image by kernel K1, Cellpose's percentile normalisation clipped to
[0, 1] and rounded to 8-bit values, in three channels, resized so that its
longer side is the encoder's 1,024 (bilinear, antialiased) and normalised
by SAM's pixel mean and std; the encoder
(:mod:`deepcalcium_torch.models.sam`) once, then the mask decoder on a 32 x
32 grid of point prompts in batches of 64, three masks each; the masks
resized to the image; the generator's filters on predicted IoU and
stability, boxes, box NMS on the card, and a label image
(:mod:`deepcalcium_torch.ops.amg`). The net is built on the card once, at
construction; every call reuses it.
"""

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from deepcalcium_torch.models import sam
from deepcalcium_torch.models.cellpose_summary import normalize99
from deepcalcium_torch.ops import amg
from deepcalcium_torch.ops.attention import attention_qkv_cuda
from deepcalcium_torch.ops.summary import movie_summary_fast
from deepcalcium_torch.train.evaluate import _streaming_mean
from deepcalcium_torch.utils import profiling
from deepcalcium_torch.utils.device import require_cuda
from deepcalcium_torch.utils.profiling import count, span

__all__ = ["SamSummary", "SamMasks", "sam_image"]


class SamMasks(NamedTuple):
    """What ``SamSummary.evaluate_movie`` returns. The kept masks are
    ordered by area, largest first: ``labels`` holds mask i as i + 1.
    Predictions are numbered prompt by prompt, three masks a prompt."""
    labels: np.ndarray          # (H, W) int32
    masks: torch.Tensor         # (n, H, W) bool, on the net's device
    scores: np.ndarray          # (n,) float32 predicted IoU
    boxes: np.ndarray           # (n, 4) int64 XYXY, inclusive
    keep: np.ndarray            # (n,) the kept masks' prediction numbers
    candidates: np.ndarray      # predictions past both filters, ascending
    candidate_boxes: np.ndarray  # their boxes, what NMS was given
    iou_preds: np.ndarray       # (3 P,) float32
    stability: np.ndarray       # (3 P,) float32
    embedding: torch.Tensor     # (1, 256, 64, 64), the compute dtype
    low_res: torch.Tensor       # (P, 3, 256, 256) logits, the compute dtype


def sam_image(mean: torch.Tensor, cfg) -> tuple:
    """(the (1, 3, S, S) float32 encoder input, the resized (h, w)) of a
    float32 (H, W) mean image: ``normalize99`` clipped to [0, 1], times
    255, rounded, in three channels, resized (longer side S, bilinear,
    antialiased), normalised by the pixel mean and std, padded to S x S."""
    img = torch.round(normalize99(mean).clamp(0, 1) * 255)
    size = amg.preprocess_shape(*img.shape, cfg.image_size)
    x = F.interpolate(img.expand(1, 3, *img.shape), size, mode="bilinear",
                      align_corners=False, antialias=True)
    pm = torch.tensor(cfg.pixel_mean, device=x.device)[:, None, None]
    ps = torch.tensor(cfg.pixel_std, device=x.device)[:, None, None]
    x = (x - pm) / ps
    s = cfg.image_size
    return F.pad(x, (0, s - size[1], 0, s - size[0])), size


class SamSummary:
    """Segment Anything's automatic mask generation on the mean image of a
    movie.

    # Arguments
        model_path: a SAM state dict saved by ``torch.save`` (the published
            ``sam_vit_h_4b8939.pth``); or pass ``params``.
        params: the state dict (tensors or arrays) by the published key
            names.
        config: the widths, a :class:`sam.Config` or a dict; SAM ViT-H's
            published ones by default.
        compute_dtype: the net's compute dtype (bfloat16 by default); None
            = float32.
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
                raise ValueError("need model_path or params: no SAM weights "
                                 "are downloaded")
            params = torch.load(model_path, map_location="cpu",
                                weights_only=True)
        if isinstance(config, dict):
            config = sam.Config.from_dict(config)
        self.config = config or sam.Config()
        with span("sam.build"):
            self.net = sam.inference_net(params, self.config, compute_dtype,
                                         self.device)

    @contextlib.contextmanager
    def _stage(self, name, timed):
        """The span ``name``. While spans record, the stage's time is also
        appended to ``timed`` as a function of no arguments: on a card the
        time between two CUDA events around its work, which nothing waits
        for, so that a traced call runs the untraced call's program; on
        the CPU, whose work is done when it is queued, the span's own."""
        with span(name):
            if not profiling.recording():
                yield
            elif self.device.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                yield
                end.record()

                def ms():
                    end.synchronize()
                    return start.elapsed_time(end)

                timed.append((name, ms))
            else:
                t = time.perf_counter()
                yield
                host_ms = (time.perf_counter() - t) * 1e3
                timed.append((name, lambda: host_ms))

    @torch.no_grad()
    def evaluate_movie(self, movie) -> SamMasks:
        """Segment a raw (T, H, W) movie into instances: a tensor or an
        array is copied to the device whole and summarised by K1; an open
        dataset (an HDF5 ``series/raw``) is folded 256 frames at a time.
        The prompt grid and the thresholds are the config's, SAM's
        ``SamAutomaticMaskGenerator`` defaults (one crop, no small-region
        removal). In a traced call each stage's time on the device is
        counted as ``<stage>.device_ms`` once the call has ended."""
        cfg, timed = self.config, []
        per_batch = cfg.points_per_batch
        with span("evaluate_movie"):
            held = isinstance(movie, (np.ndarray, torch.Tensor))
            if held:
                with span("evaluate_movie.upload"):
                    if isinstance(movie, np.ndarray):
                        movie = torch.from_numpy(np.ascontiguousarray(movie))
                    movie = movie.to(self.device)
            with self._stage("sam.summary", timed):
                if held:
                    mean, _ = movie_summary_fast(movie)
                else:
                    # An open dataset, sliced lazily: never held whole.
                    mean = torch.from_numpy(_streaming_mean(
                        movie, 256, self.device)).to(self.device)
                x, size = sam_image(mean, cfg)
            hw = tuple(mean.shape)
            with self._stage("sam.encoder", timed):
                launched = attention_qkv_cuda.launches
                emb = self.net.encode(x)
            count("sam.attn_launches", attention_qkv_cuda.launches - launched)
            pts = torch.from_numpy(amg.prompt_points(
                cfg.points_per_side, *hw, cfg.image_size)).to(self.device)
            with self._stage("sam.decoder", timed):
                low, iou = [], []
                for i in range(0, pts.shape[0], per_batch):
                    sparse = self.net.embed_points(pts[i:i + per_batch])
                    m, q = self.net.decode(emb, sparse)
                    low.append(m)
                    iou.append(q)
                low, iou = torch.cat(low), torch.cat(iou).float().flatten()
            count("sam.prompts", pts.shape[0])
            count("sam.decoder_batches", len(range(0, pts.shape[0],
                                                   per_batch)))
            count("sam.masks", iou.numel())
            with self._stage("sam.postprocess", timed):
                k = low.shape[1]
                masks = torch.empty((low.shape[0] * k,) + hw,
                                    dtype=torch.bool, device=self.device)
                stab = torch.empty_like(iou)
                for i in range(0, low.shape[0], per_batch):
                    up = amg.postprocess_masks(
                        low[i:i + per_batch], size, hw,
                        cfg.image_size).flatten(0, 1)
                    j = slice(k * i, k * i + up.shape[0])
                    stab[j] = amg.stability_score(
                        up, cfg.mask_threshold, cfg.stability_score_offset)
                    masks[j] = up > cfg.mask_threshold
                iou_kept = iou > cfg.pred_iou_thresh
                passed = iou_kept & (stab >= cfg.stability_score_thresh)
                cand = torch.nonzero(passed).flatten()
                cand_boxes = amg.mask_to_box(masks[cand])
            count("sam.masks_stable_kept", cand.numel())
            with self._stage("sam.nms", timed):
                pos = amg.box_nms(cand_boxes, iou[cand], cfg.box_nms_thresh)
            count("sam.masks_nms_kept", pos.numel())
            with self._stage("sam.labels", timed):
                kept_masks = masks[cand[pos]]
                labels, order = amg.paint_labels(kept_masks)
                pos, kept_masks = pos[order], kept_masks[order]
            with span("evaluate_movie.fetch"):
                kept = cand[pos]
                got = SamMasks(
                    labels=labels.cpu().numpy(), masks=kept_masks,
                    scores=iou[kept].cpu().numpy(),
                    boxes=cand_boxes[pos].cpu().numpy(),
                    keep=kept.cpu().numpy(), candidates=cand.cpu().numpy(),
                    candidate_boxes=cand_boxes.cpu().numpy(),
                    iou_preds=iou.cpu().numpy(), stability=stab.cpu().numpy(),
                    embedding=emb, low_res=low)
            # Read once the call has ended, so that a traced call waits for
            # nothing an untraced one does not.
            count("sam.masks_iou_kept", iou_kept.sum())
            for name, ms in timed:
                count(name + ".device_ms", ms())
            return got
