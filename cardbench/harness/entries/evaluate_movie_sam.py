"""``SamSummary.evaluate_movie`` in a closed loop with one caller: a movie
on the card to Segment Anything's automatic masks of its mean image, one
movie after another, as a lab runs SAM's (or micro-sam's) automatic mask
generator on the mean image of every recording.

Set-up makes the pool of ``evaluate_movie``'s cell (the traffic's lengths
and neuron counts, in an order and with a content of the seed's), the
weights (random from the seed, a few calibrated, below) and the
wrapper, which builds the net on the card once; it warms every movie once.
The window calls ``evaluate_movie(movie)`` on the pool in an order of the
seed's in which no movie follows itself, until ``seconds`` have passed.
It keeps every call's host outputs, and the card's (the embedding, the
low-resolution logits, the kept masks) of each call whose predicted IoUs
differ from those of every call of its movie kept before.

Random weights leave the generator's filters arbitrary and its masks
spread over the whole frame, so the IoU head's last bias and the
hypernetworks' last layers are calibrated on the float32 reference's
predictions for the pool's first movie (the config's ``calibration``): the
IoU bias so that ``iou_pass`` of the predictions exceed the IoU threshold;
the hypernetworks' last layers mapped linearly so that each mask's logits
lose their mean over the upscaled map and a shift ``beta`` (through the
channel weights whose sum of the map is nearest 1 at every pixel), with
``beta`` such that the median mask covers ``coverage`` of the frame; then
those layers scaled (the logits' scale) so that ``stable_pass`` of the
masks reach the stability threshold. NMS then sees hundreds of boxes of
many sizes, as it does on real images.

The comparison holds each distinct call against the float32 reference
(``reference/sam.py``) on the same movie: ``embed_gap`` and
``embed_rms_gap`` (the largest and the root-mean-square embedding
difference, over the reference embedding's std), ``logit_gap``
and ``iou_gap`` (the largest gaps of the low-resolution logits and
predicted IoUs), ``keep_unexplained`` (predictions whose passing of both
filters differs where the reference is certain: its IoU farther than the
``iou_gap`` limit from the threshold, and its stability on the same side
of the threshold for every shift of its logits by up to the ``logit_gap``
limit), ``mask_unexplained`` (pixels of the kept masks that differ from
the sign of the reference's resized logits where those lie farther than
the ``logit_gap`` limit from 0), ``nms_gap`` (masks kept by the call but
not by the reference's NMS on the call's own boxes and scores, or the
other way round, plus kept masks whose boxes differ from the reference's
boxes of them) and ``labels_gap`` (pixels of the label image that differ
from the reference's painting of the call's kept masks)."""

import time

import numpy as np
import torch

from cardbench.harness import synth
from cardbench.harness.entries.evaluate_movie import call_order
from cardbench.reference import sam as ref
from cardbench.reference.precision import QUANT, exact_fp32
from cardbench.reference.unet2ds import movie_mean

LN_KEYS = ("image_encoder.neck.1", "image_encoder.neck.3",
           "mask_decoder.output_upscaling.1")
EMBED_KEYS = ("point_embeddings", "not_a_point_embed", "no_mask_embed",
              "iou_token", "mask_tokens", "positional_encoding_gaussian")
HYPER_LAST = "layers.2."
IOU_BIAS = "mask_decoder.iou_prediction_head.layers.2.bias"
FLOATS = ("scores", "iou_preds", "stability")


def make_weights(cfg, seed, device):
    """The published state dict's float32 tensors that the forward reads,
    on ``device``, from the seed: kernels N(0, 1/fan_in) clipped at 2
    sigma (a transposed conv's fan_in its input channels), the encoder's
    ``attn.proj`` and ``mlp.lin2`` scaled by 1/sqrt(2 depth), biases and
    the positional table N(0, 0.02), the tables N(0, the config's
    ``init_std``) (SAM's own are zeros, which leave the bias unexercised),
    LayerNorms 1 + N(0, 0.1) and N(0, 0.1), the embeddings and the Fourier
    matrix N(0, 1) (clipped too); the transposed convs' kernels the same
    at each of their 2 x 2 positions."""
    shapes = ref.leaves(cfg)
    total = sum(int(np.prod(s)) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    scale_out = (2 * cfg["depth"]) ** -0.5
    std = cfg["init_std"]
    W, i = {}, 0
    for key, shape in shapes:
        n = int(np.prod(shape))
        v = z[i:i + n].view(shape)
        i += n
        if ".norm" in key or key.startswith(LN_KEYS):
            v = v * 0.1 + (1.0 if key.endswith("weight") else 0.0)
        elif "rel_pos" in key:
            block = int(key.split(".")[2])
            v = v * std["rel_pos_global" if block in cfg["global_blocks"]
                        else "rel_pos_window"]
        elif any(k in key for k in EMBED_KEYS):
            v = v.clone()
        elif "pos_embed" in key or key.endswith("bias"):
            v = v * 0.02
        elif "output_upscaling" in key:
            # One 2 x 2 position drawn and copied to the other three: with
            # four drawn independently, the masks are one 4 x 4 texture
            # repeated over the frame.
            v = v[..., :1, :1].expand(shape) * shape[0] ** -0.5
        else:
            v = v * (np.prod(shape[1:]) ** -0.5)
            if key.startswith("image_encoder") and key.endswith(
                    ("attn.proj.weight", "mlp.lin2.weight")):
                v = v * scale_out
        W[key] = v.contiguous()
    return W


def _stable_share(masks, scale, cfg):
    """The share of the masks of float32 logits that reach the stability
    threshold with their logits times ``scale``."""
    a = cfg["amg"]
    off = a["stability_score_offset"] / scale
    thr = a["mask_threshold"] / scale
    hi = (masks > thr + off).sum((-1, -2))
    lo = (masks > thr - off).sum((-1, -2))
    return float(((hi / lo) >= a["stability_score_thresh"]).float().mean())


class Entry:
    def __init__(self, config, traffic, seed, device, seconds):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.counts = {}

    def setup(self):
        from deepcalcium_torch.models.sam_summary import SamSummary

        cfg, tr, dev = self.config, self.traffic, self.device
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        lengths = synth.spread(tr["lengths"], rng)
        neurons = synth.spread(tr["neurons"], rng)
        self.movies = []
        for t, n in zip(lengths, neurons):
            masks = synth.neuron_masks(rng, tr["frame"], n)
            self.movies.append(synth.calcium_movie(masks, t, gen, dev))
        self.W = make_weights(cfg, self.seed, dev)
        self._embeddings = {}
        self._calibrate()
        self.wrapper = SamSummary(
            params={k: v.cpu().numpy() for k, v in self.W.items()},
            config=cfg, compute_dtype=getattr(torch, cfg["compute_dtype"]),
            device=dev)
        self.order = call_order(len(self.movies), rng)
        for i in range(len(self.movies)):
            self._call(i)

    def _reference_embedding(self, i, quant=None):
        """The float32 reference's image, resized size and embedding of
        pool movie ``i`` (kept for the exact reference)."""
        if quant is None and i in self._embeddings:
            return self._embeddings[i]
        with torch.no_grad(), exact_fp32():
            x, size = ref.image(movie_mean(self.movies[i]), self.config)
            got = (size, ref.encoder(self.W, x, self.config, quant))
        if quant is None:
            self._embeddings[i] = got
        return got

    def _reference_batches(self, i, quant=None):
        """Per batch of prompts of pool movie ``i``: (its slice of the
        predictions, the reference's low-resolution logits, its IoUs
        flattened, its logits resized to the frame, flattened)."""
        cfg, a = self.config, self.config["amg"]
        size, emb = self._reference_embedding(i, quant)
        hw = tuple(self.movies[i].shape[1:])
        pts = ref.prompt_points(cfg, *hw)
        with torch.no_grad(), exact_fp32():
            pe = ref.image_pe(self.W, cfg)
            for s in range(0, len(pts), a["points_per_batch"]):
                sparse = ref.sparse_embeddings(
                    self.W, pts[s:s + a["points_per_batch"]], cfg)
                low, iou = ref.decoder(self.W, emb, sparse, cfg, quant, pe)
                up = ref.postprocess(low, size, hw, cfg).flatten(0, 1)
                yield slice(3 * s, 3 * s + up.shape[0]), low, iou.flatten(), up

    def _calibrate(self):
        """The IoU head's last bias and the hypernetworks' last layers set
        from the reference's predictions for pool movie 0: the IoU bias
        first, then the masks' offset and threshold, then their scale (each
        changes nothing the earlier ones measured)."""
        cfg, a, c = self.config, self.config["amg"], self.config["calibration"]
        _, emb = self._reference_embedding(0)
        pts = ref.prompt_points(cfg, *self.movies[0].shape[1:])
        ious, logits, along = [], [], []
        with torch.no_grad(), exact_fp32():
            pe = ref.image_pe(self.W, cfg)
            for s in range(0, len(pts), a["points_per_batch"]):
                sparse = ref.sparse_embeddings(
                    self.W, pts[s:s + a["points_per_batch"]], cfg)
                queries, up = ref.decoder_features(self.W, emb, sparse, cfg,
                                                   None, pe)
                if not along:
                    # The upscaled map's mean channel vector, and the
                    # channel weights whose sum of the map is nearest 1 at
                    # every pixel (least squares, a ridge of 1e-6 of the
                    # Gram's mean diagonal), on the first batch.
                    u = up.transpose(0, 1).flatten(1).double()
                    mean_u = u.mean(1).float()
                    gram = u @ u.T
                    gram += torch.eye(len(gram), dtype=gram.dtype,
                                      device=gram.device) * (
                        1e-6 * gram.diagonal().mean())
                    flat = torch.linalg.solve(gram, u.sum(1)).float()
                hyper = ref.hypernetworks(self.W, queries, cfg)[:, 1:]
                low, iou = ref.decoder_heads(self.W, queries, up, cfg)
                g = torch.einsum("c,pchw->phw", flat, up).flatten(1)[:, None]
                ious.append(iou.flatten())
                # Each mask's logits less its mean over the map.
                logits.append(low.flatten(2) - (hyper @ mean_u)[..., None] * g)
                along.append(g)
        ious, logits, along = torch.cat(ious), torch.cat(logits), torch.cat(
            along)
        shift = a["pred_iou_thresh"] - float(torch.quantile(ious,
                                                            1 - c["iou_pass"]))
        self.W[IOU_BIAS] = (self.W[IOU_BIAS] + shift).contiguous()
        lo, hi = 0.0, float(logits.abs().max())
        for _ in range(50):
            beta = (lo + hi) / 2
            share = ((logits - beta * along) > a["mask_threshold"]).float()
            if float(share.mean(-1).median()) > c["coverage"]:
                lo = beta
            else:
                hi = beta
        beta = hi
        diag = {"flat_sum_min": float(along.min()),
                "flat_sum_max": float(along.max())}
        del logits, along
        # hyper -> hyper - flat (mean_u . hyper) - beta flat: the logits
        # less their mean and beta, about, at every pixel.
        center = torch.eye(len(flat), device=flat.device) - torch.outer(
            flat, mean_u)
        for k in range(cfg["multimask_outputs"] + 1):
            key = f"mask_decoder.output_hypernetworks_mlps.{k}.{HYPER_LAST}"
            self.W[key + "weight"] = (center @ self.W[key + "weight"]
                                      ).contiguous()
            self.W[key + "bias"] = (center @ self.W[key + "bias"]
                                    - beta * flat).contiguous()
        ups = torch.cat([up for _, _, _, up in self._reference_batches(0)])
        lo, hi = -3.0, 6.0          # log10 of the scale
        for _ in range(40):
            mid = (lo + hi) / 2
            if _stable_share(ups, 10 ** mid, cfg) < c["stable_pass"]:
                lo = mid
            else:
                hi = mid
        scale = 10 ** hi
        for k in list(self.W):
            if "output_hypernetworks_mlps" in k and HYPER_LAST in k:
                self.W[k] = (self.W[k] * scale).contiguous()
        covered = (ups > a["mask_threshold"]).float().mean((-1, -2))
        self.calibration = {
            "iou_bias_shift": shift, "hyper_shift": beta,
            "hyper_scale": scale, "coverage_median": float(covered.median()),
            "empty_share": float((covered == 0).float().mean()),
            "stable_share": _stable_share(ups, scale, cfg), **diag}

    def _call(self, i):
        return self.wrapper.evaluate_movie(self.movies[i])

    def window(self, seconds, spans):
        self.outputs, self.kept, lat = [], [], []
        t0 = time.perf_counter()
        while True:
            i = next(self.order)
            t = time.perf_counter()
            with spans("evaluate_movie"):
                res = self._call(i)
            lat.append(time.perf_counter() - t)
            if not any(j == i and np.array_equal(r.iou_preds, res.iou_preds,
                                                 equal_nan=True)
                       for j, r in self.kept):
                self.kept.append((i, res))
            self.outputs.append((i, res._replace(masks=None, embedding=None,
                                                 low_res=None)))
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        n = len(lat)
        a = self.config["amg"]
        self.counts = {"calls": n, "window_s": window_s,
                       "frames": [self.movies[i].shape[0]
                                  for i, _ in self.outputs],
                       "frame_hw": list(self.traffic["frame"]),
                       "prompts": n * a["points_per_side"] ** 2}
        return {"movie_ms": window_s * 1e3 / n,
                "movie_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def release(self):
        self.wrapper = None

    def compare(self):
        """Every distinct call against the reference: each call is held as
        the kept call of its movie whose host outputs equal its own, or
        else counted whole in ``keep_unexplained``."""
        nums = {"embed_gap": 0.0, "embed_rms_gap": 0.0, "logit_gap": 0.0,
                "iou_gap": 0.0,
                "keep_unexplained": 0, "mask_unexplained": 0, "nms_gap": 0,
                "labels_gap": 0}
        for i, res in self.kept:
            for k, v in self._numbers(i, res).items():
                nums[k] = max(nums[k], v)
        host = ("labels", "scores", "boxes", "keep", "candidates",
                "candidate_boxes", "iou_preds", "stability")
        for i, out in self.outputs:
            if not any(j == i and all(np.array_equal(getattr(out, f),
                                                     getattr(r, f),
                                                     equal_nan=f in FLOATS)
                                      for f in host)
                       for j, r in self.kept):
                nums["keep_unexplained"] = max(nums["keep_unexplained"],
                                               len(out.iou_preds))
        return nums

    def _bands(self, iou, up):
        """(certainly kept, certainly dropped) by the reference's filters,
        its IoUs and resized logits allowed to move by the limits."""
        a, lim = self.config["amg"], self.limits
        t, off = a["mask_threshold"], a["stability_score_offset"]
        d = lim["logit_gap"]
        lo = ((up > t + off + d).sum((-1, -2))
              / (up > t - off - d).sum((-1, -2)))
        hi = ((up > t + off - d).sum((-1, -2))
              / (up > t - off + d).sum((-1, -2)))
        s = a["stability_score_thresh"]
        th, di = a["pred_iou_thresh"], lim["iou_gap"]
        keep = (iou > th + di) & (lo >= s)
        drop = (iou <= th - di) | (hi < s)
        return keep, drop

    def _numbers(self, i, res, quant=None):
        """The compared numbers of one call's result (or of the reference
        in ``quant``, whose own filters' decisions stand for the call's)
        against the float32 reference."""
        a = self.config["amg"]
        _, emb = self._reference_embedding(i)
        size, got_emb = (self._reference_embedding(i, quant) if quant
                         else (None, res.embedding))
        diff = got_emb.float() - emb
        nums = {"embed_gap": float(diff.abs().max() / emb.std()),
                "embed_rms_gap": float(diff.square().mean().sqrt()
                                       / emb.std())}
        low_gap = iou_gap = 0.0
        unexplained = mask_off = 0
        want = {}
        if quant is None:
            passed = np.zeros(len(res.iou_preds), bool)
            passed[res.candidates] = True
            kept = {int(k): n for n, k in enumerate(res.keep)}
            batches = self._reference_batches(i)
        else:
            batches = zip(self._reference_batches(i),
                          self._reference_batches(i, quant))
        for item in batches:
            if quant is None:
                sl, low, iou, up = item
                got_low = res.low_res[sl.start // 3:sl.stop // 3].float()
                got_iou = torch.from_numpy(res.iou_preds[sl]).to(iou.device)
                got_pass = torch.from_numpy(passed[sl]).to(iou.device)
            else:
                (sl, low, iou, up), (_, got_low, got_iou, got_up) = item
                got_stab = ref.stability_score(
                    got_up, a["mask_threshold"], a["stability_score_offset"])
                got_pass = ((got_iou > a["pred_iou_thresh"])
                            & (got_stab >= a["stability_score_thresh"]))
            low_gap = max(low_gap, float((got_low - low).abs().max()))
            iou_gap = max(iou_gap, float((got_iou - iou).abs().max()))
            keep, drop = self._bands(iou, up)
            unexplained += int(((got_pass & drop) | (~got_pass & keep)).sum())
            if quant is None:
                for p in range(sl.start, sl.stop):
                    if p in kept:
                        want[p] = up[p - sl.start]
        nums.update(logit_gap=low_gap, iou_gap=iou_gap,
                    keep_unexplained=unexplained)
        if quant is not None:
            return nums
        margin = self.limits["logit_gap"]
        for p, n in kept.items():
            off = res.masks[n] != (want[p] > a["mask_threshold"])
            mask_off += int((off & ((want[p] - a["mask_threshold"]).abs()
                                    > margin)).sum())
        cand = res.candidates
        scores = torch.from_numpy(res.iou_preds[cand])
        ref_keep = {int(cand[k]) for k in ref.nms(
            torch.from_numpy(res.candidate_boxes), scores,
            a["box_nms_thresh"])}
        boxes = ref.mask_to_box(res.masks).cpu().numpy()
        nms_gap = len(ref_keep ^ set(int(k) for k in res.keep))
        nms_gap += int(np.any(boxes != res.boxes, axis=1).sum())
        labels = ref.paint(res.masks.cpu()).numpy()
        nums.update(mask_unexplained=mask_off, nms_gap=nms_gap,
                    labels_gap=int((labels != res.labels).sum()))
        return nums

    def control(self):
        """The numbers of the reference in fp8 put in the package's place,
        on each movie the window called."""
        fp8 = QUANT["fp8"]
        nums = {}
        for i in sorted({i for i, _ in self.outputs}):
            for k, v in self._numbers(i, None, fp8).items():
                nums[k] = max(nums.get(k, 0), v)
        return nums
