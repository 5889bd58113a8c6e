"""Preprocessing pipeline: images -> per-pixel CLIP feature tables
(port of langsplatv2_tpu/preprocess/pipeline.py; reference
`preprocess.py` create() (113-174) + sam_encoder (296-329)).

Per image: 4-granularity masks -> NMS -> crop / pad / 224 tiles -> CLIP
-> `<img>_s.npy` seg-index map [4, H, W] (levels default / s / m / l with
cumulative cross-level offsets) + `<img>_f.npy` features [N_seg, 512].
The mask generator is pluggable (any callable image -> 4 lists of mask
dicts): the port's SAM (`sam.TorchSamMaskGenerator`), upstream
segment_anything (`SamMaskGenerator`, import-gated) or the weights-free
`ClusterMaskGenerator`. The masks' NMS, tiles and seg maps, the CLIP
encoders and the cluster segmenter's k-means run on the pipeline's device;
the unit-norm feature rows are formed in numpy as JAX forms them, so the
files are JAX's byte for byte when the embeddings are.

Expected differences from JAX: the cluster segmenter draws its k-means++
seeds (cv2's greedy form, three candidates a seed) from a
torch.Generator, not cv2.kmeans's RNG, and iterates until no label
changes (at most 10 updates), where JAX's criteria (a squared centre
shift of at most 1.0 on features within [0, 1]) stop cv2 after its
first update; images are decoded by PIL, not cv2.imread (PNG decodes
alike, JPEG decoders may differ by a level).
"""
from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..eval.openclip import make_backend
from ..utils.sparse_codes import _assign
from . import masks as mask_ops
from .resize import resize_linear_u8

class SamMaskGenerator:
    """Wraps the segment-anything-langsplat 4-granularity generator
    (reference preprocess.py:362-372: points_per_side=32, crop_n_layers=1,
    ViT-H) on the device. Import-gated."""

    def __init__(self, checkpoint: str, model_type: str = "vit_h",
                 points_per_side: int = 32, device=None):
        from segment_anything import SamAutomaticMaskGenerator, sam_model_registry

        sam = sam_model_registry[model_type](checkpoint=checkpoint)
        sam.to(resolve_device(device))
        self.generator = SamAutomaticMaskGenerator(
            model=sam,
            points_per_side=points_per_side,
            pred_iou_thresh=0.7,
            box_nms_thresh=0.7,
            stability_score_thresh=0.85,
            crop_n_layers=1,
            crop_n_points_downscale_factor=1,
            min_mask_region_area=100,
        )

    def __call__(self, image: np.ndarray):
        return self.generator.generate(image)  # 4-tuple in the langsplat fork


def kmeans_pp_seeds(points: torch.Tensor, k: int,
                    generator: torch.Generator, trials: int = 3):
    """cv2's greedy k-means++ (KMEANS_PP_CENTERS): the first seed uniform;
    each next one the best of `trials` candidates drawn in proportion to
    the squared distance to the nearest seed, by the summed distances it
    leaves. A candidate is the least Exp(1) / distance over the points
    (an exponential race: the same law as a draw from the cumulative
    sums, without a device scan whose float order may vary from run to
    run); all distances 0 give the first point, as cv2's search does.
    Returns the seeds' indices."""
    n = points.shape[0]
    gdev = generator.device
    first = int(torch.randint(0, n, (1,), generator=generator, device=gdev))
    seeds = [first]
    dist = ((points - points[first]) ** 2).sum(-1)
    for _ in range(1, k):
        race = -torch.log(torch.rand((trials, n), generator=generator,
                                     device=gdev)).to(points.device)
        cand = torch.argmin(race / dist[None], dim=1)
        d2 = torch.minimum(((points[None] - points[cand][:, None]) ** 2)
                           .sum(-1), dist[None])
        best = int(torch.argmin(d2.sum(-1)))
        seeds.append(int(cand[best]))
        dist = d2[best]
    return seeds


def kmeans(points: torch.Tensor, k: int, generator: torch.Generator,
           max_iter: int = 10):
    """k-means on the device from cv2's greedy k-means++ seeds: Lloyd's
    iterations (centre update, reassignment) until no label changes or
    `max_iter` updates. Returns (compactness, labels [N], centres [k, D])
    as cv2.kmeans does: the summed squared distance of each point to its
    centre. An emptied cluster keeps its centre. The centre sums are
    taken in int64 fixed point (2**24 steps of the largest |feature|), so
    they do not depend on the order of a device's atomic adds and the
    labels are the same on every run."""
    scale = 2.0 ** 24 / max(1.0, float(points.abs().max()))
    fixed = torch.round(points.double() * scale).long()
    centers = points[kmeans_pp_seeds(points, k, generator)]
    labels = _assign(points, centers)
    for _ in range(max_iter):
        sums = torch.zeros((k, points.shape[1]), dtype=torch.long,
                           device=points.device).index_add_(0, labels, fixed)
        counts = torch.bincount(labels, minlength=k)
        means = (sums.double() / scale
                 / torch.clamp(counts, min=1)[:, None]).to(points.dtype)
        centers = torch.where(counts[:, None] > 0, means, centers)
        new = _assign(points, centers)
        if torch.equal(new, labels):
            break
        labels = new
    compactness = float(((points - centers[labels]) ** 2).sum())
    return compactness, labels, centers


def connected_components(mask: np.ndarray, origin=(0, 0),
                         width: int | None = None):
    """8-connected components of a binary [H, W] map, labelled in
    cv2.connectedComponents' order: a component's label follows the
    first 2x2 block (row pairs, then column pairs) that holds one of its
    pixels. `mask` may be a crop at `origin` (y, x) of an image `width`
    wide: the blocks are the image's. Returns (count including the
    background, labels)."""
    from scipy import ndimage

    lab, n = ndimage.label(mask, structure=np.ones((3, 3), bool))
    if n == 0:
        return 1, lab
    oy, ox = origin
    width = mask.shape[1] if width is None else width
    yy, xx = np.nonzero(lab)
    key = ((yy + oy) // 2) * (width + 2) + (xx + ox) // 2
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, lab[yy, xx], key)
    remap = np.zeros(n + 1, np.int32)
    remap[np.argsort(first[1:], kind="stable") + 1] = np.arange(1, n + 1)
    return n + 1, remap[lab]


class ClusterMaskGenerator:
    """Weights-free 4-granularity segmenter: k-means over (color, position)
    features followed by connected-component splitting, one clustering per
    granularity (finer = more clusters, mirroring SAM's s/m/l ordering).

    This is NOT a SAM substitute semantically — it exists so the whole
    preprocess stage runs end-to-end where no SAM checkpoint exists, and
    as a baseline segmenter for scenes where color regions track objects.
    Mask dicts carry the keys the SAM generators produce (segmentation,
    bbox, predicted_iou, stability_score). Each clustering draws from a
    torch.Generator seeded with `seed`."""

    # clusters per granularity: 0=default, 1=s(fine), 2=m, 3=l(coarse)
    LEVEL_CLUSTERS = (24, 48, 16, 6)

    def __init__(self, seed: int = 42, min_area: int | None = None,
                 position_weight: float = 0.5, device=None):
        self.seed = seed
        self.min_area = min_area   # None: adaptive, ~hw/1000 in [16, 256]
        self.position_weight = position_weight
        self.device = resolve_device(device)

    def features(self, image: np.ndarray) -> torch.Tensor:
        """[H*W, 5] f32: rgb / 255, then the weighted y / h and x / w."""
        h, w = image.shape[:2]
        dev = self.device
        img = torch.tensor(np.asarray(image), device=dev)
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev),
            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        return torch.cat([
            img.reshape(h * w, -1).float() / 255.0,
            (self.position_weight * yy / h).reshape(-1, 1),
            (self.position_weight * xx / w).reshape(-1, 1)], dim=1)

    def labels(self, image: np.ndarray, k: int) -> np.ndarray:
        """The k-means labels [H, W] of one granularity."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        _, labels, _ = kmeans(self.features(image), k, gen)
        return labels.reshape(image.shape[:2]).cpu().numpy()

    def _min_area(self, h: int, w: int) -> int:
        return (self.min_area if self.min_area is not None
                else int(np.clip(h * w // 1000, 16, 256)))

    def _masks_for(self, image: np.ndarray, k: int):
        from scipy import ndimage

        h, w = image.shape[:2]
        min_area = self._min_area(h, w)
        k = max(2, min(k, h * w // (4 * min_area)))
        labels = self.labels(image, k)
        sizes = np.bincount(labels.ravel(), minlength=k)
        boxes = ndimage.find_objects(labels + 1, max_label=k)
        out = []
        for c in range(k):
            if sizes[c] < min_area:
                continue
            ys, xs = boxes[c]        # the cluster's bounding box
            n_cc, cc = connected_components(labels[ys, xs] == c,
                                            (ys.start, xs.start), w)
            areas = np.bincount(cc.ravel(), minlength=n_cc)
            for comp, (cy, cx) in enumerate(ndimage.find_objects(cc), 1):
                if areas[comp] < min_area:
                    continue
                y0, x0 = ys.start + cy.start, xs.start + cx.start
                seg = np.zeros((h, w), bool)
                seg[y0:ys.start + cy.stop, x0:xs.start + cx.stop] = \
                    cc[cy, cx] == comp
                out.append({
                    "segmentation": seg,
                    "bbox": [x0, y0, cx.stop - cx.start, cy.stop - cy.start],
                    "predicted_iou": 1.0,
                    "stability_score": 1.0,
                })
        return out

    def __call__(self, image: np.ndarray):
        out = []
        for k in self.LEVEL_CLUSTERS:
            masks = self._masks_for(image, k)
            if not masks:
                # Degenerate inputs (tiny/noise images): a full-frame mask
                # keeps the level non-empty, which the pipeline requires.
                h, w = image.shape[:2]
                masks = [{
                    "segmentation": np.ones((h, w), bool),
                    "bbox": [0, 0, w, h],
                    "predicted_iou": 1.0,
                    "stability_score": 1.0,
                }]
            out.append(masks)
        return tuple(out)


class PreprocessPipeline:
    def __init__(self, mask_generator: Callable, clip_backend: str = "auto",
                 device=None):
        self.device = resolve_device(device)
        self.mask_generator = mask_generator
        self.clip = make_backend(clip_backend, device=self.device)

    def encode_image_tiles(self, tiles: torch.Tensor) -> np.ndarray:
        emb = np.asarray(self.clip.encode_image(tiles), np.float32)
        return emb / np.linalg.norm(emb, axis=-1, keepdims=True)

    def process_image(self, image: np.ndarray):
        """image [H, W, 3] uint8 RGB -> (features [N, 512], seg_map [4, H, W]).

        Level seg ids are offset cumulatively so all levels index one shared
        feature table (reference create(), preprocess.py:140-157)."""
        levels = self.mask_generator(image)
        levels = mask_ops.masks_update(
            *levels, iou_thr=0.8, score_thr=0.7, inner_thr=0.5,
            device=self.device)

        embeds, seg_maps, lengths = [], [], []
        for masks_lvl in levels:
            assert len(masks_lvl) > 0, "level produced no masks"
            tiles, seg_map = mask_ops.mask_to_segmap(masks_lvl, image,
                                                     self.device)
            embeds.append(self.encode_image_tiles(tiles))
            seg_maps.append(seg_map.cpu().numpy())
            lengths.append(len(masks_lvl))

        offsets = np.cumsum([0] + lengths[:-1])
        stacked = []
        for j, seg_map in enumerate(seg_maps):
            s = seg_map.copy()
            if j > 0:
                assert s.max() == lengths[j] - 1
                s[s != -1] += offsets[j]
            stacked.append(s)
        features = np.concatenate(embeds, axis=0)
        return features, np.stack(stacked, axis=0)

    def run(self, image_list: list[np.ndarray], name_list: list[str],
            save_folder: str) -> None:
        os.makedirs(save_folder, exist_ok=True)
        for img, name in zip(image_list, name_list):
            features, seg_map = self.process_image(img)
            base = os.path.join(save_folder, os.path.splitext(name)[0])
            np.save(base + "_s.npy", seg_map)
            np.save(base + "_f.npy", features)


def create(image_list, data_list, save_folder, mask_generator,
           clip_backend: str = "auto", device=None):
    """Reference-compatible entry (preprocess.py:113)."""
    PreprocessPipeline(mask_generator, clip_backend, device).run(
        image_list, data_list, save_folder)


def load_images(dataset_path: str, resize_max: int = 1080,
                device=None) -> tuple[list, list]:
    """Load + auto-resize dataset images (reference preprocess.py:374-400:
    height capped at `resize_max`, cv2's INTER_LINEAR on the device).
    Files PIL cannot read are skipped, as cv2.imread's None is."""
    from PIL import Image, ImageOps, UnidentifiedImageError

    dev = resolve_device(device)
    img_folder = os.path.join(dataset_path, "images")
    names = sorted(os.listdir(img_folder))
    images, kept = [], []
    for name in names:
        path = os.path.join(img_folder, name)
        try:
            with Image.open(path) as im:
                img = np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
        except (OSError, UnidentifiedImageError):
            continue
        if img.shape[0] > resize_max:
            scale = resize_max / img.shape[0]
            img = resize_linear_u8(torch.tensor(img, device=dev),
                                   round(img.shape[1] * scale),
                                   resize_max).cpu().numpy()
        images.append(img)
        kept.append(name)
    return images, kept
