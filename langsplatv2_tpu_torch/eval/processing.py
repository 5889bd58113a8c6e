"""Relevancy-map post-processing and metrics
(port of langsplatv2_tpu/eval/processing.py; reference eval_lerf.py:104-200).

- 29x29 average pool, stride 1, count_include_pad=False, blended
  0.5 (avg + raw);
- min-max normalization into [-1, 1], clipped to [0, 1];
- threshold -> binary mask -> 7x7 average-pool majority smoothing;
- per-level IoU against the GT masks, the level chosen by the largest
  smoothed relevancy;
- localization: the smoothed arg-max set inside any GT box.

Plain torch on the map's device. Every function takes a stack of maps
[..., H, W] and pools them in one call; the per-prompt choices (levels,
arg-max coordinates) are taken on the host.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def avg_pool_same(x: torch.Tensor, kernel: int, padding: int) -> torch.Tensor:
    """[..., H, W] average pool, stride 1, count_include_pad=False (border
    windows divide by their in-bounds count)."""
    h, w = x.shape[-2:]
    out = F.avg_pool2d(x.reshape(-1, 1, h, w).float(), kernel, stride=1,
                       padding=padding, count_include_pad=False)
    return out.reshape(x.shape)


def smooth_mask(mask: torch.Tensor) -> torch.Tensor:
    """7x7 majority smoothing (reference smooth_cuda, eval_lerf.py:104-109)."""
    return (avg_pool_same(mask.float(), 7, 3) > 0.5).to(torch.uint8)


def heatmap_to_mask(valid: torch.Tensor, thresh: float):
    """Heatmaps [..., H, W] -> (smoothed heatmaps, binary masks), each map
    normalized by its own min and max (eval_lerf.py:121-137)."""
    avg = avg_pool_same(valid, 29, 14)
    blended = 0.5 * (avg + valid)
    lo = blended.amin(dim=(-2, -1), keepdim=True)
    hi = blended.amax(dim=(-2, -1), keepdim=True)
    out = (blended - lo) / (hi - lo + 1e-9)
    out = torch.clamp(out * 2.0 - 1.0, 0.0, 1.0)
    return blended, smooth_mask((out > thresh).to(torch.uint8))


def iou(mask_a: torch.Tensor, mask_b: torch.Tensor) -> torch.Tensor:
    """IoU of binary masks over their last two dims (f32)."""
    a, b = mask_a.bool(), mask_b.bool()
    inter = (a & b).sum(dim=(-2, -1)).float()
    union = (a | b).sum(dim=(-2, -1)).float()
    return inter / union


def _gt_stack(gt: dict, prompts: list[str], device) -> torch.Tensor:
    return torch.stack([torch.as_tensor(np.asarray(gt[p]).astype(np.uint8),
                                        device=device) for p in prompts])


def segmentation_process(valid_map: torch.Tensor, thresh: float,
                         gt_masks: dict, prompts: list[str]):
    """valid_map [levels, prompts, H, W] -> per prompt the IoU at the level
    whose smoothed relevancy peaks highest (eval_lerf.py:111-156). Returns
    (chosen_iou_list, chosen_lvl_list, {prompt: [IoU per level]})."""
    valid_map = torch.as_tensor(valid_map)
    blended, mask_pred = heatmap_to_mask(valid_map, thresh)
    gt = _gt_stack(gt_masks, prompts, valid_map.device)      # [P, H, W]
    ious = iou(gt[None], mask_pred).cpu().numpy()            # [L, P]
    scores = blended.amax(dim=(-2, -1)).cpu().numpy()
    chosen = np.argmax(scores, axis=0)
    iou_all = {p: [float(v) for v in ious[:, k]]
               for k, p in enumerate(prompts)}
    return ([float(ious[c, k]) for k, c in enumerate(chosen)],
            [int(c) for c in chosen], iou_all)


def localization_process(valid_map, gt_bboxes: dict,
                         prompts: list[str]) -> int:
    """The number of prompts whose smoothed-relevancy arg-max set, at the
    level that peaks highest, has a point inside any GT box (x1 y1 x2 y2;
    eval_lerf.py:158-200)."""
    avg = avg_pool_same(torch.as_tensor(valid_map), 29, 14)   # [L, P, H, W]
    scores = avg.amax(dim=(-2, -1))
    head = torch.argmax(scores.cpu(), dim=0)   # first of equal maxima
    acc_num = 0
    for k, p in enumerate(prompts):
        i = int(head[k])
        yx = torch.nonzero(avg[i, k] == scores[i, k]).cpu().numpy()
        boxes = np.asarray(gt_bboxes[p]).reshape(-1, 4)
        x_min = np.minimum(boxes[:, 0], boxes[:, 2])[:, None]
        x_max = np.maximum(boxes[:, 0], boxes[:, 2])[:, None]
        y_min = np.minimum(boxes[:, 1], boxes[:, 3])[:, None]
        y_max = np.maximum(boxes[:, 1], boxes[:, 3])[:, None]
        y, x = yx[:, 0][None], yx[:, 1][None]
        acc_num += int(((x_min <= x) & (x <= x_max) & (y_min <= y)
                        & (y <= y_max)).any())
    return acc_num


# cv2.fillPoly's fixed point (drawing.cpp: XY_SHIFT, XY_ONE).
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine to the frame [0, width) x [0, height): (inside, x1, y1,
    x2, y2). The first end is moved first, and the second end's move reads
    the first's new position, as OpenCV does; the moves truncate a double
    quotient toward zero."""
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def draw_line(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """cv2.line(mask, p1, p2, 1, 1, LINE_8): clipped to the frame, walked
    from its left end by Bresenham's rule (error dx - 2 dy, the minor axis
    steps while it is negative)."""
    h, w = mask.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, abs(y2 - y1), 1 if y2 >= y1 else -1
    major, minor_len = max(dx, dy), min(dx, dy)
    k = np.arange(major + 1)
    # The minor offset at step k: ceil((2 minor k - major) / (2 major)),
    # at least 0 (0 for a single point).
    minor = (np.maximum(0, -((major - 2 * minor_len * k) // (2 * major)))
             if major else k)
    if dy > dx:
        mask[y1 + sy * k, x1 + minor] = 1
    else:
        mask[y1 + sy * minor, x1 + k] = 1


def _poly_edges(mask: np.ndarray, pts) -> list:
    """Each edge's outline drawn and its [y0, y1, x, dx] for the fill:
    rows y0 <= y < y1, x at row y0 and dx a row in 16.16 fixed point. An
    edge with an end outside the frame takes x from its clipped ends (y
    too unless the clip leaves one row), extrapolated back to row y0;
    horizontal edges are outline only."""
    h, w = mask.shape
    edges = []
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        draw_line(mask, x0, y0, x1, y1)
        ax, ay, bx, by = x0 << XY_SHIFT, y0, x1 << XY_SHIFT, y1
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            _, cx0, cy0, cx1, cy1 = clip_line(w, h, x0, y0, x1, y1)
            if cy0 != cy1:
                ay, by = cy0, cy1
            ax, bx = cx0 << XY_SHIFT, cx1 << XY_SHIFT
        if y0 != y1:
            dx = _trunc_div(bx - ax, by - ay)
            if y0 < y1:
                edges.append([y0, y1, ax + (y0 - ay) * dx, dx])
            else:
                edges.append([y1, y0, bx + (y1 - by) * dx, dx])
        x0, y0 = x1, y1
    return edges


def _fill_edges(mask: np.ndarray, edges: list) -> None:
    """OpenCV's FillEdgeCollection: a row at a time, the active edges in x
    order (a new edge goes before the first one of larger x); consecutive
    pairs fill from the ceiling of the left x to the floor of the right
    one, and only paired edges advance; then a stable sort by x."""
    h, w = mask.shape
    if len(edges) < 2:
        return
    ends = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3]
                                    for e in edges]
    y_max = max(e[1] for e in edges)
    if (y_max < 0 or min(e[0] for e in edges) >= h or max(ends) < 0
            or min(ends) >= (w << XY_SHIFT)):
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    total, i, active = len(edges), 0, []
    for y in range(edges[0][0], min(y_max, h)):
        pos, prev, draw = 0, None, False
        while pos < len(active) or (i < total and edges[i][0] == y):
            last = active[pos] if pos < len(active) else None
            if last is not None and last[1] == y:
                del active[pos]
                continue
            left = prev
            if last is not None and (i == total or edges[i][0] > y
                                     or last[2] < edges[i][2]):
                prev = last
            else:
                prev = edges[i]
                active.insert(pos, prev)
                i += 1
            pos += 1
            if draw:
                if y >= 0:
                    a, b = sorted((left[2], prev[2]))
                    xa, xb = (a + XY_ONE - 1) >> XY_SHIFT, b >> XY_SHIFT
                    if xa < w and xb >= 0:
                        mask[y, max(xa, 0):min(xb, w - 1) + 1] = 1
                left[2] += left[3]
                prev[2] += prev[3]
            draw = not draw
        active.sort(key=lambda e: e[2])


def polygon_to_mask(shape: tuple[int, int], points) -> np.ndarray:
    """Rasterize a labelme polygon to a bool mask (reference
    eval/utils.py:97-103): cv2.fillPoly(mask, [pts], 1) at lineType 8 and
    shift 0 for int32 vertices, bit for bit, without OpenCV: every edge
    drawn as an 8-connected line, then the even-odd fill between its
    fixed-point edge crossings, clipped to the frame."""
    mask = np.zeros(shape, dtype=np.uint8)
    pts = [(int(x), int(y))
           for x, y in np.asarray(points, np.int32).reshape(-1, 2)]
    if pts:
        _fill_edges(mask, _poly_edges(mask, pts))
    return mask.astype(bool)


def stack_mask(mask_base: np.ndarray, mask_add: np.ndarray) -> np.ndarray:
    """Union of GT masks for a repeated label (reference eval/utils.py:104)."""
    return np.logical_or(mask_base, mask_add)


def mode_smooth(mask: np.ndarray) -> np.ndarray:
    """5x5 mode filter (reference eval/utils.py:61-70 `smooth`); needs
    scipy."""
    from scipy.ndimage import generic_filter

    def mode_fn(vals):
        return np.bincount(vals.astype(np.int64)).argmax()

    return generic_filter(mask.astype(np.int64), mode_fn,
                          size=5).astype(mask.dtype)
