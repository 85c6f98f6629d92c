"""Rotated-box IoU / GIoU, 2D and 3D (counterpart of
``aloception_tpu/ops/rotated_iou.py``).

Torch ops on the boxes' device, differentiable through autograd, with
static shapes: the intersection polygon of two quads is found among 24
candidate vertices (16 edge-edge intersections, the 4 corners of each box
inside the other), sorted by angle around their centre with a stable
argsort (invalid candidates last) and measured by the shoelace formula.
No matmul, so TF32 never reaches the geometry.

Element-wise pair semantics: inputs (..., 5) as [x, y, w, h, alpha] (2D) or
(..., 7) as [x, y, z, dx, dy, dz, heading] (3D, dims 0 and 1 the ground
plane), output the value for each pair; ``pairwise`` lifts a pair op to the
(N, M) matrix.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def box2corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) [x, y, w, h, alpha] -> (..., 4, 2) corners, CCW order."""
    x, y, w, h, alpha = boxes.unbind(-1)
    dx = torch.stack([w / 2, -w / 2, -w / 2, w / 2], -1)
    dy = torch.stack([h / 2, h / 2, -h / 2, -h / 2], -1)
    cos, sin = torch.cos(alpha)[..., None], torch.sin(alpha)[..., None]
    cx = dx * cos - dy * sin + x[..., None]
    cy = dx * sin + dy * cos + y[..., None]
    return torch.stack([cx, cy], -1)


def _segment_intersections(c1: torch.Tensor, c2: torch.Tensor):
    """All 16 edge-edge intersection points between two quads.

    c1, c2: (..., 4, 2). Returns points (..., 16, 2) and validity (..., 16).
    Parallel edges (|cross| < 1e-8) never intersect."""
    p1 = c1[..., :, None, :]
    p2 = c1.roll(-1, -2)[..., :, None, :]
    q1 = c2[..., None, :, :]
    q2 = c2.roll(-1, -2)[..., None, :, :]
    r = p2 - p1
    s = q2 - q1
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q1 - p1
    parallel = denom.abs() < _EPS
    safe = torch.where(parallel, torch.ones_like(denom), denom)
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / safe
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / safe
    valid = ~parallel & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = p1 + t[..., None] * r
    return (pts.reshape(pts.shape[:-3] + (16, 2)),
            valid.reshape(valid.shape[:-2] + (16,)))


def _points_in_box(pts: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """pts (..., 4, 2) inside the convex quad corners (..., 4, 2), CCW or
    CW, with a 1e-8 margin."""
    a = corners[..., None, :, :]
    b = corners.roll(-1, -2)[..., None, :, :]
    p = pts[..., :, None, :]
    cross = (b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1]) \
        - (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0])
    return (cross >= -_EPS).all(-1) | (cross <= _EPS).all(-1)


def intersection_area(corners1: torch.Tensor, corners2: torch.Tensor
                      ) -> torch.Tensor:
    """Area of the convex intersection polygon of two quads (..., 4, 2):
    masked angular sort of the 24 candidates, then the shoelace formula."""
    inter_pts, inter_valid = _segment_intersections(corners1, corners2)
    in12 = _points_in_box(corners1, corners2)
    in21 = _points_in_box(corners2, corners1)
    pts = torch.cat([inter_pts, corners1, corners2], -2)
    valid = torch.cat([inter_valid, in12, in21], -1)

    num_valid = valid.sum(-1)
    vf = valid[..., None].to(pts.dtype)
    center = (pts * vf).sum(-2) / num_valid.clamp(min=1)[..., None]
    d = pts - center[..., None, :]
    angles = torch.atan2(d[..., 1], d[..., 0])
    angles = torch.where(valid, angles, torch.full_like(angles, 1e6))
    # stable, as jnp.argsort: ties (invalid points, duplicate vertices of
    # identical or nested boxes) keep their candidate order
    order = torch.argsort(angles, dim=-1, stable=True)
    pts_sorted = pts.gather(-2, order[..., None].expand_as(pts))
    valid_sorted = valid.gather(-1, order)

    # close the polygon: the last valid vertex wraps to the first sorted one
    nxt = pts_sorted.roll(-1, -2)
    nxt_valid = valid_sorted.roll(-1, -1)
    nxt = torch.where(nxt_valid[..., None], nxt, pts_sorted[..., :1, :])
    cross = pts_sorted[..., 0] * nxt[..., 1] - pts_sorted[..., 1] * nxt[..., 0]
    area = 0.5 * (cross * valid_sorted.to(cross.dtype)).sum(-1).abs()
    return torch.where(num_valid >= 3, area, torch.zeros_like(area))


def cal_iou(box1: torch.Tensor, box2: torch.Tensor, ret_extra: bool = False):
    """Element-wise rotated IoU of paired boxes (..., 5); with ``ret_extra``
    also both boxes' corners and the union."""
    c1 = box2corners(box1)
    c2 = box2corners(box2)
    inter = intersection_area(c1, c2)
    a1 = box1[..., 2] * box1[..., 3]
    a2 = box2[..., 2] * box2[..., 3]
    union = a1 + a2 - inter
    iou = inter / (union + _EPS)
    if ret_extra:
        return iou, c1, c2, union
    return iou


def smallest_enclosing_box(corners1: torch.Tensor, corners2: torch.Tensor
                           ) -> torch.Tensor:
    """Area of the smallest box enclosing both quads among those aligned
    with one of their 8 edges. The projections are 2-wide dot products
    written as a multiply and a sum, in true float32."""
    pts = torch.cat([corners1, corners2], -2)                     # (..., 8, 2)
    edges = torch.cat([corners1.roll(-1, -2) - corners1,
                       corners2.roll(-1, -2) - corners2], -2)     # (..., 8, 2)
    norm = torch.linalg.vector_norm(edges, dim=-1, keepdim=True)
    dirs = edges / (norm + _EPS)
    perp = torch.stack([-dirs[..., 1], dirs[..., 0]], -1)
    pts = pts[..., None, :, :]                                    # (..., 1, 8, 2)
    proj_u = (dirs[..., :, None, :] * pts).sum(-1)                # (..., dirs, pts)
    proj_v = (perp[..., :, None, :] * pts).sum(-1)
    ext_u = proj_u.amax(-1) - proj_u.amin(-1)
    ext_v = proj_v.amax(-1) - proj_v.amin(-1)
    return (ext_u * ext_v).amin(-1)


def cal_giou(box1: torch.Tensor, box2: torch.Tensor):
    """Rotated GIoU: iou - (C - U) / C with C the smallest enclosing box
    area. Returns (giou, iou)."""
    iou, c1, c2, union = cal_iou(box1, box2, ret_extra=True)
    area_c = smallest_enclosing_box(c1, c2)
    giou = iou - (area_c - union) / (area_c + _EPS)
    return giou, iou


def _z_extent(box3d: torch.Tensor):
    half = box3d[..., 5] * 0.5
    return box3d[..., 2] - half, box3d[..., 2] + half


def _z_overlap(box3d1: torch.Tensor, box3d2: torch.Tensor) -> torch.Tensor:
    """Vertical overlap of the [z, dz] extents of paired boxes."""
    zmin1, zmax1 = _z_extent(box3d1)
    zmin2, zmax2 = _z_extent(box3d2)
    return (torch.minimum(zmax1, zmax2)
            - torch.maximum(zmin1, zmin2)).clamp(min=0)


def _z_enclosing(box3d1: torch.Tensor, box3d2: torch.Tensor) -> torch.Tensor:
    """Height of the vertical extent enclosing both boxes."""
    zmin1, zmax1 = _z_extent(box3d1)
    zmin2, zmax2 = _z_extent(box3d2)
    return torch.maximum(zmax1, zmax2) - torch.minimum(zmin1, zmin2)


def _bev(box3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) [x, y, z, dx, dy, dz, heading] -> the ground-plane box
    (..., 5) [x, y, dx, dy, heading]: dims 0 and 1 are the ground plane."""
    return torch.stack([box3d[..., 0], box3d[..., 1], box3d[..., 3],
                        box3d[..., 4], box3d[..., 6]], -1)


def cal_iou_3d(box3d1: torch.Tensor, box3d2: torch.Tensor,
               verbose: bool = False):
    """Element-wise 3D IoU of paired (..., 7) boxes. The ground-plane
    intersection is recovered from the ground-plane IoU,
    I = iou * (A1 + A2) / (1 + iou + eps), as the JAX package does."""
    bev1, bev2 = _bev(box3d1), _bev(box3d2)
    iou_2d, c1, c2, _ = cal_iou(bev1, bev2, ret_extra=True)
    inter_2d = iou_2d * (bev1[..., 2] * bev1[..., 3]
                         + bev2[..., 2] * bev2[..., 3]) / (1.0 + iou_2d + _EPS)
    zo = _z_overlap(box3d1, box3d2)
    inter_3d = inter_2d * zo
    v1 = box3d1[..., 3] * box3d1[..., 4] * box3d1[..., 5]
    v2 = box3d2[..., 3] * box3d2[..., 4] * box3d2[..., 5]
    union = v1 + v2 - inter_3d
    iou3d = inter_3d / (union + _EPS)
    if verbose:
        return iou3d, c1, c2, zo, union
    return iou3d


def cal_giou_3d(box3d1: torch.Tensor, box3d2: torch.Tensor):
    """3D GIoU with the enclosing volume (enclosing ground-plane box times
    the enclosing height). Returns (giou, iou3d)."""
    iou3d, c1, c2, _, union = cal_iou_3d(box3d1, box3d2, verbose=True)
    vol_c = smallest_enclosing_box(c1, c2) * _z_enclosing(box3d1, box3d2)
    giou = iou3d - (vol_c - union) / (vol_c + _EPS)
    return giou, iou3d


def cal_diou_3d(box3d1: torch.Tensor, box3d2: torch.Tensor):
    """3D DIoU: iou - d^2 / c^2 with d the centre distance and c the
    diagonal of the axis-aligned box enclosing both. Returns (diou, iou3d)."""
    iou3d, c1, c2, _, _ = cal_iou_3d(box3d1, box3d2, verbose=True)
    d2 = ((box3d1[..., :3] - box3d2[..., :3]) ** 2).sum(-1)
    pts = torch.cat([c1, c2], -2)
    xy_ext = pts.amax(-2) - pts.amin(-2)
    c2_diag = (xy_ext ** 2).sum(-1) + _z_enclosing(box3d1, box3d2) ** 2
    diou = iou3d - d2 / (c2_diag + _EPS)
    return diou, iou3d


def pairwise(fn, boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Lift an element-wise pair op to the (..., N, M) pairwise matrix."""
    b1, b2 = torch.broadcast_tensors(boxes1[..., :, None, :],
                                     boxes2[..., None, :, :])
    return fn(b1, b2)
