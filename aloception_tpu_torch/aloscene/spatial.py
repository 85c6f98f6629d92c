"""Spatial augmented arrays: base for every (..., H, W)-structured type
(counterpart of ``aloception_tpu/aloscene/spatial.py``).

Camera-calibration child slots, stereo properties, H/W helpers, temporal/batch
dim insertion, ``batch_list`` (pad to the batch's largest frame or a fixed
size, plus the padded-area ``Mask``) and the spatial geometric ops. Ops are
named-dim driven, so CHW and HWC layouts both work. Batching concatenates on
the frames' device and builds the mask there.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .augmented import AugmentedArray
from .labels import Labels


def resize_bilinear(a: torch.Tensor, size) -> torch.Tensor:
    """An (N, C, H, W) float tensor resized to ``size`` (H, W) as the JAX
    package's ``cv2.resize(INTER_LINEAR)`` of float data: bilinear with
    half-pixel centres and no antialiasing."""
    return F.interpolate(a, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)


class SpatialAugmentedArray(AugmentedArray):
    """Base for all H,W data."""

    def __init__(self, x, names=None, cam_intrinsic=None, cam_extrinsic=None,
                 baseline=None, camera_side=None, mask=None, **kwargs):
        super().__init__(x, names=names, **kwargs)
        if ("H" not in self._names or "W" not in self._names) \
                and names is None and self.ndim >= 2:
            # default trailing ... H, W naming if the caller gave none
            self._names = (None,) * (self.ndim - 2) + ("H", "W")
        self.add_property("baseline", baseline)
        self.add_property("camera_side", camera_side)
        self.add_child("mask", mask, align_dim=["B", "T"], mergeable=True)
        self.add_child("cam_intrinsic", cam_intrinsic, align_dim=["B", "T"],
                       mergeable=True)
        self.add_child("cam_extrinsic", cam_extrinsic, align_dim=["B", "T"],
                       mergeable=True)

    # ------------------------------------------------------------------
    @property
    def H(self) -> int:
        return self.shape[self.dim_idx("H")]

    @property
    def W(self) -> int:
        return self.shape[self.dim_idx("W")]

    @property
    def HW(self) -> Tuple[int, int]:
        return (self.H, self.W)

    def append_mask(self, mask, name: Optional[str] = None):
        self._append_child("mask", mask, name)

    def append_cam_intrinsic(self, cam_intrinsic, name: Optional[str] = None):
        self._append_child("cam_intrinsic", cam_intrinsic, name)

    def append_cam_extrinsic(self, cam_extrinsic, name: Optional[str] = None):
        self._append_child("cam_extrinsic", cam_extrinsic, name)

    def _children_op_kwargs(self, op: str, kwargs: dict) -> dict:
        """Inject spatial context into child geometric ops."""
        ck = dict(kwargs)
        if op in ("_hflip", "_vflip", "_crop", "_pad"):
            ck.setdefault("frame_size", self.HW)
        if op in ("_hflip", "_vflip"):
            for name in ("cam_intrinsic", "cam_extrinsic"):
                if self._children.get(name) is not None:
                    ck.setdefault(name, self._children[name])
        return ck

    def relative_to_absolute(self, x: float, dim: str) -> int:
        size = self.H if dim.lower() == "h" else self.W
        return int(round(x * size))

    def _item_dims(self):
        """(the sizes of the leading dims, those other than C, H and W; the
        shape that broadcasts a per-item value over the payload: those
        sizes in place, 1 elsewhere)."""
        lead = tuple(s for s, n in zip(self.shape, self._names)
                     if n not in ("C", "H", "W"))
        view = [1 if n in ("C", "H", "W") else s
                for s, n in zip(self.shape, self._names)]
        return lead, view

    def _per_item(self, values: torch.Tensor) -> torch.Tensor:
        """A per-item value (of the leading dims' shape, or a scalar)
        shaped to broadcast over the payload."""
        return values.reshape(self._item_dims()[1]) if values.ndim else values

    # ------------------------------------------------------------------
    # temporal/batch dim insertion
    # ------------------------------------------------------------------
    def _insert_dim(self, dim_name: str, dim: int):
        if dim_name in self._names:
            return self
        n_names = list(self._names)
        n_names.insert(dim, dim_name)
        new = self._with_array(self.array.unsqueeze(dim), names=n_names)

        def _up(c):
            if isinstance(c, SpatialAugmentedArray):
                return c._insert_dim(dim_name, dim)
            if isinstance(c, AugmentedArray):
                n = c._with_array(
                    c.array.unsqueeze(dim),
                    names=c._names[:dim] + (dim_name,) + c._names[dim:])
                if isinstance(c, Labels) and c.scores is not None:
                    n.scores = c.scores.unsqueeze(dim)
                return n
            return c
        new._children = {
            name: new.apply_on_child(child, _up)
            if new._child_meta[name]["mergeable"] else child
            for name, child in new._children.items()}
        return new

    def temporal(self, dim: Optional[int] = None):
        """Insert a temporal dim."""
        if "T" in self._names:
            return self
        if dim is None:
            dim = 1 if self._names[0] == "B" else 0
        return self._insert_dim("T", dim)

    def batch(self, dim: int = 0):
        """Insert a batch dim."""
        if "B" in self._names:
            return self
        return self._insert_dim("B", dim)

    # ------------------------------------------------------------------
    # batch_list: pad-to-max batching with a padded-area Mask
    # ------------------------------------------------------------------
    @staticmethod
    def batch_list(sa_arrays: Union[List, Dict], pad_boxes: bool = False,
                   pad_points2d: bool = False, intersection: bool = False,
                   size=None):
        """Pad every frame at the bottom and right to the batch's largest
        (H, W), or to ``size=(H, W)``, stack them on a new B dim and attach
        a ``Mask`` (1 = padded). A dict (or list of dicts) of frame lists is
        batched per key."""
        from .mask import Mask

        if isinstance(sa_arrays, dict) or (
                len(sa_arrays) and isinstance(sa_arrays[0], dict)):
            if isinstance(sa_arrays, list):  # list of dicts -> dict of lists
                keys = sa_arrays[0].keys()
                sa_arrays = {k: [d[k] for d in sa_arrays] for k in keys}
            return {k: SpatialAugmentedArray.batch_list(
                v, pad_boxes=pad_boxes, pad_points2d=pad_points2d,
                intersection=intersection, size=size)
                for k, v in sa_arrays.items()}

        frames = [f for f in sa_arrays if f is not None]
        if not frames:
            raise ValueError("batch_list needs at least one frame")
        max_h = max(f.H for f in frames)
        max_w = max(f.W for f in frames)
        if size is not None:
            if size[0] < max_h or size[1] < max_w:
                raise ValueError(f"batch_list size {size} smaller than batch "
                                 f"max ({max_h}, {max_w})")
            max_h, max_w = int(size[0]), int(size[1])

        padded, masks = [], []
        for f in frames:
            pf = f.batch().pad((0, max_h - f.H), (0, max_w - f.W),
                               pad_boxes=pad_boxes, pad_points2d=pad_points2d)
            padded.append(pf)
            m = torch.ones(_mask_shape(pf), dtype=torch.float32,
                           device=pf.device)
            m[pf.get_slices({"H": slice(None, f.H),
                             "W": slice(None, f.W)})] = 0.0
            masks.append(m)

        out = _cat_batched(padded, intersection=intersection)
        out.append_mask(Mask(torch.cat(masks, 0), names=padded[0]._names))
        return out

    @staticmethod
    def temporal_list(sa_arrays: List["SpatialAugmentedArray"]):
        """Stack same-shape frames along a NEW temporal axis T. Children
        stack with the frames; use batch_list first when shapes differ."""
        frames = [f.temporal() for f in sa_arrays if f is not None]
        if not frames:
            raise ValueError("temporal_list needs at least one frame")
        return _cat_batched(frames, axis_name="T")

    # ------------------------------------------------------------------
    # spatial geometric primitive ops
    # ------------------------------------------------------------------
    def _hflip(self, **kwargs):
        return self._with_array(self.array.flip(self.dim_idx("W")))

    def _vflip(self, **kwargs):
        return self._with_array(self.array.flip(self.dim_idx("H")))

    def _resize(self, size01, method: str = "bilinear", **kwargs):
        """Resize the payload by relative ratios: bilinear with half-pixel
        centres and no antialiasing (the JAX package's cv2 INTER_LINEAR
        path for host data), or nearest (cv2 INTER_NEAREST). Computed in
        float32 on the payload's device."""
        h = self.relative_to_absolute(size01[0], "h")
        w = self.relative_to_absolute(size01[1], "w")
        h_idx, w_idx = self.dim_idx("H"), self.dim_idx("W")
        n_shape = list(self.shape)
        n_shape[h_idx], n_shape[w_idx] = h, w
        if 0 in self.shape:  # empty tensor: reshape only
            return self._with_array(self.array.new_zeros(n_shape))
        perm = [i for i in range(self.ndim) if i not in (h_idx, w_idx)] \
            + [h_idx, w_idx]
        a = self.array.permute(perm).float()
        lead = a.shape[:-2]
        a = a.reshape(1, -1, self.H, self.W)
        if method == "bilinear":
            out = resize_bilinear(a, (h, w))
        elif method == "nearest":
            out = F.interpolate(a, size=(h, w), mode="nearest")
        else:
            raise ValueError(f"unknown resize method {method!r}")
        out = out.reshape(*lead, h, w)
        inv = [perm.index(i) for i in range(self.ndim)]
        return self._with_array(out.permute(inv).to(self.dtype))

    def _rotate(self, angle, center=None, fill: float = 0.0, **kwargs):
        """Rotate the payload by ``angle`` degrees counter-clockwise around
        ``center`` (absolute (x, y); default (W / 2, H / 2)), same shape:
        the JAX package's ``cv2.warpAffine`` (bilinear, constant border
        ``fill``) computed in float32 on the payload's device and cast back
        to its dtype with truncation, as numpy's ``astype``. Values are
        moved, not changed: flow and disparity vectors are not rotated."""
        H, W = self.H, self.W
        if center is None:
            center = (W / 2, H / 2)
        h_idx, w_idx = self.dim_idx("H"), self.dim_idx("W")
        perm = [i for i in range(self.ndim) if i not in (h_idx, w_idx)] \
            + [h_idx, w_idx]
        a = self.array.permute(perm).reshape(-1, H, W).float()
        out = warp_affine_linear(a, rotation_matrix(center, angle), fill)
        out = out.reshape([self.shape[i] for i in perm])
        inv = [perm.index(i) for i in range(self.ndim)]
        return self._with_array(out.permute(inv).to(self.dtype))

    def _crop(self, H_crop, W_crop, **kwargs):
        hmin = self.relative_to_absolute(H_crop[0], "h")
        hmax = self.relative_to_absolute(H_crop[1], "h")
        wmin = self.relative_to_absolute(W_crop[0], "w")
        wmax = self.relative_to_absolute(W_crop[1], "w")
        return self._with_array(self.array[self.get_slices(
            {"H": slice(hmin, hmax), "W": slice(wmin, wmax)})])

    def _padded(self, offset_y, offset_x, fill):
        """Payload placed in a new buffer of the padded shape, filled with
        ``fill`` (a scalar, or a tensor broadcast to the padded shape).
        Relative offsets become pixels through Python's ``round``."""
        top, bottom = (int(round(o * self.H)) for o in offset_y)
        left, right = (int(round(o * self.W)) for o in offset_x)
        n_shape = list(self.shape)
        n_shape[self.dim_idx("H")] += top + bottom
        n_shape[self.dim_idx("W")] += left + right
        buf = torch.empty(n_shape, dtype=self.dtype, device=self.device)
        buf[...] = fill
        buf[self.get_slices({"H": slice(top, top + self.H),
                             "W": slice(left, left + self.W)})] = self.array
        return self._with_array(buf)

    def _pad(self, offset_y, offset_x, fill: float = 0.0, **kwargs):
        return self._padded(offset_y, offset_x, fill)

    def _shifted(self, shift_y: float, shift_x: float, fill):
        """Roll the payload and fill the uncovered band with ``fill``."""
        y = int(shift_y * self.H)
        x = int(shift_x * self.W)
        arr = self.array.roll(x, self.dim_idx("W"))
        if x >= 1:
            arr[self.get_slices({"W": slice(0, x)})] = fill
        elif x <= -1:
            arr[self.get_slices({"W": slice(x, None)})] = fill
        arr = arr.roll(y, self.dim_idx("H"))
        if y >= 1:
            arr[self.get_slices({"H": slice(0, y)})] = fill
        elif y <= -1:
            arr[self.get_slices({"H": slice(y, None)})] = fill
        return self._with_array(arr)

    def _spatial_shift(self, shift_y: float, shift_x: float,
                       fill: float = 0.0, **kwargs):
        return self._shifted(shift_y, shift_x, fill)

    # ------------------------------------------------------------------
    # getitem: H/W slicing becomes a crop on children
    # ------------------------------------------------------------------
    def _getitem_child(self, child, child_name: str, idx):
        hw_crop = [None, None]
        dim = 0
        for sl in (idx if isinstance(idx, tuple) else (idx,)):
            if sl is Ellipsis:
                dim += self.ndim - (len(idx) - 1)
                continue
            name = self._names[dim]
            if isinstance(sl, slice) and (sl.start is not None
                                          or sl.stop is not None):
                if name in ("H", "W"):
                    size = self.H if name == "H" else self.W
                    start = 0 if sl.start is None else sl.start
                    stop = size if sl.stop is None else sl.stop
                    hw_crop[name == "W"] = (start / size, stop / size)
            dim += 1
        out = super()._getitem_child(child, child_name, idx)
        if hw_crop[0] is not None or hw_crop[1] is not None:
            H_crop = hw_crop[0] or (0.0, 1.0)
            W_crop = hw_crop[1] or (0.0, 1.0)
            out = self.apply_on_child(
                out, lambda c: c.crop(H_crop, W_crop, frame_size=self.HW)
                if hasattr(c, "crop") else c)
        return out

    # ------------------------------------------------------------------
    # views (spatial_augmented_tensor.py:115-202 get_view)
    # ------------------------------------------------------------------
    def __get_view__(self, title=None, **kwargs):
        """The payload as an HWC image (the first item of any leading
        dims), fetched to the host."""
        from .renderer import View
        return View(_hwc_first(self, self.cpu().as_numpy()), title=title)

    def get_view(self, views: Optional[list] = None, exclude=None, size=None,
                 title=None, **kwargs):
        """The frame's view with every renderable child drawn on it, in the
        order of the children: each child's ``__get_view__`` gets the image
        drawn so far (``frame``), ``frame_size`` and the frame's unnamed
        ``cam_intrinsic``, those of the three its signature takes, and its
        view replaces the image; "mask", the calibrations and ``exclude``
        are skipped; ``size`` (H, W) resizes every view; ``views`` are
        added to the right. The object and its children are fetched to the
        host once; a child's error rises (the JAX view drops a child whose
        view raises TypeError)."""
        from .renderer import View, resize_view
        host = self.cpu()
        views = list(views) if views else []
        exclude = exclude or []
        frame_img = host.__get_view__(title=title, **kwargs).image.copy()
        ci = host._children.get("cam_intrinsic")
        offered = {"frame_size": host.HW,
                   "cam_intrinsic": ci if not isinstance(ci, dict) else None}
        for name, child in host._children.items():
            if child is None or name in exclude or name in (
                    "mask", "cam_intrinsic", "cam_extrinsic"):
                continue

            def _draw(c):
                nonlocal frame_img
                fn = getattr(c, "__get_view__", None)
                if fn is None:
                    return c
                v = fn(**_accepted(fn, dict(offered, frame=frame_img)))
                if v is not None:
                    frame_img = v.image
                return c
            self.apply_on_child(child, _draw)
        views.insert(0, View(frame_img, title=title))
        if size is not None:
            for v in views:
                v.image = resize_view(v.image, size)
        out = views[0]
        for v in views[1:]:
            out = out.add(v)
        return out

    def render(self, **kwargs):
        self.get_view().render(**kwargs)

    # the boundary into model code
    def as_layout(self, names: Tuple[str, ...]) -> torch.Tensor:
        """The payload permuted to the given named layout (e.g.
        ("B","H","W","C")), as a view."""
        return self.array.permute([self.dim_idx(n) for n in names])


def _hwc_first(arr: AugmentedArray, values: np.ndarray) -> np.ndarray:
    """``values`` (the payload of ``arr``) transposed to (..., H, W[, C])
    and cut to 3 dims by taking first items, as the JAX views take it."""
    perm = [arr.dim_idx("H"), arr.dim_idx("W")]
    if "C" in arr.names:
        perm.append(arr.dim_idx("C"))
    lead = [i for i in range(values.ndim) if i not in perm]
    img = np.transpose(values, lead + perm)
    while img.ndim > 3:
        img = img[0]
    return img


def _accepted(fn, offered: dict) -> dict:
    """The keywords of ``offered`` that ``fn``'s signature takes (all of
    them where it has ``**kwargs``)."""
    import inspect
    params = inspect.signature(fn).parameters
    if any(p.kind is p.VAR_KEYWORD for p in params.values()):
        return offered
    return {k: v for k, v in offered.items() if k in params}


def rotation_matrix(center, angle: float) -> List[float]:
    """The 2x3 affine map of ``cv2.getRotationMatrix2D(center, angle, 1)``
    (row-major, float64 on the host)."""
    a = math.radians(angle)
    alpha, beta = math.cos(a), math.sin(a)
    cx, cy = float(center[0]), float(center[1])
    return [alpha, beta, (1 - alpha) * cx - beta * cy,
            -beta, alpha, beta * cx + (1 - alpha) * cy]


def warp_affine_linear(src: torch.Tensor, m: List[float], fill: float = 0.0
                       ) -> torch.Tensor:
    """``cv2.warpAffine(src, m, (W, H), INTER_LINEAR, BORDER_CONSTANT)``
    of float32 planes (N, H, W) as OpenCV 5.0 computes it (the JAX package
    calls it with the planes as channels), on their device. The map is
    inverted in float64; taps outside the source take ``fill``.

    - 1, 3 or 4 channels: source coordinates ``x * m0 + (y * m1 + m2)`` in
      float32 (the last step fused), and two fused lerps along x and one
      along y. OpenCV computes its last W mod 16 columns apart, within one
      float32 ulp of these coordinates.
    - Other channel counts: OpenCV's fixed-point map, coordinates rounded to
      1/32 of a pixel, and the four taps weighted by products of 1-D
      weights in float32.

    Fused steps are computed in float64 and rounded once."""
    D = m[0] * m[4] - m[1] * m[3]
    D = 1.0 / D if D != 0 else 0.0
    i0, i1, i3, i4 = m[4] * D, -m[1] * D, -m[3] * D, m[0] * D
    inv = [i0, i1, -i0 * m[2] - i1 * m[5], i3, i4, -i3 * m[2] - i4 * m[5]]
    N, H, W = src.shape
    dev = src.device
    float_map = N in (1, 3, 4)
    x0, y0, ax, ay = (_float_map if float_map else _fixed_map)(inv, H, W, dev)

    flat = src.reshape(N, H * W)
    fill_t = torch.full((), fill, dtype=src.dtype, device=dev)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(-1)
        return torch.where(inside, flat[:, idx].reshape(N, H, W), fill_t)

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    if float_map:
        f0 = _fma(ax, p01 - p00, p00)
        f1 = _fma(ax, p11 - p10, p10)
        return _fma(ay, f1 - f0, f0)
    out = p00 * ((1 - ay) * (1 - ax)) + p01 * ((1 - ay) * ax) \
        + p10 * (ay * (1 - ax)) + p11 * (ay * ax)
    outside = (x0 >= W) | (x0 + 1 < 0) | (y0 >= H) | (y0 + 1 < 0)
    return torch.where(outside, fill_t, out)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (``b`` a tensor or a float32
    value as a Python float)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a.double() * b + c.double()).float()


def _float_map(inv, H, W, dev):
    """(x0, y0, ax, ay): floor and fraction of the float32 source
    coordinates of OpenCV 5's vectorised warpAffine."""
    inv = np.asarray(inv, np.float32).tolist()
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    sx = _fma(xs, inv[0], ys * inv[1] + inv[2])
    sy = _fma(xs, inv[3], ys * inv[4] + inv[5])
    x0, y0 = sx.floor(), sy.floor()
    return x0.long(), y0.long(), sx - x0, sy - y0


def _fixed_map(inv, H, W, dev):
    """(x0, y0, ax, ay) of OpenCV's fixed-point warpAffine: coordinates in
    1/1024 of a pixel (rounded half to even from float64), rounded to 1/32
    of a pixel."""
    xs = torch.arange(W, dtype=torch.float64, device=dev)
    ys = torch.arange(H, dtype=torch.float64, device=dev)
    adelta = torch.round(inv[0] * xs * 1024).long()
    bdelta = torch.round(inv[3] * xs * 1024).long()
    X0 = torch.round((inv[1] * ys + inv[2]) * 1024).long() + 16
    Y0 = torch.round((inv[4] * ys + inv[5]) * 1024).long() + 16
    X = (X0[:, None] + adelta[None, :]) >> 5
    Y = (Y0[:, None] + bdelta[None, :]) >> 5
    return X >> 5, Y >> 5, (X & 31).float() / 32, (Y & 31).float() / 32


def _mask_shape(frame: SpatialAugmentedArray) -> Tuple[int, ...]:
    shape = list(frame.shape)
    if "C" in frame._names:
        shape[frame.dim_idx("C")] = 1
    return tuple(shape)


def _cat_batched(frames: List[SpatialAugmentedArray],
                 intersection: bool = False, axis_name: str = "B"):
    """Concatenate same-shape batched frames along a named axis, merging
    children: mergeable children are concatenated, unmergeable become
    per-item lists."""
    f0 = frames[0]
    axis = f0.dim_idx(axis_name)
    out = f0._with_array(torch.cat([f.array for f in frames], axis))

    # properties: equal values survive; differing values -> None (or error)
    props = dict(f0._properties)
    for f in frames[1:]:
        for k, v in f._properties.items():
            if props.get(k) != v:
                if not intersection:
                    raise ValueError(
                        f"batch_list: property '{k}' differs across tensors "
                        f"({props.get(k)} vs {v}); pass intersection=True")
                props[k] = None
    out._properties = props

    child_names = set(f0._children)
    for f in frames[1:]:
        child_names &= set(f._children)

    n_children: Dict[str, Any] = {}
    for name in f0._child_meta:
        vals = [f._children.get(name) for f in frames] \
            if name in child_names else [None]
        present = [v is not None for v in vals]
        mergeable = f0._child_meta[name]["mergeable"]
        if not any(present):
            n_children[name] = None
        elif not all(present):
            if intersection:
                n_children[name] = None
            elif not mergeable:
                # unmergeable children tolerate gaps: per-item list w/ None
                n_children[name] = _items(vals)
            else:
                raise ValueError(
                    f"batch_list: child '{name}' missing on some tensors; "
                    "pass intersection=True to drop it")
        elif not mergeable:
            n_children[name] = _items(vals)
        elif isinstance(vals[0], dict):
            n_children[name] = {k: _merge_children([v[k] for v in vals], axis)
                                for k in vals[0]}
        else:
            n_children[name] = _merge_children(vals, axis)
    out._children = n_children
    return out


def _items(vals) -> List[Any]:
    """Per-item list of child values (lists are flattened)."""
    items: List[Any] = []
    for v in vals:
        items.extend(v if isinstance(v, list) else [v])
    return items


def _merge_children(children: List[AugmentedArray], axis: int):
    c0 = children[0]
    out = c0._with_array(torch.cat([c.array for c in children], axis))
    if isinstance(c0, Labels):
        # scores merge with the ids when every item has them
        scores = [c.scores for c in children]
        out.scores = torch.cat(scores, axis) \
            if all(s is not None for s in scores) else None
    # recurse: merge sub-children of mergeable children
    subs: Dict[str, Any] = {}
    for name, meta in c0._child_meta.items():
        vals = [c._children.get(name) for c in children]
        if all(v is None for v in vals):
            subs[name] = None
        elif meta["mergeable"] and all(isinstance(v, AugmentedArray)
                                       for v in vals):
            subs[name] = _merge_children(vals, axis)
        else:
            subs[name] = _items(vals)
    out._children = subs
    return out
