"""Label-aware augmentations (counterpart of
``aloception_tpu/alodataset/transforms.py``, its 26 classes).

Each transform draws its parameters in ``sample_params`` (returned as a
tuple), takes them back in ``set_params`` and applies them in ``apply``, so
one draw can be shared across the steps of a sequence (``same_on_sequence``)
and across a dict of frames (``same_on_frames``), and tests can set the same
parameters on both packages. Geometry goes through the aloscene ops, so
boxes, masks, flow, disparity and points move with the pixels; pixel ops are
torch ops on the frame's device.

The draws come from a ``torch.Generator`` given as ``generator=`` (torch's
default one without it); the JAX package draws from Python's ``random`` and
numpy's global state. The same distributions, not the same numbers. A
transform keeps its drawn parameters between ``set_params`` and ``apply``,
so threads do not share one: ``with_generator`` makes a copy for each
sample, drawing from that sample's generator.

``ColorJitter``'s hue reproduces OpenCV's float32 RGB <-> HSV conversion
(H in [0, 360)), and ``RandomFlowMotionBlur`` ``cv2.filter2D``'s correlation
with ``BORDER_REFLECT_101``, both as torch ops.
"""

from __future__ import annotations

import copy
import math
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..aloscene import Frame
from ..aloscene.spatial import _cat_batched


def _concat_temporal(frames: List[Frame]) -> Frame:
    """Concatenate single frames along a new T dim."""
    return _cat_batched([f.temporal() for f in frames], axis_name="T")


class AloTransform:
    """Base: ``__call__`` applies the transform with probability ``p`` to a
    frame, a temporal frame (T first) or a dict of frames."""

    def __init__(self, same_on_sequence: Union[bool, float] = True,
                 same_on_frames: Union[bool, float] = False, p: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        self.same_on_sequence = same_on_sequence
        self.same_on_frames = same_on_frames
        self.generator = generator
        self.sample_params()
        self.p = p

    def with_generator(self, generator: torch.Generator) -> "AloTransform":
        """A copy of this transform, and of those it holds, in which each
        draw of this transform's generator comes from ``generator``."""
        if self.generator is None:
            raise ValueError("with_generator: this transform draws from "
                             "torch's default generator")
        return copy.deepcopy(self, {id(self.generator): generator})

    # draws from the transform's generator
    def _rand(self) -> float:
        return float(torch.rand((), generator=self.generator))

    def _uniform(self, lo: float, hi: float, n: Optional[int] = None):
        u = torch.rand((n,) if n else (), dtype=torch.float64,
                       generator=self.generator)
        u = lo + (hi - lo) * u
        return u.tolist() if n else float(u)

    def _randint(self, lo: int, hi: int) -> int:
        """Uniform over lo..hi, both included (``random.randint``)."""
        return int(torch.randint(lo, hi + 1, (), generator=self.generator))

    def _init_same_on(self) -> Tuple[bool, bool]:
        def _to_bool(v):
            if isinstance(v, bool):
                return v
            if isinstance(v, float):
                if not 0 <= v <= 1:
                    raise ValueError("probability must be within [0, 1]")
                return self._rand() < v
            raise TypeError("same_on_* must be bool or float")
        return _to_bool(self.same_on_sequence), _to_bool(self.same_on_frames)

    def sample_params(self) -> tuple:
        raise NotImplementedError

    def set_params(self, *params):
        raise NotImplementedError

    def apply(self, frame: Frame, **kwargs) -> Frame:
        raise NotImplementedError

    def _per_step(self, f: Frame, params_of, **kwargs) -> Frame:
        """Apply to each step of a temporal frame with its own parameters."""
        steps = []
        for t in range(f.shape[f.dim_idx("T")]):
            self.set_params(*params_of(t))
            r = self.apply(f[t], **kwargs)
            if r.HW != f[t].HW:
                raise RuntimeError(
                    "size-changing transform cannot vary within a sequence")
            steps.append(r)
        return _concat_temporal(steps)

    def __call__(self, frames, **kwargs):
        if not self._rand() < self.p:
            return frames
        same_seq, same_frames = self._init_same_on()

        if isinstance(frames, Mapping):
            seq_params: dict = {}
            frame_params = None
            out = {}
            for key, f in frames.items():
                if "T" in f.names and same_frames and not same_seq:
                    def shared(t):
                        if t not in seq_params:
                            seq_params[t] = self.sample_params()
                        return seq_params[t]
                    out[key] = self._per_step(f, shared, **kwargs)
                elif "T" in f.names and not same_frames and not same_seq:
                    out[key] = self._per_step(
                        f, lambda t: self.sample_params(), **kwargs)
                elif same_frames:
                    frame_params = frame_params or self.sample_params()
                    self.set_params(*frame_params)
                    out[key] = self.apply(f, **kwargs)
                else:
                    self.set_params(*self.sample_params())
                    out[key] = self.apply(f, **kwargs)
            return out

        f = frames
        if "T" in f.names and not same_seq:
            steps = []
            for t in range(f.shape[f.dim_idx("T")]):
                self.set_params(*self.sample_params())
                steps.append(self.apply(f[t], **kwargs))
            return _concat_temporal(steps)
        self.set_params(*self.sample_params())
        return self.apply(f, **kwargs)


class Compose(AloTransform):
    """The transforms in turn, each with its own draw."""

    def __init__(self, transforms: List[AloTransform], *args, **kwargs):
        self.transforms = transforms
        super().__init__(*args, **kwargs)

    def sample_params(self):
        return ([t.sample_params() for t in self.transforms],)

    def set_params(self, params):
        for p, t in zip(params, self.transforms):
            t.set_params(*p)

    def apply(self, frame, **kwargs):
        for t in self.transforms:
            frame = t(frame, **kwargs)
        return frame

    def __repr__(self):
        inner = "\n".join(f"    {t}" for t in self.transforms)
        return f"{type(self).__name__}(\n{inner}\n)"


class RandomSelect(AloTransform):
    """``transforms1`` with probability ``p``, else ``transforms2``."""

    def __init__(self, transforms1, transforms2, p: float = 0.5, *a, **kw):
        self.transforms1 = transforms1
        self.transforms2 = transforms2
        self.p_select = p
        super().__init__(*a, **kw)

    def sample_params(self):
        self._r = self._rand()
        return (self._r, self.transforms1.sample_params(),
                self.transforms2.sample_params())

    def set_params(self, _r, p1, p2):
        self._r = _r
        self.transforms1.set_params(*p1)
        self.transforms2.set_params(*p2)

    def apply(self, frame, **kwargs):
        if self._r < self.p_select:
            return self.transforms1(frame, **kwargs)
        return self.transforms2(frame, **kwargs)


class RandomHorizontalFlip(AloTransform):
    def __init__(self, p: float = 0.5, *a, **kw):
        self.p_flip = p
        super().__init__(*a, **kw)
        self.p = 1.0  # gated by the drawn _r

    def sample_params(self):
        self._r = self._rand()
        return (self._r,)

    def set_params(self, _r):
        self._r = _r

    def apply(self, frame, **kwargs):
        return frame.hflip() if self._r < self.p_flip else frame


class RandomVerticalFlip(AloTransform):
    def __init__(self, p: float = 0.5, *a, **kw):
        self.p_flip = p
        super().__init__(*a, **kw)
        self.p = 1.0

    def sample_params(self):
        self._r = self._rand()
        return (self._r,)

    def set_params(self, _r):
        self._r = _r

    def apply(self, frame, **kwargs):
        return frame.vflip() if self._r < self.p_flip else frame


class RandomSizeCrop(AloTransform):
    """A crop of width and height drawn in [min_size, max_size]: pixels for
    ints, fractions of the frame for floats."""

    def __init__(self, min_size, max_size, *a, **kw):
        if type(min_size) is not type(max_size):
            raise TypeError("min_size and max_size must share a type")
        self.min_size = min_size
        self.max_size = max_size
        super().__init__(*a, **kw)

    def sample_params(self):
        if isinstance(self.min_size, int):
            self._w = self._randint(self.min_size, self.max_size)
            self._h = self._randint(self.min_size, self.max_size)
        else:
            self._w = self._uniform(self.min_size, self.max_size)
            self._h = self._uniform(self.min_size, self.max_size)
        self._top = self._rand()
        self._left = self._rand()
        return (self._w, self._h, self._top, self._left)

    def set_params(self, w, h, top, left):
        self._w, self._h, self._top, self._left = w, h, top, left

    def apply(self, frame, **kwargs):
        if isinstance(self._w, float):
            sample_w = int(round(self._w * frame.W))
            sample_h = int(round(self._h * frame.H))
        else:
            sample_w, sample_h = self._w, self._h
        w = min(frame.W, sample_w)
        h = min(frame.H, sample_h)
        top = int(self._top * (frame.H - h + 1))
        left = int(self._left * (frame.W - w + 1))
        return frame.crop((top / frame.H, (top + h) / frame.H),
                          (left / frame.W, (left + w) / frame.W))


class RandomCrop(AloTransform):
    """A crop of fixed ``size`` (H, W) at a random place."""

    def __init__(self, size: Tuple[int, int], *a, **kw):
        self.size = size
        super().__init__(*a, **kw)

    def sample_params(self):
        self._top = self._rand()
        self._left = self._rand()
        return (self._top, self._left)

    def set_params(self, top, left):
        self._top, self._left = top, left

    def apply(self, frame, **kwargs):
        H, W = frame.HW
        h, w = self.size
        top = int(self._top * (H - h + 1))
        left = int(self._left * (W - w + 1))
        return frame.crop((top / H, (top + h) / H), (left / W, (left + w) / W))


class RandomPad(AloTransform):
    """Pad a ``frame_size`` frame up to ``max_size`` with a random split of
    the padding between the sides."""

    def __init__(self, max_size, frame_size, **kw):
        if isinstance(max_size, int):
            max_size = (max_size, max_size)
        self.max_size = max_size
        self.frame_size = frame_size
        super().__init__(**kw)

    def sample_params(self):
        h, w = self.frame_size
        pad_w = max(self.max_size[1] - w, 0)
        pad_h = max(self.max_size[0] - h, 0)
        left = self._randint(0, pad_w)
        top = self._randint(0, pad_h)
        self._pads = (left, pad_w - left, top, pad_h - top)
        return self._pads

    def set_params(self, l, r, t, b):
        self._pads = (l, r, t, b)

    def apply(self, frame, **kwargs):
        l, r, t, b = self._pads
        return frame.pad(offset_y=(t, b), offset_x=(l, r), pad_boxes=True)


class RandomSizePad(RandomPad):
    """``RandomPad`` whose amount of padding is drawn too."""

    def sample_params(self):
        h, w = self.frame_size
        pad_w = self._randint(0, max(self.max_size[1] - w, 0))
        pad_h = self._randint(0, max(self.max_size[0] - h, 0))
        left = self._randint(0, pad_w)
        top = self._randint(0, pad_h)
        self._pads = (left, pad_w - left, top, pad_h - top)
        return self._pads


class RandomResizeWithAspectRatio(AloTransform):
    """Resize so that the shorter side is a size drawn from ``sizes``, the
    longer side at most ``max_size``."""

    def __init__(self, sizes: Sequence[int], max_size: Optional[int] = None,
                 *a, **kw):
        self.sizes = list(sizes)
        self.max_size = max_size
        super().__init__(*a, **kw)

    @staticmethod
    def get_size_with_aspect_ratio(frame: Frame, size: int,
                                   max_size: Optional[int] = None
                                   ) -> Tuple[int, int]:
        h, w = frame.H, frame.W
        if max_size is not None:
            mn, mx = float(min(w, h)), float(max(w, h))
            if mx / mn * size > max_size:
                size = int(round(max_size * mn / mx))
        if (w <= h and w == size) or (h <= w and h == size):
            return (h, w)
        if w < h:
            return (int(size * h / w), size)
        return (size, int(size * w / h))

    def sample_params(self):
        self._size = self.sizes[self._randint(0, len(self.sizes) - 1)]
        return (self._size,)

    def set_params(self, size):
        self._size = size

    def apply(self, frame, **kwargs):
        return frame.resize(
            self.get_size_with_aspect_ratio(frame, self._size, self.max_size))


class Resize(AloTransform):
    def __init__(self, size: Tuple[int, int], *a, **kw):
        if not isinstance(size, tuple):
            raise TypeError("Resize takes an (H, W) tuple")
        self.size = size
        super().__init__(*a, **kw)

    def sample_params(self):
        return (self.size,)

    def set_params(self, size):
        self.size = size

    def apply(self, frame, **kwargs):
        return frame.resize(self.size)


class Rotate(AloTransform):
    """Rotate by ``angle`` degrees counter-clockwise around ``center``."""

    def __init__(self, angle: float, center=None, *a, **kw):
        self.angle = float(angle)
        self.center = center
        super().__init__(*a, **kw)

    def sample_params(self):
        return (self.angle, self.center)

    def set_params(self, angle, center):
        self.angle, self.center = angle, center

    def apply(self, frame, **kwargs):
        return frame.rotate(self.angle, self.center)


def _in_01(frame: Frame, fn) -> Frame:
    """Apply ``fn`` to the frame's pixels in "01" and return the result in
    the frame's normalization."""
    n = frame.norm01()
    out = n._with_array(fn(n.array))
    if out.normalization != frame.normalization:
        out = out.norm_as(frame)
    return out


class RealisticNoise(AloTransform):
    """Gaussian noise plus shot noise that grows with the square of the
    intensity, on the "01" pixels, clipped to [0, 1]."""

    def __init__(self, gaussian_std: float = 0.02, shot_std: float = 0.05,
                 same_on_sequence=False, *a, **kw):
        self.gaussian_std = gaussian_std
        self.shot_std = shot_std
        super().__init__(*a, same_on_sequence=same_on_sequence, **kw)

    def sample_params(self):
        return tuple()

    def set_params(self):
        pass

    def noise(self, std: float, like: torch.Tensor) -> torch.Tensor:
        """N(0, std) noise of ``like``'s shape, drawn on the CPU (a CPU
        generator) and moved to its device."""
        return (torch.randn(like.shape, generator=self.generator) * std).to(
            like.device)

    def apply(self, frame, **kwargs):
        def fn(arr):
            g = self.noise(self.gaussian_std, arr)
            s = self.noise(self.shot_std, arr)
            return torch.clamp(arr + arr * arr * s + g, 0, 1)
        return _in_01(frame, fn)


class CustomRandomColoring(AloTransform):
    """x ** gamma * brightness * a per-channel colour, clipped to [0, 1];
    the frame must be in "01"."""

    def __init__(self, gamma_r=(0.8, 1.2), brightness_r=(0.5, 2.0),
                 colors_r=(0.5, 1.5), *a, **kw):
        self.gamma_r = gamma_r
        self.brightness_r = brightness_r
        self.colors_r = colors_r
        super().__init__(*a, **kw)

    def sample_params(self):
        self.gamma = self._uniform(*self.gamma_r)
        self.brightness = self._uniform(*self.brightness_r)
        self.colors = self._uniform(*self.colors_r, n=3)
        return (self.gamma, self.brightness, self.colors)

    def set_params(self, gamma, brightness, colors):
        self.gamma, self.brightness, self.colors = gamma, brightness, colors

    def apply(self, frame, **kwargs):
        if frame.normalization != "01":
            raise ValueError("normalize to 01 before coloring")
        arr = frame.array ** self.gamma * self.brightness
        c_idx = frame.dim_idx("C")
        n_c = arr.shape[c_idx]
        colors = [float(c) for c in self.colors]
        colors = torch.tensor([colors[i % len(colors)] for i in range(n_c)],
                              dtype=torch.float32).to(arr.device)
        shape = [1] * arr.ndim
        shape[c_idx] = n_c
        return frame._with_array(torch.clamp(arr * colors.reshape(shape), 0,
                                             1).float())


class SpatialShift(AloTransform):
    """Roll the frame by fractions drawn in [size[0], size[1]] of its height
    and width, the uncovered band filled with the mean colour."""

    def __init__(self, size: Tuple[float, float], *a, **kw):
        if not isinstance(size, tuple):
            raise TypeError("SpatialShift takes a (min, max) tuple")
        self.size = size
        super().__init__(*a, **kw)

    def sample_params(self):
        self.percentage = self._uniform(self.size[0], self.size[1], n=2)
        return (self.percentage,)

    def set_params(self, percentage):
        self.percentage = percentage

    def apply(self, frame, **kwargs):
        return frame.spatial_shift(float(self.percentage[0]),
                                   float(self.percentage[1]))


_GREY_WEIGHTS = (0.299, 0.587, 0.114)


class GrayScale(AloTransform):
    """Luma (0.299 R + 0.587 G + 0.114 B) in every channel."""

    def sample_params(self):
        return tuple()

    def set_params(self):
        pass

    def apply(self, frame, **kwargs):
        c_idx = frame.dim_idx("C")

        def fn(arr):
            shape = [1] * arr.ndim
            shape[c_idx] = 3
            w = torch.tensor(_GREY_WEIGHTS, dtype=torch.float32).to(
                arr.device).reshape(shape)
            grey = (arr * w).sum(c_idx, keepdim=True)
            return grey.expand(arr.shape).contiguous()
        return _in_01(frame, fn)


# OpenCV's float32 RGB <-> HSV (color_hsv.simd.hpp, H in [0, 360))
_FLT_EPSILON = 1.1920928955078125e-07


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> (..., 3) HSV, H in [0, 360), as
    ``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` on float32."""
    r, g, b = img.unbind(-1)
    v = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = v - vmin
    s = diff / (v.abs() + _FLT_EPSILON)
    k = 60.0 / (diff + _FLT_EPSILON)
    h = torch.where(v == r, (g - b) * k,
                    torch.where(v == g, (b - r) * k + 120.0,
                                (r - g) * k + 240.0))
    h = torch.where(h < 0, h + 360.0, h)
    return torch.stack([h, s, v], -1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of ``rgb_to_hsv``, as ``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)``
    on float32: the sextant of H picks which of v, v(1-s), v(1-s f),
    v(1-s(1-f)) each channel takes."""
    h, s, v = hsv.unbind(-1)
    h = torch.fmod(h * (6.0 / 360.0), 6.0)
    h = torch.where(h < 0, h + 6.0, h)
    sector = torch.floor(h)
    f = h - sector
    sector = sector.long()
    bad = (sector < 0) | (sector >= 6)
    sector = torch.where(bad, torch.zeros_like(sector), sector)
    f = torch.where(bad, torch.zeros_like(f), f)
    tab = torch.stack([v, v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))],
                      -1)
    # sector -> (index of b, g, r) in tab
    idx = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                        [2, 1, 0]], device=hsv.device)[sector]
    bgr = torch.gather(tab, -1, idx)
    rgb = bgr.flip(-1)
    return torch.where((s == 0)[..., None], v[..., None].expand_as(rgb), rgb)


class ColorJitter(AloTransform):
    """Brightness, contrast, saturation and hue jitter, in a drawn order, on
    the "01" pixels of each image."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1,
                 *a, **kw):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        super().__init__(*a, **kw)

    def sample_params(self):
        def _f(v, center=1.0):
            return self._uniform(max(0, center - v), center + v)
        self._b = _f(self.brightness)
        self._c = _f(self.contrast)
        self._s = _f(self.saturation)
        self._h = self._uniform(-self.hue, self.hue)
        self._order = torch.randperm(4, generator=self.generator).tolist()
        return (self._b, self._c, self._s, self._h, self._order)

    def set_params(self, b, c, s, h, order):
        self._b, self._c, self._s, self._h, self._order = b, c, s, h, order

    def _jitter(self, im: torch.Tensor) -> torch.Tensor:
        """One (H, W, 3) image."""
        for op in self._order:
            if op == 0:
                im = torch.clamp(im * self._b, 0, 1)
            elif op == 1:
                mean = im.mean()
                im = torch.clamp((im - mean) * self._c + mean, 0, 1)
            elif op == 2:
                w = torch.tensor(_GREY_WEIGHTS, dtype=torch.float32).to(
                    im.device)
                g = (im @ w)[..., None]
                im = torch.clamp((im - g) * self._s + g, 0, 1)
            else:
                hsv = rgb_to_hsv(im)
                hue = torch.remainder(hsv[..., 0] + self._h * 360, 360)
                im = torch.clamp(hsv_to_rgb(torch.stack(
                    [hue, hsv[..., 1], hsv[..., 2]], -1)), 0, 1)
        return im

    def apply(self, frame, **kwargs):
        lead = tuple(x for x in frame.names if x not in ("H", "W", "C"))
        layout = lead + ("H", "W", "C")

        def fn(arr):
            hwc = frame._with_array(arr).as_layout(layout)
            imgs = hwc.reshape((-1,) + tuple(hwc.shape[-3:]))
            out = torch.stack([self._jitter(im) for im in imgs]).reshape(
                hwc.shape)
            inv = [layout.index(x) for x in frame.names]
            return out.permute(inv).contiguous().float()
        return _in_01(frame, fn)


class RandomDownScale(AloTransform):
    """Resize down to a size drawn between ``min_size`` and the frame's."""

    def __init__(self, min_size: Tuple[int, int], preserve_ratio: bool = False,
                 *a, **kw):
        self.min_size = min_size
        self.preserve_ratio = preserve_ratio
        super().__init__(*a, **kw)

    def sample_params(self):
        self._h_coef = self._rand()
        self._w_coef = self._h_coef if self.preserve_ratio else self._rand()
        return (self._h_coef, self._w_coef)

    def set_params(self, h_coef, w_coef):
        self._h_coef, self._w_coef = h_coef, w_coef

    def apply(self, frame, **kwargs):
        H, W = frame.HW
        mh, mw = self.min_size
        h = int(mh + self._h_coef * max(H - mh, 0))
        w = int(mw + self._w_coef * max(W - mw, 0))
        if self.preserve_ratio:
            ratio = min(h / H, w / W)
            h, w = int(H * ratio), int(W * ratio)
        return frame.resize((max(h, 1), max(w, 1)))


class RandomDownScaleCrop(Compose):
    """Downscale, then crop back to ``size``."""

    def __init__(self, size: Tuple[int, int], preserve_ratio: bool = False,
                 *a, **kw):
        super().__init__([
            RandomDownScale(size, preserve_ratio, *a, **kw),
            RandomCrop(size, *a, **kw)], *a, **kw)


class DynamicCropTransform(AloTransform):
    """A ``crop_size`` crop around the ``center=`` given at call time
    (fractions as floats, pixels as ints), kept inside the frame."""

    def __init__(self, crop_size: Tuple[int, int], *a, **kw):
        self.crop_size = crop_size
        super().__init__(*a, **kw)

    def sample_params(self):
        return (self.crop_size,)

    def set_params(self, size):
        self.crop_size = size

    def apply(self, frame, center=(0.5, 0.5), **kwargs):
        H, W = frame.HW
        h, w = self.crop_size
        cy = center[0] * H if isinstance(center[0], float) else center[0]
        cx = center[1] * W if isinstance(center[1], float) else center[1]
        top = int(min(max(cy - h / 2, 0), H - h))
        left = int(min(max(cx - w / 2, 0), W - w))
        return frame.crop((top / H, (top + h) / H), (left / W, (left + w) / W))


def _box_blur_1d(arr: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Box mean of ``size`` samples along ``axis``, edges replicated, by
    differences of a float32 running sum (the JAX package's formula)."""
    if size <= 1:
        return arr
    lo, hi = size // 2, size - size // 2 - 1
    n = arr.shape[axis]
    idx = torch.arange(-lo, n + hi, device=arr.device).clamp(0, n - 1)
    a = arr.index_select(axis, idx)
    c = torch.cumsum(a, axis, dtype=torch.float32)
    lead = c.narrow(axis, size - 1, n)
    lag = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)),
                     c.narrow(axis, 0, n - 1)], axis)
    return (lead - lag) / size


class RandomFocusBlur(AloTransform):
    """Box blur of a drawn width along W and height along H."""

    def __init__(self, max_filter_size: int = 10, *a, **kw):
        self.max_filter_size = max_filter_size
        super().__init__(*a, **kw)

    def sample_params(self):
        self._h = self._randint(1, self.max_filter_size)
        self._v = self._randint(1, self.max_filter_size)
        return (self._h, self._v)

    def set_params(self, h, v):
        self._h, self._v = h, v

    def apply(self, frame, **kwargs):
        arr = frame.array.float()
        arr = _box_blur_1d(arr, self._h, frame.dim_idx("W"))
        arr = _box_blur_1d(arr, self._v, frame.dim_idx("H"))
        return frame._with_array(arr)


class RandomFocusBlurV2(RandomFocusBlur):
    """The blur blended with the sharp image by min(h, v) / max size."""

    def apply(self, frame, **kwargs):
        blurred = super().apply(frame, **kwargs)
        alpha = min(self._h, self._v) / max(self.max_filter_size, 1)
        arr = (1 - alpha) * frame.array.float() + alpha * blurred.array
        return frame._with_array(arr.float())


class RandomFocusBlurV3(RandomFocusBlurV2):
    """V2 whose vertical size is 1 half of the time."""

    def sample_params(self):
        self._h = self._randint(1, self.max_filter_size)
        self._v = 1 if self._rand() < 0.5 else self._randint(
            1, self.max_filter_size)
        return (self._h, self._v)


def motion_kernel(size: int, angle: float) -> torch.Tensor:
    """A (size, size) line kernel through the centre at ``angle`` radians,
    normalised to sum 1."""
    kernel = torch.zeros((size, size), dtype=torch.float32)
    c = size // 2
    cos, sin = math.cos(angle), math.sin(angle)
    for i in range(size):
        x = int(round(c + (i - c) * cos))
        y = int(round(c + (i - c) * sin))
        if 0 <= x < size and 0 <= y < size:
            kernel[y, x] = 1.0
    return kernel / max(float(kernel.sum()), 1.0)


def filter2d_reflect101(img: torch.Tensor, kernel: torch.Tensor
                        ) -> torch.Tensor:
    """``cv2.filter2D(img, -1, kernel)`` of a (C, H, W) float image: the
    correlation with the kernel anchored at its centre, borders reflected
    without repeating the edge (BORDER_REFLECT_101)."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    x = F.pad(img[:, None], (ax, kw - 1 - ax, ay, kh - 1 - ay),
              mode="reflect")
    return F.conv2d(x, kernel.to(img)[None, None])[:, 0]


class RandomFlowMotionBlur(AloTransform):
    """Motion blur along the direction of the frame's mean optical flow,
    with a line kernel of drawn length."""

    def __init__(self, max_kernel_size: int = 15, *a, **kw):
        self.max_kernel_size = max_kernel_size
        super().__init__(*a, **kw)

    def sample_params(self):
        self._strength = self._rand()
        return (self._strength,)

    def set_params(self, strength):
        self._strength = strength

    def apply(self, frame, **kwargs):
        flow = frame.get_child("flow")
        if flow is None or isinstance(flow, dict):
            return frame
        fl = flow.array.double()
        angle = float(torch.atan2(fl[1].mean(), fl[0].mean()))
        size = max(int(self._strength * self.max_kernel_size), 1)
        if size <= 1 or frame.ndim != 3:
            return frame
        chw = frame.as_layout(("C", "H", "W")).float()
        blurred = filter2d_reflect101(chw, motion_kernel(size, angle))
        inv = [("C", "H", "W").index(x) for x in frame.names]
        return frame._with_array(blurred.permute(inv).contiguous())


class RandomCornersMask(AloTransform):
    """Zero the pixels nearer to a corner than a drawn fraction of the
    shorter side (fisheye vignetting, WoodScape)."""

    def __init__(self, max_radius_ratio: float = 0.5, *a, **kw):
        self.max_radius_ratio = max_radius_ratio
        super().__init__(*a, **kw)

    def sample_params(self):
        self._ratio = self._uniform(0, self.max_radius_ratio)
        return (self._ratio,)

    def set_params(self, ratio):
        self._ratio = ratio

    def apply(self, frame, **kwargs):
        H, W = frame.HW
        r = self._ratio * min(H, W)
        if r < 1:
            return frame
        dev = frame.device
        ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
        xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
        corners = torch.stack([
            torch.sqrt(ys ** 2 + xs ** 2),
            torch.sqrt(ys ** 2 + (W - 1 - xs) ** 2),
            torch.sqrt((H - 1 - ys) ** 2 + xs ** 2),
            torch.sqrt((H - 1 - ys) ** 2 + (W - 1 - xs) ** 2)])
        keep = (corners.amin(0) >= r).float()
        shape = [1] * frame.ndim
        shape[frame.dim_idx("H")], shape[frame.dim_idx("W")] = H, W
        return frame._with_array(frame.array.float() * keep.reshape(shape))


class IRAugmentation(Compose):
    """Infrared-like augmentation: grey, sensor noise, a light blur."""

    def __init__(self, *a, generator: Optional[torch.Generator] = None, **kw):
        super().__init__([
            GrayScale(generator=generator),
            RealisticNoise(gaussian_std=0.03, shot_std=0.08,
                           generator=generator),
            RandomFocusBlurV2(max_filter_size=5, generator=generator),
        ], *a, generator=generator, **kw)
