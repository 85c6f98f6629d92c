"""Augmented arrays: the core labeled-data structure (counterpart of
``aloception_tpu/aloscene/augmented.py``).

A plain Python container, not a ``torch.Tensor`` subclass, holding

- ``array``      -- the payload, a ``torch.Tensor`` on any device
- ``names``      -- named dims ("B","T","C","H","W","N", or None)
- *properties*   -- metadata (normalization, box format, ...)
- *children*     -- labels that transform together with the parent

Geometric ops (hflip/vflip/resize/rotate/crop/pad/spatial_shift) return new
objects and recurse into the children; a child that cannot follow an op
(its ``_op`` raises ``NotImplementedError``) is carried over unchanged. ``.to()``, ``.cpu()`` and ``clone()`` recurse
too. Payloads stay on their device: nothing here copies to the host except
``as_numpy``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def as_tensor(x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Tensor of ``x``: tensors keep their device and dtype (unless ``dtype``
    is given); numpy float64 and Python numbers become float32."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    if not isinstance(x, np.ndarray):
        x = np.asarray(x, dtype=np.float32)
    elif x.dtype == np.float64:
        x = x.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def const(values, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device. The copy is non-blocking: a
    blocking host-to-device copy would wait for the stream to drain."""
    return torch.tensor(values, dtype=torch.float32).to(like.device,
                                                        non_blocking=True)


def _bool_index(idx) -> bool:
    return isinstance(idx, (np.ndarray, torch.Tensor)) and \
        idx.dtype in (np.bool_, torch.bool)


class AugmentedArray:
    """Base class for all augmented array types: named dims, properties,
    children that transform with the parent, merge machinery, recursive
    geometric ops."""

    def __init__(self, x, names: Optional[Sequence[Optional[str]]] = None,
                 dtype: Optional[torch.dtype] = None):
        if isinstance(x, AugmentedArray):
            x = x.array
        x = as_tensor(x, dtype)
        self.array = x
        if names is None:
            names = (None,) * x.ndim
        names = tuple(names)
        if len(names) != x.ndim:
            raise ValueError(
                f"names {names} do not match array rank {x.ndim} "
                f"(shape {tuple(x.shape)})")
        self._names: Tuple[Optional[str], ...] = names
        self._properties: Dict[str, Any] = {}
        self._children: Dict[str, Any] = {}
        self._child_meta: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------------
    # properties / children declaration
    # ------------------------------------------------------------------
    def add_property(self, name: str, value: Any):
        self._properties[name] = value

    def add_child(self, name: str, value: Any = None,
                  align_dim: Sequence[str] = ("B", "T"),
                  mergeable: bool = True):
        """Declare a child slot (a label that transforms with the parent)."""
        self._child_meta[name] = {"align_dim": tuple(align_dim),
                                  "mergeable": mergeable}
        if name not in self._children:
            self._children[name] = None
        if value is not None:
            if isinstance(value, dict):
                for k, v in value.items():
                    self._append_child(name, v, k)
            else:
                self._append_child(name, value)

    def _append_child(self, name: str, value: Any,
                      set_name: Optional[str] = None):
        """Attach a child, optionally into a named set."""
        if name not in self._child_meta:
            self.add_child(name, None)
        cur = self._children.get(name)
        if set_name is None:
            if cur is None:
                self._children[name] = value
            elif isinstance(cur, dict):
                raise ValueError(f"child '{name}' holds a named set; an "
                                 "explicit name is required")
            else:
                raise ValueError(f"an unnamed '{name}' child is already "
                                 "attached; use a name")
        elif cur is None:
            self._children[name] = {set_name: value}
        elif isinstance(cur, dict):
            cur[set_name] = value
        else:
            raise ValueError(f"child '{name}' already holds an unnamed value; "
                             "cannot mix named and unnamed children")

    def get_children(self) -> Dict[str, Any]:
        return dict(self._children)

    def set_children(self, children: Dict[str, Any]):
        for k, v in children.items():
            if k not in self._child_meta:
                self.add_child(k, None)
            self._children[k] = v
        return self

    def drop_children(self) -> Dict[str, Any]:
        """Detach and return all children."""
        children = dict(self._children)
        for k in self._children:
            self._children[k] = None
        return children

    def get_child(self, name: str):
        return self._children.get(name)

    @staticmethod
    def apply_on_child(child, fn: Callable, on_list: bool = True):
        """Apply ``fn`` on a child slot, mapping over named sets and lists."""
        if child is None:
            return None
        if isinstance(child, dict):
            return {k: AugmentedArray.apply_on_child(v, fn, on_list)
                    for k, v in child.items()}
        if isinstance(child, list) and on_list:
            return [AugmentedArray.apply_on_child(v, fn, on_list)
                    for v in child]
        return fn(child)

    def recursive_apply_on_children(self, fn: Callable) -> "AugmentedArray":
        """Replace every child with fn(child), recursing."""
        def _apply(c):
            return fn(c).recursive_apply_on_children(fn)
        for name in self._children:
            self._children[name] = self.apply_on_child(self._children[name],
                                                        _apply)
        return self

    # ------------------------------------------------------------------
    # attribute sugar: properties and children are readable/writable attrs
    # ------------------------------------------------------------------
    def __getattr__(self, name: str):
        # only called when normal lookup fails
        if name.startswith("_"):
            raise AttributeError(name)
        props = self.__dict__.get("_properties")
        if props is not None and name in props:
            return props[name]
        children = self.__dict__.get("_children")
        if children is not None and name in children:
            return children[name]
        raise AttributeError(f"{type(self).__name__} has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any):
        if not name.startswith("_") and name != "array":
            props = self.__dict__.get("_properties")
            if props is not None and name in props:
                props[name] = value
                return
            children = self.__dict__.get("_children")
            if children is not None and name in children:
                children[name] = value
                return
        object.__setattr__(self, name, value)

    # ------------------------------------------------------------------
    # tensor surface
    # ------------------------------------------------------------------
    @property
    def names(self) -> Tuple[Optional[str], ...]:
        return self._names

    @property
    def shape(self):
        return tuple(self.array.shape)

    @property
    def ndim(self) -> int:
        return self.array.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.array.dtype

    @property
    def device(self) -> torch.device:
        return self.array.device

    def size(self, name: str) -> int:
        return self.shape[self.dim_idx(name)]

    def dim_idx(self, name: str) -> int:
        try:
            return self._names.index(name)
        except ValueError:
            raise ValueError(f"dim '{name}' not in names {self._names}")

    def has_dim(self, name: str) -> bool:
        return name in self._names

    def get_slices(self, dim_slices: Dict[str, Any], default=slice(None)
                   ) -> Tuple:
        """Indexing tuple from named-dim slices."""
        return tuple(dim_slices.get(n, default) if n is not None else default
                     for n in self._names)

    def as_array(self) -> torch.Tensor:
        """The raw payload tensor."""
        return self.array

    def as_numpy(self) -> np.ndarray:
        """Host copy of the payload (synchronises with the device)."""
        return self.array.detach().cpu().numpy()

    def _map_tensors(self, fn: Callable[[torch.Tensor], torch.Tensor]
                     ) -> "AugmentedArray":
        """New container with ``fn`` applied to the payload and, recursively,
        to every child's tensors; the container structure is copied."""
        new = self._with_array(fn(self.array))
        new._children = {
            k: self.apply_on_child(
                v, lambda c: c._map_tensors(fn)
                if isinstance(c, AugmentedArray) else c)
            for k, v in self._children.items()}
        return new

    def to(self, device=None, dtype: Optional[torch.dtype] = None
           ) -> "AugmentedArray":
        """Move payload and children to ``device``; cast floating-point
        payloads (this one's and the children's) to ``dtype``."""
        def move(t):
            if dtype is not None and t.is_floating_point():
                return t.to(device=device, dtype=dtype)
            return t.to(device=device)
        return self._map_tensors(move)

    def cpu(self) -> "AugmentedArray":
        return self.to("cpu")

    def clone(self) -> "AugmentedArray":
        """Recursive copy: payloads, children and container structure."""
        return self._map_tensors(torch.clone)

    def _with_array(self, array, names: Optional[Tuple] = None
                    ) -> "AugmentedArray":
        """Same type, new payload, same metadata and children."""
        obj = object.__new__(type(self))
        obj.array = array
        obj._names = self._names if names is None else tuple(names)
        obj._properties = dict(self._properties)
        obj._child_meta = {k: dict(v) for k, v in self._child_meta.items()}
        obj._children = dict(self._children)
        return obj

    # arithmetic keeps metadata and children
    def _binop(self, other, fn):
        o = other.array if isinstance(other, AugmentedArray) else other
        return self._with_array(fn(self.array, o))

    def __add__(self, o): return self._binop(o, lambda a, b: a + b)
    def __radd__(self, o): return self._binop(o, lambda a, b: b + a)
    def __sub__(self, o): return self._binop(o, lambda a, b: a - b)
    def __rsub__(self, o): return self._binop(o, lambda a, b: b - a)
    def __mul__(self, o): return self._binop(o, lambda a, b: a * b)
    def __rmul__(self, o): return self._binop(o, lambda a, b: b * a)
    def __truediv__(self, o): return self._binop(o, lambda a, b: a / b)
    def __rtruediv__(self, o): return self._binop(o, lambda a, b: b / a)
    def __neg__(self): return self._with_array(-self.array)

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        props = ", ".join(f"{k}={v}" for k, v in self._properties.items())
        kids = {k: type(v).__name__ for k, v in self._children.items()
                if v is not None}
        return (f"{type(self).__name__}(shape={self.shape}, "
                f"names={self._names}, device={self.device}"
                + (f", {props}" if props else "")
                + (f", children={kids}" if kids else "") + ")")

    # ------------------------------------------------------------------
    # getitem with child propagation
    # ------------------------------------------------------------------
    def __getitem__(self, idx):
        if _bool_index(idx):
            # boolean mask over the leading dim: filter, and filter the
            # children aligned with it
            idx = torch.as_tensor(idx, device=self.device)
            new = self._with_array(self.array[idx])

            def _filter(c):
                if isinstance(c, AugmentedArray) and c.shape[0] == len(idx):
                    return c[idx]
                return c
            new._children = {k: self.apply_on_child(v, _filter)
                             for k, v in self._children.items()}
            return new

        if isinstance(idx, (int, slice)):
            idx = (idx,)
        if not isinstance(idx, tuple):
            raise TypeError(f"unsupported index {idx!r}")

        new_array = self.array[idx]
        # new names: ints drop dims
        n_names: List[Optional[str]] = []
        dim = 0
        for sl in idx:
            if sl is Ellipsis:
                n_skip = self.ndim - (len(idx) - 1)
                n_names.extend(self._names[dim:dim + n_skip])
                dim += n_skip
            elif isinstance(sl, int):
                dim += 1
            else:
                n_names.append(self._names[dim])
                dim += 1
        n_names.extend(self._names[dim:])
        new = self._with_array(new_array, names=tuple(n_names))

        def _slice_slot(v, k):
            if v is None:
                return None
            if isinstance(v, dict):  # named set: recurse per name
                return {kk: _slice_slot(vv, k) for kk, vv in v.items()}
            return self._getitem_child(v, k, idx)

        new._children = {k: _slice_slot(v, k)
                         for k, v in self._children.items()}
        return new

    def _getitem_child(self, child, child_name: str, idx):
        """Propagate parent indexing to a child. Children aligned on B/T
        share those leading dims with the parent, in the same order; an
        int/slice on an aligned parent dim is applied at the child's
        corresponding leading dim. Unaligned dims are skipped."""
        meta = self._child_meta[child_name]
        child_dim = 0
        out = child
        parent_dim = 0
        for sl in (idx if isinstance(idx, tuple) else (idx,)):
            if sl is Ellipsis:
                parent_dim += self.ndim - (len(idx) - 1)
                continue
            name = self._names[parent_dim]
            parent_dim += 1
            if name not in meta["align_dim"]:
                continue
            trivial = isinstance(sl, slice) and sl == slice(None)
            if not trivial:
                if isinstance(out, list):
                    out = out[sl]
                    if isinstance(sl, slice):
                        child_dim += 1
                    continue
                if isinstance(out, AugmentedArray):
                    out = out[(slice(None),) * child_dim + (sl,)]
            if isinstance(sl, slice):
                child_dim += 1
        return out

    # ------------------------------------------------------------------
    # recursive geometric ops
    # ------------------------------------------------------------------
    def _children_op_kwargs(self, op: str, kwargs: dict) -> dict:
        """Extra context injected into child geometric ops; spatial parents
        add frame_size."""
        return kwargs

    def hflip(self, **kwargs):
        """Horizontal flip of self and all children."""
        ck = self._children_op_kwargs("_hflip", kwargs)
        flipped = self._hflip(**kwargs)
        flipped.recursive_apply_on_children(
            lambda c: _child_op(c, "_hflip", **ck))
        return flipped

    def vflip(self, **kwargs):
        ck = self._children_op_kwargs("_vflip", kwargs)
        flipped = self._vflip(**kwargs)
        flipped.recursive_apply_on_children(
            lambda c: _child_op(c, "_vflip", **ck))
        return flipped

    def resize(self, size: Tuple[int, int], **kwargs):
        """Resize to absolute (H, W); children receive the relative ratio."""
        h, w = size
        size01 = (h / self.H, w / self.W)
        resized = self._resize(size01, **kwargs)
        resized.recursive_apply_on_children(
            lambda c: _child_op(c, "_resize", size01, **kwargs))
        return resized

    def rotate(self, angle: float, center=None, **kwargs):
        """Rotate by ``angle`` degrees counter-clockwise around ``center``
        (absolute (x, y); default the frame's centre)."""
        rotated = self._rotate(angle, center, **kwargs)
        rotated.recursive_apply_on_children(
            lambda c: _child_op(c, "_rotate", angle, center, **kwargs))
        return rotated

    def crop(self, H_crop: Tuple[float, float], W_crop: Tuple[float, float],
             **kwargs):
        """Relative crop in [0, 1] on both axes."""
        if H_crop[0] < 0.0 or H_crop[1] > 1.0:
            raise ValueError(f"H_crop must be within [0, 1], got {H_crop}")
        if W_crop[0] < 0.0 or W_crop[1] > 1.0:
            raise ValueError(f"W_crop must be within [0, 1], got {W_crop}")
        ck = self._children_op_kwargs("_crop", kwargs)
        cropped = self._crop(H_crop, W_crop, **kwargs)
        cropped.recursive_apply_on_children(
            lambda c: _child_op(c, "_crop", H_crop, W_crop, **ck))
        return cropped

    def pad(self, offset_y=None, offset_x=None, multiple: Optional[int] = None,
            **kwargs):
        """Pad by relative offsets (top, bottom) / (left, right), or to the
        next multiple. Int offsets are converted to relative ones."""
        if multiple is not None:
            if offset_x is not None or offset_y is not None:
                raise ValueError("pad takes offsets or multiple, not both")

            def _mult_off(dim):
                if dim % multiple == 0:
                    return (0.0, 0.0)
                rem = multiple - dim % multiple
                return (rem // 2 / dim, (rem + 1) // 2 / dim)
            offset_y = _mult_off(self.H)
            offset_x = _mult_off(self.W)
        else:
            if offset_x is None or offset_y is None:
                raise ValueError("pad needs offset_y and offset_x")
            if all(isinstance(o, (int, np.integer)) for o in offset_y):
                offset_y = (offset_y[0] / self.H, offset_y[1] / self.H)
            if all(isinstance(o, (int, np.integer)) for o in offset_x):
                offset_x = (offset_x[0] / self.W, offset_x[1] / self.W)
        ck = self._children_op_kwargs("_pad", kwargs)
        padded = self._pad(offset_y, offset_x, **kwargs)
        padded.recursive_apply_on_children(
            lambda c: _child_op(c, "_pad", offset_y, offset_x, **ck))
        return padded

    def spatial_shift(self, shift_y: float, shift_x: float, **kwargs):
        shifted = self._spatial_shift(shift_y, shift_x, **kwargs)
        shifted.recursive_apply_on_children(
            lambda c: _child_op(c, "_spatial_shift", shift_y, shift_x,
                                **kwargs))
        return shifted

    # default per-type implementations raise; subclasses override
    def _hflip(self, **kwargs): raise NotImplementedError(type(self).__name__)
    def _vflip(self, **kwargs): raise NotImplementedError(type(self).__name__)
    def _resize(self, size01, **kwargs):
        raise NotImplementedError(type(self).__name__)
    def _rotate(self, angle, center=None, **kwargs):
        raise NotImplementedError(type(self).__name__)
    def _crop(self, H_crop, W_crop, **kwargs):
        raise NotImplementedError(type(self).__name__)
    def _pad(self, offset_y, offset_x, **kwargs):
        raise NotImplementedError(type(self).__name__)
    def _spatial_shift(self, sy, sx, **kwargs):
        raise NotImplementedError(type(self).__name__)


def _child_op(child: AugmentedArray, op: str, *args, **kwargs):
    """Apply a geometric sub-op on a child, tolerating children that do not
    implement it."""
    fn = getattr(child, op, None)
    if fn is None:
        return child
    try:
        return fn(*args, **kwargs)
    except NotImplementedError:
        return child
