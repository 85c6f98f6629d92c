"""BoundingBoxes2D: N x 4 boxes in xcyc/xyxy/yxyx x absolute/relative state
(counterpart of ``aloception_tpu/aloscene/bounding_boxes_2d.py``).

Format and position converters, area, IoU/GIoU/NMS (through
``ops/boxes.py``), and the geometric ops (hflip/vflip/resize/crop/pad/
spatial_shift), including the padded_size bookkeeping (fit_to_padded_size /
remove_padding) of the DETR training pipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..ops import boxes as box_ops
from .augmented import AugmentedArray, const
from .labels import Labels

FORMATS = box_ops.FORMATS


class BoundingBoxes2D(AugmentedArray):

    def __init__(self, x, boxes_format: str, absolute: bool,
                 labels: Union[dict, Labels, None] = None,
                 frame_size: Optional[Tuple[int, int]] = None,
                 names=("N", None), **kwargs):
        super().__init__(x, names=names, **kwargs)
        if boxes_format not in FORMATS:
            raise ValueError(f"format '{boxes_format}' not in {FORMATS}")
        if absolute and frame_size is None:
            raise ValueError("absolute boxes require frame_size")
        if frame_size is not None and len(frame_size) != 2:
            raise ValueError(f"frame_size must be (H, W), got {frame_size}")
        self.add_property("boxes_format", boxes_format)
        self.add_property("absolute", absolute)
        self.add_property("padded_size", None)
        self.add_property("frame_size",
                          tuple(frame_size) if frame_size is not None else None)
        self.add_child("labels", labels, align_dim=["N"], mergeable=True)

    def append_labels(self, labels: Labels, name: Optional[str] = None):
        self._append_child("labels", labels, name)

    # colour of a label id (id % 300) in the boxes' views
    _GLOBAL_COLOR_SET = np.random.RandomState(7).uniform(0, 1, (300, 3))

    def __get_view__(self, frame=None, frame_size=None, title=None,
                     labels_set=None, **kwargs):
        """Boxes drawn onto ``frame`` (a float [0, 1] HWC image; black of
        ``frame_size``, the boxes' own or 300x300 without one), computed on
        the host (bounding_boxes_2d.py:428 get_view): box by box, the label
        name (or id) and score, then a 2-pixel rectangle in the label's
        colour (green without labels)."""
        from .renderer import View, put_adaptive_cv2_text
        from .renderer.draw import rectangle
        host = self.cpu()
        if frame is None:
            if frame_size is None and not host.absolute:
                frame_size = (300, 300)
            fs = frame_size or host.frame_size
            frame = np.zeros((int(fs[0]), int(fs[1]), 3), np.float32)
        fs = (frame.shape[0], frame.shape[1])
        boxes = host.abs_pos(fs).xyxy()
        arr = boxes.as_numpy().reshape(-1, 4)
        labels = boxes.get_child("labels")
        if isinstance(labels, dict):
            labels = labels.get(labels_set) if labels_set else \
                next(iter(labels.values()))
        lab = labels.as_numpy().astype(int) if labels is not None else None
        scores = labels.scores if labels is not None else None
        if scores is not None:
            scores = scores.numpy()
        img = (np.clip(np.ascontiguousarray(frame), 0, 1) * 255
               ).astype(np.uint8)
        for i, (x1, y1, x2, y2) in enumerate(arr):
            if lab is not None and i < len(lab):
                color = tuple(int(255 * c) for c in
                              self._GLOBAL_COLOR_SET[lab[i] % 300])
                names = labels.labels_names
                text = names[lab[i]] if names and lab[i] < len(names) \
                    else str(lab[i])
                if scores is not None:
                    text += f" {float(scores[i]):.2f}"
                put_adaptive_cv2_text(img, text, x1, max(y1 - 3, 10), color)
            else:
                color = (0, 255, 0)
            rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)), color, 2)
        return View(img.astype(np.float32) / 255.0, title=title)

    def get_view(self, frame=None, **kwargs):
        return self.__get_view__(frame=frame, **kwargs)

    # ------------------------------------------------------------------
    # format conversions
    # ------------------------------------------------------------------
    def _converted(self, dst_format: str) -> "BoundingBoxes2D":
        n = self.clone()
        if n.boxes_format == dst_format:
            return n
        n.array = box_ops.convert_format(n.array, n.boxes_format, dst_format)
        n.boxes_format = dst_format
        return n

    def xcyc(self): return self._converted("xcyc")
    def xyxy(self): return self._converted("xyxy")
    def yxyx(self): return self._converted("yxyx")

    def get_with_format(self, boxes_format: str):
        if boxes_format not in FORMATS:
            raise ValueError(f"format '{boxes_format}' not in {FORMATS}")
        return self._converted(boxes_format)

    def _scale_vec(self, frame_size) -> torch.Tensor:
        h, w = frame_size
        if self.boxes_format in ("xcyc", "xyxy"):
            return const([w, h, w, h], self.array)
        return const([h, w, h, w], self.array)

    def abs_pos(self, frame_size: Tuple[int, int]) -> "BoundingBoxes2D":
        """Boxes in absolute pixel coordinates of frame_size."""
        n = self.clone()
        frame_size = tuple(frame_size)
        if n.absolute and frame_size != n.frame_size:
            n.array = n.array / n._scale_vec(n.frame_size)
            n.absolute = False
        if not n.absolute:
            n.array = n.array * n._scale_vec(frame_size)
            n.frame_size = frame_size
            n.absolute = True
        return n

    def rel_pos(self) -> "BoundingBoxes2D":
        n = self.clone()
        if n.absolute:
            n.array = n.array / n._scale_vec(n.frame_size)
        n.absolute = False
        n.frame_size = None
        return n

    # ------------------------------------------------------------------
    # area / iou / giou / nms
    # ------------------------------------------------------------------
    def _area(self) -> torch.Tensor:
        b = self.array
        if self.boxes_format == "xcyc":
            return b[..., 2] * b[..., 3]
        return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])

    def area(self) -> torch.Tensor:
        return self._area()

    def abs_area(self, frame_size: Optional[Tuple[int, int]] = None):
        if self.absolute:
            return self._area()
        if frame_size is None:
            raise ValueError("relative boxes need frame_size for abs_area")
        return self.abs_pos(frame_size)._area()

    def rel_area(self):
        return self.rel_pos()._area() if self.absolute else self._area()

    def _same_state(self, boxes2: "BoundingBoxes2D"):
        b1 = self.xyxy()
        b2 = boxes2.xyxy()
        if b2.absolute != b1.absolute and b1.absolute:
            b2 = b2.abs_pos(b1.frame_size)
        elif b2.absolute != b1.absolute and not b1.absolute:
            b2 = b2.rel_pos()
        return b1, b2

    def iou_with(self, boxes2: "BoundingBoxes2D", ret_union: bool = False):
        b1, b2 = self._same_state(boxes2)
        return box_ops.iou_xyxy(b1.array, b2.array, ret_union=ret_union)

    def giou_with(self, boxes2: "BoundingBoxes2D") -> torch.Tensor:
        b1, b2 = self._same_state(boxes2)
        return box_ops.giou_xyxy(b1.array, b2.array)

    def nms(self, scores, iou_threshold: float = 0.5) -> torch.Tensor:
        """Indices kept by NMS, sorted by decreasing score."""
        order, keep = box_ops.nms_xyxy(
            self.xyxy().array,
            torch.as_tensor(scores, device=self.device), iou_threshold)
        return order[keep]

    # ------------------------------------------------------------------
    # geometric ops
    # ------------------------------------------------------------------
    def _flip(self, axis: int):
        absolute, frame_size, fmt = (self.absolute, self.frame_size,
                                     self.boxes_format)
        boxes = self.rel_pos().xcyc()
        cols = list(boxes.array.unbind(-1))
        cols[axis] = 1.0 - cols[axis]
        boxes.array = torch.stack(cols, -1)
        if absolute:
            boxes = boxes.abs_pos(frame_size)
        return boxes.get_with_format(fmt)

    def _hflip(self, **kwargs):
        return self._flip(0)

    def _vflip(self, **kwargs):
        return self._flip(1)

    def _resize(self, size01, **kwargs):
        boxes = self.clone()
        if not boxes.absolute:
            return boxes  # relative coords are resize-invariant
        abs_size = tuple(s * fs for s, fs in zip(size01, boxes.frame_size))
        return boxes.abs_pos(abs_size)

    def _rotate(self, angle, center=None, **kwargs):
        raise NotImplementedError("BoundingBoxes2D cannot be exactly rotated")

    def _crop(self, H_crop, W_crop, **kwargs):
        """Crop, clamp and drop empty boxes (a data-dependent shape: syncs
        with the host)."""
        if self.padded_size is not None:
            raise RuntimeError("cannot crop padded boxes; call "
                               "fit_to_padded_size() first")
        absolute, frame_size, fmt = (self.absolute, self.frame_size,
                                     self.boxes_format)

        n_boxes = self.abs_pos((100, 100)).xyxy()
        h = (H_crop[1] - H_crop[0]) * 100
        w = (W_crop[1] - W_crop[0]) * 100
        x, y = W_crop[0] * 100, H_crop[0] * 100

        arr = n_boxes.array - const([x, y, x, y], n_boxes.array)
        arr = torch.minimum(arr, const([w, h, w, h], arr))
        n_boxes.array = arr.clamp(min=0)
        n_boxes.frame_size = (h, w)
        n_boxes = n_boxes[n_boxes._area() > 0]

        n_boxes = n_boxes.rel_pos()
        if absolute:
            n_frame_size = ((H_crop[1] - H_crop[0]) * frame_size[0],
                            (W_crop[1] - W_crop[0]) * frame_size[1])
            n_boxes = n_boxes.abs_pos(n_frame_size)
        return n_boxes.get_with_format(fmt)

    def _shift_by_offset(self, offset_y, offset_x):
        """Translate boxes by a top/left pad and grow frame_size (shared by
        _pad(pad_boxes=True) and fit_to_padded_size)."""
        if not self.absolute:
            boxes = self.abs_pos((100, 100)).xcyc()
            h_shift = boxes.frame_size[0] * offset_y[0]
            w_shift = boxes.frame_size[1] * offset_x[0]
            boxes.array = boxes.array + const([[w_shift, h_shift, 0, 0]],
                                              boxes.array)
            boxes.frame_size = (100 * (1.0 + offset_y[0] + offset_y[1]),
                                100 * (1.0 + offset_x[0] + offset_x[1]))
            boxes = boxes.get_with_format(self.boxes_format)
            return boxes.rel_pos()
        boxes = self.xcyc()
        h_shift = boxes.frame_size[0] * offset_y[0]
        w_shift = boxes.frame_size[1] * offset_x[0]
        boxes.array = boxes.array + const([[w_shift, h_shift, 0, 0]],
                                          boxes.array)
        boxes.frame_size = (
            boxes.frame_size[0] * (1.0 + offset_y[0] + offset_y[1]),
            boxes.frame_size[1] * (1.0 + offset_x[0] + offset_x[1]))
        return boxes.get_with_format(self.boxes_format)

    def _pad(self, offset_y, offset_x, pad_boxes: bool = False, **kwargs):
        """By default boxes are NOT moved: the pad is recorded in
        ``padded_size``, so that transformer pipelines can mask the padded
        area while the targets stay in the unpadded coordinate system. With
        pad_boxes=True, boxes are translated into the padded frame."""
        if not pad_boxes:
            n_boxes = self.clone()
            if n_boxes.padded_size is not None:
                pr = self.frame_size if n_boxes.absolute else (1, 1)
                ps = n_boxes.padded_size
                prev = (((ps[0][0] * pr[0]), (ps[0][1] * pr[0])),
                        ((ps[1][0] * pr[1]), (ps[1][1] * pr[1])))
                tot_h = prev[0][0] + prev[0][1] + pr[0]
                tot_w = prev[1][0] + prev[1][1] + pr[1]
                n_ps = ((prev[0][0] + offset_y[0] * tot_h,
                         prev[0][1] + offset_y[1] * tot_h),
                        (prev[1][0] + offset_x[0] * tot_w,
                         prev[1][1] + offset_x[1] * tot_w))
                n_ps = ((n_ps[0][0] / pr[0], n_ps[0][1] / pr[0]),
                        (n_ps[1][0] / pr[1], n_ps[1][1] / pr[1]))
            else:
                n_ps = ((offset_y[0], offset_y[1]), (offset_x[0], offset_x[1]))
            n_boxes.padded_size = n_ps
            return n_boxes

        if self.padded_size is not None:
            raise RuntimeError("pad(pad_boxes=True) on already-padded boxes "
                               "unsupported; call fit_to_padded_size() first")
        return self._shift_by_offset(offset_y, offset_x)

    def fit_to_padded_size(self):
        """Translate boxes into the padded coordinate system recorded by
        _pad(pad_boxes=False)."""
        if self.padded_size is None:
            raise RuntimeError("no padded_size recorded")
        ps = self.padded_size
        boxes = self._shift_by_offset((ps[0][0], ps[0][1]),
                                      (ps[1][0], ps[1][1]))
        boxes.padded_size = None
        return boxes

    def remove_padding(self):
        n = self.clone()
        n.padded_size = None
        return n

    def _spatial_shift(self, shift_y: float, shift_x: float, **kwargs):
        if self.padded_size is not None:
            raise RuntimeError("cannot shift padded boxes; call "
                               "fit_to_padded_size() first")
        fmt, absolute, frame_size = (self.boxes_format, self.absolute,
                                     self.frame_size)
        n = self.rel_pos().xcyc()
        arr = n.array + const([[shift_x, shift_y, 0, 0]], n.array)
        n.array = arr.clamp(min=0.0, max=1.0)
        n = n[n._area() > 0]
        if absolute:
            n = n.abs_pos(frame_size)
        return n.get_with_format(fmt)

    def as_boxes(self, boxes: "BoundingBoxes2D") -> "BoundingBoxes2D":
        """Match another boxes' format/absolute/padded state."""
        n = self.clone()
        if boxes.absolute and not n.absolute:
            n = n.abs_pos(boxes.frame_size)
        elif not boxes.absolute and n.absolute:
            n = n.rel_pos()
        n = n.get_with_format(boxes.boxes_format)
        if boxes.padded_size is not None:
            n.padded_size = boxes.padded_size
        return n
