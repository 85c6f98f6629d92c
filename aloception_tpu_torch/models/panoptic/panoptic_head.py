"""Panoptic segmentation head over a DETR-family detector (counterpart of
``aloception_tpu/models/panoptic/panoptic_head.py``).

- ``MHAttentionMap``: per-query multi-head attention scores over the encoder
  memory, one softmax over heads and space jointly; no value projection.
- ``MaskHeadSmallConv``: FPN-style conv stack fusing the detector's
  projected C5 map and the attention maps with the backbone's layer3/2/1
  features, one mask logit map per query at stride 4.
- ``PanopticHead`` reads the detector's ``return_intermediate`` dict and
  adds ``pred_masks``; ``DetrPanoptic`` is a detector and the head in one
  module, under the reference ``state_dict`` names (``detr.*``,
  ``bbox_attention.{q,k}_linear``, ``mask_head.lay{1..5}``,
  ``mask_head.gn{1..5}``, ``mask_head.adapter{1..3}``,
  ``mask_head.out_lay``).
- ``inference_with_masks``: per image ``BoundingBoxes2D`` and ``Mask``,
  computed on the tensors' device.

Work that depends on the image only runs once per image: the projected C5
map's share of lay1's convolution and the three FPN adapters are computed
on the B backbone maps and added to each of the image's Nq query maps by
broadcasting. These are the sums of the reference, which convolves the
query-repeated tensors, with Nq times fewer operations.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...aloscene import BoundingBoxes2D, Mask
from ..detr.detr import boxes_of_kept, kept_queries
from ..transformers import GroupNorm, init_parameters

GN_EPS = 1e-5


class MHAttentionMap(nn.Module):
    """q (B, Nq, C), k (B, H, W, C) -> softmax attention maps (B, Nq, nH, H,
    W)."""

    def __init__(self, hidden_dim: int = 256, num_heads: int = 8,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.q_linear = nn.Linear(hidden_dim, hidden_dim, device=device)
        self.k_linear = nn.Linear(hidden_dim, hidden_dim, device=device)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask: (B, H, W), 1 = padded. The scores are float32 (exact
        products of the projections), padded positions take -1e9, and the
        maps are cast to q's dtype after the softmax."""
        B, Nq, _ = q.shape
        H, W = k.shape[1], k.shape[2]
        nH = self.num_heads
        qh = self.q_linear(q).float().reshape(B, Nq, nH, -1)
        kh = self.k_linear(k).float().reshape(B, H * W, nH, -1)
        scores = torch.einsum("bqnc,bpnc->bqnp", qh, kh) / math.sqrt(
            qh.shape[-1])
        if mask is not None:
            scores = scores.masked_fill(mask.reshape(B, 1, 1, H * W) > 0.5,
                                        -1e9)
        # one softmax over heads and space jointly, as the reference
        attn = scores.reshape(B, Nq, nH * H * W).softmax(-1)
        return attn.reshape(B, Nq, nH, H, W).to(q.dtype)


def _add_per_image(x: torch.Tensor, per_image: torch.Tensor) -> torch.Tensor:
    """x (B * Nq, c, h, w) += per_image (B, c, h, w), image b's map added to
    its queries b * Nq ... b * Nq + Nq - 1, in place."""
    B = per_image.shape[0]
    x.unflatten(0, (B, -1)).add_(per_image.unsqueeze(1))
    return x


class MaskHeadSmallConv(nn.Module):
    """Conv stack with FPN lateral adds. ``dim`` is the input plane's width
    (hidden + heads), which lay1 keeps; then hidden/2, /4, /8, /16. Each
    convolution is followed by GroupNorm(gcd(8, width)) and a ReLU."""

    def __init__(self, dim: int, hidden_dim: int = 256,
                 fpn_dims: Sequence[int] = (1024, 512, 256), device=None):
        super().__init__()
        d = hidden_dim
        dims = [dim, d // 2, d // 4, d // 8, d // 16]
        for i in range(5):
            cin = dims[max(i - 1, 0)]
            self.add_module(f"lay{i + 1}", nn.Conv2d(cin, dims[i], 3,
                                                     padding=1, device=device))
            self.add_module(f"gn{i + 1}", GroupNorm(
                math.gcd(8, dims[i]), dims[i], eps=GN_EPS, device=device))
        self.out_lay = nn.Conv2d(dims[4], 1, 3, padding=1, device=device)
        for i, cin in enumerate(fpn_dims):
            self.add_module(f"adapter{i + 1}", nn.Conv2d(cin, dims[i + 1], 1,
                                                         device=device))

    def forward(self, src: torch.Tensor, attn: torch.Tensor,
                fpns: List[torch.Tensor]) -> torch.Tensor:
        """src (B, C, H, W): the projected C5 map; attn (B, Nq, nH, H, W):
        the attention maps; fpns: layer3, layer2, layer1 maps (B, Ci, Hi,
        Wi), coarse to fine. 4-d tensors are NCHW, with any strides.
        Returns (B, Nq, H1, W1) mask logits at layer1's size.

        The input plane is cat([src repeated over queries, attn]); lay1's
        convolution of it is the sum of its src channels' convolution of
        src, once per image, and its attn channels' convolution of attn."""
        B, Nq, nH, H, W = attn.shape
        C = src.shape[1]
        w = self.lay1.weight
        x = F.conv2d(attn.reshape(B * Nq, nH, H, W), w[:, C:], padding=1)
        x = _add_per_image(x, F.conv2d(src, w[:, :C], self.lay1.bias,
                                       padding=1))
        x = F.relu(self.gn1(x))
        x = F.relu(self.gn2(self.lay2(x)))
        for i, fpn in enumerate(fpns):
            cur = getattr(self, f"adapter{i + 1}")(fpn)
            # jax.image.resize "nearest" samples at half-pixel centres
            x = F.interpolate(x, size=cur.shape[-2:], mode="nearest-exact")
            x = _add_per_image(x, cur)
            x = F.relu(getattr(self, f"gn{i + 3}")(
                getattr(self, f"lay{i + 3}")(x)))
        x = self.out_lay(x)
        return x.reshape(B, Nq, x.shape[-2], x.shape[-1])


class PanopticHead(nn.Module):
    """Consumes the detector's ``return_intermediate`` dict and returns it
    with ``pred_masks`` (B, Nq, H/4, W/4) added."""

    def __init__(self, hidden_dim: int = 256, num_heads: int = 8,
                 fpn_dims: Sequence[int] = (1024, 512, 256), device=None):
        super().__init__()
        self.bbox_attention = MHAttentionMap(hidden_dim, num_heads,
                                             device=device)
        self.mask_head = MaskHeadSmallConv(hidden_dim + num_heads, hidden_dim,
                                           fpn_dims, device=device)

    def forward(self, m_outputs: Dict) -> Dict:
        hs = m_outputs["dec_outputs"][-1]                     # (B, Nq, C)
        # Deformable-DETR exposes its C5 level's memory as
        # enc_outputs_spatial; DETR's memory is spatial already
        memory = m_outputs.get("enc_outputs_spatial",
                               m_outputs["enc_outputs"])      # (B, H, W, C)
        attn = self.bbox_attention(hs, memory, m_outputs.get("feat_mask"))
        src = m_outputs.get("proj_src", memory).permute(0, 3, 1, 2)
        # bb_outputs are fine to coarse (layer1-3); the head reads coarse
        # to fine
        fpns = [f.permute(0, 3, 1, 2)
                for f in reversed(m_outputs["bb_outputs"])]
        out = dict(m_outputs)
        out["pred_masks"] = self.mask_head(src, attn, fpns)
        return out


class DetrPanoptic(PanopticHead):
    """A DETR-family detector built with ``return_intermediate`` (held as
    ``detr``) and the panoptic head, which takes the detector's width,
    heads, device, dtype and mode.

    ``detector=None`` builds DETR-R50 (100 queries, ``num_classes``) in
    ``dtype``: on the CUDA card unless ``device`` names another, raising
    with no card, as ``detr_r50`` does. The head's parameters are drawn from
    ``generator`` (after the detector's, when it builds one; a fresh one
    seeded with 0 when None). ``freeze_detector`` runs the detector without
    gradients, so that only the head trains: no autograd graph is kept for
    the detector, and its MSDA calls take no backward pass. The detector
    keeps its module's mode (its dropout acts in train mode), as the JAX
    package's frozen detector does."""

    def __init__(self, detector: Optional[nn.Module] = None,
                 num_classes: int = 250, freeze_detector: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        if detector is None:
            from ..detr import detr_r50
            detector = detr_r50(num_classes=num_classes, dtype=dtype,
                                device=device, generator=generator,
                                return_intermediate=True)
        if not detector.return_intermediate:
            raise ValueError("the detector must be built with "
                             "return_intermediate=True")
        ref = detector.query_embed.weight
        super().__init__(detector.hidden_dim, detector.nheads,
                         device=ref.device)
        if generator is None:
            generator = torch.Generator(device=ref.device).manual_seed(0)
        init_parameters(self.bbox_attention, generator)
        init_parameters(self.mask_head, generator)
        # the head's parameters stay NCHW-contiguous, so its activations
        # do: PyTorch's GroupNorm on CUDA reads and writes contiguous
        # tensors, and channels_last ones paid a layout copy around it
        for head in (self.bbox_attention, self.mask_head):
            head.to(dtype=ref.dtype)
        self.detr = detector
        self.freeze_detector = freeze_detector
        self.train(detector.training)

    def forward(self, images: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Dict:
        """images (B, H, W, 3) normalised; mask (B, H, W), 1 = padded."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_detector):
            out = self.detr(images, mask)
        return super().forward(out)


def inference_with_masks(m_outputs: Dict, threshold: float = 0.0,
                         background_class: Optional[int] = None,
                         activation_fn: str = "softmax",
                         mask_threshold: float = 0.5,
                         frame_size: Optional[Tuple[int, int]] = None
                         ) -> List[Tuple[BoundingBoxes2D, Mask]]:
    """Per image (BoundingBoxes2D, Mask), both with ``Labels`` carrying the
    scores, for the same kept queries.

    ``activation_fn`` "softmax": a query is kept when its argmax class is
    not ``background_class`` (the last class when None) and its score
    exceeds ``threshold``; "sigmoid": when its best class score exceeds
    ``threshold``. The kept masks are sigmoided, bilinearly upsampled
    (half-pixel centres, no antialias) to ``frame_size`` (H, W) when given,
    and thresholded at ``mask_threshold``. The one host sync is the copy of
    the keep mask; the kept queries are gathered and upsampled on the
    device."""
    logits = m_outputs["pred_logits"].float()
    if activation_fn == "softmax":
        scores, labels = logits.softmax(-1).max(-1)
        bg = logits.shape[-1] - 1 if background_class is None \
            else background_class
        keep = (labels != bg) & (scores > threshold)
    else:
        scores, labels = logits.sigmoid().max(-1)
        keep = scores > threshold
    kept = kept_queries(keep, logits.device)
    counts, b_idx, q_idx = kept
    dets = boxes_of_kept(m_outputs["pred_boxes"], labels, scores, *kept)

    masks = m_outputs["pred_masks"][b_idx, q_idx].float().sigmoid()
    if frame_size is not None and tuple(masks.shape[1:]) != tuple(frame_size):
        size = (int(frame_size[0]), int(frame_size[1]))
        masks = F.interpolate(masks[None], size=size, mode="bilinear",
                              align_corners=False, antialias=False)[0] \
            if len(masks) else masks.new_zeros((0,) + size)
    masks = (masks > mask_threshold).float()
    return [(d, Mask(m, labels=d.labels.clone()))
            for d, m in zip(dets, masks.split(counts))]
