"""Quantization for deployment (counterpart of
``aloception_tpu/export/quantization.py``; reference:
alonet/torch2trt/calibrator.py:10-241 DataBatchStreamer and the INT8
calibrators, quantization.py:12 QuantizedModel).

- weights-only int8: per-output-channel absmax scales of the weights the
  JAX package quantizes (its 2-D ``Dense`` kernels: here the ``nn.Linear``
  weights outside ``nn.MultiheadAttention``), dequantized into a state dict;
- activation calibration: a ``DataBatchStreamer`` feeds batches through a
  function whose returned activations the calibrators observe (min-max, and
  the histogram strategies percentile and entropy), giving static int8
  scales;
- QAT: straight-through fake quantization of every kernel the JAX package
  fake-quantizes, in the JAX package's groups.

The calibrators' algorithms are this package's own numpy copies.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]


def _int8_weight_names(model: nn.Module) -> List[str]:
    """Names of the weights that correspond to flax ``Dense`` kernels (2-D
    ``kernel`` leaves): ``nn.Linear`` weights, except those inside an
    ``nn.MultiheadAttention``, whose flax counterpart holds 3-D
    ``DenseGeneral`` kernels. ``nn.Embedding`` weights are flax
    ``embedding`` leaves, not kernels."""
    inside_mha = {f"{name}.{sub}" if name else sub
                  for name, m in model.named_modules()
                  if isinstance(m, nn.MultiheadAttention)
                  for sub, _ in m.named_modules()}
    return [f"{name}.weight" for name, m in model.named_modules(
        remove_duplicate=False)
            if isinstance(m, nn.Linear) and name not in inside_mha]


def quantize_weights_int8(model: nn.Module, min_size: int = 1024
                          ) -> Tuple[Dict[str, Any], Callable]:
    """Per-output-channel absmax int8 quantization of the large weights that
    the JAX package quantizes (``_int8_weight_names``, at least
    ``min_size`` elements): each row of a torch (out, in) weight gets the
    scale max|row| / 127 (axis 0 of the flax (in, out) kernel).

    Returns (the model's state dict with {"q": int8 (out, in), "scale":
    float32 (out, 1)} in place of those weights, ``dequant``, which gives a
    dense float32 state dict for ``load_state_dict``).
    """
    names = set(_int8_weight_names(model))
    quantized: Dict[str, Any] = {}
    for name, x in model.state_dict().items():
        if name in names and x.dim() == 2 and x.numel() >= min_size:
            x = x.float()
            scale = x.abs().amax(dim=1, keepdim=True) / 127.0
            scale = torch.where(scale == 0, torch.ones_like(scale), scale)
            q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            quantized[name] = {"q": q, "scale": scale}
        else:
            quantized[name] = x

    def dequant(tree: Dict[str, Any]) -> StateDict:
        return {k: v["q"].float() * v["scale"] if isinstance(v, dict) else v
                for k, v in tree.items()}
    return quantized, dequant


def quantization_error(model: nn.Module, quantized: Dict[str, Any],
                       dequant: Callable) -> float:
    """Max relative reconstruction error over the 2-D tensors."""
    dense = dequant(quantized)
    errs = []
    for name, a in model.state_dict().items():
        if a.dim() == 2:
            a = a.float()
            denom = a.abs().max().item() or 1.0
            errs.append((a - dense[name].float()).abs().max().item() / denom)
    return max(errs) if errs else 0.0


class DataBatchStreamer:
    """(calibrator.py:10 DataBatchStreamer) iterate calibration batches: a
    dataset's ``train_loader`` in order, or a plain iterable of ready-made
    batches, at most ``max_batches``, each through ``prepare``."""

    def __init__(self, dataset, batch_size: int = 1, max_batches: int = 8,
                 prepare: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_batches = max_batches
        self.prepare = prepare

    def __iter__(self) -> Iterator:
        if hasattr(self.dataset, "train_loader"):
            loader = self.dataset.train_loader(batch_size=self.batch_size,
                                               shuffle=False)
        else:
            loader = iter(self.dataset)
        for i, batch in enumerate(loader):
            if i >= self.max_batches:
                break
            yield self.prepare(batch) if self.prepare else batch


def _calibrate(calibrator, fn: Callable, streamer: DataBatchStreamer,
               names: Optional[List[str]]) -> Dict[str, float]:
    """Run ``fn`` over the streamer; ``fn`` returns {name: activation} to
    observe."""
    for batch in streamer:
        for k, v in fn(batch).items():
            if names is None or k in names:
                calibrator.observe(k, v)
    return calibrator.scales()


class MinMaxCalibrator:
    """(calibrator.py:133 TRTCalibratorMinMax analog) collect activation
    absmax ranges over calibration data."""

    def __init__(self):
        self.ranges: Dict[str, float] = {}

    def observe(self, name: str, value):
        v = float(torch.as_tensor(value).abs().max())
        self.ranges[name] = max(self.ranges.get(name, 0.0), v)

    def scales(self, bits: int = 8) -> Dict[str, float]:
        qmax = 2 ** (bits - 1) - 1
        return {k: (v / qmax if v > 0 else 1.0) for k, v in self.ranges.items()}

    def calibrate(self, fn: Callable, streamer: DataBatchStreamer,
                  names: Optional[List[str]] = None) -> Dict[str, float]:
        return _calibrate(self, fn, streamer, names)


class HistogramCalibrator:
    """Histogram-based calibrator base (the reference's Legacy/Entropy/
    Entropy2 calibrators collect histograms first, calibrator.py:160-241):
    a per-tensor |x| histogram whose range doubles, folding pairs of bins,
    until it holds the largest value seen."""

    def __init__(self, num_bins: int = 2048):
        self.num_bins = num_bins
        self.hists: Dict[str, np.ndarray] = {}
        self.ranges: Dict[str, float] = {}

    def observe(self, name: str, value):
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy()
        v = np.abs(np.asarray(value, np.float32)).ravel()
        vmax = float(v.max(initial=0.0))
        if vmax == 0.0 and name not in self.hists:
            return
        if name not in self.hists:
            self.hists[name] = np.zeros(self.num_bins, np.int64)
            self.ranges[name] = max(vmax, 1e-12)
        while vmax > self.ranges[name]:
            h = self.hists[name]
            folded = h.reshape(self.num_bins // 2, 2).sum(1)
            self.hists[name] = np.concatenate(
                [folded, np.zeros(self.num_bins - self.num_bins // 2,
                                  np.int64)])
            self.ranges[name] *= 2
        hist, _ = np.histogram(v, bins=self.num_bins,
                               range=(0.0, self.ranges[name]))
        self.hists[name] += hist

    def calibrate(self, fn: Callable, streamer: DataBatchStreamer,
                  names: Optional[List[str]] = None) -> Dict[str, float]:
        return _calibrate(self, fn, streamer, names)

    def scales(self, bits: int = 8) -> Dict[str, float]:
        raise NotImplementedError


class PercentileCalibrator(HistogramCalibrator):
    """Scale from the p-th percentile of |activation|: clips the extreme
    tail that would otherwise waste the int8 range."""

    def __init__(self, percentile: float = 99.9, num_bins: int = 2048):
        super().__init__(num_bins)
        self.percentile = percentile

    def scales(self, bits: int = 8) -> Dict[str, float]:
        qmax = 2 ** (bits - 1) - 1
        out = {}
        for k, h in self.hists.items():
            total = h.sum()
            if total == 0:
                out[k] = 1.0
                continue
            cdf = np.cumsum(h) / total
            idx = int(np.searchsorted(cdf, self.percentile / 100.0))
            idx = min(idx, self.num_bins - 1)
            amax = (idx + 1) / self.num_bins * self.ranges[k]
            out[k] = amax / qmax if amax > 0 else 1.0
        return out


class EntropyCalibrator(HistogramCalibrator):
    """KL-divergence-minimising clip point (TensorRT's entropy calibration,
    the reference's TRTCalibratorEntropy* analog, calibrator.py:192-241):
    the threshold whose quantised distribution diverges least from the
    observed one."""

    def scales(self, bits: int = 8) -> Dict[str, float]:
        qmax = 2 ** (bits - 1) - 1
        levels = 2 ** (bits - 1)
        out = {}
        for k, h in self.hists.items():
            if h.sum() == 0:
                out[k] = 1.0
                continue
            h = h.astype(np.float64)
            best_i, best_kl = self.num_bins, np.inf
            for i in range(levels, self.num_bins + 1, levels // 2):
                p = h[:i].copy()
                p[-1] += h[i:].sum()          # the clipped tail's mass
                if p.sum() == 0:
                    continue
                # the first i bins quantised to `levels` buckets, then
                # spread back over their nonzero source bins
                idx = (np.arange(i) / (i / levels)).astype(int)
                q_small = np.bincount(idx, weights=h[:i], minlength=levels)
                nz = h[:i] > 0
                nz_per_bucket = np.bincount(idx, weights=nz.astype(float),
                                            minlength=levels)
                spread = np.where(nz_per_bucket[idx] > 0,
                                  q_small[idx] / np.maximum(
                                      nz_per_bucket[idx], 1), 0.0)
                q = np.where(nz, spread, 0.0)
                qs = q.sum()
                if qs == 0:
                    continue
                pn, qn = p / p.sum(), q / qs
                mask = pn > 0
                kl = float(np.sum(pn[mask] * np.log(
                    pn[mask] / np.maximum(qn[mask], 1e-12))))
                if kl < best_kl:
                    best_kl, best_i = kl, i
            amax = best_i / self.num_bins * self.ranges[k]
            out[k] = amax / qmax if amax > 0 else 1.0
        return out


def fake_quant(x: torch.Tensor, bits: int = 8, axis=-1) -> torch.Tensor:
    """Straight-through fake quantisation, the QAT building block
    (reference: torch2trt/quantization.py:12 QuantizedModel): absmax scales
    over ``axis`` (an int or a tuple), values rounded to ``bits``; the
    gradient is the identity."""
    qmax = 2.0 ** (bits - 1) - 1
    scale = x.abs().amax(dim=axis, keepdim=True) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax) * scale
    return x + (q - x).detach()


def _qat_fake_quant(module: nn.Module, x: torch.Tensor, bits: int,
                    min_size: int) -> torch.Tensor:
    """``x`` fake-quantised in the groups that the JAX package's
    ``quantize_params_for_qat`` uses for the flax kernel it corresponds to:
    every axis but the last of the flax kernel is reduced over.

    - ``nn.Linear`` (flax Dense (in, out), or the attention output
      DenseGeneral (heads, head_dim, out)) and ``nn.Conv2d`` (flax Conv
      (kH, kW, I, O)): one scale per output channel, dim 0 of the torch
      weight.
    - ``nn.MultiheadAttention.in_proj_weight``: the query, key and value
      DenseGeneral kernels (in, heads, head_dim) are reduced over in and
      heads, so the scale is shared by the rows of the same head_dim index
      in every head, each of the three blocks on its own.
    """
    if isinstance(module, nn.MultiheadAttention):
        heads, d = module.num_heads, module.embed_dim
        if d * d < min_size:
            return x
        blocks = x.view(3, heads, d // heads, d)
        return fake_quant(blocks, bits, axis=(1, 3)).view_as(x)
    if x.numel() < min_size:
        return x
    return fake_quant(x, bits, axis=tuple(range(1, x.dim())))


def quantize_params_for_qat(model: nn.Module, bits: int = 8,
                            min_size: int = 1024) -> StateDict:
    """The model's parameters with every large kernel fake-quantised
    (``_qat_fake_quant``), to simulate int8 deployment during finetuning:
    pass them to ``torch.func.functional_call(model, params, inputs)``.
    Gradients reach the original parameters straight through."""
    out: StateDict = {}
    for mod_name, module in model.named_modules():
        for p_name, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            kernel = (isinstance(module, (nn.Linear, nn.Conv2d))
                      and p_name == "weight") or (
                isinstance(module, nn.MultiheadAttention)
                and p_name == "in_proj_weight")
            out[name] = _qat_fake_quant(module, p, bits, min_size) \
                if kernel else p
    return out
