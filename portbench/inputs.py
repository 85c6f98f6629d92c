"""The general traffic generator: what a cell's traffic file describes,
made from the seed. Sizes (object counts, frame sizes) come from a table
that is the same for every seed, drawn from the file's ``sizes_seed``; the
seed orders them and draws everything else (pixels, boxes, classes), so
every seed asks for the same work in another order. Pixels are drawn on
the device in one call and brought to the host, where the traffic hands
them to the program. Plain tensors only: the drivers wrap them in the
program's types."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % 2**63)


def _device_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    return g


def object_counts(spec: Dict, n: int, sizes_seed: int) -> np.ndarray:
    """``n`` object counts in [min, max], geometric with mean ``mean``
    (COCO's images hold about 7 objects, a long tail of crowded ones)."""
    rng = _rng(sizes_seed)
    p = 1.0 / spec["mean"]
    out = []
    while len(out) < n:
        k = int(rng.geometric(p))
        if spec["min"] <= k <= spec["max"]:
            out.append(k)
    return np.array(out)


def boxes(rng: np.random.Generator, n: int, spec: Dict) -> np.ndarray:
    """``n`` relative (cx, cy, w, h) boxes inside the image: centres
    uniform in [margin, 1 - margin], sides log-uniform in [lo, hi]."""
    m = spec["margin"]
    c = rng.uniform(m, 1 - m, size=(n, 2))
    side = np.exp(rng.uniform(np.log(spec["side"][0]), np.log(spec["side"][1]),
                              size=(n, 2)))
    side = np.minimum(side, 2 * np.minimum(c, 1 - c))
    return np.concatenate([c, side], 1).astype(np.float32)


def train_pool(traffic: Dict, seed: int, device) -> List[Dict]:
    """``pool_batches`` raw batches of ``batch_size`` images: pixels in
    [0, 255] as float32 CHW on the host, with their boxes and classes."""
    B, (H, W) = traffic["batch_size"], traffic["image_size"]
    n_img = traffic["pool_batches"] * B
    rng = _rng(seed)
    counts = rng.permutation(object_counts(traffic["objects"], n_img,
                                           traffic["sizes_seed"]))
    pixels = torch.randint(0, 256, (n_img, 3, H, W), device=device,
                           generator=_device_generator(seed, device),
                           dtype=torch.uint8).float().cpu()
    pool = []
    for i in range(traffic["pool_batches"]):
        items = []
        for j in range(i * B, (i + 1) * B):
            n = int(counts[j])
            items.append({
                "pixels": pixels[j],
                "boxes": torch.from_numpy(boxes(rng, n, traffic["boxes"])),
                "labels": torch.from_numpy(rng.integers(
                    0, traffic["classes"], size=n).astype(np.int64))})
        pool.append(items)
    return pool


def frame_sizes(traffic: Dict, n: int) -> np.ndarray:
    rng = _rng(traffic["sizes_seed"])
    h = rng.integers(traffic["frame_h"][0], traffic["frame_h"][1] + 1, n)
    w = rng.integers(traffic["frame_w"][0], traffic["frame_w"][1] + 1, n)
    return np.stack([h, w], 1)


def frame_pool(traffic: Dict, seed: int, device) -> List[List[torch.Tensor]]:
    """``pool_batches`` batches of ``batch_size`` uint8 CHW frames on the
    host, of the sizes of ``frame_sizes`` in the seed's order."""
    B = traffic["batch_size"]
    n = traffic["pool_batches"] * B
    sizes = _rng(seed).permutation(frame_sizes(traffic, n))
    hmax, wmax = traffic["frame_h"][1], traffic["frame_w"][1]
    block = torch.randint(0, 256, (n, 3, hmax, wmax), device=device,
                          generator=_device_generator(seed, device),
                          dtype=torch.uint8).cpu()
    frames = [block[i, :, :h, :w].clone() for i, (h, w) in enumerate(sizes)]
    return [frames[i * B:(i + 1) * B] for i in range(traffic["pool_batches"])]
