"""RAFT's yardstick: the FLOPs of a served pair, counted on the plain
reference, and the least bytes of one correlation lookup. Both are the
algorithm's, whatever implements RAFT."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def flops_per_pair(cfg, hw: Sequence[int], iters: int) -> int:
    """FLOPs of the reference's forward on one pair of frames of ``hw``, at
    its padded size, with ``iters`` steps: its convolutions and matrix
    products as ``FlopCounterMode`` counts them on the meta device (the
    lookup's interpolation and the upsampling's combination count none)."""
    from torch.utils.flop_counter import FlopCounterMode
    from .models import raft
    from .nn import Precision
    from .weights import meta_weights
    p = meta_weights(raft.param_specs(cfg))
    H, W = raft.padded_hw(hw)
    image = torch.empty(1, 3, H, W, device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        raft.forward(p, image, image, cfg, Precision("float32"), iters)
    return int(counter.get_total_flops())


def level_sizes(hw8: Sequence[int], levels: int) -> List[Tuple[int, int]]:
    """(h, w) of each level of the correlation pyramid over a 1/8 map of
    ``hw8``: 2x2 average pools of stride 2, the odd row or column dropped."""
    out = [tuple(hw8)]
    while len(out) < levels:
        out.append((out[-1][0] // 2, out[-1][1] // 2))
    return out


def lookup_bytes(B: int, hw8: Sequence[int], levels: int, radius: int,
                 dtype: torch.dtype) -> int:
    """The least bytes one lookup moves: each output written once in
    float32 (B * L * (2r+1)^2 * N of them, N = h * w queries), and for each
    query and level the (2r+2)^2 pyramid values that its window's bilinear
    corners touch, read once in the pyramid's ``dtype``, at most the
    level's size."""
    n = hw8[0] * hw8[1]
    d = 2 * radius + 1
    item = torch.empty((), dtype=dtype).element_size()
    out = B * levels * d * d * n * 4
    touched = sum(min((d + 1) ** 2, h * w)
                  for h, w in level_sizes(hw8, levels))
    return out + B * n * touched * item
