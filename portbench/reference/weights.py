"""The detectors' weights, made by the benchmark from the seed on the
device in a few large calls, and handed alike to the program and to the
reference.

Inits, by the spec's name: ``lecun`` N(0, 1 / fan_in) (flax's default for
kernels), ``normal`` N(0, 1) (embeddings), ``xavier`` uniform over
+-sqrt(6 / (d_out / 3 + d_in)) (a packed attention projection),
``zeros``, ``ones``, and ``msda_grid:nH,L,P`` (published Deformable-DETR's
offset bias)."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch


def _numel(shape: Sequence[int]) -> int:
    return math.prod(shape)


def make_weights(specs: List, seed: int, dtype: torch.dtype,
                 device) -> Dict[str, torch.Tensor]:
    """{name: tensor of ``dtype`` on ``device``}: one normal draw and one
    uniform draw from a generator seeded with ``seed`` on ``device``, cut
    and scaled per tensor."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    n_normal = sum(_numel(s) for _, s, i in specs if i in ("lecun", "normal"))
    n_uniform = sum(_numel(s) for _, s, i in specs if i == "xavier")
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    out, a, b = {}, 0, 0
    for name, shape, init in specs:
        n = _numel(shape)
        if init in ("lecun", "normal"):
            t = normal[a:a + n].view(shape)
            a += n
            if init == "lecun":
                t.mul_(1.0 / math.sqrt(_numel(shape[1:])))
        elif init == "xavier":
            t = uniform[b:b + n].view(shape)
            b += n
            bound = math.sqrt(6.0 / (shape[0] // 3 + shape[1]))
            t.mul_(2 * bound).sub_(bound)
        elif init in ("zeros", "ones"):
            t = torch.full(shape, float(init == "ones"), device=device)
        elif init.startswith("msda_grid:"):
            from .models.deformable_detr import grid_bias
            t = grid_bias(*map(int, init.split(":")[1].split(","))).to(
                device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
        out[name] = t if dtype == torch.float32 else t.to(dtype)
    return out


def meta_weights(specs: List) -> Dict[str, torch.Tensor]:
    return {name: torch.empty(shape, device="meta")
            for name, shape, _ in specs}


def program_state(weights: Dict[str, torch.Tensor], keys: Sequence[str],
                  aliases: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """The weights under the program's ``state_dict`` keys (an alias names
    the same tensor as its target); a key with no weight raises."""
    state = {}
    for k in keys:
        name = aliases.get(k, k)
        if name not in weights:
            raise KeyError(f"the benchmark makes no weight for {k!r}")
        state[k] = weights[name]
    unused = set(weights) - {aliases.get(k, k) for k in keys}
    if unused:
        raise KeyError(f"weights the program does not take: "
                       f"{sorted(unused)[:5]}")
    return state
