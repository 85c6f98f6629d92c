"""What the benchmark takes from the program under test: its entry points
named in a configuration's ``program`` group, built with the benchmark's
weights. The reference never imports this module."""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from portbench.reference.weights import program_state


def entry(path: str):
    """``"package.module:name"`` -> the object."""
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def build_model(cfg: Dict, weights: Dict[str, torch.Tensor],
                dtype: torch.dtype, device, arch) -> torch.nn.Module:
    """The configuration's model from its factory, on ``device`` in
    ``dtype``, holding the benchmark's weights."""
    prog = cfg["program"]
    kwargs = {k: cfg[v] for k, v in prog["args"].items()}
    model = entry(prog["factory"])(device=device, dtype=dtype, **kwargs)
    state = program_state(weights, list(model.state_dict()),
                          arch.aliases(cfg))
    model.load_state_dict(state, strict=True)
    return model


def device_info(device: torch.device, peak: int, power_w) -> Dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    if power_w is not None:
        info["power_limit_w"] = power_w
    return info


def msda_modules(model: torch.nn.Module):
    """The modules of ``model`` whose own module calls the deformable
    attention operation by the name ``ms_deform_attn``."""
    import sys
    mods = {}
    for m in model.modules():
        src = sys.modules.get(type(m).__module__)
        if type(m).__name__ == "MSDeformAttn" and hasattr(src,
                                                          "ms_deform_attn"):
            mods[src.__name__] = src
    return list(mods.values())
