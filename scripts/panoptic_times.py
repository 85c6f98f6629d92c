"""Times the panoptic head alone in each memory layout of its parameters on
one CUDA card, on the detector's outputs: detr_r50_panoptic (DETR-R50, 250
classes, 100 queries) at batch 8 and deformable_detr_r50_panoptic (300
queries, no refinement) at batch 4, both 640x640, bfloat16, random weights
(CUDA events, mean of 10 calls after 2 warm-ups). Prints the card's name
and power limit, then one JSON line.

    python3 scripts/panoptic_times.py

The head's convolutions follow their parameters' layout (cuDNN takes
channels_last when the input or the weight is); PyTorch's GroupNorm on CUDA
reads and writes NCHW-contiguous tensors. ``DetrPanoptic`` keeps the head
NCHW-contiguous; ``chip_smoke.py`` times the served forward. Needs a CUDA
card.
"""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYOUTS = {"channels_last": "channels_last",
           "contiguous": "contiguous_format"}


def cuda_ms(fn, iters=10, warmup=2):
    """Mean milliseconds of ``fn`` on the current stream, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    from aloception_tpu_torch.models.deformable_detr import deformable_detr_r50
    from aloception_tpu_torch.models.panoptic import (DetrPanoptic,
                                                      PanopticHead)

    if not torch.cuda.is_available():
        raise SystemExit("panoptic_times.py needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    device = torch.device("cuda", 0)
    bf16 = torch.bfloat16

    def seeded():
        return torch.Generator(device=device).manual_seed(0)

    configs = {
        "detr_r50_panoptic": (lambda: DetrPanoptic(
            dtype=bf16, generator=seeded()), 8),
        "deformable_detr_r50_panoptic": (lambda: DetrPanoptic(
            deformable_detr_r50(num_classes=250, return_intermediate=True,
                                dtype=bf16, generator=seeded())), 4),
    }
    result = {}
    for name, (build, batch) in configs.items():
        model = build()
        x = torch.randn(batch, 640, 640, 3, device=device).to(bf16)
        mask = torch.zeros(batch, 640, 640, device=device)
        with torch.inference_mode():
            det_out = model.detr(x, mask)
        row = {"batch": batch}
        for layout, fmt in LAYOUTS.items():
            for head in (model.bbox_attention, model.mask_head):
                head.to(memory_format=getattr(torch, fmt))
            with torch.inference_mode():
                row[layout] = cuda_ms(
                    lambda: PanopticHead.forward(model, det_out))
            print(f"{name} bs{batch} 640 bf16, head alone {layout}: "
                  f"{row[layout]:.3f} ms")
        result[name] = row
        del model, det_out
        torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
