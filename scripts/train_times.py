"""Time the parts of the float32 training steps that the training profiles
of ``chip_smoke.py`` single out, on one CUDA card (TF32 off):

1. each convolution of RAFT's update block at the FlyingChairs stage's
   shape (batch 10, 46x62 at 1/8 of 368x496), forward and forward +
   backward, in channels-last and contiguous layouts, with
   ``torch.backends.cudnn.benchmark`` off (cuDNN's heuristic picks the
   algorithm) and on (cuDNN times its algorithms on the first call);
2. a whole RAFT train step (bs10 368x496, 12 iterations) and a whole
   detr_r50_panoptic head train step (bs8 640x640, frozen detector) with
   the flag off and on;
3. making the panoptic batch's padded masks (8, 100, 640, 640) float32 in
   pageable memory then pinning and copying them, against making them in
   pinned memory and copying them.

    python3 scripts/train_times.py

Times are CUDA events over repeated calls after warm-ups (device time of
the card's stream), and the host clock around the mask copies, which end
in a synchronise. Prints the card's name and power limit first.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# RAFT's update-block convolutions: name -> (in, out, kernel)
CONVS = {"encoder.convc1": (324, 256, (1, 1)),
         "encoder.convc2": (256, 192, (3, 3)),
         "encoder.convf1": (2, 128, (7, 7)),
         "encoder.convf2": (128, 64, (3, 3)),
         "encoder.conv": (256, 126, (3, 3)),
         "gru.convz1": (512, 128, (1, 5)),
         "flow_head.conv1": (128, 256, (3, 3)),
         "mask.0": (128, 256, (3, 3))}
BATCH, HW8 = 10, (46, 62)


def cuda_ms(fn, n=5, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def conv_times(device):
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for fmt in (torch.channels_last, torch.contiguous_format):
            for name, (cin, cout, k) in CONVS.items():
                conv = torch.nn.Conv2d(cin, cout, k, padding=(k[0] // 2,
                                                              k[1] // 2),
                                       device=device).to(memory_format=fmt)
                x = torch.randn(BATCH, cin, *HW8, device=device).contiguous(
                    memory_format=fmt).requires_grad_()

                def both():
                    conv.zero_grad(set_to_none=True)
                    x.grad = None
                    conv(x).sum().backward()

                print(f"benchmark={bench!s:5} {str(fmt)[6:]:17} {name:16} "
                      f"forward {cuda_ms(lambda: conv(x)):8.3f} ms, forward "
                      f"+ backward {cuda_ms(both):8.3f} ms", flush=True)


def step_times(device):
    from aloception_tpu_torch.models.detr import detr_r50
    from aloception_tpu_torch.models.panoptic import (DetrPanoptic,
                                                      panoptic_criterion)
    from aloception_tpu_torch.models.raft import raft, raft_sequence_loss
    g = torch.Generator(device=device).manual_seed(0)
    f1, f2 = (torch.randn(BATCH, 3, 368, 496, device=device, generator=g)
              for _ in range(2))
    flow = torch.randn(BATCH, 2, 368, 496, device=device, generator=g)
    images = torch.randn(8, 640, 640, 3, device=device, generator=g)
    targets = {"boxes": torch.rand(8, 100, 4, device=device, generator=g)
               * 0.5 + 0.25,
               "labels": torch.randint(0, 250, (8, 100), device=device,
                                       generator=g),
               "valid": torch.arange(100, device=device)[None].expand(8, -1)
               < 4,
               "masks": torch.rand(8, 100, 640, 640, device=device,
                                   generator=g).round()}
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        model = raft(device=device, generator=torch.Generator(
            device=device).manual_seed(1)).train()

        def raft_step():
            model.zero_grad(set_to_none=True)
            raft_sequence_loss(model(f1, f2, iters=12), flow)[0].backward()

        print(f"benchmark={bench}: raft train step bs{BATCH} 368x496 12 "
              f"iterations {cuda_ms(raft_step, n=3):.1f} ms", flush=True)
        del model
        model = DetrPanoptic(detr_r50(num_classes=250, return_intermediate=True,
                                      device=device)).train()
        for p in model.detr.parameters():
            p.requires_grad_(False)

        def panoptic_step():
            model.zero_grad(set_to_none=True)
            panoptic_criterion(model(images, None), targets)[0].backward()

        print(f"benchmark={bench}: detr_r50_panoptic head train step bs8 "
              f"640x640 {cuda_ms(panoptic_step, n=3):.1f} ms", flush=True)
        del model
        torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False


def mask_times(device):
    for pinned in (False, True, False, True):
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            masks = torch.zeros((8, 100, 640, 640), pin_memory=pinned)
            masks[:, :4] = 1.0
            t1 = time.perf_counter()
            (masks if pinned else masks.pin_memory()).to(device,
                                                         non_blocking=True)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            times.append(f"{(t1 - t0) * 1e3:.1f} + {(t2 - t1) * 1e3:.1f}")
        print(f"masks (8, 100, 640, 640) float32 made {'pinned' if pinned else 'pageable'}: "
              f"make + copy ms {times}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("train_times.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    conv_times(device)
    step_times(device)
    mask_times(device)


if __name__ == "__main__":
    main()
