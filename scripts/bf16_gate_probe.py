"""Readings behind ``chip_smoke.py``'s bf16 train gate tolerances
(``BF16_GATE_TOL``), on the card:

    python3 scripts/bf16_gate_probe.py

For 6 batches of the synthetic COCO sample (the gate's ``one_batch`` seeds
20-25), one Deformable-DETR-R50-refine train step in bfloat16 (the model
cast by ``cast_for_training``, dropout 0, batch 2 at 640 x 640) with the
MSDA kernel forward, against the same step with the plain forward, both
with the operator's bf16 recompute backward, by the gate's measures
(``chip_smoke.bf16_gate_phase``): the relative loss error, the matched
queries, every gradient but the sampling offsets' by max|gap| / max|g|
("dense"), the sampling offsets' by ||gap||_2 / ||g||_2 ("offsets"), and
the kernel step against a plain step carrying its MSDA values ("replay",
max|gap| / max|g|). Then, for the first batch, a fault the gate must
catch: the plain forward sampling half a cell off (loc + 0.5 / (W_l,
H_l)).

Prints the card's name and power limit first, then the readings, and
writes them to ``chiprun_out/bf16_gate_probe.json``. Needs a CUDA card.
"""

import json
import os
import subprocess
import sys
from unittest import mock

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as cs  # noqa: E402

SEEDS = range(20, 26)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from aloception_tpu_torch.ops.cuda.build import load_library
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    for name in cs.KERNEL_SOURCES:
        load_library(name)
    out = {"correct": [cs.bf16_gate_phase(device, seed, tol=False)
                       for seed in SEEDS]}
    plain = cs._PlainMSDA.apply

    def half_cell_off(value, shapes, loc, w):
        size = torch.tensor([[wd, h] for h, wd in shapes], dtype=loc.dtype,
                            device=loc.device)
        return plain(value, shapes, loc + 0.5 / size[:, None, :], w)

    with mock.patch.object(cs._PlainMSDA, "apply", half_cell_off):
        out["half_cell_off"] = cs.bf16_gate_phase(device, SEEDS[0],
                                                  tol=False)
    for key in ("loss_err", "grad_err", "offsets_l2_err", "replay_grad_err"):
        print(f"{key}: correct kernel, largest over {len(SEEDS)} batches "
              f"{max(r[key] for r in out['correct']):.3e}; half a cell off "
              f"{out['half_cell_off'][key]:.3e}")
    print("matched queries equal:",
          [r["matched_equal"] for r in out["correct"]])
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/bf16_gate_probe.json", "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
