"""Readings behind ``chip_smoke.py::train_gate_phase``'s tolerances, on the
card:

    python3 scripts/train_gate_probe.py

For 8 batches of the synthetic COCO sample (the gate's ``one_batch`` seeds
20-27), one Deformable-DETR-R50-refine fp32 train step per forward, each
against the plain forward's step, by the gate's measures
(``gate_grad_errors``): every gradient but the sampling offsets' by max|gap|
/ max|g| ("dense"), the sampling offsets' by ||gap||_2 / ||g||_2
("offsets"), and their max|gap| / max|g| (not held). The forwards:

- the MSDA kernel as built, and the kernel step against a plain step that
  carries its MSDA values ("replay", max|gap| / max|g| over every tensor);
- faults the gate must catch: the plain forward's values with value and
  attention weights rounded to bfloat16 (the backward fp32), and the plain
  version sampling half a cell off (loc + 0.5 / (W_l, H_l));
- a second correct kernel: the MSDA kernel whose sampling coordinates round
  as CUDA ``grid_sample``'s do, built from a copy of the source in a
  temporary directory.

Prints the card's name and power limit first, then a table, and writes the
readings to ``chiprun_out/train_gate_probe.json``. Needs a CUDA card.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as cs  # noqa: E402
from aloception_tpu_torch.ops.cuda import build  # noqa: E402
from aloception_tpu_torch.ops.cuda import ms_deform_attn_kernel as mk  # noqa: E402
from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch  # noqa: E402

ROUNDING = ("  const float x = lx * wl - 0.5f;\n"
            "  const float y = ly * hl - 0.5f;",
            "  const float x = __fmul_rn(__fmaf_rn(__fadd_rn(__fsub_rn("
            "__fmul_rn(2.f, lx), 1.f), 1.f), (float)wl, -1.f), 0.5f);\n"
            "  const float y = __fmul_rn(__fmaf_rn(__fadd_rn(__fsub_rn("
            "__fmul_rn(2.f, ly), 1.f), 1.f), (float)hl, -1.f), 0.5f);")
SEEDS = range(20, 28)


def bf16_values(value, shapes, loc, w):
    """The plain graph carrying the plain forward's values at bfloat16
    value and attention weights."""
    out = ms_deform_attn_torch(value, shapes, loc, w)
    low = ms_deform_attn_torch(value.bfloat16().float(), shapes, loc,
                               w.bfloat16().float())
    return out + (low - out).detach()


def half_cell_off(value, shapes, loc, w):
    """The plain version sampling half a cell right of and below loc."""
    half = 0.5 / torch.tensor([(float(w), float(h)) for h, w in shapes],
                              dtype=loc.dtype, device=loc.device)
    return ms_deform_attn_torch(value, shapes,
                                loc + half.view(1, 1, 1, -1, 1, 2), w)


def readings(device, seed, faults=True):
    """{forward: gate_grad_errors against the plain step}, and the replay."""
    from aloception_tpu_torch.models.deformable_detr import ms_deform_attn \
        as msda_module
    model, images, mask, targets = cs.gate_setup(device, seed)
    kernel_msda, outputs, forced = msda_module.ms_deform_attn, [], []

    def recorded(*args):
        out = kernel_msda(*args)
        outputs.append(out.detach())
        return out

    def kernel_valued(value, shapes, loc, w):
        out = ms_deform_attn_torch(value, shapes, loc, w)
        kernel_out = outputs[len(forced)]
        forced.append(kernel_out)
        return out + (kernel_out - out).detach()

    def step(msda):
        return cs.gate_step(model, images, mask, targets, msda)[1]

    plain = step(ms_deform_attn_torch)
    kernel = step(recorded)
    out = {"kernel": cs.gate_grad_errors(kernel, plain)}
    out["replay"] = cs.gate_grad_errors(kernel, step(kernel_valued))["all"]
    if faults:
        out["bf16 values"] = cs.gate_grad_errors(step(bf16_values), plain)
        out["half cell off"] = cs.gate_grad_errors(step(half_cell_off), plain)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    results = {seed: readings(device, seed) for seed in SEEDS}
    with tempfile.TemporaryDirectory() as d:
        for name in ("ms_deform_attn", "hungarian"):
            shutil.copy(build.CSRC_DIR / f"{name}.cu", d)
        path = os.path.join(d, "ms_deform_attn.cu")
        src = open(path).read()
        assert ROUNDING[0] in src
        with open(path, "w") as f:
            f.write(src.replace(*ROUNDING))
        build.CSRC_DIR = type(build.CSRC_DIR)(d)
        build.load_library.cache_clear()
        mk._forward_fn.cache_clear()
        args = cs.msda_inputs(cs.LEVELS_640, 2, 8500, cs.C, (0.0, 1.0),
                              torch.float32, device)
        err = (mk.ms_deform_attn_cuda(*args)
               - ms_deform_attn_torch(*args)).abs().max().item()
        print(f"grid_sample rounding variant: forward max|kernel-plain| at "
              f"bs2 Lq=8500 fp32 {err:.3e}")
        for seed in SEEDS:
            r = readings(device, seed, faults=False)
            results[seed]["kernel, grid_sample rounding"] = r["kernel"]
    print(f"gradient errors against the plain forward's step, by batch seed: "
          f"dense (max|gap|/max|g|, tol {cs.GATE_GRAD_TOL:.0e}) / offsets "
          f"(L2, tol {cs.GATE_OFFSETS_L2_TOL:.0e}) / offsets max|gap|/max|g| "
          f"(not held); replay {cs.GATE_REPLAY_TOL:.0e}")
    for seed, r in results.items():
        print(f"seed {seed}: replay {r['replay'][0]:.3e} ({r['replay'][1]})")
        for name, e in r.items():
            if name != "replay":
                print(f"  {name:30s} {e['dense'][0]:.3e} ({e['dense'][1]}) "
                      f"/ {e['offsets'][0]:.3e} ({e['offsets'][1]}) / "
                      f"{e['offsets_max'][0]:.3e}")
    names = [n for n in results[SEEDS[0]] if n != "replay"]
    for name in names:
        for k in ("dense", "offsets", "offsets_max"):
            v = [results[s][name][k][0] for s in SEEDS]
            print(f"{name} {k}: {min(v):.3e} to {max(v):.3e}")
    v = [results[s]["replay"][0] for s in SEEDS]
    print(f"replay: {min(v):.3e} to {max(v):.3e}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/train_gate_probe.json", "w") as f:
        json.dump({"device": smi, "readings": results}, f, indent=1)


if __name__ == "__main__":
    main()
