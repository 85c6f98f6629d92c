"""Runs of ``chip_smoke.py::multiscale_train_phase``'s repeated-batch check
(``falling_eval_loss``: the eval-mode loss of one batch before 16 train
steps on it and after them) against a checkout's package, on the card:

    python3 scripts/overfit_check_probe.py [--tree DIR] [--runs N]

``--tree`` names another checkout (e.g. the parent commit unpacked with
``git archive``) whose ``aloception_tpu_torch`` is imported in place of
this one's; the phase and the check are this checkout's. Each run is the
whole phase (``train_on_coco --model deformable --multiscale --batch_size
2 --max_steps 8`` on a COCO-format directory of the fixtures, then the
check), seeded as the phase seeds itself: runs differ by the card's
nondeterministic sums only. The check's steps on the repeated batch run one
at a time to ``--steps`` (32), the eval-mode loss read before them and
after each; the check's own margin (after its 16) is reported, not held.
Prints the card's name and power limit, each run's eval-mode losses and
margin, and appends them to ``chiprun_out/overfit_check_probe.json``.
Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=ROOT)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--steps", type=int, default=32,
                   help="steps on the batch, the eval-mode loss read after "
                        "each")
    args = p.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import importlib.util
    import torch
    # this checkout's phase and check, whichever package is imported
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import aloception_tpu_torch
    from aloception_tpu_torch.ops.cuda.build import load_library
    from aloception_tpu_torch.utils.coco_fixture import build_coco_dir

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"package from {os.path.dirname(aloception_tpu_torch.__file__)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    for name in cs.KERNEL_SOURCES:
        load_library(name)
    runs = []
    with tempfile.TemporaryDirectory() as root:
        build_coco_dir(root, cs.fixture_images(), seed=0,
                       n_train=cs.COCO_TRAIN_IMAGES, n_val=cs.COCO_VAL_IMAGES)
        with open(os.path.join(root, "alodataset_config.json"), "w") as f:
            json.dump({"coco": root}, f)
        def every_step(trainer, recorder, frames, steps, device, tag,
                       **_):
            """The check's eval-mode loss before the steps and after each
            of ``args.steps`` steps (the check reads it after ``steps``)."""
            from aloception_tpu_torch.train.trainer import to_device
            prepared = trainer.prepare_batch(frames)
            inputs = to_device(prepared["inputs"], device)
            targets = to_device(prepared["targets"], device)
            before = cs.eval_loss(trainer, frames, device)
            evals, losses = [], []
            for _ in range(args.steps):
                # the step ``fit`` takes on the batch, without its callbacks
                keys, packed = trainer.train_step(inputs, targets)
                losses.append(dict(zip(keys, packed.tolist()))["loss_total"])
                evals.append(cs.eval_loss(trainer, frames, device))
            after = evals[steps - 1]
            return dict(before=before, after=after, margin=before - after,
                        steps=steps, train_losses=losses, evals=evals)

        for k in range(args.runs):
            t0 = time.perf_counter()
            with mock.patch.object(cs, "falling_eval_loss", every_step):
                trainer, out = cs.multiscale_train_phase(device, root)
            check = out["overfit"]
            runs.append(dict(check, seconds=time.perf_counter() - t0))
            print(f"run {k}: eval-mode loss_total {check['before']:.4f} -> "
                  f"{check['after']:.4f} after {check['steps']} steps, margin "
                  f"{check['margin']:.4f}; after each of {args.steps} steps "
                  f"{[round(v, 3) for v in check['evals']]}")
            del trainer
            torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    path = "chiprun_out/overfit_check_probe.json"
    done = json.load(open(path)) if os.path.exists(path) else []
    done.append(dict(tree=args.tree, runs=runs))
    with open(path, "w") as f:
        json.dump(done, f, indent=1)


if __name__ == "__main__":
    main()
