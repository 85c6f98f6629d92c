"""The training step's share of the card's float32 peak: three times the
reference's forward FLOPs an image (forward and backward) times the
window's images per second, over 67 TFLOP/s (float32 outside the tensor
cores: the cell runs with TF32 off), in percent."""

from portbench.reference.counting import PEAKS


def read(r):
    w, flops = r["window"], r.get("flops_per_image")
    if not flops or not w["images"]:
        return None
    return 3 * flops * w["images"] / w["seconds"] \
        / PEAKS["fp32_flop_per_s"] * 100
