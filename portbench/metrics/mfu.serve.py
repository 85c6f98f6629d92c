"""The served model's share of the card's bf16 peak: the reference's
forward FLOPs an image times the window's images per second, over
989 TFLOP/s (dense bf16, at the 700 W power limit; the run reports the
card's limit beside it), in percent."""

from portbench.reference.counting import PEAKS


def read(r):
    w, flops = r["window"], r.get("flops_per_image")
    if not flops or not w["images"]:
        return None
    return flops * w["images"] / w["seconds"] / PEAKS["bf16_flop_per_s"] * 100
