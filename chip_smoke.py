"""Smoke run of the PyTorch port (``aloception_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Builds the MSDA CUDA kernel from ``aloception_tpu_torch/csrc`` (printing
   ``ptxas -v``'s registers and spills of each instance) and holds it against
   its plain PyTorch version on the card, in float32 and bfloat16: at the
   encoder and decoder (level-split) calls of Deformable-DETR-R50 at 640 px
   and batch 16 (the main path's plans), at a small odd shape, with narrow
   vectors, with locations outside the levels, NaN and far-outside points,
   and every instance of its template under a forced launch plan. At both
   bs16 bf16 sites it holds the kernel against the plain version on the
   inputs it times, times both (device time from CUDA graphs, and the
   kernel's eager launches by CUDA events), computes the bound from the
   call's inputs, and times plans that switch single design steps off, each
   held against the plain version too.
2. Drives the main path at full width: Deformable-DETR-R50 with box
   refinement (random weights from a seeded generator, bfloat16) answers 3
   requests of 16 uint8 480x640 images through ``fused_preprocess`` (to
   640x640), the forward and ``inference``, and must launch the kernel 12
   times per forward. In float32 at batch 16 the model on the kernel path must
   agree with the same model on the plain path, with the offset and weight
   kernels of every MSDeformAttn drawn at random so that sampling depends on
   the query. Then it times the forward at batch 16 (the configuration
   ``bench.py::bench_deformable`` measures).
3. Profiles 3 steady batch-16 forwards with ``torch.profiler``
   (device time by aten op and by kernel, device activities and busy time per
   forward, the device's idle share), and the synchronising operations of one
   forward under ``torch.cuda.set_sync_debug_mode``.
4. The Frame path, as a user of ``aloscene`` calls it: uint8 CHW frames of
   mixed sizes on the card -> ``Frame`` -> ``norm_resnet`` -> ``resize``
   (longer side 640) -> ``batch_list(size=(640, 640))`` -> forward ->
   ``inference`` (per-image ``BoundingBoxes2D`` with ``Labels``):
   - one bs16 Deformable-DETR request, which must launch the kernel 12 times;
   - DETR-R50 in float32 at batch 2 on the card against the same model on
     the CPU, on a padded batch;
   - DETR-R50 (91 classes, 100 queries, 6+6 layers, bfloat16, built with no
     device named, so on the card) answers 3 requests of 32 frames; the
     synchronising operations of one request.
5. Times the DETR-R50 forward at batch 32, 640x640 (the configuration
   ``bench.py::bench_detr`` measures) and profiles it as in 3.

Prints the card's name and power limit, one JSON line describing the kernel,
and last ``{"ok": true, "device": {...}}``. Any failure raises: the exit code
is then not 0 and no result line is printed. Needs a CUDA card; never
imports JAX.
"""

import copy
import json
import subprocess
import sys
import time
import warnings
from unittest import mock

import torch

LEVELS_640 = ((80, 80), (40, 40), (20, 20), (10, 10))
NH, C, P = 8, 32, 4
# name: (level shapes, B, Lq, C, location range); the encoder and decoder
# cases are the main path's calls, so their plans are the ones it launches
KERNEL_CASES = {
    "encoder": (LEVELS_640, 16, 8500, C, (0.0, 1.0)),
    # the decoder site: its plan splits the levels across sub-groups
    "decoder": (LEVELS_640, 16, 300, C, (0.0, 1.0)),
    "odd": (((1, 5), (2, 2), (3, 7)), 2, 37, 16, (0.0, 1.0)),
    # heads of 3 narrow vectors (8 B fp32, 4 B bf16) and a 1x1 level
    "narrow": (((9, 11), (1, 1), (4, 3), (2, 5)), 2, 37, 6, (-0.2, 1.2)),
    "out_of_bounds": (LEVELS_640, 2, 300, C, (-0.2, 1.2)),
}
# every instance of the kernel's template: dtype -> vector widths, and the
# (split, unrolled) variants of each, with points shared by shuffles where
# the sub-group allows and not; run at a small shape with C = 8
INSTANCE_VECS = {torch.float32: (16, 8, 4), torch.bfloat16: (16, 8, 4, 2)}
INSTANCE_VARIANTS = ((1, True), (2, True), (4, True), (1, False))
# the main path's call shapes at batch 16, timed in bfloat16
TIMED_SHAPES = {"encoder": (16, 8500), "decoder": (16, 300)}
# plans timed beside the chosen one at each site, to separate the design's
# steps: (label, changes to the chosen plan)
NOT_SHARED = ("points not shared (step 2 in every thread)",
              dict(share_points=False))
LOOP = ("runtime loop (step 3 off)", dict(unrolled=False, share_points=False))
STEP_PLANS = {
    "encoder": (NOT_SHARED, LOOP,
                ("8 B vectors (step 1 halved)", dict(vec_bytes=8)),
                ("2 B, a thread per channel (step 1 off)",
                 dict(vec_bytes=2))),
    "decoder": (("no level split (step 4 off)", dict(split=1)),
                ("split 2", dict(split=2)), NOT_SHARED, LOOP,
                ("2 B, a thread per channel (step 1 off)",
                 dict(vec_bytes=2, split=1))),
}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 peak rate
FP32_FLOP_PER_S = 67e12          # fp32 outside the tensor cores
BATCH, RAW_HW, SIZE = 16, (480, 640), (640, 640)
N_REQUESTS = 3
MSDA_CALLS_PER_FORWARD = 12      # 6 encoder + 6 decoder layers
# DETR-R50: the bench_detr batch; Frame-path frame sizes (H, W) are drawn
# from these ranges
DETR_BATCH = 32
FRAME_H, FRAME_W = (360, 640), (480, 640)
DETR_CLASSES = 91                # + the background class


def msda_inputs(shapes, B, Lq, channels, loc_range, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    L = len(shapes)
    len_v = sum(h * w for h, w in shapes)
    lo, hi = loc_range
    value = torch.randn(B, len_v, NH, channels, device=device, generator=g)
    loc = lo + (hi - lo) * torch.rand(B, Lq, NH, L, P, 2, device=device,
                                      generator=g)
    w = torch.rand(B, Lq, NH, L, P, device=device, generator=g)
    w = w / w.sum((3, 4), keepdim=True)
    return value.to(dtype), shapes, loc.to(dtype), w.to(dtype)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn`` on the current stream, by CUDA events."""
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


def graph_ms(fn, iters=20, reps=3):
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in
    one CUDA graph and replayed ``reps`` times after a warm-up, timed by CUDA
    events. The host's cost of enqueuing each call is left out: a 30 us
    kernel launched from Python costs about as much on the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def msda_bound(value, shapes, loc, w):
    """The least time the card could take for one call on these inputs:
    (bound_ms, "bytes" or "operations", compulsory bytes, FMAs, gathered
    bytes). Bytes: each value row (b, s, h) that a corner of nonzero weight
    touches, read once, all of loc and w, and out, written once. FMAs: one
    per channel of each such corner (the attention weight folded into the
    corner weights). Gathered bytes: one corner row per such corner, what a
    gather pulls from L2."""
    B, len_v, nH, Cv = value.shape
    item = value.element_size()
    x = loc[..., 0].float() * torch.tensor([wl for _, wl in shapes],
                                           device=loc.device)[:, None] - 0.5
    y = loc[..., 1].float() * torch.tensor([hl for hl, _ in shapes],
                                           device=loc.device)[:, None] - 0.5
    hw = torch.tensor(shapes, device=loc.device)
    hl, wl = hw[:, 0, None], hw[:, 1, None]
    start = torch.tensor([0] + [h * wd for h, wd in shapes][:-1],
                         device=loc.device).cumsum(0)[:, None]
    rows, n_corners = [], 0
    for dy in (0, 1):
        for dx in (0, 1):
            cx = torch.floor(x).long() + dx
            cy = torch.floor(y).long() + dy
            ok = (cx >= 0) & (cx < wl) & (cy >= 0) & (cy < hl) & (w != 0)
            s = start + cy * wl + cx                      # (B, Lq, nH, L, P)
            b = torch.arange(B, device=loc.device).view(B, 1, 1, 1, 1)
            h = torch.arange(nH, device=loc.device).view(1, 1, nH, 1, 1)
            rows.append(((b * len_v + s) * nH + h)[ok])
            n_corners += int(ok.sum())
    n_rows = int(torch.unique(torch.cat(rows)).numel())
    nbytes = (n_rows * Cv + loc.numel() + w.numel()
              + loc.shape[0] * loc.shape[1] * nH * Cv) * item
    fmas = n_corners * Cv
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * fmas / FP32_FLOP_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, nbytes, fmas, n_corners * Cv * item


def ptxas_report(log):
    """{(dtype, vec_bytes, levels a sub-group unrolls or 0 for the loop):
    (registers, spill store bytes, spill load bytes)} from ``ptxas -v``."""
    import re
    report, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"msda_forward_kernelI(f|13__nv_bfloat16)Li(\d+)E"
                          r"Li(\d+)E", m.group(1))
            key = (("float32" if k.group(1) == "f" else "bfloat16"),
                   int(k.group(2)), int(k.group(3))) if k else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and key:
            report[key] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and key in report:
            report[key][0] = int(m.group(1))
    return {k: tuple(v) for k, v in report.items()}


def _gate(got, want, dtype, tag):
    err = (got.float() - want.float()).abs().max().item()
    # float32: summation order only; bfloat16: the output is rounded
    tol = 1e-5 if dtype == torch.float32 else \
        2e-2 * want.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"msda kernel disagrees at {tag}: {err} > {tol}")
    return err, tol


def kernel_phase(device):
    import dataclasses
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda
    from aloception_tpu_torch.ops.cuda.ms_deform_attn_kernel import (
        LaunchPlan, launch_plan)
    from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch

    def plan_of(value, shapes, loc, w):
        B, len_v, nH, Cv = value.shape
        return launch_plan(B, loc.shape[1], nH, Cv, len(shapes), loc.shape[4],
                           len_v, value.element_size(), value.data_ptr(),
                           loc.data_ptr(), w.data_ptr())

    def brief(plan):
        return (f"vec {plan.vec_bytes} B, split {plan.split}, "
                f"{'unrolled (4, 4)' if plan.unrolled else 'runtime loop'}"
                f"{', points shared' if plan.share_points else ''}")

    errs = {}
    for name, (shapes, B, Lq, channels, loc_range) in KERNEL_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = msda_inputs(shapes, B, Lq, channels, loc_range, dtype,
                               device)
            got = ms_deform_attn_cuda(*args)
            torch.cuda.synchronize()
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            err, tol = _gate(got, ms_deform_attn_torch(*args), dtype, tag)
            print(f"msda {tag}: B={B} Lq={Lq} C={channels} "
                  f"[{brief(plan_of(*args))}] max|kernel-plain|={err:.3e} "
                  f"(tol {tol:.3e})")
            errs[tag] = err

    # every instance, forced, at a small shape with a 1x1 level
    inst_shapes = ((16, 20), (6, 8), (1, 1), (2, 3))
    n_inst = share_plans = 0
    for dtype, vecs in INSTANCE_VECS.items():
        value, _, loc, w = msda_inputs(inst_shapes, 2, 37, 8, (-0.2, 1.2),
                                       dtype, device, seed=1)
        want = ms_deform_attn_torch(value, inst_shapes, loc, w)
        for vec in vecs:
            # a sub-group of >= P threads may share points
            group = 8 * value.element_size() // vec
            for split, unrolled in INSTANCE_VARIANTS:
                shares = (False, True) if unrolled and group >= P \
                    else (False,)
                for share in shares:
                    plan = LaunchPlan(vec, split, unrolled, share)
                    got = ms_deform_attn_cuda(value, inst_shapes, loc, w,
                                              plan=plan)
                    torch.cuda.synchronize()
                    tag = f"instance {str(dtype).split('.')[-1]} {brief(plan)}"
                    errs[tag] = _gate(got, want, dtype, tag)[0]
                    n_inst += 1
                    share_plans += share
    # NaN and far-outside points add exactly 0, on each path
    for dtype in (torch.float32, torch.bfloat16):
        value, shapes, loc, w = msda_inputs(LEVELS_640, 2, 300, C, (-3.0, 4.0),
                                            dtype, device, seed=2)
        loc.view(-1)[::7] = float("nan")
        far = torch.where(loc.isnan().any(-1, keepdim=True),
                          torch.full_like(loc, -10.0), loc)
        want = ms_deform_attn_torch(value, shapes, far, w)
        for changes in ({}, NOT_SHARED[1], LOOP[1]):
            plan = dataclasses.replace(plan_of(value, shapes, loc, w),
                                       **changes)
            got = ms_deform_attn_cuda(value, shapes, loc, w, plan=plan)
            torch.cuda.synchronize()
            tag = f"nan/{str(dtype).split('.')[-1]} {brief(plan)}"
            if not got.isfinite().all():
                raise AssertionError(f"msda {tag}: non-finite output")
            errs[tag] = _gate(got, want, dtype, tag)[0]
            n_inst += 1
    print(f"msda: {n_inst} forced plans (every instance of the template, "
          f"{share_plans} of them with shared points; NaN and far points) "
          f"agree with the plain version; max|err| fp32 "
          f"{max(v for k, v in errs.items() if 'float32' in k):.3e}, bf16 "
          f"{max(v for k, v in errs.items() if 'bfloat16' in k):.3e}")

    sites = {}
    for site, (B, Lq) in TIMED_SHAPES.items():
        args = msda_inputs(LEVELS_640, B, Lq, C, (0.0, 1.0), torch.bfloat16,
                           device)
        plan = plan_of(*args)
        # the plan the main path launches, and each timed variant of it,
        # against the plain version on the inputs it is timed on
        want = ms_deform_attn_torch(*args)
        tag = f"{site} timed/bfloat16"
        errs[tag] = _gate(ms_deform_attn_cuda(*args), want, torch.bfloat16,
                          tag)[0]
        ms = graph_ms(lambda: ms_deform_attn_cuda(*args))
        eager_ms = cuda_ms(lambda: ms_deform_attn_cuda(*args))
        plain_ms = graph_ms(lambda: ms_deform_attn_torch(*args), iters=5,
                            reps=1)
        bound_ms, bound_by, nbytes, fmas, gathered = msda_bound(*args)
        print(f"msda {site} B={B} Lq={Lq} bf16 [{brief(plan)}]: "
              f"max|kernel-plain|={errs[tag]:.3e}; kernel {ms:.4f} ms (graph) "
              f"{eager_ms:.4f} ms (eager launches), plain {plain_ms:.4f} ms; "
              f"bound {bound_ms:.4f} ms "
              f"by {bound_by} ({nbytes / 1e6:.1f} MB compulsory, "
              f"{fmas / 1e9:.3f} G FMA), {bound_ms / ms:.1%} of the bound, "
              f"{nbytes / ms / 1e6:.1f} GB/s of compulsory bytes; corner rows "
              f"gathered from L2 {gathered / 1e9:.3f} GB = "
              f"{gathered / ms / 1e9:.3f} TB/s")
        steps = {}
        for label, changes in STEP_PLANS[site]:
            alt = dataclasses.replace(plan, **changes)
            _gate(ms_deform_attn_cuda(*args, plan=alt), want, torch.bfloat16,
                  label)
            steps[label] = graph_ms(lambda: ms_deform_attn_cuda(*args,
                                                                plan=alt))
            print(f"  {label:42s} [{brief(alt)}]: {steps[label]:.4f} ms")
        sites[site] = dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           plan=dataclasses.asdict(plan), steps=steps)
    return errs, sites


def slice_phase(device):
    from aloception_tpu_torch.models.deformable_detr import (
        deformable_detr_r50, inference)
    from aloception_tpu_torch.models.deformable_detr import ms_deform_attn \
        as msda_module
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda
    from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch
    from aloception_tpu_torch.ops.preprocess import fused_preprocess

    def model(dtype):
        return deformable_detr_r50(
            num_classes=91, with_box_refine=True, dtype=dtype, device=device,
            generator=torch.Generator(device=device).manual_seed(0))

    host = torch.Generator().manual_seed(1)

    def raw_batch(n):
        return torch.randint(0, 256, (n,) + RAW_HW + (3,), dtype=torch.uint8,
                             generator=host)

    # float32, at the main path's batch (so its plans): the kernel path
    # against the plain path, one model.
    # Init zeroes the offset and weight kernels (every query would sample the
    # same points with uniform weights): draw them instead.
    m32 = model(torch.float32)
    g = torch.Generator(device=device).manual_seed(2)
    with torch.no_grad():
        for mod in m32.modules():
            if isinstance(mod, msda_module.MSDeformAttn):
                mod.sampling_offsets.weight.normal_(0.0, 0.1, generator=g)
                mod.attention_weights.weight.normal_(0.0, 0.1, generator=g)
    with torch.inference_mode():
        x, mask = fused_preprocess(raw_batch(BATCH).to(device), out_size=SIZE,
                                   dtype=torch.float32)
        out_k = m32(x, mask)
        with mock.patch.object(msda_module, "ms_deform_attn",
                               ms_deform_attn_torch):
            out_p = m32(x, mask)
    parity = max((out_k[k] - out_p[k]).abs().max().item()
                 for k in ("pred_logits", "pred_boxes"))
    print(f"slice fp32 bs{BATCH}: max|kernel path - plain path| = "
          f"{parity:.3e} (tol 1e-3)")
    if not parity <= 1e-3:
        raise AssertionError(f"kernel path and plain path disagree: {parity}")
    del m32, out_k, out_p

    # the main path: bfloat16 requests of uint8 images
    m16 = model(torch.bfloat16)
    requests = [raw_batch(BATCH) for _ in range(N_REQUESTS)]
    torch.cuda.synchronize()
    ms_deform_attn_cuda.launches = 0
    latencies, results = [], []
    for raw in requests:
        t0 = time.perf_counter()
        with torch.inference_mode():
            x, mask = fused_preprocess(raw.to(device), out_size=SIZE)
            out = m16(x, mask)
            dets = inference(out)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        results.append((out, dets))
    launches = ms_deform_attn_cuda.launches

    for out, dets in results:
        logits, boxes = out["pred_logits"].float(), out["pred_boxes"]
        if logits.shape != (BATCH, 300, 91) or boxes.shape != (BATCH, 300, 4):
            raise AssertionError(f"bad shapes {logits.shape} {boxes.shape}")
        if not (logits.isfinite().all() and boxes.isfinite().all()):
            raise AssertionError("non-finite model outputs")
        if not (boxes.min() >= 0 and boxes.max() <= 1):
            raise AssertionError("boxes outside [0, 1]")
        check_detections(dets, BATCH)
        if any(bool((d.labels.scores <= 0.2).any()) for d in dets):
            raise AssertionError("a detection at or under the threshold")
    n_dets = [sum(len(d) for d in dets) for _, dets in results]
    if launches != MSDA_CALLS_PER_FORWARD * N_REQUESTS:
        raise AssertionError(f"msda kernel launched {launches} times in "
                             f"{N_REQUESTS} forwards")
    print(f"requests: {N_REQUESTS} x bs{BATCH} uint8 {RAW_HW} -> {SIZE} bf16, "
          f"latency s {[round(t, 4) for t in latencies]}, detections "
          f"{n_dets}, msda launches {launches}")

    # forward throughput, the bench_deformable configuration
    x = torch.randn(BATCH, *SIZE, 3, device=device).to(torch.bfloat16)
    mask = torch.zeros(BATCH, *SIZE, device=device)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: m16(x, mask), iters=10, warmup=2)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"deformable_detr_r50_refine bs{BATCH} {SIZE[0]}px bf16: forward "
          f"{fwd_ms:.2f} ms, {BATCH / fwd_ms * 1e3:.2f} images/s, peak "
          f"memory {peak_gib:.2f} GiB")
    profile_phase(m16, x, mask)
    return launches, parity, m16


def random_frames(n, device, seed):
    """``n`` uint8 CHW images made on the card, each of a size drawn from
    FRAME_H x FRAME_W."""
    host = torch.Generator().manual_seed(seed)
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [(int(torch.randint(FRAME_H[0], FRAME_H[1] + 1, (), generator=host)),
              int(torch.randint(FRAME_W[0], FRAME_W[1] + 1, (), generator=host)))
             for _ in range(n)]
    return [torch.randint(0, 256, (3, h, w), dtype=torch.uint8, device=device,
                          generator=g) for h, w in sizes]


def frame_batch(images):
    """Frame -> norm_resnet -> resize (longer side SIZE[0], aspect kept) ->
    batch_list(size=SIZE)."""
    from aloception_tpu_torch.aloscene import Frame, batch_list
    frames = []
    for x in images:
        f = Frame(x).norm_resnet()
        scale = SIZE[0] / max(f.HW)
        frames.append(f.resize((round(f.H * scale), round(f.W * scale))))
    return batch_list(frames, size=SIZE)


def frame_request(model, images, infer):
    """One request down the Frame path; returns (batch, outputs,
    detections)."""
    batch = frame_batch(images)
    out = model(batch.as_layout(("B", "H", "W", "C")), batch.mask.array[:, 0])
    return batch, out, infer(out)


def check_detections(dets, n, background=None):
    """``n`` relative xcyc BoundingBoxes2D, each with Labels carrying scores,
    finite boxes in [0, 1] and no background label."""
    from aloception_tpu_torch.aloscene import BoundingBoxes2D, Labels
    if len(dets) != n:
        raise AssertionError(f"{len(dets)} detection sets for {n} images")
    for d in dets:
        labels = d.get_child("labels")
        if not (isinstance(d, BoundingBoxes2D) and isinstance(labels, Labels)
                and labels.scores is not None
                and d.boxes_format == "xcyc" and not d.absolute):
            raise AssertionError(f"malformed detections {d!r}")
        b = d.array
        if b.shape != (len(labels), 4) or labels.scores.shape != (len(b),):
            raise AssertionError(f"shapes {b.shape} {labels.scores.shape}")
        if len(b) and not (b.isfinite().all() and b.min() >= 0
                           and b.max() <= 1):
            raise AssertionError("boxes not finite or outside [0, 1]")
        if background is not None and bool((labels.array == background).any()):
            raise AssertionError("a detection of the background class")
    return sum(len(d) for d in dets)


def syncs_of(fn):
    """(synchronising CUDA operations reported while ``fn`` runs, their
    messages). The mode warns once, when it is set, that it is a prototype;
    that notice is raised outside and not counted."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [str(w.message) for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def deformable_frame_phase(m16, device):
    """One bs16 request down the Frame path; the kernel must run 12 times."""
    from aloception_tpu_torch.models.deformable_detr import inference
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda

    images = random_frames(BATCH, device, seed=3)
    torch.cuda.synchronize()
    ms_deform_attn_cuda.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        batch, _, dets = frame_request(m16, images, inference)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    launches = ms_deform_attn_cuda.launches
    n_dets = check_detections(dets, BATCH)
    if launches != MSDA_CALLS_PER_FORWARD:
        raise AssertionError(f"msda kernel launched {launches} times in one "
                             "Frame-path forward")
    print(f"deformable Frame path: bs{BATCH} mixed-size uint8 frames -> "
          f"{SIZE} bf16, latency {latency:.4f} s, detections {n_dets}, "
          f"mask padded share {batch.mask.array.mean().item():.4f}, msda "
          f"launches {launches}")
    return launches


def detr_parity_phase(device):
    """DETR-R50 fp32 at batch 2 on a padded batch: the card against the CPU,
    one model."""
    from aloception_tpu_torch.models.detr import detr_r50

    cpu_model = detr_r50(dtype=torch.float32, device="cpu",
                         generator=torch.Generator().manual_seed(4))
    gpu_model = copy.deepcopy(cpu_model).to(device)
    g = torch.Generator().manual_seed(5)
    images = [torch.randint(0, 256, (3,) + hw, dtype=torch.uint8, generator=g)
              for hw in ((480, 640), (640, 427))]
    batch = frame_batch(images)
    layout = ("B", "H", "W", "C")
    with torch.inference_mode():
        want = cpu_model(batch.as_layout(layout), batch.mask.array[:, 0])
        gb = batch.to(device)
        got = gpu_model(gb.as_layout(layout), gb.mask.array[:, 0])
    err = max((got[k].cpu() - want[k]).abs().max().item()
              for k in ("pred_logits", "pred_boxes"))
    padded = batch.mask.array.mean().item()
    print(f"detr fp32 bs2 card vs cpu on a padded batch (padded share "
          f"{padded:.4f}): max|diff| = {err:.3e} (tol 1e-3)")
    if not (err <= 1e-3 and padded > 0):
        raise AssertionError(f"detr on the card disagrees with the cpu: {err}")
    return err


def detr_phase(device):
    """DETR-R50 bf16: 3 Frame-path requests of DETR_BATCH frames, the
    synchronising operations of one request, then the bs32 forward's time
    and profile."""
    from aloception_tpu_torch.models.detr import detr_r50, inference

    # no device named: the factory builds on the card
    model = detr_r50(num_classes=DETR_CLASSES, dtype=torch.bfloat16,
                     generator=torch.Generator(device=device).manual_seed(0))
    if any(p.device != device for p in model.parameters()):
        raise AssertionError("detr_r50() with no device did not build on the "
                             "card")
    requests = [random_frames(DETR_BATCH, device, seed=10 + i)
                for i in range(N_REQUESTS)]
    torch.cuda.synchronize()
    latencies, results = [], []
    for images in requests:
        t0 = time.perf_counter()
        with torch.inference_mode():
            results.append(frame_request(model, images, inference))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
    n_dets = []
    for batch, out, dets in results:
        if not (out["pred_logits"].shape == (DETR_BATCH, 100, DETR_CLASSES + 1)
                and out["pred_logits"].isfinite().all()):
            raise AssertionError("bad or non-finite detr logits")
        if not batch.mask.array.sum() > 0:
            raise AssertionError("the batch mask is empty")
        n_dets.append(check_detections(dets, DETR_BATCH,
                                       background=DETR_CLASSES))
    with torch.inference_mode():
        syncs = syncs_of(lambda: frame_request(model, requests[0], inference))
    print(f"detr Frame path: {N_REQUESTS} x bs{DETR_BATCH} mixed-size uint8 "
          f"frames -> {SIZE} bf16, latency s "
          f"{[round(t, 4) for t in latencies]}, detections {n_dets}; "
          f"synchronising operations in one request: {len(syncs)}")
    for msg in syncs[:5]:
        print(f"  {msg[:200]}")

    # forward throughput, the bench_detr configuration
    x = torch.randn(DETR_BATCH, *SIZE, 3, device=device).to(torch.bfloat16)
    mask = torch.zeros(DETR_BATCH, *SIZE, device=device)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x, mask), iters=10, warmup=2)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"detr_r50 bs{DETR_BATCH} {SIZE[0]}px bf16: forward {fwd_ms:.2f} "
          f"ms, {DETR_BATCH / fwd_ms * 1e3:.2f} images/s, peak memory "
          f"{peak_gib:.2f} GiB")
    profile_phase(model, x, mask)
    return latencies, fwd_ms


def _device_us(avg, self_only=False):
    """Device microseconds of a profiler average row (the attribute's name
    differs between PyTorch versions)."""
    prefix = "self_" if self_only else ""
    for name in (f"{prefix}device_time_total", f"{prefix}cuda_time_total"):
        if hasattr(avg, name):
            return getattr(avg, name)
    raise AttributeError("profiler rows carry no device time")


def _trace(model, x, mask, activities, n_fwd):
    from torch.profiler import profile
    with torch.inference_mode(), profile(activities=activities) as prof:
        for _ in range(n_fwd):
            model(x, mask)
        torch.cuda.synchronize()
    return prof


def _device_busy(prof):
    """(device activities, busy us, window us): kernels and copies as
    intervals on the device clock, their union, first start to last end."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, cur_start, cur_end = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    busy += cur_end - cur_start
    return len(spans), busy, spans[-1][1] - spans[0][0]


def profile_phase(model, x, mask, n_fwd=3):
    from torch.profiler import ProfilerActivity

    with torch.inference_mode():
        for _ in range(2):
            model(x, mask)
    # the idle share from a device-only trace: tracing host ops slows the
    # host, and with it the device's feed
    n_act, busy, window = _device_busy(
        _trace(model, x, mask, [ProfilerActivity.CUDA], n_fwd))
    prof = _trace(model, x, mask,
                  [ProfilerActivity.CPU, ProfilerActivity.CUDA], n_fwd)
    _, busy_host, window_host = _device_busy(prof)
    print(f"profile {n_fwd} forwards: {n_act / n_fwd:.1f} device activities "
          f"and {busy / n_fwd / 1e3:.3f} ms device-busy per forward; idle "
          f"share of the device window {1 - busy / window:.4f} (device-only "
          f"trace), {1 - busy_host / window_host:.4f} (with host ops traced)")

    # shares are of the device-busy time of the traced forwards
    rows = prof.key_averages()
    aten = sorted((r for r in rows if r.key.startswith("aten::")),
                  key=_device_us, reverse=True)[:15]
    kernels = sorted((r for r in rows if _device_us(r, self_only=True) > 0
                      and not r.key.startswith("aten::")),
                     key=lambda r: _device_us(r, self_only=True),
                     reverse=True)[:15]
    print("device ms per forward by aten op (children included; nested ops "
          "overlap):")
    for r in aten:
        us = _device_us(r)
        print(f"  {us / n_fwd / 1e3:8.3f} ms {us / busy_host:6.1%} "
              f"{r.count // n_fwd:5d} calls  {r.key}")
    print("device ms per forward by kernel (self):")
    for r in kernels:
        us = _device_us(r, self_only=True)
        print(f"  {us / n_fwd / 1e3:8.3f} ms {us / busy_host:6.1%} "
              f"{r.count // n_fwd:5d} calls  {r.key[:100]}")
    msda = [r for r in rows if r.key.startswith("void (anonymous namespace)"
                                                "::msda_forward_kernel")]
    msda_us = sum(_device_us(r, self_only=True) for r in msda)
    print(f"msda kernel: {msda_us / n_fwd / 1e3:.3f} ms per forward in "
          f"{sum(r.count for r in msda) // n_fwd} calls, "
          f"{msda_us / busy_host:.1%} of device-busy time")
    for r in msda:
        us = _device_us(r, self_only=True)
        print(f"  {us / n_fwd / 1e3:8.3f} ms {r.count // n_fwd:3d} calls  "
              f"{r.key.split('::', 1)[1].split('(')[0]}")

    with torch.inference_mode():
        syncs = syncs_of(lambda: model(x, mask))
    print(f"sync-debug: {len(syncs)} synchronising CUDA operations in one "
          "forward")
    for s in syncs[:5]:
        print(f"  {s[:200]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is False")
    from aloception_tpu_torch.ops.cuda.build import build_log, load_library

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    load_library("ms_deform_attn")
    print(f"built ms_deform_attn.cu in {time.perf_counter() - t0:.1f} s")
    report = ptxas_report(build_log("ms_deform_attn"))
    print("ptxas -v, per instance (dtype, vector bytes, levels unrolled per "
          "sub-group or 0 for the loop): registers, spill stores/loads bytes")
    for key, (regs, st, ld) in sorted(report.items()):
        flag = "  SPILLS" if st or ld else ""
        print(f"  {key}: {regs} registers, spills {st}/{ld}{flag}")

    errs, sites = kernel_phase(device)
    launches, parity, m16 = slice_phase(device)
    frame_launches = deformable_frame_phase(m16, device)
    del m16
    detr_parity_phase(device)
    detr_phase(device)

    enc, dec = sites["encoder"], sites["decoder"]
    print(json.dumps({"kernels": [{
        "name": "ms_deform_attn",
        "route": "cuda",
        "source": "aloception_tpu_torch/csrc/ms_deform_attn.cu",
        "replaces": "aloception_tpu/ops/pallas/ms_deform_attn_kernel.py:245",
        "launches": launches + frame_launches,
        "launches_by_path": {"fused_preprocess": launches,
                             "frame": frame_launches},
        "max_abs_err": max(v for k, v in errs.items() if "float32" in k),
        "max_abs_err_bf16": max(v for k, v in errs.items()
                                if "bfloat16" in k),
        "ms": enc["ms"], "ms_eager": enc["eager_ms"],
        "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        # no single PyTorch call computes MSDA
        "library_ms": None,
        "decoder_ms": dec["ms"], "decoder_ms_eager": dec["eager_ms"],
        "decoder_plain_ms": dec["plain_ms"],
        "decoder_bound_ms": dec["bound_ms"],
        "decoder_bound_by": dec["bound_by"],
        "plan": enc["plan"], "decoder_plan": dec["plan"],
        "step_ms": {"encoder": enc["steps"], "decoder": dec["steps"]},
        "registers": {"/".join(map(str, k)): v[0]
                      for k, v in sorted(report.items())},
        "slice_fp32_parity": parity,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
