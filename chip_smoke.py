"""Smoke run of the PyTorch port (``aloception_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``aloception_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once), prints ``ptxas -v``'s registers and spills of
   each MSDA instance and of the Hungarian kernel, and holds the MSDA
   kernel against its plain PyTorch version on the card, in float32 and
   bfloat16: at the
   encoder and decoder (level-split) calls of Deformable-DETR-R50 at 640 px
   and batch 16 (the main path's plans), at batch 4 (the panoptic
   path's) and at the export path's bs1 480x640 levels (Lq 6,380 and 300,
   the package's plans), at a small odd shape, with narrow
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
6. Holds the Hungarian kernel against its plain version (identical
   assignments, their largest query-index difference and count of
   differing targets reported; scipy's optimal total on integer costs with
   ties) at the
   training path's 48 matrices of 300 queries and at DETR's 8 of 100, and
   times it at the calls the training paths launch (``HUNGARIAN_TIMED``:
   Deformable bs8, DETR bs16, the multi-scale bs2 recipe) by CUDA graphs
   and eager launches, beside the plain version, its bound and the serial
   chain's us a step.
7. The training gate: one float32 Deformable-DETR-R50-refine train step at
   batch 2, 640x640, dropout 0, with the MSDA kernel forward against the
   plain forward (losses, the matched queries, every gradient: the
   sampling offsets' by their L2 gap), and against a plain step carrying
   the kernel's MSDA values (every gradient, 1e-5).
8. The training main path: Deformable-DETR-R50-refine (91 classes, float32,
   dropout 0.1) trains through ``make_deformable_detr_trainer(...).fit`` on
   the synthetic sample at batch 8, 640x640 (each batch's frames made and
   transformed inside its step): a warm-up step and 6 timed ones, each
   with 12 MSDA launches, 12 backward passes, one Hungarian
   launch and one synchronising operation; its profile; then a loss that
   falls over 10 steps on one repeated batch.
9. DETR-R50 (91 classes, float32) trains 8 batches of 16 at 384x384
   through ``make_detr_trainer(...).fit``: 2 optimizer updates.
10. RAFT and RAFT-small in float32 (TF32 off) at bs1 368x496, 12
    iterations: the card against the same model on the CPU, on the serving
    path (``only_last``) and the last flow of the all-iterations path; the
    bfloat16 RAFT against the float32 one on the card (printed).
11. RAFT serving at ``bench.py::bench_raft``'s configuration (hidden 128,
    context 128, fdim 256, 4 levels, radius 4, bfloat16, bs2 368x496, 12
    iterations, ``only_last``; built with no device named, so on the
    card): pairs/s, peak memory, the host's time to enqueue a forward and
    per device activity, the profile and syncs of one forward, and device
    time by region of the forward and kind of op.
12. RAFT's Frame path: 3 requests of 2 pairs of 436x1024 uint8 frames ->
    ``Frame`` -> ``norm_minmax_sym`` -> ``batch_list`` -> ``Padder`` ->
    RAFT -> ``unpad`` -> ``inference`` (a ``Flow`` per pair); latency and
    syncs. Then ``commands.eval_on_sintel --sample --limit_samples 2`` on
    the card. RAFT runs no kernel of the port.
13. Panoptic: the head on DETR-R50 (``DetrPanoptic()``, 100 queries) and on
    Deformable-DETR-R50 without refinement (300 queries), 250 classes,
    random weights. DETR-R50 panoptic in float32 at bs1 on a padded 384x512
    batch, the card against the CPU; Deformable panoptic in float32 at bs2
    640 px, the MSDA kernel path against the plain path. Then each in
    bfloat16 at 640x640 (DETR bs8, Deformable bs4, built with no device
    named): the outputs against the same weights in float32 on the card,
    whole and the head alone; images/s, peak memory, the detector and the
    head timed alone, profile (device-busy, idle share, 0 syncs a forward),
    device ms of the detector, the attention maps and the mask head, MSDA
    launches a forward (12 for Deformable); 3 Frame-path
    requests of 4 uint8 frames of mixed sizes -> ``inference_with_masks``
    (per-frame ``BoundingBoxes2D`` and ``Mask`` at the padded size; one sync
    a request); then ``commands.eval_on_coco --sample --limit_batches 2``
    for ``--model panoptic_deformable`` and ``--model panoptic`` on the
    card (AP and PQ).
14. Panoptic training (frozen detector, float32, TF32 off, 250 classes):
    one train step of Deformable-DETR-R50 panoptic at bs2 640 px on the
    MSDA kernel path against the plain path, and of DETR-R50 panoptic at
    bs2 384x512 on the card against the CPU (losses, every head gradient,
    matched queries); then each trains through
    ``make_panoptic_trainer(...).fit`` at its serving batch (DETR bs8,
    Deformable bs4, 640x640): step time, the host's time to prepare and
    copy a batch, peak memory, 12 MSDA launches (Deformable) and no MSDA
    backward pass a step, 2 Hungarian launches and one synchronising
    operation a batch, the profile with device ms by region, every detector
    parameter unchanged, the mask losses falling on a repeated batch.
15. RAFT training: one float32 train step at bs2 184x248, 12 iterations,
    the card against the CPU (loss, gradients, the cnet's running
    statistics); then ``make_raft_trainer(num_steps=...).fit`` at the
    reference's FlyingChairs stage, bs10 368x496, 12 iterations, on
    textured pairs with a known shift made inside the step: step time,
    pairs/s, peak memory, one sync a batch, the profile with device ms by
    region (the lookup's gather backward on its own), the EPE falling on a
    repeated batch.
16. The training commands on the card: ``train_on_coco --sample --model
    panoptic_deformable --fast_dev_run`` (its MSDA launches, no backward
    pass, the PQ table), ``train_on_chairs --sample --max_steps 4`` and
    ``eval_on_sintel --sample --ckpt_dir`` on its checkpoint.
16b. bfloat16 training (``bf16_train_phase``; the models built in float32,
    cast by the optimizer to compute in bfloat16 over float32 masters, the
    criterion in float32, TF32 off): a Deformable-DETR-R50-refine bf16
    train step at bs2 640 px with the MSDA kernel forward against the
    plain forward (both with the operator's bf16 recompute backward) and
    against a plain step carrying the kernel's values; Deformable-DETR-R50-
    refine on train_phase's 7 batches of 8 at 640x640 (12 MSDA launches and
    12 backward passes, one Hungarian launch and one sync a step; step ms,
    device-busy, peak memory beside the float32 ones; the MSDA bf16 forward
    at the first encoder call against the plain version, timed beside its
    bound); DETR-R50 8 batches of 16 at 384x384, accumulate 4; RAFT bs10
    368x496, 12 iterations, 7 steps (the two slow motion-encoder
    convolutions timed in bf16 and fp32, with the cuDNN kernels they run);
    each cell's loss over the float32 phase's step count on one repeated
    batch (``falling_eval_loss``: in eval mode, held to fall for
    Deformable-DETR and DETR; RAFT's on the batch's statistics,
    reported); ``train_on_coco --sample --fast_dev_run --bf16 --log
    tensorboard`` for ``deformable`` and
    ``panoptic_deformable``, each event file's records read back with
    their CRCs checked.
17. Export (float32, TF32 off): ``export_model --model deformable`` and
    ``--model detr --profile`` at the JAX defaults (batch 1, 480x640, 91
    classes): ``torch.export``, the AOTInductor compile and the package's
    sanity check, their seconds, the package's size and the peak memory;
    each package, as the command's ``Executor`` loaded it, held against
    the eager model on a seeded padded batch (1e-3 * max(1, max|ref|));
    the Deformable package's 12 MSDA launches a forward and its launch
    plans beside eager's; both latencies (p50/p99 to a synchronised end,
    device-busy ms); 4 requests of uint8 images of other sizes through
    ``ModelHandler`` on the same ``Executor`` (one fetch in postprocess,
    12 launches each) and a request of JPEG bytes, decoded on the host,
    whose boxes equal those of its pixels sent as an array; the ``bf16``
    profile's exported program against
    its eager module; the RAFT (``iters`` 2) and panoptic exporters'
    programs at the CPU tests' tiny widths; int8 weights-only
    Deformable-DETR-R50 (every int8 weight within half a step; the logits'
    deviation beside the JAX test's 5 % contract, with where it comes
    from) and a min-max calibration over two COCO sample batches.
18. aloscene's 3-D geometry (``geometry_phase``; torch ops, no kernel of
    the port, both kernel counts read around it and 0): the five rotated /
    3D IoU functions on 4,096 seeded pairs and the hard cases, the card
    against the CPU (1e-5); two KITTI-sized frames (375x1242 uint8, the
    published P2 intrinsic, 30 labelled 3D boxes, a dense planar depth and
    its disparity at baseline 0.54 m, 100 points, 20 oriented boxes)
    through resize -> crop -> hflip -> pad -> rotate 5 degrees ->
    ``batch_list``, back-projection, depth -> disparity -> depth and the
    enclosing 2D boxes, every payload against the CPU run (1e-4 of
    max(1, max|ref|)), the chain's warm ms and syncs; ``ApMetrics3D`` over
    100 frames of 100 predictions x 30 targets (maps equal to the CPU's,
    IoUs near a threshold printed, ms per ``add_sample``); pairwise 3D IoU
    at 500 x 200 (ms a call by CUDA events, device-busy ms and activities
    from a trace, the CPU's ms); ``DepthMetrics`` over 4 375x1242 pairs
    (1e-9 relative); the golden ``.flo`` and ``.pfm`` read exactly.
19. COCO on disk and the multi-scale recipe (``coco_disk_phase``): the
    port's decoders (Pillow for JPEG, the native loader built from
    ``aloception_tpu_torch/runtime/aloloader.cpp`` for PNG) decode every
    image fixture of ``tests/fixtures/torch_coco``, held
    bit-equal to the cv2 decode stored beside it, the corrupt one refused;
    the MSDA kernel against the plain version at each of the six
    ``MULTISCALE_BUCKETS``' level shapes (encoder Lq = Len_v and decoder Lq
    = 300, B = 2, locations within a padded item's valid ratios, fp32 and
    bf16, each plan printed) and the largest bucket's fp32 encoder call
    timed beside its bound; a COCO-format directory of the fixtures (16
    train, 200 val images, COCO's 80 category ids, polygons, a crowd RLE);
    ``train_on_coco --model deformable --multiscale --batch_size 2
    --max_steps 8`` (Deformable-DETR-R50-refine, float32): per step the
    bucket, host ms, the workers' decode and transform ms, peak memory,
    device-busy ms and idle share, 12 MSDA launches and backward passes and
    one Hungarian launch; the eval-mode loss of one repeated batch
    before and after 32 steps on it (``falling_eval_loss``);
    ``eval_on_coco --model deformable --multiscale`` on val2017 (AP,
    images/s after the first batch at each padded size, those batches' ms
    alone, data ms a batch); a ``FromDirectoryDataset`` request of the
    fixture folder through the Frame path (12 launches).
20. The flow datasets on disk (``flow_disk_phase``; RAFT runs no kernel of
    the port, both counts read around the path and 0): FlyingChairs2 (60
    train and 10 val pairs at its published 384x512, smooth seeded flows,
    occlusion PNGs) and Sintel (2 scenes x 6 frames at 436x1024, clean
    pass, ``.flo`` and occlusions) written by ``utils/flow_fixture.py``
    into a temporary root that the dataset config names; ``train_on_chairs
    --batch_size 10 --max_steps 6`` from those files (RAFT hidden 128, 4
    levels, radius 4, 12 iterations, float32): per step host ms, the
    workers' decode ms, the consumer's wait, ``prepare_batch``, device-busy
    ms and idle share, peak memory, one sync a batch; ``eval_on_sintel
    --limit_samples 8 --ckpt_dir`` on its checkpoint (EPE, pairs/s after
    the first pair, decode ms a pair), and over 2 pairs on the card and
    with ``--cpu`` (EPE within 1e-3 relative).
21. KITTI and Waymo on disk (``kitti_waymo_disk_phase``, no kernel): KITTI
    scene flow 2015 (8 frames at 375x1242, 16-bit flow and disparity PNGs,
    the published P_rect_02/P_rect_03) through float32 RAFT with
    ``Padder``, the EPE over the flow's valid pixels on the card against
    the CPU's (2 pairs, 1e-3 relative); ``KittiObject`` (100 frames, 30
    ``label_2`` boxes of the 8 classes, P2) into ``ApMetrics3D`` (maps
    equal to the CPU's, ms per ``add_sample``); ``KittiDepth`` (4 sparse
    maps) into ``DepthMetrics`` (1e-9 relative); a Waymo TFRecord (10 front
    camera frames at 1280x1920, 30 3-D boxes a frame, the calibration)
    through ``WaymoDataset.prepare`` and T=2 sequences, each frame's boxes,
    intrinsic and extrinsic on the card, the vertices in the camera frame,
    their projections and the enclosing 2-D boxes against the CPU's (1e-4
    of max(1, max|ref|)).
22. MOT17, CrowdHuman and WoodScape on disk, the views and the renderer
    (``tracking_views_disk_phase``): directories at the published sizes
    written from seeds by ``utils/tracking_fixture.py``. CrowdHuman (12
    train and 4 val JPEGs, half at 1600x2400) through ``prepare()`` (to the
    800/1333 rule) into Deformable-DETR-R50-refine training (1 class,
    float32, random weights) through a data module in the JAX tutorial
    13's pattern and ``Trainer.fit``: 4 steps of 2 at the multi-scale
    geometry, one validation pass of 2 batches with
    ``ObjectDetectorCallback`` and the TensorBoard logger (72 MSDA forward
    launches, 48 backward passes, 6 Hungarian launches; the losses finite;
    the logged images read back from the event file equal the views drawn
    on the CPU from the same predictions); MOT17 (an -FRCNN sequence of 8
    frames at 1080x1920 and a -DPM one that ``detections_set`` drops)
    through ``norm_resnet`` -> resize (800/1333) -> the trained detector
    in eval mode -> ``inference`` (12 MSDA launches an item), a Renderer
    grid of the ground-truth and predicted views over T saved and read
    back; WoodScape (966x1280, one frame a camera, boxes and gtLabels)
    through ``WooDScapeSplitDataset``; ``Frame.get_view`` of the frames on
    the card, the boxes', masks' and the KITTI scene's 3-D boxes' views,
    each equal to the CPU's; read, prepare, step, device-busy, view and
    grid times beside the card's name and power limit.
23. ``parallel/`` (``parallel_phase``; no kernel of its own, the MSDA and
    Hungarian kernels launched on every rank): Deformable-DETR-R50-refine
    (float32, TF32 off, dropout 0) at 640x640 through ``Trainer.fit``, as
    (a) two ranks on the one card over gloo with CUDA tensors, started by
    ``init_multihost``: 2 DDP steps of bs1 a rank against one process
    stepping the global bs2 batch row by row (the ranks' numerics) and,
    printed, batched; then a sequence-parallel run (sp 2: both rows a rank,
    the encoder's tokens split, its MSDA launches at Lq 4,250, their plan
    recorded) against the batched step; RAFT (hidden 128, 4 levels) one DDP
    step of bs1 a rank at 368x496, its running statistics against the
    global batch's (1e-5); (b) a world of one on NCCL: the same steps under
    a mesh of one (DDP) and under FSDP against the unwrapped step; (c)
    ``parallel.dryrun`` on 8 CPU gloo ranks at tiny widths (FSDP, TP, SP
    and the pipeline, the checks that the sharding is real). Gates: losses
    1e-4 relative, gradients 1e-3 of max|g| (the tensors feeding the
    sampling locations by L2 at 1e-2), matched queries equal, the ranks'
    parameters equal and within 1e-5 * max(1, max|p|) of the one process's
    but for 1e-4 of them (AdamW's steps of near-zero gradients); step ms,
    peak GiB, collectives and kernel counts printed; one process run twice
    gives the floor.

Prints the card's name and power limit, one JSON line describing the
kernels, and last ``{"ok": true, "device": {...}}``. Any failure raises: the exit code
is then not 0 and no result line is printed. Needs a CUDA card; never
imports JAX.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import time
import warnings
from unittest import mock

import torch

LEVELS_640 = ((80, 80), (40, 40), (20, 20), (10, 10))
# the exported Deformable-DETR-R50's levels at 480x640
LEVELS_480 = ((60, 80), (30, 40), (15, 20), (8, 10))
NH, C, P = 8, 32, 4
# name: (level shapes, B, Lq, C, location range); the encoder and decoder
# cases are the main path's calls, so their plans are the ones it launches
KERNEL_CASES = {
    "encoder": (LEVELS_640, 16, 8500, C, (0.0, 1.0)),
    # the decoder site: its plan splits the levels across sub-groups
    "decoder": (LEVELS_640, 16, 300, C, (0.0, 1.0)),
    # the panoptic Deformable path's calls at its served batch of 4
    "encoder_bs4": (LEVELS_640, 4, 8500, C, (0.0, 1.0)),
    "decoder_bs4": (LEVELS_640, 4, 300, C, (0.0, 1.0)),
    # the export path's calls: the package at bs1, 480x640
    "encoder_export": (LEVELS_480, 1, 6380, C, (0.0, 1.0)),
    "decoder_export": (LEVELS_480, 1, 300, C, (0.0, 1.0)),
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
# the autograd node of the operator aloception_tpu_torch::ms_deform_attn
MSDA_BACKWARD_NODE = "GeneratedBackwardFor_aloception_tpu_torch_ms_deform_attn"
BATCH, RAW_HW, SIZE = 16, (480, 640), (640, 640)
N_REQUESTS = 3
MSDA_CALLS_PER_FORWARD = 12      # 6 encoder + 6 decoder layers
# DETR-R50: the bench_detr batch; Frame-path frame sizes (H, W) are drawn
# from these ranges
DETR_BATCH = 32
FRAME_H, FRAME_W = (360, 640), (480, 640)
DETR_CLASSES = 91                # + the background class
# Hungarian kernel vs plain version: name -> (matrices, queries, targets,
# n_valid drawn in turn from, integer costs with ties)
HUNGARIAN_CASES = {
    "deformable": (48, 300, 100, (0, 1, 7, 37, 100), False),
    "deformable_ties": (48, 300, 100, (0, 1, 7, 37, 100), True),
    "detr": (8, 100, 100, (0, 1, 7, 37, 100), False),
    "detr_ties": (8, 100, 100, (0, 1, 7, 37, 100), True),
}
# the calls the training paths launch, timed: (matrices, queries, targets,
# n_valid drawn in turn from): Deformable-DETR-R50 at batch 8 (6 decoder
# outputs x 8, 300 queries) at a few targets and at the capacity of 100;
# DETR-R50 at batch 16 (6 x 16, 100 queries) at 7 and at 100 targets; the
# multi-scale recipe at batch 2 (6 x 2, 300 queries, COCO's <= 40 objects)
HUNGARIAN_TIMED = ((48, 300, 7, (7,)), (48, 300, 100, (100,)),
                   (96, 100, 100, (7,)), (96, 100, 100, (100,)),
                   (12, 300, 100, (40, 13, 2, 27)))
HUNGARIAN_HEADLINE = (48, 300, 100, (100,))
# training: Deformable-DETR-R50-refine at batch 8, 640 x 640, float32; one
# warm-up step, then the timed ones; a loss that falls on a repeated batch;
# the fp32 gate of the kernel forward against the plain one at batch 2
TRAIN_BATCH, TRAIN_SIZE = 8, (640, 640)
TRAIN_STEPS = 6
OVERFIT_STEPS = 10
GATE_BATCH = 2
# the train gate's gradient tolerances (train_gate_phase): two correct fp32
# kernels read up to 3.4e-3 against the plain forward on 8 batches, faulty
# forwards 0.14 or more; the kernel-valued replay 1.2-1.7e-6
# (scripts/train_gate_probe.py on an H100)
GATE_GRAD_TOL, GATE_OFFSETS_L2_TOL, GATE_REPLAY_TOL = 1e-2, 1e-2, 1e-5
# DETR-R50 training, short: 8 batches of 16 at 384 x 384, accumulate 4
DETR_TRAIN_BATCH, DETR_TRAIN_SIZE, DETR_TRAIN_BATCHES = 16, (384, 384), 8
KERNEL_SOURCES = ("ms_deform_attn", "hungarian")
# RAFT (hidden 128, context 128, fdim 256, 4 levels, radius 4) at
# bench_raft's configuration (bench.py:129-143): batch 2, 368x496, bfloat16,
# 12 iterations, only_last; the Frame path takes Sintel-sized frames
RAFT_BATCH, RAFT_HW, RAFT_ITERS = 2, (368, 496), 12
SINTEL_HW = (436, 1024)
# panoptic: the head on DETR-R50 (100 queries) and on Deformable-DETR-R50
# without refinement (300 queries, as eval_on_coco builds it), 250 classes,
# bfloat16 at 640x640, DETR at batch 8 and Deformable at batch 4; the fp32
# gates (DETR card vs CPU at bs1 on a padded 384x512 batch, Deformable
# kernel vs plain path at bs2 640 px); Frame-path requests of 4 frames of
# mixed sizes
PANOPTIC_CLASSES = 250
PANOPTIC_BATCH = {"detr_r50_panoptic": 8, "deformable_detr_r50_panoptic": 4}
PANOPTIC_GATE_HW, PANOPTIC_GATE_FRAME = (384, 512), (352, 480)
PANOPTIC_FRAMES = ((480, 640), (427, 640), (427, 640), (480, 640))
PANOPTIC_REGIONS = ("detector", "bbox_attention", "mask_head")
# the served bf16 outputs against the same weights in float32 on the same
# inputs, max|diff| / max(1, max|ref|) over masks, logits and boxes: the
# whole forward (bf16 through the detector's 12 layers), and the head alone
# on the float32 detector's outputs rounded to bf16 (bf16's unit roundoff
# is 2^-8, 3.9e-3)
PANOPTIC_BF16_TOL = {"forward": 1e-1, "head": 5e-2}
# eval_on_coco's thresholds: softmax over the background class for DETR,
# sigmoid at 0.2 for Deformable-DETR
# panoptic training (frozen detector, float32) at the serving batches and
# 640x640; the gates at bs2 (Deformable kernel vs plain path at 640 px, DETR
# card vs CPU at 384x512)
# RAFT training: the gate at bs2 184x248 card vs CPU; the reference's
# FlyingChairs stage (train_standard.sh: bs10, 368x496, lr 4e-4, wd 1e-4),
# 12 iterations; an EPE that falls on a repeated batch
RAFT_GATE_BATCH, RAFT_GATE_HW = 2, (184, 248)
RAFT_TRAIN_BATCH, RAFT_TRAIN_HW = 10, (368, 496)
RAFT_TRAIN_STEPS, RAFT_OVERFIT_STEPS = 6, 12
# export: the JAX exporter's defaults, fp32 with TF32 off, batch 1,
# 480x640, 91 classes; packages go where builds go (git-ignored); 4 requests
# of uint8 images of other sizes through the handler; the tiny exporters'
# shapes; the JAX test's int8 contract (5 % of max|fp32 logits|, on a tiny
# DETR) and the calibration over two COCO sample batches
EXPORT_HW = (480, 640)
EXPORT_DIR = "aloception_tpu_torch/_build/export"
EXPORT_REQUEST_HW = ((360, 480), (427, 640), (600, 800), (256, 320))
EXPORT_TIMED = 20
TINY_EXPORT_HW, TINY_RAFT_ITERS = (64, 96), 2
INT8_CONTRACT, CALIB_BATCHES, CALIB_BATCH = 0.05, 2, 2
# COCO on disk and the multi-scale recipe: the image fixtures (decoded and
# held against their stored cv2 decodes), a COCO-format directory of 16
# train and 200 val images made from them, train_on_coco --multiscale at bs2
# for 8 steps, the eval-mode loss of one repeated batch before and after 32
# steps on it (after 16 it rose in 3 of 10 runs, 5 on each tree, by up to
# 1.13, since the loss of a random model oscillates over such steps; after
# 32 it fell in all 10, by 3.6-9.4: scripts/overfit_check_probe.py on an
# H100), eval_on_coco --multiscale on val2017 and a FromDirectoryDataset
# request; the MSDA kernel held against the plain version at each bucket's
# level shapes
FIXTURE_DIR = "tests/fixtures/torch_coco"
COCO_TRAIN_IMAGES, COCO_VAL_IMAGES = 16, 200
MULTISCALE_BATCH, MULTISCALE_STEPS, MULTISCALE_OVERFIT = 2, 8, 32
# valid ratios (H, W) of the two items of a padded bucket batch
BUCKET_VALID = ((1.0, 1.0), (0.77, 0.6))
PANOPTIC_INFERENCE = {
    "detr_r50_panoptic": dict(threshold=0.0,
                              background_class=PANOPTIC_CLASSES,
                              activation_fn="softmax"),
    "deformable_detr_r50_panoptic": dict(threshold=0.2,
                                         activation_fn="sigmoid")}


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
    touches, read once, all of loc and w, and out, written once. FMAs: the
    operator's count (``msda_fmas``: one per channel of each such corner,
    the attention weight folded into the corner weights). Gathered bytes:
    one corner row per such corner, what a gather pulls from L2."""
    from aloception_tpu_torch.ops.ms_deform_attn import (msda_corners,
                                                         msda_fmas)
    B, len_v, nH, Cv = value.shape
    item = value.element_size()
    flat = [s for hw in shapes for s in hw]
    wl = torch.tensor([wd for _, wd in shapes], device=loc.device)[:, None]
    start = torch.tensor([0] + [h * wd for h, wd in shapes][:-1],
                         device=loc.device).cumsum(0)[:, None]
    b = torch.arange(B, device=loc.device).view(B, 1, 1, 1, 1)
    h = torch.arange(nH, device=loc.device).view(1, 1, nH, 1, 1)
    rows = [((b * len_v + start + cy * wl + cx) * nH + h)[ok]
            for cx, cy, ok in msda_corners(flat, loc, w)]
    n_rows = int(torch.unique(torch.cat(rows)).numel())
    nbytes = (n_rows * Cv + loc.numel() + w.numel()
              + loc.shape[0] * loc.shape[1] * nH * Cv) * item
    fmas = msda_fmas(value.shape, flat, loc, w)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * fmas / FP32_FLOP_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, nbytes, fmas, fmas * item


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


def plan_of(value, shapes, loc, w):
    """The launch plan the MSDA wrapper picks for these inputs."""
    from aloception_tpu_torch.ops.cuda.ms_deform_attn_kernel import launch_plan
    B, len_v, nH, Cv = value.shape
    return launch_plan(B, loc.shape[1], nH, Cv, len(shapes), loc.shape[4],
                       len_v, value.element_size(), value.data_ptr(),
                       loc.data_ptr(), w.data_ptr())


def brief(plan):
    return (f"vec {plan.vec_bytes} B, split {plan.split}, "
            f"{'unrolled (4, 4)' if plan.unrolled else 'runtime loop'}"
            f"{', points shared' if plan.share_points else ''}")


def kernel_phase(device):
    import dataclasses
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda
    from aloception_tpu_torch.ops.cuda.ms_deform_attn_kernel import LaunchPlan
    from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch

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
    profile_phase(lambda: m16(x, mask))
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
    profile_phase(lambda: model(x, mask))
    return latencies, fwd_ms


def _device_us(avg, self_only=False):
    """Device microseconds of a profiler average row (the attribute's name
    differs between PyTorch versions)."""
    prefix = "self_" if self_only else ""
    for name in (f"{prefix}device_time_total", f"{prefix}cuda_time_total"):
        if hasattr(avg, name):
            return getattr(avg, name)
    raise AttributeError("profiler rows carry no device time")


def _trace(fn, activities, n):
    """A profile of ``n`` calls of ``fn``, ending in a synchronise."""
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        for _ in range(n):
            fn()
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


def profile_phase(fn, n_fwd=3):
    """Profile ``n_fwd`` steady calls of ``fn`` (a forward, run under
    inference mode): device activities, busy time and idle share from a
    device-only trace, device time by aten op and by kernel, the MSDA
    kernels' share where they ran, and the synchronising operations of one
    call. Returns (the trace with host ops, device-busy us per call, idle
    share, synchronising operations in one call, device activities per
    call)."""
    from torch.profiler import ProfilerActivity

    def forward():
        with torch.inference_mode():
            fn()

    for _ in range(2):
        forward()
    # the idle share from a device-only trace: tracing host ops slows the
    # host, and with it the device's feed
    n_act, busy, window = _device_busy(
        _trace(forward, [ProfilerActivity.CUDA], n_fwd))
    prof = _trace(forward, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  n_fwd)
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
    if msda:
        msda_us = sum(_device_us(r, self_only=True) for r in msda)
        print(f"msda kernel: {msda_us / n_fwd / 1e3:.3f} ms per forward in "
              f"{sum(r.count for r in msda) // n_fwd} calls, "
              f"{msda_us / busy_host:.1%} of device-busy time")
        for r in msda:
            us = _device_us(r, self_only=True)
            print(f"  {us / n_fwd / 1e3:8.3f} ms {r.count // n_fwd:3d} calls  "
                  f"{r.key.split('::', 1)[1].split('(')[0]}")

    with torch.inference_mode():
        syncs = syncs_of(fn)
    print(f"sync-debug: {len(syncs)} synchronising CUDA operations in one "
          "forward")
    for s in syncs[:5]:
        print(f"  {s[:200]}")
    return prof, busy / n_fwd, 1 - busy / window, len(syncs), n_act / n_fwd


def hungarian_inputs(M, nq, nt, choices, ties, seed):
    """(cost (M, nq, nt) float32, n_valid (M,) int32) on the CPU: uniform
    costs, or integers in [0, 4) with many ties."""
    g = torch.Generator().manual_seed(seed)
    cost = (torch.randint(0, 4, (M, nq, nt), generator=g).float() if ties
            else torch.rand(M, nq, nt, generator=g))
    n_valid = torch.tensor([choices[k % len(choices)] for k in range(M)],
                           dtype=torch.int32)
    return cost, n_valid


def hungarian_tag(shape):
    M, nq, nt, choices = shape
    return f"({M}, {nq}, {nt}) n_valid {'/'.join(map(str, choices))}"


def hungarian_times(fn, cost, n_valid):
    """``fn``'s device ms a call by CUDA graphs and by eager launches on
    ``cost``/``n_valid`` (CPU tensors, the call's inputs), the bound for
    these inputs and the serial chain: the dependent augmenting steps of
    each matrix (``jv_solve``), the longest one's and us of kernel time a
    step of it."""
    from aloception_tpu_torch.ops.hungarian import jv_solve
    M, nq, nt = cost.shape
    ms = graph_ms(fn, iters=10, reps=3)
    eager_ms = cuda_ms(fn, iters=10, warmup=2)
    # the work these inputs need: each augmenting step relaxes the unused
    # columns (two subtractions and a compare) and moves the potentials (a
    # subtraction) over all Nq columns; bytes: the n_valid targets of each
    # query read once, n_valid, the (M, Nt) output written once
    steps = [jv_solve(cost[k, :, :int(n)].T.numpy())[1] if n else 0
             for k, n in enumerate(n_valid.tolist())]
    nbytes = 4 * (nq * int(n_valid.sum()) + M + M * nt)
    flops = 4 * sum(steps) * nq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return dict(ms=ms, eager_ms=eager_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, max_steps=max(steps),
                mean_steps=sum(steps) / M,
                us_per_step=ms * 1e3 / max(1, max(steps)))


def hungarian_line(row):
    return (f"kernel {row['ms']:.4f} ms (graph), {row['eager_ms']:.4f} ms "
            f"(eager launches); bound {row['bound_ms'] * 1e3:.3f} us by "
            f"{row['bound_by']} ({row['bytes'] / 1e6:.3f} MB, "
            f"{row['flops'] / 1e6:.2f} M fp32 ops), {row['bound_ms'] / row['ms']:.2%} "
            f"of it; serial chain: {row['max_steps']} dependent augmenting "
            f"steps in the longest matrix (mean {row['mean_steps']:.1f}), "
            f"{row['us_per_step']:.3f} us of kernel time a step")


def hungarian_phase(device):
    """The Hungarian kernel against its plain version: identical
    assignments in every case, scipy's optimal total on the tie cases; its
    times at the training paths' calls beside the plain version's, its
    bound and the serial chain."""
    from scipy.optimize import linear_sum_assignment
    from aloception_tpu_torch.ops.cuda import hungarian_cuda
    from aloception_tpu_torch.ops.hungarian import hungarian, hungarian_torch

    # the largest difference of a matched query index between the kernel
    # and the plain version, and the count of targets matched differently,
    # over every case and timed shape; both must be 0
    diff = dict(max_abs_err=0, mismatched=0)

    def held(got, want, tag):
        d = (got.long() - want.long()).abs()
        diff["max_abs_err"] = max(diff["max_abs_err"], int(d.max()))
        diff["mismatched"] += int((d != 0).sum())
        if d.any():
            raise AssertionError(f"hungarian {tag}: the kernel's assignment "
                                 f"differs from the plain version's at "
                                 f"{int((d != 0).sum())} targets, by up to "
                                 f"{int(d.max())} in query index")

    for seed, (name, (M, nq, nt, choices, ties)) in enumerate(
            HUNGARIAN_CASES.items()):
        cost, n_valid = hungarian_inputs(M, nq, nt, choices, ties, seed)
        got = hungarian(cost.to(device), n_valid.to(device)).cpu()
        held(got, hungarian_torch(cost, n_valid), name)
        for k in range(M if ties else 0):
            n = int(n_valid[k])
            c = cost[k, :, :n].T.double().numpy()
            r, q = linear_sum_assignment(c)
            if n and c[range(n), got[k, :n].numpy()].sum() != c[r, q].sum():
                raise AssertionError(f"hungarian {name}[{k}]: total cost is "
                                     "not scipy's optimum")
        print(f"hungarian {name}: {M} x ({nq} queries, {nt} targets), "
              f"n_valid {sorted(set(n_valid.tolist()))}: assignment identical "
              f"to the plain version's"
              f"{'; totals equal scipy optimum' if ties else ''}")

    timed = {}
    for shape in HUNGARIAN_TIMED:
        M, nq, nt, choices = shape
        cost, n_valid = hungarian_inputs(M, nq, nt, choices, False, seed=7)
        t0 = time.perf_counter()
        want = hungarian_torch(cost, n_valid)
        plain_ms = (time.perf_counter() - t0) * 1e3
        c_d, n_d = cost.to(device), n_valid.to(device)
        held(hungarian_cuda(c_d, n_d).cpu(), want, hungarian_tag(shape))
        row = hungarian_times(lambda: hungarian_cuda(c_d, n_d), cost, n_valid)
        row["plain_ms"] = plain_ms
        print(f"hungarian {hungarian_tag(shape)}: {hungarian_line(row)}; "
              f"plain version on the host {plain_ms:.2f} ms")
        timed[shape] = row
    print(f"hungarian kernel vs plain version over every case and timed "
          f"shape: max query-index difference {diff['max_abs_err']}, "
          f"{diff['mismatched']} targets matched differently")
    return timed, diff


class SampledLoader:
    """``n`` batches, lists of ``batch_size`` frames of ``dataset`` drawn
    with replacement by a seeded generator (the synthetic sample has 12,
    fewer than a batch of 16). Each frame is made and transformed when the
    loop asks for its batch, as the data module's loader does, so that work
    falls inside the trainer's step; ``seconds`` keeps its host time per
    batch."""

    def __init__(self, dataset, batch_size, n, seed):
        g = torch.Generator().manual_seed(seed)
        self.dataset = dataset
        self.rows = torch.randint(len(dataset), (n, batch_size),
                                  generator=g).tolist()
        self.seconds = []

    def __len__(self):
        return len(self.rows)

    def __iter__(self):
        for row in self.rows:
            t0 = time.perf_counter()
            frames = [self.dataset[i] for i in row]
            self.seconds.append(time.perf_counter() - t0)
            yield frames


def one_batch(dataset, batch_size, seed):
    """One batch of ``SampledLoader``, made now."""
    return next(iter(SampledLoader(dataset, batch_size, 1, seed)))


def _counts():
    from aloception_tpu_torch.ops.cuda import hungarian_cuda, ms_deform_attn_cuda
    return (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.backward_passes,
            hungarian_cuda.launches)


def _reset_counts():
    from aloception_tpu_torch.ops.cuda import hungarian_cuda, ms_deform_attn_cuda
    ms_deform_attn_cuda.launches = ms_deform_attn_cuda.backward_passes = 0
    hungarian_cuda.launches = 0


def _sync_messages(caught):
    return [w for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def make_recorder():
    """A Trainer callback that reads, at the end of each train batch (just
    after the batch's metrics fetch), the host clock, the kernel counters,
    the synchronising operations recorded so far in ``caught`` and the
    batch's metrics."""
    from aloception_tpu_torch.train import Callback

    class Recorder(Callback):
        def __init__(self):
            self.rows, self.caught = [], []

        def on_train_batch_end(self, trainer, metrics, step):
            self.rows.append(dict(t=time.perf_counter(), counts=_counts(),
                                  syncs=len(_sync_messages(self.caught)),
                                  metrics=metrics))

    return Recorder()


def recorded_fit(trainer, recorder, batches):
    """``trainer.fit`` over ``batches`` (one epoch, no validation) with the
    counters set to 0 just before and synchronising operations recorded.
    Returns per batch (host seconds, (msda launches, msda backward passes,
    hungarian launches), synchronising operations, metrics)."""
    torch.cuda.synchronize()
    _reset_counts()
    recorder.rows = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            recorder.caught = caught
            t0 = time.perf_counter()
            trainer.fit(batches, None, max_epochs=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    prev = dict(t=t0, counts=(0, 0, 0), syncs=0)
    per_batch = []
    for row in recorder.rows:
        per_batch.append((row["t"] - prev["t"],
                          tuple(a - b for a, b in zip(row["counts"],
                                                      prev["counts"])),
                          row["syncs"] - prev["syncs"], row["metrics"]))
        prev = row
    return per_batch


def eval_loss(trainer, frames, device, key="loss_total"):
    """The loss of one batch by the trainer's criterion, the model in eval
    mode (dropout off, BatchNorm on its running statistics), no
    gradients."""
    from aloception_tpu_torch.train.trainer import to_device
    prepared = trainer.prepare_batch(frames)
    _, keys, packed = trainer.eval_step(
        to_device(prepared["inputs"], device),
        to_device(prepared["targets"], device))
    return dict(zip(keys, packed.cpu().tolist()))[key]


def batch_stats_loss(trainer, frames, device, key="loss_total"):
    """The loss of one RAFT batch by its criterion with the model in train
    mode (BatchNorm on the batch's statistics; RAFT has no dropout), no
    gradients and no update: the running statistics the forward moves are
    put back. RAFT's eval-mode loss reads the cnet's running statistics,
    which trail the weights a repeated batch's steps move (ROADMAP C4)."""
    from aloception_tpu_torch.train.trainer import to_device
    from aloception_tpu_torch.train.trainers import _raft_criterion
    model = trainer.model
    prepared = trainer.prepare_batch(frames)
    inputs = to_device(prepared["inputs"], device)
    targets = to_device(prepared["targets"], device)
    stats = {n: b.clone() for n, b in model.named_buffers()}
    model.train()
    with torch.no_grad():
        flows = model(*inputs, iters=RAFT_ITERS)
        _, metrics = _raft_criterion([f.float() for f in flows], targets)
        for n, b in model.named_buffers():
            b.copy_(stats[n])
    return metrics[key].item()


def falling_eval_loss(trainer, recorder, frames, steps, device, tag,
                      key="loss_total", measure=None, hold=True):
    """The check that training moves the model: the batch's eval-mode loss
    (``eval_loss``) before ``steps`` train steps on it and after them must
    have fallen. A train step's own loss is drawn under dropout, and in
    ``multiscale_train_phase`` it swung by 2-4 around ~20 from step to step
    (ROADMAP C4); the eval-mode loss is not. ``measure`` reads the loss
    in place of ``eval_loss`` (``batch_stats_loss`` for RAFT); with
    ``hold=False`` a loss that did not fall is reported, not raised.
    Returns before, after, their margin, whether it fell and the train
    steps' losses."""
    measure = measure or eval_loss
    before = measure(trainer, frames, device, key)
    per_batch = recorded_fit(trainer, recorder, [frames] * steps)
    _check_losses(per_batch, tag)
    after = measure(trainer, frames, device, key)
    losses = [m[key] for _, _, _, m in per_batch]
    mode = "eval-mode" if measure is eval_loss else measure.__name__
    print(f"{tag}: {mode} {key} {before:.4f} before {steps} steps, "
          f"{after:.4f} after (margin {before - after:.4f}); the steps' "
          f"{key} {[round(v, 4) for v in losses]}")
    if hold and not after < before:
        raise AssertionError(f"{tag}: the {mode} {key} did not fall "
                             f"({before} -> {after})")
    return dict(before=before, after=after, margin=before - after,
                fell=after < before, steps=steps, train_losses=losses)


def _check_losses(per_batch, tag):
    import math
    for i, (_, _, _, metrics) in enumerate(per_batch):
        bad = [k for k, v in metrics.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{tag} batch {i}: non-finite {bad}")


def gate_setup(device, seed=20):
    """The train gate's Deformable-DETR-R50-refine (float32, dropout 0,
    sampling that depends on the query, as in slice_phase) and one batch of
    GATE_BATCH at TRAIN_SIZE from the data module's train transforms, drawn
    by ``one_batch(..., seed)``, on the card."""
    from aloception_tpu_torch.models.deformable_detr import deformable_detr_r50
    from aloception_tpu_torch.models.deformable_detr import ms_deform_attn \
        as msda_module
    from aloception_tpu_torch.train import CocoDetection2Detr
    from aloception_tpu_torch.train.trainer import to_device

    model = deformable_detr_r50(
        num_classes=91, with_box_refine=True, dropout=0.0, device=device,
        generator=torch.Generator(device=device).manual_seed(0)).train()
    g = torch.Generator(device=device).manual_seed(2)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, msda_module.MSDeformAttn):
                mod.sampling_offsets.weight.normal_(0.0, 0.1, generator=g)
                mod.attention_weights.weight.normal_(0.0, 0.1, generator=g)
    dm = CocoDetection2Detr(batch_size=GATE_BATCH, sample=True,
                            size=TRAIN_SIZE)
    batch = dm.prepare_batch(one_batch(dm.train_dataset, GATE_BATCH,
                                       seed=seed))
    images, mask = to_device(batch["inputs"], device)
    return model, images, mask, to_device(batch["targets"], device)


def gate_step(model, images, mask, targets, msda=None):
    """One train step's losses, every parameter's gradient and the matched
    queries, its 12 MSDA calls made by ``msda`` (the model's own, the kernel
    operator, without)."""
    from aloception_tpu_torch.models.deformable_detr import (
        deformable_criterion)
    from aloception_tpu_torch.models.deformable_detr import ms_deform_attn \
        as msda_module
    from aloception_tpu_torch.models.deformable_detr.criterion import (
        focal_cost_matrix)
    from aloception_tpu_torch.models.detr.matcher import match_outputs
    from aloception_tpu_torch.train.step import to_float32

    with mock.patch.object(msda_module, "ms_deform_attn",
                           msda or msda_module.ms_deform_attn):
        model.zero_grad(set_to_none=True)
        out = to_float32(model(images, mask))
        loss, metrics = deformable_criterion(out, targets)
        loss.backward()
    matched = match_outputs([out] + out["aux_outputs"], targets,
                            focal_cost_matrix)
    grads = {n: p.grad.detach().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    return ({k: v.item() for k, v in metrics.items()}, grads,
            torch.stack(matched))


def gate_grad_errors(got, want):
    """A step's gradients against a reference step's, by kind of tensor:
    ``dense``, over every tensor but the sampling offsets' (the
    ``sampling_offsets`` Linear of each MSDA layer), the largest max|gap| /
    max|g|; ``offsets``, over the sampling offsets', the largest
    ||gap||_2 / ||g||_2 (``offsets_max``: their max|gap| / max|g|, not
    held); ``all``, max|gap| / max|g| over every tensor. Each (error,
    tensor)."""
    if got.keys() != want.keys():
        raise AssertionError("train gate: gradients of other parameters")
    out = dict(dense=(0.0, None), offsets=(0.0, None),
               offsets_max=(0.0, None), all=(0.0, None))

    def ratio(gap, ref):
        return gap / ref if ref else (0.0 if gap == 0 else float("inf"))
    for n, ref in want.items():
        gap = got[n] - ref
        errs = {"all": ratio(gap.abs().max().item(), ref.abs().max().item())}
        if "sampling_offsets" in n:
            errs["offsets"] = ratio(gap.norm().item(), ref.norm().item())
            errs["offsets_max"] = errs["all"]
        else:
            errs["dense"] = errs["all"]
        for k, e in errs.items():
            if e > out[k][0]:
                out[k] = (e, n)
    return out


def train_gate_phase(device, seed=20):
    """One Deformable-DETR-R50-refine train step, float32, TF32 off, dropout
    0, batch 2 at 640 x 640: the MSDA kernel forward (through the
    operator's autograd) against the plain forward, same model and batch:
    losses to 1e-4 relative, the matched queries equal; every gradient but
    the sampling offsets' to GATE_GRAD_TOL of its max|g|, and the sampling
    offsets' by their L2 gap, to GATE_OFFSETS_L2_TOL of their norm: a
    sampling point that fp32 rounding moves across a cell border changes
    its location gradient by O(1), so two correct fp32 forwards give
    sampling-offset gradients up to ~1e-2 of max|g| apart at single
    entries, and the other tensors up to ~3e-3 through them
    (``scripts/train_gate_probe.py`` reads both measures on 8 batches and
    on faulty forwards). Then the kernel step against a plain
    step whose MSDA calls carry the kernel step's values through the plain
    version's autograd graph (the backward wiring alone): every gradient to
    GATE_REPLAY_TOL of its max|g|."""
    from aloception_tpu_torch.models.deformable_detr import ms_deform_attn \
        as msda_module
    from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch

    model, images, mask, targets = gate_setup(device, seed)
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

    _reset_counts()
    k_loss, k_grads, k_matched = gate_step(model, images, mask, targets,
                                           recorded)
    kernel_counts = _counts()
    p_loss, p_grads, p_matched = gate_step(model, images, mask, targets,
                                           ms_deform_attn_torch)
    f_loss, f_grads, _ = gate_step(model, images, mask, targets,
                                   kernel_valued)
    if kernel_counts[:2] != (MSDA_CALLS_PER_FORWARD,) * 2 \
            or _counts()[:2] != kernel_counts[:2]:
        raise AssertionError(f"train gate: msda (launches, backward passes) "
                             f"{kernel_counts[:2]} on the kernel step, "
                             f"{_counts()[:2]} after the plain ones")
    loss_err = max(abs(k_loss[k] - p_loss[k]) / max(abs(p_loss[k]), 1e-12)
                   for k in p_loss)
    # the replay reproduces the kernel step's forward
    replay_err = max(abs(k_loss[k] - f_loss[k]) / max(abs(k_loss[k]), 1e-12)
                     for k in k_loss)
    errs = gate_grad_errors(k_grads, p_grads)
    replay = gate_grad_errors(k_grads, f_grads)["all"]
    same = torch.equal(k_matched, p_matched)
    print(f"train gate fp32 bs{GATE_BATCH} {TRAIN_SIZE} (batch seed {seed}): "
          f"kernel forward vs plain forward, loss_total "
          f"{k_loss['loss_total']:.6f} / {p_loss['loss_total']:.6f}, max "
          f"relative loss error {loss_err:.3e} (tol 1e-4), matched queries "
          f"equal: {same}; gradients over {len(p_grads)} parameters: all but "
          f"the sampling offsets {errs['dense'][0]:.3e} of max|g| (tol "
          f"{GATE_GRAD_TOL:.0e}; {errs['dense'][1]}), the sampling offsets "
          f"{errs['offsets'][0]:.3e} of their L2 norm (tol "
          f"{GATE_OFFSETS_L2_TOL:.0e}; {errs['offsets'][1]}; "
          f"{errs['offsets_max'][0]:.3e} of max|g|, not held); against the "
          f"kernel-valued plain step {replay[0]:.3e} of max|g| (tol "
          f"{GATE_REPLAY_TOL:.0e}; {replay[1]}; its losses {replay_err:.1e} "
          f"from the kernel step's); msda launches {kernel_counts[0]}, "
          f"backward passes {kernel_counts[1]}")
    if not (loss_err <= 1e-4 and same and errs["dense"][0] <= GATE_GRAD_TOL
            and errs["offsets"][0] <= GATE_OFFSETS_L2_TOL
            and replay_err <= 1e-6 and replay[0] <= GATE_REPLAY_TOL):
        raise AssertionError("train gate: the kernel forward's step disagrees "
                             "with the plain forward's")
    return dict(loss_err=loss_err, grad_err=errs["dense"][0],
                offsets_l2_err=errs["offsets"][0],
                offsets_max_err=errs["offsets_max"][0],
                replay_grad_err=replay[0])


def train_profile(trainer, batch, device, n_steps=2, regions=None):
    """Device-busy time and idle share of train steps (device-only trace),
    and their device time by op and by kernel. ``regions`` (a context
    manager factory that labels the step's regions, the labels, and a
    function that names the region of a backward op from its callers) adds
    the device time by region from a trace of its own."""
    from torch.profiler import ProfilerActivity
    from aloception_tpu_torch.train.trainer import to_device

    inputs = to_device(batch["inputs"], device)
    targets = to_device(batch["targets"], device)

    def step():
        trainer.train_step(inputs, targets)[1].cpu()

    step()
    n_act, busy, window = _device_busy(
        _trace(step, [ProfilerActivity.CUDA], n_steps))
    prof = _trace(step, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  n_steps)
    _, busy_host, _ = _device_busy(prof)
    print(f"profile {n_steps} train steps: {n_act / n_steps:.1f} device "
          f"activities and {busy / n_steps / 1e3:.3f} ms device-busy per "
          f"step; idle share of the device window {1 - busy / window:.4f} "
          "(device-only trace)")
    rows = prof.key_averages()

    def per_step(keys, self_only):
        us = sum(_device_us(r, self_only) for r in rows if keys(r.key))
        return us / n_steps / 1e3, us / busy_host

    print("device ms per train step by op (children included; nested ops "
          "overlap):")
    for r in sorted((r for r in rows if r.key.startswith("aten::")
                     or r.key.endswith("Backward0") or "Backward" in r.key),
                    key=_device_us, reverse=True)[:20]:
        us = _device_us(r)
        print(f"  {us / n_steps / 1e3:8.3f} ms {us / busy_host:6.1%} "
              f"{r.count // n_steps:5d} calls  {r.key}")
    print("device ms per train step by kernel (self):")
    for r in sorted((r for r in rows if _device_us(r, self_only=True) > 0
                     and not r.key.startswith("aten::")),
                    key=lambda r: _device_us(r, self_only=True),
                    reverse=True)[:15]:
        us = _device_us(r, self_only=True)
        print(f"  {us / n_steps / 1e3:8.3f} ms {us / busy_host:6.1%} "
              f"{r.count // n_steps:5d} calls  {r.key[:100]}")
    parts = {
        "msda forward kernel": (lambda k: "msda_forward_kernel" in k, True),
        "msda plain backward (the operator's backward node, children "
        "included)": (lambda k: k.startswith(MSDA_BACKWARD_NODE), False),
        "grid_sample backward": (
            lambda k: k == "aten::grid_sampler_2d_backward", False),
        "hungarian kernel": (lambda k: "hungarian_kernel" in k, True),
        "AdamW update (children included)": (
            lambda k: k.startswith("Optimizer.step#"), False),
    }
    shares = {}
    for label, (keys, self_only) in parts.items():
        ms, share = per_step(keys, self_only)
        shares[label] = (ms, share)
        print(f"  {label}: {ms:.3f} ms per step, {share:.2%} of device-busy")
    out = dict(busy_ms=busy / n_steps / 1e3, idle=1 - busy / window,
               parts=shares)
    if regions is not None:
        # the regions' labels cost host time: a trace of their own
        labels, names, backward = regions
        with labels():
            prof = _trace(step, [ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], n_steps)
        table = region_breakdown(prof, busy / n_steps, names, "train step",
                                 n_steps, backward=backward, per="step")
        out["region_ms"] = {r: sum(k.values()) for r, k in table.items()}
    return out


def train_phase(device):
    """The slice's main path: Deformable-DETR-R50-refine (91 classes, 300
    queries, 6+6 layers, float32, dropout 0.1) trains through
    ``make_deformable_detr_trainer(...).fit`` on the synthetic sample at
    batch 8, 640 x 640: one warm-up step and TRAIN_STEPS timed ones, with 12
    kernel launches and 12 operator backward passes a step, one Hungarian
    launch a criterion call and one synchronising operation a batch; then
    its profile, and a loss that falls over OVERFIT_STEPS on one repeated
    batch."""
    import tempfile
    from aloception_tpu_torch.models.deformable_detr import deformable_detr_r50
    from aloception_tpu_torch.train import (CocoDetection2Detr,
                                            make_deformable_detr_trainer)

    model = deformable_detr_r50(
        num_classes=91, with_box_refine=True, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    dm = CocoDetection2Detr(batch_size=TRAIN_BATCH, sample=True,
                            size=TRAIN_SIZE)
    batches = SampledLoader(dm.train_dataset, TRAIN_BATCH, 1 + TRAIN_STEPS,
                            seed=30)
    recorder = make_recorder()
    with tempfile.TemporaryDirectory() as log_dir:
        trainer = make_deformable_detr_trainer(
            model=model, data_module=dm, log_dir=log_dir,
            callbacks=[recorder], seed=0)
        torch.cuda.reset_peak_memory_stats()
        per_batch = recorded_fit(trainer, recorder, batches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        _check_losses(per_batch, "deformable training")
        launches = tuple(sum(c[i] for _, c, _, _ in per_batch)
                         for i in range(3))
        for i, (_, counts, syncs, _) in enumerate(per_batch):
            if counts != (MSDA_CALLS_PER_FORWARD, MSDA_CALLS_PER_FORWARD, 1):
                raise AssertionError(
                    f"train batch {i}: (msda launches, msda backward passes, "
                    f"hungarian launches) {counts}")
            if syncs != 1:
                raise AssertionError(f"train batch {i}: {syncs} synchronising "
                                     "operations, not 1")
        timed = [dt for dt, _, _, _ in per_batch[1:]]
        step_s = sum(timed) / len(timed)
        frames_ms = sum(batches.seconds[1:]) / len(timed) * 1e3
        print(f"deformable_detr_r50_refine training fp32 bs{TRAIN_BATCH} "
              f"{TRAIN_SIZE} (TF32: cudnn {torch.backends.cudnn.allow_tf32}, "
              f"matmul {torch.backends.cuda.matmul.allow_tf32}): "
              f"{len(per_batch)} steps through Trainer.fit; warm-up "
              f"{per_batch[0][0] * 1e3:.1f} ms; timed step ms "
              f"{[round(dt * 1e3, 2) for dt in timed]}, mean "
              f"{step_s * 1e3:.2f} ms = {1 / step_s:.3f} steps/s = "
              f"{TRAIN_BATCH / step_s:.2f} images/s, of which making and "
              f"transforming the frames on the host {frames_ms:.2f} ms; "
              f"peak memory "
              f"{peak_gib:.2f} GiB; per step: msda launches and backward "
              f"passes {MSDA_CALLS_PER_FORWARD}, hungarian launches 1 (totals "
              f"{launches}); synchronising operations "
              f"per batch {[s for _, _, s, _ in per_batch]}; loss_total "
              f"{[round(m['loss_total'], 4) for _, _, _, m in per_batch]}")
        fixed = one_batch(dm.train_dataset, TRAIN_BATCH, seed=31)
        prof = train_profile(trainer, dm.prepare_batch(fixed), device)

        # the loss on one repeated batch
        recorder.caught = []
        overfit = recorded_fit(trainer, recorder, [fixed] * OVERFIT_STEPS)
        _check_losses(overfit, "overfit")
        losses = [m["loss_total"] for _, _, _, m in overfit]
        print(f"one repeated batch, {OVERFIT_STEPS} steps: loss_total "
              f"{[round(v, 4) for v in losses]}")
        if not losses[-1] < losses[0]:
            raise AssertionError("the loss did not fall on a repeated batch")
    return dict(launches=launches, step_ms=step_s * 1e3, frames_ms=frames_ms,
                peak_gib=peak_gib, profile=prof)


def detr_train_phase(device):
    """DETR-R50 (91 classes, float32) trains DETR_TRAIN_BATCHES batches of
    16 at 384 x 384 through ``make_detr_trainer(...).fit``: 2 optimizer
    updates at accumulate 4, finite losses, a Hungarian launch and one
    synchronising operation a batch."""
    import tempfile
    from aloception_tpu_torch.models.detr import detr_r50
    from aloception_tpu_torch.train import (CocoDetection2Detr,
                                            make_detr_trainer)

    model = detr_r50(num_classes=DETR_CLASSES, device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    dm = CocoDetection2Detr(batch_size=DETR_TRAIN_BATCH, sample=True,
                            size=DETR_TRAIN_SIZE)
    batches = SampledLoader(dm.train_dataset, DETR_TRAIN_BATCH,
                            DETR_TRAIN_BATCHES, seed=40)
    recorder = make_recorder()
    with tempfile.TemporaryDirectory() as log_dir:
        trainer = make_detr_trainer(model=model, data_module=dm,
                                    log_dir=log_dir, callbacks=[recorder],
                                    seed=0)
        per_batch = recorded_fit(trainer, recorder, batches)
    _check_losses(per_batch, "detr training")
    for i, (_, counts, syncs, _) in enumerate(per_batch):
        if counts[2] != 1 or syncs != 1:
            raise AssertionError(f"detr train batch {i}: {counts[2]} "
                                 f"hungarian launches, {syncs} syncs")
    if trainer.optimizer.updates != DETR_TRAIN_BATCHES // 4:
        raise AssertionError(f"{trainer.optimizer.updates} optimizer updates")
    timed = [dt for dt, _, _, _ in per_batch[1:]]
    step_ms = sum(timed) / len(timed) * 1e3
    frames_ms = sum(batches.seconds[1:]) / len(timed) * 1e3
    print(f"detr_r50 training fp32 bs{DETR_TRAIN_BATCH} {DETR_TRAIN_SIZE}: "
          f"{len(per_batch)} batches, {trainer.optimizer.updates} optimizer "
          f"updates (accumulate 4); batch ms "
          f"{[round(dt * 1e3, 2) for dt, _, _, _ in per_batch]}, mean after "
          f"the first {step_ms:.2f} ms = {DETR_TRAIN_BATCH / step_ms * 1e3:.2f}"
          f" images/s, of which making and transforming the frames on the "
          f"host {frames_ms:.2f} ms"
          f"; hungarian launches {sum(c[2] for _, c, _, _ in per_batch)}"
          f"; synchronising operations per batch "
          f"{[s for _, _, s, _ in per_batch]}; loss_total "
          f"{[round(m['loss_total'], 4) for _, _, _, m in per_batch]}")
    return dict(step_ms=step_ms, frames_ms=frames_ms,
                launches=sum(c[2] for _, c, _, _ in per_batch))


def raft_parity_phase(device):
    """RAFT and RAFT-small in float32 (TF32 off), bs1 368x496, 12
    iterations: the card against the same model on the CPU, the serving
    path and the last flow of the all-iterations path, each gated at 1e-3 *
    max(1, max|flow|); then the bfloat16 RAFT on the card against the
    float32 one on the same weights (printed and checked finite, not
    gated)."""
    from aloception_tpu_torch.models.raft import raft, raft_small

    g = torch.Generator().manual_seed(60)
    f1, f2 = (torch.rand(1, 3, *RAFT_HW, generator=g) * 2 - 1
              for _ in range(2))
    d1, d2 = f1.to(device), f2.to(device)
    errs = {}
    for name, factory in (("raft", raft), ("raft_small", raft_small)):
        cpu_model = factory(device="cpu",
                            generator=torch.Generator().manual_seed(61))
        gpu_model = copy.deepcopy(cpu_model).to(device)
        for path in ("only_last", "list"):
            kw = dict(iters=RAFT_ITERS, only_last=path == "only_last")
            with torch.inference_mode():
                want, got = cpu_model(f1, f2, **kw), gpu_model(d1, d2, **kw)
            if path == "list":
                if len(got) != RAFT_ITERS:
                    raise AssertionError(f"{len(got)} flows for "
                                         f"{RAFT_ITERS} iterations")
                want, got = want[-1], got[-1]
            err = (got.cpu() - want).abs().max().item()
            tol = 1e-3 * max(1.0, want.abs().max().item())
            print(f"{name} fp32 bs1 {RAFT_HW} {RAFT_ITERS} iterations, {path}"
                  f": card vs cpu max|diff| {err:.3e} (tol {tol:.3e}, "
                  f"max|flow| {want.abs().max().item():.3f})")
            if not err <= tol:
                raise AssertionError(f"{name} {path} on the card disagrees "
                                     f"with the cpu: {err} > {tol}")
            errs[f"{name}/{path}"] = err
        if name == "raft":
            m16 = raft(torch.bfloat16, device=device)
            m16.load_state_dict(cpu_model.state_dict())
            with torch.inference_mode():
                a = m16(d1, d2, iters=RAFT_ITERS, only_last=True)
                b = gpu_model(d1, d2, iters=RAFT_ITERS, only_last=True)
            if not a.isfinite().all():
                raise AssertionError("non-finite bf16 RAFT flow")
            diff = (a - b).abs().max().item()
            errs["raft/bf16_vs_fp32"] = diff
            print(f"raft bf16 vs fp32 on the card, only_last: max|diff| "
                  f"{diff:.3e} = {diff / b.abs().max().item():.3e} of "
                  f"max|flow| (not gated)")
    return errs


def _labelled(fn, label):
    from torch.profiler import record_function

    def run(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return run


RAFT_REGIONS = ("fnet", "cnet", "volume", "pyramid", "lookup", "motion "
                "encoder", "gru", "flow head", "mask head", "upsample")


def raft_regions(model):
    """Patches that label each region of a RAFT forward (RAFT_REGIONS) with
    ``record_function``, for ``region_breakdown``."""
    import contextlib
    import importlib
    raft_mod = importlib.import_module("aloception_tpu_torch.models.raft.raft")
    from aloception_tpu_torch.ops.correlation import CorrPyramid
    ub = model.update_block
    stack = contextlib.ExitStack()
    for obj, attr, label in (
            (model.fnet, "forward", "fnet"), (model.cnet, "forward", "cnet"),
            (raft_mod, "corr_volume", "volume"),
            (raft_mod, "corr_pyramid", "pyramid"),
            (raft_mod, "CorrPyramid", "pyramid"),
            (CorrPyramid, "lookup", "lookup"),
            (ub.encoder, "forward", "motion encoder"),
            (ub.gru, "forward", "gru"), (ub.flow_head, "forward", "flow head"),
            (ub.mask, "forward", "mask head"),
            (raft_mod, "convex_upsample", "upsample")):
        stack.enter_context(mock.patch.object(
            obj, attr, _labelled(getattr(obj, attr), label)))
    return stack


def _op_kind(names):
    """The kind of the op whose device time it is, from its name and its
    callers' (innermost first)."""
    kinds = (("convolution", "conv"), ("instance_norm", "norm"),
             ("batch_norm", "norm"), ("group_norm", "norm"),
             ("bmm", "matmul"), ("aten::mm", "matmul"),
             ("avg_pool2d", "avg_pool"), ("gather", "gather"),
             ("aten::cat", "cat"), ("aten::to", "cast/copy"),
             ("aten::copy_", "cast/copy"))
    for name in names:
        for key, kind in kinds:
            if key in name:
                return kind
    return "element-wise"


def region_breakdown(prof, busy_us, regions, title, n_fwd=3, backward=None,
                     per="forward"):
    """Device ms per forward (or other call, ``per``) of each labelled
    region of ``regions`` (the rest is "other"), split by the kind of op
    that launched the kernels (convolution, norm, matmul, avg_pool, gather,
    cat, cast/copy, element-wise). The autograd engine runs a backward in a
    thread of its own, outside the forward's labels: ``backward`` names the
    region of an op from its callers' names (innermost first), or None.
    Returns {region: {kind: ms}}."""
    from torch.autograd import DeviceType
    table = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        us = _device_us(e, self_only=True)
        if not us:
            continue
        names, region, a = [], "other", e
        while a is not None:
            names.append(a.name)
            if region == "other" and a.name in regions:
                region = a.name
            a = a.cpu_parent
        if region == "other" and backward is not None:
            region = backward(names) or region
        kinds = table.setdefault(region, {})
        kind = _op_kind(names)
        kinds[kind] = kinds.get(kind, 0.0) + us / n_fwd / 1e3
    total = sum(sum(k.values()) for k in table.values())
    print(f"{title} device ms per {per} by region and kind of op (self "
          f"times; {total:.3f} ms traced against {busy_us / 1e3:.3f} ms "
          f"device-busy):")
    for region, kinds in sorted(table.items(),
                                key=lambda kv: -sum(kv[1].values())):
        ms = sum(kinds.values())
        parts = ", ".join(f"{k} {v:.3f}" for k, v in
                          sorted(kinds.items(), key=lambda kv: -kv[1]))
        print(f"  {region:15s} {ms:8.3f} ms {ms * 1e3 / busy_us:6.1%}  "
              f"({parts})")
    by_kind = {}
    for kinds in table.values():
        for k, v in kinds.items():
            by_kind[k] = by_kind.get(k, 0.0) + v
    print("  by kind: " + ", ".join(
        f"{k} {v:.3f} ms {v * 1e3 / busy_us:.1%}"
        for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    return table


def raft_serving_phase(device):
    """RAFT (random weights, bfloat16, built with no device named, so on
    the card) at bench_raft's configuration: bs2 368x496, 12 iterations,
    only_last. Pairs/s from CUDA events (mean of 10 forwards after 2
    warm-ups), peak memory, the profile and the synchronising operations of
    one forward (``profile_phase``), then device time by region and kind of
    op from a trace with the regions labelled."""
    from aloception_tpu_torch.models.raft import raft

    model = raft(torch.bfloat16,
                 generator=torch.Generator(device=device).manual_seed(0))
    if any(p.device != device for p in model.parameters()):
        raise AssertionError("raft() with no device did not build on the "
                             "card")
    g = torch.Generator(device=device).manual_seed(62)
    f1, f2 = (torch.randn(RAFT_BATCH, 3, *RAFT_HW, device=device, generator=g)
              for _ in range(2))

    def forward():
        return model(f1, f2, iters=RAFT_ITERS, only_last=True)

    with torch.inference_mode():
        flow = forward()
    if not (flow.shape == (RAFT_BATCH, 2) + RAFT_HW
            and flow.dtype == torch.float32 and flow.isfinite().all()):
        raise AssertionError(f"bad RAFT flow {flow.shape} {flow.dtype}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = cuda_ms(forward, iters=10, warmup=2)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"raft bs{RAFT_BATCH} {RAFT_HW} bf16 {RAFT_ITERS} iterations "
          f"only_last: forward {fwd_ms:.3f} ms, "
          f"{RAFT_BATCH / fwd_ms * 1e3:.2f} pairs/s, peak memory "
          f"{peak_gib:.3f} GiB")
    _, busy_us, idle, syncs, n_act = profile_phase(forward)
    # the host's time to enqueue a forward (no sync: the device idles most
    # of the window, so the call returns when its last launch is queued)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(10):
            forward()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    print(f"raft host: {host_ms:.3f} ms to enqueue a forward, {n_act:.0f} "
          f"device activities, {host_ms * 1e3 / n_act:.2f} us of host per "
          f"device activity ({fwd_ms * 1e3 / n_act:.2f} us of forward)")
    # the regions' labels cost host time: a trace of their own
    from torch.profiler import ProfilerActivity
    with raft_regions(model), torch.inference_mode():
        prof = _trace(forward, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                      3)
    regions = region_breakdown(prof, busy_us, RAFT_REGIONS, "raft")
    return model, dict(forward_ms=fwd_ms, pairs_per_s=RAFT_BATCH / fwd_ms * 1e3,
                       busy_ms=busy_us / 1e3, idle=idle, peak_gib=peak_gib,
                       syncs=syncs, host_ms=host_ms, activities=n_act,
                       regions=regions)


def raft_frame_request(model, images):
    """Pairs (images[0], images[1]), (images[2], images[3]) of uint8 CHW
    frames -> Frame -> norm_minmax_sym -> batch_list -> Padder -> RAFT
    (only_last) -> unpad -> inference: a Flow per pair."""
    from aloception_tpu_torch.aloscene import Frame, batch_list
    from aloception_tpu_torch.models.raft import Padder, inference

    frames = [Frame(x).norm_minmax_sym() for x in images]
    f1, f2 = (batch_list(frames[k::2]).as_layout(("B", "C", "H", "W"))
              for k in (0, 1))
    padder = Padder(f1.shape)
    return inference(padder.unpad(model(*padder.pad(f1, f2),
                                        iters=RAFT_ITERS, only_last=True)))


def raft_frame_phase(model, device):
    """3 requests of 2 pairs of Sintel-sized uint8 frames made on the card
    from a seed, down the Frame path; Flow names and shapes, host latency
    per request, the synchronising operations of one request."""
    from aloception_tpu_torch.aloscene import Flow

    g = torch.Generator(device=device).manual_seed(63)
    requests = [[torch.randint(0, 256, (3,) + SINTEL_HW, dtype=torch.uint8,
                               device=device, generator=g) for _ in range(4)]
                for _ in range(N_REQUESTS)]
    torch.cuda.synchronize()
    latencies, results = [], []
    for images in requests:
        t0 = time.perf_counter()
        with torch.inference_mode():
            results.append(raft_frame_request(model, images))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
    for flows in results:
        if len(flows) != 2:
            raise AssertionError(f"{len(flows)} flows for 2 pairs")
        for f in flows:
            if not (isinstance(f, Flow) and f.names == ("C", "H", "W")
                    and f.shape == (2,) + SINTEL_HW and f.array.isfinite().all()):
                raise AssertionError(f"malformed flow {f!r}")
    with torch.inference_mode():
        syncs = len(syncs_of(lambda: raft_frame_request(model, requests[0])))
    print(f"raft Frame path: {N_REQUESTS} requests of 2 pairs of uint8 "
          f"{SINTEL_HW} frames (padded to a multiple of 8) bf16, latency s "
          f"{[round(t, 4) for t in latencies]}; synchronising operations in "
          f"one request: {syncs}")
    return dict(latency_s=latencies, syncs=syncs)


def raft_eval_phase():
    """``eval_on_sintel --sample --limit_samples 2`` on the card (random
    weights: the EPE proves that the entry point runs, nothing more)."""
    import math
    from aloception_tpu_torch.commands import eval_on_sintel
    epe = eval_on_sintel.main(["--sample", "--limit_samples", "2"])
    if not math.isfinite(epe):
        raise AssertionError(f"eval_on_sintel EPE {epe}")
    return epe


def panoptic_model(name, dtype, device=None, seed=0):
    """``name``'s model with random weights from a seeded generator, built
    as a user builds it: ``DetrPanoptic()`` for DETR-R50, and
    ``DetrPanoptic(deformable_detr_r50(return_intermediate=True))``; on the
    card when ``device`` is None."""
    from aloception_tpu_torch.models.deformable_detr import deformable_detr_r50
    from aloception_tpu_torch.models.panoptic import DetrPanoptic
    g = torch.Generator(device=device or "cuda").manual_seed(seed)
    if name == "detr_r50_panoptic":
        return DetrPanoptic(num_classes=PANOPTIC_CLASSES, dtype=dtype,
                            device=device, generator=g)
    return DetrPanoptic(deformable_detr_r50(
        num_classes=PANOPTIC_CLASSES, return_intermediate=True, dtype=dtype,
        device=device, generator=g), generator=g)


def _cast(tree, dtype):
    """``tree`` (tensors in dicts and lists) with its floating tensors in
    ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _rel_err(got, want, keys):
    """max over ``keys`` of max|got - want| / max(1, max|want|)."""
    return max((got[k].float().cpu() - want[k].float().cpu()).abs().max()
               .item() / max(1.0, want[k].float().abs().max().item())
               for k in keys)


def panoptic_parity_phase(device):
    """detr_r50_panoptic in float32 at bs1 on a padded 384x512 batch: the
    card against the same model on the CPU; pred_masks, logits and boxes
    within 1e-3 * max(1, max|ref|)."""
    cpu_model = panoptic_model("detr_r50_panoptic", torch.float32, "cpu",
                               seed=70)
    gpu_model = copy.deepcopy(cpu_model).to(device)
    from aloception_tpu_torch.aloscene import Frame, batch_list
    image = torch.randint(0, 256, (3,) + PANOPTIC_GATE_FRAME,
                          dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(71))
    batch = batch_list([Frame(image).norm_resnet()], size=PANOPTIC_GATE_HW)
    layout = ("B", "H", "W", "C")
    with torch.inference_mode():
        want = cpu_model(batch.as_layout(layout), batch.mask.array[:, 0])
        gb = batch.to(device)
        got = gpu_model(gb.as_layout(layout), gb.mask.array[:, 0])
    err = _rel_err(got, want, ("pred_masks", "pred_logits", "pred_boxes"))
    masks = want["pred_masks"]
    print(f"detr_r50_panoptic fp32 bs1 {PANOPTIC_GATE_HW} card vs cpu on a "
          f"padded batch (padded share {batch.mask.array.mean().item():.4f}"
          f"): pred_masks {tuple(masks.shape)}, max|diff| / max(1, max|ref|) "
          f"over masks, logits and boxes {err:.3e} (tol 1e-3; max|masks| "
          f"{masks.abs().max().item():.3f})")
    if not (err <= 1e-3 and masks.isfinite().all()):
        raise AssertionError(f"detr_r50_panoptic on the card disagrees with "
                             f"the cpu: {err}")
    return err


def panoptic_gate_phase(device):
    """deformable_detr_r50_panoptic in float32 at bs2 640x640 on the card:
    the MSDA kernel path against the plain path, one model, with the offset
    and weight kernels of every MSDeformAttn drawn at random; pred_masks,
    logits and boxes within 1e-3 * max(1, max|ref|)."""
    from aloception_tpu_torch.models.deformable_detr import ms_deform_attn \
        as msda_module
    from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch
    model = panoptic_model("deformable_detr_r50_panoptic", torch.float32,
                           device, seed=72)
    g = torch.Generator(device=device).manual_seed(73)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, msda_module.MSDeformAttn):
                mod.sampling_offsets.weight.normal_(0.0, 0.1, generator=g)
                mod.attention_weights.weight.normal_(0.0, 0.1, generator=g)
    x = torch.randn(2, *SIZE, 3, device=device, generator=g)
    mask = torch.zeros(2, *SIZE, device=device)
    mask[1, :, 3 * SIZE[1] // 4:] = 1.0
    with torch.inference_mode():
        out_k = model(x, mask)
        with mock.patch.object(msda_module, "ms_deform_attn",
                               ms_deform_attn_torch):
            out_p = model(x, mask)
    err = _rel_err(out_k, out_p, ("pred_masks", "pred_logits", "pred_boxes"))
    print(f"deformable_detr_r50_panoptic fp32 bs2 {SIZE}: kernel path vs "
          f"plain path, max|diff| / max(1, max|ref|) over masks, logits and "
          f"boxes {err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        raise AssertionError(f"panoptic kernel path and plain path disagree: "
                             f"{err}")
    return err


def check_panoptic(results, n, hw, background=None):
    """``n`` (BoundingBoxes2D, Mask) pairs: detections as
    ``check_detections``, binary (N, H, W) masks at ``hw`` with the boxes'
    labels and scores. Returns the kept queries."""
    from aloception_tpu_torch.aloscene import Mask
    kept = check_detections([b for b, _ in results], n, background)
    for b, m in results:
        if not (isinstance(m, Mask) and m.names == ("N", "H", "W")
                and m.shape == (len(b),) + tuple(hw)):
            raise AssertionError(f"malformed masks {m!r} for {len(b)} boxes")
        if not ((m.array == 0) | (m.array == 1)).all():
            raise AssertionError("masks not binary")
        if not (torch.equal(m.labels.array, b.labels.array)
                and torch.equal(m.labels.scores, b.labels.scores)):
            raise AssertionError("masks and boxes carry different labels")
    return kept


def panoptic_bf16_check(name, model, x, mask, out):
    """The served bf16 ``out`` of ``model(x, mask)`` against a float32 copy
    of the model on the same inputs, and the bf16 head alone against the
    float32 head on the float32 detector's outputs (rounded to bf16 for the
    bf16 head), each within PANOPTIC_BF16_TOL. Returns both errors."""
    from aloception_tpu_torch.models.panoptic import PanopticHead
    ref = copy.deepcopy(model).float()
    keys = ("pred_masks", "pred_logits", "pred_boxes")
    with torch.inference_mode():
        err = _rel_err(out, ref(x.float(), mask), keys)
        det = ref.detr(x.float(), mask)
        head_err = _rel_err(
            PanopticHead.forward(model, _cast(
                det, model.detr.query_embed.weight.dtype)),
            PanopticHead.forward(ref, det), ("pred_masks",))
    del ref, det
    torch.cuda.empty_cache()
    print(f"{name} bf16 vs the same weights in fp32 on the card, max|diff| "
          f"/ max(1, max|ref|): forward (masks, logits, boxes) {err:.3e} "
          f"(tol {PANOPTIC_BF16_TOL['forward']:.0e}), head alone (masks) "
          f"{head_err:.3e} (tol {PANOPTIC_BF16_TOL['head']:.0e})")
    if not (err <= PANOPTIC_BF16_TOL["forward"]
            and head_err <= PANOPTIC_BF16_TOL["head"]):
        raise AssertionError(f"{name} in bf16 disagrees with fp32: {err}, "
                             f"head {head_err}")
    return err, head_err


def panoptic_serving_phase(name, device):
    """``name`` in bfloat16 at its batch, 640x640 (built with no device
    named, so on the card): the outputs against float32
    (``panoptic_bf16_check``), images/s from CUDA events (mean of 10
    forwards after 2 warm-ups), peak memory, the detector and the head
    timed alone alike, the profile and syncs of one forward
    (``profile_phase``), device ms of the detector, the attention maps and
    the mask head from a trace with the regions labelled, and the MSDA
    launches of one forward. Returns (model, measurements)."""
    from aloception_tpu_torch.models.panoptic import PanopticHead
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda
    from torch.profiler import ProfilerActivity
    model = panoptic_model(name, torch.bfloat16)
    if any(p.device != device for p in model.parameters()):
        raise AssertionError(f"{name} with no device did not build on the "
                             "card")
    batch = PANOPTIC_BATCH[name]
    g = torch.Generator(device=device).manual_seed(74)
    x = torch.randn(batch, *SIZE, 3, device=device,
                    generator=g).to(torch.bfloat16)
    mask = torch.zeros(batch, *SIZE, device=device)
    with torch.inference_mode():
        out = model(x, mask)
    nq = model.detr.num_queries
    masks = out["pred_masks"]
    if not (masks.shape == (batch, nq, SIZE[0] // 4, SIZE[1] // 4)
            and masks.isfinite().all()):
        raise AssertionError(f"bad {name} masks {tuple(masks.shape)}")
    bf16_err, head_bf16_err = panoptic_bf16_check(name, model, x, mask, out)
    del out, masks
    torch.cuda.synchronize()
    ms_deform_attn_cuda.launches = 0
    with torch.inference_mode():
        model(x, mask)
    torch.cuda.synchronize()
    launches = ms_deform_attn_cuda.launches
    want = MSDA_CALLS_PER_FORWARD if "deformable" in name else 0
    if launches != want:
        raise AssertionError(f"{name}: msda kernel launched {launches} times "
                             f"in one forward, not {want}")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x, mask), iters=10, warmup=2)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with torch.inference_mode():
        det_ms = cuda_ms(lambda: model.detr(x, mask), iters=10, warmup=2)
        det_out = model.detr(x, mask)
        head_ms = cuda_ms(lambda: PanopticHead.forward(model, det_out),
                          iters=10, warmup=2)
    del det_out
    print(f"{name} bs{batch} {SIZE[0]}px bf16 ({batch * nq} query maps): "
          f"forward {fwd_ms:.3f} ms, {batch / fwd_ms * 1e3:.2f} images/s, "
          f"peak memory {peak_gib:.3f} GiB, msda launches a forward "
          f"{launches}; alone: detector {det_ms:.3f} ms, head {head_ms:.3f} "
          f"ms")
    _, busy_us, idle, syncs, _ = profile_phase(lambda: model(x, mask))
    if syncs:
        raise AssertionError(f"{name}: {syncs} synchronising operations in "
                             "one forward")
    with contextlib.ExitStack() as stack, torch.inference_mode():
        for mod, label in ((model.detr, "detector"),
                           (model.bbox_attention, "bbox_attention"),
                           (model.mask_head, "mask_head")):
            stack.enter_context(mock.patch.object(
                mod, "forward", _labelled(mod.forward, label)))
        prof = _trace(lambda: model(x, mask),
                      [ProfilerActivity.CPU, ProfilerActivity.CUDA], 3)
    regions = region_breakdown(prof, busy_us, PANOPTIC_REGIONS, name)
    return model, dict(batch=batch, forward_ms=fwd_ms,
                       images_per_s=batch / fwd_ms * 1e3,
                       detector_alone_ms=det_ms, head_alone_ms=head_ms,
                       bf16_vs_fp32=bf16_err, head_bf16_vs_fp32=head_bf16_err,
                       busy_ms=busy_us / 1e3, idle=idle, peak_gib=peak_gib,
                       syncs=syncs, msda_launches=launches,
                       region_ms={r: sum(k.values())
                                  for r, k in regions.items()},
                       regions=regions)


def panoptic_frame_phase(name, model, device):
    """3 requests of 4 uint8 frames of mixed sizes (PANOPTIC_FRAMES), made on
    the card: Frame -> norm_resnet -> batch_list -> model ->
    inference_with_masks (masks at the batch's padded size); latency, the
    synchronising operations of one request (1: the copy of the keep mask)
    and the MSDA launches of the requests."""
    from aloception_tpu_torch.aloscene import Frame, batch_list
    from aloception_tpu_torch.models.panoptic import inference_with_masks
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda

    g = torch.Generator(device=device).manual_seed(75)
    requests = [[torch.randint(0, 256, (3,) + hw, dtype=torch.uint8,
                               device=device, generator=g)
                 for hw in PANOPTIC_FRAMES] for _ in range(N_REQUESTS)]

    def request(images):
        b = batch_list([Frame(x).norm_resnet() for x in images])
        out = model(b.as_layout(("B", "H", "W", "C")), b.mask.array[:, 0])
        return b, inference_with_masks(out, frame_size=b.HW,
                                       **PANOPTIC_INFERENCE[name])

    torch.cuda.synchronize()
    ms_deform_attn_cuda.launches = 0
    latencies, results = [], []
    for images in requests:
        t0 = time.perf_counter()
        with torch.inference_mode():
            results.append(request(images))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
    launches = ms_deform_attn_cuda.launches
    want = MSDA_CALLS_PER_FORWARD * N_REQUESTS if "deformable" in name else 0
    if launches != want:
        raise AssertionError(f"{name} Frame path: {launches} msda launches in "
                             f"{N_REQUESTS} requests, not {want}")
    kept = [check_panoptic(res, len(PANOPTIC_FRAMES), b.HW,
                           PANOPTIC_INFERENCE[name].get("background_class"))
            for b, res in results]
    with torch.inference_mode():
        syncs = len(syncs_of(lambda: request(requests[0])))
    if syncs != 1:
        raise AssertionError(f"{name} Frame path: {syncs} synchronising "
                             "operations in one request, not 1")
    print(f"{name} Frame path: {N_REQUESTS} requests of "
          f"{len(PANOPTIC_FRAMES)} uint8 frames {sorted(set(PANOPTIC_FRAMES))}"
          f" -> {results[0][0].HW} bf16 -> masks at that size, latency s "
          f"{[round(t, 4) for t in latencies]}, kept queries {kept}, msda "
          f"launches {launches}; synchronising operations in one request: "
          f"{syncs}")
    return dict(latency_s=latencies, syncs=syncs, kept=kept,
                msda_launches=launches)


def panoptic_eval_phase():
    """``eval_on_coco --sample --limit_batches 2`` on the card for
    ``--model panoptic_deformable`` and ``--model panoptic`` (random
    weights: AP and PQ prove that the entry point runs, nothing more), with
    the MSDA launches of the Deformable run."""
    import math
    from aloception_tpu_torch.commands import eval_on_coco
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda
    results = {}
    for model in ("panoptic_deformable", "panoptic"):
        ms_deform_attn_cuda.launches = 0
        maps = eval_on_coco.main(["--sample", "--model", model,
                                  "--limit_batches", "2"])
        torch.cuda.synchronize()
        ap = maps["all"]["all"]
        if not math.isfinite(ap):
            raise AssertionError(f"eval_on_coco --model {model}: AP {ap}")
        results[model] = dict(ap=ap,
                              msda_launches=ms_deform_attn_cuda.launches)
    if results["panoptic_deformable"]["msda_launches"] != \
            2 * MSDA_CALLS_PER_FORWARD:
        raise AssertionError(f"eval_on_coco panoptic_deformable: "
                             f"{results['panoptic_deformable']} msda launches")
    print(f"eval_on_coco on the card: {results}")
    return results



def panoptic_detector(name, device, seed, **kwargs):
    """The detector of ``name``, built with ``return_intermediate`` and
    random weights from a seeded generator on ``device``, in eval mode:
    DETR-R50 (100 queries) or Deformable-DETR-R50 without refinement (300
    queries), 250 classes."""
    from aloception_tpu_torch.models.deformable_detr import deformable_detr_r50
    from aloception_tpu_torch.models.detr import detr_r50
    factory = detr_r50 if name == "detr_r50_panoptic" else deformable_detr_r50
    return factory(num_classes=PANOPTIC_CLASSES, return_intermediate=True,
                   device=device,
                   generator=torch.Generator(device=device).manual_seed(seed),
                   **kwargs)


def panoptic_train_criterion(name):
    """train_on_coco's criterion: the DETR base, or for Deformable-DETR the
    focal base criterion and matcher."""
    import functools
    from aloception_tpu_torch.models.deformable_detr import (
        deformable_criterion, focal_hungarian_match)
    from aloception_tpu_torch.models.panoptic import panoptic_criterion
    if name == "detr_r50_panoptic":
        return panoptic_criterion
    return functools.partial(panoptic_criterion,
                             base_criterion=deformable_criterion,
                             matcher=focal_hungarian_match)


def panoptic_batch(batch_size, size, seed):
    """A panoptic train batch of the synthetic sample on the CPU: the DETR
    batch with its padded instance masks."""
    from aloception_tpu_torch.train import CocoDetection2Detr
    from aloception_tpu_torch.train.trainers import _make_panoptic_prepare
    dm = CocoDetection2Detr(batch_size=batch_size, sample=True, size=size,
                            return_masks=True)
    return _make_panoptic_prepare(dm)(one_batch(dm.train_dataset, batch_size,
                                                seed))


def held_train_steps(got, want, tag, per_tensor=True):
    """Two train steps' (metrics, gradients, matched queries or None) held:
    every loss within 1e-4 relative, the matched queries equal, and each
    gradient within 1e-3 of max|g|: with ``per_tensor``, its tensor's
    largest magnitude (or 1e-3 of the largest of all where a tensor's
    gradients are near 0: the biases of convolutions that a norm follows),
    else the largest of all. Returns (loss error, gradient error)."""
    (g_loss, g_grads, g_matched), (w_loss, w_grads, w_matched) = got, want
    loss_err = max(abs(g_loss[k] - w_loss[k]) / max(abs(w_loss[k]), 1e-12)
                   for k in w_loss if k.startswith("loss"))
    if g_grads.keys() != w_grads.keys() or not w_grads:
        raise AssertionError(f"{tag}: gradients of other parameters")
    top = max(g.abs().max().item() for g in w_grads.values())
    grad_err, worst = 0.0, None
    for n, ref in w_grads.items():
        scale = max(ref.abs().max().item(), 1e-3 * top) if per_tensor \
            else top
        err = (g_grads[n].cpu() - ref.cpu()).abs().max().item() / scale
        if err > grad_err:
            grad_err, worst = err, n
    same = w_matched is None or torch.equal(g_matched.cpu(), w_matched.cpu())
    print(f"{tag}: loss_total {g_loss['loss_total']:.6f} / "
          f"{w_loss['loss_total']:.6f}, max relative loss error "
          f"{loss_err:.3e} (tol 1e-4), max gradient error {grad_err:.3e} of "
          f"max|g| {'of its tensor' if per_tensor else 'over the model'} "
          f"(tol 1e-3; {worst}) over {len(w_grads)} parameters"
          + ("" if w_matched is None else f", matched queries equal: {same}"))
    if not (loss_err <= 1e-4 and grad_err <= 1e-3 and same):
        raise AssertionError(f"{tag}: the steps disagree")
    return loss_err, grad_err


def panoptic_train_gate_phase(device):
    """One float32 panoptic train step (frozen detector, TF32 off), twice:
    deformable_detr_r50_panoptic at bs2 640x640 on the card, the MSDA
    kernel path against the plain path (the detector's dropout on, both
    steps seeded alike; the offset and weight kernels of every MSDeformAttn
    drawn at random), and detr_r50_panoptic at bs2 384x512, the card
    against the CPU (the detector's dropout 0, so that the two devices'
    draws cannot differ). Losses, every head gradient and the final layer's
    matched queries (``held_train_steps``); the kernel step launches the
    MSDA kernel 12 times with no backward pass, and the Hungarian kernel
    twice (the base criterion's and the mask losses' matching)."""
    from aloception_tpu_torch.models.deformable_detr import ms_deform_attn \
        as msda_module
    from aloception_tpu_torch.models.deformable_detr import (
        focal_hungarian_match)
    from aloception_tpu_torch.models.detr import hungarian_match
    from aloception_tpu_torch.models.panoptic import DetrPanoptic
    from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch
    from aloception_tpu_torch.train.step import to_float32
    from aloception_tpu_torch.train.trainer import to_device

    def step(model, batch, crit, matcher, dev):
        torch.manual_seed(0)
        model.zero_grad(set_to_none=True)
        inputs = to_device(batch["inputs"], dev)
        targets = to_device(batch["targets"], dev)
        out = to_float32(model(*inputs))
        loss, metrics = crit(out, targets)
        loss.backward()
        counts = _counts()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        matched, _ = matcher(out, targets)
        return ({k: v.item() for k, v in metrics.items()}, grads,
                matched), counts

    gate = {}
    name = "deformable_detr_r50_panoptic"
    model = DetrPanoptic(panoptic_detector(name, device, seed=80)).train()
    g = torch.Generator(device=device).manual_seed(81)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, msda_module.MSDeformAttn):
                mod.sampling_offsets.weight.normal_(0.0, 0.1, generator=g)
                mod.attention_weights.weight.normal_(0.0, 0.1, generator=g)
    batch = panoptic_batch(GATE_BATCH, SIZE, seed=82)
    crit = panoptic_train_criterion(name)
    _reset_counts()
    got, counts = step(model, batch, crit, focal_hungarian_match, device)
    _reset_counts()
    with mock.patch.object(msda_module, "ms_deform_attn",
                           ms_deform_attn_torch):
        want, plain_counts = step(model, batch, crit, focal_hungarian_match,
                                  device)
    print(f"{name} train step: (msda launches, backward passes, hungarian "
          f"launches) {counts} on the kernel path, {plain_counts} on the "
          "plain path")
    if counts != (MSDA_CALLS_PER_FORWARD, 0, 2) or plain_counts[:2] != (0, 0):
        raise AssertionError(f"panoptic train gate: counts {counts}, "
                             f"{plain_counts}")
    gate[name] = held_train_steps(
        got, want, f"{name} train gate fp32 bs{GATE_BATCH} {SIZE}: kernel "
        "path vs plain path")
    del model, got, want
    torch.cuda.empty_cache()

    name = "detr_r50_panoptic"
    cpu_model = DetrPanoptic(panoptic_detector(name, "cpu", seed=83,
                                               dropout=0.0)).train()
    gpu_model = copy.deepcopy(cpu_model).to(device)
    batch = panoptic_batch(GATE_BATCH, PANOPTIC_GATE_HW, seed=84)
    crit = panoptic_train_criterion(name)
    got, _ = step(gpu_model, batch, crit, hungarian_match, device)
    want, _ = step(cpu_model, batch, crit, hungarian_match,
                   torch.device("cpu"))
    gate[name] = held_train_steps(
        got, want, f"{name} train gate fp32 bs{GATE_BATCH} "
        f"{PANOPTIC_GATE_HW}: card vs cpu")
    return gate


def labelled_step(trainer, criterion, forward_kwargs=None):
    """A patch of ``trainer.train_step`` by the same step with its
    criterion labelled "criterion"."""
    from aloception_tpu_torch.train import make_train_step
    return mock.patch.object(trainer, "train_step", make_train_step(
        trainer.model, trainer.optimizer, _labelled(criterion, "criterion"),
        forward_kwargs))


def _backward_region(names):
    return "backward" if any(n.startswith("autograd::engine")
                             for n in names) else None


def prepare_times(prepare, frames, device):
    """(host ms to prepare a batch of ``frames``, ms to copy it to the card
    and synchronise, its bytes), and the prepared batch."""
    from aloception_tpu_torch.train.trainer import to_device
    t0 = time.perf_counter()
    batch = prepare(frames)
    t1 = time.perf_counter()
    to_device({"inputs": batch["inputs"], "targets": batch["targets"]},
              device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    nbytes = sum(x.numel() * x.element_size()
                 for x in [*batch["inputs"], *batch["targets"].values()])
    return ((t1 - t0) * 1e3, (t2 - t1) * 1e3, nbytes), batch


def panoptic_train_regions(trainer, criterion):
    """(labels, names, backward) for ``train_profile``: the detector, the
    attention maps, the mask head's forward, the criterion and the
    optimizer's clip and update labelled; the backward's ops are
    "backward"."""
    model = trainer.model

    def labels():
        stack = contextlib.ExitStack()
        for obj, attr, label in (
                (model.detr, "forward", "detector"),
                (model.bbox_attention, "forward", "attention maps"),
                (model.mask_head, "forward", "mask head forward"),
                (trainer.optimizer, "step", "optimizer")):
            stack.enter_context(mock.patch.object(
                obj, attr, _labelled(getattr(obj, attr), label)))
        stack.enter_context(labelled_step(trainer, criterion))
        return stack

    return labels, ("detector", "attention maps", "mask head forward",
                    "criterion", "optimizer"), _backward_region


def panoptic_train_phase(name, device):
    """``name`` (float32, 250 classes, random weights) trains its panoptic
    head on the frozen detector through ``make_panoptic_trainer(...).fit``
    at its serving batch, 640x640: a warm-up step and TRAIN_STEPS timed
    ones (frames made inside the step), with per step 12 MSDA launches for
    Deformable-DETR (0 for DETR), no MSDA backward pass, 2 Hungarian
    launches and one synchronising operation; the profile with device ms by
    region; every detector parameter unchanged (max|diff| 0); the mask
    losses (DICE + focal) falling over OVERFIT_STEPS on one repeated
    batch."""
    import tempfile
    from aloception_tpu_torch.train import (CocoDetection2Detr,
                                            make_panoptic_trainer)

    batch_size = PANOPTIC_BATCH[name]
    deformable = name != "detr_r50_panoptic"
    dm = CocoDetection2Detr(batch_size=batch_size, sample=True,
                            size=TRAIN_SIZE, return_masks=True)
    batches = SampledLoader(dm.train_dataset, batch_size, 1 + TRAIN_STEPS,
                            seed=91)
    recorder = make_recorder()
    with tempfile.TemporaryDirectory() as log_dir:
        trainer = make_panoptic_trainer(
            detector=panoptic_detector(name, device, seed=90),
            data_module=dm, criterion=panoptic_train_criterion(name),
            log_dir=log_dir, callbacks=[recorder], seed=0)
        model = trainer.model
        det0 = {k: v.clone() for k, v in model.detr.state_dict().items()}
        torch.cuda.reset_peak_memory_stats()
        per_batch = recorded_fit(trainer, recorder, batches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        _check_losses(per_batch, f"{name} training")
        want = (MSDA_CALLS_PER_FORWARD if deformable else 0, 0, 2)
        for i, (_, counts, syncs, _) in enumerate(per_batch):
            if counts != want or syncs != 1:
                raise AssertionError(
                    f"{name} train batch {i}: (msda launches, msda backward "
                    f"passes, hungarian launches) {counts}, not {want}; "
                    f"{syncs} synchronising operations")
        timed = [dt for dt, _, _, _ in per_batch[1:]]
        step_s = sum(timed) / len(timed)
        frames_ms = sum(batches.seconds[1:]) / len(timed) * 1e3
        print(f"{name} training fp32 bs{batch_size} {TRAIN_SIZE} "
              f"({batch_size * model.detr.num_queries} query maps, frozen "
              f"detector): {len(per_batch)} steps through Trainer.fit; "
              f"warm-up {per_batch[0][0] * 1e3:.1f} ms; timed step ms "
              f"{[round(dt * 1e3, 2) for dt in timed]}, mean "
              f"{step_s * 1e3:.2f} ms = {batch_size / step_s:.2f} images/s, "
              f"of which making and transforming the frames on the host "
              f"{frames_ms:.2f} ms; peak memory {peak_gib:.2f} GiB; per step "
              f"(msda launches, msda backward passes, hungarian launches) "
              f"{want}; synchronising operations per batch "
              f"{[s for _, _, s, _ in per_batch]}; loss_total "
              f"{[round(m['loss_total'], 4) for _, _, _, m in per_batch]}")
        fixed = one_batch(dm.train_dataset, batch_size, seed=92)
        prep, prepared = prepare_times(trainer.prepare_batch, fixed, device)
        print(f"{name}: preparing a batch of {batch_size} frames on the host "
              f"{prep[0]:.2f} ms, copying it to the card {prep[1]:.2f} ms "
              f"({prep[2] / 2**20:.1f} MiB, the padded instance masks "
              f"{prepared['targets']['masks'].numel() * 4 / 2**20:.1f})")
        prof = train_profile(trainer, prepared, device,
                             regions=panoptic_train_regions(
                                 trainer, panoptic_train_criterion(name)))

        recorder.caught = []
        overfit = recorded_fit(trainer, recorder, [fixed] * OVERFIT_STEPS)
        _check_losses(overfit, f"{name} overfit")
        mask_losses = [m["loss_DICE"] + m["loss_focal"]
                       for _, _, _, m in overfit]
        det_delta = max((v.float() - det0[k].float()).abs().max().item()
                        for k, v in model.detr.state_dict().items()
                        if v.is_floating_point())
        print(f"{name}: one repeated batch, {OVERFIT_STEPS} steps: mask "
              f"loss (DICE + focal) {[round(v, 4) for v in mask_losses]}; "
              f"max|diff| of every detector parameter and buffer after "
              f"{len(per_batch) + 2 + OVERFIT_STEPS} steps: {det_delta}")
        if not mask_losses[-1] < mask_losses[0]:
            raise AssertionError(f"{name}: the mask loss did not fall on a "
                                 "repeated batch")
        if det_delta != 0.0:
            raise AssertionError(f"{name}: the frozen detector moved by "
                                 f"{det_delta}")
    msda = tuple(sum(c[i] for _, c, _, _ in per_batch) for i in range(3))
    return dict(batch=batch_size, step_ms=step_s * 1e3, frames_ms=frames_ms,
                prepare_ms=prep[0], copy_ms=prep[1], batch_bytes=prep[2],
                peak_gib=peak_gib, launches=msda[0], backward_passes=msda[1],
                hungarian_launches=msda[2], syncs_per_batch=1,
                mask_loss=mask_losses, detector_max_abs_delta=det_delta,
                profile=prof)


def shifted_pairs(n, hw, seed):
    """``n`` textured pairs at ``hw``, each a crop of a noise image and the
    crop moved by a drawn (dx, dy) in [-6, 6] (content moves by +(dx, dy),
    the flow's label), as T=2 Frames with a ``flow_forward`` Flow and an
    all-zero occlusion Mask, made from numpy seeds when indexed."""
    import numpy as np
    from aloception_tpu_torch.aloscene import Flow, Frame, Mask
    from aloception_tpu_torch.aloscene.spatial import _cat_batched
    H, W = hw

    class Pairs:
        def __len__(self):
            return n

        def __getitem__(self, idx):
            rng = np.random.RandomState(seed + idx)
            img = rng.uniform(0, 255, (3, H + 16, W + 16)).astype(np.float32)
            dx, dy = rng.randint(-6, 7), rng.randint(-6, 7)
            f0 = Frame(torch.from_numpy(img[:, 8:8 + H, 8:8 + W].copy()),
                       normalization="255")
            f1 = Frame(torch.from_numpy(
                img[:, 8 - dy:8 - dy + H, 8 - dx:8 - dx + W].copy()),
                normalization="255")
            flow = torch.empty(2, H, W)
            flow[0], flow[1] = float(dx), float(dy)
            f0.append_flow(Flow(flow, occlusion=Mask(torch.zeros(1, H, W))),
                           "flow_forward")
            return _cat_batched([f0.temporal(), f1.temporal()],
                                axis_name="T")

    return Pairs()


def raft_train_gate_phase(device):
    """One float32 RAFT train step (TF32 off) at bs2 184x248, 12
    iterations, the all-iterations path with BatchNorm in train mode: the
    card against the same model on the CPU. The sequence loss and metrics,
    every gradient (``held_train_steps``), and the cnet's running means and
    variances after the step within 1e-5."""
    from aloception_tpu_torch.models.raft import raft, raft_sequence_loss
    from aloception_tpu_torch.train import Data2RAFT

    batch = Data2RAFT(sample=True).prepare_batch(
        [shifted_pairs(RAFT_GATE_BATCH, RAFT_GATE_HW, 100)[i]
         for i in range(RAFT_GATE_BATCH)])
    cpu_model = raft(device="cpu",
                     generator=torch.Generator().manual_seed(101)).train()
    gpu_model = copy.deepcopy(cpu_model).to(device)
    stats0 = {n: b.clone() for n, b in cpu_model.named_buffers()
              if n.endswith(("running_mean", "running_var"))}

    def step(model, dev):
        flows = model(*(x.to(dev) for x in batch["inputs"]), iters=RAFT_ITERS)
        loss, metrics = raft_sequence_loss(
            flows, batch["targets"]["flow"].to(dev),
            batch["targets"]["valid"].to(dev))
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        stats = {n: b.detach().cpu() for n, b in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}
        return ({k: v.item() for k, v in metrics.items()}, grads, None), stats

    got, got_stats = step(gpu_model, device)
    want, want_stats = step(cpu_model, torch.device("cpu"))
    # gradients against the model's largest: at init the encoders' are
    # 1e-3 of it, and through 12 recurrent steps float32 holds them to a few
    # percent only (float32 against float64 on one CPU differs as much)
    errs = held_train_steps(
        got, want, f"raft train gate fp32 bs{RAFT_GATE_BATCH} {RAFT_GATE_HW} "
        f"{RAFT_ITERS} iterations: card vs cpu", per_tensor=False)
    stats_err = max((got_stats[n] - w).abs().max().item()
                    for n, w in want_stats.items())
    moved = max((w - stats0[n]).abs().max().item()
                for n, w in want_stats.items())
    print(f"raft train gate: cnet running statistics card vs cpu max|diff| "
          f"{stats_err:.3e} (tol 1e-5) over {len(want_stats)} buffers, moved "
          f"by up to {moved:.3e} in the step")
    if not (stats_err <= 1e-5 and moved > 0):
        raise AssertionError(f"raft running statistics: {stats_err}, "
                             f"moved {moved}")
    return dict(loss_err=errs[0], grad_err=errs[1], stats_err=stats_err)


RAFT_TRAIN_REGIONS = RAFT_REGIONS + ("criterion", "optimizer")


def raft_train_regions(trainer):
    """(labels, names, backward) for ``train_profile``: the forward's
    regions as ``raft_regions``, the sequence loss, the optimizer's clip
    and update, and the backward split into the lookup's gather backward
    and the rest."""
    from aloception_tpu_torch.train.trainers import _raft_criterion

    def labels():
        stack = raft_regions(trainer.model)
        stack.enter_context(mock.patch.object(
            trainer.optimizer, "step",
            _labelled(trainer.optimizer.step, "optimizer")))
        stack.enter_context(labelled_step(trainer, _raft_criterion,
                                          {"iters": RAFT_ITERS}))
        return stack

    def backward(names):
        if any("GatherBackward" in n for n in names):
            return "lookup backward (gather)"
        return _backward_region(names)

    return labels, RAFT_TRAIN_REGIONS, backward


def raft_train_phase(device):
    """RAFT (float32, random weights) trains through
    ``make_raft_trainer(num_steps=...).fit`` at the reference's FlyingChairs
    stage: bs10 at 368x496, 12 iterations, AdamW 4e-4 with the OneCycle
    schedule, on textured pairs with a known shift made inside the step: a
    warm-up step and RAFT_TRAIN_STEPS timed ones, one synchronising
    operation a batch; the profile with device ms by region (the lookup's
    gather backward on its own); the EPE falling over RAFT_OVERFIT_STEPS on
    one repeated batch."""
    import tempfile
    from aloception_tpu_torch.models.raft import raft
    from aloception_tpu_torch.train import Data2RAFT, make_raft_trainer

    pairs = shifted_pairs(4 * RAFT_TRAIN_BATCH, RAFT_TRAIN_HW, 110)
    dm = Data2RAFT(batch_size=RAFT_TRAIN_BATCH, sample=True)
    batches = SampledLoader(pairs, RAFT_TRAIN_BATCH, 1 + RAFT_TRAIN_STEPS,
                            seed=111)
    recorder = make_recorder()
    model = raft(device=device,
                 generator=torch.Generator(device=device).manual_seed(112))
    with tempfile.TemporaryDirectory() as log_dir:
        trainer = make_raft_trainer(
            model=model, data_module=dm, iters=RAFT_ITERS,
            num_steps=1 + RAFT_TRAIN_STEPS + 2 + RAFT_OVERFIT_STEPS,
            log_dir=log_dir, callbacks=[recorder], seed=0)
        torch.cuda.reset_peak_memory_stats()
        per_batch = recorded_fit(trainer, recorder, batches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        _check_losses(per_batch, "raft training")
        for i, (_, counts, syncs, _) in enumerate(per_batch):
            if syncs != 1 or counts != (0, 0, 0):
                raise AssertionError(f"raft train batch {i}: {syncs} "
                                     f"synchronising operations, kernel "
                                     f"counts {counts}")
        timed = [dt for dt, _, _, _ in per_batch[1:]]
        step_s = sum(timed) / len(timed)
        frames_ms = sum(batches.seconds[1:]) / len(timed) * 1e3
        print(f"raft training fp32 bs{RAFT_TRAIN_BATCH} {RAFT_TRAIN_HW} "
              f"{RAFT_ITERS} iterations (TF32: cudnn "
              f"{torch.backends.cudnn.allow_tf32}): {len(per_batch)} steps "
              f"through Trainer.fit; warm-up {per_batch[0][0] * 1e3:.1f} ms; "
              f"timed step ms {[round(dt * 1e3, 2) for dt in timed]}, mean "
              f"{step_s * 1e3:.2f} ms = {RAFT_TRAIN_BATCH / step_s:.2f} "
              f"pairs/s, of which making the pairs on the host "
              f"{frames_ms:.2f} ms; peak memory {peak_gib:.2f} GiB; "
              f"synchronising operations per batch "
              f"{[s for _, _, s, _ in per_batch]}; loss_total "
              f"{[round(m['loss_total'], 4) for _, _, _, m in per_batch]}; "
              f"epe {[round(m['epe'], 4) for _, _, _, m in per_batch]}")
        fixed = one_batch(pairs, RAFT_TRAIN_BATCH, seed=113)
        prep, prepared = prepare_times(dm.prepare_batch, fixed, device)
        print(f"raft: preparing a batch of {RAFT_TRAIN_BATCH} pairs on the "
              f"host {prep[0]:.2f} ms, copying it to the card {prep[1]:.2f} "
              f"ms ({prep[2] / 2**20:.1f} MiB)")
        prof = train_profile(trainer, prepared, device,
                             regions=raft_train_regions(trainer))
        recorder.caught = []
        overfit = recorded_fit(trainer, recorder,
                               [fixed] * RAFT_OVERFIT_STEPS)
        _check_losses(overfit, "raft overfit")
        epes = [m["epe"] for _, _, _, m in overfit]
        print(f"raft: one repeated batch, {RAFT_OVERFIT_STEPS} steps: epe "
              f"{[round(v, 4) for v in epes]}")
        if not epes[-1] < epes[0]:
            raise AssertionError("the EPE did not fall on a repeated batch")
    return dict(batch=RAFT_TRAIN_BATCH, step_ms=step_s * 1e3,
                pairs_per_s=RAFT_TRAIN_BATCH / step_s, frames_ms=frames_ms,
                prepare_ms=prep[0], copy_ms=prep[1], batch_bytes=prep[2],
                peak_gib=peak_gib, syncs_per_batch=1, epe=epes,
                profile=prof)


def train_commands_phase():
    """The training commands on the card: ``train_on_coco --sample --model
    panoptic_deformable --fast_dev_run`` (2 train batches and 1 val batch:
    36 MSDA launches, no backward pass; the PQ callback prints), then
    ``train_on_chairs --sample --max_steps 4`` and ``eval_on_sintel
    --sample --ckpt_dir`` on its checkpoint."""
    import io
    import math
    import tempfile
    from aloception_tpu_torch.commands import (eval_on_sintel,
                                               train_on_chairs, train_on_coco)
    with tempfile.TemporaryDirectory() as log_dir:
        _reset_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            trainer = train_on_coco.main(
                ["--sample", "--model", "panoptic_deformable",
                 "--fast_dev_run", "--log_dir", log_dir])
        torch.cuda.synchronize()
        msda, backward, hung = _counts()
        text = out.getvalue()
        print(text[-600:])
        if not ("PQ[all]" in text and trainer.global_step == 2
                and msda == 3 * MSDA_CALLS_PER_FORWARD and backward == 0):
            raise AssertionError(f"train_on_coco panoptic_deformable: msda "
                                 f"{msda}, backward {backward}")
        pq = trainer.last_val_metrics
        chairs = train_on_chairs.main(["--sample", "--max_steps", "4",
                                       "--log_dir", log_dir])
        epe = eval_on_sintel.main(["--sample", "--ckpt_dir",
                                   chairs.ckpt_dir, "--limit_samples", "2"])
        if not (chairs.global_step == 4 and math.isfinite(epe)):
            raise AssertionError(f"train_on_chairs {chairs.global_step} "
                                 f"steps, eval EPE {epe}")
    print(f"train_on_coco panoptic_deformable on the card: msda launches "
          f"{msda}, backward passes {backward}, hungarian launches {hung}; "
          f"train_on_chairs 4 steps, eval_on_sintel from its checkpoint: "
          f"EPE {epe:.4f}")
    return dict(msda_launches=msda, backward_passes=backward,
                hungarian_launches=hung, val=pq, chairs_epe=epe)


# ----------------------------------------------------------------------
# bfloat16 training: the models compute in bf16 over float32 masters
# ----------------------------------------------------------------------
# the bf16 train gate (kernel forward vs plain forward, the same recompute
# backward) at bs2 640, TF32 off, dropout 0. bf16 rounding differences of
# the two forwards grow through 6+6 layers, so the steps' losses, matching
# and gradients stand far apart where the fp32 gate's agree: over 6 batches
# (scripts/bf16_gate_probe.py on an H100, 7 readings with this phase's)
# losses up to 4.4e-2 relative, the kernel step's assignments up to 0.107
# above the plain step's optimum on its costs, every gradient together up
# to 0.122 of its L2 norm (single tensors up to 1.45 of max|g|, not held),
# the kernel-valued replay up to 2.2e-2 of max|g|; a plain forward half a
# cell off reads 8.2e-2, 0.51, 0.26 and 7.3. The forward kernel itself is
# held at the step's call by bf16_msda_times (2e-2 of max|ref|).
BF16_GATE_TOL = dict(loss=0.1, matched=0.3, grad_l2=0.25, replay=0.1)
# RAFT's two slow motion-encoder convolutions (scripts/train_times.py): name
# -> (in, out, kernel), at the FlyingChairs stage's 1/8 size
RAFT_SLOW_CONVS = {"encoder.convc2": (256, 192, (3, 3)),
                   "encoder.conv": (256, 126, (3, 3))}


class _PlainMSDA(torch.autograd.Function):
    """The plain forward (``ms_deform_attn_torch``) with the operator's own
    backward (its registered recompute), for the bf16 train gate: the two
    steps then differ by the forward alone, as the fp32 gate's do."""

    @staticmethod
    def forward(ctx, value, shapes, loc, w):
        from aloception_tpu_torch.ops.ms_deform_attn import (
            ms_deform_attn_torch)
        ctx.shapes = tuple(tuple(hw) for hw in shapes)
        ctx.save_for_backward(value, loc, w)
        return ms_deform_attn_torch(value, shapes, loc, w)

    @staticmethod
    def backward(ctx, grad_out):
        from aloception_tpu_torch.ops.ms_deform_attn import _backward
        g_value, _, g_loc, g_w = _backward(ctx, grad_out)
        return g_value, None, g_loc, g_w


def bf16_gate_phase(device, seed=20, tol=None):
    """One Deformable-DETR-R50-refine train step in bfloat16 (the model cast
    by ``cast_for_training``, TF32 off, dropout 0, batch 2 at 640 x 640):
    the MSDA kernel forward against the plain forward, both with the
    operator's recompute backward; and the kernel step against a plain step
    carrying the kernel's MSDA values (the backward's wiring; its bf16
    scatter-adds are atomics, so not bit-equal). Losses relative, matched
    queries equal, gradients as ``gate_grad_errors`` reads them, each
    within ``tol`` (BF16_GATE_TOL); ``tol=False`` reads them only."""
    from aloception_tpu_torch.models.deformable_detr import ms_deform_attn \
        as msda_module
    from aloception_tpu_torch.models.transformers import cast_for_training

    tol = BF16_GATE_TOL if tol is None else tol
    model, images, mask, targets = gate_setup(device, seed)
    cast_for_training(model, torch.bfloat16)
    kernel_msda, outputs, forced = msda_module.ms_deform_attn, [], []

    def recorded(*args):
        out = kernel_msda(*args)
        outputs.append(out.detach())
        return out

    def kernel_valued(value, shapes, loc, w):
        out = _PlainMSDA.apply(value, shapes, loc, w)
        kernel_out = outputs[len(forced)]
        forced.append(kernel_out)
        return out + (kernel_out - out).detach()

    def widened(step):
        loss, grads, matched = step
        return loss, {n: g.float() for n, g in grads.items()}, matched

    _reset_counts()
    k_loss, k_grads, k_matched = widened(gate_step(model, images, mask,
                                                   targets, recorded))
    counts = _counts()
    p_loss, p_grads, p_matched = widened(gate_step(model, images, mask,
                                                   targets, _PlainMSDA.apply))
    f_loss, f_grads, _ = widened(gate_step(model, images, mask, targets,
                                           kernel_valued))
    gap = matched_cost_gap(model, images, mask, targets, k_matched, p_matched)
    if counts[:2] != (MSDA_CALLS_PER_FORWARD,) * 2:
        raise AssertionError(f"bf16 train gate: msda (launches, backward "
                             f"passes) {counts[:2]} on the kernel step")
    loss_err = max(abs(k_loss[k] - p_loss[k]) / max(abs(p_loss[k]), 1e-12)
                   for k in p_loss)
    errs = gate_grad_errors(k_grads, p_grads)
    replay = gate_grad_errors(k_grads, f_grads)["all"]
    same = torch.equal(k_matched, p_matched)
    names = sorted(p_grads)
    k_all, p_all = (torch.cat([g[n].flatten() for n in names])
                    for g in (k_grads, p_grads))
    grad_l2 = ((k_all - p_all).norm() / p_all.norm()).item()
    out = dict(seed=seed, loss_err=loss_err, matched_equal=same,
               matched_cost_gap=gap, grad_l2_err=grad_l2,
               grad_err=errs["dense"][0], offsets_l2_err=errs["offsets"][0],
               offsets_max_err=errs["offsets_max"][0],
               replay_grad_err=replay[0])
    print(f"bf16 train gate bs{GATE_BATCH} {TRAIN_SIZE} (batch seed {seed}):"
          f" kernel forward vs plain forward, loss_total "
          f"{k_loss['loss_total']:.6f} / {p_loss['loss_total']:.6f}, max "
          f"relative loss error {loss_err:.3e}, matched queries equal: "
          f"{same} (the kernel step's assignments {gap:.3e} above the plain "
          f"step's optimum on its costs); every gradient together "
          f"{grad_l2:.3e} of their L2 norm; each tensor: all but the "
          f"sampling offsets "
          f"{errs['dense'][0]:.3e} of max|g| ({errs['dense'][1]}), the "
          f"sampling offsets {errs['offsets'][0]:.3e} of their L2 norm "
          f"({errs['offsets_max'][0]:.3e} of max|g|); against the "
          f"kernel-valued plain step {replay[0]:.3e} of max|g| ({replay[1]});"
          f" tolerances {tol}")
    if tol is not False and not (
            loss_err <= tol["loss"] and gap <= tol["matched"]
            and grad_l2 <= tol["grad_l2"] and replay[0] <= tol["replay"]):
        raise AssertionError("bf16 train gate: the kernel forward's step "
                             "disagrees with the plain forward's")
    return out


def matched_cost_gap(model, images, mask, targets, got, want):
    """How far the assignments ``got`` are from the optimum ``want`` on the
    costs of the plain forward's outputs (the final and the auxiliary
    ones): the largest (total cost of ``got`` - total cost of ``want``) /
    max(1, |total of want|) over outputs and images; 0 where they are
    equal, small where they differ by a tie within the step's precision."""
    from aloception_tpu_torch.models.deformable_detr import ms_deform_attn \
        as msda_module
    from aloception_tpu_torch.models.deformable_detr.criterion import (
        focal_cost_matrix)
    from aloception_tpu_torch.train.step import to_float32
    with torch.no_grad(), mock.patch.object(msda_module, "ms_deform_attn",
                                            _PlainMSDA.apply):
        out = to_float32(model(images, mask))
    gap = 0.0
    for k, o in enumerate([out] + out["aux_outputs"]):
        cost = focal_cost_matrix(o["pred_logits"], o["pred_boxes"],
                                 targets["labels"], targets["boxes"],
                                 targets["valid"])
        for b in range(cost.shape[0]):
            t = torch.nonzero(targets["valid"][b]).flatten()
            g = cost[b, got[k, b, t], t].sum().item()
            w = cost[b, want[k, b, t], t].sum().item()
            gap = max(gap, (g - w) / max(1.0, abs(w)))
    return gap


def msda_call_inputs(model, prepared, device):
    """The inputs of the model's first MSDA call (the first encoder
    layer's) on a prepared batch, in the model's dtype."""
    from aloception_tpu_torch.models.deformable_detr import ms_deform_attn \
        as msda_module
    from aloception_tpu_torch.train.trainer import to_device
    calls, msda = [], msda_module.ms_deform_attn

    def first(*args):
        if not calls:
            calls.append(tuple(a.detach().clone() if torch.is_tensor(a)
                               else a for a in args))
        return msda(*args)

    inputs = to_device(prepared["inputs"], device)
    with mock.patch.object(msda_module, "ms_deform_attn", first), \
            torch.no_grad():
        model(*inputs)
    return calls[0]


def bf16_msda_times(value, shapes, loc, w):
    """The MSDA kernel on one training call's inputs against the plain
    version: max|diff|, its tolerance (2e-2 of max|ref| in bf16), the
    kernel's time by CUDA graphs and eager launches, the plain version's,
    the bound."""
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda
    from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch
    args = (value, shapes, loc, w)
    err, tol = _gate(ms_deform_attn_cuda(*args), ms_deform_attn_torch(*args),
                     value.dtype, "bf16 train call")
    bound_ms, bound_by, nbytes, fmas, _ = msda_bound(*args)
    out = dict(shape=dict(B=value.shape[0], Lq=loc.shape[1],
                          Len_v=value.shape[1]),
               max_abs_err=err, tol=tol,
               ms=graph_ms(lambda: ms_deform_attn_cuda(*args)),
               eager_ms=cuda_ms(lambda: ms_deform_attn_cuda(*args)),
               plain_ms=graph_ms(lambda: ms_deform_attn_torch(*args),
                                 iters=5, reps=1),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, fmas=fmas)
    print(f"msda bf16 train call B={value.shape[0]} Lq={loc.shape[1]} "
          f"[{brief(plan_of(*args))}]: max|kernel-plain| {err:.3e} (tol "
          f"{tol:.3e}); kernel {out['ms']:.4f} ms (graph) "
          f"{out['eager_ms']:.4f} ms (eager), plain {out['plain_ms']:.4f} ms;"
          f" bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
          f"{fmas / 1e9:.3f} G FMA), {bound_ms / out['ms']:.1%} of the bound")
    return out


def bf16_steps(trainer, recorder, batches, tag, counts):
    """``recorded_fit`` over ``batches`` with the peak memory: per step the
    host ms, and each step's (msda launches, backward passes, hungarian
    launches) must be ``counts`` and its synchronising operations 1.
    Returns (per_batch, step ms after the first, peak GiB, launches)."""
    torch.cuda.reset_peak_memory_stats()
    per_batch = recorded_fit(trainer, recorder, batches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _check_losses(per_batch, tag)
    for i, (_, c, syncs, _) in enumerate(per_batch):
        if c != counts or syncs != 1:
            raise AssertionError(f"{tag} batch {i}: (msda, backward, "
                                 f"hungarian) {c}, {syncs} syncs")
    timed = [dt * 1e3 for dt, _, _, _ in per_batch[1:]]
    launches = tuple(sum(c[i] for _, c, _, _ in per_batch) for i in range(3))
    print(f"{tag}: {len(per_batch)} steps through Trainer.fit; warm-up "
          f"{per_batch[0][0] * 1e3:.1f} ms; timed step ms "
          f"{[round(t, 2) for t in timed]}, mean {sum(timed) / len(timed):.2f}"
          f" ms; peak memory {peak_gib:.2f} GiB; (msda, backward, hungarian)"
          f" a step {counts}, totals {launches}; loss_total "
          f"{[round(m['loss_total'], 4) for _, _, _, m in per_batch]}")
    return per_batch, sum(timed) / len(timed), peak_gib, launches


def bf16_deformable_cell(device, fp32):
    """Deformable-DETR-R50-refine (91 classes, dropout 0.1) in bfloat16 over
    float32 masters through ``make_deformable_detr_trainer(dtype=
    torch.bfloat16).fit`` on train_phase's 7 batches of 8 at 640 x 640: 12
    MSDA launches and 12 backward passes a step, one Hungarian launch; the
    step's profile, the MSDA bf16 forward at the first encoder call, and
    the eval-mode loss falling over OVERFIT_STEPS on one batch; beside
    ``fp32``, train_phase's numbers of the same run."""
    import tempfile
    from aloception_tpu_torch.models.deformable_detr import deformable_detr_r50
    from aloception_tpu_torch.train import (CocoDetection2Detr,
                                            make_deformable_detr_trainer)

    model = deformable_detr_r50(
        num_classes=91, with_box_refine=True, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    dm = CocoDetection2Detr(batch_size=TRAIN_BATCH, sample=True,
                            size=TRAIN_SIZE)
    batches = SampledLoader(dm.train_dataset, TRAIN_BATCH, 1 + TRAIN_STEPS,
                            seed=30)
    recorder = make_recorder()
    tag = f"deformable_detr_r50_refine training bf16 bs{TRAIN_BATCH} " \
          f"{TRAIN_SIZE}"
    with tempfile.TemporaryDirectory() as log_dir:
        trainer = make_deformable_detr_trainer(
            model=model, data_module=dm, log_dir=log_dir,
            callbacks=[recorder], seed=0, dtype=torch.bfloat16)
        per_batch, step_ms, peak_gib, launches = bf16_steps(
            trainer, recorder, batches, tag,
            (MSDA_CALLS_PER_FORWARD, MSDA_CALLS_PER_FORWARD, 1))
        fixed = one_batch(dm.train_dataset, TRAIN_BATCH, seed=31)
        prepared = dm.prepare_batch(fixed)
        prof = train_profile(trainer, prepared, device)
        msda = bf16_msda_times(*msda_call_inputs(trainer.model, prepared,
                                                 device))
        fwd_ms = prof["parts"]["msda forward kernel"][0]
        print(f"{tag}: step {step_ms:.2f} ms vs fp32 {fp32['step_ms']:.2f}; "
              f"device-busy {prof['busy_ms']:.2f} ms vs fp32 "
              f"{fp32['profile']['busy_ms']:.2f}; peak {peak_gib:.2f} GiB vs "
              f"fp32 {fp32['peak_gib']:.2f}; MSDA forward kernels "
              f"{fwd_ms:.3f} ms a step, "
              f"{fwd_ms / prof['busy_ms']:.2%} of device-busy")
        overfit = falling_eval_loss(trainer, recorder, fixed, OVERFIT_STEPS,
                                    device, f"{tag}, one repeated batch")
    return dict(step_ms=step_ms, peak_gib=peak_gib, launches=launches,
                profile=prof, msda=msda, overfit=overfit,
                fp32=dict(step_ms=fp32["step_ms"], peak_gib=fp32["peak_gib"],
                          busy_ms=fp32["profile"]["busy_ms"]))


def bf16_detr_cell(device):
    """DETR-R50 (91 classes) in bfloat16 over float32 masters through
    ``make_detr_trainer(dtype=torch.bfloat16).fit``: DETR_TRAIN_BATCHES
    batches of 16 at 384 x 384, accumulate 4 (2 updates), a Hungarian
    launch a batch; then the eval-mode loss falling over as many batches of
    one repeated batch."""
    import tempfile
    from aloception_tpu_torch.models.detr import detr_r50
    from aloception_tpu_torch.train import (CocoDetection2Detr,
                                            make_detr_trainer)

    model = detr_r50(num_classes=DETR_CLASSES, device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    dm = CocoDetection2Detr(batch_size=DETR_TRAIN_BATCH, sample=True,
                            size=DETR_TRAIN_SIZE)
    batches = SampledLoader(dm.train_dataset, DETR_TRAIN_BATCH,
                            DETR_TRAIN_BATCHES, seed=40)
    recorder = make_recorder()
    tag = f"detr_r50 training bf16 bs{DETR_TRAIN_BATCH} {DETR_TRAIN_SIZE}"
    with tempfile.TemporaryDirectory() as log_dir:
        trainer = make_detr_trainer(model=model, data_module=dm,
                                    log_dir=log_dir, callbacks=[recorder],
                                    seed=0, dtype=torch.bfloat16)
        per_batch, step_ms, peak_gib, launches = bf16_steps(
            trainer, recorder, batches, tag, (0, 0, 1))
        if trainer.optimizer.updates != DETR_TRAIN_BATCHES // 4:
            raise AssertionError(f"{trainer.optimizer.updates} updates")
        fixed = one_batch(dm.train_dataset, DETR_TRAIN_BATCH, seed=41)
        prof = train_profile(trainer, dm.prepare_batch(fixed), device)
        overfit = falling_eval_loss(trainer, recorder, fixed,
                                    DETR_TRAIN_BATCHES, device,
                                    f"{tag}, one repeated batch")
    return dict(step_ms=step_ms, peak_gib=peak_gib, launches=launches,
                busy_ms=prof["busy_ms"], idle=prof["idle"], overfit=overfit)


def slow_conv_times(device, dtype):
    """RAFT's two slow motion-encoder convolutions at the FlyingChairs
    stage (batch 10, 46x62, channels-last, cuDNN's heuristic): forward and
    forward + backward ms by CUDA events, and the cuDNN kernels a forward
    and backward launch (their names carry the algorithm)."""
    from torch.profiler import ProfilerActivity
    out = {}
    H8, W8 = RAFT_TRAIN_HW[0] // 8, RAFT_TRAIN_HW[1] // 8
    for name, (cin, cout, k) in RAFT_SLOW_CONVS.items():
        conv = torch.nn.Conv2d(cin, cout, k, padding=k[0] // 2, device=device,
                               dtype=dtype)
        conv.to(memory_format=torch.channels_last)
        x = torch.randn(RAFT_TRAIN_BATCH, cin, H8, W8, device=device,
                        dtype=dtype).contiguous(
            memory_format=torch.channels_last).requires_grad_()

        def both():
            conv.zero_grad(set_to_none=True)
            x.grad = None
            conv(x).float().sum().backward()

        fwd, fwd_bwd = cuda_ms(lambda: conv(x), 10, 3), cuda_ms(both, 10, 3)
        _trace(both, [ProfilerActivity.CUDA], 1)   # a first trace can miss
        prof = _trace(both, [ProfilerActivity.CUDA], 1)
        kernels = sorted({e.key[:90] for e in prof.key_averages()
                          if _device_us(e, self_only=True) > 0})
        out[name] = dict(forward_ms=fwd, forward_backward_ms=fwd_bwd,
                         kernels=kernels)
        print(f"raft {name} ({cin}->{cout}, {k}) {str(dtype)[6:]}: forward "
              f"{fwd:.3f} ms, forward + backward {fwd_bwd:.3f} ms; kernels "
              f"{kernels}")
    return out


def bf16_raft_cell(device, fp32):
    """RAFT (random weights) in bfloat16 over float32 masters, its norms and
    the cnet's BatchNorm statistics in float32, through
    ``make_raft_trainer(dtype=torch.bfloat16).fit`` at raft_train_phase's
    configuration (bs10 368x496, 12 iterations, OneCycle): a warm-up and
    RAFT_TRAIN_STEPS timed steps, no kernel launch, one sync a batch; the
    profile; the two slow convolutions in bf16 and fp32; the loss on the
    batch's statistics (``batch_stats_loss``) over RAFT_OVERFIT_STEPS on
    one batch, reported and not held: in bf16 that batch's train loss jumps
    from ~17 to 40-57 and back within the first steps (fp32 falls
    smoothly), and its eval-mode loss, on the running statistics, rose in
    a card run (17.82 -> 21.94)."""
    import tempfile
    from aloception_tpu_torch.models.raft import raft
    from aloception_tpu_torch.train import Data2RAFT, make_raft_trainer

    pairs = shifted_pairs(4 * RAFT_TRAIN_BATCH, RAFT_TRAIN_HW, 110)
    dm = Data2RAFT(batch_size=RAFT_TRAIN_BATCH, sample=True)
    batches = SampledLoader(pairs, RAFT_TRAIN_BATCH, 1 + RAFT_TRAIN_STEPS,
                            seed=111)
    recorder = make_recorder()
    model = raft(device=device,
                 generator=torch.Generator(device=device).manual_seed(112))
    tag = f"raft training bf16 bs{RAFT_TRAIN_BATCH} {RAFT_TRAIN_HW} " \
          f"{RAFT_ITERS} iterations"
    with tempfile.TemporaryDirectory() as log_dir:
        trainer = make_raft_trainer(
            model=model, data_module=dm, iters=RAFT_ITERS,
            num_steps=1 + RAFT_TRAIN_STEPS + 2 + RAFT_OVERFIT_STEPS,
            log_dir=log_dir, callbacks=[recorder], seed=0,
            dtype=torch.bfloat16)
        per_batch, step_ms, peak_gib, _ = bf16_steps(
            trainer, recorder, batches, tag, (0, 0, 0))
        fixed = one_batch(pairs, RAFT_TRAIN_BATCH, seed=113)
        prof = train_profile(trainer, dm.prepare_batch(fixed), device)
        print(f"{tag}: step {step_ms:.2f} ms vs fp32 {fp32['step_ms']:.2f}; "
              f"device-busy {prof['busy_ms']:.2f} ms vs fp32 "
              f"{fp32['profile']['busy_ms']:.2f}; peak {peak_gib:.2f} GiB vs "
              f"fp32 {fp32['peak_gib']:.2f}")
        convs = {str(dt)[6:]: slow_conv_times(device, dt)
                 for dt in (torch.bfloat16, torch.float32)}
        overfit = falling_eval_loss(trainer, recorder, fixed,
                                    RAFT_OVERFIT_STEPS, device,
                                    f"{tag}, one repeated batch",
                                    measure=batch_stats_loss, hold=False)
    return dict(step_ms=step_ms, peak_gib=peak_gib, busy_ms=prof["busy_ms"],
                idle=prof["idle"], convs=convs, overfit=overfit,
                fp32=dict(step_ms=fp32["step_ms"], peak_gib=fp32["peak_gib"],
                          busy_ms=fp32["profile"]["busy_ms"]))


def crc32c_bitwise(data):
    """CRC-32C bit by bit (Castagnoli, reflected 0x82F63B78): a check of
    the logger's table-driven one that shares no code with it."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 & -(crc & 1))
    return crc ^ 0xFFFFFFFF


def _proto_fields(buf):
    """(field number, wire type, value) of a protocol buffer message:
    varints as ints, 64- and 32-bit fields as bytes, the rest as bytes."""
    pos, out = 0, []

    def varint():
        nonlocal pos
        shift = result = 0
        while True:
            b = buf[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return result
    while pos < len(buf):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            value = varint()
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n = varint()
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise AssertionError(f"wire type {wire}")
        out.append((field, wire, value))
    return out


def read_event_file(path):
    """The records of a TensorBoard event file, each frame's two masked
    CRC-32Cs checked: (events, {tag: [(step, simple_value)]})."""
    import struct

    def masked(data):
        crc = crc32c_bitwise(data)
        return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF

    with open(path, "rb") as f:
        raw = f.read()
    pos, events, scalars = 0, [], {}
    while pos < len(raw):
        head = raw[pos:pos + 8]
        (n,), (head_crc,) = struct.unpack("<Q", head), struct.unpack(
            "<I", raw[pos + 8:pos + 12])
        data = raw[pos + 12:pos + 12 + n]
        (data_crc,) = struct.unpack("<I", raw[pos + 12 + n:pos + 16 + n])
        if masked(head) != head_crc or masked(data) != data_crc:
            raise AssertionError(f"{path}: a record's CRC at byte {pos}")
        pos += 16 + n
        fields = {f: v for f, _, v in _proto_fields(data)}
        events.append(fields)
        step = fields.get(2, 0)
        for f, _, value in _proto_fields(fields.get(5, b"")):
            parts = {k: v for k, _, v in _proto_fields(value)}
            if f == 1 and 2 in parts:
                scalars.setdefault(parts[1].decode(), []).append(
                    (step, struct.unpack("<f", parts[2])[0]))
    if events[0].get(3) != b"brain.Event:2":
        raise AssertionError(f"{path}: no file version first")
    return events, scalars


def bf16_commands_cell():
    """``train_on_coco --sample --fast_dev_run --bf16 --log tensorboard``
    for ``deformable`` (36 MSDA launches, 24 backward passes) and
    ``panoptic_deformable`` (36, none): each run's event file read back,
    every record's CRCs checked, its scalars finite and the validation
    ones there."""
    import glob
    import io
    import math
    import tempfile
    from aloception_tpu_torch.commands import train_on_coco
    out = {}
    with tempfile.TemporaryDirectory() as log_dir:
        for model, backward in (("deformable", 2), ("panoptic_deformable",
                                                    0)):
            _reset_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                trainer = train_on_coco.main(
                    ["--sample", "--model", model, "--fast_dev_run", "--bf16",
                     "--log", "tensorboard", "--log_dir", log_dir])
            torch.cuda.synchronize()
            msda, n_backward, hung = _counts()
            (path,) = glob.glob(os.path.join(trainer.ckpt_dir, "*tfevents*"))
            events, scalars = read_event_file(path)
            values = [v for series in scalars.values() for _, v in series]
            val = [t for t in scalars if t.startswith("val/")]
            print(f"train_on_coco --bf16 --log tensorboard --model {model} "
                  f"on the card: {trainer.global_step} steps; msda launches "
                  f"{msda}, backward passes {n_backward}, hungarian {hung}; "
                  f"event file {len(events)} records, CRCs checked, "
                  f"{len(values)} scalars ({len(val)} validation tags)")
            if not (trainer.global_step == 2 and msda ==
                    3 * MSDA_CALLS_PER_FORWARD and n_backward ==
                    backward * MSDA_CALLS_PER_FORWARD and val
                    and all(math.isfinite(v) for v in values)):
                raise AssertionError(f"train_on_coco --bf16 {model}: msda "
                                     f"{msda}, backward {n_backward}, "
                                     f"scalars {scalars}")
            out[model] = dict(msda_launches=msda, backward_passes=n_backward,
                              hungarian_launches=hung, records=len(events),
                              scalars=len(values))
    return out


def bf16_train_phase(device, fp32):
    """bfloat16 training on the card at full published width, random
    weights, TF32 off: the bf16 train gate, the Deformable-DETR, DETR and
    RAFT cells beside ``fp32`` (the float32 phases' numbers of this run)
    and the two commands with ``--bf16 --log tensorboard``. The counts are
    set to 0 just before each training path and read just after it."""
    out = dict(gate=bf16_gate_phase(device))
    torch.cuda.empty_cache()
    out["deformable"] = bf16_deformable_cell(device, fp32["deformable"])
    torch.cuda.empty_cache()
    out["detr"] = bf16_detr_cell(device)
    torch.cuda.empty_cache()
    out["raft"] = bf16_raft_cell(device, fp32["raft"])
    torch.cuda.empty_cache()
    out["commands"] = bf16_commands_cell()
    return out


def export_command(argv):
    """``export_model.main(argv)`` with its wall seconds, the package's
    size and the device's peak memory; returns (the exporter, whose
    ``executor`` holds the package loaded, the profile report, stats)."""
    import os
    from aloception_tpu_torch.commands import export_model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exporter, report = export_model.main(argv)
    torch.cuda.synchronize()
    artifact = exporter.artifact
    meta = artifact.meta
    stats = dict(seconds=time.perf_counter() - t0,
                 export_s=meta["export_s"], compile_s=meta["compile_s"],
                 package_mib=os.path.getsize(artifact.package_path) / 2 ** 20,
                 device_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 sanity_max_diff=meta.get("sanity_max_diff"))
    print(f"export {' '.join(argv)}: {stats['seconds']:.1f} s (torch.export "
          f"{stats['export_s']:.1f} s, AOTInductor {stats['compile_s']:.1f} "
          f"s), package {stats['package_mib']:.1f} MiB, device peak "
          f"{stats['device_peak_gib']:.3f} GiB, sanity max|diff| on the zero "
          f"example {stats['sanity_max_diff']}")
    if report is not None:
        print(f"  profile: {report}")
    return exporter, report, stats


def _export_gate(got, want, tag, tol=1e-3):
    """Outputs key by key within tol * max(1, max|ref|); returns the worst
    relative error."""
    worst = 0.0
    for k in want:
        ref = max(1.0, want[k].abs().max().item())
        err = (got[k].float() - want[k].float()).abs().max().item() / ref
        if not err <= tol:
            raise AssertionError(f"{tag}: {k} exported vs eager {err} > {tol}")
        worst = max(worst, err)
    return worst


def latency_pair(executor, eager, inputs, n=EXPORT_TIMED):
    """The package's and the eager module's latency at the same inputs:
    p50/p99 by the host clock to a synchronised end (``Profiler``), and
    device-busy ms a call from a device-only trace."""
    from torch.profiler import ProfilerActivity
    from aloception_tpu_torch.export import Profiler
    out = {}
    for tag, fn in (("exported", lambda: executor(*inputs)),
                    ("eager", lambda: eager(*inputs))):
        with torch.inference_mode():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            prof = Profiler()
            for _ in range(n):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                prof.record(time.perf_counter() - t0)
            n_act, busy, window = _device_busy(
                _trace(fn, [ProfilerActivity.CUDA], 3))
        out[tag] = dict(prof.report(), device_busy_ms=busy / 3 / 1e3,
                        device_activities=n_act / 3,
                        idle_share=1 - busy / window)
    print(f"  latency at {tuple(inputs[0].shape)}: " + "; ".join(
        f"{k} p50 {v['p50_ms']:.3f} ms p99 {v['p99_ms']:.3f} ms, "
        f"{v['device_busy_ms']:.3f} ms device-busy in "
        f"{v['device_activities']:.0f} activities, idle "
        f"{v['idle_share']:.3f}" for k, v in out.items()))
    return out


def export_requests(executor):
    """``ModelHandler`` on the loaded package: EXPORT_REQUEST_HW uint8
    images (one a request, the package's batch), each resized on the card
    to EXPORT_HW; JSON fields checked; one device-to-host fetch in
    postprocess; then a request of JPEG bytes (decoded on the host) whose
    boxes must equal those of its decoded pixels sent as a uint8 array.
    Returns (MSDA launches, latency report, detections, the bytes
    request's launches and detections)."""
    import json
    import numpy as np
    from aloception_tpu_torch.export.production import ModelHandler
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda

    handler = ModelHandler(input_size=EXPORT_HW, threshold=0.0)
    handler.initialize(executor)
    rng = np.random.RandomState(8)
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
              for h, w in EXPORT_REQUEST_HW]
    handler.handle([images[0]])            # warm-up
    torch.cuda.synchronize()
    handler.executor.profiler.times.clear()
    ms_deform_attn_cuda.launches = 0
    results = [handler.handle([img]) for img in images]
    torch.cuda.synchronize()
    launches = ms_deform_attn_cuda.launches
    n_dets = 0
    for res in results:
        if len(res) != 1:
            raise AssertionError(f"{len(res)} results for one image")
        dets = json.loads(res[0])
        n_dets += len(dets)
        for d in dets:
            box = np.asarray(d["box_xcyc_rel"])
            if set(d) != {"label", "score", "box_xcyc_rel"} or not (
                    isinstance(d["label"], int) and 0 <= d["label"] < 91
                    and 0.0 <= d["score"] <= 1.0 and box.shape == (4,)
                    and np.isfinite(box).all() and 0 <= box.min()
                    and box.max() <= 1):
                raise AssertionError(f"malformed detection {d}")
    outputs = handler.inference(handler.preprocess([images[1]]))
    fetches = syncs_of(lambda: handler.postprocess(outputs))
    if len(fetches) != 1:
        raise AssertionError(f"postprocess synchronised {len(fetches)} times")
    request_syncs = syncs_of(lambda: handler.handle([images[2]]))
    report = handler.executor.profiler.report()
    import io
    from PIL import Image
    from aloception_tpu_torch.runtime import decode_bytes
    buf = io.BytesIO()
    Image.fromarray(images[3]).save(buf, "JPEG", quality=90)
    ms_deform_attn_cuda.launches = 0
    from_bytes = handler.handle([buf.getvalue()])
    torch.cuda.synchronize()
    bytes_launches = ms_deform_attn_cuda.launches
    from_array = handler.handle([decode_bytes(buf.getvalue()).numpy()])
    if from_bytes != from_array or bytes_launches != MSDA_CALLS_PER_FORWARD:
        raise AssertionError(f"a JPEG-bytes request ({bytes_launches} MSDA "
                             "launches) and its pixels as an array differ")
    n_bytes = len(json.loads(from_bytes[0]))
    print(f"  a request of {len(buf.getvalue())} JPEG bytes: {n_bytes} "
          f"detections, equal to its decoded pixels sent as an array; "
          f"{bytes_launches} MSDA launches")
    print(f"  {len(images)} handler requests: {n_dets} detections, MSDA "
          f"launches {launches}, package p50 {report['p50_ms']:.3f} ms; one "
          f"fetch in postprocess, {len(request_syncs)} synchronising "
          "operations a request (host-to-device copy of the image included)")
    return launches, report, n_dets, dict(msda_launches=bytes_launches,
                                          detections=n_bytes)


def export_phase(device):
    """The slice's path: ``export_model`` for Deformable-DETR-R50-refine and
    DETR-R50 at the JAX defaults (fp32, bs1, 480x640), each package, as the
    command's ``Executor`` loaded it, held against eager on a seeded batch
    (1e-3 * max(1, max|ref|)); the Deformable package's MSDA launches and
    plans against eager's; 4 requests through ``ModelHandler``; the
    latencies; the bf16 profile's exported program (a sanity check only)."""
    import os
    from aloception_tpu_torch.export import DeformableDetrExporter
    from aloception_tpu_torch.models.deformable_detr import deformable_detr_r50
    from aloception_tpu_torch.models.detr import detr_r50
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda

    os.makedirs(EXPORT_DIR, exist_ok=True)
    g = torch.Generator(device=device).manual_seed(21)
    x = torch.randn(1, *EXPORT_HW, 3, device=device, generator=g)
    mask = torch.zeros(1, *EXPORT_HW, device=device)
    mask[:, :, EXPORT_HW[1] * 3 // 4:] = 1.0      # a padded band
    results = {}
    for name, build in (("deformable", lambda: deformable_detr_r50(
            with_box_refine=True, device=device)),
                        ("detr", lambda: detr_r50(device=device))):
        path = os.path.join(EXPORT_DIR, f"{name}.pt2")
        exporter, report, stats = export_command(
            ["--model", name, "--out", path, "--profile"])
        executor = exporter.executor
        eager = build()     # the same seeded weights as the command's
        module = lambda images, m, eager=eager: {
            k: v.float() for k, v in eager(images, m).items()
            if k in ("pred_logits", "pred_boxes")}
        ms_deform_attn_cuda.launches = 0
        ms_deform_attn_cuda.plans.clear()
        with torch.inference_mode():
            got = executor(x, mask)
            torch.cuda.synchronize()
            launches = ms_deform_attn_cuda.launches
            plans = dict(ms_deform_attn_cuda.plans)
            ms_deform_attn_cuda.plans.clear()
            want = module(x, mask)
            eager_plans = dict(ms_deform_attn_cuda.plans)
        err = _export_gate(got, want, f"{name} package")
        expect = MSDA_CALLS_PER_FORWARD if name == "deformable" else 0
        if launches != expect:
            raise AssertionError(f"{name} package: {launches} MSDA launches "
                                 f"a forward, not {expect}")
        print(f"  {name} package against eager on a seeded padded batch: "
              f"{err:.3e} of max(1, max|ref|); {launches} MSDA launches a "
              "forward")
        for key in sorted(set(plans) | set(eager_plans), key=str):
            print(f"  MSDA plan at (B, Lq, Len_v, dtype) {key}: package "
                  f"{plans.get(key)}, eager {eager_plans.get(key)}")
        if plans != eager_plans:
            print("  the package's plans differ from eager's")
        results[name] = dict(stats, profile=report, gate=err,
                             msda_launches_a_forward=launches,
                             plans_equal=plans == eager_plans,
                             latency=latency_pair(executor, module,
                                                  (x, mask)))
        if name == "deformable":
            launches, served, n_dets, from_bytes = export_requests(executor)
            if launches != MSDA_CALLS_PER_FORWARD * len(EXPORT_REQUEST_HW):
                raise AssertionError(f"{launches} MSDA launches in "
                                     f"{len(EXPORT_REQUEST_HW)} requests")
            results[name].update(requests=len(EXPORT_REQUEST_HW),
                                 request_msda_launches=launches,
                                 served=served, detections=n_dets,
                                 bytes_request=from_bytes)
        del exporter, executor, eager, module
        torch.cuda.empty_cache()

    # the bf16 profile (bf16-rounded parameters, float32 compute, as the
    # JAX profile): its exported program against its eager module, on the
    # card; not compiled, to keep the run inside its time limit
    exporter = DeformableDetrExporter(deformable_detr_r50(
        with_box_refine=True, device=device), input_shape=EXPORT_HW,
                                      precision="bf16")
    t0 = time.perf_counter()
    program, module, _ = exporter.export_program()
    export_s = time.perf_counter() - t0
    with torch.inference_mode():
        got, want = program.module()(x, mask), module(x, mask)
    results["deformable_bf16"] = dict(export_s=export_s, gate=_export_gate(
        got, want, "bf16 profile program"))
    print(f"  bf16 profile: torch.export {export_s:.1f} s, the program "
          f"against eager {results['deformable_bf16']['gate']:.3e}")
    del exporter, program, module
    torch.cuda.empty_cache()
    return results


def tiny_export_phase(device):
    """The RAFT exporter (``iters`` TINY_RAFT_ITERS) and the panoptic
    exporter at the CPU tests' tiny widths, each exported by
    ``torch.export`` and its program held against eager on the card; not
    compiled, for time (the CPU tests compile tiny packages, the
    full-width ones above run on the card)."""
    from aloception_tpu_torch.export import PanopticExporter, RAFTExporter
    from aloception_tpu_torch.models.detr import Detr
    from aloception_tpu_torch.models.panoptic import DetrPanoptic
    from aloception_tpu_torch.models.raft import RAFTBase, built

    g = torch.Generator(device=device).manual_seed(22)
    tiny = dict(hidden_dim=64, num_queries=16, nheads=4, num_encoder_layers=1,
                num_decoder_layers=1, dim_feedforward=64,
                stage_sizes=(1, 1, 1, 1))
    detector = Detr(num_classes=PANOPTIC_CLASSES, return_intermediate=True,
                    device=device, **tiny).eval()
    raft = built(RAFTBase(hidden_dim=32, context_dim=32, corr_levels=2,
                          corr_radius=2, device=device), torch.float32)
    frames = [torch.rand(1, 3, *TINY_EXPORT_HW, device=device, generator=g)
              * 2 - 1 for _ in range(2)]
    image = torch.randn(1, *TINY_EXPORT_HW, 3, device=device, generator=g)
    mask = torch.zeros(1, *TINY_EXPORT_HW, device=device)
    out = {}
    for name, exporter, inputs in (
            ("raft_tiny", RAFTExporter(raft, input_shape=TINY_EXPORT_HW,
                                       iters=TINY_RAFT_ITERS), frames),
            ("panoptic_tiny", PanopticExporter(
                detector, DetrPanoptic(detector,
                                       num_classes=PANOPTIC_CLASSES),
                input_shape=TINY_EXPORT_HW), (image, mask))):
        t0 = time.perf_counter()
        program, module, _ = exporter.export_program()
        export_s = time.perf_counter() - t0
        with torch.inference_mode():
            got, want = program.module()(*inputs), module(*inputs)
        if isinstance(want, torch.Tensor):
            got, want = {"flow": got}, {"flow": want}
        out[name] = dict(export_s=export_s,
                         gate=_export_gate(got, want, name))
    print(f"tiny exporters on the card: {out}")
    return out


# the int8 weights of Deformable-DETR-R50 by role, each quantized alone
INT8_GROUPS = {
    "encoder": lambda k: k.startswith("transformer.encoder."),
    "decoder layers": lambda k: k.startswith("transformer.decoder.layers."),
    "heads": lambda k: "embed" in k}


def int8_witness(model, q, dense, ref, got, logits_with, device):
    """Where the int8 logits' deviation comes from, as fractions of
    max|fp32 logits|: the logit of the largest deviation (its place, its
    float32 and int8 values) and the deviation's median and 99th
    percentile; the deviation with each INT8_GROUPS group quantized alone;
    and with every int8 weight moved instead by seeded uniform noise of the
    quantizer's rounding size (+- half a step; none in the rows of zeros,
    which int8 holds exactly), which says how far the model moves under any
    perturbation of that size."""
    import numpy as np
    peak = ref.abs().max()
    fp32 = model.state_dict()
    int8_names = [k for k, v in q.items() if isinstance(v, dict)]
    d = (got - ref).abs()
    where = tuple(int(i) for i in np.unravel_index(int(d.argmax()), d.shape))
    share = torch.quantile((d / peak).flatten().float(),
                           torch.tensor([0.5, 0.99], device=device))
    out = dict(max_at=dict(batch_query_class=where,
                           fp32=ref[where].item(), int8=got[where].item(),
                           max_abs_fp32=peak.item()),
               p50=share[0].item(), p99=share[1].item(), alone={})
    for group, member in INT8_GROUPS.items():
        state = {k: dense[k] if k in q and isinstance(q[k], dict)
                 and member(k) else v for k, v in fp32.items()}
        out["alone"][group] = ((logits_with(state) - ref).abs().max()
                               / peak).item()
    # one noise draw per tensor: the heads are shared under two names
    gen = torch.Generator(device=device).manual_seed(24)
    noise = {}
    for k in int8_names:
        w = fp32[k]
        if w.data_ptr() not in noise:
            u = torch.rand(w.shape, generator=gen, device=device) - 0.5
            step = q[k]["scale"] * (w.abs().amax(1, keepdim=True) > 0)
            noise[w.data_ptr()] = w + u * step
    noisy = {k: noise[v.data_ptr()] if k in int8_names else v
             for k, v in fp32.items()}
    out["uniform_half_step_noise"] = ((logits_with(noisy) - ref).abs().max()
                                      / peak).item()
    print(f"int8 witness: {out}")
    return out


def quantization_phase(device):
    """Full-width Deformable-DETR-R50-refine, float32: ``quantize_weights_int8``
    held to its own bound (every int8 weight within half a step, its row's
    max|w| / 254, of the float32 one; every other tensor unchanged); the
    int8 weights-only model's logits against the float32 model's on a seeded
    batch, printed beside the JAX test's contract (INT8_CONTRACT of
    max|fp32 logits|, set on a tiny DETR; the quantizer itself is held
    equal to the JAX package's by the CPU tests); ``MinMaxCalibrator`` over
    CALIB_BATCHES COCO sample batches on the card."""
    import copy
    from aloception_tpu_torch.alodataset import CocoBaseDataset
    from aloception_tpu_torch.export import (DataBatchStreamer,
                                             MinMaxCalibrator,
                                             quantization_error,
                                             quantize_weights_int8)
    from aloception_tpu_torch.models.deformable_detr import deformable_detr_r50

    model = deformable_detr_r50(with_box_refine=True, device=device)
    q, dequant = quantize_weights_int8(model)
    dense = dequant(q)
    n_int8 = 0
    for name, w in model.state_dict().items():
        if isinstance(q[name], dict):
            n_int8 += 1
            half_step = q[name]["scale"] * (0.5 + 1e-5)
            if not bool(((dense[name] - w.float()).abs() <= half_step).all()):
                raise AssertionError(f"int8 {name}: beyond half a step")
        elif not torch.equal(dense[name], w):
            raise AssertionError(f"int8 changed {name}, not an int8 weight")
    int8 = copy.deepcopy(model)
    g = torch.Generator(device=device).manual_seed(23)
    x = torch.randn(2, *EXPORT_HW, 3, device=device, generator=g)
    mask = torch.zeros(2, *EXPORT_HW, device=device)
    with torch.inference_mode():
        ref = model(x, mask)["pred_logits"]
    peak = ref.abs().max()

    def logits_with(state):
        int8.load_state_dict(state)
        with torch.inference_mode():
            return int8(x, mask)["pred_logits"]

    got = logits_with(dense)
    if got.shape != ref.shape or not bool(got.isfinite().all()):
        raise AssertionError("int8 logits not finite or of another shape")
    rel = ((got - ref).abs().max() / peak).item()
    print(f"int8 weights-only: {n_int8} weights within half a step; logits "
          f"{rel:.4f} of max|fp32 logits| (the JAX test's contract on a "
          f"tiny DETR: < {INT8_CONTRACT}; "
          f"{'met' if rel < INT8_CONTRACT else 'not met'} here)")
    witness = int8_witness(model, q, dense, ref, got, logits_with, device)
    del int8

    def prepare(frames):
        imgs = torch.stack([f.to(device).norm_resnet().resize(EXPORT_HW)
                            .as_layout(("H", "W", "C")) for f in frames])
        return imgs.float()

    def activations(images):
        with torch.inference_mode():
            out = model(images, torch.zeros(images.shape[:3], device=device))
        return {"images": images, "pred_logits": out["pred_logits"],
                "pred_boxes": out["pred_boxes"]}

    streamer = DataBatchStreamer(CocoBaseDataset(sample=True),
                                 batch_size=CALIB_BATCH,
                                 max_batches=CALIB_BATCHES, prepare=prepare)
    scales = MinMaxCalibrator().calibrate(activations, streamer)
    if set(scales) != {"images", "pred_logits", "pred_boxes"} or not all(
            0 < s < float("inf") for s in scales.values()):
        raise AssertionError(f"calibration scales {scales}")
    out = dict(int8_weights=n_int8, int8_rel_err=rel,
               int8_jax_contract_met=rel < INT8_CONTRACT,
               int8_witness=witness,
               weight_rel_err=quantization_error(model, q, dequant),
               calibration_scales=scales)
    print(f"quantization at full width: {out}")
    return out


# ---------------------------------------------------------------------------
# 3-D geometry: aloscene's types, the rotated / 3D IoU, the 3D AP and the
# depth metrics on the card, held against the same code on the CPU

IOU_PAIRS = 4096
IOU_FUNCS = ("cal_iou", "cal_giou", "cal_iou_3d", "cal_giou_3d",
             "cal_diou_3d")
KITTI_HW = (375, 1242)
# KITTI's published P2 of the object benchmark: fx = fy, principal point
KITTI_P2 = dict(focal_length=721.5377, principal_point=(172.854, 609.5593))
KITTI_BASELINE = 0.54
SCENE_N = dict(boxes3d=30, points2d=100, oriented=20)
# per frame: resize to, crop (H, W), pad (H, W) offsets, then rotate 5 deg
SCENE_CHAIN = (((300, 994), ((0.05, 0.95), (0.1, 0.9)),
                ((0.0, 0.1), (0.05, 0.05))),
               ((320, 1060), ((0.0, 0.9), (0.05, 0.85)),
                ((0.1, 0.0), (0.0, 0.1))))
SCENE_ANGLE = 5.0
AP3D_SAMPLES, AP3D_PRED, AP3D_GT, AP3D_CLASSES = 100, 100, 30, 3
PAIRWISE = (500, 200)
DEPTH_PAIRS = 4


def iou_boxes(n, dims, g):
    """n boxes of ``dims`` centre coordinates in [-1, 1], sizes in [0.2, 2],
    headings in [-pi, pi] (overlapping centres), on the CPU."""
    return torch.cat([2 * torch.rand(n, dims, generator=g) - 1,
                      0.2 + 1.8 * torch.rand(n, dims, generator=g),
                      (2 * torch.rand(n, 1, generator=g) - 1) * torch.pi], 1)


def iou_hard_cases():
    """(2D pairs, 3D pairs): identical, nested, disjoint, 45 degree cross,
    shared edge, zero width; 3D also a vertical half-overlap and touch."""
    b2 = torch.tensor([
        [[0, 0, 1, 1, 0], [0, 0, 1, 1, 0]],
        [[0, 0, 2, 2, 0.3], [0, 0, 1, 1, 0.3]],
        [[0, 0, 1, 1, 0], [5, 5, 1, 1, 0]],
        [[0, 0, 1, 1, 0], [0, 0, 1, 1, torch.pi / 4]],
        [[0, 0, 1, 1, 0], [1, 0, 1, 1, 0]],
        [[0, 0, 0, 1, 0], [0, 0, 1, 1, 0]]])
    b3 = torch.zeros(len(b2) + 2, 2, 7)
    b3[:len(b2), :, [0, 1, 3, 4, 6]] = b2
    b3[:len(b2), :, 5] = 1.0
    b3[-2] = torch.tensor([[0, 0, 0, 2, 2, 2, 0.3], [0, 0, 1, 2, 2, 2, 0.3]])
    b3[-1] = torch.tensor([[0, 0, 0, 1, 1, 1, 0.0], [0, 0, 1, 1, 1, 1, 0.0]])
    return b2, b3


def iou_parity_step(device):
    """The five IoU functions on 4,096 seeded pairs and the hard cases, on
    the card and on the CPU. Gate: max|card - CPU| <= 1e-5 on the random
    pairs; the hard cases' differences and the pairs above 1e-6 printed."""
    from aloception_tpu_torch.ops import rotated_iou as riou
    g = torch.Generator().manual_seed(31)
    hard = dict(zip((2, 3), iou_hard_cases()))
    out = {}
    for name in IOU_FUNCS:
        dims = 3 if name.endswith("3d") else 2
        rand = iou_boxes(2 * IOU_PAIRS, dims, g).reshape(IOU_PAIRS, 2, -1)
        fn = getattr(riou, name)
        res = {}
        for tag, b in (("random", rand), ("hard", hard[dims])):
            cpu = fn(b[:, 0], b[:, 1])
            card = fn(b[:, 0].to(device), b[:, 1].to(device))
            cpu = cpu if isinstance(cpu, tuple) else (cpu,)
            card = card if isinstance(card, tuple) else (card,)
            diff = torch.stack([(c.cpu() - r).abs() for c, r in
                                zip(card, cpu)]).amax(0)
            if not torch.isfinite(diff).all():
                raise AssertionError(f"{name} {tag}: non-finite difference")
            res[tag] = diff
        err = float(res["random"].max())
        out[name] = {"max_abs_err": err,
                     "pairs_above_1e-6": int((res["random"] > 1e-6).sum()),
                     "hard_abs_err": [float(d) for d in res["hard"]]}
        print(f"geometry iou {name}: {IOU_PAIRS} pairs card vs CPU max|diff| "
              f"{err:.3e} (gate 1e-5), pairs above 1e-6 "
              f"{out[name]['pairs_above_1e-6']}; hard cases "
              f"{['%.1e' % d for d in out[name]['hard_abs_err']]}")
        if err > 1e-5:
            raise AssertionError(f"{name}: card vs CPU {err} > 1e-5")
    return out


def kitti_scene(seed):
    """A KITTI-sized frame on the CPU: uint8 375x1242 pixels, the P2
    intrinsic, 30 labelled 3D boxes, a dense planar depth (a ground plane
    with noise, 2-80 m, its own intrinsic) and its disparity at the stereo
    baseline, 100 absolute 2D points, 20 oriented boxes."""
    import aloception_tpu_torch.aloscene as sc
    g = torch.Generator().manual_seed(seed)
    H, W = KITTI_HW
    f = sc.Frame(torch.randint(0, 256, (3, H, W), generator=g,
                               dtype=torch.uint8))
    K = sc.CameraIntrinsic(**KITTI_P2)
    f.append_cam_intrinsic(K)
    n = SCENE_N["boxes3d"]
    u = torch.rand(n, 7, generator=g)
    boxes = torch.stack([30 * u[:, 0] - 15, 1 + 1.0 * u[:, 1],
                         5 + 65 * u[:, 2], 1.5 + 0.5 * u[:, 3],
                         1.4 + 0.4 * u[:, 4], 3.5 + 1.3 * u[:, 5],
                         (2 * u[:, 6] - 1) * torch.pi], 1)
    f.append_boxes3d(sc.BoundingBoxes3D(boxes, labels=sc.Labels(
        torch.randint(0, 3, (n,), generator=g).float())))
    rows = torch.arange(H, dtype=torch.float32)[:, None] - K.array[1, 2]
    plane = (KITTI_P2["focal_length"] * 1.65 / rows.clamp(min=1e-3))
    depth = (plane.clamp(2.0, 80.0) * (1 + 0.05 * torch.randn(
        H, W, generator=g))).clamp(2.0, 80.0)[None].expand(1, H, W)
    d = sc.Depth(depth.contiguous(), baseline=KITTI_BASELINE)
    d.append_cam_intrinsic(K.clone())
    f.append_depth(d)
    f.append_disparity(d.as_disp(camera_side="left"))
    m = SCENE_N["points2d"]
    pts = torch.rand(m, 2, generator=g) * torch.tensor([W, H])
    f.append_points2d(sc.Points2D(pts, "xy", True, frame_size=(H, W),
                                  labels=sc.Labels(torch.arange(m).float())))
    k = SCENE_N["oriented"]
    u = torch.rand(k, 5, generator=g)
    ob = torch.stack([W * u[:, 0], H * u[:, 1], 20 + 80 * u[:, 2],
                      10 + 40 * u[:, 3], (2 * u[:, 4] - 1) * torch.pi], 1)
    f.add_child("oriented_boxes2d", sc.OrientedBoxes2D(
        ob, absolute=True, frame_size=(H, W),
        labels=sc.Labels(torch.arange(k).float())), mergeable=False)
    return f


def scene_chain(frames):
    """Each frame: norm01 -> resize -> crop -> hflip -> pad -> rotate 5
    degrees (its points, boxes and intrinsic are carried over, as in the
    JAX package); then batch_list, the depth back-projected with each
    item's intrinsic, depth -> disparity -> depth, and each item's
    enclosing 2D boxes of its 3D boxes."""
    import aloception_tpu_torch.aloscene as sc
    done = []
    for f, (size, crop, pad) in zip(frames, SCENE_CHAIN):
        f = f.norm01().resize(size).crop(*crop).hflip().pad(*pad)
        done.append(f.rotate(SCENE_ANGLE))
    batch = sc.batch_list(done)
    points = batch.depth.as_points3d()
    disp = batch.depth.as_disp(baseline=KITTI_BASELINE)
    depth = disp.as_depth()
    boxes2d = [batch.boxes3d[i].get_enclosing_box_2d(batch.cam_intrinsic[i],
                                                     batch.HW)
               for i in range(len(frames))]
    return {"batch": batch, "points3d": points, "disparity": disp,
            "depth": depth, "enclosing_boxes2d": boxes2d}


def tree_err(got, want, path="", errs=None):
    """{path: max|got - want| / max(1, max|want|)} over an object tree of
    the port's types, lists and dicts; names, properties, shapes and the
    places of infinities must be equal."""
    from aloception_tpu_torch.aloscene import AugmentedArray
    errs = {} if errs is None else errs
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{path}: keys {set(got)} != {set(want)}")
        for k in want:
            tree_err(got[k], want[k], f"{path}/{k}", errs)
        return errs
    if isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{path}: {len(got)} != {len(want)} items")
        for i, (a, b) in enumerate(zip(got, want)):
            tree_err(a, b, f"{path}[{i}]", errs)
        return errs
    if want is None:
        if got is not None:
            raise AssertionError(f"{path}: {got} where None")
        return errs
    if not isinstance(want, AugmentedArray):
        raise AssertionError(f"{path}: unexpected {type(want)}")
    if type(got) is not type(want) or got.names != want.names \
            or got._properties != want._properties:
        raise AssertionError(f"{path}: type, names or properties differ")
    if got.shape != want.shape:
        raise AssertionError(f"{path}: shape {got.shape} vs {want.shape}")
    a, b = got.array.cpu().double(), want.array.double()
    finite = torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), finite) or not torch.equal(
            a[~finite].nan_to_num(), b[~finite].nan_to_num()):
        raise AssertionError(f"{path}: non-finite values differ")
    scale = max(1.0, float(b[finite].abs().max()) if finite.any() else 1.0)
    errs[path or "/"] = float((a[finite] - b[finite]).abs().max()) / scale \
        if finite.any() else 0.0
    for k in want._children:
        tree_err(got._children[k], want._children[k],
                 f"{path}.{k}", errs)
    return errs


def kitti_scene_step(device):
    """The scene chain on the card against the CPU. Gate: every payload
    of the result trees within 1e-4 * max(1, max|ref|). Then the chain
    timed on the card (host clock to a synchronised end) and its
    synchronising operations counted."""
    frames = [kitti_scene(seed) for seed in (41, 42)]
    want = scene_chain(frames)
    on_card = [f.to(device) for f in frames]
    torch.cuda.synchronize()
    got = scene_chain(on_card)
    if got["batch"].device != device or got["points3d"].device != device:
        raise AssertionError("the scene chain left the card")
    errs = tree_err(got, want)
    worst = max(errs, key=errs.get)
    n_pts = [len(p) for p in want["batch"].points2d]
    print(f"geometry scene: 2 KITTI frames {KITTI_HW} uint8 -> {SCENE_CHAIN} "
          f"-> rotate {SCENE_ANGLE} -> batch_list {want['batch'].shape}; "
          f"{len(errs)} payloads card vs CPU, worst {worst} "
          f"{errs[worst]:.3e} of max(1, max|ref|) (gate 1e-4); points kept "
          f"{n_pts} of {SCENE_N['points2d']}")
    if errs[worst] > 1e-4:
        raise AssertionError(f"scene {worst}: {errs[worst]} > 1e-4")
    t0 = time.perf_counter()
    scene_chain(on_card)
    torch.cuda.synchronize()
    chain_ms = 1e3 * (time.perf_counter() - t0)
    syncs = syncs_of(lambda: scene_chain(on_card))
    print(f"geometry scene chain on the card: {chain_ms:.3f} ms (host clock, "
          f"warm), {len(syncs)} synchronising operations")
    return {"max_rel_err": errs[worst], "worst": worst,
            "payloads": len(errs), "points_kept": n_pts,
            "chain_ms": chain_ms, "syncs": len(syncs)}


def ap3d_samples(device):
    """100 seeded frames: 30 targets of 3 classes, 100 scored predictions
    (jittered copies of the targets, some of another class, and false
    positives), as BoundingBoxes3D with Labels on ``device``."""
    import aloception_tpu_torch.aloscene as sc
    g = torch.Generator().manual_seed(51)
    n_t, n_p = AP3D_GT, AP3D_PRED
    samples = []
    for _ in range(AP3D_SAMPLES):
        u = torch.rand(n_t, 7, generator=g)
        gt = torch.stack([40 * u[:, 0] - 20, 1 + u[:, 1], 5 + 55 * u[:, 2],
                          1.5 + 0.5 * u[:, 3], 1.4 + 0.4 * u[:, 4],
                          3.5 + 1.3 * u[:, 5], (2 * u[:, 6] - 1) * torch.pi],
                         1)
        gt_cls = torch.randint(0, AP3D_CLASSES, (n_t,), generator=g)
        src = torch.randint(0, n_t, (n_p,), generator=g)
        noise = torch.randn(n_p, 7, generator=g) * torch.tensor(
            [0.4, 0.1, 0.4, 0.1, 0.1, 0.2, 0.2])
        pred = gt[src] + noise
        fp = torch.rand(n_p, generator=g) < 0.3
        pred[fp, 0] += 12 * (torch.rand(int(fp.sum()), generator=g) - 0.5)
        pred[fp, 2] += 12 * (torch.rand(int(fp.sum()), generator=g) - 0.5)
        flip = torch.rand(n_p, generator=g) < 0.1
        cls = torch.where(flip, (gt_cls[src] + 1) % AP3D_CLASSES, gt_cls[src])
        scores = torch.rand(n_p, generator=g)
        samples.append((
            sc.BoundingBoxes3D(pred, labels=sc.Labels(
                cls.float(), scores=scores)).to(device),
            sc.BoundingBoxes3D(gt, labels=sc.Labels(gt_cls.float())
                               ).to(device)))
    return samples


def ap3d_step(device):
    """ApMetrics3D over 100 frames on the card and on the CPU. Gate: equal
    maps. IoUs within 1e-5 of a threshold printed; ms per add_sample."""
    from aloception_tpu_torch.metrics import ApMetrics3D
    from aloception_tpu_torch.metrics.ap_metrics_3d import IOU3D_THRESHOLDS
    maps, ms = {}, {}
    for where in ("cpu", device):
        samples = ap3d_samples(where)
        m = ApMetrics3D()
        if where != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p, t in samples:
            m.add_sample(p, t)
        ms[str(where)] = 1e3 * (time.perf_counter() - t0) / len(samples)
        maps[str(where)] = m.calc_map()
    card, cpu = maps[str(device)], maps["cpu"]
    near = []
    for p, t in ap3d_samples(device):
        iou = p.iou3d_with(t)
        for thr in IOU3D_THRESHOLDS:
            close = (iou - thr).abs() < 1e-5
            near += [(thr, float(v)) for v in iou[close].tolist()]
    print(f"geometry ApMetrics3D: {AP3D_SAMPLES} frames of {AP3D_PRED} "
          f"predictions x {AP3D_GT} targets, {AP3D_CLASSES} classes: card "
          f"{card['all']} == CPU {cpu['all']}: {card == cpu}; IoUs within "
          f"1e-5 of a threshold {near}; ms per add_sample card "
          f"{ms[str(device)]:.3f}, CPU {ms['cpu']:.3f}")
    if card != cpu:
        raise AssertionError(f"ApMetrics3D card {card} != CPU {cpu}")
    return {"map": card["all"], "near_threshold": near,
            "add_sample_ms": ms[str(device)], "add_sample_ms_cpu": ms["cpu"]}


def pairwise_iou_step(device):
    """pairwise(cal_iou_3d) at 500 x 200 (Waymo scale) in float32: device
    ms per call (CUDA events), device activities per call (a trace), the
    same call's ms on the CPU (host clock)."""
    from torch.profiler import ProfilerActivity
    from aloception_tpu_torch.ops import rotated_iou as riou
    g = torch.Generator().manual_seed(61)
    b1 = iou_boxes(PAIRWISE[0], 3, g) * torch.tensor([20, 20, 2] + [1] * 4)
    b2 = iou_boxes(PAIRWISE[1], 3, g) * torch.tensor([20, 20, 2] + [1] * 4)
    c1, c2 = b1.to(device), b2.to(device)

    def call():
        return riou.pairwise(riou.cal_iou_3d, c1, c2)
    card_ms = cuda_ms(call, iters=10, warmup=2)
    prof = _trace(call, [ProfilerActivity.CUDA], 3)
    activities, busy_us, _ = _device_busy(prof)
    activities, busy_ms = activities / 3, busy_us / 3e3
    ref = riou.pairwise(riou.cal_iou_3d, b1, b2)
    t0 = time.perf_counter()
    for _ in range(3):
        riou.pairwise(riou.cal_iou_3d, b1, b2)
    cpu_ms = 1e3 * (time.perf_counter() - t0) / 3
    err = float((call().cpu() - ref).abs().max())
    print(f"geometry pairwise cal_iou_3d {PAIRWISE[0]}x{PAIRWISE[1]} fp32: "
          f"card {card_ms:.3f} ms a call (CUDA events), device-busy "
          f"{busy_ms:.3f} ms and {activities:.0f} device activities a call "
          f"(trace); CPU {cpu_ms:.1f} ms; card vs CPU {err:.2e}")
    if err > 1e-5:
        raise AssertionError(f"pairwise cal_iou_3d card vs CPU {err}")
    return {"ms": card_ms, "busy_ms": busy_ms, "activities": activities,
            "cpu_ms": cpu_ms, "max_abs_err": err}


def depth_metrics_step(device):
    """DepthMetrics over 4 KITTI-sized depth pairs with a validity mask, on
    the card and on the CPU. Gate: every key within 1e-9 relative."""
    from aloception_tpu_torch.metrics import DepthMetrics
    g = torch.Generator().manual_seed(71)
    pairs = []
    for _ in range(DEPTH_PAIRS):
        t = 0.5 + 89.5 * torch.rand(1, *KITTI_HW, generator=g)
        p = t * (0.7 + 0.7 * torch.rand(1, *KITTI_HW, generator=g))
        valid = (torch.rand(*KITTI_HW, generator=g) > 0.3).float()
        pairs.append((p, t, valid))
    keys = {}
    for where in ("cpu", device):
        m = DepthMetrics()
        for p, t, valid in pairs:
            m.add_sample(p.to(where), t.to(where), valid.to(where))
        keys[str(where)] = m.calc_map()
    card, cpu = keys[str(device)], keys["cpu"]
    rel = max(abs(card[k] - v) / abs(v) for k, v in cpu.items())
    print(f"geometry DepthMetrics: {DEPTH_PAIRS} pairs {KITTI_HW} masked, "
          f"card vs CPU max relative {rel:.2e} (gate 1e-9): {card}")
    if card.keys() != cpu.keys() or rel > 1e-9:
        raise AssertionError(f"DepthMetrics card {card} vs CPU {cpu}")
    return {"max_rel_err": rel, "keys": card}


def readers_step():
    """The golden .flo and .pfm through the port's readers equal their
    expected arrays exactly."""
    import os
    import numpy as np
    from aloception_tpu_torch.aloscene.io.disparity import load_pfm
    from aloception_tpu_torch.aloscene.io.flow import load_flow_flo
    fx = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "fixtures")
    flo = np.moveaxis(load_flow_flo(os.path.join(fx, "golden.flo")).numpy(),
                      0, -1)
    pfm = load_pfm(os.path.join(fx, "golden.pfm")).numpy()
    want_flo = np.load(os.path.join(fx, "golden_flo_expected.npy"))
    want_pfm = np.load(os.path.join(fx, "golden_pfm_expected.npy"))
    ok = np.array_equal(flo, want_flo) and np.array_equal(
        pfm.reshape(want_pfm.shape), want_pfm)
    print(f"geometry readers: golden.flo {flo.shape}, golden.pfm "
          f"{pfm.shape} equal to their expected arrays: {ok}")
    if not ok:
        raise AssertionError("a golden file read differently")
    return ok


def geometry_phase(device):
    """aloscene's 3-D geometry on the card: the IoU parity, a KITTI-sized
    scene's chain, the 3D AP, the pairwise 3D IoU at Waymo scale, the depth
    metrics and the file readers. The path launches neither hand-written
    kernel: both counts are read around it and must stay 0."""
    _reset_counts()
    t0 = time.perf_counter()
    out = {"iou": iou_parity_step(device), "scene": kitti_scene_step(device),
           "ap3d": ap3d_step(device), "pairwise": pairwise_iou_step(device),
           "depth_metrics": depth_metrics_step(device),
           "readers_equal": readers_step()}
    out["kernel_launches"] = dict(zip(("ms_deform_attn", "msda_backward",
                                       "hungarian"), _counts()))
    out["seconds"] = time.perf_counter() - t0
    print(f"geometry phase: {out['seconds']:.1f} s, hand-written kernel "
          f"launches {out['kernel_launches']}")
    if any(out["kernel_launches"].values()):
        raise AssertionError("the geometry path launched a kernel")
    return out


# ----------------------------------------------------------------------
# COCO on disk and the multi-scale recipe
# ----------------------------------------------------------------------
def fixture_images():
    import os
    return sorted(os.path.join(FIXTURE_DIR, n) for n in os.listdir(FIXTURE_DIR)
                  if n.endswith(".jpg") and n != "corrupt.jpg")


def decode_gate():
    """Every fixture decoded by the port's loader on this machine against
    the cv2 decode stored beside it (bit-equal), and the corrupt one
    refused. Returns {file:mode: (max |diff|, differing samples)} and the
    mean ms a decode."""
    import os
    import numpy as np
    from aloception_tpu_torch.aloscene import InvalidSampleError
    from aloception_tpu_torch.runtime import decode
    from aloception_tpu_torch.runtime.loader import load_library
    from aloception_tpu_torch.utils.coco_fixture import read_decodes
    t0 = time.perf_counter()
    load_library()
    build_s = time.perf_counter() - t0
    ref = read_decodes(os.path.join(FIXTURE_DIR, "decodes.npz"))
    out, times = {}, []
    for key, want in sorted(ref.items()):
        name, mode = key.split(":")
        t = time.perf_counter()
        got = decode(os.path.join(FIXTURE_DIR, name), mode).numpy()
        times.append(time.perf_counter() - t)
        got = got.reshape(want.shape).astype(np.int64)
        diff = np.abs(got - want.astype(np.int64))
        out[key] = (int(diff.max()), int((diff > 0).sum()))
        print(f"decode gate {key}: {want.shape} {want.dtype}, max|port-cv2| "
              f"{out[key][0]}, differing samples {out[key][1]}, "
              f"{times[-1] * 1e3:.2f} ms")
    try:
        decode(os.path.join(FIXTURE_DIR, "corrupt.jpg"))
        raise AssertionError("the corrupt fixture decoded")
    except InvalidSampleError as e:
        print(f"decode gate corrupt.jpg: InvalidSampleError ({e})")
    bad = {k: v for k, v in out.items() if v[0]}
    if bad:
        raise AssertionError(f"decodes differ from cv2: {bad}")
    ms = sum(times) / len(times) * 1e3
    print(f"decode gate: {len(out)} decodes bit-equal to cv2's; the loader "
          f"built in {build_s:.1f} s; {ms:.2f} ms a decode")
    return dict(equal=len(out), mean_decode_ms=ms, build_s=build_s)


def bucket_levels(hw):
    """Deformable-DETR-R50's level shapes at a padded (H, W): strides 8, 16,
    32 and the extra stride-2 level."""
    levels = [(-(-hw[0] // s), -(-hw[1] // s)) for s in (8, 16, 32)]
    levels.append((-(-levels[-1][0] // 2), -(-levels[-1][1] // 2)))
    return tuple(levels)


def bucket_msda_inputs(shapes, Lq, dtype, device, seed):
    """MSDA inputs of a padded batch of 2: the second item's locations fall
    inside its valid ratios (BUCKET_VALID), a few past them, as the
    encoder's reference points and offsets put them."""
    value, shapes, loc, w = msda_inputs(shapes, 2, Lq, C, (0.0, 1.0),
                                        torch.float32, device, seed=seed)
    vr = torch.tensor(BUCKET_VALID, device=device).flip(-1)  # (x, y)
    loc = loc * vr.view(2, 1, 1, 1, 1, 2) + 0.05 * (
        torch.rand(loc.shape, device=device, generator=torch.Generator(
            device=device).manual_seed(seed + 1)) - 0.5)
    return value.to(dtype), shapes, loc.to(dtype), w.to(dtype)


def bucket_kernel_gate(device):
    """The MSDA kernel against the plain version at each of the six
    buckets' level shapes, the encoder (Lq = Len_v) and decoder (Lq = 300)
    calls at B = 2, float32 and bfloat16, each launch plan printed; then the
    largest bucket's float32 encoder call timed (CUDA graphs and eager
    launches) beside the plain version and its bound."""
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda
    from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch
    from aloception_tpu_torch.train.data_modules import MULTISCALE_BUCKETS
    errs = {}
    for hw in MULTISCALE_BUCKETS:
        shapes = bucket_levels(hw)
        len_v = sum(h * w for h, w in shapes)
        for site, Lq in (("encoder", len_v), ("decoder", 300)):
            for dtype in (torch.float32, torch.bfloat16):
                args = bucket_msda_inputs(shapes, Lq, dtype, device, seed=7)
                got = ms_deform_attn_cuda(*args)
                torch.cuda.synchronize()
                tag = f"{hw[0]}x{hw[1]} {site}/{str(dtype).split('.')[-1]}"
                err, tol = _gate(got, ms_deform_attn_torch(*args), dtype, tag)
                errs[tag] = err
                print(f"msda bucket {tag}: levels {shapes} Lq={Lq} "
                      f"[{brief(plan_of(*args))}] max|kernel-plain|={err:.3e} "
                      f"(tol {tol:.3e})")
    hw = max(MULTISCALE_BUCKETS, key=lambda b: b[0] * b[1])
    shapes = bucket_levels(hw)
    args = bucket_msda_inputs(shapes, sum(h * w for h, w in shapes),
                              torch.float32, device, seed=8)
    ms = graph_ms(lambda: ms_deform_attn_cuda(*args))
    eager_ms = cuda_ms(lambda: ms_deform_attn_cuda(*args))
    plain_ms = graph_ms(lambda: ms_deform_attn_torch(*args), iters=3, reps=1)
    bound_ms, bound_by, nbytes, fmas, _ = msda_bound(*args)
    print(f"msda largest bucket {hw} encoder B=2 Lq={args[2].shape[1]} fp32 "
          f"[{brief(plan_of(*args))}]: kernel {ms:.4f} ms (graph) "
          f"{eager_ms:.4f} ms (eager), plain {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
          f"{fmas / 1e9:.3f} G FMA), {bound_ms / ms:.1%} of the bound")
    return errs, dict(bucket=list(hw), ms=ms, eager_ms=eager_ms,
                      plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


class _DataTimes:
    """Host seconds of each sample's decode (``getitem``) and transforms
    (``transform_fn``, where the dataset has one), by dataset index,
    recorded from the loader's worker threads; and of each train batch's
    ``prepare_batch`` with its padded size (``hw`` of its inputs), in the
    consumer's thread."""

    def __init__(self, dm, hw=lambda inputs: tuple(inputs[0].shape[1:3])):
        import threading
        self.lock, self.local = threading.Lock(), threading.local()
        self.decode, self.transform, self.batches = {}, {}, []
        ds = dm.train_dataset
        getitem, tfn, prepare = ds.getitem, ds.transform_fn, dm.prepare_batch

        def timed_getitem(idx):
            t = time.perf_counter()
            out = getitem(idx)
            self.local.idx = idx
            with self.lock:
                self.decode[idx] = time.perf_counter() - t
            return out

        def timed_transform(frame, *args):
            t = time.perf_counter()
            out = tfn(frame, *args)
            with self.lock:
                self.transform[self.local.idx] = time.perf_counter() - t
            return out

        def timed_prepare(frames, training=True):
            t = time.perf_counter()
            out = prepare(frames, training)
            if training:
                self.batches.append(dict(
                    seconds=time.perf_counter() - t,
                    hw=hw(out["inputs"]), prepared=out))
            return out
        ds.getitem = timed_getitem
        if tfn is not None:
            ds.transform_fn = timed_transform
        dm.prepare_batch = timed_prepare


def multiscale_train_phase(device, root):
    """``train_on_coco --model deformable --multiscale --batch_size 2
    --max_steps 8`` on the directory (Deformable-DETR-R50-refine, 91
    classes, random weights from the seeded global generator, float32, TF32
    off): per step its bucket, host ms, the workers' host ms to decode and
    transform its frames, the consumer's ms in ``prepare_batch``, peak
    memory, kernel launches and syncs; then device-busy ms and idle share of
    each step's batch from a device-only trace; then ``falling_eval_loss``
    over MULTISCALE_OVERFIT steps on one repeated batch."""
    import numpy as np
    from torch.profiler import ProfilerActivity
    import aloception_tpu_torch.train as train_pkg
    from aloception_tpu_torch.alodataset import base_dataset
    from aloception_tpu_torch.commands import train_on_coco
    from aloception_tpu_torch.train.trainer import to_device

    recorder = make_recorder()
    record_row = recorder.on_train_batch_end

    def on_end(trainer, metrics, step):
        record_row(trainer, metrics, step)
        recorder.rows[-1]["peak"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
    recorder.on_train_batch_end = on_end
    made, factory = {}, train_pkg.make_deformable_detr_trainer

    def instrumented(**kwargs):
        made["times"] = _DataTimes(kwargs["data_module"])
        kwargs["callbacks"] = list(kwargs["callbacks"]) + [recorder]
        trainer = factory(**kwargs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        made["t0"] = time.perf_counter()
        return trainer

    torch.manual_seed(0)
    _reset_counts()
    log_dir = os.path.join(root, "expe")
    with mock.patch.object(train_pkg, "make_deformable_detr_trainer",
                           instrumented), \
            mock.patch.object(base_dataset, "CONFIG_PATH",
                              os.path.join(root, "alodataset_config.json")):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                recorder.caught = caught
                trainer = train_on_coco.main(
                    ["--model", "deformable", "--multiscale", "--batch_size",
                     str(MULTISCALE_BATCH), "--max_steps",
                     str(MULTISCALE_STEPS), "--log_dir", log_dir])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        dm, data = trainer.data_module, made["times"]
        rows = recorder.rows[:MULTISCALE_STEPS]
        if trainer.global_step != MULTISCALE_STEPS or \
                len(data.batches) != MULTISCALE_STEPS:
            raise AssertionError(f"{trainer.global_step} steps")
        # the epoch's batches, in the loader's order (seed 0, epoch 0)
        order = np.arange(len(dm.train_dataset))
        np.random.RandomState(0).shuffle(order)
        steps, prev = [], dict(t=made["t0"], counts=(0, 0, 0), syncs=0)
        for k, row in enumerate(rows):
            idx = order[k * MULTISCALE_BATCH:(k + 1) * MULTISCALE_BATCH]
            counts = tuple(a - b for a, b in zip(row["counts"],
                                                 prev["counts"]))
            step = dict(
                bucket=list(data.batches[k]["hw"]),
                ms=(row["t"] - prev["t"]) * 1e3,
                decode_ms=sum(data.decode[i] for i in idx) * 1e3,
                transform_ms=sum(data.transform[i] for i in idx) * 1e3,
                prepare_ms=data.batches[k]["seconds"] * 1e3,
                peak_gib=row["peak"], msda=counts[0], msda_backward=counts[1],
                hungarian=counts[2], syncs=row["syncs"] - prev["syncs"],
                loss=row["metrics"]["loss_total"])
            if not np.isfinite(step["loss"]):
                raise AssertionError(f"multi-scale step {k}: loss {step}")
            if counts != (MSDA_CALLS_PER_FORWARD, MSDA_CALLS_PER_FORWARD, 1):
                raise AssertionError(f"multi-scale step {k}: (msda, backward, "
                                     f"hungarian) {counts}")
            steps.append(step)
            prev = row
        launches = tuple(sum(s[k] for s in steps)
                         for k in ("msda", "msda_backward", "hungarian"))
        # device-busy and idle share of each step's batch, traced alone
        for step, batch in zip(steps, data.batches):
            inputs = to_device(batch["prepared"]["inputs"], device)
            targets = to_device(batch["prepared"]["targets"], device)
            n_act, busy, window = _device_busy(_trace(
                lambda: trainer.train_step(inputs, targets)[1].cpu(),
                [ProfilerActivity.CUDA], 1))
            step.update(device_busy_ms=busy / 1e3, idle=1 - busy / window,
                        activities=n_act)
        for k, s in enumerate(steps):
            print(f"multi-scale step {k}: bucket {s['bucket']}, "
                  f"{s['ms']:.1f} ms (host clock); workers' host ms to decode "
                  f"{s['decode_ms']:.1f} and transform {s['transform_ms']:.1f}"
                  f", prepare_batch {s['prepare_ms']:.1f} ms; device-busy "
                  f"{s['device_busy_ms']:.1f} ms, idle share "
                  f"{s['idle']:.4f} ({s['activities']} activities); peak "
                  f"{s['peak_gib']:.2f} GiB; msda launches {s['msda']}, "
                  f"backward passes {s['msda_backward']}, hungarian "
                  f"{s['hungarian']}; syncs {s['syncs']}; loss_total "
                  f"{s['loss']:.4f}")
        first = {}
        for s in steps:
            first.setdefault(tuple(s["bucket"]), s["ms"])
        print(f"multi-scale training: {MULTISCALE_STEPS} steps bs"
              f"{MULTISCALE_BATCH}, mean {np.mean([s['ms'] for s in steps]):.1f}"
              f" ms a step; first step at each bucket (ms) {first}; launches "
              f"(msda, backward, hungarian) {launches}")
        # the loss of one repeated batch, in eval mode before and after
        fixed = [dm.train_dataset[i] for i in order[:MULTISCALE_BATCH]]
        recorder.caught = []
        overfit = falling_eval_loss(trainer, recorder, fixed,
                                    MULTISCALE_OVERFIT, device,
                                    "multi-scale, one repeated batch")
    return trainer, dict(steps=steps, launches=launches, overfit=overfit)


def multiscale_eval_phase(root):
    """``eval_on_coco --model deformable --multiscale`` on val2017 (shorter
    side 800, longer at most 1333; random weights): AP, and the loop's
    rate. A batch's time runs from the loop's request for it to its request
    for the next (loader wait, ``prepare_batch``, the model, ``inference``,
    the AP bookkeeping; not the AP tables at the end). The first batch at
    each padded size is warm-up (cuDNN's choice of algorithms, the
    allocator's growth) and is reported alone; images/s is over the
    others."""
    import math
    import numpy as np
    from aloception_tpu_torch.alodataset import base_dataset
    from aloception_tpu_torch.commands import eval_on_coco
    from aloception_tpu_torch.train import CocoDetection2Detr
    requests, waits, prepares, sizes = [], [], [], []
    val_loader, prepare = (CocoDetection2Detr.val_dataloader,
                           CocoDetection2Detr.prepare_batch)

    def timed_loader(self):
        it = iter(val_loader(self))
        while True:
            t = time.perf_counter()
            requests.append(t)
            try:
                batch = next(it)
            except StopIteration:
                return
            waits.append(time.perf_counter() - t)
            yield batch

    def timed_prepare(self, frames, training=True):
        t = time.perf_counter()
        out = prepare(self, frames, training)
        prepares.append(time.perf_counter() - t)
        sizes.append((tuple(out["inputs"][0].shape[1:3]), len(frames)))
        return out

    _reset_counts()
    with mock.patch.object(CocoDetection2Detr, "val_dataloader",
                           timed_loader), \
            mock.patch.object(CocoDetection2Detr, "prepare_batch",
                              timed_prepare), \
            mock.patch.object(base_dataset, "CONFIG_PATH",
                              os.path.join(root, "alodataset_config.json")):
        maps = eval_on_coco.main(["--model", "deformable", "--multiscale",
                                  "--batch_size", str(MULTISCALE_BATCH)])
        torch.cuda.synchronize()
    ap = maps["all"]["all"]
    n_batches = len(sizes)
    batch_s = [b - a for a, b in zip(requests, requests[1:])]
    first_at = {}
    for k, (hw, _) in enumerate(sizes):
        first_at.setdefault(hw, k)
    timed = [k for k in range(n_batches) if k not in first_at.values()]
    out = dict(ap=ap, images=sum(n for _, n in sizes), batches=n_batches,
               images_per_s=sum(sizes[k][1] for k in timed)
               / sum(batch_s[k] for k in timed),
               timed_batches=len(timed), first_batch_ms=batch_s[0] * 1e3,
               first_at_size_ms={f"{h}x{w}": batch_s[k] * 1e3
                                 for (h, w), k in first_at.items()},
               batches_at_size={f"{h}x{w}": sum(1 for s, _ in sizes
                                                if s == (h, w))
                                for h, w in first_at},
               steady_batch_ms=float(np.median([batch_s[k] for k in timed]))
               * 1e3,
               wait_ms=sum(waits) / n_batches * 1e3,
               prepare_ms=sum(prepares) / n_batches * 1e3,
               msda_launches=_counts()[0])
    print(f"eval_on_coco --multiscale on val2017 ({out['images']} images, "
          f"{n_batches} batches of {MULTISCALE_BATCH}): AP {ap:.3f}; "
          f"{out['images_per_s']:.2f} images/s over the {len(timed)} batches "
          f"after the first at each padded size (median "
          f"{out['steady_batch_ms']:.1f} ms a batch); the first batch "
          f"{out['first_batch_ms']:.1f} ms; the first at each size (ms) "
          f"{out['first_at_size_ms']}, batches at each size "
          f"{out['batches_at_size']}; host ms a batch waiting for the loader "
          f"{out['wait_ms']:.1f} and in prepare_batch {out['prepare_ms']:.1f}"
          f", msda launches {out['msda_launches']}")
    if not math.isfinite(ap) or out["images"] != COCO_VAL_IMAGES or \
            out["msda_launches"] != n_batches * MSDA_CALLS_PER_FORWARD:
        raise AssertionError(f"eval_on_coco --multiscale: {out}")
    return out


def from_directory_request(model, device):
    """A folder of the fixtures through ``FromDirectoryDataset`` (the
    corrupt file stepped over) -> resize (shorter side 800, longer at most
    1333) -> ``norm_resnet`` -> ``batch_list`` (padded to its bucket) ->
    Deformable-DETR-R50 on the card -> ``inference``."""
    from aloception_tpu_torch.alodataset import FromDirectoryDataset
    from aloception_tpu_torch.aloscene import batch_list
    from aloception_tpu_torch.alodataset.transforms import \
        RandomResizeWithAspectRatio
    from aloception_tpu_torch.models.deformable_detr import inference
    from aloception_tpu_torch.train.data_modules import pick_bucket
    ds = FromDirectoryDataset(FIXTURE_DIR)
    resize = RandomResizeWithAspectRatio([800], max_size=1333)
    t0 = time.perf_counter()
    frames = [resize(ds[i]).norm_resnet() for i in range(len(ds))]
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    _reset_counts()
    model.eval()
    t0 = time.perf_counter()
    with torch.inference_mode():
        batch = batch_list(frames, size=pick_bucket(max(f.H for f in frames),
                                                    max(f.W for f in frames)))
        batch = batch.to(device)
        out = model(batch.as_layout(("B", "H", "W", "C")),
                    batch.mask.array[:, 0])
        dets = inference(out)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    model.train()
    n = check_detections(dets, len(ds))
    launches = _counts()[0]
    print(f"FromDirectoryDataset request: {len(ds)} files of {FIXTURE_DIR} "
          f"-> bs{len(ds)} {tuple(batch.HW)}, decode and resize on the host "
          f"{host_s * 1e3:.1f} ms, request {latency:.3f} s, detections {n}, "
          f"msda launches {launches}")
    if launches != MSDA_CALLS_PER_FORWARD:
        raise AssertionError(f"{launches} msda launches in one request")
    return dict(frames=len(ds), hw=list(batch.HW), latency_s=latency,
                host_ms=host_s * 1e3, msda_launches=launches)


def coco_disk_phase(device):
    """COCO on disk and the multi-scale recipe on the card: the decode
    gate, the MSDA kernel at the six buckets, a COCO-format directory of the
    fixtures, multi-scale training through ``train_on_coco``,
    ``eval_on_coco --multiscale`` and a ``FromDirectoryDataset`` request."""
    import tempfile
    from aloception_tpu_torch.utils.coco_fixture import build_coco_dir
    t0 = time.perf_counter()
    out = {"decode": decode_gate()}
    out["bucket_errs"], out["largest_bucket"] = bucket_kernel_gate(device)
    with tempfile.TemporaryDirectory() as root:
        build_coco_dir(root, fixture_images(), seed=0,
                       n_train=COCO_TRAIN_IMAGES, n_val=COCO_VAL_IMAGES)
        # the dataset config that names it, as a user's would
        with open(os.path.join(root, "alodataset_config.json"), "w") as f:
            json.dump({"coco": root}, f)
        torch.cuda.empty_cache()
        trainer, out["train"] = multiscale_train_phase(device, root)
        out["from_directory"] = from_directory_request(trainer.model, device)
        del trainer
        torch.cuda.empty_cache()
        out["eval"] = multiscale_eval_phase(root)
    out["seconds"] = time.perf_counter() - t0
    print(f"coco_disk phase: {out['seconds']:.1f} s")
    return out


# ----------------------------------------------------------------------
# The flow, KITTI and Waymo datasets on disk
# ----------------------------------------------------------------------
# FlyingChairs2 at its published 384x512 (60 train and 10 val pairs) and
# the reference's chairs stage (train_standard.sh: bs10); Sintel at its
# 436x1024, 2 scenes x 6 frames of the clean pass; KITTI at 375x1242 with
# the published P_rect_02/P_rect_03; the Waymo front camera at 1280x1920
CHAIRS_PAIRS, CHAIRS_BATCH, CHAIRS_STEPS = (60, 10), 10, 6
CHAIRS_HW = (384, 512)
SINTEL_SCENES, SINTEL_FRAMES = 2, 6
SINTEL_EVAL_PAIRS, SINTEL_CPU_PAIRS = 8, 2
KITTI_SFLOW_FRAMES, KITTI_SFLOW_CPU = 8, 2
KITTI_OBJECT_FRAMES, KITTI_OBJECT_BOXES, KITTI_OBJECT_PRED = 100, 30, 100
KITTI_DEPTH_DRIVES, KITTI_DEPTH_FRAMES = 2, 2
WAYMO_FRAMES, WAYMO_BOXES, WAYMO_HW = 10, 30, (1280, 1920)


def _kernel_counts(tag):
    """The hand-written kernels' counts since ``_reset_counts``; a path that
    launched one raises."""
    counts = dict(zip(("ms_deform_attn", "msda_backward", "hungarian"),
                      _counts()))
    if any(counts.values()):
        raise AssertionError(f"the {tag} path launched a kernel: {counts}")
    return counts


def chairs_train_phase(device, log_dir):
    """``train_on_chairs --batch_size 10 --max_steps 6`` on the FlyingChairs2
    directory the config names (RAFT: hidden 128, 4 levels, radius 4, 12
    iterations, float32, TF32 off, random weights from the seeded global
    generator), its pairs decoded by the loader's 2 worker threads: per
    step host ms, the workers' decode ms of its pairs, the consumer's wait
    for the batch and its ``prepare_batch`` ms, peak memory, syncs and
    kernel counts. The last step runs under a device-only trace, from the
    end of the step before (the batch's wait, ``prepare_batch`` and copy
    included): its device-busy ms and idle share (a trace of a RAFT step
    holds ~200,000 activities, ~30 s of the profiler's processing each, so
    one step is traced). Batches are 384x512: ``Data2RAFT`` takes ``size``
    and does not use it, in both packages."""
    import math
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    import aloception_tpu_torch.train as train_pkg
    from aloception_tpu_torch.commands import train_on_chairs

    recorder = make_recorder()
    record_row = recorder.on_train_batch_end
    traced = profile(activities=[ProfilerActivity.CUDA])

    def on_end(trainer, metrics, step):
        if step == CHAIRS_STEPS:
            torch.cuda.synchronize()
            traced.__exit__(None, None, None)
        record_row(trainer, metrics, step)
        recorder.rows[-1]["peak"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        if step == CHAIRS_STEPS - 1:
            traced.__enter__()
    recorder.on_train_batch_end = on_end
    made, waits, factory = {}, [], train_pkg.make_raft_trainer

    def instrumented(**kwargs):
        dm = kwargs["data_module"]
        made["times"] = _DataTimes(dm, hw=lambda x: tuple(x[0].shape[-2:]))
        loader = dm.train_dataloader

        def timed_loader():
            batches = iter(loader())
            while True:
                t = time.perf_counter()
                try:
                    batch = next(batches)
                except StopIteration:
                    return
                waits.append(time.perf_counter() - t)
                yield batch
        dm.train_dataloader = timed_loader
        kwargs["callbacks"] = list(kwargs["callbacks"]) + [recorder]
        trainer = factory(**kwargs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        made["t0"] = time.perf_counter()
        # the model's build synchronises; the steps count from here
        made["syncs"] = len(_sync_messages(recorder.caught))
        return trainer

    torch.manual_seed(0)
    _reset_counts()
    with mock.patch.object(train_pkg, "make_raft_trainer", instrumented):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                recorder.caught = caught
                trainer = train_on_chairs.main(
                    ["--batch_size", str(CHAIRS_BATCH), "--max_steps",
                     str(CHAIRS_STEPS), "--log_dir", log_dir])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    dm, data = trainer.data_module, made["times"]
    if trainer.global_step != CHAIRS_STEPS or len(data.batches) != \
            CHAIRS_STEPS or len(dm.train_dataset) != CHAIRS_PAIRS[0]:
        raise AssertionError(f"train_on_chairs: {trainer.global_step} steps, "
                             f"{len(dm.train_dataset)} pairs")
    order = np.arange(len(dm.train_dataset))
    np.random.RandomState(0).shuffle(order)      # seed 0, epoch 0
    steps, prev = [], dict(t=made["t0"], counts=(0, 0, 0),
                           syncs=made["syncs"])
    for k, row in enumerate(recorder.rows[:CHAIRS_STEPS]):
        idx = order[k * CHAIRS_BATCH:(k + 1) * CHAIRS_BATCH]
        step = dict(
            hw=list(data.batches[k]["hw"]), ms=(row["t"] - prev["t"]) * 1e3,
            decode_ms=sum(data.decode[i] for i in idx) * 1e3,
            wait_ms=waits[k] * 1e3,
            prepare_ms=data.batches[k]["seconds"] * 1e3,
            peak_gib=row["peak"], syncs=row["syncs"] - prev["syncs"],
            counts=[a - b for a, b in zip(row["counts"], prev["counts"])],
            loss=row["metrics"]["loss_total"], epe=row["metrics"]["epe"])
        if step["hw"] != list(CHAIRS_HW) or step["syncs"] != 1 or \
                any(step["counts"]) or not math.isfinite(step["loss"]):
            raise AssertionError(f"train_on_chairs step {k}: {step}")
        steps.append(step)
        prev = row
    n_act, busy, window = _device_busy(traced)
    last = steps[-1]
    top = sorted(traced.key_averages(),
                 key=lambda a: -_device_us(a, self_only=True))[:6]
    last.update(device_busy_ms=busy / 1e3, idle=1 - busy / window,
                idle_of_step=1 - busy / 1e3 / last["ms"], activities=n_act,
                top_device_ms={a.key[:80]: _device_us(a, self_only=True) / 1e3
                               for a in top})
    for k, s in enumerate(steps):
        trace = "" if "idle" not in s else (
            f"; traced: device-busy {s['device_busy_ms']:.1f} ms, idle "
            f"share {s['idle']:.4f} of the device window and "
            f"{s['idle_of_step']:.4f} of the step ({s['activities']} "
            f"activities); device ms of its largest kernels "
            f"{ {k: round(v, 1) for k, v in s['top_device_ms'].items()} }")
        print(f"train_on_chairs from files, step {k}: {s['hw']}, "
              f"{s['ms']:.1f} ms (host clock); the workers' decode of its "
              f"{CHAIRS_BATCH} pairs {s['decode_ms']:.1f} ms, the consumer's "
              f"wait {s['wait_ms']:.1f} ms, prepare_batch "
              f"{s['prepare_ms']:.1f} ms; peak {s['peak_gib']:.2f} GiB; "
              f"syncs {s['syncs']}; loss_total {s['loss']:.4f}, epe "
              f"{s['epe']:.4f}{trace}")
    timed = steps[1:-1]
    out = dict(steps=steps, val=trainer.last_val_metrics,
               mean_ms=float(np.mean([s["ms"] for s in timed])),
               mean_decode_ms=float(np.mean([s["decode_ms"] for s in timed])),
               mean_wait_ms=float(np.mean([s["wait_ms"] for s in timed])),
               mean_prepare_ms=float(np.mean([s["prepare_ms"]
                                              for s in timed])),
               peak_gib=max(s["peak_gib"] for s in steps))
    print(f"train_on_chairs from files: RAFT fp32 bs{CHAIRS_BATCH} "
          f"{CHAIRS_HW} {RAFT_ITERS} iterations, {CHAIRS_STEPS} steps; "
          f"steps 1-{CHAIRS_STEPS - 2} (untraced): {out['mean_ms']:.1f} ms a "
          f"step (host clock), {CHAIRS_BATCH * 1e3 / out['mean_ms']:.2f} "
          f"pairs/s, decode {out['mean_decode_ms']:.1f} ms of worker time a "
          f"batch, wait {out['mean_wait_ms']:.1f} ms, prepare_batch "
          f"{out['mean_prepare_ms']:.1f} ms; peak {out['peak_gib']:.2f} GiB; "
          f"validation on val {trainer.last_val_metrics}")
    return trainer, out


def sintel_eval_phase(ckpt_dir):
    """``eval_on_sintel --limit_samples 8 --ckpt_dir`` on the Sintel
    directory the config names, on the card: the EPE, pairs/s after the
    first pair (the first pair's end synchronised, the last by the
    command's result), the workers' decode ms a pair and the consumer's
    wait; then the same command over 2 pairs on the card and with
    ``--cpu`` on the same checkpoint, whose EPEs must agree within 1e-3
    relative."""
    import math
    from aloception_tpu_torch.alodataset import SintelFlowDataset
    from aloception_tpu_torch.commands import eval_on_sintel
    decode, waits, marks = [], [], {}
    getitem, stream = SintelFlowDataset.getitem, SintelFlowDataset.stream_loader

    def timed_getitem(self, idx):
        t = time.perf_counter()
        out = getitem(self, idx)
        decode.append(time.perf_counter() - t)
        return out

    def timed_stream(self, num_workers=2):
        pairs = stream(self, num_workers)

        def requests():
            for k in range(len(self)):
                if k == 1:
                    torch.cuda.synchronize()
                    marks["first"] = time.perf_counter()
                t = time.perf_counter()
                frames = next(pairs)
                waits.append(time.perf_counter() - t)
                yield frames
        return requests()

    _reset_counts()
    with mock.patch.object(SintelFlowDataset, "getitem", timed_getitem), \
            mock.patch.object(SintelFlowDataset, "stream_loader",
                              timed_stream):
        t0 = time.perf_counter()
        epe = eval_on_sintel.main(["--limit_samples", str(SINTEL_EVAL_PAIRS),
                                   "--ckpt_dir", ckpt_dir])
        end = time.perf_counter()
    n = min(SINTEL_EVAL_PAIRS, SINTEL_SCENES * (SINTEL_FRAMES - 1))
    out = dict(epe=epe, pairs=n, pairs_per_s=(n - 1) / (end - marks["first"]),
               first_pair_s=marks["first"] - t0,
               decode_ms=sum(decode) / len(decode) * 1e3,
               wait_ms=sum(waits[:n]) / n * 1e3)
    card = eval_on_sintel.main(["--limit_samples", str(SINTEL_CPU_PAIRS),
                                "--ckpt_dir", ckpt_dir])
    t = time.perf_counter()
    cpu = eval_on_sintel.main(["--cpu", "--limit_samples",
                               str(SINTEL_CPU_PAIRS), "--ckpt_dir", ckpt_dir])
    out.update(card_epe_2=card, cpu_epe_2=cpu, rel=abs(card - cpu) / abs(cpu),
               cpu_s_a_pair=(time.perf_counter() - t) / SINTEL_CPU_PAIRS,
               kernel_launches=_kernel_counts("eval_on_sintel"))
    print(f"eval_on_sintel from files ({SINTEL_HW}, clean pass, the chairs "
          f"run's checkpoint): EPE {epe:.4f} over {n} pairs; "
          f"{out['pairs_per_s']:.2f} pairs/s after the first pair (start to "
          f"the first pair's end {out['first_pair_s']:.2f} s, the model's "
          f"build and restore included); the workers' decode "
          f"{out['decode_ms']:.1f} ms a pair, the consumer's wait "
          f"{out['wait_ms']:.1f} ms a pair; over {SINTEL_CPU_PAIRS} pairs card "
          f"EPE {card:.6f}, CPU {cpu:.6f}, relative {out['rel']:.2e} (gate "
          f"1e-3; the CPU {out['cpu_s_a_pair']:.1f} s a pair)")
    if not (math.isfinite(epe) and out["rel"] <= 1e-3):
        raise AssertionError(f"eval_on_sintel from files: {out}")
    return out


def flow_disk_phase(device):
    """FlyingChairs2 and Sintel directories at their published sizes,
    written from seeds (``utils/flow_fixture.py``) into a temporary root
    that the dataset config names; ``train_on_chairs`` and
    ``eval_on_sintel`` from those files. RAFT runs no kernel of the port:
    both counts are read around the path and must stay 0."""
    import tempfile
    from aloception_tpu_torch.alodataset import base_dataset
    from aloception_tpu_torch.utils import flow_fixture as ff
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        chairs = ff.build_chairs2_dir(os.path.join(root, "chairs"), seed=0,
                                      n_train=CHAIRS_PAIRS[0],
                                      n_val=CHAIRS_PAIRS[1], hw=CHAIRS_HW)
        sintel = ff.build_sintel_dir(os.path.join(root, "sintel"), seed=1,
                                     scenes=SINTEL_SCENES,
                                     frames=SINTEL_FRAMES, hw=SINTEL_HW)
        out = {"write_s": time.perf_counter() - t0}
        config = os.path.join(root, "alodataset_config.json")
        with open(config, "w") as f:
            json.dump({"FlyingChairs2": chairs, "Sintel": sintel}, f)
        with mock.patch.object(base_dataset, "CONFIG_PATH", config):
            t = time.perf_counter()
            trainer, out["train"] = chairs_train_phase(
                device, os.path.join(root, "expe"))
            out["train"]["kernel_launches"] = _kernel_counts("train_on_chairs")
            out["train"]["seconds"] = time.perf_counter() - t
            ckpt_dir = trainer.ckpt_dir
            del trainer
            torch.cuda.empty_cache()
            t = time.perf_counter()
            out["eval"] = sintel_eval_phase(ckpt_dir)
            out["eval"]["seconds"] = time.perf_counter() - t
    out["seconds"] = time.perf_counter() - t0
    print(f"flow_disk phase: {out['seconds']:.1f} s (writing the directories "
          f"{out['write_s']:.1f} s, train_on_chairs "
          f"{out['train']['seconds']:.1f} s, eval_on_sintel "
          f"{out['eval']['seconds']:.1f} s), hand-written kernel launches 0")
    return out


def _masked_epe(flow, gt):
    """Mean end-point error over the pixels ``gt``'s occlusion marks valid."""
    valid = 1.0 - gt.get_child("occlusion").array[0]
    err = (flow - gt.array).pow(2).sum(0).sqrt()
    return float((err * valid).sum() / valid.sum())


def kitti_sflow_step(device):
    """``KittiStereoFlowSFlow2015`` (the config's directory, ``load`` all:
    both cameras, the noc/occ disparities at both times, the noc/occ flows)
    -> the left pair through float32 RAFT (12 iterations, ``only_last``,
    ``Padder`` to 376x1248) on the card, the EPE over ``flow_occ``'s valid
    pixels; the first 2 pairs again on the CPU (1e-3 relative)."""
    from aloception_tpu_torch.alodataset import KittiStereoFlowSFlow2015
    from aloception_tpu_torch.models.raft import Padder, raft
    ds = KittiStereoFlowSFlow2015()
    t = time.perf_counter()
    items = [ds[i] for i in range(len(ds))]
    read_ms = (time.perf_counter() - t) / len(items) * 1e3
    for item in items:
        disp = item["left"].get_child("disparity")
        if set(item) != {"left", "right"} or set(disp) != {
                "disp_noc", "disp_occ"} or disp["disp_occ"].shape != (
                2, 1) + KITTI_HW or disp["disp_occ"].baseline is None:
            raise AssertionError("a KITTI scene-flow item lacks a label")
    cpu_model = raft(device="cpu", generator=torch.Generator().manual_seed(130))
    model = copy.deepcopy(cpu_model).to(device)

    def epe_of(m, left, where):
        frames = left.to(where).norm_minmax_sym()
        f1, f2 = (frames[t].as_layout(("C", "H", "W"))[None] for t in (0, 1))
        padder = Padder(f1.shape)
        with torch.inference_mode():
            flow = padder.unpad(m(*padder.pad(f1, f2), iters=RAFT_ITERS,
                                  only_last=True))[0]
        return _masked_epe(flow, frames[0].get_child("flow")["flow_occ"]), \
            tuple(padder.pad(f1)[0].shape[-2:])
    card, ms = [], []
    for item in items:
        torch.cuda.synchronize()
        t = time.perf_counter()
        epe, padded = epe_of(model, item["left"], device)
        ms.append((time.perf_counter() - t) * 1e3)
        card.append(epe)
    cpu = [epe_of(cpu_model, item["left"], "cpu")[0]
           for item in items[:KITTI_SFLOW_CPU]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    print(f"KITTI scene flow 2015 from files: {len(items)} frames "
          f"{KITTI_HW} (read {read_ms:.1f} ms an item: 4 images, 4 "
          f"disparities, 2 flows), baseline "
          f"{items[0]['left'].get_child('disparity')['disp_occ'].baseline:.4f}"
          f" m; RAFT fp32 padded to {padded}: EPE over flow_occ's valid "
          f"pixels {[round(e, 4) for e in card]}, ms a pair on the card "
          f"(host clock, synchronised) {[round(v, 1) for v in ms]}; first "
          f"{KITTI_SFLOW_CPU} on the CPU {[round(e, 4) for e in cpu]}, "
          f"relative {rel:.2e} (gate 1e-3)")
    if rel > 1e-3:
        raise AssertionError(f"KITTI scene flow EPE card {card} vs CPU {cpu}")
    return dict(epe=card, cpu_epe=cpu, rel=rel, ms=ms, read_ms=read_ms,
                padded_hw=list(padded))


def kitti_object_step(device):
    """``KittiObject`` (100 frames, 30 ``label_2`` objects of the 8 classes
    and 2 DontCare a frame, P2) -> its ``BoundingBoxes3D`` as targets, 100
    seeded predictions a frame (jittered copies of the targets, a tenth of
    another class, three tenths moved off), into ``ApMetrics3D`` on the
    card and on the CPU: equal maps; ms per ``add_sample``, beside the same
    metric's on ``ap3d_samples``' synthetic boxes in this run."""
    import aloception_tpu_torch.aloscene as sc
    from aloception_tpu_torch.alodataset import KittiObject
    from aloception_tpu_torch.metrics import ApMetrics3D
    ds = KittiObject()
    t = time.perf_counter()
    frames = [ds[i] for i in range(len(ds))]
    read_ms = (time.perf_counter() - t) / len(frames) * 1e3
    g = torch.Generator().manual_seed(140)
    samples, n_cls = [], len(ds.CLASSES)
    for f in frames:
        gt = f.boxes3d
        if gt.shape != (KITTI_OBJECT_BOXES, 7) or f.HW != KITTI_HW or \
                f.get_child("cam_intrinsic") is None:
            raise AssertionError(f"a KITTI object frame: {gt.shape}, {f.HW}")
        cls = gt.labels.array.long()
        src = torch.randint(0, len(gt), (KITTI_OBJECT_PRED,), generator=g)
        pred = gt.array[src] + torch.randn(KITTI_OBJECT_PRED, 7, generator=g) \
            * torch.tensor([0.4, 0.1, 0.4, 0.1, 0.1, 0.2, 0.2])
        off = torch.rand(KITTI_OBJECT_PRED, generator=g) < 0.3
        pred[off, 0] += 12 * (torch.rand(int(off.sum()), generator=g) - 0.5)
        flip = torch.rand(KITTI_OBJECT_PRED, generator=g) < 0.1
        p_cls = torch.where(flip, (cls[src] + 1) % n_cls, cls[src]).float()
        samples.append((sc.BoundingBoxes3D(pred, labels=sc.Labels(
            p_cls, labels_names=ds.CLASSES,
            scores=torch.rand(KITTI_OBJECT_PRED, generator=g))), gt))
    maps, ms = {}, {}
    synthetic = ap3d_samples(device)
    for where in ("cpu", device, "synthetic"):
        moved = synthetic if where == "synthetic" else \
            [(p.to(where), t.to(where)) for p, t in samples]
        m = ApMetrics3D()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p, t in moved:
            m.add_sample(p, t)
        ms[str(where)] = (time.perf_counter() - t0) / len(moved) * 1e3
        maps[str(where)] = m.calc_map()
    card, cpu = maps[str(device)], maps["cpu"]
    print(f"KITTI object from files: {len(frames)} frames {KITTI_HW} (read "
          f"{read_ms:.1f} ms a frame), {KITTI_OBJECT_PRED} predictions x "
          f"{KITTI_OBJECT_BOXES} targets of {n_cls} classes: ApMetrics3D "
          f"card {card['all']} == CPU {cpu['all']}: {card == cpu}; ms per "
          f"add_sample card {ms[str(device)]:.3f} (on ap3d_samples' "
          f"synthetic boxes {ms['synthetic']:.3f}), CPU {ms['cpu']:.3f}")
    if card != cpu:
        raise AssertionError(f"ApMetrics3D card {card} != CPU {cpu}")
    return dict(map=card["all"], add_sample_ms=ms[str(device)],
                add_sample_ms_synthetic=ms["synthetic"],
                add_sample_ms_cpu=ms["cpu"], read_ms=read_ms)


def kitti_depth_step(device):
    """``KittiDepth`` (2 drives x 2 frames of sparse 16-bit depth / 256)
    -> ``DepthMetrics`` over its lidar pixels (a seeded prediction of 0.7-
    1.4 x the depth), card against CPU (1e-9 relative)."""
    from aloception_tpu_torch.alodataset import KittiDepth
    from aloception_tpu_torch.metrics import DepthMetrics
    ds = KittiDepth()
    depths = [ds[i].depth.array for i in range(len(ds))]
    g = torch.Generator().manual_seed(150)
    pairs = [(d * (0.7 + 0.7 * torch.rand(d.shape, generator=g)), d,
              (d[0] != 0).float()) for d in depths]
    keys = {}
    for where in ("cpu", device):
        m = DepthMetrics()
        for p, t, valid in pairs:
            m.add_sample(p.to(where), t.to(where), valid.to(where))
        keys[str(where)] = m.calc_map()
    card, cpu = keys[str(device)], keys["cpu"]
    rel = max(abs(card[k] - v) / abs(v) for k, v in cpu.items())
    lidar = sum(float(v.mean()) for _, _, v in pairs) / len(pairs)
    print(f"KITTI depth from files: {len(depths)} maps {KITTI_HW}, "
          f"{lidar:.3f} of the pixels with a return; DepthMetrics card vs "
          f"CPU max relative {rel:.2e} (gate 1e-9): {card}")
    if card.keys() != cpu.keys() or rel > 1e-9 or len(depths) != \
            KITTI_DEPTH_DRIVES * KITTI_DEPTH_FRAMES:
        raise AssertionError(f"DepthMetrics card {card} vs CPU {cpu}")
    return dict(max_rel_err=rel, keys=card, lidar_share=lidar)


def waymo_projections(boxes, K, E, hw):
    """The 8 vertices of each box (vehicle frame, aloception axes) in the
    camera frame through ``E`` and projected by ``K``; the boxes'
    ``get_vertices_3d_proj`` and ``get_enclosing_box_2d`` by ``K``."""
    v = boxes.get_vertices_3d()
    cam = v @ E.array[:3, :3].T + E.array[:3, 3]
    k = K.array
    z = cam[..., 2:].clamp(min=1e-6)
    uv = cam[..., :2] / z * k[[0, 1], [0, 1]] + k[[0, 1], [2, 2]]
    return dict(camera_vertices=cam, image_vertices=uv,
                proj=boxes.get_vertices_3d_proj(K),
                enclosing=boxes.get_enclosing_box_2d(K, hw).array)


def waymo_step(device, records, prepared):
    """A Waymo TFRecord (one segment, 10 frames of the front camera at
    1280x1920, 30 laser boxes a frame of which 3 signs, 30 camera boxes, the
    camera's calibration) -> ``WaymoDataset.prepare`` -> T=2 sequences with
    2-D and 3-D boxes -> each frame's ``BoundingBoxes3D``,
    ``CameraIntrinsic`` and ``CameraExtrinsic`` to the card -> the
    projections of ``waymo_projections``, against the CPU's (1e-4 of
    max(1, max|ref|))."""
    from aloception_tpu_torch.alodataset import WaymoDataset
    t = time.perf_counter()
    segments = WaymoDataset.prepare(records, prepared)
    prepare_s = time.perf_counter() - t
    ds = WaymoDataset(labels=("gt_boxes_2d", "gt_boxes_3d"))
    t = time.perf_counter()
    items = [ds[i]["front"] for i in range(len(ds))]
    read_ms = (time.perf_counter() - t) / len(items) * 1e3
    errs, n_boxes, in_front = {}, 0, 0
    for k, f in enumerate(items):
        K, E = f.get_child("cam_intrinsic"), f.get_child("cam_extrinsic")
        for step in range(2):
            boxes = f.boxes3d[step]
            want = waymo_projections(boxes, K[step], E[step], f.HW)
            got = waymo_projections(boxes.to(device), K[step].to(device),
                                    E[step].to(device), f.HW)
            for name, ref in want.items():
                if got[name].device != device:
                    raise AssertionError(f"waymo {name} left the card")
                err = float((got[name].cpu() - ref).abs().max()) / max(
                    1.0, float(ref.abs().max()))
                errs[name] = max(errs.get(name, 0.0), err)
            n_boxes += len(boxes)
            in_front += int((want["camera_vertices"][..., 2] > 0).all(-1)
                            .sum())
    worst = max(errs, key=errs.get)
    print(f"Waymo from a TFRecord: prepare {prepare_s:.2f} s "
          f"({len(segments)} segment, {WAYMO_FRAMES} frames), {len(items)} "
          f"T=2 sequences {items[0].HW} (read {read_ms:.1f} ms a sequence), "
          f"{n_boxes} 3-D boxes ({in_front} wholly in front of the camera); "
          f"projections card vs CPU, worst {worst} {errs[worst]:.2e} of "
          f"max(1, max|ref|) (gate 1e-4)")
    if errs[worst] > 1e-4 or n_boxes != 2 * len(items) * (WAYMO_BOXES - 3):
        raise AssertionError(f"waymo projections: {errs}, {n_boxes} boxes")
    return dict(prepare_s=prepare_s, sequences=len(items), boxes=n_boxes,
                in_front=in_front, read_ms=read_ms, max_rel_err=errs)


def kitti_waymo_disk_phase(device):
    """KITTI scene flow 2015, object and depth directories and a Waymo
    TFRecord, written from seeds into a temporary root that the dataset
    config names, read by the port's datasets into RAFT, ``ApMetrics3D``,
    ``DepthMetrics`` and the 3-D projections on the card, each against the
    CPU. Host readers and torch ops: both kernel counts stay 0."""
    import tempfile
    from aloception_tpu_torch.alodataset import base_dataset
    from aloception_tpu_torch.utils import flow_fixture as ff
    _reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        dirs = {
            "kitti_sflow2015": ff.build_kitti_sflow_dir(
                os.path.join(root, "sflow"), seed=2, n=KITTI_SFLOW_FRAMES,
                hw=KITTI_HW, gaps=False),
            "kitti_object": ff.build_kitti_object_dir(
                os.path.join(root, "object"), seed=3, n=KITTI_OBJECT_FRAMES,
                hw=KITTI_HW, boxes=KITTI_OBJECT_BOXES, gaps=False),
            "kitti_depth": ff.build_kitti_depth_dir(
                os.path.join(root, "depth"), seed=4,
                drives=KITTI_DEPTH_DRIVES, frames=KITTI_DEPTH_FRAMES,
                hw=KITTI_HW, gaps=False),
            "waymo": os.path.join(root, "waymo")}
        records = ff.build_waymo_tfrecord_dir(
            os.path.join(root, "records"), seed=5, frames=WAYMO_FRAMES,
            hw=WAYMO_HW, boxes=WAYMO_BOXES)
        out = {"write_s": time.perf_counter() - t0}
        config = os.path.join(root, "alodataset_config.json")
        with open(config, "w") as f:
            json.dump(dirs, f)
        with mock.patch.object(base_dataset, "CONFIG_PATH", config):
            out["scene_flow"] = kitti_sflow_step(device)
            out["object"] = kitti_object_step(device)
            out["depth"] = kitti_depth_step(device)
            out["waymo"] = waymo_step(device, records,
                                      os.path.join(dirs["waymo"], "train"))
    out["kernel_launches"] = _kernel_counts("KITTI and Waymo")
    out["seconds"] = time.perf_counter() - t0
    print(f"kitti_waymo_disk phase: {out['seconds']:.1f} s (writing the "
          f"directories {out['write_s']:.1f} s), hand-written kernel "
          f"launches 0")
    return out


# ------------------------------------------------ tracking, crowds, views ----
CROWD_TRAIN_HW = ((1600, 2400), (720, 1280)) * 6     # half above 1333
CROWD_VAL_HW = ((1600, 2400), (720, 1280)) * 2
CROWD_BATCH, CROWD_STEPS, CROWD_VAL_BATCHES = 2, 4, 2
MOT_FRAMES, MOT_HW = 8, (1080, 1920)                  # MOT17-02's frames
MOT_GRID_CELL = (540, 960)
WOODSCAPE_HW = (966, 1280)
VIEW_REPEATS = 3


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def crowd_human_module(batch_size, seed=0):
    """A data module in the JAX tutorial 13's pattern: ``CocoDetection2Detr``
    (its multi-scale transforms, buckets and ``prepare_batch``) over
    ``CrowdHumanDataset``'s splits, one class, the directory the config
    names."""
    from aloception_tpu_torch.alodataset import CrowdHumanDataset, Split
    from aloception_tpu_torch.train import CocoDetection2Detr

    class CrowdHuman2Detr(CocoDetection2Detr):
        def __init__(self, **kwargs):
            super().__init__(sample=True, **kwargs)   # builds the transforms

            def tfn(t):
                return lambda frame, g: t.with_generator(g)(frame
                                                            ).norm_resnet()
            self.train_dataset = CrowdHumanDataset(
                split=Split.TRAIN, transform_fn=tfn(self.train_transform),
                transform_seed=self.seed)
            self.val_dataset = CrowdHumanDataset(
                split=Split.VAL, transform_fn=tfn(self.val_transform),
                transform_seed=self.seed)
            self.label_names = list(CrowdHumanDataset.CLASSES)

    return CrowdHuman2Detr(batch_size=batch_size, seed=seed)


def _timed_views(make, repeats=VIEW_REPEATS):
    """(the view, ms a call) of ``make()``, which draws on the host."""
    view = make()
    t0 = time.perf_counter()
    for _ in range(repeats):
        make()
    return view, (time.perf_counter() - t0) / repeats * 1e3


def _same_image(got, want, tag):
    if got.shape != want.shape or not (got == want).all():
        raise AssertionError(f"{tag}: the card's view differs from the "
                             "CPU's")


def crowd_human_train_step(device, root, smi):
    """CrowdHuman -> ``prepare()`` -> Deformable-DETR-R50-refine (1 class,
    float32, random weights) through ``Trainer.fit``, CROWD_STEPS steps of
    CROWD_BATCH at the multi-scale geometry, then one validation pass of
    CROWD_VAL_BATCHES batches with ``ObjectDetectorCallback`` and the
    TensorBoard logger. The logged images read back from the event file
    equal the views drawn on the CPU from the same predictions fetched
    from the card."""
    import math
    import numpy as np
    from torch.profiler import ProfilerActivity
    from aloception_tpu_torch.alodataset import CrowdHumanDataset, Split
    from aloception_tpu_torch.models.deformable_detr import (
        deformable_detr_r50)
    from aloception_tpu_torch.train import (MetricsCallback,
                                            ObjectDetectorCallback,
                                            make_deformable_detr_trainer)
    from aloception_tpu_torch.train.logger import read_events
    from aloception_tpu_torch.train.trainer import to_device

    out = {}
    splits = [CrowdHumanDataset(split=s) for s in (Split.TRAIN, Split.VAL)]
    t = time.perf_counter()
    prepared = [ds.prepare() for ds in splits][0]
    out["prepare_s"] = time.perf_counter() - t
    shapes = set()
    for ds in splits:
        for i in range(len(ds)):
            shapes.add(tuple(ds.getitem(i).HW))
    if max(max(s) for s in shapes) > 1333 or not prepared.endswith(
            "_prepared"):
        raise AssertionError(f"prepare left {shapes} in {prepared}")
    t = time.perf_counter()
    for i in range(len(splits[0])):
        splits[0].getitem(i)
    out["read_image_ms"] = (time.perf_counter() - t) / len(splits[0]) * 1e3

    dm = crowd_human_module(CROWD_BATCH)
    if len(dm.train_dataset) < CROWD_STEPS * CROWD_BATCH or \
            len(dm.val_dataset) < CROWD_VAL_BATCHES * CROWD_BATCH:
        raise AssertionError("the CrowdHuman splits are too short")
    model = deformable_detr_r50(
        num_classes=1, with_box_refine=True, device=device,
        generator=torch.Generator(device=device).manual_seed(0))

    predicted = []

    class Views(ObjectDetectorCallback):
        def on_val_batch_end(self, trainer, outputs, batch, metrics):
            if not self._logged_this_epoch:
                self.frames = batch["frames"]
            super().on_val_batch_end(trainer, outputs, batch, metrics)

    views = Views()
    recorder = make_recorder()
    recorder.caught = []
    trainer = make_deformable_detr_trainer(
        model=model, data_module=dm, log="tensorboard",
        log_dir=os.path.join(root, "expe"), seed=0,
        limit_val_batches=CROWD_VAL_BATCHES,
        callbacks=[recorder, MetricsCallback(), views])
    infer = trainer.inference_fn

    def recording_inference(outputs, **kw):
        boxes = infer(outputs, **kw)
        predicted.append(boxes)
        return boxes
    trainer.inference_fn = recording_inference
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    trainer.fit(dm.train_dataloader(), dm.val_dataloader(), max_epochs=1,
                max_steps=CROWD_STEPS)
    torch.cuda.synchronize()
    msda, backward, hung = _counts()
    out["fit_s"] = time.perf_counter() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    n_val = CROWD_VAL_BATCHES
    want = (MSDA_CALLS_PER_FORWARD * (CROWD_STEPS + n_val),
            MSDA_CALLS_PER_FORWARD * CROWD_STEPS, CROWD_STEPS + n_val)
    if (msda, backward, hung) != want:
        raise AssertionError(f"(msda launches, backward passes, hungarian "
                             f"launches) {(msda, backward, hung)}, not {want}")
    out["launches"] = dict(msda=msda, msda_backward=backward, hungarian=hung)
    losses = [r["metrics"]["loss_total"] for r in recorder.rows]
    val = trainer.last_val_metrics
    if len(losses) != CROWD_STEPS or not all(map(math.isfinite, losses)) \
            or not math.isfinite(val.get("val_loss_total", math.nan)):
        raise AssertionError(f"losses {losses}, validation {val}")
    times = np.diff([t0] + [r["t"] for r in recorder.rows])
    out.update(step_ms=[round(float(dt) * 1e3, 1) for dt in times],
               loss_total=losses, val_loss_total=val["val_loss_total"])

    # the logged images against the views drawn on the CPU
    trainer.logger.flush()
    events = [e for e in read_events(trainer.logger.writer.path)
              if "image" in e]
    frames = views.frames
    if len(predicted) != 1 or len(events) != min(views.max_images,
                                                 frames.shape[0]):
        raise AssertionError(f"{len(events)} logged images, inference run "
                             f"{len(predicted)} times")
    for e in events:
        b = int(e["tag"].rsplit("_", 1)[1])
        frame = frames[b].cpu()
        image = (frame.norm01().as_image(torch.float32) / 255).clamp(0, 1)
        cpu = predicted[0][b].cpu().get_view(frame=image.numpy(),
                                             frame_size=frame.HW).image
        _same_image(e["image"], (cpu * 255.0).astype(np.uint8),
                    f"the logged {e['tag']}")
    out["logged_images"] = [e["tag"] for e in events]

    # device-busy of one step on a training batch
    batch = dm.prepare_batch(next(iter(dm.train_dataloader())))
    inputs = to_device(batch["inputs"], device)
    targets = to_device(batch["targets"], device)

    def step():
        trainer.train_step(inputs, targets)[1].cpu()
    step()
    n_act, busy, window = _device_busy(
        _trace(step, [ProfilerActivity.CUDA], 1))
    out.update(busy_ms=busy / 1e3, idle=1 - busy / window,
               activities=n_act, bucket=list(batch["inputs"][0].shape[1:3]))
    print(f"  CrowdHuman [{smi}]: prepare() {out['prepare_s']:.2f} s "
          f"({len(splits[0])} + {len(splits[1])} images, the long side of "
          f"the larger ones cut to 1333 or less: {sorted(shapes)}), an "
          f"image read in {out['read_image_ms']:.1f} ms; "
          f"Deformable-DETR-R50-refine fp32 bs{CROWD_BATCH} multi-scale: "
          f"step ms {out['step_ms']} (the first with the warm-up), "
          f"device-busy {out['busy_ms']:.1f} ms a step at "
          f"{out['bucket']}, idle {out['idle']:.3f}, peak "
          f"{out['peak_gib']:.2f} GiB; loss_total {losses}, val "
          f"{val['val_loss_total']:.4f}; launches {out['launches']}; "
          f"{len(events)} logged views equal the CPU's")
    return model, out


def mot17_step(model, device, smi):
    """MOT17 T=2 items -> ``norm_resnet`` -> resize (the 800/1333 rule) ->
    the detector (eval mode) -> ``inference``; a Renderer grid of the
    ground-truth and predicted views over T saved as PNG and read back; the
    card's views against the CPU's from the same fetched predictions."""
    import numpy as np
    from aloception_tpu_torch.aloscene.renderer import Renderer, View
    from aloception_tpu_torch.alodataset import Mot17, Split
    from aloception_tpu_torch.models.deformable_detr import inference
    from aloception_tpu_torch.models.deformable_detr import ms_deform_attn \
        as msda_module
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda
    from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch
    from aloception_tpu_torch.runtime import decode

    ds = Mot17(split=Split.TRAIN, sequence_size=2)
    seqs = {seq for seq, _ in ds.items}
    if seqs != {"MOT17-02-FRCNN"} or len(ds) != MOT_FRAMES - 1:
        raise AssertionError(f"detections_set kept {seqs}, {len(ds)} items")
    t = time.perf_counter()
    items = [ds.getitem(i) for i in range(len(ds))]
    read_ms = (time.perf_counter() - t) / len(items) * 1e3
    H, W = items[0].HW
    scale = min(800 / min(H, W), 1333 / max(H, W))
    size = (int(round(H * scale)), int(round(W * scale)))
    # the first encoder (Lq = Len_v) and decoder call's inputs, kept to hold
    # the kernel against the plain version at this path's shapes
    calls, msda = {}, msda_module.ms_deform_attn

    def record(value, shapes, loc, w):
        site = "encoder" if loc.shape[1] == value.shape[1] else "decoder"
        if site not in calls:
            calls[site] = (value.clone(), tuple(tuple(int(s) for s in hw)
                                                for hw in shapes),
                           loc.clone(), w.clone())
        return msda(value, shapes, loc, w)

    model.eval()
    torch.cuda.synchronize()
    _reset_counts()
    t = time.perf_counter()
    preds = []
    with torch.inference_mode(), \
            mock.patch.object(msda_module, "ms_deform_attn", record):
        for item in items:
            f = item.to(device).norm_resnet().resize(size)
            images = f.as_layout(("T", "H", "W", "C")).contiguous()
            mask = torch.zeros(images.shape[:3], device=device)
            preds.append(inference(model(images, mask)))
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t) / len(items) * 1e3
    launches = _counts()[0]
    if launches != MSDA_CALLS_PER_FORWARD * len(items):
        raise AssertionError(f"the MOT17 path launched the MSDA kernel "
                             f"{launches} times")
    if set(calls) != {"encoder", "decoder"}:
        raise AssertionError(f"the MOT17 path's MSDA calls: {set(calls)}")
    errs = {}
    with torch.inference_mode():
        for site, args in calls.items():
            got = ms_deform_attn_cuda(*args)
            torch.cuda.synchronize()
            tag = f"MOT17 {site}/float32"
            err, tol = _gate(got, ms_deform_attn_torch(*args),
                             torch.float32, tag)
            errs[tag] = err
            print(f"msda {tag}: levels {args[1]} B={args[0].shape[0]} "
                  f"Lq={args[2].shape[1]} [{brief(plan_of(*args))}] "
                  f"max|kernel-plain|={err:.3e} (tol {tol:.3e}) on the "
                  "path's own inputs")
    del calls

    def grid(item, pred):
        cells = []
        for t_ in range(item.shape[0]):
            frame = item[t_]
            cells.append(frame.get_view(title=f"gt t={t_}"))
            cells.append(pred[t_].get_view(
                frame=frame.__get_view__().image, title=f"pred t={t_}"))
        return Renderer.get_grid_view(cells, cell_grid_size=MOT_GRID_CELL)
    card_item = items[0].to(device)
    card, grid_ms = _timed_views(lambda: grid(card_item, preds[0]))
    cpu = grid(items[0], [p.cpu() for p in preds[0]])
    _same_image(card, cpu, "the MOT17 grid")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = View(card).save(os.path.join(d, "mot17_grid"))
        _same_image(decode(path).numpy(), (card * 255).astype(np.uint8),
                    "the saved grid")
    n_dets = sum(len(b) for p in preds for b in p)
    print(f"  MOT17 [{smi}]: {len(items)} T=2 items of {H}x{W} (a read "
          f"{read_ms:.1f} ms) -> {size} -> Deformable-DETR eval fp32: "
          f"{forward_ms:.1f} ms an item, {launches} MSDA launches, "
          f"{n_dets} detections; a 2x2 grid of gt and predicted views at "
          f"{MOT_GRID_CELL} {grid_ms:.1f} ms, saved and read back equal")
    return dict(read_item_ms=read_ms, forward_ms=forward_ms,
                msda_launches=launches, grid_ms=grid_ms, detections=n_dets,
                msda_errs=errs)


def woodscape_views_step(device, smi):
    """WoodScape frames (one a camera) -> ``WooDScapeSplitDataset`` with
    boxes and segmentation -> ``Frame.get_view`` of the frame on the card
    against the CPU frame; the 3-D boxes' view of PR 9's KITTI scene
    likewise; ms a view (boxes, masks, 3-D boxes, whole frame)."""
    from aloception_tpu_torch.alodataset import WooDScapeSplitDataset, Split

    ds = WooDScapeSplitDataset(split=Split.TRAIN, labels=["boxes_2d", "seg"])
    t = time.perf_counter()
    frames = [ds.getitem(i) for i in range(len(ds))]
    read_ms = (time.perf_counter() - t) / len(frames) * 1e3
    frame = frames[0]
    card = frame.to(device)
    want = frame.get_view().image
    got, frame_ms = _timed_views(lambda: card.get_view().image)
    _same_image(got, want, "the WoodScape frame view")
    base = frame.__get_view__().image
    boxes, boxes_ms = _timed_views(
        lambda: card.boxes2d.get_view(frame=base).image)
    _same_image(boxes, frame.boxes2d.get_view(frame=base).image,
                "the WoodScape boxes view")
    masks, masks_ms = _timed_views(
        lambda: card.segmentation.__get_view__(frame=base).image)
    _same_image(masks, frame.segmentation.__get_view__(frame=base).image,
                "the WoodScape segmentation view")
    scene = kitti_scene(seed=40)
    img = scene.__get_view__().image
    cam = scene.cam_intrinsic
    card_scene = scene.to(device)
    wire, wire_ms = _timed_views(lambda: card_scene.boxes3d.get_view(
        frame=img, cam_intrinsic=card_scene.cam_intrinsic).image)
    _same_image(wire, scene.boxes3d.get_view(frame=img,
                                             cam_intrinsic=cam).image,
                "the KITTI 3-D boxes view")
    out = dict(read_frame_ms=read_ms, frame_view_ms=frame_ms,
               boxes_view_ms=boxes_ms, masks_view_ms=masks_ms,
               boxes3d_view_ms=wire_ms, frames=len(frames))
    print(f"  WoodScape [{smi}]: {len(frames)} train frames of "
          f"{frame.HW} (a read {read_ms:.1f} ms); views on the card equal "
          f"the CPU's, ms a view: frame with boxes and masks "
          f"{frame_ms:.1f}, boxes {boxes_ms:.1f}, masks {masks_ms:.1f}, "
          f"KITTI 3-D boxes {wire_ms:.1f}")
    return out


def tracking_views_disk_phase(device):
    """CrowdHuman, MOT17 and WoodScape directories at their published sizes,
    written from seeds (``utils/tracking_fixture.py``) into a temporary
    root that the dataset config names: CrowdHuman through ``prepare()``
    into Deformable-DETR-R50-refine training with ``ObjectDetectorCallback``
    (MSDA forward and backward, Hungarian), MOT17 sequences through the
    detector's Frame path (MSDA) and a Renderer grid, WoodScape frames and
    the KITTI scene's 3-D boxes through the views, each view on the card
    against the CPU's."""
    import tempfile
    from aloception_tpu_torch.alodataset import base_dataset
    from aloception_tpu_torch.utils import tracking_fixture as tf
    smi = _smi()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        dirs = {
            "CrowdHuman": tf.build_crowd_human_dir(
                os.path.join(root, "crowd"), seed=6, sizes=CROWD_TRAIN_HW,
                val_sizes=CROWD_VAL_HW, single_last=False),
            "mot17": tf.build_mot17_dir(
                os.path.join(root, "mot17"), seed=7, frames=MOT_FRAMES,
                hw=MOT_HW, sequences=("MOT17-02-FRCNN", "MOT17-02-DPM")),
            "woodscape": tf.build_woodscape_dir(
                os.path.join(root, "woodscape"), seed=8, n=1,
                hw=WOODSCAPE_HW)}
        out = {"write_s": time.perf_counter() - t0}
        config = os.path.join(root, "alodataset_config.json")
        with open(config, "w") as f:
            json.dump(dirs, f)
        with mock.patch.object(base_dataset, "CONFIG_PATH", config):
            model, out["crowd_human"] = crowd_human_train_step(device, root,
                                                               smi)
            out["mot17"] = mot17_step(model, device, smi)
            del model
            torch.cuda.empty_cache()
            out["views"] = woodscape_views_step(device, smi)
    out["seconds"] = time.perf_counter() - t0
    print(f"tracking_views_disk phase [{smi}]: {out['seconds']:.1f} s "
          f"(writing the directories {out['write_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# parallel/: two ranks on the one card over gloo, a world of one on
# NCCL, the 8-rank CPU dry run
# ---------------------------------------------------------------------------
PARALLEL_STEPS = 2
PARALLEL_RAFT_HW = (368, 496)
PARALLEL_DEVICE = "cuda"      # where the ranks of (a) and (b) run
PARALLEL_DIR = "aloception_tpu_torch/_build/parallel"


class _StepRecorder:
    """A Trainer callback: each train batch's metrics and host clock (read
    after the batch's metrics fetch, its one synchronisation)."""

    def __init__(self):
        self.metrics, self.t = [], []

    def on_train_batch_end(self, trainer, metrics, step):
        self.metrics.append(dict(metrics))
        self.t.append(time.perf_counter())

    def on_val_batch_end(self, *a): ...
    def on_val_epoch_end(self, *a): ...
    def on_epoch_end(self, *a): ...


def _gated_criterion(outputs):
    """The Deformable criterion, its float32 outputs kept (detached) in
    ``outputs`` so that the matched queries are read after the counts."""
    from aloception_tpu_torch.models.deformable_detr import (
        deformable_criterion)

    def criterion(out, targets):
        outputs.append((_detach(out), targets))
        return deformable_criterion(out, targets)
    return criterion


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _matched(out, targets):
    from aloception_tpu_torch.models.deformable_detr.criterion import (
        focal_cost_matrix)
    from aloception_tpu_torch.models.detr.matcher import match_outputs
    return torch.stack(match_outputs([out] + out["aux_outputs"], targets,
                                     focal_cost_matrix)).cpu()


class _RowWise(torch.nn.Module):
    """The model's forward row by row (batch 1 each), the outputs stacked
    back: one process's step of the global batch (the criterion's counts
    are the batch's) with the numerics of a bs1 rank's forward. Two
    correct float32 steps part where rounding moves a sampling point
    across a cell border (``train_gate_phase``), and batch 1 and batch 2
    convolutions and GEMMs round differently."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, images, mask):
        return _cat_rows([self.model(images[i:i + 1], mask[i:i + 1])
                          for i in range(images.shape[0])])


def _cat_rows(outs):
    first = outs[0]
    if isinstance(first, dict):
        return {k: _cat_rows([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_cat_rows([o[i] for o in outs])
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor) and first.dim() \
            and first.shape[0] == 1:
        return torch.cat(outs)
    return first


def parallel_deformable_run(device, tag, count_ops=False, rowwise=False,
                            **trainer_kwargs):
    """``gate_setup``'s Deformable-DETR-R50-refine (float32, dropout 0) and
    its batch of 2 at 640 x 640, through ``Trainer.fit`` for PARALLEL_STEPS
    steps on the batch (under a process group: this rank's rows, the mesh
    ``trainer_kwargs`` gives). Returns the steps' metrics and ms, the first
    step's gradients (averaged over the ranks, before the update) and
    matched queries of this rank's rows, the parameters after the steps,
    the kernel counts and plans of the steps, the collectives (DDP's bucket
    all-reduces; with ``count_ops`` every collective op too, which slows
    the steps), the peak GiB, and the kernel held against the plain version
    in float32 on the run's own first call at each launch shape (B, Lq,
    Len_v: the encoder's, at Lq / sp under sequence parallelism, and the
    decoder's). ``rowwise``: the forward row by row (``_RowWise``)."""
    from aloception_tpu_torch.models.deformable_detr import ms_deform_attn \
        as msda_module
    from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda
    from aloception_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch
    from aloception_tpu_torch.parallel import shard_batch
    from aloception_tpu_torch.parallel.dryrun import CollectiveCount
    from aloception_tpu_torch.train import Trainer

    model, images, mask, targets = gate_setup(device)
    if rowwise:
        model = _RowWise(model)
    batch = {"inputs": (images, mask), "targets": targets}
    rec, outputs, grads = _StepRecorder(), [], []
    trainer = Trainer(model, _gated_criterion(outputs),
                      prepare_batch=lambda raw, training=True: batch,
                      callbacks=[rec], log_dir=os.path.join(
                          PARALLEL_DIR, "expe"), project="parallel",
                      expe_name=tag, run_id=tag, **trainer_kwargs)
    step = trainer.optimizer.adamw.step

    def capture(*a, **kw):      # the gradients the first update is given
        if not grads:
            grads.append({n: p.grad.detach().clone() for n, p in
                          trainer.model.named_parameters()
                          if p.grad is not None})
        return step(*a, **kw)

    trainer.optimizer.adamw.step = capture
    collectives = CollectiveCount()
    if isinstance(trainer.forward_model,
                  torch.nn.parallel.DistributedDataParallel):
        collectives.hook(trainer.forward_model)
    calls, msda = {}, msda_module.ms_deform_attn

    def record(value, shapes, loc, w):
        key = (value.shape[0], loc.shape[1], value.shape[1])
        if key not in calls:
            calls[key] = (value.detach().clone(), shapes,
                          loc.detach().clone(), w.detach().clone())
        return msda(value, shapes, loc, w)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ms_deform_attn_cuda.plans = {}
    t0 = time.perf_counter()
    with collectives if count_ops else contextlib.nullcontext(), \
            mock.patch.object(msda_module, "ms_deform_attn", record):
        trainer.fit([None] * PARALLEL_STEPS, max_steps=PARALLEL_STEPS)
    counts, plans = _counts(), dict(ms_deform_attn_cuda.plans)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    msda_errs = {}
    with torch.no_grad():
        for (B, Lq, len_v), args in calls.items():
            got = ms_deform_attn_cuda(*args)
            torch.cuda.synchronize()
            key = f"parallel {tag} B{B} Lq{Lq} Len_v{len_v}/float32"
            msda_errs[key] = _gate(got, ms_deform_attn_torch(*args),
                                   torch.float32, key)[0]
    del calls
    ts = [t0] + rec.t
    head = "model." if rowwise else ""
    full = {n[len(head):]: getattr(g, "full_tensor", lambda: g)()
            for n, g in grads[0].items()}
    state = {n[len(head):]: getattr(v, "full_tensor", lambda: v)()
             for n, v in trainer.model.state_dict().items()}
    return {"metrics": rec.metrics,
            "step_ms": [1e3 * (b - a) for a, b in zip(ts, ts[1:])],
            "grads": {n: g.cpu() for n, g in full.items()},
            "matched": _matched(*outputs[0]),
            "state": {n: v.cpu() for n, v in state.items()},
            "counts": counts, "collectives": dict(collectives.counts),
            "plans": {f"B{k[0]} Lq{k[1]} Len_v{k[2]} {k[3]}": brief(p)
                      for k, p in plans.items()},
            "peak_gib": peak_gib, "msda_errs": msda_errs,
            "rows": int(shard_batch(images, trainer.mesh).shape[0])}


def parallel_raft_run(device, **trainer_kwargs):
    """RAFT (hidden 128, 4 levels, float32, BatchNorm in train mode) one
    step through ``Trainer.fit`` on 2 textured pairs at 368 x 496, 12
    iterations: its metrics and the cnet's running statistics after it."""
    from aloception_tpu_torch.models.raft import raft, raft_sequence_loss
    from aloception_tpu_torch.train import Data2RAFT, Trainer
    from aloception_tpu_torch.train.trainer import to_device

    batch = Data2RAFT(sample=True).prepare_batch(
        [shifted_pairs(2, PARALLEL_RAFT_HW, 100)[i] for i in range(2)])
    batch = {"inputs": to_device(batch["inputs"], device),
             "targets": to_device(batch["targets"], device)}
    model = raft(device="cpu", generator=torch.Generator().manual_seed(101)
                 ).to(device).train()
    rec = _StepRecorder()
    trainer = Trainer(
        model, lambda flows, t: raft_sequence_loss(flows, t["flow"],
                                                   t["valid"]),
        prepare_batch=lambda raw, training=True: batch,
        forward_kwargs={"iters": RAFT_ITERS}, callbacks=[rec],
        log_dir=os.path.join(PARALLEL_DIR, "expe"), project="parallel",
        expe_name="raft", run_id="raft", grad_clip=1.0, **trainer_kwargs)
    _reset_counts()
    trainer.fit([None], max_steps=1)
    return {"metrics": rec.metrics[0], "counts": _counts(),
            "stats": {n: b.detach().cpu() for n, b in
                      trainer.model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}


def _card_rank(rank, n, what):
    """A rank of ``parallel_phase`` (``parallel.dryrun.spawn``): the runs
    ``what`` names, on the card it bound."""
    from aloception_tpu_torch.parallel import make_mesh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device()) \
        if PARALLEL_DEVICE == "cuda" else torch.device(PARALLEL_DEVICE)
    out = {}
    if "ddp" in what:
        out["ddp"] = parallel_deformable_run(device, f"ddp{n}")
        torch.cuda.empty_cache()
    if "sp" in what:
        out["sp"] = parallel_deformable_run(device, "sp", count_ops=True,
                                            mesh=make_mesh(sp=n))
        torch.cuda.empty_cache()
    if "fsdp" in what:
        out["fsdp"] = parallel_deformable_run(device, "fsdp", fsdp=True)
        torch.cuda.empty_cache()

    if "raft" in what:
        out["raft"] = parallel_raft_run(device)
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


# parameters after the steps: the share of elements that may stand beyond
# 1e-5 * max(1, max|p|) of the one-process run's. AdamW moves an element by
# lr * m / (sqrt(v) + 1e-8): where the gradient is within float32 noise of
# 0 (cuDNN's and the MSDA backward's atomics), two runs move it by up to lr
# a step in opposite directions: 664 of the 41.75 M elements for one
# process run twice, 2 for the DDP ranks against row by row, on an H100
# after 2 steps (scripts/parallel_phase.py)
PARALLEL_PARAM_SHARE = 1e-4


def _updated_within(got, want):
    """(count of elements beyond 1e-5 * max(1, max|p|) of ``want``, of all,
    the largest |diff|), over the floating tensors of two state dicts."""
    beyond, worst, total = 0, 0.0, 0
    for n, w in want.items():
        if not w.is_floating_point():
            continue
        gap = (got[n].float() - w.float()).abs()
        tol = 1e-5 * max(1.0, w.abs().max().item())
        beyond += int((gap > tol).sum())
        worst = max(worst, gap.max().item())
        total += w.numel()
    return beyond, total, worst


# the parallel gate's tolerances against one process of the same numerics
# (``_RowWise`` for bs1 ranks, the batched step otherwise): losses 1e-4
# relative, gradients 1e-3 of max|g|, and the tensors that feed the
# sampling locations alone (the sampling offsets, the decoder's
# reference-point projection: a point that rounding moves across a cell
# border changes its location gradient by O(1)) by L2 at 1e-2
PARALLEL_GRAD_TOL, PARALLEL_LOCATION_L2_TOL = 1e-3, 1e-2

LOCATION_TENSORS = ("sampling_offsets", "transformer.reference_points")


def _grad_errors(got, want):
    """(largest max|gap| / max|g| over the tensors that do not feed the
    sampling locations, its tensor; largest ||gap||_2 / ||g||_2 over those
    that do, its tensor)."""
    dense, loc = (0.0, None), (0.0, None)
    for n, w in want.items():
        gap = got[n] - w
        if any(t in n for t in LOCATION_TENSORS):
            e = (gap.norm() / w.norm().clamp(min=1e-30)).item()
            loc = max(loc, (e, n), key=lambda x: x[0])
        else:
            e = (gap.abs().max() / w.abs().max().clamp(min=1e-30)).item()
            dense = max(dense, (e, n), key=lambda x: x[0])
    return dense, loc


def _gate_against(got, want, tag, rows=None, hold=True):
    """A run against a one-process run: the losses of each step to 1e-4
    relative; the first step's gradients by ``_grad_errors`` (1e-3 of
    max|g|, the location tensors by L2 at 1e-2); its matched queries (of
    ``rows`` of the reference) equal; the parameters after the steps within
    1e-5 * max(1, max|p|) but for PARALLEL_PARAM_SHARE of them, and all
    within 2 * lr a step (lr 1e-4, the Trainer's). ``hold`` False: printed
    only."""
    per_step = [max(_rel(got["metrics"][i][k], want["metrics"][i][k])
                    for k in want["metrics"][i])
                for i in range(PARALLEL_STEPS)]
    dense, loc = _grad_errors(got["grads"], want["grads"])
    ref = want["matched"] if rows is None else want["matched"][:, rows]
    same = torch.equal(got["matched"], ref)
    beyond, total, worst = _updated_within(got["state"], want["state"])
    print(f"  {tag}: losses of each step "
          f"{', '.join(f'{e:.3e}' for e in per_step)} (tol 1e-4), "
          f"gradients {dense[0]:.3e} of max|g| (tol {PARALLEL_GRAD_TOL:.0e};"
          f" {dense[1]}), the location tensors {loc[0]:.3e} of L2 (tol "
          f"{PARALLEL_LOCATION_L2_TOL:.0e}; {loc[1]}), matched queries "
          f"equal: {same}; parameters after {PARALLEL_STEPS} steps: {beyond}"
          f" of {total} beyond 1e-5 * max(1, max|p|) (share "
          f"{beyond / total:.2e}, tol {PARALLEL_PARAM_SHARE:.0e}), max|diff| "
          f"{worst:.3e} (tol {2e-4 * PARALLEL_STEPS:.0e})"
          f"{'' if hold else '; printed, not held'}")
    if hold and not (max(per_step) <= 1e-4 and same
                     and dense[0] <= PARALLEL_GRAD_TOL
                     and loc[0] <= PARALLEL_LOCATION_L2_TOL
                     and beyond <= PARALLEL_PARAM_SHARE * total
                     and worst <= 2e-4 * PARALLEL_STEPS):
        raise AssertionError(f"{tag} disagrees with the one-process step")
    return dict(loss_err=max(per_step), grad_err=dense[0],
                location_l2_err=loc[0], params_beyond=beyond,
                params_share=beyond / total, params_max_diff=worst)


def parallel_phase(device):
    """parallel/ on the card: (a) two ranks on the one H100 over gloo with
    CUDA tensors: Deformable-DETR-R50-refine at full width (float32, TF32
    off, dropout 0), 2 DDP ``Trainer.fit`` steps of bs1 a rank through
    ``init_multihost``, then one sequence-parallel (sp 2) run of both rows,
    whose MSDA kernel runs at Lq / 2 encoder queries, and RAFT (hidden 128,
    4 levels) one DDP step of bs1 a rank at 368 x 496, each against one
    process stepping the global bs2 batch; (b) a world of one on NCCL: the
    same Deformable steps under a mesh of one (DDP) and under FSDP against
    the unwrapped steps; (c) ``parallel.dryrun`` on 8 CPU gloo ranks at tiny
    widths (FSDP, TP, SP and PP, with the checks that the sharding is real).
    Prints the step ms, peak GiB and kernel counts of each; returns what the
    JSON line carries."""
    from aloception_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    one = parallel_deformable_run(device, "one")
    # the same step again: what two runs of one process part by (cuDNN's
    # and the MSDA backward's atomics sum in a run's own order)
    again = parallel_deformable_run(device, "again")
    out_floor = _gate_against(again, one, "one process twice", hold=False)
    rows = parallel_deformable_run(device, "rows", rowwise=True)
    one_raft = parallel_raft_run(device)
    torch.cuda.empty_cache()
    print(f"parallel: one process, Deformable-DETR-R50-refine fp32 bs2 "
          f"{TRAIN_SIZE}: step ms {[round(t, 1) for t in one['step_ms']]}, "
          f"peak {one['peak_gib']:.2f} GiB, counts (msda launches, backward "
          f"passes, hungarian) {one['counts']}")

    t0 = time.perf_counter()
    # the ranks prepare the batch on the host with this process's threads:
    # a CPU reduction in other threads rounds otherwise, and the steps part
    # by that alone (2.8e-5 of the loss, 7e-3 of a gradient, on an H100)
    threads = torch.get_num_threads()
    ranks = dryrun.spawn(2, _card_rank, ("ddp", "sp", "raft"), timeout=400,
                         device=PARALLEL_DEVICE, backend="gloo",
                         threads=threads)
    a_s = time.perf_counter() - t0
    print(f"parallel (a): 2 ranks on one card over gloo, {a_s:.1f} s")
    out = {"a_seconds": a_s, "floor": out_floor}
    for tag in ("ddp", "sp"):
        for r, res in enumerate(ranks):
            got = res[tag]
            print(f"  {tag} rank {r}: {got['rows']} rows, step ms "
                  f"{[round(t, 1) for t in got['step_ms']]}, peak "
                  f"{got['peak_gib']:.2f} GiB, counts {got['counts']}, "
                  f"collectives {got['collectives']}, msda plans "
                  f"{got['plans']}")
            if got["counts"][0] != MSDA_CALLS_PER_FORWARD * PARALLEL_STEPS \
                    or got["counts"][2] != PARALLEL_STEPS:
                raise AssertionError(f"{tag} rank {r}: kernel counts "
                                     f"{got['counts']}")
            if tag == "ddp":
                # against one process of the ranks' bs1 numerics, held;
                # against the batched bs2 step, printed
                out[f"ddp_gate_rank{r}"] = _gate_against(
                    got, rows, f"ddp rank {r} vs row by row", rows=[r])
                out[f"ddp_batched_rank{r}"] = _gate_against(
                    got, one, f"ddp rank {r} vs batched", rows=[r],
                    hold=False)
            else:
                out[f"sp_gate_rank{r}"] = _gate_against(
                    got, one, f"sp rank {r} vs batched")
        # the ranks' parameters after the steps: one model, bit for bit
        r0, r1 = (res[tag]["state"] for res in ranks)
        if any(not torch.equal(r0[k], r1[k]) for k in r0):
            raise AssertionError(f"{tag}: the ranks' parameters differ")
        out[f"{tag}_step_ms"] = [res[tag]["step_ms"] for res in ranks]
        out[f"{tag}_collectives"] = ranks[0][tag]["collectives"]
        out[f"{tag}_peak_gib"] = [res[tag]["peak_gib"] for res in ranks]
    sp_plans = ranks[0]["sp"]["plans"]
    # the encoder's calls: Lq = Len_v; under sp 2 each rank's Lq is half
    enc = max(int(k.split()[1][2:]) for k in one["plans"]
              if k.split()[1][2:] == k.split()[2][5:])
    if not any(f"Lq{-(-enc // 2)} Len_v{enc} " in k for k in sp_plans):
        raise AssertionError(f"sp: no MSDA launch at Lq {enc} / 2: "
                             f"{sp_plans}")
    out["sp_plans"] = sp_plans
    # the kernel against the plain version on each run's own inputs (the
    # largest error over the ranks)
    msda_errs = {}
    for res in [one, again, rows] + [r[t] for r in ranks
                                     for t in ("ddp", "sp")]:
        for k, v in res["msda_errs"].items():
            msda_errs[k] = max(v, msda_errs.get(k, 0.0))
    if not any(k.startswith("parallel sp ")
               and f" Lq{-(-enc // 2)} Len_v{enc}/" in k for k in msda_errs):
        raise AssertionError(f"sp: the Lq {enc} / 2 call was not held "
                             f"against the plain version: {msda_errs}")
    stats_err = max((res["raft"]["stats"][n] - w).abs().max().item()
                    for res in ranks for n, w in one_raft["stats"].items())
    raft_loss = max(_rel(res["raft"]["metrics"][k], w) for res in ranks
                    for k, w in one_raft["metrics"].items())
    print(f"  raft ddp: metrics {raft_loss:.3e} (tol 1e-4), cnet running "
          f"statistics max|diff| {stats_err:.3e} (tol 1e-5) over "
          f"{len(one_raft['stats'])} buffers")
    if not (stats_err <= 1e-5 and raft_loss <= 1e-4):
        raise AssertionError("raft ddp disagrees with the global batch")
    out.update(raft_stats_err=stats_err, raft_loss_err=raft_loss)

    t0 = time.perf_counter()
    world1, = dryrun.spawn(1, _card_rank, ("ddp", "fsdp"), timeout=300,
                           device=PARALLEL_DEVICE, threads=threads)
    b_s = time.perf_counter() - t0
    print(f"parallel (b): a world of one on NCCL, {b_s:.1f} s; unwrapped "
          f"step ms {[round(t, 1) for t in one['step_ms']]}")
    for tag in ("ddp", "fsdp"):
        got = world1[tag]
        print(f"  {tag}: step ms {[round(t, 1) for t in got['step_ms']]}, "
              f"peak {got['peak_gib']:.2f} GiB, counts {got['counts']}, "
              f"collectives {got['collectives']}")
        if got["counts"][0] != MSDA_CALLS_PER_FORWARD * PARALLEL_STEPS:
            raise AssertionError(f"world of one {tag}: counts "
                                 f"{got['counts']}")
        out[f"world1_{tag}_gate"] = _gate_against(got, one,
                                                  f"world of one {tag}")
        out[f"world1_{tag}_step_ms"] = got["step_ms"]
        msda_errs.update(got["msda_errs"])
    for k, v in msda_errs.items():
        print(f"  msda {k}: max|kernel-plain|={v:.3e} (tol 1e-05) on the "
              "run's own inputs")
    out["msda_errs"] = msda_errs
    out["unwrapped_step_ms"] = one["step_ms"]
    out["b_seconds"] = b_s

    print("parallel (c): parallel.dryrun on 8 CPU gloo ranks at tiny widths "
          "(FSDP, TP and SP over gloo and the pipeline, checked as the JAX "
          "dry run checks them; the card's gloo is left to (a))")
    t0 = time.perf_counter()
    lines = dryrun.dryrun(8)
    for line in lines:
        print(f"  {line}")
    out["c_seconds"] = time.perf_counter() - t0
    out["dryrun"] = lines
    launches = {"parallel_ddp": sum(r["ddp"]["counts"][0] for r in ranks),
                "parallel_sp": sum(r["sp"]["counts"][0] for r in ranks),
                "parallel_world1_ddp": world1["ddp"]["counts"][0],
                "parallel_world1_fsdp": world1["fsdp"]["counts"][0]}
    backward = {"parallel_ddp": sum(r["ddp"]["counts"][1] for r in ranks),
                "parallel_sp": sum(r["sp"]["counts"][1] for r in ranks),
                "parallel_world1_ddp": world1["ddp"]["counts"][1],
                "parallel_world1_fsdp": world1["fsdp"]["counts"][1]}
    hung = {"parallel_ddp": sum(r["ddp"]["counts"][2] for r in ranks),
            "parallel_sp": sum(r["sp"]["counts"][2] for r in ranks),
            "parallel_world1_ddp": world1["ddp"]["counts"][2],
            "parallel_world1_fsdp": world1["fsdp"]["counts"][2]}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"parallel phase {out['seconds']:.1f} s; msda launches {launches}, "
          f"backward passes {backward}, hungarian {hung}; {_smi()}")
    return out, launches, backward, hung


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is False")
    from aloception_tpu_torch.ops.cuda.build import build_log, load_library

    print(_smi())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    # one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(load_library, KERNEL_SOURCES))
    print(f"built {', '.join(n + '.cu' for n in KERNEL_SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in build_log("hungarian").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  hungarian ptxas: {line.strip()}")
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
    hung, hung_diff = hungarian_phase(device)
    gate = train_gate_phase(device)
    train = train_phase(device)
    torch.cuda.empty_cache()
    detr_train = detr_train_phase(device)
    torch.cuda.empty_cache()
    raft_errs = raft_parity_phase(device)
    raft_model, raft_serve = raft_serving_phase(device)
    raft_frame = raft_frame_phase(raft_model, device)
    del raft_model
    raft_epe = raft_eval_phase()
    torch.cuda.empty_cache()
    panoptic = dict(parity=panoptic_parity_phase(device),
                    gate=panoptic_gate_phase(device))
    torch.cuda.empty_cache()
    for name in PANOPTIC_BATCH:
        model, serve = panoptic_serving_phase(name, device)
        serve["frame"] = panoptic_frame_phase(name, model, device)
        panoptic[name] = serve
        del model
        torch.cuda.empty_cache()
    panoptic["eval"] = panoptic_eval_phase()
    torch.cuda.empty_cache()
    panoptic_train = dict(gate=panoptic_train_gate_phase(device))
    torch.cuda.empty_cache()
    for name in PANOPTIC_BATCH:
        panoptic_train[name] = panoptic_train_phase(name, device)
        torch.cuda.empty_cache()
    raft_train = dict(gate=raft_train_gate_phase(device))
    raft_train.update(raft_train_phase(device))
    torch.cuda.empty_cache()
    commands = train_commands_phase()
    torch.cuda.empty_cache()
    bf16 = bf16_train_phase(device, dict(deformable=train, raft=raft_train))
    bf16_msda = {"bf16_train": bf16["deformable"]["launches"][0],
                 "bf16_train_command": sum(
                     c["msda_launches"] for c in bf16["commands"].values())}
    bf16_backward = {"bf16_train": bf16["deformable"]["launches"][1],
                     "bf16_train_command": sum(
                         c["backward_passes"]
                         for c in bf16["commands"].values())}
    bf16_hung = {"bf16_train": bf16["deformable"]["launches"][2]
                 + bf16["detr"]["launches"][2],
                 "bf16_train_command": sum(
                     c["hungarian_launches"]
                     for c in bf16["commands"].values())}
    torch.cuda.empty_cache()
    export = export_phase(device)
    export["tiny"] = tiny_export_phase(device)
    export["quantization"] = quantization_phase(device)
    torch.cuda.empty_cache()
    geometry = geometry_phase(device)
    torch.cuda.empty_cache()
    coco = coco_disk_phase(device)
    torch.cuda.empty_cache()
    flow_disk = flow_disk_phase(device)
    torch.cuda.empty_cache()
    kitti_waymo = kitti_waymo_disk_phase(device)
    torch.cuda.empty_cache()
    tracking = tracking_views_disk_phase(device)
    crowd = tracking["crowd_human"]["launches"]
    tracking_msda = {"crowd_human_train": crowd["msda"],
                     "mot17_frame": tracking["mot17"]["msda_launches"]}
    torch.cuda.empty_cache()
    parallel, par_msda, par_backward, par_hung = parallel_phase(device)
    ms_train = coco["train"]["launches"]
    coco_msda = {"multiscale_train": ms_train[0],
                 "multiscale_eval": coco["eval"]["msda_launches"],
                 "from_directory": coco["from_directory"]["msda_launches"]}
    export_msda = export["deformable"]["request_msda_launches"] \
        + export["deformable"]["bytes_request"]["msda_launches"]
    pan_train = panoptic_train["deformable_detr_r50_panoptic"]
    pan_msda = {
        "panoptic_forward":
            panoptic["deformable_detr_r50_panoptic"]["msda_launches"],
        "panoptic_frame": panoptic["deformable_detr_r50_panoptic"]["frame"][
            "msda_launches"],
        "panoptic_eval": panoptic["eval"]["panoptic_deformable"][
            "msda_launches"],
        "panoptic_train": pan_train["launches"],
        "panoptic_train_command": commands["msda_launches"]}
    hung_pan = sum(panoptic_train[n]["hungarian_launches"]
                   for n in PANOPTIC_BATCH)

    enc, dec = sites["encoder"], sites["decoder"]
    msda_train, msda_backward, hung_train = train["launches"]
    hung_full = hung[HUNGARIAN_HEADLINE]
    print(json.dumps({"kernels": [{
        "name": "ms_deform_attn",
        "route": "cuda",
        "source": "aloception_tpu_torch/csrc/ms_deform_attn.cu",
        "replaces": "aloception_tpu/ops/pallas/ms_deform_attn_kernel.py:245",
        "launches": launches + frame_launches + msda_train
        + sum(pan_msda.values()) + export_msda + sum(coco_msda.values())
        + sum(bf16_msda.values()) + sum(tracking_msda.values())
        + sum(par_msda.values()),
        "launches_by_path": {"fused_preprocess": launches,
                             "frame": frame_launches,
                             "train": msda_train, **pan_msda,
                             # the AOTInductor package's requests
                             "export": export_msda, **coco_msda,
                             **bf16_msda, **tracking_msda,
                             # summed over the ranks of each run
                             **par_msda},
        # the training path's backward: the gradient of the plain version,
        # recomputed by the operator's registered backward; the panoptic paths'
        # detector is frozen and takes none
        "backward_passes": msda_backward + pan_train["backward_passes"]
        + commands["backward_passes"] + ms_train[1]
        + sum(bf16_backward.values()) + crowd["msda_backward"]
        + sum(par_backward.values()),
        "backward_passes_by_path": {
            "train": msda_backward,
            "panoptic_train": pan_train["backward_passes"],
            "panoptic_train_command": commands["backward_passes"],
            "multiscale_train": ms_train[1], **bf16_backward,
            "crowd_human_train": crowd["msda_backward"], **par_backward},
        "max_abs_err": max(v for k, v in {
            **errs, **coco["bucket_errs"],
            **tracking["mot17"]["msda_errs"],
            **parallel["msda_errs"]}.items() if "float32" in k),
        "max_abs_err_bf16": max(v for k, v in {**errs, **coco["bucket_errs"]
                                               }.items() if "bfloat16" in k),
        # the largest multi-scale bucket's fp32 encoder call
        "largest_bucket": coco["largest_bucket"],
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
        "train_gate": gate,
        # the bf16 instance at the bf16 train step's first encoder call, and
        # the bf16 step's gate (kernel forward vs plain forward)
        "bf16_train": bf16["deformable"]["msda"],
        "bf16_train_gate": bf16["gate"],
    }, {
        "name": "hungarian",
        "route": "cuda",
        "source": "aloception_tpu_torch/csrc/hungarian.cu",
        # the JAX package's on-device JV (XLA loops, not a Pallas kernel)
        "replaces": "aloception_tpu/ops/hungarian.py:28",
        "launches": hung_train + detr_train["launches"] + hung_pan
        + ms_train[2] + sum(bf16_hung.values()) + crowd["hungarian"]
        + sum(par_hung.values()),
        "launches_by_path": {"train": hung_train,
                             "detr_train": detr_train["launches"],
                             "panoptic_train": hung_pan,
                             "multiscale_train": ms_train[2], **bf16_hung,
                             "crowd_human_train": crowd["hungarian"],
                             **par_hung},
        # the largest query-index difference from the plain version's
        # assignment, and the targets matched differently, as measured
        "max_abs_err": hung_diff["max_abs_err"],
        "mismatched_targets": hung_diff["mismatched"],
        "ms": hung_full["ms"], "ms_eager": hung_full["eager_ms"],
        "plain_ms": hung_full["plain_ms"],
        "bound_ms": hung_full["bound_ms"], "bound_by": hung_full["bound_by"],
        # no PyTorch call solves an assignment
        "library_ms": None,
        "timed": {hungarian_tag(k): v for k, v in hung.items()},
    }], "train": {"deformable_step_ms": train["step_ms"],
                  "deformable_frames_ms": train["frames_ms"],
                  "detr_frames_ms": detr_train["frames_ms"],
                  "deformable_peak_gib": train["peak_gib"],
                  "deformable_profile": train["profile"],
                  "detr_step_ms": detr_train["step_ms"],
                  "panoptic": panoptic_train, "raft": raft_train,
                  "commands": commands, "bf16": bf16},
        # RAFT runs no kernel of the port: cuDNN, cuBLAS and PyTorch ops
        "raft": {"parity": raft_errs,
                 "regions": raft_serve.pop("regions"), **raft_serve,
                 "frame_latency_s": raft_frame["latency_s"],
                 "frame_syncs": raft_frame["syncs"],
                 "eval_sintel_sample_epe": raft_epe},
        # the panoptic head runs no kernel of the port; its Deformable
        # detector runs the MSDA kernel (launches above)
        "panoptic": panoptic,
        # AOTInductor packages: the Deformable one calls the MSDA operator
        "export": export,
        # aloscene's 3-D geometry, the 3D AP and the depth metrics: torch
        # ops, no kernel of the port
        "geometry": geometry,
        # COCO on disk: the decode gate, multi-scale training and eval, the
        # FromDirectoryDataset request (the kernel entries carry launches)
        "coco_disk": {k: v for k, v in coco.items() if k != "bucket_errs"},
        # the flow, KITTI and Waymo datasets on disk: no kernel of the port
        # (both counts read around each path and 0)
        "flow_disk": flow_disk, "kitti_waymo_disk": kitti_waymo,
        # MOT17, CrowdHuman and WoodScape on disk, the views and the
        # renderer: the CrowdHuman training and the MOT17 Frame path run
        # the MSDA (and Hungarian) kernels, counted above
        "tracking_views_disk": tracking,
        # parallel/: two ranks on the card over gloo (DDP, sequence
        # parallel: the sp plans are the MSDA launches at Lq / 2), a world
        # of one on NCCL (DDP, FSDP), the 8-rank CPU dry run
        "parallel": parallel}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
