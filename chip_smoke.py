#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``uavdet_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc`` (CUDA_HOME), and imports neither JAX
nor PyYAML. The phases, in order:

  0. the card: name and power limit (nvidia-smi); TF32 off, so that the
     plain versions' f32 convolutions stay f32;
  1. builds the eight CUDA kernels from ``uavdet_tpu_torch/csrc`` (nvcc,
     sm_90a, one nvcc per source, all at once), and beside them the nvJPEG
     library of the data path (``csrc/io/jpeg.cu``);
  2. kernel A (stem L1) against its plain version, on uint8 frames
     (16, 640, 640, 3), on bf16 frames of an odd shape, and on uint8 and
     bf16 frames at the shapes of ``ops.stem.L1_EDGE_SHAPES`` (sizes that
     straddle its 16 x 64 block tile and a warp's 16-pixel fragment):
     output and channel sums, and two launches' sums bitwise equal;
  3. kernel B (stem L2) against its plain version at (16, 640, 640, 32) and
     at the shapes of ``ops.stem.L2_EDGE_SHAPES`` (odd H and W, sizes that
     straddle its 16 x 16 output tile);
  4. the NMS kernel against its plain version at (16, 512) boxes with
     duplicates, equal scores, zero-area boxes and -inf padding, and at the
     cases of ``ops.nms.NMS_EDGE_CASES`` (1 to 4096 boxes, sizes off the
     64-rank mask word and the 8 blocks of a cluster, the path with the mask
     in device memory past 1024 boxes, all boxes identical, no two
     overlapping): bitwise;
  5. kernel D (dyconv) against its plain version: the shapes of
     ``ops.dyconv.EDGE_SHAPES`` (sizes that straddle its 16 x 16 pixel
     tile, its chunks of 16 input channels and its N tiles of 64 and 128
     output channels; ``fold_out`` where H is even), then the inputs the
     three SOEM sites of full-width DySOEM_SimFPN get from a batch of 32
     1280 px frames: the first 4 images of each with and without
     ``emit_gap`` and, at the first site, ``fold_out``; then the launch
     over all 32 images as the main path makes it, held against the plain
     version 4 images at a time (the plain version's f32 copies bound its
     batch). Everywhere ``emit_gap`` leaves the output bitwise as it is,
     and a second run gives bitwise the same output and sums;
  5e. kernel E (the fused stem) against its plain version, and bitwise
     against kernel B of kernel A's output (it runs kernel A's first layer
     and kernel B's tile code), on the uint8 frames (16, 640, 640, 3) and
     on bf16 frames of an odd shape; then its path, the public op, 3 calls;
  5f. kernel F (kernel B's stage ladder): the ``full`` stage bitwise equal
     to kernel B's output; then its path, the ladder's command-line entry
     ``uavdet_tpu_torch.scripts.l2_ablate``, which prints every stage's
     time;
  5g. kernel G (the fused post-stem block) against its plain version at
     (16, 320, 320, 64) with the weights folded from the full-width DyYOLO
     (packed once, and as the (O, K + 1) matrices: bitwise the same), at an
     odd shape, at the shapes of ``ops.block.BLOCK_EDGE_SHAPES`` (sizes off
     its 8 x 8 output tile, one pixel, H = 2, W = 1, a part-full last round
     of its persistent grid, odd batches), and on a small input with large
     biases, where every output depends on the zero padding of the two
     inner activations; each twice, bitwise equal; then its path,
     ``uavdet_tpu_torch.scripts.block_ablate``;
  5n. the group_norm1 kernel (RTMUAVDet's GroupNorm(1) in inference)
     against its plain version in bf16 and a float64 GroupNorm in float32
     at ``ops.group_norm.GN1_EDGE_SHAPES`` (H W off a multiple of 8, a
     sample under one chunk, B = 1, C = 1, a map whose mean is 1e3 times its
     spread), and in bf16 at RTMUAVDet's served maps (8, 192, 160, 160) and
     (8, 384, 80, 80); each twice, bitwise;
  5o. the bn_act kernel (the conv blocks' epilogue in inference: BatchNorm
     from its running statistics, LeakyReLU or SiLU, the residual) against
     its plain version at ``ops.bn_act.BN_ACT_EDGE_SHAPES`` in both layouts,
     both activations, with and without a residual, the BatchNorm's vectors
     bf16 and float32, and at the served maps ``BN_ACT_SERVED``; bitwise
     with LeakyReLU, within one bf16 unit with SiLU; each twice, bitwise;
  6. main path 1: full-width DyYOLO (conf/model/dy-yolo.yaml widths), bf16,
     seeded random weights, answers 3 requests of 16 uint8 640x640 frames
     through ``make_detector``; checks the results and the launch counts
     (stem kernels and NMS once per request, dyconv never); then runs the
     same batch with the plain versions in place of the kernels and
     compares;
  7. main path 2: full-width DySOEM_SimFPN (conf/model/dy-soem_fpn.yaml),
     bf16, seeded random weights, answers 3 requests of 32 uint8 1280x1280
     frames through ``make_detector``; checks the results and the launch
     counts (dyconv three times and NMS once per request, the stem kernels
     never); then runs the first 8 frames with the plain versions in place
     of the kernels and compares;
  7b. main path 3: full-width BaselineModel (conf/model/baseline.yaml),
     bf16, seeded random weights, answers 3 requests of 1 uint8 640x640
     frame (NMS once per request, no other kernel); compared with the plain
     path;
  7c. main path 4: the dual-stream detector on full-width DyYOLO: 3
     requests of 8 RGB (1080x1920) + 8 infrared (512x640) uint8 frames
     through ``make_detector(..., dual=True)`` (stem kernels and NMS once
     per request); compared with the plain path;
  7d. DyYOLO with ``pre_nms_topk=4096`` (3 requests of 16 frames; the NMS
     kernel's path with the mask in device memory), compared with the
     plain path;
  7e. DySOEM_SimFPN in float32 (batch 2, 256 px, eval mode): its SOEMs
     take the grouped conv (no kernel claims f32), against the same
     model's detections on the CPU;
  6-7e, each: the 3 requests run eagerly, are captured as CUDA graphs and
     are replayed (``make_detector`` on a card); a fourth request on fresh
     frames, replayed, is held bitwise against the eager
     ``inference.Detector`` and against the plain path, and its launches
     of kernels A, B, C and D are read from the device trace, each under
     a ``cudaGraphLaunch`` (``check_replay``);
  7f. train path 1: full-width DyYOLO at cfg6's shape (640 px, batch 8,
     grad_batches 2, bf16 autocast over float32 parameters, SGD with
     momentum 0.78 and lr 1e-4 from conf/model/dy-yolo.yaml), seeded
     weights, 8 microbatches of painted-box frames: 4 optimizer updates;
     every loss finite, the parameters moved, every conv and DyConv output
     bf16 (forward hooks), no kernel launched by a train step;
  7g. the trainer path: ``Trainer.fit`` at the same shape (1 epoch, 4 train
     and 2 validation batches, ``eval_ap``), checkpoints in a temporary
     directory, then a second trainer's ``fit(resume=True)``; the
     validation's detector launches kernels A, B and C once per batch and
     its detections on one batch agree with the plain path's;
  7h. train path 2: full-width DySOEM_SimFPN at 1280 px, batch 4, bf16
     autocast, 2 updates; its eval-mode validation loss launches kernel D
     three times per batch and agrees with the plain dyconv's;
  7i. float32 train steps on the card against the CPU: the tiny DyYOLO of
     tests/test_trainer.py at 64 px, TF32 off, 4 microbatches each;
  7j. the data path through the entry points, at cfg6's shape, in a
     temporary working directory: a synthetic tree (2 sequences x 2
     cameras x 16 frames per split, 512 px, seed 0) written through
     nvJPEG, whose decode of those frames is held against the drawn
     arrays; the decode of PIL's JPEGs (4:2:0 at quality 75 as the JAX
     writer and Anti-UAV store frames, 4:2:2, grey, 4:4:4;
     ``data/jpeg_reference.npz``) against PIL's decode of them, with
     nvJPEG's own RGB conversion beside; ``prepare_dataloader.main``; the train and val pipelines on
     the card against the same pipelines on the CPU over the same decoded
     frames (membership, masks and boxes bitwise, pixels within one unit);
     the pipeline's frames per second alone (4 read and decode threads,
     and one), decode and frame stage ms per batch, the frame stage at the
     cameras' sizes (8 RGB 1080x1920 + 8 infrared 512x640, card vs CPU),
     cfg6's train step fed by the pipeline against painted batches and
     against the pipeline's batches taken into a list first;
     the three entry points on their default device, the card:
     ``train.main`` (DyYOLO at cfg6's shape, 4 train and 2 validation
     batches, ``eval_ap``: kernels A, B and C once per validation batch,
     none in a train step), ``evaluate.main --split val --batch 16`` (A,
     B and C once per batch, its output line and fps) and
     ``scripts.detect.main`` over the val frames at batch 16 (A, B and C
     once per batch; its JSON keyed by relative path, in the frames' 512
     px, equal to the restored detector's boxes at 640 px scaled back);
  7k. export: ``export.export_detector`` artifacts of phase 6's DyYOLO (640
     px, batch 16, bf16), of DySOEM_SimFPN (1280 px, batch 2), of the
     dual-stream DyYOLO (2 RGB 1080x1920 + 2 infrared 512x640) and of
     BaselineModel (batch 1), and the artifact of
     ``scripts.export_detector.main --ckpt last`` over 7j's checkpoint on
     its default device; all five loaded and run (3 calls each) in one
     fresh Python process that imports only ``uavdet_tpu_torch.export``,
     which reports its launch counts and that no module under ``models/``
     and no JAX was imported there; each artifact's detections against its
     live detector's (for the CLI's, the detector ``evaluate`` restores);
     then a Lightning-format checkpoint of phase 6's DyYOLO through
     ``scripts.port_reference_checkpoint`` and ``evaluate.main --ckpt
     last`` (A, B and C once per batch), its mAP and dump against the same
     weights loaded directly;
  7l. RTMUAVDet at cfg4's shape (``bench.py``: 640 px, batch 8): full width
     (1,918,742 parameters), bf16, seeded weights, 3 requests of uint8
     frames through ``inference.make_rtm_detector``; the NMS kernel once
     and the group_norm1 kernel four times per request, no other kernel;
     the detections against the same detector with the plain NMS;
  7m. its training at cfg5's shape: 4 Adam steps (lr 1e-4) of
     ``training.rtm.make_rtm_train_step`` at 640 px, batch 8, bf16
     autocast over float32 parameters: losses finite, parameters moved,
     every conv output bf16, no kernel launched; then 3 float32 steps of
     the 64 px model (dropout off) on the card against the CPU, TF32 off;
  7n. the mosaic path: ``ops.resize.lanczos4_resize`` on the card against
     the CPU, bitwise (1080x1920 and 512x640 into 320x320, and an upscale),
     and its time on a mosaic batch's 32 sources; in 7j's working
     directory, ``DataPipeline(mosaic=True)`` over 7j's tree on the card
     against the same pipeline on the CPU over the same decoded frames
     (membership, masks and boxes bitwise, pixels within one unit; no
     kernel launched), its frames per second beside the plain train
     pipeline's, in turns; ``train.main`` with ``dataset.mosaic: true`` at
     cfg6's shape on its default device (A, B and C once per validation
     batch);
  7o. multi-device (one card, so nothing across cards is measured): (a) in
     a one-process NCCL group, the DDP and the FSDP2 step of the tiny
     DyYOLO in float32 at 64 px against the single-device step (losses
     rtol 1e-5), and cfg6 (full width, 640 px, batch 8, grad_batches 2,
     bf16) placed both ways (finite, no kernel, ms per microbatch beside
     the single-device step's); (b) two processes sharing the card over
     gloo (``parallel.dryrun.launch``, NCCL refuses two ranks on one
     device), each with a deadline: the float32 DDP step of a global batch
     of 8 against one process (phase 7i's rtol 1e-4), cfg6 DDP at 4 rows a
     rank, the sharded detect of phase 6's DyYOLO at batch 16 (8 a rank;
     kernels A, B and C once per request on each rank) against the
     one-process detect (the card's score limit, valid counts within 5 %;
     bitwise or not, printed), ``Trainer.fit`` with ``devices: 2`` and
     ``multihost: true`` over 7j's tree through ``set_local_rows`` (finite
     losses, each rank read only its rows' files, rank 0's checkpoint
     restores in one process), then FSDP2 over the two processes where
     gloo carries its collectives on CUDA tensors (else said so); (c) the
     two-rank ms per microbatch beside the one-process one, peak memory per
     rank;
  7p. sp and ep (one card: two processes sharing it over gloo, each with a
     deadline, ``sp_ep_rank_job``): on a mesh of sp 2 the spatial detect
     (``make_detector(mesh=, spatial=True)``) of phase 6's DyYOLO (640 px,
     batch 16, 320 rows a rank, bf16) and of phase 7's DySOEM_SimFPN (cfg3:
     1280 px, batch 32) against the one-process detects on the same frames
     (the card's score limit, valid counts within 5 %), the launches on each
     rank (A, B and C once per request; D three times and C once), ms per
     request and peak memory per rank beside one process's; kernels A and
     B on a rank's band with the stem's halo rows (``fused_stem_rows``'s
     operands) and kernel D on the first SOEM's halo'd band, against their
     plain versions (the first 4 images); the float32 tiny DyYOLO step on
     sp 2 and on ep 2 against one process (rtol 1e-4); cfg6 under sp 2 (8
     rows, each rank its band) and under ep 2 (4 rows a rank, the expert
     stacks sliced): finite, no kernel, ms per microbatch, peak memory, the
     expert bytes per rank and the bytes each DyConv's collectives move
     beside an all-gather of its slices; then 7o's and 7p's readings as one
     ``{"multi_device": ...}`` line;
  7q. pipeline parallelism (``parallel.pipeline``; one card, so every
     stage shares it and no speed-up can show): (a) the float32 tiny DyYOLO
     of 7i at 64 px in 2 and 4 stages, 3 microbatches of 2 rows, 2 updates
     on the card against the same steps on the CPU (7i's rtol; no kernel
     launched); (b) full-width DyYOLO at cfg6's shape (640 px, batch 8 in 2
     microbatches of 4, bf16 autocast) in 2 stages: one update against the
     plain step with grad_batches 2 on the same microbatches from the same
     weights (microbatch losses rtol 1e-3, every updated parameter and
     BatchNorm buffer within 1e-3 of its tensor's largest |value|, the
     largest differences printed); (c) ``Trainer.fit`` with ``pp_devices:
     2`` on ``[cuda:0, cuda:0]`` (2 epochs of 2 train and 1 validation
     batch, ``eval_ap``): A, B and C once per validation batch, and its
     ``last`` restored into a single-device Trainer bitwise; (d)
     ``pp_devices`` above ``torch.cuda.device_count()`` with
     ``device="cuda"`` raises;
  7r. the bench, as a user runs it: ``python -m uavdet_tpu_torch.bench``
     in a fresh process for the default cell, ``--config 1`` to ``6``
     (``--iters 5 --warmup 2``), ``--host-data --epochs 1`` and
     ``--fit-rate``, one after another: each exits with 0 and prints
     exactly one parsable JSON line with a positive value (``vs_baseline``
     a positive number for the default cell, cfg1 and cfg2, else null),
     and its stderr reports the launches of its timed calls as its path
     predicts (A, B, C per call of the default cell, cfg2 and per
     ``--host-data`` batch; C per call of cfg1 and cfg4; D three times and
     C once per call of cfg3; none in cfg5, cfg6 and ``--fit-rate``);
  7s. the section probes, through their ``main(argv)`` in this process:
     ``scripts.roofline_table`` at (16, 640) (its total 2470.9 GFLOP, the
     JAX walk's; the stem's floor printed beside kernels A and B's
     bounds), ``scripts.section_probe`` on phase 6's DyYOLO and
     ``scripts.cfg3_section_probe`` on phase 7's DySOEM_SimFPN (``--iters
     10 --warmup 3``): the sectioned call's heads and Detections bitwise
     equal to ``Detector.heads`` and ``detect`` on the same frames, its
     launches (A, B, C once; D three times and C once), the sum of the
     sections within 5 % of ``detect`` timed back to back, every section
     positive with a floor share but post; one ``{"sections": ...}``
     JSON line; the phase within 60 s;
  7t. the last probes, through their ``main(argv)`` in this process:
     ``scripts.perf_probe --layers --iters 10`` on phase 6's DyYOLO (its
     rows in the JAX script's order and the 22 layer rows, all positive,
     ``sum of layers`` printed beside ``tail``; per call A and B once in
     ``detect (stem kernels)`` and ``stem (kernels A, B)``, C once in
     both detects and both post variants, nothing in the other rows; the
     two detects' Detections within the score limit; the two post
     variants' kept scores, sorted, bitwise equal);
     ``scripts.topk_compact_probe`` at DyYOLO's post (16, 25200, k 512,
     cap 2048) and at cfg3's width (32, 1612800, cap 16384), the value
     agreement True at both; ``scripts.chain_slope`` and
     ``scripts.bblock_probe`` at their defaults (16, 320 px), every row
     positive, the s2d conv3's relative error within 1e-2; one
     ``{"probes": ...}`` JSON line; the phase within 90 s;
  8. times, with CUDA events, medians after warm-up: the four detectors per
     batch, and each kernel at its main-path shapes beside its plain
     version and beside one bf16 ``F.conv2d(groups=B)`` call that computes
     the same function (``library_ms``; the port never calls it; for kernel
     E two such calls, for kernel G three shared-weight bf16 convs with
     their leaky and add), with the
     least time the card could take (``bound_ms``: bytes over 3.35 TB/s or
     operations over the peak rate of their type, whichever is larger);
     kernel D also on all-zero operands (what the power limit costs it);
     every kernel also as the mean of back-to-back launches
     (``back_to_back_ms``: one launch between two events also counts the
     host's time to launch it, which is most of a 30 us kernel's reading);
     the NMS kernel also at (1, 512) and (16, 4096), its two phases by the
     card's global timer, and an empty launch of its grid; kernel G with
     the weights packed once, its time alone by the profiler, and the eager
     tail's two layers it replaces; a cfg6 train microbatch (and with
     PyTorch's own BatchNorm update beside the port's), images per second,
     ``Trainer.validate`` per batch and the peak device memory of training;
     7q (b)'s pp update and the plain step's on the same microbatches (ms
     per update and peak memory, in turns; a ``{"pp": ...}`` JSON line);
     7k's DyYOLO artifact against the live detector, in turns; the host's
     time to issue one call of kernels A, B and C through their registered
     operators and through the CUDA wrappers called directly; the
     group_norm1 kernel at RTMUAVDet's served maps beside its plain
     version, ``F.group_norm`` and its bound (a ``{"group_norm1": ...}``
     JSON line); the bn_act kernel at ``BN_ACT_SERVED`` beside its bound,
     its plain version and the eager chain it replaces (a ``{"bn_act":
     ...}`` JSON line); RTMUAVDet's detector per batch of 8, the NMS kernel on
     its candidates (8, 512) beside its plain version and bound, and a
     cfg5 step (an ``{"rtm": ...}`` JSON line, with 7n's readings); then
     7r's bench lines beside this phase's reading of the same cell (a
     ``{"bench": ...}`` JSON line);
  9. a ``torch.profiler`` window of each detector, of 7k's DyYOLO artifact,
     of two cfg6 train microbatches, of two 7q pp updates, of the RTMUAVDet
     detector and of two cfg5 steps: device time by kernel.

No detector path may launch kernel E, F or G: their paths are the op and
the two command-line entries, as in the JAX package.

Any failed phase makes it exit with 1 and print no result. Otherwise the
last three lines are one JSON object of the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import sys
import time
import traceback
from fractions import Fraction

import numpy as np

BATCH, SIZE, REQUESTS = 16, 640, 3
DUAL_BATCH, RGB_HW, IR_HW = 8, (1080, 1920), (512, 640)   # per modality
LADDER_ITERS = 10                    # timed launches per stage of a ladder
SOEM_BATCH, SOEM_SIZE = 32, 1280     # DySOEM_SimFPN's serving shape
SOEM_CHECK_BATCH = 4                 # images per call of kernel D's plain version
SOEM_PLAIN_FRAMES = 8                # frames of main path 2 run through the plain versions
ITERS, WARMUP = 20, 3
SOEM_ITERS, SOEM_WARMUP = 5, 2       # the DySOEM detector and kernel D per site
PLAIN_ITERS, PLAIN_WARMUP = 2, 1     # kernel D's f32 plain version at batch 32
SEED = 0
NMS_N = 512
NMS_LARGE_N = 4096                   # the NMS kernel's path with the mask in device memory
F32_BATCH, F32_SIZE = 2, 256         # the float32 DySOEM_SimFPN, card against CPU
# training at cfg6's shape (bench.py:236-276): 640 px, batch 8, grad_batches 2
TRAIN_BATCH, TRAIN_GRAD_BATCHES, TRAIN_MICRO = 8, 2, 8
TRAIN_BOXES = 8                      # the data pipeline's padded box count
TRAIN_VAL_BATCHES = 2                # Trainer.fit's validation batches
SOEM_TRAIN_BATCH, SOEM_TRAIN_MICRO = 4, 2   # DySOEM_SimFPN at 1280 px
TRAIN_ITERS, TRAIN_WARMUP = 10, 4    # timed microbatches (5 updates)
# the tiny DyYOLO of tests/test_trainer.py:14-39 (tests/test_entry_points.py
# TINY) for the float32 steps, card against CPU
TINY = (("DyConv", 8, 3, 1), (16, 3, 2), ("B", 1), (32, 3, 2), ("B", 8),
        (64, 3, 2), ("B", 8), (128, 3, 2), ("B", 1), (64, 1, 1),
        (128, 3, 1), ("S",), (32, 1, 1), ("U",), (32, 1, 1), (64, 3, 1),
        ("S",), (16, 1, 1), ("U",), (16, 1, 1), (32, 3, 1), ("S",))
PARITY_SIZE, PARITY_BATCH, PARITY_MICRO = 64, 2, 4
# the data path (7j): a synthetic tree of 512 px frames written by nvJPEG
# (resized to 640 by the pipeline), read by the port's entry points
DATA_SEQ, DATA_FRAMES, DATA_SIZE = 2, 16, 512
EVAL_BATCH = 16                      # evaluate's --batch
DATA_WORKERS = 4                     # the pipelines' read threads
DATA_EPOCHS = 3                      # timed epochs of the pipeline alone
# nvJPEG's decode of its own quality-95, 4:4:4 frames against the drawn
# arrays, mean |diff| per frame in units of 255: what the quantization
# loses. On the synthetic frames (uniform noise of 0..80, a bright box)
# that is about 3 units in any JPEG codec, libjpeg's too; a wrong decode
# (channel order, chroma, offsets) is off by tens.
JPEG_MEAN_TOL = 4.0
# the decode of PIL's JPEGs (data/jpeg_reference.npz: 4:2:0 at PIL's
# defaults as the JAX writer and Anti-UAV store frames, 4:2:2, grey, 4:4:4)
# against PIL's (libjpeg's) decode of them, in units of 255: nvJPEG's IDCT
# and libjpeg's differ by at most one unit in a plane, which the colour
# conversion carries to at most 1 + 1.772 units and a rounding in a
# channel, rarely; on average a few hundredths, and no bias. nvJPEG's own
# RGB conversion (printed beside) truncates: half a unit darker on average
JPEG_REF_MAX, JPEG_REF_MEAN, JPEG_REF_BIAS = 4, 0.1, 0.05
# detect's score threshold in 7j: evaluate's, so that the barely trained
# detector reports boxes
DETECT_SCORE = 0.001
# its boxes against the restored detector's, scaled back by the smoke: the
# JSON rounds them to 2 decimals
DETECT_BOX_TOL = 0.006
# the frame stage on the card against the CPU on the same decoded frames:
# float32 sums in another order can move a value across a rounding
# boundary of the uint8 grid, by one unit
FRAME_TOL_UNITS = 1
# float32 losses on the card against the CPU: the CPU tests hold the port's
# first four steps against JAX's to 1e-5 (tests/test_torch_train_step.py);
# cuDNN's f32 convolutions and reductions sum in other orders again
PARITY_RTOL = 1e-4
# published peaks of one H100 SXM: bytes/s of device memory, dense bf16 on the
# tensor cores, f32 outside them
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# bf16 output of an f32 sum: the kernels and their plain versions add the
# same bf16 products in another order, which can move a result across a
# bf16 rounding boundary (one ulp, 2^-8 relative), rarely further
RTOL, ATOL = 1.6e-2, 1e-2
# detections of the kernel path against the plain path: one flipped bf16 ulp
# in a kernel's output is followed by bf16 roundings in every later layer, so
# the heads' logits differ by a few hundredths (printed per head). A logit
# error d moves a score s = sigmoid(logit) by s (1 - s) d, so the limit on a
# score difference is LOGIT_TOL * s (1 - s) at the plain path's top score
# (0.5 where that is higher): about 2.7e-3 for DyYOLO's 0.028 and 2.4e-2 for
# DySOEM_SimFPN's 0.4 to 0.5. Runs on an H100 measured differences that
# correspond to 0.03 to 0.045 in the logit on both models; a wrong tap,
# channel order or suppression moves logits by whole units.
LOGIT_TOL = 0.1
# a float32 model on the card against the same model on the CPU (TF32 off):
# the same operations summed in another order, errors of a few f32 ulps
# carried through the network
F32_LOGIT_TOL = 1e-3
# RTMUAVDet (7l, 7m): cfg4's serving shape and cfg5's training shape
# (bench.py:20-21, 122-233): 640 px, batch 8; full width, 1,918,742
# parameters (the flax init's count, tests/test_torch_rtm.py holds the
# port's equal to it)
RTM_BATCH, RTM_SIZE, RTM_PARAMS = 8, 640, 1_918_742
# the group_norm1 kernel (5n, 8): the maps of RTMUAVDet's two MDyEncoders at
# its served batch, 8 x 640 px, (B, C, H, W) bf16
GN1_SERVED_SHAPES = ((8, 192, 160, 160), (8, 384, 80, 80))
GN1_EPS = 1e-5
# the bn_act kernel (5o, 8): (B, C, H, W) bf16 channels_last, activation,
# residual: DyYOLO's served batch 16 x 640 px (the first ResidualBlock's
# second block with its skip; the deepest blocks' 512 channels at 40 x 40),
# DySOEM_SimFPN's 32 x 1280 px (the input stem's map; the neck's highest
# resolution)
BN_ACT_SERVED = (((16, 64, 320, 320), "leaky_relu", True),
                 ((16, 512, 40, 40), "leaky_relu", False),
                 ((32, 32, 1280, 1280), "silu", False),
                 ((32, 64, 640, 640), "silu", False))
BN_ACT_EPS = 1e-5
RTM_TRAIN_STEPS = 4
RTM_PARITY_SIZE, RTM_PARITY_BATCH, RTM_PARITY_STEPS = 64, 2, 3
# the mosaic path (7n): the Lanczos-4 resize's card-vs-CPU cases, (source,
# quadrant) sizes: the cameras' frames into a 640 px canvas's quadrant, and
# an upscale
LANCZOS_CASES = (((1080, 1920), (320, 320)), ((512, 640), (320, 320)),
                 ((150, 200), (320, 320)))

# multi-device (7o): one card, so (a) a one-process NCCL group runs the DDP
# and FSDP2 steps, and (b) two processes share the card over gloo (NCCL
# refuses two ranks on one device). NCCL traffic, overlap and scaling
# across cards are not measured here.
MD_RANKS = 2
MD_TIMEOUT = 420                     # seconds per launch of the two ranks
MD_PARITY_BATCH = 8                  # the float32 step's global batch
MD_TRAIN_BATCHES = 2                 # Trainer.fit's train batches (7j's tree)
MD_ITERS, MD_WARMUP = 6, 2           # timed cfg6 microbatches
MD_FRAMES_SEED = 7                   # the sharded detect's frames
MD_BN_CALLS = 50                     # timed calls of one BatchNorm
# float32 losses of one process group against the single-device step on
# the same card: the same operations in the same order where the group has
# one rank
MD_ONE_RTOL = 1e-5

# sp and ep (7p): two processes share the card over gloo, as in 7o (b)
SP_RANKS = 2
SP_TIMEOUT = 600                     # seconds for the launch of the two ranks
SP_FRAMES_SEED = 8                   # the spatial DySOEM detect's frames
SP_CHECK_FRAMES = 4                  # images of a halo'd band held against
                                     # the plain versions of A, B and D
SP_ITERS, SP_WARMUP = 5, 1           # timed requests of a spatial detect

# pipeline parallelism (7q): one process drives the S stages; on the one
# card the stages share it, so what is measured is the schedule's cost over
# the plain step on the same card, not a speed-up
PP_PARITY_STAGES = (2, 4)            # (a) the float32 tiny DyYOLO, card vs CPU
PP_PARITY_MICRO, PP_PARITY_STEPS = 3, 2
PP_STAGES, PP_MICRO = 2, 2           # (b), (c): cfg6's shape in 2 stages
# (b): bf16 losses and updated tensors of the pp step against the plain
# step on the same microbatches: the same operations, the gradient of the
# two microbatches summed in one backward instead of two
PP_LOSS_RTOL = 1e-3
PP_PARAM_TOL = 1e-3                  # of each tensor's largest |value|
PP_EPOCHS, PP_TRAIN_BATCHES, PP_VAL_BATCHES = 2, 2, 1   # (c)
PP_ITERS, PP_WARMUP = 5, 2           # (e): timed updates

# the bench (7r): one fresh process per cell, as a user runs it; the cells
# with timed calls take BENCH_TIMED
BENCH_CELLS = (("default", ()), *((f"cfg{n}", ("--config", str(n)))
                                  for n in range(1, 7)),
               ("host-data", ("--host-data", "--epochs", "1")),
               ("fit-rate", ("--fit-rate",)))
BENCH_TIMED = ("--iters", "5", "--warmup", "2")
BENCH_WITH_BASELINE = ("default", "cfg1", "cfg2")
BENCH_TIMEOUT = 300                  # seconds per bench process

# the section probes (7s), in this process on the models of phases 6 and 7
SECTIONS_ARGS = ("--iters", "10", "--warmup", "3")
SECTIONS_SUM_TOL = 0.05              # sum of sections against detect, relative
SECTIONS_SECONDS = 60                # the phase's time limit
ROOFLINE_GFLOP = 2470.9              # the JAX walk's total at (16, 640)
# PERF.md section 6: kernels A and B's bounds at the default cell, in ms
STEM_KERNEL_BOUNDS_MS = (0.131, 0.188)

# the last probes (7t), in this process on the DyYOLO of phase 6
PERF_PROBE_ARGS = ("--layers", "--iters", "10")
PERF_PROBE_LAYERS = 22               # the JAX walk's rows at (16, 640)
# (cell, argv): DyYOLO's post; cfg3's width, where about 6,800 logits per
# image are above tau, so the capacity is 16384 (2048 would overflow)
TOPK_CELLS = (("DyYOLO", ("--batch", "16", "--n", "25200", "--k", "512",
                          "--cap", "2048")),
              ("cfg3", ("--batch", "32", "--n", "1612800", "--k", "512",
                        "--cap", "16384")))
TOPK_ITERS = ("--iters", "10")
# conv3 through space-to-depth against conv3, relative to its largest
# |value|: both sum the same bf16 products in f32 in another order and
# round to bf16, one ulp (2^-8) of a value near the largest at most, rarely
# two
S2D_REL_TOL = 1e-2
PROBES_SECONDS = 90                  # the phase's time limit

KERNELS = {
    "stem_l1": ("uavdet_tpu_torch/csrc/stem_l1.cu",
                "uavdet_tpu/ops/pallas_stem_split.py:62"),
    "stem_l2": ("uavdet_tpu_torch/csrc/stem_l2.cu",
                "uavdet_tpu/ops/pallas_stem_split.py:256"),
    "nms": ("uavdet_tpu_torch/csrc/nms.cu", "uavdet_tpu/ops/pallas_nms.py:28"),
    "dyconv": ("uavdet_tpu_torch/csrc/dyconv.cu",
               "uavdet_tpu/ops/pallas_dyconv.py:54"),
    "stem_fused": ("uavdet_tpu_torch/csrc/stem_fused.cu",
                   "uavdet_tpu/ops/pallas_stem.py:37"),
    "stem_l2_stage": ("uavdet_tpu_torch/csrc/stem_l2.cu",
                      "scripts/l2_ablate.py:27"),
    "post_stem_block": ("uavdet_tpu_torch/csrc/post_stem_block.cu",
                        "scripts/block_ablate.py:44"),
    "group_norm1": ("uavdet_tpu_torch/csrc/group_norm1.cu",
                    "replaces no TPU kernel (the JAX package leaves "
                    "GroupNorm to XLA); plain version "
                    "ops/group_norm.py:group_norm1_plain"),
    "bn_act": ("uavdet_tpu_torch/csrc/bn_act.cu",
               "replaces no TPU kernel (XLA fused the conv blocks' epilogue "
               "into the conv); plain version ops/bn_act.py:bn_act_plain"),
}
# the bn_act kernel's launches per call of a bf16 model in eval mode without
# autocast: DyYOLO's 70 CNNBlocks and DyConvModules after the stem kernels
# (72 where its two stem DyConvModules run too, and BaselineModel's 72
# CNNBlocks), DySOEM_SimFPN's input stem and three neck ConvModules; under
# autocast (the Trainer's validation, the eval step) and in training none
BN_DYYOLO, BN_DYYOLO_STEM, BN_BASELINE, BN_DYSOEM = 70, 72, 72, 4
# launches per request on each main path; a kernel not named is launched 0
# times there
EXPECTED_LAUNCHES = {
    "DyYOLO": {"stem_l1": 1, "stem_l2": 1, "nms": 1, "bn_act": BN_DYYOLO},
    "DySOEM_SimFPN": {"nms": 1, "dyconv": 3, "bn_act": BN_DYSOEM},
    "baseline": {"nms": 1, "bn_act": BN_BASELINE},
    "DyYOLO dual": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                    "bn_act": BN_DYYOLO},
    "DyYOLO pre_nms_topk 4096": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                                 "bn_act": BN_DYYOLO},
    "DySOEM_SimFPN float32": {"nms": 1},
    # per microbatch: training runs the plain modules
    "DyYOLO train step": {},
    "DySOEM_SimFPN train step": {},
    # per validation batch of Trainer.fit / of the eval step
    "Trainer.fit DyYOLO": {"stem_l1": 1, "stem_l2": 1, "nms": 1},
    "train entry point DyYOLO": {"stem_l1": 1, "stem_l2": 1, "nms": 1},
    # per batch of the evaluate and detect entry points
    "evaluate entry point DyYOLO": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                                    "bn_act": BN_DYYOLO},
    "detect entry point DyYOLO": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                                  "bn_act": BN_DYYOLO},
    # per microbatch fed by the data pipeline
    "DyYOLO train step fed by the pipeline": {},
    "DySOEM_SimFPN eval step": {"dyconv": 3},
    "stem_fused op": {"stem_fused": 1},
    # per call of an artifact of export.export_detector, loaded in a fresh
    # process (7k)
    "exported DyYOLO": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                        "bn_act": BN_DYYOLO},
    "exported DySOEM_SimFPN": {"nms": 1, "dyconv": 3, "bn_act": BN_DYSOEM},
    "exported DyYOLO dual": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                             "bn_act": BN_DYYOLO},
    "exported baseline": {"nms": 1, "bn_act": BN_BASELINE},
    "exported DyYOLO, scripts.export_detector --ckpt last": {
        "stem_l1": 1, "stem_l2": 1, "nms": 1, "bn_act": BN_DYYOLO},
    # per batch of evaluate over a ported reference checkpoint (7k)
    "evaluate entry point, ported checkpoint": {"stem_l1": 1, "stem_l2": 1,
                                                "nms": 1,
                                                "bn_act": BN_DYYOLO},
    # per request of make_rtm_detector (7l: each MDyEncoder's two
    # GroupNorm(1)s), per step of cfg5 (7m: nn.GroupNorm in training)
    "RTMUAVDet": {"nms": 1, "group_norm1": 4},
    "RTMUAVDet train step": {},
    "RTMUAVDet float32 train step": {},
    # per batch of the mosaic pipeline, per validation batch of train.main
    # with dataset.mosaic on (7n)
    "mosaic pipeline": {},
    "train entry point DyYOLO, mosaic": {"stem_l1": 1, "stem_l2": 1,
                                         "nms": 1},
    # per request of the sharded detect, on each of the two ranks (7o)
    "DyYOLO sharded detect, rank 0": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                                      "bn_act": BN_DYYOLO},
    "DyYOLO sharded detect, rank 1": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                                      "bn_act": BN_DYYOLO},
    # per microbatch of the DDP and FSDP2 steps (7o)
    "DyYOLO train step, placed on a mesh": {},
    # per validation batch of Trainer.fit with multihost, each rank (7o)
    "Trainer.fit multihost, rank 0": {"stem_l1": 1, "stem_l2": 1, "nms": 1},
    "Trainer.fit multihost, rank 1": {"stem_l1": 1, "stem_l2": 1, "nms": 1},
    # per request of the spatial (sp 2) detect, on each of the two ranks, on
    # its band of rows (7p)
    "DyYOLO spatial detect, rank 0": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                                      "bn_act": BN_DYYOLO},
    "DyYOLO spatial detect, rank 1": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                                      "bn_act": BN_DYYOLO},
    "DySOEM_SimFPN spatial detect, rank 0": {"nms": 1, "dyconv": 3,
                                             "bn_act": BN_DYSOEM},
    "DySOEM_SimFPN spatial detect, rank 1": {"nms": 1, "dyconv": 3,
                                             "bn_act": BN_DYSOEM},
    # per microbatch of the sp 2 and ep 2 train steps (7p)
    "DyYOLO train step, sp 2": {},
    "DyYOLO train step, ep 2": {},
    # per pp step (7q), per validation batch of Trainer.fit with pp_devices
    "DyYOLO pp train step": {},
    "Trainer.fit DyYOLO pp": {"stem_l1": 1, "stem_l2": 1, "nms": 1},
    # per timed call (warm-up included) of a bench process (7r): a
    # detector call, a train step, a batch of --host-data, a step of each
    # of --fit-rate's two Trainer.fit runs
    "bench default": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                      "bn_act": BN_DYYOLO},
    "bench cfg1": {"nms": 1, "bn_act": BN_BASELINE},
    "bench cfg2": {"stem_l1": 1, "stem_l2": 1, "nms": 1, "bn_act": BN_DYYOLO},
    "bench cfg3": {"nms": 1, "dyconv": 3, "bn_act": BN_DYSOEM},
    "bench cfg4": {"nms": 1, "group_norm1": 4},
    "bench cfg5": {},
    "bench cfg6": {},
    "bench host-data": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                        "bn_act": BN_DYYOLO},
    "bench fit-rate": {},
    # per sectioned call of the section probes (7s), warm-up included
    "section_probe DyYOLO": {"stem_l1": 1, "stem_l2": 1, "nms": 1,
                             "bn_act": BN_DYYOLO},
    "cfg3_section_probe DySOEM_SimFPN": {"nms": 1, "dyconv": 3,
                                         "bn_act": BN_DYSOEM},
    # per timed call (warm-up included) of each row of scripts.perf_probe
    # (7t); its layer rows together
    "perf_probe detect (stem kernels)": {"stem_l1": 1, "stem_l2": 1,
                                         "nms": 1, "bn_act": BN_DYYOLO},
    "perf_probe detect (no stem kernels)": {"nms": 1,
                                            "bn_act": BN_DYYOLO_STEM},
    "perf_probe preprocess": {},
    "perf_probe stem (kernels A, B)": {"stem_l1": 1, "stem_l2": 1},
    "perf_probe tail (all layers after stem)": {"bn_act": BN_DYYOLO},
    "perf_probe stem (plain layers)": {"bn_act": 2},
    "perf_probe decode+topk+NMS (full-grid decode)": {"nms": 1},
    "perf_probe decode+topk+NMS (logit-topk decode)": {"nms": 1},
    # the tail's 70 blocks spread over its PERF_PROBE_LAYERS layer rows,
    # each called as often: 70 / 22 a call on average
    "perf_probe per-layer rows": {
        "bn_act": Fraction(BN_DYYOLO, PERF_PROBE_LAYERS)},
    # one run of a ladder's entry point: every stage, warm-up included
    "l2_ablate": {"stem_l2_stage": 5 * (LADDER_ITERS + 3)},
    "block_ablate": {"post_stem_block": 4 * (LADDER_ITERS + 3)},
}


class Smoke:
    def __init__(self):
        self.failures = []
        self.stats = {name: {"launches": 0, "launches_by_path": {}}
                      for name in KERNELS}

    def check(self, name: str, ok: bool, detail: str) -> None:
        print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)
        if not ok:
            self.failures.append(name)

    def phase(self, name: str, fn, *args):
        print(f"== {name}", flush=True)
        try:
            return fn(*args)
        except Exception:   # record, report, and go on to the next phase
            traceback.print_exc()
            self.check(name, False, "raised")
            return None


def cuda_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
    from uavdet_tpu_torch.utils.timing import cuda_ms as timed
    return timed(fn, iters, warmup)


def back_to_back_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of one call among ``iters`` launched back to back."""
    from uavdet_tpu_torch.utils.timing import back_to_back_ms as timed
    return timed(fn, iters, 1)


def kernel_row_ms(fn, key: str, iters: int):
    """Device time of one call's kernels whose name holds ``key``, by
    ``torch.profiler`` over ``iters`` calls after one warm-up: the kernel
    alone. None where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and key in e.key)
    return us / iters / 1e3 if us > 0 else None


def host_us(fn, calls: int = 50) -> float:
    """Host time to issue one call of ``fn``, in us: the mean over ``calls``
    calls made back to back without waiting for the card (fewer than its
    launch queue holds), after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    their peak rate, whichever is larger."""
    by_bytes, by_ops = n_bytes / HBM_BPS * 1e3, n_ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": int(n_bytes), "operations": int(n_ops)}


def count_launches(smoke, kernels, path: str, requests: int,
                   counts=None) -> None:
    """Reads the launch counts of one main path's run (or takes ``counts``,
    read in another process) and holds them against what that path launches
    per request."""
    counts = kernels.launch_counts() if counts is None else counts
    want = {k: EXPECTED_LAUNCHES[path].get(k, 0) * requests for k in counts}
    for name, n in counts.items():
        smoke.stats[name]["launches"] += n
        smoke.stats[name]["launches_by_path"][path] = n
    smoke.check(f"launches {path}", counts == want,
                f"{counts} for {requests} requests, expected {want}")


def check_requests(smoke, results, batch: int) -> None:
    import torch
    for i, d in enumerate(results):
        shapes = (tuple(d.boxes.shape), tuple(d.scores.shape),
                  tuple(d.valid.shape))
        finite = bool(torch.isfinite(d.boxes).all()
                      and torch.isfinite(d.scores).all())
        zero = bool((d.boxes[~d.valid] == 0).all()
                    and (d.scores[~d.valid] == 0).all())
        n_valid = d.valid.sum(1)
        smoke.check(f"request {i}", shapes == ((batch, 300, 4), (batch, 300),
                                               (batch, 300))
                    and finite and zero and bool((n_valid > 0).all()),
                    f"shapes {shapes} finite {finite} invalid-zero "
                    f"{zero} valid per image {n_valid.tolist()}")


# each path kernel's name in the device trace (NMS_LARGE, counted as nms,
# launches nms_mask_kernel and then nms_walk_kernel)
KERNEL_SYMBOLS = {"stem_l1": ("stem_l1_kernel",),
                  "stem_l2": ("stem_l2_kernel",),
                  "nms": ("nms_kernel", "nms_mask_kernel"),
                  "dyconv": ("dyconv_kernel",),
                  "group_norm1": ("gn1_moments",),
                  "bn_act": ("bn_act_",)}


def check_replay(smoke, path: str, detect, twin, *frames):
    """One more call of ``detect``, on fresh ``frames`` of a signature it
    already replays as CUDA graphs, under ``tracing.collect`` and the
    profiler. Checks that the call replayed its graphs; that its answer is
    bitwise the eager ``twin``'s (``inference.Detector`` over the same
    model, same options); and that the device trace holds the launches of
    kernels A, B, C and D that EXPECTED_LAUNCHES gives for ``path``, each
    from a graph's launch (``cudaGraphLaunch``) and none outside one.
    -> the replayed Detections, for the caller's plain comparison."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from uavdet_tpu_torch import kernels, tracing
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with tracing.collect() as t, profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = detect(*frames)
        torch.cuda.synchronize()
    counted = {k: kernels.launch_counts()[k] for k in KERNEL_SYMBOLS}
    graphs = {k: v["calls"] for k, v in t.counts.items()
              if k.startswith("graph_")}
    smoke.check(f"replay {path}: graphs replayed",
                graphs == {"graph_replay": 1}, f"counters {graphs}")
    with torch.inference_mode():
        want = type(got)(*twin(*frames))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    smoke.check(f"replay {path}: bitwise the eager Detector", equal,
                f"valid per image {got.valid.sum(1).tolist()} vs "
                f"{want.valid.sum(1).tolist()}")
    events = [e for e in prof.profiler.kineto_results.events()
              if e.end_ns() > e.start_ns()]
    runtime = {e.correlation_id(): e.name() for e in events
               if e.device_type() != DeviceType.CUDA
               and e.name().startswith("cu")}
    graphed = dict.fromkeys(KERNEL_SYMBOLS, 0)
    eager = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        for k, names in KERNEL_SYMBOLS.items():
            if any(n in e.name() for n in names):
                launch = runtime.get(e.correlation_id(), "")
                (graphed if launch.startswith("cudaGraphLaunch")
                 else eager)[k] += 1
    want_n = {k: EXPECTED_LAUNCHES[path].get(k, 0) for k in KERNEL_SYMBOLS}
    smoke.check(f"replay {path}: kernel launches in the device trace",
                graphed == want_n and not any(eager.values()),
                f"under cudaGraphLaunch {graphed}, outside a graph {eager}, "
                f"expected {want_n}")
    smoke.check(f"replay {path}: launch_counts as the trace", counted ==
                graphed, f"{counted}")
    return got


def compare_heads(smoke, outs_k, outs_p) -> None:
    import torch
    for h, (ok_, op_) in enumerate(zip(outs_k, outs_p)):
        for field in ("obj", "bbox"):
            g = getattr(ok_, field).float()
            w = getattr(op_, field).float()
            corr = float(torch.corrcoef(torch.stack(
                [g.flatten(), w.flatten()]))[0, 1])
            err = float((g - w).abs().max())
            smoke.check(f"head {h} {field}", corr > 0.999,
                        f"max_abs_err {err:.4g} corr {corr:.6f}")


def compare_detections(smoke, d, plain, logit_tol=LOGIT_TOL,
                       name="detections vs plain path") -> None:
    """The score limit (``LOGIT_TOL``) and valid counts within 5 %:
    ``utils.compare.detections_agree``."""
    from uavdet_tpu_torch.utils.compare import detections_agree
    smoke.check(name, *detections_agree(d, plain, logit_tol))


def compare_bf16(smoke, name, got, want):
    """-> max abs error; checks the stated bf16 tolerance."""
    import torch
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    equal = float((got == want).float().mean())
    ok = (got.shape == want.shape and bool(torch.isfinite(g).all())
          and torch.allclose(g, w, rtol=RTOL, atol=ATOL))
    smoke.check(name, ok, f"shape {tuple(got.shape)} max_abs_err {err:.6g} "
                f"bitwise-equal {equal:.6%} (rtol {RTOL}, atol {ATOL})")
    return err


def nms_case(gen, device):
    """(16, 512) xyxy boxes and scores with duplicates, equal scores,
    zero-area boxes and -inf padding."""
    import torch
    b, n = BATCH, NMS_N
    xy = torch.rand((b, n, 2), generator=gen, device=device) * 600
    wh = 5 + torch.rand((b, n, 2), generator=gen, device=device) * 120
    boxes = torch.cat([xy, xy + wh], dim=-1)
    scores = torch.rand((b, n), generator=gen, device=device)
    boxes[:, 100:140] = boxes[:, 60:100]          # exact duplicates
    scores[:, 100:140] = scores[:, 60:100]        # ... with equal scores
    scores[:, 200:260] = 0.5                      # a run of equal scores
    boxes[:, 300:330, 2:] = boxes[:, 300:330, :2]  # zero-area boxes
    boxes[:, 460:] = 0.0                          # padding
    scores[:, 460:] = -torch.inf
    return boxes, scores


def grouped_operands(x_nhwc, weight_oihw):
    """The operands of one grouped bf16 ``F.conv2d`` (groups = batch) that
    computes a per-sample conv, made once, outside the timed call: x as
    (1, B*C, H, W) and the (B*O, C, 3, 3) weight, both channels_last."""
    import torch
    b, h, w, c = x_nhwc.shape
    x = x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    return (x.contiguous(memory_format=torch.channels_last),
            weight_oihw.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last))


def stem_weights(k_aug):
    """K (B, O, 9C + 1), taps ki-major, kj, channel and the bias as the last
    column -> the grouped conv's bf16 weight (B*O, C, 3, 3), channels_last,
    and bias (B*O,)."""
    import torch
    b, o, n = k_aug.shape
    c = (n - 1) // 9
    weight = k_aug[..., :-1].reshape(b, o, 3, 3, c).permute(0, 1, 4, 2, 3)
    return (weight.reshape(b * o, c, 3, 3).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last),
        k_aug[..., -1].reshape(b * o).to(torch.bfloat16))


def library_stem(x_nhwc, k_aug, stride: int):
    """Kernel A's or B's function as one library call."""
    import torch.nn.functional as F
    b = x_nhwc.shape[0]
    wq, bias = stem_weights(k_aug)
    x, _ = grouped_operands(x_nhwc, wq)
    return lambda: F.silu(F.conv2d(x, wq, bias, stride=stride, padding=1,
                                   groups=b))


def library_stem_fused(x_nhwc, k1, k2):
    """Kernel E's function as two library calls, the second on the first's
    output as it lies: one (1, 32 B, H, W) bf16 map."""
    import torch.nn.functional as F
    b = x_nhwc.shape[0]
    (w1, b1), (w2, b2) = stem_weights(k1), stem_weights(k2)
    x, _ = grouped_operands(x_nhwc, w1)
    return lambda: F.silu(F.conv2d(
        F.silu(F.conv2d(x, w1, b1, padding=1, groups=b)), w2, b2, stride=2,
        padding=1, groups=b))


def library_block(x_nhwc, w1, k2, k3):
    """Kernel G's function as three shared-weight bf16 channels_last convs
    with their leaky and the residual add."""
    import torch
    import torch.nn.functional as F

    def operands(k_aug, ksize):
        kq = k_aug.to(torch.bfloat16)
        o = kq.shape[0]
        weight = kq[:, :-1].reshape(o, ksize, ksize, -1).permute(0, 3, 1, 2)
        return (weight.contiguous(memory_format=torch.channels_last),
                kq[:, -1].contiguous())

    x = x_nhwc.permute(0, 3, 1, 2)   # NCHW view of NHWC memory
    (wa, ba), (wb, bb), (wc, bc) = (operands(w1, 1), operands(k2, 3),
                                    operands(k3, 3))

    def run():
        z = F.leaky_relu(F.conv2d(x, wa, ba), 0.1)
        y = F.leaky_relu(F.conv2d(z, wb, bb, padding=1), 0.1) + x
        return F.leaky_relu(F.conv2d(y, wc, bc, stride=2, padding=1), 0.1)

    return run


def library_dyconv(x, k, mul, add):
    """Kernel D's function as one library call plus its affine and SiLU."""
    import torch
    import torch.nn.functional as F
    b, h, w, c = x.shape
    co = k.shape[-1]
    xq, wq = grouped_operands(
        x, k.permute(0, 3, 2, 1).reshape(b * co, c, 3, 3))
    m = mul.to(torch.bfloat16)[None, :, None, None]
    a = add.to(torch.bfloat16)[:, :, None, None]
    return lambda: F.silu(F.conv2d(xq, wq, padding=1, groups=b).reshape(
        b, co, h, w) * m + a)


def gn1_operands(shape, dtype, gen, device, shift=0.0):
    """x (B, C, H, W) of unit spread around ``shift``, weight in [0.5,
    1.5], bias around 0, all of ``dtype``."""
    import torch
    c = shape[1]
    x = torch.randn(shape, generator=gen, device=device) + shift
    weight = 0.5 + torch.rand(c, generator=gen, device=device)
    bias = 0.5 * torch.randn(c, generator=gen, device=device)
    return x.to(dtype), weight.to(dtype), bias.to(dtype)


def gn1_close(got, want, x, weight) -> tuple:
    """(ok, detail): bf16 within one bf16 unit in the last place of each
    value of ``want``, or of 1/256 of its largest |value| where that is
    larger (the output is rounded once; near 0, f32 errors of some 1e-7
    exceed a unit of the value); float32 within 1e-5 of the largest |value|
    plus four f32 units of max |x| * max |rstd * weight|, the affine's
    largest term (tests/test_torch_group_norm.py's limits)."""
    import torch
    diff = (got.double() - want.double()).abs()
    top = float(want.abs().max())
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(want.float().abs().clamp_min(
            max(top / 256, 2.0 ** -120)))
        unit = torch.ldexp(torch.ones_like(diff), (e - 8).to(torch.int32))
        units = float((diff / unit).max())
        return units <= 1.0, f"max {units:.3f} bf16 units (limit 1)"
    xd = x.double().reshape(x.shape[0], -1)
    a = float(weight.double().abs().max() / xd.std(1, correction=0).min())
    tol = 1e-5 * top + 4 * 2.0 ** -24 * float(xd.abs().max()) * a
    err = float(diff.max())
    return err <= tol, f"max_abs_err {err:.4g} (limit {tol:.4g})"


def group_norm1_checks(smoke, dev, gen) -> None:
    """5n: the group_norm1 kernel against its plain version (bf16) or a
    float64 GroupNorm (float32) at ``ops.group_norm.GN1_EDGE_SHAPES`` and, in
    bf16, at RTMUAVDet's served shapes; each launch twice, bitwise equal
    (no atomics)."""
    import torch
    import torch.nn.functional as F
    from uavdet_tpu_torch.ops.group_norm import (GN1_EDGE_SHAPES,
                                                 group_norm1_plain)
    cases = [((b, c, h, w), shift, dtype) for b, c, h, w, shift in
             GN1_EDGE_SHAPES for dtype in (torch.float32, torch.bfloat16)]
    cases += [(shape, 0.0, torch.bfloat16) for shape in GN1_SERVED_SHAPES]
    with torch.inference_mode():
        for shape, shift, dtype in cases:
            x, w, b = gn1_operands(shape, dtype, gen, dev, shift)
            got = torch.ops.uavdet.group_norm1(x, w, b, GN1_EPS)
            want = (group_norm1_plain(x, w, b, GN1_EPS) if dtype ==
                    torch.bfloat16 else F.group_norm(
                        x.double(), 1, w.double(), b.double(), GN1_EPS))
            label = f"group_norm1 {shape} {dtype} shift {shift:g}"
            smoke.check(label, *gn1_close(got, want, x, w))
            again = torch.ops.uavdet.group_norm1(x, w, b, GN1_EPS)
            smoke.check(f"{label}: twice", torch.equal(again, got),
                        "bitwise equal")


def group_norm1_times(dev, gen, tag) -> list:
    """Phase 8's group_norm1 rows at RTMUAVDet's served shapes, bf16: the
    kernel (one launch between two events, back to back, and its two
    kernels' profiler rows), the plain version and ``F.group_norm``
    (PyTorch's GroupNorm, which the served path called before), in turns;
    beside the bound, each byte of x read once and each of y written
    once."""
    import torch
    import torch.nn.functional as F
    from uavdet_tpu_torch.ops.group_norm import group_norm1_plain
    rows = []
    with torch.inference_mode():
        for shape in GN1_SERVED_SHAPES:
            x, w, b = gn1_operands(shape, torch.bfloat16, gen, dev)
            fns = {
                "kernel": lambda: torch.ops.uavdet.group_norm1(x, w, b,
                                                               GN1_EPS),
                "plain": lambda: group_norm1_plain(x, w, b, GN1_EPS),
                "library": lambda: F.group_norm(x, 1, w, b, GN1_EPS)}
            ms = {k: [] for k in fns}
            for k in list(fns) + list(reversed(fns)):
                ms[k].append(cuda_ms(fns[k]))
            row = {"shape": list(shape),
                   **{f"{k}_ms": min(v) for k, v in ms.items()},
                   "back_to_back_ms": back_to_back_ms(fns["kernel"]),
                   "profiler_row_ms": kernel_row_ms(fns["kernel"], "gn1_",
                                                    ITERS),
                   "library_row_ms": kernel_row_ms(fns["library"], "",
                                                   ITERS),
                   **bound(2 * nbytes(x) + 2 * nbytes(w), 10 * x.numel(),
                           F32_FLOPS)}
            rows.append(row)
            print(f"group_norm1 {shape} bf16: kernel {ms['kernel']} ms "
                  f"({row['back_to_back_ms']:.4f} back to back, "
                  f"{row['profiler_row_ms']} by the profiler), "
                  f"plain {ms['plain']} ms, F.group_norm {ms['library']} ms "
                  f"({row['library_row_ms']} by the profiler), bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}) {tag}")
    print(json.dumps({"group_norm1": rows}))
    return rows


def bn_act_operands(shape, layout, residual, gen, device, params=None):
    """x (B, C, H, W) bf16 of spread 2 in ``layout`` (a memory format), a
    BatchNorm's running mean, variance in [0.05, 4] and affine around 1 and
    0 (bf16, or ``params``), a residual in x's layout or None."""
    import torch
    c = shape[1]
    bf16 = torch.bfloat16

    def map_(std):
        return (std * torch.randn(shape, generator=gen, device=device)).to(
            bf16).contiguous(memory_format=layout)
    x = map_(2.0)
    vectors = [torch.randn(c, generator=gen, device=device),
               0.05 + 3.95 * torch.rand(c, generator=gen, device=device),
               0.5 + torch.rand(c, generator=gen, device=device),
               0.5 * torch.randn(c, generator=gen, device=device)]
    vectors = [v.to(params or bf16) for v in vectors]
    return x, *vectors, (map_(1.0) if residual else None)


def bn_act_close(got, want, act) -> tuple:
    """(ok, detail): LeakyReLU bitwise (both sides the same f32 steps);
    SiLU within one bf16 unit in the last place of each value, or of 1/256
    of the largest |value| where that is larger (the kernel's SiLU takes
    the special-function unit's exp2 and reciprocal, the plain version
    PyTorch's)."""
    import torch
    if act == "leaky_relu":
        diff = int((got != want).sum())
        return diff == 0, f"{diff} values differ (bitwise)"
    top = float(want.abs().max())
    _, e = torch.frexp(want.float().abs().clamp_min(
        max(top / 256, 2.0 ** -120)))
    diff = (got.double() - want.double()).abs()
    unit = torch.ldexp(torch.ones_like(diff), (e - 8).to(torch.int32))
    units = float((diff / unit).max())
    return units <= 1.0, f"max {units:.3f} bf16 units (limit 1)"


def bn_act_checks(smoke, dev, gen) -> None:
    """5o: the bn_act kernel against its plain version at
    ``ops.bn_act.BN_ACT_EDGE_SHAPES`` (both layouts, both activations, with
    and without a residual, bf16 and float32 vectors) and at
    ``BN_ACT_SERVED``, one sample at a time (the plain version's float32
    copies of a 1280 px batch would take some 30 GB beside what earlier
    phases hold); each launch twice, bitwise equal."""
    import torch
    from uavdet_tpu_torch.ops.bn_act import BN_ACT_EDGE_SHAPES, bn_act_plain
    layouts = {"nchw": torch.contiguous_format,
               "channels_last": torch.channels_last}
    cases = [(shape, layout, act, res, params)
             for shape in BN_ACT_EDGE_SHAPES for layout in layouts
             for act in ("leaky_relu", "silu") for res in (False, True)
             for params in (torch.bfloat16, torch.float32)]
    cases += [(shape, "channels_last", act, res, torch.bfloat16)
              for shape, act, res in BN_ACT_SERVED]
    with torch.inference_mode():
        for shape, layout, act, res, params in cases:
            x, m, v, w, b, r = bn_act_operands(shape, layouts[layout], res,
                                               gen, dev, params)
            got = torch.ops.uavdet.bn_act(x, m, v, w, b, BN_ACT_EPS, act, r)
            label = (f"bn_act {shape} {layout} {act} "
                     f"{'residual ' if res else ''}{params}")
            worst = (True, "")
            for i in range(shape[0]):
                want = bn_act_plain(x[i:i + 1], m, v, w, b, BN_ACT_EPS, act,
                                    None if r is None else r[i:i + 1])
                ok, detail = bn_act_close(got[i:i + 1], want, act)
                if not ok or not worst[1]:
                    worst = (ok, f"sample {i}: {detail}")
                if not ok:
                    break
            smoke.check(label, worst[0] and got.stride() == x.stride(),
                        worst[1])
            again = torch.ops.uavdet.bn_act(x, m, v, w, b, BN_ACT_EPS, act,
                                            r)
            smoke.check(f"{label}: twice", torch.equal(again, got),
                        "bitwise equal")
    # the 1280 px maps leave some 15 GB in the allocator's cache, which
    # 7k's fresh process, sharing the card, would miss
    torch.cuda.empty_cache()


def bn_act_times(dev, gen, tag) -> list:
    """Phase 8's bn_act rows at ``BN_ACT_SERVED``: the kernel (one launch
    between two events, back to back, and its profiler row), its plain
    version and the eager chain it replaces (PyTorch's eval BatchNorm, the
    activation, the add), in turns; beside the bound, each byte of x and
    the residual read once and each of y written once."""
    import torch
    import torch.nn.functional as F
    from uavdet_tpu_torch.ops.bn_act import bn_act_plain
    rows = []
    with torch.inference_mode():
        for shape, act, res in BN_ACT_SERVED:
            x, m, v, w, b, r = bn_act_operands(shape, torch.channels_last,
                                               res, gen, dev)
            fn = (F.silu if act == "silu"
                  else lambda t: F.leaky_relu(t, 0.1))

            def chain():
                y = fn(F.batch_norm(x, m, v, w, b, False, 0.0, BN_ACT_EPS))
                return y if r is None else y + r
            fns = {
                "kernel": lambda: torch.ops.uavdet.bn_act(
                    x, m, v, w, b, BN_ACT_EPS, act, r),
                "plain": lambda: bn_act_plain(x, m, v, w, b, BN_ACT_EPS,
                                              act, r),
                "chain": chain}
            ms = {k: [] for k in fns}
            for k in list(fns) + list(reversed(fns)):
                ms[k].append(cuda_ms(fns[k]))
            moved = 2 * nbytes(x) + (0 if r is None else nbytes(r))
            row = {"shape": list(shape), "act": act, "residual": res,
                   **{f"{k}_ms": min(v) for k, v in ms.items()},
                   "back_to_back_ms": back_to_back_ms(fns["kernel"]),
                   "profiler_row_ms": kernel_row_ms(fns["kernel"],
                                                    "bn_act_", ITERS),
                   "chain_row_ms": kernel_row_ms(chain, "", ITERS),
                   **bound(moved + 4 * nbytes(m), 10 * x.numel(),
                           F32_FLOPS)}
            row["share"] = row["bound_ms"] / row["profiler_row_ms"] \
                if row["profiler_row_ms"] else None
            rows.append(row)
            print(f"bn_act {shape} {act}{' + residual' if res else ''}: "
                  f"kernel {ms['kernel']} ms ({row['back_to_back_ms']:.4f} "
                  f"back to back, {row['profiler_row_ms']} by the "
                  f"profiler), plain {ms['plain']} ms, eager chain "
                  f"{ms['chain']} ms ({row['chain_row_ms']} by the "
                  f"profiler), bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}) {tag}")
    print(json.dumps({"bn_act": rows}))
    return rows


def painted_batch(gen, device, batch: int, size: int,
                  n_boxes: int = TRAIN_BOXES):
    """A training batch on the card: dim noise frames (B, S, S, 3) f32 with
    bright rectangles where the valid boxes are, boxes (B, N, 4) normalized
    xyxy, and a mask with 1 to N valid boxes per image."""
    import torch
    from uavdet_tpu_torch.utils.datatypes import BatchData
    wh = size * (0.04 + 0.3 * torch.rand((batch, n_boxes, 2), generator=gen,
                                         device=device))
    lo = torch.rand((batch, n_boxes, 2), generator=gen, device=device) \
        * (size - wh)
    boxes = torch.cat([lo, lo + wh], dim=-1) / size
    n_valid = torch.randint(1, n_boxes + 1, (batch, 1), generator=gen,
                            device=device)
    mask = torch.arange(n_boxes, device=device)[None] < n_valid
    image = 0.3 * torch.rand((batch, size, size, 3), generator=gen,
                             device=device)
    pix = (torch.arange(size, device=device) + 0.5) / size
    for i in range(n_boxes):
        b = boxes[:, i]
        inside = ((pix[None, :, None] >= b[:, 1, None, None])
                  & (pix[None, :, None] < b[:, 3, None, None])
                  & (pix[None, None, :] >= b[:, 0, None, None])
                  & (pix[None, None, :] < b[:, 2, None, None])
                  & mask[:, i, None, None])
        image = torch.where(inside[..., None], 0.8, image)
    return BatchData(image=image, boxes=boxes, box_mask=mask)


def as_dict(ns):
    """A SimpleNamespace of hyper-parameters (nested) as plain dicts, for a
    ``Config``."""
    from types import SimpleNamespace
    if isinstance(ns, SimpleNamespace):
        return {k: as_dict(v) for k, v in vars(ns).items()}
    return ns


class BatchList:
    """A fixed list of batches with ``len()``: the trainer's data."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def conv_dtype_hooks(model):
    """Record the output dtype of every Conv2d and DyConvModule called."""
    import torch
    from uavdet_tpu_torch.models.layers import DyConvModule
    seen, handles = [], []
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, DyConvModule)):
            handles.append(m.register_forward_hook(
                lambda mod, args, out: seen.append(out.dtype)))
    return seen, handles


class RTMAndMosaic:
    """Phases 7l (RTMUAVDet serving at cfg4's shape), 7m (its training at
    cfg5's), 7n (the mosaic path), their timing in phase 8 and their
    profiles in phase 9."""

    def __init__(self, smoke, dev, gen, tag):
        self.smoke, self.dev, self.gen, self.tag = smoke, dev, gen, tag
        self.inputs = {}

    def frames(self, batch, hw):
        import torch
        return torch.randint(0, 256, (batch, *hw, 3), dtype=torch.uint8,
                             device=self.dev, generator=self.gen)

    def targets(self, batch, size):
        """One xyxy pixel box per frame, (B, 1, 4) float32."""
        import torch
        wh = size * (0.06 + 0.25 * torch.rand(
            (batch, 1, 2), generator=self.gen, device=self.dev))
        lo = torch.rand((batch, 1, 2), generator=self.gen,
                        device=self.dev) * (size - wh)
        return torch.cat([lo, lo + wh], dim=-1)

    def serving(self):
        """7l: full-width RTMUAVDet, bf16, seeded weights, 3 requests of
        uint8 frames through make_rtm_detector; NMS once per request, no
        other kernel; against the plain path (nms_alive_plain)."""
        import torch
        from uavdet_tpu_torch import kernels
        from uavdet_tpu_torch.inference import (make_rtm_detector,
                                                preprocess, rtm_candidates)
        from uavdet_tpu_torch.inference import _topk_wide
        from uavdet_tpu_torch.models.rtm_uav_det import rtm_det_scales
        from uavdet_tpu_torch.ops.nms import nms_alive_plain
        from uavdet_tpu_torch.utils.seeding import seeded_rtm_model
        smoke, dev = self.smoke, self.dev
        t0 = time.perf_counter()
        model = seeded_rtm_model(SEED, RTM_SIZE, dev)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"model: RTMUAVDet full width, {n_params} parameters, "
              f"{model.dtype}, seed {SEED}, built in "
              f"{time.perf_counter() - t0:.1f} s")
        smoke.check("RTMUAVDet parameters", n_params == RTM_PARAMS,
                    f"{n_params} (the flax init has {RTM_PARAMS})")
        scales = rtm_det_scales(RTM_SIZE)
        detect = make_rtm_detector(model, RTM_SIZE, scales)
        with torch.inference_mode():
            requests = [self.frames(RTM_BATCH, (RTM_SIZE, RTM_SIZE))
                        for _ in range(REQUESTS)]
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            results = [detect(r) for r in requests]
            torch.cuda.synchronize()
            count_launches(smoke, kernels, "RTMUAVDet", REQUESTS)
            check_requests(smoke, results, RTM_BATCH)
            outs = model(preprocess(requests[0], RTM_SIZE, model.dtype))
            shapes = [tuple(o.obj.shape) for o in outs]
            smoke.check("RTMUAVDet heads", shapes == [
                (RTM_BATCH, 3, s, s, 1) for s in scales] and all(
                    o.obj.dtype == o.bbox.dtype == torch.float32
                    for o in outs), f"{shapes}")
            plain = make_rtm_detector(model, RTM_SIZE, scales,
                                      alive_fn=nms_alive_plain)(requests[0])
            compare_detections(smoke, results[0], plain,
                               name="RTMUAVDet detections vs plain path")
            print(f"  boxes vs the plain path: valid equal "
                  f"{torch.equal(results[0].valid, plain.valid)}, max |diff|"
                  f" {float((results[0].boxes - plain.boxes).abs().max())}"
                  " px")
            # kernel C's input on this path: the sorted top 512
            boxes, scores = rtm_candidates(outs, RTM_SIZE, scales)
            top_s, top_i = _topk_wide(scores, 512)
            top_b = torch.gather(boxes, 1, top_i[..., None].expand(
                *top_i.shape, 4))
            order = torch.argsort(-top_s, dim=1, stable=True)
            self.inputs["nms"] = torch.gather(
                top_b, 1, order[..., None].expand(*order.shape, 4)
            ).contiguous()
        self.inputs["detect"] = (detect, requests[0])
        top = float(plain.scores.max())
        print(f"RTMUAVDet detections: valid per image "
              f"{results[0].valid.sum(1).tolist()}, top score {top:.4f}")

    def training(self):
        """7m: cfg5, 4 Adam steps of full-width RTMUAVDet at 640 px, batch
        8, bf16 autocast over float32 parameters; then the 64 px model in
        float32 on the card against the CPU, 3 steps (dropout off: the
        CPU's and the card's generators differ)."""
        import torch
        from uavdet_tpu_torch import kernels
        from uavdet_tpu_torch.models.rtm_uav_det import (Dropout,
                                                         rtm_det_scales)
        from uavdet_tpu_torch.training.rtm import (make_rtm_train_step,
                                                   rtm_optimizer)
        from uavdet_tpu_torch.utils.seeding import seeded_rtm_model
        smoke, dev = self.smoke, self.dev
        bf16 = torch.bfloat16
        model = seeded_rtm_model(SEED, RTM_SIZE, dev, torch.float32)
        scales = rtm_det_scales(RTM_SIZE)
        step = make_rtm_train_step(model, rtm_optimizer(model), RTM_SIZE,
                                   scales, bf16)
        data = [(self.frames(RTM_BATCH, (RTM_SIZE, RTM_SIZE)),
                 self.targets(RTM_BATCH, RTM_SIZE))
                for _ in range(RTM_TRAIN_STEPS)]
        before = [p.detach().clone() for p in model.parameters()]
        seen, handles = conv_dtype_hooks(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses = [step(x, t) for x, t in data]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "RTMUAVDet train step",
                       RTM_TRAIN_STEPS)
        for h in handles:
            h.remove()
        losses = [float(v) for v in losses]
        moved = max(float((p.detach() - q).abs().max())
                    for p, q in zip(model.parameters(), before))
        smoke.check("RTMUAVDet train losses finite and parameters moved",
                    all(np.isfinite(losses)) and moved > 0
                    and step.state.step == RTM_TRAIN_STEPS,
                    f"{losses}, max |change| {moved:.3g}, "
                    f"{step.state.step} updates")
        smoke.check("RTMUAVDet train convs run in bf16",
                    len(seen) > 0 and set(seen) == {bf16},
                    f"{len(seen)} conv outputs, dtypes {set(seen)}")
        print(f"peak device memory of {RTM_TRAIN_STEPS} cfg5 steps "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"{self.tag}")
        self.inputs["train"] = (step, data[0])

        gen_cpu = torch.Generator().manual_seed(SEED)
        size = RTM_PARITY_SIZE
        batches = [(torch.randint(0, 256, (RTM_PARITY_BATCH, size, size, 3),
                                  dtype=torch.uint8, generator=gen_cpu),
                    torch.tensor([[[8.0, 10.0, 30.0, 34.0]],
                                  [[20.0, 4.0, 50.0, 28.0]]]))
                   for _ in range(RTM_PARITY_STEPS)]

        def losses(where):
            m = seeded_rtm_model(SEED, size, where, torch.float32)
            for mod in m.modules():
                if isinstance(mod, Dropout):
                    mod.p = 0.0
            st = make_rtm_train_step(m, rtm_optimizer(m), size,
                                     rtm_det_scales(size), torch.float32)
            return np.array([float(st(x.to(where), t.to(where)))
                             for x, t in batches])

        # cuDNN's deterministic algorithms: Adam makes a full step of any
        # gradient at the float noise floor, so three steps carry the
        # reassociation of a nondeterministic backward into the losses;
        # the default algorithms' run is printed beside
        torch.backends.cudnn.deterministic = True
        try:
            kernels.reset_launch_counts()
            got = {"card": losses(dev)}
            count_launches(smoke, kernels, "RTMUAVDet float32 train step",
                           RTM_PARITY_STEPS)
        finally:
            torch.backends.cudnn.deterministic = False
        got["cpu"] = losses(torch.device("cpu"))
        default = losses(dev)
        print("  with cuDNN's default algorithms, relative to the CPU: "
              f"{(np.abs(default - got['cpu']) / got['cpu']).tolist()}")
        rel = np.abs(got["card"] - got["cpu"]) / np.abs(got["cpu"])
        smoke.check("RTMUAVDet float32 train steps, card vs CPU",
                    bool((rel < PARITY_RTOL).all()),
                    f"card {got['card'].tolist()} cpu {got['cpu'].tolist()}"
                    f" relative {rel.tolist()} (rtol {PARITY_RTOL})")

    def mosaic(self, data_dir, data_config, host_cls, pipeline_fps):
        """7n: the Lanczos-4 resize on the card against the CPU; the mosaic
        train pipeline over 7j's tree on the card against the same on the
        CPU (frames decoded by nvJPEG, copied to the host: ``host_cls``);
        the pipelines' frames per second with mosaic on and off, in turns;
        ``train.main`` with ``dataset.mosaic`` on, on its default device."""
        import os
        import torch
        from uavdet_tpu_torch import kernels
        from uavdet_tpu_torch import train as train_entry
        from uavdet_tpu_torch.data import DataPipeline, load_manifest
        from uavdet_tpu_torch.ops.resize import lanczos4_resize
        from uavdet_tpu_torch.utils.config import Config
        smoke, dev = self.smoke, self.dev
        readings = {"lanczos4_ms": {}}
        for src, dst in LANCZOS_CASES:
            x = self.frames(1, src)[0]
            got = lanczos4_resize(x, *dst)
            want = lanczos4_resize(x.cpu(), *dst)
            diff = int((got.cpu().int() - want.int()).abs().max())
            smoke.check(f"lanczos4_resize {src} -> {dst}: card vs CPU",
                        torch.equal(got.cpu(), want) and got.is_cuda
                        == (dev.type == "cuda"), f"max |diff| {diff} units "
                        "(bitwise: integer sums in float64)")
            xs = self.frames(4 * TRAIN_BATCH, src)
            ms = cuda_ms(lambda: lanczos4_resize(xs, *dst), 10, 2)
            readings["lanczos4_ms"][f"{src}->{dst}"] = ms
            print(f"lanczos4_resize of {4 * TRAIN_BATCH} uint8 frames "
                  f"{src} -> {dst} (a mosaic batch's sources): {ms:.3f} ms "
                  f"{self.tag}")
        here = os.getcwd()
        os.chdir(data_dir)
        try:
            cfg = data_config()
            recs = load_manifest(cfg.dataset.train_loader_path)
            kw = dict(input_size=SIZE, batch_size=TRAIN_BATCH, train=True,
                      seed=11, workers=DATA_WORKERS, mosaic=True)
            kernels.reset_launch_counts()
            card = list(DataPipeline(recs, device=dev, **kw))
            count_launches(smoke, kernels, "mosaic pipeline", len(card))
            host = list(host_cls(recs, device="cpu", **kw))
            same = len(card) == len(host) > 0 and all(
                torch.equal(c.box_mask.cpu(), h.box_mask)
                and torch.equal(c.boxes.cpu(), h.boxes)
                for c, h in zip(card, host))
            n_boxes = [int(c.box_mask.sum()) for c in card]
            smoke.check("mosaic pipeline: membership, masks and boxes, card "
                        "vs CPU, bitwise", same and max(n_boxes) > TRAIN_BATCH,
                        f"{len(card)} / {len(host)} batches of {TRAIN_BATCH},"
                        f" boxes per batch {n_boxes}")
            d = [(torch.round(c.image.cpu() * 255)
                  - torch.round(h.image * 255)).abs() for c, h in
                 zip(card, host)]
            diff = max(float(x.max()) for x in d)
            mean = float(np.mean([float(x.mean()) for x in d]))
            smoke.check("mosaic frame stage: card vs CPU",
                        diff <= FRAME_TOL_UNITS, f"max |diff| {diff:.0f} "
                        f"units of 255 (limit {FRAME_TOL_UNITS}), mean "
                        f"{mean:.4f}")
            fps = {"mosaic": [], "plain": []}
            for which in ("mosaic", "plain", "plain", "mosaic"):
                fps[which].append(pipeline_fps(
                    recs, True, TRAIN_BATCH, DATA_WORKERS,
                    mosaic=which == "mosaic")[0])
            readings["train_pipeline_frames_per_s"] = fps
            print(f"train pipeline alone, batch {TRAIN_BATCH}, "
                  f"{DATA_WORKERS} workers, frames/s in turns: mosaic "
                  f"{[round(v, 1) for v in fps['mosaic']]}, plain "
                  f"{[round(v, 1) for v in fps['plain']]} {self.tag}")
            conf = cfg.to_dict()
            conf["dataset"]["mosaic"] = True
            conf["train"]["checkpoint"]["dir"] = "logs/checkpoints_mosaic"
            pipe, _ = train_entry.build_pipelines(Config(conf), "cuda")
            kernels.reset_launch_counts()
            final = train_entry.main(Config(conf), [])
            torch.cuda.synchronize()
            count_launches(smoke, kernels, "train entry point DyYOLO, mosaic",
                           TRAIN_VAL_BATCHES)
            smoke.check("train entry point with dataset.mosaic: true",
                        pipe.mosaic and np.isfinite(final["val_loss"])
                        and final["val_AP"] >= 0
                        and os.path.exists("logs/checkpoints_mosaic/last"),
                        f"{final}")
        finally:
            os.chdir(here)
        self.inputs["mosaic"] = readings

    def timing(self):
        """Phase 8's RTMUAVDet rows: the detector per batch, kernel C at
        its input on this path (8, 512) beside its plain version, and cfg5
        per step."""
        import torch
        from uavdet_tpu_torch.ops.nms import nms_alive, nms_alive_plain
        out = {}
        detect, x = self.inputs["detect"]
        with torch.inference_mode():
            ms = cuda_ms(lambda: detect(x))
        out["detector"] = {"ms_per_batch": ms, "fps": RTM_BATCH * 1e3 / ms,
                           "batch": RTM_BATCH, "size": RTM_SIZE}
        print(f"detector RTMUAVDet @{RTM_SIZE} bs={RTM_BATCH} uint8 -> "
              f"Detections: {ms:.3f} ms/batch, {RTM_BATCH * 1e3 / ms:.1f} "
              f"fps {self.tag}")
        boxes = self.inputs["nms"]
        k1 = cuda_ms(lambda: nms_alive(boxes, 0.5))
        p1 = cuda_ms(lambda: nms_alive_plain(boxes, 0.5))
        k2 = cuda_ms(lambda: nms_alive(boxes, 0.5))
        p2 = cuda_ms(lambda: nms_alive_plain(boxes, 0.5))
        b, n = boxes.shape[:2]
        alive = nms_alive(boxes, 0.5)
        row = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
               "library_ms": None,
               "back_to_back_ms": back_to_back_ms(
                   lambda: nms_alive(boxes, 0.5)),
               "max_abs_err": float(not torch.equal(
                   alive, nms_alive_plain(boxes, 0.5))),
               "shape": [b, n],
               **bound(nbytes(boxes, alive),
                       b * (5 * n + 14 * n * (n - 1) // 2), F32_FLOPS)}
        out["nms"] = row
        print(f"nms on RTMUAVDet's candidates ({b}, {n}): kernel {k1:.4f} / "
              f"{k2:.4f} ms ({row['back_to_back_ms']:.4f} back to back), "
              f"plain {p1:.4f} / {p2:.4f} ms, bound {row['bound_ms']:.5f} "
              f"ms {self.tag}")
        step, (imgs, t) = self.inputs["train"]
        ms = cuda_ms(lambda: step(imgs, t), TRAIN_ITERS, TRAIN_WARMUP)
        out["train"] = {"ms_per_step": ms, "images_per_s":
                        RTM_BATCH * 1e3 / ms, "batch": RTM_BATCH,
                        "size": RTM_SIZE}
        print(f"train RTMUAVDet (cfg5) @{RTM_SIZE} bs={RTM_BATCH} bf16 "
              f"Adam: {ms:.3f} ms/step, {RTM_BATCH * 1e3 / ms:.1f} images/s "
              f"{self.tag}")
        out["mosaic"] = self.inputs.get("mosaic")
        print(json.dumps({"rtm": out}))
        return out

    def profiles(self):
        """(name, fn, batches) of phase 9's windows on these paths."""
        out = []
        if "detect" in self.inputs:
            detect, x = self.inputs["detect"]
            out.append(("RTMUAVDet", lambda: detect(x), 3))
        if "train" in self.inputs:
            step, (imgs, t) = self.inputs["train"]
            out.append(("RTMUAVDet train step cfg5, 2 steps",
                        lambda: [step(imgs, t) for _ in range(2)], 2))
        return out


def run_bench(smoke, repo: str) -> dict:
    """7r: ``python -m uavdet_tpu_torch.bench`` for each cell in a fresh
    process, as a user runs it. Each must exit with 0, print exactly one
    parsable JSON line with a positive value (``vs_baseline`` a positive
    number for the cells with the reference structure, else null) and
    report on stderr the launches its path predicts per timed call.
    -> the parsed lines by cell."""
    import os
    import subprocess
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # the processes share the card with this one
    lines = {}
    t0 = time.perf_counter()
    for case, args in BENCH_CELLS:
        if case not in ("host-data", "fit-rate"):
            args = (*args, *BENCH_TIMED)
        t1 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "uavdet_tpu_torch.bench", *args],
            cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
            capture_output=True, text=True, timeout=BENCH_TIMEOUT)
        seconds = time.perf_counter() - t1
        notes = [ln for ln in res.stderr.splitlines() if ln.startswith("# ")]
        for ln in notes:
            print("  " + ln[:400])
        if res.returncode != 0:
            print(res.stderr[-3000:])
        out = res.stdout.strip().splitlines()
        try:
            line = json.loads(out[0]) if len(out) == 1 else None
        except ValueError:
            line = None
        ok = (res.returncode == 0 and isinstance(line, dict)
              and set(line) == {"metric", "value", "unit", "vs_baseline"}
              and line["unit"] == "fps" and line["value"] > 0)
        if ok:
            vs = line["vs_baseline"]
            ok = ((isinstance(vs, float) and vs > 0)
                  if case in BENCH_WITH_BASELINE else vs is None)
        smoke.check(f"bench {case}", ok, f"rc {res.returncode} in "
                    f"{seconds:.1f} s, stdout {out}")
        reports = [json.loads(ln[len("# launches: "):]) for ln in notes
                   if ln.startswith("# launches: ")]
        smoke.check(f"bench {case} reports its launches",
                    len(reports) == (2 if case == "fit-rate" else 1),
                    f"{len(reports)} launch reports")
        for rep in reports:
            count_launches(smoke, None, f"bench {case}", rep["calls"],
                           counts=rep["counts"])
        if ok:
            lines[case] = line
    print(f"7r: {len(BENCH_CELLS)} bench processes in "
          f"{time.perf_counter() - t0:.1f} s")
    return lines


def run_sections(smoke, model, soem_model) -> dict:
    """7s: ``scripts.roofline_table``, ``scripts.section_probe`` on the
    DyYOLO of phase 6 and ``scripts.cfg3_section_probe`` on the
    DySOEM_SimFPN of phase 7, each through its ``main(argv)`` in this
    process. -> the ``{"sections": ...}`` line's content."""
    import torch
    from uavdet_tpu_torch.scripts import (cfg3_section_probe, roofline_table,
                                          section_probe)
    t0 = time.perf_counter()
    table = roofline_table.main(["--batch", str(BATCH), "--size", str(SIZE)])
    gflop = table["total"]["gflop"]
    smoke.check("roofline_table totals", round(gflop, 1) == ROOFLINE_GFLOP,
                f"{gflop:.1f} GFLOP at ({BATCH}, {SIZE}), the JAX walk's "
                f"{ROOFLINE_GFLOP}")
    stem_floor = table["sections"]["stem"]["floor_ms"]
    a, b = STEM_KERNEL_BOUNDS_MS
    print(f"stem floor {stem_floor:.3f} ms (the walk: bf16 frames in, bf16 "
          f"out) beside kernels A + B's bounds {a} + {b} = {a + b:.3f} ms "
          "(PERF.md section 6: uint8 frames in, and A's channel sums)")
    out = {"roofline": {"gflop": gflop, "floor_ms": table["total"]
                        ["floor_ms"], "stem_floor_ms": stem_floor,
                        "stem_kernel_bounds_ms": a + b}}
    for path, probe, mdl in (
            ("section_probe DyYOLO", section_probe, model),
            ("cfg3_section_probe DySOEM_SimFPN", cfg3_section_probe,
             soem_model)):
        torch.cuda.synchronize()
        rep = probe.main(list(SECTIONS_ARGS), model=mdl)
        smoke.check(f"{path}: sectioned heads bitwise", rep["heads_equal"],
                    "against Detector.heads on the same frames")
        smoke.check(f"{path}: sectioned Detections bitwise",
                    rep["detections_equal"],
                    "against make_detector's detect at its third call "
                    "(replayed as CUDA graphs)")
        count_launches(smoke, None, path, rep["calls"],
                       counts=rep["launches"])
        secs = rep["sections"]
        ratio = rep["sum_over_detect"]
        smoke.check(f"{path}: sum of sections against detect",
                    abs(ratio - 1.0) <= SECTIONS_SUM_TOL,
                    f"{rep['sum_ms']:.3f} ms against {rep['detect_ms']:.3f} "
                    f"back to back, ratio {ratio:.4f} (limit "
                    f"{SECTIONS_SUM_TOL})")
        smoke.check(f"{path}: every section positive, a floor share but "
                    "post's", all(s["ms"] > 0 for s in secs.values())
                    and secs["post"]["floor_ms"] is None
                    and all(s["floor_share"] > 0 for n, s in secs.items()
                            if n != "post"),
                    ", ".join(f"{n} {s['ms']:.3f}" for n, s in secs.items()))
        out[rep["model"]] = {k: rep[k] for k in (
            "batch", "input", "sections", "sum_ms", "device_sum_ms",
            "host_sum_ms", "detect_ms", "detect_windows_ms", "calls",
            "launches")}
    seconds = time.perf_counter() - t0
    smoke.check("7s within its time", seconds < SECTIONS_SECONDS,
                f"{seconds:.1f} s (limit {SECTIONS_SECONDS})")
    out["seconds"] = seconds
    print(json.dumps({"sections": out}))
    return out


def run_probes(smoke, model, tag) -> dict:
    """7t: ``scripts.perf_probe`` on the DyYOLO of phase 6,
    ``scripts.topk_compact_probe`` at ``TOPK_CELLS``,
    ``scripts.chain_slope`` and ``scripts.bblock_probe``, each through its
    ``main(argv)`` in this process. -> the ``{"probes": ...}`` line's
    content."""
    import torch
    from uavdet_tpu_torch.scripts import (bblock_probe, chain_slope,
                                          perf_probe, topk_compact_probe)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    rep = perf_probe.main(list(PERF_PROBE_ARGS), model=model)
    for row, got in rep["launches"].items():
        count_launches(smoke, None, f"perf_probe {row}", got["calls"],
                       counts=got["counts"])
    compare_detections(smoke, *rep["detections"],
                       name="perf_probe: detect (stem kernels) vs detect "
                       "(no stem kernels)")
    smoke.check("perf_probe: the post variants keep the same scores",
                rep["post_equal"], "full-grid and logit-topk decode, kept "
                "scores sorted, bitwise")
    rows, layers = rep["rows"], rep["layers"]
    smoke.check("perf_probe: every row, and the JAX walk's layer rows",
                len(rows) == 8 and len(layers) == PERF_PROBE_LAYERS
                and all(v > 0 for v in [*rows.values(), *layers.values()]),
                f"{len(rows)} rows, {len(layers)} layer rows (expected 8 "
                f"and {PERF_PROBE_LAYERS}), the least "
                f"{min([*rows.values(), *layers.values()]):.4g} ms")
    tail = rows["tail (all layers after stem)"]
    print(f"perf_probe: sum of layers {rep['sum_of_layers_ms']:.3f} ms "
          f"beside tail (all layers after stem) {tail:.3f} ms {tag}")
    out = {"perf_probe": {"rows": rows, "layers": layers,
                          "sum_of_layers_ms": rep["sum_of_layers_ms"],
                          "detect": rep["detect_detail"]}}
    for cell, args in TOPK_CELLS:
        r = topk_compact_probe.main([*args, *TOPK_ITERS])
        smoke.check(f"topk_compact_probe {cell}: value agreement",
                    r["agree"] is True and all(v > 0 for v in
                                               r["rows"].values()),
                    f"{r['agree']}, above tau per image {min(r['above'])} "
                    f"to {max(r['above'])} of cap {r['cap']}; rows "
                    f"{r['rows']}")
        out[f"topk {cell}"] = {k: r[k] for k in ("rows", "agree", "batch",
                                                 "n", "k", "cap")}
        out[f"topk {cell}"]["above"] = [min(r["above"]), max(r["above"])]
    for name, probe in (("chain_slope", chain_slope),
                        ("bblock_probe", bblock_probe)):
        r = probe.main([])
        smoke.check(f"{name}: every row positive",
                    all(v > 0 for v in r["rows"].values()),
                    f"{len(r['rows'])} rows")
        out[name] = {k: v for k, v in r.items() if k != "device"}
    err = out["bblock_probe"]["s2d_rel_err"]
    smoke.check("bblock_probe: conv3 via s2d against conv3", err < S2D_REL_TOL,
                f"relative max error {err:.3g} (limit {S2D_REL_TOL})")
    seconds = time.perf_counter() - t0
    smoke.check("7t within its time", seconds < PROBES_SECONDS,
                f"{seconds:.1f} s (limit {PROBES_SECONDS})")
    out["seconds"] = seconds
    print(json.dumps({"probes": out}))
    return out


def md_f32_losses(hp, batches, dev, mesh=None, fsdp=None):
    """Float32 losses of the tiny DyYOLO over ``batches`` (global CPU
    batches; on a mesh each rank takes its rows), grad_batches 2."""
    import torch
    from uavdet_tpu_torch.parallel import (local_batch_rows,
                                           shard_host_batch, shard_model)
    from uavdet_tpu_torch.training import (build_optimizer, init_state,
                                           make_train_step)
    from uavdet_tpu_torch.utils.seeding import seeded_model
    model = seeded_model("DyYOLO", hp, SEED, dev, dtype=torch.float32)
    placed = model if mesh is None else shard_model(model, mesh, fsdp)
    state = init_state(placed, *build_optimizer(placed.parameters(), hp))
    step = make_train_step(placed, hp, PARITY_SIZE, grad_batches=2,
                           mesh=mesh)
    losses = []
    for b in batches:
        if mesh is not None:
            b = shard_host_batch(b, local_batch_rows(mesh, len(b.image)))
        losses.append(float(step(state, type(b)(*(t.to(dev) for t in b)))
                            ["loss"]))
    return losses


def md_ms(fn, dev, iters: int, warmup: int) -> float:
    """Median ms of one call: CUDA events on the card, the host's clock
    where a rehearsal runs on the CPU."""
    if dev.type == "cuda":
        from uavdet_tpu_torch.utils.timing import cuda_ms
        return cuda_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def md_sync(dev, peak_reset: bool = False) -> float:
    """Wait for the card (and reset its peak memory); -> the peak GiB since
    the last reset (0 on the CPU)."""
    import torch
    if dev.type != "cuda":
        return 0.0
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if peak_reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return peak


def md_cfg6(hp, size, dev, mesh, batches, fsdp=None, iters=MD_ITERS,
            warmup=MD_WARMUP) -> dict:
    """cfg6 (``hp``: full-width DyYOLO; 640 px, grad_batches 2, bf16
    autocast) placed on ``mesh`` over ``batches`` (this rank's rows): the
    losses of the first updates, the launches, ms per microbatch (the
    median over updates, halved) and the peak device memory."""
    import torch
    from uavdet_tpu_torch import kernels
    from uavdet_tpu_torch.parallel import shard_model
    from uavdet_tpu_torch.training import (build_optimizer, init_state,
                                           make_train_step)
    from uavdet_tpu_torch.utils.seeding import seeded_model
    model = seeded_model("DyYOLO", hp, SEED, dev, dtype=torch.float32)
    placed = shard_model(model, mesh, fsdp)
    state = init_state(placed, *build_optimizer(placed.parameters(), hp))
    step = make_train_step(placed, hp, size, compute_dtype=torch.bfloat16,
                           grad_batches=TRAIN_GRAD_BATCHES, mesh=mesh)
    md_sync(dev, peak_reset=True)
    kernels.reset_launch_counts()
    losses = [float(step(state, b)["loss"]) for b in batches]
    md_sync(dev)
    counts = kernels.launch_counts()

    def update_pair():
        for b in batches[:2]:
            step(state, b)

    ms = md_ms(update_pair, dev, iters // 2, warmup // 2) / 2
    out = {"losses": losses, "counts": counts, "ms_per_microbatch": ms,
           "rows": len(batches[0].image), "step": state.step,
           "peak_gib": md_sync(dev)}
    from uavdet_tpu_torch.parallel import expert_params, unwrap
    slices = expert_params(unwrap(placed))
    if slices:   # ep: the slices this rank holds, the bytes its DyConvs move
        rows = out["rows"]
        out["expert_bytes"] = sum(p.numel() * p.element_size()
                                  for p in slices)
        out["dyconv_bytes"] = ep_bytes(unwrap(placed), rows,
                                       rows * mesh["ep"].size())
    del model, placed, state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def ep_bytes(model, rows: int, group_rows: int) -> dict:
    """Bytes of one forward's collectives of each ``ep``-sliced module on a
    rank (``rows`` its rows, ``group_rows`` its ``ep`` group's), from the
    shapes: the attentions' all-gather and the partial kernels' all-reduce
    (``parallel/experts.py:mix_slices``; the backward moves the same again),
    beside one all-gather of the slices into the whole stacks. A tensor's
    bytes, not a ring's traffic."""
    out = {}
    for name, m in model.named_modules():
        sl = [p for p in m.parameters(recurse=False)
              if getattr(p, "ep_slice", None) is not None]
        if not sl:
            continue
        info, size = sl[0].ep_slice, sl[0].element_size()
        kernel = sum(p.numel() // (info.hi - info.lo) * info.n_out
                     for p in sl)
        out[name] = {
            "attention_all_gather": info.n * max(rows, 1) * info.n_experts
            * 4,
            "partial_kernels_all_reduce": group_rows * kernel * size,
            "slices_all_gather": sum(int(np.prod(p.ep_slice.full_shape))
                                     for p in sl) * size}
    return out


def md_bn_cost(hp, size, dev, mesh, batches) -> dict:
    """cfg6 DDP on ``mesh`` (one rank) with every BatchNorm on its own path
    and through ``parallel.global_batch_norm`` (the eager float64 moments,
    its autograd Function and two all-reduces of one rank), in turns: ms per
    microbatch, the median over updates, halved."""
    import torch
    from uavdet_tpu_torch.models import layers
    from uavdet_tpu_torch.parallel import global_batch_norm, shard_model
    from uavdet_tpu_torch.training import (build_optimizer, init_state,
                                           make_train_step)
    from uavdet_tpu_torch.utils.seeding import seeded_model
    model = seeded_model("DyYOLO", hp, SEED, dev, dtype=torch.float32)
    placed = shard_model(model, mesh, False)
    state = init_state(placed, *build_optimizer(placed.parameters(), hp))
    step = make_train_step(placed, hp, size, compute_dtype=torch.bfloat16,
                           grad_batches=TRAIN_GRAD_BATCHES, mesh=mesh)
    own = layers.BatchNorm2d.forward

    def global_forward(self, x):
        if self.training:
            return global_batch_norm(x, self)
        return own(self, x)

    def update_pair():
        for b in batches[:2]:
            step(state, b)

    out = {"own": [], "global_batch_norm": []}
    try:
        for which in ("own", "global_batch_norm", "global_batch_norm",
                      "own"):
            layers.BatchNorm2d.forward = (own if which == "own"
                                          else global_forward)
            out[which].append(md_ms(update_pair, dev, MD_ITERS // 2,
                                    MD_WARMUP // 2) / 2)
    finally:
        layers.BatchNorm2d.forward = own
    del model, placed, state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def md_bn_layer(dev, group) -> dict:
    """One BatchNorm's forward and backward (bf16 autocast, channels_last)
    at cfg6's largest and smallest-plane inputs: the port's own path,
    ``global_batch_norm``, and PyTorch's ``SyncBatchNorm`` autograd Function
    (the library's synced BatchNorm, timed here only), both on the
    one-rank ``group``, in turns: the host's ms to queue one call with the
    card kept busy, and the wall ms per call, over MD_BN_CALLS calls."""
    import torch
    from torch.nn.modules._functions import SyncBatchNorm
    from uavdet_tpu_torch.models import layers
    from uavdet_tpu_torch.parallel import global_batch_norm
    out = {}
    for shape in ((TRAIN_BATCH, 32, SIZE, SIZE),
                  (TRAIN_BATCH, 512, SIZE // 32, SIZE // 32)):
        c = shape[1]
        x = torch.randn(shape, device=dev, dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        dy = torch.randn_like(x)
        own = layers.BatchNorm2d(c).to(dev)
        ours = layers.BatchNorm2d(c).to(dev)
        ours.process_group = group
        ref = torch.nn.BatchNorm2d(c).to(dev)
        ways = {"own": lambda: own(x),
                "global_batch_norm": lambda: global_batch_norm(x, ours),
                "SyncBatchNorm": lambda: SyncBatchNorm.apply(
                    x, ref.weight, ref.bias, ref.running_mean,
                    ref.running_var, ref.eps, ref.momentum, group, 1)}
        times = {k: {"host_ms": [], "wall_ms": []} for k in ways}
        for name in (*ways, *reversed(ways)):
            def call():
                with torch.autocast(dev.type, torch.bfloat16):
                    y = ways[name]()
                y.backward(dy)
            for _ in range(5):
                call()
            md_sync(dev)
            t0 = time.perf_counter()
            for _ in range(MD_BN_CALLS):
                call()
            t1 = time.perf_counter()
            md_sync(dev)
            t2 = time.perf_counter()
            times[name]["host_ms"].append((t1 - t0) * 1e3 / MD_BN_CALLS)
            times[name]["wall_ms"].append((t2 - t0) * 1e3 / MD_BN_CALLS)
        out["x".join(map(str, shape))] = times
    return out


def md_rank_job(spec: dict) -> dict:
    """One of the two ranks of phase 7o (b), sharing the card over gloo:
    the float32 DDP step, cfg6 DDP, the sharded detect and Trainer.fit with
    multihost over 7j's tree (run in its working directory)."""
    import torch
    import torch.distributed as dist
    from uavdet_tpu_torch import kernels
    from uavdet_tpu_torch.inference import make_detector
    from uavdet_tpu_torch.parallel import (local_batch_rows, local_device,
                                           make_mesh, shard_host_batch)
    from uavdet_tpu_torch.train import build_pipelines
    from uavdet_tpu_torch.training import MetricsWriter, Trainer
    from uavdet_tpu_torch.utils.config import Config
    from uavdet_tpu_torch.utils.seeding import seeded_model
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = local_device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(MD_RANKS, device_type=dev.type)
    rank = dist.get_rank()
    out = {"rank": rank, "device": str(dev), "backend": dist.get_backend()}
    out["f32_losses"] = md_f32_losses(spec["tiny_hp"], spec["parity"], dev,
                                      mesh)

    hp, size, batch = spec["hp"], spec["size"], spec["train_batch"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = local_batch_rows(mesh, batch)
    batches = [shard_host_batch(painted_batch(gen, dev, batch, size), rows)
               for _ in range(4)]
    out["cfg6"] = md_cfg6(hp, size, dev, mesh, batches)

    model = seeded_model("DyYOLO", hp, SEED, dev)
    detect = make_detector(model, hp, size, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(MD_FRAMES_SEED)
    frames = torch.randint(0, 256, (spec["detect_batch"], size, size, 3),
                           dtype=torch.uint8, device=dev, generator=gen)
    detect(frames)
    md_sync(dev)
    kernels.reset_launch_counts()
    results = [detect(frames) for _ in range(REQUESTS)]
    md_sync(dev)
    out["detect_counts"] = kernels.launch_counts()
    out["detect"] = [t.cpu() for t in results[0]]
    out["detect_ms"] = md_ms(lambda: detect(frames), dev, 10, 2)
    del model, detect, results
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    cfg = Config(spec["trainer_config"])
    train_pipe, val_pipe = build_pipelines(cfg, dev)
    reads = []
    read = train_pipe._read

    def counted(path):
        reads.append(path)
        return read(path)

    train_pipe._read = counted
    trainer = Trainer(cfg, train_pipe, val_pipe,
                      metrics=MetricsWriter(f"dvclive_md{rank}"), device=dev)
    kernels.reset_launch_counts()
    final = trainer.fit()
    md_sync(dev)
    out["fit"] = {"final": {k: v for k, v in final.items()
                            if isinstance(v, float)},
                  "counts": kernels.launch_counts(), "reads": reads,
                  "local_rows": sorted(train_pipe.local_rows or ()),
                  "step": trainer.state.step}
    return out


def md_fsdp_job(spec: dict) -> list:
    """The float32 FSDP2 step of the tiny DyYOLO on the two ranks."""
    import torch
    from uavdet_tpu_torch.parallel import local_device, make_mesh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = local_device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return md_f32_losses(spec["tiny_hp"], spec["parity"], dev,
                         make_mesh(1, MD_RANKS, device_type=dev.type))


class _Recorder:
    """An executor for ``DataPipeline._plan_local`` that records the paths
    it is asked to decode, in batch-row order, and decodes none (the
    headers it reads)."""

    def __init__(self):
        self.paths = []

    def submit(self, fn, path, *args):
        from concurrent.futures import Future
        f = Future()
        if fn.__name__ == "_load":
            self.paths.append(path)
            f.set_result(None)
        else:
            f.set_result(fn(path, *args))
        return f


class MultiDevice:
    """Phase 7o: (a) the DDP and FSDP2 steps in a one-process NCCL group,
    against the single-device step; (b) two processes sharing the card over
    gloo: the float32 DDP step (and FSDP2 where gloo carries its collectives
    on CUDA tensors) against one process, cfg6 DDP, the sharded detect
    against the one-process detect, ``Trainer.fit`` with ``devices: 2`` and
    ``multihost: true`` over 7j's tree; (c) the times, as one
    ``{"multi_device": ...}`` line."""

    def __init__(self, smoke, dev, tag, tiny_hp, hp, size=SIZE,
                 train_batch=TRAIN_BATCH, detect_batch=BATCH):
        self.smoke, self.dev, self.tag, self.tiny_hp = smoke, dev, tag, \
            tiny_hp
        self.hp, self.size = hp, size
        self.train_batch, self.detect_batch = train_batch, detect_batch
        self.report = {"card_sharing": "two ranks sharing one card (gloo); "
                       "not a scaling number"}
        self._single = None

    @property
    def single(self):
        """The float32 losses of the single-device step on the card."""
        if self._single is None:
            self._single = md_f32_losses(self.tiny_hp, self.parity_batches(),
                                         self.dev)
        return self._single

    def parity_batches(self):
        import torch
        gen = torch.Generator().manual_seed(SEED + 2)
        out = []
        for _ in range(PARITY_MICRO):
            b = painted_batch(gen, "cpu", MD_PARITY_BATCH, PARITY_SIZE, 2)
            out.append(b._replace(image=torch.rand(b.image.shape,
                                                   generator=gen)))
        return out

    def one_process(self, train_batches, single_step):
        """(a) ``train_batches``: 7f's cfg6 batches; ``single_step``: 7f's
        (state, step), timed beside the placed steps."""
        import os
        import tempfile
        import torch
        import torch.distributed as dist
        from uavdet_tpu_torch.parallel import backend_for, make_mesh
        smoke, dev = self.smoke, self.dev
        parity = self.parity_batches()
        state, step = single_step

        def single_pair():
            for b in train_batches[:2]:
                step(state, b)

        md_sync(dev, peak_reset=True)
        single_ms = md_ms(single_pair, dev, MD_ITERS // 2,
                          MD_WARMUP // 2) / 2
        readings = {"single_device_ms_per_microbatch": single_ms}
        tmp = tempfile.mkdtemp(prefix="chip_smoke_md_")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend_for(dev, 1),
            store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
            world_size=1)
        try:
            mesh = make_mesh(1, device_type=dev.type)
            for name, fsdp in (("ddp", False), ("fsdp2", True)):
                got = md_f32_losses(self.tiny_hp, parity, dev, mesh, fsdp)
                rel = float(np.max(np.abs(np.subtract(got, self.single))
                                   / np.abs(self.single)))
                smoke.check(f"one-process NCCL {name} float32 step vs "
                            "single device", rel < MD_ONE_RTOL,
                            f"losses {got} vs {self.single}, relative "
                            f"{rel:.3g} (rtol {MD_ONE_RTOL})")
                r = md_cfg6(self.hp, self.size, dev, mesh,
                            train_batches[:4], fsdp)
                count_launches(smoke, None, "DyYOLO train step, placed on a "
                               "mesh", 4, counts=r["counts"])
                smoke.check(f"one-process NCCL {name} cfg6 bf16 losses "
                            "finite", bool(np.isfinite(r["losses"]).all())
                            and r["step"] > 0, f"{r['losses']}")
                readings[f"nccl_one_process_{name}"] = {
                    k: r[k] for k in ("ms_per_microbatch", "peak_gib",
                                      "losses")}
                print(f"cfg6 {name} in a one-process NCCL group: "
                      f"{r['ms_per_microbatch']:.3f} ms/microbatch "
                      f"(single device {single_ms:.3f}), peak "
                      f"{r['peak_gib']:.2f} GiB {self.tag}")
            bn = md_bn_cost(self.hp, self.size, dev, mesh, train_batches[:2])
            readings["cfg6_ddp_batch_norm_ms_per_microbatch"] = bn
            print("cfg6 DDP in a one-process NCCL group, ms/microbatch in "
                  f"turns: BatchNorm's own path {bn['own']}, through "
                  f"global_batch_norm {bn['global_batch_norm']} {self.tag}")
            layer = md_bn_layer(dev, dist.group.WORLD)
            readings["batch_norm_layer_ms"] = layer
            print("one BatchNorm forward + backward in a one-process NCCL "
                  f"group (host ms to queue, wall ms): {json.dumps(layer)} "
                  f"{self.tag}")
        finally:
            dist.destroy_process_group()
        self.report["one_process"] = readings

    def local_rows_pipeline(self, recs, order, seed):
        """The train pipeline through ``set_local_rows`` on the card: with
        every row, bitwise the plain pipeline; with rank 0's rows, it
        decodes those rows' files alone; batches/s of rank 0's rows beside
        the plain pipeline's, in turns (the headers of every frame are read
        on both sides of a rank's step)."""
        import torch
        from uavdet_tpu_torch.data import DataPipeline
        smoke, dev, tb = self.smoke, self.dev, self.train_batch
        rows0 = set(range(tb // MD_RANKS))

        def pipe(rows):
            p = DataPipeline(recs, self.size, tb, train=True, seed=seed,
                             workers=DATA_WORKERS, device=dev)
            if rows is not None:
                p.set_local_rows(rows)
            return p

        plain, local = list(pipe(None)), list(pipe(range(tb)))
        smoke.check("set_local_rows with every row: the plain pipeline, "
                    "bitwise", len(plain) == len(local) > 0 and all(
                        all(torch.equal(a, b) for a, b in zip(p, q))
                        for p, q in zip(plain, local)),
                    f"{len(local)} / {len(plain)} batches of {tb}")
        p0 = pipe(rows0)
        reads = []
        read = p0._read
        p0._read = lambda path: (reads.append(path), read(path))[1]
        got = list(p0)
        mine = [q for i, q in enumerate(order) if i % tb in rows0]
        smoke.check("set_local_rows of rank 0's rows: its rows of the plain "
                    "pipeline, its rows' files alone",
                    sorted(reads) == sorted(mine) and all(
                        all(torch.equal(a, b[:len(rows0)])
                            for a, b in zip(g, p))
                        for g, p in zip(got, plain)),
                    f"{len(reads)} files read, {len(mine)} in its rows")

        def batches_per_s(rows):
            p = pipe(rows)
            list(p)
            md_sync(dev)
            t0, n = time.perf_counter(), 0
            for _ in range(DATA_EPOCHS):
                n += sum(1 for _ in p)
            md_sync(dev)
            return n / (time.perf_counter() - t0)

        bps = {"plain": [], "rank0_rows": []}
        for which in ("plain", "rank0_rows", "rank0_rows", "plain"):
            bps[which].append(batches_per_s(rows0 if which == "rank0_rows"
                                            else None))
        self.report["train_pipeline_batches_per_s"] = bps
        print(f"train pipeline alone, batch {tb}, {DATA_WORKERS} workers, "
              "batches/s in turns: plain "
              f"{[round(v, 1) for v in bps['plain']]}, rank 0's rows "
              f"{[round(v, 1) for v in bps['rank0_rows']]} {self.tag}")

    def two_ranks(self, data_config, detect, frames_of):
        """(b) and (c), in 7j's working directory (the current one)."""
        import torch
        from uavdet_tpu_torch.data import DataPipeline, load_manifest
        from uavdet_tpu_torch.parallel.dryrun import launch
        from uavdet_tpu_torch.training import MetricsWriter, Trainer
        from uavdet_tpu_torch.utils.config import Config
        smoke, dev = self.smoke, self.dev
        parity = self.parity_batches()
        cfg = data_config().to_dict()
        cfg["train"]["trainer"].update(
            devices=MD_RANKS, multihost=True, train_batches=MD_TRAIN_BATCHES,
            val_batches=1)
        cfg["train"]["checkpoint"]["dir"] = "logs/checkpoints_md"
        spec = {"tiny_hp": self.tiny_hp, "parity": parity,
                "trainer_config": cfg, "device": dev.type, "hp": self.hp,
                "size": self.size, "train_batch": self.train_batch,
                "detect_batch": self.detect_batch}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch("chip_smoke:md_rank_job", MD_RANKS, args=(spec,),
                       device=dev.type, timeout=MD_TIMEOUT)
        seconds = time.perf_counter() - t0
        print(f"two ranks on one card ({ranks[0]['backend']}, devices "
              f"{[r['device'] for r in ranks]}): {seconds:.1f} s")
        for r in ranks:
            rel = float(np.max(np.abs(np.subtract(r["f32_losses"],
                                                  self.single))
                               / np.abs(self.single)))
            smoke.check(f"two-rank DDP float32 step vs one process, rank "
                        f"{r['rank']}", rel < PARITY_RTOL,
                        f"losses {r['f32_losses']} vs {self.single}, "
                        f"relative {rel:.3g} (rtol {PARITY_RTOL})")
            c6 = r["cfg6"]
            count_launches(smoke, None, "DyYOLO train step, placed on a mesh",
                           4, counts=c6["counts"])
            smoke.check(f"two-rank DDP cfg6 bf16 losses finite, rank "
                        f"{r['rank']}", bool(np.isfinite(c6["losses"]).all())
                        and c6["rows"] == self.train_batch // MD_RANKS,
                        f"{c6['losses']} over {c6['rows']} rows a rank")
            count_launches(smoke, None,
                           f"DyYOLO sharded detect, rank {r['rank']}",
                           REQUESTS, counts=r["detect_counts"])

        # the sharded detect against the one-process detect
        frames = frames_of(MD_FRAMES_SEED)
        want = detect(frames)
        from uavdet_tpu_torch.utils.datatypes import Detections
        bitwise = []
        for r in ranks:
            got = Detections(*(t.to(dev) for t in r["detect"]))
            compare_detections(smoke, got, want,
                               name=f"sharded detect vs one process, rank "
                                    f"{r['rank']}")
            bitwise.append(all(torch.equal(a, b) for a, b in zip(got, want)))
        one_ms = md_ms(lambda: detect(frames), dev, 10, 2)
        print(f"sharded detect of {self.detect_batch} frames over "
              f"{MD_RANKS} ranks sharing the card: bitwise equal to one "
              f"process: {bitwise}; "
              f"{[r['detect_ms'] for r in ranks]} ms per request (one "
              f"process {one_ms:.3f} ms) {self.tag}")

        # Trainer.fit with multihost: rows, reads, checkpoint
        recs = load_manifest(cfg["dataset"]["train_loader_path"])
        seed = int(cfg["train"]["seed"] or 11)
        pipe = DataPipeline(recs, self.size, self.train_batch, train=True,
                            seed=seed, workers=DATA_WORKERS, device=dev)
        pipe.set_local_rows(range(self.train_batch))
        rec = _Recorder()
        for _ in pipe._plan_local(rec):
            pass
        order = rec.paths
        for r in ranks:
            fit = r["fit"]
            rows = set(fit["local_rows"])
            tb = self.train_batch
            mine = {p for i, p in enumerate(order) if i % tb in rows}
            trained = {p for i, p in enumerate(order[:MD_TRAIN_BATCHES * tb])
                       if i % tb in rows}
            smoke.check(f"Trainer.fit multihost rank {r['rank']} decoded "
                        "only its rows",
                        len(rows) == tb // MD_RANKS
                        and set(fit["reads"]) <= mine
                        and trained <= set(fit["reads"]),
                        f"rows {sorted(rows)}, {len(fit['reads'])} files "
                        f"read, {len(set(fit['reads']) - mine)} outside its "
                        f"rows, of {len(order)} kept samples")
            smoke.check(f"Trainer.fit multihost rank {r['rank']} losses "
                        "finite", all(np.isfinite(v) for v in
                                      fit["final"].values())
                        and fit["step"] == MD_TRAIN_BATCHES
                        // TRAIN_GRAD_BATCHES, f"{fit['final']}")
            count_launches(smoke, None, f"Trainer.fit multihost, rank "
                           f"{r['rank']}", 1, counts=fit["counts"])
        self.local_rows_pipeline(recs, order, seed)
        one_cfg = Config(dict(cfg, train=dict(cfg["train"], trainer=dict(
            cfg["train"]["trainer"], devices=1, multihost=False))))
        t = Trainer(one_cfg, BatchList([]), BatchList([]),
                    metrics=MetricsWriter("dvclive_md_restore"), device=dev)
        import os
        names = sorted(os.listdir("logs/checkpoints_md"))
        t.ckpt.restore(t.state, "last")
        smoke.check("Trainer.fit multihost checkpoint restores in one "
                    "process", t.state.step == MD_TRAIN_BATCHES
                    // TRAIN_GRAD_BATCHES and all(
                        bool(torch.isfinite(p).all())
                        for p in t.model.parameters())
                    and not os.path.exists("dvclive_md1/metrics.json"),
                    f"{names}, step {t.state.step}")
        del t

        # FSDP2 over the two processes (gloo carries its collectives on
        # CUDA tensors); any failure of a rank fails the phase
        fsdp = launch("chip_smoke:md_fsdp_job", MD_RANKS, args=(spec,),
                      device=dev.type, timeout=MD_TIMEOUT)
        for rank, got in enumerate(fsdp):
            rel = float(np.max(np.abs(np.subtract(got, self.single))
                               / np.abs(self.single)))
            smoke.check(f"two-rank FSDP2 float32 step vs one process, "
                        f"rank {rank}", rel < PARITY_RTOL,
                        f"losses {got}, relative {rel:.3g} (rtol "
                        f"{PARITY_RTOL})")

        self.report["two_ranks"] = {
            "backend": ranks[0]["backend"], "seconds": seconds,
            "ms_per_microbatch": [r["cfg6"]["ms_per_microbatch"]
                                  for r in ranks],
            "rows_per_rank": self.train_batch // MD_RANKS,
            "peak_gib": [r["cfg6"]["peak_gib"] for r in ranks],
            "detect_ms": [r["detect_ms"] for r in ranks],
            "one_process_detect_ms": one_ms, "detect_bitwise": bitwise,
            "fit": [r["fit"]["final"] for r in ranks]}


def bf16_close(got, want) -> dict:
    """The stated bf16 tolerance (RTOL, ATOL) of a kernel against its plain
    version, as numbers a rank returns."""
    import torch
    g, w = got.float(), want.float()
    return {"ok": got.shape == want.shape and bool(torch.isfinite(g).all())
            and bool(torch.allclose(g, w, rtol=RTOL, atol=ATOL)),
            "max_abs_err": float((g - w).abs().max()),
            "shape": list(got.shape)}


def sums_err(got, want) -> dict:
    """Channel sums against the plain version's: held against the largest
    sum (see phase 2)."""
    err = float((got - want).abs().max())
    return {"ok": err <= 1e-3 * float(want.abs().max()),
            "max_abs_err": err}


def sp_detect_run(detect, frames, dev) -> dict:
    """One spatial (or one-process) detect of ``frames``: a warm-up call,
    then REQUESTS requests with the launch counts set to 0 just before and
    read just after, the first result on the host, the ms per request and
    the peak device memory of the requests (and above what was resident
    before them)."""
    from uavdet_tpu_torch import kernels
    detect(frames)
    resident = 0.0
    if dev.type == "cuda":
        import torch
        md_sync(dev, peak_reset=True)
        resident = torch.cuda.memory_allocated(dev) / 2**30
    kernels.reset_launch_counts()
    results = [detect(frames) for _ in range(REQUESTS)]
    peak = md_sync(dev)
    counts = kernels.launch_counts()
    ms = md_ms(lambda: detect(frames), dev, SP_ITERS, SP_WARMUP)
    return {"result": [t.cpu() for t in results[0]], "counts": counts,
            "ms": ms, "peak_gib": peak, "above_resident_gib": peak - resident}


def sp_kernel_checks(mesh, dy_model, soem_model, frames,
                     soem_frames) -> dict:
    """Kernels A and B on this rank's band of ``frames`` with the stem's halo
    (as ``fused_stem_rows`` takes it), and kernel D on the first SOEM's
    halo'd band of ``soem_frames`` (as ``DynamicSOEM`` passes it under sp),
    each against its plain version, the first SP_CHECK_FRAMES images."""
    import torch
    from uavdet_tpu_torch.inference import preprocess
    from uavdet_tpu_torch.ops import stem
    from uavdet_tpu_torch.ops.dyconv import dyconv, dyconv_plain
    from uavdet_tpu_torch.parallel import (coordinate, row_band, sp_group,
                                           sp_rows, sp_sum)
    group, index = sp_group(mesh), coordinate(mesh)[2]
    n = mesh["sp"].size()
    out = {}
    x = frames[:SP_CHECK_FRAMES]
    height = x.shape[1]
    band = row_band(index, n, height, 32)
    top = stem.STEM_HALO[0] if band.start else 0
    bottom = stem.STEM_HALO[1] if band.stop < height else 0
    xh = x[:, band.start - top:band.stop + bottom].contiguous()
    dy0, dy1 = dy_model.layers[0], dy_model.layers[1]
    temp = dy_model.attn_temperature
    h = len(band)
    with torch.inference_mode():
        k1 = stem.stem_l1_weights(xh[:, top:top + h], dy0, temp, group)
        a1, sums = stem.stem_l1(xh, k1)
        a1_p, sums_p = stem.stem_l1_plain(xh, k1)
        out["A output"] = bf16_close(a1, a1_p)
        out["A sums"] = sums_err(sums, sums_p)
        halo = torch.cat([a1[:, :top], a1[:, top + h:]], dim=1)
        k2 = stem.stem_l2_weights(sp_sum(sums - halo.float().sum((1, 2)),
                                         group), n * h * x.shape[2], dy1,
                                  temp)
        a1b = a1[:, :top + h]
        out["B output"] = bf16_close(stem.stem_l2(a1b, k2),
                                     stem.stem_l2_plain(a1b, k2))
        out["A, B block"] = {"rows": h, "top": top, "bottom": bottom,
                             "a1_rows": int(a1.shape[1])}
        seen = []

        def capture(f, k, mul, add, emit_gap=False):
            if not seen:
                seen.append((f, k, mul, add, emit_gap))
            return dyconv(f, k, mul, add, emit_gap=emit_gap)

        size = soem_frames.shape[1]
        sband = row_band(index, n, size, 8)
        xs = preprocess(soem_frames[:SP_CHECK_FRAMES], size)
        with sp_rows(soem_model, group):
            soem_model(xs[:, sband.start:sband.stop], conv=capture)
        f, k, mul, add, emit = seen[0]
        got, got_s = dyconv(f, k, mul, add, emit_gap=True)
        want, want_s = dyconv_plain(f, k, mul, add, emit_gap=True)
        out["D output"] = bf16_close(got, want)
        out["D sums"] = sums_err(got_s, want_s)
        out["D block"] = {"rows": len(sband) // 2, "f_rows": int(f.shape[1]),
                          "emit_gap": bool(emit)}
    return out


def sp_ep_rank_job(spec: dict) -> dict:
    """One of the two ranks of phase 7p, sharing the card over gloo: on sp
    2, the spatial detects of full-width DyYOLO and DySOEM_SimFPN, kernels A,
    B and D on halo'd bands against their plain versions, the float32 tiny
    step and cfg6; on ep 2, the float32 tiny step and cfg6."""
    import torch
    import torch.distributed as dist
    from uavdet_tpu_torch.inference import make_detector
    from uavdet_tpu_torch.models.registry import DYSOEM
    from uavdet_tpu_torch.parallel import (local_batch_rows, local_device,
                                           make_mesh, shard_host_batch)
    from uavdet_tpu_torch.utils.seeding import seeded_model
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = local_device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = {"rank": dist.get_rank(), "device": str(dev),
           "backend": dist.get_backend()}
    sp = make_mesh(1, 1, SP_RANKS, 1, device_type=dev.type)
    size, soem_size = spec["size"], spec["soem_size"]

    def frames_of(seed, batch, hw):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, 256, (batch, hw, hw, 3), dtype=torch.uint8,
                             device=dev, generator=g)

    frames = frames_of(MD_FRAMES_SEED, spec["detect_batch"], size)
    soem_frames = frames_of(SP_FRAMES_SEED, spec["soem_batch"], soem_size)
    # bf16, as phases 6 and 7 serve them (and as the card's default)
    dy = seeded_model("DyYOLO", spec["hp"], SEED, dev, dtype=torch.bfloat16)
    soem = seeded_model("DySOEM_SimFPN", DYSOEM, SEED, dev,
                        dtype=torch.bfloat16)
    out["dyyolo"] = sp_detect_run(make_detector(
        dy, spec["hp"], size, mesh=sp, spatial=True), frames, dev)
    out["dysoem"] = sp_detect_run(make_detector(
        soem, DYSOEM, soem_size, mesh=sp, spatial=True), soem_frames, dev)
    out["kernels"] = sp_kernel_checks(sp, dy, soem, frames, soem_frames)
    del dy, soem
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    out["sp_f32_losses"] = md_f32_losses(spec["tiny_hp"], spec["parity"],
                                         dev, sp)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    batch = spec["train_batch"]
    batches = [painted_batch(gen, dev, batch, size) for _ in range(4)]
    out["sp_cfg6"] = md_cfg6(spec["hp"], size, dev, sp, batches)

    ep = make_mesh(1, 1, 1, SP_RANKS, device_type=dev.type)
    out["ep_f32_losses"] = md_f32_losses(spec["tiny_hp"], spec["parity"],
                                         dev, ep)
    rows = local_batch_rows(ep, batch)
    out["ep_cfg6"] = md_cfg6(spec["hp"], size, dev, ep,
                             [shard_host_batch(b, rows) for b in batches])
    return out


class SpatialExperts:
    """Phase 7p: the ``sp`` and ``ep`` axes on two processes sharing the
    card over gloo (``sp_ep_rank_job``): the spatial detects against the
    one-process detects, their launches on each rank, kernels A, B and D on
    halo'd bands against their plain versions, the float32 tiny steps
    against one process, cfg6 under both axes; the readings go into 7o's
    ``{"multi_device": ...}`` line."""

    def __init__(self, smoke, dev, tag, md, hp, size=SIZE,
                 detect_batch=BATCH, soem_size=SOEM_SIZE,
                 soem_batch=SOEM_BATCH, train_batch=TRAIN_BATCH):
        self.smoke, self.dev, self.tag, self.md = smoke, dev, tag, md
        self.hp, self.size, self.detect_batch = hp, size, detect_batch
        self.soem_size, self.soem_batch = soem_size, soem_batch
        self.train_batch = train_batch

    def run(self, detect, soem_detect):
        """``detect`` and ``soem_detect``: the one-process detectors of
        phases 6 and 7, held against the ranks on the same frames."""
        import torch
        from uavdet_tpu_torch.parallel.dryrun import launch
        from uavdet_tpu_torch.utils.datatypes import Detections
        smoke, dev, md = self.smoke, self.dev, self.md
        spec = {"tiny_hp": md.tiny_hp, "parity": md.parity_batches(),
                "device": dev.type, "hp": self.hp, "size": self.size,
                "detect_batch": self.detect_batch,
                "soem_size": self.soem_size, "soem_batch": self.soem_batch,
                "train_batch": self.train_batch}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch("chip_smoke:sp_ep_rank_job", SP_RANKS, args=(spec,),
                       device=dev.type, timeout=SP_TIMEOUT)
        seconds = time.perf_counter() - t0
        print(f"sp / ep: two ranks on one card ({ranks[0]['backend']}, "
              f"devices {[r['device'] for r in ranks]}): {seconds:.1f} s")

        def frames_of(seed, batch, hw):
            g = torch.Generator(device=dev).manual_seed(seed)
            return torch.randint(0, 256, (batch, hw, hw, 3),
                                 dtype=torch.uint8, device=dev, generator=g)

        report = {"seconds": seconds, "backend": ranks[0]["backend"]}
        for name, path, fn, frames in (
                ("dyyolo", "DyYOLO", detect,
                 frames_of(MD_FRAMES_SEED, self.detect_batch, self.size)),
                ("dysoem", "DySOEM_SimFPN", soem_detect,
                 frames_of(SP_FRAMES_SEED, self.soem_batch,
                           self.soem_size))):
            one = sp_detect_run(fn, frames, dev)
            want = Detections(*(t.to(dev) for t in one["result"]))
            bitwise = []
            for r in ranks:
                got = r[name]
                count_launches(smoke, None, f"{path} spatial detect, rank "
                               f"{r['rank']}", REQUESTS,
                               counts=got["counts"])
                g = Detections(*(t.to(dev) for t in got["result"]))
                compare_detections(smoke, g, want,
                                   name=f"{path} spatial detect (sp 2) vs "
                                        f"one process, rank {r['rank']}")
                bitwise.append(all(torch.equal(a, b)
                                   for a, b in zip(g, want)))
            report[name] = {
                "ms_per_request": [r[name]["ms"] for r in ranks],
                "one_process_ms": one["ms"],
                "peak_gib": [r[name]["peak_gib"] for r in ranks],
                "above_resident_gib": [r[name]["above_resident_gib"]
                                       for r in ranks],
                "one_process_peak_gib": one["peak_gib"],
                "one_process_above_resident_gib": one["above_resident_gib"],
                "bitwise": bitwise}
            print(f"{path} spatial detect, sp 2 sharing the card: "
                  f"{json.dumps(report[name])} {self.tag}")
            del one, want
        for r in ranks:
            for check, res in r["kernels"].items():
                if "ok" in res:
                    smoke.check(f"{check} on a halo'd band vs plain, rank "
                                f"{r['rank']}", res["ok"], json.dumps(res))
            print(f"halo'd bands, rank {r['rank']}: "
                  f"{json.dumps({k: v for k, v in r['kernels'].items() if 'ok' not in v})}")
        single = md.single
        for axis in ("sp", "ep"):
            for r in ranks:
                got = r[f"{axis}_f32_losses"]
                rel = float(np.max(np.abs(np.subtract(got, single))
                                   / np.abs(single)))
                smoke.check(f"{axis} 2 float32 step vs one process, rank "
                            f"{r['rank']}", rel < PARITY_RTOL,
                            f"losses {got} vs {single}, relative {rel:.3g} "
                            f"(rtol {PARITY_RTOL})")
                c6 = r[f"{axis}_cfg6"]
                count_launches(smoke, None, f"DyYOLO train step, {axis} 2",
                               4, counts=c6["counts"])
                smoke.check(f"{axis} 2 cfg6 bf16 losses finite, rank "
                            f"{r['rank']}", bool(np.isfinite(
                                c6["losses"]).all()) and c6["step"] > 0,
                            f"{c6['losses']} over {c6['rows']} rows a rank")
            report[f"{axis}_cfg6"] = {
                k: [r[f"{axis}_cfg6"].get(k) for r in ranks]
                for k in ("ms_per_microbatch", "peak_gib", "rows",
                          "expert_bytes", "dyconv_bytes")}
            print(f"cfg6 under {axis} 2 sharing the card: "
                  f"{json.dumps(report[f'{axis}_cfg6'])} {self.tag}")
        self.md.report["sp_ep"] = report
class PipelineStages:
    """Phase 7q: pipeline parallelism (``parallel.pipeline``), one process
    driving the stages, every stage on the one card: (a) the float32 tiny
    DyYOLO's pp steps against the same steps on the CPU; (b) one pp update
    at cfg6's shape against the plain step with ``grad_batches`` 2 on the
    same microbatches; (c) ``Trainer.fit`` with ``pp_devices: 2`` (kernels
    A, B and C in its validation; its ``last`` restored into a
    single-device Trainer); (d) the refusal of more stages than cards; (e)
    in phase 8, (b)'s ms per update and peak memory beside the plain
    step's."""

    def __init__(self, smoke, dev, tag, tiny_hp, hp, size=SIZE,
                 train_batch=TRAIN_BATCH, parity_size=PARITY_SIZE):
        self.smoke, self.dev, self.tag = smoke, dev, tag
        self.tiny_hp, self.hp, self.size = tiny_hp, hp, size
        self.train_batch, self.parity_size = train_batch, parity_size
        self.full = None   # (b)'s two steps, timed in (e)

    def parity(self):
        """(a) S = 2 and 4, M = 3 microbatches of 2 rows, 2 updates, on
        [card] * S against the CPU: the microbatches' losses within
        ``PARITY_RTOL``; a pp train step launches no kernel."""
        import torch
        from uavdet_tpu_torch import kernels
        from uavdet_tpu_torch.parallel import (PipelinedModel,
                                               make_pp_trainer_step)
        from uavdet_tpu_torch.training import build_optimizer, init_state
        from uavdet_tpu_torch.utils.seeding import seeded_model
        smoke, hp = self.smoke, self.tiny_hp
        gen = torch.Generator().manual_seed(SEED + 3)
        batches = []
        for _ in range(PP_PARITY_STEPS):
            b = painted_batch(gen, "cpu", PP_PARITY_MICRO * PARITY_BATCH,
                              self.parity_size, 2)
            batches.append(b._replace(image=torch.rand(b.image.shape,
                                                       generator=gen)))
        for n_stages in PP_PARITY_STAGES:
            losses = {}
            for side, where in (("card", self.dev),
                                ("cpu", torch.device("cpu"))):
                m = seeded_model("DyYOLO", hp, SEED, where,
                                 dtype=torch.float32)
                pm = PipelinedModel(m, n_stages, [where] * n_stages)
                state = init_state(m, *build_optimizer(m.parameters(), hp))
                step = make_pp_trainer_step(pm, hp, self.parity_size,
                                            PP_PARITY_MICRO)
                md_sync(self.dev)
                kernels.reset_launch_counts()
                losses[side] = np.concatenate([
                    step(state, type(b)(*(t.to(where) for t in b)))
                    ["microbatch_loss"].cpu().numpy() for b in batches])
                md_sync(self.dev)
                if side == "card":
                    count_launches(smoke, kernels, "DyYOLO pp train step",
                                   PP_PARITY_STEPS)
            rel = np.abs(losses["card"] - losses["cpu"]) / losses["cpu"]
            smoke.check(f"float32 pp train steps, {n_stages} stages, card "
                        "vs CPU", bool((rel < PARITY_RTOL).all()),
                        f"card {losses['card'].tolist()} cpu "
                        f"{losses['cpu'].tolist()} relative {rel.tolist()} "
                        f"(rtol {PARITY_RTOL})")

    def full_width(self):
        """(b) full-width DyYOLO at cfg6's shape (640 px, batch 8 cut into 2
        microbatches of 4, bf16 autocast over float32 parameters) in 2
        stages on the card: one update against the plain step with
        ``grad_batches`` 2 on the same two microbatches, from the same
        seeded weights."""
        import torch
        from uavdet_tpu_torch import kernels
        from uavdet_tpu_torch.parallel import (PipelinedModel,
                                               make_pp_trainer_step)
        from uavdet_tpu_torch.training import (build_optimizer, init_state,
                                               make_train_step)
        from uavdet_tpu_torch.utils.datatypes import BatchData
        from uavdet_tpu_torch.utils.seeding import seeded_model
        smoke, dev, hp = self.smoke, self.dev, self.hp
        bf16 = torch.bfloat16
        gen = torch.Generator(device=dev).manual_seed(SEED + 4)
        batch = painted_batch(gen, dev, self.train_batch, self.size)
        mb = self.train_batch // PP_MICRO
        micro = [BatchData(*(t[i * mb:(i + 1) * mb] for t in batch))
                 for i in range(PP_MICRO)]
        models = [seeded_model("DyYOLO", hp, SEED, dev, dtype=torch.float32)
                  for _ in range(2)]
        pm = PipelinedModel(models[0], PP_STAGES, [dev] * PP_STAGES)
        states = [init_state(m, *build_optimizer(m.parameters(), hp))
                  for m in models]
        pp_step = make_pp_trainer_step(pm, hp, self.size, PP_MICRO,
                                       compute_dtype=bf16)
        plain = make_train_step(models[1], hp, self.size, compute_dtype=bf16,
                                grad_batches=PP_MICRO)
        before = {k: v.float().clone()
                  for k, v in models[1].state_dict().items()}
        md_sync(dev)
        kernels.reset_launch_counts()
        got = pp_step(states[0], batch)
        md_sync(dev)
        count_launches(smoke, kernels, "DyYOLO pp train step", 1)
        want = [plain(states[1], b) for b in micro]
        g = got["microbatch_loss"].float().cpu().numpy()
        w = np.array([float(m["loss"]) for m in want])
        rel = np.abs(g - w) / np.abs(w)
        smoke.check("pp step at cfg6's shape: microbatch losses vs the "
                    "plain step", bool(np.isfinite(g).all()
                                       and (rel < PP_LOSS_RTOL).all()),
                    f"pp {g.tolist()} plain {w.tolist()} relative "
                    f"{rel.tolist()} (rtol {PP_LOSS_RTOL}) {self.tag}")
        worst, where_, moved = 0.0, None, 0.0
        want_sd = models[1].state_dict()
        for k, v in models[0].state_dict().items():
            if not v.is_floating_point():
                continue
            ref = want_sd[k].float()
            err = float((v.float() - ref).abs().max()
                        / ref.abs().max().clamp_min(1e-30))
            moved = max(moved, float((ref - before[k]).abs().max()))
            if err > worst:
                worst, where_ = err, k
        smoke.check("pp step at cfg6's shape: updated parameters and "
                    "BatchNorm buffers vs the plain step",
                    worst < PP_PARAM_TOL and moved > 0
                    and states[0].step == states[1].step == 1,
                    f"largest difference {worst:.3g} of the tensor's largest "
                    f"|value| at {where_} (limit {PP_PARAM_TOL}); the plain "
                    f"step moved a value by {moved:.3g}; updates "
                    f"{states[0].step} / {states[1].step}")
        self.full = (states, pp_step, plain, batch, micro)

    def config(self, workdir, **trainer):
        from uavdet_tpu_torch.utils.config import Config
        return Config({
            "dataset": {"batch_size": self.train_batch,
                        "image_size": [self.size, self.size]},
            "train": {"seed": SEED, "trainer": {
                "epochs": PP_EPOCHS, "grad_batches": TRAIN_GRAD_BATCHES,
                "train_batches": PP_TRAIN_BATCHES,
                "val_batches": PP_VAL_BATCHES, "val_check_interval": 1.0,
                "precision": "bf16", "grad_clip_val": None, "eval_ap": True,
                "profiler": None, **trainer},
                "checkpoint": {"dir": f"{workdir}/ck", "monitor": "val_loss",
                               "mode": "min"}},
            "model": {"name": "DyYOLO", "hparams": as_dict(self.hp)}})

    def trainer(self, workdir):
        """(c) ``Trainer.fit`` with ``pp_devices: 2`` on ``[card, card]``
        (2 epochs of 2 train and 1 validation batch, ``eval_ap``): A, B and C
        once per validation batch; its ``last`` restores into a
        single-device Trainer bitwise; (d) ``pp_devices`` above the visible
        cards raises with ``device="cuda"``."""
        import torch
        from uavdet_tpu_torch import kernels
        from uavdet_tpu_torch.training import (CheckpointManager,
                                               MetricsWriter, Trainer)
        smoke, dev = self.smoke, self.dev
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)
        train_b = BatchList([painted_batch(gen, dev, self.train_batch,
                                           self.size)
                             for _ in range(PP_TRAIN_BATCHES)])
        val_b = BatchList([painted_batch(gen, dev, self.train_batch,
                                         self.size)
                           for _ in range(PP_VAL_BATCHES)])
        pp_kw = dict(pp_devices=PP_STAGES, pp_microbatches=PP_MICRO)
        t = Trainer(self.config(f"{workdir}/pp", **pp_kw), train_b, val_b,
                    metrics=MetricsWriter(f"{workdir}/pp/dv"),
                    device=[dev] * PP_STAGES)
        md_sync(dev)
        kernels.reset_launch_counts()
        final = t.fit()
        md_sync(dev)
        count_launches(smoke, kernels, "Trainer.fit DyYOLO pp",
                       PP_EPOCHS * PP_VAL_BATCHES)
        updates = PP_EPOCHS * PP_TRAIN_BATCHES // TRAIN_GRAD_BATCHES
        smoke.check("pp Trainer.fit: val_loss, val_AP, updates",
                    np.isfinite(final["val_loss"]) and final["val_AP"] >= 0
                    and t.state.step == updates and len(t.pm.stages) == 2,
                    f"{final}, {t.state.step} updates (expected {updates}), "
                    f"stages {t.pm.ranges} on {t.pm.devices}")
        single = Trainer(self.config(f"{workdir}/single"), train_b, val_b,
                         metrics=MetricsWriter(f"{workdir}/single/dv"),
                         device=dev)
        CheckpointManager(f"{workdir}/pp/ck").restore(single.state, "last")
        sd = single.model.state_dict()
        same = [torch.equal(v, sd[k]) for k, v in t.model.state_dict().items()]
        same += [torch.equal(t.state.optimizer.state[p]["momentum_buffer"],
                             single.state.optimizer.state[q]
                             ["momentum_buffer"])
                 for p, q in zip(t.model.parameters(),
                                 single.model.parameters())]
        smoke.check("pp checkpoint restores into a single-device Trainer "
                    "bitwise", all(same) and single.state.step == updates,
                    f"{sum(same)} of {len(same)} tensors equal (weights, "
                    f"buffers, momentum); step {single.state.step}")
        n = max(2, torch.cuda.device_count() + 1)
        try:
            Trainer(self.config(f"{workdir}/refused", pp_devices=n,
                                pp_microbatches=1), train_b, val_b,
                    metrics=MetricsWriter(f"{workdir}/refused/dv"),
                    device="cuda")
            refused = "no error"
        except ValueError as e:
            refused = str(e)
        smoke.check("pp_devices above the visible cards raises",
                    "CUDA device(s) visible" in refused,
                    f"pp_devices={n}: {refused}")

    def timing(self):
        """(e) (b)'s update: ms (CUDA-event median) and the peak device
        memory above what was resident, pp and plain in turns (plain, pp,
        pp, plain). One card holds both stages: the schedule's cost, not a
        speed-up."""
        import torch
        states, pp_step, plain, batch, micro = self.full
        dev = self.dev

        def pp_update():
            pp_step(states[0], batch)

        def plain_update():
            for b in micro:
                plain(states[1], b)

        ms, peak = {"pp": [], "plain": []}, {}
        for which in ("plain", "pp", "pp", "plain"):
            fn = pp_update if which == "pp" else plain_update
            md_sync(dev, peak_reset=True)
            base = (torch.cuda.memory_allocated(dev) / 2**30
                    if dev.type == "cuda" else 0.0)
            ms[which].append(md_ms(fn, dev, PP_ITERS, PP_WARMUP))
            peak[which] = md_sync(dev) - base
        row = {"ms_per_update": {k: min(v) for k, v in ms.items()},
               "runs_ms": ms, "peak_gib_above_resident": peak,
               "stages": PP_STAGES, "microbatches": PP_MICRO,
               "rows_per_microbatch": self.train_batch // PP_MICRO,
               "size": self.size, "card_sharing": "every stage on one card: "
               "the schedule's cost over the plain step, not a scaling "
               "number"}
        print(f"pp step DyYOLO @{self.size} bs={self.train_batch} in "
              f"{PP_STAGES} stages on one card, {PP_MICRO} microbatches, "
              f"bf16: {row['ms_per_update']['pp']:.3f} ms/update "
              f"({ms['pp']}), "
              f"peak {peak['pp']:.2f} GiB above resident; plain step "
              f"grad_batches {PP_MICRO} on the same microbatches "
              f"{row['ms_per_update']['plain']:.3f} ms/update "
              f"({ms['plain']}), peak {peak['plain']:.2f} GiB {self.tag}")
        print(json.dumps({"pp": row}))

    def profile_update(self):
        states, pp_step, _, batch, _ = self.full
        pp_step(states[0], batch)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    from uavdet_tpu_torch.utils.timing import card_line
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    import importlib.util
    import os
    present = [m for m in ("PIL", "cv2", "yaml", "jax")
               if importlib.util.find_spec(m) is not None]
    print(f"host: {os.cpu_count()} CPUs; importable here, and used by "
          f"neither the port nor this script: {present}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from uavdet_tpu_torch import kernels
    from uavdet_tpu_torch.inference import (Detector, decode_topk_global,
                                            make_detector, preprocess,
                                            preprocess_dual,
                                            select_detections)
    from uavdet_tpu_torch.models import BASELINE, DYSOEM, DYYOLO
    from uavdet_tpu_torch.ops.block import (BLOCK_EDGE_SHAPES, BLOCK_STAGES,
                                            fold_block_weights,
                                            pack_block_weights,
                                            post_stem_block,
                                            post_stem_block_plain)
    from uavdet_tpu_torch.ops.dyconv import (EDGE_SHAPES, dyconv,
                                             dyconv_plain, parity_sums,
                                             rfold)
    from uavdet_tpu_torch.ops.nms import _nms_alive_cuda
    from uavdet_tpu_torch.ops.stem import _stem_l1_cuda, _stem_l2_cuda
    from uavdet_tpu_torch.ops.nms import (NMS_EDGE_CASES, batched_nms,
                                          nms_alive, nms_alive_plain,
                                          nms_edge_case, nms_empty_launch,
                                          nms_phase_ms)
    from uavdet_tpu_torch.ops.stem import (L1_EDGE_SHAPES, L2_EDGE_SHAPES,
                                           L2_STAGES,
                                           detector_stem_fast_path,
                                           fused_stem_forward, stem_fused,
                                           stem_fused_plain, stem_l1,
                                           stem_l1_plain, stem_l1_weights,
                                           stem_l2, stem_l2_plain,
                                           stem_l2_stage, stem_l2_weights)
    from uavdet_tpu_torch.scripts import block_ablate, l2_ablate
    from uavdet_tpu_torch.utils.seeding import seeded_model

    smoke = Smoke()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tag = f"[{card}]"

    # the nvJPEG library of the data path (7j) builds beside the kernels
    from concurrent.futures import ThreadPoolExecutor
    from uavdet_tpu_torch.data import jpeg
    build_pool = ThreadPoolExecutor(1)
    jpeg_build = build_pool.submit(jpeg.build)
    build_pool.shutdown(wait=False)

    def build():
        info = kernels.build()
        kernels.library()
        print(f"nvcc build {info.seconds:.1f} s -> {info.path.name}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  " + line.strip())
        smoke.check("build", True, f"{len(KERNELS)} kernels")

    smoke.phase("1 build", build)

    t0 = time.perf_counter()
    # device and dtype are the entry point's defaults: the card, bf16
    model = seeded_model("DyYOLO", DYYOLO, SEED)
    dy0, dy1, temp = model.layers[0], model.layers[1], model.attn_temperature
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: DyYOLO full width, {n_params} parameters, seed {SEED}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    frames = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    inputs = {}

    def sums_close(name, got, want, rtol):
        # sums of ~10^5 stored values: a bf16 ulp that falls the other way
        # moves a sum by 2^-8 of one value, so the error is held against the
        # largest sum, not against each (possibly cancelling) one
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        smoke.check(name, err <= rtol * top, f"max_abs_err {err:.6g} of "
                    f"{top:.6g} (rtol {rtol} of the largest sum)")

    @torch.inference_mode()
    def kernel_a():
        k1 = stem_l1_weights(frames, dy0, temp)
        a1, sums = stem_l1(frames, k1)
        a1_p, sums_p = stem_l1_plain(frames, k1)
        err = compare_bf16(smoke, f"stem_l1 uint8 {tuple(frames.shape)}",
                           a1, a1_p)
        smoke.stats["stem_l1"]["max_abs_err"] = err
        smoke.check("stem_l1 uint8 sums", torch.allclose(
            sums, sums_p, rtol=1e-3, atol=1e-2), "max_abs_err "
            f"{float((sums - sums_p).abs().max()):.6g} of "
            f"{float(sums_p.abs().max()):.6g} (rtol 1e-3)")
        inputs["l1"] = (frames, k1)
        inputs["l2"] = (a1, stem_l2_weights(sums, SIZE * SIZE, dy1, temp))
        smoke.stats["stem_l1"].update(bound(
            nbytes(frames, a1, sums) + k1.numel() * 2,
            2 * 27 * 32 * BATCH * SIZE * SIZE, BF16_FLOPS))
        odd = torch.rand((2, 97, 161, 3), generator=gen, device=dev)
        odd = odd.to(torch.bfloat16)
        k1 = stem_l1_weights(odd, dy0, temp)
        a1, sums = stem_l1(odd, k1)
        a1_p, sums_p = stem_l1_plain(odd, k1)
        compare_bf16(smoke, "stem_l1 bf16 (2,97,161,3) a1", a1, a1_p)
        smoke.check("stem_l1 bf16 sums", torch.allclose(
            sums, sums_p, rtol=1e-3, atol=1e-2), "max_abs_err "
            f"{float((sums - sums_p).abs().max()):.6g}")
        k2 = stem_l2_weights(sums, 97 * 161, dy1, temp)
        compare_bf16(smoke, "stem_l2 (2,97,161,32) -> (2,49,81,64)",
                     stem_l2(a1, k2), stem_l2_plain(a1, k2))
        for b, h, w in L1_EDGE_SHAPES:
            u8 = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                               device=dev, generator=gen)
            for x in (u8, (u8.float() / 255.0).to(torch.bfloat16)):
                k1 = 0.3 * torch.randn((b, 32, 28), generator=gen, device=dev)
                if x.dtype == torch.uint8:   # /255 folded into the taps
                    k1[..., :27] /= 255.0
                label = f"stem_l1 edge {tuple(x.shape)} {x.dtype}"
                a1, sums = stem_l1(x, k1)
                a1_p, sums_p = stem_l1_plain(x, k1)
                compare_bf16(smoke, label, a1, a1_p)
                sums_close(f"{label} sums", sums, sums_p, 1e-3)
                again, sums_again = stem_l1(x, k1)
                smoke.check(f"{label} twice on the same input",
                            torch.equal(again, a1)
                            and torch.equal(sums_again, sums),
                            "output and sums bitwise equal")

    @torch.inference_mode()
    def kernel_b():
        a1, k2 = inputs["l2"]
        out = stem_l2(a1, k2)
        err = compare_bf16(smoke, f"stem_l2 {tuple(a1.shape)} -> "
                           f"{tuple(out.shape)}", out, stem_l2_plain(a1, k2))
        smoke.stats["stem_l2"]["max_abs_err"] = err
        smoke.stats["stem_l2"].update(bound(
            nbytes(a1, out) + k2.numel() * 2,
            2 * 288 * 64 * out.numel() // 64, BF16_FLOPS))
        for b, h, w in L2_EDGE_SHAPES:
            a1 = 0.5 * torch.randn((b, h, w, 32), generator=gen, device=dev)
            k2 = 0.08 * torch.randn((b, 64, 289), generator=gen, device=dev)
            a1 = a1.to(torch.bfloat16)
            out = stem_l2(a1, k2)
            compare_bf16(smoke, f"stem_l2 edge {tuple(a1.shape)} -> "
                         f"{tuple(out.shape)}", out, stem_l2_plain(a1, k2))

    @torch.inference_mode()
    def kernel_nms():
        boxes, scores = nms_case(gen, dev)
        order = torch.argsort(-scores, dim=1, stable=True)
        boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        alive, alive_p = nms_alive(boxes_s, 0.5), nms_alive_plain(boxes_s, 0.5)
        diff = int((alive != alive_p).sum())
        smoke.check(f"nms alive {tuple(alive.shape)} bitwise", diff == 0,
                    f"{diff} of {alive.numel()} differ; {int(alive.sum())} "
                    "survivors")
        smoke.stats["nms"]["max_abs_err"] = float(diff != 0)
        got = batched_nms(boxes, scores, 0.5, 300)
        want = batched_nms(boxes, scores, 0.5, 300, alive_fn=nms_alive_plain)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        smoke.check("batched_nms keep_idx/alive/order bitwise", same, "")
        inputs["nms"] = boxes_s
        rng = np.random.default_rng(SEED)
        for kind, b, n in NMS_EDGE_CASES:
            eb, es = (torch.from_numpy(a).to(dev)
                      for a in nms_edge_case(kind, b, n, rng))
            order = torch.argsort(-es, dim=1, stable=True)
            eb_s = torch.gather(eb, 1, order[..., None].expand(-1, -1, 4))
            got, want = nms_alive(eb_s, 0.5), nms_alive_plain(eb_s, 0.5)
            diff = int((got != want).sum())
            keep = batched_nms(eb, es, 0.5, min(n, 300))
            keep_p = batched_nms(eb, es, 0.5, min(n, 300),
                                 alive_fn=nms_alive_plain)
            same = all(torch.equal(g, w) for g, w in zip(keep, keep_p))
            smoke.check(f"nms edge {kind} ({b}, {n}) bitwise",
                        diff == 0 and same, f"{diff} of {got.numel()} differ; "
                        f"{int(got.sum())} survivors; batched_nms equal "
                        f"{same}")
        # the shape timed past 1024 boxes, checked once here
        b, n = BATCH, NMS_LARGE_N
        eb, es = (torch.from_numpy(a).to(dev)
                  for a in nms_edge_case("crowded", b, n, rng))
        order = torch.argsort(-es, dim=1, stable=True)
        big = torch.gather(eb, 1, order[..., None].expand(-1, -1, 4))
        got = nms_alive(big, 0.5)
        diff = int((got != nms_alive_plain(big, 0.5)).sum())
        smoke.check(f"nms ({b}, {n}) bitwise", diff == 0,
                    f"{diff} of {got.numel()} differ; {int(got.sum())} "
                    "survivors")
        inputs["nms_large"] = big.contiguous()
        # csrc/nms.cu: 5 f32 operations per box area, 14 per IoU of a pair
        # (i, j > i): 4 min/max, 2 differences, 2 clamps, 1 product, the
        # union's sum and difference, its clamp, the quotient, the compare
        b, n = alive.shape
        smoke.stats["nms"].update(bound(
            nbytes(boxes_s, alive), b * (5 * n + 14 * n * (n - 1) // 2),
            F32_FLOPS))

    smoke.phase("2 kernel A", kernel_a)
    smoke.phase("3 kernel B", kernel_b)
    smoke.phase("4 NMS", kernel_nms)

    t0 = time.perf_counter()
    soem_model = seeded_model("DySOEM_SimFPN", DYSOEM, SEED)
    n_params = sum(p.numel() for p in soem_model.parameters())
    print(f"model: DySOEM_SimFPN full width, {n_params} parameters, seed "
          f"{SEED}, built in {time.perf_counter() - t0:.1f} s")
    for name, m in (("DyYOLO", model), ("DySOEM_SimFPN", soem_model)):
        where = {(p.device.type, p.dtype) for p in m.parameters()}
        smoke.check(f"{name} built with no device or dtype named",
                    where == {("cuda", torch.bfloat16)}, f"{where}")
    soem_frames = torch.randint(0, 256, (SOEM_BATCH, SOEM_SIZE, SOEM_SIZE, 3),
                                dtype=torch.uint8, device=dev, generator=gen)
    sites = []   # (x, k, mul, add, emit_gap) as each SOEM site calls kernel D

    def check_dyconv(label, x, k, mul, add, fold: bool):
        want, want_sums = dyconv_plain(x, k, mul, add, emit_gap=True)
        got = dyconv(x, k, mul, add)
        err = compare_bf16(smoke, f"dyconv {label} {tuple(x.shape)} -> "
                           f"{tuple(got.shape)}", got, want)
        got_g, sums = dyconv(x, k, mul, add, emit_gap=True)
        smoke.check(f"dyconv {label} emit_gap leaves the output as it is",
                    torch.equal(got_g, got), "bitwise")
        again, sums_again = dyconv(x, k, mul, add, emit_gap=True)
        smoke.check(f"dyconv {label} emit_gap twice on the same input",
                    torch.equal(again, got_g)
                    and torch.equal(sums_again, sums),
                    "output and sums bitwise equal")
        sums_close(f"dyconv {label} emit_gap sums vs plain", sums, want_sums,
                   1e-3)
        sums_close(f"dyconv {label} emit_gap sums vs its own stored output",
                   sums, parity_sums(got), 1e-5)
        if fold:
            folded = dyconv(x, k, mul, add, fold_out=True)
            smoke.check(f"dyconv {label} fold_out == rfold(out)",
                        torch.equal(folded, rfold(got)),
                        f"bitwise, {tuple(folded.shape)}")
            compare_bf16(smoke, f"dyconv {label} fold_out vs plain", folded,
                         dyconv_plain(x, k, mul, add, fold_out=True))
        return err

    def check_full_batch(label, x, k, mul, add, emit):
        """The launch the main path makes at this site, all images at once,
        against the plain version a few images at a time. -> max abs error."""
        res = dyconv(x, k, mul, add, emit_gap=emit)
        got, sums = res if emit else (res, None)
        n, ok, err, sum_err, sum_top = SOEM_CHECK_BATCH, True, 0.0, 0.0, 0.0
        for s in range(0, x.shape[0], n):
            want, want_sums = dyconv_plain(x[s:s + n], k[s:s + n], mul,
                                           add[s:s + n], emit_gap=True)
            g, w = got[s:s + n].float(), want.float()
            ok = ok and bool(torch.isfinite(g).all()) and torch.allclose(
                g, w, rtol=RTOL, atol=ATOL)
            err = max(err, float((g - w).abs().max()))
            if emit:
                sum_err = max(sum_err, float(
                    (sums[s:s + n] - want_sums).abs().max()))
                sum_top = max(sum_top, float(want_sums.abs().max()))
        ok = ok and sum_err <= 1e-3 * sum_top
        smoke.check(f"dyconv {label} one launch of {x.shape[0]} images, all "
                    f"held against plain {n} at a time", ok,
                    f"max_abs_err {err:.6g} (rtol {RTOL}, atol {ATOL})"
                    + (f"; sums max_abs_err {sum_err:.6g} of {sum_top:.6g} "
                       "(rtol 1e-3 of the largest sum)" if emit else ""))
        return err

    @torch.inference_mode()
    def kernel_d():
        # sizes on both sides of the kernel's pixel tile, K chunk and N tiles
        for b, h, w, c, co in EDGE_SHAPES:
            x = torch.randn((b, h, w, c), generator=gen, device=dev)
            k = torch.randn((b, 9, c, co), generator=gen, device=dev) \
                * (2.0 / (9 * c)) ** 0.5
            mul = 0.5 + torch.rand((co,), generator=gen, device=dev)
            add = 0.3 * torch.randn((b, co), generator=gen, device=dev)
            check_dyconv("edge", x.to(torch.bfloat16), k.to(torch.bfloat16),
                         mul, add, fold=h % 2 == 0)

        def recording(x, k, mul, add, emit_gap=False):
            sites.append((x, k, mul, add, emit_gap))
            return dyconv(x, k, mul, add, emit_gap=emit_gap)

        soem_model(preprocess(soem_frames, SOEM_SIZE), conv=recording)
        smoke.check("dyconv sites", len(sites) == 3,
                    f"{[tuple(s[0].shape) for s in sites]} -> "
                    f"{[s[1].shape[-1] for s in sites]} channels, emit_gap "
                    f"{[s[4] for s in sites]}")
        errs, total = [], {"bytes": 0, "operations": 0, "bound_ms": 0.0}
        n = SOEM_CHECK_BATCH
        for i, (x, k, mul, add, emit) in enumerate(sites):
            errs.append(check_dyconv(f"soem_{i}", x[:n], k[:n], mul, add[:n],
                                     fold=i == 0))
            errs.append(check_full_batch(f"soem_{i}", x, k, mul, add, emit))
            bb, hh, ww, cc = x.shape
            oc = k.shape[-1]
            site = bound(nbytes(x, k, mul, add) + bb * hh * ww * oc * 2,
                         2 * 9 * cc * oc * bb * hh * ww, BF16_FLOPS)
            print(f"  soem_{i} bound {site}")
            for key in total:
                total[key] += site[key]
            inputs[f"dyconv_{i}"] = site
        smoke.stats["dyconv"]["max_abs_err"] = max(errs)
        # the three sites of one request: their bounds add up, and the sum
        # is bound by what bounds the larger part of it
        by = {"bytes": 0.0, "operations": 0.0}
        for i in range(len(sites)):
            site = inputs[f"dyconv_{i}"]
            by[site["bound_by"]] += site["bound_ms"]
        smoke.stats["dyconv"].update(total, bound_by=max(by, key=by.get))

    smoke.phase("5 kernel D", kernel_d)

    def stem_ops(shape):
        """2 x 27 x 32 per pixel of the first layer + 2 x 288 x 64 per pixel
        of the second."""
        b, h, w, _ = shape
        return 2 * b * (27 * 32 * h * w
                        + 288 * 64 * ((h + 1) // 2) * ((w + 1) // 2))

    @torch.inference_mode()
    def kernel_e():
        x, k1 = inputs["l1"]
        a1, k2 = inputs["l2"]
        out = stem_fused(x, k1, k2)
        err = compare_bf16(smoke, f"stem_fused uint8 {tuple(x.shape)} -> "
                           f"{tuple(out.shape)} vs plain", out,
                           stem_fused_plain(x, k1, k2))
        smoke.stats["stem_fused"]["max_abs_err"] = err
        smoke.check("stem_fused uint8 == stem_l2(stem_l1), bitwise",
                    torch.equal(out, stem_l2(a1, k2)), f"{tuple(out.shape)}")
        smoke.stats["stem_fused"].update(bound(
            nbytes(x, out) + (k1.numel() + k2.numel()) * 2,
            stem_ops(x.shape), BF16_FLOPS))
        odd = torch.rand((2, 97, 161, 3), generator=gen, device=dev)
        odd = odd.to(torch.bfloat16)
        k1 = stem_l1_weights(odd, dy0, temp)
        a1, sums = stem_l1(odd, k1)
        k2 = stem_l2_weights(sums, 97 * 161, dy1, temp)
        out = stem_fused(odd, k1, k2)
        compare_bf16(smoke, "stem_fused bf16 (2,97,161,3) -> (2,49,81,64) "
                     "vs plain", out, stem_fused_plain(odd, k1, k2))
        smoke.check("stem_fused bf16 odd == stem_l2(stem_l1), bitwise",
                    torch.equal(out, stem_l2(a1, k2)), f"{tuple(out.shape)}")
        # its path: the public op, as a caller that holds K1 and K2 calls it
        x, k1 = inputs["l1"]
        k2 = inputs["l2"][1]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        outs = [stem_fused(x, k1, k2) for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "stem_fused op", REQUESTS)
        smoke.check("stem_fused op results", all(
            o.shape == (BATCH, SIZE // 2, SIZE // 2, 64)
            and bool(torch.isfinite(o.float()).all()) for o in outs),
            f"{REQUESTS} x {tuple(outs[0].shape)} finite")

    def run_ladder(name, entry, stages):
        """A ladder's command-line entry as its path: every stage launched
        and timed by the script's own ``main``."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        rc = entry.main(["--iters", str(LADDER_ITERS)])
        torch.cuda.synchronize()
        smoke.check(f"{name} main", rc == 0, f"returned {rc}; stages "
                    f"{list(stages)}")
        count_launches(smoke, kernels, name, 1)

    @torch.inference_mode()
    def kernel_f():
        a1, k2 = inputs["l2"]
        full, ref = stem_l2_stage(a1, k2, "full"), stem_l2(a1, k2)
        smoke.check("stem_l2_stage full == stem_l2, bitwise",
                    torch.equal(full, ref), f"{tuple(full.shape)}")
        err = compare_bf16(smoke, "stem_l2_stage full vs plain", full,
                           stem_l2_plain(a1, k2))
        smoke.stats["stem_l2_stage"]["max_abs_err"] = err
        smoke.stats["stem_l2_stage"].update(
            {k: smoke.stats["stem_l2"][k] for k in
             ("bound_ms", "bound_by", "bytes", "operations")})
        run_ladder("l2_ablate", l2_ablate, L2_STAGES)

    def check_block(label, x, w1, k2, k3, packed=None):
        """The kernel (on the packed weights where given) against its plain
        version, and a second launch bitwise equal to the first."""
        ws = packed if packed is not None else (w1, k2, k3)
        got = post_stem_block(x, *ws)
        want = post_stem_block_plain(x, w1, k2, k3)
        err = compare_bf16(smoke, f"post_stem_block {label} "
                           f"{tuple(x.shape)} -> {tuple(got.shape)}", got,
                           want)
        smoke.check(f"post_stem_block {label} twice on the same input",
                    torch.equal(post_stem_block(x, *ws), got), "bitwise")
        return got, err

    @torch.inference_mode()
    def kernel_g():
        w1, k2, k3 = fold_block_weights(model)
        packed = pack_block_weights(w1, k2, k3)
        x = stem_l2(*inputs["l2"])        # what the block sees in DyYOLO
        inputs["block"] = (x, packed)
        got, err = check_block("DyYOLO's weights", x, w1, k2, k3, packed)
        smoke.check("post_stem_block packed once == packed per call",
                    torch.equal(post_stem_block(x, w1, k2, k3), got),
                    "bitwise")
        smoke.stats["post_stem_block"]["max_abs_err"] = err
        b, h, w, _ = x.shape
        ho, wo = (h + 1) // 2, (w + 1) // 2
        smoke.stats["post_stem_block"].update(bound(
            nbytes(x) + b * ho * wo * 128 * 2
            + (w1.numel() + k2.numel() + k3.numel()) * 2,
            2 * b * (h * w * (64 * 32 + 288 * 64) + ho * wo * 576 * 128),
            BF16_FLOPS))
        odd = torch.randn((2, 37, 45, 64), generator=gen, device=dev)
        check_block("odd", odd.to(torch.bfloat16), w1, k2, k3, packed)
        for shape in BLOCK_EDGE_SHAPES:
            edge = torch.randn((*shape, 64), generator=gen, device=dev)
            check_block("edge", edge.to(torch.bfloat16), w1, k2, k3, packed)
        # biases of the size of the activations: with leaky(bias) in place
        # of zero outside the image, every border output would be off
        small = torch.randn((3, 16, 24, 64), generator=gen, device=dev)
        big = [torch.cat([k[:, :-1], torch.full_like(k[:, -1:], v)], dim=1)
               for k, v in ((w1, 1.0), (k2, -1.5), (k3, 0.5))]
        check_block("border, large biases", small.to(torch.bfloat16), *big,
                    pack_block_weights(*big))
        run_ladder("block_ablate", block_ablate, BLOCK_STAGES)

    smoke.phase("5e kernel E", kernel_e)
    smoke.phase("5f kernel F", kernel_f)
    smoke.phase("5g kernel G", kernel_g)
    smoke.phase("5n group_norm1", group_norm1_checks, smoke, dev, gen)
    smoke.phase("5o bn_act", bn_act_checks, smoke, dev, gen)

    detect = make_detector(model, DYYOLO, SIZE)
    anchors = DYYOLO.anchors

    @torch.inference_mode()
    def main_path():
        requests = [torch.randint(0, 256, (BATCH, SIZE, SIZE, 3),
                                  dtype=torch.uint8, device=dev,
                                  generator=gen) for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results = [detect(r) for r in requests]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DyYOLO", REQUESTS)
        check_requests(smoke, results, BATCH)
        inputs["dyyolo"] = requests[0]
        compare_with_plain_stem(requests[0], results[0])
        # a fourth call, on fresh frames: replayed as CUDA graphs
        fresh = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3),
                              dtype=torch.uint8, device=dev, generator=gen)
        compare_with_plain_stem(fresh, check_replay(
            smoke, "DyYOLO", detect, Detector(model, DYYOLO, SIZE), fresh))

    def compare_with_plain_stem(x, result):
        """DyYOLO on the frames x (raw uint8 at the detector's size, or
        preprocessed), with the plain versions in place of the kernels."""
        fast = detector_stem_fast_path(model)
        a_k = fast.stem(x)
        a_p = fused_stem_forward(x, dy0, dy1, temp, l1=stem_l1_plain,
                                 l2=stem_l2_plain)
        compare_bf16(smoke, f"stem output {tuple(a_p.shape)}", a_k, a_p)
        outs_k, outs_p = fast.tail(a_k), fast.tail(a_p)
        compare_heads(smoke, outs_k, outs_p)
        scales = [SIZE // o.obj.shape[2] for o in outs_p]
        boxes, scores = decode_topk_global(outs_p, anchors, scales, 512)
        plain = select_detections(boxes, scores, 0.001, 0.5, 300,
                                  alive_fn=nms_alive_plain)
        compare_detections(smoke, result, plain)

    smoke.phase("6 main path 1: DyYOLO", main_path)

    soem_detect = make_detector(soem_model, DYSOEM, SOEM_SIZE)

    @torch.inference_mode()
    def main_path_soem():
        shape = (SOEM_BATCH, SOEM_SIZE, SOEM_SIZE, 3)
        requests = [torch.randint(0, 256, shape, dtype=torch.uint8,
                                  device=dev, generator=gen)
                    for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        results = [soem_detect(r) for r in requests]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DySOEM_SimFPN", REQUESTS)
        print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB {tag}")
        check_requests(smoke, results, SOEM_BATCH)

        # the first frames of the first batch, with the plain versions in
        # place of the kernels (the f32 copies of the plain dyconv bound
        # how many frames fit)
        n = SOEM_PLAIN_FRAMES
        plain = plain_soem(requests[0][:n])
        compare_detections(smoke, soem_detect(requests[0][:n]), plain)
        # a fourth call, on fresh frames: replayed as CUDA graphs; its
        # first frames against the plain versions
        fresh = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                              generator=gen)
        got = check_replay(smoke, "DySOEM_SimFPN", soem_detect,
                           Detector(soem_model, DYSOEM, SOEM_SIZE), fresh)
        compare_detections(smoke, type(got)(*(t[:n] for t in got)),
                           plain_soem(fresh[:n]),
                           name="replayed detections vs plain path")

    def plain_soem(frames):
        """The Detections of ``frames`` with the plain versions in place
        of the kernels; their heads checked against the kernels'."""
        x = preprocess(frames, SOEM_SIZE)
        outs_k = soem_model(x)
        outs_p = soem_model(x, conv=dyconv_plain)
        print(f"plain versions on the first {len(frames)} of {SOEM_BATCH} "
              f"frames")
        compare_heads(smoke, outs_k, outs_p)
        scales = [SOEM_SIZE // o.obj.shape[2] for o in outs_p]
        return select_detections(
            *decode_topk_global(outs_p, DYSOEM.anchors, scales, 512), 0.001,
            0.5, 300, alive_fn=nms_alive_plain)

    smoke.phase("7 main path 2: DySOEM_SimFPN", main_path_soem)

    t0 = time.perf_counter()
    base_model = seeded_model("baseline", BASELINE, SEED)
    n_params = sum(p.numel() for p in base_model.parameters())
    print(f"model: BaselineModel full width, {n_params} parameters, seed "
          f"{SEED}, built in {time.perf_counter() - t0:.1f} s")
    base_detect = make_detector(base_model, BASELINE, SIZE)
    dual_detect = make_detector(model, DYYOLO, SIZE, dual=True)

    def uint8_frames(batch, hw):
        return torch.randint(0, 256, (batch, *hw, 3), dtype=torch.uint8,
                             device=dev, generator=gen)

    @torch.inference_mode()
    def main_path_baseline():
        requests = [uint8_frames(1, (SIZE, SIZE)) for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results = [base_detect(r) for r in requests]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "baseline", REQUESTS)
        check_requests(smoke, results, 1)
        compare_detections(smoke, results[0], plain_baseline(requests[0]))
        fresh = uint8_frames(1, (SIZE, SIZE))   # replayed as CUDA graphs
        got = check_replay(smoke, "baseline", base_detect,
                           Detector(base_model, BASELINE, SIZE), fresh)
        compare_detections(smoke, got, plain_baseline(fresh),
                           name="replayed detections vs plain path")

    def plain_baseline(frames):
        """The plain path: the same eager model, the plain NMS."""
        outs = base_model(preprocess(frames, SIZE))
        scales = [SIZE // o.obj.shape[2] for o in outs]
        return select_detections(
            *decode_topk_global(outs, BASELINE.anchors, scales, 512), 0.001,
            0.5, 300, alive_fn=nms_alive_plain)

    @torch.inference_mode()
    def main_path_dual():
        requests = [(uint8_frames(DUAL_BATCH, RGB_HW),
                     uint8_frames(DUAL_BATCH, IR_HW))
                    for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results = [dual_detect(rgb, ir) for rgb, ir in requests]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DyYOLO dual", REQUESTS)
        check_requests(smoke, results, 2 * DUAL_BATCH)
        x = preprocess_dual(*requests[0], SIZE)
        smoke.check("preprocess_dual",
                    x.shape == (2 * DUAL_BATCH, SIZE, SIZE, 3)
                    and x.dtype == torch.bfloat16
                    and 0.0 <= float(x.min()) and float(x.max()) <= 1.0,
                    f"{tuple(x.shape)} {x.dtype} in [{float(x.min()):.3f}, "
                    f"{float(x.max()):.3f}]")
        inputs["dual"] = requests[0]
        compare_with_plain_stem(x, results[0])
        fresh = (uint8_frames(DUAL_BATCH, RGB_HW),   # replayed as graphs
                 uint8_frames(DUAL_BATCH, IR_HW))
        got = check_replay(smoke, "DyYOLO dual", dual_detect,
                           Detector(model, DYYOLO, SIZE, dual=True), *fresh)
        compare_with_plain_stem(preprocess_dual(*fresh, SIZE), got)

    smoke.phase("7b main path 3: BaselineModel", main_path_baseline)
    smoke.phase("7c main path 4: DyYOLO dual-stream", main_path_dual)

    topk = NMS_LARGE_N
    topk_detect = make_detector(model, DYYOLO, SIZE, pre_nms_topk=topk)

    @torch.inference_mode()
    def main_path_topk():
        """More candidates than a cluster's shared memory holds (25,200 at
        640 px): the NMS kernel keeps its mask in device memory."""
        requests = [uint8_frames(BATCH, (SIZE, SIZE))
                    for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results = [topk_detect(r) for r in requests]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DyYOLO pre_nms_topk 4096", REQUESTS)
        check_requests(smoke, results, BATCH)
        compare_detections(smoke, results[0], plain_topk(requests[0]))
        fresh = uint8_frames(BATCH, (SIZE, SIZE))   # replayed as graphs
        got = check_replay(smoke, "DyYOLO pre_nms_topk 4096", topk_detect,
                           Detector(model, DYYOLO, SIZE, pre_nms_topk=topk),
                           fresh)
        compare_detections(smoke, got, plain_topk(fresh),
                           name="replayed detections vs plain path")

    def plain_topk(frames):
        fast = detector_stem_fast_path(model)
        outs = fast.tail(fast.stem(frames))
        scales = [SIZE // o.obj.shape[2] for o in outs]
        boxes, scores = decode_topk_global(outs, anchors, scales, topk)
        smoke.check("pre_nms_topk candidates", boxes.shape[1] == topk,
                    f"{tuple(boxes.shape)}")
        return select_detections(boxes, scores, 0.001, 0.5, 300,
                                 alive_fn=nms_alive_plain)

    t0 = time.perf_counter()
    f32_model = seeded_model("DySOEM_SimFPN", DYSOEM, SEED,
                             dtype=torch.float32)
    f32_cpu = seeded_model("DySOEM_SimFPN", DYSOEM, SEED, "cpu",
                           torch.float32)
    print(f"model: DySOEM_SimFPN full width, float32, on the card and on "
          f"the CPU, built in {time.perf_counter() - t0:.1f} s")

    @torch.inference_mode()
    def main_path_soem_f32():
        """No kernel claims a float32 SOEM: the grouped conv serves it (TF32
        off, as set above), held against the CPU."""
        detect_f32 = make_detector(f32_model, DYSOEM, F32_SIZE,
                                   compute_dtype=torch.float32)
        requests = [uint8_frames(F32_BATCH, (F32_SIZE, F32_SIZE))
                    for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results = [detect_f32(r) for r in requests]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DySOEM_SimFPN float32", REQUESTS)
        check_requests(smoke, results, F32_BATCH)
        on_cpu = make_detector(f32_cpu, DYSOEM, F32_SIZE,
                               compute_dtype=torch.float32)

        def cpu(frames):
            d = on_cpu(frames.cpu())
            return type(d)(*(t.to(dev) for t in d))
        compare_detections(smoke, results[0], cpu(requests[0]),
                           F32_LOGIT_TOL,
                           "float32 detections on the card vs the CPU")
        fresh = uint8_frames(F32_BATCH, (F32_SIZE, F32_SIZE))
        got = check_replay(smoke, "DySOEM_SimFPN float32", detect_f32,
                           Detector(f32_model, DYSOEM, F32_SIZE,
                                    compute_dtype=torch.float32), fresh)
        compare_detections(smoke, got, cpu(fresh), F32_LOGIT_TOL,
                           "replayed float32 detections on the card vs the "
                           "CPU")

    smoke.phase("7d main path 5: DyYOLO, pre_nms_topk 4096", main_path_topk)
    smoke.phase("7e main path 6: DySOEM_SimFPN float32", main_path_soem_f32)

    from types import SimpleNamespace

    from uavdet_tpu_torch.models.layers import BatchNorm2d
    from uavdet_tpu_torch.ops.losses import yolo_loss
    from uavdet_tpu_torch.ops.targets import encode_yolo_targets
    from uavdet_tpu_torch.training import (MetricsWriter, Trainer,
                                           build_optimizer, init_state,
                                           make_eval_step, make_train_step)
    from uavdet_tpu_torch.training.steps import autocast
    from uavdet_tpu_torch.utils.config import Config

    bf16 = torch.bfloat16

    def train_state(model, hp):
        optimizer, scheduler = build_optimizer(model.parameters(), hp)
        return init_state(model, optimizer, scheduler)

    def moved(params, before) -> float:
        return max(float((p.detach() - q).abs().max())
                   for p, q in zip(params, before))

    @torch.no_grad()
    def snapshot(model):
        return [p.detach().clone() for p in model.parameters()]

    def train_path_dyyolo():
        model_t = seeded_model("DyYOLO", DYYOLO, SEED, dtype=torch.float32)
        state = train_state(model_t, DYYOLO)
        step = make_train_step(model_t, DYYOLO, SIZE, compute_dtype=bf16,
                               grad_batches=TRAIN_GRAD_BATCHES)
        batches = [painted_batch(gen, dev, TRAIN_BATCH, SIZE)
                   for _ in range(TRAIN_MICRO)]
        before = snapshot(model_t)
        seen, handles = conv_dtype_hooks(model_t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        metrics = [step(state, b) for b in batches]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DyYOLO train step", TRAIN_MICRO)
        for h in handles:
            h.remove()
        losses = [float(m["loss"]) for m in metrics]
        smoke.check("DyYOLO train losses finite",
                    all(np.isfinite(losses)), f"{losses}")
        smoke.check("DyYOLO train parameters moved",
                    moved(model_t.parameters(), before) > 0,
                    f"max |change| {moved(model_t.parameters(), before):.3g}")
        smoke.check("DyYOLO train counters",
                    (state.step, state.mini_step, state.scheduler.last_epoch)
                    == (TRAIN_MICRO // TRAIN_GRAD_BATCHES, 0,
                        TRAIN_MICRO // TRAIN_GRAD_BATCHES),
                    f"step {state.step}, scheduler {state.scheduler.last_epoch}"
                    f", mini_step {state.mini_step} after {TRAIN_MICRO} "
                    f"microbatches of grad_batches {TRAIN_GRAD_BATCHES}")
        smoke.check("DyYOLO train convs run in bf16",
                    len(seen) > 0 and set(seen) == {bf16},
                    f"{len(seen)} conv/DyConv outputs, dtypes {set(seen)}")
        print(f"peak device memory of 8 train microbatches "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}")
        inputs["train"] = (model_t, state, step, batches)

    smoke.phase("7f train path 1: DyYOLO at cfg6", train_path_dyyolo)

    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")

    def trainer_config():
        return Config({
            "dataset": {"batch_size": TRAIN_BATCH, "image_size": [SIZE, SIZE]},
            "train": {"seed": SEED, "trainer": {
                "epochs": 1, "grad_batches": TRAIN_GRAD_BATCHES,
                "train_batches": 4, "val_batches": TRAIN_VAL_BATCHES,
                "val_check_interval": 1.0, "precision": "bf16",
                "grad_clip_val": None, "eval_ap": True, "profiler": None},
                "checkpoint": {"dir": f"{workdir}/ck", "monitor": "val_loss",
                               "mode": "min"}},
            "model": {"name": "DyYOLO", "hparams": as_dict(DYYOLO)}})

    def trainer_path():
        import os
        train_b = BatchList([painted_batch(gen, dev, TRAIN_BATCH, SIZE)
                             for _ in range(4)])
        val_b = BatchList([painted_batch(gen, dev, TRAIN_BATCH, SIZE)
                           for _ in range(TRAIN_VAL_BATCHES)])
        trainer = Trainer(trainer_config(), train_b, val_b,
                          metrics=MetricsWriter(f"{workdir}/dv"))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        final = trainer.fit()
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "Trainer.fit DyYOLO",
                       TRAIN_VAL_BATCHES)
        smoke.check("Trainer.fit val_loss and val_AP",
                    np.isfinite(final["val_loss"]) and final["val_AP"] >= 0,
                    f"{final}")
        names = sorted(os.listdir(f"{workdir}/ck"))
        smoke.check("Trainer.fit files",
                    os.path.exists(f"{workdir}/dv/metrics.json")
                    and len(names) == 3 and names[0].startswith("best-00-")
                    and names[1:] == ["last", "meta.json"], f"{names}")
        again = Trainer(trainer_config(), train_b, val_b,
                        metrics=MetricsWriter(f"{workdir}/dv2"))
        kernels.reset_launch_counts()
        final2 = again.fit(resume=True)
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "Trainer.fit DyYOLO",
                       TRAIN_VAL_BATCHES)
        smoke.check("Trainer.fit(resume=True) restores the step",
                    again.state.step == 2 * trainer.state.step
                    and np.isfinite(final2["val_loss"]),
                    f"step {again.state.step} after resuming from "
                    f"{trainer.state.step}")
        inputs["trainer"] = (trainer, val_b)
        # the trainer's detector against the same model with the plain
        # versions of kernels A, B and C, under the same autocast
        m = trainer.model.eval()
        x = val_b.batches[0].image
        with torch.inference_mode(), autocast(dev, bf16):
            d = trainer._detector(x)
            xp = preprocess(x, SIZE, bf16)
            fast = detector_stem_fast_path(m)
            a_p = fused_stem_forward(xp, m.layers[0], m.layers[1],
                                     m.attn_temperature, l1=stem_l1_plain,
                                     l2=stem_l2_plain)
            outs_p = fast.tail(a_p)
            scales = [SIZE // o.obj.shape[2] for o in outs_p]
            plain = select_detections(
                *decode_topk_global(outs_p, DYYOLO.anchors, scales, 512),
                0.001, 0.5, 300, alive_fn=nms_alive_plain)
        compare_detections(smoke, d, plain,
                           name="Trainer detections vs plain path")

    smoke.phase("7g trainer path: Trainer.fit at cfg6", trainer_path)

    def val_loss(outs, batch, hp, size):
        lb = hp.loss_balancing
        scales = [size // o.obj.shape[2] for o in outs]
        grids = encode_yolo_targets(batch.boxes, batch.box_mask, hp.anchors,
                                    scales, size)
        return yolo_loss(outs, grids, hp.anchors, scales,
                         obj_scales_w=lb.obj_scales_w, bbox_w=lb.bbox_w,
                         objectness_w=lb.objectness_w, no_obj_w=lb.no_obj_w,
                         bbox_loss_fn=hp.bbox_loss_fn)

    def train_path_soem():
        soem_t = seeded_model("DySOEM_SimFPN", DYSOEM, SEED,
                              dtype=torch.float32)
        state = train_state(soem_t, DYSOEM)
        step = make_train_step(soem_t, DYSOEM, SOEM_SIZE, compute_dtype=bf16)
        batches = [painted_batch(gen, dev, SOEM_TRAIN_BATCH, SOEM_SIZE)
                   for _ in range(SOEM_TRAIN_MICRO + 1)]
        before = snapshot(soem_t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        metrics = [step(state, b) for b in batches[:SOEM_TRAIN_MICRO]]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DySOEM_SimFPN train step",
                       SOEM_TRAIN_MICRO)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(m["loss"]) for m in metrics]
        smoke.check("DySOEM_SimFPN train losses finite and parameters moved",
                    all(np.isfinite(losses))
                    and moved(soem_t.parameters(), before) > 0
                    and state.step == SOEM_TRAIN_MICRO,
                    f"{losses}, {state.step} updates")
        print(f"DySOEM_SimFPN train @{SOEM_SIZE} bs={SOEM_TRAIN_BATCH}: peak "
              f"device memory {peak:.2f} GiB {tag}")
        smoke.stats["dyconv"]["train_peak_gib"] = peak
        val = batches[-1]
        eval_step = make_eval_step(soem_t, DYSOEM, SOEM_SIZE,
                                   compute_dtype=bf16)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = eval_step(val)
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DySOEM_SimFPN eval step", 1)
        with torch.no_grad(), autocast(dev, bf16):
            outs_k = soem_t(val.image)
            outs_p = soem_t(val.image, conv=dyconv_plain)
        # the limit is in the logit (LOGIT_TOL, as for the detections)
        err = max(float((getattr(a, f).float() - getattr(b, f).float())
                        .abs().max())
                  for a, b in zip(outs_k, outs_p) for f in ("obj", "bbox"))
        smoke.check("DySOEM_SimFPN eval logits vs plain dyconv",
                    err < LOGIT_TOL, f"max |logit diff| {err:.4g} (limit "
                    f"{LOGIT_TOL})")
        want = val_loss(outs_p, val, DYSOEM, SOEM_SIZE).total
        # BCE moves by at most the logit's error, the box terms by a small
        # multiple of it: a loss of ~10 moves far less than 5 %
        rel = abs(float(got["loss"]) - float(want)) / float(want)
        smoke.check("DySOEM_SimFPN val loss vs plain dyconv", rel < 0.05,
                    f"{float(got['loss']):.6f} vs {float(want):.6f} "
                    f"(relative {rel:.3g}; limit 0.05)")

    smoke.phase("7h train path 2: DySOEM_SimFPN", train_path_soem)

    tiny_hp = SimpleNamespace(
        anchors=(((40, 30), (60, 46), (54, 36)),
                 ((18, 14), (24, 18), (30, 12)),
                 ((6, 5), (10, 6), (13, 8))),
        lr=0.001, lr_scheduler=False, bbox_loss_fn="mse",
        loss_balancing=SimpleNamespace(obj_scales_w=(0.5, 1.0, 2.0),
                                       bbox_w=4.0, objectness_w=1.0,
                                       no_obj_w=4.0),
        optim=SimpleNamespace(name="SGD", momentum=0.78),
        attn_temperature=30.0, layer_config=TINY)

    def f32_train_parity():
        # noise frames: flat painted regions would share one pre-activation
        # per region, whose float-noise sign flips make training chaotic
        # after the first update (tests/test_torch_train_trainer.py)
        gen_cpu = torch.Generator().manual_seed(SEED)
        batches = [painted_batch(gen_cpu, "cpu", PARITY_BATCH, PARITY_SIZE, 2)
                   for _ in range(PARITY_MICRO)]
        batches = [b._replace(image=torch.rand(b.image.shape,
                                               generator=gen_cpu))
                   for b in batches]
        losses = {}
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            m = seeded_model("DyYOLO", tiny_hp, SEED, where,
                             dtype=torch.float32)
            state = train_state(m, tiny_hp)
            step = make_train_step(m, tiny_hp, PARITY_SIZE, grad_batches=2)
            losses[side] = np.array([
                float(step(state, type(b)(*(t.to(where) for t in b)))["loss"])
                for b in batches])
        rel = np.abs(losses["card"] - losses["cpu"]) / losses["cpu"]
        smoke.check("float32 train steps, card vs CPU",
                    bool((rel < PARITY_RTOL).all()),
                    f"card {losses['card'].tolist()} cpu "
                    f"{losses['cpu'].tolist()} relative {rel.tolist()} "
                    f"(rtol {PARITY_RTOL})")

    smoke.phase("7i float32 train steps: card vs CPU", f32_train_parity)

    import contextlib
    import io

    import glob

    from uavdet_tpu_torch import evaluate as evaluate_entry
    from uavdet_tpu_torch import prepare_dataloader
    from uavdet_tpu_torch import train as train_entry
    from uavdet_tpu_torch.scripts import detect as detect_entry
    from uavdet_tpu_torch.training import CheckpointManager
    from uavdet_tpu_torch.data import (DataPipeline, load_manifest,
                                       make_synthetic_dataset)
    from uavdet_tpu_torch.data import frames as frame_ops
    from uavdet_tpu_torch.data.synthetic import CARD_QUALITY, synthetic_frames

    data_root = "data/Anti-UAV-RGBT"
    tree = dict(n_seq=DATA_SEQ, n_frames=DATA_FRAMES, img_size=DATA_SIZE,
                seed=SEED)

    def data_config():
        """params.yaml of the data path: cfg6's trainer over the tree."""
        cfg = trainer_config().to_dict()
        cfg["dataset"] = {
            "root_dir": data_root,
            "train_loader_path": "data/train_manifest.json",
            "val_loader_path": "data/val_manifest.json",
            "test_loader_path": "data/test_manifest.json",
            "batch_size": TRAIN_BATCH, "remote": False,
            "image_size": [SIZE, SIZE], "workers": DATA_WORKERS,
            "mosaic": False, "format": "yolo"}
        cfg["train"]["checkpoint"]["dir"] = "logs/checkpoints"
        return Config(cfg)

    class HostFrames(DataPipeline):
        """The pipeline on the CPU with the frames nvJPEG decodes copied to
        the host in place of PIL's (absent here): the CPU's plan, boxes and
        frame stage, on the frames the card decodes."""

        def _load(self, path, stream=None):
            return jpeg.decode([self._read(path)], dev)[0].cpu()

    def pipeline_fps(recs, train, batch, workers, mosaic=False):
        """Frames per second of the pipeline alone over DATA_EPOCHS epochs
        after one."""
        pipe = DataPipeline(recs, SIZE, batch, train=train, seed=11,
                            workers=workers, mosaic=mosaic, device=dev)
        list(pipe)
        torch.cuda.synchronize()
        t0, n = time.perf_counter(), 0
        for _ in range(DATA_EPOCHS):
            for b in pipe:
                n += b.image.shape[0]
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0), n

    def pipeline_alone(recs, train, batch):
        """The pipeline's frames per second alone with DATA_WORKERS read
        and decode threads and with one, and ms per batch of decode (one
        thread, one image after another) and of the frame stage."""
        fps, n = pipeline_fps(recs, train, batch, DATA_WORKERS)
        fps_1, _ = pipeline_fps(recs, train, batch, 1)
        datas = []
        for r in recs[:batch]:
            with open(r["img_path"], "rb") as f:
                datas.append(f.read())
        decode_ms = cuda_ms(lambda: jpeg.decode(datas, dev), 10, 2)
        decoded = jpeg.decode(datas, dev)
        mats = ([frame_ops.affine_matrix(np.random.default_rng(i), SIZE)
                 for i in range(batch)] if train else None)
        stage_ms = cuda_ms(lambda: frame_ops.frame_stage(decoded, SIZE, mats),
                           10, 2)
        return {"frames_per_s": fps, "frames_per_s_1_worker": fps_1,
                "workers": DATA_WORKERS, "frames": n, "decode_ms": decode_ms,
                "frame_stage_ms": stage_ms, "batch": batch,
                "source": f"{DATA_SIZE}x{DATA_SIZE}", "size": SIZE}

    def fed_vs_painted(recs):
        """cfg6 ms per microbatch fed by the pipeline against the painted
        batches of 7f, in turns: with DATA_WORKERS read and decode threads,
        with one, and on the pipeline's batches taken into a list first
        (the hand-off alone, no producer running beside the step). An
        epoch's first microbatch waits for the pipeline to start and is
        timed apart."""
        model_t, state, step, painted = inputs["train"]
        pipes = {w: DataPipeline(recs, SIZE, TRAIN_BATCH, train=True,
                                 seed=11, workers=w, device=dev)
                 for w in (DATA_WORKERS, 1)}
        n = len(pipes[1])

        def run(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first = None
            m = 0
            for b in batches:
                step(state, b)
                m += 1
                if first is None:
                    torch.cuda.synchronize()
                    first = time.perf_counter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            return {"first_ms": (first - t0) * 1e3,
                    "steady_ms": (t1 - first) * 1e3 / (m - 1), "n": m}

        fed = f"fed_{DATA_WORKERS}"
        variants = {
            "painted": lambda: run([painted[i % len(painted)]
                                    for i in range(n)]),
            fed: lambda: run(pipes[DATA_WORKERS]),
            f"{fed}_materialized": lambda: run(list(pipes[DATA_WORKERS])),
            "fed_1": lambda: run(pipes[1]),
        }
        order = list(variants) + list(variants)[::-1]
        out = {k: [] for k in variants}
        kernels.reset_launch_counts()
        for which in order:
            out[which].append(variants[which]())
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DyYOLO train step fed by the pipeline",
                       sum(r["n"] for v in out.values() for r in v))
        return out

    def data_path():
        here = os.getcwd()
        ddir = os.path.join(workdir, "data_path")
        os.makedirs(ddir)
        os.chdir(ddir)   # the entry points write under the working directory
        try:
            run_data_path()
        finally:
            os.chdir(here)

    def run_data_path():
        info = jpeg_build.result()
        print(f"nvJPEG library: nvcc {info.seconds:.1f} s -> {info.path.name}")
        t0 = time.perf_counter()
        make_synthetic_dataset(data_root, device=dev, **tree)
        print(f"synthetic tree ({DATA_SEQ} sequences x 2 cameras x "
              f"{DATA_FRAMES} frames per split, {DATA_SIZE} px) written "
              f"through nvJPEG in {time.perf_counter() - t0:.2f} s")
        # 4. nvJPEG's decode of the frames its encoder wrote
        errs, signed = [], []
        for kind, path, arr in synthetic_frames(data_root, **tree):
            if kind == "frame":
                with open(path, "rb") as f:
                    got = jpeg.decode([f.read()], dev)[0]
                d = got.int() - torch.from_numpy(arr).to(dev).int()
                errs.append(float(d.abs().float().mean()))
                signed.append(float(d.float().mean()))
        smoke.check("nvJPEG decode of its own frames vs the drawn arrays",
                    max(errs) <= JPEG_MEAN_TOL,
                    f"{len(errs)} frames at quality {CARD_QUALITY}, 4:4:4: "
                    f"mean |diff| per frame {min(errs):.3f} to "
                    f"{max(errs):.3f} units (limit {JPEG_MEAN_TOL}), mean "
                    f"signed {np.mean(signed):+.3f}")
        reference = {}
        for name, (data, want) in jpeg.load_reference().items():
            want = torch.from_numpy(want).int()
            d = jpeg.decode([data], dev)[0].cpu().int() - want
            r = reference[name] = {"max": int(d.abs().max()),
                                   "mean": float(d.abs().float().mean()),
                                   "signed": float(d.float().mean())}
            try:   # nvJPEG's own conversion, for comparison
                own = jpeg.codec().decode_planes(
                    data, dev, jpeg.OUTPUT_RGBI,
                    [(*want.shape[:2], 3)])[0].cpu().int() - want
                r["nvjpeg_rgb"] = {"max": int(own.abs().max()),
                                   "mean": float(own.abs().float().mean()),
                                   "signed": float(own.float().mean())}
            except RuntimeError as e:
                r["nvjpeg_rgb"] = str(e)
            smoke.check(f"nvJPEG decode vs libjpeg (PIL) {name}",
                        r["max"] <= JPEG_REF_MAX
                        and r["mean"] <= JPEG_REF_MEAN
                        and abs(r["signed"]) <= JPEG_REF_BIAS,
                        f"{tuple(want.shape)}: max |diff| {r['max']} units "
                        f"(limit {JPEG_REF_MAX}), mean {r['mean']:.4f} "
                        f"(limit {JPEG_REF_MEAN}), mean signed "
                        f"{r['signed']:+.4f} (limit {JPEG_REF_BIAS}); "
                        f"nvJPEG's own RGB: {r['nvjpeg_rgb']}")

        cfg = data_config()
        counts = prepare_dataloader.main(cfg)
        smoke.check("prepare_dataloader manifests",
                    all(counts[s] > 0 for s in ("train", "val", "test"))
                    and all(os.path.exists(f"data/{s}_manifest.json")
                            for s in ("train", "val", "test")), f"{counts}")
        recs = load_manifest(cfg.dataset.train_loader_path)
        val_recs = load_manifest(cfg.dataset.val_loader_path)

        # 2. and 3.: the card's pipeline against the same pipeline on the
        # CPU, on the same decoded frames
        for name, train, batch in (("train", True, TRAIN_BATCH),
                                   ("val", False, EVAL_BATCH)):
            kw = dict(input_size=SIZE, batch_size=batch, train=train,
                      seed=11, workers=DATA_WORKERS)
            card = list(DataPipeline(recs, device=dev, **kw))
            host = list(HostFrames(recs, device="cpu", **kw))
            on_card = all(t.device == dev for c in card for t in c)
            same = len(card) == len(host) > 0 and all(
                torch.equal(c.box_mask.cpu(), h.box_mask)
                and torch.equal(c.boxes.cpu(), h.boxes)
                for c, h in zip(card, host))
            smoke.check(f"pipeline {name}: membership, masks and boxes, card "
                        "vs CPU, bitwise", same and on_card,
                        f"{len(card)} / {len(host)} batches of {batch}, "
                        f"{sum(int(c.box_mask.sum()) for c in card)} boxes, "
                        f"every tensor on {dev}: {on_card}")
            diff = max(float((torch.round(c.image.cpu() * 255)
                              - torch.round(h.image * 255)).abs().max())
                       for c, h in zip(card, host))
            mean = float(np.mean([float((torch.round(c.image.cpu() * 255)
                                         - torch.round(h.image * 255)).abs()
                                        .mean()) for c, h in zip(card, host)]))
            shape_ok = all(c.image.shape == (c.boxes.shape[0], SIZE, SIZE, 3)
                           and c.image.dtype == torch.float32 for c in card)
            smoke.check(f"frame stage {name}: card vs CPU",
                        diff <= FRAME_TOL_UNITS and shape_ok,
                        f"max |diff| {diff:.0f} units of 255 (limit "
                        f"{FRAME_TOL_UNITS}), mean {mean:.4f}")

        readings = {"pipeline": {}, "jpeg_reference": reference}
        for name, train, batch in (("train", True, TRAIN_BATCH),
                                   ("val", False, EVAL_BATCH)):
            r = pipeline_alone(recs, train, batch)
            readings["pipeline"][name] = r
            print(f"pipeline alone, {name} batch {batch}, {DATA_SIZE} px "
                  f"JPEGs -> {SIZE} px: {r['frames_per_s']:.1f} frames/s "
                  f"with {DATA_WORKERS} workers, "
                  f"{r['frames_per_s_1_worker']:.1f} with one, over "
                  f"{r['frames']} frames; decode "
                  f"{r['decode_ms']:.3f} ms/batch, frame stage "
                  f"{r['frame_stage_ms']:.3f} ms/batch {tag}")
        # the frame stage at the cameras' sizes (cfg2's streams), batched
        # per source size, with the training affine; card against CPU
        cams = [torch.randint(0, 256, (*hw, 3), dtype=torch.uint8,
                              device=dev, generator=gen)
                for hw in [RGB_HW] * DUAL_BATCH + [IR_HW] * DUAL_BATCH]
        mats = [frame_ops.affine_matrix(np.random.default_rng(i), SIZE)
                for i in range(len(cams))]
        cam_ms = cuda_ms(lambda: frame_ops.frame_stage(cams, SIZE, mats),
                         10, 2)
        pair = [0, DUAL_BATCH]   # one RGB and one infrared frame
        got = frame_ops.frame_stage([cams[i] for i in pair], SIZE,
                                    [mats[i] for i in pair])
        want = frame_ops.frame_stage([cams[i].cpu() for i in pair], SIZE,
                                     [mats[i] for i in pair])
        diff = float((torch.round(got.cpu() * 255)
                      - torch.round(want * 255)).abs().max())
        smoke.check("frame stage at the cameras' sizes: card vs CPU",
                    diff <= FRAME_TOL_UNITS,
                    f"RGB {RGB_HW} and infrared {IR_HW} -> {SIZE} px, max "
                    f"|diff| {diff:.0f} units (limit {FRAME_TOL_UNITS})")
        readings["frame_stage_cameras_ms"] = cam_ms
        print(f"frame stage of {DUAL_BATCH} RGB {RGB_HW} + {DUAL_BATCH} "
              f"infrared {IR_HW} uint8 frames -> {SIZE} px with the affine: "
              f"{cam_ms:.3f} ms per batch of {2 * DUAL_BATCH} {tag}")
        fed = fed_vs_painted(recs)
        readings["cfg6_fed_vs_painted"] = fed
        print("cfg6 train ms per microbatch, steady (an epoch's first "
              "microbatch apart) / first: " + "; ".join(
                  f"{k} {[round(r['steady_ms'], 3) for r in v]} / "
                  f"{[round(r['first_ms'], 3) for r in v]}"
                  for k, v in fed.items()) + f" {tag}")

        # 1. and 5.: train.main, evaluate.main and scripts.detect.main at
        # cfg6's shape, each on its default device
        kernels.reset_launch_counts()
        final = train_entry.main(cfg, [])
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "train entry point DyYOLO",
                       TRAIN_VAL_BATCHES)
        names = sorted(os.listdir("logs/checkpoints"))
        smoke.check("train entry point: metrics.json, best and last",
                    os.path.exists("dvclive/metrics.json")
                    and any(n.startswith("best-") for n in names)
                    and "last" in names and np.isfinite(final["val_loss"])
                    and final["val_AP"] >= 0, f"{names}, {final}")
        # twice: the first call's fps carries the new model's first
        # forward (cuDNN's choice of algorithms), as the JAX package's
        # carries its compile
        n_eval = -(-len(val_recs) // EVAL_BATCH)
        lines = []
        for run_i in range(2):
            kernels.reset_launch_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                evaluate_entry.main(cfg, ["--split", "val", "--batch",
                                          str(EVAL_BATCH)])
            torch.cuda.synchronize()
            text = buf.getvalue()
            print(text, end="")
            count_launches(smoke, kernels, "evaluate entry point DyYOLO",
                           n_eval)
            line = json.loads(text.strip().splitlines()[-1])
            smoke.check("evaluate entry point: output line",
                        {"map", "map_50", "images", "fps"} <= set(line)
                        and line["images"] == len(val_recs)
                        and "Restored checkpoint 'last'" in text,
                        f"{len(val_recs)} frames in {n_eval} batches: {line}")
            lines.append(line)
        readings["evaluate"] = {"fps": [x["fps"] for x in lines],
                                "images": lines[0]["images"],
                                "batch": EVAL_BATCH, "map": lines[0]["map"]}
        print(f"evaluate: {readings['evaluate']['fps']} fps (two runs) over "
              f"{lines[0]['images']} frames at batch {EVAL_BATCH} {tag}")
        readings["detect"] = detect_path(cfg)
        print(json.dumps({"data": readings}))

    def detect_path(cfg):
        """``scripts.detect.main`` over the val frames, then the same
        detector restored here on the first batch: its boxes at 640 px
        scaled back to the frames' pixels must be the JSON's."""
        val_glob = os.path.join(data_root, "val", "*", "*", "*.jpg")
        paths = sorted(glob.glob(val_glob))
        n_batches = -(-len(paths) // EVAL_BATCH)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = detect_entry.main(cfg, ["--images", val_glob, "--out",
                                     "dets.json", "--ckpt", "last",
                                     "--score", str(DETECT_SCORE),
                                     "--batch", str(EVAL_BATCH)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        count_launches(smoke, kernels, "detect entry point DyYOLO",
                       n_batches)
        with open("dets.json") as f:
            dets = json.load(f)
        root = os.path.join(data_root, "val")
        keys = {os.path.relpath(p, root) for p in paths}
        n_det = sum(len(v["scores"]) for v in dets.values())

        hp = cfg.model.hparams
        ck = cfg.train.checkpoint
        model_d = seeded_model(cfg.model.name, hp, 0, dev,
                               dtype=torch.float32)
        CheckpointManager(ck.dir, monitor=ck.monitor, mode=ck.mode).restore(
            train_state(model_d, hp), "last")
        model_d.to(bf16).eval()
        detect = make_detector(model_d, hp, SIZE,
                               score_threshold=DETECT_SCORE,
                               compute_dtype=bf16)
        chunk = paths[:EVAL_BATCH]
        datas = []
        for p in chunk:
            with open(p, "rb") as f:
                datas.append(f.read())
        decoded = frame_ops.decode(datas, dev)
        x = frame_ops.resize_frames(decoded, SIZE, antialias=True)
        d = detect(x.permute(0, 2, 3, 1).to(torch.uint8))
        scale = torch.tensor([DATA_SIZE / SIZE] * 4, device=dev)
        err, same_counts = 0.0, True
        for i, p in enumerate(chunk):
            keep = d.valid[i] & (d.scores[i].float() >= DETECT_SCORE)
            want = (d.boxes[i][keep].float() * scale).cpu().numpy()
            got = np.asarray(dets[os.path.relpath(p, root)]["boxes_xyxy"],
                             np.float64).reshape(-1, 4)
            same_counts &= got.shape == want.shape
            if got.shape == want.shape and len(got):
                err = max(err, float(np.abs(got - want).max()))
        smoke.check("detect entry point: path-keyed JSON in original pixels",
                    rc == 0 and set(dets) == keys and n_det > 0
                    and same_counts and err <= DETECT_BOX_TOL,
                    f"{len(dets)} frames keyed like "
                    f"{sorted(dets)[0]!r}, {n_det} detections at score >= "
                    f"{DETECT_SCORE}; first batch against the restored "
                    f"detector scaled by {DATA_SIZE}/{SIZE}: counts equal "
                    f"{same_counts}, max |diff| {err:.4f} px (limit "
                    f"{DETECT_BOX_TOL})")
        fps = len(paths) / seconds
        print(f"detect: {len(paths)} frames in {seconds:.2f} s "
              f"({fps:.1f} frames/s, files read, decoded, detected and "
              f"written to JSON) {tag}")
        return {"frames": len(paths), "seconds": seconds, "fps": fps,
                "detections": n_det}

    smoke.phase("7j data path: prepare_dataloader, train, evaluate, detect",
                data_path)

    # 7k: export. Artifacts of the four detectors and of the export CLI,
    # loaded in one fresh process that imports only uavdet_tpu_torch.export
    import subprocess
    from uavdet_tpu_torch.evaluate import evaluate_batches, restored_model
    from uavdet_tpu_torch.export import export_detector, load_detector
    from uavdet_tpu_torch.data.remote import make_filesystem
    from uavdet_tpu_torch.models.registry import serving_dtype
    from uavdet_tpu_torch.scripts import export_detector as export_entry
    from uavdet_tpu_torch.scripts import \
        port_reference_checkpoint as port_entry
    from uavdet_tpu_torch.utils.datatypes import Detections

    repo = os.path.dirname(os.path.abspath(__file__))
    export_dir = os.path.join(workdir, "export")
    LOADER = (
        "import json, sys\n"
        "import torch\n"
        "from uavdet_tpu_torch.export import load_detector\n"
        "counts = {}\n"
        "for job in json.loads(sys.argv[1]):\n"
        "    with open(job['artifact'], 'rb') as f:\n"
        "        det = load_detector(f.read())\n"
        "    kernels = sys.modules['uavdet_tpu_torch.kernels']\n"
        "    frames = torch.load(job['frames'])\n"
        "    torch.cuda.synchronize()\n"
        "    kernels.reset_launch_counts()\n"
        "    outs = [det(*frames) for _ in range(job['requests'])]\n"
        "    torch.cuda.synchronize()\n"
        "    counts[job['name']] = kernels.launch_counts()\n"
        "    torch.save(outs[0], job['out'])\n"
        "mods = sorted(sys.modules)\n"
        "bad = [m for m in mods if m.startswith('uavdet_tpu_torch.models') or"
        " m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'uavdet_tpu')]\n"
        "print(json.dumps({'counts': counts, 'bad': bad, 'port': [m for m in"
        " mods if m.startswith('uavdet_tpu_torch')]}))\n")

    def export_one(name, mdl, hp, size, batch, frames_, dual=False):
        """Exports ``mdl``'s detector; -> its loader job."""
        t0 = time.perf_counter()
        blob = export_detector(mdl, hp, size, batch, dual=dual)
        seconds = time.perf_counter() - t0
        path = os.path.join(export_dir, f"{len(jobs)}.pt2")
        with open(path, "wb") as f:
            f.write(blob)
        print(f"export {name}: {len(blob)} bytes, batch {batch}, dual "
              f"{dual}, {seconds:.1f} s")
        return dict(name=name, artifact=path, requests=REQUESTS,
                    frames=save_frames(frames_), out=f"{path}.out")

    def save_frames(frames_):
        path = os.path.join(export_dir, f"frames_{len(jobs)}.pt")
        torch.save(tuple(frames_), path)
        return path

    jobs = []

    def export_path():
        os.makedirs(export_dir)
        x16 = inputs["dyyolo"]
        rgb, ir = (t[:2] for t in inputs["dual"])
        live = {"exported DyYOLO": detect(x16)}
        jobs.append(export_one("exported DyYOLO", model, DYYOLO, SIZE,
                               BATCH, (x16,)))
        jobs.append(export_one("exported DySOEM_SimFPN", soem_model, DYSOEM,
                               SOEM_SIZE, 2, (soem_frames[:2],)))
        live["exported DySOEM_SimFPN"] = soem_detect(soem_frames[:2])
        jobs.append(export_one("exported DyYOLO dual", model, DYYOLO, SIZE,
                               2, (rgb, ir), dual=True))
        live["exported DyYOLO dual"] = dual_detect(rgb, ir)
        jobs.append(export_one("exported baseline", base_model, BASELINE,
                               SIZE, 1, (x16[:1],)))
        live["exported baseline"] = base_detect(x16[:1])
        with open(jobs[0]["artifact"], "rb") as f:   # timed in phase 8
            inputs["exported"] = load_detector(f.read())

        # the export CLI over 7j's checkpoint, on its default device
        here = os.getcwd()
        os.chdir(os.path.join(workdir, "data_path"))
        try:
            cfg = data_config()
            name = "exported DyYOLO, scripts.export_detector --ckpt last"
            path = os.path.join(export_dir, "cli.pt2")
            rc = export_entry.main(cfg, ["--out", path, "--ckpt", "last",
                                         "--batch", str(BATCH)])
            smoke.check("scripts.export_detector", rc == 0, f"rc {rc}")
            restored, _ = restored_model(cfg, "last", dev, bf16)
            live[name] = make_detector(restored, cfg.model.hparams,
                                       SIZE)(x16)
            jobs.append(dict(name=name, artifact=path, requests=REQUESTS,
                             frames=save_frames((x16,)), out=f"{path}.out"))
            del restored
            port_path(cfg)
        finally:
            os.chdir(here)

        torch.cuda.empty_cache()   # the fresh process shares the card
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", LOADER, json.dumps(jobs)], cwd=repo,
            env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
            text=True, timeout=600)
        print(res.stderr[-3000:], end="")
        smoke.check("fresh process loads the artifacts", res.returncode == 0,
                    f"rc {res.returncode}, {len(jobs)} artifacts in "
                    f"{time.perf_counter() - t0:.1f} s")
        report = json.loads(res.stdout.strip().splitlines()[-1])
        smoke.check("fresh process imports no models and no JAX",
                    not report["bad"], f"imported {report['bad']}; the "
                    f"port's modules there: {report['port']}")
        for job in jobs:
            got = Detections(*torch.load(job["out"]))
            want = live[job["name"]]
            err = float((got.scores - want.scores).abs().max())
            same = (torch.equal(got.valid, want.valid)
                    and torch.equal(got.scores, want.scores)
                    and torch.equal(got.boxes, want.boxes))
            print(f"{job['name']}: max |score diff| {err:.3g} against the "
                  f"live detector, bitwise equal {same}")
            compare_detections(smoke, got, want,
                               name=f"{job['name']} vs the live detector")
            count_launches(smoke, kernels, job["name"], REQUESTS,
                           counts=report["counts"][job["name"]])

    def port_path(cfg):
        """A Lightning-format checkpoint of phase 6's DyYOLO through
        scripts.port_reference_checkpoint and evaluate.main, against the
        same weights loaded directly and evaluated by the same loop."""
        sd = {k: v.float().cpu() for k, v in model.state_dict().items()}
        ckpt = os.path.join(export_dir, "reference.ckpt")
        torch.save({"state_dict": sd, "epoch": 1}, ckpt)
        cfg_p = cfg.to_dict()
        cfg_p["train"]["checkpoint"]["dir"] = "logs/ported"
        cfg_p = Config(cfg_p)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = port_entry.main(cfg_p, [ckpt, "logs/ported"])
        print(buf.getvalue(), end="")
        smoke.check("scripts.port_reference_checkpoint", rc == 0, f"rc {rc}")
        val_recs = load_manifest(cfg_p.dataset.val_loader_path)
        n_eval = -(-len(val_recs) // EVAL_BATCH)
        kernels.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            evaluate_entry.main(cfg_p, ["--split", "val", "--ckpt", "last",
                                        "--batch", str(EVAL_BATCH), "--dump",
                                        "ported.json"])
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "evaluate entry point, ported "
                       "checkpoint", n_eval)
        text = buf.getvalue()
        print(text, end="")
        line = json.loads(text.strip().splitlines()[-1])
        with open("ported.json") as f:
            dumped = json.load(f)["images"]
        direct = seeded_model("DyYOLO", DYYOLO, SEED + 1, dev,
                              dtype=torch.float32)
        direct.load_state_dict(sd)
        dtype = serving_dtype(dev)   # evaluate's
        direct.to(dtype).eval()
        ds = cfg_p.dataset
        pipe = DataPipeline(val_recs, input_size=SIZE, batch_size=EVAL_BATCH,
                            train=False, shuffle=False, drop_last=False,
                            fs=make_filesystem(ds.root_dir, False),
                            workers=DATA_WORKERS, device=dev)
        want, want_dump = evaluate_batches(
            make_detector(direct, DYYOLO, SIZE, compute_dtype=dtype), pipe,
            SIZE, dump=True)
        keys = sorted(k for k in want if k != "fps")
        map_err = max(abs(float(line[k]) - round(float(want[k]), 4))
                      for k in keys)
        score_err, counts_equal = 0.0, len(dumped) == len(want_dump)
        moved = unmatched = 0
        for g, w in zip(dumped, want_dump):
            gs, ws = np.asarray(g["scores"]), np.asarray(w["scores"])
            counts_equal &= gs.shape == ws.shape
            if gs.shape != ws.shape or not len(gs):
                continue
            score_err = max(score_err, float(np.abs(gs - ws).max()))
            gb = np.asarray(g["boxes_xyxy"]).reshape(-1, 4)
            wb = np.asarray(w["boxes_xyxy"]).reshape(-1, 4)
            # a box matches its slot, or one of the two slots on either side
            # that holds an equal score (tests/test_torch_detector.py)
            near = np.abs(np.arange(len(gs))[:, None]
                          - np.arange(len(gs))[None]) <= 2
            same = (np.abs(gb[:, None] - wb[None]).max(-1) <= 1e-4) & (
                np.abs(gs[:, None] - ws[None]) <= 1e-6) & near
            unmatched += int((~same.any(1)).sum())
            moved += int((~same.diagonal()).sum())
        smoke.check("evaluate over the ported checkpoint vs the weights "
                    "loaded directly",
                    line["images"] == want["images"] and map_err <= 1e-6
                    and counts_equal and score_err <= 1e-6
                    and unmatched == 0,
                    f"{line['images']} frames; mAP keys {keys} max |diff| "
                    f"{map_err:.3g} (limit 1e-6, the line rounds to 4 "
                    f"places); dump counts equal {counts_equal}, max |score "
                    f"diff| {score_err:.3g} (1e-6), boxes unmatched "
                    f"{unmatched} (1e-4 px), {moved} in a neighbouring slot "
                    f"of an equal score")
        del direct

    smoke.phase("7k export: artifacts served by a fresh process, the export "
                "and port CLIs", export_path)

    rtm = RTMAndMosaic(smoke, dev, gen, tag)
    smoke.phase("7l RTMUAVDet serving at cfg4", rtm.serving)
    smoke.phase("7m RTMUAVDet training at cfg5", rtm.training)
    smoke.phase("7n mosaic path", rtm.mosaic,
                os.path.join(workdir, "data_path"), data_config, HostFrames,
                pipeline_fps)

    md = MultiDevice(smoke, dev, tag, tiny_hp, DYYOLO)

    def md_one_process():
        _, state_t, step_t, batches_t = inputs["train"]
        md.one_process(batches_t, (state_t, step_t))

    def md_two_ranks():
        def frames_of(seed):
            g = torch.Generator(device=dev).manual_seed(seed)
            return torch.randint(0, 256, (BATCH, SIZE, SIZE, 3),
                                 dtype=torch.uint8, device=dev, generator=g)

        here = os.getcwd()
        os.chdir(os.path.join(workdir, "data_path"))   # 7j's tree
        try:
            md.two_ranks(data_config, detect, frames_of)
        finally:
            os.chdir(here)

    smoke.phase("7o multi-device (a): DDP and FSDP2 in a one-process NCCL "
                "group", md_one_process)
    smoke.phase("7o multi-device (b, c): two processes sharing the card "
                "over gloo", md_two_ranks)

    spep = SpatialExperts(smoke, dev, tag, md, DYYOLO)
    smoke.phase("7p sp and ep: spatial detects, halo'd kernels, sp and ep "
                "steps on two processes sharing the card", spep.run, detect,
                soem_detect)
    print(json.dumps({"multi_device": md.report}))

    pp = PipelineStages(smoke, dev, tag, tiny_hp, DYYOLO)
    smoke.phase("7q pp (a): float32 pp steps in 2 and 4 stages, card vs CPU",
                pp.parity)
    smoke.phase("7q pp (b): cfg6 in two stages against the plain step",
                pp.full_width)
    smoke.phase("7q pp (c, d): Trainer.fit with pp_devices 2, its checkpoint "
                "in a single-device Trainer, the refusal", pp.trainer,
                os.path.join(workdir, "pp"))
    bench_lines = smoke.phase("7r bench: python -m uavdet_tpu_torch.bench per "
                              "cell in a fresh process", run_bench, smoke,
                              repo) or {}
    smoke.phase("7s sections: roofline_table, section_probe and "
                "cfg3_section_probe", run_sections, smoke, model, soem_model)
    smoke.phase("7t the last probes: perf_probe, topk_compact_probe, "
                "chain_slope and bblock_probe", run_probes, smoke, model, tag)
    phase8 = {}   # fps (or images/s) of each bench cell in phase 8

    def time_pair(name, kern, plain, lib, iters=ITERS, warmup=WARMUP,
                  plain_iters=ITERS, plain_warmup=WARMUP):
        """Kernel and plain version in turns, so that neither side owns the
        card's warm state; then the library call."""
        k1 = cuda_ms(kern, iters, warmup)
        p1 = cuda_ms(plain, plain_iters, plain_warmup)
        k2 = cuda_ms(kern, iters, warmup)
        p2 = cuda_ms(plain, plain_iters, plain_warmup)
        lib_ms = None if lib is None else cuda_ms(lib, iters, warmup)
        burst = back_to_back_ms(kern, iters)
        print(f"{name}: kernel {k1:.4f} / {k2:.4f} ms ({burst:.4f} back to "
              f"back), plain {p1:.4f} / {p2:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} {tag}")
        return {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                "library_ms": lib_ms, "back_to_back_ms": burst}

    @torch.inference_mode()
    def timing():
        ms = cuda_ms(lambda: detect(frames))
        phase8["default"] = BATCH * 1000.0 / ms
        print(f"detector DyYOLO @{SIZE} bs={BATCH} uint8 -> Detections: "
              f"{ms:.3f} ms/batch, {BATCH * 1000.0 / ms:.1f} fps {tag}")
        ms = cuda_ms(lambda: soem_detect(soem_frames), SOEM_ITERS,
                     SOEM_WARMUP)
        phase8["cfg3"] = SOEM_BATCH * 1000.0 / ms
        print(f"detector DySOEM_SimFPN @{SOEM_SIZE} bs={SOEM_BATCH} uint8 -> "
              f"Detections: {ms:.3f} ms/batch, "
              f"{SOEM_BATCH * 1000.0 / ms:.1f} fps (median of {SOEM_ITERS}) "
              f"{tag}")
        frame = frames[:1]
        ms = cuda_ms(lambda: base_detect(frame))
        phase8["cfg1"] = 1000.0 / ms
        print(f"detector BaselineModel @{SIZE} bs=1 uint8 -> Detections: "
              f"{ms:.3f} ms/batch, {1000.0 / ms:.1f} fps {tag}")
        art = inputs.get("exported")
        if art is not None:   # 7k passed: the artifact against the live one
            readings = {"live": [], "artifact": [], "live_host_us": [],
                        "artifact_host_us": []}
            for which in ("live", "artifact", "artifact", "live"):
                fn = ((lambda: detect(frames)) if which == "live"
                      else (lambda: art(frames)))
                readings[which].append(cuda_ms(fn))
                readings[f"{which}_host_us"].append(host_us(fn, 10))
            print(f"exported DyYOLO @{SIZE} bs={BATCH} uint8, ms/batch: "
                  f"artifact {readings['artifact']}, live detector "
                  f"{readings['live']} (in turns); host time to issue one "
                  f"batch, us: artifact {readings['artifact_host_us']}, live "
                  f"{readings['live_host_us']} {tag}")
            print(json.dumps({"export": readings}))
        x, k1 = inputs["l1"]
        a1, k2 = inputs["l2"]
        boxes_s = inputs["nms"]
        host = {}
        for name, op, direct in (
                ("stem_l1", lambda: stem_l1(x, k1),
                 lambda: _stem_l1_cuda(x, k1)),
                ("stem_l2", lambda: stem_l2(a1, k2),
                 lambda: _stem_l2_cuda(a1, k2)),
                ("nms", lambda: nms_alive(boxes_s, 0.5),
                 lambda: _nms_alive_cuda(boxes_s, 0.5))):
            host[name] = {"op": [], "direct": []}
            for which in ("op", "direct", "direct", "op"):
                host[name][which].append(host_us(
                    op if which == "op" else direct))
        print("host time to issue one call, us, through the registered "
              "operator (torch.ops.uavdet.*) and the CUDA wrapper called "
              "directly, in turns: " + "; ".join(
                  f"{k} {v['op']} / {v['direct']}" for k, v in host.items())
              + f" {tag}")
        print(json.dumps({"dispatcher_host_us": host}))
        rgb, ir = inputs["dual"]
        ms = cuda_ms(lambda: dual_detect(rgb, ir))
        phase8["cfg2"] = 2 * DUAL_BATCH * 1000.0 / ms
        print(f"detector DyYOLO dual @{SIZE} {DUAL_BATCH} RGB {RGB_HW} + "
              f"{DUAL_BATCH} IR {IR_HW} uint8 -> Detections: {ms:.3f} "
              f"ms/batch, {2 * DUAL_BATCH * 1000.0 / ms:.1f} fps {tag}")
        smoke.stats["stem_l1"].update(time_pair(
            "stem_l1", lambda: stem_l1(x, k1), lambda: stem_l1_plain(x, k1),
            library_stem(x, k1, 1)))
        smoke.stats["stem_l2"].update(time_pair(
            "stem_l2", lambda: stem_l2(a1, k2), lambda: stem_l2_plain(a1, k2),
            library_stem(a1, k2, 2)))
        smoke.stats["stem_fused"].update(time_pair(
            "stem_fused", lambda: stem_fused(x, k1, k2),
            lambda: stem_fused_plain(x, k1, k2),
            library_stem_fused(x, k1, k2)))
        ab = smoke.stats["stem_l1"]["ms"] + smoke.stats["stem_l2"]["ms"]
        smoke.stats["stem_fused"]["stem_l1_plus_stem_l2_ms"] = ab
        print(f"  beside kernel A + kernel B: {ab:.4f} ms")
        smoke.stats["stem_l2_stage"].update(time_pair(
            "stem_l2_stage full", lambda: stem_l2_stage(a1, k2, "full"),
            lambda: stem_l2_plain(a1, k2), library_stem(a1, k2, 2)))
        xb, packed = inputs["block"]
        augs = [p.aug for p in packed]
        smoke.stats["post_stem_block"].update(time_pair(
            "post_stem_block (weights packed once)",
            lambda: post_stem_block(xb, *packed),
            lambda: post_stem_block_plain(xb, *augs),
            library_block(xb, *augs)))
        row = kernel_row_ms(lambda: post_stem_block(xb, *packed),
                            "post_stem_block_kernel", ITERS)
        smoke.stats["post_stem_block"]["profiler_row_ms"] = row
        print(f"  the kernel alone (profiler row): {row} ms {tag}")
        res, down = model.layers[2], model.layers[3]
        xn = xb.permute(0, 3, 1, 2)
        eager = cuda_ms(lambda: down(res(xn)))
        smoke.stats["post_stem_block"]["eager_tail_ms"] = eager
        print(f"  the same two layers of the eager tail (convs, BatchNorm, "
              f"leaky, add as separate passes): {eager:.4f} ms")
        smoke.stats["nms"].update(time_pair(
            "nms", lambda: nms_alive(boxes_s, 0.5),
            lambda: nms_alive_plain(boxes_s, 0.5), None))
        # past 1024 boxes: the mask in device memory, two launches
        big = inputs["nms_large"]
        large = time_pair(f"nms {tuple(big.shape[:2])} (mask in device "
                          "memory)", lambda: nms_alive(big, 0.5),
                          lambda: nms_alive_plain(big, 0.5), None)
        large["profiler_row_ms"] = kernel_row_ms(
            lambda: nms_alive(big, 0.5), "nms_", ITERS)
        b, n = big.shape[:2]
        large.update(bound(nbytes(big) + b * n,
                           b * (5 * n + 14 * n * (n - 1) // 2), F32_FLOPS),
                     shape=[b, n])
        print(f"  the two kernels alone (profiler rows): "
              f"{large['profiler_row_ms']} ms {tag}")
        smoke.stats["nms"]["large"] = large
        one = boxes_s[:1].contiguous()   # BaselineModel's launch
        extra = {
            "ms_batch_1": cuda_ms(lambda: nms_alive(one, 0.5)),
            "back_to_back_ms_batch_1": back_to_back_ms(
                lambda: nms_alive(one, 0.5), 200),
            "back_to_back_ms": back_to_back_ms(
                lambda: nms_alive(boxes_s, 0.5), 200),
            "empty_launch_ms": cuda_ms(lambda: nms_empty_launch(BATCH)),
            "empty_launch_ms_batch_1": cuda_ms(
                lambda: nms_empty_launch(1)),
            "no_launch_ms": cuda_ms(lambda: None),
        }
        for key, boxes in (("phase_ms", boxes_s), ("phase_ms_batch_1", one)):
            pairs = [nms_phase_ms(boxes, 0.5) for _ in range(5)]
            extra[key] = [sorted(v)[2] for v in zip(*pairs)]
        smoke.stats["nms"].update(extra)
        print(f"  nms at (1, {NMS_N}): {extra['ms_batch_1']:.4f} ms "
              f"({extra['back_to_back_ms_batch_1']:.4f} back to back); at "
              f"({BATCH}, {NMS_N}) {extra['back_to_back_ms']:.4f} back to "
              f"back of 200; an empty launch of the same grid "
              f"{extra['empty_launch_ms']:.4f} / "
              f"{extra['empty_launch_ms_batch_1']:.4f} ms, two events with "
              f"nothing between them {extra['no_launch_ms']:.4f} ms; inside "
              f"the kernel, by the card's global timer: pair mask, walk "
              f"{extra['phase_ms']} ms at {BATCH} images, "
              f"{extra['phase_ms_batch_1']} ms at 1 {tag}")
        total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
        per_site = []
        for i, (x, k, mul, add, emit) in enumerate(sites):
            t = time_pair(
                f"dyconv soem_{i} {tuple(x.shape)} -> {k.shape[-1]} "
                f"emit_gap={emit}",
                lambda: dyconv(x, k, mul, add, emit_gap=emit),
                lambda: dyconv_plain(x, k, mul, add, emit_gap=emit),
                library_dyconv(x, k, mul, add), SOEM_ITERS, SOEM_WARMUP,
                PLAIN_ITERS, PLAIN_WARMUP)
            if emit:
                t["ms_without_emit_gap"] = cuda_ms(
                    lambda: dyconv(x, k, mul, add), SOEM_ITERS, SOEM_WARMUP)
                print(f"  without emit_gap {t['ms_without_emit_gap']:.4f} ms")
            # the same launch on all-zero operands: the same instructions and
            # bytes at a fraction of the switching power; what it gains, if
            # anything, is what the card's power limit costs on real data
            zx, zk = torch.zeros_like(x), torch.zeros_like(k)
            t["ms_zero_operands"] = cuda_ms(
                lambda: dyconv(zx, zk, mul, add, emit_gap=emit), SOEM_ITERS,
                SOEM_WARMUP)
            print(f"  on all-zero operands {t['ms_zero_operands']:.4f} ms")
            del zx, zk
            t.update(inputs[f"dyconv_{i}"], site=f"soem_{i}")
            per_site.append(t)
            for key in total:
                total[key] += t[key]
        # one request's three sites together
        smoke.stats["dyconv"].update(total, sites=per_site)

    smoke.phase("8 timing", timing)

    def timing_train():
        """A cfg6 microbatch: the median over updates of 2 microbatches
        each, halved; with PyTorch's own BatchNorm update in turns with the
        port's (biased running variance); Trainer.validate per batch."""
        model_t, state, step, batches = inputs["train"]
        b = batches[0]

        def update_pair():
            step(state, b)
            step(state, b)

        def pair_ms():
            return cuda_ms(update_pair, TRAIN_ITERS // 2,
                           TRAIN_WARMUP // 2) / 2

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        port_bn, own_bn = BatchNorm2d.forward, torch.nn.BatchNorm2d.forward
        ms = {"port": [], "torch": []}
        for which in ("port", "torch", "torch", "port"):
            BatchNorm2d.forward = port_bn if which == "port" else own_bn
            try:
                ms[which].append(pair_ms())
            finally:
                BatchNorm2d.forward = port_bn
        peak = torch.cuda.max_memory_allocated() / 2**30
        micro = min(ms["port"])
        trainer, val_b = inputs["trainer"]
        eval_step = make_eval_step(trainer.model, DYYOLO, SIZE,
                                   compute_dtype=bf16)
        val_ms = cuda_ms(lambda: trainer.validate(trainer.state, eval_step),
                         3, 1) / TRAIN_VAL_BATCHES
        row = {"ms_per_microbatch": micro, "runs_ms": ms["port"],
               "images_per_s": TRAIN_BATCH * 1000.0 / micro,
               "torch_batchnorm_ms": ms["torch"],
               "validate_ms_per_batch": val_ms, "peak_gib": peak,
               "batch": TRAIN_BATCH, "size": SIZE,
               "grad_batches": TRAIN_GRAD_BATCHES}
        print(f"train DyYOLO @{SIZE} bs={TRAIN_BATCH} grad_batches "
              f"{TRAIN_GRAD_BATCHES} bf16: {micro:.3f} ms/microbatch "
              f"({ms['port']}), {row['images_per_s']:.1f} images/s; with "
              f"PyTorch's own BatchNorm update {ms['torch']} ms; "
              f"Trainer.validate {val_ms:.3f} ms/batch (eval_ap); peak "
              f"device memory {peak:.2f} GiB {tag}")
        print(json.dumps({"train": row}))
        phase8["cfg6"] = row["images_per_s"]
        pp.timing()

    smoke.phase("8 timing: training", timing_train)

    def timing_rtm():
        rows = group_norm1_times(dev, gen, tag)
        smoke.stats["group_norm1"].update(rows[0], sites=rows)
        out = rtm.timing()
        smoke.stats["nms"]["rtm"] = out["nms"]
        phase8.update(cfg4=out["detector"]["fps"],
                      cfg5=out["train"]["images_per_s"])

    smoke.phase("8 timing: RTMUAVDet", timing_rtm)

    def timing_bn_act():
        rows = bn_act_times(dev, gen, tag)
        smoke.stats["bn_act"].update(rows[0], sites=rows)

    smoke.phase("8 timing: bn_act", timing_bn_act)

    def bench_beside_phase8():
        """7r's lines beside phase 8's reading of the same cell: three
        windows of calls issued back to back (median) against one call
        between two CUDA events (median)."""
        for case, line in bench_lines.items():
            p8 = phase8.get(case)
            print(f"bench {case}: {line['value']} per s, vs_baseline "
                  f"{line['vs_baseline']} | phase 8: "
                  + (f"{p8:.1f} per s" if p8 else "no reading of this cell")
                  + f" {tag}")
        print(json.dumps({"bench": {case: {**line, "phase8": phase8.get(case)}
                                    for case, line in bench_lines.items()}}))

    smoke.phase("8 timing: 7r's bench lines beside phase 8",
                bench_beside_phase8)

    def profile(name, fn, batches):
        """Device time by kernel over a few batches, and the device's idle
        share."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(batches):
                fn()
            end.record()
            end.synchronize()
        wall_us = start.elapsed_time(end) * 1e3
        # kernels and copies on the card only (operator rows repeat them)
        rows = [(e.self_device_time_total, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows = sorted((r for r in rows if r[0] > 0), reverse=True)
        busy_us = sum(r[0] for r in rows)
        if not rows:
            print(f"profile {name}: no device time recorded (not measured)")
            return
        print(f"profile {name}: {batches} batches, device busy "
              f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms, idle share "
              f"{1 - busy_us / wall_us:.3f} {tag}")
        # the 20 largest, and the port's own kernels wherever they stand
        for i, (t, n, key) in enumerate(rows):
            if i < 20 or "(anonymous namespace)::" in key:
                print(f"  {t / batches / 1e3:9.4f} ms/batch {n // batches:5d} "
                      f"calls/batch {key[:150]}")

    print("== 9 profile (informational)", flush=True)
    for args in (("DyYOLO", lambda: detect(frames), 3),
                 ("DySOEM_SimFPN", lambda: soem_detect(soem_frames), 2),
                 ("BaselineModel bs=1", lambda: base_detect(frames[:1]), 3),
                 ("DyYOLO dual", lambda: dual_detect(*inputs["dual"]), 3),
                 ("DyYOLO exported (7k's artifact)",
                  lambda: inputs["exported"](frames), 3),
                 ("DyYOLO train step cfg6, 2 microbatches = 1 update",
                  lambda: [inputs["train"][2](inputs["train"][1], b)
                           for b in inputs["train"][3][:2]], 2),
                 ("DyYOLO pp step, cfg6's batch in 2 stages on one card, 2 "
                  "microbatches = 1 update", pp.profile_update, 2),
                 *rtm.profiles()):
        try:
            profile(*args)
        except Exception:   # a profiler that cannot trace the card fails nothing
            traceback.print_exc()

    shutil.rmtree(workdir, ignore_errors=True)
    if smoke.failures:
        print(f"FAILED: {smoke.failures}", flush=True)
        return 1
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             **smoke.stats[name]} for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
