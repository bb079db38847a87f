#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase below
    python3 chip_smoke.py --time   # phases 1, 2, 17 and 18 only

(``--rank R PORT DIR DEVICE`` runs one of phases 53-54's ranks; phase 53
starts two.)

``--time`` runs the same measurements against whichever port package lies
beside the script, so that a copy of this script in an unpacked older tree
times that tree's kernels the same way, in the same call.

Phases, each of which raises on failure (so the exit code is non-zero):

1. the card's name and power limit;
2. build the CUDA kernels from the sources in the checkout (one ``nvcc``
   per source, all started together);
3. K1 ``gather_twohot`` against its plain version at the four pyramid
   shapes of the 120x160 B=8 forward (C=10, coordinates out of range and on
   the border): bit-exact is expected, the limit is max-abs <= 1e-6;
4. K6 ``fused_jtj_jtr`` against its plain version, in float32 and in
   float64, at the same four shapes (C=8): rtol 1e-5, atol 1e-5 of the
   largest entry, and a symmetric JtJ; a ``torch.profiler`` trace of one
   call at each shape must hold exactly one device kernel;
5. K2 ``gather_twohot_grads`` and K3 ``splat_twohot`` against their plain
   versions at the four pyramid shapes of the 120x160 B=64 training step
   (C=10): K2's ``out`` bit-exact, its gx/gy within 1e-6 of the largest
   entry; K3 (float atomics) within 1e-5 of the largest entry;
6. K4 ``gather_tiles`` (B=8, 480x640) and K5 ``gather_tiles_grads`` (B=4,
   480x640 and 240x320) against their plain versions and against K1 / K2
   on the same inputs, at C=10 and C=17, K4 also at C=1, 3 and 6 and K5 at
   C=6 (the classical and ICP warps), on smooth small-motion coordinates
   (every tile stages its box in shared memory) and on the same with
   samples teleported across the plane (one launch takes both paths):
   ``out`` bit-exact, gx/gy within 1e-6 of the largest entry;
7. K1 (B=8) and K3 (B=64) against their plain versions on the smooth and
   teleported coordinates of 6, and on the smooth ones spread 4x about the
   centre (off the plane), at the four 120x160 levels, C=10 and C=17, and
   K3 at 480x640, B=4 level 0 on smooth ones: K1 bit-exact, K3 within 1e-5
   of the largest entry.  At C=10 every smooth 120x160 K3 tile stages its
   corner box in shared memory, and the level-0 teleported and off-plane
   launches take both branches (teleported samples send some tiles to
   global atomics; off the plane, the corner tiles stage all their samples
   onto one cell); K2 at B=64 on the same inputs as K3: ``out`` bit-exact
   with its plain version and with K1, gx/gy within 1e-6 of the largest
   entry; K1 and K2 also at C=1, 3 and 6, where no K3 runs;
8. serve: ``build_service("feature", "", max_batch=8)`` at 120x160 on the
   card, 12 requests from threads and one HTTP ``POST /track``; with the
   launch counts reset just before and read just after, K1 and K6 must
   have run 12 times per served batch and K2-K5 not at all.  Every R
   must be orthonormal and every t finite, and one batch through the
   kernels, through their plain versions on the card and on the CPU must
   agree within atol 1e-4;
9. serve ``feature_icp`` as in 8: per batch K1 24 times (a feature warp,
   C=10, and an ICP warp of vertices and normals, C=6, per iteration) and
   K6 12 times; the kernel forward agrees with the plain one within 1e-5
   and with the CPU one within 1e-4 on R and t;
10. the classical presets ``RGB``, ``ICP`` and ``RGB+ICP`` at 120x160 B=8
   on the served requests: per forward K1 24, 12 and 24 times (C=1; C=6;
   C=3 and C=6) and K6 0, 0 and 12 times (C=1); kernels against plain
   within 1e-5 and against the CPU within 1e-4;
11. train: the feature preset's train state on the card at 120x160, B=64,
   a seeded synthetic batch, 3 steps; with the counts reset before and read
   after each step, K2, K3 and K6 must have run 12 times and K1, K4, K5 not
   at all, and the loss and gradient norm must be finite.  One loss and
   backward through the kernels and through their plain versions on the
   card must agree: the loss within 1e-5 relative, each gradient leaf within
   5e-3 of its largest entry (the envelope of 12 chained Gauss-Newton
   solves).  The step is timed with the kernels and with the plain versions
   and profiled;
12. train ``feature_icp`` as in 11: per step K2 24 times, K3 and K6 12
   times (the ICP operand, from the input depth, needs no cotangent);
13. serve at 480x640 as in 8: per batch K4 3 times (level 0), K1 9 times
   (levels 1-3), K6 12 times, K2, K3 and K5 not at all; the kernel and
   plain forwards agree at B=8, the kernel and CPU forwards at B=2;
14. ``feature_icp`` at 480x640 B=8 on the served requests: per forward K4
   6 times (level 0, C=10 and C=6), K1 18 and K6 12 times; kernels against
   plain within 1e-5;
15. train at 480x640, B=4 as in 11: per step K5 6 times (levels 0-1), K2 6
   times (levels 2-3), K3 and K6 12 times, K1 and K4 not at all; kernels
   against plain within the same limits; timed and profiled;
16. the share of K4's, K5's and K3's tiles that staged on the
   synthetic scenes' own warps: the 480x640 ``feature`` and ``feature_icp``
   forwards, and one loss and
   backward at 480x640, B=4 and at 120x160, B=64;
17. time the forwards and each kernel at each level (CUDA events around
   back-to-back calls after warm-up, and the kernels' own device time:
   events around calls queued behind a sleep kernel, so no host launch gap
   falls between them; operands warm in L2 where they fit, as in the
   Gauss-Newton loop that reuses them), beside the plain version, one PyTorch library
   call computing the same function where there is one, and the least time
   the card could take (bytes moved over the memory rate, or flops over the
   f32 rate); ``grid_sample``'s events and device time; K1 (B=8), K2 and
   K3 (B=64) on random, smooth, teleported and off-plane coordinates, K3
   at 480x640, B=4 level 0 (smooth); K4 at 480x640 B=8 at C=1, 3, 6, 10
   and 17, and K5 at the 480x640 training shapes, beside K1 and K2 on the
   same inputs, K4 at C=6 and 10 also on tracking-like coordinates whose
   tiles mostly miss its window; K6 at the 120x160 B=8 levels, and at the
   B=64 training levels and the 480x640 B=8 levels, each checked as in 4 (at 480x640
   level 0 against the float64 plain version alone: there the float32
   one's own sums of 307,200 pixels stray past the limit); K1 at C=1, 3
   and 6 at the 120x160 B=8 levels, K2 at C=6 (B=64, level 0) and K6 at
   C=1 (120x160 B=8 level 0, checked as in 4), on smooth coordinates;
   with ``--time``, the 120x160 B=64 train step of ``feature`` and
   ``feature_icp``;
18. profile one B=8 forward at 120x160 and at 480x640 (``torch.profiler``),
   of ``feature`` and, timed too, of ``feature_icp``, and at 120x160 of
   ``RGB``, ``ICP``, ``RGB+ICP``, ``DeepIC`` and the tracker options
   ``feature_icp`` with ``scaler=MultiScale2w``, ``feature`` with
   ``dense_net``, with ``ConvRGBD`` and with ``uncer_prop``: device busy time, the span
   from its first to its last kernel, the idle share of that span, and
   launches and device time by kernel name; with ``--time``, the train
   steps of 17 too (the full run times them in 11, 12 and 21), and K1 at
   ``DeepIC``'s folded level-0 shape (80 planes of 120x160, C=1: the 10
   damping samples of B=8) beside ``grid_sample`` and the byte bound;
19. ``DeepIC``'s new kernel shapes (C=1), against the plain versions: K1
   (bit-exact) at the 10 folded damping samples of B=8 (80 planes) at each
   120x160 level and at the prior weights' upsamples (B=8, 15x20 -> 30x40,
   30x40 -> 60x80, 60x80 -> 120x160: 4 samples a cell); K2 (``out``
   bit-exact, gx/gy within 1e-6 of the largest entry) and K3 (within 1e-5)
   at the training shapes: 640 folded planes at each level and the
   upsamples at B=64;
20. serve ``DeepIC`` as in 8: per batch K1 51 times (12 a level: the first
   residual, the folded samples of 3 iterations and 2 new residuals, each
   warping x1 and the occlusion depth; and 3 upsamples), nothing else; the
   kernel forward agrees with the plain one within 1e-5 and with the CPU
   one within 1e-4;
21. train ``DeepIC`` as in 11: per step K1 once (level 3's first occlusion
   depth, where neither the operand nor the identity pose needs a
   gradient), K2 50 and K3 27 times (6 ``x1`` warps a level and the 3
   upsamples), no K4-K6;
22. the U_FC track's new kernel shapes (its warp operand of the target
   depth, features, sigma and their gradients: C=28, and C=49 with the
   ``feature`` sigma), on its forward warp's coordinates, against the plain
   versions: K4 at C=28 (B=8) on the 120x160, 480x640 and 240x320 planes,
   also with teleported samples (staged and global tiles in one launch),
   bit-exact with its plain version and K1; K1 (B=8) at C=28 and 49 at the
   120x160 levels, bit-exact; K2 (B=64) there at C=28 and 49, ``out``
   bit-exact, gx/gy within 1e-6, and K3 at C=28 within 1e-5 of the largest
   entry;
23. serve U_FC (``feature`` with ``direction=forward``) as in 8: per batch K4
   3 times (level 0) and K1 9 times, no K6 (its systems are weighted); the
   kernel forward agrees with the plain one within 1e-5 and with the CPU
   one within 1e-4;
24. the U_FC forward at 480x640 B=8 on the served requests: K4 9 times
   (levels 0-2), K1 3 times; kernels against plain within 1e-5; and the
   U_FC forward with the ``feature`` sigma (C=49) at 120x160: K1 12 times,
   kernels against plain within 1e-5 (no CPU forward: that float32 forward
   amplifies rounding at an untrained init);
25. train U_FC as in 11: per step K2 and K3 12 times, nothing else;
26. train U_FC with the learned ``MultiScale2w`` estimator
   (``train_init_pose=false``) as in 11: per step K2 24 times (12 warps and
   12 upsamples of the prior weights), K3 21 times (the zero residual's
   weights reach no loss).

27. build the port's native host tier (``data/native_io.py``, the host's
   C++ compiler: its version, the build's seconds, and whether ``png.h``,
   ``zlib.h`` and ``jpeglib.h`` exist, printed only); write a TUM-format
   sequence of 24 640x480 frames (8-bit RGB, 16-bit depth, ``rgb.txt``,
   ``depth.txt``, ``groundtruth.txt``; a textured plane seen from a camera
   that moves 1.5 cm and 0.5 degrees a frame) with the script's own PNG
   writer (rows filtered by Sub), and the first frame again filtered by
   Paeth, by Average and by all five filters in turn; every frame read
   through the native tier and through the numpy twins (``plain=True``)
   must give the same bits (``read_png``, and ``read_rgb`` or
   ``read_depth_png`` at 0.25 and 1.0); time both (medians of 5 and 3);
28. ``apps.evaluate.main`` on it (keyframes 1 and 2, B=8) at
   ``--image_resize`` 0.25 and 1.0: per batch K1 12 and K6 12 times at
   120x160, K4 3, K1 9 and K6 12 times at 640x480, nothing else; the
   per-frame poses of the CLI's dumps against ``evaluate_two_view``
   through the plain versions on the card, and at 120x160 against the
   first loader on the CPU, within 1e-4; finite EPE3D and RPE; the summary
   CSV's keyframe 1 mean row; frames/s of the CLI's loop and the share of
   it spent waiting on the loader;
29. ``apps.train.main`` on a data root whose 36 training sequences link to
   it (keyframes 1 and 2, ``--no_val``): 2 steps at 120x160 B=64 (K2, K3,
   K6 12 times a step) and 1 at 640x480 B=4 (K5 6, K2 6, K3 12, K6 12),
   finite losses, the checkpoint; a resume from it for one more step (the
   step goes on from 2, the weights and optimizer state come back); the
   evaluate CLI on the resumed checkpoint at 120x160; ms per step, the
   share of wait and step spent waiting on the loader, and the loader's ms
   per batch of 64 pairs;
30. the JSON record gets ``cli_eval``, ``cli_train`` and ``png_decode_ms``;
31. ``apps.evaluate.main --tracker`` on the sequence of 27 for the six
   non-learned baselines at ``--image_resize`` 0.25 and for ``ICP`` and
   ``RGBD`` at 1.0 (B=8, keyframes 1 and 2): per batch K1 40 (``ICP``,
   ``Point2Point``), 94 (``Iter_Point2Plane``), 80 and K6 40 (``RGBD``), K1
   and K6 40 (``ColorICP``) and 94 (``Iter_ColorICP``) at 120x160; at
   640x480 the ICP operand takes K4 at level 0 (``ICP`` K4 10, K1 30;
   ``RGBD`` K4 10, K1 70, K6 40); the per-frame poses against the same
   baseline through the plain kernels on the card within 1e-4, NaN in the
   same frames, the NaN frames counted; the first 640x480 ``ICP`` batch in
   float64 on the card against the CPU within 1e-8; frames/s;
32. ``apps.kf_vo.main`` with ``feature`` in keyframe mode at 120x160: K1 and
   K6 12 times a frame; the trajectory against ``run_vo`` through the plain
   kernels within 1e-4; ``--gt_tracker`` against ``groundtruth.txt`` within
   1e-5; ``apps.traj_eval`` of the trajectory against ``groundtruth.txt``;
   frames/s of the VO loop (decode included) and one B=1 forward timed and
   profiled;
33. ``apps.convergence_basin.main`` 2D 31x31 for ``feature`` at 120x160:
   one K1 a chunk of 64 poses and level (64); the costs against the plain
   kernels' within 1e-5 of the largest; the wall time; whether matplotlib
   imports, and the plots (``--save_img``) only where it does;
34. ``apps.import_checkpoint.main`` on a checkpoint in the original
   implementation's format written from a seeded ``feature`` tracker, then
   served through ``apps/serve.py``: the served pose equals the source
   tracker's bit for bit; the JSON record gets ``cli_baselines``,
   ``kf_vo``, ``convergence_basin`` and ``import_checkpoint``.

35. the kernels at the masked operands' odd channel counts (the frame-1
   object mask rides in the operand as its last channel, 0 or 1): K1 at
   C=11 (U_IC) and 7 (ICP) at the 120x160 B=8 levels, K2 and K3 at C=11 at
   the B=64 levels, K4 at C=11, 7 and 29 (U_FC) at 480x640 B=8 (C=29 also
   on 240x320 and 120x160), K5 at C=11 at 480x640 and 240x320 B=4, on
   smooth and teleported coordinates, against their plain versions (K1, K2,
   K4, K5 ``out`` bit-exact, gx/gy within 1e-6, K3 within 1e-5), then each
   timed at level 0 beside the unmasked operand's even count (10, 6, 28)
   and, K1-K4, at C=12 (the C=11 operand padded);
36. on a MovingObjects3D-format dataset (``write_mo3d_dataset``: a textured
   square turning and moving in front of a textured wall, seen from a moving
   camera, 640x480, every sequence of the dataset's ranges): every preset's
   masked forward at 120x160 B=8 (the first boat pairs) and ``feature``'s at
   640x480 B=8, launches pinned (as unmasked; ``RGB`` K1 36, ``DeepIC`` K1
   75, since the IC residual warps the frame-1 mask in a gather of its
   own), against the plain kernels within 1e-4, timed;
37. ``apps.evaluate.main --dataset MovingObjects3D --obj_only --save_img
   1`` with ``feature`` at 120x160 B=8 (400 pairs): launches per batch as
   served, the boat's poses against the plain kernels, frames/s, the
   loader-wait share, the 13 diagnostic PNG files; ``--tracker ICP
   --obj_only`` on the boat (K1 40 a batch);
38. ``apps.train.main --dataset MovingObjects3D --no_val`` with
   ``feature``, B=64, keyframes 1, 2 and 4, two steps at 120x160: K2, K3
   and K6 12 times a step, ms a step, the loader wait;
39. ``apps.warping_objects.main`` on the boat's first 4 pairs with
   ``--gt_pose`` (K1 once a pair, C=3) and tracked by ``feature`` with the
   masks (K1 13, K6 12 a pair): the masked residuals, the mosaics decode;
   the JSON record gets ``objects``.

40. the tracker options' new kernel shapes, against the plain versions: K1
   (bit-exact) at the learned ICP scale's 640x480 upsample (B=8, the
   240x320 prior weights to 480x640, C=1); K6's ``FusedJtJ`` at the
   120x160 B=64 levels with a nonzero JtJ cotangent (the uncertainty
   losses' path): the forward against the float64 plain version within
   rtol 1e-5 and 1e-5 of the largest entry, the backward against the plain
   one bit for bit and against float64 within the same bound;
41. ``feature_icp`` with the learned ``scaler=MultiScale2w``, served as in
   8 (K1 27 a batch: the 24 warps and the prior weights' upsamples at
   levels 2-0, the scale reading the first iteration's residuals; K6 12),
   against plain within 1e-5 and the CPU within 1e-4; ``scaler=
   expMultiScale`` the same, forward only, on ``synthetic_batch``'s smooth
   scenes (it weighs the ICP term up to 400x more: on the requests'
   uniform-noise depth its flipped ICP masks move the pose ~1e-2); the
   ``MultiScale2w`` forward
   at 640x480 B=8 (K4 6 for level 0's feature and ICP operands, K1 21, K6
   12) against plain within 1e-5;
42. ``feature`` with the ``dense_net`` initial pose and with the one-view
   ``ConvRGBD`` encoder, and ``DeepIC`` with ``no_weight_sharing``, each
   served as in 8 (K1 12 and K6 12; ``DeepIC`` K1 51); ``feature`` with
   ``multi_hypo=average`` and with ``res_input=1``, forward only; each
   against plain within 1e-5 and the CPU within 1e-4;
43. ``feature`` with ``uncer_prop`` on the smooth scenes: the forward's
   pose and level 0's 6x6 information matrix (K1 12, K6 12), against plain
   and the CPU (poses within 1e-5 and 1e-4, the matrix within 1e-4 of its
   largest entry); on the uniform-noise requests, and on the uniform noise
   of seed 3, the pose and matrix gaps of kernels, plain on the card and
   the CPU, each pair, are logged;
44. train ``feature`` with ``uncer_prop`` and the UEPE3D loss, and
   ``feature_icp`` with ``scaler=MultiScale2w``, as in 11: per step K2,
   K3, K6 12 times; and K2 27, K3 15, K6 12 times (the scale's upsamples;
   the ICP operand needs no cotangent);
45. ``apps.train.main --loss URPE --no_val`` (``uncer_prop`` on) on a
   written 8-frame sequence linked as the 36 training sequences, 2 steps at
   120x160 B=64: K2, K3, K6 12 times a step, finite losses; the JSON record
   gets ``variants``.

46. on a freshly written 24-frame sequence: ``parallel.ba.refine_pose_graph``
   on its ground truth perturbed by 0.02, ``ba_refine``'s 66 window edges
   (window 3) with JtWJ-like information matrices, 10 iterations: float64
   on the card against the CPU within 1e-9, float32 against float64 within
   ``BA_F32_ATOL``, two card calls bit for bit, the time of a call;
47. ``parallel.dense_ba.refine_dense_window`` on the seeded ``feature``
   tracker's encoding of the first 6 frames at 640x480, at level 1 (240x320,
   C=10: K1) and level 0 (480x640: K4), 12 edges, 3 iterations: one gather
   and one K6 a iteration, pinned; the poses through the kernels, through
   the plain versions on the card and on the CPU within ``DENSE_ATOL``; two
   calls bit for bit; one iteration's events, device busy time and idle
   share (``torch.profiler``);
48. ``apps.ba_refine.main --dense`` with a checkpoint the phase writes, at
   120x160 and 640x480: 9 batches of tracking (K1 12 / K6 12 a batch, or
   K4 3 / K1 9 / K6 12) and 5 dense iterations (K1 and K6 once each);
   the trajectory file against the CPU run of the CLI within
   ``BA_CLI_ATOL``, poses relative to frame 0's (the pose graph's gauge is
   weakly pinned: see ``BA_CLI_ATOL``; at 640x480 on the first 4 frames);
   ATE before and after and the wall time;
49. ``apps.run_example.main`` on the sequence's ``rgb/`` and ``depth/``: K1
   14 (two colour resizes, C=3) and K6 12 a pair; the printed poses finite
   and within 1e-4 of the CPU run's;
50. the frames laid out as a VaryLighting scene and ``apps.evaluate.main
   --dataset VaryLighting``: launches as served a batch, "no ground truth;
   23 poses estimated", a summary row of empty (NaN) metrics and 23
   frames; the JSON record gets ``ba``.

51. ``feature`` at 120x160 B=64 with ``accum_steps=2``: K2, K3 and K6 24
   times a step (12 a microbatch); the loss within 1e-5 relative and the
   averaged gradients within ``GRAD_ENVELOPE`` of the same step through the
   plain versions on the card, the parameters within 2 lr (one Adam update
   each); in float64 through the plain versions at B=8, the card against
   the CPU (loss 1e-10, gradients and parameters 1e-8); ms a step beside
   the ``accum_steps=1`` step;
52. the guarded step (``guard_nonfinite=True``) on a batch with one NaN
   depth map: ``skipped``, and the weights, BatchNorm buffers and Adam
   state bit for bit as before it, ``step`` advanced;
53. data parallel on the card: two gloo ranks on card 0 (this script with
   ``--rank``), B=32 each, against this process at B=64: two ``feature``
   steps (K2 12 / K3 12 / K6 12 a step on each rank; the first loss within
   1e-5, its gradients within ``GRAD_ENVELOPE``, the second loss and the
   BatchNorm statistics within ``DP_SECOND_LOSS``, the parameters within 4
   lr; both ranks bit for bit alike) and one 640x480 B=8 eval forward (4 a
   rank: K4 3 / K1 9 / K6 12, poses within 1e-4); the train CLI with
   ``--distributed`` at world size 1 over NCCL against the plain CLI: the
   first loss bit for bit, the second within 1e-5;
54. sharded BA on the same two ranks: phase 46's 800-pose graph in
   float64 against the unsharded refinement (1e-9), phase 47's dense
   window at level 1 (K1 3 / K6 3 on each rank) against one process
   (``DENSE_ATOL``);
55. a written 16-frame 640x480 ScanNet scan (``write_scannet_scan``: the
   TUM scene, JPEG colour by ``encode_jpeg``): every frame's ``read_jpeg``,
   ``read_rgb`` at 0.25 and 1.0 and depth map through the native tier and
   the numpy twins bit for bit, and the decode times of one frame on the
   host through both; the evaluate CLI at stride 2 at 120x160 (K1 12 / K6
   12 a batch) and 640x480 (K4 3 / K1 9 / K6 12), its 120x160 poses
   against the CLI on the CPU within 1e-4, frames/s and the loader-wait
   share, and one train-CLI step (B=4, K2 12 / K3 12 / K6 12);
56. the train CLI with ``--debug_nan`` on a batch with a NaN depth map
   must raise ``NonFiniteError`` naming a module; the JSON record gets
   ``final``.

Phase 16 also records K4's staged share on the U_FC forwards (480x640 and
120x160, on the synthetic scene and on the served requests), 17 times K4
(C=28, beside K1 and ``grid_sample``), K1 (C=28 and 49), K2 and K3 (C=28)
at U_FC's shapes, and 18 profiles the U_FC forwards (120x160, 480x640 and
C=49) and, with ``--time``, times its steps.  ``--time`` needs a port
package with the U_FC track and the tracker options of 40-45.

The last lines are a JSON ``kernels`` record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device or without the port package beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib
from http.server import ThreadingHTTPServer

import numpy as np

B, H, W = 8, 120, 160
B_TRAIN = 64  # the paper's training batch
LEVELS = ((120, 160), (60, 80), (30, 40), (15, 20))
H_VGA, W_VGA = 480, 640
VGA_LEVELS = ((480, 640), (240, 320), (120, 160), (60, 80))
B_VGA_TRAIN = 4  # the JAX package's 640x480 step without gradient accumulation
C_WARP, C_RES, C_FULL = 10, 8, 17  # C_FULL: the warp operand before sigma-slim
N_REQUESTS = 12
TRAIN_STEPS = 3
# batch seeds whose two forwards (kernels, plain) mask the same pixels: on
# some seeds K6's last-bit differences flip one pixel of a discrete mask
# (occlusion, sigma min/max), which moves the gradient by more than rounding
TRAIN_SEED = 5
VGA_TRAIN_SEED = 3
GRAD_ENVELOPE = 5e-3
SLEEP_CYCLES = 100_000_000  # ~50 ms of device sleep while device_ms queues its calls
N_CPU_VGA = 2  # the CPU forward at 480x640 takes this many requests of the batch
# the coordinates K1 and K3 are checked and timed on: uniform over and past
# the plane, smooth sub-pixel flow, the same with a few samples moved half
# the plane away (K3 launches then mix staged and global tiles), and smooth
# flow zoomed out 4x about the centre (most samples clamp to the border:
# K3 tiles in the corners stage every sample onto one cell's list)
COORDS = ("random", "smooth", "teleported", "offplane")
KEYS = ("color0", "color1", "depth0", "depth1", "calib")
# published peaks (NVIDIA data sheets): device-memory bytes/s, f32 flop/s
# outside the tensor cores; first matching substring of the card's name
PEAKS = (("H200", 4.8e12, 67e12), ("H100 PCIe", 2.0e12, 51e12),
         ("H100", 3.35e12, 67e12))

TPU_SOURCES = {
    "gather_twohot": "deep_prob_feature_track_tpu/ops/pallas/gather.py:204",
    "gather_twohot_grads": "deep_prob_feature_track_tpu/ops/pallas/gather.py:234",
    "splat_twohot": "deep_prob_feature_track_tpu/ops/pallas/gather.py:283",
    "gather_tiles": "deep_prob_feature_track_tpu/ops/pallas/gather_tiles.py:177",
    "gather_tiles_grads": "deep_prob_feature_track_tpu/ops/pallas/gather_tiles.py:177",
    "fused_jtj_jtr": "deep_prob_feature_track_tpu/ops/pallas/jtj.py:26",
}


def counts(**n):
    """Launch counts of every kernel, 0 where not given."""
    return {k: n.get(k, 0) for k in TPU_SOURCES}


# per served batch and per training step
SERVE_LAUNCHES = counts(gather_twohot=12, fused_jtj_jtr=12)
TRAIN_LAUNCHES = counts(gather_twohot_grads=12, splat_twohot=12, fused_jtj_jtr=12)
VGA_SERVE_LAUNCHES = counts(gather_tiles=3, gather_twohot=9, fused_jtj_jtr=12)
VGA_TRAIN_LAUNCHES = counts(gather_tiles_grads=6, gather_twohot_grads=6, splat_twohot=12,
                            fused_jtj_jtr=12)
# feature_icp: one more warp per iteration, the ICP operand [vertex1 | normal1]
# (C=6); ScaleNet("None") reads no residuals, so none are taken for it
ICP_SERVE_LAUNCHES = counts(gather_twohot=24, fused_jtj_jtr=12)
ICP_VGA_LAUNCHES = counts(gather_tiles=6, gather_twohot=18, fused_jtj_jtr=12)
# the ICP operand comes from the input depth and needs no cotangent: no K3
ICP_TRAIN_LAUNCHES = counts(gather_twohot_grads=24, splat_twohot=12, fused_jtj_jtr=12)
# DeepIC: the IC track with the learned M-estimator and the Direct-ResVol
# solve.  Per level the first residual, the S=10 damping samples of each of
# 3 iterations (folded into the batch: one gather of x1 and one of the
# occlusion depth for all S*B poses) and 2 new residuals warp x1 and invD1
# (C=1); the M-estimator upsamples the prior weights at levels 2, 1, 0
S_DAMP = 10
DEEPIC_SERVE_LAUNCHES = counts(gather_twohot=51)
# training: level 3's first invD1 warp needs no gradient (K1); every other
# warp takes K2, and x1's and the upsamples' operands a cotangent (K3)
DEEPIC_TRAIN_LAUNCHES = counts(gather_twohot=1, gather_twohot_grads=50, splat_twohot=27)
# per forward of the classical presets at 120x160: RGB warps the gray image
# and the occlusion depth (C=1) once each for 3 residuals a level (the last
# iteration's new residual is not taken), ICP its operand (C=6) once an
# iteration, RGB+ICP the U_IC operand (C=3) and the ICP operand once each
CLASSICAL_LAUNCHES = {"RGB": counts(gather_twohot=24), "ICP": counts(gather_twohot=12),
                      "RGB+ICP": counts(gather_twohot=24, fused_jtj_jtr=12)}
# U_FC: the paper model over the forward-compositional track, named as the
# JAX apps name it, apply_overrides(get_preset("feature"), pairs).  Its warp
# operand is [depth1, x1, sigma1, grad x1 (x, y), grad sigma1 (x, y)]: C=28
# with the slimmed 1-channel sigma, 49 with the 8-channel "feature" sigma
UFC = ("direction=forward",)
UFC_MEST = ("direction=forward", "mest_type=MultiScale2w", "train_init_pose=false")
UFC_WIDE = ("direction=forward", "uncertainty_type=feature")
C_UFC, C_UFC_WIDE = 28, 49
# per forward: at 120x160 K4 at level 0 (W*C = 4480 > 4000 refuses the full
# plane) and K1 at 1-3; at 480x640 K4 at levels 0-2 and K1 at 3; C=49 fits
# no tile budget: K1 at every level.  The systems are weighted: no K6
UFC_SERVE_LAUNCHES = counts(gather_tiles=3, gather_twohot=9)
UFC_VGA_LAUNCHES = counts(gather_tiles=9, gather_twohot=3)
UFC_WIDE_LAUNCHES = counts(gather_twohot=12)
# per step: K2 and K3 once an iteration (the grads tile gate refuses Cp > 16);
# the learned estimator's 4 applications a level at levels 2-0 upsample its
# prior weights (K2), and the 3 of the iterations reach the loss (K3)
UFC_TRAIN_LAUNCHES = counts(gather_twohot_grads=12, splat_twohot=12)
UFC_MEST_TRAIN_LAUNCHES = counts(gather_twohot_grads=24, splat_twohot=21)
# the tracker options (phases 40-45): a learned ICP scale reads the first
# iteration's residuals (no gather of its own) and upsamples the prior
# weights at levels 2-0 (3 more K1, K2 and K3); the other options launch
# as their preset
SCALE = ("scaler=MultiScale2w",)
UNCER = ("uncer_prop=1",)
SCALE_SERVE_LAUNCHES = counts(gather_twohot=27, fused_jtj_jtr=12)
SCALE_VGA_LAUNCHES = counts(gather_tiles=6, gather_twohot=21, fused_jtj_jtr=12)
SCALE_TRAIN_LAUNCHES = counts(gather_twohot_grads=27, splat_twohot=15, fused_jtj_jtr=12)
VARIANT_TIMED = (("feature_icp", SCALE), ("feature", ("init_pose_type=dense_net",)),
                 ("feature", ("encoder_name=ConvRGBD",)), ("feature", UNCER))
C_ICP = (1, 3, 6)  # the channel counts of the classical and ICP warps
PRESET_ATOL = 1e-5  # kernel against plain forward of the presets this slice added


# TUM-format sequences written by phase 27 (the card's machine has no PIL)
TUM_FRAMES = 24
TUM_K = (525.0, 525.0, 319.5, 239.5)  # TUM_CALIB: fx, fy, cx, cy at 640x480
CLI_KEYFRAMES = (1, 2)
CLI_SMALL, CLI_VGA = 0.25, 1.0  # --image_resize of the 120x160 and 640x480 CLI runs
# the evaluate CLI's --tracker baselines, launches per batch: an ICP or
# photometric iteration warps once (K1, or K4 where use_tiles holds), a
# hybrid one twice; a photometric iteration reduces with K6.  10 iterations
# on each of 4 levels, or 50/30/14 on levels 2-0; Point2Point 10 at level 2
# and 30 at level 0
BASELINE_LAUNCHES = {
    "ICP": counts(gather_twohot=40),
    "Point2Point": counts(gather_twohot=40),
    "Iter_Point2Plane": counts(gather_twohot=94),
    "RGBD": counts(gather_twohot=80, fused_jtj_jtr=40),
    "ColorICP": counts(gather_twohot=40, fused_jtj_jtr=40),
    "Iter_ColorICP": counts(gather_twohot=94, fused_jtj_jtr=94),
}
# at 640x480 the ICP operand (C=6) takes K4 at level 0
BASELINE_VGA_LAUNCHES = {
    "ICP": counts(gather_tiles=10, gather_twohot=30),
    "RGBD": counts(gather_tiles=10, gather_twohot=70, fused_jtj_jtr=40),
}
# the first 640x480 ICP batch in float64 through the plain kernels: card
# against CPU (float64 rounding through 40 chained solves)
ICP_F64_ATOL = 1e-8
BASIN_SAMPLES, BASIN_CHUNK = 31, 64  # the 2D study's 31x31 grid, 64 poses a call


def write_png(path: str, img: np.ndarray, filter_type=1) -> None:
    """Write ``img`` ([H,W] or [H,W,C], C = 1-4, uint8 or uint16) as a PNG
    whose rows use ``filter_type`` (one PNG filter 0-4, or one a row)."""
    img = np.asarray(img)
    img = img[..., None] if img.ndim == 2 else img
    h, w, c = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    x = img.astype(">u2" if depth == 16 else np.uint8).view(np.uint8).reshape(h, -1)
    x = x.astype(np.int16)
    bpp = c * depth // 8
    a, b, ul = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, bpp:], b[1:], ul[1:, bpp:] = x[:, :-bpp], x[:-1], x[:-1, :-bpp]
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    f = np.broadcast_to(np.asarray(filter_type, np.uint8), (h,))
    pred = np.choose(f[:, None], (np.zeros_like(x), a, b, (a + b) >> 1, paeth))
    rows = np.concatenate([f[:, None], ((x - pred) & 255).astype(np.uint8)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def _rotation(axis, angle):
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _quaternion(R):
    """[qx, qy, qz, qw] of a rotation by less than 180 degrees."""
    w = np.sqrt(1.0 + np.trace(R)) / 2
    return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / (4 * w), w


def write_tum_sequence(seq_dir: str, n: int = TUM_FRAMES, save=write_png) -> list:
    """Render a TUM-format RGB-D sequence of ``n`` 640x480 frames into ``seq_dir``:
    ``rgb/``, ``depth/`` (16-bit, metres x 5000), ``rgb.txt``, ``depth.txt``
    and ``groundtruth.txt``.  The scene is a textured plane tilted 30 degrees
    about the x axis, 2 m ahead of the first camera; the camera moves 1.5 cm
    and turns 0.5 degrees a frame, so the true poses are exact.  ``save(path,
    array)`` writes one image (8-bit RGB [480,640,3] or 16-bit depth [480,640]).
    Returns the camera-to-world poses (4x4)."""
    os.makedirs(os.path.join(seq_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "depth"), exist_ok=True)
    fx, fy, cx, cy = TUM_K
    tilt = np.radians(30.0)
    normal, offset = np.array([0.0, -np.sin(tilt), np.cos(tilt)]), 2.0 * np.cos(tilt)
    e1, e2 = np.array([1.0, 0.0, 0.0]), np.array([0.0, np.cos(tilt), np.sin(tilt)])
    u, v = np.meshgrid(np.arange(640, dtype=np.float64), np.arange(480, dtype=np.float64))
    rays = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    poses, lines = [], {"rgb": [], "depth": [], "groundtruth": []}
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = _rotation((0.3, 1.0, 0.2), np.radians(0.5) * i)
        T[:3, 3] = np.array([0.012, 0.006, 0.006]) * i  # 1.47 cm a frame
        d = rays @ T[:3, :3].T
        s = (offset - normal @ T[:3, 3]) / (d @ normal)  # the camera-frame depth
        X = T[:3, 3] + s[..., None] * d
        a, b = X @ e1, X @ e2
        color = np.stack([0.5 + 0.22 * np.sin(a / 0.021 + ph) * np.cos(b / 0.033 - ph)
                          + 0.2 * np.sin((a + 2 * b) / 0.011 + 2 * ph) for ph in (0, 1, 2)], -1)
        stamp = f"{1.0 + 0.1 * i:.6f}"
        save(os.path.join(seq_dir, "rgb", f"{stamp}.png"),
             np.clip(np.rint(color * 255), 0, 255).astype(np.uint8))
        save(os.path.join(seq_dir, "depth", f"{stamp}.png"),
             np.rint(s * 5000).astype(np.uint16))
        q, qw = _quaternion(T[:3, :3])
        lines["rgb"].append(f"{stamp} rgb/{stamp}.png")
        lines["depth"].append(f"{stamp} depth/{stamp}.png")
        lines["groundtruth"].append(" ".join([stamp, *(f"{x:.9f}" for x in (*T[:3, 3], *q, qw))]))
        poses.append(T)
    for name, rows in lines.items():
        with open(os.path.join(seq_dir, f"{name}.txt"), "w") as fh:
            fh.write("# timestamp data\n" + "\n".join(rows) + "\n")
    return poses


# A baseline JPEG encoder for the ScanNet phase: the card's machine has
# neither PIL nor OpenCV to write one.  Test machinery, not a package
# feature: the ITU T.81 Annex K quantization and Huffman tables, JFIF
# YCbCr, 4:2:0 chroma, an optional restart interval.
_JPEG_LUM_Q = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
               14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
               18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
               49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
_JPEG_CHR_Q = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
               24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32
_JPEG_HUFF = {  # (class, id): (counts of code lengths 1-16, symbols)
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16"
        "1718191a25262728292a3435363738393a434445464748494a535455565758595a63646566676869"
        "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6"
        "b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434"
        "e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
        "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}
_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
           41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
           23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def _huffman_codes(counts, symbols):
    """symbol -> (code, length) of a JPEG Huffman table."""
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def encode_jpeg(rgb: np.ndarray, quality: int = 90, restart: int = 0) -> bytes:
    """A baseline JFIF JPEG of uint8 RGB [H,W,3]: 4:2:0 chroma, the Annex K
    tables scaled as libjpeg scales them for ``quality``, a restart marker
    every ``restart`` MCUs (0: none)."""
    h, w, _ = rgb.shape
    x = rgb.astype(np.float64)
    ycc = np.stack([0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
                    -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128,
                    0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128], -1)
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    ycc = np.pad(ycc, ((0, H - h), (0, W - w), (0, 0)), mode="edge")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    quant = [np.clip((np.asarray(q) * scale + 50) // 100, 1, 255) for q in (_JPEG_LUM_Q, _JPEG_CHR_Q)]
    n = np.arange(8)
    dct = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16) * np.where(n == 0, np.sqrt(0.125),
                                                                           0.5)[:, None]

    def blocks(plane, q):  # [by, bx, 64] quantized coefficients, zigzag order
        b = plane.reshape(plane.shape[0] // 8, 8, plane.shape[1] // 8, 8).transpose(0, 2, 1, 3)
        c = np.einsum("ij,abjk,lk->abil", dct, b - 128.0, dct).reshape(b.shape[:2] + (64,))
        return np.rint(c / q.reshape(64))[..., _ZIGZAG].astype(np.int64)

    chroma = ycc[..., 1:].reshape(H // 2, 2, W // 2, 2, 2).mean(axis=(1, 3))
    planes = [blocks(ycc[..., 0], quant[0]), blocks(chroma[..., 0], quant[1]),
              blocks(chroma[..., 1], quant[1])]
    codes = {k: _huffman_codes(*v) for k, v in _JPEG_HUFF.items()}
    out, bits = bytearray(), []

    def flush():  # pad to a byte with ones, stuff every 0xFF
        text = "".join(bits)
        text += "1" * (-len(text) % 8)
        data = int(text, 2).to_bytes(len(text) // 8, "big") if text else b""
        out.extend(data.replace(b"\xff", b"\xff\x00"))
        bits.clear()

    def put(value, size, table):
        code, length = table
        bits.append(format(code, f"0{length}b"))
        if size:
            bits.append(format(value if value >= 0 else value + (1 << size) - 1, f"0{size}b"))

    pred = [0, 0, 0]
    n_mcu = (H // 16) * (W // 16)
    for m in range(n_mcu):
        if restart and m and m % restart == 0:
            flush()
            out.extend(bytes([0xFF, 0xD0 + (m // restart - 1) % 8]))
            pred = [0, 0, 0]
        my, mx = divmod(m, W // 16)
        units = [(0, 2 * my + dy, 2 * mx + dx) for dy in (0, 1) for dx in (0, 1)]
        for ci, by, bx in units + [(1, my, mx), (2, my, mx)]:
            coef = planes[ci][by, bx]
            tid = 0 if ci == 0 else 1
            diff = int(coef[0]) - pred[ci]
            pred[ci] = int(coef[0])
            size = abs(diff).bit_length()
            put(diff, size, codes[(0, tid)][size])
            run = 0
            last = int(np.flatnonzero(coef)[-1]) if coef[1:].any() else 0
            for k in range(1, last + 1):
                v = int(coef[k])
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    put(0, 0, codes[(1, tid)][0xF0])
                    run -= 16
                size = abs(v).bit_length()
                put(v, size, codes[(1, tid)][(run << 4) | size])
                run = 0
            if last < 63:
                put(0, 0, codes[(1, tid)][0x00])
    flush()

    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    head = b"\xff\xd8" + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tq, q in enumerate(quant):
        head += segment(0xDB, bytes([tq]) + bytes(int(v) for v in np.asarray(q)[_ZIGZAG]))
    head += segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3,
                                                                      0x11, 1]))
    for (tc, th), (counts, symbols) in _JPEG_HUFF.items():
        head += segment(0xC4, bytes([tc << 4 | th, *counts, *symbols]))
    if restart:
        head += segment(0xDD, struct.pack(">H", restart))
    head += segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return head + bytes(out) + b"\xff\xd9"


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 90, restart: int = 0) -> None:
    """Write ``encode_jpeg(rgb, quality, restart)`` to ``path``."""
    with open(path, "wb") as fh:
        fh.write(encode_jpeg(rgb, quality, restart))


SCANNET_FRAMES = 16


def write_scannet_scan(scan_dir: str, n: int = SCANNET_FRAMES, lost=(), restart: int = 8,
                       quality: int = 90) -> list:
    """Write a ScanNet-format scan of ``n`` 640x480 frames of the
    ``write_tum_sequence`` scene into ``scan_dir``: ``_info.txt``,
    ``frame-XXXXXX.color.jpg`` (:func:`encode_jpeg`),
    ``frame-XXXXXX.merged_depth.png`` (16-bit, metres x 5000) and
    ``frame-XXXXXX.pose.txt`` (camera to world; all ``inf`` for the frames
    in ``lost``, as ScanNet marks its tracking failures).  Returns the
    poses."""
    os.makedirs(scan_dir, exist_ok=True)
    frames = {}

    def keep(path, img):
        frames.setdefault(os.path.basename(path)[:-4], []).append(img)

    with tempfile.TemporaryDirectory() as tmp:
        poses = write_tum_sequence(tmp, n, save=keep)
    for i, (color, depth) in enumerate(frames.values()):
        base = os.path.join(scan_dir, f"frame-{i:06d}")
        write_jpeg(base + ".color.jpg", color, quality, restart)
        write_png(base + ".merged_depth.png", depth)
        np.savetxt(base + ".pose.txt", np.full((4, 4), np.inf) if i in lost else poses[i])
    with open(os.path.join(scan_dir, "_info.txt"), "w") as fh:
        fh.write(f"m_versionNumber = 4\nm_sensorName = StructureSDK\nm_frames.size = {n}\n")
    return poses


# the MovingObjects3D categories (``data/moving_objects.py::CATEGORIES``):
# every sequence a range names gets an info.pkl
MO3D_CATEGORIES = {"aeroplane": 200, "bicycle": 200, "bus": 200, "car": 200,
                   "boat": 200, "motorbike": 200}
MO3D_FRAMES = 6  # the frames of the one rendered clip the sequences share


def write_mo3d_dataset(root: str, h: int = 480, w: int = 640, n: int = MO3D_FRAMES,
                       categories=None, test_visible: int = 2, save=write_png) -> dict:
    """Render a MovingObjects3D-format dataset into ``root``: one clip of
    ``n`` h x w frames (``clip/color_i.png`` 8-bit RGB, ``clip/depth_i.png``
    16-bit depth in mm, ``clip/mask_i.png`` 8-bit with index 1 on the
    object) and an ``info.pkl`` for every sequence of ``categories`` (name
    -> sequence count; the dataset's full ranges by default), all pointing
    at the clip, the test objects (boat, motorbike) with their first
    ``test_visible`` frames visible.  The scene: a textured square of 0.8 m
    turning and moving at ~2 m in front of a textured wall at 4 m, seen from
    a camera that moves too; the exact camera and object poses (to world)
    go in ``info.pkl``.  ``save(path, array)`` writes one image.  Returns
    the intrinsics and the poses."""
    import pickle

    clip = os.path.join(root, "clip")
    os.makedirs(clip, exist_ok=True)
    fx = fy = 525.0 * w / 640
    cx, cy = (w - 1) / 2, (h - 1) / 2
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    rays = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    cams, objs, paths = [], [], {"color": [], "depth": [], "object_mask": []}
    for i in range(n):
        cam, obj = np.eye(4), np.eye(4)
        cam[:3, :3] = _rotation((0.3, 1.0, 0.2), np.radians(0.4) * i)
        cam[:3, 3] = np.array([0.01, 0.005, 0.004]) * i
        obj[:3, :3] = _rotation((0.2, 1.0, 0.1), np.radians(3.0) * i + 0.3)
        obj[:3, 3] = np.array([-0.15 + 0.03 * i, -0.05 + 0.015 * i, 2.0 + 0.02 * i])
        d = rays @ cam[:3, :3].T  # world directions with camera depth 1
        o = cam[:3, 3]
        s_bg = (4.0 - o[2]) / d[..., 2]
        normal = obj[:3, 2]
        s_obj = (normal @ (obj[:3, 3] - o)) / (d @ normal)
        local = (o + s_obj[..., None] * d - obj[:3, 3]) @ obj[:3, :3]
        hit = (np.abs(local[..., 0]) < 0.4) & (np.abs(local[..., 1]) < 0.4) & (s_obj > 0) \
            & (s_obj < s_bg)
        wall = o + s_bg[..., None] * d
        a = np.where(hit, local[..., 0], wall[..., 0])
        b = np.where(hit, local[..., 1], wall[..., 1])
        f = np.where(hit, 0.035, 0.07)[..., None]
        ph = np.array([0.0, 1.0, 2.0])
        color = (0.5 + 0.25 * np.sin(a[..., None] / f + ph) * np.cos(b[..., None] / (1.6 * f) - ph)
                 + 0.1 * np.sin((a + 2 * b)[..., None] / (0.7 * f) + 2 * ph))
        depth = np.where(hit, s_obj, s_bg)
        for key, name, img in (
                ("color", "color", np.clip(np.rint(color * 255), 0, 255).astype(np.uint8)),
                ("depth", "depth", np.rint(depth * 1000).astype(np.uint16)),
                ("object_mask", "mask", hit.astype(np.uint8))):
            save(os.path.join(clip, f"{name}_{i:04d}.png"), img)
            paths[key].append(f"/data/final/clip/{name}_{i:04d}.png")
        cams.append(cam)
        objs.append(obj)
    calib = [fx, fy, cx, cy]
    for name, count in (categories or MO3D_CATEGORIES).items():
        visible = list(range(test_visible if name in ("boat", "motorbike") else n))
        info = {**paths, "pose": cams, "object_poses": {"Model_1": objs},
                "object_visible_frames": {"Model_1": visible}, "calib": calib}
        blob = pickle.dumps(info)
        for seq in range(count):
            seq_dir = os.path.join(root, name, f"{seq:06d}")
            os.makedirs(seq_dir, exist_ok=True)
            with open(os.path.join(seq_dir, "info.pkl"), "wb") as fh:
                fh.write(blob)
    return {"calib": calib, "cam": cams, "obj": objs}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def peaks(name: str):
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no published peak rates for {name!r}")


def bound(nbytes, nflops, bw, flops):
    """The least time the card could take, in ms, and what bounds it: the
    bytes moved over the memory rate or the flops over the f32 rate."""
    return {"bound_ms": 1e3 * max(nbytes / bw, nflops / flops),
            "bound_by": "bytes" if nbytes / bw >= nflops / flops else "operations"}


def time_ms(torch, fn, reps: int = 50, warmup: int = 5, windows: int = 1) -> float:
    """Events time per call of ``reps`` back-to-back calls (host gaps
    included): the median over ``windows`` such windows, so that a pause of
    the shared host moves one window and not the result."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[windows // 2]


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device time per call of ``fn``: CUDA events around ``reps``
    back-to-back calls that the host queues while the card runs a sleep
    kernel, so the card runs them with no host launch gaps between them.
    Raises if the host took longer to queue them than the sleep lasted."""
    fn()
    torch.cuda.synchronize()
    queued, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    queued.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = queued.elapsed_time(start)
    if not host_ms < sleep_ms:
        raise RuntimeError(f"queueing {reps} calls took {host_ms:.3f} ms, longer than the "
                           f"{sleep_ms:.3f} ms sleep: the card waited for the host")
    return start.elapsed_time(end) / reps


def gather_inputs(torch, dev, h, w, seed, b=B):
    from deep_prob_feature_track_torch.geometry.warp import _corner_weights

    g = torch.Generator().manual_seed(seed)
    F = torch.randn(b, h, w, C_WARP, generator=g)
    u = torch.rand(b, 1, h, w, generator=g) * (w + 6) - 3
    v = torch.rand(b, 1, h, w, generator=g) * (h + 6) - 3
    u[:, 0, 0, :4] = torch.tensor([0.0, w - 1.0, w - 2.0, 3.0])
    v[:, 0, 0, :4] = torch.tensor([h - 1.0, 0.0, 5.0, h - 2.0])
    u, v = u.to(dev), v.to(dev)
    return (F.to(dev), *_corner_weights(F.shape, u, v)), (u, v)


def jtj_inputs(torch, dev, hw, seed, b=B, c=C_RES):
    g = torch.Generator().manual_seed(seed)
    shapes = ((b, c, hw),) * 3 + ((b, hw, 6),) * 2
    return [torch.randn(*s, generator=g).to(dev) for s in shapes]


def check_jtj(torch, args, label, plain32=True):
    """K6 against its plain version on ``args``, in float64 and, with
    ``plain32``, in float32: rtol 1e-5, atol 1e-5 of the largest entry; a
    symmetric JtJ.  Logs how far each float32 result is from the float64
    one; returns the kernel's largest error against the one it is held to."""
    from deep_prob_feature_track_torch.ops import kernels as K

    got = K.fused_jtj_jtr_cuda(*args, sign=-1.0)
    f32 = K.jtj_jtr_ref(*args, sign=-1.0)
    f64 = [t.float() for t in K.jtj_jtr_ref(*[a.double() for a in args], sign=-1.0)]
    torch.cuda.synchronize()
    refs = (f64, f32) if plain32 else (f64,)
    for ref in refs:
        for x, r in zip(got, ref):
            torch.testing.assert_close(x, r, rtol=1e-5, atol=1e-5 * r.abs().max().item())
    if not torch.equal(got[0], got[0].transpose(1, 2)):
        raise AssertionError(f"fused_jtj_jtr {label}: JtJ is not symmetric")

    def dist(a, r):
        return max((x - y).abs().max().item() for x, y in zip(a, r)) / r[0].abs().max().item()

    log(f"K6 fused_jtj_jtr {label}, as a share of the largest entry: |kernel - plain f64| "
        f"{dist(got, f64):.2e}, |kernel - plain f32| {dist(got, f32):.2e}, |plain f32 - plain "
        f"f64| {dist(f32, f64):.2e}")
    ref = refs[-1]
    return max((x - r).abs().max().item() for x, r in zip(got, ref))


def traced_kernels(torch, fn, warmup: int):
    """The device events of a ``torch.profiler`` trace of one call of
    ``fn``, after ``warmup`` untraced calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def phase_kernels(torch, dev):
    from deep_prob_feature_track_torch.ops import kernels as K

    err = {"gather_twohot": 0.0, "fused_jtj_jtr": 0.0}
    for i, (h, w) in enumerate(LEVELS):
        args, _ = gather_inputs(torch, dev, h, w, seed=i)
        out = K.gather_twohot_cuda(*args)
        ref = K.gather_twohot_ref(*args)
        torch.cuda.synchronize()
        e = (out - ref).abs().max().item()
        log(f"K1 gather_twohot level {i} [{B},{C_WARP},{h * w}]: max|kernel - plain| = {e:.3e}")
        if not e <= 1e-6:
            raise AssertionError(f"gather_twohot disagrees with its plain version: {e}")
        err["gather_twohot"] = max(err["gather_twohot"], e)

        args = jtj_inputs(torch, dev, h * w, seed=10 + i)
        e = check_jtj(torch, args, f"level {i} [{B},{C_RES},{h * w}]")
        err["fused_jtj_jtr"] = max(err["fused_jtj_jtr"], e)
        names = [e.name for e in traced_kernels(
            torch, lambda: K.fused_jtj_jtr_cuda(*args, sign=-1.0), warmup=1)]
        log(f"K6 fused_jtj_jtr level {i}: one call ran {len(names)} device kernel(s) {names}")
        if len(names) != 1:
            raise AssertionError(f"one fused_jtj_jtr call ran {len(names)} device kernels")
    return err


def splat_cotangent(torch, dev, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B_TRAIN, C_WARP, h * w, generator=g).to(dev)


def phase_grads_kernels(torch, dev):
    from deep_prob_feature_track_torch.ops import kernels as K

    err = {"gather_twohot_grads": 0.0, "splat_twohot": 0.0}
    for i, (h, w) in enumerate(LEVELS):
        args, _ = gather_inputs(torch, dev, h, w, seed=20 + i, b=B_TRAIN)
        got = K.gather_twohot_grads_cuda(*args)
        ref = K.gather_twohot_grads_ref(*args)
        torch.cuda.synchronize()
        e_out = (got[0] - ref[0]).abs().max().item()
        e_grads = max((a - r).abs().max().item() for a, r in zip(got[1:], ref[1:]))
        top = max(r.abs().max().item() for r in ref[1:])
        log(f"K2 gather_twohot_grads level {i} [{B_TRAIN},{C_WARP},{h * w}]: max|out - plain| "
            f"= {e_out:.3e}, max|gx,gy - plain| = {e_grads:.3e} ({e_grads / top:.2e} of "
            f"the largest entry)")
        if e_out != 0.0:
            raise AssertionError(f"gather_twohot_grads out is not bit-exact: {e_out}")
        if not e_grads <= 1e-6 * top:
            raise AssertionError(f"gather_twohot_grads gx/gy disagree: {e_grads}")
        err["gather_twohot_grads"] = max(err["gather_twohot_grads"], e_grads)

        g = splat_cotangent(torch, dev, h, w, seed=30 + i)
        got = K.splat_twohot_cuda(g, *args[1:], h, w)
        ref = K.splat_twohot_ref(g, *args[1:], h, w)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        top = ref.abs().max().item()
        log(f"K3 splat_twohot level {i} [{B_TRAIN},{h},{w},{C_WARP}]: max|kernel - plain| = "
            f"{e:.3e} ({e / top:.2e} of the largest entry {top:.3e})")
        if not e <= 1e-5 * top:
            raise AssertionError(f"splat_twohot disagrees with its plain version: {e}")
        err["splat_twohot"] = max(err["splat_twohot"], e)
    return err


def tile_inputs(torch, dev, b, h, w, c, seed, coords="smooth"):
    """A plane F [b,h,w,c] and the corner maps [b,h,w] of ``coords``:
    ``smooth`` sub-pixel flow (a tracker near convergence: every tile's box
    fits in shared memory), ``teleported``, the same with 64 samples per
    image moved half the plane away (their tiles take the global path), or
    ``offplane``, the smooth flow zoomed out 4x about the plane's centre (a
    large motion: ~94% of the samples clamp to the border), or ``tracking``,
    the JAX package's tracking-like flow of its tile tests (3-pixel
    sinusoids, ``tests/test_gather_tiles.py::make_coords``), whose motion
    gradient (up to 0.43 pixels a pixel) sends most of K4's tiles out of
    its window.  Also returns (u, v)."""
    from deep_prob_feature_track_torch.geometry.warp import _corner_weights

    g = torch.Generator().manual_seed(seed)
    F = torch.randn(b, h, w, c, generator=g)
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    phase = torch.rand(b, 1, 1, 1, generator=g) * 3
    if coords == "tracking":
        u = (xx + 3.0 * torch.sin(yy / 7.0 + phase)).contiguous()
        v = (yy + 3.0 * torch.cos(xx / 9.0 + phase)).contiguous()
    else:
        u = (xx + 0.8 * torch.sin(yy / 9.0 + phase) + 0.3).contiguous()
        v = (yy + 0.8 * torch.cos(xx / 11.0 + phase) + 0.2).contiguous()
    if coords == "offplane":
        u = (u - w / 2) * 4 + w / 2
        v = (v - h / 2) * 4 + h / 2
    if coords == "teleported":
        teleport(torch, u, v, g)
    u, v = u.to(dev), v.to(dev)
    maps = [t.reshape(b, h, w) for t in _corner_weights((b, h, w, c), u, v)]
    return F.to(dev), maps, (u, v)


def teleport(torch, u, v, g):
    """Move 64 samples an image of the coordinates u, v [b,1,h,w] (CPU,
    in place) half the plane away."""
    b, _, h, w = u.shape
    idx = torch.randint(0, h * w, (b, 64), generator=g)
    for m, size in ((u, w), (v, h)):
        flat = m.view(b, -1)
        flat.scatter_(1, idx, (flat.gather(1, idx) + size / 2) % (size - 1))


def ufc_inputs(torch, dev, b, h, w, c, seed, teleported=False):
    """A plane F [b,h,w,c] and the corner maps [b,h,w] of U_FC's forward
    warp (``solvers/trust_region.py::_warp_forward_depth``) of
    ``synthetic_batch``'s depth at h x w under a small motion, with a pixel
    of zero depth every 37 rows and 41 columns (it projects from the
    translation alone, far from its neighbours); with ``teleported``, 64
    samples an image moved half the plane away.  Also returns (u, v)."""
    from deep_prob_feature_track_torch.geometry.lie import exp_so3
    from deep_prob_feature_track_torch.geometry.warp import _corner_weights
    from deep_prob_feature_track_torch.solvers.trust_region import _warp_forward_depth
    from deep_prob_feature_track_torch.training.train import synthetic_batch

    batch = synthetic_batch(b, h, w, seed=seed, device="cpu")
    depth = batch["depth0"]
    depth[:, :, ::37, ::41] = 0.0
    g = torch.Generator().manual_seed(seed)
    pose = (exp_so3(torch.randn(b, 3, generator=g) * 0.01), torch.randn(b, 3, generator=g) * 0.02)
    u, v = _warp_forward_depth(depth, pose, batch["calib"])[:2]
    if teleported:
        teleport(torch, u, v, g)
    F = torch.randn(b, h, w, c, generator=g)
    u, v = u.to(dev), v.to(dev)
    maps = [t.reshape(b, h, w) for t in _corner_weights((b, h, w, c), u, v)]
    return F.to(dev), maps, (u, v)


# (kernel, batch, level of VGA_LEVELS) as the 480x640 paths launch them
TILE_CASES = (("gather_tiles", B, 0), ("gather_tiles_grads", B_VGA_TRAIN, 0),
              ("gather_tiles_grads", B_VGA_TRAIN, 1))
# the channel counts each tile kernel is checked at: the feature warp's,
# the un-slimmed one, and the classical and ICP warps' (K4 at C=1 and 3 is
# checked though the route sends those planes to K1)
TILE_CHANNELS = {"gather_tiles": C_ICP + (C_WARP, C_FULL),
                 "gather_tiles_grads": (6, C_WARP, C_FULL)}


def phase_tiles_kernels(torch, dev):
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.ops.kernels.tiles import grads_staged_share, staged_share

    err = {"gather_tiles": 0.0, "gather_tiles_grads": 0.0}
    for i, (kname, b, level) in enumerate(TILE_CASES):
        h, w = VGA_LEVELS[level]
        for c in TILE_CHANNELS[kname]:
            for teleport in (False, True):
                F, maps, _ = tile_inputs(torch, dev, b, h, w, c, seed=40 + i,
                                         coords="teleported" if teleport else "smooth")
                flat = [m.reshape(b, -1) for m in maps]
                share = (staged_share if kname == "gather_tiles" else grads_staged_share)(
                    maps[0], maps[2], h, w, c)
                if kname == "gather_tiles":
                    got = (K.gather_tiles_cuda(F, *maps),)
                    ref = (K.gather_tiles_ref(F, *maps),)
                    full = (K.gather_twohot_cuda(F, *flat),)
                else:
                    got = K.gather_tiles_grads_cuda(F, *maps)
                    ref = K.gather_tiles_grads_ref(F, *maps)
                    full = K.gather_twohot_grads_cuda(F, *flat)
                torch.cuda.synchronize()
                e_out = (got[0] - ref[0]).abs().max().item()
                e_full = max((a - r).abs().max().item() for a, r in zip(got, full))
                e_grads, top = 0.0, 1.0
                if len(got) == 3:
                    e_grads = max((a - r).abs().max().item() for a, r in zip(got[1:], ref[1:]))
                    top = max(r.abs().max().item() for r in ref[1:])
                log(f"{kname} level {level} [{b},{c},{h * w}], "
                    f"{'teleported' if teleport else 'smooth'} coordinates, staged share "
                    f"{share:.4f}: max|out - plain| = {e_out:.3e}, max|gx,gy - plain| = "
                    f"{e_grads:.3e} ({e_grads / top:.2e} of the largest entry), "
                    f"max|kernel - {'K2' if len(got) == 3 else 'K1'}| = {e_full:.3e}")
                if e_out != 0.0 or e_full != 0.0:
                    raise AssertionError(f"{kname} out is not bit-exact: {e_out}, {e_full}")
                if not e_grads <= 1e-6 * top:
                    raise AssertionError(f"{kname} gx/gy disagree: {e_grads}")
                if not (0.0 < share < 1.0 if teleport else share == 1.0):
                    raise AssertionError(f"{kname}: staged share {share} does not exercise the "
                                         "path these coordinates were made for")
                err[kname] = max(err[kname], e_grads if len(got) == 3 else e_out)
    return err


def phase_flat_kernels(torch, dev):
    """K1 (B=8), K2 and K3 (B=64) on smooth, teleported and off-plane
    coordinates at the four 120x160 levels, C=10 and C=17, K1 and K2 there
    at C=1, 3 and 6 (the classical and ICP warps), and K3 at 480x640, B=4
    level 0: K1 and K2's ``out`` bit-exact (K2's also with
    K1), K2's gx/gy within 1e-6 and K3 within 1e-5 of the largest entry.
    The teleported and off-plane level-0 K3 launches at C=10 must mix
    staged and global tiles, and its smooth launches at C=10 stage every
    tile."""
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.ops.kernels.splat import splat_staged_share

    err = {"gather_twohot": 0.0, "gather_twohot_grads": 0.0, "splat_twohot": 0.0}
    cases = [(False, i, B_TRAIN, h, w, c, coords) for i, (h, w) in enumerate(LEVELS)
             for c in C_ICP + (C_WARP, C_FULL) for coords in COORDS[1:]]
    cases.append((True, 0, B_VGA_TRAIN, *VGA_LEVELS[0], C_WARP, "smooth"))
    for vga, i, b, h, w, c, coords in cases:
        label = f"level {i} {h}x{w}, C={c}, {coords} coordinates"
        if not vga:
            F, args, _ = flat_inputs(torch, dev, B, h, w, c, 80 + i, coords)
            out = K.gather_twohot_cuda(F, *args)
            ref = K.gather_twohot_ref(F, *args)
            torch.cuda.synchronize()
            e = (out - ref).abs().max().item()
            log(f"K1 gather_twohot {label}, B={B}: max|kernel - plain| = {e:.3e}")
            if e != 0.0:
                raise AssertionError(f"gather_twohot is not bit-exact on {label}: {e}")

        F, args, _ = flat_inputs(torch, dev, b, h, w, c, 90 + i, coords)
        if not vga:
            got = K.gather_twohot_grads_cuda(F, *args)
            ref = K.gather_twohot_grads_ref(F, *args)
            k1 = K.gather_twohot_cuda(F, *args)
            torch.cuda.synchronize()
            e_out = max((got[0] - ref[0]).abs().max().item(), (got[0] - k1).abs().max().item())
            e2 = max((a - r).abs().max().item() for a, r in zip(got[1:], ref[1:]))
            top = max(r.abs().max().item() for r in ref[1:])
            log(f"K2 gather_twohot_grads {label}, B={b}: max|out - plain, K1| = {e_out:.3e}, "
                f"max|gx,gy - plain| = {e2:.3e} ({e2 / top:.2e} of the largest entry)")
            if e_out != 0.0:
                raise AssertionError(f"gather_twohot_grads out is not bit-exact on {label}")
            if not e2 <= 1e-6 * top:
                raise AssertionError(f"gather_twohot_grads gx/gy disagree on {label}: {e2}")
            err["gather_twohot_grads"] = max(err["gather_twohot_grads"], e2)
            err["gather_twohot"] = max(err["gather_twohot"], e)
        if c in C_ICP:  # no K3 for these warps: the ICP operand needs no cotangent,
            continue    # and the classical presets do not train
        g = torch.randn(b, c, h * w, generator=torch.Generator().manual_seed(i)).to(dev)
        got = K.splat_twohot_cuda(g, *args, h, w)
        ref = K.splat_twohot_ref(g, *args, h, w)
        torch.cuda.synchronize()
        e3 = (got - ref).abs().max().item()
        top = ref.abs().max().item()
        share = splat_staged_share(args[0], args[2], h, w, c)
        log(f"K3 splat_twohot {label}, B={b}: staged share {share:.4f}, max|kernel - plain| = "
            f"{e3:.3e} ({e3 / top:.2e} of the largest entry)")
        if not e3 <= 1e-5 * top:
            raise AssertionError(f"splat_twohot disagrees with its plain version on {label}: {e3}")
        if (vga, c, coords) == (False, C_WARP, "smooth") and share != 1.0:
            raise AssertionError(f"splat_twohot on {label}: a tile did not stage ({share})")
        if ((vga, i, c) == (False, 0, C_WARP) and coords in ("teleported", "offplane")
                and not 0.0 < share < 1.0):
            raise AssertionError(f"splat_twohot on {label} did not take both branches ({share})")
        err["splat_twohot"] = max(err["splat_twohot"], e3)
    return err


def upsample_inputs(torch, dev, b, h, w, seed):
    """A plane F [b,h,w,1] and the corner maps [b,4hw] of its align-corners
    upsample to 2h x 2w (``ops/image.py::bilinear_resize_align``)."""
    from deep_prob_feature_track_torch.geometry.warp import _corner_weights

    H2, W2 = 2 * h, 2 * w
    v = torch.arange(H2, dtype=torch.float32) * ((h - 1.0) / (H2 - 1.0))
    u = torch.arange(W2, dtype=torch.float32) * ((w - 1.0) / (W2 - 1.0))
    u = u[None, None, None, :].expand(b, 1, H2, W2).to(dev)
    v = v[None, None, :, None].expand(b, 1, H2, W2).to(dev)
    F = torch.randn(b, h, w, 1, generator=torch.Generator().manual_seed(seed)).to(dev)
    return F, list(_corner_weights(F.shape, u, v))


def phase_deepic_kernels(torch, dev):
    """K1 at DeepIC's eval shapes (the folded samples of B=8 at each level
    and the upsamples at B=8), K2 and K3 at its training shapes (the folded
    samples of B=64 and the upsamples at B=64), C=1: K1 and K2's ``out``
    bit-exact, gx/gy within 1e-6 and K3 within 1e-5 of the largest entry."""
    from deep_prob_feature_track_torch.ops import kernels as K

    err = {"gather_twohot": 0.0, "gather_twohot_grads": 0.0, "splat_twohot": 0.0}
    cases = []
    for train, b in ((False, B), (True, B_TRAIN)):
        for i, (h, w) in enumerate(LEVELS):
            F, maps, _ = tile_inputs(torch, dev, S_DAMP * b, h, w, 1, seed=130 + i)
            cases.append((f"folded level {i} {h}x{w}", train, S_DAMP * b, h, w, F,
                          [m.reshape(S_DAMP * b, -1) for m in maps]))
        for i, (h, w) in enumerate(LEVELS[1:]):
            cases.append((f"upsample {h}x{w} -> {2 * h}x{2 * w}", train, b, h, w,
                          *upsample_inputs(torch, dev, b, h, w, seed=140 + i)))
    for label, train, b, h, w, F, args in cases:
        if not train:  # the eval shapes: K1
            out, ref = K.gather_twohot_cuda(F, *args), K.gather_twohot_ref(F, *args)
            torch.cuda.synchronize()
            e = (out - ref).abs().max().item()
            log(f"K1 gather_twohot DeepIC {label}, {b} planes: max|kernel - plain| = {e:.3e}")
            if e != 0.0:
                raise AssertionError(f"gather_twohot is not bit-exact at DeepIC {label}: {e}")
            continue
        got, ref = K.gather_twohot_grads_cuda(F, *args), K.gather_twohot_grads_ref(F, *args)
        torch.cuda.synchronize()
        e_out = (got[0] - ref[0]).abs().max().item()
        e2 = max((a - r).abs().max().item() for a, r in zip(got[1:], ref[1:]))
        top = max(r.abs().max().item() for r in ref[1:])
        g = torch.randn(b, 1, args[0].shape[1], generator=torch.Generator().manual_seed(b))
        g = g.to(dev)
        got3, ref3 = K.splat_twohot_cuda(g, *args, h, w), K.splat_twohot_ref(g, *args, h, w)
        torch.cuda.synchronize()
        e3 = (got3 - ref3).abs().max().item()
        top3 = ref3.abs().max().item()
        log(f"K2/K3 DeepIC {label}, {b} planes: K2 max|out - plain| = {e_out:.3e}, "
            f"max|gx,gy - plain| = {e2:.3e} ({e2 / top:.2e} of the largest entry); K3 "
            f"max|kernel - plain| = {e3:.3e} ({e3 / top3:.2e} of the largest entry)")
        if e_out != 0.0:
            raise AssertionError(f"gather_twohot_grads out is not bit-exact at DeepIC {label}")
        if not e2 <= 1e-6 * top:
            raise AssertionError(f"gather_twohot_grads gx/gy disagree at DeepIC {label}: {e2}")
        if not e3 <= 1e-5 * top3:
            raise AssertionError(f"splat_twohot disagrees at DeepIC {label}: {e3}")
        err["gather_twohot_grads"] = max(err["gather_twohot_grads"], e2)
        err["splat_twohot"] = max(err["splat_twohot"], e3)
    return err


def phase_time_deepic(torch, dev, name):
    """K1 at DeepIC's folded level-0 shape (the 10 damping samples of B=8:
    80 planes of 120x160, C=1) on smooth coordinates, beside its plain
    version, ``grid_sample`` and the byte bound."""
    bw, flops = peaks(name)
    b = S_DAMP * B
    F, maps, uv = tile_inputs(torch, dev, b, H, W, 1, seed=150)
    r = {"b": b, "hw": [H, W], "c": 1,
         **k1_timing(torch, F, [m.reshape(b, -1) for m in maps], uv, bw, flops)}
    log(f"DeepIC folded level 0, {b} planes of {H}x{W}, C=1, smooth coordinates: K1 "
        f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} (plain {r['plain_ms']:.4f}, "
        f"grid_sample {r['library_ms']:.4f}, device {r['library_device_ms']:.4f}, bound "
        f"{r['bound_ms']:.4f})")
    return r


def check_k4(torch, F, maps, label):
    """K4 on F and the corner maps against its plain version and K1 on the
    flattened maps, bit for bit; returns the largest difference."""
    from deep_prob_feature_track_torch.ops import kernels as K

    b = F.shape[0]
    out = K.gather_tiles_cuda(F, *maps)
    ref = K.gather_tiles_ref(F, *maps)
    k1 = K.gather_twohot_cuda(F, *[m.reshape(b, -1) for m in maps])
    torch.cuda.synchronize()
    e = max((out - ref).abs().max().item(), (out - k1).abs().max().item())
    if e != 0.0:
        raise AssertionError(f"gather_tiles is not bit-exact at {label}: {e}")
    return e


def check_k2(torch, F, args, label):
    """K2 against its plain version: ``out`` bit-exact (and K1's), gx/gy
    within 1e-6 of the largest entry; returns the gx/gy difference."""
    from deep_prob_feature_track_torch.ops import kernels as K

    got, ref = K.gather_twohot_grads_cuda(F, *args), K.gather_twohot_grads_ref(F, *args)
    k1 = K.gather_twohot_cuda(F, *args)
    torch.cuda.synchronize()
    e_out = max((got[0] - ref[0]).abs().max().item(), (got[0] - k1).abs().max().item())
    e2 = max((a - r).abs().max().item() for a, r in zip(got[1:], ref[1:]))
    top = max(r.abs().max().item() for r in ref[1:])
    log(f"K2 gather_twohot_grads {label}: max|out - plain, K1| = {e_out:.3e}, max|gx,gy - "
        f"plain| = {e2:.3e} ({e2 / top:.2e} of the largest entry)")
    if e_out != 0.0:
        raise AssertionError(f"gather_twohot_grads out is not bit-exact at {label}")
    if not e2 <= 1e-6 * top:
        raise AssertionError(f"gather_twohot_grads gx/gy disagree at {label}: {e2}")
    return e2


def phase_ufc_kernels(torch, dev):
    """U_FC's new kernel shapes against the plain versions, on its forward
    warp's coordinates (``ufc_inputs``): K4 at C=28, B=8, on the 120x160
    plane and the 480x640 and 240x320 planes of 640x480's levels 0-1 (its
    level 2 is 120x160), also with teleported samples (staged and global
    tiles in one launch), bit-exact with its plain version and with K1; K1
    at C=28 and C=49 (B=8) at the four 120x160 levels, bit-exact; K2 at
    C=28 and C=49 (B=64) there, ``out`` bit-exact, gx/gy within 1e-6 of the
    largest entry; K3 at C=28 (B=64) there, within 1e-5 of the largest
    entry.  Returns the largest errors and K4's staged shares."""
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.ops.kernels.tiles import staged_share

    err = {"gather_tiles": 0.0, "gather_twohot": 0.0, "gather_twohot_grads": 0.0,
           "splat_twohot": 0.0}
    shares = {}
    for h, w in ((H, W), *VGA_LEVELS[:2]):
        for teleported in (False, True):
            F, maps, _ = ufc_inputs(torch, dev, B, h, w, C_UFC, seed=160 + h,
                                    teleported=teleported)
            key = f"{h}x{w}{' teleported' if teleported else ''}"
            shares[key] = staged_share(maps[0], maps[2], h, w, C_UFC)
            err["gather_tiles"] = max(err["gather_tiles"], check_k4(torch, F, maps, key))
            log(f"K4 gather_tiles U_FC [{B},{C_UFC},{h * w}] {key}: staged share "
                f"{shares[key]:.4f}, bit-exact with its plain version and K1")
            if teleported and not 0.0 < shares[key] < 1.0:
                raise AssertionError(f"gather_tiles at {key}: staged share {shares[key]} does "
                                     "not mix staged and global tiles")
    for i, (h, w) in enumerate(LEVELS):
        for c in (C_UFC, C_UFC_WIDE):
            label = f"U_FC level {i} {h}x{w}, C={c}"
            F, maps, _ = ufc_inputs(torch, dev, B, h, w, c, seed=170 + i)
            args = [m.reshape(B, -1) for m in maps]
            out, ref = K.gather_twohot_cuda(F, *args), K.gather_twohot_ref(F, *args)
            torch.cuda.synchronize()
            e = (out - ref).abs().max().item()
            log(f"K1 gather_twohot {label}, B={B}: max|kernel - plain| = {e:.3e}")
            if e != 0.0:
                raise AssertionError(f"gather_twohot is not bit-exact at {label}: {e}")
            F, maps, _ = ufc_inputs(torch, dev, B_TRAIN, h, w, c, seed=180 + i)
            args = [m.reshape(B_TRAIN, -1) for m in maps]
            e2 = check_k2(torch, F, args, f"{label}, B={B_TRAIN}")
            err["gather_twohot_grads"] = max(err["gather_twohot_grads"], e2)
            if c != C_UFC:  # the C=49 operand's cotangent is not on a path checked here
                continue
            g = torch.randn(B_TRAIN, c, h * w, generator=torch.Generator().manual_seed(i))
            g = g.to(dev)
            got, ref = K.splat_twohot_cuda(g, *args, h, w), K.splat_twohot_ref(g, *args, h, w)
            torch.cuda.synchronize()
            e3 = (got - ref).abs().max().item()
            top = ref.abs().max().item()
            log(f"K3 splat_twohot {label}, B={B_TRAIN}: max|kernel - plain| = {e3:.3e} "
                f"({e3 / top:.2e} of the largest entry)")
            if not e3 <= 1e-5 * top:
                raise AssertionError(f"splat_twohot disagrees at {label}: {e3}")
            err["splat_twohot"] = max(err["splat_twohot"], e3)
    return err, shares


def phase_time_ufc(torch, dev, name):
    """U_FC's kernel shapes, on its forward warp's coordinates: K4 at C=28
    (B=8) on the 120x160 plane and 640x480's level-0 and level-1 planes,
    also on smooth coordinates (every tile stages, as on the synthetic
    scenes' U_FC forwards), beside K1 on the same inputs and
    ``grid_sample``; K1 at C=28 on the
    60x80 level and at C=49 on the 120x160 one (B=8); K2 and K3 at C=28 on
    the 120x160 level (B=64, K3 beside ``grid_sampler_2d_backward``); each
    beside its plain version and bound."""
    bw, flops = peaks(name)
    rows = []
    for h, w in ((H, W), *VGA_LEVELS[:2]):
        for coords in ("ufc", "smooth"):
            F, maps, uv = (ufc_inputs(torch, dev, B, h, w, C_UFC, seed=190 + h)
                           if coords == "ufc" else
                           tile_inputs(torch, dev, B, h, w, C_UFC, seed=190 + h))
            rows.append({"kernel": "gather_tiles", "b": B, "hw": [h, w], "c": C_UFC,
                         "coords": coords,
                         **tile_timing(torch, "gather_tiles", F, maps, uv, bw, flops)})
    for (h, w), c in ((LEVELS[1], C_UFC), (LEVELS[0], C_UFC_WIDE)):
        F, maps, uv = ufc_inputs(torch, dev, B, h, w, c, seed=200 + c)
        rows.append({"kernel": "gather_twohot", "b": B, "hw": [h, w], "c": c,
                     **k1_timing(torch, F, [m.reshape(B, -1) for m in maps], uv, bw, flops)})
    F, maps, uv = ufc_inputs(torch, dev, B_TRAIN, H, W, C_UFC, seed=210)
    args = [m.reshape(B_TRAIN, -1) for m in maps]
    rows.append({"kernel": "gather_twohot_grads", "b": B_TRAIN, "hw": [H, W], "c": C_UFC,
                 **k2_timing(torch, F, args, bw, flops)})
    g = torch.randn(B_TRAIN, C_UFC, H * W, generator=torch.Generator().manual_seed(211))
    rows.append({"kernel": "splat_twohot", "b": B_TRAIN, "hw": [H, W], "c": C_UFC,
                 **k3_timing(torch, g.to(dev), args, uv, H, W, bw, flops)})
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = (f", K1 on the same inputs {r['full_plane_ms']:.4f}, device "
                 f"{r['full_plane_device_ms']:.4f}, staged share {r['staged_share']:.4f}"
                 if r["kernel"] == "gather_tiles" else "")
        log(f"U_FC {r['kernel']} C={r['c']} B={r['b']} {r['hw'][0]}x{r['hw'][1]}"
            f"{', ' + r['coords'] + ' coordinates' if 'coords' in r else ''}: "
            f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} (plain {r['plain_ms']:.4f}, "
            f"library {lib}, bound {r['bound_ms']:.4f}{extra})")
    return rows


def _payload(item) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **item)
    return buf.getvalue()


def request_items(n: int, h: int, w: int, seed: int = 1):
    from deep_prob_feature_track_torch.apps.serve import example_batch

    batch = [t.numpy() for t in example_batch(n, h, w, seed=seed, device="cpu")]
    return [{k: a[i] for k, a in zip(KEYS, batch)} for i in range(n)]


def smooth_items(n: int, h: int, w: int):
    """``n`` requests of ``training/train.py::synthetic_batch``'s smooth
    textured scenes (seed 2): on ``request_items``' uniform-noise depth the
    ICP and occlusion masks flip under one rounding of K6's sums, which a
    weighted ICP term or an information matrix amplifies."""
    from deep_prob_feature_track_torch.training.train import synthetic_batch

    batch = synthetic_batch(n, h, w, seed=2, device="cpu")
    return [{k: batch[k][i].numpy() for k in KEYS} for i in range(n)]


def config_name(preset, overrides=()):
    """The name of ``preset`` with its config overrides, for the log."""
    return " ".join((preset, *overrides))


def phase_serve(torch, dev, h, w, expected, preset="feature", overrides=()):
    """Serve 12 requests from threads and one HTTP request at h x w; the
    launch counts must be ``expected`` per served batch."""
    from deep_prob_feature_track_torch.apps.serve import build_service, make_handler
    from deep_prob_feature_track_torch.ops import kernels as K

    service = build_service(preset, "", max_batch=B, H=h, W=w, device=dev, overrides=overrides)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        items = request_items(N_REQUESTS + 1, h, w)
        results = [None] * N_REQUESTS
        errors = []

        def call(i):
            try:
                results[i] = service.submit(items[i])
            except Exception as e:  # recorded and raised below
                errors.append(f"request {i}: {e!r}")

        n0 = service.n_batches
        K.reset_launches()
        threads = [threading.Thread(target=call, args=(i,)) for i in range(N_REQUESTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        url = f"http://127.0.0.1:{httpd.server_address[1]}/track"
        req = urllib.request.Request(url, data=_payload(items[-1]), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            http_out = np.load(io.BytesIO(r.read()))
            results.append({"R": http_out["R"], "t": http_out["t"]})
        launches = dict(K.LAUNCHES)
        batches = service.n_batches - n0
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()
        server.join(10)

    if errors or any(th.is_alive() for th in threads):
        raise RuntimeError(f"requests failed: {errors}")
    log(f"{config_name(preset, overrides)}: served {len(results)} requests at {h}x{w} "
        f"({N_REQUESTS} from threads + 1 HTTP) in {batches} batches; launches {launches}")
    if batches < 2:
        raise AssertionError("expected at least two batches")
    for name, n in launches.items():
        if n != expected[name] * batches:
            raise AssertionError(f"{name} launched {n} times in {batches} batches, "
                                 f"expected {expected[name] * batches}")
    for i, out in enumerate(results):
        R, t = out["R"], out["t"]
        orth = np.abs(R.T @ R - np.eye(3)).max()
        if R.shape != (3, 3) or t.shape != (3,) or not orth < 1e-4 or not np.isfinite(t).all():
            raise AssertionError(f"request {i}: bad pose (|R^T R - I| = {orth}, t = {t})")
    return launches, items[:B]


def phase_agree(torch, dev, items, n_cpu, preset="feature", plain_atol=1e-4, expected=None,
                overrides=()):
    """The forward of ``items`` through the kernels against their plain
    versions on the card (within ``plain_atol`` on R and t); the forward of
    the first ``n_cpu`` of them through the kernels against the CPU forward
    (within 1e-4).  With ``expected``, the kernel forward's launch counts
    (reset just before it, read just after) must be those.  Returns the
    largest differences and the launch counts."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker
    from deep_prob_feature_track_torch.ops import kernels as K

    def pose(batch_items, device, plain=False):
        batch = [torch.from_numpy(np.stack([it[k] for it in batch_items])).to(device)
                 for k in KEYS]
        net = build_tracker(preset, device=device, plain_kernels=plain, overrides=overrides)
        with torch.inference_mode():
            K.reset_launches()
            R, t = net(*batch)
            launches = dict(K.LAUNCHES)
        return R.cpu().numpy(), t.cpu().numpy(), launches

    name = config_name(preset, overrides)
    *kernels, launches = pose(items, dev)
    h, w = items[0]["color0"].shape[1:]
    log(f"{name}: B={len(items)} {h}x{w} forward through the kernels, launches {launches}")
    if expected is not None and launches != expected:
        raise AssertionError(f"{name} forward launched {launches}, expected {expected}")
    pairs = [("plain", kernels, pose(items, dev, plain=True)[:2], plain_atol)]
    if n_cpu:
        few = kernels if n_cpu == len(items) else pose(items[:n_cpu], dev)[:2]
        pairs.append(("cpu", few, pose(items[:n_cpu], torch.device("cpu"))[:2], 1e-4))
    out = {"launches": launches}
    for other, (R0, t0), (R, t), atol in pairs:
        dR, dt = np.abs(R - R0).max(), np.abs(t - t0).max()
        log(f"{name}: B={len(R)} {h}x{w} forward, kernels vs {other}: max|dR| = {dR:.3e}, "
            f"max|dt| = {dt:.3e}")
        if not (dR <= atol and dt <= atol):
            raise AssertionError(f"{name}: kernel forward disagrees with the {other} forward")
        out[other] = [float(dR), float(dt)]
    return out


def _train_state(torch, dev, plain=False, preset="feature", overrides=(), objective="EPE3D"):
    from deep_prob_feature_track_torch.models.presets import apply_overrides, get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as T

    cfg = T.TrainConfig(loss=objective)
    net = LeastSquareTracking(apply_overrides(get_preset(preset), overrides), plain_kernels=plain)
    return cfg, T.create_train_state(net, cfg, seed=1, device=dev)


def _loss_and_grads(torch, dev, batch, plain, preset, overrides=(), objective="EPE3D"):
    from deep_prob_feature_track_torch.training import train as T

    cfg, state = _train_state(torch, dev, plain, preset, overrides, objective)
    loss = T.compute_loss(state.net, cfg, batch)
    loss.backward()
    return loss.item(), {k: p.grad for k, p in state.net.named_parameters()}


def _worst_leaf(grads, ref):
    """max over the leaves of |grads - ref| / max|ref|, and its leaf."""
    ratios = [(((grads[k] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item(), k)
              for k, g in ref.items()]
    if not all(np.isfinite(r) for r, _ in ratios):
        raise AssertionError("a gradient leaf is not finite")
    return max(ratios)


def phase_train(torch, dev, b, h, w, seed, expected, preset="feature", overrides=(),
                objective="EPE3D"):
    """Three steps of ``preset`` at b x h x w under the loss ``objective``, with the
    launch counts ``expected`` per step; kernels against plain versions;
    step time, memory, profile."""
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.training import train as T

    name = config_name(preset, overrides) + (
        "" if objective == "EPE3D" else f" --loss {objective}")
    batch = T.synthetic_batch(b, h, w, seed=seed, device=dev)
    cfg, state = _train_state(torch, dev, preset=preset, overrides=overrides,
                              objective=objective)
    step = T.make_train_step(cfg, steps_per_epoch=100)
    launches = {k: 0 for k in K.LAUNCHES}
    losses = []
    for i in range(TRAIN_STEPS):
        K.reset_launches()
        state, metrics = step(state, batch)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        n = dict(K.LAUNCHES)
        log(f"{name}: B={b} {h}x{w} train step {i}: loss {loss:.6f}, grad norm "
            f"{norm:.6f}, launches {n}")
        if not (np.isfinite(loss) and np.isfinite(norm)):
            raise AssertionError(f"train step {i}: non-finite loss {loss} or grad norm {norm}")
        if n != expected:
            raise AssertionError(f"train step {i} launched {n}, expected {expected}")
        for k, c in n.items():
            launches[k] += c
        losses.append(loss)

    # kernels twice (K3's atomics and cuDNN reorder sums from run to run),
    # then the plain versions
    (loss_k, grads_k), (_, grads_k2), (loss_p, grads_p) = (
        _loss_and_grads(torch, dev, batch, plain, preset, overrides, objective)
        for plain in (False, False, True))

    spread, spread_key = _worst_leaf(grads_k2, grads_k)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    worst, worst_key = _worst_leaf(grads_k, grads_p)
    log(f"{name}: B={b} {h}x{w} train loss, kernels vs plain: {loss_k:.6f} vs {loss_p:.6f} "
        f"(relative {rel_loss:.2e}); worst gradient leaf {worst_key}: {worst:.2e} of its "
        f"largest entry (kernels vs kernels: {spread:.2e}, {spread_key})")
    if not rel_loss <= 1e-5:
        raise AssertionError(f"train loss through the kernels disagrees: {rel_loss}")
    if not worst <= GRAD_ENVELOPE:
        raise AssertionError(f"gradient leaf {worst_key} outside the envelope: {worst}")

    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, lambda: step(state, batch), reps=5, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, plain_state = _train_state(torch, dev, plain=True, preset=preset, overrides=overrides,
                                  objective=objective)
    step_plain_ms = time_ms(torch, lambda: step(plain_state, batch), reps=5, warmup=2)
    log(f"{name}: B={b} {h}x{w} train step: {step_ms:.3f} ms with the kernels "
        f"({b / step_ms * 1e3:.1f} samples/s, peak memory {peak_gb:.2f} GB), "
        f"{step_plain_ms:.3f} ms with their plain versions")
    return {
        "launches": launches, "losses": losses, "loss_rel_err": rel_loss,
        "worst_grad_leaf": [worst_key, worst], "run_to_run_grad_leaf": [spread_key, spread],
        "step_ms": step_ms,
        "step_plain_ms": step_plain_ms, "peak_memory_gb": peak_gb,
        "profile": profile(torch, lambda: step(state, batch),
                           f"{name} B={b} {h}x{w} train step"),
    }


def phase_scene_share(torch, dev):
    """The share of K4's, K5's and K3's tiles that staged on the
    synthetic scenes, recorded from the warp's kernel calls (the other
    tiles take the global path): the level-0 warps of the 480x640
    ``feature`` and ``feature_icp`` forwards and the level 0-2 warps of the
    480x640 U_FC forward, the level-0 warps of the 120x160 U_FC forward on
    the synthetic scene and on the served requests' random depth, then one
    loss and backward at 480x640, B=4 (K5 at levels 0-1, K3 at every level)
    and at 120x160, B=64 (K3)."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch
    from deep_prob_feature_track_torch.geometry import warp
    from deep_prob_feature_track_torch.ops.kernels.splat import splat_staged_share
    from deep_prob_feature_track_torch.ops.kernels.tiles import grads_staged_share, staged_share
    from deep_prob_feature_track_torch.training import train as T

    kernels = {k: getattr(warp, k) for k in ("gather_tiles", "gather_tiles_grads", "splat_twohot")}
    tile_share = {"gather_tiles": staged_share, "gather_tiles_grads": grads_staged_share}
    shares = {}
    scene = [""]

    def recorder(name):
        def call(x, v0, dv, u0, du, *hw):
            if hw:  # K3: the plane's H, W; x is the cotangent [B,C,N]
                size, share = hw, splat_staged_share(v0, u0, *hw, x.shape[1])
            else:  # K4 / K5: the sample grid
                size, share = tuple(v0.shape[1:]), tile_share[name](v0, u0, *x.shape[1:])
            shares.setdefault(f"{name} {scene[0]}", []).append((size, share))
            return kernels[name](x, v0, dv, u0, du, *hw)
        return call

    for name in kernels:
        setattr(warp, name, recorder(name))
    try:
        vga = T.synthetic_batch(B, H_VGA, W_VGA, seed=VGA_TRAIN_SEED, device=dev)
        small = T.synthetic_batch(B, H, W, seed=TRAIN_SEED, device=dev)
        served = example_batch(B, H, W, seed=1, device=dev)
        for preset, overrides, batch, what in (
                ("feature", (), vga, "synthetic"), ("feature_icp", (), vga, "synthetic"),
                ("feature", UFC, vga, "synthetic"), ("feature", UFC, small, "synthetic"),
                ("feature", UFC, dict(zip(KEYS, served)), "served")):
            h, w = batch["color0"].shape[-2:]
            scene[0] = f"B={B} {h}x{w} {config_name(preset, overrides)} forward ({what})"
            with torch.inference_mode():
                build_tracker(preset, device=dev, overrides=overrides)(*[batch[k] for k in KEYS])
        for b, h, w, seed in ((B_VGA_TRAIN, H_VGA, W_VGA, VGA_TRAIN_SEED), (B_TRAIN, H, W, TRAIN_SEED)):
            scene[0] = f"B={b} {h}x{w} feature loss and backward (synthetic)"
            cfg, state = _train_state(torch, dev)
            T.compute_loss(state.net, cfg, T.synthetic_batch(b, h, w, seed=seed, device=dev)).backward()
    finally:
        for name, fn in kernels.items():
            setattr(warp, name, fn)
    for key, calls in shares.items():
        log(f"{key}: staged share per call "
            + ", ".join(f"{h}x{w} {s:.4f}" for (h, w), s in calls))
    return {k: [s for _, s in v] for k, v in shares.items()}


def _grid(u, v, b, h, w):
    """grid_sample's normalised grid [b,1,h*w,2] of raw coordinates (u, v)."""
    import torch

    n = h * w
    return torch.stack([u.reshape(b, 1, n) * (2.0 / (w - 1)) - 1,
                        v.reshape(b, 1, n) * (2.0 / (h - 1)) - 1], dim=-1)


def grid_sample_timing(torch, F, uv):
    """Events and device time of ``grid_sample`` (bilinear, border,
    align_corners=True) of F [b,h,w,C] at the raw coordinates ``uv``: the
    library call that computes K1's and K4's function."""
    b, h, w, _ = F.shape
    grid = _grid(*uv, b, h, w)
    F_nchw = F.permute(0, 3, 1, 2).contiguous()

    def call():
        return torch.nn.functional.grid_sample(F_nchw, grid, mode="bilinear",
                                               padding_mode="border", align_corners=True)

    return {"library_ms": time_ms(torch, call, windows=5), "library_device_ms": device_ms(torch, call)}


def k1_timing(torch, F, args, uv, bw, flops):
    """K1's events and device time on F [b,h,w,C] at the corner maps
    ``args`` [b,n], beside its plain version, ``grid_sample`` at the same
    coordinates ``uv`` and the byte bound."""
    from deep_prob_feature_track_torch.ops import kernels as K

    b, h, w, c = F.shape
    n = h * w
    return {
        "ms": time_ms(torch, lambda: K.gather_twohot_cuda(F, *args), windows=5),
        "device_ms": device_ms(torch, lambda: K.gather_twohot_cuda(F, *args)),
        "plain_ms": time_ms(torch, lambda: K.gather_twohot_ref(F, *args)),
        **grid_sample_timing(torch, F, uv),
        **bound(4 * (F.numel() + 4 * b * n + b * c * n), b * n * (2 + 11 * c), bw, flops),
    }


def k3_timing(torch, g, args, uv, h, w, bw, flops):
    """K3's events and device time for the cotangent g [b,C,h*w] at the
    corner maps ``args``, beside its plain version, the library's operand
    cotangent of ``grid_sample`` (border, align_corners=True) at the same
    coordinates ``uv``, the byte bound and the share of staged tiles."""
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.ops.kernels.splat import splat_staged_share

    b, c, n = g.shape
    grid = _grid(*uv, b, h, w)
    F_nchw = torch.empty(b, c, h, w, device=g.device)  # only its shape is read
    g4 = g.reshape(b, c, 1, n)
    planes = b * n * c  # floats of the cotangent and of the plane
    return {
        "ms": time_ms(torch, lambda: K.splat_twohot_cuda(g, *args, h, w), windows=5),
        "device_ms": device_ms(torch, lambda: K.splat_twohot_cuda(g, *args, h, w)),
        "plain_ms": time_ms(torch, lambda: K.splat_twohot_ref(g, *args, h, w)),
        "library_ms": time_ms(torch, lambda: torch.ops.aten.grid_sampler_2d_backward(
            g4, F_nchw, grid, 0, 1, True, [True, False]), windows=5),
        **bound(4 * (2 * planes + 4 * b * n), b * n * (2 + 12 * c), bw, flops),
        "staged_share": splat_staged_share(args[0], args[2], h, w, c),
    }


def k6_timing(torch, args, bw, flops):
    """K6's events and device time on ``args`` (alpha, beta, res [b,C,n],
    u, v [b,n,6]) beside its plain version and the byte bound."""
    from deep_prob_feature_track_torch.ops import kernels as K

    b, c, n = args[0].shape
    return {
        "ms": time_ms(torch, lambda: K.fused_jtj_jtr_cuda(*args)),
        "device_ms": device_ms(torch, lambda: K.fused_jtj_jtr_cuda(*args)),
        "plain_ms": time_ms(torch, lambda: K.jtj_jtr_ref(*args)),
        "library_ms": None,  # no single PyTorch call returns JtJ and JtR
        **bound(4 * (3 * b * c * n + 2 * b * n * 6 + b * 42), b * n * (10 * c + 144), bw, flops),
    }


def k2_timing(torch, F, args, bw, flops):
    """K2's events and device time on F [b,h,w,C] at the corner maps
    ``args`` [b,n], beside its plain version and the byte bound."""
    from deep_prob_feature_track_torch.ops import kernels as K

    b, h, w, c = F.shape
    n = args[0].shape[1]
    planes = b * n * c  # floats of each [b,C,n] output
    return {
        "ms": time_ms(torch, lambda: K.gather_twohot_grads_cuda(F, *args)),
        "device_ms": device_ms(torch, lambda: K.gather_twohot_grads_cuda(F, *args)),
        "plain_ms": time_ms(torch, lambda: K.gather_twohot_grads_ref(F, *args)),
        "library_ms": None,  # no single PyTorch call returns the value and both maps
        **bound(4 * (F.numel() + 4 * b * n + 3 * planes), b * n * (2 + 17 * c), bw, flops),
    }


def flat_inputs(torch, dev, b, h, w, c, seed, coords):
    """F [b,h,w,c], the corner maps [b,h*w] and (u, v) of ``coords``:
    ``random`` (gather_inputs, C_WARP channels), ``smooth``, ``teleported``
    or ``offplane`` (tile_inputs)."""
    if coords == "random":
        args, uv = gather_inputs(torch, dev, h, w, seed, b=b)
        return args[0], list(args[1:]), uv
    F, maps, uv = tile_inputs(torch, dev, b, h, w, c, seed, coords)
    return F, [m.reshape(b, -1) for m in maps], uv


def phase_time(torch, dev, name):
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch

    bw, flops = peaks(name)
    net = build_tracker("feature", device=dev)
    plain = build_tracker("feature", device=dev, plain_kernels=True)
    batch = example_batch(B, H, W, seed=2, device=dev)
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: net(*batch), reps=20, warmup=3)
        fwd_plain_ms = time_ms(torch, lambda: plain(*batch), reps=20, warmup=3)
    log(f"B=8 120x160 forward: {fwd_ms:.3f} ms with the kernels, "
        f"{fwd_plain_ms:.3f} ms with their plain versions")

    levels = []
    for i, (h, w) in enumerate(LEVELS):
        n = h * w
        k1 = {}
        for coords in COORDS:
            F, args, uv = flat_inputs(torch, dev, B, h, w, C_WARP, i, coords)
            k1[coords] = k1_timing(torch, F, args, uv, bw, flops)
        k6 = k6_timing(torch, jtj_inputs(torch, dev, n, seed=10 + i), bw, flops)
        levels.append({"level": i, "hw": [h, w], "gather_twohot": k1["random"],
                       **{f"gather_twohot_{c}": k1[c] for c in COORDS[1:]},
                       "fused_jtj_jtr": k6})
        for coords, r in k1.items():
            log(f"level {i} {h}x{w} B={B}, {coords} coordinates: K1 {r['ms']:.4f} ms, device "
                f"{r['device_ms']:.4f} (plain {r['plain_ms']:.4f}, grid_sample "
                f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f})")
        log(f"level {i} {h}x{w}: K6 {k6['ms']:.4f} ms, device {k6['device_ms']:.4f} "
            f"(plain {k6['plain_ms']:.4f}, bound {k6['bound_ms']:.4f})")
    return {"forward_ms": fwd_ms, "forward_plain_ms": fwd_plain_ms, "levels": levels}


def phase_time_grads(torch, dev, name):
    """K2 and K3 at the B=64 levels on random, smooth, teleported and
    off-plane coordinates, and K3 at 480x640, B=4 level 0 on smooth ones."""
    bw, flops = peaks(name)
    levels = []
    for i, (h, w) in enumerate(LEVELS):
        args, (u, v) = gather_inputs(torch, dev, h, w, seed=20 + i, b=B_TRAIN)
        g = splat_cotangent(torch, dev, h, w, seed=30 + i)
        k2 = {"random": k2_timing(torch, args[0], args[1:], bw, flops)}
        k3 = {"random": k3_timing(torch, g, args[1:], (u, v), h, w, bw, flops)}
        for coords in COORDS[1:]:
            F, flat, uv = flat_inputs(torch, dev, B_TRAIN, h, w, C_WARP, 30 + i, coords)
            k2[coords] = k2_timing(torch, F, flat, bw, flops)
            k3[coords] = k3_timing(torch, g, flat, uv, h, w, bw, flops)
        levels.append({"level": i, "hw": [h, w], "gather_twohot_grads": k2["random"],
                       **{f"gather_twohot_grads_{c}": k2[c] for c in COORDS[1:]},
                       "splat_twohot": k3["random"],
                       **{f"splat_twohot_{c}": k3[c] for c in COORDS[1:]}})
        for coords, r in k2.items():
            log(f"level {i} {h}x{w} B={B_TRAIN}, {coords} coordinates: K2 {r['ms']:.4f} ms, "
                f"device {r['device_ms']:.4f} (plain {r['plain_ms']:.4f}, bound "
                f"{r['bound_ms']:.4f})")
        for coords, r in k3.items():
            log(f"level {i} {h}x{w} B={B_TRAIN}, {coords} coordinates: K3 {r['ms']:.4f} ms, "
                f"device {r['device_ms']:.4f} (plain {r['plain_ms']:.4f}, "
                f"grid_sampler_2d_backward {r['library_ms']:.4f}, bound {r['bound_ms']:.4f}, "
                f"staged share {r['staged_share']:.4f})")

    h, w = VGA_LEVELS[0]
    _, flat, uv = flat_inputs(torch, dev, B_VGA_TRAIN, h, w, C_WARP, 70, "smooth")
    g = torch.randn(B_VGA_TRAIN, C_WARP, h * w, generator=torch.Generator().manual_seed(71))
    vga = k3_timing(torch, g.to(dev), flat, uv, h, w, bw, flops)
    log(f"level 0 {h}x{w} B={B_VGA_TRAIN}, smooth coordinates: K3 {vga['ms']:.4f} ms, device "
        f"{vga['device_ms']:.4f} (plain {vga['plain_ms']:.4f}, grid_sampler_2d_backward "
        f"{vga['library_ms']:.4f}, bound {vga['bound_ms']:.4f}, staged share "
        f"{vga['staged_share']:.4f})")
    return levels, vga


def phase_time_jtj(torch, dev, name):
    """K6 at the B=64 training levels (120x160) and the B=8 480x640 levels,
    each checked against its plain version first."""
    bw, flops = peaks(name)
    rows = []
    for b, levels in ((B_TRAIN, LEVELS), (B, VGA_LEVELS)):
        for i, (h, w) in enumerate(levels):
            args = jtj_inputs(torch, dev, h * w, seed=100 + i, b=b)
            # at 307200 pixels the float32 plain version's own sums stray
            # past the limit from the float64 ones
            e = check_jtj(torch, args, f"level {i} [{b},{C_RES},{h * w}]",
                          plain32=h * w < H_VGA * W_VGA)
            r = {"b": b, "level": i, "hw": [h, w], "max_abs_err": e,
                 **k6_timing(torch, args, bw, flops)}
            rows.append(r)
            log(f"level {i} {h}x{w} B={b}: K6 {r['ms']:.4f} ms, device {r['device_ms']:.4f} "
                f"(plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f})")
    return rows


def tile_timing(torch, kname, F, maps, uv, bw, flops):
    """K4's (``kname="gather_tiles"``) or K5's events and device time on F
    [b,h,w,C] at the corner maps [b,h,w], beside its plain version, K1 /
    K2 on the same inputs, the byte bound and, for K4, ``grid_sample`` at
    the coordinates ``uv`` and the share of its tiles that staged."""
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.ops.kernels.tiles import staged_share

    b, h, w, c = F.shape
    n = h * w
    flat = [m.reshape(b, -1) for m in maps]
    planes = b * n * c  # floats of the operand plane and of each output
    if kname == "gather_tiles":
        kern, plain, full = K.gather_tiles_cuda, K.gather_tiles_ref, K.gather_twohot_cuda
        nbytes, nflops = 4 * (2 * planes + 4 * b * n), b * n * (2 + 11 * c)
        library = {**grid_sample_timing(torch, F, uv),
                   "staged_share": staged_share(maps[0], maps[2], h, w, c)}
    else:
        kern, plain = K.gather_tiles_grads_cuda, K.gather_tiles_grads_ref
        full = K.gather_twohot_grads_cuda
        nbytes, nflops = 4 * (4 * planes + 4 * b * n), b * n * (2 + 17 * c)
        library = {"library_ms": None}  # no single call returns the value and both maps
    return {
        "ms": time_ms(torch, lambda: kern(F, *maps)),
        "device_ms": device_ms(torch, lambda: kern(F, *maps)),
        "plain_ms": time_ms(torch, lambda: plain(F, *maps)),
        **library,
        **bound(nbytes, nflops, bw, flops),
        "full_plane_ms": time_ms(torch, lambda: full(F, *flat)),
        "full_plane_device_ms": device_ms(torch, lambda: full(F, *flat)),
    }


def phase_time_tiles(torch, dev, name):
    """K4 at 480x640 B=8 at each channel count it is checked at, and K5 at
    the 480x640 training shapes (C=10), on smooth coordinates, beside their
    plain versions, K1 / K2 on the same inputs (the same function over the
    whole plane) and, for K4, ``grid_sample`` (events and device time) and
    the share of its tiles that staged; K4 at C=6 and 10 also on the
    tracking-like coordinates of ``tile_inputs``, where most tiles take the
    global path."""
    bw, flops = peaks(name)
    levels = []
    for i, (kname, b, level) in enumerate(TILE_CASES):
        h, w = VGA_LEVELS[level]
        cases = ([(c, "smooth") for c in TILE_CHANNELS[kname]]
                 + [(c, "tracking") for c in (6, C_WARP)] if kname == "gather_tiles"
                 else [(C_WARP, "smooth")])
        for c, coords in cases:
            F, maps, uv = tile_inputs(torch, dev, b, h, w, c, seed=60 + i, coords=coords)
            row = tile_timing(torch, kname, F, maps, uv, bw, flops)
            levels.append({"kernel": kname, "level": level, "b": b, "c": c, "hw": [h, w],
                           "coords": coords, **row})
            lib = ("grid_sample -" if row["library_ms"] is None else
                   f"grid_sample {row['library_ms']:.4f}, device {row['library_device_ms']:.4f}, "
                   f"staged share {row['staged_share']:.4f}")
            log(f"{kname} level {level} B={b} {h}x{w} C={c}, {coords} coordinates: "
                f"{row['ms']:.4f} ms, device "
                f"{row['device_ms']:.4f} (plain {row['plain_ms']:.4f}, "
                f"{'K1' if kname == 'gather_tiles' else 'K2'} on the same inputs "
                f"{row['full_plane_ms']:.4f}, device {row['full_plane_device_ms']:.4f}, {lib}, "
                f"bound {row['bound_ms']:.4f})")
    return levels


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``reps`` calls of ``fn`` (host-only work)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def host_tier_build():
    """The port's native host tier built on this machine (phase 27): the
    host compiler's version, the seconds of the build and load, and whether
    the compiler finds libpng's, zlib's and libjpeg's headers (printed only:
    the tier needs none of them)."""
    from deep_prob_feature_track_torch.data import native_io
    from deep_prob_feature_track_torch.ops.kernels import loader

    cxx = loader.host_cxx()
    version = subprocess.run([*cxx, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()[0]
    cached = loader.host_target(native_io.SOURCE, native_io.BUILD_DIR).exists()
    t0 = time.monotonic()
    native_io.library()
    build_s = time.monotonic() - t0
    headers = {h: subprocess.run([*cxx, "-E", "-x", "c++", "-"], input=f"#include <{h}>\n",
                                 capture_output=True, text=True, timeout=60).returncode == 0
               for h in ("png.h", "zlib.h", "jpeglib.h")}
    log(f"host tier: {' '.join(cxx)} ({version}); built and loaded in {build_s:.2f} s"
        f"{' (a library was there already)' if cached else ''}; headers found: "
        + ", ".join(f"{h} {'yes' if ok else 'no'}" for h, ok in headers.items()))
    return {"cxx": version, "build_s": build_s, "cached": cached, "headers": headers}


def same_bits(label, native, plain):
    """Raise unless the arrays ``native`` and ``plain`` hold the same
    dtype, shape and bytes."""
    if native.dtype != plain.dtype or native.shape != plain.shape or \
            native.tobytes() != plain.tobytes():
        raise AssertionError(f"{label}: the native tier's output differs from the numpy twin's")


def native_and_plain_ms(fn, reps: int = 5) -> dict:
    """Host ms of ``fn(plain=False)`` (median of ``reps``) and of
    ``fn(plain=True)`` (median of 3)."""
    return {"native": host_ms(lambda: fn(plain=False), reps),
            "plain": host_ms(lambda: fn(plain=True), 3)}


def phase_tum_sequence(workdir):
    """Phase 27: the TUM-format sequence the CLI phases read; the native
    host tier's build; every written frame read through the native tier and
    through the numpy twins, bit for bit; the decode times of both for a
    Sub, Paeth, Average and mixed-filter 640x480 frame and a depth map."""
    from deep_prob_feature_track_torch.data import io as dio
    from deep_prob_feature_track_torch.data.png import read_png

    host = host_tier_build()
    seq = os.path.join(workdir, "seq")
    t0 = time.monotonic()
    write_tum_sequence(seq)
    log(f"wrote a {TUM_FRAMES}-frame 640x480 TUM-format sequence in "
        f"{time.monotonic() - t0:.1f} s")
    rgbs = [os.path.join(seq, "rgb", f) for f in sorted(os.listdir(os.path.join(seq, "rgb")))]
    depths = [p.replace(os.sep + "rgb" + os.sep, os.sep + "depth" + os.sep) for p in rgbs]
    frames = {"sub": rgbs[0]}
    for name, filt in (("paeth", 4), ("average", 3), ("mixed", np.arange(480) % 5)):
        frames[name] = os.path.join(workdir, f"{name}.png")
        write_png(frames[name], read_png(rgbs[0]), filter_type=filt)
        if not (read_png(frames[name]) == read_png(rgbs[0])).all():
            raise AssertionError(f"the {name} frame does not decode to the Sub frame's pixels")
    t0 = time.monotonic()
    for path in rgbs + list(frames.values())[1:]:
        same_bits(path, read_png(path), read_png(path, plain=True))
        for scale in (CLI_SMALL, CLI_VGA):
            same_bits(f"{path} at {scale}", dio.read_rgb(path, scale),
                      dio.read_rgb(path, scale, plain=True))
    for path in depths:
        same_bits(path, read_png(path), read_png(path, plain=True))
        for scale in (CLI_SMALL, CLI_VGA):
            same_bits(f"{path} at {scale}", dio.read_depth_png(path, 5000.0, scale),
                      dio.read_depth_png(path, 5000.0, scale, plain=True))
    log(f"native against plain: {len(rgbs) + 3} RGB frames (Sub, Paeth, Average, mixed) and "
        f"{len(depths)} depth maps bit for bit, read_png and at {CLI_SMALL} and {CLI_VGA}, in "
        f"{time.monotonic() - t0:.1f} s")
    decode = {f"{name}_rgb8": native_and_plain_ms(lambda plain, p=path: read_png(p, plain=plain))
              for name, path in frames.items()}
    decode["sub_depth16"] = native_and_plain_ms(lambda plain: read_png(depths[0], plain=plain))
    for name in ("sub", "paeth"):
        for scale in (CLI_SMALL, CLI_VGA):
            decode[f"read_rgb_{name}_{scale}"] = native_and_plain_ms(
                lambda plain, p=frames[name], s=scale: dio.read_rgb(p, s, plain=plain))
    decode[f"read_depth_png_{CLI_SMALL}"] = native_and_plain_ms(
        lambda plain: dio.read_depth_png(depths[0], 5000.0, CLI_SMALL, plain=plain))
    log("PNG decode of one 640x480 frame, ms native / plain (median of 5 / 3): "
        + ", ".join(f"{k} {v['native']:.2f} / {v['plain']:.2f}" for k, v in decode.items()))
    return seq, {"host_tier": host, **decode}


class _CliProbe:
    """Wraps, for one CLI run, the port's loader iteration (time spent
    waiting for each batch), ``evaluate_two_view`` (its loop time, batches
    and frames) and ``make_train_step`` (each step's device-synchronised
    time, loss and launch counts)."""

    def __init__(self, torch):
        from deep_prob_feature_track_torch import evaluation
        from deep_prob_feature_track_torch.data import pipeline
        from deep_prob_feature_track_torch.ops import kernels as K
        from deep_prob_feature_track_torch.training import train

        self.torch, self.K = torch, K
        self.wait_s = self.loop_s = 0.0
        self.batches = self.frames = 0
        self.steps = []
        targets = ((pipeline.BatchLoader, "__iter__"), (evaluation, "evaluate_two_view"),
                   (train, "make_train_step"))
        self._saved = [(obj, name, getattr(obj, name)) for obj, name in targets]
        batches_iter, evaluate, make_step = (fn for _, _, fn in self._saved)
        probe = self

        def timed_iter(loader):
            it = batches_iter(loader)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                finally:
                    probe.wait_s += time.perf_counter() - t0
                yield batch

        def timed_evaluate(loader, *a, **kw):
            t0 = time.perf_counter()
            info = evaluate(loader, *a, **kw)
            probe.loop_s += time.perf_counter() - t0
            probe.batches += len(loader)
            probe.frames += len(info["names"])
            return info

        def counted_make_step(*a, **kw):
            step = make_step(*a, **kw)

            def counted_step(state, batch):
                torch.cuda.synchronize()
                K.reset_launches()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                loss = metrics["loss"].item()
                torch.cuda.synchronize()
                probe.steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                                    "launches": dict(K.LAUNCHES)})
                return state, metrics

            return counted_step

        for (obj, name, _), fn in zip(self._saved, (timed_iter, timed_evaluate,
                                                    counted_make_step)):
            setattr(obj, name, fn)

    def restore(self):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def _cli_poses(seq, size, finite=True):
    """The per-frame poses of the evaluate CLI's dumps, by loader; with
    ``finite`` every metric must be finite."""
    import pickle

    out = {}
    for kf in CLI_KEYFRAMES:
        with open(f"{seq}_keyframe_{kf}.pkl", "rb") as fh:
            info = pickle.load(fh)
        for key in ("epes", "angular_error", "translation_error"):
            if finite and not np.isfinite(info[key]).all():
                raise AssertionError(f"{size}: non-finite {key} in the CLI's dump")
        out[kf] = info
    return out


def phase_cli_eval(torch, dev, seq, workdir, scale, expected, checkpoint=""):
    """Phase 28: ``apps.evaluate.main`` on the sequence at ``scale``, B=8,
    keyframes 1 and 2: launches ``expected`` per batch; the CLI's poses
    against ``evaluate_two_view`` through the plain kernels on the card
    (and, at 120x160 without a checkpoint, the first loader on the CPU);
    frames/s of the CLI's loop and its share spent waiting on the loader."""
    from deep_prob_feature_track_torch import evaluation
    from deep_prob_feature_track_torch.apps import evaluate
    from deep_prob_feature_track_torch.apps.serve import build_tracker

    out_dir = os.path.join(workdir, f"eval_{scale}")
    args = ["--data_root", "", "--trajectory", seq, "--keyframes",
            ",".join(map(str, CLI_KEYFRAMES)), "--batch_size", str(B), "--image_resize",
            str(scale), "--output_dir", out_dir, "--device", str(dev)]
    if checkpoint:
        args += ["--checkpoint", checkpoint]
    probe = _CliProbe(torch)
    try:
        probe.K.reset_launches()
        t0 = time.monotonic()
        if evaluate.main(args) != 0:
            raise AssertionError("the evaluate CLI failed")
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = dict(probe.K.LAUNCHES)
    finally:
        probe.restore()
    size = f"evaluate CLI {scale}"
    want = {k: n * probe.batches for k, n in expected.items()}
    log(f"{size}: {probe.frames} frames in {probe.batches} batches, launches {launches}")
    if launches != want:
        raise AssertionError(f"{size} launched {launches}, expected {want}")
    name = os.path.splitext(os.path.basename(checkpoint))[0] if checkpoint else \
        "nolearning_feature"
    with open(os.path.join(out_dir, name, "summary.csv")) as fh:
        if "mean values of trajectories keyframe 1," not in fh.read():
            raise AssertionError(f"{size}: summary.csv lacks the keyframe 1 mean row")
    poses = _cli_poses(seq, size)
    result = {"frames": probe.frames, "batches": probe.batches, "launches": launches,
              "wall_s": wall, "loop_s": probe.loop_s, "fps": probe.frames / probe.loop_s,
              "loader_wait_share": probe.wait_s / probe.loop_s,
              "epe3d_cm": {kf: float(p["epes"].mean() * 100) for kf, p in poses.items()}}
    loaders = evaluation.create_eval_loaders("TUM_RGBD", "test", CLI_KEYFRAMES, B,
                                             trajectory=seq, image_resize=scale, root="")
    plain = build_tracker("feature", checkpoint, dev, plain_kernels=True)
    checks = [("plain", plain, dev, list(loaders.items()))]
    if scale == CLI_SMALL and not checkpoint:
        checks.append(("cpu", build_tracker("feature", checkpoint, "cpu"), torch.device("cpu"),
                       list(loaders.items())[:1]))
    for other, net, device, items in checks:
        for key, loader in items:
            ref = evaluation.evaluate_two_view(loader, net, device)
            got = poses[int(key.rsplit("_", 1)[1])]
            dR = float(np.abs(got["R_est"] - ref["R_est"]).max())
            dt = float(np.abs(got["t_est"] - ref["t_est"]).max())
            log(f"{size} {key.rsplit('/', 1)[1]}: CLI against {other}: max|dR| {dR:.3e}, "
                f"max|dt| {dt:.3e}")
            if not (dR <= 1e-4 and dt <= 1e-4):
                raise AssertionError(f"{size}: the CLI's poses disagree with the {other} ones")
            result[f"vs_{other}"] = max(result.get(f"vs_{other}", 0.0), dR, dt)
    log(f"{size}: {result['fps']:.1f} frames/s over the CLI's loop ({probe.loop_s:.2f} s), "
        f"{result['loader_wait_share']:.3f} of it waiting on the loader; {wall:.2f} s in all")
    return result


def phase_cli_train(torch, dev, seq, workdir):
    """Phase 29: ``apps.train.main`` on a data root whose 36 training
    sequences are links to the sequence: 2 steps at 120x160 B=64 and 1 at
    640x480 B=4, launches per step pinned; a resume for one more step from
    the checkpoint (the step goes on, the optimizer state comes back); the
    evaluate CLI on the resumed checkpoint; ms per step and the loader's ms
    per batch of 64 pairs."""
    from deep_prob_feature_track_torch.apps import train
    from deep_prob_feature_track_torch.data.loader import load_data
    from deep_prob_feature_track_torch.data.pipeline import BatchLoader
    from deep_prob_feature_track_torch.data.tum_dicts import TUM_TRAINVAL
    from deep_prob_feature_track_torch.training import checkpoints

    root = os.path.join(workdir, "trainval")
    os.makedirs(root)
    for name in (n for names in TUM_TRAINVAL.values() for n in names):
        os.symlink(seq, os.path.join(root, name))
    logs = os.path.join(workdir, "logs")
    kf = ",".join(map(str, CLI_KEYFRAMES))

    def run(size, batch, steps, expected, *extra):
        args = ["--data_root", root, "--keyframes", kf, "--batch_size", str(batch),
                "--image_resize", str(size), "--max_steps_per_epoch", str(steps), "--no_val",
                "--checkpoint_folder", logs, "--device", str(dev), *extra]
        probe = _CliProbe(torch)
        try:
            t0 = time.monotonic()
            if train.main(args) != 0:
                raise AssertionError("the train CLI failed")
            wall = time.monotonic() - t0
        finally:
            probe.restore()
        label = f"train CLI {size} B={batch}"
        for i, st in enumerate(probe.steps):
            log(f"{label} step {i}: loss {st['loss']:.6f}, {st['ms']:.1f} ms, "
                f"launches {st['launches']}")
            if not np.isfinite(st["loss"]):
                raise AssertionError(f"{label}: non-finite loss")
            if st["launches"] != expected:
                raise AssertionError(f"{label} step {i} launched {st['launches']}, "
                                     f"expected {expected}")
        (logdir,) = [os.path.join(logs, d) for d in os.listdir(logs)
                     if d.endswith(f"_batch_{batch}")]
        step_s = sum(st["ms"] for st in probe.steps) / 1e3
        share = probe.wait_s / (probe.wait_s + step_s)
        log(f"{label}: {probe.wait_s:.2f} s waiting on the loader against {step_s:.2f} s of "
            f"steps: loader-wait share {share:.3f}")
        return {"steps": probe.steps, "wall_s": wall, "loader_wait_s": probe.wait_s,
                "loader_wait_share": share, "step_ms": [st["ms"] for st in probe.steps]}, logdir

    out = {}
    out["small"], logdir = run(CLI_SMALL, B_TRAIN, 2, TRAIN_LAUNCHES, "--epochs", "1")
    first = os.path.join(logdir, "checkpoint_epoch1.pt")
    saved = checkpoints.restore_variables(first)
    if saved["step"] != 2:
        raise AssertionError(f"the final checkpoint holds step {saved['step']}, expected 2")
    # one-step epochs put step 2 at epoch 2: one more step, to step 3
    out["resume"], _ = run(CLI_SMALL, B_TRAIN, 1, TRAIN_LAUNCHES, "--epochs", "3",
                           "--checkpoint", first)
    loaded = checkpoints.restore_variables(os.path.join(logdir, "checkpoint_epoch2.pt"))
    resumed = checkpoints.restore_variables(os.path.join(logdir, "checkpoint_epoch3.pt"))
    same = loaded["step"] == 2 and all(
        torch.equal(a, b) for a, b in zip(saved["net"].values(), loaded["net"].values()))
    for i, st in saved["optimizer"]["state"].items():
        same = same and all(torch.equal(v, loaded["optimizer"]["state"][i][k])
                            for k, v in st.items())
    if not same or resumed["step"] != 3:
        raise AssertionError("the resumed run did not restore the training state")
    if resumed["optimizer"]["state"][0]["step"].item() != \
            saved["optimizer"]["state"][0]["step"].item() + 1:
        raise AssertionError("the resumed optimizer did not go on from its saved state")
    log("train CLI: resumed from step 2 with the saved weights and optimizer state, "
        "saved step 3")
    out["vga"], _ = run(CLI_VGA, B_VGA_TRAIN, 1, VGA_TRAIN_LAUNCHES, "--epochs", "1")
    out["eval_resumed"] = phase_cli_eval(torch, dev, seq, workdir, CLI_SMALL, SERVE_LAUNCHES,
                                         os.path.join(logdir, "checkpoint_epoch3.pt"))
    # the loader alone, on this thread: 2 batches of 64 pairs at 120x160
    data = load_data("TUM_RGBD", CLI_KEYFRAMES, "train", image_resize=CLI_SMALL, root=root,
                     augment_seed=1)
    it = iter(BatchLoader(data, B_TRAIN, shuffle=True, seed=1, drop_last=True, prefetch=0))
    per_batch = []
    for _ in range(2):
        t0 = time.perf_counter()
        next(it)
        per_batch.append((time.perf_counter() - t0) * 1e3)
    out["loader_ms_per_batch_64"] = per_batch
    log(f"train CLI: steps {out['small']['step_ms']} ms at --image_resize {CLI_SMALL} "
        f"B={B_TRAIN}, {out['vga']['step_ms']} ms at {CLI_VGA} B={B_VGA_TRAIN}; the loader "
        f"alone {', '.join(f'{x:.0f}' for x in per_batch)} ms a batch of {B_TRAIN} pairs")
    return out


def _finite_gap(got, ref, what):
    """``max |got - ref|`` over the finite entries; raises unless the two
    are non-finite in the same places."""
    bad = ~np.isfinite(got)
    if not np.array_equal(bad, ~np.isfinite(ref)):
        raise AssertionError(f"{what}: non-finite in other places than the plain ones")
    return float(np.abs(got[~bad] - ref[~bad]).max(initial=0.0))


def baseline_float64_check(torch, dev, seq, name):
    """The first 640x480 batch of ``name`` through the plain kernels: in
    float32 on the card, and in float64 on the card and on the CPU.  The
    float64 poses must be finite on both devices and within
    ``ICP_F64_ATOL`` of each other; a float32 sample that is NaN on the
    card (the guard lets a failed Cholesky solve through) is then one whose
    damped float32 system rounds to indefinite, not a fault of the path."""
    from deep_prob_feature_track_torch import evaluation
    from deep_prob_feature_track_torch.apps.baselines import make_baseline

    loader, = evaluation.create_eval_loaders("TUM_RGBD", "test", CLI_KEYFRAMES[:1], B,
                                             trajectory=seq, image_resize=CLI_VGA,
                                             root="").values()
    batch = next(iter(loader))
    tracker = make_baseline(name, plain=True)

    def run(device, dtype):
        args = [torch.from_numpy(np.asarray(batch[k])).to(device, dtype)
                for k in ("color0", "depth0", "color1", "depth1", "calib")]
        with torch.inference_mode():
            R, t = tracker.batch_track(*args)
        return np.concatenate([R.reshape(-1, 9).double().cpu().numpy(),
                               t.double().cpu().numpy()], axis=1)

    card32 = run(dev, torch.float32)
    card64, cpu64 = run(dev, torch.float64), run(torch.device("cpu"), torch.float64)
    if not (np.isfinite(card64).all() and np.isfinite(cpu64).all()):
        raise AssertionError(f"{name} {CLI_VGA}: a float64 pose is not finite")
    gap64 = float(np.abs(card64 - cpu64).max())
    nan32 = ~np.isfinite(card32).all(axis=1)
    gap32 = float(np.abs(card32[~nan32] - card64[~nan32]).max(initial=0.0))
    log(f"{name} {CLI_VGA} first batch: float64 card against CPU {gap64:.3e} (limit "
        f"{ICP_F64_ATOL:g}); float32 on the card NaN for samples "
        f"{np.flatnonzero(nan32).tolist()} of {len(nan32)}, the others {gap32:.3e} from "
        "float64")
    if not gap64 <= ICP_F64_ATOL:
        raise AssertionError(f"{name} {CLI_VGA}: float64 card and CPU poses {gap64:.3e} apart")
    return {"f64_card_vs_cpu": gap64, "f32_nan_samples": int(nan32.sum()),
            "f32_vs_f64_finite": gap32}


def phase_cli_baselines(torch, dev, seq, workdir):
    """Phase 31: ``apps.evaluate.main --tracker`` for the six baselines at
    120x160 and ``ICP`` and ``RGBD`` at 640x480, B=8, keyframes 1 and 2:
    launches per batch pinned; the CLI's per-frame poses against the same
    baseline through the plain kernels on the card, within 1e-4 and NaN in
    the same frames (the guard lets a failed solve through, as the JAX
    package's does), with the NaN frames counted; at 640x480 ``ICP`` the
    first batch in float64 on the card against the CPU
    (:func:`baseline_float64_check`); frames/s of the CLI's loop and its
    share spent waiting on the loader."""
    from deep_prob_feature_track_torch import evaluation
    from deep_prob_feature_track_torch.apps import evaluate
    from deep_prob_feature_track_torch.apps.baselines import make_baseline

    out = {}
    for scale, table in ((CLI_SMALL, BASELINE_LAUNCHES), (CLI_VGA, BASELINE_VGA_LAUNCHES)):
        for name, expected in table.items():
            size = f"evaluate CLI --tracker {name} {scale}"
            args = ["--data_root", "", "--trajectory", seq, "--keyframes",
                    ",".join(map(str, CLI_KEYFRAMES)), "--batch_size", str(B), "--image_resize",
                    str(scale), "--tracker", name, "--output_dir",
                    os.path.join(workdir, f"eval_{name}_{scale}"), "--device", str(dev)]
            probe = _CliProbe(torch)
            try:
                probe.K.reset_launches()
                if evaluate.main(args) != 0:
                    raise AssertionError(f"{size} failed")
                torch.cuda.synchronize()
                launches = dict(probe.K.LAUNCHES)
            finally:
                probe.restore()
            want = {k: n * probe.batches for k, n in expected.items()}
            if launches != want:
                raise AssertionError(f"{size} launched {launches}, expected {want}")
            poses = _cli_poses(seq, size, finite=False)
            plain = make_baseline(name, plain=True)
            gap = 0.0
            for key, loader in evaluation.create_eval_loaders(
                    "TUM_RGBD", "test", CLI_KEYFRAMES, B, trajectory=seq, image_resize=scale,
                    root="").items():
                ref = evaluation.evaluate_two_view(
                    loader, lambda c0, c1, d0, d1, K: plain.batch_track(c0, d0, c1, d1, K), dev)
                got = poses[int(key.rsplit("_", 1)[1])]
                gap = max(gap, _finite_gap(got["R_est"], ref["R_est"], size),
                          _finite_gap(got["t_est"], ref["t_est"], size))
            if not gap <= 1e-4:
                raise AssertionError(f"{size}: the CLI's poses are {gap:.3e} from the plain ones")
            nonfinite = sum(int((~np.isfinite(p["t_est"]).all(axis=1)).sum())
                            for p in poses.values())
            row = {"frames": probe.frames, "batches": probe.batches, "launches": launches,
                   "launches_per_batch": expected, "fps": probe.frames / probe.loop_s,
                   "loader_wait_share": probe.wait_s / probe.loop_s, "vs_plain": gap,
                   "nonfinite_frames": nonfinite,
                   "epe3d_cm_finite": {kf: float(np.nanmean(p["epes"]) * 100)
                                       for kf, p in poses.items()}}
            log(f"{size}: {row['fps']:.1f} frames/s over the CLI's loop, "
                f"{row['loader_wait_share']:.3f} of it waiting on the loader; launches "
                f"{launches} in {probe.batches} batches; CLI against plain {gap:.3e}; "
                f"non-finite poses in {nonfinite} of {probe.frames} frames; EPE3D of the "
                "finite ones " + ", ".join(f"kf {kf} {v:.3f} cm"
                                           for kf, v in row["epe3d_cm_finite"].items()))
            if scale == CLI_VGA and name == "ICP":
                row.update(baseline_float64_check(torch, dev, seq, name))
            out[f"{name} {scale}"] = row
    return out


def phase_kf_vo(torch, dev, seq, workdir):
    """Phase 32: ``apps.kf_vo.main`` with ``feature`` in keyframe mode at
    120x160 (K1 and K6 12 times a frame); its trajectory against
    ``run_vo`` through the plain kernels (within 1e-4); ``--gt_tracker``
    against the written ground truth (1e-5); ``apps.traj_eval`` of the
    written trajectory against ``groundtruth.txt``; frames/s of the VO
    loop at B=1 and the synchronised time of one B=1 forward."""
    from deep_prob_feature_track_torch.apps import kf_vo, traj_eval
    from deep_prob_feature_track_torch.apps.serve import build_tracker
    from deep_prob_feature_track_torch.data.loader import load_data
    from deep_prob_feature_track_torch.ops import kernels as K

    frames = TUM_FRAMES - 1
    base = ["--data_root", "", "--trajectory", seq, "--image_resize", str(CLI_SMALL),
            "--vo_type", "keyframe", "--device", str(dev)]
    est = os.path.join(workdir, "vo.txt")
    kf_vo.main(base + ["--output", os.path.join(workdir, "warm.txt")])  # build, cuDNN choice
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    if kf_vo.main(base + ["--output", est]) != 0:
        raise AssertionError("the kf_vo CLI failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    want = {k: n * frames for k, n in SERVE_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"kf_vo launched {launches}, expected {want}")
    _, T_est = traj_eval.load_tum_trajectory(est)
    dataset = load_data("TUM_RGBD", [1], "test", select_traj=seq, image_resize=CLI_SMALL,
                        root="")
    plain, _ = kf_vo.run_vo(dataset, build_tracker("feature", "", dev, plain_kernels=True),
                            vo_type="keyframe", device=dev)
    gap = float(np.abs(T_est - plain).max())
    gt_file = os.path.join(workdir, "vo_gt.txt")
    if kf_vo.main(base + ["--gt_tracker", "--output", gt_file]) != 0:
        raise AssertionError("kf_vo --gt_tracker failed")
    _, T_vo_gt = traj_eval.load_tum_trajectory(gt_file)
    # the sequence's first camera is the world frame
    stamps, T_gt = traj_eval.load_tum_trajectory(os.path.join(seq, "groundtruth.txt"))
    gt_gap = float(np.abs(T_vo_gt - T_gt).max())
    # the written trajectory's stamps are frame indices: give it the frames'
    timed = os.path.join(workdir, "vo_timed.txt")
    kf_vo.write_tum_trajectory(timed, T_est, timestamps=stamps)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        traj_eval.main(["--est", timed, "--gt", os.path.join(seq, "groundtruth.txt")])
    te = json.loads(buf.getvalue().strip().splitlines()[-1])
    net = build_tracker("feature", "", dev)
    item = dataset.pair_frames(0, 1)
    one = [torch.from_numpy(np.asarray(item[k])[None]).to(dev) for k in KEYS]
    with torch.inference_mode():
        forward_ms = time_ms(torch, lambda: net(*one), reps=20, warmup=3, windows=3)
        prof = profile(torch, lambda: net(*one), "B=1 120x160 kf_vo forward")
    out = {"frames": frames, "wall_s": wall, "fps": frames / wall, "launches": launches,
           "launches_per_frame": {k: v // frames for k, v in launches.items() if v},
           "vs_plain": gap, "gt_tracker_vs_groundtruth": gt_gap, "traj_eval": te,
           "forward_ms_b1": forward_ms, "profile_b1": prof}
    log(f"kf_vo feature keyframe 120x160: {frames} frames in {wall:.2f} s ({out['fps']:.1f} "
        f"frames/s, decode included), launches {out['launches_per_frame']} a frame; one B=1 "
        f"forward {forward_ms:.3f} ms; trajectory against plain {gap:.3e}; --gt_tracker "
        f"against the ground truth {gt_gap:.3e}; traj_eval {te}")
    if not (gap <= 1e-4 and gt_gap <= 1e-5):
        raise AssertionError("kf_vo: the trajectory disagrees with the plain or the GT one")
    if te["pairs"] != TUM_FRAMES or not np.isfinite(te["ate_rmse_m"]):
        raise AssertionError(f"traj_eval associated {te['pairs']} poses")
    return out


def phase_basin(torch, dev, seq, workdir):
    """Phase 33: ``apps.convergence_basin.main`` 2D 31x31 for ``feature`` at
    120x160: one K1 a chunk of 64 poses and level; its costs against
    ``evaluate_basin`` through the plain kernels; the wall time; whether
    matplotlib imports here, and the plots if it does."""
    import importlib.util
    import pickle

    from deep_prob_feature_track_torch.apps import convergence_basin as cb
    from deep_prob_feature_track_torch.apps.serve import build_tracker
    from deep_prob_feature_track_torch.data.loader import load_data
    from deep_prob_feature_track_torch.ops import kernels as K

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    log(f"matplotlib {'is' if has_mpl else 'is not'} importable on this machine")
    out_pkl = os.path.join(workdir, "cb.pkl")
    args = ["--data_root", "", "--trajectory", seq, "--image_resize", str(CLI_SMALL),
            "--pert_samples", str(BASIN_SAMPLES), "--output", out_pkl, "--device", str(dev)]
    cb.main(args)  # build, cuDNN choice
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    if cb.main(args + (["--save_img"] if has_mpl else [])) != 0:
        raise AssertionError("the convergence_basin CLI failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    chunks = -(-BASIN_SAMPLES ** 2 // BASIN_CHUNK)
    want = counts(gather_twohot=chunks * 4)
    if launches != want:
        raise AssertionError(f"convergence_basin launched {launches}, expected {want}")
    with open(out_pkl, "rb") as fh:
        costs = pickle.load(fh)["costs"]
    item = load_data("TUM_RGBD", [1], "test", select_traj=seq, image_resize=CLI_SMALL,
                     root="")[0]
    T = item["transform"]
    poses, _ = cb.perturbation_poses_2d(T[:3, :3], T[:3, 3], cb.PERT_RANGE_BY_KF[1],
                                        BASIN_SAMPLES)
    ref = cb.evaluate_basin(build_tracker("feature", "", dev, plain_kernels=True), item, poses,
                            device=dev)
    gap = float(np.abs(costs - ref).max() / np.abs(ref).max())
    plots = os.path.isfile(out_pkl.replace(".pkl", "_2d.png"))
    out = {"shape": list(costs.shape), "wall_s": wall, "launches": launches,
           "vs_plain_rel": gap, "matplotlib": has_mpl, "plots_written": plots,
           "min_cost_per_level": costs.reshape(4, -1).min(axis=1).tolist()}
    log(f"convergence_basin 2D {BASIN_SAMPLES}x{BASIN_SAMPLES} feature 120x160: costs "
        f"{costs.shape} in {wall:.2f} s (plots {'written' if plots else 'not asked'}), "
        f"launches {launches}; against plain {gap:.3e} of the largest cost")
    if not (gap <= 1e-5 and np.isfinite(costs).all() and plots == has_mpl):
        raise AssertionError("convergence_basin: costs disagree with the plain ones")
    return out


def phase_import(torch, dev, workdir):
    """Phase 34: a checkpoint in the original implementation's format
    (``module.`` prefixes, ``num_batches_tracked``), written from a seeded
    ``feature`` tracker, imported by ``apps.import_checkpoint`` and served
    through ``apps/serve.py``: the served pose equals the source
    tracker's forward bit for bit."""
    from deep_prob_feature_track_torch.apps import import_checkpoint
    from deep_prob_feature_track_torch.apps.serve import build_service, build_tracker

    source = build_tracker("feature", "", dev, seed=11)
    src = os.path.join(workdir, "ref.pth.tar")
    torch.save({"epoch": 29, "state_dict": {f"module.{k}": v.cpu()
                                            for k, v in source.state_dict().items()}}, src)
    imported = os.path.join(workdir, "imported.pt")
    if import_checkpoint.main(["--torch_checkpoint", src, "--output", imported,
                               "--strict"]) != 0:
        raise AssertionError("import_checkpoint failed")
    service = build_service("feature", imported, max_batch=B, device=dev)
    try:
        item = request_items(1, H, W)[0]
        served = service.submit(item)
    finally:
        service.stop()
    # the service pads the batch with copies of its last request
    batch = [torch.from_numpy(np.stack([item[k]] * B)).to(dev) for k in KEYS]
    with torch.inference_mode():
        R, t = source(*batch)
    same = np.array_equal(served["R"], R[0].cpu().numpy()) and np.array_equal(
        served["t"], t[0].cpu().numpy())
    log(f"import_checkpoint: served pose of the imported weights "
        f"{'equals' if same else 'differs from'} the source tracker's bit for bit")
    if not same:
        raise AssertionError("the imported tracker's pose differs from the source's")
    return {"bit_exact": same}


def phase_cli(torch, dev):
    """Phases 27-29 and 31-34 in a temporary directory, removed after."""
    import shutil

    workdir = tempfile.mkdtemp(prefix="dpft_cli_")
    try:
        seq, decode = phase_tum_sequence(workdir)
        cli_eval = {str(s): phase_cli_eval(torch, dev, seq, workdir, s, expected)
                    for s, expected in ((CLI_SMALL, SERVE_LAUNCHES),
                                        (CLI_VGA, VGA_SERVE_LAUNCHES))}
        cli_train = phase_cli_train(torch, dev, seq, workdir)
        log("loader-wait shares: evaluate CLI (phase 28) "
            + ", ".join(f"{s} {r['loader_wait_share']:.3f}" for s, r in cli_eval.items())
            + "; train CLI (phase 29) " + ", ".join(
                f"{k} {cli_train[k]['loader_wait_share']:.3f}" for k in ("small", "resume", "vga")))
        apps = {"cli_baselines": phase_cli_baselines(torch, dev, seq, workdir),
                "kf_vo": phase_kf_vo(torch, dev, seq, workdir),
                "convergence_basin": phase_basin(torch, dev, seq, workdir),
                "import_checkpoint": phase_import(torch, dev, workdir)}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"cli_eval": cli_eval, "cli_train": cli_train, "png_decode_ms": decode, **apps}


# object masks (MovingObjects3D): the frame-1 mask rides in the U_IC, fused
# ICP and U_FC operands as one more channel
C_OBJ_UIC, C_OBJ_ICP, C_OBJ_UFC = C_WARP + 1, 7, C_UFC + 1
# per masked forward at 120x160 B=8: as unmasked where the mask rides in the
# operand (U_IC, U_FC) or is ignored (the ICP track); an IC residual warps
# the frame-1 mask in a gather of its own: RGB 3 a residual, DeepIC 3 a
# residual of its first, damping-sample and new residuals (18 a level) and
# its 3 upsamples
OBJ_LAUNCHES = {
    ("feature", ()): SERVE_LAUNCHES,
    ("feature_icp", ()): ICP_SERVE_LAUNCHES,
    ("DeepIC", ()): counts(gather_twohot=75),
    ("feature", UFC): UFC_SERVE_LAUNCHES,
    ("RGB", ()): counts(gather_twohot=36),
    ("ICP", ()): CLASSICAL_LAUNCHES["ICP"],
    ("RGB+ICP", ()): CLASSICAL_LAUNCHES["RGB+ICP"],
}
OBJ_VGA_LAUNCHES = VGA_SERVE_LAUNCHES  # feature at 640x480: K4 at level 0 (C=11)
# --save_img's diagnostics forward of one batch: the forward's launches and
# one more U_IC residual a level
OBJ_DIAG_LAUNCHES = counts(gather_twohot=16, fused_jtj_jtr=12)
OBJ_KEYFRAMES_TRAIN = "1,2,4"  # scripts/train_object_3d.sh
OBJ_PAIRS = 4  # warping_objects' pairs


def mask_last_channel(torch, F):
    """``F`` [b,h,w,C] with its last channel a 0/1 object mask (an ellipse
    over the middle of the plane), as the masked operands carry it."""
    _, h, w, _ = F.shape
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    F = F.clone()
    F[..., -1] = ((((yy - h / 2) / (0.35 * h)) ** 2 + ((xx - w / 2) / (0.3 * w)) ** 2) < 1
                  ).float().to(F.device)
    return F


def phase_objmask_kernels(torch, dev, name):
    """Phase 35: the kernels at the masked operands' channel counts, odd,
    so K1-K5 take their scalar paths: K1 at C=11 (U_IC) and 7 (ICP) at the
    120x160 B=8 levels, K2 and K3 at C=11 at the B=64 levels, K4 at C=11, 7
    and 29 (U_FC) at 480x640 B=8 (and C=29 on its 240x320 and 120x160
    planes), K5 at C=11 at 480x640 and 240x320 B=4; smooth and teleported
    coordinates, the last channel a 0/1 mask (K3's cotangent zero there);
    against the plain versions: K1, K2's and K4's ``out`` and K5's bit-exact
    (K2, K4 and K5 also with K1 / K2), gx/gy within 1e-6, K3 within 1e-5 of
    the largest entry.  Then each timed at level 0 beside the even channel
    count of the unmasked operand (C=10, 6, 28), in this call, and K1-K4 at
    C=12 (the masked U_IC operand padded to an even count)."""
    from deep_prob_feature_track_torch.ops import kernels as K

    err = {k: 0.0 for k in TPU_SOURCES if k != "fused_jtj_jtr"}
    for i, (h, w) in enumerate(LEVELS):
        for coords in ("smooth", "teleported"):
            for c in (C_OBJ_UIC, C_OBJ_ICP):
                F, args, _ = flat_inputs(torch, dev, B, h, w, c, 220 + i, coords)
                F = mask_last_channel(torch, F)
                out, ref = K.gather_twohot_cuda(F, *args), K.gather_twohot_ref(F, *args)
                torch.cuda.synchronize()
                e = (out - ref).abs().max().item()
                if e != 0.0:
                    raise AssertionError(f"gather_twohot is not bit-exact at C={c}, level {i}, "
                                         f"{coords}: {e}")
            label = f"level {i} {h}x{w}, C={C_OBJ_UIC}, {coords} coordinates, B={B_TRAIN}"
            F, args, _ = flat_inputs(torch, dev, B_TRAIN, h, w, C_OBJ_UIC, 230 + i, coords)
            F = mask_last_channel(torch, F)
            err["gather_twohot_grads"] = max(err["gather_twohot_grads"],
                                             check_k2(torch, F, args, label))
            g = torch.randn(B_TRAIN, C_OBJ_UIC, h * w, generator=torch.Generator().manual_seed(i))
            g[:, -1] = 0.0  # the mask channel's cotangent
            g = g.to(dev)
            got, ref = K.splat_twohot_cuda(g, *args, h, w), K.splat_twohot_ref(g, *args, h, w)
            torch.cuda.synchronize()
            e3 = (got - ref).abs().max().item()
            top = ref.abs().max().item()
            if not e3 <= 1e-5 * top:
                raise AssertionError(f"splat_twohot disagrees at {label}: {e3}")
            err["splat_twohot"] = max(err["splat_twohot"], e3)
        log(f"K1 at C={C_OBJ_UIC} and {C_OBJ_ICP}, K2 and K3 at C={C_OBJ_UIC}, level {i} "
            f"{h}x{w}: bit-exact (K3 within 1e-5)")
    cases = [(c, VGA_LEVELS[0]) for c in (C_OBJ_UIC, C_OBJ_ICP, C_OBJ_UFC)]
    cases += [(C_OBJ_UFC, hw) for hw in (VGA_LEVELS[1], (H, W))]
    for c, (h, w) in cases:
        for coords in ("smooth", "teleported"):
            F, maps, _ = tile_inputs(torch, dev, B, h, w, c, 240 + c, coords)
            err["gather_tiles"] = max(err["gather_tiles"], check_k4(
                torch, mask_last_channel(torch, F), maps, f"C={c} {h}x{w} {coords}"))
        log(f"K4 gather_tiles C={c} B={B} {h}x{w}: bit-exact with its plain version and K1")
    for h, w in VGA_LEVELS[:2]:
        for coords in ("smooth", "teleported"):
            F, maps, _ = tile_inputs(torch, dev, B_VGA_TRAIN, h, w, C_OBJ_UIC, 250, coords)
            F = mask_last_channel(torch, F)
            got = K.gather_tiles_grads_cuda(F, *maps)
            ref = K.gather_tiles_grads_ref(F, *maps)
            full = K.gather_twohot_grads_cuda(F, *[m.reshape(B_VGA_TRAIN, -1) for m in maps])
            torch.cuda.synchronize()
            e_out = max((got[0] - ref[0]).abs().max().item(), (got[0] - full[0]).abs().max().item())
            e2 = max((a - r).abs().max().item() for a, r in zip(got[1:], ref[1:]))
            top = max(r.abs().max().item() for r in ref[1:])
            if e_out != 0.0 or not e2 <= 1e-6 * top:
                raise AssertionError(f"gather_tiles_grads at C={C_OBJ_UIC} {h}x{w} {coords}: "
                                     f"out {e_out}, gx/gy {e2}")
            err["gather_tiles_grads"] = max(err["gather_tiles_grads"], e2)
        log(f"K5 gather_tiles_grads C={C_OBJ_UIC} B={B_VGA_TRAIN} {h}x{w}: out bit-exact with "
            "its plain version and K2, gx/gy within 1e-6")

    bw, flops = peaks(name)
    rows = []
    # each masked count beside the unmasked one, and C=11 beside C=12 too:
    # the masked U_IC operand padded to an even count
    for c in (C_OBJ_UIC, C_WARP, C_WARP + 2, C_OBJ_ICP, 6):
        F, args, uv = flat_inputs(torch, dev, B, H, W, c, 260, "smooth")
        rows.append({"kernel": "gather_twohot", "b": B, "hw": [H, W], "c": c,
                     **k1_timing(torch, F, args, uv, bw, flops)})
    for c in (C_OBJ_UIC, C_WARP, C_WARP + 2):
        F, args, uv = flat_inputs(torch, dev, B_TRAIN, H, W, c, 261, "smooth")
        rows.append({"kernel": "gather_twohot_grads", "b": B_TRAIN, "hw": [H, W], "c": c,
                     **k2_timing(torch, F, args, bw, flops)})
        g = torch.randn(B_TRAIN, c, H * W, generator=torch.Generator().manual_seed(262)).to(dev)
        rows.append({"kernel": "splat_twohot", "b": B_TRAIN, "hw": [H, W], "c": c,
                     **k3_timing(torch, g, args, uv, H, W, bw, flops)})
    k4_sets = ((C_OBJ_UIC, C_WARP, C_WARP + 2), (C_OBJ_ICP, 6), (C_OBJ_UFC, C_UFC))
    for kname, b, pairs in (("gather_tiles", B, k4_sets),
                            ("gather_tiles_grads", B_VGA_TRAIN, ((C_OBJ_UIC, C_WARP),))):
        for pair in pairs:
            for c in pair:
                F, maps, uv = tile_inputs(torch, dev, b, H_VGA, W_VGA, c, 263, "smooth")
                rows.append({"kernel": kname, "b": b, "hw": [H_VGA, W_VGA], "c": c,
                             **tile_timing(torch, kname, F, maps, uv, bw, flops)})
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"objects: {r['kernel']} C={r['c']} B={r['b']} {r['hw'][0]}x{r['hw'][1]}, smooth "
            f"coordinates: {r['ms']:.4f} ms, device {r['device_ms']:.4f} (plain "
            f"{r['plain_ms']:.4f}, library {lib}, bound {r['bound_ms']:.4f})")
    return err, rows


def _mo3d_batch(torch, dev, root, scale, b=B):
    """The first ``b`` test pairs of the boat sequences at ``scale``, with
    their object masks, as tensors on ``dev``."""
    from deep_prob_feature_track_torch.data.moving_objects import MovingObjects3D
    from deep_prob_feature_track_torch.data.pipeline import collate, to_device

    data = MovingObjects3D(root, "test", [1], select_traj="boat", image_resize=scale)
    return to_device(collate([data[i] for i in range(b)]), dev)


def phase_obj_forwards(torch, dev, root):
    """Phase 36: every preset's masked forward at 120x160 B=8 (the first 8
    boat pairs) and ``feature``'s at 640x480 B=8, with the launch counts of
    ``OBJ_LAUNCHES`` (reset just before, read just after), against the
    plain kernels within 1e-4 on R and t; the masks must move each pose
    (by more than 1e-6) but the ICP track's; events ms of the masked
    forwards, one profiled."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker
    from deep_prob_feature_track_torch.ops import kernels as K

    out = {}
    cases = [(p, o, CLI_SMALL, n) for (p, o), n in OBJ_LAUNCHES.items()]
    cases.append(("feature", (), CLI_VGA, OBJ_VGA_LAUNCHES))
    batches = {}
    for preset, overrides, scale, expected in cases:
        if scale not in batches:
            batches[scale] = _mo3d_batch(torch, dev, root, scale)
        batch = batches[scale]
        args = [batch[k] for k in KEYS]
        masks = {k: batch[k] for k in ("obj_mask0", "obj_mask1")}
        label = f"{config_name(preset, overrides)} B={B} at {scale}, object masks"
        net = build_tracker(preset, device=dev, overrides=overrides)
        plain = build_tracker(preset, device=dev, plain_kernels=True, overrides=overrides)
        with torch.inference_mode():
            K.reset_launches()
            R, t = net(*args, **masks)
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
            R_p, t_p = plain(*args, **masks)
            _, t_u = net(*args)
            gap = max((R - R_p).abs().max().item(), (t - t_p).abs().max().item())
            moved = (t - t_u).abs().max().item()
            ms = time_ms(torch, lambda: net(*args, **masks), reps=10, warmup=2)
            plain_ms = time_ms(torch, lambda: plain(*args, **masks), reps=10, warmup=2)
            row = {"launches": launches, "vs_plain": gap, "moved_by_masks": moved,
                   "forward_ms": ms, "forward_plain_ms": plain_ms}
            if (preset, overrides, scale) == ("feature", (), CLI_SMALL):
                row["profile"] = profile(torch, lambda: net(*args, **masks), label + " forward")
        log(f"{label}: launches {launches}, kernels against plain {gap:.3e}, the masks moved "
            f"t by {moved:.3e}; {ms:.3f} ms a forward ({plain_ms:.3f} plain)")
        if launches != expected:
            raise AssertionError(f"{label} launched {launches}, expected {expected}")
        if not (gap <= 1e-4 and torch.isfinite(t).all()):
            raise AssertionError(f"{label}: the kernel forward is {gap} from the plain one")
        if (moved <= 1e-6) != (preset == "ICP"):  # the ICP track ignores the masks
            raise AssertionError(f"{label}: the masks moved t by {moved}")
        out[f"{label}"] = row
    return out


def phase_obj_cli_eval(torch, dev, root, workdir):
    """Phase 37: ``apps.evaluate.main --dataset MovingObjects3D --obj_only
    --save_img 1`` with ``feature`` at 120x160 B=8, keyframe 1 (boat and
    motorbike, 200 sequences each): launches per batch as served, and the
    diagnostics' batch; the boat's poses against ``evaluate_two_view``
    through the plain kernels within 1e-4; frames/s and the loader-wait
    share; the 13 diagnostic PNG files decode; then ``--tracker ICP
    --obj_only`` on the boat: K1 40 a batch, poses against the plain
    baseline within 1e-4 (NaN in the same frames)."""
    from deep_prob_feature_track_torch import evaluation
    from deep_prob_feature_track_torch.apps import evaluate
    from deep_prob_feature_track_torch.apps.baselines import make_baseline
    from deep_prob_feature_track_torch.apps.serve import build_tracker
    from deep_prob_feature_track_torch.data.png import read_png

    import pickle

    out = {}
    for tracker, expected in (("learning_based", SERVE_LAUNCHES),
                              ("ICP", BASELINE_LAUNCHES["ICP"])):
        out_dir = os.path.join(workdir, f"mo3d_eval_{tracker}")
        args = ["--dataset", "MovingObjects3D", "--data_root", root, "--keyframes", "1",
                "--batch_size", str(B), "--image_resize", str(CLI_SMALL), "--obj_only",
                "--tracker", tracker, "--output_dir", out_dir, "--device", str(dev)]
        args += ["--save_img", "1"] if tracker == "learning_based" else ["--trajectory", "boat"]
        size = f"evaluate CLI MovingObjects3D --obj_only --tracker {tracker} {CLI_SMALL}"
        probe = _CliProbe(torch)
        try:
            probe.K.reset_launches()
            t0 = time.monotonic()
            if evaluate.main(args) != 0:
                raise AssertionError(f"{size} failed")
            wall = time.monotonic() - t0
            torch.cuda.synchronize()
            launches = dict(probe.K.LAUNCHES)
        finally:
            probe.restore()
        want = {k: n * probe.batches for k, n in expected.items()}
        if tracker == "learning_based":
            want = {k: n + OBJ_DIAG_LAUNCHES[k] for k, n in want.items()}
        if launches != want:
            raise AssertionError(f"{size} launched {launches}, expected {want}")
        name = "nolearning_feature" if tracker == "learning_based" else "nolearning_ICP"
        with open(os.path.join(out_dir, name, "boat_keyframe_1.pkl"), "rb") as fh:
            got = pickle.load(fh)
        (loader,) = evaluation.create_eval_loaders("MovingObjects3D", "test", [1], B,
                                                   trajectory="boat", image_resize=CLI_SMALL,
                                                   root=root).values()
        if tracker == "learning_based":
            net = build_tracker("feature", device=dev, plain_kernels=True)
        else:
            baseline = make_baseline("ICP", plain=True)

            def net(c0, c1, d0, d1, K, obj_mask0=None, obj_mask1=None):
                return baseline.batch_track(c0, d0, c1, d1, K)
        ref = evaluation.evaluate_two_view(loader, net, dev, has_mask=True, obj_only=True)
        gap = max(_finite_gap(got["R_est"], ref["R_est"], size),
                  _finite_gap(got["t_est"], ref["t_est"], size))
        if not gap <= 1e-4:
            raise AssertionError(f"{size}: the CLI's poses are {gap:.3e} from the plain ones")
        row = {"frames": probe.frames, "batches": probe.batches, "launches": launches,
               "wall_s": wall, "fps": probe.frames / probe.loop_s,
               "loader_wait_share": probe.wait_s / probe.loop_s, "vs_plain": gap,
               "epe3d_cm_boat": float(np.nanmean(got["epes"]) * 100)}
        if tracker == "learning_based":
            vis = os.path.join(out_dir, name, "vis", "batch000")
            files = sorted(os.listdir(vis))
            shapes = {f: read_png(os.path.join(vis, f)).shape for f in files}
            if len(files) != 13 or any(s[2] != 3 for s in shapes.values()):
                raise AssertionError(f"{size}: --save_img wrote {shapes}")
            row["save_img_files"] = len(files)
        log(f"{size}: {probe.frames} frames in {probe.batches} batches, launches {launches}; "
            f"{row['fps']:.1f} frames/s over the loop, {row['loader_wait_share']:.3f} of it "
            f"waiting on the loader; CLI against plain {gap:.3e}; boat EPE3D "
            f"{row['epe3d_cm_boat']:.3f} cm")
        out[tracker] = row
    return out


def phase_obj_cli_train(torch, dev, root, workdir):
    """Phase 38: ``apps.train.main --dataset MovingObjects3D --no_val`` with
    ``feature``, B=64, keyframes 1, 2 and 4 at 120x160, two steps: K2, K3
    and K6 12 times a step, finite losses; ms a step and the time spent
    waiting on the loader."""
    from deep_prob_feature_track_torch.apps import train

    args = ["--dataset", "MovingObjects3D", "--data_root", root, "--keyframes",
            OBJ_KEYFRAMES_TRAIN, "--batch_size", str(B_TRAIN), "--image_resize", str(CLI_SMALL),
            "--epochs", "1", "--max_steps_per_epoch", "2", "--no_val", "--checkpoint_folder",
            os.path.join(workdir, "mo3d_logs"), "--device", str(dev)]
    probe = _CliProbe(torch)
    try:
        t0 = time.monotonic()
        if train.main(args) != 0:
            raise AssertionError("the MovingObjects3D train CLI failed")
        wall = time.monotonic() - t0
    finally:
        probe.restore()
    for i, st in enumerate(probe.steps):
        log(f"train CLI MovingObjects3D B={B_TRAIN} step {i}: loss {st['loss']:.6f}, "
            f"{st['ms']:.1f} ms, launches {st['launches']}")
        if not np.isfinite(st["loss"]) or st["launches"] != TRAIN_LAUNCHES:
            raise AssertionError(f"MovingObjects3D train step {i}: loss {st['loss']}, launches "
                                 f"{st['launches']}, expected {TRAIN_LAUNCHES}")
    if len(probe.steps) != 2:
        raise AssertionError(f"the MovingObjects3D train CLI took {len(probe.steps)} steps")
    log(f"train CLI MovingObjects3D: {wall:.2f} s in all, {probe.wait_s:.2f} s waiting on the "
        "loader")
    return {"steps": probe.steps, "step_ms": [st["ms"] for st in probe.steps], "wall_s": wall,
            "loader_wait_s": probe.wait_s}


def phase_warping(torch, dev, root, workdir):
    """Phase 39: ``apps.warping_objects.main`` on the boat's first
    ``OBJ_PAIRS`` pairs, with ``--gt_pose`` (one K1 at C=3 a pair) and
    tracked by ``feature`` with the masks (K1 13 and K6 12 a pair): the
    masked residual printed per pair, the mosaics decode; the ground-truth
    residual below the tracked one is not required (random weights)."""
    from deep_prob_feature_track_torch.apps import warping_objects
    from deep_prob_feature_track_torch.data.png import read_png
    from deep_prob_feature_track_torch.ops import kernels as K

    out = {}
    for mode, per_pair in (("gt_pose", counts(gather_twohot=1)),
                           ("tracked", counts(gather_twohot=13, fused_jtj_jtr=12))):
        out_dir = os.path.join(workdir, f"warp_{mode}")
        args = ["--data_root", root, "--object", "boat", "--num_pairs", str(OBJ_PAIRS),
                "--output_dir", out_dir, "--device", str(dev)]
        args += ["--gt_pose"] if mode == "gt_pose" else []
        buf = io.StringIO()
        K.reset_launches()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            if warping_objects.main(args) != 0:
                raise AssertionError(f"warping_objects {mode} failed")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(K.LAUNCHES)
        residuals = [float(line.rsplit(" ", 1)[1]) for line in buf.getvalue().splitlines()
                     if "masked residual" in line]
        want = {k: n * OBJ_PAIRS for k, n in per_pair.items()}
        shapes = {f: read_png(os.path.join(out_dir, f)).shape for f in sorted(os.listdir(out_dir))}
        log(f"warping_objects {mode}: masked residuals {residuals}, launches {launches}, "
            f"mosaics {sorted(set(shapes.values()))}, {wall:.2f} s")
        if launches != want or len(residuals) != OBJ_PAIRS or not np.isfinite(residuals).all():
            raise AssertionError(f"warping_objects {mode}: launches {launches} (expected "
                                 f"{want}), residuals {residuals}")
        if len(shapes) != OBJ_PAIRS or any(s != (2 * H, 2 * W, 3) for s in shapes.values()):
            raise AssertionError(f"warping_objects {mode}: mosaics {shapes}")
        out[mode] = {"masked_residual": residuals, "launches": launches, "wall_s": wall}
    return out


def phase_objects(torch, dev):
    """Phases 36-39 on a MovingObjects3D dataset (``write_mo3d_dataset`` at
    640x480, every sequence of the categories' ranges) in a temporary
    directory, removed after."""
    import shutil

    workdir = tempfile.mkdtemp(prefix="dpft_mo3d_")
    try:
        root = os.path.join(workdir, "mo3d")
        t0 = time.monotonic()
        write_mo3d_dataset(root)
        log(f"wrote a MovingObjects3D-format dataset ({MO3D_FRAMES} frames of 640x480, "
            f"{sum(MO3D_CATEGORIES.values())} sequences) in {time.monotonic() - t0:.1f} s")
        return {"forwards": phase_obj_forwards(torch, dev, root),
                "cli_eval": phase_obj_cli_eval(torch, dev, root, workdir),
                "cli_train": phase_obj_cli_train(torch, dev, root, workdir),
                "warping_objects": phase_warping(torch, dev, root, workdir)}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_variant_kernels(torch, dev):
    """Phase 40: K1 at the learned ICP scale's 640x480 upsample (bit-exact);
    K6's ``FusedJtJ`` forward and backward with a nonzero JtJ cotangent at
    the 120x160 B=64 levels against its plain version and float64."""
    from deep_prob_feature_track_torch.ops import kernels as K

    err = {"gather_twohot": 0.0, "fused_jtj_jtr": 0.0}
    F, args = upsample_inputs(torch, dev, B, H_VGA // 2, W_VGA // 2, seed=150)
    out, ref = K.gather_twohot_cuda(F, *args), K.gather_twohot_ref(F, *args)
    torch.cuda.synchronize()
    e = (out - ref).abs().max().item()
    log(f"K1 gather_twohot, the learned scale's upsample {H_VGA // 2}x{W_VGA // 2} -> "
        f"{H_VGA}x{W_VGA}, B={B}: max|kernel - plain| = {e:.3e}")
    if e != 0.0:
        raise AssertionError(f"gather_twohot is not bit-exact at the 640x480 upsample: {e}")
    for i, (h, w) in enumerate(LEVELS):
        inputs = jtj_inputs(torch, dev, h * w, seed=151 + i, b=B_TRAIN)
        g = torch.Generator().manual_seed(160 + i)
        G = torch.randn(B_TRAIN, 6, 6, generator=g)
        cot = ((G + G.transpose(1, 2)).to(dev), torch.randn(B_TRAIN, 6, 1, generator=g).to(dev))

        def run(plain, dtype):
            xs = [a.detach().to(dtype).clone().requires_grad_() for a in inputs]
            outs = K.FusedJtJ.apply(*xs, -1.0, plain)
            torch.autograd.backward(outs, [c.to(dtype) for c in cot])
            return [o.detach() for o in outs] + [x.grad for x in xs]

        got, plain32, plain64 = run(False, torch.float32), run(True, torch.float32), [
            t.float() for t in run(True, torch.float64)]
        torch.cuda.synchronize()
        for x, r in zip(got, plain64):
            torch.testing.assert_close(x, r, rtol=1e-5, atol=1e-5 * r.abs().max().item())
        if not all(torch.equal(x, r) for x, r in zip(got[2:], plain32[2:])):
            raise AssertionError(f"FusedJtJ's backward differs from its plain run at level {i}")
        e = max((x - r).abs().max().item() for x, r in zip(got[:2], plain64[:2]))
        top = plain64[0].abs().max().item()
        log(f"K6 FusedJtJ level {i} [{B_TRAIN},{C_RES},{h * w}] with a JtJ cotangent: "
            f"forward max|kernel - plain f64| = {e:.3e} ({e / top:.2e} of the largest entry), "
            "backward bit-exact with the plain run")
        err["fused_jtj_jtr"] = max(err["fused_jtj_jtr"], e)
    return err


def phase_uncer_agree(torch, dev, items):
    """Phase 43: ``feature`` with ``uncer_prop``: the forward's pose and
    level 0's information matrix through the kernels (launches pinned)
    against the plain versions on the card and the CPU, on the smooth
    scenes ``items``.  ``noise_gaps`` logs the same on uniform noise."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker
    from deep_prob_feature_track_torch.ops import kernels as K

    def run(device, plain=False, batch_items=None):
        batch = [torch.from_numpy(np.stack([it[k] for it in batch_items or items])).to(device)
                 for k in KEYS]
        net = build_tracker("feature", device=device, plain_kernels=plain, overrides=UNCER)
        with torch.inference_mode():
            K.reset_launches()
            (R, t), info = net(*batch)
            launches = dict(K.LAUNCHES)
        return [a.cpu().numpy() for a in (R, t, info)], launches

    got, launches = run(dev)
    name = config_name("feature", UNCER)
    if launches != SERVE_LAUNCHES:
        raise AssertionError(f"{name} forward launched {launches}, expected {SERVE_LAUNCHES}")
    out = {"launches": launches}
    for other, ref, atol in (("plain", run(dev, True)[0], PRESET_ATOL),
                             ("cpu", run(torch.device("cpu"))[0], 1e-4)):
        dR, dt = (np.abs(a - b).max() for a, b in zip(got[:2], ref[:2]))
        dI = (np.abs(got[2] - ref[2]).max(axis=(1, 2)) / np.abs(ref[2]).max(axis=(1, 2))).max()
        log(f"{name}: B={len(items)} {H}x{W} forward, kernels vs {other}: max|dR| = {dR:.3e}, "
            f"max|dt| = {dt:.3e}, level 0 information matrix {dI:.2e} of its largest entry")
        if not (dR <= atol and dt <= atol and dI <= 1e-4 and np.isfinite(got[2]).all()):
            raise AssertionError(f"{name}: kernel forward disagrees with the {other} forward")
        out[other] = [float(dR), float(dt), float(dI)]
    return out


def phase_cli_uncer(torch, dev):
    """Phase 45: ``apps.train.main --loss URPE --no_val`` on an 8-frame
    written sequence linked as the 36 training sequences: 2 steps at
    120x160 B=64, launches pinned, finite losses."""
    import shutil

    from deep_prob_feature_track_torch.apps import train
    from deep_prob_feature_track_torch.data.tum_dicts import TUM_TRAINVAL

    workdir = tempfile.mkdtemp(prefix="dpft_uncer_")
    try:
        seq = os.path.join(workdir, "seq")
        write_tum_sequence(seq, n=8)
        root = os.path.join(workdir, "trainval")
        os.makedirs(root)
        for name in (n for names in TUM_TRAINVAL.values() for n in names):
            os.symlink(seq, os.path.join(root, name))
        probe = _CliProbe(torch)
        try:
            t0 = time.monotonic()
            if train.main(["--data_root", root, "--keyframes", ",".join(map(str, CLI_KEYFRAMES)),
                           "--batch_size", str(B_TRAIN), "--image_resize", str(CLI_SMALL),
                           "--max_steps_per_epoch", "2", "--epochs", "1", "--no_val",
                           "--loss", "URPE", "--checkpoint_folder", os.path.join(workdir, "logs"),
                           "--device", str(dev)]) != 0:
                raise AssertionError("the train CLI failed")
            wall = time.monotonic() - t0
        finally:
            probe.restore()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for i, st in enumerate(probe.steps):
        log(f"train CLI --loss URPE {CLI_SMALL} B={B_TRAIN} step {i}: loss {st['loss']:.6f}, "
            f"{st['ms']:.1f} ms, launches {st['launches']}")
        if not np.isfinite(st["loss"]):
            raise AssertionError("train CLI --loss URPE: non-finite loss")
        if st["launches"] != TRAIN_LAUNCHES:
            raise AssertionError(f"train CLI --loss URPE step {i} launched {st['launches']}, "
                                 f"expected {TRAIN_LAUNCHES}")
    if len(probe.steps) != 2:
        raise AssertionError(f"train CLI --loss URPE took {len(probe.steps)} steps, expected 2")
    return {"steps": probe.steps, "wall_s": wall}


def noise_gaps(torch, dev, items, preset, overrides, label="uniform-noise requests"):
    """The forwards of ``items`` through the kernels, their plain versions on
    the card and on the CPU: the largest pose gaps between each pair, and
    with ``uncer_prop`` the largest gap of level 0's information matrix
    relative to its largest entry, per sample; logged and returned, not
    held (a float32 hazard of uniform-noise depth: a flipped occlusion,
    ICP or sigma-extreme pixel moves the solve by its own share)."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker

    poses, infos = [], []
    for device, plain in ((dev, False), (dev, True), (torch.device("cpu"), True)):
        batch = [torch.from_numpy(np.stack([it[k] for it in items])).to(device) for k in KEYS]
        net = build_tracker(preset, device=device, plain_kernels=plain, overrides=overrides)
        with torch.inference_mode():
            out = net(*batch)
        pose, info = out if isinstance(out[0], tuple) else (out, None)
        poses.append(np.concatenate([a.cpu().numpy().reshape(len(items), -1) for a in pose],
                                    axis=1))
        infos.append(None if info is None else info.cpu().numpy())
    gaps = {}
    for pair, (i, j) in (("kernels_plain", (0, 1)), ("plain_cpu", (1, 2)),
                         ("kernels_cpu", (0, 2))):
        gaps[pair] = float(np.abs(poses[i] - poses[j]).max())
        if infos[j] is not None:
            gaps[pair + "_info"] = float((np.abs(infos[i] - infos[j]).max(axis=(1, 2))
                                          / np.abs(infos[j]).max(axis=(1, 2))).max())
    log(f"{config_name(preset, overrides)}: {label}, largest R/t gaps"
        f"{' and information-matrix gaps' if infos[0] is not None else ''} (not held): {gaps}")
    return gaps


def phase_variants(torch, dev, items, vga_items):
    """Phases 41-45 (the tracker options and the uncertainty losses); 40 is
    ``phase_variant_kernels``."""
    out = {}
    served = ((("feature_icp", SCALE), SCALE_SERVE_LAUNCHES),
              (("feature", ("init_pose_type=dense_net",)), SERVE_LAUNCHES),
              (("feature", ("encoder_name=ConvRGBD",)), SERVE_LAUNCHES),
              (("DeepIC", ("no_weight_sharing=1",)), DEEPIC_SERVE_LAUNCHES))
    for (preset, overrides), expected in served:
        _, served_items = phase_serve(torch, dev, H, W, expected, preset, overrides)
        out[config_name(preset, overrides)] = phase_agree(
            torch, dev, served_items, B, preset, PRESET_ATOL, expected, overrides)
    smooth = smooth_items(B, H, W)
    # expMultiScale weighs the ICP term up to 400x MultiScale2w's: on the
    # uniform-noise requests its flipped ICP masks move the pose by ~1e-2
    for (preset, overrides), expected, batch in (
            (("feature_icp", ("scaler=expMultiScale",)), SCALE_SERVE_LAUNCHES, smooth),
            (("feature", ("multi_hypo=average",)), SERVE_LAUNCHES, items),
            (("feature", ("res_input=1",)), SERVE_LAUNCHES, items)):
        out[config_name(preset, overrides)] = phase_agree(
            torch, dev, batch, B, preset, PRESET_ATOL, expected, overrides)
    out[config_name("feature_icp", SCALE) + " 480x640"] = phase_agree(
        torch, dev, vga_items, 0, "feature_icp", PRESET_ATOL, SCALE_VGA_LAUNCHES, SCALE)
    out["expMultiScale uniform-noise gaps"] = noise_gaps(torch, dev, items, "feature_icp",
                                                         ("scaler=expMultiScale",))
    out[config_name("feature", UNCER)] = phase_uncer_agree(torch, dev, smooth)
    out["uncer_prop uniform-noise gaps"] = noise_gaps(torch, dev, items, "feature", UNCER)
    # the uniform noise that the card test of uncer_prop first took (seed 3)
    out["uncer_prop uniform-noise gaps, seed 3"] = noise_gaps(
        torch, dev, request_items(B, H, W, seed=3), "feature", UNCER,
        "uniform-noise batch of seed 3")
    out["train_uepe3d"] = phase_train(torch, dev, B_TRAIN, H, W, TRAIN_SEED, TRAIN_LAUNCHES,
                                      overrides=UNCER, objective="UEPE3D")
    out["train_scale"] = phase_train(torch, dev, B_TRAIN, H, W, TRAIN_SEED,
                                     SCALE_TRAIN_LAUNCHES, "feature_icp", SCALE)
    out["cli_train_urpe"] = phase_cli_uncer(torch, dev)
    return out


def phase_forward(torch, dev, h, w, preset="feature", overrides=()):
    """The B=8 forward of ``preset`` at h x w, with the kernels and with
    their plain versions, and one profiled forward."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch

    name = config_name(preset, overrides)
    net = build_tracker(preset, device=dev, overrides=overrides)
    plain = build_tracker(preset, device=dev, plain_kernels=True, overrides=overrides)
    batch = example_batch(B, h, w, seed=2, device=dev)
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: net(*batch), reps=10, warmup=2)
        fwd_plain_ms = time_ms(torch, lambda: plain(*batch), reps=10, warmup=2)
        log(f"{name}: B={B} {h}x{w} forward: {fwd_ms:.3f} ms with the kernels "
            f"({B / fwd_ms * 1e3:.1f} frame pairs/s), {fwd_plain_ms:.3f} ms with their "
            f"plain versions")
        return {"forward_ms": fwd_ms, "forward_plain_ms": fwd_plain_ms,
                "profile": profile(torch, lambda: net(*batch),
                                   f"{name} B={B} {h}x{w} forward")}


def phase_step_time(torch, dev, preset, overrides=()):
    """The 120x160 B=64 train step of ``preset``, with the kernels and with
    their plain versions (5 steps after 2 of warm-up, each)."""
    from deep_prob_feature_track_torch.training import train as T

    batch = T.synthetic_batch(B_TRAIN, H, W, seed=TRAIN_SEED, device=dev)
    out = {}
    for key, plain in (("step_ms", False), ("step_plain_ms", True)):
        cfg, state = _train_state(torch, dev, plain=plain, preset=preset, overrides=overrides)
        step = T.make_train_step(cfg, steps_per_epoch=100)
        out[key] = time_ms(torch, lambda: step(state, batch), reps=5, warmup=2)
    log(f"{config_name(preset, overrides)}: B={B_TRAIN} {H}x{W} train step: "
        f"{out['step_ms']:.3f} ms with the kernels, {out['step_plain_ms']:.3f} ms with their "
        "plain versions")
    return out


def phase_time_channels(torch, dev, name):
    """K1 (B=8) at the 120x160 levels at C=1, 3 and 6 (the classical and ICP
    warps) and K2 (B=64) at level 0 at C=6 (the ICP warp of the feature_icp
    step), on smooth coordinates, and K6 at the 120x160 B=8 level 0 at C=1
    (the IC track of RGB+ICP), checked as in 4 first, beside the plain
    versions, the library call and the bound.  K4 at C=6 (the ICP warp of
    the 640x480 feature_icp forward) is timed in ``phase_time_tiles``."""
    bw, flops = peaks(name)
    rows = []
    for c in C_ICP:
        for i, (h, w) in enumerate(LEVELS):
            F, args, uv = flat_inputs(torch, dev, B, h, w, c, 110 + i, "smooth")
            rows.append({"kernel": "gather_twohot", "b": B, "level": i, "hw": [h, w], "c": c,
                         **k1_timing(torch, F, args, uv, bw, flops)})
    F, args, _ = flat_inputs(torch, dev, B_TRAIN, H, W, 6, 120, "smooth")
    rows.append({"kernel": "gather_twohot_grads", "b": B_TRAIN, "level": 0, "hw": [H, W],
                 "c": 6, **k2_timing(torch, F, args, bw, flops)})
    args = jtj_inputs(torch, dev, H * W, seed=122, c=1)
    e = check_jtj(torch, args, f"level 0 [{B},1,{H * W}]")
    rows.append({"kernel": "fused_jtj_jtr", "b": B, "level": 0, "hw": [H, W], "c": 1,
                 "max_abs_err": e, **k6_timing(torch, args, bw, flops)})
    for r in rows:
        lib = "-" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f}, device {r['library_device_ms']:.4f}")
        coords = "" if r["kernel"] == "fused_jtj_jtr" else ", smooth coordinates"
        log(f"{r['kernel']} C={r['c']} level {r['level']} {r['hw'][0]}x{r['hw'][1]} "
            f"B={r['b']}{coords}: {r['ms']:.4f} ms, device {r['device_ms']:.4f} "
            f"(plain {r['plain_ms']:.4f}, library {lib}, bound {r['bound_ms']:.4f})")
    return rows


# windowed BA (phases 46-50): ``ba_refine``'s default window of 3 over the
# 24 written frames gives 66 edges, tracked in 9 batches of 8
BA_WINDOW, BA_ITERATIONS, BA_DENSE_ITERATIONS = 3, 10, 5
BA_BATCHES = -(-(TUM_FRAMES * BA_WINDOW - BA_WINDOW * (BA_WINDOW + 1) // 2) // B)
BA_F32_ATOL = 1e-5  # the pose graph's float32 poses against float64 (phase 46)
BA_LONG_FRAMES = 800  # phase 46's second graph: a real sequence's length, 2,394 edges
DENSE_FRAMES, DENSE_ITERATIONS = 6, 3  # phase 47's window: 12 edges
DENSE_ATOL = 1e-4  # phase 47's poses: kernels, plain on the card and the CPU
# ba_refine's trajectory, card against CPU, each pose taken relative to
# frame 0's.  The seeded tracker's information matrices (up to 1.0e9 at
# 120x160, 3.5e11 at 640x480; smallest eigenvalues 3.6e6, 5.6e8) dwarf the
# pose graph's 1e6 anchor on pose 0, so its gauge (one rigid motion of
# every pose) is weakly pinned: on the CPU float32 moves the whole
# trajectory by 6.4e-5 and 5.7e-4 against float64 while the poses relative
# to frame 0 stay within 3.4e-7 and 2.3e-7 (scripts/torch_ba_gauge.py)
BA_CLI_ATOL = 1e-4
BA_CPU_VGA_FRAMES = 4  # the 640x480 CPU comparison: 6 edges, one batch
RUN_EXAMPLE_ATOL = 1e-4


def _window_pose_graph(torch, gt, seed=0):
    """Phase 46's problem: the poses ``gt`` [N,4,4] taken relative to the
    first, ``ba_refine``'s window edges with exact measurements, JtWJ-like
    information matrices (``1e3 (A A^T + I)``, A standard normal) and the
    poses 2..N perturbed by 0.02 (twist units), all from a seed."""
    from deep_prob_feature_track_torch.apps.ba_refine import window_pairs
    from deep_prob_feature_track_torch.geometry.lie import exp_se3

    poses = np.linalg.inv(gt[0])[None] @ gt
    n = len(poses)
    pairs = window_pairs(n, BA_WINDOW)
    rel = [np.linalg.inv(poses[j]) @ poses[i] for i, j in pairs]
    rng = np.random.RandomState(seed)
    A = rng.randn(len(pairs), 6, 6)
    infos = list(1e3 * (A @ A.transpose(0, 2, 1) + np.eye(6)))
    dR, dt = (x.numpy() for x in exp_se3(torch.from_numpy(rng.randn(n - 1, 6) * 0.02)))
    init = poses.copy()
    init[1:, :3, :3] = poses[1:, :3, :3] @ dR
    init[1:, :3, 3] += np.einsum("nij,nj->ni", poses[1:, :3, :3], dt)
    return poses, init, pairs, [(T[:3, :3], T[:3, 3]) for T in rel], infos


def _random_walk(torch, n, seed=1):
    """``n`` camera poses [n,4,4], each step a twist of 0.02 standard
    normal (rotation and translation), from a seed."""
    from deep_prob_feature_track_torch.geometry.lie import exp_se3

    dR, dt = (x.numpy() for x in exp_se3(
        torch.from_numpy(np.random.RandomState(seed).randn(n - 1, 6) * 0.02)))
    poses = [np.eye(4)]
    for R, t in zip(dR, dt):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        poses.append(poses[-1] @ T)
    return np.stack(poses)


def _graph_poses(g):
    """A refined graph's poses as rows of R (9) and t (3), in float64."""
    return np.concatenate([g.R.double().cpu().numpy().reshape(-1, 9),
                           g.t.double().cpu().numpy()], axis=1)


def phase_pose_graph(torch, dev, gt_poses):
    """Phase 46: ``refine_pose_graph`` on the card over the written
    sequence's 24 poses: float64 against the CPU (1e-9), float32 against
    float64 (``BA_F32_ATOL``), two card calls bit for bit, the time of one
    call; then the same over ``BA_LONG_FRAMES`` poses of a random walk (a
    real sequence's length: a 4,800-wide solve, 2,394 edges), without the
    CPU run.  Both hold the float64 poses to the ground truth (1e-6)."""
    from deep_prob_feature_track_torch.parallel import ba

    out = {}
    for poses, cpu in ((gt_poses, True), (_random_walk(torch, BA_LONG_FRAMES), False)):
        gt, init, pairs, meas, infos = _window_pose_graph(torch, poses)
        label = f"{len(gt)} poses"
        runs = [("card64", dev, torch.float64), ("card32", dev, torch.float32)]
        if cpu:
            runs.append(("cpu64", "cpu", torch.float64))
        res, graphs = {}, {}
        for key, device, dtype in runs:
            graphs[key] = ba.build_window_graph(init, pairs, meas, infos, device=device,
                                                dtype=dtype)
            res[key] = ba.refine_pose_graph(graphs[key], BA_ITERATIONS)
        for key in ("card64", "card32"):
            again = ba.refine_pose_graph(graphs[key], BA_ITERATIONS)
            if not all(torch.equal(a, b) for a, b in zip((*again[0][:2], again[1]),
                                                          (*res[key][0][:2], res[key][1]))):
                raise AssertionError(f"pose graph, {label}, {key}: two card calls differ")
        card64 = _graph_poses(res["card64"][0])
        vs_cpu = float(np.abs(card64 - _graph_poses(res["cpu64"][0])).max()) if cpu else None
        f32 = float(np.abs(_graph_poses(res["card32"][0]) - card64).max())
        vs_gt = float(np.abs(card64[:, 9:] - gt[:, :3, 3]).max())
        costs = res["card32"][1].cpu().numpy()
        ms = {key: time_ms(torch, lambda: ba.refine_pose_graph(graphs[key], BA_ITERATIONS),
                           reps=5, warmup=1) for key in ("card32", "card64")}
        log(f"pose graph, {label}, {len(pairs)} edges, {BA_ITERATIONS} iterations: float64 "
            f"card against CPU " + (f"{vs_cpu:.3e} (limit 1e-9)" if cpu else "not run")
            + f", float32 against float64 {f32:.3e} (limit {BA_F32_ATOL:g}), float64 against "
            f"the ground truth {vs_gt:.3e}; float32 cost {costs[0]:.4f} -> {costs[-1]:.3e}; "
            f"two card calls bit for bit; {ms['card32']:.3f} ms a call in float32, "
            f"{ms['card64']:.3f} in float64")
        if not ((vs_cpu is None or vs_cpu <= 1e-9) and f32 <= BA_F32_ATOL and vs_gt <= 1e-6
                and costs[-1] < costs[0]):
            raise AssertionError(f"pose graph, {label}: the card's poses disagree")
        out[label] = {"edges": len(pairs), "vs_cpu_f64": vs_cpu, "f32_vs_f64": f32,
                      "vs_gt": vs_gt, "ms_f32": ms["card32"], "ms_f64": ms["card64"]}
    return out


def _dense_problem(torch, dev, seq, net, level):
    """Phase 47's window: the first ``DENSE_FRAMES`` frames at 640x480,
    encoded by ``net`` at ``level``; the ground-truth poses perturbed by
    0.01; edges spanning ``BA_WINDOW`` frames."""
    from deep_prob_feature_track_torch.apps.ba_refine import encode_frames, window_pairs
    from deep_prob_feature_track_torch.data.loader import load_data
    from deep_prob_feature_track_torch.geometry.lie import exp_se3

    ds = load_data("TUM_RGBD", [1], "test", select_traj=seq, image_resize=CLI_VGA, root="")
    frames = encode_frames(net, ds, DENSE_FRAMES, level, dev)
    gt = np.stack(ds.cam_pose_seq[0][:DENSE_FRAMES])
    gt = np.linalg.inv(gt[0])[None] @ gt
    g = torch.Generator().manual_seed(level)
    dR, dt = exp_se3(torch.randn(DENSE_FRAMES - 1, 6, generator=g, dtype=torch.float64) * 0.01)
    R = torch.from_numpy(gt[:, :3, :3]).clone()
    t = torch.from_numpy(gt[:, :3, 3]).clone()
    t[1:] += torch.einsum("nij,nj->ni", R[1:], dt)
    R[1:] = R[1:] @ dR
    pairs = window_pairs(DENSE_FRAMES, BA_WINDOW)
    ei, ej = (torch.tensor([p[k] for p in pairs], device=dev) for k in (0, 1))
    return frames, R.float().to(dev), t.float().to(dev), ei, ej


def phase_dense_window(torch, dev, seq):
    """Phase 47: ``refine_dense_window`` on the seeded ``feature`` tracker's
    encoding of 6 frames at 640x480, levels 1 and 0: a gather (K1 at level
    1, K4 at level 0) and a K6 reduction per outer iteration; the poses
    through the kernels, through the plain versions on the card and on the
    CPU within ``DENSE_ATOL``; two calls bit for bit; the events of one
    iteration, its device busy time and idle share."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.parallel.dense_ba import WindowFrames, refine_dense_window

    net = build_tracker("feature", "", dev, overrides=["uncer_prop=1"])
    out = {}
    for level, gather in ((1, "gather_twohot"), (0, "gather_tiles")):
        frames, R, t, ei, ej = _dense_problem(torch, dev, seq, net, level)
        torch.cuda.synchronize()
        K.reset_launches()
        got = refine_dense_window(frames, R, t, ei, ej, iterations=DENSE_ITERATIONS)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        want = counts(**{gather: DENSE_ITERATIONS, "fused_jtj_jtr": DENSE_ITERATIONS})
        if launches != want:
            raise AssertionError(f"dense window level {level} launched {launches}, "
                                 f"expected {want}")
        again = refine_dense_window(frames, R, t, ei, ej, iterations=DENSE_ITERATIONS)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"dense window level {level}: two calls differ")
        plain = refine_dense_window(frames, R, t, ei, ej, iterations=DENSE_ITERATIONS,
                                    plain=True)
        cpu = refine_dense_window(WindowFrames(*(x.cpu() for x in frames)), R.cpu(), t.cpu(),
                                  ei.cpu(), ej.cpu(), iterations=DENSE_ITERATIONS)

        def gap(a, b):
            return max(float((x.cpu() - y.cpu()).abs().max()) for x, y in zip(a[:2], b[:2]))

        row = {"edges": int(ei.numel()), "hw": list(frames.feats.shape[-2:]),
               "c": int(frames.feats.shape[1]), "launches": launches,
               "vs_plain": gap(got, plain), "vs_cpu": gap(got, cpu),
               "costs": got[2].cpu().tolist()}

        def one():
            return refine_dense_window(frames, R, t, ei, ej, iterations=1)

        row["iteration_ms"] = time_ms(torch, one, reps=5, warmup=1, windows=3)
        row["profile"] = profile(torch, one, f"dense window iteration, level {level}, "
                                             f"{row['edges']} edges")
        log(f"dense window level {level} ({row['hw'][0]}x{row['hw'][1]}, {row['c']} feature "
            f"channels, {row['edges']} edges, {DENSE_ITERATIONS} iterations): launches "
            f"{launches}; costs {row['costs'][0]:.4f} -> {row['costs'][-1]:.4f}; kernels "
            f"against plain {row['vs_plain']:.3e}, against the CPU {row['vs_cpu']:.3e} (limit "
            f"{DENSE_ATOL:g}); one iteration {row['iteration_ms']:.3f} ms of events, "
            f"{row['profile']['device_busy_ms']:.3f} ms device busy, idle share "
            f"{row['profile']['idle_share']:.3f}")
        if not (row["vs_plain"] <= DENSE_ATOL and row["vs_cpu"] <= DENSE_ATOL):
            raise AssertionError(f"dense window level {level}: the poses disagree")
        if not row["costs"][-1] < row["costs"][0]:
            raise AssertionError(f"dense window level {level}: the cost did not fall")
        out[f"level{level}"] = row
    return out


def _ba_cli(torch, dev, args, label):
    """Run ``apps.ba_refine.main``: its launch counts (reset just before,
    read just after), wall time, printed lines and trajectory."""
    from deep_prob_feature_track_torch.apps import ba_refine
    from deep_prob_feature_track_torch.apps.traj_eval import load_tum_trajectory
    from deep_prob_feature_track_torch.ops import kernels as K

    output = args[args.index("--output") + 1]
    buf = io.StringIO()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        if ba_refine.main([*args, "--device", str(dev)]) != 0:
            raise AssertionError(f"ba_refine {label} failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"ba_refine {label} on {dev.type}: {line}")
    return {"launches": dict(K.LAUNCHES), "wall_s": wall, "lines": lines,
            "trajectory": load_tum_trajectory(output)[1]}


def _from_first(poses):
    """Poses [N,4,4] relative to the first: free of the pose graph's gauge."""
    return np.linalg.inv(poses[0])[None] @ poses


def phase_ba_cli(torch, dev, seq, workdir):
    """Phase 48: ``apps.ba_refine.main --dense`` with a checkpoint it
    writes, at 120x160 and at 640x480 on the card: the launches of 9
    batches of 8 pairs (as served: K1 12 / K6 12, or K4 3 / K1 9 / K6 12)
    and of the dense stage (its level-1 operand takes K1; K6) pinned; the
    trajectory file against the CPU run of the same CLI within
    ``BA_CLI_ATOL``, each pose relative to frame 0's; ATE before and after,
    the wall time.  At 640x480 the CPU run covers the first
    ``BA_CPU_VGA_FRAMES`` frames, and so does a second card run that is
    compared with it: the timed 24-frame card run is held to its launch
    counts, 24 finite poses and nothing more (its first frames' poses
    differ from the short run's, since a chunk's batch-global reductions
    and the pose graph's other edges enter them)."""
    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training.checkpoints import save_variables

    ckpt = save_variables(os.path.join(workdir, "ba.pt"), LeastSquareTracking(
        get_preset("feature")).reset_parameters(5).state_dict())
    out = {}
    for scale, per_batch in ((CLI_SMALL, SERVE_LAUNCHES), (CLI_VGA, VGA_SERVE_LAUNCHES)):
        base = ["--data_root", "", "--trajectory", seq, "--image_resize", str(scale),
                "--checkpoint", ckpt, "--window", str(BA_WINDOW), "--batch_size", str(B),
                "--dense"]
        run = _ba_cli(torch, dev, [*base, "--output", os.path.join(workdir, "ba_card.txt")],
                      f"{scale}")
        want = {k: n * BA_BATCHES for k, n in per_batch.items()}
        for k in ("gather_twohot", "fused_jtj_jtr"):
            want[k] = want.get(k, 0) + BA_DENSE_ITERATIONS
        if run["launches"] != want:
            raise AssertionError(f"ba_refine {scale} launched {run['launches']}, expected {want}")
        # the CPU run of the same CLI; at 640x480 on the first frames alone
        short, label = run, f"{scale}"
        frames = [] if scale == CLI_SMALL else ["--max_frames", str(BA_CPU_VGA_FRAMES)]
        if frames:
            label = f"{scale} first {BA_CPU_VGA_FRAMES} frames"
            short = _ba_cli(torch, dev, [*base, *frames, "--output",
                                         os.path.join(workdir, "ba_short.txt")], label)
        cpu = _ba_cli(torch, torch.device("cpu"),
                      [*base, *frames, "--output", os.path.join(workdir, "ba_cpu.txt")], label)
        raw_gap = float(np.abs(short["trajectory"] - cpu["trajectory"]).max())
        gap = float(np.abs(_from_first(short["trajectory"]) - _from_first(cpu["trajectory"])).max())
        ate = next(ln for ln in run["lines"] if "ATE-RMSE" in ln)
        out[str(scale)] = {"launches": run["launches"], "wall_s": run["wall_s"],
                           "cpu_wall_s": cpu["wall_s"], "vs_cpu": gap, "vs_cpu_raw": raw_gap,
                           "ate": ate, "frames_vs_cpu": len(cpu["trajectory"])}
        log(f"ba_refine {scale} --dense: {run['wall_s']:.2f} s on the card (decode "
            f"included), launches {run['launches']}; trajectory of "
            f"{len(cpu['trajectory'])} frames against the CPU run: relative to frame 0 "
            f"{gap:.3e} (limit {BA_CLI_ATOL:g}), as written {raw_gap:.3e}; {ate}")
        if not (gap <= BA_CLI_ATOL and np.isfinite(run["trajectory"]).all()
                and len(run["trajectory"]) == TUM_FRAMES):
            raise AssertionError(f"ba_refine {scale}: the trajectory disagrees with the CPU's")
    return out


def _printed_poses(text):
    """run_example's printed poses: one row of 12 numbers a pair."""
    import re

    pairs = re.split(r"pair \d+:", text)[1:]
    return np.asarray([[float(x) for x in re.findall(r"-?\d+\.\d*(?:e[-+]\d+)?", p)]
                       for p in pairs])


def phase_run_example(torch, dev, seq):
    """Phase 49: ``apps.run_example.main`` on the sequence's ``rgb/`` and
    ``depth/`` folders: a pair's launches (K1 2 for the colour resizes,
    C=3, and 12 for the forward; K6 12), the poses finite and within
    ``RUN_EXAMPLE_ATOL`` of the CPU run's."""
    from deep_prob_feature_track_torch.apps import run_example
    from deep_prob_feature_track_torch.ops import kernels as K

    def run(device):
        buf = io.StringIO()
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            if run_example.main(["--color_dir", os.path.join(seq, "rgb"), "--depth_dir",
                                 os.path.join(seq, "depth"), "--device", str(device)]) != 0:
                raise AssertionError("run_example failed")
        torch.cuda.synchronize()
        return _printed_poses(buf.getvalue()), time.perf_counter() - t0, dict(K.LAUNCHES)

    card, wall, launches = run(dev)
    cpu = run(torch.device("cpu"))[0]
    pairs = TUM_FRAMES - 1
    want = counts(gather_twohot=14 * pairs, fused_jtj_jtr=12 * pairs)
    gap = float(np.abs(card - cpu).max()) if card.shape == cpu.shape else float("inf")
    log(f"run_example: {card.shape[0]} pairs in {wall:.2f} s on the card (decode included), "
        f"launches {launches}; poses against the CPU run {gap:.3e} (limit "
        f"{RUN_EXAMPLE_ATOL:g})")
    if launches != want:
        raise AssertionError(f"run_example launched {launches}, expected {want}")
    if not (card.shape == (pairs, 12) and np.isfinite(card).all() and gap <= RUN_EXAMPLE_ATOL):
        raise AssertionError("run_example: the poses are not finite or disagree with the CPU")
    return {"pairs": pairs, "wall_s": wall, "launches": launches, "vs_cpu": gap}


def phase_vary_lighting(torch, dev, seq, workdir):
    """Phase 50: the sequence's frames laid out as a VaryLighting scene
    (``<root>/scene0/rgb``, ``depth``, no ground truth) and
    ``apps.evaluate.main --dataset VaryLighting`` at 120x160: launches as
    served a batch, "no ground truth; 23 poses estimated", and a summary row
    of NaN (empty) metrics and 23 frames."""
    from deep_prob_feature_track_torch.apps import evaluate
    from deep_prob_feature_track_torch.ops import kernels as K

    root = os.path.join(workdir, "vl")
    os.makedirs(os.path.join(root, "scene0"))
    for sub in ("rgb", "depth"):
        os.symlink(os.path.join(seq, sub), os.path.join(root, "scene0", sub))
    out_dir = os.path.join(workdir, "vl_out")
    buf = io.StringIO()
    torch.cuda.synchronize()
    K.reset_launches()
    with contextlib.redirect_stdout(buf):
        if evaluate.main(["--dataset", "VaryLighting", "--data_root", root, "--trajectory",
                          "scene0", "--keyframes", "1", "--batch_size", str(B),
                          "--image_resize", str(CLI_SMALL), "--output_dir", out_dir,
                          "--device", str(dev)]) != 0:
            raise AssertionError("the evaluate CLI failed on VaryLighting")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    pairs = TUM_FRAMES - 1
    batches = -(-pairs // B)
    want = {k: n * batches for k, n in SERVE_LAUNCHES.items()}
    line = f"scene0_keyframe_1: no ground truth; {pairs} poses estimated"
    with open(os.path.join(out_dir, "nolearning_feature", "summary.csv")) as fh:
        rows = fh.read().splitlines()
    row = next(r for r in rows if r.startswith("scene0_keyframe_1,"))
    log(f"evaluate CLI --dataset VaryLighting: launches {launches}; printed "
        f"{line in buf.getvalue()!r} for {line!r}; summary row {row!r}")
    if launches != want:
        raise AssertionError(f"VaryLighting evaluation launched {launches}, expected {want}")
    if line not in buf.getvalue() or row != f"scene0_keyframe_1,,,,{pairs},1,scene0":
        raise AssertionError("VaryLighting evaluation: poses only and a NaN summary expected")
    return {"launches": launches, "pairs": pairs, "summary_row": row}


def phase_ba(torch, dev):
    """Phases 46-50 in a temporary directory, removed after."""
    import shutil

    workdir = tempfile.mkdtemp(prefix="dpft_ba_")
    try:
        t0 = time.monotonic()
        seq = os.path.join(workdir, "seq")
        gt = np.stack(write_tum_sequence(seq, n=TUM_FRAMES))
        out = {"pose_graph": phase_pose_graph(torch, dev, gt),
               "dense_window": phase_dense_window(torch, dev, seq),
               "ba_refine": phase_ba_cli(torch, dev, seq, workdir),
               "run_example": phase_run_example(torch, dev, seq),
               "vary_lighting": phase_vary_lighting(torch, dev, seq, workdir)}
        log(f"phases 46-50 (windowed BA, run_example, VaryLighting) in "
            f"{time.monotonic() - t0:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


# ------------------------------------------------------------- phases 51-56
ACCUM = 2  # phase 51's microbatches a step
ACCUM_LAUNCHES = counts(gather_twohot_grads=12 * ACCUM, splat_twohot=12 * ACCUM,
                        fused_jtj_jtr=12 * ACCUM)
ACCUM_F64_B = 8  # phase 51's float64 card-vs-CPU step (B=8 at 120x160, 2 microbatches)
DP_WORLD = 2  # phases 53-54: gloo ranks on the one card
DP_TIMEOUT_S = 600
DP_SECOND_LOSS = 1e-2  # phase 53's second loss, after updates up to 2 lr apart
DENSE_DP_LAUNCHES = counts(gather_twohot=DENSE_ITERATIONS, fused_jtj_jtr=DENSE_ITERATIONS)
SCANNET_KEYFRAME = 2  # 16 frames at stride 2: 7 pairs, one batch of 8


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _step_ms(torch, dev, fn):
    """ms a call of ``fn`` (events on the card, the host clock on the CPU)."""
    if dev.type == "cuda":
        return time_ms(torch, fn, reps=3, warmup=1)
    return host_ms(fn, reps=1)


def _step_snapshot(torch, state):
    """The tracker's state_dict and the optimizer's per-parameter state,
    cloned."""
    net = {k: v.detach().clone() for k, v in state.net.state_dict().items()}
    opt = {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
           for i, s in state.optimizer.state_dict()["state"].items()}
    return net, opt


def _accum_step(torch, dev, batch, plain, accum, dtype=None):
    """One ``accum``-microbatch step of ``feature`` from the seeded init:
    ``(metrics, the clipped averaged gradients, the parameters, the
    launches, the state, the step)``."""
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.training import train as T

    cfg = T.TrainConfig(accum_steps=accum)
    _, state = _train_state(torch, dev, plain=plain)
    if dtype is not None:
        state.net.to(dtype)
        state = T.TrainState(net=state.net, optimizer=T.make_optimizer(cfg,
                                                                       state.net.parameters()))
    step = T.make_train_step(cfg, steps_per_epoch=100)
    _sync(torch, dev)
    K.reset_launches()
    state, metrics = step(state, batch)
    _sync(torch, dev)
    launches = dict(K.LAUNCHES)
    grads = {k: p.grad.detach().clone() for k, p in state.net.named_parameters()
             if p.grad is not None}
    params = {k: p.detach().clone() for k, p in state.net.named_parameters()}
    return metrics, grads, params, launches, state, step


def phase_accum(torch, dev):
    """Phase 51: ``feature`` at 120x160 B=64 with ``accum_steps=2``."""
    from deep_prob_feature_track_torch.training import train as T

    batch = T.synthetic_batch(B_TRAIN, H, W, seed=TRAIN_SEED, device=dev)
    m_k, g_k, p_k, launches, state, step = _accum_step(torch, dev, batch, False, ACCUM)
    m_p, g_p, p_p, plain_launches, _, _ = _accum_step(torch, dev, batch, True, ACCUM)
    loss_k, loss_p = m_k["loss"].item(), m_p["loss"].item()
    log(f"accumulation: B={B_TRAIN} {H}x{W} in {ACCUM} microbatches: loss {loss_k:.6f}, grad "
        f"norm {m_k['grad_norm'].item():.6f}, launches {launches}")
    if launches != ACCUM_LAUNCHES or any(plain_launches.values()):
        raise AssertionError(f"the accumulated step launched {launches} (plain "
                             f"{plain_launches}), expected {ACCUM_LAUNCHES}")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    worst, worst_key = _worst_leaf(g_k, g_p)
    lr = T.TrainConfig().lr
    # one Adam update moves a parameter by at most lr: two runs whose
    # gradients differ in sign where they are near zero sit at most 2 lr apart
    dp = max(float((p_k[k] - p_p[k]).abs().max()) for k in p_k)
    log(f"accumulation: kernels against plain on the card: loss {rel:.2e} relative, worst "
        f"averaged-gradient leaf {worst_key} {worst:.2e} of its largest entry, parameters "
        f"{dp:.2e} apart (at most 2 lr = {2 * lr:g})")
    if not (rel <= 1e-5 and worst <= GRAD_ENVELOPE and dp <= 2 * lr):
        raise AssertionError("the accumulated step through the kernels disagrees with plain")

    small = {k: v[:ACCUM_F64_B].double() if v.is_floating_point() else v[:ACCUM_F64_B]
             for k, v in batch.items()}
    card = _accum_step(torch, dev, small, True, ACCUM, torch.float64)
    cpu = _accum_step(torch, torch.device("cpu"), {k: v.cpu() for k, v in small.items()}, True,
                      ACCUM, torch.float64)
    rel64 = abs(card[0]["loss"].item() - cpu[0]["loss"].item()) / abs(cpu[0]["loss"].item())
    worst64, key64 = _worst_leaf({k: v.cpu() for k, v in card[1].items()}, cpu[1])
    dp64 = max(float((card[2][k].cpu() - cpu[2][k]).abs().max()) for k in cpu[2])
    log(f"accumulation in float64 (plain, B={ACCUM_F64_B}): card against CPU: loss "
        f"{rel64:.2e} relative, worst gradient leaf {key64} {worst64:.2e}, parameters "
        f"{dp64:.2e} apart")
    if not (rel64 <= 1e-10 and worst64 <= 1e-8 and dp64 <= 1e-8):
        raise AssertionError("the float64 accumulated step on the card disagrees with the CPU")

    ms = time_ms(torch, lambda: step(state, batch), reps=3, warmup=1)
    _, _, _, _, state1, step1 = _accum_step(torch, dev, batch, False, 1)
    ms1 = time_ms(torch, lambda: step1(state1, batch), reps=3, warmup=1)
    log(f"accumulation: {ms:.3f} ms a step of B={B_TRAIN} in {ACCUM} microbatches, "
        f"{ms1:.3f} ms in one")
    return {"launches": launches, "loss": loss_k, "vs_plain_loss": rel,
            "vs_plain_grad_leaf": [worst_key, worst], "vs_plain_params": dp,
            "f64_vs_cpu": {"loss": rel64, "grad_leaf": [key64, worst64], "params": dp64},
            "step_ms": ms, "step_ms_accum1": ms1}


def phase_guard(torch, dev):
    """Phase 52: the guarded step on a batch with one NaN depth map."""
    from deep_prob_feature_track_torch.training import train as T

    cfg, state = _train_state(torch, dev)
    step = T.make_train_step(cfg, steps_per_epoch=100, guard_nonfinite=True)
    state, metrics = step(state, T.synthetic_batch(B, H, W, seed=1, device=dev))
    if bool(metrics["skipped"]):
        raise AssertionError("the guard skipped a finite batch")
    before = _step_snapshot(torch, state)
    batch = T.synthetic_batch(B, H, W, seed=2, device=dev)
    batch["depth0"][0] = float("nan")
    state, metrics = step(state, batch)
    after = _step_snapshot(torch, state)
    same = all(torch.equal(a, b) for a, b in zip(before[0].values(), after[0].values()))
    for i, s in before[1].items():
        same = same and all(torch.equal(v, after[1][i][k]) for k, v in s.items())
    log(f"guard: a NaN depth map: skipped {bool(metrics['skipped'])}, loss "
        f"{metrics['loss'].item()}, step {state.step}, skipped {state.skipped}; "
        f"weights, BatchNorm buffers and Adam state bit for bit: {same}")
    if not (bool(metrics["skipped"]) and same and state.step == 2
            and state.skipped == 1):
        raise AssertionError("the guard did not keep the state of a skipped step")
    return {"skipped": True, "bit_identical": same}


def _two_rank_work(torch, dev, mesh, workdir):
    """Phases 53-54's work, with a mesh on this rank's shard, without one on
    the whole batch: two ``feature`` steps at 120x160 B=64, the 640x480 B=8
    eval forward, the 800-pose graph and the level-1 dense window."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.parallel import ba
    from deep_prob_feature_track_torch.parallel import mesh as M
    from deep_prob_feature_track_torch.parallel.dense_ba import WindowFrames, refine_dense_window
    from deep_prob_feature_track_torch.training import train as T

    def shard(x):
        return x if mesh is None else x[M.batch_sharding(mesh, x.shape[0])]

    out = {}
    cfg, state = _train_state(torch, dev)
    step = T.make_train_step(cfg, steps_per_epoch=100, mesh=mesh)
    batch = {k: shard(v) for k, v in T.synthetic_batch(B_TRAIN, H, W, seed=TRAIN_SEED,
                                                       device=dev).items()}
    losses, launches = [], []
    for i in range(2):
        _sync(torch, dev)
        K.reset_launches()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        launches.append(dict(K.LAUNCHES))
        if i == 0:
            grads = {k: p.grad.detach().cpu() for k, p in state.net.named_parameters()
                     if p.grad is not None}
    out["train"] = {"losses": losses, "launches": launches, "grads": grads,
                    "params": {k: v.detach().cpu() for k, v in state.net.state_dict().items()},
                    "step_ms": _step_ms(torch, dev, lambda: step(state, batch))}

    net = build_tracker("feature", device=dev)
    inputs = [shard(x) for x in example_batch(B, H_VGA, W_VGA, seed=2, device=dev)]
    _sync(torch, dev)
    K.reset_launches()
    with torch.inference_mode(), M.active(mesh):
        R, t = net(*inputs)
        if mesh is not None:
            R, t = M.all_gather_rows(mesh, R), M.all_gather_rows(mesh, t)
    _sync(torch, dev)
    out["eval"] = {"R": R.cpu(), "t": t.cpu(), "launches": dict(K.LAUNCHES)}

    _, init, pairs, meas, infos = _window_pose_graph(torch, _random_walk(torch, BA_LONG_FRAMES))
    graph = ba.build_window_graph(init, pairs, meas, infos, device=dev, dtype=torch.float64)
    if mesh is None:
        refined, costs = ba.refine_pose_graph(graph, BA_ITERATIONS)
    else:
        refined, costs = ba.refine_pose_graph_sharded(graph, mesh, BA_ITERATIONS)
    out["pose_graph"] = {"R": refined.R.cpu(), "t": refined.t.cpu(), "costs": costs.cpu(),
                         "edges": len(pairs)}

    saved = torch.load(os.path.join(workdir, "dense.pt"))
    frames = WindowFrames(*(x.to(dev) for x in saved["frames"]))
    args = [saved[k].to(dev) for k in ("R", "t", "ei", "ej")]
    _sync(torch, dev)
    K.reset_launches()
    Rd, td, dcosts = refine_dense_window(frames, *args, iterations=DENSE_ITERATIONS, mesh=mesh)
    _sync(torch, dev)
    out["dense"] = {"R": Rd.cpu(), "t": td.cpu(), "costs": dcosts.cpu(),
                    "launches": dict(K.LAUNCHES), "edges": int(args[2].numel())}
    return out


def two_rank_worker(rank: int, port: int, workdir: str, device: str) -> int:
    """One of phases 53-54's gloo ranks on ``device`` (the parent's card):
    ``_two_rank_work`` on its shard, saved to ``workdir/rank{rank}.pt``."""
    import torch

    from deep_prob_feature_track_torch.device import set_float32_policy
    from deep_prob_feature_track_torch.ops.kernels import loader
    from deep_prob_feature_track_torch.parallel import mesh as M

    dev = torch.device(device)
    set_float32_policy()
    if dev.type == "cuda":
        loader.build()  # the parent's libraries, found on disk
    mesh = M.make_mesh(dev, backend="gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                       world_size=DP_WORLD)
    try:
        out = _two_rank_work(torch, dev, mesh, workdir)
    finally:
        M.destroy()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    return 0


def phase_two_ranks(torch, dev, workdir, seq):
    """Phases 53-54: two gloo ranks on the card against one process."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker
    from deep_prob_feature_track_torch.parallel.mesh import free_port
    from deep_prob_feature_track_torch.training import train as T

    net = build_tracker("feature", "", dev, overrides=["uncer_prop=1"])
    frames, R, t, ei, ej = _dense_problem(torch, dev, seq, net, 1)
    torch.save({"frames": [x.cpu() for x in frames], "R": R.cpu(), "t": t.cpu(),
                "ei": ei.cpu(), "ej": ej.cpu()}, os.path.join(workdir, "dense.pt"))
    del net
    port = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"), "--rank",
                               str(r), str(port), workdir, str(dev)], cwd=here,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(DP_WORLD)]
    try:
        ref = _two_rank_work(torch, dev, None, workdir)
        logs = [p.communicate(timeout=DP_TIMEOUT_S)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.monotonic() - t0
    if any(p.returncode for p in procs):
        raise AssertionError("a rank failed:\n" + "\n".join(x[-4000:] for x in logs))
    got = [torch.load(os.path.join(workdir, f"rank{r}.pt")) for r in range(DP_WORLD)]
    for k, v in got[0]["train"]["params"].items():
        if not torch.equal(v, got[1]["train"]["params"][k]):
            raise AssertionError(f"the ranks' {k} differ after the steps")

    g, r = got[0]["train"], ref["train"]
    per_rank = [x["train"]["launches"] for x in got]
    rel = [abs(a - b) / abs(b) for a, b in zip(g["losses"], r["losses"])]
    worst, worst_key = _worst_leaf(g["grads"], r["grads"])
    lr = T.TrainConfig().lr
    stats = [k for k in r["params"] if k.endswith(("running_mean", "running_var"))]
    dp = max(float((g["params"][k] - r["params"][k]).abs().max())
             for k in r["params"] if k not in stats and not k.endswith("num_batches_tracked"))
    ds = max(float((g["params"][k] - r["params"][k]).abs().max() / r["params"][k].abs().max())
             for k in stats)
    log(f"data parallel, {DP_WORLD} gloo ranks on the card, B={B_TRAIN // DP_WORLD} each, "
        f"against one process at B={B_TRAIN}: losses {g['losses']} against {r['losses']} "
        f"(relative {max(rel):.2e}), worst first-step gradient leaf {worst_key} {worst:.2e} "
        f"of its largest entry, parameters after 2 steps {dp:.2e} apart (at most 4 lr), "
        f"BatchNorm statistics {ds:.2e} of their largest entry; "
        f"launches a step on each rank {per_rank}; {g['step_ms']:.3f} ms a step on rank 0 "
        f"against {r['step_ms']:.3f} ms in one process")
    if not all(n == TRAIN_LAUNCHES for x in per_rank for n in x):
        raise AssertionError(f"a rank's step launched {per_rank}, expected {TRAIN_LAUNCHES}")
    # the first step from the same weights: its loss and gradients as the
    # kernels against their plain versions (phase 11); one Adam update moves
    # a parameter by up to lr, so where a gradient entry is near zero the two
    # runs' parameters part by up to 2 lr a step, and the second loss with them
    if not (rel[0] <= 1e-5 and worst <= GRAD_ENVELOPE and rel[1] <= DP_SECOND_LOSS
            and dp <= 4 * lr and ds <= DP_SECOND_LOSS):
        raise AssertionError("the two-rank steps disagree with the one-process steps")

    ge, re_ = got[0]["eval"], ref["eval"]
    de = max(float((ge["R"] - re_["R"]).abs().max()), float((ge["t"] - re_["t"]).abs().max()))
    want = VGA_SERVE_LAUNCHES
    log(f"data parallel eval forward, 640x480 B={B} ({B // DP_WORLD} a rank): poses "
        f"{de:.3e} from one process (limit 1e-4); launches {[x['eval']['launches'] for x in got]}")
    if not (de <= 1e-4 and all(x["eval"]["launches"] == want for x in got)):
        raise AssertionError("the two-rank eval forward disagrees")

    gp, rp = got[0]["pose_graph"], ref["pose_graph"]
    dpg = max(float((gp["R"] - rp["R"]).abs().max()), float((gp["t"] - rp["t"]).abs().max()))
    gd, rd = got[0]["dense"], ref["dense"]
    dd = max(float((gd["R"] - rd["R"]).abs().max()), float((gd["t"] - rd["t"]).abs().max()))
    log(f"sharded pose graph, {BA_LONG_FRAMES} poses, {gp['edges']} edges over {DP_WORLD} "
        f"ranks, float64: {dpg:.3e} from the unsharded refinement (limit 1e-9); sharded "
        f"dense window level 1, {gd['edges']} edges: {dd:.3e} from one "
        f"process (limit {DENSE_ATOL:g}), launches {[x['dense']['launches'] for x in got]}; "
        f"{wall:.1f} s for phases 53-54's two-rank part")
    if not (dpg <= 1e-9 and dd <= DENSE_ATOL
            and all(x["dense"]["launches"] == DENSE_DP_LAUNCHES for x in got)):
        raise AssertionError("the sharded back end disagrees with the unsharded one")
    return {"train": {"losses": g["losses"], "ref_losses": r["losses"], "loss_rel": max(rel),
                      "grad_leaf": [worst_key, worst], "params": dp, "bn_stats": ds,
                      "launches": per_rank,
                      "step_ms_rank0": g["step_ms"], "step_ms_one_process": r["step_ms"]},
            "eval_vga": {"vs_one_process": de, "launches": got[0]["eval"]["launches"]},
            "pose_graph": {"vs_unsharded": dpg, "edges": gp["edges"]},
            "dense_level1": {"vs_one_process": dd, "launches": got[0]["dense"]["launches"]},
            "wall_s": wall}


def _trainval_root(workdir, seq):
    """A data root whose TUM training sequences are links to ``seq``."""
    from deep_prob_feature_track_torch.data.tum_dicts import TUM_TRAINVAL

    root = os.path.join(workdir, "trainval")
    os.makedirs(root, exist_ok=True)
    for name in (n for names in TUM_TRAINVAL.values() for n in names):
        os.symlink(seq, os.path.join(root, name))
    return root


def _train_cli(torch, args, label):
    """``apps.train.main(args)`` with each step's loss, time and launches."""
    from deep_prob_feature_track_torch.apps import train

    probe = _CliProbe(torch)
    try:
        t0 = time.monotonic()
        if train.main(args) != 0:
            raise AssertionError(f"{label}: the train CLI failed")
        wall = time.monotonic() - t0
    finally:
        probe.restore()
    return probe, wall


def phase_distributed_cli(torch, dev, root, workdir):
    """Phase 53's CLI part: ``--distributed`` at world size 1 over NCCL."""
    base = ["--data_root", root, "--keyframes", "1", "--batch_size", str(B), "--image_resize",
            str(CLI_SMALL), "--epochs", "1", "--max_steps_per_epoch", "2", "--no_val",
            "--device", str(dev)]
    plain, _ = _train_cli(torch, [*base, "--checkpoint_folder", os.path.join(workdir, "l1")],
                          "train CLI")
    dist_, wall = _train_cli(torch, [*base, "--distributed", "--checkpoint_folder",
                                     os.path.join(workdir, "l2")], "train CLI --distributed")
    a = [s["loss"] for s in plain.steps]
    b = [s["loss"] for s in dist_.steps]
    log(f"train CLI --distributed (NCCL, world size 1): losses {b} against {a}; launches "
        f"{[s['launches'] for s in dist_.steps]}")
    # the first loss bit for bit; the second follows an update whose K3
    # sums (float atomics) differ in their last bits from run to run
    if not (len(a) == len(b) == 2 and a[0] == b[0] and abs(a[1] - b[1]) <= 1e-5 * abs(a[1])
            and all(s["launches"] == TRAIN_LAUNCHES for s in dist_.steps)):
        raise AssertionError("the --distributed train CLI disagrees with the plain one")
    return {"losses": b, "ref_losses": a, "wall_s": wall}


def phase_scannet(torch, dev, workdir):
    """Phase 55: a written 16-frame ScanNet scan through both CLIs."""
    import pickle

    from deep_prob_feature_track_torch.apps import evaluate
    from deep_prob_feature_track_torch.data.io import read_depth_png, read_rgb
    from deep_prob_feature_track_torch.data.jpeg import read_jpeg

    root = os.path.join(workdir, "scannet")
    scan = os.path.join(root, "val", "scene0565_00")
    t0 = time.monotonic()
    write_scannet_scan(scan, n=SCANNET_FRAMES, quality=75)
    os.makedirs(os.path.join(root, "train"))
    os.symlink(scan, os.path.join(root, "train", "scene0565_00"))
    write_s = time.monotonic() - t0
    t0 = time.monotonic()
    for i in range(SCANNET_FRAMES):
        color = os.path.join(scan, f"frame-{i:06d}.color.jpg")
        depth = os.path.join(scan, f"frame-{i:06d}.merged_depth.png")
        same_bits(color, read_jpeg(color), read_jpeg(color, plain=True))
        for scale in (CLI_SMALL, CLI_VGA):
            same_bits(f"{color} at {scale}", read_rgb(color, scale),
                      read_rgb(color, scale, plain=True))
            same_bits(f"{depth} at {scale}", read_depth_png(depth, 5000.0, scale),
                      read_depth_png(depth, 5000.0, scale, plain=True))
    log(f"ScanNet native against plain: {SCANNET_FRAMES} JPEG frames (read_jpeg, read_rgb at "
        f"{CLI_SMALL} and {CLI_VGA}) and their depth maps bit for bit in "
        f"{time.monotonic() - t0:.1f} s")
    frame = os.path.join(scan, "frame-000000.color.jpg")
    decode = {"read_jpeg_ms": native_and_plain_ms(lambda plain: read_jpeg(frame, plain=plain)),
              **{f"read_rgb_{scale}_ms": native_and_plain_ms(
                  lambda plain, s=scale: read_rgb(frame, s, plain=plain))
                 for scale in (CLI_SMALL, CLI_VGA)},
              "bytes": os.path.getsize(frame)}
    log(f"ScanNet: {SCANNET_FRAMES} frames written in {write_s:.1f} s; one 640x480 frame "
        f"({decode['bytes']} bytes), ms native / plain (host): "
        + ", ".join(f"{k[:-3]} {v['native']:.2f} / {v['plain']:.2f}" for k, v in decode.items()
                    if k != "bytes"))
    out = {"decode": decode, "write_s": write_s}
    runs = (("card", CLI_SMALL, dev, SERVE_LAUNCHES), ("card", CLI_VGA, dev, VGA_SERVE_LAUNCHES),
            ("cpu", CLI_SMALL, torch.device("cpu"), None))
    poses = {}
    for where, scale, device, expected in runs:
        label = f"ScanNet evaluate CLI {scale} on the {where}"
        out_dir = os.path.join(workdir, f"sn_{scale}_{where}")
        probe = _CliProbe(torch)
        try:
            probe.K.reset_launches()
            t0 = time.monotonic()
            if evaluate.main(["--dataset", "ScanNet", "--data_root", root, "--trajectory",
                              "scene0565_00", "--keyframes", str(SCANNET_KEYFRAME),
                              "--batch_size", str(B), "--image_resize", str(scale),
                              "--output_dir", out_dir, "--device", str(device)]) != 0:
                raise AssertionError(f"{label} failed")
            wall = time.monotonic() - t0
            _sync(torch, device)
            launches = dict(probe.K.LAUNCHES)
        finally:
            probe.restore()
        with open(os.path.join(out_dir, "nolearning_feature",
                               f"scene0565_00_keyframe_{SCANNET_KEYFRAME}.pkl"), "rb") as fh:
            info = pickle.load(fh)
        poses[(where, scale)] = info
        row = {"frames": probe.frames, "batches": probe.batches, "launches": launches,
               "wall_s": wall, "fps": probe.frames / probe.loop_s,
               "loader_wait_share": probe.wait_s / probe.loop_s,
               "epe3d_cm": float(info["epes"].mean() * 100)}
        log(f"{label}: {probe.frames} frames in {probe.batches} batches, launches {launches}, "
            f"EPE3D {row['epe3d_cm']:.3f} cm, {row['fps']:.1f} frames/s, "
            f"{row['loader_wait_share']:.3f} of the loop waiting on the loader")
        if expected is not None and launches != {k: n * probe.batches
                                                 for k, n in expected.items()}:
            raise AssertionError(f"{label} launched {launches}, expected {expected} a batch")
        if not (np.isfinite(info["R_est"]).all() and np.isfinite(info["t_est"]).all()):
            raise AssertionError(f"{label}: non-finite poses")
        out[f"evaluate_{scale}_{where}"] = row
    card, cpu = poses[("card", CLI_SMALL)], poses[("cpu", CLI_SMALL)]
    gap = max(float(np.abs(card[k] - cpu[k]).max()) for k in ("R_est", "t_est"))
    log(f"ScanNet evaluate CLI {CLI_SMALL}: card poses {gap:.3e} from the CPU's (limit 1e-4)")
    if not gap <= 1e-4:
        raise AssertionError("the ScanNet poses on the card disagree with the CPU")
    out["card_vs_cpu"] = gap
    probe, wall = _train_cli(torch, ["--dataset", "ScanNet", "--data_root", root, "--keyframes",
                                     "1", "--batch_size", "4", "--image_resize",
                                     str(CLI_SMALL), "--epochs", "1", "--max_steps_per_epoch",
                                     "1", "--no_val", "--checkpoint_folder",
                                     os.path.join(workdir, "sn_logs"), "--device", str(dev)],
                             "ScanNet train CLI")
    (st,) = probe.steps
    log(f"ScanNet train CLI, B=4 at {CLI_SMALL}: loss {st['loss']:.6f}, launches "
        f"{st['launches']}, {st['ms']:.1f} ms, loader wait {probe.wait_s:.2f} s of {wall:.1f} s "
        f"(share {probe.wait_s / (probe.wait_s + st['ms'] / 1e3):.3f} of wait and step)")
    if not (np.isfinite(st["loss"]) and st["launches"] == TRAIN_LAUNCHES):
        raise AssertionError("the ScanNet train step failed")
    out["train"] = {"loss": st["loss"], "step_ms": st["ms"], "loader_wait_s": probe.wait_s,
                    "loader_wait_share": probe.wait_s / (probe.wait_s + st["ms"] / 1e3),
                    "wall_s": wall}
    return out


def phase_debug_nan(torch, dev, root, workdir):
    """Phase 56: the train CLI with ``--debug_nan`` on a NaN batch must
    raise naming a module; nothing else counts as a pass."""
    from deep_prob_feature_track_torch.apps import train
    from deep_prob_feature_track_torch.training import train as T
    from deep_prob_feature_track_torch.utils.debug import NonFiniteError

    to_device = T.to_device

    def nan_depth(batch, device):
        out = to_device(batch, device)
        out["depth0"][0] = float("nan")
        return out

    T.to_device = nan_depth
    try:
        train.main(["--data_root", root, "--keyframes", "1", "--batch_size", str(B),
                    "--image_resize", str(CLI_SMALL), "--epochs", "1",
                    "--max_steps_per_epoch", "1", "--no_val", "--debug_nan",
                    "--checkpoint_folder", os.path.join(workdir, "nan_logs"),
                    "--device", str(dev)])
    except NonFiniteError as e:
        message = str(e)
    else:
        raise AssertionError("--debug_nan let a NaN batch through")
    finally:
        T.to_device = to_device
    log(f"--debug_nan on a NaN batch: {message}")
    if "module" not in message:
        raise AssertionError(f"--debug_nan named no module: {message}")
    return {"error": message}


def phase_final(torch, dev):
    """Phases 51-56 in a temporary directory, removed after."""
    import shutil

    workdir = tempfile.mkdtemp(prefix="dpft_final_")
    try:
        t0 = time.monotonic()
        out = {"accum": phase_accum(torch, dev), "guard": phase_guard(torch, dev)}
        seq = os.path.join(workdir, "seq")
        write_tum_sequence(seq, n=DENSE_FRAMES)
        out["two_ranks"] = phase_two_ranks(torch, dev, workdir, seq)
        root = _trainval_root(workdir, seq)
        out["distributed_cli"] = phase_distributed_cli(torch, dev, root, workdir)
        out["scannet"] = phase_scannet(torch, dev, workdir)
        out["debug_nan"] = phase_debug_nan(torch, dev, root, workdir)
        out["wall_s"] = time.monotonic() - t0
        log(f"phases 51-56 (accumulation, guard, data parallel, sharded BA, ScanNet, "
            f"--debug_nan) in {out['wall_s']:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def profile(torch, fn, label):
    """Device busy time, span, idle share, launch count, launches by kernel
    name and the top kernels of one call of ``fn`` after three warm-up
    calls (``torch.profiler``)."""
    kernels = traced_kernels(torch, fn, warmup=3)
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    launches_by_kernel = {}
    for k, (_, n) in sorted(by_name.items()):
        launches_by_kernel[k[:160]] = launches_by_kernel.get(k[:160], 0) + n
    out = {
        "device_busy_ms": busy, "device_span_ms": span, "idle_share": 1.0 - busy / span,
        "kernel_launches": len(kernels),
        "top": [{"name": k[:80], "ms": ms, "count": n} for k, (ms, n) in top],
        "launches_by_kernel": launches_by_kernel,
    }
    log(f"profile of one {label}: device busy {busy:.3f} ms over a {span:.3f} ms span "
        f"(idle share {out['idle_share']:.3f}), {len(kernels)} kernel launches")
    return out


def phase_profile(torch, dev):
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch

    net = build_tracker("feature", device=dev)
    batch = example_batch(B, H, W, seed=2, device=dev)
    with torch.inference_mode():
        return profile(torch, lambda: net(*batch), "B=8 forward")


def main(argv) -> int:
    import torch

    time_only = argv == ["--time"]
    rank_worker = len(argv) == 5 and argv[0] == "--rank"
    if argv and not (time_only or rank_worker):
        print("usage: chip_smoke.py [--time]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    try:
        from deep_prob_feature_track_torch.device import set_float32_policy
        from deep_prob_feature_track_torch.ops.kernels import loader
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})", file=sys.stderr)
        return 1

    if rank_worker:  # one of phases 53-54's ranks, started by phase_two_ranks
        return two_rank_worker(int(argv[1]), int(argv[2]), argv[3], argv[4])
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    set_float32_policy()
    if time_only:  # phases 1, 2, 17 and 18: to compare two trees in one call
        t0 = time.monotonic()
        build_kernels(loader)
        print(json.dumps({**measure(torch, dev, name), "card": smi}), flush=True)
        log(f"done in {time.monotonic() - t0:.1f} s")
        return 0
    kernels = run(torch, loader, dev, name, smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def build_kernels(loader):
    t0 = time.monotonic()
    paths = loader.build()
    log(f"built {sorted(paths)} in {time.monotonic() - t0:.1f} s")
    for source in sorted(paths):
        for line in (loader.BUILD_DIR / f"{source}.log").read_text().splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"ptxas {source}: {line.strip()}")


def measure(torch, dev, name, train_steps=True):
    """The time phases (17, 18): each kernel per level beside its plain
    version, library call and bound, the profiled forwards and, with
    ``train_steps`` (the full run's train phases time them already), the
    train steps."""
    timing = phase_time(torch, dev, name)
    grads_levels, vga_splat = phase_time_grads(torch, dev, name)
    tiles_levels = phase_time_tiles(torch, dev, name)
    jtj_levels = phase_time_jtj(torch, dev, name)
    timing["profile"] = phase_profile(torch, dev)
    return {"timing": timing, "grads_levels": grads_levels, "jtj_levels": jtj_levels,
            "tiles_levels": tiles_levels, "vga_splat_level0": vga_splat,
            "vga_forward": phase_forward(torch, dev, H_VGA, W_VGA),
            "channels_levels": phase_time_channels(torch, dev, name),
            "preset_forwards": {p: phase_forward(torch, dev, H, W, p)
                                for p in ("feature_icp", *CLASSICAL_LAUNCHES, "DeepIC")},
            "feature_icp_vga_forward": phase_forward(torch, dev, H_VGA, W_VGA, "feature_icp"),
            "deepic_k1_folded_level0": phase_time_deepic(torch, dev, name),
            "ufc_levels": phase_time_ufc(torch, dev, name),
            "ufc_forwards": {config_name("feature", o) + f" {h}x{w}": phase_forward(
                torch, dev, h, w, overrides=o)
                for o, h, w in ((UFC, H, W), (UFC, H_VGA, W_VGA), (UFC_WIDE, H, W))},
            "variant_forwards": {config_name(p, o): phase_forward(torch, dev, H, W, p, o)
                                 for p, o in VARIANT_TIMED},
            "train_steps": {config_name(p, o): phase_step_time(torch, dev, p, o)
                            for p, o in (("feature", ()), ("feature_icp", ()), ("DeepIC", ()),
                                         ("feature", UFC), ("feature", UFC_MEST))
                            if train_steps}}


def run(torch, loader, dev, name, smi):
    """Every phase on ``dev``; prints the measurements as one JSON line and
    returns the ``kernels`` record."""
    t_start = time.monotonic()
    build_kernels(loader)

    errors = phase_kernels(torch, dev)
    errors.update(phase_grads_kernels(torch, dev))
    errors.update(phase_tiles_kernels(torch, dev))
    for k, e in phase_flat_kernels(torch, dev).items():
        errors[k] = max(errors[k], e)
    launches, items = phase_serve(torch, dev, H, W, SERVE_LAUNCHES)
    phase_agree(torch, dev, items, n_cpu=B)
    icp_launches, icp_items = phase_serve(torch, dev, H, W, ICP_SERVE_LAUNCHES, "feature_icp")
    presets = {"feature_icp": phase_agree(torch, dev, icp_items, B, "feature_icp", PRESET_ATOL,
                                          ICP_SERVE_LAUNCHES)}
    for preset, expected in CLASSICAL_LAUNCHES.items():
        presets[preset] = phase_agree(torch, dev, items, B, preset, PRESET_ATOL, expected)
    train = phase_train(torch, dev, B_TRAIN, H, W, TRAIN_SEED, TRAIN_LAUNCHES)
    icp_train = phase_train(torch, dev, B_TRAIN, H, W, TRAIN_SEED, ICP_TRAIN_LAUNCHES,
                            "feature_icp")
    vga_launches, vga_items = phase_serve(torch, dev, H_VGA, W_VGA, VGA_SERVE_LAUNCHES)
    phase_agree(torch, dev, vga_items, n_cpu=N_CPU_VGA)
    presets["feature_icp_vga"] = phase_agree(torch, dev, vga_items, 0, "feature_icp",
                                             PRESET_ATOL, ICP_VGA_LAUNCHES)
    vga_train = phase_train(torch, dev, B_VGA_TRAIN, H_VGA, W_VGA, VGA_TRAIN_SEED,
                            VGA_TRAIN_LAUNCHES)
    scene_shares = phase_scene_share(torch, dev)
    for k, e in phase_deepic_kernels(torch, dev).items():
        errors[k] = max(errors[k], e)
    deepic_launches, deepic_items = phase_serve(torch, dev, H, W, DEEPIC_SERVE_LAUNCHES,
                                                "DeepIC")
    presets["DeepIC"] = phase_agree(torch, dev, deepic_items, B, "DeepIC", PRESET_ATOL,
                                    DEEPIC_SERVE_LAUNCHES)
    deepic_train = phase_train(torch, dev, B_TRAIN, H, W, TRAIN_SEED, DEEPIC_TRAIN_LAUNCHES,
                               "DeepIC")
    ufc_errors, ufc_k4_shares = phase_ufc_kernels(torch, dev)
    for k, e in ufc_errors.items():
        errors[k] = max(errors[k], e)
    ufc_launches, ufc_items = phase_serve(torch, dev, H, W, UFC_SERVE_LAUNCHES, overrides=UFC)
    presets["U_FC"] = phase_agree(torch, dev, ufc_items, B, "feature", PRESET_ATOL,
                                  UFC_SERVE_LAUNCHES, overrides=UFC)
    presets["U_FC_vga"] = phase_agree(torch, dev, vga_items, 0, "feature", PRESET_ATOL,
                                      UFC_VGA_LAUNCHES, overrides=UFC)
    # no CPU forward: with the feature sigma (near zero in places at an
    # untrained init) the float32 forward amplifies rounding, 2.9e-4 on t
    # between float32 and float64 on the CPU
    presets["U_FC_feature_sigma"] = phase_agree(torch, dev, items, 0, "feature", PRESET_ATOL,
                                                UFC_WIDE_LAUNCHES, overrides=UFC_WIDE)
    ufc_train = phase_train(torch, dev, B_TRAIN, H, W, TRAIN_SEED, UFC_TRAIN_LAUNCHES,
                            overrides=UFC)
    ufc_mest_train = phase_train(torch, dev, B_TRAIN, H, W, TRAIN_SEED, UFC_MEST_TRAIN_LAUNCHES,
                                 overrides=UFC_MEST)
    cli = phase_cli(torch, dev)
    obj_errors, obj_kernel_rows = phase_objmask_kernels(torch, dev, name)
    for k, e in obj_errors.items():
        errors[k] = max(errors[k], e)
    objects = {"kernel_times": obj_kernel_rows, **phase_objects(torch, dev)}
    for k, e in phase_variant_kernels(torch, dev).items():
        errors[k] = max(errors[k], e)
    t0 = time.monotonic()
    variants = phase_variants(torch, dev, items, vga_items)
    log(f"phases 40-45 (the tracker options) in {time.monotonic() - t0:.1f} s")
    ba = phase_ba(torch, dev)
    final = phase_final(torch, dev)
    m = measure(torch, dev, name, train_steps=False)
    print(json.dumps({**m, "train": train, "vga_train": vga_train,
                      "feature_icp_train": icp_train, "feature_icp_serve_launches": icp_launches,
                      "deepic_train": deepic_train, "deepic_serve_launches": deepic_launches,
                      "ufc_train": ufc_train, "ufc_mest_train": ufc_mest_train,
                      "ufc_serve_launches": ufc_launches, "ufc_k4_staged_share": ufc_k4_shares,
                      "preset_agree": presets, "scene_staged_share": scene_shares,
                      "vga_serve_launches": vga_launches, **cli, "objects": objects,
                      "variants": variants, "ba": ba, "final": final, "card": smi}),
          flush=True)

    # K1 and K6 as the 120x160 serve path launched them, K2 and K3 as the
    # 120x160 train path did; K4 as the 480x640 serve path, K5 as the 480x640
    # train path did
    level0 = {**m["timing"]["levels"][0], **m["grads_levels"][0],
              **{row["kernel"]: row for row in m["tiles_levels"]
                 if row["level"] == 0 and row["c"] == C_WARP and row["coords"] == "smooth"}}
    launches.update({k: train["launches"][k] for k in ("gather_twohot_grads", "splat_twohot")})
    launches["gather_tiles"] = vga_launches["gather_tiles"]
    launches["gather_tiles_grads"] = vga_train["launches"]["gather_tiles_grads"]
    kernels = []
    for kname in TPU_SOURCES:
        k = level0[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"deep_prob_feature_track_torch/ops/kernels/csrc/{loader.SOURCES[kname]}.cu",
            "replaces": TPU_SOURCES[kname],
            "launches": launches[kname],
            "max_abs_err": errors[kname],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    log(f"done in {time.monotonic() - t_start:.1f} s")
    return kernels


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
