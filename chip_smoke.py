#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--gaussians 1000000] [--views 4]
                          [--train_points 300000] [--iterations 60]
                          [--probe_rows 3232768]

The serving path:

1. Device and build: the card's name and power limit, torch/CUDA versions,
   and the nvcc build of every kernel in gaussian_transformer_tpu_torch/csrc
   (into build/torch_kernels/, one nvcc per source, all at once).
2. A seeded synthetic trained-looking scene (1,000,000 Gaussians at SH
   degree 3 on a few surfaces) written as a trained model dir with a
   Blender-layout dataset of 1920x1080 test views; the ground truth is the
   port's own render plus N(0, 0.05) noise.
3. Kernel checks on one main-path view: K1 (stream compositor forward) and
   K3 (fused SSIM forward) against their plain PyTorch versions; exact
   checksums of K1's outputs and K3's mean (equal checksums: equal bits),
   and K1's warp
   steps and uniform-skip steps counted by the plain walk with K1's 8x4
   warp map to the runs' real ends.
4. The main path: ``cli.render`` then ``cli.metrics`` through their
   ``main(argv)``, with the kernel launch counters zeroed just before and
   read just after; checks overflow, SSIM, and the PSNR against a numpy
   recomputation from the written PNGs.
5. Times (CUDA events) of K1 and K3 (over repeated launches, and with the
   L2 cache flushed before each launch) and their plain versions, K3's
   launch-only time (its C entry point on prepared inputs), the per-view
   render time, each kernel's bound, and K1's time per warp step; a forward
   and a backward through ``fused_ssim`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation).

The training path:

6. A Blender-layout training dataset of the same scene: 8 train and 2 test
   1920x1080 orbit views (ground truth: the port's renders, written with its
   PNG codec) and a ``points3d.ply`` of 300,000 points sampled from the same
   surfaces with jitter and their DC colours.
7. The main path: ``cli.train`` through ``main(argv)`` for 60 steps at full
   resolution with one densify/prune pass at step 40, counters zeroed just
   before and read just after; checks K2 and K4 ran once per step, the loss
   is finite and falls, the densify pass changed the alive count, the PLY and
   checkpoint exist and restore, and ``cli.render`` + ``cli.metrics`` score
   the trained model.
8. Kernel checks on train view 0 from the first step's state (the point
   cloud's Gaussians at 4x capacity) at the render budgets the trainer tuned
   (so the chunk size and stream length of the main path's K2 launches):
   K2 (stream compositor backward, fed the loss's true cotangents) and K4
   (fused SSIM backward on the render/GT pair) against their plain versions;
   K1's checksum on that view and the checksum of K4's two gradients.
9. Times: the median train step (steps 11-60 without the densify step) split
   into forward, loss, backward and Adam, and the host synchronisations of
   one step by call site; K2 and K4 and their plain versions with their
   bounds, K4's launch-only time; the rows per tile K2 walks (max, median,
   p99).

The table path (``RenderConfig(use_stream=False)``: ``bin_gaussians`` and the
[T, K] table compositor, kernels K5 and K6):

10. Serving: the test views of the 1M scene rendered through ``render()``,
    each with ``max_per_tile`` the smallest multiple of 32 at or above its
    largest per-tile instance count (from a probe binning), counters zeroed
    just before and read just after; checks K5 ran once per view and nothing
    overflowed. Then K5 against its plain version on view 0, its checksum
    and its warp steps (as K1's in section 3), the table render against the
    stream render of the same view (so K5 against K1), and the times: the
    render by stage (project, bin, table build, K5), K5, plain K5, bound,
    time per warp step.
11. Training: a ``Scene`` of section 6's dataset trained by
    ``train/splat.py training()`` for 60 steps with ``max_per_tile`` from
    probe binnings of every train view (+25%); checks K6 ran once per step
    and K5 once per step and probe render, the loss falls, and prints the
    overflow of every step.
12. K6 against its plain version on train view 0 from the first step's
    state at the trainer's budgets, on the loss's true cotangents (K5's
    checksum on that view); times of
    the median table train step by phase, K6, plain K6, bound; the rows per
    tile K6 walks.

The transposed-layout stream path (``attic.stream_t.stream_image_t``: the
stream as planes [16, I_pad], kernels K7 and K8) and the layout probe (K9):

13. Serving: the test views of the 1M scene through ``prepare_stream`` +
    ``stream_image_t``, counters zeroed just before and read just after;
    checks K7 ran once per view, K7 against its plain version and the view-0
    image against the stream ``render()`` (K1's rule); K7's checksum, its
    warp steps (the plain walk in screen coordinates, K1's 8x4 warps, to the
    runs' real ends) and the rows it walks at most against the rows in the
    runs. Times K1 and K7 in turns on the same stream (and the row and
    transposed paths from the gather to the image), the transposed copy,
    plain K7, the bound, SM cycles per warp step, K7's ptxas report.
14. Gradients: train view 0 at the first step's state and the trainer's
    budgets (section 8's inputs); one backward of the trainer's loss
    through ``stream_image_t`` (K8 once), the Gaussians' screen-space
    gradients against those through ``stream_image`` (K2), K8 against its
    plain version on the loss's true cotangents (K2's rule), K8's checksum
    and rows; K2 and K8 timed in turns, plain K8, the bound, K8's ptxas
    report, and K6's time on its own inputs (section 12b) for reference.
15. The layout probe through ``tools.layout_probe.main`` at N = 3,232,768
    rows (the four layouts of the reference's probe), counter zeroed just
    before and read just after; K9 against its plain version on each layout
    (1e-6 relative); times, GB/s, ``torch.sum``'s time, the bound (bytes /
    3.35 TB/s) and the extra bytes allocated.

The stacked Gaussian-sequence transformer at full width (STACK 8: token dim
and d_model 26 * 2^8 = 6656, N 2, h 8, 1,905,446,400 float32 parameters).
These sections run after the device line and sections 19-22 (which open
no profiler window), before the others, so that no torch.profiler window
precedes their timings (a window leaves the host's launches slower for the
rest of the process):

16. A seeded synthetic scene of 17,618 Gaussians at SH degree 1 (the stacked
    campaign scene's count) written as a trained model dir with a
    Blender-layout dataset of 32 ring cameras at 320x240; the first batch of
    ``train.stacked.TrainingScene`` (batch 4, bucket 16, epoch 0) and its
    lengths in fat tokens; the model from seed 0 (its parameter count
    checked against the closed form and the campaign's); ``decode_step`` fed
    the scan decode's prefix (teacher-forced) against the decoder's rows, and
    ``greedy_decode_cached`` free-running against ``greedy_decode``; the
    cached decode timed 20 times one by one (CUDA events; median, min, max)
    beside its weight-bytes bound per token, and the scan decode's time per
    window. Last of all (16b), the same model again: one cached decode under
    ``torch.profiler`` (kernels a token, device idle share), then 20 more
    timed decodes.
17. The main path: ``cli.train_stacked`` through ``main(argv)`` for one
    epoch (8 steps at batch 4 over 32 cameras), counters zeroed just before
    and read just after; checks K1 ran once per camera's visibility render
    (and 8 times per image-branch step), every loss and chamfer is finite,
    and every parameter moved but the attention key biases; the median step
    (CUDA events), the peak memory, and one more step's matmul FLOPs
    (``FlopCounterMode``) against the float32 non-tensor peak. Before those
    two (17b), one train step of the trained state whose target is the
    model's own decode under the step's dropout key plus N(0, 0.01), so the
    chamfer gate opens: counters zeroed just before and read just after (K1
    8, K2 4, K3 1, K4 1), its time (CUDA events), its peak memory, and
    whether the parameters stayed finite.
18. The image branch: ``train.stacked.image_loss`` on the first batch's
    target tokens with pred = target + N(0, 0.01), and its backward,
    counters zeroed just before and read just after (K1 8, K2 4, K3 1, K4
    1); the target renders do not overflow, the gradient reaches the
    predicted tokens finite and nonzero (zero on PAD rows), and the loss and
    the gradient agree with the same call on CPU copies (the plain versions
    of K1-K4). Each kernel against its plain version on this call's card
    tensors, at its own rule's tolerance: K1 on camera 0's target render, K2
    on camera 0's pred render with the loss's true cotangents of its
    compositor outputs, K3 and K4 on the four pred and target images at
    SSIM's cotangent. The K1-K4 entries of the kernels line carry the
    launches of the epoch, one open-gate step and this call as
    ``stacked_launches``. Sections 16-18 print the peak memory of each, as
    do sections 19-22; the kernels line carries the launches of section 19's
    runs as ``flat_launches`` and of section 21's as ``autoencoder_launches``.

The flat masked-Gaussian trainer at full width (d_model 1024, N 6, h 8,
120,851,482 float32 parameters, blockwise attention with 256-key blocks),
the Gaussian autoencoder and LPIPS. These sections run before the stacked
ones, so that no profiler window precedes their timings either:

19. A seeded synthetic scene of 24,000 Gaussians at SH degree 1 written as a
    trained model dir with a Blender-layout dataset of six 960x540 training
    cameras inside the ground disk looking outward, each of which sees
    between 5,000 and 15,000 Gaussians (one at least 12,000); the main path:
    ``cli.train_transformer`` through ``main(argv)`` for one epoch in a work
    directory, counters zeroed just before and read just after; per step the
    camera, n_src, n_tgt, the loss and its parts, the renders' overflow, the
    launches (K1 2, K2 1), the CUDA-event ms and the peak memory; checks the
    parameter count against the closed form and 120,851,482, finite losses,
    and ``best_model.npz`` with one array per parameter. Then (19b) one more
    step with ``GT_LPIPS_WEIGHTS`` at a seeded random alex npz in the
    converter's layout (the LPIPS term in the loss), and (19c) one
    ``make_flat_loss`` call on the longest camera's batch, the model standing
    in as its own teacher-forced prediction, on the card against the same
    call on CPU copies (the plain versions of K1 and K2).
20. ``greedy_decode_flat`` of the trained model for 32 tokens from the
    longest camera's source: ms a token (median of 5 decodes) and the
    encoder's ms alone.
21. ``cli.train_autoencoder`` on a 2-camera dataset of section 19's scene
    with ``--epochs 502 --lr_sweep_start 20 --lr_sweep_stop 21``, as the
    scalar stub and with ``--conv``: epochs 0-500 the token L1, epoch 501
    the image loss; counters zeroed just before each run and read after
    every step (an image step K1 3, K2 1, K3 1, K4 1; a token step K1 1);
    finite losses, the wall time, the steps' CUDA-event ms; the conv
    model's reconstruction on the card against its CPU copy (1e-5 of its
    largest value), and one ``image_loss`` of the conv model on the card
    against its CPU copy (the plain versions of K1-K4) with the card's
    reconstruction fed to both: the renders drop instances past their
    stream budget, so a float-rounding change of the reconstruction can
    change which are dropped.
22. LPIPS alex and vgg on seeded random weights at 1920x1080 on the card
    against the CPU (1e-5 relative), and their ms.

The stacked campaign's recipe at full width (``tools/stacked_campaign.py``:
STACK 8, d_model 6656, N 2, bf16 ``dtype`` and ``param_dtype``, Adafactor,
bucket 96). It runs after sections 19-22 and before 16-18, so that no
profiler window precedes its timings and no float32 model is alive:

24. ``tools.stacked_campaign.main`` for one epoch (8 steps at batch 4 over
    the 32 ring cameras of the synthetic 17,618-Gaussian scene), counters
    zeroed just before and read just after; checks 1,905,446,400
    parameters, each parameter's dtype against the flax tree's (bf16 but
    the LayerNorms and the generator), finite losses, K1 once per camera's
    visibility render and 8 times per image-branch step; each step's
    CUDA-event ms, the median, the peak memory; the ``checkpoint_step8``
    the run saved read back into a fresh model bit for bit (parameters and
    Adafactor state); one more step's matmul FLOPs against the bf16 dense
    peak and the float32 peak. 24b: one open-gate bf16 step (its target the
    model's own decode plus N(0, 0.01)), counters zeroed just before and
    read just after (K1 8, K2 4, K3 1, K4 1), its time, and that step's
    image loss and token gradient on the card against the same call on CPU
    copies of the same decoded rows (the plain K1-K4). 24c: the bf16 cached
    decode teacher-forced against the bf16 scan decode's rows (2e-2 of the
    largest: bf16 rounding; beside it the share of a K projection's outputs
    that differ between one row at a time and all rows at once; a planted
    fault, K/V written one position late, must exceed it), the K/V
    caches' dtype, and its ms a token
    (20 decodes) beside its weight-bytes bound. The kernels line carries
    the launches as ``campaign_launches``.

The quality gate's chain (``tools/full_gate.py``), cut to 3,100 iterations,
with a kill and a resume; it runs last:

23. The gate's COLMAP text dataset at its full shape: a 200,000-Gaussian
    ground truth (``tools/synthetic.py synthetic_scene``) rendered from 28
    ring cameras at 1280x720, a 10,000-point seed. ``cli.train --sh_degree 3
    --densify_grad_threshold 0.0001`` through ``main(argv)`` to iteration
    1,600 with ``--orbax_every 800``, then again on the same model dir to
    3,100 with ``--orbax_every 1000 --save_iterations 3000 3100`` (counters
    zeroed before each run and read after); then ``cli.render`` and
    ``cli.metrics``. Checks: run 2 prints ``resumed from orbax step 1600``
    and logs 1601 first; the snapshots at 1600, 2000 and 3000 carry active
    SH degree 1, 2 and 3 (``meta[2]``) and the newest three are kept; the
    PLY of iteration 3000, saved after the opacity reset, has every
    ``sigmoid(opacity) <= 0.01``; the six densify passes grew the alive
    count past the seed; K2 and K4 ran once per step; every loss is finite;
    the test PSNR equals its numpy recomputation from the PNGs (1e-3 dB).
    Prints the passes and the capacity doublings, the overflowed steps, the
    final size, the test PSNR, the median step by phase and the wall time of
    each stage; the kernels line carries the launches as ``gate_launches``.

The bf16 property stream (``RenderConfig(precision="bf16")``: the stream's
rows shifted into their tile's frame and rounded to bf16, kernels K1.bf16
``stream_fwd_bf16`` and K2.bf16 ``stream_bwd_bf16``) and the non-Pallas
compositor (``use_pallas=False``, ``render/composite.py``); they run after
section 15:

25. Serving: the test views of the 1M scene through ``render()`` in bf16,
    counters zeroed just before and read just after; checks K1.bf16 ran
    once per view and the float32 K1 not at all, no overflow, and view 0
    against the float32 render at PSNR > 40 dB (the JAX package's bf16
    rule; the max abs diff printed beside its atol 0.03). K1.bf16 against
    its plain version on the same bf16 rows (K1's rule) and its largest
    difference from K1 on the float32 rows (printed); K1.bf16 and K1 timed
    in turns, plain K1.bf16, the renders in turns, the rows' rounding, the
    bound (``utils/roofline.py``, 32 B a row).
26. Training: a ``Scene`` of section 6's dataset trained by
    ``training()`` in bf16 for 60 steps; checks K2.bf16 ran once per step,
    K1.bf16 once per step and probe render, the float32 K1/K2 never, the
    loss finite and falling, and prints the overflow and
    ``device_memory_stats()``. On section 8's inputs: K2.bf16 against its
    plain version on the loss's true cotangents (K2's rule); the trainer's
    loss's gradients in bf16 against float32 (printed beside the JAX
    package's 0.12 / 97% rule); K2.bf16 and K2 timed in turns, plain
    K2.bf16, and ``utils/roofline.step_report`` of the float32 step
    (section 9's median) and the bf16 step, each stage with its measured
    time where one is taken.
26b. ``use_pallas=False``: test view 0 of the 1M scene at section 10's
    ``max_per_tile`` against K5's render (K1's rule), its time and peak
    memory; the trainer's loss's gradients on section 12's inputs against
    those through K5/K6 (K2's rule), the backward's time and peak memory.
27. Last of all (a profiler window slows the host's launches for the rest
    of the process): ``utils/profiling.trace`` around one bf16 render;
    checks one Chrome trace was written and names the ``stream_fwd_bf16``
    kernel; prints ``device_memory_stats()``.

The kernels line carries K1.bf16 and K2.bf16 (``stream_fwd_bf16``,
``stream_bwd_bf16``) with their launches in sections 25 and 26.

The multi-device tier (``gaussian_transformer_tpu_torch/parallel/``) at
world size 1 under NCCL, in this process's own process group (destroyed
at the end); the card's machine has one card, so these sections check the
backend, the collectives on CUDA tensors, FSDP2 at full width and K1-K4
through the sharded paths, not scaling:

28. After section 8, on its state (the point cloud's Gaussians at 4x
    capacity) and train views 0-1 at 1080p, budgets tuned to the unculled
    binning every form uses: one step each of ``make_sharded_train_step``'s
    batched (``mesh=None``), manual (data 1 x gauss 1) and tile-sharded
    forms and the batched one again (the card's run-to-run difference); the
    manual and tile-sharded steps held to the batched step (the JAX test's
    bounds; parameters wherever the gradient is above float noise), K1-K4
    twice a step, ``render_tile_sharded`` against ``render()`` (2e-5), the
    manual step's collectives (``parallel/audit.py``: 7 all-gathers a view,
    no raw parameter); each step's ms.
29. After section 18, on its model and first batch: ``make_dp_train_step``
    under FSDP2 on a (data 1, fsdp 1) mesh against ``make_train_step`` on
    the same window and dropout key (loss 1e-5 relative, parameters 1e-2 x
    lr), their ms and peak memory; then (29a) ``cli.train_stacked --dp 1
    --fsdp 1`` for one epoch at one layer. 29b: ``cli.train_stacked --fsdp
    1 --orbax`` at full width and one layer (1,107,817,984 parameters) for
    two epochs to a snapshot at epoch 1, then again on the run dir: it resumes at epoch 2,
    every parameter and Adam moment (and the step count) equal to the
    first run's, gathered whole, bit for bit, and the snapshot restores
    into an unsharded model likewise; the snapshot's bytes, the ms the save
    held training, the write's and the restores' seconds, the disk's free
    bytes before the write and the host's available memory; the run dir is
    removed.
30. After section 22, on section 19's scene: a full-width flat loss and
    backward with ``ring_attention`` over a one-rank group against the same
    with blockwise attention (loss 1e-5 relative, gradients 1e-4 of the
    largest), their ms and peak; ``ulysses_attention`` and the ring on q/k/v
    of the main path's shape against blockwise attention (1e-5 of the
    largest); a heartbeat.

The kernels line's K1-K4 entries carry these runs' launches as
``tier_launches`` (29b's two runs as ``stacked_cli_fsdp_orbax`` and
``stacked_cli_fsdp_orbax_resume``).

The viewer bridge (``viewer/network_gui.py``), the native IO tier
(``native/``) and ``cli.full_eval``:

31. After section 26b: a SIBR client thread over 127.0.0.1 asks
    ``network_gui.pump`` for 20 frames of section 2's scene at 1920x1080
    (the test views, scaling modifiers 1 and 0.5); checks each frame equals
    ``image_to_bytes(render(...))`` of its camera and names the source
    path, and K1 ran once a frame; the ms a frame from the request sent to
    the last byte received, beside the render alone. 31b: ``cli.train`` on
    section 6's dataset with ``--port`` for 30 iterations, a client asking
    for 20 frames (train=True); the loss falls, the frames arrive whole.
    31c: with the listener bound and no client, one train step of section
    7's checkpoint with and without a pump before it: the same host
    synchronisations by call site and the same kernel launches in each of
    ``STEP_KERNEL_REPEATS`` steps (the host's launch calls; the profiler's
    device events vary between identical steps, printed beside them).
32. After section 29, on a fresh model of section 16's weights and its
    first batch: ``pump_stacked`` with train=False streams the cached
    decode, one frame a token, each equal to ``LiveViewerStream.compose``
    of the same carry (K1 once a frame); (32a) a train=True tick serves the
    teacher-forced composite and leaves ``model.training`` True; the ms a
    streamed frame beside section 16's cached decode ms a token. 32b: the
    same on a fresh model under FSDP2 (a one-rank mesh), served by the
    collective pump (``pump_stacked(..., group=)`` on a gloo group): each
    streamed frame and the train-mode frame against section 32's within
    2e-5, K1 once a frame, ``model.training`` True after; the ms a frame
    beside section 32's; with the listener bound and no client, the pump
    alone makes no host synchronisation and launches no kernel, and one
    train step with and without the pump before it makes the same host
    synchronisations by call site (the kernels printed, of a second step
    without the pump too: an FSDP2 step's own count varies between runs).
33. The machine's libjpeg/libpng/g++ probe, the tier's build (PNG with its
    own decoder), its readers against the
    Python ones bit for bit on a COLMAP binary model of section 6's views
    (images.bin, points3D.bin, the PNG decode) and on
    section 2's PLY (read and write), each timed; the COLMAP folder through
    ``Scene``. 33b: ``cli.full_eval --skip_training`` over synthetic roots,
    one scene per list, its renders and metrics in child processes on the
    card; PSNR against a numpy recomputation.
34. JPEG scenes: the tier's own JPEG decoder (``native/jpeg.cpp``) on a
    machine without libjpeg: ``codecs()`` and ``missing()``; every
    committed JPEG (``native/testdata/jpeg``: 8 views at 960x540, baseline,
    progressive, restart markers, 4:4:4, and a 1080p view; PR 15's
    ``fixture.jpg``) decodes to the sha256 recorded from libjpeg; the
    1080p file on one thread (median of 21 calls, ms and MP/s) and the
    8-view folder on the pool (images/s), beside the host's CPU count; a
    COLMAP model written around the committed views loads through
    ``Scene`` on the card with each camera's image equal to the
    digest-checked decode; ``cli.train`` trains it for 300 steps with
    ``--eval`` off and the PSNR on the training views must rise.
35. Every image the JAX package reads: whether ``png.h``, ``zlib.h`` and
    ``jpeglib.h`` exist here, ``codecs()`` ``['jpeg', 'png']`` from a
    build command with no ``-lpng``, ``-lz`` or ``-ljpeg``; every committed
    PNG (``native/testdata/png``: a Blender scene of 800x800 RGBA views,
    one Adam7, one palette + tRNS; a 1080p view; small files of every PNG
    mode) in both outputs (RGB, RGBA) and every JPEG mode file
    (``native/testdata/jpeg_modes``: arithmetic, 4:4:0, 4:1:1, 3x1, no
    DHT, block smoothing) against the digests of libpng, Pillow and
    libjpeg; the Blender scene through ``Scene`` at ``-r 1`` and ``-r 2``
    with each camera's image at the digest of the JAX reader's composite
    and Pillow resize; ``cli.train`` on it for 300 steps with ``--eval``,
    the PSNR on its training views rising; times: the 1080p PNG on one
    thread in the tier and in ``utils/png.py``, the Blender folder on the
    pool (images/s), ``image_to_array``'s resize of a 1080p view.
36. The COLMAP conversion driver, ``cli.convert``, on a machine without
    ImageMagick or colmap, with Pillow's import blocked while it runs
    (the machine has a Pillow; the port must not need it): a capture of
    the 8 committed 960x540
    views in ``input/`` converted with ``--resize`` through a stand-in
    colmap (a script written into the work dir, never part of the package:
    it records its arguments, copies ``input/`` to ``images/`` and writes
    the PINHOLE model where COLMAP's stages leave theirs), and a
    resize-only capture (``--skip_matching --resize``) of ``1080p.jpg``,
    ``1080p.png`` and the PNG mode files; the recorded commands against
    the root script's, ``sparse/0`` against the model, every
    ``images_2/4/8`` file against the digests of the root script's Pillow
    output (``native/testdata/convert/digests.json``); the conversion's
    time (images/s) and ``1080p.jpg``'s pyramid (ms, by stage); then
    ``cli.train -i images_2 --eval`` for 300 steps, ``cli.render`` and
    ``cli.metrics``, the test view's PSNR rising.

The kernels line's K1-K4 entries carry the launches of sections 31-32 as
``viewer_launches`` (32b's as ``stream_fsdp`` and ``teacher_forced_fsdp``)
and those of section 34's, 35's and 36's ``cli.train`` (36: with its
``cli.render`` and ``cli.metrics``) as ``jpeg_launches``,
``image_launches`` and ``convert_launches``.

Every timed section prints the SM clock (``nvidia-smi --query-gpu=clocks.sm``)
before and after its window. The K3, K4, K7 and K8 entries of the kernels
line carry the registers, spills and static shared memory ``nvcc -Xptxas
-v`` reported (the build log the loader keeps).

The last three lines of standard output are the kernels JSON line, the
card's ``name, power.limit`` as nvidia-smi prints them, and
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
those lines. Without a CUDA device, or outside a checkout of the repo, it
exits non-zero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import random
import shutil
import struct
import subprocess
import sys
import time
from argparse import Namespace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
if (ROOT / "gaussian_transformer_tpu_torch" / "__init__.py").exists():  # else main() exits non-zero
    sys.path.insert(0, str(ROOT))
    # The seeded scene, the orbit cameras, the card's name line and the
    # K1-K4 launch counters, under the names this script has always given them.
    from gaussian_transformer_tpu_torch.tools.card import (  # noqa: F401
        kernel_counters,
        read_counts,
        smi_line,
        zero_counts,
    )
    from gaussian_transformer_tpu_torch.tools.synthetic import (  # noqa: F401
        camera_from_c2w,
        look_at_c2w,
        orbit_c2w,
        synthetic_scene,
    )
    # The card's peaks and the kernels' operation counts: the bounds are
    # defined in one place, utils/roofline.py.
    from gaussian_transformer_tpu_torch.utils import roofline
    from gaussian_transformer_tpu_torch.utils.roofline import (  # noqa: F401
        K1_OPS_PER_LIVE,
        K2_OPS_PER_LIVE,
        K3_OPS_PER_PIXEL,
        K4_OPS_PER_PIXEL,
        K6_OPS_PER_LIVE,
        PEAK_BF16_FLOPS,
        PEAK_BYTES_PER_S,
        PEAK_FP32_FLOPS,
        WALK_OPS_PER_PAIR,
    )
K1_ATOL = 2e-5
K1_MAX_ERR = 1e-3
K1_MAX_SHARE = 1e-4
K3_ATOL = 1e-5
# K2: a pixel whose T lands near 1e-4 may stop one contribution apart
# between the kernel's sequential product and the plain version's cumprod
# (K1's tolerance), which moves its rows' gradients; relative to the largest.
K2_MAX_ERR = 1e-3
K2_ATOL = 2e-4
K2_MAX_SHARE = 1e-4
K4_MAX_ERR = 1e-4  # relative to the largest gradient
K9_RTOL = 1e-6  # f32 block sums of positive data against the float64 plain version
# The JAX package's bf16 rules (tests/test_stream.py TestBF16Stream): the
# image's PSNR against the float32 render (gated), its atol and the
# gradients' rule (printed: set at 192 and 96 Gaussians).
BF16_MIN_PSNR = 40.0
BF16_IMAGE_ATOL = 0.03
BF16_GRAD_MAX = 0.12
BF16_GRAD_TIGHT = 0.97
LEAF_NAMES = ("xyz", "opacity", "scaling", "features_dc", "offset")
# The training table's max_per_tile: the largest probed count plus 25%.
TABLE_TRAIN_HEADROOM = 1.25
SH_C0 = 0.28209479177387814


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}")


def sm_clock() -> str:
    """The card's SM clock now, as nvidia-smi prints it (each timed section
    prints it before and after its window)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def print_clocks(before: str, section: str) -> None:
    print(f"clocks.sm around section {section}: before {before}, after {sm_clock()}")


def sm_cycles(ms: float, clock: str, steps: int) -> float:
    """SM cycles a warp step takes: ms on all SMs at ``clock`` (nvidia-smi's
    "1980 MHz", read before the window) over the kernel's warp steps."""
    import torch

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return ms * 1e-3 * float(clock.split()[0]) * 1e6 * n_sm / max(steps, 1)


def checksum(*tensors) -> str:
    """sha256 (first 16 hex digits) of the tensors' bytes: two runs whose
    outputs agree bit for bit print the same sum."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def warp_steps(name, steps) -> dict:
    """Prints and returns a forward kernel's (steps, uniform-skip steps), as
    the plain walk counts them with the kernel's 8x4 warps and row range."""
    n, u = steps
    print(f"{name} warp steps (8x4 warps): {n} ({32 * n} lane slots), uniform skips {u} ({u / max(n, 1):.3f})")
    return {"steps": n, "uniform_skips": u}


def ptxas_report(source: str) -> dict:
    """Registers, spill bytes and static shared memory of the kernel in
    ``source`` as ``nvcc -Xptxas -v`` reported them (the build log)."""
    import re

    from gaussian_transformer_tpu_torch import kernels

    log = kernels.library_path(source).with_suffix(".log").read_text()
    regs = re.search(r"Used (\d+) registers", log)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    smem = re.search(r"(\d+) bytes smem", log)
    return {"registers": int(regs.group(1)) if regs else None,
            "spill_store_bytes": int(spill.group(1)) if spill else None,
            "spill_load_bytes": int(spill.group(2)) if spill else None,
            "static_smem_bytes": int(smem.group(1)) if smem else 0}


def ssim_launch_only(img, gt):
    """K3's and K4's C entry points on the wrapper's own arguments, prepared
    once (no allocation, no counting): two closures."""
    import torch

    from gaussian_transformer_tpu_torch.ops import fused_ssim

    a, b, dims = fused_ssim._planes(fused_ssim._flatten(img), fused_ssim._flatten(gt))
    N, H, W = dims[:3]
    partials = torch.empty(N * -(-H // fused_ssim._TH) * -(-W // fused_ssim._TW), device=a.device)
    mean = torch.empty((), device=a.device)
    g = torch.ones(1, device=a.device)
    d1, d2 = torch.empty((N, H, W), device=a.device), torch.empty((N, H, W), device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    fwd, bwd = fused_ssim.SSIM_FWD.load(), fused_ssim.SSIM_BWD.load()
    return (lambda: fwd(a.data_ptr(), b.data_ptr(), *dims, partials.data_ptr(), mean.data_ptr(), stream),
            lambda: bwd(a.data_ptr(), b.data_ptr(), g.data_ptr(), 1.0 / (N * H * W), *dims,
                        d1.data_ptr(), d2.data_ptr(), stream))


def no_sync_ssim(img, gt) -> None:
    """A forward and a backward through ``fused_ssim`` with PyTorch's sync
    debug mode set to raise on any synchronising call."""
    import torch

    from gaussian_transformer_tpu_torch.ops import fused_ssim

    x = img.detach().clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused_ssim.fused_ssim(x, gt).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(x.grad).all()), "fused_ssim forward and backward make no host synchronisation")


# ---------------------------------------------------------------- scene ----


def write_model_dir(work: Path, scene, n_views, width, height, fovx, seed, device):
    """Blender-layout dataset + trained model dir; GT = render + N(0, 0.05)."""
    import torch

    from gaussian_transformer_tpu_torch.config import save_cfg_args
    from gaussian_transformer_tpu_torch.render import render
    from gaussian_transformer_tpu_torch.scene.ply import store_point_cloud
    from gaussian_transformer_tpu_torch.utils.png import write_png

    data, model = work / "data", work / "model"
    rng = np.random.RandomState(seed + 1)
    splits = {
        "train": [orbit_c2w(math.pi / 4)],
        "test": [orbit_c2w(2 * math.pi * i / n_views + 0.3) for i in range(n_views)],
    }
    for split, c2ws in splits.items():
        (data / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i, c2w in enumerate(c2ws):
            with torch.no_grad():
                img = render(camera_from_c2w(c2w, fovx, width, height, device), scene)["render"]
            noisy = np.clip(img.cpu().numpy().transpose(1, 2, 0) + rng.normal(0, 0.05, (height, width, 3)), 0, 1)
            write_png(str(data / split / f"r_{i}.png"), (noisy * 255).astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w})
        with open(data / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)
    store_point_cloud(str(data / "points3d.ply"), np.zeros((16, 3)), np.zeros((16, 3)))
    scene.save_ply(str(model / "point_cloud" / "iteration_30000" / "point_cloud.ply"))
    save_cfg_args(str(model), Namespace(
        sh_degree=3, source_path=str(data), model_path=str(model), images="images",
        resolution=1, white_background=False, data_device=str(device), eval=True,
    ))
    return model, splits


def surface_points(n: int, seed: int):
    """A point cloud of the synthetic scene's surfaces: n points with
    N(0, 0.01) jitter and their DC colours (uint8 RGB)."""
    f = synthetic_scene(n, seed)
    rng = np.random.RandomState(seed + 7)
    xyz = (f["xyz"] + rng.normal(0.0, 0.01, f["xyz"].shape)).astype(np.float32)
    rgb = np.clip(f["features_dc"][:, 0, :] * SH_C0 + 0.5, 0.0, 1.0) * 255.0
    return xyz, rgb.astype(np.uint8)


def write_train_dataset(data: Path, scene, points, n_train, n_test, width, height, fovx, device, splits=None):
    """Blender-layout dataset of ``scene``: orbit views (or the c2w lists of
    ``splits``, {split: [c2w]}) whose ground truth is the port's render
    (PNG), and ``points3d.ply``. Returns {split: [c2w]}."""
    import torch

    from gaussian_transformer_tpu_torch.render import render
    from gaussian_transformer_tpu_torch.scene.ply import store_point_cloud
    from gaussian_transformer_tpu_torch.utils.png import write_png

    splits = splits or {
        "train": [orbit_c2w(2 * math.pi * i / n_train) for i in range(n_train)],
        "test": [orbit_c2w(2 * math.pi * (i + 0.5) / n_test + 0.2) for i in range(n_test)],
    }
    for split, c2ws in splits.items():
        (data / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i, c2w in enumerate(c2ws):
            with torch.no_grad():
                img = render(camera_from_c2w(c2w, fovx, width, height, device), scene)["render"]
            img = torch.clamp(img, 0.0, 1.0).cpu().numpy().transpose(1, 2, 0)
            write_png(str(data / split / f"r_{i}.png"), (img * 255).astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w})
        with open(data / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)
    store_point_cloud(str(data / "points3d.ply"), points[0], points[1])
    return splits



def write_lpips_weights(path, net: str, seed: int) -> None:
    """A seeded random LPIPS network in the layout tools/convert_lpips_weights.py
    writes (conv<i>.w [out, in, kh, kw] He-normal, conv<i>.b small, lin<i>.w
    [1, C, 1, 1] in [0, 0.1)): the architecture without the pretrained weights."""
    from gaussian_transformer_tpu_torch.eval import lpips

    rng = np.random.RandomState(seed)
    if net == "vgg":
        convs = [(c, 3) for c in lpips.VGG16_CFG if c != "M"]
    else:
        convs = [(c, k) for c, k, _, _ in (item for item in lpips.ALEX_CFG if item != "M")]
    stages = lpips.VGG16_STAGES if net == "vgg" else lpips.ALEX_STAGES
    out, cin = {}, 3
    for i, (cout, k) in enumerate(convs):
        out[f"conv{i}.w"] = (rng.randn(cout, cin, k, k) * math.sqrt(2.0 / (cin * k * k))).astype(np.float32)
        out[f"conv{i}.b"] = (rng.randn(cout) * 0.01).astype(np.float32)
        cin = cout
    for i, n_convs in enumerate(stages):
        c = convs[n_convs - 1][0]
        out[f"lin{i}.w"] = (rng.rand(1, c, 1, 1) * 0.1).astype(np.float32)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(path), **out)


def report_peak(summary, key: str, section: str, smi: str) -> None:
    """Print the peak device memory since the last reset, keep it in
    ``summary[key]`` and reset the peak."""
    import torch

    gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{smi}] peak memory of section {section}: {gib:.2f} GiB (torch.cuda.max_memory_allocated)")
    summary[key] = gib
    torch.cuda.reset_peak_memory_stats()

# ---------------------------------------------------------------- timing ----


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int) -> float:
    """Mean CUDA-event ms of single launches, each after writing a 256 MB
    buffer so that the 50 MB L2 holds none of the inputs."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def interleaved_ms(fns, rounds: int, reps: int) -> list:
    """Mean CUDA-event ms of each of ``fns``, timed in turns: ``rounds``
    rounds, each timing ``reps`` launches of every function in order, so a
    drift of the card's clock over the window hits all of them alike."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    totals = [0.0] * len(fns)
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            totals[i] += start.elapsed_time(end)
    return [t / (rounds * reps) for t in totals]


def render_profile(fn, top: int = 12) -> str:
    """Device time by CUDA kernel over one warm call of ``fn`` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="cuda_time_total", row_limit=top, max_name_column_width=60)


def step_profile(fn, top: int = 15):
    """(table of device time by CUDA kernel, kernel ms, wall ms, kernels
    launched) over one warm call of ``fn`` (torch.profiler; the wall time by
    CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(e.time_range.elapsed_us() for e in kernels)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=top, max_name_column_width=60)
    return table, kernel_us / 1e3, start.elapsed_time(end), len(kernels)


def kernel_count(fn) -> dict:
    """The CUDA kernels one call of ``fn`` launches (torch.profiler; ``fn``
    already warm): ``launches``, the host's kernel launch calls (the CUDA
    runtime and driver events, every thread), and ``device_events``, the
    device-side records (kernels, copies, annotations). Only the first is
    exact: on a step of ~26,800 launches the device records vary by tens
    between runs whose host launches and op sequences are the same."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    return {"launches": sum(e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cu")
                            and "LaunchKernel" in e.name for e in events),
            "device_events": sum(e.device_type == torch.autograd.DeviceType.CUDA for e in events)}


def train_step_profile(ckpt: Path, cam, gt, cfg, device, top: int = 25) -> str:
    """Device time by op over one warm train step of the trained state in
    ``ckpt`` on ``cam`` (torch.profiler), at the trainer's render budgets
    ``cfg``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gaussian_transformer_tpu_torch.train.splat import OptConfig, restore, train_step

    scene, adam, stats, it, slrs = restore(dict(np.load(ckpt, allow_pickle=False)), device)
    cam.original_image = gt
    bg = torch.zeros(3, device=device)

    def step():
        train_step(scene, adam, stats, cam, bg, it, slrs, OptConfig(), cfg)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="cuda_time_total", row_limit=top, max_name_column_width=60)


def train_step_syncs(ckpt: Path, cam, gt, cfg, device, before=None) -> dict:
    """The host synchronisations one warm train step makes (PyTorch's sync
    debug mode set to warn), by call site: {"file:line <- caller <- caller": count},
    the innermost frames in the port; ``before()``, if given, is called
    just before each step."""
    import torch

    from gaussian_transformer_tpu_torch.train.splat import OptConfig, restore, train_step

    scene, adam, stats, it, slrs = restore(dict(np.load(ckpt, allow_pickle=False)), device)
    cam.original_image = gt
    bg = torch.zeros(3, device=device)
    before = before or (lambda: None)
    before()
    scene, adam, stats, _ = train_step(scene, adam, stats, cam, bg, it, slrs, OptConfig(), cfg)
    torch.cuda.synchronize()

    def step():
        before()
        train_step(scene, adam, stats, cam, bg, it + 1, slrs, OptConfig(), cfg)

    return syncs_by_site(step)


def syncs_by_site(fn) -> dict:
    """The host synchronisations one call of ``fn`` makes (PyTorch's sync
    debug mode set to warn), by call site: {"file:line <- caller <- caller":
    count}, the innermost frames in the port."""
    import collections
    import threading
    import traceback
    import warnings

    import torch

    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if "gaussian_transformer_tpu_torch" in f.filename]
        where = " <- ".join(f"{f.filename.split('gaussian_transformer_tpu_torch/')[-1]}:{f.lineno}"
                            for f in frames[::-1][:3])
        if not frames:  # outside the port: the innermost frames and the thread
            where = f"[{threading.current_thread().name}] " + " <- ".join(
                f"{Path(f.filename).name}:{f.lineno}" for f in stack[::-1][1:4])
        sites[where] += 1

    with warnings.catch_warnings():  # restores showwarning on exit
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")  # its first call in a process warns once: not fn's
        shown, warnings.showwarning = warnings.showwarning, record
        try:
            fn()
        finally:
            warnings.showwarning = shown
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return dict(sites)


def numpy_psnr(model: Path, method: str) -> float:
    """Mean over views of the mean per-channel PSNR, from the written PNGs."""
    from gaussian_transformer_tpu_torch.utils.png import read_png

    d = model / "test" / method
    vals = []
    for name in sorted(os.listdir(d / "renders")):
        r = read_png(str(d / "renders" / name))[..., :3].astype(np.float64) / 255.0
        g = read_png(str(d / "gt" / name))[..., :3].astype(np.float64) / 255.0
        mse = ((r - g) ** 2).reshape(-1, 3).mean(axis=0)
        vals.append(float(np.mean(20 * np.log10(1.0 / np.sqrt(mse)))))
    return float(np.mean(vals))


# ------------------------------------------------------------------ main ----


def run(args, device) -> dict:
    import torch

    from gaussian_transformer_tpu_torch import kernels
    from gaussian_transformer_tpu_torch.cli import metrics as cli_metrics
    from gaussian_transformer_tpu_torch.cli import render as cli_render
    from gaussian_transformer_tpu_torch.convert import scene_from_numpy
    from gaussian_transformer_tpu_torch.ops import fused_ssim
    from gaussian_transformer_tpu_torch.render import project_view
    from gaussian_transformer_tpu_torch.render import prepare_stream, render
    from gaussian_transformer_tpu_torch.render import stream

    on_card = device.type == "cuda"
    summary = {"seed": args.seed, "gaussians": args.gaussians, "views": args.views,
               "width": args.width, "height": args.height}

    print("== 1. device and build")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    if on_card:
        sources = kernels.all_sources()
        fresh = [src for src in sources if not kernels.library_path(src).exists()]
        t0 = time.time()
        kernels.build(sources)
        summary["build_s"] = time.time() - t0
        print(f"nvcc build of {fresh} ({len(sources) - len(fresh)} of {sources} already built): "
              f"{summary['build_s']:.1f} s")
        for src in sources:
            log = kernels.library_path(src).with_suffix(".log")
            if log.exists():
                print(f"-- {src} ptxas:\n" + log.read_text().strip())

    print("== 2. scene and model dir")
    t0 = time.time()
    fields = synthetic_scene(args.gaussians, args.seed)
    scene = scene_from_numpy(fields, active_sh_degree=3, device=device)
    fovx = math.radians(50.0)
    model, splits = write_model_dir(Path(args.work), scene, args.views, args.width, args.height,
                                    fovx, args.seed, device)
    print(f"{args.gaussians} Gaussians, {args.views} test views at {args.width}x{args.height}: "
          f"{time.time() - t0:.1f} s")

    print("== 3. kernel checks on test view 0")
    cam0 = camera_from_c2w(splits["test"][0], fovx, args.width, args.height, device)
    with torch.no_grad():
        s = prepare_stream(cam0, scene)
        props = s.props()
        ct, counts = s.chunk_tile, s.binned.tile_counts
        color, t_fin = stream.composite_stream_tiles(props, ct, counts, s.grid_w, s.grid_h)
        p_color, p_t, (pairs, live) = stream.composite_stream_tiles_plain(props, ct, s.grid_w, s.grid_h,
                                                                          count_work=True)
        cov = s.binned.covered
        err = torch.cat([(color - p_color)[cov].flatten(), (t_fin - p_t)[cov].flatten()]).abs()
        k1_err = float(err.max()) if err.numel() else 0.0
        k1_share = float((err > K1_ATOL).float().mean()) if err.numel() else 0.0
        print(f"K1: {int(s.binned.n_instances)} instances, {int(s.binned.n_padded)} padded rows, "
              f"chunk {props.shape[0] // ct.shape[0]}, {pairs} walked (row, pixel) pairs, {live} contributing")
        print(f"K1 vs plain: max abs diff {k1_err:.3e} (tolerance {K1_MAX_ERR}), "
              f"share beyond {K1_ATOL}: {k1_share:.3e} (tolerance {K1_MAX_SHARE})")
        check(k1_err <= K1_MAX_ERR and k1_share <= K1_MAX_SHARE, "K1 agrees with its plain version")
        k1_sum = checksum(color, t_fin)
        print(f"K1 checksum of (color, final T) on test view 0: {k1_sum}")
        k1_steps = warp_steps("K1", stream.stream_warp_steps(props, ct, counts, s.grid_w, s.grid_h))

        img = render(cam0, scene)["render"]
        gt = torch.clamp(img + 0.05 * torch.randn(img.shape, generator=torch.Generator(device).manual_seed(args.seed), device=device), 0, 1)
        k3 = fused_ssim.fused_ssim(img, gt)
        k3_plain = fused_ssim.ssim_plain(img, gt)
        k3_err = abs(float(k3) - float(k3_plain))
        print(f"K3 vs plain: SSIM {float(k3):.7f} vs {float(k3_plain):.7f}, "
              f"abs diff {k3_err:.3e} (tolerance {K3_ATOL})")
        check(k3_err <= K3_ATOL, "K3 agrees with its plain version")
        k3_sum = checksum(k3)
        print(f"K3 checksum of the mean on test view 0: {k3_sum}")

    print("== 4. main path: cli.render then cli.metrics")
    stream.STREAM_FWD.launches = 0
    fused_ssim.SSIM_FWD.launches = 0
    t0 = time.time()
    dev_arg = [] if on_card else ["--device", str(device)]
    stats = cli_render.main(["-m", str(model), "--skip_train", "--quiet"] + dev_arg)
    t_render = time.time() - t0
    k1_launches = stream.STREAM_FWD.launches
    t0 = time.time()
    scores = cli_metrics.main(["-m", str(model)] + dev_arg)[str(model)]
    t_metrics = time.time() - t0
    k3_launches = fused_ssim.SSIM_FWD.launches
    print(f"cli.render {t_render:.1f} s, cli.metrics {t_metrics:.1f} s; "
          f"K1 launches {k1_launches}, K3 launches {k3_launches}")
    if on_card:
        check(k1_launches == args.views, f"K1 launched once per rendered view ({args.views})")
        check(k3_launches == args.views, f"K3 launched once per scored view ({args.views})")
    check(len(stats) == args.views and all(v["overflow"] == 0 for v in stats),
          f"overflow == 0 on every view ({[v['overflow'] for v in stats]})")
    method = "ours_30000"
    res = scores[method]
    with open(model / "results.json") as f:
        on_disk = json.load(f)[method]
    check(on_disk == res, "results.json holds the returned scores")
    check(math.isfinite(res["SSIM"]) and res["SSIM"] < 1.0, f"SSIM {res['SSIM']:.6f} finite and < 1")
    ref_psnr = numpy_psnr(model, method)
    check(abs(res["PSNR"] - ref_psnr) <= 1e-3,
          f"PSNR {res['PSNR']:.6f} dB == numpy recomputation {ref_psnr:.6f} dB (1e-3 dB)")
    check(20.0 <= res["PSNR"] <= 35.0, "PSNR within [20, 35] dB")
    summary.update(cli_render_s=t_render, cli_metrics_s=t_metrics, ssim=res["SSIM"],
                   psnr=res["PSNR"], views_stats=stats)

    kernels_line = {"kernels": []}
    if on_card:
        print("== 5. times (CUDA events)")
        smi = smi_line()
        clk = sm_clock()
        with torch.no_grad():
            render_ms = cuda_ms(lambda: render(cam0, scene), reps=5)
            stages = {
                "project": cuda_ms(lambda: project_view(cam0, scene, 1.0, None), reps=5),
                "project+bin": cuda_ms(lambda: prepare_stream(cam0, scene), reps=5),
                "gather": cuda_ms(lambda: s.props(), reps=5),
            }
            profile = render_profile(lambda: render(cam0, scene))
            k1_ms = cuda_ms(lambda: stream.composite_stream_tiles(props, ct, counts, s.grid_w, s.grid_h), reps=20)
            k1_plain_ms = cuda_ms(lambda: stream.composite_stream_tiles_plain(props, ct, s.grid_w, s.grid_h), reps=2)
            k3_ms = cuda_ms(lambda: fused_ssim.fused_ssim(img, gt), reps=50)
            k3_launch_ms = cuda_ms(ssim_launch_only(img, gt)[0], reps=50)
            k3_plain_ms = cuda_ms(lambda: fused_ssim.ssim_plain(img, gt), reps=5)
            k1_cold_ms = cuda_ms_cold(lambda: stream.composite_stream_tiles(props, ct, counts, s.grid_w, s.grid_h), reps=10)
            k3_cold_ms = cuda_ms_cold(lambda: fused_ssim.fused_ssim(img, gt), reps=20)
        T = s.grid_w * s.grid_h
        real_rows = int(s.binned.tile_counts.sum())
        k1_bytes = real_rows * 9 * 4 + T * 4 * 256 * 4 + 2 * T * 4
        k1_ops = pairs * WALK_OPS_PER_PAIR + live * K1_OPS_PER_LIVE
        n_px = img.numel()
        k3_bytes = 2 * n_px * 4 + 4  # both images, the mean
        k3_ops = n_px * K3_OPS_PER_PIXEL
        k1_bound, k1_by = bound(k1_bytes, k1_ops)
        k3_bound, k3_by = bound(k3_bytes, k3_ops)
        print(f"[{smi}] render {render_ms:.3f} ms/view: project {stages['project']:.3f} ms, "
              f"bin {stages['project+bin'] - stages['project']:.3f} ms, gather {stages['gather']:.3f} ms, "
              f"K1 {k1_ms:.3f} ms (stages timed apart)")
        print(f"top CUDA kernels of one render (torch.profiler, device time):\n{profile}")
        print(f"[{smi}] K1 {k1_ms:.4f} ms (L2 cold {k1_cold_ms:.4f}), plain {k1_plain_ms:.2f} ms, "
              f"bound {k1_bound:.4f} ms ({k1_by}: {k1_bytes} B, {k1_ops} fp32 ops); "
              f"{sm_cycles(k1_ms, clk, k1_steps['steps']):.2f} SM cycles per warp step")
        k3_build = ptxas_report("ssim_fwd.cu")
        print(f"[{smi}] K3 {k3_ms:.4f} ms (L2 cold {k3_cold_ms:.4f}; launch-only {k3_launch_ms:.4f}), "
              f"plain {k3_plain_ms:.3f} ms, bound {k3_bound:.4f} ms ({k3_by}: {k3_bytes} B, {k3_ops} fp32 ops); "
              f"build {k3_build}")
        print_clocks(clk, "5")
        no_sync_ssim(img, gt)
        kernels_line["kernels"] += [
            {"name": "stream_fwd", "route": "cuda",
             "source": "gaussian_transformer_tpu_torch/csrc/stream_fwd.cu",
             "replaces": "gaussian_transformer_tpu/render/stream.py:266",
             "launches": k1_launches, "max_abs_err": k1_err, "ms": k1_ms, "ms_l2_cold": k1_cold_ms,
             "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
             "tolerance": {"atol": K1_ATOL, "max_share_beyond": K1_MAX_SHARE, "max_abs": K1_MAX_ERR},
             "share_beyond_atol": k1_share, "checksum": k1_sum, "warp_steps": k1_steps},
            {"name": "ssim_fwd", "route": "cuda",
             "source": "gaussian_transformer_tpu_torch/csrc/ssim_fwd.cu",
             "replaces": "gaussian_transformer_tpu/ops/fused_ssim.py:106",
             "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms, "ms_l2_cold": k3_cold_ms,
             "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None,
             "tolerance": {"atol": K3_ATOL}, "launch_only_ms": k3_launch_ms, "checksum": k3_sum,
             "ptxas": k3_build},
        ]
        summary.update(smi=smi, render_ms=render_ms, stage_ms=stages, walked_pairs=pairs, live_pairs=live,
                       real_rows=real_rows, render_profile=profile)
    del s, props, ct, counts, color, t_fin, p_color, p_t, img, gt

    train_entries, train_cfg = train_path(args, device, scene, summary)
    kernels_line["kernels"] += train_entries
    kernels_line["kernels"] += table_path(args, device, scene, fovx, splits["test"], summary)
    kernels_line["kernels"] += transposed_path(args, device, scene, fovx, splits["test"], train_cfg, summary)
    kernels_line["kernels"] += probe_path(args, device, summary)
    kernels_line["kernels"] += bf16_path(args, device, scene, fovx, splits["test"], train_cfg, summary)
    nopallas_path(args, device, scene, fovx, splits["test"], summary)
    summary["viewer_launches"] = viewer_path(args, device, summary, scene, fovx, splits["test"], train_cfg)
    native_io_path(args, device, summary)
    summary["jpeg_launches"] = jpeg_path(args, device, summary)
    summary["image_launches"] = image_path(args, device, summary)
    summary["convert_launches"] = convert_path(args, device, summary)
    summary.update(kernels_line)
    return summary


def bound(nbytes, ops):
    """(least ms, "bytes" or "operations") on the published H100 peaks
    (``utils/roofline.py``)."""
    r = roofline.StageRoofline(nbytes, ops)
    return r.roofline_ms, r.bound


def rows_per_tile(rows) -> dict:
    """max, median, p99 and mean of the rows each tile's block walks at most."""
    r = rows.double().cpu().numpy()
    return {"tiles": int(r.size), "max": float(r.max()), "median": float(np.median(r)),
            "p99": float(np.percentile(r, 99)), "mean": float(r.mean())}


def run_rows(chunk_tile, tile_counts, n_tiles, chunk) -> dict:
    """The rows of the tiles' runs (their chunk padding included) and the
    real rows among them: what K7 and K8 walk at most, per run and in all."""
    import torch

    from gaussian_transformer_tpu_torch.render import stream

    ct = chunk_tile.to(torch.int32)
    row_start, row_end = stream.real_row_ranges(ct, tile_counts, n_tiles, chunk)
    start, end = stream.tile_chunk_ranges(ct, n_tiles)
    return {"real": int((row_end - row_start).sum()), "padded": int(((end - start) * chunk).sum()),
            "real_per_tile": rows_per_tile(row_end - row_start)}


def train_path(args, device, scene, summary):
    """Sections 6-9: the training dataset, ``cli.train``, the K2/K4 checks
    at the trainer's budgets, and the times. Returns the K2 and K4 entries of
    the kernels line (none off the card) and the render budgets the trainer
    tuned for its first step."""
    import shutil

    import torch

    from gaussian_transformer_tpu_torch.cli import metrics as cli_metrics
    from gaussian_transformer_tpu_torch.cli import render as cli_render
    from gaussian_transformer_tpu_torch.cli import train as cli_train
    from gaussian_transformer_tpu_torch.ops import fused_ssim
    from gaussian_transformer_tpu_torch.ops.losses import l1_loss
    from gaussian_transformer_tpu_torch.render import prepare_stream, render, stream
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
    from gaussian_transformer_tpu_torch.scene.ply import fetch_point_cloud
    from gaussian_transformer_tpu_torch.train.splat import PHASES, restore
    from gaussian_transformer_tpu_torch.utils.png import read_png

    on_card = device.type == "cuda"
    W, H = args.width, args.height
    fovx = math.radians(50.0)
    work = Path(args.work)
    data, model = work / "train_data", work / "train_model"
    for d in (data, model):
        shutil.rmtree(d, ignore_errors=True)

    print("== 6. training dataset")
    t0 = time.time()
    points = surface_points(args.train_points, args.seed + 3)
    splits = write_train_dataset(data, scene, points, args.train_views, 2, W, H, fovx, device)
    print(f"{args.train_views} train + 2 test views at {W}x{H}, {args.train_points} points: "
          f"{time.time() - t0:.1f} s")

    print("== 7. main path: cli.train, then cli.render and cli.metrics on the trained model")
    counters = kernel_counters()
    zero_counts(counters)
    dev_arg = [] if on_card else ["--device", str(device)]
    n = args.iterations
    third = n // 3
    t0 = time.time()
    res = cli_train.main([
        "-s", str(data), "-m", str(model), "-r", "1", "--eval", "--iterations", str(n),
        "--densify_from_iter", str(third), "--densification_interval", str(third),
        "--densify_until_iter", str(n), "--test_iterations", str(n), "--save_iterations", str(n),
        "--checkpoint_iterations", str(n), "--quiet",
    ] + dev_arg)
    t_train = time.time() - t0
    launches = read_counts(counters)
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    print(f"cli.train {n} steps: {t_train:.1f} s; launches {launches}")
    print(f"loss by step: {[round(v, 5) for v in losses]}")
    print(f"overflow by step: {[h['overflow'] for h in hist]}")
    if on_card:
        check(launches["K2"] == n and launches["K4"] == n, f"K2 and K4 launched once per step ({n})")
    check(len(losses) == n and all(math.isfinite(v) for v in losses), "every loss is finite")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last < first, f"mean loss of the last 10 steps {last:.5f} < first 10 {first:.5f}")
    dens = [h for h in hist if "densify" in h]
    check(len(dens) == 1, f"one densify pass (at steps {[h['iteration'] for h in dens]})")
    rep = dens[0]["densify"]
    print(f"densify at step {dens[0]['iteration']}: {rep}")
    check(rep["n_alive"] != args.train_points,
          f"the densify pass changed the alive count ({args.train_points} -> {rep['n_alive']})")
    ply = model / "point_cloud" / f"iteration_{n}" / "point_cloud.ply"
    ckpt = model / f"chkpnt{n}.npz"
    check(ply.exists() and ckpt.exists() and (model / "input.ply").exists()
          and (model / "cameras.json").exists(), "input.ply, cameras.json, the PLY and the checkpoint exist")
    restored = restore(dict(np.load(ckpt, allow_pickle=False)), device)[0]
    check(restored.num_alive == res["n_alive"], f"the checkpoint restores {res['n_alive']} alive Gaussians")
    del restored
    stats = cli_render.main(["-m", str(model), "--skip_train", "--quiet"] + dev_arg)
    scores = cli_metrics.main(["-m", str(model)] + dev_arg)[str(model)][f"ours_{n}"]
    check(math.isfinite(scores["PSNR"]) and math.isfinite(scores["SSIM"]),
          f"trained model: PSNR {scores['PSNR']:.3f} dB, SSIM {scores['SSIM']:.4f} on the test views")
    summary.update(train_s=t_train, train_losses=losses, train_launches=launches, densify=rep,
                   train_evals=res["evals"], train_scores=scores, train_render_stats=stats,
                   train_overflow=[h["overflow"] for h in hist])
    # The budgets the trainer tuned from its probe render, and the step from
    # which each held (a compaction re-tunes them).
    cfg = res["render_cfgs"][0][1]
    print("trainer's render budgets: " + ", ".join(
        f"from step {it}: max_instances {c.max_instances}, max_stream {c.max_stream}"
        for it, c in res["render_cfgs"]))

    print("== 8. kernel checks K2 and K4 on train view 0, first step's state, the trainer's budgets")
    g0 = GaussianScene.from_pcd(fetch_point_cloud(str(data / "points3d.ply")), 1,
                                capacity=4 * args.train_points, device=device)
    cam = camera_from_c2w(splits["train"][0], fovx, W, H, device)
    gt = torch.as_tensor(read_png(str(data / "train" / "r_0.png"))[..., :3].transpose(2, 0, 1) / 255.0,
                         dtype=torch.float32, device=device)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        s = prepare_stream(cam, g0, cfg)
        props, ct = s.props(), s.chunk_tile
        chunk = props.shape[0] // ct.shape[0]
        gw, gh = s.grid_w, s.grid_h
        color, final_t = stream.composite_stream_tiles(props, ct, s.binned.tile_counts, gw, gh)
    k1_train_sum = checksum(color, final_t)
    print(f"K1 checksum of (color, final T) on train view 0: {k1_train_sum}")
    # The loss's true cotangents of the compositor's outputs.
    c, t = color.clone().requires_grad_(), final_t.clone().requires_grad_()
    img = stream.tiles_to_image(c, t, s.binned.covered, bg, grid_w=gw, grid_h=gh)[0][:, :H, :W]
    loss = 0.8 * l1_loss(img, gt) + 0.2 * (1.0 - fused_ssim.ssim_plain(img, gt))
    g_color, g_t = torch.autograd.grad(loss, [c, t])
    img = img.detach()
    g_one = torch.ones((), device=device)
    entries = []
    with torch.no_grad():
        k2_in = (props, ct, gw, gh, color, final_t, g_color, g_t)
        d_plain = stream.composite_stream_tiles_bwd_plain(*k2_in)
        d_plain_ssim = fused_ssim.ssim_bwd_plain(img, gt, g_one)
        if on_card:
            d_k2 = stream._launch_stream_bwd(*k2_in)
            scale = float(d_plain.abs().max())
            err = (d_k2 - d_plain)[:, :stream.GRAD_F].abs()
            k2_err = float(err.max())
            k2_share = float((err > K2_ATOL * scale).float().mean())
            print(f"K2: chunk {chunk}, {props.shape[0]} stream rows, {int(s.binned.n_instances)} "
                  f"instances; max |plain| {scale:.3e}")
            print(f"K2 vs plain: max abs diff {k2_err:.3e} = {k2_err / scale:.3e} of max |plain| "
                  f"(tolerance {K2_MAX_ERR}), share beyond {K2_ATOL} of max: {k2_share:.3e} "
                  f"(tolerance {K2_MAX_SHARE})")
            check(k2_err <= K2_MAX_ERR * scale and k2_share <= K2_MAX_SHARE and torch.all(d_k2[:, stream.GRAD_F:] == 0),
                  "K2 agrees with its plain version")
            d_k4 = fused_ssim._launch_ssim_bwd(img, gt, g_one)
            scale4 = float(torch.cat([d.abs().flatten() for d in d_plain_ssim]).max())
            k4_err = max(float((a - b).abs().max()) for a, b in zip(d_k4, d_plain_ssim))
            print(f"K4 vs plain: max abs diff {k4_err:.3e} = {k4_err / scale4:.3e} of max |plain| "
                  f"{scale4:.3e} (tolerance {K4_MAX_ERR})")
            check(k4_err <= K4_MAX_ERR * scale4, "K4 agrees with its plain version")
            k4_sum = checksum(*d_k4)
            print(f"K4 checksum of (d_img1, d_img2) on train view 0: {k4_sum}")
    del d_plain, d_plain_ssim, g0
    summary.update(train_k2_chunk=chunk, train_k2_rows=props.shape[0], train_k1_checksum=k1_train_sum)
    tier_3dgs_path(args, device, summary, data, splits)

    if not on_card:
        return entries, cfg

    print("== 9. train times (CUDA events)")
    smi = smi_line()
    clk = sm_clock()
    steady = [h for h in hist if h["iteration"] > 10 and "densify" not in h]
    med = {k: float(np.median([h["phase_ms"][k] for h in steady])) for k in PHASES}
    step_ms = float(np.median([sum(h["phase_ms"].values()) for h in steady]))
    print(f"[{smi}] median train step {step_ms:.3f} ms over {len(steady)} steps "
          f"(steps 11-{n} without the densify step): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()))
    step_profile = train_step_profile(ckpt, cam, gt, res["render_cfgs"][-1][1], device)
    print(f"top CUDA ops of one train step (torch.profiler, device time):\n{step_profile}")
    step_syncs = train_step_syncs(ckpt, cam, gt, res["render_cfgs"][-1][1], device)
    print(f"host synchronisations in one train step (sync debug mode): {sum(step_syncs.values())} "
          + json.dumps(step_syncs))
    with torch.no_grad():
        k2_ms = cuda_ms(lambda: stream._launch_stream_bwd(*k2_in), reps=20)
        k2_cold_ms = cuda_ms_cold(lambda: stream._launch_stream_bwd(*k2_in), reps=10)
        k2_plain_ms = cuda_ms(lambda: stream.composite_stream_tiles_bwd_plain(*k2_in), reps=2)
        k4_ms = cuda_ms(lambda: fused_ssim._launch_ssim_bwd(img, gt, g_one), reps=50)
        k4_cold_ms = cuda_ms_cold(lambda: fused_ssim._launch_ssim_bwd(img, gt, g_one), reps=20)
        k4_plain_ms = cuda_ms(lambda: fused_ssim.ssim_bwd_plain(img, gt, g_one), reps=5)
        k4_launch_ms = cuda_ms(ssim_launch_only(img, gt)[1], reps=50)
        pairs, live = stream.composite_stream_tiles_plain(props, ct, gw, gh, count_work=True)[2]
        start, end = stream.tile_chunk_ranges(ct.to(torch.int32).contiguous(), gw * gh)
        k2_rows = rows_per_tile((end - start).long() * chunk)
    T = gw * gh
    real_rows = int(s.binned.tile_counts.sum())
    k2_bytes = real_rows * 9 * 4 + T * 8 * 256 * 4 + props.shape[0] * 16 * 4
    k2_ops = pairs * WALK_OPS_PER_PAIR + live * K2_OPS_PER_LIVE
    n_px = img.numel()
    k4_bytes = 4 * n_px * 4
    k4_ops = n_px * K4_OPS_PER_PIXEL
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    k4_bound, k4_by = bound(k4_bytes, k4_ops)
    print(f"[{smi}] K2 (chunk {chunk}, {props.shape[0]} stream rows) {k2_ms:.4f} ms "
          f"(L2 cold {k2_cold_ms:.4f}), plain {k2_plain_ms:.2f} ms, bound {k2_bound:.4f} ms ({k2_by}: {k2_bytes} B, "
          f"{k2_ops} fp32 ops, {pairs} walked pairs, {live} contributing)")
    k4_build = ptxas_report("ssim_bwd.cu")
    print(f"[{smi}] K4 {k4_ms:.4f} ms (L2 cold {k4_cold_ms:.4f}; launch-only {k4_launch_ms:.4f}), "
          f"plain {k4_plain_ms:.3f} ms, bound {k4_bound:.4f} ms ({k4_by}: {k4_bytes} B, {k4_ops} fp32 ops); "
          f"build {k4_build}")
    print(f"[{smi}] K2 rows per tile (chunk_end - chunk_start): {k2_rows}")
    print_clocks(clk, "9")
    summary.update(train_step_syncs=step_syncs, train_step_ms=step_ms, train_phase_ms=med, train_pairs=pairs, train_live_pairs=live,
                   train_real_rows=real_rows, train_step_profile=step_profile, k2_rows_per_tile=k2_rows)
    return [
        {"name": "stream_bwd", "route": "cuda",
         "source": "gaussian_transformer_tpu_torch/csrc/stream_bwd.cu",
         "replaces": "gaussian_transformer_tpu/render/stream.py:411",
         "launches": launches["K2"], "max_abs_err": k2_err, "ms": k2_ms, "ms_l2_cold": k2_cold_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "tolerance": {"max_abs_of_max": K2_MAX_ERR, "atol_of_max": K2_ATOL,
                       "max_share_beyond": K2_MAX_SHARE},
         "share_beyond_atol": k2_share, "chunk": chunk, "stream_rows": props.shape[0],
         "rows_per_tile": k2_rows},
        {"name": "ssim_bwd", "route": "cuda",
         "source": "gaussian_transformer_tpu_torch/csrc/ssim_bwd.cu",
         "replaces": "gaussian_transformer_tpu/ops/fused_ssim.py:132",
         "launches": launches["K4"], "max_abs_err": k4_err, "ms": k4_ms, "ms_l2_cold": k4_cold_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None,
         "tolerance": {"max_abs_of_max": K4_MAX_ERR}, "launch_only_ms": k4_launch_ms, "checksum": k4_sum,
         "ptxas": k4_build},
    ], cfg


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def max_tile_count(cam, gaussians, cfg) -> int:
    """The largest per-tile instance count of a view as the table path bins
    it with ``cfg``'s budgets (probe binnings at a cap that doubles until no
    tile reaches it)."""
    from gaussian_transformer_tpu_torch.render import prepare_table

    k = 4096
    while True:
        peak = int(prepare_table(cam, gaussians, cfg.replace(use_stream=False, max_per_tile=k)).binned.tile_counts.max())
        if peak < k:
            return peak
        k *= 2


def table_path(args, device, scene, fovx, test_c2ws, summary) -> list:
    """Sections 10-12: the table path's serving and training and the K5/K6
    checks and times. Returns the K5 and K6 entries of the kernels line
    (none off the card)."""
    import random
    import shutil

    import torch

    from gaussian_transformer_tpu_torch.config import OptConfig
    from gaussian_transformer_tpu_torch.ops import fused_ssim
    from gaussian_transformer_tpu_torch.ops.losses import l1_loss
    from gaussian_transformer_tpu_torch.render import RenderConfig, prepare_table, project_view, render
    from gaussian_transformer_tpu_torch.render import stream, table_composite
    from gaussian_transformer_tpu_torch.scene import Scene
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
    from gaussian_transformer_tpu_torch.scene.ply import fetch_point_cloud
    from gaussian_transformer_tpu_torch.train.splat import PHASES, training
    from gaussian_transformer_tpu_torch.utils.png import read_png

    on_card = device.type == "cuda"
    W, H = args.width, args.height
    work = Path(args.work)
    k5_fn, k6_fn = table_composite.TABLE_FWD, table_composite.TABLE_BWD

    print("== 10. table path, serving: the test views through render(use_stream=False)")
    cams = [camera_from_c2w(c2w, fovx, W, H, device) for c2w in test_c2ws]
    with torch.no_grad():
        peaks = [max_tile_count(cam, scene, RenderConfig()) for cam in cams]
    k_views = [round_up(v, 32) for v in peaks]
    k_serve = k_views[0]
    cfg = RenderConfig(use_stream=False, max_per_tile=k_serve)
    print(f"largest per-tile instance count by view: {peaks}; max_per_tile by view {k_views} "
          f"(view 0: K_serve = {k_serve})")
    k5_fn.launches = k6_fn.launches = 0
    t0 = time.time()
    with torch.no_grad():
        outs = [render(cam, scene, cfg.replace(max_per_tile=k)) for cam, k in zip(cams, k_views)]
        overflow = [int(o["overflow"]) for o in outs]
    t_serve = time.time() - t0
    k5_serve = k5_fn.launches
    print(f"{len(cams)} table renders: {t_serve:.2f} s; K5 launches {k5_serve}; overflow by view {overflow}; "
          f"instances by view {[int(o['n_instances']) for o in outs]}")
    if on_card:
        check(k5_serve == len(cams), f"K5 launched once per rendered view ({len(cams)})")
    check(all(v == 0 for v in overflow), "overflow == 0 on every view")
    with torch.no_grad():
        s = prepare_table(cams[0], scene, cfg)
        props, counts, gw = s.props(), s.binned.tile_counts, s.grid_w
        color, final_t = table_composite.composite_table_tiles(props, counts, gw)
        p_color, p_t, (pairs, live) = table_composite.composite_table_tiles_plain(props, counts, gw,
                                                                                  count_work=True)
        err = torch.cat([(color - p_color).flatten(), (final_t - p_t).flatten()]).abs()
        k5_err, k5_share = float(err.max()), float((err > K1_ATOL).float().mean())
        real_rows = int(counts.sum())
        print(f"K5: table [{props.shape[0]}, {props.shape[1]}, 16], {real_rows} real rows "
              f"({1 - real_rows / (props.shape[0] * props.shape[1]):.3f} of the rows are padding), "
              f"{pairs} walked (row, pixel) pairs, {live} contributing")
        print(f"K5 vs plain: max abs diff {k5_err:.3e} (tolerance {K1_MAX_ERR}), share beyond {K1_ATOL}: "
              f"{k5_share:.3e} (tolerance {K1_MAX_SHARE})")
        check(k5_err <= K1_MAX_ERR and k5_share <= K1_MAX_SHARE, "K5 agrees with its plain version")
        k5_sum = checksum(color, final_t)
        print(f"K5 checksum of (color, final T) on test view 0: {k5_sum}")
        k5_steps = warp_steps("K5", table_composite.table_warp_steps(props, counts, gw))
        ref = render(cams[0], scene)
        err = torch.cat([(outs[0]["render"] - ref["render"]).flatten(),
                         (outs[0]["final_T"] - ref["final_T"]).flatten()]).abs()
        tvs_err, tvs_share = float(err.max()), float((err > K1_ATOL).float().mean())
        print(f"table vs stream render of view 0: max abs diff {tvs_err:.3e} (tolerance {K1_MAX_ERR}), "
              f"share beyond {K1_ATOL}: {tvs_share:.3e} (tolerance {K1_MAX_SHARE})")
        check(tvs_err <= K1_MAX_ERR and tvs_share <= K1_MAX_SHARE, "the table render agrees with the stream render")
    del outs, ref, p_color, p_t, err
    summary.update(table_k_serve=k_serve, table_serve_peaks=peaks, table_serve_k=k_views, table_serve_overflow=overflow,
                   table_serve_s=t_serve, table_k5_pairs=pairs, table_k5_live_pairs=live, table_real_rows=real_rows,
                   table_vs_stream_err=tvs_err, table_k5_checksum=k5_sum)
    entries = []
    if on_card:
        smi = smi_line()
        clk = sm_clock()
        cam0 = cams[0]
        with torch.no_grad():
            render_ms = cuda_ms(lambda: render(cam0, scene, cfg), reps=5)
            stages = {
                "project": cuda_ms(lambda: project_view(cam0, scene, 1.0, None), reps=5),
                "project+bin": cuda_ms(lambda: prepare_table(cam0, scene, cfg), reps=5),
                "table build": cuda_ms(lambda: s.props(), reps=5),
            }
            k5_ms = cuda_ms(lambda: table_composite.composite_table_tiles(props, counts, gw), reps=20)
            k5_cold_ms = cuda_ms_cold(lambda: table_composite.composite_table_tiles(props, counts, gw), reps=10)
            k5_plain_ms = cuda_ms(lambda: table_composite.composite_table_tiles_plain(props, counts, gw), reps=2)
            profile = render_profile(lambda: render(cam0, scene, cfg))
        T = props.shape[0]
        k5_bytes = real_rows * 9 * 4 + T * 4 + T * 4 * 256 * 4
        k5_ops = pairs * WALK_OPS_PER_PAIR + live * K1_OPS_PER_LIVE
        k5_bound, k5_by = bound(k5_bytes, k5_ops)
        print(f"[{smi}] table render {render_ms:.3f} ms/view: project {stages['project']:.3f} ms, "
              f"bin {stages['project+bin'] - stages['project']:.3f} ms, table build {stages['table build']:.3f} ms, "
              f"K5 {k5_ms:.3f} ms (stages timed apart)")
        print(f"top CUDA kernels of one table render (torch.profiler, device time):\n{profile}")
        print(f"[{smi}] K5 {k5_ms:.4f} ms (L2 cold {k5_cold_ms:.4f}), plain {k5_plain_ms:.2f} ms, "
              f"bound {k5_bound:.4f} ms ({k5_by}: {k5_bytes} B, {k5_ops} fp32 ops); "
              f"{sm_cycles(k5_ms, clk, k5_steps['steps']):.2f} SM cycles per warp step")
        print_clocks(clk, "10")
        summary.update(table_render_ms=render_ms, table_stage_ms=stages, table_render_profile=profile)
        entries.append(
            {"name": "table_fwd", "route": "cuda",
             "source": "gaussian_transformer_tpu_torch/csrc/table_fwd.cu",
             "replaces": "gaussian_transformer_tpu/render/pallas_composite.py:187",
             "launches": k5_serve, "max_abs_err": k5_err, "ms": k5_ms, "ms_l2_cold": k5_cold_ms,
             "plain_ms": k5_plain_ms, "bound_ms": k5_bound, "bound_by": k5_by, "library_ms": None,
             "tolerance": {"atol": K1_ATOL, "max_share_beyond": K1_MAX_SHARE, "max_abs": K1_MAX_ERR},
             "share_beyond_atol": k5_share, "max_per_tile": k_serve, "checksum": k5_sum,
             "warp_steps": k5_steps})
    del s, props, counts, color, final_t

    print("== 11. table path, training: train/splat.py training() on the section-6 dataset")
    data, model = work / "train_data", work / "table_model"
    shutil.rmtree(model, ignore_errors=True)
    random.seed(args.seed)
    scene_obj = Scene(Namespace(model_path=str(model), source_path=str(data), images="images", eval=True,
                                white_background=False, resolution=1, data_device=str(device)),
                      shuffle=False, sh_degree=3, device=device)
    train_cams = scene_obj.get_train_cameras()
    with torch.no_grad():
        train_peaks = [max_tile_count(cam, scene_obj.gaussians, RenderConfig()) for cam in train_cams]
    k_train = round_up(int(max(train_peaks) * TABLE_TRAIN_HEADROOM), 32)
    print(f"largest per-tile instance count by train view: {train_peaks}; K_train = {k_train}")
    n = args.iterations
    third = n // 3
    opt = OptConfig(iterations=n, densify_from_iter=third, densification_interval=third, densify_until_iter=n)
    hist = []

    def log_fn(iteration, loss, overflow, phase_ms, densify, render_cfg, **_):
        hist.append({"iteration": iteration, "loss": loss, "overflow": overflow, "phase_ms": phase_ms,
                     "densify": densify, "render_cfg": render_cfg})

    cap0 = max(256, int(scene_obj.gaussians.num_alive * 4.0))  # training()'s default headroom
    k5_fn.launches = k6_fn.launches = 0
    t0 = time.time()
    training(scene_obj, opt, RenderConfig(use_stream=False, max_per_tile=k_train), seed=args.seed, log_fn=log_fn)
    t_train = time.time() - t0
    launches = {"K5": k5_fn.launches, "K6": k6_fn.launches}
    losses = [h["loss"] for h in hist]
    # A probe render tunes the budgets at the start and after each compaction, at 50k slots and more.
    caps = [cap0] + [h["densify"]["capacity"] for h in hist if h["densify"] and "capacity" in h["densify"]]
    probes = sum(c >= 50_000 for c in caps)
    print(f"training() {n} steps with the table path: {t_train:.1f} s; launches {launches}, probe renders {probes}")
    print(f"loss by step: {[round(v, 5) for v in losses]}")
    print(f"overflow by step: {[h['overflow'] for h in hist]}")
    print("densify: " + str([(h["iteration"], h["densify"]) for h in hist if h["densify"]]))
    if on_card:
        check(launches["K6"] == n and launches["K5"] == n + probes,
              f"K6 launched once per step ({n}), K5 once per step and probe render ({n} + {probes})")
    check(len(losses) == n and all(math.isfinite(v) for v in losses), "every table-path loss is finite")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last < first, f"table path: mean loss of the last 10 steps {last:.5f} < first 10 {first:.5f}")
    tcfg = hist[0]["render_cfg"]
    print(f"trainer's table budgets: max_per_tile {tcfg.max_per_tile}, max_instances {tcfg.max_instances}")
    summary.update(table_train_cfg=dataclasses.asdict(tcfg))
    summary.update(table_k_train=k_train, table_train_peaks=train_peaks, table_train_s=t_train,
                   table_train_losses=losses, table_train_launches=launches,
                   table_train_overflow=[h["overflow"] for h in hist])
    del scene_obj

    print("== 12. K6 on train view 0, first step's state, the trainer's budgets")
    g0 = GaussianScene.from_pcd(fetch_point_cloud(str(data / "points3d.ply")), 1,
                                capacity=4 * args.train_points, device=device)
    cam = camera_from_c2w(orbit_c2w(0.0), fovx, W, H, device)
    gt = torch.as_tensor(read_png(str(data / "train" / "r_0.png"))[..., :3].transpose(2, 0, 1) / 255.0,
                         dtype=torch.float32, device=device)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        s = prepare_table(cam, g0, tcfg)
        props, counts, gw, gh = s.props(), s.binned.tile_counts, s.grid_w, s.grid_h
        color, final_t = table_composite.composite_table_tiles(props, counts, gw)
    k5_train_sum = checksum(color, final_t)
    print(f"K5 checksum of (color, final T) on train view 0: {k5_train_sum}")
    summary.update(table_k5_train_checksum=k5_train_sum)
    c, t = color.clone().requires_grad_(), final_t.clone().requires_grad_()
    img = stream.tiles_to_image(c, t, None, bg, grid_w=gw, grid_h=gh)[0][:, :H, :W]
    loss = 0.8 * l1_loss(img, gt) + 0.2 * (1.0 - fused_ssim.ssim_plain(img, gt))
    g_color, g_t = torch.autograd.grad(loss, [c, t])
    k6_in = (props, counts, gw, color, final_t, g_color, g_t)
    with torch.no_grad():
        d_plain = table_composite.composite_table_tiles_bwd_plain(*k6_in)
        real_rows = int(counts.sum())
        print(f"K6: table [{props.shape[0]}, {props.shape[1]}, 16], {real_rows} real rows, "
              f"overflow {int(s.binned.overflow)}")
        if not on_card:
            return entries
        d_k6 = table_composite._launch_table_bwd(*k6_in)
        scale = float(d_plain.abs().max())
        err = (d_k6 - d_plain)[..., :stream.GRAD_F].abs()
        k6_err, k6_share = float(err.max()), float((err > K2_ATOL * scale).float().mean())
        print(f"K6 vs plain: max abs diff {k6_err:.3e} = {k6_err / scale:.3e} of max |plain| {scale:.3e} "
              f"(tolerance {K2_MAX_ERR}), share beyond {K2_ATOL} of max: {k6_share:.3e} (tolerance {K2_MAX_SHARE})")
        check(k6_err <= K2_MAX_ERR * scale and k6_share <= K2_MAX_SHARE
              and bool(torch.all(d_k6[..., stream.GRAD_F:] == 0)), "K6 agrees with its plain version")
    del d_plain, d_k6, err, g0

    print("== 12b. table train times (CUDA events)")
    smi = smi_line()
    clk = sm_clock()
    steady = [h for h in hist if h["iteration"] > 10 and not h["densify"]]
    med = {k: float(np.median([h["phase_ms"][k] for h in steady])) for k in PHASES}
    step_ms = float(np.median([sum(h["phase_ms"].values()) for h in steady]))
    print(f"[{smi}] median table train step {step_ms:.3f} ms over {len(steady)} steps "
          f"(steps 11-{n} without the densify step): " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()))
    with torch.no_grad():
        k6_ms = cuda_ms(lambda: table_composite._launch_table_bwd(*k6_in), reps=20)
        k6_cold_ms = cuda_ms_cold(lambda: table_composite._launch_table_bwd(*k6_in), reps=10)
        k6_plain_ms = cuda_ms(lambda: table_composite.composite_table_tiles_bwd_plain(*k6_in), reps=2)
        pairs, live = table_composite.composite_table_tiles_plain(props, counts, gw, count_work=True)[2]
        k6_rows = rows_per_tile(table_composite.walked_rows(counts, props.shape[1]))
    T, Kp = props.shape[0], props.shape[1]
    k6_bytes = real_rows * 9 * 4 + T * 4 + T * 8 * 256 * 4 + T * Kp * 16 * 4
    k6_ops = pairs * WALK_OPS_PER_PAIR + live * K6_OPS_PER_LIVE
    k6_bound, k6_by = bound(k6_bytes, k6_ops)
    print(f"[{smi}] K6 (table [{T}, {Kp}, 16]) {k6_ms:.4f} ms (L2 cold {k6_cold_ms:.4f}), plain {k6_plain_ms:.2f} ms, "
          f"bound {k6_bound:.4f} ms ({k6_by}: {k6_bytes} B, {k6_ops} fp32 ops, {pairs} walked pairs, "
          f"{live} contributing)")
    print(f"[{smi}] K6 rows per tile (walked_rows): {k6_rows}")
    print_clocks(clk, "12b")
    summary.update(table_train_step_ms=step_ms, table_train_phase_ms=med, table_k6_ms=k6_ms, table_k6_pairs=pairs,
                   table_k6_live_pairs=live, table_k6_real_rows=real_rows, k6_rows_per_tile=k6_rows)
    entries.append(
        {"name": "table_bwd", "route": "cuda",
         "source": "gaussian_transformer_tpu_torch/csrc/table_bwd.cu",
         "replaces": "gaussian_transformer_tpu/render/pallas_composite.py:237",
         "launches": launches["K6"], "max_abs_err": k6_err, "ms": k6_ms, "ms_l2_cold": k6_cold_ms,
         "plain_ms": k6_plain_ms, "bound_ms": k6_bound, "bound_by": k6_by, "library_ms": None,
         "tolerance": {"max_abs_of_max": K2_MAX_ERR, "atol_of_max": K2_ATOL, "max_share_beyond": K2_MAX_SHARE},
         "share_beyond_atol": k6_share, "max_per_tile": Kp, "rows_per_tile": k6_rows})
    return entries


def psnr_db(a, b) -> float:
    """Mean over channels of the PSNR of ``a`` against ``b`` (images in [0, 1])."""
    import torch

    mse = ((a - b) ** 2).mean(dim=(1, 2))
    return float((20.0 * torch.log10(1.0 / torch.sqrt(mse))).mean())


def leaf_grads(cam, gaussians, cfg, gt, device):
    """The trainer's loss on one view through ``render(cfg)``, and its
    gradients w.r.t. xyz, opacity, scaling, features_dc and the screen-space
    offset (one backward)."""
    import torch

    from gaussian_transformer_tpu_torch.ops.losses import l1_loss, ssim
    from gaussian_transformer_tpu_torch.render import render

    offset = torch.zeros(gaussians.capacity, 2, device=device, requires_grad=True)
    img = render(cam, gaussians, cfg, bg_color=torch.zeros(3, device=device), screenspace_offset=offset)["render"]
    loss = 0.8 * l1_loss(img, gt) + 0.2 * (1.0 - ssim(img, gt))
    leaves = [gaussians.xyz, gaussians.opacity, gaussians.scaling, gaussians.features_dc, offset]
    return dict(zip(LEAF_NAMES, torch.autograd.grad(loss, leaves)))


def grad_rule(a, b) -> dict:
    """The largest difference of ``b`` from ``a`` relative to the largest of
    ``a``, the share within 5% of it, and the share beyond K2's 2e-4 of it."""
    scale = float(a.abs().max())
    err = (b - a).abs()
    return {"max_of_max": float(err.max()) / scale, "within_5pct": float((err <= 0.05 * scale).float().mean()),
            "beyond_atol": float((err > K2_ATOL * scale).float().mean()), "scale": scale}


def bf16_path(args, device, scene, fovx, test_c2ws, train_cfg, summary) -> list:
    """Sections 25 and 26: the bf16 property stream (K1/K2's bf16 entry
    points) serving the 1M scene and training section 6's dataset. Returns
    the K1.bf16 and K2.bf16 entries of the kernels line (none off the card)."""
    import random

    import torch

    from gaussian_transformer_tpu_torch.config import OptConfig
    from gaussian_transformer_tpu_torch.ops import fused_ssim
    from gaussian_transformer_tpu_torch.ops.losses import l1_loss
    from gaussian_transformer_tpu_torch.render import RenderConfig, prepare_stream, project_view, render, stream
    from gaussian_transformer_tpu_torch.scene import Scene
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
    from gaussian_transformer_tpu_torch.scene.ply import fetch_point_cloud
    from gaussian_transformer_tpu_torch.train.splat import PHASES, training
    from gaussian_transformer_tpu_torch.utils.png import read_png
    from gaussian_transformer_tpu_torch.utils.profiling import device_memory_stats

    on_card = device.type == "cuda"
    W, H = args.width, args.height
    work = Path(args.work)
    k1b, k2b = stream.STREAM_FWD_BF16, stream.STREAM_BWD_BF16
    bf = RenderConfig(precision="bf16")
    counters = kernel_counters()
    smi = smi_line(device)

    print("== 25. bf16 serving: the test views through render(RenderConfig(precision='bf16'))")
    t_sec = time.time()
    cams = [camera_from_c2w(c2w, fovx, W, H, device) for c2w in test_c2ws]
    zero_counts(counters)
    k1b.launches = k2b.launches = 0
    t0 = time.time()
    with torch.no_grad():
        outs = [render(cam, scene, bf) for cam in cams]
        overflow = [int(o["overflow"]) for o in outs]
    t_serve = time.time() - t0
    k1b_serve, k1_serve = k1b.launches, read_counts(counters)["K1"]
    print(f"{len(cams)} bf16 renders: {t_serve:.2f} s; K1.bf16 launches {k1b_serve}, K1 (float32) launches "
          f"{k1_serve}; overflow by view {overflow}")
    if on_card:
        check(k1b_serve == len(cams) and k1_serve == 0,
              f"K1.bf16 launched once per rendered view ({len(cams)}) and the float32 K1 not at all")
    check(all(v == 0 for v in overflow), "overflow == 0 on every bf16 view")
    with torch.no_grad():
        ref = render(cams[0], scene)
        a, b = torch.clamp(ref["render"], 0, 1), torch.clamp(outs[0]["render"], 0, 1)
        psnr = psnr_db(b, a)
        img_diff = float((b - a).abs().max())
    print(f"bf16 vs float32 render of test view 0: PSNR {psnr:.2f} dB (rule > {BF16_MIN_PSNR} dB), max abs diff "
          f"{img_diff:.4f} (printed beside the JAX package's atol {BF16_IMAGE_ATOL}, set at 192 Gaussians, 80x48)")
    check(psnr > BF16_MIN_PSNR, f"the bf16 render is within {BF16_MIN_PSNR} dB PSNR of the float32 render")
    del outs, ref, a, b
    with torch.no_grad():
        s = prepare_stream(cams[0], scene)
        props, ct, counts = s.props(), s.chunk_tile, s.binned.tile_counts
        gw, gh = s.grid_w, s.grid_h
        rows = stream.kernel_props(props, ct, gw, "bf16")
        color, t_fin = stream.composite_stream_tiles(props, ct, counts, gw, gh, "bf16")
        p_color, p_t, (pairs, live) = stream.composite_stream_tiles_plain(rows, ct, gw, gh, count_work=True)
        cov = s.binned.covered
        err = torch.cat([(color - p_color)[cov].flatten(), (t_fin - p_t)[cov].flatten()]).abs()
        k1b_err, k1b_share = float(err.max()), float((err > K1_ATOL).float().mean())
        f_color, f_t = stream.composite_stream_tiles(props, ct, counts, gw, gh)
        vs_fp32 = float(torch.cat([(color - f_color)[cov].flatten(), (t_fin - f_t)[cov].flatten()]).abs().max())
        real_rows = int(counts.sum())
    print(f"K1.bf16: {rows.shape[0]} stream rows of {rows.shape[1]} bf16, {real_rows} real, {pairs} walked "
          f"(row, pixel) pairs, {live} contributing")
    print(f"K1.bf16 vs plain on the same bf16 rows: max abs diff {k1b_err:.3e} (tolerance {K1_MAX_ERR}), share "
          f"beyond {K1_ATOL}: {k1b_share:.3e} (tolerance {K1_MAX_SHARE}); vs K1 on the float32 rows: max abs diff "
          f"{vs_fp32:.3e} (printed)")
    check(k1b_err <= K1_MAX_ERR and k1b_share <= K1_MAX_SHARE, "K1.bf16 agrees with its plain version")
    k1b_sum = checksum(color, t_fin)
    print(f"K1.bf16 checksum of (color, final T) on test view 0: {k1b_sum}")
    del p_color, p_t, f_color, f_t, err
    summary.update(bf16_psnr=psnr, bf16_image_max_diff=img_diff, bf16_k1_vs_fp32=vs_fp32, bf16_k1_pairs=pairs,
                   bf16_k1_live_pairs=live, bf16_k1_checksum=k1b_sum, bf16_serve_s=t_serve)
    entries = []
    if on_card:
        clk = sm_clock()
        with torch.no_grad():
            k1b_ms, k1_ms = interleaved_ms([lambda: stream._launch_stream_fwd(rows, ct, counts, gw, gh, "bf16"),
                                            lambda: stream._launch_stream_fwd(props, ct, counts, gw, gh)],
                                           rounds=5, reps=10)
            k1b_plain_ms = cuda_ms(lambda: stream.composite_stream_tiles_plain(rows, ct, gw, gh), reps=2)
            rbf_ms, r32_ms = interleaved_ms([lambda: render(cams[0], scene, bf), lambda: render(cams[0], scene)],
                                            rounds=3, reps=2)
            cast_ms = cuda_ms(lambda: stream.kernel_props(props, ct, gw, "bf16"), reps=10)
        r1b = roofline.fwd_kernel(pairs, live, real_rows, gw * gh, "bf16")
        print(f"[{smi}] K1.bf16 {k1b_ms:.4f} ms, K1 {k1_ms:.4f} ms in turns on the same stream "
              f"(K1.bf16 / K1 = {k1b_ms / k1_ms:.3f}); plain K1.bf16 {k1b_plain_ms:.2f} ms; bound "
              f"{r1b.roofline_ms:.4f} ms ({r1b.bound}: {r1b.nbytes} B at 32 B a row = {r1b.t_bytes_ms:.4f} ms, "
              f"{r1b.ops} fp32 ops = {r1b.t_ops_ms:.4f} ms)")
        print(f"[{smi}] render of test view 0: bf16 {rbf_ms:.3f} ms, float32 {r32_ms:.3f} ms in turns; the rows' "
              f"shift and rounding (kernel_props) {cast_ms:.3f} ms")
        print_clocks(clk, "25")
        summary.update(bf16_render_ms=rbf_ms, bf16_fp32_render_ms=r32_ms, bf16_cast_ms=cast_ms,
                       bf16_k1_fp32_ms=k1_ms)
        entries.append(
            {"name": "stream_fwd_bf16", "route": "cuda",
             "source": "gaussian_transformer_tpu_torch/csrc/stream_fwd.cu",
             "replaces": "gaussian_transformer_tpu/render/stream.py:266",
             "launches": k1b_serve, "max_abs_err": k1b_err, "ms": k1b_ms, "plain_ms": k1b_plain_ms,
             "bound_ms": r1b.roofline_ms, "bound_by": r1b.bound, "library_ms": None,
             "tolerance": {"atol": K1_ATOL, "max_share_beyond": K1_MAX_SHARE, "max_abs": K1_MAX_ERR},
             "share_beyond_atol": k1b_share, "checksum": k1b_sum, "fp32_ms_in_turns": k1_ms,
             "max_abs_diff_vs_fp32_rows": vs_fp32})
    del s, props, rows, ct, counts, color, t_fin
    print(f"section 25 wall time {time.time() - t_sec:.1f} s")

    print("== 26. bf16 train step: train/splat.py training(RenderConfig(precision='bf16')) on the section-6 dataset")
    t_sec = time.time()
    data, model = work / "train_data", work / "bf16_model"
    shutil.rmtree(model, ignore_errors=True)
    random.seed(args.seed)
    scene_obj = Scene(Namespace(model_path=str(model), source_path=str(data), images="images", eval=True,
                                white_background=False, resolution=1, data_device=str(device)),
                      shuffle=False, sh_degree=3, device=device)
    n = args.iterations
    third = n // 3
    opt = OptConfig(iterations=n, densify_from_iter=third, densification_interval=third, densify_until_iter=n)
    hist = []

    def log_fn(iteration, loss, overflow, phase_ms, densify, render_cfg, **_):
        hist.append({"iteration": iteration, "loss": loss, "overflow": overflow, "phase_ms": phase_ms,
                     "densify": densify, "render_cfg": render_cfg})

    cap0 = max(256, int(scene_obj.gaussians.num_alive * 4.0))  # training()'s default headroom
    zero_counts(counters)
    k1b.launches = k2b.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    training(scene_obj, opt, bf, seed=args.seed, log_fn=log_fn)
    t_train = time.time() - t0
    launches = {"K1.bf16": k1b.launches, "K2.bf16": k2b.launches, **read_counts(counters)}
    mem = device_memory_stats()
    losses = [h["loss"] for h in hist]
    caps = [cap0] + [h["densify"]["capacity"] for h in hist if h["densify"] and "capacity" in h["densify"]]
    probes = sum(c >= 50_000 for c in caps)
    print(f"training() {n} bf16 steps: {t_train:.1f} s; launches {launches}, probe renders {probes}; "
          f"device_memory_stats {mem}")
    print(f"loss by step: {[round(v, 5) for v in losses]}")
    print(f"overflow by step: {[h['overflow'] for h in hist]}")
    if on_card:
        check(launches["K2.bf16"] == n and launches["K1.bf16"] == n + probes and launches["K1"] == 0
              and launches["K2"] == 0 and launches["K4"] == n,
              f"K2.bf16 launched once per step ({n}), K1.bf16 once per step and probe render ({n} + {probes}), "
              f"the float32 K1/K2 never")
    check(len(losses) == n and all(math.isfinite(v) for v in losses), "every bf16 loss is finite")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last < first, f"bf16: mean loss of the last 10 steps {last:.5f} < first 10 {first:.5f}")
    summary.update(bf16_train_s=t_train, bf16_train_losses=losses, bf16_train_launches=launches,
                   bf16_train_overflow=[h["overflow"] for h in hist], bf16_train_memory=mem)
    del scene_obj

    print("== 26, K2.bf16 on train view 0, first step's state, the trainer's budgets (section 8's inputs)")
    g0 = GaussianScene.from_pcd(fetch_point_cloud(str(data / "points3d.ply")), 1,
                                capacity=4 * args.train_points, device=device)
    cam = camera_from_c2w(orbit_c2w(0.0), fovx, W, H, device)
    gt = torch.as_tensor(read_png(str(data / "train" / "r_0.png"))[..., :3].transpose(2, 0, 1) / 255.0,
                         dtype=torch.float32, device=device)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        s = prepare_stream(cam, g0, train_cfg)
        props, ct, counts = s.props(), s.chunk_tile, s.binned.tile_counts
        gw, gh = s.grid_w, s.grid_h
        rows = stream.kernel_props(props, ct, gw, "bf16")
        color, final_t = stream.composite_stream_tiles(props, ct, counts, gw, gh, "bf16")
        color32, final_t32 = stream.composite_stream_tiles(props, ct, counts, gw, gh)
    cots = []
    for c_, t_ in ((color, final_t), (color32, final_t32)):
        c, t = c_.clone().requires_grad_(), t_.clone().requires_grad_()
        img = stream.tiles_to_image(c, t, s.binned.covered, bg, grid_w=gw, grid_h=gh)[0][:, :H, :W]
        loss = 0.8 * l1_loss(img, gt) + 0.2 * (1.0 - fused_ssim.ssim_plain(img, gt))
        cots.append(torch.autograd.grad(loss, [c, t]))
    k2b_in = (rows, ct, gw, gh, color, final_t, *cots[0])
    k2_in = (props, ct, gw, gh, color32, final_t32, *cots[1])
    with torch.no_grad():
        d_plain = stream.composite_stream_tiles_bwd_plain(*k2b_in)
        pairs, live = stream.composite_stream_tiles_plain(rows, ct, gw, gh, count_work=True)[2]
        real_rows = int(counts.sum())
        k2b_err = k2b_share = None
        if on_card:
            d_k2b = stream._launch_stream_bwd(*k2b_in, "bf16")
            scale = float(d_plain.abs().max())
            err = (d_k2b - d_plain)[:, :stream.GRAD_F].abs()
            k2b_err, k2b_share = float(err.max()), float((err > K2_ATOL * scale).float().mean())
            print(f"K2.bf16: chunk {props.shape[0] // ct.shape[0]}, {props.shape[0]} stream rows; max |plain| "
                  f"{scale:.3e}")
            print(f"K2.bf16 vs plain on the same bf16 rows: max abs diff {k2b_err:.3e} = {k2b_err / scale:.3e} of "
                  f"max |plain| (tolerance {K2_MAX_ERR}), share beyond {K2_ATOL} of max: {k2b_share:.3e} "
                  f"(tolerance {K2_MAX_SHARE})")
            check(k2b_err <= K2_MAX_ERR * scale and k2b_share <= K2_MAX_SHARE
                  and bool(torch.all(d_k2b[:, stream.GRAD_F:] == 0)), "K2.bf16 agrees with its plain version")
            del d_k2b, err
    del d_plain
    g32 = leaf_grads(cam, g0, train_cfg, gt, device)
    g16 = leaf_grads(cam, g0, train_cfg.replace(precision="bf16"), gt, device)
    rules = {k: grad_rule(g32[k], g16[k]) for k in LEAF_NAMES}
    print("bf16 vs float32 gradients of the trainer's loss on train view 0 (printed beside the JAX package's bf16 "
          f"rule, {BF16_GRAD_MAX} of the largest and > {BF16_GRAD_TIGHT} within 5%): "
          + "; ".join(f"{k} {v['max_of_max']:.4f} of the largest, {v['within_5pct']:.4f} within 5%"
                      for k, v in rules.items()))
    summary.update(bf16_grad_rules=rules, bf16_k2_pairs=pairs, bf16_k2_live_pairs=live)
    del g32, g16

    if on_card:
        clk = sm_clock()
        steady = [h for h in hist if h["iteration"] > 10 and not h["densify"]]
        med = {k: float(np.median([h["phase_ms"][k] for h in steady])) for k in PHASES}
        step_ms = float(np.median([sum(h["phase_ms"].values()) for h in steady]))
        with torch.no_grad():
            k2b_ms, k2_ms = interleaved_ms([lambda: stream._launch_stream_bwd(*k2b_in, "bf16"),
                                            lambda: stream._launch_stream_bwd(*k2_in)], rounds=5, reps=4)
            k1b_train_ms, k1_train_ms = interleaved_ms(
                [lambda: stream._launch_stream_fwd(rows, ct, counts, gw, gh, "bf16"),
                 lambda: stream._launch_stream_fwd(props, ct, counts, gw, gh)], rounds=5, reps=10)
            k2b_plain_ms = cuda_ms(lambda: stream.composite_stream_tiles_bwd_plain(*k2b_in), reps=2)
            stages = {"project": cuda_ms(lambda: project_view(cam, g0, 1.0, None), reps=5),
                      "project+bin": cuda_ms(lambda: prepare_stream(cam, g0, train_cfg), reps=5),
                      "gather": cuda_ms(lambda: s.props(), reps=5)}
        r2b = roofline.bwd_kernel(pairs, live, real_rows, rows.shape[0], gw * gh, "bf16")
        print(f"[{smi}] median bf16 train step {step_ms:.3f} ms over {len(steady)} steps (steps 11-{n} without the "
              f"densify step): " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()))
        print(f"[{smi}] K2.bf16 {k2b_ms:.4f} ms, K2 {k2_ms:.4f} ms in turns (K2.bf16 / K2 = {k2b_ms / k2_ms:.3f}); "
              f"plain K2.bf16 {k2b_plain_ms:.2f} ms; bound {r2b.roofline_ms:.4f} ms ({r2b.bound}: {r2b.nbytes} B = "
              f"{r2b.t_bytes_ms:.4f} ms, {r2b.ops} fp32 ops = {r2b.t_ops_ms:.4f} ms; {pairs} walked, {live} "
              f"contributing)")
        print(f"[{smi}] on train view 0: K1.bf16 {k1b_train_ms:.4f} ms, K1 {k1_train_ms:.4f} ms in turns")
        base = {"n_gaussians": g0.capacity, "n_instances": train_cfg.max_instances, "i_pad": props.shape[0],
                "real_rows": real_rows, "n_tiles": gw * gh, "height": H, "width": W, "sh_degree": 1}
        measured = {"project": stages["project"], "bin": stages["project+bin"] - stages["project"],
                    "gather": stages["gather"]}
        reports = {
            "fp32": roofline.step_report(
                dict(base, walked=summary["train_pairs"], contributing=summary["train_live_pairs"]),
                dict(measured, fwd_kernel=k1_train_ms, bwd_kernel=k2_ms, total=summary["train_step_ms"])),
            "bf16": roofline.step_report(
                dict(base, walked=pairs, contributing=live, precision="bf16"),
                dict(measured, fwd_kernel=k1b_train_ms, bwd_kernel=k2b_ms, total=step_ms)),
        }
        for prec, rep in reports.items():
            print(f"[{smi}] roofline of the {prec} train step (utils/roofline.step_report; float32 step: section 9's "
                  f"cli.train median, bf16: this section's): " + json.dumps(rep))
        print_clocks(clk, "26")
        summary.update(bf16_train_step_ms=step_ms, bf16_train_phase_ms=med, bf16_step_roofline=reports,
                       bf16_stage_ms=stages)
        entries.append(
            {"name": "stream_bwd_bf16", "route": "cuda",
             "source": "gaussian_transformer_tpu_torch/csrc/stream_bwd.cu",
             "replaces": "gaussian_transformer_tpu/render/stream.py:411",
             "launches": launches["K2.bf16"], "max_abs_err": k2b_err, "ms": k2b_ms, "plain_ms": k2b_plain_ms,
             "bound_ms": r2b.roofline_ms, "bound_by": r2b.bound, "library_ms": None,
             "tolerance": {"max_abs_of_max": K2_MAX_ERR, "atol_of_max": K2_ATOL, "max_share_beyond": K2_MAX_SHARE},
             "share_beyond_atol": k2b_share, "fp32_ms_in_turns": k2_ms, "stream_rows": props.shape[0],
             "grad_rule_vs_fp32": rules})
        # The forward entry's launches: the serving views and the training run's.
        entries[0]["launches_train"] = launches["K1.bf16"]
    print(f"section 26 wall time {time.time() - t_sec:.1f} s")
    return entries


def nopallas_path(args, device, scene, fovx, test_c2ws, summary) -> None:
    """Section 26b: ``RenderConfig(use_pallas=False)`` (render/composite.py,
    tensor ops) against the table kernels K5/K6 on the same lists."""
    import torch

    from gaussian_transformer_tpu_torch.render import RenderConfig, render
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
    from gaussian_transformer_tpu_torch.scene.ply import fetch_point_cloud
    from gaussian_transformer_tpu_torch.utils.png import read_png

    on_card = device.type == "cuda"
    W, H = args.width, args.height
    data = Path(args.work) / "train_data"
    smi = smi_line(device)
    print("== 26b. use_pallas=False: render/composite.py against the table kernels (K5, K6)")
    t_sec = time.time()
    k_serve = summary["table_k_serve"]
    cam0 = camera_from_c2w(test_c2ws[0], fovx, W, H, device)
    cfg = RenderConfig(use_pallas=False, max_per_tile=k_serve)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.time()
        a = render(cam0, scene, cfg)
        if on_card:
            torch.cuda.synchronize()
        fwd_s = time.time() - t0
        fwd_peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
        b = render(cam0, scene, cfg.replace(use_pallas=True, use_stream=False))
        err = torch.cat([(a["render"] - b["render"]).flatten(), (a["final_T"] - b["final_T"]).flatten()]).abs()
        img_err, img_share = float(err.max()), float((err > K1_ATOL).float().mean())
    print(f"test view 0 of the {args.gaussians}-Gaussian scene, max_per_tile {k_serve}: composite.py vs K5: max abs "
          f"diff {img_err:.3e} "
          f"(tolerance {K1_MAX_ERR}), share beyond {K1_ATOL}: {img_share:.3e} (tolerance {K1_MAX_SHARE}); "
          f"{fwd_s:.2f} s, peak {fwd_peak:.2f} GiB")
    check(img_err <= K1_MAX_ERR and img_share <= K1_MAX_SHARE, "the use_pallas=False render agrees with K5's")
    del a, b, err
    tcfg = RenderConfig(**summary["table_train_cfg"])
    g0 = GaussianScene.from_pcd(fetch_point_cloud(str(data / "points3d.ply")), 1,
                                capacity=4 * args.train_points, device=device)
    cam = camera_from_c2w(orbit_c2w(0.0), fovx, W, H, device)
    gt = torch.as_tensor(read_png(str(data / "train" / "r_0.png"))[..., :3].transpose(2, 0, 1) / 255.0,
                         dtype=torch.float32, device=device)
    g_k6 = leaf_grads(cam, g0, tcfg, gt, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    g_xla = leaf_grads(cam, g0, tcfg.replace(use_pallas=False), gt, device)
    if on_card:
        torch.cuda.synchronize()
    bwd_s = time.time() - t0
    bwd_peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    rules = {k: grad_rule(g_k6[k], g_xla[k]) for k in LEAF_NAMES}
    print(f"train view 0, first step's state, the table trainer's budgets (max_per_tile {tcfg.max_per_tile}): "
          f"gradients of the trainer's loss, composite.py vs K5/K6: "
          + "; ".join(f"{k} {v['max_of_max']:.3e} of the largest, {v['beyond_atol']:.3e} beyond {K2_ATOL}"
                      for k, v in rules.items())
          + f" (tolerance {K2_MAX_ERR} of the largest, share beyond {K2_ATOL} {K2_MAX_SHARE}); forward and backward "
          f"{bwd_s:.2f} s, peak {bwd_peak:.2f} GiB")
    check(all(v["max_of_max"] <= K2_MAX_ERR and v["beyond_atol"] <= K2_MAX_SHARE for v in rules.values()),
          "the use_pallas=False gradients agree with K5/K6's")
    if on_card:
        with torch.no_grad():
            ms = cuda_ms(lambda: render(cam0, scene, cfg), reps=2)
        print(f"[{smi}] use_pallas=False render of test view 0: {ms:.1f} ms")
        summary.update(nopallas_render_ms=ms)
    summary.update(nopallas_img_err=img_err, nopallas_grad_rules=rules, nopallas_fwd_peak_gib=fwd_peak,
                   nopallas_bwd_peak_gib=bwd_peak, nopallas_bwd_s=bwd_s)
    print(f"section 26b wall time {time.time() - t_sec:.1f} s")


def trace_path(args, device, summary) -> None:
    """Section 27, last of all (a profiler window slows the host's launches
    for the rest of the process): ``utils/profiling.trace`` around one bf16
    render of section 2's scene."""
    import torch

    from gaussian_transformer_tpu_torch.convert import scene_from_numpy
    from gaussian_transformer_tpu_torch.render import RenderConfig, render
    from gaussian_transformer_tpu_torch.utils.profiling import annotate, device_memory_stats, trace

    print("== 27. utils/profiling.trace around one bf16 render of test view 0")
    t_sec = time.time()
    scene = scene_from_numpy(synthetic_scene(args.gaussians, args.seed), active_sh_degree=3, device=device)
    cam = camera_from_c2w(orbit_c2w(0.3), math.radians(50.0), args.width, args.height, device)
    logdir = Path(args.work) / "trace"
    shutil.rmtree(logdir, ignore_errors=True)
    with torch.no_grad():
        render(cam, scene, RenderConfig(precision="bf16"))
        with trace(str(logdir)):
            with annotate("bf16_render"):
                render(cam, scene, RenderConfig(precision="bf16"))
    files = sorted(logdir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"one Chrome trace written into {logdir} ({[f.name for f in files]})")
    text = files[0].read_text()
    names_kernel = "Bf16RowStager" in text  # stream_fwd_bf16's kernel: stream_fwd_kernel<Bf16RowStager>
    print(f"trace {files[0].name}: {len(text)} bytes; names the bf16 span: {'bf16_render' in text}; names the "
          f"stream_fwd_bf16 kernel (stream_fwd_kernel<stream_common::Bf16RowStager>): {names_kernel}")
    if device.type == "cuda":
        check(names_kernel, "the trace names the stream_fwd_bf16 kernel")
    mem = device_memory_stats()
    print(f"device_memory_stats(): {mem}")
    summary.update(trace_bytes=len(text), trace_memory=mem)
    print(f"section 27 wall time {time.time() - t_sec:.1f} s")


def transposed_path(args, device, scene, fovx, test_c2ws, cfg, summary) -> list:
    """Sections 13-14: the transposed-layout stream path
    (``attic.stream_t.stream_image_t``, kernels K7 and K8) serving the test
    views and taking one backward at the trainer's first step, checked
    against the plain versions and the row-layout path (K1, K2), and timed
    in turns with K1 and K2. Returns the K7 and K8 entries of the kernels
    line (none off the card)."""
    import torch

    from gaussian_transformer_tpu_torch.attic import stream_t
    from gaussian_transformer_tpu_torch.config import OptConfig
    from gaussian_transformer_tpu_torch.ops.losses import l1_loss, ssim
    from gaussian_transformer_tpu_torch.render import prepare_stream, render, stream
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
    from gaussian_transformer_tpu_torch.scene.ply import fetch_point_cloud
    from gaussian_transformer_tpu_torch.utils.png import read_png

    on_card = device.type == "cuda"
    W, H = args.width, args.height
    k7_fn, k8_fn = stream_t.STREAM_T_FWD, stream_t.STREAM_T_BWD
    bg = torch.zeros(3, device=device)

    print("== 13. transposed path, serving: the test views through prepare_stream + attic.stream_t.stream_image_t")
    cams = [camera_from_c2w(c2w, fovx, W, H, device) for c2w in test_c2ws]
    k7_fn.launches = 0
    t0 = time.time()
    with torch.no_grad():
        outs = []
        for cam in cams:
            s = prepare_stream(cam, scene)
            p = s.proj
            img, t_map = stream_t.stream_image_t(s.binned, s.means2d, p.conics, p.rgbs, p.opacities, bg,
                                                 grid_w=s.grid_w, grid_h=s.grid_h)
            outs.append((img[:, :H, :W], t_map[:H, :W]))
    t_serve = time.time() - t0
    k7_serve = k7_fn.launches
    print(f"{len(cams)} transposed-path renders: {t_serve:.2f} s; K7 launches {k7_serve}")
    if on_card:
        check(k7_serve == len(cams), f"K7 launched once per rendered view ({len(cams)})")
    check(all(o[0].shape == (3, H, W) and bool(torch.isfinite(o[0]).all()) for o in outs),
          f"every transposed-path image is finite, 3x{H}x{W}")
    with torch.no_grad():
        s = prepare_stream(cams[0], scene)
        props, ct, gw, gh = s.props(), s.chunk_tile, s.grid_w, s.grid_h
        props_t = props.t().contiguous()
        counts = s.binned.tile_counts
        color, t_fin = stream_t.composite_stream_tiles_t(props_t, ct, counts, gw, gh)
        p_color, p_t, (pairs, live) = stream_t.composite_stream_tiles_t_plain(props_t, ct, gw, gh, count_work=True)
        cov = s.binned.covered
        err = torch.cat([(color - p_color)[cov].flatten(), (t_fin - p_t)[cov].flatten()]).abs()
        k7_err, k7_share = float(err.max()), float((err > K1_ATOL).float().mean())
        k7_rows = run_rows(ct, counts, gw * gh, props_t.shape[1] // ct.shape[0])
        print(f"K7: planes [16, {props_t.shape[1]}], chunk {props_t.shape[1] // ct.shape[0]}, {pairs} walked "
              f"(row, pixel) pairs, {live} contributing; rows walked at most (the runs' real rows) "
              f"{k7_rows['real']} of {k7_rows['padded']} in the runs")
        print(f"K7 vs plain: max abs diff {k7_err:.3e} (tolerance {K1_MAX_ERR}), share beyond {K1_ATOL}: "
              f"{k7_share:.3e} (tolerance {K1_MAX_SHARE})")
        check(k7_err <= K1_MAX_ERR and k7_share <= K1_MAX_SHARE, "K7 agrees with its plain version")
        k7_sum = checksum(color, t_fin)
        print(f"K7 checksum of (color, final T) on test view 0: {k7_sum}")
        k7_steps = warp_steps("K7", stream.stream_warp_steps(props_t.t(), ct, counts, gw, gh, absolute=True))
        ref = render(cams[0], scene)
        err = torch.cat([(outs[0][0] - ref["render"]).flatten(), (outs[0][1] - ref["final_T"]).flatten()]).abs()
        tvr_err, tvr_share = float(err.max()), float((err > K1_ATOL).float().mean())
        print(f"transposed vs stream render of view 0: max abs diff {tvr_err:.3e} (tolerance {K1_MAX_ERR}), "
              f"share beyond {K1_ATOL}: {tvr_share:.3e} (tolerance {K1_MAX_SHARE})")
        check(tvr_err <= K1_MAX_ERR and tvr_share <= K1_MAX_SHARE,
              "the transposed-path render agrees with the stream render (K7 with K1)")
    del outs, ref, p_color, p_t, err
    summary.update(transposed_serve_s=t_serve, transposed_k7_pairs=pairs, transposed_k7_live_pairs=live,
                   transposed_vs_stream_err=tvr_err, transposed_k7_checksum=k7_sum, transposed_k7_rows=k7_rows)
    entries = []
    T = gw * gh
    real_rows = int(s.binned.tile_counts.sum())
    if on_card:
        smi = smi_line()
        clk = sm_clock()
        p = s.proj
        with torch.no_grad():
            k1_ms, k7_ms = interleaved_ms([lambda: stream.composite_stream_tiles(props, ct, counts, gw, gh),
                                           lambda: stream_t.composite_stream_tiles_t(props_t, ct, counts, gw, gh)],
                                          rounds=10, reps=5)
            img_ms, img_t_ms = interleaved_ms([
                lambda: stream.stream_image(s.binned, s.means2d, p.conics, p.rgbs, p.opacities, bg, grid_w=gw, grid_h=gh),
                lambda: stream_t.stream_image_t(s.binned, s.means2d, p.conics, p.rgbs, p.opacities, bg,
                                                grid_w=gw, grid_h=gh)], rounds=5, reps=3)
            k7_cold_ms = cuda_ms_cold(lambda: stream_t.composite_stream_tiles_t(props_t, ct, counts, gw, gh), reps=10)
            transpose_ms = cuda_ms(lambda: props.t().contiguous(), reps=20)
            k7_plain_ms = cuda_ms(lambda: stream_t.composite_stream_tiles_t_plain(props_t, ct, gw, gh), reps=2)
        k7_bytes = real_rows * 9 * 4 + T * 4 * 256 * 4 + 2 * T * 4
        k7_ops = pairs * WALK_OPS_PER_PAIR + live * K1_OPS_PER_LIVE
        k7_bound, k7_by = bound(k7_bytes, k7_ops)
        print(f"[{smi}] in turns on view 0's stream: K1 {k1_ms:.4f} ms, K7 {k7_ms:.4f} ms (K7/K1 {k7_ms / k1_ms:.3f}); "
              f"gather to image: rows {img_ms:.3f} ms, transposed {img_t_ms:.3f} ms")
        k7_build = ptxas_report("stream_t_fwd.cu")
        print(f"[{smi}] K7 {k7_ms:.4f} ms (L2 cold {k7_cold_ms:.4f}), transposed copy {transpose_ms:.4f} ms, "
              f"plain {k7_plain_ms:.2f} ms, bound {k7_bound:.4f} ms ({k7_by}: {k7_bytes} B, {k7_ops} fp32 ops); "
              f"{sm_cycles(k7_ms, clk, k7_steps['steps']):.2f} SM cycles per warp step; build {k7_build}")
        print_clocks(clk, "13")
        summary.update(transposed_k1_ms=k1_ms, transposed_k7_ms=k7_ms, transposed_copy_ms=transpose_ms,
                       transposed_image_ms={"rows": img_ms, "transposed": img_t_ms})
        entries.append(
            {"name": "stream_t_fwd", "route": "cuda",
             "source": "gaussian_transformer_tpu_torch/csrc/stream_t_fwd.cu",
             "replaces": "attic/stream_t.py:134",
             "launches": k7_serve, "max_abs_err": k7_err, "ms": k7_ms, "ms_l2_cold": k7_cold_ms,
             "plain_ms": k7_plain_ms, "bound_ms": k7_bound, "bound_by": k7_by, "library_ms": None,
             "tolerance": {"atol": K1_ATOL, "max_share_beyond": K1_MAX_SHARE, "max_abs": K1_MAX_ERR},
             "share_beyond_atol": k7_share, "k1_ms_in_turns": k1_ms, "transpose_ms": transpose_ms,
             "checksum": k7_sum, "warp_steps": k7_steps, "rows": k7_rows, "ptxas": k7_build})
    del s, props, props_t, ct, counts, color, t_fin

    print("== 14. transposed path, gradients: train view 0, first step's state, the trainer's budgets")
    data = Path(args.work) / "train_data"
    g0 = GaussianScene.from_pcd(fetch_point_cloud(str(data / "points3d.ply")), 1,
                                capacity=4 * args.train_points, device=device)
    cam = camera_from_c2w(orbit_c2w(0.0), fovx, W, H, device)
    gt = torch.as_tensor(read_png(str(data / "train" / "r_0.png"))[..., :3].transpose(2, 0, 1) / 255.0,
                         dtype=torch.float32, device=device)
    lam = OptConfig().lambda_dssim

    def train_loss(img):
        img = img[:, :H, :W]
        return (1.0 - lam) * l1_loss(img, gt) + lam * (1.0 - ssim(img, gt))

    with torch.no_grad():
        s = prepare_stream(cam, g0, cfg)
    p, gw, gh = s.proj, s.grid_w, s.grid_h

    def screen_grads(image_fn):
        leaves = [v.detach().clone().requires_grad_() for v in (s.means2d, p.conics, p.rgbs, p.opacities)]
        img = image_fn(s.binned, *leaves, bg, grid_w=gw, grid_h=gh)[0]
        return torch.autograd.grad(train_loss(img), leaves)

    k8_fn.launches = 0
    g_t_path = screen_grads(stream_t.stream_image_t)
    k8_step = k8_fn.launches
    g_row_path = screen_grads(stream.stream_image)
    print(f"one backward through stream_image_t: K8 launches {k8_step}")
    if on_card:
        check(k8_step == 1, "K8 launched once per backward")
    grad_err = {}
    for name, a, b in zip(("means2d", "conics", "rgbs", "opacities"), g_t_path, g_row_path):
        scale = float(b.abs().max())
        e = (a - b).abs()
        grad_err[name] = (float(e.max()) / scale, float((e > K2_ATOL * scale).float().mean()))
        print(f"d loss / d {name}: transposed vs row path max abs diff {grad_err[name][0]:.3e} of max |row| {scale:.3e} "
              f"(tolerance {K2_MAX_ERR}), share beyond {K2_ATOL} of max: {grad_err[name][1]:.3e} (tolerance {K2_MAX_SHARE})")
    check(all(torch.isfinite(g).all() for g in g_t_path)
          and all(m <= K2_MAX_ERR and sh <= K2_MAX_SHARE for m, sh in grad_err.values()),
          "the Gaussians' screen-space gradients through K8 agree with those through K2")
    del g_t_path, g_row_path
    with torch.no_grad():
        props = s.props()
        props_t, ct, counts = props.t().contiguous(), s.chunk_tile, s.binned.tile_counts
        color, final_t = stream_t.composite_stream_tiles_t(props_t, ct, counts, gw, gh)
    # The loss's true cotangents of the compositor's outputs.
    c, t = color.clone().requires_grad_(), final_t.clone().requires_grad_()
    img = stream.tiles_to_image(c, t, s.binned.covered, bg, grid_w=gw, grid_h=gh)[0]
    g_color, g_t = torch.autograd.grad(train_loss(img), [c, t])
    k8_in = (props_t, ct, counts, gw, gh, color, final_t, g_color, g_t)
    plain_in = k8_in[:2] + k8_in[3:]
    chunk = props_t.shape[1] // ct.shape[0]
    k8_rows = run_rows(ct, counts, gw * gh, chunk)
    with torch.no_grad():
        d_plain = stream_t.composite_stream_tiles_t_bwd_plain(*plain_in)
        if not on_card:
            return entries
        d_k8 = stream_t._launch_stream_t_bwd(*k8_in)
        scale = float(d_plain.abs().max())
        err = (d_k8 - d_plain)[:stream.GRAD_F].abs()
        k8_err, k8_share = float(err.max()), float((err > K2_ATOL * scale).float().mean())
        print(f"K8: chunk {chunk}, planes [16, {props_t.shape[1]}], rows walked at most (the runs' real rows) "
              f"{k8_rows['real']} of {k8_rows['padded']} in the runs; K8 vs plain: max abs diff "
              f"{k8_err:.3e} = {k8_err / scale:.3e} of max |plain| {scale:.3e} (tolerance {K2_MAX_ERR}), share beyond "
              f"{K2_ATOL} of max: {k8_share:.3e} (tolerance {K2_MAX_SHARE})")
        check(k8_err <= K2_MAX_ERR * scale and k8_share <= K2_MAX_SHARE
              and bool(torch.all(d_k8[stream.GRAD_F:] == 0)), "K8 agrees with its plain version")
        k8_sum = checksum(d_k8)
        print(f"K8 checksum of the gradient planes on train view 0: {k8_sum}")
    del d_plain, d_k8, err, g0
    smi = smi_line()
    clk = sm_clock()
    k2_in = (props, ct, gw, gh, color, final_t, g_color, g_t)
    with torch.no_grad():
        k2_ms, k8_ms = interleaved_ms([lambda: stream._launch_stream_bwd(*k2_in),
                                       lambda: stream_t._launch_stream_t_bwd(*k8_in)], rounds=10, reps=3)
        k8_cold_ms = cuda_ms_cold(lambda: stream_t._launch_stream_t_bwd(*k8_in), reps=10)
        k8_plain_ms = cuda_ms(lambda: stream_t.composite_stream_tiles_t_bwd_plain(*plain_in), reps=2)
        pairs, live = stream_t.composite_stream_tiles_t_plain(props_t, ct, gw, gh, count_work=True)[2]
    T = gw * gh
    real_rows = int(s.binned.tile_counts.sum())
    k8_bytes = real_rows * 9 * 4 + T * 8 * 256 * 4 + props_t.shape[1] * 16 * 4
    k8_ops = pairs * WALK_OPS_PER_PAIR + live * K6_OPS_PER_LIVE
    k8_bound, k8_by = bound(k8_bytes, k8_ops)
    print(f"[{smi}] in turns on the same inputs: K2 {k2_ms:.4f} ms, K8 {k8_ms:.4f} ms (K2/K8 {k2_ms / k8_ms:.3f}, "
          f"K8/K2 {k8_ms / k2_ms:.3f})")
    k8_build = ptxas_report("stream_t_bwd.cu")
    print(f"[{smi}] K8 {k8_ms:.4f} ms (L2 cold {k8_cold_ms:.4f}), plain {k8_plain_ms:.2f} ms, bound {k8_bound:.4f} ms "
          f"({k8_by}: {k8_bytes} B, {k8_ops} fp32 ops, {pairs} walked pairs, {live} contributing); build {k8_build}")
    if "table_k6_ms" in summary:
        print(f"[{smi}] for reference, K6 on its own inputs (section 12b, train view 0's table): "
              f"{summary['table_k6_ms']:.4f} ms; K8/K6 {k8_ms / summary['table_k6_ms']:.3f}")
    print_clocks(clk, "14")
    summary.update(transposed_k2_ms=k2_ms, transposed_k8_ms=k8_ms, transposed_k8_pairs=pairs,
                   transposed_k8_live_pairs=live, transposed_grad_err=grad_err, transposed_k8_checksum=k8_sum,
                   transposed_k8_rows=k8_rows)
    entries.append(
        {"name": "stream_t_bwd", "route": "cuda",
         "source": "gaussian_transformer_tpu_torch/csrc/stream_t_bwd.cu",
         "replaces": "attic/stream_t.py:222",
         "launches": k8_step, "max_abs_err": k8_err, "ms": k8_ms, "ms_l2_cold": k8_cold_ms,
         "plain_ms": k8_plain_ms, "bound_ms": k8_bound, "bound_by": k8_by, "library_ms": None,
         "tolerance": {"max_abs_of_max": K2_MAX_ERR, "atol_of_max": K2_ATOL, "max_share_beyond": K2_MAX_SHARE},
         "share_beyond_atol": k8_share, "k2_ms_in_turns": k2_ms, "chunk": chunk,
         "stream_rows": props_t.shape[1], "checksum": k8_sum, "rows": k8_rows, "ptxas": k8_build})
    return entries


def probe_path(args, device, summary) -> list:
    """Section 15: the layout probe through its entry point
    (``tools.layout_probe.main``) at ``--probe_rows`` rows, then K9 against
    its plain version on each layout. Returns K9's entry of the kernels line
    (none off the card): its times and bounds summed over the four layouts,
    each layout's record beside them."""
    import torch

    from gaussian_transformer_tpu_torch.tools import layout_probe

    on_card = device.type == "cuda"
    k9_fn = layout_probe.LAYOUT_PROBE
    print(f"== 15. layout probe: K9 on the four layouts at N = {args.probe_rows}")
    clk = sm_clock() if on_card else None
    k9_fn.launches = 0
    records = layout_probe.main(["--rows", str(args.probe_rows)]
                                + ([] if on_card else ["--device", str(device)]))
    k9_launches = k9_fn.launches
    if on_card:
        print_clocks(clk, "15")
        check(k9_launches >= len(layout_probe.LAYOUTS), f"K9 launched on every layout ({k9_launches} launches)")
    errs = []
    for rec, (name, _, _, block) in zip(records, layout_probe.LAYOUTS):
        x = layout_probe.make_layout(name, args.probe_rows, device)
        with torch.no_grad():
            got = layout_probe.block_sums(x, block)
            ref = layout_probe.block_sums_plain(x, block)
            rel = float(((got - ref).abs() / ref.abs()).max())
            errs.append(float((got - ref).abs().max()))
            if on_card:
                rec["plain_ms"] = cuda_ms(lambda: layout_probe.block_sums_plain(x, block), reps=3)
        rec["max_rel_err"] = rel
        print(f"K9 {name}: {rec['blocks']} blocks, max rel diff vs plain {rel:.3e} (tolerance {K9_RTOL})"
              + (f"; {rec['ms']:.4f} ms (L2 cold {rec['ms_l2_cold']:.4f}), {rec['gb_per_s']:.1f} GB/s = "
                 f"{rec['share_of_peak']:.3f} of 3.35 TB/s, torch.sum {rec['library_ms']:.4f} ms, plain "
                 f"{rec['plain_ms']:.3f} ms, extra bytes kernel {rec['extra_bytes']} / torch.sum "
                 f"{rec['library_extra_bytes']}" if on_card else ""))
        check(rel <= K9_RTOL, f"K9 agrees with its plain version on {name}")
        del x
    summary.update(layout_probe=records)
    if not on_card:
        return []
    smi = smi_line()
    total = {k: sum(r[k] for r in records) for k in ("ms", "ms_l2_cold", "plain_ms", "bound_ms", "library_ms")}
    print(f"[{smi}] K9 over the four layouts: {total['ms']:.4f} ms against a bound of {total['bound_ms']:.4f} ms "
          f"(bytes); torch.sum {total['library_ms']:.4f} ms")
    return [
        {"name": "layout_probe", "route": "cuda",
         "source": "gaussian_transformer_tpu_torch/csrc/layout_probe.cu",
         "replaces": "tools/layout_probe.py:47",
         "launches": k9_launches, "max_abs_err": max(errs), "ms": total["ms"], "ms_l2_cold": total["ms_l2_cold"],
         "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"], "bound_by": "bytes",
         "library_ms": total["library_ms"], "tolerance": {"rtol": K9_RTOL},
         "summed_over": [r["layout"] for r in records], "layouts": records},
    ]


STACKED_PARAMS = 1_905_446_400  # STACK 8, d_model 6656, N 2 (the stacked campaign's meta.json)
# The stacked campaign's shape (tools/stacked_campaign.py, logs/stacked_campaign/RUN.md):
# STACK, layers, the scene's Gaussians, its cameras and their size.
STACKED_STACK, STACKED_LAYERS = 8, 2
STACKED_GAUSSIANS, STACKED_VIEWS = 17_618, 32
STACKED_W, STACKED_H = 320, 240
# Section 29b's depth: at full width (d_model 6656) with one layer, 1,107,817,984
# parameters and a 13.3 GB snapshot. Two layers (22.9 GB) cost the script
# ~30 s more, which its 1,200 s limit does not leave.
ORBAX_LAYERS = 1
SERVING_REPS = 20  # cached decodes timed one by one, before and after a profiler window
TOKEN_NOISE = 0.01  # N(0, sigma) on the targets of the open-gate step and of section 18
DECODE_REL = 1e-4  # teacher-forced cached decode vs the decoder's rows, of max |row|
# The same in bf16: one bf16 rounding is 2^-8 = 3.9e-3 relative, and a
# product over the one row of a decode step rounds otherwise than over the
# sequence (tests/test_torch_bf16.py holds the CPU to the same bound).
DECODE_REL_BF16 = 2e-2
IMAGE_LOSS_REL = 1e-5  # image loss on the card vs its CPU copy (plain K1-K4), relative
IMAGE_GRAD_REL = K2_MAX_ERR  # its token gradient, of the largest (K2's rule)


def stacked_param_count(stack: int, layers: int) -> int:
    """The encoder-decoder's parameters in closed form, D = d_model = token
    dim = 26 * 2^stack and d_ff 2D: an encoder layer 7D^2 + 11D, a decoder
    layer 11D^2 + 17D, the two embeddings, the generator and the two final
    norms 7D^2 + 11D."""
    D = 26 * 2**stack
    return layers * (18 * D * D + 28 * D) + 7 * D * D + 11 * D


def param_fingerprint(model) -> dict:
    """Per parameter, (sum, sum of |x|) in float64: equal fingerprints for
    equal tensors, so a step that moves a parameter changes its entry."""
    import torch

    with torch.no_grad():
        return {n: (float(p.double().sum()), float(p.double().abs().sum())) for n, p in model.named_parameters()}


def cuda_ms_each(fn, reps: int, warmup: int = 1) -> list:
    """CUDA-event ms of each of ``reps`` calls of ``fn``, timed one by one."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def spread(times) -> str:
    return f"median {np.median(times):.3f} ms (min {min(times):.3f}, max {max(times):.3f}, {len(times)} reps)"


def stacked_path(args, device, summary, stack=STACKED_STACK, layers=STACKED_LAYERS, gaussians=STACKED_GAUSSIANS,
                 views=STACKED_VIEWS, width=STACKED_W, height=STACKED_H) -> dict:
    """Sections 16-18: the stacked transformer at full width (STACK 8,
    d_model 6656, N 2; smaller sizes only for a rehearsal on the CPU).
    Returns the launches of K1-K4 on its paths (the CLI's epoch, one
    open-gate train step and one image-branch call), by kernel."""
    import gc
    import shutil

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from gaussian_transformer_tpu_torch import kernels
    from gaussian_transformer_tpu_torch.cli import train_stacked as cli_stacked
    from gaussian_transformer_tpu_torch.convert import scene_from_numpy
    from gaussian_transformer_tpu_torch.models.codec import fuzzy_token_equal, unstack_tokens
    from gaussian_transformer_tpu_torch.models.decode_cache import (
        decode_step,
        greedy_decode_cached,
        init_decode_state,
    )
    from gaussian_transformer_tpu_torch.models.transformer import count_params, subsequent_mask
    from gaussian_transformer_tpu_torch.ops import fused_ssim
    from gaussian_transformer_tpu_torch.ops.losses import l1_loss
    from gaussian_transformer_tpu_torch.render import RenderConfig, prepare_stream, render, stream
    from gaussian_transformer_tpu_torch.scene import Scene
    from gaussian_transformer_tpu_torch.train import stacked

    on_card = device.type == "cuda"
    smi = smi_line() if on_card else "cpu"
    W, H, fovx = width, height, math.radians(50.0)
    work = Path(args.work) / "stacked"
    shutil.rmtree(work, ignore_errors=True)
    data, model_dir, run_dir = work / "data", work / "model", work / "run"
    counters = kernel_counters()
    out = {}

    def peak(section):
        if on_card:
            report_peak(summary, f"stacked_peak_gib_{section}", section, smi)

    print(f"== 16. stacked transformer: model dir, first batch, serving (STACK {stack}, {layers} layers)")
    if on_card:
        kernels.build(kernels.all_sources())  # before any timing (one nvcc per source, in parallel)
        torch.cuda.reset_peak_memory_stats()
    random.seed(args.seed)  # Scene shuffles its cameras with Python's random, as the reference does
    fields = synthetic_scene(gaussians, args.seed + 5)
    fields["features_rest"] = fields["features_rest"][:, :3]  # SH degree 1, as the stacked CLI loads it
    scene = scene_from_numpy(fields, 1, device)
    write_train_dataset(data, scene, surface_points(2000, args.seed + 5), views, 1, W, H, fovx, device)
    scene.save_ply(str(model_dir / "point_cloud" / "iteration_30000" / "point_cloud.ply"))
    del scene
    ns = Namespace(sh_degree=1, source_path=str(data), model_path=str(model_dir), images="images",
                   resolution=-1, white_background=False, data_device=str(device), eval=True)
    tscene = stacked.TrainingScene(Scene(ns, load_iteration=-1, sh_degree=1, device=device), RenderConfig(),
                                   batch_size=4, stack=stack)
    tscene.set_epoch(0)
    batch = next(b for b in tscene.batches() if b is not None)
    Ls, Lt = batch.src.shape[1], batch.trg_y.shape[1]
    print(f"{gaussians} Gaussians, {tscene.size} cameras at {W}x{H}; first batch: src {Ls} fat "
          f"tokens, trg {Lt} ({batch.ntokens} real), token dim {batch.src.shape[2]}")
    summary.update(stacked_src_len=Ls, stacked_trg_len=Lt, stacked_ntokens=batch.ntokens)

    model = stacked.make_stacked_model(stack, layers, 0, seed=0, device=device).eval()
    n_params = count_params(model)
    print(f"model: {n_params} parameters (float32); TF32 matmuls: {torch.backends.cuda.matmul.allow_tf32}")
    check(n_params == stacked_param_count(stack, layers),
          f"{n_params} parameters == {stacked_param_count(stack, layers)} (closed form)")
    if (stack, layers) == (STACKED_STACK, STACKED_LAYERS):
        check(n_params == STACKED_PARAMS, f"{n_params} parameters == {STACKED_PARAMS} (the campaign's meta.json)")
    fingerprint = param_fingerprint(model)
    start = stacked.start_token(stack)
    with torch.no_grad():
        ys = stacked.greedy_decode(model, batch.src, batch.src_mask, Lt + 1, stack)
        rows = model.generator(model.decode(model.encode(batch.src, batch.src_mask), batch.src_mask, ys,
                                            subsequent_mask(Lt + 1, device)))
        state = init_decode_state(model, batch.src, batch.src_mask, Lt + 1)
        tf_err = max(float((decode_step(model, state, ys[:, i:i + 1], i) - rows[:, i]).abs().max())
                     for i in range(Lt + 1))
        scale = float(rows.abs().max())
        cached = greedy_decode_cached(model, batch.src, batch.src_mask, Lt + 1, start)
        free_err = float((cached - ys).abs().max())
    print(f"teacher-forced decode_step vs the decoder's rows: max abs diff {tf_err:.3e} of max |row| {scale:.3e} "
          f"(tolerance {DECODE_REL} x max)")
    check(math.isfinite(tf_err) and tf_err <= DECODE_REL * scale, "the cached decode matches the scan decode, teacher-forced")
    print(f"free-running greedy_decode_cached vs greedy_decode: max abs diff {free_err:.3e} (of max |ys| "
          f"{float(ys.abs().max()):.3e})")
    check(math.isfinite(free_err), "the free-running cached decode is finite")
    summary.update(stacked_params=n_params, stacked_teacher_forced_err=tf_err, stacked_row_scale=scale,
                   stacked_free_running_err=free_err)
    if on_card:
        # A decode step reads every decoder weight but the cross-attention
        # K/V projections (applied once, to the encoder memory), the target
        # embedding and the generator: its bytes bound the ms per token.
        step_bytes = 4 * sum(p.numel() for n, p in model.named_parameters()
                             if n.startswith(("decoder.", "tgt_embed.", "generator_proj."))
                             and ".src_attn.k." not in n and ".src_attn.v." not in n)
        token_bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
        run_cached = lambda: greedy_decode_cached(model, batch.src, batch.src_mask, Lt + 1, start)
        clk = sm_clock()
        with torch.no_grad():
            cached_ms = cuda_ms_each(run_cached, SERVING_REPS)
            scan_ms = cuda_ms_each(lambda: stacked.greedy_decode(model, batch.src, batch.src_mask, Lt + 1, stack),
                                   reps=5)
        med = float(np.median(cached_ms))
        print(f"[{smi}] serving: greedy_decode_cached of {Lt} tokens (encoder included), {spread(cached_ms)} "
              f"= {med / Lt:.3f} ms/token; bound by the decode step's {step_bytes / 1e9:.3f} GB of weights: "
              f"{token_bound_ms:.3f} ms/token")
        print(f"[{smi}] scan greedy_decode for the window: {spread(scan_ms)}")
        print_clocks(clk, "16")
        summary.update(stacked_cached_ms=cached_ms, stacked_cached_ms_per_token=med / Lt,
                       stacked_token_bound_ms=token_bound_ms, stacked_scan_ms=scan_ms)
    del model, ys, rows, state, cached
    gc.collect()
    peak("16")

    print("== 17. main path: cli.train_stacked for one epoch")
    zero_counts(counters)
    dev_arg = [] if on_card else ["--device", str(device)]
    t0 = time.time()
    res = cli_stacked.main(["-s", str(data), "-m", str(model_dir), "--eval", "--epochs", "1", "--stack",
                            str(stack), "--layers", str(layers), "--run_name", str(run_dir),
                            "--quiet"] + dev_arg)
    t_cli = time.time() - t0
    launches = read_counts(counters)
    hist = res["history"]
    n_steps = tscene.size // 4
    print(f"cli.train_stacked: {len(hist)} steps in {t_cli:.1f} s; launches {launches}")
    print("by step: " + "; ".join(f"loss {h['loss']:.4f} chamfer {h['chamfer']:.4f} img {h['img_loss']:.4f} "
                                  f"src {h['src_len']} trg {h['trg_len']}" for h in hist))
    check(len(hist) == n_steps, f"{n_steps} steps at batch 4 over {tscene.size} cameras")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["chamfer"]) for h in hist),
          "every step's loss and chamfer are finite")
    img_steps = sum(h["img_loss"] != 0.0 for h in hist)
    if on_card:
        check(launches["K1"] == tscene.size + 2 * 4 * img_steps,
              f"K1 launched once per camera's visibility render ({tscene.size}) and 8 times per image-branch "
              f"step ({img_steps})")
    after = param_fingerprint(res["model"])
    moved = [n for n in after if after[n] != fingerprint[n]]
    still = [n for n in after if n not in moved and not n.endswith("attn.k.bias")]
    print(f"parameters moved by the epoch: {len(moved)} of {len(after)} (unmoved: "
          f"{[n for n in after if n not in moved]})")
    check(not still, "every parameter but the attention key biases (zero gradient) changed")
    summary.update(stacked_cli_s=t_cli, stacked_history=hist, stacked_cli_launches=launches,
                   stacked_image_steps=img_steps)
    out["cli"] = launches
    step_fn = stacked.make_train_step(res["model"], res["tscene"].handler, RenderConfig(), res["optimizer"], stack)
    if on_card:
        step_ms = float(np.median([h["ms"] for h in hist]))
        print(f"[{smi}] median train step {step_ms:.2f} ms over {len(hist)} steps (CUDA events); "
              f"steps {[round(h['ms'], 2) for h in hist]}")
        summary["stacked_step_ms"] = step_ms
        peak("17")

    # One more step of the trained state with the chamfer gate open: its
    # target is the model's own decode under the step's dropout key (the
    # step decodes the same tokens) plus noise, so chamfer reads ~0.005.
    print(f"== 17b. an open-gate train step: the target is the model's own decode plus N(0, {TOKEN_NOISE})")
    key = (42, 10**6 + 1)
    real = ~fuzzy_token_equal(batch.trg_y, stacked.pad_token(stack))  # [1, Lt]
    with torch.no_grad():
        own = stacked.greedy_decode(res["model"], batch.src, batch.src_mask, Lt + 1, stack, key)[:, 1:]
        noise = torch.randn(own.shape, generator=torch.Generator(device).manual_seed(args.seed + 1), device=device)
        trg_open = torch.where(real[..., None], own + TOKEN_NOISE * noise, batch.trg_y)
    zero_counts(counters)
    if on_card:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    gate_loss, met = step_fn(batch.src, trg_open, batch.cameras, 5e-4, batch.src_mask, key)
    gate = {"launches": read_counts(counters), "loss": float(gate_loss), "chamfer": float(met["chamfer"]),
            "img_loss": float(met["img_loss"]), "overflow": met["overflow"].tolist() if "overflow" in met else None}
    if on_card:
        ev[1].record()
        torch.cuda.synchronize()
        gate["ms"] = ev[0].elapsed_time(ev[1])
    # A decoded Gaussian whose projected covariance overflows float32 gives
    # a non-finite gradient, in the JAX package's projection as here; Adam
    # then writes it into the parameters. Reported, not held.
    gate["params_finite"] = all(bool(torch.isfinite(q).all()) for q in res["model"].parameters())
    print(f"loss {gate['loss']:.6f}, chamfer {gate['chamfer']:.6f}, image loss {gate['img_loss']:.6f}; launches "
          f"{gate['launches']}; overflow (pred, target) {gate['overflow']}; parameters finite after the step: "
          f"{gate['params_finite']}")
    check(gate["chamfer"] < 3.0 and gate["img_loss"] > 0 and math.isfinite(gate["loss"]),
          "the chamfer gate opened, with a finite loss")
    if on_card:
        check(gate["launches"] == {"K1": 8, "K2": 4, "K3": 1, "K4": 1},
              "K1 per pred and target render (8), K2 per pred render (4), K3 and K4 once")
        gate["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"[{smi}] open-gate train step {gate['ms']:.2f} ms (CUDA events, one step); peak memory "
              f"{gate['peak_gib']:.2f} GiB (torch.cuda.max_memory_allocated)")
        torch.cuda.reset_peak_memory_stats()
    summary["stacked_open_gate"] = gate
    out["open_gate_step"] = gate["launches"]
    del own, noise, trg_open, gate_loss, met

    if on_card:
        # Two more steps on the first batch (gate shut): one profiled (after
        # a warm one), one with its matmul FLOPs counted.
        run_step = lambda: step_fn(batch.src, batch.trg_y, batch.cameras, 5e-4, batch.src_mask, (42, 10**6))
        profile, device_ms, wall_ms, _ = step_profile(run_step)
        print(f"top CUDA kernels of one stacked train step (torch.profiler, device time):\n{profile}")
        print(f"[{smi}] profiled step: {device_ms:.2f} ms of kernel time in {wall_ms:.2f} ms "
              f"(device idle {1 - device_ms / wall_ms:.3f} of the step)")
        with FlopCounterMode(display=False) as fc:
            run_step()
        del run_step
        flops = fc.get_total_flops()
        bound_ms = flops / PEAK_FP32_FLOPS * 1e3
        print(f"[{smi}] one train step on the first batch: {flops:.4e} matmul FLOPs (FlopCounterMode, "
              f"checkpoint recomputation included) = {bound_ms:.2f} ms at the float32 non-tensor peak "
              f"({PEAK_FP32_FLOPS:.3g} FLOP/s), {bound_ms / step_ms:.3f} of the median step")
        summary.update(stacked_step_flops=flops, stacked_step_bound_ms=bound_ms,
                       stacked_step_flop_share=bound_ms / step_ms, stacked_step_profile=profile,
                       stacked_step_device_ms=device_ms, stacked_step_wall_ms=wall_ms)
    del res, step_fn
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        peak("17b")

    print(f"== 18. the image branch: image_loss on the first batch's targets, pred = target + N(0, {TOKEN_NOISE})")
    tgt = unstack_tokens(batch.trg_y[0], stack)
    valid = (~fuzzy_token_equal(batch.trg_y[0], stacked.pad_token(stack))).repeat_interleave(2**stack)
    noise = torch.randn(tgt.shape, generator=torch.Generator(device).manual_seed(args.seed), device=device)
    pred = (tgt + TOKEN_NOISE * noise).requires_grad_()
    zero_counts(counters)
    loss, overflow = stacked.image_loss(pred, tgt, valid, tscene.handler, batch.cameras, RenderConfig())
    loss.backward()
    img_launches = read_counts(counters)
    grad = pred.grad
    loss = loss.detach()
    print(f"image loss {float(loss):.6f} over {len(batch.cameras)} cameras, {int(valid.sum())} real Gaussians; "
          f"overflow (pred, target) {overflow.tolist()}; launches {img_launches}")
    if on_card:
        check(img_launches == {"K1": 8, "K2": 4, "K3": 1, "K4": 1},
              "K1 per pred and target render (8), K2 per pred render (4), K3 and K4 once")
    check(int(overflow[1].sum()) == 0, "overflow == 0 for the target renders")
    check(bool(torch.isfinite(grad).all()) and float(grad[valid].abs().max()) > 0,
          "the gradient reaches the predicted tokens finite and nonzero")
    check(float(grad[~valid].abs().sum()) == 0.0, "PAD rows get no gradient")
    summary.update(stacked_image_loss=float(loss), stacked_image_launches=img_launches,
                   stacked_image_overflow=overflow.tolist())
    out["image_loss"] = img_launches

    # K1-K4 against their plain versions on this call's tensors: camera 0's
    # target render (K1); the pred and target images and SSIM's cotangent
    # (K3, K4); camera 0's pred render with the loss's true cotangents of its
    # compositor outputs (K2). On the CPU the plain versions stand in for
    # K2-K4's launch functions (K1's wrapper takes them itself).
    n_cams = len(batch.cameras)
    k_bwd = stream._launch_stream_bwd if on_card else stream.composite_stream_tiles_bwd_plain
    k_ssim = fused_ssim._launch_ssim_fwd if on_card else fused_ssim.ssim_plain
    k_ssim_bwd = fused_ssim._launch_ssim_bwd if on_card else fused_ssim.ssim_bwd_plain
    with torch.no_grad():
        g_pred = tscene.handler.denormalize(stacked.unflatten_gaussians(pred.detach())).replace(alive=valid)
        g_tgt = tscene.handler.denormalize(stacked.unflatten_gaussians(tgt)).replace(alive=valid)
        s = prepare_stream(batch.cameras[0], g_tgt)
        props, ct = s.props(), s.chunk_tile
        color, t_fin = stream.composite_stream_tiles(props, ct, s.binned.tile_counts, s.grid_w, s.grid_h)
        p_color, p_t = stream.composite_stream_tiles_plain(props, ct, s.grid_w, s.grid_h)[:2]
        cov = s.binned.covered
        k1_err = float(torch.cat([(color - p_color)[cov].flatten(), (t_fin - p_t)[cov].flatten()]).abs().max())
        clip = lambda img: torch.clamp(torch.nan_to_num(img), 0.0, 1.0)
        imgs = torch.stack([clip(render(c, g_pred)["render"]) for c in batch.cameras])
        tgts = torch.stack([clip(render(c, g_tgt)["render"]) for c in batch.cameras])
        s = prepare_stream(batch.cameras[0], g_pred)
        props, ct, gw, gh = s.props(), s.chunk_tile, s.grid_w, s.grid_h
        color, t_fin = stream.composite_stream_tiles(props, ct, s.binned.tile_counts, gw, gh)
    c, t = color.clone().requires_grad_(), t_fin.clone().requires_grad_()
    img0 = stream.tiles_to_image(c, t, s.binned.covered, torch.zeros(3, device=device), grid_w=gw, grid_h=gh)[0]
    images = torch.cat([clip(img0[:, :H, :W])[None], imgs[1:]])
    loss_0 = (l1_loss(images, tgts) * (5.0 / n_cams) * 0.1
              + (1.0 - fused_ssim.ssim_plain(images, tgts)) * (0.2 / n_cams) * 0.1)
    g_color, g_t = torch.autograd.grad(loss_0, [c, t])
    with torch.no_grad():
        k2_in = (props, ct, gw, gh, color, t_fin, g_color, g_t)
        d_k2 = k_bwd(*k2_in)
        d_plain = stream.composite_stream_tiles_bwd_plain(*k2_in)
        scale2 = float(d_plain.abs().max())
        err2 = (d_k2 - d_plain)[:, :stream.GRAD_F].abs()
        k2_err, k2_share = float(err2.max()), float((err2 > K2_ATOL * scale2).float().mean())
        a, b = fused_ssim._flatten(imgs), fused_ssim._flatten(tgts)
        k3, k3_plain = float(k_ssim(a, b)), float(fused_ssim.ssim_plain(a, b))
        k3_err = abs(k3 - k3_plain)
        g_ssim = torch.full((), -0.02 / n_cams, device=device)  # d loss / d SSIM
        d_k4, d_p4 = k_ssim_bwd(a, b, g_ssim), fused_ssim.ssim_bwd_plain(a, b, g_ssim)
        scale4 = max(float(d.abs().max()) for d in d_p4)
        k4_err = max(float((x - y).abs().max()) for x, y in zip(d_k4, d_p4))
    print(f"K1 vs plain on camera 0's target render: max abs diff {k1_err:.3e} (tolerance {K1_MAX_ERR})")
    print(f"K2 vs plain on camera 0's pred render ({props.shape[0]} stream rows): max abs diff {k2_err:.3e} = "
          f"{k2_err / scale2:.3e} of max |plain| {scale2:.3e} (tolerance {K2_MAX_ERR}), share beyond {K2_ATOL} "
          f"of max: {k2_share:.3e} (tolerance {K2_MAX_SHARE})")
    print(f"K3 vs plain on the {n_cams} pred and target images: SSIM {k3:.7f} vs {k3_plain:.7f}, abs diff "
          f"{k3_err:.3e} (tolerance {K3_ATOL})")
    print(f"K4 vs plain on them at SSIM's cotangent {float(g_ssim):.4e}: max abs diff {k4_err:.3e} = "
          f"{k4_err / scale4:.3e} of max |plain| {scale4:.3e} (tolerance {K4_MAX_ERR})")
    check(k1_err <= K1_MAX_ERR, "K1 agrees with its plain version at the stacked path's shapes")
    check(k2_err <= K2_MAX_ERR * scale2 and k2_share <= K2_MAX_SHARE and bool(torch.all(d_k2[:, stream.GRAD_F:] == 0)),
          "K2 agrees with its plain version at the stacked path's shapes")
    check(k3_err <= K3_ATOL, "K3 agrees with its plain version at the stacked path's shapes")
    check(k4_err <= K4_MAX_ERR * scale4, "K4 agrees with its plain version at the stacked path's shapes")
    summary.update(stacked_k1_err=k1_err, stacked_k2_err=k2_err, stacked_k2_scale=scale2, stacked_k2_share=k2_share,
                   stacked_k3_err=k3_err, stacked_k4_err=k4_err, stacked_k4_scale=scale4)
    if on_card:
        # The same call on CPU copies runs the plain versions of K1-K4.
        cpu = lambda t: t.detach().cpu()
        p_cpu = cpu(pred).requires_grad_()
        handler = type(tscene.handler)(*(cpu(t) for t in (tscene.handler.world_min, tscene.handler.world_max,
                                                            tscene.handler.scaling_min, tscene.handler.scaling_max)),
                                       tscene.handler.interval_num)
        cams = [cpu_camera(c) for c in batch.cameras]
        loss_cpu, _ = stacked.image_loss(p_cpu, cpu(tgt), cpu(valid), handler, cams, RenderConfig())
        loss_cpu.backward()
        loss_cpu = loss_cpu.detach()
        l_err = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
        g_scale = float(p_cpu.grad.abs().max())
        g_err = float((cpu(grad) - p_cpu.grad).abs().max())
        print(f"image loss on the card (K1-K4) vs on the CPU (plain versions): loss rel diff {l_err:.3e} "
              f"(tolerance {IMAGE_LOSS_REL}), token gradient max abs diff {g_err:.3e} = {g_err / g_scale:.3e} of "
              f"max {g_scale:.3e} (tolerance {IMAGE_GRAD_REL})")
        check(l_err <= IMAGE_LOSS_REL and g_err <= IMAGE_GRAD_REL * g_scale,
              "the image branch agrees with its plain versions")
        summary.update(stacked_image_loss_rel_err=l_err, stacked_image_grad_err=g_err,
                       stacked_image_grad_scale=g_scale)
        peak("18")

    stacked_tier_path(args, device, summary, data, model_dir, work, tscene, batch, stack, layers)
    orbax_fsdp_path(args, device, summary, data, model_dir, work, stack, min(layers, ORBAX_LAYERS))
    # Sections 32, 32b and 16b: section 16's model again.
    model = stacked.make_stacked_model(stack, layers, 0, seed=0, device=device).eval()
    viewer = stacked_viewer_path(args, device, summary, model, tscene, batch, stack)
    summary["stacked_stream_launches"] = viewer["stream"]
    summary["stacked_stream_fsdp_launches"] = fsdp_viewer_path(args, device, summary, tscene, batch, stack, layers,
                                                               viewer)
    del viewer
    model.eval()
    if on_card:
        # Last, as a torch.profiler window slows the host's launches for the
        # rest of the process: one cached decode profiled, then the same
        # timings as section 16's.
        print("== 16b. serving under torch.profiler: the cached decode's kernels and device idle share")
        run_cached = lambda: greedy_decode_cached(model, batch.src, batch.src_mask, Lt + 1, start)
        clk = sm_clock()
        with torch.no_grad():
            _, busy_ms, wall_ms, n_kernels = step_profile(run_cached)
            after_ms = cuda_ms_each(run_cached, SERVING_REPS)
        after_med = float(np.median(after_ms))
        print(f"[{smi}] one cached decode under torch.profiler: {n_kernels} kernels ({n_kernels / Lt:.1f} a token), "
              f"{busy_ms:.2f} ms of kernel time ({busy_ms / Lt:.3f} a token) in {wall_ms:.2f} ms "
              f"(device idle {1 - busy_ms / wall_ms:.3f})")
        print(f"[{smi}] the cached decode after the profiler windows of sections 17 and 16b: {spread(after_ms)} "
              f"= {after_med / Lt:.3f} ms/token ({after_med / med:.3f} of section 16's)")
        print_clocks(clk, "16b")
        summary.update(stacked_cached_busy_ms=busy_ms, stacked_cached_wall_ms=wall_ms,
                       stacked_cached_kernels=n_kernels, stacked_cached_after_profiler_ms=after_ms)
    del model
    return out


CAMPAIGN_STEPS = 8  # one epoch of the campaign's loop: 32 ring cameras at batch 4


def campaign_dtype_rule(name: str, param_dtype):
    """The flax tree's dtype of a parameter: LayerNorm scales and shifts and
    the generator head float32, everything else ``param_dtype``."""
    import torch

    if name.endswith((".a_2", ".b_2")) or name.startswith("generator_proj."):
        return torch.float32
    return param_dtype


def campaign_path(args, device, summary, smoke=False, gaussians=None) -> dict:
    """Section 24: the stacked campaign's recipe (``tools/stacked_campaign.py``)
    at full width (STACK 8, d_model 6656, N 2, bf16 parameters, Adafactor,
    bucket 96); ``smoke`` (the tool's ``--smoke`` sizes, float32
    parameters) and ``gaussians`` only for a rehearsal on the CPU. Returns
    the launches of K1-K4 on its paths (the campaign's epoch and one
    open-gate step), by kernel."""
    import gc
    import shutil

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from gaussian_transformer_tpu_torch import kernels
    from gaussian_transformer_tpu_torch.models.codec import fuzzy_token_equal, unstack_tokens
    from gaussian_transformer_tpu_torch.models.decode_cache import (
        decode_step,
        greedy_decode_cached,
        init_decode_state,
    )
    from gaussian_transformer_tpu_torch.models.transformer import count_params, subsequent_mask
    from gaussian_transformer_tpu_torch.render import RenderConfig
    from gaussian_transformer_tpu_torch.tools import stacked_campaign as campaign
    from gaussian_transformer_tpu_torch.train import stacked
    from gaussian_transformer_tpu_torch.train.adafactor import Adafactor

    on_card = device.type == "cuda"
    smi = smi_line() if on_card else "cpu"
    work = Path(args.work) / "campaign"
    shutil.rmtree(work, ignore_errors=True)
    counters = kernel_counters()
    out = {}

    print(f"== 24. the stacked campaign's recipe: tools.stacked_campaign for one epoch ({CAMPAIGN_STEPS} steps, "
          f"batch 4{', --smoke' if smoke else ', bucket 96, bf16 parameters'}, Adafactor)")
    if on_card:
        kernels.build(kernels.all_sources())
        torch.cuda.reset_peak_memory_stats()
    argv = ["--steps", str(CAMPAIGN_STEPS), "--out", str(work), "--ckpt_every", str(10 * CAMPAIGN_STEPS)]
    argv += (["--smoke"] if smoke else []) + ([] if on_card else ["--device", str(device)])
    zero_counts(counters)
    t0 = time.time()
    res = campaign.main(argv, campaign.GAUSSIANS if gaussians is None else gaussians)
    t_run = time.time() - t0
    launches = read_counts(counters)
    model, opt, tscene, hist = res["model"], res["optimizer"], res["tscene"], res["history"]
    stack = res["meta"]["stack"]
    n_params = count_params(model)
    print(f"tools.stacked_campaign: {len(hist)} steps in {t_run:.1f} s; launches {launches}; model {n_params} "
          f"parameters, dtype {model.dtype}, param_dtype {model.param_dtype}")
    print("by step: " + "; ".join(f"loss {h['loss']:.4f} chamfer {h['chamfer']:.4f} img {h['img_loss']:.4f} "
                                  f"src {h['src_len']} trg {h['trg_len']}" for h in hist))
    check(n_params == stacked_param_count(stack, 2), f"{n_params} parameters == {stacked_param_count(stack, 2)}")
    if not smoke:
        check(n_params == STACKED_PARAMS, f"{n_params} parameters == {STACKED_PARAMS} (the campaign's meta.json)")
        check(model.dtype == model.param_dtype == torch.bfloat16, "the campaign's model is bf16 in dtype and "
                                                                  "param_dtype")
    wrong = [(n, p.dtype) for n, p in model.named_parameters() if p.dtype != campaign_dtype_rule(n, model.param_dtype)]
    n_f32 = sum(p.numel() for p in model.parameters() if p.dtype == torch.float32)
    print(f"parameter dtypes: {n_params - n_f32} in {model.param_dtype}, {n_f32} in float32 (LayerNorms, generator)")
    check(not wrong, f"every parameter's dtype is the flax tree's (wrong: {wrong[:4]})")
    check(len(hist) == CAMPAIGN_STEPS and all(math.isfinite(h["loss"]) and math.isfinite(h["chamfer"]) for h in hist),
          f"{CAMPAIGN_STEPS} steps, every loss and chamfer finite")
    img_steps = sum(h["img_loss"] != 0.0 for h in hist)
    if on_card:
        check(launches["K1"] == tscene.size + 2 * 4 * img_steps,
              f"K1 launched once per camera's visibility render ({tscene.size}) and 8 times per image-branch step "
              f"({img_steps})")
        step_ms = [h["cuda_ms"] for h in hist]
        med = float(np.median(step_ms))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        print(f"[{smi}] campaign steps (CUDA events): {[round(x, 2) for x in step_ms]}; median {med:.2f} ms, median "
              f"of steps 2-{len(hist)} {np.median(step_ms[1:]):.2f} ms; peak memory {peak_gib:.2f} GiB "
              f"(torch.cuda.max_memory_allocated)")
        summary.update(campaign_step_ms=step_ms, campaign_step_median_ms=med, campaign_peak_gib=peak_gib)
    summary.update(campaign_s=t_run, campaign_history=hist, campaign_launches=launches, campaign_image_steps=img_steps)
    out["campaign_epoch"] = launches

    # The checkpoint the run saved at its end, read back into a fresh model.
    tag = f"step{res['global_step']}"
    ckpt = work / f"checkpoint_{tag}"
    size = sum(f.stat().st_size for f in ckpt.iterdir())
    fresh = stacked.make_stacked_model(stack, 2, 0, seed=1, device=device, dtype=model.dtype,
                                       param_dtype=model.param_dtype)
    fresh_opt = Adafactor(fresh.parameters())
    t0 = time.time()
    stacked.load_checkpoint(str(work), tag, fresh, fresh_opt)
    t_load = time.time() - t0
    same_p = all(torch.equal(a, b) for a, b in zip(model.parameters(), fresh.parameters()))
    same_s = all(opt.state[a]["step"] == fresh_opt.state[b]["step"]
                 and all(torch.equal(opt.state[a][k], fresh_opt.state[b][k]) for k in ("v_row", "v_col", "v"))
                 for a, b in zip(model.parameters(), fresh.parameters()))
    print(f"checkpoint_{tag}: {size / 1e9:.3f} GB on disk, read back in {t_load:.1f} s; parameters equal bit for bit: "
          f"{same_p}; Adafactor state (count, v_row, v_col, v) equal: {same_s}")
    check(same_p and same_s, "the checkpoint reloads bit for bit")
    summary.update(campaign_ckpt_bytes=size, campaign_ckpt_load_s=t_load)
    del fresh, fresh_opt
    gc.collect()

    tscene.set_epoch(0)
    batch = next(b for b in tscene.batches() if b is not None)
    Lt = batch.trg_y.shape[1]
    step_fn = stacked.make_train_step(model, tscene.handler, RenderConfig(), opt, stack)
    if on_card:
        with FlopCounterMode(display=False) as fc:
            step_fn(batch.src, batch.trg_y, batch.cameras, 5e-4, batch.src_mask, (42, 10**6))
        flops = fc.get_total_flops()
        bf16_ms, fp32_ms = flops / PEAK_BF16_FLOPS * 1e3, flops / PEAK_FP32_FLOPS * 1e3
        print(f"[{smi}] one campaign step (src {batch.src.shape[1]}, trg {Lt}): {flops:.4e} matmul FLOPs "
              f"(FlopCounterMode, checkpoint recomputation included) = {bf16_ms:.2f} ms at the bf16 dense peak "
              f"({PEAK_BF16_FLOPS:.3g} FLOP/s), {bf16_ms / med:.3f} of the median step; {fp32_ms:.1f} ms at the "
              f"float32 peak ({PEAK_FP32_FLOPS:.3g}), {fp32_ms / med:.3f} of it")
        summary.update(campaign_step_flops=flops, campaign_flop_share_bf16=bf16_ms / med,
                       campaign_flop_share_fp32=fp32_ms / med)

    print(f"== 24b. an open-gate bf16 step: the target is the model's own decode plus N(0, {TOKEN_NOISE})")
    key = (42, 10**6 + 1)
    real = ~fuzzy_token_equal(batch.trg_y, stacked.pad_token(stack))  # [1, Lt]
    with torch.no_grad():
        own = stacked.greedy_decode(model, batch.src, batch.src_mask, Lt + 1, stack, key)[:, 1:]
        noise = torch.randn(own.shape, generator=torch.Generator(device).manual_seed(args.seed + 1), device=device)
        trg_open = torch.where(real[..., None], own + TOKEN_NOISE * noise, batch.trg_y)
    zero_counts(counters)
    if on_card:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    gate_loss, met = step_fn(batch.src, trg_open, batch.cameras, 5e-4, batch.src_mask, key)
    gate = {"launches": read_counts(counters), "loss": float(gate_loss), "chamfer": float(met["chamfer"]),
            "img_loss": float(met["img_loss"]), "overflow": met["overflow"].tolist() if "overflow" in met else None}
    if on_card:
        ev[1].record()
        torch.cuda.synchronize()
        gate["ms"] = ev[0].elapsed_time(ev[1])
    gate["params_finite"] = all(bool(torch.isfinite(q).all()) for q in model.parameters())
    print(f"loss {gate['loss']:.6f}, chamfer {gate['chamfer']:.6f}, image loss {gate['img_loss']:.6f}; launches "
          f"{gate['launches']}; overflow (pred, target) {gate['overflow']}; parameters finite after the step: "
          f"{gate['params_finite']}" + (f"; {gate['ms']:.2f} ms (CUDA events)" if on_card else ""))
    check(gate["chamfer"] < 3.0 and gate["img_loss"] > 0 and math.isfinite(gate["loss"]),
          "the chamfer gate opened, with a finite loss")
    if on_card:
        check(gate["launches"] == {"K1": 8, "K2": 4, "K3": 1, "K4": 1},
              "K1 per pred and target render (8), K2 per pred render (4), K3 and K4 once")
    summary["campaign_open_gate"] = gate
    out["open_gate_step"] = gate["launches"]

    # That step's image loss on the card (K1-K4) and on CPU copies (the plain
    # versions), both fed the step's decoded rows: the decode before the
    # step, under the step's key and parameters.
    tgt = unstack_tokens(trg_open[0], stack)
    valid = real[0].repeat_interleave(2**stack)
    pred = unstack_tokens(own[0], stack).clone().requires_grad_()
    loss_card, _ = stacked.image_loss(pred, tgt, valid, tscene.handler, batch.cameras, RenderConfig())
    loss_card.backward()
    cpu = lambda t: t.detach().cpu()
    p_cpu = cpu(pred).requires_grad_()
    h = tscene.handler
    handler = type(h)(*(cpu(t) for t in (h.world_min, h.world_max, h.scaling_min, h.scaling_max)), h.interval_num)
    loss_cpu, _ = stacked.image_loss(p_cpu, cpu(tgt), cpu(valid), handler, [cpu_camera(c) for c in batch.cameras],
                                     RenderConfig())
    loss_cpu.backward()
    loss_card, loss_cpu = loss_card.detach(), loss_cpu.detach()
    l_err = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    g_scale = float(p_cpu.grad.abs().max())
    g_err = float((cpu(pred.grad) - p_cpu.grad).abs().max())
    print(f"the step's image loss on the card (K1-K4) vs on the CPU (plain versions), one input: {float(loss_card):.7f} "
          f"vs {float(loss_cpu):.7f}, rel diff {l_err:.3e} (tolerance {IMAGE_LOSS_REL}); token gradient max abs diff "
          f"{g_err:.3e} = {g_err / g_scale:.3e} of max {g_scale:.3e} (tolerance {IMAGE_GRAD_REL}); the step's own "
          f"image loss {gate['img_loss']:.7f}")
    check(l_err <= IMAGE_LOSS_REL and g_err <= IMAGE_GRAD_REL * g_scale,
          "the open-gate step's image loss agrees with its plain versions")
    summary.update(campaign_image_loss_rel_err=l_err, campaign_image_grad_err=g_err, campaign_image_grad_scale=g_scale)
    del own, noise, trg_open, gate_loss, met, pred, p_cpu, loss_card, loss_cpu, step_fn

    print("== 24c. the bf16 cached decode against the bf16 scan decode")
    model.eval()
    start = stacked.start_token(stack)
    with torch.no_grad():
        ys = stacked.greedy_decode(model, batch.src, batch.src_mask, Lt + 1, stack)
        rows = model.generator(model.decode(model.encode(batch.src, batch.src_mask), batch.src_mask, ys,
                                            subsequent_mask(Lt + 1, device)))
        state = init_decode_state(model, batch.src, batch.src_mask, Lt + 1)
        tf_err = max(float((decode_step(model, state, ys[:, i:i + 1], i) - rows[:, i]).abs().max())
                     for i in range(Lt + 1))
        scale = float(rows.abs().max())
        # A planted fault the check must refuse: each token's K/V written one
        # position late, so attention also reads the empty slot 0.
        late = init_decode_state(model, batch.src, batch.src_mask, Lt + 2)
        fault_err = max(float((decode_step(model, late, ys[:, i:i + 1], i + 1) - rows[:, i]).abs().max())
                        for i in range(Lt + 1))
        del late
        caches = {k: str(v.dtype) for k, v in state["layers"][0].items()}
        # How far a product's row count alone moves its bf16 outputs: the
        # first decoder layer's K projection of the scan's rows, one row at
        # a time (as decode_step runs it) against all rows at once.
        layer0 = model.decoder.layers()[0]
        y = layer0.sub0.norm(model.tgt_embed(ys))
        full_k = layer0.self_attn.k(y)
        one_k = torch.cat([layer0.self_attn.k(y[:, i:i + 1]) for i in range(Lt + 1)], 1)
        k_share = float((full_k != one_k).float().mean())
    tol = DECODE_REL if model.dtype == torch.float32 else DECODE_REL_BF16
    print(f"teacher-forced decode_step vs the scan decode's rows: max abs diff {tf_err:.3e} = {tf_err / scale:.3e} of "
          f"max |row| {scale:.3e} (tolerance {tol}); the first decoder layer's K projection row by row vs of all "
          f"{Lt + 1} rows at once: {k_share:.4f} of its outputs differ; caches {caches}; a planted fault (K/V "
          f"written one position late): {fault_err:.3e} = {fault_err / scale:.3e} of max |row|")
    check(all(v == str(model.dtype) for v in caches.values()), "the K/V caches are held in the compute dtype")
    check(math.isfinite(tf_err) and tf_err <= tol * scale,
          f"the {model.dtype} cached decode matches the scan decode, teacher-forced")
    check(fault_err > tol * scale, "the check refuses a cache written one position late")
    summary.update(campaign_teacher_forced_err=tf_err, campaign_row_scale=scale, campaign_k_row_share=k_share,
                   campaign_late_cache_err=fault_err)
    if on_card:
        step_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                         if n.startswith(("decoder.", "tgt_embed.", "generator_proj."))
                         and ".src_attn.k." not in n and ".src_attn.v." not in n)
        token_bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
        run_cached = lambda: greedy_decode_cached(model, batch.src, batch.src_mask, Lt + 1, start)
        clk = sm_clock()
        with torch.no_grad():
            cached_ms = cuda_ms_each(run_cached, SERVING_REPS)
        med_dec = float(np.median(cached_ms))
        print(f"[{smi}] bf16 serving: greedy_decode_cached of {Lt} tokens (encoder included), {spread(cached_ms)} "
              f"= {med_dec / Lt:.3f} ms/token; bound by the decode step's {step_bytes / 1e9:.3f} GB of weights: "
              f"{token_bound_ms:.3f} ms/token")
        print_clocks(clk, "24c")
        summary.update(campaign_cached_ms=cached_ms, campaign_cached_ms_per_token=med_dec / Lt,
                       campaign_token_bound_ms=token_bound_ms)
        peak_all = torch.cuda.max_memory_allocated() / 2**30
        print(f"[{smi}] peak memory of section 24: {peak_all:.2f} GiB (torch.cuda.max_memory_allocated)")
        summary["campaign_section_peak_gib"] = peak_all
    del model, opt, res, ys, rows, state
    gc.collect()
    shutil.rmtree(work, ignore_errors=True)
    return out


FLAT_PARAMS = 120_851_482  # d_model 1024, N 6, h 8: train_transformer.py's defaults
# The flat trainer's shape: train_transformer.py's model (d_model 1024, 6
# layers), key blocks of 256 (every bucket length is a multiple of 256), and
# a synthetic SH-1 scene whose training cameras see 5,000-15,000 Gaussians.
FLAT_D, FLAT_LAYERS, FLAT_BLOCK_K = 1024, 6, 256
FLAT_GAUSSIANS = 24_000
FLAT_W, FLAT_H = 960, 540
FLAT_MAX_LEN, FLAT_LONG = 15_000, 12_000
FLAT_DECODE_TOKENS = 32
FLAT_LOSS_REL = 1e-5  # the loss on the card vs its CPU copy (plain K1/K2), relative
FLAT_GRAD_REL = K2_MAX_ERR  # its gradient, of the largest (K2's rule)
AE_RECON_REL = 1e-5  # the conv autoencoder's reconstruction on the card vs its CPU copy, of the largest value
LPIPS_W, LPIPS_H = 1920, 1080
LPIPS_REL = 1e-5  # LPIPS on the card vs on the CPU, relative


def flat_param_count(d_model: int, layers: int) -> int:
    """The flat model's parameters in closed form: the core (the stacked
    model's layout at D = d_model) plus two 26 -> D Dense layers and the D ->
    26 head."""
    return layers * (18 * d_model * d_model + 28 * d_model) + 7 * d_model * d_model + 11 * d_model \
        + 2 * 27 * d_model + 26 * d_model + 26


def flat_c2ws() -> list:
    """Six training cameras inside the ground disk, each looking outward and
    down over a part of the scene from (radius, height) toward the ground
    at a larger radius, so that between a third and two thirds of the
    Gaussians lie in front of it."""
    cams = []
    for (radius, height, reach), turns in (((1.2, 0.8, 3.0), (0.0, 0.5)), ((1.0, 1.0, 2.6), (0.0, 0.5)),
                                          ((1.4, 0.9, 3.0), (1.0, 1.5))):
        for turn in turns:
            a = math.pi * turn
            cams.append(look_at_c2w([radius * math.sin(a), height, radius * math.cos(a)],
                                    [reach * math.sin(a), -1.0, reach * math.cos(a)]))
    return cams


def cpu_camera(cam):
    """A CPU copy of a camera (its ground truth included)."""
    moved = {f: getattr(cam, f).detach().cpu() for f in
             ("world_view_transform", "full_proj_transform", "camera_center", "original_image")
             if getattr(cam, f) is not None}
    return dataclasses.replace(cam, **moved)


def add_path_launches(entries, key: str, launches) -> None:
    """Write a path's K1-K4 launches ({run: {"K1": n, ...}}) into those
    kernels' entries of the kernels line, under ``key``."""
    names = {"K1": "stream_fwd", "K2": "stream_bwd", "K3": "ssim_fwd", "K4": "ssim_bwd"}
    for entry in entries:
        for k, name in names.items():
            if entry["name"] == name:
                entry[key] = {run: counts[k] for run, counts in launches.items()}


def flat_path(args, device, summary, d_model=FLAT_D, layers=FLAT_LAYERS, gaussians=FLAT_GAUSSIANS,
              width=FLAT_W, height=FLAT_H, ae_size=None, lpips_size=(LPIPS_W, LPIPS_H),
              decode_tokens=FLAT_DECODE_TOKENS) -> dict:
    """Sections 19-22: the flat trainer at full width (d_model 1024, N 6),
    its decode, the autoencoder (21 on section 19's scene, 21b on sections
    1-9's, ``ae_size`` = (Gaussians, width, height), default ``args``') and
    LPIPS (smaller sizes only for a rehearsal on the CPU, which lowers
    ``cli.train_transformer.MIN_LEN`` to suit). Returns the launches of
    K1-K4 on its runs, by run."""
    import copy
    import gc
    import shutil

    import torch

    from gaussian_transformer_tpu_torch import kernels
    from gaussian_transformer_tpu_torch.cli import train_autoencoder as cli_ae
    from gaussian_transformer_tpu_torch.cli import train_transformer as cli_flat
    from gaussian_transformer_tpu_torch.convert import scene_from_numpy
    from gaussian_transformer_tpu_torch.eval import lpips
    from gaussian_transformer_tpu_torch.models.box_sort import GaussianHandler
    from gaussian_transformer_tpu_torch.models.codec import flatten_gaussians, unflatten_gaussians
    from gaussian_transformer_tpu_torch.models.transformer import count_params, jax_order
    from gaussian_transformer_tpu_torch.render import RenderConfig, render
    from gaussian_transformer_tpu_torch.scene import Scene
    from gaussian_transformer_tpu_torch.train import flat

    on_card = device.type == "cuda"
    smi = smi_line() if on_card else "cpu"
    dev_arg = [] if on_card else ["--device", str(device)]
    fovx = math.radians(50.0)
    work = (Path(args.work) / "flat").resolve()
    shutil.rmtree(work, ignore_errors=True)
    data, ae_data, model_dir, run_dir = work / "data", work / "ae_data", work / "model", work / "run"
    run_dir.mkdir(parents=True)
    min_len = cli_flat.MIN_LEN
    tf32 = torch.backends.cudnn.allow_tf32  # what the port leaves as it finds it
    counters = kernel_counters()
    out = {}
    cwd = os.getcwd()
    env_weights = os.environ.pop("GT_LPIPS_WEIGHTS", None)

    def diff(a, b):
        return {k: b[k] - a[k] for k in a}

    def peak(section):
        if on_card:
            report_peak(summary, f"flat_peak_gib_{section}", section, smi)

    print(f"== 19. flat trainer at full width: cli.train_transformer (d_model {d_model}, {layers} layers, "
          f"block_k {FLAT_BLOCK_K})")
    if on_card:
        kernels.build(kernels.all_sources())  # before any timing (one nvcc per source, in parallel)
        torch.cuda.reset_peak_memory_stats()
    random.seed(args.seed)  # Scene shuffles its cameras with Python's random, as the reference does
    fields = synthetic_scene(gaussians, args.seed + 19)
    fields["features_rest"] = fields["features_rest"][:, :3]  # SH degree 1, as the flat CLI loads it
    scene = scene_from_numpy(fields, 1, device)
    c2ws = flat_c2ws()
    points = surface_points(2000, args.seed + 19)
    write_train_dataset(data, scene, points, 0, 0, width, height, fovx, device,
                        splits={"train": c2ws, "test": [orbit_c2w(0.3)]})
    write_train_dataset(ae_data, scene, points, 0, 0, width, height, fovx, device,
                        splits={"train": c2ws[:2], "test": [orbit_c2w(0.3)]})
    scene.save_ply(str(model_dir / "point_cloud" / "iteration_30000" / "point_cloud.ply"))
    del scene

    steps = []

    def on_step(rec):
        rec["counts"] = read_counts(counters)  # cumulative since the zeroing
        if on_card:
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        steps.append(rec)

    os.chdir(run_dir)
    try:
        zero_counts(counters)
        t0 = time.time()
        res = cli_flat.main(["-s", str(data), "-m", str(model_dir), "--eval", "--epochs", "1", "--d_model",
                             str(d_model), "--layers", str(layers), "--max_len", str(FLAT_MAX_LEN),
                             "--attn_block_k", str(FLAT_BLOCK_K), "--quiet"] + dev_arg,
                            on_step=on_step)
        t_cli = time.time() - t0
        launches = read_counts(counters)
    finally:
        os.chdir(cwd)
    tscene, model, hist = res["tscene"], res["model"], res["history"]
    counts = tscene.counts
    n_params = count_params(model)
    print(f"{gaussians} Gaussians at SH degree 1, {len(counts)} training cameras at {width}x{height}; visible "
          f"Gaussians per camera {counts}; {tscene.size} within ({min_len}, {FLAT_MAX_LEN - 1})")
    print(f"model: {n_params} parameters (float32, {4 * n_params / 1e9:.3f} GB; Adamax's two moments "
          f"{8 * n_params / 1e9:.3f} GB more); lpips(alex) in the loss: {flat.lpips_mod.available('alex')}")
    check(n_params == flat_param_count(d_model, layers), f"{n_params} parameters == {flat_param_count(d_model, layers)} "
          "(closed form)")
    if (d_model, layers) == (FLAT_D, FLAT_LAYERS):
        check(n_params == FLAT_PARAMS, f"{n_params} parameters == {FLAT_PARAMS}")
        check(tscene.size >= 4 and max(c for c in counts if min_len < c < FLAT_MAX_LEN - 1) >= FLAT_LONG,
              f"at least 4 cameras in the window, one seeing >= {FLAT_LONG}")
    check(len(hist) == tscene.size, f"one step per camera in the window ({tscene.size})")
    prev = {"K1": len(counts) if on_card else 0, "K2": 0, "K3": 0, "K4": 0}  # the visibility renders
    for h in hist:
        h["launches"] = diff(prev, h.pop("counts"))
        prev = {k: prev[k] + h["launches"][k] for k in prev}
        print(f"  step {h['step']}: camera {h['cam']}, n_src {h['n_src']}, n_tgt {h['n_tgt']} (src {h['src_len']}, "
              f"tgt {h['tgt_len']} rows), loss {h['loss']:.6f} = 0.5 x gen {h['gen']:.6f} / base {h['base']:.6f} "
              f"+ 0.1 x l2 {h['l2']:.6f}; overflow (prediction, truth) {h['overflow']}; lr {h['lr']:.3e}; "
              f"launches {h['launches']}"
              + (f"; {h['ms']:.1f} ms, peak {h['peak_gib']:.2f} GiB" if on_card else ""))
    print(f"cli.train_transformer: {len(hist)} steps in {t_cli:.1f} s; launches {launches}")
    check(all(math.isfinite(h[k]) for h in hist for k in ("loss", "base", "gen", "l2")),
          "every step's loss and its parts are finite")
    if on_card:
        check(all(h["launches"] == {"K1": 2, "K2": 1, "K3": 0, "K4": 0} for h in hist),
              "K1 twice (prediction and truth renders) and K2 once a step")
        step_ms = [h["ms"] for h in hist]
        print(f"[{smi}] flat train step: {spread(step_ms)} (CUDA events)")
        summary.update(flat_step_ms=step_ms, flat_step_peak_gib=max(h["peak_gib"] for h in hist))
    with np.load(run_dir / cli_flat.BEST_MODEL) as saved:
        check(len(saved.files) == len(jax_order(model)), f"best_model.npz holds one array per parameter "
              f"({len(saved.files)})")
    summary.update(flat_params=n_params, flat_counts=counts, flat_history=hist, flat_cli_s=t_cli,
                   flat_cli_launches=launches)
    out["flat_cli"] = launches

    longest = max(range(tscene.size), key=lambda i: int(tscene.visible[i].sum()))
    tscene.set_epoch(0)
    batch = tscene.make_batch(longest)
    lp_path = work / "weights_random" / "lpips_alex.npz"
    write_lpips_weights(lp_path, "alex", args.seed + 20)
    os.environ["GT_LPIPS_WEIGHTS"] = str(lp_path)
    lpips._load.cache_clear()
    try:
        print(f"== 19b. one more step with LPIPS(alex) (seeded random weights, {lp_path.name}) on camera {longest}")
        loss_fn = flat.make_flat_loss(model, RenderConfig())
        check(flat.lpips_mod.available("alex"), "the loss takes the LPIPS term")
        args_b = [batch[k] for k in ("src", "trg", "trg_y", "src_mask", "trg_mask", "cam")]
        zero_counts(counters)
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        res["optimizer"].zero_grad(set_to_none=True)
        loss, met = loss_fn(*args_b, dropout_key=(42, len(hist)))
        loss.backward()
        res["optimizer"].step()
        lp_launches = read_counts(counters)
        lp_step = {"loss": float(loss.detach()), **{k: float(met[k].detach()) for k in ("base", "gen", "l2")},
                   "launches": lp_launches}
        lp_step["lpips_term"] = lp_step["loss"] - (0.5 * lp_step["gen"] / lp_step["base"] + 0.1 * lp_step["l2"])
        if on_card:
            ev[1].record()
            torch.cuda.synchronize()
            lp_step["ms"] = ev[0].elapsed_time(ev[1])
        print(f"loss {lp_step['loss']:.6f} (0.4 x LPIPS {lp_step['lpips_term']:.6f}); launches {lp_launches}"
              + (f"; [{smi}] {lp_step['ms']:.1f} ms (CUDA events, one step)" if on_card else ""))
        check(math.isfinite(lp_step["loss"]) and lp_step["lpips_term"] > 0, "a finite loss with an LPIPS term")
        check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "the parameters stay finite")
        if on_card:
            check(lp_launches == {"K1": 2, "K2": 1, "K3": 0, "K4": 0}, "K1 twice and K2 once")
        summary["flat_lpips_step"] = lp_step
        out["flat_lpips_step"] = lp_launches
        del loss, met
    finally:
        os.environ.pop("GT_LPIPS_WEIGHTS")
        lpips._load.cache_clear()

    # make_flat_loss on the card against the same call on CPU copies (the
    # plain versions of K1 and K2): the model stands in as its own
    # teacher-forced prediction for this batch, a parameter, so the call's
    # renders are at the main path's shapes and its gradient is the tokens'.
    print(f"== 19c. make_flat_loss on camera {longest}'s batch on the card vs on CPU copies (plain K1/K2)")
    model.eval()
    with torch.no_grad():
        pred = model.generator(model(*[batch[k] for k in ("src", "trg", "src_mask", "trg_mask")]))

    class Decoded(torch.nn.Module):
        def __init__(self, x):
            super().__init__()
            self.x = torch.nn.Parameter(x.clone())

        def forward(self, src, tgt, src_mask, tgt_mask, rng=None):
            return self.x

        def generator(self, x):
            return x

    results = {}
    for where in ("card", "cpu") if on_card else ("cpu",):
        mv = (lambda t: t) if where == "card" else (lambda t: t.detach().cpu())
        stand_in = Decoded(mv(pred))
        b = {k: mv(batch[k]) for k in ("src", "trg", "trg_y", "src_mask", "trg_mask")}
        cam = batch["cam"] if where == "card" else cpu_camera(batch["cam"])
        if where == "card":
            zero_counts(counters)
        loss, met = flat.make_flat_loss(stand_in, RenderConfig(), use_lpips=False)(
            b["src"], b["trg"], b["trg_y"], b["src_mask"], b["trg_mask"], cam)
        loss.backward()
        results[where] = (float(loss.detach()), stand_in.x.grad.detach().cpu(), read_counts(counters))
    loss_c, grad_c, cmp_launches = results["card" if on_card else "cpu"]
    if on_card:
        loss_p, grad_p, _ = results["cpu"]
        l_err = abs(loss_c - loss_p) / abs(loss_p)
        g_scale = float(grad_p.abs().max())
        g_err = float((grad_c - grad_p).abs().max())
        print(f"loss {loss_c:.7f} on the card (launches {cmp_launches}) vs {loss_p:.7f} on the CPU: rel diff "
              f"{l_err:.3e} (tolerance {FLAT_LOSS_REL}); token gradient max abs diff {g_err:.3e} = "
              f"{g_err / g_scale:.3e} of max {g_scale:.3e} (tolerance {FLAT_GRAD_REL})")
        check(cmp_launches == {"K1": 2, "K2": 1, "K3": 0, "K4": 0}, "the card's call launched K1 twice and K2 once")
        check(l_err <= FLAT_LOSS_REL and g_err <= FLAT_GRAD_REL * g_scale,
              "make_flat_loss on the card agrees with its plain versions")
        summary.update(flat_loss_rel_err=l_err, flat_grad_err=g_err, flat_grad_scale=g_scale)
    check(math.isfinite(loss_c) and bool(torch.isfinite(grad_c).all()) and float(grad_c.abs().max()) > 0,
          "a finite loss and a finite, nonzero token gradient")
    if on_card:
        # The matmul FLOPs of one loss and backward on the longest camera's
        # batch (the recomputed key blocks included), against its step time.
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as fc:
            flat.make_flat_loss(model, RenderConfig(), use_lpips=False)(*args_b)[0].backward()
        model.zero_grad(set_to_none=True)
        flops = fc.get_total_flops()
        long_ms = next(h["ms"] for h in hist if h["cam"] == longest)
        bound_ms = flops / PEAK_FP32_FLOPS * 1e3
        print(f"[{smi}] one flat loss and backward on camera {longest}'s batch: {flops:.4e} matmul FLOPs "
              f"(FlopCounterMode) = {bound_ms:.1f} ms at the float32 non-tensor peak ({PEAK_FP32_FLOPS:.3g} FLOP/s), "
              f"{bound_ms / long_ms:.3f} of that camera's step in the epoch ({long_ms:.1f} ms)")
        summary.update(flat_step_flops=flops, flat_step_bound_ms=bound_ms, flat_long_step_ms=long_ms)
    peak("19")

    print(f"== 20. flat decode: greedy_decode_flat of the full-width model, {decode_tokens} tokens from camera "
          f"{longest}'s source ({batch['src'].shape[1]} rows)")
    run_decode = lambda: flat.greedy_decode_flat(model, batch["src"], batch["src_mask"], decode_tokens)
    ys = run_decode()
    check(ys.shape == (1, decode_tokens, 26) and bool(torch.isfinite(ys).all()),
          f"a finite [1, {decode_tokens}, 26] decode")
    if on_card:
        clk = sm_clock()
        with torch.no_grad():
            dec_ms = cuda_ms_each(run_decode, reps=5)
            enc_ms = cuda_ms_each(lambda: model.encode(batch["src"], batch["src_mask"]), reps=5)
        med = float(np.median(dec_ms))
        print(f"[{smi}] greedy_decode_flat: {spread(dec_ms)} = {med / decode_tokens:.3f} ms/token "
              f"(the encoder alone {spread(enc_ms)})")
        print_clocks(clk, "20")
        summary.update(flat_decode_ms=dec_ms, flat_decode_ms_per_token=med / decode_tokens, flat_encode_ms=enc_ms)
    del model, res, tscene, batch, ys, pred, run_decode
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    peak("20")

    ag, aw, ah = ae_size or (args.gaussians, args.width, args.height)
    big_data, big_model = work / "ae_big_data", work / "ae_big_model"
    for section, what, ae_dir, ae_model_dir in (
            ("21", f"section 19's scene ({gaussians} Gaussians, {width}x{height})", ae_data, model_dir),
            ("21b", f"sections 1-9's scene ({ag} Gaussians, {aw}x{ah})", big_data, big_model)):
        print(f"== {section}. autoencoder: cli.train_autoencoder on a 2-camera dataset of {what}, epochs 0-501 "
              f"(epoch 501 the image loss)")
        tag = "" if section == "21" else "_big"
        if section == "21b":
            # synthetic_scene(args.gaussians, args.seed) is section 2's scene;
            # its train view and first test view are the cameras.
            t0 = time.time()
            fields = synthetic_scene(ag, args.seed)
            fields["features_rest"] = fields["features_rest"][:, :3]  # SH degree 1, as the CLI loads it
            scene = scene_from_numpy(fields, 1, device)
            write_train_dataset(big_data, scene, points, 0, 0, aw, ah, fovx, device,
                                splits={"train": [orbit_c2w(math.pi / 4), orbit_c2w(0.3)],
                                        "test": [orbit_c2w(math.pi / 2 + 0.3)]})
            scene.save_ply(str(big_model / "point_cloud" / "iteration_30000" / "point_cloud.ply"))
            del scene, fields
            print(f"dataset and model dir: {time.time() - t0:.1f} s")
        for conv in (False, True):
            name = ("conv" if conv else "stub") + tag
            ae_steps = []
            os.chdir(run_dir)
            try:
                zero_counts(counters)
                t0 = time.time()
                ae_res = cli_ae.main(["-s", str(ae_dir), "-m", str(ae_model_dir), "--eval", "--epochs", "502",
                                      "--lr_sweep_start", "20", "--lr_sweep_stop", "21", "--quiet"]
                                     + (["--conv"] if conv else []) + dev_arg,
                                     on_step=lambda rec: ae_steps.append((rec, read_counts(counters))))
                t_ae = time.time() - t0
                ae_launches = read_counts(counters)
            finally:
                os.chdir(cwd)
            prev = {k: 0 for k in counters}
            per_step = []
            for rec, cum in ae_steps:
                rec["launches"] = diff(prev, cum)
                prev = cum
                per_step.append(rec)
            img = [r for r in per_step if r["kind"] == "image"]
            tok = [r for r in per_step if r["kind"] == "token"]
            print(f"{name}: {len(per_step)} steps ({len(tok)} token, {len(img)} image) in {t_ae:.1f} s; launches "
                  f"{ae_launches}; image steps: " + "; ".join(
                      f"loss {r['loss']:.6f}, {r['n_visible']} visible, launches {r['launches']}"
                      + (f", {r['ms']:.2f} ms" if on_card else "") for r in img))
            check(len(img) == 2 and len(tok) == 1002, "1002 token steps and 2 image steps")
            check(all(r["finite"] for r in per_step), "every loss is finite")
            if on_card:
                check(all(r["launches"] == {"K1": 3, "K2": 1, "K3": 1, "K4": 1} for r in img),
                      "an image step launches K1 3 (visibility, input, reconstruction), K2 1, K3 1, K4 1")
                check(all(r["launches"] == {"K1": 1, "K2": 0, "K3": 0, "K4": 0} for r in tok),
                      "a token step launches K1 once (visibility)")
                tok_ms = [r["ms"] for r in tok]
                print(f"[{smi}] {name} token step {spread(tok_ms)}; image steps {[round(r['ms'], 3) for r in img]} "
                      "ms (CUDA events)")
            summary[f"autoencoder_{name}"] = {"s": t_ae, "launches": ae_launches, "image_steps": img,
                                              "token_step_ms": [r["ms"] for r in tok] if on_card else None}
            out[f"autoencoder_{name}"] = ae_launches
        check(torch.backends.cudnn.allow_tf32 == tf32, f"the CLIs leave cuDNN's TF32 flag as they found it ({tf32})")

        # One image_loss on the card against the same call on CPU copies
        # (plain K1-K4), with the conv autoencoder the run trained, under
        # the process's own TF32 flag: the model's convolutions hold float32.
        # The CPU copy's reconstruction differs from the card's by float
        # rounding (~1e-6), and the renders, which drop the instances past
        # their stream budget, are not continuous in it: a radius that moves
        # by a pixel changes which instances a tile keeps. So the model is
        # held to its copy on its own, and the CPU call renders the card's
        # reconstruction, back-propagated through the copy's own graph.
        ae_model = ae_res["models"][20]

        class GivenValues(torch.autograd.Function):
            @staticmethod
            def forward(ctx, y, given):
                return given.clone()

            @staticmethod
            def backward(ctx, g):
                return g, None

        class GivenOutput(torch.nn.Module):
            """``model`` whose output takes the values ``given`` (its
            backward is the model's own)."""

            def __init__(self, model, given):
                super().__init__()
                self.model, self.given = model, given

            def forward(self, x):
                return GivenValues.apply(self.model(x), self.given)

        ns = Namespace(sh_degree=1, source_path=str(ae_dir), model_path=str(ae_model_dir), images="images",
                       resolution=-1, white_background=False, data_device=str(device), eval=True)
        sc = Scene(ns, load_iteration=-1, sh_degree=1, device=device)
        with torch.no_grad():
            handler = GaussianHandler.create(sc.gaussians)
            g = handler.denormalize(unflatten_gaussians(handler.box_sort(sc.gaussians)))
            cam = sc.get_train_cameras()[0]
            ae_input = flatten_gaussians(g)[render(cam, g)["visibility_filter"]][None]
        results = {}
        for where in ("card", "cpu") if on_card else ("cpu",):
            m = ae_model if where == "card" else copy.deepcopy(ae_model).cpu()
            if where == "card":
                with torch.no_grad():
                    rec_c = m(ae_input.transpose(1, 2)).cpu()
                    rec_p = copy.deepcopy(m).cpu()(ae_input.cpu().transpose(1, 2))
                rec_err, rec_scale = float((rec_c - rec_p).abs().max()), float(rec_p.abs().max())
                print(f"the conv model's reconstruction on the card vs its CPU copy: max abs diff {rec_err:.3e} "
                      f"of max {rec_scale:.3e} (tolerance {AE_RECON_REL} of the max)")
                check(rec_err <= AE_RECON_REL * rec_scale,
                      "the conv model's reconstruction on the card agrees with its CPU copy")
            elif on_card:
                m = GivenOutput(m, results["card"][3].transpose(1, 2))  # what the card's renders took
            m.zero_grad(set_to_none=True)
            if where == "card":
                zero_counts(counters)
            t0 = time.time()
            loss, pred = cli_ae.image_loss(m, ae_input if where == "card" else ae_input.cpu(),
                                           cam if where == "card" else cpu_camera(cam), RenderConfig())
            pred.retain_grad()
            loss.backward()
            results[where] = (float(loss.detach()), [p.grad.detach().cpu() for p in m.parameters()],
                              read_counts(counters), pred.detach().cpu(), pred.grad.detach().cpu(), time.time() - t0)
        loss_c, grads_c, il_launches, pred_c, _, _ = results["card" if on_card else "cpu"]
        print(f"image_loss on {ae_input.shape[1]} visible Gaussians; on the CPU (plain K1-K4) "
              f"{results['cpu'][5]:.1f} s wall")
        if on_card:
            loss_p, grads_p, _, _, tgrad_p, _ = results["cpu"]
            l_err = abs(loss_c - loss_p) / abs(loss_p)
            g_scale = max(float(x.abs().max()) for x in grads_p)
            g_err = max(float((a - b).abs().max()) for a, b in zip(grads_c, grads_p))
            t_scale = float(tgrad_p.abs().max())
            t_err = float((results["card"][4] - tgrad_p).abs().max())
            print(f"image_loss (conv) on the card {loss_c:.7f} (launches {il_launches}) vs on the CPU {loss_p:.7f}: "
                  f"rel diff {l_err:.3e} (tolerance {FLAT_LOSS_REL}); the reconstructed tokens' gradient max abs diff "
                  f"{t_err:.3e} = {t_err / t_scale:.3e} of max {t_scale:.3e}; parameter gradients max abs diff "
                  f"{g_err:.3e} = {g_err / g_scale:.3e} of max {g_scale:.3e} (gradients: tolerance {FLAT_GRAD_REL} in "
                  f"section 21, printed in 21b); both rendered the card's reconstruction; cuDNN "
                  f"TF32 flag: {torch.backends.cudnn.allow_tf32}")
            check(il_launches == {"K1": 2, "K2": 1, "K3": 1, "K4": 1}, "image_loss launched K1 2, K2 1, K3 1, K4 1")
            check(l_err <= FLAT_LOSS_REL, "image_loss on the card agrees with its plain versions")
            if section == "21":
                check(t_err <= FLAT_GRAD_REL * t_scale and g_err <= FLAT_GRAD_REL * g_scale,
                      "its token and parameter gradients agree with their plain versions")
                # Printed, not checked: the same call on the CPU copy's own
                # reconstruction, and the instances the card's renders drop.
                with torch.no_grad():
                    own = float(cli_ae.image_loss(copy.deepcopy(ae_model).cpu(), ae_input.cpu(), cpu_camera(cam),
                                                  RenderConfig())[0])
                    drops = [int(render(cam, unflatten_gaussians(t[0].to(device)))["overflow"])
                             for t in (ae_input, pred_c)]
                print(f"image_loss on the CPU copy's own reconstruction {own:.7f}: rel diff "
                      f"{abs(own - loss_c) / abs(own):.3e} from the card's; the card's renders of the input and of "
                      f"the reconstruction drop {drops[0]} and {drops[1]} instances past their stream budget")
                summary[f"autoencoder{tag}_image_loss_own_recon"] = {"loss": own, "dropped": drops}
            else:
                # The trained reconstruction renders within float noise of
                # its input at many of the 1080p pixels, where L1's sign, and
                # so the gradient, can differ between the two sides; K2 and
                # K4 are held to their plain versions at this size in
                # section 8. The gradients are printed, the ties counted.
                with torch.no_grad():
                    in_im = render(cam, unflatten_gaussians(ae_input[0]))["render"]
                    out_im = render(cam, unflatten_gaussians(pred_c.to(device)[0]))["render"]
                    ties = int(((out_im - in_im).abs() < 1e-6).sum())
                print(f"{ties} of {out_im.numel()} pixel channels of the two renders lie within 1e-6 of each other")
                summary[f"autoencoder{tag}_l1_ties"] = ties
            summary[f"autoencoder{tag}_image_loss"] = {"rel_err": l_err, "token_grad_err": t_err,
                                                       "token_grad_scale": t_scale, "grad_err": g_err,
                                                       "grad_scale": g_scale, "recon_err": rec_err,
                                                       "visible": ae_input.shape[1], "cpu_s": results["cpu"][5]}
        check(math.isfinite(loss_c) and all(bool(torch.isfinite(x).all()) for x in grads_c),
              "a finite image loss and finite gradients")
        del ae_res, ae_model, sc, g, ae_input, results
        gc.collect()
        peak(section)

    lw, lh = lpips_size
    print(f"== 22. LPIPS (alex and vgg, seeded random weights) at {lw}x{lh}: the card vs the CPU")
    r = np.random.RandomState(args.seed + 22)
    x = r.rand(3, lh, lw).astype(np.float32)
    y = np.clip(x + r.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    lp = {}
    try:
        for net in ("alex", "vgg"):
            path = work / "weights_random" / f"lpips_{net}.npz"
            write_lpips_weights(path, net, args.seed + 22)
            os.environ["GT_LPIPS_WEIGHTS"] = str(path)
            lpips._load.cache_clear()
            ref = float(lpips.lpips(torch.from_numpy(x), torch.from_numpy(y), net))
            rec = {"cpu": ref}
            if on_card:
                xc, yc = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
                with torch.no_grad():
                    got = float(lpips.lpips(xc, yc, net))
                    clk = sm_clock()
                    ms = cuda_ms_each(lambda: lpips.lpips(xc, yc, net), reps=5)
                rec.update(card=got, rel_err=abs(got - ref) / abs(ref), ms=ms)
                print(f"[{smi}] LPIPS({net}): {got:.7f} on the card vs {ref:.7f} on the CPU, rel diff "
                      f"{rec['rel_err']:.3e} (tolerance {LPIPS_REL}); {spread(ms)} (CUDA events)")
                print_clocks(clk, "22")
                check(rec["rel_err"] <= LPIPS_REL, f"LPIPS({net}) on the card agrees with the CPU")
            check(math.isfinite(ref) and ref > 0, f"LPIPS({net}) is finite and positive")
            lp[net] = rec
    finally:
        os.environ.pop("GT_LPIPS_WEIGHTS", None)
        if env_weights is not None:
            os.environ["GT_LPIPS_WEIGHTS"] = env_weights
        lpips._load.cache_clear()
    summary["lpips"] = lp
    peak("22")
    return out


GATE_CAMS, GATE_WIDTH, GATE_HEIGHT = 28, 1280, 720  # the quality gate's dataset (tools/full_gate.py)
GATE_GT, GATE_SEED_POINTS = 200_000, 10_000
GATE_RUNS = ((1600, 800), (3100, 1000))  # (iterations, --orbax_every): run 1, then the resumed run 2
GATE_SH_AT = {1600: 1, 2000: 2, 3000: 3}  # snapshot step -> active SH degree (a bump every 1000)
GATE_RESET = 3000  # the opacity reset (opacity_reset_interval) whose PLY is checked


def gate_path(args, device, summary, cams=GATE_CAMS, width=GATE_WIDTH, height=GATE_HEIGHT,
              gt_size=GATE_GT, seed_points=GATE_SEED_POINTS) -> dict:
    """Section 23: the quality gate's chain, cut to 3,100 iterations, with a
    kill-and-resume. Returns the launches {run: {"K1": n, ...}}."""
    import contextlib
    import io
    import shutil

    import torch

    from gaussian_transformer_tpu_torch.cli import metrics as cli_metrics
    from gaussian_transformer_tpu_torch.cli import render as cli_render
    from gaussian_transformer_tpu_torch.cli import train as cli_train
    from gaussian_transformer_tpu_torch.scene.ply import read_ply_vertex_table
    from gaussian_transformer_tpu_torch.tools import full_gate
    from gaussian_transformer_tpu_torch.train import orbax_ckpt
    from gaussian_transformer_tpu_torch.train.splat import PHASES

    on_card = device.type == "cuda"
    smi = smi_line() if on_card else "cpu"
    work = Path(args.work)
    data, model = work / "gate_scene", work / "gate_model"
    for d in (data, model):
        shutil.rmtree(d, ignore_errors=True)
    dev_arg = [] if on_card else ["--device", str(device)]
    counters = kernel_counters()
    t_start, times, launches, hist = time.time(), {}, {}, []

    print(f"== 23. the quality gate's chain, cut: {gt_size} Gaussians of ground truth, {cams} cameras at "
          f"{width}x{height}, {seed_points} seed points; cli.train to {GATE_RUNS[0][0]}, killed, resumed to "
          f"{GATE_RUNS[1][0]}; cli.render, cli.metrics")
    t0 = time.time()
    full_gate.build_scene_dir(data, cams, width, height, gt_size, seed_points, args.seed, device)
    times["dataset"] = time.time() - t0
    # SH degree 3 (the fork's default is 1), so that the bumps at 2000 and 3000 happen.
    base = ["-s", str(data), "-m", str(model), "--eval", "--sh_degree", "3",
            "--densify_grad_threshold", "0.0001"] + dev_arg
    for run, (iters, every) in enumerate(GATE_RUNS, 1):
        argv = base + ["--iterations", str(iters), "--orbax_every", str(every), "--test_iterations", str(iters)]
        if run == 2:
            argv += ["--save_iterations", str(GATE_RESET), str(iters)]
        zero_counts(counters)
        out = io.StringIO()
        t0 = time.time()
        # Run 2 prints (its resume line is checked); both print to a buffer.
        with contextlib.redirect_stdout(out):
            res = cli_train.main(argv + (["--quiet"] if run == 1 else []))
        times[f"train run {run}"] = time.time() - t0
        launches[f"gate_run{run}"] = read_counts(counters)
        steps = [h["iteration"] for h in res["history"]]
        print(f"cli.train run {run}: iterations {steps[0]}-{steps[-1]}, {times[f'train run {run}']:.1f} s, "
              f"launches {launches[f'gate_run{run}']}")
        n = len(steps)
        if on_card:
            check(launches[f"gate_run{run}"]["K2"] == n and launches[f"gate_run{run}"]["K4"] == n,
                  f"run {run}: K2 and K4 launched once per step ({n})")
        check(all(math.isfinite(h["loss"]) for h in res["history"]), f"run {run}: every loss is finite")
        mgr = orbax_ckpt.make_manager(str(model))
        if run == 1:
            check(steps == list(range(1, iters + 1)), f"run 1 trains iterations 1-{iters}")
            check(mgr.all_steps() == [every, iters], f"run 1's snapshots: {mgr.all_steps()} == {[every, iters]}")
        else:
            first = GATE_RUNS[0][0]
            check(f"resumed from orbax step {first}" in out.getvalue(), f"run 2 prints 'resumed from orbax step {first}'")
            check(steps[0] == first + 1 and steps == list(range(first + 1, iters + 1)),
                  f"run 2's first logged iteration is {first + 1} (got {steps[0]})")
        for step, deg in GATE_SH_AT.items():
            if step in mgr.all_steps() and (run == 1) == (step <= GATE_RUNS[0][0]):
                meta = orbax_ckpt.restore_raw(mgr, step)["meta"].tolist()
                check(int(meta[0]) == step and int(meta[2]) == deg,
                      f"snapshot {step}: meta {meta}, active SH degree {deg}")
        hist += res["history"]
    check(orbax_ckpt.make_manager(str(model)).all_steps() == [2000, 3000, 3100],
          "the newest three snapshots are kept: 2000, 3000, 3100")

    ply = read_ply_vertex_table(str(model / "point_cloud" / f"iteration_{GATE_RESET}" / "point_cloud.ply"))
    opac = 1.0 / (1.0 + np.exp(-ply["opacity"].astype(np.float64)))
    check(float(opac.max()) <= 0.01 * (1 + 1e-5),
          f"the PLY of iteration {GATE_RESET} (after the opacity reset): max sigmoid(opacity) "
          f"{float(opac.max()):.9f} <= 0.01 ({opac.size} Gaussians)")
    dens = [(h["iteration"], h["densify"]) for h in hist if "densify" in h]
    alive = [d["n_alive"] for _, d in dens]
    doublings = [(i, d["capacity"]) for i, d in dens if "capacity" in d]
    print(f"densify passes (iteration, alive): {[(i, d['n_alive']) for i, d in dens]}; "
          f"capacity doublings (iteration, capacity): {doublings}")
    check(len(dens) == 6 and max(alive) > seed_points,
          f"6 densify passes grew the alive count from {seed_points} seed points (to {max(alive)} at most)")

    zero_counts(counters)
    t0 = time.time()
    stats = cli_render.main(["-m", str(model), "--skip_train", "--quiet"] + dev_arg)
    times["render"] = time.time() - t0
    launches["gate_render"] = read_counts(counters)
    zero_counts(counters)
    t0 = time.time()
    method = f"ours_{GATE_RUNS[1][0]}"
    scores = cli_metrics.main(["-m", str(model)] + dev_arg)[str(model)][method]
    times["metrics"] = time.time() - t0
    launches["gate_metrics"] = read_counts(counters)
    ref_psnr = numpy_psnr(model, method)
    check(abs(scores["PSNR"] - ref_psnr) <= 1e-3,
          f"test PSNR {scores['PSNR']:.6f} dB == numpy recomputation {ref_psnr:.6f} dB (1e-3 dB)")
    n_final = full_gate.ply_vertex_count(model / "point_cloud" / f"iteration_{GATE_RUNS[1][0]}" / "point_cloud.ply")
    overflowed = sum(1 for h in hist if h["overflow"])
    print(f"[{smi}] gate chain: {overflowed} of {len(hist)} steps overflowed, {sum(1 for v in stats if v['overflow'])} "
          f"of {len(stats)} rendered test views; final size {n_final}; test PSNR {scores['PSNR']:.4f} dB, "
          f"SSIM {scores['SSIM']:.5f}")
    med = {}
    if on_card:
        timed = [h["phase_ms"] for h in hist if "densify" not in h]
        med = {k: float(np.median([p[k] for p in timed])) for k in PHASES}
        med["step"] = float(np.median([sum(p.values()) for p in timed]))
        print(f"[{smi}] median train step of the chain {med['step']:.3f} ms: "
              + ", ".join(f"{k} {med[k]:.3f} ms" for k in PHASES))
    times["section"] = time.time() - t_start
    print(f"[{smi}] section 23 wall times (s): " + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    summary.update(gate_times_s=times, gate_overflowed_steps=overflowed, gate_n_final=n_final,
                   gate_psnr=scores["PSNR"], gate_ssim=scores["SSIM"], gate_phase_ms=med,
                   gate_densify=[{"iteration": i, **d} for i, d in dens], gate_launches=launches)
    return launches


# ------------------------------------------------- the multi-device tier ---

TIER_LOSS_REL = 1e-5  # the manual step vs the batched step (tests/test_parallel.py:70-77)
TIER_ATOL = 1e-6  # their parameters and Adam moments
TIER_STATS_ATOL = 1e-5  # their densify statistics
TILE_LOSS_REL, TILE_XYZ_ATOL, TILE_STATS_ATOL = 1e-3, 1e-5, 1e-4  # the tile-sharded step (the JAX test's bounds)
TILE_IMAGE_ATOL = 2e-5  # render_tile_sharded vs render()
TIER_VIEWS = 2  # section 28's camera batch
# Section 28's parameters: a first Adam step (eps 1e-15) moves an element by
# lr x g / (|g| + eps), lr x sign(g) wherever g is not ~0; where |g| is float
# noise (below this share of its leaf's largest) the CUDA atomics' order
# decides the sign, so there the bound is the step's largest move, 2 x lr.
TIER_GRAD_NOISE = 1e-6
TIER_PARAM_ATOL = 1e-2 * 5e-4  # section 29: 1e-2 x lr of the parameters after one Adam step
TIER_ATTN_REL = 1e-5  # section 30: ring vs blockwise vs Ulysses, of the largest output
TIER_GRAD_REL = 1e-4  # section 30: the ring step's gradients vs the blockwise step's, of the largest


def tier_group(device):
    """Join (once) the process group of sections 28-30: world size 1, NCCL
    on the card (gloo on the CPU), in this process."""
    import torch.distributed as dist

    from gaussian_transformer_tpu_torch.parallel.mesh import free_port, init_distributed

    if not dist.is_initialized():
        init_distributed(device, init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
        print(f"process group: backend {dist.get_backend()}, world size {dist.get_world_size()}")
    return dist.group.WORLD


def tier_3dgs_path(args, device, summary, data, splits) -> dict:
    """Section 28: the 3DGS tier on section 8's state (the point cloud's
    Gaussians at 4x capacity) and a batch of the first two train views: one
    step each of the batched (``mesh=None``), the manual Gaussian-sharded
    (data 1 x gauss 1) and the tile-sharded step on fresh copies, held to
    each other; ``render_tile_sharded`` against ``render()``; the manual
    step's collectives. Returns the K1-K4 launches of each step."""
    import torch

    from gaussian_transformer_tpu_torch.config import OptConfig
    from gaussian_transformer_tpu_torch.parallel import audit
    from gaussian_transformer_tpu_torch.parallel import collectives as cc
    from gaussian_transformer_tpu_torch.parallel.mesh import make_mesh
    from gaussian_transformer_tpu_torch.parallel.step import make_sharded_train_step, stack_cameras
    from gaussian_transformer_tpu_torch.parallel.tile_shard import render_tile_sharded
    from gaussian_transformer_tpu_torch.render import RenderConfig, render, tune_config
    from gaussian_transformer_tpu_torch.scene.densify import DensifyStats
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
    from gaussian_transformer_tpu_torch.scene.ply import fetch_point_cloud
    from gaussian_transformer_tpu_torch.train.optim import PARAM_LEAVES, AdamState, expon_lr, leaf_learning_rates
    from gaussian_transformer_tpu_torch.utils.png import read_png

    on_card = device.type == "cuda"
    smi = smi_line() if on_card else "cpu"
    W, H, fovx = args.width, args.height, math.radians(50.0)
    group = tier_group(device)
    print(f"== 28. the 3DGS tier: batched, manual (data 1 x gauss 1) and tile-sharded steps, {TIER_VIEWS} train "
          f"views at {W}x{H}")
    cams = []
    for i in range(TIER_VIEWS):
        cam = camera_from_c2w(splits["train"][i], fovx, W, H, device)
        cam.original_image = torch.as_tensor(read_png(str(data / "train" / f"r_{i}.png"))[..., :3].transpose(2, 0, 1)
                                             / 255.0, dtype=torch.float32, device=device)
        cams.append(cam)
    batch = stack_cameras(cams)
    pcd = fetch_point_cloud(str(data / "points3d.ply"))
    fresh = lambda: GaussianScene.from_pcd(pcd, 1, capacity=4 * args.train_points, device=device)
    bg = torch.zeros(3, device=device)
    # Every form bins without tile culling (the manual and tile-sharded
    # forms' binning), at budgets tuned to that binning's counts.
    g = fresh()
    with torch.no_grad():
        probe = render(cams[0], g, RenderConfig(tile_cull=False))
    cfg = tune_config(RenderConfig(tile_cull=False), {k: int(probe[k]) for k in ("n_instances", "n_padded", "n_tiles")})
    print(f"capacity {g.capacity}, {g.num_alive} alive; budgets max_instances {cfg.max_instances}, "
          f"max_stream {cfg.max_stream}")
    del g, probe
    mesh = make_mesh(1, 1)
    counters = kernel_counters()
    results, launches, times, reports = {}, {}, {}, {}
    runs = (("batched", {}), ("manual", {"mesh": mesh}), ("tile", {"mesh": mesh, "tile_axis": "gauss"}),
            ("batched_again", {}))
    for name, kw in runs:
        step = make_sharded_train_step(OptConfig(), cfg, **kw)
        g = fresh()
        adam, stats = AdamState.init(g), DensifyStats.init(g.capacity, device)
        zero_counts(counters)
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        with cc.recording() as rec:
            g, adam, stats, m = step(g, adam, stats, batch, bg, 1, 1.0)
        if on_card:
            ev[1].record()
            torch.cuda.synchronize()
            times[name] = ev[0].elapsed_time(ev[1])
        launches[name] = read_counts(counters)
        reports[name] = audit.collective_report(rec)
        results[name] = (g, adam, stats, {k: float(v) for k, v in m.items()})
        print(f"{name} step: loss {results[name][3]['loss']:.7f}, n_visible {int(results[name][3]['n_visible'])}; "
              f"launches {launches[name]}" + (f"; [{smi}] {times[name]:.2f} ms (CUDA events, one step)" if on_card
                                              else ""))
        if on_card:
            check(launches[name] == {k: TIER_VIEWS for k in ("K1", "K2", "K3", "K4")},
                  f"K1-K4 launched once per view in the {name} step")
    lrs = leaf_learning_rates(OptConfig(), float(expon_lr(1, OptConfig().position_lr_init, OptConfig().position_lr_final,
                                                          lr_delay_mult=OptConfig().position_lr_delay_mult,
                                                          max_steps=OptConfig().position_lr_max_steps)))

    def diffs(a, b, atol):
        (ga, aa, sa, ma), (gb, ab, sb, mb) = results[a], results[b]
        d = {"loss_rel": abs(ma["loss"] - mb["loss"]) / abs(mb["loss"]), "params_tight": 0.0, "noise_elements": 0,
             "params_beyond": 0}
        for k in PARAM_LEAVES:
            g = ab.mu[k] / 0.1  # the step's gradient, read off Adam's first moment
            noise = g.abs() < TIER_GRAD_NOISE * g.abs().max()
            diff = (getattr(ga, k) - getattr(gb, k)).detach().abs()
            if (~noise).any():
                d["params_tight"] = max(d["params_tight"], float(diff[~noise].max()))
            d["noise_elements"] += int(noise.sum())
            d["params_beyond"] += int((diff > torch.where(noise, torch.full_like(diff, 2.0 * float(lrs[k])),
                                                          torch.full_like(diff, atol))).sum())
        d["xyz"] = float((ga.xyz - gb.xyz).detach().abs().max())
        d["adam"] = max(float((x[k] - y[k]).abs().max()) for x, y in ((aa.mu, ab.mu), (aa.nu, ab.nu))
                        for k in PARAM_LEAVES)
        d["stats"] = max(float((getattr(sa, k) - getattr(sb, k)).abs().max())
                         for k in ("xyz_gradient_accum", "denom", "max_radii2d"))
        d["accum"] = float((sa.xyz_gradient_accum - sb.xyz_gradient_accum).abs().max())
        return d

    dr, dm = diffs("batched_again", "batched", TIER_ATOL), diffs("manual", "batched", TIER_ATOL)
    dt = diffs("tile", "batched", TILE_XYZ_ATOL)
    print(f"the batched step run twice (the card's run-to-run difference): {dr}")
    print(f"manual vs batched: {dm}")
    print(f"tile vs batched: {dt}")
    check(dm["loss_rel"] <= TIER_LOSS_REL and dm["adam"] <= TIER_ATOL and dm["stats"] <= TIER_STATS_ATOL
          and dm["params_beyond"] == 0,
          f"the manual step agrees with the batched step (loss {TIER_LOSS_REL} relative, Adam's moments "
          f"{TIER_ATOL}, statistics {TIER_STATS_ATOL}, parameters {TIER_ATOL}; 2 x lr where the gradient is "
          f"below {TIER_GRAD_NOISE} of its leaf's largest)")
    check(dt["loss_rel"] <= TILE_LOSS_REL and dt["params_beyond"] == 0 and dt["accum"] <= TILE_STATS_ATOL,
          f"the tile-sharded step agrees with the batched step (loss {TILE_LOSS_REL} relative, parameters "
          f"{TILE_XYZ_ATOL}, 2 x lr where the gradient is below {TIER_GRAD_NOISE} of its leaf's largest; gradient "
          f"accumulator {TILE_STATS_ATOL})")
    report = reports["manual"]
    print("the manual step's collectives (parallel/audit.py):\n" + audit.summarize(report))
    audit.assert_no_param_gathers(report, [(3, 3), (4,), (1, 3)], min_rows=1024)
    check(sum(c.op == "all-gather" for c in report) == 7 * TIER_VIEWS,
          "the manual step all-gathers the 7 projected arrays per view and no raw parameter")
    del results
    g = fresh()
    with torch.no_grad():
        a = render(cams[0], g, cfg, bg_color=bg)
        zero_counts(counters)
        b = render_tile_sharded(cams[0], g, cfg, group, bg_color=bg)
        tile_render = read_counts(counters)
    img_err = float((a["render"] - b["render"]).abs().max())
    t_err = float((a["final_T"] - b["final_T"]).abs().max())
    print(f"render_tile_sharded vs render() on train view 0: image max abs diff {img_err:.3e}, final T {t_err:.3e} "
          f"(tolerance {TILE_IMAGE_ATOL}); launches {tile_render}")
    check(img_err <= TILE_IMAGE_ATOL and t_err <= TILE_IMAGE_ATOL, "render_tile_sharded agrees with render()")
    summary.update(tier_3dgs={"launches": launches, "ms": times, "manual_vs_batched": dm, "tile_vs_batched": dt,
                              "batched_run_to_run": dr,
                              "tile_render_err": img_err, "collectives": [c._asdict() for c in report], "smi": smi})
    del g, a, b
    summary["tier_3dgs_launches"] = {f"3dgs_{k}": v for k, v in launches.items()}
    return summary["tier_3dgs_launches"]


def stacked_tier_path(args, device, summary, data, model_dir, work, tscene, batch, stack, layers) -> dict:
    """Section 29: the stacked tier at the width of sections 16-18 (the
    CLI's recipe, float32 Adam): one ``make_dp_train_step`` on a (data 1,
    fsdp 1) mesh with the model under FSDP2 against ``make_train_step`` on
    the same window and dropout key; then one epoch of ``cli.train_stacked
    --dp 1 --fsdp 1`` at one layer. Returns the K1-K4 launches of both."""
    import gc

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from gaussian_transformer_tpu_torch.cli import train_stacked as cli_stacked
    from torch.distributed.tensor import DTensor

    from gaussian_transformer_tpu_torch.parallel.fsdp import full_tensor, leaf_spec, shard_model
    from gaussian_transformer_tpu_torch.parallel.mesh import world_device_type
    from gaussian_transformer_tpu_torch.render import RenderConfig
    from gaussian_transformer_tpu_torch.train import stacked

    on_card = device.type == "cuda"
    smi = smi_line() if on_card else "cpu"
    tier_group(device)
    print(f"== 29. the stacked tier: make_dp_train_step under FSDP2 on a (data 1, fsdp 1) mesh vs make_train_step "
          f"(STACK {stack}, {layers} layers, float32 Adam)")
    counters = kernel_counters()
    key = (42, 29)
    out, ms = {}, {}

    def timed(name, fn):
        zero_counts(counters)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        res = fn()
        if on_card:
            ev[1].record()
            torch.cuda.synchronize()
            ms[name] = ev[0].elapsed_time(ev[1])
            ms[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out[name] = read_counts(counters)
        return res

    model = stacked.make_stacked_model(stack, layers, 0, seed=0, device=device)
    step = stacked.make_train_step(model, tscene.handler, RenderConfig(), stacked.make_optimizer(model), stack)
    ref_loss, ref_met = timed("stacked_train_step", lambda: step(batch.src, batch.trg_y, batch.cameras, 5e-4,
                                                                  batch.src_mask, key + (0,)))
    ref = {n: p.detach().cpu() for n, p in model.named_parameters()}
    ref_loss = float(ref_loss)
    del model, step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    model = stacked.make_stacked_model(stack, layers, 0, seed=0, device=device)
    mesh = init_device_mesh(world_device_type(), (1, 1), mesh_dim_names=("data", "fsdp"))
    shard_model(model, mesh)
    step = stacked.make_dp_train_step(model, tscene.handler, RenderConfig(), stacked.make_optimizer(model), stack,
                                      mesh=mesh)
    loss, met = timed("stacked_dp_fsdp_step", lambda: step(batch.src, batch.trg_y, [batch.cameras], 5e-4,
                                                           batch.src_mask, key))
    loss = float(loss)
    sharded = sum(isinstance(p, DTensor) for p in model.parameters())
    want = sum(bool(leaf_spec(p, 1, "fsdp")) for p in model.parameters())
    p_err = max(float((full_tensor(p.detach()).cpu() - ref[n]).abs().max()) for n, p in model.named_parameters())
    l_err = abs(loss - ref_loss) / abs(ref_loss)
    print(f"make_train_step: loss {ref_loss:.7f} (chamfer {float(ref_met['chamfer']):.4f}); make_dp_train_step "
          f"under FSDP2 ({sharded} of {len(ref)} parameters sharded): loss {loss:.7f}; loss rel diff {l_err:.3e}, "
          f"largest parameter difference after the step {p_err:.3e} (tolerance {TIER_PARAM_ATOL}); launches "
          f"{out}")
    if on_card:
        print(f"[{smi}] make_train_step {ms['stacked_train_step']:.1f} ms, peak {ms['stacked_train_step_peak_gib']:.2f} "
              f"GiB; make_dp_train_step under FSDP2 {ms['stacked_dp_fsdp_step']:.1f} ms, peak "
              f"{ms['stacked_dp_fsdp_step_peak_gib']:.2f} GiB (CUDA events, one step; "
              f"torch.cuda.max_memory_allocated)")
    check(sharded == want, f"FSDP2 holds the {want} parameters leaf_spec shards as DTensors")
    check(l_err <= TIER_LOSS_REL and p_err <= TIER_PARAM_ATOL,
          "the FSDP2 data-parallel step agrees with the single-device step")
    summary.update(tier_stacked={"loss": loss, "ref_loss": ref_loss, "loss_rel": l_err, "param_err": p_err,
                                 "ms": ms, "launches": dict(out), "sharded": sharded})
    del model, step, ref
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    print("== 29a. main path: cli.train_stacked --dp 1 --fsdp 1, one epoch at 1 layer")
    dev_arg = [] if on_card else ["--device", str(device)]
    t0 = time.time()
    res = timed("stacked_cli_dp_fsdp", lambda: cli_stacked.main(
        ["-s", str(data), "-m", str(model_dir), "--eval", "--epochs", "1", "--stack", str(stack), "--layers", "1",
         "--run_name", str(work / "run_tier"), "--quiet", "--dp", "1", "--fsdp", "1"] + dev_arg))
    hist = res["history"]
    print(f"cli.train_stacked --dp 1 --fsdp 1: {len(hist)} steps in {time.time() - t0:.1f} s; launches "
          f"{out['stacked_cli_dp_fsdp']}; losses {[round(h['loss'], 4) for h in hist]}")
    check(len(hist) == tscene.size // 4 and all(math.isfinite(h["loss"]) for h in hist),
          f"{tscene.size // 4} data-parallel steps with finite losses")
    summary["tier_stacked"]["cli_losses"] = [h["loss"] for h in hist]
    summary["tier_stacked_launches"] = dict(out)
    del res
    gc.collect()
    return summary["tier_stacked_launches"]


def host_available_bytes() -> int:
    """The host's available memory (``MemAvailable`` of /proc/meminfo)."""
    with open("/proc/meminfo") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith("MemAvailable:"))


def state_mismatches(model_a, opt_a, model_b, opt_b) -> tuple:
    """(tensors compared, names of those that differ) over two models'
    parameters and their Adam state, each whole (``full_tensor``), bit for
    bit (``torch.equal``)."""
    import torch

    from gaussian_transformer_tpu_torch.parallel.fsdp import full_tensor

    n, bad = 0, []
    for (name, p), (name_b, q) in zip(model_a.named_parameters(), model_b.named_parameters()):
        pairs = [("", p.detach(), q.detach())]
        sa, sb = opt_a.state.get(p, {}), opt_b.state.get(q, {})
        if set(sa) != set(sb) or name != name_b:
            bad.append(name)
            continue
        pairs += [(f".{k}", sa[k], sb[k]) for k in sorted(sa)]
        for k, x, y in pairs:
            n += 1
            x, y = full_tensor(x), full_tensor(y)
            if x.device != y.device:
                y = y.to(x.device)
            if not torch.equal(x, y):
                bad.append(name + k)
    return n, bad


def orbax_fsdp_path(args, device, summary, data, model_dir, work, stack, layers) -> dict:
    """Section 29b: ``cli.train_stacked --fsdp 1 --orbax`` at the width of
    sections 16-18 in the tier's group: two epochs to a snapshot at epoch 1,
    then the same run again, which resumes at epoch 2 and trains no
    further; its parameters and Adam state against the first run's (the
    state gathered at the save) bit for bit, and the snapshot restored into
    an unsharded model likewise. Prints the snapshot's bytes, the ms the
    save held training, the write's and the restores' seconds, the disk's
    free bytes before the write and the host's available memory. Returns
    the K1-K4 launches of the two runs."""
    import gc
    import shutil

    import torch

    from gaussian_transformer_tpu_torch.cli import train_stacked as cli_stacked
    from gaussian_transformer_tpu_torch.train import orbax_ckpt, stacked

    on_card = device.type == "cuda"
    smi = smi_line() if on_card else "cpu"
    tier_group(device)
    run = work / "run_orbax"
    shutil.rmtree(run, ignore_errors=True)
    print(f"== 29b. cli.train_stacked --fsdp 1 --orbax (STACK {stack}, {layers} layers): two epochs to a snapshot at "
          f"epoch 1, then a resume")
    counters = kernel_counters()
    argv = ["-s", str(data), "-m", str(model_dir), "--eval", "--stack", str(stack), "--layers", str(layers),
            "--run_name", str(run), "--quiet", "--fsdp", "1", "--orbax", "--checkpoint_every", "1", "--epochs", "2",
            "--ip", "127.0.0.1", "--port", "0"] + ([] if on_card else ["--device", str(device)])
    free_before, host_before = shutil.disk_usage(work).free, host_available_bytes()
    zero_counts(counters)
    t0 = time.time()
    first = cli_stacked.main(argv)
    t_first = time.time() - t0
    launches = {"stacked_cli_fsdp_orbax": read_counts(counters)}
    snap = first["snapshots"]
    state_file = run / "orbax" / "1" / orbax_ckpt.STATE_FILE
    n_bytes = state_file.stat().st_size if state_file.exists() else 0
    check(first["first_epoch"] == 0 and list(snap["save_ms"]) == [1] and list(snap["write_s"]) == [1]
          and n_bytes > 0, "the first run saved one snapshot, at epoch 1")
    zero_counts(counters)
    host_mid = host_available_bytes()
    t0 = time.time()
    second = cli_stacked.main(argv)
    t_second = time.time() - t0
    launches["stacked_cli_fsdp_orbax_resume"] = read_counts(counters)
    check(second["first_epoch"] == 2 and second["snapshots"]["restored"] == 1 and not second["history"],
          "the second run resumed from the snapshot at epoch 2 and trained no further")
    n_cmp, bad = state_mismatches(second["model"], second["optimizer"], first["model"], first["optimizer"])
    print(f"resumed vs the state gathered at the save: {n_cmp} tensors (parameters, Adam's exp_avg, exp_avg_sq and "
          f"step), {len(bad)} differ {bad[:5]}")
    check(n_cmp > 0 and not bad, "every restored parameter and Adam moment equals the saved state bit for bit")
    del first
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    plain = stacked.make_stacked_model(stack, layers, 0, seed=1, device=device)
    plain_opt = stacked.make_optimizer(plain)
    t0 = time.perf_counter()
    step = orbax_ckpt.restore_state(orbax_ckpt.make_manager(str(run)), plain, plain_opt)
    if on_card:
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    n_plain, bad_plain = state_mismatches(plain, plain_opt, second["model"], second["optimizer"])
    print(f"the snapshot restored into an unsharded model: step {step}, {n_plain} tensors, {len(bad_plain)} differ "
          f"{bad_plain[:5]}")
    check(step == 1 and n_plain == n_cmp and not bad_plain,
          "the snapshot restores into an unsharded model bit for bit")
    out = {"bytes": n_bytes, "save_ms": snap["save_ms"][1], "write_s": snap["write_s"][1],
           "restore_s": second["snapshots"]["restore_s"], "restore_unsharded_s": plain_s, "disk_free_before": free_before,
           "host_available_before": host_before, "host_available_after_save": host_mid, "first_run_s": t_first,
           "second_run_s": t_second, "launches": launches, "smi": smi}
    print(f"[{smi}] snapshot {n_bytes} bytes ({n_bytes / 1e9:.2f} GB); the save held training {out['save_ms']:.1f} ms "
          f"(gather + copy to the host); the write {out['write_s']:.2f} s (writer thread); the resume's restore "
          f"{out['restore_s']:.2f} s, into an unsharded model {plain_s:.2f} s (the file read warm: just written); "
          f"disk free before the write {free_before} bytes; host memory available {host_before} bytes before, "
          f"{host_mid} after the first run; the runs {t_first:.1f} s and {t_second:.1f} s")
    del second, plain, plain_opt
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    shutil.rmtree(run, ignore_errors=True)
    summary["tier_orbax"] = out
    summary["tier_orbax_launches"] = launches
    return launches


def flat_tier_path(args, device, summary, d_model=FLAT_D, layers=FLAT_LAYERS) -> dict:
    """Section 30: the flat tier at the width of section 19 (d_model 1024,
    N 6) on its scene's longest camera: one loss and backward with
    ``ring_attention`` over a one-rank group against the same with
    ``blockwise_attention``; ``ulysses_attention`` on q/k/v of the main
    path's shape; a heartbeat. Returns the K1-K4 launches of the ring step."""
    import gc

    import torch

    from gaussian_transformer_tpu_torch.cli import train_transformer as cli_flat
    from gaussian_transformer_tpu_torch.ops.attention import blockwise_attention
    from gaussian_transformer_tpu_torch.parallel.health import heartbeat
    from gaussian_transformer_tpu_torch.parallel.ring import ring_attention
    from gaussian_transformer_tpu_torch.parallel.ulysses import ulysses_attention
    from gaussian_transformer_tpu_torch.render import RenderConfig
    from gaussian_transformer_tpu_torch.scene import Scene
    from gaussian_transformer_tpu_torch.train import flat

    on_card = device.type == "cuda"
    smi = smi_line() if on_card else "cpu"
    group = tier_group(device)
    work = (Path(args.work) / "flat").resolve()
    random.seed(args.seed)
    ns = Namespace(sh_degree=1, source_path=str(work / "data"), model_path=str(work / "model"), images="images",
                   resolution=-1, white_background=False, data_device=str(device), eval=True)
    tscene = flat.FlatTrainingScene(Scene(ns, load_iteration=-1, sh_degree=1, device=device), RenderConfig(),
                                    max_len=FLAT_MAX_LEN, min_len=cli_flat.MIN_LEN)
    longest = max(range(tscene.size), key=lambda i: int(tscene.visible[i].sum()))
    tscene.set_epoch(0)
    batch = tscene.make_batch(longest)
    Ls, Lt = batch["src"].shape[1], batch["trg"].shape[1]
    print(f"== 30. the flat tier: ring_attention over a one-rank group vs blockwise_attention (d_model {d_model}, "
          f"{layers} layers), camera {longest}: src {Ls} tokens, tgt {Lt}")
    counters = kernel_counters()
    args_b = [batch[k] for k in ("src", "trg", "trg_y", "src_mask", "trg_mask", "cam")]
    runs, ms = {}, {}
    ring = flat.init_flat_model(flat.EmbeddedEncoderDecoder(N=layers, d_model=d_model, device=device,
                                                            seq_group=group), seed=0)
    blk = flat.EmbeddedEncoderDecoder(N=layers, d_model=d_model, block_k=FLAT_BLOCK_K, device=device)
    blk.load_state_dict(ring.state_dict())
    launches = {}
    for name, model in (("ring", ring), ("blockwise", blk)):
        zero_counts(counters)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        loss, met = flat.make_flat_loss(model, RenderConfig(), use_lpips=False)(*args_b)
        loss.backward()
        if name == "ring":
            flat.reduce_grads(model.parameters(), group)
        if on_card:
            ev[1].record()
            torch.cuda.synchronize()
            ms[name] = ev[0].elapsed_time(ev[1])
            ms[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        launches[name] = read_counts(counters)
        runs[name] = (float(loss.detach()), {n: p.grad for n, p in model.named_parameters()})
    l_err = abs(runs["ring"][0] - runs["blockwise"][0]) / abs(runs["blockwise"][0])
    g_scale = max(float(g.abs().max()) for g in runs["blockwise"][1].values())
    g_err = max(float((runs["ring"][1][n] - g).abs().max()) for n, g in runs["blockwise"][1].items())
    print(f"loss: ring {runs['ring'][0]:.7f}, blockwise {runs['blockwise'][0]:.7f} (rel diff {l_err:.3e}, tolerance "
          f"{TIER_LOSS_REL}); gradients max abs diff {g_err:.3e} = {g_err / g_scale:.3e} of max {g_scale:.3e} "
          f"(tolerance {TIER_GRAD_REL}); launches {launches}")
    if on_card:
        print(f"[{smi}] loss and backward: ring {ms['ring']:.1f} ms (peak {ms['ring_peak_gib']:.2f} GiB), blockwise "
              f"{ms['blockwise']:.1f} ms (peak {ms['blockwise_peak_gib']:.2f} GiB) (CUDA events, one step)")
        check(launches["ring"] == {"K1": 2, "K2": 1, "K3": 0, "K4": 0}, "K1 twice and K2 once in the ring step")
    check(l_err <= TIER_LOSS_REL and g_err <= TIER_GRAD_REL * g_scale, "the ring step agrees with the blockwise step")
    del ring, blk, runs
    gc.collect()

    gen = torch.Generator(device).manual_seed(args.seed + 30)
    h, dk = 8, d_model // 8
    q, k, v = (torch.randn(1, h, Ls, dk, generator=gen, device=device) for _ in range(3))
    mask = batch["src_mask"][:, None]  # [1, 1, 1, Ls]
    with torch.no_grad():
        o_ring = ring_attention(q, k, v, mask, group)
        o_uly = ulysses_attention(q, k, v, mask, group)
        o_blk = blockwise_attention(q, k, v, mask, block_k=FLAT_BLOCK_K)
    scale = float(o_blk.abs().max())
    e_ring, e_uly = float((o_ring - o_blk).abs().max()), float((o_uly - o_blk).abs().max())
    print(f"attention on q/k/v [1, {h}, {Ls}, {dk}] with the source PAD mask: ring vs blockwise max abs diff "
          f"{e_ring:.3e}, ulysses vs blockwise {e_uly:.3e} (of max {scale:.3e}; tolerance {TIER_ATTN_REL} x max)")
    check(e_ring <= TIER_ATTN_REL * scale and e_uly <= TIER_ATTN_REL * scale,
          "ring and Ulysses attention agree with blockwise attention")
    beat = heartbeat(60.0, group)
    print(f"heartbeat over the world: {beat}")
    check(beat, "the heartbeat completed")
    summary.update(tier_flat={"loss_rel": l_err, "grad_err": g_err, "grad_scale": g_scale, "ms": ms,
                              "launches": launches, "ring_err": e_ring, "ulysses_err": e_uly, "src_len": Ls})
    del q, k, v, o_ring, o_uly, o_blk
    gc.collect()
    summary["tier_flat_launches"] = {"flat_ring_step": launches["ring"]}
    return summary["tier_flat_launches"]


# ------------------------------------------------------ the viewer bridge ---

VIEWER_REQUESTS = 20  # served frames timed in section 31
VIEWER_TRAIN_ITERS = 30  # cli.train iterations with a client attached
VIEWER_TRAIN_FRAMES = 20  # frames the client asks for during them
STEP_KERNEL_REPEATS = 3  # section 31c's steps counted with and without a pump, each alone
VIEWER_IMAGE_ATOL = 2e-5  # section 32b's frames under FSDP2 vs section 32's (the repo's image rule)
# full_eval's synthetic roots: one scene per list (a child process per
# render and one for the metrics), at this size.
FULL_EVAL_SCENES = {"mipnerf360_outdoor_scenes": ["bicycle"], "mipnerf360_indoor_scenes": ["room"],
                    "tanks_and_temples_scenes": ["truck"], "deep_blending_scenes": ["drjohnson"]}
FULL_EVAL_GAUSSIANS, FULL_EVAL_VIEWS, FULL_EVAL_W, FULL_EVAL_H = 50_000, 3, 480, 270


def free_port() -> int:
    """A free localhost port (bind port 0, read it, release it)."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sibr_request(cam, train: bool, keep_alive: bool = True, smod: float = 1.0, shs_python: bool = False) -> bytes:
    """The SIBR viewer's request for ``cam`` (its matrices with the
    protocol's flips undone, which ``receive`` flips back)."""
    view = np.array(cam.world_view_transform.detach().cpu().numpy(), np.float32)
    proj = np.array(cam.full_proj_transform.detach().cpu().numpy(), np.float32)
    view[:, 1:3] *= -1
    proj[:, 1] *= -1
    msg = {"resolution_x": cam.image_width, "resolution_y": cam.image_height, "train": train,
           "fov_y": cam.FoVy, "fov_x": cam.FoVx, "z_near": 0.01, "z_far": 100.0, "shs_python": shs_python,
           "rot_scale_python": False, "keep_alive": keep_alive, "scaling_modifier": smod,
           "view_matrix": [float(v) for v in view.ravel()],
           "view_projection_matrix": [float(v) for v in proj.ravel()]}
    payload = json.dumps(msg).encode()
    return len(payload).to_bytes(4, "little") + payload


class SibrClient:
    """A SIBR viewer in a thread: it connects to ``port`` (retrying until the
    listener is bound), sends each request once the reply to the last one
    has arrived, and records (image bytes, verify string, ms from the
    request sent to the reply's last byte) per reply; then it closes the
    connection, which ends the server's service."""

    def __init__(self, port: int, requests, image_bytes, timeout: float = 300.0):
        import threading

        self.port, self.requests, self.timeout = port, list(requests), timeout
        self.image_bytes = image_bytes if isinstance(image_bytes, list) else [image_bytes] * len(self.requests)
        self.replies, self.error = [], None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _recv(self, s, n) -> bytes:
        out = bytearray()
        while len(out) < n:
            chunk = s.recv(min(n - len(out), 1 << 22))
            if not chunk:
                raise ConnectionError("closed mid-reply")
            out += chunk
        return bytes(out)

    def _run(self):
        import socket

        try:
            deadline = time.time() + self.timeout
            while True:
                try:
                    s = socket.create_connection(("127.0.0.1", self.port), timeout=self.timeout)
                    break
                except ConnectionRefusedError:
                    if time.time() > deadline:
                        raise
                    time.sleep(0.05)
            with s:
                for req, n in zip(self.requests, self.image_bytes):
                    t0 = time.perf_counter()
                    s.sendall(req)
                    img = self._recv(s, n)
                    verify = self._recv(s, int.from_bytes(self._recv(s, 4), "little")).decode("ascii")
                    self.replies.append((img, verify, (time.perf_counter() - t0) * 1e3))
        except Exception as e:  # read by the main thread
            self.error = e

    @property
    def done(self) -> bool:
        return not self.thread.is_alive()

    def join(self):
        self.thread.join(self.timeout)
        check(self.error is None and self.done, f"the SIBR client finished ({self.error!r})")


def serve_until(client, tick, timeout: float = 300.0) -> None:
    """Call ``tick()`` (one viewer pump) until ``client`` is done."""
    deadline = time.time() + timeout
    while not client.done and time.time() < deadline:
        tick()
        time.sleep(0.001)
    client.join()


def step_kernels(ckpt: Path, cam, gt, cfg, device, before=None, repeats: int = STEP_KERNEL_REPEATS) -> dict:
    """The CUDA kernels of ``repeats`` warm train steps of the state in
    ``ckpt``, one ``kernel_count`` a step: {"launches": [...],
    "device_events": [...]} (the host's launch calls, exact, and the
    profiler's device events, which vary by tens between identical steps),
    with ``before()`` called just before each step."""
    import torch

    from gaussian_transformer_tpu_torch.train.splat import OptConfig, restore, train_step

    scene, adam, stats, it, slrs = restore(dict(np.load(ckpt, allow_pickle=False)), device)
    cam.original_image = gt
    bg = torch.zeros(3, device=device)

    def step():
        if before is not None:
            before()
        train_step(scene, adam, stats, cam, bg, it, slrs, OptConfig(), cfg)

    step()
    counts = [kernel_count(step) for _ in range(repeats)]
    return {k: [c[k] for c in counts] for k in ("launches", "device_events")}


def viewer_path(args, device, summary, scene, fovx, test_c2ws, train_cfg) -> dict:
    """Section 31: the SIBR viewer bridge on the 3DGS path. Returns the K1-K4
    launches of its runs (the served frames, cli.train with a client)."""
    import shutil

    import torch

    from gaussian_transformer_tpu_torch.cli import train as cli_train
    from gaussian_transformer_tpu_torch.render import RenderConfig, render
    from gaussian_transformer_tpu_torch.utils.png import read_png
    from gaussian_transformer_tpu_torch.viewer import network_gui

    on_card = device.type == "cuda"
    smi = smi_line(device)
    W, H = args.width, args.height
    work = Path(args.work)
    data, model = work / "train_data", work / "train_model"
    counters = kernel_counters()
    out = {}

    print(f"== 31. the SIBR viewer: network_gui.pump serving section 2's scene ({args.gaussians} Gaussians, "
          f"SH 3) at {W}x{H} to a client over 127.0.0.1, {VIEWER_REQUESTS} requests over the test views")
    cams = [camera_from_c2w(c, fovx, W, H, device) for c in test_c2ws]
    smods = [(1.0, 0.5)[i % 2] for i in range(VIEWER_REQUESTS)]
    reqs = [sibr_request(cams[i % len(cams)], train=i == VIEWER_REQUESTS - 1, smod=smods[i])
            for i in range(VIEWER_REQUESTS)]
    served = []

    @torch.no_grad()
    def render_fn(cam, smod):
        served.append((cam, smod))
        return render(cam, scene, RenderConfig(), scaling_modifier=smod)["render"]

    port = free_port()
    network_gui.init("127.0.0.1", port)
    zero_counts(counters)
    client = SibrClient(port, reqs, W * H * 3)
    serve_until(client, lambda: network_gui.pump(render_fn, source_path=str(data), device=device))
    served_launches = read_counts(counters)
    network_gui.conn = None
    check(len(client.replies) == VIEWER_REQUESTS and len(served) == VIEWER_REQUESTS,
          f"{VIEWER_REQUESTS} frames served ({len(client.replies)} received, {len(served)} rendered)")
    if on_card:
        check(served_launches["K1"] == VIEWER_REQUESTS, f"K1 launched once per served frame ({served_launches})")
    mismatched = 0
    with torch.no_grad():
        for (img, verify, _), (cam, smod) in zip(client.replies, served):
            direct = bytes(network_gui.image_to_bytes(render(cam, scene, RenderConfig(), scaling_modifier=smod)["render"]))
            mismatched += img != direct or verify != str(data)
    check(mismatched == 0, f"every served frame equals image_to_bytes(render(...)) of its camera and "
                           f"scaling modifier, and names the source path ({mismatched} of {VIEWER_REQUESTS} differ)")
    check(len({img for img, _, _ in client.replies[:2]}) == 2, "scaling modifiers 1 and 0.5 serve different frames")
    frame_ms = [ms for _, _, ms in client.replies]
    out["served"] = served_launches
    summary.update(viewer_frame_ms=frame_ms)
    if on_card:
        with torch.no_grad():
            render_ms = {smod: cuda_ms(lambda: render(cams[0], scene, RenderConfig(), scaling_modifier=smod), reps=5)
                         for smod in (1.0, 0.5)}
            bytes_ms = cuda_ms(lambda: network_gui.image_to_bytes(
                render(cams[0], scene, RenderConfig())["render"]), reps=5)
        print(f"[{smi}] served frame, request sent to last byte received: {spread(frame_ms)}; the render alone "
              f"(test view 0, CUDA events): {render_ms[1.0]:.3f} ms at smod 1.0, {render_ms[0.5]:.3f} ms at 0.5; "
              f"render + image_to_bytes: {bytes_ms:.3f} ms")
        summary.update(viewer_render_ms=render_ms, viewer_render_bytes_ms=bytes_ms)
    network_gui.listener.close()

    print(f"== 31b. cli.train on section 6's dataset for {VIEWER_TRAIN_ITERS} iterations with --port and a client "
          f"asking for {VIEWER_TRAIN_FRAMES} frames (train=True) of train view 0")
    with open(data / "transforms_train.json") as f:
        c2w0 = json.load(f)["frames"][0]["transform_matrix"]
    cam0 = camera_from_c2w(c2w0, fovx, W, H, device)
    vmodel = work / "viewer_model"
    shutil.rmtree(vmodel, ignore_errors=True)
    port = free_port()
    client = SibrClient(port, [sibr_request(cam0, train=True, keep_alive=False)] * VIEWER_TRAIN_FRAMES, W * H * 3)
    zero_counts(counters)
    dev_arg = [] if on_card else ["--device", str(device)]
    n = VIEWER_TRAIN_ITERS
    t0 = time.time()
    res = cli_train.main(["-s", str(data), "-m", str(vmodel), "-r", "1", "--eval", "--iterations", str(n),
                          "--test_iterations", str(n), "--save_iterations", str(n), "--quiet",
                          "--ip", "127.0.0.1", "--port", str(port)] + dev_arg)
    t_train = time.time() - t0
    client.join()
    network_gui.conn = None
    network_gui.listener.close()
    train_launches = read_counts(counters)
    losses = [h["loss"] for h in res["history"]]
    print(f"cli.train with the viewer: {n} steps in {t_train:.1f} s; launches {train_launches}; "
          f"{len(client.replies)} frames received")
    check(len(losses) == n and all(math.isfinite(v) for v in losses), "every loss is finite")
    check(np.mean(losses[-10:]) < np.mean(losses[:10]), "the loss falls")
    check(len(client.replies) == VIEWER_TRAIN_FRAMES and all(len(img) == W * H * 3 and verify == str(data)
                                                             for img, verify, _ in client.replies),
          f"{VIEWER_TRAIN_FRAMES} frames of {W}x{H}x3 bytes arrived, each naming the source path")
    if on_card:
        extra = summary["train_launches"]["K1"] - args.iterations  # section 7's probe and evaluation renders
        check(train_launches["K1"] == n + VIEWER_TRAIN_FRAMES + extra and train_launches["K2"] == n,
              f"K1 once per step and per served frame, plus the probe and evaluation renders ({extra}, as in "
              f"section 7); K2 once per step")
    out["cli_train"] = train_launches
    summary.update(viewer_train_s=t_train, viewer_train_frame_ms=[ms for _, _, ms in client.replies])

    if on_card:
        print("== 31c. a bound listener and no client: section 9's tools on one train step with and without a pump "
              "before it")
        ckpt = model / f"chkpnt{args.iterations}.npz"
        gt = torch.as_tensor(read_png(str(data / "train" / "r_0.png"))[..., :3].transpose(2, 0, 1) / 255.0,
                             dtype=torch.float32, device=device)
        network_gui.init("127.0.0.1", free_port())
        pump = lambda: network_gui.pump(lambda c, s: None, device=device)
        syncs = {"no listener": train_step_syncs(ckpt, cam0, gt, train_cfg, device),
                 "pump, no client": train_step_syncs(ckpt, cam0, gt, train_cfg, device, before=pump)}
        kernels_n = {"no listener": step_kernels(ckpt, cam0, gt, train_cfg, device),
                     "pump, no client": step_kernels(ckpt, cam0, gt, train_cfg, device, before=pump)}
        network_gui.listener.close()
        print("host synchronisations of one step by call site: " + json.dumps(syncs))
        print(f"CUDA kernels of {STEP_KERNEL_REPEATS} steps in turn (torch.profiler; host launch calls and device "
              f"events, one a step): {kernels_n}")
        check(syncs["no listener"] == syncs["pump, no client"], "the pump adds no host synchronisation")
        check(kernels_n["no listener"]["launches"] == kernels_n["pump, no client"]["launches"],
              "the pump adds no launch (the host's launch calls of each step; the device events vary by tens "
              "between identical steps)")
        summary.update(viewer_step_syncs=syncs, viewer_step_kernels=kernels_n)
    return out


class RecordingStream:
    """A LiveViewerStream that keeps a copy of every carry it renders (the
    decoded rows, their count) and the request's camera and flags."""

    def __init__(self, inner):
        self.inner, self.rendered, self.images = inner, [], []

    @property
    def n_steps(self):
        return self.inner.n_steps

    def decoding(self):
        return self.inner.decoding()

    def start(self):
        return self.inner.start()

    def step(self, carry):
        return self.inner.step(carry)

    def render(self, carry, cam, smod, show_prompt, show_pred):
        self.rendered.append((carry[0].clone(), carry[2], cam, smod, show_prompt, show_pred))
        self.images.append(self.inner.render(carry, cam, smod, show_prompt, show_pred))
        return self.images[-1]


def stacked_viewer_path(args, device, summary, model, tscene, batch, stack) -> dict:
    """Section 32: the stacked live stream on section 16's model and first
    batch. Returns the K1 launches of the stream (``stream``), its frames
    (``frames``: each streamed image, ``teacher_forced``: the train-mode
    tick's) and the streamed frames' ms (``frame_ms``), for section 32b."""
    import torch

    from gaussian_transformer_tpu_torch.render import RenderConfig
    from gaussian_transformer_tpu_torch.train import stacked
    from gaussian_transformer_tpu_torch.viewer import network_gui

    on_card = device.type == "cuda"
    smi = smi_line(device)
    counters = kernel_counters()
    cam = batch.cameras[0]
    W, H = cam.image_width, cam.image_height
    Lt = batch.trg_y.shape[1]
    print(f"== 32. the stacked live stream: pump_stacked with train=False streams the cached decode of the first "
          f"batch ({Lt} tokens), one {W}x{H} frame a token (show_prompt and show_pred)")
    stream = stacked.LiveViewerStream(model, tscene.handler, RenderConfig(), stack)
    stream.set_batch(batch)
    rec = RecordingStream(stream)
    reqs = [sibr_request(cam, train=False, keep_alive=True, shs_python=True) for _ in range(Lt)]
    reqs.append(sibr_request(cam, train=True))
    port = free_port()
    network_gui.init("127.0.0.1", port)
    model.eval()
    zero_counts(counters)
    client = SibrClient(port, reqs, W * H * 3)
    serve_until(client, lambda: network_gui.pump_stacked(lambda *a: None, rec, "stacked", device=device))
    stream_launches = read_counts(counters)
    network_gui.conn = None
    frames = [img for img, _, _ in client.replies]
    check(len(rec.rendered) == Lt and len(frames) == Lt + 1,
          f"one frame per decoded token ({len(rec.rendered)} rendered of {Lt}), then the last again ({len(frames)})")
    if on_card:
        check(stream_launches["K1"] == Lt, f"K1 once per streamed frame ({stream_launches})")
    with torch.no_grad():
        expect = [bytes(network_gui.image_to_bytes(stream.compose(ys, i, c, s, p, q)))
                  for ys, i, c, s, p, q in rec.rendered]
    check(frames[:Lt] == expect and frames[Lt] == expect[-1],
          "each streamed frame equals LiveViewerStream.compose of the same carry")
    check([i for _, i, *_ in rec.rendered] == list(range(1, Lt + 1)), "the frames follow the decode steps 1..Lt")
    frame_ms = [ms for _, _, ms in client.replies[:Lt]]
    out = {"stream": stream_launches, "frames": rec.images, "frame_ms": frame_ms}

    print("== 32a. one train=True tick: the teacher-forced composite of the batch, the model in train mode after")
    model.train()
    fn = stacked.make_viewer_train_fn(stream)
    client = SibrClient(port, [sibr_request(cam, train=True, keep_alive=True, shs_python=True)], W * H * 3)
    serve_until(client, lambda: network_gui.pump_stacked(fn, stream, "stacked", device=device))
    network_gui.conn = None
    network_gui.listener.close()
    check(model.training, "model.training is True after the train-mode tick")
    with torch.no_grad():
        model.eval()
        gen = model.generator(model.decode(model.encode(batch.src, batch.src_mask), batch.src_mask, batch.trg,
                                           batch.trg_mask))
        out["teacher_forced"] = stream.compose(gen, gen.shape[1], cam, 1.0, True, True)
        expect = bytes(network_gui.image_to_bytes(out["teacher_forced"]))
    check(len(client.replies) == 1 and client.replies[0][0] == expect,
          "the train-mode frame is the teacher-forced decode's composite")
    summary.update(stacked_stream_frame_ms=frame_ms)
    if on_card:
        med = float(np.median(frame_ms))
        tok = summary.get("stacked_cached_ms_per_token")
        with torch.no_grad(), stream.decoding():
            carry = stream.start()
            for _ in range(Lt // 2):
                carry = stream.step(carry)
            step_ms = cuda_ms_each(lambda: stream.step((carry[0], carry[1], Lt // 2)), reps=5)
            comp_ms = cuda_ms_each(lambda: stream.render((carry[0], carry[1], Lt // 2), cam, 1.0, True, True), reps=5)
        print(f"[{smi}] streamed frame (request sent to last byte received: decode step + render + bytes): "
              f"{spread(frame_ms)}; section 16's cached decode {tok if tok is None else round(tok, 3)} ms/token; "
              f"at token {Lt // 2}: decode step {spread(step_ms)}, composite render {spread(comp_ms)}")
        summary.update(stacked_stream_frame_ms_median=med, stacked_stream_step_ms=step_ms,
                       stacked_stream_render_ms=comp_ms)
    return out


def fsdp_viewer_path(args, device, summary, tscene, batch, stack, layers, viewer) -> dict:
    """Section 32b: section 32's stream on a fresh model of section 16's
    weights under FSDP2 (``shard_model`` on a one-rank mesh), served by the
    collective pump (``pump_stacked(..., group=)`` on a gloo group of its
    own): the streamed frames and the train-mode tick's frame against
    section 32's (``viewer``: the unsharded model's) within 2e-5, K1 once a
    frame, the model left in train mode; with the listener bound and no
    client, the pump alone makes no host synchronisation and launches no
    kernel, and one train step with and without it before makes the same
    host synchronisations by call site. Returns the K1-K4 launches of the
    stream and of the train-mode tick."""
    import gc

    import torch
    import torch.distributed as dist

    from gaussian_transformer_tpu_torch.parallel.fsdp import make_fsdp_mesh, shard_model
    from gaussian_transformer_tpu_torch.render import RenderConfig
    from gaussian_transformer_tpu_torch.train import stacked
    from gaussian_transformer_tpu_torch.viewer import network_gui

    on_card = device.type == "cuda"
    smi = smi_line(device)
    tier_group(device)
    group = dist.new_group(backend="gloo")
    counters = kernel_counters()
    cam = batch.cameras[0]
    W, H = cam.image_width, cam.image_height
    Lt = batch.trg_y.shape[1]
    print(f"== 32b. the stacked live stream under FSDP2 (one-rank mesh), served by every rank's pump over a gloo group: "
          f"{Lt} frames, then a train-mode tick")
    model = stacked.make_stacked_model(stack, layers, 0, seed=0, device=device)
    shard_model(model, make_fsdp_mesh(1))
    stream = stacked.LiveViewerStream(model, tscene.handler, RenderConfig(), stack)
    stream.set_batch(batch)
    rec = RecordingStream(stream)
    reqs = [sibr_request(cam, train=False, keep_alive=True, shs_python=True) for _ in range(Lt)]
    reqs.append(sibr_request(cam, train=True))
    port = free_port()
    network_gui.init("127.0.0.1", port)
    model.eval()
    zero_counts(counters)
    client = SibrClient(port, reqs, W * H * 3)
    serve_until(client, lambda: network_gui.pump_stacked(lambda *a: None, rec, "stacked", device=device, group=group))
    out = {"stream_fsdp": read_counts(counters)}
    network_gui.conn = None
    frames = [img for img, _, _ in client.replies]
    check(len(rec.images) == Lt and len(frames) == Lt + 1,
          f"one frame per decoded token ({len(rec.images)} rendered of {Lt}), then the last again ({len(frames)})")
    if on_card:
        check(out["stream_fsdp"]["K1"] == Lt, f"K1 once per streamed frame ({out['stream_fsdp']})")
    err = max(float((a - b).abs().max()) for a, b in zip(rec.images, viewer["frames"]))
    sent = all(f == bytes(network_gui.image_to_bytes(img)) for f, img in zip(frames, rec.images))
    print(f"streamed frames under FSDP2 vs section 32's of the unsharded model: max abs diff {err:.3e} (tolerance "
          f"{VIEWER_IMAGE_ATOL}); the replies are the frames' bytes: {sent}")
    check(err <= VIEWER_IMAGE_ATOL and sent and frames[Lt] == frames[Lt - 1],
          "each streamed frame equals section 32's within the image rule, and is what was sent")
    frame_ms = [ms for _, _, ms in client.replies[:Lt]]

    model.train()
    fn = stacked.make_viewer_train_fn(stream)
    served = []

    def train_fn(*a):
        served.append(fn(*a))
        return served[-1]

    zero_counts(counters)
    client = SibrClient(port, [sibr_request(cam, train=True, keep_alive=True, shs_python=True)], W * H * 3)
    serve_until(client, lambda: network_gui.pump_stacked(train_fn, stream, "stacked", device=device, group=group))
    out["teacher_forced_fsdp"] = read_counts(counters)
    network_gui.conn = None
    check(model.training, "model.training is True after the train-mode tick")
    tf_err = float((served[0] - viewer["teacher_forced"]).abs().max()) if served else float("inf")
    print(f"the train-mode tick's frame vs section 32a's: max abs diff {tf_err:.3e} (tolerance {VIEWER_IMAGE_ATOL})")
    check(len(served) == 1 and len(client.replies) == 1 and tf_err <= VIEWER_IMAGE_ATOL
          and client.replies[0][0] == bytes(network_gui.image_to_bytes(served[0])),
          "the train-mode frame is the teacher-forced composite of the unsharded model's, within the image rule")
    summary.update(stacked_stream_fsdp_frame_ms=frame_ms, stacked_stream_fsdp_err=err,
                   stacked_stream_fsdp_teacher_forced_err=tf_err)
    if on_card:
        print(f"[{smi}] streamed frame under FSDP2 (request sent to last byte received): {spread(frame_ms)}; section "
              f"32's (unsharded, one process): {spread(viewer['frame_ms'])}")
        # A bound listener and no client: the collective pump before a step
        # adds no host synchronisation and no kernel (31c's check), counted
        # by the host's launch calls (kernel_count).
        optimizer = stacked.make_optimizer(model)
        step_fn = stacked.make_train_step(model, tscene.handler, RenderConfig(), optimizer, stack)
        # lr 0: every step the same (weights, dropout masks, the chamfer gate), so only the pump differs
        run_step = lambda: step_fn(batch.src, batch.trg_y, batch.cameras, 0.0, batch.src_mask, (42, 32))
        pump = lambda: network_gui.pump_stacked(fn, stream, "stacked", device=device, group=group)
        with_pump = lambda: (pump(), run_step())
        run_step()
        run_step()  # Adam's state and the allocator's blocks settled
        torch.cuda.synchronize()
        syncs = {"pump alone": syncs_by_site(pump), "no pump": syncs_by_site(run_step),
                 "pump, no client": syncs_by_site(with_pump)}
        kernels_n = {"pump alone": kernel_count(pump), "no pump": kernel_count(run_step),
                     "pump, no client": kernel_count(with_pump), "no pump again": kernel_count(run_step)}
        print("host synchronisations by call site of the pump alone and of one --fsdp 1 step without and with it: "
              + json.dumps(syncs))
        print(f"CUDA kernels (torch.profiler) of the pump alone and of one --fsdp 1 step without it, with it and "
              f"without it again: {kernels_n}")
        check(not syncs["pump alone"] and syncs["no pump"] == syncs["pump, no client"],
              "the collective pump adds no host synchronisation")
        check(kernels_n["pump alone"]["launches"] == 0
              and kernels_n["no pump"]["launches"] == kernels_n["pump, no client"]["launches"]
              == kernels_n["no pump again"]["launches"], "the collective pump adds no launch")
        summary.update(stacked_stream_fsdp_step_syncs=syncs, stacked_stream_fsdp_step_kernels=kernels_n)
        del optimizer, step_fn, run_step, with_pump
    network_gui.listener.close()
    dist.destroy_process_group(group)
    del model, stream, rec, fn, served
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------- native IO and full_eval ---


def io_probe() -> str:
    """What the machine offers the native IO tier: the headers, the
    libraries the loader knows, the compiler."""
    cmd = ("ls /usr/include/jpeglib.h /usr/include/png.h 2>&1; ldconfig -p | grep -E 'jpeg|png'; "
           "g++ --version 2>&1 | head -1")
    return subprocess.run(["bash", "-c", cmd], capture_output=True, text=True, timeout=60).stdout.strip()


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def write_full_eval_roots(root: Path, device, scenes=None, gaussians=FULL_EVAL_GAUSSIANS, views=FULL_EVAL_VIEWS,
                          width=FULL_EVAL_W, height=FULL_EVAL_H, seed=0) -> dict:
    """Synthetic roots for ``cli.full_eval --skip_training``: per scene of
    ``scenes`` ({full_eval list name: [scene]}), a COLMAP binary dataset
    under ``root/<m360|tat|db>/<scene>`` (the image folder the list trains
    on: images_4, images_2 or images; the ground truth a render plus
    N(0, 0.05)) and a trained model dir ``root/eval/<scene>`` holding
    point_cloud/iteration_7000 and _30000 and its cfg_args. Returns the
    full_eval flags and {scene: model dir}."""
    import torch

    from gaussian_transformer_tpu_torch.config import save_cfg_args
    from gaussian_transformer_tpu_torch.convert import scene_from_numpy
    from gaussian_transformer_tpu_torch.render import render
    from gaussian_transformer_tpu_torch.tools.synthetic import write_colmap_binary

    scenes = scenes or FULL_EVAL_SCENES
    where = {"mipnerf360_outdoor_scenes": ("m360", "images_4"), "mipnerf360_indoor_scenes": ("m360", "images_2"),
             "tanks_and_temples_scenes": ("tat", "images"), "deep_blending_scenes": ("db", "images")}
    fovx = math.radians(50.0)
    models = {}
    for k, (lst, names) in enumerate(sorted(scenes.items())):
        for name in names:
            base, images = where[lst]
            src, model = root / base / name, root / "eval" / name
            fields = synthetic_scene(gaussians, seed + k)
            scene = scene_from_numpy(fields, 3, device)
            rng = np.random.RandomState(seed + k)
            shots = []
            for i in range(views):
                c2w = orbit_c2w(2 * math.pi * i / views + 0.1 * k)
                with torch.no_grad():
                    img = render(camera_from_c2w(c2w, fovx, width, height, device), scene)["render"]
                noisy = np.clip(img.cpu().numpy().transpose(1, 2, 0) + rng.normal(0, 0.05, (height, width, 3)), 0, 1)
                shots.append((c2w, (noisy * 255).astype(np.uint8)))
            xyz, rgb = surface_points(2000, seed + k)
            write_colmap_binary(src, shots, width, height, fovx, xyz, rgb, images=images, seed=seed + k)
            for it in (7000, 30000):
                scene.save_ply(str(model / "point_cloud" / f"iteration_{it}" / "point_cloud.ply"))
            save_cfg_args(str(model), Namespace(sh_degree=3, source_path=str(src), model_path=str(model),
                                                images=images, resolution=1, white_background=False,
                                                data_device="cuda", eval=True))
            models[name] = model
    flags = ["-m360", str(root / "m360"), "-tat", str(root / "tat"), "-db", str(root / "db"),
             "--output_path", str(root / "eval")]
    return {"flags": flags, "models": models}


def native_io_path(args, device, summary) -> None:
    """Section 33: the native IO tier (built, or why not) held to the Python
    readers on section 6's views and section 2's PLY, a COLMAP folder
    through ``Scene``, and ``cli.full_eval --skip_training``."""
    import shutil

    import torch

    from gaussian_transformer_tpu_torch import native
    from gaussian_transformer_tpu_torch.cli import full_eval
    from gaussian_transformer_tpu_torch.scene import Scene
    from gaussian_transformer_tpu_torch.scene import colmap, ply
    from gaussian_transformer_tpu_torch.tools.synthetic import write_colmap_binary
    from gaussian_transformer_tpu_torch.utils.png import read_png

    on_card = device.type == "cuda"
    smi = smi_line(device)
    work = Path(args.work)
    data = work / "train_data"
    fovx = math.radians(50.0)
    W, H = args.width, args.height

    print("== 33. native IO: the machine's libpng/g++, the tier's build, its readers against the Python ones")
    probe = io_probe()
    print("probe (ls /usr/include/jpeglib.h /usr/include/png.h; ldconfig -p | grep -E 'jpeg|png'; g++ --version):\n"
          + probe)
    _, build_ms = timed(native.build)
    codecs, missing = native.codecs(), native.missing()
    print(f"native tier: available {native.available()} ({native.unavailable_reason() or 'built'}), codecs "
          f"{list(codecs)}, built in {build_ms:.0f} ms; missing: {missing or 'none'}")
    print(f"png.h here: {os.path.exists('/usr/include/png.h')}; the tier decodes PNG with its own decoder "
          f"(native/png.cpp, no libpng)")
    check("png" in codecs, "png: the tier decodes it, with or without png.h")
    check(native.available(), f"the tier's parsers build ({native.unavailable_reason()})")
    summary.update(io_probe=probe, native_codecs=list(codecs), native_missing=missing, native_build_ms=build_ms)

    root = work / "native_io"
    shutil.rmtree(root, ignore_errors=True)
    with open(data / "transforms_train.json") as f:
        frames = json.load(f)["frames"]
    views = [(fr["transform_matrix"], read_png(str(data / f"{fr['file_path']}.png"))[..., :3]) for fr in frames]
    pc = ply.read_ply_vertex_table(str(data / "points3d.ply"))
    xyz = np.stack([pc["x"], pc["y"], pc["z"]], 1).astype(np.float64)
    rgb = np.stack([pc["red"], pc["green"], pc["blue"]], 1)
    write_colmap_binary(root / "colmap", views, W, H, fovx, xyz, rgb)
    times = {}
    sp = root / "colmap" / "sparse" / "0"

    def same(a, b, what):
        ok = all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))
        check(ok, f"{what}: native and Python readers agree bit for bit")

    (n_img, times["images.bin native"]) = timed(lambda: colmap.read_extrinsics_binary(str(sp / "images.bin")))
    (p_img, times["images.bin python"]) = timed(lambda: colmap.read_extrinsics_binary(str(sp / "images.bin"),
                                                                                       native_io=False))
    check(sorted(n_img) == sorted(p_img) and all(n_img[k].name == p_img[k].name and n_img[k].camera_id ==
                                                 p_img[k].camera_id for k in n_img), "images.bin: ids and names")
    same([v for k in sorted(n_img) for v in (n_img[k].qvec, n_img[k].tvec)],
         [v for k in sorted(p_img) for v in (p_img[k].qvec, p_img[k].tvec)], f"images.bin ({len(n_img)} images)")
    (n_pts, times["points3D.bin native"]) = timed(lambda: colmap.read_points3D_binary(str(sp / "points3D.bin")))
    (p_pts, times["points3D.bin python"]) = timed(lambda: colmap.read_points3D_binary(str(sp / "points3D.bin"),
                                                                                       native_io=False))
    same(n_pts, p_pts, f"points3D.bin ({len(xyz)} points)")
    check(np.array_equal(n_pts[0], xyz), "points3D.bin holds the points written")
    big = work / "model" / "point_cloud" / "iteration_30000" / "point_cloud.ply"
    (n_ply, times["PLY read native"]) = timed(lambda: ply.read_ply_vertex_table(str(big)))
    (p_ply, times["PLY read python"]) = timed(lambda: ply.read_ply_vertex_table(str(big), native_io=False))
    check(list(n_ply) == list(p_ply), "the PLY's property names")
    same(list(n_ply.values()), list(p_ply.values()), f"section 2's PLY read ({len(n_ply['x'])} rows, "
                                                     f"{len(n_ply)} properties)")
    table = np.stack(list(p_ply.values()), 1)
    names = list(p_ply)
    del n_ply, p_ply
    _, times["PLY write native"] = timed(lambda: ply.write_ply_vertex_table(str(root / "n.ply"), names, table))
    _, times["PLY write python"] = timed(lambda: ply.write_ply_vertex_table(str(root / "p.ply"), names, table,
                                                                            native_io=False))
    check((root / "n.ply").read_bytes() == (root / "p.ply").read_bytes() == big.read_bytes(),
          "section 2's PLY written by the native and Python writers: the same bytes as the file")
    del table
    pngs = [str(root / "colmap" / "images" / f"{i:03d}.png") for i in range(len(views))]
    p_png, times["PNG decode utils/png.py"] = timed(lambda: {p: read_png(p) for p in pngs})
    n_png, times["PNG decode native"] = timed(lambda: native.decode_folder(pngs))
    same([n_png[p] for p in pngs], [p_png[p] for p in pngs], f"PNG decode ({len(pngs)} views at {W}x{H})")
    print(f"[{smi}] IO times (ms, host clock): " + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    random.seed(args.seed)
    ns = Namespace(sh_degree=3, source_path=str(root / "colmap"), model_path=str(root / "colmap_model"),
                   images="images", resolution=1, white_background=False, eval=False)
    (loaded, times["Scene load (COLMAP, PNGs)"]) = timed(lambda: Scene(ns, sh_degree=3, shuffle=False, device=device))
    cams = {c.image_name: c for c in loaded.get_train_cameras()}
    check(sorted(cams) == [f"{i:03d}" for i in range(len(views))] and all(
        torch.equal(cams[f"{i:03d}"].original_image.cpu(),
                    torch.from_numpy(views[i][1].transpose(2, 0, 1).astype(np.float32) / 255.0))
        for i in range(len(views))), "the COLMAP folder loads through Scene with the PNGs' pixels")
    print(f"Scene load of the COLMAP folder ({len(views)} views at {W}x{H}, {len(xyz)} points): "
          f"{times['Scene load (COLMAP, PNGs)']:.0f} ms")
    del loaded, cams
    summary.update(io_ms=times)

    n_children = sum(len(v) for v in FULL_EVAL_SCENES.values()) * 2 + 1
    print(f"== 33b. cli.full_eval --skip_training over synthetic roots: one scene per list ({FULL_EVAL_GAUSSIANS} "
          f"Gaussians, {FULL_EVAL_VIEWS} views at {FULL_EVAL_W}x{FULL_EVAL_H}, COLMAP binary), {n_children} child "
          f"processes on the {'card' if on_card else 'CPU'}")
    fe = write_full_eval_roots(root / "full_eval", device, FULL_EVAL_SCENES, FULL_EVAL_GAUSSIANS, FULL_EVAL_VIEWS,
                               FULL_EVAL_W, FULL_EVAL_H)
    saved = {k: getattr(full_eval, k) for k in FULL_EVAL_SCENES}
    try:
        for k, v in FULL_EVAL_SCENES.items():
            setattr(full_eval, k, v)
        t0 = time.time()
        ran = full_eval.main(["--skip_training"] + fe["flags"] + ([] if on_card else ["--device", str(device)]))
        t_fe = time.time() - t0
    finally:
        for k, v in saved.items():
            setattr(full_eval, k, v)
    print(f"cli.full_eval: {len(ran)} children in {t_fe:.1f} s, exit codes {[rc for _, rc in ran]}")
    check(len(ran) == n_children and all(rc == 0 for _, rc in ran), "every child exited 0")
    scores = {}
    for name, model in fe["models"].items():
        with open(model / "results.json") as f:
            res = json.load(f)
        for method in ("ours_7000", "ours_30000"):
            ref = numpy_psnr(model, method)
            check(abs(res[method]["PSNR"] - ref) <= 1e-3 and math.isfinite(res[method]["SSIM"]),
                  f"{name} {method}: PSNR {res[method]['PSNR']:.4f} dB == numpy {ref:.4f} dB, SSIM "
                  f"{res[method]['SSIM']:.4f}")
        scores[name] = res
    summary.update(full_eval_s=t_fe, full_eval_scores=scores)


# ---------------------------------------------------------- JPEG scenes ---

JPEG_DIR = ROOT / "gaussian_transformer_tpu_torch" / "native" / "testdata" / "jpeg"
JPEG_ITERATIONS = 300  # section 34's cli.train run on the committed JPEG scene
JPEG_POINTS = 50_000  # its COLMAP model's points3D.bin (surface_points)
JPEG_TIMING_CALLS = 21  # one-thread decodes of the 1080p file (the median is printed)
JPEG_FOLDER_CALLS = 5  # pool decodes of the 8-view folder


def jpeg_path(args, device, summary, iterations=None) -> dict:
    """Section 34: the native IO tier's own JPEG decoder on this machine
    (no libjpeg), every committed JPEG against its digest, the decode
    times, a COLMAP model written around the committed views loaded
    through ``Scene``, and ``cli.train`` on it for ``iterations`` steps
    (default ``JPEG_ITERATIONS``). Returns the run's K1-K4 launches
    ({"train": {...}})."""
    import hashlib
    import statistics

    import torch

    from gaussian_transformer_tpu_torch import native
    from gaussian_transformer_tpu_torch.cli import train as cli_train
    from gaussian_transformer_tpu_torch.render import render
    from gaussian_transformer_tpu_torch.scene import Scene
    from gaussian_transformer_tpu_torch.scene.camera_utils import image_to_array
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
    from gaussian_transformer_tpu_torch.tools.synthetic import write_colmap_binary

    on_card = device.type == "cuda"
    smi = smi_line(device)
    iterations = iterations or JPEG_ITERATIONS
    testdata = JPEG_DIR.parent
    views = json.loads((JPEG_DIR / "views.json").read_text())
    digests = json.loads((JPEG_DIR / "digests.json").read_text())
    W, H, fovx = views["width"], views["height"], views["fovx"]

    print("== 34. JPEG scenes: the tier's own JPEG decoder on this machine, the committed JPEGs against their "
          "digests, decode times, a JPEG COLMAP scene through Scene and cli.train")
    header = os.path.exists("/usr/include/jpeglib.h")
    _, build_ms = timed(native.build)
    codecs, missing = native.codecs(), native.missing()
    print(f"jpeglib.h here: {header}; the tier built in {build_ms:.0f} ms: codecs() {list(codecs)}, "
          f"missing() {missing}")
    check("jpeg" in codecs, "the tier decodes JPEG with its own decoder (no libjpeg)")

    files = {n: testdata / n if n == "fixture.jpg" else JPEG_DIR / n for n in digests}
    decoded = native.decode_folder([str(p) for p in files.values()])
    for name, path in files.items():
        arr = decoded[str(path)]
        got = hashlib.sha256(arr.tobytes()).hexdigest()
        check(got == digests[name], f"{name} ({arr.shape[1]}x{arr.shape[0]}, {path.stat().st_size} B) decodes "
                                    f"to its digest {digests[name][:16]}")
    check(np.array_equal(decoded[str(files["fixture.jpg"])], np.load(testdata / "fixture_rgb.npy")),
          "fixture.jpg decodes to fixture_rgb.npy bit for bit")

    big = JPEG_DIR / views["timing"]["file"]
    bw, bh = native.image_size(str(big))
    native.load_images([str(big)], bw, bh, threads=1)
    one = [timed(lambda: native.load_images([str(big)], bw, bh, threads=1))[1] for _ in range(JPEG_TIMING_CALLS)]
    folder = [str(JPEG_DIR / v["file"]) for v in views["views"]]
    pool = [timed(lambda: native.load_images(folder, W, H))[1] for _ in range(JPEG_FOLDER_CALLS)]
    one_ms, pool_ms = statistics.median(one), statistics.median(pool)
    cpus = os.cpu_count()
    print(f"[{smi}] host CPUs {cpus}: {big.name} ({bw}x{bh}, 4:2:0 q95, {big.stat().st_size} B) on one thread: "
          f"median {one_ms:.3f} ms of {len(one)} calls (min {min(one):.3f}, max {max(one):.3f}), "
          f"{bw * bh / one_ms / 1e3:.2f} MP/s; the {len(folder)}-view folder ({W}x{H}) on the pool ({cpus} "
          f"threads): median {pool_ms:.3f} ms of {len(pool)} calls, {len(folder) / pool_ms * 1e3:.1f} images/s")
    summary.update(jpeg_decode={"cpus": cpus, "smi": smi, "one_thread_ms": one, "one_thread_median_ms": one_ms,
                                "mp_per_s": bw * bh / one_ms / 1e3, "folder_ms": pool, "folder_median_ms": pool_ms,
                                "images_per_s": len(folder) / pool_ms * 1e3})

    root = Path(args.work) / "jpeg_scene"
    shutil.rmtree(root, ignore_errors=True)
    xyz, rgb = surface_points(JPEG_POINTS, args.seed + 16)
    write_colmap_binary(root / "data", [(v["c2w"], JPEG_DIR / v["file"]) for v in views["views"]], W, H, fovx,
                        xyz, rgb, seed=args.seed)
    random.seed(args.seed)
    ns = Namespace(sh_degree=1, source_path=str(root / "data"), model_path=str(root / "load"), images="images",
                   resolution=1, white_background=False, eval=False)
    loaded, load_ms = timed(lambda: Scene(ns, sh_degree=1, shuffle=False, device=device))
    cams = sorted(loaded.get_train_cameras(), key=lambda c: c.image_name)
    check([c.image_name for c in cams] == [Path(v["file"]).stem for v in views["views"]] and all(
        torch.equal(c.original_image.cpu(), torch.from_numpy(image_to_array(decoded[str(JPEG_DIR / v["file"])],
                                                                            (W, H))))
        for c, v in zip(cams, views["views"])),
        f"the JPEG COLMAP folder loads through Scene on the {device.type}: each camera's original_image is "
        f"camera_utils' array of the digest-checked decode")
    print(f"Scene load of the JPEG COLMAP folder ({len(cams)} views at {W}x{H}, {JPEG_POINTS} points): "
          f"{load_ms:.0f} ms")

    def train_psnr(gaussians) -> float:
        with torch.no_grad():
            return float(np.mean([psnr_db(torch.clamp(render(c, gaussians)["render"], 0, 1), c.original_image)
                                  for c in cams]))

    before = train_psnr(loaded.gaussians)
    del loaded
    model = root / "model"
    counters = kernel_counters()
    zero_counts(counters)
    dev_arg = [] if on_card else ["--device", str(device)]
    t0 = time.time()
    res = cli_train.main(["-s", str(root / "data"), "-m", str(model), "-r", "1", "--iterations", str(iterations),
                          "--save_iterations", str(iterations), "--test_iterations", str(iterations),
                          "--quiet"] + dev_arg)
    t_train = time.time() - t0
    launches = read_counts(counters)
    losses = [h["loss"] for h in res["history"]]
    print(f"cli.train on the JPEG scene, {iterations} steps (--eval off): {t_train:.1f} s; launches {launches}; "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    check(len(losses) == iterations and all(math.isfinite(v) for v in losses), "every loss is finite")
    if on_card:
        check(launches["K2"] == iterations and launches["K4"] == iterations and min(launches.values()) > 0,
              f"K1-K4 ran on the JPEG scene, K2 and K4 once per step ({iterations})")
    trained = GaussianScene.load_ply(str(model / "point_cloud" / f"iteration_{iterations}" / "point_cloud.ply"), 1,
                                     device=device)
    after = train_psnr(trained)
    print(f"PSNR on the {len(cams)} training views: {before:.3f} dB before, {after:.3f} dB after {iterations} steps")
    check(after > before, f"training on the JPEG scene raised the PSNR ({before:.3f} -> {after:.3f} dB)")
    summary.update(jpeg_scene={"load_ms": load_ms, "train_s": t_train, "iterations": iterations,
                               "psnr_before": before, "psnr_after": after, "launches": launches,
                               "loss_first": losses[0], "loss_last": losses[-1]})
    return {"train": launches}


# --------------------------------------------------------------- images ---

PNG_DIR = ROOT / "gaussian_transformer_tpu_torch" / "native" / "testdata" / "png"
JPEG_MODES_DIR = ROOT / "gaussian_transformer_tpu_torch" / "native" / "testdata" / "jpeg_modes"
IMAGE_ITERATIONS = 300  # section 35's cli.train run on the committed Blender scene
IMAGE_POINTS = 20_000  # its points3d.ply (surface_points)
IMAGE_TIMING_CALLS = 11  # one-thread tier decodes of the 1080p PNG (the median is printed)
IMAGE_FOLDER_CALLS = 5  # pool decodes of the Blender folder
IMAGE_RESIZE_CALLS = 5  # image_to_array resizes of a 1080p view


def image_path(args, device, summary, iterations=None) -> dict:
    """Section 35: every image the JAX package reads, read alike here: the
    machine's headers, the tier's build with no image library, every
    committed PNG (both outputs) and JPEG mode file against its digest,
    the committed Blender scene through ``Scene`` at ``-r 1`` and ``-r 2``
    against the digests of the JAX reader's composite and Pillow resize,
    ``cli.train`` on it for ``iterations`` steps (default
    ``IMAGE_ITERATIONS``) with ``--eval``, and the decode and resize times.
    Returns the run's K1-K4 launches ({"train": {...}})."""
    import statistics

    import torch

    from gaussian_transformer_tpu_torch import native
    from gaussian_transformer_tpu_torch.cli import train as cli_train
    from gaussian_transformer_tpu_torch.render import render
    from gaussian_transformer_tpu_torch.scene import Scene
    from gaussian_transformer_tpu_torch.scene.camera_utils import image_to_array
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
    from gaussian_transformer_tpu_torch.scene.ply import store_point_cloud
    from gaussian_transformer_tpu_torch.utils import png as pypng

    on_card = device.type == "cuda"
    smi = smi_line(device)
    iterations = iterations or IMAGE_ITERATIONS
    t_section = time.perf_counter()
    print("== 35. every image the JAX package reads: the tier's own PNG and JPEG decoders with no image library, "
          "the committed PNGs and JPEG modes against their digests, a Blender scene through Scene at -r 1 and "
          "-r 2 and cli.train, decode and resize times")
    headers = {h: os.path.exists(f"/usr/include/{h}") for h in ("png.h", "zlib.h", "jpeglib.h")}
    cmd = native.build_command(native.compiler() or "g++", native.library_path())
    print(f"headers here: {headers}; the tier's build: {' '.join(Path(c).name for c in cmd)}")
    check(not any(flag in cmd for flag in ("-lpng", "-lz", "-ljpeg")), "the build links no image library")
    check(list(native.codecs()) == ["jpeg", "png"] and native.missing() == {},
          f"codecs() {list(native.codecs())}: both decoders built in")
    summary.update(image_headers=headers)

    def digest(arr) -> str:
        return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()

    record = json.loads((PNG_DIR / "digests.json").read_text())
    files = {name: str(PNG_DIR / name) for name in record["files"]}
    check(sorted(files) == sorted(str(p.relative_to(PNG_DIR)) for p in PNG_DIR.rglob("*.png")),
          f"digests.json lists every committed PNG ({len(files)})")
    rgb, rgba = native.decode_folder(list(files.values())), native.decode_folder(list(files.values()), rgba=True)
    bad = [n for n, p in files.items()
           if digest(rgb[p]) != record["files"][n]["rgb"] or digest(rgba[p]) != record["files"][n]["rgba"]]
    check(not bad, f"{len(files)} committed PNGs decode to libpng's RGB and Pillow's RGBA digests (off: {bad})")
    modes = json.loads((JPEG_MODES_DIR / "digests.json").read_text())
    got = native.decode_folder([str(JPEG_MODES_DIR / n) for n in modes])
    bad = [n for n in modes if digest(got[str(JPEG_MODES_DIR / n)]) != modes[n]]
    check(not bad, f"{len(modes)} JPEG mode files ({', '.join(sorted(modes))}) decode to libjpeg's digests "
                   f"(off: {bad})")

    root = Path(args.work) / "image_scene"
    shutil.rmtree(root, ignore_errors=True)
    data = root / "data"
    shutil.copytree(PNG_DIR / "blender", data)
    xyz, colours = surface_points(IMAGE_POINTS, args.seed + 35)
    store_point_cloud(str(data / "points3d.ply"), xyz, colours)
    loads = {}
    for r in (1, 2):
        random.seed(args.seed)
        ns = Namespace(sh_degree=1, source_path=str(data), model_path=str(root / f"load_r{r}"), images="images",
                       resolution=r, white_background=False, eval=True)
        loaded, loads[r] = timed(lambda: Scene(ns, sh_degree=1, shuffle=False, device=device))
        want = record["scene"][f"r{r}"]
        cams = [("train", c) for c in loaded.get_train_cameras()] + [("test", c) for c in loaded.get_test_cameras()]
        off = [f"{s}/{c.image_name}" for s, c in cams
               if digest(c.original_image.cpu().numpy()) != want[f"{s}/{c.image_name}"]]
        side = 800 // r
        check(len(cams) == len(want) and not off and all(tuple(c.original_image.shape) == (3, side, side)
                                                         for _, c in cams),
              f"-r {r}: the Blender scene loads through Scene on the {device.type}, {len(cams)} views at "
              f"{side}x{side}, each at the digest of the JAX reader's composite and Pillow resize (off: {off})")
        if r == 1:
            scene_r1, cams_r1 = loaded, [c for s, c in cams if s == "train"]
        del loaded, cams
    print(f"Scene load of the Blender scene (5 views at 800x800, {IMAGE_POINTS} points): -r 1 {loads[1]:.0f} ms, "
          f"-r 2 {loads[2]:.0f} ms")

    def train_psnr(gaussians) -> float:
        with torch.no_grad():
            return float(np.mean([psnr_db(torch.clamp(render(c, gaussians)["render"], 0, 1), c.original_image)
                                  for c in cams_r1]))

    before = train_psnr(scene_r1.gaussians)
    del scene_r1
    model = root / "model"
    counters = kernel_counters()
    zero_counts(counters)
    dev_arg = [] if on_card else ["--device", str(device)]
    t0 = time.time()
    res = cli_train.main(["-s", str(data), "-m", str(model), "-r", "1", "--eval", "--iterations", str(iterations),
                          "--save_iterations", str(iterations), "--test_iterations", str(iterations),
                          "--quiet"] + dev_arg)
    t_train = time.time() - t0
    launches = read_counts(counters)
    losses = [h["loss"] for h in res["history"]]
    print(f"cli.train on the Blender scene, {iterations} steps (--eval): {t_train:.1f} s; launches {launches}; "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    check(len(losses) == iterations and all(math.isfinite(v) for v in losses), "every loss is finite")
    if on_card:
        check(launches["K2"] == iterations and launches["K4"] == iterations and min(launches.values()) > 0,
              f"K1-K4 ran on the Blender scene, K2 and K4 once per step ({iterations})")
    trained = GaussianScene.load_ply(str(model / "point_cloud" / f"iteration_{iterations}" / "point_cloud.ply"), 1,
                                     device=device)
    after = train_psnr(trained)
    print(f"PSNR on the {len(cams_r1)} training views: {before:.3f} dB before, {after:.3f} dB after "
          f"{iterations} steps")
    check(after > before, f"training on the Blender scene raised the PSNR ({before:.3f} -> {after:.3f} dB)")
    del trained, cams_r1

    big = PNG_DIR / "1080p.png"
    bw, bh = native.image_size(str(big))
    native.load_images([str(big)], bw, bh, threads=1)
    one = [timed(lambda: native.load_images([str(big)], bw, bh, threads=1))[1] for _ in range(IMAGE_TIMING_CALLS)]
    py_arr, py_ms = timed(lambda: pypng.read_png_rgb(str(big)))
    check(digest(py_arr) == record["files"]["1080p.png"]["rgb"], "utils/png.py reads the 1080p PNG to its digest")
    folder = [files[n] for n in record["files"] if n.startswith("blender/")]
    pool = [timed(lambda: native.load_images(folder, 800, 800, rgba=True))[1] for _ in range(IMAGE_FOLDER_CALLS)]
    view = rgb[files["1080p.png"]]
    resize = [timed(lambda: image_to_array(view, (bw // 2, bh // 2)))[1] for _ in range(IMAGE_RESIZE_CALLS)]
    one_ms, pool_ms, resize_ms = statistics.median(one), statistics.median(pool), statistics.median(resize)
    cpus = os.cpu_count()
    print(f"[{smi}] host CPUs {cpus}: 1080p.png ({bw}x{bh} RGB, libpng's adaptive filters, {big.stat().st_size} B) "
          f"on one thread: tier median {one_ms:.3f} ms of {len(one)} calls (min {min(one):.3f}, max {max(one):.3f}), "
          f"{bw * bh / one_ms / 1e3:.2f} MP/s; utils/png.py {py_ms:.1f} ms (one call); the {len(folder)}-view "
          f"Blender folder (800x800 RGBA) on the pool: median {pool_ms:.3f} ms of {len(pool)} calls, "
          f"{len(folder) / pool_ms * 1e3:.1f} images/s; image_to_array's resize of the 1080p view to "
          f"{bw // 2}x{bh // 2}: median {resize_ms:.1f} ms of {len(resize)} calls")
    section_s = time.perf_counter() - t_section
    print(f"section 35: {section_s:.1f} s")
    summary.update(image_path={"cpus": cpus, "smi": smi, "png_one_thread_ms": one, "png_one_thread_median_ms": one_ms,
                               "png_mp_per_s": bw * bh / one_ms / 1e3, "png_python_ms": py_ms,
                               "folder_ms": pool, "folder_median_ms": pool_ms,
                               "images_per_s": len(folder) / pool_ms * 1e3, "resize_ms": resize,
                               "resize_median_ms": resize_ms, "scene_load_ms": loads, "train_s": t_train,
                               "iterations": iterations, "psnr_before": before, "psnr_after": after,
                               "launches": launches, "section_s": section_s})
    return {"train": launches}


# -------------------------------------------------------------- convert ---

CONVERT_DIR = ROOT / "gaussian_transformer_tpu_torch" / "native" / "testdata" / "convert"
CONVERT_ITERATIONS = 300  # section 36's cli.train run on the converted images_2
CONVERT_POINTS = 50_000  # the stand-in's points3D.bin (surface_points)
CONVERT_TIMING_CALLS = 5  # one-thread pyramids of 1080p.jpg (the median is printed)

# A stand-in for the colmap binary: written into a work directory by
# section 36 and the convert tests, never part of the package. It records
# its arguments (one JSON list a line in calls.jsonl beside it), exits with
# STANDIN_COLMAP_FAIL's code at the stage it names ("<stage>:<code>"), and
# leaves what each COLMAP stage leaves: the database, distorted/sparse/0,
# and for image_undistorter input/ copied to images/ and the PINHOLE model
# in <output>/sparse/ (COLMAP's undistorter's layout).
STANDIN_COLMAP = '''#!{python}
"""Stand-in colmap (not COLMAP): records its arguments, writes its outputs."""
import json, os, shutil, sys

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = {model!r}
with open(os.path.join(HERE, "calls.jsonl"), "a") as f:
    f.write(json.dumps(["colmap"] + sys.argv[1:]) + "\\n")
stage, opts, args = sys.argv[1], {{}}, sys.argv[2:]
while args:
    key = args.pop(0)
    if "=" in key:
        key, value = key.split("=", 1)
    else:
        value = args.pop(0) if args else ""
    opts[key] = value
fail = os.environ.get("STANDIN_COLMAP_FAIL", "")
if fail.split(":")[0] == stage:
    sys.exit(int(fail.split(":")[1]))


def model_into(out):
    os.makedirs(out, exist_ok=True)
    for name in sorted(os.listdir(MODEL)) if MODEL else []:
        shutil.copyfile(os.path.join(MODEL, name), os.path.join(out, name))


if stage == "feature_extractor":
    open(opts["--database_path"], "wb").close()
elif stage == "mapper":
    model_into(os.path.join(opts["--output_path"], "0"))
elif stage == "image_undistorter":
    out = opts["--output_path"]
    shutil.copytree(opts["--image_path"], os.path.join(out, "images"), dirs_exist_ok=True)
    model_into(os.path.join(out, "sparse"))
'''

# A stand-in for ImageMagick's magick: records its arguments beside it,
# exits with STANDIN_MAGICK_FAIL's code ("<percent>:<code>") on that resize,
# and leaves the file as it is.
STANDIN_MAGICK = '''#!{python}
"""Stand-in magick (not ImageMagick): records its arguments."""
import json, os, sys

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "calls.jsonl"), "a") as f:
    f.write(json.dumps(["magick"] + sys.argv[1:]) + "\\n")
fail = os.environ.get("STANDIN_MAGICK_FAIL", "")
if fail and fail.split(":")[0] in sys.argv:
    sys.exit(int(fail.split(":")[1]))
'''


def write_standin(directory, name: str, model=None) -> Path:
    """The stand-in ``colmap`` or ``magick`` as an executable script in
    ``directory`` (``model``: the colmap stand-in's model directory)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / name
    text = STANDIN_COLMAP if name == "colmap" else STANDIN_MAGICK
    path.write_text(text.format(python=sys.executable, model=None if model is None else str(model)))
    path.chmod(0o755)
    return path


def standin_calls(directory) -> list:
    """The argument lists the stand-ins in ``directory`` recorded, in order."""
    log = Path(directory) / "calls.jsonl"
    return [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []


def expected_calls(sp, camera: str = "OPENCV", gpu: int = 1, skip_matching: bool = False) -> list:
    """The colmap argument lists the root ``convert.py`` issues for ``sp``."""
    db = f"{sp}/distorted/database.db"
    calls = [] if skip_matching else [
        ["colmap", "feature_extractor", "--database_path", db, "--image_path", f"{sp}/input",
         "--ImageReader.single_camera", "1", "--ImageReader.camera_model", camera,
         "--SiftExtraction.use_gpu", str(gpu)],
        ["colmap", "exhaustive_matcher", "--database_path", db, "--SiftMatching.use_gpu", str(gpu)],
        ["colmap", "mapper", "--database_path", db, "--image_path", f"{sp}/input", "--output_path",
         f"{sp}/distorted/sparse", "--Mapper.ba_global_function_tolerance=0.000001"],
    ]
    return calls + [["colmap", "image_undistorter", "--image_path", f"{sp}/input", "--input_path",
                     f"{sp}/distorted/sparse/0", "--output_path", str(sp), "--output_type", "COLMAP"]]


def png_header(blob: bytes) -> bytes:
    """IHDR, PLTE and tRNS of a PNG (type and data of each, in that order)."""
    found, pos = {}, 8
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos: pos + 4])
        kind = blob[pos + 4: pos + 8]
        found.setdefault(kind, blob[pos + 8: pos + 8 + n])
        pos += 12 + n
    return b"".join(k + found[k] for k in (b"IHDR", b"PLTE", b"tRNS") if k in found)


def pyramid_digest(path) -> str:
    """A JPEG's sha256; a PNG's over its IHDR, PLTE, tRNS and decoded
    samples (big-endian at 16 bits), which Pillow's and the port's files
    share (their IDATs differ with the deflate)."""
    from gaussian_transformer_tpu_torch import native

    blob = Path(path).read_bytes()
    if not blob.startswith(b"\x89PNG"):
        return hashlib.sha256(blob).hexdigest()
    _, samples = native.image_samples(str(path))
    return hashlib.sha256(png_header(blob) + samples.astype(samples.dtype.newbyteorder(">")).tobytes()).hexdigest()


def pyramid_digests(sp) -> dict:
    """{"images_N/<file>": pyramid_digest} of a converted capture."""
    sp = Path(sp)
    return {f"{sub}/{p.name}": pyramid_digest(p) for sub in ("images_2", "images_4", "images_8")
            for p in sorted((sp / sub).iterdir())}


def write_captures(work, seed: int) -> dict:
    """Section 36's two captures under ``work``, as a user's capture folders
    look before ``convert.py``: {"colmap": (folder, its stand-in's model
    dir), "resize": (folder, None)}. The colmap capture's input/ holds the 8
    committed 960x540 views (a PINHOLE model written around them with
    ``surface_points`` is what the stand-in returns), the resize-only
    capture's ``1080p.jpg``, ``1080p.png`` and the PNG mode files."""
    from gaussian_transformer_tpu_torch.tools.synthetic import write_colmap_binary

    work = Path(work)
    shutil.rmtree(work, ignore_errors=True)
    views = json.loads((JPEG_DIR / "views.json").read_text())
    xyz, rgb = surface_points(CONVERT_POINTS, seed + 16)
    write_colmap_binary(work / "model", [(v["c2w"], JPEG_DIR / v["file"]) for v in views["views"]],
                        views["width"], views["height"], views["fovx"], xyz, rgb, images="input", seed=seed)
    shutil.copytree(work / "model" / "input", work / "colmap" / "input")
    (work / "resize" / "input").mkdir(parents=True)
    for src in [JPEG_DIR / "1080p.jpg", PNG_DIR / "1080p.png"] + sorted((PNG_DIR / "modes").glob("*.png")):
        shutil.copyfile(src, work / "resize" / "input" / src.name)
    return {"colmap": (work / "colmap", work / "model" / "sparse" / "0"), "resize": (work / "resize", None)}


def convert_captures(captures, record, work: Path):
    """``cli.convert --resize`` on each capture of ``write_captures``
    through the stand-in colmap, its commands, pyramid digests and
    ``sparse/0`` checked: ({capture: ms}, {capture: source images})."""
    from gaussian_transformer_tpu_torch.cli import convert as cli_convert

    # No --magick_executable: the user's call. Where a magick is installed,
    # a path that does not exist keeps the pyramid on the port's writer.
    no_magick = [] if shutil.which("magick") is None else ["--magick_executable", str(work / "no-magick")]
    runs = {"colmap": [], "resize": ["--skip_matching"]}
    times, n_src = {}, {}
    for name, extra in runs.items():
        sp, model = captures[name]
        standin = write_standin(work / f"bin_{name}", "colmap", model)
        argv = ["-s", str(sp), "--colmap_executable", str(standin), "--resize"] + extra + no_magick
        code, times[name] = timed(lambda: cli_convert.main(argv))
        check(code == 0, f"cli.convert {' '.join(extra + ['--resize'])} on the {name} capture exits 0")
        calls = standin_calls(standin.parent)
        want = expected_calls(sp, skip_matching=bool(extra))
        check(calls == want, f"the {name} capture: the stand-in recorded the root script's {len(want)} colmap "
                             f"commands, in order ({[c[1] for c in calls]})")
        n_src[name] = len(os.listdir(sp / "images"))
        got, digests = pyramid_digests(sp), record[name]
        off = sorted(k for k in set(got) | set(digests) if got.get(k) != digests.get(k))
        check(not off, f"the {name} capture: {len(got)} pyramid files ({n_src[name]} images x 3) equal the root "
                       f"script's Pillow output by their digests (off: {off[:5]})")
        if model is not None:
            check(sorted(os.listdir(sp / "sparse" / "0")) == sorted(os.listdir(model)) and all(
                (sp / "sparse" / "0" / f).read_bytes() == (model / f).read_bytes() for f in os.listdir(model)),
                f"the {name} capture: sparse/* moved into sparse/0, the undistorter's model byte for byte")
    return times, n_src


def convert_path(args, device, summary, iterations=None) -> dict:
    """Section 36: ``cli.convert`` on the two captures of ``write_captures``
    through the stand-in colmap, every pyramid file against the root
    script's digests, the conversion's times, and ``cli.train -i images_2
    --eval`` on the colmap capture for ``iterations`` steps (default
    ``CONVERT_ITERATIONS``) with ``cli.render`` and ``cli.metrics``.
    Returns the K1-K4 launches of that chain ({"train": {...}})."""
    import statistics

    import torch

    from gaussian_transformer_tpu_torch import native
    from gaussian_transformer_tpu_torch.cli import convert as cli_convert
    from gaussian_transformer_tpu_torch.cli import metrics as cli_metrics
    from gaussian_transformer_tpu_torch.cli import render as cli_render
    from gaussian_transformer_tpu_torch.cli import train as cli_train
    from gaussian_transformer_tpu_torch.render import render
    from gaussian_transformer_tpu_torch.scene import Scene
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
    from gaussian_transformer_tpu_torch.utils import imagefile

    on_card = device.type == "cuda"
    smi = smi_line(device)
    iterations = iterations or CONVERT_ITERATIONS
    t_section = time.perf_counter()
    print("== 36. the COLMAP conversion driver: cli.convert through a stand-in colmap (a script of this run, not "
          "COLMAP) with the images_2/4/8 pyramid written as Pillow writes it, with Pillow's import blocked and no "
          "ImageMagick; "
          "cli.train -i images_2 --eval, cli.render, cli.metrics")
    import importlib.util

    tools = {t: shutil.which(t) is not None for t in ("colmap", "magick")}
    tools["Pillow"] = importlib.util.find_spec("PIL") is not None  # asked, never imported
    _, build_ms = timed(native.build)
    print(f"[{smi}] on this machine: {tools}; the tier built from the checkout's sources in {build_ms:.0f} ms: "
          f"{native.available()} ({native.unavailable_reason() or 'with its JPEG encoder'})")
    check(native.available(), "the native IO tier is built (the pyramid needs it without ImageMagick)")
    record = json.loads((CONVERT_DIR / "digests.json").read_text())
    work = Path(args.work) / "convert"
    captures = write_captures(work, args.seed)
    # Pillow's import fails while the captures convert: the pyramid cannot
    # come from it, here or in a module the converter loads.
    pil = {m: sys.modules.pop(m) for m in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]}
    sys.modules["PIL"] = None
    try:
        times, n_src = convert_captures(captures, record, work)
    finally:
        del sys.modules["PIL"]
        sys.modules.update(pil)
    n_img = sum(n_src.values())
    conv_s = sum(times.values()) / 1e3
    print(f"[{smi}] host CPUs {os.cpu_count()}: cli.convert --resize: the colmap capture ({n_src['colmap']} views "
          f"960x540 JPEG) {times['colmap']:.1f} ms, the resize-only capture ({n_src['resize']} files) "
          f"{times['resize']:.1f} ms; {n_img / conv_s:.2f} images/s ({3 * n_img / conv_s:.1f} pyramid files/s) on "
          f"{os.cpu_count()} threads")

    big = str(captures["resize"][0] / "images" / "1080p.jpg")
    scratch = work / "timing"
    scratch.mkdir()
    dsts = [(str(scratch / f"{sub}.jpg"), pct) for sub, pct, _ in cli_convert.PYRAMID]

    def pyramid():  # one file of cli.convert's resize_folder: read, resize, encode, write
        done, error = cli_convert.shrink(big, dsts)
        if error is not None:
            raise error
        for dst, data in done:
            Path(dst).write_bytes(data)

    pyramid()
    one = [timed(pyramid)[1] for _ in range(CONVERT_TIMING_CALLS)]
    img, open_ms = timed(lambda: imagefile.open_image(big))
    small = {}
    resize_ms = save_ms = 0.0
    for dst, pct in dsts:
        small[dst], ms = timed(lambda: imagefile.resize_image(img, (round(1920 * pct), round(1080 * pct))))
        resize_ms += ms
        save_ms += timed(lambda: imagefile.save_image(small[dst], dst))[1]
    one_ms = statistics.median(one)
    print(f"[{smi}] 1080p.jpg's pyramid (960x540, 480x270, 240x135 JPEGs) on one thread: median {one_ms:.3f} ms "
          f"of {len(one)} calls (min {min(one):.3f}, max {max(one):.3f}); one call by stage: decode "
          f"{open_ms:.3f} ms, 3 resizes {resize_ms:.3f} ms, 3 encodes {save_ms:.3f} ms")

    sp = captures["colmap"][0]
    random.seed(args.seed)
    ns = Namespace(sh_degree=1, source_path=str(sp), model_path=str(work / "load"), images="images_2", resolution=-1,
                   white_background=False, eval=True)
    loaded = Scene(ns, sh_degree=1, shuffle=False, device=device)
    test = loaded.get_test_cameras()
    check(len(test) == 1 and len(loaded.get_train_cameras()) == 7 and all(
        tuple(c.original_image.shape) == (3, 270, 480) for c in test),
        "the converted capture loads through Scene from images_2: 7 training views and 1 test view at 480x270")

    def test_psnr(gaussians) -> float:
        with torch.no_grad():
            return float(np.mean([psnr_db(torch.clamp(render(c, gaussians)["render"], 0, 1), c.original_image)
                                  for c in test]))

    before = test_psnr(loaded.gaussians)
    del loaded
    model = work / "trained"
    counters = kernel_counters()
    zero_counts(counters)
    dev_arg = [] if on_card else ["--device", str(device)]
    t0 = time.time()
    res = cli_train.main(["-s", str(sp), "-m", str(model), "-i", "images_2", "--eval", "--iterations",
                          str(iterations), "--save_iterations", str(iterations), "--test_iterations",
                          str(iterations), "--quiet"] + dev_arg)
    t_train = time.time() - t0
    cli_render.main(["-m", str(model), "--skip_train", "--quiet"] + dev_arg)
    scores = cli_metrics.main(["-m", str(model)] + dev_arg)[str(model)][f"ours_{iterations}"]
    launches = read_counts(counters)
    losses = [h["loss"] for h in res["history"]]
    print(f"[{smi}] cli.train -i images_2 --eval, {iterations} steps: {t_train:.1f} s, loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; with cli.render and cli.metrics, launches {launches}")
    check(len(losses) == iterations and all(math.isfinite(v) for v in losses), "every loss is finite")
    if on_card:
        check(launches["K2"] == iterations and launches["K4"] == iterations and min(launches.values()) > 0,
              f"K1-K4 ran on the converted capture, K2 and K4 once per step ({iterations})")
    trained = GaussianScene.load_ply(str(model / "point_cloud" / f"iteration_{iterations}" / "point_cloud.ply"), 1,
                                     device=device)
    after = test_psnr(trained)
    print(f"[{smi}] PSNR on the test view: {before:.3f} dB before, {after:.3f} dB after {iterations} steps "
          f"(cli.metrics: PSNR {scores['PSNR']:.3f} dB, SSIM {scores['SSIM']:.4f})")
    check(after > before and scores["PSNR"] > before,
          f"training on the converted images_2 raised the test view's PSNR ({before:.3f} -> {after:.3f} dB)")
    section_s = time.perf_counter() - t_section
    print(f"[{smi}] section 36: {section_s:.1f} s")
    summary.update(convert_path={"cpus": os.cpu_count(), "smi": smi, "tools": tools, "build_ms": build_ms,
                                 "convert_ms": times,
                                 "images": n_src, "images_per_s": n_img / conv_s, "pyramid_1080p_ms": one,
                                 "pyramid_1080p_median_ms": one_ms, "decode_ms": open_ms, "resize_ms": resize_ms,
                                 "encode_ms": save_ms, "train_s": t_train, "iterations": iterations,
                                 "psnr_before": before, "psnr_after": after, "metrics": scores,
                                 "launches": launches, "section_s": section_s})
    return {"train": launches}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gaussians", type=int, default=1_000_000)
    parser.add_argument("--views", type=int, default=4)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--train_points", type=int, default=300_000)
    parser.add_argument("--train_views", type=int, default=8)
    parser.add_argument("--iterations", type=int, default=60)
    parser.add_argument("--probe_rows", type=int, default=3_232_768, help="stream rows N of the layout probe")
    parser.add_argument("--work", default=str(ROOT / "build" / "chip_smoke"),
                        help="scratch dir for the model dir (default build/chip_smoke)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "gaussian_transformer_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, {torch.cuda.device_count()} visible")
    print(f"nvidia-smi name, power.limit: {smi_line()}")
    t0 = time.time()
    try:
        # The transformer sections first, the flat ones and the campaign's
        # (no profiler window) before the stacked ones (17 and 16b profile):
        # no profiler window precedes their timings.
        flat_summary, stacked = {}, {}
        flat_launches = flat_path(args, device, flat_summary)
        torch.cuda.empty_cache()
        flat_tier_path(args, device, flat_summary)
        torch.cuda.empty_cache()
        campaign_launches = campaign_path(args, device, stacked)
        torch.cuda.empty_cache()
        launches = stacked_path(args, device, stacked)
        torch.cuda.empty_cache()
        summary = run(args, device)
        summary.update(stacked)
        summary.update(flat_summary)
        add_path_launches(summary["kernels"], "stacked_launches", launches)
        add_path_launches(summary["kernels"], "campaign_launches", campaign_launches)
        add_path_launches(summary["kernels"], "flat_launches",
                          {k: v for k, v in flat_launches.items() if k.startswith("flat")})
        add_path_launches(summary["kernels"], "autoencoder_launches",
                          {k: v for k, v in flat_launches.items() if k.startswith("autoencoder")})
        torch.cuda.empty_cache()
        add_path_launches(summary["kernels"], "gate_launches", gate_path(args, device, summary))
        add_path_launches(summary["kernels"], "jpeg_launches", summary["jpeg_launches"])
        add_path_launches(summary["kernels"], "image_launches", summary["image_launches"])
        add_path_launches(summary["kernels"], "convert_launches", summary["convert_launches"])
        add_path_launches(summary["kernels"], "viewer_launches",
                          {**summary["viewer_launches"], "stacked_stream": summary["stacked_stream_launches"],
                           **summary["stacked_stream_fsdp_launches"]})
        add_path_launches(summary["kernels"], "tier_launches",
                          {**summary["tier_3dgs_launches"], **summary["tier_stacked_launches"],
                           **summary["tier_orbax_launches"], **summary["tier_flat_launches"]})
        trace_path(args, device, summary)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    summary["total_s"] = time.time() - t0
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_summary.json").write_text(json.dumps(summary, indent=1))
    print(f"total {summary['total_s']:.1f} s")
    print(json.dumps({"kernels": summary["kernels"]}))
    print(summary["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
