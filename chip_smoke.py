"""Chip smoke test of the PyTorch/CUDA port (``implicit_depth_torch``) on one
NVIDIA GPU: builds the CUDA kernels, holds each against its plain PyTorch
version at the shapes of its main path, serves synthetic frames through the
port's two-stage ``DepthCompleter`` (in the default per_ray decode mode and
in the ``global`` and dense modes), trains stage 1 for a few steps (in
every ``decode_bwd`` mode: ``kernel_save``, ``kernel``, ``kernel_save_all``
and ``xla``) and stage 2 behind a frozen stage 1, all at the full default
width, cross-checks frames and train steps against the plain CPU path,
serves and resumes from checkpoints, runs the trainer through the CLI
(``implicit_depth_torch.main``) on the user's configs, (phases 33-35)
writes the reference datasets' file layouts with the port's own codecs and
trains, tests and serves from those files, and (phases 36-38) serves and
tests the reference's own checkpoint layout, trains and serves the IMNet
offset decoder and the decoders without positional encoding, and trains
with a checkpointed backbone and with L-BFGS, (phase 39) serves and
trains at per-ray pair budgets other than 8, (phase 40) trains stage 1
in the ``global`` and dense modes, (phase 41) serves and trains at
every width option of the reference (imnet_gf 48 and 128, rgb_out 64,
roi_out_bbox 4, pnet_out 100, pnet_out 512 with multires 10), (phase 42)
at all of them at once, and (phase 43) times and traces a served frame and
a train step with the port's profiling module.

    python3 chip_smoke.py             # every phase; exits 0 only if all pass
    python3 chip_smoke.py --profile   # also torch.profiler tables of a frame
                                      # and of a train step in each
                                      # decode_bwd mode and of a stage-2
                                      # step, with its device time

Phases:
  1. device: a CUDA device must be present; prints name and power limit;
  2. build: nvcc builds csrc/*.cu (into build/idt_torch_kernels/; K3's
     ray_decode_bwd.cu once per decoder width), all at once: seconds to
     each library;
  3. kernels: K1 ray_decode, K4 ief_decode, K5 segment_max0 on the inputs the
     main path gives them (recorded from a warm-up frame), in bf16 and f32:
     max |kernel - plain| against a stated tolerance that lies well below
     the spread of the outputs (the weights are redrawn at unit activation
     scale), and median times of the kernel, its plain version and (K5) the
     library yardstick; for K5 also the bare kernel's device time and the
     yardstick's (torch.profiler, 100 calls) and every device operation a
     call puts on the stream;
  4. main path: 5 frames of 480x640 through DepthCompleter.complete on the
     card (launch counters from 0: K1 1, K4 2, K5 10 per frame), finite output,
     input depth passed through bit for bit; median ms per frame;
  5. cross-check: one frame in f32 on the card (kernels) and on the CPU
     (plain versions), same weights and valid-point draw;
  6. training path: 5 timed Adam steps (after a warm-up step) of the
     default stage-1 model at 240x320, 20,000 rays and 10,000 valid points
     per image, batch 4, bf16 (launch counters from 0: K2 1, K3 1, K5 2 per
     step; K3's Pass A on wgmma, ``ray_decode_bwd.wgmma_launches``, 1 per
     step wherever K3's plan takes the 64-row instance, in phases 10 and 11
     too), finite losses, every parameter moved; median step_ms, peak
     memory;
  7. training kernels, on the inputs the warm-up step gave them (recorded),
     in bf16 and f32, against their plain versions: K2 ray_decode_save's
     outputs and saves; K3 ray_decode_bwd's d_vox_table, d_ray_feat and
     every weight gradient; K5 segment_max0's forward and its gradient
     (exact); times and bounds; K3's passes (device ms of Pass A, Pass B and
     the final reduction from CUDA events the C function records between
     its launches) and its scratch;
  8. training cross-check: one f32 train step on the card and on the CPU
     (a smaller frame), same weights and draws, for three seeds: losses and
     each parameter's gradient; for the first seed also the card with
     cuDNN deterministic and with cuDNN off, logged;
  9. the ``global`` (budget 8) and dense (``pairs_budget_per_ray`` 0) decode
     modes, each: K6 pair_decode against its plain version on the inputs
     recorded from a warm-up frame, in bf16 and f32, with times and bound
     (in ``global`` over the rows below the frame's row count, which K6
     alone decodes: every row past it must be exactly 0 and every row below
     it the bits of the call without the count, whose time and bound are
     logged too); K6's ptxas registers and spills from the build;
     MODE_FRAMES frames of 480x640 served (launch counters from 0: K6 1, K1
     0, K4 2, K5 10 per frame), input depth bit for bit, median ms per
     frame, the valid pairs per frame and the pairs the budget dropped; an
     f32 frame at 120x160 on the card and on the CPU (as phase 5), the
     ``global`` one at budget 1, which must drop pairs;
 10. training with ``decode_bwd: kernel``: TRAIN_STEPS Adam steps as in
     phase 6 (launch counters from 0: K1 1, K3 1, K2 0, K5 2 per step); on
     the recorded inputs, in bf16 and f32, K1 against ``ray_decode_plain``
     at K2's output tolerances and K3's recompute instance against
     ``ray_decode_bwd_plain(saved=None)`` at K3's, with times, passes and
     bounds;
 11. training with ``decode_bwd: kernel_save_all``: TRAIN_STEPS Adam steps
     (launch counters from 0: K2 'all' 1, K3 1, K1 0, K2 0, K5 2 per step);
     on the recorded inputs, in bf16 and f32, K2 'all' against
     ``ray_decode_plain(saves='all')`` (outputs, the f32 offsets and logit
     at K2's output tolerances, every other save within an ulp of its
     largest value, the first offset exact) and K3 from full saves against
     ``ray_decode_bwd_plain(saved=<those saves>)`` at K3's, with times,
     passes, scratch and bounds;
 12. training with ``decode_bwd: xla``: TRAIN_STEPS Adam steps (launch
     counters from 0: K1 1, K2 0, K2 'all' 0, K3 0, K5 2 per step; the
     backward is autograd through the plain decode, as the JAX package's
     'xla' mode is XLA autograd); the step medians of all four
     ``decode_bwd`` modes of this run;
 13. stage-2 training: TRAIN_STEPS Adam steps of the refine network
     (configs/train_refine.yaml's settings: forward_times 2, perturbation
     0.8, lr 1e-3, pos_w 100, surf_norm_w 10) behind the frozen per_ray
     stage 1, batch 4 at 240x320, 20,000 rays and 10,000 valid points per
     image, bf16 (launch counters from 0: K1 1, K4 2, K5 10, K2 0, K3 0, K6
     0 per step), finite losses, every refine parameter moved, every stage-1
     parameter and buffer bit for bit as before; median step_ms, peak
     memory; on the inputs the warm-up step gave K4's training entry and
     the refine network's K5 calls (recorded), in bf16 and f32: K4 against
     ``ief_decode_plain`` (phase 3's tolerances), the training decode's
     gradients (K4 forward, autograd of the plain decode recomputed)
     against autograd of ``ief_decode_plain`` on the same inputs, whether
     they are the same bits, and the backward's time; K5 and its gradient
     exact, as phase 7;
 14. stage 2 with hard negatives (configs/train_refine_hardneg.yaml: ratio
     0.1, pos_w 20, lr 1e-4): HARDNEG_STEPS steps, finite, the same launch
     counts;
 15. the refine eval step on one 240x320 image, every pixel a ray,
     ``use_all_pix`` false, in f32 on the card (K1 1, K4 2, K5 10) and on
     the CPU, same weights and valid points: as phase 5;
 16. one f32 refine step on the card and on the CPU (phase 8's frame),
     same weights and draws, for three seeds: losses and each refine
     parameter's gradient;
 17. checkpoints: phase 13's stage 1 and refine state saved;
     ``DepthCompleter.from_checkpoint`` serves a 480x640 frame bit for bit
     as the in-memory pair; the refine state restored into fresh models
     takes one more step bit for bit as the uninterrupted state does.
 18-22. the trainer, data pipeline and CLI: ``implicit_depth_torch.main``
     on the user's configs (configs/train_lidf.yaml, train_refine.yaml,
     test_lidf.yaml, read by the port's YAML reader) with synthetic data,
     each cut a ``--set`` override, cuDNN deterministic; first the loader's
     host time per sample and per batch of 32;
 18. (A) stage 1 at the config's batch 32, one epoch of 2 steps from
     phase 6's unit-scale weights (a checkpoint the CLI loads): launch
     counters from 0 (K2 1, K3 1 with its Pass A on wgmma, K5 2 per step),
     the trainer's step time (epoch_time_s / steps), peak memory and, with
     ``--profile``, a step's device time; the first step's K2 and K3 calls
     (recorded) against their plain versions computed over chunks of 80,000
     rays, with phase 7's bf16 tolerances, timed, and Pass A and Pass B of
     each K3 instance on them; then 10 steps at batch 4 for the trainer's
     step time beside phase 6's;
 19. (B) stage 1 at batch 4, 2 epochs of 2 steps, a checkpoint every step,
     each epoch validated over 8 synthetic frames: launches per step as
     phase 6, per eval frame K1 1, K5 2; finite losses, 2 epoch records,
     valid_log.txt, latest, epoch000, epoch001 and best checkpoints;
 20. (C) B killed by a raising step after 3 steps; a fresh trainer resumes
     at epoch 1 skipping 1 step and ends with B's parameters and buffers bit
     for bit; a further resume starts at epoch 2 with no skip;
 21. (D) configs/test_lidf.yaml from B's checkpoint: result/synthetic.csv
     (JAX's header, a row per frame, MEAN) equal to cleargrasp_metrics
     recomputed from a fresh trainer's eval outputs; K1 1, K5 2 per frame;
 22. (E) configs/train_refine.yaml behind B's checkpoint, one epoch of 2
     steps at batch 4, validated: per step K1 1, K4 2, K5 10, per eval frame
     as a served frame; the frozen stage 1 bit for bit its checkpoint; a
     480x640 frame from ``DepthCompleter.from_checkpoint`` of both
     checkpoints, input depth bit for bit.
 23-25. data-parallel training across processes: each rank a process of
     ``python -m implicit_depth_torch.main`` with torchrun's variables
     (RANK_LAUNCHER: cuDNN deterministic, no TF32, launches counted, each
     gradient all-reduce timed); rank 0 alone may write files;
 23. stage 1 (configs/train_lidf.yaml, full width, one ResNet block a
     stage: DP_STAGE1_DEPTH; f32) on 2 gloo ranks on this card, global
     batch 4 (2 a rank), one epoch of 2 steps from a unit-scale
     checkpoint, against one process at batch 4: losses
     rtol 1e-3, atol 1e-5; parameters within the bounds of the JAX
     package's two-process test; per rank per step K2 1, K3 1, K5 2; a
     second run of the ranks bit for bit the first;
 24. stage 2 the same way (configs/train_refine_hardneg.yaml, the global
     hard-negative top-k) behind phase 19's checkpoint (full depth: the
     frozen stage 1 takes no gradient): per rank per step K1 1, K4 2, K5
     10;
 25. bf16 stage-1 step time of 2 gloo ranks on this card against one rank
     (an NCCL group of one) at 2 samples a rank, each rank's gradient
     all-reduce time (gloo on one card goes through the host: not what
     NCCL on two cards costs); with 2 or more cards, phases 23-24 again
     under NCCL, one card a rank, else ``nccl_2card: not run``.
 26. the decoders' other widths, imnet_gf 32 (128-64-32-1: the widths of
     configs/smoke_synthetic.yaml and both convergence configs) and 8
     (32-16-8-1: the tiny CLI model), at 120x160: K1 and K4 on the calls of
     a served frame, K6 on those of a ``global`` and a dense frame, K2, K2
     'all' and K3's three instances on those of a training step of batch
     4 in each decode_bwd mode (2,048 rays an image), each against its
     plain version in bf16 and f32 at the tolerances of phases 3, 7 and
     9-11 but the bf16 outputs' (WIDTH_BF16_TOL: the narrower decoders'
     outputs spread less), with the launches of WIDTH_FRAMES frames and
     TRAIN_STEPS steps at that width; K3 twice on each recorded call, the same bits; each
     kernel's row under "at_widths", by its decoder widths;
 27. configs/smoke_synthetic.yaml as it stands (``--set`` only its log
     directory) through the CLI: 2 epochs, validated (launches per step
     K2 1, K3 1, K5 2; per eval frame K1 1, K5 2), finite losses; then
     ``exp_type=test`` from its checkpoint (per eval frame K1 1, K5 2);
 28. the same test with ``tpu.eval_rays_per_chunk`` a quarter of a frame's
     rays: per eval frame K1 4, K5 2; its CSV, and every eval output and
     loss, the bits of the one-shot test's;
 29. configs/convergence_refine.yaml behind 27's checkpoint, cut by
     ``--set`` to one epoch of 2 steps: per step K1 1, K4 2, K5 10, per
     eval frame as a served frame; the frozen stage 1 bit for bit its
     checkpoint.
 30-32. the mesh's rays axis: RAYS_WORLD ranks of a gloo group on this
     card at data 1 x rays 2 (mesh.use_layout; each rank a process of
     RAYS_LAUNCHER, cuDNN deterministic), and DepthCompleter on a grid;
 30. on each rank, bf16 stage-1 and stage-2 steps of the full model
     (phase 6's and phase 13's, a global batch of RAYS_BATCH image at
     240x320, 1,000 of its 2,000 rays a rank: RAYS_GRID_SET): launches
     per rank per step K2 1, K3 1, K5
     2 and K1 1, K4 2, K5 10; the calls each kernel got on the rank's block
     (K2, K3, K5, K1 of the frozen stage 1, K4 with its gradient) against
     their plain versions at phases 3, 7 and 13's tolerances; then one f32
     step (one ResNet block a stage, as phase 23) against one process on
     the same batch: the ranks' loss shares summed within 1e-4, each
     gradient at phase 8's limits;
 31. configs/test_lidf.yaml through the CLI's trainer on those ranks from
     a unit-scale checkpoint: validation and the test CSV, each eval
     frame's 76,800 rays split (K1 once a frame and rank over 38,400 rays,
     K5 2); every eval output and the CSV the bits of one process's, rank
     1 writing nothing;
 32. DepthCompleter(mesh=[[card, card]]) on 480x640 frames in the
     per_ray, global and dense modes: K1 or K6 on a device's block and K4,
     K5 of a recorded frame against their plain versions; per frame K1 or
     K6 2, K4 2, K5 12; the completed depth and the prediction the bits of
     one card's, frame_ms beside one card's. With 2 or more cards, 30-31
     again under NCCL (one card a rank) and 32 on a grid of two cards,
     else ``rays_2card: not run``;
 33-35. the disk datasets, without OpenCV, Pillow or h5py:
 33. tools/make_disk_datasets.py writes a tree at 480x640 (DISK_COUNTS:
     8 train frames a source, 2 val, 2 test): every file reads back (EXR,
     PNG, HDF5, JSON, YAML exact; JPEG at least JPEG_MIN_PSNR from its
     scene), the JPEG decode ms and the loader's ms a sample of
     train_lidf.yaml's mixed train split (240x320, augmented); K2, K3, K5
     of a train step of a batch of the tree's files and K1, K4, K5 of a
     frame served from them against their plain versions (phases 3 and
     7's tolerances, the seeded unit-scale weights);
 34. configs/train_lidf.yaml as it stands (--set: the roots, the log
     directory, one epoch at batch 4: 3 steps, one eval frame a batch),
     validated on the four ClearGrasp splits (per step K2 1, K3 1, K5 2;
     per eval frame K1 1, K5 2) with the trainer's [timing] feed_wait;
     train_refine_hardneg.yaml behind it (2 steps of 6; per step and
     eval frame K1 1, K4 2, K5 10); test_lidf.yaml and test_refine.yaml:
     the CSVs of syn / real x known / novel, each equal to the metrics
     recomputed from a fresh trainer's eval outputs;
 35. tools/complete_depth.py on two real-val frames (a port-written JPEG,
     the depth as a 16-bit PNG in millimetres) from 34's checkpoints: the
     PNG it writes is DepthCompleter.complete's depth bit for bit; per
     frame K1 1, K4 2, K5 10; cv2, PIL and h5py never loaded;
 36-38. the reference's checkpoints and the options of the last slice:
 36. the default model's seeded unit-scale weights written as the
     reference writes its best_network.pth (both stages, its names, the
     ROI columns channel-major, num_batches_tracked, an optimizer entry,
     the epoch and a numpy metric), converted by
     ``python -m implicit_depth_torch.tools.import_torch_ckpt``: every
     tensor the file's; served by DepthCompleter.from_checkpoint in the
     per_ray, global and dense modes (K1 or K6, K4, K5 against their plain
     versions at phases 3 and 9's tolerances; launches per frame as phases
     4 and 9; per_ray also f32 card vs CPU as phase 5, at 120x160);
     test_lidf.yaml (checkpoint_path) and test_refine.yaml
     (lidf_ckpt_path and checkpoint_path) at the imported directories:
     each CSV equal to the metrics recomputed, launches per eval frame as
     phase 21's and phase 4's;
 37. model.offdec_type IMNET, then pos_encode false, in both stages: a
     stage-1 step at batch 4 and 240x320, a stage-2 step behind it, a
     480x640 frame served in each decode mode, K5 alone launched (2 a
     stage-1 step, 10 a stage-2 step or frame); the f32 card results
     against the CPU's (frames at 120x160 in each mode; a stage-1 and a
     stage-2 step, gradients by group at phase 8's limits); step times
     beside the IEF steps of phases 6, 13 and 18;
 38. tpu.remat_backbone: a kernel_save step at batch 4 with and without,
     gradients and running statistics bit for bit (cuDNN deterministic),
     peak memory both ways at batch 4 and 32; L-BFGS: 3 steps (per step
     K2 1, K3 1, K5 2), a checkpoint, a resume whose next step is bit for
     bit, the card's update from the recorded gradients against a float64
     two-loop (LBFGS_F64_RTOL), the step time and the optimizer's memory.
 39. the per-ray pair budgets other than 8: the default model (K = 20) at
     ``pairs_budget_per_ray`` 4, 12 and 16 (BUDGETS): a 480x640 frame
     served (K1 1, K4 2, K5 10 a frame, input depth bit for bit), a bare
     stage-1 step in each decode_bwd mode (launches as phases 6 and
     10-12), a stage-2 step behind the frozen stage 1 (K1 1, K4 2, K5 10),
     each after a step or frame whose K1, K2, K2 'all' and K3 calls are
     recorded and held against their plain versions in bf16 and f32 at
     phases 3, 7, 10 and 11's tolerances, with times and bounds (the
     kernels line's "at_budgets"), K3 twice on each call the same bits; an
     f32 frame card vs CPU at budget 12 (as phase 5, at 120x160); every
     kernel at kb 1 and 64 on calls made from recorded ones (slots of a kb
     4 call; a kb 16 call's slots four times over); then
     configs/train_lidf.yaml at budget 16 through the CLI (one epoch of 2
     steps at batch 4, validated: K2 1, K3 1, K5 2 a step; K1 1, K5 2 an
     eval frame) and configs/test_lidf.yaml from its checkpoint (its CSV).
 40. stage-1 training in the ``global`` (budget 8) and dense modes (K6
     forward, the backward autograd of the plain decode recomputed in
     chunks), each at phase 6's default widths: at batch 4 and at
     train_lidf.yaml's batch 32 a recorded step and PAIR_STEPS counted ones
     (launch counters from 0: K6 1, K5 2, K1-K3 0 a step, the segment sum
     SUMS_PER_CHUNK a chunk of the recompute; host ms, device ms of a
     step, peak memory; the segment sum's calls recorded), K6 against its
     plain version on the
     step's recorded forward call (bf16 and f32 at PAIR_TRAIN_TOL, on at
     most PAIR_CHECK_ROWS of its rows), two steps twice bit for bit
     under cuDNN's deterministic algorithms; at batch 4 the step's
     gradients through K6 against the plain path's (f32 by parameter,
     bf16 by group); an f32 step card vs CPU (as phase 8, one seed); then
     configs/train_lidf.yaml in the mode through the CLI (one epoch of 2
     steps at batch 4, validated: K6 1, K5 2 a step and an eval frame) and
     configs/test_lidf.yaml from its checkpoint (its CSV).
 41. model widths: the default model at each width option of the
     reference (MODEL_WIDTHS: W1 imnet_gf 48, W2 128, W3 rgb_out 64, W4
     roi_out_bbox 4, W5 pnet_out 100, W6 pnet_out 512 with multires 10),
     bf16: a 480x640 frame per_ray (K1, K4, K5 recorded, then a frame
     counted: K1 1, K4 2, K5 10) and ``global`` (K6 1, K4 2, K5 10), a
     bare 240x320 batch-4 step with decode_bwd kernel_save (K2 1, K3 1, K5
     2), kernel (K1 1, K3 1, K5 2) and kernel_save_all (K2 'all' 1, K3 1,
     K5 2), a stage-2 step (K1 1, K4 2, K5 10);
     each recorded call against its plain version at the default
     tolerances, each at least BITE times below the outputs' spread
     (MODEL_WIDTH_CHECKS; K4's call in the stage-2 step recorded, not
     held: the served call holds K4); K3 twice on each call the same bits; two steps twice bit for bit at W2
     and W6. Each kernel's row carries its widths (``at_model_widths``).
 42. the widest widths: phase 41's runs (the dense mode beside
     ``global``) at W7, every width option at its extreme at once
     (WIDEST_WIDTHS: imnet_gf 128, pnet_out 512, multires 10, rgb_out 64,
     roi_out_bbox 4; refine imnet_gf 128, pnet_out 512: kp 640, crp 1056,
     K4's rows 1616, K6's 1696, the chunked bf16 layout, K3's Pass A on
     16 rows), in bf16 and with the model computing in f32, and at W2 in
     f32 (the f32 instances on blocks of 16 rows), each kernel held to its
     plain version in the model's type (width_checks); two W7 bf16 steps
     twice bit for bit. The rows go under ``at_model_widths`` ("W7",
     "W7 f32", "W2 f32").
 43. profiling: implicit_depth_torch/utils/profiling.py on the default
     model, bf16: a served per_ray frame's forward by device_slope_time
     (runs of 2 and 12 forwards, one read-back a run) beside its
     CUDA-event time, complete() by interleaved_slope on the host clock;
     a torch.profiler trace (profiling.trace, Chrome traces under
     build/traces/) of one served frame and of one batch-4 kernel_save
     stage-1 step: each logs its ten longest device operations, its
     device-idle share and its path, and must hold, by CUDA symbol, each
     hand-written kernel its path launched (frame: K1 ray_decode_tc<0>,
     K4 ief_decode_tc, K5 segment_max_kernel; step: K2 ray_decode_tc<1>,
     K3's pass_a_kernel and pass_b_kernel once a chunk and its two
     reduce_kernel, K5) as many times as the launch counters say; each
     trace's idle split by program span (profiling.idle_by_span) must sum
     to its device-idle share times its window, within 1% of the window.
     The frame and the step then run once more with tracing on under
     torch.cuda.set_sync_debug_mode("warn"): every operation that makes
     the host wait for the card must lie in a sync.* span (the frame's
     one read-back in infer.read_back). Each kernel's row carries
     ``profiled``, its launches in each trace.
 44. segment sum: ops/segment.py::segment_sum_ (csrc/segment_sum.cu).
     Each call phase 40 recorded in the global mode's batch-32 step (the
     voxel and the ray table, a whole chunk and the last) replayed onto a
     zero table: the plain version's bits, the same bits twice, the
     index_put_(accumulate=True) it replaced within f32 summation order;
     CUDA-event times of the kernel, the plain version and index_put_, and
     the bound by bytes: the segment_sum_ row of the kernels line. Then
     train.lidf.allpairs.b32's recompute shapes (SUM_ROWS live rows of a
     step in chunks of SUM_CHUNK; f32 rows onto the 23,328 x 128 voxel
     table, one cell taking SUM_BIG rows of the first chunk; bf16 rows
     onto the 640,000 x 155 ray rows): the step's two sorts and its sums
     against the plain version bit for bit and against the same chunks'
     index_put_ within f32 summation order, the same bits twice,
     SUMS_PER_CHUNK launches a chunk; CUDA-event times of the kernel path
     (sorts included), of the index_put_ it replaced and of the plain
     version, and the device time of each operation under torch.profiler
     (the row's ``at_cell_shapes``).
     Then the seconds of phases 2-44, of 33-35, of 36-38, of 39, 40, 41,
     42, 43, 44.
The next-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failure raises: no phase is caught.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

# the checkout this script belongs to: the package, the configs and the
# build directory are found beside it, whatever the working directory
ROOT = pathlib.Path(__file__).resolve().parent
MAIN_FRAMES = 5
FRAME_HW = (480, 640)
SEED = 0
# the full default model; every pixel of a frame is a ray
SERVE_OVERRIDES = {"mask_type": "all"}
EXPECT_PER_FRAME = {"ray_decode": 1, "ief_decode": 2, "segment_max0": 10}
# the global and dense decode modes: K6 in place of K1
MODES = {"global": {"pairs_budget_mode": "global", "pairs_budget_per_ray": 8},
         "dense": {"pairs_budget_per_ray": 0}}
MODE_FRAMES = 3
EXPECT_PER_MODE_FRAME = {"pair_decode": 1, "ray_decode": 0, "ief_decode": 2,
                         "segment_max0": 10}
# a dense f32 decode on the CPU at 240x320 is 1.5 M rows: cross-check the
# modes at a quarter of the pixels
MODE_XCHECK_DATASET = {"img_height": 120, "img_width": 160}
# the served frames hold 2.3-3.4 valid pairs per ray, so budget 8 drops none:
# the global cross-check runs at budget 1, which must drop pairs, so that the
# spill slot and the per-ray competition over `pair_valid & decoded` run on
# the card too
MODE_XCHECK_TPU = {"global": {"pairs_budget_per_ray": 1}, "dense": {}}
# H100 SXM peaks: dense bf16 tensor cores, f32 on the CUDA cores, HBM3
PEAK_TC = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_CUDA_CORES = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain version on the same inputs, with the weights of
# builder.randomize_weights_ (decoder outputs of 0.3-0.6 with a spread of
# 0.05-0.1 at the serving shapes): f32 — the same f32 algebra in another
# summation order (measured ~2e-7 on an H100); bf16 — the summation order
# can move the bf16 rounding of a hidden activation by one ulp (2^-8 of it),
# which moved outputs by up to ~2e-3 on an H100: the tolerance is twice
# that; K5 — a max is exact in any order
TOL = {("ray_decode", torch.float32): 1e-5, ("ray_decode", torch.bfloat16): 4e-3,
       ("pair_decode", torch.float32): 1e-5, ("pair_decode", torch.bfloat16): 4e-3,
       ("ief_decode", torch.float32): 1e-5, ("ief_decode", torch.bfloat16): 4e-3,
       ("segment_max0", torch.float32): 0.0, ("segment_max0", torch.bfloat16): 0.0}
# a tolerance must be this many times smaller than the spread (standard
# deviation) of the outputs it compares, or the comparison could not tell a
# right kernel from one that drops an iteration or a layer
BITE = 10
# cross-check (f32, card kernels vs CPU plain, same weights): a pixel agrees
# when |depth difference| <= 1e-3 m; up to 1% may differ, because a 1e-6
# difference can still move a predicted point across a voxel boundary (the
# refine then pools and decodes another cell) or flip a near-tie slot
XCHECK_ATOL, XCHECK_FRAC = 1e-3, 0.01
# training: the default model and sizes (240x320, 20,000 rays and 10,000
# valid points per image); the configured batch_size 32 is cut to the JAX
# bench's training batch 4 (640,000 decoded pairs per step)
TRAIN_OVERRIDES = {}
TRAIN_BATCH, TRAIN_STEPS = 4, 5
EXPECT_PER_STEP = {"ray_decode_save": 1, "ray_decode_bwd": 1,
                   "segment_max0": 2}
# decode_bwd 'kernel': K1's save-free forward, K3 recomputing layer 1
EXPECT_PER_STEP_KERNEL = {"ray_decode": 1, "ray_decode_save": 0,
                          "ray_decode_bwd": 1, "segment_max0": 2}
# decode_bwd 'kernel_save_all': K2 'all', K3 from its full saves
EXPECT_PER_STEP_SAVE_ALL = {"ray_decode_save_all": 1, "ray_decode_bwd": 1,
                            "ray_decode": 0, "ray_decode_save": 0,
                            "segment_max0": 2}
# decode_bwd 'xla': K1, then autograd through the plain decode (no K3)
EXPECT_PER_STEP_XLA = {"ray_decode": 1, "ray_decode_save": 0,
                       "ray_decode_save_all": 0, "ray_decode_bwd": 0,
                       "segment_max0": 2}
# the training kernels against their plain versions. K2's outputs: f32
# 1e-5 as K1's; bf16 1e-3 (2.5x the 4e-4 measured on an H100 at these
# shapes: the training model's decoder outputs spread less than the served
# ones, std ~0.026, and K1's 4e-3 would not bite); its saves, rounded to
# the compute type from sums taken in another order, may differ by an ulp
# of each value: f32 1e-5, bf16 2^-7 of the largest value. K3 per
# gradient, by the norm of the difference over the norm of the plain
# gradient: f32 1e-4 (one algebra, another order); bf16 2e-2 (the kernel
# rounds each cotangent to bf16 before its product, as the JAX kernel does;
# the plain autograd does not)
TRAIN_TOL = {("ray_decode_save_out", torch.float32): 1e-5,
             ("ray_decode_save_out", torch.bfloat16): 1e-3,
             ("ray_decode_save", torch.float32): 1e-5,
             ("ray_decode_save", torch.bfloat16): 2.0 ** -7,
             ("ray_decode_bwd", torch.float32): 1e-4,
             ("ray_decode_bwd", torch.bfloat16): 2e-2,
             ("ray_decode_bwd_recompute", torch.float32): 1e-4,
             ("ray_decode_bwd_recompute", torch.bfloat16): 2e-2,
             ("ray_decode_bwd_all", torch.float32): 1e-4,
             ("ray_decode_bwd_all", torch.bfloat16): 2e-2}
# train-step cross-check (f32, card vs CPU, same weights and draws, the
# curriculum's labelled slot so that no near-tie picks another slot), per
# seed: the largest relative difference of a loss, and of a parameter's
# gradient in each group. Readings on an H100 for seeds 0/1/2: losses
# 9.9e-7/3.7e-6/7.0e-7; decoders and PointNet (the port's kernels, the K5
# gradient) 5.4e-4/1.2e-3/1.1e-3; ResNet 3.2e-3/1.3e-2/7.3e-3. Summation
# order alone moves them that far: the same card with cuDNN off (PyTorch's
# own convolutions) moved seed 0's ResNet gradients by 3.4e-3 and a decoder
# bias's by 2.5e-3 from its cuDNN run (the backward through 33 convolutions
# and train-mode batch norms amplifies a 1e-5 difference of the feature
# map). Limits: 1e-4, 5e-3 and 4e-2, 3-4x above the largest reading and
# at least 2x above the cuDNN-off distance; a decoder gradient 1% off
# still fails
XCHECK_TRAIN = {"dataset": {"img_height": 120, "img_width": 160},
                "grid": {"miss_sample_num": 2000, "valid_sample_num": 2000},
                "tpu": {"compute_dtype": "float32"}}
XCHECK_SEEDS = (0, 1, 2)
XCHECK_LOSS_RTOL, XCHECK_GRAD_RTOL, XCHECK_RESNET_RTOL = 1e-4, 5e-3, 4e-2
# stage-2 training: the settings of configs/train_refine.yaml that the port
# reads, copied so that the smoke needs no pyyaml
# (tests/test_torch_port_refine_train holds them against the file), the
# default widths, 240x320 at 20,000 rays and 10,000 valid points per image,
# bf16; the configured batch_size 32 cut to 4, as for stage 1
REFINE_OVERRIDES = {"mask_type": "all", "model": {"maxpool_label_epo": 0},
                    "refine": {"forward_times": 2, "perturb": True,
                               "perturb_prob": 0.8,
                               "offset_range": [-0.2, 0.2]},
                    "training": {"batch_size": 32, "nepochs": 30,
                                 "nepoch_decay": 30, "lr": 0.001},
                    "loss": {"pos_w": 100.0, "prob_w": 0,
                             "surf_norm_w": 10.0},
                    "tpu": {"max_pairs_per_ray": 20,
                            "compute_dtype": "bfloat16"}}
# configs/train_refine_hardneg.yaml: hard negatives (ratio 0.1), pos_w 20,
# lr 1e-4
REFINE_HARDNEG_OVERRIDES = {
    **REFINE_OVERRIDES,
    "training": {"batch_size": 32, "nepochs": 30, "lr": 0.0001},
    "loss": {"hard_neg": True, "hard_neg_ratio": 0.1, "pos_w": 20.0,
             "prob_w": 0, "surf_norm_w": 10.0}}
HARDNEG_STEPS = 2
# per stage-2 step: the frozen stage 1's serving K1 (no graph), two refine
# iterations each decoding through K4 and pooling through K5 4 times (2
# parts x 2 pools), stage 1's 2 K5 pools; no stage-1 training kernel
EXPECT_PER_REFINE_STEP = {"ray_decode": 1, "ief_decode": 2,
                          "segment_max0": 10, "ray_decode_save": 0,
                          "ray_decode_save_all": 0, "ray_decode_bwd": 0,
                          "pair_decode": 0}
# the training IEF decode's backward (autograd of the plain decode,
# recomputed) against autograd of the plain decode on the same inputs: the
# same computation, expected bit for bit; held to K3's tolerances
REFINE_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the f32 refine step cross-check (card vs CPU, same weights and draws):
# phase 8's frame and limits (losses 1e-4, decoder and PointNet gradients
# 5e-3)
REFINE_XCHECK = {**REFINE_OVERRIDES, **XCHECK_TRAIN,
                 "tpu": {"max_pairs_per_ray": 20, "compute_dtype": "float32"}}
SOURCES = {"ray_decode": ("implicit_depth_torch/csrc/ray_decode.cu",
                          "implicit_depth_tpu/ops/pallas_ray_decode.py:357"),
           "ray_decode_save": ("implicit_depth_torch/csrc/ray_decode.cu",
                               "implicit_depth_tpu/ops/pallas_ray_decode.py:650"),
           "ray_decode_bwd": ("implicit_depth_torch/csrc/ray_decode_bwd.cu",
                              "implicit_depth_tpu/ops/pallas_ray_decode.py:931"),
           "ray_decode_bwd_recompute": (
               "implicit_depth_torch/csrc/ray_decode_bwd.cu",
               "implicit_depth_tpu/ops/pallas_ray_decode.py:931"),
           # fused_ray_decode_table's forward rule with save_mode='all'
           # (_table_fwd), and _fused_bwd_impl's save_mode == "all" branch
           "ray_decode_save_all": (
               "implicit_depth_torch/csrc/ray_decode.cu",
               "implicit_depth_tpu/ops/pallas_ray_decode.py:650"),
           "ray_decode_bwd_all": (
               "implicit_depth_torch/csrc/ray_decode_bwd.cu",
               "implicit_depth_tpu/ops/pallas_ray_decode.py:931"),
           "pair_decode": ("implicit_depth_torch/csrc/pair_decode.cu",
                           "implicit_depth_tpu/ops/pallas_decode.py:111"),
           "ief_decode": ("implicit_depth_torch/csrc/ief_decode.cu",
                          "implicit_depth_tpu/ops/pallas_ray_decode.py:821"),
           "segment_max0": ("implicit_depth_torch/csrc/segment_max.cu",
                            "implicit_depth_tpu/ops/pallas_segment.py:63"),
           # no TPU kernel: XLA sums the gathered rows' gradients there
           "segment_sum_": ("implicit_depth_torch/csrc/segment_sum.cu",
                            "index_put_(accumulate=True) in "
                            "ops/pair_decode.py::pair_decode_bwd_chunked")}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, warmup=2, reps=10):
    """Median of ``reps`` single-call CUDA-event times after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, match, reps=100):
    """(mean device ms per call of the kernels whose name holds ``match``,
    {device operation: (ms, count) per call}) over ``reps`` calls of ``fn``
    (torch.profiler, after one warm-up call); (None, {}) where the profiler
    sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, ops = 0.0, {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t <= 0 or str(getattr(ev, "device_type", "")).endswith("CPU"):
            continue
        ops[ev.key[:80]] = (t / reps / 1e3, ev.count / reps)
        if match in ev.key:
            total += t
    return (total / reps / 1e3 if total else None), ops


class Checks(NamedTuple):
    """How a phase holds each kernel to its plain version and times it:
    ``dtypes``, the types compared; each tolerance at least BITE times
    below the spread of the outputs it compares (``cap``: a tolerance that
    is not is lowered to that spread over BITE); ``quick``: a time is
    one call after ``warmup`` calls where that call took over
    BUDGET_SLOW_MS, else the median of BUDGET_REPS calls after it
    (otherwise ``time_ms``'s medians); ``profiled``, the types in which
    K3's passes and K5's profiler readings are taken; ``per_output``: a
    forward kernel's outputs each held to the tolerance its own spread
    gives (over the rows decoded), as ``row_checks`` holds K2's, where
    without it their largest error is held to the tolerance of their least
    spread."""
    dtypes: tuple = (torch.bfloat16, torch.float32)
    cap: bool = False
    quick: bool = False
    warmup: int = 0
    profiled: tuple = (torch.bfloat16, torch.float32)
    per_output: bool = False

    def time(self, fn, warmup=2, reps=10):
        if not self.quick:
            return time_ms(fn, warmup, reps)
        once = time_ms(fn, self.warmup, 1)
        return once if once > BUDGET_SLOW_MS else time_ms(fn, 0, BUDGET_REPS)

    def tol(self, tol, spread):
        """``tol``, lowered to ``spread / BITE`` with ``cap``."""
        return min(tol, spread / BITE) if self.cap else tol


# phases 2-38's and 40's checks: bf16 and f32, full timings
CHECKS = Checks()


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def rel_norm(got, ref, floor=0.0):
    """|got - ref| / max(|ref|, floor) over the whole tensor. ``floor``
    serves a gradient that is a sum which cancels, as the gradient of a
    decoder's last bias (the sum of its output's cotangents; the softmax
    cross-entropy's sum to ~0 over each ray's slots): it is then measured
    against the sum of the magnitudes it adds up."""
    got, ref = got.double(), ref.double()
    return ((got - ref).norm() / ref.norm().clamp(min=max(floor, 1e-30))).item()


def decoder_widths(w):
    """(4g, 2g, g) of the stage-1 decoders whose kernel operands are ``w``."""
    return w["b1"].shape[0] // 2, w["off_w2"].shape[1], w["off_w3"].shape[1]


def bound(name, a, dt, n_iter=2, rows=None):
    """(bound_ms, bound_by, flops, bytes) of one call on these inputs (and
    ``n_iter`` IEF iterations): each input read once, each output written
    once, the operations at the peak rate of the units that do them. K6:
    ``rows`` rows decoded (default all), whose cells, rays and positions are
    read; every row's outputs written."""
    if name in ("ray_decode", "ray_decode_save", "ray_decode_save_all"):
        vt, cells, pos, rf, w = a
        n, kb = cells.shape
        c_vox, c_ray, multires = w["dims"]
        g1, g2, g3 = decoder_widths(w)
        tail = g1 * g2 + g2 * g3 + g3
        # per pair: layer 1 over [vox | pos6 | trig] for both decoders, then
        # three tails (2 IEF iterations + the prob decoder); per ray: the
        # [roi | dir_e] part of layer 1
        flops = 2 * (n * kb * ((c_vox + 6 + 12 * multires) * 2 * g1 + 3 * tail)
                     + n * c_ray * 2 * g1)
        byt = nbytes(vt, cells, pos, rf, *w.values()) + 2 * n * kb * 4
        # the saves are written in the compute dtype (the table may be
        # read in f32: the trainer hands K2 the PointNet's f32 features)
        esize = torch.empty((), dtype=dt).element_size()
        if name != "ray_decode":  # e1, z1p, trig written
            byt += n * kb * (2 * g1 + 12 * multires) * esize
        if name == "ray_decode_save_all":
            # and per IEF iteration and the probability decoder h2, h3; the
            # offsets entering each iteration, the final one, the logit (f32)
            byt += n * kb * ((n_iter + 1) * (g2 + g3) * esize
                             + (n_iter + 2) * 4)
        peak = PEAK_TC[dt]
    elif name == "pair_decode":
        vt, cells, pos, rf, w, rays = a
        p = cells.shape[0]
        rows = p if rows is None else rows
        c_vox, c_roi, c_dir, multires = w["dims"]
        c_embed = c_vox + c_roi + 6 * (1 + 2 * multires) + c_dir
        g1, g2, g3 = decoder_widths(w)
        tail = g1 * g2 + g2 * g3 + g3
        # per row decoded: layer 1 of both decoders over the whole embedding
        # (the IEF's once), two IEF tails and the probability tail
        flops = 2 * rows * (c_embed * 2 * g1 + 3 * tail)
        per_row = nbytes(cells, pos, rays) / max(p, 1)
        byt = nbytes(vt, rf, *w.values()) + rows * per_row + 2 * p * 4
        peak = PEAK_TC[dt]
    elif name in ("ray_decode_bwd", "ray_decode_bwd_recompute",
                  "ray_decode_bwd_all"):
        vt, cells, pos, rf, w, saved, g_off, g_logit = a
        n, kb = cells.shape
        c_vox, c_ray, multires = w["dims"]
        g1, g2, g3 = decoder_widths(w)
        tail = g1 * g2 + g2 * g3 + g3
        c_pair = c_vox + 6 + 12 * multires
        # per pair, from the saved layer-1 pre-activations: the three tails
        # recomputed (2 IEF iterations + the prob decoder) and differentiated
        # (input and weight gradients: 2 products each), layer 1's weight
        # gradient over [vox | pos6 | trig] and d(voxel row), for both
        # decoders; per ray: the [roi | dir_e] weight gradient and d_ray_feat
        flops = 2 * (n * kb * (3 * tail + 3 * 2 * tail + c_pair * 2 * g1
                               + c_vox * 2 * g1)
                     + n * c_ray * 2 * g1 * 2)
        if name == "ray_decode_bwd_all":  # from full saves: no forward tail
            flops -= 2 * n * kb * 3 * tail
        if saved is None:  # recompute: both layer-1 products, per pair and ray
            flops += 2 * (n * kb * c_pair * 2 * g1 + n * c_ray * 2 * g1)
        byt = (nbytes(vt, cells, pos, rf, *w.values(), *(saved or ()), g_off,
                      g_logit)
               + vt.numel() * 4 + n * c_ray * 4          # d_table, d_ray_feat
               + sum(w[k].numel() * 4 for k in w if k != "dims"))
        peak = PEAK_TC[dt]
    elif name == "ief_decode":
        e, rc, p, w = a
        n = e.shape[0]
        g1, g2, g3 = w["w1"].shape[1], w["w2"].shape[1], w["w3"].shape[1]
        flops = 2 * n * ((e.shape[1] + rc.shape[1] + p.shape[1]) * g1
                         + 2 * (g1 * g2 + g2 * g3 + g3))
        byt = nbytes(e, rc, p, *w.values()) + n * 4
        peak = PEAK_TC[dt]
    elif name == "segment_max0_bwd":
        # per element: the tie compare, its count, the share's division and
        # product; reads data, ids, valid, the pooled output and its
        # cotangent, writes d data
        d, ids, ns, v, out, g = a
        flops = 4 * d.numel()
        byt = nbytes(d, ids, v, out, g) + d.numel() * d.element_size()
        peak = PEAK_CUDA_CORES
    else:
        d, ids, ns, v = a
        flops = d.numel()  # one compare per element
        byt = nbytes(d, ids, v) + ns * d.shape[1] * d.element_size()
        peak = PEAK_CUDA_CORES
    t_ops, t_bytes = flops / peak, byt / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, byt)


def build_phase():
    from implicit_depth_torch.ops import cuda
    cuda.build_all()
    log(f"build_s {cuda.build_seconds:.2f}; seconds to each library "
        f"{ {k: round(v, 1) for k, v in cuda.source_seconds.items()} }")
    for line in cuda.build_log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "error")):
            log("  nvcc:", line.strip())


def make_frames(n, hw):
    from implicit_depth_torch.data.synthetic import synthetic_scene_raw
    rng = np.random.default_rng(SEED)
    frames = []
    for _ in range(n):
        s = synthetic_scene_raw(rng, *hw)
        # depth is missing on the transparent object (whose visible part may
        # be empty) and at 5% scattered sensor holes
        missing = s["object_masks"][0] | (rng.random(hw) < 0.05)
        depth = np.where(missing, 0.0, s["depth"]).astype(np.float32)
        frames.append((s["rgb_u8"], depth, (s["fx"], s["fy"], s["cx"], s["cy"])))
    return frames


def kernel_modules():
    """(module, attribute) of each kernel wrapper as the serving paths call
    it."""
    from implicit_depth_torch.models import lidf, pointnet, refine
    return {"ray_decode": (lidf, "ray_decode"), "ief_decode": (refine, "ief_decode"),
            "segment_max0": (pointnet, "segment_max0"),
            "pair_decode": (lidf, "pair_decode")}


def counters():
    """Each kernel wrapper, which counts its launches in ``.launches``."""
    from implicit_depth_torch.ops import ief_decode as ied
    from implicit_depth_torch.ops import pair_decode as pd
    from implicit_depth_torch.ops import ray_decode as rd
    from implicit_depth_torch.ops import segment
    return {"ray_decode": rd.ray_decode, "ray_decode_save": rd.ray_decode_save,
            "ray_decode_save_all": rd.ray_decode_save_all,
            "ray_decode_bwd": rd.ray_decode_bwd, "ief_decode": ied.ief_decode,
            "segment_max0": segment.segment_max0,
            "pair_decode": pd.pair_decode,
            "segment_sum_": segment.segment_sum_}


def counts_of(fn):
    """The names of a wrapper's counters, its integer attributes
    (``launches``; K3's ``wgmma_launches``; the segment sum's ``rows``; the
    recompute's ``rows`` and ``chunks``)."""
    return [k for k, v in vars(fn).items()
            if isinstance(v, int) and not isinstance(v, bool)]


def as_served(name, a):
    """A serving entry's arguments ``a`` with its table (end rows) cast and
    padded as the entry does before either branch
    (``decode_common.rows_operand``): the arguments its kernel and its
    plain version take. Other wrappers' arguments as they are."""
    from implicit_depth_torch.ops import decode_common as common
    from implicit_depth_torch.ops import ief_decode as ied
    from implicit_depth_torch.ops import pair_decode as pd
    from implicit_depth_torch.ops import ray_decode as rd
    fmt, at_w = {"ray_decode": (rd.FORMAT, 4), "pair_decode": (pd.FORMAT, 4),
                 "ief_decode": (ied.FORMAT, 3)}.get(name, (None, 0))
    if fmt is None:
        return a
    return (common.rows_operand(a[0], a[at_w], fmt), *a[1:])


def record_calls(mods, run, when=None, keep=None):
    """``run()`` with each kernel wrapper of ``mods`` ({name: (module,
    attribute)}) replaced by a recorder; returns {(name, shapes): (args,
    kwargs)} of each wrapper's first call per input shape (among the calls
    ``when(args)`` accepts; stored as ``keep(args)`` gives them; a serving
    entry's as its kernel takes them, ``as_served``). The launches
    ``run()`` makes count on the wrappers as without the recorders."""
    recorded = {}
    originals = {name: getattr(m, attr) for name, (m, attr) in mods.items()}

    def recorder(name):
        def call(*a, **kw):
            a = as_served(name, a)
            shape = tuple(tuple(t.shape) for t in a if torch.is_tensor(t))
            if (name, shape) not in recorded and (when is None or when(a)):
                recorded[(name, shape)] = (keep(a) if keep else a, kw)
            return originals[name](*a, **kw)
        # a wrapper that counts through its own module's global name counts
        # on this recorder while it stands in there (each of its counters)
        for k in counts_of(originals[name]):
            setattr(call, k, 0)
        return call

    recorders = {name: recorder(name) for name in mods}
    for name, (m, attr) in mods.items():
        setattr(m, attr, recorders[name])
    try:
        run()
    finally:
        for name, (m, attr) in mods.items():
            setattr(m, attr, originals[name])
            # launches counted on the recorder go to the wrapper's counts
            for k in counts_of(originals[name]):
                setattr(originals[name], k, getattr(originals[name], k) +
                        getattr(recorders[name], k))
    torch.cuda.synchronize()
    return recorded


def k1_f32_operands(lidf):
    """K1's operands from ``lidf``'s decoders in f32 (the f32 twin of a
    recorded bf16 call)."""
    from implicit_depth_torch.models.lidf import decoder_weights
    from implicit_depth_torch.ops import ray_decode as rd
    return rd.prep_ray_decode_weights(
        decoder_weights(lidf.offset_dec, lidf.prob_dec), lidf.dims["c_vox"],
        lidf.dims["c_roi"], lidf.dims["c_dir"], lidf.multires, torch.float32)


@torch.inference_mode()
def kernel_phase(recorded, lidf, refine, dev, tols=TOL, bite=True):
    """Each recorded call of a served frame, kernel vs plain (see
    ``forward_rows``). Returns the row of each kernel at its largest bf16
    shape."""
    from implicit_depth_torch.ops import ief_decode as ied

    f32w_k1 = k1_f32_operands(lidf)
    f32w_k4 = ied.prep_ief_weights(
        refine.offset_dec.decode_weights(), refine.dims["c_end"],
        refine.dims["c_rc"], refine.dims["c_pos"], refine.dims["c_dir"],
        torch.float32)

    def as_f32(name, a):
        """The recorded bf16 call's operands in f32 (weights re-prepared)."""
        if name == "ray_decode":
            vt, cells, pos, rf, _ = a
            return vt.float(), cells, pos, rf.float(), f32w_k1
        if name == "ief_decode":
            e, rc, p, _ = a
            return e.float(), rc.float(), p.float(), f32w_k4
        return segment_as_f32(name, a)

    rows = forward_rows(recorded, as_f32, dev, tols, bite=bite)
    if set(rows) != set(EXPECT_PER_FRAME):
        raise AssertionError(f"kernels measured: {sorted(rows)}")
    return rows


def segment_as_f32(name, a):
    """A recorded K5 call's operands with the data in f32."""
    d, ids, ns, v = a
    return d.detach().float(), ids, ns, v


def forward_rows(recorded, as_f32, dev, tols=TOL, dtypes=None, bite=True,
                 checks=CHECKS, held=True):
    """Each recorded call ({(name, shapes): (args, kwargs)}) in bf16 (as
    recorded) and f32 (``as_f32(name, args)``), or in ``dtypes`` (default
    ``checks.dtypes``): max |kernel - plain| against ``tols``
    (``checks.tol``), which must lie BITE times below the
    outputs' spread (with ``bite``; else the spread is only reported; not
    ``held``: the error and spread are recorded, and only finite outputs
    required); times; bound. Returns the row of each kernel at its largest
    shape in the first of ``dtypes``."""
    from implicit_depth_torch.ops import ief_decode as ied
    from implicit_depth_torch.ops import pair_decode as pd
    from implicit_depth_torch.ops import ray_decode as rd
    from implicit_depth_torch.ops import segment

    dtypes = dtypes or checks.dtypes
    time_ms = checks.time
    mods = kernel_modules()
    by_shape = {}
    plain = {"ray_decode": rd.ray_decode_plain,
             "ief_decode": ied.ief_decode_plain,
             "segment_max0": segment.segment_max0_plain,
             "pair_decode": pd.pair_decode_plain}
    entries = {}
    for (name, shape), (a0, kw) in sorted(recorded.items()):
        kern = getattr(*mods[name])
        for dt in dtypes:
            a = a0 if dt == torch.bfloat16 else as_f32(name, a0)
            got, ref = kern(*a, **kw), plain[name](*a, **kw)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            errs = [(g.float() - r.float()).abs().max().item()
                    for g, r in zip(got, ref)]
            err = max(errs)
            # typical size and least spread of the outputs compared
            typical = max(r.float().abs().mean().item() for r in ref)
            if checks.per_output:
                # each output against its own spread, over the rows decoded
                # (K6's rows past its count are 0 in both)
                live = int(kw["n_rows"].item()) if kw.get(
                    "n_rows") is not None else None
                spreads = [r[:live].float().std().item() for r in ref]
            else:  # every output against the least spread
                spreads = [min(r.float().std().item() for r in ref)] * len(ref)
            spread = min(spreads)
            tol_of = [checks.tol(tols[(name, dt)], sp) for sp in spreads]
            tol = (tol_of if checks.per_output else tol_of[0]) if held \
                else None
            ok = all(torch.isfinite(g).all() for g in got) and (
                not held or all(e <= t for e, t in zip(errs, tol_of)))
            ms = time_ms(lambda: kern(*a, **kw))
            plain_ms = time_ms(lambda: plain[name](*a, **kw))
            lib_ms, extra = None, {}
            rows = None
            if kw.get("n_rows") is not None:  # K6 in the global mode
                rows, extra = count_checks(name, dt, kern, a, kw, got, ms,
                                           checks)
            if name == "segment_max0":  # yardstick: one PyTorch scatter call
                d, ids, ns, v = a
                src = torch.where(v[:, None], d, torch.zeros((), dtype=d.dtype,
                                                             device=dev))
                idx = ids.long()[:, None].expand_as(d)
                # a max into a zero table is idempotent: every repeat does
                # the same work as the first
                table = torch.zeros((ns, d.shape[1]), dtype=d.dtype, device=dev)
                lib_ms = time_ms(lambda: table.scatter_reduce_(0, idx, src,
                                                               "amax"))
                # device times: the bare kernel (of 100 wrapper calls), what
                # else each call puts on the stream, and the yardstick's
                extra["kernel_device_ms"], extra["device_ops_per_call"] = \
                    device_ms(lambda: kern(*a, **kw), "segment_max") \
                    if dt in checks.profiled else (None, None)
                extra["library_device_ms"] = device_ms(
                    lambda: table.scatter_reduce_(0, idx, src, "amax"),
                    "scatter")[0] if dt in checks.profiled else None
            b_ms, b_by, flops, byt = bound(name, a, dt, rows=rows)
            if checks.per_output:
                extra = {"errors": errs, "spreads": spreads, **extra}
            row = {"name": name, "dtype": str(dt).split(".")[-1],
                   "shape": [list(s) for s in shape], "max_abs_err": err,
                   "tolerance": tol, "typical_abs": typical,
                   "spread": spread, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "flops": flops, "bytes": byt, **extra}
            log(f"kernel {name} {row['dtype']} {row['shape']}: "
                f"max_abs_err {err:.3g} "
                f"({f'tol {tol}' if held else 'recorded, not held'}; "
                f"outputs: mean |y| "
                f"{typical:.3g}, std {spread:.3g}) ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} library_ms {lib_ms} "
                f"bound_ms {b_ms:.4f} ({b_by})"
                + "".join(f" {k} {v}" for k, v in extra.items()))
            if not ok:
                raise AssertionError(f"{name} {dt}: kernel disagrees with its "
                                     f"plain version: {err} > {tol}")
            if held and bite and any(BITE * t > sp
                                     for t, sp in zip(tol_of, spreads)):
                raise AssertionError(f"{name} {dt}: tolerance {tol} is not "
                                     f"{BITE}x below the outputs' spread "
                                     f"{spreads}")
            if name == "segment_max0":  # every shape's times, for the record
                by_shape.setdefault(name, []).append(
                    {k: row[k] for k in ("shape", "dtype", "ms", "library_ms",
                                         "kernel_device_ms",
                                         "library_device_ms")})
            # the JSON line carries the main path's dtype at its largest shape
            if dt == dtypes[0]:
                size = shape[0][0] * (shape[0][1] if len(shape[0]) > 1 else 1)
                if name not in entries or size >= entries[name][0]:
                    entries[name] = (size, row)
    rows = {name: row for name, (_, row) in entries.items()}
    for name, shapes in by_shape.items():
        rows[name]["by_shape"] = shapes
    return rows


def count_checks(name, dt, kern, a, kw, got, ms, checks=CHECKS):
    """K6 called with its row count (the global mode's valid prefix): every
    output row at or past the count exactly 0, and the rows below it the
    bits of the same call without the count (which decodes every row).
    Returns (rows decoded, the row's extra entries: rows_decoded, and the
    time and bound of the call without the count)."""
    rows = int(kw["n_rows"].item())
    p = got[0].shape[0]
    kw_all = {k: v for k, v in kw.items() if k != "n_rows"}
    full = kern(*a, **kw_all)
    torch.cuda.synchronize()
    for g, f in zip(got, full):
        if (g[rows:] != 0).any():
            raise AssertionError(f"{name} {dt}: rows at or past n_rows={rows} "
                                 "are not 0")
        if not torch.equal(g[:rows], f[:rows]):
            raise AssertionError(f"{name} {dt}: the rows below n_rows differ "
                                 "from the call without it")
    ms_all = checks.time(lambda: kern(*a, **kw_all))
    b_all = bound(name, a, dt)[0]
    log(f"kernel {name} {str(dt).split('.')[-1]}: {rows} of {p} rows "
        f"decoded: ms {ms:.4f}; every row: ms {ms_all:.4f} bound_ms "
        f"{b_all:.4f}")
    return rows, {"rows_decoded": rows, "rows": p, "ms_all_rows": ms_all,
                  "bound_ms_all_rows": b_all}


def ptxas_of(source, match):
    """{entry function: {registers, spill_stores, spill_loads}} of the
    entries of ``source`` (e.g. "pair_decode.cu") whose mangled name holds
    ``match``, from this process's build log (nvcc -Xptxas -v); {} when the
    kernels were built before this process."""
    from implicit_depth_torch.ops import cuda
    out, entry, section = {}, None, None
    for line in cuda.build_log.splitlines():
        if line.startswith("== "):
            section = line[3:].split()[0]
        elif section != source:
            continue
        elif "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and match in entry and "spill stores" in line:
            f = line.split()
            out.setdefault(entry, {}).update(
                spill_stores=int(f[f.index("spill") - 2]),
                spill_loads=int(f[-4]))
        elif entry and match in entry and "registers" in line:
            f = line.replace(",", " ").split()
            out.setdefault(entry, {})["registers"] = int(f[f.index("registers") - 1])
    return out


def main_path(dc, frames, cfg, expect=EXPECT_PER_FRAME, label="main path"):
    """Serve ``frames`` with the launch counters of ``expect`` from 0;
    returns the launches and the median ms per frame."""
    counts = {k: f for k, f in counters().items() if k in expect}
    for f in counts.values():
        f.launches = 0
    frame_ms = []
    for rgb, depth, intr in frames:
        t0 = time.perf_counter()
        out = dc.complete(rgb, depth, intr)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        assert out["depth"].shape == depth.shape, out["depth"].shape
        assert out["depth_pred"].shape == (cfg.dataset.img_height,
                                           cfg.dataset.img_width)
        assert np.isfinite(out["depth"]).all() and np.isfinite(out["depth_pred"]).all()
        have = depth != 0
        assert have.any() and (~have).any()
        assert out["depth"][have].tobytes() == depth[have].tobytes(), \
            "input depth not passed through bit for bit"
    launches = {k: f.launches for k, f in counts.items()}
    log(f"{label}: {len(frames)} frames {frames[0][1].shape[0]}x"
        f"{frames[0][1].shape[1]}, launches {launches}, "
        f"frame_ms {frame_ms}, median frame_ms {statistics.median(frame_ms)}")
    for k, per in expect.items():
        if launches[k] != per * len(frames):
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{len(frames)} frames, expected "
                                 f"{per} per frame")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, statistics.median(frame_ms)


def cross_check(overrides, lidf_cpu, refine_cpu, frame, dev):
    """One frame in f32 through the same weights on ``dev`` (kernels) and on
    the CPU (plain versions), with the same valid-point draw. Returns the
    frame's (valid pair slots, rays)."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.geometry.sampling import sample_valid_stratified
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.models.lidf import prepare_inputs

    cfg32 = load_config(overrides={**overrides,
                                   "tpu": {**overrides.get("tpu", {}),
                                           "compute_dtype": "float32"}})
    for m in (lidf_cpu, refine_cpu):
        m.dtype = torch.float32
    runs = {}
    for device, lm, rm in ((dev, copy.deepcopy(lidf_cpu),
                            copy.deepcopy(refine_cpu)),
                           ("cpu", lidf_cpu, refine_cpu)):
        c = DepthCompleter(cfg32, lidf=lm, refine=rm, device=device)
        batch = c.device_batch(*([x] for x in frame))
        vidx, _, _ = sample_valid_stratified(
            (batch["depth_corrupt"] != 0).cpu(), lm.static.n_valid,
            torch.Generator().manual_seed(SEED))
        with torch.inference_mode():
            inputs = prepare_inputs(lm.static, batch, valid_idx=vidx)
            out = lm(inputs)
            pred = out["pred_pos"]
            for _ in range(cfg32.refine.forward_times):
                pred = rm(inputs, out, pred)
        runs[str(device)] = (out["max_slot"].cpu(), pred[..., 2].float().cpu())
    (slot_a, z_a), (slot_b, z_b) = runs[str(dev)], runs["cpu"]
    slot_same = (slot_a == slot_b).float().mean().item()
    diff = (z_a - z_b).abs()
    agree = (diff <= XCHECK_ATOL).float().mean().item()
    log(f"cross-check f32 {dev} vs cpu: stage-1 slots equal {slot_same:.6f}, "
        f"depth_pred within {XCHECK_ATOL} m: {agree:.6f}, "
        f"median |diff| {diff.median().item():.3g}, max |diff| "
        f"{diff.max().item():.3g}")
    if agree < 1 - XCHECK_FRAC or slot_same < 1 - XCHECK_FRAC:
        raise AssertionError("cross-check: the card and the CPU disagree")
    valid = inputs["pair_valid"]
    return int(valid.sum().item()), valid.shape[0] * valid.shape[1]


def train_batches(n, cfg, batch, dev, seed=SEED):
    """``n`` seeded synthetic training batches at the config's resolution,
    as device tensors."""
    from implicit_depth_torch.data.synthetic import synthetic_batch
    h, w = cfg.dataset.img_height, cfg.dataset.img_width
    return [{k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(seed + 1 + i, batch, h, w).items()}
            for i in range(n)]


def train_kernel_modules(decode_bwd="kernel_save"):
    """(module, attribute) of each kernel wrapper as a train step calls it:
    the forward K2 (``kernel_save``), K2 'all' (``kernel_save_all``) or K1
    (``kernel``, ``xla``), K3, K5."""
    from implicit_depth_torch.models import pointnet
    from implicit_depth_torch.ops import ray_decode as rd
    fwd = {"kernel_save": "ray_decode_save",
           "kernel_save_all": "ray_decode_save_all"}.get(decode_bwd,
                                                         "ray_decode")
    return {fwd: (rd, fwd), "ray_decode_bwd": (rd, "ray_decode_bwd"),
            "segment_max0": (pointnet, "segment_max0")}


def record_train_calls(step, state, batch, gen, decode_bwd="kernel_save"):
    """One (warm-up) train step; returns {name: (args, kwargs)} of the first
    call of the decode's forward (K2 or K1) and of K3, {(name, shapes):
    (args, kwargs)} of each K5 call under "segment_max0", and under
    "f32_operands" the decode's weight operands in f32 from the weights that
    step saw."""
    from implicit_depth_torch.models.lidf import decoder_weights
    from implicit_depth_torch.ops import ray_decode as rd
    m = state.model
    f32 = rd.prep_ray_decode_weights(
        {k: v.detach().clone() for k, v in
         decoder_weights(m.offset_dec, m.prob_dec).items()},
        m.dims["c_vox"], m.dims["c_roi"], m.dims["c_dir"], m.multires,
        torch.float32)
    losses = {}
    calls = record_calls(train_kernel_modules(decode_bwd),
                         lambda: losses.update(step(state, batch, gen, 0)))
    assert all(torch.isfinite(v) for v in losses.values()), losses
    recorded = {"f32_operands": f32, "segment_max0": {}}
    for (name, shape), (a, kw) in calls.items():
        if name == "segment_max0":  # the step's graph is gone: detach
            recorded[name][(name, shape)] = ((a[0].detach(), *a[1:]), kw)
        else:
            recorded.setdefault(name, (a, kw))
    return recorded


def segment_train_phase(calls, dev):
    """K5 at the shapes a train step gives it ({(name, shapes): (args,
    kwargs)}): the forward against its plain version in bf16 and f32 (as
    ``forward_rows``), and its gradient, taken through the wrapper's
    autograd Function after the kernel's forward, against autograd of
    ``segment_max0_plain`` on the same inputs and a seeded cotangent.
    Both share a segment's cotangent among its tied rows: exact. The
    plain autograd runs on the inputs in f32, since its bf16 run counts
    the ties in bf16, which cannot count past 256. Returns the forward
    row at the largest shape with the backward's rows under "bwd"."""
    from implicit_depth_torch.ops import segment

    with torch.inference_mode():
        row = forward_rows(calls, segment_as_f32, dev)["segment_max0"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    row["bwd"] = {}
    for (_, shape), (a, _) in sorted(calls.items()):
        d0, ids, ns, v = a
        g0 = torch.randn((ns, d0.shape[1]), generator=gen, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            d, g = d0.to(dt), g0.to(dt)
            x = d.clone().requires_grad_()
            out = segment.segment_max0(x, ids, ns, v)
            got, = torch.autograd.grad(out, x, g, retain_graph=True)
            x32 = d.float().requires_grad_()
            ref, = torch.autograd.grad(
                segment.segment_max0_plain(x32, ids, ns, v), x32, g.float())
            ref = ref.to(dt)
            xp = d.clone().requires_grad_()
            yp = segment.segment_max0_plain(xp, ids, ns, v)
            same_dt, = torch.autograd.grad(yp, xp, g, retain_graph=True)
            err = (got.float() - ref.float()).abs().max().item()
            err_dt = (got.float() - same_dt.float()).abs().max().item()
            tie = d == out.detach()[ids.long()]
            if v is not None:
                tie &= v[:, None]
            most = torch.zeros(out.shape, device=dev).index_add_(
                0, ids.long(), tie.float()).max().item()
            ms = time_ms(lambda: torch.autograd.grad(out, x, g,
                                                     retain_graph=True))
            plain_ms = time_ms(lambda: torch.autograd.grad(yp, xp, g,
                                                           retain_graph=True))
            b_ms, b_by, flops, byt = bound("segment_max0_bwd",
                                           (d, ids, ns, v, out, g), dt)
            dtn = str(dt).split(".")[-1]
            log(f"kernel segment_max0 backward {dtn} {list(d.shape)} -> "
                f"{ns} segments: max_abs_err {err:.3g} (tol 0; cotangents "
                f"std {g.float().std().item():.3g}; against the plain "
                f"autograd in {dtn} itself {err_dt:.3g}; most rows tied at "
                f"a segment's maximum in one channel {most:.0f}) ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
            if err != 0.0 or not torch.isfinite(got).all():
                raise AssertionError(f"segment_max0 backward {dt} "
                                     f"{list(d.shape)}: {err} != 0")
            if dtn not in row["bwd"] or \
                    d.numel() >= np.prod(row["bwd"][dtn]["shape"]):
                row["bwd"][dtn] = {"shape": list(d.shape),
                                   "max_abs_err": err, "ms": ms,
                                   "plain_ms": plain_ms, "library_ms": None,
                                   "bound_ms": b_ms, "bound_by": b_by}
    return row


def bwd_checks(name, dt, got, ref, tol, floors):
    """K3's (d_vox_table, d_ray_feat, {operand: gradient}) ``got`` against
    the plain version's ``ref``, each gradient by the relative norm of the
    difference (``rel_norm`` with ``floors``) within ``tol``, logged; raises
    on a miss. Returns ([(what, got, ref)], (worst what, its relative
    error), its max |difference|)."""
    worst, err, failed = ("", 0.0), 0.0, []
    pairs = [("d_vox_table", got[0], ref[0]), ("d_ray_feat", got[1], ref[1])]
    pairs += [(k, got[2][k], ref[2][k]) for k in got[2]]
    for nm, g, r in pairs:
        e = rel_norm(g, r, floors.get(nm, 0.0))
        log(f"kernel {name} {str(dt).split('.')[-1]} {nm}: relative error "
            f"{e:.3g}, max |diff| {(g - r).abs().max().item():.3g}, max "
            f"|ref| {r.abs().max().item():.3g}")
        if not (torch.isfinite(g).all() and e <= tol):
            failed.append(f"{nm}: relative error {e} > {tol}")
        if e >= worst[1]:
            worst, err = (nm, e), (g - r).abs().max().item()
    if failed:
        raise AssertionError(f"{name} {dt}: {failed}")
    return pairs, worst, err


@torch.no_grad()
def train_kernel_phase(recorded, tols=TRAIN_TOL, checks=CHECKS):
    """K2 and K3 at the recorded training shapes, in bf16 (as recorded) and
    f32 (``checks.dtypes``): kernel vs plain, times, bounds. Returns each
    kernel's row in the first of ``checks.dtypes``."""
    from implicit_depth_torch.ops import ray_decode as rd

    w32 = recorded["f32_operands"]
    (vt, cells, pos, rf, w_bf), kw2 = recorded["ray_decode_save"]
    a3, kw3 = recorded["ray_decode_bwd"]
    g_off, g_logit = a3[6], a3[7]
    rows = {}
    for dt in checks.dtypes:
        w = w_bf if dt == torch.bfloat16 else w32
        a2 = (vt.to(dt), cells, pos, rf.to(dt), w)
        # K2: outputs as K1's; saves relative to their largest value
        got, ref = rd.ray_decode_save(*a2, **kw2), \
            rd.ray_decode_plain(*a2, **kw2, saves=True)
        torch.cuda.synchronize()
        tol_out = tols[("ray_decode_save_out", dt)]
        compared = [("offset", got[0], ref[0], tol_out),
                    ("logit", got[1], ref[1], tol_out)]
        for nm, g, r in zip(("e1", "z1p", "trig"), got[2], ref[2]):
            compared.append((nm, g, r, tols[("ray_decode_save", dt)]
                           * r.float().abs().max().item()))
        err2 = row_checks("ray_decode_save", dt, compared, checks)
        saved = got[2]
        # K3: every gradient against autograd of the plain decode started
        # from the same saves, by the relative norm of the difference
        a3 = (*a2, saved, g_off, g_logit)
        k3 = rd.ray_decode_bwd(*a3, **kw3)
        p3 = rd.ray_decode_bwd_plain(*a2[:4], w, g_off, g_logit, **kw3,
                                     dtype=dt, saved=saved)
        torch.cuda.synchronize()
        tol3 = tols[("ray_decode_bwd", dt)]
        floors = {"off_b4": g_off.abs().sum().item(),
                  "prob_b4": g_logit.abs().sum().item()}
        pairs, worst, err3 = bwd_checks("ray_decode_bwd", dt, k3, p3, tol3,
                                        floors)
        # against the exact gradient of the plain decode (not from the
        # saves), for the record: the bf16 saves move it by a few percent
        exact = rd.ray_decode_bwd_plain(*a2[:4], w, g_off, g_logit, **kw3,
                                        dtype=dt)
        drift = max(rel_norm(g, r, floors.get(nm, 0.0)) for (nm, g, _), r in
                    zip(pairs, [exact[0], exact[1],
                                *(exact[2][k] for k in k3[2])]))
        log(f"kernel ray_decode_bwd {str(dt).split('.')[-1]}: worst relative error "
            f"{worst[1]:.3g} ({worst[0]}, tol {tol3}: the plain gradients' "
            f"own spread is 1); max |diff| there {err3:.3g}; from the exact "
            f"gradient of the unsaved decode at most {drift:.3g}")
        for name, args, kw, err, extra in (
                ("ray_decode_save", a2, kw2, err2, {}),
                ("ray_decode_bwd", a3, kw3, err3,
                 {"max_rel_err": worst[1], "worst": worst[0],
                  "tolerance_rel": tol3})):
            if name == "ray_decode_save":
                kern, plain = (lambda: rd.ray_decode_save(*a2, **kw2),
                               lambda: rd.ray_decode_plain(*a2, **kw2,
                                                           saves=True))
            else:
                kern = lambda: rd.ray_decode_bwd(*a3, **kw3)  # noqa: E731
                plain = lambda: rd.ray_decode_bwd_plain(  # noqa: E731
                    *a2[:4], w, g_off, g_logit, **kw3, dtype=dt, saved=saved)
            ms = checks.time(kern, warmup=1, reps=5)
            plain_ms = checks.time(plain, warmup=1, reps=3)
            b_ms, b_by, flops, byt = bound(name, args, dt)
            if name == "ray_decode_bwd" and dt in checks.profiled:
                extra = {**extra, "passes": k3_passes(a3, kw3)}
            row = {"name": name, "dtype": str(dt).split(".")[-1],
                   "shape": [list(cells.shape)], "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                   "bytes": byt, **extra}
            log(f"kernel {name} {row['dtype']} {row['shape']}: ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
            if dt == checks.dtypes[0]:
                rows[name] = row
        del a3, k3, p3, exact, got, ref
        torch.cuda.empty_cache()
    return rows


def k3_wgmma(a, kw):
    """1 where K3's plan for the operands ``a`` (as ``ray_decode_bwd``
    takes them) runs the 64-row wgmma Pass A, else 0: the launches of
    ``ray_decode_bwd.wgmma_launches`` a K3 call on them adds."""
    from implicit_depth_torch.ops import cuda
    from implicit_depth_torch.ops import ray_decode as rd
    cells, w = a[1], a[4]
    n, kb = cells.shape
    plan = rd.bwd_plan(n, w["pair_w1"].shape[0], w["ray_w1"].shape[0],
                       kw.get("n_iter", 2), w["pair_w1"].dtype == torch.bfloat16,
                       cuda.sm_count(cells.device), g=w["b1"].shape[0] // 8,
                       kb=kb, c_vox=w["dims"][0])
    return int(plan["pass_a"] == "wgmma")


def k3_passes(a, kw):
    """K3's passes on the operands ``a`` (as ``ray_decode_bwd`` takes them):
    the device ms of Pass A and of Pass B over all chunks and of the final
    reduction (median of 3 calls after one, from CUDA events the C function
    records between its launches), the plan's scratch bytes, and the peak
    device memory one call adds to what is allocated before it."""
    from implicit_depth_torch.ops import ray_decode as rd
    rd.ray_decode_bwd_pass_ms(*a, **kw)
    runs = [rd.ray_decode_bwd_pass_ms(*a, **kw) for _ in range(3)]
    out = {k: statistics.median(r[k] for r in runs)
           for k in ("pass_a_ms", "pass_b_ms", "reduce_ms")}
    out.update(chunks=runs[0]["chunks"], scratch_bytes=runs[0]["scratch_bytes"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = rd.ray_decode_bwd(*a, **kw)
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    del got
    log(f"kernel ray_decode_bwd passes: {out}")
    return out


def row_checks(name, dt, compared, checks=CHECKS):
    """Each (what, got, ref, tol) of ``compared``: max |got - ref| <= tol
    (``checks.tol``), finite, and tol BITE times below the spread of ref;
    returns the largest error."""
    worst, failed = 0.0, []
    for what, g, r, tol in compared:
        err = (g.float() - r.float()).abs().max().item()
        spread = r.float().std().item()
        tol = checks.tol(tol, spread)
        log(f"kernel {name} {str(dt).split('.')[-1]} {what}: max_abs_err "
            f"{err:.3g} (tol {tol:.3g}; std {spread:.3g})")
        if not (err <= tol and torch.isfinite(g).all()):
            failed.append(f"{what}: {err} > {tol}")
        if BITE * tol > spread:
            failed.append(f"{what}: tolerance {tol} is not {BITE}x below the "
                          f"spread {spread}")
        worst = max(worst, err)
    if failed:
        raise AssertionError(f"{name} {dt}: {failed}")
    return worst


def train_path(cfg, model, dev, profile=False, expect=EXPECT_PER_STEP,
               steps=None):
    """Warm-up step (recording the kernels' inputs), then ``steps``
    (default TRAIN_STEPS) timed steps with the launch counters of
    ``expect`` from 0; returns (recorded, launches, step_ms)."""
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    decode_bwd = cfg.tpu.decode_bwd
    steps = steps or TRAIN_STEPS
    state = TrainState.create(model, cfg.training, steps_per_epoch=1000)
    step = make_lidf_train_step(cfg, model, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = train_batches(steps + 1, cfg, TRAIN_BATCH, dev)
    recorded = record_train_calls(step, state, batches[0], gen, decode_bwd)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    counts = {k: f for k, f in counters().items() if k in expect}
    torch.cuda.reset_peak_memory_stats()
    for f in counts.values():
        f.launches = 0
    from implicit_depth_torch.ops import ray_decode as rd
    wgmma0 = rd.ray_decode_bwd.wgmma_launches
    step_ms, losses = [], []
    for i, b in enumerate(batches[1:]):
        t0 = time.perf_counter()
        out = step(state, b, gen, i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: v.item() for k, v in out.items()})
    launches = {k: f.launches for k, f in counts.items()}
    log(f"training (decode_bwd {decode_bwd}): {steps} steps of batch "
        f"{TRAIN_BATCH} at {cfg.dataset.img_height}x{cfg.dataset.img_width}, "
        f"launches "
        f"{launches}, step_ms {step_ms}, median step_ms "
        f"{statistics.median(step_ms)}")
    log(f"training losses {losses}")
    log(f"training peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k, per in expect.items():
        if launches[k] != per * steps:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{steps} steps, expected {per} each")
    if expect.get("ray_decode_bwd"):
        # K3's Pass A on wgmma wherever its plan takes it (bf16, 64 rows)
        wgmma = rd.ray_decode_bwd.wgmma_launches - wgmma0
        want = launches["ray_decode_bwd"] * k3_wgmma(
            *recorded["ray_decode_bwd"])
        log(f"training (decode_bwd {decode_bwd}): {wgmma} K3 launches with "
            f"the wgmma Pass A in {steps} steps, expected {want}")
        if wgmma != want:
            raise AssertionError(f"K3's wgmma Pass A: {wgmma} launches in "
                                 f"{steps} steps, expected {want}")
    if not all(np.isfinite(v) for ls in losses for v in ls.values()):
        raise AssertionError("training: a loss is not finite")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"training: parameters did not move: {still}")
    if profile:
        profile_device_ms(lambda: step(state, batches[1], gen, 0),
                          f"training (decode_bwd {decode_bwd}): device time "
                          "of one step")
    return recorded, launches, step_ms


def profile_device_ms(fn, label, table=True):
    """One call of ``fn`` under torch.profiler: logs the table (with
    ``table``) and ``label`` with the device time, the table's "Self CUDA
    time total" (the device operations' own entries, user annotations left
    out); returns it in ms."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    if table:
        log(events.table(sort_by="cuda_time_total", row_limit=30))
    device_us = sum(ev.self_device_time_total for ev in events
                    if str(ev.device_type).endswith("CUDA")
                    and not getattr(ev, "is_user_annotation", False))
    log(f"{label} {device_us / 1e3:.3f} ms (the sum of every device "
        "operation's time)")
    return device_us / 1e3


def train_cross_check(dev):
    """For each seed of XCHECK_SEEDS, one f32 train step of the same weights
    on the card (kernels) and on the CPU (plain versions), same valid-point
    and ray-window draws. For the first seed the card also runs the step
    with cuDNN held to deterministic algorithms and with cuDNN off
    (PyTorch's own convolutions): how far those move the ResNet's gradients
    from the card's default run shows how much of its distance to the CPU
    the choice of convolution algorithm makes. Every seed is logged before
    a failure is raised."""
    failed = []
    for seed in XCHECK_SEEDS:
        failed += cross_check_seed(dev, seed, witness=seed == XCHECK_SEEDS[0])
    if failed:
        raise AssertionError(f"train cross-check: the card and the CPU "
                             f"disagree: {failed}")


@contextlib.contextmanager
def cudnn_flags(**flags):
    """``torch.backends.cudnn``'s attributes set to ``flags`` for the
    block (TF32 stays as ``main`` set it: off)."""
    old = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(torch.backends.cudnn, k, v)


def cross_check_seed(dev, seed, witness, mode=None):
    """One seed of ``train_cross_check`` (in the decode ``mode`` of MODES
    when given: phase 40); returns what failed."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.geometry.sampling import (
        sample_masked_window,
        sample_valid_stratified,
    )
    from implicit_depth_torch.models.lidf import decoder_weights
    from implicit_depth_torch.ops import pair_decode as pd
    from implicit_depth_torch.ops import ray_decode as rd
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    cfg = load_config(overrides=XCHECK_TRAIN if mode is None
                      else mode_overrides(XCHECK_TRAIN, mode))
    static = build_static(cfg)
    gen = torch.Generator().manual_seed(seed)
    model = randomize_weights_(build_lidf(cfg, static, gen), gen)
    batch = train_batches(1, cfg, 1, "cpu", seed)[0]
    vidx, _, _ = sample_valid_stratified(batch["valid_mask"] > 0.5,
                                         static.n_valid, gen)
    _, _, _, mstart = sample_masked_window(
        (batch["corrupt_mask"] > 0.5).reshape(1, -1), static.n_rays, gen)
    # the decoders' last biases: their gradients are sums of the decode's
    # cotangents that cancel (see rel_norm), measured against the sum of
    # the cotangents' magnitudes, taken from the card's K3 call (in the
    # global and dense modes, from the recompute's)
    floors = {}
    mod, attr, at = ((rd, "ray_decode_bwd", 6) if mode is None
                     else (pd, "pair_decode_bwd_chunked", 7))
    bwd = getattr(mod, attr)

    def recorder(*a, **kw):
        floors["off_b4"] = a[at].abs().sum().item()
        floors["prob_b4"] = a[at + 1].abs().sum().item()
        return bwd(*a, **kw)

    for k in counts_of(bwd):  # the wrapper counts on its stand-in
        setattr(recorder, k, 0)
    variants = [("card", dev, contextlib.nullcontext()),
                ("cpu", torch.device("cpu"), contextlib.nullcontext())]
    if witness:
        variants += [("card, cuDNN deterministic", dev,
                      cudnn_flags(deterministic=True, benchmark=False)),
                     ("card, cuDNN off", dev, cudnn_flags(enabled=False))]
    runs, last_bias = {}, {}
    for label, device, ctx in variants:
        m = copy.deepcopy(model).to(device)
        state = TrainState.create(m, cfg.training, steps_per_epoch=1000)
        setattr(mod, attr, recorder if label == "card" else bwd)
        try:
            with ctx:
                losses = make_lidf_train_step(cfg, m, device)(
                    state, {k: v.to(device) for k, v in batch.items()}, None,
                    0, valid_idx=vidx, miss_start=mstart)
        finally:
            setattr(mod, attr, bwd)
        names = {id(p): n for n, p in m.named_parameters()}
        last_bias = {names[id(p)]: k for k, p in decoder_weights(
            m.offset_dec, m.prob_dec).items() if k in floors}
        runs[label] = ({k: v.item() for k, v in losses.items()},
                       {n: p.grad.cpu() for n, p in m.named_parameters()})

    def compare(a, b):
        (la, ga), (lb, gb) = runs[a], runs[b]
        loss_err = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-6) for k in lb)
        errs = {n: rel_norm(ga[n], gb[n], floors[last_bias[n]]
                            if n in last_bias else 0.0) for n in gb}
        groups = {}
        for group in ("resnet", "decoders and pnet"):
            errs_g = {n: e for n, e in errs.items()
                      if n.startswith("resnet.") == (group == "resnet")}
            worst = max(errs_g, key=errs_g.get)
            groups[group] = (errs_g[worst], worst,
                             statistics.median(errs_g.values()))
        log(f"train cross-check f32 seed {seed}"
            f"{f' ({mode} mode)' if mode else ''}, {a} vs {b} "
            f"({cfg.dataset.img_height}x{cfg.dataset.img_width}, "
            f"{static.n_rays} rays): largest relative loss difference "
            f"{loss_err:.3g}; gradients, largest relative error (median): "
            + "; ".join(f"{g} {w:.3g} ({n}) ({med:.3g})"
                        for g, (w, n, med) in groups.items()))
        return loss_err, groups

    log(f"train cross-check f32 seed {seed}: losses card {runs['card'][0]} "
        f"cpu {runs['cpu'][0]}")
    loss_err, groups = compare("card", "cpu")
    failed = []
    if loss_err > XCHECK_LOSS_RTOL:
        failed.append(f"seed {seed} losses: {loss_err} > {XCHECK_LOSS_RTOL}")
    for group, tol in (("resnet", XCHECK_RESNET_RTOL),
                       ("decoders and pnet", XCHECK_GRAD_RTOL)):
        if groups[group][0] > tol:
            failed.append(f"seed {seed} {group}: {groups[group][0]} ("
                          f"{groups[group][1]}) > {tol}")
    for label, _, _ in variants[2:]:
        compare(label, "cpu")
        compare(label, "card")
    return failed


def mode_overrides(overrides, mode, **extra):
    """``overrides`` in the decode mode ``mode`` (of MODES)."""
    out = {**overrides, **extra}
    out["tpu"] = {**overrides.get("tpu", {}), **MODES[mode]}
    return out


def build_models(cfg, train=False, seed=SEED):
    """The stage-1 and stage-2 models of ``cfg`` (every pixel a ray, or
    with ``train`` the training rays) with the seeded weights at unit
    activation scale that every serving phase uses."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_refine,
        build_static,
        randomize_weights_,
    )
    static = build_static(cfg) if train else build_static(
        cfg, n_rays=cfg.dataset.img_height * cfg.dataset.img_width)
    gen = torch.Generator().manual_seed(seed)
    lidf = randomize_weights_(build_lidf(cfg, static, gen), gen)
    refine = randomize_weights_(build_refine(cfg, static, gen), gen)
    return lidf, refine


def pair_kernel_rows(recorded, lidf, dev, tols=TOL, checks=CHECKS):
    """K6 on the calls recorded from a served frame (``forward_rows``, with
    the weights re-prepared in f32 for the f32 run)."""
    from implicit_depth_torch.models.lidf import decoder_weights
    from implicit_depth_torch.ops import pair_decode as pd

    f32w = pd.prep_pair_decode_weights(
        decoder_weights(lidf.offset_dec, lidf.prob_dec), lidf.dims["c_vox"],
        lidf.dims["c_roi"], lidf.dims["c_dir"], lidf.multires, torch.float32)

    def as_f32(name, a):
        vt, cells, pos, rf, _, rays = a
        return vt.float(), cells, pos, rf.float(), f32w, rays

    with torch.inference_mode():
        row = forward_rows(recorded, as_f32, dev, tols,
                           checks=checks)["pair_decode"]
    row.setdefault("rows_decoded", row["shape"][1][0])  # cells: every row
    return row


def mode_pairs(dc, frames, budget):
    """(valid pair slots, pairs the global budget dropped) of each frame, from
    the geometry its served run computed (same seed, same valid draw)."""
    from implicit_depth_torch.models.lidf import prepare_inputs
    out = []
    for rgb, depth, intr in frames:
        batch = dc.device_batch([rgb], [depth], [intr])
        gen = torch.Generator(device=dc.device).manual_seed(0)
        with torch.inference_mode():
            valid = prepare_inputs(dc.static, batch, mask_type="all",
                                   generator=gen)["pair_valid"]
        b, r, _ = valid.shape
        n = int(valid.sum().item())
        out.append((n, max(n - b * r * budget, 0) if budget else 0))
    return out


def pair_modes_phase(dev, overrides, frame_hw, profile=False):
    """Phase 9: the global and dense decode modes (see the module doc).
    Returns K6's row (its largest bf16 shape, the dense frame's) with each
    mode's under "modes", and the launches of both modes' runs."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter

    frames = make_frames(MODE_FRAMES + 1, frame_hw)
    rows = {}
    for mode in MODES:
        cfg = load_config(overrides=mode_overrides(overrides, mode))
        lidf, refine = build_models(cfg)
        assert lidf.decode_mode == mode, lidf.decode_mode
        dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
        recorded = record_calls({"pair_decode": kernel_modules()["pair_decode"]},
                                lambda: dc.complete(*frames[0]))
        mode_row = pair_kernel_rows(recorded, lidf, dev)
        launches, frame_ms = main_path(
            dc, frames[1:], cfg, EXPECT_PER_MODE_FRAME, f"{mode} mode")
        if profile:
            mode_row["frame_device_ms"] = profile_device_ms(
                lambda: dc.complete(*frames[1]),
                f"{mode} mode: device time of one frame")
        budget = cfg.tpu.pairs_budget_per_ray if mode == "global" else 0
        pairs = mode_pairs(dc, frames[1:], budget)
        log(f"{mode} mode: valid pairs per frame {[v for v, _ in pairs]}, "
            f"dropped by the budget {[d for _, d in pairs]} (budget "
            f"{budget or 'none'} per ray, {lidf.static.k_pairs} slots)")
        rows[mode] = add_launches(
            {**mode_row, "frame_ms": frame_ms,
             "valid_pairs": [v for v, _ in pairs],
             "dropped_pairs": [d for _, d in pairs]},
            launches["pair_decode"], MODE_FRAMES, "frame")
        del dc, lidf, refine
        torch.cuda.empty_cache()
        # the f32 cross-check, at MODE_XCHECK_DATASET and MODE_XCHECK_TPU
        xo = mode_overrides(overrides, mode, dataset=MODE_XCHECK_DATASET)
        xo["tpu"].update(MODE_XCHECK_TPU[mode])
        xcfg = load_config(overrides=xo)
        n_pairs, n_rays = cross_check(xo, *build_models(xcfg), frames[1], dev)
        if mode == "global":
            budget = xcfg.tpu.pairs_budget_per_ray
            dropped = max(n_pairs - n_rays * budget, 0)
            log(f"global cross-check: {n_pairs} valid pairs, budget {budget} "
                f"per ray over {n_rays} rays dropped {dropped}")
            if dropped == 0:
                raise AssertionError("global cross-check: the budget dropped "
                                     "no pair")
            rows[mode]["xcheck_dropped_pairs"] = dropped
        torch.cuda.empty_cache()
    # the JSON row at the largest shape (the dense frame's), as forward_rows
    row = dict(max(rows.values(), key=lambda r: np.prod(r["shape"][1])))
    row["modes"] = {m: {k: r[k] for k in (
        "shape", "max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms",
        "bound_by", "rows_decoded", "ms_all_rows", "bound_ms_all_rows",
        "frame_ms", "frame_device_ms", "valid_pairs", "dropped_pairs",
        "xcheck_dropped_pairs", "launches", "launches_per_frame") if k in r}
        for m, r in rows.items()}
    # registers and spills of the K6 entries, from this run's build
    row["ptxas"] = ptxas_of("pair_decode.cu", "pair_decode")
    log(f"pair_decode ptxas: {row['ptxas']}")
    row["launches"] = sum(r["launches"] for r in rows.values())
    row["launches_per_frame"] = {m: r["launches_per_frame"]
                                 for m, r in rows.items()}
    return row


@torch.no_grad()
def recompute_kernel_rows(recorded, tols=TRAIN_TOL, checks=CHECKS):
    """Phase 10's kernel check: K3's recompute instance (``saved=None``) on
    the recorded training inputs against ``ray_decode_bwd_plain(saved=None)``
    in bf16 (as recorded) and f32, by the relative norm of each gradient's
    difference; times, bound. Returns its row in the first of
    ``checks.dtypes``."""
    from implicit_depth_torch.ops import ray_decode as rd

    w32 = recorded["f32_operands"]
    (vt, cells, pos, rf, w_bf, saved, g_off, g_logit), kw = \
        recorded["ray_decode_bwd"]
    assert saved is None
    floors = {"off_b4": g_off.abs().sum().item(),
              "prob_b4": g_logit.abs().sum().item()}
    out = None
    for dt in checks.dtypes:
        w = w_bf if dt == torch.bfloat16 else w32
        a = (vt.to(dt), cells, pos, rf.to(dt), w, None, g_off, g_logit)
        got = rd.ray_decode_bwd(*a, **kw)
        ref = rd.ray_decode_bwd_plain(*a[:5], g_off, g_logit, **kw, dtype=dt,
                                      saved=None)
        torch.cuda.synchronize()
        tol = tols[("ray_decode_bwd_recompute", dt)]
        dtn = str(dt).split(".")[-1]
        _, worst, err = bwd_checks("ray_decode_bwd_recompute", dt, got, ref,
                                   tol, floors)
        log(f"kernel ray_decode_bwd_recompute {dtn} {list(cells.shape)}: "
            f"worst relative error {worst[1]:.3g} ({worst[0]}, tol {tol}), "
            f"max |diff| there {err:.3g}")
        del got, ref
        ms = checks.time(lambda: rd.ray_decode_bwd(*a, **kw), warmup=1,
                         reps=5)
        plain_ms = checks.time(lambda: rd.ray_decode_bwd_plain(
            *a[:5], g_off, g_logit, **kw, dtype=dt, saved=None),
            warmup=1, reps=3)
        b_ms, b_by, flops, byt = bound("ray_decode_bwd_recompute", a, dt)
        log(f"kernel ray_decode_bwd_recompute {dtn}: ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
        passes = k3_passes(a, kw) if dt in checks.profiled else None
        if dt == checks.dtypes[0]:
            out = {"name": "ray_decode_bwd_recompute", "dtype": dtn,
                   "shape": [list(cells.shape)], "max_abs_err": err,
                   "max_rel_err": worst[1], "worst": worst[0],
                   "tolerance_rel": tol, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                   "flops": flops, "bytes": byt, "passes": passes}
        torch.cuda.empty_cache()
    return out


def train_forward_row(recorded, dev, train_tols=TRAIN_TOL, checks=CHECKS):
    """Phase 10's forward check: K1 on the recorded training inputs against
    ``ray_decode_plain`` (``forward_rows``), at K2's output tolerances
    (of ``train_tols``): the same decode, whose outputs spread less under
    the training weights than the served ones, so that K1's serving
    tolerance would not bite."""
    w32 = recorded["f32_operands"]
    a, kw = recorded["ray_decode"]
    shape = tuple(tuple(t.shape) for t in a if torch.is_tensor(t))

    def as_f32(name, a):
        vt, cells, pos, rf, _ = a
        return vt.float(), cells, pos, rf.float(), w32

    tols = {("ray_decode", dt): train_tols[("ray_decode_save_out", dt)]
            for dt in (torch.bfloat16, torch.float32)}
    with torch.inference_mode():
        return forward_rows({("ray_decode", shape): (a, kw)}, as_f32, dev,
                            tols, checks=checks)["ray_decode"]


def train_kernel_variant_phase(dev, train_overrides, profile=False):
    """Phase 10: training with ``decode_bwd: kernel``. Returns K1's row at
    the training shapes and K3's recompute row, each with its launches."""
    cfg, model = train_mode_model(dev, train_overrides, "kernel")
    recorded, launches, step_ms = train_path(cfg, model, dev, profile,
                                             expect=EXPECT_PER_STEP_KERNEL)
    del model
    torch.cuda.empty_cache()
    k1 = add_launches(train_forward_row(recorded, dev),
                      launches["ray_decode"], TRAIN_STEPS, "step")
    k3 = add_launches(recompute_kernel_rows(recorded),
                      launches["ray_decode_bwd"], TRAIN_STEPS, "step")
    k3["step_ms"] = statistics.median(step_ms)
    return k1, k3


def train_mode_model(dev, train_overrides, decode_bwd):
    """The config and seeded training model of ``train_overrides`` with
    ``tpu.decode_bwd`` set (the weights of phase 6's model)."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config

    cfg = load_config(overrides={**train_overrides, "tpu": {
        **train_overrides.get("tpu", {}), "decode_bwd": decode_bwd}})
    gen = torch.Generator().manual_seed(SEED + 1)
    return cfg, randomize_weights_(build_lidf(cfg, build_static(cfg), gen),
                                   gen).to(dev)


@torch.no_grad()
def save_all_kernel_rows(recorded, tols=TRAIN_TOL, checks=CHECKS):
    """Phase 11's kernel checks on the recorded training inputs, in bf16 (as
    recorded) and f32: K2 'all' against ``ray_decode_plain(saves='all')``,
    K3 from its full saves against ``ray_decode_bwd_plain`` from the same
    saves. Returns both kernels' rows in the first of ``checks.dtypes``."""
    from implicit_depth_torch.ops import ray_decode as rd

    w32 = recorded["f32_operands"]
    (vt, cells, pos, rf, w_bf), kw2 = recorded["ray_decode_save_all"]
    a3, kw3 = recorded["ray_decode_bwd"]
    g_off, g_logit = a3[6], a3[7]
    names = rd.save_names(kw2["n_iter"], "all")
    floors = {"off_b4": g_off.abs().sum().item(),
              "prob_b4": g_logit.abs().sum().item()}
    rows = {}
    for dt in checks.dtypes:
        dtn = str(dt).split(".")[-1]
        w = w_bf if dt == torch.bfloat16 else w32
        a2 = (vt.to(dt), cells, pos, rf.to(dt), w)
        got = rd.ray_decode_save_all(*a2, **kw2)
        ref = rd.ray_decode_plain(*a2, **kw2, saves="all")
        torch.cuda.synchronize()
        # outputs, and the f32 offsets and logit before the squash (the
        # soft clamp is the identity on (0, 1)), at K2's output tolerance;
        # the other saves within an ulp of their largest value; the offset
        # entering the first iteration is init_offset, exactly
        tol_out = tols[("ray_decode_save_out", dt)]
        compared = [("offset", got[0], ref[0], tol_out),
                    ("logit", got[1], ref[1], tol_out)]
        for nm, g, r in zip(names, got[2], ref[2]):
            if nm == "off0":
                if not torch.equal(g, r):
                    raise AssertionError(f"ray_decode_save_all {dt}: off0 "
                                         "is not init_offset")
                continue
            f32 = nm.startswith("off") or nm == "logit"
            compared.append((nm, g, r, tol_out if f32 else
                             tols[("ray_decode_save", dt)]
                             * r.float().abs().max().item()))
        err2 = row_checks("ray_decode_save_all", dt, compared, checks)
        saved = got[2]
        a3 = (*a2, saved, g_off, g_logit)
        k3 = rd.ray_decode_bwd(*a3, **kw3)
        p3 = rd.ray_decode_bwd_plain(*a2[:4], w, g_off, g_logit, **kw3,
                                     dtype=dt, saved=saved)
        torch.cuda.synchronize()
        tol3 = tols[("ray_decode_bwd_all", dt)]
        _, worst, err3 = bwd_checks("ray_decode_bwd_all", dt, k3, p3, tol3,
                                    floors)
        log(f"kernel ray_decode_bwd_all {dtn}: worst relative error "
            f"{worst[1]:.3g} ({worst[0]}, tol {tol3}), max |diff| there "
            f"{err3:.3g}")
        del k3, p3, ref
        torch.cuda.empty_cache()
        for name, args, kern, plain, err, extra in (
                ("ray_decode_save_all", a2,
                 lambda: rd.ray_decode_save_all(*a2, **kw2),
                 lambda: rd.ray_decode_plain(*a2, **kw2, saves="all"),
                 err2, {"save_bytes": sum(t.numel() * t.element_size()
                                          for t in saved)}),
                ("ray_decode_bwd_all", a3,
                 lambda: rd.ray_decode_bwd(*a3, **kw3),
                 lambda: rd.ray_decode_bwd_plain(
                     *a2[:4], w, g_off, g_logit, **kw3, dtype=dt,
                     saved=saved),
                 err3, {"max_rel_err": worst[1], "worst": worst[0],
                        "tolerance_rel": tol3})):
            ms = checks.time(kern, warmup=1, reps=5)
            plain_ms = checks.time(plain, warmup=1, reps=3)
            b_ms, b_by, flops, byt = bound(name, args, dt, kw2["n_iter"])
            if name == "ray_decode_bwd_all" and dt in checks.profiled:
                extra = {**extra, "passes": k3_passes(a3, kw3)}
            log(f"kernel {name} {dtn} {list(cells.shape)}: ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
            if dt == checks.dtypes[0]:
                rows[name] = {"name": name, "dtype": dtn,
                              "shape": [list(cells.shape)],
                              "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "library_ms": None,
                              "bound_ms": b_ms, "bound_by": b_by,
                              "flops": flops, "bytes": byt, **extra}
        del a3, got, saved
        torch.cuda.empty_cache()
    return rows


def train_save_all_phase(dev, train_overrides, profile=False):
    """Phase 11: training with ``decode_bwd: kernel_save_all``. Returns the
    rows of K2 'all' and K3 from full saves, each with its launches."""
    cfg, model = train_mode_model(dev, train_overrides, "kernel_save_all")
    recorded, launches, step_ms = train_path(cfg, model, dev, profile,
                                             expect=EXPECT_PER_STEP_SAVE_ALL)
    del model
    torch.cuda.empty_cache()
    rows = save_all_kernel_rows(recorded)
    add_launches(rows["ray_decode_save_all"],
                 launches["ray_decode_save_all"], TRAIN_STEPS, "step")
    add_launches(rows["ray_decode_bwd_all"], launches["ray_decode_bwd"],
                 TRAIN_STEPS, "step")
    rows["ray_decode_bwd_all"]["step_ms"] = statistics.median(step_ms)
    return rows


def train_xla_phase(dev, train_overrides, profile=False):
    """Phase 12: training with ``decode_bwd: xla`` (K1, then autograd of the
    plain decode). Returns its launches per step and median step_ms."""
    cfg, model = train_mode_model(dev, train_overrides, "xla")
    _, launches, step_ms = train_path(cfg, model, dev, profile,
                                      expect=EXPECT_PER_STEP_XLA)
    del model
    torch.cuda.empty_cache()
    return {"launches_per_step": {k: n // TRAIN_STEPS
                                  for k, n in launches.items()},
            "step_ms": statistics.median(step_ms)}


# -- stage 2: training, its eval step, checkpoints (phases 13-17) ------------

def refine_kernel_modules():
    """(module, attribute) of each kernel entry as a refine train step calls
    it: the training IEF decode (K4's forward) and K5."""
    from implicit_depth_torch.models import pointnet, refine
    return {"ief_decode_train": (refine, "ief_decode_train"),
            "segment_max0": (pointnet, "segment_max0")}


def snapshot(a):
    """A recorded call's arguments, detached and copied: the training
    decode's f32 operands alias live parameters that the update changes."""
    def one(x):
        if torch.is_tensor(x):
            return x.detach().clone()
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        return x
    return tuple(one(x) for x in a)


def refine_train_path(cfg, lidf, refine, dev, steps, profile=False,
                      label="stage 2"):
    """A warm-up refine step (recording the inputs of K4's training entry
    and of the refine network's K5 calls, those with a gradient), then
    ``steps`` timed steps with the launch counters of
    EXPECT_PER_REFINE_STEP from 0: finite losses, every refine parameter
    moved, the frozen stage 1's parameters and buffers bit for bit.
    Returns a dict of the state, the step, the batches, the recorded calls,
    the launches, step_ms and (``profile``) the device time of a step."""
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_refine_train_step

    state = TrainState.create(refine, cfg.training, steps_per_epoch=1000)
    step = make_refine_train_step(cfg, lidf, refine, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = train_batches(steps + 1, cfg, TRAIN_BATCH, dev)
    lidf_before = {k: v.clone() for k, v in lidf.state_dict().items()}
    warm = {}
    recorded = record_calls(refine_kernel_modules(),
                            lambda: warm.update(step(state, batches[0], gen,
                                                     0)),
                            when=lambda a: a[0].requires_grad, keep=snapshot)
    assert all(torch.isfinite(v) for v in warm.values()), warm
    before = {n: p.detach().clone() for n, p in refine.named_parameters()}
    counts = {k: f for k, f in counters().items()
              if k in EXPECT_PER_REFINE_STEP}
    torch.cuda.reset_peak_memory_stats()
    for f in counts.values():
        f.launches = 0
    step_ms, losses = [], []
    for i, b in enumerate(batches[1:]):
        t0 = time.perf_counter()
        out = step(state, b, gen, i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: v.item() for k, v in out.items()})
    launches = {k: f.launches for k, f in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label}: {steps} steps of batch {TRAIN_BATCH} at "
        f"{cfg.dataset.img_height}x{cfg.dataset.img_width}, launches "
        f"{launches}, step_ms {step_ms}, median step_ms "
        f"{statistics.median(step_ms)}")
    log(f"{label} losses {losses}")
    log(f"{label} peak device memory {peak:.2f} GiB")
    for k, per in EXPECT_PER_REFINE_STEP.items():
        if launches[k] != per * steps:
            raise AssertionError(f"{label}: {k}: {launches[k]} launches in "
                                 f"{steps} steps, expected {per} each")
    if not all(np.isfinite(v) for ls in losses for v in ls.values()):
        raise AssertionError(f"{label}: a loss is not finite")
    still = [n for n, p in refine.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"{label}: refine parameters did not move: "
                             f"{still}")
    changed = [k for k, v in lidf.state_dict().items()
               if not torch.equal(v, lidf_before[k])]
    if changed or any(p.requires_grad for p in lidf.parameters()):
        raise AssertionError(f"{label}: the frozen stage 1 changed: {changed}")
    log(f"{label}: every refine parameter moved; the stage-1 parameters and "
        f"buffers ({len(lidf_before)} tensors) are bit for bit as before")
    device = None
    if profile:
        device = profile_device_ms(lambda: step(state, batches[1], gen, 0),
                                   f"{label}: device time of one step")
    return {"state": state, "step": step, "batches": batches,
            "recorded": recorded, "launches": launches,
            "step_ms": statistics.median(step_ms), "peak_gib": peak,
            "device_ms": device}


def refine_k4_row(recorded, dev, dtypes=(torch.bfloat16, torch.float32),
                  bite=True, tols=TOL, checks=CHECKS, held=True):
    """Phase 13's K4 checks on the recorded inputs of K4's training entry
    (one refine iteration's rows), in bf16 (as recorded) and f32: the
    kernel against ``ief_decode_plain`` (``forward_rows``, phase 3's
    tolerances; ``bite``, ``checks`` and ``held`` as there), and the
    training decode's gradients
    (``IefDecodeTrain``: K4 forward, autograd of the plain decode
    recomputed) against autograd of ``ief_decode_plain`` on the same
    inputs, with the backward's time (the forward in ``dtypes`` only, the
    gradient in both). Returns the forward's row in the first of
    ``dtypes``."""
    from implicit_depth_torch.ops import decode_common as common
    from implicit_depth_torch.ops import ief_decode as ied

    (_, shape), (a, kw) = next((k, v) for k, v in recorded.items()
                               if k[0] == "ief_decode_train")
    end, rc, pos, w32, dtype = a
    # K4's call as the training entry makes it on the card: the operands
    # and the end rows at the kernel's widths
    padded = common.pad_operands(w32, ied.FORMAT)
    end_k4 = common.pad_columns(end, padded["dims"][0])
    shape = (tuple(end_k4.shape), *shape[1:])
    call = {("ief_decode", shape[:3]):
            ((end_k4, rc, pos,
              common.cast_operands(padded, ied.FORMAT, dtype)), kw)}

    def as_f32(name, args):
        e, r, p, _ = args
        return (e.float(), r.float(), p.float(),
                common.cast_operands(padded, ied.FORMAT, torch.float32))

    with torch.inference_mode():
        row = forward_rows(call, as_f32, dev, tols, dtypes=dtypes,
                           bite=bite, checks=checks,
                           held=held)["ief_decode"]
    g = torch.randn(end.shape[0], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    row["grad"] = {}
    for dt in (torch.bfloat16, torch.float32):
        dtn = str(dt).split(".")[-1]
        wl = {k: w32[k].clone().requires_grad_() for k in ied.FORMAT.operands}
        w = dict(wl, dims=w32["dims"])
        e = end.to(dt).clone().requires_grad_()
        p = pos.to(dt).clone().requires_grad_()
        r = rc.to(dt)
        leaves = [e, p, *wl.values()]
        names = ["d_end", "d_pos", *wl]
        out = ied.ief_decode_train(e, r, p, w, dt, **kw)
        got = torch.autograd.grad(out, leaves, g, retain_graph=True)
        ref_out = ied.ief_decode_plain(
            e, r, p, common.round_biases(w, ied.FORMAT, dt), dtype=dt, **kw)
        ref = torch.autograd.grad(ref_out, leaves, g, retain_graph=True)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, ref))
        errs = {n: rel_norm(x, y) for n, x, y in zip(names, got, ref)}
        worst = max(errs, key=errs.get)
        tol = REFINE_GRAD_TOL[dt]
        bwd_ms = checks.time(lambda: torch.autograd.grad(
            out, leaves, g, retain_graph=True), warmup=1, reps=5)
        plain_bwd_ms = checks.time(lambda: torch.autograd.grad(
            ref_out, leaves, g, retain_graph=True), warmup=1, reps=5)
        log(f"kernel ief_decode training gradient {dtn} {list(end.shape)}: "
            f"{'the same bits as' if same else 'differs from'} autograd of "
            f"ief_decode_plain; worst relative error {errs[worst]:.3g} "
            f"({worst}, tol {tol}); backward ms {bwd_ms:.4f} (autograd of "
            f"the plain decode alone {plain_bwd_ms:.4f})")
        if not (all(torch.isfinite(x).all() for x in got)
                and errs[worst] <= tol):
            raise AssertionError(f"ief_decode training gradient {dt}: "
                                 f"{worst} {errs[worst]} > {tol}")
        row["grad"][dtn] = {"same_bits": same, "max_rel_err": errs[worst],
                            "worst": worst, "tolerance_rel": tol,
                            "bwd_ms": bwd_ms, "plain_bwd_ms": plain_bwd_ms}
        del out, ref_out, got, ref
        torch.cuda.empty_cache()
    return row


def refine_train_phase(dev, profile=False):
    """Phase 13: stage-2 training behind the frozen per_ray stage 1. Returns
    K4's and K5's training rows, each with its launches per step, and the
    models, state and step for phase 17."""
    from implicit_depth_torch.config import load_config

    cfg = load_config(overrides=REFINE_OVERRIDES)
    lidf, refine = (m.to(dev) for m in build_models(cfg, train=True))
    log(f"stage-2 training model: {cfg.dataset.img_height}x"
        f"{cfg.dataset.img_width}, batch {TRAIN_BATCH} (configured "
        f"{cfg.training.batch_size}), rays {lidf.static.n_rays}, valid "
        f"{lidf.static.n_valid}, K={lidf.static.k_pairs}, "
        f"kb={cfg.tpu.pairs_budget_per_ray}, dtype {cfg.tpu.compute_dtype}, "
        f"forward_times {cfg.refine.forward_times}, perturb "
        f"{cfg.refine.perturb_prob}, {cfg.training.optimizer_name} lr "
        f"{cfg.training.lr}, pos_w {cfg.loss.pos_w}, surf_norm_w "
        f"{cfg.loss.surf_norm_w}")
    run = refine_train_path(cfg, lidf, refine, dev, TRAIN_STEPS, profile)
    k4 = add_launches(refine_k4_row(run["recorded"], dev),
                      run["launches"]["ief_decode"], TRAIN_STEPS, "step")
    k4.update(step_ms=run["step_ms"], step_device_ms=run["device_ms"],
              peak_gib=run["peak_gib"])
    k5 = add_launches(segment_train_phase(
        {k: v for k, v in run["recorded"].items() if k[0] == "segment_max0"},
        dev), run["launches"]["segment_max0"], TRAIN_STEPS, "step")
    return {"ief_decode": k4, "segment_max0": k5}, (cfg, lidf, run)


def refine_hardneg_phase(dev):
    """Phase 14: HARDNEG_STEPS refine steps with hard negatives. Returns its
    launches per step and median step_ms."""
    from implicit_depth_torch.config import load_config

    cfg = load_config(overrides=REFINE_HARDNEG_OVERRIDES)
    assert cfg.loss.hard_neg
    lidf, refine = (m.to(dev) for m in build_models(cfg, train=True))
    run = refine_train_path(cfg, lidf, refine, dev, HARDNEG_STEPS,
                            label="stage 2 hard_neg")
    return {"launches_per_step": {k: n // HARDNEG_STEPS
                                  for k, n in run["launches"].items()},
            "step_ms": run["step_ms"]}


def refine_eval_phase(dev):
    """Phase 15: the refine eval step on one 240x320 image, every pixel a
    ray, ``use_all_pix`` false (only zero-depth pixels' predictions enter
    the PointNet), in f32 on the card (one K1, two K4, ten K5) and on the
    CPU with the same weights and valid-point draw: the refined points
    within XCHECK_ATOL on all but XCHECK_FRAC of the rays."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.geometry.sampling import sample_valid_stratified
    from implicit_depth_torch.train.steps import make_refine_eval_step

    over = {**REFINE_OVERRIDES,
            "refine": {**REFINE_OVERRIDES["refine"], "use_all_pix": False},
            "tpu": {**REFINE_OVERRIDES["tpu"], "compute_dtype": "float32"}}
    cfg = load_config(overrides=over)
    lidf, refine = build_models(cfg)
    batch = train_batches(1, cfg, 1, "cpu")[0]
    vidx, _, _ = sample_valid_stratified(batch["depth_corrupt"] != 0,
                                         lidf.static.n_valid,
                                         torch.Generator().manual_seed(SEED))
    runs = {}
    counts = {k: f for k, f in counters().items()
              if k in EXPECT_PER_REFINE_STEP}
    for device in (dev, torch.device("cpu")):
        for f in counts.values():
            f.launches = 0
        step = make_refine_eval_step(cfg, copy.deepcopy(lidf),
                                     copy.deepcopy(refine), device)
        _, out, pred, losses = step(None, {k: v.to(device) for k, v in
                                           batch.items()}, valid_idx=vidx)
        runs[device.type] = (pred.float().cpu(), {k: v.item() for k, v in
                                                  losses.items()})
        if device == dev:
            launches = {k: f.launches for k, f in counts.items()}
    diff = (runs[dev.type][0] - runs["cpu"][0]).abs().amax(-1)
    agree = (diff <= XCHECK_ATOL).float().mean().item()
    injected = (batch["depth_corrupt"] == 0).float().mean().item()
    log(f"refine eval step f32 {dev} vs cpu ({cfg.dataset.img_height}x"
        f"{cfg.dataset.img_width}, every pixel a ray, use_all_pix false: "
        f"{injected:.3f} of the pixels injected): launches {launches}, "
        f"refined points within {XCHECK_ATOL} m: {agree:.6f}, median |diff| "
        f"{diff.median().item():.3g}, max |diff| {diff.max().item():.3g}; "
        f"losses card {runs[dev.type][1]} cpu {runs['cpu'][1]}")
    want = {k: EXPECT_PER_REFINE_STEP[k] for k in
            ("ray_decode", "ief_decode", "segment_max0")}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"refine eval step: launches {launches}, "
                             f"expected {want}")
    if agree < 1 - XCHECK_FRAC:
        raise AssertionError("refine eval step: the card and the CPU "
                             "disagree")
    return {"agree": agree, "launches": launches}


def refine_cross_check(dev):
    """Phase 16: for each seed of XCHECK_SEEDS, one f32 refine step of the
    same weights on the card (kernels) and on the CPU (plain versions),
    same valid points, ray window and perturbation: the losses within
    XCHECK_LOSS_RTOL, each refine gradient within XCHECK_GRAD_RTOL. Every
    seed is logged before a failure is raised."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.geometry.sampling import (
        sample_masked_window,
        sample_valid_stratified,
    )
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_refine_train_step

    cfg = load_config(overrides=REFINE_XCHECK)
    failed = []
    for seed in XCHECK_SEEDS:
        lidf, refine = build_models(cfg, train=True, seed=seed)
        static = lidf.static
        batch = train_batches(1, cfg, 1, "cpu", seed)[0]
        gen = torch.Generator().manual_seed(seed)
        vidx, _, _ = sample_valid_stratified(batch["valid_mask"] > 0.5,
                                             static.n_valid, gen)
        _, _, _, mstart = sample_masked_window(
            (batch["corrupt_mask"] > 0.5).reshape(1, -1), static.n_rays, gen)
        noise = {k: torch.rand((1,), generator=gen)
                 for k in ("apply", "bucket", "u")}
        runs = {}
        for device in (dev, torch.device("cpu")):
            lm, rm = copy.deepcopy(lidf), copy.deepcopy(refine)
            state = TrainState.create(rm, cfg.training, steps_per_epoch=1000)
            losses = make_refine_train_step(cfg, lm, rm, device)(
                state, {k: v.to(device) for k, v in batch.items()}, None, 0,
                valid_idx=vidx, miss_start=mstart,
                noise={k: v.to(device) for k, v in noise.items()})
            runs[device.type] = ({k: v.item() for k, v in losses.items()},
                                 {n: p.grad.cpu()
                                  for n, p in rm.named_parameters()})
        (la, ga), (lb, gb) = runs[dev.type], runs["cpu"]
        loss_err = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-6) for k in lb)
        errs = {n: rel_norm(ga[n], gb[n]) for n in gb}
        worst = max(errs, key=errs.get)
        log(f"refine cross-check f32 seed {seed}, card vs cpu "
            f"({cfg.dataset.img_height}x{cfg.dataset.img_width}, "
            f"{static.n_rays} rays, perturbation {noise}): losses card {la} "
            f"cpu {lb}; largest relative loss difference {loss_err:.3g}; "
            f"gradients, largest relative error {errs[worst]:.3g} ({worst}), "
            f"median {statistics.median(errs.values()):.3g}")
        if loss_err > XCHECK_LOSS_RTOL:
            failed.append(f"seed {seed} losses: {loss_err}")
        if errs[worst] > XCHECK_GRAD_RTOL:
            failed.append(f"seed {seed} {worst}: {errs[worst]}")
    if failed:
        raise AssertionError(f"refine cross-check: the card and the CPU "
                             f"disagree: {failed}")


def checkpoint_phase(dev, cfg, lidf, run):
    """Phase 17: checkpoints on the card. Phase 13's stage 1 and refine
    state saved; ``DepthCompleter.from_checkpoint`` of them serves a
    480x640 frame bit for bit as the in-memory pair; the refine state
    restored into fresh models takes one more step bit for bit as the
    uninterrupted state does (same batch, same draws)."""
    import os
    import tempfile

    from implicit_depth_torch.builder import build_refine
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.train.checkpoint import Checkpointer
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_refine_train_step

    state, step, batch = run["state"], run["step"], run["batches"][1]
    frame = make_frames(1, FRAME_HW)[0]
    with tempfile.TemporaryDirectory() as d:
        lidf_dir, refine_dir = os.path.join(d, "lidf"), os.path.join(d, "refine")
        Checkpointer(lidf_dir).save(lidf, epoch=0)
        Checkpointer(refine_dir).save(state, epoch=0, meta={"phase": 13})
        want = DepthCompleter(cfg, lidf=lidf, refine=state.model,
                              device=dev).complete(*frame)
        dc = DepthCompleter.from_checkpoint(lidf_dir, refine_dir, cfg=cfg,
                                            device=dev)
        got = dc.complete(*frame)
        same_frame = all(got[k].tobytes() == want[k].tobytes()
                         for k in ("depth", "depth_pred"))
        fresh = TrainState.create(build_refine(cfg, lidf.static).to(dev),
                                  cfg.training, steps_per_epoch=1000)
        fresh, meta = Checkpointer(refine_dir).restore(fresh)
    resumed = make_refine_train_step(cfg, lidf, fresh.model, dev)
    outs = []
    for st, fn in ((state, step), (fresh, resumed)):
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        outs.append({k: v.item() for k, v in fn(st, batch, gen, 1).items()})
    same_losses = outs[0] == outs[1]
    differ = [n for (n, p), q in zip(state.model.named_parameters(),
                                     fresh.model.parameters())
              if not torch.equal(p, q)]
    log(f"checkpoints: a 480x640 frame from DepthCompleter.from_checkpoint "
        f"{'is' if same_frame else 'is NOT'} bit for bit the in-memory "
        f"pair's; restored refine state (step {fresh.step}, meta {meta}): "
        f"one more step gives losses {outs[1]} against the uninterrupted "
        f"{outs[0]} ({'the same bits' if same_losses else 'different'}), "
        f"parameters differing: {differ}")
    if not (same_frame and same_losses and not differ):
        raise AssertionError("checkpoints: the restored models do not give "
                             "the bits of the in-memory ones")
    return {"frame_bit_identical": same_frame, "resume_bit_identical": True}


def refine_phases(dev, profile=False):
    """Phases 13-17 (see the module doc). Returns K4's and K5's stage-2
    training rows."""
    rows, (cfg, lidf, run) = refine_train_phase(dev, profile)
    rows["ief_decode"]["hard_neg"] = refine_hardneg_phase(dev)
    rows["ief_decode"]["eval"] = refine_eval_phase(dev)
    refine_cross_check(dev)
    rows["ief_decode"]["checkpoint"] = checkpoint_phase(dev, cfg, lidf, run)
    del run, lidf
    torch.cuda.empty_cache()
    return rows


# -- the trainer, data pipeline and CLI (phases 18-22) -----------------------
# the user's configs, read through the port's YAML reader; each cut is a
# --set override (PERF.md §4), the data synthetic (no dataset is in the repo)
TRAINER_CONFIGS = {stage: str(ROOT / "configs" / name) for stage, name in (
    ("lidf", "train_lidf.yaml"), ("refine", "train_refine.yaml"),
    ("test", "test_lidf.yaml"), ("test_refine", "test_refine.yaml"),
    ("refine_hardneg", "train_refine_hardneg.yaml"),
    ("smoke", "smoke_synthetic.yaml"),
    ("conv_refine", "convergence_refine.yaml"))}
TRAINER_SET = ["dataset.type=synthetic", "training.log_interval=1"]
# A: the config's batch 32, one epoch of 2 steps
BATCH32_SET = ["dataset.synthetic_len=64", "training.nepochs=1",
               "training.do_valid=False"]
# the trainer at batch 4, 10 steps, beside phase 6's bare step
BATCH4_SET = ["training.batch_size=4", "dataset.synthetic_len=40",
              "training.nepochs=1", "training.do_valid=False"]
# B: batch 4, 2 epochs of 2 steps, a mid-epoch checkpoint every step, each
# epoch validated over the synthetic valid split (synthetic_len frames)
STAGE1_SET = ["training.batch_size=4", "dataset.synthetic_len=8",
              "training.nepochs=2", "training.ckpt_every_steps=1",
              "training.valid_batch_size=1"]
# C: B killed by a step that raises after this many steps
KILL_AFTER = 3
# E: stage 2, batch 4, one epoch of 2 steps, validated
REFINE_TRAINER_SET = ["training.batch_size=4", "dataset.synthetic_len=8",
                      "training.nepochs=1", "training.valid_batch_size=1"]


def expect_per_eval_frame(rays=1, chunk=0):
    """Per eval batch of stage 1: K1 once (once a chunk of ``chunk`` rays,
    ceil(rays / chunk) times, when ``tpu.eval_rays_per_chunk`` is below the
    ``rays`` of a frame) and the stage-1 PointNet's 2 pools."""
    return {"ray_decode": -(-rays // chunk) if 0 < chunk < rays else 1,
            "segment_max0": 2}


# per eval frame: stage 1 in one shot; stage 2 as a served frame
EXPECT_PER_EVAL_FRAME = expect_per_eval_frame()
# batch 32's plain K2 and K3 are computed over chunks of this many rays
# (the batch-4 step's 80,000), so that their f32 graphs fit the card
PLAIN_CHUNK_RAYS = 80000
LOADER_SAMPLES = 32


def cli(dev, stage, workdir, *sets, make=False):
    """``implicit_depth_torch.main`` on ``dev`` with the config of ``stage``
    (TRAINER_CONFIGS), logging into ``workdir``: the trainer it ran (or,
    with ``make``, built and did not run)."""
    from implicit_depth_torch import main as cli_main
    argv = ["--device", str(dev), "--cfg_paths", TRAINER_CONFIGS[stage],
            "--set", f"base_log_dir={workdir}", "log_name=run", *TRAINER_SET,
            *sets]
    return (cli_main.make_trainer if make else cli_main.main)(argv)


def counted(run):
    """``run()`` with every kernel wrapper's count from 0; returns (its
    result, {kernel: launches})."""
    counts = counters()
    for f in counts.values():
        f.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in counts.items()}


def expect_launches(label, launches, steps, frames, per_step, per_frame,
                    chunks=0):
    """Each kernel's launches against ``steps`` x ``per_step`` + ``frames``
    x ``per_frame`` (a kernel named in neither: 0); the segment sum's
    against SUMS_PER_CHUNK x ``chunks``, the recompute backward's chunks
    (the global and dense modes' training)."""
    want = {k: steps * per_step.get(k, 0) + frames * per_frame.get(k, 0)
            for k in launches}
    if "segment_sum_" in want:
        want["segment_sum_"] += SUMS_PER_CHUNK * chunks
    log(f"{label}: launches {launches} in {steps} steps and {frames} eval "
        f"frames")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")


def epoch_records(tr):
    return epoch_log(tr.epoch_log_path)


def epoch_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f.read().splitlines()]


def trainer_step_ms(tr, record):
    """The trainer's host-clock time per step of one epoch's record."""
    return record["train"]["epoch_time_s"] * 1e3 / tr.steps_per_epoch


def loader_phase(dev, workdir):
    """Host seconds per synthetic sample at the config's resolution, one
    thread, and per batch of 32 through the trainer's loader (its 4
    threads)."""
    tr = cli(dev, "lidf", workdir, *BATCH32_SET, make=True)
    ds = tr.train_loader.dataset
    t0 = time.perf_counter()
    for i in range(LOADER_SAMPLES):
        ds.__getitem__(i, 0)
    per_sample = (time.perf_counter() - t0) / LOADER_SAMPLES
    t0 = time.perf_counter()
    n = sum(1 for _ in tr.train_loader.epoch(0))
    per_batch = (time.perf_counter() - t0) / n
    log(f"loader: {per_sample * 1e3:.2f} ms a synthetic sample at "
        f"{ds.h}x{ds.w} (one thread); {per_batch * 1e3:.1f} ms a batch of "
        f"{tr.train_loader.batch_size} through the trainer's loader "
        f"({tr.train_loader.num_workers} threads)")
    return {"sample_ms": per_sample * 1e3, "batch32_ms": per_batch * 1e3}


def chunked_plain_k2(a2, kw2, n_chunk):
    """``ray_decode_plain(saves=True)`` over chunks of rays, concatenated:
    the same function, rows computed independently."""
    from implicit_depth_torch.ops import ray_decode as rd
    vt, cells, pos, rf, w = a2
    parts = [rd.ray_decode_plain(vt, cells[s:s + n_chunk], pos[s:s + n_chunk],
                                 rf[s:s + n_chunk], w, **kw2, saves=True)
             for s in range(0, cells.shape[0], n_chunk)]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
            tuple(torch.cat([p[2][i] for p in parts]) for i in range(3)))


def chunked_plain_k3(a3, kw3, dt, n_chunk):
    """``ray_decode_bwd_plain`` from the saves over chunks of rays: the
    table's and weights' gradients summed over the chunks, the rays'
    concatenated."""
    from implicit_depth_torch.ops import ray_decode as rd
    vt, cells, pos, rf, w, saved, g_off, g_logit = a3
    kb = cells.shape[1]
    d_vt, d_rf, d_w = None, [], {}
    for s in range(0, cells.shape[0], n_chunk):
        e = s + n_chunk
        g = rd.ray_decode_bwd_plain(
            vt, cells[s:e], pos[s:e], rf[s:e], w, g_off[s:e], g_logit[s:e],
            **kw3, dtype=dt, saved=tuple(t[s * kb:e * kb] for t in saved))
        d_vt = g[0] if d_vt is None else d_vt + g[0]
        d_rf.append(g[1])
        for k, v in g[2].items():
            d_w[k] = v if k not in d_w else d_w[k] + v
    return d_vt, torch.cat(d_rf), d_w


@torch.no_grad()
def batch32_kernel_rows(recorded):
    """Phase 18's K2 and K3 checks: the calls recorded from a batch-32
    trainer step, in bf16 (as the trainer runs), against their plain
    versions computed over chunks of rays (``chunked_plain_k2`` /
    ``_k3``), with phase 7's tolerances; times and bounds."""
    from implicit_depth_torch.ops import ray_decode as rd
    dt, n_chunk = torch.bfloat16, PLAIN_CHUNK_RAYS
    first = {}
    for (name, _), call in recorded.items():
        first.setdefault(name, call)
    a2, kw2 = first["ray_decode_save"]
    a3, kw3 = first["ray_decode_bwd"]
    got = rd.ray_decode_save(*a2, **kw2)
    ref = chunked_plain_k2(a2, kw2, n_chunk)
    tol_out = TRAIN_TOL[("ray_decode_save_out", dt)]
    checks = [("offset", got[0], ref[0], tol_out),
              ("logit", got[1], ref[1], tol_out)]
    for nm, g, r in zip(("e1", "z1p", "trig"), got[2], ref[2]):
        checks.append((nm, g, r, TRAIN_TOL[("ray_decode_save", dt)]
                       * r.float().abs().max().item()))
    err2 = row_checks("ray_decode_save", dt, checks)
    del ref
    k3_args = (*a2, got[2], a3[6], a3[7])
    k3 = rd.ray_decode_bwd(*k3_args, **kw3)
    p3 = chunked_plain_k3(k3_args, kw3, dt, n_chunk)
    torch.cuda.synchronize()
    tol3 = TRAIN_TOL[("ray_decode_bwd", dt)]
    floors = {"off_b4": a3[6].abs().sum().item(),
              "prob_b4": a3[7].abs().sum().item()}
    _, worst, err3 = bwd_checks("ray_decode_bwd", dt, k3, p3, tol3, floors)
    del k3, p3
    rows = {}
    for name, args, kw, err, kern, plain in (
            ("ray_decode_save", a2, kw2, err2,
             lambda: rd.ray_decode_save(*a2, **kw2),
             lambda: chunked_plain_k2(a2, kw2, n_chunk)),
            ("ray_decode_bwd", k3_args, kw3, err3,
             lambda: rd.ray_decode_bwd(*k3_args, **kw3),
             lambda: chunked_plain_k3(k3_args, kw3, dt, n_chunk))):
        ms = time_ms(kern, warmup=1, reps=3)
        plain_ms = time_ms(plain, warmup=0, reps=1)
        b_ms, b_by, _, _ = bound(name, args, dt)
        rows[name] = {"shape": list(args[1].shape), "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by}
        if name == "ray_decode_bwd":
            rows[name].update(max_rel_err=worst[1], worst=worst[0])
        log(f"kernel {name} bf16 at batch 32 {rows[name]['shape']}: ms "
            f"{ms:.4f} plain_ms (chunks of {n_chunk} rays) {plain_ms:.4f} "
            f"bound_ms {b_ms:.4f} ({b_by})")
    # Pass A and Pass B of each K3 instance at batch 32: from K2's saves,
    # recomputing layer 1, from K2 'all''s full saves
    passes = {}
    for inst, saves in (("kernel_save", got[2]), ("kernel", None),
                        ("kernel_save_all", "all")):
        if saves == "all":
            del got
            torch.cuda.empty_cache()
            saves = rd.ray_decode_save_all(*a2, **kw2)[2]
        log(f"kernel ray_decode_bwd ({inst}) bf16 at batch 32:")
        passes[inst] = k3_passes((*a2, saves, a3[6], a3[7]), kw3)
        del saves
        torch.cuda.empty_cache()
    rows["ray_decode_bwd"]["passes"] = passes
    return rows


def unit_scale_checkpoint(stage, sets, ckpt_dir):
    """A checkpoint of the stage-1 model of the CLI's config with the
    seeded unit-scale weights of ``build_models`` (phase 6's), for the
    trainer to start from (``checkpoint_path``): the builders' own initial
    decoders output ~1e-3, where no tolerance of K2 against its plain
    version could bite."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.main import parse_overrides
    from implicit_depth_torch.train.checkpoint import Checkpointer
    cfg = load_config(TRAINER_CONFIGS[stage],
                      overrides=parse_overrides([*TRAINER_SET, *sets]))
    gen = torch.Generator().manual_seed(SEED + 1)
    model = randomize_weights_(build_lidf(cfg, build_static(cfg), gen), gen)
    Checkpointer(str(ckpt_dir)).save(model, epoch=0)
    return ckpt_dir


def trainer_batch32_phase(dev, workdir, profile=False):
    """Phase 18 (A): stage 1 through the CLI at the config's batch 32, one
    epoch of 2 steps from unit-scale weights (``unit_scale_checkpoint``),
    recording the first step's K2 and K3 calls (checked after:
    ``batch32_kernel_rows``); then the same at batch 4 for 10 steps, the
    trainer's step time beside phase 6's bare step."""
    init = unit_scale_checkpoint("lidf", BATCH32_SET, workdir / "init")
    sets = (*BATCH32_SET, f"checkpoint_path={init}")
    from implicit_depth_torch.ops import ray_decode as rd
    holder = {}
    torch.cuda.reset_peak_memory_stats()
    wgmma0 = rd.ray_decode_bwd.wgmma_launches
    recorded, launches = counted(lambda: record_calls(
        train_kernel_modules(),
        lambda: holder.update(tr=cli(dev, "lidf", workdir / "a32", *sets))))
    tr = holder["tr"]
    # K3's Pass A on wgmma (bf16, 64 rows): one launch a stage-1 step
    wgmma = rd.ray_decode_bwd.wgmma_launches - wgmma0
    a3, kw3 = next(call for (name, _), call in recorded.items()
                   if name == "ray_decode_bwd")
    want = launches["ray_decode_bwd"] * k3_wgmma(a3, kw3)
    log(f"trainer batch 32: {wgmma} K3 launches with the wgmma Pass A in "
        f"{tr.steps_per_epoch} steps, expected {want}")
    if wgmma != want or want != tr.steps_per_epoch:
        raise AssertionError(f"trainer batch 32: {wgmma} wgmma Pass A "
                             f"launches, expected {tr.steps_per_epoch}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = epoch_records(tr)[-1]
    step_ms = trainer_step_ms(tr, rec)
    expect_launches("trainer batch 32", launches, tr.steps_per_epoch, 0,
                    EXPECT_PER_STEP, {})
    if not np.isfinite(rec["train"]["loss_net"]):
        raise AssertionError(f"trainer batch 32: losses {rec['train']}")
    log(f"trainer batch 32: {tr.steps_per_epoch} steps of batch "
        f"{tr.cfg.training.batch_size} at {tr.cfg.dataset.img_height}x"
        f"{tr.cfg.dataset.img_width}, {tr.static.n_rays} rays and "
        f"{tr.static.n_valid} valid points an image, step time (epoch_time_s "
        f"/ steps) {step_ms:.1f} ms, peak device memory {peak:.2f} GiB (with "
        f"the recorded first step's K2 and K3 operands held), losses "
        f"{rec['train']}")
    out = {"step_ms": step_ms, "peak_gib": peak, "launches": launches}
    if profile:
        from implicit_depth_torch.train.trainer import to_device
        batch = to_device(next(iter(tr.train_loader.epoch(1))), tr.device)
        out["step_device_ms"] = profile_device_ms(
            lambda: tr.train_step(tr.state, batch, tr.generator, 1),
            "trainer batch 32: device time of one step")
    del tr, holder
    torch.cuda.empty_cache()
    out["kernels"] = batch32_kernel_rows(recorded)
    del recorded
    torch.cuda.empty_cache()
    tr4, launches4 = counted(lambda: cli(dev, "lidf", workdir / "a4",
                                         *BATCH4_SET,
                                         f"checkpoint_path={init}"))
    expect_launches("trainer batch 4", launches4, tr4.steps_per_epoch, 0,
                    EXPECT_PER_STEP, {})
    out["batch4_step_ms"] = trainer_step_ms(tr4, epoch_records(tr4)[-1])
    log(f"trainer batch 4: step time {out['batch4_step_ms']:.1f} ms over "
        f"{tr4.steps_per_epoch} steps")
    return out


def assert_same_tensors(label, a, b):
    """Two state dicts, every tensor bit for bit."""
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if set(a) != set(b) or differ:
        raise AssertionError(f"{label}: differ at {differ or set(a) ^ set(b)}")
    log(f"{label}: {len(a)} tensors bit for bit")


def trainer_stage1_phase(dev, workdir):
    """Phases 19-20 (B, C): stage 1 through the CLI at batch 4, 2 epochs of
    2 steps with validation and a checkpoint every step; then the same run
    killed after KILL_AFTER steps, resumed mid-epoch by a fresh trainer to
    the bits of the uninterrupted one, and resumed again at its end. cuDNN
    runs its deterministic algorithms. Returns B's trainer and launches."""
    import os

    from implicit_depth_torch.train import trainer as trainer_mod

    tr, launches = counted(lambda: cli(dev, "lidf", workdir / "b",
                                       *STAGE1_SET))
    recs = epoch_records(tr)
    steps = tr.steps_per_epoch * len(recs)
    frames = sum(len(tr.make_valid_loaders()["synthetic"].dataset)
                 for r in recs if "valid" in r)
    expect_launches("trainer stage 1", launches, steps, frames,
                    EXPECT_PER_STEP, EXPECT_PER_EVAL_FRAME)
    ckpts = ("latest_network", "epoch000_network", "epoch001_network",
             "best_network")
    missing = [c for c in ckpts if not os.path.isdir(
        os.path.join(tr.ckpt_dir, c))]
    losses = [v for r in recs for v in (*r["train"].values(),
                                        *r["valid"]["synthetic"].values())]
    if (len(recs) != 2 or missing or not os.path.exists(tr.valid_log_path)
            or not all(np.isfinite(losses))):
        raise AssertionError(f"trainer stage 1: records {recs}, missing "
                             f"checkpoints {missing}")
    log(f"trainer stage 1: {len(recs)} epochs, step times "
        f"{[trainer_step_ms(tr, r) for r in recs]} ms (a checkpoint every "
        f"step), valid {[r['valid'] for r in recs]}; checkpoints {ckpts}")

    class Preempted(RuntimeError):
        pass

    real_make, calls = trainer_mod.make_lidf_train_step, {"n": 0}

    def dying_make(*a, **kw):
        step = real_make(*a, **kw)

        def dying(*sa, **skw):
            if calls["n"] >= KILL_AFTER:
                raise Preempted("simulated preemption")
            calls["n"] += 1
            return step(*sa, **skw)
        return dying

    trainer_mod.make_lidf_train_step = dying_make
    try:
        cli(dev, "lidf", workdir / "c", *STAGE1_SET)
        raise AssertionError("trainer resume: the dying step did not raise")
    except Preempted:
        pass
    finally:
        trainer_mod.make_lidf_train_step = real_make
    resumed = cli(dev, "lidf", workdir / "c", *STAGE1_SET, make=True)
    at = (resumed.start_epoch, resumed._resume_skip_steps, resumed.state.step)
    want = divmod(KILL_AFTER, tr.steps_per_epoch) + (KILL_AFTER,)
    log(f"trainer resume: killed after {KILL_AFTER} steps; the fresh trainer "
        f"starts at epoch {at[0]}, skipping {at[1]} steps, at update {at[2]}")
    if at != want:
        raise AssertionError(f"trainer resume: at {at}, expected {want}")
    resumed.run()
    assert_same_tensors("trainer resume: the resumed run's parameters and "
                        "buffers against the uninterrupted run's",
                        tr.model.state_dict(), resumed.model.state_dict())
    again = cli(dev, "lidf", workdir / "c", *STAGE1_SET, make=True)
    if (again.start_epoch, again._resume_skip_steps) != (2, 0):
        raise AssertionError(f"trainer resume: a resume after the run starts "
                             f"at {again.start_epoch}, skip "
                             f"{again._resume_skip_steps}")
    log("trainer resume: a resume after the end starts at epoch 2, no skip")
    return tr, launches


def trainer_test_phase(dev, workdir, ckpt_dir):
    """Phase 21 (D): configs/test_lidf.yaml through the CLI from B's
    checkpoint: the per-image CSV, each value equal to cleargrasp_metrics
    of the eval outputs of a fresh trainer of the same config."""
    import csv
    import os

    from implicit_depth_torch.train.metrics import (
        cleargrasp_metrics,
        depth_images_from_outputs,
    )
    from implicit_depth_torch.train.trainer import to_device

    sets = (f"checkpoint_path={ckpt_dir}", "dataset.synthetic_len=8")
    tr, launches = counted(lambda: cli(dev, "test", workdir / "d", *sets))
    loader = tr.make_valid_loaders()["synthetic"]
    expect_launches("trainer test", launches, 0, len(loader.dataset), {},
                    EXPECT_PER_EVAL_FRAME)
    with open(os.path.join(tr.result_dir, "synthetic.csv")) as f:
        rows = list(csv.reader(f))
    fresh = cli(dev, "test", workdir / "d2", *sets, make=True)
    h, w = fresh.cfg.dataset.img_height, fresh.cfg.dataset.img_width
    want = []
    for batch in loader.epoch(0):
        inputs, pred, _ = fresh._eval(to_device(batch, fresh.device))
        depth = depth_images_from_outputs(inputs, pred, h, w)
        for i, path in enumerate(batch["item_path"]):
            m = cleargrasp_metrics(depth[i], batch["depth"][i],
                                   batch["corrupt_mask"][i])
            if m:
                want.append([path, *(repr(m[k]) for k in (
                    "rmse", "abs_rel", "mae", "a1", "a2", "a3"))])
    mean = np.asarray([r[1:] for r in want], np.float64).mean(0)
    header = ["Image Num", "RMSE", "REL", "MAE", "Delta 1.05", "Delta 1.10",
              "Delta 1.25"]
    ok = (rows[0] == header and rows[1:-1] == want and rows[-1][0] == "MEAN"
          and np.array_equal(np.asarray(rows[-1][1:], np.float64), mean))
    log(f"trainer test: result/synthetic.csv {len(rows) - 2} rows and MEAN "
        f"{rows[-1][1:]}; {'equal to' if ok else 'NOT equal to'} the "
        f"metrics recomputed from a fresh trainer's eval outputs")
    if not ok:
        raise AssertionError(f"trainer test: CSV {rows} against {want}")
    return launches


def trainer_refine_phase(dev, workdir, ckpt_dir, profile=False):
    """Phase 22 (E): configs/train_refine.yaml through the CLI behind B's
    checkpoint: launches per step and eval frame, the stage-1 tensors bit
    for bit the checkpoint's; then DepthCompleter.from_checkpoint on both
    checkpoints serves a 480x640 frame, input depth bit for bit."""
    from implicit_depth_torch.builder import build_lidf
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.train.checkpoint import restore_params_only

    tr, launches = counted(lambda: cli(dev, "refine", workdir / "e",
                                       f"lidf_ckpt_path={ckpt_dir}",
                                       *REFINE_TRAINER_SET))
    recs = epoch_records(tr)
    frames = len(tr.make_valid_loaders()["synthetic"].dataset)
    expect_launches("trainer stage 2", launches, tr.steps_per_epoch, frames,
                    EXPECT_PER_REFINE_STEP, EXPECT_PER_FRAME)
    if not all(np.isfinite(v) for v in recs[-1]["train"].values()):
        raise AssertionError(f"trainer stage 2: {recs}")
    saved = restore_params_only(ckpt_dir, build_lidf(tr.cfg, tr.static))
    assert_same_tensors("trainer stage 2: the frozen stage 1 against its "
                        "checkpoint", {k: v.cpu() for k, v in
                                       tr.lidf_model.state_dict().items()},
                        saved.state_dict())
    step_ms = trainer_step_ms(tr, recs[-1])
    log(f"trainer stage 2: step time {step_ms:.1f} ms, losses "
        f"{recs[-1]['train']}, valid {recs[-1].get('valid')}")
    out = {"step_ms": step_ms, "launches": launches}
    if profile:
        from implicit_depth_torch.train.trainer import to_device
        batch = to_device(next(iter(tr.train_loader.epoch(1))), tr.device)
        out["step_device_ms"] = profile_device_ms(
            lambda: tr.train_step(tr.state, batch, tr.generator, 1),
            "trainer stage 2: device time of one step")
    dc = DepthCompleter.from_checkpoint(ckpt_dir, tr.ckpt_dir, cfg=tr.cfg,
                                        device=dev)
    rgb, depth, intr = make_frames(1, FRAME_HW)[0]
    got = dc.complete(rgb, depth, intr)
    have = depth != 0
    same = got["depth"][have].tobytes() == depth[have].tobytes()
    log(f"trainer stage 2: a {FRAME_HW[0]}x{FRAME_HW[1]} frame served from "
        f"both checkpoints; input depth {'bit for bit' if same else 'CHANGED'}"
        f", finite {bool(np.isfinite(got['depth']).all())}")
    if not (same and np.isfinite(got["depth"]).all()):
        raise AssertionError("trainer stage 2: the served frame")
    return out


def trainer_phases(dev, profile=False):
    """Phases 18-25 (see the module doc) in a temporary directory. Returns
    {kernel: its trainer record} for the kernels line, and the step times."""
    import os
    import tempfile

    os.environ["IDT_TIMING"] = "1"  # the trainer logs its epoch's phases
    with tempfile.TemporaryDirectory() as d, cudnn_flags(
            deterministic=True, benchmark=False):
        workdir = pathlib.Path(d)
        loader = loader_phase(dev, workdir / "loader")
        a = trainer_batch32_phase(dev, workdir, profile)
        b, b_launches = trainer_stage1_phase(dev, workdir)
        d_launches = trainer_test_phase(dev, workdir, b.ckpt_dir)
        e = trainer_refine_phase(dev, workdir, b.ckpt_dir, profile)
        dp_rows, dp_times = parallel_phases(dev, workdir, b.ckpt_dir)
    per_step = {k: per for k, per in EXPECT_PER_STEP.items()}
    rows = {}
    for name in counters():
        rows[name] = {
            "launches": {"batch32": a["launches"][name],
                         "stage1": b_launches[name], "test": d_launches[name],
                         "stage2": e["launches"][name]},
            "launches_per_step": per_step.get(name, 0),
            "launches_per_eval_frame": EXPECT_PER_EVAL_FRAME.get(name, 0),
            "launches_per_stage2_step": EXPECT_PER_REFINE_STEP.get(name, 0),
            "data_parallel": dp_rows[name]}
        if name in a["kernels"]:
            rows[name]["batch32"] = a["kernels"][name]
    times = {"loader": loader, "batch32_step_ms": a["step_ms"],
             "batch32_peak_gib": a["peak_gib"],
             "batch32_step_device_ms": a.get("step_device_ms"),
             "batch4_step_ms": a["batch4_step_ms"],
             "stage2_step_ms": e["step_ms"],
             "stage2_step_device_ms": e.get("step_device_ms"),
             "data_parallel": dp_times}
    return rows, times


# -- the decoders' other widths (phases 26-29) ------------------------------
# the widths of configs/smoke_synthetic.yaml and of both convergence configs
# (imnet_gf 32: decoders 128-64-32-1, pnet_out 64, rgb_out 16) and of the
# tiny CLI model (imnet_gf 8: 32-16-8-1, pnet_out 16, rgb_out 8), at the
# smoke config's 120x160 frame (19,200 rays) and 2,048 training rays an image
# (8,192 a step of batch 4)
WIDTH_MODELS = {
    32: {"model": {"rgb_out": 16, "pnet_out": 64, "pnet_gf": 16,
                   "imnet_gf": 32},
         "refine": {"pnet_out": 64, "pnet_gf": 16, "imnet_gf": 32}},
    8: {"model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8},
        "refine": {"pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8}}}
WIDTH_HW = (120, 160)
WIDTH_TRAIN = {"dataset": {"img_height": WIDTH_HW[0],
                           "img_width": WIDTH_HW[1]},
               "grid": {"miss_sample_num": 2048, "valid_sample_num": 2048}}
WIDTH_FRAMES = 2
# bf16 tolerances at these widths: (K1, K4 and K6; K2's outputs). The
# randomized decoders' outputs spread less than at imnet_gf 64 (a served
# frame's K1 std 0.020 at 32 and 0.035 at 8, K6's dense 0.018 and 0.032;
# the training step's logit 0.012 and 0.0029), so the default width's
# tolerances would not bite. Measured on an H100, the largest |kernel -
# plain| of these calls: at 32, K1 5.8e-4, K4 6.5e-4, K6 5.9e-4, K2's
# outputs 5.2e-4; at 8, K1 1.07e-3, K4 1.40e-3, K6 1.07e-3, K2's outputs
# 1.6e-4 (K2 'all''s offset). Each tolerance is twice the largest
# reading (at 8, 1.8x for K2's outputs) and BITE times below the spread; f32
# keeps 1e-5 (readings ~1e-7), K3 its relative 2e-2 (readings 2.8e-3 and
# 3.7e-3)
WIDTH_BF16_TOL = {32: (1.3e-3, 1e-3), 8: (2.8e-3, 2.8e-4)}


def width_tols(g):
    """TOL and TRAIN_TOL with the bf16 tolerances of WIDTH_BF16_TOL[g]."""
    serve, out = WIDTH_BF16_TOL[g]
    bf = torch.bfloat16
    return {**TOL, **TRAIN_TOL,
            **{(name, bf): serve
               for name in ("ray_decode", "ief_decode", "pair_decode")},
            ("ray_decode_save_out", bf): out}

# each K3 instance with the decode_bwd mode whose steps launch it
WIDTH_TRAIN_MODES = (("kernel_save", EXPECT_PER_STEP),
                     ("kernel", EXPECT_PER_STEP_KERNEL),
                     ("kernel_save_all", EXPECT_PER_STEP_SAVE_ALL))
# what the kernels line keeps of a kernel's row at another width
WIDTH_KEYS = ("dtype", "shape", "max_abs_err", "tolerance", "max_rel_err",
              "worst", "tolerance_rel", "ms", "plain_ms", "library_ms",
              "bound_ms", "bound_by", "launches", "launches_per_frame",
              "launches_per_step", "passes", "rows_decoded", "ms_all_rows",
              "bound_ms_all_rows", "modes", "repeat_bit_identical")
# phases 27-29 on configs/smoke_synthetic.yaml at its own widths (imnet_gf
# 32), its test and chunked test, and configs/convergence_refine.yaml
# behind its checkpoint, cut to one epoch of 2 steps
CONV_REFINE_SET = ["training.nepochs=1", "dataset.synthetic_len=8"]


def decoder_label(g):
    """The decoder widths of imnet_gf ``g``, as the kernels line names
    them."""
    return f"{4 * g}-{2 * g}-{g}-1"


def k3_repeats(recorded):
    """K3 twice on a recorded call: every gradient, d_vox_table included,
    the same bits (its fixed-order sums; no atomics)."""
    from implicit_depth_torch.ops import ray_decode as rd
    a, kw = recorded["ray_decode_bwd"]
    first, again = rd.ray_decode_bwd(*a, **kw), rd.ray_decode_bwd(*a, **kw)
    torch.cuda.synchronize()
    same = (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
            and all(torch.equal(first[2][k], again[2][k]) for k in first[2]))
    if not same:
        raise AssertionError("ray_decode_bwd: two calls on the same inputs "
                             "gave different bits")
    return True


def width_phase(dev, g):
    """Phase 26 at imnet_gf ``g`` (WIDTH_MODELS): the serving path's K1 and
    K4 and both decode modes' K6 on the calls recorded from a served
    120x160 frame, and K2, K2 'all' and K3's three instances on the calls
    recorded from a training step in each decode_bwd mode, each against
    its plain version in bf16 and f32 at ``width_tols(g)``, with the
    launches of WIDTH_FRAMES frames and
    TRAIN_STEPS steps at this width; K3 twice on each recorded call, the
    same bits. Returns {kernel: its bf16 row}."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter

    label = decoder_label(g)
    log(f"widths {label}: imnet_gf {g}, {WIDTH_MODELS[g]}")
    serve = {"mask_type": "all",
             "dataset": {"img_height": WIDTH_HW[0], "img_width": WIDTH_HW[1]},
             **WIDTH_MODELS[g]}
    frames = make_frames(WIDTH_FRAMES + 1, WIDTH_HW)
    cfg = load_config(overrides=serve)
    lidf, refine = build_models(cfg)
    dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
    tols = width_tols(g)
    rows = kernel_phase(record_calls(kernel_modules(),
                                     lambda: dc.complete(*frames[0])),
                        lidf, refine, dev, tols)
    launches, _ = main_path(dc, frames[1:], cfg, label=f"widths {label}")
    for name, n in launches.items():
        add_launches(rows[name], n, WIDTH_FRAMES, "frame")
    del rows["segment_max0"], dc, lidf, refine  # K5 has no decoder width
    modes = {}
    for mode in MODES:
        cfg_m = load_config(overrides=mode_overrides(serve, mode))
        lidf, refine = build_models(cfg_m)
        dc = DepthCompleter(cfg_m, lidf=lidf, refine=refine, device=dev)
        recorded = record_calls(
            {"pair_decode": kernel_modules()["pair_decode"]},
            lambda: dc.complete(*frames[0]))
        row = pair_kernel_rows(recorded, lidf, dev, tols)
        launches, _ = main_path(dc, frames[1:], cfg_m, EXPECT_PER_MODE_FRAME,
                                f"widths {label}, {mode} mode")
        modes[mode] = add_launches(row, launches["pair_decode"], WIDTH_FRAMES,
                                   "frame")
        del dc, lidf, refine
    row = dict(max(modes.values(), key=lambda r: np.prod(r["shape"][1])))
    row["modes"] = {m: {k: r[k] for k in WIDTH_KEYS if k in r}
                    for m, r in modes.items()}
    row["launches"] = sum(r["launches"] for r in modes.values())
    rows["pair_decode"] = row
    torch.cuda.empty_cache()
    train = {**WIDTH_TRAIN, **WIDTH_MODELS[g]}
    for decode_bwd, expect in WIDTH_TRAIN_MODES:
        cfg_t, model = train_mode_model(dev, train, decode_bwd)
        recorded, launches, _ = train_path(cfg_t, model, dev, expect=expect)
        del model
        torch.cuda.empty_cache()
        if decode_bwd == "kernel_save":
            got = train_kernel_phase(recorded, tols)
            fwd = "ray_decode_save"
            bwd = "ray_decode_bwd"
        elif decode_bwd == "kernel":
            got = {"ray_decode_bwd_recompute":
                   recompute_kernel_rows(recorded, tols)}
            fwd, bwd = None, "ray_decode_bwd_recompute"
        else:
            got = save_all_kernel_rows(recorded, tols)
            fwd, bwd = "ray_decode_save_all", "ray_decode_bwd_all"
        if fwd:
            add_launches(got[fwd], launches[fwd], TRAIN_STEPS, "step")
        add_launches(got[bwd], launches["ray_decode_bwd"], TRAIN_STEPS,
                     "step")
        got[bwd]["repeat_bit_identical"] = k3_repeats(recorded)
        log(f"widths {label}: {bwd} twice on the recorded call: the same "
            f"bits")
        rows.update(got)
        del recorded
        torch.cuda.empty_cache()
    return rows


def config_cli(dev, stage, workdir, *sets, make=False):
    """``implicit_depth_torch.main`` on ``dev`` with the config of ``stage``
    (TRAINER_CONFIGS) as it stands: ``--set`` only the log directory and
    ``sets``."""
    from implicit_depth_torch import main as cli_main
    argv = ["--device", dev.type, "--cfg_paths", TRAINER_CONFIGS[stage],
            "--set", f"base_log_dir={workdir}", "log_name=run", *sets]
    return (cli_main.make_trainer if make else cli_main.main)(argv)


def eval_batches(tr):
    """The batches of the trainer's validation split (its eval frames)."""
    return tr.make_valid_loaders()["synthetic"].steps_per_epoch()


def read_csv(tr):
    import csv
    import os
    with open(os.path.join(tr.result_dir, "synthetic.csv")) as f:
        return list(csv.reader(f))


def config_phases(dev):
    """Phases 27-29 (see the module doc) in a temporary directory, cuDNN
    deterministic. Returns {kernel: its launches in each run} and the runs'
    step times."""
    import tempfile

    from implicit_depth_torch.builder import build_lidf
    from implicit_depth_torch.train.checkpoint import restore_params_only
    from implicit_depth_torch.train.trainer import to_device

    out = {}
    with tempfile.TemporaryDirectory() as d, cudnn_flags(
            deterministic=True, benchmark=False):
        workdir = pathlib.Path(d)
        # 27: train, then test from the checkpoint
        tr, launches = counted(lambda: config_cli(dev, "smoke",
                                                  workdir / "smoke"))
        recs = epoch_records(tr)
        steps = tr.steps_per_epoch * len(recs)
        frames = sum(eval_batches(tr) for r in recs if "valid" in r)
        expect_launches("smoke config", launches, steps, frames,
                        EXPECT_PER_STEP, EXPECT_PER_EVAL_FRAME)
        losses = [v for r in recs for v in (*r["train"].values(),
                                            *r.get("valid", {}).get(
                                                "synthetic", {}).values())]
        if len(recs) != tr.cfg.training.nepochs or not all(
                np.isfinite(losses)):
            raise AssertionError(f"smoke config: records {recs}")
        log(f"smoke config: imnet_gf {tr.cfg.model.imnet_gf}, "
            f"{len(recs)} epochs of {tr.steps_per_epoch} steps, step times "
            f"{[trainer_step_ms(tr, r) for r in recs]} ms, train "
            f"{recs[-1]['train']}, valid {recs[-1].get('valid')}")
        out["smoke_train"] = {"launches": launches, "steps": steps,
                              "eval_frames": frames,
                              "step_ms": [trainer_step_ms(tr, r)
                                          for r in recs]}
        ckpt = tr.ckpt_dir
        test = ("exp_type=test", f"checkpoint_path={ckpt}")
        te, launches = counted(lambda: config_cli(dev, "smoke",
                                                  workdir / "test", *test))
        expect_launches("smoke config test", launches, 0, eval_batches(te),
                        {}, EXPECT_PER_EVAL_FRAME)
        one_shot = read_csv(te)
        out["smoke_test"] = {"launches": launches,
                             "eval_frames": eval_batches(te)}
        # 28: the test with the decode over chunks of a quarter of the rays
        rays = te.cfg.dataset.img_height * te.cfg.dataset.img_width
        chunk = rays // 4
        chunked = (*test, f"tpu.eval_rays_per_chunk={chunk}")
        tc, launches = counted(lambda: config_cli(dev, "smoke",
                                                  workdir / "chunked",
                                                  *chunked))
        per = expect_per_eval_frame(rays, chunk)
        expect_launches(f"smoke config test, {chunk} rays a chunk", launches,
                        0, eval_batches(tc), {}, per)
        if read_csv(tc) != one_shot:
            raise AssertionError("chunked test: its CSV differs from the "
                                 "one-shot test's")
        a = config_cli(dev, "smoke", workdir / "a", *test, make=True)
        b = config_cli(dev, "smoke", workdir / "b", *chunked, make=True)
        n_frames = 0
        for batch in a.make_valid_loaders()["synthetic"].epoch(0):
            db = to_device(batch, a.device)
            ia, oa, la = a.eval_step(a.state, db, a.generator)
            ib, ob, lb = b.eval_step(b.state, db, b.generator)
            assert_same_tensors("chunked eval against one shot",
                                {**oa, **{f"loss_{k}": v for k, v in
                                          la.items()}},
                                {**ob, **{f"loss_{k}": v for k, v in
                                          lb.items()}})
            n_frames += 1
        log(f"smoke config test, {chunk} rays a chunk: K1 "
            f"{per['ray_decode']} per eval frame; its CSV and every eval "
            f"output and loss of {n_frames} eval batches the bits of the "
            f"one-shot test")
        out["smoke_test_chunked"] = {"launches": launches, "chunk": chunk,
                                     "eval_frames": eval_batches(tc),
                                     "bit_identical": True}
        # 29: stage 2 behind the smoke run's checkpoint
        tr2, launches = counted(lambda: config_cli(
            dev, "conv_refine", workdir / "refine", f"lidf_ckpt_path={ckpt}",
            *CONV_REFINE_SET))
        recs = epoch_records(tr2)
        frames = sum(eval_batches(tr2) for r in recs if "valid" in r)
        expect_launches("convergence_refine config", launches,
                        tr2.steps_per_epoch * len(recs), frames,
                        EXPECT_PER_REFINE_STEP, EXPECT_PER_FRAME)
        if not all(np.isfinite(v) for r in recs for v in r["train"].values()):
            raise AssertionError(f"convergence_refine config: {recs}")
        saved = restore_params_only(ckpt, build_lidf(tr2.cfg, tr2.static))
        assert_same_tensors("convergence_refine config: the frozen stage 1 "
                            "against its checkpoint",
                            {k: v.cpu() for k, v in
                             tr2.lidf_model.state_dict().items()},
                            saved.state_dict())
        log(f"convergence_refine config: refine imnet_gf "
            f"{tr2.cfg.refine.imnet_gf}, {tr2.steps_per_epoch} steps, step "
            f"time {trainer_step_ms(tr2, recs[-1]):.1f} ms, train "
            f"{recs[-1]['train']}, valid {recs[-1].get('valid')}")
        out["conv_refine"] = {"launches": launches,
                              "steps": tr2.steps_per_epoch * len(recs),
                              "eval_frames": frames,
                              "step_ms": trainer_step_ms(tr2, recs[-1])}
    return out


# -- data-parallel training across processes (phases 23-25) -----------------
# each rank a process of ``python -m implicit_depth_torch.main`` (through
# RANK_LAUNCHER) with torchrun's variables set by hand; gloo puts both ranks
# on this card, as NCCL refuses to
DP_WORLD = 2
DP_TIMEOUT_S = 300
# 23 and 24: f32, global batch 4 (2 a rank), one epoch of 2 steps
DP_SET = ["training.batch_size=4", "dataset.synthetic_len=8",
          "training.nepochs=1", "training.do_valid=False",
          "tpu.compute_dtype=float32"]
# 23 cuts the ResNet's depth to one block a stage (the width stays). At
# full depth f32 summation order alone, amplified by the backward of 33
# train-mode batch norms and turned by Adam into flipped steps, takes the
# run past the bounds of assert_params_close: on an H100
# (scripts/dp_noise_floor.py), after this phase's 2 steps, one process
# against itself (cuDNN's deterministic algorithms against PyTorch's own
# convolutions) put 67 of 248 tensors past them (the worst at 11.4x its
# outlier limit), 2 ranks against one process 62 (9.9x); at one block a
# stage 0 (0.70) and 0 (0.50)
DP_STAGE1_DEPTH = ["model.resnet_stages=[1, 1, 1, 1]"]
# 25: bf16 (the config's), 2 samples a rank, 2 epochs of DP_TIME_STEPS
# steps; the second epoch's time per step
DP_TIME_STEPS = 3
DP_TIME_SET = ["training.nepochs=2", "training.do_valid=False"]
# a rank: cuDNN's deterministic algorithms and no TF32, as the trainer
# phases run, its kernels' launches counted from 0, each gradient
# all-reduce timed between two device synchronizations; writes both to
# the JSON file argv[1] after the CLI (argv[2:]) has run
RANK_LAUNCHER = r"""
import json, runpy, sys, time
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from implicit_depth_torch.parallel import mesh

counts = chip_smoke.counters()
for fn in counts.values():
    fn.launches = 0
allreduce_ms, real = [], mesh.all_reduce_grads


def timed(params):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    real(params)
    torch.cuda.synchronize()
    allreduce_ms.append((time.perf_counter() - t0) * 1e3)


timed.calls = 0  # all_reduce_grads counts through its global name
mesh.all_reduce_grads = timed
out = sys.argv[1]
sys.argv = ["implicit_depth_torch.main", *sys.argv[2:]]
runpy.run_module("implicit_depth_torch.main", run_name="__main__")
with open(out, "w") as f:
    json.dump({"launches": {k: fn.launches for k, fn in counts.items()},
               "allreduce_ms": allreduce_ms}, f)
"""


def start_ranks(workdir, stage, sets, world=DP_WORLD, backend="gloo",
                device="cuda:0"):
    """Starts ``world`` ranks of the CLI on the config of ``stage``, rank r
    logging under ``workdir/rank<r>`` (``device`` None: each rank on
    cuda:LOCAL_RANK), its output into ``workdir/out<r>.txt``; returns what
    :func:`finish_ranks` takes."""
    import os
    import socket

    workdir.mkdir(parents=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(world):
        argv = ["--cfg_paths", TRAINER_CONFIGS[stage], "--dist_backend",
                backend, *(["--device", device] if device else []), "--set",
                f"base_log_dir={workdir / f'rank{r}'}", "log_name=run",
                *TRAINER_SET, *sets]
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        with open(workdir / f"out{r}.txt", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_LAUNCHER,
                 str(workdir / f"counts{r}.json"), *argv],
                env=env, stdout=out, stderr=subprocess.STDOUT, cwd=ROOT))
    return workdir, procs


def finish_ranks(started):
    """Waits for the ranks of :func:`start_ranks`. Raises unless every rank
    exits 0 within DP_TIMEOUT_S, and if a rank other than 0 wrote a file
    (every rank still running is killed). Returns rank 0's workdir and each
    rank's {launches, allreduce_ms}."""
    workdir, procs = started
    try:
        for p in procs:
            p.wait(timeout=DP_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        out = (workdir / f"out{r}.txt").read_text()
        for line in out.splitlines():
            if line.startswith(("[rank", "[timing]")):
                log(f"  rank {r}: {line}")
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {len(procs)} exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
    wrote = [r for r in range(1, len(procs))
             if (workdir / f"rank{r}").exists()]
    if wrote:
        raise AssertionError(f"ranks {wrote} wrote files")
    ranks = [json.loads((workdir / f"counts{r}.json").read_text())
             for r in range(len(procs))]
    return workdir / "rank0" / "run", ranks


def saved_state(run_dir):
    return torch.load(run_dir / "ckpt" / "latest_network" / "state.pt",
                      weights_only=True)["model"]


def assert_params_close(label, got, want, frac=0.995, atol_bulk=5e-4,
                        atol_max=5e-3):
    """The bounds of the JAX package's two-process test
    (tests/test_multiprocess.py::_assert_params_close): every element
    within ``atol_max``, at most 0.5% (at least 3) of a tensor's elements
    outside ``atol_bulk`` + 5e-3 of the value. Adam turns float
    reassociation into a full step on the odd element whose gradient sits
    near zero."""
    worst = 0.0
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs()
        worst = max(worst, d.max().item())
        bad = int((d > atol_bulk + w.double().abs() * 5e-3).sum())
        limit = max(3, int((1 - frac) * d.numel()))
        if d.max() >= atol_max or bad > limit:
            raise AssertionError(f"{label}: {k} max |diff| {d.max():.2e}, "
                                 f"{bad}/{d.numel()} outside (limit {limit})")
    log(f"{label}: {len(want)} tensors within the bounds, largest "
        f"|difference| {worst:.3g}")


def compare_losses(label, got_recs, want_recs):
    """Each epoch's train means (epoch_time_s aside) rtol 1e-3, atol 1e-5."""
    for got, want in zip(got_recs, want_recs, strict=True):
        for k, v in want["train"].items():
            if k != "epoch_time_s" and not np.isclose(
                    got["train"][k], v, rtol=1e-3, atol=1e-5):
                raise AssertionError(f"{label}: epoch {want['epoch']} {k} "
                                     f"{got['train'][k]} against {v}")
    log(f"{label}: the ranks' losses {got_recs[-1]['train']}, one "
        f"process's {want_recs[-1]['train']}")


def dp_start(workdir, stage, sets, world=DP_WORLD, backend="gloo",
             device="cuda:0", repeat=False):
    """The ranks of a :func:`dp_phase`, started: one group, with ``repeat``
    two (the second for the bit-for-bit repeat; every kernel on the path
    is deterministic, so groups may run side by side)."""
    return [start_ranks(workdir / name, stage, sets, world=world,
                        backend=backend, device=device)
            for name in ("two", "again")[:1 + repeat]]


def stop_ranks(started):
    """Kills every rank of ``started`` (groups of :func:`start_ranks`)
    still running."""
    for _, procs in started:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def dp_phase(dev, workdir, stage, sets, per_step, label, started):
    """Phases 23 and 24: ``stage`` through the CLI on the ranks ``started``
    (:func:`dp_start`) against one process on the same global batch, run
    here meanwhile (losses, parameters, launches per rank per step, only
    rank 0 writing); a second group, bit for bit the first. Returns each
    rank's launches."""
    one = cli(dev, stage, workdir / "one", *sets)
    run_dir, ranks = finish_ranks(started[0])
    for r, rk in enumerate(ranks):
        expect_launches(f"{label} rank {r}", rk["launches"],
                        one.steps_per_epoch, 0, per_step, {})
    compare_losses(label, epoch_log(run_dir / "epoch_log.jsonl"),
                   epoch_records(one))
    want = saved_state(pathlib.Path(one.workdir))
    got = saved_state(run_dir)
    assert_params_close(f"{label}: parameters against one process", got, want)
    if len(started) > 1:
        again, _ = finish_ranks(started[1])
        assert_same_tensors(f"{label}: a second run of the ranks", got,
                            saved_state(again))
    return [rk["launches"] for rk in ranks]


def dp_timing_phase(workdir, init):
    """Phase 25: bf16 stage-1 step time of DP_WORLD gloo ranks on this card
    against one rank (an NCCL group of one, so that NCCL's init and
    all-reduce run) at the same 2 samples a rank, and each rank's gradient
    all-reduce time."""
    per_rank = 2
    out = {}
    for world, backend, device in ((DP_WORLD, "gloo", "cuda:0"),
                                   (1, "nccl", None)):
        sets = [*DP_TIME_SET, f"training.batch_size={per_rank * world}",
                f"dataset.synthetic_len={per_rank * world * DP_TIME_STEPS}",
                f"checkpoint_path={init}"]
        run_dir, ranks = finish_ranks(start_ranks(
            workdir / f"time{world}", "lidf", sets, world=world,
            backend=backend, device=device))
        rec = epoch_log(run_dir / "epoch_log.jsonl")[-1]
        out[world] = {
            "backend": backend,
            "step_ms": rec["train"]["epoch_time_s"] * 1e3 / DP_TIME_STEPS,
            "allreduce_ms": [statistics.median(rk["allreduce_ms"]
                                               [-DP_TIME_STEPS:])
                             for rk in ranks]}
    log(f"data parallel, bf16 stage 1 at {per_rank} samples a rank (second "
        f"epoch): {DP_WORLD} gloo ranks on one card {out[DP_WORLD]['step_ms']:.1f}"
        f" ms a step, gradient all-reduce (median, between device syncs) "
        f"{out[DP_WORLD]['allreduce_ms']} ms per rank; 1 rank (NCCL group "
        f"of one) {out[1]['step_ms']:.1f} ms a step, all-reduce "
        f"{out[1]['allreduce_ms']} ms. Gloo on one card goes through the "
        f"host: not what NCCL on two cards costs")
    return out


def parallel_phases(dev, workdir, stage1_ckpt):
    """Phases 23-25 (see the module doc). Returns {kernel: {phase: [launches
    of each rank]}} and phase 25's times."""
    sets1 = [*DP_SET, *DP_STAGE1_DEPTH]
    init1 = unit_scale_checkpoint("lidf", sets1, workdir / "dp_init1")
    runs = {"dp_stage1": (workdir / "dp1", "lidf",
                          [*sets1, f"checkpoint_path={init1}"],
                          EXPECT_PER_STEP, True),
            "dp_stage2": (workdir / "dp2", "refine_hardneg",
                          [*DP_SET, f"lidf_ckpt_path={stage1_ckpt}"],
                          EXPECT_PER_REFINE_STEP, False)}
    launches = {}
    # both phases' ranks start together, each phase's one process then
    # runs beside them
    torch.cuda.empty_cache()
    started = {}
    try:
        for name, (d, stage, sets, _, repeat) in runs.items():
            started[name] = dp_start(d, stage, sets, repeat=repeat)
        for name, (d, stage, sets, per_step, _) in runs.items():
            launches[name] = dp_phase(dev, d, stage, sets, per_step,
                                      f"data parallel {name}", started[name])
    finally:
        stop_ranks([g for groups in started.values() for g in groups])
    init = unit_scale_checkpoint("lidf", DP_TIME_SET, workdir / "dp_init")
    times = dp_timing_phase(workdir / "dp_time", init)
    if torch.cuda.device_count() >= DP_WORLD:
        for name, (d, stage, sets, per_step, _) in runs.items():
            d = d.with_name(d.name + "_nccl")
            group = dp_start(d, stage, sets, backend="nccl", device=None)
            try:
                launches[f"{name}_nccl"] = dp_phase(
                    dev, d, stage, sets, per_step,
                    f"data parallel {name} NCCL on {DP_WORLD} cards", group)
            finally:
                stop_ranks(group)
    else:
        log(f"nccl_2card: not run ({torch.cuda.device_count()} card)")
    rows = {k: {name: [rk[k] for rk in ranks]
                for name, ranks in launches.items()}
            for k in counters()}
    return rows, times


# -- the mesh's rays axis (phases 30-32) -------------------------------------
# 30-31: RAYS_WORLD gloo ranks on this card at data 1 x rays 2, each a
# process of RAYS_LAUNCHER running rays_rank; 32: DepthCompleter on a grid
RAYS_WORLD = 2
RAYS_BATCH = 1          # the global batch of the bare steps: data 1 x rays 2
RAYS_STEPS = 2
# 30's ray slots an image, cut from 20,000: the synthetic training images
# hold 800-7,066 corrupted pixels (the ray window's), so of 20,000 slots
# the second rank's block would hold no ray, and no tolerance could bite on
# its constant outputs. The warm-up step's image holds 5,673; at 4,000
# slots the second block's rays (slots 2,000-3,999) met few occupied
# voxels and K4's outputs there spread 8.3e-4, below what its tolerance
# can bite on (H100); 2,000 slots give each rank 1,000 rays of the window's
# start
RAYS_GRID_SET = {"grid": {"miss_sample_num": 2000}}
RAYS_TIMEOUT_S = 400
# 31: configs/test_lidf.yaml from phase 30's unit-scale checkpoint
RAYS_TEST_SET = ["dataset.synthetic_len=4"]
RAYS_GRID_FRAMES = 2
# per served frame on a 1 x 2 grid of one card: K1 (or K6) once a device,
# the stage-1 PointNet's 2 pools a device, the RefineNet on the first
# device as on one card
EXPECT_PER_GRID_FRAME = {
    "per_ray": {"ray_decode": 2, "pair_decode": 0, "ief_decode": 2,
                "segment_max0": 12},
    "global": {"ray_decode": 0, "pair_decode": 2, "ief_decode": 2,
               "segment_max0": 12},
    "dense": {"ray_decode": 0, "pair_decode": 2, "ief_decode": 2,
              "segment_max0": 12}}
# a rank: cuDNN's deterministic algorithms and no TF32 (as the trainer
# phases run), joins the group from torchrun's variables on the card
# argv[3] (empty: cuda:LOCAL_RANK) under the backend argv[4], runs
# rays_rank(argv[1], argv[2]) and leaves the group
RAYS_LAUNCHER = r"""
import sys
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from implicit_depth_torch.parallel import mesh

mesh.init_from_env(sys.argv[3] or None, sys.argv[4],
                   timeout_s=chip_smoke.RAYS_TIMEOUT_S)
try:
    chip_smoke.rays_rank(sys.argv[1], sys.argv[2])
finally:
    mesh.shutdown()
"""


def rays_models(dev, f32=False):
    """Phase 6's stage-1 model (``f32``: in f32, one ResNet block a stage,
    as phase 23 cuts it) and its config, the seeded unit-scale weights."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config
    over = {**copy.deepcopy(TRAIN_OVERRIDES), **RAYS_GRID_SET}
    if f32:
        over.setdefault("tpu", {})["compute_dtype"] = "float32"
        over.setdefault("model", {})["resnet_stages"] = [1, 1, 1, 1]
    cfg = load_config(overrides=over)
    gen = torch.Generator().manual_seed(SEED + 1)
    model = randomize_weights_(build_lidf(cfg, build_static(cfg), gen), gen)
    return cfg, model.to(dev)


def rays_f32_step(dev):
    """One f32 stage-1 step (``rays_models(f32=True)``) of the global batch
    of RAYS_BATCH: the losses (the rank's shares) and the summed
    gradients."""
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step
    cfg, model = rays_models(dev, f32=True)
    state = TrainState.create(model, cfg.training, steps_per_epoch=1000)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = train_batches(1, cfg, RAYS_BATCH, dev)[0]
    losses = make_lidf_train_step(cfg, model, dev)(state, batch, gen, 0)
    return ({k: v.item() for k, v in losses.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()})


def rays_k1_rows(lidf, run, dev):
    """K1 on the calls ``run()`` gives the stage-1 model's decode, against
    ``ray_decode_plain`` in f32 (phase 3's tolerance; see rays_stage2)."""
    from implicit_depth_torch.models import lidf as lidf_mod
    from implicit_depth_torch.models.lidf import decoder_weights
    from implicit_depth_torch.ops import ray_decode as rd
    f32w = rd.prep_ray_decode_weights(
        decoder_weights(lidf.offset_dec, lidf.prob_dec), lidf.dims["c_vox"],
        lidf.dims["c_roi"], lidf.dims["c_dir"], lidf.multires, torch.float32)
    calls = record_calls({"ray_decode": (lidf_mod, "ray_decode")}, run)

    def as_f32(name, a):
        vt, cells, pos, rf, _ = a
        return vt.float(), cells, pos, rf.float(), f32w

    with torch.inference_mode():
        return forward_rows(calls, as_f32, dev,
                            dtypes=(torch.float32,))["ray_decode"]


def rays_eval(tr):
    """The validation and test of trainer ``tr`` (each eval frame's rays
    split over the ranks), with each kernel's launches from 0: returns
    (launches, every eval output, the median host-clock ms of an eval
    step, from its call to a device synchronization)."""
    outs, ms = [], []
    real = tr._eval

    def keep(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inputs, pred, losses = real(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(pred.detach().cpu())
        return inputs, pred, losses

    tr._eval = keep
    _, launches = counted(lambda: (tr.validate(0), tr.test()))
    tr._eval = real
    return launches, outs, statistics.median(ms)


def rays_stage2(dev):
    """Phase 13's stage-2 steps on this rank's block (refine_train_path:
    launches per step, every refine parameter moved, the frozen stage 1 bit
    for bit), the recorded calls of K1 (the frozen stage 1), K4 (its
    training entry, with its gradient) and K5 against their plain versions.
    K1's and K4's forwards are held in f32 only (tolerance 1e-5, which
    bites). In bf16, on an H100: K4's outputs on a block of 1,000 training
    rays (offsets near 0.25) spread 7e-4 to 9e-4, less than a bf16 ulp
    there, so that no bf16 tolerance can bite (on the CPU, 1e-3 to 8e-3 at
    batch 1 and 3; phase 13's check bites on its 80,000 rows through the
    window's padding slots, whose outputs stand apart), and K1 on a block
    of 2,000 rays differed from its plain version by 4.76e-3, past the
    serving frames' 4e-3. Returns the launches and the rows' errors."""
    from implicit_depth_torch.config import load_config
    cfg = load_config(overrides={**REFINE_OVERRIDES, **RAYS_GRID_SET})
    lidf, refine = (m.to(dev) for m in build_models(cfg, train=True))
    run = {}
    k1 = rays_k1_rows(lidf, lambda: run.update(refine_train_path(
        cfg, lidf, refine, dev, TRAIN_STEPS)), dev)
    k4 = refine_k4_row(run["recorded"], dev, dtypes=(torch.float32,))
    k5 = segment_train_phase(
        {k: v for k, v in run["recorded"].items() if k[0] == "segment_max0"},
        dev)
    return {"launches": run["launches"],
            "rows": {name: {"max_abs_err": r["max_abs_err"],
                            "shape": r["shape"], "dtype": r["dtype"]}
                     for name, r in (("ray_decode", k1), ("ief_decode", k4),
                                     ("segment_max0", k5))}}


def rays_rank(out_path, workdir):
    """One rank of phases 30-31, writing its results to ``out_path``
    (torch.save): bf16 stage-1 and stage-2 steps of the full model on the
    rank's block of the rays (TRAIN_STEPS steps a stage, launches per step
    counted, each kernel's recorded calls on the block against its plain
    version), one f32 step for the comparison with one process, then the
    validation and test of configs/test_lidf.yaml through the CLI's
    trainer."""
    from implicit_depth_torch.parallel import mesh
    global TRAIN_BATCH, TRAIN_STEPS
    TRAIN_BATCH, TRAIN_STEPS = RAYS_BATCH, RAYS_STEPS
    dev = torch.device("cuda", torch.cuda.current_device())
    lay = mesh.use_layout(RAYS_BATCH)
    log(f"rays rank {mesh.rank()}: layout data {lay.data} x rays {lay.rays} "
        f"at data {lay.data_index}, rays {lay.ray_index}")
    out = {"layout": (lay.data, lay.rays, lay.data_index, lay.ray_index)}
    # -- 30: bf16 stage 1 ---------------------------------------------------
    cfg, model = rays_models(dev)
    recorded, launches, step_ms = train_path(cfg, model, dev)
    rows = train_kernel_phase(recorded)
    rows["segment_max0"] = segment_train_phase(recorded["segment_max0"], dev)
    out["stage1"] = {"launches": launches, "step_ms": step_ms,
                     "rows": {k: {"max_abs_err": r["max_abs_err"],
                                  "shape": r["shape"]}
                              for k, r in rows.items()}}
    del model, recorded
    torch.cuda.empty_cache()
    # -- 30: bf16 stage 2 ----------------------------------------------------
    out["stage2"] = rays_stage2(dev)
    torch.cuda.empty_cache()
    # -- 30: f32 against one process -------------------------------------
    out["f32"] = rays_f32_step(dev)
    torch.cuda.empty_cache()
    # -- 31: validation and the test CSV through the CLI's trainer --------
    tr = cli(dev, "test", pathlib.Path(workdir) / f"rank{mesh.rank()}",
             f"checkpoint_path={pathlib.Path(workdir) / 'ckpt'}",
             *RAYS_TEST_SET, make=True)
    out["eval"] = rays_eval(tr)
    torch.save(out, out_path)


def rays_one_step_ms(dev):
    """Median host-clock ms of phase 30's bf16 stage-1 step in one process
    (no group): RAYS_STEPS steps of RAYS_BATCH image after a warm-up."""
    global TRAIN_BATCH, TRAIN_STEPS
    saved = TRAIN_BATCH, TRAIN_STEPS
    TRAIN_BATCH, TRAIN_STEPS = RAYS_BATCH, RAYS_STEPS
    try:
        cfg, model = rays_models(dev)
        _, _, step_ms = train_path(cfg, model, dev)
    finally:
        TRAIN_BATCH, TRAIN_STEPS = saved
    del model
    torch.cuda.empty_cache()
    return statistics.median(step_ms)


def start_rays_ranks(workdir, device="cuda:0", backend="gloo"):
    """The RAYS_WORLD ranks of phases 30-31, started on ``device`` (None:
    rank r on cuda:r) under ``backend``."""
    import os
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(RAYS_WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(RAYS_WORLD),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        with open(workdir / f"out{r}.txt", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RAYS_LAUNCHER,
                 str(workdir / f"rank{r}.pt"), str(workdir), device or "",
                 backend],
                env=env, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT))
    return procs


def finish_rays_ranks(workdir, procs):
    """Each rank's results, after every rank exited 0 within
    RAYS_TIMEOUT_S (its kernel checks logged here)."""
    try:
        for p in procs:
            p.wait(timeout=RAYS_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = []
    for r, p in enumerate(procs):
        text = (workdir / f"out{r}.txt").read_text()
        for line in text.splitlines():
            if line.startswith(("kernel ", "rays ", "training", "stage 2")):
                log(f"  rank {r}: {line}")
        if p.returncode != 0:
            failed.append(f"rays rank {r} exited {p.returncode}:\n"
                          f"{text[-4000:]}")
    if failed:
        raise AssertionError("\n".join(failed))
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def rays_phases(dev, workdir, device="cuda:0", backend="gloo"):
    """Phases 30-31 (see the module doc): the ranks (on ``device`` under
    ``backend``, as :func:`start_rays_ranks`) run while this process takes
    the one-process references. Returns {kernel: {phase: [launches of each
    rank]}}."""
    workdir.mkdir(parents=True)
    unit_scale_checkpoint("test", RAYS_TEST_SET, workdir / "ckpt")
    # the one-process references first, so that the ranks' times are theirs
    with cudnn_flags(deterministic=True, benchmark=False):
        one_loss, one_grads = rays_f32_step(dev)
        tr = cli(dev, "test", workdir / "one",
                 f"checkpoint_path={workdir / 'ckpt'}", *RAYS_TEST_SET,
                 make=True)
        one_launches, one_outs, one_eval_ms = rays_eval(tr)
        one_step_ms = rays_one_step_ms(dev)
    torch.cuda.empty_cache()
    ranks = finish_rays_ranks(workdir, start_rays_ranks(workdir, device,
                                                        backend))
    for r, rk in enumerate(ranks):
        if rk["layout"] != (1, RAYS_WORLD, 0, r):
            raise AssertionError(f"rays rank {r}: layout {rk['layout']}")
        log(f"rays rank {r}: stage 1 launches {rk['stage1']['launches']} in "
            f"{RAYS_STEPS} steps, step_ms {rk['stage1']['step_ms']}; stage 2 "
            f"{rk['stage2']['launches']}; kernel rows on the block "
            f"{rk['stage1']['rows']}, {rk['stage2']['rows']}")
    # f32: the ranks' shares summed against one process, each rank's
    # summed gradient against its gradient (phase 8's limits)
    loss, grads = ranks[0]["f32"]
    for k, v in one_loss.items():
        got = sum(rk["f32"][0][k] for rk in ranks)
        if not np.isclose(got, v, rtol=XCHECK_LOSS_RTOL, atol=1e-6):
            raise AssertionError(f"rays f32: {k} {got} against one "
                                 f"process's {v}")
    # a gradient that cancels (a decoder's last bias) is measured against a
    # thousandth of the largest gradient's norm
    floor = 1e-3 * max(g.double().norm().item() for g in one_grads.values())
    worst = ("", 0.0)
    for n, g in one_grads.items():
        e = rel_norm(grads[n], g, floor)
        tol = XCHECK_RESNET_RTOL if n.startswith("resnet") else \
            XCHECK_GRAD_RTOL
        if not (e <= tol and torch.isfinite(grads[n]).all()):
            raise AssertionError(f"rays f32: {n} relative error {e} > {tol}")
        worst = max(worst, (n, e), key=lambda x: x[1])
    log(f"rays f32 step ({RAYS_WORLD} ranks, data 1 x rays {RAYS_WORLD}) "
        f"against one process: losses {loss} (shares of rank 0), one "
        f"process {one_loss}; worst gradient {worst[0]} relative "
        f"{worst[1]:.3g}")
    # 31: launches per eval frame and rank, the outputs and the CSV
    frames = len(one_outs)
    per = {"ray_decode": 1, "segment_max0": 2}
    for r, rk in enumerate(ranks):
        launches, outs, _ = rk["eval"]
        expect_launches(f"rays validation and test, rank {r}", launches, 0,
                        frames, {}, per)
        if len(outs) != frames or not all(
                torch.equal(a, b) for a, b in zip(outs, one_outs)):
            raise AssertionError(f"rays rank {r}: the eval outputs are not "
                                 "the bits of one process's")
    expect_launches("rays validation and test, one process", one_launches,
                    0, frames, {}, per)
    csv_got = (workdir / "rank0" / "run" / "result" / "synthetic.csv")
    csv_want = pathlib.Path(tr.result_dir) / "synthetic.csv"
    if csv_got.read_bytes() != csv_want.read_bytes() or \
            (workdir / "rank1" / "run").exists():
        raise AssertionError("rays: rank 0's test CSV is not one process's, "
                             "or rank 1 wrote files")
    log(f"rays validation and test on {RAYS_WORLD} ranks: {frames} eval "
        f"frames, K1 once a frame and rank over "
        f"{tr.cfg.dataset.img_height * tr.cfg.dataset.img_width // RAYS_WORLD}"
        f" rays; every eval output and the CSV the bits of one process's")
    log(f"rays times (host clock to a device sync, median): an eval step "
        f"{[rk['eval'][2] for rk in ranks]} ms per rank against one "
        f"process's {one_eval_ms:.2f}; a bf16 stage-1 step of "
        f"{RAYS_BATCH} image {[statistics.median(rk['stage1']['step_ms']) for rk in ranks]}"
        f" ms per rank against one process's {one_step_ms:.2f}")
    out = {"stage1": [rk["stage1"]["launches"] for rk in ranks],
           "stage2": [rk["stage2"]["launches"] for rk in ranks],
           "eval": [rk["eval"][0] for rk in ranks]}
    return {k: {ph: [lc.get(k, 0) for lc in per_rank]
                for ph, per_rank in out.items()} for k in counters()}


def grid_phase(dev, grid=None):
    """Phase 32: DepthCompleter on a grid (default ``[[dev, dev]]``: data 1
    x rays 2 on this card) in the per_ray, ``global`` and dense modes: K1 /
    K6 on a device's block of the rays and K4 / K5 on the recorded calls
    of a frame against their plain versions, the launches per frame, the
    completed depth and the prediction the bits of one card's, frame_ms
    against one card. Returns {kernel: {mode: launches}} and the times."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter
    grid = grid or [[dev, dev]]
    label = ",".join(str(d) for d in grid[0])
    frames = make_frames(RAYS_GRID_FRAMES + 1, FRAME_HW)
    launches, times = {}, {}
    for mode in ("per_ray", "global", "dense"):
        over = (SERVE_OVERRIDES if mode == "per_ray"
                else mode_overrides(SERVE_OVERRIDES, mode))
        cfg = load_config(overrides=over)
        lidf, refine = build_models(cfg)
        one = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
        on_grid = DepthCompleter(cfg, lidf=lidf, refine=refine, mesh=grid)
        recorded = record_calls(kernel_modules(),
                                lambda: on_grid.complete(*frames[0]))
        if mode == "per_ray":
            rows = kernel_phase(recorded, lidf, refine, dev)
        else:
            rows = {"pair_decode": pair_kernel_rows(
                {k: v for k, v in recorded.items() if k[0] == "pair_decode"},
                lidf, dev)}
        log(f"rays grid {label} {mode}: kernels on a device's block "
            + "; ".join(f"{k} {r['shape']} max_abs_err {r['max_abs_err']:.3g}"
                        for k, r in rows.items()))
        outs, n = counted(lambda: [on_grid.complete(*f) for f in frames[1:]])
        expect_launches(f"rays grid {label} {mode}", n, 0, RAYS_GRID_FRAMES,
                        {}, EXPECT_PER_GRID_FRAME[mode])
        for (rgb, depth, intr), got in zip(frames[1:], outs):
            want = one.complete(rgb, depth, intr)
            if not all(np.array_equal(got[k], want[k])
                       for k in ("depth", "depth_pred")):
                raise AssertionError(f"rays grid {label} {mode}: the frame is "
                                     "not the bits of one card's")
            have = depth != 0
            if got["depth"][have].tobytes() != depth[have].tobytes():
                raise AssertionError(f"rays grid {label} {mode}: input depth "
                                     "not passed through")
        grid_ms = statistics.median(time_ms(lambda: on_grid.complete(*f),
                                            warmup=1, reps=3)
                                    for f in frames[1:])
        one_ms = statistics.median(time_ms(lambda: one.complete(*f),
                                           warmup=1, reps=3)
                                   for f in frames[1:])
        times[mode] = {"frame_ms": grid_ms, "one_card_frame_ms": one_ms}
        log(f"rays grid {label} {mode}: {RAYS_GRID_FRAMES} frames of "
            f"{FRAME_HW[0]}x{FRAME_HW[1]} the bits of one card's; frame_ms "
            f"{grid_ms:.2f} against one card {one_ms:.2f}")
        for k, v in n.items():
            launches.setdefault(k, {})[mode] = v
        del one, on_grid, lidf, refine
        torch.cuda.empty_cache()
    return launches, times


def add_launches(row, n, runs, unit):
    """``row`` with its kernel's ``n`` launches in a main path of ``runs``
    frames or steps (``unit``)."""
    row.update({"launches": n, f"launches_per_{unit}": n // runs})
    return row


# what the kernels line copies from each kernel's row
ENTRY_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms", "dtype", "shape", "tolerance",
              "typical_abs", "max_rel_err", "worst", "tolerance_rel",
              "launches_per_frame", "launches_per_step", "train", "modes",
              "kernel_device_ms", "library_device_ms", "device_ops_per_call",
              "by_shape", "passes", "step_ms", "save_bytes", "train_xla",
              "rows_decoded", "ptxas", "refine_train", "trainer", "decoder",
              "at_widths", "config_runs", "rays", "disk", "reference_ckpt",
              "options", "remat_lbfgs", "at_budgets", "at_model_widths",
              "profiled", "recompute_chunks", "launches_per_chunk",
              "rel_gap_to_index_put", "at_cell_shapes")


# -- the disk datasets (phases 33-35) -------------------------------------------
# the tree phase 33 writes: 8 train frames a source, 2 val and 2 test, at the
# published 480x640 (the mixed train split, 90% of each source: 14 frames)
DISK_COUNTS = {"n_train": 8, "n_val": 2, "n_test": 2}
DISK_HW = (480, 640)
DISK_SEED = 0
# the encoder's JPEGs against their scenes: the CPU tests hold it within 1 dB
# of cv2's quality-95 encode, which gives these scenes 43.3 dB
JPEG_MIN_PSNR = 40.0
# phase 34: train_lidf.yaml cut to one epoch at batch 4 (3 steps), each eval
# batch one frame; the hard-negative stage 2 at batch 6 (2 steps)
DISK_STAGE1_SET = ["training.batch_size=4", "training.nepochs=1",
                   "training.valid_batch_size=1"]
DISK_HARDNEG_SET = ["training.batch_size=6", "training.nepochs=1",
                    "training.valid_batch_size=1"]
DISK_SPLITS = ("synthetic_known", "synthetic_novel", "real_known",
               "real_novel")


def disk_cli(dev, config, root, workdir, *sets, make=False):
    """``implicit_depth_torch.main`` on a config of ``configs/`` as it
    stands, with ``--set`` for the dataset roots, the log directory and
    ``sets``."""
    from implicit_depth_torch import main as cli_main
    argv = ["--device", str(dev), "--cfg_paths", str(ROOT / "configs" / config),
            "--set", f"dataset.cleargrasp_root_dir={root / 'cleargrasp'}",
            f"dataset.omniverse_root_dir={root / 'omniverse'}",
            f"base_log_dir={workdir}", "log_name=run", *sets]
    return (cli_main.make_trainer if make else cli_main.main)(argv)


def psnr(a, b):
    err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(err, 1e-12)))


def disk_write_phase(root):
    """Phase 33: ``tools/make_disk_datasets.py`` writes the tree; every file
    reads back (EXR, PNG, HDF5, JSON, YAML exact, JPEG within
    JPEG_MIN_PSNR of its scene). Returns the JPEG decode times (ms)."""
    from implicit_depth_torch.data.exr import read_exr
    from implicit_depth_torch.data.hdf5 import read_hdf5
    from implicit_depth_torch.data.jpeg import read_jpeg
    from implicit_depth_torch.data.seg_io import imread_indexed
    from implicit_depth_torch.tools import make_disk_datasets as make

    t0 = time.perf_counter()
    n = make.write_tree(str(root), src_hw=DISK_HW, seed=DISK_SEED,
                        **DISK_COUNTS)
    write_s = time.perf_counter() - t0
    decode_ms, worst_psnr, bad = [], np.inf, []
    for path, want in make.tree_files(str(root), src_hw=DISK_HW,
                                      seed=DISK_SEED, **DISK_COUNTS):
        ext = pathlib.Path(path).suffix
        if ext == ".jpg":
            t0 = time.perf_counter()
            got = read_jpeg(path)[..., ::-1]
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            worst_psnr = min(worst_psnr, psnr(got, want))
            ok = got.shape == want.shape and psnr(got, want) >= JPEG_MIN_PSNR
        elif ext == ".png":
            ok = np.array_equal(imread_indexed(path), want)
        elif ext == ".exr":
            got = read_exr(path)
            ok = set(got) == set(want) and all(
                got[k].tobytes() == want[k].tobytes() for k in want)
        elif ext == ".h5":
            got = read_hdf5(path)
            ok = set(got) == set(want) and all(
                got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
                for k in want)
        elif ext == ".json":
            ok = json.load(open(path)) == want
        else:
            ok = open(path).read() == want
        if not ok:
            bad.append(path)
    log(f"disk tree: {n} files at {DISK_HW[0]}x{DISK_HW[1]} ({DISK_COUNTS}) "
        f"written in {write_s:.1f} s; every file read back ({len(bad)} "
        f"differ); JPEG decode {statistics.median(decode_ms):.1f} ms median "
        f"of {len(decode_ms)} ({min(decode_ms):.1f}-{max(decode_ms):.1f}), "
        f"worst PSNR against its scene {worst_psnr:.2f} dB")
    if bad:
        raise AssertionError(f"disk tree: files that do not read back: {bad}")
    return {"write_s": write_s, "files": n,
            "jpeg_decode_ms": statistics.median(decode_ms),
            "jpeg_worst_psnr_db": worst_psnr}


def disk_loader_phase(dev, root, workdir):
    """Host ms a sample of train_lidf.yaml's mixed train split on the tree
    (240x320, augmented), one thread."""
    tr = disk_cli(dev, "train_lidf.yaml", root, workdir, *DISK_STAGE1_SET,
                  make=True)
    ds = tr.train_loader.dataset
    t0 = time.perf_counter()
    for i in range(len(ds)):
        s = ds.__getitem__(i, 0)
        if not all(np.isfinite(v).all() for k, v in s.items()
                   if k != "item_path"):
            raise AssertionError(f"disk loader: sample {i} not finite")
    ms = (time.perf_counter() - t0) * 1e3 / len(ds)
    log(f"disk loader: {ms:.1f} ms a sample of the mixed train split "
        f"({len(ds)} samples, {s['rgb'].shape[0]}x{s['rgb'].shape[1]}, "
        f"augmented; one thread), beside phase 18's synthetic sample")
    return ms


class _Tee:
    """Standard output kept as well as shown (the trainer's ``[timing]``
    lines)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def feed_wait_of(text):
    import re
    m = re.search(r"\[timing\] rank 0 epoch \d+ feed_wait=([\d.]+)s "
                  r"dispatch=([\d.]+)s harvest=([\d.]+)s", text)
    if not m:
        raise AssertionError("no [timing] line from the trainer")
    return {k: float(v) for k, v in zip(("feed_wait_s", "dispatch_s",
                                         "harvest_s"), m.groups())}


def split_csvs(tr, fresh, label):
    """Every split's CSV of a test run against cleargrasp_metrics of the
    eval outputs of ``fresh`` (a trainer of the same config), split by split
    in the same order."""
    import csv
    import os

    from implicit_depth_torch.train.metrics import (
        cleargrasp_metrics,
        depth_images_from_outputs,
    )
    from implicit_depth_torch.train.trainer import to_device

    h, w = fresh.cfg.dataset.img_height, fresh.cfg.dataset.img_width
    loaders = fresh.make_valid_loaders()
    if tuple(loaders) != DISK_SPLITS:
        raise AssertionError(f"{label}: splits {list(loaders)}")
    means = {}
    for split, loader in loaders.items():
        want = []
        for batch in loader.epoch(0):
            inputs, pred, _ = fresh._eval(to_device(batch, fresh.device))
            depth = depth_images_from_outputs(inputs, pred, h, w)
            for i, path in enumerate(batch["item_path"]):
                m = cleargrasp_metrics(depth[i], batch["depth"][i],
                                       batch["corrupt_mask"][i])
                if m:
                    want.append([path, *(repr(m[k]) for k in (
                        "rmse", "abs_rel", "mae", "a1", "a2", "a3"))])
        with open(os.path.join(tr.result_dir, f"{split}.csv")) as f:
            rows = list(csv.reader(f))
        mean = np.asarray([r[1:] for r in want], np.float64).mean(0)
        if not (rows[1:-1] == want and rows[-1][0] == "MEAN" and np.array_equal(
                np.asarray(rows[-1][1:], np.float64), mean)):
            raise AssertionError(f"{label}: {split}.csv {rows} against {want}")
        means[split] = rows[-1][1:]
    log(f"{label}: CSVs of {list(means)}, each equal to the metrics "
        f"recomputed from a fresh trainer's eval outputs; MEAN RMSE "
        f"{ {k: float(v[0]) for k, v in means.items()} }")
    return means


def disk_trainer_phase(dev, root, workdir):
    """Phase 34: train_lidf.yaml, then train_refine_hardneg.yaml behind it,
    then test_lidf.yaml and test_refine.yaml, all from the tree."""
    import contextlib
    import os

    os.environ["IDT_TIMING"] = "1"
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        s1, l1 = counted(lambda: disk_cli(dev, "train_lidf.yaml", root,
                                          workdir / "lidf", *DISK_STAGE1_SET))
    timing = feed_wait_of("".join(tee.lines))
    recs = epoch_records(s1)
    frames = sum(len(v.dataset) for v in s1.make_valid_loaders().values())
    expect_launches("disk stage 1", l1, s1.steps_per_epoch, frames,
                    EXPECT_PER_STEP, EXPECT_PER_EVAL_FRAME)
    if set(recs[-1]["valid"]) != set(DISK_SPLITS) or not all(
            np.isfinite(v) for v in recs[-1]["train"].values()):
        raise AssertionError(f"disk stage 1: {recs}")
    epoch_s = recs[-1]["train"]["epoch_time_s"]
    log(f"disk stage 1: {s1.steps_per_epoch} steps of batch 4, "
        f"{trainer_step_ms(s1, recs[-1]):.1f} ms a step; [timing] {timing} "
        f"of a {epoch_s:.2f} s epoch: feed_wait "
        f"{timing['feed_wait_s'] / epoch_s:.0%} of it; valid "
        f"{ {k: round(v['loss_net'], 4) for k, v in recs[-1]['valid'].items()} }")

    s2, l2 = counted(lambda: disk_cli(
        dev, "train_refine_hardneg.yaml", root, workdir / "hardneg",
        f"lidf_ckpt_path={s1.ckpt_dir}", *DISK_HARDNEG_SET))
    frames2 = sum(len(v.dataset) for v in s2.make_valid_loaders().values())
    expect_launches("disk stage 2 hard_neg", l2, s2.steps_per_epoch, frames2,
                    EXPECT_PER_REFINE_STEP, EXPECT_PER_FRAME)
    if not all(np.isfinite(v) for v in epoch_records(s2)[-1]["train"].values()):
        raise AssertionError(f"disk stage 2: {epoch_records(s2)}")

    t1, lt1 = counted(lambda: disk_cli(
        dev, "test_lidf.yaml", root, workdir / "test_lidf",
        f"checkpoint_path={s1.ckpt_dir}"))
    n_test = sum(len(v.dataset) for v in t1.make_valid_loaders().values())
    expect_launches("disk test_lidf", lt1, 0, n_test, {},
                    EXPECT_PER_EVAL_FRAME)
    m1 = split_csvs(t1, disk_cli(dev, "test_lidf.yaml", root,
                                 workdir / "test_lidf2",
                                 f"checkpoint_path={s1.ckpt_dir}", make=True),
                    "disk test_lidf")
    refine_sets = (f"checkpoint_path={s2.ckpt_dir}",
                   f"lidf_ckpt_path={s1.ckpt_dir}")
    t2, lt2 = counted(lambda: disk_cli(dev, "test_refine.yaml", root,
                                       workdir / "test_refine", *refine_sets))
    expect_launches("disk test_refine", lt2, 0, n_test, {}, EXPECT_PER_FRAME)
    m2 = split_csvs(t2, disk_cli(dev, "test_refine.yaml", root,
                                 workdir / "test_refine2", *refine_sets,
                                 make=True), "disk test_refine")
    launches = {k: {"stage1": l1[k], "hardneg": l2[k], "test_lidf": lt1[k],
                    "test_refine": lt2[k]} for k in l1}
    return {"stage1_step_ms": trainer_step_ms(s1, recs[-1]),
            "epoch_s": epoch_s, **timing, "test_lidf_mean": m1,
            "test_refine_mean": m2, "launches": launches}, s1, s2


def disk_complete_phase(dev, root, workdir, s1, s2):
    """Phase 35: ``tools/complete_depth.py`` on two frames of the tree (a
    port-written JPEG and its depth as a 16-bit PNG in millimetres): its
    PNG reads back as DepthCompleter.complete of the same arrays, bit for
    bit; launches per frame as a served frame."""
    import os

    from implicit_depth_torch.config import load_config, load_yaml
    from implicit_depth_torch.data.exr import exr_loader
    from implicit_depth_torch.data.png import read_png, write_png
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.tools import complete_depth as tool

    real = root / "cleargrasp" / "cleargrasp-dataset-test-val" / "real-val" / \
        "d415"
    cam = load_yaml((real / "camera_intrinsics.yaml").read_text())
    intr = [str(cam[k]) for k in ("fx", "fy", "cx", "cy")]
    cfg_path = os.path.join(s2.workdir, "config.yaml")
    cfg = load_config(cfg_path, overrides={"mask_type": "all"})
    dc = DepthCompleter.from_checkpoint(s1.ckpt_dir, s2.ckpt_dir, cfg=cfg,
                                        device=dev)
    frames, launches = 0, None
    for i in range(2):
        stem = f"{i:09d}"
        rgb_path = str(real / f"{stem}-transparent-rgb-img.jpg")
        depth_m = exr_loader(str(real / f"{stem}-transparent-depth-img.exr"),
                             1)
        depth_path = str(workdir / f"{stem}-depth.png")
        write_png(depth_path, np.round(depth_m * 1000.0).astype(np.uint16))
        out_path = str(workdir / f"{stem}-completed.png")
        argv = ["--lidf_ckpt", s1.ckpt_dir, "--refine_ckpt", s2.ckpt_dir,
                "--cfg_paths", cfg_path, "--rgb", rgb_path, "--depth",
                depth_path, "--out", out_path, "--device", str(dev),
                "--fx", intr[0], "--fy", intr[1], "--cx", intr[2],
                "--cy", intr[3]]
        _, n = counted(lambda: tool.main(argv))
        launches = n if launches is None else {k: launches[k] + n[k]
                                               for k in n}
        frames += 1
        got = read_png(out_path)
        rgb, depth = tool.load_rgb(rgb_path), tool.load_depth(depth_path)
        want = dc.complete(rgb, depth, tuple(float(v) for v in intr))["depth"]
        want = (want * 1000.0).astype(np.uint16)
        if got.dtype != np.uint16 or got.tobytes() != want.tobytes():
            raise AssertionError(f"complete_depth: {out_path} is not "
                                 "DepthCompleter.complete's depth")
        log(f"complete_depth: {stem} ({rgb.shape[0]}x{rgb.shape[1]} JPEG, "
            f"16-bit PNG depth, {int((depth == 0).sum())} missing pixels) "
            f"-> {out_path}: bit for bit DepthCompleter.complete's")
    expect_launches("complete_depth", launches, 0, frames, {},
                    EXPECT_PER_FRAME)
    loaded = [m for m in ("cv2", "PIL", "h5py") if sys.modules.get(m)]
    log(f"modules loaded of cv2, PIL, h5py: {loaded}")
    if loaded:
        raise AssertionError(f"the port loaded {loaded}")
    return launches


def disk_kernel_phase(dev, root, workdir):
    """K2, K3 and K5 on a train step of a batch of 4 of the tree's mixed
    train split, and K1, K4 and K5 on a served frame of its files (a
    port-written JPEG, its EXR depth and JSON camera), each against its
    plain version
    at phase 3's and phase 7's tolerances, with the seeded unit-scale
    weights of ``build_models``. Returns {kernel: row}."""
    from implicit_depth_torch.config import load_config, load_yaml
    from implicit_depth_torch.data.exr import exr_loader
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.tools import complete_depth as tool
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step
    from implicit_depth_torch.train.trainer import to_device

    tr = disk_cli(dev, "train_lidf.yaml", root, workdir, *DISK_STAGE1_SET,
                  make=True)
    cfg = tr.cfg
    batch = to_device(next(iter(tr.train_loader.epoch(0))), dev)
    model = build_models(cfg, train=True)[0].to(dev)
    state = TrainState.create(model, cfg.training, steps_per_epoch=1000)
    step = make_lidf_train_step(cfg, model, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    recorded = record_train_calls(step, state, batch, gen,
                                  cfg.tpu.decode_bwd)
    rows = train_kernel_phase(recorded)
    rows["segment_max0"] = segment_train_phase(recorded["segment_max0"], dev)
    log(f"disk kernels: a train step of batch {batch['rgb'].shape[0]} of the "
        f"tree's files, every kernel against its plain version")
    del recorded, model, state, step, tr
    torch.cuda.empty_cache()

    cfg_s = load_config(str(ROOT / "configs" / "test_refine.yaml"),
                        overrides={"mask_type": "all"})
    lidf, refine = build_models(cfg_s)
    dc = DepthCompleter(cfg_s, lidf=lidf, refine=refine, device=dev)
    val = root / "cleargrasp" / "cleargrasp-dataset-test-val"
    # a synthetic-val frame, held to BITE: its outputs spread enough
    scene = val / "synthetic-val" / "scene0"
    fov = json.loads((scene / "json-files" / "000000000-masks.json")
                     .read_text())["camera"]["field_of_view"]
    h, w = DISK_HW
    frame = (tool.load_rgb(str(scene / "rgb-imgs" / "000000000-rgb.jpg")),
             exr_loader(str(scene / "depth-imgs-rectified"
                            / "000000000-depth-rectified.exr"), 1),
             (w * 0.5 / np.tan(fov["x_axis_rads"] * 0.5),
              h * 0.5 / np.tan(fov["y_axis_rads"] * 0.5), w * 0.5, h * 0.5))
    served = kernel_phase(record_calls(kernel_modules(),
                                       lambda: dc.complete(*frame)),
                          dc.lidf, dc.refine, dev)
    log("disk kernels: a synthetic-val frame served from the tree's files, "
        "every kernel against its plain version")
    # the real-val frame phase 35 serves first: each kernel within its
    # tolerance; its outputs' spread is reported beside the tolerance, since
    # its missing depth can leave K1's logits less than BITE x its bf16
    # tolerance (0.036 against 0.04 with these weights)
    real = val / "real-val" / "d415"
    cam = load_yaml((real / "camera_intrinsics.yaml").read_text())
    frame = (tool.load_rgb(str(real / "000000000-transparent-rgb-img.jpg")),
             exr_loader(str(real / "000000000-transparent-depth-img.exr"), 1),
             tuple(float(cam[k]) for k in ("fx", "fy", "cx", "cy")))
    served_real = kernel_phase(record_calls(kernel_modules(),
                                            lambda: dc.complete(*frame)),
                               dc.lidf, dc.refine, dev, bite=False)
    log("disk kernels: a real-val frame served from the tree's files, every "
        "kernel within its tolerance; outputs' spread / tolerance: "
        + ", ".join(f"{n} {r['spread']:.3g} / {r['tolerance']}"
                    + (f" = {r['spread'] / r['tolerance']:.3g}"
                       if r["tolerance"] else " (exact)")
                    for n, r in sorted(served_real.items())))
    del dc, lidf, refine
    torch.cuda.empty_cache()
    return {"train": rows, "served": served, "served_real": served_real}


def disk_phases(dev):
    """Phases 33-35 in a temporary directory; returns their record and
    {kernel: launches}."""
    import tempfile
    with tempfile.TemporaryDirectory() as d, cudnn_flags(
            deterministic=True, benchmark=False):
        d = pathlib.Path(d)
        t0 = time.perf_counter()
        tree = disk_write_phase(d / "tree")
        tree["loader_ms"] = disk_loader_phase(dev, d / "tree", d / "loader")
        t33 = time.perf_counter() - t0
        kernel_rows = disk_kernel_phase(dev, d / "tree", d / "kernels")
        rec, s1, s2 = disk_trainer_phase(dev, d / "tree", d / "runs")
        t34 = time.perf_counter() - t0 - t33
        launches = rec.pop("launches")
        served = disk_complete_phase(dev, d / "tree", d, s1, s2)
        t35 = time.perf_counter() - t0 - t33 - t34
    for k in launches:
        launches[k]["complete_depth"] = served[k]
    seconds = {"33": round(t33, 1), "34": round(t34, 1), "35": round(t35, 1)}
    log(f"disk phases seconds {seconds}")
    rows = {}
    for part, by_name in kernel_rows.items():
        for name, row in by_name.items():
            rows.setdefault(name, {})[part] = {
                k: row[k] for k in ("max_abs_err", "tolerance", "spread",
                                    "ms", "plain_ms", "bound_ms", "shape",
                                    "dtype")
                if k in row}
    for name in launches:
        rows.setdefault(name, {})["launches"] = launches[name]
    return {**tree, **rec, "seconds": seconds}, rows


# -- the reference's checkpoints, the other decoders, remat and L-BFGS -------
# (phases 36-38)
# 36: reference-layout files of the default model (seeded unit-scale
# weights), their epoch and a metric scalar (a numpy value, as the
# reference's may be)
REF_META = {"epoch": 59, "xyz_err": 0.05}
REF_TEST_SET = ["dataset.synthetic_len=4"]
# 37: the configurations the kernels do not take, each in both stages; the
# JAX package decodes them in XLA, the port in plain torch: K5 alone runs
OPTION_SETS = {"imnet": {"model": {"offdec_type": "IMNET"},
                         "refine": {"offdec_type": "IMNET"}},
               "no_posenc": {"model": {"pos_encode": False},
                             "refine": {"pos_encode": False}}}
OPTION_STEPS = 2


def only_k5(n):
    """Every kernel 0 launches but K5's ``n``."""
    return {**{k: 0 for k in counters()}, "segment_max0": n}


# 38: batch 4 as phase 6, and the configured batch 32; L-BFGS steps before
# the checkpoint, and its memory of 10 pairs
REMAT_BATCHES = (TRAIN_BATCH, 32)
LBFGS_STEPS = 3
# the card's L-BFGS update (f32, cuBLAS inner products over the 21.6 M
# parameters) against the float64 two-loop of the same recorded gradients:
# the largest difference over the largest value of the update; f32
# accumulation over 4.9 M values reached 1.3e-4 of it on a CPU (MKL)
LBFGS_F64_RTOL = 1e-3


def merged(*dicts):
    """The nested overrides of ``dicts`` merged, the later winning."""
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
                out.get(k), dict) else copy.deepcopy(v)
    return out


def reference_state(model, prefix):
    """The state of ``model``'s submodule ``prefix`` ("resnet.", "pnet.",
    "offset_dec.", "prob_dec.") in the reference's checkpoint layout (the
    inverse of ``utils/torch_import.py``): the ResNet's ``resnet34_8s.*``
    names, the PointNet's ``point_lin*`` / ``vox_lin*``, a decoder's
    ``linear_1..4`` with its layer-1 ROI columns back in channel-major
    order."""
    from implicit_depth_torch.utils import torch_import as ti
    names = {port: ref for ref, port in ti._PNET}
    out = {}
    for k, v in model.state_dict().items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if prefix == "resnet.":
            for s in range(1, 5):
                for i in range(8):
                    k = k.replace(f"layer{s}_{i}.", f"layer{s}.{i}.")
            k = "resnet34_8s." + k.replace("down_conv.", "downsample.0.") \
                .replace("down_bn.", "downsample.1.")
        elif prefix == "pnet.":
            part, rest = k.split(".", 1)
            k = f"{names[part]}.{rest}"
        else:
            for i in range(4):
                k = k.replace(f"mlp.l{i}.", f"linear_{i + 1}.")
        out[k] = v.detach().cpu().clone()
    if prefix in ("offset_dec.", "prob_dec."):
        s = model.static.roi_out_bbox ** 2
        start = model.pnet.v2_mlp.weight.shape[0]
        rgb = model.dims["c_rc" if "c_rc" in model.dims else "c_roi"]
        rgb = (rgb - (model.dims["c_dir"] if "c_rc" in model.dims else 0)) // s
        w = out["linear_1.weight"]
        ref = w.clone()
        ref[:, ti.roi_row_permutation(start, rgb, s)] = \
            w[:, start:start + rgb * s]
        out["linear_1.weight"] = ref
    return out


def reference_files(workdir, lidf, refine):
    """The two stages as the reference saves them (``torch.save`` of one
    dict each: the modules' states, an optimizer entry, the epoch and a
    numpy metric scalar); returns their paths."""
    s1 = {"resnet_model": reference_state(lidf, "resnet."),
          "pnet_model": reference_state(lidf, "pnet."),
          "offset_dec": reference_state(lidf, "offset_dec."),
          "prob_dec": reference_state(lidf, "prob_dec."),
          "optimizer": {"state": {}, "param_groups": [{"lr": 1e-3}]},
          "epoch": REF_META["epoch"],
          "xyz_err": np.float64(REF_META["xyz_err"])}
    s2 = {"pnet_model_refine": reference_state(refine, "pnet."),
          "offset_dec_refine": reference_state(refine, "offset_dec."),
          "optimizer": {}, "epoch": REF_META["epoch"],
          "xyz_err": np.float64(REF_META["xyz_err"])}
    paths = (workdir / "best_network_lidf.pth",
             workdir / "best_network_refine.pth")
    for ck, p in zip((s1, s2), paths):
        torch.save(ck, p)
    return paths


def import_tools(jobs, rgb_out):
    """``python -m implicit_depth_torch.tools.import_torch_ckpt`` on each
    (pth, out) of ``jobs``, each in a process of its own from the checkout,
    all at once (``rgb_out``: a stage-2 file's ROI width, which it does not
    hold)."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "implicit_depth_torch.tools.import_torch_ckpt",
         "--pth", str(pth), "--out", str(out), "--rgb_out", str(rgb_out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pth, out in jobs]
    for p in procs:
        out, err = p.communicate(timeout=300)
        if p.returncode:
            raise AssertionError(f"import_torch_ckpt: {err[-2000:]}")
        log(f"import_torch_ckpt: {out.strip()}")


def synthetic_csv(tr, fresh, label):
    """The test run's result/synthetic.csv against cleargrasp_metrics of the
    eval outputs of ``fresh`` (a trainer of the same config)."""
    import csv
    import os

    from implicit_depth_torch.train.metrics import (
        cleargrasp_metrics,
        depth_images_from_outputs,
    )
    from implicit_depth_torch.train.trainer import to_device

    h, w = fresh.cfg.dataset.img_height, fresh.cfg.dataset.img_width
    want = []
    for batch in fresh.make_valid_loaders()["synthetic"].epoch(0):
        inputs, pred, _ = fresh._eval(to_device(batch, fresh.device))
        depth = depth_images_from_outputs(inputs, pred, h, w)
        for i, path in enumerate(batch["item_path"]):
            m = cleargrasp_metrics(depth[i], batch["depth"][i],
                                   batch["corrupt_mask"][i])
            if m:
                want.append([path, *(repr(m[k]) for k in (
                    "rmse", "abs_rel", "mae", "a1", "a2", "a3"))])
    with open(os.path.join(tr.result_dir, "synthetic.csv")) as f:
        rows = list(csv.reader(f))
    mean = np.asarray([r[1:] for r in want], np.float64).mean(0)
    if not (want and rows[1:-1] == want and rows[-1][0] == "MEAN"
            and np.array_equal(np.asarray(rows[-1][1:], np.float64), mean)):
        raise AssertionError(f"{label}: CSV {rows} against {want}")
    log(f"{label}: result/synthetic.csv {len(want)} rows, MEAN {rows[-1][1:]}"
        f", equal to the metrics recomputed from a fresh trainer's eval "
        f"outputs")
    return rows[-1][1:]


def reference_phase(dev, workdir):
    """Phase 36: reference-layout files of the default model, converted by
    the tool, served in the three decode modes (K1 or K6, K4, K5 against
    their plain versions on those weights; per_ray also f32 card vs CPU)
    and tested through the CLI. Returns {kernel: row}."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter

    cfg = load_config(overrides=SERVE_OVERRIDES)
    lidf, refine = build_models(cfg, seed=SEED + 36)
    paths = reference_files(workdir, lidf, refine)
    log(f"reference files: {[f'{p.name} {p.stat().st_size / 2**20:.1f} MiB' for p in paths]}")
    dirs = [workdir / "imported_lidf", workdir / "imported_refine"]
    import_tools(zip(paths, dirs), cfg.model.rgb_out)
    frames = make_frames(2, FRAME_HW)
    rows, launches = {}, {}
    for mode in ("per_ray", *MODES):
        o = SERVE_OVERRIDES if mode == "per_ray" else mode_overrides(
            SERVE_OVERRIDES, mode)
        mcfg = load_config(overrides=o)
        dc = DepthCompleter.from_checkpoint(str(dirs[0]), str(dirs[1]),
                                            cfg=mcfg, device=dev)
        for name, (src, got) in (("lidf", (lidf, dc.lidf)),
                                 ("refine", (refine, dc.refine))):
            for k, v in src.state_dict().items():
                if not k.endswith("num_batches_tracked") and not torch.equal(
                        v, got.state_dict()[k].cpu()):
                    raise AssertionError(f"imported {name} {k} is not the "
                                         "file's")
        assert dc.lidf.decode_mode == mode, dc.lidf.decode_mode
        if mode == "per_ray":
            rec = record_calls(kernel_modules(), lambda: dc.complete(*frames[0]))
            mode_rows = kernel_phase(rec, dc.lidf, dc.refine, dev)
            expect = EXPECT_PER_FRAME
        else:
            rec = record_calls({"pair_decode": kernel_modules()["pair_decode"]},
                               lambda: dc.complete(*frames[0]))
            mode_rows = {"pair_decode": pair_kernel_rows(rec, dc.lidf, dev)}
            expect = EXPECT_PER_MODE_FRAME
        n, frame_ms = main_path(dc, frames[1:], mcfg, expect,
                                f"imported checkpoint, {mode} mode")
        for name, row in mode_rows.items():
            rows.setdefault(name, {})[mode] = {
                k: row[k] for k in ("max_abs_err", "tolerance", "ms",
                                    "plain_ms", "bound_ms", "shape", "dtype")
                if k in row}
        for k, v in n.items():
            launches.setdefault(k, {})[mode] = v
        if mode == "per_ray":  # phase 5's check, at a quarter of the pixels
            xo = merged(o, {"dataset": MODE_XCHECK_DATASET})
            xdc = DepthCompleter.from_checkpoint(
                str(dirs[0]), str(dirs[1]), cfg=load_config(overrides=xo),
                device="cpu")
            cross_check(xo, xdc.lidf, xdc.refine, frames[1], dev)
            del xdc
        del dc
        torch.cuda.empty_cache()
    # the user's test configs through the CLI, at the imported directories
    t1, l1 = counted(lambda: cli(dev, "test", workdir / "t1", *REF_TEST_SET,
                                 f"checkpoint_path={dirs[0]}"))
    fresh1 = cli(dev, "test", workdir / "t1b", *REF_TEST_SET,
                 f"checkpoint_path={dirs[0]}", make=True)
    n1 = len(t1.make_valid_loaders()["synthetic"].dataset)
    expect_launches("imported test_lidf", l1, 0, n1, {},
                    EXPECT_PER_EVAL_FRAME)
    synthetic_csv(t1, fresh1, "imported test_lidf")
    sets2 = (*REF_TEST_SET, f"checkpoint_path={dirs[1]}",
             f"lidf_ckpt_path={dirs[0]}")
    t2, l2 = counted(lambda: cli(dev, "test_refine", workdir / "t2", *sets2))
    fresh2 = cli(dev, "test_refine", workdir / "t2b", *sets2, make=True)
    expect_launches("imported test_refine", l2, 0, n1, {}, EXPECT_PER_FRAME)
    synthetic_csv(t2, fresh2, "imported test_refine")
    for k in l1:
        launches.setdefault(k, {}).update(test_lidf=l1[k], test_refine=l2[k])
    for k, v in launches.items():
        rows.setdefault(k, {})["launches"] = v
    return rows


def option_xcheck(dev, overrides, label):
    """One f32 stage-1 and one f32 stage-2 step of the same weights and
    draws on the card and on the CPU: the losses within XCHECK_LOSS_RTOL,
    each group's gradients (by the norm of the difference over the
    group's) within phase 8's limits."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.geometry.sampling import (
        sample_masked_window,
        sample_valid_stratified,
    )
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import (
        make_lidf_train_step,
        make_refine_train_step,
    )

    cfg = load_config(overrides=merged(REFINE_XCHECK, overrides))
    lidf, refine = build_models(cfg, train=True, seed=SEED + 37)
    batch = train_batches(1, cfg, 1, "cpu")[0]
    gen = torch.Generator().manual_seed(SEED)
    vidx, _, _ = sample_valid_stratified(batch["valid_mask"] > 0.5,
                                         lidf.static.n_valid, gen)
    _, _, _, mstart = sample_masked_window(
        (batch["corrupt_mask"] > 0.5).reshape(1, -1), lidf.static.n_rays, gen)
    noise = {k: torch.rand((1,), generator=gen) for k in ("apply", "bucket",
                                                         "u")}
    for stage in ("stage 1", "stage 2"):
        runs = {}
        for device in (dev, torch.device("cpu")):
            lm, rm = copy.deepcopy(lidf), copy.deepcopy(refine)
            trained = lm if stage == "stage 1" else rm
            state = TrainState.create(trained, cfg.training,
                                      steps_per_epoch=1000)
            b = {k: v.to(device) for k, v in batch.items()}
            if stage == "stage 1":
                losses = make_lidf_train_step(cfg, lm, device)(
                    state, b, None, 10, valid_idx=vidx, miss_start=mstart)
            else:
                losses = make_refine_train_step(cfg, lm, rm, device)(
                    state, b, None, 10, valid_idx=vidx, miss_start=mstart,
                    noise={k: v.to(device) for k, v in noise.items()})
            runs[device.type] = ({k: v.item() for k, v in losses.items()},
                                 {n: p.grad.cpu() for n, p in
                                  trained.named_parameters()})
        (la, ga), (lb, gb) = runs[dev.type], runs["cpu"]
        loss_err = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-6) for k in lb)
        errs = {}
        for group in {n.split(".")[0] for n in gb}:
            names = [n for n in gb if n.split(".")[0] == group]
            errs[group] = rel_norm(torch.cat([ga[n].reshape(-1) for n in names]),
                                   torch.cat([gb[n].reshape(-1) for n in names]))
        log(f"{label} {stage} cross-check f32 card vs cpu "
            f"({cfg.dataset.img_height}x{cfg.dataset.img_width}): largest "
            f"relative loss difference {loss_err:.3g}; gradients by group "
            f"{ {g: float(f'{e:.3g}') for g, e in errs.items()} }")
        bad = [g for g, e in errs.items()
               if e > (XCHECK_RESNET_RTOL if g == "resnet" else XCHECK_GRAD_RTOL)]
        if loss_err > XCHECK_LOSS_RTOL or bad:
            raise AssertionError(f"{label} {stage} cross-check: the card and "
                                 f"the CPU disagree: {loss_err}, {bad}")


def timed_steps(label, step, state, batches, expect):
    """A warm-up step, then one a batch, the launch counters from 0:
    returns the median host-clock ms and the launches."""
    gen = torch.Generator(device=batches[0]["rgb"].device).manual_seed(SEED)
    step(state, batches[0], gen, 10)
    counts = counters()
    for f in counts.values():
        f.launches = 0
    ms = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        out = step(state, b, gen, 10)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if not all(torch.isfinite(v) for v in out.values()):
            raise AssertionError(f"{label}: a loss is not finite: {out}")
    launches = {k: f.launches for k, f in counts.items()}
    expect_launches(label, launches, len(ms), 0, expect, {})
    log(f"{label}: step_ms {ms}, median {statistics.median(ms):.1f}")
    return statistics.median(ms), launches


def options_phase(dev):
    """Phase 37: an IMNet offset decoder, then ``pos_encode: false``, each
    in both stages: a stage-1 step at batch 4 and 240x320, a stage-2 step
    behind it, a served 480x640 frame in each decode mode (K5 alone, no
    other kernel), and the f32 card results against the CPU's (steps and
    frames). Returns {option: record}."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import (
        make_lidf_train_step,
        make_refine_train_step,
    )

    frames = make_frames(1, FRAME_HW)
    out = {}
    for option, sets in OPTION_SETS.items():
        rec, launches = {}, {}
        cfg = load_config(overrides=merged(TRAIN_OVERRIDES, sets))
        lidf, _ = build_models(cfg, train=True, seed=SEED + 37)
        lidf.to(dev)
        assert not lidf.fused
        batches = train_batches(OPTION_STEPS + 1, cfg, TRAIN_BATCH, dev)
        state = TrainState.create(lidf, cfg.training, steps_per_epoch=1000)
        rec["stage1_step_ms"], launches["stage1"] = timed_steps(
            f"{option} stage 1", make_lidf_train_step(cfg, lidf, dev), state,
            batches, only_k5(2))
        torch.cuda.reset_peak_memory_stats()
        cfg2 = load_config(overrides=merged(REFINE_OVERRIDES, sets))
        lidf2, refine2 = build_models(cfg2, train=True, seed=SEED + 37)
        lidf2.to(dev), refine2.to(dev)
        state2 = TrainState.create(refine2, cfg2.training, steps_per_epoch=1000)
        rec["stage2_step_ms"], launches["stage2"] = timed_steps(
            f"{option} stage 2", make_refine_train_step(cfg2, lidf2, refine2,
                                                        dev),
            state2, train_batches(OPTION_STEPS + 1, cfg2, TRAIN_BATCH, dev),
            only_k5(10))
        del lidf, state, lidf2, refine2, state2, batches
        torch.cuda.empty_cache()
        for mode in ("per_ray", *MODES):
            o = merged(SERVE_OVERRIDES, sets) if mode == "per_ray" else \
                mode_overrides(merged(SERVE_OVERRIDES, sets), mode)
            mcfg = load_config(overrides=o)
            lm, rm = build_models(mcfg, seed=SEED + 37)
            dc = DepthCompleter(mcfg, lidf=lm, refine=rm, device=dev)
            dc.complete(*frames[0])  # warm-up
            n, rec[f"{mode}_frame_ms"] = main_path(
                dc, frames, mcfg, only_k5(10), f"{option} {mode} mode")
            launches[mode] = n["segment_max0"]
            del dc, lm, rm
            torch.cuda.empty_cache()
            xo = merged(o, {"dataset": MODE_XCHECK_DATASET})
            if mode == "global":
                xo["tpu"].update(MODE_XCHECK_TPU["global"])
            cross_check(xo, *build_models(load_config(overrides=xo),
                                          seed=SEED + 37), frames[0], dev)
        option_xcheck(dev, sets, option)
        rec["launches_k5"] = {k: (v["segment_max0"] if isinstance(v, dict)
                                  else v) for k, v in launches.items()}
        out[option] = rec
        log(f"{option}: {rec}")
    return out


def remat_step(dev, cfg, batch, remat):
    """One stage-1 ``kernel_save`` step of phase 6's weights with
    ``remat_backbone`` as given: (gradients, running statistics, peak GiB,
    launches)."""
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    c = copy.deepcopy(cfg)
    c.tpu.remat_backbone = remat
    model = build_models(c, train=True, seed=SEED + 38)[0].to(dev)
    assert model.remat_backbone == remat
    state = TrainState.create(model, c.training, steps_per_epoch=1000)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (_, launches) = counted(lambda: make_lidf_train_step(c, model, dev)(
        state, batch, gen, 0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {k: v.detach().clone() for k, v in model.state_dict().items()
             if "running" in k}
    del model, state
    return grads, stats, peak, launches


def lbfgs_f64(history, g, memory=10):
    """The L-BFGS direction (optax's scale_by_lbfgs) in float64 from the
    f32 parameters and gradients of each step so far (``history``: [(w, g),
    ...], this step's last) and this step's gradient."""
    pairs = [(history[i + 1][0] - history[i][0],
              history[i + 1][1] - history[i][1])
             for i in range(len(history) - 1)][-memory:]
    if not pairs:
        return g / max(1.0, float(np.linalg.norm(g)))
    rhos = [1.0 / du.dot(dw) for dw, du in pairs]
    q, alphas = g.copy(), []
    for (dw, du), rho in zip(reversed(pairs), reversed(rhos)):
        alphas.append(rho * dw.dot(q))
        q -= alphas[-1] * du
    dw, du = pairs[-1]
    q *= du.dot(dw) / du.dot(du)
    for (dw, du), rho, a in zip(pairs, rhos, reversed(alphas)):
        q += (a - rho * du.dot(q)) * dw
    return q


def remat_lbfgs_phase(dev, workdir):
    """Phase 38: ``remat_backbone`` against none (gradients and running
    statistics bit for bit; peak memory at batch 4 and 32), then L-BFGS:
    LBFGS_STEPS steps, a checkpoint and a resume whose next step is bit for
    bit the uninterrupted one, and the card's update from the recorded
    gradients against a float64 two-loop. Returns its record."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.train.checkpoint import Checkpointer
    from implicit_depth_torch.train.state import LBFGS, TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    rec, launches = {"peak_gib": {}}, {}
    cfg = load_config(overrides=TRAIN_OVERRIDES)
    with cudnn_flags(deterministic=True, benchmark=False):
        for b in REMAT_BATCHES:
            batch = train_batches(1, cfg, b, dev)[0]
            g0, s0, p0, l0 = remat_step(dev, cfg, batch, False)
            g1, s1, p1, l1 = remat_step(dev, cfg, batch, True)
            rec["peak_gib"][f"batch {b}"] = {"remat": p1, "none": p0}
            for k in l0:
                launches[k] = launches.get(k, 0) + l0[k] + l1[k]
            expect_launches(f"remat batch {b}", l1, 1, 0, EXPECT_PER_STEP, {})
            if b == TRAIN_BATCH:
                diff = [n for n in g0 if not torch.equal(g0[n], g1[n])] + \
                    [k for k in s0 if not torch.equal(s0[k], s1[k])]
                if diff:
                    raise AssertionError(f"remat: not bit for bit: {diff}")
                log(f"remat: batch {b}, {len(g0)} gradients and {len(s0)} "
                    f"running statistics bit for bit without it")
            log(f"remat: batch {b} peak device memory {p1:.2f} GiB with, "
                f"{p0:.2f} without")
            del g0, g1, s0, s1, batch
            torch.cuda.empty_cache()

        # L-BFGS: LBFGS_STEPS steps, a checkpoint, one more step; the same
        # from the checkpoint in a fresh state
        lcfg = load_config(overrides=merged(TRAIN_OVERRIDES, {
            "training": {"optimizer_name": "lbfgs"}}))
        batches = train_batches(LBFGS_STEPS + 1, lcfg, TRAIN_BATCH, dev)
        model = build_models(lcfg, train=True, seed=SEED + 38)[0].to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before_opt = torch.cuda.memory_allocated()
        state = TrainState.create(model, lcfg.training, steps_per_epoch=1000)
        assert isinstance(state.optimizer, LBFGS)
        opt_bytes = torch.cuda.memory_allocated() - before_opt
        step = make_lidf_train_step(lcfg, model, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        history, ms = [], []
        params = list(model.parameters())

        def flat(ts):
            return torch.cat([t.detach().reshape(-1)
                              for t in ts]).double().cpu().numpy()

        counts = counters()
        for f in counts.values():
            f.launches = 0
        for i in range(LBFGS_STEPS):
            w = flat(params)
            t0 = time.perf_counter()
            step(state, batches[i], gen, 0)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            history.append((w, flat([p.grad for p in params])))
        l_lbfgs = {k: f.launches for k, f in counts.items()}
        expect_launches("lbfgs", l_lbfgs, LBFGS_STEPS, 0, EXPECT_PER_STEP, {})
        for k, n in l_lbfgs.items():
            launches[k] = launches.get(k, 0) + n
        ckpt = Checkpointer(str(workdir / "lbfgs"))
        ckpt.save(state, epoch=0)
        gen_state = gen.get_state()
        step(state, batches[LBFGS_STEPS], gen, 0)
        want = {n: p.detach().clone() for n, p in model.named_parameters()}
        model2 = build_models(lcfg, train=True, seed=SEED + 99)[0].to(dev)
        state2 = TrainState.create(model2, lcfg.training, steps_per_epoch=1000)
        ckpt.restore(state2)
        gen2 = torch.Generator(device=dev)
        gen2.set_state(gen_state)
        make_lidf_train_step(lcfg, model2, dev)(state2, batches[LBFGS_STEPS],
                                                gen2, 0)
        diff = [n for n, p in model2.named_parameters()
                if not torch.equal(p.detach(), want[n])]
        if diff or state2.step != state.step:
            raise AssertionError(f"lbfgs resume: not bit for bit: {diff}")
        log(f"lbfgs: {LBFGS_STEPS} steps, checkpoint, resume: step "
            f"{state.step} bit for bit the uninterrupted one")
        rec["lbfgs"] = {"step_ms": ms, "optimizer_gib": opt_bytes / 2 ** 30,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del model2, state2, want, model, state, step, batches
        torch.cuda.empty_cache()

        # the card's update from the recorded gradients (a fresh L-BFGS over
        # one flat parameter, rate 1) against the float64 two-loop
        flat_p = torch.nn.Parameter(torch.zeros(history[0][0].shape[0],
                                                device=dev))
        opt = LBFGS([flat_p], lr=1.0)
        errs = []
        for i, (w, g) in enumerate(history):
            with torch.no_grad():
                flat_p.copy_(torch.from_numpy(w).float())
            flat_p.grad = torch.from_numpy(g).float().to(dev)
            opt.step()
            got = flat_p.detach().double().cpu().numpy() - w
            ref = -lbfgs_f64(history[:i + 1], g)
            errs.append(float(np.abs(got - ref).max() / np.abs(ref).max()))
        log(f"lbfgs: the card's update from the recorded gradients against "
            f"the float64 two-loop, largest difference over the largest "
            f"value: {errs} (limit {LBFGS_F64_RTOL})")
        if max(errs) > LBFGS_F64_RTOL:
            raise AssertionError(f"lbfgs: {errs} > {LBFGS_F64_RTOL}")
        rec["lbfgs"]["f64_rel_err"] = errs
        del opt, flat_p
        torch.cuda.empty_cache()
    log(f"remat and lbfgs: {rec}")
    return rec, launches


# -- the per-ray pair budgets other than 8 (phase 39) -------------------------
# the default model (K = 20 pair slots) at these pairs_budget_per_ray: the
# serving, bare training, stage-2 and (BUDGET_CLI) CLI paths
BUDGETS = (4, 12, 16)
# counted frames and steps of each path at a budget (after the recorded one)
BUDGET_FRAMES, BUDGET_STEPS = 1, 1
# the budget of the f32 frame card vs CPU (at MODE_XCHECK_DATASET), and of
# the CLI runs
BUDGET_XCHECK, BUDGET_CLI = 12, 16
# configs/train_lidf.yaml cut to one epoch of 2 steps at batch 4, validated
BUDGET_CLI_SET = ["training.batch_size=4", "dataset.synthetic_len=8",
                  "training.nepochs=1", "training.valid_batch_size=1",
                  f"tpu.pairs_budget_per_ray={BUDGET_CLI}"]
# budgets only the kernels see, on calls made from recorded ones: kb 1, the
# first slot of a kb-4 call; kb 64 (a ray a bf16 tile; two f32 blocks a
# ray), a kb-16 call's slots four times over, on its first BUDGET_ALONE_RAYS
# rays (256,000 pair rows: the phase's budget of time)
BUDGET_ALONE = {1: 4, 64: 16}
BUDGET_ALONE_RAYS = 4000
# the frozen stage 1's K1 call in a stage-2 step (no earlier phase holds
# it): its decoder outputs spread twice the served frame's (std 0.100-0.109
# against 0.050-0.057 on an H100), and a bf16 flip of a hidden activation
# moved one output by 8.05e-3 at kb 8, 12 and 16 alike (the same pair among
# the first 8 slots; at kb 8 the kernel computes the parent's bits), 4.62e-3
# at kb 4. bf16: twice the largest reading, as phase 3's 4e-3 is twice the
# served frame's, which leaves it STAGE2_BITE (not BITE) times below the
# spread: a dropped layer or iteration moves most outputs by about the
# spread; f32 keeps 1e-5 and BITE
STAGE2_K1_TOL = {("ray_decode", torch.float32): 1e-5,
                 ("ray_decode", torch.bfloat16): 1.6e-2}
STAGE2_BITE = 5
# phase 39's timings (its budget of about a minute: K1-K3 at three budgets
# in bf16 and f32; the plain K3 and the f32 K3 take 0.1-0.4 s a call on an
# H100): a first call, whose time is the reading where it took over
# BUDGET_SLOW_MS, else the median of BUDGET_REPS calls after it
BUDGET_REPS, BUDGET_SLOW_MS = 3, 50.0
# K3's passes timed in bf16 only
BUDGET_CHECKS = Checks(quick=True, profiled=(torch.bfloat16,))
# what the kernels line keeps of a kernel's row at a budget
BUDGET_KEYS = WIDTH_KEYS + ("frame_ms", "train", "stage2")


def budget_k1_row(recorded, lidf, dev, tols=TOL, bite=True,
                  checks=BUDGET_CHECKS):
    """K1 on the calls of ``recorded`` (``forward_rows``, in bf16 as
    recorded and in f32 with ``lidf``'s weights re-prepared)."""
    f32w = k1_f32_operands(lidf)

    def as_f32(name, a):
        vt, cells, pos, rf, _ = a
        return vt.float(), cells, pos, rf.float(), f32w

    with torch.inference_mode():
        return forward_rows(recorded, as_f32, dev, tols, bite=bite,
                            checks=checks)["ray_decode"]


def slots_of(kb, rays, *ts):
    """Each (rays, slots, ...) tensor of ``ts`` at ``kb`` slots: its first
    ``kb`` slots, or its slots repeated up to ``kb``, on its first ``rays``
    rays."""
    out = []
    for t in ts:
        t = t[:rays]
        reps = -(-kb // t.shape[1])
        out.append(t.repeat(1, reps, *([1] * (t.dim() - 2)))[:, :kb]
                   .contiguous())
    return out


def budget_alone_rows(serve_calls, train_calls, lidf):
    """K1, K2, K2 'all' and K3's three instances at the budgets of
    BUDGET_ALONE, on calls made from the recorded ones of another budget,
    each against its plain version in bf16 and f32 (phases 3, 7, 10 and
    11's tolerances); K3 twice on each call, the same bits. Returns {kb:
    {kernel: its bf16 row}}."""
    out = {}
    for kb, src in BUDGET_ALONE.items():
        (a, kw), = serve_calls[src].values()
        vt, cells, pos, rf, w = a
        n = a[1].shape[0] if kb < src else BUDGET_ALONE_RAYS
        cells, pos = slots_of(kb, n, cells, pos)
        call = (vt, cells, pos, rf[:n].contiguous(), w)
        rows = {"ray_decode": budget_k1_row(
            {("ray_decode", tuple(tuple(t.shape) for t in call
                                  if torch.is_tensor(t))): (call, kw)},
            lidf, vt.device)}
        rec = train_calls[src]
        (vt, cells, pos, rf, w), kw2 = rec["ray_decode_save"]
        a3, kw3 = rec["ray_decode_bwd"]
        n = cells.shape[0] if kb < src else BUDGET_ALONE_RAYS
        cells, pos, g_off, g_logit = slots_of(kb, n, cells, pos, a3[6], a3[7])
        rf = rf[:n].contiguous()
        derived = {"f32_operands": rec["f32_operands"],
                   "ray_decode_save": ((vt, cells, pos, rf, w), kw2),
                   "ray_decode_save_all": ((vt, cells, pos, rf, w), kw2),
                   "ray_decode_bwd": ((vt, cells, pos, rf, w, None, g_off,
                                       g_logit), kw3)}
        log(f"kb {kb} alone: {n} rays of {kb} slots, from kb {src}'s calls")
        rows.update(train_kernel_phase(derived, checks=BUDGET_CHECKS))
        rows["ray_decode_bwd_recompute"] = recompute_kernel_rows(
            derived, checks=BUDGET_CHECKS)
        rows.update(save_all_kernel_rows(derived, checks=BUDGET_CHECKS))
        from implicit_depth_torch.ops import ray_decode as rd
        a2 = derived["ray_decode_save"][0]
        for name, saved in (("ray_decode_bwd", rd.ray_decode_save(
                *a2, **kw2)[2]), ("ray_decode_bwd_recompute", None),
                            ("ray_decode_bwd_all", rd.ray_decode_save_all(
                                *a2, **kw2)[2])):
            rows[name]["repeat_bit_identical"] = k3_repeats(
                {"ray_decode_bwd": ((*a2, saved, g_off, g_logit), kw3)})
        log(f"kb {kb} alone: each K3 instance twice on its call: the same "
            f"bits")
        out[kb] = rows
        del derived, rec
        torch.cuda.empty_cache()
    return out


def budget_cli_phase(dev, workdir):
    """configs/train_lidf.yaml at ``pairs_budget_per_ray`` BUDGET_CLI
    through the CLI (BUDGET_CLI_SET), then configs/test_lidf.yaml from its
    checkpoint at the same budget: launches per step K2 1, K3 1, K5 2 and
    per eval frame K1 1, K5 2; finite losses; the test's CSV. Returns
    {kernel: launches} of both runs."""
    tr, launches = counted(lambda: cli(dev, "lidf", workdir / "train",
                                       *BUDGET_CLI_SET))
    recs = epoch_records(tr)
    steps = tr.steps_per_epoch * len(recs)
    frames = sum(len(tr.make_valid_loaders()["synthetic"].dataset)
                 for r in recs if "valid" in r)
    expect_launches(f"kb {BUDGET_CLI} CLI train_lidf", launches, steps,
                    frames, EXPECT_PER_STEP, EXPECT_PER_EVAL_FRAME)
    losses = [v for r in recs for v in r["train"].values()]
    if tr.cfg.tpu.pairs_budget_per_ray != BUDGET_CLI or steps != 2 \
            or not all(np.isfinite(losses)):
        raise AssertionError(f"kb {BUDGET_CLI} CLI: records {recs}")
    test, test_launches = counted(lambda: cli(
        dev, "test", workdir / "test", f"checkpoint_path={tr.ckpt_dir}",
        "dataset.synthetic_len=4", f"tpu.pairs_budget_per_ray={BUDGET_CLI}"))
    expect_launches(f"kb {BUDGET_CLI} CLI test_lidf", test_launches, 0,
                    len(test.make_valid_loaders()["synthetic"].dataset), {},
                    EXPECT_PER_EVAL_FRAME)
    rows = read_csv(test)
    if rows[-1][0] != "MEAN" or not np.isfinite(
            np.asarray(rows[-1][1:], np.float64)).all():
        raise AssertionError(f"kb {BUDGET_CLI} CLI test: CSV {rows}")
    log(f"kb {BUDGET_CLI} CLI: train_lidf.yaml {steps} steps, losses "
        f"{[r['train'] for r in recs]}; test_lidf.yaml result/synthetic.csv "
        f"{len(rows) - 2} rows, MEAN {rows[-1][1:]}")
    return {k: launches[k] + test_launches[k] for k in launches}


def budget_phase(dev, workdir):
    """Phase 39: the default model at each pairs_budget_per_ray of BUDGETS
    (K = 20 slots) through its entry points: DepthCompleter.complete on a
    480x640 frame (K1's calls recorded, then BUDGET_FRAMES frames counted:
    K1 1, K4 2, K5 10 a frame, input depth bit for bit), the bare stage-1
    steps in each decode_bwd mode (a recorded step, then BUDGET_STEPS
    counted: launches as phases 6 and 10-12), stage 2 behind the frozen
    stage 1 (K1 1, K4 2, K5 10 a step; K1's call of a step recorded); each
    recorded K1, K2, K2 'all' and K3 call against its plain version in bf16
    and f32 at phases 3, 7, 10 and 11's tolerances, K3 twice on each call
    the same bits; an f32 frame card vs CPU at BUDGET_XCHECK (as phase 5,
    at MODE_XCHECK_DATASET); kb 1 and 64 on calls made from recorded ones
    (budget_alone_rows); the CLI at BUDGET_CLI (budget_cli_phase). Returns
    ({kernel: {"kb<kb>": its row}}, the CLI's launches)."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.models import lidf as lidf_mod

    frames = make_frames(BUDGET_FRAMES + 1, FRAME_HW)
    out, serve_calls, train_calls = {}, {}, {}

    def put(name, kb, row):
        out.setdefault(name, {})[f"kb{kb}"] = {
            k: row[k] for k in BUDGET_KEYS if k in row}

    for kb in BUDGETS:
        t_kb = time.perf_counter()
        tpu = {"tpu": {"pairs_budget_per_ray": kb}}
        cfg = load_config(overrides=merged(SERVE_OVERRIDES, tpu))
        lidf, refine = build_models(cfg)
        assert lidf.decode_mode == "per_ray" and lidf.pairs_budget == kb
        dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
        calls = record_calls({"ray_decode": kernel_modules()["ray_decode"]},
                             lambda: dc.complete(*frames[0]))
        serve_calls[kb] = calls
        k1 = budget_k1_row(calls, lidf, dev)
        launches, frame_ms = main_path(dc, frames[1:], cfg,
                                       label=f"kb {kb} main path")
        k1 = add_launches(k1, launches["ray_decode"], BUDGET_FRAMES,
                          "frame")
        k1["frame_ms"] = frame_ms
        if kb == BUDGET_XCHECK:
            xo = merged(SERVE_OVERRIDES, tpu,
                        {"dataset": MODE_XCHECK_DATASET})
            cross_check(xo, *build_models(load_config(overrides=xo)),
                        frames[1], dev)
        del dc, lidf, refine
        torch.cuda.empty_cache()
        # the bare stage-1 steps, each decode_bwd mode
        for decode_bwd, expect in (
                ("kernel_save", EXPECT_PER_STEP),
                ("kernel", EXPECT_PER_STEP_KERNEL),
                ("kernel_save_all", EXPECT_PER_STEP_SAVE_ALL),
                ("xla", EXPECT_PER_STEP_XLA)):
            cfg_t, model = train_mode_model(
                dev, merged(TRAIN_OVERRIDES, tpu), decode_bwd)
            assert model.pairs_budget == kb
            recorded, launches, step_ms = train_path(
                cfg_t, model, dev, expect=expect, steps=BUDGET_STEPS)
            del model
            torch.cuda.empty_cache()
            if decode_bwd == "kernel_save":
                train_calls[kb] = recorded
                got = train_kernel_phase(recorded, checks=BUDGET_CHECKS)
                fwd, bwd = "ray_decode_save", "ray_decode_bwd"
            elif decode_bwd == "kernel":
                k1["train"] = {k: v for k, v in add_launches(
                    train_forward_row(recorded, dev, checks=BUDGET_CHECKS),
                    launches["ray_decode"], BUDGET_STEPS,
                    "step").items() if k in WIDTH_KEYS}
                got = {"ray_decode_bwd_recompute": recompute_kernel_rows(
                    recorded, checks=BUDGET_CHECKS)}
                fwd, bwd = None, "ray_decode_bwd_recompute"
            elif decode_bwd == "kernel_save_all":
                got = save_all_kernel_rows(recorded, checks=BUDGET_CHECKS)
                fwd, bwd = "ray_decode_save_all", "ray_decode_bwd_all"
            else:
                continue
            if fwd:
                add_launches(got[fwd], launches[fwd], BUDGET_STEPS,
                             "step")
            add_launches(got[bwd], launches["ray_decode_bwd"],
                         BUDGET_STEPS, "step")
            got[bwd]["step_ms"] = statistics.median(step_ms)
            got[bwd]["repeat_bit_identical"] = k3_repeats(recorded)
            log(f"kb {kb}: {bwd} twice on the recorded call: the same "
                f"bits")
            for name, row in got.items():
                put(name, kb, row)
            if decode_bwd != "kernel_save":
                del recorded
            torch.cuda.empty_cache()
        # stage 2 behind the frozen stage 1 at this budget
        cfg_r = load_config(overrides=merged(REFINE_OVERRIDES, tpu))
        lidf, refine = (m.to(dev) for m in build_models(cfg_r,
                                                        train=True))
        run2 = refine_train_path(cfg_r, lidf, refine, dev, BUDGET_STEPS,
                                 label=f"kb {kb} stage 2")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        calls = record_calls(
            {"ray_decode": (lidf_mod, "ray_decode")},
            lambda: run2["step"](run2["state"], run2["batches"][0], gen,
                                 0))
        row = budget_k1_row(calls, lidf, dev, STAGE2_K1_TOL, bite=False)
        if STAGE2_BITE * row["tolerance"] > row["spread"]:
            raise AssertionError(f"kb {kb} stage 2: K1's tolerance "
                                 f"{row['tolerance']} is not "
                                 f"{STAGE2_BITE}x below the outputs' "
                                 f"spread {row['spread']}")
        k1["stage2"] = {k: v for k, v in add_launches(
            row, run2["launches"]["ray_decode"], BUDGET_STEPS,
            "step").items() if k in WIDTH_KEYS}
        k1["stage2"]["step_ms"] = run2["step_ms"]
        put("ray_decode", kb, k1)
        del lidf, refine, run2, calls
        torch.cuda.empty_cache()
        log(f"kb {kb}: {time.perf_counter() - t_kb:.1f} s")
    t_alone = time.perf_counter()
    lidf = build_models(load_config(overrides=SERVE_OVERRIDES))[0]
    for kb, rows in budget_alone_rows(serve_calls, train_calls,
                                      lidf.to(dev)).items():
        for name, row in rows.items():
            put(name, kb, row)
    log(f"kb {', '.join(map(str, BUDGET_ALONE))} alone: "
        f"{time.perf_counter() - t_alone:.1f} s")
    del serve_calls, train_calls
    torch.cuda.empty_cache()
    t_cli = time.perf_counter()
    cli_launches = budget_cli_phase(dev, workdir)
    log(f"kb {BUDGET_CLI} CLI: {time.perf_counter() - t_cli:.1f} s")
    return out, cli_launches


# -- phase 40: the global and dense modes' stage-1 training -------------------
# bare steps at the default widths (240x320, 20,000 rays and 10,000 points an
# image, bf16) at the bench's batch 4 and train_lidf.yaml's batch 32: a
# recorded step, then PAIR_STEPS counted
PAIR_BATCHES = (4, 32)
PAIR_STEPS = 2
# per step: K6 forward once (its backward recomputes the plain decode), K5's
# two pools, none of the per_ray kernels
EXPECT_PER_PAIR_STEP = {"pair_decode": 1, "segment_max0": 2, "ray_decode": 0,
                        "ray_decode_save": 0, "ray_decode_save_all": 0,
                        "ray_decode_bwd": 0}
EXPECT_PER_PAIR_EVAL_FRAME = {"pair_decode": 1, "segment_max0": 2}
# the recompute backward's segment sum: two launches a table (voxels, rays)
# a chunk, however many chunks a step's live rows make
SUMS_PER_CHUNK = 4
# K6 against its plain version on the recorded forward call, on at most
# this many of its rows (the plain decode of batch 32's 12.8 M dense rows
# would need ~50 GB of f32 intermediates): batch 4's dense rows, all
PAIR_CHECK_ROWS = 1_600_000
# K6 against its plain version in a training step: f32 1e-5 (as TOL); bf16
# 2e-3, 2.5x the largest reading on an H100 (7.9e-4, dense batch 4; 6.5e-4
# to 6.8e-4 global), as K2's training tolerance is 2.5x its reading: the
# dense mode's outputs spread less (std 0.013) than the served frame's, so
# that TOL's 4e-3 would not bite; with a bite of 5 (as STAGE2_BITE)
PAIR_TRAIN_TOL = {("pair_decode", torch.float32): 1e-5,
                  ("pair_decode", torch.bfloat16): 2e-3}
PAIR_BITE = 5
# the step's gradients, K6 route against the plain path's (autograd of
# pair_decode_plain in one piece) on the card, same weights, batch, draws,
# cuDNN deterministic, at batch 4 (the plain path's graph of batch 32's
# rows would not fit the card): f32 by each parameter's relative norm; bf16
# per group (the forward's outputs may differ by a bf16 rounding, and the
# recompute sums the ray rows' gradients in f32 where the plain gather's
# backward sums them in bf16; the backward through the batch norms carries
# both into the ResNet). Readings on an H100 in both modes: f32 ResNet
# 1.02e-5, decoders and PointNet 2.0e-6; bf16 1.74e-2 and 4.28e-3; limits
# about 10x and 3-5x above them
PAIR_GRAD_RTOL = 1e-4
PAIR_BF16_GRAD_RTOL = {"resnet": 5e-2, "decoders and pnet": 2e-2}
# train_lidf.yaml through the CLI in each mode: one epoch of 2 steps at
# batch 4, validated; then test_lidf.yaml from its checkpoint
PAIR_CLI_SET = ["training.batch_size=4", "dataset.synthetic_len=8",
                "training.nepochs=1", "training.valid_batch_size=1"]
PAIR_MODE_SETS = {"global": ["tpu.pairs_budget_mode=global"],
                  "dense": ["tpu.pairs_budget_per_ray=0"]}


def pair_train_model(dev, mode, dtype=None):
    """The seeded training model of TRAIN_OVERRIDES in ``mode`` (the weights
    of phase 6's model), with its config; in ``dtype`` when given."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config
    extra = {"compute_dtype": dtype} if dtype else {}
    cfg = load_config(overrides=merged(TRAIN_OVERRIDES, {"tpu": {
        **MODES[mode], **extra}}))
    gen = torch.Generator().manual_seed(SEED + 1)
    model = randomize_weights_(build_lidf(cfg, build_static(cfg), gen), gen)
    assert model.decode_mode == mode, model.decode_mode
    return cfg, model.to(dev)


def pair_f32_operands(model):
    from implicit_depth_torch.models.lidf import decoder_weights
    from implicit_depth_torch.ops import pair_decode as pd
    return pd.prep_pair_decode_weights(
        {k: v.detach().clone() for k, v in
         decoder_weights(model.offset_dec, model.prob_dec).items()},
        model.dims["c_vox"], model.dims["c_roi"], model.dims["c_dir"],
        model.multires, torch.float32)


def cut_pair_call(a, kw, rows):
    """A recorded K6 call cut to its first ``rows`` rows (whole rays in the
    dense layout; the row count clamped)."""
    vt, cells, pos, rf, w, rays = a
    p = cells.shape[0]
    if p <= rows:
        return a, kw
    if rays is None:
        slots = p // rf.shape[0]
        rows = rows // slots * slots
        rf = rf[:rows // slots]
    else:
        rays = rays[:rows]
    if kw.get("n_rows") is not None:
        kw = {**kw, "n_rows": kw["n_rows"].clamp(max=rows)}
    return (vt, cells[:rows], pos[:rows], rf, w, rays), kw


def pair_k6_row(recorded, f32w, dev):
    """K6 against its plain version on the step's recorded forward call (cut
    to PAIR_CHECK_ROWS), bf16 as recorded and f32, at PAIR_TRAIN_TOL, which
    must lie PAIR_BITE times below the outputs' spread; K6's time on the
    whole call, and the recompute backward's on its recorded call, with the
    rows it decoded."""
    from implicit_depth_torch.ops import pair_decode as pd

    (key, (a, kw)), = [(k, v) for k, v in recorded.items()
                       if k[0] == "pair_decode"]
    a = tuple(t.detach() if torch.is_tensor(t) else t for t in a)
    with torch.inference_mode():
        step_ms = time_ms(lambda: pd.pair_decode(*a, **kw))
    (ab, kwb), = [v for k, v in recorded.items() if k[0] == "recompute"]
    g_off, g_logit = ab[7], ab[8]
    live = (g_off != 0) | (g_logit != 0)
    if ab[6] is not None:
        live &= torch.arange(live.shape[0], device=dev) < ab[6]
    bwd_ms = time_ms(lambda: pd.pair_decode_bwd_chunked(*ab, **kwb),
                     warmup=1, reps=3)
    a, kw = cut_pair_call(a, kw, PAIR_CHECK_ROWS)

    def as_f32(name, a):
        vt, cells, pos, rf, _, rays = a
        return vt.float(), cells, pos, rf.float(), f32w, rays

    shape = tuple(tuple(t.shape) for t in a if torch.is_tensor(t))
    with torch.inference_mode():
        row = forward_rows({("pair_decode", shape): (a, kw)}, as_f32, dev,
                           PAIR_TRAIN_TOL, bite=False)["pair_decode"]
    if PAIR_BITE * row["tolerance"] > row["spread"]:
        raise AssertionError(f"K6 in training: tolerance {row['tolerance']} "
                             f"is not {PAIR_BITE}x below the outputs' spread "
                             f"{row['spread']}")
    row["rows_checked"] = a[1].shape[0]
    row["rows_in_step"] = key[1][1][0]
    row.update(step_ms=step_ms, recompute_ms=bwd_ms,
               recompute_rows=int(live.sum().item()))
    log(f"K6 in the step: {step_ms:.4f} ms over {row['rows_in_step']} rows; "
        f"the recompute backward {bwd_ms:.4f} ms over the "
        f"{row['recompute_rows']} rows that carry a gradient")
    return row


def sum_operands(a):
    """A recorded segment-sum call kept for a replay onto a zero table: the
    table's shape, then the rows, keys and order."""
    return (tuple(a[0].shape), *(t.detach() for t in a[1:]))


def pair_steps(cfg, model, dev, batch):
    """A recorded step (K6's forward call, the recompute's, the segment
    sum's), then PAIR_STEPS counted steps of ``batch``: returns (recorded,
    the segment sum's recorded calls, launches, recompute chunks, step_ms,
    peak GiB, device ms of one step, losses)."""
    from implicit_depth_torch.ops import pair_decode as pd
    from implicit_depth_torch.ops import segment
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    state = TrainState.create(model, cfg.training, steps_per_epoch=1000)
    step = make_lidf_train_step(cfg, model, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = train_batches(PAIR_STEPS + 1, cfg, batch, dev)
    recorded = {}
    sums = record_calls(
        {"segment_sum_": (segment, "segment_sum_")},
        lambda: recorded.update(record_calls(
            {"pair_decode": (pd, "pair_decode"),
             "recompute": (pd, "pair_decode_bwd_chunked")},
            lambda: step(state, batches[0], gen, 0))),
        keep=sum_operands)
    counts = {k: f for k, f in counters().items()
              if k in EXPECT_PER_PAIR_STEP or k == "segment_sum_"}
    for f in counts.values():
        f.launches = 0
    chunks0 = pd.pair_decode_bwd_chunked.chunks
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for i, b in enumerate(batches[1:]):
        t0 = time.perf_counter()
        out = step(state, b, gen, i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: v.item() for k, v in out.items()})
    launches = {k: f.launches for k, f in counts.items()}
    chunks = pd.pair_decode_bwd_chunked.chunks - chunks0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dev_ms = profile_device_ms(lambda: step(state, batches[1], gen, 0),
                               f"batch {batch}: device time of one step",
                               table=batch == PAIR_BATCHES[0])
    for k, per in EXPECT_PER_PAIR_STEP.items():
        if launches[k] != per * PAIR_STEPS:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{PAIR_STEPS} steps, expected {per} each")
    if chunks < PAIR_STEPS or \
            launches["segment_sum_"] != SUMS_PER_CHUNK * chunks:
        raise AssertionError(f"segment_sum_: {launches['segment_sum_']} "
                             f"launches in {PAIR_STEPS} steps of {chunks} "
                             f"recompute chunks, expected {SUMS_PER_CHUNK} "
                             f"a chunk")
    if not all(np.isfinite(v) for ls in losses for v in ls.values()):
        raise AssertionError(f"a loss is not finite: {losses}")
    return recorded, sums, launches, chunks, step_ms, peak, dev_ms, losses


def pair_repeat(cfg, model, dev, batch):
    """Two steps from the same state, batches and draws, twice, under
    cuDNN's deterministic algorithms: the same losses, parameters and
    buffers bit for bit."""
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step
    batches = train_batches(2, cfg, batch, dev, seed=SEED + 7)
    runs = []
    with cudnn_flags(deterministic=True, benchmark=False):
        for _ in range(2):
            m = copy.deepcopy(model)
            state = TrainState.create(m, cfg.training, steps_per_epoch=1000)
            step = make_lidf_train_step(cfg, m, dev)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            losses = [{k: v.item() for k, v in step(state, b, gen, i).items()}
                      for i, b in enumerate(batches)]
            runs.append((losses, {k: v.clone() for k, v in
                                  m.state_dict().items()}))
            del m, state, step
            torch.cuda.empty_cache()
    (la, sa), (lb, sb) = runs
    if la != lb:
        raise AssertionError(f"losses differ: {la} {lb}")
    assert_same_tensors(f"batch {batch}: two steps twice", sa, sb)
    return True


def pair_plain_grads(dev, mode, dtype):
    """One step of batch TRAIN_BATCH in ``dtype`` through K6 and the
    recompute, and through the plain path (autograd of pair_decode_plain
    in one piece), same weights, batch and draws, cuDNN deterministic:
    {group: (largest relative error, its parameter)}; losses' largest
    relative difference."""
    from implicit_depth_torch.models import lidf as lidf_mod
    from implicit_depth_torch.models.lidf import decoder_weights
    from implicit_depth_torch.ops import decode_common as common
    from implicit_depth_torch.ops import pair_decode as pd
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    cfg, model = pair_train_model(dev, mode, dtype)
    batch = train_batches(1, cfg, TRAIN_BATCH, dev, seed=SEED + 9)[0]
    floors = {}
    bwd = pd.pair_decode_bwd_chunked

    def recorder(*a, **kw):
        floors["off_b4"] = a[7].abs().sum().item()
        floors["prob_b4"] = a[8].abs().sum().item()
        return bwd(*a, **kw)

    for k in counts_of(bwd):  # the wrapper counts on its stand-in
        setattr(recorder, k, 0)

    def plain_train(vox, cells, pos, rf, w32, rays=None, *, dtype, **kw):
        return pd.pair_decode_plain(vox, cells, pos, rf,
                                    common.round_biases(w32, pd.FORMAT,
                                                        dtype),
                                    rays, dtype=dtype, **kw)

    runs = {}
    train = lidf_mod.pair_decode_train
    for route in ("kernel", "plain"):
        m = copy.deepcopy(model)
        state = TrainState.create(m, cfg.training, steps_per_epoch=1000)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        pd.pair_decode_bwd_chunked = recorder
        if route == "plain":
            lidf_mod.pair_decode_train = plain_train
        try:
            with cudnn_flags(deterministic=True, benchmark=False):
                losses = make_lidf_train_step(cfg, m, dev)(state, batch, gen,
                                                           0)
        finally:
            lidf_mod.pair_decode_train = train
            pd.pair_decode_bwd_chunked = bwd
        names = {id(p): n for n, p in m.named_parameters()}
        last_bias = {names[id(p)]: k for k, p in decoder_weights(
            m.offset_dec, m.prob_dec).items() if k in ("off_b4", "prob_b4")}
        runs[route] = ({k: v.item() for k, v in losses.items()},
                       {n: p.grad.detach().clone()
                        for n, p in m.named_parameters()})
        del m, state
        torch.cuda.empty_cache()
    (lk, gk), (lp, gp) = runs["kernel"], runs["plain"]
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-6) for k in lp)
    errs = {n: rel_norm(gk[n], gp[n], floors[last_bias[n]]
                        if n in last_bias else 0.0) for n in gp}
    groups = {}
    for group in ("resnet", "decoders and pnet"):
        e = {n: v for n, v in errs.items()
             if n.startswith("resnet.") == (group == "resnet")}
        worst = max(e, key=e.get)
        groups[group] = (e[worst], worst)
    return loss_err, groups


def pair_cli_phase(dev, workdir, mode):
    """train_lidf.yaml in ``mode`` through the CLI (PAIR_CLI_SET), then
    test_lidf.yaml from its checkpoint in the same mode: per step K6 1, K5
    2, K1-K3 0, the segment sum SUMS_PER_CHUNK a recompute chunk; per eval
    frame K6 1, K5 2; finite losses; the test's CSV.
    Returns {kernel: launches} of both runs."""
    from implicit_depth_torch.ops import pair_decode as pd
    sets = PAIR_MODE_SETS[mode]
    chunks0 = pd.pair_decode_bwd_chunked.chunks
    tr, launches = counted(lambda: cli(dev, "lidf", workdir / f"{mode}_train",
                                       *PAIR_CLI_SET, *sets))
    chunks = pd.pair_decode_bwd_chunked.chunks - chunks0
    recs = epoch_records(tr)
    steps = tr.steps_per_epoch * len(recs)
    frames = sum(len(tr.make_valid_loaders()["synthetic"].dataset)
                 for r in recs if "valid" in r)
    expect_launches(f"{mode} CLI train_lidf", launches, steps, frames,
                    EXPECT_PER_PAIR_STEP, EXPECT_PER_PAIR_EVAL_FRAME, chunks)
    losses = [v for r in recs for v in r["train"].values()]
    if tr.model.decode_mode != mode or steps != 2 \
            or not all(np.isfinite(losses)):
        raise AssertionError(f"{mode} CLI: mode {tr.model.decode_mode}, "
                             f"records {recs}")
    test, test_launches = counted(lambda: cli(
        dev, "test", workdir / f"{mode}_test",
        f"checkpoint_path={tr.ckpt_dir}", "dataset.synthetic_len=4", *sets))
    expect_launches(f"{mode} CLI test_lidf", test_launches, 0,
                    len(test.make_valid_loaders()["synthetic"].dataset), {},
                    EXPECT_PER_PAIR_EVAL_FRAME)
    rows = read_csv(test)
    if rows[-1][0] != "MEAN" or not np.isfinite(
            np.asarray(rows[-1][1:], np.float64)).all():
        raise AssertionError(f"{mode} CLI test: CSV {rows}")
    log(f"{mode} CLI: train_lidf.yaml {steps} steps, losses "
        f"{[r['train'] for r in recs]}; test_lidf.yaml result/synthetic.csv "
        f"{len(rows) - 2} rows, MEAN {rows[-1][1:]}")
    return {k: launches[k] + test_launches[k] for k in launches}


def pair_train_phase(dev, workdir):
    """Phase 40: stage-1 training in the global (budget 8) and dense modes.
    For each mode: at each batch of PAIR_BATCHES a recorded step and
    PAIR_STEPS counted steps (K6 1, K5 2, K1-K3 0 a step; host ms, device
    ms, peak GiB), K6 against its plain version on the recorded forward
    call, two steps twice bit for bit under cuDNN's deterministic
    algorithms; at batch 4 the step's gradients against the plain path's
    (f32 and bf16); an f32 step card vs CPU at XCHECK_TRAIN (as phase 8);
    then train_lidf.yaml and test_lidf.yaml through the CLI. Returns
    ({mode: its record}, the segment sum's row: its calls recorded in the
    global mode's step at the last of PAIR_BATCHES, for phase 44, and its
    launches in that batch's counted steps)."""
    failed, out = [], {}
    for mode in MODES:
        t_mode = time.perf_counter()
        rec = {}
        for batch in PAIR_BATCHES:
            cfg, model = pair_train_model(dev, mode)
            f32w = pair_f32_operands(model)
            recorded, sums, launches, chunks, step_ms, peak, dev_ms, \
                losses = pair_steps(cfg, model, dev, batch)
            k6 = pair_k6_row(recorded, f32w, dev)
            del recorded
            if mode == "global" and batch == PAIR_BATCHES[-1]:
                sum_row = {"recorded": sums, "recompute_chunks": chunks,
                           "launches_per_chunk": SUMS_PER_CHUNK,
                           **add_launches({}, launches["segment_sum_"],
                                          PAIR_STEPS, "step")}
            del sums
            torch.cuda.empty_cache()
            same = pair_repeat(cfg, model, dev, batch)
            log(f"{mode} training batch {batch}: launches {launches} in "
                f"{PAIR_STEPS} steps ({chunks} recompute chunks), step_ms "
                f"{step_ms}, device ms of a step "
                f"{dev_ms:.3f}, peak {peak:.2f} GiB, losses {losses}; K6 "
                f"max_abs_err {k6['max_abs_err']:.3g} (tol "
                f"{k6['tolerance']}, spread {k6['spread']:.3g}) on "
                f"{k6['rows_checked']} of {k6['rows_in_step']} rows")
            rec[f"batch{batch}"] = {
                "launches_per_step": {k: n // PAIR_STEPS
                                      for k, n in launches.items()},
                "recompute_chunks": chunks,
                "step_ms": step_ms, "step_device_ms": dev_ms,
                "peak_gib": peak, "repeat_bit_identical": same,
                "k6": {k: k6[k] for k in (
                    "dtype", "shape", "max_abs_err", "tolerance", "spread",
                    "ms", "plain_ms", "bound_ms", "bound_by", "rows_checked",
                    "rows_in_step", "rows_decoded", "step_ms", "recompute_ms",
                    "recompute_rows") if k in k6}}
            del model
            torch.cuda.empty_cache()
        for dtype, limits in (("float32", None), ("bfloat16",
                                                  PAIR_BF16_GRAD_RTOL)):
            loss_err, groups = pair_plain_grads(dev, mode, dtype)
            log(f"{mode} {dtype} step, K6 and the recompute against the "
                f"plain path: largest relative loss difference "
                f"{loss_err:.3g}; gradients, largest relative error: "
                + "; ".join(f"{g} {e:.3g} ({n})"
                            for g, (e, n) in groups.items()))
            rec[f"vs_plain_{dtype}"] = {g: e for g, (e, _) in groups.items()}
            for g, (e, n) in groups.items():
                tol = PAIR_GRAD_RTOL if limits is None else limits[g]
                if e > tol:
                    failed.append(f"{mode} {dtype} vs plain: {g} {e} ({n}) "
                                  f"> {tol}")
        failed += cross_check_seed(dev, SEED, witness=False, mode=mode)
        rec["cli_launches"] = pair_cli_phase(dev, workdir, mode)
        rec["seconds"] = time.perf_counter() - t_mode
        log(f"phase 40 {mode}: {rec['seconds']:.1f} s")
        out[mode] = rec
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase 40: {failed}")
    return out, sum_row


# -- phase 41: the reference's model options at their widths -----------------
# the default model with each width option of the reference (seeded
# weights, bf16): W1 imnet_gf 48 (run at the compiled 64, zero units), W2
# 128 (the single-buffered layout; K3 on tiles of 32 rows), W3 rgb_out 64
# (crp 288), W4 roi_out_bbox 4 (crp 544; K4's and K6's rows 720 and 784
# wide), W5 pnet_out 100 (the voxel table padded to 112 columns), W6
# pnet_out 512 with multires 10 (kp 640; K6's rows 800 wide)
MODEL_WIDTHS = {
    "W1": {"model": {"imnet_gf": 48}, "refine": {"imnet_gf": 48}},
    "W2": {"model": {"imnet_gf": 128}, "refine": {"imnet_gf": 128}},
    "W3": {"model": {"rgb_out": 64}},
    "W4": {"model": {"roi_out_bbox": 4}},
    "W5": {"model": {"pnet_out": 100}, "refine": {"pnet_out": 100}},
    "W6": {"model": {"pnet_out": 512, "multires": 10},
           "refine": {"pnet_out": 512}},
}
# the configurations whose stage-1 steps also run twice, bit for bit
MODEL_WIDTH_REPEAT = ("W2", "W6")
# Phase 41's checks: bf16 alone (the cross-checks' f32, which takes
# imnet_gf <= 64, is held by phases 26-29); phases 3, 7, 10 and 11's
# tolerances (TOL, TRAIN_TOL), each lowered, where it does not lie BITE
# times below the spread of the outputs it compares, to that spread over
# BITE, and never raised. The randomized models at these widths spread
# some outputs less than the default model's (NVIDIA H100 80GB HBM3, a run
# with every check logged: the served K1's std 0.0315 at W3 against the
# default's 0.050, K2's logit 0.0067 at W2), while a bf16 flip of a hidden
# activation moves an output by a few hundredths of its spread at every
# width (K1 0.023-0.080 of it, K2 0.015-0.057, K4 0.012-0.032, K6
# 0.007-0.020). Timing: a call after one warm-up call, or the median of
# BUDGET_REPS under BUDGET_SLOW_MS; no K3 passes, no K5 profile (phases 3
# and 7: neither has a width).
MODEL_WIDTH_CHECKS = Checks(dtypes=(torch.bfloat16,), cap=True, quick=True,
                            warmup=1, profiled=())
# K4's call in the stage-2 step is compared and its error and spread
# recorded, not held: at W2 and W5 its outputs sit in the soft clamp's
# flat part (mean 0.997 and 1.01, std 0.0139 and 0.0025), where an
# activation's error passes at slope 1 while the spread is compressed, so
# that no tolerance above the readings (W2 2.19e-3) lies BITE times below
# the spread, and at W4 it read 5.11e-3, above TOL's 4e-3 (its std 0.112).
# The served frame's K4 call holds K4 at every width (4e-3; std
# 0.069-0.156), and the step's K4 gradient is held at phase 13's
# tolerances.
# what the kernels line keeps of a kernel's row at a width option
MODEL_WIDTH_KEYS = WIDTH_KEYS + ("spread", "frame_ms", "step_ms", "widths",
                                 "grad", "train", "steps_bit_identical",
                                 "dense")

# -- phase 42: every width option at its extreme at once, bf16 and f32 ------
# W7: the default model with W2-W6's options all at once (kp 640, crp
# 1056, K4's rows 1616, K6's 1696; decoders 512-256-128-1): K1/K2's and
# K4's and K6's bf16 blocks stage X in chunks, K3's Pass A runs on tiles of
# 16 rows; then W7 and W2 with the model computing in f32 (the FMA
# instances on blocks of 16 rows, K3's Pass A on tiles of 16). Each run as
# phase 41's, with the dense mode beside ``global``; the f32 runs hold each
# kernel to its plain version in f32 at phase 41's rule (MODEL_WIDTH_CHECKS
# in f32: width_checks)
W7_OPTIONS = {"model": {"imnet_gf": 128, "pnet_out": 512, "multires": 10,
                        "rgb_out": 64, "roi_out_bbox": 4},
              "refine": {"imnet_gf": 128, "pnet_out": 512}}
WIDEST_WIDTHS = {
    "W7": W7_OPTIONS,
    "W7 f32": {**W7_OPTIONS, "tpu": {"compute_dtype": "float32"}},
    "W2 f32": {**MODEL_WIDTHS["W2"], "tpu": {"compute_dtype": "float32"}},
}
WIDEST_REPEAT = ("W7",)
# phase 41's rule, each output of a forward kernel held to its own spread
# over the rows decoded (as row_checks holds K2's): at W7 the `global`
# call's K6 offsets spread 0.0116 over its 280,001 decoded rows and its
# logits over 0.04 (NVIDIA H100 80GB HBM3); the least spread of the two,
# over every row (the 334,399 past the count 0 in both), read 0.00785,
# and would hold the logits' bf16 error (1.28e-3) to a tenth of it
WIDEST_CHECKS = MODEL_WIDTH_CHECKS._replace(per_output=True)


def width_checks(opts, checks=MODEL_WIDTH_CHECKS):
    """``checks`` in the type the option's model computes in."""
    if opts.get("tpu", {}).get("compute_dtype") == "float32":
        return checks._replace(dtypes=(torch.float32,))
    return checks


def model_widths(cfg):
    """The layer-1 and decoder widths a configuration gives the kernels:
    imnet_gf (stage 1, stage 2) and the compiled width each runs at, the
    voxel width and its padded one, K1/K2/K3's kp and crp, K4's and K6's
    row widths, whether K1's block takes the single layout, K3's rows a
    tile, in the type the configuration computes in."""
    from implicit_depth_torch.models.embedder import posenc_dim
    from implicit_depth_torch.ops import decode_common as common
    from implicit_depth_torch.ops import pair_decode as pd
    from implicit_depth_torch.ops import ray_decode as rd
    m, r = cfg.model, cfg.refine
    bf16 = cfg.tpu.compute_dtype == "bfloat16"
    c_vox, c_end = (-(-c // common.VOX_MULTIPLE) * common.VOX_MULTIPLE
                    for c in (m.pnet_out, r.pnet_out))
    c_roi = m.rgb_out * m.roi_out_bbox ** 2
    kp = -(-(c_vox + 6 + 12 * m.multires) // 16) * 16
    crp = -(-(c_roi + posenc_dim(m.multires_views)) // 16) * 16
    g, g2 = common.compiled_gf(m.imnet_gf), common.compiled_gf(r.imnet_gf)
    return {"imnet_gf": [m.imnet_gf, g], "refine_imnet_gf": [r.imnet_gf, g2],
            "c_vox": [m.pnet_out, c_vox], "kp": kp, "crp": crp,
            "k4_kp": -(-(c_end + c_roi + posenc_dim(r.multires_views)
                         + posenc_dim(r.multires)) // 16) * 16,
            "k6_kp": pd.pair_layout(c_vox, c_roi, posenc_dim(m.multires_views),
                                    m.multires)["kp"],
            "k1_layout": common.decode_plan("K1", kp, crp, g=g, is_bf16=bf16)[
                "layout"],
            "k3_rows": rd.bwd_plan(1, kp, crp, 2, bf16, 132, g=g,
                                   c_vox=c_vox)["rows_per_tile"]}


def model_width_phase(dev, widths=MODEL_WIDTHS, repeat=MODEL_WIDTH_REPEAT,
                      pair_modes=("global",), base_checks=MODEL_WIDTH_CHECKS):
    """Phase 41 (and 42, with WIDEST_WIDTHS, WIDEST_REPEAT, the dense mode
    beside ``global`` in ``pair_modes`` and WIDEST_CHECKS): the default
    model at each
    width option of ``widths``, through its entry points, in bf16 (or the
    option's ``tpu.compute_dtype``): DepthCompleter.complete on a
    480x640 frame per_ray (K1, K4, K5 recorded, then a frame counted: K1 1,
    K4 2, K5 10) and in each of ``pair_modes`` (K6 recorded, then a frame
    counted: K6 1, K4 2, K5 10); a bare 240x320 batch-4 stage-1 step with
    ``decode_bwd`` kernel_save (K2 1, K3 1, K5 2), one with kernel (K1 1,
    K3 1, K5 2) and one with kernel_save_all (K2 'all' 1, K3 1, K5 2),
    each after a recorded one; a stage-2 step behind the
    frozen stage 1 (K1 1, K4 2, K5 10). Each recorded call against its
    plain version (``base_checks`` in the model's type, width_checks:
    the tolerances of phases 3, 7, 10 and 11, each at least BITE times
    below the outputs' spread; K4 in the step: recorded, its gradient at
    phase 13's tolerances); K3 twice on each recorded call, the same bits;
    at ``repeat`` two steps twice bit for bit. Cuts: one counted frame or
    step a path; one type an option. Returns {kernel: {option: its
    row}}; a mode past ``global`` under the K6 row's key of that mode."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter

    frames = make_frames(2, FRAME_HW)
    tols = {**TOL, **TRAIN_TOL}
    out = {}

    def put(name, w, row, widths):
        row = {**row, "widths": widths}
        out.setdefault(name, {})[w] = {k: row[k] for k in MODEL_WIDTH_KEYS
                                       if k in row}

    for w, opts in widths.items():
        t_w = time.perf_counter()
        checks = width_checks(opts, base_checks)
        serve = merged(SERVE_OVERRIDES, opts)
        cfg = load_config(overrides=serve)
        at = model_widths(cfg)
        log(f"{w}: {opts}: {at}")
        lidf, refine = build_models(cfg)
        dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
        with torch.inference_mode():
            # the recorded calls are in the type the checks compare
            rows = forward_rows(record_calls(
                kernel_modules(), lambda: dc.complete(*frames[0])),
                lambda name, a: a, dev, tols, checks=checks)
        launches, frame_ms = main_path(dc, frames[1:], cfg,
                                       label=f"{w} main path")
        for name, n in launches.items():
            add_launches(rows[name], n, 1, "frame")
        rows["ray_decode"]["frame_ms"] = frame_ms
        del dc, lidf, refine
        for mode in pair_modes:
            cfg_g = load_config(overrides=mode_overrides(serve, mode))
            lidf, refine = build_models(cfg_g)
            dc = DepthCompleter(cfg_g, lidf=lidf, refine=refine, device=dev)
            k6 = pair_kernel_rows(record_calls(
                {"pair_decode": kernel_modules()["pair_decode"]},
                lambda: dc.complete(*frames[0])), lidf, dev, tols, checks)
            launches, frame_ms = main_path(dc, frames[1:], cfg_g,
                                           EXPECT_PER_MODE_FRAME,
                                           f"{w} {mode} mode")
            k6 = add_launches(k6, launches["pair_decode"], 1, "frame")
            k6["frame_ms"] = frame_ms
            if mode == "global":
                rows["pair_decode"] = k6
            else:
                rows["pair_decode"][mode] = {
                    k: v for k, v in k6.items()
                    if k in MODEL_WIDTH_KEYS and k != "widths"}
            del dc, lidf, refine
            torch.cuda.empty_cache()
        train = merged(TRAIN_OVERRIDES, opts)
        for decode_bwd, expect in (
                ("kernel_save", EXPECT_PER_STEP),
                ("kernel", EXPECT_PER_STEP_KERNEL),
                ("kernel_save_all", EXPECT_PER_STEP_SAVE_ALL)):
            cfg_t, model = train_mode_model(dev, train, decode_bwd)
            recorded, launches, step_ms = train_path(cfg_t, model, dev,
                                                     expect=expect, steps=1)
            if decode_bwd == "kernel_save":
                got = train_kernel_phase(recorded, tols, checks)
                fwd, bwd = "ray_decode_save", "ray_decode_bwd"
            elif decode_bwd == "kernel_save_all":
                got = save_all_kernel_rows(recorded, tols, checks)
                fwd, bwd = "ray_decode_save_all", "ray_decode_bwd_all"
            else:
                got = {"ray_decode_bwd_recompute":
                       recompute_kernel_rows(recorded, tols, checks)}
                rows["ray_decode"]["train"] = {
                    k: v for k, v in add_launches(
                        train_forward_row(recorded, dev, tols, checks),
                        launches["ray_decode"], 1, "step").items()
                    if k in WIDTH_KEYS}
                fwd, bwd = None, "ray_decode_bwd_recompute"
            if fwd:
                add_launches(got[fwd], launches[fwd], 1, "step")
            add_launches(got[bwd], launches["ray_decode_bwd"], 1, "step")
            got[bwd]["step_ms"] = statistics.median(step_ms)
            got[bwd]["repeat_bit_identical"] = k3_repeats(recorded)
            log(f"{w}: {bwd} twice on the recorded call: the same bits")
            if decode_bwd == "kernel_save" and w in repeat:
                got[bwd]["steps_bit_identical"] = pair_repeat(
                    cfg_t, model, dev, TRAIN_BATCH)
                log(f"{w}: two steps twice: the same bits")
            rows.update(got)
            del model, recorded
            torch.cuda.empty_cache()
        cfg_r = load_config(overrides=merged(REFINE_OVERRIDES, opts))
        lidf, refine = (m.to(dev) for m in build_models(cfg_r,
                                                        train=True))
        run2 = refine_train_path(cfg_r, lidf, refine, dev, 1,
                                 label=f"{w} stage 2")
        k4 = refine_k4_row(run2["recorded"], dev, dtypes=checks.dtypes,
                           tols=tols, checks=checks, held=False)
        rows["ief_decode"]["train"] = {
            k: v for k, v in add_launches(
                k4, run2["launches"]["ief_decode"], 1, "step").items()
            if k in MODEL_WIDTH_KEYS}
        rows["ief_decode"]["train"]["step_ms"] = run2["step_ms"]
        del lidf, refine, run2
        torch.cuda.empty_cache()
        for name, row in rows.items():
            put(name, w, row, at)
        log(f"{w}: {time.perf_counter() - t_w:.1f} s")
    return out


# -- phase 43: the profiling module on the card --------------------------------
# implicit_depth_torch/utils/profiling.py on the default model at full width,
# bf16: a served per_ray frame timed by device_slope_time beside its CUDA
# events and by interleaved_slope on the host clock, then torch.profiler
# traces of one served frame and of one batch-4 kernel_save stage-1 step.
# Each trace must name, by CUDA symbol, every hand-written kernel its path
# launches, as many times as the launch counters say: the proof that the
# profiler sees the kernels launched through ctypes. Each trace's idle is
# split by the program's spans (sum held to the idle share within
# IDLE_SPLIT_SLACK of the window), and every wait of the host for the card
# in the frame and the step must lie in a span named in SYNC_SPANS
TRACE_DIR = ROOT / "build" / "traces"
IDLE_SPLIT_SLACK = 0.01
SYNC_SPANS = ("sync.", "infer.read_back")
SLOPE_ITERS = (2, 12)    # device_slope_time's runs of the frame's forward
HOST_ITERS = (1, 5)      # interleaved_slope's runs of complete()
TOP_OPS = 10
# each wrapper's kernels by (CUDA symbol, first template argument where it
# tells them apart: K1's and K2's save mode) and how many a launch puts on
# the stream: K3 one Pass A and one Pass B a chunk of rays (bwd_plan), then
# two reductions; K5's bf16 epilogue (to_bf16) is listed, not held
TRACE_SYMBOLS = {
    "ray_decode": {("ray_decode_tc", 0): 1},
    "ray_decode_save": {("ray_decode_tc", 1): 1},
    "ief_decode": {("ief_decode_tc", None): 1},
    "segment_max0": {("segment_max_kernel", None): 1},
    "ray_decode_bwd": {("pass_a_kernel", None): "chunks",
                       ("pass_b_kernel", None): "chunks",
                       ("reduce_kernel", None): 2},
}


def kernel_symbol(name):
    """(symbol, first template argument where it is an integer) of a
    kernel of the port's CUDA sources (each in an anonymous namespace), from
    its demangled or its mangled name; None for any other device
    operation."""
    import re
    m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)(?:<(\d+)[,>])?",
                 name)
    if m:
        return m.group(1), int(m.group(2)) if m.group(2) else None
    m = re.match(r"_ZN12_GLOBAL__N_1(\d+)", name)
    if m:
        end = m.end() + int(m.group(1))
        arg = re.match(r"ILi(\d+)E", name[end:])
        return name[m.end():end], int(arg.group(1)) if arg else None
    return None


def traced_kernels(prof):
    """{(symbol, template argument): (count, device ms)} of the port's
    kernels in a profile."""
    from implicit_depth_torch.utils import profiling
    out = {}
    for name, (ms, count) in profiling.device_ops(prof).items():
        sym = kernel_symbol(name)
        if sym is not None:
            n0, ms0 = out.get(sym, (0, 0.0))
            out[sym] = (n0 + count, ms0 + ms)
    return out


def traced_phase(label, run, expect, chunks=None):
    """``run()`` once under ``profiling.trace`` with the launch counters of
    ``expect`` from 0: logs the trace's ten longest device operations, the
    device-idle share of the window and the trace's path; fails unless
    every wrapper launched as ``expect`` says and the trace holds each of
    its kernels as many times (K3's chunks: ``chunks``). Returns the
    launches, the symbols' counts and device ms, and the idle share."""
    from implicit_depth_torch.utils import profiling
    counts = {k: f for k, f in counters().items() if k in expect}
    for f in counts.values():
        f.launches = 0
    with profiling.stage_timer(label, sync=True):
        with profiling.trace(str(TRACE_DIR), cuda=True) as t:
            run()
    launches = {k: f.launches for k, f in counts.items()}
    ops = profiling.device_ops(t.profile)
    idle = profiling.device_idle_share(t.profile)
    by_span = idle_split(label, t.profile, idle)
    log(f"{label}: the {TOP_OPS} longest device operations (ms, count):")
    for name, (ms, n) in list(ops.items())[:TOP_OPS]:
        log(f"  {ms:9.3f} {n:5d}  {name[:120]}")
    log(f"{label}: device time {sum(ms for ms, _ in ops.values()):.3f} ms, "
        f"device idle {idle:.4f} of the traced window; launches "
        f"{launches}; Chrome trace {t.path}")
    found = traced_kernels(t.profile)
    log(f"{label}: the port's kernels in the trace {found}")
    failed = [f"{k}: {launches[k]} launches, expected {n}"
              for k, n in expect.items() if launches[k] != n]
    symbols = {}
    for name, n in launches.items():
        for sym, per in TRACE_SYMBOLS[name].items():
            want = n * (chunks if per == "chunks" else per)
            hits = [v for (s, arg), v in found.items()
                    if s == sym[0] and sym[1] in (None, arg)]
            got = (sum(c for c, _ in hits), sum(ms for _, ms in hits))
            symbols[f"{sym[0]}" + (f"<{sym[1]}>" if sym[1] is not None
                                   else "")] = {"count": got[0],
                                                "device_ms": got[1]}
            if got[0] != want:
                failed.append(f"{name}: {got[0]} kernels {sym} in the "
                              f"trace, expected {want}")
    if failed:
        raise AssertionError(f"phase 43 {label}: {failed}")
    return {"launches": launches, "symbols": symbols, "idle_share": idle,
            "idle_by_span": by_span,
            "device_ms": sum(ms for ms, _ in ops.values()),
            "trace": str(t.path)}


def idle_split(label, prof, idle):
    """profiling.idle_by_span of a trace, logged; fails unless its parts
    sum to the device-idle share ``idle`` times the window within
    IDLE_SPLIT_SLACK of the window."""
    from implicit_depth_torch.utils import profiling
    events = prof.events()
    window = (max(ev.time_range.end for ev in events)
              - min(ev.time_range.start for ev in events)) / 1e6
    by_span = profiling.idle_by_span(prof)
    off = abs(sum(by_span.values()) - idle * window)
    log(f"{label}: idle by program span (ms) " + ", ".join(
        f"{k} {v * 1e3:.3f}" for k, v in by_span.items())
        + f"; the sum {off * 1e3:.4f} ms off the idle share times the "
        f"{window * 1e3:.3f} ms window")
    if off > IDLE_SPLIT_SLACK * window:
        raise AssertionError(f"phase 43 {label}: idle_by_span sums "
                             f"{off * 1e3:.4f} ms off of a {window * 1e3:.3f}"
                             " ms window")
    return by_span


def sync_sites(label, run):
    """``run()`` with tracing on under torch.cuda.set_sync_debug_mode
    ("warn"): {innermost open span: waits} of every operation that made
    the host wait for the card, on whichever thread; fails unless each
    lies in a span of SYNC_SPANS."""
    import collections
    import threading
    import warnings

    from implicit_depth_torch.utils import profiling
    found, stray = collections.Counter(), []
    show = warnings.showwarning

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):  # the mode's notice
            return show(message, category, filename, lineno, file, line)
        inner = (profiling.open_spans() or ["(no span)"])[-1]
        found[inner] += 1
        if not inner.startswith(SYNC_SPANS):
            stray.append(f"{inner} [{threading.current_thread().name}] "
                         f"{filename}:{lineno}: {str(message)[:60]}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        profiling.enable()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            profiling.disable()
    torch.cuda.synchronize()
    log(f"{label}: host waits by span {dict(found)}")
    if stray:
        raise AssertionError(f"phase 43 {label}: waits outside a sync span: "
                             f"{stray}")
    return dict(found)


def profiling_phase(dev):
    """Phase 43 (see TRACE_DIR); returns {kernel: {"frame" / "step":
    launches in the trace}} and the phase's readings."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.ops import ray_decode as rd
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step
    from implicit_depth_torch.utils import profiling

    cfg = load_config(overrides=SERVE_OVERRIDES)
    lidf, refine = build_models(cfg)
    dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
    frame = make_frames(1, FRAME_HW)[0]
    dc.complete(*frame)
    batch = dc.device_batch([frame[0]], [frame[1]], [frame[2]])

    def forward(gen, b):  # each call's valid-point draw from its generator
        return dc.forward(b, seed=gen.initial_seed())[0].sum()

    slope_ms = profiling.device_slope_time(
        forward, batch, iters_a=SLOPE_ITERS[0], iters_b=SLOPE_ITERS[1]) * 1e3
    event_ms = time_ms(lambda: dc.forward(batch, 0))
    runs = [lambda n=n: [dc.complete(*frame) for _ in range(n)]
            for n in HOST_ITERS]
    host_ms = profiling.interleaved_slope(*runs, *HOST_ITERS) * 1e3
    log(f"phase 43 served frame: device_slope_time {slope_ms:.3f} ms a "
        f"forward (runs of {SLOPE_ITERS}), CUDA events {event_ms:.3f} ms "
        f"(median of 10), interleaved_slope of complete() {host_ms:.3f} ms "
        "a frame on the host clock")
    out = {"frame_slope_ms": slope_ms, "frame_event_ms": event_ms,
           "frame_host_ms": host_ms}
    out["frame"] = traced_phase("phase 43 traced frame",
                                lambda: dc.complete(*frame),
                                EXPECT_PER_FRAME)
    out["frame"]["sync_sites"] = sync_sites("phase 43 frame",
                                            lambda: dc.complete(*frame))
    del dc, lidf, refine, batch
    torch.cuda.empty_cache()

    cfg_t = load_config(overrides=TRAIN_OVERRIDES)
    gen = torch.Generator().manual_seed(SEED + 1)
    model = randomize_weights_(build_lidf(cfg_t, build_static(cfg_t), gen),
                               gen).to(dev)
    state = TrainState.create(model, cfg_t.training, steps_per_epoch=1000)
    step = make_lidf_train_step(cfg_t, model, dev)
    step_gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = train_batches(2, cfg_t, TRAIN_BATCH, dev)
    recorded = record_train_calls(step, state, batches[0], step_gen)
    a3, kw3 = recorded["ray_decode_bwd"]
    chunks = rd.ray_decode_bwd_pass_ms(*a3, **kw3)["chunks"]
    out["step"] = traced_phase(
        f"phase 43 traced step (batch {TRAIN_BATCH}, decode_bwd "
        f"{cfg_t.tpu.decode_bwd})",
        lambda: step(state, batches[1], step_gen, 1), EXPECT_PER_STEP,
        chunks)
    out["step"]["k3_chunks"] = chunks
    out["step"]["sync_sites"] = sync_sites(
        "phase 43 step", lambda: step(state, batches[1], step_gen, 1))
    out["stage_seconds"] = profiling.stage_times()
    log(f"phase 43 stage_times {out['stage_seconds']}")
    del model, state, step, recorded
    torch.cuda.empty_cache()
    per_kernel = {}
    for where in ("frame", "step"):
        for name, n in out[where]["launches"].items():
            per_kernel.setdefault(name, {})[where] = n
    return per_kernel, out


# phase 44: a step of train.lidf.allpairs.b32's recompute backward (C24b:
# 726-786 k live rows, 6 chunks): rows, chunk, the voxel table (B·9³ cells
# x c_vox) and the per-ray rows (B·R x c_roi + c_dir), rows of one cell
SUM_ROWS, SUM_CHUNK = 760_000, 1 << 17
SUM_VOX, SUM_RAYS, SUM_BIG = (23_328, 128), (640_000, 155), 50_000


def segment_sum_inputs(dev, seed=SEED):
    """(cells, rays, f32 voxel-row gradients, bf16 ray-row gradients) of
    SUM_ROWS live rows: cells drawn with a heavy skew (many rays cross a
    few voxels) and SUM_BIG rows of the first chunk in one cell; rays
    uniform."""
    g = torch.Generator(dev).manual_seed(seed)
    weight = torch.rand(SUM_VOX[0], generator=g, device=dev) ** 8
    cells = torch.multinomial(weight, SUM_ROWS, replacement=True,
                              generator=g)
    cells[torch.randperm(SUM_CHUNK, generator=g, device=dev)[:SUM_BIG]] = \
        SUM_VOX[0] // 3
    rays = torch.randint(0, SUM_RAYS[0], (SUM_ROWS,), generator=g,
                         device=dev)
    return (cells, rays,
            torch.randn(SUM_ROWS, SUM_VOX[1], generator=g, device=dev),
            torch.randn(SUM_ROWS, SUM_RAYS[1], generator=g,
                        device=dev).bfloat16())


# the segment sum against the index_put_ it replaced, which sums the same
# rows in f32 in another order: relative norm of the difference
SUM_GAP = 1e-5


def sum_bytes(rows, keys_by_chunk):
    """Bytes the segment sum moves: the rows once, a key and an order (int64)
    a row, each table row a chunk touches read and written once in f32."""
    c = rows.shape[1]
    touched = sum(int(torch.unique(k).numel()) for k in keys_by_chunk) * c
    return nbytes(rows) + 16 * rows.shape[0] + 8 * touched


def segment_sum_replays(dev, recorded):
    """Phase 44's replays of the segment sum's calls recorded in phase 40
    (see the module docstring): the row of the largest call, with every
    call's readings under ``by_shape``."""
    from implicit_depth_torch.ops import segment
    calls = []
    for (_, shapes), (a, _) in sorted(recorded.items()):
        shape, rows, keys, order = a
        index = torch.empty_like(keys)
        index[order] = keys  # each row's table row, as index_put_ took it

        def zero():
            return torch.zeros(shape, device=dev)

        def old(table):
            return table.index_put_((index,), rows.float(), accumulate=True)

        got = [segment.segment_sum_(zero(), rows, keys, order)
               for _ in range(2)]
        plain = segment.segment_sum_plain_(zero(), rows, keys, order)
        ref = old(zero())
        torch.cuda.synchronize()
        label = (f"segment_sum_ {list(shape)} x {rows.shape[0]} "
                 f"{str(rows.dtype).split('.')[-1]} rows")
        assert torch.equal(got[0], got[1]), f"{label}: not the same bits"
        assert torch.equal(got[0], plain), f"{label}: not the plain bits"
        gap = rel_norm(got[0], ref)
        assert gap <= SUM_GAP, f"{label}: {gap} from index_put_"
        del got, plain, ref
        table = zero()
        row = {"name": "segment_sum_",
               "dtype": str(rows.dtype).split(".")[-1],
               "shape": [list(x) for x in shapes], "max_abs_err": 0.0,
               "tolerance": 0.0, "rel_gap_to_index_put": gap,
               "ms": time_ms(lambda: segment.segment_sum_(table, rows, keys,
                                                          order)),
               "plain_ms": time_ms(lambda: segment.segment_sum_plain_(
                   table, rows, keys, order), 1, 3),
               "library_ms": time_ms(lambda: old(table), 1, 5),
               "bound_ms": sum_bytes(rows, [keys]) / PEAK_BYTES * 1e3,
               "bound_by": "bytes"}
        log(f"kernel {label}: the plain bits, twice; rel gap to index_put_ "
            f"{gap:.3g}; ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
            f"library_ms {row['library_ms']:.4f} bound_ms "
            f"{row['bound_ms']:.4f} (bytes)")
        calls.append((rows.numel(), row))
        del table
    if not calls:
        raise AssertionError("phase 44: no segment-sum call was recorded")
    out = dict(max(calls, key=lambda c: c[0])[1])
    out["by_shape"] = [{k: r[k] for k in ("shape", "dtype", "ms", "plain_ms",
                                          "library_ms", "bound_ms")}
                       for _, r in calls]
    return out


def segment_sum_phase(dev, recorded):
    """Phase 44 (see the module docstring): the segment sum's row of the
    kernels line, the calls ``recorded`` in phase 40 replayed, and its
    readings at the cell's shapes under ``at_cell_shapes``."""
    from implicit_depth_torch.ops import segment
    row = segment_sum_replays(dev, recorded)
    cells, rays, vox_rows, ray_rows = segment_sum_inputs(dev)
    index = ((cells, vox_rows, SUM_VOX), (rays, ray_rows, SUM_RAYS))

    def by(add):
        tables = [torch.zeros(shape, device=dev) for _, _, shape in index]
        plans = [segment.chunk_sort(i, SUM_CHUNK, shape[0]) if add else None
                 for i, _, shape in index]
        for s in range(0, SUM_ROWS, SUM_CHUNK):
            for table, plan, (i, rows, _) in zip(tables, plans, index):
                if add is None:  # the sorted index_put_ it replaced
                    table.index_put_((i[s:s + SUM_CHUNK],),
                                     rows[s:s + SUM_CHUNK].float(),
                                     accumulate=True)
                    continue
                keys, order = (t[s:s + SUM_CHUNK] for t in plan)
                add(table, rows[s:s + SUM_CHUNK], keys, order)
        return tables

    segment.segment_sum_.launches = 0
    got = by(segment.segment_sum_)
    chunks = -(-SUM_ROWS // SUM_CHUNK)
    assert segment.segment_sum_.launches == SUMS_PER_CHUNK * chunks
    again = by(segment.segment_sum_)
    plain = by(segment.segment_sum_plain_)
    old = by(None)
    torch.cuda.synchronize()
    out = {"rows": SUM_ROWS, "chunks": chunks, "rel_gap_to_index_put": {}}
    for name, a, b, p, o in zip(("vox", "ray"), got, again, plain, old):
        assert torch.equal(a, b), f"segment sum {name}: not the same bits"
        assert torch.equal(a, p), f"segment sum {name}: not the plain bits"
        gap = rel_norm(a, o)
        assert gap <= SUM_GAP, f"segment sum {name}: {gap} from index_put_"
        out["rel_gap_to_index_put"][name] = gap
    del got, again, plain, old
    out["kernel_ms"] = time_ms(lambda: by(segment.segment_sum_))
    out["index_put_ms"] = time_ms(lambda: by(None), 1, 5)
    out["plain_ms"] = time_ms(lambda: by(segment.segment_sum_plain_), 1, 3)
    _, ops = device_ms(lambda: by(segment.segment_sum_), "segment_sum",
                       reps=10)
    out["device_ops_ms"] = {k: round(v[0], 4) for k, v in ops.items()}
    out["kernels_device_ms"] = sum(v[0] for k, v in ops.items()
                                   if "segment_sum" in k)
    out["bound_ms"] = sum(
        sum_bytes(rows, [i[s:s + SUM_CHUNK]
                         for s in range(0, SUM_ROWS, SUM_CHUNK)])
        for i, rows, _ in index) / PEAK_BYTES * 1e3
    log(f"phase 44 at the cell's shapes: {json.dumps(out)}")
    row["at_cell_shapes"] = out
    return row


def run(dev, overrides=SERVE_OVERRIDES, frame_hw=FRAME_HW, profile=False,
        train_overrides=TRAIN_OVERRIDES):
    """Phases 2-44 on ``dev``; prints their seconds and the kernels line."""
    t_start = time.perf_counter()
    from implicit_depth_torch.builder import (
        build_lidf,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter

    build_phase()
    # random weights from a seed, redrawn at unit activation scale so that
    # every comparison below sees decoder outputs spread over (0, 1)
    cfg = load_config(overrides=overrides)
    lidf, refine = build_models(cfg)
    static = lidf.static
    lidf_cpu, refine_cpu = copy.deepcopy(lidf), copy.deepcopy(refine)
    dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
    log(f"model: {cfg.dataset.img_height}x{cfg.dataset.img_width}, "
        f"K={static.k_pairs}, kb={cfg.tpu.pairs_budget_per_ray}, "
        f"valid={static.n_valid}, dtype={cfg.tpu.compute_dtype}, "
        f"forward_times={cfg.refine.forward_times}")
    frames = make_frames(MAIN_FRAMES + 1, frame_hw)

    rows = kernel_phase(record_calls(kernel_modules(),
                                   lambda: dc.complete(*frames[0])),
                      lidf, refine, dev)
    launches, _ = main_path(dc, frames[1:], cfg)
    for name, n in launches.items():
        add_launches(rows[name], n, MAIN_FRAMES, "frame")
    if profile:
        profile_device_ms(lambda: dc.complete(*frames[1]),
                          "main path: device time of one frame")
    cross_check(overrides, lidf_cpu, refine_cpu, frames[1], dev)
    del dc, lidf, refine, lidf_cpu, refine_cpu
    torch.cuda.empty_cache()
    rows["segment_sum_"] = {}  # the recompute's: phases 40 and 44

    # -- stage-1 training ------------------------------------------------------
    cfg_t = load_config(overrides=train_overrides)
    static_t = build_static(cfg_t)
    gen = torch.Generator().manual_seed(SEED + 1)
    model = randomize_weights_(build_lidf(cfg_t, static_t, gen), gen).to(dev)
    log(f"training model: {cfg_t.dataset.img_height}x"
        f"{cfg_t.dataset.img_width}, batch {TRAIN_BATCH} (configured "
        f"{cfg_t.training.batch_size}), rays {static_t.n_rays}, valid "
        f"{static_t.n_valid}, K={static_t.k_pairs}, "
        f"kb={cfg_t.tpu.pairs_budget_per_ray}, dtype "
        f"{cfg_t.tpu.compute_dtype}, decode_bwd {cfg_t.tpu.decode_bwd}, "
        f"{cfg_t.training.optimizer_name} lr {cfg_t.training.lr}")
    recorded, launches_t, step_ms = train_path(cfg_t, model, dev, profile)
    train_rows = train_kernel_phase(recorded)
    train_rows["segment_max0"] = segment_train_phase(
        recorded["segment_max0"], dev)
    for name, n in launches_t.items():
        add_launches(train_rows[name], n, TRAIN_STEPS, "step")
    rows["segment_max0"]["train"] = train_rows.pop("segment_max0")
    train_rows["ray_decode_bwd"]["step_ms"] = statistics.median(step_ms)
    rows.update(train_rows)
    del recorded, model
    torch.cuda.empty_cache()
    train_cross_check(dev)

    # -- the global and dense decode modes (K6) ------------------------------
    rows["pair_decode"] = pair_modes_phase(dev, overrides, frame_hw, profile)
    # -- stage-1 training with decode_bwd: kernel ------------------------------
    rows["ray_decode"]["train"], rows["ray_decode_bwd_recompute"] = \
        train_kernel_variant_phase(dev, train_overrides, profile)
    # -- stage-1 training with decode_bwd: kernel_save_all and xla -----------
    rows.update(train_save_all_phase(dev, train_overrides, profile))
    rows["ray_decode"]["train_xla"] = train_xla_phase(dev, train_overrides,
                                                      profile)
    # -- stage-2 training, its eval step, checkpoints ------------------------
    refine_rows = refine_phases(dev, profile)
    rows["ief_decode"]["refine_train"] = refine_rows["ief_decode"]
    rows["segment_max0"]["refine_train"] = refine_rows["segment_max0"]
    log(f"step medians in this run: decode_bwd kernel_save "
        f"{rows['ray_decode_bwd']['step_ms']} ms, kernel "
        f"{rows['ray_decode_bwd_recompute']['step_ms']} ms, kernel_save_all "
        f"{rows['ray_decode_bwd_all']['step_ms']} ms, xla "
        f"{rows['ray_decode']['train_xla']['step_ms']} ms; stage 2 "
        f"{refine_rows['ief_decode']['step_ms']} ms, hard_neg "
        f"{refine_rows['ief_decode']['hard_neg']['step_ms']} ms")

    # -- the trainer, data pipeline and CLI -------------------------------------
    trainer_rows, trainer_times = trainer_phases(dev, profile)
    for name, row in trainer_rows.items():
        rows[name]["trainer"] = row
    log(f"trainer against the bare steps in this run: stage 1 batch 4 "
        f"{trainer_times['batch4_step_ms']:.1f} ms a step (phase 6 "
        f"{rows['ray_decode_bwd']['step_ms']:.1f}), stage 2 "
        f"{trainer_times['stage2_step_ms']:.1f} ms (phase 13 "
        f"{refine_rows['ief_decode']['step_ms']:.1f}); batch 32 "
        f"{trainer_times['batch32_step_ms']:.1f} ms a step, device time "
        f"{trainer_times['batch32_step_device_ms']}, peak "
        f"{trainer_times['batch32_peak_gib']:.2f} GiB; loader "
        f"{trainer_times['loader']}")

    # -- the decoders' other widths, the small-width configs (26-29) -------
    for g in WIDTH_MODELS:
        for name, row in width_phase(dev, g).items():
            rows[name].setdefault("at_widths", {})[decoder_label(g)] = {
                k: row[k] for k in WIDTH_KEYS if k in row}
    for name in rows:
        if name not in ("segment_max0", "segment_sum_"):  # the decoders
            rows[name]["decoder"] = decoder_label(64)
    for run_name, rec in config_phases(dev).items():
        for name, n in rec["launches"].items():
            if name in rows:
                rows[name].setdefault("config_runs", {})[run_name] = n

    # -- the mesh's rays axis (phases 30-32) --------------------------------
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        rays = {"one_card": rays_phases(dev, pathlib.Path(d) / "rays")}
        grids = {"one_card": grid_phase(dev)}
        if torch.cuda.device_count() >= RAYS_WORLD:
            rays["two_cards_nccl"] = rays_phases(
                dev, pathlib.Path(d) / "rays_nccl", device=None,
                backend="nccl")
            grids["two_cards"] = grid_phase(dev, [[torch.device("cuda", i)
                                                   for i in range(2)]])
        else:
            log(f"rays_2card: not run ({torch.cuda.device_count()} card)")
    for name in rows:
        rows[name]["rays"] = {
            **{f"{where} {ph}": v for where, r in rays.items()
               for ph, v in r.get(name, {}).items()},
            **{f"grid {where}": g[0].get(name, {})
               for where, g in grids.items()}}
    log(f"rays grid frame_ms: "
        f"{ {where: g[1] for where, g in grids.items()} }")

    # -- the disk datasets, the paper's configs from files (phases 33-35) ---
    t_disk = time.perf_counter()
    disk, disk_rows = disk_phases(dev)
    disk_s = time.perf_counter() - t_disk
    for name, row in disk_rows.items():
        if name in rows:
            rows[name]["disk"] = row
    log(f"disk: {json.dumps(disk)}")

    # -- the reference's checkpoints, the other decoders, remat, L-BFGS ------
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        for name, row in reference_phase(dev, pathlib.Path(d)).items():
            rows[name]["reference_ckpt"] = row
        t36 = time.perf_counter() - t0
        options = options_phase(dev)
        t37 = time.perf_counter() - t0 - t36
        remat, remat_launches = remat_lbfgs_phase(dev, pathlib.Path(d))
        t38 = time.perf_counter() - t0 - t36 - t37
    # -- the per-ray pair budgets other than 8 (phase 39) --------------------
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        budgets, budget_cli = budget_phase(dev, pathlib.Path(d))
        t39 = time.perf_counter() - t0
    for name, by_kb in budgets.items():
        rows[name]["at_budgets"] = by_kb
    for name, n in budget_cli.items():
        if name in rows:
            rows[name].setdefault("at_budgets", {})[
                f"kb{BUDGET_CLI} cli"] = n
    log(f"phase 39 seconds {round(t39, 1)}")
    # -- the global and dense modes' stage-1 training (phase 40) -------------
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        rows["pair_decode"]["train"], sums = pair_train_phase(
            dev, pathlib.Path(d))
        t40 = time.perf_counter() - t0
    log(f"phase 40 seconds {round(t40, 1)}")
    # -- the reference's model options at their widths (phase 41) -----------
    t0 = time.perf_counter()
    for name, by_w in model_width_phase(dev).items():
        rows[name]["at_model_widths"] = by_w
    t41 = time.perf_counter() - t0
    log(f"phase 41 seconds {round(t41, 1)}")
    # -- every width option at its extreme at once, bf16 and f32 (phase 42)
    t0 = time.perf_counter()
    for name, by_w in model_width_phase(dev, WIDEST_WIDTHS, WIDEST_REPEAT,
                                        ("global", "dense"),
                                        WIDEST_CHECKS).items():
        rows[name].setdefault("at_model_widths", {}).update(by_w)
    t42 = time.perf_counter() - t0
    log(f"phase 42 seconds {round(t42, 1)}")
    # -- the profiling module on the card (phase 43) -------------------------
    t0 = time.perf_counter()
    profiled, prof43 = profiling_phase(dev)
    for name, by in profiled.items():
        rows[name]["profiled"] = by
    t43 = time.perf_counter() - t0
    log(f"phase 43: {json.dumps(prof43)}")
    log(f"phase 43 seconds {round(t43, 1)}")
    # -- the recompute backward's segment sum (phase 44) ---------------------
    t0 = time.perf_counter()
    rows["segment_sum_"].update(segment_sum_phase(dev, sums.pop("recorded")),
                                **sums)
    del sums
    t44 = time.perf_counter() - t0
    log(f"phase 44 seconds {round(t44, 1)}")
    rows["segment_max0"]["options"] = {k: v["launches_k5"]
                                       for k, v in options.items()}
    for name, n in remat_launches.items():
        if name in rows:
            rows[name]["remat_lbfgs"] = n
    log(f"options against the IEF decode in this run: stage 1 step_ms "
        f"{ {k: round(v['stage1_step_ms'], 1) for k, v in options.items()} } "
        f"(IEF: phase 6 {rows['ray_decode_bwd']['step_ms']:.1f}, the "
        f"trainer's batch 4 {trainer_times['batch4_step_ms']:.1f}); stage 2 "
        f"{ {k: round(v['stage2_step_ms'], 1) for k, v in options.items()} } "
        f"(IEF: phase 13 {refine_rows['ief_decode']['step_ms']:.1f}); "
        f"per_ray frame_ms "
        f"{ {k: round(v['per_ray_frame_ms'], 1) for k, v in options.items()} }")
    log(f"phases 36-38 seconds {round(t36, 1)} / {round(t37, 1)} / "
        f"{round(t38, 1)}")

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1],
                **{k: row[k] for k in ENTRY_KEYS if k in row}}
               for name, row in sorted(rows.items())]
    uncounted = [e["name"] for e in kernels if "launches" not in e]
    if uncounted:
        raise AssertionError(f"kernels with no main-path launches: {uncounted}")
    log(f"smoke_s {time.perf_counter() - t_start:.1f} (phases 2-44; "
        f"33-35: {disk_s:.1f}; 36-38: {t36 + t37 + t38:.1f}; 39: "
        f"{t39:.1f}; 40: {t40:.1f}; 41: {t41:.1f}; 42: {t42:.1f}; 43: "
        f"{t43:.1f}; 44: {t44:.1f})")
    log(json.dumps({"kernels": kernels}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="print torch.profiler tables of one served frame "
                    "and of one train step in each decode_bwd mode and of "
                    "one stage-2 step")
    args = ap.parse_args()

    # -- 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    if not (ROOT / "implicit_depth_torch").is_dir():
        print(f"chip_smoke: the port (implicit_depth_torch/) is not beside "
              f"the script in {ROOT}", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log("torch", torch.__version__, "cuda", torch.version.cuda)
    # f32 results are compared: no TF32 in convolutions or products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run(torch.device("cuda"), profile=args.profile)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
