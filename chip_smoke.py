#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the final line is printed only when
every phase passed; each prints its seconds):

1. identity: the card's name and power limit (nvidia-smi), torch's CUDA
   version, the nvcc path;
2. build: compile the CUDA kernels from ``sphfluidsimulation_torch/csrc``
   (the probe group of ``csrc/probes`` included), one nvcc per source,
   side by side;
3. compare: each kernel against its plain PyTorch version on the same
   inputs at frame 0 (which still holds out-of-cube spawns): K1 density and
   K2 fused substep at both sizes of the faithful path (262,144 particles,
   R = 47, and 1,048,576 particles, R = 75); K1, K2 with the extension sums,
   K3 forces, and K3 + ``integrate_substep`` at BASELINE config 3 (524,288
   requested = 524,176 active particles, R = 47, preset 2, XSPH 0.3,
   artificial viscosity 0.5); the compact-lane kernel K5: density at both
   sizes, the fused substep at 262k (at 1M it is held at frame 10: its
   plain version takes 13 s a call), forces at 262k, density and the fused
   substep with extensions at config 3, the substep and forces on rows two
   substeps into the frame, where rows drift, with the drift count equal to
   the plain version's; every kernel with the frame's voxel capacity; the
   scene-axis instances (one launch over all scenes of a batch) at
   BASELINE config 5 (8 scenes of 524,288 requested particles, rest
   density 1.0-2.0): K1-scenes, given the density record as the stepper
   builds it and bit-equal to its reference walk (occ, raw and pos), and
   K2-scenes on the rows two substeps into the frame, each scene held to
   its plain version and bit-equal to its solo launch, and K2-ext-scenes
   likewise on 2 scenes of config 3's
   physics, whose artificial viscosity zeroed is a planted control that
   must fail; K3-scenes (config 5) and K3-ext-scenes (the config-3 batch)
   on the rows two substeps into the frame, and the K5-scenes instances,
   density on the frame and the substep (with extensions on the config-3
   batch) and forces on the rows two substeps in, each scene bit-equal to
   its solo launch (K5's drift count too, and equal to its plain
   version's), the two ends of the sweep held to their plain versions
   (K5, whose plain version takes seconds a scene: scene 0),
   with planted controls (K3-scenes and K5-scenes with viscosity 0,
   K3-ext-scenes folded with XSPH 0);
4. main paths, each after an untimed first call of its rollout (which
   builds the kernels and records the graph), with the launch counters
   reset just before and read just after it; the sorted tier's rollouts
   run as a replayed CUDA graph, the default on the card
   (``sim/graph.py``): the faithful 10-frame ``make_rollout`` at both
   sizes (1 + 5 launches a frame, no extension
   instance), then config 3 faithful (K1 + 5 K2-ext a frame) and config 3
   corrected (6 K1 + 5 K3 a frame); then the compact route
   (``tune=SortedTuning(compact=True)``): faithful at both sizes (1 K5
   density + 5 K5 substeps a frame), config 3 faithful (1 + 5 K5-ext) and
   262k corrected (6 K5 density + 5 K5 forces); config 5 through
   ``parallel.BatchedScenes`` (its default on the card, a replayed graph a
   frame: 1 K1-scenes, 1 frame record + 5 K2-scenes), its finite
   positions in [0, 1] and
   its non-finite rows counted (phase 12 replays their first frames
   through the plain versions); positions must be in
   [0, 1], and finite with ``exact_cert`` 0 on the K1-K3 route (on K5's
   the certificate is the drift count, printed beside the rate, and where
   it is not 0 a drifted row may end non-finite, as its plain version
   does; the count is printed); then the compares again on the
   frame-10 states (config 5's frame 11 for the scene axis), with planted
   controls that must fail their rule: K2 with viscosity zeroed, K2-ext
   with the artificial viscosity zeroed, K3 with XSPH zeroed, K5 with
   viscosity zeroed, K2-scenes with viscosity zeroed;
5. reference: the 1,024-particle golden dam-break (tests/data) on the card,
   frame-1 max error < 1e-5 and frame-5 RMSE < 1e-3; and a 1,024-particle
   calm scene with XSPH 0.3 and artificial viscosity 0.4, whose sorted tier
   tracks the port's own brute oracle within 1e-5 over 3 frames in both
   modes (the machine with the card has no JAX);
6. the CLI in-process: ``run`` at config 3 for 3 frames, faithful and
   ``--corrected``, through the kernels, and faithful with
   ``SPH_PALLAS_COMPACT=1`` through K5 (phase 9 lists the variants');
7. timing: each kernel's launch (its scalar block and the force modes' pj
   built beforehand) and its plain version (not at 1M, no kernel's main
   shape), with CUDA events, the card kept
   busy while the host queues the launches, so the times are device times,
   at the shapes of its path, K5 beside K1/K2/K3 at the same states (the
   fused substeps on rows two substeps into the frame, the rest at the
   frame start); each kernel's bound, the larger of its bytes over the
   card's memory rate and its FP32 operations, counted from the member
   pairs of this run's inputs, over the FP32 rate; and K5's stream, the
   slots a tile that it reads (each union cell cut at the capacity), beside
   the length of the uncut union; the scene-axis instances at phase 3's
   batches (config 5 at frame 11, the config-3 batch at frame 0): K1,
   K2, K3 and K5 (density, substep, forces; with extensions K2-ext, K3-ext
   and K5-ext on the config-3 batch; the forces on the frame-start rows,
   the substeps on the rows two substeps in), their plain versions scene
   by scene, and K1's density record build, and beside them the solo
   kernels on the same inputs, one launch a scene (the reference walks'
   times, the tile clocks and the row-loop counts are the
   ``scripts/torch_*_ab.py`` tools'); every K5 substep instance and
   K5-band density also timed walking each tile whole on one warp
   (``split=0``, the body before wide tiles were split: the "_whole"
   shapes), given the frame's ``occ_prefix`` as the stepper and the slab
   step give it once a frame (its own time printed beside); and the K5
   substep at the 262k spawn (frame-start rows, where no tile may pass the
   split threshold) beside its whole-tile body (the "262k_f0" shape); K5
   forces in the walk it chooses by rows a cell (``compact.own_lists``)
   beside the other, which gives the same bits (held so in phases 3, 4b
   and 9): solo at 262k, each lane walking its own slots of a round,
   beside every lane stepping through the round's list ("_list"), and
   over config 5's scenes the other way round ("_own");
8. the slab step (``parallel.make_pallas_slab_step``) on ``LocalRing(4)``,
   four z-slabs on the one card: the banded K1 and K2 (K2-ext at config 3)
   held against their banded plain versions on each shard's frame
   (``slab_pallas.shard_frames``) at frame 0 and after 3 slab frames, at
   262k and config 3, with K2-band with viscosity 0 as the planted control;
   on the same frames the launched K2-band and K2-ext-band (a group of
   lanes a live row, ``csrc/window_walk.cuh``) bit-equal to the one-thread
   walk (``lanes=1``) in every variant library (default, facc0, kahan,
   bf16); the slab path at 262k and at config 3, 3 frames each, with
   exactly 4 K1 and 20 K2 launches a frame; frame 1 at 262k equal to the single-device
   window route bit for bit wherever ``exact_cert`` is 0, and the overflow
   equal to its; the calm 1k scene on 2 and 4 slabs for 3 frames, with
   ``exact_cert`` 0 and within 2e-5 of the single-device route; the
   recorded slab frame (``slab_pallas.GraphSlabStep``, one replay a call,
   the default on the card) against the host loop (``host_loop=True``) at
   262k and config 3 on the window route and at 262k on the compact route:
   3 frames from the same slab state after a first call of each, run host,
   graph, graph, host, with exactly 4 K1-band + 20 K2-band launches a
   frame (K2-ext-band at config 3, K5-band density and substep on the
   compact route) in every run, the states and every metric lane of each
   frame bit-equal, each mode's rate, host ms and device ms a frame (the
   profiler's kernels, copies and memsets) and idle share; the slab
   step's rate at 262k and 1M in both modes (H G G H, 3 frames after one)
   beside the single-device graph rollout's; and the banded kernels'
   times (one launch on each shard), plain versions and bounds, K2's
   beside the one-thread walk's on the same inputs. The slab runs use the
   row slack of the JAX tests (4.0), since
   the golden and config-3 spawns are not spread evenly over z, and a halo
   slack of 8.0;
9. the tuning variants (``SortedTuning``, the JAX ``PallasTuning``'s
   semantic knobs; their libraries are built in phase 2 beside the
   default ones, each build's seconds printed): each new instance held to
   the plain version of its own variant at frame 0 and on the frame-10
   states, at 262k and config 3 (K2/K3 with ``fuse_acc`` off, the
   ``kahan`` K1, K2 and K3, the ``bf16`` K2, K2-ext, K3 and K5 force
   modes), with the Kahan K2-ext's and K3's max |k - p64| printed beside
   the default kernels' on the config-3 state, and two planted controls
   that must fail: the bf16 K2-ext held to the f32 plain version and the
   fuse_acc K2-ext with viscosity 0; then, each with the counters reset
   before it, every variant's path selected through its ``SPH_PALLAS_*``
   variable, 3 frames each (among them the unfused route, 1 K1 + 5 K3 a
   frame and no K2, at 262k and config 3, and the corrected Kahan and
   facc0 routes at config 3, 6 K1 + 5 frame records + 5 K3-ext a frame);
   the compact-route slab step on ``LocalRing(4)`` at 262k and config 3
   for 3 frames (4 K5-band density and 20 K5-band substep launches a
   frame), its kernels held to their
   banded plain versions on each shard's frame, and the calm 1k scene on
   2 and 4 slabs (``exact_cert`` 0, within 2e-5 of the single-device
   compact route); the CLI at config 3 with ``SPH_PALLAS_FUSED=0``, with
   ``SPH_PALLAS_KAHAN=1`` (the Kahan K2-ext, which walks the frame
   record the stepper builds once a frame) and ``--corrected`` with
   ``SPH_PALLAS_BF16=1`` (a candidates' pass before each bf16 K3-ext);
   and each new instance's time, plain time and bound, as in phase 7; the
   variants' scene-axis instances on 2
   scenes of 262k: each variant's batch (``kahan``, ``bf16``,
   ``fuse_acc=False``, ``bf16`` on the compact route) through
   ``BatchedScenes`` for 3 frames with its exact launches, then each
   instance on the spawn's frame bit-equal to its solo launch scene by
   scene, scene 0 held to its variant's plain version, and timed; the
   bf16 K2-ext, which reads its candidates rounded once a substep by
   ``bf16_candidates`` (held bit-equal to its plain version), and the
   bf16 K3-ext, which reads the same copy, each bit-equal to the walk that
   rounds in its registers, its reference, and timed with its pass, beside
   the pass alone (on copies of the rows cycled past the card's L2) and
   the default K2-ext and K3-ext on the same inputs; the frame record
   (``sph_kernels.frame_record``), built by its pass ``sph_frame_record``
   and held bit-equal to its plain version, and its seven one-scene
   record walks, the Kahan and the facc0 K2-ext and K3-ext at config 3 and
   the bf16, the Kahan and the facc0 K2 without extensions at 262k, each
   bit-equal to the walk that reads occ, raw and pj, as launched and given
   the record, and timed given it; the pass timed on copies of its inputs
   cycled past the L2 (at config 3 here, over config 5's scenes in phase
   7); the paths count its launches (one a frame, five a corrected frame:
   the Kahan and the facc0 corrected config-3 paths); at frame 10 two
   planted controls that must leave the reference's bits: a copy whose vz
   is truncated, not rounded, and a record whose occ lane is cleared on
   one occupied row (for each record walk);
10. the paths of the JAX package's default backend and its export path,
   each with the launch counters reset before it: the exact tiers
   (``neighbor="slotted"`` and ``"gather"``, plain PyTorch, which launch no
   hand-written kernel) on the calm 1k scene, faithful and corrected, 3
   frames, within 1e-5 of the port's brute oracle, and slotted with XSPH
   0.3 and artificial viscosity 0.4 likewise; at 262k, 3 frames each of
   slotted and gather, their frame-1 overflow equal to the voxel table's
   (``grid.build_bucket``; the sorted tier's, which ranks within anchor
   runs, is printed beside: the two differ where spawns alias, as in JAX),
   each tier's rate beside the sorted tier's; at config 3, 3 frames of
   slotted with the extensions, positions in [0, 1]; the calm pin
   (tests/data/calm1024_pin_r2.npz) after 100 frames on the sorted and the
   slotted tier, RMSE and max error printed and held to the CPU tests'
   tolerance, ``exact_cert`` 0; ``make_dt_rollout`` on the sorted tier at
   262k over 5 frames of a varying schedule, bit-equal to stepping frame by
   frame, with exactly 1 K1 and 5 K2 launches a frame; ``snapshot_every=5``
   on a 10-frame sorted rollout at 262k: 2 snapshots, the last the final
   positions, the final state bit-equal to the rollout without snapshots,
   the same launches; and the render layer: ``mesh_properties`` of a 262k
   state on the card equal to the same call on the CPU within 1e-6, a PNG
   and a viewer HTML written from it, the seconds of each printed;
11. the probes (``sphfluidsimulation_torch/probes``, the Hopper
   micro-benchmarks of the JAX package's Mosaic probes; their libraries
   are built in phase 2 beside the rest), each run through its entry point
   with the probe launch counters reset before it and read after: live
   (and ``live.probe_device`` in a child process), the ten intops stages
   against the scripts' numpy truth, loopstruct A-E on the script's
   synthetic walk (262,144 rows x 1,408 candidates; also with the gate
   open) and A_f, B_f, D_f (with its range pre-pass) and E_f on the 262k
   frame-10 state of phase 4 under K3's rule (the walk share B_f / A_f
   printed), the twelve mxu instances (D, G, A, M, D128, A128, M128 at 1x
   and 3x TF32) under ``mxu.mxu_rule`` with the script's divergence table
   and ``torch.bmm``'s time, v7prims against np.roll and scalar S0-S3
   within an ulp, every kernel timed beside its plain version and bound;
   the compact probe's one-step check at 16,384 particles, which must bear
   out its explanation (``compact.checks``); and planted controls that
   must fail: intops stage 3 with a shift of 9, loopstruct A with a line
   dropped, and mxu's (``mxu.CONTROLS``: at 1x TF32 G, A, M, A128 and M128
   with the first chunk dropped and with the velocity accumulate negated,
   A at 1x and 3x with the ones column zeroed).
12. the modules the JAX package runs besides the kernels' paths,
   each with the launch counters reset before it and read after it:
   BASELINE config 5 through the CLI's ``sweep`` (8 scenes of 524,288
   requested particles, rest density 1.0-2.0, 3 frames, the sorted tier,
   a PNG a scene): exactly 1 K1-scenes, 1 frame record and 5 K2-scenes
   launches a frame,
   8 PNGs; the same sweep through ``parallel.BatchedScenes`` in both
   modes, the host loop (``host_loop=True``) and the graph (the default),
   each after a first frame, run host, graph, graph, host over 3 frames
   each, with exactly 1 + 5 launches a frame in every run and the states
   and metrics of the two modes bit-equal at frames 4, 7 and 10; each
   mode's aggregate particle-substeps/s and host ms a frame printed, and
   over frames 8-10 its host ms a frame beside the device ms a frame of a
   second batch that runs the same frames under the profiler (bit-equal
   to the first), and so the idle share; every scene at
   frame 4 bit-equal to its solo ``make_rollout``; scenes 0 and 7 (the
   ends of the rest-density sweep) and each scene in which a position went
   non-finite, stepped alone on their rows of the batch's ``PhysParams``
   and bit-equal to the batch, with the last frame of scenes 0 and 7 and
   each frame in which a position goes non-finite replayed with K1 and
   each K2 launch held to its plain version (phase 3's rules); a
   position may end non-finite with ``exact_cert`` 0 only where the plain
   substep on the same inputs gives it too; a batch of 2 scenes of
   config 3's physics (1 K1-scenes + 5 K2-ext-scenes a frame, each scene
   bit-equal to its solo rollout after 2 frames); the sweep's other
   routes on the scene axis: ``sweep --corrected`` (6 K1-scenes + 5
   K3-scenes a frame) and the ``SPH_PALLAS_COMPACT=1`` sweep (1 + 5
   K5-scenes) through the CLI for 3 frames and through ``BatchedScenes``
   in both modes as above (H G G H, the exact launches, the modes
   bit-equal, each mode's rate, host and device ms a frame and idle
   share), scenes 0 and 7 bit-equal to their solo rollouts, positions in
   the cube (a non-finite one at ``exact_cert`` 0 replayed through the
   plain versions, as for the faithful batch); and one frame each of
   config 5 compact corrected (6 + 5 K5-scenes) and of the config-3
   batch corrected (K3-ext-scenes) and compact (K5-ext-scenes), its last
   scene bit-equal to its solo rollout; config 5 on the slotted
   tier (the JAX CLI's default) for 1 frame, no kernel launch; the sites
   tier (``neighbor="sites"``, plain torch, no kernel launch) at 262k
   golden for 3 frames (frame 1 takes the spawn escalation) with positions
   in [0, 1] and the certificate printed, at 1M (R = 75) for 1 frame
   with the band count of ``sites.bands_for`` and again with the other
   count (one piece, or the 5 z-bands of JAX's rule), bit-equal, each
   timed with its peak memory, and on the calm 1k scene within 1e-5
   of the brute oracle in both modes (with and without the extensions);
   the sites slab step on ``LocalRing(4)`` at 262k for 3 frames and
   through ``run --shards 4`` for 1 frame, and the calm 1k scene on 2 and 4 slabs
   within 2e-6 (positions) and 2e-4 (velocities) of the single-device
   sites step; the row-sharded domain step on ``LocalRing(4)`` at 262k
   for 1 frame against the single-device gather step; and ``entry()`` run
   once (1 K1 + 5 K2). Each prints its seconds and rate.
13. the graph against the host loop: at 262k golden, 1M, config 3
   faithful and corrected and on the compact route at 262k, the graph
   rollout (``host_loop=False``) and the host loop (``host_loop=True``),
   10 frames from the same spawn state, run host, graph, graph, host with
   the counters reset before each run and read after it (exactly the
   path's launches in both modes), the outputs and every metric lane
   bit-equal; each mode's rate, host ms a frame, device ms a frame (the
   profiler's kernel, copy and memset time) and device idle share;
   ``snapshot_every=5`` and ``make_dt_rollout`` at 262k bit-equal in both
   modes with the same launches; and ``Scene.step`` at 262k, one frame a
   call for 10 frames from the spawn, ``jit=True`` (the recorded frame,
   the default) against ``jit=False`` (the eager step), H G G H, exactly
   1 K1 + 5 K2 a frame in every run, the final state and metrics
   bit-equal, each mode's rate, host and device ms a frame and idle
   share.

The last three lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import sys
import time

FRAMES = 10
# Tolerances of each kernel against its plain version on the same inputs.
# The kernels sum in walk order with FMA contraction, the plain versions in
# a fixed tree order, so the two differ by rounding.
# density: |k − p| ≤ 1e-5·|p| + 1e-6·max|p|, elementwise.
DENSITY_RTOL = 1e-5
# substep (K2, K2-ext) and forces (K3, folded): particle by particle,
# |k − p64| ≤ 4·|p32 − p64| + 256·u·σ against the plain version in float64
# (p64) and in float32 (p32), with σ the lane's own rounding scale; the NaN
# pattern (and for the substep the ρ and NaN-count lanes) equal to p32's
# (sph_kernels.substep_accuracy / forces_accuracy state the rule and why).
# the sorted tier against the port's brute oracle on the calm 1k scene
ORACLE_ATOL = 1e-5
# the card spins this many cycles (about 25 ms) before each timed block,
# while the host queues it, so that kernel times are device times
LEAD_CYCLES = 50_000_000
XSPH, ALPHA = 0.3, 0.5          # BASELINE config 3 (README.md)
# the slab step: shards on one card and frames a path; the row slack of the
# JAX tests (the golden and config-3 spawns are not spread evenly over z),
# and twice the default halo slack (the halo is sized from the mean
# occupancy, and the golden spawn's column is denser: at 4.0 slab 3 of 262k
# drops 20,711 boundary rows at frame 0)
SLAB_D, SLAB_FRAMES, SLAB_SLACK, SLAB_HALO = 4, 3, 4.0, 8.0

# the slab step on the compact route and the variants' paths: frames a path
VARIANT_FRAMES = 3
# phase 10: the calm pin's tolerance, (RMSE, max) at frame 100, that of
# tests/test_torch_calm_pin.py (JAX's own CPU rollout is off the TPU-written
# pin by 4.47e-6 / 6.19e-5 there); the dt replay's schedule (frame deltas)
PIN_RMSE, PIN_MAX = 1e-5, 1e-4
DT_SCHEDULE = (1 / 240, 1 / 120, 1 / 360, 1 / 180, 1 / 480)

# phase 12: BASELINE config 5 (README.md: sweep --particles 524288 --scenes
# 8 --export-dir) and the frames of each path; the sites slab step's row
# slack (the golden spawn is not spread evenly over z, as in phase 8) and
# the tolerances of tests/test_slab.py:164-167
C5_PARTICLES, C5_SCENES, C5_FRAMES = 524288, 8, 3
SITES_FRAMES = 3
SITES_SLAB_POS, SITES_SLAB_VEL = 2e-6, 2e-4

# The bound of a kernel: the larger of its bytes over the memory rate and
# its FP32 operations over the FP32 rate outside the tensor cores (NVIDIA
# H100 SXM, dense, from NVIDIA's H100 datasheet).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per member pair: the fewest that the pair terms of
# sph_kernels.forces_plain need. A multiply-add counts 2, a square root or
# a division 1 (they cost more: this is a lower bound). p_j and 1/ρ_j are
# inputs (pj, one value a particle, built by pj_cols before the launch); a
# constant factor of a whole sum (c_poly6, c_grad, ½, 2, h, c_s) is
# applied once a row, and a reciprocal two terms share is taken once.
# - density 12: 3 differences, |r|² 5, h² − |r|² 1, d² 1, sum += d²·d 2;
# - force pair 32: 3 differences, |r|² 5, √ 1, e = h − |r| 1, ∇W e³/|r| 3,
#   pressure coefficient (p_i + p_j)/ρ_j 2 and its product with ∇W 1, the
#   pressure sum 6, the viscosity coefficient e/ρ_j 1, v_j − v_i 3, the
#   viscosity sum 6;
# - the extension terms 27 more: h² − |r|² 1, its cube 2, ρ_i + ρ_j 1 and
#   its reciprocal 1 (2/(ρ_i + ρ_j) = 1/ρ̄), the XSPH coefficient 1 and sum
#   6, v·r 5, μ 2 (|r|² + 0.01 h² and a division), Π∇W 2, the Monaghan sum
#   6.
# The kernels' add_pair_pj does more (the constants, 1/|r| by rsqrt).
OPS_PER_PAIR = {"density": 12, "forces": 32, "fused": 32}
OPS_PER_PAIR_EXT = 27
# the variants (a kernel's name + its tags): kahan's compensation costs 3
# more operations per accumulator and member pair (y = term - c, and
# c = (t - s) - y, beside the sum's own add): one accumulator in density,
# three in the fused-accumulator force pair, six more for the extension
# sums; bf16 with rho_j from the candidate computes press_j and 1/rho_j per
# pair (3) on the window route (K5 once a streamed slot: not counted);
# fuse_acc off sums the same terms in two triples (the same count)
KAHAN_ACCUMULATORS = {"density": 1, "forces": 3, "fused": 3}
KAHAN_ACCUMULATORS_EXT = 6
BF16_RHO_OPS = 3
# per-row operations outside the pair loop: ρ·m; the fused tail 50 (+15
# for the extension fold), into whose scales the constants fold; the
# forces write the raw sums, so they apply the constants to them (6, +6
# with the extension sums), and their fold is a separate torch pass
OPS_PER_ROW = {"density": 1, "forces": 6, "fused": 50}
OPS_PER_ROW_EXT = {"density": 0, "forces": 6, "fused": 15}
# bytes per row read and written once: density reads pos f32[3], raw i32,
# occ u8 and writes ρ f32; the force modes read the rows f32[8] and write
# rows f32[8] (fused) or sums f32[12] (forces); the force modes of K2, K3
# and K5 also read pj f32[2], and K5 reads cid i32
ROW_BYTES = {"density": 12 + 4 + 1 + 4, "fused": 32 + 4 + 1 + 32,
             "forces": 32 + 4 + 1 + 48}
# a dead row of a slab's buffer: K1 writes its ρ 0, K2 copies its row
DEAD_ROW_BYTES = {"density": 4, "fused": 64}
# the bf16 candidates' pass reads the rows f32[8] and writes their
# half-width copy f32[6] a row; its FP32 operation a row is the reciprocal
# (the roundings are integer operations)
CAND_ROW_BYTES, CAND_ROW_OPS = 32 + 24, 1
# the frame record's pass reads ρ f32, raw i32 and occ u8 and writes the
# record f32[4] a row; its FP32 operations a row: ρ − ρ₀, k·(…) and the
# reciprocal
RECORD_ROW_BYTES, RECORD_ROW_OPS = 4 + 4 + 1 + 16, 3
# every kernel of the port: (kind, source, the TPU kernel it replaces)
KERNELS = {
    "density": ("density", "density.cu", "pallas_sph.py:961"),
    "fused_substep": ("fused", "fused_substep.cu", "pallas_sph.py:961"),
    "fused_substep_ext": ("fused", "fused_substep.cu", "pallas_sph.py:961"),
    "forces": ("forces", "forces.cu", "pallas_sph.py:961"),
    "compact_density": ("density", "compact.cu", "pallas_compact.py:237"),
    "compact_substep": ("fused", "compact.cu", "pallas_compact.py:237"),
    "compact_substep_ext": ("fused", "compact.cu", "pallas_compact.py:237"),
    "compact_forces": ("forces", "compact.cu", "pallas_compact.py:237"),
    "density_band": ("density", "density.cu", "pallas_sph.py:961"),
    "fused_substep_band": ("fused", "fused_substep.cu", "pallas_sph.py:961"),
    "fused_substep_ext_band": ("fused", "fused_substep.cu",
                               "pallas_sph.py:961"),
    "compact_density_band": ("density", "compact.cu",
                             "pallas_compact.py:237"),
    "compact_substep_band": ("fused", "compact.cu", "pallas_compact.py:237"),
    "compact_substep_ext_band": ("fused", "compact.cu",
                                 "pallas_compact.py:237"),
    "density_scenes": ("density", "density.cu", "pallas_sph.py:961"),
    "fused_substep_scenes": ("fused", "fused_substep.cu",
                             "pallas_sph.py:961"),
    "fused_substep_ext_scenes": ("fused", "fused_substep.cu",
                                 "pallas_sph.py:961"),
    "forces_scenes": ("forces", "forces.cu", "pallas_sph.py:961"),
    "forces_ext_scenes": ("forces", "forces.cu", "pallas_sph.py:961"),
    "compact_density_scenes": ("density", "compact.cu",
                               "pallas_compact.py:237"),
    "compact_substep_scenes": ("fused", "compact.cu",
                               "pallas_compact.py:237"),
    "compact_substep_ext_scenes": ("fused", "compact.cu",
                                   "pallas_compact.py:237"),
    "compact_forces_scenes": ("forces", "compact.cu",
                              "pallas_compact.py:237"),
    # the bf16 K2-ext's candidates, rounded once a substep (a pass of the
    # bf16 library beside its walk)
    "bf16_candidates": ("candidates", "fused_substep.cu",
                        "pallas_sph.py:961"),
    # the frame record of K2's and K3's record walks (every library's pass,
    # once a frame, once a corrected substep)
    "frame_record": ("record", "fused_substep.cu", "pallas_sph.py:961"),
}
# the variants' instances: the kernel's entry with the variant's tag
# (sph_kernels.variant_tag)
KERNELS.update({f"{name}+{tag}": KERNELS[name] for name, tags in (
    ("density", ("kahan",)),
    ("fused_substep", ("facc0", "kahan", "bf16")),
    ("fused_substep_ext", ("facc0", "kahan", "bf16")),
    ("forces", ("facc0", "kahan", "bf16")),
    ("compact_substep", ("bf16",)), ("compact_substep_ext", ("bf16",)),
    ("compact_forces", ("bf16",)), ("density_scenes", ("kahan",)),
    ("fused_substep_scenes", ("facc0", "kahan", "bf16")),
    ("compact_substep_scenes", ("bf16",))) for tag in tags})


def bound(name: str, n: int, r: int, pairs: int, ext: bool,
          s_cells: int | None = None, n_dead: int = 0,
          scenes: int = 1) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take for
    kernel ``name``'s work on n rows at resolution r with ``pairs`` member
    pairs (self pairs excluded for the force modes), with or without the
    extension sums. A banded instance gives its start tables' cells
    ``s_cells`` (default R³) and its dead rows ``n_dead``; a scene-axis
    instance its ``scenes`` (n counts the rows of all of them, each with its
    own start table and scalars). A variant's instance (``name`` with its
    tags) adds its own operations."""
    kind = KERNELS[name][0]
    if kind in ("candidates", "record"):
        row_bytes, row_ops = ((CAND_ROW_BYTES, CAND_ROW_OPS)
                              if kind == "candidates"
                              else (RECORD_ROW_BYTES, RECORD_ROW_OPS))
        t_bytes = n * row_bytes / HBM_BYTES_PER_S
        t_ops = n * row_ops / FP32_OPS_PER_S
        return 1e3 * max(t_bytes, t_ops), \
            "bytes" if t_bytes >= t_ops else "operations"
    tags = name.split("+")[1:]
    k5 = name.startswith("compact")
    rho_j = "bf16" in tags and (ext or k5)        # pj not read
    nbytes = n * (ROW_BYTES[kind] + (4 if k5 else 0)
                  + (8 if kind != "density" and not rho_j else 0))
    nbytes += n_dead * DEAD_ROW_BYTES.get(kind, 0)
    cells = r ** 3 if s_cells is None else s_cells
    nbytes += scenes * (4 * (cells + 1) + 4 * 15)   # start[], the scalars
    per_pair = OPS_PER_PAIR[kind] + (OPS_PER_PAIR_EXT if ext else 0)
    if "kahan" in tags:
        per_pair += 3 * (KAHAN_ACCUMULATORS[kind]
                         + (KAHAN_ACCUMULATORS_EXT if ext else 0))
    if rho_j and not k5:
        per_pair += BF16_RHO_OPS
    ops = pairs * per_pair
    ops += n * (OPS_PER_ROW[kind] + (OPS_PER_ROW_EXT[kind] if ext else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


class Phase:
    """Prints a phase's wall seconds when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s",
                  flush=True)


def phase12(dev, ident: str, read_launches, hold_density, hold_out,
            zero: dict, sizes: dict, out_dir: str,
            c5_particles: int = C5_PARTICLES,
            c5_scenes: int = C5_SCENES) -> None:
    """Phase 12: config 5, the sites tier, the sites slab step, the domain
    step and ``entry()`` (the module docstring, item 12). ``read_launches``
    fails unless the counters since the last reset are its ``want``;
    ``hold_density(k, p, name, label)`` and ``hold_out(name, out, ref,
    label)`` hold a kernel's output to its plain version's (phase 3's
    rules) and fail where it leaves it."""
    import torch

    from sphfluidsimulation_torch import SimConfig, cli, entry
    from sphfluidsimulation_torch.ops import sites
    from sphfluidsimulation_torch.ops import sph_kernels as sk
    from sphfluidsimulation_torch.ops.frame import build_frame
    from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning
    from sphfluidsimulation_torch.params import PhysParams
    from sphfluidsimulation_torch.parallel import (BatchedScenes, LocalRing,
                                                   collect, distribute,
                                                   make_sharded_frame_step,
                                                   make_slab_step)
    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      integrate_substep,
                                                      make_frame_step,
                                                      make_param_step,
                                                      make_rollout)
    from sphfluidsimulation_torch.state import ParticleState
    from sphfluidsimulation_torch.utils.profiling import device_ms

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def same_bits(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and bool(
            (a.view(torch.int32) == b.view(torch.int32)).all())

    def run_cli(label, argv, want):
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        sync()
        dt = time.perf_counter() - t0
        print(f"{label}: exit {rc} in {dt:.4f} s [{ident}]", flush=True)
        if rc != 0:
            fail(f"{label} exits {rc}")
        read_launches(label, want)
        return dt

    def in_cube(pos, label, cert, proven=None):
        """Positions in [0, 1]. As in phases 4 and 8, a row may end
        non-finite only where the run certifies a truncation (``cert`` >
        0), or where ``proven`` marks it: a row that went non-finite in a
        frame replayed through the plain versions (``replay_frame``)."""
        bad = ~torch.isfinite(pos).all(1)
        fin = ~bad
        inside = bool(((pos[fin] >= 0) & (pos[fin] <= 1)).all())
        unproven = int((bad if proven is None else bad & ~proven).sum())
        print(f"{label}: {int(bad.sum())} rows with non-finite positions "
              f"({unproven} not proven by the plain version), the finite in "
              f"[0, 1] {inside}; exact_cert {cert}", flush=True)
        if not inside:
            fail(f"{label}: a finite position outside [0, 1]")
        if unproven and cert == 0:
            fail(f"{label}: {unproven} rows with non-finite positions and "
                 f"exact_cert 0")

    def replay_frame(cfg, state, phys, label):
        """One faithful sorted frame of ``state`` as ``_sorted_step`` runs
        it (build_frame, K1, 5 K2 with the frame's pj and scalar block),
        K1 and each K2 launch held to its plain version on the same inputs
        (K2's rule includes the NaN pattern). Returns the new state and the
        rows (caller order) whose position went non-finite in it; for each
        such row the plain substep on the same inputs must give a
        non-finite position too, and the inputs that made it are
        printed."""
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        frame, (pos_s, vel_s) = build_frame(state.pos, r, cap,
                                            extras=(state.pos, state.vel))
        scal = sk.scal_block(phys)
        rho = sk.density_cuda(frame, pos_s, phys, r, cap, scal)
        hold_density(rho, sk.density_plain(frame, pos_s, phys, r, cap),
                     "density", label)
        rows = sk.pack_rows(pos_s, vel_s, rho)
        pj = sk.pj_cols(rho, phys)
        went = torch.zeros_like(rho, dtype=torch.bool)
        for k in range(cfg.substeps):
            ref = sk.substep_reference(frame, rows, phys, r, cap)
            out = sk.fused_substep_cuda(frame, rows, phys, r, cap, pj=pj,
                                        scal=scal)
            e, line = hold_out("fused_substep", out, ref,
                               f"{label} substep {k + 1}")
            print(f"compare {label} substep {k + 1}: fused_substep "
                  f"max|k-p| {e:.3e}, {line}", flush=True)
            new = (torch.isfinite(rows[:, :3]).all(1)
                   & ~torch.isfinite(out[:, :3]).all(1))
            if bool(new.any()):
                f_p = sk.forces_reference(frame, rows, phys, r, cap).p32
                for i in new.nonzero()[:4, 0].tolist():
                    print(f"{label} substep {k + 1}: row {i} goes "
                          f"non-finite: in pos {rows[i, :3].tolist()} vel "
                          f"{rows[i, 3:6].tolist()} rho {float(rows[i, 6])}"
                          f"; plain fluid force {f_p[i, :3].tolist()}; "
                          f"out vel kernel {out[i, 3:6].tolist()} plain "
                          f"{ref.p32[i, 3:6].tolist()}", flush=True)
                if not bool((~torch.isfinite(ref.p32[new, :3])).any(1)
                            .all()):
                    fail(f"{label} substep {k + 1}: the kernel's position "
                         f"goes non-finite where the plain version's does "
                         f"not")
                went |= new
            rows = out
        pos_s, vel_s, _, nan_hits = sk.unpack_rows(rows)
        order = frame.order.long()

        def unsort(a):
            o = torch.empty_like(a)
            o[order] = a
            return o

        return (ParticleState(pos=unsort(pos_s), vel=unsort(vel_s),
                              nan_count=state.nan_count + unsort(nan_hits)),
                unsort(went))

    def replay_corrected_frame(cfg, state, phys, label):
        """One corrected sorted frame of ``state`` without extensions as
        ``_corrected_step`` runs it (each substep: build_frame, K1, K3 with
        the substep's pj and the frame's scalar block, the fold,
        ``integrate_substep``), K1 and K3 held to their plain versions on
        the same inputs (K3's rule includes the NaN pattern). Returns the
        new state and the rows whose position went non-finite in it; for
        each such row the plain force, integrated alike, must give a
        non-finite position too."""
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        scal = sk.scal_block(phys)
        pos, vel = state.pos, state.vel
        nan_hits = torch.zeros_like(state.nan_count)
        went = torch.zeros_like(nan_hits, dtype=torch.bool)
        for k in range(cfg.substeps):
            lab = f"{label} substep {k + 1}"
            frame, (pos_s, vel_s) = build_frame(pos, r, cap,
                                                extras=(pos, vel))
            rho = sk.density_cuda(frame, pos_s, phys, r, cap, scal)
            hold_density(rho, sk.density_plain(frame, pos_s, phys, r, cap),
                         "density", lab)
            rows = sk.pack_rows(pos_s, vel_s, rho)
            ref = sk.forces_reference(frame, rows, phys, r, cap)
            f, _ = sk.fold_forces(sk.forces_cuda(
                frame, rows, phys, r, cap, False, sk.pj_cols(rho, phys),
                scal), rho, phys)
            e, line = hold_out("forces", f, ref, lab)
            print(f"compare {lab}: forces max|k-p| {e:.3e}, {line}",
                  flush=True)
            pos_n, vel_n, nan = integrate_substep(pos_s, vel_s, f, phys)
            new = (torch.isfinite(pos_s).all(1)
                   & ~torch.isfinite(pos_n).all(1))
            if bool(new.any()):
                pos_p, _, _ = integrate_substep(pos_s, vel_s, ref.p32, phys)
                if not bool((~torch.isfinite(pos_p[new])).any(1).all()):
                    fail(f"{lab}: the kernel's position goes non-finite "
                         f"where the plain version's does not")
            order = frame.order.long()

            def unsort(a):
                o = torch.empty_like(a)
                o[order] = a
                return o

            went |= unsort(new)
            pos, vel = unsort(pos_n), unsort(vel_n)
            nan_hits = nan_hits + unsort(nan.to(torch.int32))
        return (ParticleState(pos=pos, vel=vel,
                              nan_count=state.nan_count + nan_hits), went)

    def prove_scenes(cfg, overrides, params, states, frames, faithful):
        """Each scene of ``states`` (after ``frames`` frames) in which a
        position went non-finite, stepped alone on its row of the batch's
        ``params`` and bit-equal to the batch, each frame in which a
        position goes non-finite replayed with every launch held to its
        plain version (``replay_frame``, ``replay_corrected_frame``).
        Returns {scene: rows proven non-finite}."""
        bad = ~torch.isfinite(states.pos).all(2)
        proven = {}
        replay = replay_frame if faithful else replay_corrected_frame
        for sc in bad.any(1).nonzero()[:, 0].tolist():
            cs = cfg.replace(**overrides[sc])
            ps = PhysParams(*(x[sc] for x in params))
            pstep = make_param_step(cs, faithful=faithful)
            st = initial_state(cs, dev)
            proven[sc] = torch.zeros_like(bad[sc])
            for f in range(frames):
                nxt, _ = pstep(st, ps)
                if bool((~torch.isfinite(nxt.pos).all(1)
                         & torch.isfinite(st.pos).all(1)).any()):
                    label = (f"{cfg.substeps}-substep frame {f + 1} of scene "
                             f"{sc} (rest density {cs.rest_density:g}, "
                             f"faithful={faithful})")
                    rep, went = replay(cs, st, ps, label)
                    if not all(same_bits(a, b) for a, b in zip(rep, nxt)):
                        fail(f"{label}: the replay leaves the frame step")
                    proven[sc] |= went
                st = nxt
            if not all(same_bits(x[sc], y) for x, y in zip(states, st)):
                fail(f"scene {sc} alone leaves the batch")
        return proven

    def sweep_modes(label, cfg, overrides, kw, per_frame, solo_scenes):
        """One route of the sweep through ``BatchedScenes`` in both modes,
        the host loop and the graph, each after a first frame (which
        records the graph), run H G G H over C5_FRAMES frames each: the
        exact launches a frame in every run and the two modes' states and
        metrics bit-equal; each mode's aggregate particle-substeps/s and
        host ms a frame, and over the next C5_FRAMES frames its host ms
        beside the device ms of a second batch that runs the same frames
        under the profiler, and so the idle share; the scenes
        ``solo_scenes`` at frame C5_FRAMES + 1 bit-equal to their solo
        rollouts; positions in the cube (``in_cube``, with
        ``prove_scenes``)."""
        want = dict(zero, **{k: v * C5_FRAMES for k, v in per_frame.items()})
        modes = ("host", "graph")
        bss = {m: BatchedScenes(cfg, overrides, devices=dev,
                                host_loop=True if m == "host" else None,
                                **kw) for m in modes}
        for m in modes:
            if dev.type == "cuda" and bss[m].host_loop is not (m == "host"):
                fail(f"{label}, {m}: host_loop {bss[m].host_loop}")
            bss[m].step()
        sync()
        host_ms = {m: [] for m in modes}
        for k, m in enumerate(("host", "graph", "graph", "host")):
            sk.reset_launch_counts()
            t0 = time.perf_counter()
            bss[m].step(C5_FRAMES)
            sync()
            host_ms[m].append((time.perf_counter() - t0) * 1e3 / C5_FRAMES)
            read_launches(f"{label}, {m}", want)
            if k == 1:
                states, ms = bss["graph"].states, bss["graph"].last_metrics
        if not all(same_bits(x, y) for x, y in zip(
                (*bss["host"].states, *bss["host"].last_metrics),
                (*bss["graph"].states, *bss["graph"].last_metrics))):
            fail(f"{label}: the graph leaves the host loop")
        late_ms, dev_ms = {}, {}
        for m in modes:
            twin = BatchedScenes(cfg, overrides, devices=dev,
                                 host_loop=True if m == "host" else None,
                                 **kw)
            twin.step(2 * C5_FRAMES + 1)
            sync()
            t0 = time.perf_counter()
            bss[m].step(C5_FRAMES)
            sync()
            late_ms[m] = (time.perf_counter() - t0) * 1e3 / C5_FRAMES
            if dev.type == "cuda":
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    twin.step(C5_FRAMES)
                    sync()
                dev_ms[m] = device_ms(prof) / C5_FRAMES
            else:
                twin.step(C5_FRAMES)
                dev_ms[m] = float("nan")
            if not all(same_bits(x, y) for x, y in zip(twin.states,
                                                       bss[m].states)):
                fail(f"{label}, {m}: a second batch leaves the first")
            del twin
        work = len(overrides) * cfg.n_particles * cfg.substeps
        text = []
        for m in modes:
            mean = sum(host_ms[m]) / len(host_ms[m])
            text.append(
                f"{m} {work / mean * 1e3:.6g} particle-substeps/s aggregate "
                f"(host {' / '.join(f'{x:.4f}' for x in host_ms[m])} ms a "
                f"frame; frames {2 * C5_FRAMES + 2}-{3 * C5_FRAMES + 1} host "
                f"{late_ms[m]:.4f}, device {dev_ms[m]:.4f} ms a frame, idle "
                f"share {1 - dev_ms[m] / late_ms[m]:.4f})")
        print(f"{label}, {len(overrides)} scenes x {cfg.n_particles} "
              f"particles, frames 2-{2 * C5_FRAMES + 1}: {'; '.join(text)}; "
              f"graph/host rate "
              f"{sum(host_ms['host']) / sum(host_ms['graph']):.4f}; states "
              f"and metrics bit-equal at frames {C5_FRAMES + 1} and "
              f"{2 * C5_FRAMES + 1}; exact_cert {ms.exact_cert.tolist()} "
              f"[{ident}]", flush=True)
        params = bss["graph"].params
        del bss
        faithful = kw.get("faithful", True)
        for sc in solo_scenes:
            cs = cfg.replace(**overrides[sc])
            solo, _ = make_rollout(cs, C5_FRAMES + 1, faithful=faithful,
                                   tune=kw.get("tune"), device=dev)(
                initial_state(cs, dev))
            if not all(same_bits(x[sc], y) for x, y in zip(states, solo)):
                fail(f"{label}: scene {sc} leaves its solo rollout")
        print(f"{label}: scenes {list(solo_scenes)} at frame "
              f"{C5_FRAMES + 1} bit-equal to their solo rollouts", flush=True)
        # on the compact route a drifted row may end non-finite, counted by
        # its scene's certificate
        proven = ({} if kw.get("tune", SortedTuning()).compact else
                  prove_scenes(cfg, overrides, params, states, C5_FRAMES + 1,
                               faithful))
        for sc in range(len(overrides)):
            in_cube(states.pos[sc], f"{label} scene {sc}",
                    int(ms.exact_cert[sc]), proven.get(sc))

    # -- config 5 through the CLI: 1 K1 + 5 K2 launches a frame over the
    # scene axis (a replayed graph), 8 PNGs
    c5 = SimConfig(particle_number=c5_particles)
    png_dir = os.path.join(out_dir, "config5")
    os.makedirs(png_dir, exist_ok=True)
    for f in os.listdir(png_dir):
        os.remove(os.path.join(png_dir, f))
    c5_argv = ["sweep", "--device", dev.type, "--particles",
               str(c5_particles), "--scenes", str(c5_scenes)]
    scenes_want = dict(zero, density_scenes=C5_FRAMES,
                       frame_record=C5_FRAMES,
                       fused_substep_scenes=C5_FRAMES * 5)
    with Phase("config 5 sweep"):
        dt = run_cli(f"cli {' '.join(c5_argv)} --frames {C5_FRAMES} "
                     f"--export-dir", c5_argv + [
                         "--frames", str(C5_FRAMES), "--export-dir",
                         png_dir], scenes_want)
        pngs = sorted(os.listdir(png_dir))
        print(f"config 5 sweep: {len(pngs)} PNGs {pngs[:2]}..., "
              f"{sum(os.path.getsize(os.path.join(png_dir, f)) for f in pngs)}"
              f" bytes; the command's seconds include the spawns, the "
              f"graph's recording and the export", flush=True)
        if len(pngs) != c5_scenes:
            fail(f"config 5 sweep wrote {len(pngs)} PNGs")
        # the same batch in both modes, host loop and graph, each after a
        # first frame (which records the graph), run H G G H over frames
        # 2-4 and 5-7: the same launches, the same bits
        overrides = cli.sweep_overrides(1.0, 2.0, c5_scenes)
        modes = ("host", "graph")
        # the graph is the default on the card
        bss = {m: BatchedScenes(c5, overrides, devices=dev,
                                host_loop=True if m == "host" else None)
               for m in modes}
        for m in modes:
            if dev.type == "cuda" and bss[m].host_loop is not (m == "host"):
                fail(f"config 5 BatchedScenes, {m}: host_loop "
                     f"{bss[m].host_loop}")
            bss[m].step()
        sync()
        host_ms = {m: [] for m in modes}
        for k, m in enumerate(("host", "graph", "graph", "host")):
            sk.reset_launch_counts()
            t0 = time.perf_counter()
            bss[m].step(C5_FRAMES)
            sync()
            host_ms[m].append((time.perf_counter() - t0) * 1e3 / C5_FRAMES)
            read_launches(f"config 5 BatchedScenes, {m}", scenes_want)
            if k == 1:
                states4, m4 = bss["graph"].states, bss["graph"].last_metrics
        if not all(same_bits(x, y) for x, y in zip(
                (*bss["host"].states, *bss["host"].last_metrics),
                (*bss["graph"].states, *bss["graph"].last_metrics))):
            fail("config 5: the graph leaves the host loop")
        # frames 8-10 of each mode on the host clock, and the same frames of
        # a twin batch (stepped to frame 7 untimed) under the profiler: the
        # device ms a frame and the idle share of the same work
        late_ms, dev_ms = {}, {}
        for m in modes:
            twin = BatchedScenes(c5, overrides, devices=dev,
                                 host_loop=True if m == "host" else None)
            twin.step(2 * C5_FRAMES + 1)
            sync()
            t0 = time.perf_counter()
            bss[m].step(C5_FRAMES)
            sync()
            late_ms[m] = (time.perf_counter() - t0) * 1e3 / C5_FRAMES
            if dev.type == "cuda":
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    twin.step(C5_FRAMES)
                    sync()
                dev_ms[m] = device_ms(prof) / C5_FRAMES
            else:
                twin.step(C5_FRAMES)
                dev_ms[m] = float("nan")
            if not all(same_bits(x, y) for x, y in zip(twin.states,
                                                       bss[m].states)):
                fail(f"config 5, {m}: a second batch leaves the first")
            del twin
        if not all(same_bits(x, y) for x, y in zip(
                (*bss["host"].states, *bss["host"].last_metrics),
                (*bss["graph"].states, *bss["graph"].last_metrics))):
            fail("config 5: the graph leaves the host loop at frame 10")
        work = c5_scenes * c5.n_particles * c5.substeps
        text = []
        for m in modes:
            mean = sum(host_ms[m]) / len(host_ms[m])
            text.append(
                f"{m} {work / mean * 1e3:.6g} particle-substeps/s aggregate "
                f"(host {' / '.join(f'{x:.4f}' for x in host_ms[m])} ms a "
                f"frame; frames 8-10 host {late_ms[m]:.4f}, device "
                f"{dev_ms[m]:.4f} ms a frame, idle share "
                f"{1 - dev_ms[m] / late_ms[m]:.4f})")
        print(f"config 5 sorted, {c5_scenes} scenes x {c5.n_particles} "
              f"particles, frames 2-{2 * C5_FRAMES + 1}: {'; '.join(text)}; "
              f"graph/host rate {sum(host_ms['host']) / sum(host_ms['graph']):.4f}"
              f"; states and metrics bit-equal at frames {C5_FRAMES + 1}, "
              f"{2 * C5_FRAMES + 1} and {3 * C5_FRAMES + 1} [{ident}]",
              flush=True)
        params = bss["graph"].params
        del bss
        # every scene at frame 4 against its solo rollout (1 K1 + 5 K2 a
        # frame, the solo instances), bit for bit
        states, m = states4, m4
        for sc in range(c5_scenes):
            cs = c5.replace(**overrides[sc])
            sk.reset_launch_counts()
            solo, _ = make_rollout(cs, C5_FRAMES + 1, device=dev)(
                initial_state(cs, dev))
            sync()
            read_launches(f"config 5 scene {sc} alone", dict(
                zero, density=C5_FRAMES + 1,
                fused_substep=(C5_FRAMES + 1) * 5))
            if not all(same_bits(x[sc], y) for x, y in zip(states, solo)):
                fail(f"config 5: scene {sc} leaves its solo rollout")
        print(f"config 5: each of the {c5_scenes} scenes at frame "
              f"{C5_FRAMES + 1} bit-equal to its solo rollout; mean_density "
              f"{[round(float(x), 4) for x in m.mean_density]}, overflow "
              f"{m.overflow.tolist()}, exact_cert {m.exact_cert.tolist()} "
              f"[{ident}]", flush=True)
        # K1 and K2 at config 5's shape and per-scene scalars: each scene
        # stepped alone on its row of the batch's PhysParams; the last frame
        # of the two ends of the rest-density sweep, and each frame in which
        # a scene's position goes non-finite, replayed with every launch
        # held to its plain version
        bad = ~torch.isfinite(states.pos).all(2)
        proven = {}
        for sc in sorted({0, c5_scenes - 1,
                          *bad.any(1).nonzero()[:, 0].tolist()}):
            cs = c5.replace(**overrides[sc])
            ps = PhysParams(*(x[sc] for x in params))
            pstep = make_param_step(cs)
            st = initial_state(cs, dev)
            proven[sc] = torch.zeros_like(bad[sc])
            for f in range(C5_FRAMES + 1):
                nxt, _ = pstep(st, ps)
                grew = (~torch.isfinite(nxt.pos).all(1)
                        & torch.isfinite(st.pos).all(1))
                last = f == C5_FRAMES and sc in (0, c5_scenes - 1)
                if bool(grew.any()) or last:
                    label = (f"config 5 scene {sc} (rest density "
                             f"{cs.rest_density:g}) frame {f + 1}")
                    rep, went = replay_frame(cs, st, ps, label)
                    if not all(same_bits(a, b) for a, b in zip(rep, nxt)):
                        fail(f"{label}: the replay leaves the frame step")
                    proven[sc] |= went
                    print(f"{label}: replayed bit-equal to the frame step, "
                          f"{int(went.sum())} rows went non-finite, each "
                          f"with the plain version's", flush=True)
                st = nxt
            if not all(same_bits(x[sc], y) for x, y in zip(states, st)):
                fail(f"config 5: scene {sc} alone leaves the batch")
        for sc in range(c5_scenes):
            in_cube(states.pos[sc], f"config 5 scene {sc}",
                    int(m.exact_cert[sc]), proven.get(sc))
        del states
        # the batch with the extension sums: config 3's physics, 2 scenes,
        # 1 K1 + 5 K2-ext a frame over the scene axis
        c3b = SimConfig(particle_number=c5_particles, preset=2, xsph=XSPH,
                        artificial_viscosity=ALPHA)
        ov3 = cli.sweep_overrides(1.2, 1.8, 2)
        bs = BatchedScenes(c3b, ov3, devices=dev)
        bs.step()                                      # records the graph
        sync()
        sk.reset_launch_counts()
        bs.step()
        sync()
        read_launches("config 3 BatchedScenes", dict(
            zero, density_scenes=1, frame_record=1,
            fused_substep_ext_scenes=5))
        for sc in range(2):
            cs = c3b.replace(**ov3[sc])
            sk.reset_launch_counts()
            solo, _ = make_rollout(cs, 2, device=dev)(initial_state(cs,
                                                                    dev))
            sync()
            read_launches(f"config 3 scene {sc} alone", dict(
                zero, density=2, fused_substep_ext=10))
            if not all(same_bits(x[sc], y) for x, y in zip(bs.states,
                                                           solo)):
                fail(f"config 3 batch: scene {sc} leaves its solo rollout")
        print("config 3 batch of 2 scenes with extensions: each scene "
              "bit-equal to its solo rollout after 2 frames", flush=True)
        del bs, solo
    # -- the sweep's other routes on the scene axis: --corrected (6
    # K1-scenes + 5 K3-scenes a frame) and SPH_PALLAS_COMPACT=1 (1 + 5
    # K5-scenes), through the CLI and through BatchedScenes in both modes;
    # the compact route corrected (6 + 5 K5-scenes), and the config-3 batch
    # corrected (K3-ext-scenes) and compact (K5-ext-scenes), one frame each
    compact_tune = SortedTuning(compact=True)
    with Phase("config 5 corrected and compact sweeps"):
        for env, extra, per_frame in (
                ({}, ["--corrected"], dict(density_scenes=6,
                                           frame_record=5,
                                           forces_scenes=5)),
                ({"SPH_PALLAS_COMPACT": "1"}, [],
                 dict(compact_density_scenes=1,
                      compact_substep_scenes=5))):
            os.environ.update(env)
            try:
                run_cli(f"cli {env or ''} {' '.join(c5_argv + extra)} "
                        f"--frames {C5_FRAMES}",
                        c5_argv + extra + ["--frames", str(C5_FRAMES)],
                        dict(zero, **{k: v * C5_FRAMES
                                      for k, v in per_frame.items()}))
            finally:
                for var in env:
                    del os.environ[var]
        ends = (0, c5_scenes - 1)
        sweep_modes("config 5 corrected", c5, overrides,
                    dict(faithful=False), dict(density_scenes=6,
                                               frame_record=5,
                                               forces_scenes=5), ends)
        sweep_modes("config 5 compact", c5, overrides,
                    dict(tune=compact_tune),
                    dict(compact_density_scenes=1,
                         compact_substep_scenes=5), ends)
        for label, cfg, ov, kw, want in (
                ("config 5 compact corrected", c5, overrides,
                 dict(faithful=False, tune=compact_tune),
                 dict(compact_density_scenes=6, compact_forces_scenes=5)),
                ("config 3 batch corrected", c3b, ov3,
                 dict(faithful=False),
                 dict(density_scenes=6, frame_record=5,
                      forces_ext_scenes=5)),
                ("config 3 batch compact", c3b, ov3, dict(tune=compact_tune),
                 dict(compact_density_scenes=1,
                      compact_substep_ext_scenes=5))):
            bs = BatchedScenes(cfg, ov, devices=dev, **kw)
            bs.step()                                  # records the graph
            sync()
            sk.reset_launch_counts()
            bs.step()
            sync()
            read_launches(label, dict(zero, **want))
            sc = len(ov) - 1
            cs = cfg.replace(**ov[sc])
            solo, _ = make_rollout(cs, 2, faithful=kw.get("faithful", True),
                                   tune=kw.get("tune"), device=dev)(
                initial_state(cs, dev))
            if not all(same_bits(x[sc], y) for x, y in zip(bs.states, solo)):
                fail(f"{label}: scene {sc} leaves its solo rollout")
            m = bs.last_metrics
            print(f"{label}: scene {sc} bit-equal to its solo rollout after "
                  f"2 frames; exact_cert {m.exact_cert.tolist()} [{ident}]",
                  flush=True)
            for k in range(len(ov)):
                in_cube(bs.states.pos[k], f"{label} scene {k}",
                        int(m.exact_cert[k]))
            del bs, solo
    with Phase("config 5 slotted"):
        dt = run_cli(f"cli {' '.join(c5_argv)} --frames 1 --neighbor "
                     f"slotted", c5_argv + ["--frames", "1", "--neighbor",
                                            "slotted"], zero)
        print(f"config 5 slotted, 1 frame (spawns included): "
              f"{c5_scenes * c5.n_particles * c5.substeps / dt:.6g} "
              f"particle-substeps/s [{ident}]", flush=True)

    # -- the sites tier: 262k golden (frame 1 escalates), 1M banded, calm
    calm = SimConfig(particle_number=1024, bucket_resolution=11, preset=0,
                     gas_constant=20.0, rest_density=1.7, viscosity=0.05,
                     stiffness_coefficient=1000.0, frame_dt=1 / 240)
    from sphfluidsimulation_torch.bench import site_bands

    def run_sites(cfg, frames, st0):
        """(final, metrics, seconds, peak bytes above the start) of a sites
        rollout."""
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        final, m = make_rollout(cfg, frames, neighbor="sites",
                                device=dev)(st0)
        sync()
        dt = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) - base
                if dev.type == "cuda" else 0)
        return final, m, dt, peak

    for key, frames in (("262k", SITES_FRAMES), ("1m", 1)):
        cfg = sizes[key]
        with Phase(f"sites {key}"):
            st0 = initial_state(cfg, dev)
            sk.reset_launch_counts()
            final, m, dt, peak = run_sites(cfg, frames, st0)
            read_launches(f"the sites path {key}", zero)
            cert = m.exact_cert.tolist()
            print(f"sites {key}: N={cfg.n_particles} R="
                  f"{cfg.bucket_resolution}, {site_bands(cfg, dev)} z-band(s), "
                  f"{frames} frame(s) from the spawn in {dt:.4f} s = "
                  f"{cfg.n_particles * cfg.substeps * frames / dt:.6g} "
                  f"particle-substeps/s, peak {peak / 2**20:.1f} MiB; "
                  f"exact_cert {cert}, overflow {m.overflow.tolist()}, "
                  f"max_speed "
                  f"{[float(f'{x:.4g}') for x in m.max_speed.tolist()]} "
                  f"[{ident}]", flush=True)
            in_cube(final.pos, f"sites {key}", sum(cert))
            if key != "1m":
                continue
            # the other band count (one piece, or the TPU rule's bands),
            # timed on the same frame: bit-identical to the auto count
            nb = site_bands(cfg, dev)
            alt = 1 if nb != 1 else sites.auto_bands(cfg.bucket_resolution)
            out, m2, dt2, peak2 = run_sites(cfg.replace(site_bands=alt),
                                            frames, st0)
            bits = all(same_bits(a, b) for a, b in zip(out, final))
            est = sites.one_piece_bytes(
                cfg.bucket_resolution, cfg.n_particles,
                cfg.site_capacity_i or cfg.site_capacity, cfg.site_capacity)
            peak1 = peak if nb == 1 else peak2
            print(f"sites {key} with {alt} z-band(s): {frames} frame(s) in "
                  f"{dt2:.4f} s = "
                  f"{cfg.n_particles * cfg.substeps * frames / dt2:.6g} "
                  f"particle-substeps/s, peak {peak2 / 2**20:.1f} MiB; "
                  f"bit-equal to {nb} z-band(s) {bits}; the one-piece "
                  f"pass's peak {peak1 / 2**20:.1f} MiB within its bound "
                  f"sites.one_piece_bytes {est / 2**20:.1f} MiB "
                  f"{peak1 <= est} [{ident}]", flush=True)
            if dev.type == "cuda" and peak1 > est:
                fail(f"sites {key}: the one-piece pass takes more than "
                     f"sites.one_piece_bytes")
            if not bits:
                fail(f"sites {key}: {alt} z-band(s) leave {nb}")
    with Phase("sites calm 1k"):
        for cfg in (calm, calm.replace(xsph=0.3, artificial_viscosity=0.4)):
            s0 = initial_state(cfg, dev)
            for faithful in (True, False):
                a, ma = make_rollout(cfg, 3, neighbor="sites",
                                     faithful=faithful, device=dev)(s0)
                b, mb = make_rollout(cfg, 3, neighbor="brute",
                                     faithful=faithful, device=dev)(s0)
                e = float((a.pos - b.pos).abs().max())
                print(f"calm 1k sites, xsph {cfg.xsph}, alpha "
                      f"{cfg.artificial_viscosity}, faithful={faithful}: vs "
                      f"brute max |dpos| {e:.3e} over 3 frames (< "
                      f"{ORACLE_ATOL:g}); exact_cert {ma.exact_cert.tolist()}",
                      flush=True)
                if not (e < ORACLE_ATOL and int(ma.exact_cert.sum()) == 0
                        and torch.equal(ma.overflow, mb.overflow)):
                    fail(f"the sites tier leaves the brute oracle "
                         f"(faithful={faithful}, xsph {cfg.xsph})")

    # -- the sites slab step on LocalRing(4)
    with Phase("sites slab 262k"):
        cfg = sizes["262k"]
        step, spec = make_slab_step(cfg, LocalRing(SLAB_D),
                                    row_slack=SLAB_SLACK, device=dev)
        phys = PhysParams.from_config(cfg, dev)
        sst = distribute(initial_state(cfg, dev), cfg, spec)
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        certs = []
        for _ in range(SITES_FRAMES):
            sst, m = step(sst, phys)
            certs.append(int(m.exact_cert))
        sync()
        dt = time.perf_counter() - t0
        read_launches("the sites slab path 262k", zero)
        out, lost = collect(sst, cfg.n_particles)
        print(f"sites slab 262k on {SLAB_D} slabs: {SITES_FRAMES} frames "
              f"from the spawn in {dt:.4f} s = "
              f"{cfg.n_particles * cfg.substeps * SITES_FRAMES / dt:.6g} "
              f"particle-substeps/s; exact_cert {certs}, lost {lost} "
              f"[{ident}]", flush=True)
        in_cube(out.pos, "sites slab 262k", sum(certs))
        if lost:
            fail(f"sites slab 262k lost {lost} rows")
        run_cli(f"cli run --shards {SLAB_D} at 262k", [
            "run", "--device", dev.type, "--particles",
            str(cfg.particle_number), "--bucket-resolution",
            str(cfg.bucket_resolution), "--shards", str(SLAB_D),
            "--row-slack", str(SLAB_SLACK), "--frames", "1"], zero)
    with Phase("sites slab calm 1k"):
        slab_calm = calm.replace(gas_constant=1.0, site_capacity=24)
        rng = torch.Generator().manual_seed(0)
        st = initial_state(slab_calm, dev)._replace(
            pos=(0.05 + 0.9 * torch.rand(slab_calm.n_particles, 3,
                                         generator=rng)).to(dev),
            vel=(0.02 * torch.randn(slab_calm.n_particles, 3,
                                    generator=rng)).to(dev))
        ref, mr = make_frame_step(slab_calm, neighbor="sites",
                                  device=dev)(st)
        for d in (2, 4):
            step, spec = make_slab_step(slab_calm, LocalRing(d), device=dev)
            sst, m = step(distribute(st, slab_calm, spec),
                          PhysParams.from_config(slab_calm, dev))
            out, lost = collect(sst, slab_calm.n_particles)
            ep = float((out.pos - ref.pos).abs().max())
            ev = float((out.vel - ref.vel).abs().max())
            print(f"sites slab calm 1k on {d} slabs: max |dpos| {ep:.3e} "
                  f"(< {SITES_SLAB_POS:g}), max |dvel| {ev:.3e} (< "
                  f"{SITES_SLAB_VEL:g}), exact_cert {int(m.exact_cert)}, "
                  f"lost {lost}", flush=True)
            if not (ep < SITES_SLAB_POS and ev < SITES_SLAB_VEL and lost == 0
                    and int(m.exact_cert) == 0
                    and int(m.overflow) == int(mr.overflow)):
                fail(f"the sites slab step on {d} slabs leaves the single "
                     f"device")

    # -- the row-sharded domain step against the single-device gather step
    with Phase("domain 262k"):
        cfg = sizes["262k"]
        st0 = initial_state(cfg, dev)
        phys = PhysParams.from_config(cfg, dev)
        ref, mr = make_frame_step(cfg, neighbor="gather", device=dev)(st0)
        step = make_sharded_frame_step(cfg, LocalRing(SLAB_D), device=dev)
        sk.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        out, m = step(st0, phys)
        sync()
        dt = time.perf_counter() - t0
        read_launches("the domain path 262k", zero)
        e = float(torch.where(torch.isnan(ref.pos), 0.0,
                              out.pos - ref.pos).abs().max())
        same_nan = torch.equal(torch.isnan(out.pos), torch.isnan(ref.pos))
        print(f"domain 262k on {SLAB_D} row shards: 1 frame in {dt:.4f} s = "
              f"{cfg.n_particles * cfg.substeps / dt:.6g} particle-substeps/s;"
              f" max |dpos| against the gather step {e:.3e} (< 2e-6), same "
              f"NaN rows {same_nan}, overflow {int(m.overflow)} (gather "
              f"{int(mr.overflow)}) [{ident}]", flush=True)
        if not (e < 2e-6 and same_nan
                and int(m.overflow) == int(mr.overflow)):
            fail("the domain step leaves the single-device gather step")

    # -- entry(), once
    with Phase("entry"):
        step, (state, phys) = entry.entry(dev)
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, phys)
        sync()
        dt = time.perf_counter() - t0
        read_launches("entry()", dict(zero, density=1, fused_substep=5))
        print(f"entry(): one frame of {state.pos.shape[0]} particles in "
              f"{dt:.4f} s, exact_cert {int(m.exact_cert)} [{ident}]",
              flush=True)
        in_cube(state.pos, "entry()", int(m.exact_cert))


def flat(out):
    """A rollout's or a step's outputs as one list of tensors."""
    return [t for x in out for t in (x if isinstance(x, tuple) else (x,))]


def bit_equal(a, b) -> bool:
    """Equal tensor lists, NaNs and signed zeros bit for bit."""
    import torch
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            *(t.view(torch.int32) if t.is_floating_point() else t
              for t in (x, y)))
        for x, y in zip(a, b))


def mode_text(work: int, host_ms: dict, dev_ms: dict) -> str:
    """Each mode's rate, host ms a frame of each run, device ms a frame and
    device idle share, and the graph's rate over the host loop's."""
    text = []
    for m in ("host", "graph"):
        mean = sum(host_ms[m]) / len(host_ms[m])
        text.append(
            f"{m} {work / mean * 1e3:.6g} particle-substeps/s (host "
            f"{' / '.join(f'{x:.4f}' for x in host_ms[m])} ms a frame, "
            f"device {dev_ms[m]:.4f}, idle share {1 - dev_ms[m] / mean:.4f})")
    gain = sum(host_ms["host"]) / sum(host_ms["graph"])
    return f"{'; '.join(text)}; graph/host rate {gain:.4f}"


def profiled_ms(run, frames: int) -> float:
    """Device ms a frame of ``run()`` (``frames`` frames) under the
    profiler: its kernels, copies and memsets."""
    import torch

    from sphfluidsimulation_torch.utils.profiling import device_ms
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    return device_ms(prof) / frames


def slab_graph(dev, ident: str, read_launches, zero: dict, sizes: dict, c3,
               k5, states0: dict, c3_state) -> None:
    """The slab step on ``LocalRing(SLAB_D)`` as one recorded frame a call
    (``slab_pallas.GraphSlabStep``, the default on the card) against its
    host loop (``host_loop=True``): at 262k and config 3 on the window
    route and at 262k on the compact route, ``SLAB_FRAMES`` frames from
    the same slab state after a first call of each (which records the
    graph), run host, graph, graph, host with the exact launches in each
    run, the states and every metric lane of each frame bit-equal; each
    mode's rate, host and device ms a frame and idle share. Then the slab
    rates in both modes at 262k and 1M beside the single-device graph
    rollout's."""
    import torch

    from sphfluidsimulation_torch.ops import sph_kernels as sk
    from sphfluidsimulation_torch.params import PhysParams
    from sphfluidsimulation_torch.parallel import (LocalRing, distribute,
                                                   make_pallas_slab_step)
    from sphfluidsimulation_torch.sim.stepper import make_rollout

    modes = ("host", "graph")

    def steps_of(cfg, tune=None):
        steps = {}
        for m in modes:
            steps[m], spec = make_pallas_slab_step(
                cfg, LocalRing(SLAB_D), row_slack=SLAB_SLACK,
                halo_slack=SLAB_HALO, tune=tune, device=dev,
                host_loop=True if m == "host" else None)
            if steps[m].host_loop is not (m == "host"):
                fail(f"the {m} slab step reports host_loop "
                     f"{steps[m].host_loop}")
        return steps, spec

    def frames(step, st, phys):
        """Every frame's state and metrics over SLAB_FRAMES frames."""
        out = []
        for _ in range(SLAB_FRAMES):
            st, m = step(st, phys)
            out += [*st, *m]
        return out

    def runs(label, steps, s0, phys, want):
        """H G G H, each counted and host-timed: (outputs, host ms)."""
        for m in modes:
            frames(steps[m], s0, phys)       # warm-up; the graph's records
        outs, host_ms = {}, {m: [] for m in modes}
        for m in ("host", "graph", "graph", "host"):
            torch.cuda.synchronize()
            sk.reset_launch_counts()
            t0 = time.perf_counter()
            out = frames(steps[m], s0, phys)
            torch.cuda.synchronize()
            host_ms[m].append((time.perf_counter() - t0) * 1e3 / SLAB_FRAMES)
            if want is not None:
                read_launches(f"slab {label}, {m}", want)
            if m in outs and not bit_equal(outs[m], out):
                fail(f"slab {label}: two {m} runs differ")
            outs[m] = out
        return outs, host_ms

    cells = {"262k": (sizes["262k"], None, states0["262k"],
                      dict(density_band=1, fused_substep_band=5)),
             "config 3": (c3, None, c3_state,
                          dict(density_band=1, fused_substep_ext_band=5)),
             "262k compact": (sizes["262k"], k5, states0["262k"],
                              dict(compact_density_band=1,
                                   compact_substep_band=5))}
    with Phase("slab graph against host loop"):
        for label, (cfg, tune, st0, per_frame) in cells.items():
            steps, spec = steps_of(cfg, tune)
            phys = PhysParams.from_config(cfg, dev)
            s0 = distribute(st0, cfg, spec)
            want = dict(zero, **{k: v * SLAB_D * SLAB_FRAMES
                                 for k, v in per_frame.items()})
            outs, host_ms = runs(label, steps, s0, phys, want)
            if not bit_equal(outs["host"], outs["graph"]):
                fail(f"slab {label}: the graph leaves the host loop")
            dev_ms = {m: profiled_ms(lambda: frames(steps[m], s0, phys),
                                     SLAB_FRAMES) for m in modes}
            certs = [int(x) for x in outs["graph"][10::11]]
            work = cfg.n_particles * cfg.substeps
            print(f"slab graph vs host loop, {label}, {SLAB_D} slabs, "
                  f"frames 0-{SLAB_FRAMES - 1}: "
                  f"{mode_text(work, host_ms, dev_ms)}; states and metrics "
                  f"of every frame bit-equal; exact_cert {certs} [{ident}]",
                  flush=True)

    with Phase("slab rates"):
        for key, cfg in sizes.items():
            steps, spec = steps_of(cfg)
            phys = PhysParams.from_config(cfg, dev)
            s1, _ = steps["graph"](distribute(states0[key], cfg, spec), phys)
            _, host_ms = runs(f"rates {key}", steps, s1, phys, None)
            st1, _ = make_rollout(cfg, 1, device=dev)(states0[key])
            roll = make_rollout(cfg, SLAB_FRAMES, device=dev)
            roll(st1)                                 # records the graph
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            roll(st1)
            torch.cuda.synchronize()
            one_ms = (time.perf_counter() - t0) * 1e3 / SLAB_FRAMES
            work = cfg.n_particles * cfg.substeps
            rates = {m: work / (sum(v) / len(v)) * 1e3
                     for m, v in host_ms.items()}
            text = {m: " / ".join(f"{x:.4f}" for x in v)
                    for m, v in host_ms.items()}
            print(f"slab rate {key} ({SLAB_D} slabs, frames 1-{SLAB_FRAMES},"
                  f" H G G H): host loop {rates['host']:.6g} "
                  f"particle-substeps/s ({text['host']} ms a frame), graph "
                  f"{rates['graph']:.6g} ({text['graph']} ms); single-device "
                  f"graph rollout {work / one_ms * 1e3:.6g} ({one_ms:.4f} "
                  f"ms); graph / single device "
                  f"{rates['graph'] * one_ms / work / 1e3:.4f} [{ident}]",
                  flush=True)


def phase13(dev, ident: str, read_launches, zero: dict, sizes: dict, c3,
            k5, states0: dict, c3_state) -> None:
    """The sorted tier's rollout as a replayed CUDA graph (``sim/graph.py``,
    the default on the card) against its host loop (``host_loop=True``),
    each from the same spawn state: bit-equal outputs, metrics and
    snapshots included, the exact launch counts in both modes, and each
    mode's rate, host and device ms a frame and device idle share."""
    import torch

    from sphfluidsimulation_torch import Scene, make_dt_rollout
    from sphfluidsimulation_torch.ops import sph_kernels as sk
    from sphfluidsimulation_torch.sim.stepper import make_rollout

    modes = ("host", "graph")

    def timed_call(label, mode, roll, args, want):
        """One counted, host-timed call: (flat outputs, host ms)."""
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        out = flat(roll(*args))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        read_launches(f"{label}, {mode}", want)
        if roll.host_loop is not (mode == "host"):
            fail(f"{label}: the {mode} rollout reports host_loop "
                 f"{roll.host_loop}")
        return out, ms

    # (config, faithful, tune, state, launches a frame)
    cells = {
        "262k": (sizes["262k"], True, None, states0["262k"],
                 dict(density=1, fused_substep=5)),
        "1m": (sizes["1m"], True, None, states0["1m"],
               dict(density=1, fused_substep=5)),
        "config 3 faithful": (c3, True, None, c3_state,
                              dict(density=1, fused_substep_ext=5)),
        "config 3 corrected": (c3, False, None, c3_state,
                               dict(density=6, forces=5)),
        "262k compact": (sizes["262k"], True, k5, states0["262k"],
                         dict(compact_density=1, compact_substep=5)),
    }
    with Phase("graph against host loop"):
        for label, (cfg, faithful, tune, st0, per_frame) in cells.items():
            want = dict(zero, **{k: v * FRAMES for k, v in per_frame.items()})
            rolls = {m: make_rollout(cfg, FRAMES, faithful=faithful,
                                     tune=tune, device=dev,
                                     host_loop=m == "host") for m in modes}
            for m in modes:
                rolls[m](st0)          # warm-up; the graph's records it
            outs, host_ms = {}, {m: [] for m in modes}
            for m in ("host", "graph", "graph", "host"):
                outs[m], ms = timed_call(label, m, rolls[m], (st0,), want)
                host_ms[m].append(ms / FRAMES)
            if not bit_equal(outs["host"], outs["graph"]):
                fail(f"{label}: the graph leaves the host loop")
            dev_ms = {m: profiled_ms(lambda: rolls[m](st0), FRAMES)
                      for m in modes}
            work = cfg.n_particles * cfg.substeps
            print(f"graph vs host loop, {label}, frames 0-{FRAMES - 1}: "
                  f"{mode_text(work, host_ms, dev_ms)}; outputs and metrics "
                  f"bit-equal [{ident}]", flush=True)

        # Scene.step, one frame a call: jit=True (the default) replays the
        # recorded frame, jit=False steps eagerly; each run from the spawn
        cfg, st0 = sizes["262k"], states0["262k"]
        scenes = {m: Scene(cfg, device=dev, jit=m == "graph") for m in modes}
        want = dict(zero, density=FRAMES, fused_substep=5 * FRAMES)

        def scene_run(scene):
            scene.state = st0
            for _ in range(FRAMES):
                st = scene.step()
            return [*st, *scene.last_metrics]

        for m in modes:
            if scenes[m].host_loop is not (m == "host"):
                fail(f"Scene(jit={m == 'graph'}) reports host_loop "
                     f"{scenes[m].host_loop}")
            scenes[m].step()                  # the graph's records it
        outs, host_ms = {}, {m: [] for m in modes}
        for m in ("host", "graph", "graph", "host"):
            torch.cuda.synchronize()
            sk.reset_launch_counts()
            t0 = time.perf_counter()
            outs[m] = scene_run(scenes[m])
            torch.cuda.synchronize()
            host_ms[m].append((time.perf_counter() - t0) * 1e3 / FRAMES)
            read_launches(f"Scene.step 262k, {m}", want)
        if not bit_equal(outs["host"], outs["graph"]):
            fail("Scene(jit=True) leaves the eager step")
        dev_ms = {m: profiled_ms(lambda: scene_run(scenes[m]), FRAMES)
                  for m in modes}
        work = cfg.n_particles * cfg.substeps
        print(f"Scene.step jit=True vs jit=False, 262k, frames 0-"
              f"{FRAMES - 1}, one frame a call: "
              f"{mode_text(work, host_ms, dev_ms)}; state and metrics "
              f"bit-equal [{ident}]", flush=True)

        cfg, st0 = sizes["262k"], states0["262k"]
        nf = len(DT_SCHEDULE)
        for label, make, args, want in (
                ("262k snapshot_every=5", lambda hl: make_rollout(
                    cfg, FRAMES, snapshot_every=5, device=dev, host_loop=hl),
                 (st0,), dict(zero, density=FRAMES,
                              fused_substep=5 * FRAMES)),
                ("262k dt replay", lambda hl: make_dt_rollout(
                    cfg, nf, device=dev, host_loop=hl),
                 (st0, DT_SCHEDULE), dict(zero, density=nf,
                                          fused_substep=5 * nf))):
            outs = {}
            for m in modes:
                roll = make(m == "host")
                roll(*args)
                outs[m], _ = timed_call(label, m, roll, args, want)
            ok = bit_equal(outs["host"], outs["graph"])
            print(f"graph vs host loop, {label}: {len(outs['graph'])} "
                  f"output tensors bit-equal {ok} [{ident}]", flush=True)
            if not ok:
                fail(f"{label}: the graph leaves the host loop")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from itertools import cycle

    import numpy as np

    from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig, cli
    from sphfluidsimulation_torch.bench import scaled_config
    from sphfluidsimulation_torch.ops import compact, cuda_build
    from sphfluidsimulation_torch.ops import sph_kernels as sk
    from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning
    from sphfluidsimulation_torch.ops.frame import (build_frame,
                                                    build_frame_scenes,
                                                    scene_frame)
    from sphfluidsimulation_torch.parallel import BatchedScenes
    from sphfluidsimulation_torch.params import PhysParams, stack_params
    from sphfluidsimulation_torch.probes.common import past_l2
    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      integrate_substep,
                                                      make_rollout)
    from sphfluidsimulation_torch.state import stack_states
    from sphfluidsimulation_torch.utils.profiling import (CudaTimer,
                                                          gpu_identity)

    # ---- 1. identity
    ident = gpu_identity().splitlines()[0]
    dev = torch.device("cuda")
    print(f"gpu: {ident} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc {cuda_build.nvcc_path()}", flush=True)

    # ---- 2. build: the default libraries and the variants' (phase 9)
    FACC0, KAHAN, BF16 = (SortedTuning(fuse_acc=False),
                          SortedTuning(kahan=True), SortedTuning(bf16=True))
    with Phase("build"):
        libs = cuda_build.build((FACC0, KAHAN, BF16), probes=True)
        cuda_build.load()
        for lib in libs:
            secs = cuda_build.build_seconds.get(lib.name)
            print(f"build {lib.name}: "
                  f"{'cached' if secs is None else f'{secs:.2f} s of nvcc'}",
                  flush=True)

    sizes = {"262k": GOLDEN_CONFIG, "1m": scaled_config(1 << 20)}
    c3 = SimConfig(particle_number=524288, preset=2, xsph=XSPH,
                   artificial_viscosity=ALPHA)
    k5 = SortedTuning(compact=True)
    # the batches of the scene axis: config 5, and 2 scenes of config 3's
    # physics (the extension sums), as phase 12 runs them
    c5 = SimConfig(particle_number=C5_PARTICLES)
    c5_ov = cli.sweep_overrides(1.0, 2.0, C5_SCENES)
    c3b = SimConfig(particle_number=C5_PARTICLES, preset=2, xsph=XSPH,
                    artificial_viscosity=ALPHA)
    c3b_ov = cli.sweep_overrides(1.2, 1.8, 2)
    errs = dict.fromkeys(KERNELS, 0.0)

    def frame_inputs(cfg, state):
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        phys = PhysParams.from_config(cfg, dev)
        frame, (pos_s, vel_s) = build_frame(state.pos, r, cap,
                                            extras=(state.pos, state.vel))
        return frame, pos_s, vel_s, phys, r, cap

    def max_err(k, p):
        # lanes equal in both (infinities included) differ by 0
        return float(torch.where(torch.isnan(p) | (k == p), 0.0,
                                 k - p).abs().max())

    def rule_line(acc):
        return (f"max|k-f64| {acc.err:.3e} (plain f32 {acc.err_plain:.3e}), "
                f"roundings needed {acc.roundings:.4g} of "
                f"{sk.SUBSTEP_ROUNDINGS:g}, lanes over bound {acc.n_over}")

    def must_pass(acc, what, label):
        if not acc.ok:
            fail(f"{what} disagrees at {label}: {rule_line(acc)}; same NaN "
                 f"pattern {acc.same_nan}, same rho/nan lanes "
                 f"{acc.same_aux}")
        return rule_line(acc)

    def must_fail(acc, what, label):
        print(f"planted control {label}, {what}: roundings needed "
              f"{acc.roundings:.4g}, lanes over bound {acc.n_over}",
              flush=True)
        if acc.ok:
            fail(f"the check passes {what} at {label}")

    def hold_density(rho_k, rho_p, name, label):
        torch.cuda.synchronize()
        d = (rho_k - rho_p).abs()
        tol = DENSITY_RTOL * rho_p.abs() + 1e-6 * rho_p.abs().max()
        e_d = float(d.max())
        if not bool(torch.isfinite(rho_k).all()) or bool((d > tol).any()):
            fail(f"{name} kernel disagrees at {label}: max |err| {e_d}")
        errs[name] = max(errs[name], e_d)
        print(f"compare {label}: {name} max|k-p| {e_d:.3e} (max rho "
              f"{float(rho_p.max()):.4g})", flush=True)

    def compare_density(frame, pos_s, phys, r, cap, label):
        """K1 against its plain version; returns both densities."""
        rho_k = sk.density_cuda(frame, pos_s, phys, r, cap)
        rho_p = sk.density_plain(frame, pos_s, phys, r, cap)
        hold_density(rho_k, rho_p, "density", label)
        return rho_k, rho_p

    def same_cert(ck, cp, what, label):
        if int(ck) != int(cp):
            fail(f"{what} at {label}: drift count {int(ck)}, plain version "
                 f"{int(cp)}")
        return int(ck)

    def compare_k5(cfg, state, label, forces=False, planted=False,
                   substep=True):
        """K5 against its plain versions: density on the frame, then (with
        ``substep``) the fused substep (and the forces) on rows two
        substeps into the frame (two K5 launches), whose fresh cells may
        have left their tile's band. The drift count of each kernel equals
        its plain version's (the fresh spans of the same rows)."""
        frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, state)
        xs, al = cfg.xsph, cfg.artificial_viscosity
        ext = sk.uses_extensions(xs, al)
        rho_k, ck = compact.density_compact_cuda(frame, pos_s, phys, r, cap)
        rho_p, cp = compact.density_compact_plain(frame, pos_s, phys, r)
        hold_density(rho_k, rho_p, "compact_density", label)
        same_cert(ck, cp, "K5 density", label)
        if not substep:
            return
        rows = sk.pack_rows(pos_s, vel_s, rho_p)
        for _ in range(2):
            rows, _ = compact.compact_substep_cuda(frame, rows, phys, r, cap,
                                                   xs, al)
        cp = compact.spans_of(frame, rows[:, 0:3], r, True)[1]
        name = "compact_substep_ext" if ext else "compact_substep"
        out_k, ck = compact.compact_substep_cuda(frame, rows, phys, r, cap,
                                                 xs, al)
        ref = sk.substep_reference(frame, rows, phys, r, None, xs, al,
                                   compact.compact_sums_plain)
        line = must_pass(sk.hold(out_k, ref), f"K5 {name}", label)
        drift = same_cert(ck, cp, f"K5 {name}", label)
        e_s = max_err(out_k[:, :6], ref.p32)
        errs[name] = max(errs[name], e_s)
        print(f"compare {label}: {name} on substep 3 max|k-p| {e_s:.3e}, "
              f"{line}; drift count {drift} (plain {int(cp)})", flush=True)
        if forces:
            s_k, ck = compact.forces_compact_cuda(frame, rows, phys, r, cap)
            # the walk it does not choose, the same bits
            s_o, co = compact.forces_compact_cuda(
                frame, rows, phys, r, cap,
                own=not compact.own_lists(rows.shape[0], r))
            if not (same_bits(s_k, s_o) and int(ck) == int(co)):
                fail(f"{label}: K5 forces' two walks differ")
            f_k = sk.fold_forces(s_k, rows[:, 6], phys, fuse_acc=False)[0]
            ref_f = sk.forces_reference(frame, rows, phys, r, None,
                                        sums_fn=compact.compact_sums_plain)
            line = must_pass(sk.hold(f_k, ref_f), "K5 forces", label)
            drift = same_cert(ck, cp, "K5 forces", label)
            e_f = max_err(f_k, ref_f.p32)
            errs["compact_forces"] = max(errs["compact_forces"], e_f)
            print(f"compare {label}: compact_forces max|k-p| {e_f:.3e}, "
                  f"{line}; drift count {drift}", flush=True)
        if planted:
            no_visc = phys._replace(
                viscosity=torch.zeros_like(phys.viscosity))
            bad, _ = compact.compact_substep_cuda(frame, rows, no_visc, r,
                                                  cap, xs, al)
            must_fail(sk.hold(bad, ref),
                      "the K5 substep with viscosity 0", label)

    DEFAULT = SortedTuning()

    def hold_out(name, out, ref, label):
        """Holds ``out`` to ``ref`` (it must pass); the max |k - p32| joins
        kernel ``name``'s error; returns it and the rule's line."""
        line = must_pass(sk.hold(out, ref), name, label)
        n = ref.p32.shape[1]
        e = max_err(out[:, :n], ref.p32)
        errs[name] = max(errs[name], e)
        return e, line

    def compare(cfg, state, label, planted=False, tunes=(DEFAULT,)):
        """K1 and K2 against their plain versions (the faithful path), K2
        in each variant of ``tunes`` against the plain version of its own
        variant; with ``planted`` the default K2 with viscosity 0 must
        fail."""
        frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, state)
        _, rho_p = compare_density(frame, pos_s, phys, r, cap, label)
        rows = sk.pack_rows(pos_s, vel_s, rho_p)
        for tune in tunes:
            name = "fused_substep" + sk.variant_tag("fused_substep.cu", tune)
            ref = sk.substep_reference(frame, rows, phys, r, cap, tune=tune)
            out_k = sk.fused_substep_cuda(frame, rows, phys, r, cap,
                                          tune=tune)
            e_s, line = hold_out(name, out_k, ref, label)
            print(f"compare {label}: {name} max|k-p| {e_s:.3e}, {line}; "
                  f"overflow {int((~frame.occ).sum())}", flush=True)
            if planted and tune == DEFAULT:
                # the substep kernel without viscosity must fail the check,
                # or the check cannot see a viscosity fault
                no_visc = phys._replace(
                    viscosity=torch.zeros_like(phys.viscosity))
                must_fail(sk.hold(sk.fused_substep_cuda(frame, rows, no_visc,
                                                        r, cap), ref),
                          "the substep kernel with viscosity 0", label)
        return frame, rows, phys, r, cap

    def compare_ext(cfg, state, label, planted=False, tunes=(DEFAULT,)):
        """K1, K2-ext, K3 and K3 + integrate_substep at config 3, K2-ext
        and K3 in each variant of ``tunes`` against the plain version of
        its own variant; returns the frame's inputs and, for each variant,
        K2-ext's output and reference and K3's folded output and
        reference."""
        frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, state)
        rho_k, _ = compare_density(frame, pos_s, phys, r, cap, label)
        rows = sk.pack_rows(pos_s, vel_s, rho_k)
        accs = {}
        for tune in tunes:
            n2 = "fused_substep_ext" + sk.variant_tag("fused_substep.cu",
                                                      tune)
            n3 = "forces" + sk.variant_tag("forces.cu", tune)
            ref2 = sk.substep_reference(frame, rows, phys, r, cap, XSPH,
                                        ALPHA, tune=tune)
            k2 = sk.fused_substep_cuda(frame, rows, phys, r, cap, XSPH,
                                       ALPHA, tune=tune)
            e2, line2 = hold_out(n2, k2, ref2, label)
            ref3 = sk.forces_reference(frame, rows, phys, r, cap, XSPH,
                                       ALPHA, tune=tune)
            sums = sk.forces_cuda(frame, rows, phys, r, cap, True,
                                  tune=tune)
            f, dv = sk.fold_forces(sums, rows[:, 6], phys, XSPH, ALPHA,
                                   fuse_acc=tune.fuse_acc)
            e3, line3 = hold_out(n3, sk.forces_out(f, dv, XSPH), ref3,
                                 label)
            accs[tune] = (k2, ref2, sk.forces_out(f, dv, XSPH), ref3)
            pos_n, vel_n, nan = integrate_substep(rows[:, 0:3], rows[:, 3:6],
                                                  f, phys, dv)
            k3 = sk.pack_rows(pos_n, vel_n, rows[:, 6],
                              rows[:, 7] + nan.to(rows.dtype))
            line32 = must_pass(sk.hold(k3, ref2),
                               f"{n3} + integrate_substep", label)
            e32 = max_err(k3, k2)
            print(f"compare {label}: {n2} max|k-p| {e2:.3e}, {line2}; {n3} "
                  f"max|k-p| {e3:.3e}, {line3}; K3+integrate vs "
                  f"substep-ext max|diff| {e32:.3e}, {line32}; overflow "
                  f"{int((~frame.occ).sum())}", flush=True)
            if planted and tune == DEFAULT:
                must_fail(sk.hold(sk.fused_substep_cuda(
                    frame, rows, phys, r, cap, XSPH, 0.0), ref2),
                    "the substep kernel with the artificial viscosity 0",
                    label)
                f0, dv0 = sk.fold_forces(sums, rows[:, 6], phys, 0.0, ALPHA)
                must_fail(sk.hold(sk.forces_out(f0, dv0, XSPH), ref3),
                          "the forces kernel with XSPH 0", label)
        return frame, rows, phys, r, cap, accs

    def same_bits(a, b):
        """Bit for bit, NaN payloads included."""
        return a.shape == b.shape and a.dtype == b.dtype and bool(
            (a.view(torch.int32) == b.view(torch.int32)).all())

    def scene_inputs(cfg, overrides, states=None):
        """A batch's frame over the scene axis, its sorted positions and
        velocities, its stacked params (the spawn states when None)."""
        cfgs = [cfg.replace(**ov) for ov in overrides]
        if states is None:
            states = stack_states([initial_state(c, dev) for c in cfgs])
        params = stack_params([PhysParams.from_config(c, dev) for c in cfgs])
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        frame, (pos_s, vel_s) = build_frame_scenes(
            states.pos, r, cap, extras=(states.pos, states.vel))
        return frame, pos_s, vel_s, params, r, cap

    def compare_scenes(cfg, overrides, states, label, planted=False):
        """K1-scenes, given the density record as the stepper gives it,
        then K2-scenes (K2-ext-scenes with extensions) on the rows two
        substeps into the frame, given the frame record, against each
        scene's plain version (phase 3's rules) and bit-equal to each
        scene's solo launch and to the reference walk
        (``reference=True``), which is held to the plain version too;
        with ``planted`` K2-scenes with viscosity 0 (the artificial
        viscosity 0 with extensions) must fail scene 0's rule. Returns the
        frame, the positions, the frame-start rows, the rows two substeps
        in, the params, r and the capacity."""
        frame, pos_s, vel_s, params, r, cap = scene_inputs(cfg, overrides,
                                                           states)
        xs, al = cfg.xsph, cfg.artificial_viscosity
        ext = sk.uses_extensions(xs, al)
        name = "fused_substep_ext_scenes" if ext else "fused_substep_scenes"
        scal = sk.scal_blocks(params, xs, al)
        drec = sk.density_record_scenes(frame, pos_s)
        rho = sk.density_scenes_cuda(frame, pos_s, params, r, cap, scal,
                                     rec=drec)
        if not same_bits(rho, sk.density_scenes_cuda(
                frame, pos_s, params, r, cap, scal, reference=True)):
            fail(f"{label}: density_scenes leaves the reference walk")
        rows = rows0 = sk.pack_rows_scenes(pos_s, vel_s, rho)
        rec = sk.frame_record_scenes(frame, rho, params)
        for _ in range(2):
            rows = sk.fused_substep_scenes_cuda(frame, rows, params, r, cap,
                                                xs, al, scal=scal, rec=rec)
        out = sk.fused_substep_scenes_cuda(frame, rows, params, r, cap, xs,
                                           al, scal=scal, rec=rec)
        walk0 = sk.fused_substep_scenes_cuda(frame, rows, params, r, cap, xs,
                                             al, scal=scal, reference=True)
        if not same_bits(out, walk0):
            fail(f"{label}: {name} leaves the reference walk")
        refs = []
        for sc in range(pos_s.shape[0]):
            fs, ph = scene_frame(frame, sc), sk.scene_params(params, sc)
            lab = f"{label} scene {sc}"
            hold_density(rho[sc], sk.density_plain(fs, pos_s[sc], ph, r,
                                                   cap),
                         "density_scenes", lab)
            refs.append(sk.substep_reference(fs, rows[sc], ph, r, cap, xs,
                                             al))
            hold_out(name, walk0[sc], refs[-1], f"{lab}, reference walk")
            e, line = hold_out(name, out[sc], refs[-1], lab)
            solo = (same_bits(rho[sc], sk.density_cuda(
                        fs, pos_s[sc], ph, r, cap))
                    and same_bits(out[sc], sk.fused_substep_cuda(
                        fs, rows[sc], ph, r, cap, xs, al)))
            print(f"compare {lab}: {name} on substep 3 max|k-p| {e:.3e}, "
                  f"{line}; K1 and K2 bit-equal to the scene's solo "
                  f"launches {solo}, K1's and K2's record walks to their "
                  f"reference walks", flush=True)
            if not solo:
                fail(f"{lab}: a scene-axis kernel leaves the solo kernel")
        if planted:
            if ext:
                bad = sk.fused_substep_scenes_cuda(frame, rows, params, r,
                                                   cap, xs, 0.0, rec=rec)
                what = f"{name} with the artificial viscosity 0"
            else:
                bad = sk.fused_substep_scenes_cuda(
                    frame, rows, params._replace(
                        viscosity=torch.zeros_like(params.viscosity)),
                    r, cap, xs, al, rec=rec)
                what = f"{name} with viscosity 0"
            must_fail(sk.hold(bad[0], refs[0]), what, f"{label} scene 0")
        return frame, pos_s, rows0, rows, params, r, cap

    def held_scenes(n_sc):
        """The scenes whose launches are held to their plain versions: the
        two ends of a sweep (every scene is bit-equal to its solo launch,
        which phases 3 and 4b hold to its plain version)."""
        return sorted({0, n_sc - 1})

    def compare_scenes_forces(cfg, overrides, states, label, planted=False):
        """K3-scenes (K3-ext-scenes with extensions) on the rows two
        substeps into the frame, as the unfused route launches it (a
        spawn's velocities are 0), given the frame record: each scene's
        sums bit-equal to its solo launch and all of them to the reference
        walk's, and the ends of the sweep held to their plain versions
        (the solo rule); with ``planted`` the viscosity zeroed (XSPH 0 in
        the fold with extensions) must fail scene 0's rule."""
        frame, pos_s, vel_s, params, r, cap = scene_inputs(cfg, overrides,
                                                           states)
        xs, al = cfg.xsph, cfg.artificial_viscosity
        ext = sk.uses_extensions(xs, al)
        name = "forces_ext_scenes" if ext else "forces_scenes"
        scal = sk.scal_blocks(params)
        rho = sk.density_scenes_cuda(frame, pos_s, params, r, cap, scal)
        rows = sk.pack_rows_scenes(pos_s, vel_s, rho)
        rec = sk.frame_record_scenes(frame, rho, params)
        for _ in range(2):
            rows = sk.fused_substep_scenes_cuda(
                frame, rows, params, r, cap, xs, al,
                scal=sk.scal_blocks(params, xs, al), rec=rec)
        sums = sk.forces_scenes_cuda(frame, rows, params, r, cap, ext,
                                     scal=scal, rec=rec)
        if not same_bits(sums, sk.forces_scenes_cuda(
                frame, rows, params, r, cap, ext, scal=scal,
                reference=True)):
            fail(f"{label}: {name} leaves the reference walk")
        view = sk.scene_view(params)
        f, dv = sk.fold_forces(sums, rho, view, xs, al)
        n_sc = pos_s.shape[0]
        refs = {}
        for sc in range(n_sc):
            fs, ph = scene_frame(frame, sc), sk.scene_params(params, sc)
            lab = f"{label} scene {sc}"
            if not same_bits(sums[sc], sk.forces_cuda(fs, rows[sc], ph, r,
                                                      cap, ext)):
                fail(f"{lab}: K3-scenes leaves the solo K3")
            if sc not in held_scenes(n_sc):
                continue
            refs[sc] = sk.forces_reference(fs, rows[sc], ph, r, cap, xs, al)
            out = sk.forces_out(f[sc], None if dv is None else dv[sc], xs)
            e, line = hold_out(name, out, refs[sc], lab)
            print(f"compare {lab}: {name} max|k-p| {e:.3e}, {line}",
                  flush=True)
        print(f"compare {label}: {name}, each of the {n_sc} scenes "
              f"bit-equal to its solo K3 launch, the record walk to the "
              f"reference walk", flush=True)
        if planted:
            ph = sk.scene_params(params, 0)
            if ext:
                f0, dv0 = sk.fold_forces(sums[0], rho[0], ph, 0.0, al)
                what = f"{name} folded with XSPH 0"
            else:
                no_visc = params._replace(
                    viscosity=torch.zeros_like(params.viscosity))
                bad = sk.forces_scenes_cuda(
                    frame, rows, no_visc, r, cap, False,
                    scal=sk.scal_blocks(no_visc), rec=rec)
                f0, dv0 = sk.fold_forces(bad[0], rho[0], ph)
                what = f"{name} with viscosity 0"
            must_fail(sk.hold(sk.forces_out(f0, dv0, xs), refs[0]), what,
                      f"{label} scene 0")

    def compare_scenes_k5(cfg, overrides, states, label, planted=False):
        """K5-scenes: density on the frame, then the fused substep (K5-ext
        with extensions) and, without extensions, the forces on the rows
        two substeps into the frame; each scene's output and drift count
        bit-equal to its solo launch's, each drift count equal to its plain
        version's, and scene 0 held to its plain versions (the solo rules;
        K5's plain version takes seconds a scene); with ``planted`` the
        substep with viscosity 0 must fail scene 0's rule."""
        frame, pos_s, vel_s, params, r, cap = scene_inputs(cfg, overrides,
                                                           states)
        xs, al = cfg.xsph, cfg.artificial_viscosity
        ext = sk.uses_extensions(xs, al)
        name = "compact_substep_ext_scenes" if ext else \
            "compact_substep_scenes"
        rho, c0 = compact.density_compact_scenes_cuda(frame, pos_s, params, r,
                                                      cap)
        rows = sk.pack_rows_scenes(pos_s, vel_s, rho)
        pj = sk.pj_cols_scenes(rho, params)
        scal = sk.scal_blocks(params, xs, al)
        for _ in range(2):
            rows, _ = compact.compact_substep_scenes_cuda(
                frame, rows, params, r, cap, xs, al, pj, scal)
        out, cs = compact.compact_substep_scenes_cuda(frame, rows, params, r,
                                                      cap, xs, al, pj, scal)
        if not ext:
            sums, cf = compact.forces_compact_scenes_cuda(
                frame, rows, params, r, cap, pj, sk.scal_blocks(params))
        n_sc = pos_s.shape[0]
        refs = {}
        for sc in range(n_sc):
            fs, ph = scene_frame(frame, sc), sk.scene_params(params, sc)
            lab = f"{label} scene {sc}"
            d1, c1 = compact.density_compact_cuda(fs, pos_s[sc], ph, r, cap)
            o1, k1 = compact.compact_substep_cuda(fs, rows[sc], ph, r, cap,
                                                  xs, al)
            solo = (same_bits(rho[sc], d1) and int(c0[sc]) == int(c1)
                    and same_bits(out[sc], o1) and int(cs[sc]) == int(k1))
            if not ext:
                s1, f1 = compact.forces_compact_cuda(fs, rows[sc], ph, r,
                                                     cap)
                solo = solo and same_bits(sums[sc], s1) and \
                    int(cf[sc]) == int(f1)
            if not solo:
                fail(f"{lab}: a K5-scenes launch leaves the solo K5")
            cp = compact.spans_of(fs, rows[sc, :, 0:3], r, True)[1]
            drift = same_cert(cs[sc], cp, name, lab)
            if not ext:
                same_cert(cf[sc], cp, "compact_forces_scenes", lab)
            if sc != 0:
                continue
            hold_density(rho[sc], compact.density_compact_plain(
                fs, pos_s[sc], ph, r)[0], "compact_density_scenes", lab)
            refs[sc] = sk.substep_reference(fs, rows[sc], ph, r, None, xs,
                                            al, compact.compact_sums_plain)
            e, line = hold_out(name, out[sc], refs[sc], lab)
            print(f"compare {lab}: {name} on substep 3 max|k-p| {e:.3e}, "
                  f"{line}; drift count {drift}", flush=True)
            if not ext:
                ref_f = sk.forces_reference(
                    fs, rows[sc], ph, r, None,
                    sums_fn=compact.compact_sums_plain)
                f_k = sk.fold_forces(sums[sc], rows[sc, :, 6], ph,
                                     fuse_acc=False)[0]
                e, line = hold_out("compact_forces_scenes", f_k, ref_f, lab)
                print(f"compare {lab}: compact_forces_scenes max|k-p| "
                      f"{e:.3e}, {line}", flush=True)
        print(f"compare {label}: K5-scenes, each of the {n_sc} scenes "
              f"bit-equal to its solo launches; drift counts "
              f"{cs.tolist()}", flush=True)
        if planted:
            bad, _ = compact.compact_substep_scenes_cuda(
                frame, rows, params._replace(
                    viscosity=torch.zeros_like(params.viscosity)),
                r, cap, xs, al, pj)
            must_fail(sk.hold(bad[0], refs[0]), f"{name} with viscosity 0",
                      f"{label} scene 0")

    # ---- 3. compare at frame 0 (out-of-cube spawns)
    with Phase("compare frame 0"):
        states = {k: initial_state(c, dev) for k, c in sizes.items()}
        for k, cfg in sizes.items():
            compare(cfg, states[k], f"{k} frame 0")
        c3_state = initial_state(c3, dev)
        compare_ext(c3, c3_state, "config 3 frame 0")
    with Phase("compare K5 frame 0"):
        for k, cfg in sizes.items():
            # the 1M substep is held at frame 10 (its plain version takes
            # 13 s a call)
            compare_k5(cfg, states[k], f"{k} frame 0", forces=k == "262k",
                       substep=k != "1m")
        compare_k5(c3, c3_state, "config 3 frame 0")
    with Phase("compare scene axis frame 0"):
        compare_scenes(c5, c5_ov, None, "config 5 frame 0")
        c3b_in = compare_scenes(c3b, c3b_ov, None, "config 3 batch frame 0",
                                planted=True)
    with Phase("compare K3-scenes and K5-scenes frame 0"):
        compare_scenes_forces(c5, c5_ov, None, "config 5 frame 0",
                              planted=True)
        compare_scenes_forces(c3b, c3b_ov, None, "config 3 batch frame 0",
                              planted=True)
        compare_scenes_k5(c5, c5_ov, None, "config 5 frame 0", planted=True)
        compare_scenes_k5(c3b, c3b_ov, None, "config 3 batch frame 0")
    states0 = dict(states)

    # ---- 4. main paths, each after an untimed first call of its rollout
    # (the first launch of each torch kernel loads its module, and the first
    # call records the graph; that is set-up time)
    launches_total = dict.fromkeys(KERNELS, 0)

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    def read_launches(label, want):
        """The counters since the last reset, which must be ``want``'s
        nonzero entries exactly; added to the kernels' totals."""
        launches = nonzero(sk.launch_counts)
        print(f"launches in {label}: {launches}", flush=True)
        if launches != nonzero(want):
            fail(f"{label}: launch counts {launches}, expected "
                 f"{nonzero(want)}")
        for name, c in launches.items():
            launches_total[name] += c

    def run_path(label, rolls, inputs, want, cfgs, exact=True,
                 frames=FRAMES):
        # a first call of each rollout, untimed and uncounted: it builds the
        # kernels, loads their modules and records the sorted tier's graph
        for k, roll in rolls.items():
            roll(inputs[k])
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        results = {}
        for k, roll in rolls.items():
            t0 = time.perf_counter()
            final, m = roll(inputs[k])
            torch.cuda.synchronize()
            results[k] = (final, m, time.perf_counter() - t0)
        read_launches(label, want)
        for k, (final, m, dt) in results.items():
            cfg = cfgs[k]
            pos = final.pos
            cert = int(m.exact_cert.sum())
            # a row past its tile's band loses candidates on the compact
            # route (the JAX semantics, counted by exact_cert): on the
            # golden EOS its acceleration can then be -inf where the full
            # set gives NaN, the NaN trap does not fire, and v = inf - inf
            # is NaN. Only there may a position be non-finite.
            bad = int((~torch.isfinite(pos)).any(1).sum())
            if bad and (exact or cert == 0):
                fail(f"{k}: {bad} rows with non-finite positions")
            fin = torch.isfinite(pos)
            if not bool(((pos[fin] >= 0) & (pos[fin] <= 1)).all()):
                fail(f"{k}: positions outside [0, 1]")
            if exact and cert != 0:
                fail(f"{k}: exact_cert {cert}")
            rate = cfg.n_particles * cfg.substeps * frames / dt
            print(f"rollout {k}: N={cfg.n_particles} "
                  f"R={cfg.bucket_resolution} {frames} frames in {dt:.4f} s "
                  f"= {rate:.6g} particle-substeps/s; exact_cert "
                  f"{cert} {m.exact_cert.tolist()}; non-finite position "
                  f"rows {bad}; overflow per frame "
                  f"{m.overflow.tolist()}; nan_events "
                  f"{int(m.nan_events.sum())}; max_speed per frame "
                  f"{[float(f'{x:.4g}') for x in m.max_speed.tolist()]} "
                  f"[{ident}]", flush=True)
        return {k: v[0] for k, v in results.items()}

    zero = dict.fromkeys(sk.launch_counts, 0)
    with Phase("faithful rollouts 262k, 1m"):
        rolls = {k: make_rollout(c, FRAMES, device=dev)
                 for k, c in sizes.items()}
        states = run_path(
            "the faithful path", rolls, states,
            dict(zero, density=FRAMES * len(sizes),
                 fused_substep=FRAMES * len(sizes) * 5), sizes)
    c3_modes = {"config 3 faithful": True, "config 3 corrected": False}
    c3_states = {}
    for k, faithful in c3_modes.items():
        with Phase(f"rollout {k}"):
            roll = make_rollout(c3, FRAMES, faithful=faithful, device=dev)
            want = (dict(zero, density=FRAMES, fused_substep_ext=FRAMES * 5)
                    if faithful else
                    dict(zero, density=FRAMES * 6, forces=FRAMES * 5))
            c3_states.update(run_path(f"the {k} path", {k: roll},
                                      {k: c3_state}, want, {k: c3}))

    # config 5 over the scene axis: BatchedScenes, a replayed graph a frame
    # (1 K1-scenes, 1 frame record + 5 K2-scenes), after a first frame
    # that records it.
    # The golden EOS may leave a row non-finite at exact_cert 0 (the
    # reference's own inf - inf, which phase 12 replays through the plain
    # versions over frames 1-4): counted here; a finite position must lie
    # in [0, 1]
    with Phase("rollout config 5 batch"):
        bs = BatchedScenes(c5, c5_ov, devices=dev)
        bs.step()
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        bs.step(FRAMES)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        read_launches("the config 5 batch path", dict(
            zero, density_scenes=FRAMES, frame_record=FRAMES,
            fused_substep_scenes=5 * FRAMES))
        c5_states, m = bs.states, bs.last_metrics
        del bs
        pos = c5_states.pos
        fin = torch.isfinite(pos).all(2)
        if not bool(((pos[fin] >= 0) & (pos[fin] <= 1)).all()):
            fail("config 5 batch: positions outside [0, 1]")
        print(f"rollout config 5 batch: {C5_SCENES} scenes x "
              f"{c5.n_particles} particles, frames 2-{FRAMES + 1} in "
              f"{dt:.4f} s = "
              f"{C5_SCENES * c5.n_particles * c5.substeps * FRAMES / dt:.6g}"
              f" particle-substeps/s aggregate; non-finite position rows "
              f"per scene {(~fin).sum(1).tolist()}; exact_cert "
              f"{m.exact_cert.tolist()}; overflow {m.overflow.tolist()} "
              f"[{ident}]", flush=True)

    # the compact route (K5)
    with Phase("compact rollouts 262k, 1m"):
        rolls = {k: make_rollout(c, FRAMES, tune=k5, device=dev)
                 for k, c in sizes.items()}
        k5_states = run_path(
            "the compact faithful path", rolls, states0,
            dict(zero, compact_density=FRAMES * len(sizes),
                 compact_substep=FRAMES * len(sizes) * 5), sizes,
            exact=False)
    k5_paths = {"config 3 faithful, compact": (c3, True, dict(
                    zero, compact_density=FRAMES,
                    compact_substep_ext=FRAMES * 5)),
                "262k corrected, compact": (sizes["262k"], False, dict(
                    zero, compact_density=FRAMES * 6,
                    compact_forces=FRAMES * 5))}
    for k, (cfg, faithful, want) in k5_paths.items():
        with Phase(f"rollout {k}"):
            st0 = c3_state if cfg is c3 else states0["262k"]
            roll = make_rollout(cfg, FRAMES, faithful=faithful, tune=k5,
                                device=dev)
            k5_states.update(run_path(f"the {k} path", {k: roll}, {k: st0},
                                      want, {k: cfg}, exact=False))

    # ---- 4b. compare again after 10 frames, with the planted controls
    with Phase(f"compare frame {FRAMES}"):
        for k, cfg in sizes.items():
            compare(cfg, states[k], f"{k} frame {FRAMES}", planted=True)
        compare_ext(c3, c3_states["config 3 faithful"],
                    f"config 3 frame {FRAMES}", planted=True)
    with Phase(f"compare scene axis frame {FRAMES + 1}"):
        c5_in = compare_scenes(c5, c5_ov, c5_states,
                               f"config 5 frame {FRAMES + 1}", planted=True)
    with Phase(f"compare K5 frame {FRAMES}"):
        for k, cfg in sizes.items():
            compare_k5(cfg, k5_states[k], f"{k} frame {FRAMES}",
                       forces=k == "262k", planted=k == "262k")
        compare_k5(c3, k5_states["config 3 faithful, compact"],
                   f"config 3 frame {FRAMES}")

    # ---- 5. references on the card
    with Phase("references"):
        data = os.path.join(root, "tests", "data", "golden_dambreak_1k.npz")
        with np.load(data) as z:
            g1, g5 = z["pos_1"], z["pos_5"]
        gcfg = SimConfig(particle_number=1024, bucket_resolution=11,
                         preset=1)
        s1, _ = make_rollout(gcfg, 1, device=dev)(initial_state(gcfg, dev))
        s5, _ = make_rollout(gcfg, 4, device=dev)(s1)
        err1 = float(np.abs(s1.pos.cpu().numpy() - g1).max())
        rmse5 = float(np.sqrt(np.mean((s5.pos.cpu().numpy() - g5) ** 2)))
        print(f"golden 1k: frame-1 max err {err1:.3e} (< 1e-5), frame-5 "
              f"RMSE {rmse5:.3e} (< 1e-3)", flush=True)
        if not (err1 < 1e-5 and rmse5 < 1e-3):
            fail("golden 1k trajectory off")
        # calm physics (tests/test_pallas.py:18-21) with both extensions
        calm = SimConfig(particle_number=1024, bucket_resolution=11,
                         preset=0, gas_constant=20.0, rest_density=1.7,
                         viscosity=0.05, stiffness_coefficient=1000.0,
                         frame_dt=1 / 240, xsph=0.3, artificial_viscosity=0.4)
        s0 = initial_state(calm, dev)
        for faithful in (True, False):
            a, ma = make_rollout(calm, 3, faithful=faithful, device=dev)(s0)
            b, mb = make_rollout(calm, 3, neighbor="brute", faithful=faithful,
                                 device=dev)(s0)
            e = float((a.pos - b.pos).abs().max())
            print(f"calm 1k with extensions, faithful={faithful}: sorted vs "
                  f"brute max |dpos| {e:.3e} over 3 frames (< "
                  f"{ORACLE_ATOL:g}); overflow {ma.overflow.tolist()} vs "
                  f"{mb.overflow.tolist()}", flush=True)
            if not e < ORACLE_ATOL or not torch.equal(ma.overflow,
                                                      mb.overflow):
                fail(f"the sorted tier leaves the brute oracle "
                     f"(faithful={faithful})")

    # ---- 6. the CLI, in-process, at config 3
    with Phase("cli"):
        argv = ["run", "--device", "cuda", "--particles", "524288",
                "--preset", "2", "--xsph", str(XSPH), "--alpha-visc",
                str(ALPHA), "--frames", "3"]
        # the route and the variant from the SPH_PALLAS_* variables, as the
        # JAX CLI's users set them
        for extra, env, want in (
                ([], {}, dict(density=3, fused_substep_ext=15)),
                (["--corrected"], {}, dict(density=18, forces=15)),
                ([], {"SPH_PALLAS_COMPACT": "1"},
                 dict(compact_density=3, compact_substep_ext=15)),
                ([], {"SPH_PALLAS_FUSED": "0"}, dict(density=3, forces=15)),
                ([], {"SPH_PALLAS_KAHAN": "1"},
                 {"density+kahan": 3, "frame_record": 3,
                  "fused_substep_ext+kahan": 15}),
                (["--corrected"], {"SPH_PALLAS_BF16": "1"},
                 {"density": 18, "forces+bf16": 15,
                  "bf16_candidates": 15})):
            os.environ.update(env)
            sk.reset_launch_counts()
            rc = cli.main(argv + extra)
            for var in env:
                del os.environ[var]
            label = f"cli {env or 'default'} {' '.join(argv + extra)}"
            print(f"{label}: exit {rc}", flush=True)
            if rc != 0:
                fail(f"{label} exits {rc}")
            read_launches(label, want)

    # ---- 7. timing, kernel vs plain vs bound, at each path's frame-10
    # state of the K1-K3 route; K5 at the same states
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        with CudaTimer(LEAD_CYCLES) as t:
            for _ in range(reps):
                fn()
        return t.ms / reps

    def plain_ms(plain):
        """A plain version's time: one call, and a call under a second
        warmed and timed again (the longest take tens of seconds a call)."""
        torch.cuda.synchronize()
        with CudaTimer(LEAD_CYCLES) as t:
            plain()
        return t.ms if t.ms > 1000.0 else time_ms(plain, 1)

    times = {}      # name → {shape: (ms, plain ms, bound ms, bound by)}

    def record_copies(frame, rho, n_rows):
        """(frame, ρ) and copies of its raw, occ and ρ, cycled: a timed
        loop of the frame record's pass over them moves twice the card's
        L2 between two reads of one copy, so its reads come from device
        memory, as its bound counts them."""
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        k = -(-2 * l2 // (n_rows * RECORD_ROW_BYTES))
        return cycle([(frame, rho)] + [
            (frame._replace(raw=frame.raw.clone(), occ=frame.occ.clone()),
             rho.clone()) for _ in range(k)])

    def timed(name, shape, n, r, pairs, ext, fn, plain, **band):
        """Times fn beside its plain version and bound; a K5 substep's fn
        is a function of the split threshold (called with its default),
        also timed with every tile whole. ``plain`` is the plain version,
        or its time in ms where it was timed already. At 1M, no kernel's
        main shape, the plain versions are not timed (None): the 1M K5
        substep's alone takes 13-21 s a run (PERF.md)."""
        km = time_ms(fn, 20)
        pm = (None if shape == "1m" else plain if isinstance(plain, float)
              else plain_ms(plain))
        b_ms, b_by = bound(name, n, r, pairs, ext, **band)
        times.setdefault(name, {})[shape] = (km, pm, b_ms, b_by)
        whole = ""
        if name.startswith("compact_substep") or \
                name == "compact_density_band":
            # K5's substep and banded density beside their body before the
            # split ("_whole")
            wm = time_ms(lambda: fn(0), 20)
            times[name][f"{shape}_whole"] = (wm, pm, b_ms, b_by)
            whole = (f"; one warp a tile {wm:.4f} ms = {100 * b_ms / wm:.2f}%"
                     f", split/whole {km / wm:.4f}")
        plain_text = "not timed" if pm is None else f"{pm:.4f} ms"
        print(f"time {shape} {name}: kernel {km:.4f} ms, plain {plain_text}, "
              f"bound {b_ms:.5f} ms ({b_by}, {pairs} member pairs) = "
              f"{100 * b_ms / km:.2f}% of the bound{whole} [{ident}]",
              flush=True)

    def occ_prefix_ms(label, occ):
        """The split's count of occupied slots (``compact.occ_prefix``),
        which the path computes once a frame."""
        ms = time_ms(lambda: compact.occ_prefix(occ), 20)
        print(f"occ_prefix {label}: {ms:.4f} ms once a frame [{ident}]",
              flush=True)

    with Phase("timing"):
        shapes = {"262k": (sizes["262k"], states["262k"]),
                  "1m": (sizes["1m"], states["1m"]),
                  "c3": (c3, c3_states["config 3 faithful"])}
        for shape, (cfg, st) in shapes.items():
            frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, st)
            n = pos_s.shape[0]
            xs, al = cfg.xsph, cfg.artificial_viscosity
            ext = sk.uses_extensions(xs, al)
            rows = sk.pack_rows(pos_s, vel_s,
                                sk.density_cuda(frame, pos_s, phys, r, cap))
            # the fused substeps run on rows two substeps into the frame:
            # K5's tile spans widen within a frame (a row that steps into
            # the next z-plane stretches its tile's span over R² cells),
            # so frame-start rows understate it; the density and the
            # forces of the corrected mode always see frame-start rows
            mid = rows
            for _ in range(2):
                mid = sk.fused_substep_cuda(frame, mid, phys, r, cap, xs, al)
            # each launch's inputs, built before its timing: the scalar
            # blocks and the force modes' pj (pj is of the frame-start ρ,
            # which mid keeps)
            scal, scal_f = sk.scal_block(phys), sk.scal_block(phys, xs, al)
            pj = sk.pj_cols(rows[:, 6], phys)
            tot, own = sk.member_pairs(frame, pos_s, r, cap)
            m_tot, m_own = sk.member_pairs(frame, mid[:, 0:3], r, cap)
            ctot, _ = compact.member_pairs(frame, pos_s, r, fresh=False)
            ftot, fown = compact.member_pairs(frame, pos_s, r, fresh=True)
            k_tot, k_own = compact.member_pairs(frame, mid[:, 0:3], r,
                                                fresh=True)
            print(f"member pairs {shape}: frame start, window route {tot} "
                  f"({own} self, {tot / n:.2f} a particle), K5 density "
                  f"{ctot}, K5 forces {ftot} ({fown} self); substep 3, "
                  f"window route {m_tot} ({m_own} self), K5 {k_tot} "
                  f"({k_own} self)", flush=True)
            for when, p in (("frame start", pos_s), ("substep 3", mid)):
                spans, _ = compact.fresh_spans(compact.stale_spans(frame),
                                               p[:, 0:3], r)
                union, streamed = (float(compact.stream_slots(
                    spans, frame.start, r, c).double().mean())
                    for c in (None, cap))
                ca, cb = compact.tile_cells(spans, r)
                cells = float((cb - ca).sum(1).double().mean())
                print(f"K5 stream {shape} {when}: {streamed:.1f} slots a "
                      f"tile streamed (each union cell cut at the capacity "
                      f"{cap}), of a union of {union:.1f} slots in "
                      f"{cells:.1f} cells a tile, on average", flush=True)
            if not ext:
                timed("density", shape, n, r, tot, False,
                      lambda: sk.density_cuda(frame, pos_s, phys, r, cap,
                                              scal),
                      lambda: sk.density_plain(frame, pos_s, phys, r, cap))
                timed("compact_density", shape, n, r, ctot, False,
                      lambda: compact.density_compact_cuda(frame, pos_s,
                                                           phys, r, cap,
                                                           scal),
                      lambda: compact.density_compact_plain(frame, pos_s,
                                                            phys, r))
            fused, k5_fused = (("fused_substep_ext", "compact_substep_ext")
                               if ext else
                               ("fused_substep", "compact_substep"))
            timed(fused, shape, n, r, m_tot - m_own, ext,
                  lambda: sk.fused_substep_cuda(frame, mid, phys, r, cap,
                                                xs, al, pj, scal_f),
                  lambda: sk.fused_substep_plain(frame, mid, phys, r, cap,
                                                 xs, al))
            occ = compact.occ_prefix(frame.occ)
            occ_prefix_ms(shape, frame.occ)
            timed(k5_fused, shape, n, r, k_tot - k_own, ext,
                  lambda sp=compact.SPLIT_SLOTS: compact.compact_substep_cuda(
                      frame, mid, phys, r, cap, xs, al, pj, scal_f,
                      occ_cum=occ, split=sp),
                  lambda: compact.compact_substep_plain(frame, mid, phys, r,
                                                        xs, al))
            if shape == "262k":
                # the spawn's first substep, where no tile may pass the
                # threshold: the split's check beside the whole-tile body
                f0, p0, v0, _, _, _ = frame_inputs(cfg, initial_state(cfg,
                                                                      dev))
                r0 = sk.pack_rows(p0, v0, sk.density_cuda(f0, p0, phys, r,
                                                          cap))
                pj0, occ0 = sk.pj_cols(r0[:, 6], phys), compact.occ_prefix(
                    f0.occ)
                tot0, own0 = compact.member_pairs(f0, p0, r, fresh=True)
                timed(k5_fused, f"{shape}_f0", n, r, tot0 - own0, ext,
                      lambda sp=compact.SPLIT_SLOTS:
                      compact.compact_substep_cuda(
                          f0, r0, phys, r, cap, xs, al, pj0, scal_f,
                          occ_cum=occ0, split=sp),
                      lambda: compact.compact_substep_plain(f0, r0, phys, r,
                                                            xs, al))
            if ext:
                timed("forces", shape, n, r, tot - own, True,
                      lambda: sk.forces_cuda(frame, rows, phys, r, cap,
                                             True, pj, scal),
                      lambda: sk.forces_plain(frame, rows, phys, r, cap,
                                              ext=True))
            if shape == "262k":
                # K5's forces instance has no extensions: K3's beside it
                timed("forces", "262k_no_ext", n, r, tot - own, False,
                      lambda: sk.forces_cuda(frame, rows, phys, r, cap,
                                             False, pj, scal),
                      lambda: sk.forces_plain(frame, rows, phys, r, cap))
                timed("compact_forces", shape, n, r, ftot - fown, False,
                      lambda: compact.forces_compact_cuda(frame, rows, phys,
                                                          r, cap, pj, scal),
                      lambda: compact.forces_compact_plain(frame, rows,
                                                           phys, r))
                # the walk it does not choose on the same inputs (every
                # lane through the round's list, "_list")
                timed("compact_forces", f"{shape}_list", n, r,
                      ftot - fown, False,
                      lambda: compact.forces_compact_cuda(
                          frame, rows, phys, r, cap, pj, scal, own=False),
                      times["compact_forces"][shape][1])
        # the scene-axis instances: K1-scenes on config 5's frame-11
        # frame, K2-scenes on its rows two substeps in; K2-ext-scenes on
        # the config-3 batch's, frame 0 (compare_scenes' inputs); each
        # plain version is the solo plain version scene by scene
        for shape, (frame, pos_s, rows0, mid, params, r, cap), cfg in (
                ("c5", c5_in, c5), ("c3x2", c3b_in, c3b)):
            n_sc, n = pos_s.shape[:2]
            xs, al = cfg.xsph, cfg.artificial_viscosity
            ext = sk.uses_extensions(xs, al)
            scal = sk.scal_blocks(params, xs, al)
            pj = sk.pj_cols_scenes(mid[..., 6], params)
            rec = sk.frame_record_scenes(frame, mid[..., 6], params)
            win0 = [sk.member_pairs(scene_frame(frame, sc), pos_s[sc], r,
                                    cap) for sc in range(n_sc)]
            tot, f0 = sum(t for t, _ in win0), sum(t - o for t, o in win0)
            m_tot = sum(t - o for t, o in (
                sk.member_pairs(scene_frame(frame, sc), mid[sc, :, 0:3], r,
                                cap) for sc in range(n_sc)))
            print(f"member pairs {shape}, {n_sc} scenes: frame start "
                  f"{tot} ({tot / (n_sc * n):.2f} a particle), substep 3 "
                  f"{m_tot} without the self pairs", flush=True)
            if not ext:
                # K1-scenes given the density record as the stepper builds
                # it; the record's build
                drec = sk.density_record_scenes(frame, pos_s)
                timed("density_scenes", shape, n_sc * n, r, tot, False,
                      lambda: sk.density_scenes_cuda(frame, pos_s, params,
                                                     r, cap, scal, rec=drec),
                      lambda: sk.density_scenes_plain(frame, pos_s, params,
                                                      r, cap),
                      scenes=n_sc)
                build = time_ms(lambda: sk.density_record_scenes(frame,
                                                                 pos_s), 20)
                print(f"time {shape}: the density record's build "
                      f"{build:.4f} ms, once a K1-scenes launch [{ident}]",
                      flush=True)
                # the frame record's pass over the scenes, on copies of its
                # inputs cycled past the L2
                copies = record_copies(frame, mid[..., 6].contiguous(),
                                       n_sc * n)
                timed("frame_record", shape, n_sc * n, r, 0, False,
                      lambda: sk.frame_record_scenes(*next(copies), params),
                      lambda: sk.frame_record_scenes_plain(
                          frame, mid[..., 6], params), scenes=n_sc)
                del copies
            k2_name = ("fused_substep_ext_scenes" if ext
                       else "fused_substep_scenes")
            timed(k2_name, shape, n_sc * n, r, m_tot, ext,
                  lambda: sk.fused_substep_scenes_cuda(
                      frame, mid, params, r, cap, xs, al, scal=scal,
                      rec=rec),
                  lambda: sk.fused_substep_scenes_plain(
                      frame, mid, params, r, cap, xs, al),
                  scenes=n_sc)
            # the solo kernels on the same inputs, one launch a scene, as
            # the batch ran before the scene axis (not a main path's count)
            solo = [(scene_frame(frame, sc), sk.scene_params(params, sc))
                    for sc in range(n_sc)]
            blocks = [sk.scal_block(ph, xs, al) for _, ph in solo]
            k1 = (float("nan") if ext else time_ms(lambda: [
                sk.density_cuda(fs, pos_s[sc], ph, r, cap, blocks[sc])
                for sc, (fs, ph) in enumerate(solo)], 20))
            k2 = time_ms(lambda: [
                sk.fused_substep_cuda(fs, mid[sc], ph, r, cap, xs, al,
                                      pj[sc], blocks[sc])
                for sc, (fs, ph) in enumerate(solo)], 20)
            print(f"time {shape}: the solo kernels on the same inputs, "
                  f"{n_sc} launches each: K1 {k1:.4f} ms, "
                  f"{'K2-ext' if ext else 'K2'} {k2:.4f} ms [{ident}]",
                  flush=True)
            # K3-scenes and K5-scenes on the same inputs: the forces of
            # both (the corrected mode's) on the frame-start rows, K5
            # density on the frame, the K5 substep on the rows two
            # substeps in; beside them the solo kernels, one launch a
            # scene. At the frame start no row has left its tile's band,
            # so K5's member pairs there are K1's (tot, f0 without the
            # self pairs); two substeps in they are counted
            scal_f = sk.scal_blocks(params)
            k5_mid = sum(t - o for t, o in (
                compact.member_pairs(fs, mid[sc, :, 0:3], r, True)
                for sc, (fs, _) in enumerate(solo)))
            print(f"K5 member pairs {shape}, {n_sc} scenes: substep 3 "
                  f"{k5_mid} without the self pairs", flush=True)
            k3_name = "forces_ext_scenes" if ext else "forces_scenes"
            timed(k3_name, shape, n_sc * n, r, f0, ext,
                  lambda: sk.forces_scenes_cuda(frame, rows0, params, r, cap,
                                                ext, scal=scal_f, rec=rec),
                  lambda: sk.forces_scenes_plain(frame, rows0, params, r,
                                                 cap, ext),
                  scenes=n_sc)
            occ = compact.occ_prefix(frame.occ)
            occ_prefix_ms(f"{shape}, {n_sc} scenes", frame.occ)
            timed("compact_substep_ext_scenes" if ext
                  else "compact_substep_scenes", shape, n_sc * n, r, k5_mid,
                  ext,
                  lambda sp=compact.SPLIT_SLOTS:
                  compact.compact_substep_scenes_cuda(
                      frame, mid, params, r, cap, xs, al, pj, scal,
                      occ_cum=occ, split=sp),
                  lambda: compact.compact_substep_scenes_plain(
                      frame, mid, params, r, xs, al),
                  scenes=n_sc)
            occ_solo = [compact.occ_prefix(fs.occ) for fs, _ in solo]
            solo_ms = {"K3": time_ms(lambda: [
                sk.forces_cuda(fs, rows0[sc], ph, r, cap, ext, pj[sc],
                               blocks[sc])
                for sc, (fs, ph) in enumerate(solo)], 20),
                "K5 substep": time_ms(lambda: [
                    compact.compact_substep_cuda(fs, mid[sc], ph, r, cap, xs,
                                                 al, pj[sc], blocks[sc],
                                                 occ_cum=occ_solo[sc])
                    for sc, (fs, ph) in enumerate(solo)], 20)}
            if not ext:
                timed("compact_density_scenes", shape, n_sc * n, r, tot,
                      False,
                      lambda: compact.density_compact_scenes_cuda(
                          frame, pos_s, params, r, cap, scal),
                      lambda: compact.density_compact_scenes_plain(
                          frame, pos_s, params, r),
                      scenes=n_sc)
                timed("compact_forces_scenes", shape, n_sc * n, r, f0,
                      False,
                      lambda: compact.forces_compact_scenes_cuda(
                          frame, rows0, params, r, cap, pj, scal),
                      lambda: compact.forces_compact_scenes_plain(
                          frame, rows0, params, r),
                      scenes=n_sc)
                if shape == "c5":
                    # the walk it does not choose at about 5 rows a cell
                    # (each lane its own slots, "_own")
                    timed("compact_forces_scenes", f"{shape}_own",
                          n_sc * n, r, f0, False,
                          lambda: compact.forces_compact_scenes_cuda(
                              frame, rows0, params, r, cap, pj, scal,
                              own=True),
                          times["compact_forces_scenes"][shape][1],
                          scenes=n_sc)
                solo_ms["K5 density"] = time_ms(lambda: [
                    compact.density_compact_cuda(fs, pos_s[sc], ph, r, cap,
                                                 blocks[sc])
                    for sc, (fs, ph) in enumerate(solo)], 20)
                solo_ms["K5 forces"] = time_ms(lambda: [
                    compact.forces_compact_cuda(fs, rows0[sc], ph, r, cap,
                                                pj[sc], blocks[sc])
                    for sc, (fs, ph) in enumerate(solo)], 20)
            print(f"time {shape}: the solo kernels on the same inputs, "
                  f"{n_sc} launches each: "
                  f"{', '.join(f'{k} {v:.4f} ms' for k, v in solo_ms.items())}"
                  f" [{ident}]", flush=True)

    # ---- 8. the slab step on LocalRing(4), one card
    from sphfluidsimulation_torch.parallel import (LocalRing, collect,
                                                   distribute,
                                                   make_pallas_slab_step)
    from sphfluidsimulation_torch.parallel.slab_pallas import shard_frames

    ring = LocalRing(SLAB_D)
    slab_cfgs = {"262k": (sizes["262k"], states0["262k"]),
                 "c3": (c3, c3_state)}

    def slab_setup(cfg, d=SLAB_D):
        step, spec = make_pallas_slab_step(cfg, LocalRing(d),
                                           row_slack=SLAB_SLACK,
                                           halo_slack=SLAB_HALO)
        print(f"slab spec, {cfg.n_particles} particles: {spec._asdict()}, "
              f"c_loc {spec.c_loc}", flush=True)
        return step, spec, PhysParams.from_config(cfg, dev)

    def compare_slab(cfg, spec, sst, label, planted=False):
        """K1-band and K2-band (K2-ext-band with extensions) against their
        banded plain versions on each shard's frame of ``sst``."""
        phys = PhysParams.from_config(cfg, dev)
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        xs, al = cfg.xsph, cfg.artificial_viscosity
        name = ("fused_substep_ext_band" if sk.uses_extensions(xs, al)
                else "fused_substep_band")
        sfs = shard_frames(cfg, spec, ring, sst)
        live = [int(sf.frame.start[-1]) for sf in sfs]
        for k, sf in enumerate(sfs):
            lab, band = f"{label}, shard {k}", sf.band
            rho_k = sk.density_cuda(sf.frame, sf.pos_s, phys, r, cap,
                                    band=band)
            rho_p = sk.density_plain(sf.frame, sf.pos_s, phys, r, cap, band)
            hold_density(rho_k, rho_p, "density_band", lab)
            rows = sk.pack_rows(sf.pos_s, sf.vel_s, rho_p)
            out = sk.fused_substep_cuda(sf.frame, rows, phys, r, cap, xs, al,
                                        band=band)
            line = must_pass(sk.substep_accuracy(
                sf.frame, rows, out, phys, r, cap, xs, al, band=band),
                name, lab)
            e = max_err(out, sk.fused_substep_plain(sf.frame, rows, phys, r,
                                                    cap, xs, al, band=band))
            errs[name] = max(errs[name], e)
            print(f"compare {lab}: {name} max|k-p| {e:.3e}, {line}; band "
                  f"{band}, live rows {live[k]} of {rows.shape[0]}, "
                  f"certificate (clip, halo drops, lost) {int(sf.cert)}",
                  flush=True)
            if planted and live[k] == max(live):
                no_visc = phys._replace(
                    viscosity=torch.zeros_like(phys.viscosity))
                bad = sk.fused_substep_cuda(sf.frame, rows, no_visc, r, cap,
                                            xs, al, band=band)
                must_fail(sk.substep_accuracy(sf.frame, rows, bad, phys, r,
                                              cap, xs, al, band=band),
                          f"{name} with viscosity 0", lab)

    def lanes_slab(cfg, spec, sst, label):
        """The launched K2-band (K2-ext-band with extensions), a group of
        lanes a live row, bit-equal to the one-thread walk (lanes=1) on
        each shard's frame of ``sst``, in every variant library."""
        phys = PhysParams.from_config(cfg, dev)
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        xs, al = cfg.xsph, cfg.artificial_viscosity
        ext = sk.uses_extensions(xs, al)
        widths = {}
        for sf in shard_frames(cfg, spec, ring, sst):
            rows = sk.pack_rows(sf.pos_s, sf.vel_s, sk.density_cuda(
                sf.frame, sf.pos_s, phys, r, cap, band=sf.band))
            for vname, vt in (("default", None), ("facc0", FACC0),
                              ("kahan", KAHAN), ("bf16", BF16)):
                widths[vname] = sk.band_walk(ext, vt)
                out = sk.fused_substep_cuda(sf.frame, rows, phys, r, cap, xs,
                                            al, band=sf.band, tune=vt)
                one = sk.fused_substep_cuda(sf.frame, rows, phys, r, cap, xs,
                                            al, band=sf.band, tune=vt,
                                            lanes=1)
                if not same_bits(out, one):
                    fail(f"{label}, band {sf.band}, {vname}: the launched "
                         f"banded K2 ((lanes, slots) {widths[vname]}) "
                         f"leaves the one-thread walk's bits")
        print(f"lanes {label}: the launched banded K2{'-ext' if ext else ''} "
              f"((lanes a row, slots a lane) {widths}) bit-equal to the "
              f"one-thread walk on each of {SLAB_D} shards [{ident}]",
              flush=True)

    with Phase("slab compare frame 0"):
        for key, (cfg, st0) in slab_cfgs.items():
            _, spec, _ = slab_setup(cfg)
            compare_slab(cfg, spec, distribute(st0, cfg, spec),
                         f"{key} slab frame 0")
            lanes_slab(cfg, spec, distribute(st0, cfg, spec),
                       f"{key} slab frame 0")

    slab_after = {}
    for key, (cfg, st0) in slab_cfgs.items():
        with Phase(f"slab path {key}"):
            step, spec, phys = slab_setup(cfg)
            ext = sk.uses_extensions(cfg.xsph, cfg.artificial_viscosity)
            ref1, mr = make_rollout(cfg, 1, device=dev)(st0)
            sst = distribute(st0, cfg, spec)
            torch.cuda.synchronize()
            sk.reset_launch_counts()
            ms = []
            for f in range(SLAB_FRAMES):
                sst, m = step(sst, phys)
                ms.append(m)
                if f == 0:
                    sst1 = sst
            torch.cuda.synchronize()
            want = dict(zero, density_band=SLAB_D * SLAB_FRAMES)
            want["fused_substep_ext_band" if ext else "fused_substep_band"] \
                = 5 * SLAB_D * SLAB_FRAMES
            read_launches(f"the slab path {key}", want)
            out1, lost = collect(sst1, cfg.n_particles)
            diffs = [float((a.double() - b.double()).abs().max())
                     for a, b in zip(out1, ref1)]
            bits = all(torch.equal(a, b) for a, b in zip(out1, ref1))
            cert1 = int(ms[0].exact_cert)
            print(f"slab {key} frame 1 vs the single-device window route: "
                  f"bit for bit {bits}; max |diff| pos {diffs[0]:.3e}, vel "
                  f"{diffs[1]:.3e}, nan_count {diffs[2]:.0f}; exact_cert "
                  f"{cert1}, lost {lost}; overflow {int(ms[0].overflow)} "
                  f"(single device {int(mr.overflow[0])}); exact_cert per "
                  f"frame {[int(x.exact_cert) for x in ms]}, max_speed "
                  f"{[float(f'{float(x.max_speed):.4g}') for x in ms]} "
                  f"[{ident}]", flush=True)
            if int(ms[0].overflow) != int(mr.overflow[0]):
                fail(f"slab {key}: frame-1 overflow differs")
            if key == "262k" and cert1 == 0 and not bits:
                fail("slab 262k frame 1 leaves the single-device route "
                     "with exact_cert 0")
            # a row whose window the band cut may go non-finite, as on the
            # compact route; only where the certificate says so
            pos = sst.pos[sst.valid]
            fin = torch.isfinite(pos).all(1)
            certs = sum(int(x.exact_cert) for x in ms)
            print(f"slab {key}: own rows with non-finite positions "
                  f"{int((~fin).sum())}", flush=True)
            if not bool(fin.all()) and certs == 0:
                fail(f"slab {key}: non-finite positions with exact_cert 0")
            if not bool(((pos[fin] >= 0) & (pos[fin] <= 1)).all()):
                fail(f"slab {key}: own rows outside [0, 1]")
            slab_after[key] = (spec, sst)

    with Phase(f"slab compare frame {SLAB_FRAMES}"):
        for key, (cfg, _) in slab_cfgs.items():
            spec, sst = slab_after[key]
            compare_slab(cfg, spec, sst, f"{key} slab frame {SLAB_FRAMES}",
                         planted=key == "262k")
            lanes_slab(cfg, spec, sst, f"{key} slab frame {SLAB_FRAMES}")

    with Phase("slab calm 1k"):
        calm = SimConfig(particle_number=1024, bucket_resolution=11,
                         preset=0, gas_constant=20.0, rest_density=1.7,
                         viscosity=0.05, stiffness_coefficient=1000.0,
                         frame_dt=1 / 240)
        s0 = initial_state(calm, dev)
        ref, _ = make_rollout(calm, 3, device=dev)(s0)
        for d in (2, 4):
            step, spec, phys = slab_setup(calm, d)
            sst = distribute(s0, calm, spec)
            certs = []
            for _ in range(3):
                sst, m = step(sst, phys)
                certs.append(int(m.exact_cert))
            out, lost = collect(sst, calm.n_particles)
            e = float((out.pos - ref.pos).abs().max())
            bits = all(torch.equal(a, b) for a, b in zip(out, ref))
            print(f"slab calm 1k, {d} slabs, 3 frames: max |dpos| {e:.3e} "
                  f"(< 2e-5), bit for bit {bits}, exact_cert {certs}, lost "
                  f"{lost}", flush=True)
            if certs != [0, 0, 0] or lost or not e < 2e-5:
                fail(f"the calm slab run on {d} slabs")

    slab_graph(dev, ident, read_launches, zero, sizes, c3, k5, states0,
               c3_state)

    with Phase("slab timing"):
        for key, (cfg, _) in slab_cfgs.items():
            spec, sst = slab_after[key]
            phys = PhysParams.from_config(cfg, dev)
            r, cap = cfg.bucket_resolution, cfg.voxel_capacity
            xs, al = cfg.xsph, cfg.artificial_viscosity
            ext = sk.uses_extensions(xs, al)
            sfs = shard_frames(cfg, spec, ring, sst)
            scal, scal_f = sk.scal_block(phys), sk.scal_block(phys, xs, al)
            ins = []
            for sf in sfs:
                rows = sk.pack_rows(sf.pos_s, sf.vel_s, sk.density_cuda(
                    sf.frame, sf.pos_s, phys, r, cap, band=sf.band))
                mid = rows
                for _ in range(2):
                    mid = sk.fused_substep_cuda(sf.frame, mid, phys, r, cap,
                                                xs, al, band=sf.band)
                ins.append((sf, mid, sk.pj_cols(rows[:, 6], phys)))
            n_live = sum(int(sf.frame.start[-1]) for sf in sfs)
            n_dead = SLAB_D * spec.c_loc - n_live
            cells = SLAB_D * spec.z_span * r * r
            d_pairs = sum(sk.member_pairs(sf.frame, sf.pos_s, r, cap,
                                          sf.band)[0] for sf in sfs)
            f_pairs = 0
            for sf, mid, _ in ins:
                tot, own = sk.member_pairs(sf.frame, mid[:, 0:3], r, cap,
                                           sf.band)
                f_pairs += tot - own
            shape = f"{key}_slab"
            print(f"member pairs {shape}: density {d_pairs}, substep 3 "
                  f"{f_pairs}; live rows {n_live} of {SLAB_D * spec.c_loc}",
                  flush=True)
            if not ext:
                timed("density_band", shape, n_live, r, d_pairs, False,
                      lambda: [sk.density_cuda(sf.frame, sf.pos_s, phys, r,
                                               cap, scal, sf.band)
                               for sf, _, _ in ins],
                      lambda: [sk.density_plain(sf.frame, sf.pos_s, phys, r,
                                                cap, sf.band)
                               for sf, _, _ in ins],
                      s_cells=cells, n_dead=n_dead)
            name = "fused_substep_ext_band" if ext else "fused_substep_band"
            timed(name, shape, n_live, r, f_pairs, ext,
                  lambda: [sk.fused_substep_cuda(sf.frame, mid, phys, r, cap,
                                                 xs, al, pj, scal_f, sf.band)
                           for sf, mid, pj in ins],
                  lambda: [sk.fused_substep_plain(sf.frame, mid, phys, r,
                                                  cap, xs, al, band=sf.band)
                           for sf, mid, _ in ins],
                  s_cells=cells, n_dead=n_dead)
            # the one-thread walk on the same inputs, the reference instance
            one = time_ms(lambda: [sk.fused_substep_cuda(
                sf.frame, mid, phys, r, cap, xs, al, pj, scal_f, sf.band,
                lanes=1) for sf, mid, pj in ins], 20)
            km = times[name][shape][0]
            print(f"time {shape} {name} one lane a row (lanes=1): {one:.4f} "
                  f"ms; launched, (lanes, slots) {sk.band_walk(ext)}: "
                  f"{km:.4f} ms = {km / one:.4f} x [{ident}]", flush=True)

    # ---- 9. the tuning variants and the banded K5
    vtunes = (FACC0, KAHAN, BF16)

    def compare_k5_bf16(cfg, state, label, forces=False):
        """K5's bf16 force modes against their plain versions on the
        frame-start rows (the window route's density), the drift count
        equal to the plain version's."""
        frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, state)
        xs, al = cfg.xsph, cfg.artificial_viscosity
        rows = sk.pack_rows(pos_s, vel_s,
                            sk.density_plain(frame, pos_s, phys, r, cap))
        cp = compact.spans_of(frame, pos_s, r, True)[1]
        name = ("compact_substep_ext" if sk.uses_extensions(xs, al)
                else "compact_substep") + "+bf16"
        ref = sk.substep_reference(frame, rows, phys, r, None, xs, al,
                                   compact.compact_sums_plain, tune=BF16)
        out, ck = compact.compact_substep_cuda(frame, rows, phys, r, cap,
                                               xs, al, tune=BF16)
        e, line = hold_out(name, out, ref, label)
        same_cert(ck, cp, name, label)
        print(f"compare {label}: {name} max|k-p| {e:.3e}, {line}; drift "
              f"count {int(ck)}", flush=True)
        if forces:
            ref_f = sk.forces_reference(frame, rows, phys, r, None,
                                        sums_fn=compact.compact_sums_plain,
                                        tune=BF16)
            sums, ck = compact.forces_compact_cuda(frame, rows, phys, r, cap,
                                                   tune=BF16)
            s_o, co = compact.forces_compact_cuda(
                frame, rows, phys, r, cap, tune=BF16,
                own=not compact.own_lists(rows.shape[0], r))
            if not (same_bits(sums, s_o) and int(ck) == int(co)):
                fail(f"{label}: K5 bf16 forces' two walks differ")
            f = sk.fold_forces(sums, rows[:, 6], phys, fuse_acc=False)[0]
            e, line = hold_out("compact_forces+bf16", f, ref_f, label)
            same_cert(ck, cp, "compact_forces+bf16", label)
            print(f"compare {label}: compact_forces+bf16 max|k-p| {e:.3e}, "
                  f"{line}", flush=True)

    def hold_record_walks(lab, frame, rows, phys, walks, planted):
        """Each one-scene record walk of ``walks`` (name: its wrapper's
        call), as launched (the record built by the pass in the wrapper)
        and given the record, bit-equal to its walk of occ, raw and pj
        (``reference``); with ``planted``, a record whose occ lane is
        cleared on one occupied row must leave the reference's bits."""
        rec = sk.frame_record(frame, rows[:, 6], phys)
        refs = {}
        for wname, call in walks.items():
            ref = refs[wname] = call(reference=True)
            if not (same_bits(call(), ref) and same_bits(call(rec=rec),
                                                          ref)):
                fail(f"{lab}: the {wname} record walk leaves the walk of "
                     f"occ, raw and pj")
        if planted:
            bad_rec = rec.clone()
            occupied = torch.nonzero(frame.occ)
            j = int(occupied[occupied.shape[0] // 2])
            bad_rec.view(torch.int32)[0, j, 3] = 0
            for wname, call in walks.items():
                if same_bits(call(rec=bad_rec), refs[wname]):
                    fail(f"{lab}: the planted record (occ cleared on row "
                         f"{j}) passes {wname}")
        return rec

    def compare_variants(label, st262, st_c3, st_k5_262, st_k5_c3,
                         planted=False):
        """Each new instance against the plain version of its variant at
        262k and config 3; the Kahan kernels' max |k - p64| beside the
        default kernels' at config 3; with ``planted`` the two controls."""
        lab = f"262k {label}"
        frame, rows, phys, r, cap = compare(sizes["262k"], st262, lab,
                                            tunes=vtunes)
        pos_s = rows[:, 0:3].contiguous()
        hold_density(sk.density_cuda(frame, pos_s, phys, r, cap,
                                     tune=KAHAN),
                     sk.density_plain(frame, pos_s, phys, r, cap,
                                      tune=KAHAN), "density+kahan", lab)
        for tune in vtunes:
            name = "forces" + sk.variant_tag("forces.cu", tune)
            ref = sk.forces_reference(frame, rows, phys, r, cap, tune=tune)
            f = sk.fold_forces(sk.forces_cuda(frame, rows, phys, r, cap,
                                              tune=tune),
                               rows[:, 6], phys, fuse_acc=tune.fuse_acc)[0]
            e, line = hold_out(name, f, ref, lab)
            print(f"compare {lab}: {name} (no extensions) max|k-p| "
                  f"{e:.3e}, {line}", flush=True)
        # the bf16, the Kahan and the facc0 K2 without extensions walk the
        # one-scene frame record
        walks = {"fused_substep" + sk.variant_tag("fused_substep.cu", t):
                 (lambda t=t, **kw: sk.fused_substep_cuda(
                     frame, rows, phys, r, cap, tune=t, **kw))
                 for t in (BF16, KAHAN, FACC0)}
        hold_record_walks(lab, frame, rows, phys, walks, planted)
        print(f"compare {lab}: the record walks of {', '.join(walks)} "
              f"bit-equal to the walks of occ, raw and pj"
              f"{'; the planted record fails' if planted else ''}",
              flush=True)
        compare_k5_bf16(sizes["262k"], st_k5_262, lab, forces=True)
        lab = f"config 3 {label}"
        frame, rows, phys, r, cap, outs = compare_ext(
            c3, st_c3, lab, tunes=(DEFAULT,) + vtunes)
        pos_s = rows[:, 0:3].contiguous()
        rho_kahan = sk.density_cuda(frame, pos_s, phys, r, cap, tune=KAHAN)
        hold_density(rho_kahan, sk.density_plain(frame, pos_s, phys, r, cap,
                                                 tune=KAHAN),
                     "density+kahan", lab)
        errs_k = {t: (sk.hold(k2, ref2).err, sk.hold(k3, ref3).err)
                  for t, (k2, ref2, k3, ref3) in outs.items()}
        print(f"kahan vs default, {lab}: max|k-p64| K2-ext "
              f"{errs_k[KAHAN][0]:.6e} vs "
              f"{errs_k[DEFAULT][0]:.6e}; K3 {errs_k[KAHAN][1]:.6e} vs "
              f"{errs_k[DEFAULT][1]:.6e} (each against the float64 "
              f"evaluation of its own variant)", flush=True)
        compare_k5_bf16(c3, st_k5_c3, lab)
        # the bf16 K2-ext reads its candidates rounded once (the pass's
        # copy, held to its plain version bit for bit): its output is the
        # in-register walk's, the reference, bit for bit
        cand_k = sk.bf16_candidates_cuda(rows)
        cand_p = sk.bf16_candidates_plain(rows)
        errs["bf16_candidates"] = max(errs["bf16_candidates"],
                                      max_err(cand_k, cand_p))
        if not same_bits(cand_k, cand_p):
            fail(f"{lab}: bf16_candidates leaves its plain version")
        k2_ref = sk.fused_substep_cuda(frame, rows, phys, r, cap, XSPH, ALPHA,
                                       tune=BF16, reference=True)
        if not same_bits(outs[BF16][0], k2_ref):
            fail(f"{lab}: the bf16 K2-ext leaves its in-register walk")
        # the bf16 K3-ext reads the same copy: its sums are those of the
        # walk that rounds in its registers. Planted (on the frame-10 rows:
        # the spawn's velocities are 0, whose truncation is their
        # rounding): a copy whose vz is truncated to its high half, not
        # rounded, must leave the reference's bits
        k3_ref = sk.forces_cuda(frame, rows, phys, r, cap, True, tune=BF16,
                                reference=True)
        if not same_bits(sk.forces_cuda(frame, rows, phys, r, cap, True,
                                        tune=BF16), k3_ref):
            fail(f"{lab}: the bf16 K3-ext leaves its in-register walk")
        if planted:
            planted_cand = cand_k.clone()
            tail = sk.candidate_halves(planted_cand)[1]
            vz = rows[:, 5].view(torch.int32) & -0x10000
            rho_b = sk.bf16_round(rows[:, 6]).view(torch.int32)
            tail[:, 0] = (vz | ((rho_b >> 16) & 0xFFFF)).view(torch.float32)
            bad = torch.empty_like(k3_ref)
            sk._walk_launch(cuda_build.function("forces.cu",
                                                "sph_forces_cand", BF16),
                            "forces", frame, rows, None, sk.scal_block(phys),
                            bad, r, cap, True, cand=planted_cand)
            if same_bits(bad, k3_ref):
                fail(f"{lab}: the planted copy (vz truncated) passes")
        # the record walks with extensions: the Kahan and the facc0 K2-ext
        # and K3-ext, each bit-equal to its walk of occ, raw and pj; the
        # frame record, built by its pass, is its plain version's
        walks = {}
        for tune in (KAHAN, FACC0):
            walks["fused_substep_ext" + sk.variant_tag("fused_substep.cu",
                                                       tune)] = (
                lambda t=tune, **kw: sk.fused_substep_cuda(
                    frame, rows, phys, r, cap, XSPH, ALPHA, tune=t, **kw))
            walks["forces" + sk.variant_tag("forces.cu", tune)] = (
                lambda t=tune, **kw: sk.forces_cuda(
                    frame, rows, phys, r, cap, True, tune=t, **kw))
        rec = hold_record_walks(lab, frame, rows, phys, walks, planted)
        rec_p = sk.frame_record_scenes_plain(*sk.one_scene(frame, rows[:, 6],
                                                           phys))
        errs["frame_record"] = max(errs["frame_record"], max_err(rec, rec_p))
        if not same_bits(rec, rec_p):
            fail(f"{lab}: frame_record leaves its plain version")
        print(f"compare {lab}: bf16_candidates and frame_record bit-equal "
              f"to their plain versions; fused_substep_ext+bf16 and "
              f"forces+bf16 (with extensions) bit-equal to their "
              f"in-register walks; the record walks of "
              f"{', '.join(walks)} bit-equal to the walks of occ, raw and "
              f"pj"
              f"{'; the planted copy and record fail' if planted else ''}",
              flush=True)
        if planted:
            k2_bf16, ref_def = outs[BF16][0], outs[DEFAULT][1]
            must_fail(sk.hold(k2_bf16, ref_def),
                      "the bf16 K2-ext held to the f32 plain version", lab)
            no_visc = phys._replace(
                viscosity=torch.zeros_like(phys.viscosity))
            must_fail(sk.hold(sk.fused_substep_cuda(frame, rows, no_visc, r,
                                                    cap, XSPH, ALPHA),
                              ref_def),
                      "the fuse_acc K2-ext with viscosity 0", lab)

    with Phase("tuning variants: compare frame 0"):
        compare_variants("frame 0", states0["262k"], c3_state,
                         states0["262k"], c3_state)
    with Phase(f"tuning variants: compare frame {FRAMES}"):
        compare_variants(f"frame {FRAMES}", states["262k"],
                         c3_states["config 3 faithful"], k5_states["262k"],
                         k5_states["config 3 faithful, compact"],
                         planted=True)

    # every variant's path, selected through its SPH_PALLAS_* variable
    # (make_rollout reads them), VARIANT_FRAMES frames from the spawn
    vf = VARIANT_FRAMES
    variant_paths = (
        ("unfused 262k", {"SPH_PALLAS_FUSED": "0"}, "262k",
         {"density": vf, "forces": 5 * vf}),
        ("unfused config 3", {"SPH_PALLAS_FUSED": "0"}, "c3",
         {"density": vf, "forces": 5 * vf}),
        # the facc0 and the Kahan K2's record, built by its pass once a
        # frame
        ("facc0 262k", {"SPH_PALLAS_FACC": "0"}, "262k",
         {"density": vf, "frame_record": vf, "fused_substep+facc0": 5 * vf}),
        ("facc0 config 3", {"SPH_PALLAS_FACC": "0"}, "c3",
         {"density": vf, "frame_record": vf,
          "fused_substep_ext+facc0": 5 * vf}),
        ("facc0 unfused 262k", {"SPH_PALLAS_FACC": "0",
                                "SPH_PALLAS_FUSED": "0"}, "262k",
         {"density": vf, "forces+facc0": 5 * vf}),
        # the facc0 K3-ext's record, built by its pass every substep
        ("facc0 corrected config 3", {"SPH_PALLAS_FACC": "0"}, "c3",
         {"density": 6 * vf, "frame_record": 5 * vf,
          "forces+facc0": 5 * vf}),
        ("kahan 262k", {"SPH_PALLAS_KAHAN": "1"}, "262k",
         {"density+kahan": vf, "frame_record": vf,
          "fused_substep+kahan": 5 * vf}),
        ("kahan unfused config 3", {"SPH_PALLAS_KAHAN": "1",
                                    "SPH_PALLAS_FUSED": "0"}, "c3",
         {"density+kahan": vf, "frame_record": vf, "forces+kahan": 5 * vf}),
        # the Kahan K3-ext's record, built by its pass every substep
        ("kahan corrected config 3", {"SPH_PALLAS_KAHAN": "1"}, "c3",
         {"density+kahan": 6 * vf, "frame_record": 5 * vf,
          "forces+kahan": 5 * vf}),
        # the bf16 K2's record, built by its pass once a frame
        ("bf16 262k", {"SPH_PALLAS_BF16": "1"}, "262k",
         {"density": vf, "frame_record": vf, "fused_substep+bf16": 5 * vf}),
        ("bf16 config 3", {"SPH_PALLAS_BF16": "1"}, "c3",
         {"density": vf, "fused_substep_ext+bf16": 5 * vf,
          "bf16_candidates": 5 * vf}),
        ("bf16 unfused 262k", {"SPH_PALLAS_BF16": "1",
                               "SPH_PALLAS_FUSED": "0"}, "262k",
         {"density": vf, "forces+bf16": 5 * vf}),
        ("bf16 compact 262k", {"SPH_PALLAS_BF16": "1",
                               "SPH_PALLAS_COMPACT": "1"}, "262k",
         {"compact_density": vf, "compact_substep+bf16": 5 * vf}),
        ("bf16 compact config 3", {"SPH_PALLAS_BF16": "1",
                                   "SPH_PALLAS_COMPACT": "1"}, "c3",
         {"compact_density": vf, "compact_substep_ext+bf16": 5 * vf}),
        ("bf16 compact unfused 262k", {"SPH_PALLAS_BF16": "1",
                                       "SPH_PALLAS_COMPACT": "1",
                                       "SPH_PALLAS_FUSED": "0"}, "262k",
         {"compact_density": vf, "compact_forces+bf16": 5 * vf}))
    with Phase("tuning variants: paths"):
        for label, env, key, want in variant_paths:
            cfg, st0 = ((c3, c3_state) if key == "c3"
                        else (sizes[key], states0[key]))
            os.environ.update(env)
            try:
                roll = make_rollout(cfg, vf, device=dev,
                                    faithful="corrected" not in label)
            finally:
                for var in env:
                    del os.environ[var]
            run_path(f"the {label} path ({env})", {label: roll},
                     {label: st0}, want, {label: cfg},
                     exact="SPH_PALLAS_COMPACT" not in env, frames=vf)

    # the variants' scene-axis instances: 2 scenes of 262k (rest density
    # 1.0 and 2.0), each variant's batch through BatchedScenes (the graph)
    # for VARIANT_FRAMES frames after the frame that records it, then each
    # instance on the spawn's frame: every scene bit-equal to its solo
    # launch in the same variant, scene 0 held to the plain version of its
    # variant, and its time, plain time and bound
    vb_cfg, vb_ov = sizes["262k"], cli.sweep_overrides(1.0, 2.0, 2)
    variant_batches = (
        (KAHAN, {"density_scenes+kahan": 1, "frame_record": 1,
                 "fused_substep_scenes+kahan": 5}),
        (BF16, {"density_scenes": 1, "frame_record": 1,
                "fused_substep_scenes+bf16": 5}),
        (FACC0, {"density_scenes": 1, "frame_record": 1,
                 "fused_substep_scenes+facc0": 5}),
        (SortedTuning(compact=True, bf16=True),
         {"compact_density_scenes": 1, "compact_substep_scenes+bf16": 5}))
    with Phase("tuning variants: scene axis"):
        frame, pos_s, vel_s, params, r, cap = scene_inputs(vb_cfg, vb_ov)
        n_sc, n = pos_s.shape[:2]
        solo = [(scene_frame(frame, sc), sk.scene_params(params, sc))
                for sc in range(n_sc)]
        fs0, ph0 = solo[0]
        rows = sk.pack_rows_scenes(pos_s, vel_s, sk.density_scenes_cuda(
            frame, pos_s, params, r, cap))
        pj, scal = sk.pj_cols_scenes(rows[..., 6], params), \
            sk.scal_blocks(params)
        rec = sk.frame_record_scenes(frame, rows[..., 6], params)
        win = [sk.member_pairs(fs, pos_s[sc], r, cap)
               for sc, (fs, _) in enumerate(solo)]
        k5_win = [compact.member_pairs(fs, pos_s[sc], r, True)
              for sc, (fs, _) in enumerate(solo)]
        tot, f_pairs = sum(t for t, _ in win), sum(t - o for t, o in win)
        k5_pairs = sum(t - o for t, o in k5_win)
        for tune, per_frame in variant_batches:
            label = f"the 262k x 2 batch path, {tune}"
            bs = BatchedScenes(vb_cfg, vb_ov, devices=dev, tune=tune)
            bs.step()                                  # records the graph
            torch.cuda.synchronize()
            sk.reset_launch_counts()
            bs.step(vf)
            torch.cuda.synchronize()
            read_launches(label, dict(zero, **{k: v * vf
                                               for k, v in per_frame.items()}))
            pos = bs.states.pos
            fin = torch.isfinite(pos).all(2)
            if not bool(((pos[fin] >= 0) & (pos[fin] <= 1)).all()):
                fail(f"{label}: positions outside [0, 1]")
            if not tune.compact and not bool(fin.all()):
                fail(f"{label}: non-finite positions")
            del bs
            if tune.compact:
                name = "compact_substep_scenes+bf16"
                out, cs = compact.compact_substep_scenes_cuda(
                    frame, rows, params, r, cap, pj=pj, scal=scal, tune=tune)
                solo_ok = all(
                    same_bits(out[sc], o1) and int(cs[sc]) == int(c1)
                    for sc, (fs, ph) in enumerate(solo)
                    for o1, c1 in [compact.compact_substep_cuda(
                        fs, rows[sc], ph, r, cap, tune=tune)])
                ref = sk.substep_reference(fs0, rows[0], ph0, r, None,
                                           sums_fn=compact.compact_sums_plain,
                                           tune=tune)
                occ = compact.occ_prefix(frame.occ)
                kernel = (lambda sp=compact.SPLIT_SLOTS:
                          compact.compact_substep_scenes_cuda(
                              frame, rows, params, r, cap, pj=pj, scal=scal,
                              tune=tune, occ_cum=occ, split=sp))
                plain = (lambda: compact.compact_substep_scenes_plain(
                    frame, rows, params, r, tune=tune))
                pairs = k5_pairs
            else:
                name = "fused_substep_scenes" + sk.variant_tag(
                    "fused_substep.cu", tune)
                out = sk.fused_substep_scenes_cuda(frame, rows, params, r, cap,
                                                   scal=scal, tune=tune,
                                                   rec=rec)
                walk0 = sk.fused_substep_scenes_cuda(
                    frame, rows, params, r, cap, scal=scal, tune=tune,
                    reference=True, pj=pj)
                solo_ok = same_bits(out, walk0) and all(
                    same_bits(out[sc], sk.fused_substep_cuda(
                        fs, rows[sc], ph, r, cap, tune=tune))
                    for sc, (fs, ph) in enumerate(solo))
                ref = sk.substep_reference(fs0, rows[0], ph0, r, cap,
                                           tune=tune)
                kernel = (lambda: sk.fused_substep_scenes_cuda(
                    frame, rows, params, r, cap, scal=scal, tune=tune,
                    rec=rec))
                plain = (lambda: sk.fused_substep_scenes_plain(
                    frame, rows, params, r, cap, tune=tune))
                pairs = f_pairs
            e, line = hold_out(name, out[0], ref, "262k x 2 frame 0 scene 0")
            print(f"compare 262k x 2 frame 0: {name} scene 0 max|k-p| "
                  f"{e:.3e}, {line}; each scene bit-equal to its solo "
                  f"launch{'' if tune.compact else ' and the reference walk'}"
                  f" {solo_ok}", flush=True)
            if not solo_ok:
                fail(f"{name} leaves the solo launch of its variant")
            timed(name, "262kx2", n_sc * n, r, pairs, False, kernel, plain,
                  scenes=n_sc)
            if not tune.compact:
                hold_out(name, walk0[0], ref,
                         "262k x 2 frame 0 scene 0, reference walk")
            if tune.compact:
                # the default instance on the same spawn inputs
                timed("compact_substep_scenes", "262kx2", n_sc * n, r, pairs,
                      False,
                      lambda sp=compact.SPLIT_SLOTS:
                      compact.compact_substep_scenes_cuda(
                          frame, rows, params, r, cap, pj=pj, scal=scal,
                          occ_cum=occ, split=sp),
                      lambda: compact.compact_substep_scenes_plain(
                          frame, rows, params, r), scenes=n_sc)
            if tune.kahan:
                # the density record walk, given the record as the stepper
                # builds it, against the reference walk and the solo K1
                drec = sk.density_record_scenes(frame, pos_s)
                rho = sk.density_scenes_cuda(frame, pos_s, params, r, cap,
                                             scal, tune, rec=drec)
                hold_density(rho[0], sk.density_plain(fs0, pos_s[0], ph0, r,
                                                      cap, tune=tune),
                             "density_scenes+kahan", "262k x 2 frame 0")
                if not same_bits(rho, sk.density_scenes_cuda(
                        frame, pos_s, params, r, cap, scal, tune,
                        reference=True)):
                    fail("density_scenes+kahan leaves the reference walk")
                if not all(same_bits(rho[sc], sk.density_cuda(
                        fs, pos_s[sc], ph, r, cap, tune=tune))
                        for sc, (fs, ph) in enumerate(solo)):
                    fail("density_scenes+kahan leaves the solo launch")
                timed("density_scenes+kahan", "262kx2", n_sc * n, r, tot,
                      False,
                      lambda: sk.density_scenes_cuda(frame, pos_s, params, r,
                                                     cap, scal, tune,
                                                     rec=drec),
                      lambda: sk.density_scenes_plain(frame, pos_s, params,
                                                      r, cap, tune),
                      scenes=n_sc)

    # the slab step on the compact route: the banded K5
    slab_k5 = {}
    for key, (cfg, st0) in slab_cfgs.items():
        with Phase(f"tuning variants: compact slab path {key}"):
            step, spec = make_pallas_slab_step(
                cfg, LocalRing(SLAB_D), row_slack=SLAB_SLACK,
                halo_slack=SLAB_HALO, tune=k5)
            phys = PhysParams.from_config(cfg, dev)
            ext = sk.uses_extensions(cfg.xsph, cfg.artificial_viscosity)
            sst = distribute(st0, cfg, spec)
            torch.cuda.synchronize()
            sk.reset_launch_counts()
            t0 = time.perf_counter()
            ms = []
            for _ in range(vf):
                sst, m = step(sst, phys)
                ms.append(m)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            want = {"compact_density_band": SLAB_D * vf,
                    ("compact_substep_ext_band" if ext
                     else "compact_substep_band"): 5 * SLAB_D * vf}
            read_launches(f"the compact slab path {key}", want)
            pos = sst.pos[sst.valid]
            fin = torch.isfinite(pos).all(1)
            certs = [int(x.exact_cert) for x in ms]
            print(f"compact slab {key} ({SLAB_D} slabs, {vf} frames from "
                  f"the spawn, {dt:.4f} s): exact_cert {certs}, overflow "
                  f"{[int(x.overflow) for x in ms]}, own rows with "
                  f"non-finite positions {int((~fin).sum())} [{ident}]",
                  flush=True)
            if not bool(fin.all()) and sum(certs) == 0:
                fail(f"compact slab {key}: non-finite positions with "
                     f"exact_cert 0")
            if not bool(((pos[fin] >= 0) & (pos[fin] <= 1)).all()):
                fail(f"compact slab {key}: own rows outside [0, 1]")
            slab_k5[key] = (spec, sst)

    with Phase("tuning variants: compact slab compare"):
        for key, (cfg, _) in slab_cfgs.items():
            spec, sst = slab_k5[key]
            phys = PhysParams.from_config(cfg, dev)
            r, cap = cfg.bucket_resolution, cfg.voxel_capacity
            xs, al = cfg.xsph, cfg.artificial_viscosity
            name = ("compact_substep_ext_band" if sk.uses_extensions(xs, al)
                    else "compact_substep_band")
            for k, sf in enumerate(shard_frames(cfg, spec, ring, sst)):
                lab = f"{key} compact slab frame {vf}, shard {k}"
                rho_k, _ = compact.density_compact_cuda(
                    sf.frame, sf.pos_s, phys, r, cap, band=sf.band)
                rho_p, _ = compact.density_compact_plain(
                    sf.frame, sf.pos_s, phys, r, sf.band)
                hold_density(rho_k, rho_p, "compact_density_band", lab)
                rows = sk.pack_rows(sf.pos_s, sf.vel_s, rho_p)
                ref = sk.substep_reference(sf.frame, rows, phys, r, None, xs,
                                           al, compact.compact_sums_plain,
                                           sf.band)
                out, ck = compact.compact_substep_cuda(
                    sf.frame, rows, phys, r, cap, xs, al, band=sf.band)
                e, line = hold_out(name, out, ref, lab)
                same_cert(ck, compact.spans_of(sf.frame, rows[:, 0:3], r,
                                               True, sf.band)[1], name, lab)
                print(f"compare {lab}: {name} max|k-p| {e:.3e}, {line}; "
                      f"band {sf.band}, live rows {int(sf.frame.start[-1])}"
                      f", drift count {int(ck)}", flush=True)

    with Phase("tuning variants: compact slab calm 1k"):
        calm = SimConfig(particle_number=1024, bucket_resolution=11,
                         preset=0, gas_constant=20.0, rest_density=1.7,
                         viscosity=0.05, stiffness_coefficient=1000.0,
                         frame_dt=1 / 240)
        s0 = initial_state(calm, dev)
        ref, _ = make_rollout(calm, 3, tune=k5, device=dev)(s0)
        for d in (2, 4):
            step, spec = make_pallas_slab_step(calm, LocalRing(d),
                                               row_slack=SLAB_SLACK,
                                               halo_slack=SLAB_HALO, tune=k5)
            phys = PhysParams.from_config(calm, dev)
            sst = distribute(s0, calm, spec)
            certs = []
            for _ in range(3):
                sst, m = step(sst, phys)
                certs.append(int(m.exact_cert))
            out, lost = collect(sst, calm.n_particles)
            e = float((out.pos - ref.pos).abs().max())
            e_v = float((out.vel - ref.vel).abs().max())
            print(f"compact slab calm 1k, {d} slabs, 3 frames: max |dpos| "
                  f"{e:.3e} (< 2e-5), max |dvel| {e_v:.3e}, exact_cert "
                  f"{certs}, lost {lost}", flush=True)
            if certs != [0, 0, 0] or lost or not e < 2e-5:
                fail(f"the calm compact slab run on {d} slabs")

    with Phase("tuning variants: timing"):
        for shape, (cfg, st) in (("262k", shapes["262k"]),
                                 ("c3", shapes["c3"])):
            frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, st)
            n = pos_s.shape[0]
            xs, al = cfg.xsph, cfg.artificial_viscosity
            ext = sk.uses_extensions(xs, al)
            rows = sk.pack_rows(pos_s, vel_s,
                                sk.density_cuda(frame, pos_s, phys, r, cap))
            mid = rows
            for _ in range(2):
                mid = sk.fused_substep_cuda(frame, mid, phys, r, cap, xs, al)
            scal, scal_f = sk.scal_block(phys), sk.scal_block(phys, xs, al)
            pj = sk.pj_cols(rows[:, 6], phys)
            # the record walks' frame record, which the stepper builds
            # once a frame (the frame-start ρ, which mid keeps)
            rec = sk.frame_record(frame, rows[:, 6], phys)
            tot, own = sk.member_pairs(frame, pos_s, r, cap)
            m_tot, m_own = sk.member_pairs(frame, mid[:, 0:3], r, cap)
            k_tot, k_own = compact.member_pairs(frame, mid[:, 0:3], r,
                                                fresh=True)
            ftot, fown = compact.member_pairs(frame, pos_s, r, fresh=True)
            if not ext:
                timed("density+kahan", shape, n, r, tot, False,
                      lambda: sk.density_cuda(frame, pos_s, phys, r, cap,
                                              scal, tune=KAHAN),
                      lambda: sk.density_plain(frame, pos_s, phys, r, cap,
                                               tune=KAHAN))
            base = "fused_substep_ext" if ext else "fused_substep"
            for tune in vtunes:
                name = base + sk.variant_tag("fused_substep.cu", tune)
                timed(name, shape, n, r, m_tot - m_own, ext,
                      lambda: sk.fused_substep_cuda(frame, mid, phys, r, cap,
                                                    xs, al, pj, scal_f,
                                                    tune=tune, rec=rec),
                      lambda: sk.fused_substep_plain(frame, mid, phys, r,
                                                     cap, xs, al, tune=tune))
                if ext and tune is KAHAN:
                    # the record's pass, once a frame (once a corrected
                    # substep), on copies of its inputs cycled past the L2
                    copies = record_copies(frame, rows[:, 6].contiguous(),
                                           n)
                    timed("frame_record", shape, n, r, 0, False,
                          lambda: sk.frame_record(*next(copies), phys),
                          lambda: sk.frame_record_scenes_plain(
                              *sk.one_scene(frame, rows[:, 6], phys)))
                    del copies
                if ext and tune is BF16:
                    # with its candidates' pass (above), the pass alone,
                    # and the default K2-ext's time beside it
                    # the pass cycles through copies of the rows past the
                    # card's L2, so that it reads them from device memory,
                    # as its bound counts them
                    copies = cycle(past_l2(mid, n * CAND_ROW_BYTES))
                    timed("bf16_candidates", shape, n, r, 0, False,
                          lambda: sk.bf16_candidates_cuda(next(copies)),
                          lambda: sk.bf16_candidates_plain(mid))
                    del copies
                    k2_ms = time_ms(lambda: sk.fused_substep_cuda(
                        frame, mid, phys, r, cap, xs, al, pj, scal_f), 20)
                    print(f"time {shape}: fused_substep_ext+bf16 with its "
                          f"candidates' pass {times[name][shape][0]:.4f} ms, "
                          f"the default K2-ext {k2_ms:.4f} ms on the same "
                          f"inputs: {times[name][shape][0] / k2_ms:.4f} x "
                          f"[{ident}]", flush=True)
                name = "forces" + sk.variant_tag("forces.cu", tune)
                timed(name, shape, n, r, tot - own, ext,
                      lambda: sk.forces_cuda(frame, rows, phys, r, cap, ext,
                                             pj, scal, tune=tune, rec=rec),
                      lambda: sk.forces_plain(frame, rows, phys, r, cap, ext,
                                              tune=tune))
                if ext and tune is BF16:
                    # with its candidates' pass, beside the default K3-ext
                    k3_ms = time_ms(lambda: sk.forces_cuda(
                        frame, rows, phys, r, cap, ext, pj, scal), 20)
                    print(f"time {shape}: forces+bf16 with its candidates' "
                          f"pass {times[name][shape][0]:.4f} ms, the default "
                          f"K3-ext {k3_ms:.4f} ms on the same inputs: "
                          f"{times[name][shape][0] / k3_ms:.4f} x "
                          f"[{ident}]", flush=True)
            name = ("compact_substep_ext" if ext else "compact_substep") \
                + "+bf16"
            occ = compact.occ_prefix(frame.occ)
            timed(name, shape, n, r, k_tot - k_own, ext,
                  lambda sp=compact.SPLIT_SLOTS: compact.compact_substep_cuda(
                      frame, mid, phys, r, cap, xs, al, pj, scal_f,
                      tune=BF16, occ_cum=occ, split=sp),
                  lambda: compact.compact_substep_plain(frame, mid, phys, r,
                                                        xs, al, tune=BF16))
            if not ext:
                timed("compact_forces+bf16", shape, n, r, ftot - fown, False,
                      lambda: compact.forces_compact_cuda(frame, rows, phys,
                                                          r, cap, pj, scal,
                                                          tune=BF16),
                      lambda: compact.forces_compact_plain(frame, rows, phys,
                                                           r, BF16))
                timed("compact_forces+bf16", f"{shape}_list", n, r,
                      ftot - fown, False,
                      lambda: compact.forces_compact_cuda(
                          frame, rows, phys, r, cap, pj, scal, tune=BF16,
                          own=False),
                      times["compact_forces+bf16"][shape][1])
        for key, (cfg, _) in slab_cfgs.items():
            spec, sst = slab_k5[key]
            phys = PhysParams.from_config(cfg, dev)
            r, cap = cfg.bucket_resolution, cfg.voxel_capacity
            xs, al = cfg.xsph, cfg.artificial_viscosity
            ext = sk.uses_extensions(xs, al)
            sfs = shard_frames(cfg, spec, ring, sst)
            scal, scal_f = sk.scal_block(phys), sk.scal_block(phys, xs, al)
            ins = []
            for sf in sfs:
                rows = sk.pack_rows(sf.pos_s, sf.vel_s,
                                    compact.density_compact_cuda(
                                        sf.frame, sf.pos_s, phys, r, cap,
                                        band=sf.band)[0])
                mid = rows
                for _ in range(2):
                    mid, _ = compact.compact_substep_cuda(
                        sf.frame, mid, phys, r, cap, xs, al, band=sf.band)
                ins.append((sf, mid, sk.pj_cols(rows[:, 6], phys),
                            compact.occ_prefix(sf.frame.occ)))
            n_live = sum(int(sf.frame.start[-1]) for sf in sfs)
            n_dead = SLAB_D * spec.c_loc - n_live
            cells = SLAB_D * spec.z_span * r * r
            d_pairs = sum(compact.member_pairs(sf.frame, sf.pos_s, r, False,
                                               sf.band)[0] for sf in sfs)
            f_pairs = 0
            for sf, mid, _, _ in ins:
                tot, own = compact.member_pairs(sf.frame, mid[:, 0:3], r,
                                                True, sf.band)
                f_pairs += tot - own
            shape = f"{key}_slab"
            print(f"member pairs {shape}, compact route: density {d_pairs}, "
                  f"substep 3 {f_pairs}; live rows {n_live} of "
                  f"{SLAB_D * spec.c_loc}", flush=True)
            if not ext:
                timed("compact_density_band", shape, n_live, r, d_pairs,
                      False,
                      lambda sp=compact.DENSITY_SPLIT_SLOTS: [
                          compact.density_compact_cuda(
                              sf.frame, sf.pos_s, phys, r, cap, scal,
                              sf.band, occ, sp)
                          for sf, _, _, occ in ins],
                      lambda: [compact.density_compact_plain(
                          sf.frame, sf.pos_s, phys, r, sf.band)
                          for sf, _, _, _ in ins],
                      s_cells=cells, n_dead=n_dead)
            name = ("compact_substep_ext_band" if ext
                    else "compact_substep_band")
            timed(name, shape, n_live, r, f_pairs, ext,
                  lambda sp=compact.SPLIT_SLOTS: [
                      compact.compact_substep_cuda(
                          sf.frame, mid, phys, r, cap, xs, al, pj, scal_f,
                          sf.band, occ_cum=occ, split=sp)
                      for sf, mid, pj, occ in ins],
                  lambda: [compact.compact_substep_plain(
                      sf.frame, mid, phys, r, xs, al, sf.band)
                      for sf, mid, _, _ in ins],
                  s_cells=cells, n_dead=n_dead)

    # ---- 10. the JAX package's default backend and its export path
    from sphfluidsimulation_torch import make_dt_rollout, make_param_step
    from sphfluidsimulation_torch.ops import grid
    from sphfluidsimulation_torch.native import build as native_build
    from sphfluidsimulation_torch.render import export, meshprops, viewer

    def no_kernel(label):
        read_launches(label, zero)

    calm = SimConfig(particle_number=1024, bucket_resolution=11, preset=0,
                     gas_constant=20.0, rest_density=1.7, viscosity=0.05,
                     stiffness_coefficient=1000.0, frame_dt=1 / 240)
    with Phase("exact tiers: calm 1k"):
        for cfg, tiers in ((calm, ("slotted", "gather")),
                           (calm.replace(xsph=0.3, artificial_viscosity=0.4),
                            ("slotted",))):
            s0 = initial_state(cfg, dev)
            for faithful in (True, False):
                b, mb = make_rollout(cfg, 3, neighbor="brute",
                                     faithful=faithful, device=dev)(s0)
                for tier in tiers:
                    sk.reset_launch_counts()
                    a, ma = make_rollout(cfg, 3, neighbor=tier,
                                         faithful=faithful, device=dev)(s0)
                    torch.cuda.synchronize()
                    no_kernel(f"the {tier} path")
                    e = float((a.pos - b.pos).abs().max())
                    print(f"calm 1k {tier}, xsph {cfg.xsph}, alpha "
                          f"{cfg.artificial_viscosity}, faithful={faithful}:"
                          f" vs brute max |dpos| {e:.3e} over 3 frames (< "
                          f"{ORACLE_ATOL:g}); overflow {ma.overflow.tolist()}"
                          f" vs {mb.overflow.tolist()}", flush=True)
                    if not e < ORACLE_ATOL or not torch.equal(ma.overflow,
                                                              mb.overflow):
                        fail(f"the {tier} tier leaves the brute oracle "
                             f"(faithful={faithful}, xsph {cfg.xsph})")

    with Phase("exact tiers: 262k and config 3"):
        cfg, st0 = sizes["262k"], states0["262k"]
        bucket, _ = grid.build_bucket(st0.pos, cfg.bucket_resolution,
                                      cfg.voxel_capacity)
        table_ovf = int(grid.overflow_count(bucket))
        rates = {}
        for tier in ("sorted", "slotted", "gather"):
            roll = make_rollout(cfg, 3, neighbor=tier, device=dev)
            roll(st0)                # warm-up; the sorted tier's records it
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final, m = roll(st0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rates[tier] = cfg.n_particles * cfg.substeps * 3 / dt
            ovf1 = int(m.overflow[0])
            print(f"262k {tier}: 3 frames from the spawn in {dt:.4f} s = "
                  f"{rates[tier]:.6g} particle-substeps/s ({rates[tier] / rates['sorted']:.4f} "
                  f"of the sorted tier's); frame-1 overflow {ovf1} (voxel "
                  f"table {table_ovf}); overflow per frame "
                  f"{m.overflow.tolist()}, non-finite position rows "
                  f"{int((~torch.isfinite(final.pos)).any(1).sum())} "
                  f"[{ident}]", flush=True)
            if tier != "sorted" and ovf1 != table_ovf:
                fail(f"262k {tier}: frame-1 overflow {ovf1}, the voxel "
                     f"table's {table_ovf}")
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        final, m = make_rollout(c3, 3, neighbor="slotted", device=dev)(
            c3_state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        no_kernel("the slotted config 3 path")
        pos = final.pos
        inside = bool(((pos >= 0) & (pos <= 1)).all())
        print(f"config 3 slotted with extensions, 3 frames from the spawn "
              f"in {dt:.4f} s = {c3.n_particles * c3.substeps * 3 / dt:.6g} "
              f"particle-substeps/s: positions in [0, 1] {inside}, overflow "
              f"{m.overflow.tolist()}, max_speed "
              f"{[float(f'{x:.4g}') for x in m.max_speed.tolist()]} "
              f"[{ident}]", flush=True)
        if not inside:
            fail("config 3 slotted: positions outside [0, 1]")

    with Phase("calm pin"):
        with np.load(os.path.join(root, "tests", "data",
                                  "calm1024_pin_r2.npz")) as z:
            pin = torch.from_numpy(z["f100"]).to(dev)
        for tier in ("sorted", "slotted"):
            final, m = make_rollout(calm, 100, neighbor=tier, device=dev)(
                initial_state(calm, dev))
            d = (final.pos.double() - pin.double())
            rmse, mx = float(d.pow(2).mean().sqrt()), float(d.abs().max())
            cert = int(m.exact_cert.sum())
            print(f"calm pin f100, {tier}: RMSE {rmse:.4e} (< {PIN_RMSE:g}),"
                  f" max {mx:.4e} (< {PIN_MAX:g}), exact_cert {cert} "
                  f"[{ident}]", flush=True)
            if not (rmse < PIN_RMSE and mx < PIN_MAX and cert == 0):
                fail(f"the calm pin on the {tier} tier")

    with Phase("dt replay 262k"):
        cfg, st0 = sizes["262k"], states0["262k"]
        nf = len(DT_SCHEDULE)
        roll = make_dt_rollout(cfg, nf, device=dev)
        roll(st0, DT_SCHEDULE[:1] * nf)                         # warm-up
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        final, m = roll(st0, DT_SCHEDULE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        read_launches("the dt replay", dict(zero, density=nf,
                                            fused_substep=5 * nf))
        step = make_param_step(cfg)
        base = PhysParams.from_config(cfg, dev)
        div = torch.tensor(cfg.substep_divisor, dtype=torch.float32,
                           device=dev)
        st = st0
        for d_f in DT_SCHEDULE:
            st, _ = step(st, base._replace(dt=torch.tensor(
                d_f, dtype=torch.float32, device=dev) / div))
        bits = all(same_bits(a, b) for a, b in zip(final, st))
        print(f"dt replay 262k, {nf} frames of {DT_SCHEDULE}: {dt:.4f} s, "
              f"bit-equal to stepping frame by frame {bits}; exact_cert "
              f"{m.exact_cert.tolist()} [{ident}]", flush=True)
        if not bits:
            fail("the dt replay leaves per-frame stepping")

    with Phase("snapshots 262k"):
        cfg, st0 = sizes["262k"], states0["262k"]
        sk.reset_launch_counts()
        final, m, snaps = make_rollout(cfg, 10, snapshot_every=5,
                                       device=dev)(st0)
        torch.cuda.synchronize()
        read_launches("the snapshot rollout", dict(zero, density=10,
                                                   fused_substep=50))
        sk.reset_launch_counts()
        plain, _ = make_rollout(cfg, 10, device=dev)(st0)
        torch.cuda.synchronize()
        read_launches("the rollout without snapshots",
                      dict(zero, density=10, fused_substep=50))
        ok = (snaps.shape == (2, cfg.n_particles, 3)
              and same_bits(snaps[1], final.pos)
              and all(same_bits(a, b) for a, b in zip(final, plain)))
        print(f"snapshots 262k, every 5 of 10 frames: {tuple(snaps.shape)}, "
              f"the last the final positions and the final state bit-equal "
              f"to the rollout without snapshots: {ok}", flush=True)
        if not ok:
            fail("the snapshot rollout")

    with Phase("render 262k"):
        cfg = sizes["262k"]
        rp = meshprops.RenderParams.from_config(cfg, dev)
        nan_mask = final.nan_count > 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mat, col = meshprops.mesh_properties(final.pos, final.vel, rp,
                                             nan_mask)
        torch.cuda.synchronize()
        t_mesh = time.perf_counter() - t0
        mat_c, col_c = meshprops.mesh_properties(
            final.pos.cpu(), final.vel.cpu(),
            meshprops.RenderParams.from_config(cfg), nan_mask.cpu())
        e_mesh = max(float((a.cpu() - b).abs().max())
                     for a, b in ((mat, mat_c), (col, col_c)))
        out_dir = os.path.join(root, "build", "render")
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        img = export.render_frame_png(final.pos.cpu().numpy(),
                                      col.cpu().numpy(),
                                      sim_scale=cfg.sim_scale,
                                      particle_radius=cfg.particle_radius)
        png = os.path.join(out_dir, "frame.png")
        export.save_png(png, img)
        t_png = time.perf_counter() - t0
        t0 = time.perf_counter()
        html = viewer.export_html_viewer(
            os.path.join(out_dir, "viewer.html"), snaps.cpu().numpy(),
            torch.linalg.vector_norm(final.vel, dim=-1).expand(
                snaps.shape[0], -1).cpu().numpy(),
            sim_scale=cfg.sim_scale, low_speed=cfg.low_speed,
            high_speed=cfg.high_speed)
        t_html = time.perf_counter() - t0
        print(f"render 262k: mesh_properties {t_mesh:.6f} s on the card "
              f"(max |card - cpu| {e_mesh:.3e}, < 1e-6); PNG "
              f"{os.path.getsize(png)} bytes in {t_png:.4f} s (rasteriser "
              f"{'native' if native_build.load_framecodec() else 'numpy'}); "
              f"viewer HTML {os.path.getsize(html)} bytes in {t_html:.4f} s "
              f"[{ident}]", flush=True)
        if not e_mesh < 1e-6:
            fail("mesh_properties on the card leaves the CPU's")

    # ---- 11. the probes (sphfluidsimulation_torch/probes), each through
    # its entry point with the probe counters reset before it: every probe
    # kernel held to its plain version at the scripts' full sizes (the
    # loopstruct frame form on the 262k frame-10 state of phase 4), then
    # the planted controls, which must fail their rules
    from sphfluidsimulation_torch import probes
    from sphfluidsimulation_torch.probes import compact as p_compact
    from sphfluidsimulation_torch.probes import intops as p_intops
    from sphfluidsimulation_torch.probes import loopstruct as p_ls
    from sphfluidsimulation_torch.probes import mxu as p_mxu

    with Phase("probes"):
        probe_runs = {}
        probes.reset_launch_counts()
        for name in probes.NAMES:
            if name == "compact":
                continue
            t0 = time.perf_counter()
            kw = {"state": states["262k"]} if name == "loopstruct" else {}
            probe_runs[name] = probes.run(name, dev, **kw)
            print(f"probe {name}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        probe_launches = dict(probes.launch_counts)
        print(f"launches in the probes: {probe_launches}", flush=True)
        for name, res in probe_runs.items():
            if not res["ok"]:
                fail(f"probe {name}: a kernel disagrees with its plain "
                     f"version")
            for k in res["kernels"]:
                if not probe_launches.get(k):
                    fail(f"probe kernel {k} was not launched")
        # compact: the one-step check of its script (no kernel of its own;
        # its bench stages are phase 4's rates), and what one run can show
        # of why its routes differ
        if not p_compact.checks(dev)["explained"]:
            fail("probe compact: the routes' difference is not the compact "
                 "route's certified rows")
        # planted controls
        st3 = [st for st in p_intops.stages() if st.stage == 3][0]
        a3, b3 = p_intops.inputs_on(st3, dev)
        bad = p_intops.stage_cuda(3, a3, b3, shift=9)
        if np.array_equal(bad.cpu().numpy(), st3.truth):
            fail("planted control passed: intops stage 3 with a shift of 9")
        opened = p_ls.gate_open(p_ls.to_device(
            p_ls.synth_inputs(np.random.RandomState(0)), dev))
        bad = p_ls.synth_cuda("A", p_ls.drop_line(opened))
        if p_ls.synth_rule("A", p_ls.synth_plain("A", opened), bad, opened):
            fail("planted control passed: loopstruct A with a line dropped")
        # mxu's, launched by its run beside their instances
        mxu_controls = probe_runs["mxu"]["controls"]
        if len(mxu_controls) != sum(map(len, p_mxu.CONTROLS.values())):
            fail("probe mxu: a planted control did not run")
        for label, n_over in mxu_controls.items():
            if not n_over:
                fail(f"planted control passed: mxu {label}")
        print(f"planted controls fail as they must: intops stage 3 with a "
              f"shift of 9, loopstruct A with a line dropped, mxu "
              f"{', '.join(mxu_controls)} [{ident}]", flush=True)

    # ---- 12. config 5, the sites tier, the sites slab step, the domain
    # step and entry()
    phase12(dev, ident, read_launches, hold_density, hold_out, zero, sizes,
            os.path.join(root, "build", "phase12"))

    # ---- 13. the graph rollout against the host loop
    phase13(dev, ident, read_launches, zero, sizes, c3, k5, states0,
            c3_state)

    # the main shape of each kernel's path first; the others as ms_<shape>
    main_shape = {"density": "262k", "fused_substep": "262k",
                  "fused_substep_ext": "c3", "forces": "c3",
                  "compact_density": "262k", "compact_substep": "262k",
                  "compact_substep_ext": "c3", "compact_forces": "262k",
                  "density_band": "262k_slab",
                  "fused_substep_band": "262k_slab",
                  "fused_substep_ext_band": "c3_slab",
                  "compact_density_band": "262k_slab",
                  "compact_substep_band": "262k_slab",
                  "compact_substep_ext_band": "c3_slab",
                  "density_scenes": "c5", "fused_substep_scenes": "c5",
                  "fused_substep_ext_scenes": "c3x2",
                  "forces_scenes": "c5", "forces_ext_scenes": "c3x2",
                  "compact_density_scenes": "c5",
                  "compact_substep_scenes": "c5",
                  "compact_substep_ext_scenes": "c3x2",
                  "compact_forces_scenes": "c5",
                  "density+kahan": "262k", "bf16_candidates": "c3",
                  "frame_record": "c3"}
    main_shape.update({f"{name}+{tag}": "262kx2" for name, tags in (
        ("density_scenes", ("kahan",)),
        ("fused_substep_scenes", ("facc0", "kahan", "bf16")),
        ("compact_substep_scenes", ("bf16",))) for tag in tags})
    for name in KERNELS:
        if "+" in name and name not in main_shape:
            at_c3 = name.startswith(("fused_substep_ext",
                                     "compact_substep_ext", "forces"))
            main_shape[name] = "c3" if at_c3 else "262k"
    slab_text = (f", {SLAB_D} slabs: the sum of one launch on each shard's "
                 f"frame after {SLAB_FRAMES} slab frames")
    shape_text = {"262k": "262144 particles, R = 47",
                  "1m": "1048576 particles, R = 75",
                  "c3": "config 3: 524176 particles, R = 47, XSPH 0.3, "
                        "alpha 0.5",
                  "262k_slab": "262144 particles, R = 47" + slab_text,
                  "c3_slab": "config 3" + slab_text,
                  "c5": f"config 5: {C5_SCENES} scenes x 524176 particles, "
                        f"R = 47, one launch over the scenes",
                  "c3x2": "2 scenes of config 3's physics x 524176 "
                          "particles, R = 47, one launch over the scenes",
                  "262kx2": "2 scenes x 262144 particles, R = 47, rest "
                            "density 1.0 and 2.0, frame 0, one launch over "
                            "the scenes"}
    record = {"kernels": []}
    for name, (_, file, replaces) in KERNELS.items():
        main = main_shape[name]
        ms, pm, b_ms, b_by = times[name][main]
        rec = {"name": name, "route": "cuda",
               "source": f"sphfluidsimulation_torch/csrc/{file}",
               "replaces": f"sphfluidsimulation_tpu/ops/{replaces}",
               "launches": launches_total[name], "max_abs_err": errs[name],
               "ms": ms, "plain_ms": pm, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None, "shape": shape_text[main]}
        for other, (ms, pm, b_ms, b_by) in times[name].items():
            if other != main:
                rec.update({f"ms_{other}": ms, f"bound_ms_{other}": b_ms,
                            f"bound_by_{other}": b_by})
                if pm is not None:
                    rec[f"plain_ms_{other}"] = pm
        record["kernels"].append(rec)
    for res in probe_runs.values():
        for name, k in res["kernels"].items():
            record["kernels"].append({
                "name": f"probe_{name}", "route": "cuda",
                "source": k["source"], "replaces": k["replaces"],
                "launches": probe_launches[name],
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                "library": k["library"]})
    print(json.dumps(record), flush=True)
    print(ident, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
