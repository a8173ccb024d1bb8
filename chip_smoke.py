#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--other OTHER_ROOT] [--kernels]

1. Prints the card (nvidia-smi name and power limit), builds the kernels
   from ``seamlesscloneoptimization_tpu_torch/csrc`` and prints the build
   time, ptxas's resource report and both TF32 flags.
2. Holds each of the twenty-eight kernels against its plain PyTorch twin on
   the card: every kernel bit-exact over its whole output (the divides too: the
   twin's divide is IEEE on the card as well; the kernels are built with
   -fmad=false, so the multigrid's float arithmetic rounds as the twin's
   separate ops do). The DST kernels run at the shapes of the headline
   serve frame (a 2400x1552 full-mask patch into a 4800x2694 destination,
   bench.py's geometry): the slice-1 kernels on the unfolded chain's
   tensors, the folded chain's kernels on the pair chain's;
   ``clamp_cast_paste`` also at 8K, from the ``"t"`` chain's slab
   (3, 2816, 3840) and from an exact-size solution (3, 2798, 3798), whose
   rows alternate between 16-byte aligned and 8 bytes off
   (``slab_8k_*``, ``exact_8k_*``), planar and interleaved;
   ``unfold_minor`` also at the per-axis strips' shape, the one its serve
   launch had before the per-axis route took the fused kernels
   (``strips``), and ``transpose_pair`` (strip H's plain form, strip W's
   divide), ``unfold_transpose`` (strip H) and ``unfold_clamp_paste``
   (strip W) at the shapes of the strips' serve launches (``strips``, each
   with its path, bound and, from the strips' profiles, ``loop_ms``). The
   multigrid
   kernels run at the 8K frame's (a 3802x2802 full-mask patch into a
   7680x4320 destination: interior 2798x3798, 10.6 MP): the fine level
   (3, 2816, 3840) and the first transposed coarse level (3, 1920, 1408,
   betas 1.5, known-zero guess); the quarter-plane kernels at its quarter
   planes (3, 4, 1408, 1920) and transposed coarse RHS (3, 1920, 1408):
   the dense <-> quarter conversions at the footprint (3, 2816, 3840), the
   descent in its fused and split forms, the split form's restriction
   (equal to the fused rc_t), the ascent with and without its residual.
   Slice 4a's at the headline: ``preprocess_rhs_p`` at the exact interior
   size (its own kernels-line entry, ``preprocess_rhs_p_exact``),
   ``postprocess_transposed`` on the DST-GEMM solve's transposed interior
   (planar and interleaved, at ROI widths 128, 251, 256, and one row
   short, h2 % 4 != 0: the ragged route, ``ragged_*``), ``rb_sweeps``
   for 1, 2, 3, 4 and 6 sweeps (two launches), at the 8K interior and on a
   97x131 grid. Slice 8a's: ``rb_sweeps_tile`` on the 8K DD tiles
   (3, 1412, 1912) (a 2x2 mesh over the 2800x3800 padded interior, a 6-px
   ghost band) at the four tiles' origins, 1 and 2 sweeps, an odd origin
   and a domain cutting the tile (5 sweeps, two launches); slice 8c's
   window form of ``rb_sweeps_tile`` (its own kernels-line entry,
   ``rb_sweeps_tile_window``) on the four bands of a ghosted headline tile
   (a 2x2 mesh over the 1548x2396 interior) at halos 2, 4 and 8 (bands of
   6, 12 and 24), every tile's origins, the round's sweeps and 5 (two
   launches), an odd origin and a domain clipping the bands; the exact-size
   ``mg_down`` (known-zero and given guess) and ``mg_up`` at the DD coarse
   solve's two fused levels (1398x1898 and 698x948, betas != 1), each form
   its own kernels-line entry (``mg_down_exact``, ``mg_up_exact``);
   ``mg_down`` / ``mg_up`` at the 8K dense chain's coarse levels on
   ``mg_geometry``'s slabs ((3, 1440, 1920) and (3, 800, 1024),
   ``dense_levels``; its fine level is the 8K slab above); and
   at each of the 8K ``"q"`` chain's three fused coarse levels
   (``coarse_levels``, each with its bound) ``mg_up`` / ``mg_down``, the
   transfers ``mg_restrict_t`` / ``mg_prolong_t`` and the fused forms that
   ``vcycle_t`` runs, ``mg_down_t`` (mg_down + mg_restrict_t) and
   ``mg_up_t`` (mg_prolong_t + mg_up), also at the 8K fine level and its
   first coarse level: each fused form bit-exact against its twin and
   against the unfused pair, and timed with the pair beside it
   (``pair_ms``, ``pair_b2b_ms``). Times kernel,
   twin and, where one PyTorch call computes the same function, that call
   (``library_ms``; the port never calls it), each launch cold in L2 with
   the card spinning while the host issues it (so the time is the
   device's); the redesigned kernels also back to back (``b2b_ms``) and,
   from the profiles of the 8K ``"q"`` frame and of the pair chain, in
   the loop (``loop_ms``: device time per launch in the served frame, per
   coarse level by launch order; the standalone level kernels and
   transfers from the same frame profiled with the four-kernel chain,
   ``vcycle_t_unfused``); and one GEMM of each chain. ``prep_mask`` (the
   engine's mask prep, no TPU counterpart) at the headline's full and
   elliptic masks and the 8K patch's, into a new tensor and in place, cold,
   back to back and in the pair and ``"q"`` engines' ``run`` requests.
3. Drives each path through the entry points with the launch counters set
   to 0 just before and read just after, and checks every kernel's
   per-frame count (``PATHS``; every ``vcycle_t`` level of the ``"t"`` and
   ``"q"`` chains is one ``mg_down_t`` and one ``mg_up_t`` a cycle, and no
   path launches ``mg_restrict_t`` or ``mg_prolong_t``) and the engine's
   ``prep_mask`` launches (one a request, ``less_preps``), that nothing
   outside the ROI interior changed, and the card against the same port
   on the CPU (the plain twins), diff_max <= 1:
   - ``pair``: ``CloneConfig()`` (``dst_folded=True``) at the headline,
     20 chained ``timed_serve`` frames and one single-shot ``run`` into the
     interleaved destination; the Poisson residual of one folded
     ``solve_dst_gemm_pl``; a profile of the serve frame (device time by
     kernel and group, GEMMs per frame, idle share);
   - ``unfolded``: ``CloneConfig(dst_folded=False)`` at the headline, the
     same, with its own profile;
   - ``per_axis_w`` and ``per_axis_h``: the default config on a 126x2400
     and a 2400x126 strip (only the long side folds, joined through the
     pair chain's kernels: strip W ends in ``unfold_clamp_paste``, strip H
     runs ``unfold_transpose`` and ``clamp_cast_paste``; no
     ``unfold_minor``), each with its profile and the same frame served on
     the parent's unfused chain from the same kernels (``torch.cat``,
     ``transpose``, ``unfold_minor``, ``clamp_cast_paste``; no path counts
     those launches): busy us a frame both ways, pasted bytes equal;
   - ``mg_t``: ``CloneConfig(mg_padded="t")`` at 8K, where ``auto``
     resolves to multigrid: 10 chained frames and one single-shot run in
     tolerance mode (1e-4; every V-cycle kernel a multiple of the 4 fused
     levels, and the single run's quotient equal to the cycles that
     ``solve_multigrid(return_info=True)`` reports on the same RHS, whose
     relative residual must be <= tol), then with ``mg_cycles=4`` (each
     V-cycle kernel 4 levels x 4 cycles a frame); a profile of the serve
     frame; no CPU comparison at this size;
   - ``mg_t_headline``: ``solver="multigrid", mg_padded="t"`` at the
     headline (3 fused levels), with the card against the CPU;
   - the serve times of the pair chain and of the ``"t"`` multigrid at the
     headline and at 8K, the first H100 data on the auto crossover;
   - ``mg_q``: ``CloneConfig()`` at 8K, where ``auto`` resolves to the
     default quarter-plane multigrid (3 fused coarse levels): tolerance
     mode, the single run's cycles (its mg_ud_q launches) equal to those of
     ``solve_multigrid`` on the same quartered RHS, whose dense relative
     residual must be <= tol; ``mg_q_fixed`` the same with ``mg_cycles=4``;
     profiles of both; ``mg_q_headline``: ``solver="multigrid"`` at the
     headline with the card against the CPU, its profile, and the host's
     issue time of a 4-cycle solve against the card's time for it, with
     the fused transfers and with the four-kernel chain, in turns;
   - ``mg_q_coarse``: ``CloneConfig(tol=0.05)`` at 8K, where no check-free
     cycle comes first and the check-first loop runs (per cycle the split
     mg_down_q, mg_restrict_tq, the coarse levels, mg_prolong_tq and
     mg_up_q with its residual), its single run's cycles equal to those
     ``solve_multigrid`` reports for the dense RHS (relative residual <=
     0.05), its profile; ``mg_q_coarse_headline``: ``solver="multigrid",
     tol=0.05`` at the headline with the card against the CPU, its profile;
   - ``mg_dense``: ``solve_multigrid`` on the dense 8K RHS (to_quarters in,
     from_quarters out) at tol 1e-4 with ``return_info`` (its cycles those
     of the born-quartered solve), ``padded_output=True`` (exact zeros
     outside the domain), and warm-started from the tol 0.05 solution
     (to_quarters twice, fewer cycles);
   then ``seamless_clone`` on a small irregular mask in all three modes;
   - ``jacobi``: ``CloneConfig(solver="jacobi")`` at the headline, a
     single run and 2 chained frames (tol 1e-4 ends a frame, at 5500
     sweeps on an H100: 110 bursts; 10 000 is only the cap), ``rb_sweeps``
     13 launches per burst of 50 sweeps (1430 a frame); the run's RHS solved with the kernel and with plain sweeps
     on the card, bit-equal with equal iterations, and the run's image
     equal to the plain solve pasted;
   - ``jacobi_small``: the same on a 66x66 patch that converges, the card
     against the CPU (diff_max <= 1, equal iterations);
   - ``dst_fft``: ``CloneConfig(solver="dst_fft")`` at the headline, card
     against the CPU and against the pair chain's image (diff_max <= 1),
     the relative residual;
   - ``mg_element``: ``solve_multigrid(nu2=6, use_pallas=True)`` on the
     headline RHS, the element V-cycles with the fine ascent one
     ``rb_sweeps`` burst of 2 launches a cycle, cycles equal to the CPU's,
     relative residual <= tol;
   - ``dst_post_t``: ``CloneConfig(use_pallas_preprocess=False)`` at the
     headline, the plain RHS, the transposed DST-GEMM solve and
     ``postprocess_transposed`` once a frame, card against the CPU;
   - ``tiled_dd``: ``TiledSeamlessClone(CloneConfig())`` on a 2x2 mesh of
     the one card at 8K, tol 1e-4: per frame clamp_cast_paste 1 a tile
     (the per-tile plain RHS, the DD solve on tiles, the paste into each
     cell's destination tile), per cycle rb_sweeps_tile 2 a tile and
     mg_down / mg_up once per fused coarse level (2); the single run's
     cycles equal to those ``solve_poisson_dd(return_info=True)`` reports
     on its RHS, relative residual <= tol; serve ms beside the single-card
     ``"q"`` frame; the resident frames profiled (tolerance and
     ``mg_cycles=4``);
     ``tiled_dd_fixed`` ``mg_cycles=4``; the 1x1 mesh byte for byte
     ``SeamlessClone(CloneConfig())``; ``tiled_dd_headline`` the 2x2 serve
     at the headline, card against the CPU mesh (1 fused coarse level);
   - ``rb_tiled``: ``solve_redblack_tiled`` on the headline interior, 1000
     sweeps at tol 0, the kernel route bit-equal to the plain sweeps on the
     card, 500 rounds x 4 tiles launches; a 62x62 solve to tol 1e-4, card
     against the CPU mesh (equal sweeps); slice 8c's ``rb_overlap``: the
     interior-first schedule (``overlap=True``) against the plain one at
     tol 0, in turns (plain, overlap, overlap, plain), at the headline at
     halos 4 and 8 (200 sweeps), at 8K (40) and on a 256x256 grid at halo
     8 (200; 128x128 tiles): bit-equal, rb_sweeps_tile rounds x 4 tiles x
     5 x ceil(s / 4) launches (four fifths of them the window form)
     against rounds x 4 x ceil(s / 4), ms a sweep for each; one overlap
     round profiled, its device ops by stream (the sweeps on one stream,
     the strip copies and zero fills on another) (the ``rb_overlap`` JSON
     line);
   - ``mg_padded_false``: ``CloneConfig(solver="multigrid",
     mg_padded=False)`` at the headline, the element V-cycle with its 2
     fused levels (mg_down / mg_up a level a cycle), card against the CPU,
     cycles equal to ``solve_multigrid``'s report.
   - ``mg_padded_true`` (slice 4b): ``CloneConfig(mg_padded=True)`` at
     8K through ``auto``, the dense rounded V-cycle ``vcycle_p`` with its 3
     fused levels on ``mg_geometry``'s slabs (mg_down / mg_up a level a
     cycle; erode3, the exact-size preprocess_rhs_p and clamp_cast_paste
     once), tolerance 1e-4: the single run's cycles equal to those
     ``solve_multigrid(padded=True, return_info=True)`` reports on its RHS,
     relative residual <= tol; ``mg_padded_true_fixed`` ``mg_cycles=4``
     (exact counts); profiles of both; ``mg_padded_true_headline``
     (``solver="multigrid"``, 2 fused levels) card against the CPU and its
     single run bit-equal to ``mg_padded_false``'s;
   - ``mg_fmg`` and ``mg_pcg``: ``solve_multigrid(fmg_start=True)`` (the
     default ``"q"`` chain: the cascade's element V-cycles, 1 + 2 fused
     levels, then the check-first loop from it) and ``pcg=True`` (one
     element V-cycle, 2 fused levels, to start and one an iteration) on
     the headline RHS at tol 1e-4: cycles / iterations equal to the CPU's,
     residual <= tol, exact counts, fmg's cycles <= the zero start's;
   - ``prec_<mode>`` (slice 4c): ``CloneConfig(precision=mode)`` for each
     bf16 mode (default, 2x_img, 2x_v, fwd2x, inv2x) at the headline, the
     pair chain's launches; the card's solve of the frame's RHS as far from
     FP32's as the CPU path's in the same mode (within 5%); the chain's 8
     GEMM products in the mode timed back to back, a profile of each
     mode's frame and of FP32's beside it, and each mode's single run's
     diff_max against FP32's and against the CPU path (the
     ``precision_modes`` JSON line);
   - slice 5, bucketed serving (``bbox_bucket=128``) on seeded ellipse
     masks whose tight bbox is a multiple of 128 on neither side:
     ``bucket_exact_headline`` (``bucket_exact=True``, tight 1401x2201 in
     the bucket 1408x2304 of the headline frame, tol 1e-4): the tight
     system's runtime-domain multigrid, erode3, the exact-size
     preprocess_rhs_p and clamp_cast_paste once a frame, mg_down / mg_up
     once per fused dyn level (2) a cycle; card against the CPU, the
     single run's cycles equal to those ``solve_dyn_window`` reports on
     the card and on the CPU for its RHS, a served frame equal to run(),
     diff_max against the tight unbucketed dst_gemm frame;
     ``bucket_exact_8k`` (tight 2601x3601 in 2688x3712, 3 fused levels):
     cycles against the report, relative residual <= tol;
     ``bucket_grown_headline`` (the pair chain on the 1406x2302 bucket
     interior; three tight bboxes in the one bucket leave one cached set
     of DST bases), ``bucket_grown_post_t`` (``use_pallas_preprocess=
     False``: postprocess_transposed's ragged route, h2 % 4 = 2), both card
     against the CPU, and ``bucket_grown_8k`` (2686x3710, 9.97 MP: the
     ``"q"`` chain, cycles against the solve of its RHS); each with its
     profile (busy, idle share, torch ops a frame; the ``bucket_paths``
     JSON line) and its kernels' in-the-loop times on the kernels line;
   - slice 6, the batch and the edits, on a seeded 3840x2160 destination:
     ``batch_64_4k`` (64 seeded 136x136 patches whose ellipses have a
     128x128 tight bbox, one per cell of an 8x8 grid, no overlap: one
     "exact" group) through ``seamless_clone_batch_fused`` on the plain
     route (clamp_cast_paste 1 a call) and as ``batch_64_4k_pallas``
     (``use_pallas=True``: erode3 64, preprocess_rhs_p 64, clamp_cast_paste
     1), each card against the CPU and against 64 sequential
     ``seamless_clone`` calls on the card (diff_max <= 1), the device step
     timed (a warm-up, then 5 steps with CUDA events) and profiled (busy,
     idle share, torch ops a step); ``batch_mixed_4k_{exact,pad,pad_exact}``
     (64 jobs of seeded tight sides 96-128, 8 of them moved onto their
     right neighbour): each route card against the CPU, its steps timed
     and, in each overlap, the later job's whole window in the destination
     (its ring the destination its group found, the window within 1 of the
     job's step alone; bit-equal with pad_exact); pad_exact on the first 16
     jobs when its phase would pass 30 s, and at tol 1e-6 within 1 of the
     sequential calls on the jobs that overlap none; ``edit_color_1080p``
     and ``edit_texture_1080p`` (1920x1080, the direct route: clamp_cast_paste
     1; the host Canny timed apart) card against the CPU;
     ``edit_color_4k`` and ``edit_illumination_4k`` (the 8.28 MP interior
     on the "q" chain: to_quarters 1, from_quarters 1, mg_ud_q and
     mg_prolong_tq a cycle, clamp_cast_paste 1), the cycles equal to those
     ``solve_multigrid(return_info=True)`` reports on the same RHS, its
     relative residual <= 1e-5; ``edit_tiled`` (``local_edit_tiled`` of the
     colour change on a 2x2 mesh of the card at 1080p: rb_sweeps_tile 2 a
     tile a cycle, clamp_cast_paste 1 a tile) within 1 of ``color_change`` on the
     card (the ``batch_paths`` and ``edit_paths`` JSON lines);
   - slice 7, the user surface on the ``pair`` frame's seeded headline
     src / dst / full mask: ``cli_headline`` (the inputs written as YAML,
     ``cli.main`` run in this process with ``--loops 5``: the pair chain's
     kernels (1 + 5) x a run; its ``ucRGB_Output.bmp`` and ``result.yml``
     bit-equal to the engine's run on the card and within 1 of the CPU
     path; the YAML reads and writes timed), ``cli_compare``
     (``compare.main`` on the CLI's BMP against the engine's image: every
     statistic 0; the g0.yml of a ``--debug-dump`` run against the CPU
     path's ``dump_stages`` g0.yml, abs_max <= 1e-3) and ``capi_headline``
     (``capi_host.build_library`` / ``build_test_program`` timed; the C
     program in a subprocess on device 0 with ``SC_TPU_PYTHONPATH`` the
     repo root and this interpreter's path: both its runs, the second from
     another pthread, bit-equal to the engine's; then the library loaded in
     this process through ctypes and one ``sc_tpu_run`` counted: the pair
     chain once) (the ``surface_paths`` JSON line);
   - slice 8, ``path="gspmd"`` (``solve_multigrid_sharded``, the element
     V-cycle partitioned over the mesh) on the 2x2 mesh of the card:
     ``tiled_gspmd`` (``TiledSeamlessClone(CloneConfig(tol=1e-4),
     path="gspmd")`` at 8K: clamp_cast_paste once a tile a frame, rb_sweeps_tile
     2 a tile a cycle on its one plain level; its serve ms/frame, cycles,
     launches, a 2-frame profile's idle share and torch ops; the solve of
     the frame's RHS bit-equal to the card's single-device element solve
     ``solve_multigrid(use_pallas=False)`` with equal cycles, those of the
     single run, relative residual <= tol), ``tiled_gspmd_fixed`` (the same
     with ``mg_cycles=4``, exact counts), ``edit_tiled_gspmd``
     (``local_edit_tiled(path="gspmd")`` of the colour change at 1080p,
     within 1 of the DD path's) and ``dist_2proc`` (two processes on the
     card, ``parallel/dist_check.py``, joined by ``init_distributed`` over
     gloo, two tiles each of a 2x2 mesh: ``solve_poisson_dd`` and
     ``solve_multigrid_sharded`` at tol 1e-4 on the 8K RHS, each run twice,
     bit-equal to the single-process 2x2 mesh; ms a solve, the transfers
     and bytes a cycle that cross to the other rank, the backend; slice
     8c: ``solve_redblack_tiled`` at halo 4 in both schedules, 400 sweeps
     and one round (ms a sweep past the round: the solve's final gather
     takes most of a short one), each rank bit-equal to one process, the
     overlap round profiled in each rank: the D2H staging on a stream
     other than the sweeps')
     (the ``slice8_paths`` JSON line);
   - slice 8b, the mesh-resident tiled pipeline on the 2x2 mesh of the
     card: ``tiled_dd``, ``tiled_dd_fixed``, ``tiled_gspmd`` and
     ``tiled_gspmd_fixed`` serve that engine at 8K, and each also checks
     its resident frame (``resident_check``: a profiled frame's idle share
     and torch ops, clamp_cast_paste once a tile a frame and rb_sweeps_tile
     a frame, each cell's resident bytes, no gather in the timed frames
     (``parallel/mesh.py:GATHERS``), the chained result bit-equal to the
     single-device composition: the plain RHS, the whole-g
     ``solve_poisson_dd`` on the same mesh or ``solve_multigrid(...,
     use_pallas=False)``, the paste; the ``resident`` JSON object),
     ``bucket_exact_tiled``
     (``bucket_exact_8k``'s ellipse: ``solve_multigrid_dyn_sharded``
     bit-equal to ``solve_multigrid_dyn(use_pallas=False)`` with equal
     cycles, the frame bit-equal to its single-device composition and within
     1 of ``bucket_exact_8k``), ``batch_64_4k_mesh`` (``batch_64_4k``'s jobs
     in 4 blocks over the mesh, ``clone_roi_batch(mesh=...)``: bit-equal to
     ``batch_64_4k``), ``dist_2proc``'s engine (the resident engine's
     ``timed_serve`` at 8K in two processes, bit-equal on both ranks to the
     one-process mesh's; ms a frame, bytes a frame sent to the other rank)
     and ``dryrun_2x2`` (``dryrun_multichip``'s eight sub-checks) (the
     ``slice8b_paths`` JSON line).

With ``--other OTHER_ROOT`` (another checkout of this repository, for
example the parent commit unpacked with ``git archive``; only its
``csrc/`` is read), the sources of ``OTHER_KERNELS`` there are built with
the same nvcc flags and launched through the same wrappers in turns with
this checkout's (other, this, this, other): each kernel timed against
the other also gets ``other_ms`` / ``other_b2b_ms`` and whether the two
outputs are equal (``other_output_equal``); the SASS of each pair is
compared. The red-black rows carry it for one 4-sweep launch and, per
launch, for a 50-sweep burst (``in_burst_*``), rb_sweeps_tile for 2 and
1 sweeps (``one_sweep_*``); the 8K preprocess_rhs_p slab also carries
preprocess_rhs_q's times of the same call (``rhs_q_ms``), which reads the
same u8 inputs and writes as many bytes. A checkout without the fused transfers runs, in its turns,
``vcycle_t`` as the four-kernel chain (``vcycle_t_unfused``), and its time
for ``mg_down_t`` / ``mg_up_t`` is that of its unfused pair on the same
inputs. When every pair's outputs were equal, each path of
``COMPARE_PATHS`` (the headline DST frames, which run preprocess_rhs_t,
the multigrid and DD frames, and the jacobi and dst_fft frames, which
run rb_sweeps and the exact-size preprocess_rhs_p, and dst_post_t, which
runs postprocess_transposed) serves its frames in
turns with the two kernel sets (ms/frame, and from a profile the kernel
busy time, idle share and the in-the-loop time of each ``LOOP_PROFILE``
kernel the path profiles, ``other_loop_ms`` in the kernels line;
``PROFILE_PATH`` names the frame of a profile labelled otherwise), printed
as one JSON line
(``frames_vs_other``) before the kernels line.
An in-place kernel's outputs are compared on fresh copies of its
destination.
``--kernels`` stops after step 2 and prints the rows measured so far as
one JSON line (``kernels_only``, no launch counts, no result line): with
``--other`` pointing at a copy of the kernels with phases cut out, the
quick way to a kernel's cost split.

Prints the kernel table as one JSON line (one entry per kernel; the
``*_interleaved`` entries are the same kernel on the single-shot path's
interleaved destination, the ``*_exact`` ones the exact-size forms of
mg_down / mg_up; ``launches`` is the count of the path that runs
the kernel, ``launches_by_path`` every path's; for ``mg_dense`` the first
count is the tol 1e-4 solve's, the second the warm start's; for
``cli_headline`` the CLI's 1 + 5 runs), then, as the
last line,
``{"ok": true, "device": {...}}``. Every phase raises on failure; the
script exits non-zero, printing no result, when there is no CUDA card or
the port's package is missing. Images are synthetic, made from a seed.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
SRC_HW = (1552, 2400)
DST_HW = (2694, 4800)
SRC_8K = (2802, 3802)  # full mask: ROI 2800x3800, interior 2798x3798
DST_8K = (4320, 7680)
STRIPS = ((126, 2400), (2400, 126))  # per-axis branch: one side does not fold
SERVE_LOOPS = 20
MG_LOOPS = 10
STRIP_LOOPS = 5
REPS = 10
TOL = 1e-4  # CloneConfig's default
COARSE_TOL = 0.05  # a draft-quality tolerance: no check-free cycle (_tol_burst 0)
# slice 4c: the DST-GEMM precision modes with bf16 passes (the pair chain)
PRECISION_MODES = ("default", "2x_img", "2x_v", "fwd2x", "inv2x")
PRECISION_PATHS = {f"prec_{m}": m for m in PRECISION_MODES}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak HBM3 bandwidth
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# ~2 ms of spinning before a timed launch: the card starts the kernel only
# once the host has issued it, so the events time the device alone
SPIN_CYCLES = 4_000_000
KERNELS = ("erode3", "preprocess_rhs_t", "transpose", "clamp_cast_paste", "fold_minor",
           "unfold_minor", "transpose_pair", "unfold_transpose", "unfold_clamp_paste",
           "preprocess_rhs_p", "mg_down", "mg_up", "mg_restrict_t", "mg_prolong_t",
           "mg_down_t", "mg_up_t", "preprocess_rhs_q", "mg_down_q", "mg_up_q", "mg_ud_q",
           "mg_prolong_tq", "clamp_cast_paste_q", "to_quarters", "from_quarters", "mg_restrict_tq",
           "rb_sweeps", "postprocess_transposed", "rb_sweeps_tile")
# a fused vcycle_t level of the "t" and "q" chains: each of these once a cycle
MG_KERNELS = ("mg_down_t", "mg_up_t")
# the kernels folded into others: launched by no serve path, held against
# their twins in the kernel phase (the transfers into the fused levels;
# unfold_minor, the natural-order return of a solver-level call, into the
# per-axis route's transpose_pair, unfold_transpose and unfold_clamp_paste)
FOLDED = {"mg_restrict_t": "mg_down_t", "mg_prolong_t": "mg_up_t",
          "unfold_minor": "transpose_pair, unfold_transpose, unfold_clamp_paste"}
# a cycle of the check-first loop: each of these once
Q_CHECK_FIRST = ("mg_down_q", "mg_restrict_tq", "mg_prolong_tq", "mg_up_q")
JACOBI_SMALL_HW = (66, 66)  # full mask: interior 62x62, converges within max_iters
CHECK_EVERY = 50  # solve_redblack's sweeps between checks
RB_LAUNCHES_PER_BURST = -(-CHECK_EVERY // 4)  # rb_sweeps runs <= 4 sweeps a launch
JACOBI_LOOPS = 2  # a headline jacobi frame is thousands of sweeps
DD_MESH = (2, 2)  # slice 8a: four tiles of the one card
DD_TILES = DD_MESH[0] * DD_MESH[1]
DD_BAND = 6  # the DD multigrid's CA ghost band at nu = (1, 2)
RB_TILED_SWEEPS = 1000  # rb_tiled: a fixed count, tol 0
RB_TILED_HALO = 4  # solve_redblack_tiled's default: 2 sweeps an exchange
RB_OVERLAP_SWEEPS = 200  # slice 8c: each schedule at the headline and on small tiles
RB_OVERLAP_SWEEPS_8K = 40
RB_OVERLAP_CHECK = 40  # sweeps between checks: whole rounds at halos 4 and 8
RB_OVERLAP_SMALL = (256, 256)  # 128x128 tiles: latency-bound
# dist_2proc's solve_redblack_tiled runs (8K, halo 4): the solve's final
# gather (≈64 MB a rank over gloo) takes ≈370 ms, so the rounds' cost is read
# from the difference with a one-round solve of each schedule
DIST_RB_SWEEPS = 400
GSPMD_LOOPS = 3  # slice 8: path="gspmd" serve frames (host-bound, ~0.1-0.3 s each at 8K)
GSPMD_PLAIN_LEVELS = 1  # partitioned levels with betas 1 at 8K and 1080p (even interiors)
DIST_WORLD = 2  # dist_2proc: two processes on the one card, two tiles each
DIST_TIMEOUT = 300  # seconds for both ranks (start-up, two runs of each solve)
RESIDENT_LOOPS = 3  # slice 8b: bucket_exact_tiled's serve frames at 8K (host-bound)
DIST_ENGINE_LOOPS = 2  # dist_2proc's engine: timed frames after the warm-up
# slice 5: bbox_bucket=128 on seeded ellipse masks whose tight bbox is a
# multiple of 128 on neither side (the buckets' interiors then are 126 mod 128)
BUCKET = 128
BUCKET_BBOX, BUCKET_HW = (1401, 2201), (1408, 2304)  # headline: interior 1406 x 2302
BUCKET_BBOX_8K, BUCKET_HW_8K = (2601, 3601), (2688, 3712)  # 8K: interior 2686 x 3710
BUCKET_SIZES = ((1401, 2201), (1290, 2180), (1350, 2250))  # one headline bucket
# slice 6: the batch (64 jobs into a 4K destination, one a cell of an 8 x 8
# grid of 270 x 480 cells) and the edits
DST_4K = (2160, 3840)
BATCH_GRID = (8, 8)
BATCH_PATCH, BATCH_BBOX = (136, 136), (128, 128)  # batch_64_4k: one "exact" group
BATCH_STEPS = 5
MIXED_SIDES = (96, 128)  # batch_mixed_4k: seeded tight sides, inclusive
MIXED_SHIFT = 400  # a shifted job's centre moves this far toward its right neighbour
MIXED_OVERLAPS = 8
MIXED_EXACT_TOL = 1e-6  # pad_exact held against the sequential seamless_clone calls
# pad_exact's phase runs the entry point about PAD_EXACT_CALLS times: when
# that would pass PAD_EXACT_LIMIT_S on 64 jobs, it runs on the first 16
PAD_EXACT_LIMIT_S, PAD_EXACT_CALLS = 30.0, 6
EDIT_1080P = (1080, 1920)
EDIT_BBOX_1080P, EDIT_BBOX_4K = (701, 1201), (1401, 2401)
EDIT_CALLS = 5
EDIT_FACTORS = (1.7, 0.6, 1.2)  # colorChange's red, green, blue factors
EDIT_TOL = 1e-5  # the edits' multigrid tolerance (JAX's solve_auto)
# slice 7: the CLI's timed runs after its warm-up; the stage tensors of its
# --debug-dump against the CPU path's (the plain RHS on both)
CLI_LOOPS = 5
STAGE_ABS_TOL = 1e-3


UNFUSED_PROFILE = "mg_q 8K tolerance (unfused chain)"
# the per-axis strips: path -> its source's (h, w) under a full mask, and
# the profile of its frame on the parent's unfused chain (cat, transpose,
# unfold_minor)
STRIP_PATHS = {"per_axis_w": STRIPS[0], "per_axis_h": STRIPS[1]}
UNFUSED_STRIP = {p: f"{p} (unfused chain)" for p in STRIP_PATHS}
# kernel -> (the profile that runs it on the main path, its kernel's name):
# the kernels line's in-the-loop time per launch; "<kernel> <form>" puts a
# second profile or template of the kernel under "<form>_loop_ms"
LOOP_PROFILE = {"erode3": ("mg_q 8K tolerance", "erode3_kernel"),
                # the engine's mask prep: one a request of the pair and mg_q engines
                "prep_mask": ("pair requests", "prep_mask_kernel"),
                "prep_mask eight_k": ("mg_q 8K requests", "prep_mask_kernel"),
                "erode3 pair": ("pair", "erode3_kernel"),
                "transpose_pair": ("pair", "transpose_pair_kernel<false"),
                "transpose_pair divide": ("pair", "transpose_pair_kernel<true"),
                "unfold_transpose": ("pair", "unfold_transpose_kernel"),
                "unfold_clamp_paste": ("pair", "unfold_clamp_paste_kernel"),
                "fold_minor": ("pair", "fold_minor_kernel"),
                # the per-axis strips: each folded axis through the fused kernels
                # (the strip template or the headline one: one launch a frame)
                "transpose_pair strip_h": ("per_axis_h", "transpose_pair"),
                "transpose_pair strip_w_divide": ("per_axis_w", "transpose_pair"),
                "unfold_transpose strip_h": ("per_axis_h", "unfold_transpose"),
                "unfold_clamp_paste strip_w": ("per_axis_w", "unfold_clamp_paste"),
                "fold_minor strip_w": ("per_axis_w", "fold_minor_kernel"),
                "fold_minor strip_h": ("per_axis_h", "fold_minor_kernel"),
                "transpose strip_w": ("per_axis_w", "transpose_kernel<false"),
                "transpose strip_h_divide": ("per_axis_h", "transpose_kernel<true"),
                # the same strip frames on the parent's unfused per-axis chain
                "unfold_minor strip_w": (UNFUSED_STRIP["per_axis_w"], "unfold_minor_kernel"),
                "unfold_minor strip_h": (UNFUSED_STRIP["per_axis_h"], "unfold_minor_kernel"),
                "transpose": ("unfolded", "transpose_kernel<false"),
                "transpose divide": ("unfolded", "transpose_kernel<true"),
                "preprocess_rhs_t": ("pair", "preprocess_rhs_t_kernel"),
                "clamp_cast_paste_q": ("mg_q 8K tolerance", "clamp_cast_paste_q_kernel"),
                "mg_ud_q": ("mg_q 8K tolerance", "level_q_kernel<true, true"),
                "mg_down_q": ("mg_q 8K tolerance", "level_q_kernel<false, true"),
                "mg_up_q": ("mg_q 8K mg_cycles=4", "level_q_kernel<true, false"),
                "mg_prolong_tq": ("mg_q 8K tolerance", "mg_prolong_tq_kernel"),
                "mg_restrict_tq": (f"mg_q 8K tol {COARSE_TOL}", "mg_restrict_tq_kernel"),
                "mg_up_t": ("mg_q 8K tolerance", "mg_up_t_kernel"),
                "mg_down_t": ("mg_q 8K tolerance", "mg_down_t_kernel"),
                "preprocess_rhs_q": ("mg_q 8K tolerance", "preprocess_rhs_q_kernel"),
                # the same frame with the four-kernel chain (vcycle_t_unfused)
                "mg_up": (UNFUSED_PROFILE, "mg_up_kernel"),
                "mg_down": (UNFUSED_PROFILE, "mg_down_kernel"),
                # the dense rounded chain's frame (mg_padded=True): every level
                "mg_up dense": ("mg_padded_true 8K tolerance", "mg_up_kernel"),
                "mg_down dense": ("mg_padded_true 8K tolerance", "mg_down_kernel"),
                "mg_restrict_t": (UNFUSED_PROFILE, "mg_restrict_t_kernel"),
                "mg_prolong_t": (UNFUSED_PROFILE, "mg_prolong_t_kernel"),
                "rb_sweeps": ("jacobi", "rb_sweeps_tile_kernel"),
                "rb_sweeps_tile": ("tiled_dd 8K tolerance", "rb_sweeps_tile_kernel"),
                "preprocess_rhs_p": ("mg_t 8K tolerance", "preprocess_rhs_p_kernel"),
                "preprocess_rhs_p exact": ("dst_fft", "preprocess_rhs_p_kernel"),
                # the generic paste: the 8K slab, the headline slab, the 8K
                # and the headline exact-size solutions
                "clamp_cast_paste": ("mg_t 8K tolerance", "clamp_cast_paste_kernel"),
                "clamp_cast_paste unfolded": ("unfolded", "clamp_cast_paste_kernel"),
                "clamp_cast_paste tiled_dd": ("tiled_dd 8K tolerance", "clamp_cast_paste_kernel"),
                "clamp_cast_paste dst_fft": ("dst_fft", "clamp_cast_paste_kernel"),
                "postprocess_transposed": ("dst_post_t", "postprocess_transposed_kernel"),
                # slice 5: the bucketed frames (bucket_exact's kernels, the
                # grown bucket's pair chain, its ragged transposed tail at
                # h2 = 1406 and its "q" chain at 8K)
                **{f"{k} bucket_exact_{p}": (f"bucket_exact {label}", kernel)
                   for p, label in (("headline", "headline"), ("8k", "8K"))
                   for k, kernel in (("erode3", "erode3_kernel"),
                                     ("preprocess_rhs_p_exact", "preprocess_rhs_p_kernel"),
                                     ("mg_down_exact", "mg_down_kernel"),
                                     ("mg_up_exact", "mg_up_kernel"),
                                     ("clamp_cast_paste", "clamp_cast_paste_kernel"))},
                **{f"{k} bucket_grown_headline": ("bucket_grown headline", kernel)
                   for k, kernel in (("preprocess_rhs_t", "preprocess_rhs_t_kernel"),
                                     ("fold_minor", "fold_minor_kernel"),
                                     ("transpose_pair", "transpose_pair"),
                                     ("unfold_transpose", "unfold_transpose"),
                                     ("unfold_clamp_paste", "unfold_clamp_paste"))},
                "postprocess_transposed bucket_grown_post_t": ("bucket_grown_post_t",
                                                               "postprocess_transposed"),
                **{f"{k} bucket_grown_8k": ("bucket_grown 8K", kernel)
                   for k, kernel in (("mg_ud_q", "level_q_kernel<true, true"),
                                     ("mg_down_t", "mg_down_t_kernel"),
                                     ("mg_up_t", "mg_up_t_kernel"),
                                     ("preprocess_rhs_q", "preprocess_rhs_q_kernel"),
                                     ("clamp_cast_paste_q", "clamp_cast_paste_q_kernel"))},
                # slice 6: the 64-job batch step (the per-job kernels, the
                # one paste of the 192-channel stack), the 4K edit's "q"
                # chain on the dense RHS, the tiled edit's sweeps
                "erode3 batch_64_4k": ("batch_64_4k_pallas", "erode3_kernel"),
                "preprocess_rhs_p_exact batch_64_4k": ("batch_64_4k_pallas",
                                                       "preprocess_rhs_p_kernel"),
                "clamp_cast_paste batch_64_4k": ("batch_64_4k", "clamp_cast_paste_kernel"),
                **{f"{k} edit_color_4k": ("edit_color_4k", kernel)
                   for k, kernel in (("to_quarters", "to_quarters"),
                                     ("from_quarters", "from_quarters"),
                                     ("mg_ud_q", "level_q_kernel<true, true"),
                                     ("mg_down_q", "level_q_kernel<false, true"),
                                     ("mg_prolong_tq", "mg_prolong_tq_kernel"),
                                     ("clamp_cast_paste", "clamp_cast_paste_kernel"))},
                "rb_sweeps_tile edit_tiled": ("edit_tiled", "rb_sweeps_tile_kernel")}
# a LOOP_PROFILE profile -> the COMPARE_PATHS frame it profiles (default:
# the profile's own label), whose --other turns time the kernel in the loop
PROFILE_PATH = {"tiled_dd 8K tolerance": "tiled_dd", "mg_t 8K tolerance": "mg_t",
                "mg_padded_true 8K tolerance": "mg_padded_true"}
# --other: the kernels built from the other checkout (the level kernels and
# every source that includes their headers), the turns, and the serve paths
# that run them
OTHER_KERNELS = ("mg_down_q", "mg_up_q", "mg_ud_q", "mg_up", "mg_down", "mg_up_t", "mg_down_t",
                 "rb_sweeps_tile", "preprocess_rhs_q", "preprocess_rhs_t", "clamp_cast_paste_q",
                 "erode3", "transpose_pair", "unfold_transpose", "unfold_clamp_paste",
                 "unfold_minor", "preprocess_rhs_p", "clamp_cast_paste", "postprocess_transposed")
TURNS = ("other", "this", "this", "other")
COMPARE_PATHS = ("pair", "unfolded", "per_axis_w", "per_axis_h", "mg_t", "mg_t_fixed",
                 "mg_t_headline", "mg_q", "mg_q_fixed", "mg_q_headline", "mg_q_coarse",
                 "mg_q_coarse_headline", "tiled_dd", "tiled_dd_fixed", "tiled_dd_headline",
                 "mg_padded_false", "jacobi", "dst_fft", "dst_post_t", "mg_padded_true",
                 "mg_padded_true_fixed", "mg_padded_true_headline", *PRECISION_PATHS)


def _per_frame(**counts):
    return {k: counts.get(k, 0) for k in (*KERNELS, "prep_mask")}


def _mg_per_frame(levels: int, cycles: int):
    return _per_frame(erode3=1, preprocess_rhs_p=1, clamp_cast_paste=1,
                      **{k: levels * cycles for k in MG_KERNELS})


def _mg_q_per_frame(levels: int, cycles: int):
    """The quarter-plane chain, fixed mode: ``levels`` fused coarse levels."""
    return _per_frame(erode3=1, preprocess_rhs_q=1, clamp_cast_paste_q=1, mg_down_q=1,
                      mg_ud_q=cycles - 1, mg_up_q=1, mg_prolong_tq=cycles,
                      **{k: levels * cycles for k in MG_KERNELS})


def _dense_per_frame(levels: int, cycles: int):
    """The dense rounded chain (mg_padded=True) and the element V-cycle
    (mg_padded=False), fixed mode: ``levels`` fused levels, mg_down and
    mg_up once each a level a cycle, the exact-size RHS and paste."""
    return _per_frame(erode3=1, preprocess_rhs_p=1, clamp_cast_paste=1,
                      mg_down=levels * cycles, mg_up=levels * cycles)


def _dd_per_frame(levels: int, cycles: int):
    """The 2x2 DD frame, fixed mode: ``levels`` fused coarse levels; the
    paste once a tile (the mesh-resident destination's tiles)."""
    return _per_frame(clamp_cast_paste=DD_TILES, rb_sweeps_tile=2 * DD_TILES * cycles,
                      mg_down=levels * cycles, mg_up=levels * cycles)


PATHS = {
    "pair": _per_frame(erode3=1, preprocess_rhs_t=1, fold_minor=2, transpose_pair=3,
                       unfold_transpose=2, unfold_clamp_paste=1),
    "unfolded": _per_frame(erode3=1, preprocess_rhs_t=1, transpose=3, clamp_cast_paste=1),
    # one side of at most 128 px: the long side folds, joined through the
    # pair chain's kernels (strip W: w folds; strip H: h folds)
    "per_axis_w": _per_frame(erode3=1, preprocess_rhs_t=1, fold_minor=1, transpose=2,
                             transpose_pair=1, unfold_clamp_paste=1),
    "per_axis_h": _per_frame(erode3=1, preprocess_rhs_t=1, fold_minor=1, transpose_pair=1,
                             transpose=1, unfold_transpose=1, clamp_cast_paste=1),
    # tolerance mode: the V-cycle kernels' counts depend on the data (see
    # check_mg_counts); fixed mode (mg_cycles=4) at 8K has 4 fused levels
    "mg_t": None,
    "mg_t_fixed": _mg_per_frame(4, 4),
    "mg_t_headline": None,
    # the quarter-plane chain (the default mg_padded="q"): its finest level
    # in quarter planes, 3 fused "t" coarse levels at 8K, 2 at the headline
    "mg_q": None,
    "mg_q_fixed": _mg_q_per_frame(3, 4),
    "mg_q_headline": None,
    # tol 0.05: the check-first loop, its cycles data-dependent
    "mg_q_coarse": None,
    "mg_q_coarse_headline": None,
    # solve_multigrid on a dense RHS (no serve frame: the solves' counts)
    "mg_dense": None,
    # slice 4a: red-black (bursts of rb_sweeps, their number data-dependent),
    # the DST-FFT solve, the element path's fine sweeps (solver-level, nu2=6),
    # and the transposed post-process (use_pallas_preprocess=False)
    "jacobi": None,
    "jacobi_small": None,
    "dst_fft": _per_frame(erode3=1, preprocess_rhs_p=1, clamp_cast_paste=1),
    "mg_element": None,
    "dst_post_t": _per_frame(postprocess_transposed=1),
    # slice 8a: the 2x2 DD serve (tolerance mode: cycles data-dependent;
    # rb_sweeps_tile 2 a tile a cycle, mg_down / mg_up once per fused
    # coarse level a cycle, 2 at 8K), the red-black tiled solve
    # (solver-level) and mg_padded=False (the element V-cycle's fused levels)
    "tiled_dd": None,
    "tiled_dd_fixed": _dd_per_frame(2, 4),
    "tiled_dd_headline": None,
    "rb_tiled": None,
    "mg_padded_false": None,
    # slice 4b: the dense rounded chain (mg_padded=True; tolerance mode
    # data-dependent, 3 fused levels at 8K, 2 at the headline), and the
    # solver-level fmg start (the "q" chain) and pcg at the headline
    "mg_padded_true": None,
    "mg_padded_true_fixed": _dense_per_frame(3, 4),
    "mg_padded_true_headline": None,
    "mg_fmg": None,
    "mg_pcg": None,
    # slice 5: bucketed serving. bucket_exact: the tight system inside the
    # bucket (erode3, the exact-size preprocess_rhs_p and clamp_cast_paste
    # once, mg_down / mg_up once per fused level a cycle, data-dependent
    # cycles); the grown bucket: the pair chain at the headline, the
    # transposed tail with use_pallas_preprocess=False, the "q" chain at 8K
    "bucket_exact_headline": None,
    "bucket_exact_8k": None,
    "bucket_grown_post_t": _per_frame(postprocess_transposed=1),
    "bucket_grown_8k": None,
    # slice 6: a call of the batch entry point on 64 jobs of one shape (the
    # group's plain RHS, or erode3 + preprocess_rhs_p a job; one
    # clamp_cast_paste on the N*C stack); the mixed batch ("exact": one
    # paste a group; "pad": one group; "pad_exact": each job's tight system,
    # erode3, preprocess_rhs_p and clamp_cast_paste a job, no fused dyn
    # level at 128); the edits: the direct route at 1080p (the paste
    # only), the "q" chain on the dense 4K RHS, the DD solve on a 2x2 mesh
    "batch_64_4k": _per_frame(clamp_cast_paste=1),
    "batch_64_4k_pallas": _per_frame(erode3=64, preprocess_rhs_p=64, clamp_cast_paste=1),
    "batch_mixed_4k_exact": None,
    "batch_mixed_4k_pad": _per_frame(clamp_cast_paste=1),
    "batch_mixed_4k_pad_exact": None,
    "edit_color_1080p": _per_frame(clamp_cast_paste=1),
    "edit_texture_1080p": _per_frame(clamp_cast_paste=1),
    "edit_color_4k": None,
    "edit_illumination_4k": None,
    "edit_tiled": None,
    # slice 7: the CLI (one warm-up and CLI_LOOPS timed runs) and one
    # sc_tpu_run through the C ABI, each the pair chain a run at the headline
    "cli_headline": None,
    "capi_headline": None,
    # slice 8: path="gspmd" on the 2x2 mesh (the generic tail's paste, and
    # rb_sweeps_tile 2 a tile a cycle on the plain level; tolerance mode
    # data-dependent), and the gspmd edit at 1080p
    "tiled_gspmd": None,
    "tiled_gspmd_fixed": _per_frame(clamp_cast_paste=DD_TILES,
                                    rb_sweeps_tile=2 * DD_TILES * GSPMD_PLAIN_LEVELS * 4),
    "edit_tiled_gspmd": None,
}
PATHS["bucket_grown_headline"] = dict(PATHS["pair"])  # the pair chain on the bucket
PATHS["cli_headline"] = dict(PATHS["pair"])
PATHS["capi_headline"] = dict(PATHS["pair"])
# slice 4c: every precision mode's frame launches the pair chain's kernels
PATHS.update({p: dict(PATHS["pair"]) for p in PRECISION_PATHS})
DENSE_PATHS = ("mg_padded_false", "mg_padded_true", "mg_padded_true_headline")
JACOBI_PATHS = ("jacobi", "jacobi_small")
MG_Q_PATHS = ("mg_q", "mg_q_fixed", "mg_q_headline", "bucket_grown_8k")
BUCKET_EXACT_PATHS = ("bucket_exact_headline", "bucket_exact_8k")
MG_Q_COARSE_PATHS = ("mg_q_coarse", "mg_q_coarse_headline")
TILED_PATHS = ("tiled_dd", "tiled_dd_fixed", "tiled_dd_headline")
GSPMD_PATHS = ("tiled_gspmd", "edit_tiled_gspmd")
# fused levels of the "t" chain; fused coarse levels below the quarter level
MG_LEVELS = {"mg_t": 4, "mg_t_headline": 3, "mg_q": 3, "mg_q_headline": 2, "mg_q_coarse": 3,
             "mg_q_coarse_headline": 2,
             # exact-size fused levels: the DD coarse solve's, mg_padded=False's
             "tiled_dd": 2, "tiled_dd_fixed": 2, "tiled_dd_headline": 1, "mg_padded_false": 2,
             # the dense rounded chain's fused levels (mg_geometry's slabs)
             "mg_padded_true": 3, "mg_padded_true_fixed": 3, "mg_padded_true_headline": 2,
             # bucket_exact's fused dyn levels (>= 2^18 true points); the grown
             # 8K bucket's fused "q" coarse levels
             "bucket_exact_headline": 2, "bucket_exact_8k": 3, "bucket_grown_8k": 3}
# the path whose serve run gives each kernel's "launches"
HOME_PATH = {"transpose": "unfolded", "clamp_cast_paste": "unfolded",
             "preprocess_rhs_p": "mg_t",
             "mg_down": "mg_padded_true", "mg_up": "mg_padded_true", "mg_down_t": "mg_q",
             "mg_up_t": "mg_q", "preprocess_rhs_q": "mg_q", "mg_down_q": "mg_q", "mg_ud_q": "mg_q",
             "mg_up_q": "mg_q_fixed", "mg_prolong_tq": "mg_q", "clamp_cast_paste_q": "mg_q",
             "to_quarters": "edit_color_4k", "from_quarters": "edit_color_4k",
             "mg_restrict_tq": "mg_q_coarse", "rb_sweeps": "jacobi",
             "postprocess_transposed": "dst_post_t", "rb_sweeps_tile": "tiled_dd"}
_PK = "seamlesscloneoptimization_tpu/ops/pallas_kernels.py"
_MQ = "seamlesscloneoptimization_tpu/ops/pallas_mg_quarter.py"
REPLACES = {
    "erode3": [f"{_PK}:1164"],
    "preprocess_rhs_t": [f"{_PK}:1288"],
    "transpose": [f"{_PK}:1557"],
    "clamp_cast_paste": [f"{_PK}:1785", f"{_PK}:1656"],
    "clamp_cast_paste_interleaved": [f"{_PK}:1614"],
    "fold_minor": [f"{_PK}:1914"],
    "unfold_minor": [f"{_PK}:1958"],
    "transpose_pair": [f"{_PK}:2011"],
    "unfold_transpose": [f"{_PK}:2089"],
    "unfold_clamp_paste": [f"{_PK}:2130", f"{_PK}:1785"],
    "unfold_clamp_paste_interleaved": [f"{_PK}:2130", f"{_PK}:1958", f"{_PK}:1614"],
    "preprocess_rhs_p": [f"{_PK}:1358", f"{_PK}:1077"],
    "preprocess_rhs_p_exact": [f"{_PK}:1077"],
    "mg_down": [f"{_PK}:595"],
    "mg_up": [f"{_PK}:805"],
    "mg_restrict_t": [f"{_PK}:933"],
    "mg_prolong_t": [f"{_PK}:986"],
    "mg_down_t": [f"{_PK}:595", f"{_PK}:933"],
    "mg_up_t": [f"{_PK}:986", f"{_PK}:805"],
    "preprocess_rhs_q": [f"{_PK}:1434"],
    "mg_down_q": [f"{_MQ}:414"],
    "mg_up_q": [f"{_MQ}:675"],
    "mg_ud_q": [f"{_MQ}:784"],
    "mg_prolong_tq": [f"{_MQ}:561"],
    "clamp_cast_paste_q": [f"{_PK}:1695", f"{_PK}:1785"],
    "clamp_cast_paste_q_interleaved": [f"{_PK}:1695", f"{_MQ}:158", f"{_PK}:1614"],
    "to_quarters": [f"{_MQ}:120"],
    "from_quarters": [f"{_MQ}:158"],
    "mg_restrict_tq": [f"{_MQ}:511"],
    "rb_sweeps": [f"{_PK}:316", f"{_PK}:288", f"{_PK}:301"],
    "postprocess_transposed": [f"{_PK}:1498"],
    "rb_sweeps_tile": [f"{_PK}:391", f"{_PK}:362"],
    "rb_sweeps_tile_window": [f"{_PK}:391", f"{_PK}:362"],
    "mg_down_exact": [f"{_PK}:595"],
    "mg_up_exact": [f"{_PK}:805"],
    "prep_mask": ["none: the JAX package preps the mask on the host (native.prep_mask)"],
}
SOURCE = {"preprocess_rhs_p_exact": "preprocess_rhs_p", "mg_down_exact": "mg_down",
          "mg_up_exact": "mg_up", "rb_sweeps": "rb_sweeps_tile",
          "clamp_cast_paste_interleaved": "clamp_cast_paste",
          "unfold_clamp_paste_interleaved": "unfold_clamp_paste",
          "clamp_cast_paste_q_interleaved": "clamp_cast_paste_q"}


def synthetic_image(rng, hw, cell=48):
    """Smooth random colour field plus noise, u8 (H, W, 3)."""
    import numpy as np

    h, w = hw
    coarse = rng.integers(0, 256, (h // cell + 2, w // cell + 2, 3)).astype(np.float32)
    img = np.kron(coarse, np.ones((cell, cell, 1), np.float32))[:h, :w]
    img += rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def ellipse_mask(rng, hw, bbox_hw, jitter: int = 8):
    """A u8 {0,255} ellipse mask whose bbox is exactly ``bbox_hw``, placed up
    to ``jitter`` pixels (drawn from ``rng``) off the image's centre."""
    import numpy as np

    bh_, bw_ = bbox_hw
    y0 = (hw[0] - bh_) // 2 + int(rng.integers(-jitter, jitter + 1))
    x0 = (hw[1] - bw_) // 2 + int(rng.integers(-jitter, jitter + 1))
    cy, cx = y0 + (bh_ - 1) / 2, x0 + (bw_ - 1) / 2
    yy, xx = np.ogrid[: hw[0], : hw[1]]
    inside = ((yy - cy) / (bh_ / 2)) ** 2 + ((xx - cx) / (bw_ / 2)) ** 2 <= 1
    return inside.astype(np.uint8) * 255


def build_other(other_root: Path):
    """Build the sources of ``other_root``'s OTHER_KERNELS with this
    checkout's nvcc flags, all at once. Returns (name -> ctypes function,
    for the kernels its sources export; its quarter tile (kTH, kTW); source
    -> ptxas's resource lines; source -> library path)."""
    import ctypes
    import re

    from seamlesscloneoptimization_tpu_torch.ops import _build

    csrc = other_root / "seamlesscloneoptimization_tpu_torch" / "csrc"
    out = other_root / "_other_build"
    out.mkdir(exist_ok=True)
    sources = sorted({_build.source_name(name) for name in OTHER_KERNELS})
    libs = {src: out / f"lib{src}.so" for src in sources}
    procs = {src: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(libs[src]), str(csrc / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for src in sources}
    funcs, ptxas = {}, {}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"building {other_root.name}'s {src} failed:\n{log}")
        ptxas[src] = " | ".join(ln.strip() for ln in log.splitlines()
                                if "Used" in ln or "spill" in ln)
        lib = ctypes.CDLL(str(libs[src]))
        for name in OTHER_KERNELS:
            symbol, argtypes = _build.SIGNATURES[name]
            if _build.source_name(name) != src or not hasattr(lib, symbol):
                continue  # a checkout without the fused transfers exports no mg_*_t
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            funcs[name] = fn
    header = (csrc / "mg_level_q.cuh").read_text()
    tile = tuple(int(re.search(rf"constexpr int {k} = (\d+);", header).group(1))
                 for k in ("kTH", "kTW"))
    return funcs, tile, ptxas, libs


@contextlib.contextmanager
def unfused_chain():
    """Run ``vcycle_t`` as the four-kernel chain that the fused transfers
    fold (``solvers/multigrid.py:vcycle_t_unfused``)."""
    from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM

    saved = TM.vcycle_t
    TM.vcycle_t = TM.vcycle_t_unfused
    try:
        yield
    finally:
        TM.vcycle_t = saved


@contextlib.contextmanager
def unfused_per_axis():
    """Serve the per-axis DST route as the parent commit composed it from the
    same kernels: a folded axis concatenates its half-GEMM outputs
    (``torch.cat``) for a ``transpose`` and unfolds in an ``unfold_minor``
    pass of its own, and the frame ends in ``clamp_cast_paste``."""
    import torch

    from seamlesscloneoptimization_tpu_torch.models import pipeline
    from seamlesscloneoptimization_tpu_torch.ops import kernels as K
    from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import (
        dst_bases,
        pair_chain_applies,
    )

    def fwd(a, b):
        if not b.folded:
            return torch.matmul(a, b.mats[0])
        s, d = K.fold_minor(a, b.n)
        return torch.cat([torch.matmul(s, b.mats[0]), torch.matmul(d, b.mats[1])], dim=-1)

    def inv(a, b):
        if not b.folded:
            return torch.matmul(a, b.mats[0])
        ep = b.mats[2].shape[0]
        return K.unfold_minor(torch.matmul(a[..., :ep], b.mats[2]),
                              torch.matmul(a[..., ep:], b.mats[3]), b.n, b.n_pad)

    def solve(g_tp, h2, w2, precision="highest", folded=False, bases=None, return_parts=False):
        if return_parts or (folded and pair_chain_applies(h2, w2)):
            raise AssertionError("the unfused chain is the per-axis route's only")
        _, wp, hp = g_tp.shape
        bh, bw = bases if bases is not None else dst_bases(h2, w2, hp, wp, g_tp.device, folded)
        tr1 = K.transpose(fwd(g_tp, bh))
        tr2 = K.transpose(fwd(tr1, bw), bh.lam, bw.lam)
        tr3 = K.transpose(inv(tr2, bh))
        return inv(tr3, bw)

    saved = pipeline.solve_dst_gemm_pl, pipeline.parts_apply
    pipeline.solve_dst_gemm_pl, pipeline.parts_apply = solve, lambda w2, folded: False
    try:
        yield
    finally:
        pipeline.solve_dst_gemm_pl, pipeline.parts_apply = saved


@contextlib.contextmanager
def swapped(funcs: dict, q_tile: tuple[int, int], cast_mask: bool = True):
    """Launch ``funcs`` in place of this checkout's kernels of the same
    names, with the per-tile residual maxima sized for ``q_tile``. Another
    checkout's erode3 may read a {0,1} mask only (its pipeline cast the
    mask first): with ``cast_mask`` the pipeline casts the mask first too
    (two torch ops a frame). One without the fused transfers runs
    ``vcycle_t`` as the four-kernel chain."""
    import torch

    from seamlesscloneoptimization_tpu_torch.models import pipeline
    from seamlesscloneoptimization_tpu_torch.ops import _build
    from seamlesscloneoptimization_tpu_torch.ops import kernels as K

    saved = {n: _build.kernel_function(n) for n in funcs}, K.Q_TILE, pipeline.erode3
    _build._functions.update(funcs)
    K.Q_TILE = q_tile
    if "erode3" in funcs and cast_mask:
        pipeline.erode3 = lambda m: K.erode3((m != 0).to(torch.uint8))
    try:
        with contextlib.nullcontext() if "mg_down_t" in funcs else unfused_chain():
            yield
    finally:
        _build._functions.update(saved[0])
        K.Q_TILE, pipeline.erode3 = saved[1:]


def sass(lib: Path) -> dict[str, list[str]] | None:
    """The instructions of each of a library's kernels (cuobjdump -sass), by
    kernel name, or None where the toolkit has no cuobjdump. The numbers
    ptxas gives its internal subroutines (the IEEE divide's slow path,
    ``$__internal_<k>_$...``) count the module's kernels, so they are
    written ``<k>``; runs of blanks are one blank (cuobjdump pads the
    columns to the module's longest instruction)."""
    import re

    from seamlesscloneoptimization_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None and "/*" in ln:  # instruction lines only
            funcs[name].append(" ".join(re.sub(r"__internal_\d+_", "__internal_<k>_",
                                               ln).split()))
    return funcs


def sass_kept(mine: dict, theirs: dict) -> tuple[bool, list[str], list[str]]:
    """Whether every kernel of ``theirs`` has one of ``mine`` with the same
    instructions (the names carry a per-source hash), the names of
    ``mine`` without such a twin there, and for each kernel of ``theirs``
    without one here its first differing instruction against this
    checkout's kernel of as many instructions that differs least."""
    theirs_bodies, mine_bodies = list(theirs.values()), list(mine.values())
    lost = []
    for name, body in theirs.items():
        if body in mine_bodies:
            continue
        near = [m for m in mine_bodies if len(m) == len(body)]
        diffs = [[(x, y) for x, y in zip(body, m) if x != y] for m in near]
        best = min(diffs, key=len, default=None)
        lost.append(f"{name[:90]}: {len(body)} instructions, "
                    + (f"{len(best)} lines differ, first {best[0]}" if best
                       else "no kernel here of that length"))
    return not lost, [n for n, body in mine.items() if body not in theirs_bodies], lost


def less_preps(path: str, what: str, launches: dict, requests: int) -> dict:
    """``launches`` less the engine's mask preps, which must number
    ``requests``: one a ``run`` or ``timed_serve`` of ``SeamlessClone`` (a
    1x1 mesh's too), none for a larger mesh's frames, a pipeline, solver or
    edit called directly, or the batch path."""
    if launches["prep_mask"] != requests:
        raise AssertionError(f"{path} {what} launched prep_mask {launches['prep_mask']} "
                             f"times, expected {requests} (one a request)")
    return {**launches, "prep_mask": 0}


def check_counts(path: str, what: str, launches: dict, frames: int, requests: int) -> dict:
    """The path's launch counts over ``frames`` frames of ``requests``
    engine requests; returns ``launches`` less the mask preps."""
    launches = less_preps(path, what, launches, requests)
    if PATHS[path] is None:
        check = (check_mg_q_counts if path in MG_Q_PATHS else
                 check_mg_q_coarse_counts if path in MG_Q_COARSE_PATHS else
                 check_jacobi_counts if path in JACOBI_PATHS else
                 check_tiled_counts if path in TILED_PATHS else
                 check_gspmd_counts if path in GSPMD_PATHS else
                 check_unpadded_counts if path in DENSE_PATHS + BUCKET_EXACT_PATHS
                 else check_mg_counts)
        check(path, what, launches, frames)
        return launches
    for name, per in PATHS[path].items():
        if launches[name] != per * frames:
            raise AssertionError(f"{path} {what} launched {name} {launches[name]} times, "
                                 f"expected {per} x {frames} frames")
    return launches


def check_mg_counts(path: str, what: str, launches: dict, frames: int) -> int:
    """Tolerance-mode multigrid counts: erode3, preprocess_rhs_p and
    clamp_cast_paste once a frame, the two V-cycle kernels equally often,
    a multiple of the fused levels, nothing else. Returns the cycles run."""
    levels = MG_LEVELS[path]
    n = launches["mg_down_t"]
    want = _mg_per_frame(1, 0)
    want = {k: v * frames for k, v in want.items()}
    want.update({k: n for k in MG_KERNELS})
    if launches != want or n == 0 or n % levels:
        raise AssertionError(f"{path} {what}: launches {launches}, expected V-cycle kernels "
                             f"equal, a multiple of {levels} levels, and {frames} frames")
    return n // levels


def check_mg_q_counts(path: str, what: str, launches: dict, frames: int) -> int:
    """Tolerance-mode quarter-plane counts: erode3, preprocess_rhs_q,
    mg_down_q and clamp_cast_paste_q once a frame, one mg_ud_q and one
    mg_prolong_tq per cycle, each coarse-level kernel once per cycle and
    fused coarse level, no mg_up_q, nothing else. Returns the cycles run."""
    levels = MG_LEVELS[path]
    n = launches["mg_ud_q"]
    want = _per_frame(erode3=frames, preprocess_rhs_q=frames, clamp_cast_paste_q=frames,
                      mg_down_q=frames, mg_ud_q=n, mg_prolong_tq=n,
                      **{k: n * levels for k in MG_KERNELS})
    if launches != want or n < frames:
        raise AssertionError(f"{path} {what}: launches {launches}, expected {want}")
    return n


def check_mg_q_coarse_counts(path: str, what: str, launches: dict, frames: int) -> int:
    """Check-first quarter-plane counts (no check-free cycle): erode3,
    preprocess_rhs_q and clamp_cast_paste_q once a frame; per cycle the
    split mg_down_q, mg_restrict_tq, mg_prolong_tq and mg_up_q once, each
    coarse-level kernel once per fused coarse level; no mg_ud_q, no
    conversion, nothing else. Returns the cycles run."""
    levels = MG_LEVELS[path]
    n = launches["mg_up_q"]
    want = _per_frame(erode3=frames, preprocess_rhs_q=frames, clamp_cast_paste_q=frames,
                      **{k: n for k in Q_CHECK_FIRST}, **{k: n * levels for k in MG_KERNELS})
    if launches != want or n < frames:
        raise AssertionError(f"{path} {what}: launches {launches}, expected {want}")
    return n


def check_jacobi_counts(path: str, what: str, launches: dict, frames: int) -> int:
    """Red-black frames: erode3, preprocess_rhs_p and clamp_cast_paste once a
    frame, rb_sweeps ceil(50 / 4) = 13 launches per burst of 50 sweeps,
    nothing else. Returns the bursts run."""
    n = launches["rb_sweeps"]
    want = _per_frame(erode3=frames, preprocess_rhs_p=frames, clamp_cast_paste=frames,
                      rb_sweeps=n)
    if launches != want or n < frames or n % RB_LAUNCHES_PER_BURST:
        raise AssertionError(f"{path} {what}: launches {launches}, expected {want} with "
                             f"rb_sweeps a multiple of {RB_LAUNCHES_PER_BURST}")
    return n // RB_LAUNCHES_PER_BURST


def check_tiled_counts(path: str, what: str, launches: dict, frames: int) -> int:
    """DD frames on the 2x2 mesh: clamp_cast_paste once a tile a frame (the
    generic tail on each cell's destination tile; the RHS is plain torch per
    tile); per cycle rb_sweeps_tile 2 a tile (nu1 = 1
    and nu2 = 2 sweeps, one exchange and one launch each) and mg_down /
    mg_up once per fused coarse level; nothing else. Returns the cycles."""
    levels = MG_LEVELS[path]
    n, rem = divmod(launches["rb_sweeps_tile"], 2 * DD_TILES)
    want = _per_frame(clamp_cast_paste=frames * DD_TILES, rb_sweeps_tile=2 * DD_TILES * n,
                      mg_down=levels * n, mg_up=levels * n)
    if launches != want or rem or n < frames:
        raise AssertionError(f"{path} {what}: launches {launches}, expected {want}")
    return n


def check_gspmd_counts(path: str, what: str, launches: dict, frames: int) -> int:
    """path="gspmd" frames on the 2x2 mesh: clamp_cast_paste once a tile a
    frame (the generic tail on each cell's destination tile; the RHS is
    plain torch per tile); per cycle rb_sweeps_tile 2 a
    tile on each partitioned level with betas 1 (nu1 and nu2 sweeps on a
    4-ring band, one launch each; ``GSPMD_PLAIN_LEVELS``); nothing else (the
    beta levels and the gathered coarse levels run in torch ops). Returns
    the cycles."""
    per_cycle = 2 * DD_TILES * GSPMD_PLAIN_LEVELS
    n, rem = divmod(launches["rb_sweeps_tile"], per_cycle)
    want = _per_frame(clamp_cast_paste=frames * DD_TILES, rb_sweeps_tile=per_cycle * n)
    if launches != want or rem or n < frames:
        raise AssertionError(f"{path} {what}: launches {launches}, expected {want}")
    return n


def check_unpadded_counts(path: str, what: str, launches: dict, frames: int) -> int:
    """mg_padded=False, mg_padded=True and bucket_exact frames: erode3,
    preprocess_rhs_p (exact size) and clamp_cast_paste once a frame, mg_down
    and mg_up once per fused level a cycle (the element V-cycle's, vcycle_p's
    on mg_geometry's slabs, or the runtime-domain multigrid's), nothing else.
    Returns the cycles."""
    levels = MG_LEVELS[path]
    n, rem = divmod(launches["mg_down"], levels)
    want = _per_frame(erode3=frames, preprocess_rhs_p=frames, clamp_cast_paste=frames,
                      mg_down=levels * n, mg_up=levels * n)
    if launches != want or rem or n < frames:
        raise AssertionError(f"{path} {what}: launches {launches}, expected {want}")
    return n


def check_outside(out, dst, interior) -> None:
    """out == dst outside the ROI interior (top1, left1, h2, w2), and changed
    inside it."""
    import numpy as np

    top1, left1, h2, w2 = interior
    outside = np.ones(dst.shape[:2], bool)
    outside[top1 : top1 + h2, left1 : left1 + w2] = False
    if not np.array_equal(out[outside], dst[outside]):
        raise AssertionError("pixels outside the ROI interior changed")
    if np.array_equal(out[~outside], dst[~outside]):
        raise AssertionError("the ROI interior is unchanged")


def diff_max(a, b) -> int:
    import numpy as np

    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


def profile_frames(label, clone_pipeline, kwargs, frames: int = 5,
                   into: dict | None = None, brief: bool = False) -> dict:
    """Where a serve frame's device time goes: torch.profiler over
    ``frames`` chained frames of the serve pipeline, kernel time per frame
    by name and by group, the busy share of the device's span (CUDA events
    around the window), and the GEMM launches per frame. Returns
    {"gemms" (a frame; -1 when the profiler recorded no device time),
    "span_us", "busy_us", "idle"}, times a frame. ``into[label]`` gets (device us a
    frame, launches a frame) by kernel name, and the launches in issue
    order as (name, us). ``brief``: print the summary line only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    clone_pipeline(**kwargs)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s.record()
        for _ in range(frames):
            clone_pipeline(**kwargs)
        e.record()
        e.synchronize()
    span_us = s.elapsed_time(e) * 1e3 / frames
    per_kernel, calls = {}, {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0.0)
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + t / frames
            calls[ev.key] = calls.get(ev.key, 0) + ev.count
    busy = sum(per_kernel.values())
    result = {"gemms": -1, "span_us": span_us, "busy_us": busy,
              "idle": 1 - busy / span_us if busy else None}
    if busy == 0:
        print(f"profile {label}: no device time recorded; frame span {span_us:.1f} us")
        return result
    ours = ("erode3", "preprocess_rhs_t", "transpose_kernel", "clamp_cast_paste",
            "fold_minor", "unfold_minor", "transpose_pair", "unfold_transpose",
            "unfold_clamp_paste", "preprocess_rhs_p", "mg_down", "mg_up", "mg_restrict_t",
            "mg_prolong_t", "preprocess_rhs_q", "level_q_kernel", "to_quarters",
            "from_quarters", "rb_sweeps", "postprocess_transposed", "prep_mask")
    groups = {"gemm": 0.0, "port kernels": 0.0, "other": 0.0}
    gemm_calls = other_calls = 0
    for k, t in per_kernel.items():
        is_gemm = any(g in k.lower() for g in ("gemm", "cutlass", "xmma", "nvjet"))
        g = "gemm" if is_gemm else "port kernels" if any(o in k for o in ours) else "other"
        groups[g] += t
        gemm_calls += calls[k] if is_gemm else 0
        other_calls += calls[k] if g == "other" else 0
    result["gemms"] = gemm_calls / frames
    result["gemm_us"] = groups["gemm"]
    result["torch_op_launches"] = other_calls / frames
    if into is not None:
        seq = sorted((ev.time_range.start, ev.name, ev.time_range.elapsed_us())
                     for ev in prof.events()
                     if str(getattr(ev, "device_type", "")).endswith("CUDA"))
        into[label] = (per_kernel, {k: n / frames for k, n in calls.items()},
                       [(name, us) for _, name, us in seq])
    print(f"profile {label} ({frames} frames, profiler on): device span {span_us:.1f} "
          f"us/frame, kernels busy {busy:.1f} us/frame, idle share {result['idle']:.3f}, "
          f"GEMM launches {gemm_calls / frames:g}, torch-op kernel launches "
          f"{other_calls / frames:g} per frame")
    if brief:
        return result
    for g, t in groups.items():
        print(f"profile {label} group {g}: {t:.1f} us/frame ({t / busy:.3f} of busy)")
    for k, t in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:14]:
        print(f"profile {label} kernel {t:9.1f} us/frame x{calls[k] / frames:g}  {k[:100]}")
    return result


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    kernels_only = "--kernels" in args
    args = [a for a in args if a != "--kernels"]
    other_root = None
    if len(args) == 2 and args[0] == "--other":
        other_root = Path(args[1]).resolve()
    elif args:
        print("usage: python3 chip_smoke.py [--other OTHER_ROOT] [--kernels]", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from seamlesscloneoptimization_tpu_torch import native
    from seamlesscloneoptimization_tpu_torch.api import seamless_clone
    from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
    from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone, prepare_inputs
    from seamlesscloneoptimization_tpu_torch.models.pipeline import _plain_rhs, clone_pipeline
    from seamlesscloneoptimization_tpu_torch.ops import _build
    from seamlesscloneoptimization_tpu_torch.ops import kernels as K
    from seamlesscloneoptimization_tpu_torch.ops.guidance import bgr_to_gray_u8
    from seamlesscloneoptimization_tpu_torch.ops.kernels import ru128
    from seamlesscloneoptimization_tpu_torch.parallel import (
        TiledSeamlessClone,
        make_tile_mesh,
        solve_poisson_dd,
        solve_redblack_tiled,
    )
    from seamlesscloneoptimization_tpu_torch.solvers import jacobi as TJ
    from seamlesscloneoptimization_tpu_torch.solvers import dst_gemm as TD
    from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM
    from seamlesscloneoptimization_tpu_torch.solvers.dst_fft import solve_dst_fft
    from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import (
        dst_bases,
        pair_chain_applies,
        solve_dst_gemm,
        solve_dst_gemm_pl,
    )

    dev = torch.device("cuda")

    # -- 1. the card and the build ---------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s")
    for name, report in _build.ptxas_report().items():
        print(f"ptxas {name}: {report}")
    other = None
    other_fused = True  # the other checkout has mg_down_t / mg_up_t
    other_agrees = []  # per timed kernel: the other checkout's output equals this one's
    if other_root is not None:
        t0 = time.perf_counter()
        other_funcs, other_tile, other_ptxas, other_libs = build_other(other_root)
        print(f"{other_root.name}'s kernels built in {time.perf_counter() - t0:.2f} s, "
              f"quarter tile {other_tile}")

        # the mask cast only where the other erode3 reads a {0,255} mask
        # otherwise than this one does
        other_casts = False
        if "erode3" in other_funcs:
            gen_m = torch.Generator(dev).manual_seed(SEED)
            probe = (torch.rand((37, 70), generator=gen_m, device=dev) < 0.8).to(torch.uint8)
            with swapped(other_funcs, other_tile, cast_mask=False):
                theirs = K.erode3(probe * 255)
            other_casts = not torch.equal(theirs, K.erode3(probe * 255))
        print(f"{other_root.name}'s erode3 needs the mask cast to {{0,1}}: {other_casts}")

        def other():
            return swapped(other_funcs, other_tile, other_casts)

        for src, lib in other_libs.items():
            mine = sass(_build._target(src))
            if mine is None:
                print(f"ptxas {src} of {other_root.name}: {other_ptxas[src]}; SASS not checked")
                continue
            theirs = sass(lib)
            kept, new, lost = sass_kept(mine, theirs)
            print(f"ptxas {src} of {other_root.name}: {other_ptxas[src]}; SASS equal to "
                  f"this checkout's: {mine == theirs}; each of its kernels' SASS among this "
                  f"checkout's: {kept}; this checkout's kernels without a twin there: "
                  f"{[n[:90] for n in new]}" + (f"; its kernels without a twin here: {lost}"
                                               if lost else ""))
        other_fused = "mg_down_t" in other_funcs
        print(f"{other_root.name} has the fused transfers: {other_fused}")
    print("tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32,
          "float32_matmul_precision", torch.get_float32_matmul_precision())

    # -- the headline frame's tensors, exactly as the serve pipeline makes them
    rng = np.random.default_rng(SEED)
    src = synthetic_image(rng, SRC_HW)
    dst = synthetic_image(rng, DST_HW)
    mask = np.full(SRC_HW, 255, np.uint8)
    center = (DST_HW[1] // 2, DST_HW[0] // 2)
    m, (x0, y0), (left, top), (bh, bw) = prepare_inputs(mask, src.shape, dst.shape, center)
    h2, w2 = bh - 2, bw - 2
    hp, wp = ru128(h2), ru128(w2)
    c = 3
    if not pair_chain_applies(h2, w2):
        raise AssertionError(f"the headline interior {h2}x{w2} does not fold")
    dst_p = torch.from_numpy(dst).to(dev).permute(2, 0, 1).contiguous()
    dest_roi = dst_p[:, top : top + bh, left : left + bw]
    src_roi = torch.from_numpy(src).to(dev)[y0 : y0 + bh, x0 : x0 + bw].permute(2, 0, 1)
    mask_roi = torch.from_numpy(np.ascontiguousarray(m[y0 : y0 + bh, x0 : x0 + bw])).to(dev)
    patch = torch.where(mask_roi[None] != 0, src_roi, 0).to(torch.uint8)
    m01 = (mask_roi != 0).to(torch.uint8)
    plain_b = dst_bases(h2, w2, hp, wp, dev)
    fold_b = dst_bases(h2, w2, hp, wp, dev, folded=True)
    (vh,), lam_h = plain_b[0].mats, plain_b[0].lam
    (vw,), lam_w = plain_b[1].mats, plain_b[1].lam
    vep_h, vop_h, ve2p_h, vo2p_h = fold_b[0].mats
    vep_w, vop_w, ve2p_w, vo2p_w = fold_b[1].mats
    ep_h, op_h, ep_w, op_w = (vep_h.shape[0], vop_h.shape[0], vep_w.shape[0],
                              vop_w.shape[0])
    he_h, he_w, ho_h, ho_w = (h2 + 1) // 2, (w2 + 1) // 2, h2 // 2, w2 // 2
    print(f"geometry: roi {bh}x{bw}, interior {h2}x{w2}, slab ({c}, {wp}, {hp}); "
          f"folded halves h {ep_h}+{op_h}, w {ep_w}+{op_w}")

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2

    def time_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(REPS):
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)  # the card waits while the host issues fn
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / REPS

    def b2b_ms(fn, n: int = 20) -> float:
        """Back to back: a launch's time inside a chain of launches of it."""
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / n

    def side(name):
        return other() if name == "other" else contextlib.nullcontext()

    def poisoned(fn) -> tuple:
        """fn's outputs from a launch into memory just filled with NaN (the
        allocator hands the same sizes, asked in the same order, the same
        blocks): an element the kernel leaves unwritten then holds no
        earlier launch's result."""
        out = fn()
        sizes = [t.numel() for t in (out if isinstance(out, tuple) else (out,))]
        del out
        junk = [torch.full((n,), float("nan"), device=dev) for n in sizes]
        del junk
        out = fn()
        return out if isinstance(out, tuple) else (out,)

    def vs_other(fn, result=None, pair=None) -> dict:
        """The kernel back to back; with --other, also the other checkout's
        kernel, cold and back to back, in turns, and whether the two
        outputs are equal (each side's from ``poisoned``, or the tuple
        ``result()`` returns: an in-place kernel's launch into a fresh copy
        of its destination). ``pair``: a fused kernel's unfused pair, which
        the other checkout runs where it has no fused transfers."""
        out = {"b2b_ms": b2b_ms(fn)}
        if other is None:
            return out
        turns, outs = {"other": [], "this": []}, {}
        for name in TURNS:
            with side(name):
                f = pair if name == "other" and pair is not None and not other_fused else fn
                turns[name].append((time_ms(f), b2b_ms(f)))
                outs.setdefault(name, poisoned(f) if result is None else result())
        a, b = outs["other"], outs["this"]
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        other_agrees.append(equal)
        out.update(other_ms=sum(t[0] for t in turns["other"]) / 2,
                   other_b2b_ms=sum(t[1] for t in turns["other"]) / 2,
                   turns_ms=turns, other_output_equal=equal)
        return out

    def per_launch(timed: dict, n: int) -> dict:
        """vs_other's times of a run of n launches, per launch."""
        out = {k: v / n if k.endswith("_ms") and k != "turns_ms" else v
               for k, v in timed.items()}
        if "turns_ms" in timed:
            out["turns_ms"] = {s_: [(a / n, b / n) for a, b in t_]
                               for s_, t_ in timed["turns_ms"].items()}
        return out

    def print_other(what, r, pre=""):
        """A row's vs_other times (keys under ``pre``) on one line."""
        print(f"{what} ({card}): {r[pre + 'ms']:.5f} ms cold, "
              f"{r[pre + 'b2b_ms']:.5f} back to back"
              + (f"; other {r[pre + 'other_ms']:.5f} cold, {r[pre + 'other_b2b_ms']:.5f} "
                 f"back to back, outputs equal {r[pre + 'other_output_equal']}"
                 if pre + "other_ms" in r else ""))

    def bound(nbytes: float, nops: float):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_FLOPS * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    errs = {}

    def require_equal(name, got, want):
        """Bit-exact or raise; records the kernel's max |kernel - twin|."""
        err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        kernel = name.split()[0]
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its twin, max |diff| {err}")

    rows = {}

    def row(name, nbytes, nops, ms, plain_ms, library_ms=None, **extra):
        b_ms, b_by = bound(nbytes, nops)
        rows[name] = dict(name=name, route="cuda",
                          source="seamlesscloneoptimization_tpu_torch/csrc/"
                                 f"{SOURCE.get(name, _build.source_name(name))}.cu",
                          replaces=REPLACES[name][0], launches=None, max_abs_err=errs[name],
                          ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=library_ms, **extra)
        if len(REPLACES[name]) > 1:
            rows[name]["also_replaces"] = REPLACES[name][1:]

    def gemm_line(what, a, v):
        ms = time_ms(lambda: torch.matmul(a, v))
        flops = 2 * a.numel() * v.shape[1]
        print(f"one FP32 GEMM of the {what} chain ({'x'.join(map(str, a.shape))} @ "
              f"{v.shape[0]}x{v.shape[1]}, {flops / 1e9:.1f} GFLOP): {ms:.4f} ms = "
              f"{flops / ms / 1e9:.1f} TFLOP/s")

    # -- 2a. the slice-1 kernels, on the unfolded chain's tensors ---------------
    # the pipeline passes the {0,255} ROI; a {0,1} mask keeps the timed
    # outputs comparable with another checkout's erode3, which may read
    # {0,1} masks only
    me = K.erode3(mask_roi)
    require_equal("erode3", me, K.erode3_plain(mask_roi))
    require_equal("erode3 {0,1}", K.erode3(m01), me)
    row("erode3", 2 * bh * bw, 12 * bh * bw,
        time_ms(lambda: K.erode3(m01)), time_ms(lambda: K.erode3_plain(m01)),
        shape=f"u8 ({bh},{bw})", **vs_other(lambda: K.erode3(m01)))

    # prep_mask (no TPU counterpart): the engine's mask prep, a request's
    # first kernel; bit-exact to its twin on the card at the headline's full
    # mask, an elliptic one and the 8K patch's full mask, into a new tensor
    # and in place, the bbox also against native.prep_mask's
    prep_masks = {}
    for what, m_np in (("headline", mask), ("8K", np.full(SRC_8K, 255, np.uint8)),
                       ("headline ellipse", ellipse_mask(np.random.default_rng(SEED + 27),
                                                         SRC_HW, (1401, 2203)))):
        m_d = torch.from_numpy(m_np).to(dev)
        want_m, want_b = K.prep_mask_plain(m_d)
        got_m, got_b = K.prep_mask(m_d)
        require_equal(f"prep_mask {what}", got_m, want_m)
        require_equal(f"prep_mask {what} bbox", got_b, want_b)
        own = m_d.clone()
        K.prep_mask(own, out=own)
        require_equal(f"prep_mask {what} in place", own, want_m)
        require_equal(f"prep_mask {what} input", m_d, torch.from_numpy(m_np).to(dev))
        if tuple(got_b.tolist()) != native.prep_mask(m_np)[1]:
            raise AssertionError(f"prep_mask {what}: bbox {got_b.tolist()}, native "
                                 f"{native.prep_mask(m_np)[1]}")
        prep_masks[what] = m_d
    (ph, pw), (ph8, pw8) = SRC_HW, SRC_8K
    m_h, m_8 = prep_masks["headline"], prep_masks["8K"]
    row("prep_mask", 2 * ph * pw, 0, time_ms(lambda: K.prep_mask(m_h)),
        time_ms(lambda: K.prep_mask_plain(m_h)), shape=f"u8 ({ph},{pw})",
        b2b_ms=b2b_ms(lambda: K.prep_mask(m_h)),
        in_place_ms=time_ms(lambda: K.prep_mask(m_h, out=m_h)),
        eight_k_ms=time_ms(lambda: K.prep_mask(m_8)),
        eight_k_plain_ms=time_ms(lambda: K.prep_mask_plain(m_8)),
        eight_k_bound_ms=bound(2 * ph8 * pw8, 0)[0], eight_k_shape=f"u8 ({ph8},{pw8})")
    r_p = rows["prep_mask"]
    print(f"prep_mask ({card}): headline {r_p['ms']:.5f} ms cold, {r_p['b2b_ms']:.5f} back "
          f"to back, in place {r_p['in_place_ms']:.5f}, bound {r_p['bound_ms']:.5f}, plain "
          f"{r_p['plain_ms']:.5f}; 8K {r_p['eight_k_ms']:.5f} cold, bound "
          f"{r_p['eight_k_bound_ms']:.5f}, plain {r_p['eight_k_plain_ms']:.5f}")
    del prep_masks, m_h, m_8, m_d, own, got_m, want_m

    gray = bgr_to_gray_u8(patch).to(torch.uint8)[None].expand(c, bh, bw)
    for flags, rule, p_in in ((1, "opencv", patch), (2, "opencv", patch),
                              (2, "norm", patch), (1, "opencv", gray)):
        require_equal(f"preprocess_rhs_t flags={flags} {rule}",
                      K.preprocess_rhs_t(dest_roi, p_in, me, flags, rule),
                      K.preprocess_rhs_t_plain(dest_roi, p_in, me, flags, rule))
    g_tp = K.preprocess_rhs_t(dest_roi, patch, me)
    row("preprocess_rhs_t", 2 * c * bh * bw + bh * bw + 4 * c * wp * hp, 30 * c * bh * bw,
        time_ms(lambda: K.preprocess_rhs_t(dest_roi, patch, me)),
        time_ms(lambda: K.preprocess_rhs_t_plain(dest_roi, patch, me)),
        shape=f"u8 ({c},{bh},{bw}) -> ({c},{wp},{hp})",
        **vs_other(lambda: K.preprocess_rhs_t(dest_roi, patch, me)))
    # the per-axis strips' ROIs (a grid of few tiles: one channel a block),
    # views into the planar destination as on their serve frames
    strips, erode_strips = [], []
    gen_s = torch.Generator(dev).manual_seed(SEED + 3)
    for sh_, sw_ in ((s_[0] - 2, s_[1] - 2) for s_ in STRIPS):
        d_s = dst_p[:, 1 : 1 + sh_, 3 : 3 + sw_]
        p_s = torch.randint(0, 256, (c, sh_, sw_), generator=gen_s, device=dev,
                            dtype=torch.uint8)
        m1_s = (torch.rand((sh_, sw_), generator=gen_s, device=dev) < 0.999).to(torch.uint8)
        m_s = K.erode3(m1_s)
        require_equal(f"erode3 strip {sh_}x{sw_}", m_s, K.erode3_plain(m1_s))
        erode_strips.append(dict(shape=f"u8 ({sh_},{sw_})",
                                 ms=time_ms(lambda m1_s=m1_s: K.erode3(m1_s)),
                                 bound_ms=bound(2 * sh_ * sw_, 12 * sh_ * sw_)[0],
                                 **vs_other(lambda m1_s=m1_s: K.erode3(m1_s))))
        require_equal(f"preprocess_rhs_t strip {sh_}x{sw_}", K.preprocess_rhs_t(d_s, p_s, m_s),
                      K.preprocess_rhs_t_plain(d_s, p_s, m_s))

        def rhs_strip(d_s=d_s, p_s=p_s, m_s=m_s):
            return K.preprocess_rhs_t(d_s, p_s, m_s)

        strips.append(dict(shape=f"u8 ({c},{sh_},{sw_})", ms=time_ms(rhs_strip),
                           bound_ms=bound(2 * c * sh_ * sw_ + sh_ * sw_
                                          + 4 * c * ru128(sw_ - 2) * ru128(sh_ - 2),
                                          30 * c * sh_ * sw_)[0], **vs_other(rhs_strip)))
    rows["preprocess_rhs_t"]["strips"] = strips
    rows["erode3"]["strips"] = erode_strips
    for what, xs_ in (("erode3", erode_strips), ("preprocess_rhs_t", strips)):
        print(f"{what} on the per-axis strips ({card}): " + "; ".join(
            f"{x['shape']} {x['ms']:.5f} ms cold, {x['b2b_ms']:.5f} back to back, bound "
            f"{x['bound_ms']:.5f}" + (f", other {x['other_ms']:.5f} / {x['other_b2b_ms']:.5f}"
                                      if "other_ms" in x else "") for x in xs_))

    s1 = torch.matmul(g_tp, vh)
    require_equal("transpose", K.transpose(s1), K.transpose_plain(s1))
    s2 = torch.matmul(K.transpose(s1), vw)
    tr2 = K.transpose(s2, lam_h, lam_w)
    tr2_plain = K.transpose_plain(s2, lam_h, lam_w)
    require_equal("transpose (divide)", tr2, tr2_plain)
    row("transpose", 8 * c * wp * hp, 0,
        time_ms(lambda: K.transpose(s1)), time_ms(lambda: K.transpose_plain(s1)),
        time_ms(lambda: s1.transpose(1, 2).contiguous()),
        divide_ms=time_ms(lambda: K.transpose(s2, lam_h, lam_w)),
        divide_plain_ms=time_ms(lambda: K.transpose_plain(s2, lam_h, lam_w)),
        divide_bound_ms=bound(8 * c * wp * hp + 4 * (wp + hp), 2 * c * wp * hp)[0])

    u = torch.matmul(K.transpose(torch.matmul(tr2, vh)), vw)
    d_k, d_p = dst_p.clone(), dst_p.clone()
    K.clamp_cast_paste(u, d_k, top + 1, left + 1, h2, w2)
    K.clamp_cast_paste_plain(u, d_p, top + 1, left + 1, h2, w2)
    require_equal("clamp_cast_paste (planar)", d_k, d_p)
    i_k = torch.from_numpy(dst.copy()).to(dev)
    i_p = i_k.clone()
    K.clamp_cast_paste(u, i_k.permute(2, 0, 1), top + 1, left + 1, h2, w2)
    K.clamp_cast_paste_plain(u, i_p.permute(2, 0, 1), top + 1, left + 1, h2, w2)
    require_equal("clamp_cast_paste_interleaved", i_k, i_p)

    def paste(u_, d_img, planar=True, at=(top + 1, left + 1, h2, w2)):
        return K.clamp_cast_paste(u_, d_img if planar else d_img.permute(2, 0, 1), *at)

    row("clamp_cast_paste", 5 * c * h2 * w2, 2 * c * h2 * w2,
        time_ms(lambda: paste(u, d_k)),
        time_ms(lambda: K.clamp_cast_paste_plain(u, d_p, top + 1, left + 1, h2, w2)),
        shape=f"u {tuple(u.shape)} -> u8 ({c},{h2},{w2}) planar",
        **vs_other(lambda: paste(u, d_k), lambda: (paste(u, dst_p.clone()),)))
    row("clamp_cast_paste_interleaved", 5 * c * h2 * w2, 2 * c * h2 * w2,
        time_ms(lambda: paste(u, i_k, False)),
        time_ms(lambda: K.clamp_cast_paste_plain(u, i_p.permute(2, 0, 1), top + 1,
                                                 left + 1, h2, w2)),
        shape=f"u {tuple(u.shape)} -> u8 ({c},{h2},{w2}) interleaved",
        **vs_other(lambda: paste(u, i_k, False),
                   lambda: (paste(u, torch.from_numpy(dst.copy()).to(dev), False),)))
    print_other("clamp_cast_paste headline planar", rows["clamp_cast_paste"])
    print_other("clamp_cast_paste headline interleaved", rows["clamp_cast_paste_interleaved"])
    gemm_line("unfolded", g_tp, vh)
    del s1, s2, tr2, tr2_plain, u

    # -- 2b. the folded chain's kernels, on the pair chain's tensors ------------
    s, d = K.fold_minor(g_tp, h2)
    ws, wd = K.fold_minor_plain(g_tp, h2)
    require_equal("fold_minor (h, s)", s, ws)
    require_equal("fold_minor (h, d)", d, wd)
    fe, fo = torch.matmul(s, vep_h), torch.matmul(d, vop_h)
    tr1 = K.transpose_pair(fe, fo)
    require_equal("transpose_pair", tr1, K.transpose_pair_plain(fe, fo))
    s2, d2 = K.fold_minor(tr1, w2)
    ws2, wd2 = K.fold_minor_plain(tr1, w2)
    require_equal("fold_minor (w, s)", s2, ws2)
    require_equal("fold_minor (w, d)", d2, wd2)
    ge, go = torch.matmul(s2, vep_w), torch.matmul(d2, vop_w)
    lam_gw, lam_gh = fold_b[1].lam, fold_b[0].lam
    wins_h = ((0, ep_h), (ep_h, op_h))
    tr2w = [K.transpose_pair(ge, go, lam_gw, lam_gh, rs, rc) for rs, rc in wins_h]
    for (rs, rc), t in zip(wins_h, tr2w):
        require_equal(f"transpose_pair (divide, rows {rs}+{rc})", t,
                      K.transpose_pair_plain(ge, go, lam_gw, lam_gh, rs, rc))
    e_h, o_h = torch.matmul(tr2w[0], ve2p_h), torch.matmul(tr2w[1], vo2p_h)
    wins_w = ((0, ep_w), (ep_w, op_w))
    t3 = [K.unfold_transpose(e_h, o_h, h2, hp, rs, rc) for rs, rc in wins_w]
    for (rs, rc), t in zip(wins_w, t3):
        require_equal(f"unfold_transpose (rows {rs}+{rc})", t,
                      K.unfold_transpose_plain(e_h, o_h, h2, hp, rs, rc))
    e_w, o_w = torch.matmul(t3[0], ve2p_w), torch.matmul(t3[1], vo2p_w)
    require_equal("unfold_minor", K.unfold_minor(e_w, o_w, w2, wp),
                  K.unfold_minor_plain(e_w, o_w, w2, wp))
    d_k, d_p = dst_p.clone(), dst_p.clone()
    K.unfold_clamp_paste(e_w, o_w, d_k, top + 1, left + 1, h2, w2)
    K.unfold_clamp_paste_plain(e_w, o_w, d_p, top + 1, left + 1, h2, w2)
    require_equal("unfold_clamp_paste (planar)", d_k, d_p)
    i_k = torch.from_numpy(dst.copy()).to(dev)
    i_p = i_k.clone()
    K.unfold_clamp_paste(e_w, o_w, i_k.permute(2, 0, 1), top + 1, left + 1, h2, w2)
    K.unfold_clamp_paste_plain(e_w, o_w, i_p.permute(2, 0, 1), top + 1, left + 1, h2, w2)
    require_equal("unfold_clamp_paste_interleaved", i_k, i_p)
    # the kernels' other paths: a window that is no whole tile (the ragged
    # unfold_transpose), an ep that is no multiple of 4 (the scalar loads)
    require_equal("unfold_transpose (ragged rows 37+101)",
                  K.unfold_transpose(e_h, o_h, h2, hp, 37, 101),
                  K.unfold_transpose_plain(e_h, o_h, h2, hp, 37, 101))
    e_s, o_s = (x[..., : he_w + 1 + (he_w % 4 == 3)].contiguous() for x in (e_w, o_w))
    for name, img, planar in (("unfold_clamp_paste", dst_p, True),
                              ("unfold_clamp_paste_interleaved", torch.from_numpy(dst).to(dev),
                               False)):
        a, b = img.clone(), img.clone()
        for f, x in ((K.unfold_clamp_paste, a), (K.unfold_clamp_paste_plain, b)):
            f(e_s, o_s, x if planar else x.permute(2, 0, 1), top + 1, left + 1, h2, w2)
        require_equal(f"{name} (scalar loads)", a, b)
    del e_s, o_s, a, b

    def unfold_paste(d_img, planar=True):
        return K.unfold_clamp_paste(e_w, o_w, d_img if planar else d_img.permute(2, 0, 1),
                                    top + 1, left + 1, h2, w2)

    row("fold_minor", 4 * c * wp * (h2 + ep_h + op_h), 2 * c * wp * ho_h,
        time_ms(lambda: K.fold_minor(g_tp, h2)), time_ms(lambda: K.fold_minor_plain(g_tp, h2)),
        shape=f"({c},{wp},{hp}) n={h2} -> ({c},{wp},{ep_h}) + ({c},{wp},{op_h})",
        w_ms=time_ms(lambda: K.fold_minor(tr1, w2)),
        w_plain_ms=time_ms(lambda: K.fold_minor_plain(tr1, w2)),
        w_bound_ms=bound(4 * c * (ep_h + op_h) * (w2 + ep_w + op_w),
                         2 * c * (ep_h + op_h) * ho_w)[0])
    gh, gw = ep_h + op_h, ep_w + op_w
    row("transpose_pair", 8 * c * wp * gh, 0,
        time_ms(lambda: K.transpose_pair(fe, fo)),
        time_ms(lambda: K.transpose_pair_plain(fe, fo)),
        shape=f"({c},{wp},{ep_h}) + ({c},{wp},{op_h}) -> ({c},{gh},{wp})",
        divide_ms=time_ms(lambda: K.transpose_pair(ge, go, lam_gw, lam_gh, 0, ep_h)),
        divide_plain_ms=time_ms(lambda: K.transpose_pair_plain(ge, go, lam_gw, lam_gh,
                                                               0, ep_h)),
        divide_bound_ms=bound(8 * c * ep_h * gw + 4 * (gw + ep_h), 2 * c * ep_h * gw)[0],
        divide_shape=f"({c},{gh},{ep_w}) + ({c},{gh},{op_w}) rows 0+{ep_h} -> "
                     f"({c},{gw},{ep_h})",
        **vs_other(lambda: K.transpose_pair(fe, fo)),
        **{f"divide_{k}": v for k, v in vs_other(
            lambda: K.transpose_pair(ge, go, lam_gw, lam_gh, 0, ep_h)).items()})
    row("unfold_transpose", 4 * c * ep_w * (2 * he_h + hp), c * ep_w * h2,
        time_ms(lambda: K.unfold_transpose(e_h, o_h, h2, hp, 0, ep_w)),
        time_ms(lambda: K.unfold_transpose_plain(e_h, o_h, h2, hp, 0, ep_w)),
        shape=f"2x ({c},{gw},{ep_h}) rows 0+{ep_w}, n={h2} -> ({c},{hp},{ep_w})",
        **vs_other(lambda: K.unfold_transpose(e_h, o_h, h2, hp, 0, ep_w)))
    row("unfold_minor", 4 * c * hp * (2 * he_w + wp), c * hp * w2,
        time_ms(lambda: K.unfold_minor(e_w, o_w, w2, wp)),
        time_ms(lambda: K.unfold_minor_plain(e_w, o_w, w2, wp)),
        shape=f"2x ({c},{hp},{ep_w}), n={w2} -> ({c},{hp},{wp})")
    # the shape its one serve launch has: the per-axis strips' folded side
    # (a 128-row slab, the long side unfolded)
    gen_u = torch.Generator(dev).manual_seed(SEED + 5)
    unfold_strips = []
    for sh_, sw_ in ((s_[0] - 2, s_[1] - 2) for s_ in STRIPS):
        n_s, rows_s = max(sh_, sw_), ru128(min(sh_, sw_))
        b_s = dst_bases(sh_, sw_, ru128(sh_), ru128(sw_), dev, folded=True)[int(sw_ > sh_)]
        e_s, o_s = (torch.randn((c, rows_s, b_s.mats[2].shape[1]), generator=gen_u, device=dev)
                    for _ in range(2))
        require_equal(f"unfold_minor strip n={n_s}", K.unfold_minor(e_s, o_s, n_s, b_s.n_pad),
                      K.unfold_minor_plain(e_s, o_s, n_s, b_s.n_pad))
        unfold_strips.append(dict(
            shape=f"2x {tuple(e_s.shape)}, n={n_s} -> ({c},{rows_s},{b_s.n_pad})",
            ms=time_ms(lambda: K.unfold_minor(e_s, o_s, n_s, b_s.n_pad)),
            bound_ms=bound(4 * c * rows_s * (2 * (n_s - n_s // 2) + b_s.n_pad),
                           c * rows_s * n_s)[0]))
    rows["unfold_minor"]["strips"] = unfold_strips
    print(f"unfold_minor on the per-axis strips ({card}): " + "; ".join(
        f"{x['shape']} {x['ms']:.5f} ms cold, bound {x['bound_ms']:.5f}" for x in unfold_strips))
    del e_s, o_s
    # the fused kernels at the shapes of the per-axis strips' serve launches
    # (a 128-lane other side): strip W's divide (transpose_pair) and paste
    # (unfold_clamp_paste), strip H's forward transpose_pair and
    # unfold_transpose
    fused_strips = {"transpose_pair": [], "unfold_transpose": [], "unfold_clamp_paste": []}
    for path, hw_s in STRIP_PATHS.items():
        *_, (sbh, sbw) = prepare_inputs(np.full(hw_s, 255, np.uint8), hw_s + (3,),
                                        DST_HW + (3,), center)
        sh2, sw2 = sbh - 2, sbw - 2
        sbase_h, sbase_w = dst_bases(sh2, sw2, ru128(sh2), ru128(sw2), dev, folded=True)
        fb, ob = (sbase_w, sbase_h) if path == "per_axis_w" else (sbase_h, sbase_w)
        n_s, rows_s = fb.n, ob.n_pad
        sep, sop = fb.mats[0].shape[0], fb.mats[1].shape[0]
        s_he = n_s - n_s // 2
        # the chain's zeros: the other side's padding rows, the fold's
        # padding lanes (0 / x takes another path through an IEEE divide)
        a_s = torch.randn((c, rows_s, sep), generator=gen_u, device=dev)
        b_s = torch.randn((c, rows_s, sop), generator=gen_u, device=dev)
        o_s = torch.randn((c, rows_s, sep), generator=gen_u, device=dev)
        dense = a_s.clone(), b_s.clone()
        for x_, lanes in ((a_s, s_he), (b_s, n_s // 2), (o_s, s_he)):
            x_[:, ob.n:] = 0
            x_[..., lanes:] = 0
        tp_bytes = 8 * c * rows_s * (sep + sop)
        src_copy = torch.randn((c, rows_s, sep + sop), generator=gen_u, device=dev)
        dst_copy = torch.empty_like(src_copy)
        floor = dict(copy_ms=time_ms(lambda: dst_copy.copy_(src_copy)),
                     copy_b2b_ms=b2b_ms(lambda: dst_copy.copy_(src_copy)))
        if path == "per_axis_w":
            lam_p, lam_r = fb.lam, ob.lam
            for a_, b_ in ((a_s, b_s), dense):
                require_equal(f"transpose_pair strip {path}",
                              K.transpose_pair(a_, b_, lam_p, lam_r),
                              K.transpose_pair_plain(a_, b_, lam_p, lam_r))
            fn = (lambda a_s=a_s, b_s=b_s, lp=lam_p, lr=lam_r:
                  K.transpose_pair(a_s, b_s, lp, lr))
            fn_dense = (lambda a_s=dense[0], b_s=dense[1], lp=lam_p, lr=lam_r:
                        K.transpose_pair(a_s, b_s, lp, lr))
            fused_strips["transpose_pair"].append(dict(
                path=path, form="divide", shape=f"({c},{rows_s},{sep}) + ({c},{rows_s},{sop}) -> "
                                                f"({c},{sep + sop},{rows_s})",
                ms=time_ms(fn), bound_ms=bound(tp_bytes + 4 * (sep + sop + rows_s),
                                               2 * c * rows_s * (sep + sop))[0], **vs_other(fn),
                dense_ms=time_ms(fn_dense),
                **{f"dense_{k}": v for k, v in vs_other(fn_dense).items()}, **floor))
            # the paste: rows [0, sh2) of (c, 128, ep) into the planar destination
            at = (top + 1, left + 1, sh2, sw2)
            sd_k, sd_p = dst_p.clone(), dst_p.clone()
            K.unfold_clamp_paste(a_s, o_s, sd_k, *at)
            K.unfold_clamp_paste_plain(a_s, o_s, sd_p, *at)
            require_equal(f"unfold_clamp_paste strip {path}", sd_k, sd_p)
            fn = (lambda a_s=a_s, o_s=o_s, sd_k=sd_k, at=at:
                  K.unfold_clamp_paste(a_s, o_s, sd_k, *at))
            fused_strips["unfold_clamp_paste"].append(dict(
                path=path, shape=f"2x ({c},{rows_s},{sep}) rows 0+{sh2} -> u8 ({c},{sh2},{sw2}) "
                                 "planar",
                ms=time_ms(fn), bound_ms=bound(8 * c * sh2 * s_he + c * sh2 * sw2,
                                               3 * c * sh2 * sw2)[0],
                **vs_other(fn, lambda a_s=a_s, o_s=o_s, at=at: (
                    K.unfold_clamp_paste(a_s, o_s, dst_p.clone(), *at),))))
            del sd_k, sd_p
        else:
            require_equal(f"transpose_pair strip {path}", K.transpose_pair(a_s, b_s),
                          K.transpose_pair_plain(a_s, b_s))
            fn = lambda a_s=a_s, b_s=b_s: K.transpose_pair(a_s, b_s)
            fused_strips["transpose_pair"].append(dict(
                path=path, form="plain", shape=f"({c},{rows_s},{sep}) + ({c},{rows_s},{sop}) -> "
                                               f"({c},{sep + sop},{rows_s})",
                ms=time_ms(fn), bound_ms=bound(tp_bytes, 0)[0], **vs_other(fn), **floor))
            out_pad = fb.n_pad
            require_equal(f"unfold_transpose strip {path}",
                          K.unfold_transpose(a_s, o_s, n_s, out_pad),
                          K.unfold_transpose_plain(a_s, o_s, n_s, out_pad))
            fn = lambda a_s=a_s, o_s=o_s, n=n_s, op_=out_pad: K.unfold_transpose(a_s, o_s, n, op_)
            fused_strips["unfold_transpose"].append(dict(
                path=path, shape=f"2x ({c},{rows_s},{sep}), n={n_s} -> ({c},{out_pad},{rows_s})",
                ms=time_ms(fn), bound_ms=bound(4 * c * rows_s * (2 * s_he + out_pad),
                                               c * rows_s * n_s)[0], **vs_other(fn)))
        del a_s, b_s, o_s, dense, src_copy, dst_copy
    for name, xs_ in fused_strips.items():
        print(f"{name} on the per-axis strips ({card}): " + "; ".join(
            f"{x['path']} {x['shape']} {x['ms']:.5f} ms cold, {x['b2b_ms']:.5f} back to back, "
            f"bound {x['bound_ms']:.5f}" + (f", other {x['other_ms']:.5f} / "
                                            f"{x['other_b2b_ms']:.5f}" if "other_ms" in x else "")
            + (f"; without zeros {x['dense_ms']:.5f} / {x['dense_b2b_ms']:.5f}"
               + (f", other {x['dense_other_ms']:.5f} / {x['dense_other_b2b_ms']:.5f}"
                  if "dense_other_ms" in x else "") if "dense_ms" in x else "")
            + (f"; a copy of the same bytes {x['copy_ms']:.5f} / {x['copy_b2b_ms']:.5f}"
               if "copy_ms" in x else "")
            for x in xs_))
    ucp_bytes, ucp_ops = 8 * c * h2 * he_w + c * h2 * w2, 3 * c * h2 * w2
    row("unfold_clamp_paste", ucp_bytes, ucp_ops,
        time_ms(lambda: unfold_paste(d_k)),
        time_ms(lambda: K.unfold_clamp_paste_plain(e_w, o_w, d_p, top + 1, left + 1,
                                                   h2, w2)),
        shape=f"2x ({c},{hp},{ep_w}) -> u8 ({c},{h2},{w2}) planar",
        **vs_other(lambda: unfold_paste(d_k), lambda: (unfold_paste(dst_p.clone()),)))
    row("unfold_clamp_paste_interleaved", ucp_bytes, ucp_ops,
        time_ms(lambda: unfold_paste(i_k, False)),
        time_ms(lambda: K.unfold_clamp_paste_plain(e_w, o_w, i_p.permute(2, 0, 1), top + 1,
                                                   left + 1, h2, w2)),
        shape=f"2x ({c},{hp},{ep_w}) -> u8 ({c},{h2},{w2}) interleaved",
        **vs_other(lambda: unfold_paste(i_k, False),
                   lambda: (unfold_paste(torch.from_numpy(dst.copy()).to(dev), False),)))
    for name, xs_ in fused_strips.items():
        rows[name]["strips"] = xs_
    gemm_line("pair", s, vep_h)
    gemm_line("pair", s2, vep_w)
    del (s, d, ws, wd, fe, fo, tr1, s2, d2, ws2, wd2, ge, go, tr2w, e_h, o_h, t3, e_w, o_w,
         d_k, d_p, i_k, i_p)

    # -- 2c. the multigrid kernels, at the 8K frame's fine level and its first
    #    transposed coarse level -------------------------------------------------
    src8 = synthetic_image(rng, SRC_8K)
    dst8 = synthetic_image(rng, DST_8K)
    mask8 = np.full(SRC_8K, 255, np.uint8)
    ctr8 = (DST_8K[1] // 2, DST_8K[0] // 2)
    m8, (x8, y8), (left8, top8), (bh8, bw8) = prepare_inputs(mask8, src8.shape, dst8.shape,
                                                             ctr8)
    h8, w8 = bh8 - 2, bw8 - 2
    _, hp8, wp8, hp28 = K.mg_geometry_t(h8, w8)
    dst8_p = torch.from_numpy(dst8).to(dev).permute(2, 0, 1).contiguous()
    dest8 = dst8_p[:, top8 : top8 + bh8, left8 : left8 + bw8]
    src8_roi = torch.from_numpy(src8).to(dev)[y8 : y8 + bh8, x8 : x8 + bw8].permute(2, 0, 1)
    mask8_roi = torch.from_numpy(np.ascontiguousarray(m8[y8 : y8 + bh8, x8 : x8 + bw8])).to(dev)
    patch8 = torch.where(mask8_roi[None] != 0, src8_roi, 0).to(torch.uint8)
    m8_01 = (mask8_roi != 0).to(torch.uint8)
    me8 = K.erode3(m8_01)
    require_equal("erode3 8K", me8, K.erode3_plain(m8_01))
    require_equal("erode3 8K {0,255}", K.erode3(mask8_roi), me8)
    rows["erode3"].update(eight_k_shape=f"({bh8},{bw8})",
                          eight_k_ms=time_ms(lambda: K.erode3(m8_01)),
                          eight_k_bound_ms=bound(2 * bh8 * bw8, 12 * bh8 * bw8)[0],
                          **{f"eight_k_{k}": v
                             for k, v in vs_other(lambda: K.erode3(m8_01)).items()})
    print(f"8K geometry: roi {bh8}x{bw8}, interior {h8}x{w8} ({h8 * w8 / 1e6:.1f} MP), "
          f"level-0 slab ({c}, {hp8}, {wp8}), rh rows {hp28}")
    gray8 = bgr_to_gray_u8(patch8).to(torch.uint8)[None].expand(c, bh8, bw8)
    for flags, rule, p_in in ((1, "opencv", patch8), (2, "opencv", patch8),
                              (2, "norm", patch8), (1, "opencv", gray8)):
        for ohw in ((hp8, wp8), (h8, w8)):
            require_equal(f"preprocess_rhs_p flags={flags} {rule} {ohw}",
                          K.preprocess_rhs_p(dest8, p_in, me8, ohw, flags, rule),
                          K.preprocess_rhs_p_plain(dest8, p_in, me8, ohw, flags, rule))
    g8 = K.preprocess_rhs_p(dest8, patch8, me8, (hp8, wp8))
    row("preprocess_rhs_p", 2 * c * bh8 * bw8 + bh8 * bw8 + 4 * c * hp8 * wp8,
        30 * c * bh8 * bw8,
        time_ms(lambda: K.preprocess_rhs_p(dest8, patch8, me8, (hp8, wp8))),
        time_ms(lambda: K.preprocess_rhs_p_plain(dest8, patch8, me8, (hp8, wp8))),
        shape=f"u8 ({c},{bh8},{bw8}) -> ({c},{hp8},{wp8})",
        **vs_other(lambda: K.preprocess_rhs_p(dest8, patch8, me8, (hp8, wp8))))

    def mg_level_checks(label, g, u, h, w, bh, bw, rh_rows):
        """mg_down (known-zero and given guess), mg_restrict_t, mg_prolong_t
        and mg_up of one level against their twins, and the fused forms
        mg_down_t / mg_up_t against theirs and against those pairs; returns
        the tensors."""
        hc, wc = (h - 1) // 2, (w - 1) // 2
        cgeom = K.mg_geometry_t(wc, hc, wp_min=rh_rows)
        u0, rh0 = K.mg_down(None, g, 1, h, w, bh, bw, rh_rows)
        w0, wrh0 = K.mg_down_plain(None, g, 1, h, w, bh, bw, rh_rows)
        require_equal(f"mg_down {label} (known-zero guess) u", u0, w0)
        require_equal(f"mg_down {label} (known-zero guess) rh", rh0, wrh0)
        if u is not None:
            u1, rh1 = K.mg_down(u, g, 1, h, w, bh, bw, rh_rows)
            w1, wrh1 = K.mg_down_plain(u, g, 1, h, w, bh, bw, rh_rows)
            require_equal(f"mg_down {label} u", u1, w1)
            require_equal(f"mg_down {label} rh", rh1, wrh1)
        rc = K.mg_restrict_t(rh0, h, w, bw, cgeom[1])
        require_equal(f"mg_restrict_t {label}", rc, K.mg_restrict_t_plain(rh0, h, w, bw,
                                                                            cgeom[1]))
        # the coarse RHS stands in for a coarse solution: same shape, same zeros
        e = K.mg_prolong_t(rc, w, bw, rh_rows, g.shape[2])
        require_equal(f"mg_prolong_t {label}", e,
                      K.mg_prolong_t_plain(rc, w, bw, rh_rows, g.shape[2]))
        up = K.mg_up(u0, g, e, 2, h, w, bh, bw)
        require_equal(f"mg_up {label}", up, K.mg_up_plain(u0, g, e, 2, h, w, bh, bw))
        for guess, what in ((None, " (known-zero guess)"), (u, "")):
            if what and u is None:
                continue
            got = K.mg_down_t(guess, g, 1, h, w, bh, bw, cgeom[1])
            want = K.mg_down_t_plain(guess, g, 1, h, w, bh, bw, cgeom[1])
            u_p, rh_p = K.mg_down(guess, g, 1, h, w, bh, bw, rh_rows)
            pair = (u_p, K.mg_restrict_t(rh_p, h, w, bw, cgeom[1]))
            for a, b, c_, part in zip(got, want, pair, ("u", "rc_t")):
                require_equal(f"mg_down_t {label}{what} {part}", a, b)
                require_equal(f"mg_down_t {label}{what} {part} (the unfused pair's)", a, c_)
        up_t = K.mg_up_t(u0, g, rc, 2, h, w, bh, bw)
        require_equal(f"mg_up_t {label}", up_t, K.mg_up_t_plain(u0, g, rc, 2, h, w, bh, bw))
        require_equal(f"mg_up_t {label} (the unfused pair's)", up_t, up)
        return u0, rh0, rc, e, cgeom

    u8, rh8, rc8, e8, cgeom8 = mg_level_checks("8K level 0", g8, None, h8, w8, 1.0, 1.0, hp28)
    hc8, wc8 = (h8 - 1) // 2, (w8 - 1) // 2
    _, bh1 = TM._coarsen(h8, 1.0)
    _, bw1 = TM._coarsen(w8, 1.0)
    # the child level: logical (wc, hc), transposed, betas swapped
    _, _, rc1, _, _ = mg_level_checks("8K level 1", rc8, None, wc8, hc8, bw1, bh1, cgeom8[3])
    mg_level_checks("8K level 0 (second cycle)", g8, u8, h8, w8, 1.0, 1.0, hp28)
    print(f"8K level 1: ({c}, {cgeom8[1]}, {cgeom8[2]}), logical {wc8}x{hc8}, betas "
          f"({bw1}, {bh1}); level 2 RHS {tuple(rc1.shape)}")
    lvl = (f"coarse level 1 ({c},{cgeom8[1]},{cgeom8[2]}) logical {wc8}x{hc8} "
           f"beta ({bw1},{bh1})")
    u1c, rh1c = K.mg_down(None, rc8, 1, wc8, hc8, bw1, bh1, cgeom8[3])
    e1c = K.mg_prolong_t(rc1, hc8, bh1, cgeom8[3], cgeom8[2])
    row("mg_down", 4 * c * (3 * hp8 * wp8 + hp28 * wp8), c * h8 * w8 * 11 + c * hc8 * w8 * 5,
        time_ms(lambda: K.mg_down(u8, g8, 1, h8, w8, 1.0, 1.0, hp28)),
        time_ms(lambda: K.mg_down_plain(u8, g8, 1, h8, w8, 1.0, 1.0, hp28)),
        shape=f"u, g ({c},{hp8},{wp8}), nu1=1 -> u, rh ({c},{hp28},{wp8})",
        zero_guess_ms=time_ms(lambda: K.mg_down(None, g8, 1, h8, w8, 1.0, 1.0, hp28)),
        coarse_ms=time_ms(lambda: K.mg_down(None, rc8, 1, wc8, hc8, bw1, bh1, cgeom8[3])),
        coarse_shape=lvl, **vs_other(lambda: K.mg_down(u8, g8, 1, h8, w8, 1.0, 1.0, hp28)))
    row("mg_up", 4 * c * (3 * hp8 * wp8 + hc8 * wp8), c * h8 * w8 * 12,
        time_ms(lambda: K.mg_up(u8, g8, e8, 2, h8, w8)),
        time_ms(lambda: K.mg_up_plain(u8, g8, e8, 2, h8, w8)),
        shape=f"u, g ({c},{hp8},{wp8}) + e ({c},{hp28},{wp8}), nu2=2 -> ({c},{hp8},{wp8})",
        coarse_ms=time_ms(lambda: K.mg_up(u1c, rc8, e1c, 2, wc8, hc8, bw1, bh1)),
        coarse_shape=lvl, **vs_other(lambda: K.mg_up(u8, g8, e8, 2, h8, w8)))
    row("mg_restrict_t", 4 * c * (hc8 * wp8 + cgeom8[1] * hp28), 3 * c * hc8 * wc8,
        time_ms(lambda: K.mg_restrict_t(rh8, h8, w8, 1.0, cgeom8[1])),
        time_ms(lambda: K.mg_restrict_t_plain(rh8, h8, w8, 1.0, cgeom8[1])),
        shape=f"({c},{hp28},{wp8}) -> ({c},{cgeom8[1]},{hp28})",
        coarse_ms=time_ms(lambda: K.mg_restrict_t(rh1c, wc8, hc8, bh1, rc1.shape[1])),
        coarse_shape=lvl)
    row("mg_prolong_t", 4 * c * (wc8 * hp28 + hp28 * wp8), 2 * c * hp28 * w8,
        time_ms(lambda: K.mg_prolong_t(rc8, w8, 1.0, hp28, wp8)),
        time_ms(lambda: K.mg_prolong_t_plain(rc8, w8, 1.0, hp28, wp8)),
        shape=f"({c},{cgeom8[1]},{cgeom8[2]}) -> ({c},{hp28},{wp8})",
        coarse_ms=time_ms(lambda: K.mg_prolong_t(rc1, hc8, bh1, cgeom8[3], cgeom8[2])),
        coarse_shape=lvl)
    # the fused forms at the "t" chain's level 0 (given guess), the unfused
    # pair beside each; level 1 below, as the "q" chain's coarse level 1
    rows8 = cgeom8[1]

    def down_t0():
        return K.mg_down_t(u8, g8, 1, h8, w8, 1.0, 1.0, rows8)

    def down_pair0():
        u_p, rh_p = K.mg_down(u8, g8, 1, h8, w8, 1.0, 1.0, hp28)
        return u_p, K.mg_restrict_t(rh_p, h8, w8, 1.0, rows8)

    def up_t0():
        return K.mg_up_t(u8, g8, rc8, 2, h8, w8)

    def up_pair0():
        return K.mg_up(u8, g8, K.mg_prolong_t(rc8, w8, 1.0, hp28, wp8), 2, h8, w8)

    row("mg_down_t", 4 * c * (3 * hp8 * wp8 + rows8 * hp28),
        c * h8 * w8 * 11 + c * hc8 * w8 * 5 + 3 * c * hc8 * wc8, time_ms(down_t0),
        time_ms(lambda: K.mg_down_t_plain(u8, g8, 1, h8, w8, 1.0, 1.0, rows8)),
        shape=f"u, g ({c},{hp8},{wp8}), nu1=1 -> u, rc_t ({c},{rows8},{hp28})",
        pair_ms=time_ms(down_pair0), pair_b2b_ms=b2b_ms(down_pair0),
        zero_guess_ms=time_ms(lambda: K.mg_down_t(None, g8, 1, h8, w8, 1.0, 1.0, rows8)),
        **vs_other(down_t0, pair=down_pair0))
    row("mg_up_t", 4 * c * (3 * hp8 * wp8 + wc8 * hc8), c * h8 * w8 * 12 + 2 * c * hc8 * w8,
        time_ms(up_t0), time_ms(lambda: K.mg_up_t_plain(u8, g8, rc8, 2, h8, w8)),
        shape=f"u, g ({c},{hp8},{wp8}) + ec_t ({c},{rows8},{hp28}), nu2=2 -> "
              f"({c},{hp8},{wp8})",
        pair_ms=time_ms(up_pair0), pair_b2b_ms=b2b_ms(up_pair0),
        **vs_other(up_t0, pair=up_pair0))
    for name in ("mg_down_t", "mg_up_t"):
        r = rows[name]
        print(f"{name} at the 8K 't' level 0 ({card}): {r['ms']:.5f} ms cold, "
              f"{r['b2b_ms']:.5f} back to back; the unfused pair {r['pair_ms']:.5f} / "
              f"{r['pair_b2b_ms']:.5f}; bound {r['bound_ms']:.5f}")
    del u8, rh8, rc8, e8, rc1, u1c, rh1c, e1c

    # the "q" chain's fused coarse levels at 8K (each transposed, betas
    # swapped): mg_up (given guess, nu2 = 2) and mg_down (known-zero guess)
    # against their twins, timed cold and back to back, each with its bound
    gen8 = torch.Generator(dev).manual_seed(SEED + 2)
    coarse_q = TM.q_coarse_levels(h8, w8)
    if len(coarse_q) != MG_LEVELS["mg_q"]:
        raise AssertionError(f"the 8K 'q' chain has {len(coarse_q)} fused coarse levels")
    up_levels, down_levels, restrict_levels, prolong_levels = [], [], [], []
    down_t_levels, up_t_levels = [], []
    for lh, lw, bh_l, bw_l, (_, hp_c, wp_c, hp2_c) in coarse_q:
        g_c = torch.zeros((c, hp_c, wp_c), device=dev)
        u_c = torch.zeros((c, hp_c, wp_c), device=dev)
        e_c = torch.zeros((c, hp2_c, wp_c), device=dev)
        hc_l = (lh - 1) // 2
        g_c[:, :lh, :lw] = torch.randn((c, lh, lw), generator=gen8, device=dev) * 50.0
        u_c[:, :lh, :lw] = torch.randn((c, lh, lw), generator=gen8, device=dev) * 10.0
        e_c[:, :hc_l, :lw] = torch.randn((c, hc_l, lw), generator=gen8, device=dev) * 5.0
        a_l = (lh, lw, bh_l, bw_l)
        shape = f"({c},{hp_c},{wp_c}) logical {lh}x{lw} beta ({bh_l},{bw_l})"
        require_equal(f"mg_up 8K coarse {shape}", K.mg_up(u_c, g_c, e_c, 2, *a_l),
                      K.mg_up_plain(u_c, g_c, e_c, 2, *a_l))
        for got, want, what in zip(K.mg_down(None, g_c, 1, *a_l, hp2_c),
                                   K.mg_down_plain(None, g_c, 1, *a_l, hp2_c), ("u", "rh")):
            require_equal(f"mg_down 8K coarse {shape} (known-zero guess) {what}", got, want)
        def up(u_c=u_c, g_c=g_c, e_c=e_c, a_l=a_l):
            return K.mg_up(u_c, g_c, e_c, 2, *a_l)

        def down(g_c=g_c, a_l=a_l, r=hp2_c):
            return K.mg_down(None, g_c, 1, *a_l, r)

        up_levels.append(dict(shape=shape, ms=time_ms(up), bound_ms=bound(
            4 * c * (3 * hp_c * wp_c + hc_l * wp_c), c * lh * lw * 12)[0], **vs_other(up)))
        down_levels.append(dict(shape=shape, ms=time_ms(down),
                                bound_ms=bound(4 * c * (2 * hp_c * wp_c + hp2_c * wp_c),
                                               c * lh * lw * 11 + c * hc_l * lw * 5)[0],
                                **vs_other(down)))
        # the level's transfers as vcycle_t runs them: rh -> the transposed
        # child's RHS, and the child's correction back along w
        wc_l = (lw - 1) // 2
        chp = K.mg_geometry_t(wc_l, hc_l, wp_min=hp2_c)[1]
        rh_c = down()[1]
        rc_c = K.mg_restrict_t(rh_c, lh, lw, bw_l, chp)
        require_equal(f"mg_restrict_t 8K coarse {shape}", rc_c,
                      K.mg_restrict_t_plain(rh_c, lh, lw, bw_l, chp))
        e_l = K.mg_prolong_t(rc_c, lw, bw_l, hp2_c, wp_c)
        require_equal(f"mg_prolong_t 8K coarse {shape}", e_l,
                      K.mg_prolong_t_plain(rc_c, lw, bw_l, hp2_c, wp_c))
        restrict_levels.append(dict(shape=shape, ms=time_ms(
            lambda rh_c=rh_c, a_l=(lh, lw, bw_l, chp): K.mg_restrict_t(rh_c, *a_l)),
            bound_ms=bound(4 * c * (hc_l * wp_c + chp * hp2_c), 3 * c * hc_l * wc_l)[0]))
        prolong_levels.append(dict(shape=shape, ms=time_ms(
            lambda rc_c=rc_c, a_l=(lw, bw_l, hp2_c, wp_c): K.mg_prolong_t(rc_c, *a_l)),
            bound_ms=bound(4 * c * (wc_l * hp2_c + hp2_c * wp_c), 2 * c * hp2_c * lw)[0]))
        # the fused forms as vcycle_t runs them (the known-zero descent; the
        # level's rc_t standing in for the child's correction), each against
        # its twin and its unfused pair, the pair timed beside it

        def down_t(g_c=g_c, a_l=a_l, o=chp):
            return K.mg_down_t(None, g_c, 1, *a_l, o)

        def down_pair(g_c=g_c, a_l=a_l, r=hp2_c, o=chp):
            u_p, rh_p = K.mg_down(None, g_c, 1, *a_l, r)
            return u_p, K.mg_restrict_t(rh_p, a_l[0], a_l[1], a_l[3], o)

        def up_t(u_c=u_c, g_c=g_c, ec=rc_c, a_l=a_l):
            return K.mg_up_t(u_c, g_c, ec, 2, *a_l)

        def up_pair(u_c=u_c, g_c=g_c, ec=rc_c, a_l=a_l, r=hp2_c, wp_c=wp_c):
            return K.mg_up(u_c, g_c, K.mg_prolong_t(ec, a_l[1], a_l[3], r, wp_c), 2, *a_l)

        for a, b, c_, part in zip(down_t(), K.mg_down_t_plain(None, g_c, 1, *a_l, chp),
                                  down_pair(), ("u", "rc_t")):
            require_equal(f"mg_down_t 8K coarse {shape} {part}", a, b)
            require_equal(f"mg_down_t 8K coarse {shape} {part} (the unfused pair's)", a, c_)
        require_equal(f"mg_up_t 8K coarse {shape}", up_t(),
                      K.mg_up_t_plain(u_c, g_c, rc_c, 2, *a_l))
        require_equal(f"mg_up_t 8K coarse {shape} (the unfused pair's)", up_t(), up_pair())
        down_t_levels.append(dict(
            shape=shape, ms=time_ms(down_t), pair_ms=time_ms(down_pair),
            pair_b2b_ms=b2b_ms(down_pair),
            bound_ms=bound(4 * c * (2 * hp_c * wp_c + chp * hp2_c),
                           c * lh * lw * 11 + c * hc_l * lw * 5 + 3 * c * hc_l * wc_l)[0],
            **vs_other(down_t, pair=down_pair)))
        up_t_levels.append(dict(
            shape=shape, ms=time_ms(up_t), pair_ms=time_ms(up_pair), pair_b2b_ms=b2b_ms(up_pair),
            bound_ms=bound(4 * c * (3 * hp_c * wp_c + wc_l * hc_l),
                           c * lh * lw * 12 + 2 * c * hc_l * lw)[0],
            **vs_other(up_t, pair=up_pair)))
        del g_c, u_c, e_c, rh_c, rc_c, e_l
    for name, lv in (("mg_up", up_levels), ("mg_down", down_levels),
                     ("mg_restrict_t", restrict_levels), ("mg_prolong_t", prolong_levels),
                     ("mg_down_t", down_t_levels), ("mg_up_t", up_t_levels)):
        rows[name].update(coarse_levels=lv, coarse_bound_ms=lv[0]["bound_ms"],
                          coarse_sum_ms=sum(x["ms"] for x in lv),
                          coarse_sum_bound_ms=sum(x["bound_ms"] for x in lv))
        print(f"{name} at the 8K 'q' coarse levels ({card}): " + "; ".join(
            f"{x['shape']} {x['ms']:.5f} ms cold, "
            + (f"{x['b2b_ms']:.5f} back to back, " if "b2b_ms" in x else "")
            + (f"the unfused pair {x['pair_ms']:.5f} / {x['pair_b2b_ms']:.5f}, "
               if "pair_ms" in x else "")
            + f"bound {x['bound_ms']:.5f}" + (f", other {x['other_ms']:.5f} / {x['other_b2b_ms']:.5f}"
                                      if "other_ms" in x else "") for x in lv))

    # the dense rounded chain's (mg_padded=True) fused levels at 8K, each on
    # mg_geometry's slab: level 0 is the 8K slab timed above; mg_down (given
    # and known-zero guess) and mg_up (nu2 = 2) at the coarse levels, bit-exact
    # against their twins, timed cold, each with its bound
    p8 = TM.p_levels(h8, w8)
    if len(p8) != MG_LEVELS["mg_padded_true"] or p8[0][4][1:] != (hp8, wp8):
        raise AssertionError(f"the 8K dense chain's levels {[lv[:4] for lv in p8]}")
    dense_down, dense_up = [], []
    for lh, lw, bh_l, bw_l, (th_l, hp_l, wp_l) in p8[1:]:
        hc_l = (lh - 1) // 2
        g_l = torch.zeros((c, hp_l, wp_l), device=dev)
        u_l = torch.zeros((c, hp_l, wp_l), device=dev)
        e_l = torch.zeros((c, hp_l // 2, wp_l), device=dev)
        g_l[:, :lh, :lw] = torch.randn((c, lh, lw), generator=gen8, device=dev) * 50.0
        u_l[:, :lh, :lw] = torch.randn((c, lh, lw), generator=gen8, device=dev) * 10.0
        e_l[:, :hc_l, :lw] = torch.randn((c, hc_l, lw), generator=gen8, device=dev) * 5.0
        a_l = (lh, lw, bh_l, bw_l)
        shape = f"({c},{hp_l},{wp_l}) th {th_l}, logical {lh}x{lw} beta ({bh_l},{bw_l})"
        for guess, gname in ((None, "known-zero"), (u_l, "given")):
            for got, want, what in zip(K.mg_down(guess, g_l, 1, *a_l),
                                       K.mg_down_plain(guess, g_l, 1, *a_l), ("u", "rh")):
                require_equal(f"mg_down dense 8K {shape} ({gname} guess) {what}", got, want)
        require_equal(f"mg_up dense 8K {shape}", K.mg_up(u_l, g_l, e_l, 2, *a_l),
                      K.mg_up_plain(u_l, g_l, e_l, 2, *a_l))
        dense_down.append(dict(
            shape=shape, ms=time_ms(lambda g_l=g_l, a_l=a_l: K.mg_down(None, g_l, 1, *a_l)),
            given_guess_ms=time_ms(
                lambda g_l=g_l, u_l=u_l, a_l=a_l: K.mg_down(u_l, g_l, 1, *a_l)),
            bound_ms=bound(4 * c * (2 * hp_l * wp_l + hp_l // 2 * wp_l),
                           c * lh * lw * 11 + c * hc_l * lw * 5)[0]))
        dense_up.append(dict(
            shape=shape, ms=time_ms(lambda u_l=u_l, g_l=g_l, e_l=e_l, a_l=a_l:
                                    K.mg_up(u_l, g_l, e_l, 2, *a_l)),
            bound_ms=bound(4 * c * (3 * hp_l * wp_l + hc_l * wp_l), c * lh * lw * 12)[0]))
        del g_l, u_l, e_l
    for name, lv in (("mg_down", dense_down), ("mg_up", dense_up)):
        rows[name]["dense_levels"] = lv
        print(f"{name} at the 8K dense chain's coarse levels ({card}): " + "; ".join(
            f"{x['shape']} {x['ms']:.5f} ms cold"
            + (f" (given guess {x['given_guess_ms']:.5f})" if "given_guess_ms" in x else "")
            + f", bound {x['bound_ms']:.5f}" for x in lv))

    # -- 2d. the quarter-plane kernels, at the 8K frame's quarter planes -------
    _, hq8, wq28, hp2q8 = K.mg_geometry_q(h8, w8)
    chp8 = K.mg_geometry_t(wc8, hc8, wp_min=hp2q8)[1]
    qhw8 = (2 * hq8, 2 * wq28)
    for flags, rule, p_in in ((1, "opencv", patch8), (2, "opencv", patch8),
                              (2, "norm", patch8), (1, "opencv", gray8)):
        require_equal(f"preprocess_rhs_q flags={flags} {rule}",
                      K.preprocess_rhs_q(dest8, p_in, me8, qhw8, flags, rule),
                      K.preprocess_rhs_q_plain(dest8, p_in, me8, qhw8, flags, rule))
    gq8 = K.preprocess_rhs_q(dest8, patch8, me8, qhw8)
    qplanes, qhalf, rct = c * 4 * hq8 * wq28, c * hq8 * wq28, c * chp8 * hq8
    qshape = f"({c},4,{hq8},{wq28})"
    print(f"8K quarter level: planes {qshape}, coarse RHS ({c},{chp8},{hq8}) transposed")
    row("preprocess_rhs_q", 2 * c * bh8 * bw8 + bh8 * bw8 + 4 * qplanes, 30 * c * bh8 * bw8,
        time_ms(lambda: K.preprocess_rhs_q(dest8, patch8, me8, qhw8)),
        time_ms(lambda: K.preprocess_rhs_q_plain(dest8, patch8, me8, qhw8)),
        shape=f"u8 ({c},{bh8},{bw8}) -> {qshape}",
        **vs_other(lambda: K.preprocess_rhs_q(dest8, patch8, me8, qhw8)))
    # the slab's yardstick in this call: the same u8 inputs and output bytes
    rhs_p8 = rows["preprocess_rhs_p"]
    rhs_p8.update(rhs_q_ms=rows["preprocess_rhs_q"]["ms"],
                  rhs_q_b2b_ms=rows["preprocess_rhs_q"]["b2b_ms"])
    print(f"preprocess_rhs_p 8K slab ({card}): {rhs_p8['ms']:.5f} ms cold, "
          f"{rhs_p8['b2b_ms']:.5f} back to back; preprocess_rhs_q {rhs_p8['rhs_q_ms']:.5f}, "
          f"{rhs_p8['rhs_q_b2b_ms']:.5f}; bound {rhs_p8['bound_ms']:.5f}"
          + (f"; other {rhs_p8['other_ms']:.5f} / {rhs_p8['other_b2b_ms']:.5f}"
             if "other_ms" in rhs_p8 else ""))
    uq0, rcq0 = K.mg_down_q(None, gq8, 1, h8, w8, chp8)
    for got, want, what in zip((uq0, rcq0), K.mg_down_q_plain(None, gq8, 1, h8, w8, chp8),
                               ("u", "rc_t")):
        require_equal(f"mg_down_q 8K (known-zero guess) {what}", got, want)
    for got, want, what in zip(K.mg_down_q(uq0, gq8, 1, h8, w8, chp8),
                               K.mg_down_q_plain(uq0, gq8, 1, h8, w8, chp8), ("u", "rc_t")):
        require_equal(f"mg_down_q 8K {what}", got, want)
    # the coarse RHS stands in for a coarse solution: same shape, same zeros
    e_q = K.mg_prolong_tq(rcq0, w8, hp2q8, wq28)
    for got, want, what in zip(e_q, K.mg_prolong_tq_plain(rcq0, w8, hp2q8, wq28),
                               ("even", "odd")):
        require_equal(f"mg_prolong_tq 8K {what}", got, want)
    require_equal("mg_up_q 8K", K.mg_up_q(uq0, gq8, *e_q, 2, h8, w8),
                  K.mg_up_q_plain(uq0, gq8, *e_q, 2, h8, w8))
    for wr in (False, True):
        for got, want, what in zip(K.mg_ud_q(uq0, gq8, *e_q, 2, 1, h8, w8, chp8, wr),
                                   K.mg_ud_q_plain(uq0, gq8, *e_q, 2, 1, h8, w8, chp8, wr),
                                   ("u", "rc_t", "rmax")):
            require_equal(f"mg_ud_q 8K {what}" + (" (with_residual)" if wr else ""), got,
                          want)
    # the check-first loop's forms: the split descent, its restriction (equal
    # to the fused rc_t), the ascent with its residual
    for guess, label in ((None, " (known-zero guess)"), (uq0, "")):
        split = K.mg_down_q(guess, gq8, 1, h8, w8)
        for got, want, what in zip(split, K.mg_down_q_plain(guess, gq8, 1, h8, w8),
                                   ("u", "rh_e", "rh_o")):
            require_equal(f"mg_down_q 8K split{label} {what}", got, want)
    rh_q = K.mg_down_q(None, gq8, 1, h8, w8)[1:]
    rct_s = K.mg_restrict_tq(*rh_q, h8, w8, chp8)
    require_equal("mg_restrict_tq 8K", rct_s, K.mg_restrict_tq_plain(*rh_q, h8, w8, chp8))
    require_equal("mg_restrict_tq 8K (the fused descent's rc_t)", rct_s, rcq0)
    for got, want, what in zip(K.mg_up_q(uq0, gq8, *e_q, 2, h8, w8, with_residual=True),
                               K.mg_up_q_plain(uq0, gq8, *e_q, 2, h8, w8, True),
                               ("u", "rmax")):
        require_equal(f"mg_up_q 8K (with_residual) {what}", got, want)
    # the conversions over the whole footprint, padding included
    xd8 = torch.randn((c, 2 * hq8, 2 * wq28), generator=torch.Generator(dev).manual_seed(SEED),
                      device=dev)
    xq8 = K.to_quarters(xd8)
    require_equal("to_quarters 8K", xq8, K.to_quarters_plain(xd8))
    require_equal("from_quarters 8K", K.from_quarters(xq8), K.from_quarters_plain(xq8))
    require_equal("from_quarters 8K (the inverse)", K.from_quarters(xq8), xd8)
    uq_paste = uq0 * 40.0 + 100.0  # values across [0, 255] and beyond
    d_k, d_p = dst8_p.clone(), dst8_p.clone()
    K.clamp_cast_paste_q(uq_paste, d_k, top8 + 1, left8 + 1, h8, w8)
    K.clamp_cast_paste_q_plain(uq_paste, d_p, top8 + 1, left8 + 1, h8, w8)
    require_equal("clamp_cast_paste_q (planar)", d_k, d_p)
    i_k = torch.from_numpy(dst8.copy()).to(dev)
    i_p = i_k.clone()
    K.clamp_cast_paste_q(uq_paste, i_k.permute(2, 0, 1), top8 + 1, left8 + 1, h8, w8)
    K.clamp_cast_paste_q_plain(uq_paste, i_p.permute(2, 0, 1), top8 + 1, left8 + 1, h8, w8)
    require_equal("clamp_cast_paste_q_interleaved", i_k, i_p)
    pts8 = c * h8 * w8
    row("mg_down_q", 4 * (3 * qplanes + rct), 11 * pts8,
        time_ms(lambda: K.mg_down_q(uq0, gq8, 1, h8, w8, chp8)),
        time_ms(lambda: K.mg_down_q_plain(uq0, gq8, 1, h8, w8, chp8)),
        shape=f"u, g {qshape}, nu1=1 -> u, rc_t ({c},{chp8},{hq8})",
        zero_guess_ms=time_ms(lambda: K.mg_down_q(None, gq8, 1, h8, w8, chp8)),
        zero_guess_bound_ms=bound(4 * (2 * qplanes + rct), 11 * pts8)[0],
        split_shape=f"u, g {qshape}, nu1=1 -> u, rh_e, rh_o 2x ({c},{hq8},{wq28})",
        split_ms=time_ms(lambda: K.mg_down_q(uq0, gq8, 1, h8, w8)),
        split_plain_ms=time_ms(lambda: K.mg_down_q_plain(uq0, gq8, 1, h8, w8)),
        split_bound_ms=bound(4 * (3 * qplanes + 2 * qhalf), 11 * pts8)[0],
        split_zero_guess_ms=time_ms(lambda: K.mg_down_q(None, gq8, 1, h8, w8)),
        split_zero_guess_bound_ms=bound(4 * (2 * qplanes + 2 * qhalf), 11 * pts8)[0],
        **vs_other(lambda: K.mg_down_q(uq0, gq8, 1, h8, w8, chp8)))
    row("mg_up_q", 4 * (3 * qplanes + 2 * qhalf), 14 * pts8,
        time_ms(lambda: K.mg_up_q(uq0, gq8, *e_q, 2, h8, w8)),
        time_ms(lambda: K.mg_up_q_plain(uq0, gq8, *e_q, 2, h8, w8)),
        shape=f"u, g {qshape} + e_even, e_odd ({c},{hq8},{wq28}), nu2=2 -> u",
        with_residual_ms=time_ms(lambda: K.mg_up_q(uq0, gq8, *e_q, 2, h8, w8, True)),
        with_residual_plain_ms=time_ms(lambda: K.mg_up_q_plain(uq0, gq8, *e_q, 2, h8, w8,
                                                               True)),
        with_residual_bound_ms=bound(4 * (3 * qplanes + 2 * qhalf), 19 * pts8)[0],
        **vs_other(lambda: K.mg_up_q(uq0, gq8, *e_q, 2, h8, w8)))
    row("mg_restrict_tq", 4 * (2 * qhalf + rct), 3 * c * hc8 * wc8,
        time_ms(lambda: K.mg_restrict_tq(*rh_q, h8, w8, chp8)),
        time_ms(lambda: K.mg_restrict_tq_plain(*rh_q, h8, w8, chp8)),
        shape=f"rh_e, rh_o 2x ({c},{hq8},{wq28}) -> ({c},{chp8},{hq8})")
    dshape = f"({c},{2 * hq8},{2 * wq28})"
    row("to_quarters", 8 * qplanes, 0, time_ms(lambda: K.to_quarters(xd8)),
        time_ms(lambda: K.to_quarters_plain(xd8)),
        time_ms(lambda: xd8.view(c, hq8, 2, wq28, 2).permute(0, 2, 4, 1, 3).contiguous()),
        shape=f"{dshape} -> {qshape}")
    row("from_quarters", 8 * qplanes, 0, time_ms(lambda: K.from_quarters(xq8)),
        time_ms(lambda: K.from_quarters_plain(xq8)),
        time_ms(lambda: xq8.view(c, 2, 2, hq8, wq28).permute(0, 3, 1, 4, 2).contiguous()),
        shape=f"{qshape} -> {dshape}")
    row("mg_ud_q", 4 * (3 * qplanes + 2 * qhalf + rct), 25 * pts8,
        time_ms(lambda: K.mg_ud_q(uq0, gq8, *e_q, 2, 1, h8, w8, chp8)),
        time_ms(lambda: K.mg_ud_q_plain(uq0, gq8, *e_q, 2, 1, h8, w8, chp8)),
        shape=f"u, g {qshape} + e_even, e_odd, nu2=2, nu1=1 -> u, rc_t ({c},{chp8},{hq8})",
        with_residual_ms=time_ms(lambda: K.mg_ud_q(uq0, gq8, *e_q, 2, 1, h8, w8, chp8, True)),
        with_residual_plain_ms=time_ms(
            lambda: K.mg_ud_q_plain(uq0, gq8, *e_q, 2, 1, h8, w8, chp8, True)),
        **vs_other(lambda: K.mg_ud_q(uq0, gq8, *e_q, 2, 1, h8, w8, chp8)))
    row("mg_prolong_tq", 4 * (rct + 2 * qhalf), 2 * qhalf,
        time_ms(lambda: K.mg_prolong_tq(rcq0, w8, hp2q8, wq28)),
        time_ms(lambda: K.mg_prolong_tq_plain(rcq0, w8, hp2q8, wq28)),
        shape=f"({c},{chp8},{hq8}) -> 2x ({c},{hq8},{wq28})")
    def paste_q(d_img, planar=True):
        return K.clamp_cast_paste_q(uq_paste, d_img if planar else d_img.permute(2, 0, 1),
                                    top8 + 1, left8 + 1, h8, w8)

    row("clamp_cast_paste_q", 5 * pts8, 2 * pts8,
        time_ms(lambda: paste_q(d_k)),
        time_ms(lambda: K.clamp_cast_paste_q_plain(uq_paste, d_p, top8 + 1, left8 + 1, h8,
                                                   w8)),
        shape=f"{qshape} -> u8 ({c},{h8},{w8}) planar",
        **vs_other(lambda: paste_q(d_k), lambda: (paste_q(dst8_p.clone()),)))
    row("clamp_cast_paste_q_interleaved", 5 * pts8, 2 * pts8,
        time_ms(lambda: paste_q(i_k, False)),
        time_ms(lambda: K.clamp_cast_paste_q_plain(uq_paste, i_p.permute(2, 0, 1), top8 + 1,
                                                   left8 + 1, h8, w8)),
        shape=f"{qshape} -> u8 ({c},{h8},{w8}) interleaved",
        **vs_other(lambda: paste_q(i_k, False),
                   lambda: (paste_q(torch.from_numpy(dst8).to(dev), False),)))
    # the generic paste at 8K: from the "t" chain's slab (rows 16-byte
    # aligned) and from the exact-size solve of the DD and mg_padded=False
    # frames, wu = 3798 (every other row 8 bytes past a 16-byte boundary)
    gen8 = torch.Generator(dev).manual_seed(SEED + 8)
    at8 = (top8 + 1, left8 + 1, h8, w8)
    for form, u_shape in (("slab_8k", (c, 2 * hq8, 2 * wq28)), ("exact_8k", (c, h8, w8))):
        u8_ = torch.randn(u_shape, generator=gen8, device=dev) * 160.0 + 90.0
        for planar, img in ((True, dst8_p), (False, torch.from_numpy(dst8).to(dev))):
            a_, b_ = img.clone(), img.clone()
            paste(u8_, a_, planar, at8)
            K.clamp_cast_paste_plain(u8_, b_ if planar else b_.permute(2, 0, 1), *at8)
            require_equal(f"clamp_cast_paste {form} ({'planar' if planar else 'interleaved'})",
                          a_, b_)
        d8_, i8_ = dst8_p.clone(), torch.from_numpy(dst8).to(dev)
        rows["clamp_cast_paste"].update({
            f"{form}_shape": f"u {u_shape} -> u8 ({c},{h8},{w8})",
            f"{form}_ms": time_ms(lambda: paste(u8_, d8_, True, at8)),
            f"{form}_bound_ms": bound(5 * pts8, 2 * pts8)[0],
            f"{form}_interleaved_ms": time_ms(lambda: paste(u8_, i8_, False, at8)),
            **{f"{form}_{k}": v for k, v in vs_other(
                lambda: paste(u8_, d8_, True, at8),
                lambda: (paste(u8_, dst8_p.clone(), True, at8),)).items()},
            **{f"{form}_interleaved_{k}": v for k, v in vs_other(
                lambda: paste(u8_, i8_, False, at8),
                lambda: (paste(u8_, torch.from_numpy(dst8).to(dev), False, at8),)).items()}})
        print_other(f"clamp_cast_paste 8K {form} planar", rows["clamp_cast_paste"], f"{form}_")
        print_other(f"clamp_cast_paste 8K {form} interleaved", rows["clamp_cast_paste"],
                    f"{form}_interleaved_")
        del u8_, d8_, i8_, a_, b_
    del uq0, rcq0, e_q, uq_paste, d_k, d_p, i_k, i_p, gray8, rh_q, rct_s, split, xd8, xq8

    # -- 2e. slice 4a: the exact-size preprocess_rhs_p (#26's own role) and
    #    postprocess_transposed at the headline, rb_sweeps at the headline and
    #    8K interiors and on an odd small grid --------------------------------
    for flags, rule, p_in in ((1, "opencv", patch), (2, "opencv", patch),
                              (2, "norm", patch), (1, "opencv", gray)):
        require_equal(f"preprocess_rhs_p_exact flags={flags} {rule}",
                      K.preprocess_rhs_p(dest_roi, p_in, me, (h2, w2), flags, rule),
                      K.preprocess_rhs_p_plain(dest_roi, p_in, me, (h2, w2), flags, rule))
    g_ex = K.preprocess_rhs_p(dest_roi, patch, me, (h2, w2))
    row("preprocess_rhs_p_exact", 2 * c * bh * bw + bh * bw + 4 * c * h2 * w2,
        30 * c * bh * bw,
        time_ms(lambda: K.preprocess_rhs_p(dest_roi, patch, me, (h2, w2))),
        time_ms(lambda: K.preprocess_rhs_p_plain(dest_roi, patch, me, (h2, w2))),
        shape=f"u8 ({c},{bh},{bw}) -> ({c},{h2},{w2})",
        **vs_other(lambda: K.preprocess_rhs_p(dest_roi, patch, me, (h2, w2))))
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    u_rb = torch.randn((c, h2, w2), generator=gen, device=dev) * 10.0
    for k in (1, 2, 3, 4, 6):
        require_equal(f"rb_sweeps headline k={k}", K.rb_sweeps(u_rb, g_ex, k),
                      K.rb_sweeps_plain(u_rb, g_ex, k))
    g8x = K.preprocess_rhs_p(dest8, patch8, me8, (h8, w8))
    u8x = torch.randn((c, h8, w8), generator=gen, device=dev) * 10.0
    require_equal("rb_sweeps 8K k=4", K.rb_sweeps(u8x, g8x, 4), K.rb_sweeps_plain(u8x, g8x, 4))
    u_odd, g_odd = (torch.randn((c, 97, 131), generator=gen, device=dev) * s_
                    for s_ in (10.0, 50.0))
    require_equal("rb_sweeps 97x131 k=5", K.rb_sweeps(u_odd, g_odd, 5),
                  K.rb_sweeps_plain(u_odd, g_odd, 5))
    pts_h = c * h2 * w2
    row("rb_sweeps", 12 * pts_h, 5 * 4 * pts_h,
        time_ms(lambda: K.rb_sweeps(u_rb, g_ex, 4)),
        time_ms(lambda: K.rb_sweeps_plain(u_rb, g_ex, 4)),
        shape=f"u, g ({c},{h2},{w2}), 4 sweeps (one launch)",
        in_burst_ms=time_ms(lambda: K.rb_sweeps(u_rb, g_ex, CHECK_EVERY)) / RB_LAUNCHES_PER_BURST,
        one_sweep_ms=time_ms(lambda: K.rb_sweeps(u_rb, g_ex, 1)),
        one_sweep_bound_ms=bound(12 * pts_h, 5 * pts_h)[0],
        eight_k_shape=f"({c},{h8},{w8}), 4 sweeps",
        eight_k_ms=time_ms(lambda: K.rb_sweeps(u8x, g8x, 4)),
        eight_k_bound_ms=bound(12 * pts8, 5 * 4 * pts8)[0],
        **vs_other(lambda: K.rb_sweeps(u_rb, g_ex, 4)),
        **{f"in_burst_{k}": v for k, v in per_launch(vs_other(
            lambda: K.rb_sweeps(u_rb, g_ex, CHECK_EVERY)), RB_LAUNCHES_PER_BURST).items()})
    print_other("rb_sweeps headline, 4 sweeps", rows["rb_sweeps"])
    print_other("rb_sweeps headline, a launch in a 50-sweep burst", rows["rb_sweeps"],
                "in_burst_")
    del u8x, g8x, u_odd, g_odd
    u_t = solve_dst_gemm(g_ex, transposed_output=True, precision="high", folded=True)
    d_k, d_p = dst_p.clone(), dst_p.clone()
    K.postprocess_transposed(u_t, d_k, top + 1, left + 1)
    K.postprocess_transposed_plain(u_t, d_p, top + 1, left + 1)
    require_equal("postprocess_transposed (planar)", d_k, d_p)
    i_k = torch.from_numpy(dst.copy()).to(dev)
    i_p = i_k.clone()
    K.postprocess_transposed(u_t, i_k.permute(2, 0, 1), top + 1, left + 1)
    K.postprocess_transposed_plain(u_t, i_p.permute(2, 0, 1), top + 1, left + 1)
    require_equal("postprocess_transposed (interleaved)", i_k, i_p)
    for bw_s in (128, 251, 256):  # the bw % 128 classes of the Pallas kernel's tests
        u_s = torch.rand((c, bw_s - 2, 62), generator=gen, device=dev) * 380.0 - 60.0
        roi_s = torch.randint(0, 256, (c, 64, bw_s), generator=gen, device=dev,
                              dtype=torch.uint8)
        a_s, b_s = roi_s.clone(), roi_s.clone()
        K.postprocess_transposed(u_s, a_s, 1, 1)
        K.postprocess_transposed_plain(u_s, b_s, 1, 1)
        require_equal(f"postprocess_transposed 64x{bw_s}", a_s, b_s)
    # h2 % 4 != 0: the ragged route (the first design), one ROI row fewer
    u_r = u_t[:, :, : h2 - 1].contiguous()
    for planar, img in ((True, dst_p), (False, torch.from_numpy(dst.copy()).to(dev))):
        a_, b_ = img.clone(), img.clone()
        K.postprocess_transposed(u_r, a_ if planar else a_.permute(2, 0, 1), top + 1, left + 1)
        K.postprocess_transposed_plain(u_r, b_ if planar else b_.permute(2, 0, 1), top + 1,
                                       left + 1)
        require_equal(f"postprocess_transposed ragged ({'planar' if planar else 'interleaved'})",
                      a_, b_)

    def post(u_, d_img, planar=True):
        return K.postprocess_transposed(u_, d_img if planar else d_img.permute(2, 0, 1),
                                        top + 1, left + 1)

    row("postprocess_transposed", 5 * c * h2 * w2, 2 * c * h2 * w2,
        time_ms(lambda: post(u_t, d_k)),
        time_ms(lambda: K.postprocess_transposed_plain(u_t, d_p, top + 1, left + 1)),
        shape=f"u_t ({c},{w2},{h2}) -> the u8 ROI ({c},{bh},{bw}) in place, planar",
        interleaved_ms=time_ms(lambda: post(u_t, i_k, False)),
        ragged_shape=f"u_t ({c},{w2},{h2 - 1}) (h2 % 4 != 0), planar",
        ragged_ms=time_ms(lambda: post(u_r, d_k)),
        ragged_bound_ms=bound(5 * c * (h2 - 1) * w2, 2 * c * (h2 - 1) * w2)[0],
        **vs_other(lambda: post(u_t, d_k), lambda: (post(u_t, dst_p.clone()),)),
        **{f"interleaved_{k}": v for k, v in vs_other(
            lambda: post(u_t, i_k, False),
            lambda: (post(u_t, torch.from_numpy(dst.copy()).to(dev), False),)).items()},
        **{f"ragged_{k}": v for k, v in vs_other(
            lambda: post(u_r, d_k), lambda: (post(u_r, dst_p.clone()),)).items()})
    for what, pre in (("planar", ""), ("interleaved", "interleaved_"), ("ragged", "ragged_")):
        print_other(f"postprocess_transposed headline {what}", rows["postprocess_transposed"],
                    pre)
    del u_rb, u_t, u_r, d_k, d_p, i_k, i_p, a_, b_

    # -- 2f. slice 8a: rb_sweeps_tile on the 8K DD tiles (a 2x2 mesh over the
    #    padded interior, the CA ghost band on every side) at the four tiles'
    #    origins, an odd origin and a domain cutting the tile; the exact-size
    #    mg_down / mg_up at the DD coarse solve's two fused levels ----------
    th_dd = max(2 * -(-h8 // (2 * DD_MESH[0])), 8)
    tw_dd = max(2 * -(-w8 // (2 * DD_MESH[1])), 8)
    shape_dd = (c, th_dd + 2 * DD_BAND, tw_dd + 2 * DD_BAND)
    u_dd = torch.randn(shape_dd, generator=gen, device=dev) * 10.0
    g_dd = torch.randn(shape_dd, generator=gen, device=dev) * 50.0
    dom8 = (h8, w8)
    origins = [(iy * th_dd - DD_BAND, ix * tw_dd - DD_BAND)
               for iy in range(DD_MESH[0]) for ix in range(DD_MESH[1])]
    for org in origins:
        for n in (1, 2):
            require_equal(f"rb_sweeps_tile 8K tile at {org} n={n}",
                          K.rb_sweeps_tile(u_dd, g_dd, n, org, dom8),
                          K.rb_sweeps_tile_plain(u_dd, g_dd, n, org, dom8))
    for org, dom, n in (((th_dd - DD_BAND - 1, 1 - DD_BAND), dom8, 2),   # odd origin
                        ((-DD_BAND, tw_dd - DD_BAND), (900, 2600), 5)):  # cut, 2 launches
        require_equal(f"rb_sweeps_tile 8K tile at {org} domain {dom} n={n}",
                      K.rb_sweeps_tile(u_dd, g_dd, n, org, dom),
                      K.rb_sweeps_tile_plain(u_dd, g_dd, n, org, dom))
    pts_dd = c * shape_dd[1] * shape_dd[2]
    org_br = origins[-1]
    row("rb_sweeps_tile", 12 * pts_dd, 5 * 2 * pts_dd,
        time_ms(lambda: K.rb_sweeps_tile(u_dd, g_dd, 2, org_br, dom8)),
        time_ms(lambda: K.rb_sweeps_tile_plain(u_dd, g_dd, 2, org_br, dom8)),
        shape=f"u, g {shape_dd}, 2 sweeps (the ascent's nu2), origin {org_br}, "
              f"domain {h8}x{w8}",
        one_sweep_ms=time_ms(lambda: K.rb_sweeps_tile(u_dd, g_dd, 1, org_br, dom8)),
        one_sweep_bound_ms=bound(12 * pts_dd, 5 * pts_dd)[0],
        **vs_other(lambda: K.rb_sweeps_tile(u_dd, g_dd, 2, org_br, dom8)),
        **{f"one_sweep_{k}": v for k, v in vs_other(
            lambda: K.rb_sweeps_tile(u_dd, g_dd, 1, org_br, dom8)).items()})
    print_other("rb_sweeps_tile 8K DD tile, 2 sweeps", rows["rb_sweeps_tile"])
    print_other("rb_sweeps_tile 8K DD tile, 1 sweep", rows["rb_sweeps_tile"], "one_sweep_")
    del u_dd, g_dd

    # the window form (slice 8c): the four bands of a ghosted headline tile (a
    # 2x2 mesh over the 1548x2396 interior), read where they lie, as the
    # interior-first schedule sweeps them: halos 2, 4 and 8 (bands of 6, 12
    # and 24 rows or columns), every tile's origins, its sweeps and 5 (two
    # launches), an odd origin and a domain clipping the bands; timed at
    # halo 4, the bottom-right tile's four bands (2 sweeps each)
    th_h, tw_h = h2 // DD_MESH[0], w2 // DD_MESH[1]
    dom_h = (h2, w2)

    def bands(x, b):
        return (x[:, :b], x[:, -b:], x[:, :, :b], x[:, :, -b:])

    def band_origins(r0, c0, k, b):
        return ((r0 - k, c0 - k), (r0 + th_h + k - b, c0 - k), (r0 - k, c0 - k),
                (r0 - k, c0 + tw_h + k - b))

    for k_h in (2, 4, 8):
        b_h = 3 * k_h
        x_h = torch.randn((c, th_h + 2 * k_h, tw_h + 2 * k_h), generator=gen, device=dev) * 10
        gx_h = torch.randn(x_h.shape, generator=gen, device=dev) * 50
        for iy in range(DD_MESH[0]):
            for ix in range(DD_MESH[1]):
                orgs = band_origins(iy * th_h, ix * tw_h, k_h, b_h)
                for v, gv, org in zip(bands(x_h, b_h), bands(gx_h, b_h), orgs):
                    for n, o, dom in ((k_h // 2, org, dom_h), (5, org, dom_h),
                                      (k_h // 2, (org[0] + 1, org[1]), (h2 - 3, w2 - 5))):
                        require_equal(f"rb_sweeps_tile_window band {tuple(v.shape)} at {o} "
                                      f"domain {dom} n={n}", K.rb_sweeps_tile(v, gv, n, o, dom),
                                      K.rb_sweeps_tile_plain(v, gv, n, o, dom))
        if k_h == RB_TILED_HALO:
            x_t, gx_t, orgs_t = x_h, gx_h, band_origins(th_h, tw_h, k_h, b_h)
        del x_h, gx_h

    def four_bands(fn):
        return lambda: [fn(v, gv, RB_TILED_HALO // 2, o, dom_h) for v, gv, o in zip(
            bands(x_t, 3 * RB_TILED_HALO), bands(gx_t, 3 * RB_TILED_HALO), orgs_t)]

    pts_b = sum(v.numel() for v in bands(x_t, 3 * RB_TILED_HALO))
    row("rb_sweeps_tile_window", 12 * pts_b, 6 * (RB_TILED_HALO // 2) * pts_b,
        time_ms(four_bands(K.rb_sweeps_tile)), time_ms(four_bands(K.rb_sweeps_tile_plain)),
        shape=f"the four bands (top, bottom {c}x{3 * RB_TILED_HALO}x{x_t.shape[2]}, left, "
              f"right {c}x{x_t.shape[1]}x{3 * RB_TILED_HALO}) of the ghosted headline tile "
              f"{tuple(x_t.shape)} at ({th_h}, {tw_h}), halo {RB_TILED_HALO}, "
              f"{RB_TILED_HALO // 2} sweeps each: 4 launches",
        per_band_ms=[time_ms(lambda v=v, gv=gv, o=o: K.rb_sweeps_tile(
            v, gv, RB_TILED_HALO // 2, o, dom_h)) for v, gv, o in zip(
            bands(x_t, 3 * RB_TILED_HALO), bands(gx_t, 3 * RB_TILED_HALO), orgs_t)],
        b2b_ms=b2b_ms(four_bands(K.rb_sweeps_tile)))
    print_other("rb_sweeps_tile_window, a headline tile's four bands at halo 4",
                rows["rb_sweeps_tile_window"])
    print(f"rb_sweeps_tile_window ({card}): bound {rows['rb_sweeps_tile_window']['bound_ms']:.5f} "
          f"ms, the twin {rows['rb_sweeps_tile_window']['plain_ms']:.5f}, per band "
          f"{rows['rb_sweeps_tile_window']['per_band_ms']}")
    del x_t, gx_t
    lvl_dd = []  # (h, w, bh, bw) of the DD coarse solve's fused levels
    lh, bh_l = TM._coarsen(h8, 1.0)
    lw, bw_l = TM._coarsen(w8, 1.0)
    while TM._fused_level(lh, lw, 1, 2, True):
        lvl_dd.append((lh, lw, bh_l, bw_l))
        (lh, bh_l), (lw, bw_l) = TM._coarsen(lh, bh_l), TM._coarsen(lw, bw_l)
    if len(lvl_dd) != MG_LEVELS["tiled_dd"]:
        raise AssertionError(f"the 8K DD coarse solve has {len(lvl_dd)} fused levels")
    exact = []
    for lh, lw, bh_l, bw_l in lvl_dd:
        slab = (c, lh + lh % 2, lw)
        g_l = torch.zeros(slab, device=dev)
        u_l = torch.zeros(slab, device=dev)
        e_l = torch.zeros((c, slab[1] // 2, lw), device=dev)
        g_l[:, :lh] = torch.randn((c, lh, lw), generator=gen, device=dev) * 50.0
        u_l[:, :lh] = torch.randn((c, lh, lw), generator=gen, device=dev) * 10.0
        e_l[:, : (lh - 1) // 2] = torch.randn((c, (lh - 1) // 2, lw), generator=gen,
                                              device=dev) * 5.0
        label = f"{lh}x{lw} beta ({bh_l}, {bw_l})"
        for guess in (None, u_l):
            got = K.mg_down(guess, g_l, 1, lh, lw, bh_l, bw_l)
            want = K.mg_down_plain(guess, g_l, 1, lh, lw, bh_l, bw_l)
            what = "known-zero guess" if guess is None else "given guess"
            require_equal(f"mg_down_exact {label} ({what}) u", got[0], want[0])
            require_equal(f"mg_down_exact {label} ({what}) rh", got[1], want[1])
        require_equal(f"mg_up_exact {label}", K.mg_up(u_l, g_l, e_l, 2, lh, lw, bh_l, bw_l),
                      K.mg_up_plain(u_l, g_l, e_l, 2, lh, lw, bh_l, bw_l))
        exact.append((slab, g_l, u_l, e_l, lh, lw, bh_l, bw_l))
    (slab, g_l, u_l, e_l, lh, lw, bh_l, bw_l), lvl2 = exact[0], exact[-1]
    hp_l = slab[1]
    row("mg_down_exact", 4 * c * (2 * hp_l * lw + hp_l // 2 * lw),
        c * lh * lw * 11 + c * ((lh - 1) // 2) * lw * 5,
        time_ms(lambda: K.mg_down(None, g_l, 1, lh, lw, bh_l, bw_l)),
        time_ms(lambda: K.mg_down_plain(None, g_l, 1, lh, lw, bh_l, bw_l)),
        shape=f"DD coarse level 1: g {slab} (true {lh}x{lw}, betas {bh_l}, {bw_l}), "
              f"known-zero guess, nu1=1 -> u, rh ({c},{hp_l // 2},{lw})",
        given_guess_ms=time_ms(lambda: K.mg_down(u_l, g_l, 1, lh, lw, bh_l, bw_l)),
        last_level_shape=f"{lvl2[0]}", last_level_ms=time_ms(
            lambda: K.mg_down(None, lvl2[1], 1, *lvl2[4:])))
    row("mg_up_exact", 4 * c * (3 * hp_l * lw + hp_l // 2 * lw), c * lh * lw * 12,
        time_ms(lambda: K.mg_up(u_l, g_l, e_l, 2, lh, lw, bh_l, bw_l)),
        time_ms(lambda: K.mg_up_plain(u_l, g_l, e_l, 2, lh, lw, bh_l, bw_l)),
        shape=f"DD coarse level 1: u, g {slab} + e ({c},{hp_l // 2},{lw}), nu2=2",
        last_level_shape=f"{lvl2[0]}", last_level_ms=time_ms(
            lambda: K.mg_up(lvl2[2], lvl2[1], lvl2[3], 2, *lvl2[4:])),
        **vs_other(lambda: K.mg_up(u_l, g_l, e_l, 2, lh, lw, bh_l, bw_l)))
    del exact, lvl2, g_l, u_l, e_l, flush
    if kernels_only:
        print(json.dumps({"kernels_only": list(rows.values())}))
        return 0

    # -- 3. every path through the entry points ---------------------------------
    path_launches = {}
    loop_profiles = {}  # the in-the-loop times of the kernels line (LOOP_PROFILE)
    cpu_diffs = {}
    run_outputs = {}
    serve_outputs = {}  # the serve's chained image, by path
    cpu_outputs = {}  # the CPU path's single-shot image, by path
    frames_vs_other = {}

    def compare_frames(path, label, eng, s_img, mask_, d_img, ctr, loops):
        """--other: the path's serve frames with the other checkout's kernels
        and with this one's, in turns: ms/frame over 3 x ``loops`` chained
        frames, then a 3-frame profile's busy time and idle share."""
        m_, xy, lt, hw = eng._prepare(mask_, s_img, d_img, ctr)
        kw = dict(src=torch.from_numpy(s_img).to(dev),
                  dst=torch.from_numpy(d_img).to(dev).permute(2, 0, 1).contiguous(),
                  mask=torch.from_numpy(m_).to(dev), bbox_xy=xy, left_top=lt,
                  planar_dst=True, **eng._pipeline_kwargs(hw, eng.config.flags, True))
        turns = {"other": [], "this": []}
        for name in TURNS:
            prof_label = f"{path} ({label}) with {name}'s kernels"
            kernel_us = {}
            with side(name):
                _, ms = eng.timed_serve(s_img, d_img, mask_, ctr, loops=3 * loops)
                prof = profile_frames(prof_label, clone_pipeline, kw, frames=3, brief=True,
                                      into=kernel_us)
            per_kernel, per_frame, _ = kernel_us.get(prof_label, ({}, {}, []))
            loop = {}  # the in-the-loop time of each LOOP_PROFILE kernel this path profiles
            for key, (profiled, kernel) in LOOP_PROFILE.items():
                n = sum(v for k, v in per_frame.items() if kernel in k)
                if PROFILE_PATH.get(profiled, profiled) == path and n:
                    loop[key] = sum(t for k, t in per_kernel.items() if kernel in k) / n / 1e3
            turns[name].append(dict(ms_per_frame=ms, busy_us=prof["busy_us"],
                                    span_us=prof["span_us"], idle=prof["idle"],
                                    torch_op_launches=prof.get("torch_op_launches"),
                                    loop_ms=loop))
        frames_vs_other[f"{path} ({label})" if path in frames_vs_other else path] = turns
        print(f"frames {path} ({label}, {card}), other -> this: " + "; ".join(
            f"{k} {[r[k] for r in turns['other']]} -> {[r[k] for r in turns['this']]}"
            for k in ("ms_per_frame", "busy_us", "idle", "torch_op_launches", "loop_ms")))

    def prep_loop(label, eng_, s_img, mask_, d_img):
        """A profile of 1 + 3 of the engine's ``run`` requests (their
        prep_mask launches, one a request, give the kernels line its
        in-the-loop time under ``label``)."""
        ctr = (d_img.shape[1] // 2, d_img.shape[0] // 2)
        K.reset_launches()
        profile_frames(label, lambda: eng_.run(s_img, d_img, mask_, ctr), {}, frames=3,
                       into=loop_profiles, brief=True)
        less_preps(label, "4 runs", dict(K.LAUNCHES), 4)

    def drive(path, cfg, s_img, mask_, loops, label, d_img=dst, cpu="run+serve",
              solver="dst_gemm", engine=None, preps=1):
        """timed_serve (warm-up + loops frames) and one single-shot run, each
        with the counters set to 0 just before and read just after; the card
        against the CPU twins (``cpu``: "run+serve" the run and a 2-frame
        serve, "run" the run only, None no comparison). ``engine(device)``
        makes the engine (default: ``SeamlessClone(cfg, device)``); ``preps``
        is its prep_mask launches a request (0 on a mesh's frames, which
        prepare the mask on the host). ``path_launches`` keeps the counts
        less the preps."""
        make = engine or (lambda device: SeamlessClone(cfg, device=device))
        eng = make("cuda")
        ctr = (d_img.shape[1] // 2, d_img.shape[0] // 2)
        exact = bool(cfg.bucket_exact and cfg.bbox_bucket)
        _, _, (lft, tp), (rh, rw), *tight = prepare_inputs(
            mask_, s_img.shape, d_img.shape, ctr, bucket=cfg.bbox_bucket, return_tight=exact)
        # the written interior: the tight bbox's in bucket_exact mode
        dy, dx, th, tw = tight[0] if exact else (0, 0, rh, rw)
        interior = (tp + dy + 1, lft + dx + 1, th - 2, tw - 2)
        K.reset_launches()
        out, ms = eng.timed_serve(s_img, d_img, mask_, ctr, loops=loops)
        torch.cuda.synchronize()
        serve = check_counts(path, f"serve ({label})", dict(K.LAUNCHES), loops + 1, preps)
        if eng.metrics["solver_resolved"] != solver:
            raise AssertionError(f"solver resolved to {eng.metrics['solver_resolved']}, "
                                 f"expected {solver}")
        out_np = out.cpu().numpy()
        if out_np.shape != d_img.shape or out_np.dtype != np.uint8:
            raise AssertionError(f"serve output {out_np.shape} {out_np.dtype}")
        check_outside(out_np, d_img, interior)
        serve_outputs.setdefault(path, out_np)
        mps = s_img.shape[0] * s_img.shape[1] / (ms * 1e3)
        print(f"serve {path} ({label}): {ms:.4f} ms/frame, {mps:.1f} MP/s over {loops} "
              f"chained frames, interior {th - 2}x{tw - 2} of ROI {rh}x{rw} ({card}); "
              f"device memory {eng.metrics['device_memory_bytes']} B")
        K.reset_launches()
        run_out = eng.run(s_img, d_img, mask_, ctr)
        eng.sync()
        launched = dict(K.LAUNCHES)
        run = check_counts(path, f"single-shot run ({label})", launched, 1, preps)
        run_np = run_out.cpu().numpy()
        run_outputs.setdefault(path, run_np)
        check_outside(run_np, d_img, interior)
        print(f"single-shot run {path} ({label}): launches {json.dumps(launched)}")
        path_launches.setdefault(path, (serve, run))
        if other is not None and path in COMPARE_PATHS and all(other_agrees):
            compare_frames(path, label, eng, s_img, mask_, d_img, ctr, loops)
        if cpu is None:
            return eng, ms
        cpu_eng = make("cpu")
        cpu_run = cpu_outputs.setdefault(path, cpu_eng.run(s_img, d_img, mask_, ctr).numpy())
        d_run = diff_max(run_np, cpu_run)
        d_serve = 0
        if cpu == "run+serve":
            a, _ = eng.timed_serve(s_img, d_img, mask_, ctr, loops=1)
            b, _ = cpu_eng.timed_serve(s_img, d_img, mask_, ctr, loops=1)
            d_serve = diff_max(a.cpu().numpy(), b.numpy())
        print(f"card vs cpu, {path} ({label}): run diff_max {d_run}"
              + (f", 2-frame serve diff_max {d_serve}" if cpu == "run+serve" else ""))
        if d_run > 1 or d_serve > 1:
            raise AssertionError(f"{path} ({label}): card and CPU disagree by more than 1")
        cpu_diffs[f"{path} ({label})"] = max(d_run, d_serve)
        return eng, ms

    eng, pair_ms = drive("pair", CloneConfig(), src, mask, SERVE_LOOPS,
                         f"{SRC_HW[1]}x{SRC_HW[0]}")

    # Poisson residual of one folded card solve, in float64: A u = g on the interior
    g = g_tp[:, :w2, :h2].transpose(1, 2).double()
    u = solve_dst_gemm_pl(g_tp, h2, w2, folded=True, bases=fold_b)
    up = torch.nn.functional.pad(u[:, :h2, :w2].double(), (1, 1, 1, 1))
    lap = (up[:, :-2, 1:-1] + up[:, 2:, 1:-1] + up[:, 1:-1, :-2] + up[:, 1:-1, 2:]
           - 4 * up[:, 1:-1, 1:-1])
    rel_res = ((lap - g).abs().max() / g.abs().max()).item()
    pad = u.clone()
    pad[:, :h2, :w2] = 0
    pad_rel = (pad.abs().max() / u.abs().max()).item()
    print(f"folded solve: max |A u - g| / max |g| = {rel_res:.3e}, "
          f"max |padding| / max |u| = {pad_rel:.3e}")
    if not (rel_res < 1e-2 and pad_rel < 1e-4 and torch.isfinite(u).all()):
        raise AssertionError(f"folded solve: residual {rel_res}, padding {pad_rel}")
    del g, u, up, lap, pad

    prof_kw = dict(src=torch.from_numpy(src).to(dev), dst=dst_p.clone(),
                   mask=torch.from_numpy(m).to(dev), bbox_xy=(x0, y0),
                   left_top=(left, top), bbox_hw=(bh, bw), flags=1, planar_dst=True)
    def dst_gemms(label, folded, bases):
        """GEMM launches a frame of the DST chain's profile. Every frame
        launches the same kernels, so a fraction of a GEMM a frame means
        the trace lost events: profile again, up to 3 times."""
        for _ in range(3):
            n = profile_frames(label, clone_pipeline, dict(
                prof_kw, solver_kwargs={"precision": "high", "folded": folded},
                bases=bases), into=loop_profiles)["gemms"]
            if n == int(n):
                break
        return n

    prep_loop("pair requests", eng, src, mask, dst)
    gemms = dst_gemms("pair", True, fold_b)
    if gemms not in (-1, 8):
        raise AssertionError(f"the pair chain ran {gemms} GEMMs a frame, expected 8")
    gemms_u = dst_gemms("unfolded", False, plain_b)
    if gemms_u not in (-1, 4):
        raise AssertionError(f"the unfolded chain ran {gemms_u} GEMMs a frame, expected 4")
    del prof_kw

    _, unfolded_ms = drive("unfolded", CloneConfig(dst_folded=False), src, mask, SERVE_LOOPS,
                           f"{SRC_HW[1]}x{SRC_HW[0]}")
    print(f"serve at {SRC_HW[1]}x{SRC_HW[0]}: pair chain {pair_ms:.4f} ms/frame, unfolded "
          f"chain {unfolded_ms:.4f} ms/frame, ratio {pair_ms / unfolded_ms:.3f} ({card})")
    # the per-axis strips: each serve frame, its profile, and the same frame
    # on the parent's unfused chain from the same kernels, profiled beside
    # it in turns (busy us a frame both ways, and without the GEMMs, whose
    # time swings more than the rest) and pasting the same bytes
    strip_busy = {}
    for path, hw in STRIP_PATHS.items():
        s_src = synthetic_image(rng, hw)
        s_mask = np.full(hw, 255, np.uint8)
        s_eng, _ = drive(path, CloneConfig(), s_src, s_mask, STRIP_LOOPS,
                         f"{hw[1]}x{hw[0]} strip")
        s_m, s_xy, s_lt, s_hw = s_eng._prepare(s_mask, s_src, dst, center)
        s_kw = dict(src=torch.from_numpy(s_src).to(dev), mask=torch.from_numpy(s_m).to(dev),
                    bbox_xy=s_xy, left_top=s_lt, planar_dst=True,
                    **s_eng._pipeline_kwargs(s_hw, s_eng.config.flags, True))
        routes = (("fused", path, contextlib.nullcontext, PATHS[path]),
                  ("unfused", UNFUSED_STRIP[path], unfused_per_axis, _per_frame(
                      erode3=1, preprocess_rhs_t=1, fold_minor=1, unfold_minor=1, transpose=3,
                      clamp_cast_paste=1)))
        outs, busy = [], {"fused": [], "unfused": [], "fused_no_gemm": [], "unfused_no_gemm": []}
        for turn in range(2):
            for route, label, chain, want in routes:
                with chain():
                    if turn == 0:
                        K.reset_launches()
                        outs.append(clone_pipeline(**s_kw, dst=dst_p.clone()))
                        torch.cuda.synchronize()
                        if K.LAUNCHES != want:
                            raise AssertionError(f"{label}: launches {K.LAUNCHES}, expected {want}")
                    for _ in range(3):  # a fraction of a GEMM a frame: the trace lost events
                        prof = profile_frames(label, clone_pipeline, dict(s_kw, dst=dst_p.clone()),
                                              into=loop_profiles, brief=turn > 0)
                        if prof["gemms"] == int(prof["gemms"]):
                            break
                busy[route].append(prof["busy_us"])
                busy[f"{route}_no_gemm"].append(prof["busy_us"] - prof.get("gemm_us", 0.0))
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"{path}: the fused and the unfused route pasted different "
                                 f"bytes, diff_max {diff_max(outs[0].cpu(), outs[1].cpu())}")
        strip_busy[path] = busy
        mean = {k: sum(v) / len(v) for k, v in busy.items()}
        print(f"{path} ({hw[1]}x{hw[0]} strip, {card}): kernels busy {busy['fused']} us/frame "
              f"on the fused route, {busy['unfused']} on the parent's unfused chain, in turns "
              f"(means {mean['fused'] - mean['unfused']:+.1f}; without the GEMMs "
              f"{busy['fused_no_gemm']} and {busy['unfused_no_gemm']}, "
              f"{mean['fused_no_gemm'] - mean['unfused_no_gemm']:+.1f}); pasted outputs "
              "bit-equal")
        del outs, s_kw, s_eng

    # -- the transpose-fused multigrid: 8K through auto, then the headline ------
    levels8 = 0
    lh, lw = h8, w8
    while TM._fused_level(lh, lw, 1, 2, True, TM.FUSE_MIN if levels8 == 0 else TM.FUSE_MIN_T):
        levels8, (lh, lw) = levels8 + 1, ((lw - 1) // 2, (lh - 1) // 2)
    if levels8 != MG_LEVELS["mg_t"]:
        raise AssertionError(f"8K has {levels8} fused levels, expected {MG_LEVELS['mg_t']}")
    print(f"8K multigrid: {levels8} fused levels, coarsest {lh}x{lw} solved exactly")
    eng8, mg8_ms = drive("mg_t", CloneConfig(mg_padded="t"), src8, mask8, MG_LOOPS, "8K",
                         d_img=dst8, cpu=None, solver="multigrid")
    run_cycles = check_mg_counts("mg_t", "single-shot run (8K)", path_launches["mg_t"][1], 1)
    serve_cycles = path_launches["mg_t"][0]["mg_down_t"] // levels8
    # the single run's RHS (the original destination), solved with the report
    g8 = K.preprocess_rhs_p(dest8, patch8, me8, (hp8, wp8))
    u_chk, info = TM.solve_multigrid(g8, true_hw=(h8, w8), padded="t", use_pallas=True,
                                     tol=TOL, return_info=True)
    gmax = g8.abs().max().item()
    rel_res = info["residual"] / gmax
    print(f"8K tolerance mode: single run {run_cycles} cycles, solve_multigrid reports "
          f"{info['cycles']} cycles, relative residual {rel_res:.3e} (tol {TOL}); "
          f"serve {serve_cycles} cycles over {MG_LOOPS + 1} frames")
    if info["cycles"] != run_cycles or not rel_res <= TOL or not torch.isfinite(u_chk).all():
        raise AssertionError(f"8K multigrid: {run_cycles} cycles run, {info} reported")
    del u_chk
    _, mg8_fixed_ms = drive("mg_t_fixed", CloneConfig(mg_padded="t", mg_cycles=4), src8, mask8,
                            MG_LOOPS, "8K, mg_cycles=4", d_img=dst8, cpu=None,
                            solver="multigrid")
    print(f"8K serve ({card}): tolerance mode {mg8_ms:.4f} ms/frame "
          f"({serve_cycles / (MG_LOOPS + 1):g} cycles a frame), mg_cycles=4 "
          f"{mg8_fixed_ms:.4f} ms/frame")
    prof8 = dict(src=torch.from_numpy(src8).to(dev), dst=dst8_p.clone(),
                 mask=torch.from_numpy(m8).to(dev), bbox_xy=(x8, y8), left_top=(left8, top8),
                 bbox_hw=(bh8, bw8), flags=1, planar_dst=True, solver=TM.solve_multigrid,
                 bases={}, solver_name="multigrid")
    for label, cyc in (("mg_t 8K tolerance", None), ("mg_t 8K mg_cycles=4", 4)):
        kw = CloneConfig(solver="multigrid", mg_padded="t", mg_cycles=cyc).solver_kwargs()
        profile_frames(label, clone_pipeline, dict(prof8, solver_kwargs=kw), frames=3,
                       into=loop_profiles)
    del prof8, eng8
    dst8_eng = SeamlessClone(CloneConfig(solver="dst_gemm"), device="cuda")
    _, dst8_ms = dst8_eng.timed_serve(src8, dst8, mask8, ctr8, loops=5)
    del dst8_eng
    _, mg_head_ms = drive("mg_t_headline", CloneConfig(solver="multigrid", mg_padded="t"),
                          src, mask, MG_LOOPS, f"{SRC_HW[1]}x{SRC_HW[0]}", cpu="run",
                          solver="multigrid")
    head_cycles = path_launches["mg_t_headline"][0]["mg_down_t"] // MG_LEVELS["mg_t_headline"]
    print(f"crossover data ({card}), serve ms/frame, dst_gemm pair chain vs multigrid "
          f"mg_padded='t' tol {TOL}: {h2 * w2 / 1e6:.1f} MP {pair_ms:.4f} vs {mg_head_ms:.4f} "
          f"({head_cycles / (MG_LOOPS + 1):g} cycles a frame); {h8 * w8 / 1e6:.1f} MP "
          f"{dst8_ms:.4f} vs {mg8_ms:.4f}")

    # -- the quarter-plane multigrid (the default): 8K through auto, then the
    #    headline ---------------------------------------------------------------
    for path, (lh, lw) in (("mg_q", (h8, w8)), ("mg_q_headline", (h2, w2))):
        if (not TM.quarter_path_applies(lh, lw)
                or len(TM.q_coarse_levels(lh, lw)) != MG_LEVELS[path]):
            raise AssertionError(f"{path}: {lh}x{lw} is not a quarter-plane grid with "
                                 f"{MG_LEVELS[path]} fused coarse levels")
    eng8, q8_ms = drive("mg_q", CloneConfig(), src8, mask8, MG_LOOPS, "8K", d_img=dst8,
                        cpu=None, solver="multigrid")
    q_run_cycles = check_mg_q_counts("mg_q", "single-shot run (8K)", path_launches["mg_q"][1],
                                     1)
    q_serve_cycles = path_launches["mg_q"][0]["mg_ud_q"]
    prep_loop("mg_q 8K requests", eng8, src8, mask8, dst8)
    # the single run's RHS through the solver: its cycles are its mg_ud_q
    # launches; the residual of the card's solution, dense, in float64
    gq8 = K.preprocess_rhs_q(dest8, patch8, me8, qhw8)
    K.reset_launches()
    uq8 = TM.solve_multigrid(gq8, true_hw=(h8, w8), padded="q", use_pallas=True, tol=TOL,
                             padded_output="quarters")
    torch.cuda.synchronize()
    solve_cycles = K.LAUNCHES["mg_ud_q"]
    u8d = K.from_quarters(uq8)[:, :h8, :w8].double()
    g8d = K.from_quarters(gq8)[:, :h8, :w8].double()
    up8 = torch.nn.functional.pad(u8d, (1, 1, 1, 1))
    lap8 = (up8[:, :-2, 1:-1] + up8[:, 2:, 1:-1] + up8[:, 1:-1, :-2] + up8[:, 1:-1, 2:]
            - 4 * up8[:, 1:-1, 1:-1])
    q_rel = ((lap8 - g8d).abs().max() / g8d.abs().max()).item()
    print(f"8K quarter-plane tolerance mode: single run {q_run_cycles} cycles (mg_ud_q "
          f"launches), the solve of its RHS {solve_cycles}, relative residual {q_rel:.3e} "
          f"(tol {TOL}); serve {q_serve_cycles} cycles over {MG_LOOPS + 1} frames")
    if solve_cycles != q_run_cycles or not q_rel <= TOL or not torch.isfinite(uq8).all():
        raise AssertionError(f"8K quarter-plane multigrid: {q_run_cycles} cycles run, "
                             f"{solve_cycles} in the solve, residual {q_rel}")
    del uq8, u8d, g8d, up8, lap8, eng8
    _, q8_fixed_ms = drive("mg_q_fixed", CloneConfig(mg_cycles=4), src8, mask8, MG_LOOPS,
                           "8K, mg_cycles=4", d_img=dst8, cpu=None, solver="multigrid")
    print(f"8K serve ({card}), quarter-plane multigrid: tolerance mode {q8_ms:.4f} ms/frame "
          f"({q_serve_cycles / (MG_LOOPS + 1):g} cycles a frame), mg_cycles=4 "
          f"{q8_fixed_ms:.4f} ms/frame; the 't' chain {mg8_ms:.4f} and {mg8_fixed_ms:.4f}")
    for label, cyc, chain in (("mg_q 8K tolerance", None, contextlib.nullcontext),
                              ("mg_q 8K mg_cycles=4", 4, contextlib.nullcontext),
                              (UNFUSED_PROFILE, None, unfused_chain)):
        kw = CloneConfig(solver="multigrid", mg_cycles=cyc).solver_kwargs()
        with chain():
            profile_frames(label, clone_pipeline, dict(
                src=torch.from_numpy(src8).to(dev), dst=dst8_p.clone(),
                mask=torch.from_numpy(m8).to(dev), bbox_xy=(x8, y8), left_top=(left8, top8),
                bbox_hw=(bh8, bw8), flags=1, planar_dst=True, solver=TM.solve_multigrid,
                bases={}, solver_name="multigrid", solver_kwargs=kw), frames=3,
                into=loop_profiles)
    _, q_head_ms = drive("mg_q_headline", CloneConfig(solver="multigrid"), src, mask,
                         MG_LOOPS, f"{SRC_HW[1]}x{SRC_HW[0]}", cpu="run", solver="multigrid")
    q_head_cycles = path_launches["mg_q_headline"][0]["mg_ud_q"]
    # The host's issue time of a 4-cycle quarter solve at the headline against
    # the card's time for it: a spin kernel holds the card while the host
    # queues the solve, so the events time the device work alone. In turns
    # with the fused transfers and with the four-kernel chain (2 wrapper
    # calls a coarse level a cycle fewer: 16 in this solve).
    _, hqh, wq2h, _ = K.mg_geometry_q(h2, w2)
    gqh = K.preprocess_rhs_q(dest_roi, patch, K.erode3(m01), (2 * hqh, 2 * wq2h))
    eig_h: dict = {}

    def solve4():
        return TM.solve_multigrid(gqh, true_hw=(h2, w2), padded="q", use_pallas=True,
                                  cycles=4, padded_output="quarters", eig_cache=eig_h)

    issue = {"fused": [], "unfused": []}
    device_ms = {"fused": [], "unfused": []}
    for chain in ("fused", "unfused", "unfused", "fused"):
        with contextlib.nullcontext() if chain == "fused" else unfused_chain():
            solve4()
            for _ in range(5):
                torch.cuda.synchronize()
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(100_000_000)  # ~50 ms of spinning at the card's clock
                t0 = time.perf_counter()
                s.record()
                solve4()
                e.record()
                issue[chain].append((time.perf_counter() - t0) * 1e3)
                e.synchronize()
                device_ms[chain].append(s.elapsed_time(e))
    for chain in ("fused", "unfused"):
        print(f"host issue vs device, 4-cycle quarter solve at the headline, {chain} "
              f"transfers ({card}): host {min(issue[chain]):.4f}-{max(issue[chain]):.4f} ms "
              f"(median {sorted(issue[chain])[4]:.4f}), device {min(device_ms[chain]):.4f}-"
              f"{max(device_ms[chain]):.4f} ms")
    if max(max(v) for v in issue.values()) > 40.0:
        raise AssertionError("the host issue outlasted the spin: the device time is not "
                             "the solve's alone")
    del gqh, eig_h
    profile_frames("mg_q headline tolerance", clone_pipeline, dict(
        src=torch.from_numpy(src).to(dev), dst=dst_p.clone(), mask=torch.from_numpy(m).to(dev),
        bbox_xy=(x0, y0), left_top=(left, top), bbox_hw=(bh, bw), flags=1, planar_dst=True,
        solver=TM.solve_multigrid, bases={}, solver_name="multigrid",
        solver_kwargs=CloneConfig(solver="multigrid").solver_kwargs()), frames=3)
    print(f"crossover data ({card}), serve ms/frame, dst_gemm pair chain vs multigrid "
          f"mg_padded='q' tol {TOL}: {h2 * w2 / 1e6:.1f} MP {pair_ms:.4f} vs {q_head_ms:.4f} "
          f"({q_head_cycles / (MG_LOOPS + 1):g} cycles a frame); {h8 * w8 / 1e6:.1f} MP "
          f"{dst8_ms:.4f} vs {q8_ms:.4f}")

    # -- a coarse tolerance (no check-free cycle: the check-first loop) at 8K
    #    through auto, then at the headline -----------------------------------
    if TM._tol_burst(COARSE_TOL, CloneConfig().max_cycles) != 0:
        raise AssertionError(f"tol {COARSE_TOL} has a check-free burst")
    _, qc8_ms = drive("mg_q_coarse", CloneConfig(tol=COARSE_TOL), src8, mask8, MG_LOOPS,
                      f"8K, tol {COARSE_TOL}", d_img=dst8, cpu=None, solver="multigrid")
    qc_run_cycles = check_mg_q_coarse_counts("mg_q_coarse", "single-shot run (8K)",
                                             path_launches["mg_q_coarse"][1], 1)
    qc_serve_cycles = path_launches["mg_q_coarse"][0]["mg_up_q"]
    # the single run's RHS, dense and true-size, through the solver's report
    g8d = K.preprocess_rhs_p(dest8, patch8, me8, (h8, w8))
    g8max = g8d.abs().max().item()
    u_coarse, info_c = TM.solve_multigrid(g8d, use_pallas=True, tol=COARSE_TOL,
                                          return_info=True)
    print(f"8K tol {COARSE_TOL} (check-first loop): single run {qc_run_cycles} cycles, "
          f"solve_multigrid reports {info_c['cycles']}, relative residual "
          f"{info_c['residual'] / g8max:.3e}; serve {qc_serve_cycles} cycles over "
          f"{MG_LOOPS + 1} frames, {qc8_ms:.4f} ms/frame ({card})")
    if info_c["cycles"] != qc_run_cycles or not info_c["residual"] <= COARSE_TOL * g8max:
        raise AssertionError(f"8K tol {COARSE_TOL}: {qc_run_cycles} cycles run, {info_c}")
    profile_frames(f"mg_q 8K tol {COARSE_TOL}", clone_pipeline, dict(
        src=torch.from_numpy(src8).to(dev), dst=dst8_p.clone(),
        mask=torch.from_numpy(m8).to(dev), bbox_xy=(x8, y8), left_top=(left8, top8),
        bbox_hw=(bh8, bw8), flags=1, planar_dst=True, solver=TM.solve_multigrid, bases={},
        solver_name="multigrid",
        solver_kwargs=CloneConfig(solver="multigrid", tol=COARSE_TOL).solver_kwargs()),
        frames=3, into=loop_profiles)
    _, qc_head_ms = drive("mg_q_coarse_headline", CloneConfig(solver="multigrid", tol=COARSE_TOL),
                          src, mask, MG_LOOPS, f"{SRC_HW[1]}x{SRC_HW[0]}, tol {COARSE_TOL}",
                          cpu="run", solver="multigrid")
    profile_frames(f"mg_q headline tol {COARSE_TOL}", clone_pipeline, dict(
        src=torch.from_numpy(src).to(dev), dst=dst_p.clone(), mask=torch.from_numpy(m).to(dev),
        bbox_xy=(x0, y0), left_top=(left, top), bbox_hw=(bh, bw), flags=1, planar_dst=True,
        solver=TM.solve_multigrid, bases={}, solver_name="multigrid",
        solver_kwargs=CloneConfig(solver="multigrid", tol=COARSE_TOL).solver_kwargs()),
        frames=3)
    print(f"serve, quarter-plane multigrid tol {COARSE_TOL} ({card}): 8K {qc8_ms:.4f} "
          f"ms/frame, headline {qc_head_ms:.4f} ms/frame "
          f"({path_launches['mg_q_coarse_headline'][0]['mg_up_q'] / (MG_LOOPS + 1):g} "
          f"cycles a frame)")

    # -- solve_multigrid on the dense 8K RHS: to_quarters in, from_quarters out
    K.reset_launches()
    u_d, info_d = TM.solve_multigrid(g8d, use_pallas=True, tol=TOL, return_info=True)
    torch.cuda.synchronize()
    dense_launches = dict(K.LAUNCHES)
    if (dense_launches["to_quarters"], dense_launches["from_quarters"]) != (1, 1):
        raise AssertionError(f"the dense 8K solve launched {dense_launches}")
    print(f"dense 8K solve, tol {TOL}: {info_d['cycles']} cycles (the born-quartered solve "
          f"{solve_cycles}), relative residual {info_d['residual'] / g8max:.3e}")
    if (info_d["cycles"] != solve_cycles or not info_d["residual"] <= TOL * g8max
            or tuple(u_d.shape) != (c, h8, w8) or not torch.isfinite(u_d).all()):
        raise AssertionError(f"the dense 8K solve: {info_d}, shape {tuple(u_d.shape)}")
    slab = TM.solve_multigrid(g8d, use_pallas=True, tol=TOL, padded_output=True)
    if (tuple(slab.shape) != (c, 2 * hq8, 2 * wq28) or slab[:, h8:].any()
            or slab[:, :, w8:].any() or not torch.equal(slab[:, :h8, :w8], u_d)):
        raise AssertionError(f"padded_output=True: {tuple(slab.shape)}, not the solve with "
                             "exact zeros outside the domain")
    K.reset_launches()
    u_w, info_w = TM.solve_multigrid(g8d, u0=u_coarse, use_pallas=True, tol=TOL,
                                     return_info=True)
    torch.cuda.synchronize()
    warm_launches = dict(K.LAUNCHES)
    print(f"dense 8K solve, tol {TOL}, warm start from the tol {COARSE_TOL} solution: "
          f"{info_w['cycles']} cycles against {info_d['cycles']} from zero, relative residual "
          f"{info_w['residual'] / g8max:.3e}; launches {json.dumps(warm_launches)}")
    if (warm_launches["to_quarters"] != 2 or warm_launches["from_quarters"] != 1
            or not info_w["cycles"] < info_d["cycles"] or not info_w["residual"] <= TOL * g8max):
        raise AssertionError(f"the warm-started 8K solve: {info_w}, launches {warm_launches}")
    path_launches["mg_dense"] = (dense_launches, warm_launches)
    del g8d, u_coarse, u_d, slab, u_w

    s_src = synthetic_image(rng, (194, 300))
    s_dst = synthetic_image(rng, (449, 800))
    yy, xx = np.mgrid[:194, :300]
    s_mask = (((yy - 97) ** 2 + (xx - 150) ** 2 < 80 ** 2)
              | ((yy >= 30) & (yy <= 120) & (xx >= 40) & (xx <= 260))).astype(np.uint8) * 255
    for flags in (1, 2, 3):
        dm = diff_max(seamless_clone(s_src, s_dst, s_mask, (400, 200), flags),
                      seamless_clone(s_src, s_dst, s_mask, (400, 200), flags, device="cpu"))
        print(f"card vs cpu, irregular mask 300x194, flags={flags}: diff_max {dm}")
        if dm > 1:
            raise AssertionError(f"flags={flags}: card and CPU disagree by {dm}")

    # -- slice 4a: red-black at the headline and on a small patch, the DST-FFT
    #    solve, the element path's fine sweeps and the transposed post-process
    def frame_rhs(s_img, mask_, d_img):
        """The exact-size RHS of a single-shot run's frame, as its kernels make it."""
        ctr = (d_img.shape[1] // 2, d_img.shape[0] // 2)
        m_, (xs, ys), (lf, tp), (rh, rw) = prepare_inputs(mask_, s_img.shape, d_img.shape, ctr)
        dd = torch.from_numpy(d_img).to(dev).permute(2, 0, 1)[:, tp : tp + rh, lf : lf + rw]
        ss = torch.from_numpy(s_img).to(dev)[ys : ys + rh, xs : xs + rw].permute(2, 0, 1)
        mm = torch.from_numpy(m_[ys : ys + rh, xs : xs + rw]).to(dev)
        pp = torch.where(mm[None] != 0, ss, 0).to(torch.uint8)
        return K.preprocess_rhs_p(dd, pp, K.erode3((mm != 0).to(torch.uint8)), (rh - 2, rw - 2))

    def rel_residual(u, g) -> float:
        """max |A u - g| / max |g| in float64."""
        up = torch.nn.functional.pad(u.double(), (1, 1, 1, 1))
        lap = (up[:, :-2, 1:-1] + up[:, 2:, 1:-1] + up[:, 1:-1, :-2] + up[:, 1:-1, 2:]
               - 4 * up[:, 1:-1, 1:-1])
        return ((lap - g.double()).abs().max() / g.double().abs().max()).item()

    headline = f"{SRC_HW[1]}x{SRC_HW[0]}"
    prof_h = dict(src=torch.from_numpy(src).to(dev), dst=dst_p.clone(),
                  mask=torch.from_numpy(m).to(dev), bbox_xy=(x0, y0), left_top=(left, top),
                  bbox_hw=(bh, bw), flags=1, planar_dst=True)
    cfg_j = CloneConfig(solver="jacobi")
    _, jac_ms = drive("jacobi", cfg_j, src, mask, JACOBI_LOOPS, headline, cpu=None,
                      solver="jacobi")
    jac_bursts = check_jacobi_counts("jacobi", "single-shot run", path_launches["jacobi"][1], 1)
    # the run's RHS solved with the kernel and with the plain sweeps, both on the card
    g_j = frame_rhs(src, mask, dst)
    t0 = time.perf_counter()
    u_jk, info_k = TJ.solve_redblack(g_j, return_info=True, **cfg_j.solver_kwargs())
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    u_jp, info_p = TJ.solve_redblack(g_j, return_info=True,
                                     **dict(cfg_j.solver_kwargs(), use_pallas=False))
    plain_s = time.perf_counter() - t0
    want_img = torch.from_numpy(dst.copy()).to(dev)
    K.clamp_cast_paste_plain(u_jp, want_img.permute(2, 0, 1), top + 1, left + 1, h2, w2)
    same_img = np.array_equal(run_outputs["jacobi"], want_img.cpu().numpy())
    print(f"jacobi at the headline ({card}): {info_k['iterations']} sweeps (cap "
          f"{cfg_j.max_iters}), relative residual {info_k['residual'] / g_j.abs().max().item():.3e}"
          f" (tol {cfg_j.tol}); launches a frame rb_sweeps {jac_bursts * RB_LAUNCHES_PER_BURST} "
          f"= {jac_bursts} bursts x {RB_LAUNCHES_PER_BURST}, erode3, preprocess_rhs_p, "
          f"clamp_cast_paste 1; serve {jac_ms:.4f} ms/frame over {JACOBI_LOOPS} frames; the "
          f"solve {kernel_s * 1e3:.1f} ms with rb_sweeps, {plain_s * 1e3:.1f} ms with plain "
          f"sweeps; bit-equal {torch.equal(u_jk, u_jp)}, the run's image equal {same_img}")
    if (info_k["iterations"] != info_p["iterations"]
            or info_k["iterations"] != jac_bursts * CHECK_EVERY
            or not torch.equal(u_jk, u_jp) or not same_img):
        raise AssertionError(f"jacobi: kernel {info_k}, plain sweeps {info_p}, run bursts "
                             f"{jac_bursts}, images equal {same_img}")
    del g_j, u_jk, u_jp, want_img
    profile_frames("jacobi", clone_pipeline, dict(
        prof_h, solver=TJ.solve_redblack, solver_kwargs=cfg_j.solver_kwargs(),
        solver_name="jacobi", use_pallas_post=False), frames=1, into=loop_profiles)

    rng4 = np.random.default_rng(SEED + 4)
    src_j = synthetic_image(rng4, JACOBI_SMALL_HW, cell=16)
    mask_j = np.full(JACOBI_SMALL_HW, 255, np.uint8)
    cfg_js = CloneConfig(solver="jacobi")
    _, js_ms = drive("jacobi_small", cfg_js, src_j, mask_j, STRIP_LOOPS,
                     f"{JACOBI_SMALL_HW[1]}x{JACOBI_SMALL_HW[0]}", solver="jacobi")
    g_js = frame_rhs(src_j, mask_j, dst)
    _, info_js = TJ.solve_redblack(g_js, return_info=True, **cfg_js.solver_kwargs())
    _, info_jc = TJ.solve_redblack(g_js.cpu(), return_info=True, **cfg_js.solver_kwargs())
    js_bursts = check_jacobi_counts("jacobi_small", "single-shot run",
                                    path_launches["jacobi_small"][1], 1)
    print(f"jacobi small ({card}): {info_js['iterations']} sweeps on the card, "
          f"{info_jc['iterations']} on the CPU, the run {js_bursts * CHECK_EVERY}; relative "
          f"residual {info_js['residual'] / g_js.abs().max().item():.3e}; serve {js_ms:.4f} "
          f"ms/frame")
    if (info_js["iterations"] != info_jc["iterations"]
            or info_js["iterations"] != js_bursts * CHECK_EVERY
            or not info_js["iterations"] < cfg_js.max_iters):
        raise AssertionError(f"jacobi small: card {info_js}, CPU {info_jc}, run {js_bursts}")
    del g_js

    _, fft_ms = drive("dst_fft", CloneConfig(solver="dst_fft"), src, mask, STRIP_LOOPS, headline,
                      cpu="run", solver="dst_fft")
    d_pair = diff_max(run_outputs["dst_fft"], run_outputs["pair"])
    g_f = frame_rhs(src, mask, dst)
    u_f = solve_dst_fft(g_f)
    fft_rel = rel_residual(u_f, g_f)
    print(f"dst_fft at the headline ({card}): serve {fft_ms:.4f} ms/frame (the pair chain "
          f"{pair_ms:.4f}); run diff_max {d_pair} against the pair chain's; relative residual "
          f"{fft_rel:.3e}")
    if d_pair > 1 or not fft_rel < 1e-2 or not torch.isfinite(u_f).all():
        raise AssertionError(f"dst_fft: diff_max {d_pair} against the pair chain, residual "
                             f"{fft_rel}")
    del u_f
    profile_frames("dst_fft", clone_pipeline, dict(
        prof_h, solver=solve_dst_fft, solver_name="dst_fft", use_pallas_post=False),
        into=loop_profiles)

    # the element path: nu2 = 6 leaves the fused chains, and the fine level's
    # 6-sweep ascent is one rb_sweeps burst of 2 launches a cycle
    if TM.quarter_path_applies(h2, w2, 1, 6) or TM.t_chain_applies(h2, w2, 1, 6):
        raise AssertionError("nu2=6 at the headline took a fused chain")
    K.reset_launches()
    t0 = time.perf_counter()
    u_e, info_e = TM.solve_multigrid(g_f, nu2=6, use_pallas=True, tol=TOL, return_info=True)
    torch.cuda.synchronize()
    el_ms = (time.perf_counter() - t0) * 1e3
    el_launches = dict(K.LAUNCHES)
    _, info_ec = TM.solve_multigrid(g_f.cpu(), nu2=6, use_pallas=True, tol=TOL,
                                    return_info=True)
    el_rel = info_e["residual"] / g_f.abs().max().item()
    print(f"mg_element at the headline, nu2=6 ({card}): {info_e['cycles']} cycles on the card, "
          f"{info_ec['cycles']} on the CPU, relative residual {el_rel:.3e} (tol {TOL}); "
          f"launches {json.dumps({k: v for k, v in el_launches.items() if v})}; "
          f"{el_ms:.1f} ms a solve (host clock)")
    if (el_launches != _per_frame(rb_sweeps=2 * info_e["cycles"])
            or info_e["cycles"] != info_ec["cycles"] or not el_rel <= TOL
            or not torch.isfinite(u_e).all()):
        raise AssertionError(f"mg_element: {info_e}, CPU {info_ec}, launches {el_launches}")
    path_launches["mg_element"] = (el_launches, el_launches)
    del g_f, u_e

    _, post_ms = drive("dst_post_t", CloneConfig(use_pallas_preprocess=False), src, mask,
                       STRIP_LOOPS, headline, cpu="run")
    print(f"dst_post_t at the headline ({card}): serve {post_ms:.4f} ms/frame, "
          f"postprocess_transposed once a frame")
    profile_frames("dst_post_t", clone_pipeline, dict(
        prof_h, solver=solve_dst_gemm, solver_kwargs={"precision": "high", "folded": True},
        solver_name="dst_gemm", use_pallas_pre=False), into=loop_profiles)
    del prof_h

    # -- slice 8a: the 2x2 DD serve at 8K (tolerance and fixed), the 1x1 mesh,
    #    the DD serve at the headline against the CPU mesh, the red-black tiled
    #    solve, mg_padded=False -------------------------------------------------
    def chained(solver, n, s_img, mask_, d_img, dyn_kw=None):
        """n frames of the single-device composition a resident frame is
        held against, chained on one planar destination: the plain RHS,
        ``solver`` (or, with ``dyn_kw``, bucket_exact's dyn solve of the
        tight window), clamp_cast_paste."""
        ctr = (d_img.shape[1] // 2, d_img.shape[0] // 2)
        exact = dyn_kw is not None
        m_, xy, lt, hw, *tight = prepare_inputs(mask_, s_img.shape, d_img.shape, ctr,
                                                bucket=BUCKET if exact else 0,
                                                return_tight=exact)
        buf = torch.from_numpy(d_img).to(dev).permute(2, 0, 1).contiguous()
        kw = dict(src=torch.from_numpy(s_img).to(dev), dst=buf, mask=torch.from_numpy(m_).to(dev),
                  bbox_xy=xy, left_top=lt, true_bbox=tight[0] if exact else None, bbox_hw=hw,
                  flags=1, planar_dst=True, solver=solver, solver_kwargs=dyn_kw,
                  solver_name="multigrid_resident", use_pallas_pre=False, use_pallas_post=False)
        for _ in range(n):
            clone_pipeline(**kw)
        return buf.permute(1, 2, 0).cpu().numpy()

    def resident_frame_profile(label, eng_, s_img, mask_, d_img, frames=2, brief=True):
        """profile_frames of the engine's resident frame (``step``)."""
        ctr = (d_img.shape[1] // 2, d_img.shape[0] // 2)
        flags_, prep_ = eng_._prepared(s_img, d_img, mask_, ctr, None)
        fr = eng_._frame(s_img, d_img, prep_, flags_)
        return profile_frames(label, lambda: fr.step(), {}, frames=frames, into=loop_profiles,
                              brief=brief)

    resident = {}  # slice 8b's figures of the tiled phases' resident frames, by path

    def resident_check(path, eng_, loops, solver, label, frames_prof=2, brief=True):
        """The slice-8b checks of a tiled serve phase that ``drive`` ran at
        8K: its ``loops + 1`` chained frames bit-equal to the single-device
        composition with ``solver``, no gather in the timed frames, each
        cell's resident bytes; its resident frame profiled as ``label``."""
        frames = loops + 1
        same = np.array_equal(serve_outputs[path], chained(solver, frames, src8, mask8, dst8))
        prof = resident_frame_profile(label, eng_, src8, mask8, dst8, frames_prof, brief)
        serve = path_launches[path][0]
        resident[path] = dict(
            frames=frames, bit_equal_composition=same,
            launches_per_frame={k: v / frames for k, v in serve.items() if v},
            gathers_per_frame=eng_.metrics["gathers_per_frame"],
            crossed_bytes_per_frame=eng_.metrics["crossed_bytes_per_frame"],
            replicated_bytes_per_frame=eng_.metrics["replicated_bytes_per_frame"],
            resident_bytes=eng_.metrics["resident_bytes"], busy_us=prof["busy_us"],
            span_us=prof["span_us"], idle=prof["idle"],
            torch_op_launches=prof.get("torch_op_launches"))
        print(f"{path} resident ({card}): the destination held as tiles on the 2x2 mesh; "
              f"clamp_cast_paste {serve['clamp_cast_paste'] / frames:g} and rb_sweeps_tile "
              f"{serve['rb_sweeps_tile'] / frames:g} a frame; gathers in the timed frames "
              f"{eng_.metrics['gathers_per_frame']}, replicated levels "
              f"{eng_.metrics['replicated_bytes_per_frame'] / 1e6:.3f} MB a frame; resident "
              f"bytes by cell {json.dumps(eng_.metrics['resident_bytes'])}; profiled frame "
              f"busy {prof['busy_us']:.1f} us of {prof['span_us']:.1f}, idle {prof['idle']}, "
              f"torch ops {prof.get('torch_op_launches')}; {frames} chained frames bit-equal "
              f"to the single-device composition {same}")
        if not same or eng_.metrics["gathers_per_frame"] != 0:
            raise AssertionError(f"{path} resident: {resident[path]}")

    def dd_engine(cfg):
        return lambda device: TiledSeamlessClone(
            cfg, mesh=make_tile_mesh([torch.device(device)] * DD_TILES, DD_MESH))

    mesh_c = make_tile_mesh([dev] * DD_TILES, DD_MESH)
    eng_dd, dd8_ms = drive("tiled_dd", CloneConfig(), src8, mask8, MG_LOOPS, "8K", d_img=dst8,
                           cpu=None, solver="multigrid_dd", engine=dd_engine(CloneConfig()),
                           preps=0)
    dd_run_cycles = check_tiled_counts("tiled_dd", "single-shot run (8K)",
                                       path_launches["tiled_dd"][1], 1)
    dd_serve = path_launches["tiled_dd"][0]
    dd_serve_cycles = dd_serve["rb_sweeps_tile"] // (2 * DD_TILES)
    # the single run's RHS (the plain stages of the generic tail) through the
    # solver's own report
    g_dd8 = _plain_rhs(dest8, patch8, mask8_roi, 1, "opencv")[0]
    u_dd8, info_dd = solve_poisson_dd(g_dd8, mesh_c, tol=TOL, return_info=True, eig_cache={})
    g_dd8max = g_dd8.abs().max().item()
    dd_rel = info_dd["residual"] / g_dd8max
    dd_rel64 = rel_residual(u_dd8, g_dd8)
    print(f"tiled_dd 8K ({card}): 2x2 mesh of one card, tiles {th_dd}x{tw_dd} + a "
          f"{DD_BAND}-px band; single run {dd_run_cycles} cycles, solve_poisson_dd reports "
          f"{info_dd['cycles']}, relative residual {dd_rel:.3e} (float64 {dd_rel64:.3e}, tol "
          f"{TOL}); serve {dd8_ms:.4f} ms/frame ({dd_serve_cycles / (MG_LOOPS + 1):g} cycles a "
          f"frame) against the single-card 'q' frame {q8_ms:.4f}; launches a cycle "
          f"rb_sweeps_tile {2 * DD_TILES}, mg_down {MG_LEVELS['tiled_dd']}, mg_up "
          f"{MG_LEVELS['tiled_dd']}, clamp_cast_paste {DD_TILES} a frame: "
          f"{json.dumps(dd_serve)}")
    if (info_dd["cycles"] != dd_run_cycles or not dd_rel <= TOL
            or not torch.isfinite(u_dd8).all()):
        raise AssertionError(f"tiled_dd 8K: {dd_run_cycles} cycles run, {info_dd} reported")
    del u_dd8
    # slice 8b: the chained frames against the plain RHS, the whole-g
    # solve_poisson_dd on the same mesh and the paste; the resident frame profiled
    resident_check("tiled_dd", eng_dd, MG_LOOPS, lambda g: solve_poisson_dd(g, mesh_c, tol=TOL),
                   "tiled_dd 8K tolerance", frames_prof=3, brief=False)
    del eng_dd
    eng_dd, dd8_fixed_ms = drive("tiled_dd_fixed", CloneConfig(mg_cycles=4), src8, mask8,
                                 MG_LOOPS, "8K, mg_cycles=4", d_img=dst8, cpu=None,
                                 solver="multigrid_dd", engine=dd_engine(CloneConfig(mg_cycles=4)),
                                 preps=0)
    resident_check("tiled_dd_fixed", eng_dd, MG_LOOPS, lambda g: solve_poisson_dd(
        g, mesh_c, cycles=4), "tiled_dd 8K mg_cycles=4", frames_prof=3, brief=False)
    del eng_dd
    print(f"tiled_dd 8K serve ({card}): tolerance {dd8_ms:.4f} ms/frame, mg_cycles=4 "
          f"{dd8_fixed_ms:.4f}; the single-card 'q' frame {q8_ms:.4f} and {q8_fixed_ms:.4f}")
    one = TiledSeamlessClone(CloneConfig(), mesh=make_tile_mesh([dev], (1, 1)))
    one_out = one.run(src8, dst8, mask8, ctr8).cpu().numpy()
    ref_out = SeamlessClone(CloneConfig(), device="cuda").run(src8, dst8, mask8, ctr8)
    same = np.array_equal(one_out, ref_out.cpu().numpy())
    print(f"tiled 1x1 mesh at 8K: byte for byte SeamlessClone(CloneConfig()) {same}, solver "
          f"{one.metrics['solver_resolved']}")
    if not same or one.metrics["solver_resolved"] != "multigrid":
        raise AssertionError("the 1x1 mesh is not the single-device engine")
    del one, one_out, ref_out
    _, dd_head_ms = drive("tiled_dd_headline", CloneConfig(), src, mask, MG_LOOPS, headline,
                          cpu="run", solver="multigrid_dd", engine=dd_engine(CloneConfig()),
                          preps=0)
    print(f"tiled_dd at the headline ({card}): serve {dd_head_ms:.4f} ms/frame "
          f"({path_launches['tiled_dd_headline'][0]['rb_sweeps_tile'] / (2 * DD_TILES)
              / (MG_LOOPS + 1):g} cycles a frame); the single-card 'q' frame {q_head_ms:.4f}")

    # solve_redblack_tiled on the headline interior: a fixed count, kernel
    # against plain sweeps on the card, then a small solve to tol, card
    # against the CPU mesh
    g_rb = frame_rhs(src, mask, dst)
    rounds = RB_TILED_SWEEPS // (RB_TILED_HALO // 2)
    runs = {}
    for route in (None, False):
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[route] = solve_redblack_tiled(g_rb, mesh_c, tol=0.0, max_iters=RB_TILED_SWEEPS,
                                           halo=RB_TILED_HALO, use_pallas=route,
                                           return_info=True)
        torch.cuda.synchronize()
        runs[route] += ((time.perf_counter() - t0) * 1e3, dict(K.LAUNCHES))
    (u_rk, info_rk, rk_ms, rk_launches), (u_rp, info_rp, rp_ms, _) = runs[None], runs[False]
    rb_equal = torch.equal(u_rk, u_rp)
    print(f"rb_tiled at the headline ({card}): {info_rk['iterations']} sweeps on the 2x2 mesh, "
          f"rb_sweeps_tile {rk_launches['rb_sweeps_tile']} launches = {rounds} rounds x "
          f"{DD_TILES} tiles x 1; {rk_ms / RB_TILED_SWEEPS:.4f} ms a sweep with the kernel, "
          f"{rp_ms / RB_TILED_SWEEPS:.4f} with plain sweeps (host clock, "
          f"{RB_TILED_SWEEPS // 50} checks included); bit-equal {rb_equal}")
    if (rk_launches != _per_frame(rb_sweeps_tile=rounds * DD_TILES) or not rb_equal
            or not info_rk["iterations"] == info_rp["iterations"] == RB_TILED_SWEEPS):
        raise AssertionError(f"rb_tiled: {info_rk}, {info_rp}, launches {rk_launches}")
    path_launches["rb_tiled"] = (rk_launches, rk_launches)
    del g_rb, u_rk, u_rp, runs
    g_rs = frame_rhs(src_j, mask_j, dst)
    mesh_cpu = make_tile_mesh([torch.device("cpu")] * DD_TILES, DD_MESH)
    u_rs, info_rs = solve_redblack_tiled(g_rs, mesh_c, tol=TOL, return_info=True)
    u_rc, info_rc = solve_redblack_tiled(g_rs.cpu(), mesh_cpu, tol=TOL, return_info=True)
    rs_diff = (u_rs.cpu() - u_rc).abs().max().item() / u_rc.abs().max().item()
    print(f"rb_tiled small ({card}): {tuple(g_rs.shape)} to tol {TOL}: {info_rs['iterations']} "
          f"sweeps on the card, {info_rc['iterations']} on the CPU mesh, max |du| / max |u| "
          f"{rs_diff:.3e}, bit-equal {torch.equal(u_rs.cpu(), u_rc)}")
    if info_rs["iterations"] != info_rc["iterations"] or not rs_diff <= 1e-6:
        raise AssertionError(f"rb_tiled small: card {info_rs}, CPU {info_rc}")
    del g_rs, u_rs, u_rc

    # slice 8c: the interior-first schedule (overlap=True) against the plain
    # one, tol 0 at a fixed count, in turns (plain, overlap, overlap, plain),
    # on the 2x2 mesh: the headline at halos 4 and 8, 8K, and small
    # latency-bound tiles; then one profiled overlap round's device ops by
    # stream
    from seamlesscloneoptimization_tpu_torch.parallel import dist_check

    t_ov = time.perf_counter()
    rb_overlap = {}

    def rb_schedules(label, g_, halo, sweeps):
        s_ = halo // 2
        turns, got = {False: [], True: []}, {}
        for ov in (False, True, True, False):
            K.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u_, info_ = solve_redblack_tiled(g_, mesh_c, tol=0.0, max_iters=sweeps, halo=halo,
                                             check_every=RB_OVERLAP_CHECK, overlap=ov,
                                             return_info=True)
            torch.cuda.synchronize()
            turns[ov].append((time.perf_counter() - t0) * 1e3 / info_["iterations"])
            got[ov] = (u_, info_["iterations"], dict(K.LAUNCHES),
                       K.WINDOW_LAUNCHES["rb_sweeps_tile"])
        (u_p, it_p, l_p, w_p), (u_o, it_o, l_o, w_o) = got[False], got[True]
        rounds_ = it_o // s_
        per_ = DD_TILES * -(-s_ // 4)
        rec = dict(grid=list(g_.shape), tile=[g_.shape[1] // DD_MESH[0],
                                              g_.shape[2] // DD_MESH[1]],
                   halo=halo, sweeps=it_o, bit_equal=torch.equal(u_p, u_o),
                   plain_ms_per_sweep=sum(turns[False]) / 2,
                   overlap_ms_per_sweep=sum(turns[True]) / 2,
                   turns_ms_per_sweep={"plain": turns[False], "overlap": turns[True]},
                   launches_plain=l_p["rb_sweeps_tile"], launches_overlap=l_o["rb_sweeps_tile"],
                   window_launches_overlap=w_o)
        rec["overlap_over_plain"] = rec["overlap_ms_per_sweep"] / rec["plain_ms_per_sweep"]
        print(f"rb_overlap {label} ({card}): {tuple(g_.shape)} on the 2x2 mesh, halo {halo}, "
              f"{it_o} sweeps: plain {rec['plain_ms_per_sweep']:.4f} ms a sweep, overlap "
              f"{rec['overlap_ms_per_sweep']:.4f} (x{rec['overlap_over_plain']:.3f}; host clock, "
              f"the checks included, the mean of two turns each); bit-equal {rec['bit_equal']}; "
              f"rb_sweeps_tile {l_o['rb_sweeps_tile']} = {rounds_} rounds x {DD_TILES} tiles x 5 "
              f"x {-(-s_ // 4)} ({w_o} of the window form), plain {l_p['rb_sweeps_tile']}")
        if (not rec["bit_equal"] or not it_p == it_o == sweeps
                or l_o != _per_frame(rb_sweeps_tile=rounds_ * 5 * per_)
                or w_o != rounds_ * 4 * per_ or w_p != 0
                or l_p != _per_frame(rb_sweeps_tile=rounds_ * per_)):
            raise AssertionError(f"rb_overlap {label}: {rec}, launches {l_o}, {l_p}")
        rb_overlap[label] = rec
        return l_o, w_o

    g_rb = frame_rhs(src, mask, dst)
    for halo in (RB_TILED_HALO, 8):
        launches_ov, window_ov = rb_schedules(f"headline_halo{halo}", g_rb, halo,
                                              RB_OVERLAP_SWEEPS)
        if halo == RB_TILED_HALO:
            path_launches["rb_tiled_overlap"] = (launches_ov, launches_ov)
            rows["rb_sweeps_tile_window"].update(
                launches=window_ov, path=f"rb_overlap headline_halo{halo} (the bands of "
                                         f"{RB_OVERLAP_SWEEPS // (halo // 2)} rounds x 4 tiles)")
    g_rb8 = frame_rhs(src8, mask8, dst8)
    rb_schedules("8k_halo4", g_rb8, RB_TILED_HALO, RB_OVERLAP_SWEEPS_8K)
    del g_rb8
    g_small = torch.randn((c, *RB_OVERLAP_SMALL), generator=torch.Generator(dev).manual_seed(
        SEED + 23), device=dev) * 50
    rb_schedules(f"small_{RB_OVERLAP_SMALL[0]}_halo8", g_small, 8, RB_OVERLAP_SWEEPS)
    del g_small
    rows["rb_sweeps_tile"]["rb_overlap_launches"] = {
        label: {"overlap": r["launches_overlap"], "window": r["window_launches_overlap"],
                "plain": r["launches_plain"]} for label, r in rb_overlap.items()}

    def side_streams(streams, staged):
        """(the streams of the rb_sweeps_tile kernels, the other streams
        that ran any of ``staged``)."""
        rb = sorted(st for st, ops in streams.items() if ops.get("rb_sweeps_tile"))
        other = sorted(st for st, ops in streams.items()
                       if st not in rb and any(ops.get(k) for k in staged))
        return rb, other

    one_round = dict(tol=0.0, max_iters=RB_TILED_HALO // 2, check_every=RB_TILED_HALO // 2,
                     halo=RB_TILED_HALO, overlap=True)
    streams = dist_check.stream_ops(lambda: solve_redblack_tiled(g_rb, mesh_c, **one_round))
    rb_st, copy_st = side_streams(streams, ("copy", "fill", "Memset", "DtoD"))
    rb_overlap["streams_one_process"] = streams
    print(f"rb_overlap one profiled round ({card}; a check's exchange, the round, the gather), "
          f"device ops by stream: {json.dumps(streams)}; rb_sweeps_tile on {rb_st}, strip "
          f"copies and zero fills also on {copy_st}")
    if len(rb_st) != 1 or not copy_st:
        raise AssertionError(f"rb_overlap: the strip copies are not on a side stream: {streams}")
    del g_rb
    print(json.dumps({"rb_overlap": rb_overlap}))
    print(f"the slice-8c rb_overlap phase ran {time.perf_counter() - t_ov:.1f} s")

    _, unp_ms = drive("mg_padded_false", CloneConfig(solver="multigrid", mg_padded=False), src,
                      mask, MG_LOOPS, headline, cpu="run", solver="multigrid")
    unp_run_cycles = check_unpadded_counts("mg_padded_false", "single-shot run",
                                           path_launches["mg_padded_false"][1], 1)
    g_unp = frame_rhs(src, mask, dst)
    _, info_unp = TM.solve_multigrid(g_unp, use_pallas=True, padded=False, tol=TOL,
                                     return_info=True)
    unp_rel = info_unp["residual"] / g_unp.abs().max().item()
    print(f"mg_padded_false at the headline ({card}): serve {unp_ms:.4f} ms/frame; single run "
          f"{unp_run_cycles} cycles, solve_multigrid reports {info_unp['cycles']}, relative "
          f"residual {unp_rel:.3e}; the 'q' frame {q_head_ms:.4f}")
    if info_unp["cycles"] != unp_run_cycles or not unp_rel <= TOL:
        raise AssertionError(f"mg_padded_false: {unp_run_cycles} cycles run, {info_unp}")
    del g_unp

    # -- slice 4b: the dense rounded multigrid (mg_padded=True) at 8K through
    #    auto (tolerance, mg_cycles=4) and at the headline; fmg and pcg --------
    for path, (lh, lw) in (("mg_padded_true", (h8, w8)), ("mg_padded_true_headline", (h2, w2))):
        if (TM.quarter_path_applies(lh, lw, 0)
                or len(TM.p_levels(lh, lw)) != MG_LEVELS[path]):
            raise AssertionError(f"{path}: {lh}x{lw} is not a dense-chain grid with "
                                 f"{MG_LEVELS[path]} fused levels")
    print(f"dense rounded chain: 8K levels {[lv[4] for lv in TM.p_levels(h8, w8)]}, headline "
          f"levels {[lv[4] for lv in TM.p_levels(h2, w2)]} ((th, hp, wp) of mg_geometry)")
    _, pt8_ms = drive("mg_padded_true", CloneConfig(mg_padded=True), src8, mask8, MG_LOOPS,
                      "8K", d_img=dst8, cpu=None, solver="multigrid")
    pt_run_cycles = check_unpadded_counts("mg_padded_true", "single-shot run (8K)",
                                          path_launches["mg_padded_true"][1], 1)
    pt_serve_cycles = (path_launches["mg_padded_true"][0]["mg_down"]
                       // MG_LEVELS["mg_padded_true"])
    # the single run's RHS (the exact-size RHS of the generic tail) through the
    # solver's own report
    g_pt8 = frame_rhs(src8, mask8, dst8)
    u_pt8, info_pt8 = TM.solve_multigrid(g_pt8, use_pallas=True, padded=True, tol=TOL,
                                         return_info=True)
    pt_rel = info_pt8["residual"] / g_pt8.abs().max().item()
    print(f"mg_padded_true 8K ({card}): single run {pt_run_cycles} cycles, solve_multigrid "
          f"reports {info_pt8['cycles']}, relative residual {pt_rel:.3e} (float64 "
          f"{rel_residual(u_pt8, g_pt8):.3e}, tol {TOL}); serve {pt8_ms:.4f} ms/frame "
          f"({pt_serve_cycles / (MG_LOOPS + 1):g} cycles a frame); the 'q' frame {q8_ms:.4f}, "
          f"the 't' frame {mg8_ms:.4f}")
    if (info_pt8["cycles"] != pt_run_cycles or not pt_rel <= TOL
            or not torch.isfinite(u_pt8).all()):
        raise AssertionError(f"mg_padded_true 8K: {pt_run_cycles} cycles run, {info_pt8}")
    del g_pt8, u_pt8
    _, pt8_fixed_ms = drive("mg_padded_true_fixed", CloneConfig(mg_padded=True, mg_cycles=4),
                            src8, mask8, MG_LOOPS, "8K, mg_cycles=4", d_img=dst8, cpu=None,
                            solver="multigrid")
    for label, cyc in (("mg_padded_true 8K tolerance", None),
                       ("mg_padded_true 8K mg_cycles=4", 4)):
        kw = CloneConfig(solver="multigrid", mg_padded=True, mg_cycles=cyc).solver_kwargs()
        profile_frames(label, clone_pipeline, dict(
            src=torch.from_numpy(src8).to(dev), dst=dst8_p.clone(),
            mask=torch.from_numpy(m8).to(dev), bbox_xy=(x8, y8), left_top=(left8, top8),
            bbox_hw=(bh8, bw8), flags=1, planar_dst=True, solver=TM.solve_multigrid,
            bases={}, solver_name="multigrid", solver_kwargs=kw), frames=3,
            into=loop_profiles)
    _, pt_head_ms = drive("mg_padded_true_headline", CloneConfig(solver="multigrid",
                                                                 mg_padded=True),
                          src, mask, MG_LOOPS, headline, cpu="run", solver="multigrid")
    pt_same = np.array_equal(run_outputs["mg_padded_true_headline"],
                             run_outputs["mg_padded_false"])
    pt_head_cycles = (path_launches["mg_padded_true_headline"][0]["mg_down"]
                      / MG_LEVELS["mg_padded_true_headline"] / (MG_LOOPS + 1))
    print(f"mg_padded_true at the headline ({card}): serve {pt_head_ms:.4f} ms/frame "
          f"({pt_head_cycles:g} cycles a frame); mg_padded=False "
          f"{unp_ms:.4f}; the single run bit-equal to mg_padded_false's: {pt_same}; 8K serve "
          f"tolerance {pt8_ms:.4f}, mg_cycles=4 {pt8_fixed_ms:.4f} ms/frame")
    if not pt_same:
        raise AssertionError("mg_padded=True and mg_padded=False differ at the headline")

    # fmg_start (the default "q" chain: the cascade's element V-cycles, then
    # the check-first loop from it) and pcg (the element V-cycle as the
    # preconditioner) on the headline RHS, the card against the CPU
    g_h = frame_rhs(src, mask, dst)
    g_hmax = g_h.abs().max().item()
    n_h = len(TM.p_levels(h2, w2))
    _, info_z = TM.solve_multigrid(g_h, use_pallas=True, tol=TOL, return_info=True)
    solver_runs = {}
    for path, kw in (("mg_fmg", {"fmg_start": True}), ("mg_pcg", {"pcg": True})):
        TM.solve_multigrid(g_h, use_pallas=True, tol=TOL, **kw)  # warm-up
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        u_s, info_s = TM.solve_multigrid(g_h, use_pallas=True, tol=TOL, return_info=True, **kw)
        torch.cuda.synchronize()
        s_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(K.LAUNCHES)
        _, info_c = TM.solve_multigrid(g_h.cpu(), use_pallas=True, tol=TOL, return_info=True,
                                       **kw)
        rel = info_s["residual"] / g_hmax
        rel64 = rel_residual(u_s, g_h)
        k = info_s["cycles"]
        if path == "mg_fmg":  # the cascade's V-cycle a level, each fusing the levels below
            want = _per_frame(mg_down=n_h * (n_h + 1) // 2, mg_up=n_h * (n_h + 1) // 2,
                              to_quarters=2, from_quarters=1,
                              **{q: k for q in Q_CHECK_FIRST},
                              **{t: k * MG_LEVELS["mg_q_headline"] for t in MG_KERNELS})
        else:  # one preconditioning V-cycle to start and one an iteration
            want = _per_frame(mg_down=n_h * (k + 1), mg_up=n_h * (k + 1))
        what = "cycles" if path == "mg_fmg" else "iterations"
        print(f"{path} at the headline ({card}): {k} {what} on the card, "
              f"{info_c['cycles']} on the CPU, {info_z['cycles']} cycles from zero; "
              f"relative residual {rel:.3e} (float64 {rel64:.3e}, tol {TOL}); "
              f"{s_ms:.1f} ms a solve (host clock); launches "
              f"{json.dumps({n: v for n, v in launches.items() if v})}")
        if (k != info_c["cycles"] or not rel <= TOL or launches != want
                or not torch.isfinite(u_s).all()
                or (path == "mg_fmg" and not k <= info_z["cycles"])):
            raise AssertionError(f"{path}: {info_s}, CPU {info_c}, zero start {info_z}, "
                                 f"launches {launches}, expected {want}")
        path_launches[path] = (launches, launches)
        solver_runs[path] = dict(cycles=k, cpu_cycles=info_c["cycles"],
                                 zero_start_cycles=info_z["cycles"], rel_residual=rel,
                                 rel_residual_f64=rel64, host_ms=s_ms)
        del u_s
    del g_h

    # -- slice 4c: the pair-chain frame in each bf16 precision mode: serve ms,
    #    the GEMMs' time, the solve against the CPU's and FP32's, diff_max ---
    prec_kw = dict(src=torch.from_numpy(src).to(dev), dst=dst_p.clone(),
                   mask=torch.from_numpy(m).to(dev), bbox_xy=(x0, y0), left_top=(left, top),
                   bbox_hw=(bh, bw), flags=1, planar_dst=True)
    gen_p = torch.Generator(dev).manual_seed(SEED + 5)
    g_tp_c = g_tp.cpu()
    u_fp32 = solve_dst_gemm_pl(g_tp, h2, w2, "high", True, bases=fold_b)[:, :h2, :w2]
    precision_rows = {}
    for path, mode in (("pair", "high"), *PRECISION_PATHS.items()):
        if path != "pair":  # the card against the CPU in the mode: below, on the solve
            _, ms = drive(path, CloneConfig(precision=mode), src, mask, SERVE_LOOPS, headline,
                          cpu=None)
        else:
            ms = pair_ms
        b_mode = dst_bases(h2, w2, hp, wp, dev, folded=True, precision=mode)
        # the pair chain's 8 products in the mode, on its operand shapes, back to
        # back with CUDA events (the profile below may lose a frame's events)
        fwd_mode, inv_mode = TD.PRECISION_MODES[mode]
        gh = sum(x.shape[0] for x in b_mode[0].mats[:2])
        gw = sum(x.shape[0] for x in b_mode[1].mats[:2])
        prods = []
        b_h_, b_w_ = b_mode
        for basis, k, rows_, prod in ((b_h_, 0, wp, fwd_mode), (b_h_, 1, wp, fwd_mode),
                                      (b_w_, 0, gh, fwd_mode), (b_w_, 1, gh, fwd_mode),
                                      (b_h_, 2, gw, inv_mode), (b_h_, 3, gw, inv_mode),
                                      (b_w_, 2, hp, inv_mode), (b_w_, 3, hp, inv_mode)):
            a_ = torch.randn((c, rows_, basis.mats[k].shape[0]), generator=gen_p, device=dev)
            prods.append((a_, basis.mats[k], basis.bf16[k] if basis.bf16 else None, prod))
        gemm_ms = b2b_ms(lambda prods=prods: [TD._mm(*x) for x in prods])
        del prods
        for _ in range(3):  # a fraction of a GEMM a frame: the trace lost events
            prof = profile_frames(f"pair {mode}", clone_pipeline, dict(
                prec_kw, solver_kwargs={"precision": mode, "folded": True}, bases=b_mode),
                brief=True)
            if prof["gemms"] == int(prof["gemms"]):
                break
        u_mode = solve_dst_gemm_pl(g_tp, h2, w2, mode, True, bases=b_mode)[:, :h2, :w2]
        u_cpu = solve_dst_gemm_pl(g_tp_c, h2, w2, mode, True)[:, :h2, :w2]
        umax = u_fp32.abs().max().item()
        rel_cpu = (u_mode.cpu() - u_cpu).abs().max().item() / umax
        rel_fp32 = (u_mode - u_fp32).abs().max().item() / umax
        rel_fp32_cpu = (u_cpu - u_fp32.cpu()).abs().max().item() / umax
        img_cpu = SeamlessClone(CloneConfig(precision=mode), device="cpu").run(
            src, dst, mask, center).numpy()
        precision_rows[mode] = dict(
            path=path, ms_per_frame=ms, gemm_ms=gemm_ms, profiled_gemm_us=prof.get("gemm_us"),
            profiled_gemms=prof["gemms"], busy_us=prof["busy_us"],
            torch_op_launches=prof.get("torch_op_launches"), solve_rel_vs_cpu=rel_cpu,
            solve_rel_vs_fp32=rel_fp32, cpu_solve_rel_vs_fp32=rel_fp32_cpu,
            diff_max_vs_fp32=diff_max(run_outputs[path], run_outputs["pair"]),
            diff_max_vs_cpu=diff_max(run_outputs[path], img_cpu))
        # the card's solve carries the mode's error: its distance from FP32
        # within 5% (+1e-4 of max |u|) of the CPU path's, whose arithmetic the
        # CPU tests pin to JAX's (tests/test_torch_precision_modes.py). The two
        # differ where a bf16 rounding flips between the GEMM routes' FP32 sums.
        if (not abs(rel_fp32 - rel_fp32_cpu) <= 0.05 * rel_fp32_cpu + 1e-4
                or not torch.isfinite(u_mode).all()):
            raise AssertionError(f"precision {mode}: the card's solve is {rel_fp32:.3e} of max "
                                 f"|u| from FP32's, the CPU path's {rel_fp32_cpu:.3e}")
        del b_mode, u_mode, u_cpu, img_cpu
    print(f"precision modes on the pair chain at the headline ({card}): " + "; ".join(
        f"{mode} {r['ms_per_frame']:.4f} ms/frame, 8 GEMM products {r['gemm_ms']:.4f} ms "
        f"(profiled {r['profiled_gemm_us']} us x{r['profiled_gemms']:g}), busy "
        f"{r['busy_us']:.1f} us, solve vs the CPU {r['solve_rel_vs_cpu']:.2e} and vs FP32 "
        f"{r['solve_rel_vs_fp32']:.2e} (the CPU path's {r['cpu_solve_rel_vs_fp32']:.2e}) of "
        f"max |u|, diff_max vs FP32 {r['diff_max_vs_fp32']}, "
        f"vs the CPU {r['diff_max_vs_cpu']}" for mode, r in precision_rows.items()))
    print(json.dumps({"precision_modes": precision_rows, "solver_runs": solver_runs}))
    del prec_kw, g_tp_c, u_fp32

    # -- slice 5: bucketed serving, bbox_bucket=128 on seeded ellipse masks:
    #    bucket_exact at the headline and at 8K, the grown bucket on the pair
    #    chain, on the transposed tail and on the "q" chain at 8K ------------------
    from seamlesscloneoptimization_tpu_torch.solvers.multigrid_dyn import solve_dyn_window

    rng_b = np.random.default_rng(SEED + 11)
    mask_b = ellipse_mask(rng_b, SRC_HW, BUCKET_BBOX)
    mask_b8 = ellipse_mask(rng_b, SRC_8K, BUCKET_BBOX_8K)
    bucket_rows = {}

    def bucket_prep(s_img, mask_, d_img):
        """prepare_inputs with the bucket: (mask, xy, left_top, bucket hw, tight)."""
        ctr = (d_img.shape[1] // 2, d_img.shape[0] // 2)
        return prepare_inputs(mask_, s_img.shape, d_img.shape, ctr, bucket=BUCKET,
                              return_tight=True)

    def bucket_roi(s_img, mask_, d_img, device, window):
        """(dest, patch, mask) of the bucket ROI (``window`` False) or of the
        tight window in it, as the pipeline makes them."""
        m_, (xs, ys), (lf, tp), (rh, rw), (dy, dx, th, tw) = bucket_prep(s_img, mask_, d_img)
        if window:
            xs, ys, lf, tp, rh, rw = xs + dx, ys + dy, lf + dx, tp + dy, th, tw
        dd = torch.from_numpy(d_img).to(device).permute(2, 0, 1)[:, tp : tp + rh, lf : lf + rw]
        ss = torch.from_numpy(s_img).to(device)[ys : ys + rh, xs : xs + rw].permute(2, 0, 1)
        mm = torch.from_numpy(np.ascontiguousarray(m_[ys : ys + rh, xs : xs + rw])).to(device)
        return dd, torch.where(mm[None] != 0, ss, 0).to(torch.uint8), mm

    def tight_rhs(s_img, mask_, d_img, device):
        """The RHS a bucket_exact frame solves (the tight window's, exact
        size: the kernels on the card, their twins on the CPU), and the
        bucket's interior, whose shape sets the hierarchy."""
        dd, pp, mm = bucket_roi(s_img, mask_, d_img, device, window=True)
        _, _, _, (rh, rw), _ = bucket_prep(s_img, mask_, d_img)
        th, tw = mm.shape
        return K.preprocess_rhs_p(dd, pp, K.erode3(mm), (th - 2, tw - 2)), (rh - 2, rw - 2)

    def bucket_profile(label, eng_, s_img, mask_, d_img):
        """profile_frames of the engine's serve frame (the tight bbox carried
        along in bucket_exact mode)."""
        ctr = (d_img.shape[1] // 2, d_img.shape[0] // 2)
        m_, xy, lt, hw, tight = eng_._unpack_prep(eng_._prepare(mask_, s_img, d_img, ctr))
        kw = dict(src=torch.from_numpy(s_img).to(dev),
                  dst=torch.from_numpy(d_img).to(dev).permute(2, 0, 1).contiguous(),
                  mask=torch.from_numpy(m_).to(dev), bbox_xy=xy, left_top=lt, true_bbox=tight,
                  planar_dst=True, **eng_._pipeline_kwargs(hw, eng_.config.flags, True))
        return profile_frames(label, clone_pipeline, kw, frames=3, into=loop_profiles)

    def served_equals_run(path, eng_, s_img, mask_, d_img):
        """One chained serve frame (the warm-up on the planar buffer) against
        the path's single-shot run, byte for byte."""
        ctr = (d_img.shape[1] // 2, d_img.shape[0] // 2)
        served, _ = eng_.timed_serve(s_img, d_img, mask_, ctr, loops=0)
        if not np.array_equal(served.cpu().numpy(), run_outputs[path]):
            raise AssertionError(f"{path}: a served frame differs from run()")

    def prof_row(prof):
        return dict(busy_us=prof["busy_us"], span_us=prof["span_us"], idle=prof["idle"],
                    torch_op_launches=prof.get("torch_op_launches"))

    for hw_, bbox, want in ((SRC_HW, BUCKET_BBOX, BUCKET_HW),
                            (SRC_8K, BUCKET_BBOX_8K, BUCKET_HW_8K)):
        m_t = mask_b if hw_ == SRC_HW else mask_b8
        d_t = dst if hw_ == SRC_HW else dst8
        prep_t = bucket_prep(np.empty(hw_ + (3,), np.uint8), m_t, d_t)
        if prep_t[3] != want or tuple(prep_t[4][2:]) != bbox:
            raise AssertionError(f"bucket geometry {prep_t[3]}, tight {prep_t[4]}: expected "
                                 f"{want}, {bbox}")
    bh2, bw2 = BUCKET_HW[0] - 2, BUCKET_HW[1] - 2
    bh28, bw28 = BUCKET_HW_8K[0] - 2, BUCKET_HW_8K[1] - 2
    print(f"bucket geometry: headline tight {BUCKET_BBOX} in bucket {BUCKET_HW} (interior "
          f"{bh2} x {bw2}, h2 % 4 = {bh2 % 4}, w2 % 128 = {bw2 % 128}), 8K tight "
          f"{BUCKET_BBOX_8K} in bucket {BUCKET_HW_8K} (interior {bh28} x {bw28}, "
          f"{bh28 * bw28 / 1e6:.2f} MP)")

    # bucket_exact at the headline: the card against the CPU, the cycles against
    # the CPU path's report, a served frame equal to run(), and the image
    # against the tight unbucketed DST-GEMM frame's
    cfg_be = CloneConfig(bbox_bucket=BUCKET, bucket_exact=True)
    eng_be, be_ms = drive("bucket_exact_headline", cfg_be, src, mask_b, MG_LOOPS, headline,
                          cpu="run", solver="multigrid_dyn")
    be_run = check_unpadded_counts("bucket_exact_headline", "single-shot run",
                                   path_launches["bucket_exact_headline"][1], 1)
    be_serve = (path_launches["bucket_exact_headline"][0]["mg_down"]
                / MG_LEVELS["bucket_exact_headline"] / (MG_LOOPS + 1))
    g_bh, pad_bh = tight_rhs(src, mask_b, dst, dev)
    _, info_bh = solve_dyn_window(g_bh, pad_bh, tol=TOL, return_info=True)
    g_bh_cpu, _ = tight_rhs(src, mask_b, dst, "cpu")
    _, info_bh_cpu = solve_dyn_window(g_bh_cpu, pad_bh, tol=TOL, return_info=True)
    rel_bh = info_bh["residual"] / g_bh.abs().max().item()
    served_equals_run("bucket_exact_headline", eng_be, src, mask_b, dst)
    tight_img = SeamlessClone(CloneConfig(), device="cuda").run(
        src, dst, mask_b, center).cpu().numpy()
    d_tight = diff_max(run_outputs["bucket_exact_headline"], tight_img)
    print(f"bucket_exact headline ({card}): single run {be_run} cycles, the card's solve of its "
          f"RHS {info_bh['cycles']}, the CPU path's {info_bh_cpu['cycles']}; relative residual "
          f"{rel_bh:.3e} (tol {TOL}); a served frame equal to run(); diff_max against the tight "
          f"unbucketed dst_gemm frame {d_tight}")
    if not (be_run == info_bh["cycles"] == info_bh_cpu["cycles"]) or not rel_bh <= TOL:
        raise AssertionError(f"bucket_exact headline: {be_run} cycles run, card {info_bh}, "
                             f"CPU {info_bh_cpu}")
    del g_bh, g_bh_cpu
    bucket_rows["bucket_exact_headline"] = dict(
        ms_per_frame=be_ms, cycles_run=be_run, cycles_per_served_frame=be_serve,
        cpu_cycles=info_bh_cpu["cycles"], rel_residual=rel_bh,
        diff_max_vs_cpu=cpu_diffs[f"bucket_exact_headline ({headline})"],
        diff_max_vs_tight_dst_gemm=d_tight,
        **prof_row(bucket_profile("bucket_exact headline", eng_be, src, mask_b, dst)))
    del eng_be

    # bucket_exact at 8K: the cycles against the solver's report, the residual
    eng_be8, be8_ms = drive("bucket_exact_8k", cfg_be, src8, mask_b8, MG_LOOPS, "8K",
                            d_img=dst8, cpu=None, solver="multigrid_dyn")
    be8_run = check_unpadded_counts("bucket_exact_8k", "single-shot run (8K)",
                                    path_launches["bucket_exact_8k"][1], 1)
    be8_serve = (path_launches["bucket_exact_8k"][0]["mg_down"]
                 / MG_LEVELS["bucket_exact_8k"] / (MG_LOOPS + 1))
    g_b8, pad_b8 = tight_rhs(src8, mask_b8, dst8, dev)
    u_b8, info_b8 = solve_dyn_window(g_b8, pad_b8, tol=TOL, return_info=True)
    rel_b8 = info_b8["residual"] / g_b8.abs().max().item()
    rel_b8_64 = rel_residual(u_b8, g_b8)
    served_equals_run("bucket_exact_8k", eng_be8, src8, mask_b8, dst8)
    print(f"bucket_exact 8K ({card}): single run {be8_run} cycles, the solve of its RHS "
          f"{info_b8['cycles']}; relative residual {rel_b8:.3e} (float64 {rel_b8_64:.3e}, tol "
          f"{TOL}); a served frame equal to run()")
    if be8_run != info_b8["cycles"] or not rel_b8 <= TOL or not torch.isfinite(u_b8).all():
        raise AssertionError(f"bucket_exact 8K: {be8_run} cycles run, {info_b8}")
    del g_b8, u_b8
    bucket_rows["bucket_exact_8k"] = dict(
        ms_per_frame=be8_ms, cycles_run=be8_run, cycles_per_served_frame=be8_serve,
        rel_residual=rel_b8, rel_residual_f64=rel_b8_64,
        **prof_row(bucket_profile("bucket_exact 8K", eng_be8, src8, mask_b8, dst8)))
    del eng_be8

    # the grown bucket at the headline (the pair chain on 1406 x 2302), then
    # three mask sizes in the one bucket: one cached set of DST bases
    cfg_bg = CloneConfig(bbox_bucket=BUCKET)
    eng_bg, bg_ms = drive("bucket_grown_headline", cfg_bg, src, mask_b, SERVE_LOOPS, headline,
                          cpu="run")
    sizes = []
    for bbox in BUCKET_SIZES:
        mk = ellipse_mask(rng_b, SRC_HW, bbox)
        *_, (bh_b, bw_b), tight_b = bucket_prep(src, mk, dst)
        K.reset_launches()
        out_b = eng_bg.run(src, dst, mk, center)
        torch.cuda.synchronize()
        if (bh_b, bw_b) != BUCKET_HW or tuple(tight_b[2:]) != bbox:
            raise AssertionError(f"{bbox}: bucket {(bh_b, bw_b)}, tight {tight_b}")
        check_counts("bucket_grown_headline", f"run, tight {bbox}", dict(K.LAUNCHES), 1, 1)
        sizes.append(dict(tight=bbox, changed=int((out_b.cpu().numpy() != dst).any(-1).sum())))
    if len(eng_bg._bases) != 1:
        raise AssertionError(f"three masks in one bucket left {len(eng_bg._bases)} bases")
    d_grown = diff_max(run_outputs["bucket_grown_headline"], tight_img)
    print(f"bucket_grown headline ({card}): three tight bboxes {[x['tight'] for x in sizes]} "
          f"in the bucket {BUCKET_HW}, one _bases entry; diff_max against the tight "
          f"unbucketed frame {d_grown} (the Dirichlet frame moved to the bucket's edge)")
    bucket_rows["bucket_grown_headline"] = dict(
        ms_per_frame=bg_ms, bases_entries=len(eng_bg._bases), sizes=sizes,
        diff_max_vs_cpu=cpu_diffs[f"bucket_grown_headline ({headline})"],
        diff_max_vs_tight_dst_gemm=d_grown,
        **prof_row(bucket_profile("bucket_grown headline", eng_bg, src, mask_b, dst)))
    del eng_bg, tight_img

    # the grown bucket with use_pallas_preprocess=False: the plain RHS, the
    # transposed solve, postprocess_transposed at h2 = 1406 (the ragged route)
    eng_bp, bp_ms = drive("bucket_grown_post_t",
                          CloneConfig(bbox_bucket=BUCKET, use_pallas_preprocess=False), src,
                          mask_b, SERVE_LOOPS, headline, cpu="run")
    bucket_rows["bucket_grown_post_t"] = dict(
        ms_per_frame=bp_ms, h2_mod_4=bh2 % 4,
        diff_max_vs_cpu=cpu_diffs[f"bucket_grown_post_t ({headline})"],
        **prof_row(bucket_profile("bucket_grown_post_t", eng_bp, src, mask_b, dst)))
    del eng_bp

    # the grown bucket at 8K: 2686 x 3710 = 9.97 MP resolves to the "q"
    # multigrid; the single run's cycles against the solve of its RHS
    if (not TM.quarter_path_applies(bh28, bw28)
            or len(TM.q_coarse_levels(bh28, bw28)) != MG_LEVELS["bucket_grown_8k"]):
        raise AssertionError("the 8K bucket is not a quarter-plane grid with "
                             f"{MG_LEVELS['bucket_grown_8k']} fused coarse levels")
    eng_bg8, bg8_ms = drive("bucket_grown_8k", cfg_bg, src8, mask_b8, MG_LOOPS, "8K",
                            d_img=dst8, cpu=None, solver="multigrid")
    bg8_run = check_mg_q_counts("bucket_grown_8k", "single-shot run (8K)",
                                path_launches["bucket_grown_8k"][1], 1)
    dd8, pp8, mm8 = bucket_roi(src8, mask_b8, dst8, dev, window=False)
    _, hq_b, wq2_b, _ = K.mg_geometry_q(bh28, bw28)
    gq_b = K.preprocess_rhs_q(dd8, pp8, K.erode3(mm8), (2 * hq_b, 2 * wq2_b))
    K.reset_launches()
    uq_b = TM.solve_multigrid(gq_b, true_hw=(bh28, bw28), padded="q", use_pallas=True,
                              tol=TOL, padded_output="quarters")
    torch.cuda.synchronize()
    bg8_solve = K.LAUNCHES["mg_ud_q"]
    rel_bg8 = rel_residual(K.from_quarters(uq_b)[:, :bh28, :bw28],
                           K.from_quarters(gq_b)[:, :bh28, :bw28])
    print(f"bucket_grown 8K ({card}): single run {bg8_run} cycles (mg_ud_q launches), the "
          f"solve of its RHS {bg8_solve}, relative residual {rel_bg8:.3e} (tol {TOL})")
    if bg8_solve != bg8_run or not rel_bg8 <= TOL or not torch.isfinite(uq_b).all():
        raise AssertionError(f"bucket_grown 8K: {bg8_run} cycles run, {bg8_solve} in the "
                             f"solve, residual {rel_bg8}")
    del dd8, pp8, mm8, gq_b, uq_b
    bucket_rows["bucket_grown_8k"] = dict(
        ms_per_frame=bg8_ms, cycles_run=bg8_run, rel_residual_f64=rel_bg8,
        cycles_per_served_frame=path_launches["bucket_grown_8k"][0]["mg_ud_q"] / (MG_LOOPS + 1),
        **prof_row(bucket_profile("bucket_grown 8K", eng_bg8, src8, mask_b8, dst8)))
    del eng_bg8
    for path, r in bucket_rows.items():
        print(f"{path} ({card}): serve {r['ms_per_frame']:.4f} ms/frame, kernels busy "
              f"{r['busy_us']:.1f} us/frame of a {r['span_us']:.1f} us span, idle share "
              f"{r['idle']}, torch-op kernel launches {r['torch_op_launches']} a frame"
              + (f", {r['cycles_per_served_frame']:g} cycles a served frame"
                 if "cycles_per_served_frame" in r else ""))
    print(json.dumps({"bucket_paths": bucket_rows}))

    # -- slice 6: the batch (64 jobs into one 4K destination a step, one shape
    #    and mixed sizes) and the edits (1080p on the direct route, 4K on the
    #    "q" chain, and over a 2x2 mesh of the card) ----------------------------
    from seamlesscloneoptimization_tpu_torch import api as TA
    from seamlesscloneoptimization_tpu_torch.ops import edit as TE
    from seamlesscloneoptimization_tpu_torch.ops.canny import canny
    from seamlesscloneoptimization_tpu_torch.ops.rhs import poisson_rhs
    from seamlesscloneoptimization_tpu_torch.parallel import batch as TB
    from seamlesscloneoptimization_tpu_torch.parallel import local_edit_tiled

    t_6 = time.perf_counter()
    rng_6 = np.random.default_rng(SEED + 13)
    dst4k = synthetic_image(rng_6, DST_4K)
    gy_, gx_ = BATCH_GRID
    cell_h, cell_w = DST_4K[0] // gy_, DST_4K[1] // gx_
    cells = [(cell_w // 2 + cell_w * (i % gx_), cell_h // 2 + cell_h * (i // gx_))
             for i in range(gy_ * gx_)]
    batch_rows, edit_rows = {}, {}

    def launches_of(fn):
        """fn() with the counters set to 0 just before and read just after."""
        K.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        return res, dict(K.LAUNCHES)

    def event_ms(fn, n: int) -> list:
        """fn() once to warm up, then n calls each timed with CUDA events."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            fn()
            e_ev.record()
            e_ev.synchronize()
            times.append(s_ev.elapsed_time(e_ev))
        return times

    def batch_step(groups_d, out, bucket, use_pallas, tol):
        """The device part of a seamless_clone_batch_fused call: its groups'
        steps on the resident destination."""
        return TB.composite_groups(out, groups_d, 1, TB.fast_dst_solver(), bucket, use_pallas,
                                   tol)

    def drive_batch(path, srcs_, masks_, centers_, bucket="exact", use_pallas=False, tol=TOL,
                    steps=BATCH_STEPS):
        """One call of the entry point on the card (the counters around it,
        checked when the path has fixed counts), the card against the CPU
        (diff_max <= 1), the device step timed (warm-up + ``steps``, CUDA
        events each) and profiled. Returns (the card's image, its row)."""
        kw = dict(bucket=bucket, use_pallas=use_pallas, tol=tol)
        t0 = time.perf_counter()
        out, launches = launches_of(lambda: TB.seamless_clone_batch_fused(
            dst4k, srcs_, masks_, centers_, **kw))
        call_s = time.perf_counter() - t0
        if PATHS[path] is not None:
            check_counts(path, "call", launches, 1, 0)
        path_launches.setdefault(path, (launches, launches))
        run_outputs.setdefault(path, out)
        d_cpu = diff_max(out, TB.seamless_clone_batch_fused(dst4k, srcs_, masks_, centers_, **kw,
                                                            device="cpu"))
        cpu_diffs[path] = d_cpu
        if d_cpu > 1 or out.shape != dst4k.shape or np.array_equal(out, dst4k):
            raise AssertionError(f"{path}: card against CPU diff_max {d_cpu}")
        groups_d = TB.plan_groups(dst4k.shape, srcs_, masks_, centers_, bucket, device=dev)
        out_d = torch.from_numpy(dst4k).to(dev)
        ms = event_ms(lambda: batch_step(groups_d, out_d, bucket, use_pallas, tol), steps)
        # pad_exact's step is ~100 000 torch ops: one profiled step, no trace kept
        prof = profile_frames(path, lambda **k_: batch_step(**k_), dict(
            groups_d=groups_d, out=out_d, bucket=bucket, use_pallas=use_pallas, tol=tol),
            frames=1 if bucket == "pad_exact" else 3,
            into=None if bucket == "pad_exact" else loop_profiles, brief=True)
        row = dict(ms_per_step=ms, mean_ms=sum(ms) / len(ms), first_call_s=call_s,
                   groups=len(groups_d), jobs=sum(len(p_[1]) for p_ in groups_d),
                   launches_per_call={k: v for k, v in launches.items() if v},
                   diff_max_vs_cpu=d_cpu, busy_us=prof["busy_us"], span_us=prof["span_us"],
                   idle=prof["idle"], torch_op_launches=prof.get("torch_op_launches"),
                   gemms=prof["gemms"])
        print(f"{path} ({card}): step {row['mean_ms']:.4f} ms ({[round(x, 4) for x in ms]}), "
              f"{row['groups']} group(s) of {row['jobs']} jobs, busy {row['busy_us']:.1f} us "
              f"of a {row['span_us']:.1f} us span, idle share {row['idle']}, torch-op "
              f"launches {row['torch_op_launches']}, GEMMs {row['gemms']} a step; launches a "
              f"call {row['launches_per_call']}; first call {call_s:.2f} s; card vs cpu "
              f"diff_max {d_cpu}")
        batch_rows[path] = row
        return out, row

    # batch_64_4k: 64 seeded 136 x 136 patches, ellipses of tight bbox 128 x 128
    # (one "exact" group), no overlap, on the plain route and on the kernels
    srcs64 = [synthetic_image(rng_6, BATCH_PATCH) for _ in cells]
    masks64 = [ellipse_mask(rng_6, BATCH_PATCH, BATCH_BBOX, jitter=0) for _ in cells]
    seq64 = TA.seamless_clone_batch(srcs64, dst4k, masks64, cells)
    for path, use_pallas in (("batch_64_4k", False), ("batch_64_4k_pallas", True)):
        out64, row = drive_batch(path, srcs64, masks64, cells, use_pallas=use_pallas)
        row["diff_max_vs_sequential"] = diff_max(out64, seq64)
        print(f"{path} ({card}): diff_max against 64 sequential seamless_clone calls on the "
              f"card {row['diff_max_vs_sequential']}")
        if row["diff_max_vs_sequential"] > 1 or row["groups"] != 1:
            raise AssertionError(f"{path}: {row}")
    del seq64

    # batch_mixed_4k: seeded tight sides in MIXED_SIDES; MIXED_OVERLAPS jobs
    # moved toward their right neighbour, so each such pair overlaps
    sides = rng_6.integers(MIXED_SIDES[0], MIXED_SIDES[1] + 1, (len(cells), 2))
    srcs_m = [synthetic_image(rng_6, (int(h_) + 8, int(w_) + 8)) for h_, w_ in sides]
    masks_m = [ellipse_mask(rng_6, s_.shape[:2], (int(h_), int(w_)), jitter=0)
               for s_, (h_, w_) in zip(srcs_m, sides)]
    shifted = [gx_ * k + k % (gx_ - 1) for k in range(MIXED_OVERLAPS)]
    centers_m = [(x_ + MIXED_SHIFT, y_) if i in shifted else (x_, y_)
                 for i, (x_, y_) in enumerate(cells)]
    pairs = [(i, i + 1) for i in shifted]

    def tight_window(i):
        """(top, left, h, w) of job i's tight ROI in the destination."""
        h_, w_ = (int(v) for v in sides[i])
        return centers_m[i][1] - h_ // 2, centers_m[i][0] - w_ // 2, h_, w_

    for a, b in pairs:
        (ta, la, ha, wa), (tb, lb, hb, wb) = tight_window(a), tight_window(b)
        if not (la < lb + wb and lb < la + wa and ta < tb + hb and tb < ta + ha):
            raise AssertionError(f"batch_mixed_4k: jobs {a} and {b} do not overlap")

    def check_later_window(path, out, bucket, jobs_):
        """In each overlap, the destination holds the later job's whole window
        (composite order: group order, then job order). Its ring is the
        destination as its group found it (the original, in one group:
        every window is gathered before any paste) exactly, and the window
        is within 1 of that job's step run alone on the same destination
        (bit-equal with pad_exact, whose jobs solve one by one)."""
        plan = TB.plan_groups(dst4k.shape, [srcs_m[i] for i in jobs_],
                              [masks_m[i] for i in jobs_], [centers_m[i] for i in jobs_], bucket,
                              device=dev)
        order = sorted(range(len(jobs_)), key=lambda i: (tuple(sides[jobs_[i]]), i)) \
            if bucket == "exact" else list(range(len(jobs_)))
        where, k = {}, 0  # job -> (group, index in it)
        for gi, (hw_, s_, *_rest) in enumerate(plan):
            for j in range(len(s_)):
                job = jobs_[order[k]]
                if bucket == "exact" and tuple(hw_) != tuple(int(v) for v in sides[job]):
                    raise AssertionError(f"{path}: group {hw_} holds job {job} of {sides[job]}")
                where[job] = (gi, j)
                k += 1
        worst = 0
        for a, b in pairs:
            if a not in where or b not in where:
                continue
            later = max((a, b), key=lambda i: where[i])
            gi, j = where[later]
            (bh_, bw_), s_, m_, l_, t_ = plan[gi]
            lf, tp = (int(v) for v in l_[j])
            base = batch_step(plan[:gi], torch.from_numpy(dst4k).to(dev), bucket, False, TOL)
            alone = batch_step([((bh_, bw_), s_[j : j + 1], m_[j : j + 1], l_[j : j + 1],
                                 t_[j : j + 1])], base, bucket, False, TOL)
            alone, base = alone.cpu().numpy(), base.cpu().numpy()
            win, ref = out[tp : tp + bh_, lf : lf + bw_], alone[tp : tp + bh_, lf : lf + bw_]
            before = base[tp : tp + bh_, lf : lf + bw_]
            ring = np.ones((bh_, bw_), bool)
            ring[1:-1, 1:-1] = False
            if not np.array_equal(win[ring], before[ring]):
                raise AssertionError(f"{path}: job {later}'s window ring is not the destination "
                                     "its group found")
            d = diff_max(win, ref)
            worst = max(worst, d)
            if d > (0 if bucket == "pad_exact" else 1):
                raise AssertionError(f"{path}: job {later}'s window is {d} from its own step")
        return worst

    mixed_jobs = list(range(len(cells)))
    for bucket in ("exact", "pad", "pad_exact"):
        path = f"batch_mixed_4k_{bucket}"
        jobs_ = mixed_jobs
        if bucket == "pad_exact":
            t0 = time.perf_counter()
            TB.seamless_clone_batch_fused(dst4k, srcs_m, masks_m, centers_m, bucket=bucket)
            pad_exact_s = time.perf_counter() - t0
            if PAD_EXACT_CALLS * pad_exact_s > PAD_EXACT_LIMIT_S:
                jobs_ = mixed_jobs[:16]
                print(f"{path} ({card}): a 64-job call took {pad_exact_s:.2f} s, the phase "
                      f"would take over {PAD_EXACT_LIMIT_S} s: it runs on the first 16 jobs")
            pe_call_64_s = pad_exact_s
        out_m, row = drive_batch(path, [srcs_m[i] for i in jobs_], [masks_m[i] for i in jobs_],
                                 [centers_m[i] for i in jobs_], bucket=bucket,
                                 steps=2 if bucket == "pad_exact" else BATCH_STEPS)
        launches = path_launches[path][0]
        if bucket == "exact" and launches != _per_frame(clamp_cast_paste=row["groups"]):
            raise AssertionError(f"{path}: launches {launches}, {row['groups']} groups")
        if bucket == "pad_exact" and launches != _per_frame(
                erode3=len(jobs_), preprocess_rhs_p=len(jobs_), clamp_cast_paste=len(jobs_)):
            raise AssertionError(f"{path}: launches {launches} for {len(jobs_)} jobs")
        row["later_window_diff_max"] = check_later_window(path, out_m, bucket, jobs_)
        row["jobs_run"] = len(jobs_)
        if bucket == "pad_exact":
            row["call_s_64_jobs"] = pe_call_64_s
        print(f"{path} ({card}): in each overlap the later job's whole window, its ring the "
              f"destination its group found; diff_max against its own step "
              f"{row['later_window_diff_max']}")

    # pad_exact at tol MIXED_EXACT_TOL against sequential seamless_clone calls,
    # on the jobs that overlap none
    jobs_ = list(range(batch_rows["batch_mixed_4k_pad_exact"]["jobs_run"]))
    pick = lambda xs: [xs[i] for i in jobs_]  # noqa: E731
    tight_pe = TB.seamless_clone_batch_fused(dst4k, pick(srcs_m), pick(masks_m),
                                             pick(centers_m), bucket="pad_exact",
                                             tol=MIXED_EXACT_TOL)
    seq_m = TA.seamless_clone_batch(pick(srcs_m), dst4k, pick(masks_m), pick(centers_m))
    alone_jobs = [i for i in jobs_ if not any(i in p_ for p_ in pairs)]
    d_seq = 0
    for i in alone_jobs:
        tp, lf, h_, w_ = tight_window(i)
        d_seq = max(d_seq, diff_max(tight_pe[tp : tp + h_, lf : lf + w_],
                                    seq_m[tp : tp + h_, lf : lf + w_]))
    batch_rows["batch_mixed_4k_pad_exact"]["diff_max_vs_sequential_tol_1e-6"] = d_seq
    print(f"batch_mixed_4k_pad_exact at tol {MIXED_EXACT_TOL} ({card}): diff_max against "
          f"sequential seamless_clone calls over the {len(alone_jobs)} jobs that overlap none "
          f"{d_seq}")
    if d_seq > 1:
        raise AssertionError(f"pad_exact against the sequential calls: diff_max {d_seq}")
    del tight_pe, seq_m
    print(json.dumps({"batch_paths": batch_rows}))

    # the edits: 1080p on the direct DST-GEMM route
    img1080 = synthetic_image(rng_6, EDIT_1080P)
    mask1080 = ellipse_mask(rng_6, EDIT_1080P, EDIT_BBOX_1080P)
    img4k = synthetic_image(rng_6, DST_4K)
    mask4k = ellipse_mask(rng_6, DST_4K, EDIT_BBOX_4K)
    red, green, blue = EDIT_FACTORS

    def drive_edit(path, fn, img, mask_, args, cpu=True):
        """One call with the counters around it, a warm-up and EDIT_CALLS calls
        timed with CUDA events (the device tensor returned), a 3-call profile,
        and the card against the CPU (diff_max <= 1). Returns (image,
        launches, row)."""
        out, launches = launches_of(lambda: fn(img, mask_, *args))
        path_launches.setdefault(path, (launches, launches))
        if PATHS[path] is not None:
            check_counts(path, "call", launches, 1, 0)
        ms = event_ms(lambda: fn(img, mask_, *args, to_numpy=False), EDIT_CALLS)
        prof = profile_frames(path, lambda: fn(img, mask_, *args, to_numpy=False), {},
                              frames=3, into=loop_profiles, brief=True)
        row = dict(ms_per_call=ms, mean_ms=sum(ms) / len(ms),
                   launches_per_call={k: v for k, v in launches.items() if v},
                   busy_us=prof["busy_us"], span_us=prof["span_us"], idle=prof["idle"],
                   torch_op_launches=prof.get("torch_op_launches"), gemms=prof["gemms"])
        if cpu:
            row["diff_max_vs_cpu"] = diff_max(out, fn(img, mask_, *args, device="cpu"))
            cpu_diffs[path] = row["diff_max_vs_cpu"]
            if row["diff_max_vs_cpu"] > 1:
                raise AssertionError(f"{path}: card against CPU diff_max {row}")
        if out.shape != img.shape or np.array_equal(out, img):
            raise AssertionError(f"{path}: output {out.shape} unchanged or misshapen")
        edit_rows[path] = row
        print(f"{path} ({card}): {row['mean_ms']:.4f} ms a call "
              f"({[round(x, 4) for x in ms]}), busy {row['busy_us']:.1f} us of a "
              f"{row['span_us']:.1f} us span, idle share {row['idle']}, torch-op launches "
              f"{row['torch_op_launches']}, GEMMs {row['gemms']}; launches a call "
              f"{row['launches_per_call']}" + (f"; card vs cpu diff_max "
                                               f"{row['diff_max_vs_cpu']}" if cpu else ""))
        return out, launches, row

    drive_edit("edit_color_1080p", TA.color_change, img1080, mask1080, (red, green, blue))
    masked1080 = np.where(mask1080[..., None] != 0, img1080, 0).astype(np.uint8)
    t0 = time.perf_counter()
    edges1080 = canny(masked1080, 30, 45, 3)
    canny_ms = (time.perf_counter() - t0) * 1e3
    _, _, row = drive_edit("edit_texture_1080p", TA.texture_flattening, img1080, mask1080,
                           (30, 45, 3))
    row["host_canny_ms"] = canny_ms
    row["edge_pixels"] = int((edges1080 != 0).sum())
    print(f"edit_texture_1080p ({card}): the host Canny of the masked source {canny_ms:.1f} ms "
          f"({row['edge_pixels']} edge pixels), inside each call's time")

    # the edits at 4K: 3838 x 2158 = 8.28 MP interior, above the crossover: the
    # "q" chain on the dense RHS, to tol 1e-5; cycles against the solve's report
    h4, w4 = DST_4K[0] - 2, DST_4K[1] - 2
    levels4 = len(TM.q_coarse_levels(h4, w4))
    if not TM.quarter_path_applies(h4, w4):
        raise AssertionError("the 4K interior is not a quarter-plane grid")
    for path, fn, args, kind, params in (
            ("edit_color_4k", TA.color_change, (red, green, blue), TE.COLOR_CHANGE,
             (blue, green, red)),
            ("edit_illumination_4k", TA.illumination_change, (0.2, 0.4), TE.ILLUMINATION_CHANGE,
             (0.2, 0.4))):
        _, launches, row = drive_edit(path, fn, img4k, mask4k, args, cpu=False)
        cycles = launches["mg_ud_q"]
        want = _per_frame(to_quarters=1, from_quarters=1, mg_down_q=1, mg_ud_q=cycles,
                          mg_prolong_tq=cycles, clamp_cast_paste=1,
                          **{k: levels4 * cycles for k in MG_KERNELS})
        src_p, me4, params4, _ = TE.edit_inputs(img4k, mask4k, params, None, dev)
        src_f = src_p.float()
        gx4, gy4 = TE.edit_guidance(src_f, me4, params4, None, kind=kind)
        g4 = poisson_rhs(gx4, gy4, src_f)
        u4, info4 = TM.solve_multigrid(g4, tol=EDIT_TOL, padded="q", use_pallas=True,
                                       return_info=True)
        rel4 = info4["residual"] / g4.abs().max().item()
        rel4_64 = rel_residual(u4, g4)
        row.update(cycles=cycles, solve_cycles=info4["cycles"], rel_residual=rel4,
                   rel_residual_f64=rel4_64, coarse_levels=levels4)
        print(f"{path} ({card}): {cycles} cycles (mg_ud_q launches), the solve of its RHS "
              f"{info4['cycles']}; relative residual {rel4:.3e} (float64 {rel4_64:.3e}, tol "
              f"{EDIT_TOL}); {levels4} fused coarse levels")
        if launches != want or cycles != info4["cycles"] or not rel4 <= EDIT_TOL:
            raise AssertionError(f"{path}: launches {launches}, expected {want}; {info4}")
        del src_p, src_f, me4, gx4, gy4, g4, u4

    # the tiled edit: local_edit_tiled of the colour change on a 2x2 mesh of the card
    mesh_e = make_tile_mesh([torch.device("cuda")] * DD_TILES, DD_MESH)
    col1080 = TA.color_change(img1080, mask1080, red, green, blue)
    t0 = time.perf_counter()
    tiled, launches = launches_of(lambda: local_edit_tiled(
        img1080, mask1080, TE.COLOR_CHANGE, (blue, green, red), mesh=mesh_e))
    tiled_s = time.perf_counter() - t0
    path_launches.setdefault("edit_tiled", (launches, launches))
    n_dd, rem = divmod(launches["rb_sweeps_tile"], 2 * DD_TILES)
    if (rem or not n_dd or launches["mg_down"] != launches["mg_up"] or launches != _per_frame(
            clamp_cast_paste=DD_TILES, rb_sweeps_tile=launches["rb_sweeps_tile"],
            mg_down=launches["mg_down"], mg_up=launches["mg_up"])):
        raise AssertionError(f"edit_tiled: launches {launches}")
    prof = profile_frames("edit_tiled", lambda: local_edit_tiled(
        img1080, mask1080, TE.COLOR_CHANGE, (blue, green, red), mesh=mesh_e), {}, frames=1,
        into=loop_profiles, brief=True)
    d_tiled = diff_max(tiled, col1080)
    edit_rows["edit_tiled"] = dict(
        first_call_s=tiled_s, cycles=n_dd, launches_per_call={k: v for k, v in launches.items()
                                                              if v},
        diff_max_vs_color_change=d_tiled, busy_us=prof["busy_us"], span_us=prof["span_us"],
        idle=prof["idle"], torch_op_launches=prof.get("torch_op_launches"))
    print(f"edit_tiled ({card}): local_edit_tiled on a 2x2 mesh of the card, {n_dd} DD cycles, "
          f"rb_sweeps_tile {launches['rb_sweeps_tile']} launches, {tiled_s:.2f} s the first "
          f"call, a profiled call {prof['span_us'] / 1e3:.1f} ms; diff_max against color_change "
          f"on the card {d_tiled}")
    if d_tiled > 1:
        raise AssertionError(f"edit_tiled: diff_max {d_tiled} against color_change")
    del col1080, tiled
    print(json.dumps({"edit_paths": edit_rows}))
    print(f"the slice-6 phases ran {time.perf_counter() - t_6:.1f} s")

    # -- slice 7: the CLI, the compare harness and the C ABI at the headline
    #    (the seeded headline src / dst / full mask of the pair frame) --------
    import ctypes
    import io
    import os
    import tempfile

    from seamlesscloneoptimization_tpu_torch import capi_host, native
    from seamlesscloneoptimization_tpu_torch import cli as TCLI
    from seamlesscloneoptimization_tpu_torch import compare as TCMP

    t_7 = time.perf_counter()
    surface = {}
    want = SeamlessClone(CloneConfig(), device=dev).run(src, dst, mask, center).cpu().numpy()
    cpu_want = cpu_outputs["pair"]
    root = Path(__file__).resolve().parent

    @contextlib.contextmanager
    def io_timed(into: dict):
        """native's YAML reads and writes timed, seconds by function name."""
        saved = {f: getattr(native, f) for f in ("read_yaml_mat", "write_yaml_mat")}

        def timed(f):
            def call(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return saved[f](*a, **kw)
                finally:
                    into.setdefault(f, []).append(time.perf_counter() - t0)
            return call

        for f in saved:
            setattr(native, f, timed(f))
        try:
            yield into
        finally:
            for f, fn in saved.items():
                setattr(native, f, fn)

    def captured(fn, *a) -> tuple[int, list[str]]:
        """fn(*a)'s return code and its printed lines, each printed again."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(*a)
        lines = buf.getvalue().splitlines()
        for ln in lines:
            print(f"  | {ln}")
        return rc, lines

    with tempfile.TemporaryDirectory(prefix="chip_smoke_slice7_") as tmp_s:
        tmp = Path(tmp_s)
        inputs = []
        writes = {}
        with io_timed(writes):
            for name, a in (("src", src), ("dst", dst), ("mask", mask)):
                native.write_yaml_mat(tmp / f"{name}.yml", a, name=name)
                inputs.append(str(tmp / f"{name}.yml"))
        argv = [*inputs, str(center[0]), str(center[1]), "0"]
        print(f"cli_headline ({card}): inputs written as YAML in "
              f"{[round(t, 3) for t in writes['write_yaml_mat']]} s (src {src.size}, dst "
              f"{dst.size}, mask {mask.size} values; "
              f"{[os.path.getsize(p) for p in inputs]} bytes)")

        # cli_headline: the CLI in this process, one warm-up and CLI_LOOPS runs
        cli_io = {}
        K.reset_launches()
        t0 = time.perf_counter()
        with io_timed(cli_io):
            rc, lines = captured(TCLI.main, argv + ["--loops", str(CLI_LOOPS), "--output-dir",
                                                    str(tmp / "cli")])
        cli_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"cli_headline: the CLI returned {rc}")
        check_counts("cli_headline", f"CLI (1 + {CLI_LOOPS} runs)", launches, 1 + CLI_LOOPS,
                     1 + CLI_LOOPS)
        path_launches.setdefault("cli_headline", (launches, launches))
        image = native.read_bmp(tmp / "cli" / "ucRGB_Output.bmp")
        result = native.read_yaml_mat(tmp / "cli" / "result.yml")
        if not (np.array_equal(image, want) and np.array_equal(result, want)):
            raise AssertionError(f"cli_headline: the CLI's BMP / result.yml differ from the "
                                 f"engine's run: diff_max {diff_max(image, want)}, "
                                 f"{diff_max(result, want)}")
        d_cpu = diff_max(image, cpu_want)
        cpu_diffs["cli_headline"] = d_cpu
        if d_cpu > 1:
            raise AssertionError(f"cli_headline: diff_max {d_cpu} against the CPU path")
        compute = next(ln for ln in lines if ln.startswith("Compute stage performance time="))
        cli_ms = float(compute.split("time=")[1].split()[0])
        surface["cli_headline"] = dict(
            compute_ms=cli_ms, loops=CLI_LOOPS, cli_s=cli_s, read_yaml_s=cli_io["read_yaml_mat"],
            write_yaml_s=cli_io["write_yaml_mat"], input_write_yaml_s=writes["write_yaml_mat"],
            launches={k: v for k, v in launches.items() if v}, diff_max_vs_cpu=d_cpu)
        print(f"cli_headline ({card}): compute {cli_ms:.3f} ms a run over {CLI_LOOPS} runs; "
              f"YAML reads {[round(t, 3) for t in cli_io['read_yaml_mat']]} s (src, dst, mask), "
              f"result.yml write {cli_io['write_yaml_mat'][0]:.3f} s; the whole CLI "
              f"{cli_s:.2f} s; BMP and result.yml bit-equal to the engine's run, diff_max "
              f"{d_cpu} against the CPU path; launches {json.dumps(surface['cli_headline']['launches'])}")

        # cli_compare: compare.main on the CLI's BMP against the engine's image
        native.write_bmp(tmp / "engine.bmp", want)
        rc, lines = captured(TCMP.main, [str(tmp / "cli" / "ucRGB_Output.bmp"),
                                         str(tmp / "engine.bmp")])
        stats = {k: float(v) for k, v in (ln.split(": ") for ln in lines)}
        if rc != 0 or len(stats) != 5 or any(stats.values()):
            raise AssertionError(f"cli_compare: rc {rc}, statistics {stats}, expected all 0")
        # --debug-dump on the card; its g0.yml against the CPU path's
        dbg_io = {}
        t0 = time.perf_counter()
        with io_timed(dbg_io):
            rc, _ = captured(TCLI.main, argv + ["--debug-dump", "--output-dir",
                                                str(tmp / "dbg")])
        dbg_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli_compare: the CLI with --debug-dump returned {rc}")
        t0 = time.perf_counter()
        SeamlessClone(CloneConfig(debug_dir=str(tmp / "dbg_cpu")), device="cpu").dump_stages(
            src, dst, mask, center)
        cpu_dump_s = time.perf_counter() - t0
        rc, lines = captured(TCMP.main, ["--yaml", str(tmp / "dbg" / "debug" / "g0.yml"),
                                         str(tmp / "dbg_cpu" / "g0.yml")])
        stage = {k: float(v) for k, v in (ln.split(": ") for ln in lines)}
        if rc != 0 or not stage["abs_max"] <= STAGE_ABS_TOL:
            raise AssertionError(f"cli_compare: g0.yml card vs CPU {stage}, tolerance "
                                 f"{STAGE_ABS_TOL}")
        surface["cli_compare"] = dict(image_stats=stats, g0_card_vs_cpu=stage,
                                      debug_cli_s=dbg_s, debug_write_yaml_s=dbg_io[
                                          "write_yaml_mat"], cpu_dump_stages_s=cpu_dump_s)
        print(f"cli_compare ({card}): the CLI's BMP against the engine's, every statistic 0; "
              f"--debug-dump g0.yml card vs CPU abs_max {stage['abs_max']:.3e} rel_max "
              f"{stage['rel_max']:.3e} (tolerance {STAGE_ABS_TOL}); the --debug-dump CLI "
              f"{dbg_s:.2f} s, its YAML writes {[round(t, 3) for t in dbg_io['write_yaml_mat']]} "
              f"s (result, mask_eroded, g0, g1, g2); the CPU's dump_stages {cpu_dump_s:.2f} s")

        # capi_headline: the library and the C program, built here
        t0 = time.perf_counter()
        lib = capi_host.build_library()
        lib_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        prog = capi_host.build_test_program()
        prog_s = time.perf_counter() - t0
        print(f"capi_headline: built {lib.name} in {lib_s:.2f} s, {prog.name} in {prog_s:.2f} s")
        for name, a in (("face", src), ("body", dst), ("mask", mask)):
            a.tofile(tmp / f"{name}.raw")
        cmd = [str(prog), str(tmp / "face.raw"), *map(str, SRC_HW), str(tmp / "body.raw"),
               *map(str, DST_HW), str(tmp / "mask.raw"), *map(str, center), "0", "",
               str(tmp / "out1.raw"), str(tmp / "out2.raw")]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                           env=dict(os.environ, SC_TPU_PYTHONPATH=capi_host.embedded_path(root)))
        prog_run_s = time.perf_counter() - t0
        for ln in (r.stdout + r.stderr).splitlines():
            print(f"  | {ln}")
        if r.returncode != 0:
            raise AssertionError(f"capi_headline: the C program exited {r.returncode}")
        outs = [np.fromfile(tmp / f, np.uint8).reshape(want.shape)
                for f in ("out1.raw", "out2.raw")]
        if not all(np.array_equal(o, want) for o in outs):
            raise AssertionError("capi_headline: the C program's outputs differ from the "
                                 f"engine's run: diff_max {[diff_max(o, want) for o in outs]}")
        d_cpu = max(diff_max(o, cpu_want) for o in outs)
        cpu_diffs["capi_headline"] = d_cpu
        if d_cpu > 1:
            raise AssertionError(f"capi_headline: diff_max {d_cpu} against the CPU path")
        prog_ms = {ln.split(":")[0]: float(ln.split(": ")[1].split()[0])
                   for ln in r.stdout.splitlines() if ln.endswith(" ms")}
        # one sc_tpu_run in this process through ctypes (the interpreter is
        # already up: the library only takes the GIL), its launches counted
        cdll = ctypes.CDLL(str(lib))
        cdll.sc_tpu_create_instance.restype = ctypes.c_void_p
        cdll.sc_tpu_create_instance.argtypes = [ctypes.c_int, ctypes.c_char_p]
        cdll.sc_tpu_run.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        cdll.sc_tpu_destroy.argtypes = [ctypes.c_void_p]
        cdll.sc_tpu_last_error.restype = ctypes.c_char_p
        inst = cdll.sc_tpu_create_instance(0, b"")
        if not inst:
            raise AssertionError(f"capi_headline: {cdll.sc_tpu_last_error().decode()}")
        out_abi = np.empty_like(dst)
        face_b, body_b, mask_b = src.tobytes(), dst.tobytes(), mask.tobytes()

        def abi_run():
            return cdll.sc_tpu_run(inst, face_b, *SRC_HW, body_b, *DST_HW, mask_b, *SRC_HW,
                                   *center, out_abi.ctypes.data, 1)

        abi_run()  # warm-up: the engine's DST bases
        K.reset_launches()
        t0 = time.perf_counter()
        rc = abi_run()
        abi_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(K.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"capi_headline: sc_tpu_run: {cdll.sc_tpu_last_error().decode()}")
        check_counts("capi_headline", "in-process sc_tpu_run", launches, 1, 1)
        path_launches.setdefault("capi_headline", (launches, launches))
        abi_run_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            rc = abi_run() or rc
            abi_run_ms.append((time.perf_counter() - t0) * 1e3)
        cdll.sc_tpu_destroy(inst)
        if rc != 0:
            raise AssertionError(f"capi_headline: sc_tpu_run: {cdll.sc_tpu_last_error().decode()}")
        if not np.array_equal(out_abi, want):
            raise AssertionError(f"capi_headline: the in-process run differs from the engine's, "
                                 f"diff_max {diff_max(out_abi, want)}")
        surface["capi_headline"] = dict(
            build_library_s=lib_s, build_program_s=prog_s, program_s=prog_run_s,
            program_ms=prog_ms, in_process_run_ms=[abi_ms, *abi_run_ms],
            launches={k: v for k, v in launches.items() if v}, diff_max_vs_cpu=d_cpu)
        print(f"capi_headline ({card}): the C program's two runs (main thread, another pthread) "
              f"bit-equal to the engine's run, diff_max {d_cpu} against the CPU path; the "
              f"program {prog_run_s:.2f} s in all; in this process sc_tpu_run (upload, clone, "
              f"the result copied into out, sync) {abi_ms:.2f} ms, then "
              f"{[round(t, 2) for t in abi_run_ms]} ms; launches "
              f"{json.dumps(surface['capi_headline']['launches'])}")
    print(json.dumps({"surface_paths": surface}))
    print(f"the slice-7 phases ran {time.perf_counter() - t_7:.1f} s")

    # -- slice 8: path="gspmd" (solve_multigrid_sharded, the element V-cycle
    #    partitioned over the mesh) at 8K on the 2x2 mesh of the card, its
    #    mg_cycles=4 form, the gspmd edit at 1080p, and two processes on the
    #    card joined by init_distributed over gloo --------------------------------
    import tempfile

    from seamlesscloneoptimization_tpu_torch.parallel import dist_check, solve_multigrid_sharded
    from seamlesscloneoptimization_tpu_torch.parallel import tiled as TT

    t_8 = time.perf_counter()
    slice8 = {}

    def gspmd_engine(cfg):
        return lambda device: TiledSeamlessClone(
            cfg, mesh=make_tile_mesh([torch.device(device)] * DD_TILES, DD_MESH), path="gspmd")

    def timed_solve(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    g8 = _plain_rhs(dest8, patch8, mask8_roi, 1, "opencv")[0]
    g8max = g8.abs().max().item()
    lv = TT._Level(*g8.shape[1:], 1.0, 1.0, TT._split(g8.shape[1], DD_MESH[0]),
                   TT._split(g8.shape[2], DD_MESH[1]))
    gs_levels = []
    while lv.sharded:
        gs_levels.append([lv.h, lv.w, lv.bh, lv.bw, min(b - a for a, b in zip(lv.rows,
                                                                             lv.rows[1:]))])
        lv = lv.coarser()
    if sum(1 for x in gs_levels if x[2] == x[3] == 1.0) != GSPMD_PLAIN_LEVELS:
        raise AssertionError(f"tiled_gspmd: partitioned levels {gs_levels}")
    for path, cfg, label in (("tiled_gspmd", CloneConfig(tol=TOL), "8K"),
                             ("tiled_gspmd_fixed", CloneConfig(tol=TOL, mg_cycles=4),
                              "8K, mg_cycles=4")):
        eng_gs, ms = drive(path, cfg, src8, mask8, GSPMD_LOOPS, label, d_img=dst8, cpu=None,
                           solver="multigrid_gspmd", engine=gspmd_engine(cfg), preps=0)
        serve, run = path_launches[path]
        cycles = run["rb_sweeps_tile"] // (2 * DD_TILES * GSPMD_PLAIN_LEVELS)
        want_cycles = cfg.mg_cycles
        (u_gs, info_gs), gs_ms = timed_solve(lambda: solve_multigrid_sharded(
            g8, mesh_c, tol=TOL, cycles=want_cycles, return_info=True))
        (u_el, info_el), el_ms = timed_solve(lambda: TM.solve_multigrid(
            g8, tol=TOL, cycles=want_cycles, use_pallas=False, return_info=True))
        same = torch.equal(u_gs, u_el)
        rel = info_gs["residual"] / g8max
        rel64 = rel_residual(u_gs, g8)
        # slice 8b: the chained frames against the plain RHS, the
        # single-device element solve and the paste; the resident frame profiled
        resident_check(path, eng_gs, GSPMD_LOOPS, lambda g, c=want_cycles: TM.solve_multigrid(
            g, tol=TOL, cycles=c, use_pallas=False), f"{path} 8K")
        prof = resident[path]
        del eng_gs
        slice8[path] = dict(
            ms_per_frame=ms, cycles_run=cycles, cycles_solve=info_gs["cycles"],
            cycles_single_device=info_el["cycles"], bit_equal_single_device=same,
            rel_residual=rel, rel_residual_f64=rel64, solve_ms=gs_ms,
            single_device_element_solve_ms=el_ms,
            launches_per_frame={k: v / (GSPMD_LOOPS + 1) for k, v in serve.items() if v},
            rb_sweeps_tile_per_frame=serve["rb_sweeps_tile"] / (GSPMD_LOOPS + 1),
            busy_us=prof["busy_us"], span_us=prof["span_us"], idle=prof["idle"],
            torch_op_launches=prof.get("torch_op_launches"), levels=gs_levels)
        print(f"{path} ({card}): 2x2 mesh of one card, partitioned levels (h, w, bh, bw, "
              f"shortest tile side) {gs_levels}; serve {ms:.4f} ms/frame; the single run "
              f"{cycles} cycles, solve_multigrid_sharded {info_gs['cycles']} in {gs_ms:.1f} ms, "
              f"the single-device element solve {info_el['cycles']} in {el_ms:.1f} ms; "
              f"bit-equal {same}; relative residual {rel:.3e} (float64 {rel64:.3e}); "
              f"launches a frame {json.dumps(slice8[path]['launches_per_frame'])}")
        if (not same or not cycles == info_gs["cycles"] == info_el["cycles"]
                or (want_cycles is None and not rel <= TOL)
                or not torch.isfinite(u_gs).all()):
            raise AssertionError(f"{path}: {slice8[path]}")
        del u_gs, u_el

    # the gspmd edit at 1080p, within 1 of the DD path's edit
    ed_gs, launches = launches_of(lambda: local_edit_tiled(
        img1080, mask1080, TE.COLOR_CHANGE, (blue, green, red), mesh=mesh_e, path="gspmd"))
    path_launches["edit_tiled_gspmd"] = (launches, launches)
    n_gs = check_gspmd_counts("edit_tiled_gspmd", "call (1080p)", launches, 1)
    _, ed_ms = timed_solve(lambda: local_edit_tiled(
        img1080, mask1080, TE.COLOR_CHANGE, (blue, green, red), mesh=mesh_e, path="gspmd"))
    ed_dd = local_edit_tiled(img1080, mask1080, TE.COLOR_CHANGE, (blue, green, red),
                             mesh=mesh_e)
    d_ed = diff_max(ed_gs, ed_dd)
    prof = profile_frames("edit_tiled_gspmd", lambda: local_edit_tiled(
        img1080, mask1080, TE.COLOR_CHANGE, (blue, green, red), mesh=mesh_e, path="gspmd"),
        {}, frames=1, into=loop_profiles, brief=True)
    slice8["edit_tiled_gspmd"] = dict(
        call_ms=ed_ms, cycles=n_gs, launches_per_call={k: v for k, v in launches.items() if v},
        diff_max_vs_dd=d_ed, busy_us=prof["busy_us"], span_us=prof["span_us"],
        idle=prof["idle"], torch_op_launches=prof.get("torch_op_launches"))
    print(f"edit_tiled_gspmd ({card}): local_edit_tiled(path='gspmd') on a 2x2 mesh of the "
          f"card at 1080p, {n_gs} cycles, {ed_ms:.1f} ms a call (host clock); diff_max against "
          f"the DD path's edit {d_ed}")
    if d_ed > 1:
        raise AssertionError(f"edit_tiled_gspmd: diff_max {d_ed} against the DD path's edit")
    del ed_gs, ed_dd

    # two processes on the card, two tiles each, joined by init_distributed
    # (gloo: the processes share the card), against the single-process 2x2 mesh
    (u_dd1, info_dd1), dd1_ms = timed_solve(lambda: solve_poisson_dd(
        g8, mesh_c, tol=TOL, return_info=True))
    (u_gs1, info_gs1), gs1_ms = timed_solve(lambda: solve_multigrid_sharded(
        g8, mesh_c, tol=TOL, return_info=True))
    g8c = g8.cpu()
    # slice 8b: the same two processes also serve the mesh-resident engine at
    # 8K (timed_serve), held against the one-process 2x2 resident engine
    eng_run = {"args": tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        src8, dst8, mask8)) + (ctr8,), "config": {"tol": TOL}, "loops": DIST_ENGINE_LOOPS}
    (want_e, info_e1), e1_ms = timed_solve(lambda: dist_check.run_one("engine", eng_run, mesh_c,
                                                                      dev))
    # slice 8c: solve_redblack_tiled in both schedules on the 8K RHS at a
    # fixed count and for one round (the overlap round profiled in each rank)
    rb_kw = dict(tol=0.0, max_iters=DIST_RB_SWEEPS, halo=RB_TILED_HALO)
    round_kw = dict(tol=0.0, max_iters=RB_TILED_HALO // 2, check_every=RB_TILED_HALO // 2,
                    halo=RB_TILED_HALO)
    (u_rbp1, info_rbp1), rbp1_ms = timed_solve(lambda: solve_redblack_tiled(
        g8, mesh_c, return_info=True, **rb_kw))
    (u_rbo1, _), rbo1_ms = timed_solve(lambda: solve_redblack_tiled(
        g8, mesh_c, overlap=True, return_info=True, **rb_kw))
    if not torch.equal(u_rbp1, u_rbo1):
        raise AssertionError("dist_2proc: the one-process schedules differ at 8K")
    dist_runs = {"dd": {"g": g8c, "kwargs": {"tol": TOL}},
                 "sharded": {"g": g8c, "kwargs": {"tol": TOL}}, "engine": eng_run,
                 "rb_plain": {"g": g8c, "kwargs": rb_kw},
                 "rb_overlap": {"g": g8c, "kwargs": {**rb_kw, "overlap": True}},
                 "rb_plain_round": {"g": g8c, "kwargs": round_kw},
                 "rb_overlap_round": {"g": g8c, "kwargs": {**round_kw, "overlap": True},
                                      "profile": True}}
    u_round = solve_redblack_tiled(g8, mesh_c, **round_kw).cpu()
    expect = {"dd": u_dd1.cpu(), "sharded": u_gs1.cpu(), "engine": want_e,
              "rb_plain": u_rbp1.cpu(), "rb_overlap": u_rbp1.cpu(),
              "rb_plain_round": u_round, "rb_overlap_round": u_round}
    del u_dd1, u_gs1, want_e, u_rbp1, u_rbo1
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dist_runs, f"{tmp}/in.pt")
        torch.save(expect, f"{tmp}/expect.pt")
        t0 = time.perf_counter()
        ranks = dist_check.spawn(DIST_WORLD, [
            "--device", "cuda", "--tiles", str(DD_TILES // DIST_WORLD), "--shape",
            *map(str, DD_MESH), "--input", f"{tmp}/in.pt", "--expect", f"{tmp}/expect.pt",
            "--repeat", "2"], DIST_TIMEOUT)
        dist_s = time.perf_counter() - t0
    del dist_runs, expect, g8c, eng_run
    if any(rc != 0 for rc, _ in ranks):
        raise AssertionError("dist_2proc: a rank failed:\n" + "\n---\n".join(
            out[-3000:] for _, out in ranks))
    reports = [dist_check.report_of(out) for _, out in ranks]
    slice8["dist_2proc"] = dict(wall_s=dist_s, single_process_ms={
        "dd": dd1_ms, "sharded": gs1_ms, "rb_plain": rbp1_ms, "rb_overlap": rbo1_ms},
                                single_process_cycles={"dd": info_dd1["cycles"],
                                                       "sharded": info_gs1["cycles"]},
                                ranks=reports)
    for rep in reports:
        for name in ("dd", "sharded"):
            row = rep["solves"][name]
            print(f"dist_2proc rank {rep['rank']} ({card}, backend {rep['backend']}, cells "
                  f"{rep['cells']}): {name} {row['ms']:.1f} ms a solve (the second run; "
                  f"single process {slice8['dist_2proc']['single_process_ms'][name]:.1f}), "
                  f"{row['cycles']} cycles, bit-equal to the single-process 2x2 mesh "
                  f"{row['equal']}; crossing to the other rank a cycle "
                  f"{row['crossed_transfers_per_step']:.1f} transfers, "
                  f"{row['crossed_bytes_per_step'] / 1e6:.3f} MB; rb_sweeps_tile "
                  f"{row['rb_sweeps_tile']}")
    for rep in reports:
        for name in ("rb_plain", "rb_overlap"):
            row, one = rep["solves"][name], rep["solves"][f"{name}_round"]
            row["ms_per_sweep_past_round"] = (row["ms"] - one["ms"]) / (
                row["iterations"] - one["iterations"])
            print(f"dist_2proc rank {rep['rank']} ({card}, backend {rep['backend']}): {name} "
                  f"{row['ms']:.1f} ms a solve of {row['iterations']} sweeps, halo "
                  f"{RB_TILED_HALO} (the second run; single process "
                  f"{slice8['dist_2proc']['single_process_ms'][name]:.1f}), one round "
                  f"{one['ms']:.1f}: {row['ms_per_sweep_past_round']:.4f} ms a sweep past it; "
                  f"bit-equal to the single-process 2x2 mesh {row['equal']}, {one['equal']}; "
                  f"rb_sweeps_tile {row['rb_sweeps_tile']}, {one['rb_sweeps_tile']}")
        streams = rep["solves"]["rb_overlap_round"].get("streams", {})
        rb_st, dtoh_st = side_streams(streams, ("DtoH",))
        print(f"dist_2proc rank {rep['rank']} one profiled overlap round ({card}), device ops "
              f"by stream: {json.dumps(streams)}; rb_sweeps_tile on {rb_st}, D2H staging also "
              f"on {dtoh_st}")
        if len(rb_st) != 1 or not dtoh_st:
            raise AssertionError(f"dist_2proc rank {rep['rank']}: the D2H staging is not on a "
                                 f"side stream: {streams}")
    if not all(rep["backend"] == "gloo" and rep["reinit_noop"] and all(
            row["equal"] for row in rep["solves"].values()) for rep in reports):
        raise AssertionError(f"dist_2proc: {reports}")
    print(f"dist_2proc: {DIST_WORLD} processes in {dist_s:.1f} s (start-up, two runs of each "
          f"solve)")
    rows["rb_sweeps_tile"]["dist_2proc_launches_per_rank"] = {
        name: [rep["solves"][name]["rb_sweeps_tile"] for rep in reports]
        for name in ("dd", "sharded", "rb_plain", "rb_overlap")}
    del g8
    print(json.dumps({"slice8_paths": slice8}))
    print(f"the slice-8 phases ran {time.perf_counter() - t_8:.1f} s")

    # -- slice 8b (the mesh-resident frames of tiled_dd(_fixed) and
    #    tiled_gspmd(_fixed) are checked in those phases): bucket_exact's
    #    partitioned dyn solve, the batch's jobs split over the mesh, the
    #    engine across two processes, dryrun_multichip on the 2x2 mesh ------------
    from seamlesscloneoptimization_tpu_torch.parallel import dryrun_multichip
    from seamlesscloneoptimization_tpu_torch.parallel import solve_multigrid_dyn_sharded
    from seamlesscloneoptimization_tpu_torch.solvers.multigrid_dyn import solve_multigrid_dyn

    t_8b = time.perf_counter()
    slice8b = {}

    def plain_levels(h2_, w2_, padded=None):
        """The partitioned levels with betas 1 of a solve on the 2x2 mesh."""
        lv_ = TT._Level(h2_, w2_, 1.0, 1.0, TT._split(h2_, DD_MESH[0]),
                        TT._split(w2_, DD_MESH[1]), padded)
        return sum(1 for x in TT._levels(lv_)[:-1] if x.unit)


    # bucket_exact_tiled: the 8K ellipse in its 128-bucket on the 2x2 mesh
    cfg_bt = CloneConfig(bbox_bucket=BUCKET, bucket_exact=True)
    eng_bt = TiledSeamlessClone(cfg_bt, mesh=mesh_c)
    out_bt, launches = launches_of(lambda: eng_bt.run(src8, dst8, mask_b8, ctr8))
    out_bt = out_bt.cpu().numpy()
    path_launches.setdefault("bucket_exact_tiled", (launches, launches))
    dd_, pp_, mm_ = bucket_roi(src8, mask_b8, dst8, dev, window=True)
    g_bt = _plain_rhs(dd_, pp_, mm_, 1, "opencv")[0]
    _, _, _, (rh_b, rw_b), _ = bucket_prep(src8, mask_b8, dst8)
    hw_bt = tuple(g_bt.shape[1:])
    g_btp = torch.nn.functional.pad(g_bt, (0, rw_b - 2 - hw_bt[1], 0, rh_b - 2 - hw_bt[0]))
    del dd_, pp_, mm_, g_bt
    (u_bs, info_bs), bs_ms = timed_solve(lambda: solve_multigrid_dyn_sharded(
        g_btp, hw_bt, mesh_c, tol=TOL, return_info=True))
    (u_b1, info_b1), b1_ms = timed_solve(lambda: solve_multigrid_dyn(
        g_btp, hw_bt, tol=TOL, use_pallas=False, return_info=True))
    same_solve = torch.equal(u_bs, u_b1) and info_bs == info_b1
    del u_bs, u_b1, g_btp
    bt_levels = plain_levels(*hw_bt, (rh_b - 2, rw_b - 2))
    n_bt, rem = divmod(launches["rb_sweeps_tile"], 2 * DD_TILES * max(bt_levels, 1))
    ref_bt = chained(None, 1, src8, mask_b8, dst8, dyn_kw=dict(
        tol=TOL, cycles=None, max_cycles=60, use_pallas=False))
    same_bt = np.array_equal(out_bt, ref_bt)
    d_bt = diff_max(out_bt, run_outputs["bucket_exact_8k"])
    _, bt_ms = eng_bt.timed_serve(src8, dst8, mask_b8, ctr8, loops=RESIDENT_LOOPS)
    prof = resident_frame_profile("bucket_exact_tiled", eng_bt, src8, mask_b8, dst8)
    slice8b["bucket_exact_tiled"] = dict(
        ms_per_frame=bt_ms, cycles=n_bt, solve_cycles=info_bs["cycles"],
        solve_bit_equal_single_device=same_solve, sharded_solve_ms=bs_ms,
        single_device_solve_ms=b1_ms, plain_partitioned_levels=bt_levels,
        frame_bit_equal_composition=same_bt, diff_max_vs_bucket_exact_8k=d_bt,
        launches_per_call={k: v for k, v in launches.items() if v},
        resident_bytes=eng_bt.metrics["resident_bytes"], busy_us=prof["busy_us"],
        span_us=prof["span_us"], idle=prof["idle"],
        torch_op_launches=prof.get("torch_op_launches"))
    print(f"bucket_exact_tiled ({card}): the 8K ellipse (tight {hw_bt[0] + 2}x{hw_bt[1] + 2} "
          f"in {rh_b}x{rw_b}) on the 2x2 mesh: solve_multigrid_dyn_sharded {info_bs['cycles']} "
          f"cycles in {bs_ms:.1f} ms, bit-equal to solve_multigrid_dyn(use_pallas=False) "
          f"({b1_ms:.1f} ms) {same_solve}; the frame bit-equal to the single-device "
          f"composition {same_bt}, diff_max against bucket_exact_8k {d_bt}; serve "
          f"{bt_ms:.4f} ms/frame; launches {json.dumps(slice8b['bucket_exact_tiled']['launches_per_call'])}")
    if (not same_solve or not same_bt or d_bt > 1 or rem or n_bt != info_bs["cycles"]
            or launches != _per_frame(clamp_cast_paste=DD_TILES,
                                      rb_sweeps_tile=launches["rb_sweeps_tile"])
            or eng_bt.metrics["solver_resolved"] != "multigrid_dyn"):
        raise AssertionError(f"bucket_exact_tiled: {slice8b['bucket_exact_tiled']}")
    del eng_bt, out_bt, ref_bt

    # batch_64_4k_mesh: batch_64_4k's 64 jobs in blocks of 16 over the 2x2 mesh
    groups64 = TB.plan_groups(dst4k.shape, srcs64, masks64, cells, "exact", device=dev)
    (hw64, srcs_d, masks_d, lts64, _), = groups64
    patches_d = TB._masked_planar(srcs_d, masks_d)
    dst4k_p = torch.from_numpy(dst4k).to(dev).permute(2, 0, 1)

    def mesh_step(mesh_=mesh_c):
        d_p = TB._gather(dst4k_p, lts64, *hw64)
        blended = TB.clone_roi_batch(d_p, patches_d, masks_d, 1, TB.fast_dst_solver(),
                                     mesh=mesh_)
        return TB._composite(dst4k_p, blended, lts64)

    out_bm, launches = launches_of(mesh_step)
    path_launches.setdefault("batch_64_4k_mesh", (launches, launches))
    same_bm = np.array_equal(out_bm.permute(1, 2, 0).cpu().numpy(), run_outputs["batch_64_4k"])
    same_stack = torch.equal(mesh_step(), mesh_step(None))
    bm_ms = event_ms(mesh_step, BATCH_STEPS)
    prof = profile_frames("batch_64_4k_mesh", lambda: mesh_step(), {}, frames=3,
                          into=loop_profiles, brief=True)
    slice8b["batch_64_4k_mesh"] = dict(
        ms_per_step=bm_ms, mean_ms=sum(bm_ms) / len(bm_ms),
        batch_64_4k_mean_ms=batch_rows["batch_64_4k"]["mean_ms"], bit_equal_batch_64_4k=same_bm,
        bit_equal_without_mesh=same_stack, launches_per_step={k: v for k, v in
                                                              launches.items() if v},
        busy_us=prof["busy_us"], span_us=prof["span_us"], idle=prof["idle"],
        torch_op_launches=prof.get("torch_op_launches"), gemms=prof["gemms"])
    print(f"batch_64_4k_mesh ({card}): 64 jobs in 4 blocks of 16 over the 2x2 mesh of the card: "
          f"step {sum(bm_ms) / len(bm_ms):.4f} ms ({[round(x, 4) for x in bm_ms]}) against "
          f"batch_64_4k's {batch_rows['batch_64_4k']['mean_ms']:.4f}; bit-equal to batch_64_4k "
          f"{same_bm}, to the step without a mesh {same_stack}; idle {prof['idle']}, torch ops "
          f"{prof.get('torch_op_launches')}, GEMMs {prof['gemms']} a step; launches "
          f"{json.dumps(slice8b['batch_64_4k_mesh']['launches_per_step'])}")
    if not same_bm or not same_stack or launches != _per_frame(clamp_cast_paste=DD_TILES):
        raise AssertionError(f"batch_64_4k_mesh: {slice8b['batch_64_4k_mesh']}")
    del groups64, srcs_d, masks_d, patches_d, dst4k_p, out_bm

    # dist_2proc, extended: the resident engine's timed_serve at 8K in the same
    # two processes (run there above), against the one-process 2x2 engine
    slice8["dist_2proc"]["engine"] = dict(
        single_process_ms_per_frame=info_e1["ms_per_frame"], single_process_call_ms=e1_ms,
        ranks=[dict(rank=rep["rank"], **rep["solves"]["engine"]) for rep in reports])
    for rep in reports:
        row = rep["solves"]["engine"]
        print(f"dist_2proc engine rank {rep['rank']} ({card}, backend {rep['backend']}, cells "
              f"{rep['cells']}): TiledSeamlessClone.timed_serve at 8K {row['ms_per_frame']:.1f} "
              f"ms a frame (the second run; single process {info_e1['ms_per_frame']:.1f}), "
              f"{row['crossed_bytes_per_frame'] / 1e6:.3f} MB a frame sent to the other rank, "
              f"replicated levels {row['replicated_bytes_per_frame'] / 1e6:.3f} MB a frame, "
              f"gathers a frame {row['gathers_per_frame']}; clamp_cast_paste "
              f"{row['clamp_cast_paste']}; bit-equal on this rank to the one-process 2x2 "
              f"resident engine {row['equal']}")
    if not all(rep["solves"]["engine"]["equal"]
               and rep["solves"]["engine"]["gathers_per_frame"] == 0 for rep in reports):
        raise AssertionError(f"dist_2proc engine: {slice8['dist_2proc']['engine']}")

    # dryrun_2x2: dryrun_multichip's eight sub-checks on the 2x2 mesh of the card
    (dry, _), dry_ms = timed_solve(lambda: (dryrun_multichip(mesh_c), None))
    slice8b["dryrun_2x2"] = dict(figures=dry, s=dry_ms / 1e3)
    print(f"dryrun_2x2 ({card}): dryrun_multichip passed its eight sub-checks on the 2x2 mesh "
          f"in {dry_ms / 1e3:.1f} s: {json.dumps(dry)}")
    for name in ("clamp_cast_paste", "rb_sweeps_tile"):
        rows[name]["resident_launches_per_frame"] = {
            p: r["launches_per_frame"].get(name, 0) for p, r in resident.items()}
    print(json.dumps({"slice8b_paths": slice8b, "resident": resident,
                      "dist_2proc_engine": slice8["dist_2proc"]["engine"]}))
    print(f"the slice-8b phases ran {time.perf_counter() - t_8b:.1f} s")

    # -- the kernel table: launches of each kernel's own path ---------------------
    for name in KERNELS:
        home = None if name in FOLDED else HOME_PATH.get(name, "pair")
        rows[name]["launches"] = 0 if home is None else path_launches[home][0][name]
        rows[name]["path"] = home
        rows[name]["launches_by_path"] = {p: path_launches[p][0][name] for p in PATHS}
        rows[name]["run_launches_by_path"] = {p: path_launches[p][1][name] for p in PATHS}
    for name, fused in FOLDED.items():
        rows[name]["folded_into"] = fused
        if (any(rows[name]["launches_by_path"].values())
                or any(rows[name]["run_launches_by_path"].values())):
            raise AssertionError(f"{name} was launched on a path: it is folded into {fused}")
    rows["prep_mask"].update(launches=1, path="one a request: every run and timed_serve")
    rows["clamp_cast_paste_interleaved"]["launches"] = path_launches["unfolded"][1][
        "clamp_cast_paste"]
    rows["clamp_cast_paste_interleaved"]["path"] = "unfolded single-shot run"
    rows["unfold_clamp_paste_interleaved"]["launches"] = path_launches["pair"][1][
        "unfold_clamp_paste"]
    rows["unfold_clamp_paste_interleaved"]["path"] = "pair single-shot run"
    rows["clamp_cast_paste_q_interleaved"]["launches"] = path_launches["mg_q"][1][
        "clamp_cast_paste_q"]
    rows["clamp_cast_paste_q_interleaved"]["path"] = "mg_q single-shot run"
    rows["preprocess_rhs_p_exact"]["launches"] = path_launches["dst_fft"][0]["preprocess_rhs_p"]
    rows["preprocess_rhs_p_exact"]["path"] = "dst_fft (also jacobi, jacobi_small)"
    for name, base in (("mg_down_exact", "mg_down"), ("mg_up_exact", "mg_up")):
        rows[name]["launches"] = path_launches["tiled_dd"][0][base]
        rows[name]["path"] = "tiled_dd (the coarse solve's fused levels)"
        rows[name]["launches_by_path"] = {p: path_launches[p][0][base] for p in (
            "tiled_dd", "tiled_dd_fixed", "tiled_dd_headline", "mg_padded_false",
            *BUCKET_EXACT_PATHS)}
    loop_lines = []
    for key, (label, kernel) in LOOP_PROFILE.items():
        name, _, form = key.partition(" ")
        pre = f"{form}_" if form else ""
        per_kernel, per_frame, seq = loop_profiles.get(label, ({}, {}, []))
        n = sum(v for k, v in per_frame.items() if kernel in k)
        us = sum(t for k, t in per_kernel.items() if kernel in k)
        rows[name].update({f"{pre}loop_ms": us / n / 1e3 if n else None,
                           f"{pre}loop_launches_per_frame": n, f"{pre}loop_profile": label})
        # --other: the other checkout's kernel in the same frame, in its turns
        other_loop = [r["loop_ms"].get(key) for r in frames_vs_other.get(
            PROFILE_PATH.get(label, label), {}).get("other", [])]
        if other_loop and None not in other_loop:
            rows[name][f"{pre}other_loop_ms"] = sum(other_loop) / len(other_loop)
        loop_lines.append(f"{key} ({label}) {rows[name][pre + 'loop_ms']} ms x{n:g} a frame")
        # per coarse level, by launch order: a cycle descends levels 1, 2,
        # 3 (mg_down_t; mg_down, mg_restrict_t) and ascends 3, 2, 1
        times = [t for k, t in seq if kernel in k]
        levels = rows[name].get("coarse_levels", []) if not form else []
        if levels and times and len(times) % len(levels) == 0:
            descent = name in ("mg_down_t", "mg_down", "mg_restrict_t")
            order = range(len(levels)) if descent else range(len(levels))[::-1]
            for lv, i in zip(levels, order):
                lv["loop_ms"] = sum(times[i :: len(levels)]) / len(times[i :: len(levels)]) / 1e3
            print(f"{name} in the loop ({label}, {card}), by coarse level: " + "; ".join(
                f"{lv['shape']} {lv['loop_ms']:.5f} ms" for lv in levels))
    print(f"in the loop ({card}): " + "; ".join(loop_lines))
    strip_loop = {("transpose_pair", "per_axis_w"): "strip_w_divide_loop_ms",
                  ("transpose_pair", "per_axis_h"): "strip_h_loop_ms",
                  ("unfold_transpose", "per_axis_h"): "strip_h_loop_ms",
                  ("unfold_clamp_paste", "per_axis_w"): "strip_w_loop_ms"}
    for (name, path), key in strip_loop.items():
        for x in rows[name]["strips"]:
            if x["path"] == path:
                x["loop_ms"] = rows[name].get(key)
                print(f"{name} on {path} ({card}): {x['ms']:.5f} ms cold, {x['b2b_ms']:.5f} "
                      f"back to back, {x['loop_ms']} in the loop, bound {x['bound_ms']:.5f}")
    print(json.dumps({"strip_frames_busy_us": strip_busy}))
    for name, r in rows.items():
        if not r["launches"] and name not in FOLDED:
            raise AssertionError(f"{name} was launched no time on its path")
    print(f"card vs cpu diff_max by path: {json.dumps(cpu_diffs)}")
    print(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s, the build included")
    if other is not None:
        print(json.dumps({"frames_vs_other": frames_vs_other, "other": str(other_root),
                          "kernel_outputs_equal": all(other_agrees)}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
