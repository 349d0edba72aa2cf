"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives ``pylrbms_tpu_torch`` (never JAX) on the card and fails unless every
phase passes:

1. device: CUDA present; prints the card's name and power limit;
2. build: compiles the CUDA kernels from ``pylrbms_tpu_torch/csrc`` (nvcc,
   sm_90a) and prints the build time and the compiler's resource report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving shapes (G=2, K=64, N=384, B=1 and 256; f64, f32, bf16
   matrices), the serving harvest (B=12), the order-2 blocks (K=64, N=576
   and 768; f64 and f32 x f32; B=1, 12, 16) and at tail shapes (K=4, N=24;
   N=96 with 13 lanes on the ring), with the tolerances stated
   below, and precond_dot's rz bitwise equal across two launches; per
   shape the route ``plan`` picked, the kernel's time with the 50 MB L2
   flushed between repetitions (and warm, as earlier runs timed it), the
   plain version's and one library call's time (flushed), the bound and
   the kernel's share of it (CUDA events, median of 20), and the 442k
   truth blocks stored in bf16 (K=256, N=1728, one lane); the dmma route at
   every f64 shape the paths launch above the stream (``DMMA_SHAPES``: the
   Gramians, the reductors, the estimator, ``spe10_3d``; G=2 with coef,
   bf16 x f64, N=216 at 32 and 17 lanes), none of them on the SIMT tiles,
   with the first port's SIMT tiles (route 2 of the C entry) timed beside
   the first six; the ring (both kernels' f64 and f32 pairs at 5-16 lanes,
   ragged N with 16-byte rows) at every shape of ``RING_SHAPES`` (the
   paths' 16-lane launches: the parabolic ``solve_batch``, the MOR scale
   corrector, the Q2 3D harvest, the order-2 blocks, the dense corrector),
   with the first port's 16-lane register stream (route 0 of the C entry,
   16 lanes) timed beside each; the tensor route (wgmma fed by TMA) at every
   shape of ``TENSOR_SHAPES`` (the paths' f32-vector launches above the
   stream: the 2D and 3D serving apply and preconditioner at B=256, the
   truth harvest filter at 32 lanes, N=512 and 1728); a row that takes
   another route fails; then ``stencil3_apply`` (the lane-batched 3D hex
   stencil apply) at the SPE10 3D cell's shape (K=32, s=4, nb=8, Q=2) at
   B=1024 and 256 in f32 and f64, against the plain gather in f64 and the
   per-lane assembled apply (f32 2e-5, f64 1e-12 of the |.|-sum), y
   bitwise equal over two launches, timed beside its bound (the formula of
   ``benchmark/stencil_roofline.py``) and the plain apply; and on grids
   with one subdomain along an axis, s = 1, 2, 4 and Q = 3; then
   ``stencil2_apply`` (the lane-batched 2D tri P1 stencil apply) at the
   OS2015 stencil cell's shape (K=64, s=8, nb=3, Q=2; the ``PATH_SHAPES``
   rows, random components) at B=1024 and 256 in f32 and f64, held and
   timed as ``stencil3_apply``, and on ragged grids (s = 1, 2, 3, 4; Q = 3);
4. entry config: ``graft_entry.entry()`` (2x2 subdomains, half 1, nref 1,
   tol 1e-8), one query on the card in f64 and in f32, against its own
   CPU f64 run;
5. serving config (8x8 subdomains, half 2, nref 2: 24 576 dofs; affine
   apply, harvested coarse space with 12 modes, tol 1e-6, f32, default
   bf16 Jacobi storage), B=256 queries mu = linspace(0.1, 1, 256) in one
   call: finite non-negative indicators, lane 0 equal to the single query,
   4 lanes against a scipy sparse LU solve, and both kernels launched on
   that path; prints per-query and single-query times, PCG iterations and
   peak device memory;
6. stencil apply: the matrix-free ``AssembledStencil.apply`` against the
   block operator's apply, entry config f64 (1e-12) and serving config f32
   (1e-5), one vector and 4 lanes;
7. the reference's default online step at the serving config
   (``make_online_step`` without ``matrix_free``: the stencil form at
   >= 16 384 dofs; harvested coarse space, 12 modes, tol 1e-6), one query
   and B=256: U against the affine step's U for the same mu (1e-3),
   indicators finite and non-negative, precond_dot launched (and the
   stencil operator's ``lane_kernel``, where it has one); prints per-query
   and single-query times, PCG iterations beside the affine step's and
   peak memory;
8. ``StationaryBlockModel.solve`` at 98 304 dofs (8x8 subdomains, half 2,
   nref 3, f64, solver 'auto' at precision 1e-10): the matrix-free
   two-level PCG, its divergence post-check, U against scipy splu (1e-6);
   then the same solve with ``mixed=True``; prints time and iterations;
9. main-path shapes: every (kernel, shape, dtypes) the main paths launched
   (``stencil3_apply`` and ``stencil2_apply`` by (Q, grid, s, B, dtype),
   on random components)
   that phase 3 did not check (phase 8's K=64, N=1536 blocks, the
   harvest's one-lane power iteration, ...), against its plain version on
   the card at phase 3's tolerances, timed as in phase 3; fails if an
   f64-vector shape would take the SIMT tiles; logs the shapes that take
   the ring, those still on the 16-lane register stream and the tensor
   route's shapes with their block tiles;
10. model order reduction at the serving config in f64 (K=64, N=384):
   ``LRBMSReductor`` with one snapshot and ``reduce()``: the ROM estimate
   against the FOM estimate of the reconstruction (1e-8), ``residual_norm``
   against the true residual (1e-6); from that reduced model
   ``AdaptiveEnrichment`` (Doerfler 0.33, max age 4, target 1e-2) for 3
   random mus (seed 7) x 3 steps: eta not increasing (to 1% a step); one
   corrector batch against the dense patch solve for 2 marked subdomains
   (1e-6); ``weak_greedy`` over ``sample_uniformly(6)`` with 4 extensions
   (criterion 'residual', with Gramians): the last max error a tenth of
   the first or less; both kernels launched (dense corrector apply,
   Gramian applies, PCG snapshots);
11. the greedy at 98 304 dofs in f64 (16x16 subdomains, half 2, nref 2:
   K=256, N=384): the same ``weak_greedy`` call, which here takes the
   direct FOM residual, the lean incremental re-reduction and matrix-free
   snapshot solves; the ROM against a FOM solve at a training mu; then one
   mu of ``AdaptiveEnrichment`` x 2 steps (target 1e-12 so that both run;
   stencil corrector apply);
   indicators finite and non-negative; precond_dot launched.
   Phases 10 and 11 print seconds per greedy iteration and enrichment round
   and per span, corrector PCG iterations, RB sizes and peak memory;
12. the parabolic path at 98 304 dofs (SPE10 with raster (8, 8), nearest,
   contrast 1e4; 16x16 subdomains, half 2, nref 2; f64, T=1, nt=10): the
   matrix-free implicit-Euler trajectory (two-level, 12 harvested modes)
   timed per step with its iterations, its final step against a host scipy
   splu implicit Euler (1e-6), ``solve`` ('auto') against it (1e-6),
   ``solve_batch`` of 16 mus with the shared preconditioner, each lane
   against its single-mu trajectory (1e-6), and the snapshot ROM
   (``ParabolicLRBMSReductor`` on 8 strided steps): its error against the
   FOM trajectory and the projected against the unprojected estimate
   (1e-8);
13. artificial channels at the serving grid (8x8 subdomains, half 2, nref
   2: 24 576 dofs; f64, T=1, nt=20): the block-PCG trajectory at the seeded
   mu of ``scripts/parabolic.py``, its parabolic estimate (five groups
   finite and >= 0), ``ParabolicAdaptiveEnrichment`` from the order-0
   basis x 3 steps (the ROM's error against the FOM trajectory falls) and
   ``pod_greedy`` over 5 mus, 3 extensions of 2 POD modes (the max
   estimate falls), run a second time with ``batched_gs``; prints seconds
   per round and iteration with their spans and peak memory.
   Phases 12 and 13 launch both kernels;
14. the reference's golden triple: OS2015 crisscross, 4x4 subdomains,
   half 1, nref 1, f64, paper convention: eta_nc / eta_r / eta_df to rel
   1e-4 of 1.656117e-01 / 1.446952e-01 / 3.548075e-01, the card within
   1e-10 of the port on the CPU;
15. crisscross at full width: phase 5 and phase 7 at the serving grid
   (K=64, N=384, f32, B=256; same gates), phase 8 at nref 3 (98 304
   dofs, f64) and phase 10 (reductor, enrichment, greedy; same gates);
16. order 2: P2 tri at the serving grid (K=64, N=768, 49 152 dofs, lean,
   f64): ``solve`` 'auto' (mf_pcg through the order-2 stencil) against
   scipy splu (1e-6), the positive-form estimate (finite, >= 0), the RT1
   local conservation of the splu solution (1e-9); crisscross P2 and quad
   Q2 at the entry config, card against CPU (1e-10);
17. EOC: the paper-convention ``StationaryEocStudy`` (OS2015, 2x2, half 1,
   nref 1, p_ref 2, one refinement) on tri and crisscross, the table
   against the port on the CPU (1e-8), indicator EOC in (0.7, 1.4),
   efficiency constant to 25%; a small ``InstationaryEocStudy`` (thermal
   block) to its end, its error falling;
18. phase 12's SPE10 trajectory with ``precision='mixed'``,
   ``inner='halo'`` against ``inner='stencil'``: ms/step and iterations
   per step, each final step against host splu (1e-6); the banded apply
   against the stencil apply at the serving grid in f64 (1e-12), timed
   beside the stencil and block applies;
19. the academic3d golden triples (2x2x2 subdomains, half 1, mu 0.5, paper
   convention): Q1 nref 1 and Q2 nref 0 to rel 1e-5 of GOLDEN3, the card
   within 1e-12 of the port on the CPU;
20. 3D serving: academic3d (OS2015 lifted to 3D) at 4x4x4 subdomains, half
   1, nref 2 (K=64, N=512, 32 768 dofs): phase 5 (affine, B=256) and phase
   7 (the stencil step) with their gates, the stencil step launching
   ``stencil3_apply``;
21. 3D scale: SPE10 3D (z-layers 40-44, contrast 1e4) at 8x8x4, half 1,
   nref 2 (K=256, N=512, 131 072 dofs), f64, lean: mf_pcg (harvested, 12
   modes, precision 1e-8) and mixed=True, relative f64 residual <= 1e-7;
   the positive-form estimate; the stencil apply = the block apply on U
   (1e-12 of |A| |U|);
22. 3D MOR: SPE10 3D at 4x4x2, half 1, nref 2 (K=32, N=512, 16 384
   dofs), f64: the FOM solve against splu (1e-6), phase 10's ROM gates on
   an order-0 + one-snapshot model, the weak greedy (5 extensions over 6
   training mus), enrichment from the greedy's model (3 mus x 3 rounds)
   and a corrector batch against the dense patch solve;
23. 3D implicit Euler (T=1, nt=10): phase 21's model with ``_solve_mf``
   (ms/step, iterations, per-step residual <= 1e-7), then phase 22's grid:
   the block-PCG trajectory against a host splu implicit Euler (1e-6) and
   ``solve_batch`` B=4 against single-mu trajectories (1e-6);
24. Q2 3D: academic3d Q2 at 4x4x4, half 1, nref 1 (K=64, N=216, 13 824
   dofs), lean, f64: mf_pcg against splu (1e-6), the RT_[1] hex estimate,
   the local conservation of the splu solution (1e-9);
25. the truth solver (``truth.truth_solve``): (a) on phase 21's model
   through its ``mf_operator`` and ``cast_f32``, the f64 recurrence (bf16
   and f32 block factors) and the f32 inner IR, each with relres <= 1e-9
   and U within 1e-7 of an mf_pcg solve at precision 1e-11, and the VTU of
   U (``d.visualize``) parsed back; (b) at full width, the 442k-q2
   ``SolveOnlyModel`` (SPE10 3D raster (4, 8, 8), contrast 1e4, Q2: K=256,
   N=1728, 442 368 dofs), block route, f64 recurrence, at mu = 1.0 and 0.3:
   relres <= 1e-9 and U within TRUTH_TOL of ``docs/results/ref442k.npz``;
   prints seconds per stage, ms per iteration, peak memory and the
   per-iteration roofline share.

26. distribution over the subdomain axis (``scripts/dryrun_multichip``
   through the rank launcher of ``scripts/distributed_smoke``, every rank
   on cuda:0), after a probe of which gloo operations take CUDA tensors:
   (a) world 1 over NCCL and (b) world 4 over gloo at the serving grid
   (K=64, N=384, f64): the K-sharded online step against the unsharded
   one (U, indicators, eta; 1e-8), the SPMD solver (1e-8), ``reduce(mesh=)``
   (rtol 1e-12 / atol 1e-14) and its ROM solve (1e-10), the K-banded
   corrector (1e-8), ``solve_sharded`` (1e-8), ``batched_estimates(mesh=)``
   over 64 mus (1e-12); (c) world 2 over gloo: the two-level matrix-free
   solve at 98 304 dofs (K=64, N=1536) and at SPE10 3D 131 072 dofs (K=256,
   bands of 2 z-layers), phase 12's SPE10 trajectory (nt=10) in f64 and
   mixed and a B=2 sweep (1e-8 of max |U|).  Per leg: seconds, iterations
   sharded and unsharded, per-rank ms per iteration and exchange ms per
   iteration, per-rank peak memory.  Ranks sharing the card are no
   speedup, and NCCL across devices is not exercised.
27. the entry-point scripts (``pylrbms_tpu_torch/scripts``), each at the
   configuration its ``docs/results/`` file records, held to that file by
   ``scripts/_results.py``: the CPU-written tables (OS2015 plain,
   crisscross, paper and reduced; P2; the thermal-block EOC; academic3d
   Q1 and Q2; the SPE10 efficiency study) to their printed digits, EOC
   cells to 0.02; the TPU files' accuracy values (the channels demo at 8x8,
   nt=100; the SPE10 greedy at K=256; ``spe10_scale --matrix-free``; the
   SPE10 trajectory and its ROM; five ``spe10_3d`` commands; the 1M-dof
   sharded solve) at rel 1e-3 or their own tolerance, residuals under
   their solve's bound (the channels' switch decided at its zeros as in
   the file's run; the at-scale 3D eta of the file, an f32 artifact of the
   JAX accelerator branch, printed, not held); the demo and
   ``spe10_3d_efficiency_study --smoke``
   against the port on the CPU (1e-8); the acceptance script to GOLDEN
   (1e-5) and the golden triple (1e-4); the VTU parsed back; W threads on
   their own streams and the batched apply equal to the sequential applies.
   Per script: card seconds, peak device memory and kernel launches; the
   scripts' output goes to ``results_out/chip_smoke_scripts/``.
28. the JAX-call-compatible surface: (a) ``scripts/spe10_3d --nref 2``
   (SPE10 3D 4x4x2, half 1, K=32, N=512, 16 384 dofs, f64), whose FOM
   solve is ``solve_pcg(two_level=True)``: 129 iterations (the count of
   the script's earlier hand-built ones-basis route), relres <= 1e-8, and
   on the same system U of ``two_level`` = U of the ones-basis route
   (1e-12) in equal iterations; (b) the same solve with ``coarse_f32=True`` (its iterations
   printed beside the f64 coarse level's, not held); (c) right after phase
   8, on its model: ``solve_ir`` through ``ops/ir.make_precond_f32``, the
   model's ``mixed=True`` solve and a direct call, with phase 8's mixed
   iterations and equal rounds, relres <= 1e-10; (d)
   ``graft_entry.entry()`` in f32 on the card against its CPU f64 run
   (1e-3), its PCG iterations printed; (e) ``utils/timers.trace`` around
   that step: a non-empty Chrome trace that names both kernels (their
   counts there printed beside the wrappers').

Phases run in the order 1-8, 28c, 10-21, 23, 25a, 22, 24, 25b, 26, 27, 28,
9, each timed with its peak device memory, and the total is printed.  Each
main path (phases 5, 7, 8, 10-13, 15, 16, 18a, 20-28) runs with the kernel
launch counts and signatures cleared just before it and read just after
(phase 26's and the sharded script's in their ranks); the summary's
``launches`` is the sum of the counts.

Its last three lines are the ``nvidia-smi`` name/power-limit line, a JSON
summary of the kernels and ``{"ok": true, "device": {...}}``.  Exits non-zero
without that last line if CUDA is unavailable or any phase fails.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback

import numpy as np

SEED = 0
ENTRY = {"num_subdomains": [2, 2],
         "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": 1}
SERVING = {"num_subdomains": [8, 8],
           "half_num_fine_elements_per_subdomain_and_dim": 2,
           "num_refinements": 2}
SCALE = {"num_subdomains": [8, 8],
         "half_num_fine_elements_per_subdomain_and_dim": 2,
         "num_refinements": 3}
NORTH_STAR = {"num_subdomains": [16, 16],
              "half_num_fine_elements_per_subdomain_and_dim": 2,
              "num_refinements": 2}
B_SERVE = 256
# kernel-vs-plain tolerances, as max|kernel - plain| / max|plain|:
# f64: rounding of a different summation order over N <= 384 terms;
# f32 (and bf16 matrices, whose elements widen exactly to f32 on both
# sides): the normwise form of the tests/test_pallas.py bounds (rtol 2e-5 on
# the products, 2e-4 on the per-subdomain dots rz).
TOL = {"f64": (1e-12, 1e-12), "f32": (2e-5, 2e-4)}
# the dmma route's f64 shapes (every f64-vector launch above the stream), as
# the paths launch them: (kind, G, K, N, B); the SIMT tiles (route 2) are
# timed beside the first DMMA_TILES_AB in the same run
DMMA_SHAPES = (
    ("precond_dot", 1, 32, 512, 32),          # spe10_3d (phase 27)
    ("block_matvec", 1, 256, 384, 128),       # parabolic reductor (phase 12)
    ("block_matvec", 1, 32, 512, 128),        # 3D MOR Gramians (phase 22)
    ("block_matvec", 1, 64, 384, 128),        # Gramians (phases 10, 13, 26a)
    ("block_matvec", 1, 16, 384, 128),        # band Gramians of reduce(mesh=) (26b)
    ("block_matvec", 1, 32, 512, 32),         # spe10_3d (phase 27)
    ("block_matvec", 1, 256, 384, 20), ("block_matvec", 1, 256, 384, 21),  # parabolic
    ("block_matvec", 1, 64, 384, 20), ("block_matvec", 1, 64, 384, 21),    # estimator, GS
    ("block_matvec", 1, 64, 24, 100), ("block_matvec", 1, 64, 24, 128),    # scripts/parabolic
    ("block_matvec", 2, 64, 384, 128),        # G=2 with coef
    ("block_matvec", 1, 64, 216, 32), ("precond_dot", 1, 64, 216, 32),     # ragged N
    ("block_matvec", 1, 64, 216, 17), ("precond_dot", 1, 64, 216, 17),     # lane tails
)
DMMA_TILES_AB = 6
# the ring's 5-16-lane shapes as the paths launch them: (kind, G, K, N, B,
# dtype of matrix and vectors); the 16-lane register stream (route 0) is
# timed beside each in the same run
RING_SHAPES = (
    ("precond_dot", 1, 256, 384, 16, "f32"),  # parabolic solve_batch (phase 12)
    ("precond_dot", 1, 256, 384, 12, "f64"),  # MOR scale stencil corrector (phase 11)
    ("block_matvec", 1, 64, 216, 16, "f64"),  # Q2 3D harvest (phase 24): ragged N
    *(("precond_dot", 1, 64, N, B, dt) for N in (768, 576) for dt in ("f64", "f32")
      for B in (12, 16)),                     # order-2 and Q2 quad blocks
    ("precond_dot", 1, 64, 384, 5, "f64"),    # dense corrector (phase 10)
    ("precond_dot", 1, 64, 216, 16, "f64"),   # ragged N
)
# the tensor route's shapes as the paths launch them: (kind, G, K, N, B,
# matrix dtype, vector dtype)
TENSOR_SHAPES = (
    ("block_matvec", 2, 64, 384, 256, "f32", "f32"),    # 2D serving apply (5, 7, 15)
    ("precond_dot", 1, 64, 384, 256, "bf16", "f32"),    # 2D serving preconditioner
    ("block_matvec", 2, 64, 512, 256, "f32", "f32"),    # 3D serving apply (20)
    ("precond_dot", 1, 64, 512, 256, "bf16", "f32"),    # 3D serving preconditioner
    ("block_matvec", 1, 256, 512, 32, "f32", "f32"),    # 131k truth harvest filter (25a)
    ("block_matvec", 1, 256, 1728, 32, "f32", "f32"),   # 442k truth harvest filter (25b)
)
# the kernel phase's other shapes as the paths launch them (kind, G, K, N,
# B, matrix dtype, vector dtype): the 2D serving blocks at one lane and at
# B_SERVE (less what TENSOR_SHAPES holds), the harvest filter, the order-2
# blocks (precond_dot at 12 and 16 lanes: RING_SHAPES) and the 442k truth
# blocks stored in bf16 (jacobi_storage='bf16')
PATH_SHAPES = (
    *(shape for B in (1, B_SERVE) for shape in (
        *(("block_matvec", 2, 64, 384, B, dt, dt) for dt in ("f64", "f32")),
        *(("precond_dot", 1, 64, 384, B, mdt, vdt)
          for mdt, vdt in (("f64", "f64"), ("f32", "f32"), ("bf16", "f32"), ("bf16", "f64"))))
      if shape not in TENSOR_SHAPES),
    ("block_matvec", 1, 64, 384, 12, "f32", "f32"),     # harvest filter (ring)
    *(shape for N in (576, 768) for dt in ("f64", "f32") for shape in (
        *(("block_matvec", 1, 64, N, B, dt, dt) for B in (1, 12, 16)),
        ("precond_dot", 1, 64, N, 1, dt, dt))),         # Q2 quad, P2 tri
    ("block_matvec", 1, 256, 1728, 1, "bf16", "f32"),   # 442k truth
    # the OS2015 stencil cell's apply (K=64 square subdomains, N = 6 s^2 at
    # s=8, Q=2 as G), random components: kernel_case takes it to stencil_case
    *(("stencil2_apply", 2, 64, 384, B, dt, dt) for B in (1024, 256) for dt in ("f32", "f64")),
)


# the kernels of the two Pallas TPU kernels (every main path but the 3D
# lane-batched stencil launches both)
BLOCK_KERNELS = ("block_matvec", "precond_dot")
# stencil3_apply at the SPE10 3D cell's shape (4x4x2 subdomains of 4^3 hex
# cells: K=32, s=4, nb=8, Q=2) at these lane counts, f32 and f64; tolerance
# on max |kernel - reference| / max sum_q |theta| |S_q| |x| (the |.|-sum:
# at contrast 1e4 A x cancels), the reference the plain gather in f64:
# f64 summation-order rounding; f32 that of 7 x 8 x Q-term f32 sums (the
# 2D stencil2_apply's 4 x 3 x Q-term sums are held to the same)
STENCIL3_CFG = {"num_subdomains": [4, 4, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
                "num_refinements": 2}
STENCIL3_LANES = (1024, 256)
STENCIL_TOL = {"f64": 1e-12, "f32": 2e-5}

_LOG_TO = [None]          # where log() prints while a phase redirects stdout


def log(msg):
    print(msg, flush=True, file=_LOG_TO[0] or sys.stdout)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


_FLUSH = []


def flush_l2():
    """Write 256 MiB, five times the H100's 50 MB L2, so the next kernel
    finds its operands in device memory, not in L2."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 * 2**20, dtype=torch.float32, device="cuda"))
    _FLUSH[0].zero_()


def cuda_ms(fn, reps=20, flush=False) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), with
    the L2 flushed before each run when ``flush``.  A 1 ms device sleep
    before the start event keeps the card busy while the host enqueues
    ``fn``, so the events time the device work and not the host's
    launch overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush:
            flush_l2()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


# the highest peak device memory of the running phase, folded in whenever
# a phase resets the counter for a reading of its own
_PEAK = [0]


def reset_peak(torch, dev):
    _PEAK[0] = max(_PEAK[0], torch.cuda.max_memory_allocated(dev))
    torch.cuda.reset_peak_memory_stats(dev)


def run_phase(torch, dev, phase_name, fn, *args, **kw):
    """Run one phase; log its seconds and its peak device memory."""
    torch.cuda.synchronize()
    _PEAK[0] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    peak = max(_PEAK[0], torch.cuda.max_memory_allocated(dev))
    log(f"phase {phase_name}: {time.perf_counter() - t0:.2f} s, peak device memory "
        f"{peak / 2**20:.1f} MiB")
    torch.cuda.empty_cache()
    return out


def timed_median(torch, fn, reps=5):
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def kernel_case(hk, torch, dev, randn, kind, G, K, N, B, mdt, vdt):
    """One kernel against its plain version on the card at one shape, inputs
    from ``randn(shape)`` (an f64 tensor on the card); raises if it is off
    its tolerance (or, for precond_dot, if two launches give different rz
    bits).  Returns the summary's numbers: ``max_abs_err``, ``ms`` (L2
    flushed), ``warm_ms``, ``plain_ms`` and ``library_ms`` (flushed; the
    library call is one ``torch.matmul`` on operands laid out beforehand,
    its output [K, N, B] instead of [B, K, N]), ``bound_ms``, ``bound_by``
    and ``path`` (the route ``hk.plan`` picked)."""
    if kind == "stencil2_apply":                     # G components, square grid of K
        ky = kx = math.isqrt(K)
        op = random_stencil_op2(torch, dev, ky, kx, math.isqrt(N // 6), G, vdt)
        return {**stencil_case(hk, torch, dev, op, B, vdt), "path": "simt"}
    dt_name = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
    A = randn((G, K, N, N)).to(mdt)
    x = randn((B, K, N)).to(vdt)
    tol = TOL["f64" if vdt == torch.float64 else "f32"]
    xt = x.permute(1, 2, 0).contiguous()                     # [K, N, B]
    if kind == "block_matvec":
        coef = randn((B, G)).to(vdt) if G > 1 else None
        run = lambda: hk.block_matvec(A, x, coef)            # noqa: E731
        plain = lambda: hk.block_matvec_plain(A, x, coef)    # noqa: E731
        if coef is None:
            lhs, rhs = A[0].to(vdt), xt
        else:                                                # [A_0 | A_1] @ [c0 x; c1 x]
            lhs = A.to(vdt).permute(1, 2, 0, 3).reshape(K, N, G * N)
            rhs = (coef.T[:, None, None, :] * xt[None]).reshape(G, K, N, B)
            rhs = rhs.permute(1, 0, 2, 3).reshape(K, G * N, B)
        y, yp = run(), plain()
        torch.cuda.synchronize()
        errs = [rel(y.cpu(), yp.cpu())]
        abs_err = float((y - yp).abs().max())
        ok = errs[0] <= tol[0]
        same = True
    else:
        F = A[0].contiguous()
        del A
        run = lambda: hk.precond_dot(F, x)                   # noqa: E731
        plain = lambda: hk.precond_dot_plain(F, x)           # noqa: E731
        lhs, rhs = F.to(vdt), xt
        (z, rz), (zp, rzp), (z2, rz2) = run(), plain(), run()
        torch.cuda.synchronize()
        errs = [rel(z.cpu(), zp.cpu()), rel(rz.cpu(), rzp.cpu())]
        abs_err = float(max((z - zp).abs().max(), (rz - rzp).abs().max()))
        same = bool(torch.equal(rz, rz2) and torch.equal(z, z2))
        ok = errs[0] <= tol[0] and errs[1] <= tol[1] and same
    library = lambda: torch.matmul(lhs, rhs)                 # noqa: E731
    ms, warm_ms = cuda_ms(run, flush=True), cuda_ms(run)
    plain_ms, library_ms = cuda_ms(plain, flush=True), cuda_ms(library, flush=True)
    bound_ms, bound_by = hk.bound(kind, G, K, N, B, mdt, vdt)
    path = hk.plan(kind, G, K, N, B, mdt, vdt).name
    label = (f"{kind} G={G} K={K} N={N} B={B} "
             f"{dt_name[mdt]} x {dt_name[vdt]}")
    log(f"kernel {label} [{path}]: max rel err {', '.join(f'{e:.3e}' for e in errs)} "
        f"(tol {tol[0]:.0e}{'/' + format(tol[1], '.0e') if len(errs) > 1 else ''})"
        f"{'' if kind == 'block_matvec' else ', rz bitwise equal over 2 launches: ' + str(same)} "
        f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms (warm L2 {warm_ms:.4f}), "
        f"plain {plain_ms:.4f}, library {library_ms:.4f}, bound {bound_ms:.4f} ms "
        f"({bound_by}), share of bound {bound_ms / ms:.3f}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version"
                             f"{'' if same else ' (rz not reproducible)'}")
    return {"max_abs_err": abs_err, "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "path": path}


def c_entry_ms(hk, torch, dev, randn, kind, G, K, N, B, route, mdt=None, vdt=None):
    """One kernel at one shape through the C entry called with ``route``
    directly, past ``hk.plan``: the first port's SIMT tiles (``hk.TILES``;
    no wrapper takes them for f64 vectors) or its 16-lane register stream
    (``hk.STREAM`` at 16 lanes, which the ring replaced at 5-16 lanes).  Held
    to the plain version at ``TOL`` and timed as ``kernel_case`` times a
    kernel (L2 flushed, median of 20)."""
    mdt, vdt = mdt or torch.float64, vdt or torch.float64
    lib, stream = hk._lib(), torch.cuda.current_stream(dev).cuda_stream
    A, x = randn((G, K, N, N)).to(mdt), randn((B, K, N)).to(vdt)
    coef = randn((B, G)).to(vdt) if G > 1 else None
    y, rz = torch.empty_like(x), torch.empty((B, K), dtype=vdt, device=dev)
    codes = (hk._DTYPE_CODE[mdt], hk._DTYPE_CODE[vdt])
    lanes, chunks, scratch = 0, 1, []
    if route == hk.STREAM:                         # rz scratch: tickets, partials
        lanes = hk.STREAM_LANES[-1]
        chunks = hk._stream_chunks(G, K, N, lanes, x.element_size())
        scratch = [torch.zeros(K, dtype=torch.int32, device=dev),
                   torch.empty(B * K * -(-N // (hk.ROWS_PER_BLOCK * chunks)), dtype=vdt,
                               device=dev)]
    tickets, partials = (t.data_ptr() for t in scratch) if scratch else (None, None)
    if kind == "block_matvec":
        call = lambda: lib.pylrbms_block_matvec(                 # noqa: E731
            route, lanes, chunks, *codes, A.data_ptr(), x.data_ptr(),
            None if coef is None else coef.data_ptr(), y.data_ptr(), G, K, N, B, stream)
        ref = [hk.block_matvec_plain(A, x, coef)]
    else:
        call = lambda: lib.pylrbms_precond_dot(                  # noqa: E731
            route, lanes, chunks, *codes, A[0].data_ptr(), x.data_ptr(), y.data_ptr(),
            rz.data_ptr(), partials, tickets, K, N, B, stream)
        ref = list(hk.precond_dot_plain(A[0], x))
    rcs = [call()]
    torch.cuda.synchronize()
    errs = [rel(got.cpu(), want.cpu()) for got, want in zip((y, rz), ref)]
    tol = TOL["f64" if vdt == torch.float64 else "f32"]
    if any(rcs) or any(e > t for e, t in zip(errs, tol)):
        raise AssertionError(f"route {route} {kind} K={K} N={N} B={B}: rc {rcs}, errors {errs}")
    return cuda_ms(lambda: rcs.append(call()), flush=True)


def random_stencil_op3(torch, dev, kz, ky, kx, s, Q, dtype, seed=SEED):
    """A ``StencilOperator3`` of Q random hex Q1 components (every field
    standard normal) on kz x ky x kx subdomains of s^3 cells: the kernel's
    operand at any grid a path launched it on."""
    from types import SimpleNamespace
    from pylrbms_tpu_torch.ops.matrixfree3d import StencilOperator3, SwipdgStencil3
    K, nb = kz * ky * kx, 8
    space = SimpleNamespace(K=K, s=s, nb=nb, N=s ** 3 * nb,
                            grid=SimpleNamespace(kx=kx, ky=ky, kz=kz))
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def r(*shape):
        return torch.randn(shape + (nb, nb), generator=g, device=dev, dtype=dtype)

    def quads(*shape):
        return tuple(r(*shape) for _ in range(4))

    return StencilOperator3(space, tuple(SwipdgStencil3(
        vol=r(K, s, s, s), X=quads(K, s, s, s - 1), Y=quads(K, s, s - 1, s),
        Z=quads(K, s - 1, s, s), IX=quads(kz * ky * (kx - 1), s * s),
        IY=quads(kz * (ky - 1) * kx, s * s), IZ=quads((kz - 1) * ky * kx, s * s),
        D_side={sd: r(K, s * s) for sd in ("left", "right", "bottom", "top", "near", "far")})
        for _ in range(Q)))


def random_stencil_op2(torch, dev, ky, kx, s, Q, dtype, seed=SEED):
    """A ``StencilOperator`` of Q random tri P1 components (every field
    standard normal) on ky x kx subdomains of s^2 cells of two triangles:
    the operand of ``stencil2_apply`` at any grid a path launched it on."""
    from pylrbms_tpu_torch.grid import Grid
    from pylrbms_tpu_torch.ops.matrixfree import StencilOperator, SwipdgStencil
    from pylrbms_tpu_torch.ops.spaces import BlockDGSpace
    space = BlockDGSpace(Grid(lower_left=(0.0, 0.0), upper_right=(1.0, 1.0), kx=kx, ky=ky,
                              s=s, grid_type="tri"))
    K, nb = space.K, space.nb
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def r(*shape):
        return torch.randn(shape + (nb, nb), generator=g, device=dev, dtype=dtype)

    def quads(*shape):
        return tuple(r(*shape) for _ in range(4))

    return StencilOperator(space, tuple(SwipdgStencil(
        vol=r(K, s, s, 2), D=quads(K, s, s), V=quads(K, s, s - 1), H=quads(K, s - 1, s),
        R=quads(ky * (kx - 1), s), U=quads((ky - 1) * kx, s),
        D_side={sd: r(K, s) for sd in ("left", "right", "bottom", "top")})
        for _ in range(Q)))


def stencil_case(hk, torch, dev, op, B, dtype):
    """The lane kernel of ``op`` (``stencil3_apply`` on a hex Q1 family,
    ``stencil2_apply`` on a tri P1 one) on its folded components against its
    plain versions on the card, theta [B, Q] in [0.1, 1], x standard normal:
    the gather form in f64 (``STENCIL_TOL`` of the |.|-sum) and the per-lane
    assembled apply in ``dtype`` (the step's plain path; the same tolerance,
    both sides rounding), y bitwise equal over two launches.  Times (L2
    flushed, and warm) the kernel and the plain apply (its per-lane
    stencils built beforehand).  Returns the summary's numbers."""
    sp = op.space
    name = op.lane_kernel
    if name == "stencil3_apply":
        grid = (sp.grid.kz, sp.grid.ky, sp.grid.kx)
        kernel, gather, bound = hk.stencil3_apply, hk.stencil3_apply_plain, hk.stencil3_bound
    else:
        grid = (sp.grid.ky, sp.grid.kx)
        kernel, gather, bound = hk.stencil2_apply, hk.stencil2_apply_plain, hk.stencil2_bound
    Q = len(op.stencils)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + B)
    theta = (0.1 + 0.9 * torch.rand((B, Q), generator=g, device=dev,
                                    dtype=torch.float64)).to(dtype)
    x = torch.randn((B, sp.K, sp.N), generator=g, device=dev, dtype=torch.float64).to(dtype)
    P, P64 = op.folded(dtype, dev), op.folded(torch.float64, dev)
    run = lambda: kernel(P, theta, x, grid)                      # noqa: E731
    y, y2 = run(), run()
    ref = gather(P64, theta.double(), x.double(), grid)
    scale = float(gather(P64.abs(), theta.double().abs(), x.double().abs(), grid).max())
    del P64
    A = op.assemble(theta).materialize()
    plain = lambda: A.apply(x)                                    # noqa: E731
    yp = plain()
    torch.cuda.synchronize()
    errs = [float((y.double() - ref).abs().max()) / scale,
            float((y - yp).double().abs().max()) / scale]
    del ref, yp
    same = bool(torch.equal(y, y2))
    dt = "f64" if dtype == torch.float64 else "f32"
    tol = STENCIL_TOL[dt]
    ms, warm_ms, plain_ms = cuda_ms(run, flush=True), cuda_ms(run), cuda_ms(plain, flush=True)
    del A
    bound_ms, bound_by = bound(Q, *grid, sp.s, B, dtype)
    ok = max(errs) <= tol and same
    label = f"{name} Q={Q} grid={grid} s={sp.s} B={B} {dt}"
    log(f"kernel {label}: max err / |.|-sum "
        f"{errs[0]:.3e} (f64 gather), {errs[1]:.3e} (plain apply) (tol {tol:.0e}), y bitwise "
        f"equal over 2 launches: {same} {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms (warm L2 "
        f"{warm_ms:.4f}), plain {plain_ms:.4f}, bound {bound_ms:.4f} ms ({bound_by}), share "
        f"of bound {bound_ms / ms:.3f}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain versions"
                             f"{'' if same else ' (y not reproducible)'}")
    return {"max_abs_err": errs[0] * scale, "ms": ms, "warm_ms": warm_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by}


def stencil3_phase(hk, torch, dev):
    """Phase 3's rows of ``stencil3_apply``: the SPE10 3D cell's components
    (``STENCIL3_CFG``) at ``STENCIL3_LANES`` lanes, f32 and f64; then grids
    with one subdomain along an axis, s = 1 and 2 and Q = 3 (random
    components).  Returns (the summary row: f32 at the cell's B, the
    signatures checked)."""
    _, discretize = problem_and_discretizer(3)
    checked, row = set(), None
    for dtype in (torch.float32, torch.float64):
        d, _ = discretize(spe10_3d(STENCIL3_CFG), device=dev, dtype=dtype)
        op = d.mf_operator()
        g = d.space.grid
        for B in STENCIL3_LANES:
            r = stencil_case(hk, torch, dev, op, B, dtype)
            checked.add(("stencil3_apply", len(op.stencils), g.kz, g.ky, g.kx, d.space.s,
                         B, dtype))
            if dtype == torch.float32 and B == STENCIL3_LANES[0]:
                row = r
            torch.cuda.empty_cache()
        del d, op
    for kz, ky, kx, s, Q, B in ((1, 2, 3, 2, 3, 7), (3, 1, 2, 1, 2, 33), (2, 2, 1, 4, 2, 1)):
        for dtype in (torch.float32, torch.float64):
            op = random_stencil_op3(torch, dev, kz, ky, kx, s, Q, dtype)
            stencil_case(hk, torch, dev, op, B, dtype)
            checked.add(("stencil3_apply", Q, kz, ky, kx, s, B, dtype))
    return row, checked


def kernel_phase(hk, torch, dev):
    """Kernel vs plain on the card; returns the summary of the serving-shape
    cases per kernel (f32 vectors, B=256: the main path's dtypes) and the
    set of (kernel, G, K, N, B, matrix dtype, vector dtype) checked."""
    rng = np.random.default_rng(SEED)
    randn = lambda shape: torch.as_tensor(rng.standard_normal(shape), device=dev)  # noqa: E731
    summary, checked = {}, set()

    def case(kind, G, K, N, B, mdt, vdt):
        if kind == "stencil2_apply":                     # its signature (Q, ky, kx, s, B, dtype)
            checked.add((kind, G, math.isqrt(K), math.isqrt(K), math.isqrt(N // 6), B, vdt))
        else:
            checked.add((kind, G, K, N, B, mdt, vdt))
        r = kernel_case(hk, torch, dev, randn, kind, G, K, N, B, mdt, vdt)
        if vdt == torch.float64 and r["path"] == "tiles":
            raise AssertionError(f"{kind} K={K} N={N} B={B}: an f64 launch took the SIMT tiles")
        return r

    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    dts = {"f64": f64, "f32": f32, "bf16": bf16}
    tensor_rows = []
    # the tensor rows' inputs are drawn on the card: N=1728 takes 6 GB a draw
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    drandn = lambda shape: torch.randn(shape, generator=g, device=dev,  # noqa: E731
                                       dtype=torch.float64)
    for kind, G, K, N, B, mdt, vdt in TENSOR_SHAPES:
        checked.add((kind, G, K, N, B, dts[mdt], dts[vdt]))
        r = kernel_case(hk, torch, dev, drandn, kind, G, K, N, B, dts[mdt], dts[vdt])
        if r["path"] != "tensor":
            raise AssertionError(f"{kind} K={K} N={N} B={B}: took {r['path']}, "
                                 f"not the tensor route")
        if (G, K, N, B) in ((2, 64, 384, B_SERVE), (1, 64, 384, B_SERVE)):
            summary[kind] = r                            # the serving batch's shapes
        p = hk.plan(kind, G, K, N, B, dts[mdt], dts[vdt])
        log(f"tensor route {kind} G={G} K={K} N={N} B={B} {mdt} x {vdt}: {r['ms']:.4f} ms "
            f"({hk.TENSOR_ROWS} x {p.lanes} tile), plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}), "
            f"share {r['bound_ms'] / r['ms']:.3f}, x library {r['ms'] / r['library_ms']:.2f}")
        tensor_rows.append({"shape": f"{kind} G={G} K={K} N={N} B={B} {mdt} x {vdt}",
                            "tile": [hk.TENSOR_ROWS, p.lanes],
                            **{key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                                       "bound_ms", "max_abs_err")}})
        torch.cuda.empty_cache()
    log(f"tensor shapes: {json.dumps(tensor_rows)}")
    for kind, G, K, N, B, mdt, vdt in PATH_SHAPES:
        r = case(kind, G, K, N, B, dts[mdt], dts[vdt])
        if kind == "stencil2_apply" and (B, vdt) == (1024, "f32"):
            summary[kind] = r                            # the OS2015 stencil cell's shape
        torch.cuda.empty_cache()
    for ky, kx, s, Q, B in ((1, 2, 3, 3, 7), (3, 1, 1, 2, 33), (2, 2, 4, 2, 1), (2, 3, 2, 2, 17)):
        for dtype in (f32, f64):                         # ragged grids, s odd among them
            stencil_case(hk, torch, dev, random_stencil_op2(torch, dev, ky, kx, s, Q, dtype),
                         B, dtype)
            checked.add(("stencil2_apply", Q, ky, kx, s, B, dtype))
    for dt in (f64, f32):                                # ring: G=2, a half-empty row tile
        case("block_matvec", 2, 4, 96, 13, dt, dt)
    ring_rows = []
    for kind, G, K, N, B, dt in RING_SHAPES:            # ring against the 16-lane stream
        r = case(kind, G, K, N, B, dts[dt], dts[dt])
        if r["path"] != "ring":
            raise AssertionError(f"{kind} K={K} N={N} B={B} {dt}: took {r['path']}, not the ring")
        t = c_entry_ms(hk, torch, dev, randn, kind, G, K, N, B, hk.STREAM, dts[dt], dts[dt])
        log(f"16-lane register stream (route 0) {kind} G={G} K={K} N={N} B={B} {dt}: "
            f"{t:.4f} ms against ring {r['ms']:.4f} ms ({t / r['ms']:.2f}x; ring faster: "
            f"{r['ms'] < t}), plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f}, share {r['bound_ms'] / r['ms']:.3f}")
        ring_rows.append({"shape": f"{kind} G={G} K={K} N={N} B={B} {dt}", "stream_ms": t,
                          **{key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                                     "bound_ms", "max_abs_err")}})
        torch.cuda.empty_cache()
    log(f"ring shapes: {json.dumps(ring_rows)}")
    for n, (kind, G, K, N, B) in enumerate(DMMA_SHAPES):  # dmma: f64 vectors, many lanes
        r = case(kind, G, K, N, B, f64, f64)
        if n < DMMA_TILES_AB:
            t = c_entry_ms(hk, torch, dev, randn, kind, G, K, N, B, hk.TILES)
            log(f"SIMT tiles (route 2) {kind} G={G} K={K} N={N} B={B} f64 x f64: {t:.4f} ms "
                f"against dmma {r['ms']:.4f} ms ({t / r['ms']:.2f}x), plain {r['plain_ms']:.4f}, "
                f"library {r['library_ms']:.4f}")
        torch.cuda.empty_cache()
    for kind in ("block_matvec", "precond_dot"):          # bf16 x f64 on the dmma route
        case(kind, 1, 64, 384, 128, bf16, f64)
    for B in (1, 4, 13):
        for mdt, vdt in ((f64, f64), (f32, f32), (bf16, f32)):
            case("block_matvec", 2 if mdt != bf16 else 1, 4, 24, B, mdt, vdt)
            case("precond_dot", 1, 4, 24, B, mdt, vdt)
    summary["stencil3_apply"], stencil_checked = stencil3_phase(hk, torch, dev)
    return summary, checked | stencil_checked


def path_shape_phase(hk, torch, dev, paths, checked):
    """Every kernel shape the main paths launched (``paths``: path name ->
    (launch counts, kernel -> {signature: launches} from
    ``hk.launch_signature_counts()``)), with its launches per path; those
    the kernel phase did not already check are held against their plain
    version on the card (phase 8's K=64, N=1536 blocks, the harvest's
    power-iteration lane, the corrector's lane counts, ...)."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    randn = lambda shape: torch.randn(shape, generator=g, device=dev,  # noqa: E731
                                      dtype=torch.float64)
    per_shape = {}
    for path, (_, shapes) in paths.items():
        for kind, sigs in shapes.items():
            for sig, n in sigs.items():
                per_shape.setdefault((kind, *sig), {})[path] = n
    todo = sorted(set(per_shape) - checked, key=str)
    log(f"main-path kernel shapes: {len(per_shape)}, not in the kernel phase: {len(todo)}")
    for shape in sorted((s for s in per_shape if s[0] in ("stencil3_apply", "stencil2_apply")),
                        key=str):
        kind, Q, *grid, s, B, dt = shape
        log(f"launches of {kind} Q={Q} grid={tuple(grid)} s={s} B={B} "
            f"{str(dt)[6:]}{'' if shape in todo else ' (checked in the kernel phase)'}: "
            f"{per_shape.pop(shape)}")
        if shape in todo:
            random_op = random_stencil_op3 if kind == "stencil3_apply" else random_stencil_op2
            stencil_case(hk, torch, dev, random_op(torch, dev, *grid, s, Q, dt), B, dt)
            torch.cuda.empty_cache()
    todo = [s for s in todo if s in per_shape]
    simt = [s for s in per_shape if hk.plan(*s).route == hk.TILES]
    log(f"main-path shapes on the SIMT tiles: {simt}")
    if any(s[-1] == torch.float64 for s in simt):
        raise AssertionError(f"f64-vector launches took the SIMT tiles: {simt}")
    plans = {s: hk.plan(*s) for s in per_shape}
    tensor = sorted(((s, (hk.TENSOR_ROWS, p.lanes)) for s, p in plans.items()
                     if p.route == hk.TENSOR), key=str)
    log(f"main-path shapes on the tensor route (rows x lanes a block): {tensor}")
    log(f"main-path shapes on the ring: "
        f"{sorted((s for s, p in plans.items() if p.route == hk.RING), key=str)}")
    log(f"main-path shapes on the 16-lane register stream: "
        f"{sorted((s for s, p in plans.items() if p.route == hk.STREAM and p.lanes == 16), key=str)}")
    for shape in sorted(per_shape, key=str):
        kind, G, K, N, B, mdt, vdt = shape
        log(f"launches of {kind} G={G} K={K} N={N} B={B} {str(mdt)[6:]} x {str(vdt)[6:]}"
            f"{'' if shape in todo else ' (checked in the kernel phase)'}: {per_shape[shape]}")
        if shape in todo:
            kernel_case(hk, torch, dev, randn, kind, G, K, N, B, mdt, vdt)
            torch.cuda.empty_cache()


def entry_phase(torch, dev):
    """``graft_entry.entry()`` (OS2015 2x2, half 1, nref 1, tol 1e-8) on the
    card in f64 and f32 against its CPU f64 run."""
    from pylrbms_tpu_torch.graft_entry import entry

    def run(device, dtype):
        fn, args = entry(device=device, dtype=dtype)
        U, ind = fn(*args)
        return U.cpu().double().numpy(), ind.cpu().double().numpy()

    U_ref, ind_ref = run("cpu", torch.float64)
    U64, ind64 = run(dev, torch.float64)
    U32, ind32 = run(dev, torch.float32)
    checks = [("f64 U", rel(U64, U_ref), 1e-8), ("f64 indicators", rel(ind64, ind_ref), 1e-8),
              ("f32 U", rel(U32, U_ref), 1e-3), ("f32 indicators", rel(ind32, ind_ref), 1e-3)]
    for name, err, tol in checks:
        log(f"entry config {name} vs CPU f64: rel err {err:.3e} (tol {tol:.0e}) "
            f"{'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            raise AssertionError(f"entry config {name} off by {err:.3e}")


def serving_phase(hk, torch, dev, smi, cfg=None, label="serving", dim=2):
    import scipy.sparse.linalg as spla
    from pylrbms_tpu_torch.model import make_online_step
    from pylrbms_tpu_torch.la.block import to_scipy_csr

    init_grid_and_problem, discretize = problem_and_discretizer(dim)
    f32 = torch.float32
    t0 = time.perf_counter()
    d, _ = discretize(init_grid_and_problem(cfg or SERVING), device=dev, dtype=f32)
    torch.cuda.synchronize()
    log(f"{label} config: K={d.space.K} N={d.space.N} dofs={d.space.K * d.space.N}; "
        f"discretize {time.perf_counter() - t0:.2f} s")
    mus = np.linspace(0.1, 1.0, B_SERVE)
    thetas = np.stack([np.ones(B_SERVE), mus], 1)
    theta_fs = np.ones((B_SERVE, 1))
    mus_b = {"diffusion": torch.as_tensor(mus[:, None], dtype=f32, device=dev)}
    mu0 = {"diffusion": torch.as_tensor(mus[:1], dtype=f32, device=dev)}

    # ---- the main path: build the step, one single query, one batched call
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    fn = make_online_step(d, tol=1e-6, maxiter=400, coarse_space="harvested",
                          coarse_modes=12, matrix_free="affine")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    U1, ind1 = fn(thetas[0], theta_fs[0], mu0)
    Ub, indb = fn(thetas, theta_fs, mus_b)
    torch.cuda.synchronize()
    launches, shapes = hk.launch_counts(), hk.launch_signature_counts()
    log(f"{label} main path (step build {t_build:.2f} s + 1 single + 1 batched "
        f"B={B_SERVE} call): kernel launches {launches}")

    ind_np = indb.double().cpu().numpy()
    if not (np.isfinite(ind_np).all() and (ind_np >= 0).all()):
        raise AssertionError(f"{label} indicators not finite and non-negative")
    U1_np = U1.double().cpu().numpy()
    Ub_np = Ub.double().cpu().numpy()
    err0 = rel(Ub_np[0], U1_np)
    log(f"{label} lane 0 vs single query: rel err {err0:.3e} (tol 1e-03) "
        f"{'ok' if err0 <= 1e-3 else 'FAIL'}")
    if not err0 <= 1e-3:
        raise AssertionError("batched lane 0 differs from the single query")
    for i in (0, B_SERVE // 3, 2 * B_SERVE // 3, B_SERVE - 1):
        mu_i = {"diffusion": torch.tensor([mus[i]])}
        A = to_scipy_csr(d.assemble(mu_i))
        b = d.rhs(mu_i).double().cpu().numpy().reshape(-1)
        u = spla.splu(A.tocsc()).solve(b)
        err = rel(Ub_np[i].reshape(-1), u)
        log(f"{label} lane {i} (mu={mus[i]:.4f}) vs scipy splu (f64): rel err "
            f"{err:.3e} (tol 1e-03) {'ok' if err <= 1e-3 else 'FAIL'}")
        if not err <= 1e-3:
            raise AssertionError(f"{label} lane {i} off the sparse LU solution")
    for name in BLOCK_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {label} path")

    # ---- measurements (launches here are not counted in the summary)
    reset_peak(torch, dev)
    per_query = timed_median(torch, lambda: fn(thetas, theta_fs, mus_b)) / B_SERVE
    peak = torch.cuda.max_memory_allocated(dev)
    single = timed_median(torch, lambda: fn(thetas[0], theta_fs[0], mu0))
    it_b = fn.iters_probe(thetas, theta_fs)
    it_1 = fn.iters_probe(thetas[0], theta_fs[0])
    log(f"{label} per-query {per_query * 1e3:.4f} ms (median of 5 batched "
        f"B={B_SERVE} calls), single-query {single * 1e3:.3f} ms (median of 5); "
        f"PCG iterations {it_b} (batched, lock-step max) / {it_1} (single); "
        f"peak device memory {peak / 2**20:.1f} MiB [{smi}]")
    ref = {"d": d, "U1": U1_np, "Ub": Ub_np, "iters": (it_b, it_1),
           "args": (thetas, theta_fs, mus_b, mu0)}
    return (launches, shapes), ref


def problem_and_discretizer(dim):
    """(init_grid_and_problem, discretize) of the OS2015 problem: the 2D
    one, or its lift to the 3D hex family (academic3d)."""
    if dim == 3:
        from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem
        from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize
    else:
        from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
        from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    return init_grid_and_problem, discretize


def stencil_apply_phase(torch, dev, d_serving):
    """The stencil apply against the block operator's apply on the card."""
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize

    d_entry, _ = discretize(init_grid_and_problem(ENTRY), device=dev, dtype=torch.float64)
    rng = np.random.default_rng(SEED)
    for name, d, tol in (("entry f64", d_entry, 1e-12), ("serving f32", d_serving, 1e-5)):
        mu = d.parse_parameter(0.5)
        A = d.mf_operator().assemble(d.theta(mu))
        Ab = d.assemble(mu)
        K, N = d.space.K, d.space.N
        for lanes in ((), (4,)):
            x = torch.as_tensor(rng.standard_normal(lanes + (K, N)), dtype=d.dtype, device=dev)
            err = rel(A.apply(x).double().cpu(), Ab.apply(x).double().cpu())
            log(f"stencil apply {name} x{lanes or (1,)} vs block apply: rel err {err:.3e} "
                f"(tol {tol:.0e}) {'ok' if err <= tol else 'FAIL'}")
            if not err <= tol:
                raise AssertionError(f"stencil apply ({name}) disagrees with the block apply")


def stencil_step_phase(hk, torch, dev, smi, ref, label="stencil step"):
    """The reference's default online step at the serving config (the
    stencil form), against the affine step of phase 5 (``ref``)."""
    from pylrbms_tpu_torch.model import make_online_step

    d = ref["d"]
    thetas, theta_fs, mus_b, mu0 = ref["args"]
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    fn = make_online_step(d, tol=1e-6, maxiter=400, coarse_space="harvested", coarse_modes=12)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    U1, ind1 = fn(thetas[0], theta_fs[0], mu0)
    Ub, indb = fn(thetas, theta_fs, mus_b)
    torch.cuda.synchronize()
    launches, shapes = hk.launch_counts(), hk.launch_signature_counts()
    log(f"{label} main path (step build {t_build:.2f} s + 1 single + 1 batched "
        f"B={B_SERVE} call): 'stencils' in step.arrays: {'stencils' in fn.arrays}; "
        f"kernel launches {launches}")
    if "stencils" not in fn.arrays:
        raise AssertionError("make_online_step did not resolve to the stencil form")
    if launches["precond_dot"] <= 0:
        raise AssertionError("precond_dot was not launched on the stencil path")
    lane_kernel = d.mf_operator().lane_kernel
    if lane_kernel and launches[lane_kernel] <= 0:
        raise AssertionError(f"{lane_kernel} was not launched on the {label} path")
    ind_np = np.concatenate([ind1.double().cpu().numpy()[None], indb.double().cpu().numpy()])
    if not (np.isfinite(ind_np).all() and (ind_np >= 0).all()):
        raise AssertionError(f"{label} indicators not finite and non-negative")
    e1 = rel(U1.double().cpu().numpy(), ref["U1"])
    eb = rel(Ub.double().cpu().numpy(), ref["Ub"])
    for name, err in (("single query", e1), (f"B={B_SERVE} lanes", eb)):
        log(f"{label} {name} U vs affine step U: rel err {err:.3e} (tol 1e-03) "
            f"{'ok' if err <= 1e-3 else 'FAIL'}")
        if not err <= 1e-3:
            raise AssertionError(f"{label} ({name}) off the affine step")

    batched = lambda: fn(thetas, theta_fs, mus_b)       # noqa: E731
    reset_peak(torch, dev)
    per_query = timed_median(torch, batched) / B_SERVE
    peak = torch.cuda.max_memory_allocated(dev)
    single = timed_median(torch, lambda: fn(thetas[0], theta_fs[0], mu0))
    it_b = fn.iters_probe(thetas, theta_fs)
    it_1 = fn.iters_probe(thetas[0], theta_fs[0])
    log(f"{label} per-query {per_query * 1e3:.4f} ms (median of 5 batched B={B_SERVE} "
        f"calls), single-query {single * 1e3:.3f} ms (median of 5); PCG iterations "
        f"{it_b} / {it_1} (batched / single; affine step {ref['iters'][0]} / "
        f"{ref['iters'][1]}); peak device memory {peak / 2**20:.1f} MiB [{smi}]")
    return launches, shapes


def scale_solve_phase(hk, torch, dev, smi, cfg=None, label="scale", keep=None):
    """``StationaryBlockModel.solve`` above 32 768 dofs: 'auto' takes the
    matrix-free two-level PCG; then the same solve with ``mixed=True``.
    ``keep`` (a dict) receives the model, mu and the mixed runs' iterations
    for phase 28c."""
    import scipy.sparse.linalg as spla
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.la.block import to_scipy_csr

    t0 = time.perf_counter()
    d, _ = discretize(init_grid_and_problem(cfg or SCALE), device=dev, dtype=torch.float64, lean=True)
    torch.cuda.synchronize()
    dofs = d.space.K * d.space.N
    log(f"{label} config: K={d.space.K} N={d.space.N} dofs={dofs}; discretize "
        f"{time.perf_counter() - t0:.2f} s")
    mu = d.parse_parameter(0.5)
    t0 = time.perf_counter()
    u_ref = spla.splu(to_scipy_csr(d.assemble(mu)).tocsc()).solve(
        d.rhs(mu).double().cpu().numpy().reshape(-1))
    log(f"{label} config scipy splu (f64, host): {time.perf_counter() - t0:.2f} s")

    hk.reset_launch_counts()
    opts = {"precision": 1e-10}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d.prepare_solver(mu, inverse_options=opts)           # the frozen preconditioner
    torch.cuda.synchronize()
    log(f"{label} prepare_solver (block factors + harvested coarse space, frozen at "
        f"mu=0.5): {time.perf_counter() - t0:.2f} s")
    results = {False: [], True: []}
    for mixed in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        U = d.solve(mu, inverse_options=dict(opts, mixed=mixed))   # SolverError if the post-check fails
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
        if d.last_solve_iters is None:
            raise AssertionError("solve 'auto' did not take the mf_pcg path")
        err = rel(U.double().cpu().numpy().reshape(-1), u_ref)
        results[mixed].append((t_solve, int(d.last_solve_iters), err))
    launches, shapes = hk.launch_counts(), hk.launch_signature_counts()
    if keep is not None:
        keep.update(d=d, mu=mu, mixed_iters=[r[1] for r in results[True]])
    log(f"{label} solve main path (prepare_solver + 4 solves): kernel launches {launches}")
    for mixed, runs in results.items():
        kind = "mixed=True" if mixed else "mf_pcg f64"
        err = max(r[2] for r in runs)
        log(f"{label} solve {kind}: {', '.join(f'{r[0]:.3f}' for r in runs)} s (turns "
            f"f64, mixed, mixed, f64), {runs[0][1]} iterations, post-check passed; U vs "
            f"scipy splu rel err {err:.3e} (tol 1e-06) {'ok' if err <= 1e-6 else 'FAIL'} [{smi}]")
        if not err <= 1e-6:
            raise AssertionError(f"{label} solve ({kind}) off the sparse LU solution")
    return launches, shapes


def _spans(T, prefix):
    """``name median (max) ms x calls`` of the timer spans starting with
    ``prefix``."""
    return "; ".join(
        f"{name[len(prefix):].strip()} {1e3 * float(np.median(ts)):.1f} "
        f"({1e3 * max(ts):.1f}) ms x{len(ts)}"
        for name, ts in sorted(T.spans.items()) if name.startswith(prefix))


def _check(name, err, tol):
    log(f"{name}: {err:.3e} (tol {tol:.0e}) {'ok' if err <= tol else 'FAIL'}")
    if not err <= tol:
        raise AssertionError(f"{name}: {err:.3e} > {tol:.0e}")


def _greedy(torch, d, smi, label, extensions=4):
    """The bench's greedy call; prints its spans; returns the result."""
    from pylrbms_tpu_torch.greedy import weak_greedy
    from pylrbms_tpu_torch.utils.timers import GLOBAL_TIMINGS as T

    T.clear()
    T.enable()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = weak_greedy(d, d.parameter_space.sample_uniformly(6), target_error=1e-12,
                      max_extensions=extensions)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    n_it = max(1, res.fom_solves)
    log(f"{label} greedy: {t_all:.2f} s for {len(res.max_etas)} sweeps and {res.fom_solves} "
        f"snapshots ({t_all / n_it:.3f} s per iteration, the initial reduction included); "
        f"max errors {', '.join(f'{e:.3e}' for e in res.max_etas)}; RB size "
        f"{res.rd.solution_dim} (local max {int(res.rd.sizes.max())}, r_max {res.rd.r_max}); "
        f"Gramians {'yes' if res.rd.G_AA is not None else 'no (lean, incremental)'}; "
        f"snapshot Krylov iterations (last) "
        f"{'n/a' if d.last_solve_iters is None else int(d.last_solve_iters)} [{smi}]")
    log(f"{label} greedy spans, median (max) [{smi}]: {_spans(T, 'greedy:')}")
    T.disable()
    return res


def _enrich(torch, gpd, d, red, rd, mus, steps, smi, label, target=1e-2):
    """``AdaptiveEnrichment`` over ``mus`` x ``steps`` from the reduced model
    ``rd`` of ``red``; prints its spans; returns (loop, per-mu eta lists)."""
    from pylrbms_tpu_torch.online_enrichment import AdaptiveEnrichment
    from pylrbms_tpu_torch.utils.timers import GLOBAL_TIMINGS as T

    loop = AdaptiveEnrichment(gpd, d, d.space, red, rd, target_error=target,
                              marking_doerfler_theta=0.33, marking_max_age=4)
    T.clear()
    T.enable()
    all_etas, pcg_its, marks = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for mu in mus:
        etas = []

        def cb(rd, u, mu_, info, etas=etas):
            etas.append(info["eta"])
            if info["local_problem_solves"]:
                marks.append(info["local_problem_solves"])
                pcg_its.append(loop._corrector.last_iters)

        loop.solve(mu, enrichment_steps=steps, callback=cb)
        all_etas.append(etas)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    rounds = max(1, len(marks))
    log(f"{label} enrichment: {t_all:.2f} s for {len(mus)} mus, {len(marks)} rounds "
        f"({t_all / rounds:.3f} s per round); eta per mu "
        f"{[[float(f'{e:.4e}') for e in etas] for etas in all_etas]}; marked per round {marks}; "
        f"corrector PCG iterations per round {pcg_its} "
        f"({'stencil' if loop._corrector is not None and loop._corrector.stencils is not None else 'dense'} "
        f"apply); RB size {loop.rd.solution_dim} (local max {int(loop.rd.sizes.max())}, "
        f"r_max {loop.rd.r_max}) [{smi}]")
    log(f"{label} enrichment spans, median (max) [{smi}]: {_spans(T, 'enrich:')}")
    T.disable()
    return loop, all_etas


def mor_serving_phase(hk, torch, dev, smi, cfg=None, label="MOR serving"):
    """Phase 10: reductor, greedy and adaptive enrichment at the serving
    config in f64."""
    from pylrbms_tpu_torch.reductor import LRBMSReductor

    init_grid_and_problem, discretize = problem_and_discretizer(2)
    gpd = init_grid_and_problem(cfg or SERVING)
    t0 = time.perf_counter()
    d, _ = discretize(gpd, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    log(f"{label} config (f64): K={d.space.K} N={d.space.N} dofs={d.space.K * d.space.N}; "
        f"discretize {time.perf_counter() - t0:.2f} s")
    reset_peak(torch, dev)
    hk.reset_launch_counts()

    # ---- reductor: order 0 + one snapshot, reduce (with Gramians)
    mu = d.parse_parameter(1.0)
    red = LRBMSReductor(d, order=0)
    red.extend_basis(d.solve(mu))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rd = red.reduce()
    torch.cuda.synchronize()
    t_red = time.perf_counter() - t0
    mu2 = d.parse_parameter(0.3)
    t_step = timed_median(torch, lambda: rd.online_step(mu2), reps=3)
    log(f"{label} reduce (full, with Gramians, r_max {rd.r_max}): {t_red:.3f} s; "
        f"rd.online_step {t_step * 1e3:.2f} ms (median of 3) [{smi}]")
    _rom_gates(torch, d, rd, red, mu2, label)

    # ---- adaptive enrichment from that reduced model (order 0 + the
    # snapshot at mu = 1, the flow of scripts/online_adaptive_lrbms.py)
    mus = d.parameter_space.sample_randomly(3, seed=7)
    loop, all_etas = _enrich(torch, gpd, d, red, rd, mus, 3, smi, label)
    _enrich_gates(loop, all_etas)
    _corrector_check(d, loop, d.parse_parameter(mus[0]), label)
    del loop, red, rd

    # ---- greedy (its own reductor)
    res = _greedy_gates(torch, d, smi, label, 4)
    torch.cuda.synchronize()
    launches, shapes = hk.launch_counts(), hk.launch_signature_counts()
    log(f"{label} main path: kernel launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB [{smi}]")
    for name in BLOCK_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {label} path")
    return launches, shapes


def _enrich_gates(loop, all_etas):
    """At least one enrichment round ran; eta not increasing a step (to 1%:
    the estimate is not monotone under Galerkin enrichment, as the
    reference's own test allows, and near its discretization floor it
    wiggles in the 4th digit)."""
    if loop._corrector is None:
        raise AssertionError("no enrichment round ran: eta met the target at once")
    for etas in all_etas:
        if not all(b <= 1.01 * a for a, b in zip(etas, etas[1:])):
            raise AssertionError(f"enrichment eta increased: {etas}")


def _corrector_check(d, loop, mu, label, **kw):
    """One batch of the enrichment's corrector (Doerfler 0.33 on the ROM's
    indicators at ``mu``) against the dense patch solve (1e-6); ``kw`` go
    to the corrector's solve."""
    from pylrbms_tpu_torch.online_enrichment import doerfler_marking
    c, _, ind = loop.rd.online_step(mu)
    marked = sorted(doerfler_marking(ind, 0.33))
    u_full = loop.rd.reconstruct(c)
    W = loop._corrector.solve(marked, mu, current_solution=u_full, **kw)
    for i in sorted({0, len(marked) - 1}):
        w = d.solve_for_local_correction(marked[i], None, mu, current_solution=u_full)
        _check(f"{label} batched corrector ({len(marked)} marked, "
               f"{loop._corrector.last_iters} PCG iterations) vs dense patch solve, "
               f"subdomain {marked[i]}, rel err", rel(W[i].cpu(), w.cpu()), 1e-6)


def _greedy_gates(torch, d, smi, label, extensions):
    """``_greedy`` with the Gramian residual, its max error falling tenfold
    and one snapshot per extension."""
    res = _greedy(torch, d, smi, label, extensions)
    if res.rd.G_AA is None:
        raise AssertionError(f"the {label} greedy should use the Gramian residual")
    if not res.max_etas[-1] <= 0.1 * res.max_etas[0]:
        raise AssertionError(f"greedy max error did not fall tenfold: {res.max_etas}")
    if res.fom_solves != extensions:
        raise AssertionError(f"greedy made {res.fom_solves} snapshot solves, expected "
                             f"{extensions}")
    return res


def _rom_gates(torch, d, rd, red, mu, label):
    """ROM estimate = FOM estimate of the reconstruction (1e-8) and
    ``residual_norm`` = the true residual norm (1e-6) at ``mu``."""
    c = rd.solve(mu)
    U_rec = red.reconstruct(c)
    eta_r, _, ind_r = rd.estimate(c, mu, decompose=True)
    eta_f, _, ind_f = d.estimate(U_rec, mu, decompose=True)
    _check(f"{label} ROM estimate vs FOM estimate of the reconstruction, rel err",
           abs(float(eta_r) - float(eta_f)) / abs(float(eta_f)), 1e-8)
    _check(f"{label} ROM indicators vs FOM indicators, rel err",
           rel(ind_r.cpu(), ind_f.cpu()), 1e-8)
    r_true = float(torch.linalg.norm((d.rhs(mu) - d.assemble(mu).apply(U_rec)).reshape(-1)))
    _check(f"{label} residual_norm vs the true residual norm, rel err",
           abs(float(rd.residual_norm(c, mu)) - r_true) / r_true, 1e-6)


def mor_scale_phase(hk, torch, dev, smi, cfg=None):
    """Phase 11: the greedy and one enrichment at 98 304 dofs in f64."""
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.online_enrichment import doerfler_marking

    gpd = init_grid_and_problem(cfg or NORTH_STAR)
    t0 = time.perf_counter()
    d, _ = discretize(gpd, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    log(f"MOR scale config (f64): K={d.space.K} N={d.space.N} dofs={d.space.K * d.space.N}; "
        f"discretize {time.perf_counter() - t0:.2f} s")
    reset_peak(torch, dev)
    hk.reset_launch_counts()

    res = _greedy(torch, d, smi, "MOR scale")
    if res.rd.G_AA is not None or d.last_solve_iters is None:
        raise AssertionError("the scale greedy should take the lean projection and mf_pcg")
    if not res.max_etas[-1] < res.max_etas[0]:
        raise AssertionError(f"greedy max error did not fall: {res.max_etas}")

    # the ROM against a FOM solve at a training mu: the relative l2 error is
    # held to the last max error (a residual norm over the training set,
    # taken before the last extension) relative to ||b||, scale 1; the
    # measured ratio is printed
    mu = d.parse_parameter(d.parameter_space.sample_uniformly(6)[2])
    U_fom = d.solve(mu, inverse_options={"precision": 1e-10})
    U_rom = res.reductor.reconstruct(res.rd.solve(mu))
    err = float(torch.linalg.norm(U_rom - U_fom) / torch.linalg.norm(U_fom))
    bnorm = float(torch.linalg.norm(d.rhs(mu)))
    bound = res.max_etas[-1] / bnorm
    log(f"MOR scale ROM vs FOM solve at mu={float(mu['diffusion']):.2f}: rel l2 err {err:.3e}; "
        f"last max error / ||b|| = {res.max_etas[-1] / bnorm:.3e} (ratio "
        f"{err / bound:.2e}, limit 1) {'ok' if err <= bound else 'FAIL'}")
    if not err <= bound:
        raise AssertionError("the greedy's ROM is off the FOM solve")

    mus = d.parameter_space.sample_randomly(1, seed=7)
    # target 1e-12: below the discretization floor of eta, so both steps run
    loop, all_etas = _enrich(torch, gpd, d, res.reductor, res.rd, mus, 2, smi, "MOR scale",
                             target=1e-12)
    if loop._corrector is None or loop._corrector.stencils is None:
        raise AssertionError("the scale corrector should take the stencil apply")
    mu3 = d.parse_parameter(mus[0])
    c, eta, ind_t = loop.rd.online_step(mu3)
    ind = ind_t.cpu().numpy()
    if not (np.isfinite(ind).all() and (ind >= 0).all() and np.isfinite(float(eta))):
        raise AssertionError("scale indicators not finite and non-negative")

    # ---- one stencil corrector batch against the dense patch solve
    marked = sorted(doerfler_marking(ind_t, 0.33))
    u_full = loop.rd.reconstruct(c)
    W = loop._corrector.solve(marked, mu3, current_solution=u_full)
    for i in sorted({0, len(marked) - 1}):
        w = d.solve_for_local_correction(marked[i], None, mu3, current_solution=u_full)
        _check(f"MOR scale stencil corrector ({len(marked)} marked, "
               f"{loop._corrector.last_iters} PCG iterations) vs dense patch solve, "
               f"subdomain {marked[i]}, rel err", rel(W[i].cpu(), w.cpu()), 1e-6)
    torch.cuda.synchronize()
    launches, shapes = hk.launch_counts(), hk.launch_signature_counts()
    log(f"MOR scale main path: kernel launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB [{smi}]")
    if launches["precond_dot"] <= 0:
        raise AssertionError("precond_dot was not launched on the MOR scale path")
    return launches, shapes


def _launched_both(hk, label):
    launches, shapes = hk.launch_counts(), hk.launch_signature_counts()
    log(f"{label} main path: kernel launches {launches}")
    for name in BLOCK_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {label} path")
    return launches, shapes


def host_implicit_euler(torch, im, mu, dt):
    """The final step of the implicit-Euler trajectory of ``im`` at ``mu``
    (time-independent rhs) by one scipy splu on the host, and the host's ms
    per step (the factorization included)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from pylrbms_tpu_torch.la.block import to_scipy_csr

    st = im.stationary
    K, N = st.space.K, st.space.N
    Q = st.op.A_diag.shape[0]
    A_q = [to_scipy_csr(st.op.assemble(torch.eye(Q, dtype=torch.float64, device=st.device)[q]))
           for q in range(Q)]
    th = st.theta(mu).cpu().numpy()
    b = st.rhs(mu).double().cpu().numpy().reshape(-1)
    M_np = im.mass.cpu().numpy()
    M_csr = sp.block_diag([sp.csr_matrix(M_np[k]) for k in range(K)], format="csr")
    t0 = time.perf_counter()
    lu = spla.splu((M_csr + dt * sum(float(t) * Aq for t, Aq in zip(th, A_q))).tocsc())
    u = np.zeros(K * N)
    for _ in range(im.nt):
        u = lu.solve(M_csr @ u + dt * b)
    return u, (time.perf_counter() - t0) / im.nt * 1e3


def parabolic_scale_phase(hk, torch, dev, smi, cfg=None, nt=10, B=16):
    """Phase 12: the parabolic FOM and its snapshot ROM at 98 304 dofs."""
    from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize
    from pylrbms_tpu_torch.reductor import ParabolicLRBMSReductor

    gpd = init_grid_and_problem(cfg or NORTH_STAR, raster=(8, 8), raster_mode="nearest",
                                max_contrast=1e4)
    t0 = time.perf_counter()
    im, _ = discretize(gpd, T=1.0, nt=nt, device=dev, dtype=torch.float64)
    st = im.stationary
    K, N = st.space.K, st.space.N
    torch.cuda.synchronize()
    log(f"parabolic scale config (SPE10, f64): K={K} N={N} dofs={K * N}, nt={nt}; discretize "
        f"{time.perf_counter() - t0:.2f} s")
    dt = 1.0 / nt
    mu0 = im.parse_parameter([1.0])
    reset_peak(torch, dev)
    hk.reset_launch_counts()

    # ---- the FOM trajectory (bench.py's parabolic leg)
    t0 = time.perf_counter()
    traj, its = im._solve_mf(mu0, dt, two_level=True, coarse_modes=12, return_iters=True)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj = im._solve_mf(mu0, dt, two_level=True, coarse_modes=12)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    step_ms = float(np.median(ts)) / nt * 1e3
    log(f"parabolic trajectory (mf, two-level, 12 harvested modes): {step_ms:.3f} ms/step "
        f"(median of 3; runs {', '.join(f'{t:.3f}' for t in ts)} s); first call {t_first:.2f} s "
        f"with the coarse freeze; PCG iterations per step {its.tolist()} [{smi}]")
    u, host_ms = host_implicit_euler(torch, im, mu0, dt)
    _check(f"parabolic final step vs host scipy splu implicit Euler ({host_ms:.1f} ms/step "
           f"factorize included), max rel err", rel(traj[-1].cpu().numpy().reshape(-1), u), 1e-6)
    U_auto = im.solve(mu0)
    _check("parabolic solve 'auto' (mf, 16 modes) vs the 12-mode trajectory, rel err",
           rel(U_auto.cpu(), traj.cpu()), 1e-6)

    # ---- B trajectories in one call, the preconditioner shared
    lo, hi = st.parameter_space.minimum, st.parameter_space.maximum
    mus = [im.parse_parameter([m]) for m in np.linspace(lo, hi, B)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Ub = im.solve_batch(mus)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    its_b = im.last_solve_iters
    errs = []
    for b, m in enumerate(mus):
        U1 = im._solve_mf(m, dt)
        errs.append(float(torch.linalg.norm(Ub[b] - U1) / torch.linalg.norm(U1)))
    log(f"parabolic solve_batch B={B} (shared block factors at mu_bar): {t_b:.3f} s = "
        f"{t_b / nt / B * 1e3:.3f} ms per step per mu; lock-step PCG iterations per step "
        f"{its_b.max(dim=0).values.tolist()} [{smi}]")
    _check(f"parabolic solve_batch lanes vs single-mu trajectories, max rel l2 err",
           max(errs), 1e-6)

    # ---- the snapshot ROM (scripts/spe10_parabolic.py --rom)
    sel = np.unique(np.linspace(0, nt, 8).astype(int))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    red = ParabolicLRBMSReductor(st)
    red.extend_basis(traj[torch.as_tensor(sel, device=dev)])
    rd = red.reduce().attach_instationary(im)
    torch.cuda.synchronize()
    t_red = time.perf_counter() - t0
    t_rom = timed_median(torch, lambda: rd.solve(mu0), reps=3)
    c = rd.solve(mu0)
    err = float(torch.linalg.norm(red.reconstruct(c) - traj) / torch.linalg.norm(traj))
    t_est = timed_median(torch, lambda: rd.estimate(c, mu0, projected=True), reps=3)
    eta_p, _ = rd.estimate(c, mu0, projected=True)
    eta_r, _ = rd.estimate(c, mu0, projected=False)
    log(f"parabolic ROM: {len(sel)} snapshots, reduce {t_red:.2f} s (r_max {rd.r_max}, "
        f"{K * rd.r_max} reduced dofs); ROM trajectory {t_rom * 1e3:.2f} ms, projected estimate "
        f"{t_est * 1e3:.2f} ms, eta {float(eta_p):.6e}; ROM vs FOM trajectory rel l2 err "
        f"{err:.3e}; peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB "
        f"[{smi}]")
    if not err < 1e-2:
        raise AssertionError(f"the snapshot ROM is off its own trajectory: {err:.3e}")
    _check("parabolic ROM projected vs unprojected estimate, rel err",
           abs(float(eta_p) - float(eta_r)) / abs(float(eta_r)), 1e-8)
    torch.cuda.synchronize()
    return _launched_both(hk, "parabolic scale")


def parabolic_serving_phase(hk, torch, dev, smi, cfg=None, nt=20):
    """Phase 13: artificial channels at the serving grid: the block-PCG
    trajectory, its estimate, parabolic enrichment and the POD-greedy."""
    from pylrbms_tpu_torch.problems.artificial_channels import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize
    from pylrbms_tpu_torch.greedy import pod_greedy
    from pylrbms_tpu_torch.online_enrichment import ParabolicAdaptiveEnrichment
    from pylrbms_tpu_torch.reductor import ParabolicLRBMSReductor
    from pylrbms_tpu_torch.utils.timers import GLOBAL_TIMINGS as T

    t0 = time.perf_counter()
    im, _ = discretize(init_grid_and_problem(cfg or SERVING), T=1.0, nt=nt, device=dev,
                       dtype=torch.float64)
    st = im.stationary
    K, N = st.space.K, st.space.N
    torch.cuda.synchronize()
    log(f"parabolic serving config (artificial channels, f64): K={K} N={N} dofs={K * N}, "
        f"nt={nt}; discretize {time.perf_counter() - t0:.2f} s")
    mu = im.parameter_space.sample_randomly(1, seed=11)[0]
    reset_peak(torch, dev)
    hk.reset_launch_counts()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U = im.solve(mu)
    torch.cuda.synchronize()
    t_fom = time.perf_counter() - t0
    if im.last_solve_iters is None:
        raise AssertionError("the serving trajectory should take the block-PCG route")
    t0 = time.perf_counter()
    eta, parts = im.estimate(U, mu)
    torch.cuda.synchronize()
    t_est = time.perf_counter() - t0
    names = ("nc", "r", "df", "time residual", "time-derivative nc")
    log(f"parabolic serving trajectory at switch={float(mu['switch'][0]):.4f} (block PCG): "
        f"{t_fom:.3f} s ({t_fom / nt * 1e3:.2f} ms/step), PCG iterations per step "
        f"{im.last_solve_iters.tolist()}; estimate {t_est:.3f} s, eta {float(eta):.6e}, "
        f"groups {', '.join(f'{n} {float(torch.linalg.norm(p)):.3e}' for n, p in zip(names, parts))} "
        f"[{smi}]")
    for n, p in zip(names, parts):
        if not (bool(torch.isfinite(p).all()) and bool((p >= 0).all())):
            raise AssertionError(f"parabolic estimate group {n} not finite and non-negative")

    # ---- parabolic adaptive enrichment from the order-0 basis
    T.clear()
    T.enable()
    red = ParabolicLRBMSReductor(st, order=0)
    loop = ParabolicAdaptiveEnrichment(im, red, red.reduce().attach_instationary(im),
                                       target_error=0.0, marking_doerfler_theta=0.33)
    hist = []

    def cb(rd, c, mu_, info):
        err = float(torch.linalg.norm(red.reconstruct(c) - U) / torch.linalg.norm(U))
        hist.append((info["eta"], err, info["local_problem_solves"],
                     None if loop._corrector is None else loop._corrector.last_iters))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.solve(mu, enrichment_steps=3, callback=cb)
    torch.cuda.synchronize()
    t_enr = time.perf_counter() - t0
    log(f"parabolic enrichment: {t_enr:.2f} s for 3 rounds ({t_enr / 3:.3f} s per round); "
        f"(eta, ROM vs FOM rel l2 err, marked, corrector PCG iterations) per step "
        f"{[(float(f'{e:.4e}'), float(f'{r:.4e}'), m, i) for e, r, m, i in hist]}; RB size "
        f"{loop.rd.solution_dim} [{smi}]")
    log(f"parabolic enrichment spans, median (max) [{smi}]: {_spans(T, 'parabolic enrich:')}")
    T.disable()
    if not hist[-1][1] < hist[0][1]:
        raise AssertionError(f"the enriched ROM's error did not fall: {hist}")

    # ---- POD-greedy, host Gram-Schmidt, then the batched one
    train = im.parameter_space.sample_uniformly(5)
    runs = {}
    for batched in (False, True):
        T.clear()
        T.enable()
        ParabolicLRBMSReductor.batched_gs = batched
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pod_greedy(im, train, target_error=1e-6, max_extensions=3, pod_modes=2)
            torch.cuda.synchronize()
            t_pod = time.perf_counter() - t0
        finally:
            ParabolicLRBMSReductor.batched_gs = False
        runs[batched] = res
        n_it = max(1, res.fom_solves)
        label = "batched_gs=True" if batched else "host Gram-Schmidt"
        log(f"POD-greedy ({label}): {t_pod:.2f} s for {len(res.max_etas)} sweeps and "
            f"{res.fom_solves} FOM trajectories ({t_pod / n_it:.3f} s per iteration, the "
            f"initial reduction included); max estimates "
            f"{', '.join(f'{e:.4e}' for e in res.max_etas)}; RB size "
            f"{int(res.reductor.basis_sizes().sum())} (r_max {res.rd.r_max}) [{smi}]")
        log(f"POD-greedy ({label}) spans, median (max) [{smi}]: {_spans(T, 'pod-greedy:')}")
        T.disable()
    res, res_b = runs[False], runs[True]
    if not res.max_etas[-1] < res.max_etas[0]:
        raise AssertionError(f"POD-greedy max estimate did not fall: {res.max_etas}")
    _check("POD-greedy batched_gs vs host Gram-Schmidt max estimates, max rel diff",
           rel(res_b.max_etas, res.max_etas), 1e-6)
    torch.cuda.synchronize()
    log(f"parabolic serving peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB [{smi}]")
    return _launched_both(hk, "parabolic serving")


# the reference's golden triple (BASELINE.md; its crisscross decomposition
# script), as the JAX package reproduces it (tests/test_crisscross.py)
GOLDEN = (1.656117e-01, 1.446952e-01, 3.548075e-01)
GOLDEN_CFG = {"num_subdomains": [4, 4], "half_num_fine_elements_per_subdomain_and_dim": 1,
              "num_refinements": 1, "grid_type": "crisscross"}
CC_SERVING = dict(SERVING, grid_type="crisscross")
CC_SCALE = dict(SCALE, grid_type="crisscross")


def golden_phase(torch, dev):
    """Phase 14: eta_nc / eta_r / eta_df of the reference's own config on
    the crisscross family (paper convention: square roots of the summed
    local quantities) on the card, against the reference's numbers and the
    port on the CPU."""
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize

    def triple(device):
        d, _ = discretize(init_grid_and_problem(GOLDEN_CFG), device=device)
        mu = d.parse_parameter(1.0)
        quantities = d.estimator.local_quantities(d.solve(mu)[None], mu)
        return np.array([float(torch.sqrt(torch.clamp(v[0], min=0).sum())) for v in quantities])

    card, cpu = triple(dev), triple("cpu")
    for name, v, ref in zip(("eta_nc", "eta_r", "eta_df"), card, GOLDEN):
        _check(f"golden triple {name} on the card {v:.6e} vs the reference's {ref:.6e}, rel err",
               abs(v - ref) / ref, 1e-4)
    _check("golden triple on the card vs the port on the CPU, max rel err", rel(card, cpu), 1e-10)


def rt_conservation_error(torch, d, U, mu):
    """max over elements of |int_T div t - int_T f| / max |int_T f| for the
    reconstructed flux t of U (RT0 or RT1, the space's degree): SWIPDG
    tested with the element's indicator makes it rounding for a solved U."""
    from pylrbms_tpu_torch.ops import assembly as asm
    from pylrbms_tpu_torch.ops.rt1 import rt_tab_any_order
    from pylrbms_tpu_torch.parameters import evaluate_coefficients

    ed = d.estimator.data
    sp = ed.flux.space
    t = d.estimator.reconstruct_flux(U, mu)                  # [K, Nrt]
    _chi, idx, div_q, _ = rt_tab_any_order(sp)
    nf = idx.shape[-1]
    t_cell = t[:, torch.as_tensor(idx.reshape(-1), device=t.device)].reshape(
        sp.K, sp.s, sp.s, sp.T, nf)
    w = asm.tensor(sp.vol_w, t.dtype, t.device)
    area = sp.hx * sp.hy
    div_int = area * torch.einsum(asm.vol_ein(sp, "tq,kyxte,tqe->kyxt"), w, t_cell,
                                  asm.tensor(div_q, t.dtype, t.device))
    xq = asm.tensor(asm.vol_points(sp), t.dtype, t.device)
    theta_f = evaluate_coefficients(ed.f_coeffs, mu, dtype=t.dtype, device=t.device)
    f_mu = sum(c * ff(xq).to(t.dtype) for c, ff in zip(theta_f, ed.f_funcs))
    f_int = area * torch.einsum(asm.vol_ein(sp, "tq,kyxtq->kyxt"), w, f_mu)
    return float((div_int - f_int).abs().max() / f_int.abs().max())


def order2_phase(hk, torch, dev, smi):
    """Phase 16: P2 on 'tri' at the serving grid (K=64, N=768), lean: solve
    'auto' (the matrix-free PCG through the order-2 stencil) against splu,
    the positive-form estimate and the RT1 local conservation; then
    crisscross P2 and quad Q2 at the entry config, card against CPU."""
    import scipy.sparse.linalg as spla
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.la.block import to_scipy_csr

    t0 = time.perf_counter()
    d, _ = discretize(init_grid_and_problem(SERVING), device=dev, dtype=torch.float64,
                      lean=True, order=2)
    torch.cuda.synchronize()
    K, N = d.space.K, d.space.N
    log(f"order 2 config (P2 tri, lean, f64): K={K} N={N} dofs={K * N}; discretize "
        f"{time.perf_counter() - t0:.2f} s")
    mu = d.parse_parameter(0.5)
    t0 = time.perf_counter()
    u_ref = spla.splu(to_scipy_csr(d.assemble(mu)).tocsc()).solve(
        d.rhs(mu).double().cpu().numpy().reshape(-1))
    t_lu = time.perf_counter() - t0
    hk.reset_launch_counts()
    opts = {"precision": 1e-10}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U = d.solve(mu, inverse_options=opts)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    if d.last_solve_iters is None:
        raise AssertionError("order-2 solve 'auto' did not take the mf_pcg path")
    t_solve = timed_median(torch, lambda: d.solve(mu, inverse_options=opts), reps=3)
    eta, (nc, r, df), ind = d.estimate(U, mu, decompose=True)
    torch.cuda.synchronize()
    launches, shapes = hk.launch_counts(), hk.launch_signature_counts()
    t_est = timed_median(torch, lambda: d.estimate(U, mu), reps=3)
    log(f"order 2 main path (solve + estimate): kernel launches {launches}")
    log(f"order 2 solve 'auto' (mf_pcg, precision 1e-10): {t_solve:.3f} s (median of 3; first "
        f"{t_first:.2f} s with the preconditioner), {int(d.last_solve_iters)} iterations; "
        f"scipy splu {t_lu:.2f} s; estimate {t_est * 1e3:.1f} ms, eta {float(eta):.6e} "
        f"(nc {float(torch.linalg.norm(nc)):.3e}, r {float(torch.linalg.norm(r)):.3e}, "
        f"df {float(torch.linalg.norm(df)):.3e}) [{smi}]")
    _check("order 2 solve vs scipy splu, rel err", rel(U.cpu().numpy().reshape(-1), u_ref), 1e-6)
    ind_np = ind.cpu().numpy()
    if not (np.isfinite(ind_np).all() and (ind_np >= 0).all() and float(eta) > 0):
        raise AssertionError("order-2 indicators not finite and non-negative")
    U_ref = torch.as_tensor(u_ref.reshape(K, N), device=dev)
    _check("order 2 RT1 local conservation of the splu solution, max rel err",
           rt_conservation_error(torch, d, U_ref, mu), 1e-9)
    if launches["precond_dot"] <= 0:
        raise AssertionError("precond_dot was not launched on the order-2 path")

    for gt in ("crisscross", "quad"):
        outs = []
        for device in (dev, "cpu"):
            m, _ = discretize(init_grid_and_problem(dict(ENTRY, grid_type=gt)), device=device,
                              order=2)
            mu_m = m.parse_parameter(0.5)
            Um = m.solve(mu_m)
            eta_m, _, ind_m = m.estimate(Um, mu_m, decompose=True)
            outs.append((Um.cpu(), ind_m.cpu(), float(eta_m)))
        (U1, i1, e1), (U0, i0, e0) = outs
        _check(f"order 2 {gt} (nb={m.space.nb}, N={m.space.N}) card vs CPU: U, indicators, "
               f"eta max rel err", max(rel(U1, U0), rel(i1, i0), abs(e1 - e0) / e0), 1e-10)
    return launches, shapes


def eoc_phase(torch, dev, smi):
    """Phase 17: the paper-convention StationaryEocStudy (OS2015, 2x2
    subdomains, half 1, nref 1, p_ref 2, one refinement) on tri and
    crisscross on the card, against the port on the CPU; then a small
    InstationaryEocStudy (thermal block, dt halved per level)."""
    import math
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.problems.thermalblock import init_grid_and_problem as thermalblock
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize as parabolic
    from pylrbms_tpu_torch.EOC import InstationaryEocStudy, StationaryEocStudy, default_refine

    columns = ("h", "elliptic_mu_bar", "eta_nc", "eta_r", "eta_df", "eta")

    def flat(data):
        return np.array([v for lvl in sorted(data) for g in ("norm", "indicator", "estimate")
                         for v in data[lvl][g].values()])

    for gt in ("tri", "crisscross"):
        def run(device):
            return StationaryEocStudy(
                init_grid_and_problem, lambda g: discretize(g, device=device),
                dict(ENTRY, grid_type=gt), default_refine, mu=1, p_ref=2, max_levels=1,
                paper_convention=True, device=device).run(columns)

        t0 = time.perf_counter()
        data = run(dev)
        t_card = time.perf_counter() - t0
        _check(f"EOC {gt} ({t_card:.2f} s on the card) table vs the port on the CPU, max rel err",
               rel(flat(data), flat(run("cpu"))), 1e-8)
        for ind in ("eta_nc", "eta_r", "eta_df"):
            rate = math.log(data[1]["indicator"][ind] / data[0]["indicator"][ind]) / math.log(0.5)
            log(f"EOC {gt} {ind}: {rate:.3f} (gate (0.7, 1.4)) "
                f"{'ok' if 0.7 < rate < 1.4 else 'FAIL'}")
            if not 0.7 < rate < 1.4:
                raise AssertionError(f"EOC {gt} {ind} {rate:.3f} not first order")
        effs = [data[lvl]["norm"]["elliptic_mu_bar"] / data[lvl]["estimate"]["eta"]
                for lvl in (0, 1)]
        _check(f"EOC {gt} efficiency {effs[0]:.4f} -> {effs[1]:.4f}, relative change",
               abs(effs[1] / effs[0] - 1.0), 0.25)

    def refine_dt(c):
        out = default_refine(c)
        out["dt"] = c["dt"] / 2
        return out

    def disc(gpd, T, nt):
        im, data = parabolic(gpd, T, nt, device=dev)
        return im, {"block_space": data["block_space"]}

    base = dict(ENTRY, num_refinements=0, T=0.5, dt=0.125)
    t0 = time.perf_counter()
    study = InstationaryEocStudy(thermalblock, disc, base, refine_dt, refine_dt(refine_dt(base)),
                                 mu=(1, 1, 1, 1), max_levels=1, device=dev)
    data = study.run(("h", "dt", "L2 - L2", "L2 - elliptic_mu_bar", "eta_nc", "eta_r",
                      "eta_df", "R_T", "partial_t_nc", "eta"))
    vals = flat(data)
    log(f"instationary EOC: {time.perf_counter() - t0:.2f} s on the card [{smi}]")
    if not (np.isfinite(vals).all() and (vals >= 0).all()):
        raise AssertionError("instationary EOC table not finite and non-negative")
    if not data[1]["norm"]["L2 - L2"] < data[0]["norm"]["L2 - L2"]:
        raise AssertionError("instationary EOC: the error did not fall")


def halo_phase(hk, torch, dev, smi, cfg=None, nt=10):
    """Phase 18a: phase 12's SPE10 trajectory in mixed precision with the
    halo-dense f32 inner operator against the stencil one, each final step
    against a host splu implicit Euler."""
    from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize

    gpd = init_grid_and_problem(cfg or NORTH_STAR, raster=(8, 8), raster_mode="nearest",
                                max_contrast=1e4)
    im, _ = discretize(gpd, T=1.0, nt=nt, device=dev, dtype=torch.float64)
    K, N = im.stationary.space.K, im.stationary.space.N
    dt = 1.0 / nt
    mu0 = im.parse_parameter([1.0])
    u, host_ms = host_implicit_euler(torch, im, mu0, dt)
    log(f"halo config (SPE10, f64, mixed): K={K} N={N} dofs={K * N}, nt={nt}; host splu "
        f"{host_ms:.1f} ms/step")
    reset_peak(torch, dev)
    hk.reset_launch_counts()
    kw = dict(two_level=True, coarse_modes=12, precision="mixed")
    runs = {}
    for inner in ("halo", "stencil"):
        traj, its = im._solve_mf(mu0, dt, inner=inner, return_iters=True, **kw)
        runs[inner] = (traj, its)
    torch.cuda.synchronize()
    launches, shapes = hk.launch_counts(), hk.launch_signature_counts()
    log(f"halo main path (the mixed trajectory, halo then stencil inner): kernel launches "
        f"{launches}")
    for inner in ("halo", "stencil", "halo", "stencil"):
        step = timed_median(torch, lambda: im._solve_mf(mu0, dt, inner=inner, **kw), reps=1)
        runs[inner] += (step / nt * 1e3,)
    for inner, (traj, its, *ms) in runs.items():
        log(f"mixed trajectory inner={inner}: {', '.join(f'{m:.3f}' for m in ms)} ms/step (turns "
            f"halo, stencil, halo, stencil); iterations per step (f32 + f64) {its.tolist()}; "
            f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB [{smi}]")
        _check(f"mixed trajectory inner={inner} final step vs host scipy splu, max rel err",
               rel(traj[-1].cpu().numpy().reshape(-1), u), 1e-6)
    if launches["precond_dot"] <= 0:
        raise AssertionError("precond_dot was not launched on the halo path")
    return launches, shapes


def banded_phase(torch, dev, smi):
    """Phase 18b: the banded apply against the stencil and block applies at
    the serving tri config in f64."""
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.ops.banded import banded_operator

    d, _ = discretize(init_grid_and_problem(SERVING), device=dev, dtype=torch.float64)
    theta = d.theta(d.parse_parameter(0.5))
    t0 = time.perf_counter()
    bop = banded_operator(d.space, d.op)
    bands = bop.assemble(theta)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    A_st = d.mf_operator().assemble(theta)
    A_bl = d.assemble(d.parse_parameter(0.5))
    rng = np.random.default_rng(SEED)
    for lanes in ((), (16,)):
        x = torch.as_tensor(rng.standard_normal(lanes + (d.space.K, d.space.N)), device=dev)
        y_b = bop.apply(bands, x)
        _check(f"banded apply x{lanes or (1,)} ({len(bop.offsets)} bands) vs stencil apply, "
               f"rel err", rel(y_b.cpu(), A_st.apply(x).cpu()), 1e-12)
        ms = {name: cuda_ms(fn) for name, fn in (("banded", lambda: bop.apply(bands, x)),
                                                 ("stencil", lambda: A_st.apply(x)),
                                                 ("block", lambda: A_bl.apply(x)))}
        log(f"apply x{lanes or (1,)} f64 at {d.space.K * d.space.N} dofs: "
            f"{', '.join(f'{k} {v:.4f} ms' for k, v in ms.items())} (CUDA events, median of "
            f"20); banded build {t_build:.2f} s [{smi}]")


# ---------------------------------------------------------------------------
# the 3D hex family (phases 19-24)
# ---------------------------------------------------------------------------

# academic3d golden triples (tests/test_scripts.py): eta, |nc|, |r|, |df|,
# paper convention, mu = 0.5, 2x2x2 subdomains, half 1
GOLDEN3 = {1: ((2.669043e+00, 8.099561e-02, 1.546472e+00, 1.041575e+00), 1),
           2: ((1.010787e+00, 1.879885e-02, 6.276844e-01, 3.643033e-01), 0)}
SERVING3D = {"num_subdomains": [4, 4, 4], "half_num_fine_elements_per_subdomain_and_dim": 1,
             "num_refinements": 2}                  # K=64, N=512, 32 768 dofs
SCALE3D = {"num_subdomains": [8, 8, 4], "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 2}                    # K=256, N=512, 131 072 dofs
MOR3D = {"num_subdomains": [4, 4, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": 2}                      # K=32, N=512, 16 384 dofs
Q2_3D = {"num_subdomains": [4, 4, 4], "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": 1}                      # Q2: K=64, N=216, 13 824 dofs


def spe10_3d(cfg):
    """SPE10 model 2, z-layers 40-44 (the synthetic block), contrast 1e4."""
    from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem_3d
    return init_grid_and_problem_3d(cfg, layers=(40, 44), max_contrast=1e4)


def golden3d_phase(torch, dev):
    """Phase 19: the academic3d golden triples (Q1 nref 1, Q2 nref 0) on
    the card against GOLDEN3 (rel 1e-5) and the port on the CPU (1e-12)."""
    init_grid_and_problem, discretize = problem_and_discretizer(3)
    mu = {"diffusion": 0.5}
    for order, (ref, nref) in GOLDEN3.items():
        def run(device):
            cfg = {"num_subdomains": [2, 2, 2],
                   "half_num_fine_elements_per_subdomain_and_dim": 1, "num_refinements": nref}
            d, _ = discretize(init_grid_and_problem(cfg), device=device, order=order)
            eta, parts, _ = d.estimate(d.solve(mu), mu, decompose=True, paper_convention=True)
            return np.array([float(eta)] + [float(torch.linalg.norm(p)) for p in parts])

        card, cpu = run(dev), run("cpu")
        for name, v, g in zip(("eta", "nc", "r", "df"), card, ref):
            _check(f"golden 3D Q{order} {name} on the card {v:.6e} vs {g:.6e}, rel err",
                   abs(v - g) / g, 1e-5)
        _check(f"golden 3D Q{order} card vs the port on the CPU, max rel err", rel(card, cpu),
               1e-12)


def scale3d_phase(hk, torch, dev, smi):
    """Phase 21: SPE10 3D at 131 072 dofs (8x8x4, half 1, nref 2, f64,
    lean): mf_pcg (harvested, 12 modes, precision 1e-8), then mixed=True,
    then the positive-form estimate.  Gates: relative f64 residual <= 1e-7,
    the stencil apply = the assembled block apply on U (1e-12 of the
    |.|-sum |A| |U|).  Returns the
    path's launches and the model (phase 23 reuses it)."""
    _, discretize = problem_and_discretizer(3)
    t0 = time.perf_counter()
    d, _ = discretize(spe10_3d(SCALE3D), device=dev, dtype=torch.float64, lean=True)
    torch.cuda.synchronize()
    K, N = d.space.K, d.space.N
    log(f"3D scale config (SPE10 3D, f64, lean): K={K} N={N} dofs={K * N}; discretize "
        f"{time.perf_counter() - t0:.2f} s")
    mu = d.parse_parameter(1.0)
    A, b = d.assemble(mu), d.rhs(mu)
    opts = {"type": "mf_pcg", "precision": 1e-8, "coarse_space": "harvested",
            "coarse_modes": 12}
    hk.reset_launch_counts()
    runs = {False: [], True: []}
    for mixed in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        U = d.solve(mu, inverse_options=dict(opts, mixed=mixed))
        torch.cuda.synchronize()
        res = float(torch.linalg.norm(b - A.apply(U)) / torch.linalg.norm(b))
        runs[mixed].append((time.perf_counter() - t0, int(d.last_solve_iters), res))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eta, (nc, r, df), ind = d.estimate(U, mu, decompose=True)
    torch.cuda.synchronize()
    t_est = time.perf_counter() - t0
    launches, shapes = _launched_both(hk, "3D scale")
    for mixed, rs in runs.items():
        kind = "mixed=True" if mixed else "mf_pcg f64"
        log(f"3D scale solve {kind}: {', '.join(f'{x[0]:.3f}' for x in rs)} s (turns f64, "
            f"mixed, mixed, f64; the first with the preconditioner freeze), iterations "
            f"{[x[1] for x in rs]} [{smi}]")
        _check(f"3D scale solve {kind} relative f64 residual", max(x[2] for x in rs), 1e-7)
    ind_np = ind.cpu().numpy()
    log(f"3D scale estimate (positive form): {t_est:.3f} s, eta {float(eta):.6e} (nc "
        f"{float(torch.linalg.norm(nc)):.3e}, r {float(torch.linalg.norm(r)):.3e}, df "
        f"{float(torch.linalg.norm(df)):.3e}) [{smi}]")
    if not (np.isfinite(ind_np).all() and (ind_np >= 0).all()):
        raise AssertionError("3D scale indicators not finite and non-negative")
    # normalized by the |.|-sum (|A| |U|): A U ~ b cancels terms up to the
    # 1e4 contrast, so a signed reference would weigh their rounding by it
    A_st = d.mf_operator().assemble(d.theta(mu))
    A_abs = type(A)(A.static, A.A_diag.abs(), **{n: C.abs() for n, C in A.couplings().items()})
    scale = float(A_abs.apply(U.abs()).max())
    _check("3D scale stencil apply vs assembled block apply on U, max |diff| / max |A| |U|",
           float((A_st.apply(U) - A.apply(U)).abs().max()) / scale, 1e-12)
    return (launches, shapes), d


def parabolic3d_phase(hk, torch, dev, smi, d_scale, nt=10, B=4):
    """Phase 23: implicit Euler (T=1, nt=10) on the 3D hex family: at
    phase 21's grid the matrix-free ``_solve_mf`` with a per-step residual
    gate (1e-7); at phase 22's grid (SPE10 3D, 16 384 dofs) the block-PCG
    trajectory against a host splu implicit Euler (1e-6) and
    ``solve_batch`` of B=4 mus, each lane against its single-mu trajectory
    (1e-6)."""
    from pylrbms_tpu_torch.model import InstationaryBlockModel
    from pylrbms_tpu_torch.discretize_parabolic_block_swipdg3d import discretize
    dt = 1.0 / nt
    hk.reset_launch_counts()
    im = InstationaryBlockModel(stationary=d_scale, T=1.0, nt=nt)
    mu = im.parse_parameter(1.0)
    K, N = d_scale.space.K, d_scale.space.N
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj, its = im._solve_mf(mu, dt, two_level=True, coarse_modes=12, return_iters=True)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    t_run = timed_median(torch, lambda: im._solve_mf(mu, dt, two_level=True, coarse_modes=12),
                         reps=2)
    G = im._euler_operator(d_scale.assemble(mu), dt)
    theta_f = im._theta_f_steps(mu, dt)
    worst = 0.0
    for n in range(nt):
        rhs = im.mass_apply(traj[n]) + dt * torch.einsum("q,qkn->kn", theta_f[n], d_scale.rhs_q)
        worst = max(worst, float(torch.linalg.norm(G.apply(traj[n + 1]) - rhs)
                                 / torch.linalg.norm(rhs)))
    log(f"3D parabolic trajectory at {K * N} dofs (mf, two-level, 12 harvested modes): "
        f"{t_run / nt * 1e3:.3f} ms/step (median of 2), first call {t_first:.2f} s with the "
        f"coarse freeze; PCG iterations per step {its.tolist()} [{smi}]")
    _check("3D parabolic per-step relative residual, max", worst, 1e-7)
    del im, G, traj
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    im, _ = discretize(spe10_3d(MOR3D), T=1.0, nt=nt, device=dev, dtype=torch.float64)
    st = im.stationary
    torch.cuda.synchronize()
    log(f"3D parabolic serving config (SPE10 3D, f64): K={st.space.K} N={st.space.N} "
        f"dofs={st.space.K * st.space.N}; discretize {time.perf_counter() - t0:.2f} s")
    mu = im.parse_parameter(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U = im.solve(mu)
    torch.cuda.synchronize()
    t_fom = time.perf_counter() - t0
    u, host_ms = host_implicit_euler(torch, im, mu, dt)
    its = im.last_solve_iters
    log(f"3D parabolic trajectory ({'dense LU' if its is None else 'block PCG'}): "
        f"{t_fom / nt * 1e3:.2f} ms/step, PCG iterations per step "
        f"{'-' if its is None else its.tolist()}; host splu {host_ms:.1f} ms/step [{smi}]")
    _check("3D parabolic final step vs host scipy splu implicit Euler, max rel err",
           rel(U[-1].cpu().numpy().reshape(-1), u), 1e-6)
    lo, hi = st.parameter_space.minimum, st.parameter_space.maximum
    mus = [im.parse_parameter([m]) for m in np.linspace(lo, hi, B)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Ub = im.solve_batch(mus)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    errs = [float(torch.linalg.norm(Ub[i] - im._solve_mf(m, dt)) / torch.linalg.norm(Ub[i]))
            for i, m in enumerate(mus)]
    log(f"3D parabolic solve_batch B={B}: {t_b / nt / B * 1e3:.3f} ms per step per mu [{smi}]")
    _check("3D parabolic solve_batch lanes vs single-mu trajectories, max rel l2 err",
           max(errs), 1e-6)
    return _launched_both(hk, "3D parabolic")


def mor3d_phase(hk, torch, dev, smi):
    """Phase 22: SPE10 3D at 16 384 dofs (4x4x2, half 1, nref 2: K=32,
    N=512, f64, full tensors), the flow of ``scripts/spe10_3d.py --nref 2
    --greedy 5 --training 6 --online-mus 3``: the FOM solve against scipy
    splu (1e-6); the weak greedy, 5 extensions over 6 training parameters;
    then adaptive enrichment from the greedy's reduced model at 3 mus
    (``default_rng(3)``) x 3 rounds.  Phase 10's gates on the way: the ROM
    estimate and ``residual_norm`` of an order-0 + one-snapshot reduced
    model, the greedy's fall, eta per round, one
    corrector batch against the dense patch solve (that check runs the
    masked PCG to convergence, maxiter 2000: the enrichment's 300-iteration
    cap stops it early at this contrast)."""
    import scipy.sparse.linalg as spla
    from pylrbms_tpu_torch.la.block import to_scipy_csr
    from pylrbms_tpu_torch.reductor import LRBMSReductor
    _, discretize = problem_and_discretizer(3)
    gpd = spe10_3d(MOR3D)
    t0 = time.perf_counter()
    d, _ = discretize(gpd, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    label = "3D MOR"
    log(f"{label} config (SPE10 3D, f64): K={d.space.K} N={d.space.N} "
        f"dofs={d.space.K * d.space.N}; discretize {time.perf_counter() - t0:.2f} s")
    mu = d.parse_parameter(1.0)
    t0 = time.perf_counter()
    u_ref = spla.splu(to_scipy_csr(d.assemble(mu)).tocsc()).solve(
        d.rhs(mu).double().cpu().numpy().reshape(-1))
    t_lu = time.perf_counter() - t0
    hk.reset_launch_counts()
    _check(f"{label} FOM solve vs scipy splu ({t_lu:.2f} s), rel err",
           rel(d.solve(mu).cpu().numpy().reshape(-1), u_ref), 1e-6)
    # phase 10's ROM gates on an order-0 + one-snapshot reduced model (on the
    # greedy's the residual is ~1e-10 of b and residual_norm's three terms
    # cancel to rounding)
    red = LRBMSReductor(d, order=0)
    red.extend_basis(d.solve(mu))
    _rom_gates(torch, d, red.reduce(), red, d.parse_parameter(0.3), label)
    del red
    res = _greedy_gates(torch, d, smi, label, 5)
    mus = [d.parse_parameter(float(m))
           for m in np.random.default_rng(3).uniform(0.1, 1.0, 3)]
    loop, all_etas = _enrich(torch, gpd, d, res.reductor, res.rd, mus, 3, smi, label,
                             target=1e-3)
    _enrich_gates(loop, all_etas)
    _corrector_check(d, loop, mus[0], label, maxiter=2000)
    return _launched_both(hk, label)


def rt_conservation_error3(torch, d, U, mu):
    """The 3D form of :func:`rt_conservation_error`: per hex cell
    |int div t - int f| / max |int f| for the reconstructed flux of U."""
    from pylrbms_tpu_torch.ops import assembly3d as asm3
    from pylrbms_tpu_torch.ops.rt1hex import rt_tab_any_order3
    from pylrbms_tpu_torch.parameters import evaluate_coefficients

    ed = d.estimator.data
    sp = ed.flux.space
    t = d.estimator.reconstruct_flux(U, mu)                  # [K, Nrt]
    _chi, idx, div_q, _ = rt_tab_any_order3(sp)
    C = sp.s ** 3
    t_cell = t[:, torch.as_tensor(idx.reshape(-1), device=t.device)].reshape(sp.K, C, -1)
    w = torch.as_tensor(sp.vol_w, dtype=t.dtype, device=t.device)
    dq = torch.as_tensor(np.ascontiguousarray(div_q), dtype=t.dtype, device=t.device)
    div_int = sp.volume * torch.einsum("q,kce,qe->kc", w, t_cell, dq)
    xq = asm3.vol_points(sp, t.dtype, t.device)
    theta_f = evaluate_coefficients(ed.f_coeffs, mu, dtype=t.dtype, device=t.device)
    f_mu = sum(c * ff(xq).to(t.dtype) for c, ff in zip(theta_f, ed.f_funcs))
    f_int = sp.volume * torch.einsum("q,kcq->kc", w, f_mu)
    return float((div_int - f_int).abs().max() / f_int.abs().max())


def q2_3d_phase(hk, torch, dev, smi):
    """Phase 24: academic3d Q2 at 13 824 dofs (4x4x4, half 1, nref 1: K=64,
    N=216, lean, f64): mf_pcg through the Q2 hex stencil against scipy
    splu (1e-6), the RT_[1] hex estimate (finite, >= 0) and the local
    conservation of the splu solution's reconstruction (1e-9)."""
    import scipy.sparse.linalg as spla
    from pylrbms_tpu_torch.la.block import to_scipy_csr
    init_grid_and_problem, discretize = problem_and_discretizer(3)
    t0 = time.perf_counter()
    d, _ = discretize(init_grid_and_problem(Q2_3D), device=dev, dtype=torch.float64,
                      lean=True, order=2)
    torch.cuda.synchronize()
    K, N = d.space.K, d.space.N
    log(f"Q2 3D config (academic3d Q2, lean, f64): K={K} N={N} dofs={K * N}; discretize "
        f"{time.perf_counter() - t0:.2f} s")
    mu = d.parse_parameter(0.5)
    t0 = time.perf_counter()
    u_ref = spla.splu(to_scipy_csr(d.assemble(mu)).tocsc()).solve(
        d.rhs(mu).double().cpu().numpy().reshape(-1))
    t_lu = time.perf_counter() - t0
    hk.reset_launch_counts()
    opts = {"type": "mf_pcg", "precision": 1e-10}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U = d.solve(mu, inverse_options=opts)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    t_solve = timed_median(torch, lambda: d.solve(mu, inverse_options=opts), reps=3)
    eta, (nc, r, df), ind = d.estimate(U, mu, decompose=True)
    torch.cuda.synchronize()
    launches, shapes = _launched_both(hk, "Q2 3D")
    log(f"Q2 3D mf_pcg (precision 1e-10): {t_solve:.3f} s (median of 3; first {t_first:.2f} s "
        f"with the preconditioner), {int(d.last_solve_iters)} iterations; scipy splu "
        f"{t_lu:.2f} s; eta {float(eta):.6e} (nc {float(torch.linalg.norm(nc)):.3e}, r "
        f"{float(torch.linalg.norm(r)):.3e}, df {float(torch.linalg.norm(df)):.3e}) [{smi}]")
    _check("Q2 3D solve vs scipy splu, rel err", rel(U.cpu().numpy().reshape(-1), u_ref), 1e-6)
    ind_np = ind.cpu().numpy()
    if not (np.isfinite(ind_np).all() and (ind_np >= 0).all() and float(eta) > 0):
        raise AssertionError("Q2 3D indicators not finite and non-negative")
    _check("Q2 3D RT_[1] local conservation of the splu solution, max rel err",
           rt_conservation_error3(torch, d, torch.as_tensor(u_ref.reshape(K, N), device=dev),
                                  mu), 1e-9)
    return launches, shapes


TRUTH_REF = "docs/results/ref442k.npz"
# U of the 442k Q2 solve against the reference file, max-norm relative.  The
# reference stopped at relres 5.1e-10 (docs/results/truth_solver.txt), this
# solve at <= 1e-10 with its own chunking and summation order, so the two are
# different iterates near the same solution; an H100 measured 1.7e-12
# between them at mu = 1.0.  1e-8 leaves four decades for other cards and
# stopping points and is eight below the gap between the mu = 1.0 and 0.3
# solutions, so a solve of the wrong problem cannot pass.
TRUTH_TOL = 1e-8
TRUTH_MUS = (1.0, 0.3)


def _vtu_check(path, K, N, n_cells, U):
    """Parse a written VTU back: point and cell counts, and the point values
    equal to U exactly (repr round-trips float64)."""
    import re
    import xml.etree.ElementTree as ET
    with open(path) as f:
        head = f.read(400)
    counts = re.search(r'NumberOfPoints="(\d+)" NumberOfCells="(\d+)"', head).groups()
    if counts != (str(K * N), str(n_cells)):
        raise AssertionError(f"VTU counts {counts}, expected {(K * N, n_cells)}")
    vals = np.array(ET.parse(path).getroot().find(".//PointData/DataArray").text.split(),
                    dtype=np.float64)
    if not np.array_equal(vals, np.asarray(U, np.float64).reshape(-1)):
        raise AssertionError("VTU point values differ from U")


def _truth_log(label, info, smi):
    it = info["it32"]
    log(f"{label}: relres {info['relres']:.3e}, {it} iterations ({info['rounds']} "
        f"{'rounds' if info['it64'] == 0 else 'chunks'}); assemble {info['t_assemble']:.2f} s "
        f"(dense blocks {info['t_blocks']:.2f}, eigh {info['t_eigh']:.2f}), harvest "
        f"{info['t_harvest']:.2f} s, coarse {info['t_coarse']:.2f} s (with the harvest), solve "
        f"{info['t_solve']:.2f} s, {1e3 * info['t_solve'] / max(it, 1):.3f} ms/iteration "
        f"[{smi}]")
    _check(f"{label} relative residual", info["relres"], 1e-9)


def truth_scale_phase(hk, torch, dev, smi, d):
    """Phase 25a: ``truth_solve`` on phase 21's model (SPE10 3D, K=256,
    N=512, 131 072 dofs, f64, lean) through its ``mf_operator`` and
    ``cast_f32``: the f64 recurrence (bf16-stored block factors), the f32
    inner IR (f32 factors) and the f64 recurrence on f32 factors.  Gates:
    relres <= 1e-9 and U within 1e-7 (max-norm relative) of an mf_pcg
    solve of the model at precision 1e-11 (phase 21's own solve stops at
    1e-8); the VTU of U (``d.visualize``) parses back to its counts and
    values.  Returns the path's launches (block_matvec only: truth has no
    precond_dot)."""
    import tempfile
    from pylrbms_tpu_torch.truth import truth_solve
    mu = d.parse_parameter(1.0)
    K, N = d.space.K, d.space.N
    ref_opts = {"type": "mf_pcg", "precision": 1e-11, "coarse_space": "harvested",
                "coarse_modes": 12, "max_iter": 5000}
    U_ref = d.solve(mu, inverse_options=ref_opts).cpu().numpy()
    hk.reset_launch_counts()
    runs = (("f64 recurrence, bf16 factors", dict(jacobi_storage="bf16")),
            ("f32 inner IR", dict(recurrence="f32ir")),
            ("f64 recurrence", dict()))
    for label, kw in runs:
        U, info = truth_solve(d, mu, verbose=False, **kw)
        _truth_log(f"truth 131k ({label})", info, smi)
        _check(f"truth 131k ({label}) U vs mf_pcg at precision 1e-11, max rel err",
               rel(U, U_ref), 1e-7)
    launches, shapes = hk.launch_counts(), hk.launch_signature_counts()
    log(f"truth 131k main path: kernel launches {launches}")
    if launches["block_matvec"] <= 0:
        raise AssertionError("block_matvec was not launched on the truth 131k path")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = d.visualize(torch.as_tensor(U, device=dev), f"{tmp}/truth131k")
        t_vtu = time.perf_counter() - t0
        _vtu_check(path, K, N, K * d.space.s ** 3, U)
        log(f"truth 131k VTU: {path.rsplit('/', 1)[1]} written in {t_vtu:.2f} s, parsed back "
            f"({K * N} points, {K * d.space.s ** 3} hexes, values exact)")
    return launches, shapes


def truth_full_phase(hk, torch, dev, smi, mus=TRUTH_MUS):
    """Phase 25b: the 442k-q2 truth solve at full width (SPE10 3D, raster
    (4, 8, 8) nearest, contrast 1e4, 8x8x4 subdomains, half 1, nref 2, Q2:
    K=256, N=1728, 442 368 dofs) through ``SolveOnlyModel``, block route,
    f64 recurrence, as ``scripts/spe10_3d_truth.py --config 442k-q2``.
    Gates per mu: relres <= 1e-9, U within TRUTH_TOL of the reference
    file's u_<mu>.  Prints the seconds per stage, the peak device memory,
    ms per iteration, the launches and the per-iteration roofline share
    (``roofline.pcg_iteration_cost``)."""
    from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem_3d
    from pylrbms_tpu_torch.truth import SolveOnlyModel, truth_solve
    from pylrbms_tpu_torch.utils import roofline
    ref = np.load(TRUTH_REF)
    cfg = {"num_subdomains": [int(v) for v in ref["subs"]],
           "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": int(ref["nref"])}
    gpd = init_grid_and_problem_3d(cfg, raster=tuple(int(v) for v in ref["raster"]),
                                   raster_mode="nearest",
                                   max_contrast=float(ref["max_contrast"]))
    m_c = 6 + 32
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731

    class CountedModel(SolveOnlyModel):
        """Counts one PCG iteration's bytes and operations from the f64
        stencil that the solve assembles (so the count costs no assembly of
        its own): that stencil, the f32 block factors, the coarse basis
        [K, N, 38] and inverse [K*38, K*38] in f64."""
        cost = None

        def stencil_at(self, mu, dtype):
            S = super().stencil_at(mu, dtype)
            if dtype == torch.float64 and self.cost is None:
                K, N = self.space.K, self.space.N
                self.cost = roofline.pcg_iteration_cost(
                    S, meta((K, N, N), torch.float32), meta((K, N, m_c), torch.float64),
                    meta((K * m_c, K * m_c), torch.float64))
            return S

    t0 = time.perf_counter()
    d = CountedModel(gpd, order=int(ref["order"]), device=dev)
    torch.cuda.synchronize()
    K, N = d.space.K, d.space.N
    log(f"truth 442k ({ref['config']}): K={K} N={N} dofs={K * N}; solve-only model "
        f"{time.perf_counter() - t0:.2f} s")
    hk.reset_launch_counts()
    infos = []
    for m in mus:
        reset_peak(torch, dev)
        U, info = truth_solve(d, {"switch": m}, tol=1e-10, n_harvest=32, rounds=2,
                              recurrence="f64", verbose=False)
        peak = torch.cuda.max_memory_allocated(dev)
        _truth_log(f"truth 442k mu={m}", info, smi)
        log(f"truth 442k mu={m}: peak device memory {peak / 2**30:.2f} GiB")
        _check(f"truth 442k mu={m} U vs {TRUTH_REF}:u_{m}, max rel err",
               rel(U, ref[f"u_{m}"]), TRUTH_TOL)
        infos.append(info)
    launches, shapes = hk.launch_counts(), hk.launch_signature_counts()
    log(f"truth 442k main path: kernel launches {launches}")
    if launches["block_matvec"] <= 0:
        raise AssertionError("block_matvec was not launched on the truth 442k path")
    cost = d.cost
    t_bytes = cost.bytes / hk.HBM_BYTES_PER_S
    t_ops = cost.flops / hk.PEAK_OPS_PER_S["f64 tensor"]
    bound_ms = 1e3 * max(t_bytes, t_ops)
    ms_it = 1e3 * infos[0]["t_solve"] / infos[0]["it32"]
    r = roofline.roofline(cost, ms_it / 1e3)
    log(f"truth 442k per PCG iteration: {cost.bytes / 1e9:.3f} GB and {cost.flops / 1e9:.3f} "
        f"GFLOP counted, bound {bound_ms:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}), measured {ms_it:.4f} ms: share "
        f"of bound {bound_ms / ms_it:.3f}, {r['hbm_gbs']:.1f} GB/s ({r['hbm_util']:.3f} of "
        f"HBM) [{smi}]")
    return launches, shapes


# phase 26: (label, world, backend, dryrun preset); every rank on cuda:0
DIST_RUNS = (("26a", 1, "nccl", "serving"), ("26b", 4, "gloo", "serving"),
             ("26c", 2, "gloo", "scale"))
# the gloo operations the sharded paths pass CUDA tensors to (the halo
# strips go through host buffers: gloo's point-to-point takes host memory)
GLOO_CUDA_OPS = ("all_reduce", "broadcast", "all_gather", "batch_isend_irecv (host buffers)")


def distributed_phase(hk, torch, dev, smi, paths, runs=DIST_RUNS):
    """Phase 26: distribution over the subdomain axis on the card.  A probe
    of which gloo operations take CUDA tensors (two ranks on cuda:0;
    point-to-point on CUDA tensors in a launch of its own, whose answer is
    logged: the mesh stages gloo's halo strips through host buffers), then
    ``scripts/dryrun_multichip`` through the rank launcher for each of
    ``runs``: 26a world 1 over NCCL and 26b world 4 over gloo at the
    serving grid (online step, SPMD solver, reduce, corrector, solve_sharded,
    the sweep over 64 mus), 26c world 2 over gloo at scale (the two-level
    matrix-free solves at 98 304 and 131 072 dofs, the SPE10 trajectory in
    f64 and mixed and a B=2 sweep).  Every leg is held to its unsharded
    reference on rank 0 in the ranks (a failed or hung rank fails the
    phase); the ranks' kernel launches join ``paths`` as 'distributed
    26x'.  Ranks sharing one card time-share it: their times are per-rank
    ms per iteration and exchange ms, not a speedup; NCCL across devices
    is not exercised."""
    from pylrbms_tpu_torch.scripts import distributed_smoke, dryrun_multichip
    t0 = time.perf_counter()
    probe = distributed_smoke.probe_gloo_cuda(2)
    log(f"gloo with float64 CUDA tensors, 2 ranks on cuda:0 ({time.perf_counter() - t0:.2f} s): "
        f"{probe}")
    bad = [op for op in GLOO_CUDA_OPS if probe.get(op) != "ok"]
    if bad:
        raise RuntimeError(f"gloo refused CUDA tensors in {bad}: {probe}")
    for label, world, backend, preset in runs:
        t0 = time.perf_counter()
        payloads = dryrun_multichip.run(world, device="cuda", backend=backend, preset=preset,
                                        timeout_s=600)
        log(f"phase {label}: world {world} over {backend} on cuda:0, {preset} legs, "
            f"{time.perf_counter() - t0:.2f} s with the ranks' start and model builds; {smi}")
        for line in dryrun_multichip.format_legs(payloads):
            log(f"  {label} {line}")
        sigs = {}
        for p in payloads:
            for kind, counts in p["launches"].items():
                for sig, n in counts.items():
                    sigs.setdefault(kind, {})[sig] = sigs.get(kind, {}).get(sig, 0) + n
        log(f"  {label} kernel launches (all ranks): "
            f"{ {k: sum(v.values()) for k, v in sigs.items()} }; per-rank peak device memory "
            f"{[round(p['peak_bytes'] / 2**20, 1) for p in payloads]} MiB")
        paths[f"distributed {label}"] = ({k: sum(v.values()) for k, v in sigs.items()}, sigs)
        if not all(paths[f"distributed {label}"][0].get(k) for k in BLOCK_KERNELS):
            raise RuntimeError(f"{label}: a kernel was not launched in the ranks: {sigs}")


# ---------------------------------------------------------------------------
# phase 27: the entry-point scripts of ``pylrbms_tpu_torch/scripts``, each at
# the configuration its ``docs/results/`` file records and held to that file
# (``scripts/_results.py``: CPU-written tables to their printed digits, the
# TPU files' accuracy values at their tolerances); their output goes to
# SCRIPT_LOGS, one file a script.

SCRIPT_LOGS = "results_out/chip_smoke_scripts"


def _close(label, a, b, rtol):
    a, b = float(a), float(b)
    err = abs(a - b) / max(abs(b), 1e-300)
    ok = err <= rtol
    log(f"  {label}: {a:.10e} vs {b:.10e}, rel {err:.2e} (tol {rtol:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    return [] if ok else [f"{label}: {a!r} vs {b!r}, rel {err:.2e} > {rtol:.0e}"]


def _equal(label, a, b):
    ok = a == b
    log(f"  {label}: {a} vs {b} {'ok' if ok else 'FAIL'}")
    return [] if ok else [f"{label}: {a!r} != {b!r}"]


def _held(label, bad):
    log(f"  {label}: {'ok' if not bad else f'{len(bad)} off'}")
    for b in bad[:20]:
        log(f"    {b}")
    return list(bad)


def _tpu(R, values):
    return R.hold_tpu(values, log=lambda s: log(f"  {s}"))


def _counts(R, values, note=""):
    for key, v in values.items():
        fname, line, text = R.TPU_COUNTS[key]
        log(f"  count {key}{note}: {v} (the file's {text}, {fname}:{line}; not held)")


def _script_demo(R, torch, dev, timed):
    """Row 1: the README demo on the card against the port on the CPU."""
    from pylrbms_tpu_torch.scripts import online_adaptive_lrbms as m
    cpu = m.main(device="cpu")
    out = timed(m.main, device=dev)
    bad = _close("detailed eta vs the port on the CPU", out["eta"], cpu["eta"], 1e-8)
    bad += _close("reduced eta vs the port on the CPU", out["eta_red"], cpu["eta_red"], 1e-8)
    for i, ((e, n), (e_c, n_c)) in enumerate(zip(out["online"], cpu["online"])):
        bad += _close(f"online mu #{i} final eta", e, e_c, 1e-8)
        bad += _equal(f"online mu #{i} RB size", n, n_c)
    return bad + _equal("online mus", len(out["online"]), len(cpu["online"]))


def _script_decomp(R, torch, dev, timed):
    """Row 2: the acceptance script (GOLDEN at rel 1e-5, the ROM's triple =
    the detailed one) and, crisscross with the paper convention, the
    reference's golden triple (rel 1e-4, as phase 14)."""
    from pylrbms_tpu_torch.scripts import linearelliptic_block_swipdg_decomp as m
    out = timed(m.main, device=dev)
    bad = []
    for k, g in R.DECOMP_GOLDEN.items():
        bad += _close(f"{k} vs GOLDEN", out["fom"][k], g, 1e-5)
    for k in ("eta_nc", "eta_r", "eta_df"):
        bad += _close(f"ROM {k} vs detailed", out["rom"][k], out["fom"][k], 1e-8)
    cc = timed(m.main, crisscross=True, paper_convention=True, device=dev)
    for k, g in zip(("eta_nc", "eta_r", "eta_df"), GOLDEN):
        bad += _close(f"crisscross paper {k} vs the reference's golden", cc["fom"][k], g, 1e-4)
    return bad


def _script_golden_gap(R, torch, dev, timed):
    from pylrbms_tpu_torch.scripts import golden_gap_study as m
    out = timed(m.main, out="results_out/golden_gap_attribution.md", device=dev)
    return _held(R.GOLDEN_GAP, R.hold_golden_gap(out["rows"], out["text"]))


def _script_mpi_elliptic(R, torch, dev, timed):
    from pylrbms_tpu_torch.scripts import mpi_elliptic as m
    out = timed(m.main, "results_out/vtu", device=dev)
    sp = out["d"].space
    try:
        _vtu_check(out["path"], sp.K, sp.N, sp.K * sp.s * sp.s * sp.T, out["U"].cpu().numpy())
    except AssertionError as e:
        return [f"mpi_elliptic VTU: {e}"]
    log(f"  VTU {out['path']} parsed back: counts and point values = U ok")
    return []


def _script_os2015(R, torch, dev, timed):
    from pylrbms_tpu_torch.scripts import OS2015_convergence_study as m
    bad = []
    for fname, kw in (("OS2015_convergence_study.txt", {}),
                      ("OS2015_convergence_study_crisscross.txt",
                       dict(crisscross=True, paper_convention=True)),
                      ("OS2015_convergence_study_paper.txt", dict(paper_convention=True))):
        bad += _held(fname, R.hold_studies(fname, timed(m.main, device=dev, **kw)))
    return bad


def _script_os2015_reduced(R, torch, dev, timed):
    from pylrbms_tpu_torch.scripts import OS2015_convergence_study_as_reduced as m
    fname = "OS2015_convergence_study_as_reduced.txt"
    return _held(fname, R.hold_studies(fname, [timed(m.main, device=dev)]))


def _script_p2(R, torch, dev, timed):
    from pylrbms_tpu_torch.scripts import p2_convergence_study as m
    out = timed(m.main, device=dev)
    fname = "P2_convergence_study.txt"
    return _held(fname, R.hold_rows(fname, [out["tri"], out["crisscross"], out["quad"]]))


def _script_parabolic_eoc(R, torch, dev, timed):
    from pylrbms_tpu_torch.scripts import parabolic_convergence_study as m
    fname = "parabolic_convergence_study.txt"
    return _held(fname, R.hold_studies(fname, [timed(m.main, device=dev)]))


def _script_channels(R, torch, dev, timed):
    """Row 9 at the reference's configuration (8x8, nt=100), its switch
    sin(4 pi t) > 0 decided at its zeros t = j/4 as in the file's run (see
    ``_results.CHANNELS_TIES_TPU``) and held; then as the port decides it
    (printed, not held)."""
    from pylrbms_tpu_torch.scripts import parabolic as m
    keys = ("total", "nc", "r", "df", "rt", "tdnc")
    with R.channels_switch_at_ties(R.CHANNELS_TIES_TPU):
        out = timed(m.main, nt=100, subdomains=(8, 8), device=dev)
    vals = {"parabolic.rom_error": out["reduction_error"]}
    for tag in ("fom", "rom"):
        for k in keys:
            vals[f"parabolic.{tag}.{k}"] = out[tag.upper()][k]
    bad = _tpu(R, vals)
    own = timed(m.main, nt=100, subdomains=(8, 8), device=dev)["FOM"]
    log("  the port's own decisions at the ties (on at 1/4 and 3/4): FOM "
        + ", ".join(f"{k} {own[k]:.6e}" for k in keys) + " (not held)")
    return bad


def _script_academic3d(R, torch, dev, timed):
    from pylrbms_tpu_torch.scripts import academic3d_convergence_study as m
    fname = "academic3d_convergence_study.txt"
    return _held(fname, R.hold_rows(fname, [timed(m.main, device=dev)]))


def _script_q2_3d(R, torch, dev, timed):
    from pylrbms_tpu_torch.scripts import q2_3d_convergence_study as m
    return _held("q2_3d_convergence_study.txt", R.hold_q2_3d(timed(m.main, device=dev)))


def _script_spe10_efficiency(R, torch, dev, timed):
    from pylrbms_tpu_torch.scripts import spe10_efficiency_study as m
    out = timed(m.main, device=dev)
    fname = "spe10_efficiency_study.txt"
    return _held(fname, R.hold_studies(fname, [out[1.0], out[0.3]]))


def _script_spe10_greedy(R, torch, dev, timed):
    """Row 13, the north-star pipeline at full width (K=256, N=384)."""
    from pylrbms_tpu_torch.scripts import spe10_greedy as m
    out = timed(m.cli, "--subdomains 16 16 --half 2 --nref 2 --training 8 --target 1e-2 "
                "--online-mus 3".split() + ["--device", str(dev)])
    vals = {f"spe10_greedy.max_eta{i}": v for i, v in enumerate(out["max_etas"])}
    vals.update({f"spe10_greedy.online_eta{i}": e for i, (e, _) in enumerate(out["online"])})
    bad = _equal("greedy iterations", len(out["max_etas"]), 3)
    _counts(R, {"spe10_greedy.rb_size": out["rb_size"]})
    log(f"  online RB sizes {[n for _, n in out['online']]}, FOM solves {out['fom_solves']}")
    return bad + _tpu(R, vals)


def _script_spe10_scale(R, torch, dev, timed):
    from pylrbms_tpu_torch.scripts import spe10_scale as m
    out = timed(m.cli, "--matrix-free --dtype float64 --maxiter 1500".split()
                + ["--device", str(dev)])
    bad = [] if out["finite"] else ["spe10_scale: indicators not finite"]
    return bad + _tpu(R, {"spe10_scale.relres": out["relres"]})


def _script_spe10_parabolic(R, torch, dev, timed):
    from pylrbms_tpu_torch.scripts import spe10_parabolic as m
    out = timed(m.main, ["--rom", "--rom-snapshots", "4"], device=dev)
    return _tpu(R, {f"spe10_parabolic.{k}": out[k]
                    for k in ("euler_residual", "eta", "host_agreement", "rom_eta",
                              "rom_error")})


SPE10_3D_RUNS = (
    ("scale", "--subdomains 8 8 4 --half 1 --nref 2 --lean --mf"),
    ("mor", "--nref 2"),
    ("greedy", "--nref 2 --greedy 5 --training 6 --online-mus 3"),
    ("target", "--nref 2 --greedy 2 --training 6 --online-mus 3 --online-target-rel 1.05"),
    ("parabolic", "--subdomains 8 8 4 --half 2 --nref 1 --lean --mf --skip-estimate "
                  "--parabolic 20 --parabolic-batch 4"),
)


def _script_spe10_3d(R, torch, dev, timed):
    """Row 16 at the five commands the 3D TPU files record."""
    from pylrbms_tpu_torch.scripts import spe10_3d as m
    out = {name: timed(m.main, argv.split(), device=dev) for name, argv in SPE10_3D_RUNS}
    s, f, g, t, p = (out[k] for k, _ in SPE10_3D_RUNS)
    log(f"  scale solve: max-norm residual ratio {s['relres']:.2e} (the file's measure: "
        f"1.4e-09 after the TPU's f64 polish); held: ||b - A U|| / ||b|| {s['relres2']:.2e}")
    vals = {"spe10_3d.scale.relres": s["relres2"], "spe10_3d.scale.eta": s["eta"],
            "spe10_3d.relres": f["relres"], "spe10_3d.eta": f["eta"],
            "spe10_3d.eta_rom": f["eta_rom"], "spe10_3d.rom_fom_gap": f["rom_fom_gap"],
            "spe10_3d_greedy.eta_rom": g["eta_rom"], "spe10_3d_greedy.eta_rec": g["eta_rec"],
            "spe10_3d_greedy.rom_fom_gap": g["rom_fom_gap"],
            "spe10_3d_parabolic.euler_residual": p["euler_residual"],
            "spe10_3d_parabolic.lane": p["lane"]}
    vals.update({f"spe10_3d_greedy.surrogate{i}": v for i, v in enumerate(g["max_etas"])})
    vals.update({f"spe10_3d_greedy.online_eta{i}": o["eta"] for i, o in enumerate(g["online"])})
    for i, o in enumerate(t["online"]):
        vals[f"spe10_3d_target.eta_fom{i}"] = o["eta_fom"]
        vals[f"spe10_3d_target.eta{i}"] = o["eta"]
    _counts(R, {"spe10_3d.scale.its": s["fom_its"], "spe10_3d.its": f["fom_its"],
                "spe10_3d_greedy.iterations": len(g["max_etas"]),
                "spe10_3d_greedy.rb_size": g["rb_size"]})
    log(f"  target run: enrichment rounds per mu {[o['rounds'] for o in t['online']]}, "
        f"RB sizes {[o['rb_size'] for o in t['online']]}")
    return _tpu(R, vals)


def _script_efficiency3d_smoke(R, torch, dev, timed):
    """Row 17, ``--smoke``: the card against the port on the CPU (1e-8)."""
    from pylrbms_tpu_torch.scripts import spe10_3d_efficiency_study as m
    cpu = m.main(smoke=True, device="cpu")
    out = timed(m.main, smoke=True, device=dev)
    bad = []
    for mu, rows in cpu.items():
        for i, (row, row_c) in enumerate(zip(out[mu], rows)):
            for k in ("|e|_ell", "eta", "eta_nc", "eta_df", "|e|_DG+pen"):
                bad += _close(f"mu {mu} level {i} {k} vs the port on the CPU", row[k], row_c[k],
                              1e-8)
            scale = max(row["eta_nc"], row["eta_df"])
            ok = row["eta_r"] <= R.ROUNDING_REL * scale
            log(f"  mu {mu} level {i} eta_r {row['eta_r']:.3e} at rounding level "
                f"(<= {R.ROUNDING_REL:.0e} x {scale:.3e}) {'ok' if ok else 'FAIL'}")
            bad += [] if ok else [f"efficiency 3D smoke level {i}: eta_r {row['eta_r']!r}"]
    return bad


def _script_concurrency(R, torch, dev, timed):
    """Row 18: W threads on their own streams = the sequential applies
    exactly; the batched apply = the per-vector applies."""
    from pylrbms_tpu_torch.scripts import batched_matvec_test, threadpool_test
    tp = timed(threadpool_test.main, device=dev)
    bm = timed(batched_matvec_test.main, device=dev)
    bad = _equal("threadpool results identical to the sequential ones", tp["identical"], True)
    bad += _equal("CUDA streams in the pool", tp["streams"] > 1, True)
    ok = bm["max_lane_err"] < 1e-10
    log(f"  batched apply vs per-vector: max rel {bm['max_lane_err']:.2e} (tol 1e-10) "
        f"{'ok' if ok else 'FAIL'}")
    return bad + ([] if ok else [f"batched apply lane error {bm['max_lane_err']!r}"])


XL_RUNS = (("1", "nccl"), ("2", "gloo"))


def _script_xl_sharded(R, torch, dev, timed):
    """Row 19: the 1M-dof K-sharded solve over world 1 (NCCL) and world 2
    (gloo) on the card; sharded U = rank 0's unsharded U (1e-8)."""
    from pylrbms_tpu_torch.scripts import mf_sharded_xl_demo as m
    bad, sigs, peaks = [], {"block_matvec": {}, "precond_dot": {}}, []
    for world, backend in XL_RUNS:
        res = timed(m.main, ["--world", world, "--backend", backend], device=dev)
        bad += _tpu(R, {"xl_sharded.relres": res["relres"]})
        ok = res["u_vs_unsharded"] <= 1e-8
        log(f"  world {world} ({backend}): sharded U vs unsharded max rel "
            f"{res['u_vs_unsharded']:.2e} (tol 1e-8) {'ok' if ok else 'FAIL'}; iterations "
            f"sharded {res['its']}, unsharded {res['its_unsharded']}; solve "
            f"{res['t_solve']:.2f} s, assembly {res['t_assembly']:.2f} s, preconditioner "
            f"{res['t_precond']:.2f} s")
        bad += [] if ok else [f"world {world}: sharded U off the unsharded one"]
        _counts(R, {"xl_sharded.its": res["its"]}, f" at world {world}")
        for launches in res["launches"]:
            for kind, counts in launches.items():
                for sig, n in counts.items():
                    sigs.setdefault(kind, {})[sig] = sigs.get(kind, {}).get(sig, 0) + n
        peaks += res["peak_bytes"]
    return bad, sigs, peaks


SCRIPT_CASES = (
    ("online_adaptive_lrbms", _script_demo),
    ("linearelliptic_block_swipdg_decomp", _script_decomp),
    ("golden_gap_study", _script_golden_gap),
    ("mpi_elliptic", _script_mpi_elliptic),
    ("OS2015_convergence_study", _script_os2015),
    ("OS2015_convergence_study_as_reduced", _script_os2015_reduced),
    ("p2_convergence_study", _script_p2),
    ("parabolic_convergence_study", _script_parabolic_eoc),
    ("parabolic", _script_channels),
    ("academic3d_convergence_study", _script_academic3d),
    ("q2_3d_convergence_study", _script_q2_3d),
    ("spe10_efficiency_study", _script_spe10_efficiency),
    ("spe10_greedy", _script_spe10_greedy),
    ("spe10_scale", _script_spe10_scale),
    ("spe10_parabolic", _script_spe10_parabolic),
    ("spe10_3d", _script_spe10_3d),
    ("spe10_3d_efficiency_study", _script_efficiency3d_smoke),
    ("threadpool_test + batched_matvec_test", _script_concurrency),
    ("mf_sharded_xl_demo", _script_xl_sharded),
)


def scripts_phase(hk, torch, dev, smi, paths, only=None):
    """Phase 27: every script of ``SCRIPT_CASES`` (or those named in
    ``only``) on the card, with the kernel launch counts cleared just before
    it and read just after (the xl demo's from its ranks) into ``paths`` as
    'script <name>'; prints the card seconds (the script's own runs, not
    the CPU references) and peak device memory of each.  Every mismatch is
    logged; the phase raises after the last script if any script was off
    its file or raised."""
    import contextlib
    import io
    import os
    from pylrbms_tpu_torch.scripts import _results as R
    os.makedirs(SCRIPT_LOGS, exist_ok=True)
    failed = {}
    _LOG_TO[0] = sys.stdout
    for name, case in SCRIPT_CASES:
        if only is not None and name not in only:
            continue
        card_s = []

        def timed(fn, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            card_s.append(time.perf_counter() - t0)
            return out

        log(f"script {name}:")
        hk.reset_launch_counts()
        reset_peak(torch, dev)
        t0 = time.perf_counter()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                got = case(R, torch, dev, timed)
        except Exception:                                # noqa: BLE001 — logged, then raised
            got = [f"{name} raised:\n{traceback.format_exc()}"]
            log(got[0])
        finally:
            with open(os.path.join(SCRIPT_LOGS, name.split()[0] + ".log"), "w") as f:
                f.write(buf.getvalue())
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        if isinstance(got, tuple):                        # ranks: their launches and peaks
            bad, shapes, peaks = got
            launches = {k: sum(v.values()) for k, v in shapes.items()}
            peak = f"per rank {[round(p / 2**20, 1) for p in peaks]} MiB"
        else:
            bad = got
            launches, shapes = hk.launch_counts(), hk.launch_signature_counts()
            peak = f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB"
        paths[f"script {name}"] = (launches, shapes)
        log(f"script {name}: card {sum(card_s):.2f} s in {len(card_s)} run(s) "
            f"({', '.join(f'{t:.2f}' for t in card_s)}), {total:.2f} s with the CPU "
            f"references; peak device memory {peak}; kernel launches {launches}; "
            f"{'ok' if not bad else f'{len(bad)} FAILED'} [{smi}]")
        if bad:
            failed[name] = bad
    _LOG_TO[0] = None
    total = {k: sum(p[0].get(k, 0) for n, p in paths.items() if n.startswith("script "))
             for k in ("block_matvec", "precond_dot")}
    log(f"scripts' kernel launches: {total}")
    if failed:
        raise AssertionError(f"scripts off their result files: {sorted(failed)}: "
                             + "; ".join(b for v in failed.values() for b in v[:3]))
    for k, n in total.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by the scripts")


# ------------------------------------------------------------- phase 28

API_SPE10 = {"num_subdomains": [4, 4, 2],  # scripts/spe10_3d --nref 2 (K=32, N=512), f64
             "half_num_fine_elements_per_subdomain_and_dim": 1, "num_refinements": 2}
API_SPE10_ITS = 129                # its FOM solve's iterations on the ones-basis route
API_ROUTE_TOL = 1e-12              # two_level's U against the ones-basis route's


def _api_path(hk, paths, name):
    paths[name] = (hk.launch_counts(), hk.launch_signature_counts())
    log(f"{name}: kernel launches {paths[name][0]}")


def api_ir_phase(hk, torch, dev, smi, keep, paths):
    """Phase 28c: ``solve_ir`` on phase 8's model (98 304 dofs, its frozen
    preconditioner) through ``ops/ir.make_precond_f32``: the model's
    ``mixed=True`` solve and a direct ``solve_ir`` call, each with phase 8's
    mixed iterations, the same rounds, and the f64 residual <= 1e-10."""
    from pylrbms_tpu_torch import model as model_mod
    from pylrbms_tpu_torch.ops import ir
    d, mu = keep["d"], keep["mu"]
    made, infos = [], []
    make, model_solve_ir = ir.make_precond_f32, model_mod.solve_ir

    def counted_make(*a, **kw):
        made.append(1)
        return make(*a, **kw)

    def recorded_solve_ir(*a, **kw):
        out = model_solve_ir(*a, **kw)
        infos.append(tuple(int(v) for v in out[1:]))
        return out

    hk.reset_launch_counts()
    ir.make_precond_f32, model_mod.solve_ir = counted_make, recorded_solve_ir
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        U = d.solve(mu, inverse_options={"precision": 1e-10, "mixed": True})
        torch.cuda.synchronize()
        t_model = time.perf_counter() - t0
        bf, C, ci = next(v for k, v in d._mf_cache.items()
                         if isinstance(k, tuple) and k[0] == "precond")
        theta, b = d.theta(mu), d.rhs(mu)
        A = d.mf_operator().assemble(theta)
        A32 = d._mf_cache["sop32"].assemble(theta.to(torch.float32))
        dvec = torch.einsum("q,qkn->kn", theta, d._mf_cache["diag_q"])
        t0 = time.perf_counter()
        x, it32, rounds, it64 = ir.solve_ir(A, A32, b, dvec, tol=1e-10, maxiter=2000,
                                            block_factors=bf, coarse_inv=ci, coarse_basis=C,
                                            return_info=True)
        torch.cuda.synchronize()
        t_direct = time.perf_counter() - t0
    finally:
        ir.make_precond_f32, model_mod.solve_ir = make, model_solve_ir
    _api_path(hk, paths, "API solve_ir (make_precond_f32)")
    direct = (int(it32), int(rounds), int(it64))
    relres = float(torch.linalg.norm(b - A.apply(x)) / torch.linalg.norm(b))
    log(f"API solve_ir at {d.space.K * d.space.N} dofs: model mixed=True {t_model:.3f} s "
        f"(f32 iterations, rounds, f64 iterations) {infos}, direct solve_ir {t_direct:.3f} s "
        f"{direct}; phase 8 mixed iterations {keep['mixed_iters']}; make_precond_f32 "
        f"built {len(made)} times; relres {relres:.2e}; U direct vs model rel "
        f"{rel(x.cpu(), U.cpu()):.2e} [{smi}]")
    if len(made) != 2 or infos != [direct]:
        raise AssertionError(f"solve_ir routes differ: model {infos}, direct {direct}, "
                             f"make_precond_f32 built {len(made)} times")
    for its in (int(d.last_solve_iters), direct[0] + direct[2]):
        if its not in keep["mixed_iters"]:
            raise AssertionError(f"solve_ir took {its} iterations, phase 8 {keep['mixed_iters']}")
    if not relres <= 1e-10:
        raise AssertionError(f"solve_ir relres {relres:.2e} > 1e-10")


def _trace_kernels(path):
    """{kernel: device launches} of a Chrome trace of ``timers.trace``, by
    the __global__ functions of csrc/block_kernels.cu (named in the trace
    as ``void (anonymous namespace)::stream_kernel<TS, TA, VECL, LB, PD>(...)``;
    stream_kernel's last template argument is its precond_dot flag)."""
    import re
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {"block_matvec": 0, "precond_dot": 0}
    for e in events:
        m = re.match(r"(?:void )?(?:\(anonymous namespace\)::)?(\w+)(?:<([^>]*)>)?",
                     e.get("name", "")) if e.get("cat") == "kernel" else None
        if m is None:
            continue
        fn, targs = m.group(1), m.group(2) or ""
        if fn.startswith("block_matvec_") or fn == "stream_ring":
            out["block_matvec"] += 1
        elif fn.startswith("precond_dot_"):
            out["precond_dot"] += 1
        elif fn == "stream_kernel":
            out["precond_dot" if targs.split(",")[-1].strip() == "true" else "block_matvec"] += 1
    return out


def api_phase(hk, torch, dev, smi, paths):
    """Phase 28 (a, b, d, e): the JAX-call-compatible surface on the card —
    ``scripts/spe10_3d`` with ``solve_pcg(two_level=True)`` at 16 384 dofs,
    the same solve against the ones-basis route and with ``coarse_f32``,
    ``graft_entry.entry()``, and ``timers.trace`` around its step."""
    import contextlib
    import glob
    import io
    import os
    import tempfile
    from pylrbms_tpu_torch.scripts import spe10_3d
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize
    from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem_3d
    from pylrbms_tpu_torch.graft_entry import entry
    from pylrbms_tpu_torch.utils.timers import trace

    # (a) the script's FOM solve now calls two_level=True
    argv = (["--subdomains", *map(str, API_SPE10["num_subdomains"]), "--half",
             str(API_SPE10["half_num_fine_elements_per_subdomain_and_dim"]),
             "--nref", str(API_SPE10["num_refinements"])])
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = spe10_3d.main(argv, device=dev)
    torch.cuda.synchronize()
    log(f"API spe10_3d {' '.join(argv)}: {time.perf_counter() - t0:.2f} s, FOM "
        f"solve {out['t_solve'] * 1e3:.1f} ms, {out['fom_its']} iterations (ones-basis "
        f"route: {API_SPE10_ITS}), relres {out['relres2']:.2e} [{smi}]")
    _api_path(hk, paths, "API spe10_3d two-level")
    if out["fom_its"] != API_SPE10_ITS or not out["relres2"] <= 1e-8:
        raise AssertionError(f"spe10_3d two-level: {out['fom_its']} iterations, relres "
                             f"{out['relres2']:.2e}")

    # (a, b) the same system: two_level, the ones-basis route, coarse_f32
    gpd = init_grid_and_problem_3d(API_SPE10, layers=(40, 44), max_contrast=1e4)
    d, _ = discretize(gpd, dtype=torch.float64, device=dev)
    mup = d.parse_parameter({"switch": 1.0})
    A, b = d.op.assemble(d.theta(mup)), d.rhs(mup)
    ci = torch.linalg.inv(A.coarse_matrix().double())
    ones = torch.ones((d.space.K, d.space.N, 1), dtype=torch.float64, device=dev)
    hk.reset_launch_counts()
    runs = {}
    for name, kw in (("two_level", {"two_level": True}),
                     ("ones basis", {"coarse_inv": ci, "coarse_basis": ones}),
                     ("coarse_f32", {"two_level": True, "coarse_f32": True})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        U, it = A.solve_pcg(b, tol=1e-8, maxiter=4000, return_iters=True, **kw)
        torch.cuda.synchronize()
        runs[name] = (U, int(it), time.perf_counter() - t0,
                      float(torch.linalg.norm(A.apply(U) - b) / torch.linalg.norm(b)))
    _api_path(hk, paths, "API solve_pcg coarse routes")
    err = rel(runs["two_level"][0].cpu(), runs["ones basis"][0].cpu())
    for name, (_, it, t, rr) in runs.items():
        log(f"API solve_pcg {name}: {it} iterations, {t * 1e3:.1f} ms, relres {rr:.2e}")
    f64_its, f32_its = runs["two_level"][1], runs["coarse_f32"][1]
    log(f"API solve_pcg: two_level vs ones-basis U rel {err:.2e} (tol {API_ROUTE_TOL:.0e}); "
        f"coarse_f32 {f32_its} iterations against f64 coarse {f64_its} "
        f"({100.0 * (f32_its - f64_its) / f64_its:+.1f}%) [{smi}]")
    if not (runs["two_level"][1] == runs["ones basis"][1] == API_SPE10_ITS
            and runs["two_level"][3] <= 1e-8 and err <= API_ROUTE_TOL):
        raise AssertionError(f"two_level against the ones-basis route: iterations "
                             f"{runs['two_level'][1]} / {runs['ones basis'][1]}, U rel {err:.2e}")
    if not runs["coarse_f32"][3] <= 1e-8:
        raise AssertionError(f"coarse_f32 relres {runs['coarse_f32'][3]:.2e} > 1e-8")
    del d, A, b, runs

    # (d) graft_entry.entry() on the card, against its CPU f64 run
    fn_ref, args_ref = entry(device="cpu", dtype=torch.float64)
    U_ref, ind_ref = (t.numpy() for t in fn_ref(*args_ref))
    fn, args = entry()
    hk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U32, ind32 = fn(*args)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    _api_path(hk, paths, "API graft_entry")
    its = fn.iters_probe(*args)
    errs = (rel(U32.cpu(), U_ref), rel(ind32.cpu(), ind_ref))
    log(f"API graft_entry.entry(): f32 step {t_step * 1e3:.1f} ms, {its} PCG iterations "
        f"(maxiter 500), U / indicators vs CPU f64 rel {errs[0]:.2e} / {errs[1]:.2e} "
        f"(tol 1e-03) [{smi}]")
    if not max(errs) <= 1e-3:
        raise AssertionError(f"graft_entry step off the CPU f64 run: {errs}")

    # (e) timers.trace around one online step
    with tempfile.TemporaryDirectory() as tmp:
        hk.reset_launch_counts()
        with trace(tmp):
            fn(*args)
        launched = hk.launch_counts()
        files = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        size = os.path.getsize(files[0]) if len(files) == 1 else 0
        seen = _trace_kernels(files[0]) if size else {}
    log(f"API timers.trace: {len(files)} file(s), {size} bytes; kernels in the trace "
        f"{seen}, wrapper launches {launched}")
    # the trace names both kernels; its counts may fall a few launches short
    # of the wrappers' (CUPTI can drop kernel records)
    launched = {k: launched[k] for k in BLOCK_KERNELS}
    if not size or not all(launched.values()) or not all(seen.get(k) for k in launched):
        raise AssertionError(f"timers.trace: no trace, or a kernel missing from it: "
                             f"{seen} (wrapper launches {launched})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    try:
        smi = smi_line()
        log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
        dev = torch.device("cuda", 0)
        from pylrbms_tpu_torch.ops import hopper_kernels as hk
        from pylrbms_tpu_torch.utils.precision import pin_precision
        pin_precision()

        t0 = time.perf_counter()
        report = hk.build()
        hk.load()
        log(f"kernel build (nvcc sm_90a): {time.perf_counter() - t0:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

        ph = lambda name, fn, *a, **kw: run_phase(torch, dev, name, fn, *a, **kw)  # noqa: E731
        t_all = time.perf_counter()
        summary, checked = ph("3 kernels", kernel_phase, hk, torch, dev)
        ph("4 entry", entry_phase, torch, dev)
        paths = {}
        paths["serving affine"], ref = ph("5 serving", serving_phase, hk, torch, dev, smi)
        ph("6 stencil apply", stencil_apply_phase, torch, dev, ref["d"])
        paths["stencil step"] = ph("7 stencil step", stencil_step_phase, hk, torch, dev, smi, ref)
        del ref
        keep = {}
        paths["scale solve"] = ph("8 scale solve", scale_solve_phase, hk, torch, dev, smi,
                                  keep=keep)
        ph("28c API solve_ir", api_ir_phase, hk, torch, dev, smi, keep, paths)
        del keep
        paths["MOR serving"] = ph("10 MOR serving", mor_serving_phase, hk, torch, dev, smi)
        paths["MOR scale"] = ph("11 MOR scale", mor_scale_phase, hk, torch, dev, smi)
        paths["parabolic scale"] = ph("12 parabolic scale", parabolic_scale_phase, hk, torch,
                                      dev, smi)
        paths["parabolic serving"] = ph("13 parabolic serving", parabolic_serving_phase, hk,
                                        torch, dev, smi)
        ph("14 golden", golden_phase, torch, dev)
        paths["crisscross serving affine"], ref = ph(
            "15a crisscross serving", serving_phase, hk, torch, dev, smi, cfg=CC_SERVING,
            label="crisscross serving")
        paths["crisscross stencil step"] = ph(
            "15b crisscross stencil step", stencil_step_phase, hk, torch, dev, smi, ref,
            label="crisscross stencil step")
        del ref
        paths["crisscross solve"] = ph("15c crisscross solve", scale_solve_phase, hk, torch,
                                       dev, smi, cfg=CC_SCALE, label="crisscross scale")
        paths["crisscross MOR"] = ph("15d crisscross MOR", mor_serving_phase, hk, torch, dev,
                                     smi, cfg=CC_SERVING, label="crisscross MOR")
        paths["order 2"] = ph("16 order 2", order2_phase, hk, torch, dev, smi)
        ph("17 EOC", eoc_phase, torch, dev, smi)
        paths["halo trajectory"] = ph("18a halo", halo_phase, hk, torch, dev, smi)
        ph("18b banded", banded_phase, torch, dev, smi)
        ph("19 golden 3D", golden3d_phase, torch, dev)
        paths["3D serving affine"], ref = ph(
            "20a 3D serving", serving_phase, hk, torch, dev, smi, cfg=SERVING3D,
            label="3D serving", dim=3)
        paths["3D stencil step"] = ph(
            "20b 3D stencil step", stencil_step_phase, hk, torch, dev, smi, ref,
            label="3D stencil step")
        del ref
        paths["3D scale"], d_scale = ph("21 3D scale", scale3d_phase, hk, torch, dev, smi)
        paths["3D parabolic"] = ph("23 3D parabolic", parabolic3d_phase, hk, torch, dev, smi,
                                   d_scale)
        paths["truth 131k"] = ph("25a truth 131k", truth_scale_phase, hk, torch, dev, smi,
                                 d_scale)
        del d_scale
        paths["3D MOR"] = ph("22 3D MOR", mor3d_phase, hk, torch, dev, smi)
        paths["Q2 3D"] = ph("24 Q2 3D", q2_3d_phase, hk, torch, dev, smi)
        paths["truth 442k"] = ph("25b truth 442k", truth_full_phase, hk, torch, dev, smi)
        ph("26 distributed", distributed_phase, hk, torch, dev, smi, paths)
        ph("27 scripts", scripts_phase, hk, torch, dev, smi, paths)
        ph("28 API", api_phase, hk, torch, dev, smi, paths)
        launches = {k: sum(p[0].get(k, 0) for p in paths.values()) for k in summary}
        log(f"main-path kernel launches: { {name: p[0] for name, p in paths.items()} }")
        ph("9 main-path shapes", path_shape_phase, hk, torch, dev, paths, checked)
        log(f"chip_smoke total: {time.perf_counter() - t_all:.2f} s after the build")

        replaces = {"block_matvec": "pylrbms_tpu/ops/pallas_kernels.py:41",
                    "precond_dot": "pylrbms_tpu/ops/pallas_kernels.py:89",
                    "stencil3_apply": None, "stencil2_apply": None}
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        kernels = [{"name": name, "route": "cuda",
                    "source": "pylrbms_tpu_torch/csrc/block_kernels.cu",
                    "replaces": replaces[name], "launches": launches[name],
                    **{key: summary[name][key] for key in keys}}
                   for name in hk.KERNELS]
    except Exception:                                    # noqa: BLE001 — report and fail
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
