#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepqmc_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

or, for the device, build and trace phases alone,
``python3 chip_smoke.py --only trace_path``.

Phases, each with a start and an end line and its own time budget:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: the CUDA kernels from ``deepqmc_tpu_torch/csrc`` into an empty
   ``deepqmc_tpu_torch/_build/`` (``nvcc``, one process per source);
3. kernels: each kernel against its plain PyTorch version on the same inputs
   on the card, at B = 256, at the run path's B = 4096 and at the main
   path's B = 2048, with the stated tolerances; the kernel's and the plain version's times (median of 20 runs,
   CUDA events, after a warm-up); then at other shapes, among them the three
   slogdet kernels at n = 5 (rows split 3/2), n = 2 with no down rows, n = 42
   and n = 64, each with the body it took (staged or tiled) on a line, and the
   attention kernel at n = 1, 2, 7, 16 and 33, and at
   n = 42 (K = 126, B = 64) and n = 64 (K = 192, B = 32), timed beside their
   bound; two launches of every kernel on the same inputs at B = 256 (and of
   the slogdet kernels at each of their other shapes) must be bitwise
   equal, and the block kernel's
   split-TF32 tensor-core floor and the weight bytes its staging plan reads
   from L2 (both computed, not measured, so not in the kernels record) are
   printed beside its float32 bound;
4. main path: the H2O PsiFormer at full width (16 determinants, embedding
   256, 4 layers, 4 heads of 64; seeded random weights), 2048 walkers,
   3 evaluation steps through ``deepqmc_tpu_torch.evaluate`` (10 Metropolis
   moves, the forward-Laplacian local energy, statistics and EWM each), with
   the per-op forward Laplacian; the launch counters of the attention and
   slogdet kernels must grow during it, and one local energy must launch the
   attention kernel 4 times, the flat slogdet kernel once and the block
   kernel never.  Then the local energy of 64 of the walkers from the kernel
   path (float32, card) against the plain path (float64, CPU);
5. block path: the same model and run with ``block_kernel=True``, where each
   layer's forward Laplacian is one launch of the fused block kernel: 4
   launches of it, none of the attention kernel and one of the flat slogdet
   kernel per local energy; its
   local energy on 64 walkers against the float64 plain path (CPU) and
   against the per-op path on the card.  Then one layer with
   ``block_kernel=True`` at n = 42 (B = 64, K = 126), past the block kernel's
   32 electrons: it must take the per-op rules (one attention launch, no block
   launch) and agree with the per-op layer, and the block kernel's wrapper
   called directly at n = 42 must raise;
6. square path: the main path's model and its last 2048 walkers; the Slater
   matrices' forward-Laplacian triple (``_spin_orbitals``) goes through four
   dispatches of the log-determinant: flat row blocks and flat whole
   (``fwdlap.slogdet_flat_rows``, ``slogdet_flat``: the flat kernel, once
   each), square row blocks (``slogdet_rows``: the square split kernel) and
   square whole (``slogdet``: the square kernel).  Signs must be equal, and
   log|det|, J and L within the local energy's tolerance rule of float64
   (below), of the plain version in float32 on the card and of each other;
7. train path: 6 KFAC training steps of the same model (fresh seed-0 weights)
   through ``deepqmc_tpu_torch.train`` on the per-op path: 2048 walkers,
   decorr 10, ``median_log_squeeze_and_mask`` clipping, KFAC as the JAX
   package's bench.py sets it (lr 0.05 / (1 + n / 10000), damping 1e-3, norm
   constraint 1e-3, inverses every 5 steps, so refreshed at steps 0 and 5).
   Every step must be finite, change the parameters and launch the attention
   kernel 4 times, the flat slogdet kernel once and the block kernel never
   (all from the local energy).  It prints the median step time of steps 1-5,
   5 more steps split by CUDA events into sampling, local energy, gradient and
   taps, KFAC update and psi refresh (the same calls the step makes), and the
   peak device memory.  On 64 of the last walkers the VMC gradient (float32,
   card, kernels) and one KFAC update from the run's optimizer state (as it
   is, with carried inverses, and moved to a refresh step) are held to the
   float64 plain path on the CPU by the local energy's rule, as global L2
   norms over all parameters, and the gradient once more with
   ``block_kernel=True``.  Then 2 training steps with
   ``block_kernel=True``: 4 block launches, 1 flat slogdet launch and no
   attention launch per step, finite, parameters changing;
8. sampling path: the same model (fresh seed-0 weights), 2048 walkers, per-op
   path.  ``train(sampler='decorr_langevin', max_eq_steps=60)`` equilibrates
   (10 Langevin moves a call, early stopping allowed; no kernel launches) and
   takes 3 KFAC steps (each finite, changing the parameters, 4 attention
   launches, 1 flat slogdet launch, no block launch); it prints the calls
   taken, their median time, tau and the acceptance at the end, and the
   median step time.  The cleaned Langevin force of 64 equilibrated walkers
   (float32, card) is held to the float64 plain path on the CPU by the local
   energy's rule (global L2, relative to max(1, |F|)).  The log|det| of the
   Slater matrices of those walkers by ``torch.linalg.slogdet`` on the strided
   view ``slogdet_flat`` builds and on a contiguous copy, each against
   float64.  One sample call of each recipe (``bench.py``'s Metropolis at
   decorr 10 and the four of ``sampling.RECIPES``), the median of 3 after a
   warm-up.  Then two geometries (the stored H2O and the same with both O-H
   bonds 10 % longer), one per step, sampled by
   ``chain(ResampledSampler(period=3), DecorrSampler(length=10),
   MetropolisSampler(max_age=20))``: 4 KFAC steps through ``fit.train_step``,
   each leaving the other molecule's walkers and EWM row bit-equal, with
   finite, positive walker weights of unit mean; it prints the largest weight,
   the effective sample size and the peak device memory of the phase.
9. run path: ``deepqmc_tpu_torch.train.train``, the JAX package's ``train``
   with ``train_psiformer.yaml``'s settings: the same model (fresh seed-0
   weights), 4096 walkers, ``decorr_metropolis_psiformer``, KFAC as
   ``opt/kfac_psiformer.yaml`` (lr 0.05 / (1 + n / 100000), damping 1e-3,
   norm constraint 1e-3, inverses every 5), ``median_clip_and_mask(clip_width=5,
   median_center=True)``, SCF pretraining with LAMB (lr 3e-4, b1 0.9, b2 0.999,
   basis 'sto-6g'); cut to 40 pretraining steps, 20 equilibration calls, 8 fit
   steps and a checkpoint every 4 steps, in the git-ignored ``runs/run_path``
   (removed at the end), with metric and HDF5 sinks of its own (tensorboardX
   and h5py are optional and not needed here).  The pretraining MSE must be finite and fall (the
   mean of the last 10 steps below that of the first 10); pretraining and
   equilibration launch no kernel; each fit step launches the attention
   kernel 4 times and the flat slogdet kernel once; ``chkpt-0.pt``,
   ``chkpt-4.pt`` and ``chkpt-8.pt`` are written, and the last one loads the
   run's parameters and walkers bit for bit.  Then 3 evaluation steps from it
   (``opt=None``, its walkers kept): finite, the same launches a step, the
   parameters bit-equal.  It prints the SCF seconds, the median pretraining
   step, the equilibration calls and their median, the median fit step, the
   checkpoint's bytes and its write and read times, the median evaluation
   step and the peak device memory.
10. zoo path: the FermiNet and PauliNet-style ``default`` presets at full
   width (FermiNet: 16 determinants, embedding 256, 4 layers, two-particle
   width 32; ``default``: 16, 128, 3, 32; seed-0 weights) on H2O.  FermiNet's
   evaluation at 2048 walkers, 3 steps of ``decorr_metropolis_ferminet``
   through ``deepqmc_tpu_torch.evaluate``, with full determinants (one launch
   of the flat slogdet kernel a local energy) and with per-spin determinants
   (two); each step finite and launching just that; E_loc on 64 walkers held to
   the float64 plain path by the local energy's rule.  Then
   ``train_ferminet.yaml`` (4096 walkers, ``decorr_metropolis_ferminet``, KFAC
   as ``opt/kfac.yaml``: lr 0.05 / (1 + n / 10000), damping and norm
   constraint 1e-3, inverses every 5; ``median_clip_and_mask(clip_width=5,
   median_center=False)``) and ``train.yaml`` with the ``default`` preset
   (1000 walkers, ``decorr_langevin``, the same KFAC,
   ``median_log_squeeze_and_mask`` and ``alpha=4.0``), both with Adam
   pretraining (lr 3e-4) on the 'sto-6g' SCF, through ``train.train``, cut to
   10 pretraining steps, 10 equilibration calls, 6 fit steps and a checkpoint
   every 3 steps in the git-ignored ``runs/zoo_path`` (removed after each
   run).  Pretraining and equilibration launch no kernel; each fit step must
   be finite, change the parameters and launch the flat slogdet kernel once
   and nothing else.  It prints the median evaluation step and local-energy
   time, the median pretraining step, equilibration call and fit step of each
   run, and the peak device memory.

11. excited path: ``train.train`` with ``train_excited_psiformer.yaml``'s
   settings: 2 electronic states of the full-width PsiFormer (one module per
   state, each from its own generator forked from seed 0; no merge keys),
   2048 walkers per state, ``decorr_metropolis_psiformer``, KFAC as
   ``kfac_psiformer`` (lr 0.05 / (1 + n / 50000), damping and norm
   constraint 1e-3, inverses every 5) over both states with one trust
   region, the loss with ``alpha=4.0``, ``scale_overlap_by='max_gap_std'``,
   ``min_gap_scale_factor=1e-3``, ``median_clip_and_mask(clip_width=5,
   median_center=True)`` and ``psi_ratio_clip_and_mask``, a ``SpinMonitor``
   every step, LAMB pretraining on CASCI(4, 4) targets over the 'sto-6g' SCF;
   cut to 20 pretraining steps, 10 equilibration calls, 6 fit steps and a
   checkpoint every 3 in the git-ignored ``runs/excited_path`` (removed at the
   end).  Each fit step launches the attention kernel 8 times and the flat
   slogdet kernel twice (4 + 1 per state; the ratio, spin and refresh forwards
   none); every step finite; both states' parameters change and differ; the
   overlap matrix finite with its unit diagonal, the spin finite; the last
   checkpoint reloads both states' parameters, KFAC states and walkers bit
   for bit.  E_loc of 64 of each state's last walkers and the penalised
   gradient of both states (64 walkers each, non-zero one-sided overlaps) are
   held to the float64 plain path by the local energy's rule.  Then 5 more
   steps split by CUDA events (sampling, the local energy per state, the
   ratio forwards, gradient and taps, KFAC update, psi refresh, the spin
   monitor) and 3 evaluation steps from the last checkpoint with
   ``OscillatorStrengthMonitor`` and ``SpinMonitor`` (walkers kept): the same
   launches, finite, oscillator strengths with a zero diagonal, parameters
   unchanged.  It prints the SCF and CASCI seconds, the medians of each
   phase, the split and the peak device memory.

12. cli path: the command line, ``python3 -m deepqmc_tpu_torch`` in a
   subprocess: ``task=train_psiformer ansatz=psiformer hamil/mol=H2O`` at 2048
   walkers cut to 5 pretraining steps, 5 equilibration calls and 5 fit steps
   in the git-ignored ``runs/cli_path/train`` (kept for the force path, then
   removed), then ``task=evaluate`` of 3 steps from its checkpoint in
   ``runs/cli_path/evaluate`` (removed at the end), both with the metric and HDF5 sinks turned off on the command line
   (the card's machine has no tensorboardX or h5py; a line says so).  Both
   must exit 0 and write their log, their composed config and (training) the
   checkpoints of steps 0 and 5; each fit and evaluation step, read from the
   run's log, must launch the attention kernel 4 times and the flat slogdet
   kernel once, with a finite energy.  It prints each subprocess's wall time,
   the time to its first step, the median step and the peak device memory.
13. force path: the kernels' wrappers given an operand that carries a
   forward-mode tangent on the card must raise and launch nothing.  Then
   ``evaluate_forces.yaml``'s four force monitors and the bare one
   (``observable.ForceMonitor``) over 2 evaluation steps from the cli path's
   training checkpoint (H2O at full width, its 2048 walkers, ``train.train``
   with ``opt=None`` and recording sinks): each step launches the attention
   kernel 4 times and the flat slogdet kernel once (the local energy; the
   estimators' tangent pass runs the plain cores), every estimator's samples
   finite.  Each estimator on those walkers timed alone, launching nothing,
   with its peak device memory.  The gate: E_loc and the five estimators of 16
   of the walkers, the card in float32 (E_loc by the kernels) against the
   plain path in float64 on the CPU by the local energy's rule; the tangent
   pass (J, t, grad_r t, lap_r t) in float64 on the card against the CPU
   within 1e-8 relative.  Then ``python3 -m deepqmc_tpu_torch
   task=evaluate_forces task.restdir=... task.h5_logger=null`` in a
   subprocess: exit 0, 2 evaluation steps read from its log, each with the
   launches of one local energy;
14. ecp path: ScO with ccECPs on both nuclei and the full-width PsiFormer,
   composed from the conf tree (``hamil/mol=ScO +hamil.ecp_type=ccECP
   ansatz=psiformer``): 11 + 6 valence electrons split 9/8, K = 51.  Kernels
   1 and 2 against their plain versions at this shape (B = 64 and 512, with
   the slogdet body taken); E_loc of 64 walkers with V_nl on the same
   quadrature rotations, the card in float32 with kernels against the plain
   path in float64 on the CPU by the local energy's rule (one local energy:
   4 attention and 1 flat slogdet launch), and V_nl alone by the same rule
   (relative to max(1, |V_nl|)), on ``init_sample`` walkers and again on 64
   walkers after 10 equilibration calls on the card; the local energy of 512 walkers
   split by CUDA events into the kinetic FL pass and V_nl, with its peak
   memory; then a cut ``task=train_psiformer`` through
   ``app.cli`` in this process (512 walkers, no pretraining: the ScO SCF does
   not fit the run; 10 equilibration calls, 3 fit steps, in the git-ignored
   ``runs/ecp_path``, removed at the end), each fit step finite with 4
   attention and 1 flat slogdet launch.  It prints the times, the fit step
   and the peak device memory.
15. benzene path: benzene (42 electrons, 21 up and 21 down, K = 126) with the
   full-width PsiFormer (seed-0 weights): 3 evaluation steps of 512 walkers
   through ``deepqmc_tpu_torch.evaluate`` with the local energy in chunks of
   128 walkers (``eloc_walker_chunk``): per step 16 attention launches at
   n = 42 and 4 flat slogdet launches, whose last took the tiled body; E_loc
   finite; E_loc of 16 of the walkers against the float64 plain path by the
   local energy's rule; one KFAC step through ``fit.train`` with both walker
   chunks at 128 (``DEEPQMC_TPU_ELOC_WALKER_CHUNK`` and
   ``DEEPQMC_TPU_GRAD_WALKER_CHUNK``): the launches of one chunked local
   energy, the parameters changed and finite.  It prints the step time, the
   local energy's time and the peak device memory.
16. deeperwin path: the DeepErwin preset at full width on H2O (32 full
   determinants, embedding 256, 4 interactions, two-particle width 32;
   seed-0 weights), 3 evaluation steps of 2048 walkers through
   ``deepqmc_tpu_torch.evaluate``: each launches the flat slogdet kernel
   once (at D = 32, n = 10 split 5/5) and nothing else, E_loc finite, E_loc
   of 64 walkers against the float64 plain path by the local energy's rule.
   Then one evaluation step of the transferable components at the widths of
   ``tests/test_transferable.py`` (nuclear embeddings, combined attention
   over 3 nuclei and 10 electrons, a nuclear head feeding nucleus-dependent
   envelopes, the nuclear cusp): one flat slogdet launch and one attention
   launch a layer, E_loc against float64.  Then ``python3 -m
   deepqmc_tpu_torch ansatz=deeperwin hamil/mol=H2O`` (the default task,
   train.yaml: 1000 walkers, ``decorr_langevin``, KFAC, SCF pretraining) in
   a subprocess, cut to 5 pretraining steps, 5 equilibration calls and 6 fit
   steps with a checkpoint every step in the git-ignored
   ``runs/deeperwin_path`` (removed at the end): each fit step, read from its
   log, finite with one flat slogdet launch, and each changes the parameters
   (checkpoints 0-6, all finite).  It prints the step times, the local
   energy's time, the peak device memory, the fit step and the time to the
   first step.
17. mol batch path: the full-width H2O PsiFormer (seed-0 weights) on four
   geometries of H2O (both O-H bonds at 0.9, 1.0, 1.1 and 1.25 times
   ``molecule.py``'s, built in memory), two a step (``molecule_batch_size=2``)
   at 2048 walkers a molecule through ``train.train``: no pretraining, 5
   equilibration calls, 5 KFAC fit steps (bench.py's KFAC, decorr 10), then
   2 evaluation steps from its state (``opt=None``).  Each step takes both
   molecules' walkers through one local energy, so it launches the attention
   kernel 4 times and the flat slogdet kernel once, at B = 4096; every step
   finite, the fit changing the parameters, the energy EWM set for every
   molecule a step touched.  E_loc, the gradient and one KFAC update (from
   the run's optimizer state) on 64 walkers a molecule of two molecules, the
   card in float32 against the plain path in float64 on the CPU by the local
   energy's rule.  It prints the fit and evaluation step times and the peak
   device memory;
18. dp path: data parallelism over two ranks on the one card (``gloo``, which
   takes CUDA tensors; NCCL refuses two ranks on one GPU), started by this
   script as two processes of itself (``--dp-rank``) after its build, so they
   load the built library.  The same PsiFormer (seed-0 weights) and two of
   the geometries, 2048 walkers a molecule in all (1024 a rank).  On fixed
   walkers this script writes under ``runs/dp_path`` each rank takes
   the gradient and one KFAC update: rank 0's must hold to this process's on
   the whole batch by the local energy's rule (the bars the mol batch path's
   plain float32 path set); one local energy launches the attention kernel 4
   times and the flat slogdet kernel once on each rank (B = 2048).  Then 3
   KFAC steps through ``fit.train`` on each rank, each with those launches
   and finite, after which the parameters must be bitwise equal across the
   ranks.  A rank that fails fails the phase; one that hangs is stopped by
   the phase's budget.  Then one ``nccl`` process group of one rank in this
   process takes one step of the same run, so the NCCL code path runs.  It
   prints the step times of the two ranks and of the one-rank group.
19. precision path: the JAX package's precision levers.  Kernels 1-4 with
   bf16-stored Jacobians (and kernel 1's low mode, with bf16 and with float32
   Jacobians) against their plain versions fed the same operands upcast, at
   B = 256 and 2048 and at odd shapes (n = 2, 7, 33, 42; the slogdet kernels'
   one-bf16 copies, shifted square runs and n = 2 with no down rows), two
   launches bitwise equal, timed at B = 2048 beside their bound at the bf16
   bytes; the error of a float32 product under each label ('default' shows
   whether cuBLAS takes bf16 for 'medium').  One local energy of the main
   path's model on its last walkers under ``DEEPQMC_TPU_JAC_DTYPE=bf16``,
   with ``JAC_MATMUL`` f32 and bf16: kernel 1 launched 4 times and kernel 2
   once, each with a bf16 Jacobian (the wrappers count by dtype); E_loc of 64
   walkers against the float64 plain path without levers by the local
   energy's rule, its bar set by the float32 plain path under the same levers;
   ``JAC_MATMUL=bf16`` alone runs kernel 1 in its low mode on float32
   Jacobians.  The four log-determinant rules on a bf16 store (kernel 2
   twice, kernels 3 and 4 once, all bf16).  10 Metropolis moves under
   ``SAMPLING_PRECISION=high`` (log|psi| of the sampled walkers against
   'highest') and one gradient under ``GRAD_PRECISION=high`` (against
   'highest', relative L2), the matmul precision 'highest' inside each local
   energy and after each context.  Then, printed and not gated, an
   evaluation step with every lever off and on and a training step with
   every lever on (the trace path times the levers-off training steps).

20. trace path: the port's spans (``deepqmc_tpu_torch.tracing``) against
   ``torch.profiler``'s device trace.  The host clock: 20 launches into an
   idle device over 1 s, each between two host times, must each find its
   launch call in the trace between them.  The device's intervals may lie
   earlier than their launches, by a lag that may grow (the card's timer
   converted); ``qmcbench/program_spans.py`` estimates it from every launch
   in the trace.  Moved later by it, a
   ``torch.cuda._sleep`` kernel of about 10 ms launched in a span that then
   synchronises must lie inside the span, and a device-idle gap must cover
   at least 95 % of a span around a host-only ``time.sleep(0.02)`` between
   two short kernels, starting within 50 us of the span's start and ending
   no earlier than the span's end and the next launch call (the host's time
   from the span's end to that call is printed, not bounded: it is the
   profiler's and Python's overhead, 41-75 us).  Sync counting: 5
   ``.item()`` calls in a span read ``syncs`` 5, a span of queued launches
   alone 0.  Then 3 KFAC steps of the main path's model (fresh seed-0
   weights, 2048 walkers, decorr 10) through ``fit.train`` with tracing on:
   each step's span tree holds the sampling (10 moves), the local energy,
   the gradient, KFAC (its inverses on step 0 only, period 5) and the psi
   refresh, and its ``step`` span the launches of one local energy (4
   attention, 1 flat slogdet).  It prints the clock offsets, the syncs of
   each span, ``tracing.summary()`` and the three steps' times (the
   precision path's levers-off training timing, taken here).

The kernels phase also takes kernel 2 (and the square kernels) at the
deeperwin path's shape, B = 2048, K = 30, D = 32, n = 10 split 5/5, and
kernel 1 at the transferable components' (B = 2048, K = 30, 13 tokens, 2
heads of 8), each against its plain version, bitwise repeatable (kernel 2)
and timed beside its bound.

Each path's launch counts are read from a run that starts with every count
at 0.  It prints a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line; a watchdog ends a run that hangs.  Without CUDA, or without the
package beside it, it exits non-zero at once.
"""

import faulthandler
import json
import math
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

WATCHDOG_S = 1100  # the whole run, build included; the run's limit is 1200 s
PHASE_BUDGET_S = {
    'device': 60, 'build': 240, 'kernels': 300, 'main_path': 300, 'block_path': 180,
    'square_path': 120, 'train_path': 240, 'sampling_path': 240, 'run_path': 300,
    'zoo_path': 300, 'excited_path': 240, 'cli_path': 240, 'force_path': 240, 'ecp_path': 240,
    'benzene_path': 240, 'deeperwin_path': 180, 'mol_batch_path': 150, 'dp_path': 150,
    'precision_path': 60, 'trace_path': 120,
}

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 flop/s outside the tensor cores.  The bound of a kernel is the larger
# of its bytes over the first and its flops over the second.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Dense TF32 tensor-core flop/s of the same card.  The block kernel's products
# take three TF32 products per float32 one (split TF32), so its tensor-core
# floor is 3 flops over this rate; its ``bound_ms`` stays the float32 bound.
TF32_FLOPS_PER_S = 495e12

# Tolerances of the kernels against their plain versions, both float32 on the
# card: the two sum in other orders (K = 30 directions, dh = 64 products), so
# they agree to float32 rounding times the size of the sums, not bitwise.
KERNEL_RTOL = 1e-4  # max |kernel - plain| / max(1, max |plain|), per output
# Local energy on 64 walkers: the kernel path (float32, card) against the plain
# path in float64 (CPU).  Near a node of psi the forward Laplacian's float32
# rounding is amplified by the inverse of the Slater matrices, so the bar is the
# plain path's own float32 error on the same walkers (CPU): the kernel path's
# worst error, relative to max(1, |E_loc|), may be at most ELOC_FACTOR times
# that plus ELOC_FLOOR.
ELOC_FACTOR, ELOC_FLOOR = 10.0, 1e-4
# The block path and the per-op path on the card are two float32 computations,
# each held within the tolerance above of the float64 plain path on the same
# walkers, so they may be twice that apart.  The square path holds the four
# log-determinant dispatches to the same rule, per determinant, for log|det|,
# J and L: L grows near a node of a determinant, where its float32 rounding is
# amplified as E_loc's is.
BLOCK_VS_PER_OP_FACTOR = 2.0
# Kernels whose sums have one owner each and a fixed order: two launches on the
# same inputs must give the same bits.
DETERMINISTIC = ('fl_attention', 'fl_slogdet_traces', 'fl_slogdet_square',
                 'fl_slogdet_square_split', 'fl_block')


_T0 = time.monotonic()


class Phase:
    """Prints start/end lines; re-arms the watchdog with the phase's budget."""

    def __init__(self, name):
        self.name, self.budget = name, PHASE_BUDGET_S[name]

    def __enter__(self):
        left = WATCHDOG_S - (time.monotonic() - _T0)
        faulthandler.dump_traceback_later(max(1.0, min(self.budget, left)), exit=True)
        print(f'[{self.name}] start', flush=True)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.monotonic() - self.t0
        faulthandler.dump_traceback_later(max(1.0, WATCHDOG_S - (time.monotonic() - _T0)), exit=True)
        status = 'failed' if exc_type else 'end'
        print(f'[{self.name}] {status} after {dt:.2f} s', flush=True)
        if exc_type is None and dt > self.budget:
            raise SystemExit(f'phase {self.name} overran its budget of {self.budget} s')
        return False


def max_errors(out, ref):
    err = (out - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    return err, err / scale


def attention_inputs(gen, B, K=30, n=10, H=4, dh=64):
    import torch

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device='cuda', dtype=torch.float32)

    prim = [draw(B, n, H, dh) for _ in range(3)]
    jacs = [draw(B, K, n, H, dh) for _ in range(3)]
    laps = [draw(B, n, H, dh) for _ in range(3)]
    return (*prim, *jacs, *laps)


def inverse_input(gen, B, D, n):
    import torch

    # well-conditioned determinants, so m = A^-1 J stays of the size of J
    a = torch.eye(n, device='cuda') + 0.3 / n**0.5 * torch.randn(B, D, n, n, generator=gen,
                                                                 device='cuda')
    return torch.linalg.inv(a).contiguous()


def slogdet_inputs(gen, B, K=30, D=16, nu=5, nd=5):
    import torch

    n = nu + nd
    inv = inverse_input(gen, B, D, n)
    ju = torch.randn(B, K, nu, D * n, generator=gen, device='cuda')
    jd = torch.randn(B, K, nd, D * n, generator=gen, device='cuda')
    return inv, ju, jd


def square_inputs(gen, B, K=30, D=16, nu=5, nd=5):
    """inv, ja [B, K, D, n, n] and la of the square kernel (n = nu + nd)."""
    import torch

    n = nu + nd
    inv = inverse_input(gen, B, D, n)
    ja = torch.randn(B, K, D, n, n, generator=gen, device='cuda')
    return inv, ja, torch.randn(B, D, n, n, generator=gen, device='cuda')


def square_split_inputs(gen, B, K=30, D=16, nu=5, nd=5):
    """inv, ju [B, K, D, nu, n], jd [B, K, D, nd, n] and la of the square split kernel."""
    inv, ja, la = square_inputs(gen, B, K, D, nu, nd)
    return inv, ja[..., :nu, :].contiguous(), ja[..., nu:, :].contiguous(), la


def attention_bound_ms(B, K=30, n=10, H=4, dh=64, jbytes=4):
    """Kernel 1's bound; ``jbytes`` the bytes of a Jacobian element (2 for bf16)."""
    f = 4
    nbytes = f * B * H * n * dh * (6 + 2) + jbytes * B * K * n * H * dh * (3 + 1)
    flops = B * H * (12 * K * n * n * dh + 12 * n * n * dh + 20 * K * n * n)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S), nbytes, flops


def slogdet_bound_ms(B, K=30, D=16, n=10, with_l=False, jbytes=4):
    """The slogdet kernels' bound; ``with_l`` for the square ones, which also
    read L and form tr(A^-1 L); ``jbytes`` the bytes of a Jacobian element."""
    f = 4
    nbytes = (f * ((2 if with_l else 1) * B * D * n * n + B * K * D + B * D)
              + jbytes * B * K * n * D * n)
    flops = B * D * K * (2 * n * n * n + 3 * n * n) + (2 * B * D * n * n if with_l else 0)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S), nbytes, flops


def square_bound_ms(B):
    return slogdet_bound_ms(B, with_l=True)


def block_layer(d=256, H=4, seed=0, block_kernel=False):
    """One PsiFormer layer on the card with the preset's initialisation."""
    import torch

    from deepqmc_tpu_torch.gnn.update_features import NodeAttentionElectronUpdateFeature

    gen = torch.Generator().manual_seed(seed)
    return NodeAttentionElectronUpdateFeature.psiformer(d, num_heads=H, gen=gen,
                                                        block_kernel=block_kernel).cuda()


def body_of(kernel):
    """Which body of ``csrc/fl_slogdet.cu`` the last launch of a slogdet kernel took."""
    p = kernel.last_plan
    return f'{("staged", "tiled")[p.body]} body, G={p.G}, S={p.S}'


def block_inputs(gen, B, K=30, n=10, d=256, H=4):
    import torch

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device='cuda', dtype=torch.float32)

    return (draw(B, n, d), draw(B, K, n, d), draw(B, n, d),
            *(w.detach() for w in block_layer(d, H).block_weights()), H)


def block_bound_ms(B, K=30, n=10, d=256, H=4):
    f = 4
    nbytes = f * (4 * B * n * d + 2 * B * K * n * d + 6 * d * d + 2 * d)
    dh = d // H
    flops = B * (12 * (K + 2) * n * d * d
                 + H * (12 * K * n * n * dh + 12 * n * n * dh + 20 * K * n * n))
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S), nbytes, flops


def eloc_rel_errors(hamil, wf, r64, R, plain_wfs):
    """E_loc of ``wf`` (card) and of the float32 plain path (CPU) on the walkers
    ``r64``, each relative to the float64 plain path (CPU); with the values."""
    import torch

    import deepqmc_tpu_torch as dq

    mol_idx = torch.zeros(len(r64), dtype=torch.long)
    e_path = {}
    with torch.inference_mode():
        e_path['card'], _ = hamil.local_energy(
            wf, dq.PhysicalConfiguration(R, r64, mol_idx.cuda()))
        for name, wf_cpu in plain_wfs.items():
            dtype = next(wf_cpu.parameters()).dtype
            e_path[name], _ = hamil.local_energy(wf_cpu, dq.PhysicalConfiguration(
                R.cpu().to(dtype), r64.cpu().to(dtype), mol_idx))
    ref = e_path['plain_f64']
    scale = ref.abs().clamp(min=1.0)
    rel = {k: ((e_path[k].double().cpu() - ref).abs() / scale).max().item()
           for k in ('card', 'plain_f32')}
    return rel, e_path['card'], scale


def kfac_state_to(opt_state, dtype, device, step=None):
    """A copy of a KFAC state in ``dtype`` on ``device`` (its step moved to ``step``)."""
    return {
        'step': opt_state['step'] if step is None else step,
        'ema_weight': opt_state['ema_weight'],
        **{key: {p: tuple(t.to(device=device, dtype=dtype) for t in pair)
                 for p, pair in opt_state[key].items()}
           for key in ('factors', 'inverses')},
    }


def flat_params(wf):
    import torch

    return torch.cat([p.detach().flatten() for p in wf.parameters()])


def rel_l2(got, ref):
    """|got - ref| / |ref|, both flat, in float64 on the CPU."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return ((got - ref).norm() / ref.norm()).item()


def force_rel_errors(hamil, wf, r64, tau, R):
    """The cleaned Langevin force of ``wf`` (card) and of the float32 plain path
    (CPU) on the walkers ``r64``, each against the float64 plain path (CPU):
    |F - F_64| / max(1, |F_64|), global L2 norms."""
    import torch

    import deepqmc_tpu_torch as dq
    from deepqmc_tpu_torch.sampling import LangevinSampler

    weights = {k: v.cpu() for k, v in wf.state_dict().items()}
    forces = {}
    for name, dtype, device in (('card', torch.float32, 'cuda'),
                                ('plain_f64', torch.float64, 'cpu'),
                                ('plain_f32', torch.float32, 'cpu')):
        wf_r = dq.psiformer_ansatz(hamil, seed=0).to(device=device, dtype=dtype)
        wf_r.load_state_dict({k: v.to(dtype) for k, v in weights.items()})
        state = {'r': r64.to(device, dtype), 'age': torch.zeros(len(r64), dtype=torch.long),
                 'tau': tau.to(device, dtype)}
        with torch.no_grad():
            forces[name] = LangevinSampler(hamil, wf_r).update(state, R.to(device, dtype))['force']
    ref = forces['plain_f64'].double().cpu()
    scale = max(1.0, ref.norm().item())
    return {k: (forces[k].double().cpu() - ref).norm().item() / scale
            for k in ('card', 'plain_f32')}


def sampling_path(dq, hamil, R, smi, counts, zero_counts, per_op_step):
    """Phase 8: equilibration and training with a recipe, the force against
    float64, the slogdet layouts, a sample call per recipe, two geometries."""
    import torch

    from deepqmc_tpu_torch.ewm import init_multi_mol_multi_state_ewm
    from deepqmc_tpu_torch.fit import (
        DEFAULT_OPT_KWARGS,
        TrainState,
        molecule_state,
        train_step,
        walker_weights,
    )
    from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask
    from deepqmc_tpu_torch.ops.slogdet import unflatten_dets
    from deepqmc_tpu_torch.optimizer import KFACOptimizer
    from deepqmc_tpu_torch.sampling import (
        RECIPES,
        DecorrSampler,
        MetropolisSampler,
        ResampledSampler,
        chain,
        initialize_sampler_state,
        initialize_sampling,
    )
    from deepqmc_tpu_torch.utils import cuda_median_ms

    torch.cuda.reset_peak_memory_stats()
    wf = dq.psiformer_ansatz(hamil, seed=0).cuda()
    zero_counts()
    seen, before = counts(), flat_params(wf)
    eq_s, step_s, last_eq = [], [], None
    t0 = time.monotonic()
    for step, state, E_loc, stats in dq.fit.train(hamil, wf, n_walkers=2048, steps=3, seed=0,
                                              sampler='decorr_langevin', max_eq_steps=60):
        torch.cuda.synchronize()
        (eq_s if E_loc is None else step_s).append(time.monotonic() - t0)
        now, after = counts(), flat_params(wf)
        launches = {k: now[k] - seen[k] for k in now}
        if E_loc is None:
            last_eq = (step, stats, state.sampler)
            if any(launches.values()):
                raise SystemExit(f'equilibration call {step} launched {launches}')
        else:
            loss = stats['local_energy/mean'].item()
            print(f'langevin train step {step}: loss {loss:.6f} acceptance '
                  f'{stats["sampling/acceptance"].item():.4f} tau '
                  f'{stats["sampling/tau"].item():.4f} time {step_s[-1]:.3f} s; launches '
                  f'{launches}', flush=True)
            if not (math.isfinite(loss) and torch.isfinite(E_loc).all()
                    and all(torch.isfinite(v).all() for v in stats.values())):
                raise SystemExit(f'langevin train step {step} not finite')
            if torch.equal(after, before):
                raise SystemExit(f'langevin train step {step} left the parameters unchanged')
            if launches != per_op_step:
                raise SystemExit(f'langevin train step {step} launched {launches}, '
                                 f'want {per_op_step}')
        seen, before = now, after
        t0 = time.monotonic()
    eq_step, eq_stats, eq_state = last_eq
    eq_median = sorted(eq_s)[len(eq_s) // 2]
    print(f'{smi} | equilibration (decorr_langevin, 2048 walkers, at most 60 calls, early '
          f'stopping on): {len(eq_s)} calls, median {eq_median:.4f} s a call (first '
          f'{eq_s[0]:.3f} s, all {sum(eq_s):.2f} s); at the end tau '
          f'{eq_stats["sampling/tau"].item():.4f}, acceptance '
          f'{eq_stats["sampling/acceptance"].item():.4f}', flush=True)
    print(f'{smi} | training step (decorr_langevin, KFAC, 2048 walkers): median of 3 '
          f'{1e3 * sorted(step_s)[1]:.1f} ms (steps '
          f'{", ".join(f"{1e3 * t:.1f}" for t in step_s)} ms)', flush=True)

    # the cleaned force of 64 equilibrated walkers against float64
    _, elec = molecule_state(eq_state)
    rel = force_rel_errors(hamil, wf, elec['r'][:64], elec['tau'], R)
    tol = ELOC_FACTOR * rel['plain_f32'] + ELOC_FLOOR
    ok = rel['card'] <= tol
    print(f'Langevin force on 64 walkers against the plain path in f64 (CPU), global L2 '
          f'relative to max(1, |F|): card (f32) {rel["card"]:.3e}; plain path (f32, CPU) '
          f'{rel["plain_f32"]:.3e}; tol {tol:.3e} {"ok" if ok else "FAIL"}', flush=True)
    if not ok:
        raise SystemExit('the Langevin force on the card disagrees with the plain path')

    # log|det| of the equilibrated walkers' Slater matrices: strided view and copy
    with torch.no_grad():
        pc = dq.PhysicalConfiguration(R, elec['r'], torch.zeros(2048, dtype=torch.long,
                                                                device='cuda'))
        a_flat = torch.cat(wf._spin_orbitals(pc), -2)
        view = unflatten_dets(a_flat, wf.n_det)
        ref = torch.linalg.slogdet(view.double())[1]
        for label, a in (('strided view', view), ('contiguous copy', view.contiguous())):
            err = (torch.linalg.slogdet(a)[1].double() - ref).abs()
            rel_det = err / ref.abs().clamp(min=1.0)
            print(f'{smi} | slogdet of the {label} (f32, card, stride {tuple(a.stride())}) '
                  f'against f64: log|det| max abs err {err.max().item():.3e}, median '
                  f'{err.median().item():.3e}, max rel (to max(1, |ref|)) '
                  f'{rel_det.max().item():.3e}', flush=True)
        del pc, a_flat, view

    # one sample call of each recipe at 2048 walkers, from the equilibrated walkers
    recipes = {'bench.py Metropolis (decorr 10)':
               lambda hamil, wf: DecorrSampler(length=10).wrap(MetropolisSampler(hamil, wf)),
               **RECIPES}
    gen = torch.Generator('cuda').manual_seed(3)
    for name, factory in recipes.items():
        sampler = factory(hamil=hamil, wf=wf)
        with torch.no_grad():
            state = sampler.update({'r': elec['r'], 'age': torch.zeros_like(elec['age']),
                                    'tau': torch.tensor(sampler.initial_tau, device='cuda')}, R)
            ms = cuda_median_ms(lambda: sampler.sample(gen, state, R), runs=3, warmup=1)
        print(f'{smi} | sample call of {name} ({sampler.length} moves, 2048 walkers): '
              f'{ms:.2f} ms', flush=True)
        del state

    # two geometries, one molecule a step, walkers weighted by ResampledSampler
    coords = hamil.mol.coords
    stretched = coords.copy()
    stretched[1:] = coords[0] + 1.1 * (coords[1:] - coords[0])
    mols = [hamil.mol, dq.Molecule(coords=stretched, charges=hamil.mol.charges,
                                   charge=hamil.mol.charge, spin=hamil.mol.spin)]
    wf2 = dq.psiformer_ansatz(hamil, seed=0).cuda()
    factory = lambda hamil, wf: chain(  # noqa: E731
        ResampledSampler(period=3), DecorrSampler(length=10),
        MetropolisSampler(hamil, wf, max_age=20))
    idx_sampler, sampler = initialize_sampling(torch.Generator().manual_seed(2), hamil, wf2,
                                               mols, 1, 1, elec_sampler=factory)
    with torch.no_grad():
        state = initialize_sampler_state(torch.Generator().manual_seed(0), sampler, 2048, mols,
                                         dtype=torch.float32, device='cuda')
    opt = KFACOptimizer(create_loss_fn(hamil, wf2, median_log_squeeze_and_mask),
                        **DEFAULT_OPT_KWARGS['kfac'])
    R0, elec0 = molecule_state(state)
    train_state = TrainState(state, wf2.state_dict(),
                             opt.init(MetropolisSampler.phys_conf(R0, elec0['r'])))
    ewm, update_ewm = init_multi_mol_multi_state_ewm((2, 1), device='cuda')
    std_ewm = ewm
    gen = torch.Generator('cuda').manual_seed(1)
    zero_counts()
    seen, before, two_s = counts(), flat_params(wf2), []
    for step in range(4):
        mol_idxs = idx_sampler.sample()
        i = mol_idxs.item()
        prev, prev_ewm = train_state.sampler, ewm
        t0 = time.monotonic()
        train_state, ewm, std_ewm, E_loc, _, stats = train_step(
            gen, sampler, opt, train_state, mol_idxs, ewm, std_ewm, update_ewm)
        torch.cuda.synchronize()
        two_s.append(time.monotonic() - t0)
        now, after = counts(), flat_params(wf2)
        launches = {k: now[k] - seen[k] for k in now}
        weight = walker_weights(train_state.sampler, mol_idxs)
        ess = stats['sampling/effective sample size'].item()
        print(f'two geometries, step {step}: molecule {i}, E_loc mean '
              f'{stats["local_energy/mean"].item():.6f}, largest weight '
              f'{weight.max().item():.4f}, effective sample size {ess:.1f} of 2048, time '
              f'{two_s[-1]:.3f} s; launches {launches}', flush=True)
        new = train_state.sampler
        if not all(torch.equal(new['elec'][k][1 - i], prev['elec'][k][1 - i])
                   for k in ('r', 'age', 'tau', 'step')):
            raise SystemExit(f'step {step} on molecule {i} changed the other molecule\'s walkers')
        if torch.equal(new['elec']['r'][i], prev['elec']['r'][i]):
            raise SystemExit(f'step {step} left the walkers of molecule {i} where they were')
        if not all(torch.allclose(a[1 - i], b[1 - i], rtol=0, atol=0, equal_nan=True)
                   for a, b in zip(ewm, prev_ewm)) or torch.equal(ewm.buffer[i],
                                                                  prev_ewm.buffer[i]):
            raise SystemExit(f'step {step} updated the EWM grid outside molecule {i}')
        if not (torch.isfinite(weight).all() and (weight > 0).all()
                and abs(weight.mean().item() - 1) < 1e-5):
            raise SystemExit(f'step {step}: the walker weights are not finite, positive and '
                             'of unit mean')
        if not (torch.isfinite(E_loc).all() and not torch.equal(after, before)
                and launches == per_op_step):
            raise SystemExit(f'step {step}: not finite, parameters unchanged or launches '
                             f'{launches}, want {per_op_step}')
        seen, before = now, after
    print(f'{smi} | two geometries (ResampledSampler, decorr 10, max_age 20, KFAC): steps '
          f'{", ".join(f"{1e3 * t:.1f}" for t in two_s)} ms', flush=True)
    print(f'{smi} | sampling path peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
    del wf, wf2, train_state, state, opt
    torch.cuda.empty_cache()


# The run path's cuts of train_psiformer.yaml (its settings otherwise): 4096
# walkers, pretraining 40 steps of 20,000, equilibration 20 calls of 1000,
# the fit 8 steps of 200,000, a checkpoint every 4 steps (of 1000); then 3
# evaluation steps from the last checkpoint
RUN_WALKERS, RUN_PRETRAIN_STEPS, RUN_EQ_STEPS, RUN_FIT_STEPS = 4096, 40, 20, 8
RUN_CHKPT_INTERVAL, RUN_EVAL_STEPS = 4, 3


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _recording_sinks(counts, wf):
    """Stand-ins for a run's metric sink and ``H5Logger`` (h5py is optional):
    ``records`` gets each update's time, launch counts, stats and (fit and
    evaluation steps) the parameters after it; ``rows`` each results row's
    entries that it would write, by key."""
    import torch

    from deepqmc_tpu_torch.utils import flatten_dict

    records, rows = [], []

    class Metrics:
        def __init__(self, workdir, n_mol):
            pass

        def update(self, step, stats, multi_stats, mol_idxs, prefix=None):
            torch.cuda.synchronize()
            records.append(dict(t=time.monotonic(), prefix=prefix, step=step, counts=counts(),
                                stats={**multi_stats, **stats}, mol_idxs=list(mol_idxs),
                                params=None if prefix else flat_params(wf)))

        def close(self):
            pass

    class Results:
        def __init__(self, workdir, keys, *, init_step=0, aux_data=None):
            self.keys = ['local_energy', *keys]

        def update(self, data):
            rows.append({k: v for k, v in flatten_dict(data).items()
                         if any(p in k for p in self.keys)})

        def close(self):
            pass

    return records, rows, Metrics, Results


def _cut_run(smi, hamil, wf, opt, sampler_factory, loss_function_factory, *, label, walkers,
             pretrain_steps, pretrain_kwargs, eq_steps, fit_steps, chkpt_interval, workdir,
             counts, zero_counts, per_step, **train_kwargs):
    """``train.train`` on the card, cut in depth, with the checks every cut run
    shares: the phases it was given and one SCF, a finite pretraining MSE, no
    launch before the fit, per fit step the launches ``per_step``, finite
    stats and changed parameters, the samples recorded and a checkpoint every
    ``chkpt_interval`` steps.  ``train_kwargs`` go to ``train.train``.  Prints
    each phase's median; returns the run's state and its pretraining and fit
    records."""
    import logging
    from functools import partial

    import numpy as np
    import torch

    from deepqmc_tpu_torch.log import CheckpointStore
    from deepqmc_tpu_torch.train import train

    records, rows, Metrics, Results = _recording_sinks(counts, wf)
    writes, scf = [], []

    class TimedStore(CheckpointStore):
        def dump(self):
            t0 = time.monotonic()
            super().dump()
            path = self.chkpts[-1].path
            writes.append((path.name, path.stat().st_size, 1e3 * (time.monotonic() - t0)))

    class ScfTime(logging.Handler):
        def emit(self, record):
            if hasattr(record, 'scf_seconds'):
                scf.append(record.scf_seconds)

    shutil.rmtree(workdir, ignore_errors=True)
    logger = logging.getLogger('deepqmc_tpu_torch.train')
    handler, level = ScfTime(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    before = flat_params(wf)
    zero_counts()
    t0 = time.monotonic()
    try:
        state = train(
            hamil, wf, opt, sampler_factory, steps=fit_steps, seed=0,
            electron_batch_size=walkers, workdir=workdir, max_eq_steps=eq_steps,
            pretrain_steps=pretrain_steps, pretrain_kwargs=pretrain_kwargs,
            chkpt_constructor=partial(TimedStore, interval=chkpt_interval),
            metric_logger_constructor=Metrics, h5_logger_constructor=Results,
            loss_function_factory=loss_function_factory, device='cuda', **train_kwargs,
        )
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    run_s = time.monotonic() - t0

    pre, eq, fit = ([r for r in records if r['prefix'] == p]
                    for p in ('pretraining', 'equilibration', None))
    print(f'{label}: {len(pre)} pretraining steps, {len(eq)} equilibration calls, {len(fit)} '
          f'fit steps in {run_s:.1f} s; launches {counts()}', flush=True)
    if (len(pre) != pretrain_steps or len(eq) != eq_steps or len(fit) != fit_steps
            or state.opt['step'] != fit_steps or len(scf) != 1):
        raise SystemExit(f'{label}: the run did not take the phases it was given')
    if not all(math.isfinite(float(np.mean(r['stats']['MSE']))) for r in pre):
        raise SystemExit(f'{label}: the pretraining MSE is not finite')
    if any(eq[-1]['counts'].values()):
        raise SystemExit(f'{label}: pretraining and equilibration launched {eq[-1]["counts"]}')
    prev, prev_params = eq[-1]['counts'], before
    for r in fit:
        launches = {k: r['counts'][k] - prev[k] for k in prev}
        prev = r['counts']
        e = r['stats']['local_energy/mean']
        print(f'{label} fit step {r["step"]}: E_loc mean {float(np.mean(e)):.6f} std '
              f'{float(np.mean(r["stats"]["local_energy/std"])):.6f} step time '
              f'{r["stats"]["perf/step_time"]:.3f} s; launches {launches}', flush=True)
        if launches != per_step:
            raise SystemExit(f'{label} fit step {r["step"]} launched {launches}, want {per_step}')
        if not all(np.isfinite(v).all() for v in r['stats'].values()):
            raise SystemExit(f'{label} fit step {r["step"]}: stats not finite')
        if torch.equal(r['params'], prev_params):
            raise SystemExit(f'{label} fit step {r["step"]} left the parameters unchanged')
        prev_params = r['params']
    if len(rows) != fit_steps or not all(
            {'local_energy/samples', 'psi/samples/log'} <= row.keys() for row in rows):
        raise SystemExit(f'{label}: the fit did not record its samples')
    names = sorted(f for f in os.listdir(os.path.join(workdir, 'training'))
                   if f.startswith('chkpt-'))
    want = {f'chkpt-{i}.pt' for i in range(0, fit_steps + 1, chkpt_interval)}
    print(f'{label} checkpoints {names}; written {writes}', flush=True)
    if set(names) != want:
        raise SystemExit(f'{label}: checkpoints {names}, want {sorted(want)}')

    pre_s = [b['t'] - a['t'] for a, b in zip(pre, pre[1:])]
    eq_s = [b['t'] - a['t'] for a, b in zip(eq, eq[1:])]
    fit_s = [r['stats']['perf/step_time'] for r in fit]
    print(f'{smi} | {label} SCF (H2O, {pretrain_kwargs["scf_kwargs"]}, host numpy) '
          f'{scf[0]:.2f} s', flush=True)
    print(f'{smi} | {label} pretraining step ({pretrain_kwargs["opt"]}, {walkers} walkers): '
          f'median {1e3 * _median(pre_s):.1f} ms of {len(pre_s)} (first step to the second '
          f'{1e3 * pre_s[0]:.1f} ms)', flush=True)
    print(f'{smi} | {label} equilibration: {len(eq)} calls, median {1e3 * _median(eq_s):.1f} '
          'ms a call', flush=True)
    print(f'{smi} | {label} fit step (KFAC, {walkers} walkers): median '
          f'{1e3 * _median(fit_s):.1f} ms (steps {", ".join(f"{1e3 * t:.1f}" for t in fit_s)} '
          f'ms); launches a step {per_step}', flush=True)
    print(f'{smi} | {label} checkpoint {_median([b for _, b, _ in writes]) / 1e6:.2f} MB, '
          f'written in {", ".join(f"{ms:.1f}" for *_, ms in writes)} ms', flush=True)
    return state, pre, fit


def run_path(dq, hamil, smi, counts, zero_counts, per_op_step):
    """Phase 9: ``train.train`` as ``train_psiformer.yaml`` sets it (cut in
    depth), then an evaluation from its last checkpoint; returns the kernel
    launches of both runs."""
    from functools import partial

    import numpy as np
    import torch

    from deepqmc_tpu_torch.fit import TrainState
    from deepqmc_tpu_torch.log import CheckpointStore
    from deepqmc_tpu_torch.loss import create_loss_fn, median_clip_and_mask
    from deepqmc_tpu_torch.optimizer import KFACOptimizer
    from deepqmc_tpu_torch.sampling import RECIPES, initialize_sampling
    from deepqmc_tpu_torch.train import train
    from deepqmc_tpu_torch.utils import ConstantSchedule, InverseSchedule

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs', 'run_path')
    print(f'run path: train_psiformer.yaml at full width, {RUN_WALKERS} walkers, cut: '
          f'pretraining {RUN_PRETRAIN_STEPS} steps (of 20000), equilibration {RUN_EQ_STEPS} '
          f'calls (of 1000), fit {RUN_FIT_STEPS} steps (of 200000), checkpoint interval '
          f'{RUN_CHKPT_INTERVAL} (of 1000); workdir {workdir}', flush=True)
    loss = partial(create_loss_fn, clip_mask_fn=partial(
        median_clip_and_mask, clip_width=5, median_center=True))
    sampler_factory = partial(initialize_sampling,
                              elec_sampler=RECIPES['decorr_metropolis_psiformer'])
    opt = partial(KFACOptimizer, learning_rate_schedule=InverseSchedule(0.05, 100000),
                  damping_schedule=ConstantSchedule(1e-3), norm_constraint=1e-3,
                  inverse_update_period=5)
    torch.cuda.reset_peak_memory_stats()
    wf = dq.psiformer_ansatz(hamil, seed=0).cuda()
    state, pre, _ = _cut_run(
        smi, hamil, wf, opt, sampler_factory, loss, label='run path', walkers=RUN_WALKERS,
        pretrain_steps=RUN_PRETRAIN_STEPS,
        pretrain_kwargs=dict(opt='lamb', opt_kwargs=dict(learning_rate=3e-4, b1=0.9, b2=0.999),
                             scf_kwargs=dict(basis='sto-6g')),
        eq_steps=RUN_EQ_STEPS, fit_steps=RUN_FIT_STEPS, chkpt_interval=RUN_CHKPT_INTERVAL,
        workdir=workdir, counts=counts, zero_counts=zero_counts, per_step=per_op_step,
    )
    train_launches = counts()
    mse = [float(np.mean(r['stats']['MSE'])) for r in pre]
    first, last = float(np.mean(mse[:10])), float(np.mean(mse[-10:]))
    print(f'pretraining MSE: first {mse[0]:.4e}, mean of the first 10 {first:.4e}, of the last '
          f'10 {last:.4e}, last {mse[-1]:.4e}', flush=True)
    if not last < first:
        raise SystemExit('pretraining: the MSE did not fall')
    path = os.path.join(workdir, 'training', f'chkpt-{RUN_FIT_STEPS}.pt')
    t0 = time.monotonic()
    step, loaded = CheckpointStore.load(path, 'cuda')
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.monotonic() - t0)
    print(f'{smi} | run path checkpoint read in {load_ms:.1f} ms', flush=True)
    if step != RUN_FIT_STEPS or not (
            all(torch.equal(loaded.params[k], v) for k, v in wf.state_dict().items())
            and torch.equal(loaded.sampler['elec']['r'], state.sampler['elec']['r'])):
        raise SystemExit('the last checkpoint does not hold the run\'s parameters and walkers')

    records, rows, Metrics, Results = _recording_sinks(counts, wf)
    before = {k: v.clone() for k, v in wf.state_dict().items()}
    zero_counts()
    train(hamil, wf, None, sampler_factory, steps=RUN_EVAL_STEPS, seed=0,
          electron_batch_size=RUN_WALKERS, workdir=workdir,
          train_state=TrainState(loaded.sampler, loaded.params, None),
          metric_logger_constructor=Metrics, h5_logger_constructor=Results, device='cuda',
          loss_function_factory=loss)
    torch.cuda.synchronize()
    ev = [r for r in records if r['prefix'] is None]
    prev = dict.fromkeys(train_launches, 0)
    for r in ev:
        launches = {k: r['counts'][k] - prev[k] for k in prev}
        prev = r['counts']
        e = r['stats']['local_energy/mean']
        print(f'run evaluation step {r["step"]}: E_loc mean {float(np.mean(e)):.6f} step time '
              f'{r["stats"]["perf/step_time"]:.3f} s; launches {launches}', flush=True)
        if launches != per_op_step or not np.isfinite(e).all():
            raise SystemExit(f'run evaluation step {r["step"]}: launches {launches} or E_loc '
                             'not finite')
    if len(ev) != RUN_EVAL_STEPS or len(rows) != RUN_EVAL_STEPS or records[0]['prefix']:
        raise SystemExit('the evaluation did not take its steps, or equilibrated')
    if not all(torch.equal(v, before[k]) for k, v in wf.state_dict().items()):
        raise SystemExit('the evaluation changed the parameters')

    ev_s = [r['stats']['perf/step_time'] for r in ev]
    print(f'{smi} | run path evaluation step ({RUN_WALKERS} walkers): median '
          f'{1e3 * _median(ev_s):.1f} ms (steps {", ".join(f"{1e3 * t:.1f}" for t in ev_s)} ms)',
          flush=True)
    print(f'{smi} | run path peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
    del wf, state, loaded
    torch.cuda.empty_cache()
    shutil.rmtree(workdir)  # four checkpoints of 34 MB each
    return {k: train_launches[k] + prev[k] for k in prev}


# zoo path: the FermiNet evaluation at 2048 walkers (3 steps, full and
# per-spin determinants); train_ferminet.yaml at 4096 walkers and train.yaml
# (the default ansatz) at 1000, each cut to 10 pretraining steps (of 1000 and
# 100), 10 equilibration calls (of 1000) and 6 fit steps (of 100,000 and
# 1000), a checkpoint every 3 steps
ZOO_EVAL_WALKERS, ZOO_EVAL_STEPS = 2048, 3
def check_eloc_64(label, hamil, R, wf, make_wf, r):
    """E_loc of ``wf`` on the card against float64 copies (``make_wf()`` on the
    CPU holding its weights) on 64 of the walkers ``r``, by the local energy's rule."""
    import torch

    weights = {k: v.cpu() for k, v in wf.state_dict().items()}
    plain_wfs = {}
    for name, dtype in (('plain_f64', torch.float64), ('plain_f32', torch.float32)):
        plain_wfs[name] = make_wf().to(dtype)
        plain_wfs[name].load_state_dict({k: v.to(dtype) for k, v in weights.items()})
    rel, _, _ = eloc_rel_errors(hamil, wf, r[:64], R, plain_wfs)
    tol = ELOC_FACTOR * rel['plain_f32'] + ELOC_FLOOR
    print(f'{label}: E_loc on 64 walkers against the plain path in f64 (CPU): kernel path '
          f'(f32, card) max rel err {rel["card"]:.3e}; plain path (f32, CPU) max rel err '
          f'{rel["plain_f32"]:.3e}; tol {tol:.3e}', flush=True)
    if not rel['card'] <= tol:
        raise SystemExit(f'{label}: the kernel-path local energy disagrees with the plain path')


ZOO_RUNS = {  # preset -> (task, walkers, recipe, pretraining and fit steps of the task)
    'ferminet': ('train_ferminet.yaml', 4096, 'decorr_metropolis_ferminet', 1000, 100000),
    'default': ('train.yaml', 1000, 'decorr_langevin', 100, 1000),
}
ZOO_PRETRAIN_STEPS, ZOO_EQ_STEPS, ZOO_FIT_STEPS, ZOO_CHKPT_INTERVAL = 10, 10, 6, 3


def zoo_path(dq, hamil, R, smi, counts, zero_counts):
    """Phase 10: the FermiNet and default presets at full width. FermiNet's
    evaluation with full and per-spin determinants (kernel 2 once and twice a
    local energy), then a cut training run of each preset through
    ``train.train``; after each, E_loc of 64 of its walkers against float64.
    Returns the kernel launches of the phase."""
    from functools import partial

    import torch

    from deepqmc_tpu_torch.fit import molecule_state
    from deepqmc_tpu_torch.loss import (
        create_loss_fn,
        median_clip_and_mask,
        median_log_squeeze_and_mask,
    )
    from deepqmc_tpu_torch.optimizer import KFACOptimizer
    from deepqmc_tpu_torch.sampling import RECIPES, initialize_sampling
    from deepqmc_tpu_torch.utils import ConstantSchedule, InverseSchedule, cuda_median_ms

    total = dict.fromkeys(counts(), 0)
    peak = []

    def take(launches):
        for k, v in launches.items():
            total[k] += v

    def slogdet_only(n):
        return dict.fromkeys(total, 0) | {'fl_slogdet_traces': n}

    torch.cuda.reset_peak_memory_stats()
    for full in (True, False):
        label = f'ferminet ({"full" if full else "per-spin"} determinants)'
        per_eloc = slogdet_only(1 if full else 2)
        make_wf = partial(dq.ferminet_ansatz, hamil, seed=0, full_determinant=full)
        wf = make_wf()
        zero_counts()
        seen, step_s, last = counts(), [], None
        t0 = time.monotonic()
        for step, state, E_loc, stats in dq.evaluate(
                hamil, wf, n_walkers=ZOO_EVAL_WALKERS, steps=ZOO_EVAL_STEPS,
                sampler='decorr_metropolis_ferminet', seed=0):
            torch.cuda.synchronize()
            step_s.append(time.monotonic() - t0)
            now = counts()
            launches = {k: now[k] - seen[k] for k in now}
            seen = now
            print(f'{label} step {step}: E_loc mean {stats["local_energy/mean"].item():.6f} std '
                  f'{stats["local_energy/std"].item():.6f} acceptance '
                  f'{stats["sampling/acceptance"].item():.4f} time {step_s[-1]:.3f} s; '
                  f'launches {launches}', flush=True)
            if not torch.isfinite(E_loc).all() or E_loc.shape != (ZOO_EVAL_WALKERS,):
                raise SystemExit(f'{label} step {step}: E_loc not finite or of shape '
                                 f'{tuple(E_loc.shape)}')
            if launches != per_eloc:
                raise SystemExit(f'{label} step {step} launched {launches}, want {per_eloc}')
            last = molecule_state(state)[1]
            t0 = time.monotonic()
        take(counts())
        with torch.inference_mode():
            pc = dq.PhysicalConfiguration(
                R, last['r'], torch.zeros(ZOO_EVAL_WALKERS, dtype=torch.long, device='cuda'))
            eloc_ms = cuda_median_ms(lambda: hamil.local_energy(wf, pc), runs=3, warmup=1)
        print(f'{smi} | zoo path {label}, {ZOO_EVAL_WALKERS} walkers: median evaluation step '
              f'{_median(step_s):.3f} s (steps {", ".join(f"{t:.3f}" for t in step_s)} s); local '
              f'energy alone {eloc_ms:.1f} ms; kernel 2 launches a local energy '
              f'{per_eloc["fl_slogdet_traces"]}', flush=True)
        check_eloc_64(label, hamil, R, wf, make_wf, last['r'])
        del wf, pc, last, state
        torch.cuda.empty_cache()
    peak.append(torch.cuda.max_memory_allocated() / 2**30)
    print(f'{smi} | zoo path FermiNet evaluation peak device memory {peak[-1]:.2f} GiB',
          flush=True)

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs', 'zoo_path')
    opt = partial(KFACOptimizer, learning_rate_schedule=InverseSchedule(0.05, 10000),
                  damping_schedule=ConstantSchedule(1e-3), norm_constraint=1e-3,
                  inverse_update_period=5)
    losses = {
        'ferminet': partial(create_loss_fn, clip_mask_fn=partial(
            median_clip_and_mask, clip_width=5.0, median_center=False)),
        'default': partial(create_loss_fn, clip_mask_fn=median_log_squeeze_and_mask, alpha=4.0),
    }
    for preset, (task, walkers, recipe, task_pre, task_fit) in ZOO_RUNS.items():
        label = f'zoo path {preset} run'
        print(f'zoo path: {task} ({preset} at full width), {walkers} walkers, {recipe}, cut: '
              f'pretraining {ZOO_PRETRAIN_STEPS} steps (of {task_pre}), equilibration '
              f'{ZOO_EQ_STEPS} calls (of 1000), fit {ZOO_FIT_STEPS} steps (of {task_fit}), '
              f'checkpoint interval {ZOO_CHKPT_INTERVAL}; workdir {workdir}', flush=True)
        make_wf = partial(dq.ansatz_preset(preset, seed=0), hamil)
        wf = make_wf().cuda()
        torch.cuda.reset_peak_memory_stats()
        state, *_ = _cut_run(
            smi, hamil, wf, opt, partial(initialize_sampling, elec_sampler=RECIPES[recipe]),
            losses[preset], label=label, walkers=walkers, pretrain_steps=ZOO_PRETRAIN_STEPS,
            pretrain_kwargs=dict(opt='adam', opt_kwargs=dict(learning_rate=3e-4, b1=0.9,
                                                             b2=0.999),
                                 scf_kwargs=dict(basis='sto-6g')),
            eq_steps=ZOO_EQ_STEPS, fit_steps=ZOO_FIT_STEPS, chkpt_interval=ZOO_CHKPT_INTERVAL,
            workdir=workdir, counts=counts, zero_counts=zero_counts, per_step=slogdet_only(1),
        )
        take(counts())
        peak.append(torch.cuda.max_memory_allocated() / 2**30)
        print(f'{smi} | {label} peak device memory {peak[-1]:.2f} GiB', flush=True)
        check_eloc_64(f'{label} (trained weights, last walkers)', hamil, R, wf, make_wf,
                      molecule_state(state.sampler)[1]['r'])
        del wf, state
        torch.cuda.empty_cache()
        shutil.rmtree(workdir)
    print(f'{smi} | zoo path peak device memory {max(peak):.2f} GiB', flush=True)
    return total


# excited path: train_excited_psiformer.yaml at full width, 2 states of 2048
# walkers each, cut to 20 pretraining steps (of 1000), 10 equilibration calls
# (of 1000) and 6 fit steps (of 100,000), a checkpoint every 3 steps; then 3
# evaluation steps from the last checkpoint as evaluate_excited.yaml
EXC_STATES, EXC_WALKERS, EXC_CAS = 2, 2048, (4, 4)
EXC_PRETRAIN_STEPS, EXC_EQ_STEPS, EXC_FIT_STEPS, EXC_CHKPT_INTERVAL = 20, 10, 6, 3
EXC_EVAL_STEPS, EXC_SPLIT_STEPS, EXC_CHECK_WALKERS = 3, 5, 64


def _state_copy(make, stack, dtype, device):
    """The state modules ``stack`` (each made by ``make()``) copied to ``dtype`` on ``device``."""
    from deepqmc_tpu_torch.wf import StateStack

    weights = {k: v.detach().cpu().to(dtype) for k, v in stack.state_dict().items()}
    out = StateStack([make() for _ in stack]).to(device=device, dtype=dtype)
    out.load_state_dict(weights)
    return out


def excited_path(dq, hamil, R, smi, counts, zero_counts, per_op_step):
    """Phase 11: ``train.train`` as ``train_excited_psiformer.yaml`` sets it
    (2 states, cut in depth), then an evaluation from its last checkpoint as
    ``evaluate_excited.yaml``; E_loc per state and the penalised gradient
    against float64; the fit step split by CUDA events.  Returns the kernel
    launches of both runs."""
    from functools import partial

    import numpy as np
    import torch

    from deepqmc_tpu_torch.fit import TrainState
    from deepqmc_tpu_torch.log import CheckpointStore
    from deepqmc_tpu_torch.loss import (
        create_loss_fn,
        median_clip_and_mask,
        psi_ratio_clip_and_mask,
    )
    from deepqmc_tpu_torch.loss.energy import compute_local_energy
    from deepqmc_tpu_torch.loss.loss_function import Terms
    from deepqmc_tpu_torch.observable import (
        Batch,
        OscillatorStrengthMonitor,
        SpinMonitor,
    )
    from deepqmc_tpu_torch.optimizer import KFACOptimizer
    from deepqmc_tpu_torch.sampling import RECIPES, initialize_sampling
    from deepqmc_tpu_torch.train import train
    from deepqmc_tpu_torch.utils import ConstantSchedule, InverseSchedule
    from deepqmc_tpu_torch.wf import init_wf_states

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs', 'excited_path')
    label = 'excited path'
    print(f'{label}: train_excited_psiformer.yaml at full width, {EXC_STATES} states of '
          f'{EXC_WALKERS} walkers, merge_keys None, seed 0; cut: pretraining '
          f'{EXC_PRETRAIN_STEPS} steps (of 1000), equilibration {EXC_EQ_STEPS} calls (of 1000), '
          f'fit {EXC_FIT_STEPS} steps (of 100000), checkpoint interval {EXC_CHKPT_INTERVAL} '
          f'(of 1000); workdir {workdir}', flush=True)
    print(f'{label}: CASCI targets cas={EXC_CAS} on the \'sto-6g\' SCF (the task\'s '
          '\'aug-cc-pVTZ\' maps onto an uncontracted even-tempered stand-in of over 128 AOs, '
          'which the JAX package itself gives up for its minimal basis); evaluation '
          f'{EXC_EVAL_STEPS} steps (of the task\'s) from the last checkpoint with '
          'OscillatorStrengthMonitor and SpinMonitor, its walkers kept', flush=True)
    per_step = {k: EXC_STATES * v for k, v in per_op_step.items()}
    loss = partial(create_loss_fn, clip_mask_fn=partial(median_clip_and_mask, clip_width=5,
                                                        median_center=True),
                   alpha=4.0, scale_overlap_by='max_gap_std', min_gap_scale_factor=1e-3,
                   clip_mask_overlap_fn=psi_ratio_clip_and_mask)
    sampler_factory = partial(initialize_sampling,
                              elec_sampler=RECIPES['decorr_metropolis_psiformer'])
    opt = partial(KFACOptimizer, learning_rate_schedule=InverseSchedule(0.05, 50000),
                  damping_schedule=ConstantSchedule(1e-3), norm_constraint=1e-3,
                  inverse_update_period=5)
    # one generator per state, forked from seed 0 as TrainSession._fork_gen forks
    gens = [torch.Generator().manual_seed(int(np.random.SeedSequence([0, k]).generate_state(1)[0]))
            for k in range(EXC_STATES)]
    torch.cuda.reset_peak_memory_stats()
    stack = init_wf_states(partial(dq.psiformer_ansatz, hamil), gens).cuda()
    start = [flat_params(wf) for wf in stack]
    state, pre, fit = _cut_run(
        smi, hamil, stack, opt, sampler_factory, loss, label=label, walkers=EXC_WALKERS,
        pretrain_steps=EXC_PRETRAIN_STEPS,
        pretrain_kwargs=dict(opt='lamb', opt_kwargs=dict(learning_rate=3e-4, b1=0.9, b2=0.999),
                             scf_kwargs=dict(basis='sto-6g', cas=EXC_CAS)),
        eq_steps=EXC_EQ_STEPS, fit_steps=EXC_FIT_STEPS, chkpt_interval=EXC_CHKPT_INTERVAL,
        workdir=workdir, counts=counts, zero_counts=zero_counts, per_step=per_step,
        electronic_states=EXC_STATES,
        observable_monitors=[SpinMonitor(save_samples=False, period=1)],
    )
    train_launches = counts()
    trained = [flat_params(wf) for wf in stack]
    if any(torch.equal(a, b) for a, b in zip(start, trained)) or torch.equal(*trained):
        raise SystemExit(f'{label}: a state\'s parameters did not change, or the two states\' '
                         'parameters are equal')
    last = fit[-1]['stats']
    overlap, spin = last['overlap/pairwise/mean'], last['spin/mean']
    print(f'{label} last fit step: overlap/pairwise/mean {np.asarray(overlap).tolist()}, '
          f'spin/mean {np.asarray(spin).tolist()}, energy/ewm '
          f'{np.asarray(last["energy/ewm"]).tolist()}', flush=True)
    # S_ii is each state's overlap with itself, the mean of unit weights: 1
    if not (np.isfinite(overlap).all() and (np.diagonal(overlap, 0, -2, -1) == 1).all()
            and np.isfinite(spin).all() and np.shape(spin) == (1, EXC_STATES)):
        raise SystemExit(f'{label}: the overlap or spin statistics are not finite, or the '
                         'overlap diagonal is not 1')
    path = os.path.join(workdir, 'training', f'chkpt-{EXC_FIT_STEPS}.pt')
    step, loaded = CheckpointStore.load(path, 'cuda')
    same_opt = all(
        torch.equal(a, b) for key in ('factors', 'inverses')
        for got, want in zip(loaded.opt[key], state.opt[key], strict=True)
        for p in want for a, b in zip(got[p], want[p], strict=True))
    if step != EXC_FIT_STEPS or len(loaded.opt['factors']) != EXC_STATES or not (
            same_opt and all(torch.equal(loaded.params[k], v)
                             for k, v in stack.state_dict().items())
            and torch.equal(loaded.sampler['elec']['r'], state.sampler['elec']['r'])):
        raise SystemExit(f'{label}: the last checkpoint does not hold both states\' '
                         'parameters, KFAC states and walkers bit for bit')
    print(f'{label}: chkpt-{EXC_FIT_STEPS}.pt reloads both states\' parameters, KFAC states '
          'and walkers bit for bit', flush=True)

    # E_loc of 64 of each state's last walkers with the trained weights
    r_last = state.sampler['elec']['r'][0, :, :EXC_CHECK_WALKERS]
    dtypes = {'card': torch.float32, 'plain_f64': torch.float64, 'plain_f32': torch.float32}
    plain = {name: _state_copy(partial(dq.psiformer_ansatz, hamil, seed=0), stack, dtypes[name],
                               'cpu')
             for name in ('plain_f64', 'plain_f32')}
    for s in range(EXC_STATES):
        rel, _, _ = eloc_rel_errors(hamil, stack[s], r_last[s], R,
                                    {k: v[s] for k, v in plain.items()})
        tol = ELOC_FACTOR * rel['plain_f32'] + ELOC_FLOOR
        print(f'{label} state {s}: E_loc on {EXC_CHECK_WALKERS} walkers against the plain path '
              f'in f64 (CPU): kernel path (f32, card) max rel err {rel["card"]:.3e}; plain path '
              f'(f32, CPU) {rel["plain_f32"]:.3e}; tol {tol:.3e}', flush=True)
        if not rel['card'] <= tol:
            raise SystemExit(f'{label} state {s}: the kernel-path local energy disagrees with '
                             'the plain path')

    # the penalised gradient of both states on 64 walkers each
    data = {'energy_ewm': np.asarray(last['energy/ewm']),
            'std_ewm': np.asarray(last['energy/std_ewm'])}
    grads, overlap_term = {}, {}
    for name, copy in {'card': stack, **plain}.items():
        dtype, device = dtypes[name], 'cuda' if name == 'card' else 'cpu'
        pc = dq.PhysicalConfiguration(R.to(device, dtype), r_last.to(device, dtype), torch.zeros(
            EXC_STATES, EXC_CHECK_WALKERS, dtype=torch.long, device=device))
        loss_r = loss(hamil, copy)
        (_, (_, ratio_r, _)), g = loss_r.value_and_grad(
            pc, torch.ones(EXC_STATES, EXC_CHECK_WALKERS, dtype=dtype, device=device),
            {k: torch.as_tensor(v, dtype=torch.float64, device=device) for k, v in data.items()})
        grads[name] = [torch.cat([t.flatten() for t in gs.values()]) for gs in g]
        # the one-sided overlaps S_01 and S_10 (unit weights) that the penalty's tangent reads
        overlap_term[name] = ratio_r.mean(-1)[[0, 1], [1, 0]].tolist()
    print(f'{label}: the one-sided overlaps (S_01, S_10) on the {EXC_CHECK_WALKERS} walkers a '
          'state: ' + ', '.join(f'{k} ({v[0]:.4e}, {v[1]:.4e})' for k, v in overlap_term.items()),
          flush=True)
    if 0.0 in overlap_term['plain_f64']:
        raise SystemExit(f'{label}: the overlap term of the gradient check is zero')
    for s in range(EXC_STATES):
        rel = {n: rel_l2(grads[n][s], grads['plain_f64'][s]) for n in ('card', 'plain_f32')}
        tol = ELOC_FACTOR * rel['plain_f32'] + ELOC_FLOOR
        ok = rel['card'] <= tol
        print(f'{label} state {s}: penalised gradient on {EXC_CHECK_WALKERS} walkers a state '
              f'against the plain path in f64 (CPU), global L2: card (f32, kernels) rel err '
              f'{rel["card"]:.3e}; plain path (f32, CPU) {rel["plain_f32"]:.3e}; tol {tol:.3e} '
              f'{"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            raise SystemExit(f'{label} state {s}: the penalised gradient on the card disagrees '
                             'with the plain path')
    del plain, grads

    # the fit step split by CUDA events: the calls the step makes, one by one
    _, sampler = sampler_factory(torch.Generator().manual_seed(0), hamil, stack, [hamil.mol],
                                 EXC_STATES, 1)
    loss_s = loss(hamil, stack)
    opt_s = opt(loss_s)
    opt_s.kfac.init(dq.PhysicalConfiguration(R, state.sampler['elec']['r'][0], torch.zeros(
        EXC_STATES, EXC_WALKERS, dtype=torch.long, device='cuda')))
    smpl_state, opt_state = state.sampler, state.opt
    split_gen = torch.Generator('cuda').manual_seed(7)
    weight = torch.ones(EXC_STATES, EXC_WALKERS, device='cuda')
    data_t = {k: torch.as_tensor(v, dtype=torch.float64, device='cuda') for k, v in data.items()}
    spin_monitor = SpinMonitor(save_samples=False, period=1).finalize(hamil, stack)
    stages = ('sampling', *(f'local energy {s}' for s in range(EXC_STATES)), 'ratio forwards',
              'gradient and taps', 'KFAC update', 'psi refresh', 'spin monitor')
    splits = []
    for _ in range(EXC_SPLIT_STEPS):
        refresh = opt_state['step'] % opt_s.kfac.inverse_update_period == 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        t0 = time.monotonic()
        ev[0].record()
        with torch.no_grad():
            smpl_state, pc, _ = sampler.sample(split_gen, smpl_state, torch.tensor([0]))
        ev[1].record()
        E = []
        for s, wf in enumerate(stack):
            E.append(compute_local_energy(hamil, wf, pc.state(s))[0])
            ev[2 + s].record()
        ratio = loss_s.overlap_penalty.ratios(list(stack), pc)
        ev[2 + EXC_STATES].record()
        terms = Terms(torch.zeros(()), torch.stack(E)[None], ratio, None, {})
        g, sums = loss_s.grad_and_taps(pc, weight, terms, taps=True, data=data_t)
        ev[3 + EXC_STATES].record()
        opt_state, _ = opt_s.kfac.update(opt_state, g, sums, EXC_WALKERS)
        ev[4 + EXC_STATES].record()
        with torch.no_grad():
            smpl_state = sampler.update(smpl_state)
        ev[5 + EXC_STATES].record()
        spin_monitor(0, None, pc, None, terms.local_energy, None)
        ev[6 + EXC_STATES].record()
        ev[-1].synchronize()
        host_ms = 1e3 * (time.monotonic() - t0)
        ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        splits.append((refresh, ms))
        print(f'{label} split step {opt_state["step"] - 1} (inverses '
              f'{"refreshed" if refresh else "carried"}): '
              + ', '.join(f'{n} {t:.2f} ms' for n, t in zip(stages, ms))
              + f'; sum {sum(ms):.2f} ms, host {host_ms:.2f} ms', flush=True)
        del g, sums
    carried = [ms for refresh, ms in splits if not refresh]
    medians = [_median(col) for col in zip(*carried)]
    print(f'{smi} | {label} fit step split by CUDA events (median of the {len(carried)} steps '
          'with carried inverses): ' + ', '.join(f'{n} {t:.2f} ms' for n, t in zip(stages, medians))
          + '; KFAC update on a refresh step '
          + ', '.join(f'{ms[3 + EXC_STATES]:.2f}' for refresh, ms in splits if refresh) + ' ms',
          flush=True)
    del loss_s, opt_s, sampler, spin_monitor

    # evaluation from the last checkpoint, the sampler state kept
    records, rows, Metrics, Results = _recording_sinks(counts, stack)
    before = {k: v.clone() for k, v in loaded.params.items()}  # the split steps moved stack
    zero_counts()
    train(hamil, stack, None, sampler_factory, steps=EXC_EVAL_STEPS, seed=0,
          electron_batch_size=EXC_WALKERS, electronic_states=EXC_STATES, workdir=workdir,
          train_state=TrainState(loaded.sampler, loaded.params, None),
          observable_monitors=[OscillatorStrengthMonitor(save_samples=False, period=1),
                               SpinMonitor(save_samples=False, period=1)],
          metric_logger_constructor=Metrics, h5_logger_constructor=Results, device='cuda',
          loss_function_factory=loss)
    torch.cuda.synchronize()
    ev_records = [r for r in records if r['prefix'] is None]
    prev = dict.fromkeys(train_launches, 0)
    for r in ev_records:
        launches = {k: r['counts'][k] - prev[k] for k in prev}
        prev = r['counts']
        st = r['stats']
        f = np.asarray(st['oscillator_strength/mean'])
        print(f'{label} evaluation step {r["step"]}: E_loc mean '
              f'{np.asarray(st["local_energy/mean"]).tolist()} spin/mean '
              f'{np.asarray(st["spin/mean"]).tolist()} oscillator_strength/mean '
              f'{f.tolist()} step time {st["perf/step_time"]:.3f} s; launches {launches}',
              flush=True)
        if launches != per_step or not all(np.isfinite(v).all() for v in st.values()):
            raise SystemExit(f'{label} evaluation step {r["step"]}: launches {launches}, or '
                             'stats not finite')
        if f.shape != (1, EXC_STATES, EXC_STATES) or (np.diagonal(f, 0, -2, -1) != 0).any():
            raise SystemExit(f'{label} evaluation step {r["step"]}: oscillator strengths of '
                             f'shape {f.shape} or with a non-zero diagonal')
    if len(ev_records) != EXC_EVAL_STEPS or len(rows) != EXC_EVAL_STEPS or records[0]['prefix']:
        raise SystemExit(f'{label}: the evaluation did not take its steps, or equilibrated')
    if not all(torch.equal(v, before[k]) for k, v in stack.state_dict().items()):
        raise SystemExit(f'{label}: the evaluation changed the parameters')
    ev_s = [r['stats']['perf/step_time'] for r in ev_records]
    print(f'{smi} | {label} evaluation step ({EXC_STATES} x {EXC_WALKERS} walkers, '
          f'OscillatorStrengthMonitor and SpinMonitor): median {1e3 * _median(ev_s):.1f} ms '
          f'(steps {", ".join(f"{1e3 * t:.1f}" for t in ev_s)} ms)', flush=True)
    print(f'{smi} | {label} peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
    del stack, state, loaded
    torch.cuda.empty_cache()
    shutil.rmtree(workdir)
    return {k: train_launches[k] + prev[k] for k in prev}


# cli path: the true entry point in a subprocess, train_psiformer.yaml on H2O at
# 2048 walkers, cut to 5 pretraining steps, 5 equilibration calls and 5 fit
# steps, then 3 evaluation steps from its checkpoint in a second workdir
CLI_WALKERS, CLI_PRETRAIN_STEPS, CLI_EQ_STEPS, CLI_STEPS, CLI_EVAL_STEPS = 2048, 5, 5, 5, 3
CLI_TIMEOUT_S = 200
# the two sinks whose packages (tensorboardX, h5py) the card's machine lacks
CLI_SINKS_OFF = ['task.metric_logger_constructor=null', 'task.h5_logger_constructor=null']
_STEP_LINE = r'^\[([^\]]+)\] DEBUG:deepqmc_tpu_torch\.train: (training|evaluation) step (\d+): (\{.*\})$'


def _log_steps(workdir, mode):
    """The step lines of ``mode`` in ``workdir/deepqmc.log`` as (time, step,
    record, launches of the step), the log's text and its peak memory line."""
    import json
    import re
    from datetime import datetime

    text = open(os.path.join(workdir, 'deepqmc.log')).read()
    steps, prev = [], None
    for stamp, m, step, rec in re.findall(_STEP_LINE, text, re.M):
        if m != mode:
            continue
        rec = json.loads(rec)
        prev = prev or dict.fromkeys(rec['launches'], 0)
        launches = {k: rec['launches'][k] - prev[k] for k in prev}
        prev = rec['launches']
        t = datetime.strptime(stamp, '%Y-%m-%d %H:%M:%S,%f').timestamp()
        steps.append((t, int(step), rec, launches))
    peak = re.findall(r'Peak device memory: ([0-9.]+) GiB', text)
    return steps, text, float(peak[-1]) if peak else float('nan')


def _check_steps(label, steps, n_steps, want):
    """Each of ``n_steps`` steps finite, launching ``want``; their medians."""
    if len(steps) != n_steps:
        raise SystemExit(f'{label}: {len(steps)} steps logged, want {n_steps}')
    for _, step, rec, launches in steps:
        print(f'{label} step {step}: E_loc mean {rec["E_mean"]:.6f} step time '
              f'{rec["step_time"]:.3f} s; launches {launches}', flush=True)
        if not math.isfinite(rec['E_mean']):
            raise SystemExit(f'{label} step {step}: the energy is not finite')
        if launches != want:
            raise SystemExit(f'{label} step {step} launched {launches}, want {want}')
    return [rec['step_time'] for _, _, rec, _ in steps]


def cli_path(smi, per_op_step):
    """Phase 12: ``python3 -m deepqmc_tpu_torch`` in a subprocess, training and
    then evaluating from its checkpoint; returns the launches of both runs,
    read from each run's log, and the training run's workdir (kept)."""
    root = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(root, 'runs', 'cli_path')
    shutil.rmtree(base, ignore_errors=True)
    train_dir, eval_dir = os.path.join(base, 'train'), os.path.join(base, 'evaluate')
    print(f'cli path: sinks turned off on the command line, as the card\'s machine has no '
          f'tensorboardX or h5py: {" ".join(CLI_SINKS_OFF)}', flush=True)
    runs = (
        ('training', train_dir, CLI_STEPS,
         ['task=train_psiformer', 'ansatz=psiformer', 'hamil/mol=H2O',
          f'task.electron_batch_size={CLI_WALKERS}', f'task.steps={CLI_STEPS}',
          f'task.pretrain_steps={CLI_PRETRAIN_STEPS}', f'+task.max_eq_steps={CLI_EQ_STEPS}',
          *CLI_SINKS_OFF],
         ['deepqmc.log', '.hydra/config.json', 'training/chkpt-0.pt',
          f'training/chkpt-{CLI_STEPS}.pt']),
        ('evaluation', eval_dir, CLI_EVAL_STEPS,
         ['task=evaluate', f'task.restdir={os.path.join(train_dir, "training")}',
          f'+task.steps={CLI_EVAL_STEPS}'],
         ['deepqmc.log', '.hydra/config.json', 'evaluation']),
    )
    total = dict.fromkeys(per_op_step, 0)
    for mode, workdir, n_steps, overrides, files in runs:
        cmd = [sys.executable, '-m', 'deepqmc_tpu_torch', *overrides, f'--workdir={workdir}']
        print(f'cli path: python3 {" ".join(cmd[1:])}', flush=True)
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT_S)
        wall_s = time.time() - t0
        if proc.returncode:
            print(proc.stderr[-6000:], file=sys.stderr, flush=True)
            raise SystemExit(f'cli path: the {mode} run exited with {proc.returncode}')
        missing = [f for f in files if not os.path.exists(os.path.join(workdir, f))]
        if missing:
            raise SystemExit(f'cli path: the {mode} run did not write {missing}')
        steps, text, peak_gib = _log_steps(workdir, mode)
        step_s = _check_steps(f'cli path {mode}', steps, n_steps, per_op_step)
        for line in text.splitlines():
            if 'SCF solution in' in line or 'Pretraining completed' in line:
                print(f'cli path {mode}: {line}', flush=True)
        print(f'{smi} | cli path {mode} run ({CLI_WALKERS} walkers): subprocess wall time '
              f'{wall_s:.1f} s, first step logged {steps[0][0] - t0:.1f} s after the start, '
              f'median step {1e3 * _median(step_s):.1f} ms (steps '
              f'{", ".join(f"{1e3 * t:.1f}" for t in step_s)} ms), peak device memory '
              f'{peak_gib:.3f} GiB', flush=True)
        for k in total:
            total[k] += steps[-1][2]['launches'][k]
    shutil.rmtree(eval_dir)  # the training run stays for the force path
    return total, train_dir


# ecp path: ScO with ccECPs on both nuclei (17 valence electrons, 9 up and 8
# down) and the full-width PsiFormer, composed from the conf tree; the E_loc
# gate on 64 walkers, a cut train_psiformer.yaml run at 512 walkers (no
# pretraining: the ScO SCF does not fit the run; 10 equilibration calls, 3
# fit steps), the local energy's parts at 512 walkers
ECP_OVERRIDES = ['hamil/mol=ScO', '+hamil.ecp_type=ccECP', 'ansatz=psiformer']
ECP_CHECK_WALKERS, ECP_RUN_WALKERS, ECP_EQ_STEPS, ECP_FIT_STEPS = 64, 512, 10, 3


def ecp_path(dq, smi, counts, zero_counts, per_op_step):
    """Phase 14; returns the kernel launches of its cut run."""
    import torch

    from deepqmc_tpu_torch import app, config
    from deepqmc_tpu_torch.ecp.ecp_utils import random_azimuths
    from deepqmc_tpu_torch.fit import molecule_state
    from deepqmc_tpu_torch.ecp.gaussian_type_ecp import NL_CHUNK
    from deepqmc_tpu_torch.ops.fl_attention import mha_core_fl, mha_core_fl_plain
    from deepqmc_tpu_torch.ops.fl_slogdet import slogdet_traces, slogdet_traces_plain
    from deepqmc_tpu_torch.utils import cuda_median_ms

    cfg = config.compose(overrides=ECP_OVERRIDES)
    hamil = config.instantiate(cfg['hamil'], root=cfg)
    nu, nd = hamil.n_up, hamil.n_down
    n, K = nu + nd, 3 * (nu + nd)
    n_nl = len(hamil.ecp.nuc_with_nl_pot)
    print(f'ecp path: {" ".join(ECP_OVERRIDES)}: valence {hamil.ns_valence.tolist()}, '
          f'{nu} up and {nd} down, K = {K}, {n_nl} nuclei with a nonlocal part; nonlocal '
          f'chunk {NL_CHUNK} configurations ({NL_CHUNK // (12 * n)} walkers)', flush=True)
    if (nu, nd) != (9, 8) or hamil.ns_valence.tolist() != [11.0, 6.0] or n_nl != 2:
        raise SystemExit('ecp path: ScO with ccECPs is not 11 + 6 valence electrons split 9/8')

    # kernels 1 and 2 at this shape, against their plain versions
    gen = torch.Generator('cuda').manual_seed(1)
    for B in (ECP_CHECK_WALKERS, ECP_RUN_WALKERS):
        for name, kernel, plain, args, bound in (
            ('fl_attention', mha_core_fl, mha_core_fl_plain, attention_inputs(gen, B, K=K, n=n),
             attention_bound_ms(B, K=K, n=n)),
            ('fl_slogdet_traces', slogdet_traces, slogdet_traces_plain,
             slogdet_inputs(gen, B, K=K, D=16, nu=nu, nd=nd),
             slogdet_bound_ms(B, K, 16, n)),
        ):
            got = kernel(*args)
            torch.cuda.synchronize()
            errs = [max_errors(o, r) for o, r in zip(got, plain(*args))]
            body = f' ({body_of(kernel)})' if name == 'fl_slogdet_traces' else ''
            ms = cuda_median_ms(lambda: kernel(*args), runs=5, warmup=1)
            plain_ms = cuda_median_ms(lambda: plain(*args), runs=5, warmup=1)
            print(f'{smi} | ecp path {name}{body} B={B} n={n} K={K}: max abs err '
                  f'{max(e for e, _ in errs):.3e}, rel {max(r for _, r in errs):.3e} (tol '
                  f'{KERNEL_RTOL:.0e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
                  f'{bound[0]:.4f} ms', flush=True)
            if not all(r <= KERNEL_RTOL and math.isfinite(e) for e, r in errs):
                raise SystemExit(f'ecp path: {name} disagrees with its plain version at n = {n}')
            del args, got
    torch.cuda.empty_cache()

    # the gates: E_loc and V_nl (on the same rotations) of 64 walkers, the card
    # in float32 with kernels against the plain path in float64 on the CPU,
    # each by the local energy's rule, on init_sample walkers and on walkers
    # equilibrated on the card
    wf = config.instantiate(cfg['ansatz'], root=cfg)(hamil)  # seed 0, float32, CPU
    weights = {k: v.clone() for k, v in wf.state_dict().items()}
    phi64 = random_azimuths(torch.Generator().manual_seed(2), (n_nl, ECP_CHECK_WALKERS, n),
                            torch.float64)

    def gate(walkers, r64):
        results = {}
        for label, dtype, device in (('card', torch.float32, 'cuda'),
                                     ('plain_f64', torch.float64, 'cpu'),
                                     ('plain_f32', torch.float32, 'cpu')):
            w = config.instantiate(cfg['ansatz'], root=cfg)(hamil).to(device=device, dtype=dtype)
            w.load_state_dict({k: v.to(dtype) for k, v in weights.items()})
            pc = dq.PhysicalConfiguration(
                torch.as_tensor(hamil.mol.coords, dtype=dtype, device=device),
                r64.to(device=device, dtype=dtype),
                torch.zeros(ECP_CHECK_WALKERS, dtype=torch.long, device=device))
            zero_counts()
            with torch.inference_mode():
                e, stats = hamil.local_energy(w, pc, phi=phi64.to(device=device, dtype=dtype))
            if label == 'card':
                torch.cuda.synchronize()
                if counts() != per_op_step:
                    raise SystemExit(f'ecp path: one local energy launched {counts()}, want '
                                     f'{per_op_step}')
                card = w, pc
            results[label] = (e.double().cpu(), stats['hamil/V_nl'].double().cpu())
        ref, v_ref = results['plain_f64']
        scale = ref.abs().clamp(min=1.0)
        rel = {k: ((results[k][0] - ref).abs() / scale).max().item()
               for k in ('card', 'plain_f32')}
        tol = ELOC_FACTOR * rel['plain_f32'] + ELOC_FLOOR
        v_err = (results['card'][1] - v_ref).abs().max().item()
        print(f'{smi} | ecp path E_loc of {ECP_CHECK_WALKERS} {walkers} walkers (V_nl on the '
              f'same rotations) against the plain path in f64 (CPU): card (f32, kernels) rel err '
              f'{rel["card"]:.3e}; plain path (f32, CPU) rel err {rel["plain_f32"]:.3e}; tol '
              f'{tol:.3e} {"ok" if rel["card"] <= tol else "FAIL"}; E_loc mean '
              f'{ref.mean().item():.6f}; V_nl mean {v_ref.mean().item():.6f} (card '
              f'{results["card"][1].mean().item():.6f}), max abs err of V_nl on the card '
              f'{v_err:.3e}', flush=True)
        if not (rel['card'] <= tol and torch.isfinite(results['card'][0]).all()):
            raise SystemExit('ecp path: the local energy on the card disagrees with the plain '
                             'path')
        v_rel = {k: rel_max(results[k][1], v_ref) for k in ('card', 'plain_f32')}
        v_tol = ELOC_FACTOR * v_rel['plain_f32'] + ELOC_FLOOR
        v_ok = v_rel['card'] <= v_tol and bool(torch.isfinite(results['card'][1]).all())
        print(f'{smi} | ecp path V_nl of the {ECP_CHECK_WALKERS} {walkers} walkers against the '
              f'plain path in f64 (CPU), relative to max(1, |V_nl|): card (f32, kernels) rel err '
              f'{v_rel["card"]:.3e}; plain path (f32, CPU) rel err {v_rel["plain_f32"]:.3e}; '
              f'tol {v_tol:.3e} {"ok" if v_ok else "FAIL"}', flush=True)
        if not v_ok:
            raise SystemExit('ecp path: V_nl on the card disagrees with the plain path')
        return card

    wf_card, pc_card = gate('init_sample', hamil.init_sample(
        torch.Generator().manual_seed(0), ECP_CHECK_WALKERS).r)
    wf_eq = config.instantiate(cfg['ansatz'], root=cfg)(hamil)
    wf_eq.load_state_dict(weights)
    *_, (_, eq_state, _, _) = dq.evaluate(hamil, wf_eq, n_walkers=ECP_CHECK_WALKERS, steps=0,
                                          device='cuda', max_eq_steps=ECP_EQ_STEPS,
                                          eq_allow_early_stopping=False)
    del wf_card, pc_card, wf_eq
    wf_card, pc_card = gate(f'equilibrated ({ECP_EQ_STEPS} calls of 10 Metropolis moves)',
                            molecule_state(eq_state)[1]['r'].double().cpu())

    # the local energy's parts at 512 walkers
    for B in (ECP_RUN_WALKERS,):
        pc = dq.PhysicalConfiguration(
            pc_card.R, hamil.init_sample(torch.Generator('cuda').manual_seed(3), B,
                                         dtype=torch.float32).r,
            torch.zeros(B, dtype=torch.long, device='cuda'))
        phi = random_azimuths(torch.Generator('cuda').manual_seed(4), (n_nl, B, n),
                              torch.float32)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            nl_ms = cuda_median_ms(lambda: hamil.ecp.nonloc_potential(pc, wf_card, phi=phi),
                                   runs=3, warmup=1)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            kin_ms = cuda_median_ms(lambda: hamil.laplacian(lambda r: wf_card(
                pc.replace(r=r)).log)(pc.r), runs=3, warmup=1)
            all_ms = cuda_median_ms(lambda: hamil.local_energy(wf_card, pc, phi=phi), runs=3,
                                    warmup=1)
        print(f'{smi} | ecp path local energy of {B} walkers: {all_ms:.1f} ms, of which the '
              f'kinetic FL pass {kin_ms:.1f} ms and V_nl {nl_ms:.1f} ms ({nl_ms / all_ms:.2f} of '
              f'it); peak device memory {peak_gib:.3f} GiB', flush=True)
    del wf_card, pc_card, pc
    torch.cuda.empty_cache()

    # the cut run, through the command line in this process
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs', 'ecp_path')
    shutil.rmtree(workdir, ignore_errors=True)
    argv = [*ECP_OVERRIDES, 'task=train_psiformer',
            f'task.electron_batch_size={ECP_RUN_WALKERS}', f'task.steps={ECP_FIT_STEPS}',
            'task.pretrain_steps=null', f'+task.max_eq_steps={ECP_EQ_STEPS}', *CLI_SINKS_OFF,
            f'--workdir={workdir}']
    print(f'ecp path: cli {" ".join(argv)}', flush=True)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    app.cli(argv)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = counts()
    steps, _, peak_gib = _log_steps(workdir, 'training')
    step_s = _check_steps('ecp path fit', steps, ECP_FIT_STEPS, per_op_step)
    print(f'{smi} | ecp path cut run ({ECP_RUN_WALKERS} walkers, {ECP_EQ_STEPS} equilibration '
          f'calls, {ECP_FIT_STEPS} fit steps): {run_s:.1f} s, median fit step '
          f'{1e3 * _median(step_s):.1f} ms (steps {", ".join(f"{1e3 * t:.1f}" for t in step_s)}'
          f' ms), peak device memory {peak_gib:.3f} GiB; launches {launches}', flush=True)
    shutil.rmtree(workdir)
    return launches


# force path: the five Hellmann-Feynman estimators (evaluate_forces.yaml's four
# monitors and the bare one) over 2 evaluation steps from the cli path's
# training checkpoint (H2O at full width, its 2048 walkers); the estimators on
# 16 of its walkers against float64, the tangent pass in float64 on the card
# against the CPU; then task=evaluate_forces through the command line
FORCE_KINDS = ('bare', 'ac_zv', 'ac_zvq', 'ac_zvzb', 'ac_zvzbq')
FORCE_EVAL_STEPS, FORCE_CLI_STEPS, FORCE_CHECK_WALKERS = 2, 2, 16
# The tangent pass in float64 on the card and on the CPU: the same plain
# arithmetic in other orders, so they agree to float64 rounding, amplified
# where a Slater matrix is near singular: max |card - CPU| / max(1, max |CPU|)
# per output.
FORCE_F64_RTOL = 1e-8


def rel_max(got, ref):
    """max |got - ref| / max(1, |ref|) over the entries, in float64 on the CPU."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()


def _forces(hamil, wf, pc):
    """E_loc and the five estimators of the walkers ``pc`` under ``wf``."""
    import torch

    from deepqmc_tpu_torch import force

    with torch.inference_mode():
        e_loc, _ = hamil.local_energy(wf, pc)
    e_loc = e_loc.clone()
    energy = e_loc.mean().expand_as(e_loc)
    out = {'E_loc': e_loc}
    for kind in FORCE_KINDS:
        build = getattr(force, f'evaluate_hf_force_{kind}')
        fn = build(hamil) if kind == 'bare' else build(hamil, wf)
        out[kind] = fn(pc, e_loc, energy) if 'zb' in kind else fn(pc)
    return out


def force_path(dq, hamil, smi, counts, zero_counts, per_op_step, train_dir):
    """Phase 13: the force monitors in an evaluation from the cli path's
    checkpoint in ``train_dir``, the estimators and the tangent pass against
    float64, ``task=evaluate_forces`` in a subprocess; returns the kernel
    launches of the evaluation and of the subprocess."""
    from functools import partial

    import numpy as np
    import torch
    from torch.autograd import forward_ad

    from deepqmc_tpu_torch import force, observable
    from deepqmc_tpu_torch.fit import TrainState, molecule_state
    from deepqmc_tpu_torch.log import CheckpointStore
    from deepqmc_tpu_torch.ops.fl_attention import mha_core_fl
    from deepqmc_tpu_torch.ops.fl_block import psiformer_block_fl
    from deepqmc_tpu_torch.ops.fl_slogdet import slogdet_traces
    from deepqmc_tpu_torch.sampling import RECIPES, initialize_sampling
    from deepqmc_tpu_torch.train import train
    from deepqmc_tpu_torch.utils import chunk_size

    # the kernels' wrappers refuse an operand that carries a forward-mode tangent
    gen = torch.Generator('cuda').manual_seed(5)
    for name, kernel, args in (('fl_attention', mha_core_fl, attention_inputs(gen, 4)),
                               ('fl_slogdet_traces', slogdet_traces, slogdet_inputs(gen, 4)),
                               ('fl_block', psiformer_block_fl, block_inputs(gen, 4))):
        before = kernel.launches
        with forward_ad.dual_level():
            dual = forward_ad.make_dual(args[0], torch.ones_like(args[0]))
            try:
                kernel(dual, *args[1:])
            except RuntimeError as e:
                print(f'force path: {name} given a dual operand on the card raises: {e}',
                      flush=True)
            else:
                raise SystemExit(f'force path: {name} took an operand that carries a tangent')
        if kernel.launches != before:
            raise SystemExit(f'force path: {name} launched on a dual operand')

    chkpt = os.path.join(train_dir, 'training', f'chkpt-{CLI_STEPS}.pt')
    _, loaded = CheckpointStore.load(chkpt, 'cuda')
    wf = dq.psiformer_ansatz(hamil, seed=0).cuda()
    wf.load_state_dict(loaded.params)
    n_walkers = loaded.sampler['elec']['r'].shape[2]
    print(f'force path: evaluate_forces.yaml\'s monitors ({", ".join(FORCE_KINDS[1:])}) and '
          f'the bare one over {FORCE_EVAL_STEPS} evaluation steps from {chkpt} (H2O, full '
          f'width, {n_walkers} walkers), direction chunk '
          f'{chunk_size(9, None, "DEEPQMC_TPU_FORCE_DIRECTION_CHUNK", default=6)} of 9 '
          'coordinates', flush=True)
    monitors = [observable.ForceMonitor(kind, save_samples=True, period=1)
                for kind in FORCE_KINDS]
    records, rows, Metrics, Results = _recording_sinks(counts, wf)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.monotonic()
    train(hamil, wf, None, partial(initialize_sampling,
                                   elec_sampler=RECIPES['decorr_metropolis_psiformer']),
          steps=FORCE_EVAL_STEPS, seed=0, electron_batch_size=n_walkers,
          workdir=os.path.join(train_dir, 'forces'),
          train_state=TrainState(loaded.sampler, loaded.params, None),
          metric_logger_constructor=Metrics, h5_logger_constructor=Results,
          observable_monitors=monitors, device='cuda')
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    eval_launches = counts()
    ev = [r for r in records if r['prefix'] is None]
    prev = dict.fromkeys(eval_launches, 0)
    for r, row in zip(ev, rows):
        launches = {k: r['counts'][k] - prev[k] for k in prev}
        prev = r['counts']
        means = {kind: np.asarray(r['stats'][f'hf_force_{kind}/mean']) for kind in FORCE_KINDS}
        print(f'force path evaluation step {r["step"]}: E_loc mean '
              f'{float(np.mean(r["stats"]["local_energy/mean"])):.6f}; launches {launches}; '
              'the mean force on O: ' + '; '.join(
                  f'{kind} {np.array2string(m.reshape(-1, 3)[0], precision=4)}'
                  for kind, m in means.items()), flush=True)
        if launches != per_op_step:
            raise SystemExit(f'force path step {r["step"]} launched {launches}, want '
                             f'{per_op_step}')
        for kind in FORCE_KINDS:
            samples = row[f'hf_force_{kind}/samples']
            if samples.shape != (1, 1, n_walkers, 3, 3) or not np.isfinite(samples).all():
                raise SystemExit(f'force path step {r["step"]}: {kind} samples of shape '
                                 f'{samples.shape} or not finite')
    if len(ev) != FORCE_EVAL_STEPS or len(rows) != FORCE_EVAL_STEPS:
        raise SystemExit('force path: the evaluation did not take its steps')
    if not (eval_launches['fl_attention'] and eval_launches['fl_slogdet_traces']):
        raise SystemExit('force path: the evaluation launched no attention or slogdet kernel')
    print(f'{smi} | force path: {FORCE_EVAL_STEPS} evaluation steps with the five force '
          f'monitors ({n_walkers} walkers) in {run_s:.1f} s; peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {eval_launches}',
          flush=True)

    # each estimator on the run's walkers, timed alone
    R, elec = molecule_state(loaded.sampler)
    pc = dq.PhysicalConfiguration(R, elec['r'], torch.zeros(n_walkers, dtype=torch.long,
                                                             device='cuda'))
    with torch.inference_mode():
        e_loc, _ = hamil.local_energy(wf, pc)
    e_loc = e_loc.clone()
    energy = e_loc.mean().expand_as(e_loc)
    zero_counts()
    for kind in FORCE_KINDS:
        build = getattr(force, f'evaluate_hf_force_{kind}')
        fn = build(hamil) if kind == 'bare' else build(hamil, wf)
        call = (lambda: fn(pc, e_loc, energy)) if 'zb' in kind else (lambda: fn(pc))
        call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        out = call()
        torch.cuda.synchronize()
        ms = 1e3 * (time.monotonic() - t0)
        print(f'{smi} | force path {kind} of {n_walkers} walkers: {ms:.1f} ms a step, peak '
              f'device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB', flush=True)
        if not torch.isfinite(out).all():
            raise SystemExit(f'force path: {kind} is not finite')
        del out
    if any(counts().values()):
        raise SystemExit(f'force path: the estimators launched {counts()}: the tangent pass '
                         'must run the plain cores')
    torch.cuda.empty_cache()

    # the gate: the five estimators on 16 walkers, the card (float32, E_loc by
    # the kernels) against the plain path in float64 on the CPU, by the local
    # energy's rule; the tangent pass in float64 on the card against the CPU
    r16 = elec['r'][:FORCE_CHECK_WALKERS].double().cpu()
    weights = {k: v.cpu() for k, v in wf.state_dict().items()}
    results, tangents = {}, {}
    for label, dtype, device in (('card', torch.float32, 'cuda'),
                                 ('plain_f64', torch.float64, 'cpu'),
                                 ('plain_f32', torch.float32, 'cpu'),
                                 ('card_f64', torch.float64, 'cuda')):
        w = dq.psiformer_ansatz(hamil, seed=0).to(device=device, dtype=dtype)
        w.load_state_dict({k: v.to(dtype) for k, v in weights.items()})
        pc16 = dq.PhysicalConfiguration(
            R.to(device=device, dtype=dtype), r16.to(device=device, dtype=dtype),
            torch.zeros(FORCE_CHECK_WALKERS, dtype=torch.long, device=device))
        if label != 'card_f64':
            results[label] = _forces(hamil, w, pc16)
        if dtype == torch.float64:
            J, (t, jac_t, lap_t) = force.log_psi_tangents(w, pc16)
            tangents[device] = {'J': J, 't': t, 'grad_r t': jac_t, 'lap_r t': lap_t}
    for kind in ('E_loc', *FORCE_KINDS):
        rel = {k: rel_max(results[k][kind], results['plain_f64'][kind])
               for k in ('card', 'plain_f32')}
        tol = ELOC_FACTOR * rel['plain_f32'] + ELOC_FLOOR
        ok = rel['card'] <= tol and bool(torch.isfinite(results['card'][kind]).all())
        print(f'force path {kind} of {FORCE_CHECK_WALKERS} walkers against the plain path in '
              f'f64 (CPU): card (f32) rel err {rel["card"]:.3e}; plain path (f32, CPU) rel err '
              f'{rel["plain_f32"]:.3e}; tol {tol:.3e} {"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            raise SystemExit(f'force path: {kind} on the card disagrees with the plain path')
    for key, ref in tangents['cpu'].items():
        err = (tangents['cuda'][key].cpu() - ref).abs().max().item()
        rel = err / max(1.0, ref.abs().max().item())
        print(f'force path tangent pass {key} in f64, card against CPU: max abs err {err:.3e}, '
              f'rel {rel:.3e} (tol {FORCE_F64_RTOL:.0e})', flush=True)
        if not rel <= FORCE_F64_RTOL:
            raise SystemExit(f'force path: the tangent pass ({key}) on the card disagrees '
                             'with the CPU')
    del wf, loaded, pc, results, tangents
    torch.cuda.empty_cache()

    # task=evaluate_forces through the command line, its HDF5 sink off
    root = os.path.dirname(os.path.abspath(__file__))
    workdir = os.path.join(os.path.dirname(train_dir), 'evaluate_forces')
    cmd = [sys.executable, '-m', 'deepqmc_tpu_torch', 'task=evaluate_forces',
           f'task.restdir={os.path.join(train_dir, "training")}',
           f'+task.steps={FORCE_CLI_STEPS}', 'task.h5_logger=null', f'--workdir={workdir}']
    print(f'force path: python3 {" ".join(cmd[1:])}', flush=True)
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    wall_s = time.time() - t0
    if proc.returncode:
        print(proc.stderr[-6000:], file=sys.stderr, flush=True)
        raise SystemExit(f'force path: task=evaluate_forces exited with {proc.returncode}')
    steps, _, peak_gib = _log_steps(workdir, 'evaluation')
    step_s = _check_steps('force path cli', steps, FORCE_CLI_STEPS, per_op_step)
    print(f'{smi} | force path task=evaluate_forces ({n_walkers} walkers, four force monitors):'
          f' subprocess wall time {wall_s:.1f} s, steps (without the monitors) '
          f'{", ".join(f"{1e3 * t:.1f}" for t in step_s)} ms, peak device memory '
          f'{peak_gib:.3f} GiB', flush=True)
    return {k: eval_launches[k] + steps[-1][2]['launches'][k] for k in eval_launches}


# benzene path: 42 electrons (21 up, 21 down), K = 126, the full-width
# PsiFormer with seed-0 weights; 3 evaluation steps at 512 walkers with the
# local energy in chunks of 128, E_loc of 16 walkers against float64, one KFAC
# step with both walker chunks
BENZENE_WALKERS, BENZENE_CHUNK, BENZENE_STEPS, BENZENE_CHECK_WALKERS = 512, 128, 3, 16


def benzene_path(dq, smi, counts, zero_counts):
    """Phase 15; returns the kernel launches of its evaluation and training step."""
    import torch

    from deepqmc_tpu_torch.fit import molecule_state
    from deepqmc_tpu_torch.loss.energy import compute_local_energy
    from deepqmc_tpu_torch.ops.fl_slogdet import TILED, slogdet_traces
    from deepqmc_tpu_torch.utils import cuda_median_ms

    hamil = dq.MolecularHamiltonian(mol=dq.Molecule.from_name('benzene'))
    n = hamil.n_up + hamil.n_down
    chunks = BENZENE_WALKERS // BENZENE_CHUNK
    per_eloc = {'fl_attention': 4 * chunks, 'fl_slogdet_traces': chunks, 'fl_slogdet_square': 0,
                'fl_slogdet_square_split': 0, 'fl_block': 0}
    jac_gb = 4 * BENZENE_CHUNK * 3 * n * n * 256 / 1e9
    print(f'benzene path: {n} electrons ({hamil.n_up} up, {hamil.n_down} down), K = {3 * n}; '
          f'{BENZENE_WALKERS} walkers, local energy in chunks of {BENZENE_CHUNK} (a [{BENZENE_CHUNK}'
          f', {3 * n}, {n}, 256] float32 Jacobian is {jac_gb:.2f} GB)', flush=True)
    if n != 42:
        raise SystemExit('benzene path: benzene does not have 42 electrons')
    wf = dq.psiformer_ansatz(hamil, seed=0).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.monotonic()
    steps = list(dq.evaluate(hamil, wf, n_walkers=BENZENE_WALKERS, steps=BENZENE_STEPS,
                             device='cuda', eloc_walker_chunk=BENZENE_CHUNK))
    torch.cuda.synchronize()
    eval_s = time.monotonic() - t0
    eval_launches = counts()
    want = {k: BENZENE_STEPS * v for k, v in per_eloc.items()}
    for step, _, e_loc, _ in steps:
        print(f'benzene path evaluation step {step}: E_loc mean {e_loc.mean().item():.6f} std '
              f'{e_loc.std().item():.6f}', flush=True)
        if not torch.isfinite(e_loc).all():
            raise SystemExit(f'benzene path step {step}: E_loc not finite')
    body = slogdet_traces.last_plan.body
    print(f'benzene path: {eval_launches} launches in {BENZENE_STEPS} steps ({want} wanted: '
          f'each chunk 4 attention launches at n = {n} and one flat slogdet launch); the flat '
          f'slogdet kernel took the {body_of(slogdet_traces)}', flush=True)
    if eval_launches != want or body != TILED:
        raise SystemExit('benzene path: the local energy did not take kernel 1 and the tiled '
                         'body of kernel 2 at n = 42')
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _, state, _, _ = steps[-1]
    R, elec = molecule_state(state)
    pc = dq.PhysicalConfiguration(R, elec['r'], torch.zeros(BENZENE_WALKERS, dtype=torch.long,
                                                             device='cuda'))
    with torch.inference_mode():
        eloc_ms = cuda_median_ms(lambda: compute_local_energy(
            hamil, wf, pc, walker_chunk=BENZENE_CHUNK), runs=3, warmup=1)
    print(f'{smi} | benzene path ({BENZENE_WALKERS} walkers, chunks of {BENZENE_CHUNK}): '
          f'{BENZENE_STEPS} evaluation steps in {eval_s:.1f} s ({1e3 * eval_s / BENZENE_STEPS:.1f}'
          f' ms a step, the first included), local energy {eloc_ms:.1f} ms, peak device memory '
          f'{peak_gib:.3f} GiB', flush=True)

    # the gate: E_loc of 16 of the walkers against the float64 plain path
    weights = {k: v.cpu() for k, v in wf.state_dict().items()}
    plain = {}
    for label, dtype in (('plain_f64', torch.float64), ('plain_f32', torch.float32)):
        plain[label] = dq.psiformer_ansatz(hamil, seed=0).to(dtype)
        plain[label].load_state_dict({k: v.to(dtype) for k, v in weights.items()})
    zero_counts()
    rel, e_card, _ = eloc_rel_errors(hamil, wf, elec['r'][:BENZENE_CHECK_WALKERS], R,
                                     plain)
    tol = ELOC_FACTOR * rel['plain_f32'] + ELOC_FLOOR
    print(f'benzene path E_loc of {BENZENE_CHECK_WALKERS} walkers against the plain path in f64 '
          f'(CPU): card (f32, kernels) rel err {rel["card"]:.3e}; plain path (f32, CPU) rel err '
          f'{rel["plain_f32"]:.3e}; tol {tol:.3e}; launches {counts()}', flush=True)
    if not (rel['card'] <= tol and torch.isfinite(e_card).all()):
        raise SystemExit('benzene path: the local energy on the card disagrees with the plain path')
    del plain

    # one KFAC step with both walker chunks, through the JAX package's variables
    before = flat_params(wf)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.monotonic()
    with mock.patch.dict(os.environ, {'DEEPQMC_TPU_ELOC_WALKER_CHUNK': str(BENZENE_CHUNK),
                                      'DEEPQMC_TPU_GRAD_WALKER_CHUNK': str(BENZENE_CHUNK)}):
        (_, train_state, e_loc, stats), = dq.fit.train(hamil, wf, n_walkers=BENZENE_WALKERS,
                                                       steps=1, device='cuda')
    torch.cuda.synchronize()
    train_s = time.monotonic() - t0
    train_launches = counts()
    changed = not torch.equal(flat_params(wf), before)
    finite = bool(torch.isfinite(flat_params(wf)).all() and torch.isfinite(e_loc).all())
    print(f'{smi} | benzene path KFAC step ({BENZENE_WALKERS} walkers, local energy and gradient '
          f'in chunks of {BENZENE_CHUNK}): {1e3 * train_s:.1f} ms (the sampler\'s start '
          f'included), E_loc mean {e_loc.mean().item():.6f}, parameters changed {changed}, '
          f'finite {finite}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}'
          f' GiB; launches {train_launches}', flush=True)
    if not (changed and finite) or train_launches != per_eloc:
        raise SystemExit('benzene path: the training step did not change the parameters, was '
                         'not finite, or did not launch one chunked local energy')
    del wf, steps, state, pc, train_state
    torch.cuda.empty_cache()
    return {k: eval_launches[k] + train_launches[k] for k in eval_launches}


# deeperwin path: the DeepErwin preset at full width on H2O (32 full
# determinants, embedding 256, 4 interactions, two-particle width 32; seed-0
# weights), 3 evaluation steps at 2048 walkers; one evaluation step of the
# transferable components at the widths of tests/test_transferable.py; the
# default task (train.yaml: 1000 walkers, decorr_langevin, KFAC, SCF
# pretraining) through the command line with ansatz=deeperwin, cut to 5
# pretraining steps, 5 equilibration calls and 6 fit steps
DW_WALKERS, DW_EVAL_STEPS = 2048, 3
DW_CLI_PRETRAIN_STEPS, DW_CLI_EQ_STEPS, DW_CLI_STEPS = 5, 5, 6
DW_CLI_TIMEOUT_S = 120


def transferable_ansatz(hamil, seed=0):
    """``tests/test_transferable.py``'s ansatz on the port's classes: atom-type
    nuclear embeddings (16) through an MLP, two combined attention layers over
    nuclei and electrons (2 heads of 8), a ``NuclearGNNHead`` of zetas and
    pis feeding ``SimplifiedNucleusDependentEnvelopes`` (4 per nucleus,
    per-orbital exponents), 2 full determinants, and the nuclear cusp."""
    from functools import partial

    from deepqmc_tpu_torch import fwdlap, nn
    from deepqmc_tpu_torch.gnn import ElectronGNN, ElectronGNNLayer
    from deepqmc_tpu_torch.gnn.electron_gnn import ElectronEmbedding, NucleiEmbedding
    from deepqmc_tpu_torch.gnn.update_features import CombinedNodeAttentionUpdateFeature
    from deepqmc_tpu_torch.presets import _dist_diff_features, _mlp, build_ansatz
    from deepqmc_tpu_torch.wf.cusp import NuclearCuspAsymptotic, PsiformerCusp
    from deepqmc_tpu_torch.wf.env import SimplifiedNucleusDependentEnvelopes
    from deepqmc_tpu_torch.wf.nn_wave_function import BackflowOp
    from deepqmc_tpu_torch.wf.omni import Backflow, NuclearGNNHead, OmniNet

    n_env, n_det, n_orb = 4, 2, hamil.n_up + hamil.n_down
    gnn = partial(
        ElectronGNN, n_interactions=2,
        nuclei_embedding=partial(NucleiEmbedding, embedding_dim=16, atom_type_embedding=True,
                                 subnet_type='mlp', edge_features=None),
        electron_embedding=partial(ElectronEmbedding,
                                   positional_embeddings={'ne': _dist_diff_features()},
                                   use_spin=True, project_to_embedding_dim=True),
        two_particle_stream_dim=8, self_interaction=True, edge_features=None,
        layer_factory=partial(
            ElectronGNNLayer, subnet_factory=nn.Identity, electron_residual=False,
            nucleus_residual=False, two_particle_residual=False, deep_features=False,
            update_rule='concatenate',
            update_features=[partial(
                CombinedNodeAttentionUpdateFeature, num_heads=2,
                mlp_factory=_mlp(['log', 1], True, False, fwdlap.tanh, 'ferminet'),
                attention_residual=nn.ResidualConnection(normalize=False),
                mlp_residual=nn.ResidualConnection(normalize=False), elec_to_nuc=True)]),
    )
    shape = (n_orb * n_det * n_env,)
    return build_ansatz(hamil, dict(
        omni_factory=partial(
            OmniNet, embedding_dim=16, jastrow_factory=None,
            backflow_factory=partial(Backflow, subnet_factory=_mlp(
                ['log', 1], False, True, None, 'ferminet')),
            nuclear_gnn_head=partial(NuclearGNNHead,
                                     one_particle_parameters={'zetas': shape, 'pis': shape}),
            gnn_factory=gnn),
        envelope=partial(SimplifiedNucleusDependentEnvelopes, n_envelope_per_nucleus=n_env,
                         per_orbital_exponent=True, fixed_pi=False),
        backflow_op=partial(BackflowOp, mult_act=lambda x: x), n_determinants=n_det,
        full_determinant=True, cusp_electrons=None,
        cusp_nuclei=partial(NuclearCuspAsymptotic, trainable_alpha=True,
                            cusp_function=PsiformerCusp()),
        backflow_transform='mult', conf_coeff=nn.SumPool,
    ), seed=seed)


def deeperwin_path(dq, hamil, R, smi, counts, zero_counts):
    """Phase 16: the DeepErwin preset's evaluation (kernel 2 once a local energy,
    nothing else) and E_loc gate; one evaluation step of the transferable
    components (kernel 2 once, kernel 1 once a layer) and their E_loc gate;
    ``ansatz=deeperwin`` trained through the command line in a subprocess
    (every step finite, launching kernel 2 once, changing the parameters, as
    its checkpoints show).  Returns the kernel launches of the phase."""
    from functools import partial

    import torch

    from deepqmc_tpu_torch.fit import molecule_state
    from deepqmc_tpu_torch.log import CheckpointStore
    from deepqmc_tpu_torch.utils import cuda_median_ms

    total = dict.fromkeys(counts(), 0)
    slogdet_once = dict.fromkeys(total, 0) | {'fl_slogdet_traces': 1}
    models = (
        ('deeperwin', partial(dq.deeperwin_ansatz, hamil, seed=0), DW_EVAL_STEPS, slogdet_once),
        ('transferable components', partial(transferable_ansatz, hamil), 1,
         slogdet_once | {'fl_attention': 2}),
    )
    for label, make_wf, n_steps, per_eloc in models:
        wf = make_wf()
        n_params = sum(p.numel() for p in wf.parameters())
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        seen, step_s, last = counts(), [], None
        t0 = time.monotonic()
        for step, state, E_loc, stats in dq.evaluate(hamil, wf, n_walkers=DW_WALKERS,
                                                     steps=n_steps, decorr=10, seed=0):
            torch.cuda.synchronize()
            step_s.append(time.monotonic() - t0)
            now = counts()
            launches = {k: now[k] - seen[k] for k in now}
            seen = now
            print(f'{label} step {step}: E_loc mean {stats["local_energy/mean"].item():.6f} std '
                  f'{stats["local_energy/std"].item():.6f} acceptance '
                  f'{stats["sampling/acceptance"].item():.4f} time {step_s[-1]:.3f} s; '
                  f'launches {launches}', flush=True)
            if not torch.isfinite(E_loc).all() or E_loc.shape != (DW_WALKERS,):
                raise SystemExit(f'{label} step {step}: E_loc not finite or of shape '
                                 f'{tuple(E_loc.shape)}')
            if launches != per_eloc:
                raise SystemExit(f'{label} step {step} launched {launches}, want {per_eloc}')
            last = molecule_state(state)[1]
            t0 = time.monotonic()
        for k, v in counts().items():
            total[k] += v
        with torch.inference_mode():
            pc = dq.PhysicalConfiguration(
                R, last['r'], torch.zeros(DW_WALKERS, dtype=torch.long, device='cuda'))
            eloc_ms = cuda_median_ms(lambda: hamil.local_energy(wf, pc), runs=3, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'{smi} | deeperwin path {label} ({n_params} parameters), {DW_WALKERS} walkers: '
              f'median evaluation step {_median(step_s):.3f} s (steps '
              f'{", ".join(f"{t:.3f}" for t in step_s)} s); local energy alone {eloc_ms:.1f} '
              f'ms; launches a local energy {per_eloc}; peak device memory {peak:.2f} GiB',
              flush=True)
        check_eloc_64(f'deeperwin path {label}', hamil, R, wf, make_wf, last['r'])
        del wf, pc, last, state
        torch.cuda.empty_cache()

    root = os.path.dirname(os.path.abspath(__file__))
    workdir = os.path.join(root, 'runs', 'deeperwin_path')
    shutil.rmtree(workdir, ignore_errors=True)
    cmd = [sys.executable, '-m', 'deepqmc_tpu_torch', 'ansatz=deeperwin', 'hamil/mol=H2O',
           f'task.steps={DW_CLI_STEPS}', f'task.pretrain_steps={DW_CLI_PRETRAIN_STEPS}',
           f'+task.max_eq_steps={DW_CLI_EQ_STEPS}', '+task.chkpt_constructor.interval=1',
           *CLI_SINKS_OFF, f'--workdir={workdir}']
    print(f'deeperwin path: python3 {" ".join(cmd[1:])} (train.yaml: 1000 walkers, '
          f'decorr_langevin, KFAC; cut: pretraining {DW_CLI_PRETRAIN_STEPS} steps of 100, '
          f'equilibration {DW_CLI_EQ_STEPS} calls, fit {DW_CLI_STEPS} steps of 1000, a '
          'checkpoint every step)', flush=True)
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=DW_CLI_TIMEOUT_S)
    wall_s = time.time() - t0
    if proc.returncode:
        print(proc.stderr[-6000:], file=sys.stderr, flush=True)
        raise SystemExit(f'deeperwin path: the training run exited with {proc.returncode}')
    steps, text, peak_gib = _log_steps(workdir, 'training')
    step_s = _check_steps('deeperwin path training', steps, DW_CLI_STEPS, slogdet_once)
    for line in text.splitlines():
        if 'SCF solution in' in line or 'Pretraining completed' in line:
            print(f'deeperwin path training: {line}', flush=True)
    params = [CheckpointStore.load(os.path.join(workdir, 'training', f'chkpt-{i}.pt'))[1].params
              for i in range(DW_CLI_STEPS + 1)]
    for i, (before, after) in enumerate(zip(params, params[1:])):
        if not all(torch.isfinite(v).all() for v in after.values()):
            raise SystemExit(f'deeperwin path training: step {i} left parameters not finite')
        if all(torch.equal(before[k], after[k]) for k in before):
            raise SystemExit(f'deeperwin path training: step {i} left the parameters unchanged')
    print(f'deeperwin path training: each of the {DW_CLI_STEPS} fit steps changed the '
          'parameters (checkpoints 0-6), all finite', flush=True)
    print(f'{smi} | deeperwin path training run (1000 walkers): subprocess wall time '
          f'{wall_s:.1f} s, first fit step logged {steps[0][0] - t0:.1f} s after the start, '
          f'median fit step {1e3 * _median(step_s):.1f} ms (steps '
          f'{", ".join(f"{1e3 * t:.1f}" for t in step_s)} ms), peak device memory '
          f'{peak_gib:.3f} GiB', flush=True)
    for k in total:
        total[k] += steps[-1][2]['launches'][k]
    shutil.rmtree(workdir)
    return total


MB_SCALES = (0.9, 1.0, 1.1, 1.25)  # the O-H bonds of the mol batch path's geometries
MB_WALKERS, MB_EQ_STEPS, MB_FIT_STEPS, MB_EVAL_STEPS = 2048, 5, 5, 2
MB_CHECK_WALKERS = 64  # a molecule, for the float64 gate
DP_WALKERS, DP_STEPS = 2048, 3  # a molecule over both ranks
DP_RANK_TIMEOUT_S = 120
DP_DIR = os.path.join('runs', 'dp_path')  # git-ignored; removed at the end of the phase


def h2o_geometries(dq, hamil, scales=MB_SCALES):
    """H2O with both O-H bonds at ``scales`` times ``hamil.mol``'s (O first)."""
    import numpy as np

    mol = hamil.mol
    coords = np.asarray(mol.coords)
    return [dq.Molecule(coords=np.concatenate([coords[:1], coords[:1] + s * (coords[1:]
                                                                             - coords[:1])]),
                        charges=mol.charges, charge=mol.charge, spin=mol.spin) for s in scales]


def _grid_replicas(dq, hamil, weights, R, r):
    """(wave function, loss, walkers, unit weights) of the PsiFormer holding
    ``weights`` on the grid ``R`` ``[m, n_nuc, 3]``, ``r`` ``[m, 1, B, n, 3]``:
    the card in float32 and the plain path on the CPU in float64 and float32."""
    import torch

    from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask

    out = {}
    for name, dtype, device in (('card', torch.float32, 'cuda'),
                                ('plain_f64', torch.float64, 'cpu'),
                                ('plain_f32', torch.float32, 'cpu')):
        wf = dq.psiformer_ansatz(hamil, seed=0).to(device=device, dtype=dtype)
        wf.load_state_dict({k: v.to(dtype) for k, v in weights.items()})
        m, _, B = r.shape[:3]
        pc = dq.PhysicalConfiguration(
            R.to(device, dtype), r.to(device, dtype),
            torch.arange(m, device=device)[:, None, None].expand(m, 1, B).clone())
        ones = torch.ones(m, 1, B, dtype=dtype, device=device)
        out[name] = wf, create_loss_fn(hamil, wf, median_log_squeeze_and_mask), pc, ones
    return out


def _gradient_and_update(loss, wf, pc, ones, opt_state=None):
    """(E_loc, the flat gradient, the flat KFAC update) of one KFAC step from
    ``opt_state`` (a fresh state for None) on the walkers ``pc``."""
    import torch

    from deepqmc_tpu_torch.fit import DEFAULT_OPT_KWARGS
    from deepqmc_tpu_torch.kfac import KFAC

    (_, (E, _, _)), g = loss.value_and_grad(pc, ones)
    kfac = KFAC(loss, **DEFAULT_OPT_KWARGS['kfac'])
    state = kfac.init(pc) if opt_state is None else opt_state
    if opt_state is not None:
        kfac.init(pc)
    before = flat_params(wf)
    kfac.step(state, pc, ones)
    return E, torch.cat([t.flatten() for t in g.values()]), flat_params(wf) - before


def _per_step_launches(label, records, want):
    """Each record's launches since the one before it, each against ``want``."""
    prev = None
    for r in records:
        if prev is not None:
            launches = {k: r['counts'][k] - prev[k] for k in prev}
            if launches != want:
                raise SystemExit(f'{label} step {r["step"]} launched {launches}, want {want}')
        prev = r['counts']


def mol_batch_path(dq, hamil, smi, counts, zero_counts, per_op_step):
    """Phase 17: two of four H2O geometries a step through ``train.train``,
    then 2 evaluation steps; the float64 gate on 64 walkers a molecule.
    Returns (the launches of the run, the walkers and nuclei of two molecules
    for the dp path, the plain float32 path's errors as the dp path's bars)."""
    from functools import partial

    import numpy as np
    import torch

    from deepqmc_tpu_torch.fit import DEFAULT_OPT_KWARGS, electron_sampler
    from deepqmc_tpu_torch.log import no_sink
    from deepqmc_tpu_torch.optimizer import KFACOptimizer
    from deepqmc_tpu_torch.sampling import initialize_sampling
    from deepqmc_tpu_torch.train import train

    mols = h2o_geometries(dq, hamil)
    wf = dq.psiformer_ansatz(hamil, seed=0).cuda()
    records, _, Metrics, _ = _recording_sinks(counts, wf)
    workdir = os.path.join('runs', 'mol_batch_path')
    shutil.rmtree(workdir, ignore_errors=True)
    common = dict(sampler_factory=partial(initialize_sampling,
                                          elec_sampler=electron_sampler(None, 10)),
                  seed=0, electron_batch_size=MB_WALKERS, molecule_batch_size=2, mols=mols,
                  workdir=workdir, chkpt_constructor=no_sink, metric_logger_constructor=Metrics,
                  h5_logger_constructor=no_sink, device='cuda')
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    before = flat_params(wf)
    state = train(hamil, wf, partial(KFACOptimizer, **DEFAULT_OPT_KWARGS['kfac']),
                  steps=MB_FIT_STEPS, max_eq_steps=MB_EQ_STEPS, eq_allow_early_stopping=False,
                  **common)
    fit = [r for r in records if r['prefix'] is None]
    eq = [r for r in records if r['prefix'] == 'equilibration']
    eval_records = len(records)
    train(hamil, wf, None, train_state=state, steps=MB_EVAL_STEPS, **common)
    torch.cuda.synchronize()
    evals = records[eval_records:]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    shutil.rmtree(workdir, ignore_errors=True)
    if len(fit) != MB_FIT_STEPS or len(eq) != MB_EQ_STEPS or len(evals) != MB_EVAL_STEPS:
        raise SystemExit('mol batch path: the run did not take the steps it was given')
    if any(eq[-1]['counts'].values()):
        raise SystemExit(f'mol batch path: equilibration launched {eq[-1]["counts"]}')
    _per_step_launches('mol batch path fit', [eq[-1], *fit], per_op_step)
    _per_step_launches('mol batch path evaluation', [fit[-1], *evals], per_op_step)
    ewm, prev_params = {}, before
    for r in [*fit, *evals]:
        stats = r['stats']
        E = np.asarray(stats['local_energy/mean'])
        print(f'mol batch step {r["step"]} ({"fit" if r in fit else "evaluation"}): molecules '
              f'{r["mol_idxs"]} E_loc mean {np.round(E.ravel(), 6).tolist()} energy EWM '
              f'{np.round(np.asarray(stats["energy/ewm"]).ravel(), 6).tolist()} step time '
              f'{stats["perf/step_time"]:.3f} s', flush=True)
        if E.shape != (2, 1) or not all(np.isfinite(v).all() for v in stats.values()):
            raise SystemExit(f'mol batch step {r["step"]}: stats not finite or E of shape '
                             f'{E.shape}')
        for i, m in enumerate(r['mol_idxs']):
            ewm[int(m)] = float(np.asarray(stats['energy/ewm'])[i, 0])
        if r in fit:
            if torch.equal(r['params'], prev_params):
                raise SystemExit(f'mol batch fit step {r["step"]} left the parameters unchanged')
            prev_params = r['params']
        elif not torch.equal(r['params'], prev_params):
            raise SystemExit(f'mol batch evaluation step {r["step"]} changed the parameters')
    if sorted(ewm) != list(range(len(mols))) or not all(map(math.isfinite, ewm.values())):
        raise SystemExit(f'mol batch path: the energy EWMs of the molecules touched: {ewm}')
    fit_s = [r['stats']['perf/step_time'] for r in fit]
    eval_s = [r['stats']['perf/step_time'] for r in evals]
    print(f'{smi} | mol batch fit step (2 of 4 H2O geometries, {MB_WALKERS} walkers a '
          f'molecule, KFAC): median {1e3 * _median(fit_s):.1f} ms (steps '
          f'{", ".join(f"{1e3 * t:.1f}" for t in fit_s)} ms); launches a step {per_op_step} '
          f'at B = {2 * MB_WALKERS}', flush=True)
    print(f'{smi} | mol batch evaluation step: {", ".join(f"{1e3 * t:.1f}" for t in eval_s)} '
          f'ms; peak device memory {peak_gib:.2f} GiB', flush=True)

    # the float64 gate on 64 walkers of each of two molecules
    elec = state.sampler['elec']
    r = elec['r'][:2, :, :MB_CHECK_WALKERS].detach()
    R = state.sampler['nuc']['R'][:2]
    weights = {k: v.cpu() for k, v in wf.state_dict().items()}
    from deepqmc_tpu_torch.log import copy_train_state

    opt_state = copy_train_state(state).opt
    vals = {}
    for name, (wf_r, loss_r, pc, ones) in _grid_replicas(dq, hamil, weights, R, r).items():
        dtype, device = ones.dtype, ones.device
        vals[name] = _gradient_and_update(loss_r, wf_r, pc, ones,
                                          kfac_state_to(opt_state, dtype, device))
    ref_E = vals['plain_f64'][0]
    scale = ref_E.abs().clamp(min=1.0)
    rel = {n: ((vals[n][0].double().cpu() - ref_E) / scale).abs().max().item()
           for n in ('card', 'plain_f32')}
    bars = {}
    for i, what in ((0, 'E_loc'), (1, 'gradient'), (2, 'KFAC update')):
        if i:
            rel = {n: rel_l2(vals[n][i], vals['plain_f64'][i]) for n in ('card', 'plain_f32')}
        tol = ELOC_FACTOR * rel['plain_f32'] + ELOC_FLOOR
        bars[what] = rel['plain_f32']
        ok = rel['card'] <= tol
        print(f'mol batch {what} on {MB_CHECK_WALKERS} walkers of 2 molecules against the '
              f'plain path in f64 (CPU): card (f32, kernels) rel err {rel["card"]:.3e}; plain '
              f'path (f32, CPU) rel err {rel["plain_f32"]:.3e}; tol {tol:.3e} '
              f'{"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            raise SystemExit(f'mol batch path: the {what} on the card disagrees with float64')
    launches = {k: evals[-1]['counts'][k] for k in evals[-1]['counts']}
    walkers = (elec['r'][:2, :, :DP_WALKERS].detach().clone(), R.detach().clone())
    del wf, state, records
    torch.cuda.empty_cache()
    return launches, walkers, bars


def dp_rank(rank: int, world: int, port: int) -> int:
    """One rank of the dp path: the gradient and a KFAC update on the fixed
    walkers of ``DP_DIR``, then ``DP_STEPS`` KFAC steps through ``fit.train``;
    writes what it computed to ``DP_DIR/rank<rank>.pt``."""
    faulthandler.dump_traceback_later(DP_RANK_TIMEOUT_S, exit=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import torch.distributed as dist

    import deepqmc_tpu_torch as dq
    from deepqmc_tpu_torch import parallel
    from deepqmc_tpu_torch.ops import _cuda
    from deepqmc_tpu_torch.ops.fl_attention import mha_core_fl
    from deepqmc_tpu_torch.ops.fl_slogdet import slogdet_traces
    from deepqmc_tpu_torch.utils import set_true_fp32

    if not _cuda.library_path().exists():
        raise SystemExit(f'rank {rank}: the kernels are not built')
    set_true_fp32()
    # gloo: NCCL takes one rank a GPU, and both ranks share the one card here
    parallel.maybe_init_multi_host('cuda', environ=_multihost_env(port, world, rank),
                                   backend='gloo')
    counters = (mha_core_fl, slogdet_traces)
    want = [4, 1]

    def launches():
        return [c.launches for c in counters]

    data = torch.load(os.path.join(DP_DIR, 'walkers.pt'), weights_only=True)
    hamil = dq.MolecularHamiltonian(mol=dq.Molecule.from_name('H2O'))
    mols = h2o_geometries(dq, hamil)[:2]
    wf = dq.psiformer_ansatz(hamil, seed=0).cuda()
    from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask

    loss = create_loss_fn(hamil, wf, median_log_squeeze_and_mask)
    r = parallel.shard_walkers(data['r'].cuda())
    pc = dq.PhysicalConfiguration(data['R'].cuda(), r, torch.arange(
        2, device='cuda')[:, None, None].expand(r.shape[:3]).clone())
    for c in counters:
        c.launches = 0
    with torch.inference_mode():
        loss.terms(pc, torch.ones(r.shape[:3], device='cuda'))
    torch.cuda.synchronize()
    eloc_launches = launches()
    E, grad, update = _gradient_and_update(loss, wf, pc, torch.ones(r.shape[:3], device='cuda'))
    out = {'eloc_launches': eloc_launches, 'E': torch.as_tensor(parallel.gather_on_host(E)),
           'grad': grad.cpu(),
           'update': update.cpu()}

    wf = dq.psiformer_ansatz(hamil, seed=0).cuda()
    step_s, step_launches, t0, seen = [], [], time.monotonic(), launches()
    for step, _, E_loc, stats in dq.fit.train(hamil, wf, n_walkers=DP_WALKERS, steps=DP_STEPS,
                                              decorr=10, seed=0, mols=mols,
                                              molecule_batch_size=2, device='cuda'):
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        now = launches()
        step_launches.append([a - b for a, b in zip(now, seen)])
        seen = now
        if not (torch.isfinite(E_loc).all() and all(torch.isfinite(v).all()
                                                    for v in stats.values())):
            raise SystemExit(f'rank {rank} step {step}: not finite')
        t0 = time.monotonic()
    out |= {'step_s': step_s, 'step_launches': step_launches, 'params': flat_params(wf).cpu(),
            'walkers': list(r.shape)}
    torch.save(out, os.path.join(DP_DIR, f'rank{rank}.pt'))
    dist.destroy_process_group()
    if eloc_launches != want or any(n != want for n in step_launches):
        raise SystemExit(f'rank {rank}: launches {eloc_launches}, {step_launches}, want {want}')
    return 0


def _multihost_env(port: int, world: int, rank: int) -> dict:
    """The variables that start rank ``rank`` of ``world`` (``DEEPQMC_TPU_*``)."""
    return {'DEEPQMC_TPU_MULTIHOST': '1', 'DEEPQMC_TPU_COORDINATOR_ADDRESS': f'127.0.0.1:{port}',
            'DEEPQMC_TPU_NUM_PROCESSES': str(world), 'DEEPQMC_TPU_PROCESS_ID': str(rank)}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def dp_path(dq, hamil, smi, counts, zero_counts, walkers, bars):
    """Phase 18: two ``gloo`` ranks on the card against this process on the
    same walkers, their parameters after 3 steps, then one ``nccl`` group of
    one rank; returns the launches of rank 0's run."""
    import torch
    import torch.distributed as dist

    r, R = walkers
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    torch.save({'r': r.cpu(), 'R': R.cpu()}, os.path.join(DP_DIR, 'walkers.pt'))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), '--dp-rank', str(rank),
                               '2', str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    # one process on the whole batch meanwhile
    wf = dq.psiformer_ansatz(hamil, seed=0).cuda()
    from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask

    loss = create_loss_fn(hamil, wf, median_log_squeeze_and_mask)
    pc = dq.PhysicalConfiguration(R, r, torch.arange(2, device='cuda')[:, None, None].expand(
        r.shape[:3]).clone())
    _, grad, update = _gradient_and_update(loss, wf, pc, torch.ones(r.shape[:3], device='cuda'))
    del wf, loss
    failed = []
    for rank, proc in enumerate(procs):
        try:
            log, _ = proc.communicate(timeout=DP_RANK_TIMEOUT_S + 20)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            raise SystemExit(f'dp path: rank {rank} hung')
        print(f'--- rank {rank} (exit {proc.returncode})\n{log[-2000:]}', flush=True)
        if proc.returncode != 0:
            failed.append(rank)
    if failed:
        raise SystemExit(f'dp path: ranks {failed} failed')
    ranks = [torch.load(os.path.join(DP_DIR, f'rank{k}.pt'), weights_only=True) for k in range(2)]
    for what, got, ref in (('gradient', ranks[0]['grad'], grad),
                           ('KFAC update', ranks[0]['update'], update)):
        rel = rel_l2(got, ref)
        tol = ELOC_FACTOR * bars[what] + ELOC_FLOOR
        ok = rel <= tol
        print(f'dp path {what}: rank 0 of 2 (gloo, {ranks[0]["walkers"][2]} walkers a molecule '
              f'a rank) against one process on the {r.shape[2]} walkers a molecule: rel err '
              f'{rel:.3e}; tol {tol:.3e} (the mol batch path\'s plain f32 error {bars[what]:.3e}) '
              f'{"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            raise SystemExit(f'dp path: the {what} of two ranks disagrees with one process')
    same = torch.equal(ranks[0]['params'], ranks[1]['params'])
    print(f'dp path: parameters after {DP_STEPS} KFAC steps bitwise equal across the ranks: '
          f'{same}', flush=True)
    if not same:
        raise SystemExit('dp path: the ranks\' parameters differ')
    for k, rk in enumerate(ranks):
        print(f'{smi} | dp path rank {k} of 2 (gloo, one card): step times '
              f'{", ".join(f"{1e3 * t:.1f}" for t in rk["step_s"])} ms; launches a local '
              f'energy {rk["eloc_launches"]}, a step {rk["step_launches"]}', flush=True)

    # one NCCL group of one rank: the same code path over NCCL
    from deepqmc_tpu_torch import parallel

    if not parallel.maybe_init_multi_host('cuda', environ=_multihost_env(_free_port(), 1, 0)):
        raise SystemExit('dp path: the NCCL group did not form')
    if dist.get_backend() != 'nccl':
        raise SystemExit(f'dp path: the group took {dist.get_backend()}, not nccl')
    try:
        wf = dq.psiformer_ansatz(hamil, seed=0).cuda()
        zero_counts()
        t0 = time.monotonic()
        for step, _, E_loc, stats in dq.fit.train(
                hamil, wf, n_walkers=DP_WALKERS, steps=1, decorr=10, seed=0,
                mols=h2o_geometries(dq, hamil)[:2], molecule_batch_size=2, device='cuda'):
            torch.cuda.synchronize()
            nccl_s = time.monotonic() - t0
            if not torch.isfinite(E_loc).all():
                raise SystemExit('dp path: the NCCL step is not finite')
        nccl_launches = counts()
    finally:
        dist.destroy_process_group()
    print(f'{smi} | dp path NCCL group of one rank: a fit step (with its set-up) '
          f'{1e3 * nccl_s:.1f} ms; launches {nccl_launches}', flush=True)
    shutil.rmtree(DP_DIR)
    if nccl_launches['fl_attention'] != 4 or nccl_launches['fl_slogdet_traces'] != 1:
        raise SystemExit(f'dp path: the NCCL step launched {nccl_launches}')
    del wf
    torch.cuda.empty_cache()
    return {'fl_attention': sum(n[0] for n in ranks[0]['step_launches']) + 4,
            'fl_slogdet_traces': sum(n[1] for n in ranks[0]['step_launches']) + 1}


# ---- the precision path: the JAX package's precision levers on the card ----

# A bf16 value's spacing relative to it (8 significant bits): J_t of a bf16
# store is the kernel's float32 value rounded there, so it may sit half a
# spacing from the plain version's float32 value, and a spacing where the two
# float32 values straddle a rounding boundary.
BF16_ULP = 2.0 ** -8
# Kernel 1's low mode against the plain low mode, worst element: both round
# the operands of the Jacobian contractions to bf16, but the operands they
# compute first (a, Ja) differ in float32's last bits between the two, so a
# rounding may land one bf16 spacing apart (2^-8 of the operand) and move its
# products by as much; four such spacings of the output's scale bound what a
# few of them add.  This bound cannot tell the modes apart (rounding the
# operands moves an output by less than a spacing): LOW_SEPARATION does.
LOW_RTOL = 2.0 ** -6
# Kernel 1 in either mode is held to the plain version of its own mode and of
# the other, on the outputs the mode changes (J_t, L_t; J_t at the kernel's
# store dtype): the mean |kernel - plain of its mode| may be at most this
# share of the mean |kernel - plain of the other mode|.  Rounding flips make
# the first 1e-4 to 8e-4 of the second (an H100, the main shapes); a kernel
# that ignores the mode, or rounds one operand of a product and not the
# other, reads about 1.
LOW_SEPARATION = 0.25
# Sampling under 'high' (TF32, 10 mantissa bits, unit roundoff 2^-11 = 4.9e-4)
# against 'highest' on the same walkers: log|psi| through 4 layers of
# 256-wide products, max |d log psi| / max(1, |log psi|); TF32's roundoff,
# grown 20 times through the network's products, is about 1e-2.
SAMPLE_PSI_RTOL = 1e-2
# E_loc of 64 walkers under the bf16 store, relative to max(1, |E_loc|),
# against float64 without levers: the card's kernels and the plain path
# (float32, CPU) round at the same points.  The worst walker (near a node,
# where the Slater inverses amplify the rounding) is held by the ELOC_FACTOR
# rule; the median walker within ELOC_MEDIAN_FACTOR of the plain path's
# median, both ways: a lever the card ignored reads float32's error, more
# than 15 times less (the main path's worst walker is 1.3e-4 from float64,
# the bf16 store's median 2e-3), and one off by order 1 some 500 times more.
# On an H100 (700 W) the card's median over the plain path's read 1.16 (the
# store alone) and 0.78 (with the bf16 products).  The card is not held to
# the plain path under the same levers walker by walker: one bf16 rounding
# that lands apart (float32 sums in other orders) changes every value after
# it by a bf16 spacing, so later roundings land apart at random, and the two
# differ by as much as each differs from float64 (medians 1.9e-3 and 2.1e-3).
ELOC_MEDIAN_FACTOR = 2.0
# The gradient under 'high' against 'highest' on the same walkers, relative
# L2, on three draws of 2048 walkers (10 Metropolis moves each).  Two
# gradients: that of the mean of log|psi| and the loss's, a mean of
# (E_loc - mean) d log psi.  On an H100 (700 W) the first read 1.20e-2,
# 1.72e-2 and 1.22e-2, some 30 times TF32's unit roundoff (2^-11): the
# rounding of the products grows through the layers and the determinants'
# pullback.  The loss's read 4.83e-2, 9.89e-2 and 3.60e-2, 3 to 6 times
# more: its coefficients change sign across the walkers, so its terms cancel
# to a sum smaller than they are, and their roundings do not cancel with
# them.  Each bar is twice the worst of the three.  Both must also differ
# from 'highest' by more than GRAD_TF32_MIN and ten times the difference of
# two 'highest' gradients (0 there): a context that does nothing reads
# that difference.
GRAD_PSI_RTOL = 3.5e-2
GRAD_HIGH_RTOL = 0.2
GRAD_TF32_MIN = 1e-5
GRAD_SEEDS = (3, 4, 5)
PRECISION_WALKERS = 64


def bf16_split(args, slots):
    """(args with the Jacobian operands at ``slots`` stored in bf16, the same
    operands upcast back to float32)."""
    low, up = list(args), list(args)
    for i in slots:
        low[i] = args[i].bfloat16()
        up[i] = low[i].float()
    return tuple(low), tuple(up)


def excess_rel(got, ref, rtol_ulp=0.0):
    """(max |got - ref|, the largest excess of |got - ref| over ``rtol_ulp``
    |ref|, relative to max(1, max |ref|))."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    scale = max(1.0, ref.abs().max().item())
    return diff.max().item(), (diff - rtol_ulp * ref.abs()).max().item() / scale


def bf16_kernel_cases(mha_core_fl, mha_core_fl_plain, slogdet_traces, slogdet_traces_plain,
                      square_traces, square_traces_plain, square_split_traces,
                      square_split_traces_plain):
    """The bf16 variants of kernels 1-4: (name, kernel, plain, inputs, Jacobian
    slots, outputs, index of a bf16 output, tolerance, bound, keywords,
    source, replaces)."""
    from functools import partial

    att = ('deepqmc_tpu_torch/csrc/fl_attention.cu', 'deepqmc_tpu/ops/fl_attention.py:481')
    sl = 'deepqmc_tpu_torch/csrc/fl_slogdet.cu'
    return [
        ('fl_attention_bf16', mha_core_fl, mha_core_fl_plain, attention_inputs, (3, 4, 5),
         ('t', 'J_t', 'L_t'), 1, KERNEL_RTOL, partial(attention_bound_ms, jbytes=2), {}, *att),
        ('fl_attention_bf16_low', mha_core_fl, mha_core_fl_plain, attention_inputs, (3, 4, 5),
         ('t', 'J_t', 'L_t'), 1, LOW_RTOL, partial(attention_bound_ms, jbytes=2),
         {'low': True}, *att),
        ('fl_attention_low', mha_core_fl, mha_core_fl_plain, attention_inputs, (),
         ('t', 'J_t', 'L_t'), None, LOW_RTOL, attention_bound_ms, {'low': True}, *att),
        ('fl_slogdet_traces_bf16', slogdet_traces, slogdet_traces_plain, slogdet_inputs, (1, 2),
         ('jout', 'trq'), None, KERNEL_RTOL, partial(slogdet_bound_ms, jbytes=2), {}, sl,
         'deepqmc_tpu/ops/fl_slogdet.py:566'),
        ('fl_slogdet_square_bf16', square_traces, square_traces_plain, square_inputs, (1,),
         ('jout', 'lout'), None, KERNEL_RTOL, partial(slogdet_bound_ms, with_l=True, jbytes=2),
         {}, sl, 'deepqmc_tpu/ops/fl_slogdet.py:133'),
        ('fl_slogdet_square_split_bf16', square_split_traces, square_split_traces_plain,
         square_split_inputs, (1, 2), ('jout', 'lout'), None, KERNEL_RTOL,
         partial(slogdet_bound_ms, with_l=True, jbytes=2), {}, sl,
         'deepqmc_tpu/ops/fl_slogdet.py:236'),
    ]


def check_bf16_case(case, gen, B, kw_shape, deterministic=True, timed=False):
    """One bf16 case at B walkers (``kw_shape`` the inputs' shape keywords)
    against its plain version fed the same operands upcast; raises where it
    disagrees or two launches differ.  Returns (worst abs error, ms, plain ms)."""
    import torch

    from deepqmc_tpu_torch.utils import cuda_median_ms

    name, kernel, plain, make, slots, outs, bf16_out, tol, _, kw, *_ = case
    pkw = {k: v for k, v in kw.items() if k != 'body'}  # the body is the kernel's alone
    args, up = bf16_split(make(gen, B, **kw_shape), slots)
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*up, **pkw)
    worst = 0.0
    for i, (label, o, r) in enumerate(zip(outs, got, ref)):
        err, rel = excess_rel(o, r, BF16_ULP if i == bf16_out else 0.0)
        ok = rel <= tol and math.isfinite(err)
        print(f'{name} B={B} {kw_shape} {label}: max abs err {err:.3e}, rel excess {rel:.3e} '
              f'(tol {tol:.1e}{" past a bf16 spacing" if i == bf16_out else ""}) '
              f'{"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            raise SystemExit(f'{name} disagrees with its plain version on {label}')
        worst = max(worst, err)
    if bf16_out is not None and got[bf16_out].dtype != torch.bfloat16:
        raise SystemExit(f'{name} wrote {got[bf16_out].dtype}, want bf16')
    if name.startswith('fl_attention'):  # the mode: nearer its own plain version
        low = pkw.get('low', False)
        other = plain(*up, **dict(pkw, low=not low))
        for label, o, r, x in zip(outs, got, ref, other):
            if label == 't':  # the primal's products never drop precision
                continue
            near, far = ((o.float() - y.to(o.dtype).float()).abs().mean().item() for y in (r, x))
            ok = near <= LOW_SEPARATION * far
            print(f'{name} B={B} {kw_shape} {label}: mean |kernel - plain low={low}| {near:.3e}, '
                  f'|kernel - plain low={not low}| {far:.3e} (at most {LOW_SEPARATION} of it) '
                  f'{"ok" if ok else "FAIL"}', flush=True)
            if not ok:
                raise SystemExit(f'{name} is not nearer its own mode (low={low}) on {label}')
        del other
    if deterministic:
        same = all(torch.equal(a, o) for a, o in zip(kernel(*args, **kw), got))
        print(f'{name} B={B} {kw_shape}: two launches bitwise equal: {same}', flush=True)
        if not same:
            raise SystemExit(f'{name} is not deterministic')
    ms = plain_ms = None
    if timed:
        ms = cuda_median_ms(lambda: kernel(*args, **kw))
        plain_ms = cuda_median_ms(lambda: plain(*args, **pkw))
    del args, up, got, ref
    return worst, ms, plain_ms


def precision_path(dq, hamil, R, r_main, smi, counters, zero_counts):
    """The precision levers: kernels 1-4 with bf16 Jacobians and kernel 1's
    low mode against their plain versions, timed; one local energy of the
    main path under the bf16 store with and without the bf16 contractions
    (launch counts by dtype, E_loc of 64 walkers against float64); the four
    log-determinant rules on a bf16 store; sampling and the gradient under
    'high'; 'medium' in cuBLAS; step times with the levers off and on.
    Returns the bf16 variants' records for the kernels line."""
    import torch

    from deepqmc_tpu_torch import fwdlap
    from deepqmc_tpu_torch.ab_lih_convergence import LEVERS_OFF, VARIANTS
    from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask
    from deepqmc_tpu_torch.ops import fl_attention, fl_slogdet
    from deepqmc_tpu_torch.ops.slogdet import unflatten_dets
    from deepqmc_tpu_torch.sampling import DecorrSampler, MetropolisSampler
    from deepqmc_tpu_torch.nn.core import dense_layer_paths
    from deepqmc_tpu_torch.utils import (
        cuda_median_ms,
        grad_precision_ctx,
        matmul_precision,
        sampling_precision_ctx,
    )

    gen = torch.Generator('cuda').manual_seed(19)
    cases = bf16_kernel_cases(
        fl_attention.mha_core_fl, fl_attention.mha_core_fl_plain, fl_slogdet.slogdet_traces,
        fl_slogdet.slogdet_traces_plain, fl_slogdet.square_traces,
        fl_slogdet.square_traces_plain, fl_slogdet.square_split_traces,
        fl_slogdet.square_split_traces_plain)
    records = {}
    for case in cases:
        name, bound, source, replaces = case[0], case[8], case[10], case[11]
        check_bf16_case(case, gen, 256, {})
        worst, ms, plain_ms = check_bf16_case(case, gen, 2048, {}, timed=True)
        bound_ms, nbytes, flops = bound(2048)
        bound_by = 'bytes' if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else 'operations'
        print(f'{smi} | {name} B=2048: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
              f'{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP)',
              flush=True)
        records[name] = dict(name=name, route='cuda', source=source, replaces=replaces,
                             launches=0, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        torch.cuda.empty_cache()
    # other shapes: odd n and dh, benzene's n = 42, K past a ring; the slogdet
    # kernels' plain bf16 copies (odd D n: one bf16 a copy), the shifted runs
    # of a square layout (tiled body forced) and n = 2 with no down rows
    att_shapes = (dict(K=21, n=7, H=2, dh=16), dict(K=9, n=33, H=2, dh=16),
                  dict(K=4, n=2, H=2, dh=8), dict(K=126, n=42))
    sl_shapes = (dict(K=15, D=3, nu=3, nd=2), dict(K=21, D=3, nu=4, nd=3),
                 dict(K=6, D=4, nu=2, nd=0), dict(K=126, D=4, nu=21, nd=21))
    for case in cases:
        for kw_shape in (att_shapes if case[0].startswith('fl_attention') else sl_shapes):
            check_bf16_case(case, gen, 5, kw_shape)
    for case in cases[4:]:  # a square layout's runs at their shift: n = 6, one determinant a block
        tiled = case[:9] + ({'body': fl_slogdet.TILED},) + case[10:]
        check_bf16_case(tiled, gen, 5, dict(K=9, D=2, nu=3, nd=3))
        rb = fl_slogdet.row_blocks(fl_slogdet.SQUARE, 2, 6, 0, 1, esize=2)
        print(f'{case[0]} n = 6: {body_of(case[1])}; a square record of it at bf16: vw '
              f'{rb.vw}, shift {rb.shift}', flush=True)
    torch.cuda.empty_cache()

    # cuBLAS and the 'medium' label: the error of one float32 product under
    # each torch precision against float64 (TF32 keeps 10 mantissa bits, bf16
    # 7).  The port refuses the JAX label 'default' where CUDA is present, as
    # long as cuBLAS runs 'medium' as TF32.
    a = torch.randn(1024, 1024, generator=gen, device='cuda')
    b = torch.randn(1024, 1024, generator=gen, device='cuda')
    ref = (a.double() @ b.double())
    errs = {}
    for label in ('highest', 'high', 'medium'):
        torch.set_float32_matmul_precision(label)
        try:
            errs[label] = ((a @ b).double() - ref).abs().max().item() / ref.abs().max().item()
        finally:
            torch.set_float32_matmul_precision('highest')
    takes_bf16 = errs['medium'] > 2 * errs['high']
    try:
        with matmul_precision('default'):
            refused = False
    except ValueError:
        refused = True
    print(f'one 1024 x 1024 float32 product against float64, max rel err: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f"; cuBLAS takes bf16 for 'medium': {takes_bf16}; the label 'default' refused: "
          f'{refused}', flush=True)
    if not (refused or takes_bf16):
        raise SystemExit("the label 'default' runs as TF32 on the card and was not refused")
    del a, b, ref

    # one local energy of the main path under the bf16 store, with and
    # without the bf16 contractions: launches by dtype, E_loc of 64 walkers
    wf = dq.psiformer_ansatz(hamil, seed=0).cuda()
    weights = {k: v.cpu() for k, v in wf.state_dict().items()}
    plain = {}
    for name, dtype in (('f64', torch.float64), ('f32', torch.float32)):
        plain[name] = dq.psiformer_ansatz(hamil, seed=0).to(dtype)
        plain[name].load_state_dict({k: v.to(dtype) for k, v in weights.items()})
    B = len(r_main)
    pc = dq.PhysicalConfiguration(R, r_main, torch.zeros(B, dtype=torch.long, device='cuda'))
    r64 = r_main[:PRECISION_WALKERS].cpu()
    idx64 = torch.zeros(PRECISION_WALKERS, dtype=torch.long)

    def eloc_cpu(wf_cpu, dtype):
        with torch.inference_mode():
            return hamil.local_energy(wf_cpu, dq.PhysicalConfiguration(
                R.cpu().to(dtype), r64.to(dtype), idx64))[0].double()

    with mock.patch.dict(os.environ, LEVERS_OFF):
        ref = eloc_cpu(plain['f64'], torch.float64)
    scale = ref.abs().clamp(min=1.0)
    for mm in ('f32', 'bf16'):
        with mock.patch.dict(os.environ, {'DEEPQMC_TPU_JAC_DTYPE': 'bf16',
                                          'DEEPQMC_TPU_JAC_MATMUL': mm}):
            with torch.inference_mode():
                zero_counts()
                e_card, _ = hamil.local_energy(wf, pc)
                torch.cuda.synchronize()
                att = dict(fl_attention.mha_core_fl.by_dtype)
                sl = dict(fl_slogdet.slogdet_traces.by_dtype)
                e_card64, _ = hamil.local_energy(wf, dq.PhysicalConfiguration(
                    R, r_main[:PRECISION_WALKERS], pc.mol_idx[:PRECISION_WALKERS]))
                eloc_ms = cuda_median_ms(lambda: hamil.local_energy(wf, pc), runs=3, warmup=1)
            e_plain = eloc_cpu(plain['f32'], torch.float32)
        low = mm == 'bf16'
        print(f'one local energy under JAC_DTYPE=bf16 JAC_MATMUL={mm}: attention launches by '
              f'(dtype, low) {att}, flat slogdet by dtype {sl}; {eloc_ms:.1f} ms at {B} walkers',
              flush=True)
        if att != {(torch.bfloat16, low): 4} or sl != {torch.bfloat16: 1}:
            raise SystemExit(f'one local energy under the bf16 store did not launch kernel 1 '
                             f'4 times and kernel 2 once with bf16 Jacobians (low {low})')
        if not torch.isfinite(e_card).all():
            raise SystemExit('the local energy under the bf16 store is not finite')
        err_card = (e_card64.double().cpu() - ref).abs() / scale
        err_plain = (e_plain - ref).abs() / scale
        same = (e_card64.double().cpu() - e_plain).abs() / scale
        tol = ELOC_FACTOR * err_plain.max().item() + ELOC_FLOOR
        med, med_plain = err_card.median().item(), err_plain.median().item()
        ok = (err_card.max().item() <= tol
              and med_plain / ELOC_MEDIAN_FACTOR <= med <= ELOC_MEDIAN_FACTOR * med_plain)
        print(f'E_loc on {PRECISION_WALKERS} walkers under JAC_DTYPE=bf16 JAC_MATMUL={mm}, '
              f'rel to max(1, |E_loc|), against the plain path in f64 without levers (CPU): '
              f'card worst {err_card.max().item():.3e} (tol {tol:.3e}), median {med:.3e}; the '
              f'plain path (f32, same levers, CPU) worst {err_plain.max().item():.3e}, median '
              f'{med_plain:.3e}; the medians {med / med_plain:.3f} apart (within '
              f'{ELOC_MEDIAN_FACTOR} both ways) {"ok" if ok else "FAIL"}; card against that '
              f'plain path (not gated) worst {same.max().item():.3e}, median '
              f'{same.median().item():.3e}', flush=True)
        if not ok:
            raise SystemExit('the local energy under the bf16 store disagrees with the plain path')
        for key in (('fl_attention_bf16_low' if low else 'fl_attention_bf16'),
                    'fl_slogdet_traces_bf16'):
            records[key]['launches'] = (att[torch.bfloat16, low] if key.startswith('fl_att')
                                        else sl[torch.bfloat16])
    with mock.patch.dict(os.environ, {'DEEPQMC_TPU_JAC_DTYPE': 'f32',
                                      'DEEPQMC_TPU_JAC_MATMUL': 'bf16'}):
        with torch.inference_mode():
            zero_counts()
            hamil.local_energy(wf, pc)
            att = dict(fl_attention.mha_core_fl.by_dtype)
        print(f'one local energy under JAC_MATMUL=bf16 alone: attention launches by (dtype, low) '
              f'{att}', flush=True)
        if att != {(torch.float32, True): 4}:
            raise SystemExit('JAC_MATMUL=bf16 alone did not run kernel 1 in its low mode')
        records['fl_attention_low']['launches'] = att[torch.float32, True]

    # the four log-determinant rules on a bf16 store (kernels 2, 3 and 4)
    D = wf.n_det
    with torch.inference_mode(), fwdlap.jac_levers(fwdlap.Levers(torch.bfloat16, False)):
        sp = dq.PhysicalConfiguration(R, fwdlap.FL.seed(r_main), pc.mol_idx)
        up, down = wf._spin_orbitals(sp)

        def square(v):
            return fwdlap.FL(*(unflatten_dets(t, D) for t in (v.x, v.stored_jac, v.lap)))

        sq_up, sq_down = square(up), square(down)
        zero_counts()
        outs = {
            'flat rows': fwdlap.slogdet_flat_rows(up, down, D),
            'flat whole': fwdlap.slogdet_flat(fwdlap.cat([up, down], -2), D),
            'square rows': fwdlap.slogdet_rows(sq_up, sq_down),
            'square whole': fwdlap.slogdet(fwdlap.cat([sq_up, sq_down], -2)),
        }
        torch.cuda.synchronize()
        by = {k: dict(c.by_dtype) for k, c in counters.items() if hasattr(c, 'by_dtype')}
        print(f'the four log-determinant rules on a bf16 store: launches by dtype {by}',
              flush=True)
        want = {'fl_slogdet_traces': {torch.bfloat16: 2}, 'fl_slogdet_square':
                {torch.bfloat16: 1}, 'fl_slogdet_square_split': {torch.bfloat16: 1}}
        if any(by[k] != v for k, v in want.items()):
            raise SystemExit(f'the log-determinant rules on a bf16 store launched {by}')
        records['fl_slogdet_square_bf16']['launches'] = by['fl_slogdet_square'][torch.bfloat16]
        records['fl_slogdet_square_split_bf16']['launches'] = \
            by['fl_slogdet_square_split'][torch.bfloat16]
        a, ja, la = (torch.cat(t, -2) for t in ((sq_up.x, sq_down.x),
                                                 (sq_up.stored_jac, sq_down.stored_jac),
                                                 (sq_up.lap, sq_down.lap)))
        ref = [t.double() for t in fl_slogdet.square_traces_plain(
            torch.linalg.inv(a.double()), ja.double(), la.double())]
        first = outs['flat rows'][1]
        for name, (sign, out) in outs.items():
            errs = [((g.double() - r).abs() / r.abs().clamp(min=1.0)).max().item()
                    for g, r in zip((out.jac, out.lap), ref)]
            agree = [((g.double() - f.double()).abs() / f.double().abs().clamp(min=1.0)).max()
                     .item() for g, f in zip((out.jac, out.lap), (first.jac, first.lap))]
            print(f'{name} on the bf16 store: J, L against f64 of the same store '
                  f'{errs[0]:.3e}, {errs[1]:.3e}; against flat rows {agree[0]:.3e}, '
                  f'{agree[1]:.3e}', flush=True)
            if not all(math.isfinite(e) for e in errs + agree):
                raise SystemExit(f'{name} on the bf16 store is not finite')
        del sp, up, down, sq_up, sq_down, outs, a, ja, la
    torch.cuda.empty_cache()

    # sampling and the gradient under 'high'; 'highest' inside the local energy
    seen = []  # the precision at each forward-Laplacian pass of the network
    fwd, bwd = [], []  # at each psi forward that the pullback runs, and inside it

    def psi_hook(m, args, out):
        if fwdlap.is_fl(args[0].r):
            seen.append(torch.get_float32_matmul_precision())
        elif out.log.requires_grad:
            fwd.append(torch.get_float32_matmul_precision())

    def dense_hook(m, args, out):  # fires as the pullback reaches each dense layer
        if isinstance(out, torch.Tensor) and out.requires_grad:
            out.register_hook(lambda g: bwd.append(torch.get_float32_matmul_precision()))

    hooks = [wf.register_forward_hook(psi_hook)]
    hooks += [m.register_forward_hook(dense_hook) for m in dense_layer_paths(wf)]
    sampler = DecorrSampler(length=10).wrap(MetropolisSampler(hamil, wf))
    state = {'r': r_main.clone(), 'age': torch.zeros(B, dtype=torch.long, device='cuda'),
             'tau': torch.tensor(0.3, device='cuda')}
    with mock.patch.dict(os.environ, {'DEEPQMC_TPU_SAMPLING_PRECISION': 'high'}), \
            torch.no_grad():
        with sampling_precision_ctx():  # the chain's psi all at 'high', as fit.train_step
            inside = torch.get_float32_matmul_precision()
            state = sampler.update(state, R)
            draws = [sampler.sample(torch.Generator('cuda').manual_seed(s), state, R)
                     for s in GRAD_SEEDS]
            new, spc, _ = draws[0]
            with torch.inference_mode():
                hamil.local_energy(wf, spc)
        after = torch.get_float32_matmul_precision()
    with torch.no_grad():
        psi = wf(spc).log
    rel = ((new['psi'].log - psi).abs().max() / psi.abs().max().clamp(min=1.0)).item()
    print(f'10 Metropolis moves under SAMPLING_PRECISION=high (context {inside}): log|psi| of '
          f'the sampled walkers against highest, max rel err {rel:.3e} (tol '
          f'{SAMPLE_PSI_RTOL:.0e}); precision inside the local energy {seen}, after the '
          f'context {after}', flush=True)
    if inside != 'high' or after != 'highest' or seen != ['highest'] or not rel <= SAMPLE_PSI_RTOL:
        raise SystemExit('sampling under high: wrong precision or log|psi| off')
    loss = create_loss_fn(hamil, wf, median_log_squeeze_and_mask)
    ones = torch.ones(B, device='cuda')
    params = list(wf.parameters())

    def gradient(label, walkers, of):
        """The loss's gradient (``of`` 'loss') or that of the mean of log|psi|
        under GRAD_PRECISION=label, flat; raises unless the label was in force
        at the psi forward and throughout the pullback, and nowhere else."""
        seen.clear(), fwd.clear(), bwd.clear()
        with mock.patch.dict(os.environ, {'DEEPQMC_TPU_GRAD_PRECISION': label}):
            if of == 'loss':
                _, g = loss.value_and_grad(walkers, ones)
                g = list(g.values())
            else:
                with grad_precision_ctx(), torch.enable_grad():
                    g = torch.autograd.grad(wf(walkers).log.mean(), params, allow_unused=True)
                g = [torch.zeros_like(p) if x is None else x for p, x in zip(params, g)]
        want_seen = ['highest'] if of == 'loss' else []
        if (seen != want_seen or set(fwd) != {label} or set(bwd) != {label}
                or torch.get_float32_matmul_precision() != 'highest'):
            raise SystemExit(f'the gradient of the {of} under GRAD_PRECISION={label}: precision '
                             f'in the local energy {seen}, at the psi forward {set(fwd)}, in the '
                             f'pullback {set(bwd)}, after {torch.get_float32_matmul_precision()}')
        return torch.cat([t.flatten() for t in g])

    print(f'gradients: the precision in force checked at the local energy, the psi forward '
          f'and each of the {len(hooks) - 1} dense layers in the pullback', flush=True)
    for i, (_, walkers, _) in enumerate(draws):
        for of, bar in (('mean log|psi|', GRAD_PSI_RTOL), ('loss', GRAD_HIGH_RTOL)):
            highest = gradient('highest', walkers, of)
            noise = rel_l2(gradient('highest', walkers, of), highest) if i == 0 else 0.0
            rel = rel_l2(gradient('high', walkers, of), highest)
            floor = max(GRAD_TF32_MIN, 10 * noise)
            ok = floor <= rel <= bar
            twice = f'{noise:.3e} apart' if i == 0 else 'not repeated'
            print(f'gradient of the {of} under GRAD_PRECISION=high against highest on the same '
                  f'{B} walkers (draw {GRAD_SEEDS[i]}), rel L2 {rel:.3e} (between {floor:.1e} '
                  f'and {bar:.2g}); two highest gradients {twice} {"ok" if ok else "FAIL"}',
                  flush=True)
            if not ok:
                raise SystemExit(f'the gradient of the {of} under high is not a TF32 rounding '
                                 'of the highest one')
    for h in hooks:
        h.remove()
    del loss, sampler, state, new, spc, draws, plain
    torch.cuda.empty_cache()

    # times, printed and not gated: an evaluation and a training step with
    # every lever off and on (the gate's r4_all, the JAX accelerator defaults);
    # the trace path times the training run with the levers off
    for label, env in (('off', LEVERS_OFF), ('on', VARIANTS['r4_all']['env'])):
        with mock.patch.dict(os.environ, env):
            for mode in ('evaluation',) if label == 'off' else ('evaluation', 'training'):
                wf_t = dq.psiformer_ansatz(hamil, seed=0).cuda()
                run = (dq.evaluate(hamil, wf_t, n_walkers=2048, steps=3, decorr=10, seed=0)
                       if mode == 'evaluation' else
                       dq.fit.train(hamil, wf_t, n_walkers=2048, steps=3, decorr=10, seed=0,
                                    optimizer='kfac'))
                times, t0 = [], time.monotonic()
                for _, _, E_loc, _ in run:
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.monotonic() - t0))
                    if not torch.isfinite(E_loc).all():
                        raise SystemExit(f'a {mode} step with the levers {label} is not finite')
                    t0 = time.monotonic()
                print(f'{smi} | {mode} step, 2048 walkers, levers {label}: steps '
                      f'{", ".join(f"{t:.1f}" for t in times)} ms', flush=True)
                del wf_t, run
    torch.cuda.empty_cache()
    return list(records.values())


TRACE_SLEEP_MS = 10.0  # the clock check's kernel
TRACE_LAUNCHES, TRACE_LAUNCH_GAP_S = 20, 0.05  # launches into an idle device over 1 s
TRACE_IDLE_S, TRACE_IDLE_COVER, TRACE_PLACE_NS = 0.02, 0.95, 50_000
TRACE_ITEMS = 5


def trace_path(dq, smi, per_op_step):
    """The spans' clock, idle placement and sync counter on the card, then
    the span tree of 3 KFAC steps; returns the launches of those steps.

    The spans' host clock must be the profiler's for its host events: each
    timed launch call lies between the host times taken around it.  The
    device's intervals may lie earlier than their launches, by a lag that
    may grow (the card's timer converted): moved later by the benchmark's
    estimate of it (``qmcbench/program_spans.py``), each kernel must lie
    inside its span and each idle gap must start at its span's start and
    last until its end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepqmc_tpu_torch import tracing
    from deepqmc_tpu_torch.ab_lih_convergence import LEVERS_OFF
    from qmcbench.program_spans import aligned, device_ops, skew_line

    print(smi, flush=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10**6)
    end.record()
    torch.cuda.synchronize()
    cycles = int(1e6 * TRACE_SLEEP_MS / start.elapsed_time(end))
    x = torch.ones(4, device='cuda')
    torch.cuda.synchronize()
    marks = []
    tracing.reset()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)  # the profiler's first launch
        torch.cuda.synchronize()
        for _ in range(TRACE_LAUNCHES):
            a = time.time_ns()
            torch.cuda._sleep(1000)
            marks.append((a, time.time_ns()))
            torch.cuda.synchronize()
            time.sleep(TRACE_LAUNCH_GAP_S)
        with tracing.span('clock'):
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
        torch.cuda._sleep(cycles // 20)
        torch.cuda.synchronize()
        with tracing.span('idle'):
            time.sleep(TRACE_IDLE_S)
        torch.cuda._sleep(cycles // 20)
        torch.cuda.synchronize()
        with tracing.span('items'):
            for _ in range(TRACE_ITEMS):
                x.sum().item()
        with tracing.span('queued'):
            for _ in range(10):
                x = x + 1
        torch.cuda.synchronize()
    tracing.disable()
    spans = {r['name']: r for r in tracing.records()}
    ops, calls = device_ops(prof)
    prog = {'device': ops, 'launch_ns': {c: t[0] for c, t in calls.items()}}
    host = dict(zip(ops, aligned(prog)))  # each operation on the host's clock
    t0, lead0, slope = skew_line(ops, prog['launch_ns'])
    timed = [(m, calls[k[3]], k) for m in marks for k in ops
             if k[3] in calls and m[0] <= calls[k[3]][0] <= m[1]]
    wholly = sum(c[1] <= m[1] for m, c, _ in timed)
    lead = [c[0] - k[0] for _, c, k in timed]
    print(f'trace path: host clock: {len(timed)} of {TRACE_LAUNCHES} timed launch calls (over '
          f'{1e-9 * (marks[-1][0] - marks[0][0]):.2f} s) found between their host times, '
          f'{wholly} wholly; launch call start - host time before it, median '
          f'{1e-3 * sorted(c[0] - m[0] for m, c, _ in timed)[len(timed) // 2]:.1f} us; their '
          f'launch call start - device start (raw) first {1e-3 * lead[0]:.1f} us, last '
          f'{1e-3 * lead[-1]:.1f} us, largest {1e-3 * max(lead):.1f} us; the device\'s lag '
          f'estimated over the trace {1e-3 * lead0:.1f} us + {1e6 * slope:.1f} ppm', flush=True)
    if len(timed) != TRACE_LAUNCHES or wholly != TRACE_LAUNCHES:
        raise SystemExit('the spans\' clock is not the profiler\'s host clock')
    clock = spans['clock']
    k = max(ops, key=lambda o: o[1] - o[0])
    (k0, k1, *_), c0 = host[k], calls[k[3]][0]
    print(f'trace path: clock: kernel of {1e-6 * (k[1] - k[0]):.3f} ms on the device; its '
          f'launch call {1e-3 * (c0 - clock["start_ns"]):.1f} us after the span start; kernel '
          f'start - span start {1e-3 * (k[0] - clock["start_ns"]):.1f} us raw, '
          f'{1e-3 * (k0 - clock["start_ns"]):.1f} us moved; span end - kernel end '
          f'{1e-3 * (clock["end_ns"] - k[1]):.1f} us raw, {1e-3 * (clock["end_ns"] - k1):.1f} us '
          f'moved', flush=True)
    if not clock['start_ns'] <= min(c0, k0) < k1 <= clock['end_ns']:
        raise SystemExit('the kernel does not lie inside its span')
    idle = spans['idle']
    a, b = idle['start_ns'], idle['end_ns']
    moved = sorted(host.values())
    before = max(e for _, e, *_ in moved if e <= (a + b) // 2)
    after, _, _, nxt = min(o for o in moved if o[0] >= (a + b) // 2)
    launch = calls[nxt][0]
    cover = (min(after, b) - max(before, a)) / (b - a)
    print(f'trace path: idle: span {1e-6 * (b - a):.3f} ms, device-idle gap '
          f'{1e-6 * (after - before):.3f} ms covering {100 * cover:.2f} % of it; gap start - '
          f'span start {1e-3 * (before - a):.1f} us; gap end - span end {1e-3 * (after - b):.1f} '
          f'us; the next launch call - span end {1e-3 * (launch - b):.1f} us (not bounded: the '
          f'host\'s time to its next launch), gap end - that call {1e-3 * (after - launch):.1f} '
          f'us (moved)', flush=True)
    if (cover < TRACE_IDLE_COVER or abs(before - a) > TRACE_PLACE_NS or after < max(b, launch)):
        raise SystemExit('the device-idle gap is not where its span is')
    syncs = {k: r['counts']['syncs'] for k, r in spans.items()}
    print(f'trace path: syncs by span {syncs} ({TRACE_ITEMS} .item() calls in items)',
          flush=True)
    if syncs['items'] != TRACE_ITEMS or syncs['queued'] != 0:
        raise SystemExit('the sync counter is wrong')

    hamil = dq.MolecularHamiltonian(mol=dq.Molecule.from_name('H2O'))
    wf = dq.psiformer_ansatz(hamil, seed=0)
    tracing.reset()
    tracing.enable()
    times, t0 = [], time.monotonic()
    with mock.patch.dict(os.environ, LEVERS_OFF):
        for _ in dq.fit.train(hamil, wf, n_walkers=2048, steps=3, decorr=10, seed=0,
                              optimizer='kfac'):
            torch.cuda.synchronize()
            times.append(1e3 * (time.monotonic() - t0))
            t0 = time.monotonic()
    tracing.disable()
    print(f'{smi} | training step, 2048 walkers, levers off (tracing on): steps '
          f'{", ".join(f"{t:.1f}" for t in times)} ms', flush=True)
    recs = tracing.records()
    print(tracing.summary(), flush=True)
    launches = dict.fromkeys(per_op_step, 0)
    for n in range(3):
        mine = [r for r in recs if r['step'] == n]
        names = [r['name'] for r in mine]
        want = {'step', 'sampling.sample', 'sampling.move', 'local_energy', 'grad',
                'grad.backward', 'grad.taps', 'kfac.update', 'kfac.factors',
                'kfac.precondition', 'sampling.update', 'fit.stats'}
        if n == 0:
            want.add('kfac.inverses')
        step = mine[0]
        print(f'trace path: step {n}: {len(mine)} spans, launches {step["launches"]}, syncs '
              f'{sum(r["counts"]["syncs"] for r in mine)}', flush=True)
        if (set(names) != want or names.count('sampling.move') != 10
                or step['launches'] != per_op_step):
            raise SystemExit(f'step {n}: the span tree or its launches are wrong: {names}')
        for k, v in step['launches'].items():
            launches[k] += v
    del wf
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script needs a GPU', file=sys.stderr)
        return 1
    try:
        import deepqmc_tpu_torch as dq
        from deepqmc_tpu_torch.ops import _cuda
        from deepqmc_tpu_torch import fwdlap
        from deepqmc_tpu_torch.ops.fl_attention import mha_core_fl, mha_core_fl_plain
        from deepqmc_tpu_torch.ops.fl_block import (
            psiformer_block_fl,
            psiformer_block_fl_plain,
            weight_bytes,
        )
        from deepqmc_tpu_torch.ops.fl_slogdet import (
            slogdet_traces,
            slogdet_traces_plain,
            square_split_traces,
            square_split_traces_plain,
            square_traces,
            square_traces_plain,
        )
        from deepqmc_tpu_torch.ops.slogdet import unflatten_dets
        from deepqmc_tpu_torch.fit import molecule_state
        from deepqmc_tpu_torch.utils import cuda_median_ms
    except ImportError as e:
        print(f'chip_smoke: the package deepqmc_tpu_torch is missing ({e}); run from the '
              'repository root', file=sys.stderr)
        return 1

    with Phase('device'):
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        print(f'torch {torch.__version__} cuda {torch.version.cuda} '
              f'device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}',
              flush=True)
        # true float32 (the precision API only: torch raises where it and the
        # legacy allow_tf32 flag disagree)
        torch.set_float32_matmul_precision('highest')
        torch.backends.cudnn.allow_tf32 = False

    with Phase('build'):
        shutil.rmtree(_cuda.BUILD_DIR, ignore_errors=True)
        t0 = time.monotonic()
        lib_path = _cuda.build(verbose=True)
        build_s = time.monotonic() - t0
        _cuda.library()
        print(f'built {lib_path.name} in {build_s:.2f} s', flush=True)

    if sys.argv[1:] == ['--only', 'trace_path']:
        with Phase('trace_path'):
            step = dict.fromkeys(dq.ops.launch_counts(), 0) | {'fl_attention': 4,
                                                              'fl_slogdet_traces': 1}
            print(f'launches during the trace path: {trace_path(dq, smi, step)}', flush=True)
        faulthandler.cancel_dump_traceback_later()
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count(),
        }}), flush=True)
        return 0

    kernels = []
    with Phase('kernels'):
        gen = torch.Generator('cuda').manual_seed(0)
        cases = [
            ('fl_attention', mha_core_fl, mha_core_fl_plain, attention_inputs,
             ('t', 'J_t', 'L_t'), attention_bound_ms,
             'deepqmc_tpu_torch/csrc/fl_attention.cu',
             'deepqmc_tpu/ops/fl_attention.py:481'),
            ('fl_slogdet_traces', slogdet_traces, slogdet_traces_plain, slogdet_inputs,
             ('jout', 'trq'), slogdet_bound_ms,
             'deepqmc_tpu_torch/csrc/fl_slogdet.cu',
             'deepqmc_tpu/ops/fl_slogdet.py:566'),
            ('fl_slogdet_square', square_traces, square_traces_plain, square_inputs,
             ('jout', 'lout'), square_bound_ms,
             'deepqmc_tpu_torch/csrc/fl_slogdet.cu',
             'deepqmc_tpu/ops/fl_slogdet.py:133'),
            ('fl_slogdet_square_split', square_split_traces, square_split_traces_plain,
             square_split_inputs, ('jout', 'lout'), square_bound_ms,
             'deepqmc_tpu_torch/csrc/fl_slogdet.cu',
             'deepqmc_tpu/ops/fl_slogdet.py:236'),
            ('fl_block', psiformer_block_fl, psiformer_block_fl_plain, block_inputs,
             ('y', 'J_y', 'L_y'), block_bound_ms,
             'deepqmc_tpu_torch/csrc/fl_block.cu',
             'deepqmc_tpu/ops/fl_block.py:403'),
        ]
        for name, kernel, plain, inputs, outs, bound, source, replaces in cases:
            worst = 0.0
            # the run path's 4096 walkers too; the main path's 2048 last, as
            # its inputs are the ones timed below
            for B in (256, 4096, 2048):
                args = inputs(gen, B)
                got = kernel(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                if name.startswith('fl_slogdet'):
                    print(f'{name} B={B}: {body_of(kernel)}', flush=True)
                for label, o, r in zip(outs, got, ref):
                    err, rel = max_errors(o, r)
                    ok = rel <= KERNEL_RTOL and math.isfinite(err)
                    print(f'{name} B={B} {label}: max abs err {err:.3e}, rel {rel:.3e} '
                          f'(tol {KERNEL_RTOL:.0e}) {"ok" if ok else "FAIL"}', flush=True)
                    if not ok:
                        raise SystemExit(f'{name} disagrees with its plain version on {label}')
                    worst = max(worst, err)
                if B == 256 and name in DETERMINISTIC:  # no atomics: the same bits every launch
                    again = kernel(*args)
                    same = all(torch.equal(a, o) for a, o in zip(again, got))
                    print(f'{name} B={B}: two launches bitwise equal: {same}', flush=True)
                    if not same:
                        raise SystemExit(f'{name} is not deterministic')
                    del again
            ms = cuda_median_ms(lambda: kernel(*args))
            plain_ms = cuda_median_ms(lambda: plain(*args))
            bound_ms, nbytes, flops = bound(2048)
            bound_by = 'bytes' if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else 'operations'
            print(f'{name} B=2048: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
                  f'{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e9:.3f} GB, '
                  f'{flops / 1e9:.2f} GFLOP)', flush=True)
            kernels.append(dict(
                name=name, route='cuda', source=source, replaces=replaces, launches=0,
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
            ))
            if name == 'fl_block':  # the same layer through the per-op rules (kernel 1)
                # computed from the counts, not measured: kept out of the kernels record
                tc_floor_ms = 1e3 * 3 * flops / TF32_FLOPS_PER_S
                weight_gb = weight_bytes(2048, 30, 10, 256, 4) / 1e9
                print(f'{name} B=2048 (computed, not measured): split-TF32 tensor-core floor '
                      f'{tc_floor_ms:.4f} ms (3 x {flops / 1e9:.2f} GFLOP at '
                      f'{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s) beside the float32 bound '
                      f'{bound_ms:.4f} ms; weight bytes from L2 per launch by the kernel\'s '
                      f'staging plan {weight_gb:.2f} GB', flush=True)
                layer = block_layer()
                h = fwdlap.FL(*args[:3])
                with torch.inference_mode():
                    per_op_ms = cuda_median_ms(lambda: layer(h))
                kernels[-1]['per_op_ms'] = per_op_ms
                print(f'{name} B=2048: per-op path of the same layer {per_op_ms:.4f} ms',
                      flush=True)
                del layer, h
            del args, got, ref
            torch.cuda.empty_cache()
        # other shapes than the main path's: odd n, several rounds of directions
        # and of output tiles per block (paths H2O does not take); the slogdet
        # kernels at n = 5 split 3/2 (JAX's split), n = 2 with no down rows
        # (triplet H2), n = 42 (benzene) and n = 64 (their largest instance)
        slogdet_kernels = (
            ('fl_slogdet_traces', slogdet_traces, slogdet_traces_plain, slogdet_inputs),
            ('fl_slogdet_square', square_traces, square_traces_plain, square_inputs),
            ('fl_slogdet_square_split', square_split_traces, square_split_traces_plain,
             square_split_inputs),
        )
        slogdet_shapes = (
            (5, dict(K=21, D=3, nu=4, nd=3)),
            (5, dict(K=48, D=4, nu=8, nd=8)),
            (5, dict(K=15, D=3, nu=3, nd=2)),
            (5, dict(K=6, D=4, nu=2, nd=0)),
            (256, dict(K=126, D=16, nu=21, nd=21)),
            (64, dict(K=192, D=4, nu=32, nd=32)),
            # the zoo path's own launches: FermiNet's per-spin determinants
            # (n = 5 split 3/2) at its evaluation walkers, the default run's
            # walkers (its full determinants)
            (ZOO_EVAL_WALKERS, dict(K=30, D=16, nu=3, nd=2)),
            (ZOO_RUNS['default'][1], dict(K=30, D=16, nu=5, nd=5)),
            # the deeperwin path's: 32 full determinants of H2O at its walkers
            (DW_WALKERS, dict(K=30, D=32, nu=5, nd=5)),
        )
        for B, kw in slogdet_shapes:
            for name, kernel, plain, make in slogdet_kernels:
                args = make(gen, B, **kw)
                got = kernel(*args)
                print(f'{name} B={B} {kw}: {body_of(kernel)}', flush=True)
                for o, r in zip(got, plain(*args)):
                    err, rel = max_errors(o, r)
                    print(f'{name} B={B} {kw}: max abs err {err:.3e}, rel {rel:.3e}', flush=True)
                    if not rel <= KERNEL_RTOL:
                        raise SystemExit(f'{name} disagrees with its plain version at B={B} {kw}')
                if not all(torch.equal(a, o) for a, o in zip(kernel(*args), got)):
                    raise SystemExit(f'{name} is not deterministic at B={B} {kw}')
                del got
                if B > 5:
                    ms = cuda_median_ms(lambda: kernel(*args), runs=5, warmup=1)
                    plain_ms = cuda_median_ms(lambda: plain(*args), runs=5, warmup=1)
                    bound_ms, nbytes, flops = slogdet_bound_ms(
                        B, kw['K'], kw['D'], kw['nu'] + kw['nd'],
                        with_l=name != 'fl_slogdet_traces')
                    print(f'{name} B={B} {kw}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
                          f'bound {bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB, '
                          f'{flops / 1e9:.2f} GFLOP)', flush=True)
                del args
                torch.cuda.empty_cache()
        # the attention kernel beyond H2O's 10 tokens: benzene's 42 and its
        # largest instance, 64, at the preset's 4 heads of 64; the transferable
        # components' 3 nuclei and 10 electrons, 2 heads of 8, at their walkers
        for B, kw in ((64, dict(K=126, n=42)), (32, dict(K=192, n=64)),
                      (DW_WALKERS, dict(K=30, n=13, H=2, dh=8))):
            args = attention_inputs(gen, B, **kw)
            for label, o, r in zip(('t', 'J_t', 'L_t'), mha_core_fl(*args), mha_core_fl_plain(*args)):
                err, rel = max_errors(o, r)
                print(f'fl_attention B={B} {kw} {label}: max abs err {err:.3e}, rel {rel:.3e}',
                      flush=True)
                if not rel <= KERNEL_RTOL:
                    raise SystemExit(f'fl_attention disagrees with its plain version at B={B} {kw}')
            ms = cuda_median_ms(lambda: mha_core_fl(*args), runs=5, warmup=1)
            plain_ms = cuda_median_ms(lambda: mha_core_fl_plain(*args), runs=5, warmup=1)
            bound_ms, nbytes, flops = attention_bound_ms(B, **kw)
            print(f'fl_attention B={B} {kw}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
                  f'attention_bound_ms {bound_ms:.4f} ({nbytes / 1e9:.3f} GB, '
                  f'{flops / 1e9:.2f} GFLOP)', flush=True)
            del args
            torch.cuda.empty_cache()
        for name, kernel, plain, make, kw in (
            ('fl_attention', mha_core_fl, mha_core_fl_plain, attention_inputs,
             dict(K=21, n=7, H=2, dh=12)),
            ('fl_attention', mha_core_fl, mha_core_fl_plain, attention_inputs,
             dict(K=48, n=16, H=2, dh=64)),
            # one token (no softmax to speak of), two, and an odd count past 32
            ('fl_attention', mha_core_fl, mha_core_fl_plain, attention_inputs,
             dict(K=5, n=1, H=1, dh=4)),
            ('fl_attention', mha_core_fl, mha_core_fl_plain, attention_inputs,
             dict(K=4, n=2, H=2, dh=8)),
            ('fl_attention', mha_core_fl, mha_core_fl_plain, attention_inputs,
             dict(K=9, n=33, H=2, dh=16)),
            # odd n with K not a multiple of the 4-direction chunk; a width that is
            # not a multiple of 8 (one head); the small test width; n = 32 with a
            # 2-direction chunk
            ('fl_block', psiformer_block_fl, psiformer_block_fl_plain, block_inputs,
             dict(K=21, n=7, d=64, H=2)),
            ('fl_block', psiformer_block_fl, psiformer_block_fl_plain, block_inputs,
             dict(K=5, n=3, d=12, H=1)),
            ('fl_block', psiformer_block_fl, psiformer_block_fl_plain, block_inputs,
             dict(K=30, n=10, d=32, H=2)),
            ('fl_block', psiformer_block_fl, psiformer_block_fl_plain, block_inputs,
             dict(K=2, n=32, d=64, H=4)),
        ):
            args = make(gen, 5, **kw)
            for o, r in zip(kernel(*args), plain(*args)):
                err, rel = max_errors(o, r)
                print(f'{name} {kw}: max abs err {err:.3e}, rel {rel:.3e}', flush=True)
                if not rel <= KERNEL_RTOL:
                    raise SystemExit(f'{name} disagrees with its plain version at {kw}')
        counters = {'fl_attention': mha_core_fl, 'fl_slogdet_traces': slogdet_traces,
                    'fl_slogdet_square': square_traces,
                    'fl_slogdet_square_split': square_split_traces,
                    'fl_block': psiformer_block_fl}
        print('launches in this phase (checks and timing): '
              + ', '.join(f'{k} {c.launches}' for k, c in counters.items()), flush=True)
        torch.cuda.empty_cache()

    by_name = {k['name']: k for k in kernels}

    def counts():
        return {name: c.launches for name, c in counters.items()}

    def zero_counts():
        for c in counters.values():
            c.launches = 0
            if hasattr(c, 'by_dtype'):  # kernels 1-4: launches by Jacobian dtype
                c.by_dtype.clear()

    def eval_run(wf):
        """3 evaluation steps of 2048 walkers from zeroed counts; (step times,
        last sampler state, launches during the run)."""
        zero_counts()
        step_s, last = [], None
        t0 = time.monotonic()
        for step, state, E_loc, stats in dq.evaluate(hamil, wf, n_walkers=2048, steps=3,
                                                    decorr=10, seed=0):
            torch.cuda.synchronize()
            step_s.append(time.monotonic() - t0)
            print(f'step {step}: E_loc mean {stats["local_energy/mean"].item():.6f} std '
                  f'{stats["local_energy/std"].item():.6f} acceptance '
                  f'{stats["sampling/acceptance"].item():.4f} ewm '
                  f'{stats["energy/ewm"].item():.6f} time {step_s[-1]:.3f} s', flush=True)
            if not torch.isfinite(E_loc).all() or E_loc.shape != (2048,):
                raise SystemExit(f'step {step}: E_loc not finite or of shape {tuple(E_loc.shape)}')
            last = molecule_state(state)[1]  # the one molecule's electron sampler state
            t0 = time.monotonic()
        return step_s, last, counts()

    def local_energy_ms(wf, last, label, step_s):
        with torch.inference_mode():
            pc = dq.PhysicalConfiguration(R, last['r'], torch.zeros(2048, dtype=torch.long,
                                                                    device='cuda'))
            eloc_ms = cuda_median_ms(lambda: hamil.local_energy(wf, pc), runs=3, warmup=1)
        print(f'{label}: median step time {sorted(step_s)[1]:.3f} s; local energy alone '
              f'(2048 walkers) {eloc_ms:.1f} ms; the rest of a step (10 Metropolis moves, '
              f'statistics, EWM) {1e3 * sorted(step_s)[1] - eloc_ms:.1f} ms', flush=True)
        return pc

    with Phase('main_path'):
        hamil = dq.MolecularHamiltonian(mol=dq.Molecule.from_name('H2O'))
        R = torch.as_tensor(hamil.mol.coords, dtype=torch.float32, device='cuda')
        wf = dq.psiformer_ansatz(hamil, seed=0)  # full width: the preset's defaults
        torch.cuda.reset_peak_memory_stats()
        step_s, last, launches = eval_run(wf)
        print(f'launches during the main path: {launches}', flush=True)
        for name in ('fl_attention', 'fl_slogdet_traces'):
            by_name[name]['launches'] = launches[name]
            if launches[name] == 0:
                raise SystemExit(f'{name} was never launched on the main path')
        if launches['fl_block']:
            raise SystemExit('the per-op main path launched the block kernel')
        main_last = last
        print(f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
        pc = local_energy_ms(wf, last, 'per-op path', step_s)
        zero_counts()
        with torch.inference_mode():
            hamil.local_energy(wf, pc)
        one = counts()
        print(f'launches in one local energy on the per-op path: {one}', flush=True)
        if one['fl_attention'] != 4 or one['fl_slogdet_traces'] != 1 or one['fl_block']:
            raise SystemExit('one local energy on the per-op path is not 4 attention launches '
                             'and 1 flat slogdet launch')

        weights = {k: v.cpu() for k, v in wf.state_dict().items()}
        plain_wfs = {}
        for name, dtype in (('plain_f64', torch.float64), ('plain_f32', torch.float32)):
            plain_wfs[name] = dq.psiformer_ansatz(hamil, seed=0).to(dtype)
            plain_wfs[name].load_state_dict({k: v.to(dtype) for k, v in weights.items()})
        rel, _, _ = eloc_rel_errors(hamil, wf, last['r'][:64], R, plain_wfs)
        tol = ELOC_FACTOR * rel['plain_f32'] + ELOC_FLOOR
        print(f'E_loc on 64 walkers against the plain path in f64 (CPU): kernel path '
              f'(f32, card) max rel err {rel["card"]:.3e}; plain path (f32, CPU) max rel '
              f'err {rel["plain_f32"]:.3e}; tol {tol:.3e}', flush=True)
        if not rel['card'] <= tol:
            raise SystemExit('kernel-path local energy disagrees with the plain path')

    with Phase('block_path'):
        wf_block = dq.psiformer_ansatz(hamil, seed=0, block_kernel=True).cuda()
        wf_block.load_state_dict(wf.state_dict())
        torch.cuda.reset_peak_memory_stats()
        step_s, last, launches = eval_run(wf_block)
        print(f'launches during the block path: {launches}', flush=True)
        by_name['fl_block']['launches'] = launches['fl_block']
        if launches['fl_block'] != 4 * 3 or launches['fl_attention']:
            raise SystemExit('the block path did not run 4 fused layers (and no attention '
                             'kernel) per local energy')
        print(f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
        pc = local_energy_ms(wf_block, last, 'block path', step_s)
        zero_counts()
        with torch.inference_mode():
            hamil.local_energy(wf_block, pc)
        one = counts()
        print(f'launches in one local energy on the block path: {one}', flush=True)
        if one['fl_block'] != 4 or one['fl_attention'] != 0 or one['fl_slogdet_traces'] != 1:
            raise SystemExit('one local energy on the block path is not 4 block launches '
                             'and 1 flat slogdet launch')

        r64 = last['r'][:64]
        rel, e_block, scale = eloc_rel_errors(hamil, wf_block, r64, R, plain_wfs)
        tol = ELOC_FACTOR * rel['plain_f32'] + ELOC_FLOOR
        print(f'E_loc on 64 walkers against the plain path in f64 (CPU): block path '
              f'(f32, card) max rel err {rel["card"]:.3e}; plain path (f32, CPU) max rel '
              f'err {rel["plain_f32"]:.3e}; tol {tol:.3e}', flush=True)
        if not rel['card'] <= tol:
            raise SystemExit('block-path local energy disagrees with the plain path')
        with torch.inference_mode():
            e_per_op, _ = hamil.local_energy(wf, dq.PhysicalConfiguration(
                R, r64, torch.zeros(64, dtype=torch.long, device='cuda')))
        diff = ((e_block - e_per_op).abs().double().cpu() / scale).max().item()
        print(f'E_loc on the same 64 walkers, block path against per-op path (both f32, '
              f'card): max rel diff {diff:.3e}; tol {BLOCK_VS_PER_OP_FACTOR * tol:.3e}',
              flush=True)
        if not diff <= BLOCK_VS_PER_OP_FACTOR * tol:
            raise SystemExit('block-path local energy disagrees with the per-op path')

        # above 32 electrons the block path runs the layer's per-op rules
        # (fl_block.takes): one attention launch, no block launch
        h = fwdlap.FL(*block_inputs(gen, 64, K=126, n=42)[:3])
        fused, per_op = block_layer(block_kernel=True), block_layer()
        with torch.inference_mode():
            zero_counts()
            y = fused(h)
            torch.cuda.synchronize()
            launches = counts()
            want = dict.fromkeys(counters, 0) | {'fl_attention': 1}
            print(f'block layer (block_kernel=True) at n = 42, B = 64, K = 126: launches '
                  f'{launches}', flush=True)
            if launches != want:
                raise SystemExit(f'the block layer at n = 42 launched {launches}, want {want}')
            y_ref = per_op(h)
            for label, o, r in zip(('y', 'J_y', 'L_y'), (y.x, y.jac, y.lap),
                                   (y_ref.x, y_ref.jac, y_ref.lap)):
                err, rel = max_errors(o, r)
                ok = rel <= BLOCK_VS_PER_OP_FACTOR * KERNEL_RTOL
                print(f'block layer at n = 42 against the per-op layer, {label}: max abs err '
                      f'{err:.3e}, rel {rel:.3e} (tol {BLOCK_VS_PER_OP_FACTOR * KERNEL_RTOL:.0e}) '
                      f'{"ok" if ok else "FAIL"}', flush=True)
                if not ok:
                    raise SystemExit(f'the block layer at n = 42 disagrees on {label}')
            try:
                psiformer_block_fl(h.x, h.jac, h.lap, *fused.block_weights(), 4)
            except ValueError as e:
                print(f'psiformer_block_fl at n = 42 on the card raises: {e}', flush=True)
            else:
                raise SystemExit('psiformer_block_fl took n = 42 on the card')
        del h, y, y_ref, fused, per_op
        torch.cuda.empty_cache()

    with Phase('square_path'):
        D = wf.n_det
        with torch.inference_mode():
            pc = dq.PhysicalConfiguration(R, fwdlap.FL.seed(main_last['r']),
                                          torch.zeros(2048, dtype=torch.long, device='cuda'))
            up, down = wf._spin_orbitals(pc)  # flat [B, n_spin, D*n], J [B, K, n_spin, D*n]

            def square(v):  # flat -> square row blocks [B, D, n_spin, n], J [B, K, D, n_spin, n]
                return fwdlap.FL(*(unflatten_dets(t, D) for t in (v.x, v.jac, v.lap)))

            sq_up, sq_down = square(up), square(down)
            torch.cuda.synchronize()
            zero_counts()
            paths = {
                'flat rows (fl_slogdet_traces)': fwdlap.slogdet_flat_rows(up, down, D),
                'flat whole (fl_slogdet_traces)': fwdlap.slogdet_flat(
                    fwdlap.cat([up, down], -2), D),
                'square rows (fl_slogdet_square_split)': fwdlap.slogdet_rows(sq_up, sq_down),
                'square whole (fl_slogdet_square)': fwdlap.slogdet(
                    fwdlap.cat([sq_up, sq_down], -2)),
            }
            torch.cuda.synchronize()
            launches = counts()
            print(f'launches during the square path: {launches}', flush=True)
            want = {'fl_attention': 0, 'fl_slogdet_traces': 2, 'fl_slogdet_square': 1,
                    'fl_slogdet_square_split': 1, 'fl_block': 0}
            if launches != want:
                raise SystemExit(f'the square path launched {launches}, want {want}')
            for name in ('fl_slogdet_square', 'fl_slogdet_square_split'):
                by_name[name]['launches'] = launches[name]

            a, ja, la = (torch.cat(t, -2) for t in ((sq_up.x, sq_down.x),
                                                     (sq_up.jac, sq_down.jac),
                                                     (sq_up.lap, sq_down.lap)))

            def plain(dtype):
                a_, ja_, la_ = (t.to(dtype) for t in (a, ja, la))
                sign, logdet = torch.linalg.slogdet(a_)
                return (sign, logdet, *square_traces_plain(torch.linalg.inv(a_), ja_, la_))

            ref64, ref32 = plain(torch.float64), plain(torch.float32)
            del a, ja, la

        def rel_err(x, ref):  # per determinant, relative to max(1, |ref|)
            ref = ref.double()
            return ((x.double() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()

        labels = ('log|det|', 'J', 'L')
        tol = [ELOC_FACTOR * rel_err(r32, r64) + ELOC_FLOOR
               for r32, r64 in zip(ref32[1:], ref64[1:])]
        print('square path, plain version (f32, card) against f64: '
              + ', '.join(f'{lb} {rel_err(r32, r64):.3e}'
                          for lb, r32, r64 in zip(labels, ref32[1:], ref64[1:]))
              + '; tol ' + ', '.join(f'{lb} {t:.3e}' for lb, t in zip(labels, tol)), flush=True)
        first = None
        for name, (sign, out) in paths.items():
            got = (out.x, out.jac, out.lap)
            errs = [rel_err(g, r) for g, r in zip(got, ref64[1:])]
            to_plain = [rel_err(g, r) for g, r in zip(got, ref32[1:])]
            to_first = [rel_err(g, r) for g, r in zip(got, first or got)]
            first = first or got
            print(f'square path, {name}: against f64 '
                  + ', '.join(f'{lb} {e:.3e}' for lb, e in zip(labels, errs))
                  + '; against the plain f32 version '
                  + ', '.join(f'{lb} {e:.3e}' for lb, e in zip(labels, to_plain))
                  + '; against the first dispatch '
                  + ', '.join(f'{lb} {e:.3e}' for lb, e in zip(labels, to_first)), flush=True)
            if not torch.equal(sign, ref32[0]):
                raise SystemExit(f'square path: {name} disagrees on signs')
            for lb, e, p, f, t in zip(labels, errs, to_plain, to_first, tol):
                if not (e <= t and p <= BLOCK_VS_PER_OP_FACTOR * t
                        and f <= BLOCK_VS_PER_OP_FACTOR * t):
                    raise SystemExit(f'square path: {name} disagrees on {lb}')

    with Phase('train_path'):
        from deepqmc_tpu_torch.fit import DEFAULT_OPT_KWARGS
        from deepqmc_tpu_torch.kfac import KFAC
        from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask
        from deepqmc_tpu_torch.sampling import DecorrSampler, MetropolisSampler

        per_op_step = dict.fromkeys(counters, 0) | {'fl_attention': 4, 'fl_slogdet_traces': 1}
        block_step = dict.fromkeys(counters, 0) | {'fl_block': 4, 'fl_slogdet_traces': 1}

        def run_training(wf, steps, want):
            """``steps`` KFAC steps of 2048 walkers from zeroed counts, each checked;
            (step times, last train state)."""
            zero_counts()
            step_s, before, seen = [], flat_params(wf), counts()
            t0 = time.monotonic()
            for step, state, E_loc, stats in dq.fit.train(hamil, wf, n_walkers=2048, steps=steps,
                                                      decorr=10, seed=0, optimizer='kfac'):
                torch.cuda.synchronize()
                step_s.append(time.monotonic() - t0)
                now, after = counts(), flat_params(wf)
                launches = {k: now[k] - seen[k] for k in now}
                loss = stats['local_energy/mean'].item()  # unit weights: the loss
                print(f'train step {step}: loss {loss:.6f} E_loc std '
                      f'{stats["local_energy/std"].item():.6f} acceptance '
                      f'{stats["sampling/acceptance"].item():.4f} lr {stats["opt/lr"].item():.3e} '
                      f'norm scale {stats["opt/norm_scale"].item():.4f} update norm '
                      f'{stats["opt/update_norm"].item():.3e} time {step_s[-1]:.3f} s; '
                      f'launches {launches}', flush=True)
                if not (math.isfinite(loss) and torch.isfinite(E_loc).all()
                        and E_loc.shape == (2048,)
                        and all(torch.isfinite(v).all() for v in stats.values())):
                    raise SystemExit(f'train step {step}: loss, E_loc or stats not finite, or '
                                     f'E_loc of shape {tuple(E_loc.shape)}')
                if torch.equal(after, before):
                    raise SystemExit(f'train step {step} left the parameters unchanged')
                if launches != want:
                    raise SystemExit(f'train step {step} launched {launches}, want {want}')
                seen, before = now, after
                t0 = time.monotonic()
            return step_s, state

        wf_train = dq.psiformer_ansatz(hamil, seed=0).cuda()
        torch.cuda.reset_peak_memory_stats()
        step_s, state = run_training(wf_train, 6, per_op_step)
        train_ms = 1e3 * sorted(step_s[1:])[2]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        print(f'{smi} | training step (per-op path, KFAC, 2048 walkers): median of steps 1-5 '
              f'{train_ms:.1f} ms (steps {", ".join(f"{1e3 * t:.1f}" for t in step_s)} ms; '
              f'inverses refreshed at steps 0 and 5)', flush=True)
        print(f'{smi} | training peak device memory {peak_gib:.2f} GiB', flush=True)

        # the step split by CUDA events: the calls train_step makes, one by one
        # (KFAC.step is loss.value_grad_and_taps, i.e. terms + grad_and_taps, then update)
        sampler = DecorrSampler(length=10).wrap(MetropolisSampler(hamil, wf_train))
        loss = create_loss_fn(hamil, wf_train, median_log_squeeze_and_mask)
        kfac = KFAC(loss, **DEFAULT_OPT_KWARGS['kfac'])
        smpl_state, opt_state = molecule_state(state.sampler)[1], state.opt
        kfac.init(sampler.phys_conf(R, smpl_state['r']))
        split_gen = torch.Generator('cuda').manual_seed(7)
        weight = torch.ones(2048, device='cuda')
        stages = ('sampling', 'local energy', 'gradient and taps', 'KFAC update', 'psi refresh')
        splits = []
        for _ in range(5):  # steps 6-10 of the run: inverses carried, then refreshed at 10
            refresh = opt_state['step'] % kfac.inverse_update_period == 0
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
            t0 = time.monotonic()
            ev[0].record()
            with torch.no_grad():
                smpl_state, pc, _ = sampler.sample(split_gen, smpl_state, R)
            ev[1].record()
            terms = loss.terms(pc, weight)
            ev[2].record()
            grads, sums = loss.grad_and_taps(pc, weight, terms, taps=True)
            ev[3].record()
            opt_state, _ = kfac.update(opt_state, grads, sums, 2048)
            ev[4].record()
            with torch.no_grad():
                smpl_state = sampler.update(smpl_state, R)
            ev[5].record()
            ev[5].synchronize()
            host_ms = 1e3 * (time.monotonic() - t0)
            ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
            splits.append((refresh, ms, host_ms))
            print(f'split step {opt_state["step"] - 1} (inverses '
                  f'{"refreshed" if refresh else "carried"}): '
                  + ', '.join(f'{n} {t:.2f} ms' for n, t in zip(stages, ms))
                  + f'; sum {sum(ms):.2f} ms, host {host_ms:.2f} ms', flush=True)
            del grads, sums
        carried = [ms for refresh, ms, _ in splits if not refresh]
        medians = [sorted(col)[len(col) // 2] for col in zip(*carried)]
        refresh_kfac = [ms[3] for refresh, ms, _ in splits if refresh]
        print(f'{smi} | training step split by CUDA events (median of the {len(carried)} '
              'steps with carried inverses): '
              + ', '.join(f'{n} {t:.2f} ms' for n, t in zip(stages, medians))
              + f'; sum {sum(medians):.2f} ms; KFAC update on a refresh step '
              + ', '.join(f'{t:.2f}' for t in refresh_kfac) + ' ms', flush=True)
        del loss, kfac, sampler

        # gradient and KFAC update on 64 walkers: card (f32, kernels) against the
        # CPU plain path in f64, the bar set by the CPU plain path in f32
        r64 = smpl_state['r'][:64]
        weights = {k: v.cpu() for k, v in wf_train.state_dict().items()}

        def replica(dtype, device, block_kernel=False):
            wf_r = dq.psiformer_ansatz(hamil, seed=0, block_kernel=block_kernel).to(
                device=device, dtype=dtype)
            wf_r.load_state_dict({k: v.to(dtype) for k, v in weights.items()})
            pc_r = dq.PhysicalConfiguration(R.to(device, dtype), r64.to(device, dtype),
                                            torch.zeros(64, dtype=torch.long, device=device))
            return wf_r, create_loss_fn(hamil, wf_r, median_log_squeeze_and_mask), pc_r

        paths = {'card': (torch.float32, 'cuda'), 'plain_f64': (torch.float64, 'cpu'),
                 'plain_f32': (torch.float32, 'cpu')}
        grads, deltas = {}, {}
        for name, (dtype, device) in [*paths.items(), ('card_block', (torch.float32, 'cuda'))]:
            wf_r, loss_r, pc_r = replica(dtype, device, block_kernel=name == 'card_block')
            ones = torch.ones(64, dtype=dtype, device=device)
            _, g = loss_r.value_and_grad(pc_r, ones)
            grads[name] = torch.cat([t.flatten() for t in g.values()])
            if name == 'card_block':
                continue
            for label, step in (('carried', None), ('refreshed', 10)):
                wf_r.load_state_dict({k: v.to(dtype) for k, v in weights.items()})
                kfac_r = KFAC(loss_r, **DEFAULT_OPT_KWARGS['kfac'])
                kfac_r.init(pc_r)
                before = flat_params(wf_r)
                kfac_r.step(kfac_state_to(opt_state, dtype, device, step), pc_r, ones)
                deltas[name, label] = flat_params(wf_r) - before
        checks = [('gradient', grads),
                  ('gradient (block path)', grads | {'card': grads['card_block']})] + [
            (f'KFAC update ({label} inverses)', {n: deltas[n, label] for n in paths})
            for label in ('carried', 'refreshed')
        ]
        for what, vals in checks:
            rel = {n: rel_l2(vals[n], vals['plain_f64']) for n in ('card', 'plain_f32')}
            tol = ELOC_FACTOR * rel['plain_f32'] + ELOC_FLOOR
            ok = rel['card'] <= tol
            print(f'{what} on 64 walkers against the plain path in f64 (CPU), global L2: card '
                  f'(f32, kernels) rel err {rel["card"]:.3e}; plain path (f32, CPU) rel err '
                  f'{rel["plain_f32"]:.3e}; tol {tol:.3e} {"ok" if ok else "FAIL"}', flush=True)
            if not ok:
                raise SystemExit(f'the {what} on the card disagrees with the plain path')

        wf_block_train = dq.psiformer_ansatz(hamil, seed=0, block_kernel=True).cuda()
        block_s, _ = run_training(wf_block_train, 2, block_step)
        print(f'{smi} | training step (block path, KFAC, 2048 walkers): steps '
              f'{", ".join(f"{1e3 * t:.1f}" for t in block_s)} ms', flush=True)
        del wf_train, wf_block_train
        torch.cuda.empty_cache()

    with Phase('sampling_path'):
        sampling_path(dq, hamil, R, smi, counts, zero_counts, per_op_step)

    with Phase('run_path'):
        run_launches = run_path(dq, hamil, smi, counts, zero_counts, per_op_step)
        for name, n in run_launches.items():
            by_name[name]['run_launches'] = n

    with Phase('zoo_path'):
        zoo_launches = zoo_path(dq, hamil, R, smi, counts, zero_counts)
        print(f'launches during the zoo path: {zoo_launches}', flush=True)
        if zoo_launches['fl_slogdet_traces'] == 0 or any(
                n for k, n in zoo_launches.items() if k != 'fl_slogdet_traces'):
            raise SystemExit('the zoo path did not run on kernel 2 alone')
        for name, n in zoo_launches.items():
            by_name[name]['zoo_launches'] = n

    with Phase('excited_path'):
        excited_launches = excited_path(dq, hamil, R, smi, counts, zero_counts, per_op_step)
        print(f'launches during the excited path: {excited_launches}', flush=True)
        for name, n in excited_launches.items():
            by_name[name]['excited_launches'] = n

    with Phase('cli_path'):
        cli_launches, cli_train_dir = cli_path(smi, per_op_step)
        print(f'launches during the cli path (read from its logs): {cli_launches}', flush=True)
        for name, n in cli_launches.items():
            by_name[name]['cli_launches'] = n

    with Phase('force_path'):
        force_launches = force_path(dq, hamil, smi, counts, zero_counts, per_op_step,
                                    cli_train_dir)
        shutil.rmtree(os.path.dirname(cli_train_dir))
        print(f'launches during the force path: {force_launches}', flush=True)
        for name, n in force_launches.items():
            by_name[name]['force_launches'] = n

    with Phase('ecp_path'):
        ecp_launches = ecp_path(dq, smi, counts, zero_counts, per_op_step)
        print(f'launches during the ecp path\'s cut run: {ecp_launches}', flush=True)
        for name, n in ecp_launches.items():
            by_name[name]['ecp_launches'] = n

    with Phase('benzene_path'):
        benzene_launches = benzene_path(dq, smi, counts, zero_counts)
        print(f'launches during the benzene path: {benzene_launches}', flush=True)
        for name, n in benzene_launches.items():
            by_name[name]['benzene_launches'] = n

    with Phase('deeperwin_path'):
        dw_launches = deeperwin_path(dq, hamil, R, smi, counts, zero_counts)
        print(f'launches during the deeperwin path: {dw_launches}', flush=True)
        if dw_launches['fl_slogdet_traces'] == 0:
            raise SystemExit('the deeperwin path never launched kernel 2')
        for name, n in dw_launches.items():
            by_name[name]['deeperwin_launches'] = n

    with Phase('mol_batch_path'):
        mb_launches, mb_walkers, mb_bars = mol_batch_path(dq, hamil, smi, counts, zero_counts,
                                                          per_op_step)
        print(f'launches during the mol batch path: {mb_launches}', flush=True)
        for name, n in mb_launches.items():
            by_name[name]['mol_batch_launches'] = n

    with Phase('dp_path'):
        dp_launches = dp_path(dq, hamil, smi, counts, zero_counts, mb_walkers, mb_bars)
        print(f'launches of rank 0 during the dp path: {dp_launches}', flush=True)
        for name in by_name:
            by_name[name]['dp_launches'] = dp_launches.get(name, 0)

    with Phase('precision_path'):
        kernels.extend(precision_path(dq, hamil, R, main_last['r'], smi, counters, zero_counts))

    with Phase('trace_path'):
        trace_launches = trace_path(dq, smi, per_op_step)
        print(f'launches during the trace path: {trace_launches}', flush=True)

    print(json.dumps({'kernels': kernels}), flush=True)
    print(f'{smi} | whole run {time.monotonic() - _T0:.1f} s', flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--dp-rank']:  # one rank of the dp path, started by main
        sys.exit(dp_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])))
    sys.exit(main())
