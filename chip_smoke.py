#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Drives the port's main paths — the paper's Table-1 loop: typed trace ->
fused flat log-joint -> static HMC with 4 leapfrog steps over 4 chains —
for all eight Table-1 models at full width: ``logreg`` (10,000 x 100),
``naive_bayes`` (1,000 x 40, 10 classes), ``hier_poisson`` (50 obs, 10
groups), ``hmm_semisup`` (K=5, V=20, T=300), ``lda`` (V=100, K=5, 10 docs,
10,176 words), ``gauss_unknown`` (10,000 obs; also on the per-site
evaluator with the per-array switch on) and ``sto_volatility`` (T = 500)
through the hand-written CUDA kernels of
``src/repro_torch/kernels/fused_logpdf/csrc``, ``gaussian_10k`` (10,000-D)
through the separable-potential compiler and the fused n-step leapfrog of
``src/repro_torch/kernels/fused_leapfrog/csrc``; and two synthetic models
of the JAX package that reach the other density families: ``family_mix_8k``
(8,192-D, seven families: the fused leapfrog with a mixed opcode table,
then the autodiff integrator) and ``mixed`` (a dense 5-D MvNormal among
four other families); and ``eight_schools``, which with gauss_unknown
runs the conditionally separable spec (plain torch: its head replays the
model), with the static analysis over the whole suite. Then the LM
substrate, through the entry points a user calls
(``launch.serve.serve_batch``, ``models.bayes_lm``), with random weights
from a seed and ``attn_impl="flash"``: serving ``smollm-360m`` at full
width and depth and ``gemma2-27b`` at full width with its depth cut to
one (local, global) block, through the hand-written
flash-attention kernels (``flash_fwd_tc``, the bf16 prefill on the tensor
cores; ``flash_decode``, every decode step; ``flash_fwd_tf32``, the
prefill of the float32 serving run on the tensor cores in 3xTF32);
scoring 4 x 2,048 tokens under the Bayesian ``mamba2-1.3b`` at full width
and depth, through ``ssd_scan_tc`` (bf16 on the tensor cores;
``ssd_scan_tf32``, 3xTF32, on the float32 gate) and
``categorical_logits_sum``; and serving ``mamba2-1.3b`` briefly (its
prefill runs the plain scan, its decode the O(1) update, as in the JAX
package: no kernel of this slice). Draws per model are in ``DRAWS``.
Phases, in order:

1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. builds the five kernel sources with ``nvcc``, in parallel, and prints
   each build time, and (compiled beside them) ``nvcc -Xptxas -v``'s
   registers, shared memory and spills of this slice's kernels;
3. holds each kernel against its plain PyTorch version on the card and
   checks that two runs are bit-identical: the fused_logpdf sums at rtol
   1e-6 (ragged sizes, 1/4/16 rows, a stride-0 ``y``, logits one float
   past a 16-byte boundary; categorical over C = 1 to 4,097 classes and
   1 to 100,000 items with labels shared and per row, one launch a call,
   and at its edges: labels outside [0, C), -inf logits, and at C = 257,
   1,000 and 50,280 also a row of -inf, +inf and NaN logits;
   gamma, beta and normal, whose terms change sign, at 1e-6 of the sum of
   their magnitudes, with parameters per row, shared by the rows (row
   stride 0), one per row (element stride 0) and as views one float past
   a 16-byte boundary; the one-launch reductions (std_normal_sum,
   gamma_unnorm_sum, beta_unnorm_sum, student_t_unnorm_sum, normal_sum,
   bernoulli_logit_sum) where a row takes several blocks, with 16- and
   4-byte loads (normal's, beta's, student_t's parameters and bernoulli's
   y shared and one a row; normal's data
   also shared, as on the switch route): 1,000 back-to-back calls
   bit-identical with the last-block counts read back at 0, and calls
   alternating between two streams equal to them; student_t at rtol 1e-6;
   the dense quadratic form at rtol 1e-5 over D = 1 to 1,024 and N = 1 to
   100,000 with the precision shared and per row) and their backward
   through ``vmap(grad)`` with one launch for the whole chain axis; the
   fused leapfrog and fused potential for every opcode alone, a mixed
   table and one whose opcodes change every 512 coordinates
   (family_mix_8k's layout), with and without an inverse mass, 1/4/16
   chains with distinct step sizes, dim 1 to 1,000,003 and 0/1/4/8 steps
   (q, p and gradient at rtol 1e-5 plus atol 1e-5 * max|plain|, the
   potential at 1e-5 * sum_i |v_i|; both one launch a call with the
   counts back at 0, the leapfrog's 0 steps returning the state, offset
   views giving the same bits; the potential's merge path at 4 x 10,000,
   4 x 8,192 and 1 x 1,000,003, q dense and at row stride 0: 1,000
   back-to-back calls bit-identical, calls alternating with the
   leapfrog's and between two streams giving the same bits); flash_attention's four kernels by max|kernel -
   plain| / max|plain| (2e-5 in float32, 3e-2 in bf16: tests/
   test_kernels.py's) over that file's cases in both types, each kernel
   at its edges (``FLASH_KERNEL_CASES``: decode at G 1 to 8, odd Sk and
   holes; the tensor-core prefill at hd 64 and 128, ragged, windowed and
   softcapped), rings with holes and fully masked rows (exact zeros)
   through each kernel and every call of the LM paths (``LM_FLASH``, the
   large ones on their first and last 128 query rows), each kernel
   reached (the FP32 flash_fwd, which no main path runs any more, also on
   every float32 prefill call by ``launch_kernel``), and the backward
   through the ``autograd.Function`` at 2e-5; the three SSD kernels the
   same way (2e-4 and 5e-2) over that file's cases, the tensor-core
   kernels' shapes (``SSD_TC_CASES``) and mamba2's 4 x 2,048 x 64 heads:
   the kernel ``plan`` picks, and on every call it sends to a tensor-core
   kernel the FP32 kernel as well, the mixer's strided views through both
   tensor-core kernels, chunk invariance at 1e-4, and the backward;
   categorical_logits_sum
   again at C = 49,152 and 50,280 over 8,192 items, one launch a call;
   all bit-identical on a rerun;
4. ``logreg``: ``run_chains(HMC(step_size=0.002, n_leapfrog=4),
   num_chains=4, num_samples=DRAWS["logreg"])`` with every launch count set
   to 0 just before and read just after; the counts must equal the
   autodiff integrator's evaluations plus the potential compiler's probe
   evaluations (5 for a model whose sites all have opcodes, 0 when a site
   has none) plus, on the switch route, the two eager evaluations of the
   discovery run and the compiler's recording replay; checks finite draws
   and logp, the mean acceptance, and the density at the final draws
   (linked back to the unconstrained space) on the fused and the per-site
   evaluators, against the hand-written twin where there is one and the
   chain's own logp (rtol 1e-5);
5. the same for ``naive_bayes`` (step 0.01);
6. ``gaussian_10k`` (step 0.1): the same call compiles a separable spec
   (uniform NORMAL opcode, dim 10,000) and runs one ``fused_leapfrog``
   launch per draw and one ``fused_potential_vg`` at chain init, besides
   the compiler's 5 probe evaluations; checks the posterior mean and
   variance of every coordinate against 0 and 1 within 5.5 Monte-Carlo
   standard errors from its ESS; then runs the same seed with
   ``leapfrog="reference"`` and holds the first 10 draws of both
   integrators together (atol 1e-4 on the draws, rtol 1e-5 on logp); then,
   as in phase 4, ``hier_poisson`` (step 0.02; std_normal_sum and
   gamma_unnorm_sum once per evaluation; no probes: its dependency graph
   puts a Poisson likelihood on its leaves),
   ``hmm_semisup`` (step 0.01; the small-C categorical_logits_sum twice
   per evaluation, C = 5 and 20; no probes: the compiler stops at the
   simplex sites) and ``lda`` (step 0.005; the small-C path once, 4 x
   10,176 x 100; no probes), and their simplex draws: non-negative, rows summing
   to 1 within 1e-5; ``gauss_unknown`` (step 0.01; the conditional spec,
   head s: std_normal_sum twice in each of the compiler's 5 probe
   evaluations and no launch a transition, the conditional integrator
   being plain torch; its posterior means of m and s against the
   conjugate posterior's within 5.5 Monte-Carlo standard errors), then the
   same model under the autodiff integrator on the per-site evaluator
   inside ``use_fused_logpdf()``
   (``normal_sum`` once per evaluation for all chains: shared data, one
   mu and sigma per chain); ``sto_volatility`` (step 0.01; std_normal_sum
   twice, no probes: its y mixes three leaf sites); ``family_mix_8k`` (step
   0.01: its mixed-opcode spec, whose opcodes, coefficients and const
   equal a float64 fold of the model's parameters, and one
   ``fused_leapfrog`` per draw; then
   ``leapfrog="reference"`` with std_normal_sum, gamma_unnorm_sum,
   beta_unnorm_sum and student_t_unnorm_sum once per evaluation, its first
   10 draws held to the fused run's at atol 1e-4 + rtol 1e-5); ``mixed``
   (step 0.1; mvn_quadform_sum, beta, student_t, gamma and std_normal once
   per evaluation, no probes); then the LM paths (``LM_SERVE``,
   ``LM_SCORE``): for each serving path with attention, in float32 on the
   same weights, the flash route against the dense route over the prefill
   and every decode step fed the same tokens, and prefill(S - 1) plus
   decode(1) against ``forward_train``'s last logits (both within 2e-3;
   for gemma2 the prompt passes the 4,096-slot ring, so this is the ring
   repair at real size; the float32 flash run is counted: flash_fwd_tf32
   once per attention layer in the prefill, flash_decode in each decode
   step);
   then the timed bf16 ``serve_batch`` with every count zeroed just before
   and read just after (flash_fwd_tc once per attention layer in the
   prefill, flash_decode once per layer in each decode step, nothing
   else),
   and the dense route's bf16 greedy tokens for agreement (reported, not
   gated); for the scoring path, in float32, the log-likelihood with
   ``ssd_scan_tf32`` (counted: once per layer) against the plain scan's (rtol
   1e-4) and logjoint = logprior + loglikelihood (rtol 1e-5); in bf16 the
   log-likelihood through ``ssd_scan_tc`` against the plain scan's on the
   same weights (``LM_SCORE_BF16_TOL``); then two timed bf16 evaluations,
   counted (ssd_scan_tc once per layer, categorical_logits_sum once, per
   evaluation);
6b. NUTS, the other samplers and Table 1, each run counted: NUTS on
   gaussian_10k through the fused leaves (4 chains, 100 warmup, 200
   draws; ``fused_potential_vg`` once per lockstep leaf iteration and at
   chain init, nothing else but the compiler's 5 probes; its moments
   gated as phase 6's; launches, tree depth and host syncs a draw
   printed; then ms a transition and a leaf iteration replayed and under
   ``disable_capture()``, in turns, ``NUTS_TIMED``) and on logreg
   through the autodiff leaves (40 + 80 draws,
   depth at most 7; the density kernels once per leaf iteration; the
   final-draw densities at rtol 1e-5 and the means against the port's
   HMC chain started at a NUTS draw within 5.5 Monte-Carlo standard
   errors); MAP, RWMH from MAP's mode, ADVI full-batch and against
   ``minibatch=``, and the self-batching SGLD step on tests/test_infer.py's
   and tests/test_sharded_chains.py's models and gates; then Table 1
   (``benchmarks/table1.py``'s ``table1/<model>/{typed,handwritten,
   untyped},us_per_call,derived`` lines for the eight models: one chain
   of ``make_chain_fn`` on the fused log-density and on the hand-written
   twin, replaying their captured transitions after one whole chain, and
   ``HMC.run_untyped``'s draw loop; medians of ``TABLE1_REPS``; logreg's
   typed and hand-written chains also once under ``disable_capture()``,
   ``table1_eager/...`` lines). Table 1's lines are information: only a
   NaN or a failed run fails them;
6c. the compile step held: every captured PPL path (HMC with
   dual-averaging warmup on the eleven models, both integrators on the
   separable and the conditional ones, gauss_unknown's switch route,
   NUTS on gaussian_10k and logreg, Table 1's chains, MAP, RWMH, ADVI
   with and without ``minibatch=``, the subsampled SGLD step, phase 6e's
   logreg posterior-predictive query and a server batch of it, phase
   6f's segmented driver on gaussian_10k) against the
   same run under ``disable_capture()``: identical draws bit for bit and
   equal launch counts, or the run fails (the LM decode steps are held the
   same way, greedy and sampled, in the LM phase);
6d. the conditional spec (ROADMAP Queue 1 item 5): eight_schools on its
   published data (step 0.1, 1,000 draws; std_normal_sum twice in each of
   the compiler's 5 probe evaluations, nothing a transition) and phase
   6's gauss_unknown run, each through ``run_chains(model,
   HMC(leapfrog="auto"))`` with 4 chains: the spec is conditional, head
   {mu, tau} and {s}; the first 10 draws equal ``leapfrog="reference"``'s
   from the same seed within atol 1e-5 (``repro``'s gate,
   tests/test_analysis.py:248-259); ms a draw of both routes. Then
   ``python -m repro_torch.analyze --json`` over the whole paper suite on
   the card, in a process of its own: exit status 0, a report that
   ``validate_analysis_report`` accepts, the verdicts (separable
   gaussian_10k, conditional gauss_unknown and eight_schools, the rest
   none);
6e. probability queries and the query server (ROADMAP Queue 1 item 6):
   on logreg (10,000 x 100) a prior, a likelihood and a joint on a
   held-out data set, and a posterior predictive over M = 1,000 draws of a
   4-chain ``run_chains`` (250 draws a chain), each through ``prob``:
   equal to ``compiled=False`` and to the per-site evaluator's plain
   torch (the per-array switch off) within 1e-5 relative, its three
   compiled calls (eager, captured, replayed) equal to
   ``disable_capture()`` bit for bit, ms a call replayed; a
   ``QueryServer`` batch of 8 PPD requests over 8 held-out data sets
   from seeds (bucket 8; lanes x draws as the rows of ONE
   ``bernoulli_logit_sum`` launch, counted), each lane equal to its
   single ``prob`` within 1e-6 relative, its stats equal to those
   reckoned from the requests, captured equal to eager bit for bit; then
   ``serve_queries()``'s demo workload (32 requests, batch 8), its stats
   reckoned from the requests and each lane of a server over the same
   requests equal to its single ``prob``;
6f. the segmented, resumable, fault-tolerant driver (ROADMAP Queue 1
   item 7), 4 chains each (``DRIVER_RUNS``): gaussian_10k on the fused
   leapfrog (Table 1's HMC, 200 + 1,000 draws, ``checkpoint_every=250``),
   logreg on the autodiff leapfrog (100 + 300, 100) and NUTS on
   gaussian_10k (20 + 40, 15): segmented (with and without snapshots)
   equal to unsegmented bit for bit; ``ScriptedPreemption(after_polls=2)``
   then a resume into a cleared program cache equal to the uninterrupted
   run bit for bit; a ``NaNInjector`` at one iteration rerun on the
   reference twin (one fallback segment, finite draws) and, with
   ``fallback=False``, recorded; a ``torn_save`` of the step after the
   latest skipped on resume; snapshot bytes and seconds and ms a draw
   segmented against unsegmented. The checkpoints go to a temporary
   directory that the phase removes;
6g. sharding on ``torch.distributed`` (ROADMAP Queue 1 item 8), logreg
   (10,000 x 100, ``shard_sites=("X", "y")``, 4 chains): the trivial plan
   ``run_chains(mesh=ShardedRun.plan())`` in this process equal to
   ``run_chains()`` bit for bit; then a world of 4 ranks spawned on the
   one card (``sharding.spawn_world``: gloo over CUDA tensors, the
   kernels this process built loaded from the build directory; a time
   limit kills every rank and fails the phase), each rank: which gloo
   collectives take CUDA tensors (the mesh layer hands gloo its CUDA
   tensors as they are, so a refusal fails the phase; printed); the
   sharded density and gradient against the unsharded ones at 4 points
   for 2 and 4 data shards (1e-6 relative on the value, 1e-5 of max
   |gradient|); a chains-only 4 x 1 run of 6 draws, no adaptation,
   against the unsharded draws at 1e-4, its transitions replayed as
   graphs (counted); an adaptive 2 x 2 chains x data run, 100 + 200
   draws, with every count zeroed just before and read just after:
   finite, one data-axis collective a gradient evaluation,
   ``bernoulli_logit_sum`` and ``std_normal_sum`` once an evaluation,
   the former at the shard's 5,000 rows; a chains-only segmented run
   preempted and resumed equal to the uninterrupted one bit for bit; ms
   a transition of each mesh (four processes time-sharing one card: not
   a speed figure) with the gloo all-reduce's share, host seconds of
   each part, memory a rank. Here: the two ranks of each data group end
   bit for bit equal, and w's posterior mean within 5.5 Monte-Carlo
   standard errors of the same run on one device.
   ``torch.cuda.memory_reserved()``, ``memory_allocated()`` and the peak
   since the previous line (``max_memory_allocated()``) are printed after
   phases 6, 6b, 6c, 6d, 6e, 6f and 6g, the LM paths and phase 6h;
6h. Bayesian-LM training (ROADMAP Queue 1 item 9, its training part),
   after the LM paths, tokens from ``SyntheticTokens(seed=0)``, random
   weights from seed 0, ``attn_impl="flash"``: smollm-360m at full width
   and depth (32 layers, bf16, remat "nothing" as its config has it)
   through ``launch.train.train()``, MAP-AdamW at lr 3e-4 on 8 x 1,024
   tokens for 10 steps, counted (``flash_fwd_tc`` twice a layer, in the
   forward and in remat's recompute, ``categorical_logits_sum`` once, a
   step; the attention backward recomputes through the plain version),
   the nll falling; a checkpoint of the last step's state written and
   restored bit for bit (MB, seconds); ms a step replayed and eager,
   tokens/s, the busy share of two replayed steps under the profiler,
   peak memory; 3 SGLD steps through ``train()`` (counted, finite nll).
   The float32 gate on a float32 copy at 2 x 1,024, all 32 layers: the
   MAP step's scaled log-joint (prior plus likelihood, read apart) and
   its gradient through ``flash_fwd_tf32`` and ``categorical_logits_sum``
   (counted) against the plain route (``attn_impl="xla"``, the per-site
   evaluator's plain categorical, no launch): nll and grad_norm within
   rtol 1e-5, every gradient leaf within 5e-5 of its max |plain| (the
   logjoint, which the prior's plain sum dominates, printed); then the
   control, ``flash_fwd_tc`` on the inputs rounded to bf16, which must
   break one of those limits. Remat: one bf16 gradient with remat off,
   "nothing" and "dots": the logjoint equal, the gradients within 1e-6
   of each leaf's max, each one's peak memory and launches. Three MAP
   steps captured (a CUDA graph from the second) against the same steps
   under ``disable_capture()``, run twice: bit for bit where two eager
   runs agree, else within the two eager runs' spread (the leaves named).
   mamba2-1.3b at full width and depth (48 layers, bf16): 3 MAP steps
   on 4 x 2,048 through ``train()`` (``ssd_scan_tc`` twice a layer,
   counted), finite nll; its float32 gate through ``ssd_scan_tf32`` at
   depth cut from 48 to 4, as smollm's but with each gradient leaf
   within 5e-4 (control ``ssd_scan_tc``). ``infer.make_sgld_step`` on smollm's Bayesian
   LM: one step on the card, counted;
7. the card's floor for one launch (a 4-float ``zero_()``, timed as the
   kernels are); times each kernel at the main paths' shapes (and a wide
   one) beside its bound, its plain version and, where one exists, one
   PyTorch library call (device time from the profiler, and the time the
   host takes to issue each call; the fused leapfrog at gaussian_10k's
   and family_mix_8k's compiled specs), and profiles a window of
   transitions
   of logreg, of gaussian_10k under both integrators, of hier_poisson,
   hmm_semisup, lda, gauss_unknown (the switch route, the autodiff and the
   conditional integrators), eight_schools (autodiff and conditional),
   sto_volatility and family_mix_8k for the
   device's busy share, each eagerly and replayed as ``run_chains``
   replays it (kernels, and host syncs and copies by name, a
   transition); the flash kernels at the LM paths' calls
   (``FLASH_TIMED``: the bf16 serving calls and the float32 prefill; the
   library call is ``scaled_dot_product_attention`` with a boolean mask
   and ``enable_gqa``, none where gemma2's softcap applies; at the float32
   prefill the FP32 flash_fwd too) and the SSD kernels at mamba2's bf16
   and float32 calls (at each the kernel ``plan`` picks and the FP32
   kernel), their bounds at the peak for the kernel's route (the bf16
   tensor cores, FP32, or three passes at the TF32 rate for the 3xTF32
   kernels and mvn_quadform_sum; at the FP32 rate also ``bound_fp32_ms``);
   the kernels' line lists the FP32 kernels that no main path runs any
   more with 0 launches and ``off_main_path``; and
   profiles of each serving path's prefill and decode steps (eager, and
   the decode step replayed as ``serve_batch`` runs it; ms a token of
   each unprofiled, in turns) and of one scoring evaluation.

Usage, from the root of a checkout, on a machine with one CUDA GPU:

    python3 chip_smoke.py [--samples N] [--out build/chip_smoke.json]

The last two lines of standard output are the kernels' JSON line and
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero and
prints no result, as does a machine without CUDA or a directory without
the port's sources.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # dense TF32 on the tensor cores
# float ops per element, as written in the .cu source
STD_NORMAL_OPS = 4      # two multiplies, a subtract, the add into the sum
BERNOULLI_OPS = 11      # max, fabs, 2 negations, exp, log1p, add, 1-y, mul, sub, sum
GAMMA_OPS = 5           # log, two multiplies, a subtract, the add into the sum
# categorical, as log_softmax needs them: per class a max, a subtract, an
# exp and an add; per item the log, two subtracts and the add into the sum
CATEGORICAL_CLASS_OPS = 4
CATEGORICAL_ITEM_OPS = 4
# fused leapfrog: per element and step two half-kicks and a drift (three
# multiply-adds) and the gradient; at the final q the value and its add
# into the sum. Gradient and value by opcode (ZERO, NORMAL, EXP, SOFTPLUS,
# TLOG; an exp, log1p or divide counts one): NORMAL -(u - c0) * (c1 * c1)
# and -0.5 ((u - c0) c1)^2; EXP c0 - c1 c2 exp(c2 u) and c0 u - c1 exp(c2
# u); SOFTPLUS two logistics (fabs, negation, exp, add, divide each) and
# two softplus (fabs, negation, exp, log1p, max, add each) with their
# multiplies; TLOG with zt = (u - c2) c3
LEAPFROG_KICK_OPS = 6
LF_GRAD_OPS = (0, 3, 5, 14, 10)
LF_VALUE_OPS = (0, 4, 5, 16, 7)
# normal: subtract, divide, two multiplies, log, two subtracts, the add
NORMAL_OPS = 8
# beta: log, log1p, a negation, two multiplies, an add, the add into the sum
BETA_OPS = 7
# student_t: z * z, a divide, log1p, df + 1, two multiplies, the add
STUDENT_T_OPS = 7
LOGPDF_CU = "src/repro_torch/kernels/fused_logpdf/csrc/fused_logpdf.cu"
MVN_CU = "src/repro_torch/kernels/fused_logpdf/csrc/mvn_quad.cu"
LEAPFROG_CU = "src/repro_torch/kernels/fused_leapfrog/csrc/fused_leapfrog.cu"
FLASH_CU = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SSD_CU = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SOURCES = {
    "std_normal_sum": LOGPDF_CU,
    "bernoulli_logit_sum": LOGPDF_CU,
    "categorical_logits_sum": LOGPDF_CU,
    "categorical_logits_sum_small": LOGPDF_CU,
    "gamma_unnorm_sum": LOGPDF_CU,
    "fused_leapfrog": LEAPFROG_CU,
    "fused_potential_vg": LEAPFROG_CU,
    "normal_sum": LOGPDF_CU,
    "beta_unnorm_sum": LOGPDF_CU,
    "student_t_unnorm_sum": LOGPDF_CU,
    "mvn_quadform_sum": MVN_CU,
    "flash_fwd": FLASH_CU,
    "flash_fwd_tc": FLASH_CU,
    "flash_decode": FLASH_CU,
    "flash_fwd_tf32": FLASH_CU,
    "ssd_scan": SSD_CU,
    "ssd_scan_tc": SSD_CU,
    "ssd_scan_tf32": SSD_CU,
}
REPLACES = {
    "std_normal_sum": "src/repro/kernels/fused_logpdf/kernel.py:54",
    "bernoulli_logit_sum": "src/repro/kernels/fused_logpdf/kernel.py:97",
    "categorical_logits_sum": "src/repro/kernels/fused_logpdf/kernel.py:120",
    "categorical_logits_sum_small":
        "src/repro/kernels/fused_logpdf/kernel.py:120",
    "gamma_unnorm_sum": "src/repro/kernels/fused_logpdf/kernel.py:154",
    "fused_leapfrog": "src/repro/kernels/fused_leapfrog/kernel.py:38",
    "fused_potential_vg": "src/repro/kernels/fused_leapfrog/kernel.py:130",
    "normal_sum": "src/repro/kernels/fused_logpdf/kernel.py:75",
    "beta_unnorm_sum": "src/repro/kernels/fused_logpdf/kernel.py:174",
    "student_t_unnorm_sum": "src/repro/kernels/fused_logpdf/kernel.py:194",
    "mvn_quadform_sum": "src/repro/kernels/fused_logpdf/kernel.py:220",
    "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:34",
    "flash_fwd_tc": "src/repro/kernels/flash_attention/kernel.py:34",
    "flash_decode": "src/repro/kernels/flash_attention/kernel.py:34",
    "flash_fwd_tf32": "src/repro/kernels/flash_attention/kernel.py:34",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:31",
    "ssd_scan_tc": "src/repro/kernels/ssd_scan/kernel.py:31",
    "ssd_scan_tf32": "src/repro/kernels/ssd_scan/kernel.py:31",
}
NO_LIBRARY = {
    "gamma_unnorm_sum": "no single PyTorch call computes sum(am1 log x - "
                        "rate x) (poisson_nll_loss adds 1e-8 inside the log "
                        "and has no rate)",
    "beta_unnorm_sum": "no single PyTorch call computes sum(am1 log x + bm1 "
                       "log1p(-x)) (torch.distributions.Beta.log_prob is "
                       "several calls and adds the normaliser; "
                       "binary_cross_entropy clamps the logs at -100 and "
                       "has one weight for both terms)",
    "student_t_unnorm_sum": "no single PyTorch call computes sum(-(df + 1)/2 "
                            "log1p(z^2/df)) (torch.distributions.StudentT."
                            "log_prob is several calls and adds the "
                            "normaliser)",
    "fused_leapfrog": "no single PyTorch call computes an n-step integrator",
    "fused_potential_vg": "no single PyTorch call computes a potential's "
                          "value and its gradient",
    "ssd_scan": "no single PyTorch call computes a chunked state-space scan "
                "(PyTorch has no selective-scan operator; its plain version "
                "is a dozen einsums and a loop over chunks)",
}
NO_LIBRARY["ssd_scan_tc"] = NO_LIBRARY["ssd_scan"]
NO_LIBRARY["ssd_scan_tf32"] = NO_LIBRARY["ssd_scan"]
# kernels that no main path launches any more: plan sends the calls they
# ran to the tensor-core kernels; they keep the shapes those do not take,
# are held to their plain versions in phase 3 and timed (by
# launch_kernel) at the float32 calls they used to run
OFF_MAIN_PATH = {
    "flash_fwd": "the float32 prefill at hd 64 and 128 now runs "
                 "flash_fwd_tf32; flash_fwd keeps the other head dims (16, "
                 "20, 256), which no main path has",
    "ssd_scan": "mamba2's float32 scoring call now runs ssd_scan_tf32; "
                "ssd_scan keeps head dim 32, other state dims, unaligned "
                "rows and bf16 at chunk 32, which no main path has",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase 1: the card
# ---------------------------------------------------------------------------
def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    check(out, "nvidia-smi printed nothing")
    return out.splitlines()[0].strip()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
MAIN_SHAPES = {"std_normal_sum": [(4, 11), (4, 101), (4, 400), (4, 40000)],
               "bernoulli_logit_sum": [(4, 10000)],
               # (chains, items, classes): hmm_semisup's two blocks, lda's
               "categorical_logits_sum_small": [(4, 99, 5), (4, 100, 20),
                                                (4, 10176, 100)],
               # mamba2-1.3b scoring's tokens, and the other LM
               # vocabularies: smollm's, granite-moe's, deepseek's (its
               # scoring's tokens)
               "categorical_logits_sum": [(1, 8192, 50280), (1, 8192, 49152),
                                          (1, 8192, 49155),
                                          (1, 8192, 102400)],
               # hier_poisson's block, and a wide one for the timing phase
               "gamma_unnorm_sum": [(4, 1), (4, 40000)],
               # gauss_unknown's per-array route (shared x, one mu and one
               # sigma per chain), and a wide one
               "normal_sum": [(4, 10000), (4, 40000)],
               # mixed's scalar site, family_mix_8k's block, a wide one
               "beta_unnorm_sum": [(4, 1), (4, 1024), (4, 40000)],
               "student_t_unnorm_sum": [(4, 8), (4, 2048), (4, 40000)],
               # (chains, N, D): mixed's 5-D site, and a wide one
               "mvn_quadform_sum": [(4, 1, 5), (4, 4096, 256)]}
FUSED_LOGPDF = ("std_normal_sum", "bernoulli_logit_sum",
                "categorical_logits_sum", "categorical_logits_sum_small",
                "gamma_unnorm_sum", "normal_sum", "beta_unnorm_sum",
                "student_t_unnorm_sum", "mvn_quadform_sum")
CHECK_ROWS = (1, 4, 16)
# (2,047 and 2,049: either side of one block's share of a row in the
# one-launch reductions)
CHECK_N = (1, 101, 255, 257, 400, 2047, 2049, 10000, 40000, 40400, 1_000_003)


def check_kernels(torch, ops, ref):
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1234)
    worst = {k: 0.0 for k in ("std_normal_sum", "bernoulli_logit_sum")}
    shapes = sorted({(r, n) for r in CHECK_ROWS for n in CHECK_N}
                    | {s for k in worst for s in MAIN_SHAPES[k]})
    for rows, n in shapes:
        z = 2.0 * torch.randn(rows, n, generator=gen, device=dev)
        zo = (2.0 * torch.randn(rows * n + 1, generator=gen, device=dev)
              )[1:].view(rows, n)  # off 16 bytes: 4-byte loads
        y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
        cases = [("std_normal_sum", ops.std_normal_sum_rows, (z,),
                  ref.std_normal_logpdf_sum_ref)]
        # y at row stride 0 (logreg's) and dense, then the offset logits
        for args in ((z, y.expand(rows, n)), (z, y.repeat(rows, 1)),
                     (zo, y.expand(rows, n))):
            cases.append(("bernoulli_logit_sum", ops.bernoulli_logit_sum_rows,
                          args, ref.bernoulli_logits_logpmf_sum_ref))
        for name, kern, args, plain in cases:
            got = kern(*args)
            again = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, again),
                  f"{name} {rows}x{n}: two runs differ")
            err = (got - want).abs()
            tol = 1e-6 * want.abs()
            check(bool((err <= tol).all()),
                  f"{name} {rows}x{n}: max rel err "
                  f"{float((err / want.abs()).max()):.3e} > 1e-6")
            if (rows, n) in MAIN_SHAPES[name]:
                worst[name] = max(worst[name], float(err.max()))
    log(f"kernels vs plain: {len(shapes)} shapes x 4 cases, rtol 1e-6, "
        f"bit-identical reruns: ok")

    # backward through vmap(grad): one launch for the whole chain axis
    z = torch.randn(4, 10000, generator=gen, device=dev)
    y = (torch.rand(10000, generator=gen, device=dev) < 0.5).float()
    ops.reset_launch_counts()
    g = torch.func.vmap(torch.func.grad(ops.std_normal_logpdf_sum))(z)
    gl = torch.func.vmap(torch.func.grad(ops.bernoulli_logits_logpmf_sum),
                         in_dims=(0, None))(z, y)
    torch.cuda.synchronize()
    logits = torch.randn(4, 100, 20, generator=gen, device=dev)
    labels = torch.randint(0, 20, (100,), generator=gen, device=dev,
                           dtype=torch.int32)
    gc = torch.func.vmap(torch.func.grad(ops.categorical_logits_logpmf_sum),
                         in_dims=(0, None))(logits, labels)
    x = 0.1 + torch.rand(4, 11, generator=gen, device=dev)
    am1 = torch.rand(11, generator=gen, device=dev)
    rate = 0.5 + torch.rand(11, generator=gen, device=dev)
    gx = torch.func.vmap(torch.func.grad(ops.gamma_unnorm_logpdf_sum),
                         in_dims=(0, None, None))(x, am1, rate)
    torch.cuda.synchronize()
    want = {**dict.fromkeys(FUSED_LOGPDF, 0),
            **dict.fromkeys(("std_normal_sum", "bernoulli_logit_sum",
                             "categorical_logits_sum_small",
                             "gamma_unnorm_sum"), 1)}
    check(ops.LAUNCHES == want,
          f"vmap(grad) over 4 chains launched {ops.LAUNCHES}, expected one "
          "launch per kernel")
    torch.testing.assert_close(g, -z, rtol=1e-6, atol=0)
    torch.testing.assert_close(gl, y - torch.sigmoid(z), rtol=1e-6, atol=1e-7)
    onehot = torch.nn.functional.one_hot(labels.long(), 20).float()
    torch.testing.assert_close(gc, onehot - torch.softmax(logits, -1),
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(gx, am1 / x - rate, rtol=1e-6, atol=0)
    log("vmap(grad) backward: ok, one launch per kernel for 4 chains")
    return worst


def same_bits(torch, a, b) -> bool:
    """Bit-identical, NaN included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


CAT_C = (1, 2, 5, 20, 31, 32, 33, 100, 257, 1000, 4096, 4097)
# the large-C path's edge cases: 4-byte loads (257), 16-byte ones (1,000
# and mamba2's vocabulary)
CAT_EDGE_C = (257, 1000, 50280)
CAT_N = (1, 99, 100, 257, 10176, 100_000)
CAT_MAX_ELEMS = 1 << 27  # 512 MB of logits: larger cases are left out


def check_categorical_gamma_kernels(torch, ops, ref):
    """categorical_logits_sum against its plain version at rtol 1e-6 (every
    term is <= 0, so the sum does not cancel) over CAT_C x CAT_N x 1/4/16
    rows with labels shared (row stride 0) and per row, up to
    CAT_MAX_ELEMS logits, and at its edges (labels outside [0, C), -inf
    logits, a row of -inf: the same NaN and -inf as the plain version);
    gamma_unnorm_sum at 1e-6 of sum_i |am1_i log x_i| + |rate_i x_i| (its
    terms change sign) with am1 and rate shared and per row. Both with
    bit-identical reruns. Returns the worst abs error at the main paths'
    shapes."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(99)
    worst = {"categorical_logits_sum": 0.0,
             "categorical_logits_sum_small": 0.0, "gamma_unnorm_sum": 0.0}
    n_cat = skipped = 0
    for c in CAT_C:
        for n in CAT_N:
            for rows in CHECK_ROWS:
                if rows * n * c > CAT_MAX_ELEMS:
                    skipped += 2
                    continue
                logits = 3.0 * torch.randn(rows, n, c, generator=gen,
                                           device=dev)
                for shared in (True, False):
                    lab = torch.randint(0, c, (n,) if shared else (rows, n),
                                        generator=gen, device=dev,
                                        dtype=torch.int32).expand(rows, n)
                    ops.reset_launch_counts()
                    got = ops.categorical_logits_sum_rows(logits, lab)
                    check(sum(ops.LAUNCHES.values()) == 1,
                          f"categorical {rows}x{n}x{c}: launches "
                          f"{ops.LAUNCHES}, expected one")
                    again = ops.categorical_logits_sum_rows(logits, lab)
                    want = ref.categorical_logits_logpmf_sum_ref(logits, lab)
                    torch.cuda.synchronize()
                    tag = f"categorical_logits_sum {rows}x{n}x{c} " \
                          f"{'shared' if shared else 'per-row'} labels"
                    check(same_bits(torch, got, again), f"{tag}: two runs differ")
                    err = (got - want).abs()
                    check(bool((err <= 1e-6 * want.abs()).all()),
                          f"{tag}: max rel err "
                          f"{float((err / want.abs()).max()):.3e} > 1e-6")
                    name = ("categorical_logits_sum_small"
                            if ops.categorical_group(c)
                            else "categorical_logits_sum")
                    if (rows, n, c) in MAIN_SHAPES[name]:
                        worst[name] = max(worst[name], float(err.max()))
                    n_cat += 1
                del logits
    # the edges, as the plain version defines them
    ninf = float("-inf")
    logits = torch.randn(2, 6, 40, generator=gen, device=dev)
    logits[:, 1, ::3] = ninf
    logits[:, 2, :] = ninf
    logits[:, 3, 7] = ninf
    edge_cases = [
        (logits, torch.tensor([[0, 2, 5, 7, 1, 2], [0, 1, 5, 6, -1, 40]])),
        (logits[:, [0, 1, 3, 4, 5]].contiguous(),
         torch.tensor([[0, 1, 3, 4, 5], [0, 3, 7, 2, 2]])),
        (logits[:, [0, 1, 4]].contiguous(), torch.tensor([[0, 1, 41]] * 2)),
    ]
    for lg, lab in edge_cases:
        lab = lab.to(device=dev, dtype=torch.int32)
        got = ops.categorical_logits_sum_rows(lg, lab)
        want = ref.categorical_logits_logpmf_sum_ref(lg, lab)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0,
                                   equal_nan=True)
        check(same_bits(torch, got, ops.categorical_logits_sum_rows(lg, lab)),
              "categorical_logits_sum edge case: two runs differ")
    # above 256 classes, one item a row so each edge is held alone: -inf
    # entries, a label on one, a row of -inf, +inf, NaN, labels -1 and C,
    # and -inf over each lane's first classes
    for c in CAT_EDGE_C:
        lg = torch.randn(9, 1, c, generator=gen, device=dev)
        lg[1, 0, ::3] = ninf
        lg[2, 0, ::3] = ninf
        lg[3, 0, :] = ninf
        lg[4, 0, c - 1] = float("inf")
        lg[5, 0, 5] = float("nan")
        lg[8, 0, :min(c - 1, 2048)] = ninf
        lab = torch.tensor([0, 1, 3, 2, 4, 5, -1, c, c - 1],
                           dtype=torch.int32, device=dev).view(9, 1)
        got = ops.categorical_logits_sum_rows(lg, lab)
        want = ref.categorical_logits_logpmf_sum_ref(lg, lab)
        check(bool(torch.isnan(want[[3, 4, 5, 6, 7]]).all())
              and float(want[2]) == ninf, f"C = {c} edges: plain {want}")
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0,
                                   equal_nan=True)
        check(same_bits(torch, got, ops.categorical_logits_sum_rows(lg, lab)),
              f"categorical_logits_sum C = {c} edge cases: two runs differ")
        edge_cases.append((lg, lab))
    log(f"categorical_logits_sum vs plain: {n_cat} cases (C in {CAT_C}, "
        f"n in {CAT_N}, {CHECK_ROWS} rows, labels shared and per row, one "
        f"launch a call; {skipped} over {CAT_MAX_ELEMS} logits left out) and "
        f"{len(edge_cases)} edge cases (C = 40 and {CAT_EDGE_C}), rtol 1e-6, "
        "bit-identical reruns: ok")

    n_gamma = 0
    shapes = sorted({(r, n) for r in CHECK_ROWS for n in CHECK_N}
                    | set(MAIN_SHAPES["gamma_unnorm_sum"]))
    for rows, n in shapes:
        x = 0.05 + 4.0 * torch.rand(rows, n, generator=gen, device=dev)
        for shared in (True, False):
            pshape = (n,) if shared else (rows, n)
            am1 = -0.5 + 3.5 * torch.rand(pshape, generator=gen, device=dev)
            rate = 0.2 + 3.0 * torch.rand(pshape, generator=gen, device=dev)
            am1, rate = am1.expand(rows, n), rate.expand(rows, n)
            got = ops.gamma_unnorm_sum_rows(x, am1, rate)
            again = ops.gamma_unnorm_sum_rows(x, am1, rate)
            want = ref.gamma_unnorm_logpdf_sum_ref(x, am1, rate)
            torch.cuda.synchronize()
            tag = f"gamma_unnorm_sum {rows}x{n} " \
                  f"{'shared' if shared else 'per-row'} parameters"
            check(same_bits(torch, got, again), f"{tag}: two runs differ")
            abs_sum = ((am1 * torch.log(x)).abs() + (rate * x).abs()).sum(-1)
            err = (got - want).abs()
            check(bool((err <= 1e-6 * abs_sum).all()),
                  f"{tag}: err {float(err.max()):.3e} beyond 1e-6 * "
                  "sum|terms|")
            if (rows, n) in MAIN_SHAPES["gamma_unnorm_sum"]:
                worst["gamma_unnorm_sum"] = max(worst["gamma_unnorm_sum"],
                                                float(err.max()))
            n_gamma += 1
    log(f"gamma_unnorm_sum vs plain: {n_gamma} cases (n up to 1,000,003, "
        f"{CHECK_ROWS} rows, parameters shared and per row), 1e-6 of "
        "sum|terms|, bit-identical reruns: ok")
    return worst


ONE_LAUNCH = ("std_normal_sum", "gamma_unnorm_sum", "beta_unnorm_sum",
              "student_t_unnorm_sum", "normal_sum", "bernoulli_logit_sum")
# the four whose inputs also take an element stride of 0 (one value a row)
ELEM_STRIDED = ("beta_unnorm_sum", "student_t_unnorm_sum", "normal_sum",
                "bernoulli_logit_sum")
ONE_LAUNCH_SHAPES = ((4, 40000), (1, 1_000_003))  # more than one block a row
ONE_LAUNCH_RERUNS = 1000


def one_launch_case(torch, ops, ref, name, rows, n, offset, gen,
                    params="shared"):
    """(wrapper, inputs, plain result, the gate's scale) of a one-launch
    reduction: the value's rows 16-byte aligned, or (``offset``) one float
    past a 16-byte boundary, which takes the 4-byte loads; the parameters
    at row stride 0 (``params="shared"``, as on the main paths) or, for
    beta, student_t, normal and bernoulli (its y), one value a row
    (``"scalar"``, element stride 0, which never bars 16-byte loads); for
    normal also
    ``"switch"``, gauss_unknown's switch route: the data shared by the
    rows (row stride 0) and one mu and one sigma a row."""
    dev = torch.device(DEVICE)

    def rows_of(lo, scale, draw):
        if offset:
            flat = lo + scale * draw(rows * n + 1, generator=gen, device=dev)
            return flat[1:].view(rows, n)
        return lo + scale * draw(rows, n, generator=gen, device=dev)

    def param(lo, scale):
        shape = (n,) if params == "shared" else (rows, 1)
        return (lo + scale * torch.rand(shape, generator=gen, device=dev)
                ).expand(rows, n)

    if name == "std_normal_sum":
        z = rows_of(0.0, 2.0, torch.randn)
        want = ref.std_normal_logpdf_sum_ref(z)
        return ops.std_normal_sum_rows, (z,), want, want.abs()
    if name == "normal_sum":
        if params == "switch":
            x = (2.0 * torch.randn(n + offset, generator=gen, device=dev)
                 )[offset:].expand(rows, n)
            params = "scalar"
        else:
            x = rows_of(0.0, 2.0, torch.randn)
        mu, sig = param(-1.0, 2.0), param(0.3, 2.7)
        want = ref.normal_logpdf_sum_ref(x, mu, sig)
        return (ops.normal_sum_rows, (x, mu, sig), want,
                abs_terms(torch, name, (x, mu, sig)))
    if name == "beta_unnorm_sum":
        x = rows_of(0.01, 0.98, torch.rand)
        am1, bm1 = param(-0.5, 3.5), param(-0.5, 3.5)
        want = ref.beta_unnorm_logpdf_sum_ref(x, am1, bm1)
        return (ops.beta_unnorm_sum_rows, (x, am1, bm1), want,
                abs_terms(torch, name, (x, am1, bm1)))
    if name == "bernoulli_logit_sum":  # every term <= 0
        logits = rows_of(0.0, 2.0, torch.randn)
        shape = (1, n) if params == "shared" else (rows, 1)
        y = (torch.rand(shape, generator=gen, device=dev) < 0.5
             ).float().expand(rows, n)
        want = ref.bernoulli_logits_logpmf_sum_ref(logits, y)
        return ops.bernoulli_logit_sum_rows, (logits, y), want, want.abs()
    if name == "student_t_unnorm_sum":
        z = rows_of(0.0, 3.0, torch.randn)
        df = param(0.5, 29.5)
        want = ref.student_t_unnorm_logpdf_sum_ref(z, df)
        return ops.student_t_unnorm_sum_rows, (z, df), want, want.abs()
    x = rows_of(0.05, 4.0, torch.rand)
    am1, rate = param(-0.5, 3.5), param(0.2, 3.0)
    want = ref.gamma_unnorm_logpdf_sum_ref(x, am1, rate)
    terms = ((am1 * torch.log(x)).abs() + (rate * x).abs()).sum(-1)
    return ops.gamma_unnorm_sum_rows, (x, am1, rate), want, terms


def counts_at_zero(torch, stream) -> bool:
    """The last-block counts of ``stream`` (the one-launch reductions' and
    the fused leapfrog's, ``kernels._scratch``), read back: there, and all
    0."""
    from repro_torch.kernels._scratch import SCRATCH
    torch.cuda.synchronize()
    entry = SCRATCH.get((torch.cuda.current_device(), stream.cuda_stream))
    return entry is not None and not bool(entry[1].any())


def check_one_launch(torch, ops, ref):
    """The one-launch reductions where a row takes more than one block (the
    last block of a row merges): ONE_LAUNCH_RERUNS back-to-back calls
    bit-identical with every count read back at 0, and calls alternating
    between two streams equal to them with both streams' counts at 0; with
    16-byte loads and with 4-byte ones, and beta's and student_t's
    parameters shared and one value a row. Gates as in check_kernels,
    check_categorical_gamma_kernels and check_density_kernels."""
    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(18)
    n_cases = 0
    for name, rows, n, params, offset in [
            (name, rows, n, params, offset) for name in ONE_LAUNCH
            for rows, n in ONE_LAUNCH_SHAPES
            for params in (("shared", "scalar") if name in ELEM_STRIDED
                           else ("shared",))
                          + (("switch",) if name == "normal_sum" else ())
            for offset in (False, True)]:
        kern, args, want, scale = one_launch_case(
            torch, ops, ref, name, rows, n, offset, gen, params)
        width = "4-byte" if offset else "16-byte"
        tag = f"{name} {rows}x{n} {width} loads, {params} parameters"
        plan = ops.reduce_plan(n, ops._reduce_inputs(
            args, rows, n, name in ELEM_STRIDED))
        check(plan.nparts > 1 and plan.vec == (not offset),
              f"{tag}: plan {plan}")
        main = torch.cuda.current_stream()
        first = kern(*args)
        again = torch.stack([kern(*args)
                             for _ in range(ONE_LAUNCH_RERUNS)])
        torch.cuda.synchronize()
        check(bool(((first - want).abs() <= 1e-6 * scale).all()),
              f"{tag}: err {float((first - want).abs().max()):.3e} "
              "beyond 1e-6")
        check(same_bits(torch, again, first.expand_as(again)),
              f"{tag}: {ONE_LAUNCH_RERUNS} reruns not bit-identical")
        check(counts_at_zero(torch, main),
              f"{tag}: counts not back at 0")
        streams = (torch.cuda.Stream(), torch.cuda.Stream())
        for s in streams:
            s.wait_stream(main)
        alt = []
        for i in range(20):
            with torch.cuda.stream(streams[i % 2]):
                alt.append(kern(*args))
        for s in streams:
            main.wait_stream(s)
        check(all(counts_at_zero(torch, s) for s in streams),
              f"{tag}: counts of the two streams not back at 0")
        check(all(same_bits(torch, a, first) for a in alt),
              f"{tag}: calls on two streams differ")
        n_cases += 1
    log(f"{', '.join(ONE_LAUNCH)} merge path: {n_cases} cases "
        f"({ONE_LAUNCH_SHAPES}, 16- and 4-byte loads, parameters shared "
        "and one a row, normal's data shared as on the switch route), "
        f"{ONE_LAUNCH_RERUNS} back-to-back calls bit-identical, counts read "
        "back at 0, two streams alternating agree: ok")


ELEMENTWISE = ("normal_sum", "beta_unnorm_sum", "student_t_unnorm_sum")
# parameters dense per row, shared by the rows (row stride 0), one value
# per row (element stride 0: gauss_unknown's mu and sigma), or every input
# a view one float past a 16-byte boundary (4-byte loads)
ELEM_PARAMS = ("per_row", "shared", "scalar", "offset")


def elementwise_case(torch, ops, ref, name, rows, n, params, gen, shared_x=False):
    """(wrapper, inputs, plain version) of one per-element kernel."""
    dev = torch.device(DEVICE)

    def dense(lo, scale, draw):
        if params == "offset":
            flat = lo + scale * draw(rows * n + 1, generator=gen, device=dev)
            return flat[1:].view(rows, n)
        return lo + scale * draw(rows, n, generator=gen, device=dev)

    def param(lo, hi):
        if params in ("per_row", "offset"):
            return dense(lo, hi - lo, torch.rand)
        shape = (n,) if params == "shared" else (rows, 1)
        return (lo + (hi - lo) * torch.rand(shape, generator=gen,
                                            device=dev)).expand(rows, n)

    if name == "normal_sum":
        x = (2.0 * torch.randn(n, generator=gen, device=dev).expand(rows, n)
             if shared_x else dense(0.0, 2.0, torch.randn))
        return (ops.normal_sum_rows, (x, param(-1.0, 1.0), param(0.3, 3.0)),
                ref.normal_logpdf_sum_ref)
    if name == "beta_unnorm_sum":
        return (ops.beta_unnorm_sum_rows, (dense(0.01, 0.98, torch.rand),
                                           param(-0.5, 3.0),
                                           param(-0.5, 3.0)),
                ref.beta_unnorm_logpdf_sum_ref)
    return (ops.student_t_unnorm_sum_rows, (dense(0.0, 3.0, torch.randn),
                                            param(0.5, 30.0)),
            ref.student_t_unnorm_logpdf_sum_ref)


def abs_terms(torch, name, args):
    """sum_i of the magnitudes of a sign-changing sum's terms."""
    if name == "normal_sum":
        x, loc, scale = args
        z = (x - loc) / scale
        return (0.5 * z * z + torch.log(scale).abs() + 0.9189385).sum(-1)
    x, am1, bm1 = args
    return ((am1 * torch.log(x)).abs() + (bm1 * torch.log1p(-x)).abs()).sum(-1)


MVN_D = (1, 5, 24, 63, 64, 65, 127, 256, 1024)
MVN_N = (1, 96, 4096, 100_000)
MVN_MAX_ELEMS = 1 << 27  # 512 MB of xc: larger cases are left out


def precision(torch, d, gen, rows=None):
    """A symmetric positive definite ``a a^T / d + I`` (one or ``rows``)."""
    dev = torch.device(DEVICE)
    shape = (d, d) if rows is None else (rows, d, d)
    a = torch.randn(shape, generator=gen, device=dev) / d ** 0.5
    return a @ a.mT + torch.eye(d, device=dev)


def check_density_kernels(torch, ops, ref):
    """normal_sum and beta_unnorm_sum at 1e-6 of the sum of their terms'
    magnitudes (their terms change sign), student_t_unnorm_sum at rtol 1e-6
    (every term <= 0), each over CHECK_ROWS x CHECK_N with parameters per
    row, shared by the rows, one per row and offset views (ELEM_PARAMS);
    mvn_quadform_sum at rtol 1e-5
    (a float32 product over D terms per entry, with a positive definite
    precision) over MVN_D x MVN_N x CHECK_ROWS up to MVN_MAX_ELEMS, the
    precision shared by the rows and per row; all with bit-identical
    reruns; and the backward of all four through vmap(grad), one launch
    each for 4 chains. Returns the worst abs error at the main paths'
    shapes."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2024)
    worst = dict.fromkeys(ELEMENTWISE + ("mvn_quadform_sum",), 0.0)
    n_elem = 0
    for name in ELEMENTWISE:
        shapes = sorted({(r, n) for r in CHECK_ROWS for n in CHECK_N}
                        | set(MAIN_SHAPES[name]))
        for rows, n in shapes:
            for params in ELEM_PARAMS:
                kern, args, plain = elementwise_case(
                    torch, ops, ref, name, rows, n, params, gen,
                    shared_x=params == "scalar")
                got, again, want = kern(*args), kern(*args), plain(*args)
                torch.cuda.synchronize()
                tag = f"{name} {rows}x{n} {params} parameters"
                check(same_bits(torch, got, again), f"{tag}: two runs differ")
                err = (got - want).abs()
                if name == "student_t_unnorm_sum":
                    check(bool((err <= 1e-6 * want.abs()).all()),
                          f"{tag}: max rel err "
                          f"{float((err / want.abs()).max()):.3e} > 1e-6")
                else:
                    check(bool((err <= 1e-6 * abs_terms(torch, name,
                                                        args)).all()),
                          f"{tag}: err {float(err.max()):.3e} beyond 1e-6 * "
                          "sum|terms|")
                if (rows, n) in MAIN_SHAPES[name]:
                    worst[name] = max(worst[name], float(err.max()))
                n_elem += 1
    log(f"normal_sum, beta_unnorm_sum, student_t_unnorm_sum vs plain: "
        f"{n_elem} cases (n up to 1,000,003, {CHECK_ROWS} rows, parameters "
        "per row, shared, one per row and offset views), 1e-6 of "
        "sum|terms| (rtol 1e-6 for student_t), bit-identical reruns: ok")

    n_mvn = skipped = 0
    for d in MVN_D:
        for n in MVN_N:
            for rows in CHECK_ROWS:
                if rows * n * d > MVN_MAX_ELEMS:
                    skipped += 2
                    continue
                xc = torch.randn(rows, n, d, generator=gen, device=dev)
                for shared in (True, False):
                    prec = (precision(torch, d, gen).expand(rows, d, d)
                            if shared else precision(torch, d, gen, rows))
                    got = ops.mvn_quadform_sum_rows(xc, prec)
                    again = ops.mvn_quadform_sum_rows(xc, prec)
                    want = ref.mvnormal_prec_quadform_sum_ref(xc, prec)
                    torch.cuda.synchronize()
                    tag = f"mvn_quadform_sum {rows}x{n}x{d} " \
                          f"{'shared' if shared else 'per-row'} precision"
                    check(same_bits(torch, got, again),
                          f"{tag}: two runs differ")
                    err = (got - want).abs()
                    check(bool((err <= 1e-5 * want.abs()).all()),
                          f"{tag}: max rel err "
                          f"{float((err / want.abs()).max()):.3e} > 1e-5")
                    if (rows, n, d) in MAIN_SHAPES["mvn_quadform_sum"]:
                        worst["mvn_quadform_sum"] = max(
                            worst["mvn_quadform_sum"], float(err.max()))
                    n_mvn += 1
                del xc
    log(f"mvn_quadform_sum vs plain: {n_mvn} cases (D in {MVN_D}, N in "
        f"{MVN_N}, {CHECK_ROWS} rows, precision shared and per row; "
        f"{skipped} over {MVN_MAX_ELEMS} elements left out), rtol 1e-5, "
        "bit-identical reruns: ok")

    # backward through vmap(grad): one launch each for 4 chains
    x = torch.randn(10000, generator=gen, device=dev)
    mu = torch.randn(4, generator=gen, device=dev)
    sig = 0.5 + torch.rand(4, generator=gen, device=dev)
    xb = 0.05 + 0.9 * torch.rand(4, 1024, generator=gen, device=dev)
    z = torch.randn(4, 2048, generator=gen, device=dev)
    xc = torch.randn(4, 1, 5, generator=gen, device=dev)
    prec = precision(torch, 5, gen)
    ops.reset_launch_counts()
    gm, gs = torch.func.vmap(torch.func.grad(ops.normal_logpdf_sum,
                                             argnums=(1, 2)),
                             in_dims=(None, 0, 0))(x, mu, sig)
    gb = torch.func.vmap(torch.func.grad(ops.beta_unnorm_logpdf_sum),
                         in_dims=(0, None, None))(xb, 1.0, 2.0)
    gt = torch.func.vmap(torch.func.grad(ops.student_t_unnorm_logpdf_sum),
                         in_dims=(0, None))(z, 4.0)
    gq = torch.func.vmap(torch.func.grad(ops.mvnormal_prec_quadform_sum),
                         in_dims=(0, None))(xc, prec)
    torch.cuda.synchronize()
    want = {**dict.fromkeys(FUSED_LOGPDF, 0),
            **dict.fromkeys(ELEMENTWISE + ("mvn_quadform_sum",), 1)}
    check(ops.LAUNCHES == want, f"vmap(grad) over 4 chains launched "
          f"{ops.LAUNCHES}, expected one launch per kernel")
    zz = (x - mu[:, None]) / sig[:, None]
    torch.testing.assert_close(gm, (zz / sig[:, None]).sum(-1), rtol=1e-4,
                               atol=1e-2)
    torch.testing.assert_close(gs, ((zz * zz - 1) / sig[:, None]).sum(-1),
                               rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(gb, 1.0 / xb - 2.0 / (1 - xb), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(gt, -5.0 * z / (4.0 + z * z), rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(gq, -(xc @ prec), rtol=1e-5, atol=1e-6)
    log("vmap(grad) backward of normal, beta, student_t and mvn_quadform: "
        "ok, one launch per kernel for 4 chains")
    return worst


# (uniform opcode, coordinates a run of one opcode): None is a mixed table
# (the any-opcode kernel), its opcode drawn for every coordinate or, as in
# family_mix_8k, for every 512
LF_TABLES = ((None, 1), (None, 512), (0, 1), (1, 1), (2, 1), (3, 1), (4, 1))
LF_CHAINS = (1, 4, 16)
# either side of a warp's 128 and of one block's 256 coordinates a chain
LF_DIMS = (1, 127, 129, 255, 256, 257, 2047, 2049, 8192, 10000, 1_000_003)
LF_STEPS = (0, 1, 4, 8)
LF_MAIN = (1, 4, 10000, 4)  # (opcode, chains, dim, n_steps) of gaussian_10k


def check_leapfrog_kernels(torch, lf_ops, lf_ref, spec_mod):
    """Both fused_leapfrog kernels against their plain versions: q, p, g at
    rtol 1e-5 + atol 1e-5 * max|plain| (nvcc contracts the updates into
    FMAs and torch does not; the difference compounds over the steps), the
    potential at 1e-5 * sum_i |v_i| (a float32 sum in another order), and
    bit-identical reruns; each kernel one launch a call with the counts
    read back at 0, the leapfrog's 0-step call returning the state bit for
    bit, and
    the state as views one float past a 16-byte boundary giving the bits of
    dense rows. Returns the worst abs error at the main path's shape for
    each kernel."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4321)
    worst = {"fused_leapfrog": 0.0, "fused_potential_vg": 0.0}
    n_cases = 0

    def close(name, got, want):
        check(bool(torch.isfinite(want).all()), f"{name}: plain version "
              "not finite (inputs out of range)")
        err = (got - want).abs()
        tol = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
        check(bool((err <= tol).all()), f"{name}: max abs err "
              f"{float(err.max()):.3e} beyond rtol 1e-5 + atol 1e-5*max")
        return float(err.max())

    def close_potential(name, spec, q, got, want):
        op, c0, c1, c2, c3 = spec.coeff_arrays(dev)
        abs_sum = spec_mod.potential_elem_value(
            op, c0, c1, c2, c3, q, uniform_op=spec.uniform_op).abs().sum(-1)
        err = (got - want).abs()
        check(bool((err <= 1e-5 * abs_sum + 1e-6).all()),
              f"{name}: potential err {float(err.max()):.3e} beyond "
              "1e-5 * sum|v|")
        return float(err.max())

    def offset(t):
        return torch.empty(t.numel() + 1, device=dev)[1:].view_as(t).copy_(t)

    main = torch.cuda.current_stream()
    for uop, run in LF_TABLES:
        for dim in LF_DIMS:
            spec = lf_ref.random_spec(dim, uop, seed=dim, run=run)
            for rows in LF_CHAINS:
                q = 0.5 * torch.randn(rows, dim, generator=gen, device=dev)
                p = 0.5 * torch.randn(rows, dim, generator=gen, device=dev)
                eps = 0.01 + 0.04 * torch.rand(rows, generator=gen, device=dev)
                im = 0.5 + torch.rand(dim, generator=gen, device=dev)
                tag = f"op {uop} run {run} {rows}x{dim}"
                before = lf_ops.LAUNCHES["fused_potential_vg"]
                lp, g = lf_ops.potential_value_and_grad(spec, q)
                check(lf_ops.LAUNCHES["fused_potential_vg"] == before + 1,
                      f"fused_potential_vg {tag}: not one launch a call")
                lp2, g2 = lf_ops.potential_value_and_grad(spec, q)
                want_lp, want_g = lf_ref.potential_value_and_grad_ref(spec, q)
                torch.cuda.synchronize()
                check(torch.equal(lp, lp2) and torch.equal(g, g2),
                      f"fused_potential_vg {tag}: two runs differ")
                check(lf_ops.leapfrog_parts(dim) == 1
                      or counts_at_zero(torch, main),
                      f"fused_potential_vg {tag}: counts not back at 0")
                errs = [close(f"fused_potential_vg {tag} grad", g, want_g),
                        close_potential(f"fused_potential_vg {tag}", spec, q,
                                        lp, want_lp)]
                if (uop, run, rows, dim) == (LF_MAIN[0], 1) + LF_MAIN[1:3]:
                    worst["fused_potential_vg"] = max(errs)
                n_cases += 1
                for mass in (None, im):
                    for n_steps in LF_STEPS:
                        before = lf_ops.LAUNCHES["fused_leapfrog"]
                        got = lf_ops.fused_leapfrog(spec, q, p, g, eps,
                                                    n_steps, inv_mass=mass)
                        t = f"fused_leapfrog {tag} n={n_steps} " \
                            f"mass={mass is not None}"
                        check(lf_ops.LAUNCHES["fused_leapfrog"] == before + 1,
                              f"{t}: not one launch a call")
                        again = lf_ops.fused_leapfrog(spec, q, p, g, eps,
                                                      n_steps, inv_mass=mass)
                        want = lf_ref.leapfrog_ref(spec, q, p, g, eps,
                                                   n_steps, inv_mass=mass)
                        torch.cuda.synchronize()
                        check(all(torch.equal(a, b)
                                  for a, b in zip(got, again)),
                              f"{t}: two runs differ")
                        check(lf_ops.leapfrog_parts(dim) == 1
                              or counts_at_zero(torch, main),
                              f"{t}: counts not back at 0")
                        if n_steps == 0:
                            check(all(torch.equal(a, b) for a, b in zip(
                                (got[0], got[1], got[3]), (q, p, g))),
                                  f"{t}: 0 steps changed the state")
                        errs = [close(f"{t} {k}", got[i], want[i])
                                for k, i in (("q", 0), ("p", 1), ("g", 3))]
                        errs.append(close_potential(t, spec, want[0],
                                                    got[2], want[2]))
                        if (uop, run, rows, dim, n_steps) == \
                                (LF_MAIN[0], 1) + LF_MAIN[1:] and mass is None:
                            worst["fused_leapfrog"] = max(errs)
                        n_cases += 1
                if rows == 4 and dim >= 1024:
                    views = [offset(t) for t in (q, p, g)]
                    check(all(torch.equal(a, b) for a, b in zip(
                        lf_ops.fused_leapfrog(spec, q, p, g, eps, 4),
                        lf_ops.fused_leapfrog(spec, *views, eps, 4))),
                          f"fused_leapfrog {tag}: offset views differ")
    log(f"fused_leapfrog kernels vs plain: {n_cases} cases "
        f"({len(LF_TABLES)} opcode tables x {len(LF_DIMS)} dims x "
        f"{len(LF_CHAINS)} chain counts; with and without inverse mass; "
        f"{LF_STEPS} steps), bit-identical reruns, one fused_leapfrog and "
        "one fused_potential_vg launch a call with the counts back at 0, "
        "offset views equal: ok; "
        f"worst abs err at 4x10,000: {worst}")
    return worst


# fused_potential_vg's merge path: (table, chains, dim) where a chain takes
# several blocks; "runs" is family_mix_8k's layout (one opcode for each 512
# coordinates)
POTENTIAL_MERGE = (("normal", 4, 10000), ("runs", 4, 8192),
                   ("normal", 1, 1_000_003), ("runs", 1, 1_000_003))
POTENTIAL_TABLES = {"normal": (1, 1), "runs": (None, 512)}


def check_potential_merge(torch, lf_ops, lf_ref):
    """fused_potential_vg where a chain takes several blocks (the last
    block of a chain merges), at gaussian_10k's and family_mix_8k's 4
    chains and at 1 x 1,000,003, from dense rows and from q shared by the
    chains at row stride 0: ONE_LAUNCH_RERUNS back-to-back calls
    bit-identical with the counts read back at 0; calls alternating with
    fused_leapfrog's on one stream (sharing its scratch) and calls
    alternating between two streams give the same bits, every count back
    at 0. The plain-version gates are check_leapfrog_kernels'."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(19)
    main = torch.cuda.current_stream()
    n_cases = 0
    for table, rows, dim in POTENTIAL_MERGE:
        uop, run = POTENTIAL_TABLES[table]
        spec = lf_ref.random_spec(dim, uop, seed=dim, run=run)
        q = 0.5 * torch.randn(rows, dim, generator=gen, device=dev)
        p = torch.randn(rows, dim, generator=gen, device=dev)
        for layout, u in (("dense", q), ("row stride 0",
                                         q[:1].expand(rows, dim))):
            tag = f"fused_potential_vg {table} {rows}x{dim} {layout}"
            check(lf_ops.leapfrog_parts(dim) > 1, f"{tag}: one block")

            def call(u=u, spec=spec):
                return lf_ops.potential_value_and_grad(spec, u)

            first = call()
            runs = [call() for _ in range(ONE_LAUNCH_RERUNS)]
            torch.cuda.synchronize()
            check(all(same_bits(torch, a[0], first[0])
                      and same_bits(torch, a[1], first[1]) for a in runs),
                  f"{tag}: {ONE_LAUNCH_RERUNS} reruns not bit-identical")
            check(counts_at_zero(torch, main), f"{tag}: counts not back at 0")
            del runs
            mixed = []
            for _ in range(10):
                lf_ops.fused_leapfrog(spec, u, p, first[1], 0.01, 4)
                mixed.append(call())
            torch.cuda.synchronize()
            check(all(same_bits(torch, a[0], first[0])
                      and same_bits(torch, a[1], first[1]) for a in mixed),
                  f"{tag}: calls alternating with fused_leapfrog differ")
            check(counts_at_zero(torch, main), f"{tag}: counts not back at 0 "
                  "after the leapfrog's")
            streams = (torch.cuda.Stream(), torch.cuda.Stream())
            for s in streams:
                s.wait_stream(main)
            alt = []
            for i in range(20):
                with torch.cuda.stream(streams[i % 2]):
                    alt.append(call())
            for s in streams:
                main.wait_stream(s)
            check(all(counts_at_zero(torch, s) for s in streams),
                  f"{tag}: counts of the two streams not back at 0")
            check(all(same_bits(torch, a[0], first[0])
                      and same_bits(torch, a[1], first[1]) for a in alt),
                  f"{tag}: calls on two streams differ")
            n_cases += 1
    log(f"fused_potential_vg merge path: {n_cases} cases "
        f"({POTENTIAL_MERGE}, dense and row stride 0), "
        f"{ONE_LAUNCH_RERUNS} back-to-back calls bit-identical, counts read "
        "back at 0, alternating with fused_leapfrog and between two "
        "streams the same bits: ok")


# ---------------------------------------------------------------------------
# phases 4-6: the main paths
# ---------------------------------------------------------------------------
# launches of each fused_logpdf kernel per log-density evaluation (the
# fused evaluators send one block per family and per observed/unobserved)
PER_EVAL = {"logreg": {"std_normal_sum": 1, "bernoulli_logit_sum": 1},
            "naive_bayes": {"std_normal_sum": 2},
            "gaussian_10k": {"std_normal_sum": 1},
            "hier_poisson": {"std_normal_sum": 1, "gamma_unnorm_sum": 1},
            # one block per class count: C = 5 (transitions), 20 (emissions)
            # (both C <= 256: the small-C path)
            "hmm_semisup": {"categorical_logits_sum_small": 2},
            "lda": {"categorical_logits_sum_small": 1},
            # the prior block (m) and the likelihood block (y)
            "gauss_unknown": {"std_normal_sum": 2},
            # the per-site evaluator with the per-array switch on: the
            # 10,000 observations, once for all chains
            "gauss_unknown_switch": {"normal_sum": 1},
            # the prior block (mu and h_std) and the likelihood block (y)
            "sto_volatility": {"std_normal_sum": 2},
            # the prior block (mu and theta; tau's HalfNormal has no
            # family) and the likelihood block (y)
            "eight_schools": {"std_normal_sum": 2},
            "family_mix_8k": {"std_normal_sum": 1, "gamma_unnorm_sum": 1,
                              "beta_unnorm_sum": 1,
                              "student_t_unnorm_sum": 1},
            "mixed": {"std_normal_sum": 1, "gamma_unnorm_sum": 1,
                      "beta_unnorm_sum": 1, "student_t_unnorm_sum": 1,
                      "mvn_quadform_sum": 1}}
# the potential compiler's log-density evaluations (core/potential.py
# _build and _build_cond): for a compile that reaches its probes (a
# separable or a conditional one), the value at the recorded point, then a
# value and a gradient at each of two probe points, whatever the verdict;
# a model whose dependency graph rules both out is rejected before the
# first (logreg, naive_bayes, hier_poisson, sto_volatility: coupled
# through likelihoods no leaf can attach; hmm_semisup, lda: simplex sites;
# mixed: MvNormal has no opcode). Each runs the fused forward once; the
# gradient's backward launches nothing. The graph build and the
# conditional spec's replays run on the plain evaluator and launch nothing.
PROBE_EVALS = {"logreg": 0, "naive_bayes": 0, "gaussian_10k": 5,
               "hier_poisson": 0, "hmm_semisup": 0, "lda": 0,
               "gauss_unknown": 5, "gauss_unknown_switch": 5,
               "sto_volatility": 0, "mixed": 0, "family_mix_8k": 5,
               "eight_schools": 5}
# on the switch route the observed block is also evaluated eagerly, once
# by the discovery run when run_chains draws the start itself (the switch
# route runs the autodiff integrator, leapfrog="reference", so that
# normal_sum stays on its transitions: the conditional spec would attach
# y to m and evaluate no Normal block)
EAGER_EVALS = {"gauss_unknown_switch": 1}
SEPARABLE = ("gaussian_10k", "family_mix_8k")  # the compiler accepts these
# leapfrog="auto" runs these on the conditional spec: plain torch, no
# kernel launch in a transition (ROADMAP Queue 1 item 5)
CONDITIONAL = ("gauss_unknown", "eight_schools")
# where the chains start (run_chains' init_varinfo and init_jitter): the
# prior draw with jitter 1, except (no warmup in Table 1, so a start where
# every fixed-step transition diverges never moves):
# - hier_poisson, whose prior draw of a0 ~ Normal(0, 10) lands at such
#   log-rates, and sto_volatility, whose prior draws of sigma (HalfCauchy)
#   and phi near +-1 do: the unconstrained origin (Stan's init=0), with
#   the usual jitter;
# - gauss_unknown, whose 10,000 observations give a posterior sd of 0.007
#   in m, below the fixed step 0.01 times the gradient anywhere else: the
#   data's moments (s = var(y), m = mean(y)), with jitter 0.05
START = {"hier_poisson": ("origin", 1.0), "sto_volatility": ("origin", 1.0),
         "gauss_unknown": ("moments", 0.05)}
# draws per chain on each main path (Table 1: 2000). The whole script must
# stay within 600 s; the cuts, and why, are in PERF.md section 4.
DRAWS = {"logreg": 300, "naive_bayes": 300, "gaussian_10k": 2000,
         "hier_poisson": 500, "hmm_semisup": 100, "lda": 500,
         "gauss_unknown": 1000, "gauss_unknown_switch": 1000,
         "sto_volatility": 500, "family_mix_8k": 1000, "mixed": 500,
         "eight_schools": 1000}


def run_model(torch, name, num_samples, seed=0, leapfrog="auto",
              route="fused"):
    """Drive one main path through ``run_chains`` with every launch count
    set to 0 just before and read just after, and check the counts
    exactly: the compiler's probes, the switch route's eager evaluations,
    then one launch per density block per evaluation (autodiff integrator)
    or one fused leapfrog per transition and one fused potential at init
    (fused integrator, which ``leapfrog="auto"`` must pick for the
    separable models and only for them). ``route="switch"`` runs the
    per-site evaluator (``backend="reference"``) inside
    ``use_fused_logpdf()``."""
    import contextlib

    from repro_torch.kernels import use_fused_logpdf

    with (use_fused_logpdf() if route == "switch"
          else contextlib.nullcontext()):
        return _run_model(torch, name, num_samples, seed, leapfrog, route)


def build_model(name):
    """A paper model, or one of ``repro_torch.models.family_mix``'s."""
    from repro_torch.models import SYNTHETIC_NAMES, build, build_synthetic
    return (build_synthetic if name in SYNTHETIC_NAMES else build)(
        name, device=DEVICE)


def start_point(torch, np, pm, seed):
    """(init_varinfo, init_jitter) for ``run_chains``, as START says."""
    how, jitter = START.get(pm.name, ("prior", 1.0))
    if how == "prior":
        return None, jitter
    linked = pm.model.typed_varinfo(
        torch.Generator(device=DEVICE).manual_seed(seed)).link()
    if how == "origin":
        flat = torch.zeros(linked.num_flat, device=DEVICE)
    else:  # gauss_unknown's layout: u_s = log s, then m
        y = pm.data["y"].astype(np.float64)
        flat = torch.tensor([np.log(y.var()), y.mean()], dtype=torch.float32,
                            device=DEVICE)
    return linked.replace_flat(flat).invlink(), jitter


def _run_model(torch, name, num_samples, seed, leapfrog, route):
    import numpy as np

    from repro_torch.infer import HMC, run_chains
    from repro_torch.kernels.fused_leapfrog import ops as lf_ops
    from repro_torch.kernels.fused_logpdf import ops

    pm = build_model(name)
    key = name if route == "fused" else f"{name}_{route}"
    backend = "reference" if route == "switch" else "fused"
    kernel = HMC(step_size=pm.step_size, n_leapfrog=pm.n_leapfrog,
                 leapfrog=leapfrog)
    num_chains = 4
    init, jitter = start_point(torch, np, pm, seed)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    lf_ops.reset_launch_counts()
    t0 = time.perf_counter()
    chain = run_chains(seed, pm.model, kernel, num_samples,
                       num_chains=num_chains, device=DEVICE,
                       init_varinfo=init, init_jitter=jitter, backend=backend)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {**ops.LAUNCHES, **lf_ops.LAUNCHES}

    evals = num_samples * pm.n_leapfrog + 1  # + the initial gradient
    fused = kernel.uses_potential_spec and name in SEPARABLE
    # the conditional integrator is plain torch: no launch a transition
    cond = (kernel.uses_potential_spec and name in CONDITIONAL
            and route == "fused")
    integrator = "fused" if fused else "conditional" if cond else "autodiff"
    want = dict.fromkeys(launches, 0)
    probes = PROBE_EVALS[key] if kernel.uses_potential_spec else 0
    eager = EAGER_EVALS.get(key, 0) * (init is None)
    for k, per in PER_EVAL[key].items():
        want[k] += per * (eager + probes + (0 if fused or cond else evals))
    if fused:
        want["fused_leapfrog"] = num_samples  # no warmup in Table 1
        want["fused_potential_vg"] = 1
    check(launches == want,
          f"{key} ({leapfrog}): launches {launches}, expected {want} "
          f"({probes} compiler probe evaluations, {eager} eager, "
          f"{integrator} integrator)")

    logp = chain.stats["logp"]
    acc = float(chain.stats["accept_prob"].mean())
    acc_chains = [float(a) for a in chain.stats["accept_prob"].mean(axis=1)]
    for site in chain.names():
        check(np.isfinite(chain[site]).all(),
              f"{key}: non-finite draws of '{site}'")
    check(np.isfinite(logp).all(), f"{key}: non-finite logp")
    check(0.0 < acc <= 1.0, f"{key}: mean acceptance {acc} not in (0, 1]")

    simplex = {}
    for s in pm.model.typed_varinfo(
            torch.Generator(device=DEVICE).manual_seed(seed)).layout.sites:
        if s.support == "simplex":
            x = chain[s.name]
            dev1 = float(np.abs(x.sum(-1, dtype=np.float64) - 1.0).max())
            check(bool((x >= 0).all()) and dev1 <= 1e-5,
                  f"{key}: simplex draws of '{s.name}' off the simplex "
                  f"(min {float(x.min()):.3e}, max |row sum - 1| {dev1:.3e})")
            simplex[s.name] = {"min": float(x.min()), "max_row_sum_dev": dev1}

    rel = final_draw_density(torch, pm, chain, seed)

    summary = chain.summary().splitlines()
    result = {
        "model": name, "route": route, "backend": backend,
        "leapfrog": leapfrog,
        "integrator": integrator,
        "compiler_probe_evals": probes, "eager_evals": eager,
        "num_chains": num_chains, "num_samples": num_samples,
        "step_size": pm.step_size, "n_leapfrog": pm.n_leapfrog,
        "seconds": secs, "seconds_per_draw": secs / num_samples,
        "grad_evals_per_s": num_chains * evals / secs,
        "launches": launches, "evals_per_chain": evals,
        "mean_accept": acc, "accept_per_chain": acc_chains,
        "start": START.get(name, ("prior draw", 1.0))[0],
        "fused_vs_reference_max_rel": rel,
        "simplex": simplex, "summary_head": summary[:4],
    }
    log(f"{key} ({leapfrog}: {result['integrator']} integrator, {backend} "
        f"evaluator): {num_chains} chains x {num_samples} draws in "
        f"{secs:.2f} s: {secs / num_samples * 1e3:.3f} ms/draw, "
        f"{result['grad_evals_per_s']:.0f} grad evals/s, mean accept "
        f"{acc:.3f} (per chain {', '.join(f'{a:.3f}' for a in acc_chains)}), "
        f"launches {launches}, fused vs reference density max rel {rel:.2e}")
    for line in summary[:4]:
        log("   ", line)
    return result, pm, kernel, chain


def final_states(torch, pm, chain, seed=0):
    """(the linked trace, the chains' final draws linked back through each
    site's bijector, the stick-breaking inverse for simplex rows, to the
    unconstrained flat state ``(num_chains, dim)``)."""
    from repro_torch.bijectors import bijector_for

    tvi = pm.model.typed_varinfo(
        torch.Generator(device=DEVICE).manual_seed(seed)).link()
    q = torch.cat([
        bijector_for(d).inverse(torch.as_tensor(chain[s.name][:, -1],
                                                device=DEVICE))
        .reshape(chain.num_chains, -1)
        for s, d in zip(tvi.layout.sites, tvi.dists)], dim=1)
    return tvi, q


def final_draw_density(torch, pm, chain, seed=0):
    """The density at the final draws on the fused and the per-site
    evaluators (the per-site one through the per-array kernel on the
    switch route) vs the hand-written twin and the chain's logp (rtol
    1e-5), on the card, at :func:`final_states`; returns max |fused -
    per-site| / |per-site|."""
    tvi, q = final_states(torch, pm, chain, seed)
    fused_d = torch.func.vmap(pm.model.make_logdensity_fn(tvi))(q)
    refd = torch.func.vmap(pm.model.make_logdensity_fn(
        tvi, backend="reference"))(q)
    torch.testing.assert_close(fused_d, refd, rtol=1e-5, atol=0)
    if pm.handwritten is not None:
        hand = torch.func.vmap(pm.handwritten)(q)
        torch.testing.assert_close(fused_d, hand, rtol=1e-5, atol=0)
    torch.testing.assert_close(
        fused_d.cpu(), torch.as_tensor(chain.stats["logp"][:, -1]),
        rtol=1e-5, atol=0)
    return float(((fused_d - refd).abs() / refd.abs()).max())


def check_first_draws(np, name, chain, ref_chain, first=10, rtol=0.0):
    """The first draws of the fused and the reference integrator (same
    seed, same generator draws) together: every draw within 1e-4 + rtol *
    |draw| (atol 1e-4 alone for gaussian_10k), logp at rtol 1e-5."""
    d = max(float((np.abs(chain[s][:, :first] - ref_chain[s][:, :first])
                   - rtol * np.abs(ref_chain[s][:, :first])).max())
            for s in chain.names())
    lp, lp_ref = chain.stats["logp"][:, :first], ref_chain.stats["logp"][:, :first]
    lp_rel = float((np.abs(lp - lp_ref) / np.abs(lp_ref)).max())
    check(d <= 1e-4 and lp_rel <= 1e-5,
          f"{name}: first {first} draws of the fused and reference "
          f"integrators differ: max abs {d:.3e} beyond 1e-4 + {rtol} * "
          f"|draw|, logp max rel {lp_rel:.3e} (rtol 1e-5)")
    return {"first_draws": first, "fused_vs_reference_draws_max_abs": d,
            "fused_vs_reference_logp_max_rel": lp_rel}


def check_gaussian(np, chain, ref_chain, first=10):
    """gaussian_10k: the moments of :func:`gaussian_moments`; and the first
    draws of the fused and the reference integrator (same seed, same
    generator draws) together."""
    out = gaussian_moments(np, chain)
    out.update(check_first_draws(np, "gaussian_10k", chain, ref_chain,
                                 first))
    d = out["fused_vs_reference_draws_max_abs"]
    lp_rel = out["fused_vs_reference_logp_max_rel"]
    log(f"gaussian_10k first {first} draws fused vs reference: max abs "
        f"{d:.2e}, logp max rel {lp_rel:.2e}")
    return out


def gaussian_moments(np, chain, label="gaussian_10k"):
    """gaussian_10k: every coordinate's posterior mean within 5.5 Monte-Carlo
    standard errors of 0 (sd 1/sqrt(ESS of x)) and its variance within 5.5
    of 1 (sd sqrt(2/ESS of x^2))."""
    from repro_torch.infer import effective_sample_size

    x = chain["x"].astype(np.float64)  # (chains, draws, dim)
    dim = x.shape[-1]
    mean = x.mean(axis=(0, 1))
    var = x.var(axis=(0, 1))
    ess = np.array([effective_sample_size(x[:, :, i]) for i in range(dim)])
    ess2 = np.array([effective_sample_size(x[:, :, i] ** 2)
                     for i in range(dim)])
    z_mean = mean * np.sqrt(ess)
    z_var = (var - 1.0) / np.sqrt(2.0 / ess2)
    out = {"ess_median": float(np.median(ess)),
           "ess_min": float(ess.min()),
           "ess_sq_median": float(np.median(ess2)),
           "max_abs_z_mean": float(np.abs(z_mean).max()),
           "max_abs_z_var": float(np.abs(z_var).max()),
           "mean_abs_mean": float(np.abs(mean).mean()),
           "mean_var": float(var.mean())}
    check(np.isfinite(ess).all() and np.isfinite(ess2).all(),
          f"{label}: ESS not finite")
    check(out["max_abs_z_mean"] < 5.5 and out["max_abs_z_var"] < 5.5,
          f"{label}: posterior moments off: {out}")
    log(f"{label} moments: ESS median {out['ess_median']:.0f} (min "
        f"{out['ess_min']:.0f}, x^2 median {out['ess_sq_median']:.0f}); max "
        f"|z| of the {dim:,} means {out['max_abs_z_mean']:.2f}, of the "
        f"variances {out['max_abs_z_var']:.2f} (limit 5.5)")
    return out


def check_gauss_unknown(np, pm, chain):
    """gauss_unknown's conjugate posterior: with s ~ InvGamma(2, 3), m | s ~
    N(0, s) and y_i | m, s ~ N(m, s), E[m | y] = n ybar / (n + 1) and s | y
    ~ InvGamma(2 + n/2, 3 + (sum y^2 - (n ybar)^2 / (n + 1)) / 2). The
    draws' means of m and s within 5.5 Monte-Carlo standard errors (sd of
    the draws over sqrt(ESS)) of those."""
    from repro_torch.infer import effective_sample_size

    y = pm.data["y"].astype(np.float64)
    n = y.size
    a_post = 2.0 + n / 2.0
    b_post = 3.0 + 0.5 * (np.sum(y * y) - (n * y.mean()) ** 2 / (n + 1))
    exact = {"m": n * y.mean() / (n + 1), "s": b_post / (a_post - 1.0)}
    out = {}
    for site, want in exact.items():
        x = chain[site].astype(np.float64)
        ess = effective_sample_size(x)
        z = (x.mean() - want) / (x.std() / np.sqrt(ess))
        out[site] = {"mean": float(x.mean()), "exact": float(want),
                     "ess": float(ess), "z": float(z)}
        check(np.isfinite(z) and abs(z) < 5.5,
              f"gauss_unknown: posterior mean of {site} {x.mean():.6f}, "
              f"exact {want:.6f}: {z:.2f} Monte-Carlo standard errors "
              f"(ESS {ess:.0f}), limit 5.5")
    log("gauss_unknown posterior means vs the conjugate posterior: "
        + ", ".join(f"{k} {v['mean']:.5f} (exact {v['exact']:.5f}, "
                    f"{v['z']:+.2f} se, ESS {v['ess']:.0f})"
                    for k, v in out.items()))
    return out


# family_mix_8k's sites in their flat order, each one's opcode and
# coefficients as a float64 fold of the model's parameters gives them (the
# link's log-Jacobian folded in, as core/potential.py _compile_site), and
# the u-independent rest of one element's log-density: Normal(0, 2) -log 2
# - log(2 pi)/2; Gamma(2, 1.5) 2 log 1.5 - lgamma(2); Beta(2, 3) lgamma(5)
# - lgamma(2) - lgamma(3); StudentT(4, 0, 1) lgamma(5/2) - lgamma(2) -
# log(4 pi)/2; Cauchy(0, 2) -log(2 pi); Uniform(-1, 1) -log 2 + log 2 (the
# link's width); LogNormal(0, 1) -log(2 pi)/2
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
FAMILY_MIX_TABLE = (  # (site, size, opcode name, c0, c1, c2, c3, rest)
    ("n", 2048, "OP_NORMAL", 0.0, 1.0 / 2.0, 0.0, 0.0,
     -math.log(2.0) - _HALF_LOG_2PI),
    ("g", 1024, "OP_EXP", 2.0, 1.5, 1.0, 0.0,
     2.0 * math.log(1.5) - math.lgamma(2.0)),
    ("b", 1024, "OP_SOFTPLUS", 2.0, 3.0, 0.0, 0.0,
     math.lgamma(5.0) - math.lgamma(2.0) - math.lgamma(3.0)),
    ("t", 2048, "OP_TLOG", (4.0 + 1.0) / 2.0, 1.0 / 4.0, 0.0, 1.0,
     math.lgamma(2.5) - math.lgamma(2.0) - 0.5 * math.log(4.0 * math.pi)),
    ("c", 1024, "OP_TLOG", 1.0, 1.0, 0.0, 1.0 / 2.0,
     -math.log(2.0 * math.pi)),
    ("u", 512, "OP_SOFTPLUS", 1.0, 1.0, 0.0, 0.0, 0.0),
    ("l", 512, "OP_NORMAL", 0.0, 1.0, 0.0, 0.0, -_HALF_LOG_2PI))


def check_family_mix_spec(torch, np, spec_mod, lf_ops, spec, pm, chain):
    """The spec run_chains compiled for family_mix_8k against
    FAMILY_MIX_TABLE: opcodes equal, coefficients at atol 1e-6, const at
    rtol 1e-5; and its value (the fused potential, const included) at the
    final draws equal to the fused log-density at rtol 1e-5."""
    check(spec is not None and spec.uniform_op is None and spec.dim == 8192,
          f"family_mix_8k did not compile to a mixed spec of dim 8,192: "
          f"{spec}")
    op = np.concatenate([np.full(size, getattr(spec_mod, code), np.int32)
                         for _, size, code, *_ in FAMILY_MIX_TABLE])
    coeffs = [np.concatenate([np.full(size, c[k])
                              for _, size, _, *c in FAMILY_MIX_TABLE])
              for k in range(4)]
    const = sum(size * rest for _, size, *_, rest in FAMILY_MIX_TABLE)
    check(abs(spec.const - const) <= 1e-5 * abs(const),
          f"family_mix_8k: const {spec.const:.6f}, the model's {const:.6f}")
    check(np.array_equal(spec.op, op), "family_mix_8k: opcodes differ "
          "from the model's")
    for name, got, exp in zip(("c0", "c1", "c2", "c3"),
                              (spec.c0, spec.c1, spec.c2, spec.c3), coeffs):
        err = float(np.abs(np.asarray(got, np.float64) - exp).max())
        check(err <= 1e-6, f"family_mix_8k: {name} off by {err:.3e}")
    tvi = pm.model.typed_varinfo(
        torch.Generator(device=DEVICE).manual_seed(0)).link()
    names = [s.name for s in tvi.layout.sites]
    check(names == [t[0] for t in FAMILY_MIX_TABLE],
          f"family_mix_8k: flat order {names}")
    from repro_torch.bijectors import bijector_for
    q = torch.cat([bijector_for(d).inverse(torch.as_tensor(
        chain[s.name][:, -1], device=DEVICE)).reshape(4, -1)
        for s, d in zip(tvi.layout.sites, tvi.dists)], dim=1)
    lp, _ = lf_ops.potential_value_and_grad(spec, q)
    dens = torch.func.vmap(pm.model.make_logdensity_fn(tvi))(q)
    torch.testing.assert_close(lp, dens, rtol=1e-5, atol=0)
    out = {"dim": spec.dim, "const": float(spec.const),
           "const_from_the_model": const,
           "spec_vs_density_max_rel": float(
               ((lp - dens).abs() / dens.abs()).max())}
    log(f"family_mix_8k spec: opcodes and coefficients as the model's, "
        f"const {spec.const:.6f} (the model's {const:.6f}); spec vs density "
        f"at the final draws max "
        f"rel {out['spec_vs_density_max_rel']:.2e}")
    return out


# ---------------------------------------------------------------------------
# phase 6b: NUTS, the other samplers and Table 1
# ---------------------------------------------------------------------------
# (warmup, draws, max_depth) of each NUTS path, 4 chains; logreg's trees
# are capped at depth 7 (127 leaves) for the time of its warmup from the
# prior draw
NUTS_RUNS = {"gaussian_10k": (100, 200, 10), "logreg": (40, 70, 7)}
# the HMC chains that logreg's NUTS means are held to: (warmup, draws,
# leapfrog steps), 4 chains with dual averaging from a Uniform(-0.1, 0.1)
# jitter around the port's MAP mode (MAP_STEPS of Adam), none of it from
# NUTS; every coordinate's split R-hat must stay under HMC_REF_RHAT
NUTS_HMC_REF = (40, 150, 8)
NUTS_TIMED = (10, 20)  # warmup, draws of nuts_timed's runs
MAP_STEPS = 300
HMC_REF_RHAT = 1.1
# Table 1 (benchmarks/table1.py's three variants of one chain), in
# TABLE1_REPS alternating repetitions: (typed and hand-written draws, each
# timed after one warm-up call of 2; untyped draws, its loop alone: a
# 1-draw run subtracted from a (1 + n)-draw run); hmm_semisup's transition
# takes hundreds of ms and lda's ~100 ms for the three, so theirs are cut
TABLE1_DRAWS = {"hmm_semisup": (3, 1), "lda": (15, 8)}
TABLE1_DEFAULT = (20, 10)
TABLE1_REPS = 3
TABLE1_EAGER = ("logreg",)  # the chains also timed with capture off


def counts_reset(torch):
    """Every launch count and the NUTS tree counts set to 0, the card idle."""
    from repro_torch.infer import nuts as nuts_mod
    from repro_torch.kernels.fused_leapfrog import ops as lf_ops
    from repro_torch.kernels.fused_logpdf import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    lf_ops.reset_launch_counts()
    nuts_mod.reset_tree_counts()


def counts_read(torch):
    """(launches, NUTS tree counts) since :func:`counts_reset`."""
    from repro_torch.infer import nuts as nuts_mod
    from repro_torch.kernels.fused_leapfrog import ops as lf_ops
    from repro_torch.kernels.fused_logpdf import ops
    torch.cuda.synchronize()
    return {**ops.LAUNCHES, **lf_ops.LAUNCHES}, dict(nuts_mod.TREE_COUNTS)


def nuts_path(torch, np, name, seed=0):
    """NUTS on one paper model through ``run_chains``: 4 chains from the
    prior draw with jitter 1, dual-averaging warmup, counted. The launches
    must be the compiler's probe evaluations plus one evaluation per
    lockstep leaf iteration and one at chain init: ``fused_potential_vg``
    on a separable spec (gaussian_10k, whose moments are then gated as
    phase 6's), the density blocks' kernels otherwise (logreg, whose
    final-draw densities are then held to the per-site evaluator, the
    hand-written twin and the chain's logp at rtol 1e-5, and whose means
    to the port's own HMC within 5.5 Monte-Carlo standard errors: the
    chains of :func:`hmc_reference`, which take nothing from NUTS)."""
    from repro_torch.infer import NUTS, run_chains

    warmup, draws, depth = NUTS_RUNS[name]
    pm = build_model(name)
    kernel = NUTS(step_size=pm.step_size, max_depth=depth)
    counts_reset(torch)
    t0 = time.perf_counter()
    chain = run_chains(seed, pm.model, kernel, draws, num_warmup=warmup,
                       num_chains=4, device=DEVICE)
    launches, tree = counts_read(torch)
    secs = time.perf_counter() - t0
    trees = warmup + draws
    check(tree["trees"] == trees, f"NUTS {name}: {tree['trees']} trees, "
          f"expected {trees}")
    evals = tree["leaf_iterations"] + 1  # + the chain init
    fused = name in SEPARABLE
    want = dict.fromkeys(launches, 0)
    for k, per in PER_EVAL[name].items():
        want[k] += per * (PROBE_EVALS[name] + (0 if fused else evals))
    if fused:
        want["fused_potential_vg"] = evals
    check(launches == want, f"NUTS {name}: launches {launches}, expected "
          f"{want} ({tree['leaf_iterations']} lockstep leaf iterations)")
    for site in chain.names():
        check(np.isfinite(chain[site]).all(),
              f"NUTS {name}: non-finite draws of '{site}'")
    check(np.isfinite(chain.stats["logp"]).all(), f"NUTS {name}: "
          "non-finite logp")
    depth_mean = float(chain.stats["tree_depth"].mean())
    check(tree["draws"] == draws, f"NUTS {name}: {tree['draws']} draws")
    out = {"model": name, "num_chains": 4, "num_warmup": warmup,
           "num_samples": draws, "max_depth": depth, "seconds": secs,
           "seconds_per_transition": secs / trees, "launches": launches,
           "trees": trees, "leaf_iterations": tree["leaf_iterations"],
           "leaf_iterations_per_transition": tree["leaf_iterations"] / trees,
           "host_syncs_per_transition": tree["host_syncs"] / trees,
           # the sampling draws alone (warmup's trees start deeper)
           "leaf_iterations_per_draw": tree["draw_leaf_iterations"] / draws,
           "host_syncs_per_draw": tree["draw_host_syncs"] / draws,
           "mean_tree_depth": depth_mean,
           "mean_accept": float(chain.stats["accept_prob"].mean()),
           "divergences": int(chain.stats["diverging"].sum())}
    if fused:
        # one launch a leaf iteration: the sampling draws' own
        out["potential_launches_per_draw"] = out["leaf_iterations_per_draw"]
        out.update(gaussian_moments(np, chain, label=f"NUTS {name}"))
    else:
        out["final_density_max_rel"] = final_draw_density(torch, pm, chain,
                                                          seed)
        ref, out["hmc_reference"] = hmc_reference(torch, np, pm, seed)
        out["max_abs_z_vs_hmc"] = compare_means(np, name, chain, ref)
    out["timed"] = nuts_timed(torch, pm, kernel, seed)
    log(f"NUTS {name}: 4 chains x ({warmup} warmup + {draws}) draws in "
        f"{secs:.2f} s ({secs / trees * 1e3:.2f} ms a transition); sampling "
        f"draws: mean tree depth {depth_mean:.2f}, "
        f"{out['leaf_iterations_per_draw']:.2f} lockstep leaf iterations "
        f"and {out['host_syncs_per_draw']:.2f} host syncs a draw (warmup "
        f"included: {out['leaf_iterations_per_transition']:.2f} and "
        f"{out['host_syncs_per_transition']:.2f}); mean accept "
        f"{out['mean_accept']:.3f}, {out['divergences']} divergent; "
        f"launches {launches}"
        + (f"; fused_potential_vg {out['potential_launches_per_draw']:.2f} "
           "launches a draw" if fused else ""))
    return out, chain


def nuts_timed(torch, pm, kernel, seed=0):
    """ms a transition and a lockstep leaf iteration of NUTS on ``pm``,
    replayed (the leaf programs captured by the run before) and under
    ``disable_capture()``, in turns: ``NUTS_TIMED`` warmup and draws of 4
    chains each, host clock, synchronised."""
    from repro_torch.core.program import disable_capture
    from repro_torch.infer import run_chains
    from repro_torch.infer import nuts as nuts_mod

    warm, draws = NUTS_TIMED
    res = {}
    for mode in ("replayed", "eager", "replayed", "eager"):
        torch.cuda.synchronize()
        nuts_mod.reset_tree_counts()
        t0 = time.perf_counter()
        with (disable_capture() if mode == "eager"
              else contextlib.nullcontext()):
            run_chains(seed + 1, pm.model, kernel, draws, num_warmup=warm,
                       num_chains=4, device=DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        tree = dict(nuts_mod.TREE_COUNTS)
        res.setdefault(mode, []).append({
            "ms_per_transition": secs * 1e3 / tree["trees"],
            "ms_per_leaf_iteration": secs * 1e3 / tree["leaf_iterations"],
            "leaf_iterations_per_transition":
                tree["leaf_iterations"] / tree["trees"],
            "host_syncs_per_transition": tree["host_syncs"] / tree["trees"]})
    for mode, runs in res.items():
        log(f"NUTS {pm.name} {mode}: "
            + ", ".join(f"{r['ms_per_transition']:.3f} ms a transition, "
                        f"{r['ms_per_leaf_iteration']:.3f} ms a leaf "
                        f"iteration ({r['leaf_iterations_per_transition']:.2f}"
                        " a transition)" for r in runs))
    return res


def hmc_reference(torch, np, pm, seed=0):
    """The port's HMC on ``pm``, independent of NUTS: the port's MAP mode
    (``MAP_STEPS`` of Adam from 0), then 4 chains from a Uniform(-0.1, 0.1)
    jitter around it (overdispersed: logreg's posterior sds are ~0.02),
    ``NUTS_HMC_REF`` = (warmup with dual averaging, draws, leapfrog steps)
    through ``run_chains``. Fails unless every coordinate's split R-hat is
    under ``HMC_REF_RHAT``. Returns the chain and its summary."""
    from repro_torch.infer import (HMC, MAP, effective_sample_size,
                                   run_chains, split_rhat)

    warmup, draws, n_leapfrog = NUTS_HMC_REF
    t0 = time.perf_counter()
    est, losses = MAP(num_steps=MAP_STEPS).run(seed, pm.model, device=DEVICE)
    tvi = pm.model.typed_varinfo(
        torch.Generator(device=DEVICE).manual_seed(seed))
    mode = tvi.replace_values(tuple(
        torch.as_tensor(est[mt.name], device=DEVICE).reshape(mt.shape)
        for mt in tvi.metas))
    kern = HMC(step_size=pm.step_size, n_leapfrog=n_leapfrog,
               adapt_step_size=True)
    chain = run_chains(seed + 1, pm.model, kern, draws, num_warmup=warmup,
                       num_chains=4, init_varinfo=mode, init_jitter=0.1,
                       device=DEVICE)
    secs = time.perf_counter() - t0
    rhat, ess = [], []
    for site in chain.names():
        x = chain[site].astype(np.float64)
        x = x.reshape(x.shape[:2] + (-1,))
        for i in range(x.shape[-1]):
            rhat.append(split_rhat(x[..., i]))
            ess.append(effective_sample_size(x[..., i]))
    out = {"map_steps": MAP_STEPS, "map_loss_first": float(losses[0]),
           "map_loss_last": float(losses[-1]), "num_warmup": warmup,
           "num_samples": draws, "n_leapfrog": n_leapfrog,
           "max_split_rhat": float(max(rhat)), "min_ess": float(min(ess)),
           "mean_accept": float(chain.stats["accept_prob"].mean()),
           "seconds": secs}
    check(np.isfinite(rhat).all() and max(rhat) < HMC_REF_RHAT,
          f"HMC reference on {pm.name}: split R-hat up to {max(rhat):.3f}, "
          f"limit {HMC_REF_RHAT}")
    log(f"HMC reference on {pm.name}: MAP loss {losses[0]:.1f} -> "
        f"{losses[-1]:.1f}; 4 chains x ({warmup} warmup + {draws}) draws of "
        f"{n_leapfrog} leapfrog steps in {secs:.2f} s; split R-hat <= "
        f"{max(rhat):.4f}, ESS >= {min(ess):.1f}, mean accept "
        f"{out['mean_accept']:.3f}")
    return chain, out


def compare_means(np, name, chain, other, n_se=5.5):
    """Every coordinate's posterior mean of ``chain`` against ``other``'s
    within ``n_se`` Monte-Carlo standard errors of the difference (each sd
    over sqrt(ESS)); returns the largest |z|."""
    from repro_torch.infer import effective_sample_size

    worst = 0.0
    for site in chain.names():
        a = chain[site].astype(np.float64)
        b = other[site].astype(np.float64)
        a = a.reshape(a.shape[:2] + (-1,))
        b = b.reshape(b.shape[:2] + (-1,))
        for i in range(a.shape[-1]):
            se = [x[..., i].std() / np.sqrt(effective_sample_size(x[..., i]))
                  for x in (a, b)]
            z = (a[..., i].mean() - b[..., i].mean()) / np.hypot(*se)
            check(np.isfinite(z) and abs(z) < n_se,
                  f"NUTS {name}: mean of {site}[{i}] {a[..., i].mean():.5f} "
                  f"vs HMC's {b[..., i].mean():.5f}: {z:.2f} standard "
                  f"errors, limit {n_se}")
            worst = max(worst, abs(float(z)))
    log(f"NUTS {name}: means vs the port's HMC reference chains: max "
        f"|z| {worst:.2f} (limit {n_se})")
    return worst


def _gauss_models(torch, np):
    """The models of tests/test_infer.py (mu, s; 200 observations of N(2,
    1)) and tests/test_sharded_chains.py (a mean under 128 observations of
    N(-1, 0.5); SGLD's under 64 of N(2, 1)), data on the card."""
    from repro_torch import model, observe, sample
    from repro_torch.dists import HalfNormal, Normal

    np.random.seed(0)
    y200 = np.random.normal(2.0, 1.0, size=200).astype(np.float32)
    y128 = np.random.default_rng(1).normal(-1.0, 0.5, 128).astype(np.float32)
    y64 = np.random.default_rng(0).normal(2.0, 1.0, 64).astype(np.float32)

    @model
    def gauss(y):
        mu = sample("mu", Normal(0.0, 10.0))
        s = sample("s", HalfNormal(2.0))
        observe("y", Normal(mu, s), y)

    @model
    def mean_only(y):
        mu = sample("mu", Normal(0.0, 5.0))
        observe("y", Normal(mu, 0.5), y)

    @model
    def sgld_mean(y):
        mu = sample("params", Normal(0.0, 10.0))
        observe("y", Normal(mu, 1.0), y)

    def on_card(y):
        return torch.as_tensor(y, device=DEVICE)

    return ((gauss(on_card(y200)), y200), (mean_only(on_card(y128)), y128),
            (sgld_mean(on_card(y64)), y64))


def other_samplers(torch, np):
    """MAP, RWMH from MAP's mode, ADVI (full-batch, then full against
    ``minibatch=``) and the self-batching SGLD step on the card, each
    counted, with tests/test_infer.py's and tests/test_sharded_chains.py's
    gates."""
    from repro_torch.infer import (ADVI, MAP, RWMH, SGLD,
                                   make_subsampled_sgld_step)
    from repro_torch.sharding import Minibatch

    (m, y), (m2, y2), (m3, y3) = _gauss_models(torch, np)
    runs, out = {}, {}

    def counted(label, fn):
        counts_reset(torch)
        t0 = time.perf_counter()
        res = fn()
        launches, _ = counts_read(torch)
        secs = time.perf_counter() - t0
        check(sum(launches.values()) > 0, f"{label} launched no kernel")
        runs[label] = {"launches": launches, "seconds": secs}
        return res

    est, losses = counted("map", lambda: MAP(num_steps=400).run(
        13, m, device=DEVICE))
    mu_map = float(est["mu"])
    check(abs(mu_map - y.mean()) < 0.05 and losses[-1] < losses[0],
          f"MAP: mu {mu_map:.4f}, data mean {y.mean():.4f}; loss "
          f"{losses[0]:.2f} -> {losses[-1]:.2f}")
    out["map"] = {"mu": mu_map, "data_mean": float(y.mean()),
                  "loss_first": float(losses[0]),
                  "loss_last": float(losses[-1])}

    tvi = m.typed_varinfo(torch.Generator(device=DEVICE).manual_seed(0))
    mode = tvi.replace_values(tuple(
        torch.as_tensor(est[mt.name], device=DEVICE).reshape(mt.shape)
        for mt in tvi.metas))
    ch = counted("rwmh", lambda: RWMH(proposal_scale=0.1).run(
        7, m, 600, num_warmup=200, init_varinfo=mode, num_chains=4,
        device=DEVICE))
    check(abs(ch.mean("mu") - y.mean()) < 0.2
          and np.isfinite(ch.stats["logp"]).all(),
          f"RWMH: mean of mu {ch.mean('mu'):.4f}, data mean {y.mean():.4f}")
    out["rwmh"] = {"mean_mu": float(ch.mean("mu")),
                   "accept": float(ch.stats["accept_prob"].mean())}

    res = counted("advi", lambda: ADVI(num_steps=400, lr=0.05).run(
        9, m, device=DEVICE))
    post = res.sample(11, 2000)
    check(abs(float(post["mu"].mean()) - y.mean()) < 0.1
          and res.elbo_trace[-1] > res.elbo_trace[0]
          and np.isfinite(res.elbo_trace).all(),
          f"ADVI: posterior mean of mu {float(post['mu'].mean()):.4f}, data "
          f"mean {y.mean():.4f}; ELBO {res.elbo_trace[0]:.2f} -> "
          f"{res.elbo_trace[-1]:.2f}")
    out["advi"] = {"mean_mu": float(post["mu"].mean()),
                   "elbo_first": float(res.elbo_trace[0]),
                   "elbo_last": float(res.elbo_trace[-1])}

    full = counted("advi_full_128", lambda: ADVI(
        num_mc=4, lr=0.05, num_steps=300).run(2, m2, device=DEVICE))
    mini = counted("advi_minibatch_32", lambda: ADVI(
        num_mc=4, lr=0.05, num_steps=300,
        minibatch=Minibatch(("y",), 32)).run(2, m2, device=DEVICE))
    d = abs(float(mini.mu[0]) - float(full.mu[0]))
    check(d < 0.1 and np.isfinite(mini.elbo_trace).all(),
          f"ADVI minibatch: mu {float(mini.mu[0]):.4f} vs full-batch "
          f"{float(full.mu[0]):.4f}")
    out["advi_minibatch"] = {"mu_full": float(full.mu[0]),
                             "mu_minibatch": float(mini.mu[0])}

    def sgld_run():
        sgld = SGLD(step_size=2e-2, temperature=0.0)
        step = make_subsampled_sgld_step(m3, Minibatch(("y",), 16), sgld)
        params = torch.zeros((), device=DEVICE)
        state = sgld.init(params)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        lps = []
        for _ in range(300):
            params, state, lp = step(gen, params, state)
            lps.append(lp)
        return params, torch.stack(lps)

    lp0 = float(m3.logjoint({"params": torch.zeros((), device=DEVICE)}))
    params, lps = counted("sgld_subsampled", sgld_run)
    lp1 = float(m3.logjoint({"params": params}))
    check(bool(torch.isfinite(lps).all()) and lp1 > lp0
          and abs(float(params) - y3.mean()) < 0.5,
          f"SGLD: mu {float(params):.4f}, data mean {y3.mean():.4f}; "
          f"log-joint {lp0:.2f} -> {lp1:.2f}")
    out["sgld"] = {"mu": float(params), "data_mean": float(y3.mean()),
                   "logjoint_first": lp0, "logjoint_last": lp1}
    for label, r in runs.items():
        log(f"{label}: {r['seconds']:.2f} s, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }")
    log("samplers: " + json.dumps(out))
    return runs, out


# ---------------------------------------------------------------------------
# the graphs phase: every captured path against the same run eagerly
# ---------------------------------------------------------------------------
GRAPH_RUN = (4, 6)  # warmup, draws of each captured-against-eager HMC run
GRAPH_NUTS = (3, 4)
GRAPH_STEPS = 30    # MAP, ADVI and SGLD steps
GRAPH_MODELS = ("logreg", "naive_bayes", "gaussian_10k", "hier_poisson",
                "hmm_semisup", "lda", "gauss_unknown", "sto_volatility",
                "family_mix_8k", "mixed", "eight_schools")


def same_results(np, a, b) -> bool:
    """Bit for bit (NaN equal to NaN): two Chains, arrays or trees."""
    from repro_torch.infer.chains import Chain

    if isinstance(a, Chain):
        return (a.names() == b.names() and set(a.stats) == set(b.stats)
                and all(same_results(np, a[k], b[k]) for k in a.names())
                and all(same_results(np, a.stats[k], b.stats[k])
                        for k in a.stats))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_results(np, a[k], b[k])
                                            for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_results(np, x, y)
                                        for x, y in zip(a, b))
    if hasattr(a, "detach"):
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"))


def captured_vs_eager(torch, np, label, fn, mods=None, warm=None):
    """``fn()`` with capture on, then under ``disable_capture()``, each with
    every launch count zeroed just before and read just after: the results
    must be identical bit for bit, the counted launches equal (a replay
    adds back what its capture counted), and the first run must have
    replayed graphs. ``warm()``, run eagerly first, builds what only a
    first run builds (the cached density and spec: the compiler's
    probes)."""
    from repro_torch.core.program import GRAPH_COUNTS, disable_capture

    mods = mods or _ppl_mods()
    if warm is not None:
        with disable_capture():
            warm()
    lm_reset(mods)
    before = dict(GRAPH_COUNTS)
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    launches = lm_counts(mods)
    graphs = {k: GRAPH_COUNTS[k] - before[k] for k in before}
    lm_reset(mods)
    t0 = time.perf_counter()
    with disable_capture():
        want = fn()
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    eager_launches = lm_counts(mods)
    same = same_results(np, got, want)
    check(same, f"graphs {label}: the captured run differs from the eager "
          "one")
    check(launches == eager_launches, f"graphs {label}: launches "
          f"{launches} captured, {eager_launches} eager")
    check(graphs["replays"] > 0, f"graphs {label}: no graph was replayed "
          f"({graphs})")
    log(f"graphs {label}: identical to the eager run; {graphs['captures']} "
        f"captures, {graphs['replays']} replays; launches "
        f"{ {k: v for k, v in launches.items() if v} }; {t_graph:.2f} s "
        f"captured, {t_eager:.2f} s eager")
    return {"identical": same, "captures": graphs["captures"],
            "replays": graphs["replays"], "launches": launches,
            "seconds": t_graph, "eager_seconds": t_eager}


def _ppl_mods():
    from repro_torch.kernels.fused_leapfrog import ops as lf_ops
    from repro_torch.kernels.fused_logpdf import ops
    return (ops, lf_ops)


def graphs_phase(torch, np):
    """Captured against eager on the PPL paths at full size (the LM decode
    steps are held in :func:`lm_serve_path`): HMC with dual-averaging
    warmup on the ten models (gaussian_10k and family_mix_8k fused, then
    under the autodiff integrator) and gauss_unknown's switch route, NUTS
    on gaussian_10k (fused leaves) and logreg, Table 1's chains (typed and
    hand-written) on logreg and gaussian_10k, MAP, RWMH, ADVI (full and
    minibatch), the subsampled SGLD step, a logreg posterior-predictive
    query (M = 1,000), a query-server batch of 4 of them, and the
    segmented driver on gaussian_10k. Draws are cut to
    ``GRAPH_RUN``, ``GRAPH_NUTS`` and ``GRAPH_STEPS``: each run still
    takes the eager first call, the capture and replays of each program."""
    from repro_torch.infer import (ADVI, HMC, MAP, NUTS, RWMH, SGLD,
                                   make_subsampled_sgld_step, run_chains)
    from repro_torch.infer.hmc import make_chain_fn
    from repro_torch.kernels import use_fused_logpdf
    from repro_torch.sharding import Minibatch

    t_start = time.perf_counter()
    warm, draws = GRAPH_RUN
    out = {}
    for name in GRAPH_MODELS:
        pm = build_model(name)
        init, jitter = start_point(torch, np, pm, 0)
        for leapfrog in (("auto", "reference")
                         if name in SEPARABLE + CONDITIONAL else ("auto",)):
            kernel = HMC(step_size=pm.step_size, n_leapfrog=pm.n_leapfrog,
                         adapt_step_size=True, leapfrog=leapfrog)
            label = name + ("" if leapfrog == "auto" else " (autodiff)")
            def run(n=draws, w=warm):
                return run_chains(0, pm.model, kernel, n, num_warmup=w,
                                  num_chains=4, device=DEVICE,
                                  init_varinfo=init, init_jitter=jitter)

            out[label] = captured_vs_eager(torch, np, label, run,
                                           warm=lambda: run(1, 0))
        if name in ("logreg", "gaussian_10k"):
            tvi = pm.model.typed_varinfo(
                torch.Generator(device=DEVICE).manual_seed(42)).link()
            for variant, ld in (("typed", pm.model.make_logdensity_fn(tvi)),
                                ("handwritten", pm.handwritten)):
                chain = make_chain_fn(ld, draws, pm.step_size, pm.n_leapfrog,
                                      collect=name == "logreg")
                out[f"table1 {name} {variant}"] = captured_vs_eager(
                    torch, np, f"table1 {name} {variant}", lambda: chain(
                        torch.Generator(device=DEVICE).manual_seed(0),
                        tvi.flat()))
    pm = build_model("gauss_unknown")
    init, jitter = start_point(torch, np, pm, 0)
    def switch_run(n=draws, w=warm):
        return run_chains(0, pm.model, HMC(step_size=pm.step_size,
                                           leapfrog="reference"), n,
                          num_warmup=w, num_chains=4, device=DEVICE,
                          init_varinfo=init, init_jitter=jitter,
                          backend="reference")

    with use_fused_logpdf():
        out["gauss_unknown_switch"] = captured_vs_eager(
            torch, np, "gauss_unknown (switch route)", switch_run,
            warm=lambda: switch_run(1, 0))
    n_warm, n_draws = GRAPH_NUTS
    for name in ("gaussian_10k", "logreg"):
        pm = build_model(name)
        kernel = NUTS(step_size=pm.step_size, max_depth=NUTS_RUNS[name][2])

        def nuts_run(n=n_draws, w=n_warm):
            return run_chains(0, pm.model, kernel, n, num_warmup=w,
                              num_chains=4, device=DEVICE)

        out[f"nuts {name}"] = captured_vs_eager(
            torch, np, f"NUTS {name}", nuts_run, warm=lambda: nuts_run(1, 0))
    (m, _), (m2, _), (m3, _) = _gauss_models(torch, np)
    steps = GRAPH_STEPS
    out["map"] = captured_vs_eager(
        torch, np, "MAP", lambda: MAP(num_steps=steps).run(13, m,
                                                           device=DEVICE))
    out["rwmh"] = captured_vs_eager(
        torch, np, "RWMH", lambda: RWMH(proposal_scale=0.1).run(
            7, m, draws, num_warmup=warm, num_chains=4, device=DEVICE),
        warm=lambda: RWMH(proposal_scale=0.1).run(7, m, 1, num_chains=4,
                                                  device=DEVICE))

    def advi(minibatch):
        res = ADVI(num_mc=4, lr=0.05, num_steps=steps,
                   minibatch=minibatch).run(2, m2, device=DEVICE)
        return res.mu, res.log_sigma, res.elbo_trace

    out["advi"] = captured_vs_eager(torch, np, "ADVI", lambda: advi(None))
    out["advi_minibatch"] = captured_vs_eager(
        torch, np, "ADVI (minibatch)", lambda: advi(Minibatch(("y",), 32)))

    def sgld():
        sgld = SGLD(step_size=2e-2, temperature=0.0)
        step = make_subsampled_sgld_step(m3, Minibatch(("y",), 16), sgld)
        params = torch.zeros((), device=DEVICE)
        state = sgld.init(params)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        lps = []
        for _ in range(steps):
            params, state, lp = step(gen, params, state)
            lps.append(lp)
        return params, torch.stack(lps)

    out["sgld"] = captured_vs_eager(torch, np, "SGLD (subsampled)", sgld)

    # the query programs (phase 6e's paths): three calls of a logreg
    # posterior predictive (eager, captured, replayed) and three batches of
    # the server, each on a cache of its own
    from repro_torch.core.program import ProgramCache
    from repro_torch.core.queries import prob
    from repro_torch.launch.serve import QueryServer

    pm = build_model("logreg")
    rng = np.random.default_rng(0)
    n, dim = pm.data["X"].shape
    c = {"w": rng.normal(size=(1000, dim)).astype(np.float32) * 0.1,
         "b": rng.normal(size=1000).astype(np.float32)}
    reqs = [("X = Xn, y = yn | chain = c, model = m",
             dict(zip(("Xn", "yn"), heldout_logreg(np, s, n, dim)), c=c,
                  m=pm.model)) for s in range(4)]
    out["query ppd"] = captured_vs_eager(
        torch, np, "query (logreg PPD, M = 1,000)", lambda: (lambda cache: [
            prob(reqs[0][0], cache=cache, device=DEVICE, **reqs[0][1])
            for _ in range(3)])(ProgramCache()))
    out["query server"] = captured_vs_eager(
        torch, np, "query server (4 logreg PPD lanes)", lambda: (
            lambda server: [server.serve(reqs) for _ in range(3)])(
                QueryServer(cache=ProgramCache(), device=DEVICE)))
    # the segmented driver (phase 6f's path) on gaussian_10k, fused
    pm = build_model("gaussian_10k")
    kernel = HMC(step_size=pm.step_size, n_leapfrog=pm.n_leapfrog,
                 adapt_step_size=True)

    def segmented(n=draws, w=warm):
        return run_chains(0, pm.model, kernel, n, num_warmup=w,
                          num_chains=4, device=DEVICE, checkpoint_every=3)

    out["segmented"] = captured_vs_eager(
        torch, np, "segmented driver (gaussian_10k)", segmented,
        warm=lambda: segmented(1, 0))
    log(f"graphs phase: {len(out)} paths identical captured and eager in "
        f"{time.perf_counter() - t_start:.1f} s")
    return out


def cond_spec(torch, pm):
    """The conditional spec ``run_chains`` compiled for ``pm`` (the
    program cache's; the profiler's trace draws from seed 3, whose layout
    is the same)."""
    from repro_torch.core.program import cached_potential
    return cached_potential(pm.model, pm.model.typed_varinfo(
        torch.Generator(device=DEVICE).manual_seed(0)).link()).spec


def memory_line(torch, label):
    """The card's memory after a phase: what the caching allocator holds
    (``memory_reserved``), what tensors hold now (``memory_allocated``)
    and their peak since the last line (``max_memory_allocated``, whose
    counter is then reset), in MiB."""
    torch.cuda.synchronize()
    mib = 1 << 20
    out = {"reserved_mib": torch.cuda.memory_reserved() / mib,
           "allocated_mib": torch.cuda.memory_allocated() / mib,
           "max_allocated_mib": torch.cuda.max_memory_allocated() / mib}
    torch.cuda.reset_peak_memory_stats()
    log(f"memory after {label}: reserved {out['reserved_mib']:.1f} MiB, "
        f"allocated {out['allocated_mib']:.1f} MiB, max allocated since "
        f"the last line {out['max_allocated_mib']:.1f} MiB")
    return out


# phase 6d: the conditional spec. The compiler's verdict and head on each
# model, its first draws against the autodiff integrator's (repro's own
# gate, tests/test_analysis.py:248-259: atol 1e-5 over 10 draws), ms a
# draw of both routes; then the analysis CLI over the whole suite
COND_HEADS = {"eight_schools": ("mu", "tau"), "gauss_unknown": ("s",)}
COND_FIRST = 10
COND_ATOL = 1e-5
COND_REFERENCE_SAMPLES = 300


def conditional_phase(torch, np, runs, models, draws):
    """eight_schools (its published data) and gauss_unknown (Table 1's
    10,000 observations), 4 chains each through ``run_chains(model,
    HMC(leapfrog="auto"))`` (:func:`run_model`, counted: the compiler's 5
    probe evaluations, no launch a transition): the spec ``run_chains``
    compiled (the cache's) is conditional with ``COND_HEADS``' head; the
    first ``COND_FIRST`` draws equal ``leapfrog="reference"``'s from the
    same seed within ``COND_ATOL``; gauss_unknown's means match the
    conjugate posterior. gauss_unknown's main run is phase 6's."""
    from repro_torch.core.program import cached_potential
    from repro_torch.kernels.fused_leapfrog.spec import CondPotentialSpec

    out = {}
    for name, head in COND_HEADS.items():
        if name not in runs:
            runs[name], pm, kernel, chain = run_model(torch, name,
                                                      draws(name))
            models[name] = (pm, kernel, chain)
        pm, kernel, chain = models[name]
        check(runs[name]["integrator"] == "conditional",
              f"{name}: leapfrog='auto' ran the "
              f"{runs[name]['integrator']} integrator")
        res = cached_potential(pm.model, pm.model.typed_varinfo(
            torch.Generator(device=DEVICE).manual_seed(0)).link())
        check(res.kind == "conditional"
              and isinstance(res.spec, CondPotentialSpec)
              and tuple(res.spec.head_syms) == head,
              f"{name}: the compiler's verdict is {res.kind} "
              f"({res.reason}), head "
              f"{getattr(res.spec, 'head_syms', None)}, expected "
              f"conditional with head {head}")
        ref_run, _, _, ref_chain = run_model(
            torch, name, COND_REFERENCE_SAMPLES, leapfrog="reference")
        runs[f"{name}_reference"] = ref_run
        d = max(float(np.abs(chain[s][:, :COND_FIRST]
                             - ref_chain[s][:, :COND_FIRST]).max())
                for s in chain.names())
        lp, lp_ref = (c.stats["logp"][:, :COND_FIRST]
                      for c in (chain, ref_chain))
        lp_rel = float((np.abs(lp - lp_ref) / np.abs(lp_ref)).max())
        check(d <= COND_ATOL,
              f"{name}: the first {COND_FIRST} draws of the conditional and "
              f"the autodiff integrators differ by {d:.3e} (atol "
              f"{COND_ATOL})")
        ms, ms_ref = (r["seconds_per_draw"] * 1e3
                      for r in (runs[name], ref_run))
        out[name] = {"head_syms": list(res.spec.head_syms),
                     "first_draws": COND_FIRST, "draws_max_abs": d,
                     "logp_max_rel": lp_rel, "ms_per_draw": ms,
                     "reference_ms_per_draw": ms_ref,
                     "draws": runs[name]["num_samples"],
                     "reference_draws": ref_run["num_samples"]}
        log(f"{name}: conditional spec, head {', '.join(head)}; first "
            f"{COND_FIRST} draws against the autodiff integrator's: max abs "
            f"{d:.2e} (atol {COND_ATOL}), logp max rel {lp_rel:.2e}; "
            f"{ms:.3f} ms/draw conditional ({runs[name]['num_samples']} "
            f"draws) against {ms_ref:.3f} autodiff ({ref_run['num_samples']})")
    out["analyze_cli"] = analyze_cli(torch)
    return out


ANALYZE_SUITE = ("gaussian_10k", "gauss_unknown", "naive_bayes", "logreg",
                 "hier_poisson", "sto_volatility", "hmm_semisup", "lda",
                 "eight_schools")


def analyze_cli(torch):
    """``python -m repro_torch.analyze --json`` over the whole paper suite
    on the card, in a process of its own: exit status 0 (no error
    finding), a report that ``validate_analysis_report`` accepts, stamped
    with this card, and the verdicts ``leapfrog="auto"`` acts on."""
    import os

    from repro_torch.analysis.report import validate_analysis_report

    path = ROOT / "build" / "analysis.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analyze", "--quiet", "--json",
         str(path)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"    analyze: {line}")
    check(proc.returncode == 0,
          f"python -m repro_torch.analyze exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    report = json.loads(path.read_text())
    errs = validate_analysis_report(report)
    check(not errs, f"the analysis report is malformed: {errs}")
    kinds = {m["name"]: m["potential"]["kind"] for m in report["models"]}
    want = dict.fromkeys(ANALYZE_SUITE)
    want.update(gaussian_10k="separable", gauss_unknown="conditional",
                eight_schools="conditional")
    check(kinds == want, f"analyze: verdicts {kinds}, expected {want}")
    check(report["machine"]["device"] == torch.cuda.get_device_name(0),
          f"analyze: the report's device is {report['machine']['device']}")
    log(f"analyze: {len(kinds)} models, exit status 0, report valid, "
        f"{secs:.1f} s")
    return {"seconds": secs, "returncode": proc.returncode, "kinds": kinds,
            "n_errors": sum(m["n_errors"] for m in report["models"]),
            "n_warnings": sum(m["n_warnings"] for m in report["models"])}


# ---------------------------------------------------------------------------
# phase 6e: probability queries and the query server (ROADMAP Queue 1 item
# 6) on logreg at Table 1's width, and serve_queries()'s demo workload
# ---------------------------------------------------------------------------
QUERY_CHAIN = (4, 250)   # chains x draws of the logreg run the PPD averages
QUERY_HELDOUT = 8        # held-out data sets, one a server request
QUERY_RTOL = 1e-5        # compiled against compiled=False and plain torch
QUERY_LANE_RTOL = 1e-6   # a server lane against its single prob call
QUERY_TIMED = 20         # replayed calls of each kind timed
DEMO_QUERIES = (32, 8)   # serve_queries(): requests, batch


def heldout_logreg(np, seed, n, dim):
    """A held-out logreg data set: fresh ``X`` from ``seed`` and labels
    drawn from the same true weights as ``paper_suite.logreg``'s data
    (its seed 2), as NumPy arrays."""
    rng = np.random.default_rng(2)
    rng.normal(size=(n, dim))
    w_true = rng.normal(size=dim) * (rng.random(dim) < 0.3)
    rng = np.random.default_rng(1000 + seed)
    X = rng.normal(size=(n, dim)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ w_true)))
    y = (rng.random(n) < p).astype(np.int32)
    return X, y


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def queries_phase(torch, np):
    """Phase 6e. logreg (10,000 x 100): a prior, a likelihood on a held-out
    data set, a joint, and a posterior predictive over M = 1,000 draws of
    a 4-chain ``run_chains`` (250 draws a chain), each through ``prob``:
    compiled against ``compiled=False`` and against the per-site
    evaluator's plain torch (the per-array switch off) at 1e-5 relative,
    and three compiled calls (eager, captured, replayed) against
    ``disable_capture()`` bit for bit; ms a call replayed. Then a
    ``QueryServer`` batch of 8 PPD requests over 8 held-out data sets
    (bucket 8: lanes x draws as the kernel's rows, one launch counted),
    each lane against its single ``prob`` at 1e-6, the stats against the
    requests, captured against eager; then ``serve_queries()``'s demo
    workload (32 requests, batch 8) and a ``QueryServer`` over the same
    requests, lane by lane."""
    from repro_torch.core import queries
    from repro_torch.core.program import (GRAPH_COUNTS, ProgramCache,
                                          disable_capture)
    from repro_torch.infer import HMC, run_chains
    from repro_torch.launch.serve import (QueryServer, _demo_query_requests,
                                          _next_pow2, serve_queries)

    t_start = time.perf_counter()
    pm = build_model("logreg")
    chains, per = QUERY_CHAIN
    counts_reset(torch)
    chain = run_chains(0, pm.model, HMC(step_size=pm.step_size,
                                        n_leapfrog=pm.n_leapfrog), per,
                       num_chains=chains, device=DEVICE)
    chain_launches, _ = counts_read(torch)
    draws = {k: chain[k].reshape((chains * per,) + chain[k].shape[2:])
             for k in ("w", "b")}
    M = chains * per
    w0 = draws["w"].mean(axis=0).astype(np.float32)
    b0 = np.float32(draws["b"].mean())
    sets = [heldout_logreg(np, s, *pm.data["X"].shape)
            for s in range(QUERY_HELDOUT)]
    X0, y0 = sets[0]
    specs = {
        "prior": ("w = w0, b = b0 | model = m", {}),
        "likelihood": ("X = Xn, y = yn | w = w0, b = b0, model = m",
                       {"Xn": X0, "yn": y0}),
        "joint": ("X = Xn, y = yn, w = w0, b = b0 | model = m",
                  {"Xn": X0, "yn": y0}),
        "posterior_predictive": ("X = Xn, y = yn | chain = c, model = m",
                                 {"Xn": X0, "yn": y0, "c": draws}),
    }
    cache = ProgramCache()
    out = {"chain_launches": chain_launches, "num_draws": M, "kinds": {}}
    launches = []
    for kind, (spec, extra) in specs.items():
        b = {"m": pm.model, "w0": w0, "b0": b0, **extra}
        before = dict(GRAPH_COUNTS)
        counts_reset(torch)
        got = [queries.prob(spec, cache=cache, device=DEVICE, **b)
               for _ in range(3)]
        kind_launches, _ = counts_read(torch)
        launches.append(kind_launches)
        graphs = {k: GRAPH_COUNTS[k] - before[k] for k in before}
        with disable_capture():
            eager_prog = queries.prob(spec, cache=cache, device=DEVICE, **b)
        uncompiled = queries.prob(spec, compiled=False, device=DEVICE, **b)
        plain = queries._prob_eager(spec, b, device=DEVICE,
                                    backend="reference")
        value = float(got[-1])
        check(math.isfinite(value), f"query {kind}: {value}")
        check(all(same_results(np, g, eager_prog) for g in got),
              f"query {kind}: captured {[float(g) for g in got]} differs "
              f"from eager {float(eager_prog)}")
        check(graphs["captures"] == 1 and graphs["replays"] == 2,
              f"query {kind}: {graphs} (one capture, two replays expected)")
        rel_c, rel_p = _rel(value, uncompiled), _rel(value, plain)
        check(rel_c <= QUERY_RTOL and rel_p <= QUERY_RTOL,
              f"query {kind}: {value} against compiled=False "
              f"{float(uncompiled)} ({rel_c:.2e}) and plain torch "
              f"{float(plain)} ({rel_p:.2e})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(QUERY_TIMED):
            queries.prob(spec, cache=cache, device=DEVICE, **b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / QUERY_TIMED * 1e3
        out["kinds"][kind] = {"value": value, "rel_vs_uncompiled": rel_c,
                              "rel_vs_plain": rel_p, "ms_a_call": ms,
                              "launches_3_calls": kind_launches, **graphs}
        log(f"query logreg {kind}: {value:.6f} (compiled=False rel "
            f"{rel_c:.2e}, plain torch rel {rel_p:.2e}); captured = eager; "
            f"{graphs['captures']} capture, {graphs['replays']} replays; "
            f"{ms:.3f} ms a call replayed ({1e3 / ms:.1f} queries/s); "
            f"launches in 3 calls "
            f"{ {k: v for k, v in kind_launches.items() if v} }")

    # the server: 8 PPD requests over the 8 held-out data sets, one group
    spec = specs["posterior_predictive"][0]
    reqs = [(spec, {"Xn": X, "yn": y, "c": draws, "m": pm.model})
            for X, y in sets]
    singles = [queries.prob(s, cache=cache, device=DEVICE, **b)
               for s, b in reqs]
    server = QueryServer(cache=cache, device=DEVICE)
    before = dict(GRAPH_COUNTS)
    results = []
    for _ in range(3):  # eager, captured, replayed
        counts_reset(torch)
        results.append(server.serve(reqs))
        launches.append(counts_read(torch)[0])
    graphs = {k: GRAPH_COUNTS[k] - before[k] for k in before}
    with disable_capture():
        eager = server.serve(reqs)
    batch_launches = launches[-1]
    want_launches = dict.fromkeys(batch_launches, 0)
    want_launches["bernoulli_logit_sum"] = 1
    check(batch_launches == want_launches,
          f"query server: one batched PPD call launched {batch_launches}, "
          f"expected {want_launches} (lanes x draws as one launch's rows)")
    lane_rel = max(_rel(g, s) for g, s in zip(results[-1], singles))
    check(lane_rel <= QUERY_LANE_RTOL,
          f"query server: a lane is {lane_rel:.2e} from its single prob")
    check(all(same_results(np, torch.stack(r), torch.stack(eager))
              for r in results),
          "query server: the captured batch differs from the eager one")
    st = server.stats
    want_st = (4, 1, 0, 4 * len(reqs))  # batches, groups, padding, requests
    check((st.batches, st.groups, st.padded_lanes, st.requests) == want_st,
          f"query server: stats {st.as_dict()}, expected (batches, groups, "
          f"padded_lanes, requests) {want_st}")
    ms = st.latency_s / st.batches * 1e3
    out["server"] = {"lanes": len(reqs), "num_draws": M,
                     "max_lane_rel": lane_rel, "launches": batch_launches,
                     "stats": st.as_dict(), **graphs,
                     "ms_a_batch_mean": ms}
    log(f"query server logreg: {len(reqs)} PPD lanes x {M} draws x "
        f"{len(y0):,} rows, bucket 8: lanes = single prob within {lane_rel:.2e}; "
        f"captured = eager; launches a batch {batch_launches}; "
        f"{graphs['captures']} captures, {graphs['replays']} replays; "
        f"{ms:.3f} ms a batch mean over {st.batches} ({st.throughput_qps:.1f}"
        f" queries/s, first call and capture included)")

    # serve_queries()'s demo workload, and a server over its requests
    n_req, batch = DEMO_QUERIES
    demo = _demo_query_requests(n_req)
    counts_reset(torch)
    st = serve_queries(n_req, batch, device=DEVICE)
    launches.append(counts_read(torch)[0])
    groups, padded = set(), 0
    for off in range(0, n_req, batch):
        kinds = [spec for spec, _ in demo[off:off + batch]]
        groups.update(kinds)
        padded += sum(_next_pow2(kinds.count(k)) - kinds.count(k)
                      for k in set(kinds))
    want_st = (n_req, -(-n_req // batch), len(groups), padded)
    got_st = (st.requests, st.batches, st.groups, st.padded_lanes)
    check(got_st == want_st, f"serve_queries: (requests, batches, groups, "
          f"padded_lanes) {got_st}, reckoned from the requests {want_st}")
    demo_cache = ProgramCache()
    server = QueryServer(cache=demo_cache, device=DEVICE)
    lanes = []
    for off in range(0, n_req, batch):
        lanes += server.serve(demo[off:off + batch])
    singles = [queries.prob(s, cache=demo_cache, device=DEVICE, **b)
               for s, b in demo]
    demo_rel = max(_rel(g, s) for g, s in zip(lanes, singles))
    check(demo_rel <= QUERY_LANE_RTOL,
          f"demo server: a lane is {demo_rel:.2e} from its single prob")
    out["serve_queries"] = {"stats": st.as_dict(), "max_lane_rel": demo_rel}
    log(f"serve_queries: {st.requests} queries in {st.batches} batches "
        f"({st.groups} program groups, {st.padded_lanes} padded lanes) as "
        f"reckoned; {st.latency_s / st.requests * 1e3:.3f} ms a request, "
        f"{st.throughput_qps:.1f} queries/s (first calls and captures "
        f"included); cache {st.cache_hits} hits, {st.cache_misses} misses; "
        f"lanes = single prob within {demo_rel:.2e}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 6e done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 6f: the segmented, resumable, fault-tolerant driver (ROADMAP Queue
# 1 item 7) at Table 1's widths
# ---------------------------------------------------------------------------
# name -> (model, sampler, warmup, draws, checkpoint_every, NaN iteration)
DRIVER_RUNS = {
    "gaussian_10k": ("gaussian_10k", "hmc", 200, 1000, 250, 700),
    "logreg_autodiff": ("logreg", "hmc_reference", 100, 300, 100, 250),
    "nuts_gaussian_10k": ("gaussian_10k", "nuts", 20, 40, 15, 40),
}


def segment_ends(warm, n, every):
    """Where the driver's segments end: ``every`` transitions, the warmup
    cut at its end (``infer.driver.run_segmented``)."""
    ends, it = [], 0
    while it < warm + n:
        it = min(it + every, warm if it < warm else warm + n)
        ends.append(it)
    return ends


def _driver_sampler(pm, how):
    from repro_torch.infer import HMC, NUTS
    if how == "nuts":
        return NUTS(step_size=pm.step_size, max_depth=NUTS_RUNS[pm.name][2])
    return HMC(step_size=pm.step_size, n_leapfrog=pm.n_leapfrog,
               leapfrog="reference" if how == "hmc_reference" else "auto")


def driver_phase(torch, np):
    """Phase 6f. For each of ``DRIVER_RUNS`` (4 chains): the unsegmented
    ``run_chains``; the same call segmented with snapshots (equal bit for
    bit; snapshot bytes and seconds, ms a draw against unsegmented);
    ``ScriptedPreemption(after_polls=2)`` then a resume after
    ``clear_cache()`` (equal to the uninterrupted run bit for bit); a
    ``NaNInjector`` at one iteration with the fallback (one segment rerun
    on the reference twin, finite draws) and without it (the NaN
    recorded); a ``torn_save`` of the step after the latest, skipped on
    resume (equal again). Checkpoints go to a temporary directory that
    the phase removes."""
    import shutil
    import tempfile

    from repro_torch.ckpt.checkpoint import latest_step, restore
    from repro_torch.core.program import clear_cache
    from repro_torch.infer import run_chains
    from repro_torch.runtime import NaNInjector, ScriptedPreemption, torn_save

    t_start = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out, launches = {}, []
    models = {}
    try:
        for label, (name, how, warm, n, every, nan_at) in DRIVER_RUNS.items():
            pm = models.get(name) or models.setdefault(name, build_model(name))
            kernel = _driver_sampler(pm, how)
            common = dict(num_warmup=warm, num_chains=4, device=DEVICE)

            def go(kern=kernel, **kw):
                counts_reset(torch)
                t0 = time.perf_counter()
                chain = run_chains(0, pm.model, kern, n, **common, **kw)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches.append(counts_read(torch)[0])
                return chain, secs

            go()  # builds the programs: the timed runs below are warm
            single, t_single = go()
            d = f"{root}/{label}"
            bare, t_bare = go(checkpoint_every=every)
            seg, t_seg = go(checkpoint_dir=f"{d}/seg", checkpoint_every=every)
            check(same_results(np, seg, single)
                  and same_results(np, bare, single),
                  f"driver {label}: the segmented run differs from the "
                  "unsegmented one")
            h = seg.health
            check(h.ok and h.completed == warm + n,
                  f"driver {label}: segmented health\n{h.report()}")
            stop = segment_ends(warm, n, every)[2]  # the third poll
            part, _ = go(checkpoint_dir=f"{d}/resume", checkpoint_every=every,
                         preemption=ScriptedPreemption(after_polls=2))
            check(part.health.preempted and latest_step(f"{d}/resume")
                  == part.health.completed == stop,
                  f"driver {label}: preempted at {part.health.completed}, "
                  f"latest step {latest_step(f'{d}/resume')}, expected {stop}")
            clear_cache()
            resumed, t_resume = go(checkpoint_dir=f"{d}/resume",
                                   checkpoint_every=every)
            check(resumed.health.resumed_from == stop
                  and same_results(np, resumed, single),
                  f"driver {label}: the run resumed from "
                  f"{resumed.health.resumed_from} differs from the "
                  "uninterrupted one")
            # a writer killed while committing the step after the latest
            go(checkpoint_dir=f"{d}/torn", checkpoint_every=every,
               preemption=ScriptedPreemption(after_polls=2))
            good = latest_step(f"{d}/torn")
            torn_save(f"{d}/torn", good + every,
                      restore(f"{d}/torn", good)[1], kill_at="before_commit")
            check(latest_step(f"{d}/torn") == good,
                  f"driver {label}: the torn step is visible")
            torn, _ = go(checkpoint_dir=f"{d}/torn", checkpoint_every=every)
            check(torn.health.resumed_from == good
                  and same_results(np, torn, single),
                  f"driver {label}: the resume past a torn step differs")
            nan = {}
            for fallback in (True, False):
                chain, _ = go(kern=NaNInjector(kernel, at_iterations=[nan_at]),
                              checkpoint_every=every, fallback=fallback)
                hh = chain.health
                finite = all(np.isfinite(chain[k]).all()
                             for k in chain.names())
                if fallback:
                    check(hh.fallback_segments == 1 and finite
                          and int(hh.nonfinite.sum()) > 0,
                          f"driver {label}: NaN at {nan_at} with the "
                          f"fallback\n{hh.report()}")
                else:
                    check(hh.fallback_segments == 0 and not finite
                          and int(hh.nonfinite.sum()) > 0,
                          f"driver {label}: NaN at {nan_at} without the "
                          f"fallback\n{hh.report()}")
                nan[fallback] = {"nonfinite": hh.nonfinite.tolist(),
                                 "fallback_segments": hh.fallback_segments,
                                 "finite": finite}
            ms_single = t_single / n * 1e3
            ms_bare = t_bare / n * 1e3
            ms_seg = t_seg / n * 1e3
            out[label] = {
                "model": name, "sampler": how, "num_warmup": warm,
                "num_samples": n, "checkpoint_every": every,
                "ms_a_draw_unsegmented": ms_single,
                "ms_a_draw_segments_alone": ms_bare,
                "ms_a_draw_segmented": ms_seg,
                "ms_a_draw_added": ms_seg - ms_single,
                "ms_a_draw_resumed_cold": t_resume / n * 1e3,
                "snapshots": h.snapshots, "snapshot_bytes": h.snapshot_bytes,
                "snapshot_s": h.snapshot_s,
                "snapshot_write_s": h.snapshot_write_s,
                "preempted_at": part.health.completed,
                "nan": {str(k): v for k, v in nan.items()}}
            log(f"driver {label}: {warm} + {n} draws, segments of {every}: "
                f"segmented = unsegmented, resumed from {stop} (cleared "
                f"cache) = uninterrupted, resumed past a torn step = "
                f"uninterrupted, NaN at {nan_at} rerun on the reference "
                f"twin ({nan[True]['fallback_segments']} segment) / "
                f"recorded without it; {h.snapshots} snapshots of "
                f"{h.snapshot_bytes / max(h.snapshots, 1) / 2**20:.1f} MiB, "
                f"copied to the host in {h.snapshot_s:.3f} s and written in "
                f"{h.snapshot_write_s:.3f} s in all; ms a draw {ms_seg:.3f} "
                f"segmented "
                f"with snapshots, {ms_bare:.3f} in segments alone, against "
                f"{ms_single:.3f} unsegmented (+{ms_seg - ms_single:.3f})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 6f done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 6g: sharding on torch.distributed (ROADMAP Queue 1 item 8): logreg
# at Table 1's width over a world of 4 ranks that share the one card
# ---------------------------------------------------------------------------
MESH_WORLD = 4             # ranks, all on cuda:0: gloo over CUDA tensors
MESH_SITES = ("X", "y")    # logreg's observed rows
MESH_CHAINS = 4
MESH_POINTS = 4            # density and gradient checks a shard count
MESH_VALUE_RTOL = 1e-6     # tests/test_sharded_chains.py's density gate
MESH_GRAD_RTOL = 1e-5      # of max |gradient|
MESH_DRAWS = 6             # chains-only against unsharded, no adaptation
MESH_DRAW_TOL = 1e-4
MESH_TIMED = 100           # draws of the timed chains-only run
MESH_MIX = (100, 200)      # warmup, draws of the adaptive 2 x 2 run
MESH_N_SE = 5.5
MESH_SEGMENTED = (20, 40, 15)  # warmup, draws, checkpoint_every
MESH_TIMEOUT_S = 300.0


def _mesh_hmc(pm, adapt):
    from repro_torch.infer import HMC
    return HMC(step_size=pm.step_size, n_leapfrog=pm.n_leapfrog,
               adapt_step_size=adapt)


def _sync(torch):
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def mesh_gloo_ops(torch):
    """Which gloo collectives take this rank's CUDA tensors: each op the
    mesh layer makes, tried once on the card over the world. The mesh
    layer stages nothing through the host, so a refusal fails the phase.
    Returns {op: "device" or the refusal}."""
    import torch.distributed as dist

    dev = torch.device(DEVICE)
    out = {}
    ops = {"all_reduce": lambda t: dist.all_reduce(t),
           "all_gather": lambda t: dist.all_gather(
               [torch.empty_like(t) for _ in range(dist.get_world_size())],
               t)}
    for name, op in ops.items():
        t = torch.full((3,), float(dist.get_rank() + 1), device=dev)
        try:
            op(t)
            _sync(torch)
            out[name] = "device"
        except RuntimeError as exc:
            out[name] = f"refused: {exc}"
        check(out[name] == "device",
              f"gloo {name} on {dev.type} tensors: {out[name]} (the mesh "
              "layer hands gloo its tensors as they are)")
    return out


def mesh_densities(torch, np, pm):
    """The sharded density and gradient against the unsharded ones at
    ``MESH_POINTS`` points, for 2 and 4 data shards (every rank)."""
    from repro_torch.infer.hmc import value_and_grad
    from repro_torch.sharding import (ShardedRun, make_sharded_logdensity,
                                      use_run)

    tvi = pm.model.typed_varinfo(
        torch.Generator(device=DEVICE).manual_seed(0)).link()
    q0 = tvi.flat()
    steps = torch.arange(1, q0.shape[0] + 1, dtype=q0.dtype, device=q0.device)
    qs = torch.stack([q0, q0 + 0.3, q0 - 0.2, q0 + 0.005 * steps])
    v0, g0 = value_and_grad(pm.model.make_logdensity_fn(tvi))(qs)
    out = {}
    for shards in (2, 4):
        plan = ShardedRun.plan(data_shards=shards, shard_sites=MESH_SITES)
        with use_run(plan):
            ld = make_sharded_logdensity(pm.model, tvi, plan, device=DEVICE)
            v1, g1 = ld.value_and_grad(qs)
            single = torch.stack([ld(q) for q in qs])
        v_err = (torch.maximum((v1 - v0).abs(), (single - v0).abs())
                 / v0.abs().clamp(min=1.0)).max().item()
        g_err = ((g1 - g0).abs().amax(dim=1)
                 / g0.abs().amax(dim=1).clamp(min=1.0)).max().item()
        rows = [tuple(x.shape) for x in ld.local]
        check(v_err <= MESH_VALUE_RTOL and g_err <= MESH_GRAD_RTOL
              and all(r[0] == pm.data["y"].shape[0] // shards for r in rows),
              f"mesh density over {shards} shards: value rel err {v_err:.2e}"
              f" (limit {MESH_VALUE_RTOL}), gradient {g_err:.2e} (limit "
              f"{MESH_GRAD_RTOL}), rows {rows}")
        out[shards] = {"value_rel_err": v_err, "grad_rel_err": g_err,
                       "rows": rows, "plan": repr(plan)}
    return out


def mesh_rank(rank, world_size, ckpt_root):
    """One rank of phase 6g's world (every rank runs all of it, the same
    calls in the same order). Returns what the parent checks and prints."""
    import hashlib
    import os

    import numpy as np
    import torch

    from repro_torch.core.program import GRAPH_COUNTS, program_cache
    from repro_torch.infer import run_chains
    from repro_torch.kernels.fused_logpdf import ops
    from repro_torch.runtime import ScriptedPreemption
    from repro_torch.sharding import ShardedLogDensity, ShardedRun, world

    entered = time.time()
    steps, t_step = {}, [time.perf_counter()]

    def step(name):  # host seconds of each part of this rank's work
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now

    pm = build_model("logreg")
    out = {"rank": rank, "backend": torch.distributed.get_backend(),
           "entered": entered, "steps_s": steps,
           "gloo_ops": mesh_gloo_ops(torch)}
    step("model")
    out["densities"] = mesh_densities(torch, np, pm)
    step("densities")

    # chains only, 4 x 1, no adaptation: the unsharded run's draws
    kern = _mesh_hmc(pm, False)
    chains_only = ShardedRun.plan()
    base = run_chains(0, pm.model, kern, MESH_DRAWS, num_chains=MESH_CHAINS,
                      device=DEVICE)
    r0 = GRAPH_COUNTS["replays"]
    sh = run_chains(0, pm.model, kern, MESH_DRAWS, num_chains=MESH_CHAINS,
                    device=DEVICE, mesh=chains_only)
    replays = GRAPH_COUNTS["replays"] - r0
    err = max(float(np.abs(sh[k] - base[k]).max()) for k in base.names())
    check(all(np.allclose(sh[k], base[k], atol=MESH_DRAW_TOL,
                          rtol=MESH_DRAW_TOL) for k in base.names())
          and replays > 0,
          f"rank {rank}: chains-only draws max |d| {err:.2e} against the "
          f"unsharded run (limit {MESH_DRAW_TOL}), {replays} replays")
    _sync(torch)
    t0 = time.perf_counter()
    run_chains(0, pm.model, kern, MESH_TIMED, num_chains=MESH_CHAINS,
               device=DEVICE, mesh=chains_only)
    _sync(torch)
    out["chains_only"] = {"max_abs_diff": err, "replays": replays,
                          "ms_a_draw": (time.perf_counter() - t0)
                          / MESH_TIMED * 1e3}
    step("chains_only")

    # chains x data, 2 x 2, adaptive: every count zeroed just before the
    # run and read just after
    plan = ShardedRun.plan(data_shards=2, shard_sites=MESH_SITES)
    warm, n = MESH_MIX
    rows_seen = []
    plain_rows = ops.bernoulli_logit_sum_rows

    def rows_counted(logits, y):
        rows_seen.append(tuple(logits.shape))
        return plain_rows(logits, y)

    def evaluations():
        return sum(p.evaluations for k in program_cache().keys()
                   if isinstance(p := program_cache().get(k),
                                 ShardedLogDensity))

    ops.bernoulli_logit_sum_rows = rows_counted
    try:
        run_chains(1, pm.model, _mesh_hmc(pm, True), 2, num_warmup=1,
                   num_chains=MESH_CHAINS, device=DEVICE, mesh=plan)
        rows_seen.clear()
        step("mix_warm")
        e0 = evaluations()
        _sync(torch)
        ops.reset_launch_counts()
        world.reset_collective_counts()
        t0 = time.perf_counter()
        mix = run_chains(1, pm.model, _mesh_hmc(pm, True), n,
                         num_warmup=warm, num_chains=MESH_CHAINS,
                         device=DEVICE, mesh=plan)
        _sync(torch)
        secs = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    finally:
        ops.bernoulli_logit_sum_rows = plain_rows
    evals = evaluations() - e0
    collectives = dict(world.COLLECTIVES)
    shard_rows = pm.data["y"].shape[0] // plan.num_data_shards
    check(all(np.isfinite(mix[k]).all() for k in mix.names())
          and np.isfinite(mix.stats["logp"]).all(),
          f"rank {rank}: non-finite draws on the 2 x 2 mesh")
    check(evals > 0 and collectives.get("data") == evals,
          f"rank {rank}: {collectives} collectives for {evals} gradient "
          "evaluations on the 2 x 2 mesh (one data-axis all-reduce each)")
    check(launches["bernoulli_logit_sum"] == evals
          and launches["std_normal_sum"] == evals
          and rows_seen and all(r[-1] == shard_rows for r in rows_seen),
          f"rank {rank}: launches {launches} for {evals} evaluations, "
          f"bernoulli rows {sorted(set(rows_seen))} (expected n = "
          f"{shard_rows})")
    digest = hashlib.sha1(b"".join(
        np.ascontiguousarray(mix[k]).tobytes() for k in mix.names())
        + np.ascontiguousarray(mix.stats["logp"]).tobytes()).hexdigest()
    out["mix"] = {
        "seconds": secs, "transitions": warm + n,
        "ms_a_transition": secs / (warm + n) * 1e3,
        "evaluations": evals, "collectives": collectives,
        "collective_s": dict(world.COLLECTIVE_S),
        "collectives_per_evaluation": collectives["data"] / evals,
        "launches": launches, "bernoulli_rows": sorted(set(rows_seen)),
        "hash": digest, "w": mix["w"], "mean_accept":
        float(mix.stats["accept_prob"].mean())}
    step("mix")

    # the chains-only segmented run, preempted and resumed
    warm, n, every = MESH_SEGMENTED
    kw = dict(num_warmup=warm, num_chains=MESH_CHAINS, device=DEVICE,
              mesh=chains_only, checkpoint_every=every)
    seg_kern = _mesh_hmc(pm, True)
    full = run_chains(2, pm.model, seg_kern, n,
                      checkpoint_dir=os.path.join(ckpt_root, "full"), **kw)
    d = os.path.join(ckpt_root, "resume")
    part = run_chains(2, pm.model, seg_kern, n, checkpoint_dir=d,
                      preemption=ScriptedPreemption(after_polls=2), **kw)
    resumed = run_chains(2, pm.model, seg_kern, n, checkpoint_dir=d, **kw)
    check(part.health.preempted and resumed.health.resumed_from ==
          part.health.completed and same_results(np, resumed, full),
          f"rank {rank}: the mesh run resumed from "
          f"{resumed.health.resumed_from} differs from the uninterrupted one")
    out["segmented"] = {"preempted_at": part.health.completed,
                        "snapshots": full.health.snapshots}
    step("segmented")
    if DEVICE != "cpu":
        mib = 1 << 20
        out["memory"] = {
            "max_allocated_mib": torch.cuda.max_memory_allocated() / mib,
            "reserved_mib": torch.cuda.memory_reserved() / mib}
    return out


def mesh_phase(torch, np):
    """Phase 6g. (a) The trivial plan in this process equals no mesh bit
    for bit. (b) A world of ``MESH_WORLD`` ranks spawned on the card
    (gloo over CUDA tensors; the kernels this process built are loaded
    from the build directory), with a time limit that kills every rank
    and fails the phase, runs :func:`mesh_rank` on each. Then the 2 x 2
    run's posterior mean of w is held to the single-device run's, here,
    and the two ranks of each data group to each other."""
    import shutil
    import tempfile

    from repro_torch.infer import effective_sample_size, run_chains
    from repro_torch.sharding import ShardedRun, spawn_world

    t_start = time.perf_counter()
    pm = build_model("logreg")
    kern = _mesh_hmc(pm, False)
    counts_reset(torch)
    trivial = run_chains(0, pm.model, kern, MESH_DRAWS,
                         num_chains=MESH_CHAINS, device=DEVICE,
                         mesh=ShardedRun.plan())
    launches = [counts_read(torch)[0]]
    alone = run_chains(0, pm.model, kern, MESH_DRAWS, num_chains=MESH_CHAINS,
                       device=DEVICE)
    check(same_results(np, trivial, alone),
          "mesh: the trivial plan differs from no mesh")
    log(f"mesh (a): run_chains(mesh=ShardedRun.plan()) in one process is "
        f"{ShardedRun.plan()!r} and equals run_chains() bit for bit")

    warm, n = MESH_MIX
    single_kern = _mesh_hmc(pm, True)
    run_chains(1, pm.model, single_kern, 2, num_warmup=1,
               num_chains=MESH_CHAINS, device=DEVICE)
    _sync(torch)
    t0 = time.perf_counter()
    single = run_chains(1, pm.model, single_kern, n, num_warmup=warm,
                        num_chains=MESH_CHAINS, device=DEVICE)
    _sync(torch)
    single_ms = (time.perf_counter() - t0) / (warm + n) * 1e3

    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t0, spawned = time.perf_counter(), time.time()
        ranks = spawn_world(mesh_rank, MESH_WORLD, args=(root,),
                            device=DEVICE, timeout_s=MESH_TIMEOUT_S)
        world_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    log(f"mesh (b): {MESH_WORLD} ranks on one card, backend "
        f"{r0['backend']}, in {world_s:.1f} s; gloo on CUDA tensors: "
        + ", ".join(f"{k} {v}" for k, v in r0["gloo_ops"].items()))
    for shards, d in r0["densities"].items():
        worst_v = max(r["densities"][shards]["value_rel_err"] for r in ranks)
        worst_g = max(r["densities"][shards]["grad_rel_err"] for r in ranks)
        log(f"mesh density, {d['plan']}: rows a rank {d['rows']}, value "
            f"rel err {worst_v:.2e} (limit {MESH_VALUE_RTOL}), gradient "
            f"{worst_g:.2e} of max |grad| (limit {MESH_GRAD_RTOL}) at "
            f"{MESH_POINTS} points, worst of {MESH_WORLD} ranks")

    # the 2 x 2 run: data groups identical, w's mean against the
    # single-device run's
    for a, b in ((0, 1), (2, 3)):
        check(ranks[a]["mix"]["hash"] == ranks[b]["mix"]["hash"],
              f"mesh: ranks {a} and {b} of one data group end apart")
    w_mesh = r0["mix"]["w"].astype(np.float64)
    w_one = single["w"].astype(np.float64)
    worst = 0.0
    for i in range(w_mesh.shape[-1]):
        se = [x[..., i].std() / np.sqrt(effective_sample_size(x[..., i]))
              for x in (w_mesh, w_one)]
        z = (w_mesh[..., i].mean() - w_one[..., i].mean()) / np.hypot(*se)
        check(np.isfinite(z) and abs(z) < MESH_N_SE,
              f"mesh: mean of w[{i}] {w_mesh[..., i].mean():.5f} on the "
              f"2 x 2 mesh vs {w_one[..., i].mean():.5f} on one device: "
              f"{z:.2f} standard errors, limit {MESH_N_SE}")
        worst = max(worst, abs(float(z)))
    mix = [r["mix"] for r in ranks]
    share = [m["collective_s"].get("data", 0.0) / m["seconds"] for m in mix]
    log(f"mesh chains x data 2 x 2, {warm} + {n} draws of {MESH_CHAINS} "
        f"chains: finite, w's mean within {worst:.2f} standard errors of "
        f"the single-device run's (limit {MESH_N_SE}); data groups {{0, 1}}"
        f" and {{2, 3}} identical (sha1 {r0['mix']['hash'][:12]}, "
        f"{ranks[2]['mix']['hash'][:12]}); collectives a gradient "
        f"evaluation {[m['collectives_per_evaluation'] for m in mix]}; "
        f"bernoulli_logit_sum "
        f"{[m['launches']['bernoulli_logit_sum'] for m in mix]} "
        f"launches a rank at rows {r0['mix']['bernoulli_rows']}")
    log(f"mesh ms a transition (four processes time-sharing one card, not "
        f"a speed figure): chains x data 2 x 2 eager "
        f"{[round(m['ms_a_transition'], 3) for m in mix]} (the data-axis "
        f"gloo all-reduce {[round(s * 100, 1) for s in share]} % of it), "
        f"chains only 4 x 1 replayed "
        f"{[round(r['chains_only']['ms_a_draw'], 3) for r in ranks]} ms a "
        f"draw; one device alone, replayed, {single_ms:.3f} ms a transition "
        f"({warm} + {n})")
    worst_d = max(r["chains_only"]["max_abs_diff"] for r in ranks)
    log(f"mesh chains only 4 x 1: {MESH_DRAWS} draws against the unsharded "
        f"run max |d| {worst_d:.2e}"
        f" (limit {MESH_DRAW_TOL}), transitions replayed as graphs on every "
        f"rank ({[r['chains_only']['replays'] for r in ranks]}); segmented "
        f"{MESH_SEGMENTED[0]} + {MESH_SEGMENTED[1]} in segments of "
        f"{MESH_SEGMENTED[2]}, preempted at "
        f"{r0['segmented']['preempted_at']} and resumed = uninterrupted "
        f"bit for bit")
    log("mesh host seconds a rank: to enter the world "
        + ", ".join(f"{r['entered'] - spawned:.1f}" for r in ranks) + "; "
        + "; ".join(f"{k} " + ", ".join(f"{r['steps_s'][k]:.1f}"
                                         for r in ranks)
                    for k in r0["steps_s"]))
    if "memory" in r0:
        log("mesh memory a rank (max allocated / reserved, MiB): "
            + ", ".join(f"{r['memory']['max_allocated_mib']:.1f} / "
                        f"{r['memory']['reserved_mib']:.1f}" for r in ranks))
    launches += [m["launches"] for m in mix]
    out = {"world": MESH_WORLD, "backend": r0["backend"],
           "gloo_ops": r0["gloo_ops"],
           "world_s": world_s, "single_ms_a_transition": single_ms,
           "w_worst_z": worst, "collective_share": share,
           "ranks": [{k: v for k, v in r.items() if k != "mix"}
                     | {"mix": {k: v for k, v in r["mix"].items()
                                if k != "w"}} for r in ranks],
           "launches": launches}
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 6g done in {out['seconds']:.1f} s")
    return out


def table1(torch, np):
    """Table 1's three variants of one HMC chain (``benchmarks/table1.py``)
    for each paper model, on the card: ``make_chain_fn`` of the model's
    fused log-density (typed) and of its hand-written twin, and
    ``HMC.run_untyped`` (the per-site evaluator replayed eagerly, autograd
    and a NumPy loop) timed on its draw loop alone (its setup, a 1-draw
    run less one draw, is reported apart). ``TABLE1_REPS`` repetitions in
    turn; each row carries the median µs a draw and the spread of each
    ratio over the repetitions. Each chain's transition is a program: one
    whole chain runs first (its eager call and capture), and the timed
    chains replay its graph; on ``TABLE1_EAGER`` the typed and hand-written
    chains are also timed once under ``disable_capture()``
    (``table1_eager/...`` lines). Information lines: only a NaN or a
    failed run fails the phase. Returns the typed runs' counts and the
    rows."""
    from repro_torch.core.program import disable_capture
    from repro_torch.infer.hmc import HMC, make_chain_fn
    from repro_torch.models import MODEL_NAMES

    runs, rows = {}, []
    for name in MODEL_NAMES:
        iters, u_iters = TABLE1_DRAWS.get(name, TABLE1_DEFAULT)
        pm = build_model(name)
        tvi = pm.model.typed_varinfo(
            torch.Generator(device=DEVICE).manual_seed(42)).link()
        q0 = tvi.flat()
        collect = q0.shape[0] <= 1024  # no 2000 x 10,000 draws
        hmc = HMC(step_size=pm.step_size, n_leapfrog=pm.n_leapfrog)
        chains = {}
        for label, logdensity in (
                ("typed", pm.model.make_logdensity_fn(tvi)),
                ("handwritten", pm.handwritten)):
            chains[label] = make_chain_fn(logdensity, iters, pm.step_size,
                                          pm.n_leapfrog, collect=collect)
            # one whole chain first: its transition program's eager call
            # and capture, so the timed chains replay (as repro's Table 1
            # times a compiled chain)
            chains[label](torch.Generator(device=DEVICE).manual_seed(0), q0)

        def timed(label, eager=False):
            gen = torch.Generator(device=DEVICE).manual_seed(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with disable_capture() if eager else contextlib.nullcontext():
                outs = chains[label](gen, q0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(not bool(torch.isnan(outs[1]).any()),
                  f"table1 {name} {label}: NaN logp")
            return secs / iters

        def untyped(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ch = hmc.run_untyped(0, pm.model, n, init_varinfo=tvi.invlink(),
                                 device=DEVICE)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(not np.isnan(ch.stats["logp"]).any(),
                  f"table1 {name} untyped: NaN logp")
            return secs

        untyped(1)  # the "package" program and first-call costs
        counts_reset(torch)
        reps = []
        for r in range(TABLE1_REPS):
            typed_s = timed("typed")
            if r == 0:
                runs[name], _ = counts_read(torch)
            hand_s = timed("handwritten")
            one = untyped(1)
            loop_s = (untyped(1 + u_iters) - one) / u_iters
            reps.append((typed_s, hand_s, loop_s, one - loop_s))
        med = np.median(np.asarray(reps), axis=0)
        t_h = [t / h for t, h, _, _ in reps]
        u_t = [u / t for t, _, u, _ in reps]
        row = {"model": name, "iters": iters, "untyped_iters": u_iters,
               "reps": TABLE1_REPS,
               "typed_us": med[0] * 1e6, "handwritten_us": med[1] * 1e6,
               "untyped_us": med[2] * 1e6, "untyped_setup_ms": med[3] * 1e3,
               "typed_vs_handwritten": [min(t_h), float(np.median(t_h)),
                                        max(t_h)],
               "untyped_over_typed": [min(u_t), float(np.median(u_t)),
                                      max(u_t)],
               "reps_us": [[x * 1e6 for x in rep[:3]] for rep in reps],
               "typed_launches": runs[name]}
        rows.append(row)
        log(f"table1/{name}/typed,{row['typed_us']:.2f},"
            f"median_of={TABLE1_REPS};iters={iters}")
        log(f"table1/{name}/handwritten,{row['handwritten_us']:.2f},"
            f"median_of={TABLE1_REPS};iters={iters}")
        log(f"table1/{name}/untyped,{row['untyped_us']:.2f},"
            f"median_of={TABLE1_REPS};loop_iters={u_iters};"
            f"setup_ms={row['untyped_setup_ms']:.1f};"
            "typed_vs_handwritten={:.3f}[{:.3f}-{:.3f}];"
            "untyped_over_typed={:.3f}[{:.3f}-{:.3f}]".format(
                *row["typed_vs_handwritten"][1::-1],
                row["typed_vs_handwritten"][2],
                *row["untyped_over_typed"][1::-1],
                row["untyped_over_typed"][2]))
        if name in TABLE1_EAGER:  # the same chains run op by op, once
            for label in ("typed", "handwritten"):
                row[f"{label}_eager_us"] = timed(label, eager=True) * 1e6
                log(f"table1_eager/{name}/{label},"
                    f"{row[f'{label}_eager_us']:.2f},iters={iters}")
    return runs, rows


def table1_profile(torch, np, name="logreg", calls=10):
    """Where a Table-1 draw's time goes on ``name``: one gradient
    evaluation (a leapfrog step's work) of the typed density (the fused
    log-density under ``torch.func``), the hand-written twin (the same
    transform) and the untyped path (the per-site evaluator replayed
    eagerly with ``torch.autograd`` and the host round trip of
    ``run_untyped``), on one chain. Per evaluation: host µs (CUDA-synced
    clock, unprofiled), aten events (nested ones included) and kernel
    launches and device µs under ``torch.profiler``; and, for the typed
    one, the Python functions with the most own time under ``cProfile``."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.contexts import DefaultContext
    from repro_torch.infer.hmc import value_and_grad

    pm = build_model(name)
    tvi = pm.model.typed_varinfo(
        torch.Generator(device=DEVICE).manual_seed(42)).link()
    q0 = tvi.flat()
    q_np = q0.cpu().numpy()
    typed = value_and_grad(pm.model.make_logdensity_fn(tvi))
    hand = value_and_grad(pm.handwritten)
    ctx = DefaultContext()

    def untyped():  # infer/hmc.py run_untyped's logp_and_grad
        u = torch.as_tensor(q_np, device=DEVICE).requires_grad_(True)
        lp = pm.model._eval_logp(tvi.replace_flat(u), ctx, eager=True)
        (g,) = torch.autograd.grad(lp, u)
        return float(lp.detach()), g.detach().cpu().numpy()

    out = {"model": name}
    for label, fn in (("typed", lambda: typed(q0)),
                      ("handwritten", lambda: hand(q0)),
                      ("untyped", untyped)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) / calls * 1e6
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type.name == "CUDA" and device_us(e) > 0]
        aten = [e for e in events if e.key.startswith("aten::")]
        out[label] = {
            "host_us": host_us,
            "aten_events": sum(e.count for e in aten) / calls,
            "kernel_launches": sum(e.count for e in kernels) / calls,
            "device_us": sum(device_us(e) for e in kernels) / calls,
            "top_aten": [[e.key, e.count / calls] for e in
                         sorted(aten, key=lambda e: -e.count)[:6]]}
        log(f"table1 profile {name} {label}: {host_us:.1f} us a gradient "
            f"evaluation; {out[label]['aten_events']:.0f} aten events, "
            f"{out[label]['kernel_launches']:.0f} kernel launches, "
            f"{out[label]['device_us']:.1f} us on the device")
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(calls):
        typed(q0)
    torch.cuda.synchronize()
    pr.disable()
    stats = pstats.Stats(pr)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:8]
    out["typed_cprofile"] = [
        {"function": f"{Path(f).name}:{line}({fn})", "calls": nc / calls,
         "own_us": tt / calls * 1e6, "cumulative_us": ct / calls * 1e6}
        for (f, line, fn), (_, nc, tt, ct, _) in top]
    log(f"table1 profile {name} typed: own time under cProfile "
        "(us an evaluation):")
    for t in out["typed_cprofile"]:
        log(f"    {t['own_us']:9.1f} own {t['cumulative_us']:9.1f} cum "
            f"x{t['calls']:<5.0f} {t['function'][:90]}")
    return out


# ---------------------------------------------------------------------------
# phase 7: timing
# ---------------------------------------------------------------------------
def time_ms(torch, fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


# launches per call of every hand-written kernel: the kernel and its
# per-row finish (categorical_logits_sum_small), except mvn_quadform_sum,
# the one-launch reductions (std_normal_sum, gamma_unnorm_sum,
# beta_unnorm_sum, student_t_unnorm_sum, normal_sum, bernoulli_logit_sum),
# the large-C categorical_logits_sum, fused_leapfrog and
# fused_potential_vg, whose last block of a row (a chain) sums the row's
# partials inside the one launch (a row of one block writes its sum itself)
KERNEL_LAUNCHES_PER_CALL = 2
LAUNCHES_PER_CALL = {"mvn_quadform_sum": 1, "std_normal_sum": 1,
                     "gamma_unnorm_sum": 1, "beta_unnorm_sum": 1,
                     "student_t_unnorm_sum": 1, "normal_sum": 1,
                     "bernoulli_logit_sum": 1, "categorical_logits_sum": 1,
                     "fused_leapfrog": 1, "fused_potential_vg": 1}


WINDOW_PAD_S = 0.02  # host seconds between a profiler window's edges and its calls


def device_ms(torch, fn, iters=50, attempts=3, launches_per_call=None,
              names=None):
    """Device time per call of every CUDA kernel that ``fn`` launches, from
    torch.profiler (only those whose name holds one of ``names``, when
    given). The profiler now and then records a window without some of
    its device activity (most often the window's first kernel, so each
    window starts with a marker launch, ``torch.cuda._sleep``'s
    spin_kernel, left out of the sums), and the calls start WINDOW_PAD_S
    after the window opens and end WINDOW_PAD_S before it closes (the
    profiler keeps only device activity whose time, carried onto the
    host's clock, falls inside the window, and that time can land
    hundreds of microseconds early: probes/profiler_windows.py): a window
    that shows none, or (given ``launches_per_call``) another number of
    kernels than ``iters`` times that, is taken again. None when no
    attempt's trace is whole."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(WINDOW_PAD_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(WINDOW_PAD_S)
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and device_us(e) > 0
                  and "spin_kernel" not in e.key
                  and (names is None or any(n in e.key for n in names))]
        total = sum(device_us(e) for e in events)
        launches = sum(e.count for e in events)
        if total > 0 and launches_per_call in (None, launches / iters):
            return total / 1e3 / iters
    return None


def launch_floor(torch):
    """The card's floor for one launch: a one-block PyTorch kernel (zero_()
    of 4 floats) timed as time_kernels times a kernel, device time from
    the profiler and issued time from back-to-back calls."""
    x = torch.ones(4, device=DEVICE)
    issued = [time_ms(torch, x.zero_) for _ in range(2)]
    dev_ms = device_ms(torch, x.zero_, launches_per_call=1)
    row = {"name": "zero_ of 4 floats", "ms": dev_ms,
           "issued_ms": min(issued), "issued_ms_runs": issued,
           "ms_from": "torch.profiler device time" if dev_ms is not None
           else "not measured (no whole device trace)"}
    device = f"{dev_ms * 1e3:.2f}" if dev_ms is not None else "not measured"
    log(f"one-launch floor (zero_() of 4 floats, one block), us: device "
        f"{device} / issued {row['issued_ms'] * 1e3:.2f}")
    return row


def logpdf_case(torch, F, ops, ref, name, shape, gen):
    """Inputs at ``shape``, the kernel's wrapper, its plain version, one
    library call computing the same function, negated (a loss; None where
    there is none), and the bytes and float operations the function
    needs."""
    dev = torch.device(DEVICE)
    r, n = shape[:2]
    z = torch.randn(r, n, generator=gen, device=dev)
    if name == "std_normal_sum":
        zeros, ones = torch.zeros_like(z), torch.ones_like(z)

        def library():
            return F.gaussian_nll_loss(z, zeros, ones, full=True,
                                       reduction="none").sum(-1)

        return ((z,), ops.std_normal_sum_rows, ref.std_normal_logpdf_sum_ref,
                library, 4 * r * n + 4 * r, STD_NORMAL_OPS * r * n)
    if name == "bernoulli_logit_sum":
        y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
        ys = y.expand(r, n)  # stride 0, as on the main path

        def library():
            return F.binary_cross_entropy_with_logits(
                z, ys, reduction="none").sum(-1)

        return ((z, ys), ops.bernoulli_logit_sum_rows,
                ref.bernoulli_logits_logpmf_sum_ref, library,
                4 * r * n + 4 * n + 4 * r,  # y read once
                BERNOULLI_OPS * r * n)
    if name == "gamma_unnorm_sum":
        x = 0.05 + 4.0 * torch.rand(r, n, generator=gen, device=dev)
        am1 = torch.rand(n, generator=gen, device=dev).expand(r, n)
        rate = (0.5 + torch.rand(n, generator=gen, device=dev)).expand(r, n)
        return ((x, am1, rate), ops.gamma_unnorm_sum_rows,
                ref.gamma_unnorm_logpdf_sum_ref, None,
                4 * r * n + 8 * n + 4 * r,  # am1, rate read once (stride 0)
                GAMMA_OPS * r * n)
    if name == "normal_sum":
        if n == 10000:  # gauss_unknown: shared x, one mu and sigma per chain
            x = (1.5 + 0.7 * z[0]).expand(r, n)
            mu = (1.5 + 0.1 * torch.randn(r, 1, generator=gen, device=dev))
            sig = 0.5 + torch.rand(r, 1, generator=gen, device=dev)
            nbytes = 4 * n + 8 * r + 4 * r
        else:  # x per row, mu and sigma shared by the rows
            x = z
            mu = torch.randn(n, generator=gen, device=dev)
            sig = 0.5 + torch.rand(n, generator=gen, device=dev)
            nbytes = 4 * r * n + 8 * n + 4 * r
        mu, sig = mu.expand(r, n), sig.expand(r, n)
        var = sig * sig  # the library call's parameter, made once

        def library():  # one call; the sum over every row
            return F.gaussian_nll_loss(mu, x, var, full=True,
                                       reduction="sum")

        return ((x, mu, sig), ops.normal_sum_rows, ref.normal_logpdf_sum_ref,
                library, nbytes, NORMAL_OPS * r * n)
    if name == "beta_unnorm_sum":
        x = 0.01 + 0.98 * torch.rand(r, n, generator=gen, device=dev)
        am1 = torch.rand(n, generator=gen, device=dev).expand(r, n)
        bm1 = (2.0 * torch.rand(n, generator=gen, device=dev)).expand(r, n)
        return ((x, am1, bm1), ops.beta_unnorm_sum_rows,
                ref.beta_unnorm_logpdf_sum_ref, None,
                4 * r * n + 8 * n + 4 * r,  # am1, bm1 read once (stride 0)
                BETA_OPS * r * n)
    if name == "student_t_unnorm_sum":
        df = (0.5 + 30.0 * torch.rand(n, generator=gen, device=dev))
        return ((3.0 * z, df.expand(r, n)), ops.student_t_unnorm_sum_rows,
                ref.student_t_unnorm_logpdf_sum_ref, None,
                4 * r * n + 4 * n + 4 * r,  # df read once (stride 0)
                STUDENT_T_OPS * r * n)
    if name == "mvn_quadform_sum":
        d = shape[2]
        xc = torch.randn(r, n, d, generator=gen, device=dev)
        prec = precision(torch, d, gen)

        def library():  # one call: sum_n xc_n^T P xc_n per row
            return torch.einsum("bnd,de,bne->b", xc, prec, xc)

        return ((xc, prec.expand(r, d, d)), ops.mvn_quadform_sum_rows,
                ref.mvnormal_prec_quadform_sum_ref, library,
                4 * r * n * d + 4 * d * d + 4 * r,  # P read once (stride 0)
                2 * r * n * d * d + 2 * r * n * d)
    c = shape[2]
    logits = 3.0 * torch.randn(r, n, c, generator=gen, device=dev)
    labels = torch.randint(0, c, (n,), generator=gen, device=dev,
                           dtype=torch.int32).expand(r, n)
    targets = labels.reshape(-1).long()  # the library call's label type

    def library():
        return F.cross_entropy(logits.reshape(-1, c), targets,
                               reduction="none").reshape(r, n).sum(-1)

    return ((logits, labels), ops.categorical_logits_sum_rows,
            ref.categorical_logits_logpmf_sum_ref, library,
            4 * r * n * c + 4 * n + 4 * r,  # labels read once (stride 0)
            r * n * (CATEGORICAL_CLASS_OPS * c + CATEGORICAL_ITEM_OPS))


# how a library call's result compares with the kernel's: the negated loss
# per row, except gaussian_nll_loss summed over every row and the einsum's
# quadratic form, which the kernel halves and negates
LIBRARY_HOLD = {"normal_sum": lambda lib, k: (-lib, k.sum()),
                "mvn_quadform_sum": lambda lib, k: (-0.5 * lib, k)}


# shapes timed beside MAIN_SHAPES: bernoulli's row of many blocks
TIMED_WIDE = {"bernoulli_logit_sum": [(1, 1_000_003)]}


def time_kernels(torch, F, ops, ref):
    """Each fused_logpdf kernel at the main paths' shapes (and
    ``TIMED_WIDE``'s) beside its plain version and one library call: device time from the profiler (``*_ms``)
    and CUDA-event time over back-to-back calls from the host
    (``*_issued_ms``, the wrapper's host cost at these sizes)."""
    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(7)
    rows = []
    for name, shapes in MAIN_SHAPES.items():
        for shape in shapes + TIMED_WIDE.get(name, []):
            args, kern, plain, library, nbytes, nops = logpdf_case(
                torch, F, ops, ref, name, shape, gen)
            calls = {"": lambda: kern(*args), "plain_": lambda: plain(*args)}
            row = {"name": name, "shape": list(shape),
                   "ms_from": "torch.profiler device time"}
            if library is not None:
                # hold the library call to the kernel before timing it
                torch.testing.assert_close(
                    *LIBRARY_HOLD.get(name, lambda lib, k: (-lib, k))(
                        library(), kern(*args)), rtol=1e-5, atol=0)
                calls["library_"] = library
            # plain, kernel, kernel, plain: compare within one call
            for prefix in ("plain_", "", "", "plain_"):
                row.setdefault(f"{prefix}issued_ms_runs", []).append(
                    time_ms(torch, calls[prefix]))
            if library is not None:
                row["library_issued_ms_runs"] = [time_ms(torch, library)]
            else:
                row.update(library_ms=None, library_issued_ms=None,
                           library_none_because=NO_LIBRARY[name])
            for prefix, fn in calls.items():
                row[f"{prefix}issued_ms"] = min(row[f"{prefix}issued_ms_runs"])
                row[f"{prefix}ms"] = device_ms(
                    torch, fn, launches_per_call=LAUNCHES_PER_CALL.get(
                        name, KERNEL_LAUNCHES_PER_CALL)
                    if prefix == "" else None)
                if row[f"{prefix}ms"] is None:  # no whole device trace
                    row[f"{prefix}ms"] = row[f"{prefix}issued_ms"]
                    row["ms_from"] = "cuda events (no whole device trace)"
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / FP32_FLOPS_PER_S * 1e3
            row.update(bytes=nbytes, ops=nops, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bound_fp32_ms=max(t_bytes, t_ops))
            if name == "mvn_quadform_sum":
                # the kernel's products: three TF32 passes (3xTF32) of
                # 2 N D^2 flops a row at the tensor cores' TF32 rate
                r_, n_, d_ = shape
                t_tc = 3 * 2 * r_ * n_ * d_ * d_ / TF32_FLOPS_PER_S * 1e3
                row.update(tf32_ops=3 * 2 * r_ * n_ * d_ * d_,
                           bound_ms=max(t_bytes, t_tc),
                           bound_by="bytes" if t_bytes >= t_tc
                           else "operations")
            rows.append(row)
            lib = (f"library {row['library_ms'] * 1e3:.2f} / "
                   f"{row['library_issued_ms'] * 1e3:.2f}"
                   if library is not None else "library: none")
            log(f"time {name} {'x'.join(map(str, shape))} ({row['ms_from']} "
                f"/ issued from the host), us: kernel {row['ms'] * 1e3:.2f} / "
                f"{row['issued_ms'] * 1e3:.2f}, plain "
                f"{row['plain_ms'] * 1e3:.2f} / "
                f"{row['plain_issued_ms'] * 1e3:.2f}, {lib}, bound "
                f"{row['bound_ms'] * 1e3:.4f} ({row['bound_by']}; FP32 "
                f"{row['bound_fp32_ms'] * 1e3:.4f})")
    return rows


# coefficient arrays (of c0..c3) each opcode's kernel reads, as
# kCoeffsRead in fused_leapfrog.cu
COEFFS_READ = {0: 0, 1: 2, 2: 3, 3: 2, 4: 4}


def table_read_bytes(spec) -> int:
    """Bytes of the opcode table one fused_leapfrog call reads, once for
    every chain: 4 B per coordinate for each coefficient array the opcode
    uses; the any-opcode kernel reads op and all four."""
    if spec.uniform_op is None:
        return (4 + 4 * 4) * spec.dim
    return 4 * COEFFS_READ[spec.uniform_op] * spec.dim


def leapfrog_ops(spec, rows, n_steps) -> int:
    """Float operations of one fused_leapfrog call (``n_steps`` of kicks,
    drift and gradient, then the value and its add into the sum), and of
    one fused_potential_vg call at ``n_steps=None``, counted per opcode as
    the source writes them."""
    import numpy as np
    count = np.bincount(spec.op, minlength=len(LF_GRAD_OPS))
    grad = sum(int(c) * LF_GRAD_OPS[k] for k, c in enumerate(count))
    value = sum(int(c) * (LF_VALUE_OPS[k] + 1) for k, c in enumerate(count))
    if n_steps is None:
        return rows * (grad + value)
    return rows * (n_steps * (LEAPFROG_KICK_OPS * spec.dim + grad) + value)


def time_leapfrog_kernels(torch, lf_ops, lf_ref, specs, n_steps=4, rows=4):
    """Both fused_leapfrog kernels at the main paths' shapes (``specs``
    maps a path to its compiled spec: gaussian_10k's uniform NORMAL table
    and family_mix_8k's mixed one; 4 chains, 4 steps) beside their plain
    versions, timed as in :func:`time_kernels`, and fused_potential_vg at
    the same states. No library call computes either function."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = []
    for path, spec in specs.items():
        dim = spec.dim
        q = torch.randn(rows, dim, generator=gen, device=dev)
        p = torch.randn(rows, dim, generator=gen, device=dev)
        eps = torch.full((rows,), 0.1, device=dev)
        _, g = lf_ops.potential_value_and_grad(spec, q)
        table_bytes = table_read_bytes(spec)
        state = 4 * rows * dim
        cases.append((
            "fused_leapfrog", path, [rows, dim, n_steps],
            lambda s=spec, q=q, p=p, g=g, e=eps: lf_ops.fused_leapfrog(
                s, q, p, g, e, n_steps),
            lambda s=spec, q=q, p=p, g=g, e=eps: lf_ref.leapfrog_ref(
                s, q, p, g, e, n_steps),
            # q, p, g and eps in; q, p, g and the potential out
            6 * state + table_bytes + 8 * rows,
            leapfrog_ops(spec, rows, n_steps)))
        cases.append((
            "fused_potential_vg", path, [rows, dim],
            lambda s=spec, q=q: lf_ops.potential_value_and_grad(s, q),
            lambda s=spec, q=q: lf_ref.potential_value_and_grad_ref(s, q),
            2 * state + table_bytes + 4 * rows,
            leapfrog_ops(spec, rows, None)))
    out = []
    for name, path, shape, kern, plain, nbytes, nops in cases:
        row = {"name": name, "shape": shape, "call": path,
               "ms_from": "torch.profiler device time"}
        calls = {"": kern, "plain_": plain}
        for prefix in ("plain_", "", "", "plain_"):
            row.setdefault(f"{prefix}issued_ms_runs", []).append(
                time_ms(torch, calls[prefix]))
        for prefix, fn in calls.items():
            row[f"{prefix}issued_ms"] = min(row[f"{prefix}issued_ms_runs"])
            row[f"{prefix}ms"] = device_ms(
                torch, fn, launches_per_call=LAUNCHES_PER_CALL.get(
                    name, KERNEL_LAUNCHES_PER_CALL)
                if prefix == "" else None)
            if row[f"{prefix}ms"] is None:
                row[f"{prefix}ms"] = row[f"{prefix}issued_ms"]
                row["ms_from"] = "cuda events (no whole device trace)"
        row.update(library_ms=None, library_issued_ms=None,
                   library_none_because=NO_LIBRARY[name])
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_FLOPS_PER_S * 1e3
        row.update(bytes=nbytes, ops=nops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        out.append(row)
        log(f"time {name} {path} {'x'.join(map(str, shape))} "
            f"({row['ms_from']} / issued from the host), us: kernel "
            f"{row['ms'] * 1e3:.2f} / {row['issued_ms'] * 1e3:.2f}, plain "
            f"{row['plain_ms'] * 1e3:.2f} / {row['plain_issued_ms'] * 1e3:.2f}"
            f", bound {row['bound_ms'] * 1e3:.4f} ({row['bound_by']}); "
            f"library: none ({NO_LIBRARY[name]})")
    return out


def profile_transitions(torch, pm, kernel, spec=None, steps=20,
                        route="fused"):
    """Device busy share and top kernels over ``steps`` transitions of one
    model; ``spec`` (a compiled PotentialSpec or CondPotentialSpec)
    selects the fused or the conditional integrator, ``route="switch"``
    the per-site evaluator with the per-array switch on."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import use_fused_logpdf

    switch = route == "switch"
    with use_fused_logpdf() if switch else contextlib.nullcontext():
        return _profile_transitions(torch, pm, kernel, spec, steps, switch,
                                    ProfilerActivity, profile)


def _profile_transitions(torch, pm, kernel, spec, steps, switch,
                         ProfilerActivity, profile):
    from repro_torch.infer.chains import TransitionPrograms

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    tvi = pm.model.typed_varinfo(gen).link()
    kern = kernel.make_kernel(pm.model.make_logdensity_fn(
        tvi, backend="reference" if switch else "fused"), tvi.num_flat,
        spec=spec)
    integrator = ("autodiff" if spec is None else "conditional"
                  if type(spec).__name__ == "CondPotentialSpec" else "fused")
    label = f"{pm.name} ({integrator}{', switch route' if switch else ''})"
    state = kern.init(tvi.flat().expand(4, tvi.num_flat).contiguous())
    for _ in range(5):
        state, out = kern.step(state, gen)
    eager = _transition_window(torch, label, lambda: kern.step(state, gen),
                               steps, ProfilerActivity, profile)
    # the same transition as run_chains replays it: the step program over
    # its buffers (the first call eager, the second captured), then the
    # window over replays alone
    progs = TransitionPrograms(kern)
    bufs = tuple(x.clone() for x in state[:3]) + (state[3], state[4])
    draws = {k: torch.empty(v.shape[:1] + (max(steps, 3),) + v.shape[1:],
                            dtype=v.dtype, device=DEVICE)
             for k, v in out.items()}
    idx = torch.zeros((1,), dtype=torch.int64, device=DEVICE)
    for _ in range(3):
        progs.step(bufs, draws, idx, gen)
    idx.zero_()
    replay = _transition_window(
        torch, label + " replayed",
        lambda: progs.step(bufs, draws, idx, gen), steps, ProfilerActivity,
        profile)
    check(progs.step.captures == 1 and progs.step.replays == steps + 2,
          f"profile {label}: the step program was captured "
          f"{progs.step.captures} times and replayed {progs.step.replays}")
    if eager["kernels_per_transition"] and replay["kernels_per_transition"]:
        log(f"    {label}: {replay['kernels_per_transition']:.0f} kernels a "
            f"replay against {eager['kernels_per_transition']:.0f} eager; "
            f"wall {replay['wall_ms_per_transition']:.3f} ms against "
            f"{eager['wall_ms_per_transition']:.3f}")
    return {**eager, "replay": replay}


def _transition_window(torch, label, fn, steps, ProfilerActivity, profile):
    """The profiler over ``steps`` calls of ``fn``: wall and device ms,
    busy share, kernels, and the host syncs and copies (runtime calls whose
    name holds Synchronize or Memcpy, by name) a transition."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_PAD_S)  # as device_ms pads its windows
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(WINDOW_PAD_S)
    events = prof.key_averages()
    kernels = [(e.key, device_us(e), e.count) for e in events
               if device_us(e) > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(k[1] for k in kernels)
    kernels.sort(key=lambda k: -k[1])
    host = sorted((e for e in events if e.device_type.name == "CPU"),
                  key=lambda e: -e.self_cpu_time_total)
    # the window's own closing cudaDeviceSynchronize is left out
    syncs = {e.key: e.count / steps for e in events
             if ("Synchronize" in e.key or "Memcpy" in e.key)
             and e.device_type.name == "CPU"}
    syncs.pop("cudaDeviceSynchronize", None)
    out = {"model": label, "transitions": steps,
           "wall_ms_per_transition": wall * 1e3 / steps,
           "device_ms_per_transition": busy_us / 1e3 / steps,
           "busy_share": busy_us / 1e6 / wall if busy_us else None,
           "kernels_per_transition": sum(k[2] for k in kernels) / steps,
           "syncs_or_copies_per_transition": sum(syncs.values()),
           "syncs_or_copies_by_name": syncs,
           "top_kernels": [{"name": k, "device_us": us, "count": c}
                           for k, us, c in kernels[:12]],
           "top_host_ops": [{"name": e.key, "self_cpu_us": e.self_cpu_time_total,
                             "count": e.count} for e in host[:12]]}
    # the old key, kept for the JSON's readers
    out["kernel_launches_per_transition"] = out["kernels_per_transition"]
    if busy_us:
        log(f"profile {label}: {out['wall_ms_per_transition']:.3f} ms wall "
            f"per transition, {out['device_ms_per_transition']:.3f} ms on the "
            f"device, busy share {out['busy_share']:.3f}")
        log(f"    {out['kernels_per_transition']:.0f} kernels and "
            f"{out['syncs_or_copies_per_transition']:.1f} syncs or copies per "
            f"transition {syncs}; top kernels by device time:")
        for k in out["top_kernels"]:
            log(f"    {k['device_us'] / steps:9.2f} us/transition "
                f"x{k['count'] // steps:<4d} {k['name'][:90]}")
        log("    top host ops by self CPU time:")
        for h in out["top_host_ops"][:8]:
            log(f"    {h['self_cpu_us'] / steps:9.2f} us/transition "
                f"x{h['count'] // steps:<4d} {h['name'][:90]}")
    else:
        log(f"profile {label}: the trace shows no device time (not measured)")
    return out


# ---------------------------------------------------------------------------
# phase 3 (continued): flash_attention and ssd_scan against their plain
# versions, categorical_logits_sum at the LM vocabularies
# ---------------------------------------------------------------------------
def rel_err(a, b) -> float:
    """max|a - b| / max|b|: tests/test_kernels.py's measure."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-6))


FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SSD_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
# tests/test_kernels.py's FLASH_CASES (B, Sq, Sk, KV, G, hd, causal, window,
# cap), each in float32 and bf16, and head dims 16 and 20
FLASH_CASES = [(2, 128, 128, 2, 2, 64, True, None, None),
               (1, 256, 256, 1, 4, 128, True, None, 50.0),
               (2, 100, 100, 2, 1, 64, True, 64, None),
               (1, 64, 64, 4, 1, 128, False, None, None),
               (1, 1, 96, 2, 2, 64, True, None, None),
               (1, 8, 160, 1, 2, 256, True, 32, 30.0),
               (2, 40, 40, 2, 3, 16, True, None, None),
               (2, 33, 70, 1, 3, 20, True, 9, None)]
# the LM paths' calls, with the positions and validity the paths give them
# (smollm-360m: 8 requests, prompt 1,024, 64 new tokens, a 1,088-slot
# cache; gemma2-27b: 2 requests, prompt 4,160, 32 new, a 4,096-slot ring
# on the local layer, 4,192 slots on the global one). The prefill's last
# query is at position prompt - 1; the decode's at the last step.
LM_FLASH = {
    "smollm_prefill": dict(B=8, KV=5, G=3, hd=64, window=None, cap=None,
                           kind="prefill", S=1024, T=1088),
    "smollm_decode": dict(B=8, KV=5, G=3, hd=64, window=None, cap=None,
                          kind="decode", pos=1086, T=1088),
    "gemma2_prefill_local": dict(B=2, KV=16, G=2, hd=128, window=4096,
                                 cap=50.0, kind="ring_prefill", S=4160,
                                 T=4096),
    "gemma2_prefill_global": dict(B=2, KV=16, G=2, hd=128, window=None,
                                  cap=50.0, kind="prefill", S=4160, T=4192),
    "gemma2_decode_local": dict(B=2, KV=16, G=2, hd=128, window=4096,
                                cap=50.0, kind="ring_decode", pos=4190,
                                T=4096),
    "gemma2_decode_global": dict(B=2, KV=16, G=2, hd=128, window=None,
                                 cap=50.0, kind="decode", pos=4190, T=4192),
    # granite-moe-1b-a400m: 8 requests, prompt 1,024, 64 new tokens, GQA
    # of 8 x 2 heads of 64
    "granite_moe_prefill": dict(B=8, KV=8, G=2, hd=64, window=None,
                                cap=None, kind="prefill", S=1024, T=1088),
    "granite_moe_decode": dict(B=8, KV=8, G=2, hd=64, window=None,
                               cap=None, kind="decode", pos=1086, T=1088),
}
# (b, s, h, p, g, n, chunk): tests/test_kernels.py's SSD_CASES, a ragged
# grouped one, and mamba2-1.3b's scoring call (4 x 2,048 tokens)
SSD_CASES = [(2, 256, 4, 64, 1, 128, 128), (1, 200, 8, 64, 2, 128, 64),
             (1, 256, 4, 64, 4, 32, 128), (2, 64, 2, 32, 1, 16, 32),
             (1, 77, 4, 32, 2, 16, 32)]
SSD_MAMBA2 = (4, 2048, 64, 64, 1, 128, 128)
# ssd_scan_tc's other shapes: p 128, n 64, chunk 64, ragged lengths
SSD_TC_CASES = [(1, 77, 2, 128, 1, 64, 128), (2, 300, 4, 128, 2, 128, 64),
                (1, 130, 4, 64, 2, 64, 64)]
# smollm-360m's, mamba2-1.3b's, granite-moe-1b-a400m's (odd: 4-byte loads)
# and deepseek-v2-lite-16b's
LM_VOCABS = (49_152, 50_280, 49_155, 102_400)


def flash_call(torch, spec, dtype, gen):
    """q, k, v and the keyword arguments of one LM path's flash call."""
    dev = torch.device(DEVICE)
    B, KV, G, hd, T = (spec[k] for k in ("B", "KV", "G", "hd", "T"))
    i32 = dict(dtype=torch.int32, device=dev)
    if spec["kind"] == "prefill":         # plain cache, prompt written
        S = spec["S"]
        qp = torch.arange(S, **i32)
        kp = torch.arange(T, **i32)
        ok = kp < S
    elif spec["kind"] == "decode":        # plain cache, one new token
        S = 1
        qp = torch.tensor([spec["pos"]], **i32)
        kp = torch.arange(T, **i32)
        ok = kp <= spec["pos"]
    elif spec["kind"] == "ring_prefill":  # the old ring (empty) + new keys
        S = spec["S"]
        qp = torch.arange(S, **i32)
        slot = torch.arange(T, **i32)
        kp = torch.cat([slot - T, qp])
        ok = torch.cat([torch.zeros(T, dtype=torch.bool, device=dev),
                        torch.ones(S, dtype=torch.bool, device=dev)])
    else:                                 # ring decode
        S = 1
        last = spec["pos"]
        qp = torch.tensor([last], **i32)
        kp = last - torch.remainder(last - torch.arange(T, **i32), T)
        ok = kp >= 0
    Sk = kp.numel()
    q = torch.randn(B, S, KV, G, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    kw = dict(q_positions=qp[None].expand(B, S),
              kv_positions=kp[None].expand(B, Sk),
              kv_mask=ok[None].expand(B, Sk), causal=True,
              window=spec["window"], cap=spec["cap"])
    return q, k, v, kw


def _row_subset(torch, S, keep=128):
    """Query rows held to the plain version at a large Sq: the first and
    last ``keep`` (rows are independent, so the kernel runs all of them)."""
    if S <= 2 * keep:
        return torch.arange(S)
    return torch.cat([torch.arange(keep), torch.arange(S - keep, S)])


def flash_vs_plain(torch, fops, fref, q, k, v, kw):
    """(kernel output, rel err, max abs err) against the plain version on
    a subset of the query rows; checks a bit-identical rerun."""
    got = fops.flash_attention_gqa(q, k, v, **kw)
    again = fops.flash_attention_gqa(q, k, v, **kw)
    rows = _row_subset(torch, q.shape[1]).to(q.device)
    sub = dict(kw, q_positions=kw["q_positions"][:, rows])
    want = fref.attention_ref(q[:, rows], k, v, **sub)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "flash_attention: two runs differ")
    part = got[:, rows]
    return got, rel_err(part, want), float((part.float() - want.float())
                                           .abs().max())


def flash_kernel_of(fops, q, k):
    """The kernel ``plan`` picks for this call."""
    B, Sq, KV, G, hd = q.shape
    return fops.plan(B, Sq, k.shape[1], KV, G, q.dtype, hd).kernel


# (B, Sq, Sk, KV, G, hd, window, cap, holes): flash_decode at G 1 to 8,
# odd Sk and holes in the cache; flash_fwd_tc at hd 64 and 128 with ragged
# Sq and Sk, a window, a softcap and holes
FLASH_KERNEL_CASES = [(3, 1, 77, 2, 1, 64, None, None, True),
                      (2, 1, 301, 3, 2, 128, 50, 30.0, True),
                      (1, 1, 1023, 1, 4, 64, None, None, False),
                      (2, 1, 513, 2, 5, 128, None, 50.0, True),
                      (1, 3, 99, 2, 7, 64, 40, None, True),
                      (1, 1, 4097, 1, 8, 128, None, None, True),
                      (2, 333, 517, 2, 3, 64, None, None, True),
                      (1, 190, 1000, 3, 2, 128, 128, 50.0, True),
                      (1, 64, 65, 1, 1, 64, None, None, False),
                      (2, 97, 97, 1, 2, 128, 17, None, True)]


def check_flash_kernel(torch, fops, fref):
    """flash_attention's four kernels against the plain version by rel err
    (2e-5 float32, 3e-2 bf16): FLASH_CASES in both types with a partly
    filled cache, FLASH_KERNEL_CASES (each kernel at its edges), a ring
    with holes and fully masked rows (exact zeros) through each kernel,
    every LM path's call in both types (and, on each float32 prefill, the
    FP32 flash_fwd by launch_kernel too); bit-identical reruns; the
    backward through the autograd.Function against autograd of the plain
    version. Checks that every kernel ran, and returns each kernel's worst
    abs error at the LM paths' calls of the main path's type (bf16 for
    flash_fwd_tc and flash_decode; float32 for flash_fwd_tf32, the float32
    gates' prefill, and for flash_fwd on the same calls)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(11)
    fops.reset_launch_counts()
    n = 0
    for B, Sq, Sk, KV, G, hd, causal, window, cap in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                       for s in ((B, Sq, KV, G, hd), (B, Sk, KV, hd),
                                 (B, Sk, KV, hd)))
            kp = torch.arange(Sk, dtype=torch.int32, device=dev)
            kw = dict(q_positions=(kp[Sk - Sq:])[None].expand(B, Sq),
                      kv_positions=kp[None].expand(B, Sk),
                      kv_mask=(kp < Sk - 3)[None].expand(B, Sk),
                      causal=causal, window=window, cap=cap)
            _, err, _ = flash_vs_plain(torch, fops, fref, q, k, v, kw)
            tol = FLASH_TOL[str(dtype).split(".")[1]]
            check(err < tol, f"flash_attention {(B, Sq, Sk, KV, G, hd)} "
                  f"{dtype} ({flash_kernel_of(fops, q, k)}): rel err "
                  f"{err:.3e} >= {tol}")
            n += 1
    for case in FLASH_KERNEL_CASES:
        B, Sq, Sk, KV, G, hd, window, cap, holes = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                       for s in ((B, Sq, KV, G, hd), (B, Sk, KV, hd),
                                 (B, Sk, KV, hd)))
            kp = torch.arange(Sk, dtype=torch.int32, device=dev)
            ok = kp < Sk - 1
            if holes:
                ok = ok & (torch.remainder(kp, 13) != 5)
            kw = dict(q_positions=(kp[Sk - Sq:])[None].expand(B, Sq),
                      kv_positions=kp[None].expand(B, Sk),
                      kv_mask=ok[None].expand(B, Sk), causal=True,
                      window=window, cap=cap)
            _, err, _ = flash_vs_plain(torch, fops, fref, q, k, v, kw)
            tol = FLASH_TOL[str(dtype).split(".")[1]]
            check(err < tol, f"flash_attention {case} {dtype} "
                  f"({flash_kernel_of(fops, q, k)}): rel err {err:.3e} >= "
                  f"{tol}")
            n += 1
    # ring positions, holes, and a query before every key: through
    # flash_decode (3 rows of queries) and, with 70 query rows, the two
    # prefill kernels; the rows before every key must be exactly zero
    B, Sk, KV, G, hd, last = 2, 64, 2, 2, 64, 100
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=dev)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev)
    slot = torch.arange(Sk, dtype=torch.int32, device=dev)
    ok = torch.ones(B, Sk, dtype=torch.bool, device=dev)
    ok[:, 5:40:4] = False
    ring = dict(kv_positions=(last - torch.remainder(last - slot, Sk))[None]
                .expand(B, Sk), kv_mask=ok, causal=True, window=48, cap=None)
    for dtype, sq in ((torch.float32, 3), (torch.bfloat16, 3),
                      (torch.float32, 35), (torch.bfloat16, 35)):
        qpos = torch.tensor([last, last - 1, -7] + [last - 2 - i for i in
                                                    range(sq - 3)],
                            dtype=torch.int32, device=dev)
        q = torch.randn(B, sq, KV, G, hd, generator=gen, device=dev)
        kw = dict(ring, q_positions=qpos[None].expand(B, sq))
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        got, err, _ = flash_vs_plain(torch, fops, fref, qd, kd, vd, kw)
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        name = flash_kernel_of(fops, qd, kd)
        check(err < tol, f"flash_attention ring case ({name}, {dtype}): rel "
              f"err {err:.3e}")
        check(bool((got[:, 2] == 0).all()),
              f"flash_attention ({name}): a fully masked row is not exactly "
              "zero")
        n += 1
        if sq == 35:  # the FP32 kernel on the prefill call too
            got = fops.launch_kernel("flash_fwd", qd, kd, vd, **kw)
            err = rel_err(got, fref.attention_ref(qd, kd, vd, **kw))
            check(err < tol and bool((got[:, 2] == 0).all()),
                  f"flash_fwd ring case ({dtype}): rel err {err:.3e}, "
                  f"masked row zero {bool((got[:, 2] == 0).all())}")
            n += 1
    # backward through the autograd.Function
    q = torch.randn(B, 3, KV, G, hd, generator=gen, device=dev)
    kw = dict(ring, q_positions=torch.tensor([[last, last - 1, -7]] * B,
                                             dtype=torch.int32, device=dev))
    w = torch.randn(q.shape, generator=gen, device=dev)
    grads = []
    for fn in (fops.flash_attention_gqa, fref.attention_ref):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*ins, **kw) * w).sum().backward()
        grads.append([t.grad for t in ins])
    for name, a, b in zip("qkv", *grads):
        e = rel_err(a, b)
        check(e < 2e-5, f"flash_attention backward d{name}: rel err {e:.3e}")
    worst = dict.fromkeys(fops.KERNELS, 0.0)
    for name, spec in LM_FLASH.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, kw = flash_call(torch, spec, dtype, gen)
            got, err, abs_err = flash_vs_plain(torch, fops, fref, q, k, v,
                                               kw)
            tol = FLASH_TOL[str(dtype).split(".")[1]]
            kern = flash_kernel_of(fops, q, k)
            check(err < tol, f"flash_attention {name} {dtype} ({kern}): rel "
                  f"err {err:.3e} >= {tol}")
            if (dtype == torch.bfloat16) == (kern in ("flash_fwd_tc",
                                                      "flash_decode")):
                worst[kern] = max(worst[kern], abs_err)
            n += 1
            if kern == "flash_fwd_tf32":
                # the FP32 kernel on the call it ran before flash_fwd_tf32
                old = fops.launch_kernel("flash_fwd", q, k, v, **kw)
                rows = _row_subset(torch, q.shape[1]).to(q.device)
                want = fref.attention_ref(
                    q[:, rows], k, v,
                    **dict(kw, q_positions=kw["q_positions"][:, rows]))
                e = rel_err(old[:, rows], want)
                check(e < tol, f"flash_fwd {name} {dtype}: rel err {e:.3e}")
                worst["flash_fwd"] = max(worst["flash_fwd"], float(
                    (old[:, rows] - want).abs().max()))
                n += 1
                del old, want
            del q, k, v, got
    torch.cuda.synchronize()
    ran = dict(fops.LAUNCHES)
    check(all(ran[k] > 0 for k in fops.KERNELS),
          f"flash_attention checks did not reach every kernel: {ran}")
    log(f"flash_attention vs plain: {n} cases (test_kernels.py's cases, each "
        f"kernel at its edges and every LM path's call, float32 at rel 2e-5 "
        f"and bf16 at 3e-2), rings with holes and exactly-zero masked rows "
        f"through each kernel, the backward at 2e-5, bit-identical reruns: "
        f"ok; launches {ran}")
    return worst


def ssd_inputs(torch, case, dtype, gen):
    b, s, h, p, g, n, _ = case
    dev = torch.device(DEVICE)
    x = torch.randn(b, s, h, p, generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen,
                                                  device=dev))
    A = -torch.exp(0.5 * torch.randn(h, generator=gen, device=dev))
    B = torch.randn(b, s, g, n, generator=gen, device=dev).to(dtype)
    C = torch.randn(b, s, g, n, generator=gen, device=dev).to(dtype)
    return x, dt, A, B, C


# the type of each SSD kernel's main-path call (the FP32 kernel's former
# one: mamba2's float32 scoring), where its worst abs error is read
SSD_MAIN_TYPE = {"ssd_scan": "float32", "ssd_scan_tc": "bfloat16",
                 "ssd_scan_tf32": "float32"}


def check_ssd_kernel(torch, sops, sref):
    """The SSD kernels against the plain version by rel err (2e-4
    float32, 5e-2 bf16) over SSD_CASES, SSD_TC_CASES and mamba2's call in
    both types: the kernel ``plan`` picks everywhere, and where it picks a
    tensor-core kernel (``ssd_scan_tc`` for bf16, ``ssd_scan_tf32`` for
    float32) the FP32 kernel on the same call too (``launch_kernel``); the
    mixer's strided views through both tensor-core kernels; each with a
    bit-identical rerun; chunk 32 against chunk 64 on the FP32 kernel and
    ``ssd_scan_tf32`` at chunk 32, 64 and 128 (the same bits: it walks
    sub-chunks of 64) against the FP32 kernel at chunk 32 (1e-4); the
    backward (2e-4) through both FP32 kernels. Returns the worst abs error
    of each kernel at mamba2's call in its main path's type
    (``SSD_MAIN_TYPE``)."""
    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(12)
    worst = dict.fromkeys(sops.KERNELS, 0.0)
    ran = dict.fromkeys(sops.KERNELS, 0)
    n_cases = 0
    for case in SSD_CASES + SSD_TC_CASES + [SSD_MAMBA2]:
        b, s, h, p, g, n, chunk = case
        for dtype in (torch.float32, torch.bfloat16):
            ins = ssd_inputs(torch, case, dtype, gen)
            want = sref.ssd_scan_ref(*ins, chunk=chunk)
            chosen = sops.plan(h, g, p, n, chunk, dtype)
            kernels = [chosen] + (["ssd_scan"] if chosen != "ssd_scan"
                                  else [])
            for kernel in kernels:
                sops.reset_launch_counts()
                if kernel == chosen:
                    got = sops.ssd_scan(*ins, chunk=chunk)
                    again = sops.ssd_scan(*ins, chunk=chunk)
                else:
                    got = sops.launch_kernel(kernel, *ins, chunk=chunk)
                    again = sops.launch_kernel(kernel, *ins, chunk=chunk)
                torch.cuda.synchronize()
                check(sops.LAUNCHES[kernel] == 2, f"{kernel} {case}: "
                      f"launches {sops.LAUNCHES}")
                ran[kernel] += 1
                check(torch.equal(got, again),
                      f"{kernel} {case}: two runs differ")
                err = rel_err(got, want)
                dt_name = str(dtype).split(".")[1]
                tol = SSD_TOL[dt_name]
                check(err < tol, f"{kernel} {case} {dtype}: rel err "
                      f"{err:.3e} >= {tol}")
                if case == SSD_MAMBA2 and dt_name == SSD_MAIN_TYPE[kernel]:
                    worst[kernel] = float((got.float() - want.float())
                                          .abs().max())
                n_cases += 1
            del ins, want, got, again
    # the mixer's views of the convolution output, read through strides
    b, s, h, p, g, n, chunk = SSD_MAMBA2[0], 512, 8, 64, 1, 128, 128
    dev = torch.device(DEVICE)
    for dtype, kernel in ((torch.bfloat16, "ssd_scan_tc"),
                          (torch.float32, "ssd_scan_tf32")):
        conv = torch.randn(b, s, h * p + 2 * g * n, generator=gen,
                           device=dev).to(dtype)
        xs, Bc, Cc = torch.split(conv, [h * p, g * n, g * n], dim=-1)
        x, B, C = (xs.reshape(b, s, h, p), Bc.reshape(b, s, g, n),
                   Cc.reshape(b, s, g, n))
        _, dt, A, _, _ = ssd_inputs(torch, (b, s, h, p, g, n, chunk),
                                    torch.float32, gen)
        sops.reset_launch_counts()
        got = sops.ssd_scan(x, dt, A, B, C, chunk=chunk)
        want_counts = {**dict.fromkeys(sops.KERNELS, 0), kernel: 1}
        check(sops.LAUNCHES == want_counts,
              f"ssd_scan on the mixer's {dtype} views: launches "
              f"{sops.LAUNCHES}")
        err = rel_err(got, sref.ssd_scan_ref(x, dt, A, B, C, chunk=chunk))
        tol = SSD_TOL[str(dtype).split(".")[1]]
        check(err < tol, f"{kernel} on the mixer's views: rel err "
              f"{err:.3e}")
    check(all(ran.values()), f"an SSD kernel was not reached: {ran}")
    ins = ssd_inputs(torch, (1, 128, 2, 32, 1, 64, 32), torch.float32, gen)
    e = rel_err(sops.ssd_scan(*ins, chunk=32), sops.ssd_scan(*ins, chunk=64))
    check(e < 1e-4, f"ssd_scan chunk 32 vs 64: rel err {e:.3e}")
    tf_ins = ssd_inputs(torch, (1, 300, 2, 64, 1, 64, 64), torch.float32,
                        gen)
    y32, y64, y128 = (sops.ssd_scan(*tf_ins, chunk=c) for c in sops.CHUNKS)
    same = torch.equal(y32, y64) and torch.equal(y64, y128)
    e = rel_err(y128, sops.launch_kernel("ssd_scan", *tf_ins, chunk=32))
    check(same and e < 1e-4, f"ssd_scan_tf32 chunk 32, 64 and 128 equal "
          f"{same}; vs ssd_scan at chunk 32: rel err {e:.3e}")
    for args, chunk in ((ins, 32), (tf_ins, 64)):
        w = torch.randn(args[0].shape, generator=gen, device=args[0].device)
        grads = []
        for fn in (sops.ssd_scan, sref.ssd_scan_ref):
            xs = [t.clone().requires_grad_(True) for t in args]
            (fn(*xs, chunk=chunk) * w).sum().backward()
            grads.append([t.grad for t in xs])
        for name, a, b in zip(("x", "dt", "A", "B", "C"), *grads):
            e = rel_err(a, b)
            check(e < 2e-4, f"ssd_scan backward (chunk {chunk}) d{name}: rel "
                  f"err {e:.3e}")
    log(f"ssd_scan kernels vs plain: {n_cases} kernel runs ({ran}) over "
        "test_kernels.py's cases, a ragged grouped one, the tensor-core "
        "kernels' shapes and mamba2's 4 x 2,048 x 64 heads (float32 at rel "
        "2e-4, bf16 at 5e-2), the mixer's strided views in both types, "
        "chunk invariance at 1e-4, the backward at 2e-4, bit-identical "
        f"reruns: ok (mamba2 abs err in the main path's type {worst})")
    return worst


def check_categorical_lm(torch, ops, ref):
    """categorical_logits_sum at the LM vocabularies, N = 8,192 items (the
    scoring paths' 4 x 2,048 tokens), one launch a call, at rtol 1e-6 with
    a bit-identical rerun. Returns the worst abs error."""
    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(13)
    err = {}
    for c in LM_VOCABS:
        logits = 3.0 * torch.randn(1, 8192, c, generator=gen, device=DEVICE)
        lab = torch.randint(0, c, (1, 8192), generator=gen, device=DEVICE,
                            dtype=torch.int32)
        ops.reset_launch_counts()
        got = ops.categorical_logits_sum_rows(logits, lab)
        check(ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0),
                               "categorical_logits_sum": 1},
              f"categorical_logits_sum 1x8192x{c}: launches {ops.LAUNCHES}")
        again = ops.categorical_logits_sum_rows(logits, lab)
        want = ref.categorical_logits_logpmf_sum_ref(logits, lab)
        torch.cuda.synchronize()
        check(same_bits(torch, got, again),
              f"categorical_logits_sum 1x8192x{c}: two runs differ")
        err[c] = float((got - want).abs().max())
        check(err[c] <= 1e-6 * float(want.abs().max()),
              f"categorical_logits_sum 1x8192x{c}: err {err[c]:.3e}")
        del logits
    log(f"categorical_logits_sum at C = {LM_VOCABS}, N = 8,192: rtol 1e-6, "
        f"bit-identical reruns: ok (abs err {err})")
    return max(err.values())


# ---------------------------------------------------------------------------
# the LM paths: serving smollm-360m and gemma2-27b, scoring mamba2-1.3b
# ---------------------------------------------------------------------------
# (arch, requests, prompt, new tokens, depth: None for the config's own)
LM_SERVE = {"smollm-360m": (8, 1024, 64, None),
            "gemma2-27b": (2, 4160, 32, 2),   # one (local, global) block
            "mamba2-1.3b": (4, 1024, 32, None)}
LM_SCORE = ("mamba2-1.3b", 4, 2048)           # (arch, sequences, tokens)
LM_GRAPH_NEW = 8   # new tokens of each captured-against-eager serving run
DECODE_TIMED = 32  # decode steps timed unprofiled, replayed and eager
LM_GATE = 2e-3  # tests/test_archs.py's tolerance for decode vs forward
# bf16 scoring: the log-likelihood through ssd_scan_tc against the plain
# scan's, same bf16 weights and tokens. The two differ only inside the
# scan: the kernel rounds W, S and B o segdt to bf16 (2^-9 relative each)
# where the plain scan keeps float32 (the float32 gate above holds the
# scan itself to 1e-4). Those roundings pass through 48 residual layers
# into logits that random weights make sharp (about -290 nats a token), so
# the total moves by a few 1e-4 of itself: 2.95e-4 on an H100 at this
# seed; 1e-3 leaves three times that
LM_SCORE_BF16_TOL = 1e-3


def lm_counts(mods) -> dict:
    return {k: v for m in mods for k, v in m.LAUNCHES.items()}


def lm_reset(mods) -> None:
    for m in mods:
        m.reset_launch_counts()


def greedy_run(torch, lm, bayes_lm, cfg, params, prompts, max_new,
               feed=None):
    """Prefill and ``max_new - 1`` greedy decode steps through the serving
    step functions; returns the logits of every step (the prefill's last
    and each decode's) and the tokens. ``feed`` (B, max_new) replaces the
    greedy tokens fed back (to hold two routes on the same sequence)."""
    B, S = prompts.shape
    cache = lm.init_cache(cfg, B, S + max_new, device=DEVICE)
    prefill = bayes_lm.make_prefill_step(cfg)
    decode = bayes_lm.make_serve_step(cfg)
    with torch.no_grad():
        logits, cache = prefill(params, prompts, cache)
        steps = [logits[:, -1].float()]
        token = torch.argmax(steps[0], -1).to(torch.int32)[:, None]
        tokens = [token]
        pos = torch.full((B,), S, dtype=torch.int32, device=DEVICE)
        for i in range(max_new - 1):
            fed = token if feed is None else feed[:, i:i + 1]
            token, logits, cache = decode(params, fed, cache, pos + i)
            steps.append(logits[:, -1].float())
            tokens.append(token)
    return steps, torch.cat(tokens, dim=1)


def close_within(torch, a, b, tol=LM_GATE) -> float:
    """max(|a - b| - tol |b|): within tol (rtol and atol) iff <= tol."""
    return float(((a - b).abs() - tol * b.abs()).max())


def _attn_layer_count(cfg) -> int:
    """Layers that run flash attention (global and local blocks)."""
    return sum(b in ("global", "local") for b in
               (cfg.layer_pattern * cfg.n_layers)[:cfg.n_layers])


def serve_gates(torch, arch, cfg, params, prompts, max_new, mods):
    """The float32 gates of a serving path, on ``params`` upcast: the
    flash route against the dense route over every step on the same
    tokens (attention layers only), and prefill(S - 1) plus decode(1)
    against forward_train's last logits, the latter at capacity E / k in
    a MoE config, as tests/test_archs.py gives it (the default capacity
    drops most pairs at decode).

    Each logit within LM_GATE (rtol and atol, ``close_within``), except
    in a MoE config: there within LM_GATE of the step's largest logit
    (``rel_err``, the kernels' measure), each logit's reading reported. With random
    weights the experts' init (std 1/sqrt(E), ROADMAP Queue 3 C) gives
    logits up to 150-250, and float32's own error at full depth is
    already 3-5e-3 in a logit: the dense route against a float64 run of
    the same model and tokens, which granite's gate runs too (reported);
    near-ties route some tokens to other experts in either route."""
    import dataclasses

    from repro_torch.models import bayes_lm
    from repro_torch.nn import lm

    batch, prompt_len = prompts.shape
    n_attn = _attn_layer_count(cfg)
    within = rel_err if cfg.moe else functools.partial(close_within, torch)
    out = {"gate_layers": cfg.n_layers, "f32_launches": {},
           "gate_measure": "rel_err" if cfg.moe else "close_within"}
    p32 = lm.tree_map(lambda t: t.float(), params)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    if n_attn:
        # the float32 serving run is counted too: its prefill is
        # flash_fwd_tf32's main-path call, its decode steps flash_decode's
        torch.cuda.synchronize()
        lm_reset(mods)
        flash, ftok = greedy_run(torch, lm, bayes_lm, c32, p32, prompts,
                                 max_new)
        torch.cuda.synchronize()
        out["f32_launches"] = lm_counts(mods)
        want32 = {**dict.fromkeys(out["f32_launches"], 0),
                  "flash_fwd_tf32": n_attn,
                  "flash_decode": n_attn * (max_new - 1)}
        check(out["f32_launches"] == want32,
              f"{arch} float32 serving: launches {out['f32_launches']}, "
              f"expected {want32}")
        dense, _ = greedy_run(torch, lm, bayes_lm, dataclasses.replace(
            c32, attn_impl="xla"), p32, prompts, max_new, feed=ftok)
        pairs = list(zip(flash, dense))
        out["flash_vs_dense"] = max(within(a, b) for a, b in pairs)
        if cfg.moe:
            out["flash_vs_dense_elementwise"] = max(
                close_within(torch, a, b) for a, b in pairs)
            # float32's own error: both routes against a float64 run
            p64 = lm.tree_map(lambda t: t.double(), params)
            exact, _ = greedy_run(torch, lm, bayes_lm, dataclasses.replace(
                c32, dtype=torch.float64, attn_impl="xla"), p64, prompts,
                max_new, feed=ftok)
            del p64
            out["flash_vs_float64_max_abs"] = max(
                float((a - e).abs().max()) for a, e in zip(flash, exact))
            out["dense_vs_float64_max_abs"] = max(
                float((b - e).abs().max()) for b, e in zip(dense, exact))
            del exact
        check(out["flash_vs_dense"] <= LM_GATE,
              f"{arch}: flash and dense routes differ beyond {LM_GATE} "
              f"({out['gate_measure']} {out['flash_vs_dense']:.3e})")
        del flash, dense, pairs
    if cfg.moe:
        c32 = dataclasses.replace(c32, capacity_factor=float(
            cfg.n_experts / cfg.top_k))
    with torch.no_grad():
        full = lm.forward_train(c32, p32, prompts)[:, -1]
        cache = lm.init_cache(c32, batch, prompt_len, device=DEVICE)
        _, cache = lm.prefill(c32, p32, prompts[:, :-1], cache)
        dec, _ = lm.decode_step(c32, p32, prompts[:, -1:], cache,
                                torch.full((batch,), prompt_len - 1,
                                           dtype=torch.int32, device=DEVICE))
    out["decode_vs_forward"] = within(dec[:, 0], full)
    out["decode_vs_forward_elementwise"] = close_within(torch, dec[:, 0],
                                                        full)
    out["decode_vs_forward_max_abs"] = float((dec[:, 0] - full).abs().max())
    out["forward_max_abs_logit"] = float(full.abs().max())
    check(out["decode_vs_forward"] <= LM_GATE,
          f"{arch}: prefill(S-1) + decode(1) differs from forward_train "
          f"beyond {LM_GATE} ({out['gate_measure']} "
          f"{out['decode_vs_forward']:.3e})")
    del p32, full, cache, dec
    torch.cuda.empty_cache()
    return out


def lm_serve_path(torch, arch, mods, shape=None, gate_depth=None):
    """One serving path at full width: the float32 gates
    (:func:`serve_gates`; at ``gate_depth`` layers, on the first layers
    of the same weights, run before the full model is made), then the
    timed bf16 serve_batch with the kernels' counts zeroed just before and
    read just after, the decode step's graph against eager, then the
    dense route's bf16 tokens for agreement. ``shape`` is (requests,
    prompt, new tokens, depth), ``LM_SERVE[arch]`` by default."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve import serve_batch
    from repro_torch.nn import lm

    batch, prompt_len, max_new, depth = shape or LM_SERVE[arch]
    cfg = dataclasses.replace(configs.get_config(arch), attn_impl="flash")
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                            device=DEVICE)
    n_attn = _attn_layer_count(cfg)
    gates = {}
    if gate_depth is not None:  # before the full model: room for both
        gcfg = dataclasses.replace(cfg, n_layers=gate_depth)
        gates = serve_gates(torch, arch, gcfg,
                            lm.init_params(gcfg, seed=0, device=DEVICE),
                            prompts, max_new, mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    out = {"arch": arch, "layers": cfg.n_layers, "requests": batch,
           "prompt": prompt_len, "new_tokens": max_new,
           "params": lm.count_params(params),
           "init_s": time.perf_counter() - t0}
    if gate_depth is None and (n_attn or cfg.moe):
        gates = serve_gates(torch, arch, cfg, params, prompts, max_new, mods)
    out.update(gates)

    # the timed bf16 run, counted
    serve_batch(arch, cfg=cfg, params=params, prompts=prompts[:, :16],
                max_new=2, device=DEVICE)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm_reset(mods)
    gen_tokens, stats = serve_batch(arch, cfg=cfg, params=params,
                                    prompts=prompts, max_new=max_new,
                                    device=DEVICE)
    torch.cuda.synchronize()
    out["launches"] = lm_counts(mods)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / (1 << 20)
    # bf16: the prefill on the tensor cores, each decode step's call on
    # flash_decode, once per attention layer; nothing else
    want = {**dict.fromkeys(out["launches"], 0), "flash_fwd_tc": n_attn,
            "flash_decode": n_attn * (max_new - 1)}
    check(out["launches"] == want, f"{arch}: launches {out['launches']}, "
          f"expected {want}")
    check(gen_tokens.shape == (batch, max_new)
          and bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab)).all()),
          f"{arch}: generated tokens {tuple(gen_tokens.shape)} out of range")
    out.update(prefill_ms=stats["prefill_s"] * 1e3,
               decode_ms_per_token=stats["decode_s_per_token"] * 1e3,
               tokens_per_s=stats["tokens_per_s"])
    # the decode step's graph against the same steps eagerly, greedy and
    # sampled (the request's generator registered with the graph)
    import numpy as np
    for temp in (0.0, 1.0):
        out[f"graphs_temperature_{temp:g}"] = captured_vs_eager(
            torch, np, f"{arch} decode (temperature {temp:g})",
            lambda: serve_batch(arch, cfg=cfg, params=params,
                                prompts=prompts, max_new=LM_GRAPH_NEW,
                                temperature=temp, device=DEVICE)[0],
            mods=mods)
    if n_attn:  # greedy agreement with the dense route in bf16 (reported)
        dense_tokens, _ = serve_batch(
            arch, cfg=dataclasses.replace(cfg, attn_impl="xla"),
            params=params, prompts=prompts, max_new=max_new, device=DEVICE)
        same = (dense_tokens == gen_tokens).float()
        out["bf16_greedy_agreement"] = float(same.mean())
        first_diff = (same.cumprod(1).sum(1)).tolist()
        out["bf16_tokens_before_first_difference"] = first_diff
    log(f"{arch} serving ({cfg.n_layers} layers, {out['params'] / 1e9:.3f} B "
        f"parameters, {batch} requests x prompt {prompt_len} + {max_new} "
        f"new, bf16): prefill {out['prefill_ms']:.2f} ms, decode "
        f"{out['decode_ms_per_token']:.3f} ms/token, "
        f"{out['tokens_per_s']:.1f} tokens/s, peak {out['peak_mib']:.0f} "
        f"MiB; launches {out['launches']}"
        + (f"; float32 gates at {out['gate_layers']} layers "
           f"({out['gate_measure']} <= {LM_GATE}): "
           + (f"flash vs dense {out['flash_vs_dense']:.2e}, "
              if n_attn else "")
           + (f"(each logit {out['flash_vs_dense_elementwise']:.2e}; max |d| "
              f"to float64: flash {out['flash_vs_float64_max_abs']:.2e}, "
              f"dense {out['dense_vs_float64_max_abs']:.2e}), "
              if "flash_vs_float64_max_abs" in out else "")
           + f"decode vs forward {out['decode_vs_forward']:.2e} (each logit "
           f"{out['decode_vs_forward_elementwise']:.2e}; max |d| "
           f"{out['decode_vs_forward_max_abs']:.2e}, max |logit| "
           f"{out['forward_max_abs_logit']:.1f})"
           if "decode_vs_forward" in out else
           " (prefill: the plain scan; decode: the O(1) update)")
        + (f"; bf16 greedy agreement with dense "
           f"{out['bf16_greedy_agreement']:.3f}" if n_attn else ""))
    return out, (cfg, params, prompts)


def lm_score_path(torch, mods):
    """mamba2-1.3b scoring at full width and depth: the Bayesian LM's
    log-likelihood and log-joint of 4 x 2,048 tokens. Float32 gates: the
    kernel route's log-likelihood (``ssd_scan_tf32``, counted) against
    the plain scan's (rtol 1e-4), logjoint = logprior + loglikelihood (rtol
    1e-5). The bf16 gate: the log-likelihood through ``ssd_scan_tc``
    against the plain scan's on the same bf16 weights and tokens
    (LM_SCORE_BF16_TOL). Then the timed bf16 evaluations, counted."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.contexts import LikelihoodContext, PriorContext
    from repro_torch.models import bayes_lm
    from repro_torch.nn import lm

    arch, nseq, ntok = LM_SCORE
    cfg = dataclasses.replace(configs.get_config(arch), attn_impl="flash")
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (nseq, ntok), generator=gen,
                           device=DEVICE)
    labels = torch.randint(0, cfg.vocab, (nseq, ntok), generator=gen,
                           device=DEVICE)
    out = {"arch": arch, "layers": cfg.n_layers, "tokens": [nseq, ntok],
           "params": lm.count_params(params)}
    with torch.no_grad():
        p32 = lm.tree_map(lambda t: t.float(), params)
        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        m = bayes_lm.make_lm_model(c32)(tokens=tokens, labels=labels,
                                        params=p32)
        lm_reset(mods)
        ll = float(m.logp_with_context({}, LikelihoodContext()))
        out["f32_launches"] = lm_counts(mods)
        lp = float(m.logp_with_context({}, PriorContext()))
        lj = float(m.logjoint({}))
        ll_plain = float(bayes_lm.make_lm_model(dataclasses.replace(
            c32, attn_impl="xla"))(tokens=tokens, labels=labels,
                                   params=p32).logp_with_context(
            {}, LikelihoodContext()))
        del m, p32
        torch.cuda.empty_cache()
    out.update(loglik_f32=ll, loglik_plain_scan_f32=ll_plain, logprior_f32=lp,
               logjoint_f32=lj,
               kernel_vs_plain_rel=abs(ll - ll_plain) / abs(ll_plain),
               joint_vs_parts_rel=abs(lj - (lp + ll)) / abs(lj))
    check(all(math.isfinite(x) for x in (ll, lp, lj, ll_plain)),
          f"{arch}: non-finite densities {out}")
    check(out["kernel_vs_plain_rel"] <= 1e-4,
          f"{arch}: log-likelihood with the kernel {ll} vs the plain scan "
          f"{ll_plain} (rel {out['kernel_vs_plain_rel']:.2e} > 1e-4)")
    check(out["joint_vs_parts_rel"] <= 1e-5,
          f"{arch}: logjoint {lj} != logprior + loglikelihood {lp + ll}")
    want32 = {**dict.fromkeys(out["f32_launches"], 0),
              "ssd_scan_tf32": cfg.n_layers, "categorical_logits_sum": 1}
    check(out["f32_launches"] == want32, f"{arch} float32 scoring: launches "
          f"{out['f32_launches']}, expected {want32}")

    # bf16: the tensor-core scan against the plain scan, same weights
    with torch.no_grad():
        ll_tc = float(bayes_lm.make_lm_model(cfg)(
            tokens=tokens, labels=labels,
            params=params).logp_with_context({}, LikelihoodContext()))
        ll_plain16 = float(bayes_lm.make_lm_model(dataclasses.replace(
            cfg, attn_impl="xla"))(tokens=tokens, labels=labels,
                                   params=params).logp_with_context(
            {}, LikelihoodContext()))
    out.update(loglik_bf16_tc=ll_tc, loglik_bf16_plain_scan=ll_plain16,
               bf16_kernel_vs_plain_rel=abs(ll_tc - ll_plain16)
               / abs(ll_plain16))
    check(math.isfinite(ll_tc) and math.isfinite(ll_plain16)
          and out["bf16_kernel_vs_plain_rel"] <= LM_SCORE_BF16_TOL,
          f"{arch}: bf16 log-likelihood through ssd_scan_tc {ll_tc} vs the "
          f"plain scan {ll_plain16} (rel "
          f"{out['bf16_kernel_vs_plain_rel']:.2e} > {LM_SCORE_BF16_TOL})")

    with torch.no_grad():
        m = bayes_lm.make_lm_model(cfg)(tokens=tokens, labels=labels,
                                        params=params)
        m.logp_with_context({}, LikelihoodContext())  # warm-up
        torch.cuda.synchronize()
        lm_reset(mods)
        t0 = time.perf_counter()
        ll16 = m.logp_with_context({}, LikelihoodContext())
        lj16 = m.logjoint({})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    out["launches"] = lm_counts(mods)
    want = {**dict.fromkeys(out["launches"], 0),
            "ssd_scan_tc": 2 * cfg.n_layers, "categorical_logits_sum": 2}
    check(out["launches"] == want, f"{arch} scoring: launches "
          f"{out['launches']}, expected {want}")
    out.update(loglik_bf16=float(ll16), logjoint_bf16=float(lj16),
               ms_per_evaluation=secs * 1e3 / 2,
               tokens_per_s=2 * nseq * ntok / secs)
    check(math.isfinite(out["loglik_bf16"]) and math.isfinite(
        out["logjoint_bf16"]), f"{arch}: non-finite bf16 densities")
    log(f"{arch} scoring ({cfg.n_layers} layers, {out['params'] / 1e9:.3f} B "
        f"parameters, {nseq} x {ntok} tokens): float32 log-likelihood "
        f"{ll:.3f} with the kernel, {ll_plain:.3f} with the plain scan (rel "
        f"{out['kernel_vs_plain_rel']:.2e}); bf16 {ll_tc:.3f} through "
        f"ssd_scan_tc, {ll_plain16:.3f} with the plain scan (rel "
        f"{out['bf16_kernel_vs_plain_rel']:.2e}); logjoint - (logprior + "
        f"loglikelihood) rel {out['joint_vs_parts_rel']:.2e}; bf16 "
        f"{out['ms_per_evaluation']:.2f} ms per evaluation "
        f"({out['tokens_per_s']:.0f} tokens/s), launches {out['launches']}")
    return out, (cfg, params, tokens, labels)


# ---------------------------------------------------------------------------
# phase 6h: Bayesian-LM training (ROADMAP Queue 1 item 9, its training part)
# ---------------------------------------------------------------------------
TRAIN_ARCH = "smollm-360m"
TRAIN_SHAPE = (8, 1024)      # smollm's batch x sequence
TRAIN_MAP_STEPS = 10
TRAIN_LR = 3e-4
TRAIN_SGLD_STEPS = 3
TRAIN_TIMED = 3              # steps timed eagerly and replayed
TRAIN_PROFILED = 2           # replayed steps under the profiler
TRAIN_F32_SHAPE = (2, 1024)  # the float32 gate's batch x sequence
TRAIN_F32_RTOL = 1e-5        # nll, grad_norm: kernels against plain
TRAIN_F32_GRAD = 5e-5        # each gradient leaf, of its max |plain|
TRAIN_MAMBA_F32_GRAD = 5e-4  # the same, mamba2's (its scan's gradients)
TRAIN_REMAT_GRAD = 1e-6      # remat policies against remat off
TRAIN_GRAPH_STEPS = 3        # captured against eager
TRAIN_MAMBA = ("mamba2-1.3b", 4, 2048, 3)  # arch, batch, sequence, steps
TRAIN_MAMBA_F32_DEPTH = 4    # the float32 gate's depth (cut from 48)
TRAIN_SGLD_LM = (2, 1024)    # make_sgld_step's batch on smollm


def _attn_layers(cfg) -> int:
    return sum(b in ("global", "local") for b in
               (cfg.layer_pattern * cfg.n_layers)[:cfg.n_layers])


def _train_cfg(arch, **kw):
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get_config(arch), attn_impl="flash",
                               **kw)


def _forget_train_programs(torch):
    """Drop every cached training step's graphs (their memory pools and
    the states they hold), then the allocator's cache."""
    from repro_torch.core.program import program_cache
    cache = program_cache()
    for key in list(cache.keys()):
        if key.kind == "train_step":
            cache.get(key).forget()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _leaves(torch, tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if torch.is_tensor(t)]


def _grad_eval(torch, cfg, params, batch, total_tokens, backend="fused",
               mods=None):
    """The MAP step's log-joint and its gradient, once, eagerly: the scaled
    log-joint ``make_train_step`` differentiates, taken as its two parts,
    the weights' prior and the likelihood under ``MiniBatchContext(
    LikelihoodContext(), scale)``, so that the nll is read from the
    likelihood itself and not from a sum that the prior dominates, and its
    gradient through ``torch.autograd.grad``. (metrics as floats: logjoint,
    nll, grad_norm; gradient leaves as float32; launches; peak MiB.)"""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch import optim
    from repro_torch.core.contexts import LikelihoodContext, MiniBatchContext
    from repro_torch.models import bayes_lm

    n_tokens = batch["tokens"].numel()
    scale = total_tokens / n_tokens
    leaves, spec = tree_flatten(params)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if mods is not None:
        lm_reset(mods)
    live = [p.detach().requires_grad_(True) for p in leaves]
    tree = tree_unflatten(live, spec)
    mdl = bayes_lm.make_lm_model(cfg)(params=tree, **batch)
    loglik = mdl.logp_with_context(
        {}, MiniBatchContext(LikelihoodContext(), scale), backend=backend)
    logjoint = bayes_lm.tree_normal_logprior(tree) + loglik
    grads = [g.float() for g in torch.autograd.grad(logjoint, live)]
    torch.cuda.synchronize()
    launches = lm_counts(mods) if mods is not None else None
    peak = torch.cuda.max_memory_allocated() / (1 << 20)
    metrics = {"logjoint": float(logjoint.detach()),
               "nll": -float(loglik.detach()) / scale / n_tokens,
               "grad_norm": float(optim.global_norm(grads))}
    del live, tree, mdl, loglik, logjoint
    torch.cuda.empty_cache()
    return metrics, grads, launches, peak


@contextlib.contextmanager
def _bf16_kernel(kernel):
    """The float32 gate's control: the kernel's float32 inputs rounded to
    bfloat16 and given to the bf16 kernel (``flash_fwd_tc``,
    ``ssd_scan_tc``), its output taken back to float32: a bf16-internal
    kernel in the TF32 one's place, which the gate's limits must see."""
    if kernel.startswith("flash"):
        from repro_torch.kernels.flash_attention import ops as mod
        name = "flash_attention_gqa"
        real = mod.flash_attention_gqa

        def low(q, k, v, **kw):
            return real(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                        **kw).float()
    else:
        from repro_torch.kernels.ssd_scan import ops as mod
        name = "ssd_scan"
        real = mod.ssd_scan

        def low(x, dt, A, B, C, **kw):
            return real(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(),
                        **kw).float()
    setattr(mod, name, low)
    try:
        yield
    finally:
        setattr(mod, name, real)


def _gate_readings(got, g_got, want, g_want):
    """(relative error of each metric, the largest gradient leaf's error
    over its max |plain|)."""
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    grad = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(g_got, g_want))
    return rel, grad


def _float32_gate(torch, label, cfg, params, batch, total_tokens, mods,
                  kernel, grad_limit):
    """One gradient evaluation of the MAP step through the kernels
    (``kernel`` counted once a layer and again in remat's recompute;
    categorical_logits_sum once) against the plain route (``attn_impl=
    "xla"``, the per-site evaluator's plain categorical, no launch),
    float32 on the same weights and batch: nll and grad_norm within
    TRAIN_F32_RTOL, each gradient leaf within ``grad_limit`` of its max
    |plain| (the logjoint, which the prior's plain sum dominates, is
    printed). Then the control, the bf16 kernel in ``kernel``'s place,
    which must break one of these limits."""
    import dataclasses

    from repro_torch.nn import lm

    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = lm.tree_map(lambda t: t.float(), params)
    got, g_got, launches, _ = _grad_eval(torch, c32, p32, batch,
                                         total_tokens, mods=mods)
    want, g_want, plain_launches, _ = _grad_eval(
        torch, dataclasses.replace(c32, attn_impl="xla"), p32, batch,
        total_tokens, backend="reference", mods=mods)
    layers = cfg.n_layers if kernel.startswith("ssd") else _attn_layers(cfg)
    expect = {**dict.fromkeys(launches, 0), kernel: 2 * layers,
              "categorical_logits_sum": 1}
    check(launches == expect, f"{label} float32 gradient: launches "
          f"{launches}, expected {expect}")
    check(not any(plain_launches.values()), f"{label} float32 plain "
          f"gradient launched {plain_launches}")
    rel, grad = _gate_readings(got, g_got, want, g_want)
    del g_got
    low_kernel = kernel.replace("_tf32", "_tc")
    with _bf16_kernel(kernel):
        low, g_low, low_launches, _ = _grad_eval(torch, c32, p32, batch,
                                                 total_tokens, mods=mods)
    del p32
    check(low_launches[low_kernel] == 2 * layers and not low_launches[kernel],
          f"{label} control: launches {low_launches}")
    low_rel, low_grad = _gate_readings(low, g_low, want, g_want)
    del g_low, g_want
    torch.cuda.empty_cache()
    check(all(math.isfinite(v) for v in got.values()),
          f"{label} float32 gradient: metrics {got}")
    gated = ("nll", "grad_norm")
    check(max(rel[k] for k in gated) <= TRAIN_F32_RTOL, f"{label} float32 "
          f"gradient: kernels {got} vs plain {want} (rel {rel})")
    check(grad <= grad_limit, f"{label} float32 gradient: a leaf differs by "
          f"{grad:.3e} of its max |plain|")
    check(max(low_rel[k] for k in gated) > TRAIN_F32_RTOL
          or low_grad > grad_limit, f"{label} float32 gate: the bf16 "
          f"control passes it (rel {low_rel}, gradient {low_grad:.3e})")
    log(f"{label} float32 gate ({cfg.n_layers} layers, batch "
        f"{tuple(batch['tokens'].shape)}): metrics rel {rel}, gradient "
        f"{grad:.3e} of each leaf's max (limits: nll and grad_norm rtol "
        f"{TRAIN_F32_RTOL}, gradient {grad_limit}); control {low_kernel}: "
        f"rel {low_rel}, gradient {low_grad:.3e}; launches {launches}")
    return {"metrics": got, "plain_metrics": want, "metrics_rel": rel,
            "grad_rel_max": grad, "grad_limit": grad_limit,
            "control": {"kernel": low_kernel, "metrics_rel": low_rel,
                        "grad_rel_max": low_grad},
            "launches": launches}


def _timed_steps(torch, step_fn, state, gen, batch, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        _, metrics = step_fn(state, gen, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, metrics


def _tree_bits_equal(torch, a, b) -> bool:
    return all(same_bits(torch, x, y) for x, y in zip(_leaves(torch, a),
                                                       _leaves(torch, b)))


def train_smollm(torch, np, mods):
    """smollm-360m at full width and depth through ``train()``: MAP-AdamW
    for TRAIN_MAP_STEPS steps (counted; the nll must fall), a checkpoint of
    the last step written and restored bit for bit, ms a step eager and
    replayed, the busy share, then TRAIN_SGLD_STEPS SGLD steps (counted;
    finite nll)."""
    import shutil
    import tempfile

    from repro_torch.ckpt import restore, save
    from repro_torch.core.program import disable_capture
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import train
    from repro_torch.models import bayes_lm
    from repro_torch.nn import lm

    cfg = _train_cfg(TRAIN_ARCH)
    batch, seq = TRAIN_SHAPE
    n_attn = _attn_layers(cfg)
    check(cfg.remat and n_attn == cfg.n_layers == 32,
          f"{TRAIN_ARCH}: config {cfg}")
    out = {"arch": TRAIN_ARCH, "layers": cfg.n_layers, "batch": batch,
           "seq": seq, "remat": cfg.remat, "policy": cfg.remat_policy}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm_reset(mods)
    t0 = time.perf_counter()
    state, hist = train(TRAIN_ARCH, smoke=False, cfg=cfg,
                        steps=TRAIN_MAP_STEPS, batch=batch, seq=seq,
                        lr=TRAIN_LR, log_every=1, device=DEVICE)
    torch.cuda.synchronize()
    out["map_s"] = time.perf_counter() - t0
    out["launches"] = lm_counts(mods)
    out["map_peak_mib"] = torch.cuda.max_memory_allocated() / (1 << 20)
    out["nll"] = [h[1] for h in hist]
    # remat: each attention layer's forward runs again in the backward,
    # whose own attention gradient recomputes through the plain version
    per_step = {"flash_fwd_tc": 2 * n_attn, "categorical_logits_sum": 1}
    want = {**dict.fromkeys(out["launches"], 0),
            **{k: v * TRAIN_MAP_STEPS for k, v in per_step.items()}}
    check(out["launches"] == want, f"{TRAIN_ARCH} training: launches "
          f"{out['launches']}, expected {want}")
    check(len(hist) == TRAIN_MAP_STEPS and all(map(math.isfinite,
                                                   out["nll"])),
          f"{TRAIN_ARCH} training: nll {out['nll']}")
    check(out["nll"][-1] < out["nll"][0], f"{TRAIN_ARCH} training: nll did "
          f"not fall over {TRAIN_MAP_STEPS} steps: {out['nll']}")
    check(int(state.step) == TRAIN_MAP_STEPS, f"step {int(state.step)}")

    # the last step's checkpoint, written and restored bit for bit
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(root, TRAIN_MAP_STEPS, state)
        out["ckpt_write_s"] = time.perf_counter() - t0
        d = Path(root) / f"step_{TRAIN_MAP_STEPS:08d}"
        out["ckpt_mb"] = sum(f.stat().st_size for f in d.iterdir()) / 1e6
        t0 = time.perf_counter()
        step, back = restore(root, target=state)
        torch.cuda.synchronize()
        out["ckpt_read_s"] = time.perf_counter() - t0
        check(step == TRAIN_MAP_STEPS and _tree_bits_equal(torch, back,
                                                           state),
              f"{TRAIN_ARCH}: the restored checkpoint differs from the state")
        del back
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # ms a step: the same program (train()'s key) replayed on the trained
    # state, then eagerly
    _, step_fn = bayes_lm.make_train_step(
        cfg, total_tokens=float(TRAIN_MAP_STEPS * batch * seq), mode="map",
        learning_rate=TRAIN_LR)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                           seed=0, device=DEVICE)
    tokens = data.batch(TRAIN_MAP_STEPS)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    out["replayed_ms"], m = _timed_steps(torch, step_fn, state, gen, tokens,
                                         TRAIN_TIMED)
    with disable_capture():
        out["eager_ms"], _ = _timed_steps(torch, step_fn, state, gen, tokens,
                                          TRAIN_TIMED)
    out["tokens_per_s"] = batch * seq / (out["replayed_ms"] / 1e3)
    check(math.isfinite(float(m["nll"])), f"timed steps: nll {m}")
    out["profile"] = profile_window(
        torch, f"{TRAIN_ARCH} training step (replayed)",
        lambda: step_fn(state, gen, tokens), TRAIN_PROFILED)
    del state, step_fn, m
    _forget_train_programs(torch)

    # SGLD through train(), counted
    lm_reset(mods)
    t0 = time.perf_counter()
    _, hist = train(TRAIN_ARCH, smoke=False, cfg=cfg, steps=TRAIN_SGLD_STEPS,
                    batch=batch, seq=seq, mode="sgld", log_every=1,
                    device=DEVICE)
    torch.cuda.synchronize()
    out["sgld_s"] = time.perf_counter() - t0
    out["sgld_launches"] = lm_counts(mods)
    out["sgld_nll"] = [h[1] for h in hist]
    want = {**dict.fromkeys(out["sgld_launches"], 0),
            **{k: v * TRAIN_SGLD_STEPS for k, v in per_step.items()}}
    check(out["sgld_launches"] == want, f"{TRAIN_ARCH} SGLD: launches "
          f"{out['sgld_launches']}, expected {want}")
    check(len(hist) == TRAIN_SGLD_STEPS
          and all(map(math.isfinite, out["sgld_nll"])),
          f"{TRAIN_ARCH} SGLD: nll {out['sgld_nll']}")
    _forget_train_programs(torch)
    log(f"{TRAIN_ARCH} training ({cfg.n_layers} layers, batch {batch} x "
        f"{seq}, bf16, remat {cfg.remat_policy}): MAP nll "
        f"{out['nll'][0]:.4f} -> {out['nll'][-1]:.4f} in "
        f"{TRAIN_MAP_STEPS} steps ({out['map_s']:.2f} s with the capture); "
        f"{out['replayed_ms']:.2f} ms a step replayed, {out['eager_ms']:.2f} "
        f"eager, {out['tokens_per_s']:.0f} tokens/s; peak "
        f"{out['map_peak_mib']:.1f} MiB; checkpoint {out['ckpt_mb']:.1f} MB "
        f"written in {out['ckpt_write_s']:.2f} s, restored bit for bit in "
        f"{out['ckpt_read_s']:.2f} s; launches {out['launches']}; SGLD nll "
        f"{out['sgld_nll']}, launches {out['sgld_launches']}")
    return out


def train_gates(torch, np, mods):
    """smollm's float32 gate, the remat policies against remat off, and
    the captured step against the eager one."""
    import dataclasses

    from repro_torch.core.program import GRAPH_COUNTS, disable_capture
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import bayes_lm
    from repro_torch.nn import lm

    cfg = _train_cfg(TRAIN_ARCH)
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    out = {}
    b32, s32 = TRAIN_F32_SHAPE
    batch32 = SyntheticTokens(vocab=cfg.vocab, seq_len=s32,
                              global_batch=b32, seed=0,
                              device=DEVICE).batch(0)
    out["float32"] = _float32_gate(torch, TRAIN_ARCH, cfg, params, batch32,
                                   float(TRAIN_MAP_STEPS * b32 * s32), mods,
                                   "flash_fwd_tf32", TRAIN_F32_GRAD)

    # remat: off, "nothing" and "dots", one bf16 gradient each
    batch, seq = TRAIN_SHAPE
    tokens = SyntheticTokens(vocab=cfg.vocab, seq_len=seq,
                             global_batch=batch, seed=0,
                             device=DEVICE).batch(0)
    total = float(TRAIN_MAP_STEPS * batch * seq)
    runs = {}
    for name, kw in (("off", dict(remat=False)),
                     ("nothing", dict(remat_policy="nothing")),
                     ("dots", dict(remat_policy="dots"))):
        runs[name] = _grad_eval(torch, dataclasses.replace(cfg, **kw),
                                params, tokens, total, mods=mods)
    n_attn = _attn_layers(cfg)
    base, g_base, _, _ = runs["off"]
    out["remat"] = {}
    for name, (metrics, grads, launches, peak) in runs.items():
        want = {**dict.fromkeys(launches, 0), "categorical_logits_sum": 1,
                "flash_fwd_tc": n_attn * (1 if name == "off" else 2)}
        check(launches == want, f"remat {name}: launches {launches}, "
              f"expected {want}")
        grad = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(grads, g_base))
        check(metrics["logjoint"] == base["logjoint"], f"remat {name}: "
              f"logjoint {metrics['logjoint']!r} != {base['logjoint']!r}")
        check(grad <= TRAIN_REMAT_GRAD, f"remat {name}: gradient {grad:.3e} "
              f"of a leaf's max from remat off")
        out["remat"][name] = {"peak_mib": peak, "grad_rel_max": grad,
                              "logjoint": metrics["logjoint"],
                              "launches": launches}
    del runs, g_base
    log(f"remat (one bf16 gradient, batch {batch} x {seq}): " + "; ".join(
        f"{k} peak {v['peak_mib']:.1f} MiB, gradient {v['grad_rel_max']:.2e}"
        f" of max" for k, v in out["remat"].items()) + "; logjoint equal")

    # captured against eager: three MAP steps from one start state, twice
    # eagerly (which ops reproduce) and once captured
    def three(eager):
        init_fn, step_fn = bayes_lm.make_train_step(
            cfg, total_tokens=total, mode="map", learning_rate=TRAIN_LR)
        state = init_fn(lm.tree_map(lambda t: t.clone(), params))
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        metrics = []
        ctx = disable_capture() if eager else contextlib.nullcontext()
        with ctx:
            for _ in range(TRAIN_GRAPH_STEPS):
                metrics.append(step_fn(state, gen, tokens)[1])
        torch.cuda.synchronize()
        return state, metrics

    e1, m1 = three(True)
    e2, m2 = three(True)
    before = dict(GRAPH_COUNTS)
    cap, mc = three(False)
    graphs = {k: GRAPH_COUNTS[k] - before[k] for k in before}
    check(graphs["captures"] == 1
          and graphs["replays"] == TRAIN_GRAPH_STEPS - 1,
          f"captured training: {graphs}")
    names = [n for n, _ in _named_leaves(e1)]
    rows = []
    for (name, a), (_, b), (_, c) in zip(_named_leaves(e1), _named_leaves(e2),
                                         _named_leaves(cap)):
        spread = float((a.float() - b.float()).abs().max())
        diff = float((a.float() - c.float()).abs().max())
        rows.append((name, spread, diff))
    metric_spread = max(abs(float(x[k]) - float(y[k])) for x, y in zip(m1, m2)
                        for k in x)
    metric_diff = max(abs(float(x[k]) - float(y[k])) for x, y in zip(m1, mc)
                      for k in x)
    unrepro = [r[0] for r in rows if r[1] > 0]
    for name, spread, diff in rows:
        if spread == 0:
            check(diff == 0, f"captured training: leaf {name} differs from "
                  f"the eager run ({diff:.3e}) where two eager runs agree")
        else:  # within the eager runs' own spread
            check(diff <= spread, f"captured training: leaf {name} differs "
                  f"by {diff:.3e}, two eager runs by {spread:.3e}")
    check(metric_diff <= metric_spread, f"captured training: metrics differ "
          f"by {metric_diff:.3e}, two eager runs by {metric_spread:.3e}")
    out["graphs"] = {"graph_counts": graphs, "eager_unreproducible": unrepro,
                     "leaves": len(names), "metric_spread": metric_spread,
                     "metric_diff": metric_diff,
                     "worst": sorted(rows, key=lambda r: -r[1])[:5]}
    log(f"graphs {TRAIN_ARCH} training ({TRAIN_GRAPH_STEPS} MAP steps): "
        f"{graphs}; "
        + ("identical to the eager run bit for bit, as two eager runs are"
           if not unrepro else
           f"{len(unrepro)} of {len(names)} leaves differ between two eager "
           f"runs (largest spreads {out['graphs']['worst']}); the captured "
           f"run is within each leaf's eager spread, bit for bit elsewhere")
        + f"; metrics spread {metric_spread:.3e}, captured {metric_diff:.3e}")
    del e1, e2, cap, params
    _forget_train_programs(torch)
    return out


def _named_leaves(state):
    from repro_torch.ckpt.checkpoint import _flatten_with_paths
    return _flatten_with_paths(state)


def train_mamba(torch, np, mods):
    """mamba2-1.3b at full width and depth: TRAIN_MAMBA's MAP steps through
    ``train()`` (ssd_scan_tc once a layer and again in remat's recompute,
    counted; finite nll), then the float32 gate at depth cut to
    TRAIN_MAMBA_F32_DEPTH through ssd_scan_tf32."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import train
    from repro_torch.nn import lm

    arch, batch, seq, steps = TRAIN_MAMBA
    cfg = _train_cfg(arch)
    check(cfg.remat and cfg.n_layers == 48, f"{arch}: config {cfg}")
    out = {"arch": arch, "layers": cfg.n_layers, "batch": batch, "seq": seq}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm_reset(mods)
    t0 = time.perf_counter()
    _, hist = train(arch, smoke=False, cfg=cfg, steps=steps, batch=batch,
                    seq=seq, lr=TRAIN_LR, log_every=1, device=DEVICE)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["peak_mib"] = torch.cuda.max_memory_allocated() / (1 << 20)
    out["launches"] = lm_counts(mods)
    out["nll"] = [h[1] for h in hist]
    want = {**dict.fromkeys(out["launches"], 0),
            "ssd_scan_tc": 2 * cfg.n_layers * steps,
            "categorical_logits_sum": steps}
    check(out["launches"] == want, f"{arch} training: launches "
          f"{out['launches']}, expected {want}")
    check(len(hist) == steps and all(map(math.isfinite, out["nll"])),
          f"{arch} training: nll {out['nll']}")
    _forget_train_programs(torch)
    import dataclasses
    c4 = dataclasses.replace(cfg, n_layers=TRAIN_MAMBA_F32_DEPTH)
    params = lm.init_params(c4, seed=0, device=DEVICE)
    tokens = SyntheticTokens(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                             seed=0, device=DEVICE).batch(0)
    out["float32"] = _float32_gate(torch, f"{arch} (depth "
                                   f"{TRAIN_MAMBA_F32_DEPTH})", c4, params,
                                   tokens, float(steps * batch * seq), mods,
                                   "ssd_scan_tf32", TRAIN_MAMBA_F32_GRAD)
    del params
    torch.cuda.empty_cache()
    log(f"{arch} training ({cfg.n_layers} layers, batch {batch} x {seq}, "
        f"bf16): nll {out['nll']} over {steps} MAP steps in "
        f"{out['seconds']:.2f} s; peak {out['peak_mib']:.1f} MiB; launches "
        f"{out['launches']}")
    return out


def sgld_lm(torch, np, mods):
    """``make_sgld_step`` on smollm's Bayesian LM (the weights bound as
    data, as in ``repro``): one step on the card, counted, finite."""
    import dataclasses

    from repro_torch.data import SyntheticTokens
    from repro_torch.infer.sgld import SGLD, make_sgld_step
    from repro_torch.models import bayes_lm
    from repro_torch.nn import lm

    cfg = _train_cfg(TRAIN_ARCH)
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    batch, seq = TRAIN_SGLD_LM
    tokens = SyntheticTokens(vocab=cfg.vocab, seq_len=seq,
                             global_batch=batch, seed=0,
                             device=DEVICE).batch(0)
    m = bayes_lm.make_lm_model(cfg)(params=params, **tokens)
    sgld = SGLD()
    step = make_sgld_step(m, 1e4, sgld=sgld)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    lm_reset(mods)
    _, _, lp = step(gen, params, sgld.init(params), **tokens)
    torch.cuda.synchronize()
    launches = lm_counts(mods)
    want = {**dict.fromkeys(launches, 0), "categorical_logits_sum": 1,
            "flash_fwd_tc": _attn_layers(cfg)}
    check(launches == want, f"make_sgld_step on {TRAIN_ARCH}: launches "
          f"{launches}, expected {want}")
    check(math.isfinite(float(lp)), f"make_sgld_step: logp {float(lp)}")
    log(f"make_sgld_step on {TRAIN_ARCH}'s Bayesian LM (batch {batch} x "
        f"{seq}): logp {float(lp):.6e}, launches {launches}")
    del params, m
    torch.cuda.empty_cache()
    return {"logp": float(lp), "launches": launches}


def train_phase(torch, np, mods):
    """Phase 6h: the Bayesian-LM training path on the card."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"smollm": train_smollm(torch, np, mods)}
    out["gates"] = train_gates(torch, np, mods)
    out["mamba2"] = train_mamba(torch, np, mods)
    out["sgld_lm"] = sgld_lm(torch, np, mods)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = [out["smollm"]["launches"],
                       out["smollm"]["sgld_launches"],
                       out["mamba2"]["launches"], out["sgld_lm"]["launches"],
                       out["gates"]["float32"]["launches"],
                       out["mamba2"]["float32"]["launches"]]
    log(f"phase 6h done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 6i: MoE and MLA (ROADMAP Queue 1 item 9a): deepseek-v2-lite-16b and
# granite-moe-1b-a400m served at full width and depth, deepseek scored,
# expert parallelism over a world of ranks on the card
# ---------------------------------------------------------------------------
# (requests, prompt, new tokens, depth: None for the config's own)
MOE_SERVE = {"deepseek-v2-lite-16b": (8, 1024, 64, None),
             "granite-moe-1b-a400m": (8, 1024, 64, None)}
# the float32 gates' depth (None: the config's own). deepseek's float32
# copy (62 GB) does not fit beside its bf16 weights (31 GB): its gates run
# on the dense layer and 3 MoE layers (about 9 GB), before the full model
MOE_GATE_DEPTH = {"deepseek-v2-lite-16b": 4, "granite-moe-1b-a400m": None}
MOE_SCORE = ("deepseek-v2-lite-16b", 4, 2048)  # (arch, sequences, tokens)
# bf16 scoring: the log-likelihood through categorical_logits_sum against
# the per-site evaluator's plain categorical, on the same bf16 forward:
# both read the same float32 logits (8,192 x 102,400), so they differ
# only in the order of the float32 sum over 838.9 M terms: 7.67e-8 on an
# H100 at this seed (one float32 ulp of the -1.63e6 total); 1e-6 leaves
# 13 ulps
MOE_SCORE_BF16_TOL = 1e-6
# expert parallelism: (arch, depth, sequences, tokens) in float32, and the
# (data, model) meshes of the 4-rank world with their capacity factors
EP_RUN = ("granite-moe-1b-a400m", 2, 2, 256)
EP_MESHES = (((1, 4), None), ((2, 2), "E/k"))
EP_WORLD = 4
EP_TOL = 1e-5
EP_TIMEOUT_S = 300.0


def moe_score_path(torch, mods, cfg, params):
    """deepseek-v2-lite-16b scoring at full width and depth on the served
    bf16 weights: the Bayesian LM's log-likelihood and log-joint of 4 x
    2,048 tokens. Float32 gates on a model cut to ``MOE_GATE_DEPTH``
    layers from the same seed (the served model's first layers:
    ``Initializer`` keys each leaf by its path, and the cut model's paths
    are the full one's first), upcast: the kernel route's log-likelihood
    (``categorical_logits_sum``, counted) against the per-site
    evaluator's plain categorical (rtol 1e-4), logjoint = logprior +
    loglikelihood (rtol 1e-5). The bf16 gate: the same two routes at full
    depth (``MOE_SCORE_BF16_TOL``). Then the timed bf16 evaluations,
    counted: one ``categorical_logits_sum`` a log-likelihood evaluation,
    and the prior's launches apart."""
    import dataclasses

    from repro_torch.core.contexts import LikelihoodContext, PriorContext
    from repro_torch.models import bayes_lm
    from repro_torch.nn import lm

    arch, nseq, ntok = MOE_SCORE
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (nseq, ntok), generator=gen,
                           device=DEVICE)
    labels = torch.randint(0, cfg.vocab, (nseq, ntok), generator=gen,
                           device=DEVICE)
    lik = LikelihoodContext()
    out = {"arch": arch, "layers": cfg.n_layers, "tokens": [nseq, ntok],
           "params": lm.count_params(params)}
    with torch.no_grad():
        cut = dataclasses.replace(cfg, n_layers=MOE_GATE_DEPTH[arch])
        p32 = lm.tree_map(lambda t: t.float(),
                          lm.init_params(cut, seed=0, device=DEVICE))
        c32 = dataclasses.replace(cut, dtype=torch.float32)
        m = bayes_lm.make_lm_model(c32)(tokens=tokens, labels=labels,
                                        params=p32)
        lm_reset(mods)
        ll = float(m.logp_with_context({}, lik))
        out["f32_launches"] = lm_counts(mods)
        ll_plain = float(m.logp_with_context({}, lik, backend="reference"))
        out["f32_plain_launches"] = lm_counts(mods)
        lp = float(m.logp_with_context({}, PriorContext()))
        lj = float(m.logjoint({}))
        del m, p32
        torch.cuda.empty_cache()
    out.update(gate_layers=cut.n_layers, loglik_f32=ll,
               loglik_plain_f32=ll_plain, logprior_f32=lp, logjoint_f32=lj,
               kernel_vs_plain_rel=abs(ll - ll_plain) / abs(ll_plain),
               joint_vs_parts_rel=abs(lj - (lp + ll)) / abs(lj))
    check(all(math.isfinite(x) for x in (ll, lp, lj, ll_plain)),
          f"{arch}: non-finite densities {out}")
    check(out["kernel_vs_plain_rel"] <= 1e-4,
          f"{arch}: log-likelihood with the kernel {ll} vs the plain "
          f"categorical {ll_plain} (rel {out['kernel_vs_plain_rel']:.2e} > "
          "1e-4)")
    check(out["joint_vs_parts_rel"] <= 1e-5,
          f"{arch}: logjoint {lj} != logprior + loglikelihood {lp + ll}")
    want32 = {**dict.fromkeys(out["f32_launches"], 0),
              "categorical_logits_sum": 1}
    check(out["f32_launches"] == want32 and out["f32_plain_launches"]
          == want32, f"{arch} float32 scoring: launches "
          f"{out['f32_launches']}, then {out['f32_plain_launches']} after "
          f"the plain route, expected {want32} for both")

    with torch.no_grad():
        m = bayes_lm.make_lm_model(cfg)(tokens=tokens, labels=labels,
                                        params=params)
        ll_k16 = float(m.logp_with_context({}, lik))
        ll_p16 = float(m.logp_with_context({}, lik, backend="reference"))
        out.update(loglik_bf16_kernel=ll_k16, loglik_bf16_plain=ll_p16,
                   bf16_kernel_vs_plain_rel=abs(ll_k16 - ll_p16)
                   / abs(ll_p16))
        check(math.isfinite(ll_k16) and math.isfinite(ll_p16)
              and out["bf16_kernel_vs_plain_rel"] <= MOE_SCORE_BF16_TOL,
              f"{arch}: bf16 log-likelihood through categorical_logits_sum "
              f"{ll_k16} vs the plain categorical {ll_p16} (rel "
              f"{out['bf16_kernel_vs_plain_rel']:.2e} > "
              f"{MOE_SCORE_BF16_TOL})")
        torch.cuda.synchronize()
        lm_reset(mods)
        lp16 = m.logp_with_context({}, PriorContext())
        torch.cuda.synchronize()
        out["prior_launches"] = lm_counts(mods)
        torch.cuda.reset_peak_memory_stats()
        lm_reset(mods)
        t0 = time.perf_counter()
        ll16 = m.logp_with_context({}, lik)
        lj16 = m.logjoint({})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out["launches"] = lm_counts(mods)
        out["peak_mib"] = torch.cuda.max_memory_allocated() / (1 << 20)
    want = {**dict.fromkeys(out["launches"], 0),
            "categorical_logits_sum": 2}
    check(out["launches"] == want, f"{arch} scoring: launches "
          f"{out['launches']}, expected {want} (one a log-likelihood "
          "evaluation, of 8,192 x 102,400 logits)")
    out.update(logprior_bf16=float(lp16), loglik_bf16=float(ll16),
               logjoint_bf16=float(lj16), ms_per_evaluation=secs * 1e3 / 2,
               tokens_per_s=2 * nseq * ntok / secs)
    check(all(math.isfinite(out[k]) for k in ("logprior_bf16", "loglik_bf16",
                                              "logjoint_bf16")),
          f"{arch}: non-finite bf16 densities")
    log(f"{arch} scoring ({cfg.n_layers} layers, {out['params'] / 1e9:.3f} B "
        f"parameters, {nseq} x {ntok} tokens, vocabulary {cfg.vocab}): "
        f"float32 at {cut.n_layers} layers, log-likelihood {ll:.3f} with "
        f"the kernel, {ll_plain:.3f} plain (rel "
        f"{out['kernel_vs_plain_rel']:.2e}), logjoint - (logprior + "
        f"loglikelihood) rel {out['joint_vs_parts_rel']:.2e}; bf16 "
        f"{ll_k16:.3f} with the kernel, {ll_p16:.3f} plain (rel "
        f"{out['bf16_kernel_vs_plain_rel']:.2e}, limit "
        f"{MOE_SCORE_BF16_TOL}); {out['ms_per_evaluation']:.2f} ms per "
        f"evaluation ({out['tokens_per_s']:.0f} tokens/s), peak "
        f"{out['peak_mib']:.0f} MiB; launches {out['launches']}, the "
        f"prior's {out['prior_launches']}")
    return out


def ep_rank(rank, world_size):
    """One rank of phase 6i's expert-parallel world: granite-moe at full
    width, cut depth, float32; ``forward_train`` with ``moe_impl="ep"`` on
    each of ``EP_MESHES`` against the one-process ``moe_ffn`` forward at the
    same capacity, with the collectives counted."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.nn import lm
    from repro_torch.sharding import DEFAULT_RULES, Mesh, use_rules, world

    arch, depth, nseq, ntok = EP_RUN
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=depth,
                              dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    tokens = torch.randint(0, cfg.vocab, (nseq, ntok), device=DEVICE,
                           generator=torch.Generator(
                               device=DEVICE).manual_seed(3))
    out = {"rank": rank, "backend": torch.distributed.get_backend(),
           "moe_layers": depth - (cfg.first_dense if cfg.moe else 0)}
    for (data, model), factor in EP_MESHES:
        c = cfg if factor is None else dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts / cfg.top_k))
        rules = DEFAULT_RULES.with_mesh(Mesh(
            np.arange(world_size).reshape(data, model), ("data", "model")))
        with torch.no_grad():
            want = lm.forward_train(c, params, tokens)
            _sync(torch)
            world.reset_collective_counts()
            t0 = time.perf_counter()
            with use_rules(rules):
                got = lm.forward_train(dataclasses.replace(c, moe_impl="ep"),
                                       params, tokens)
            _sync(torch)
        out[f"{data}x{model}"] = {
            "capacity_factor": c.capacity_factor,
            "err": rel_err(got, want),
            "err_elementwise": float(((got - want).abs()
                                      - EP_TOL * want.abs()).max()),
            "finite": bool(torch.isfinite(got).all()),
            "shape": tuple(got.shape), "collectives": dict(world.COLLECTIVES),
            "seconds": time.perf_counter() - t0}
    return out


def ep_phase(torch):
    """Expert parallelism over ``EP_WORLD`` ranks spawned on the one card
    (gloo over CUDA tensors; a time limit kills every rank and fails the
    phase): each mesh's forward equal to moe_ffn's within ``EP_TOL`` of
    the largest logit (``rel_err``: the ranks' partial sums add a
    token's k pairs in another order, and float32's error in a logit
    scales with the largest, up to about 150 here; each logit's reading
    at rtol and atol ``EP_TOL`` reported), on every rank, with exactly
    one all-reduce over the expert axis a MoE layer (and one all-gather
    over the data axis a MoE layer where it has two ranks). A correctness
    check, not a speed figure: four processes time-share one card."""
    from repro_torch.sharding import spawn_world

    t0 = time.perf_counter()
    ranks = spawn_world(ep_rank, EP_WORLD, device=DEVICE,
                        timeout_s=EP_TIMEOUT_S)
    out = {"world_s": time.perf_counter() - t0, "ranks": ranks}
    arch, depth, nseq, ntok = EP_RUN
    for (data, model), factor in EP_MESHES:
        key = f"{data}x{model}"
        layers = ranks[0]["moe_layers"]
        want = {"model": layers, **({"data": layers} if data > 1 else {})}
        for r in ranks:
            case = r[key]
            check(case["finite"] and case["err"] <= EP_TOL,
                  f"EP {key} rank {r['rank']}: forward differs from moe_ffn "
                  f"beyond {EP_TOL} ({case['err']:.3e})")
            check(case["collectives"] == want,
                  f"EP {key} rank {r['rank']}: collectives "
                  f"{case['collectives']}, expected {want}")
        log(f"EP {arch} ({depth} layers, float32, {nseq} x {ntok} tokens) on "
            f"a data {data} x model {model} mesh of {EP_WORLD} ranks "
            f"({r['backend']}), capacity factor {case['capacity_factor']:g}: "
            f"forward within {EP_TOL} of moe_ffn's largest logit on every "
            f"rank (worst {max(r[key]['err'] for r in ranks):.2e}; each "
            f"logit at rtol and atol {EP_TOL}: "
            f"{max(r[key]['err_elementwise'] for r in ranks):.2e}), "
            f"collectives a rank {want}")
    return out


def moe_phase(torch, np, mods):
    """Phase 6i: the two MoE architectures' serving paths (deepseek's MLA
    launches no flash kernel: zero launches), deepseek's scoring on the
    served weights, then expert parallelism."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {}
    for arch, shape in MOE_SERVE.items():
        out[f"{arch}_serving"], (cfg, params, _) = lm_serve_path(
            torch, arch, mods, shape, MOE_GATE_DEPTH[arch])
        if arch == MOE_SCORE[0]:
            out[f"{arch}_scoring"] = moe_score_path(torch, mods, cfg,
                                                    params)
        del params
        torch.cuda.empty_cache()
    out["ep"] = ep_phase(torch)
    out["seconds"] = time.perf_counter() - t0
    runs = [v for k, v in out.items() if k.endswith(("_serving",
                                                     "_scoring"))]
    out["launches"] = ([r["launches"] for r in runs]
                       + [r.get("f32_launches", {}) for r in runs])
    log(f"phase 6i done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 7 (continued): the LM kernels' times, profiles of the LM paths
# ---------------------------------------------------------------------------
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak (NVIDIA data sheet)


def flash_pairs(torch, kw, heads: int) -> int:
    """(query, key) pairs the masks keep, over every query head."""
    qp = kw["q_positions"][:, :, None].long()
    kp = kw["kv_positions"][:, None, :].long()
    keep = kw["kv_mask"][:, None, :] & (kp <= qp)
    if kw["window"] is not None:
        keep &= qp - kp < kw["window"]
    return int(keep.sum()) * heads


def sdpa_call(torch, F, q, k, v, kw):
    """One PyTorch call computing the same attention (no softcap): SDPA
    with a boolean mask and enable_gqa."""
    B, Sq, KV, G, hd = q.shape
    qp = kw["q_positions"][:, None, :, None]
    kp = kw["kv_positions"][:, None, None, :]
    mask = kw["kv_mask"][:, None, None, :] & (kp <= qp)
    if kw["window"] is not None:
        mask = mask & (qp - kp < kw["window"])
    qh = q.reshape(B, Sq, KV * G, hd).transpose(1, 2)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              enable_gqa=True)

    def as_ours(o):
        return o.transpose(1, 2).reshape(B, Sq, KV, G, hd)

    return library, as_ours


def time_row(torch, name, shape, kern, plain, library, nbytes, nops, peak,
             why_none=None, launches=1, names=None, passes=1):
    """A timing row: device ms (profiler) and issued ms (CUDA events) of
    the kernel, its plain version and the library call, beside the bound
    from ``nbytes`` and ``passes`` times ``nops`` at ``peak`` operations
    per second (3 for a 3xTF32 kernel at the TF32 rate), and the bound of
    ``nops`` at the FP32 rate beside it."""
    calls = {"": kern, "plain_": plain}
    if library is not None:
        calls["library_"] = library
    row = {"name": name, "shape": shape, "ms_from": "torch.profiler device "
           "time"}
    for prefix in ("plain_", "", "", "plain_"):
        row.setdefault(f"{prefix}issued_ms_runs", []).append(
            time_ms(torch, calls[prefix], iters=10, warmup=2))
    if library is not None:
        row["library_issued_ms_runs"] = [time_ms(torch, library, iters=10,
                                                 warmup=2)]
    else:
        row.update(library_ms=None, library_issued_ms=None,
                   library_none_because=why_none)
    for prefix, fn in calls.items():
        row[f"{prefix}issued_ms"] = min(row[f"{prefix}issued_ms_runs"])
        row[f"{prefix}profiler_ms"] = device_ms(
            torch, fn, iters=10,
            launches_per_call=launches if prefix == "" else None,
            names=names if prefix == "" else None)
        row[f"{prefix}ms"] = row[f"{prefix}profiler_ms"]
    # a kernel of 50 us or more keeps the device busy back to back, so CUDA
    # events time its row (the profiler has shown such a kernel at half its
    # event time while its count was whole); a shorter one is issued slower
    # than it runs, and the profiler's device times are the row's times
    if any(row[f"{p}ms"] is None for p in calls) or row["ms"] >= 0.05:
        row["ms_from"] = "cuda events"
        for prefix in calls:
            row[f"{prefix}ms"] = row[f"{prefix}issued_ms"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = passes * nops / peak * 1e3
    row.update(bytes=nbytes, ops=nops, passes=passes, peak_ops_per_s=peak,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_fp32_ms=max(t_bytes, nops / FP32_FLOPS_PER_S * 1e3))
    lib = (f"library {row['library_ms'] * 1e3:.2f}" if library is not None
           else "library: none")
    log(f"time {name} {'x'.join(map(str, shape))} (device / issued), us: "
        f"kernel {row['ms'] * 1e3:.2f} / {row['issued_ms'] * 1e3:.2f}, plain "
        f"{row['plain_ms'] * 1e3:.2f} / {row['plain_issued_ms'] * 1e3:.2f}, "
        f"{lib}, bound {row['bound_ms'] * 1e3:.2f} ({row['bound_by']}, "
        f"{passes} x ops at {peak / 1e12:.0f} TFLOP/s; at the FP32 rate "
        f"{row['bound_fp32_ms'] * 1e3:.2f})")
    return row


# the LM paths' flash calls that are timed, each in the type the main path
# runs it in: the bf16 serving calls (flash_fwd_tc, flash_decode) and the
# float32 gates' prefill (flash_fwd_tf32, and the FP32 flash_fwd on the
# same call)
# kernels whose line has a row for each timed call, not only the widest
PER_CALL_ROWS = ("flash_fwd", "flash_fwd_tc", "flash_decode",
                 "flash_fwd_tf32", "ssd_scan_tf32",
                 "categorical_logits_sum_small", "categorical_logits_sum",
                 "bernoulli_logit_sum", "ssd_scan",
                 "std_normal_sum", "gamma_unnorm_sum", "beta_unnorm_sum",
                 "student_t_unnorm_sum", "normal_sum", "fused_leapfrog",
                 "fused_potential_vg")
FLASH_TIMED = (("smollm_prefill", "bfloat16"), ("smollm_decode", "bfloat16"),
               ("gemma2_prefill_local", "bfloat16"),
               ("gemma2_decode_local", "bfloat16"),
               ("smollm_prefill", "float32"),
               ("granite_moe_prefill", "bfloat16"),
               ("granite_moe_decode", "bfloat16"),
               ("granite_moe_prefill", "float32"))


def read_bytes(t) -> int:
    """Bytes of ``t`` counted once: an axis of stride 0 (one row shared by
    the batch) is read once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n


def flash_launches_per_call(fops, q, k) -> int:
    """Kernels one call launches: the tensor-core kernels' pre-pass, the
    kernel, and a prefill kernel's split combine (flash_decode merges its
    own)."""
    B, Sq, KV, G, hd = q.shape
    kernel, _, nsplit = fops.plan(B, Sq, k.shape[1], KV, G, q.dtype, hd)
    return ((kernel in ("flash_fwd_tc", "flash_fwd_tf32")) + 1
            + (nsplit > 1 and kernel != "flash_decode"))


# each LM kernel's peak rate and passes of the products at it, by the
# inputs' type: the bf16 tensor cores; the 3xTF32 kernels' three passes at
# the TF32 rate; the FP32 kernels on the CUDA cores (a bf16 call at the bf16
# rate, as the inputs' type gives it)
_BF16, _FP32, _TF32 = ((BF16_FLOPS_PER_S, 1), (FP32_FLOPS_PER_S, 1),
                       (TF32_FLOPS_PER_S, 3))
ROUTE_PEAK = {"flash_fwd_tc": {"bfloat16": _BF16},
              "flash_decode": {"bfloat16": _BF16},
              "flash_fwd": {"float32": _FP32},
              "flash_fwd_tf32": {"float32": _TF32},
              "ssd_scan_tc": {"bfloat16": _BF16},
              "ssd_scan": {"bfloat16": _BF16, "float32": _FP32},
              "ssd_scan_tf32": {"float32": _TF32}}

# the SSD kernels' device functions, as the profiler names them
SSD_DEVICE_NAMES = {"ssd_scan": "ssd_scan_kernel<", "ssd_scan_tc": "ssd_scan_tc<",
                    "ssd_scan_tf32": "ssd_scan_tf32"}
# kernels a call: ssd_scan_tf32's pre-pass (ssd_scan_tf32_gram) and scan
SSD_LAUNCHES_PER_CALL = {"ssd_scan": 1, "ssd_scan_tc": 1, "ssd_scan_tf32": 2}
# positions a step of the scan where it is not the call's chunk:
# ssd_scan_tf32 walks sub-chunks of 64 whatever the chunk (ssd_scan.cu
# kTfRows), so its work, and the bound, are those of chunk 64
SSD_STEP_ROWS = {"ssd_scan_tf32": 64}


def time_lm_kernels(torch, F, fops, fref, sops, sref):
    """flash_attention's kernels at the LM paths' calls (FLASH_TIMED) and
    the SSD kernels at mamba2's: bound from the bytes (q, k, v, out,
    positions and validity read or written once) and the products' flops
    (4 hd per kept (query, key) pair; the SSD's causal halves at the
    positions the kernel steps, ``SSD_STEP_ROWS``) at the peak
    for the kernel's route (the bf16 tensor cores; three TF32 passes for
    the 3xTF32 kernels; FP32 for the FP32 kernels), the FP32 bound beside
    it. At each float32 call the FP32 kernel that ran it before
    (``launch_kernel``) is timed too."""
    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(14)
    rows = []
    for name, dt in FLASH_TIMED:
        spec = LM_FLASH[name]
        dtype = getattr(torch, dt)
        q, k, v, kw = flash_call(torch, spec, dtype, gen)
        B, Sq, KV, G, hd = q.shape
        Sk = k.shape[1]
        nbytes = sum(read_bytes(t) for t in (
            q, q, k, v, kw["q_positions"], kw["kv_positions"], kw["kv_mask"]))
        nops = 4 * hd * flash_pairs(torch, kw, KV * G)
        kern = lambda: fops.flash_attention_gqa(q, k, v, **kw)  # noqa: E731
        plain = lambda: fref.attention_ref(q, k, v, **kw)  # noqa: E731
        library, why = None, None
        if spec["cap"] is None:
            library, as_ours = sdpa_call(torch, F, q, k, v, kw)
            e = rel_err(as_ours(library()), kern())
            check(e < FLASH_TOL[dt], f"SDPA vs flash_attention {name} {dt}: "
                  f"rel {e:.3e}")
        else:
            why = ("scaled_dot_product_attention has no softcap (gemma2's "
                   "cap * tanh(s / cap)), so no single PyTorch call "
                   "computes this attention")
        kernel = flash_kernel_of(fops, q, k)
        peak, passes = ROUTE_PEAK[kernel][dt]
        rows.append(time_row(
            torch, kernel, [B, Sq, Sk, KV, G, hd], kern, plain, library,
            nbytes, nops, peak, why, flash_launches_per_call(fops, q, k),
            names=("flash_",), passes=passes))
        rows[-1].update(call=name, dtype=dt)
        if kernel == "flash_fwd_tf32":  # the FP32 kernel on the same call
            nsplit = fops.plan(B, Sq, Sk, KV, G, dtype, hd).nsplit
            peak, passes = ROUTE_PEAK["flash_fwd"][dt]
            rows.append(time_row(
                torch, "flash_fwd", [B, Sq, Sk, KV, G, hd],
                lambda: fops.launch_kernel("flash_fwd", q, k, v, **kw),
                plain, library, nbytes, nops, peak, why, 1 + (nsplit > 1),
                names=("flash_",), passes=passes))
            rows[-1].update(call=name, dtype=dt)
        del q, k, v
    b, s, h, p, g, n, L = SSD_MAMBA2

    def ssd_ops(rows_a_step):
        """The products' flops when the scan steps ``rows_a_step``
        positions at a time, C B^T formed once for a group's heads."""
        nc = -(-s // rows_a_step)
        causal = rows_a_step * (rows_a_step + 1) // 2
        return 2 * b * nc * (g * causal * n + h * (
            causal * p + 2 * rows_a_step * n * p))
    for dt_name in ("bfloat16", "float32"):
        ins = ssd_inputs(torch, SSD_MAMBA2, getattr(torch, dt_name), gen)
        nbytes = sum(read_bytes(t) for t in ins) + read_bytes(ins[0])  # + y
        # at each call the kernel plan picks and the FP32 kernel
        for kernel in (("ssd_scan_tc", "ssd_scan") if dt_name == "bfloat16"
                       else ("ssd_scan_tf32", "ssd_scan")):
            peak, passes = ROUTE_PEAK[kernel][dt_name]
            rows.append(time_row(
                torch, kernel, list(SSD_MAMBA2),
                lambda k=kernel, i=ins: sops.launch_kernel(k, *i, chunk=L),
                lambda i=ins: sref.ssd_scan_ref(*i, chunk=L), None, nbytes,
                ssd_ops(SSD_STEP_ROWS.get(kernel, L)), peak,
                NO_LIBRARY[kernel], SSD_LAUNCHES_PER_CALL[kernel],
                names=(SSD_DEVICE_NAMES[kernel],), passes=passes))
            rows[-1].update(call=f"mamba2_scoring_{dt_name}", dtype=dt_name)
        del ins
    return rows


def profile_window(torch, label, fn, steps):
    """Device busy share and top kernels over ``steps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_PAD_S)  # as device_ms pads its windows
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(WINDOW_PAD_S)
    events = prof.key_averages()
    kernels = sorted(((e.key, device_us(e), e.count) for e in events
                      if device_us(e) > 0 and e.device_type.name == "CUDA"),
                     key=lambda k: -k[1])
    busy_us = sum(k[1] for k in kernels)
    out = {"window": label, "calls": steps,
           "wall_ms_per_call": wall * 1e3 / steps,
           "device_ms_per_call": busy_us / 1e3 / steps,
           "busy_share": busy_us / 1e6 / wall if busy_us else None,
           "kernel_launches_per_call": sum(k[2] for k in kernels) / steps,
           "top_kernels": [{"name": k, "device_us": us, "count": c}
                           for k, us, c in kernels[:10]]}
    if busy_us:
        log(f"profile {label}: {out['wall_ms_per_call']:.3f} ms wall per "
            f"call, {out['device_ms_per_call']:.3f} ms on the device, busy "
            f"share {out['busy_share']:.3f}, "
            f"{out['kernel_launches_per_call']:.0f} launches per call; top:")
        for k in out["top_kernels"][:6]:
            log(f"    {k['device_us'] / steps:10.2f} us/call "
                f"x{k['count'] // steps:<4d} {k['name'][:90]}")
    else:
        log(f"profile {label}: the trace shows no device time (not measured)")
    return out


def profile_lm(torch, serve_state, score_state):
    """A window of decode steps of each serving path (its prefill once),
    eager and replayed (``launch.serve.decode_program``, as ``serve_batch``
    runs it), ms a token of each unprofiled, in turns, and one scoring
    evaluation."""
    from repro_torch.core.contexts import LikelihoodContext
    from repro_torch.core.program import disable_capture
    from repro_torch.launch.serve import decode_program
    from repro_torch.models import bayes_lm
    from repro_torch.nn import lm
    out = {}
    for arch, (cfg, params, prompts) in serve_state.items():
        B, S = prompts.shape
        steps = 8
        # the eager window's steps, then the program's: two before its
        # window, one more at the window's start, the window, and the
        # timed steps in four turns
        n_prog = 3 + steps + 2 * DECODE_TIMED
        cache = lm.init_cache(cfg, B, S + steps + 2 + n_prog, device=DEVICE)
        prefill = bayes_lm.make_prefill_step(cfg)
        decode = bayes_lm.make_serve_step(cfg)
        with torch.no_grad():
            out[f"{arch}_prefill"] = profile_window(
                torch, f"{arch} prefill", lambda: prefill(
                    params, prompts, lm.init_cache(cfg, B, S, device=DEVICE)),
                1)
            prefill(params, prompts, cache)
            pos = torch.full((B,), S, dtype=torch.int32, device=DEVICE)
            token = prompts[:, -1:].to(torch.int32)
            state = {"i": 0}

            def step():
                decode(params, token, cache, pos + state["i"])
                state["i"] += 1

            out[f"{arch}_decode"] = profile_window(
                torch, f"{arch} decode step", step, steps)
            prog = decode_program(cfg)
            tok = token.clone()
            ppos = pos + steps + 2
            toks = torch.empty((B, n_prog + 1), dtype=torch.int32,
                               device=DEVICE)
            idx = torch.zeros((1,), dtype=torch.int64, device=DEVICE)
            gen = torch.Generator(device=DEVICE).manual_seed(0)

            def call():
                prog(params, tok, cache, ppos, toks, idx, gen, None)

            call()
            call()
            out[f"{arch}_decode_replayed"] = profile_window(
                torch, f"{arch} decode step replayed", call, steps)
            timed = {"replayed": [], "eager": []}
            for mode in ("replayed", "eager", "eager", "replayed"):
                n = DECODE_TIMED // 2
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (disable_capture() if mode == "eager"
                      else contextlib.nullcontext()):
                    for _ in range(n):
                        call()
                torch.cuda.synchronize()
                timed[mode].append((time.perf_counter() - t0) * 1e3 / n)
            check(prog.captures == 1, f"{arch}: the decode program was "
                  f"captured {prog.captures} times")
            out[f"{arch}_decode_ms_per_token"] = timed
            log(f"{arch} decode ms a token (unprofiled, {DECODE_TIMED // 2} "
                f"steps a turn): replayed {timed['replayed']}, eager "
                f"{timed['eager']}")
        del cache
    cfg, params, tokens, labels = score_state
    with torch.no_grad():
        m = bayes_lm.make_lm_model(cfg)(tokens=tokens, labels=labels,
                                        params=params)
        out["mamba2-1.3b_scoring"] = profile_window(
            torch, "mamba2-1.3b scoring (log-likelihood)",
            lambda: m.logp_with_context({}, LikelihoodContext()), 2)
    return out


# ---------------------------------------------------------------------------
REFERENCE_SAMPLES = 300  # gaussian_10k, family_mix_8k under the autodiff integrator


# the kernels whose registers, shared memory and spills phase 2 reports
PTXAS_REPORTED = ("flash_fwd_tc", "flash_tiles", "flash_decode",
                  "flash_combine", "flash_fwd_tf32", "categorical_small_partials",
                  "mvn_quad_tc", "ssd_scan_tc", "ssd_scan_tf32", "row_sum",
                  "leapfrog_kernel")


def ptxas_report(path: str) -> list:
    """``nvcc -Xptxas -v``'s lines for the PTXAS_REPORTED kernels of one
    source: (kernel, its properties) pairs. A separate compile whose output
    is discarded: the library phase 2 loads is built without -v."""
    from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, find_nvcc
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(BUILD_DIR / f"ptxas-{Path(path).stem}.so"), str(ROOT / path)],
        capture_output=True, text=True, check=False)
    check(proc.returncode == 0, f"nvcc -Xptxas -v failed for {path}:\n"
          f"{proc.stderr[-4000:]}")
    out, kernel = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
            kernel = name if any(k in name for k in PTXAS_REPORTED) else None
        elif kernel is not None and ("spill" in line or "Used" in line):
            out.append((kernel, line.split(":", 1)[-1].strip()))
    return out


def build_all(loaders):
    """Build every kernel source at once (one nvcc each, started
    together); ``loaders`` maps a source to the function that builds and
    loads it. Returns seconds per source."""
    from concurrent.futures import ThreadPoolExecutor

    def one(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(loaders)) as pool:
        futures = {path: pool.submit(one, load)
                   for path, load in loaders.items()}
        return {path: f.result() for path, f in futures.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=None,
                    help="HMC draws per chain for every model (default: "
                         "DRAWS, Table 1's 2000 where the time allows)")
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke.json"),
                    help="where to write the full results as JSON")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core.potential import compile_potential
        from repro_torch.kernels.fused_leapfrog import ops as lf_ops
        from repro_torch.kernels.fused_leapfrog import ref as lf_ref
        from repro_torch.kernels.fused_leapfrog import spec as spec_mod
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.flash_attention import ref as fref
        from repro_torch.kernels.fused_logpdf import ops, ref
        from repro_torch.kernels.ssd_scan import ops as sops
        from repro_torch.kernels.ssd_scan import ref as sref
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: {exc}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi)

    # phase 2
    t0 = time.perf_counter()
    reports = {}
    build_s = build_all({
        LOGPDF_CU: ops._lib, MVN_CU: ops._mvn_lib, LEAPFROG_CU: lf_ops._lib,
        FLASH_CU: fops._lib, SSD_CU: sops._lib,
        # the -Xptxas -v compiles of the sources with this slice's kernels,
        # started with the builds
        **{f"{path} (-Xptxas -v)": (lambda p=path: reports.__setitem__(
            p, ptxas_report(p)))
           for path in (FLASH_CU, LOGPDF_CU, MVN_CU, SSD_CU, LEAPFROG_CU)}})
    for path, secs in build_s.items():
        log(f"built and loaded {path} in {secs:.2f} s")
    log(f"{len(build_s)} compiles in {time.perf_counter() - t0:.2f} s")
    for path, lines in reports.items():
        for kernel, props in lines:
            log(f"ptxas {Path(path).name} {kernel}: {props}")

    # phase 3
    worst = check_kernels(torch, ops, ref)
    worst.update(check_categorical_gamma_kernels(torch, ops, ref))
    check_one_launch(torch, ops, ref)
    worst.update(check_density_kernels(torch, ops, ref))
    worst.update(check_leapfrog_kernels(torch, lf_ops, lf_ref, spec_mod))
    check_potential_merge(torch, lf_ops, lf_ref)
    worst.update(check_flash_kernel(torch, fops, fref))
    worst.update(check_ssd_kernel(torch, sops, sref))
    worst["categorical_logits_sum"] = max(worst["categorical_logits_sum"],
                                          check_categorical_lm(torch, ops, ref))
    log(f"phases 1-3 done at {time.perf_counter() - t_start:.1f} s")

    def draws(key):
        return args.samples if args.samples is not None else DRAWS[key]

    # phases 4-6: the main paths, every count zeroed just before each run
    # and read just after it (run_model)
    runs, models = {}, {}
    for name in ("logreg", "naive_bayes", "gaussian_10k"):
        runs[name], pm, kernel, chain = run_model(torch, name, draws(name))
        models[name] = (pm, kernel, chain)
    check(runs["logreg"]["launches"]["bernoulli_logit_sum"] > 0
          and runs["logreg"]["launches"]["std_normal_sum"] > 0,
          "logreg did not launch both kernels")
    # the spec run_chains compiled for gaussian_10k, compiled again on the
    # same trace (same seed) for the timing phase, outside the counted runs
    g_pm = models["gaussian_10k"][0]
    g_tvi = g_pm.model.typed_varinfo(
        torch.Generator(device=DEVICE).manual_seed(0)).link()
    g_comp = compile_potential(g_pm.model, g_tvi)
    check(g_comp.kind == "separable" and g_comp.spec is not None
          and g_comp.spec.uniform_op == spec_mod.OP_NORMAL
          and g_comp.spec.dim == 10_000,
          f"gaussian_10k did not compile to a uniform NORMAL spec of dim "
          f"10,000: {g_comp}")
    ref_run, _, _, ref_chain = run_model(
        torch, "gaussian_10k", min(REFERENCE_SAMPLES, draws("gaussian_10k")),
        leapfrog="reference")
    runs["gaussian_10k_reference"] = ref_run
    checks = {"gaussian_10k": check_gaussian(np, models["gaussian_10k"][2],
                                             ref_chain)}
    speedup = ref_run["seconds_per_draw"] / runs["gaussian_10k"]["seconds_per_draw"]
    log(f"gaussian_10k: fused {runs['gaussian_10k']['seconds_per_draw'] * 1e3:.3f}"
        f" ms/draw vs autodiff {ref_run['seconds_per_draw'] * 1e3:.3f} ms/draw "
        f"({speedup:.1f}x)")
    for name in ("hier_poisson", "hmm_semisup", "lda", "gauss_unknown"):
        runs[name], pm, kernel, chain = run_model(torch, name, draws(name))
        models[name] = (pm, kernel, chain)
    checks["gauss_unknown"] = check_gauss_unknown(
        np, models["gauss_unknown"][0], models["gauss_unknown"][2])
    key = "gauss_unknown_switch"
    runs[key], pm, kernel, chain = run_model(
        torch, "gauss_unknown", draws(key), leapfrog="reference",
        route="switch")
    models[key] = (pm, kernel, chain)
    checks[key] = check_gauss_unknown(np, pm, chain)
    for name in ("sto_volatility", "family_mix_8k"):
        runs[name], pm, kernel, chain = run_model(torch, name, draws(name))
        models[name] = (pm, kernel, chain)
    f_pm, f_kernel, f_chain = models["family_mix_8k"]
    f_comp = compile_potential(f_pm.model, f_pm.model.typed_varinfo(
        torch.Generator(device=DEVICE).manual_seed(0)).link())
    checks["family_mix_8k"] = check_family_mix_spec(
        torch, np, spec_mod, lf_ops, f_comp.spec, f_pm, f_chain)
    ref_run, _, _, ref_chain = run_model(
        torch, "family_mix_8k",
        min(REFERENCE_SAMPLES, draws("family_mix_8k")), leapfrog="reference")
    runs["family_mix_8k_reference"] = ref_run
    checks["family_mix_8k"].update(check_first_draws(
        np, "family_mix_8k", f_chain, ref_chain, rtol=1e-5))
    log(f"family_mix_8k: first 10 draws of the fused and the autodiff "
        f"integrator agree (max |d| - 1e-5 |draw| "
        f"{checks['family_mix_8k']['fused_vs_reference_draws_max_abs']:.2e})"
        f"; fused {runs['family_mix_8k']['seconds_per_draw'] * 1e3:.3f} "
        f"ms/draw vs autodiff {ref_run['seconds_per_draw'] * 1e3:.3f}")
    runs["mixed"], pm, kernel, chain = run_model(torch, "mixed",
                                                 draws("mixed"))
    models["mixed"] = (pm, kernel, chain)
    memory = {"6": memory_line(torch, "phase 6")}
    # phase 6b: NUTS, the other samplers and Table 1, each run counted
    t6b = time.perf_counter()
    nuts = {"gaussian_10k": nuts_path(torch, np, "gaussian_10k")[0],
            "logreg": nuts_path(torch, np, "logreg")[0]}
    sampler_runs, checks["samplers"] = other_samplers(torch, np)
    table1_runs, table1_rows = table1(torch, np)
    table1_prof = table1_profile(torch, np)
    phase_6b_s = time.perf_counter() - t6b
    log(f"phase 6b done in {phase_6b_s:.1f} s")
    memory["6b"] = memory_line(torch, "phase 6b")
    # phase 6c: every captured PPL path against the same run eagerly
    t6c = time.perf_counter()
    graphs = graphs_phase(torch, np)
    phase_6c_s = time.perf_counter() - t6c
    memory["6c"] = memory_line(torch, "phase 6c")
    # phase 6d: the conditional spec, and the analysis CLI
    t6d = time.perf_counter()
    conditional = conditional_phase(torch, np, runs, models, draws)
    phase_6d_s = time.perf_counter() - t6d
    log(f"phase 6d done in {phase_6d_s:.1f} s")
    memory["6d"] = memory_line(torch, "phase 6d")
    # phase 6e: probability queries and the query server
    query_out = queries_phase(torch, np)
    memory["6e"] = memory_line(torch, "phase 6e")
    # phase 6f: the segmented, resumable, fault-tolerant driver
    driver_out = driver_phase(torch, np)
    memory["6f"] = memory_line(torch, "phase 6f")
    # phase 6g: sharding over a world of ranks on the card
    mesh_out = mesh_phase(torch, np)
    memory["6g"] = memory_line(torch, "phase 6g")
    # the LM paths, each with every count zeroed just before its timed run
    # and read just after it
    lm_mods = (ops, lf_ops, fops, sops)
    lm_runs, serve_state = {}, {}
    for arch in LM_SERVE:
        lm_runs[f"{arch}_serving"], serve_state[arch] = lm_serve_path(
            torch, arch, lm_mods)
    lm_runs["mamba2-1.3b_scoring"], score_state = lm_score_path(torch,
                                                                lm_mods)
    memory["lm"] = memory_line(torch, "the LM paths")
    # phase 6h: Bayesian-LM training
    train_out = train_phase(torch, np, lm_mods)
    memory["6h"] = memory_line(torch, "phase 6h")
    # phase 6i: MoE and MLA
    moe_out = moe_phase(torch, np, lm_mods)
    memory["6i"] = memory_line(torch, "phase 6i")
    log(f"phases 4-6 done at {time.perf_counter() - t_start:.1f} s")

    # phase 7
    floor = launch_floor(torch)
    timings = time_kernels(torch, F, ops, ref)
    timings += time_leapfrog_kernels(
        torch, lf_ops, lf_ref, {"gaussian_10k": g_comp.spec,
                                "family_mix_8k": f_comp.spec})
    g_kernel = models["gaussian_10k"][1]
    prof = {
        "logreg": profile_transitions(torch, *models["logreg"][:2]),
        "gaussian_10k": profile_transitions(torch, g_pm, g_kernel,
                                            spec=g_comp.spec, steps=100),
        "gaussian_10k_reference": profile_transitions(torch, g_pm, g_kernel,
                                                      steps=20),
        "hier_poisson": profile_transitions(torch,
                                            *models["hier_poisson"][:2]),
        # one transition: ~16,000 launches, and the trace's processing
        # grows with them
        "hmm_semisup": profile_transitions(torch, *models["hmm_semisup"][:2],
                                           steps=1),
        "lda": profile_transitions(torch, *models["lda"][:2]),
        # gauss_unknown and eight_schools: the autodiff integrator (no
        # spec), then the conditional one that leapfrog="auto" runs
        "gauss_unknown": profile_transitions(torch,
                                             *models["gauss_unknown"][:2]),
        "gauss_unknown_conditional": profile_transitions(
            torch, *models["gauss_unknown"][:2], spec=cond_spec(
                torch, models["gauss_unknown"][0])),
        "eight_schools": profile_transitions(torch,
                                             *models["eight_schools"][:2]),
        "eight_schools_conditional": profile_transitions(
            torch, *models["eight_schools"][:2], spec=cond_spec(
                torch, models["eight_schools"][0])),
        "gauss_unknown_switch": profile_transitions(
            torch, *models["gauss_unknown_switch"][:2], route="switch"),
        "sto_volatility": profile_transitions(torch,
                                              *models["sto_volatility"][:2]),
        "family_mix_8k": profile_transitions(torch, f_pm, f_kernel,
                                             spec=f_comp.spec, steps=100),
        "family_mix_8k_reference": profile_transitions(torch, f_pm, f_kernel,
                                                       steps=20),
        "mixed": profile_transitions(torch, *models["mixed"][:2]),
    }

    timings += time_lm_kernels(torch, F, fops, fref, sops, sref)
    prof.update(profile_lm(torch, serve_state, score_state))

    kernels = []
    # every counted run's launches: the PPL paths, the LM paths (bf16) and
    # the LM paths' float32 serving runs
    counted = ([r["launches"] for r in runs.values()]
               + [r["launches"] for r in nuts.values()]
               + [r["launches"] for r in sampler_runs.values()]
               + list(table1_runs.values())
               + [r["launches"] for r in lm_runs.values()]
               + [r.get("f32_launches", {}) for r in lm_runs.values()]
               + [query_out["chain_launches"]] + query_out["launches"]
               + driver_out["launches"] + mesh_out["launches"]
               + train_out["launches"] + moe_out["launches"])
    for name in SOURCES:
        # one row per call for the kernels this slice redesigned; for the
        # others the row of the main path's widest call
        timed = [t for t in timings if t["name"] == name]
        if name not in PER_CALL_ROWS:
            timed = [max(timed, key=lambda t: t["bytes"])]
        launches = sum(c.get(name, 0) for c in counted)
        for main in timed:
            extra = ({"off_main_path": OFF_MAIN_PATH[name]}
                     if name in OFF_MAIN_PATH else {})
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": worst[name], "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": main["library_ms"],
                "issued_ms": main["issued_ms"],
                "plain_issued_ms": main["plain_issued_ms"],
                "library_issued_ms": main["library_issued_ms"],
                "ms_from": main["ms_from"], "shape": main["shape"],
                "call": main.get("call"), "bound_fp32_ms":
                main.get("bound_fp32_ms"), **extra,
            })
        # every kernel of the main paths ran there; the FP32 kernels the
        # tensor-core ones replaced there (OFF_MAIN_PATH) ran in phase 3
        check(launches > 0 or name in OFF_MAIN_PATH,
              f"{name} was never launched on the main paths")
        check(not (launches > 0 and name in OFF_MAIN_PATH),
              f"{name} ran on a main path ({launches} launches)")
    total_s = time.perf_counter() - t_start
    log(f"all phases done in {total_s:.1f} s")
    result = {"device": kind, "nvidia_smi": smi, "build_s": build_s,
              "ptxas": {p: lines for p, lines in reports.items()},
              "runs": runs, "nuts": nuts, "sampler_runs": sampler_runs,
              "table1": table1_rows, "table1_profile": table1_prof,
              "phase_6b_s": phase_6b_s, "graphs": graphs,
              "phase_6c_s": phase_6c_s, "conditional": conditional,
              "phase_6d_s": phase_6d_s, "queries": query_out,
              "driver": driver_out, "mesh": mesh_out, "training": train_out,
              "moe": moe_out,
              "memory": memory,
              "lm_runs": lm_runs, "checks": checks,
              "timings": timings, "launch_floor": floor,
              "profile": prof, "kernels": kernels, "seconds": total_s}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    log(f"wrote {out}")

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
