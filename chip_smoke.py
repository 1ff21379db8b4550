#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--ncycles N] [--ncycles-plain N] [--ncycles-stage N]

Phases (any failure exits nonzero and prints no result line):

1. Require CUDA (no CPU fallback); print the card's name and power limit.
2. Build the kernels' five sources (csrc/program_eval.cu, which holds
   #1, its parametric form #1p, their bf16 forms 1b and their float64
   forms, program_multi.cu with #2 and its bf16 and float64 forms 2b and
   2 f64, program_grad.cu with #3 and its float64 form,
   program_predict.cu, program_predict_vjp.cu) from the checkout, one
   nvcc per source, all started together. Prints ptxas's registers,
   stack and spills of every instantiation of #1-#5 (the tile
   interpreter of csrc/interp.cuh).
3. Hold kernel #1 against its plain PyTorch version at the benchmark
   shapes: 16,384 random trees (maxsize 30, + - * / exp abs cos), 5
   features, 10,000 rows. Validity bit-equal; loss and cost within rtol
   1e-5 (the row sums run in another order); inf in the same places; the
   cost form equal to the plain form + loss_to_cost bit for bit;
   dedup=True equal to dedup=False bit for bit; two launches identical.
   Times the kernel (CUDA events) and the plain version.
4. Hold kernels #2 and #3 against their plain versions at the constant
   optimizer's bench shapes: 18,432 trees (512 islands x 36 selected),
   V = 24 line-search variants for #2 and V = 3 restarts for #3, 10,000
   rows. Validity bit-equal; loss within rtol 1e-5 with inf in the same
   places; #2 with V = 1 bit-equal to #1's plain form; #3's loss bit-equal
   to #2's on the same variants; gradients non-finite in the same pairs
   and otherwise within 1e-4 of the sum of the absolute per-row terms;
   two launches bit-identical. #3's checks run again on 18,432 trees whose
   step counts span its three launch classes (MIXED_NLENGTHS). Times both
   kernels (CUDA events, #3 on both inputs) and reckons their bounds.
   Prints a digest of #3's output bits on each input
   (bench/kernel_turns.py compares two checkouts' digests).
5. Main path: `Engine` at the headline configuration, 512 islands x 256
   members x 10,000 rows x 5 features, tournament 16, maxsize 30, the
   constant optimizer on (the default), --ncycles cycles (20; phase 28
   runs the cell's 100): init_state, one warm-up
   iteration, two timed iterations. Prints evals/s (the optimizer's
   f_calls included), seconds per iteration, launches per kernel (per
   iteration: ncycles + 1 of #1, 8 of #2, 9 of #3), peak memory.
6. The same without the constant optimizer (the first slice's path) at a
   cut depth: launches of #1 only.
7. `equation_search(X, y, niterations=1, device="cuda")` with the default
   Options on the same data; one iteration (two until phases 23-25 came)
   keeps the whole script well within its time limit.
8. Hold kernels #4 and #5 against their plain versions at the template
   cycle's shapes: 16,384 random trees (maxsize 30, + - * cos), 10,000
   rows, random cotangents for #5, every fifth tree's const_ok cleared;
   four inputs: shared X (F = 1), the same with overflow rows (every 97th
   row +-1e20, so x * x overflows and inf - inf gives NaN), per-member
   X (F = 2) with overflow rows in every seventh tree's X, and shared X
   (F = 1) on trees whose step counts span #5's three launch classes
   (MIXED_NLENGTHS, 32 trees an island). Validity
   bit-equal; predictions, gcomp and gx NaN in the same places and +-inf
   in the same places, and otherwise predictions and gx within rtol 1e-5,
   or within 1e-5 of the tree's largest finite |value| where the rows
   cancel, and gcomp within 1e-4 of the sum of the absolute per-row
   terms; two launches bit-identical. Prints each input's valid trees,
   non-finite predictions, step-count classes and a digest of #4's and
   #5's output bits. Times both (CUDA events; the shared, per-member and
   mixed-step inputs) and reckons their bounds.
9. Template main path: `Engine` at the JAX package's chip-sized template
   cell (bench/cell.py FULL, variant "template": 512 islands x 256
   members, tournament 16, maxsize 30, + - * cos, 10,000 rows x 2
   features from seed 1234, structure f(x1) * f(x1) + g(x2),
   optimizer_probability 0; cut from 100 to TEMPLATE_CYCLES = 20 cycles):
   init_state, one warm-up
   iteration, two timed iterations. Launches of #4 must be 3 x (ncycles +
   1) per iteration,
   none of #1-#3 or #5; the best hall-of-fame member's loss is recomputed
   on the host from its decoded expression.
10. The template constant optimizer: the same structure at 64 islands x
   256 (the default optimizer_probability 0.14; at 512 islands the
   line search's 442,368 members would need 17.7 GB per [members, rows]
   tensor), cut to TEMPLATE_OPT_CYCLES = 5 cycles (the optimizer runs
   once per iteration whatever the depth, so the cut saves the evolution
   cycles' time within the time limit and leaves the optimizer's launches
   as they are). Launches of #5 must be 27 per iteration (9
   gradient passes x 3 call sites); prints #4's launches and the
   optimizer's share of the evaluations (f_calls).
11. A composition structure g(f(x1), x2) through
   `equation_search(..., device="cuda")`: kernels #4 and #5 in per-member
   mode. Prints the best loss and its string.
12. Hold kernel #1's parametric form (#1p, ``bank[t, p, class[r]]`` per
   parameter leaf) against its plain version: 16,384 random parametric
   trees (F = 2, NP = 2, NC = 3), 10,000 rows, every fifth tree's
   const_ok cleared, every 97th row's X at +-1e20, every 11th tree's bank
   +inf for class 2 only. Validity bit-equal; loss sums NaN and +-inf in
   the same places and within rtol 1e-5 on valid trees; two launches
   bit-identical. Times it (CUDA events), the plain version, and #1 on
   the same trees with their parameter leaves read as constants.
13. Parametric main path: `Engine` at the JAX package's chip-sized
   parametric cell (bench/cell.py FULL, variant "parametric": 512 islands
   x 256 members, tournament 16, maxsize 30, + - * cos, 10,000 rows x 2
   features from seed 1234, class = integers(0, 3), y = amp[class] cos(x1)
   + x2, max_parameters 1, optimizer_probability 0, TEMPLATE_CYCLES = 20
   cycles): launches
   of #1p must be ncycles + 1 per iteration, none of the other kernels;
   prints the best member with its (1, 3) bank.
14. The parametric constant optimizer (eager BFGS over constants and
   banks, torch.autograd through the interpreter): the same problem at 64
   islands x 256, the default optimizer_probability 0.14, cut to
   TEMPLATE_OPT_CYCLES = 5 cycles, one iteration after init (no warm-up
   iteration); prints the f_calls share and the peak memory.
15. `equation_search(..., device="cuda")` on tests/test_parametric.py's
   per-class-offset problem (extra={"class": ...}) and on
   tests/test_template.py's template with parameters f(x1) + p[0] x2 +
   p[1]; fails past those tests' thresholds.

16. Hold kernel 1b (#1 with a bf16 value buffer) against its plain bf16
   version on phase 3's inputs (cost and plain forms) and phase 12's
   (parametric form), and kernel 2b (#2 with a bf16 buffer) on phase 4's
   (V = 24): validity bit-equal, NaN and +-inf in the same places, trees of
   + - * / abs within rtol 1e-5 (both sides store the same bf16 bits), the
   others with a median relative error below 1e-4 and every one below 1e-2
   (an ULP of a transcendental in float32 can flip one bf16 rounding); two
   launches bit-identical; 2b with V = 1 bit-equal to 1b's plain form; and
   against #1/#1p/#2 in float32 on the same inputs, the rank contract of
   tests/test_staged_eval.py (finite verdicts agree on 90%, median relative
   error below 0.02, top-quartile overlap at least 75%). Times each kernel
   and its float32 counterpart (CUDA events) and reckons the bounds.
17. The JAX package's graftstage cells at full width (bench/cell.py FULL,
   variants plain, plain-staged, plain-bf16, plain-staged-bf16: 512 islands
   x 256, tournament 16, maxsize 30, + - * cos, 10,000 rows x 2 features
   from seed 1234, y = cos(2.13 x1) + 0.5 x2, optimizer_probability 0,
   sample fraction 0.125, rescore fraction 0.25) at --ncycles-stage cycles
   (5): launches per iteration exactly ncycles + 1 of #1 / 1b, or 2 x
   ncycles + 1 staged (a screen and a rescore per cycle, the finalize
   without dedup under bf16); after the staged runs every population cost
   equals an unstaged re-eval at the same precision within rtol 1e-5.
18. Phase 5's configuration with optimizer_bf16_linesearch at
   STAGE_LS_CYCLES = 5 cycles: 8 launches of 2b and 9 of #3 per
   iteration, none of #2; the f_calls share and the best loss beside
   phase 5's.
19. equation_search with staged_eval, eval_precision="bf16" and the bf16
   line search on the plain cell's problem (16 islands x 64) and on phase
   15's parametric problem: kernels 1b, 2b and 1b's parametric form only;
   the best member's loss recomputed on the host in float64 from its
   decoded expression within the bf16 tolerance BF16_SEARCH_TOL.
20. Phase 5's configuration with minibatches (batching=True, batch_size
   50, the Options default) at BATCH_CYCLES = 5 cycles: per iteration
   exactly 10 launches of #1 over 50 rows and 1 (the finalize) over 10,000,
   8 of #2 and 9 of #3 over 50 rows, read from every launch's row count;
   #1-#3 replayed on the path's own first 50-row inputs against their plain
   versions (phases 3-4's checks) and timed (CUDA events) beside phases 3
   and 4's 10,000-row times, with their bounds; evals/s counts an
   evaluation as batch_size / n of one, as the JAX package does; the best
   member of the last finalize's population (scored on every row; the hall
   of fame also keeps the cycles' best with their batch losses, and
   migration copies them into the islands, as in the JAX package)
   recomputed on the host in float64 within rtol 1e-5.
21. equation_search at phase 20's configuration without minibatches,
   writing CSVs and a checkpoint every iteration into a temporary
   directory: 3 iterations straight through against 2, then resume="auto"
   to 3 under the same run_id; then the newest checkpoint corrupted and the
   resume repeated from the one before. Every state tensor bit-equal (the
   device evaluation counter restarts at 0 on resume, as in the JAX
   package, so the totals are compared), the CSVs byte-equal. Prints the
   checkpoint's bytes and write seconds.
22. SRRegressor(niterations=2) with the default device_scale="auto" (512
   x 256, tournament 16, 100 cycles: pinning ncycles_per_iteration would
   turn the scale off, as in the JAX package) on phase 5's X with a target
   the bench operators express, seeded with an initial population that
   holds it: predict on 2,000 held-out rows against a float64 host
   evaluation of get_best() within rtol 1e-5 (or 1e-5 of the predictions'
   RMS where rows cancel); MultitargetSRRegressor on two targets at 64
   islands x 256, 10 cycles, returns two equations.

23. Telemetry at full width: equation_search on phase 5's configuration
   at TELEM_CYCLES = 3 cycles, TELEM_ITERS = 2 iterations, with
   telemetry=True (use_recorder off) and off, in turns (off, on, on, off):
   every state tensor and the hall of fame bit-identical; the JSONL valid,
   its events run_start, 2 x iteration, run_end; per iteration the
   identities between the counters (the JAX package's meaning: per island
   in the cycles, plus the finalize) and kernel #1's calls read by
   wrapping its wrapper's __call__ (W calls, the last the dedup'd finalize
   over every row): eval_launches = I (W - 1) + 1, eval_rows = the cycle
   launches' trees + I P, finalize_rows = I P; host syncs per iteration
   (warnings under torch.cuda.set_sync_debug_mode("warn"), on in every
   run) equal with telemetry on and off; s/iteration on and off, host_fraction, and the
   sr:* ranges of one torch.profiler capture of an iteration. Then the
   plain-staged cell (phase 17's) the same way: screen_launches and
   rescore_launches = I x the screen (1,250-row) and rescore (10,000-row)
   calls, screen_rows and rescore_rows = their trees, eval_rows =
   screen_rows + I P.
24. The mini matrix's quality: the 12 non-sharded cells of
   benchmarks/baseline.json (plain, plain-staged, plain-bf16,
   plain-staged-bf16, parametric, template x seeds 0 and 1; bench/cell.py
   MINI) through the port's bench/cell.py on the card, each on its kernel
   (#1, 1b, #1p, #4 by the wrappers' launch counters), gated by the port's
   bench/gate.py: band excursions soft (another library than the
   baseline's), the backstops (best_loss 10x, pareto_volume 0.1x) hard.
   Prints each cell's best_loss and pareto_volume beside the baseline's.
25. A stop between chunks: phase 5's configuration at STOP_CYCLES = 40
   cycles; a single-chunk iteration (timed) and a chunked one ([10] x 4, no stop)
   from one state bit-identical; equation_search with timeout_in_seconds
   at a quarter of that iteration stops within its first iteration, after
   the epilogue (the counters give the cycles run). Prints the overshoot.

26. Every library loss besides L2 (L1, Huber at deltas 0.5, 1 and 2,
   log-cosh, the logit distance, sigmoid cross-entropy on 0/1 targets,
   the periodic L2 at periods 2 pi and 1) on kernels #1 (cost form), #1p,
   1b, #2, 2b and #3 against their plain versions on the first
   LOSS_SUBSET (#1, #1p, 1b) or LOSS_SUBSET_MULTI (#2, 2b, #3) trees of
   phases 3, 12 and 4's inputs (rtol 1e-5, 1b and 2b by phase 16's bf16
   rule, #3's loss bit-equal to #2's, gradients within 1e-4 of the
   absolute row sums), log-cosh on every tree too; each kind's #1, #2 and
   #3 timed at the full shapes (CUDA events) beside its bound. Then the
   float64 forms of #1 (cost form), #1p, #2 and #3 at the full shapes in
   float64 against their float64 plain versions (rtol 1e-9; #3's loss
   bit-equal to #2's), timed, bounds at FP64's 34 TFLOP/s, and every kind
   on their subsets.
27. The optimizer cell at LOSS_CYCLES = 3 cycles with
   elementwise_loss="logcosh" (launches of #1-#3 only: 11, 8 and 9 an
   iteration) and with eval_dtype="float64" (the same counts of their
   float64 forms, none of the float32 kernels), and the parametric cell
   in float64 (#1p's float64 form only); each best member's loss
   recomputed on the host in float64 (log-cosh within rtol 1e-3, float64
   within 1e-9).
28. ``python -m symbolicregression_jl_tpu_torch.bench.headline`` in its own
   process: its JSON line (the headline metric) printed.

29. A user elementwise callable (ops/fused_eval.py's user-loss route:
   kernel #4's predictions in chunks, the callable in PyTorch, kernel #5
   in the backward of its gradient) at the optimizer cell's shapes, phase
   4's 18,432 trees over 10,000 rows: for (p - t) ** 2 and abs(p - t) the
   cost form, the line search (V = 24) and the gradient (V = 3) against
   the L2 / L1 forms of kernels #1, #2 and #3 on the same trees (validity
   bit-equal, costs and losses within rtol 1e-5) and, on the first
   USER_SUBSET trees, against the route's plain version (#4 and #5's plain
   versions), gradients within 1e-4 of #3's absolute row sums; times of
   the route beside the library kernels', its launches of #4 and #5, and
   one launch of #4 and #5 over all the trees. Then the optimizer cell at
   USER_CYCLES = 3 cycles with elementwise_loss = lambda p, t: abs(p - t):
   launches of #4 and #5 only, s/iteration, the best member's loss
   recomputed on the host in float64 within rtol 1e-4.
30. graftshield at the optimizer cell (ROBUST_CYCLES = 3 cycles,
   ROBUST_ITERS = 3 iterations, telemetry on): shield off, on, on, off in
   turns, every state tensor bit-identical, s/iteration of each; two
   injected "CUDA out of memory" failures of the second attempt retried,
   the state bit-identical to the clean run; a real
   torch.cuda.OutOfMemoryError (an oversized torch.empty) classified as
   an out-of-memory, and an attempt that held 60% of the free memory and
   then asked for as much again retried successfully after the runner
   freed it; island 3 NaN-poisoned at iteration 1, quarantined, finite
   after; in a child process a SIGTERM at iteration 2 ending "preempted"
   with an emergency checkpoint, then resume="auto" bit-identical to the
   uninterrupted run; in another child a spin kernel
   (``torch.cuda._sleep``) in the second iteration attempt under
   iteration_deadline = ROBUST_DEADLINE: exit code 124, the dump naming
   the phase and iteration, the main thread's last frames printed.

31. Zero-weight padding on the kernels (pack/padding.py): phase 3's 16,384
   trees and phase 4's 18,432 trees (V = 24 line-search and V = 3 gradient
   variants) on the bench data's first 6,000 rows (weights 1), against the
   same rows padded to their 8,192-row bucket with cyclic and with edge
   replicas at weight 0: kernels #1 (plain and cost forms), #2 and #3
   bit-equal (loss sums, costs, validity, gradients), and their plain
   versions too (#1 on every tree, #2 and #3 on PLAIN_SUBSET trees). Times
   #1 at 6,000 and at 8,192 rows.
32. SearchServer(pack=PackPolicy()) on the card at the optimizer cell's
   widths (512 islands x 256, tournament 16, maxsize 30, + - * /, exp abs
   cos, the optimizer on; SERVE_CYCLES = 5 cycles, SERVE_ITERS = 2
   iterations): four requests of 5,000-8,000 rows x 5 features (seeds
   0-3, y as in the optimizer cell), one 8,192-row bucket, submitted
   before start() so they form one cohort: every request done, a launch
   of 4 tenants, only #1-#3 launched (#2 8 and #3 9 a search iteration,
   each iteration the shield retried counted again, read from the
   requests' fault records; #1 as many as the four solo runs together,
   give or take a retried iteration's), one cache miss then hits,
   each fingerprint equal to the request's run alone on a fresh server;
   then a child server takes requests 0 and 1 and SIGKILLs itself at the
   first checkpoint, and a server over the same root finishes both with
   the unkilled fingerprints. Prints requests/s, seconds a cohort round,
   peak memory.
33. equation_search at the optimizer cell, DIAG_CYCLES = 5 cycles,
   DIAG_ITERS = 3 iterations, telemetry on, ledger/pulse/gauge off / on /
   on / off: the state bit-identical across turns, ledger.jsonl valid,
   gauge memory events with torch.cuda bytes, `telemetry timeline`
   valid; at 64 islands and 2 cycles an injected out-of-memory dumps a
   valid pulse bundle and a torch.profiler window over one iteration holds
   the kernels' launches; then bench/load.py's run_load on the card (its
   requests/s, p99 poll latency, cache hit rate and shed fraction).

34. Units at the optimizer cell's widths (UNITS_CYCLES = 3 cycles, 2
   timed iterations) on 10,000 rows from seed 0 of m (kg), v (m/s) and h
   (m), y = 0.5 m v^2 + 9.81 m h (J), dimensional_constraint_penalty
   1000, in turns with the same search without units (off, on, on, off):
   launches of #1-#3 only (phase 5's counts), the dimensional check on
   every evaluation with units and on none without; prints each cycle's
   share of violating candidates, s/iteration on and off, and the lowest-
   cost equation's dimensions, which must not violate.
35. A D template, -D(V, 1)(x1) on y = -dV/dx1 for V = x1^2 cos(x1), at the
   template cell's widths (512 x 256, + - * cos, 10,000 rows from seed
   1234, D_CYCLES = 3 cycles, optimizer off): #4 and #5 once an
   evaluation and nothing else; one batch of 4,096 members' D values from
   #5 against the plain version (phase 8's rule) and beside the eager
   forward mode; then the constant optimizer at 64 islands (probability
   0.14; one iteration after init, no warm-up): the gradient on the eager interpreter's second-order path (no
   launch), the line search on #4 and #5 (once each a line search);
   prints s/iteration, the optimizer's seconds and f_calls share, the
   peak memory.
36. Tooling: `python -m symbolicregression_jl_tpu_torch.bench run` on the
   plain and template mini cells (each a subprocess on the card; their
   kernels launched), `bench gate` against benchmarks/baseline.json and
   `bench trend` over both files, exit codes 0; phase 32's cohort of 4
   under SearchServer(debug_checks=True), cut to DEBUG_SERVE_ITERS = 1
   iteration: every request done, no lock-order violation, every
   observed edge inside lint/lock_order.py's blessed order; one optimizer
   cell iteration with Options(debug_checks=True) and the audit's
   seconds; compile_count_guard(0) around a warm iteration;
   lint/runtime.py's no_transfer around a kernel #1 launch (passes) and
   around an .item() (raises).
37. User operators: gauss(x) = exp(-x * x), softplus(x) = log1p(exp(x))
   and pdiv(a, b) = where(b == 0, 0, a / b), torch callables traced by
   ops/user_ops.py into a generated header; phase 2 builds the five
   sources with it beside the built-in ones (the same set with / in
   pdiv's place runs on those libraries, whose set covers it, and must
   build none of its own). #1 (cost and plain forms), #2
   (V = 24) and #3 (V = 3) on phase 4's 18,432 trees drawn from + - *
   pdiv / exp gauss softplus, #4 and #5 on phase 8's shapes (shared X,
   F = 1; per-member X, F = 2), the kernels on every tree and the plain
   versions on the first USER_OP_SUBSET = 2,048, against them under phases
   3, 4 and 8's rules, with their times and bounds; then
   equation_search(device="cuda") with turbo on at the optimizer cell's
   widths (USER_OP_CYCLES = 10 cycles, one iteration): #1-#3 launched, its
   best loss recomputed on the host in float64; and the engine with pdiv
   and with / in its place, in turns (pdiv, /, /, pdiv; one timed
   iteration each after init, no warm-up): phase 5's launch counts, the eager
   interpreter called no time, s/iteration of each.
38. The dtype forms: #4 and #5's double forms (shared and per-member X)
   and #4's bf16 form against their plain versions on phase 8's shapes;
   1b (cost and parametric forms) and 2b for float64 data (bf16 buffer,
   float32 steps, float64 loss spine) and for bf16 data (a bf16 loss
   spine) on phases 3, 12 and 4's inputs under phase 16's rules (2b's
   plain version on the first USER_OP_SUBSET trees); then
   DTYPE_CYCLES = 10 cycles and one timed iteration after init each: a
   float64 template search at the template cell's widths and its
   optimizer at 64 islands, the optimizer cell with float64 data,
   eval_precision="bf16" and the bf16 line search, the optimizer cell with
   eval_dtype="bfloat16", the parametric cell in both, and a user
   elementwise loss abs(p - t) in a parametric, a float64 and a bf16
   search (the last with phase 37's operators): each on its forms alone by
   the launch counters.

39. Multi-device search (parallel/, mesh/) at the optimizer cell's full
   width (512 islands x 256, tournament 16, maxsize 30, + - * / exp abs
   cos, 10,000 rows x 5 from seed 0, the optimizer on) at MESH_CYCLES = 10
   cycles, one iteration each: (a) in a 1-rank nccl group on cuda:0, the
   plain Engine, the mesh runtime (MeshEngine) and the legacy sharded
   runtime (Engine(plan=)) from the same init, the digests of pops, hof and
   num_evals of both runtimes equal to the plain Engine's, each with #1 11,
   #2 8 and #3 9 launches; (b) two gloo ranks spawned on the one card
   (NCCL refuses two ranks on one device; each rank and the pair under
   MESH_TIMEOUT_S): with the optimizer off the 2-shard MeshEngine's
   digests equal the unsharded Engine's from (a)'s process, with it on
   finite populations, a hall of fame that decodes and migration that
   moved genomes across the shards; each rank's s/iteration, gather bytes
   and seconds, launches of #1-#3 and peak memory; (c) one dedup_exchange
   (rows = shard_unique + local_dup, shard_unique >= global_unique).
40. Data-row shards (``RuntimeOptions(n_data_shards=2)``'s layout): two
   gloo ranks on the one card, one island shard and ROW_RANKS = 2 data
   shards, each rank holding a block of the rows (5,000 of the 10,000)
   and launching the kernels on it; the wrappers add every block's row
   sums before the mean. (a) The optimizer cell at full width and
   ROW_CYCLES = 10: the init population's losses and costs within rtol
   1e-5 of the unsharded Engine's (inf alike); one iteration launches #1
   11 (none in the cost-epilogue form), #2 8 and #3 9 per rank; the same
   seed twice bit-identical; both ranks hold the same state. (b) The
   template cell at ROW_TEMPLATE_CYCLES = 3 (#4 per rank) and its
   optimizer at 64 islands (#5 per rank). (c) One-iteration searches
   (ROW_SMALL_ISLANDS x ROW_SMALL_POP) with batching (batch_size 50),
   staged_eval and a custom loss (the mean absolute error): a finite hall
   of fame each. Prints each rank's seconds, launches, collectives (count,
   bytes, seconds) and peak memory.

Every file a phase writes goes to a temporary directory, removed at the
end. Each phase prints its seconds when the next one starts. The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

N_ROWS = 10_000
N_FEATURES = 5
ISLANDS = 512               # the headline and template cells' width
TEMPLATE_CYCLES = 20        # the template and parametric cells' cut depth (bench/cell.py FULL
                            # has 100; phases 9 and 13)
TEMPLATE_OPT_CYCLES = 5     # the template optimizer phase's cut depth (phase 10)
RTOL = 1e-5
H100_FP32_FLOPS = 67e12     # non-tensor-core FP32 peak, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
# PR 5's times of the kernels PR 6 redesigned (PERF.md section 6, chip_smoke.py
# on an NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's.
PR5_MS = {"program_eval": 1.7189, "program_eval_param": 2.6702, "program_eval_bf16": 1.7574,
          "program_eval_param_bf16": 2.7767, "program_multi": 46.5144,
          "program_multi_bf16": 46.0428}
# The times of kernels #3, #4 and #5 as per-row kernels, before their tile
# redesign (PERF.md section 6, chip_smoke.py on an NVIDIA H100 80GB HBM3 at
# 700 W), printed beside this run's; #4 and #5 at the shared and the
# per-member input.
PER_ROW_MS = {"program_grad": 18.0438, "program_predict shared": 2.1888,
              "program_predict per-member": 2.4685, "program_predict_vjp shared": 7.4891,
              "program_predict_vjp per-member": 9.3743}


def bench_data():
    """The benchmark problem: 10,000 rows x 5 features from seed 0."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-3.0, 3.0, (N_ROWS, N_FEATURES)).astype(np.float32)
    y = (np.cos(2.13 * X[:, 0]) + 0.5 * X[:, 1] * np.abs(X[:, 2]) ** 0.9
         - 0.3 * np.abs(X[:, 3]) ** 1.5
         + 1e-1 * rng.standard_normal(N_ROWS)).astype(np.float32)
    return X, y


def bench_options(sr, ncycles: int, populations: int = 0, optimize: bool = True, **kw):
    """The headline configuration; ``populations`` 0 means ISLANDS. No
    files unless ``kw`` asks for them; ``kw`` may replace the operators."""
    populations = populations or ISLANDS
    base = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["exp", "abs", "cos"],
                maxsize=30, populations=populations, population_size=256,
                tournament_selection_n=16, ncycles_per_iteration=ncycles,
                should_optimize_constants=optimize, save_to_file=False)
    base.update(kw)
    return sr.Options(**base)


def was(name: str) -> str:
    """A redesigned kernel's time before its redesign, for the line that
    prints this run's."""
    if name in PER_ROW_MS:
        return f" (per-row kernel: {PER_ROW_MS[name]:.4f} ms)"
    return f" (PR 5: {PR5_MS[name]:.4f} ms)"


def digest(*ts) -> str:
    """The first 16 hex digits of a SHA-256 over the tensors' bytes (None
    skipped): two runs whose outputs differ in any bit differ here."""
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ptxas_report(log: str, kernel: str):
    """(instantiation, registers, stack bytes, spill stores, spill loads) of
    each entry function whose name contains ``kernel``, from nvcc's
    ``-Xptxas -v`` report; names demangled where cu++filt or c++filt is
    installed."""
    import re
    import shutil

    rows, name, stack = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, stack = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            stack = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and kernel in name:
            rows.append((name, int(m.group(1))) + (stack or (0, 0, 0)))
            name = None
    filt = shutil.which("cu++filt") or shutil.which("/usr/local/cuda/bin/cu++filt") \
        or shutil.which("c++filt")
    if filt and rows:
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows), capture_output=True,
                             text=True).stdout.splitlines()
        if len(out) == len(rows):
            # "void <unnamed>::k<float, (int)0, true, false>(int const*, ...)"
            # -> "k<float, 0, true, false>"; "void <unnamed>::k(int const*, ...)" -> "k"
            short = [re.sub(r"\(int\)", "", o.split("::", 1)[-1]) for o in out]
            rows = [(o[:o.rfind(">(") + 1] if ">(" in o else o.split("(", 1)[0],) + r[1:]
                    for o, r in zip(short, rows)]
    return rows


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same(torch, a, b):
    """Bit-for-bit equality (NaN payloads included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return bool(torch.equal(a, b))


def nonfinite_match(torch, a, b):
    """NaN in the same places, and +-inf in the same places with the same
    sign (NaN compares unequal to itself, so the masks are compared)."""
    ia, ib = torch.isinf(a), torch.isinf(b)
    return (bool(torch.equal(torch.isnan(a), torch.isnan(b))) and bool(torch.equal(ia, ib))
            and bool(torch.equal(a[ia], b[ib])))


def close(torch, a, b):
    """Within rtol where finite, non-finite exactly where the other is.
    Returns (same_inf, within, max rel err, max abs err)."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    same_inf = nonfinite_match(torch, a, b)
    err = (a[fa] - b[fb]).abs()
    within = bool((err <= RTOL * b[fb].abs()).all()) if same_inf else False
    rel = float((err / b[fb].abs().clamp(min=1e-30)).max()) if same_inf and err.numel() else 0.0
    return same_inf, within, rel, float(err.max()) if same_inf and err.numel() else 0.0


class Checks:
    def __init__(self):
        self.failures = []

    def __call__(self, name, ok):
        print(f"  check {name}: {'ok' if ok else 'FAILED'}")
        if not ok:
            self.failures.append(name)

    def raise_if_failed(self, what):
        if self.failures:
            raise RuntimeError(f"{what} checks failed: {self.failures}")


def bound(ops_count: float, bytes_moved: float):
    """(bound ms, bound_by): the larger of the FP32-operation time and the
    byte time on the H100."""
    bound_ops = ops_count / H100_FP32_FLOPS * 1e3
    bound_bytes = bytes_moved / H100_HBM_BYTES_S * 1e3
    return max(bound_ops, bound_bytes), "operations" if bound_ops >= bound_bytes else "bytes"


def kernel1_inputs(torch, sr, dev, options=None):
    """Kernel #1's inputs at the bench shapes (phases 3 and 16): 16,384
    random trees (maxsize 30, + - * / exp abs cos, or ``options``'
    operators) over the bench data."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.population import init_population
    from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.complexity import (build_complexity_tables,
                                                                compute_complexity_batch)
    from symbolicregression_jl_tpu_torch.ops.program import compile_program

    options = options or bench_options(sr, 1)
    X, y = bench_data()
    ds = sr.make_dataset(X, y, device=dev)
    ds.update_baseline_loss(options.elementwise_loss)
    data = ds.data
    cfg = evolve_config_from_options(options, N_FEATURES, dev)
    trees = init_population(rng.split(rng.key(1, device=dev), 64), 256, cfg.mctx).reshape(-1)
    tables = build_complexity_tables(options, N_FEATURES, dev)
    cx = compute_complexity_batch(trees, tables)
    ops = options.operators
    prog = compile_program(trees, N_FEATURES, len(ops.binary))
    args = FE._launch_inputs(prog, data.Xt, data.y, data.weights, N_FEATURES, ops)
    denom = FE._denominator(data.weights, data.Xt)
    norm = FE.baseline_normalization(data.baseline_loss, data.use_baseline)
    scal = torch.stack([denom, norm, torch.tensor(options.parsimony, dtype=torch.float32,
                                                  device=dev)]).contiguous()
    return options, data, trees, cx, prog, args, scal, cx.to(torch.float32).contiguous()


def phase_kernel(torch, sr, dev):
    """Phase 3: kernel #1 against its plain version at the bench shapes."""
    from symbolicregression_jl_tpu_torch.core.losses import loss_to_cost
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    options, data, trees, cx, prog, args, scal, cxf = kernel1_inputs(torch, sr, dev)
    T = trees.length.shape[0]
    ops, el = options.operators, options.elementwise_loss
    denom = scal[0]

    kernel = FE.PROGRAM_EVAL
    loss_k, valid_k = kernel(*args, ops, el)
    loss_k2, valid_k2 = kernel(*args, ops, el)
    lossc_k, validc_k, cost_k = kernel(*args, ops, el, cx=cxf, scal=scal)
    torch.cuda.synchronize()
    loss_p, valid_p = FE.program_eval_plain(*args, ops, el)
    lossc_p, validc_p, cost_p = FE.program_eval_plain(*args, ops, el, cx=cxf, scal=scal)
    torch.cuda.synchronize()

    check = Checks()
    _same = lambda a, b: same(torch, a, b)
    _close = lambda a, b: close(torch, a, b)

    check("two launches bit-identical", _same(loss_k, loss_k2) and _same(valid_k, valid_k2))
    print(f"  bits #1: {digest(loss_k, valid_k, lossc_k, validc_k, cost_k)}")
    check("validity bit-equal (plain form)", _same(valid_k, valid_p))
    check("validity bit-equal (cost form)", _same(validc_k, validc_p))
    # The plain form's loss sum is only meaningful for valid trees.
    same_inf, within, rel_sum, _ = _close(torch.where(valid_p, loss_k, torch.inf),
                                         torch.where(valid_p, loss_p, torch.inf))
    check(f"loss sum within rtol {RTOL} (max rel err {rel_sum:.3g})", within)
    same_inf, within, rel_loss, abs_loss = _close(lossc_k, lossc_p)
    check("inf where the plain version has inf (loss)", same_inf)
    check(f"loss within rtol {RTOL} (max rel err {rel_loss:.3g})", within)
    same_inf, within, rel_cost, _ = _close(cost_k, cost_p)
    check("inf where the plain version has inf (cost)", same_inf)
    check(f"cost within rtol {RTOL} (max rel err {rel_cost:.3g})", within)

    # Cost form == plain form + loss_to_cost, bit for bit (both kernel).
    mean = loss_k / denom
    loss_from_plain = torch.where(valid_k & torch.isfinite(mean), mean, torch.inf)
    cost_from_plain = loss_to_cost(loss_from_plain, data.baseline_loss, data.use_baseline,
                                   cx, options.parsimony)
    check("cost form == plain form + loss_to_cost (bit)",
          _same(lossc_k, loss_from_plain) and _same(cost_k, cost_from_plain))
    l_dd, v_dd = FE.fused_loss(trees, data.Xt, data.y, data.weights, ops, el, dedup=True)
    l_nd, v_nd = FE.fused_loss(trees, data.Xt, data.y, data.weights, ops, el, dedup=False)
    check("dedup=True == dedup=False (bit)", _same(l_dd, l_nd) and _same(v_dd, v_nd))

    ms = cuda_ms(torch, lambda: kernel(*args, ops, el, cx=cxf, scal=scal), reps=10)
    t0 = time.perf_counter()
    FE.program_eval_plain(*args, ops, el, cx=cxf, scal=scal)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    n = N_ROWS
    L, CMAX = args[0].shape[1], args[2].shape[1]
    step_rows = float(prog.nsteps.to(torch.float64).sum()) * n
    ops_count = step_rows + 4.0 * n * T        # one op per step and row; loss d*d*w + sum
    bytes_moved = 4.0 * (T * L + T + T * CMAX + T + N_FEATURES * n + 2 * n + T + 3
                         + 3 * T)              # inputs once, loss/valid/cost out
    bound_ms, bound_by = bound(ops_count, bytes_moved)
    print(f"  kernel vs plain at T={T} trees, F={N_FEATURES}, n={n}, L={L}, CMAX={CMAX}: "
          f"{int(valid_k.sum())} valid, mean steps {step_rows / n / T:.3f}")
    print(f"  kernel {ms:.4f} ms{was(kernel.name)} (cost form, CUDA events, mean of 10), plain "
          f"{plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {ops_count:.4g} FP32 ops, "
          f"{bytes_moved:.4g} bytes)")
    check.raise_if_failed("kernel #1")
    return {
        "name": kernel.name, "route": "cuda", "source": kernel.source,
        "replaces": kernel.replaces, "launches": None, "max_abs_err": abs_loss,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }


def opt_kernel_inputs(torch, sr, dev, options=None):
    """Kernels #2/#3's inputs at the constant optimizer's bench shapes
    (phases 4 and 16): 18,432 trees (512 islands x 36 selected), their
    constants perturbed V = 24 (line search) and V = 3 (gradient) ways;
    ``options`` (the bench options by default) give the operators."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.population import init_population
    from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.program import compile_program

    options = options or bench_options(sr, 1)
    X, y = bench_data()
    ds = sr.make_dataset(X, y, device=dev)
    data = ds.data
    cfg = evolve_config_from_options(options, N_FEATURES, dev)
    k_sel = round(options.population_size * options.optimizer_probability)   # 36
    trees = init_population(rng.split(rng.key(2, device=dev), options.populations), k_sel,
                            cfg.mctx).reshape(-1)
    T = trees.length.shape[0]
    ops, el = options.operators, options.elementwise_loss
    prog = compile_program(trees, N_FEATURES, len(ops.binary))
    instr, nsteps, cvals, const_ok, Xt, yt, w = FE._launch_inputs(
        prog, data.Xt, data.y, data.weights, N_FEATURES, ops)
    nconst = prog.nconst.to(torch.int32).contiguous()
    R = options.optimizer_nrestarts + 1
    C = 8                                               # max_linesearch
    V_ls = R * C
    g = torch.Generator(device=dev).manual_seed(0)

    def variants(V):
        """The trees' constants perturbed V ways, with a few non-finite."""
        cv = cvals[:, None, :] * (1.0 + 0.5 * torch.randn((T, V, cvals.shape[1]), generator=g,
                                                          device=dev))
        cv[::997, -1, 0] = torch.inf
        return cv.contiguous()

    cv_ls, cv_g = variants(V_ls), variants(R)
    return (options, trees, prog, (instr, nsteps, cvals, const_ok, Xt, yt, w), nconst, R, V_ls,
            cv_ls, cv_g)


# Phase 4's second input for #3: islands of 36 trees of a given number of
# operator draws (init_population's nlength), so that the trees' step
# counts m fall in csrc/program_grad.cu's launch classes (m <= 4, 5-12, 13
# or more) in the shares bench/profile_iteration.py counted for #3's trees
# in the optimizer cell's 10-cycle iteration (65.8%, 33.6%, 0.6%): 337
# islands of 1-4 draws, 172 of 5-12 and 3 of 16-18.
MIXED_NLENGTHS = ([1 + i % 4 for i in range(337)] + [5 + i % 8 for i in range(172)]
                  + [16, 17, 18])


def mixed_trees(torch, dev, mctx, seed: int, per_island: int):
    """Islands of ``per_island`` random trees (init_population) of
    MIXED_NLENGTHS operator draws each, flat, grouped by draw count."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.population import init_population
    from symbolicregression_jl_tpu_torch.ops.encoding import TreeBatch

    keys = rng.split(rng.key(seed, device=dev), len(MIXED_NLENGTHS))
    parts = []
    for nl in sorted(set(MIXED_NLENGTHS)):
        idx = torch.tensor([i for i, v in enumerate(MIXED_NLENGTHS) if v == nl], device=dev)
        parts.append(init_population(keys[idx], per_island, mctx, nlength=nl).reshape(-1))
    return TreeBatch(*(torch.cat(f) for f in zip(*(p.fields() for p in parts))))


def mixed_grad_inputs(torch, sr, dev):
    """Kernel #3's phase 4 arguments (instr, nsteps, nconst, cvals_v, X, y,
    w) on 512 x 36 trees of MIXED_NLENGTHS, their constants perturbed
    V = 3 ways with a few non-finite, and the operators and loss."""
    from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.program import compile_program

    options = bench_options(sr, 1)
    X, y = bench_data()
    data = sr.make_dataset(X, y, device=dev).data
    cfg = evolve_config_from_options(options, N_FEATURES, dev)
    trees = mixed_trees(torch, dev, cfg.mctx, 3, 36)
    ops, el = options.operators, options.elementwise_loss
    prog = compile_program(trees, N_FEATURES, len(ops.binary))
    instr, nsteps, cvals, _, Xt, yt, w = FE._launch_inputs(prog, data.Xt, data.y, data.weights,
                                                           N_FEATURES, ops)
    V = options.optimizer_nrestarts + 1
    g = torch.Generator(device=dev).manual_seed(1)
    cv = cvals[:, None, :] * (1.0 + 0.5 * torch.randn((cvals.shape[0], V, cvals.shape[1]),
                                                      generator=g, device=dev))
    cv[::997, -1, 0] = torch.inf
    nconst = prog.nconst.to(torch.int32).contiguous()
    return (instr, nsteps, nconst, cv.contiguous(), Xt, yt, w), ops, el


def grad_checks(torch, check, tag, args, ops, el):
    """Kernel #3 on ``args`` against its plain version and kernel #2 (the
    checks of phase 4, named with ``tag``). Returns (largest gradient error,
    plain version's ms, valid pairs)."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    instr, nsteps, nconst, cv, Xt, yt, w = args
    _same = lambda a, b: same(torch, a, b)
    gl, gv, gg = FE.PROGRAM_GRAD(*args, ops, el)
    gl2, gv2, gg2 = FE.PROGRAM_GRAD(*args, ops, el)
    lm, vm = FE.PROGRAM_MULTI(instr, nsteps, cv, Xt, yt, w, ops, el)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pl, pv, pg, pabs = FE.program_grad_plain(*args, ops, el, return_abs=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(f"#3{tag} two launches bit-identical",
          _same(gl, gl2) and _same(gv, gv2) and _same(gg, gg2))
    print(f"  bits #3{tag}: {digest(gl, gv, gg)}")
    check(f"#3{tag} validity bit-equal", _same(gv, pv))
    check(f"#3{tag} loss == #2's on the same variants (bit)", _same(gl, lm) and _same(gv, vm))
    same_inf, within, rel3, _ = close(torch, torch.where(pv, gl, torch.inf),
                                      torch.where(pv, pl, torch.inf))
    check(f"#3{tag} loss sum within rtol {RTOL} (max rel err {rel3:.3g})", same_inf and within)
    # Gradients: a valid pair's gradient is non-finite in the same
    # components; finite ones agree within 1e-4 of the sum of the absolute
    # per-row terms (each row's derivative agrees within a few ULP; the
    # rows are summed in another order and may cancel).
    live = pv[..., None].expand_as(pg)
    fin_k, fin_p = torch.isfinite(gg), torch.isfinite(pg)
    check(f"#3{tag} gradients non-finite in the same places",
          bool(torch.equal(fin_k[live], fin_p[live])))
    both = live & fin_k & fin_p
    gerr = (gg - pg).abs()[both]
    gtol = 1e-4 * pabs[both]
    check(f"#3{tag} gradients within 1e-4 of the absolute row sums (max err / scale "
          f"{float((gerr / pabs[both].clamp(min=1e-30)).max()):.3g})", bool((gerr <= gtol).all()))
    return (float(gerr.max()) if gerr.numel() else 0.0), plain_ms, int(gv.sum())


def grad_bound(torch, args):
    """(bound ms, bound_by, operations, bytes) of kernel #3 on ``args``: the
    forward's operations, then per step and row the derivative and one more
    operation per operand, the loss derivative and the constants' sums."""
    instr, nsteps, nconst, cv, Xt, yt, w = args
    T, V, CMAX = cv.shape
    L, n = instr.shape[1], Xt.shape[1]
    steps = float(nsteps.to(torch.float64).sum())
    nc = float(nconst.to(torch.float64).sum())
    ops3 = (3.0 * steps + 8.0 * T + nc) * V * n
    bytes3 = 4.0 * (T * L + 2 * T + T * V * CMAX + Xt.shape[0] * n + 2 * n + 2 * T * V
                    + T * V * CMAX)
    return bound(ops3, bytes3) + (ops3, bytes3)


def phase_opt_kernels(torch, sr, dev):
    """Phase 4: kernels #2 and #3 against their plain versions at the
    constant optimizer's bench shapes."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    (options, trees, prog, (instr, nsteps, cvals, const_ok, Xt, yt, w), nconst, R, V_ls, cv_ls,
     cv_g) = opt_kernel_inputs(torch, sr, dev)
    T = trees.length.shape[0]
    ops, el = options.operators, options.elementwise_loss
    check = Checks()
    _same = lambda a, b: same(torch, a, b)
    _close = lambda a, b: close(torch, a, b)
    multi, grad = FE.PROGRAM_MULTI, FE.PROGRAM_GRAD

    # kernel #2
    lk, vk = multi(instr, nsteps, cv_ls, Xt, yt, w, ops, el)
    lk2, vk2 = multi(instr, nsteps, cv_ls, Xt, yt, w, ops, el)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, vp = FE.program_multi_plain(instr, nsteps, cv_ls, Xt, yt, w, ops, el)
    torch.cuda.synchronize()
    plain_ms_multi = (time.perf_counter() - t0) * 1e3
    check("#2 two launches bit-identical", _same(lk, lk2) and _same(vk, vk2))
    print(f"  bits #2: {digest(lk, vk)}")
    check("#2 validity bit-equal", _same(vk, vp))
    same_inf, within, rel2, abs2 = _close(torch.where(vp, lk, torch.inf),
                                          torch.where(vp, lp, torch.inf))
    check("#2 inf where the plain version has inf", same_inf)
    check(f"#2 loss sum within rtol {RTOL} (max rel err {rel2:.3g})", within)
    ones = torch.ones(T, dtype=torch.int32, device=dev)
    l1, v1 = multi(instr, nsteps, cvals[:, None, :].contiguous(), Xt, yt, w, ops, el)
    l1e, v1e = FE.PROGRAM_EVAL(instr, nsteps, cvals, ones, Xt, yt, w, ops, el)
    check("#2 with V = 1 == #1's plain form (bit)", _same(l1[:, 0], l1e) and _same(v1[:, 0], v1e))

    # kernel #3, on phase 4's trees and on trees of every launch class
    gargs = (instr, nsteps, nconst, cv_g, Xt, yt, w)
    abs3, plain_ms_grad, gvalid = grad_checks(torch, check, "", gargs, ops, el)
    margs, mops, mel = mixed_grad_inputs(torch, sr, dev)
    abs3m, plain_ms_mixed, mvalid = grad_checks(torch, check, " (mixed steps)", margs, mops, mel)
    abs3 = max(abs3, abs3m)

    ms_multi = cuda_ms(torch, lambda: multi(instr, nsteps, cv_ls, Xt, yt, w, ops, el), reps=5)
    ms_grad = cuda_ms(torch, lambda: grad(*gargs, ops, el), reps=5)
    ms_mixed = cuda_ms(torch, lambda: grad(*margs, mops, mel), reps=5)
    n = N_ROWS
    L, CMAX = instr.shape[1], cvals.shape[1]
    steps = float(nsteps.to(torch.float64).sum())
    nc = float(nconst.to(torch.float64).sum())
    # #2: one operation per step and row, four for the loss term and sum.
    ops2 = (steps + 4.0 * T) * V_ls * n
    bytes2 = 4.0 * (T * L + T + T * V_ls * CMAX + N_FEATURES * n + 2 * n + 2 * T * V_ls)
    b3, by3, ops3, bytes3 = grad_bound(torch, gargs)
    b3m, by3m, ops3m, bytes3m = grad_bound(torch, margs)
    mm = margs[1].to(torch.float64)
    b2, by2 = bound(ops2, bytes2)
    print(f"  {T} trees (mean steps {steps / T:.3f}, mean constants {nc / T:.3f}), {n} rows; "
          f"{int(vk.sum())} of {T * V_ls} line-search pairs valid, "
          f"{gvalid} of {T * R} gradient pairs valid")
    print(f"  mixed steps: {mm.numel()} trees (mean steps {float(mm.mean()):.3f}; m <= 4 "
          f"{int((mm <= 4).sum())}, 5-12 {int(((mm > 4) & (mm <= 12)).sum())}, 13 or more "
          f"{int((mm > 12).sum())}), {mvalid} of {mm.numel() * R} gradient pairs valid")
    print(f"  #2 program_multi: {ms_multi:.4f} ms{was(multi.name)} (V={V_ls}, CUDA events, "
          f"mean of 5), plain "
          f"{plain_ms_multi:.1f} ms, bound {b2:.4f} ms ({by2}: {ops2:.4g} ops, {bytes2:.4g} B)")
    print(f"  #3 program_grad: {ms_grad:.4f} ms{was(grad.name)} (V={R}, CUDA events, mean of "
          f"5), plain "
          f"{plain_ms_grad:.1f} ms, bound {b3:.4f} ms ({by3}: {ops3:.4g} ops, {bytes3:.4g} B)")
    print(f"  #3 program_grad, mixed steps: {ms_mixed:.4f} ms (V={R}, CUDA events, mean of 5), "
          f"plain {plain_ms_mixed:.1f} ms, bound {b3m:.4f} ms ({by3m}: {ops3m:.4g} ops, "
          f"{bytes3m:.4g} B)")
    check.raise_if_failed("kernels #2 and #3")
    row = lambda k, err, ms, plain, b, by: {
        "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
        "bound_by": by, "library_ms": None}
    return [row(multi, abs2, ms_multi, plain_ms_multi, b2, by2),
            row(grad, abs3, ms_grad, plain_ms_grad, b3, by3)]


KERNEL_NAMES = ("PROGRAM_EVAL", "PROGRAM_MULTI", "PROGRAM_GRAD", "PROGRAM_PREDICT",
                "PROGRAM_PREDICT_VJP", "PROGRAM_EVAL_PARAM", "PROGRAM_EVAL_BF16",
                "PROGRAM_EVAL_PARAM_BF16", "PROGRAM_MULTI_BF16", "PROGRAM_EVAL_F64",
                "PROGRAM_EVAL_PARAM_F64", "PROGRAM_MULTI_F64", "PROGRAM_GRAD_F64",
                "PROGRAM_EVAL_BF16_F64", "PROGRAM_EVAL_PARAM_BF16_F64", "PROGRAM_EVAL_BF16_DATA",
                "PROGRAM_EVAL_PARAM_BF16_DATA", "PROGRAM_MULTI_BF16_F64",
                "PROGRAM_MULTI_BF16_DATA", "PROGRAM_PREDICT_F64", "PROGRAM_PREDICT_BF16",
                "PROGRAM_PREDICT_VJP_F64")


def kernels():
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    return [getattr(FE, k) for k in KERNEL_NAMES]


def run_engine(torch, sr, dev, options, iters: int = 2, data=None, on_engine=None, extra=None,
               units=None, timing=None, warmup: bool = True):
    """init_state, one warm-up iteration (none with ``warmup=False``), then
    ``iters`` timed iterations with every kernel's launch count set to 0
    just before them. ``data``
    is (X, y), the bench problem by default; ``extra`` its class column
    for parametric options; ``units`` the dataset's X_units/y_units;
    ``on_engine`` sees the engine before the timed iterations; ``timing``
    (a list) gets the timed seconds per iteration. Returns (launches by
    kernel name, state, engine, evaluations in the timed iterations)."""
    from symbolicregression_jl_tpu_torch.core.options import float_dtype
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.engine import Engine

    X, y = bench_data() if data is None else data
    dtype = float_dtype(options.eval_dtype)
    ds = sr.make_dataset(X, y, extra=extra, device=dev, dtype=dtype, **(units or {}))
    ds.update_baseline_loss(options.elementwise_loss)
    n_params = n_classes = 0
    if isinstance(options.expression_spec, sr.ParametricExpressionSpec):
        n_params, n_classes = options.expression_spec.max_parameters, ds.n_classes
    engine = Engine(options, X.shape[1], device=dev, n_params=n_params, n_classes=n_classes,
                    dtype=dtype)
    print(f"  islands {options.populations} x members {options.population_size}, "
          f"rows {X.shape[0]} x features {X.shape[1]}, ncycles_per_iteration "
          f"{options.ncycles_per_iteration}, constant optimizer "
          f"{options.should_optimize_constants} (probability {options.optimizer_probability}), "
          f"template {engine.template is not None}, parameter banks "
          f"{engine.cfg.n_params} x {engine.cfg.n_classes}, turbo {engine.cfg.turbo}, fused cost "
          f"{engine.cfg.fuse_cost}, loss {options.elementwise_loss!r}, dtype {engine.dtype}")
    t0 = time.perf_counter()
    state = engine.init_state(rng.key(0, device=dev), ds.data, options.populations)
    if warmup:
        state = engine.run_iteration(state, ds.data, options.maxsize)
    torch.cuda.synchronize()
    print(f"  init{' + warm-up iteration' if warmup else ''}: {time.perf_counter() - t0:.2f} s")
    if on_engine is not None:
        on_engine(engine)

    evals0 = float(state.num_evals)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels():
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(iters):
        state = engine.run_iteration(state, ds.data, options.maxsize)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels()}
    evals = float(state.num_evals) - evals0
    print(f"  {iters} timed iterations: {elapsed / iters:.3f} s/iteration, "
          f"{evals / elapsed:.6g} evals/s ({evals:.0f} evals)")
    if timing is not None:
        timing.append(elapsed / iters)
    print(f"  launches {launches}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not bool(torch.isfinite(state.hof.loss[state.hof.exists]).all()) \
            or not bool(state.hof.exists.any()):
        raise RuntimeError("hall of fame holds no finite entry")
    if state.pops.cost.shape != (options.populations, options.population_size):
        raise RuntimeError(f"population cost has shape {tuple(state.pops.cost.shape)}")
    return launches, state, engine, evals


def expect(launches, **counts):
    """The launch counts a path must show: ``counts``, every other kernel 0."""
    expected = dict.fromkeys(launches, 0)
    expected.update(counts)
    return expected


def best_loss(state) -> float:
    """The hall of fame's best loss."""
    return float(state.hof.loss[state.hof.exists].min())


def phase_main_path(torch, sr, dev, ncycles: int):
    """Phase 5: the headline configuration, constant optimizer on. Returns
    the launches and the hall of fame's best loss."""
    options = bench_options(sr, ncycles)
    iters = 2
    launches, state, _, _ = run_engine(torch, sr, dev, options, iters)
    expected = expect(launches,
                      program_eval=iters * (ncycles + 1),              # each cycle + finalize
                      program_multi=iters * options.optimizer_iterations,     # line searches
                      program_grad=iters * (options.optimizer_iterations + 1))  # + the first
    print(f"  expected {expected}")
    if launches != expected or 0 in (launches[k] for k in ("program_eval", "program_multi",
                                                            "program_grad")):
        raise RuntimeError(f"main path launched {launches}, expected {expected}")
    print(f"  hall of fame best loss {best_loss(state):.6g}")
    return launches, best_loss(state)


def phase_no_optimizer(torch, sr, dev, ncycles: int):
    """Phase 6: the first slice's path (no constant optimizer), cut depth."""
    options = bench_options(sr, ncycles, optimize=False)
    launches, _, _, _ = run_engine(torch, sr, dev, options, iters=2)
    expected = expect(launches, program_eval=2 * (ncycles + 1))
    if launches != expected:
        raise RuntimeError(f"no-optimizer path launched {launches}, expected {expected}")


def phase_search(sr, dev, out_base):
    """Phase 7: equation_search with the default Options on the bench data;
    its files (save_to_file is on by default) go under ``out_base``."""
    X, y = bench_data()
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=sr.Options(output_directory=out_base), niterations=1,
                             seed=0, device=dev, verbosity=0)
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  default Options: {time.perf_counter() - t0:.2f} s, best loss {best.loss:.6g} at "
          f"complexity {best.complexity}: {best.equation_string()}")
    if not np.isfinite(best.loss):
        raise RuntimeError("equation_search returned no finite loss")


# ---------------------------------------------------------------------------
# Template expressions (kernels #4 and #5)
# ---------------------------------------------------------------------------


def template_data():
    """The JAX package's template cell data (bench/cell.py, variant
    "template"): 10,000 rows x 2 features from seed 1234 uniform on
    [-2, 2], y = (1.5 x1)^2 + cos(2 x2)."""
    rng = np.random.default_rng(1234)
    X = rng.uniform(-2.0, 2.0, (N_ROWS, 2)).astype(np.float32)
    y = ((1.5 * X[:, 0]) ** 2 + np.cos(2.0 * X[:, 1])).astype(np.float32)
    return X, y


def template_options(sr, ncycles: int, populations: int = 0, combiner=None, **kw):
    """bench/cell.py FULL with variant "template" (optimizer_probability 0
    unless given); ``populations`` 0 means ISLANDS."""
    populations = populations or ISLANDS
    from symbolicregression_jl_tpu_torch.models import template_spec

    combiner = combiner or (lambda f, g, x1, x2: f(x1) * f(x1) + g(x2))
    spec = template_spec(expressions=("f", "g"))(combiner)
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=30,
                populations=populations, population_size=256, tournament_selection_n=16,
                ncycles_per_iteration=ncycles, optimizer_probability=0.0,
                expression_spec=spec, save_to_file=False)
    base.update(kw)
    return sr.Options(**base)


def tree_close(torch, a, b, rtol=RTOL):
    """[T, ...] values: non-finite in the same places (``nonfinite_match``)
    and otherwise within ``rtol``, or within ``rtol`` of the tree's largest
    finite |b| where the rows cancel. Returns (ok, worst relative error,
    worst error over the tree's scale, worst absolute error)."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    fb = torch.isfinite(b)
    if not nonfinite_match(torch, a, b):
        return False, float("inf"), float("inf"), float("inf")
    scale = torch.where(fb, b.abs(), 0.0).amax(dim=-1, keepdim=True).expand_as(b)[fb]
    err = (a - b).abs()[fb]
    if not err.numel():
        return True, 0.0, 0.0, 0.0
    mag = b.abs()[fb]
    ok = bool(((err <= rtol * mag) | (err <= rtol * scale)).all())
    rel = float((err / mag.clamp(min=1e-30)).max())
    return ok, rel, float((err / scale.clamp(min=1e-30)).max()), float(err.max())


OVERFLOW = 1e20   # x * x overflows float32 at this |x|; x + c, x * c and cos(x) do not


def predict_inputs(torch, sr, dev, F: int, per_member: bool, overflow: bool, g,
                   mixed: bool = False, options=None):
    """Kernel #4/#5 inputs at the template cycle's shapes: 16,384 random
    trees over F arguments (every fifth tree's const_ok cleared), X on
    [-2, 2] (shared [F, n] or per-member [T, F, n]), random cotangents.
    ``overflow`` sets every 97th row to +-OVERFLOW: in every tree's X when
    shared, in every seventh tree's when per-member. ``mixed``: 512 islands
    of 32 trees of MIXED_NLENGTHS operator draws, so that their step counts
    fall in all three launch classes of #5, in place of 5 draws each.
    ``options`` (the template cell's by default) give the operators."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.population import init_population
    from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options
    from symbolicregression_jl_tpu_torch.ops.program import compile_program

    options = options or template_options(sr, 1)
    T, n = ISLANDS * 2 * 16, N_ROWS   # the cycle's candidates: islands x 2 x ceil(256 / 16)
    cfg = evolve_config_from_options(options, F, dev)
    if mixed:
        trees = mixed_trees(torch, dev, cfg.mctx, 9, T // len(MIXED_NLENGTHS))
    else:
        trees = init_population(rng.split(rng.key(5 + F, device=dev), 64), T // 64, cfg.mctx,
                                nlength=5).reshape(-1)
    prog = compile_program(trees, F, len(options.operators.binary))
    X = torch.rand((T, F, n) if per_member else (F, n), generator=g, device=dev) * 4 - 2
    if overflow:
        big = X[::7, :, ::97] if per_member else X[:, ::97]
        big.copy_(torch.where(big < 0, -OVERFLOW, OVERFLOW))
    ct = torch.randn((T, n), generator=g, device=dev)
    ok = prog.const_ok.clone()
    ok[::5] = False
    return options.operators, prog, X, ct, ok.to(torch.int32).contiguous()


def phase_predict_kernels(torch, sr, dev):
    """Phase 8: kernels #4 and #5 against their plain versions at the
    template cycle's shapes, in both X modes and with overflow rows."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    check = Checks()
    _same = lambda a, b: same(torch, a, b)
    k4, k5 = FE.PROGRAM_PREDICT, FE.PROGRAM_PREDICT_VJP
    g = torch.Generator(device=dev).manual_seed(4)
    report, errs4, errs5 = {}, [], []
    for mode, F, per_member, overflow in (("shared", 1, False, False),
                                          ("shared, overflow rows", 1, False, True),
                                          ("per-member", 2, True, True),
                                          ("mixed steps", 1, False, False)):
        ops, prog, X, ct, ok = predict_inputs(torch, sr, dev, F, per_member, overflow, g,
                                              mixed=mode == "mixed steps")
        instr, nsteps, cvals, Xc = FE._predict_inputs(prog, X, F, ops)
        nconst = prog.nconst.to(torch.int32).contiguous()
        T, n = ct.shape

        pk, vk = k4(instr, nsteps, cvals, ok, Xc, ops)
        pk2, vk2 = k4(instr, nsteps, cvals, ok, Xc, ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp, vp = FE.program_predict_plain(instr, nsteps, cvals, ok, Xc, ops)
        torch.cuda.synchronize()
        plain4 = (time.perf_counter() - t0) * 1e3
        check(f"#4 {mode}: two launches bit-identical", _same(pk, pk2) and _same(vk, vk2))
        check(f"#4 {mode}: validity bit-equal", _same(vk, vp))
        good, rel4, scl4, abs4 = tree_close(torch, pk, pp)
        check(f"#4 {mode}: predictions NaN and +-inf in the same places, otherwise within "
              f"rtol {RTOL} or {RTOL} of the tree's largest |pred| (worst relative error "
              f"{rel4:.3g}, worst over the tree's scale {scl4:.3g})", good)
        errs4.append(abs4)

        gk, xk = k5(instr, nsteps, nconst, cvals, Xc, ct, ops)
        gk2, xk2 = k5(instr, nsteps, nconst, cvals, Xc, ct, ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp, xp, gabs = FE.program_predict_vjp_plain(instr, nsteps, nconst, cvals, Xc, ct, ops,
                                                    return_abs=True)
        torch.cuda.synchronize()
        plain5 = (time.perf_counter() - t0) * 1e3
        check(f"#5 {mode}: two launches bit-identical",
              _same(gk, gk2) and (xk is None or _same(xk, xk2)))
        check(f"#5 {mode}: gcomp NaN and +-inf in the same places",
              nonfinite_match(torch, gk, gp))
        both = torch.isfinite(gabs) & torch.isfinite(gk) & torch.isfinite(gp)
        gerr = (gk - gp).abs()[both]
        gscale = float((gerr / gabs[both].clamp(min=1e-30)).max()) if gerr.numel() else 0.0
        check(f"#5 {mode}: gcomp within 1e-4 of the absolute row sums (worst error over "
              f"that scale {gscale:.3g})", bool((gerr <= 1e-4 * gabs[both]).all()))
        errs5.append(float(gerr.max()) if gerr.numel() else 0.0)
        if per_member:
            good, relx, sclx, absx = tree_close(torch, xk, xp)
            check(f"#5 {mode}: gx NaN and +-inf in the same places, otherwise within rtol "
                  f"{RTOL} or {RTOL} of the tree's largest |gx| (worst relative error "
                  f"{relx:.3g}, worst over the tree's scale {sclx:.3g})", good)
            errs5.append(absx)
        steps = float(nsteps.to(torch.float64).sum())
        nc = float(nconst.to(torch.float64).sum())
        mm = nsteps.to(torch.float64)
        print(f"  {mode} X (F = {F}): {T} trees, mean steps {steps / T:.3f} (m <= 4 "
              f"{int((mm <= 4).sum())}, 5-12 {int(((mm > 4) & (mm <= 12)).sum())}, 13 or more "
              f"{int((mm > 12).sum())}), mean constants "
              f"{nc / T:.3f}, {int(vk.sum())} of {T} valid ({int((ok == 0).sum())} with "
              f"const_ok cleared), {n} rows; {int((~torch.isfinite(pk)).sum())} of {pk.numel()} "
              f"predictions non-finite ({int(torch.isnan(pk).sum())} NaN), "
              f"{int((~torch.isfinite(gk)).sum())} of {gk.numel()} gcomp entries non-finite")
        print(f"  bits #4 {mode}: {digest(pk, vk)}")
        print(f"  bits #5 {mode}: {digest(gk, xk)}")

        if not overflow or per_member:
            ms4 = cuda_ms(torch, lambda: k4(instr, nsteps, cvals, ok, Xc, ops), reps=5)
            ms5 = cuda_ms(torch, lambda: k5(instr, nsteps, nconst, cvals, Xc, ct, ops), reps=5)
            L, CMAX = instr.shape[1], cvals.shape[1]
            xbytes = 4.0 * (T if per_member else 1) * F * n
            # #4: one operation per step and row; inputs once, pred and valid out.
            b4, by4 = bound(steps * n,
                            4.0 * (T * L + 2 * T + T * CMAX) + xbytes + 4.0 * T * (n + 1))
            # #5: the forward's, then per step and row the derivative and one more
            # operation per operand, and the constants' sums; ct in, gcomp (and gx) out.
            b5, by5 = bound((3.0 * steps + nc) * n,
                            4.0 * (T * L + 2 * T + 2 * T * CMAX + T * n) + xbytes
                            + (xbytes if per_member else 0.0))
            # The per-row kernels' times (none for the mixed-step input).
            before = lambda k: was(f"{k.name} {mode}") if f"{k.name} {mode}" in PER_ROW_MS else ""
            print(f"  #4 program_predict: {ms4:.4f} ms{before(k4)} (CUDA events, "
                  f"mean of 5), plain "
                  f"{plain4:.1f} ms, bound {b4:.4f} ms ({by4})")
            print(f"  #5 program_predict_vjp: {ms5:.4f} ms{before(k5)} (CUDA "
                  f"events, mean of 5), plain {plain5:.1f} ms, bound {b5:.4f} ms ({by5})")
            report[mode] = {k4: (ms4, plain4, b4, by4), k5: (ms5, plain5, b5, by5)}
        del pk, pk2, pp, gk, gk2, gp, gabs, xk, xk2, xp, X, ct
        torch.cuda.empty_cache()
    check.raise_if_failed("kernels #4 and #5")

    def row(k, errs):
        """Times of the shared input (the main path's call sites); the
        largest error of all three inputs."""
        ms, plain, b, by = report["shared"][k]
        return {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                "launches": None, "max_abs_err": max(errs), "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": None}

    return [row(k4, errs4), row(k5, errs5)]


def phase_template_main_path(torch, sr, dev):
    """Phase 9: the template cell at full width; kernel #4 only."""
    ncycles = TEMPLATE_CYCLES
    options = template_options(sr, ncycles)
    iters = 2
    launches, state, engine, _ = run_engine(torch, sr, dev, options, iters,
                                            data=template_data())
    expected = expect(launches, program_predict=iters * 3 * (ncycles + 1))
    print(f"  expected {expected}")
    if launches != expected:
        raise RuntimeError(f"template path launched {launches}, expected {expected}")
    # The best member's loss, recomputed on the host from its decoded expression.
    hof = sr.HallOfFame.from_device(state.hof, options.operators, template=engine.template)
    best = min(hof.entries, key=lambda e: e.loss)
    X, y = template_data()
    host = best.template_expr(X, device="cpu").astype(np.float64)
    mse = float(np.mean((host - y) ** 2))
    print(f"  best: loss {best.loss:.6g} at complexity {best.complexity}: "
          f"{best.equation_string()}; host recomputation {mse:.6g}")
    if not abs(mse - best.loss) <= 1e-4 * max(best.loss, 1e-6):
        raise RuntimeError(f"hall of fame loss {best.loss} but the host computes {mse}")
    return launches


def phase_template_optimizer(torch, sr, dev):
    """Phase 10: the template constant optimizer at 64 islands; kernel #5."""
    ncycles = TEMPLATE_OPT_CYCLES
    options = template_options(sr, ncycles, populations=ISLANDS // 8,
                               optimizer_probability=0.14)
    f_calls = []

    def record(engine):
        optimize = engine._optimize

        def recorded(*a, **kw):
            pops, calls = optimize(*a, **kw)
            f_calls.append(float(calls))
            return pops, calls

        engine._optimize = recorded

    iters = 1
    launches, state, engine, evals = run_engine(torch, sr, dev, options, iters,
                                                data=template_data(), on_engine=record)
    passes = options.optimizer_iterations + 1
    expected5 = iters * 3 * passes
    expected4 = iters * 3 * (ncycles + 1 + passes + options.optimizer_iterations)
    print(f"  expected program_predict_vjp {expected5}, program_predict {expected4}")
    if launches != expect(launches, program_predict_vjp=expected5, program_predict=expected4):
        raise RuntimeError(f"template optimizer launched {launches}")
    print(f"  launches in the optimizer: #5 {launches['program_predict_vjp']}, #4 "
          f"{launches['program_predict'] - iters * 3 * (ncycles + 1)}")
    print(f"  optimizer f_calls {sum(f_calls):.0f} of {evals:.0f} evaluations in {iters} "
          f"iteration(s): {sum(f_calls) / evals:.1%}")
    return launches


def phase_template_search(torch, sr, dev):
    """Phase 11: a composition structure through equation_search."""
    X, y = template_data()
    y = (np.cos(1.5 * X[:, 0]) * X[:, 1]).astype(np.float32)
    options = template_options(sr, 20, populations=32, population_size=64,
                               tournament_selection_n=8, optimizer_probability=0.14,
                               combiner=lambda f, g, x1, x2: g(f(x1), x2))
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    before = FE.PROGRAM_PREDICT_VJP.launches
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=options, niterations=2, seed=0, device=dev)
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  g(f(x1), x2) on y = cos(1.5 x1) x2: {time.perf_counter() - t0:.2f} s, best loss "
          f"{best.loss:.6g} at complexity {best.complexity}: {best.equation_string()}")
    if not np.isfinite(best.loss) or FE.PROGRAM_PREDICT_VJP.launches == before:
        raise RuntimeError("the composition search returned no finite loss or ran no #5")


# ---------------------------------------------------------------------------
# Parametric expressions (kernel #1's parametric form) and template
# parameters
# ---------------------------------------------------------------------------


def parametric_data():
    """The JAX package's parametric cell data (bench/cell.py, variant
    "parametric"): 10,000 rows x 2 features from seed 1234 uniform on
    [-2, 2], class = integers(0, 3), y = amp[class] cos(x1) + x2 with
    amp = [1, 2, 3]."""
    rng = np.random.default_rng(1234)
    X = rng.uniform(-2.0, 2.0, (N_ROWS, 2)).astype(np.float32)
    cls = rng.integers(0, 3, N_ROWS)
    y = (np.array([1.0, 2.0, 3.0], np.float32)[cls] * np.cos(X[:, 0]) + X[:, 1]).astype(
        np.float32)
    return X, y, cls


def parametric_options(sr, ncycles: int, populations: int = 0, **kw):
    """bench/cell.py FULL with variant "parametric": max_parameters 1,
    optimizer_probability 0 unless given; ``populations`` 0 means ISLANDS."""
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=30,
                populations=populations or ISLANDS, population_size=256,
                tournament_selection_n=16, ncycles_per_iteration=ncycles,
                optimizer_probability=0.0,
                expression_spec=sr.ParametricExpressionSpec(max_parameters=1),
                save_to_file=False)
    base.update(kw)
    return sr.Options(**base)


def param_kernel_inputs(torch, sr, dev):
    """Kernel #1p's inputs (phases 12 and 16): 16,384 random parametric
    trees (F = 2, NP = 2, NC = 3), 10,000 rows, every fifth tree's const_ok
    cleared, every 97th row's X at +-OVERFLOW, every 11th tree's bank +inf
    for class 2 only."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.population import init_population
    from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.program import compile_program

    F, NP, NC, n = 2, 2, 3, N_ROWS
    options = parametric_options(sr, 1)
    cfg = evolve_config_from_options(options, F, dev, n_params=NP, n_classes=NC)
    T = ISLANDS * 2 * 16      # the cycle's candidates: islands x 2 x ceil(256 / 16)
    trees = init_population(rng.split(rng.key(7, device=dev), 64), T // 64, cfg.mctx,
                            nlength=5).reshape(-1)
    ops, el = options.operators, options.elementwise_loss
    g = torch.Generator(device=dev).manual_seed(12)
    X = torch.rand((F, n), generator=g, device=dev) * 4 - 2
    big = X[:, ::97]
    big.copy_(torch.where(big < 0, -OVERFLOW, OVERFLOW))
    y = torch.randn(n, generator=g, device=dev)
    cls = torch.randint(0, NC, (n,), generator=g, device=dev, dtype=torch.int32)
    bank = torch.randn((T, NP, NC), generator=g, device=dev)
    bank[::11, :, 2] = torch.inf
    prog = compile_program(trees, F, len(ops.binary), n_params=NP)
    instr, nsteps, cvals, ok, Xc, yc, w = FE._launch_inputs(prog, X, y, None, F, ops, NP)
    ok = ok.clone()
    ok[::5] = 0
    return options, trees, X, y, (instr, nsteps, cvals, ok, bank, cls, Xc, yc, w)


def phase_param_kernel(torch, sr, dev):
    """Phase 12: kernel #1's parametric form against its plain version."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.program import compile_program

    F, NP, NC, n = 2, 2, 3, N_ROWS
    options, trees, X, y, args = param_kernel_inputs(torch, sr, dev)
    instr, nsteps, cvals, ok, bank, cls, Xc, yc, w = args
    T = trees.length.shape[0]
    ops, el = options.operators, options.elementwise_loss

    kernel = FE.PROGRAM_EVAL_PARAM
    lk, vk = kernel(*args, ops, el)
    lk2, vk2 = kernel(*args, ops, el)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, vp = FE.program_eval_plain(instr, nsteps, cvals, ok, Xc, yc, w, ops, el, bank=bank,
                                   class_idx=cls)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    check = Checks()
    check("two launches bit-identical", same(torch, lk, lk2) and same(torch, vk, vk2))
    print(f"  bits #1p: {digest(lk, vk)}")
    check("validity bit-equal", same(torch, vk, vp))
    check("loss sums NaN and +-inf in the same places", nonfinite_match(torch, lk, lp))
    same_inf, within, rel, abs_err = close(torch, torch.where(vp, lk, torch.inf),
                                           torch.where(vp, lp, torch.inf))
    check(f"loss sum within rtol {RTOL} on valid trees (max rel err {rel:.3g})", within)
    ms = cuda_ms(torch, lambda: kernel(*args, ops, el), reps=10)

    # #1 (NP = 0) on the same trees: their parameter leaves alias constants.
    prog0 = compile_program(trees, F, len(ops.binary))
    args0 = FE._launch_inputs(prog0, X, y, None, F, ops)
    FE.PROGRAM_EVAL(*args0, ops, el)
    ms0 = cuda_ms(torch, lambda: FE.PROGRAM_EVAL(*args0, ops, el), reps=10)

    L, CMAX = instr.shape[1], cvals.shape[1]
    steps = float(nsteps.to(torch.float64).sum())
    ops_count = steps * n + 4.0 * n * T       # one op per step and row; loss d*d*w + sum
    bytes_moved = 4.0 * (T * L + 3 * T + T * CMAX + T * NP * NC + n + F * n + 2 * n + T)
    bound_ms, bound_by = bound(ops_count, bytes_moved)
    pleaf = ((trees.arity == 0) & (trees.op == 2)
             & (torch.arange(trees.max_nodes, device=dev) < trees.length[:, None])).any(-1)
    print(f"  {T} parametric trees (F = {F}, NP = {NP}, NC = {NC}), {n} rows, L = {L}, "
          f"mean steps {steps / T:.3f}, {int(pleaf.sum())} with parameter leaves; "
          f"{int(vk.sum())} of {T} valid ({int((ok == 0).sum())} with const_ok cleared, "
          f"{int((~torch.isfinite(bank).all(-1).all(-1)).sum())} with a non-finite bank entry)")
    print(f"  #1p program_eval_param: {ms:.4f} ms{was(kernel.name)} (CUDA events, mean of 10), "
          f"plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}: {ops_count:.4g} FP32 ops, "
          f"{bytes_moved:.4g} bytes); #1 (NP = 0, parameter leaves as constants) on the same "
          f"trees {ms0:.4f} ms")
    check.raise_if_failed("kernel #1p")
    return {"name": kernel.name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": None, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def phase_parametric_main_path(torch, sr, dev):
    """Phase 13: the parametric cell at full width; kernel #1p only."""
    ncycles = TEMPLATE_CYCLES
    options = parametric_options(sr, ncycles)
    X, y, cls = parametric_data()
    iters = 2
    launches, state, engine, _ = run_engine(torch, sr, dev, options, iters, data=(X, y),
                                            extra={"class": cls})
    expected = {name: 0 for name in launches}
    expected["program_eval_param"] = iters * (ncycles + 1)
    print(f"  expected {expected}")
    if launches != expected:
        raise RuntimeError(f"parametric path launched {launches}, expected {expected}")
    hof = sr.HallOfFame.from_device(state.hof, options.operators)
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  best: loss {best.loss:.6g} at complexity {best.complexity}: "
          f"{best.equation_string()}, bank {np.array2string(best.params, precision=5)}")
    if best.params is None or best.params.shape != (1, 3):
        raise RuntimeError("the best member carries no (1, 3) parameter bank")
    return launches


def phase_parametric_optimizer(torch, sr, dev):
    """Phase 14: the parametric constant optimizer (eager BFGS over the
    constants and the banks) at 64 islands and 10 cycles, one iteration
    after init (no warm-up: eager code has nothing to compile)."""
    options = parametric_options(sr, TEMPLATE_OPT_CYCLES, populations=ISLANDS // 8,
                                 optimizer_probability=0.14)
    X, y, cls = parametric_data()
    f_calls = []

    def record(engine):
        optimize = engine._optimize

        def recorded(*a, **kw):
            pops, calls = optimize(*a, **kw)
            f_calls.append(float(calls))
            return pops, calls

        engine._optimize = recorded

    iters = 1
    t0 = time.perf_counter()
    launches, _, _, evals = run_engine(torch, sr, dev, options, iters, data=(X, y),
                                       extra={"class": cls}, on_engine=record, warmup=False)
    if launches["program_eval_param"] != iters * (TEMPLATE_OPT_CYCLES + 1) or any(
            v for k, v in launches.items() if k != "program_eval_param"):
        raise RuntimeError(f"parametric optimizer path launched {launches}")
    print(f"  optimizer f_calls {sum(f_calls):.0f} of {evals:.0f} evaluations in {iters} "
          f"iteration(s): {sum(f_calls) / evals:.1%}; phase {time.perf_counter() - t0:.1f} s")


def phase_plugin_searches(torch, sr, dev):
    """Phase 15: a parametric search and a template search with
    parameters through equation_search on the card."""
    from symbolicregression_jl_tpu_torch.models import template_spec
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    # tests/test_parametric.py:60-84: per-class offsets.
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (128, 2)).astype(np.float32)
    cls = rng.integers(0, 3, 128)
    y = (X[:, 0] * 1.5 + np.array([0.5, -1.0, 2.0])[cls]).astype(np.float32)
    o = sr.Options(binary_operators=["+", "*"], unary_operators=[], maxsize=8, populations=2,
                   population_size=12, ncycles_per_iteration=10, tournament_selection_n=4,
                   expression_spec=sr.ParametricExpressionSpec(max_parameters=1),
                   optimizer_probability=0.5, optimizer_iterations=4, save_to_file=False)
    before = FE.PROGRAM_EVAL_PARAM.launches
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=o, niterations=12, seed=0, extra={"class": cls},
                             device=dev)
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  parametric, y = 1.5 x1 + offset[class]: {time.perf_counter() - t0:.2f} s, best "
          f"loss {best.loss:.6g}: {best.equation_string()}, bank "
          f"{np.array2string(best.params, precision=5)}")
    if not best.loss < 0.05 or best.params is None or best.params.shape != (1, 3) \
            or FE.PROGRAM_EVAL_PARAM.launches == before:
        raise RuntimeError("the parametric search missed the test's threshold (loss < 0.05, "
                           "a (1, 3) bank) or ran no #1p")

    # tests/test_template.py:249-276: f(x1) + p[0] x2 + p[1].
    spec = template_spec(expressions=("f",), parameters={"p": 2})(
        lambda f, x1, x2, p: f(x1) + p[0] * x2 + p[1])
    rng = np.random.default_rng(1)
    X = rng.uniform(-2, 2, (200, 2)).astype(np.float32)
    y = (X[:, 0] ** 2 + 3.0 * X[:, 1] - 0.5).astype(np.float32)
    o = sr.Options(binary_operators=["+", "-", "*"], unary_operators=[], maxsize=8,
                   populations=4, population_size=20, ncycles_per_iteration=8,
                   optimizer_probability=0.3, expression_spec=spec, save_to_file=False)
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=o, niterations=8, seed=0, device=dev)
    best = min(hof.entries, key=lambda e: e.loss)
    params = best.template_expr.params
    print(f"  template with parameters, y = x1^2 + 3 x2 - 0.5: {time.perf_counter() - t0:.2f} "
          f"s, best loss {best.loss:.6g}: {best.equation_string()}")
    if not best.loss < 1e-6 or params is None or not np.allclose(sorted(params), [-0.5, 3.0],
                                                                   atol=1e-2):
        raise RuntimeError("the template search with parameters missed the test's thresholds "
                           "(loss < 1e-6, p = [3, -0.5] within 1e-2)")


# ---------------------------------------------------------------------------
# graftstage: bf16 value buffers (kernels 1b and 2b) and staged evaluation
# ---------------------------------------------------------------------------

STAGE_CELLS = ("plain", "plain-staged", "plain-bf16", "plain-staged-bf16")
STAGE_LS_CYCLES = 5                 # phase 18's cut depth (the optimizer runs once per iteration)
BF16_TRANSCENDENTAL_MEDIAN = 1e-4   # kernel vs plain, trees with a transcendental step
BF16_TRANSCENDENTAL_MAX = 1e-2


def inexact_trees(torch, instr, nsteps, operators):
    """[T] bool: a live step applies a unary operator other than abs, whose
    float32 value the kernel and the plain version may round an ULP apart;
    such an ULP can flip one bf16 rounding (2^-8 relative)."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    tab = torch.tensor(FE._optab_list(operators), device=instr.device)
    mask = 0x3F if FE._dispatch_plan(operators).merged else 0x7F
    entry = tab[((instr >> 24) & mask).long()]
    live = torch.arange(instr.shape[1], device=instr.device)[None, :] < nsteps[:, None]
    unary = ((entry >> 8) == FE._K_UNARY) & ((entry & 0xFF) != FE._KERNEL_OP_IDS["abs"])
    return (live & unary).any(dim=1)


def bf16_close(torch, a, b, inexact):
    """Kernel 1b/2b against its plain bf16 version: NaN and +-inf in the
    same places; on trees of exact operators (+ - * / abs) within rtol
    1e-5 (the same stored bf16 bits, rows summed in another order); on the
    others a median relative error below BF16_TRANSCENDENTAL_MEDIAN and
    every one below BF16_TRANSCENDENTAL_MAX. Returns (ok, worst relative
    error on exact trees, median and worst on the others, worst absolute
    error)."""
    if not nonfinite_match(torch, a, b):
        return False, float("inf"), float("inf"), float("inf"), float("inf")
    ex = ~inexact.reshape(inexact.shape + (1,) * (a.dim() - 1)).expand_as(a)
    fin = torch.isfinite(b)
    err = (a - b).abs()
    rel = err / b.abs().clamp(min=1e-30)
    r_ex = rel[fin & ex]
    r_in = rel[fin & ~ex]
    worst_ex = float(r_ex.max()) if r_ex.numel() else 0.0
    med_in = float(r_in.median()) if r_in.numel() else 0.0
    worst_in = float(r_in.max()) if r_in.numel() else 0.0
    ok = (worst_ex <= RTOL and med_in < BF16_TRANSCENDENTAL_MEDIAN
          and worst_in < BF16_TRANSCENDENTAL_MAX)
    return ok, worst_ex, med_in, worst_in, float(err[fin].max()) if fin.any() else 0.0


def rank_contract(torch, f32, b16):
    """tests/test_staged_eval.py's contract of bf16 against f32 on the same
    inputs: finite verdicts agree on 90%, median relative error below 0.02,
    top-quartile overlap at least 75%. Returns (ok, median relative error,
    overlap fraction, finite-agreement fraction)."""
    a, b = f32.double(), b16.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    agree = float((fa == fb).double().mean())
    both = fa & fb
    rel = ((b - a).abs() / (a.abs() + 1e-6))[both]
    med = float(rel.median()) if rel.numel() else 0.0
    k = max(1, int(both.sum()) // 4)
    top_a = set(torch.argsort(torch.where(both, a, torch.inf))[:k].tolist())
    top_b = set(torch.argsort(torch.where(both, b, torch.inf))[:k].tolist())
    overlap = len(top_a & top_b) / k
    return agree >= 0.9 and med < 0.02 and overlap >= 0.75, med, overlap, agree


def phase_bf16_kernels(torch, sr, dev):
    """Phase 16: kernels 1b (cost, plain and parametric forms) and 2b
    against their plain bf16 versions at phases 3, 12 and 4's shapes, and
    against kernels #1/#1p/#2 in float32 on the same inputs (the rank
    contract)."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    check = Checks()
    _same = lambda a, b: same(torch, a, b)
    rows = []

    # 1b, cost and plain forms, on phase 3's inputs.
    options, data, trees, cx, prog, args, scal, cxf = kernel1_inputs(torch, sr, dev)
    ops, el = options.operators, options.elementwise_loss
    argsb = args[:4] + (FE._bf16_rows(args[4]),) + args[5:]
    T = trees.length.shape[0]
    n = N_ROWS
    inexact = inexact_trees(torch, args[0], args[1], ops)
    k1b = FE.PROGRAM_EVAL_BF16
    lk, vk = k1b(*argsb, ops, el)
    lk2, vk2 = k1b(*argsb, ops, el)
    lck, vck, ck = k1b(*argsb, ops, el, cx=cxf, scal=scal)
    lck2, vck2, ck2 = k1b(*argsb, ops, el, cx=cxf, scal=scal)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lcp, vcp, cp = FE.program_eval_plain(*argsb, ops, el, cx=cxf, scal=scal, bf16=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    lp, vp = FE.program_eval_plain(*argsb, ops, el, bf16=True)
    check("1b two launches bit-identical (plain and cost forms)",
          _same(lk, lk2) and _same(vk, vk2) and _same(lck, lck2) and _same(ck, ck2))
    print(f"  bits 1b: {digest(lk, vk, lck, vck, ck)}")
    check("1b validity bit-equal (plain and cost forms)", _same(vk, vp) and _same(vck, vcp))
    errs = []
    for what, a, b in (("plain-form loss sum", torch.where(vp, lk, torch.inf),
                        torch.where(vp, lp, torch.inf)),
                       ("cost-form loss", lck, lcp), ("cost", ck, cp)):
        ok, wex, med, win, aerr = bf16_close(torch, a, b, inexact)
        errs.append(aerr)
        check(f"1b {what}: non-finite in the same places; + - * / abs trees within rtol "
              f"{RTOL} (worst {wex:.3g}); {int(inexact.sum())} transcendental trees median "
              f"{med:.3g} < {BF16_TRANSCENDENTAL_MEDIAN:g}, worst {win:.3g} < "
              f"{BF16_TRANSCENDENTAL_MAX:g}", ok)
    l32, v32, c32 = FE.PROGRAM_EVAL(*args, ops, el, cx=cxf, scal=scal)
    ok, med, overlap, agree = rank_contract(torch, c32, ck)
    check(f"1b rank contract against #1 (cost): finite verdicts agree {agree:.4f} >= 0.9, "
          f"median relative error {med:.3g} < 0.02, top-quartile overlap {overlap:.4f} >= 0.75",
          ok)
    ms = cuda_ms(torch, lambda: k1b(*argsb, ops, el, cx=cxf, scal=scal), reps=10)
    ms32 = cuda_ms(torch, lambda: FE.PROGRAM_EVAL(*args, ops, el, cx=cxf, scal=scal), reps=10)
    L, CMAX = args[0].shape[1], args[2].shape[1]
    step_rows = float(prog.nsteps.to(torch.float64).sum()) * n
    ops_count = step_rows + 4.0 * n * T
    bytes_moved = (4.0 * (T * L + T + T * CMAX + T + 2 * n + T + 3 + 3 * T)
                   + 2.0 * N_FEATURES * n)          # X in bf16
    b1, by1 = bound(ops_count, bytes_moved)
    print(f"  1b program_eval_bf16 (cost form, {T} trees x {n} rows, "
          f"{int(vck.sum())} valid): {ms:.4f} ms{was(k1b.name)} (CUDA events, mean of 10), #1 "
          f"on the same "
          f"inputs {ms32:.4f} ms, plain {plain_ms:.1f} ms, bound {b1:.4f} ms ({by1})")
    rows.append({"name": k1b.name, "route": "cuda", "source": k1b.source,
                 "replaces": k1b.replaces, "launches": None, "max_abs_err": max(errs), "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b1, "bound_by": by1, "library_ms": None})
    del args, argsb
    torch.cuda.empty_cache()

    # 1b, parametric form, on phase 12's inputs.
    poptions, ptrees, X, y, pargs = param_kernel_inputs(torch, sr, dev)
    instr, nsteps, cvals, ok_, bank, cls, Xc, yc, w = pargs
    pops, pel = poptions.operators, poptions.elementwise_loss
    Xb = FE._bf16_rows(Xc)
    kp = FE.PROGRAM_EVAL_PARAM_BF16
    call = lambda: kp(instr, nsteps, cvals, ok_, bank, cls, Xb, yc, w, pops, pel)
    pk, pv = call()
    pk2, pv2 = call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qk, qv = FE.program_eval_plain(instr, nsteps, cvals, ok_, Xb, yc, w, pops, pel, bank=bank,
                                   class_idx=cls, bf16=True)
    torch.cuda.synchronize()
    pplain_ms = (time.perf_counter() - t0) * 1e3
    pin = inexact_trees(torch, instr, nsteps, pops)
    check("1b parametric: two launches bit-identical", _same(pk, pk2) and _same(pv, pv2))
    check("1b parametric: validity bit-equal", _same(pv, qv))
    ok, wex, med, win, perr = bf16_close(torch, torch.where(qv, pk, torch.inf),
                                         torch.where(qv, qk, torch.inf), pin)
    check(f"1b parametric loss sum: + - * trees within rtol {RTOL} (worst {wex:.3g}); "
          f"transcendental trees median {med:.3g}, worst {win:.3g}", ok)
    p32, pv32 = FE.PROGRAM_EVAL_PARAM(*pargs, pops, pel)
    ok, med, overlap, agree = rank_contract(torch, torch.where(pv32, p32, torch.inf),
                                            torch.where(pv, pk, torch.inf))
    check(f"1b parametric rank contract against #1p: agree {agree:.4f}, median {med:.3g}, "
          f"overlap {overlap:.4f}", ok)
    pms = cuda_ms(torch, call, reps=10)
    pms32 = cuda_ms(torch, lambda: FE.PROGRAM_EVAL_PARAM(*pargs, pops, pel), reps=10)
    PT, PL, PC = instr.shape[0], instr.shape[1], cvals.shape[1]
    steps = float(nsteps.to(torch.float64).sum())
    bp, byp = bound(steps * n + 4.0 * n * PT,
                    4.0 * (PT * PL + 3 * PT + PT * PC + PT * 2 * 3 + n + 2 * n + PT)
                    + 2.0 * 2 * n)
    print(f"  1b program_eval_param_bf16 ({PT} trees, {int(pv.sum())} valid): {pms:.4f} ms"
          f"{was(kp.name)} "
          f"(CUDA events, mean of 10), #1p on the same inputs {pms32:.4f} ms, plain "
          f"{pplain_ms:.1f} ms, bound {bp:.4f} ms ({byp})")
    rows.append({"name": kp.name, "route": "cuda", "source": kp.source, "replaces": kp.replaces,
                 "launches": None, "max_abs_err": perr, "ms": pms, "plain_ms": pplain_ms,
                 "bound_ms": bp, "bound_by": byp, "library_ms": None})
    del pargs, Xb
    torch.cuda.empty_cache()

    # 2b on phase 4's inputs.
    (moptions, mtrees, mprog, (instr, nsteps, cvals, _, Xt, yt, w), nconst, R, V_ls, cv_ls,
     _) = opt_kernel_inputs(torch, sr, dev)
    mops, mel = moptions.operators, moptions.elementwise_loss
    Xb = FE._bf16_rows(Xt)
    k2b = FE.PROGRAM_MULTI_BF16
    mk, mv = k2b(instr, nsteps, cv_ls, Xb, yt, w, mops, mel)
    mk2, mv2 = k2b(instr, nsteps, cv_ls, Xb, yt, w, mops, mel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mp, mvp = FE.program_multi_plain(instr, nsteps, cv_ls, Xb, yt, w, mops, mel, bf16=True)
    torch.cuda.synchronize()
    mplain_ms = (time.perf_counter() - t0) * 1e3
    MT = instr.shape[0]
    min_ = inexact_trees(torch, instr, nsteps, mops)
    check("2b two launches bit-identical", _same(mk, mk2) and _same(mv, mv2))
    print(f"  bits 2b: {digest(mk, mv)}")
    check("2b validity bit-equal", _same(mv, mvp))
    ok, wex, med, win, merr = bf16_close(torch, torch.where(mvp, mk, torch.inf),
                                         torch.where(mvp, mp, torch.inf), min_)
    check(f"2b loss sums: + - * / abs trees within rtol {RTOL} (worst {wex:.3g}); "
          f"transcendental trees median {med:.3g}, worst {win:.3g}", ok)
    ones = torch.ones(MT, dtype=torch.int32, device=dev)
    l1, v1 = k2b(instr, nsteps, cvals[:, None, :].contiguous(), Xb, yt, w, mops, mel)
    l1e, v1e = k1b(instr, nsteps, cvals, ones, Xb, yt, w, mops, mel)
    check("2b with V = 1 == 1b's plain form (bit)", _same(l1[:, 0], l1e) and _same(v1[:, 0], v1e))
    m32, mv32 = FE.PROGRAM_MULTI(instr, nsteps, cv_ls, Xt, yt, w, mops, mel)
    ok, med, overlap, agree = rank_contract(
        torch, torch.where(mv32, m32, torch.inf).reshape(-1),
        torch.where(mv, mk, torch.inf).reshape(-1))
    check(f"2b rank contract against #2: agree {agree:.4f}, median {med:.3g}, overlap "
          f"{overlap:.4f}", ok)
    mms = cuda_ms(torch, lambda: k2b(instr, nsteps, cv_ls, Xb, yt, w, mops, mel), reps=5)
    mms32 = cuda_ms(torch, lambda: FE.PROGRAM_MULTI(instr, nsteps, cv_ls, Xt, yt, w, mops, mel),
                    reps=5)
    ML, MC = instr.shape[1], cvals.shape[1]
    msteps = float(nsteps.to(torch.float64).sum())
    b2, by2 = bound((msteps + 4.0 * MT) * V_ls * n,
                    4.0 * (MT * ML + MT + MT * V_ls * MC + 2 * n + 2 * MT * V_ls)
                    + 2.0 * N_FEATURES * n)
    print(f"  2b program_multi_bf16 ({MT} trees x V = {V_ls}, {int(mv.sum())} of {mv.numel()} "
          f"pairs valid): {mms:.4f} ms{was(k2b.name)} (CUDA events, mean of 5), #2 on the same "
          f"inputs "
          f"{mms32:.4f} ms, plain {mplain_ms:.1f} ms, bound {b2:.4f} ms ({by2})")
    rows.append({"name": k2b.name, "route": "cuda", "source": k2b.source,
                 "replaces": k2b.replaces, "launches": None, "max_abs_err": merr, "ms": mms,
                 "plain_ms": mplain_ms, "bound_ms": b2, "bound_by": by2, "library_ms": None})
    check.raise_if_failed("kernels 1b and 2b")
    return rows


def stage_data():
    """The JAX package's plain cell data (bench/cell.py, variant "plain"):
    10,000 rows x 2 features from seed 1234 uniform on [-2, 2],
    y = cos(2.13 x1) + 0.5 x2."""
    rng = np.random.default_rng(1234)
    X = rng.uniform(-2.0, 2.0, (N_ROWS, 2)).astype(np.float32)
    y = (np.cos(2.13 * X[:, 0]) + 0.5 * X[:, 1]).astype(np.float32)
    return X, y


def stage_options(sr, variant: str, ncycles: int, populations: int = 0, **kw):
    """bench/cell.py FULL with one of the plain variants: 512 islands x 256
    members, tournament 16, maxsize 30, + - * and cos, optimizer_probability
    0; staging at the default fraction 0.125 (1,250 sample rows) and
    rescore fraction 0.25."""
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=30,
                populations=populations or ISLANDS, population_size=256,
                tournament_selection_n=16, ncycles_per_iteration=ncycles,
                optimizer_probability=0.0,
                eval_precision="bf16" if variant.endswith("bf16") else "f32",
                staged_eval="staged" in variant, save_to_file=False)
    base.update(kw)
    return sr.Options(**base)


def phase_stage_cells(torch, sr, dev, ncycles: int):
    """Phase 17: the four graftstage cells at full width. Launches per
    iteration exact; after the staged runs every population cost equals an
    unstaged re-eval at the same precision within rtol 1e-5."""
    from symbolicregression_jl_tpu_torch.evolve.step import rescore_count, resolve_sample_rows

    iters = 2
    out = {}
    for variant in STAGE_CELLS:
        print(f"  -- {variant}")
        options = stage_options(sr, variant, ncycles)
        launches, state, engine, _ = run_engine(torch, sr, dev, options, iters,
                                                data=stage_data())
        staged = engine.cfg.staged_eval
        per_iter = (2 if staged else 1) * ncycles + 1
        kernel = "program_eval_bf16" if engine.cfg.eval_bf16 else "program_eval"
        expected = expect(launches, **{kernel: iters * per_iter})
        print(f"  expected {expected}")
        if launches != expected:
            raise RuntimeError(f"{variant} launched {launches}, expected {expected}")
        if staged:
            n_cand = 2 * engine.cfg.n_slots
            print(f"  screen {resolve_sample_rows(engine.cfg, N_ROWS)} of {N_ROWS} rows; "
                  f"rescore {rescore_count(engine.cfg, n_cand)} of up to {n_cand} candidates "
                  f"per island")
            I, P = state.pops.cost.shape
            ds = sr.make_dataset(*stage_data(), device=dev)
            ds.update_baseline_loss(options.elementwise_loss)
            flat = state.pops.trees.reshape(-1)
            params = state.pops.params.reshape(I * P, *state.pops.params.shape[2:])
            cost = state.pops.cost.reshape(-1)
            c_ref, _, _ = engine._eval(flat, params, ds.data, fuse_cost=engine.cfg.fuse_cost)
            fin = torch.isfinite(c_ref)
            good = nonfinite_match(torch, cost, c_ref) and bool(
                ((cost - c_ref).abs()[fin] <= 1e-5 * c_ref.abs()[fin]).all())
            print(f"  population costs == an unstaged re-eval at the same precision (rtol 1e-5; "
                  f"{int(fin.sum())} of {fin.numel()} finite): {'ok' if good else 'FAILED'}")
            if not good:
                raise RuntimeError(f"{variant}: a population cost is not its full-data cost")
        print(f"  hall of fame best loss {best_loss(state):.6g}")
        out[variant] = launches
        del state, engine
        torch.cuda.empty_cache()
    return out


def phase_bf16_line_search(torch, sr, dev, ncycles: int, f32_best: float):
    """Phase 18: phase 5's configuration with the bf16 line search, cut
    depth: 2b once per L-BFGS iteration, #3 once more, #2 never."""
    options = bench_options(sr, ncycles, optimizer_bf16_linesearch=True)
    f_calls = []

    def record(engine):
        if not engine.opt_cfg.ls_bf16:
            raise RuntimeError("the engine on the card did not take the bf16 line search")
        optimize = engine._optimize

        def recorded(*a, **kw):
            pops, calls = optimize(*a, **kw)
            f_calls.append(float(calls))
            return pops, calls

        engine._optimize = recorded

    iters = 2
    launches, state, _, evals = run_engine(torch, sr, dev, options, iters, on_engine=record)
    it = options.optimizer_iterations
    expected = expect(launches, program_eval=iters * (ncycles + 1),
                      program_multi_bf16=iters * it, program_grad=iters * (it + 1))
    print(f"  expected {expected}")
    if launches != expected:
        raise RuntimeError(f"bf16 line search launched {launches}, expected {expected}")
    print(f"  optimizer f_calls {sum(f_calls[-iters:]):.0f} of {evals:.0f} evaluations in "
          f"{iters} iterations: {sum(f_calls[-iters:]) / evals:.1%}")
    print(f"  hall of fame best loss {best_loss(state):.6g} ({ncycles} cycles, bf16 line "
          f"search); phase 5 (float32 line search, its depth) {f32_best:.6g}")
    return launches


def host_predict(torch, node, X64, params=None, cls=None):
    """A decoded tree's predictions in float64 on the host: X64 [n, F]; a
    parameter leaf reads ``params[p, cls[r]]``."""
    if node.degree == 0:
        if node.is_parameter:
            return torch.from_numpy(params[node.parameter][cls].astype(np.float64))
        if node.constant:
            return torch.full((X64.shape[0],), float(node.val), dtype=torch.float64)
        return torch.from_numpy(X64[:, node.feature])
    return node.op.fn(*[host_predict(torch, c, X64, params, cls) for c in node.children])


# The reported loss comes from the bf16 finalize, so it differs from the
# host's float64 loss by the bf16 storage error of the predictions p_b:
# |sqrt(reported) - sqrt(host)| <= RMS(p_b - p) (the triangle inequality in
# L2). A stored value is off by at most 2^-9 relative; allowing 16 such
# roundings through the tree, RMS(p_b - p) <= 2^-5 RMS(y) for the fits a
# search keeps. A broken path (another tree, other rows, a wrong root)
# misses by O(RMS(y)).
BF16_SEARCH_TOL = 2.0 ** -5


def check_host_loss(torch, best, X, y, what, cls=None):
    """Fails where the hall of fame's loss of ``best`` is off its float64
    host recomputation by more than BF16_SEARCH_TOL RMS(y) in root terms."""
    p = host_predict(torch, best.tree, X.astype(np.float64), best.params, cls).numpy()
    host = float(np.mean((p - y.astype(np.float64)) ** 2))
    gap = abs(np.sqrt(best.loss) - np.sqrt(host))
    tol = BF16_SEARCH_TOL * float(np.sqrt(np.mean(y.astype(np.float64) ** 2)))
    print(f"  {what}: reported loss {best.loss:.6g}, host float64 {host:.6g}; "
          f"|sqrt difference| {gap:.3g} <= {tol:.3g}")
    if not gap <= tol:
        raise RuntimeError(f"{what}: reported loss {best.loss} but the host computes {host}")


def phase_stage_search(torch, sr, dev):
    """Phase 19: equation_search with all three graftstage options on the
    plain cell's problem at a small size, and on phase 15's parametric
    problem (kernel 1b's parametric form)."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    X, y = stage_data()
    options = stage_options(sr, "plain-staged-bf16", 30, populations=16, population_size=64,
                            tournament_selection_n=8, optimizer_probability=0.14,
                            optimizer_bf16_linesearch=True)
    for k in kernels():
        k.launches = 0
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=options, niterations=3, seed=0, device=dev)
    launches = {k.name: k.launches for k in kernels()}
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  staged + bf16 + bf16 line search, 16 x 64, {N_ROWS} rows: "
          f"{time.perf_counter() - t0:.2f} s, best loss {best.loss:.6g} at complexity "
          f"{best.complexity}: {best.equation_string()}")
    print(f"  launches {launches}")
    if not (launches["program_eval_bf16"] and launches["program_multi_bf16"]) or \
            launches["program_eval"] or launches["program_multi"]:
        raise RuntimeError("the search did not run on kernels 1b and 2b alone")
    check_host_loss(torch, best, X, y, "plain")

    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (128, 2)).astype(np.float32)
    cls = rng.integers(0, 3, 128)
    y = (X[:, 0] * 1.5 + np.array([0.5, -1.0, 2.0])[cls]).astype(np.float32)
    o = sr.Options(binary_operators=["+", "*"], unary_operators=[], maxsize=8, populations=2,
                   population_size=12, ncycles_per_iteration=10, tournament_selection_n=4,
                   expression_spec=sr.ParametricExpressionSpec(max_parameters=1),
                   optimizer_probability=0.5, optimizer_iterations=4, staged_eval=True,
                   eval_precision="bf16", optimizer_bf16_linesearch=True, save_to_file=False)
    for k in kernels():
        k.launches = 0
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=o, niterations=12, seed=0, extra={"class": cls},
                             device=dev)
    plaunches = {k.name: k.launches for k in kernels()}
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  parametric, staged + bf16, y = 1.5 x1 + offset[class]: "
          f"{time.perf_counter() - t0:.2f} s, best loss {best.loss:.6g}: "
          f"{best.equation_string()}, bank {np.array2string(best.params, precision=5)}")
    print(f"  launches {plaunches}")
    if plaunches != expect(plaunches, program_eval_param_bf16=plaunches[
            "program_eval_param_bf16"]) or not plaunches["program_eval_param_bf16"]:
        raise RuntimeError("the parametric search did not run on kernel 1b's parametric form "
                           "alone")
    if not best.loss < 0.05:
        raise RuntimeError("the parametric search missed phase 15's threshold (loss < 0.05)")
    check_host_loss(torch, best, X, y, "parametric", cls=np.searchsorted(np.unique(cls), cls))
    return launches, plaunches


# ---------------------------------------------------------------------------
# The search API: minibatches, checkpoints and resume, SRRegressor
# ---------------------------------------------------------------------------

BATCH_SIZE = 50             # Options' default batch_size
BATCH_CYCLES = 5            # phases 20-21's cut depth (one optimizer run per iteration whatever it)
CKPT_ITERS = 3              # phase 21: the uninterrupted run's iterations; the killed run stops at 2


class RowRecorder:
    """Wraps the ``__call__`` of kernels #1-#3's wrappers: records the rows
    of every launch on the card and keeps a copy of the first launch's
    arguments at each row count (to replay the path's own inputs against
    the plain versions). ``close`` restores the wrappers."""

    X_ARG = {"program_eval": 4, "program_multi": 3, "program_grad": 4}
    device_type = "cuda"   # the device whose calls are launches

    def __init__(self, torch):
        from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

        self.rows = {name: [] for name in self.X_ARG}
        self.first = {}
        self._saved = {}
        copy = lambda v: v.clone() if torch.is_tensor(v) else v
        for k in (FE.PROGRAM_EVAL, FE.PROGRAM_MULTI, FE.PROGRAM_GRAD):
            cls = type(k)
            if cls in self._saved:
                continue
            orig = cls.__call__
            self._saved[cls] = orig

            def call(wrapper, *args, _orig=orig, **kw):
                at = self.X_ARG.get(wrapper.name)
                if at is not None and args[at].device.type == self.device_type:
                    n = int(args[at].shape[-1])
                    self.rows[wrapper.name].append(n)
                    if (wrapper.name, n) not in self.first:
                        self.first[(wrapper.name, n)] = (
                            [copy(a) for a in args], {k2: copy(v) for k2, v in kw.items()})
                return _orig(wrapper, *args, **kw)

            cls.__call__ = call

    def close(self):
        for cls, orig in self._saved.items():
            cls.__call__ = orig


def eval_bound(torch, args):
    """(bound ms, bound_by) of kernel #1's cost form on ``args`` (phase 3's
    count: one operation per step and row, four for the loss term and sum;
    inputs read once, loss, validity and cost written once)."""
    instr, nsteps, cvals, _, X, _, _ = args[:7]
    T, L = instr.shape
    F, n = X.shape
    CMAX = cvals.shape[1]
    ops_count = float(nsteps.to(torch.float64).sum()) * n + 4.0 * n * T
    bytes_moved = 4.0 * (T * L + T + T * CMAX + T + F * n + 2 * n + T + 3 + 3 * T)
    return bound(ops_count, bytes_moved)


def multi_bound(torch, args):
    """(bound ms, bound_by) of kernel #2 on ``args`` (phase 4's count)."""
    instr, nsteps, cv, X = args[:4]
    T, V, CMAX = cv.shape
    L, n = instr.shape[1], X.shape[1]
    ops2 = (float(nsteps.to(torch.float64).sum()) + 4.0 * T) * V * n
    return bound(ops2, 4.0 * (T * L + T + T * V * CMAX + X.shape[0] * n + 2 * n + 2 * T * V))


def phase_batched_main_path(torch, sr, dev, kernel_rows):
    """Phase 20: phase 5's configuration with minibatches of BATCH_SIZE
    rows, BATCH_CYCLES cycles. Per iteration: #1 once per cycle on the
    batch's rows and once in the finalize on every row, #2 8 times and #3
    9 times on the batch's rows. #1-#3 replayed on the path's own 50-row
    inputs against their plain versions and timed beside phases 3 and 4's
    10,000-row times. The best member of the last finalize's population
    (scored on every row) recomputed on the host in float64."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.encoding import decode_tree

    options = bench_options(sr, BATCH_CYCLES, batching=True, batch_size=BATCH_SIZE)
    recorder = {}
    finalized = []

    def install(engine):
        if not engine.cfg.batching or engine.cfg.batch_size != BATCH_SIZE:
            raise RuntimeError("the engine did not take the minibatch options")
        finalize = engine._finalize_costs

        def kept(pops, data):
            out = finalize(pops, data)
            finalized[:] = [out]
            return out

        engine._finalize_costs = kept
        recorder["r"] = RowRecorder(torch)

    iters = 2
    try:
        launches, _, _, _ = run_engine(torch, sr, dev, options, iters, on_engine=install)
    finally:
        if "r" in recorder:
            recorder["r"].close()
    rec = recorder["r"]
    it = options.optimizer_iterations
    expected = expect(launches, program_eval=iters * (BATCH_CYCLES + 1),
                      program_multi=iters * it, program_grad=iters * (it + 1))
    print(f"  expected {expected}")
    if launches != expected:
        raise RuntimeError(f"batched main path launched {launches}, expected {expected}")
    want_rows = {"program_eval": ([BATCH_SIZE] * BATCH_CYCLES + [N_ROWS]) * iters,
                 "program_multi": [BATCH_SIZE] * (iters * it),
                 "program_grad": [BATCH_SIZE] * (iters * (it + 1))}
    print(f"  rows per launch: #1 {rec.rows['program_eval'][:BATCH_CYCLES + 1]} (each "
          f"iteration), #2 {sorted(set(rec.rows['program_multi']))}, #3 "
          f"{sorted(set(rec.rows['program_grad']))}")
    if rec.rows != want_rows:
        raise RuntimeError(f"batched launches read rows {rec.rows}, expected {want_rows}")

    check = Checks()
    ops, el = options.operators, options.elementwise_loss
    eargs, ekw = rec.first[("program_eval", BATCH_SIZE)]
    T1 = eargs[0].shape[0]
    lk, vk, ck = FE.PROGRAM_EVAL(*eargs, **ekw)
    lk2, vk2, ck2 = FE.PROGRAM_EVAL(*eargs, **ekw)
    lp, vp, cp = FE.program_eval_plain(*eargs, **ekw)
    check("#1 (50 rows) two launches bit-identical", same(torch, lk, lk2)
          and same(torch, vk, vk2) and same(torch, ck, ck2))
    check("#1 (50 rows) validity bit-equal", same(torch, vk, vp))
    same_inf, within, rel1, abs1 = close(torch, lk, lp)
    check(f"#1 (50 rows) loss within rtol {RTOL}, inf in the same places (max rel err "
          f"{rel1:.3g})", same_inf and within)
    same_inf, within, relc, _ = close(torch, ck, cp)
    check(f"#1 (50 rows) cost within rtol {RTOL} (max rel err {relc:.3g})", same_inf and within)
    margs, _ = rec.first[("program_multi", BATCH_SIZE)]
    ml, mv = FE.PROGRAM_MULTI(*margs)
    pl, pv = FE.program_multi_plain(*margs)
    check("#2 (50 rows) validity bit-equal", same(torch, mv, pv))
    same_inf, within, rel2, abs2 = close(torch, torch.where(pv, ml, torch.inf),
                                         torch.where(pv, pl, torch.inf))
    check(f"#2 (50 rows) loss sum within rtol {RTOL} (max rel err {rel2:.3g})",
          same_inf and within)
    gargs, _ = rec.first[("program_grad", BATCH_SIZE)]
    abs3, _, gvalid = grad_checks(torch, check, " (50 rows)", tuple(gargs[:7]), ops, el)
    check.raise_if_failed("kernels #1-#3 on the batched path's inputs")

    ms1 = cuda_ms(torch, lambda: FE.PROGRAM_EVAL(*eargs, **ekw), reps=20)
    ms2 = cuda_ms(torch, lambda: FE.PROGRAM_MULTI(*margs), reps=20)
    ms3 = cuda_ms(torch, lambda: FE.PROGRAM_GRAD(*gargs), reps=20)
    b1, by1 = eval_bound(torch, eargs)
    b2, by2 = multi_bound(torch, margs)
    b3, by3, _, _ = grad_bound(torch, tuple(gargs[:7]))
    full = {r["name"]: r["ms"] for r in kernel_rows}
    T2, V2 = margs[2].shape[:2]
    T3, V3 = gargs[3].shape[:2]
    print(f"  #1 per 50-row launch ({T1} trees, cost form): {ms1:.4f} ms, bound {b1:.4f} ms "
          f"({by1}); phase 3's 10,000-row launch {full['program_eval']:.4f} ms")
    print(f"  #2 per 50-row launch ({T2} trees x V = {V2}): {ms2:.4f} ms, bound {b2:.4f} ms "
          f"({by2}); phase 4's 10,000-row launch {full['program_multi']:.4f} ms")
    print(f"  #3 per 50-row launch ({T3} trees x V = {V3}, {gvalid} pairs valid): {ms3:.4f} ms, "
          f"bound {b3:.4f} ms ({by3}); phase 4's 10,000-row launch "
          f"{full['program_grad']:.4f} ms")
    print(f"  (CUDA events, mean of 20 on the path's own first 50-row inputs; max abs err "
          f"#1 {abs1:.3g}, #2 {abs2:.3g}, #3 {abs3:.3g})")

    # The last finalize's population, scored on every row. (After it, the
    # hall of fame keeps the cycles' best with their batch losses, and
    # migration copies hall-of-fame members into the islands, as in the JAX
    # package.)
    pops = finalized[0]
    flat = pops.loss.reshape(-1)
    i = int(torch.argmin(torch.where(torch.isfinite(flat), flat, torch.inf)))
    P = options.population_size
    fields = [f[i // P, i % P].cpu().numpy() for f in pops.trees.fields()]
    tree = decode_tree(*fields, ops)
    X, y = bench_data()
    p = host_predict(torch, tree, X.astype(np.float64)).numpy()
    host = float(np.mean((p - y.astype(np.float64)) ** 2))
    got = float(flat[i])
    print(f"  the last finalize's best member {sr.string_tree(tree)}: loss {got:.8g} (all "
          f"rows), host float64 {host:.8g}")
    if not abs(got - host) <= RTOL * abs(host):
        raise RuntimeError(f"the finalize's loss {got} is off the host's {host}")
    return launches


def state_tensors(torch, state):
    """The tensors of a SearchDeviceState, in field order."""
    from symbolicregression_jl_tpu_torch.api.checkpoint import map_arrays

    out = []
    map_arrays(state, lambda t: out.append(t) or t)
    return out


def phase_checkpoint_resume(torch, sr, dev, out_base):
    """Phase 21: equation_search at phase 20's configuration without
    minibatches, BATCH_CYCLES cycles, writing CSVs and a checkpoint every
    iteration under ``out_base``: CKPT_ITERS iterations straight through
    against CKPT_ITERS - 1 then resume="auto" to CKPT_ITERS under the same
    run_id; then the newest checkpoint corrupted and the resume repeated
    from the previous one. Every state tensor bit-equal (the device
    evaluation counter restarts at 0 on resume, so the totals are
    compared), the CSVs byte-equal."""
    import filecmp

    from symbolicregression_jl_tpu_torch.api import checkpoint as CK

    X, y = bench_data()
    run = dict(verbosity=0, run_id="smoke", device=dev)
    opts = lambda d: bench_options(sr, BATCH_CYCLES, save_to_file=True,
                                   output_directory=os.path.join(out_base, d))
    ropt = lambda n: sr.RuntimeOptions(niterations=n, checkpoint_every_n=1, seed=0,
                                       verbosity=0, run_id="smoke")
    writes = []
    save = CK.save_search_state

    def timed_save(path, state):
        t0 = time.perf_counter()
        save(path, state)
        writes.append((time.perf_counter() - t0, os.path.getsize(path)))

    CK.save_search_state = timed_save
    from symbolicregression_jl_tpu_torch.shield import checkpoints as shield

    shield.save_search_state = timed_save
    try:
        t0 = time.perf_counter()
        straight, _ = sr.equation_search(X, y, options=opts("straight"),
                                         runtime_options=ropt(CKPT_ITERS), return_state=True,
                                         device=dev)
        t1 = time.perf_counter()
        sr.equation_search(X, y, options=opts("killed"), runtime_options=ropt(CKPT_ITERS - 1),
                           device=dev)
        t2 = time.perf_counter()
        # The seed must not matter: the key comes from the checkpoint.
        resumed, _ = sr.equation_search(X, y, options=opts("killed"), niterations=CKPT_ITERS,
                                        resume="auto", return_state=True, seed=99, **run)
        t3 = time.perf_counter()
    finally:
        CK.save_search_state = save
        shield.save_search_state = save
    print(f"  straight {CKPT_ITERS} iterations {t1 - t0:.2f} s; killed after "
          f"{CKPT_ITERS - 1} {t2 - t1:.2f} s; resumed to {CKPT_ITERS} {t3 - t2:.2f} s")
    secs, sizes = zip(*writes)
    print(f"  {len(writes)} checkpoint writes: {sizes[0]} bytes each "
          f"({sizes[0] / 2**20:.1f} MiB), {min(secs):.3f}-{max(secs):.3f} s a write "
          f"(mean {sum(secs) / len(secs):.3f} s; digest, fsync, read-back, replace)")
    check = Checks()
    base_a = os.path.join(out_base, "straight", "smoke")
    base_b = os.path.join(out_base, "killed", "smoke")

    def compare(tag, state):
        ta, tb = state_tensors(torch, straight.device_states[0]), state_tensors(
            torch, state.device_states[0])
        nev = straight.device_states[0].num_evals
        diff = [k for k, (a, b) in enumerate(zip(ta, tb))
                if a is not nev and not same(torch, a, b)]
        check(f"{tag}: {len(ta) - 1} state tensors bit-equal", len(ta) == len(tb) and not diff)
        check(f"{tag}: iterations_done {state.iterations_done}, total evaluations "
              f"{state.num_evals:.9g} against {straight.num_evals:.9g}",
              state.iterations_done == CKPT_ITERS
              and abs(state.num_evals - straight.num_evals) <= 1e-6 * straight.num_evals)
        check(f"{tag}: hall-of-fame CSVs byte-equal",
              filecmp.cmp(os.path.join(base_a, "hall_of_fame.csv"),
                          os.path.join(base_b, "hall_of_fame.csv"), shallow=False))

    compare("resume", resumed)
    newest = os.path.join(base_b, "search_state.pkl")
    with open(newest, "r+b") as f:
        f.seek(-64, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fallback, _ = sr.equation_search(X, y, options=opts("killed"), niterations=CKPT_ITERS,
                                         resume="auto", return_state=True, seed=99, **run)
    check("corrupt newest checkpoint: resume warned and fell back",
          any("corrupt" in str(w.message) for w in caught))
    compare("resume past the corrupt checkpoint", fallback)
    check.raise_if_failed("checkpoint and resume")


def phase_regressor(torch, sr, dev):
    """Phase 22: SRRegressor with the default device_scale="auto" (512 x
    256, 100 cycles) on phase 5's X with a target the bench operators
    express, seeded with an initial population that holds it; predictions
    on held-out rows against a float64 host evaluation of get_best();
    MultitargetSRRegressor on two targets at 64 islands."""
    X, _ = bench_data()
    truth = "cos(2.13 * x1) + 0.5 * (x2 * abs(x3))"
    f = lambda A: (np.cos(np.float32(2.13) * A[:, 0]) + np.float32(0.5) * (A[:, 1] * np.abs(
        A[:, 2]))).astype(np.float32)
    y = f(X)
    held = np.random.default_rng(1).uniform(-3, 3, (2_000, N_FEATURES)).astype(np.float32)
    kw = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["exp", "abs", "cos"],
              maxsize=30, save_to_file=False)
    t0 = time.perf_counter()
    model = sr.SRRegressor(niterations=2, seed=0, device=dev, **kw)
    model.fit(X, y, initial_population=[truth, "cos(2.13 * x1)", "x2 * abs(x3)", "x1"])
    o = model.options_
    print(f"  SRRegressor: {time.perf_counter() - t0:.2f} s, device-scaled "
          f"{model.device_scaled_} ({o.populations} x {o.population_size}, tournament "
          f"{o.tournament_selection_n}, {o.ncycles_per_iteration} cycles)")
    scale = model._DEVICE_SCALE_CONFIG
    if not model.device_scaled_ or o.populations != scale["populations"] \
            or o.population_size != scale["population_size"]:
        raise RuntimeError("SRRegressor did not take the device scale on the card")
    best = model.get_best()
    print(f"  best: complexity {best.complexity}, loss {best.loss:.6g}: {best.equation}")
    pred = model.predict(held)
    host = host_predict(torch, best.tree, held.astype(np.float64)).numpy()
    atol = 1e-5 * float(np.sqrt(np.mean(host ** 2)))
    err = np.abs(pred - host)
    print(f"  predict on {held.shape[0]} held-out rows: max |err| {err.max():.3g} against "
          f"rtol 1e-5 or 1e-5 of the predictions' RMS ({atol:.3g}); R^2 on them "
          f"{model.score(held, f(held)):.6f}")
    if not np.all((err <= 1e-5 * np.abs(host)) | (err <= atol)):
        raise RuntimeError("SRRegressor.predict disagrees with the host evaluation")
    t0 = time.perf_counter()
    multi = sr.MultitargetSRRegressor(niterations=2, seed=0, device=dev, populations=64,
                                      population_size=256, tournament_selection_n=16,
                                      ncycles_per_iteration=BATCH_CYCLES, **kw)
    multi.fit(X, np.stack([y, X[:, 0] * X[:, 1]], axis=1))
    eqs = multi.get_best()
    print(f"  MultitargetSRRegressor (64 x 256, {BATCH_CYCLES} cycles): "
          f"{time.perf_counter() - t0:.2f} s; " + "; ".join(
              f"output {j + 1}: loss {e.loss:.6g}, {e.equation}" for j, e in enumerate(eqs)))
    if len(eqs) != 2 or multi.predict(held).shape != (held.shape[0], 2):
        raise RuntimeError("MultitargetSRRegressor did not return two equations")


# ---------------------------------------------------------------------------
# Observability: telemetry at full width, the mini matrix's quality, a stop
# between chunks (phases 23-25)
# ---------------------------------------------------------------------------

TELEM_CYCLES = 3            # phase 23's cut depth (one optimizer run per iteration whatever it)
TELEM_ITERS = 2
QUALITY_SEEDS = (0, 1)
QUALITY_KERNEL = {"plain": "program_eval", "plain-staged": "program_eval",
                  "plain-bf16": "program_eval_bf16", "plain-staged-bf16": "program_eval_bf16",
                  "parametric": "program_eval_param", "template": "program_predict"}


class TreeRecorder:
    """Wraps the ``__call__`` of kernel #1's wrapper: records (trees, rows)
    of every call that launches it (tensors on ``device_type``), for the
    counters' identities. ``close`` restores the wrapper."""

    device_type = "cuda"   # the device whose calls are launches

    def __init__(self):
        from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

        self.calls = []
        self._cls = type(FE.PROGRAM_EVAL)
        self._orig = orig = self._cls.__call__

        def call(wrapper, *args, **kw):
            if wrapper.name == "program_eval" and args[4].device.type == self.device_type:
                self.calls.append((int(args[0].shape[0]), int(args[4].shape[-1])))
            return orig(wrapper, *args, **kw)

        self._cls.__call__ = call

    def close(self):
        self._cls.__call__ = self._orig


def telemetry_search(torch, sr, dev, options, data, out_base, run_id, count_syncs=False,
                     recorder=None):
    """equation_search(niterations=TELEM_ITERS) with a stop hook that marks
    each iteration's end (it runs once per iteration, at the boundary):
    the host clock, the sync warnings seen so far (under
    torch.cuda.set_sync_debug_mode("warn") when ``count_syncs``; a warning
    costs microseconds, against seconds an iteration) and the recorder's
    calls so far. Returns (state, marks, syncs per iteration after the
    first)."""
    import warnings

    X, y = data
    marks = []
    caught = []

    def syncs_seen():
        return sum("synchroniz" in str(w.message) for w in caught)

    def hook():
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), syncs_seen(),
                      len(recorder.calls) if recorder is not None else 0))
        return None

    ropt = sr.RuntimeOptions(niterations=TELEM_ITERS, seed=0, verbosity=0, run_id=run_id,
                             stop_hook=hook)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        caught = got
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), 0, len(recorder.calls) if recorder else 0))
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = sr.equation_search(X, y, options=options, runtime_options=ropt,
                                          return_state=True, device=dev)
        finally:
            if count_syncs:
                torch.cuda.set_sync_debug_mode(0)
    syncs = [b[1] - a[1] for a, b in zip(marks[1:], marks[2:])] if count_syncs else None
    return state, marks, syncs


def core_events(events):
    """A run's telemetry records without graftgauge's ``gauge`` records,
    which every search with a telemetry stream writes by default (a memory
    sample each iteration, the watermarks and the dispatch latency at the
    end)."""
    return [e for e in events if e["event"] != "gauge"]


def calls_by_iteration(check, tag, calls, marks, r0, n_members):
    """Kernel #1's calls split at the iterations' ends; the first call is
    init_state's scoring of the initial population (every member, every
    row), which precedes iteration 1."""
    bounds = [m[2] - r0 for m in marks]
    per = [calls[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    check(f"{tag}: the first call of #1 is init_state's ({calls[0][0]} trees)",
          calls[0] == (n_members, N_ROWS))
    per[0] = per[0][1:]
    return per


def check_counter_identities(check, tag, events, calls_by_iter, I, P, n_rows, staged):
    """The identities between the JSONL counters (the JAX package's
    meaning: per island in the cycles, plus the finalize's rows and launch)
    and kernel #1's calls in each iteration: W calls, the last the
    finalize (n_rows rows); the cycles' calls each cover every island."""
    for k, (ev, calls) in enumerate(zip(events, calls_by_iter), start=1):
        c = ev["outputs"][0]["counters"]
        W = len(calls)
        fin_trees, fin_rows = calls[-1]
        cyc = calls[:-1]
        check(f"{tag} iteration {k}: eval_launches {c['eval_launches']} == I (W - 1) + 1 = "
              f"{I} x ({W} - 1) + 1", c["eval_launches"] == I * (W - 1) + 1
              and fin_rows == n_rows)
        if staged:
            screen = [t for t, r in cyc if r < n_rows]
            rescore = [t for t, r in cyc if r == n_rows]
            check(f"{tag} iteration {k}: screen_launches {c['screen_launches']} == I x "
                  f"{len(screen)}, rescore_launches {c['rescore_launches']} == I x "
                  f"{len(rescore)}", c["screen_launches"] == I * len(screen)
                  and c["rescore_launches"] == I * len(rescore) and len(screen) == len(rescore))
            check(f"{tag} iteration {k}: screen_rows {c['screen_rows']} == sum of the screen "
                  f"launches' trees {sum(screen)}; rescore_rows {c['rescore_rows']} == "
                  f"{sum(rescore)}; eval_rows {c['eval_rows']} == screen_rows + I P",
                  c["screen_rows"] == sum(screen) and c["rescore_rows"] == sum(rescore)
                  and c["eval_rows"] == sum(screen) + I * P)
        else:
            check(f"{tag} iteration {k}: eval_rows {c['eval_rows']} == the cycle launches' "
                  f"trees {sum(t for t, _ in cyc)} + I P ({I * P})",
                  c["eval_rows"] == sum(t for t, _ in cyc) + I * P
                  and c["screen_rows"] == c["rescore_rows"] == 0)
        check(f"{tag} iteration {k}: finalize_rows {c['dedup']['rows']} == I P; "
              f"finalize_unique {c['dedup']['unique']} (post-migration population) beside the "
              f"dedup'd finalize launch's {fin_trees} trees (pre-migration)",
              c["dedup"]["rows"] == I * P and 1 <= c["dedup"]["unique"] <= I * P)


def phase_telemetry(torch, sr, dev, out_base, card):
    """Phase 23: the optimizer cell (TELEM_CYCLES cycles, TELEM_ITERS
    iterations) through equation_search with telemetry on and off in turns
    (off, on, on, off): bit-identical states and halls of fame; the JSONL
    valid with run_start, TELEM_ITERS x iteration, run_end; the counters'
    identities with kernel #1's calls; equal host syncs per iteration on
    and off (set_sync_debug_mode("warn")); s/iteration on and off; the
    sr:* spans of one torch.profiler capture of an iteration; then the
    plain-staged cell with its screen and rescore counters."""
    import dataclasses

    from symbolicregression_jl_tpu_torch.telemetry.schema import load_events

    check = Checks()
    X, y = bench_data()
    tfile = lambda rid: os.path.join(out_base, f"{rid}.jsonl")
    opts = lambda on, rid: bench_options(sr, TELEM_CYCLES, telemetry=on, use_recorder=False,
                                         telemetry_file=tfile(rid))
    I, P = opts(False, "shape").populations, opts(False, "shape").population_size
    states, per_iter, sync_counts = {}, {"on": [], "off": []}, {"on": [], "off": []}
    rec = TreeRecorder()
    try:
        runs = {}
        for i, mode in enumerate(("off", "on", "on", "off")):
            rid = f"telem_{mode}_{i}"
            r0 = len(rec.calls)
            state, marks, syncs = telemetry_search(torch, sr, dev, opts(mode == "on", rid),
                                                   (X, y), out_base, rid, count_syncs=True,
                                                   recorder=rec)
            states[rid] = state
            sync_counts[mode].append(syncs)
            its = [b[0] - a[0] for a, b in zip(marks[:-1], marks[1:])]
            per_iter[mode].append(sum(its[1:]) / len(its[1:]))
            runs[rid] = calls_by_iteration(check, rid, rec.calls[r0:], marks, r0, I * P)
            print(f"  {mode}: s/iteration {', '.join(f'{t:.3f}' for t in its)} (the first "
                  f"includes init)")
    finally:
        rec.close()
    ref = state_tensors(torch, states["telem_off_0"].device_states[0])
    for rid, st in states.items():
        t = state_tensors(torch, dataclasses.replace(st.device_states[0], telem=None))
        hof_same = [e.equation_string() for e in st.hofs[0].entries] == [
            e.equation_string() for e in states["telem_off_0"].hofs[0].entries]
        check(f"{rid}: every state tensor bit-equal to the first off run's, hall of fame equal",
              len(t) == len(ref) and all(same(torch, a, b) for a, b in zip(t, ref)) and hof_same)
    check(f"host syncs per iteration (iterations 2-{TELEM_ITERS}) equal with telemetry on "
          f"{sync_counts['on']} and off {sync_counts['off']}",
          len({tuple(c) for c in sync_counts["on"] + sync_counts["off"]}) == 1
          and len(sync_counts["on"][0]) == TELEM_ITERS - 1)
    mean = lambda v: sum(v) / len(v)
    print(f"  {card}: s/iteration (iterations 2-{TELEM_ITERS}, in turns off, on, on, off) "
          f"off {per_iter['off'][0]:.4f} / {per_iter['off'][1]:.4f}, on {per_iter['on'][0]:.4f}"
          f" / {per_iter['on'][1]:.4f}: on / off {mean(per_iter['on']) / mean(per_iter['off']):.4f}")
    for rid in ("telem_on_1", "telem_on_2"):
        events = core_events(load_events(tfile(rid)))
        check(f"{rid}: JSONL valid, events run_start, {TELEM_ITERS} x iteration, run_end",
              [e["event"] for e in events] == ["run_start"] + ["iteration"] * TELEM_ITERS
              + ["run_end"])
        iters = events[1:-1]
        check_counter_identities(check, rid, iters, runs[rid], I, P, N_ROWS, staged=False)
        print(f"  {rid}: host_fraction {[round(e['host_fraction'], 4) for e in iters]}, "
              f"recompiles {[e['recompiles'] for e in iters]}, finalize unique "
              f"{[e['outputs'][0]['counters']['dedup']['unique'] for e in iters]} of {I * P}, "
              f"the finalize launch's trees {[c[-1][0] for c in runs[rid]]}")
    c = core_events(load_events(tfile("telem_on_1")))[1]["outputs"][0]["counters"]
    print(f"  iteration 1's counters: {json.dumps(c)}")

    # One torch.profiler capture of a one-iteration search: its sr:* ranges.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sr.equation_search(X, y, options=opts(True, "prof"), niterations=1, seed=0, verbosity=0,
                           device=dev)
        torch.cuda.synchronize()
    spans = sorted({e.key for e in prof.key_averages() if e.key.startswith("sr:")})
    print(f"  sr:* spans in one torch.profiler capture of an iteration: {spans}")
    check("the capture shows sr:iteration, sr:host:hof_decode, sr:host:checkpoint, "
          "sr:host:sinks and sr:constant_optimizer",
          {"sr:iteration", "sr:host:hof_decode", "sr:host:checkpoint", "sr:host:sinks",
           "sr:constant_optimizer"} <= set(spans))

    # The plain-staged cell: the screen and rescore counters.
    rec = TreeRecorder()
    try:
        staged = {}
        for on in (True, False):
            rid = f"staged_{'on' if on else 'off'}"
            r0 = len(rec.calls)
            o = stage_options(sr, "plain-staged", TELEM_CYCLES, telemetry=on,
                              telemetry_file=tfile(rid))
            st, marks, _ = telemetry_search(torch, sr, dev, o, stage_data(), out_base, rid,
                                            recorder=rec)
            staged[rid] = (st, calls_by_iteration(check, rid, rec.calls[r0:], marks, r0, I * P))
    finally:
        rec.close()
    ta = state_tensors(torch, dataclasses.replace(staged["staged_on"][0].device_states[0],
                                                  telem=None))
    tb = state_tensors(torch, staged["staged_off"][0].device_states[0])
    check("plain-staged: every state tensor bit-equal with telemetry on and off",
          len(ta) == len(tb) and all(same(torch, a, b) for a, b in zip(ta, tb)))
    events = core_events(load_events(tfile("staged_on")))
    check_counter_identities(check, "plain-staged", events[1:-1], staged["staged_on"][1], I, P,
                             N_ROWS, staged=True)
    c = events[1]["outputs"][0]["counters"]
    print(f"  plain-staged iteration 1: screen_rows {c['screen_rows']}, rescore_rows "
          f"{c['rescore_rows']} (observed fraction {c['rescore_rows'] / c['screen_rows']:.4f}), "
          f"screen/rescore launches {c['screen_launches']}/{c['rescore_launches']}, eval_rows "
          f"{c['eval_rows']}, eval_launches {c['eval_launches']}")
    check.raise_if_failed("telemetry at full width")


def phase_quality(torch, sr, dev, out_base):
    """Phase 24: the 12 non-sharded cells of benchmarks/baseline.json (6
    variants x seeds 0 and 1, MINI shapes) through the port's bench/cell.py
    on the card, each on its kernel (launch counters), gated by the port's
    bench/gate.py under the library-drift rule."""
    from symbolicregression_jl_tpu_torch.bench import cell as C
    from symbolicregression_jl_tpu_torch.bench import gate as G

    check = Checks()
    baseline = G.load_baseline(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                            "benchmarks", "baseline.json"))
    recs = []
    t0 = time.perf_counter()
    for variant in QUALITY_KERNEL:
        for seed in QUALITY_SEEDS:
            cid = f"{variant}/seed{seed}"
            for k in kernels():
                k.launches = 0
            r = C.run_cell({"variant": variant, "seed": seed, "shape": C.MINI, "cell_id": cid,
                            "out_dir": os.path.join(out_base, "matrix")}, device=dev)
            launched = {k.name: k.launches for k in kernels() if k.launches}
            kname = QUALITY_KERNEL[variant]
            check(f"{cid} ran on {kname}: launches {launched}", launched.get(kname, 0) > 0)
            b = baseline["cells"][cid]["metrics"]
            m = r["metrics"]
            print(f"  {cid}: best_loss {m['best_loss']:.6g} (baseline {b['best_loss']:.6g}), "
                  f"pareto_volume {m['pareto_volume']:.6g} (baseline {b['pareto_volume']:.6g}), "
                  f"{r['wall_s']:.2f} s")
            recs.append(r)
    print(f"  12 cells in {time.perf_counter() - t0:.1f} s")
    result = G.make_result(recs, matrix="mini", platform="gpu")
    findings = G.diff_result(result, baseline, cells_filter=[r["cell_id"] for r in recs])
    for line in G.format_findings(findings).splitlines():
        print(f"  {line}")
    check("the 12 cells pass the quality rule (backstops hard, band excursions soft)",
          not G.gate_failed(findings))
    check.raise_if_failed("the mini matrix's quality")
    return findings


STOP_CYCLES = 40            # phase 25's cut depth (four chunks of 10)


def phase_stop_between_chunks(torch, sr, dev, out_base):
    """Phase 25: the optimizer cell at STOP_CYCLES cycles. A single-chunk
    iteration (timed: the measured iteration) and a chunked one (four
    equal chunks, no stop) from the same state, bit-identical; then
    equation_search with timeout_in_seconds at a quarter of the measured
    iteration: it stops within the first iteration (after its epilogue),
    and the counters say how many of the cycles ran. Prints the
    overshoot."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.engine import Engine
    from symbolicregression_jl_tpu_torch.telemetry.schema import load_events

    check = Checks()
    ncycles = STOP_CYCLES
    X, y = bench_data()
    options = bench_options(sr, ncycles)
    ds = sr.make_dataset(X, y, device=dev)
    ds.update_baseline_loss(options.elementwise_loss)
    engine = Engine(options, X.shape[1], device=dev)
    s0 = engine.init_state(rng.key(0, device=dev), ds.data, options.populations)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = engine.run_iteration(s0, ds.data, options.maxsize)
    torch.cuda.synchronize()
    t_iter = time.perf_counter() - t0
    polls = []

    def poll(pending):
        polls.append(1)
        return False

    t0 = time.perf_counter()
    chunked = engine.run_iteration(s0, ds.data, options.maxsize,
                                   chunk_sizes=[ncycles // 4] * 4, should_stop=poll)
    torch.cuda.synchronize()
    t_chunked = time.perf_counter() - t0
    ta, tb = state_tensors(torch, one), state_tensors(torch, chunked)
    check(f"chunked ([{ncycles // 4}] x 4, {len(polls)} polls) and single-chunk "
          f"{ncycles}-cycle iterations "
          f"bit-identical", len(ta) == len(tb) and all(same(torch, a, b) for a, b in zip(ta, tb))
          and len(polls) == 3)
    print(f"  one {ncycles}-cycle iteration {t_iter:.3f} s; chunked {t_chunked:.3f} s")
    del one, chunked, s0
    timeout = t_iter / 4
    path = os.path.join(out_base, "stop.jsonl")
    o = bench_options(sr, ncycles, timeout_in_seconds=timeout, telemetry=True,
                      telemetry_file=path)
    t0 = time.perf_counter()
    state, _ = sr.equation_search(X, y, options=o, niterations=10, seed=0, verbosity=0,
                                  return_state=True, device=dev)
    wall = time.perf_counter() - t0
    events = core_events(load_events(path))
    end = events[-1]
    c = events[1]["outputs"][0]["counters"]
    cycles_run = (c["eval_launches"] - 1) // options.populations
    print(f"  timeout {timeout:.3f} s: stopped '{end['stop_reason']}' after "
          f"{state.iterations_done} iteration(s), {cycles_run} of {ncycles} cycles; "
          f"search elapsed {end['elapsed_s']:.3f} s (overshoot {end['elapsed_s'] - timeout:.3f} "
          f"s; a whole iteration would be {t_iter - timeout:.3f} s), call {wall:.3f} s")
    check("the timeout stopped the search within its first iteration, after the epilogue",
          end["stop_reason"] == "timeout" and state.iterations_done == 1
          and cycles_run < ncycles
          and c["dedup"]["rows"] == options.populations * options.population_size)
    check.raise_if_failed("a stop between chunks")


# ---------------------------------------------------------------------------
# Phases 26-28: every library loss and the float64 forms on kernels #1-#3,
# the logcosh and float64 searches, the headline bench
# ---------------------------------------------------------------------------

RTOL64 = 1e-9               # float64 kernels against their float64 plain versions
H100_FP64_FLOPS = 34e12     # non-tensor-core FP64 peak, H100 SXM data sheet
LOSS_SUBSET = 512           # trees of #1, #1p and 1b held against the plain version per kind
LOSS_SUBSET_MULTI = 64      # trees of #2, 2b and #3 likewise
LOSS_CYCLES = 3             # phase 27's cut depth (one optimizer run per iteration whatever it)
# Operations of each loss kind's formula per row (csrc/interp.cuh
# loss_of_kind), the weight and the row sum included.
LOSS_OPS = {0: 4, 1: 4, 2: 7, 3: 12, 4: 14, 5: 11, 6: 9}


def loss_cases():
    """(name, loss) of every library loss besides L2 and each factory at
    two parameters (core/losses.py KernelLoss)."""
    from symbolicregression_jl_tpu_torch.core import losses as L

    return [("L1DistLoss", L.l1_dist_loss), ("huber_loss(0.5)", L.huber_loss(0.5)),
            ("huber_loss(1)", L.LOSS_REGISTRY["huber"]), ("huber_loss(2)", L.huber_loss(2.0)),
            ("logcosh", L.log_cosh_loss), ("LogitDistLoss", L.logit_dist_loss),
            ("sigmoid_cross_entropy_loss", L.sigmoid_cross_entropy_loss),
            ("periodic_l2_loss(2 pi)", L.periodic_l2_loss()),
            ("periodic_l2_loss(1)", L.periodic_l2_loss(1.0))]


SIGMOID_CE = 5   # core/losses.py LOSS_SIGMOID_CE


def binary_targets(torch, groups, ys):
    """Phase 26's argument tuples ``groups`` with each target of ``ys``
    replaced by 0/1 (y above its median): sigmoid cross-entropy takes a
    logit and a class. With real-valued targets max(p, 0) - p y cancels
    within a row, and an ULP of log1p(exp(-|p|)) is then more of the row's
    value than rtol allows."""
    to01 = {id(y): (y > y.median()).to(y.dtype).contiguous() for y in ys}
    return tuple(tuple(to01.get(id(a), a) for a in g) for g in groups)


def bound64(ops_count: float, bytes_moved: float):
    """(bound ms, bound_by) of a float64 kernel: FP64 operations at 34
    TFLOP/s or bytes at 3.35 TB/s, whichever is larger."""
    bound_ops = ops_count / H100_FP64_FLOPS * 1e3
    bound_bytes = bytes_moved / H100_HBM_BYTES_S * 1e3
    return max(bound_ops, bound_bytes), "operations" if bound_ops >= bound_bytes else "bytes"


def close_at(torch, a, b, rtol):
    """``close`` at another tolerance: (same non-finite places, within
    rtol, max rel err, max abs err)."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    same_inf = nonfinite_match(torch, a, b)
    if not same_inf:
        return False, False, float("inf"), float("inf")
    err = (a[fa] - b[fb]).abs()
    if not err.numel():
        return True, True, 0.0, 0.0
    rel = float((err / b[fb].abs().clamp(min=1e-300)).max())
    return True, bool((err <= rtol * b[fb].abs()).all()), rel, float(err.max())


def head(args, k: int, idx):
    """``args`` with the tensors at positions ``idx`` cut to their first
    ``k`` trees (contiguous)."""
    return tuple(a[:k].contiguous() if i in idx else a for i, a in enumerate(args))


def grad_close(torch, check, tag, kernel_out, plain_out, rtol):
    """Kernel #3 (or its float64 form) against its plain version: validity
    bit-equal, loss sums within rtol on valid pairs, gradients non-finite
    in the same places and otherwise within rtol of the sum of the
    absolute per-row terms. Returns the largest gradient error."""
    gl, gv, gg = kernel_out
    pl, pv, pg, pabs = plain_out
    check(f"{tag} validity bit-equal", same(torch, gv, pv))
    same_inf, within, rel, _ = close_at(torch, torch.where(pv, gl, torch.inf),
                                        torch.where(pv, pl, torch.inf), rtol)
    check(f"{tag} loss sum within rtol {rtol:g} (max rel err {rel:.3g})", same_inf and within)
    live = pv[..., None].expand_as(pg)
    fin_k, fin_p = torch.isfinite(gg), torch.isfinite(pg)
    check(f"{tag} gradients non-finite in the same places",
          bool(torch.equal(fin_k[live], fin_p[live])))
    both = live & fin_k & fin_p
    gerr = (gg - pg).abs()[both]
    ratio = float((gerr / pabs[both].clamp(min=1e-300)).max()) if gerr.numel() else 0.0
    check(f"{tag} gradients within {rtol:g} of the absolute row sums (max err / scale "
          f"{ratio:.3g})", bool((gerr <= rtol * pabs[both]).all()))
    return float(gerr.max()) if gerr.numel() else 0.0


def phase_loss_kernels(torch, sr, dev):
    """Phase 26: every library loss besides L2 on kernels #1 (cost form),
    #1p, 1b, #2, 2b and #3 against their plain versions (the first
    LOSS_SUBSET or LOSS_SUBSET_MULTI trees of phases 3, 12 and 4's inputs),
    each timed at the full shapes; then the float64 forms of #1, #1p, #2
    and #3 against their float64 plain versions at the full shapes, every
    kind on the subsets. Returns the kernel-table rows of the float64 forms
    and of #1-#3 with logcosh."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    check = Checks()
    rows = []
    options, data, trees, cx, prog, args, scal, cxf = kernel1_inputs(torch, sr, dev)
    ops = options.operators
    T, n = trees.length.shape[0], N_ROWS
    L, CMAX = args[0].shape[1], args[2].shape[1]
    K1 = LOSS_SUBSET
    a1 = head(args, K1, (0, 1, 2, 3))
    cx1 = cxf[:K1].contiguous()
    inexact1 = inexact_trees(torch, a1[0], a1[1], ops)
    a1b = a1[:4] + (FE._bf16_rows(a1[4]),) + a1[5:]
    popts, _, _, _, pargs = param_kernel_inputs(torch, sr, dev)
    pops = popts.operators
    ap = head(pargs, K1, (0, 1, 2, 3, 4))
    (oopts, otrees, oprog, (oinstr, onsteps, ocvals, _, oXt, oyt, ow), onconst, R, V_ls,
     cv_ls, cv_g) = opt_kernel_inputs(torch, sr, dev)
    K2 = LOSS_SUBSET_MULTI
    a2 = (oinstr[:K2].contiguous(), onsteps[:K2].contiguous(), cv_ls[:K2].contiguous(), oXt,
          oyt, ow)
    a3 = (oinstr[:K2].contiguous(), onsteps[:K2].contiguous(), onconst[:K2].contiguous(),
          cv_g[:K2].contiguous(), oXt, oyt, ow)
    inexact2 = inexact_trees(torch, a2[0], a2[1], ops)
    a2b = a2[:3] + (FE._bf16_rows(oXt),) + a2[4:]
    g3full = (oinstr, onsteps, onconst, cv_g, oXt, oyt, ow)
    steps1 = float(prog.nsteps.to(torch.float64).sum())
    steps2 = float(onsteps.to(torch.float64).sum())
    To = oinstr.shape[0]

    print(f"  {len(loss_cases())} kinds; #1, #1p and 1b on the first {K1} of {T} trees, #2, 2b "
          f"and #3 on the first {K2} of {To} trees (V = {V_ls} and {R}) against their plain "
          f"versions; times at the full shapes (CUDA events)")
    base = (args, a1, a1b, ap, a2, a2b, a3, g3full, (oinstr, onsteps, cv_ls, oXt, oyt, ow))
    for name, el in loss_cases():
        tag = f"{name}:"
        (args, a1, a1b, ap, a2, a2b, a3, g3full, m_full) = (
            binary_targets(torch, base, (args[5], pargs[7], oyt)) if el.kind == SIGMOID_CE
            else base)
        lk, vk, ck = FE.PROGRAM_EVAL(*a1, ops, el, cx=cx1, scal=scal)
        lp, vp, cp = FE.program_eval_plain(*a1, ops, el, cx=cx1, scal=scal)
        check(f"{tag} #1 validity bit-equal", same(torch, vk, vp))
        s1, w1, r1, _ = close(torch, lk, lp)
        s2, w2, r2, _ = close(torch, ck, cp)
        check(f"{tag} #1 loss and cost within rtol {RTOL}, inf in the same places (max rel "
              f"err {max(r1, r2):.3g})", s1 and w1 and s2 and w2)
        lk, vk = FE.PROGRAM_EVAL_PARAM(*ap, pops, el)
        lp, vp = FE.program_eval_plain(*ap[:4], *ap[6:], pops, el, bank=ap[4], class_idx=ap[5])
        s1, w1, r1, _ = close(torch, torch.where(vp, lk, torch.inf), torch.where(vp, lp, torch.inf))
        check(f"{tag} #1p validity bit-equal, loss sums within rtol {RTOL} (max rel err "
              f"{r1:.3g})", same(torch, vk, vp) and s1 and w1)
        lk, vk, ck = FE.PROGRAM_EVAL_BF16(*a1b, ops, el, cx=cx1, scal=scal)
        lp, vp, cp = FE.program_eval_plain(*a1b, ops, el, cx=cx1, scal=scal, bf16=True)
        ok, wex, med, win, _ = bf16_close(torch, ck, cp, inexact1)
        check(f"{tag} 1b validity bit-equal, cost by the bf16 rule (exact trees {wex:.3g}, "
              f"median {med:.3g}, worst {win:.3g})", same(torch, vk, vp) and ok)
        lk, vk = FE.PROGRAM_MULTI(*a2, ops, el)
        lp, vp = FE.program_multi_plain(*a2, ops, el)
        s1, w1, r1, _ = close(torch, torch.where(vp, lk, torch.inf), torch.where(vp, lp, torch.inf))
        check(f"{tag} #2 validity bit-equal, loss sums within rtol {RTOL} (max rel err "
              f"{r1:.3g})", same(torch, vk, vp) and s1 and w1)
        lk, vk = FE.PROGRAM_MULTI_BF16(*a2b, ops, el)
        lp, vp = FE.program_multi_plain(*a2b, ops, el, bf16=True)
        ok, wex, med, win, _ = bf16_close(torch, torch.where(vp, lk, torch.inf),
                                          torch.where(vp, lp, torch.inf), inexact2)
        check(f"{tag} 2b validity bit-equal, loss sums by the bf16 rule (exact trees "
              f"{wex:.3g}, median {med:.3g}, worst {win:.3g})", same(torch, vk, vp) and ok)
        gk = FE.PROGRAM_GRAD(*a3, ops, el)
        mk = FE.PROGRAM_MULTI(a3[0], a3[1], a3[3], *a3[4:], ops, el)
        check(f"{tag} #3 loss == #2's on the same variants (bit)",
              same(torch, gk[0], mk[0]) and same(torch, gk[1], mk[1]))
        err3 = grad_close(torch, check, f"{tag} #3", gk,
                          FE.program_grad_plain(*a3, ops, el, return_abs=True), 1e-4)
        ms1 = cuda_ms(torch, lambda: FE.PROGRAM_EVAL(*args, ops, el, cx=cxf, scal=scal), reps=5)
        ms2 = cuda_ms(torch, lambda: FE.PROGRAM_MULTI(*m_full, ops, el), reps=3)
        ms3 = cuda_ms(torch, lambda: FE.PROGRAM_GRAD(*g3full, ops, el), reps=3)
        lo = LOSS_OPS[el.kind]
        b1, by1 = bound(steps1 * n + lo * n * T, 4.0 * (T * (L + CMAX + 5) + 7 * n))
        b2, by2 = bound((steps2 + lo * To) * V_ls * n,
                        4.0 * (To * (L + 3 + V_ls * CMAX) + 7 * n))
        b3, by3, _, _ = grad_bound(torch, g3full)
        print(f"  {name} (kind {el.kind}, parameter {el.param:g}): #1 {ms1:.4f} ms (bound "
              f"{b1:.4f} {by1}), #2 {ms2:.4f} ms (bound {b2:.4f} {by2}), #3 {ms3:.4f} ms "
              f"(bound {b3:.4f} {by3}); #3 largest gradient error {err3:.3g}")
        if name == "logcosh":
            rows += logcosh_rows(torch, check, (args, cxf, scal, ops), m_full, g3full,
                                 el, ((ms1, b1, by1), (ms2, b2, by2), (ms3, b3, by3)))
    (args, a1, a1b, ap, a2, a2b, a3, g3full, _) = base
    check.raise_if_failed("phase 26, loss kinds")

    # The float64 forms at the full shapes, L2 (the default loss).
    d = lambda t: t.double().contiguous()
    el = options.elementwise_loss
    a64 = args[:2] + (d(args[2]), args[3], d(args[4]), d(args[5]), d(args[6]))
    cx64, scal64 = d(cxf), d(scal)
    k = FE.PROGRAM_EVAL_F64
    lk, vk, ck = k(*a64, ops, el, cx=cx64, scal=scal64)
    lk2, _, ck2 = k(*a64, ops, el, cx=cx64, scal=scal64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, vp, cp = FE.program_eval_plain(*a64, ops, el, cx=cx64, scal=scal64)
    torch.cuda.synchronize()
    plain1 = (time.perf_counter() - t0) * 1e3
    check("#1 f64 two launches bit-identical", same(torch, lk, lk2) and same(torch, ck, ck2))
    check("#1 f64 validity bit-equal", same(torch, vk, vp))
    s1, w1, r1, e1 = close_at(torch, lk, lp, RTOL64)
    s2, w2, r2, _ = close_at(torch, ck, cp, RTOL64)
    check(f"#1 f64 loss and cost within rtol {RTOL64:g}, inf in the same places (max rel err "
          f"{max(r1, r2):.3g})", s1 and w1 and s2 and w2)
    ms = cuda_ms(torch, lambda: k(*a64, ops, el, cx=cx64, scal=scal64), reps=5)
    b, by = bound64(steps1 * n + 4.0 * n * T, 8.0 * (T * (L + CMAX + 5) + 7 * n))
    print(f"  #1 program_eval_f64: {ms:.4f} ms (cost form, CUDA events, mean of 5), plain "
          f"{plain1:.1f} ms, bound {b:.4f} ms ({by}); {int(vk.sum())} of {T} valid")
    rows.append(table_row(k, e1, ms, plain1, b, by))

    pinstr, pnsteps, pcvals, pok, pbank, pcls, pX, py, pw = pargs
    p64 = (pinstr, pnsteps, d(pcvals), pok, d(pbank), pcls, d(pX), d(py), d(pw))
    k = FE.PROGRAM_EVAL_PARAM_F64
    lk, vk = k(*p64, pops, el)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, vp = FE.program_eval_plain(*p64[:4], *p64[6:], pops, el, bank=p64[4], class_idx=pcls)
    torch.cuda.synchronize()
    plainp = (time.perf_counter() - t0) * 1e3
    check("#1p f64 validity bit-equal", same(torch, vk, vp))
    s1, w1, r1, e1 = close_at(torch, torch.where(vp, lk, torch.inf),
                              torch.where(vp, lp, torch.inf), RTOL64)
    check(f"#1p f64 loss sums within rtol {RTOL64:g} (max rel err {r1:.3g})", s1 and w1)
    ms = cuda_ms(torch, lambda: k(*p64, pops, el), reps=5)
    TP, LP, CP = pinstr.shape[0], pinstr.shape[1], pcvals.shape[1]
    stepsp = float(pnsteps.to(torch.float64).sum())
    b, by = bound64(stepsp * n + 4.0 * n * TP,
                    8.0 * (TP * (LP + CP + 3) + TP * pbank.shape[1] * pbank.shape[2] + 6 * n))
    print(f"  #1p program_eval_param_f64: {ms:.4f} ms (CUDA events, mean of 5), plain "
          f"{plainp:.1f} ms, bound {b:.4f} ms ({by})")
    rows.append(table_row(k, e1, ms, plainp, b, by))

    m64 = (oinstr, onsteps, d(cv_ls), d(oXt), d(oyt), d(ow))
    k = FE.PROGRAM_MULTI_F64
    lk, vk = k(*m64, ops, el)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, vp = FE.program_multi_plain(*m64, ops, el)
    torch.cuda.synchronize()
    plain2 = (time.perf_counter() - t0) * 1e3
    check("#2 f64 validity bit-equal", same(torch, vk, vp))
    s1, w1, r1, e1 = close_at(torch, torch.where(vp, lk, torch.inf),
                              torch.where(vp, lp, torch.inf), RTOL64)
    check(f"#2 f64 loss sums within rtol {RTOL64:g} (max rel err {r1:.3g})", s1 and w1)
    ms = cuda_ms(torch, lambda: k(*m64, ops, el), reps=3)
    b, by = bound64((steps2 + 4.0 * To) * V_ls * n, 8.0 * (To * (L + 3 + V_ls * CMAX) + 7 * n))
    print(f"  #2 program_multi_f64: {ms:.4f} ms (V={V_ls}, CUDA events, mean of 3), plain "
          f"{plain2:.1f} ms, bound {b:.4f} ms ({by})")
    rows.append(table_row(k, e1, ms, plain2, b, by))

    g64 = (oinstr, onsteps, onconst, d(cv_g), d(oXt), d(oyt), d(ow))
    k = FE.PROGRAM_GRAD_F64
    gk = k(*g64, ops, el)
    mk = FE.PROGRAM_MULTI_F64(oinstr, onsteps, d(cv_g), *g64[4:], ops, el)
    check("#3 f64 loss == #2 f64's on the same variants (bit)",
          same(torch, gk[0], mk[0]) and same(torch, gk[1], mk[1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = FE.program_grad_plain(*g64, ops, el, return_abs=True)
    torch.cuda.synchronize()
    plain3 = (time.perf_counter() - t0) * 1e3
    e3 = grad_close(torch, check, "#3 f64", gk, gp, RTOL64)
    ms = cuda_ms(torch, lambda: k(*g64, ops, el), reps=3)
    _, _, ops3, bytes3 = grad_bound(torch, g3full)
    b, by = bound64(ops3, 2.0 * bytes3)
    print(f"  #3 program_grad_f64: {ms:.4f} ms (V={R}, CUDA events, mean of 3), plain "
          f"{plain3:.1f} ms, bound {b:.4f} ms ({by})")
    rows.append(table_row(k, e3, ms, plain3, b, by))

    # Every kind on the float64 forms, on the subsets.
    for name, el in loss_cases():
        a = head(a64, K1, (0, 1, 2, 3))
        lk, vk, ck = FE.PROGRAM_EVAL_F64(*a, ops, el, cx=cx64[:K1].contiguous(), scal=scal64)
        lp, vp, cp = FE.program_eval_plain(*a, ops, el, cx=cx64[:K1].contiguous(), scal=scal64)
        s1, w1, r1, _ = close_at(torch, ck, cp, RTOL64)
        ap64 = head(p64, K1, (0, 1, 2, 3, 4))
        lk2, vk2 = FE.PROGRAM_EVAL_PARAM_F64(*ap64, pops, el)
        lp2, vp2 = FE.program_eval_plain(*ap64[:4], *ap64[6:], pops, el, bank=ap64[4],
                                         class_idx=pcls)
        s2, w2, r2, _ = close_at(torch, torch.where(vp2, lk2, torch.inf),
                                 torch.where(vp2, lp2, torch.inf), RTOL64)
        am = head(m64, K2, (0, 1, 2))
        lk3, vk3 = FE.PROGRAM_MULTI_F64(*am, ops, el)
        lp3, vp3 = FE.program_multi_plain(*am, ops, el)
        s3, w3, r3, _ = close_at(torch, torch.where(vp3, lk3, torch.inf),
                                 torch.where(vp3, lp3, torch.inf), RTOL64)
        check(f"{name}: #1, #1p and #2 f64 validity bit-equal, within rtol {RTOL64:g} (max rel "
              f"err {max(r1, r2, r3):.3g})",
              same(torch, vk, vp) and same(torch, vk2, vp2) and same(torch, vk3, vp3)
              and s1 and w1 and s2 and w2 and s3 and w3)
        ag = head(g64, K2, (0, 1, 2, 3))
        grad_close(torch, check, f"{name}: #3 f64", FE.PROGRAM_GRAD_F64(*ag, ops, el),
                   FE.program_grad_plain(*ag, ops, el, return_abs=True), 1e-8)
    check.raise_if_failed("phase 26, float64 forms")
    return rows


def logcosh_rows(torch, check, a1, a2, a3, el, times):
    """Kernel-table rows of #1-#3 with logcosh: each held against its plain
    version at the full shapes (phase 26's subset checks, on every tree),
    with the plain version's time, beside the kernel times of ``times``."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    args, cxf, scal, ops = a1
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, vp, cp = FE.program_eval_plain(*args, ops, el, cx=cxf, scal=scal)
    torch.cuda.synchronize()
    p1 = (time.perf_counter() - t0) * 1e3
    lk, vk, ck = FE.PROGRAM_EVAL(*args, ops, el, cx=cxf, scal=scal)
    s1, w1, r1, e1 = close(torch, lk, lp)
    check(f"logcosh #1 at the full shapes: validity bit-equal, loss within rtol {RTOL} (max "
          f"rel err {r1:.3g})", same(torch, vk, vp) and s1 and w1)
    t0 = time.perf_counter()
    lp, vp = FE.program_multi_plain(*a2, ops, el)
    torch.cuda.synchronize()
    p2 = (time.perf_counter() - t0) * 1e3
    lk, vk = FE.PROGRAM_MULTI(*a2, ops, el)
    s2, w2, r2, e2 = close(torch, torch.where(vp, lk, torch.inf), torch.where(vp, lp, torch.inf))
    check(f"logcosh #2 at the full shapes: validity bit-equal, loss sums within rtol {RTOL} "
          f"(max rel err {r2:.3g})", same(torch, vk, vp) and s2 and w2)
    t0 = time.perf_counter()
    gp = FE.program_grad_plain(*a3, ops, el, return_abs=True)
    torch.cuda.synchronize()
    p3 = (time.perf_counter() - t0) * 1e3
    e3 = grad_close(torch, check, "logcosh #3 at the full shapes", FE.PROGRAM_GRAD(*a3, ops, el),
                    gp, 1e-4)
    for k, err, plain, (ms, b, by) in ((FE.PROGRAM_EVAL, e1, p1, times[0]),
                                       (FE.PROGRAM_MULTI, e2, p2, times[1]),
                                       (FE.PROGRAM_GRAD, e3, p3, times[2])):
        row = table_row(k, err, ms, plain, b, by)
        row["name"] = f"{k.name} logcosh"
        row["replaces"] = k.replaces + " with elementwise_loss='logcosh'"
        out.append(row)
        print(f"  {row['name']}: {ms:.4f} ms, plain {plain:.1f} ms, bound {b:.4f} ms ({by})")
    return out


def host_loss64(torch, state, operators, X, y, loss):
    """(reported, host) loss of the hall of fame's best member: its tree
    decoded and evaluated on the host in float64, ``loss`` elementwise."""
    from symbolicregression_jl_tpu_torch.ops.encoding import decode_population

    ex = state.hof.exists
    i = int(torch.where(ex, state.hof.loss, torch.inf).argmin())
    node = decode_population(state.hof.trees.reshape(-1)[i:i + 1], operators)[0]
    p = host_predict(torch, node, X.astype(np.float64))
    host = float(loss(p, torch.from_numpy(y.astype(np.float64))).mean())
    return float(state.hof.loss[i]), host


def phase_loss_searches(torch, sr, dev):
    """Phase 27: the optimizer cell (512 x 256, 10,000 rows x 5) at
    LOSS_CYCLES cycles with elementwise_loss="logcosh" (kernels #1-#3 with
    LOSS_ANY), and with eval_dtype="float64" (their float64 forms), and the
    parametric cell with eval_dtype="float64" (#1p's float64 form): each on
    its kernels alone by the launch counters, its best member's loss
    recomputed on the host in float64. Returns the launches of each run."""
    out = {}
    X, y = bench_data()
    it = 2
    nc = LOSS_CYCLES
    opt_iters = 8
    for tag, kw, names, rtol in (
            ("logcosh", dict(elementwise_loss="logcosh"),
             ("program_eval", "program_multi", "program_grad"), 1e-3),
            ("float64", dict(eval_dtype="float64"),
             ("program_eval_f64", "program_multi_f64", "program_grad_f64"), 1e-9)):
        print(f"  {tag}:")
        options = bench_options(sr, nc, **kw)
        launches, state, engine, _ = run_engine(torch, sr, dev, options, it)
        expected = expect(launches, **{names[0]: it * (nc + 1), names[1]: it * opt_iters,
                                       names[2]: it * (opt_iters + 1)})
        if launches != expected:
            raise RuntimeError(f"{tag} search launched {launches}, expected {expected}")
        if tag == "float64" and state.pops.cost.dtype != torch.float64:
            raise RuntimeError(f"float64 search keeps costs in {state.pops.cost.dtype}")
        rep, host = host_loss64(torch, state, options.operators, X, y,
                                options.elementwise_loss)
        print(f"  {tag}: best loss {rep:.10g}, host float64 {host:.10g}")
        if not abs(rep - host) <= rtol * abs(host):
            raise RuntimeError(f"{tag}: reported loss {rep} but the host computes {host}")
        out[tag] = launches
    print("  parametric float64:")
    Xp, yp, cls = parametric_data()
    options = parametric_options(sr, nc, eval_dtype="float64")
    launches, state, _, _ = run_engine(torch, sr, dev, options, it, data=(Xp, yp),
                                       extra={"class": cls})
    expected = expect(launches, program_eval_param_f64=it * (nc + 1))
    if launches != expected:
        raise RuntimeError(f"parametric float64 launched {launches}, expected {expected}")
    print(f"  parametric float64: best loss {best_loss(state):.10g}")
    out["parametric float64"] = launches
    return out


def phase_headline(torch):
    """Phase 28: the port's headline bench as a user runs it, once:
    ``python -m symbolicregression_jl_tpu_torch.bench.headline``. Prints
    its JSON line."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "symbolicregression_jl_tpu_torch.bench.headline"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"bench.headline exit {proc.returncode}:\n{proc.stdout}\n"
                           f"{proc.stderr[-4000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    print(f"  {line}")
    print(f"  {time.perf_counter() - t0:.1f} s in all (process start, init, 1 warm-up and 3 "
          f"measured iterations)")
    if rec.get("metric") != "full_dataset_expr_evals_per_sec_10k_rows" or not rec["value"] > 0:
        raise RuntimeError(f"bench.headline printed {line}")
    return rec



# ---------------------------------------------------------------------------
# Phase 29: user elementwise losses on kernels #4 and #5
# ---------------------------------------------------------------------------

USER_CYCLES = 3             # phase 29's search depth (one optimizer run per iteration whatever it)
USER_SUBSET = 256           # phase 4's first trees (with their variants) held against the
                            # plain route


def user_losses():
    """(name, user callable, the library loss it computes) of phase 29."""
    from symbolicregression_jl_tpu_torch.core import losses as L

    return [("(p - t) ** 2", lambda p, t: (p - t) ** 2, L.l2_dist_loss),
            ("abs(p - t)", lambda p, t: abs(p - t), L.l1_dist_loss)]


def route_launches(torch, fn):
    """(result of ``fn()``, launches of #4, launches of #5 in it)."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    p0, v0 = FE.PROGRAM_PREDICT.launches, FE.PROGRAM_PREDICT_VJP.launches
    out = fn()
    torch.cuda.synchronize()
    return out, FE.PROGRAM_PREDICT.launches - p0, FE.PROGRAM_PREDICT_VJP.launches - v0


def first_trees(prog, k: int):
    """The first ``k`` trees of a compiled program."""
    import dataclasses

    return dataclasses.replace(prog, **{f.name: getattr(prog, f.name)[:k].contiguous()
                                        for f in dataclasses.fields(prog)})


def grad_within(torch, a, b, scale, rtol=1e-4):
    """Gradients ``a`` and ``b`` agree within rtol of the absolute row sums
    ``scale`` (equal where the scale is not finite). Returns (ok, worst
    error over the scale)."""
    err = (a - b).abs()
    ok = (err <= rtol * scale) | (err == 0)
    ratio = float((err / scale.clamp(min=1e-30)).nan_to_num(0.0, 0.0, 0.0).max()) \
        if err.numel() else 0.0
    return bool(ok.all()), ratio


def phase_user_loss(torch, sr, dev):
    """Phase 29: a user elementwise callable on kernel #4's predictions
    and, for its gradient, kernel #5 (ops/fused_eval.py's user-loss route)
    at the optimizer cell's shapes: phase 4's 18,432 trees over 10,000
    rows, the cost form, the line search's V = 24 variants and the
    gradient's V = 3. For (p - t) ** 2 and abs(p - t): the route's
    validity bit-equal to the library L2 / L1 forms of kernels #1 (cost
    form), #2 and #3 on the same trees, costs and losses within rtol 1e-5;
    on the first USER_SUBSET trees the route against its plain version
    (#4 and #5's plain versions) and the gradients of both against #3's
    within 1e-4 of the absolute row sums. Then the optimizer cell at
    USER_CYCLES cycles with the abs(p - t) callable: launches of #4 and #5
    only, the best member's loss recomputed on the host in float64.
    Prints the route's times and launches beside the library kernels'.
    Returns the search's launches."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.complexity import (build_complexity_tables,
                                                                compute_complexity_batch)

    (options, trees, prog, (instr, nsteps, cvals, const_ok, Xt, yt, w), nconst, R, V_ls, cv_ls,
     cv_g) = opt_kernel_inputs(torch, sr, dev)
    T = trees.length.shape[0]
    F, ops, k = N_FEATURES, options.operators, USER_SUBSET
    X, y = bench_data()
    cx = compute_complexity_batch(trees, build_complexity_tables(options, F, dev))
    sub = first_trees(prog, k)
    check = Checks()
    print(f"  {T} trees, {N_ROWS} rows; chunks of at most {FE.USER_LOSS_CHUNK_BYTES} bytes")
    for name, user, lib in user_losses():
        tag = f"user {name}"
        ds = sr.make_dataset(X, y, device=dev)
        ds.update_baseline_loss(lib)
        kw = dict(baseline_loss=ds.data.baseline_loss, use_baseline=ds.data.use_baseline,
                  parsimony=options.parsimony)
        cost_args = (prog, Xt, yt, None, cx, F, ops)
        (cu, lu, vu), n4c, _ = route_launches(
            torch, lambda: FE.fused_cost_program(*cost_args, user, **kw))
        ck, lk, vk = FE.fused_cost_program(*cost_args, lib, **kw)
        check(f"{tag}: cost form, validity == #1 {lib.name}'s (bit)", same(torch, vu, vk))
        s1, w1, r1, e1 = close(torch, cu, ck)
        s2, w2, r2, _ = close(torch, lu, lk)
        check(f"{tag}: cost and loss within rtol {RTOL} of #1's (max rel err {r1:.3g}, "
              f"{r2:.3g})", s1 and w1 and s2 and w2)
        pl, pv = FE.user_loss_program(sub, Xt, yt, None, F, ops, user, plain=True)
        s3, w3, r3, _ = close(torch, lu[:k], pl)
        check(f"{tag}: first {k} trees' losses == the plain route's (validity bit, rtol "
              f"{RTOL}: max rel err {r3:.3g})", same(torch, vu[:k], pv) and s3 and w3)

        ls_args = (prog, cv_ls, Xt, yt, None, F, ops)
        (lm, vm), n4l, _ = route_launches(torch, lambda: FE.user_loss_multi(*ls_args, user))
        lm2, vm2 = FE.fused_loss_multi(*ls_args, lib)
        s4, w4, r4, _ = close(torch, lm, lm2)
        check(f"{tag}: line search (V = {V_ls}) == #2's (validity bit, rtol {RTOL}: max rel "
              f"err {r4:.3g})", same(torch, vm, vm2) and s4 and w4)

        g_args = (prog, cv_g, Xt, yt, None, F, ops)
        (gl, gv, gg), n4g, n5g = route_launches(torch, lambda: FE.user_grad_multi(*g_args, user))
        kl, kv, kg = FE.fused_grad_multi(*g_args, lib)
        s5, w5, r5, _ = close(torch, gl, kl)
        check(f"{tag}: gradient route's loss (V = {R}) == #3's (validity bit, rtol {RTOL}: "
              f"max rel err {r5:.3g})", same(torch, gv, kv) and s5 and w5)
        pgl, pgv, pgg = FE.user_grad_multi(sub, cv_g[:k].contiguous(), Xt, yt, None, F, ops,
                                           user, plain=True)
        *_, pabs = FE.program_grad_plain(instr[:k].contiguous(), nsteps[:k].contiguous(),
                                         nconst[:k].contiguous(), cv_g[:k].contiguous(), Xt, yt,
                                         w, ops, lib, return_abs=True)
        scale = pabs / float(N_ROWS)
        ok6, q6 = grad_within(torch, gg[:k], kg[:k], scale)
        ok7, q7 = grad_within(torch, gg[:k], pgg, scale)
        check(f"{tag}: first {k} trees' gradients within 1e-4 of the absolute row sums of "
              f"#3's (worst {q6:.3g}) and of the plain route's (worst {q7:.3g})",
              ok6 and ok7 and same(torch, gv[:k], pgv))

        ms_cost = cuda_ms(torch, lambda: FE.fused_cost_program(*cost_args, user, **kw), reps=3)
        ms_cost1 = cuda_ms(torch, lambda: FE.fused_cost_program(*cost_args, lib, **kw), reps=5)
        ms_ls = cuda_ms(torch, lambda: FE.user_loss_multi(*ls_args, user), reps=2)
        ms_ls2 = cuda_ms(torch, lambda: FE.fused_loss_multi(*ls_args, lib), reps=3)
        ms_g = cuda_ms(torch, lambda: FE.user_grad_multi(*g_args, user), reps=2)
        ms_g3 = cuda_ms(torch, lambda: FE.fused_grad_multi(*g_args, lib), reps=3)
        print(f"  {tag}: cost form {ms_cost:.3f} ms ({n4c} launches of #4) against #1's "
              f"{ms_cost1:.4f} ms; line search {ms_ls:.2f} ms ({n4l} of #4) against #2's "
              f"{ms_ls2:.3f} ms; gradient {ms_g:.2f} ms ({n4g} of #4, {n5g} of #5) against "
              f"#3's {ms_g3:.3f} ms (CUDA events; {int(vu.sum())} of {T} trees, "
              f"{int(vm.sum())} of {T * V_ls} and {int(gv.sum())} of {T * R} pairs valid)")
    ct = torch.randn((T, N_ROWS), generator=torch.Generator(device=dev).manual_seed(3),
                     device=dev)
    ms4 = cuda_ms(torch, lambda: FE.PROGRAM_PREDICT(instr, nsteps, cvals, const_ok, Xt, ops),
                  reps=5)
    ms5 = cuda_ms(torch, lambda: FE.PROGRAM_PREDICT_VJP(instr, nsteps, nconst, cvals, Xt, ct,
                                                        ops), reps=3)
    print(f"  one launch over all {T} trees: #4 {ms4:.4f} ms, #5 {ms5:.4f} ms (CUDA events)")
    check.raise_if_failed("user-loss route")

    name, user, _ = user_losses()[1]
    print(f"  search with elementwise_loss = lambda p, t: {name}:")
    opts = bench_options(sr, USER_CYCLES, elementwise_loss=user)
    iters = 2
    launches, state, engine, _ = run_engine(torch, sr, dev, opts, iters)
    if engine.cfg.fuse_cost or not engine.cfg.turbo:
        raise RuntimeError(f"user-loss engine: turbo {engine.cfg.turbo}, fused cost "
                           f"{engine.cfg.fuse_cost}")
    route = {"program_predict": launches["program_predict"],
             "program_predict_vjp": launches["program_predict_vjp"]}
    if launches != expect(launches, **route) or 0 in route.values():
        raise RuntimeError(f"user-loss search launched {launches}: #4 and #5 only")
    rep, host = host_loss64(torch, state, opts.operators, X, y, user)
    print(f"  best loss {rep:.10g}, host float64 {host:.10g}")
    if not abs(rep - host) <= 1e-4 * abs(host):
        raise RuntimeError(f"user-loss search: reported loss {rep} but the host computes {host}")
    return launches


# ---------------------------------------------------------------------------
# Phase 30: robustness at full width
# ---------------------------------------------------------------------------

ROBUST_CYCLES = 3           # phase 30's depth (the optimizer cell, cut as phase 23's)
ROBUST_ITERS = 3
ROBUST_DEADLINE = 10.0      # iteration_deadline (s) of the spin-kernel child, over 3x an iteration
SPIN_CYCLES = 30 * 2 * 10**9   # the spin kernel: 30-60 s at the card's 1-2 GHz clock


def robust_search(torch, sr, dev, out_dir, run_id, niterations=ROBUST_ITERS, resume=None,
                  seed=0, **kw):
    """equation_search on the optimizer cell at ROBUST_CYCLES cycles with
    telemetry, its files under ``out_dir``. Returns (state, the run's
    telemetry events, seconds)."""
    X, y = bench_data()
    options = bench_options(sr, ROBUST_CYCLES, save_to_file=True, output_directory=out_dir,
                            telemetry=True, **kw)
    t0 = time.perf_counter()
    state, _ = sr.equation_search(X, y, options=options, niterations=niterations, seed=seed,
                                  run_id=run_id, verbosity=0, device=dev, return_state=True,
                                  resume=resume)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return state, run_events(os.path.join(out_dir, run_id)), secs


def seconds_per_iteration(events) -> float:
    """Host seconds per iteration after the first (the telemetry's
    elapsed_s), so the first iteration's kernel loads are left out."""
    its = [e for e in events if e["event"] == "iteration"]
    return (its[-1]["elapsed_s"] - its[0]["elapsed_s"]) / (len(its) - 1)


def run_events(path):
    """The telemetry records of a run directory ([] when it wrote none)."""
    path = os.path.join(path, "telemetry.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def fault_events(events, kind=None):
    return [e for e in events if e["event"] == "fault" and kind in (None, e["kind"])]


def child_search(out_dir: str, run_id: str, device: str = "cuda", deadline=None,
                 spin_at: int = 0) -> None:
    """Phase 30's search in a process of its own (``python -c``): with
    SR_FAULT_PLAN from the environment, and with ``spin_at`` a spin kernel
    (``torch.cuda._sleep``) launched at the start of that iteration
    attempt, inside its watchdog phase, under ``iteration_deadline``."""
    import torch

    import symbolicregression_jl_tpu_torch as sr
    from symbolicregression_jl_tpu_torch.shield import faults

    if spin_at:
        class SpinInjector(faults.FaultInjector):
            def on_dispatch(self, iteration):
                super().on_dispatch(iteration)
                if self.dispatches == spin_at:
                    self._record("spin_kernel", iteration, dispatch=self.dispatches,
                                 cycles=SPIN_CYCLES)
                    torch.cuda._sleep(SPIN_CYCLES)

        faults.install(SpinInjector(faults.FaultPlan()))
    robust_search(torch, sr, torch.device(device), out_dir, run_id, iteration_deadline=deadline)
    print("child search finished")


def run_child(out_dir: str, run_id: str, env_extra=None, timeout=600, **kw):
    """Runs child_search in a new process; returns (exit code, stdout,
    stderr, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    args = ", ".join([repr(out_dir), repr(run_id)] + [f"{k}={v!r}" for k, v in kw.items()])
    code = f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; " \
           f"chip_smoke.child_search({args})"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=timeout, env=dict(os.environ, **(env_extra or {})))
    return proc.returncode, proc.stdout, proc.stderr, time.perf_counter() - t0


def phase_robustness(torch, sr, dev, out_base):
    """Phase 30: graftshield at the optimizer cell (512 x 256, 10,000 rows,
    ROBUST_CYCLES cycles, ROBUST_ITERS iterations, telemetry on): shield
    off, on, on, off in turns, every state bit-identical, s/iteration of
    each; two injected CUDA out-of-memory failures of the second attempt
    retried, the state bit-identical to the clean run; a real
    torch.cuda.OutOfMemoryError classified as an out-of-memory and a
    retry of an attempt that held most of the card succeeding after the
    runner freed it; island 3 NaN-poisoned at the end of iteration 1,
    quarantined and finite afterwards; a SIGTERM at the end of iteration 2
    in a child process ending "preempted" with an emergency checkpoint,
    and resume="auto" from it bit-identical to the uninterrupted run; a
    spin kernel in a child's second iteration attempt under
    iteration_deadline exiting with code 124 and a dump."""
    from symbolicregression_jl_tpu_torch.shield import faults
    from symbolicregression_jl_tpu_torch.shield.degrade import (ShieldRunner, _is_oom,
                                                                is_transient_failure)
    from symbolicregression_jl_tpu_torch.telemetry.schema import validate_event

    check = Checks()
    base = os.path.join(out_base, "robust")
    nev = lambda s: s.device_states[0].num_evals

    def same_state(a, b):
        ta, tb = state_tensors(torch, a.device_states[0]), state_tensors(torch, b.device_states[0])
        return len(ta) == len(tb) and all(x is nev(a) or same(torch, x, y)
                                          for x, y in zip(ta, tb))

    runs = {}
    for i, shield in enumerate((False, True, True, False)):
        state, events, secs = robust_search(torch, sr, dev, base, f"turn{i}", shield=shield)
        runs[i] = state
        print(f"  shield {'on ' if shield else 'off'} (turn {i + 1}): "
              f"{seconds_per_iteration(events):.3f} s/iteration after the first, {secs:.2f} s "
              f"in all, faults {fault_events(events)}")
    ref = runs[1]
    check("shield on and off: every state tensor bit-identical in all four turns",
          all(same_state(ref, runs[i]) for i in (0, 2, 3)))

    faults.install(faults.FaultInjector(faults.FaultPlan(
        raise_on_dispatch=2, raise_count=2,
        raise_message="CUDA out of memory. Tried to allocate 2.00 GiB (injected)")))
    try:
        state, events, secs = robust_search(torch, sr, dev, base, "retry", retry_backoff=0.05)
    finally:
        faults.clear()
    retries = fault_events(events, "retry")
    print(f"  retry: {secs:.2f} s, {[(e['iteration'], e['detail']['attempt']) for e in retries]}")
    check("injected out-of-memory: two retries of iteration 2, state bit-identical to the clean "
          "run", [e["detail"]["attempt"] for e in retries] == [1, 2]
          and all(e["iteration"] == 2 for e in retries) and same_state(ref, state))

    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    try:
        torch.empty(2 * total, dtype=torch.uint8, device=dev)
        real = None
    except torch.cuda.OutOfMemoryError as e:
        real = e
    check(f"a real {type(real).__name__} is transient and an out-of-memory",
          real is not None and is_transient_failure(real) and _is_oom(real))
    calls = []

    def attempt():
        held = torch.empty(int(free * 0.6), dtype=torch.uint8, device=dev)
        calls.append(torch.cuda.memory_reserved())
        if len(calls) == 1:   # more than is left: a real out-of-memory
            torch.empty(int(free * 0.6), dtype=torch.uint8, device=dev)
        return held.numel()

    runner = ShieldRunner(max_retries=1, backoff=0.0)
    got = runner.run(attempt)
    after = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    print(f"  real out-of-memory: {free / 2**30:.1f} GiB free of {total / 2**30:.1f}; attempts "
          f"reserved {[round(c / 2**30, 1) for c in calls]} GiB, {after / 2**30:.1f} GiB after")
    check("the retry of an attempt that held 60% of the free memory succeeded after the "
          "runner freed it", got == int(free * 0.6) and runner.retries_total == 1)

    faults.install(faults.FaultInjector(faults.FaultPlan(nan_poison_island=(3, 1))))
    try:
        state, events, secs = robust_search(torch, sr, dev, base, "poison")
    finally:
        faults.clear()
    q = fault_events(events, "quarantine")
    finite3 = float(torch.isfinite(state.device_states[0].pops.loss[3]).float().mean())
    print(f"  NaN poison: {secs:.2f} s, quarantine records "
          f"{[(e['iteration'], e['detail']['islands']) for e in q]}, island 3 finite "
          f"{finite3:.3f}")
    check("island 3 poisoned after iteration 1: quarantined then, its losses finite after",
          len(q) == 1 and q[0]["iteration"] == 1 and q[0]["detail"]["islands"] == [3]
          and finite3 > 0.5)

    sig_base = os.path.join(out_base, "sigterm")
    rc, out, err, secs = run_child(sig_base, "pre", device=str(dev), env_extra={
        "SR_FAULT_PLAN": json.dumps({"sigterm_at_iteration": 2})})
    pre = run_events(os.path.join(sig_base, "pre"))
    end = [e for e in pre if e["event"] == "run_end"]
    kinds = [e["kind"] for e in fault_events(pre)]
    print(f"  SIGTERM child: exit {rc} in {secs:.1f} s; faults {kinds}; run_end "
          f"{end[0]['stop_reason'] if end else None} after {end[0]['iterations'] if end else None}")
    check("SIGTERM at iteration 2: exit 0, stop_reason preempted after 2 iterations, an "
          "emergency checkpoint", rc == 0 and end and end[0]["stop_reason"] == "preempted"
          and end[0]["iterations"] == 2 and "emergency_checkpoint" in kinds
          and "preempt_signal" in kinds)
    if rc != 0:
        raise RuntimeError(f"the SIGTERM child exited {rc}:\n{err[-3000:]}")
    state, events, secs = robust_search(torch, sr, dev, sig_base, "res", resume="auto", seed=99)
    res = [(e["kind"], e["detail"].get("iterations_done")) for e in fault_events(events)]
    print(f"  resume: {secs:.2f} s, {res}")
    check("resume='auto' from the emergency checkpoint: every state tensor bit-identical to the "
          "uninterrupted run", state.iterations_done == ROBUST_ITERS and same_state(ref, state)
          and abs(state.num_evals - ref.num_evals) <= 1e-6 * ref.num_evals)

    rc, out, err, secs = run_child(base, "hang", device=str(dev), deadline=ROBUST_DEADLINE,
                                   spin_at=2)
    dump_path = os.path.join(base, "hang", "watchdog_dump.txt")
    dump = open(dump_path).read() if os.path.exists(dump_path) else ""
    hang = run_events(os.path.join(base, "hang"))
    if rc != 124:
        print(err[-3000:])
    kinds = [(e["kind"], e["detail"].get("fault")) for e in fault_events(hang)]
    main_stack = dump.split("(main)", 1)[-1].split("--- thread", 1)[0].strip().splitlines()
    print(f"  spin kernel under iteration_deadline {ROBUST_DEADLINE} s: exit {rc} in "
          f"{secs:.1f} s; faults {kinds}; the main thread's last frames:")
    for line in main_stack[-4:]:
        print(f"    {line}")
    check("a real hang: exit 124 with a dump naming phase 'iteration' and iteration 2, and a "
          "watchdog_timeout record", rc == 124 and "phase      : iteration" in dump
          and "iteration  : 2" in dump and "phase deadline exceeded" in err
          and ("watchdog_timeout", None) in kinds and "child search finished" not in out)
    bad = [e for run in (pre, hang, events) for e in run if validate_event(e)]
    check("every telemetry record of the child and resumed runs validates", not bad)
    check.raise_if_failed("robustness")


# ---------------------------------------------------------------------------
# Serving: zero-weight padding on the kernels, the server at full width,
# the default diagnostics and the load bench (phases 31-33)
# ---------------------------------------------------------------------------

PAD_REAL = 6000             # phase 31's real rows (phase 3's and 4's first 6,000)
PAD_BUCKET = 8192           # their admission bucket (serve/admission.py shape_bucket)
PLAIN_SUBSET = 256          # trees of #2 and #3 whose plain versions are held padded/unpadded
SERVE_ROWS = (5000, 6000, 7000, 8000)   # phase 32's requests, seeds 0-3: one 8,192-row bucket
SERVE_CYCLES = 5
SERVE_ITERS = 2
DIAG_CYCLES = 5
DIAG_ITERS = 3


def padded_data(torch, sr, dev, fill):
    """Phase 31's data: the bench data's first PAD_REAL rows (weights 1),
    or the same rows padded to PAD_BUCKET with ``fill`` replicas at weight
    0 (pack/padding.py). Returns the DeviceData."""
    from symbolicregression_jl_tpu_torch.pack import pad_to_bucket

    X, y = bench_data()
    X, y = X[:PAD_REAL], y[:PAD_REAL]
    if fill is None:
        w = np.ones(PAD_REAL, np.float32)
    else:
        X, y, w = pad_to_bucket(X, y, rows=PAD_BUCKET, fill=fill)
    return sr.make_dataset(X, y, weights=w, device=dev).data


def phase_padding(torch, sr, dev, card):
    """Phase 31: phase 3's and phase 4's trees on 6,000 real rows against
    the same rows padded to 8,192 with cyclic and with edge replicas at
    weight 0: kernels #1 (plain and cost forms), #2 and #3 bit-equal, and
    the plain versions of #1 (every tree) and #2/#3 (PLAIN_SUBSET trees)
    bit-equal too."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    options, _, trees, cx, prog, _, scal, cxf = kernel1_inputs(torch, sr, dev)
    (_, _, prog2, _, nconst, _, _, cv_ls, cv_g) = opt_kernel_inputs(torch, sr, dev)
    ops, el = options.operators, options.elementwise_loss
    # one scalar row for every side: the kernels' denominator is sum(w),
    # 6,000 on each; the baseline normalization is the host's, not theirs
    scal = scal.clone()
    scal[0] = float(PAD_REAL)
    check = Checks()
    outs, times = {}, {}
    sub = slice(0, PLAIN_SUBSET)
    for fill in (None, "cyclic", "edge"):
        data = padded_data(torch, sr, dev, fill)
        a1 = FE._launch_inputs(prog, data.Xt, data.y, data.weights, N_FEATURES, ops)
        instr, nsteps, cvals, ok, Xt, yt, w = FE._launch_inputs(prog2, data.Xt, data.y,
                                                                data.weights, N_FEATURES, ops)
        got = [*FE.PROGRAM_EVAL(*a1, ops, el), *FE.PROGRAM_EVAL(*a1, ops, el, cx=cxf, scal=scal),
               *FE.PROGRAM_MULTI(instr, nsteps, cv_ls, Xt, yt, w, ops, el),
               *FE.PROGRAM_GRAD(instr, nsteps, nconst, cv_g, Xt, yt, w, ops, el)]
        plain = [*FE.program_eval_plain(*a1, ops, el, cx=cxf, scal=scal),
                 *FE.program_multi_plain(instr[sub], nsteps[sub], cv_ls[sub], Xt, yt, w, ops, el),
                 *FE.program_grad_plain(instr[sub], nsteps[sub], nconst[sub], cv_g[sub], Xt, yt,
                                        w, ops, el)]
        torch.cuda.synchronize()
        outs[fill] = (got, plain)
        times[fill] = cuda_ms(torch, lambda: FE.PROGRAM_EVAL(*a1, ops, el, cx=cxf, scal=scal), 10)
        print(f"  {fill or 'unpadded'}: {Xt.shape[1]} rows, #1 cost form {times[fill]:.4f} ms "
              f"(CUDA events, mean of 10; {card})")
    names = ["#1 loss sum", "#1 validity", "#1 cost-form loss", "#1 cost-form validity",
             "#1 cost", "#2 loss sum", "#2 validity", "#3 loss sum", "#3 validity",
             "#3 gradient"]
    pnames = ["#1 plain loss", "#1 plain validity", "#1 plain cost", "#2 plain loss sum",
              "#2 plain validity", "#3 plain loss sum", "#3 plain validity", "#3 plain gradient"]
    ref, pref = outs[None]
    print(f"  valid: #1 {int(ref[1].sum())} of {ref[1].numel()}, #2 {int(ref[6].sum())} of "
          f"{ref[6].numel()}, #3 {int(ref[8].sum())} of {ref[8].numel()}; digest "
          f"{digest(*ref)}")
    nonfin = ~torch.isfinite(ref[9])
    print(f"  #3's unpadded gradient: {int(nonfin.sum())} of {nonfin.numel()} components "
          f"non-finite (a replica row's 0 x inf would reach these without n_grad)")
    for fill in ("cyclic", "edge"):
        got, plain = outs[fill]
        diff = ref[9].view(torch.int32) != got[9].view(torch.int32)
        if bool(diff.any()):
            print(f"  {fill}: {int(diff.sum())} gradient components differ, "
                  f"{int((diff & nonfin).sum())} of them non-finite unpadded")
        for nm, a, b in zip(names, ref, got):
            check(f"{fill}: {nm} bit-equal to the unpadded launch", same(torch, a, b))
        for nm, a, b in zip(pnames, pref, plain):
            check(f"{fill}: {nm} bit-equal to the unpadded plain version", same(torch, a, b))
    check.raise_if_failed("zero-weight padding")


def serve_request_data(seed: int, rows: int):
    """Phase 32's request data: ``rows`` x 5 features from ``seed``, y as in
    the optimizer cell (bench_data's law and noise)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, (rows, N_FEATURES)).astype(np.float32)
    y = (np.cos(2.13 * X[:, 0]) + 0.5 * X[:, 1] * np.abs(X[:, 2]) ** 0.9
         - 0.3 * np.abs(X[:, 3]) ** 1.5 + 1e-1 * rng.standard_normal(rows)).astype(np.float32)
    return X, y


def serve_options():
    """The optimizer cell's widths as a serve request's JSON options."""
    return dict(binary_operators=["+", "-", "*", "/"], unary_operators=["exp", "abs", "cos"],
                maxsize=30, populations=ISLANDS, population_size=256, tournament_selection_n=16,
                ncycles_per_iteration=SERVE_CYCLES)


def serve_submit(server, index: int, niterations: int = 0) -> str:
    X, y = serve_request_data(index, SERVE_ROWS[index])
    return server.submit(X, y, options=serve_options(), niterations=niterations or SERVE_ITERS,
                         seed=index)


def serve_child(root: str, device: str = "cuda") -> None:
    """Phase 32's crash: a server in a process of its own takes requests 0
    and 1 and is SIGKILLed (by itself) once the first checkpoint lands."""
    import signal
    import threading

    from symbolicregression_jl_tpu_torch.pack import PackPolicy
    from symbolicregression_jl_tpu_torch.serve import SearchServer

    server = SearchServer(root, pack=PackPolicy(), device=device)
    ids = [serve_submit(server, i) for i in (0, 1)]

    def kill_at_first_checkpoint():
        paths = [os.path.join(root, "requests", r, r, "search_state.pkl") for r in ids]
        while not any(os.path.exists(p) for p in paths):
            time.sleep(0.01)
        print("child: first checkpoint written; SIGKILL", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)

    threading.Thread(target=kill_at_first_checkpoint, daemon=True).start()
    server.start()
    server.wait_idle(timeout=600)
    print("child: finished without being killed", flush=True)


def serve_retries(root, ids):
    """The iterations the shield retried in each request, from the fault
    records of its flight-recorder bundle (a fault dumps it)."""
    out = {}
    for rid in ids:
        path = os.path.join(root, "requests", rid, rid, "pulse_bundle.json")
        events = []
        if os.path.exists(path):
            with open(path) as f:
                events = json.load(f).get("events", [])
        out[rid] = sum(1 for e in events if e.get("event") == "fault"
                       and e.get("kind") == "retry")
    return out


def serve_events(root):
    with open(os.path.join(root, "serve_telemetry.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_server(torch, sr, dev, out_base, card):
    """Phase 32: SearchServer(pack=PackPolicy()) at the optimizer cell's
    widths on the card: four requests of one 8,192-row bucket in one
    cohort, each fingerprint against its run alone on a fresh server, the
    launches, the cache, and a SIGKILLed child server replayed."""
    from symbolicregression_jl_tpu_torch.pack import PackPolicy
    from symbolicregression_jl_tpu_torch.serve import SearchServer

    check = Checks()
    root = os.path.join(out_base, "serve_packed")
    server = SearchServer(root, pack=PackPolicy(), device=dev)
    ids = [serve_submit(server, i) for i in range(len(SERVE_ROWS))]
    for k in kernels():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server.start()
    snaps = [server.wait(r, timeout=900) for r in ids]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    server.stop(drain=True, timeout=60)
    launches = {k.name: k.launches for k in kernels()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for s in snaps:
        if s["state"] != "done":
            print(f"  {s['request_id']}: {s['state']}: {s['error']}")
    check("every request done", all(s["state"] == "done" for s in snaps))
    if check.failures:
        print(f"  snapshots {snaps}")
        check.raise_if_failed("serve")
    ev = serve_events(root)
    launch_ev = [e for e in ev if e["kind"] == "pack_launch"]
    done_ev = [e for e in ev if e["kind"] == "pack_done"]
    sizes = [len(e["detail"]["tenants"]) for e in launch_ev]
    rounds = sum(e["detail"]["rounds"] for e in done_ev)
    cohort_s = sum(d["t"] - l["t"] for l, d in zip(launch_ev, done_ev))
    stats = server.cache.stats()
    print(f"  {card}: 4 requests ({', '.join(map(str, SERVE_ROWS))} rows -> bucket "
          f"{snaps[0]['bucket']}, pad rows {[s['pad_rows'] for s in snaps]}) in {wall:.2f} s: "
          f"{len(ids) / wall:.4f} requests/s; launches of tenants {sizes}, {rounds} cohort "
          f"rounds, {cohort_s / max(rounds, 1):.3f} s a round; peak device memory "
          f"{peak:.3f} GiB; cache {stats['hits']} hits / {stats['misses']} misses (hit rate "
          f"{stats['hit_rate']})")
    print(f"  launches {launches}")
    check("a launch holds 4 tenants", max(sizes, default=0) == 4)
    # A retried iteration (graftshield: an out-of-memory of one of the
    # four tenants sharing the card) runs its launches again, up to a whole
    # iteration's: the rule counts it from the requests' fault records.
    retries = serve_retries(root, ids)
    print(f"  {card}: shield retries of an iteration by request {retries}")
    opt, extra = SERVE_ITERS * len(ids), sum(retries.values())
    within = lambda n, per: per * opt <= n <= per * (opt + extra)
    check("only #1-#3 launched, #2 8 and #3 9 a search iteration (and a retried one's)",
          launches == expect(launches, program_eval=launches["program_eval"],
                             program_multi=launches["program_multi"],
                             program_grad=launches["program_grad"])
          and launches["program_eval"] > 0 and within(launches["program_multi"], 8)
          and within(launches["program_grad"], 9))
    check("cache: one miss, then hits", stats["misses"] == 1 and stats["hits"] == len(ids) - 1)
    packed = [s["result"]["fingerprint"] for s in snaps]
    solo_eval = solo_retries = 0
    for i in range(len(ids)):
        solo_root = os.path.join(out_base, f"serve_solo{i}")
        solo = SearchServer(solo_root, pack=PackPolicy(), device=dev)
        for k in kernels():
            k.launches = 0
        rid = serve_submit(solo, i)
        t1 = time.perf_counter()
        solo.start()
        s = solo.wait(rid, timeout=600)
        solo.stop(drain=True, timeout=60)
        solo_eval += next(k.launches for k in kernels() if k.name == "program_eval")
        solo_retries += sum(serve_retries(solo_root, [rid]).values())
        print(f"  request {i} alone: {time.perf_counter() - t1:.2f} s ({card}), fingerprint "
              f"{s['result']['fingerprint'][:16]}, packed {packed[i][:16]}")
        check(f"request {i}: packed fingerprint == solo", s["result"]["fingerprint"] == packed[i])
    check("#1's launches packed == the solo runs' sum (give or take a retried iteration's)",
          abs(launches["program_eval"] - solo_eval)
          <= (SERVE_CYCLES + 1) * (extra + solo_retries))
    # Crash replay: a child server takes requests 0 and 1, dies by SIGKILL
    # at its first checkpoint; a server over the same root finishes both.
    # The child needs the card's memory: this process's servers are gone,
    # and the allocator's cache goes back to the driver.
    del server, solo
    torch.cuda.empty_cache()
    crash_root = os.path.join(out_base, "serve_crash")
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
            f"chip_smoke.serve_child({crash_root!r}, {str(dev)!r})")
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=here, capture_output=True,
                          text=True, timeout=600)
    print(f"  child server: exit code {proc.returncode} after {time.perf_counter() - t1:.2f} s; "
          f"{proc.stdout.strip()}")
    check("child server SIGKILLed", proc.returncode == -9)
    if proc.returncode != -9:
        print(proc.stderr[-3000:])
        with open(os.path.join(crash_root, "requests.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec["event"] == "failed":
                    print(f"  child's {rec['request_id']} failed: {rec['detail']}")
    t1 = time.perf_counter()
    replay = SearchServer(crash_root, pack=PackPolicy(), device=dev).start()
    rs = [replay.wait(r, timeout=600) for r in ("req00001", "req00002")]
    replay.stop(drain=True, timeout=60)
    print(f"  replay: {time.perf_counter() - t1:.2f} s ({card}), states "
          f"{[s['state'] for s in rs]}, resumed {[s['resumed'] for s in rs]}")
    for s in rs:
        if s["state"] != "done":
            print(f"  replayed {s['request_id']}: {s['state']}: {s['error']}")
    check("replay finishes both", all(s["state"] == "done" for s in rs))
    check("replayed fingerprints == unkilled",
          [s["result"]["fingerprint"] for s in rs if s["result"]] == packed[:2])
    check.raise_if_failed("serve")


def diag_search(torch, sr, dev, out_dir, run_id, niterations=DIAG_ITERS, populations=0,
                ncycles=0, **ropt):
    """equation_search on the optimizer cell at ``ncycles`` (DIAG_CYCLES)
    cycles with telemetry and its files under ``out_dir``; ``ropt``
    RuntimeOptions fields. Returns (state, seconds)."""
    X, y = bench_data()
    options = bench_options(sr, ncycles or DIAG_CYCLES, populations, save_to_file=True,
                            output_directory=out_dir, telemetry=True)
    t0 = time.perf_counter()
    state, _ = sr.equation_search(
        X, y, options=options, device=dev, runtime_options=sr.RuntimeOptions(
            niterations=niterations, seed=0, verbosity=0, run_id=run_id, return_state=True,
            **ropt))
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def phase_diagnostics(torch, sr, dev, out_base, card):
    """Phase 33: ledger, pulse and gauge off / on / on / off at the
    optimizer cell; an injected fault's bundle and a profiler window; the
    timeline; then the load bench on the card."""
    from symbolicregression_jl_tpu_torch.bench import load as L
    from symbolicregression_jl_tpu_torch.ledger.ledger import load_accounts
    from symbolicregression_jl_tpu_torch.ledger.timeline import validate_chrome_trace
    from symbolicregression_jl_tpu_torch.pulse.recorder import validate_bundle
    from symbolicregression_jl_tpu_torch.shield import faults
    from symbolicregression_jl_tpu_torch.telemetry import report

    check = Checks()
    d = os.path.join(out_base, "diag")
    off = dict(ledger=False, pulse=False, gauge=False)
    turns = []
    for i, on in enumerate((False, True, True, False)):
        state, secs = diag_search(torch, sr, dev, d, f"turn{i}", **({} if on else off))
        run_dir = os.path.join(d, f"turn{i}")
        turns.append((on, state_tensors(torch, state.device_states[0]), run_dir))
        print(f"  turn {i} (ledger, pulse, gauge {'on' if on else 'off'}): {secs:.2f} s, "
              f"{seconds_per_iteration(run_events(run_dir)):.3f} s/iteration after the first "
              f"({card})")
    ref = turns[0][1]
    check("hall of fame and state bit-identical across turns",
          all(len(t) == len(ref) and all(same(torch, a, b) for a, b in zip(ref, t))
              for _, t, _ in turns[1:]))
    for on, _, run_dir in turns:
        ev = run_events(run_dir)
        gauge = [e for e in ev if e["event"] == "gauge"]
        if not on:
            check(f"{os.path.basename(run_dir)}: no ledger, no gauge events",
                  not os.path.exists(os.path.join(run_dir, "ledger.jsonl")) and not gauge)
            continue
        accts = load_accounts(os.path.join(run_dir, "ledger.jsonl"))
        check(f"{os.path.basename(run_dir)}: ledger.jsonl validates, {DIAG_ITERS} iterations",
              len(accts) == 1 and accts[0]["deterministic"]["iterations"] == DIAG_ITERS)
        mem = [e["detail"] for e in gauge if e["kind"] == "memory"]
        total = torch.cuda.get_device_properties(dev).total_memory
        check(f"{os.path.basename(run_dir)}: gauge memory events carry torch.cuda bytes",
              len(mem) == DIAG_ITERS and all(m["live_bytes"] > 0 and m["bytes_in_use"] > 0
                                             and m["bytes_limit"] == total for m in mem))
        print(f"  {os.path.basename(run_dir)}: ledger device_s {accts[0]['wall']['device_s']:.3f} "
              f"host_s {accts[0]['wall']['host_s']:.3f}, compile "
              f"{accts[0]['wall']['compile']}; gauge live bytes "
              f"{[m['live_bytes'] for m in mem]}, peak in use "
              f"{max(m['peak_bytes_in_use'] for m in mem) / 2**30:.3f} GiB ({card})")
    out = os.path.join(d, "timeline.json")
    rc = report.main(["timeline", turns[1][2], "--out", out])
    with open(out) as f:
        doc = json.load(f)
    check("telemetry timeline renders a valid Chrome trace",
          rc == 0 and validate_chrome_trace(doc) == [] and len(doc["traceEvents"]) > 10)
    # An injected out-of-memory (retried) dumps the flight recorder's
    # bundle; a profiler window over one iteration; at 64 islands and 2
    # cycles, which bounds the trace (about 6,400 launches a cycle).
    faults.install(faults.FaultInjector(faults.FaultPlan(
        raise_on_dispatch=2, raise_count=1, raise_message="CUDA out of memory (injected)")))
    try:
        _, secs = diag_search(torch, sr, dev, d, "fault", niterations=2, populations=64,
                              ncycles=2, pulse_trace_on=True, pulse_trace_iterations=1)
    finally:
        faults.clear()
    run_dir = os.path.join(d, "fault")
    bundle_path = os.path.join(run_dir, "pulse_bundle.json")
    with open(bundle_path) as f:
        bundle = json.load(f)
    check("the injected fault dumped a valid pulse bundle",
          validate_bundle(bundle) == [] and bundle["trigger"]["reason"] == "fault")
    trace = os.path.join(run_dir, "pulse_traces", "capture01", "trace.json")
    with open(trace) as f:
        tdoc = json.load(f)
    kern = sum(1 for e in tdoc.get("traceEvents", [])
               if e.get("cat") == "kernel" and "program_" in str(e.get("name")))
    print(f"  fault run (64 islands, 2 cycles, 2 iterations): {secs:.2f} s; bundle trigger "
          f"{bundle['trigger']}; profiler window {os.path.getsize(trace) / 2**20:.1f} MiB, "
          f"{len(tdoc.get('traceEvents', []))} events, {kern} of them launches of #1-#3")
    check("one torch.profiler window written, with the kernels on the device", kern > 0)
    # The load bench on the card: the storm's four numbers.
    rep = L.run_load(os.path.join(out_base, "load"), device=str(dev), log=lambda *a: None)
    p99 = rep["poll_latency_s"]["p99"]
    print(f"  load bench ({card}): {rep['requests_per_sec']} requests/s, p99 poll latency "
          f"{p99} s, cache hit rate {rep['cache_hit_rate']}, shed fraction "
          f"{rep['shed_fraction']}; {rep['completed']}/{rep['submitted']} done, "
          f"{rep['rejected']} rejects retried, {rep['wall_s']} s")
    check("load bench ok", rep["ok"])
    check.raise_if_failed("diagnostics")


# ---------------------------------------------------------------------------
# Units, D and the tooling (phases 34-36)
# ---------------------------------------------------------------------------

UNITS_CYCLES = 3            # phase 34's depth (one optimizer run per iteration whatever it)
UNITS = {"X_units": ["kg", "m/s", "m"], "y_units": "J"}
D_CYCLES = 3                # phase 35's depth
DEBUG_SERVE_ITERS = 1       # phase 36's cohort, cut from phase 32's SERVE_ITERS
BENCH_CLI_VARIANTS = ("plain", "template")   # phase 36's slice of the mini matrix


def units_data():
    """Phase 34's problem: 10,000 rows from seed 0 of a mass m (kg), a
    speed v (m/s) and a height h (m); y = 0.5 m v^2 + 9.81 m h (J)."""
    rng = np.random.default_rng(0)
    m = rng.uniform(1.0, 10.0, N_ROWS)
    v = rng.uniform(-10.0, 10.0, N_ROWS)
    h = rng.uniform(0.0, 10.0, N_ROWS)
    X = np.stack([m, v, h], 1).astype(np.float32)
    y = (0.5 * m * v * v + 9.81 * m * h).astype(np.float32)
    return X, y


def phase_units(torch, sr, dev, card):
    """Phase 34: the optimizer cell's widths on the units problem with
    dimensional_constraint_penalty=1000 and X_units/y_units, in turns with
    the same search without units (off, on, on, off): launches of #1-#3
    only, each cycle's share of violating candidates (the violation masks
    kept on the device and read after the timed iterations), s/iteration
    on and off, and the best equation's dimensions, which must not violate."""
    from fractions import Fraction

    from symbolicregression_jl_tpu_torch.core.units import Dimensions, parse_unit, pretty_dims
    from symbolicregression_jl_tpu_torch.ops import dims_eval as DE
    from symbolicregression_jl_tpu_torch.ops.encoding import encode_population

    check = Checks()
    ncycles, iters = UNITS_CYCLES, 2
    options = bench_options(sr, ncycles, dimensional_constraint_penalty=1000.0)
    X, y = units_data()
    orig = DE.dimensional_violations_batch
    masks = []

    def recorded(*a, **kw):
        v = orig(*a, **kw)
        masks.append(v.detach())
        return v

    times = {"off": [], "on": []}
    kept = None
    for turn in ("off", "on", "on", "off"):
        print(f"  units {turn}:")
        DE.dimensional_violations_batch = recorded
        try:
            launches, state, engine, _ = run_engine(
                torch, sr, dev, options, iters, data=(X, y),
                units=UNITS if turn == "on" else None, timing=times[turn],
                on_engine=lambda e: masks.clear())
        finally:
            DE.dimensional_violations_batch = orig
        expected = expect(launches, program_eval=iters * (ncycles + 1),
                          program_multi=iters * options.optimizer_iterations,
                          program_grad=iters * (options.optimizer_iterations + 1))
        check(f"units {turn}: launches of #1-#3 only, as phase 5", launches == expected)
        check(f"units {turn}: the check ran {'on every evaluation' if turn == 'on' else 'never'}",
              len(masks) == (iters * (ncycles + 1) if turn == "on" else 0))
        if turn == "on" and kept is None:
            kept = (state, engine, [(int(m.sum()), m.numel()) for m in masks])
    state, engine, counts = kept
    per_cycle = [f"{v / n:.3f}" for v, n in counts[:ncycles]]
    print(f"  violating share of each cycle's candidates (first timed iteration): "
          f"{', '.join(per_cycle)}; finalize {counts[ncycles][0] / counts[ncycles][1]:.3f} "
          f"of {counts[ncycles][1]} members")
    on, off = times["on"], times["off"]
    print(f"  {card}: s/iteration off {off[0]:.3f}, on {on[0]:.3f}, on {on[1]:.3f}, off "
          f"{off[1]:.3f} (units on / off {sum(on) / sum(off):.3f})")
    hof = sr.HallOfFame.from_device(state.hof, options.operators)
    best = min(hof.entries, key=lambda e: e.cost)
    ds = sr.make_dataset(X, y, device=dev, **UNITS)
    batch = encode_population([best.tree], max(best.tree.count_nodes(), 1), options.operators,
                              device=dev)
    viol, root, wild = DE.dimensional_violations_batch(
        batch, ds.data.dims_row, ds.data.x_dims, ds.data.y_dims, True, options.operators,
        return_root=True)
    dims = "a wildcard" if bool(wild[0]) else (pretty_dims(Dimensions(tuple(
        Fraction(e).limit_denominator(1000) for e in root[0].tolist()))) or "dimensionless")
    print(f"  best (lowest cost): loss {best.loss:.6g}, cost {best.cost:.6g}, complexity "
          f"{best.complexity}: {best.equation_string(variable_names=['m', 'v', 'h'])}; dims "
          f"{dims} against y's {pretty_dims(parse_unit(UNITS['y_units']).dims)}; violates "
          f"{bool(viol[0])}")
    check("the best equation does not violate its units", not bool(viol[0]))
    check.raise_if_failed("units")


def d_data():
    """Phase 35's problem: 10,000 rows of x1 from seed 1234 uniform on
    [-2, 2]; y = -dV/dx1 for V = x1^2 cos(x1)."""
    rng = np.random.default_rng(1234)
    X = rng.uniform(-2.0, 2.0, (N_ROWS, 1)).astype(np.float32)
    x1 = X[:, 0].astype(np.float64)
    y = -(2.0 * x1 * np.cos(x1) - x1 * x1 * np.sin(x1))
    return X, y.astype(np.float32)


def d_options(sr, ncycles: int, populations: int = 0, **kw):
    """The template cell's widths with the structure -D(V, 1)(x1)."""
    from symbolicregression_jl_tpu_torch.models import D, template_spec

    spec = template_spec(expressions=("V",))(lambda V, x1: -D(V, 1)(x1))
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=30,
                populations=populations or ISLANDS, population_size=256,
                tournament_selection_n=16, ncycles_per_iteration=ncycles,
                optimizer_probability=0.0, expression_spec=spec, save_to_file=False)
    base.update(kw)
    return sr.Options(**base)


def phase_d_template(torch, sr, dev, card):
    """Phase 35: a D template at the template cell's widths (kernel #4
    forward and #5's row cotangents per evaluation), then its constant
    optimizer at 64 islands (the gradient on the eager interpreter's
    second-order path, the line search on #4 and #5), and one batch of D
    values from #5 against the plain version."""
    from symbolicregression_jl_tpu_torch.evolve import constant_opt as CO
    from symbolicregression_jl_tpu_torch.models import template as ST
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.encoding import TreeBatch

    check = Checks()
    ncycles, iters = D_CYCLES, 2
    options = d_options(sr, ncycles)
    launches, state, engine, _ = run_engine(torch, sr, dev, options, iters, data=d_data())
    evals = iters * (ncycles + 1)
    check("the D template launches #4 and #5 once an evaluation, nothing else",
          launches == expect(launches, program_predict=evals, program_predict_vjp=evals))
    hof = sr.HallOfFame.from_device(state.hof, options.operators, template=engine.template)
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  best: loss {best.loss:.6g} at complexity {best.complexity}: "
          f"{best.equation_string()}")
    check("a finite best loss", bool(np.isfinite(best.loss)))

    # One batch of D values: #5 (gx of the all-ones cotangent) against its
    # plain version, and the eager interpreter's forward mode beside them.
    X, _ = d_data()
    x = torch.from_numpy(X[:, 0]).to(dev)
    flat = state.pops.trees.reshape(-1, 1)
    M = min(4096, flat.length.shape[0])
    sub = TreeBatch(*(f[:M, 0] for f in (flat.arity, flat.op, flat.feat, flat.const)),
                    flat.length[:M, 0])
    ops = options.operators
    d_k = ST._BatchedTreeCallable("V", sub, 1, ops, N_ROWS, True).derivative(1, x)
    with torch.enable_grad():
        xm = x.expand(M, 1, N_ROWS).contiguous().requires_grad_(True)
        pred, v = FE.fused_predict_ad(TreeBatch(sub.arity, sub.op, sub.feat, sub.const,
                                                sub.length), xm, ops, plain=True)
        (gx,) = torch.autograd.grad(pred, xm, torch.ones_like(pred))
    d_p = gx[:, 0]
    d_f = ST._BatchedTreeCallable("V", sub, 1, ops, N_ROWS, False).derivative(1, x)
    torch.cuda.synchronize()
    raw_ok = torch.isfinite(d_p).all(dim=-1) & v
    good, rel, scl, _ = tree_close(torch, d_k.x[raw_ok], d_p[raw_ok])
    check(f"#5's D values against the plain version on {int(raw_ok.sum())} of {M} members "
          f"(NaN and +-inf alike, within rtol {RTOL} or {RTOL} of the member's largest |D|; "
          f"worst relative {rel:.3g}, over the scale {scl:.3g})", good)
    check("#5's D validity equal to the plain version's",
          bool(torch.equal(d_k.valid, raw_ok & v)))
    # The forward mode beside #5: where D cancels to zero the two orders
    # leave different ULP-sized remainders, so the error is taken over the
    # member's larger |D| of the two, floored at 1e-6.
    both = d_k.valid & d_f.valid
    a, b = d_k.x[both], d_f.x[both]
    scale = torch.maximum(a.abs().amax(dim=1), b.abs().amax(dim=1)).clamp(min=1e-6)
    err = (a - b).abs().amax(dim=1) / scale
    print(f"  forward mode (eager interpreter) beside #5 on {int(both.sum())} members both "
          f"call valid: {float((err <= 1e-4).float().mean()):.4f} of them within 1e-4 of the "
          f"member's scale, worst {float(err.max()):.3g}; validity equal on "
          f"{float((d_k.valid == d_f.valid).float().mean()):.4f}")
    ms_k = cuda_ms(torch, lambda: ST._BatchedTreeCallable("V", sub, 1, ops, N_ROWS, True)
                   .derivative(1, x), reps=5)
    print(f"  D of {M} members over {N_ROWS} rows through #4 + #5: {ms_k:.4f} ms ({card})")

    # The constant optimizer at 64 islands: the eager interpreter's
    # forward-mode derivative under autograd (second order).
    options = d_options(sr, ncycles, populations=ISLANDS // 8, optimizer_probability=0.14)
    f_calls, opt_s = [], []

    def record(engine):
        optimize = engine._optimize

        def recorded(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pops, calls = optimize(*a, **kw)
            torch.cuda.synchronize()
            opt_s.append(time.perf_counter() - t0)
            f_calls.append(float(calls))
            return pops, calls

        engine._optimize = recorded

    timing = []
    launches, state, engine, evals = run_engine(torch, sr, dev, options, 1, data=d_data(),
                                                on_engine=record, timing=timing, warmup=False)
    n1 = ncycles + 1 + options.optimizer_iterations
    check("#4 and #5 once an evaluation and once a line search (the gradient passes on the "
          "eager interpreter launch nothing)",
          launches == expect(launches, program_predict=n1, program_predict_vjp=n1))
    print(f"  {card}: {timing[0]:.3f} s/iteration at {ISLANDS // 8} islands, the optimizer "
          f"{opt_s[-1]:.3f} s of it; f_calls {sum(f_calls[-1:]):.0f} of {evals:.0f} evaluations "
          f"({f_calls[-1] / evals:.1%}); peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"(chunks of {CO.D_CHUNK_BYTES / 2**20:.0f} MiB of value buffer)")
    hof = sr.HallOfFame.from_device(state.hof, options.operators, template=engine.template)
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  best after the optimizer: loss {best.loss:.6g}: {best.equation_string()}")
    check("a finite best loss after the optimizer", bool(np.isfinite(best.loss)))
    check.raise_if_failed("D template")


def phase_tooling(torch, sr, dev, out_base, card):
    """Phase 36: ``bench run`` (two mini cells through the matrix runner,
    each a subprocess on the card), ``bench gate`` on its result against
    benchmarks/baseline.json and ``bench trend`` over both files; phase
    32's cohort of 4 under SearchServer(debug_checks=True), its observed
    lock edges inside lint/lock_order.py's blessed order; one iteration of
    the optimizer cell with Options(debug_checks=True) and the audit's
    seconds; compile_count_guard(0) around a warm iteration; no_transfer
    around a kernel #1 launch (passes) and an .item() (raises)."""
    from symbolicregression_jl_tpu_torch.bench.__main__ import main as BENCH_MAIN
    from symbolicregression_jl_tpu_torch.lint import racecheck as RC
    from symbolicregression_jl_tpu_torch.lint.lock_order import BLESSED_EDGES, blessed_closure
    from symbolicregression_jl_tpu_torch.lint.runtime import compile_count_guard, no_transfer
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.pack import PackPolicy
    from symbolicregression_jl_tpu_torch.serve import SearchServer

    check = Checks()
    here = os.path.dirname(os.path.abspath(__file__))
    bench = os.path.join(out_base, "bench_cli")
    res, gated = os.path.join(bench, "result.json"), os.path.join(bench, "gated.json")
    sl = ["--variants", *BENCH_CLI_VARIANTS, "--seeds", "0"]
    t0 = time.perf_counter()
    # The CLI's entry function in this process; the matrix runner starts
    # each cell in a process of its own.
    for name, argv in (("run", ["run", *sl, "--workdir", os.path.join(bench, "work"), "--out",
                                res, "--device", dev.type]),
                       ("gate", ["gate", "--result", res, *sl, "--out", gated, "--baseline",
                                 os.path.join(here, "benchmarks", "baseline.json")]),
                       ("trend", ["trend", gated, res])):
        print(f"  python -m symbolicregression_jl_tpu_torch.bench {' '.join(argv)}")
        check(f"bench {name} exit code 0", BENCH_MAIN(argv) == 0)
    print(f"  bench run + gate + trend: {time.perf_counter() - t0:.1f} s")
    if os.path.exists(res):
        with open(res) as f:
            result = json.load(f)
        print(f"  provenance {result['provenance']}")
        kern = {"plain": "program_eval", "template": "program_predict"}
        for v in BENCH_CLI_VARIANTS:
            rec = result["cells"].get(f"{v}/seed0", {})
            check(f"bench cell {v}/seed0 ran on the card on {kern[v]}: launches "
                  f"{rec.get('launches')}", rec.get("backend") == dev.type
                  and rec.get("launches", {}).get(kern[v], 0) > 0)
        check("the result's platform is gpu", result["platform"] == "gpu")

    # Phase 32's cohort under the runtime lock-order auditor.
    torch.cuda.empty_cache()
    root = os.path.join(out_base, "serve_debug")
    server = SearchServer(root, pack=PackPolicy(), device=dev, debug_checks=True)
    ids = [serve_submit(server, i, DEBUG_SERVE_ITERS) for i in range(len(SERVE_ROWS))]
    t0 = time.perf_counter()
    server.start()
    snaps = [server.wait(r, timeout=900) for r in ids]
    wall = time.perf_counter() - t0
    server.stop(drain=True, timeout=60)
    rec = RC.global_recorder()
    closure = blessed_closure(BLESSED_EDGES)
    edges = sorted(rec.edges)
    print(f"  {card}: the cohort of 4 under debug_checks ({DEBUG_SERVE_ITERS} iteration) in "
          f"{wall:.2f} s; observed lock edges "
          f"{[(a, b, rec.edges[(a, b)]) for a, b in edges]}")
    check("every request done", all(s["state"] == "done" for s in snaps))
    check("no lock-order violation", rec.violations == [])
    check("every observed edge lies inside BLESSED_EDGES' order",
          all(b in closure.get(a, ()) for a, b in edges))
    del server
    torch.cuda.empty_cache()

    # debug_checks on an engine iteration, then the guards.
    options = bench_options(sr, UNITS_CYCLES, debug_checks=True)
    audit_s = []

    def record(engine):
        audit = engine._audit_state

        def timed(st, where):
            t0 = time.perf_counter()
            audit(st, where)
            audit_s.append(time.perf_counter() - t0)

        engine._audit_state = timed

    timing = []
    _, state, engine, _ = run_engine(torch, sr, dev, options, 1, on_engine=record,
                                     timing=timing)
    print(f"  {card}: one iteration with debug_checks {timing[0]:.3f} s, of which the audit "
          f"(population and hall of fame to the host, the invariants) {audit_s[-1]:.3f} s")
    check("the audit ran after the timed iteration", len(audit_s) == 1)
    X, y = bench_data()
    ds = sr.make_dataset(X, y, device=dev)
    ds.update_baseline_loss(options.elementwise_loss)
    with compile_count_guard(0, what="a warm iteration") as stats:
        engine.run_iteration(state, ds.data, options.maxsize)
        torch.cuda.synchronize()
    print(f"  compile_count_guard(0) around a warm iteration: {stats.traces} loads, "
          f"{stats.backend_compiles} builds")
    opts, _, _, _, _, args, scal, cxf = kernel1_inputs(torch, sr, dev)
    kernel, el = FE.PROGRAM_EVAL, opts.elementwise_loss
    kernel(*args, opts.operators, el, cx=cxf, scal=scal)
    torch.cuda.synchronize()
    before = kernel.launches
    try:
        with no_transfer():
            kernel(*args, opts.operators, el, cx=cxf, scal=scal)
        launched = True
    except RuntimeError as e:
        print(f"  no_transfer around a kernel #1 launch raised: {e}")
        launched = False
    check("no_transfer passes a kernel #1 launch", launched and kernel.launches == before + 1)
    try:
        with no_transfer():
            torch.ones(4, device=dev).sum().item()
        raised = False
    except RuntimeError as e:
        raised = "synchroniz" in str(e)
        print(f"  no_transfer around .item(): {str(e).splitlines()[0]}")
    check("no_transfer raises on an .item()", raised)
    check.raise_if_failed("tooling")


# ---------------------------------------------------------------------------
# Phase 37: user operators generated into kernels #1-#5
# ---------------------------------------------------------------------------

USER_OP_CYCLES = 10         # phase 37's search depth (one optimizer run per iteration whatever it)
USER_OP_SUBSET = 2048       # phase 37's and 38's first trees held against the plain versions
                            # (the kernels run on all of them; plain ms is on these)
_USER_OPS = {}


def user_ops():
    """Phase 37's user operators, written in torch (the same Op objects on
    every call, so their operator set's kernels build once): gauss(x) =
    exp(-x * x), softplus(x) = log1p(exp(x)) and pdiv(a, b) = where(b == 0,
    0, a / b)."""
    import torch
    from symbolicregression_jl_tpu_torch.ops.operators import Op

    if not _USER_OPS:
        _USER_OPS["gauss"] = Op("gauss", 1, lambda x: torch.exp(-x * x))
        _USER_OPS["softplus"] = Op("softplus", 1, lambda x: torch.log1p(torch.exp(x)))
        _USER_OPS["pdiv"] = Op("pdiv", 2, lambda a, b: torch.where(b == 0, 0, a / b))
    return _USER_OPS


def user_op_options(sr, ncycles: int, pdiv: bool = True, **kw):
    """The optimizer cell (512 x 256, 10,000 rows x 5) with + - * and pdiv
    (or /), exp and the two user unary operators."""
    u = user_ops()
    return bench_options(sr, ncycles,
                         binary_operators=["+", "-", "*", u["pdiv"] if pdiv else "/"],
                         unary_operators=["exp", u["gauss"], u["softplus"]], **kw)


def user_op_header(sr, pdiv: bool = True):
    """The generated CUDA header of phase 37's operator set (``pdiv``
    False: the set with / in pdiv's place, whose user unary operators need
    libraries of their own)."""
    from symbolicregression_jl_tpu_torch.ops.user_ops import user_op_set

    return user_op_set(user_op_options(sr, 1, pdiv=pdiv).operators).header


def bound_mixed(ops32: float, spine_ops: float, esize: int, bytes_moved: float):
    """(bound ms, bound_by) of a kernel whose steps are FP32 operations and
    whose loss spine's operations are FP64 (``esize`` 8) or FP32."""
    t_ops = (ops32 / H100_FP32_FLOPS
             + spine_ops / (H100_FP64_FLOPS if esize == 8 else H100_FP32_FLOPS)) * 1e3
    t_bytes = bytes_moved / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def table_row(k, err, ms, plain_ms, b, by, name=None):
    return {"name": name or k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None}


def timed_plain(torch, fn):
    """(result of ``fn()``, its milliseconds on the host clock)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def predict_pair_checks(torch, check, tag, k4, k5, ops, instr, nsteps, nconst, cvals, ok, Xc,
                        ct, per_member, k: int = 0):
    """Kernels #4 and #5 (``k4``, ``k5``) against their plain versions under
    phase 8's rules: the kernels on every tree, the plain versions on the
    first ``k`` (0: all). Returns (largest #4 error, largest #5 error, plain
    ms of #4 and #5 on those trees)."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    _same = lambda a, b: same(torch, a, b)
    k = k or instr.shape[0]
    sub = lambda t: t[:k].contiguous()
    Xs = sub(Xc) if per_member else Xc
    pk, vk = k4(instr, nsteps, cvals, ok, Xc, ops)
    pk2, vk2 = k4(instr, nsteps, cvals, ok, Xc, ops)
    check(f"#4 {tag}: two launches bit-identical", _same(pk, pk2) and _same(vk, vk2))
    (pp, vp), plain4 = timed_plain(torch, lambda: FE.program_predict_plain(
        sub(instr), sub(nsteps), sub(cvals), sub(ok), Xs, ops, bf16=k4.bf16))
    pk, vk = pk[:k], vk[:k]
    check(f"#4 {tag}: validity bit-equal", _same(vk, vp))
    good, rel4, scl4, abs4 = tree_close(torch, pk, pp)
    check(f"#4 {tag}: predictions NaN and +-inf in the same places, otherwise within rtol "
          f"{RTOL} or {RTOL} of the tree's largest |pred| (worst relative error {rel4:.3g}, "
          f"worst over the tree's scale {scl4:.3g})", good)
    print(f"  bits #4 {tag}: {digest(pk, vk)}; {int(vk.sum())} of {vk.numel()} valid, "
          f"{int((~torch.isfinite(pk)).sum())} non-finite predictions")
    if k5 is None:
        return abs4, 0.0, plain4, 0.0
    gk, xk = k5(instr, nsteps, nconst, cvals, Xc, ct, ops)
    gk2, xk2 = k5(instr, nsteps, nconst, cvals, Xc, ct, ops)
    (gp, xp, gabs), plain5 = timed_plain(torch, lambda: FE.program_predict_vjp_plain(
        sub(instr), sub(nsteps), sub(nconst), sub(cvals), Xs, sub(ct), ops, return_abs=True))
    check(f"#5 {tag}: two launches bit-identical",
          _same(gk, gk2) and (xk is None or _same(xk, xk2)))
    gk, xk = gk[:k], (None if xk is None else xk[:k])
    # Where the absolute per-row terms overflow (gabs inf) the order of the
    # sum decides between finite, +-inf and NaN (tests/test_torch_tile_host.py
    # holds the same rule); everywhere else the non-finite places agree.
    order = torch.isinf(gabs)
    miss = ~((torch.isnan(gk) == torch.isnan(gp)) & (torch.isposinf(gk) == torch.isposinf(gp))
             & (torch.isneginf(gk) == torch.isneginf(gp)))
    for t, c in torch.nonzero(miss & ~order)[:5].tolist():
        print(f"  #5 {tag}: tree {t} constant {c}: kernel {float(gk[t, c])!r}, plain "
              f"{float(gp[t, c])!r}, absolute row sum {float(gabs[t, c])!r}")
    check(f"#5 {tag}: gcomp NaN and +-inf in the same places where the absolute row sums are "
          f"finite ({int((miss & order).sum())} of {int(order.sum())} entries with an "
          f"overflowing row sum differ)", not bool((miss & ~order).any()))
    both = torch.isfinite(gabs) & torch.isfinite(gk) & torch.isfinite(gp)
    gerr = (gk - gp).abs()[both]
    gscale = float((gerr / gabs[both].clamp(min=1e-30)).max()) if gerr.numel() else 0.0
    check(f"#5 {tag}: gcomp within 1e-4 of the absolute row sums (worst error over that "
          f"scale {gscale:.3g})", bool((gerr <= 1e-4 * gabs[both]).all()))
    err5 = float(gerr.max()) if gerr.numel() else 0.0
    if per_member:
        good, relx, sclx, absx = tree_close(torch, xk, xp)
        check(f"#5 {tag}: gx NaN and +-inf in the same places, otherwise within rtol {RTOL} or "
              f"{RTOL} of the tree's largest |gx| (worst relative error {relx:.3g})", good)
        err5 = max(err5, absx)
    print(f"  bits #5 {tag}: {digest(gk, xk)}")
    return abs4, err5, plain4, plain5


def predict_bounds(nsteps, nconst, T, L, CMAX, F, n, per_member, esize):
    """(#4's bound, #5's bound) as phase 8 reckons them, in values of
    ``esize`` bytes (FP32 or FP64 operations by the table)."""
    import torch

    steps = float(nsteps.to(torch.float64).sum())
    nc = float(nconst.to(torch.float64).sum())
    bnd = bound if esize == 4 else bound64
    xbytes = esize * (T if per_member else 1) * F * n
    b4 = bnd(steps * n, 4.0 * (T * L + 2 * T) + esize * T * CMAX + xbytes + esize * T * n
             + 4.0 * T)
    b5 = bnd((3.0 * steps + nc) * n, 4.0 * (T * L + 2 * T) + esize * (2 * T * CMAX + T * n)
             + xbytes + (xbytes if per_member else 0.0))
    return b4, b5


class EagerCount:
    """Counts calls of the eager interpreter (ops/eval.py eval_tree_batch,
    as evolve/step.py and the constant optimizer call it) while entered."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        from symbolicregression_jl_tpu_torch.evolve import constant_opt, step

        self._saved = [(mod, mod.eval_tree_batch) for mod in (step, constant_opt)]
        for mod, fn in self._saved:
            def counted(*a, _fn=fn, **kw):
                self.calls += 1
                return _fn(*a, **kw)
            mod.eval_tree_batch = counted
        return self

    def __exit__(self, *exc):
        for mod, fn in self._saved:
            mod.eval_tree_batch = fn


def phase_user_ops(torch, sr, dev, card):
    """Phase 37: the user operators gauss, softplus and pdiv (torch
    callables, traced by ops/user_ops.py and generated into every kernel
    source). Their libraries' build seconds; #1 (cost and plain forms), #2
    (V = 24) and #3 (V = 3) on phase 4's 18,432 trees drawn from the user
    operator set, and #4 and #5 on phase 8's 16,384 trees (shared X, F = 1,
    and per-member X, F = 2), against their plain versions under phases 3,
    4 and 8's rules; then equation_search(device="cuda") with turbo on at
    the optimizer cell's widths (USER_OP_CYCLES cycles): #1-#3 launched, the
    eager interpreter called no time, the best member's loss recomputed on
    the host in float64; and the engine's s/iteration in turns with the
    same search with pdiv replaced by /. Returns the kernel-table rows."""
    from symbolicregression_jl_tpu_torch.ops import cuda_build
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    t37 = time.perf_counter()
    into = lambda what: print(f"  ({what}: {time.perf_counter() - t37:.1f} s into the phase)")
    header = user_op_header(sr)
    t0 = time.perf_counter()
    cuda_build.build_all(cuda_build.SOURCES, header)
    print(f"  user-op libraries ready in {time.perf_counter() - t0:.2f} s (nvcc "
          f"{', '.join(f'{cuda_build.build_seconds(f, header):.2f}' for f in cuda_build.SOURCES)} "
          f"s, in parallel; 0.00: built beside phase 2's)")
    for f, kname in (("program_eval.cu", "program_eval_kernel"),
                     ("program_grad.cu", "program_grad_kernel"),
                     ("program_predict_vjp.cu", "program_predict_vjp_kernel")):
        for name, regs, stack, sst, sld in ptxas_report(cuda_build.build_log(f, header), kname):
            print(f"  ptxas (user ops) {name}: {regs} registers, stack {stack} B, spill stores "
                  f"{sst} B, spill loads {sld} B")
    options = user_op_options(sr, 1)
    ops, el = options.operators, options.elementwise_loss
    check = Checks()
    _same = lambda a, b: same(torch, a, b)
    rows = []
    X, y = bench_data()
    ds = sr.make_dataset(X, y, device=dev)
    ds.update_baseline_loss(el)
    data = ds.data

    # #1, #2, #3 on phase 4's trees: the kernels on all, the plain versions
    # on the first USER_OP_SUBSET (with their variants).
    (_, trees, prog, (instr, nsteps, cvals, const_ok, Xt, yt, w), nconst, R, V_ls, cv_ls,
     cv_g) = opt_kernel_inputs(torch, sr, dev, options)
    T, L, CMAX, n = instr.shape[0], instr.shape[1], cvals.shape[1], N_ROWS
    K = min(USER_OP_SUBSET, T)
    sub = lambda t: t[:K].contiguous()
    from symbolicregression_jl_tpu_torch.ops.complexity import (build_complexity_tables,
                                                                compute_complexity_batch)
    cxf = compute_complexity_batch(trees, build_complexity_tables(options, N_FEATURES, dev)) \
        .to(torch.float32).contiguous()
    norm = FE.baseline_normalization(data.baseline_loss, data.use_baseline)
    scal = torch.stack([FE._denominator(None, Xt), norm,
                        torch.tensor(options.parsimony, dtype=torch.float32, device=dev)])
    args1 = (instr, nsteps, cvals, const_ok, Xt, yt, w)
    sargs1 = tuple(map(sub, args1[:4])) + args1[4:]
    k1 = FE.PROGRAM_EVAL
    lk, vk, ck = k1(*args1, ops, el, cx=cxf, scal=scal)
    lk2, vk2, ck2 = k1(*args1, ops, el, cx=cxf, scal=scal)
    sk, svk = k1(*args1, ops, el)
    (lp, vp, cp), plain1 = timed_plain(torch, lambda: FE.program_eval_plain(
        *sargs1, ops, el, cx=sub(cxf), scal=scal))
    sp, svp = FE.program_eval_plain(*sargs1, ops, el)
    check("#1 user ops: two launches bit-identical", _same(lk, lk2) and _same(ck, ck2))
    check(f"#1 user ops: validity bit-equal on the first {K} trees (cost and plain forms)",
          _same(vk[:K], vp) and _same(svk[:K], svp))
    s1, w1, r1, e1 = close(torch, lk[:K], lp)
    s2, w2, r2, _ = close(torch, ck[:K], cp)
    s3, w3, r3, _ = close(torch, torch.where(svp, sk[:K], torch.inf),
                          torch.where(svp, sp, torch.inf))
    check(f"#1 user ops: loss, cost and plain-form sums inf in the same places and within rtol "
          f"{RTOL} (max rel err {r1:.3g}, {r2:.3g}, {r3:.3g})",
          s1 and w1 and s2 and w2 and s3 and w3)
    print(f"  bits #1 user ops: {digest(lk, vk, ck)}; {int(vk.sum())} of {T} trees valid, mean "
          f"steps {float(nsteps.double().mean()):.3f}; plain versions on the first {K}")
    ms1 = cuda_ms(torch, lambda: k1(*args1, ops, el, cx=cxf, scal=scal), reps=10)
    steps = float(nsteps.to(torch.float64).sum())
    b1, by1 = bound(steps * n + 4.0 * n * T,
                    4.0 * (T * L + T + T * CMAX + T + N_FEATURES * n + 2 * n + T + 3 + 3 * T))
    print(f"  #1 program_eval, user ops (cost form, {T} trees): {ms1:.4f} ms (CUDA events, mean "
          f"of 10), plain {plain1:.1f} ms on {K} trees, bound {b1:.4f} ms ({by1})")
    rows.append(table_row(k1, e1, ms1, plain1, b1, by1, "program_eval user ops"))

    k2 = FE.PROGRAM_MULTI
    mk, mv = k2(instr, nsteps, cv_ls, Xt, yt, w, ops, el)
    mk2, mv2 = k2(instr, nsteps, cv_ls, Xt, yt, w, ops, el)
    (mp, mvp), plain2 = timed_plain(torch, lambda: FE.program_multi_plain(
        sub(instr), sub(nsteps), sub(cv_ls), Xt, yt, w, ops, el))
    check("#2 user ops: two launches bit-identical", _same(mk, mk2) and _same(mv, mv2))
    check(f"#2 user ops: validity bit-equal on the first {K} trees", _same(mv[:K], mvp))
    s4, w4, r4, e2 = close(torch, torch.where(mvp, mk[:K], torch.inf),
                           torch.where(mvp, mp, torch.inf))
    check(f"#2 user ops: loss sums inf in the same places, within rtol {RTOL} (max rel err "
          f"{r4:.3g})", s4 and w4)
    print(f"  bits #2 user ops: {digest(mk, mv)}")
    ms2 = cuda_ms(torch, lambda: k2(instr, nsteps, cv_ls, Xt, yt, w, ops, el), reps=5)
    b2, by2 = bound((steps + 4.0 * T) * V_ls * n,
                    4.0 * (T * L + T + T * V_ls * CMAX + N_FEATURES * n + 2 * n + 2 * T * V_ls))
    print(f"  #2 program_multi, user ops (V = {V_ls}): {ms2:.4f} ms (CUDA events, mean of 5), "
          f"plain {plain2:.1f} ms on {K} trees, bound {b2:.4f} ms ({by2})")
    rows.append(table_row(k2, e2, ms2, plain2, b2, by2, "program_multi user ops"))

    gargs = (instr, nsteps, nconst, cv_g, Xt, yt, w)
    gl, gv, gg = FE.PROGRAM_GRAD(*gargs, ops, el)
    gl2, gv2, gg2 = FE.PROGRAM_GRAD(*gargs, ops, el)
    ml, mvv = k2(instr, nsteps, cv_g, Xt, yt, w, ops, el)
    (pl, pv, pg, pabs), plain3 = timed_plain(torch, lambda: FE.program_grad_plain(
        *map(sub, gargs[:4]), Xt, yt, w, ops, el, return_abs=True))
    check("#3 user ops: two launches bit-identical",
          _same(gl, gl2) and _same(gv, gv2) and _same(gg, gg2))
    check("#3 user ops: loss == #2's on the same variants (bit)", _same(gl, ml) and _same(gv, mvv))
    print(f"  bits #3 user ops: {digest(gl, gv, gg)}")
    gl, gv, gg = gl[:K], gv[:K], gg[:K]
    check(f"#3 user ops: validity bit-equal on the first {K} trees", _same(gv, pv))
    s5, w5, r5, _ = close(torch, torch.where(pv, gl, torch.inf), torch.where(pv, pl, torch.inf))
    check(f"#3 user ops: loss sum within rtol {RTOL} (max rel err {r5:.3g})", s5 and w5)
    live = pv[..., None].expand_as(pg)
    check("#3 user ops: gradients non-finite in the same places",
          bool(torch.equal(torch.isfinite(gg)[live], torch.isfinite(pg)[live])))
    both = live & torch.isfinite(gg) & torch.isfinite(pg)
    gerr = (gg - pg).abs()[both]
    check(f"#3 user ops: gradients within 1e-4 of the absolute row sums (max err / scale "
          f"{float((gerr / pabs[both].clamp(min=1e-30)).max()) if gerr.numel() else 0.0:.3g})",
          bool((gerr <= 1e-4 * pabs[both]).all()))
    e3 = float(gerr.max()) if gerr.numel() else 0.0
    ms3 = cuda_ms(torch, lambda: FE.PROGRAM_GRAD(*gargs, ops, el), reps=5)
    b3, by3, _, _ = grad_bound(torch, gargs)
    print(f"  #3 program_grad, user ops (V = {R}): {ms3:.4f} ms (CUDA events, mean of 5), plain "
          f"{plain3:.1f} ms on {K} trees, bound {b3:.4f} ms ({by3})")
    rows.append(table_row(FE.PROGRAM_GRAD, e3, ms3, plain3, b3, by3,
                          "program_grad user ops"))
    del cv_ls, mk, mk2, mp, mv, mv2, mvp
    torch.cuda.empty_cache()
    into("#1-#3 checked")

    # #4 and #5 on phase 8's trees.
    g = torch.Generator(device=dev).manual_seed(37)
    popts = template_options(sr, 1, binary_operators=list(options.operators.binary),
                             unary_operators=list(options.operators.unary))
    t4 = t5 = None
    err4 = err5 = 0.0
    for mode, F, per_member in (("shared, user ops", 1, False), ("per-member, user ops", 2, True)):
        pops, pprog, PX, ct, pok = predict_inputs(torch, sr, dev, F, per_member, False, g,
                                                  options=popts)
        pin, pns, pcv, PXc = FE._predict_inputs(pprog, PX, F, pops)
        pnc = pprog.nconst.to(torch.int32).contiguous()
        KP = min(USER_OP_SUBSET, pin.shape[0])
        a4, a5, p4, p5 = predict_pair_checks(torch, check, mode, FE.PROGRAM_PREDICT,
                                             FE.PROGRAM_PREDICT_VJP, pops, pin, pns, pnc, pcv,
                                             pok, PXc, ct, per_member, k=KP)
        err4, err5 = max(err4, a4), max(err5, a5)
        if not per_member:
            PT = pin.shape[0]
            ms4 = cuda_ms(torch, lambda: FE.PROGRAM_PREDICT(pin, pns, pcv, pok, PXc, pops), 5)
            ms5 = cuda_ms(torch, lambda: FE.PROGRAM_PREDICT_VJP(pin, pns, pnc, pcv, PXc, ct,
                                                                pops), 5)
            bb4, bb5 = predict_bounds(pns, pnc, PT, pin.shape[1], pcv.shape[1], F, n, False, 4)
            t4, t5 = (ms4, p4) + bb4, (ms5, p5) + bb5
            print(f"  #4 program_predict, user ops: {ms4:.4f} ms, plain {p4:.1f} ms on {KP} "
                  f"trees, bound {bb4[0]:.4f} ms ({bb4[1]}); #5 program_predict_vjp, user ops: "
                  f"{ms5:.4f} ms, "
                  f"plain {p5:.1f} ms on {KP} trees, bound {bb5[0]:.4f} ms ({bb5[1]}) (CUDA "
                  f"events, mean of 5)")
        del PX, ct, PXc
        torch.cuda.empty_cache()
    rows.append(table_row(FE.PROGRAM_PREDICT, err4, *t4, name="program_predict user ops"))
    rows.append(table_row(FE.PROGRAM_PREDICT_VJP, err5, *t5, name="program_predict_vjp user ops"))
    check.raise_if_failed("user operators on kernels #1-#5")
    into("#4 and #5 checked")

    # equation_search with the user operators, turbo on (the default on the card).
    t0 = time.perf_counter()
    uopts = user_op_options(sr, USER_OP_CYCLES)
    for k in kernels():
        k.launches = 0
    hof = sr.equation_search(X, y, options=uopts, niterations=1, seed=0, device=dev,
                             verbosity=0)
    search_launches = {k.name: k.launches for k in kernels()}
    best = min(hof.entries, key=lambda e: e.loss)
    p = host_predict(torch, best.tree, X.astype(np.float64)).numpy()
    host = float(np.mean((p - y.astype(np.float64)) ** 2))
    print(f"  equation_search(device='cuda') with gauss, softplus and pdiv: "
          f"{time.perf_counter() - t0:.2f} s, launches {search_launches}; best loss "
          f"{best.loss:.6g} at complexity {best.complexity}: {best.equation_string()}; host "
          f"float64 {host:.6g}")
    if 0 in (search_launches[k] for k in ("program_eval", "program_multi", "program_grad")):
        raise RuntimeError(f"the user-op search launched {search_launches}: #1-#3 expected")
    if not abs(best.loss - host) <= 1e-3 * max(abs(host), 1e-6):
        raise RuntimeError(f"user-op search: reported loss {best.loss}, host {host}")
    into("the search")

    # s/iteration in turns: pdiv, /, /, pdiv; the eager interpreter counted.
    timing = {True: [], False: []}
    launches = None
    with EagerCount() as eager:
        for use_pdiv in (True, False, False, True):
            print(f"  {'pdiv' if use_pdiv else '/'}:")
            opts = user_op_options(sr, USER_OP_CYCLES, pdiv=use_pdiv)
            lch, state, _, _ = run_engine(torch, sr, dev, opts, iters=1,
                                          timing=timing[use_pdiv], warmup=False)
            if use_pdiv:
                launches = lch
    if eager.calls:
        raise RuntimeError(f"the eager interpreter ran {eager.calls} times with turbo on")
    slash = user_op_header(sr, pdiv=False)
    if any(cuda_build.build_seconds(f, slash) for f in cuda_build.SOURCES):
        raise RuntimeError("the set with / built libraries of its own; pdiv's set covers it")
    ratio = [a / b for a, b in zip(timing[True], timing[False][::-1])]
    print(f"  s/iteration with pdiv {timing[True]}, with / {timing[False]} (in turns; pdiv / '/' "
          f"{', '.join(f'{r:.3f}' for r in ratio)}); eager interpreter calls {eager.calls}; "
          f"{card}")
    expected = expect(launches, program_eval=USER_OP_CYCLES + 1,
                      program_multi=uopts.optimizer_iterations,
                      program_grad=uopts.optimizer_iterations + 1)
    if launches != expected:
        raise RuntimeError(f"user-op engine launched {launches}, expected {expected}")
    for row, name in zip(rows[:3], ("program_eval", "program_multi", "program_grad")):
        row["launches"] = launches[name]
    return rows


# ---------------------------------------------------------------------------
# Phase 38: the dtype forms
# ---------------------------------------------------------------------------

DTYPE_CYCLES = 10           # phase 38's search depth


def phase_dtype_forms(torch, sr, dev, card):
    """Phase 38: #4 and #5's double forms on phase 8's shapes and #4's bf16
    form on its shared input, 1b and 2b for float64 data (a float64 loss
    spine) and for bf16 data (a bf16 loss spine) on phases 3, 12 and 4's
    inputs, against their plain versions; then, DTYPE_CYCLES cycles each, one
    timed iteration: a float64 template search at the template cell's
    widths and its optimizer at 64 islands (as phase 10), the optimizer cell
    with float64 data and eval_precision="bf16" (with the bf16 line search),
    the optimizer cell with eval_dtype="bfloat16", the parametric cell in
    both, and a user elementwise loss in a parametric, a float64 and a bf16
    search (the last with phase 37's user operators), printing their
    launches of #4 and #5. Returns the kernel-table rows."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    check = Checks()
    _same = lambda a, b: same(torch, a, b)
    rows = {}
    n = N_ROWS

    # #4 / #5 double, #4 bf16.
    g = torch.Generator(device=dev).manual_seed(38)
    for mode, F, per_member in (("shared, float64", 1, False), ("per-member, float64", 2, True),
                                ("shared, bf16", 1, False)):
        ops, prog, X, ct, ok = predict_inputs(torch, sr, dev, F, per_member, False, g)
        bf = mode.endswith("bf16")
        X = X.double() if not bf else X
        ct = ct.double() if not bf else ct
        pin, pns, pcv, PXc = FE._predict_inputs(prog, X, F, ops)
        pnc = prog.nconst.to(torch.int32).contiguous()
        k4 = FE.PROGRAM_PREDICT_BF16 if bf else FE.PROGRAM_PREDICT_F64
        k5 = None if bf else FE.PROGRAM_PREDICT_VJP_F64
        Xk = FE._bf16_rows(PXc) if bf else PXc
        a4, a5, p4, p5 = predict_pair_checks(torch, check, mode, k4, k5, ops, pin, pns, pnc, pcv,
                                             ok, Xk, ct, per_member)
        if not per_member:
            PT = pin.shape[0]
            ms4 = cuda_ms(torch, lambda: k4(pin, pns, pcv, ok, Xk, ops), 5)
            bb4, bb5 = predict_bounds(pns, pnc, PT, pin.shape[1], pcv.shape[1], F, n, False,
                                      4 if bf else 8)
            rows[k4.name] = table_row(k4, a4, ms4, p4, *bb4)
            line = f"  #4 {k4.name}: {ms4:.4f} ms, plain {p4:.1f} ms, bound {bb4[0]:.4f} ms"
            if k5 is not None:
                ms5 = cuda_ms(torch, lambda: k5(pin, pns, pnc, pcv, Xk, ct, ops), 5)
                rows[k5.name] = table_row(k5, a5, ms5, p5, *bb5)
                line += (f"; #5 {k5.name}: {ms5:.4f} ms, plain {p5:.1f} ms, bound "
                         f"{bb5[0]:.4f} ms")
            print(line + " (CUDA events, mean of 5)")
        elif rows.get(FE.PROGRAM_PREDICT_VJP_F64.name):
            r = rows[FE.PROGRAM_PREDICT_VJP_F64.name]
            r["max_abs_err"] = max(r["max_abs_err"], a5)
        del X, ct, PXc, Xk
        torch.cuda.empty_cache()

    # 1b / 2b with a float64 or a bf16 loss spine, on phases 3 and 4's inputs.
    options, data, trees, cx, prog, args, scal, cxf = kernel1_inputs(torch, sr, dev)
    ops, el = options.operators, options.elementwise_loss
    T, L, CMAX = args[0].shape[0], args[0].shape[1], args[2].shape[1]
    inexact = inexact_trees(torch, args[0], args[1], ops)
    steps = float(prog.nsteps.to(torch.float64).sum())
    rb = lambda t: t.to(torch.bfloat16).to(torch.float32)
    for spine, kern in (("float64", FE.PROGRAM_EVAL_BF16_F64),
                        ("bf16", FE.PROGRAM_EVAL_BF16_DATA)):
        if spine == "float64":
            a = (args[0], args[1], args[2].double(), args[3], FE._bf16_rows(args[4].double()),
                 args[5].double(), args[6].double())
            cxs, sc = cxf.double(), scal.double()
        else:
            a = (args[0], args[1], args[2], args[3], FE._bf16_rows(args[4]), rb(args[5]),
                 rb(args[6]))
            cxs, sc = cxf, scal
        lk, vk, ck = kern(*a, ops, el, cx=cxs, scal=sc)
        lk2, vk2, ck2 = kern(*a, ops, el, cx=cxs, scal=sc)
        (lp, vp, cp), plain = timed_plain(torch, lambda: FE.program_eval_plain(
            *a, ops, el, cx=cxs, scal=sc, bf16="data" if spine == "bf16" else True))
        check(f"1b {spine} spine: two launches bit-identical",
              _same(lk, lk2) and _same(ck, ck2) and _same(vk, vk2))
        check(f"1b {spine} spine: validity bit-equal", _same(vk, vp))
        errs = []
        for what, x, z in (("loss", lk, lp), ("cost", ck, cp)):
            good, wex, med, win, aerr = bf16_close(torch, x, z, inexact)
            errs.append(aerr)
            check(f"1b {spine} spine {what}: non-finite in the same places; + - * / abs trees "
                  f"within rtol {RTOL} (worst {wex:.3g}); transcendental trees median "
                  f"{med:.3g}, worst {win:.3g}", good)
        print(f"  bits 1b {spine} spine: {digest(lk, vk, ck)}")
        ms = cuda_ms(torch, lambda: kern(*a, ops, el, cx=cxs, scal=sc), reps=10)
        es = 8 if spine == "float64" else 4
        b, by = bound_mixed(steps * n, 4.0 * n * T, es,
                            4.0 * (T * L + 2 * T) + es * (T * CMAX + 2 * n + T + 3 + 2 * T)
                            + 2.0 * N_FEATURES * n)
        print(f"  1b {kern.name}: {ms:.4f} ms (CUDA events, mean of 10), plain {plain:.1f} ms, "
              f"bound {b:.4f} ms ({by})")
        rows[kern.name] = table_row(kern, max(errs), ms, plain, b, by)
    del args
    torch.cuda.empty_cache()

    poptions, ptrees, PX, Py, pargs = param_kernel_inputs(torch, sr, dev)
    instr, nsteps, cvals, ok_, bank, cls, Xc, yc, w = pargs
    pops, pel = poptions.operators, poptions.elementwise_loss
    pin_ = inexact_trees(torch, instr, nsteps, pops)
    PT, PL, PC = instr.shape[0], instr.shape[1], cvals.shape[1]
    psteps = float(nsteps.to(torch.float64).sum())
    for spine, kern in (("float64", FE.PROGRAM_EVAL_PARAM_BF16_F64),
                        ("bf16", FE.PROGRAM_EVAL_PARAM_BF16_DATA)):
        if spine == "float64":
            a = (instr, nsteps, cvals.double(), ok_, bank.double(), cls,
                 FE._bf16_rows(Xc.double()), yc.double(), w.double())
        else:
            a = (instr, nsteps, cvals, ok_, bank, cls, FE._bf16_rows(Xc), rb(yc), rb(w))
        lk, vk = kern(*a, pops, pel)
        lk2, vk2 = kern(*a, pops, pel)
        (lp, vp), plain = timed_plain(torch, lambda: FE.program_eval_plain(
            *a[:4], *a[6:], pops, pel, bank=a[4], class_idx=a[5],
            bf16="data" if spine == "bf16" else True))
        check(f"1b parametric {spine} spine: two launches bit-identical",
              _same(lk, lk2) and _same(vk, vk2))
        check(f"1b parametric {spine} spine: validity bit-equal", _same(vk, vp))
        good, wex, med, win, aerr = bf16_close(torch, torch.where(vp, lk, torch.inf),
                                               torch.where(vp, lp, torch.inf), pin_)
        check(f"1b parametric {spine} spine: + - * trees within rtol {RTOL} (worst {wex:.3g}); "
              f"transcendental trees median {med:.3g}, worst {win:.3g}", good)
        ms = cuda_ms(torch, lambda: kern(*a, pops, pel), reps=10)
        es = 8 if spine == "float64" else 4
        b, by = bound_mixed(psteps * n, 4.0 * n * PT, es,
                            4.0 * (PT * PL + 3 * PT) + es * (PT * PC + PT * 2 * 3 + 2 * n + PT)
                            + 4.0 * n + 2.0 * 2 * n)
        print(f"  1b {kern.name}: {ms:.4f} ms (CUDA events, mean of 10), plain {plain:.1f} ms, "
              f"bound {b:.4f} ms ({by})")
        rows[kern.name] = table_row(kern, aerr, ms, plain, b, by)
    del pargs
    torch.cuda.empty_cache()

    (moptions, mtrees, mprog, (instr, nsteps, cvals, _, Xt, yt, w), nconst, R, V_ls, cv_ls,
     _) = opt_kernel_inputs(torch, sr, dev)
    mops, mel = moptions.operators, moptions.elementwise_loss
    min_ = inexact_trees(torch, instr, nsteps, mops)
    MT, ML, MC = instr.shape[0], instr.shape[1], cvals.shape[1]
    msteps = float(nsteps.to(torch.float64).sum())
    for spine, kern in (("float64", FE.PROGRAM_MULTI_BF16_F64),
                        ("bf16", FE.PROGRAM_MULTI_BF16_DATA)):
        if spine == "float64":
            a = (instr, nsteps, cv_ls.double(), FE._bf16_rows(Xt.double()), yt.double(),
                 w.double())
        else:
            a = (instr, nsteps, cv_ls, FE._bf16_rows(Xt), rb(yt), rb(w))
        mk, mv = kern(*a, mops, mel)
        mk2, mv2 = kern(*a, mops, mel)
        KM = min(USER_OP_SUBSET, MT)
        (mp, mvp), plain = timed_plain(torch, lambda: FE.program_multi_plain(
            *(t[:KM].contiguous() for t in a[:3]), *a[3:], mops, mel,
            bf16="data" if spine == "bf16" else True))
        check(f"2b {spine} spine: two launches bit-identical", _same(mk, mk2) and _same(mv, mv2))
        print(f"  bits 2b {spine} spine: {digest(mk, mv)}")
        mk, mv = mk[:KM], mv[:KM]
        check(f"2b {spine} spine: validity bit-equal on the first {KM} trees", _same(mv, mvp))
        good, wex, med, win, aerr = bf16_close(torch, torch.where(mvp, mk, torch.inf),
                                               torch.where(mvp, mp, torch.inf), min_[:KM])
        check(f"2b {spine} spine: + - * / abs trees within rtol {RTOL} (worst {wex:.3g}); "
              f"transcendental trees median {med:.3g}, worst {win:.3g}", good)
        ms = cuda_ms(torch, lambda: kern(*a, mops, mel), reps=5)
        es = 8 if spine == "float64" else 4
        b, by = bound_mixed(msteps * V_ls * n, 4.0 * MT * V_ls * n, es,
                            4.0 * (MT * ML + MT) + es * (MT * V_ls * MC + 2 * n)
                            + 4.0 * MT * V_ls + es * MT * V_ls + 2.0 * N_FEATURES * n)
        print(f"  2b {kern.name}: {ms:.4f} ms (CUDA events, mean of 5), plain {plain:.1f} ms "
              f"on {KM} trees, bound {b:.4f} ms ({by})")
        rows[kern.name] = table_row(kern, aerr, ms, plain, b, by)
    del cv_ls, mk, mk2, mp
    torch.cuda.empty_cache()
    check.raise_if_failed("the dtype forms of kernels #1, #2, #4 and #5")

    # The searches, one timed iteration each after init.
    nc, it = DTYPE_CYCLES, 1
    runs = {}

    def search(tag, options, data=None, extra=None, **expected):
        print(f"  {tag}:")
        launches, state, _, _ = run_engine(torch, sr, dev, options, it, data=data, extra=extra,
                                           warmup=False)
        got = {k: v for k, v in launches.items() if v}
        print(f"  {tag}: launches of #4 and #5 {launches['program_predict']}, "
              f"{launches['program_predict_f64']}, {launches['program_predict_bf16']} / "
              f"{launches['program_predict_vjp']}, {launches['program_predict_vjp_f64']}; "
              f"best loss {best_loss(state):.10g}; all {got}")
        for name, count in expected.items():
            if (count is None and not launches[name]) or (count is not None
                                                          and launches[name] != count):
                raise RuntimeError(f"{tag}: launched {launches}, expected {name} {count}")
        extra_names = set(got) - set(expected)
        if extra_names:
            raise RuntimeError(f"{tag}: launched {sorted(extra_names)} too: {launches}")
        runs[tag] = launches
        return state

    passes = 8 + 1
    state = search("float64 template", template_options(sr, nc, eval_dtype="float64"),
                   data=template_data(), program_predict_f64=3 * (nc + 1))
    if state.pops.cost.dtype != torch.float64:
        raise RuntimeError("the float64 template search keeps float32 costs")
    search("float64 template optimizer (64 islands)",
           template_options(sr, nc, populations=ISLANDS // 8, optimizer_probability=0.14,
                            eval_dtype="float64"),
           data=template_data(), program_predict_f64=3 * (nc + 1 + passes + 8),
           program_predict_vjp_f64=3 * passes)
    search("float64 data, eval_precision='bf16', bf16 line search",
           bench_options(sr, nc, eval_dtype="float64", eval_precision="bf16",
                         optimizer_bf16_linesearch=True),
           program_eval_bf16_f64=nc + 1, program_multi_bf16_f64=8, program_grad_f64=passes)
    search("eval_dtype='bfloat16'", bench_options(sr, nc, eval_dtype="bfloat16"),
           program_eval_bf16_data=nc + 1, program_multi_bf16_data=8, program_grad=passes)
    Xp, yp, clsp = parametric_data()
    search("parametric, float64 data, eval_precision='bf16'",
           parametric_options(sr, nc, eval_dtype="float64", eval_precision="bf16"),
           data=(Xp, yp), extra={"class": clsp}, program_eval_param_bf16_f64=nc + 1)
    search("parametric, eval_dtype='bfloat16'", parametric_options(sr, nc, eval_dtype="bfloat16"),
           data=(Xp, yp), extra={"class": clsp}, program_eval_param_bf16_data=nc + 1)
    user = lambda p, t: abs(p - t)
    search("user loss, parametric",
           parametric_options(sr, nc, elementwise_loss=user), data=(Xp, yp),
           extra={"class": clsp}, program_predict=None)
    search("user loss, float64", bench_options(sr, nc, eval_dtype="float64",
                                              elementwise_loss=user),
           program_predict_f64=None, program_predict_vjp_f64=None)
    search("user loss, eval_precision='bf16', user operators",
           user_op_options(sr, nc, eval_precision="bf16", elementwise_loss=user),
           program_predict_bf16=None, program_predict=None, program_predict_vjp=None)

    for name, tag in (("program_predict_f64", "float64 template"),
                      ("program_predict_vjp_f64", "float64 template optimizer (64 islands)"),
                      ("program_predict_bf16", "user loss, eval_precision='bf16', user operators"),
                      ("program_eval_bf16_f64",
                       "float64 data, eval_precision='bf16', bf16 line search"),
                      ("program_multi_bf16_f64",
                       "float64 data, eval_precision='bf16', bf16 line search"),
                      ("program_eval_bf16_data", "eval_dtype='bfloat16'"),
                      ("program_multi_bf16_data", "eval_dtype='bfloat16'"),
                      ("program_eval_param_bf16_f64",
                       "parametric, float64 data, eval_precision='bf16'"),
                      ("program_eval_param_bf16_data", "parametric, eval_dtype='bfloat16'")):
        rows[name]["launches"] = runs[tag][name]
    print(f"  {card}")
    user_route = runs["user loss, eval_precision='bf16', user operators"]
    return list(rows.values()), user_route


MESH_CYCLES = 10            # phase 39's depth (one iteration of each run)
MESH_RANKS = 2              # phase 39(b): two gloo ranks on the one card
MESH_TIMEOUT_S = 300        # each group's collectives and the ranks' deadline
MESH_ONE_RANK_BACKEND = "nccl"
MESH_POP = 256              # members per island (the optimizer cell's)


def state_digests(state):
    """Digests of a full state's populations, hall of fame and evaluation
    count (phase 39's bit-identity)."""
    from symbolicregression_jl_tpu_torch.api.checkpoint import map_arrays

    def leaves(obj):
        out = []
        map_arrays(obj, out.append)
        return out

    return {"pops": digest(*leaves(state.pops)), "hof": digest(*leaves(state.hof)),
            "num_evals": digest(state.num_evals)}


def mesh_rank_run(ncycles: int = MESH_CYCLES, islands: int = 0, population_size: int = 256,
                  device: str = "cuda"):
    """Phase 39(b) on one rank of a gloo group of ranks sharing the card
    (run by parallel/launch.py in a process of its own): the optimizer
    cell's MeshEngine for one iteration with the optimizer off, then with
    it on, each from its init; a dedup-key exchange after the second.
    Returns each run's s/iteration, launches, gather bytes and seconds,
    peak memory, full-state digests and checks."""
    import torch

    import symbolicregression_jl_tpu_torch as sr
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.mesh import MeshEngine, MeshPlan
    from symbolicregression_jl_tpu_torch.mesh.dryrun import (check_migration_mixed,
                                                             check_populations)
    from symbolicregression_jl_tpu_torch.parallel import multihost
    from symbolicregression_jl_tpu_torch.parallel.collectives import collective_stats

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    X, y = bench_data()
    ds = sr.make_dataset(X, y, device=dev)
    plan = MeshPlan.build()
    out = {"rank": multihost.process_index(), "runs": {}}
    for optimize in (False, True):
        options = bench_options(sr, ncycles, islands, optimize=optimize,
                                population_size=population_size)
        ds.update_baseline_loss(options.elementwise_loss)
        engine = MeshEngine(options, X.shape[1], plan, device=dev)
        data = plan.place_data(ds.data)
        state = engine.init_state(rng.key(0), data, options.populations)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for k in kernels():
            k.launches = 0
        collective_stats(reset=True)
        t0 = time.perf_counter()
        state = engine.run_iteration(state, data, options.maxsize)
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        run = {"s_per_iteration": dt,
               "launches": {k.name: k.launches for k in kernels() if k.launches},
               "collectives": collective_stats(),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
               "local_islands": int(state.birth.shape[0])}
        full = plan.gather_state(state)
        run["digests"] = state_digests(full)
        if optimize:
            check_populations(engine, state, options)
            check_migration_mixed(engine, state, options)
            run["checks"] = "finite populations, a hall of fame that decodes, mixed migration"
            run["exchange"] = engine.dedup_exchange(state)
        out["runs"]["on" if optimize else "off"] = run
    return out


def phase_mesh(torch, sr, dev, out_base, card, ncycles: int = MESH_CYCLES):
    """Phase 39: the multi-device search at the optimizer cell's width (the
    module docstring's 39). Returns each kernel's launches per rank in the
    2-rank run and in the 1-rank group's mesh run."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.engine import Engine
    from symbolicregression_jl_tpu_torch.mesh import MeshEngine, MeshPlan
    from symbolicregression_jl_tpu_torch.parallel import multihost
    from symbolicregression_jl_tpu_torch.parallel.launch import run_ranks

    check = Checks()
    X, y = bench_data()
    ds = sr.make_dataset(X, y, device=dev)
    main_counts = dict(program_eval=ncycles + 1, program_multi=8, program_grad=9)

    def one(engine, options):
        """init and one iteration: (digests, launches, seconds)."""
        ds.update_baseline_loss(options.elementwise_loss)
        state = engine.init_state(rng.key(0), ds.data, options.populations)
        torch.cuda.synchronize()
        for k in kernels():
            k.launches = 0
        t0 = time.perf_counter()
        state = engine.run_iteration(state, ds.data, options.maxsize)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return state_digests(state), {k.name: k.launches for k in kernels()}, dt

    # (a) a 1-rank group on cuda:0
    store = os.path.join(out_base, "mesh_store")
    multihost.initialize_multihost(num_processes=1, process_id=0, init_method="file://" + store,
                                   backend=MESH_ONE_RANK_BACKEND, timeout_s=MESH_TIMEOUT_S)
    try:
        options = bench_options(sr, ncycles, population_size=MESH_POP)
        print(f"  (a) a 1-rank {multihost.backend()} group on {dev}: islands "
              f"{options.populations} x {options.population_size}, {ncycles} cycles, the "
              f"optimizer on, rows {X.shape[0]} x {X.shape[1]}")
        runs = {}
        for name, make in (
                ("plain Engine", lambda: Engine(options, X.shape[1], device=dev)),
                ("MeshEngine", lambda: MeshEngine(options, X.shape[1], MeshPlan.build(),
                                                  device=dev)),
                ("legacy sharded runtime", lambda: Engine(options, X.shape[1], device=dev,
                                                          plan=MeshPlan.build()))):
            torch.cuda.reset_peak_memory_stats()
            runs[name] = one(make(), options)
            d, launches, dt = runs[name]
            print(f"  {card}: {name}: {dt:.3f} s/iteration, launches "
                  f"{ {k: v for k, v in launches.items() if v} }, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, digests {d}")
            check(f"{name}: #1 {ncycles + 1}, #2 8, #3 9 launches, no other",
                  launches == expect(launches, **main_counts))
        for name in ("MeshEngine", "legacy sharded runtime"):
            check(f"{name} bit-identical to the plain Engine (pops, hof, num_evals)",
                  runs[name][0] == runs["plain Engine"][0])
        off = bench_options(sr, ncycles, optimize=False, population_size=MESH_POP)
        unsharded_off, _, dt = one(Engine(off, X.shape[1], device=dev), off)
        print(f"  {card}: unsharded Engine, optimizer off: {dt:.3f} s/iteration, digests "
              f"{unsharded_off}")
    finally:
        multihost.shutdown()
    one_rank = runs["MeshEngine"][1]

    # (b) two gloo ranks on the one card, (c) the dedup exchange
    here = os.path.dirname(os.path.abspath(__file__))
    logs = []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks("chip_smoke:mesh_rank_run", MESH_RANKS,
                      kwargs={"ncycles": ncycles, "islands": ISLANDS, "population_size": MESH_POP,
                              "device": str(dev)}, backend="gloo",
                      timeout_s=MESH_TIMEOUT_S, sys_path=[here],
                      workdir=os.path.join(out_base, "mesh_ranks"), logs=logs)
    print(f"  (b) {MESH_RANKS} gloo ranks on {dev}: {time.perf_counter() - t0:.1f} s with "
          f"their start-up")
    for r in ranks:
        for mode, run in r["runs"].items():
            c = run["collectives"]
            print(f"  {card}: rank {r['rank']}, optimizer {mode}: {run['local_islands']} "
                  f"islands, {run['s_per_iteration']:.3f} s/iteration, gathers "
                  f"{c['collectives']} collectives, {c['bytes']} B received in "
                  f"{c['seconds']:.3f} s, launches {run['launches']}, peak "
                  f"{run['peak_gib'] or 0.0:.3f} GiB")
    off_runs = [r["runs"]["off"] for r in ranks]
    on_runs = [r["runs"]["on"] for r in ranks]
    check("optimizer off: the 2-shard MeshEngine bit-identical to the unsharded Engine",
          all(run["digests"] == unsharded_off for run in off_runs))
    check("optimizer on: both ranks hold the same state", on_runs[0]["digests"]
          == on_runs[1]["digests"])
    check("optimizer on: " + on_runs[0]["checks"], all("checks" in run for run in on_runs))
    for run in on_runs:
        check(f"optimizer on: rank launches #1 {ncycles + 1}, #2 8, #3 9",
              all(run["launches"].get(k, 0) == v for k, v in main_counts.items())
              and set(run["launches"]) == set(main_counts))
    for run in off_runs:
        check(f"optimizer off: rank launches #1 {ncycles + 1} only",
              run["launches"] == {"program_eval": ncycles + 1})
    ex = on_runs[0]["exchange"]
    print(f"  (c) dedup exchange: {ex['rows']} rows, {ex['shard_unique']} shard-unique "
          f"{ex['per_shard_unique']}, {ex['global_unique']} global-unique, local dup "
          f"{ex['local_dup']}, cross-shard dup {ex['cross_shard_dup']}, "
          f"{ex['exchanged_bytes']} B in {ex['exchange_time_s']:.4f} s ({card})")
    check("exchange: rows = shard_unique + local_dup",
          ex["rows"] == ex["shard_unique"] + ex["local_dup"])
    check("exchange: shard_unique >= global_unique", ex["shard_unique"] >= ex["global_unique"])
    check("exchange: rows = islands x members", ex["rows"] == ISLANDS * MESH_POP)
    if check.failures:
        for i, log in enumerate(logs):
            print(f"  rank {i} output:\n{log[-3000:]}")
    check.raise_if_failed("mesh")
    return ({k: on_runs[0]["launches"].get(k, 0) for k in main_counts},
            {k: one_rank.get(k, 0) for k in main_counts})


ROW_CYCLES = 10             # phase 40(a)'s depth (one iteration, run twice)
ROW_TEMPLATE_CYCLES = 3     # phase 40(b)'s template cell depth
ROW_SMALL_ISLANDS = 32      # phase 40(c)'s searches: islands x ROW_SMALL_POP, 3 cycles
ROW_SMALL_POP = 64
ROW_RANKS = 2               # two gloo ranks on the one card, one data shard each
ROW_NAMES = ("program_eval", "program_multi", "program_grad", "program_predict",
             "program_predict_vjp")


def row_abs_mean(pred, y, w, valid):
    """Phase 40(c)'s custom whole-prediction loss: the mean absolute error."""
    import torch

    return torch.mean(torch.abs(pred - y))


def row_shard_rank_run(device: str = "cuda"):
    """Phase 40 on one rank of a gloo group of ROW_RANKS ranks sharing the
    card (run by parallel/launch.py in a process of its own), one island
    shard and ROW_RANKS data shards: each rank holds a block of the rows.
    Returns each run's launches, seconds, collectives, peak memory and
    checks."""
    import torch

    import symbolicregression_jl_tpu_torch as sr
    from symbolicregression_jl_tpu_torch.api.search import RuntimeOptions
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.engine import Engine
    from symbolicregression_jl_tpu_torch.mesh import MeshPlan
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.parallel import multihost
    from symbolicregression_jl_tpu_torch.parallel.collectives import collective_stats

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    plan = MeshPlan.build(n_island_shards=1, n_data_shards=ROW_RANKS)
    out = {"rank": multihost.process_index(), "runs": {}, "checks": {}}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def reset():
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        for k in kernels():
            k.launches = 0
        FE.PROGRAM_EVAL.cost_launches = 0
        collective_stats(reset=True)
        return time.perf_counter()

    def record(name, t0, **extra):
        sync()
        out["runs"][name] = dict(
            seconds=time.perf_counter() - t0,
            launches={k.name: k.launches for k in kernels() if k.launches},
            cost_launches=FE.PROGRAM_EVAL.cost_launches, collectives=collective_stats(),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None, **extra)

    # (a) the optimizer cell
    X, y = bench_data()
    options = bench_options(sr, ROW_CYCLES)
    ds = sr.make_dataset(X, y, device=dev)
    ds.update_baseline_loss(options.elementwise_loss)
    data = plan.place_data(ds.data)
    whole = Engine(options, X.shape[1], device=dev).init_state(rng.key(0, device=dev), ds.data,
                                                               options.populations)
    engine = Engine(options, X.shape[1], device=dev, plan=plan)
    state0 = engine.init_state(rng.key(0, device=dev), data, options.populations)
    out["checks"]["init trees equal the unsharded Engine's"] = all(
        torch.equal(a, b) for a, b in zip(whole.pops.trees.fields(), state0.pops.trees.fields()))
    for f in ("loss", "cost"):
        same_inf, within, rel, _ = close(torch, getattr(state0.pops, f), getattr(whole.pops, f))
        out["checks"][f"init {f} within rtol 1e-5 of the unsharded Engine's (max rel "
                      f"{rel:.3g}), inf alike"] = same_inf and within
    out["rows"] = data.n
    digests = []
    for run in ("first", "second"):
        t0 = reset()
        state = engine.run_iteration(state0, data, options.maxsize)
        record(f"optimizer cell ({run})", t0, best=best_loss(state))
        digests.append(state_digests(state))
    out["checks"]["the same seed twice: bit-identical"] = digests[0] == digests[1]
    out["digest"] = digests[0]
    del whole, state0, state, engine, data

    # (b) the template cell, and its optimizer at ISLANDS // 8
    Xt, yt = template_data()
    for name, opts in (("template cell", template_options(sr, ROW_TEMPLATE_CYCLES)),
                       ("template optimizer", template_options(
                           sr, TEMPLATE_OPT_CYCLES, populations=ISLANDS // 8,
                           optimizer_probability=0.14))):
        tds = sr.make_dataset(Xt, yt, device=dev)
        tds.update_baseline_loss(opts.elementwise_loss)
        tdata = plan.place_data(tds.data)
        eng = Engine(opts, Xt.shape[1], device=dev, plan=plan)
        st = eng.init_state(rng.key(0, device=dev), tdata, opts.populations)
        t0 = reset()
        st = eng.run_iteration(st, tdata, opts.maxsize)
        record(name, t0, best=best_loss(st), cycles=opts.ncycles_per_iteration,
               optimizer_iterations=opts.optimizer_iterations)
        del eng, st, tdata

    # (c) equation_search with each feature the port used to refuse
    for name, kw in (("batching", dict(batching=True, batch_size=BATCH_SIZE)),
                     ("staged_eval", dict(staged_eval=True)),
                     ("custom loss", dict(loss_function=row_abs_mean))):
        opts = bench_options(sr, 3, populations=ROW_SMALL_ISLANDS,
                             population_size=ROW_SMALL_POP, **kw)
        t0 = reset()
        hof = sr.equation_search(X, y, options=opts, device=dev, runtime_options=RuntimeOptions(
            niterations=1, seed=0, verbosity=0, n_data_shards=ROW_RANKS))
        losses = [float(e.loss) for e in hof.entries]
        record(name, t0, hof=len(losses), best=min(losses) if losses else float("nan"))
        out["checks"][f"{name}: a finite hall of fame"] = bool(losses) and bool(
            np.isfinite(losses).all())
    return out


def phase_row_shards(torch, sr, dev, out_base, card):
    """Phase 40: data-row shards on the card (the module docstring's 40).
    Returns each kernel's launches per rank in (a), (b)'s template cell
    and (b)'s optimizer."""
    from symbolicregression_jl_tpu_torch.parallel.launch import run_ranks

    check = Checks()
    here = os.path.dirname(os.path.abspath(__file__))
    logs = []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks("chip_smoke:row_shard_rank_run", ROW_RANKS, kwargs={"device": str(dev)},
                      backend="gloo", timeout_s=MESH_TIMEOUT_S, sys_path=[here],
                      workdir=os.path.join(out_base, "row_ranks"), logs=logs)
    print(f"  {ROW_RANKS} gloo ranks on {dev}, one island shard and {ROW_RANKS} data shards: "
          f"{time.perf_counter() - t0:.1f} s with their start-up; rows per rank "
          f"{[r['rows'] for r in ranks]}")
    for r in ranks:
        for name, run in r["runs"].items():
            c = run["collectives"]
            print(f"  {card}: rank {r['rank']}, {name}: {run['seconds']:.3f} s, launches "
                  f"{run['launches']} (cost-epilogue form {run['cost_launches']}), "
                  f"{c['collectives']} collectives, {c['bytes']} B received in "
                  f"{c['seconds']:.3f} s, peak {run['peak_gib'] or 0.0:.3f} GiB, best loss "
                  f"{run['best']:.6g}")
        for name, ok in r["checks"].items():
            check(f"rank {r['rank']}: {name}", ok)
    check("both ranks hold the same state", ranks[0]["digest"] == ranks[1]["digest"])
    t = TEMPLATE_OPT_CYCLES
    opt_iters = bench_options(sr, 1).optimizer_iterations
    passes = opt_iters + 1
    want = {"optimizer cell (first)": dict(program_eval=ROW_CYCLES + 1, program_multi=8,
                                           program_grad=9),
            "template cell": dict(program_predict=3 * (ROW_TEMPLATE_CYCLES + 1)),
            "template optimizer": dict(program_predict=3 * (t + 1 + passes + opt_iters),
                                       program_predict_vjp=3 * passes)}
    want["optimizer cell (second)"] = want["optimizer cell (first)"]
    for r in ranks:
        for name, counts in want.items():
            run = r["runs"][name]
            check(f"rank {r['rank']}, {name}: launches {counts}, no other",
                  run["launches"] == counts and run["cost_launches"] == 0)
        for name in ("batching", "staged_eval", "custom loss"):
            print(f"  rank {r['rank']}, {name}: hall of fame of {r['runs'][name]['hof']}")
    if check.failures:
        for i, log in enumerate(logs):
            print(f"  rank {i} output:\n{log[-3000:]}")
    check.raise_if_failed("row shards")
    per_rank = {}
    for name in ROW_NAMES:
        per_rank[name] = sum(ranks[0]["runs"][run]["launches"].get(name, 0)
                             for run in ("optimizer cell (first)", "template cell",
                                         "template optimizer"))
        if not per_rank[name]:
            raise RuntimeError(f"phase 40 launched {name} no time")
    return per_rank


def _build_or_error(cuda_build, header):
    """Builds every source with ``header``; returns the error instead of
    raising it (the caller re-raises it on its own thread)."""
    try:
        cuda_build.build_all(cuda_build.SOURCES, header)
    except BaseException as e:  # noqa: BLE001 - re-raised by the caller
        return e
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ncycles", type=int, default=20,
                    help="ncycles_per_iteration of the main path (depth only)")
    ap.add_argument("--ncycles-plain", type=int, default=10,
                    help="ncycles_per_iteration of the no-optimizer path (depth only)")
    ap.add_argument("--ncycles-stage", type=int, default=5,
                    help="ncycles_per_iteration of the four graftstage cells (depth only)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import symbolicregression_jl_tpu_torch as sr
    from symbolicregression_jl_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    # Every file a phase writes (hall-of-fame CSVs, checkpoints) goes here,
    # never into the checkout; removed on the way out.
    out_base = tempfile.mkdtemp(prefix="sr_chip_smoke_")
    try:
        return run_phases(args, torch, sr, cuda_build, dev, out_base)
    finally:
        shutil.rmtree(out_base, ignore_errors=True)


def run_phases(args, torch, sr, cuda_build, dev, out_base) -> int:
    t_phase = [time.perf_counter(), time.perf_counter()]

    def header(text):
        """Print the last phase's seconds, then the next phase's header."""
        now = time.perf_counter()
        if text != "[1] device":
            print(f"  (phase took {now - t_phase[0]:.1f} s; {now - t_phase[1]:.1f} s so far)")
        t_phase[0] = now
        if text:
            print(text)

    header("[1] device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    header("[2] build")
    t0 = time.perf_counter()
    files = list(dict.fromkeys(k._file for k in kernels()))
    # Phase 37's user-operator set builds beside the built-in one, all ten
    # nvcc processes at once (the set with / in pdiv's place runs on these
    # libraries, whose set covers it); a failure of either raises here.
    user_build = {}
    thread = threading.Thread(target=lambda: user_build.update(done=_build_or_error(
        cuda_build, user_op_header(sr))))
    thread.start()
    cuda_build.build_all(files)
    thread.join()
    if isinstance(user_build.get("done"), BaseException):
        raise user_build["done"]
    for k in kernels():
        k.library()
    print(f"  {', '.join(files)}: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {', '.join(f'{cuda_build.build_seconds(f):.2f}' for f in files)} "
          f"s, in parallel)")
    for f, kname in (("program_eval.cu", "program_eval_kernel"),
                     ("program_multi.cu", "program_multi_kernel"),
                     ("program_grad.cu", "program_grad_kernel"),
                     ("program_predict.cu", "program_predict_kernel"),
                     ("program_predict_vjp.cu", "program_predict_vjp_kernel")):
        report = ptxas_report(cuda_build.build_log(f), kname)
        if not report:
            raise RuntimeError(f"no ptxas report for {kname} in the build of {f}")
        for name, regs, stack, spill_st, spill_ld in report:
            print(f"  ptxas {name}: {regs} registers, stack {stack} B, spill stores "
                  f"{spill_st} B, spill loads {spill_ld} B")

    header("[3] kernel #1 against its plain version")
    rows = [phase_kernel(torch, sr, dev)]

    header("[4] kernels #2 and #3 against their plain versions")
    rows += phase_opt_kernels(torch, sr, dev)

    header("[5] main path (constant optimizer on)")
    launches, f32_best = phase_main_path(torch, sr, dev, args.ncycles)
    for row in rows:
        row["launches"] = launches[row["name"]]

    header("[6] no-optimizer path")
    phase_no_optimizer(torch, sr, dev, args.ncycles_plain)

    header("[7] equation_search")
    phase_search(sr, dev, out_base)

    header("[8] kernels #4 and #5 against their plain versions")
    rows += phase_predict_kernels(torch, sr, dev)

    header("[9] template main path")
    launches = phase_template_main_path(torch, sr, dev)
    rows[3]["launches"] = launches["program_predict"]

    header("[10] template constant optimizer")
    launches = phase_template_optimizer(torch, sr, dev)
    rows[4]["launches"] = launches["program_predict_vjp"]

    header("[11] template composition search")
    phase_template_search(torch, sr, dev)

    header("[12] kernel #1p (parametric form of #1) against its plain version")
    rows.append(phase_param_kernel(torch, sr, dev))

    header("[13] parametric main path")
    launches = phase_parametric_main_path(torch, sr, dev)
    rows[5]["launches"] = launches["program_eval_param"]

    header("[14] parametric constant optimizer")
    phase_parametric_optimizer(torch, sr, dev)

    header("[15] parametric search and template search with parameters")
    phase_plugin_searches(torch, sr, dev)

    header("[16] kernels 1b and 2b (bf16 value buffers) against their plain versions")
    bf16_rows = phase_bf16_kernels(torch, sr, dev)
    rows += bf16_rows

    header("[17] graftstage cells")
    cells = phase_stage_cells(torch, sr, dev, args.ncycles_stage)
    bf16_rows[0]["launches"] = cells["plain-staged-bf16"]["program_eval_bf16"]

    header("[18] bf16 line search")
    launches = phase_bf16_line_search(torch, sr, dev, STAGE_LS_CYCLES, f32_best)
    bf16_rows[2]["launches"] = launches["program_multi_bf16"]

    header("[19] equation_search with staged_eval, eval_precision='bf16' and the bf16 line search")
    _, plaunches = phase_stage_search(torch, sr, dev)
    bf16_rows[1]["launches"] = plaunches["program_eval_param_bf16"]

    header("[20] batched main path (batching=True, batch_size 50)")
    blaunches = phase_batched_main_path(torch, sr, dev, rows)
    print(f"  launches of the batched main path (2 iterations): {blaunches}")

    header("[21] checkpoints and resume at full width")
    phase_checkpoint_resume(torch, sr, dev, out_base)

    header("[22] SRRegressor and MultitargetSRRegressor on the card")
    phase_regressor(torch, sr, dev)

    header("[23] telemetry at full width (optimizer cell and plain-staged cell)")
    phase_telemetry(torch, sr, dev, out_base, card)

    header("[24] the mini matrix's quality (12 non-sharded cells of benchmarks/baseline.json)")
    phase_quality(torch, sr, dev, out_base)

    header("[25] a stop between chunks of cycles (timeout at a quarter of an iteration)")
    phase_stop_between_chunks(torch, sr, dev, out_base)

    header("[26] every library loss on kernels #1-#3, and their float64 forms, against their "
          "plain versions")
    loss_rows = phase_loss_kernels(torch, sr, dev)
    rows += loss_rows

    header("[27] a logcosh search and float64 searches at the optimizer cell's width")
    slaunches = phase_loss_searches(torch, sr, dev)
    for row in loss_rows:
        name = row["name"]
        if name.endswith(" logcosh"):
            row["launches"] = slaunches["logcosh"][name[:-len(" logcosh")]]
        elif name == "program_eval_param_f64":
            row["launches"] = slaunches["parametric float64"][name]
        else:
            row["launches"] = slaunches["float64"][name]

    header("[28] the headline bench (python -m symbolicregression_jl_tpu_torch.bench.headline)")
    phase_headline(torch)

    header("[29] a user elementwise loss on kernels #4 and #5")
    phase_user_loss(torch, sr, dev)

    header("[30] robustness at the optimizer cell's width (retry, OOM, quarantine, SIGTERM, "
          "watchdog)")
    phase_robustness(torch, sr, dev, out_base)

    header("[31] zero-weight padding on kernels #1-#3 (6,000 rows against 8,192)")
    phase_padding(torch, sr, dev, card)

    header("[32] SearchServer with packing at the optimizer cell's widths")
    phase_server(torch, sr, dev, out_base, card)

    header("[33] ledger, pulse and gauge in turns, a fault's bundle, a profiler window, the "
           "load bench")
    phase_diagnostics(torch, sr, dev, out_base, card)

    header("[34] units at the optimizer cell's widths, in turns with the same search without")
    phase_units(torch, sr, dev, card)

    header("[35] a D template at the template cell's widths, its constant optimizer, #5's D "
           "values")
    phase_d_template(torch, sr, dev, card)

    header("[36] tooling: bench run/gate/trend, the cohort under debug_checks, the audits and "
           "guards")
    phase_tooling(torch, sr, dev, out_base, card)

    header("[37] user operators (gauss, softplus, pdiv) generated into kernels #1-#5")
    rows += phase_user_ops(torch, sr, dev, card)

    header("[38] the dtype forms: #4/#5 double, #4 bf16, 1b/2b with a float64 or bf16 loss "
           "spine, and their searches")
    drows, user_route = phase_dtype_forms(torch, sr, dev, card)
    for row in rows:
        if row["name"] in ("program_predict user ops", "program_predict_vjp user ops"):
            row["launches"] = user_route[row["name"][:-len(" user ops")]]
    rows += drows

    header("[39] multi-device search: a 1-rank nccl group, two gloo ranks on the card, the "
           "dedup exchange")
    per_rank, one_rank = phase_mesh(torch, sr, dev, out_base, card)
    for row in rows:
        if row["name"] in per_rank:
            row["mesh_launches_per_rank"] = per_rank[row["name"]]
            row["mesh_launches_1rank"] = one_rank[row["name"]]
            if not per_rank[row["name"]] or not one_rank[row["name"]]:
                raise RuntimeError(f"phase 39 launched {row['name']} no time")

    header("[40] data-row shards: two gloo ranks on the card, one block of the rows each "
           "(optimizer cell, template cell and optimizer, batching, staged_eval, a custom loss)")
    row_launches = phase_row_shards(torch, sr, dev, out_base, card)
    for row in rows:
        row["row_shard_launches_per_rank"] = row_launches.get(row["name"], 0)

    header("")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
