#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (weatherbenchx_tpu_torch) on one GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed N]

Phases, each printing progress lines; any failed check raises, so the
script exits nonzero:

1. Device: requires a CUDA device; prints the card's name and power limit.
2. Build: compiles the port's CUDA kernels from ops/csrc with nvcc, the
   register and sorted-runs kernels' generated translation units and the
   block sorts' source in parallel; prints the build time, the registers
   of every register and sorted-runs kernel (and of each other kernel, a
   line each) and fails unless every kernel of the build shows 0 bytes of
   stack frame and spills.
3. Kernels against their plain PyTorch versions on the card: several
   ensemble sizes and shapes, NaN members, |mean| >> std, float32 and
   bfloat16, 1-D input, and the main paths' own shapes; each route
   boundary (2, 63 and 64 members on the network, 65, 100, 101, 128, 129
   and 256 on the sorted runs, 257, 300, 1,817 and 7,424 on the block
   sort); a NaN at every member position (21 and 49 on the network, 101
   and 256 on the sorted runs, 300 and 7,424 on the block sort); +-inf
   members at 2, 3, 10, 19, 20, 21, 49, 50, 64, 65, 100, 101, 256, 257,
   300 and 7,424 members, every route, against the plain version and the
   JAX kernels' inf/NaN pattern (their sort body from 20 members, their
   pair body below); NaN and +-inf members on both sides of a run's edge,
   at the last member and on both sides of 256 members, in both dtypes
   (and on the merge sort at 58,113, 59,392, both sides of its change from
   4 to 8 runs and 2^20, on both sides of its runs' edge and its last
   merge's); members all +inf or all -inf (or all but one) at each run
   count, with padded runs, at 256, on the block sort at 257, 300, 1,817,
   7,424 and 58,112 and on the merge sort at 58,113, 59,392 and 2^20;
   every register kernel built, M = 2..64, and every run size
   of the sorted runs (33, 43, 50, 51, 64) at each run count it serves, in
   both dtypes; the cross kernel's tiled form at 160 x 300, 300 x 257,
   1,816 x 1,819 (one tile) and 1,900 x 2,000 (two); and the block sort's
   edges through the metrics (257, both sides of the first change of
   gridpoints per block, 7,424, one gridpoint's capacity 58,112, and on
   the merge sort 58,113, both sides of each change of its run count and
   2^20, over 96 points (2^20 over 4): the fused pass, the spread and, to
   8,192 members, the two-ensemble skill against float64, each launch
   counted; the block sorts timed there beside their bound), with +-inf
   and NaN members on both sides of a run's edge and of the first shared
   stage's half; and the merge sort at 58,113, 59,392 and 2^20 with ties
   across its edges and +-0.0, in both dtypes, two launches equal bit for
   bit.
4. Main path at full width: ChunkEvaluator with fair CRPS, the unbiased
   spread/skill ratio and the unbiased ensemble-mean RMSE over 3 chunks of
   a 50-member 0.25-degree ensemble (50 x 1 x 4 x 721 x 1440 float32,
   iid N(0, 1) from the seed), area-weighted over 3 regions and their land
   parts, masked. Checks one fused kernel launch per chunk, agreement with
   a float64 recomputation, and the closed forms for iid normals.
   4b. The same configuration at 101 members (ECMWF's extended-range
   ensemble: 100 perturbed members and the control), 2 chunks of
   101 x 1 x 4 x 721 x 1440 float32 (1.68 GB each on the card): the fused
   kernel's sorted runs. Checks one fused launch per chunk at 101 members,
   agreement within 1e-5 of a float64 recomputation, and each value
   within 6 standard errors of its closed form (the errors estimated from
   the points' own statistics); prints the seconds per chunk and the
   kernel's median time at that shape beside its plain version's.
   4c. HENS (Mahesh et al. 2024, arXiv:2408.03100) at its published width:
   7,424 members x 1 lead x 721 x 1440 float32 (30.83 GB a chunk), 2
   chunks (depth cut to 2 leads and one variable), each made on the card
   from the seed with a CUDA torch.Generator and dropped after its
   evaluation, through ChunkEvaluator: (a) fair CRPS, spread/skill and
   ensemble-mean RMSE against a deterministic target (one fused block-sort
   launch a chunk); (b) fair CRPS against a 10-member N(0.5, 1) analysis
   ensemble (one staged cross launch, 7,424 x 10, and one spread-only
   block-sort launch a chunk). Checks the launches and member counts; each
   kernel output on 16,384 points gathered across the grid within 1e-5 of
   its plain version and of float64; two launches on a chunk equal bit for
   bit; the metrics against float64 means of the kernels' per-point
   statistics and within 6 standard errors of the closed forms. Times the
   three kernels (median and IQR of 10 CUDA-event samples) beside their
   bytes bounds and the plain versions (over the chunk in 16 slices);
   prints the peak device memory.
   4d. A lagged-average HENS ensemble (Hoffman and Kalnay 1983), a
   construct past one point's block sort: 8 daily HENS inits valid at one
   time pooled into 59,392 members, one 0.25-degree field cut to a band of
   48 latitude rows (14 to 25.75 degrees N) x 1,440, 2 chunks of 16.42 GB
   made on the card, through ChunkEvaluator: fair CRPS, spread/skill,
   ensemble-mean RMSE and root mean variance against the target (one fused
   merge-sort launch a chunk) and the ensemble's spread E|X - X'| alone, a
   metric defined here (one spread-only launch, no cross). Checked as 4c
   (16,384 gathered points, two launches bit for bit, float64 means, the
   closed forms within 3 standard errors); times both kernels beside their
   bytes bound and the plain versions, logs a model of the bytes each call
   moves, its plan and its kernels' device time by torch.profiler, and the
   peak device memory.
5. Ensemble-vs-ensemble path at full width: pipeline.evaluate over
   in-memory stores, 50 forecast members (3 inits x 4 leads x 721 x 1440,
   iid N(0, 1)) against a 10-member ensemble analysis (8 valid times, iid
   N(0.5, 1)), 3 chunks of one init: energy-distance CRPS, fair CRPS and
   the unbiased ensemble-mean RMSE, same weights and bins, masked. Checks
   the launch counts (one cross and two spread launches per chunk, no
   fused), agreement with a float64 recomputation, and the closed forms.
6. The deterministic benchmark path at full width, through
   run_benchmark_evaluation's own construction (build_loaders,
   load_climatology, build_metrics, build_aggregator) over in-memory
   stores with ECMWF names: the registry default of hres_1440x721_2020,
   25 field-levels (6 upper-air variables x 500/700/850 hPa, 5 surface, 2
   precipitation) at 0.25 degrees, 2 chunks of 1 init x 12 leads 6 h
   apart, the 17 regions and their land parts (34 bins), area weights,
   masked. Data from the seed on the card: target = clim(doy, hour) +
   z_c(valid) + z_t and prediction = clim + z_c + z_p, z iid N(0, 1), so
   RMSE = sqrt(2), MSE = 2, bias = 0, ACC = 1/2, prediction activity =
   sqrt(2) and wind-vector RMSE = 2 (precipitation in metres, 1e-3 of
   those where they scale); SEEPS has no closed form. Every value within
   1e-5 of a float64 recomputation and within 6 standard errors of its
   closed form. Run twice: under the default resource budget (every
   climatology resident) and under WBX_RESOURCE_BYTES at half the
   climatology's size (the largest arrays host-gathered, SEEPS's p1
   resident); the two AggregationStates equal by torch.equal. Prints the
   seconds per chunk, the stage timers and the peak device memory.
7. The evaluation CLI (weatherbenchx_tpu_torch.apps.run_evaluation
   --device cuda, its main run in this process) on a small .npz store in
   a temporary directory: RMSE of
   N(0, 1) against N(0, 1) is sqrt(2); again from .wbx and netCDF copies
   of the stores, each equal to the .npz run bit for bit.
8. The benchmark CLI (weatherbenchx_tpu_torch.apps.run_benchmark_evaluation
   --device cuda, its main run in this process) on
   64 x 32 .npz stores with ECMWF names: the deterministic recipe above
   (RMSE = sqrt(2), ACC = 1/2) and --prediction=ens with 8 N(0, 1)
   members against N(0, 1) (CRPS = 1/sqrt(pi) = 0.5642, unbiased
   spread/skill = 1, ensemble-mean RMSE = sqrt(1 + 1/8)), with the fused
   kernel launched at least once per chunk; tolerances are 6 standard
   errors at the global bin's effective size. Both branches again from
   zarr v2 blosc-lz4 copies of the stores (one field per cell), writing
   zarr, wbx and netCDF outputs, each equal to its .npz run bit for bit,
   the ensemble run with the .npz run's fused launches.
9. The benchmark path of phase 6 from on-disk stores: phase 6's stores
   written by the port's writers into a git-ignored directory of the
   checkout (predictions zarr v2 consolidated, blosc-lz4 with byte shuffle,
   one (init, lead, level) field per cell; targets zarr v3 sharded with
   zstd; climatology .wbx), opened lazily through the CLI's construction
   (the configs' path), the AggregationState equal to phase 6's by
   torch.equal. Requires the native blockstore and zarr codec built and
   called (their call counts and seconds are printed); prints the write
   seconds and rates per container, the bytes on disk, the loaders'
   one-time preparation (timed apart from seconds per chunk, which are
   also printed with it counted in), the per-chunk stage timers with the
   native decode's share of each load, one chunk of targets read with and
   without the latitude flip, and seconds per chunk beside phase 6's
   in-memory figures of the same run; deletes the stores.
10. Timing with CUDA events: each kernel against its plain version at its
   path's shape (fused and spread at M = 50, spread at M = 10, cross 50 x
   10), beside its bound and beside a device-to-device copy of the 50-member
   ensemble (the card's streaming rate); the shared-memory form (fused and
   spread-only) at M = 100 over 4 x 721 x 1440, checked against and timed
   beside its plain versions, its bytes bound and its pair loop's; one
   whole eval_chunk, and the pipeline's seconds per chunk.
11. The metric families at full width (1 init x 4 leads x 721 x 1440,
   float32, from the seed), each through ChunkEvaluator.eval_chunk and
   metric_values over the 17 regions and their land parts (34 bins), area
   weights, masked: the fractions skill score (3 x 3 pixels, longitude
   wrapping) of two iid Bernoulli(1/2) fields, the rank histogram of a
   50-member iid ensemble (51 ranks), the relative economic value of an
   8-member probability against a boolean target (8 thresholds x 8
   cost/loss ratios); and RMSE and CSI (through ContinuousToBinary) binned
   by land/sea x 30-degree latitude bands x the hour of the lead time at
   once. Every value within 1e-5 (relative to |value|; the relative
   economic value, which crosses zero, to max(|value|, 1)) of a float64
   recomputation from the same inputs without the port's statistics,
   weights or bins (weatherbenchx_tpu_torch/bench_families.py); FSS
   near 0.9 and every rank near 1/51 within 6 standard errors; the same
   chunk evaluated twice equal by torch.equal; every tensor on the card;
   no kernel launch counted (these families are jnp in the JAX package,
   torch ops here). Prints per family the median and IQR of 12 eval_accum
   steps by CUDA events, the card's busy time within one step and its
   three longest kernels by torch.profiler, the host-fed eval_chunk and
   the peak device memory.

12. The station path: 6,000 METAR-like stations from the seed (hourly
   reports, ~97% arriving, ~1% filed twice, 2% of values QC-flagged, times
   within 15 minutes of the hour) against a 0.25-degree forecast of 2m
   temperature and 10 m wind speed, 8 inits x 41 leads (0-240 h), one init
   per chunk, through EvaluationPipeline on the card: the forecast
   interpolated to the stations by GridToSparseWithAltitudeAdjustment
   (bilinear, longitude wrapping, a seeded grid elevation); an in-memory
   station loader picks each station's closest report (first filed on
   ties) within 30 minutes, on a fixed index of every station, NaN mask,
   padded to a multiple of 1,024; masked aggregation over the index by
   BySets (3 station networks), init and lead kept; RMSE, bias and MAE; a
   chunk_stats_sink into a zarr v2 ZarrStatsStore (masked points NaN).
   Values within 1e-5 of a float64 numpy reference that does its own
   bilinear gather, altitude adjustment and report selection; the store
   read back with load_unaggregated, its sums per network within 1e-6 of
   the state (equality by torch.equal printed). Prints seconds per chunk,
   the interpolation's share, operand layouts built and the cost of one
   rebuild, peak memory. Sub-case: one chunk of a 50-member ensemble x 4
   leads at the stations (fair CRPS, spread/skill, ensemble-mean RMSE),
   exactly one fused launch with the sink on, and the fused kernel against
   its plain version on that NaN-padded station layout.
13. Unaggregated statistics at full width: one chunk of phase 6's
   configuration with chunk_stats_sink streaming every statistic (SEEPS's
   masked points NaN) into a zarr v2 blosc store in a git-ignored
   directory (free disk checked; variables cut only if it lacks room, and
   then said), deleted after; the state equal by torch.equal to the same
   chunk's without the sink; the sink's GB/s, bytes on disk and the cost
   of the host copies. Phase 8 also runs the benchmark CLI with
   --unaggregated_zarr into zarr v2 blosc and v3 sharded zstd stores.
14. Significance at scorecard size: a state with init_time kept, 366 inits
   x 41 leads x 34 bins x phase 6's 25 field-levels at 1.5 degrees, RMSE
   and bias of a main and a baseline forecast whose errors are AR(1) in
   init time (phi 0.6), main offset by 0.5, built by ChunkEvaluator.
   eval_accum from chunks made on the card; on it, t_test.IID,
   GeerAR2Corrected, LazarusHACEWC, IIDBootstrap and ClusterBootstrap (by
   day) with 1,000 replicates, the paired HAC-EWC for_baseline_comparison,
   and StationaryBootstrap on one field-level of one region. Checks: the
   IID standard error of RMSE against its float64 closed form, every
   method on the card against the same call on a CPU copy of three
   field-levels (1e-9 relative to max(|value|, 1)), the paired test's
   p-values below 0.01. Prints each method's seconds and peak memory.
15. Batched dispatch (chunks_per_dispatch), run beside the phases whose
   inputs it reuses; the batched path never drops to one chunk at a time
   but on a signature split, and the splits are counted and printed:
   (a) after phase 10, phase 4's 3 chunks through EvaluationPipeline at
   chunks_per_dispatch=3 (the chunks stacked on the card): exactly one
   fused launch for the three, the values within 1e-5 relative of phase
   4's per-chunk run and of the float64 recomputation, the peak device
   memory printed; (b) in phase 6, its configuration at
   chunks_per_dispatch=2 under both resource plans (resident, and the
   climatology host-gathered: the gather with a chunk dim at full width),
   each state within 1e-6 of phase 6's (max |diff| over max |value| per
   array), torch.equal printed; (c) after phase 14, its configuration
   through the pipeline (1.5 degrees, 25 field-levels, 41 leads, 34 bins,
   init_time kept, RMSE and bias) over 32 inits of in-memory stores at 1
   and 8 chunks per dispatch, the two states within 1e-5 (F64_RTOL: a
   GEMM of 8 times the rows sums in another float32 order), each run's
   seconds per chunk and eval_chunk_seconds, and from a profile_dir trace
   (observability.maybe_profile) its CUDA kernels and eager operator calls
   per chunk and the card's busy share; (d) after phase 8, on the host,
   its two benchmark CLI outputs (hres and ens) combined by
   apps/combine_results, rendered by apps/scorecard_html, and the page's
   self-test run on its generated logic by apps/jsmini, with the seconds
   of each (apps/scorecard_figure draws with matplotlib, which the card's
   machine lacks, so no phase calls it; the CPU tests cover it); (e) a
   ConstantLatencyWrapper (6 h) around an in-memory store like phase 7's
   through the pipeline on the card, equal by torch.equal to an unwrapped
   run of the nominal inits it maps to.

16. Ranks over torch.distributed, after phase 15, each rank a spawned
   process (multichip.run_ranks; the kernels built in phase 2, before any
   rank starts): (a) NCCL at world size 1 ('cpu:gloo,cuda:nccl'): phase
   4's 3 chunks through EvaluationPipeline(distributed=True) with a 1-rank
   mesh {'space': 1} over longitude, so the state's reductions are NCCL
   calls; (b) and (c) in one spawn of 2 gloo ranks, (b) then (c):
   (b) 2 gloo ranks sharing the card, distributed=True: rank 0
   evaluates chunks 0 and 2, rank 1 chunk 1 (2 and 1 fused launches), and
   both return the summed total; (c) 2 gloo ranks as a mesh, {'space': 2}
   with longitude sharded (one fused launch per chunk over 50 x 1 x 4 x
   721 x 720 on each rank) and {'ensemble': 2} with the members sharded
   (gathered first: one launch per chunk over all 50). Every rank's values
   within 1e-5 relative of phase 4's (torch.equal printed), its launches,
   the chunk its kernel saw, seconds per chunk, peak device memory and
   bytes gathered printed; (d) multichip.dryrun_multichip(4) on the card:
   its six phases on 4 gloo ranks sharing it, each equal to the direct
   result.
17. The randomized parity fuzz on the card, after phase 16
   (weatherbenchx_tpu_torch.parity_fuzz, the port's counterpart of
   tools/tpu_parity_fuzz.py): FUZZ_SEEDS seeds of each of the config,
   wrappers, spatial_rank and seeps families (19 x 36 grids, 4 inits x 3
   leads, 7 members, 5 target members; seed N draws as
   TestRandomizedConfigParity's seed N), each config run through
   compute_metric_values_for_single_chunk on the card and again on the
   CPU (the kernels' plain versions), held to atol and rtol 1e-5 with the
   key sets, dims and coords equal; and FUZZ_LARGE_K_SEEDS large_k seeds
   (the aggregation at 721 x 1440, 12-34 region bins, area weights, 3-5
   statistics x 2-4 leads) against a float64 contraction of the same
   weights and masks, at 2e-5 of max(|bin sum|, its row's RMS). Fails on
   any failure (a raise is one), unless the ensemble configs launched the
   fused kernel and the two-ensemble configs the cross and spread
   kernels. Prints per family the configs, the largest gap, the seconds on
   the card and on the CPU, the launches per kernel with the member counts
   they saw, and for large_k the rows and bins. Then the five layers'
   families, each held to its CPU run the same way: time_bins (every
   time unit of both packages' _extract_time_unit, sets of them, int
   seconds, edge bins and string and integer sets over datetimes from
   1900 to 2100 with sub-second parts, stacked with regions), sparse
   (0-40 stations through the loaders' interpolation, masks and padding),
   dispatch (3-7 chunks whose signatures change mid-stream through
   EvaluationPipeline at 1-8 chunks a dispatch), inference (the six
   methods on AR(1) states, float64, at rtol 1e-9) and large_members
   (CRPS, spread/skill and ensemble-mean RMSE at 65..70,000 members, also
   against a float64 run of the same draw), at FUZZ_SEEDS seeds each;
   large_members must launch the sorted runs, the block sort and the
   merge sort.
18. The drivers at full width, after phase 17, each stream run in a
   process of its own (python -m weatherbenchx_tpu_torch.tools.<name>),
   stores under DISK_STORE_DIR, deleted after: (a) stream_scale_demo's month, 31 inits
   x 50 members x 721 x 1440 as zarr v2 blosc (6.4 GB) at 4 inits per
   chunk: the fused launches equal to the CPU count per chunk times the
   chunks, CRPS, spread/skill and ensemble-mean RMSE within 1e-5 relative
   of a float64 run of the plain versions on the card over slabs made
   again from the store's seed; run again checkpointing every chunk,
   SIGKILLed once its manifest records 3 chunks, then rerun: its values
   equal to the uninterrupted run's by np.array_equal; the RSS at the end
   less the RSS after chunk 3 below one chunk's host bytes; one chunk's
   predictions read with and without the latitude flip, the native
   decode's share of the loads; (b) the 6-hourly year cut to 365 inits
   (4.5 GB .wbx, chunks of 32): RMSE per lead and region within 1e-5 of
   float64, the same RSS check; (c) the three examples in this process
   with --device cuda, their printed lines equal to their CPU runs (the
   ensemble example: one fused M = 8 launch per chunk), and the port's
   fixtures (made on the card, equal to the CPU's) through the canonical
   month drive of the benchmark CLI: RMSE within 2% of sqrt(2), ACC within
   0.02 of 1/2 in the global bin. Prints each run's per-chunk seconds,
   RSS, stage timers and native seconds.
19. The docs, after phase 18: each how-to notebook of
   weatherbenchx_tpu_torch/tools/make_notebooks built with the device
   cuda and its code cells run in this process (a fresh namespace each,
   no nbformat), every array that reaches a metric's statistics on the
   card, the printed numbers within 1e-5 relative (or one unit in the last
   printed digit) of the committed CPU notebooks in docs/torch/notebooks/;
   sparse_data (Parquet: pandas and pyarrow) is left out.

The whole script's seconds are printed before the last three lines: a
JSON object describing the three kernels, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

import argparse
import collections
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

M = 50
GRID = (1, 4, 721, 1440)  # init_time, lead_time, latitude, longitude
DEVICE = 'cuda'
N_CHUNKS = 3
# Tolerances, relative to max(|want|, 1), of a kernel against its plain
# version on identical input: float32 allows summation-order roundoff;
# bfloat16 outputs are rounded from float32 on both sides, so they may sit
# one bfloat16 step (2**-7 relative) apart.
KERNEL_RTOL = {'float32': 1e-5, 'bfloat16': 1e-2}
# Port metric values against the float64 recomputation.
F64_RTOL = 1e-5
# Closed forms for an iid N(0,1) ensemble against iid N(0,1) targets, with
# sampling tolerances of >= 7 standard errors for the smallest region
# (~1e5 gridpoints over 3 chunks).
CLOSED_FORMS = {'crps': (1 / math.sqrt(math.pi), 0.01),
                'spread_skill': (1.0, 0.02),
                'unbiased_mean_rmse': (1.0, 0.02)}
REGIONS = {'global': ((-90, 90), (0, 360)),
           'tropics': ((-20, 20), (0, 360)),
           'extratropics_north': ((20, 90), (0, 360))}
# The ensemble-vs-ensemble path: 50 forecast members against a 10-member
# ensemble analysis (ERA5's EDA member count), 3 inits 12 h apart, each
# one chunk of the GRID's 4 leads 6 h apart, so 8 valid times.
M_TARGETS = 10
N_ENS_INITS = 3
N_VALID = 8
TARGET_MEAN = 0.5
# E|X - Y| for X ~ N(0, 1), Y ~ N(0.5, 1): X - Y ~ N(-0.5, 2), so
# E|X - Y| = (2/sqrt(pi)) exp(-1/16) + 0.5 erf(1/4) = 1.198177; and
# E|X - X'| = E|Y - Y'| = 2/sqrt(pi). Tolerances: per-gridpoint standard
# deviations 0.113 (energy distance), 0.157 (CRPS) and 0.388 (unbiased
# ensemble-mean MSE) by simulation; the smallest bin (tropics land, ~93k
# gridpoints per init) has an area-weighted effective size of 278,660 over
# the 3 inits, so standard errors 2.1e-4, 3.0e-4 and 7.4e-4 (RMSE); the
# tolerances are 9.4, 10 and 8.2 of them.
E_ABS_XY = 2 / math.sqrt(math.pi) * math.exp(-1 / 16) + 0.5 * math.erf(0.25)
ENS_CLOSED_FORMS = {
    'energy_distance': (E_ABS_XY - 2 / math.sqrt(math.pi), 0.002),
    'crps': (E_ABS_XY - 1 / math.sqrt(math.pi), 0.003),
    'unbiased_mean_rmse': (TARGET_MEAN, 0.006),
}
# The CLI phase: N(0, 1) forecasts against N(0, 1) analyses on a 1.5-degree
# grid, 8 inits x 2 leads. RMSE = sqrt(2); its standard error in the
# northern-hemisphere bin (effective size 70,263) is 3.8e-3; the
# tolerance is 7.9 of them.
CLI_GRID = (121, 240)
CLI_RMSE_TOL = 0.03
# Member counts checked with a NaN at every member position: odd counts on
# the network route (the median's weight is 0), on the sorted runs 101
# (phase 4b's) and 256 (four full runs, the route's end), and on the block
# sort 300 and phase 4c's 7,424.
NAN_POSITION_MEMBERS = (21, 49, 101, 256, 300, 7424)
# Member counts checked with infinite members: both sides of the JAX
# kernels' sort threshold (20), of the register route's end (64) and of
# the sorted runs' (256), phase 4b's 101, and on the block sort 300 and
# phase 4c's 7,424.
INFINITY_MEMBERS = (2, 3, 10, 19, 20, 21, 49, 50, 64, 65, 100, 101, 256, 257,
                    300, 7424)
# Member counts checked with NaN and +-inf members at a run's edge: the
# sorted runs' ends and their changes of run count, on the block sort 257,
# 300 and 1,817 (members on both sides of 256, a run's edge there), and on
# the merge sort 58,113, phase 4d's 59,392, both sides of its change from 4
# to 8 runs and 2^20 (its first runs' edge and its last merge's).
RUN_EDGE_MEMBERS = (65, 100, 101, 128, 129, 192, 193, 256, 257, 300, 1817,
                    58113, 59392, 115712, 115713, 1 << 20)
# Member counts checked with every member (or all but one) at one
# infinity, where a merge walk exhausts a run and then meets only that
# infinity: each run count and padded runs, the sorted runs' end; on the
# block sort 257, 300, 1,817, 7,424 and one point's capacity, 58,112; on
# the merge sort 58,113, 59,392 and 2^20.
ONE_INFINITY_MEMBERS = (65, 67, 100, 128, 129, 130, 192, 193, 205, 256, 257,
                        300, 1817, 7424, 58112, 58113, 59392, 1 << 20)
# The H100 SXM's HBM rate, and its float32 issue rate for operations that
# are not FMAs (min, max, add, subtract): 128 per clock per SM x 132 SMs x
# 1.98 GHz; the data sheet's 67 TFLOP/s counts an FMA as two. For the
# kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
# Calls per timed sample (time_cuda), for kernels and plain versions alike.
TIMING_REPS = 20
# ... and for the block sorts at phase 3's shapes (96 points).
MEMBER_TILE_TIMING_REPS = 2
# The sorted-runs form's members at phase 10's wide shape, and its seed.
SORTED_M = 100
SORTED_SEED = 100
# Phase 4b: the main path's configuration at 101 members, 2 chunks, its
# closed forms checked within LARGE_SIGMAS standard errors.
M_LARGE = 101
N_LARGE_CHUNKS = 2
LARGE_SIGMAS = 6.0
# Phase 4c: HENS (Mahesh et al. 2024, "Huge Ensembles Part I",
# arXiv:2408.03100): 7,424 SFNO members at 0.25 degrees, scored by CRPS and
# spread/skill; depth cut to one variable and 2 leads, one a chunk (30.83
# GB of float32 each), made on the card; the CRPS against ensemble targets
# takes a 10-member analysis ensemble (ERA5's EDA count), N(0.5, 1).
M_HENS = 7424
HENS_GRID = (1, 1, 721, 1440)
N_HENS_CHUNKS = 2
# Gridpoints gathered across the grid where each kernel output is held to
# its plain version and float64; slices of the chunk the plain versions
# are timed over (a whole chunk's sort would not fit the card twice); CUDA
# event samples per kernel.
HENS_GATHER = 16384
HENS_PLAIN_SLICES = 16
HENS_TIMING_SAMPLES = 10
# Phase 4d: a lagged-average ensemble (Hoffman and Kalnay 1983, Tellus
# 35A) of HENS, a construct: 8 consecutive daily HENS inits valid at one
# time, pooled into 8 x 7,424 = 59,392 members, past one point's block sort
# (58,112). One 0.25-degree field cut to a band of 48 latitude rows (14 to
# 25.75 degrees N, so that the tropics and the northern extratropics both
# meet it) x 1,440 longitudes, 2 chunks of 16.42 GB made on the card; the
# closed forms checked within LAGGED_SIGMAS standard errors.
M_LAGGED = 8 * M_HENS
LAGGED_ROWS = range(416, 464)  # of the ascending 0.25-degree latitudes
N_LAGGED_CHUNKS = 2
LAGGED_SIGMAS = 3.0
# E|X - X'| for X, X' iid N(0, 1): the spread metric's closed form.
SPREAD_CLOSED_FORM = 2 / math.sqrt(math.pi)


def log(msg: str) -> None:
  print(msg, flush=True)


def card_line() -> str:
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0]


def rel_err(got, want):
  """(NaN, +inf and -inf patterns equal, max |got-want| / max(|want|, 1)
  and max abs err over the points where want is finite)."""
  import torch
  got, want = got.double(), want.double()
  same_nan = all(bool(torch.equal(f(got), f(want)))
                 for f in (torch.isnan, torch.isposinf, torch.isneginf))
  ok = torch.isfinite(want)
  diff = (got[ok] - want[ok]).abs()
  if diff.numel() == 0:
    return same_nan, 0.0, 0.0
  rel = (diff / want[ok].abs().clamp(min=1.0)).max().item()
  return same_nan, rel, diff.max().item()


def check_kernels(seed: int) -> dict:
  """Phase 3: both kernels against their plain versions on the card."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  rng = np.random.default_rng(seed)
  # (members, rest shape, NaN at (member, flat point) or None, offset, scale)
  cases = [
      (2, (1000,), None, 0.0, 1.0),
      (3, (1000,), (1, 17), 0.0, 1.0),
      (8, (3, 2, 37, 71), None, 0.0, 1.0),
      (21, (1, 2, 37, 71), (10, 500), 0.0, 1.0),
      (50, (4, 777), None, 288.0, 3.0),
      (50, (1, 2, 37, 71), (49, 0), 0.0, 1.0),
      # The route boundaries (the network from 2 members, the sorted runs
      # past 64, the block sort past 256), the changes of run count, the
      # block sort at 300, 1,817 and phase 4c's 7,424, and the ensemble
      # path's 10 members.
      (2, (2, 37, 71), (1, 700), 0.0, 1.0),
      (10, (2, 37, 71), (5, 700), 0.0, 1.0),
      (63, (2, 37, 71), (0, 700), 0.0, 1.0),
      (64, (2, 37, 71), (63, 700), 0.0, 1.0),
      (65, (2, 37, 71), (32, 700), 288.0, 3.0),
      (100, (2, 37, 71), (50, 700), 0.0, 1.0),
      (101, (2, 37, 71), (100, 700), 288.0, 3.0),
      (128, (1, 37, 71), (64, 70), 0.0, 1.0),
      (129, (1, 37, 71), (0, 70), 0.0, 1.0),
      (256, (1, 37, 71), (255, 70), 288.0, 3.0),
      (257, (1, 37, 71), (256, 70), 0.0, 1.0),
      (300, (2, 99), (150, 7), 288.0, 3.0),
      (1817, (1, 99), (1816, 98), 0.0, 1.0),
      (7424, (1, 40), (3712, 3), 288.0, 3.0),
      (M, GRID, None, 0.0, 1.0),
  ]
  main_path_err = {}
  for dtype in (torch.float32, torch.bfloat16):
    dname = str(dtype).split('.')[-1]
    for m, rest, nan_at, offset, scale in cases:
      if rest == GRID and dtype != torch.float32:
        continue  # the main path runs float32
      x = (offset + scale * rng.standard_normal((m,) + rest, dtype=np.float32))
      y = (offset + scale * rng.standard_normal(rest, dtype=np.float32))
      if nan_at is not None:
        x.reshape(m, -1)[nan_at] = np.nan
      xd = torch.from_numpy(x).to(DEVICE, dtype)
      yd = torch.from_numpy(y).to(DEVICE, dtype)
      got = cp.fused_ensemble_stats(xd, yd) + (cp.pairwise_spread_sum(xd),)
      want = cp.fused_ensemble_stats_plain(xd, yd) + (
          cp.pairwise_spread_sum_plain(xd),)
      torch.cuda.synchronize()
      names = ('spread_sum', 'skill_sum', 'mean', 'sq_dev_sum', 'spread_only')
      worst = 0.0
      for name, g, w in zip(names, got, want):
        same_nan, rel, abs_err = rel_err(g, w)
        if not same_nan:
          raise AssertionError(f'{name} M={m} rest={rest} {dname}: NaN '
                               'pattern differs from the plain version')
        if rel > KERNEL_RTOL[dname]:
          raise AssertionError(f'{name} M={m} rest={rest} {dname}: rel err '
                               f'{rel:.3g} > {KERNEL_RTOL[dname]}')
        worst = max(worst, rel)
        if rest == GRID:
          main_path_err[name] = abs_err
      if nan_at is not None and not all(
          bool(torch.isnan(g.reshape(-1)[nan_at[1]])) for g in got):
        raise AssertionError(f'M={m}: NaN member did not poison its point')
      log(f'kernel check M={m} ({cp.spread_form(m)}) rest={rest} {dname} '
          f'nan={nan_at is not None} offset={offset}: max rel err '
          f'{worst:.3g} (tol {KERNEL_RTOL[dname]}) ok')
  check_nan_positions(rng)
  check_infinities(rng)
  check_run_edges(rng)
  check_one_infinity(rng)
  check_every_register_kernel(rng)
  check_every_run_size(rng)
  main_path_err['cross'] = check_cross_kernel(rng)
  check_member_tiles(rng)
  return main_path_err


def stats_against_plain(x, y, label: str, dname: str) -> tuple:
  """The fused and spread-only kernels against their plain versions on
  x (M, N) and y (N); returns the five outputs. Raises unless every output
  has the plain version's NaN and +-inf pattern and is within
  KERNEL_RTOL."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  got = cp._launch_stats(x, y) + (cp._launch_stats(x, None),)
  want = cp.fused_ensemble_stats_plain(x, y) + (
      cp.pairwise_spread_sum_plain(x),)
  torch.cuda.synchronize()
  names = ('spread_sum', 'skill_sum', 'mean', 'sq_dev_sum', 'spread_only')
  for name, g, w in zip(names, got, want):
    same, rel, _ = rel_err(g, w)
    if not same:
      raise AssertionError(f'{label} {name} {dname}: NaN/inf pattern differs '
                           'from the plain version')
    if rel > KERNEL_RTOL[dname]:
      raise AssertionError(f'{label} {name} {dname}: rel err {rel:.3g} > '
                           f'{KERNEL_RTOL[dname]}')
  return got


def check_nan_positions(rng) -> None:
  """On the network, sorted-runs and block-sort routes, whose sorts drop
  NaN through fminf/fmaxf: point p holds a NaN at member p, for every p;
  each output must be NaN there and nowhere else."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  for m in NAN_POSITION_MEMBERS:
    form = cp.spread_form(m)
    if form not in ('network', 'sorted', 'blocksort'):
      raise AssertionError(f'M={m} takes the {form} route')
    n = max(4000, m + 40)
    x = rng.standard_normal((m, n), dtype=np.float32)
    for p in range(m):
      x[p, p] = np.nan
    y = rng.standard_normal(n, dtype=np.float32)
    for dtype in (torch.float32, torch.bfloat16):
      dname = str(dtype).split('.')[-1]
      got = stats_against_plain(torch.from_numpy(x).to(DEVICE, dtype),
                                torch.from_numpy(y).to(DEVICE, dtype),
                                f'NaN positions M={m}', dname)
      want = torch.arange(n, device=DEVICE) < m
      if not all(torch.equal(torch.isnan(g), want) for g in got):
        raise AssertionError(f'M={m}: a NaN member must poison its own '
                             'point, at every member position, and no other')
      log(f'kernel check M={m} ({form}) {dname}: a NaN at each of the {m} '
          'member positions poisons its own point only ok')


def jax_infinite_spread(m: int, n_pos: int, n_neg: int) -> float:
  """The JAX kernels' spread of m members, n_pos of them +inf and n_neg
  -inf: their sort body (from 20 members) weights rank k by 2k - m - 1 and
  leaves the zero weight out, so terms of both signs (NaN) appear once
  2 n_pos > m + 1 or 2 n_neg > m + 1; their pair body (below 20) takes
  |inf - inf| = NaN for two members at one infinity."""
  nan = 2 * n_pos > m + 1 or 2 * n_neg > m + 1
  if m < 20:
    nan = nan or n_pos > 1 or n_neg > 1
  return math.nan if nan else math.inf


def check_infinities(rng) -> None:
  """Every route (the network to 64 members, the sorted runs to 256, the
  block sort past them), both dtypes:
  +-inf members in seven columns (one +inf; one -inf; one of each; two
  +inf; m//2 + 1 +inf; m//2 + 1 -inf; m//2 + 2 +inf) give the plain
  version's inf and NaN points, which are the JAX kernels'."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  for m in INFINITY_MEMBERS:
    x = rng.standard_normal((m, 1000), dtype=np.float32)
    counts = [(1, 0), (0, 1), (1, 1), (2, 0), (m // 2 + 1, 0),
              (0, m // 2 + 1), (m // 2 + 2, 0)]
    want = []
    for col, (n_pos, n_neg) in enumerate(counts):
      n_pos = min(n_pos, m)
      rows = rng.permutation(m)
      x[rows[:n_pos], col] = np.inf
      x[rows[n_pos:n_pos + n_neg], col] = -np.inf
      want.append(jax_infinite_spread(m, n_pos, n_neg))
    y = rng.standard_normal(1000, dtype=np.float32)
    for dtype in (torch.float32, torch.bfloat16):
      dname = str(dtype).split('.')[-1]
      got = stats_against_plain(torch.from_numpy(x).to(DEVICE, dtype),
                                torch.from_numpy(y).to(DEVICE, dtype),
                                f'infinities M={m}', dname)
      head = got[4][:7].float().cpu().numpy()
      if not (np.array_equal(np.isnan(head), np.isnan(want))
              and np.array_equal(np.isposinf(head), np.isposinf(want))
              and bool(torch.isfinite(got[4][7:]).all())):
        raise AssertionError(f'M={m}: spread at the infinite points {head}, '
                             f'the JAX kernels give {want}')
      log(f'kernel check M={m} ({cp.spread_form(m)}) {dname}: +-inf members '
          f'give the plain version\'s and the JAX kernels\' inf/NaN points '
          f'{head.tolist()} ok')


def run_edge(m: int) -> int:
  """The first member of a second run: the sorted runs' run size, the
  block sort's 256 (a run's edge there), the merge sort's run size."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  form = cp.spread_form(m)
  if form == 'sorted':
    return cp.sorted_runs(m)[1]
  return cp.merge_runs(m)[1] if form == 'mergesort' else cp.SORTED_MAX_MEMBERS


def edge_points(m: int) -> int:
  """Points of an edge check: 2,000, fewer past 32,768 members (64 at
  2^20), so that a check's input stays near 256 MB."""
  return max(64, min(2000, 2 ** 26 // m))


def check_run_edges(rng) -> None:
  """The sorted runs (and on the block sort 257, 300 and 1,817 members,
  where 256 is a run's edge; and on the merge sort past 58,112, where the
  runs' edge is its run size and the last merge's the middle of its runs)
  in both dtypes: +inf, -inf and NaN members at the last member of the
  first run, the first of the second, both, the last member, and on the
  merge sort both sides of the last merge's edge, against the plain
  versions; each NaN poisons its point."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  for m in RUN_EDGE_MEMBERS:
    form = cp.spread_form(m)
    edge = run_edge(m)
    n = edge_points(m)
    x = rng.standard_normal((m, n), dtype=np.float32)
    cols = [((edge - 1,), np.inf), ((edge,), np.inf),
            ((edge - 1, edge), np.inf), ((edge - 1,), -np.inf),
            ((edge,), -np.inf), ((m - 1,), np.inf), ((m - 1,), -np.inf),
            ((edge - 1,), np.nan), ((edge,), np.nan), ((m - 1,), np.nan)]
    if form == 'mergesort':
      runs, size = cp.merge_runs(m)
      mid = runs // 2 * size
      cols += [((mid - 1,), np.inf), ((mid,), -np.inf),
               ((mid - 1, mid), -np.inf), ((mid - 1,), np.nan),
               ((mid,), np.nan)]
    for col, (rows, value) in enumerate(cols):
      x[list(rows), col] = value
    y = rng.standard_normal(n, dtype=np.float32)
    nan_cols = [c for c, (_, v) in enumerate(cols) if np.isnan(v)]
    for dtype in (torch.float32, torch.bfloat16):
      dname = str(dtype).split('.')[-1]
      got = stats_against_plain(torch.from_numpy(x).to(DEVICE, dtype),
                                torch.from_numpy(y).to(DEVICE, dtype),
                                f'run edges M={m}', dname)
      if not all(bool(torch.isnan(g[nan_cols]).all()) for g in got):
        raise AssertionError(f'M={m} {dname}: a NaN member at a run edge '
                             'did not poison its point')
      where = (f'members {edge - 1}, {edge} and {m - 1}'
               + (', and the last merge\'s edge' if form == 'mergesort'
                  else ''))
      log(f'kernel check M={m} ({form}) {dname}: +-inf and NaN members at '
          f'{where} give the plain version\'s points ok ({n} points)')


def check_one_infinity(rng) -> None:
  """Both dtypes: a point whose members are all +inf (or all -inf), all
  but one finite member (in the first run, in the last), all but one of
  the other infinity (in the second run), and m//2 + 2 at one infinity.
  A merge walk toward that infinity exhausts a run and then meets only the
  infinity, so the exhausted run keeps winning the tie and must read no
  row past its end; the block sort's compare-exchanges meet only that
  infinity and the +inf past M, which none may move: each point NaN, as
  the plain version's, and the finite points within KERNEL_RTOL."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  for m in ONE_INFINITY_MEMBERS:
    edge = run_edge(m)
    n = edge_points(m)
    for value in (np.inf, -np.inf):
      x = rng.standard_normal((m, n), dtype=np.float32)
      x[:, :4] = value
      x[0, 1] = 0.0
      x[m - 1, 2] = 0.0
      x[edge, 3] = -value
      x[:m // 2 + 2, 4] = value
      y = rng.standard_normal(n, dtype=np.float32)
      for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        got = stats_against_plain(torch.from_numpy(x).to(DEVICE, dtype),
                                  torch.from_numpy(y).to(DEVICE, dtype),
                                  f'one infinity {value} M={m}', dname)
        if not (bool(torch.isnan(got[0][:5]).all())
                and bool(torch.isnan(got[4][:5]).all())
                and bool(torch.isfinite(got[4][5:]).all())):
          raise AssertionError(f'M={m} {dname} {value}: spread at the '
                               'infinite points not NaN')
    log(f'kernel check M={m} ({cp.spread_form(m)}): members all +inf, all '
        '-inf, all but one, float32 and bfloat16, give the plain '
        'version\'s NaN points ok')


def check_every_run_size(rng) -> None:
  """Each sorted-runs kernel built (``SORTED_RUN_SIZES``), at the smallest
  member count that takes it at each run count, fused and spread-only,
  against the plain versions: a NaN member, a +inf and a -inf at other
  points, |mean| >> std."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  cases = {}
  for m in cp.SORTED_MEMBERS:
    runs, r = cp.sorted_runs(m)
    cases.setdefault((r, runs), m)
  sizes = sorted({r for r, _ in cases})
  if sizes != list(cp.SORTED_RUN_SIZES):
    raise AssertionError(f'run sizes {sizes}')
  for dtype in (torch.float32, torch.bfloat16):
    dname = str(dtype).split('.')[-1]
    for (r, runs), m in sorted(cases.items()):
      x = 288 + 3 * rng.standard_normal((m, 3000), dtype=np.float32)
      x[m // 2, 0] = np.nan
      x[0, 1] = np.inf
      x[m - 1, 2] = -np.inf
      y = 288 + 3 * rng.standard_normal(3000, dtype=np.float32)
      got = stats_against_plain(torch.from_numpy(x).to(DEVICE, dtype),
                                torch.from_numpy(y).to(DEVICE, dtype),
                                f'runs of {r} (M={m})', dname)
      if not all(bool(torch.isnan(g[0])) for g in got):
        raise AssertionError(f'{runs} runs of {r} {dname}: NaN member did '
                             'not poison its point')
    log(f'kernel check: {len(sizes)} sorted-runs kernels (R = '
        f'{", ".join(map(str, sizes))}) at M = '
        f'{", ".join(str(m) for _, m in sorted(cases.items()))} {dname}, '
        'fused and spread-only, against the plain versions ok')


def check_every_register_kernel(rng) -> None:
  """Each register kernel built, M = 2..64, fused and spread-only, against
  the plain versions: a NaN member, a +inf and a -inf at other points.
  Raises after all kernels, naming every one that failed."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  failed = []
  for dtype in (torch.float32, torch.bfloat16):
    dname = str(dtype).split('.')[-1]
    for m in cp.REGISTER_MEMBERS:
      x = rng.standard_normal((m, 3000), dtype=np.float32)
      x[m // 2, 0] = np.nan
      x[0, 1] = np.inf
      x[m - 1, 2] = -np.inf
      y = rng.standard_normal(3000, dtype=np.float32)
      try:
        got = stats_against_plain(torch.from_numpy(x).to(DEVICE, dtype),
                                  torch.from_numpy(y).to(DEVICE, dtype),
                                  f'M={m}', dname)
        if not all(bool(torch.isnan(g[0])) for g in got):
          raise AssertionError(f'M={m} {dname}: NaN member did not poison '
                               'its point')
      except AssertionError as e:
        failed.append(str(e))
    log(f'kernel check: {len(cp.REGISTER_MEMBERS)} register kernels (M) '
        f'{dname}, fused and spread-only, against the plain versions')
  if failed:
    raise AssertionError(f'{len(failed)} register kernel checks failed:\n'
                         + '\n'.join(failed))
  log('kernel check: every register kernel matches the plain versions ok')


def check_cross_kernel(rng) -> float:
  """The cross kernel against its plain version; max abs err at the path's
  shape."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  # (Mx, My, rest shape, NaN at (side, member, flat point) or None, offset,
  # scale)
  cases = [
      (1, 1, (1000,), None, 0.0, 1.0),
      (3, 5, (3, 2, 37, 71), None, 0.0, 1.0),
      (8, 2, (1, 2, 37, 71), ('x', 7, 500), 0.0, 1.0),
      (25, 25, (1, 2, 37, 71), ('y', 24, 0), 0.0, 1.0),
      (50, 10, (4, 777), None, 288.0, 3.0),
      (50, 50, (1, 2, 37, 71), ('y', 3, 4000), 0.0, 1.0),
      (6, 4, (), None, 0.0, 1.0),  # 1-D input
      # Two large ensembles: the tiled form past 8,192 pairs, one tile
      # (the smaller side to 1,816 members) and two.
      (160, 300, (2, 61), ('y', 299, 0), 288.0, 3.0),
      (300, 257, (3, 41), ('y', 128, 7), 0.0, 1.0),
      (1816, 1819, (2, 50), ('x', 1815, 99), 0.0, 1.0),
      (1900, 2000, (2, 50), ('x', 1899, 99), 0.0, 1.0),
      (M, M_TARGETS, GRID, None, 0.0, 1.0),
  ]
  path_err = None
  for dtype in (torch.float32, torch.bfloat16):
    dname = str(dtype).split('.')[-1]
    for mx, my, rest, nan_at, offset, scale in cases:
      if rest == GRID and dtype != torch.float32:
        continue  # the path runs float32
      x = offset + scale * rng.standard_normal((mx,) + rest, dtype=np.float32)
      y = offset + scale * rng.standard_normal((my,) + rest, dtype=np.float32)
      if nan_at is not None:
        side, member, point = nan_at
        poisoned = x if side == 'x' else y
        poisoned.reshape(poisoned.shape[0], -1)[member, point] = np.nan
      xd = torch.from_numpy(x).to(DEVICE, dtype)
      yd = torch.from_numpy(y).to(DEVICE, dtype)
      got = cp.pairwise_cross_sum(xd, yd)
      want = cp.pairwise_cross_sum_plain(xd, yd)
      torch.cuda.synchronize()
      same_nan, rel, abs_err = rel_err(got, want)
      if got.shape != rest or got.dtype != dtype:
        raise AssertionError(f'cross Mx={mx} My={my} {dname}: shape '
                             f'{tuple(got.shape)} dtype {got.dtype}')
      if not same_nan:
        raise AssertionError(f'cross Mx={mx} My={my} rest={rest} {dname}: '
                             'NaN pattern differs from the plain version')
      if rel > KERNEL_RTOL[dname]:
        raise AssertionError(f'cross Mx={mx} My={my} rest={rest} {dname}: '
                             f'rel err {rel:.3g} > {KERNEL_RTOL[dname]}')
      if nan_at is not None and not (
          bool(torch.isnan(got.reshape(-1)[nan_at[2]]))
          and int(torch.isnan(got).sum()) == 1):
        raise AssertionError(f'cross Mx={mx} My={my}: a NaN member must '
                             'poison its own point and no other')
      if rest == GRID:
        path_err = abs_err
      log(f'cross kernel check Mx={mx} My={my} '
          f'rest={rest} {dname} nan={nan_at is not None} offset={offset}: '
          f'max rel err {rel:.3g} (tol {KERNEL_RTOL[dname]}) ok')
  return path_err


def pair_sum_f64(a, b):
  """sum_{i,j} |a_i - b_j| per point by the float64 broadcast, as many
  points at a time as keep the broadcast near 2 GB: the definition,
  written out here."""
  import torch
  step = max(1, 2 ** 28 // (a.shape[0] * b.shape[0]))
  return torch.cat([(a[:, None, lo:lo + step] - b[None, :, lo:lo + step])
                    .abs().sum((0, 1)) for lo in range(0, a.shape[1], step)])


def spread_f64(x):
  """sum_{i != j} |x_i - x_j| per point in float64 from the sorted members:
  2 sum_k gap_k k (m - k), every term >= 0 (the broadcast would not fit the
  card at 58,112 members)."""
  import torch
  s = torch.sort(x.double(), dim=0).values
  m = s.shape[0]
  k = torch.arange(1, m, device=x.device, dtype=torch.float64)
  return 2 * ((s[1:] - s[:-1]) * (k * (m - k))[:, None]).sum(0)


def blocksort_edges() -> tuple:
  """The block sort's edges: its first count; both sides of the first
  change of gridpoints per block; phase 4c's 7,424; one gridpoint's
  capacity, 58,112; and past it the merge sort's: 58,113, both sides of
  each change of its run count (4 to 8 runs at 4 MERGESORT_RUN_MAX, ...,
  32 to 64) and the kernels' last count, 2^20."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  first = cp.BLOCKSORT_MEMBERS[0]
  change = next(m for m in cp.BLOCKSORT_MEMBERS
                if cp.blocksort_config(m)[0] < cp.blocksort_config(first)[0])
  top = cp.BLOCKSORT_MAX_MEMBERS
  edges = (first, change - 1, change, M_HENS, top, top + 1)
  runs = cp.merge_runs(top + 1)[0]
  while runs * cp.MERGESORT_RUN_MAX < cp.MAX_MEMBERS:
    edges += (runs * cp.MERGESORT_RUN_MAX, runs * cp.MERGESORT_RUN_MAX + 1)
    runs *= 2
  return edges + (cp.MAX_MEMBERS,)


def check_member_tiles(rng) -> None:
  """The block sort's and the merge sort's edges (blocksort_edges) through
  the metrics: the fused pass, the spread outside a pass and, to 8,192
  members, the two-ensemble skill against M + 3 members (the cross
  kernel's tiled form, one to five tiles), each against float64 and
  launched once; over 96 points, 4 at 2^20. Then +-inf and NaN members on
  both sides of a run's edge and of the first shared stage's half at
  7,424 members, against the plain versions; and the merge sort's ties and
  signed zeros (check_mergesort_ties). The counts to 8,192 are timed
  (time_member_tiles)."""
  import torch
  from weatherbenchx_tpu_torch.darray import DimArray
  from weatherbenchx_tpu_torch.metrics import base, probabilistic
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  for m in blocksort_edges():
    small = m <= 8192
    n = 4 if m == cp.MAX_MEMBERS else 96
    x = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32))
    y = torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
    yt = torch.from_numpy(rng.standard_normal((m + 3, n), dtype=np.float32))
    x[m - 5, 1] = float('nan')
    preds = {'v': DimArray(x.to(DEVICE), ('number', 'point'))}
    tgts = {'v': DimArray(y.to(DEVICE), ('point',))}
    ens_tgts = {'v': DimArray(yt.to(DEVICE), ('number', 'point'))}
    cp.reset_launch_counts()
    with base.computation_cache():
      got = {
          'fused skill': probabilistic.CRPSSkill().compute(preds, tgts)['v'],
          'fused spread': probabilistic.CRPSSpread().compute(preds, tgts)['v'],
          'fused variance': probabilistic.EnsembleVariance().compute(
              preds, tgts)['v'],
      }
    got['spread'] = probabilistic.CRPSSpread().compute(preds, tgts)['v']
    if small:
      got['cross'] = probabilistic.CRPSSkill().compute(preds, ens_tgts)['v']
    torch.cuda.synchronize()
    want_launches = {'fused_ensemble_stats': 1, 'pairwise_spread_sum': 1,
                     'pairwise_cross_sum': int(small)}
    if cp.LAUNCHES != want_launches:
      raise AssertionError(f'M={m}: launches {cp.LAUNCHES}, want '
                           f'{want_launches}')
    xd, yd, ytd = (t.to(DEVICE, torch.float64) for t in (x, y, yt))
    spread = spread_f64(xd) / (m * (m - 1))
    want = {'fused skill': (xd - yd).abs().mean(0), 'fused spread': spread,
            'fused variance': xd.var(0, correction=1), 'spread': spread}
    if small:
      want['cross'] = pair_sum_f64(xd, ytd) / (m * (m + 3))
    worst = 0.0
    for name, da in got.items():
      if da.device.type != DEVICE or da.dtype != torch.float32:
        raise AssertionError(f'M={m} {name}: {da.device} {da.dtype}')
      same_nan, rel, _ = rel_err(da.data, want[name])
      if not same_nan or not bool(torch.isnan(da.data[1])):
        raise AssertionError(f'M={m} {name}: NaN pattern differs')
      if rel > KERNEL_RTOL['float32']:
        raise AssertionError(f'M={m} {name}: rel err vs float64 {rel:.3g} > '
                             f'{KERNEL_RTOL["float32"]}')
      worst = max(worst, rel)
    cross = f', cross against {m + 3}' if small else ''
    log(f'block sort edge M={m} ({cp.spread_form(m)}, {n} points{cross}): '
        f'fused pass and spread launched once each, max rel err vs float64 '
        f'{worst:.3g} (tol {KERNEL_RTOL["float32"]}) ok')
    if small:
      time_member_tiles(x.to(DEVICE), y.to(DEVICE))
  m = M_HENS
  half = 1 << ((m - 1).bit_length() - 1)
  x = rng.standard_normal((m, 96), dtype=np.float32)
  x[3, 0] = x[half + 3, 1] = np.inf
  x[31, 2] = x[32, 2] = -np.inf
  x[half - 1, 3], x[half, 3] = np.inf, -np.inf
  x[m - 1, 4] = np.nan
  x[half - 1, 5] = np.nan
  y = rng.standard_normal(96, dtype=np.float32)
  for dtype in (torch.float32, torch.bfloat16):
    dname = str(dtype).split('.')[-1]
    stats_against_plain(torch.from_numpy(x).to(DEVICE, dtype),
                        torch.from_numpy(y).to(DEVICE, dtype),
                        f'block sort edges M={m}', dname)
    log(f'block sort edge check M={m} {dname}: +-inf and NaN members at a '
        f'run\'s edge (31, 32) and the first shared stage\'s ({half - 1}, '
        f'{half}) give the plain version\'s points ok')
  check_mergesort_ties(rng)


def check_mergesort_ties(rng) -> None:
  """The merge sort at 58,113, phase 4d's 59,392 and 2^20, both dtypes:
  members quantized to 0.5 (ties in every run and across each edge), the
  members at the runs' edge and the last merge's equal, +-0.0 mixed, all
  -0.0 but one 1.5 (the spread exactly 2 x 1.5 (M - 1) in float32): the
  plain versions' values; and two launches equal bit for bit."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  for m in (cp.BLOCKSORT_MAX_MEMBERS + 1, M_LAGGED, cp.MAX_MEMBERS):
    n = edge_points(m)
    runs, size = cp.merge_runs(m)
    mid = runs // 2 * size
    x = (np.round(2 * rng.standard_normal((m, n))) / 2).astype(np.float32)
    x[[size - 1, size, mid - 1, mid], 0] = 0.5
    x[:, 1] = np.where(rng.random(m) < 0.5, np.float32(-0.0),
                       np.float32(0.0))
    x[:, 2] = np.float32(-0.0)
    x[m // 3, 2] = 1.5
    y = rng.standard_normal(n, dtype=np.float32)
    for dtype in (torch.float32, torch.bfloat16):
      dname = str(dtype).split('.')[-1]
      xd = torch.from_numpy(x).to(DEVICE, dtype)
      yd = torch.from_numpy(y).to(DEVICE, dtype)
      got = stats_against_plain(xd, yd, f'merge sort ties M={m}', dname)
      again = cp._launch_stats(xd, yd) + (cp._launch_stats(xd, None),)
      bits = torch.int32 if dtype == torch.float32 else torch.int16
      if not all(torch.equal(a.view(bits), b.view(bits))
                 for a, b in zip(got, again)):
        raise AssertionError(f'M={m} {dname}: two launches differ')
      if float(got[0][1]) != 0 or (dtype == torch.float32 and
                                   float(got[4][2]) != 2 * 1.5 * (m - 1)):
        raise AssertionError(f'M={m} {dname}: signed zeros {got[0][1]}, '
                             f'one 1.5 among -0.0 {got[4][2]}')
    log(f'merge sort check M={m} ({runs} runs of {size}, {n} points): ties '
        'across the runs\' and the last merge\'s edges, +-0.0, float32 and '
        'bfloat16, give the plain version\'s values; two launches equal bit '
        'for bit ok')


def time_member_tiles(x, y) -> None:
  """The block sorts' times at phase 3's shapes (x (M, 96)), each beside
  its bound (stats_work) and the bytes' time alone."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  m, n = x.shape
  res = time_cuda({'fused': lambda: cp.fused_ensemble_stats(x, y),
                   'spread': lambda: cp.pairwise_spread_sum(x)},
                  rounds=6, reps=MEMBER_TILE_TIMING_REPS)
  work = {'fused': stats_work(m, n, True), 'spread': stats_work(m, n, False)}
  for name, (med, q1, q3, count) in res.items():
    nbytes, ops = work[name]
    ms, by = bound(nbytes, ops)
    log(f'block sort edge timing M={m} {name}: median {med:.4f} ms, IQR '
        f'[{q1:.4f}, {q3:.4f}] ms over {count} runs; bound {ms:.4f} ms by '
        f'{by} ({ms / med:.1%} of it; bytes alone '
        f'{1e3 * nbytes / HBM_BYTES_PER_S:.6f} ms for {nbytes} bytes, '
        f'{ops} operations); N={n}, float32')


def build_report(build_log: str) -> dict:
  """Phase 2's reading of nvcc's -Xptxas -v lines: the cross, block-sort
  and merge-sort kernels line by line; the register and sorted-runs
  kernels as registers per (dtype, output set) and M or run size. Raises
  unless every register and sorted-runs kernel was compiled, and unless
  every kernel of the build has 0 bytes of stack frame and spills.
  Returns {mangled name: [registers, stack frame and spill bytes]}."""
  import re
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  entry = re.compile(r"Compiling entry function '(\S+)'")
  props = re.compile(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                     r'(\d+) bytes spill loads')
  regs = re.compile(r'Used (\d+) registers')
  generated = re.compile(r'(register|sorted)_stats_kernelI(f|13__nv_bfloat16)'
                         r'Lb([01])ELi(\d+)E')
  kernels = {}  # mangled name -> [registers, stack + spill bytes]
  current = None
  for line in build_log.splitlines():
    if line.startswith('== '):
      log(f'  nvcc: {line}')
    if m := entry.search(line):
      current = m.group(1)
      kernels[current] = [None, None]
    elif current and (m := props.search(line)):
      kernels[current][1] = sum(int(g) for g in m.groups())
    elif current and (m := regs.search(line)):
      kernels[current][0] = int(m.group(1))
    else:
      continue
    if not generated.search(current):
      log(f'  nvcc: {line.strip()}')
  table = {}
  spilled = [f'{mangled}: {spill} bytes of stack frame and spills'
             for mangled, (_, spill) in kernels.items() if spill]
  if spilled:
    raise AssertionError(f'{len(spilled)} kernels with a stack frame or '
                         'spills:\n' + '\n'.join(spilled))
  for mangled, (nregs, spill) in kernels.items():
    if nregs is None or spill is None:
      raise AssertionError(f'no ptxas properties for {mangled}')
    if m := generated.search(mangled):
      dtype = 'f32' if m.group(2) == 'f' else 'bf16'
      key = (m.group(1), dtype, ('spread', 'fused')[int(m.group(3))])
      table.setdefault(key, {})[int(m.group(4))] = nregs
  for form, sizes in (('register', cp.REGISTER_MEMBERS),
                      ('sorted', cp.SORTED_RUN_SIZES)):
    got = sum(len(v) for k, v in table.items() if k[0] == form)
    if got != 4 * len(sizes):
      raise AssertionError(f'{got} {form} kernels in the build log, want '
                           f'{4 * len(sizes)}')
  for (form, dtype, outs), by_m in sorted(table.items()):
    label = 'network' if form == 'register' else 'sorted runs'
    by = 'M' if form == 'register' else 'run size'
    log(f'  nvcc: {label} {outs} {dtype} registers by {by}: '
        + ' '.join(f'{m}:{r}' for m, r in sorted(by_m.items())))
  log(f'  nvcc: {len(kernels)} kernels, every one with 0 bytes of stack '
      'frame, spill stores and spill loads')
  return kernels


def mergesort_registers(kernels: dict) -> dict:
  """The merge sort's kernels in build_report's table: {merge levels, last
  merge (spread, fused), finish (per dtype and output set), the block
  sort's run mode (per dtype and output set): [registers, spill bytes]}."""
  import re
  names = {
      r'merge_kernelILb0ELb0E': 'merge_level',
      r'merge_kernelILb1ELb0E': 'last_merge_spread',
      r'merge_kernelILb1ELb1E': 'last_merge_fused',
      r'finish_kernelIfLb0E': 'finish_f32_spread',
      r'finish_kernelIfLb1E': 'finish_f32_fused',
      r'finish_kernelI13__nv_bfloat16Lb0E': 'finish_bf16_spread',
      r'finish_kernelI13__nv_bfloat16Lb1E': 'finish_bf16_fused',
      r'blocksort_stats_kernelIfLb0ELb1E': 'runs_f32_spread',
      r'blocksort_stats_kernelIfLb1ELb1E': 'runs_f32_fused',
      r'blocksort_stats_kernelI13__nv_bfloat16Lb0ELb1E': 'runs_bf16_spread',
      r'blocksort_stats_kernelI13__nv_bfloat16Lb1ELb1E': 'runs_bf16_fused',
  }
  out = {}
  for mangled, props in kernels.items():
    for pattern, name in names.items():
      if re.search(pattern, mangled):
        out[name] = props
  if len(out) != len(names):
    raise AssertionError(f'merge sort kernels in the build log: {sorted(out)}'
                         f', want {sorted(names.values())}')
  return out


def grid_coords():
  """Ascending latitudes and longitudes of the GRID (0.25 degrees)."""
  nlat, nlon = GRID[2:]
  return (np.arange(nlat) * (180 / (nlat - 1)) - 90,
          np.arange(nlon) * (360 / nlon))


NORMAL_PARTS = 16  # streams a large array's normals are drawn from


def normals(key: list, shape: tuple) -> np.ndarray:
  """Standard normals in float32 from a numpy seed ``key``: the array's
  NORMAL_PARTS contiguous parts each from its own stream (``key + [i]``),
  filled by threads at once (numpy draws without the GIL). The same key
  gives the same array in any process."""
  from concurrent.futures import ThreadPoolExecutor
  out = np.empty(shape, np.float32)
  flat = out.reshape(-1)
  edges = np.linspace(0, flat.size, NORMAL_PARTS + 1).astype(np.int64)

  def fill(i: int) -> None:
    np.random.default_rng(list(key) + [i]).standard_normal(
        int(edges[i + 1] - edges[i]), dtype=np.float32,
        out=flat[edges[i]:edges[i + 1]])
  with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
    list(pool.map(fill, range(NORMAL_PARTS)))
  return out


def make_chunk(seed: int, k: int, members: int = M):
  """One host chunk (predictions, targets) of the main-path configuration
  at ``members`` ensemble members."""
  from weatherbenchx_tpu_torch.darray import Coord, DimArray
  lat, lon = grid_coords()
  lat = lat[::-1].copy()  # north to south, as ERA5 stores it
  coords = {
      'init_time': np.array([np.datetime64('2020-01-01T00', 'ns')
                             + k * np.timedelta64(12, 'h')]),
      'lead_time': (np.arange(GRID[1]) * np.timedelta64(6, 'h')
                    ).astype('timedelta64[ns]'),
      'latitude': lat, 'longitude': lon,
  }
  # A coverage mask that drops the two pole rows.
  mask = np.ones(GRID[2:], bool)
  mask[[0, -1]] = False
  coords['mask'] = Coord(('latitude', 'longitude'), mask)
  x = normals([seed, k, 0], (members,) + GRID)
  y = normals([seed, k, 1], GRID)
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  preds = {'2m_temperature': DimArray(
      x, ('number',) + dims, dict(coords, number=np.arange(members)))}
  tgts = {'2m_temperature': DimArray(y, dims, coords)}
  return preds, tgts


def land_sea_mask():
  """A smooth synthetic land mask, stored south to north."""
  from weatherbenchx_tpu_torch.darray import DimArray
  lat, lon = grid_coords()
  land = (np.cos(np.deg2rad(lat))[:, None]
          * np.sin(3 * np.deg2rad(lon))[None, :]) > 0.3
  return DimArray(land, ('latitude', 'longitude'),
                  {'latitude': lat, 'longitude': lon})


def bin_weights(aggregator, da):
  """Area weights x mask x region bins, (region, lat, lon) float64 on the
  card, for a DimArray with latitude, longitude and mask coords."""
  import torch
  w = torch.from_numpy(np.asarray(
      aggregator.weigh_by[0].weights(da).values, np.float64)).to(DEVICE)
  bins = torch.from_numpy(aggregator.bin_by[0].create_bin_mask(da).values
                          ).to(DEVICE).double()
  mask = torch.from_numpy(np.asarray(da.coords['mask'].values)).to(
      DEVICE).double()
  return w[None, :, None] * mask[None] * bins


def weighted_means(stat_chunks, wb) -> dict:
  """Explicit weighted means per (lead, region) of per-chunk statistics.

  stat_chunks: one {name: (init, lead, lat, lon) tensor} per chunk; wb:
  (region, lat, lon) weights. Sums over (init, lat, lon) in float64.
  """
  num, den = {}, 0
  for stats in stat_chunks:
    for k, s in stats.items():
      num[k] = num.get(k, 0) + (s[:, :, None] * wb[None, None]).sum((0, 3, 4))
    den = den + wb.sum((1, 2))[None, :] * s.shape[0]
  return {k: v / den for k, v in num.items()}


def main_path_statistics(chunks) -> list:
  """Per chunk, the main path's per-point statistics in float64 with the
  plain versions on the card: {'skill', 'spread' (fair CRPS terms), 'var',
  'umse'}, each (init, lead, lat, lon)."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  stat_chunks = []
  for preds, tgts in chunks:
    x = preds['2m_temperature'].data.to(DEVICE, torch.float64)
    y = tgts['2m_temperature'].data.to(DEVICE, torch.float64)
    m = x.shape[0]
    spread, skill, mean, sq_dev = cp.fused_ensemble_stats_plain(x, y)
    del x
    var = sq_dev / (m - 1)
    stat_chunks.append({'skill': skill / m, 'spread': spread / (m * (m - 1)),
                        'var': var, 'umse': (mean - y) ** 2 - var / m})
  return stat_chunks


def f64_reference(chunks, aggregator, stat_chunks=None) -> dict:
  """Metric values recomputed in float64 with the plain versions on the card.

  Independent of the port's aggregation: explicit weighted sums over
  (init_time, latitude, longitude) per region and lead time.
  """
  import torch
  if stat_chunks is None:
    stat_chunks = main_path_statistics(chunks)
  mean_stat = weighted_means(stat_chunks,
                             bin_weights(aggregator, chunks[0][1][
                                 '2m_temperature']))
  return {
      'crps': mean_stat['skill'] - 0.5 * mean_stat['spread'],
      'spread_skill': torch.sqrt(mean_stat['var'] / mean_stat['umse']),
      'unbiased_mean_rmse': torch.sqrt(mean_stat['umse']),
  }


def region_aggregator():
  from weatherbenchx_tpu_torch import aggregation, binning, weighting
  return aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions(REGIONS, land_sea_mask=land_sea_mask())],
      masked=True)


def check_values(path: str, values: dict, ref: dict, closed_forms: dict
                 ) -> None:
  """Each metric: dims, finite, within F64_RTOL of float64, near its closed
  form."""
  import torch
  for name, (closed, tol) in closed_forms.items():
    da = values[f'{name}.2m_temperature']
    if da.dims != ('lead_time', 'region') or da.shape != (GRID[1], 6):
      raise AssertionError(f'{path} {name}: dims {da.dims} shape {da.shape}')
    got = da.data.to(DEVICE).double()
    if not bool(torch.isfinite(got).all()):
      raise AssertionError(f'{path} {name}: non-finite values {got}')
    rel = ((got - ref[name]).abs() / ref[name].abs()).max().item()
    if rel > F64_RTOL:
      raise AssertionError(f'{path} {name}: rel err vs float64 {rel:.3g} > '
                           f'{F64_RTOL}')
    far = (got - closed).abs().max().item()
    if far > tol:
      raise AssertionError(f'{path} {name}: {far:.4g} from the closed form '
                           f'{closed:.6f} (tol {tol})')
    log(f'{path} {name}: mean {got.mean().item():.6f}, closed form '
        f'{closed:.6f} (max dev {far:.4g}, tol {tol}); rel err vs float64 '
        f'{rel:.3g} (tol {F64_RTOL}) ok')


def main_path(seed: int):
  """Phase 4: the port's main path at full width, checked."""
  import torch
  from weatherbenchx_tpu_torch import aggregation
  from weatherbenchx_tpu_torch.metrics import probabilistic
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  from weatherbenchx_tpu_torch.parallel import evaluator
  metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
  }
  aggregator = region_aggregator()
  ev = evaluator.ChunkEvaluator(metrics, aggregator, device=DEVICE)
  t0 = time.perf_counter()
  chunks = [make_chunk(seed, k) for k in range(N_CHUNKS)]
  log(f'main path: made {N_CHUNKS} chunks of {M} x {GRID} float32 in '
      f'{time.perf_counter() - t0:.1f} s')

  cp.reset_launch_counts()
  t0 = time.perf_counter()
  states = [ev.eval_chunk(p, t) for p, t in chunks]
  values = aggregation.AggregationState.sum(states).metric_values(metrics)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = dict(cp.LAUNCHES)
  log(f'main path: {N_CHUNKS} chunks evaluated in {seconds:.2f} s, '
      f'kernel launches {launches}')
  if launches != {'fused_ensemble_stats': N_CHUNKS, 'pairwise_spread_sum': 0,
                  'pairwise_cross_sum': 0}:
    raise AssertionError(f'expected {N_CHUNKS} fused launches (one per '
                         f'chunk) and no other, got {launches}')
  check_values('main path', values, f64_reference(chunks, aggregator),
               CLOSED_FORMS)
  return ev, chunks, launches, values


def weighted_standard_error(per_point, wb):
  """(lead, region) standard errors of the weighted means of per-point
  values (one (init, lead, lat, lon) or (init, lead, region, lat, lon)
  tensor per chunk; wb (region, lat, lon)): sigma^2 sum w^2 / (sum w)^2,
  sigma^2 the weighted variance over (init, lat, lon)."""
  import torch
  w = wb[None, None]  # (1, 1, region, lat, lon)
  per_point = [z if z.dim() == 5 else z[:, :, None] for z in per_point]
  den = sum(w.sum((0, 3, 4)) * z.shape[0] for z in per_point)
  w2 = sum((w ** 2).sum((0, 3, 4)) * z.shape[0] for z in per_point)
  mean = sum((z * w).sum((0, 3, 4)) for z in per_point) / den
  var = sum(((z - mean[None, :, :, None, None]) ** 2 * w).sum((0, 3, 4))
            for z in per_point) / den
  return torch.sqrt(var * w2) / den


def closed_form_sigmas(stat_chunks, wb, values: dict) -> dict:
  """Per metric of the main path, the largest |value - closed form| over
  (lead, region) in standard errors: each estimated from the points' own
  float64 statistics (stat_chunks, main_path_statistics) as a weighted
  mean's, sigma^2 sum w^2 / (sum w)^2 with sigma^2 the weighted variance
  over (init, lat, lon), through the delta method for the square roots
  (RMSE = sqrt(U); spread/skill = sqrt(V / U), whose per-point influence
  is R/2 (v / V - u / U))."""
  import torch

  def standard_error(per_point):
    return weighted_standard_error(per_point, wb)

  means = weighted_means(stat_chunks, wb)
  u, v = means['umse'], means['var']
  ratio = torch.sqrt(v / u)
  influence = [0.5 * ratio[None, :, :, None, None]
               * (s['var'][:, :, None] / v[None, :, :, None, None]
                  - s['umse'][:, :, None] / u[None, :, :, None, None])
               for s in stat_chunks]
  ses = {
      'crps': standard_error([s['skill'] - 0.5 * s['spread']
                              for s in stat_chunks]),
      'spread_skill': standard_error(influence),
      'unbiased_mean_rmse': standard_error([s['umse'] for s in stat_chunks])
                            / (2 * torch.sqrt(u)),
  }
  out = {}
  for name, se in ses.items():
    got = values[f'{name}.2m_temperature'].data.to(DEVICE).double()
    out[name] = ((got - CLOSED_FORMS[name][0]).abs() / se).max().item()
  return out


def large_ensemble_path(seed: int, card: str) -> dict:
  """Phase 4b: the main path's configuration at M_LARGE members, checked
  as phase 4 is, the closed forms within LARGE_SIGMAS standard errors; the
  fused kernel's sorted runs timed at that shape."""
  import torch
  from weatherbenchx_tpu_torch import aggregation
  from weatherbenchx_tpu_torch.metrics import probabilistic
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  from weatherbenchx_tpu_torch.parallel import evaluator
  if cp.spread_form(M_LARGE) != 'sorted':
    raise AssertionError(f'M={M_LARGE} routes to {cp.spread_form(M_LARGE)}')
  metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
  }
  aggregator = region_aggregator()
  ev = evaluator.ChunkEvaluator(metrics, aggregator, device=DEVICE)
  t0 = time.perf_counter()
  chunks = [make_chunk(seed + 4, k, M_LARGE) for k in range(N_LARGE_CHUNKS)]
  log(f'phase 4b large ensemble: made {N_LARGE_CHUNKS} chunks of {M_LARGE} x '
      f'{GRID} float32 in {time.perf_counter() - t0:.1f} s')
  cp.reset_launch_counts()
  states, seconds = [], []
  for p, t in chunks:
    t0 = time.perf_counter()
    states.append(ev.eval_chunk(p, t))
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
  launches = dict(cp.LAUNCHES)
  members = sorted(cp.MEMBER_COUNTS['fused_ensemble_stats'])
  values = aggregation.AggregationState.sum(states).metric_values(metrics)
  log(f'phase 4b large ensemble: {N_LARGE_CHUNKS} chunks evaluated in '
      f'{sum(seconds):.2f} s ({", ".join(f"{s:.3f}" for s in seconds)} s '
      f'per chunk), kernel launches {launches}, fused at M = {members}')
  if launches != {'fused_ensemble_stats': N_LARGE_CHUNKS,
                  'pairwise_spread_sum': 0, 'pairwise_cross_sum': 0}:
    raise AssertionError(f'expected {N_LARGE_CHUNKS} fused launches (one '
                         f'per chunk) and no other, got {launches}')
  if members != [M_LARGE]:
    raise AssertionError(f'the fused kernel ran at M = {members}')
  stat_chunks = main_path_statistics(chunks)
  ref = f64_reference(chunks, aggregator, stat_chunks)
  wb = bin_weights(aggregator, chunks[0][1]['2m_temperature'])
  sigmas = closed_form_sigmas(stat_chunks, wb, values)
  del stat_chunks
  for name in CLOSED_FORMS:
    da = values[f'{name}.2m_temperature']
    if da.dims != ('lead_time', 'region') or da.shape != (GRID[1], 6):
      raise AssertionError(f'phase 4b {name}: dims {da.dims} shape '
                           f'{da.shape}')
    got = da.data.to(DEVICE).double()
    if not bool(torch.isfinite(got).all()):
      raise AssertionError(f'phase 4b {name}: non-finite values {got}')
    rel = ((got - ref[name]).abs() / ref[name].abs()).max().item()
    if rel > F64_RTOL:
      raise AssertionError(f'phase 4b {name}: rel err vs float64 {rel:.3g} '
                           f'> {F64_RTOL}')
    if sigmas[name] > LARGE_SIGMAS:
      raise AssertionError(f'phase 4b {name}: {sigmas[name]:.2f} standard '
                           f'errors from the closed form '
                           f'{CLOSED_FORMS[name][0]:.6f}')
    log(f'phase 4b large ensemble {name}: mean {got.mean().item():.6f}, '
        f'closed form {CLOSED_FORMS[name][0]:.6f} (at most '
        f'{sigmas[name]:.2f} standard errors, limit {LARGE_SIGMAS}); rel err '
        f'vs float64 {rel:.3g} (tol {F64_RTOL}) ok')
  p, t = chunks[0]
  x = p['2m_temperature'].data.to(DEVICE)
  y = t['2m_temperature'].data.to(DEVICE)
  n = y.numel()
  got = cp.fused_ensemble_stats(x, y)
  want = cp.fused_ensemble_stats_plain(x, y)
  err = max(rel_err(g, w)[2] for g, w in zip(got, want))
  res = time_cuda({'fused_kernel': lambda: cp.fused_ensemble_stats(x, y)},
                  rounds=12, reps=TIMING_REPS)
  res.update(time_cuda(
      {'fused_plain': lambda: cp.fused_ensemble_stats_plain(x, y)},
      rounds=6, reps=TIMING_REPS))
  nbytes, ops = stats_work(M_LARGE, n, True)
  bound_ms, by = bound(nbytes, ops)
  for name, (med, q1, q3, count) in res.items():
    log(f'phase 4b timing {name} M={M_LARGE}: median {med:.4f} ms, IQR '
        f'[{q1:.4f}, {q3:.4f}] ms over {count} runs; bound {bound_ms:.4f} ms '
        f'by {by} ({bound_ms / med:.1%} of it; bytes {nbytes}, operations '
        f'{ops}); N={n}, float32; card {card}')
  del x, y, chunks
  return {'launches': launches, 'members': members, 'seconds': seconds,
          'max_abs_err': err, 'sigmas': sigmas, 'timing': res}


def hens_chunk(seed: int, k: int) -> tuple:
  """Phase 4c's chunk k (lead k x 6 h), made on the card from the seed: the
  forecast (M_HENS, *HENS_GRID), the target and the 10-member analysis
  ensemble, as DimArrays with phase 4's coords and mask."""
  import torch
  from weatherbenchx_tpu_torch.darray import Coord, DimArray
  gen = torch.Generator(device=DEVICE)
  gen.manual_seed(1000 * seed + 44 + k)
  x = torch.randn((M_HENS,) + HENS_GRID, generator=gen, device=DEVICE)
  y = torch.randn(HENS_GRID, generator=gen, device=DEVICE)
  yt = TARGET_MEAN + torch.randn((M_TARGETS,) + HENS_GRID, generator=gen,
                                 device=DEVICE)
  lat, lon = grid_coords()
  mask = np.ones(HENS_GRID[2:], bool)
  mask[[0, -1]] = False
  coords = {
      'init_time': np.array([np.datetime64('2020-01-01T00', 'ns')]),
      'lead_time': np.array([k * np.timedelta64(6, 'h')]).astype(
          'timedelta64[ns]'),
      'latitude': lat[::-1].copy(), 'longitude': lon,
      'mask': Coord(('latitude', 'longitude'), mask)}
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  preds = {'2m_temperature': DimArray(
      x, ('number',) + dims, dict(coords, number=np.arange(M_HENS)))}
  tgts = {'2m_temperature': DimArray(y, dims, coords)}
  ens = {'2m_temperature': DimArray(
      yt, ('number',) + dims, dict(coords, number=np.arange(M_TARGETS)))}
  return preds, tgts, ens


def hens_check_chunk(x, y, yt, idx, label: str) -> tuple:
  """Phase 4c's (and 4d's) kernel checks on one chunk, flat (M, N), (N),
  (10, N) or None: the fused, spread-only and (yt given) cross kernels
  launched twice each (equal bits), and on the gathered points idx each
  output within KERNEL_RTOL of its plain version and F64_RTOL of float64.
  Returns ({kernel: outputs}, max abs err per kernel against the plain
  version)."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  runs = {
      'fused': lambda: cp.fused_ensemble_stats(x, y),
      'spread': lambda: (cp.pairwise_spread_sum(x),),
  }
  if yt is not None:
    runs['cross'] = lambda: (cp.pairwise_cross_sum(x, yt),)
  got = {}
  for name, run in runs.items():
    first, again = run(), run()
    torch.cuda.synchronize()
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(first, again)):
      raise AssertionError(f'{label} {name}: two launches on one chunk '
                           'differ')
    got[name] = first
  # The references over slices of the gathered points, each about 2 GB
  # in float64, so that a sort's temporaries fit beside the chunk.
  step = max(1, 2 ** 28 // x.shape[0])
  refs = {}
  for dtype in (torch.float32, torch.float64):
    parts = []
    for lo in range(0, len(idx), step):
      cut = idx[lo:lo + step]
      a, b = x[:, cut].to(dtype), y[cut].to(dtype)
      part = {'fused': cp.fused_ensemble_stats_plain(a, b),
              'spread': (cp.pairwise_spread_sum_plain(a),)}
      if yt is not None:
        part['cross'] = (cp.pairwise_cross_sum_plain(
            a, yt[:, cut].to(dtype)),)
      parts.append(part)
      del a, b
    refs[dtype] = {name: tuple(torch.cat([p[name][i] for p in parts])
                               for i in range(len(parts[0][name])))
                   for name in parts[0]}
  errs = {}
  for name, outs in got.items():
    errs[name] = 0.0
    for i, out in enumerate(outs):
      for dtype, tol in ((torch.float32, KERNEL_RTOL['float32']),
                         (torch.float64, F64_RTOL)):
        same, rel, abs_err = rel_err(out[idx], refs[dtype][name][i])
        if not same or rel > tol:
          raise AssertionError(f'{label} {name} output {i}: rel err '
                               f'{rel:.3g} vs the plain version in {dtype} '
                               f'(tol {tol}), NaN pattern equal {same}')
        if dtype == torch.float32:
          errs[name] = max(errs[name], abs_err)
  return got, errs


def hens_plain_ms(x, y, yt) -> dict:
  """The plain versions' ms over one chunk, HENS_PLAIN_SLICES slices of its
  points in turn (a whole chunk's sort would not fit beside it), two
  samples by CUDA events, the median; the cross's where yt is given."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  n = y.numel()
  step = -(-n // HENS_PLAIN_SLICES)
  cuts = [slice(lo, min(lo + step, n)) for lo in range(0, n, step)]
  fns = {
      'fused': lambda: [cp.fused_ensemble_stats_plain(x[:, c], y[c])
                        for c in cuts],
      'spread': lambda: [cp.pairwise_spread_sum_plain(x[:, c]) for c in cuts],
  }
  if yt is not None:
    fns['cross'] = lambda: [cp.pairwise_cross_sum_plain(x[:, c], yt[:, c])
                            for c in cuts]
  res = time_cuda(fns, rounds=2)
  return {k: v[0] for k, v in res.items()}


def hens_path(seed: int, card: str) -> dict:
  """Phase 4c: HENS at its published width (M_HENS members, one 0.25-degree
  field a chunk, N_HENS_CHUNKS chunks made on the card and dropped after
  each) through ChunkEvaluator: (a) fair CRPS, the unbiased spread/skill
  ratio and the unbiased ensemble-mean RMSE against a deterministic target,
  one fused launch a chunk; (b) fair CRPS against the 10-member analysis
  ensemble, one cross (7,424 x 10, staged) and one spread-only launch a
  chunk. Checks the launches and member counts, each kernel output on
  HENS_GATHER gathered points against its plain version and float64, two
  launches on a chunk bit for bit, the metrics against float64 means of
  the kernels' per-point statistics and the closed forms within
  LARGE_SIGMAS standard errors; times the three kernels (median and IQR of
  HENS_TIMING_SAMPLES by CUDA events) beside their bytes bounds and the
  plain versions (over the chunk slice by slice); logs the peak device
  memory of the path (a chunk made and evaluated) and of the phase."""
  import torch
  from weatherbenchx_tpu_torch import aggregation
  from weatherbenchx_tpu_torch.metrics import probabilistic
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  from weatherbenchx_tpu_torch.parallel import evaluator
  t_phase = time.perf_counter()
  if cp.spread_form(M_HENS) != 'blocksort':
    raise AssertionError(f'phase 4c route: {cp.spread_form(M_HENS)}')
  det_metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
  }
  ens_metrics = {'crps_ens': probabilistic.CRPSEnsemble()}
  aggregator = region_aggregator()
  ev_det = evaluator.ChunkEvaluator(det_metrics, aggregator, device=DEVICE)
  ev_ens = evaluator.ChunkEvaluator(ens_metrics, aggregator, device=DEVICE)
  n = math.prod(HENS_GRID)
  idx = torch.linspace(0, n - 1, HENS_GATHER, device=DEVICE).long()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  det_states, ens_states, stat_chunks, crps_ens_chunks = [], [], [], []
  seconds, launches, members, errs = [], {}, {}, {}
  wb = None
  path_peak = 0
  for k in range(N_HENS_CHUNKS):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    preds, tgts, ens = hens_chunk(seed, k)
    torch.cuda.synchronize()
    t_made = time.perf_counter() - t0
    cp.reset_launch_counts()
    t0 = time.perf_counter()
    det_states.append(ev_det.eval_chunk(preds, tgts))
    ens_states.append(ev_ens.eval_chunk(preds, ens))
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
    path_peak = max(path_peak, torch.cuda.max_memory_allocated())
    for name, count in cp.LAUNCHES.items():
      launches[name] = launches.get(name, 0) + count
      members.setdefault(name, set()).update(cp.MEMBER_COUNTS[name])
    log(f'phase 4c HENS chunk {k}: made on the card in {t_made:.2f} s, '
        f'evaluated in {seconds[-1]:.3f} s, launches {dict(cp.LAUNCHES)}')
    x = preds['2m_temperature'].data.reshape(M_HENS, n)
    y = tgts['2m_temperature'].data.reshape(n)
    yt = ens['2m_temperature'].data.reshape(M_TARGETS, n)
    got, chunk_errs = hens_check_chunk(x, y, yt, idx, f'phase 4c chunk {k}')
    for name, e in chunk_errs.items():
      errs[name] = max(errs.get(name, 0.0), e)
    spread, skill, mean, sq_dev = (t.double() for t in got['fused'])
    var = sq_dev / (M_HENS - 1)
    y64 = y.double()
    shape = (1, 1) + HENS_GRID[2:]
    stat_chunks.append({
        'skill': (skill / M_HENS).reshape(shape),
        'spread': (spread / (M_HENS * (M_HENS - 1))).reshape(shape),
        'var': var.reshape(shape),
        'umse': ((mean - y64) ** 2 - var / M_HENS).reshape(shape)})
    crps_ens_chunks.append(
        (got['cross'][0].double() / (M_HENS * M_TARGETS)
         - 0.5 * got['spread'][0].double() / (M_HENS * (M_HENS - 1))
         ).reshape(shape))
    if wb is None:
      wb = bin_weights(aggregator, tgts['2m_temperature'])
    if k == N_HENS_CHUNKS - 1:
      timing = time_cuda({
          'fused': lambda: cp.fused_ensemble_stats(x, y),
          'spread': lambda: cp.pairwise_spread_sum(x),
          'cross': lambda: cp.pairwise_cross_sum(x, yt),
      }, rounds=HENS_TIMING_SAMPLES)
      plain = hens_plain_ms(x, y, yt)
    del preds, tgts, ens, x, y, yt, got
  peak = torch.cuda.max_memory_allocated()  # the last chunk's checks
  want = {'fused_ensemble_stats': N_HENS_CHUNKS,
          'pairwise_spread_sum': N_HENS_CHUNKS,
          'pairwise_cross_sum': N_HENS_CHUNKS}
  want_members = {'fused_ensemble_stats': {M_HENS},
                  'pairwise_spread_sum': {M_HENS},
                  'pairwise_cross_sum': {(M_HENS, M_TARGETS)}}
  if launches != want or members != want_members:
    raise AssertionError(f'phase 4c launches {launches} at {members}, want '
                         f'{want} at {want_members}')
  log(f'phase 4c HENS path: {N_HENS_CHUNKS} chunks of {M_HENS} x '
      f'{HENS_GRID} float32 evaluated in {sum(seconds):.2f} s '
      f'({", ".join(f"{t:.3f}" for t in seconds)} s per chunk), launches '
      f'{launches} at {members}; peak device memory {path_peak / 2**30:.2f} '
      f'GiB on the path (a chunk made and evaluated), {peak / 2**30:.2f} GiB '
      'with the last chunk\'s checks and the plain versions\' timing')
  values = aggregation.AggregationState.sum(det_states).metric_values(
      det_metrics)
  values.update(aggregation.AggregationState.sum(ens_states).metric_values(
      ens_metrics))
  # The chunks are leads: one (init, lead, lat, lon) set of statistics.
  stat_chunks = [{key: torch.cat([c[key] for c in stat_chunks], dim=1)
                  for key in stat_chunks[0]}]
  crps_ens_chunks = [torch.cat(crps_ens_chunks, dim=1)]
  means = weighted_means(stat_chunks, wb)
  refs = {'crps': means['skill'] - 0.5 * means['spread'],
          'spread_skill': torch.sqrt(means['var'] / means['umse']),
          'unbiased_mean_rmse': torch.sqrt(means['umse']),
          'crps_ens': weighted_means([{'c': c} for c in crps_ens_chunks],
                                     wb)['c']}
  sigmas = closed_form_sigmas(stat_chunks, wb, values)
  crps_ens_closed = ENS_CLOSED_FORMS['crps'][0]
  got = values['crps_ens.2m_temperature'].data.to(DEVICE).double()
  sigmas['crps_ens'] = ((got - crps_ens_closed).abs() / weighted_standard_error(
      crps_ens_chunks, wb)).max().item()
  closed = {**{k: v[0] for k, v in CLOSED_FORMS.items()},
            'crps_ens': crps_ens_closed}
  rels = {}
  for name, ref in refs.items():
    da = values[f'{name}.2m_temperature']
    if da.dims != ('lead_time', 'region') or da.shape != (N_HENS_CHUNKS, 6):
      raise AssertionError(f'phase 4c {name}: dims {da.dims} shape '
                           f'{da.shape}')
    got = da.data.to(DEVICE).double()
    if not bool(torch.isfinite(got).all()):
      raise AssertionError(f'phase 4c {name}: non-finite values {got}')
    rels[name] = ((got - ref).abs() / ref.abs()).max().item()
    if rels[name] > F64_RTOL:
      raise AssertionError(f'phase 4c {name}: rel err vs the float64 means '
                           f'{rels[name]:.3g} > {F64_RTOL}')
    if sigmas[name] > LARGE_SIGMAS:
      raise AssertionError(f'phase 4c {name}: {sigmas[name]:.2f} standard '
                           f'errors from the closed form {closed[name]:.6f}')
    log(f'phase 4c HENS {name}: mean {got.mean().item():.6f}, closed form '
        f'{closed[name]:.6f} (at most {sigmas[name]:.2f} standard errors, '
        f'limit {LARGE_SIGMAS}); rel err vs the float64 means of the '
        f'kernels\' per-point statistics {rels[name]:.3g} (tol {F64_RTOL}) '
        'ok')
  log(f'phase 4c HENS kernels on {HENS_GATHER} gathered points of each '
      f'chunk: within {KERNEL_RTOL["float32"]} of the plain versions and '
      f'{F64_RTOL} of float64 (max abs err against the plain versions '
      f'{json.dumps(errs)}); two launches on a chunk equal bit for bit')
  works = {'fused': stats_work(M_HENS, n, True),
           'spread': stats_work(M_HENS, n, False),
           'cross': cross_work(M_HENS, M_TARGETS, n)}
  for name, (med, q1, q3, count) in timing.items():
    nbytes, ops = works[name]
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ms, by = bound(nbytes, ops)
    network = ('' if name == 'cross' else f'; the block sort\'s own network '
               f'{blocksort_ops(M_HENS) * n}')
    log(f'phase 4c timing {name} M={M_HENS}'
        f'{f" x {M_TARGETS}" if name == "cross" else ""} '
        f'({cp.spread_form(M_HENS) if name != "cross" else "staged"}): '
        f'median {med:.4f} ms, IQR [{q1:.4f}, {q3:.4f}] ms over {count} '
        f'runs; bytes bound {bytes_ms:.4f} ms ({nbytes} bytes, '
        f'{bytes_ms / med:.1%} of it); bound {ms:.4f} ms by {by} ({ops} '
        f'operations{network}); the plain version {plain[name]:.2f} ms '
        f'over {HENS_PLAIN_SLICES} slices; N={n}, float32; card {card}')
  out = {'launches': launches, 'seconds': seconds,
         'path_peak_gib': path_peak / 2**30, 'peak_gib': peak / 2**30,
         'max_abs_err': errs, 'rel_vs_f64': rels, 'sigmas': sigmas,
         'timing': timing, 'plain_ms': plain,
         'phase_seconds': time.perf_counter() - t_phase}
  log(f'phase 4c: {out["phase_seconds"]:.1f} s in all')
  return out


def lagged_band():
  """Phase 4d's latitudes (descending, as ERA5 stores them), longitudes and
  the band's land mask (ascending latitudes), from phase 4's grid."""
  from weatherbenchx_tpu_torch.darray import DimArray
  lat, lon = grid_coords()
  land = land_sea_mask()
  rows = np.asarray(LAGGED_ROWS)
  band = DimArray(np.asarray(land.values)[rows], ('latitude', 'longitude'),
                  {'latitude': lat[rows], 'longitude': lon})
  return lat[rows][::-1].copy(), lon, band


def lagged_aggregator(band):
  """Phase 4's regions and their land parts over the band, area-weighted,
  masked."""
  from weatherbenchx_tpu_torch import aggregation, binning, weighting
  return aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions(REGIONS, land_sea_mask=band)],
      masked=True)


def lagged_metrics() -> tuple:
  """Phase 4d's metrics: against the target, one fused pass (fair CRPS,
  the unbiased spread/skill ratio, the unbiased ensemble-mean RMSE and the
  root mean ensemble variance); and the ensemble's spread E|X - X'| (its
  fair CRPS spread term, the port's CRPSSpread) as a metric of its own,
  defined here: the port has none. CRPSSpread reads the forecast alone; a
  target with an ensemble dim keeps the fused pass away, so that it takes
  one spread-only launch, as the prediction spread of CRPSEnsembleDistance
  does against an ensemble analysis, here with no cross."""
  from weatherbenchx_tpu_torch.metrics import base, probabilistic

  class EnsembleSpread(base.PerVariableMetric):
    """The fair ensemble spread E|X - X'|, the CRPS spread term alone."""

    @property
    def statistics(self):
      return {'CRPSSpread': probabilistic.CRPSSpread(use_sort=True)}

    def _values_from_mean_statistics_per_variable(self, s):
      return s['CRPSSpread']

  det = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
      'root_mean_variance': probabilistic.EnsembleRootMeanVariance(),
  }
  return det, {'spread': EnsembleSpread()}


def lagged_chunk(seed: int, k: int, lat, lon) -> tuple:
  """Phase 4d's chunk k (lead k x 6 h), made on the card from the seed: the
  forecast (M_LAGGED, 1, 1, band) and the N(0, 1) target, as DimArrays,
  and the target as a one-member ensemble (a view), the spread metric's;
  a coverage mask drops the band's edge rows."""
  import torch
  from weatherbenchx_tpu_torch.darray import Coord, DimArray
  grid = (1, 1, len(lat), len(lon))
  gen = torch.Generator(device=DEVICE)
  gen.manual_seed(1000 * seed + 48 + k)
  x = torch.randn((M_LAGGED,) + grid, generator=gen, device=DEVICE)
  y = torch.randn(grid, generator=gen, device=DEVICE)
  mask = np.ones(grid[2:], bool)
  mask[[0, -1]] = False
  coords = {
      'init_time': np.array([np.datetime64('2020-01-01T00', 'ns')]),
      'lead_time': np.array([k * np.timedelta64(6, 'h')]).astype(
          'timedelta64[ns]'),
      'latitude': lat, 'longitude': lon,
      'mask': Coord(('latitude', 'longitude'), mask)}
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  preds = {'2m_temperature': DimArray(
      x, ('number',) + dims, dict(coords, number=np.arange(M_LAGGED)))}
  tgts = {'2m_temperature': DimArray(y, dims, coords)}
  ens = {'2m_temperature': DimArray(
      y.unsqueeze(0), ('number',) + dims, dict(coords, number=np.arange(1)))}
  return preds, tgts, ens


def lagged_path(seed: int, card: str) -> dict:
  """Phase 4d: the lagged-average HENS ensemble (M_LAGGED members, a band
  of one 0.25-degree field a chunk, N_LAGGED_CHUNKS chunks made on the card
  and dropped after each) through ChunkEvaluator: (a) fair CRPS,
  spread/skill, ensemble-mean RMSE and root mean variance against the
  target, one fused merge-sort launch a chunk; (b) the ensemble's spread
  alone, one spread-only launch a chunk. Checks the launches and member
  counts, each output on HENS_GATHER gathered points against its plain
  version and float64, two launches on a chunk bit for bit, the metrics
  against float64 means of the kernels' per-point statistics and within
  LAGGED_SIGMAS standard errors of the closed forms; times both kernels
  beside their bytes bound and the plain versions (over the chunk slice by
  slice); logs a model of the bytes each call moves (mergesort_traffic),
  the peak device memory, and the device time of one call of each by
  kernel (torch.profiler)."""
  import re
  import torch
  from weatherbenchx_tpu_torch import aggregation
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  from weatherbenchx_tpu_torch.parallel import evaluator
  t_phase = time.perf_counter()
  if cp.spread_form(M_LAGGED) != 'mergesort':
    raise AssertionError(f'phase 4d route: {cp.spread_form(M_LAGGED)}')
  lat, lon, band = lagged_band()
  det_metrics, spread_metrics = lagged_metrics()
  aggregator = lagged_aggregator(band)
  ev_det = evaluator.ChunkEvaluator(det_metrics, aggregator, device=DEVICE)
  ev_spread = evaluator.ChunkEvaluator(spread_metrics, aggregator,
                                       device=DEVICE)
  n = len(lat) * len(lon)
  idx = torch.linspace(0, n - 1, HENS_GATHER, device=DEVICE).long()
  torch.cuda.empty_cache()
  det_states, spread_states, stat_chunks = [], [], []
  seconds, launches, members, errs = [], {}, {}, {}
  wb = None
  path_peak = 0
  for k in range(N_LAGGED_CHUNKS):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    preds, tgts, ens = lagged_chunk(seed, k, lat, lon)
    torch.cuda.synchronize()
    t_made = time.perf_counter() - t0
    cp.reset_launch_counts()
    t0 = time.perf_counter()
    det_states.append(ev_det.eval_chunk(preds, tgts))
    spread_states.append(ev_spread.eval_chunk(preds, ens))
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
    path_peak = max(path_peak, torch.cuda.max_memory_allocated())
    for name, count in cp.LAUNCHES.items():
      launches[name] = launches.get(name, 0) + count
      members.setdefault(name, set()).update(cp.MEMBER_COUNTS[name])
    log(f'phase 4d lagged HENS chunk {k}: made on the card in {t_made:.2f} '
        f's, evaluated in {seconds[-1]:.3f} s, launches {dict(cp.LAUNCHES)}')
    x = preds['2m_temperature'].data.reshape(M_LAGGED, n)
    y = tgts['2m_temperature'].data.reshape(n)
    got, chunk_errs = hens_check_chunk(x, y, None, idx,
                                       f'phase 4d chunk {k}')
    for name, e in chunk_errs.items():
      errs[name] = max(errs.get(name, 0.0), e)
    spread, skill, mean, sq_dev = (t.double() for t in got['fused'])
    var = sq_dev / (M_LAGGED - 1)
    pairs = M_LAGGED * (M_LAGGED - 1)
    shape = (1, 1, len(lat), len(lon))
    stat_chunks.append({
        'skill': (skill / M_LAGGED).reshape(shape),
        'spread': (spread / pairs).reshape(shape),
        'var': var.reshape(shape),
        'umse': ((mean - y.double()) ** 2 - var / M_LAGGED).reshape(shape),
        'spread_only': (got['spread'][0].double() / pairs).reshape(shape)})
    if wb is None:
      wb = bin_weights(aggregator, tgts['2m_temperature'])
    if k == N_LAGGED_CHUNKS - 1:
      timing = time_cuda({
          'fused': lambda: cp.fused_ensemble_stats(x, y),
          'spread': lambda: cp.pairwise_spread_sum(x),
      }, rounds=HENS_TIMING_SAMPLES)
      plain = hens_plain_ms(x, y, None)
      breakdown = {
          name: device_time(fn, top=None) for name, fn in (
              ('fused', lambda: cp.fused_ensemble_stats(x, y)),
              ('spread', lambda: cp.pairwise_spread_sum(x)))}
    del preds, tgts, ens, x, y, got
  peak = torch.cuda.max_memory_allocated()
  want = {'fused_ensemble_stats': N_LAGGED_CHUNKS,
          'pairwise_spread_sum': N_LAGGED_CHUNKS, 'pairwise_cross_sum': 0}
  want_members = {'fused_ensemble_stats': {M_LAGGED},
                   'pairwise_spread_sum': {M_LAGGED},
                   'pairwise_cross_sum': set()}
  if launches != want or members != want_members:
    raise AssertionError(f'phase 4d launches {launches} at {members}, want '
                         f'{want} at {want_members}')
  log(f'phase 4d lagged HENS path: {N_LAGGED_CHUNKS} chunks of {M_LAGGED} x '
      f'(1, 1, {len(lat)}, {len(lon)}) float32 evaluated in '
      f'{sum(seconds):.2f} s ({", ".join(f"{t:.3f}" for t in seconds)} s '
      f'per chunk), launches {launches} at {members}; peak device memory '
      f'{path_peak / 2**30:.2f} GiB on the path (a chunk made and '
      f'evaluated), {peak / 2**30:.2f} GiB with the last chunk\'s checks '
      'and the timing')
  metrics = {**det_metrics, **spread_metrics}
  values = aggregation.AggregationState.sum(det_states).metric_values(
      det_metrics)
  values.update(aggregation.AggregationState.sum(
      spread_states).metric_values(spread_metrics))
  stat_chunks = [{key: torch.cat([c[key] for c in stat_chunks], dim=1)
                  for key in stat_chunks[0]}]
  means = weighted_means(stat_chunks, wb)
  refs = {'crps': means['skill'] - 0.5 * means['spread'],
          'spread_skill': torch.sqrt(means['var'] / means['umse']),
          'unbiased_mean_rmse': torch.sqrt(means['umse']),
          'root_mean_variance': torch.sqrt(means['var']),
          'spread': means['spread_only']}
  sigmas = closed_form_sigmas(stat_chunks, wb, values)
  for name, key, root in (('root_mean_variance', 'var', True),
                          ('spread', 'spread_only', False)):
    se = weighted_standard_error([c[key] for c in stat_chunks], wb)
    if root:
      se = se / (2 * torch.sqrt(means[key]))
    closed = 1.0 if root else SPREAD_CLOSED_FORM
    got = values[f'{name}.2m_temperature'].data.to(DEVICE).double()
    sigmas[name] = ((got - closed).abs() / se).max().item()
  closed = {**{k: v[0] for k, v in CLOSED_FORMS.items()},
            'root_mean_variance': 1.0, 'spread': SPREAD_CLOSED_FORM}
  rels = {}
  for name in metrics:
    da = values[f'{name}.2m_temperature']
    if da.dims != ('lead_time', 'region') or da.shape != (N_LAGGED_CHUNKS,
                                                          6):
      raise AssertionError(f'phase 4d {name}: dims {da.dims} shape '
                           f'{da.shape}')
    got = da.data.to(DEVICE).double()
    if not bool(torch.isfinite(got).all()):
      raise AssertionError(f'phase 4d {name}: non-finite values {got}')
    rels[name] = ((got - refs[name]).abs() / refs[name].abs()).max().item()
    if rels[name] > F64_RTOL:
      raise AssertionError(f'phase 4d {name}: rel err vs the float64 means '
                           f'{rels[name]:.3g} > {F64_RTOL}')
    if sigmas[name] > LAGGED_SIGMAS:
      raise AssertionError(f'phase 4d {name}: {sigmas[name]:.2f} standard '
                           f'errors from the closed form {closed[name]:.6f}')
    log(f'phase 4d lagged HENS {name}: mean {got.mean().item():.6f}, closed '
        f'form {closed[name]:.6f} (at most {sigmas[name]:.2f} standard '
        f'errors, limit {LAGGED_SIGMAS}); rel err vs the float64 means of '
        f'the kernels\' per-point statistics {rels[name]:.3g} (tol '
        f'{F64_RTOL}) ok')
  log(f'phase 4d kernels on {HENS_GATHER} gathered points of each chunk: '
      f'within {KERNEL_RTOL["float32"]} of the plain versions and '
      f'{F64_RTOL} of float64 (max abs err against the plain versions '
      f'{json.dumps(errs)}); two launches on a chunk equal bit for bit')
  runs, size, words, batch = cp.mergesort_plan(M_LAGGED, n)
  modelled = {}
  for name, (med, q1, q3, count) in timing.items():
    fused = name == 'fused'
    nbytes, ops = stats_work(M_LAGGED, n, fused)
    modelled[name] = mergesort_traffic(M_LAGGED, n, runs, words, fused)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    moved = modelled[name]['total']
    log(f'phase 4d timing {name} M={M_LAGGED} (mergesort: {runs} runs of '
        f'{size}, {words} scratch words a point, batches of {batch} '
        f'points): median {med:.4f} ms, IQR [{q1:.4f}, {q3:.4f}] ms over '
        f'{count} runs; bytes bound {bytes_ms:.4f} ms ({nbytes} bytes, '
        f'{bytes_ms / med:.1%} of it); modelled_bytes {moved} '
        f'({json.dumps(modelled[name])}, a model, not measured), '
        f'{1e3 * moved / HBM_BYTES_PER_S:.4f} ms at the HBM rate; '
        f'operations {ops}; the plain version {plain[name]:.2f} ms over '
        f'{HENS_PLAIN_SLICES} slices; N={n}, float32; card {card}')
  kernels = {}
  for name, (busy, rows) in breakdown.items():
    kernels[name] = {'busy_ms': busy, 'kernels': {}}
    for key, ms in rows:
      short = re.search(r'(\w+_kernel<[^()]*>)', key)
      short = short.group(1) if short else key[:60]
      kernels[name]['kernels'][short] = (
          kernels[name]['kernels'].get(short, 0.0) + ms)
    log(f'phase 4d device time of one {name} call by torch.profiler: busy '
        f'{busy} ms; by kernel (ms) {json.dumps(kernels[name]["kernels"])}')
  out = {'launches': launches, 'seconds': seconds,
         'path_peak_gib': path_peak / 2**30, 'peak_gib': peak / 2**30,
         'max_abs_err': errs, 'rel_vs_f64': rels, 'sigmas': sigmas,
         'timing': timing, 'plain_ms': plain, 'modelled_bytes': modelled,
         'device_time': kernels,
         'plan': {'runs': runs, 'run_members': size, 'scratch_words': words,
                  'batch': batch},
         'points': n, 'phase_seconds': time.perf_counter() - t_phase}
  log(f'phase 4d: {out["phase_seconds"]:.1f} s in all')
  return out


def ensemble_stores(seed: int):
  """(predictions, targets) in-memory stores of the ensemble path."""
  from weatherbenchx_tpu_torch.darray import DimArray
  lat, lon = grid_coords()
  lat = lat[::-1].copy()  # north to south, as ERA5 stores it
  inits = (np.datetime64('2020-01-01T00', 'ns')
           + np.arange(N_ENS_INITS) * np.timedelta64(12, 'h'))
  leads = (np.arange(GRID[1]) * np.timedelta64(6, 'h')).astype(
      'timedelta64[ns]')
  valid = (np.datetime64('2020-01-01T00', 'ns')
           + np.arange(N_VALID) * np.timedelta64(6, 'h'))
  space = {'latitude': lat, 'longitude': lon}
  x = normals([seed, 1000, 0], (M, N_ENS_INITS) + GRID[1:])
  y = normals([seed, 1000, 1], (M_TARGETS, N_VALID) + GRID[2:])
  y += TARGET_MEAN
  preds = {'2m_temperature': DimArray(
      x, ('number', 'init_time', 'lead_time', 'latitude', 'longitude'),
      {'number': np.arange(M), 'init_time': inits, 'lead_time': leads,
       **space})}
  tgts = {'2m_temperature': DimArray(
      y, ('number', 'valid_time', 'latitude', 'longitude'),
      {'number': np.arange(M_TARGETS), 'valid_time': valid, **space})}
  return preds, tgts


def attach_mask(chunk):
  """process_chunk_fn: the coverage mask of the main path (no pole rows)."""
  from weatherbenchx_tpu_torch.darray import Coord
  mask = np.ones(GRID[2:], bool)
  mask[[0, -1]] = False
  return {k: da.assign_coords(mask=Coord(('latitude', 'longitude'), mask))
          for k, da in chunk.items()}


def ensemble_metrics():
  from weatherbenchx_tpu_torch.metrics import probabilistic
  return {
      'energy_distance': probabilistic.CRPSEnsembleDistance(use_sort=True),
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
  }


def run_ensemble_pipeline(stores, registry):
  """pipeline.evaluate over the stores on the card; (values, seconds)."""
  import torch
  from weatherbenchx_tpu_torch import time_chunks
  from weatherbenchx_tpu_torch.data import loaders
  from weatherbenchx_tpu_torch.parallel import pipeline
  preds, tgts = stores
  times = time_chunks.TimeChunks(
      preds['2m_temperature'].coord_values('init_time'),
      preds['2m_temperature'].coord_values('lead_time'),
      init_time_chunk_size=1)
  t0 = time.perf_counter()
  values = pipeline.evaluate(
      ensemble_metrics(), region_aggregator(),
      loaders.PredictionsFromDataset(ds=preds, rename_dimensions=None,
                                     process_chunk_fn=attach_mask),
      loaders.TargetsFromDataset(ds=tgts, rename_dimensions=None,
                                 process_chunk_fn=attach_mask),
      times, device=DEVICE, metrics_registry=registry)
  torch.cuda.synchronize()
  return values, time.perf_counter() - t0


def ensemble_f64_reference(stores) -> dict:
  """The ensemble path's metric values in float64 with the plain versions
  on the card, gathered from the stores by index (valid = 2 init + lead)."""
  import torch
  from weatherbenchx_tpu_torch.darray import DimArray
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  preds, tgts = (s['2m_temperature'] for s in stores)
  mx, my = M, M_TARGETS
  stat_chunks = []
  for k in range(N_ENS_INITS):
    x = preds.data[:, k:k + 1].to(DEVICE, torch.float64)
    y = tgts.data[:, 2 * k:2 * k + GRID[1]][:, None].to(DEVICE, torch.float64)
    var_x, var_y = x.var(0, correction=1), y.var(0, correction=1)
    stat_chunks.append({
        'skill': cp.pairwise_cross_sum_plain(x, y) / (mx * my),
        'spread_x': cp.pairwise_spread_sum_plain(x) / (mx * (mx - 1)),
        'spread_y': cp.pairwise_spread_sum_plain(y) / (my * (my - 1)),
        'umse': (x.mean(0) - y.mean(0)) ** 2 - var_x / mx - var_y / my})
    del x, y
  grid = attach_mask({'g': DimArray(
      np.zeros(GRID[2:], np.float32), ('latitude', 'longitude'),
      {'latitude': preds.coord_values('latitude'),
       'longitude': preds.coord_values('longitude')})})['g']
  s = weighted_means(stat_chunks, bin_weights(region_aggregator(), grid))
  return {
      'energy_distance': s['skill'] - 0.5 * s['spread_x'] - 0.5 * s['spread_y'],
      'crps': s['skill'] - 0.5 * s['spread_x'],
      'unbiased_mean_rmse': torch.sqrt(s['umse']),
  }


def ensemble_path(seed: int):
  """Phase 5: the ensemble-vs-ensemble path through pipeline.evaluate."""
  from weatherbenchx_tpu_torch import observability
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  t0 = time.perf_counter()
  stores = ensemble_stores(seed)
  log(f'ensemble path: made stores of {M} x {N_ENS_INITS} x {GRID[1:]} and '
      f'{M_TARGETS} x {N_VALID} x {GRID[2:]} float32 in '
      f'{time.perf_counter() - t0:.1f} s')
  registry = observability.Metrics()
  cp.reset_launch_counts()
  values, seconds = run_ensemble_pipeline(stores, registry)
  launches = dict(cp.LAUNCHES)
  log(f'ensemble path: {N_ENS_INITS} chunks through pipeline.evaluate in '
      f'{seconds:.2f} s, kernel launches {launches}; '
      f'{registry.summary()!r}')
  want = {'fused_ensemble_stats': 0, 'pairwise_spread_sum': 2 * N_ENS_INITS,
          'pairwise_cross_sum': N_ENS_INITS}
  if launches != want:
    raise AssertionError(f'expected launches {want}, got {launches}')
  check_values('ensemble path', values, ensemble_f64_reference(stores),
               ENS_CLOSED_FORMS)
  return stores, launches


def run_main(module: str, argv: list) -> str:
  """``python -m <module> <argv>`` as its ``main(argv)`` in this process
  (no new process pays for ``import torch`` and a CUDA context); what it
  printed. The kernel launch counts start at 0, as in a fresh process."""
  import contextlib
  import importlib
  import io as io_std
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  cp.reset_launch_counts()
  buf = io_std.StringIO()
  with contextlib.redirect_stdout(buf):
    importlib.import_module(module).main(list(argv))
  return buf.getvalue()


def cli_phase(seed: int) -> None:
  """Phase 7: the evaluation CLI on the card over a small .npz store."""
  from weatherbenchx_tpu_torch import io
  from weatherbenchx_tpu_torch.darray import DimArray
  rng = np.random.default_rng([seed, 2000])
  inits = np.arange('2020-01-01', '2020-01-05', np.timedelta64(12, 'h'),
                    dtype='datetime64[ns]')
  leads = np.array([0, 6], dtype='timedelta64[h]').astype('timedelta64[ns]')
  valid = np.arange('2020-01-01', '2020-01-05T12', np.timedelta64(6, 'h'),
                    dtype='datetime64[ns]')
  space = {'latitude': np.linspace(-90, 90, CLI_GRID[0]),
           'longitude': np.arange(CLI_GRID[1]) * (360 / CLI_GRID[1])}
  with tempfile.TemporaryDirectory() as tmp:
    p, t = os.path.join(tmp, 'p.npz'), os.path.join(tmp, 't.npz')
    io.save_dataset(p, {'2m_temperature': DimArray(
        rng.standard_normal((len(inits), 2) + CLI_GRID, dtype=np.float32),
        ('time', 'prediction_timedelta', 'latitude', 'longitude'),
        {'time': inits, 'prediction_timedelta': leads, **space})})
    io.save_dataset(t, {'2m_temperature': DimArray(
        rng.standard_normal((len(valid),) + CLI_GRID, dtype=np.float32),
        ('time', 'latitude', 'longitude'), {'time': valid, **space})})

    def run(suffix: str):
      """The CLI over the stores in ``suffix``'s container, its output in
      the same container; returns the RMSE."""
      if suffix != '.npz':
        for path in (p, t):
          io.save_dataset(path[:-4] + suffix, io.load_dataset(path))
      out = os.path.join(tmp, f'o{suffix}')
      run_main('weatherbenchx_tpu_torch.apps.run_evaluation', [
          '--device', DEVICE, f'--prediction_path={p[:-4]}{suffix}',
          f'--target_path={t[:-4]}{suffix}', f'--output_path={out}',
          '--time_start=2020-01-01', '--time_stop=2020-01-05',
          '--lead_time_stop=12', '--variables=2m_temperature',
          '--time_chunk_size=2'])
      return io.load_dataset(out)['rmse.2m_temperature']

    t0 = time.perf_counter()
    rmse = run('.npz')
    seconds = time.perf_counter() - t0
    for suffix in ('.wbx', '.nc'):
      other = run(suffix)
      if not (other.dims == rmse.dims
              and np.array_equal(other.values, rmse.values)):
        raise AssertionError(f'CLI from {suffix} stores: {other.values} '
                             f'differs from the .npz run {rmse.values}')
      log(f'cli: from {suffix} stores with a {suffix} output, equal to the '
          '.npz run bit for bit ok')
  far = float(np.abs(rmse.values - math.sqrt(2)).max())
  if rmse.shape != (2, 2) or not far <= CLI_RMSE_TOL:
    raise AssertionError(f'CLI rmse {rmse.values} (shape {rmse.shape}): '
                         f'{far:.4g} from sqrt(2), tol {CLI_RMSE_TOL}')
  log(f'cli: {len(inits)} inits x 2 leads x {CLI_GRID} in '
      f'{seconds:.1f} s; rmse {rmse.values.ravel()} vs '
      f'sqrt(2) (max dev {far:.4g}, tol {CLI_RMSE_TOL}) ok')


# -- the deterministic benchmark path (run_benchmark_evaluation's setup) -------

# The registry's default for hres_1440x721_2020: STANDARD_VARIABLES +
# PRECIPITATION_VARIABLES at the CLI's default levels 500/700/850, i.e.
# 6 x 3 upper-air + 5 surface + 2 precipitation = 25 field-levels, on the
# 0.25-degree grid; --lead_time_chunk_size 12 with leads 6 h apart, one
# init per chunk; 2 chunks (the 00z and 12z inits of 2020-01-01), so 14
# valid times and a climatology of the touched window (dayofyear 1-4 x 4
# hours = 16 slots), 17 regions and their land parts (34 bins).
BENCH_GRID = (721, 1440)
BENCH_LEVELS = (500, 700, 850)
BENCH_LEADS = 12
BENCH_INITS = 2
# Precipitation follows the same recipe in metres (1e-3 x N(0, 1) fields);
# its closed forms scale with it.
PRECIP_SCALE = 1e-3
# Sampling tolerances: BENCH_SIGMAS standard errors, each the metric's
# per-gridpoint standard deviation (for iid normal z's: RMSE 1, MSE
# 2*sqrt(2), bias sqrt(2), ACC (1 - rho^2) = 0.75, activity 1, vector RMSE
# 1, in units of the field's scale) over the square root of the bin's
# effective size: Kish's (sum w)^2 / sum w^2 of the area weights, times the
# independent inits.
BENCH_SIGMAS = 6.0
BENCH_CLOSED_FORMS = {  # metric: (value, per-point sd, power of the scale)
    'rmse': (math.sqrt(2), 1.0, 1), 'mse': (2.0, 2 * math.sqrt(2), 2),
    'bias': (0.0, math.sqrt(2), 1), 'acc': (0.5, 0.75, 0),
    'prediction_activity': (math.sqrt(2), 1.0, 1),
    'vector_rmse': (2.0, 1.0, 1)}
# Differences from the float64 recomputation are taken relative to
# max(|float64 value|, the field's scale ** power): bias is near 0.
BENCH_F64_RTOL = 1e-5


def bench_variables():
  from weatherbenchx_tpu_torch.apps import configs
  return configs.STANDARD_VARIABLES + configs.PRECIPITATION_VARIABLES


def bench_land_sea_mask():
  """5-degree land/sea checkerboard, stored north to south as ERA5 does:
  every region's land part holds land."""
  from weatherbenchx_tpu_torch.darray import DimArray
  lat = np.linspace(90, -90, BENCH_GRID[0])
  lon = np.arange(BENCH_GRID[1]) * (360 / BENCH_GRID[1])
  land = ((np.floor(lat / 5)[:, None] + np.floor(lon / 5)[None, :]) % 2) == 0
  return DimArray(land.astype(np.float32), ('latitude', 'longitude'),
                  {'latitude': lat, 'longitude': lon})


def bench_stores(seed: int) -> dict:
  """Host stores of the benchmark path, generated on the card.

  target = clim(doy, hour) + z_c(valid) + z_t and prediction = clim +
  z_c + z_p (tools/gen_demo_fixtures.py's recipe), all z iid N(0, 1) from
  a torch.Generator seeded by ``seed``; ECMWF dim names; analyses and
  climatology latitude-descending as ERA5 stores them, predictions
  ascending. The SEEPS climatology: wet thresholds 1.5e-3 + 2e-4 N(0, 1)
  and dry fractions in 0.05-0.95 (bench.py:534-535's range), so some
  points fall outside [min_p1, max_p1] and are masked.
  """
  import torch
  from weatherbenchx_tpu_torch.apps import configs
  from weatherbenchx_tpu_torch.darray import DimArray
  gen = torch.Generator(device=DEVICE)
  gen.manual_seed(seed)
  nlat, nlon = BENCH_GRID
  lat = np.linspace(-90, 90, nlat)
  lon = np.arange(nlon) * (360 / nlon)
  inits = (np.datetime64('2020-01-01T00', 'ns')
           + np.arange(BENCH_INITS) * np.timedelta64(12, 'h'))
  leads = (np.arange(BENCH_LEADS) * np.timedelta64(6, 'h')).astype(
      'timedelta64[ns]')
  n_valid = 2 * (BENCH_INITS - 1) + BENCH_LEADS
  valid = (np.datetime64('2020-01-01T00', 'ns')
           + np.arange(n_valid) * np.timedelta64(6, 'h'))
  n_slots = 4 * ((n_valid + 3) // 4)
  up = {'latitude': lat, 'longitude': lon}
  down = {'latitude': lat[::-1].copy(), 'longitude': lon}
  ccoords = {'dayofyear': np.arange(1, n_slots // 4 + 1),
             'hour': np.array([0, 6, 12, 18])}
  # Valid time v (6-hourly from Jan 1 00z) is climatology slot v, and
  # init k's lead j is valid time 2k + j.
  vpos = torch.tensor([2 * k + j for k in range(BENCH_INITS)
                       for j in range(BENCH_LEADS)], device=DEVICE)

  def randn(*shape):
    return torch.randn(shape, generator=gen, device=DEVICE)

  def host(x, flip):
    return (x.flip(-2) if flip else x).cpu().numpy()

  preds, tgts, clim = {}, {}, {}
  for name in bench_variables():
    lev = name in configs.UPPER_LEVEL_VARIABLES
    fshape = ((len(BENCH_LEVELS),) if lev else ()) + BENCH_GRID
    fdims = (('level',) if lev else ()) + ('latitude', 'longitude')
    lcoords = {'level': np.array(BENCH_LEVELS)} if lev else {}
    scale = PRECIP_SCALE if name in configs.PRECIPITATION_VARIABLES else 1.0
    c = randn(n_slots, *fshape)
    zc = randn(n_valid, *fshape)
    t = c[:n_valid] + zc + randn(n_valid, *fshape)
    p = (c[vpos] + zc[vpos]).reshape((BENCH_INITS, BENCH_LEADS) + fshape)
    p += randn(BENCH_INITS, BENCH_LEADS, *fshape)
    tgts[name] = DimArray(host(t * scale, True), ('time',) + fdims,
                          {'time': valid, **down, **lcoords})
    preds[name] = DimArray(
        host(p * scale, False), ('time', 'prediction_timedelta') + fdims,
        {'time': inits, 'prediction_timedelta': leads, **up, **lcoords})
    clim[name] = DimArray(
        host(c.reshape((n_slots // 4, 4) + fshape) * scale, True),
        ('dayofyear', 'hour') + fdims, {**ccoords, **down, **lcoords})
    del c, zc, t, p
  cshape = (n_slots // 4, 4) + BENCH_GRID
  cdims = ('dayofyear', 'hour', 'latitude', 'longitude')
  for name in configs.PRECIPITATION_VARIABLES:
    clim[f'{name}_seeps_threshold'] = DimArray(
        host(1.5e-3 + 2e-4 * randn(*cshape), True), cdims,
        {**ccoords, **down})
    # A dry fraction that varies from point to point far more than from
    # slot to slot, so that its mean p1 leaves [0.1, 0.85] at some points.
    u = 0.05 + 0.9 * torch.rand(BENCH_GRID, generator=gen, device=DEVICE)
    jitter = torch.rand(cshape, generator=gen, device=DEVICE) - 0.5
    clim[f'{name}_seeps_dry_fraction'] = DimArray(
        host((u + 0.04 * jitter).clamp(0.05, 0.95), True), cdims,
        {**ccoords, **down})
  tgts['land_sea_mask'] = bench_land_sea_mask()
  return {'predictions': preds, 'targets': tgts, 'climatology': clim,
          'inits': inits, 'leads': leads}


def bench_sources(stores, paths=None) -> dict:
  """The CLI's configs of the three stores: in memory (``ds``), or the
  on-disk stores at ``paths`` (``path``)."""
  from weatherbenchx_tpu_torch.apps import configs
  out = {}
  for key in ('predictions', 'targets', 'climatology'):
    out[key] = ({'path': paths[key]} if paths else {'ds': stores[key]})
  out['targets']['data_loader_kwargs'] = {
      'preprocessing_fn': configs.sort_latitude}
  return out


def bench_pipeline(stores, registry, sources, variables=None, group=1):
  """The benchmark CLI's own construction over the stores' configs (every
  variable of the stores unless ``variables`` names some), ``group``
  chunks per dispatch."""
  from weatherbenchx_tpu_torch import time_chunks
  from weatherbenchx_tpu_torch.apps import run_benchmark_evaluation as cli
  from weatherbenchx_tpu_torch.parallel import pipeline
  variables, levels = variables or bench_variables(), list(BENCH_LEVELS)
  p_loader, t_loader = cli.build_loaders(
      'hres', sources['predictions'], sources['targets'], variables, levels)
  climatology = cli.load_climatology(sources['climatology'], variables,
                                     levels)
  metrics = cli.build_metrics(variables, climatology, is_probabilistic=False)
  aggregator = cli.build_aggregator(
      cli.open_store(sources['targets'])['land_sea_mask'], temporal=False)
  times = time_chunks.TimeChunks(stores['inits'], stores['leads'],
                                 init_time_chunk_size=1,
                                 lead_time_chunk_size=BENCH_LEADS)
  return pipeline.EvaluationPipeline(
      metrics=metrics, aggregator=aggregator, predictions_loader=p_loader,
      targets_loader=t_loader, times=times, device=DEVICE,
      metrics_registry=registry, chunks_per_dispatch=group)


def run_bench(stores, budget_bytes, card: str, sources=None,
              label: str = 'benchmark path', group: int = 1):
  """One pipeline run under a resource budget (None: the default) over
  the stores' configs (``bench_sources``; default in memory); returns
  (pipeline, host state, seconds, timings): the run's seconds and stage
  timers, the construction's seconds (climatology opened and uploaded)
  and the loaders' one-time preparation. The preparation is timed apart,
  before the run, so seconds per chunk leave it out; ``s_per_chunk_with_
  prepare`` counts it in, as a run that prepares on its first chunk
  pays it."""
  import torch
  from weatherbenchx_tpu_torch import observability
  from weatherbenchx_tpu_torch.metrics import base
  if budget_bytes is None:
    os.environ.pop('WBX_RESOURCE_BYTES', None)
  else:
    os.environ['WBX_RESOURCE_BYTES'] = str(budget_bytes)
  t0 = time.perf_counter()
  try:
    registry = observability.Metrics()
    pipe = bench_pipeline(stores, registry, sources or bench_sources(stores),
                          group=group)
  finally:
    os.environ.pop('WBX_RESOURCE_BYTES', None)
  ev = pipe._evaluator
  seeps = pipe.metrics['seeps']
  p1_ids = {base.resource_id(p1) for p1 in seeps._p1.values()}
  if p1_ids & ev.host_gather_ids or not p1_ids <= set(ev.resources()):
    raise AssertionError('SEEPS p1 must stay resident')
  torch.cuda.synchronize()
  setup = time.perf_counter() - t0
  t0 = time.perf_counter()
  pipe.predictions_loader.maybe_prepare_dataset()
  pipe.targets_loader.maybe_prepare_dataset()
  prepare = time.perf_counter() - t0
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = pipe.run()
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated()
  timers = {k: round(d.mean, 4) for k, d in registry.timings.items()}
  plan = 'default' if budget_bytes is None else f'{budget_bytes} B'
  log(f'{label} [{plan} budget]: {len(ev.host_gather_ids)} of '
      f'{len(ev.resources()) + len(ev.host_gather_ids)} climatology arrays '
      f'host-gathered, {ev.resource_bytes / 2**30:.3f} GiB resident; '
      f'construction (climatology opened and uploaded) {setup:.3f} s; '
      f'loaders\' one-time preparation {prepare:.3f} s; '
      f'{seconds / BENCH_INITS:.3f} s per chunk ({BENCH_INITS} chunks, wall '
      f'clock to a final synchronize), {(prepare + seconds) / BENCH_INITS:.3f} '
      f'with the preparation counted in; per-chunk means (s) '
      f'{json.dumps(timers)}; peak device memory {peak / 2**30:.2f} GiB; '
      f'card {card}')
  return pipe, state, seconds, {'s_per_chunk': seconds / BENCH_INITS,
                                's_per_chunk_with_prepare':
                                    (prepare + seconds) / BENCH_INITS,
                                'construction_s': setup,
                                'prepare_s': prepare, **timers}


def bench_weights(aggregator):
  """(region, lat, lon) float64 area weights x bins on the card, ascending
  latitude, and each bin's effective size per init (Kish)."""
  import torch
  from weatherbenchx_tpu_torch.darray import DimArray
  lat = np.linspace(-90, 90, BENCH_GRID[0])
  lon = np.arange(BENCH_GRID[1]) * (360 / BENCH_GRID[1])
  grid = DimArray(np.zeros(BENCH_GRID, np.float32), ('latitude', 'longitude'),
                  {'latitude': lat, 'longitude': lon})
  w = torch.from_numpy(np.asarray(
      aggregator.weigh_by[0].weights(grid).values, np.float64)).to(DEVICE)
  bins = torch.from_numpy(aggregator.bin_by[0].create_bin_mask(grid).values
                          ).to(DEVICE).double()
  wb = w[None, :, None] * bins
  n_eff = wb.sum((1, 2)) ** 2 / (wb ** 2).sum((1, 2))
  return wb, n_eff


def bench_f64_reference(stores, wb) -> dict:
  """Every metric value recomputed in float64 on the card from the host
  stores: explicit weighted sums over (init, lat, lon) per lead, level and
  region; independent of the port's statistics, alignment and
  aggregation."""
  import torch
  from weatherbenchx_tpu_torch.apps import configs
  preds, tgts, clim = (stores[k] for k in ('predictions', 'targets',
                                           'climatology'))

  def card(store, name, flip):
    x = store[name].data.to(DEVICE, torch.float64)
    return x.flip(-2) if flip else x

  def wsum(s, w=wb):  # (lead, [level], lat, lon) -> (lead, [level], region)
    return torch.einsum('l...yx,ryx->l...r', s, w)

  num, den = {}, {}

  def add(key, s, w=wb):
    num[key] = num.get(key, 0) + wsum(s, w)
    den[key] = den.get(key, 0) + w.sum((1, 2))

  wind = {'u_component_of_wind': ('v_component_of_wind', 'wind'),
          '10m_u_component_of_wind': ('10m_v_component_of_wind', '10m_wind')}
  for k in range(BENCH_INITS):
    window = slice(2 * k, 2 * k + BENCH_LEADS)
    for name in bench_variables():
      p = card(preds, name, False)[k]
      t = card(tgts, name, True)[window]
      c = card(clim, name, True).flatten(0, 1)[window]
      add(('se', name), (p - t) ** 2)
      add(('err', name), p - t)
      add(('spa', name), (p - c) ** 2)
      add(('sta', name), (t - c) ** 2)
      add(('cov', name), (p - c) * (t - c))
      if name in wind:
        v_name, vector = wind[name]
        pv = card(preds, v_name, False)[k]
        tv = card(tgts, v_name, True)[window]
        add(('wse', vector), (p - t) ** 2 + (pv - tv) ** 2)
      if name in configs.SEEPS_DRY_THRESHOLDS_MM:
        add(('seeps', name),
            *bench_seeps_reference(clim, name, p, t, window, wb))
      del p, t, c
  mean = {key: num[key] / (den[key] * 1.0) for key in num}
  out = {}
  for name in bench_variables():
    out[f'rmse.{name}'] = mean[('se', name)].sqrt()
    out[f'mse.{name}'] = mean[('se', name)]
    out[f'bias.{name}'] = mean[('err', name)]
    out[f'acc.{name}'] = mean[('cov', name)] / (
        mean[('spa', name)].sqrt() * mean[('sta', name)].sqrt())
    out[f'prediction_activity.{name}'] = mean[('spa', name)].sqrt()
    if name in configs.SEEPS_DRY_THRESHOLDS_MM:
      out[f'seeps.{name}'] = mean[('seeps', name)]
  for vector in ('wind', '10m_wind'):
    out[f'vector_rmse.{vector}'] = mean[('wse', vector)].sqrt()
  return out


def bench_seeps_reference(clim, name, p, t, window, wb):
  """(score, weights) of SEEPS in float64: the port's semantics (a NaN
  wet threshold scores 0; p1 the float32 mean dry fraction; points with
  p1 outside [0.1, 0.85] carry no weight), with the float32 images of the
  constants the port compares float32 data against."""
  import torch
  from weatherbenchx_tpu_torch.apps import configs
  def card(key):
    return clim[key].data.to(DEVICE, torch.float64).flip(-2)

  wet = card(f'{name}_seeps_threshold').flatten(0, 1)[window]
  p1 = card(f'{name}_seeps_dry_fraction').mean((0, 1)).float().double()
  lo = float(np.float32(configs.SEEPS_DRY_THRESHOLDS_MM[name] / 1000))

  def bands(x):
    return x <= lo, (x > lo) & (x < wet), x >= wet

  fd, fl, fh = bands(p)
  td, tl, th = bands(t)
  score = 0.5 * ((fd & tl) * (1 / (1 - p1)) + (fd & th) * (4 / (1 - p1))
                 + (fl & td) * (1 / p1) + (fl & th) * (3 / (1 - p1))
                 + (fh & td) * (1 / p1 + 3 / (2 + p1))
                 + (fh & tl) * (3 / (2 + p1)))
  keep = ((p1 >= float(np.float32(0.1)))
          & (p1 <= float(np.float32(0.85)))).double()
  return score * keep, wb * keep


def check_bench_values(values: dict, ref: dict, n_eff, masked_p1: dict
                       ) -> float:
  """Every metric: dims, finite, within BENCH_F64_RTOL of float64 and (all
  but SEEPS) within BENCH_SIGMAS standard errors of its closed form."""
  import torch
  from weatherbenchx_tpu_torch.apps import configs
  worst = 0.0
  n_indep = n_eff * BENCH_INITS
  for key, want in ref.items():
    metric, name = key.split('.', 1)
    da = values[key]
    lev = name in configs.UPPER_LEVEL_VARIABLES or name == 'wind'
    dims = ('lead_time',) + (('level',) if lev else ()) + ('region',)
    shape = (BENCH_LEADS,) + ((len(BENCH_LEVELS),) if lev else ()) + (34,)
    if da.dims != dims or da.shape != shape:
      raise AssertionError(f'{key}: dims {da.dims} shape {da.shape}')
    got = da.data.to(DEVICE).double()
    if not bool(torch.isfinite(got).all()):
      raise AssertionError(f'{key}: non-finite values')
    scale = PRECIP_SCALE if name in configs.PRECIPITATION_VARIABLES else 1.0
    value, sd, power = BENCH_CLOSED_FORMS.get(metric, (None, None, 1))
    floor = scale ** power
    rel = ((got - want).abs() / want.abs().clamp(min=floor)).max().item()
    if rel > BENCH_F64_RTOL:
      raise AssertionError(f'{key}: rel err vs float64 {rel:.3g} > '
                           f'{BENCH_F64_RTOL}')
    worst = max(worst, rel)
    if value is None:
      continue
    tol = BENCH_SIGMAS * sd * floor / n_indep.sqrt()  # per region
    dev = (got - value * floor).abs() / tol
    if dev.max().item() > 1:
      raise AssertionError(f'{key}: {dev.max().item():.3g} tolerances from '
                           f'the closed form {value * floor:.6g}')
  for metric, (value, sd, _) in BENCH_CLOSED_FORMS.items():
    names = ['wind', '10m_wind'] if metric == 'vector_rmse' else [
        'geopotential', '2m_temperature']
    for name in names:
      got = values[f'{metric}.{name}'].data.double()
      log(f'benchmark path {metric}.{name}: mean {got.mean().item():.6f}, '
          f'closed form {value:.6f}; global bin range '
          f'[{got[..., 0].min().item():.6f}, {got[..., 0].max().item():.6f}]')
  for name in configs.PRECIPITATION_VARIABLES:
    got = values[f'seeps.{name}'].data.double()
    log(f'benchmark path seeps.{name}: mean {got.mean().item():.6f} '
        '(no closed form; held to float64 only)')
  for name, p1 in masked_p1.items():
    log(f'benchmark path seeps.{name}: p1 outside [0.1, 0.85] at '
        f'{p1:.2%} of gridpoints (masked)')
  log(f'benchmark path: {len(ref)} metric arrays within {worst:.3g} of '
      f'float64 (tol {BENCH_F64_RTOL}); closed forms within '
      f'{BENCH_SIGMAS} standard errors (smallest bin effective size '
      f'{int(n_indep.min().item())})')
  return worst


def benchmark_path(seed: int, card: str) -> tuple:
  """Phase 6: the deterministic benchmark path at full width, under the
  default budget (every climatology resident) and under a budget below
  the climatology's size (the largest arrays host-gathered); the two
  states equal by torch.equal. Returns (seconds per chunk, the stores, the
  resident run's state, its timings)."""
  import torch
  t0 = time.perf_counter()
  stores = bench_stores(seed)
  nbytes = sum(da.data.numel() * da.data.element_size()
               for key in ('predictions', 'targets', 'climatology')
               for da in stores[key].values())
  log(f'benchmark path: made {len(bench_variables())} variables '
      f'({len(BENCH_LEVELS)} levels upper-air), {nbytes / 2**30:.2f} GiB of '
      f'host stores, in {time.perf_counter() - t0:.1f} s')
  pipe, state, seconds, timings = run_bench(stores, None, card)
  ev = pipe._evaluator
  if ev.host_gather_ids:
    raise AssertionError('the default budget should keep every climatology '
                         f'resident; {len(ev.host_gather_ids)} were demoted')
  values = state.metric_values(pipe.metrics)
  wb, n_eff = bench_weights(pipe.aggregator)
  masked_p1 = {
      name: float(((p1.data < np.float32(0.1)) | (p1.data > np.float32(0.85))
                   ).float().mean())
      for name, p1 in pipe.metrics['seeps']._p1.items()}
  check_bench_values(values, bench_f64_reference(stores, wb), n_eff,
                     masked_p1)
  budget = ev.resource_bytes // 2
  del pipe, values, wb
  torch.cuda.empty_cache()
  pipe2, state2, seconds2, _ = run_bench(stores, budget, card)
  demoted = len(pipe2._evaluator.host_gather_ids)
  if not demoted:
    raise AssertionError('a budget below the climatology demoted nothing')
  got, want = state2.to_dataset(), state.to_dataset()
  if sorted(got) != sorted(want) or not all(
      torch.equal(got[k].data, want[k].data) for k in want):
    raise AssertionError('host-gather and resident states differ')
  log(f'benchmark path: resident and host-gather states equal by '
      f'torch.equal ({len(want)} arrays; {demoted} arrays demoted under '
      f'{budget} B)')
  del pipe2
  torch.cuda.empty_cache()
  batched = batched_benchmark_path(stores, state, budget, card)
  return ({'resident_s_per_chunk': seconds / BENCH_INITS,
           'host_gather_s_per_chunk': seconds2 / BENCH_INITS,
           'batched': batched}, stores, state, timings)


# Phase 9's stores on disk, written where git ignores them, and the room
# they need: about 6 GB of float32 fields that barely compress, with
# room to spare.
DISK_STORE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              'build', 'chip_smoke_stores')
DISK_STORE_NEEDS_BYTES = 12 * 2**30
# The containers: WeatherBench 2's public stores are zarr v2 with
# blosc-lz4 and byte shuffle, one (init, lead, level) field per cell.
DISK_CONTAINERS = {
    'predictions': ('predictions.zarr', {
        'compressor': 'blosc', 'zarr_format': 2, 'chunks': {
            'time': 1, 'prediction_timedelta': 1, 'level': 1}}),
    'targets': ('targets.zarr', {
        'compressor': 'zstd', 'zarr_format': 3,
        'chunks': {'time': 1, 'level': 1}, 'shards': {'time': 7}}),
    'climatology': ('climatology.wbx', None),
}


def tree_bytes(path: str) -> int:
  if os.path.isfile(path):
    return os.path.getsize(path)
  return sum(os.path.getsize(os.path.join(root, f))
             for root, _, files in os.walk(path) for f in files)


def time_target_flip(stores, path: str, card: str) -> dict:
  """The first chunk's targets read from the on-disk store by the loader,
  with and without sort_latitude's latitude flip, in turns (flip, plain,
  plain, flip), each read's native decode seconds beside it: the flip's
  cost apart from the decode. The flipped chunk must equal the plain one
  reversed along latitude."""
  import torch
  from weatherbenchx_tpu_torch import native, time_chunks
  from weatherbenchx_tpu_torch.apps import configs
  from weatherbenchx_tpu_torch.data import loaders
  inits, leads = time_chunks.TimeChunks(
      stores['inits'], stores['leads'], init_time_chunk_size=1,
      lead_time_chunk_size=BENCH_LEADS)[0]
  reads, chunks = {'flip': [], 'plain': []}, {}
  for name in ('flip', 'plain', 'plain', 'flip'):
    loader = loaders.TargetsFromDataset(
        path=path, variables=bench_variables(),
        sel_kwargs={'level': list(BENCH_LEVELS)},
        preprocessing_fn=configs.sort_latitude if name == 'flip' else None)
    loader.maybe_prepare_dataset()
    native.reset_call_counts()
    t0 = time.perf_counter()
    chunks[name] = loader.load_chunk(inits, leads)
    seconds = time.perf_counter() - t0
    reads[name].append({'seconds': seconds,
                        'decode_ranges_s': native.SECONDS['decode_ranges']})
  for k, da in chunks['plain'].items():
    if 'latitude' in da.dims and not torch.equal(
        chunks['flip'][k].data,
        da.data.flip(da.dims.index('latitude'))):
      raise AssertionError(f'{k}: the flipped targets are not the plain '
                           'ones reversed along latitude')
  out = {name: {key: float(np.median([r[key] for r in rs]))
                for key in rs[0]} for name, rs in reads.items()}
  log(f'disk benchmark path: one chunk of targets read with the latitude '
      f'flip {out["flip"]["seconds"]:.3f} s (native decode '
      f'{out["flip"]["decode_ranges_s"]:.3f} s), without it '
      f'{out["plain"]["seconds"]:.3f} s (decode '
      f'{out["plain"]["decode_ranges_s"]:.3f} s); medians of 2 reads each, '
      f'in turns; card {card}')
  return out


def disk_benchmark_path(stores, want_state, in_memory: dict,
                        card: str) -> dict:
  """Phase 9: phase 6's stores written to disk by the port's writers and
  evaluated from there through the CLI's construction (lazy opens); the
  state equal to phase 6's by torch.equal. Fails unless the native
  blockstore and zarr codec are built and called."""
  import shutil
  import torch
  from weatherbenchx_tpu_torch import io, native, zarr_io
  if not (native.blockstore_available() and native.zarrcodec_available()):
    raise AssertionError('the native blockstore and zarr codec must build '
                         'on the card\'s machine (g++, zlib, zstd, lz4)')
  shutil.rmtree(DISK_STORE_DIR, ignore_errors=True)
  os.makedirs(DISK_STORE_DIR)
  free = shutil.disk_usage(DISK_STORE_DIR).free
  if free < DISK_STORE_NEEDS_BYTES:
    raise AssertionError(f'{DISK_STORE_DIR}: {free} bytes free, the stores '
                         f'need {DISK_STORE_NEEDS_BYTES}')
  try:
    native.reset_call_counts()
    paths, writes = {}, {}
    for key, (name, zarr_kwargs) in DISK_CONTAINERS.items():
      path = paths[key] = os.path.join(DISK_STORE_DIR, name)
      nbytes = sum(da.data.numel() * da.data.element_size()
                   for da in stores[key].values())
      t0 = time.perf_counter()
      if zarr_kwargs is None:
        io.save_dataset(path, stores[key])
      else:
        zarr_io.save_dataset_zarr(path, stores[key], **zarr_kwargs)
      seconds = time.perf_counter() - t0
      on_disk = tree_bytes(path)
      writes[key] = {'seconds': seconds, 'GB_per_s': nbytes / seconds / 1e9,
                     'array_bytes': nbytes, 'bytes_on_disk': on_disk}
      log(f'disk benchmark path: wrote {key} ({name}, {nbytes} bytes of '
          f'arrays, {on_disk} bytes on disk) in {seconds:.3f} s, '
          f'{nbytes / seconds / 1e9:.3f} GB/s; card {card}')
    write_calls = {k: (native.CALLS[k], native.BYTES[k]) for k in native.CALLS}
    native.reset_call_counts()
    _, state, _, timings = run_bench(
        stores, None, card, bench_sources(stores, paths),
        label='disk benchmark path')
    run_calls = {k: (native.CALLS[k], native.BYTES[k]) for k in native.CALLS}
    run_native_s = dict(native.SECONDS)
    log(f'disk benchmark path: native (calls, array bytes) while writing '
        f'{write_calls}; while evaluating {BENCH_INITS} chunks {run_calls}')
    # Each loader thread calls its native reads one after another, so a
    # function's seconds over the chunks split its loader's per-chunk mean
    # into the native read and decode and the Python around it (axis plans,
    # shard indexes, the scatter into the window; for the predictions also
    # the statistics' host preparation). The construction's few calls (the
    # land-sea mask) are counted in.
    loads = {}
    for timer, fn in (('load_targets_seconds', 'decode_ranges'),
                      ('load_predictions_seconds', 'decode_cells')):
      total, in_native = timings[timer], run_native_s[fn] / BENCH_INITS
      loads[timer] = {'seconds': total, f'native_{fn}_s': in_native,
                      'python_s': total - in_native}
      log(f'disk benchmark path: {timer} {total:.3f} s per chunk, of which '
          f'native {fn} {in_native:.3f} s and the Python around it '
          f'{total - in_native:.3f} s; card {card}')
    log(f'disk benchmark path: native seconds while evaluating '
        f'{BENCH_INITS} chunks {json.dumps(run_native_s)}; card {card}')
    if not (write_calls['pwrite_blocks'][0] and write_calls['encode_cells'][0]
            and write_calls['encode_buffers'][0]
            and run_calls['decode_cells'][0]
            and run_calls['decode_ranges'][0]):
      raise AssertionError('the native blockstore and zarr codec must carry '
                           'the writes and the reads')
    got, want = state.to_dataset(), want_state.to_dataset()
    if sorted(got) != sorted(want) or not all(
        torch.equal(got[k].data, want[k].data) for k in want):
      raise AssertionError('the on-disk run\'s state differs from the '
                           'in-memory run\'s')
    log(f'disk benchmark path: state equal to phase 6\'s by torch.equal '
        f'({len(want)} arrays); seconds per chunk {timings["s_per_chunk"]:.3f} '
        f'on disk vs {in_memory["s_per_chunk"]:.3f} in memory (this run); '
        f'one-time preparation {timings["prepare_s"]:.3f} vs '
        f'{in_memory["prepare_s"]:.3f} s; card {card}')
    flip = time_target_flip(stores, paths['targets'], card)
  finally:
    shutil.rmtree(DISK_STORE_DIR, ignore_errors=True)
  return {'writes': writes, 'on_disk': timings, 'in_memory': in_memory,
          'loads': loads, 'target_flip': flip,
          'native_calls': {'write': write_calls, 'evaluate': run_calls},
          'native_seconds': run_native_s}


# The benchmark CLI phase: the demo recipe at 64 x 32 (1.6 M-gridpoint
# fields are not needed to exercise the CLI), ECMWF dim names, 8 inits 12 h
# apart x 4 leads, geopotential at 3 levels and 2m temperature; and an
# 8-member N(0, 1) ensemble against N(0, 1) analyses.
BENCH_CLI_GRID = (32, 64)
BENCH_CLI_INITS = 8
BENCH_CLI_MEMBERS = 8


def bench_cli_stores(tmp: str, seed: int) -> dict:
  """Writes the CLI phase's .npz stores with the port's io; returns paths."""
  from weatherbenchx_tpu_torch import io
  from weatherbenchx_tpu_torch.darray import DimArray
  rng = np.random.default_rng([seed, 3000])
  nlat, nlon = BENCH_CLI_GRID
  space = {'latitude': np.linspace(-90, 90, nlat),
           'longitude': np.arange(nlon) * (360 / nlon)}
  inits = (np.datetime64('2020-01-01', 'ns')
           + np.arange(BENCH_CLI_INITS) * np.timedelta64(12, 'h'))
  leads = (np.arange(4) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
  n_valid = 2 * (BENCH_CLI_INITS - 1) + 4
  valid = (np.datetime64('2020-01-01', 'ns')
           + np.arange(n_valid) * np.timedelta64(6, 'h'))
  vpos = (2 * np.arange(BENCH_CLI_INITS)[:, None]
          + np.arange(4)[None, :]).reshape(-1)
  n_days = (n_valid + 3) // 4
  pred, tgt, clim, ens, ens_tgt = {}, {}, {}, {}, {}
  for name, lev in (('geopotential', True), ('2m_temperature', False)):
    fshape = ((3,) if lev else ()) + BENCH_CLI_GRID
    fdims = (('level',) if lev else ()) + ('latitude', 'longitude')
    lcoords = {'level': np.array(BENCH_LEVELS)} if lev else {}

    def rand(*lead):
      return rng.standard_normal(lead + fshape, dtype=np.float32)

    c = rand(4 * n_days)
    zc = rand(n_valid)
    tgt[name] = DimArray(c[:n_valid] + zc + rand(n_valid), ('time',) + fdims,
                         {'time': valid, **space, **lcoords})
    pred[name] = DimArray(
        (c[vpos] + zc[vpos]).reshape((BENCH_CLI_INITS, 4) + fshape)
        + rand(BENCH_CLI_INITS, 4), ('time', 'prediction_timedelta') + fdims,
        {'time': inits, 'prediction_timedelta': leads, **space, **lcoords})
    clim[name] = DimArray(
        c.reshape((n_days, 4) + fshape), ('dayofyear', 'hour') + fdims,
        {'dayofyear': np.arange(1, n_days + 1),
         'hour': np.array([0, 6, 12, 18]), **space, **lcoords})
    ens[name] = DimArray(
        rand(BENCH_CLI_MEMBERS, BENCH_CLI_INITS, 4),
        ('number', 'time', 'prediction_timedelta') + fdims,
        {'number': np.arange(BENCH_CLI_MEMBERS), 'time': inits,
         'prediction_timedelta': leads, **space, **lcoords})
    ens_tgt[name] = DimArray(rand(n_valid), ('time',) + fdims,
                             {'time': valid, **space, **lcoords})
  paths = {}
  for key, ds in (('hres', pred), ('era5', tgt), ('clim', clim),
                  ('ens', ens), ('ens_era5', ens_tgt)):
    paths[key] = os.path.join(tmp, f'{key}.npz')
    io.save_dataset(paths[key], ds)
  return paths


def run_bench_cli(args: list) -> str:
  """The benchmark CLI's main over phase 8's stores, in this process; what
  it printed."""
  return run_main('weatherbenchx_tpu_torch.apps.run_benchmark_evaluation', [
      '--device', DEVICE, '--init_time_start=2020-01-01',
      f'--init_time_stop=2020-01-{1 + BENCH_CLI_INITS // 2:02d}',
      '--lead_time_stop_days=1', '--resolution=64x32', *args])


def global_n_eff() -> float:
  """Effective size (Kish, area weights) of the global bin of one init at
  BENCH_CLI_GRID, times the inits."""
  from weatherbenchx_tpu_torch import weighting
  from weatherbenchx_tpu_torch.darray import DimArray
  grid = DimArray(np.zeros(BENCH_CLI_GRID, np.float32),
                  ('latitude', 'longitude'),
                  {'latitude': np.linspace(-90, 90, BENCH_CLI_GRID[0]),
                   'longitude': np.arange(BENCH_CLI_GRID[1]) * 5.625})
  w = np.broadcast_to(np.asarray(
      weighting.GridAreaWeighting().weights(grid).values, np.float64)[:, None],
                      BENCH_CLI_GRID)
  return float(w.sum() ** 2 / (w ** 2).sum()) * BENCH_CLI_INITS


def ensemble_sds(m: int) -> dict:
  """Per-gridpoint standard deviations, by simulation on the card (4 M
  draws), of the statistics behind the ensemble metrics for an m-member
  N(0, 1) ensemble against N(0, 1): fair CRPS; the log spread/skill ratio's
  numerator minus denominator (delta method: the ratio's standard error
  is half that over the root of the size); and the squared ensemble-mean
  error (the RMSE's is that over 2 RMSE)."""
  import torch
  gen = torch.Generator(device=DEVICE)
  gen.manual_seed(7)
  x = torch.randn((m, 1 << 22), generator=gen, device=DEVICE,
                  dtype=torch.float64)
  y = torch.randn((1 << 22,), generator=gen, device=DEVICE,
                  dtype=torch.float64)
  skill = (x - y).abs().mean(0)
  xs = x.sort(0).values
  k = torch.arange(1, m + 1, device=DEVICE, dtype=torch.float64)[:, None]
  spread = 2 * ((2 * k - m - 1) * xs).sum(0) / (m * (m - 1))
  var = x.var(0, correction=1)
  sq = (x.mean(0) - y) ** 2
  return {'crps': (skill - 0.5 * spread).std().item(),
          'spread_skill': (var - (sq - var / m)).std().item(),
          'mean_rmse_sq': sq.std().item()}


def kernel_launches(stdout: str) -> dict:
  line = [l for l in stdout.splitlines() if l.startswith('Kernel launches: ')]
  return json.loads(line[-1].removeprefix('Kernel launches: '))


def bench_cli_from_zarr(tmp: str, paths: dict, det: dict, ens: dict) -> dict:
  """Phase 8's CLI runs again from zarr v2 blosc-lz4 copies of the stores
  (one field per cell, as WeatherBench 2's public stores), the metrics
  written as zarr, netCDF and wbx; each equal to its .npz run bit for bit.
  Returns the ensemble run's kernel launches."""
  from weatherbenchx_tpu_torch import io, zarr_io
  zpaths = {}
  for key, path in paths.items():
    zpaths[key] = path[:-4] + '.zarr'
    zarr_io.save_dataset_zarr(
        zpaths[key], io.load_dataset(path), compressor='blosc',
        chunks={'time': 1, 'prediction_timedelta': 1, 'level': 1,
                'number': 1})
  out = None
  for prediction, fmt, want in (('hres', 'zarr', det), ('hres', 'nc', det),
                                ('ens', 'wbx', ens)):
    args = [f'--prediction={prediction}',
            f'--prediction_path={zpaths[prediction]}',
            '--variables=geopotential,2m_temperature',
            f'--output_dir={tmp}/{prediction}_{fmt}',
            f'--output_format={fmt}']
    if prediction == 'hres':
      args += [f'--target_path={zpaths["era5"]}',
               f'--climatology_path={zpaths["clim"]}']
    else:
      args += [f'--target_path={zpaths["ens_era5"]}']
    stdout = run_bench_cli(args)
    if prediction == 'ens':
      out = stdout
    got = io.load_dataset(f'{tmp}/{prediction}_{fmt}/{prediction}_vs_era5_'
                          f'64x32_2020-init12h.{fmt}')
    if sorted(got) != sorted(want) or not all(
        got[k].dims == want[k].dims
        and np.array_equal(got[k].values, want[k].values, equal_nan=True)
        for k in want):
      raise AssertionError(f'benchmark CLI {prediction} from zarr ({fmt} '
                           'output) differs from its .npz run')
    log(f'benchmark cli: {prediction} from zarr v2 blosc stores, {fmt} '
        'output, equal to the .npz run bit for bit ok')
  return kernel_launches(out)


def bench_cli_unaggregated(tmp: str, paths: dict, det: dict) -> None:
  """Phase 8's deterministic run again with --unaggregated_zarr, into a
  zarr v2 blosc store and a v3 sharded zstd store: the metrics equal to the
  run without it bit for bit, and the stored squared errors of
  geopotential equal to (prediction - target)^2 from the .npz stores."""
  import torch
  from weatherbenchx_tpu_torch import io, zarr_io
  pred = io.load_dataset(paths['hres'])['geopotential'].values
  tgt = io.load_dataset(paths['era5'])['geopotential'].values
  vpos = 2 * np.arange(BENCH_CLI_INITS)[:, None] + np.arange(4)[None, :]
  want = (torch.from_numpy(pred) - torch.from_numpy(tgt[vpos])) ** 2
  for label, extra in (
      ('zarr v2 blosc', ['--zarr_compressor=blosc']),
      ('zarr v3 sharded zstd', ['--zarr_format=3', '--zarr_compressor=zstd',
                                '--zarr_shards=init_time=4,lead_time=4'])):
    out = f'{tmp}/unagg_{len(extra)}'
    t0 = time.perf_counter()
    run_bench_cli(['--prediction=hres', f'--prediction_path={paths["hres"]}',
                   f'--target_path={paths["era5"]}',
                   f'--climatology_path={paths["clim"]}',
                   '--variables=geopotential,2m_temperature',
                   f'--output_dir={out}', '--unaggregated_zarr', *extra])
    seconds = time.perf_counter() - t0
    got = io.load_dataset(f'{out}/hres_vs_era5_64x32_2020-init12h.npz')
    if sorted(got) != sorted(det) or not all(
        np.array_equal(got[k].values, det[k].values, equal_nan=True)
        for k in det):
      raise AssertionError(f'benchmark CLI with --unaggregated_zarr ({label}) '
                           'changed the metrics')
    stats = zarr_io.open_dataset_zarr(
        f'{out}/hres_vs_era5_64x32_2020-init12h_stats.zarr')
    se = stats['SquaredError.geopotential'].transpose(
        'init_time', 'lead_time', 'level', 'latitude', 'longitude').data
    _, rel, _ = rel_err(se, want)
    if se.shape != want.shape or rel > 1e-6:
      raise AssertionError(f'benchmark CLI {label} store: SquaredError '
                           f'{tuple(se.shape)}, {rel:.3g} from the stores')
    log(f'benchmark cli --unaggregated_zarr ({label}): {len(stats)} '
        f'statistic arrays, SquaredError.geopotential {tuple(se.shape)} within '
        f'{rel:.3g} of (prediction - target)^2; metrics equal to the run '
        f'without the flag bit for bit; {seconds:.1f} s ok')


def benchmark_cli_phase(seed: int) -> dict:
  """Phase 8: python -m ...run_benchmark_evaluation --device cuda on .npz
  stores, deterministic (RMSE = sqrt(2), ACC = 1/2) and --prediction=ens
  (CRPS = 1/sqrt(pi), unbiased spread/skill = 1, ensemble-mean RMSE =
  sqrt(1 + 1/8), one fused launch per chunk and variable at least).
  Returns the ensemble run's launches and the two outputs by file name
  (phase 15(d) combines them)."""
  from weatherbenchx_tpu_torch import io
  n = global_n_eff()
  with tempfile.TemporaryDirectory() as tmp:
    paths = bench_cli_stores(tmp, seed)
    t0 = time.perf_counter()
    run_bench_cli(['--prediction=hres', f'--prediction_path={paths["hres"]}',
                   f'--target_path={paths["era5"]}',
                   f'--climatology_path={paths["clim"]}',
                   '--variables=geopotential,2m_temperature',
                   f'--output_dir={tmp}/det'])
    det = io.load_dataset(
        f'{tmp}/det/hres_vs_era5_64x32_2020-init12h.npz')
    det_s = time.perf_counter() - t0
    bench_cli_unaggregated(tmp, paths, det)
    t0 = time.perf_counter()
    out = run_bench_cli(['--prediction=ens',
                         f'--prediction_path={paths["ens"]}',
                         f'--target_path={paths["ens_era5"]}',
                         '--variables=geopotential,2m_temperature',
                         f'--output_dir={tmp}/ens'])
    ens = io.load_dataset(f'{tmp}/ens/ens_vs_era5_64x32_2020-init12h.npz')
    ens_s = time.perf_counter() - t0
    launches = kernel_launches(out)
    zarr_launches = bench_cli_from_zarr(tmp, paths, det, ens)
  if zarr_launches != launches:
    raise AssertionError(f'the ensemble run from zarr launched '
                         f'{zarr_launches}, from .npz {launches}')
  n_chunks = BENCH_CLI_INITS  # one init per chunk, its 4 leads in one
  if launches['fused_ensemble_stats'] < n_chunks:
    raise AssertionError(f'expected >= {n_chunks} fused launches (one per '
                         f'chunk), got {launches}')
  sds = ensemble_sds(BENCH_CLI_MEMBERS)
  m = BENCH_CLI_MEMBERS
  checks = [
      (det, 'rmse', math.sqrt(2), 1.0),
      (det, 'acc', 0.5, 0.75),
      (ens, 'crps', 1 / math.sqrt(math.pi), sds['crps']),
      (ens, 'unbiased_spread_skill', 1.0, 0.5 * sds['spread_skill']),
      (ens, 'mean_rmse', math.sqrt(1 + 1 / m),
       sds['mean_rmse_sq'] / (2 * math.sqrt(1 + 1 / m))),
  ]
  for ds, metric, value, sd in checks:
    tol = BENCH_SIGMAS * sd / math.sqrt(n)
    for name in ('geopotential', '2m_temperature'):
      da = ds[f'{metric}.{name}']
      glob = da.values[..., list(da.coord_values('region')).index('global')]
      far = float(np.abs(glob - value).max())
      if not np.isfinite(glob).all() or far > tol:
        raise AssertionError(f'benchmark CLI {metric}.{name}: {glob} is '
                             f'{far:.4g} from {value:.6f} (tol {tol:.4g})')
      log(f'benchmark cli {metric}.{name}: global bin mean '
          f'{glob.mean():.6f} vs {value:.6f} (max dev {far:.4g}, tol '
          f'{tol:.4g}) ok')
  log(f'benchmark cli: deterministic {det_s:.1f} s, ensemble {ens_s:.1f} s '
      f'(in this process); ensemble kernel launches {launches}')
  return launches, {'hres_vs_era5_64x32_2020-init12h.npz': det,
                    'ens_vs_era5_64x32_2020-init12h.npz': ens}


def time_cuda(fns: dict, rounds: int, reps: int = 1) -> dict:
  """Median and IQR (ms per call) per function, taken in turns: CUDA
  events around ``reps`` calls back to back, so that the host's launch
  overhead hides behind the device's work."""
  import torch
  samples = {k: [] for k in fns}
  names = list(fns)
  for r in range(rounds + 1):
    for name in (names if r % 2 == 0 else names[::-1]):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(reps):
        fns[name]()
      end.record()
      end.synchronize()
      if r:  # round 0 warms up
        samples[name].append(start.elapsed_time(end) / reps)
  return {k: (float(np.median(v)), float(np.percentile(v, 25)),
              float(np.percentile(v, 75)), len(v))
          for k, v in samples.items()}


def blocksort_ops(m: int) -> int:
  """Operations of the block sort's own network on m members
  (csrc/blocksort_stats.cu), per point, a diagnostic beside its bound
  (O(M log^2 M), several times what a sort needs): the min and max of each
  compare-exchange it runs (the runs'
  networks of 32; each shared pass's items, G <= 4 stages of 2^(G-1) each;
  a register pass of 80 a run per level), the last level's neighbour min
  and the gap's difference and multiply-add per member, and the NaN and
  +-inf tests on load."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  run = cp.BLOCKSORT_RUN
  runs = -(-m // run)
  log2v = (m - 1).bit_length()
  ces = runs * len(cp.sort_network(run))
  for level in range(6, log2v + 1):
    pivot = level - 1
    while pivot >= 5:
      g = min(4, pivot - 4)  # the kernel's kMaxStages a shared pass
      low = pivot - g + 1
      hi, rem = (m - 1) >> (low + g), (m - 1) & ((1 << (low + g)) - 1)
      items = (hi << low) + min(rem, (1 << low) - 1) + 1
      ces += items * g * 2 ** (g - 1)
      pivot -= g
    ces += runs * 80
  return 2 * ces + 6 * m


def sort_ops(m: int) -> int:
  """The comparisons any comparison sort of m members needs, log2(m!)
  rounded up: the work of a block sort's function, whatever network runs
  it."""
  return math.ceil(math.lgamma(m + 1) / math.log(2))


def stats_work(m: int, n: int, fused: bool) -> tuple:
  """(bytes, operations) of the fused or spread-only kernel on float32
  x (m, n), in the form spread_form(m): each input read once, each output
  written once; per point the compare-exchanges' min and max, the shift
  and weighted sum and the NaN test (network); the compare-exchanges of
  each sorted run, a compare per further run head and member taken by the
  merge walks, a difference and a multiply-add per pair of mirrored ranks
  and the NaN test (sorted); the comparisons any sort of m members needs
  (sort_ops), a difference and a multiply-add per gap and the NaN test,
  not the block sort's own network (blocksort_ops; blocksort and
  mergesort, whose scratch traffic mergesort_traffic models); fused adds
  the sum, skill, mean and squared deviations."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  form = cp.spread_form(m)
  if form == 'network':
    ops = 2 * len(cp.sort_network(m)) + 3 * m
  elif form == 'sorted':
    runs, size = cp.sorted_runs(m)
    ops = runs * 2 * len(cp.sort_network(size)) + (runs - 1) * m + 2 * m
  else:
    ops = sort_ops(m) + 3 * m
  if fused:
    ops += 5 * m + 1
  nbytes = 4 * n * (m + (1 + 4 if fused else 1))
  return nbytes, ops * n


def mergesort_traffic(m: int, n: int, runs: int, words: int,
                      fused: bool) -> dict:
  """A model of the bytes a merge sort of float32 x (m, n) moves in device
  memory, not a measurement (no counter of the card's traffic can be read
  here): `runs` runs and `words` float32 scratch words a point
  (crps_pairwise.mergesort_plan); the input and outputs once; each sorted
  run written to the scratch, each merge but the last reading and writing
  the columns once, the last reading them once; the partial sums (the
  words past the two columns) written and read once. The merge-path
  searches' few words a tile and the fused last merge's reads of the runs'
  sums are left out."""
  levels = runs.bit_length() - 2  # the merges that write
  columns = 4 * m * n * (1 + levels)
  parts = 4 * n * (words - 2 * m)
  out = {'input': 4 * n * (m + (1 if fused else 0)),
         'output': 4 * n * (4 if fused else 1),
         'scratch_written': columns + parts,
         'scratch_read': columns + parts}
  out['total'] = sum(out.values())
  return out


def cross_work(mx: int, my: int, n: int) -> tuple:
  """(bytes, operations) of the cross kernel on float32 x (mx, n) and
  y (my, n): a difference and an add per pair."""
  return 4 * n * (mx + my + 1), 2 * mx * my * n


def bound(nbytes: int, ops: int) -> tuple:
  """(least ms on the card, 'bytes' or 'operations')."""
  t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
  return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                     else 'operations')


def time_kernels(x, y, yt, card: str) -> dict:
  """Phase 10's kernel timings at the paths' shapes, float32: fused and
  spread at M = 50, spread at M = 10 (the ensemble path's analysis), cross
  50 x 10, each against its plain version, TIMING_REPS calls per sample
  for both; and, in the kernels' turns, a device-to-device copy of x
  (x.clone()), the card's streaming rate. Returns {name: (median, q1, q3,
  runs)} in ms and logs each kernel beside its bound and its rate beside
  the copy's."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  n = y.numel()
  res = time_cuda({
      'fused_kernel': lambda: cp.fused_ensemble_stats(x, y),
      'spread_kernel': lambda: cp.pairwise_spread_sum(x),
      'spread10_kernel': lambda: cp.pairwise_spread_sum(yt),
      'cross_kernel': lambda: cp.pairwise_cross_sum(x, yt),
      'copy': x.clone,
  }, rounds=12, reps=TIMING_REPS)
  res.update(time_cuda({
      'fused_plain': lambda: cp.fused_ensemble_stats_plain(x, y),
      'spread_plain': lambda: cp.pairwise_spread_sum_plain(x),
      'spread10_plain': lambda: cp.pairwise_spread_sum_plain(yt),
      'cross_plain': lambda: cp.pairwise_cross_sum_plain(x, yt),
  }, rounds=6, reps=TIMING_REPS))
  m, mt = x.shape[0], yt.shape[0]
  med, q1, q3, count = res['copy']
  copy_bytes = 2 * x.numel() * x.element_size()
  log(f'timing copy (x.clone(), {copy_bytes} bytes read and written): '
      f'median {med:.4f} ms, IQR [{q1:.4f}, {q3:.4f}] ms over {count} runs; '
      f'{copy_bytes / med / 1e9:.4f} TB/s, '
      f'{copy_bytes / med * 1e3 / HBM_BYTES_PER_S:.1%} of '
      f'{HBM_BYTES_PER_S / 1e12} TB/s; card {card}')
  work = {'fused': stats_work(m, n, True), 'spread': stats_work(m, n, False),
          'spread10': stats_work(mt, n, False), 'cross': cross_work(m, mt, n)}
  for name, (med, q1, q3, count) in res.items():
    if name == 'copy':
      continue
    key, kind = name.rsplit('_', 1)
    ms, by = bound(*work[key])
    share = ''
    if kind == 'kernel':
      share = (f'{ms / med:.1%} of the bound, '
               f'{copy_share(res, work[key][0], med, copy_bytes):.1%} of the '
               'copy\'s rate; ')
    log(f'timing {name}: median {med:.4f} ms, IQR [{q1:.4f}, {q3:.4f}] ms '
        f'over {count} runs; {share}bound {ms:.4f} ms by {by}; N={n}, '
        f'float32; card {card}')
  return res


def time_sorted_form(card: str) -> dict:
  """Phase 10's row of the sorted-runs form (65..256 members): fused and
  spread-only at M = SORTED_M over GRID, float32, iid N(0, 1), checked
  against their plain versions, then timed as time_kernels times the
  others. Logs each beside its bytes bound, the replaced pair loop's (one
  operation per pair of members and point) and the operations of
  stats_work. Returns {name: (median, q1, q3, runs)} in ms."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  m, n = SORTED_M, math.prod(GRID)
  if cp.spread_form(m) != 'sorted':
    raise AssertionError(f'M = {m} routes to {cp.spread_form(m)}')
  g = torch.Generator(device=DEVICE).manual_seed(SORTED_SEED)
  x = torch.randn((m,) + GRID, generator=g, device=DEVICE)
  y = torch.randn(GRID, generator=g, device=DEVICE)
  stats_against_plain(x.reshape(m, n), y.reshape(n), f'sorted form M={m}',
                      'float32')
  res = time_cuda({
      'fused_kernel': lambda: cp.fused_ensemble_stats(x, y),
      'spread_kernel': lambda: cp.pairwise_spread_sum(x),
  }, rounds=12, reps=TIMING_REPS)
  res.update(time_cuda({
      'fused_plain': lambda: cp.fused_ensemble_stats_plain(x, y),
      'spread_plain': lambda: cp.pairwise_spread_sum_plain(x),
  }, rounds=6, reps=TIMING_REPS))
  pairs = m * (m - 1) // 2
  pair_ms = 1e3 * pairs * n / FP32_OPS_PER_S
  runs, size = cp.sorted_runs(m)
  for name, (med, q1, q3, count) in res.items():
    key, kind = name.split('_')
    nbytes, ops = stats_work(m, n, key == 'fused')
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    share = (f'{bytes_ms / med:.1%} of the bytes bound; '
             if kind == 'kernel' else '')
    log(f'timing sorted form {name} M={m} ({runs} runs of {size}): median '
        f'{med:.4f} ms, IQR [{q1:.4f}, {q3:.4f}] ms over {count} runs; '
        f'{share}bytes bound {bytes_ms:.4f} ms ({nbytes} bytes), the pair '
        f'loop\'s {pair_ms:.4f} ms ({pairs} pairs per point), operations '
        f'{1e3 * ops / FP32_OPS_PER_S:.4f} ms ({ops} by stats_work); N={n}, '
        f'float32; card {card}')
  del x, y
  return {f'sorted{m}_{k}': v for k, v in res.items()}


def copy_share(res: dict, nbytes: int, ms: float, copy_bytes: int) -> float:
  """A kernel's bytes per ms over the copy's in the same run."""
  return (nbytes / ms) / (copy_bytes / res['copy'][0])


def timing(ev, chunks, stores, card: str) -> dict:
  """Phase 10: the kernels (time_kernels) at their paths' shapes; one
  eval_chunk; the ensemble pipeline's seconds per chunk."""
  from weatherbenchx_tpu_torch import observability
  from weatherbenchx_tpu_torch.aggregation import AggregationState
  p, t = chunks[0]
  x = p['2m_temperature'].data.to(DEVICE)
  y = t['2m_temperature'].data.to(DEVICE)
  yt = stores[1]['2m_temperature'].data[:, :GRID[1]][:, None].to(
      DEVICE).contiguous()
  res = time_kernels(x, y, yt, card)
  res.update(time_sorted_form(card))
  pair = ev.prepare_pair(p, t)
  steps = time_cuda({
      'eval_chunk (host chunk in)': lambda: ev.eval_chunk(p, t),
      'eval_accum (chunk on device)':
          lambda: ev.eval_accum(pair, AggregationState.zero()),
  }, rounds=10)
  for name, (med, q1, q3, count) in steps.items():
    log(f'timing {name}: median {med:.4f} ms, IQR [{q1:.4f}, {q3:.4f}] ms '
        f'over {count} runs; M={M}, N={x[0].numel()}, float32; card {card}')
  res.update(steps)
  del x, y, yt, pair
  registry = observability.Metrics()
  _, seconds = run_ensemble_pipeline(stores, registry)
  per_chunk = {k: d.mean for k, d in registry.timings.items()}
  log(f'timing ensemble pipeline: {seconds / N_ENS_INITS:.4f} s per chunk '
      f'({N_ENS_INITS} chunks, wall clock to a final synchronize); per-chunk '
      f'means (s) {json.dumps(per_chunk)}; card {card}')
  return res


def timing_fields(res: dict, key: str, work: tuple, form: str,
                  copy_bytes: int) -> dict:
  """A kernel's time, its plain version's (both TIMING_REPS calls per
  sample), its bound and its rate against the copy's at one shape."""
  ms = res[f'{key}_kernel'][0]
  bound_ms, by = bound(*work)
  return {'ms': ms, 'plain_ms': res[f'{key}_plain'][0], 'bound_ms': bound_ms,
          'bound_by': by, 'library_ms': None, 'bytes': work[0],
          'bound_share': bound_ms / ms,
          'copy_share': copy_share(res, work[0], ms, copy_bytes),
          'form': form}


def measured_fields(ms: float, plain_ms: float, work: tuple) -> dict:
  """A kernel's time beside its plain version's and its bound, at one
  shape, with the bytes bound alone."""
  bound_ms, by = bound(*work)
  return {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
          'bound_by': by, 'library_ms': None, 'bytes': work[0],
          'operations': work[1], 'bound_share': bound_ms / ms,
          'bytes_bound_ms': 1e3 * work[0] / HBM_BYTES_PER_S}


def kernels_line(main_launches, ens_launches, main_err, res, n,
                 station, batched, large, hens, lagged, merge_regs) -> dict:
  """The `kernels` JSON: fused and spread at M = 50, cross at 50 x 10, and
  the spread's M = 10 launch (the ensemble path's analysis) beside it; the
  fused kernel's launch and error on the station path (phase 12) and its
  launch on the batched main path (phase 15(a): 3 chunks, one launch)
  beside its main path's; the fused kernel's sorted runs on phase 4b's
  path at M = 101, with phase 10's M = 100 row beside it, and the
  spread-only sorted runs' M = 100 row (on no path); the fused and
  spread-only block sorts on phase 4c's path at M = 7,424 (bound_ms by
  stats_work, with the operations of their own network, blocksort_ops,
  beside it), and the staged cross's launches there beside its main
  path's; the fused and spread-only merge sorts on phase 4d's path at M =
  59,392 (its plan, and its kernels' registers and spills beside them). No single PyTorch call computes any of the
  three functions, so library_ms is null."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  csrc = 'weatherbenchx_tpu_torch/ops/csrc/'
  replaced = 'weatherbenchx_tpu/ops/crps_pairwise.py'
  # The TPU kernel the JAX package runs for a spread of m members: its
  # _spread_kernel_sort :229 from 20 members on (_spread_form),
  # _spread_kernel :124 below.
  def spread_line(m):
    return 229 if m >= 20 else 124
  f50, f10 = cp.spread_form(M), cp.spread_form(M_TARGETS)
  n_hens = math.prod(HENS_GRID)
  register = csrc + 'register_stats.cuh'
  copy_bytes = 2 * 4 * M * n
  return {'kernels': [{
      'name': 'fused_ensemble_stats', 'route': 'cuda', 'source': register,
      'replaces': f'{replaced}:238',
      'launches': main_launches['fused_ensemble_stats'],
      'max_abs_err': max(main_err[k] for k in (
          'spread_sum', 'skill_sum', 'mean', 'sq_dev_sum')),
      **timing_fields(res, 'fused', stats_work(M, n, True), f50, copy_bytes),
      'station_path': {
          'launches': station['launches']['fused_ensemble_stats'],
          'shape': station['shape'], 'max_abs_err': station['max_abs_err']},
      'batched_path': {
          'launches': batched['launches']['fused_ensemble_stats'],
          'chunks': batched['chunks']},
  }, {
      'name': 'pairwise_spread_sum', 'route': 'cuda', 'source': register,
      'replaces': f'{replaced}:{spread_line(M)}',
      'launches': ens_launches['pairwise_spread_sum'],
      'max_abs_err': main_err['spread_only'],
      **timing_fields(res, 'spread', stats_work(M, n, False), f50,
                      copy_bytes),
      'm10': {'replaces': f'{replaced}:{spread_line(M_TARGETS)}',
              **timing_fields(res, 'spread10',
                              stats_work(M_TARGETS, n, False), f10,
                              copy_bytes)},
      f'm{SORTED_M}': {
          'source': csrc + 'sorted_stats.cuh', 'launches': 0,
          **timing_fields(res, f'sorted{SORTED_M}_spread',
                          stats_work(SORTED_M, n, False), 'sorted',
                          copy_bytes)},
  }, {
      'name': 'fused_ensemble_stats_sorted_runs', 'route': 'cuda',
      'source': csrc + 'sorted_stats.cuh', 'replaces': f'{replaced}:238',
      'launches': large['launches']['fused_ensemble_stats'],
      'max_abs_err': large['max_abs_err'],
      **timing_fields({**large['timing'], 'copy': res['copy']}, 'fused',
                      stats_work(M_LARGE, n, True), 'sorted', copy_bytes),
      'members': M_LARGE,
      f'm{SORTED_M}': timing_fields(res, f'sorted{SORTED_M}_fused',
                                    stats_work(SORTED_M, n, True), 'sorted',
                                    copy_bytes),
  }, {
      'name': 'pairwise_cross_sum', 'route': 'cuda',
      'source': csrc + 'crps_pairwise.cu', 'replaces': f'{replaced}:426',
      'launches': ens_launches['pairwise_cross_sum'],
      'max_abs_err': main_err['cross'],
      **timing_fields(res, 'cross', cross_work(M, M_TARGETS, n), 'cross',
                      copy_bytes),
      'hens_path': {
          'launches': hens['launches']['pairwise_cross_sum'],
          'shape': [M_HENS, M_TARGETS, n_hens],
          'max_abs_err': hens['max_abs_err']['cross'],
          **measured_fields(hens['timing']['cross'][0],
                            hens['plain_ms']['cross'],
                            cross_work(M_HENS, M_TARGETS, n_hens))},
  }, {
      'name': 'fused_ensemble_stats_blocksort', 'route': 'cuda',
      'source': csrc + 'blocksort_stats.cu', 'replaces': f'{replaced}:238',
      'launches': hens['launches']['fused_ensemble_stats'],
      'max_abs_err': hens['max_abs_err']['fused'],
      **measured_fields(hens['timing']['fused'][0], hens['plain_ms']['fused'],
                        stats_work(M_HENS, n_hens, True)),
      'members': M_HENS, 'points': n_hens,
      'network_operations': blocksort_ops(M_HENS) * n_hens,
  }, {
      'name': 'pairwise_spread_sum_blocksort', 'route': 'cuda',
      'source': csrc + 'blocksort_stats.cu', 'replaces': f'{replaced}:229',
      'launches': hens['launches']['pairwise_spread_sum'],
      'max_abs_err': hens['max_abs_err']['spread'],
      **measured_fields(hens['timing']['spread'][0],
                        hens['plain_ms']['spread'],
                        stats_work(M_HENS, n_hens, False)),
      'members': M_HENS, 'points': n_hens,
      'network_operations': blocksort_ops(M_HENS) * n_hens,
  }, *({
      'name': f'{name}_mergesort', 'route': 'cuda',
      'source': csrc + 'mergesort_stats.cu',
      'replaces': f'{replaced}:{line}',
      'launches': lagged['launches'][name],
      'max_abs_err': lagged['max_abs_err'][key],
      **measured_fields(lagged['timing'][key][0], lagged['plain_ms'][key],
                        stats_work(M_LAGGED, lagged['points'], key == 'fused')),
      'members': M_LAGGED, 'points': lagged['points'],
      'plan': lagged['plan'],
      'registers_and_spills': merge_regs,
  } for name, key, line in (('fused_ensemble_stats', 'fused', 238),
                            ('pairwise_spread_sum', 'spread', 229)))]}


# Phase 11, the metric families: the three families of the JAX package's
# benchmark that have no kernel of their own (FSS, rank histogram, relative
# economic value), as it defines them, on the production aggregator (the 17
# regions and their land parts, area weights, masked), and a drive of three
# binnings at once (weatherbenchx_tpu_torch/bench_families.py holds the
# cases and their float64 references). One init x 4 leads x 721 x 1440,
# float32, from the seed.
FAMILY_GRID = (1, 4, 721, 1440)
# Against float64: relative to |value|, the relative economic value (which
# crosses zero) to max(|value|, 1).
FAMILY_F64_RTOL = 1e-5
FAMILY_SIGMAS = 6.0  # closed forms: standard errors at a bin's Kish size
# The 51 ranks' means against 1: each is its own float32 contraction over a
# region's points, so they sum to 1 within float32 roundoff only (the
# float64 reference within 1e-12).
RANK_SUM_TOL = 1e-6


def device_time(fn, top: int = 3) -> tuple:
  """(ms the card was busy, [(kernel, ms), ...] the `top` longest, all
  where top is None) during one call of fn, by torch.profiler's kernel
  records; (None, []) where it records no device time."""
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    fn()
    torch.cuda.synchronize()
  # Kernel records only: an operator's record repeats its kernels' time,
  # and the port's `wbx.` ranges show on the device's timeline as
  # annotations that span their kernels.
  rows = [(e.key, e.self_device_time_total / 1e3) for e in p.key_averages()
          if e.device_type == DeviceType.CUDA
          and not e.key.startswith('wbx.')]
  rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
  if not rows:
    return None, []
  return sum(ms for _, ms in rows), rows[:top]


def family_phase(seed: int, card: str) -> dict:
  """Phase 11: each family through ChunkEvaluator.eval_chunk and
  metric_values on the card; values against float64, the same chunk twice
  to the same bits, no kernel launch counted, tensors on the card; step
  times by CUDA events, the host-fed eval_chunk and peak memory."""
  import torch
  from weatherbenchx_tpu_torch import aggregation, bench_families
  from weatherbenchx_tpu_torch.aggregation import AggregationState
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  from weatherbenchx_tpu_torch.parallel import evaluator
  grid = FAMILY_GRID
  weights = bench_families.family_weights(grid, DEVICE)
  cp.reset_launch_counts()
  report = {}
  for name in bench_families.FAMILIES:
    t0 = time.perf_counter()
    metrics, aggregator, preds, tgts = bench_families.family_case(
        name, seed, grid)
    made = time.perf_counter() - t0
    ev = evaluator.ChunkEvaluator(metrics, aggregator, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ev.eval_chunk(preds, tgts)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    again = ev.eval_chunk(preds, tgts)
    arrays = state.to_dataset()
    for key, da in arrays.items():
      if da.device.type != DEVICE:
        raise AssertionError(f'families {name}: {key} on {da.device}')
      if not torch.equal(da.data, again.to_dataset()[key].data):
        raise AssertionError(f'families {name}: {key} differs between two '
                             'evaluations of one chunk')
    values = state.metric_values(metrics)
    if any(da.device.type != DEVICE for da in values.values()):
      raise AssertionError(f'families {name}: values not on {DEVICE}')
    ref = bench_families.family_reference(name, preds, tgts, weights)
    checked = bench_families.check_family_values(
        name, values, ref, weights, rtol=FAMILY_F64_RTOL,
        sigmas=FAMILY_SIGMAS, rank_sum_tol=RANK_SUM_TOL)
    for metric, (err, note) in checked.items():
      measure = ('max(|value|, 1)' if metric in bench_families.RELATIVE_FLOOR
                 else '|value|')
      log(f'families {metric}: {note}, max rel err vs float64 {err:.3g} '
          f'(tol {FAMILY_F64_RTOL}, relative to {measure}) ok')
    rel = {metric: err for metric, (err, _) in checked.items()}
    pair = ev.prepare_pair(preds, tgts)
    steps = time_cuda({
        'eval_accum': lambda: ev.eval_accum(pair, AggregationState.zero()),
    }, rounds=12)
    fed = time_cuda({'eval_chunk': lambda: ev.eval_chunk(preds, tgts)},
                    rounds=3)
    med, q1, q3, count = steps['eval_accum']
    busy, longest = device_time(
        lambda: ev.eval_accum(pair, AggregationState.zero()))
    busy_note = 'device time not measured' if busy is None else (
        f'card busy {busy:.4f} ms of a step ({busy / med:.1%} of the '
        'median), longest kernels ' + ', '.join(
            f'{k[:60]} {ms:.3f} ms' for k, ms in longest))
    # The operands' cache key: the coords the binnings read enter it by
    # content, hashed once per coord object (cold), then found (warm).
    stat = pair[0][bench_families.VARIABLE]
    aggregation._CONTENT_FINGERPRINTS.clear()
    t0 = time.perf_counter()
    aggregator.layout_key(stat)
    key_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(100):
      aggregator.layout_key(stat)
    key_warm = (time.perf_counter() - t0) / 100
    n_stats = sum(len(v) for v in state.sum_weights.values())
    log(f'families {name}: {n_stats} statistic arrays, inputs made in '
        f'{made:.2f} s; '
        f'eval_accum (chunk on the card) median {med:.4f} ms, IQR '
        f'[{q1:.4f}, {q3:.4f}] ms over {count} runs; {busy_note}; '
        f'eval_chunk (host chunk '
        f'in) median {fed["eval_chunk"][0]:.4f} ms over '
        f'{fed["eval_chunk"][3]} runs, first call {first * 1e3:.1f} ms; '
        f'peak device memory {peak / 2**30:.3f} GiB; layout key (host) '
        f'{key_cold * 1e6:.0f} us cold, {key_warm * 1e6:.0f} us warm, reading '
        f'{sorted({c for b in aggregator.bin_by for c in b.host_coords})}; '
        f'two evaluations equal '
        f'by torch.equal; grid {tuple(grid)}, float32; card {card}')
    report[name] = {'eval_accum_ms': med, 'eval_accum_iqr_ms': [q1, q3],
                    'device_busy_ms': busy,
                    'eval_chunk_ms': fed['eval_chunk'][0],
                    'first_eval_chunk_ms': first * 1e3,
                    'peak_gib': peak / 2**30,
                    'layout_key_us': [key_cold * 1e6, key_warm * 1e6],
                    'max_rel_err': rel}
    del ev, pair, stat, preds, tgts, state, again, values, ref
    torch.cuda.empty_cache()
  if any(cp.LAUNCHES.values()):
    raise AssertionError('the metric families have no kernel of their own, '
                         f'yet launches were counted: {cp.LAUNCHES}')
  return report


# -- Phase 12, the station path --------------------------------------------------

# METAR stations scored against a 0.25-degree forecast, as
# tools/sparse_scale_demo.py shapes them: 6,000 stations with seeded
# positions and elevations, hourly reports of which about 97% arrive, about
# 1% are filed twice and 2% of each variable's values carry a bad QC flag;
# report times jitter within 15 minutes of the hour. The forecast: one init
# per chunk, 41 leads (0-240 h every 6 h), 2m temperature and 10 m wind
# speed on 721 x 1440. Cut: 8 inits (00 and 12 UTC from 2020-01-01), not a
# month's 62.
STATIONS = 6000
STATION_INITS = 8
STATION_LEADS = 41
STATION_VARIABLES = ('2m_temperature', '10m_wind_speed')
STATION_NETWORKS = 3
STATION_PAD = 1024
STATION_TOLERANCE = np.timedelta64(30, 'm')
# Values against the float64 reference, relative to max(|value|, 1) (the
# bias sits near 0); the stored statistics' sums against the state's,
# relative to the sum of the terms' magnitudes.
STATION_F64_RTOL = 1e-5
STATION_STORE_RTOL = 1e-6
# The ensemble sub-case: 50 members of 2m temperature x 4 leads, one chunk.
STATION_ENSEMBLE_LEADS = 4
STATION_GRID = (721, 1440)


def station_table(seed: int) -> dict:
  """The stations and their reports (numpy, host): per report its time,
  station and one value per variable, NaN where its QC flag is bad."""
  rng = np.random.default_rng([seed, 12000])
  lat = rng.uniform(-65, 75, STATIONS)
  lon = rng.uniform(0, 360, STATIONS)
  elevation = np.abs(rng.normal(200, 350, STATIONS))
  names = np.array([f'S{i:05d}' for i in range(STATIONS)])
  start = np.datetime64('2020-01-01T00', 'ns')
  hours = (STATION_INITS - 1) * 12 + (STATION_LEADS - 1) * 6 + 1
  present = rng.random((hours, STATIONS)) < 0.97
  hour, station = np.nonzero(present)
  dup = rng.random(hour.size) < 0.01
  hour = np.concatenate([hour, hour[dup]])
  station = np.concatenate([station, station[dup]])
  n = hour.size
  jitter = rng.integers(-15, 15, n) * np.timedelta64(1, 'm')
  values = {
      '2m_temperature': (288 - 0.0065 * elevation[station]
                         - 25 * np.cos(np.deg2rad(lat[station]))
                         + 3 * rng.standard_normal(n)),
      '10m_wind_speed': np.abs(5 + 2 * rng.standard_normal(n))}
  for name in STATION_VARIABLES:
    values[name][rng.random(n) < 0.02] = np.nan  # bad QC flag
  return {'lat': lat, 'lon': lon, 'elevation': elevation, 'names': names,
          'time': start + hour * np.timedelta64(1, 'h') + jitter,
          'hour': hour, 'station': station, 'values': values}


def station_loader(table: dict, leads, variables=STATION_VARIABLES):
  """An in-memory station loader: for each (init, lead) point, each
  station's report closest to the valid time within the tolerance (the
  first filed on ties), its QC-flagged values NaN, on a fixed ``index`` of
  every station (NaN where none reported); then the NaN mask and the
  padding of ``index`` to a multiple of STATION_PAD."""
  from weatherbenchx_tpu_torch.darray import Coord, DimArray
  from weatherbenchx_tpu_torch.data import base as data_base
  order = np.argsort(table['time'], kind='stable')
  times = table['time'][order]
  coords = {'latitude': Coord(('index',), table['lat']),
            'longitude': Coord(('index',), table['lon']),
            'elevation': Coord(('index',), table['elevation']),
            'stationName': Coord(('index',), table['names'])}

  class StationReports(data_base.DataLoader):

    def _load_chunk_from_source(self, init_times, lead_times=None):
      valid = (init_times[:, None].astype('datetime64[ns]')
               + lead_times[None, :].astype('timedelta64[ns]'))
      out = {v: np.full(valid.shape + (STATIONS,), np.nan, np.float32)
             for v in variables}
      for i, j in np.ndindex(valid.shape):
        lo, hi = np.searchsorted(times, [valid[i, j] - STATION_TOLERANCE,
                                         valid[i, j] + STATION_TOLERANCE])
        rows = np.sort(order[lo:hi])  # in filing order
        gap = np.abs(table['time'][rows] - valid[i, j])
        ranked = rows[np.argsort(gap, kind='stable')]
        _, first = np.unique(table['station'][ranked], return_index=True)
        keep = ranked[first]
        for v in variables:
          out[v][i, j, table['station'][keep]] = table['values'][v][keep]
      dims = ('init_time', 'lead_time', 'index')
      return {v: DimArray(out[v], dims, {
          'init_time': init_times, 'lead_time': lead_times,
          'valid_time': Coord(('init_time', 'lead_time'), valid), **coords})
              for v in variables}

  return StationReports(add_nan_mask=True, pad_index_multiple=STATION_PAD)


def station_grid_elevation(seed: int):
  """A seeded grid elevation in metres (float32), latitude ascending."""
  from weatherbenchx_tpu_torch.darray import DimArray
  rng = np.random.default_rng([seed, 12001])
  return DimArray((rng.random(STATION_GRID) * 2000).astype(np.float32),
                  ('latitude', 'longitude'), station_space())


def station_space() -> dict:
  nlat, nlon = STATION_GRID
  return {'latitude': np.linspace(-90, 90, nlat),
          'longitude': np.arange(nlon) * (360 / nlon)}


def station_forecast(seed: int, inits, leads, members=None,
                     variables=STATION_VARIABLES) -> dict:
  """The forecast store (host), generated on the card from the seed."""
  import torch
  from weatherbenchx_tpu_torch.darray import DimArray
  gen = torch.Generator(device=DEVICE)
  gen.manual_seed(seed + 12002)
  lat = torch.linspace(-90, 90, STATION_GRID[0], device=DEVICE)[:, None]
  lead_shape = ((members,) if members else ()) + (len(inits), len(leads))
  out = {}
  for name in variables:
    z = torch.randn(lead_shape + STATION_GRID, generator=gen, device=DEVICE)
    if name == '2m_temperature':
      field = 288 - 25 * torch.cos(torch.deg2rad(lat)) + 3 * z
    else:
      field = (5 + 2 * z).abs()
    dims = ((('number',) if members else ())
            + ('init_time', 'lead_time', 'latitude', 'longitude'))
    coords = {'init_time': inits, 'lead_time': leads, **station_space()}
    if members:
      coords['number'] = np.arange(members)
    out[name] = DimArray(field.cpu().numpy(), dims, coords)
    del z, field
  return out


def station_networks(table: dict) -> dict:
  return {f'network_{k}': table['names'][k::STATION_NETWORKS]
          for k in range(STATION_NETWORKS)}


def bilinear_f64(grid: np.ndarray, lat: np.ndarray, lon: np.ndarray):
  """float64 bilinear gather from (..., *STATION_GRID) at the stations, the
  longitude wrapping; independent of the port's interpolation."""
  nlat, nlon = STATION_GRID
  fi = (lat + 90) / (180 / (nlat - 1))
  i0 = np.clip(np.floor(fi).astype(int), 0, nlat - 2)
  fi = fi - i0
  fj = lon / (360 / nlon)
  j0 = np.floor(fj).astype(int)
  fj = fj - j0
  j0 %= nlon
  j1 = (j0 + 1) % nlon
  g = grid.astype(np.float64)
  return ((1 - fi) * (1 - fj) * g[..., i0, j0] + (1 - fi) * fj * g[..., i0, j1]
          + fi * (1 - fj) * g[..., i0 + 1, j0] + fi * fj * g[..., i0 + 1, j1])


def altitude_adjusted_f64(name: str, values, table: dict, grid_elev):
  """The altitude adjustment in float64 (Ingleby 2014, section 3.3)."""
  dz = table['elevation'] - bilinear_f64(grid_elev, table['lat'],
                                         table['lon'])
  dz = np.where(np.abs(dz) < 1500, dz, 0.0)
  if name == '2m_temperature':
    return values - 0.0065 * dz
  factor = np.where(dz < 100, 1.0, 1 + 0.002 * (dz - 100))
  return values * np.where(dz < 1100, factor, 3.0)


def station_f64_reference(table, forecast, grid_elev, inits, leads) -> dict:
  """RMSE, bias and MAE per (init, lead, network) in float64 from the raw
  report table (no loader): each station's report closest to the valid
  time, QC-flagged values missing."""
  start = np.datetime64('2020-01-01T00', 'ns')
  gap = np.abs(table['time'] - (start + table['hour'] * np.timedelta64(
      1, 'h')))
  networks = station_networks(table)
  member = np.stack([np.isin(table['names'], v) for v in networks.values()])
  out = {}
  # Per (hour, station) the report of least gap, the first filed on ties.
  rows = np.lexsort((np.arange(gap.size), gap, table['station'],
                     table['hour']))
  h, s = table['hour'][rows], table['station'][rows]
  pick = rows[np.r_[True, (h[1:] != h[:-1]) | (s[1:] != s[:-1])]]
  for name in STATION_VARIABLES:
    obs = np.full(((STATION_INITS - 1) * 12 + (STATION_LEADS - 1) * 6 + 1,
                   STATIONS), np.nan)
    obs[table['hour'][pick], table['station'][pick]] = (
        table['values'][name][pick])
    pred = bilinear_f64(forecast[name].values, table['lat'], table['lon'])
    pred = altitude_adjusted_f64(name, pred, table, grid_elev)
    hour = ((inits[:, None] - start) / np.timedelta64(1, 'h')
            + leads[None, :] / np.timedelta64(1, 'h')).astype(int)
    err = pred - obs[hour]  # (init, lead, station)
    ok = ~np.isnan(err)
    e = np.where(ok, err, 0.0)
    count = np.einsum('ils,ns->iln', ok.astype(float), member)
    out[f'rmse.{name}'] = np.sqrt(np.einsum('ils,ns->iln', e ** 2, member)
                                  / count)
    out[f'bias.{name}'] = np.einsum('ils,ns->iln', e, member) / count
    out[f'mae.{name}'] = np.einsum('ils,ns->iln', np.abs(e), member) / count
  return out


def masked_to_nan(flat: dict) -> dict:
  """A sink's statistics with their mask applied (NaN where it is False)
  and dropped: a store keeps no mask (ZarrStatsStore refuses one, as the
  JAX package's does), so the NaN carries it."""
  from weatherbenchx_tpu_torch.darray import DimArray
  out = {}
  for key, da in flat.items():
    if da.has_coord('mask'):
      c = da.coords['mask']
      da = da.where(DimArray(np.asarray(c.values), c.dims)).drop_coords(
          'mask')
    out[key] = da
  return out


class Timed:
  """Wraps an interpolation's ``interpolate`` to add up its seconds."""

  def __init__(self, inner):
    self.inner, self.seconds, self.calls = inner, 0.0, 0

  def interpolate(self, ds, reference=None):
    t0 = time.perf_counter()
    out = self.inner.interpolate(ds, reference)
    self.seconds += time.perf_counter() - t0
    self.calls += 1
    return out


def station_path(seed: int, card: str) -> dict:
  """Phase 12: the station path on the card, against float64; the sink's
  zarr store read back against the state; the ensemble sub-case's fused
  launches."""
  import shutil
  import torch
  from weatherbenchx_tpu_torch import aggregation, binning, interpolations
  from weatherbenchx_tpu_torch import time_chunks
  from weatherbenchx_tpu_torch.data import loaders
  from weatherbenchx_tpu_torch.metrics import deterministic, probabilistic
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  from weatherbenchx_tpu_torch.parallel import pipeline, unaggregated
  t0 = time.perf_counter()
  table = station_table(seed)
  inits = (np.datetime64('2020-01-01T00', 'ns')
           + np.arange(STATION_INITS) * np.timedelta64(12, 'h'))
  leads = (np.arange(STATION_LEADS) * np.timedelta64(6, 'h')).astype(
      'timedelta64[ns]')
  forecast = station_forecast(seed, inits, leads)
  grid_elev = station_grid_elevation(seed)
  log(f'station path: {STATIONS} stations, {table["time"].size} reports, '
      f'forecast {len(inits)} x {len(leads)} x {STATION_GRID} x '
      f'{len(STATION_VARIABLES)} float32 made in '
      f'{time.perf_counter() - t0:.1f} s')
  interp = Timed(interpolations.GridToSparseWithAltitudeAdjustment(
      'linear', grid_elevation=grid_elev, dims=['latitude', 'longitude'],
      wrap_longitude=True))
  predictions = loaders.PredictionsFromDataset(
      ds=forecast, rename_dimensions=None, interpolation=interp)
  networks = station_networks(table)
  aggregator = aggregation.Aggregator(
      reduce_dims=['index'], masked=True,
      bin_by=[binning.BySets(networks, 'stationName', bin_dim_name='network')])
  metrics = {'rmse': deterministic.RMSE(), 'bias': deterministic.Bias(),
             'mae': deterministic.MAE()}
  times = time_chunks.TimeChunks(inits, leads, init_time_chunk_size=1)
  store_path = os.path.join(DISK_STORE_DIR, 'station_stats.zarr')
  shutil.rmtree(DISK_STORE_DIR, ignore_errors=True)
  os.makedirs(DISK_STORE_DIR)
  try:
    store = unaggregated.ZarrStatsStore(times, store_path)
    pipe = pipeline.EvaluationPipeline(
        metrics=metrics, aggregator=aggregator,
        predictions_loader=predictions, targets_loader=station_loader(
            table, leads), times=times, device=DEVICE,
        chunk_stats_sink=lambda i, o, flat: store.write_chunk(
            i, o, masked_to_nan(flat)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = pipe.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    store.finalize()
    stored = unaggregated.load_unaggregated(store_path)
    values = state.metric_values(metrics)
    ref = station_f64_reference(table, forecast, grid_elev.values, inits,
                                leads)
    worst = 0.0
    for key, want in ref.items():
      da = values[key].transpose('init_time', 'lead_time', 'network')
      got = da.values.astype(np.float64)
      if da.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f'station path {key}: shape {da.shape}, '
                             'or non-finite values')
      rel = float((np.abs(got - want) / np.maximum(np.abs(want), 1)).max())
      if rel > STATION_F64_RTOL:
        raise AssertionError(f'station path {key}: rel err vs float64 '
                             f'{rel:.3g} > {STATION_F64_RTOL}')
      worst = max(worst, rel)
    # The store, read back: its masked statistics summed per network, one
    # chunk at a time by the aggregation's own contraction (float32 on the
    # card), against the state's weighted sums; the difference relative to
    # the sum of the terms' magnitudes (the bias's terms cancel).
    sums_equal, store_rel = True, 0.0
    names = np.append(table['names'], [''] * (
        stored['SquaredError.2m_temperature'].sizes['index'] - STATIONS))
    member = torch.from_numpy(np.stack(
        [np.isin(names, v) for v in networks.values()])).float().to(DEVICE)
    for key, da in stored.items():
      stat, var = key.split('.', 1)
      x = torch.nan_to_num(da.transpose('init_time', 'lead_time', 'index')
                           .data.to(DEVICE))
      got = torch.cat([torch.einsum('ils,ns->iln', x[i:i + 1], member)
                       for i in range(x.shape[0])])
      scale = torch.einsum('ils,ns->iln', x.double().abs(), member.double())
      ws = state.sum_weighted_statistics[stat][var].transpose(
          'init_time', 'lead_time', 'network').data.float().to(DEVICE)
      store_rel = max(store_rel, float(
          ((got.double() - ws.double()).abs() / scale.clamp(min=1e-30)
           ).max()))
      sums_equal &= bool(torch.equal(got, ws))
    if store_rel > STATION_STORE_RTOL:
      raise AssertionError(f'station path: the stored statistics sum to '
                           f'{store_rel:.3g} from the state')
    on_disk = tree_bytes(store_path)
  finally:
    shutil.rmtree(DISK_STORE_DIR, ignore_errors=True)
  per_chunk = seconds / STATION_INITS
  interp_s = interp.seconds / max(interp.calls, 1)
  timers = {k: round(d.mean, 4) for k, d in pipe._obs.timings.items()
            if k in ('load_targets_seconds', 'load_predictions_seconds',
                     'eval_chunk_seconds', 'chunk_stats_sink_seconds')}
  # The trap of a flat report layout: a chunk whose station set changes
  # rebuilds its weights and bin masks. One such build, cold, on the card.
  flat = station_loader(table, leads).load_chunk(inits[:1], leads)
  stat = flat['2m_temperature'].isel(index=np.random.default_rng(
      seed).permutation(STATIONS))
  t1 = time.perf_counter()
  aggregator.prepare_operands({'s': {'v': stat}}, {}, DEVICE)
  torch.cuda.synchronize()
  rebuild = time.perf_counter() - t1
  log(f'station path: {len(ref)} metric arrays within {worst:.3g} of '
      f'float64 (tol {STATION_F64_RTOL}, relative to max(|value|, 1)); the '
      f'zarr v2 store read back ({len(stored)} arrays, {on_disk} bytes): '
      f'its masked sums within {store_rel:.3g} of the state (tol '
      f'{STATION_STORE_RTOL}), equal by torch.equal: {sums_equal}')
  log(f'station path: {per_chunk:.3f} s per chunk ({STATION_INITS} chunks of '
      f'{STATION_LEADS} leads x {STATIONS} stations padded to a multiple of '
      f'{STATION_PAD}), interpolation {interp_s:.3f} s per chunk '
      f'({interp_s / per_chunk:.1%} of a chunk); per-chunk means (s) '
      f'{json.dumps(timers)}; operand layouts built '
      f'{pipe._evaluator.operand_builds} (a changed station set rebuilds: '
      f'{rebuild * 1e3:.1f} ms cold); peak device memory '
      f'{peak / 2**30:.3f} GiB; card {card}')
  builds = pipe._evaluator.operand_builds
  del forecast, predictions, pipe, state, flat, stat
  ens = station_ensemble(seed, table, grid_elev, card)
  return {'s_per_chunk': per_chunk, 'interp_s_per_chunk': interp_s,
          'interp_share': interp_s / per_chunk, 'timers': timers,
          'operand_builds': builds, 'rebuild_ms': rebuild * 1e3,
          'peak_gib': peak / 2**30, 'max_rel_err': worst,
          'store_rel': store_rel, 'store_sums_equal': sums_equal,
          'store_bytes': on_disk, 'ensemble': ens}


def station_ensemble(seed: int, table: dict, grid_elev, card: str) -> dict:
  """Phase 12's sub-case: one chunk of a 50-member 2m temperature ensemble
  x 4 leads at the stations, fair CRPS, spread/skill and ensemble-mean RMSE
  through the pipeline with a sink on: one fused launch for the chunk; and
  the kernel against its plain version on that chunk's NaN-padded station
  layout."""
  import torch
  from weatherbenchx_tpu_torch import aggregation, binning, interpolations
  from weatherbenchx_tpu_torch import time_chunks
  from weatherbenchx_tpu_torch.data import loaders
  from weatherbenchx_tpu_torch.metrics import probabilistic
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  from weatherbenchx_tpu_torch.parallel import pipeline
  inits = np.array(['2020-01-01T00'], 'datetime64[ns]')
  leads = (np.arange(STATION_ENSEMBLE_LEADS) * np.timedelta64(6, 'h')).astype(
      'timedelta64[ns]')
  variables = ('2m_temperature',)
  forecast = station_forecast(seed + 1, inits, leads, members=M,
                              variables=variables)
  predictions = loaders.PredictionsFromDataset(
      ds=forecast, rename_dimensions=None,
      interpolation=interpolations.GridToSparseWithAltitudeAdjustment(
          'linear', grid_elevation=grid_elev,
          dims=['latitude', 'longitude'], wrap_longitude=True))
  targets = station_loader(table, leads, variables)
  metrics = {'crps': probabilistic.CRPSEnsemble(use_sort=True),
             'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
             'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE()}
  emitted = []
  pipe = pipeline.EvaluationPipeline(
      metrics=metrics, aggregator=aggregation.Aggregator(
          reduce_dims=['index'], masked=True,
          bin_by=[binning.BySets(station_networks(table), 'stationName',
                                 bin_dim_name='network')]),
      predictions_loader=predictions, targets_loader=targets,
      times=time_chunks.TimeChunks(inits, leads, init_time_chunk_size=1),
      device=DEVICE,
      chunk_stats_sink=lambda i, o, flat: emitted.append(sorted(flat)))
  cp.reset_launch_counts()
  t0 = time.perf_counter()
  state = pipe.run()
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = dict(cp.LAUNCHES)
  if launches != {'fused_ensemble_stats': 1, 'pairwise_spread_sum': 0,
                  'pairwise_cross_sum': 0} or len(emitted) != 1:
    raise AssertionError(f'station ensemble: expected one fused launch for '
                         f'its one chunk with the sink on, got {launches} '
                         f'and {len(emitted)} sink calls')
  values = state.metric_values(metrics)
  for key, da in values.items():
    if not np.isfinite(da.values).all():
      raise AssertionError(f'station ensemble {key}: non-finite values')
  # The kernel at the path's shape: members x init x lead x the padded
  # station index, its padded rows NaN.
  tgt = targets.load_chunk(inits, leads)
  pred = predictions.load_chunk(inits, leads, reference=tgt)
  x = pred['2m_temperature'].transpose(
      'number', 'init_time', 'lead_time', 'index').data.to(DEVICE)
  y = tgt['2m_temperature'].data.to(DEVICE)
  got = cp.fused_ensemble_stats(x, y)
  want = cp.fused_ensemble_stats_plain(x, y)
  errs = [rel_err(g, w) for g, w in zip(got, want)]
  if not all(same for same, _, _ in errs) or max(
      r for _, r, _ in errs) > KERNEL_RTOL['float32']:
    raise AssertionError(f'station ensemble: fused kernel against its plain '
                         f'version on {tuple(x.shape)}: {errs}')
  summary = {k: float(np.nanmean(da.values)) for k, da in values.items()}
  log(f'station ensemble: {M} members x {STATION_ENSEMBLE_LEADS} leads at '
      f'{STATIONS} stations, one chunk in {seconds:.3f} s; fused launches '
      f'{launches["fused_ensemble_stats"]} with the sink on (statistics '
      f'{emitted[0]}); network means {json.dumps(summary)}; fused kernel on '
      f'{tuple(x.shape)} (padded rows NaN) against its plain version: max '
      f'rel err {max(r for _, r, _ in errs):.3g}, max abs err '
      f'{max(a for _, _, a in errs):.3g}; card {card}')
  return {'seconds': seconds, 'launches': launches,
          'max_abs_err': max(a for _, _, a in errs), 'shape': list(x.shape)}


# -- Phase 13, unaggregated statistics at full width ------------------------------

# One chunk of phase 6's configuration (25 field-levels x 12 leads x 721 x
# 1440, 34 bins) with the pipeline's chunk_stats_sink streaming every
# statistic into a zarr v2 blosc store under DISK_STORE_DIR: about 8
# statistics x 25 field-levels of 12 x 721 x 1440 float32, ~10 GB at most.
UNAGG_STORE_NEEDS_BYTES = 12 * 2**30


def unaggregated_path(stores, card: str) -> dict:
  """Phase 13: one chunk of phase 6's configuration with a chunk_stats_sink
  into a zarr v2 blosc store; the state equal by torch.equal to the same
  chunk's without the sink; the sink's rate and the bytes on disk."""
  import shutil
  import torch
  from weatherbenchx_tpu_torch import observability, time_chunks, zarr_io
  from weatherbenchx_tpu_torch.parallel import unaggregated
  shutil.rmtree(DISK_STORE_DIR, ignore_errors=True)
  os.makedirs(DISK_STORE_DIR)
  variables = bench_variables()
  free = shutil.disk_usage(DISK_STORE_DIR).free
  cut = ''
  if free < UNAGG_STORE_NEEDS_BYTES:
    keep = max(1, int(len(variables) * free / UNAGG_STORE_NEEDS_BYTES))
    variables = variables[:keep]
    cut = (f'; CUT to {keep} of the {len(bench_variables())} variables: '
           f'{free} bytes free, the store needs up to '
           f'{UNAGG_STORE_NEEDS_BYTES}')
  one = dict(stores, inits=stores['inits'][:1])
  times = time_chunks.TimeChunks(one['inits'], one['leads'],
                                 init_time_chunk_size=1,
                                 lead_time_chunk_size=BENCH_LEADS)
  path = os.path.join(DISK_STORE_DIR, 'bench_stats.zarr')
  written = {'bytes': 0, 'arrays': 0}
  try:
    store = unaggregated.ZarrStatsStore(times, path, compressor='blosc')

    def sink(i, offsets, flat):
      flat = masked_to_nan(flat)
      written['bytes'] += sum(da.data.numel() * da.data.element_size()
                              for da in flat.values())
      written['arrays'] += len(flat)
      store.write_chunk(i, offsets, flat)

    states, timers = {}, {}
    for label, with_sink in (('sink', True), ('plain', False)):
      registry = observability.Metrics()
      pipe = bench_pipeline(one, registry, bench_sources(one), variables)
      pipe.chunk_stats_sink = sink if with_sink else None
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      t0 = time.perf_counter()
      states[label] = pipe.run()
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
      timers[label] = {'seconds': seconds,
                       'peak_gib': torch.cuda.max_memory_allocated() / 2**30,
                       **{k: d.mean for k, d in registry.timings.items()}}
      del pipe
    t0 = time.perf_counter()
    store.finalize()
    finalize_s = time.perf_counter() - t0
    on_disk = tree_bytes(path)
    got, want = states['sink'].to_dataset(), states['plain'].to_dataset()
    if sorted(got) != sorted(want) or not all(
        torch.equal(got[k].data, want[k].data) for k in want):
      raise AssertionError('unaggregated path: the state with the sink '
                           'differs from the state without it')
    opened = zarr_io.open_dataset_zarr(path)  # lazy: metadata and coords
    if len(opened) != written['arrays'] or any(
        da.sizes['init_time'] != 1 or da.sizes['lead_time'] != BENCH_LEADS
        for da in opened.values()):
      raise AssertionError('unaggregated path: the store does not hold the '
                           'chunk\'s statistics')
  finally:
    shutil.rmtree(DISK_STORE_DIR, ignore_errors=True)
  sink_s = timers['sink']['chunk_stats_sink_seconds']
  copy_s = (timers['sink']['eval_chunk_seconds']
            - timers['plain']['eval_chunk_seconds'])
  log(f'unaggregated path: one chunk of phase 6\'s configuration '
      f'({len(variables)} variables{cut}) streamed {written["arrays"]} '
      f'statistic arrays, {written["bytes"]} bytes, into a zarr v2 blosc '
      f'store: the sink {sink_s:.3f} s ({written["bytes"] / sink_s / 1e9:.3f} '
      f'GB/s), finalize {finalize_s:.3f} s, {on_disk} bytes on disk; the '
      f'host copies add {copy_s:.3f} s to eval_chunk '
      f'({timers["sink"]["eval_chunk_seconds"]:.3f} against '
      f'{timers["plain"]["eval_chunk_seconds"]:.3f} s); the chunk '
      f'{timers["sink"]["seconds"]:.3f} s with the sink, '
      f'{timers["plain"]["seconds"]:.3f} without; peak device memory '
      f'{timers["sink"]["peak_gib"]:.2f} / {timers["plain"]["peak_gib"]:.2f} '
      f'GiB; states equal by torch.equal ({len(want)} arrays); card {card}')
  return {'variables': len(variables), 'bytes': written['bytes'],
          'arrays': written['arrays'], 'sink_s': sink_s,
          'GB_per_s': written['bytes'] / sink_s / 1e9,
          'bytes_on_disk': on_disk, 'finalize_s': finalize_s,
          'host_copy_s': copy_s, 'timers': timers}


# -- Phase 14, significance at scorecard size -------------------------------------

# Half a year of inits (2020, 00 and 12 UTC: 366) x 41 leads (0-240 h every
# 6 h) x 34 bins x phase 6's 25 field-levels at 1.5 degrees (121 x 240):
# RMSE and bias of a main and a baseline forecast against the same target,
# their errors N(0, 1) per gridpoint, AR(1) in init time with phi = 0.6,
# the main forecast offset by SIG_OFFSET. Each init is one chunk generated
# on the card and evaluated by ChunkEvaluator.eval_accum; the per-init
# states are concatenated on the card along init_time. (Not batched: the
# IID check below needs each init's weights bit for bit equal, which a
# stacked contraction does not give.)
SIG_INITS = 366
SIG_LEADS = 41
SIG_GRID = (121, 240)
SIG_PHI = 0.6
# Large enough that the paired test finds it in the smallest bin: with the
# AR(1) inflation sqrt((1 + phi) / (1 - phi)) = 2, one gridpoint's paired
# standard error over 366 inits is 2 sqrt(2 / 366) = 0.148, so 3.4 of them
# at one gridpoint, and many more over a bin's gridpoints.
SIG_OFFSET = 0.5
SIG_REPLICATES = 1000
SIG_RTOL = 1e-9  # card against CPU, and the IID closed form
SIG_P_MAX = 0.01
SIG_CPU_VARIABLE = 'geopotential'  # three field-levels (500, 700, 850)
SIG_STATIONARY = ('2m_temperature', 'global')  # one field-level, one region


def concat_states(states, dim: str):
  """Per-chunk states joined along ``dim`` on their device."""
  from weatherbenchx_tpu_torch import darray, tree
  from weatherbenchx_tpu_torch.aggregation import AggregationState
  def join(*parts):
    return darray.concat(list(parts), dim)
  return AggregationState(
      tree.map_structure(join, *[s.sum_weighted_statistics for s in states]),
      tree.map_structure(join, *[s.sum_weights for s in states]))


def significance_states(seed: int, card: str) -> tuple:
  """(main state, baseline state, seconds) with init_time kept, on the
  card, from SIG_INITS chunks made on the card."""
  import torch
  from weatherbenchx_tpu_torch import aggregation, binning, weighting
  from weatherbenchx_tpu_torch.aggregation import AggregationState
  from weatherbenchx_tpu_torch.apps import configs
  from weatherbenchx_tpu_torch.darray import Coord, DimArray
  from weatherbenchx_tpu_torch.metrics import deterministic
  from weatherbenchx_tpu_torch.parallel import evaluator
  nlat, nlon = SIG_GRID
  lat = np.linspace(-90, 90, nlat)
  lon = np.arange(nlon) * (360 / nlon)
  land = ((np.floor(lat / 5)[:, None] + np.floor(lon / 5)[None, :]) % 2) == 0
  aggregator = aggregation.Aggregator(
      reduce_dims=['latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions(configs.REGIONS, land_sea_mask=DimArray(
          land.astype(np.float32), ('latitude', 'longitude'),
          {'latitude': lat, 'longitude': lon}))],
      masked=True)
  metrics = {'rmse': deterministic.RMSE(), 'bias': deterministic.Bias()}
  ev = evaluator.ChunkEvaluator(metrics, aggregator, device=DEVICE)
  inits = (np.datetime64('2020-01-01T00', 'ns')
           + np.arange(SIG_INITS) * np.timedelta64(12, 'h'))
  leads = (np.arange(SIG_LEADS) * np.timedelta64(6, 'h')).astype(
      'timedelta64[ns]')
  gen = torch.Generator(device=DEVICE)
  gen.manual_seed(seed + 14000)
  shapes = {}
  for name in bench_variables():
    lev = name in configs.UPPER_LEVEL_VARIABLES
    shapes[name] = ((SIG_LEADS,) + ((len(BENCH_LEVELS),) if lev else ())
                    + SIG_GRID, ('lead_time',) + (('level',) if lev else ())
                    + ('latitude', 'longitude'),
                    {'level': np.array(BENCH_LEVELS)} if lev else {})
  err = {side: {name: torch.randn(shape, generator=gen, device=DEVICE)
                for name, (shape, _, _) in shapes.items()}
         for side in ('main', 'baseline')}
  innovation = math.sqrt(1 - SIG_PHI ** 2)
  states = {'main': [], 'baseline': []}
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for k in range(SIG_INITS):
    coords = {'init_time': inits[k:k + 1], 'lead_time': leads,
              'latitude': lat, 'longitude': lon}
    targets, preds = {}, {'main': {}, 'baseline': {}}
    for name, (shape, dims, lcoords) in shapes.items():
      t = torch.randn(shape, generator=gen, device=DEVICE)
      targets[name] = DimArray(t[None], ('init_time',) + dims,
                               {**coords, **lcoords})
      for side, offset in (('main', SIG_OFFSET), ('baseline', 0.0)):
        if k:
          e = err[side][name]
          e.mul_(SIG_PHI).add_(torch.randn(shape, generator=gen,
                                           device=DEVICE), alpha=innovation)
        preds[side][name] = DimArray((t + offset + err[side][name])[None],
                                     ('init_time',) + dims,
                                     {**coords, **lcoords})
    for side in states:
      states[side].append(ev.eval_accum((preds[side], targets),
                                        AggregationState.zero()))
  day = Coord(('init_time',), inits.astype('datetime64[D]'))
  out = [concat_states(states[side], 'init_time').map(
      lambda x: x.assign_coords(day=day)) for side in ('main', 'baseline')]
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  return metrics, out[0], out[1], seconds


def subset_state(state, variable: str, region=None, device=None):
  """The state's arrays of one variable (and one region), on ``device``."""
  from weatherbenchx_tpu_torch.aggregation import AggregationState
  def pick(tree_):
    out = {}
    for stat, per_var in tree_.items():
      da = per_var[variable]
      if region is not None:
        da = da.isel(region=[list(da.coord_values('region')).index(region)])
      if device is not None:
        da = da.copy(data=da.data.to(device))
      out[stat] = {variable: da}
    return out
  return AggregationState(pick(state.sum_weighted_statistics),
                          pick(state.sum_weights))


def inference_outputs(method) -> dict:
  """Every output of an inference method, computed (forces the work)."""
  lo, hi = method.confidence_intervals(0.05)
  return {'point': method.point_estimates(),
          'se': method.standard_error_estimates(), 'lo': lo, 'hi': hi,
          'p': method.p_values(0.0)}


def significance_path(seed: int, card: str) -> dict:
  """Phase 14: t-tests, bootstraps, the paired HAC test and the stationary
  bootstrap on the card state; the IID RMSE standard error against its
  float64 closed form; the card against a CPU copy of three field-levels;
  the paired test's p-values for the offset."""
  import torch
  from weatherbenchx_tpu_torch.inference import bootstrap, t_test
  metrics, main, baseline, build_s = significance_states(seed, card)
  n_leaves = sum(len(v) for v in main.sum_weights.values())
  log(f'significance: {SIG_INITS} inits x {SIG_LEADS} leads x 34 bins x '
      f'{len(bench_variables())} variables ({n_leaves} state arrays per '
      f'side) at {SIG_GRID}, {2 * SIG_INITS} eval_accum steps in '
      f'{build_s:.1f} s ({build_s / (2 * SIG_INITS) * 1e3:.2f} ms each); '
      f'card {card}')
  sv, sr = SIG_STATIONARY
  methods = {
      'iid_t': lambda m, b: t_test.IID(metrics, m, 'init_time'),
      'geer_ar2_t': lambda m, b: t_test.GeerAR2Corrected(
          metrics, m, 'init_time'),
      'lazarus_hac_ewc_t': lambda m, b: t_test.LazarusHACEWC(
          metrics, m, 'init_time'),
      'iid_bootstrap': lambda m, b: bootstrap.IIDBootstrap(
          metrics, m, 'init_time', n_replicates=SIG_REPLICATES, seed=seed),
      'cluster_bootstrap': lambda m, b: bootstrap.ClusterBootstrap(
          metrics, m, 'day', n_replicates=SIG_REPLICATES, seed=seed + 1),
      'paired_hac_ewc': lambda m, b: (
          t_test.LazarusHACEWC.for_baseline_comparison(
              metrics, m, b, experimental_unit_dim='init_time')),
      'stationary_bootstrap': lambda m, b: bootstrap.StationaryBootstrap(
          metrics, subset_state(m, sv, sr), 'init_time',
          n_replicates=SIG_REPLICATES, seed=seed + 2),
  }
  results, report = {}, {}
  for name, make in methods.items():
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results[name] = inference_outputs(make(main, baseline))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    for per_metric in results[name]['se'].values():
      for da in per_metric.values():
        if da.device.type != DEVICE or da.dtype != torch.float64:
          raise AssertionError(f'significance {name}: {da.device} '
                               f'{da.dtype}, not float64 on the card')
    report[name] = {'seconds': seconds, 'peak_gib': peak}
    log(f'significance {name}: {seconds:.3f} s, peak device memory '
        f'{peak:.3f} GiB; card {card}')
  # The IID standard error of RMSE against its float64 closed form.
  iid_rel = 0.0
  for var, se in results['iid_t']['se']['rmse'].items():
    ws = main.sum_weighted_statistics['SquaredError'][var]
    w = main.sum_weights['SquaredError'][var]
    mse = (ws.data.double() / w.data.double()).movedim(
        ws.dims.index('init_time'), -1)
    rmse = mse.mean(-1).sqrt()
    want = mse.std(-1, correction=1) / (2 * rmse * math.sqrt(SIG_INITS))
    got = se.transpose(*[d for d in ws.dims if d != 'init_time']).data
    iid_rel = max(iid_rel, float(((got - want).abs() / want.abs()).max()))
  if iid_rel > SIG_RTOL:
    raise AssertionError(f'significance: IID RMSE standard error '
                         f'{iid_rel:.3g} from its closed form')
  # The card against the same calls on a CPU copy of three field-levels.
  cpu_rel = 0.0
  for name, make in methods.items():
    if name == 'stationary_bootstrap':
      cpu = inference_outputs(make(subset_state(main, sv, sr, 'cpu'), None))
      var = sv
    else:
      cpu = inference_outputs(make(
          subset_state(main, SIG_CPU_VARIABLE, device='cpu'),
          subset_state(baseline, SIG_CPU_VARIABLE, device='cpu')))
      var = SIG_CPU_VARIABLE
    for out, per_metric in cpu.items():
      for metric, per_var in per_metric.items():
        want = per_var[var].data
        got = results[name][out][metric][var].transpose(
            *per_var[var].dims).data.cpu()
        ok = ~torch.isnan(want)
        if not torch.equal(ok, ~torch.isnan(got)):
          raise AssertionError(f'significance {name} {out}: NaN patterns '
                               'differ between the card and the CPU')
        rel = float(((got[ok] - want[ok]).abs()
                     / want[ok].abs().clamp(min=1.0)).max()) if ok.any(
                     ) else 0.0
        cpu_rel = max(cpu_rel, rel)
  if cpu_rel > SIG_RTOL:
    raise AssertionError(f'significance: the card {cpu_rel:.3g} from the '
                         f'CPU (tol {SIG_RTOL})')
  # The paired test finds the offset.
  p = torch.cat([da.data.flatten() for da in
                 results['paired_hac_ewc']['p']['bias'].values()])
  p_bias = float(p.max()) if bool(torch.isfinite(p).all()) else math.inf
  diff = [da.data for da in
          results['paired_hac_ewc']['point']['bias'].values()]
  if p_bias >= SIG_P_MAX:
    raise AssertionError(f'significance: the paired HAC test missed the '
                         f'offset {SIG_OFFSET}: p up to {p_bias:.3g}')
  mean_diff = float(torch.cat([d.flatten() for d in diff]).mean())
  log(f'significance: IID RMSE standard error within {iid_rel:.3g} of the '
      f'float64 closed form; the card within {cpu_rel:.3g} of a CPU copy '
      f'({SIG_CPU_VARIABLE}, 3 field-levels; {sv} x {sr} for the stationary '
      f'bootstrap; tol {SIG_RTOL}); paired HAC-EWC: bias difference '
      f'{mean_diff:.4f} (offset {SIG_OFFSET}), the largest p {p_bias:.3g} '
      f'(< {SIG_P_MAX}); card {card}')
  return {'build_s': build_s, 'methods': report, 'iid_rel': iid_rel,
          'cpu_rel': cpu_rel, 'paired_p_max': p_bias,
          'paired_bias_diff': mean_diff}


# -- phase 15: batched dispatch -------------------------------------------------

# Phase 15(c): phase 14's configuration through the pipeline, over 32 inits
# of in-memory stores, one init per chunk, at these group sizes. Its two
# states are held to F64_RTOL: a stack of 8 chunks contracts 8 times the
# rows in one GEMM, which sums each row's 29,040 gridpoints in another
# float32 order than a chunk alone (1.06e-6 apart on the H100, at a bias
# sum of zero-mean errors; 1.01e-6 on the CPU, in the sums of weights).
DISPATCH_INITS = 32
DISPATCH_GROUPS = (1, 8)
BATCHED_BENCH_RTOL = 1e-6


def state_rel(got, want) -> tuple:
  """(max over the arrays of max |got - want| / max |want|, the array that
  takes it, all equal by torch.equal) of two AggregationStates, on the
  host in float64."""
  import torch
  got, want = got.to_host().to_dataset(), want.to_host().to_dataset()
  if sorted(got) != sorted(want):
    raise AssertionError(f'state keys differ: {sorted(set(got) ^ set(want))}')
  worst, where, equal = 0.0, None, True
  for k in want:
    g, w = got[k].transpose(*want[k].dims).data, want[k].data
    equal = equal and bool(torch.equal(g, w))
    scale = w.abs().max().item()
    rel = (g.double() - w.double()).abs().max().item() / (scale or 1.0)
    if rel >= worst:
      worst, where = rel, k
  return worst, where, equal


def chunk_loader(chunks, side: int):
  """A DataLoader serving host chunks by their (single) init time."""
  from weatherbenchx_tpu_torch.data import base
  by_init = {c[side]['2m_temperature'].coord_values('init_time')[0]: c[side]
             for c in chunks}

  class ChunkSource(base.DataLoader):
    def _load_chunk_from_source(self, init_times, lead_times=None):
      return by_init[init_times[0]]
  return ChunkSource()


def batched_main_path(chunks, phase4_values, card: str) -> dict:
  """Phase 15(a): phase 4's 3 chunks through EvaluationPipeline at
  chunks_per_dispatch=3: one fused launch for the three, values within
  F64_RTOL of phase 4's per-chunk run and of the float64 recomputation."""
  import torch
  from weatherbenchx_tpu_torch import observability, time_chunks
  from weatherbenchx_tpu_torch.metrics import probabilistic
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  from weatherbenchx_tpu_torch.parallel import pipeline
  metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
  }
  aggregator = region_aggregator()
  inits = np.concatenate([c[0]['2m_temperature'].coord_values('init_time')
                          for c in chunks])
  registry = observability.Metrics()
  pipe = pipeline.EvaluationPipeline(
      metrics=metrics, aggregator=aggregator,
      predictions_loader=chunk_loader(chunks, 0),
      targets_loader=chunk_loader(chunks, 1),
      times=time_chunks.TimeChunks(
          inits, chunks[0][0]['2m_temperature'].coord_values('lead_time'),
          init_time_chunk_size=1),
      device=DEVICE, chunks_per_dispatch=len(chunks),
      metrics_registry=registry)
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  cp.reset_launch_counts()
  t0 = time.perf_counter()
  values = pipe.run().metric_values(metrics)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = dict(cp.LAUNCHES)
  peak = torch.cuda.max_memory_allocated()
  ev = pipe._evaluator
  log(f'phase 15a batched main path: {len(chunks)} chunks of {M} x {GRID} '
      f'in {ev.dispatches} dispatch(es), signature splits '
      f'{ev.signature_splits} + {registry.counters.get("signature_splits", 0)}'
      f', kernel launches {launches}, {seconds:.2f} s to a final '
      f'synchronize, eval_chunk_seconds '
      f'{registry.timings["eval_chunk_seconds"].mean:.3f}; peak device memory '
      f'{peak / 2**30:.2f} GiB; card {card}')
  if launches != {'fused_ensemble_stats': 1, 'pairwise_spread_sum': 0,
                  'pairwise_cross_sum': 0}:
    raise AssertionError(f'expected one fused launch for the {len(chunks)} '
                         f'stacked chunks and no other, got {launches}')
  if ev.dispatches != 1:
    raise AssertionError(f'{ev.dispatches} dispatches, want 1')
  check_values('phase 15a batched main path', values,
               f64_reference(chunks, aggregator), CLOSED_FORMS)
  worst = 0.0
  for name in CLOSED_FORMS:
    key = f'{name}.2m_temperature'
    got = values[key].transpose(*phase4_values[key].dims).data.double()
    want = phase4_values[key].data.double().cpu()
    worst = max(worst, ((got - want).abs() / want.abs()).max().item())
  if worst > F64_RTOL:
    raise AssertionError(f'batched main path {worst:.3g} from phase 4 > '
                         f'{F64_RTOL}')
  log(f'phase 15a batched main path: values {worst:.3g} relative from phase '
      f'4\'s per-chunk run (tol {F64_RTOL}) ok')
  return {'launches': launches, 'dispatches': ev.dispatches,
          'chunks': len(chunks), 'seconds': seconds,
          'peak_gib': peak / 2**30, 'rel_vs_phase4': worst}


def batched_benchmark_path(stores, want_state, budget: int, card: str
                           ) -> dict:
  """Phase 15(b): phase 6's configuration at chunks_per_dispatch=2 (its 2
  chunks in one dispatch) under both of phase 6's resource plans; each
  state within BATCHED_BENCH_RTOL of phase 6's resident state (max |diff|
  over max |value| per array), torch.equal printed."""
  import torch
  out = {}
  for plan, b in (('resident', None), ('host_gather', budget)):
    pipe, state, seconds, _ = run_bench(
        stores, b, card, label=f'phase 15b batched benchmark path ({plan})',
        group=BENCH_INITS)
    ev = pipe._evaluator
    if (plan == 'host_gather') != bool(ev.host_gather_ids):
      raise AssertionError(f'{plan}: {len(ev.host_gather_ids)} demoted')
    if ev.dispatches != 1 or ev.signature_splits:
      raise AssertionError(f'{plan}: {ev.dispatches} dispatches, '
                           f'{ev.signature_splits} signature splits; want 1, 0')
    rel, where, equal = state_rel(state, want_state)
    log(f'phase 15b batched benchmark path ({plan}): {BENCH_INITS} chunks in '
        f'1 dispatch; state {rel:.3g} from phase 6\'s (max |diff| / max '
        f'|value| per array, at {where}; tol {BATCHED_BENCH_RTOL}); '
        f'torch.equal {equal}; card {card}')
    if not rel <= BATCHED_BENCH_RTOL:
      raise AssertionError(f'{plan}: batched state {rel:.3g} from phase 6')
    out[plan] = {'s_per_chunk': seconds / BENCH_INITS, 'rel': rel,
                 'torch_equal': equal}
    del pipe, state
    torch.cuda.empty_cache()
  return out


def dispatch_stores(seed: int) -> dict:
  """Phase 15(c)'s host stores: phase 14's 25 field-levels at 1.5 degrees,
  DISPATCH_INITS inits 12 h apart x SIG_LEADS leads; targets N(0, 1) at
  the valid times, predictions the target plus N(0, 1); made on the card
  from the seed."""
  import torch
  from weatherbenchx_tpu_torch.apps import configs
  from weatherbenchx_tpu_torch.darray import DimArray
  gen = torch.Generator(device=DEVICE)
  gen.manual_seed(seed + 15000)
  nlat, nlon = SIG_GRID
  space = {'latitude': np.linspace(-90, 90, nlat),
           'longitude': np.arange(nlon) * (360 / nlon)}
  inits = (np.datetime64('2020-01-01T00', 'ns')
           + np.arange(DISPATCH_INITS) * np.timedelta64(12, 'h'))
  leads = (np.arange(SIG_LEADS) * np.timedelta64(6, 'h')).astype(
      'timedelta64[ns]')
  n_valid = 2 * (DISPATCH_INITS - 1) + SIG_LEADS
  valid = (np.datetime64('2020-01-01T00', 'ns')
           + np.arange(n_valid) * np.timedelta64(6, 'h'))
  vpos = torch.tensor([2 * k + j for k in range(DISPATCH_INITS)
                       for j in range(SIG_LEADS)], device=DEVICE)
  preds, tgts = {}, {}
  for name in bench_variables():
    lev = name in configs.UPPER_LEVEL_VARIABLES
    fshape = ((len(BENCH_LEVELS),) if lev else ()) + SIG_GRID
    fdims = (('level',) if lev else ()) + ('latitude', 'longitude')
    lcoords = {'level': np.array(BENCH_LEVELS)} if lev else {}
    t = torch.randn((n_valid,) + fshape, generator=gen, device=DEVICE)
    p = t[vpos] + torch.randn((len(vpos),) + fshape, generator=gen,
                              device=DEVICE)
    tgts[name] = DimArray(t.cpu().numpy(), ('valid_time',) + fdims,
                          {'valid_time': valid, **space, **lcoords})
    preds[name] = DimArray(
        p.reshape((DISPATCH_INITS, SIG_LEADS) + fshape).cpu().numpy(),
        ('init_time', 'lead_time') + fdims,
        {'init_time': inits, 'lead_time': leads, **space, **lcoords})
    del t, p
  return {'predictions': preds, 'targets': tgts, 'inits': inits,
          'leads': leads, 'space': space}


def dispatch_run(stores, group: int, profile_dir=None) -> tuple:
  """One EvaluationPipeline run of phase 15(c) at ``group`` chunks per
  dispatch; returns (host state, seconds to a final synchronize,
  registry, evaluator)."""
  import torch
  from weatherbenchx_tpu_torch import aggregation, binning, observability
  from weatherbenchx_tpu_torch import time_chunks, weighting
  from weatherbenchx_tpu_torch.apps import configs
  from weatherbenchx_tpu_torch.darray import DimArray
  from weatherbenchx_tpu_torch.data import loaders
  from weatherbenchx_tpu_torch.metrics import deterministic
  from weatherbenchx_tpu_torch.parallel import pipeline
  lat, lon = stores['space']['latitude'], stores['space']['longitude']
  land = ((np.floor(lat / 5)[:, None] + np.floor(lon / 5)[None, :]) % 2) == 0
  registry = observability.Metrics()
  pipe = pipeline.EvaluationPipeline(
      metrics={'rmse': deterministic.RMSE(), 'bias': deterministic.Bias()},
      aggregator=aggregation.Aggregator(
          reduce_dims=['latitude', 'longitude'],
          weigh_by=[weighting.GridAreaWeighting()],
          bin_by=[binning.Regions(configs.REGIONS, land_sea_mask=DimArray(
              land.astype(np.float32), ('latitude', 'longitude'),
              stores['space']))],
          masked=True),
      predictions_loader=loaders.PredictionsFromDataset(
          ds=stores['predictions'], rename_dimensions=None),
      targets_loader=loaders.TargetsFromDataset(
          ds=stores['targets'], rename_dimensions=None),
      times=time_chunks.TimeChunks(stores['inits'], stores['leads'],
                                   init_time_chunk_size=1),
      device=DEVICE, chunks_per_dispatch=group, metrics_registry=registry,
      profile_dir=profile_dir)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  state = pipe.run()
  torch.cuda.synchronize()
  return state, time.perf_counter() - t0, registry, pipe._evaluator


def dispatch_path(seed: int, card: str) -> dict:
  """Phase 15(c): phase 14's configuration (1.5 degrees, 25 field-levels,
  41 leads, 34 bins, init_time kept, RMSE and bias) through
  EvaluationPipeline over DISPATCH_INITS inits of in-memory stores, at
  each of DISPATCH_GROUPS chunks per dispatch: seconds per chunk and the
  mean eval_chunk_seconds of a plain run, then a profiled run
  (profile_dir): CUDA kernels and eager operator calls per chunk and the
  card's busy share (the union of its kernels' intervals over the run's
  wall time); the states within F64_RTOL of each other."""
  import torch
  from weatherbenchx_tpu_torch import observability
  from weatherbenchx_tpu_torch.metrics import deterministic
  t0 = time.perf_counter()
  stores = dispatch_stores(seed)
  log(f'phase 15c dispatch path: made {DISPATCH_INITS} inits x {SIG_LEADS} '
      f'leads x {len(bench_variables())} variables at {SIG_GRID} in '
      f'{time.perf_counter() - t0:.1f} s')
  out, states = {}, {}
  for group in DISPATCH_GROUPS:
    state, seconds, registry, ev = dispatch_run(stores, group)
    states[group] = state
    eval_s = registry.timings['eval_chunk_seconds']
    with tempfile.TemporaryDirectory() as trace_dir:
      _, traced_s, _, _ = dispatch_run(stores, group, trace_dir)
      summary = observability.trace_summary(trace_dir)
      trace_mb = os.path.getsize(summary['path']) / 2**20
    row = {
        's_per_chunk': seconds / DISPATCH_INITS,
        'dispatches': ev.dispatches,
        'signature_splits': ev.signature_splits
                            + registry.counters.get('signature_splits', 0),
        'eval_chunk_seconds_mean': eval_s.mean,
        'eval_chunk_seconds_per_chunk': eval_s.total / DISPATCH_INITS,
        'profiled_s_per_chunk': traced_s / DISPATCH_INITS,
        'kernels_per_chunk': summary['kernels'] / DISPATCH_INITS,
        'cpu_ops_per_chunk': summary['cpu_ops'] / DISPATCH_INITS,
        'busy_share': summary['busy_seconds'] / traced_s,
        'kernel_ms_per_chunk': 1e3 * summary['kernel_seconds']
                               / DISPATCH_INITS,
        'trace_mib': trace_mb,
    }
    out[group] = row
    log(f'phase 15c dispatch path, {group} chunk(s) per dispatch: '
        f'{row["s_per_chunk"]:.4f} s per chunk ({DISPATCH_INITS} chunks, wall '
        f'clock to a final synchronize, {ev.dispatches} dispatches, '
        f'{row["signature_splits"]} signature splits); eval_chunk_seconds '
        f'mean {eval_s.mean:.4f} s per dispatch, '
        f'{row["eval_chunk_seconds_per_chunk"]:.4f} s per chunk; profiled '
        f'run {row["profiled_s_per_chunk"]:.4f} s per chunk, '
        f'{row["kernels_per_chunk"]:.1f} CUDA kernels and '
        f'{row["cpu_ops_per_chunk"]:.1f} eager operator calls per chunk, '
        f'the card busy {row["busy_share"]:.1%} of the run '
        f'({row["kernel_ms_per_chunk"]:.3f} ms of kernels per chunk; trace '
        f'{trace_mb:.1f} MiB); card {card}')
    torch.cuda.empty_cache()
  rel, where, equal = state_rel(states[DISPATCH_GROUPS[1]],
                                states[DISPATCH_GROUPS[0]])
  if not rel <= F64_RTOL:
    raise AssertionError(f'dispatch path: groups {DISPATCH_GROUPS} differ by '
                         f'{rel:.3g} > {F64_RTOL} at {where}')
  values = states[DISPATCH_GROUPS[1]].metric_values(
      {'rmse': deterministic.RMSE()})
  rmse = values['rmse.2m_temperature']
  glob = rmse.values[..., list(rmse.coord_values('region')).index('global')]
  if rmse.dims != ('init_time', 'lead_time', 'region') or not (
      abs(glob.mean() - 1.0) < 0.01):
    raise AssertionError(f'dispatch path rmse dims {rmse.dims}, global mean '
                         f'{glob.mean()} (want 1)')
  log(f'phase 15c dispatch path: states of groups {DISPATCH_GROUPS} '
      f'{rel:.3g} apart (at {where}; tol {F64_RTOL}), torch.equal {equal}; '
      f'global RMSE of N(0, 1) errors {glob.mean():.5f} (want 1) ok')
  del stores, states
  return {'groups': out, 'rel': rel, 'rel_at': where, 'torch_equal': equal}


def scorecard_phase(outputs: dict) -> dict:
  """Phase 15(d), on the host: phase 8's two benchmark CLI outputs (hres
  and ens, 64 x 32) written into a results directory, combined by
  combine_results with display names, rendered by scorecard_html, and the
  rendered page's own self-test run on its generated logic by jsmini."""
  import re
  from weatherbenchx_tpu_torch import io
  from weatherbenchx_tpu_torch.apps import combine_results, jsmini
  from weatherbenchx_tpu_torch.apps import scorecard_html
  with tempfile.TemporaryDirectory() as tmp:
    for name, ds in outputs.items():
      io.save_dataset(os.path.join(tmp, name), ds)
    out = os.path.join(tmp, 'scorecard', 'scorecard.npz')
    os.makedirs(os.path.dirname(out))
    t0 = time.perf_counter()
    combine_results.main(['--results_dir', tmp, '--output_path', out,
                          '--display_names'])
    combine_s = time.perf_counter() - t0
    sc = io.load_dataset(out)
    t0 = time.perf_counter()
    page = scorecard_html.render_scorecard_html(out)
    render_s = time.perf_counter() - t0
  data = json.loads(re.search(r'const DATA = (\{.*?\});\n', page,
                              re.S).group(1))
  m = re.search(r'const SELFTEST = (\[.*?\]);\n', page, re.S)
  fixtures = json.loads(m.group(1))
  logic_js = page[m.end():page.index('function sl_deepNear')]
  t0 = time.perf_counter()
  failures = jsmini.run_selftests(logic_js, fixtures, data['values'])
  selftest_s = time.perf_counter() - t0
  models = list(sc['Geopotential'].coord_values('model'))
  if failures or models != ['IFS ENS vs ERA5', 'IFS HRES vs ERA5']:
    raise AssertionError(f'scorecard: models {models}, self-test failures '
                         f'{failures}')
  log(f'phase 15d scorecard: {len(sc)} variables x {len(models)} models '
      f'combined in {combine_s:.3f} s, page of {len(page)} characters '
      f'rendered in {render_s:.3f} s, {len(fixtures)} self-test fixtures '
      f'passed through jsmini in {selftest_s:.3f} s ok')
  return {'combine_s': combine_s, 'render_s': render_s,
          'selftest_s': selftest_s, 'fixtures': len(fixtures)}


def latency_phase(seed: int, card: str) -> dict:
  """Phase 15(e): a ConstantLatencyWrapper (6 h) around an in-memory store
  like phase 7's (2m temperature at CLI_GRID, N(0, 1)), through
  EvaluationPipeline on the card at 2 chunks per dispatch: inits 6 h after
  each nominal run score that run 6 h further out, equal by torch.equal to
  a run without the wrapper of the nominal inits at the shifted leads."""
  import torch
  from weatherbenchx_tpu_torch import aggregation, observability
  from weatherbenchx_tpu_torch import time_chunks, weighting
  from weatherbenchx_tpu_torch.darray import DimArray
  from weatherbenchx_tpu_torch.data import latency_wrappers, loaders
  from weatherbenchx_tpu_torch.metrics import deterministic
  from weatherbenchx_tpu_torch.parallel import pipeline
  rng = np.random.default_rng([seed, 15500])
  nominal = np.arange('2020-01-01', '2020-01-05', np.timedelta64(12, 'h'),
                      dtype='datetime64[ns]')
  leads = (np.arange(0, 49, 6) * np.timedelta64(1, 'h')).astype(
      'timedelta64[ns]')
  valid = np.arange('2020-01-01', '2020-01-07', np.timedelta64(6, 'h'),
                    dtype='datetime64[ns]')
  space = {'latitude': np.linspace(-90, 90, CLI_GRID[0]),
           'longitude': np.arange(CLI_GRID[1]) * (360 / CLI_GRID[1])}
  preds = {'2m_temperature': DimArray(
      rng.standard_normal((len(nominal), len(leads)) + CLI_GRID,
                          dtype=np.float32),
      ('init_time', 'lead_time', 'latitude', 'longitude'),
      {'init_time': nominal, 'lead_time': leads, **space})}
  tgts = {'2m_temperature': DimArray(
      rng.standard_normal((len(valid),) + CLI_GRID, dtype=np.float32),
      ('valid_time', 'latitude', 'longitude'), {'valid_time': valid, **space})}
  metrics = {'rmse': deterministic.RMSE(), 'bias': deterministic.Bias()}
  offset = np.timedelta64(6, 'h')
  requested = leads[:-2]  # the adjusted leads stay on the store's grid

  def run(loader, inits, run_leads):
    return pipeline.EvaluationPipeline(
        metrics=metrics,
        aggregator=aggregation.Aggregator(
            reduce_dims=['latitude', 'longitude'],
            weigh_by=[weighting.GridAreaWeighting()]),
        predictions_loader=loader,
        targets_loader=loaders.TargetsFromDataset(ds=tgts,
                                                  rename_dimensions=None),
        times=time_chunks.TimeChunks(inits, run_leads,
                                     init_time_chunk_size=1),
        device=DEVICE, chunks_per_dispatch=2,
        metrics_registry=observability.Metrics()).run()

  t0 = time.perf_counter()
  wrapped = run(latency_wrappers.ConstantLatencyWrapper(
      loaders.PredictionsFromDataset(ds=preds, rename_dimensions=None),
      latency=offset, nominal_init_times=nominal), nominal + offset,
      requested)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  plain = run(loaders.PredictionsFromDataset(ds=preds, rename_dimensions=None),
              nominal, requested + offset)
  got, want = wrapped.to_dataset(), plain.to_dataset()
  if sorted(got) != sorted(want):
    raise AssertionError('latency phase: state keys differ')
  for k in want:
    if not (torch.equal(got[k].data, want[k].data) and np.array_equal(
        got[k].coord_values('init_time'),
        want[k].coord_values('init_time') + offset)):
      raise AssertionError(f'latency phase: {k} differs from the unwrapped '
                           'run of the nominal inits')
  log(f'phase 15e latency wrapper: {len(nominal)} inits 6 h after their '
      f'runs x {len(requested)} leads through the pipeline on the card in '
      f'{seconds:.2f} s, equal by torch.equal to the unwrapped nominal run '
      f'at leads + 6 h ({len(want)} arrays) ok; card {card}')
  return {'seconds': seconds, 'arrays': len(want)}


# -- Phase 16, ranks over torch.distributed -------------------------------------
# The ranks are spawned processes (multichip.run_ranks). NCCL refuses two
# ranks on one GPU, so the ranks that share this card use gloo, and NCCL
# runs at world size 1. Phase 2 built the kernels before any rank starts,
# so no rank runs nvcc.

RANK_TIMEOUT_S = 600.0
MAIN_INIT0 = np.datetime64('2020-01-01T00', 'ns')
# Sub-phase: ([(run name, distributed, (mesh axis, axis size, sharded dim)
# or None)], world size, backend). (b) and (c) share one spawn of
# their 2 gloo ranks: each rank runs the chunk-parallel run, then the two
# meshes.
RANK_RUNS = {
    'a': ([('nccl_world1', True, ('space', 1, 'longitude'))], 1,
          'cpu:gloo,cuda:nccl'),
    'bc': ([('gloo_distributed', True, None),
            ('mesh_space', False, ('space', 2, 'longitude')),
            ('mesh_ensemble', False, ('ensemble', 2, 'number'))], 2, 'gloo'),
}


def main_metrics() -> dict:
  from weatherbenchx_tpu_torch.metrics import probabilistic
  return {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
  }


def phase16_rank(rank: int, world: int, sub: str, seed: int) -> dict:
  """One rank of phase 16's sub-phase ``sub``: phase 4's 3 chunks through
  EvaluationPipeline, as each of the sub-phase's runs configures it. Makes
  only the chunks this rank evaluates, before the timed run."""
  import torch
  import torch.distributed as dist
  from torch.distributed.device_mesh import init_device_mesh
  from weatherbenchx_tpu_torch import observability, time_chunks
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  from weatherbenchx_tpu_torch.parallel import distributed as dist_lib
  from weatherbenchx_tpu_torch.parallel import pipeline
  runs, _, backend = RANK_RUNS[sub]
  torch.cuda.set_device(0)  # the one card, which the ranks share
  inits = MAIN_INIT0 + np.arange(N_CHUNKS) * np.timedelta64(12, 'h')
  leads = (np.arange(GRID[1]) * np.timedelta64(6, 'h')).astype(
      'timedelta64[ns]')
  out = {}
  for name, distributed, mesh_spec in runs:
    mesh = dim_to_axis = None
    if mesh_spec is not None:
      axis, size, dim = mesh_spec
      mesh = init_device_mesh('cuda' if 'nccl' in backend else 'cpu',
                              (size,), mesh_dim_names=(axis,))
      dim_to_axis = {dim: axis}
    mine = [k for k in range(N_CHUNKS)
            if not distributed or k % world == rank]
    chunks = [make_chunk(seed, k) for k in mine]
    registry = observability.Metrics()
    pipe = pipeline.EvaluationPipeline(
        metrics=main_metrics(), aggregator=region_aggregator(),
        predictions_loader=chunk_loader(chunks, 0),
        targets_loader=chunk_loader(chunks, 1),
        times=time_chunks.TimeChunks(inits, leads, init_time_chunk_size=1),
        device=DEVICE, mesh=mesh, dim_to_axis=dim_to_axis,
        distributed=distributed, metrics_registry=registry)
    ev, shapes = pipe._evaluator, []
    place = ev.to_device

    def to_device(p, t, place=place, shapes=shapes):
      placed = place(p, t)
      shapes.append(tuple(placed[0]['2m_temperature'].shape))
      return placed

    ev.to_device = to_device
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist_lib.BYTES_GATHERED.clear()
    cp.reset_launch_counts()
    t0 = time.perf_counter()
    values = pipe.run().metric_values(main_metrics())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out[name] = {
        'launches': dict(cp.LAUNCHES),
        'values': {k: da.values for k, da in values.items()},
        'dims': {k: da.dims for k, da in values.items()},
        'chunks': mine if distributed else list(range(N_CHUNKS)),
        'device_chunk_shape': shapes[0],
        'seconds': seconds, 'seconds_per_chunk': seconds / len(shapes),
        'eval_chunk_seconds': registry.timings['eval_chunk_seconds'].mean,
        'peak_gib': torch.cuda.max_memory_allocated() / 2**30,
        'bytes_gathered': dict(dist_lib.BYTES_GATHERED),
        'backend': str(dist.get_backend()),
    }
    del pipe, chunks
  return out


def rank_path(seed: int, phase4_values: dict, card: str) -> dict:
  """Phase 16: (a) NCCL at world size 1, (b) 2 chunk-parallel gloo ranks,
  (c) 2 gloo ranks as a mesh, each within F64_RTOL of phase 4's values on
  every rank, with their fused launches; (d) the six-phase dryrun on 4
  gloo ranks sharing the card."""
  import torch
  from weatherbenchx_tpu_torch import multichip
  expected_shapes = {
      'nccl_world1': (M,) + GRID,
      'gloo_distributed': (M,) + GRID,
      'mesh_space': (M,) + GRID[:3] + (GRID[3] // 2,),
      'mesh_ensemble': (M,) + GRID,
  }
  report = {}
  for sub, (runs, world, backend) in RANK_RUNS.items():
    t0 = time.perf_counter()
    ranks = multichip.run_ranks(
        f'{os.path.abspath(__file__)}:phase16_rank', world,
        {'sub': sub, 'seed': seed}, backend=backend,
        timeout_s=RANK_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for name, _, _ in runs:
      for rank, r in enumerate(ranks):
        got = r[name]
        want_fused = len(got['chunks'])
        worst, equal = 0.0, True
        for k, want in phase4_values.items():
          g = torch.from_numpy(np.transpose(got['values'][k], [
              got['dims'][k].index(d) for d in want.dims]))
          w = want.data.double().cpu()
          worst = max(worst, ((g - w).abs() / w.abs()).max().item())
          equal = equal and torch.equal(g.float(), want.data.float().cpu())
        log(f'phase 16{sub} {name} rank {rank}/{world} ({got["backend"]}): '
            f'chunks {got["chunks"]}, kernel launches {got["launches"]}, '
            f'device chunk {got["device_chunk_shape"]}, '
            f'{got["seconds_per_chunk"]:.3f} s per chunk '
            f'(eval_chunk_seconds {got["eval_chunk_seconds"]:.3f}), peak '
            f'{got["peak_gib"]:.2f} GiB, bytes gathered '
            f'{got["bytes_gathered"]}; values {worst:.3g} relative from '
            f'phase 4 (tol {F64_RTOL}), torch.equal {equal}; card {card}')
        if got['launches'] != {'fused_ensemble_stats': want_fused,
                               'pairwise_spread_sum': 0,
                               'pairwise_cross_sum': 0}:
          raise AssertionError(f'phase 16{sub} {name} rank {rank}: launches '
                               f'{got["launches"]}, want {want_fused} fused')
        if got['device_chunk_shape'] != expected_shapes[name]:
          raise AssertionError(
              f'phase 16{sub} {name} rank {rank}: the kernel saw '
              f'{got["device_chunk_shape"]}, want {expected_shapes[name]}')
        if worst > F64_RTOL:
          raise AssertionError(f'phase 16{sub} {name} rank {rank}: {worst:.3g}'
                               f' from phase 4 > {F64_RTOL}')
        report[f'{name}_rank{rank}'] = {
            k: got[k] for k in ('chunks', 'launches', 'seconds_per_chunk',
                                'eval_chunk_seconds', 'peak_gib',
                                'bytes_gathered', 'backend')}
        report[f'{name}_rank{rank}'].update(rel_vs_phase4=worst,
                                            torch_equal=equal)
    report[f'{sub}_wall_seconds'] = wall
    log(f'phase 16{sub}: {world} rank(s), {backend}, {wall:.1f} s with the '
        'ranks\' start')
  t0 = time.perf_counter()
  lines = multichip.dryrun_multichip(4, device=DEVICE,
                                     timeout_s=RANK_TIMEOUT_S)
  report['d_wall_seconds'] = time.perf_counter() - t0
  if len(lines) != 6:
    raise AssertionError(f'the dryrun printed {len(lines)} phases, want 6')
  log(f'phase 16d dryrun: six phases on 4 gloo ranks sharing the card in '
      f'{report["d_wall_seconds"]:.1f} s; card {card}')
  return report


# Seeds by family: the four metric families, the five layers' families
# (the binnings, the station path, batched dispatch, inference, the
# ensembles past 64 members) and large_k at 721 x 1440.
FUZZ_SEEDS = {'config': 200, 'wrappers': 200, 'spatial_rank': 200,
              'seeps': 200, 'time_bins': 200, 'sparse': 100, 'dispatch': 20,
              'inference': 50, 'large_members': 40, 'large_k': 20}
# The member counts that large_members must launch: the sorted runs, the
# block sort and the merge sort (ops/crps_pairwise.spread_form).
FUZZ_LARGE_FORMS = ('sorted', 'blocksort', 'mergesort')


def fuzz_phase(card: str) -> dict:
  """Phase 17: the randomized parity fuzz on the card, checked."""
  from weatherbenchx_tpu_torch import parity_fuzz
  from weatherbenchx_tpu_torch.ops import crps_pairwise
  t0 = time.perf_counter()
  report, failures = parity_fuzz.fuzz(FUZZ_SEEDS, DEVICE)
  seconds = time.perf_counter() - t0
  for f in failures[:10]:
    log(f'parity fuzz failure: {json.dumps(f)}')
  if failures:
    raise AssertionError(f'phase 17: {len(failures)} fuzz configs failed')
  for family, n in FUZZ_SEEDS.items():
    if report[family]['configs'] != n:
      raise AssertionError(f'phase 17: {family} ran '
                           f'{report[family]["configs"]} configs, not {n}')
  by_kind = report['config']['launches_by_kind']
  fused = sum(by_kind.get(k, {}).get('fused_ensemble_stats', 0)
              for k in ('ensemble', 'two_ensemble'))
  two = by_kind.get('two_ensemble', {})
  if not fused or not two.get('pairwise_cross_sum') or not two.get(
      'pairwise_spread_sum'):
    raise AssertionError('phase 17: the ensemble configs must launch the '
                         'fused kernel and the two-ensemble configs the '
                         f'cross and spread kernels; launches {by_kind}')
  large = report['large_members']
  seen = {crps_pairwise.spread_form(m)
          for name in ('fused_ensemble_stats', 'pairwise_spread_sum')
          for m in large['members'].get(name, ())}
  if not set(FUZZ_LARGE_FORMS) <= seen:
    raise AssertionError(f'phase 17: large_members launched the forms '
                         f'{sorted(seen)}, want {FUZZ_LARGE_FORMS}; members '
                         f'{large["members"]}')
  for family, r in report.items():
    if family == parity_fuzz.LARGE_K:
      log(f'parity fuzz {family}: {r["configs"]} seeds, largest scaled '
          f'error {r["max_error"]:.3e} (limit {parity_fuzz.LARGE_K_LIMIT}), '
          f'rows {min(r["rows"])}-{max(r["rows"])}, bins '
          f'{min(r["bins"])}-{max(r["bins"])}, {r["seconds"]:.2f} s; '
          f'card {card}')
    else:
      f64 = (f', largest gap to float64 {r["max_gap_float64"]:.3e}'
             if 'max_gap_float64' in r else '')
      log(f'parity fuzz {family}: {r["configs"]} configs '
          f'({dict(sorted(collections.Counter(r["kinds"]).items()))}), '
          f'largest gap {r["max_gap"]:.3e}{f64}, {r["seconds"]:.2f} s on the '
          f'card, {r["cpu_seconds"]:.2f} s on the CPU, launches '
          f'{r["launches"]}, members {r["members"]}; card {card}')
  log(f'phase 17 parity fuzz: {seconds:.1f} s')
  return dict(report, seconds=seconds)


# -- Phase 18, the drivers at full width ----------------------------------------
# Each run of the stream demo is `python -m
# weatherbenchx_tpu_torch.tools.stream_scale_demo`, a process of its own,
# so that the RSS it reports is its own; the stores and fixtures are
# written, the examples and the canonical drive of the benchmark CLI run,
# through their main() in this process (the examples' kernel launches are
# counted here). Stores
# go under DISK_STORE_DIR and are deleted after use. The month is the JAX
# tool's (31 inits x 50 members x 721 x 1440, zarr v2 blosc) at chunks of
# DRIVER_MONTH_CHUNK inits, the store's own cells (the tool's default of
# 32 would hold the whole month, 6.4 GB, on the host at once); the year is
# cut to DRIVER_YEAR_INITS inits of its 1,460 (depth only: the grid and the
# 2 leads stay) at the tool's chunks of 32. The kill-and-resume run is
# killed once its checkpoint records DRIVER_KILL_AFTER chunks.
DRIVER_GRID = (721, 1440)
DRIVER_MONTH_INITS = 31
DRIVER_MONTH_MEMBERS = 50
DRIVER_MONTH_CHUNK = 4
DRIVER_YEAR_INITS = 365
DRIVER_YEAR_CHUNK = 32
DRIVER_KILL_AFTER = 3
DRIVER_NEEDS_BYTES = 10 * 2**30
DRIVER_TIMEOUT_S = 600
# The canonical month drive (the verify skill's): the fixtures' RMSE is
# sqrt(2) and their ACC 1/2 by construction; the global bin over 62 inits
# of 64 x 32 holds both to a few tenths of a percent.
CANONICAL_RMSE_RTOL = 0.02
CANONICAL_ACC_ATOL = 0.02


def driver_report(module: str, args: list) -> dict:
  """Runs ``python -m <module> <args>`` from the checkout; the JSON object
  its last line prints (None if that is no JSON object)."""
  out = subprocess.run(
      [sys.executable, '-m', module] + list(args),
      cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
      text=True, timeout=DRIVER_TIMEOUT_S)
  if out.returncode != 0:
    raise AssertionError(f'{module} {" ".join(args)} exited '
                         f'{out.returncode}:\n{out.stdout[-4000:]}\n'
                         f'{out.stderr[-4000:]}')
  last = out.stdout.strip().splitlines()[-1]
  return json.loads(last) if last.startswith('{') else None


STREAM_DEMO = 'weatherbenchx_tpu_torch.tools.stream_scale_demo'


def demo_tile(seed: int, nlat: int, nlon: int):
  """The stream demo's random tile as its store writer draws it (numpy
  default_rng(seed), 8 float32 fields), float64 on the card."""
  import torch
  rng = np.random.default_rng(seed)
  tile = rng.standard_normal((8, nlat, nlon)).astype(np.float32)
  return torch.from_numpy(tile).to(DEVICE, torch.float64)


def demo_slab(tile, i: int):
  """Slab i of the stream demo's stores: the tile's field i % 8, its first
  point holding i."""
  slab = tile[i % 8].clone()
  slab[0, 0] = i
  return slab


def demo_lat_weights(nlat: int, nlon: int):
  """Area weights (lat, 1), float64 on the card, of the stores' descending
  latitudes."""
  import torch
  from weatherbenchx_tpu_torch import weighting
  from weatherbenchx_tpu_torch.darray import DimArray
  lats = np.linspace(90, -90, nlat)
  da = DimArray(np.zeros((nlat, nlon), np.float32), ('latitude', 'longitude'),
                {'latitude': lats,
                 'longitude': np.linspace(0, 360, nlon, endpoint=False)})
  w = weighting.GridAreaWeighting().weights(da)
  return torch.from_numpy(np.asarray(w.values, np.float64)).to(DEVICE)[:, None]


def month_f64_reference(n_init: int, members: int, nlat: int,
                        nlon: int) -> dict:
  """The month's metrics in float64 on the card: the stores' slabs made
  again from the tile (not read back), the plain fused statistics over
  the members, explicit area-weighted means over inits and the grid."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  tile = demo_tile(1, nlat, nlon)
  w = demo_lat_weights(nlat, nlon)
  sums = {'skill': 0.0, 'spread': 0.0, 'var': 0.0, 'umse': 0.0, 'se': 0.0}
  for j in range(n_init):
    x = torch.stack([demo_slab(tile, m * n_init + j) for m in range(members)])
    y = demo_slab(tile, j)
    spread, skill, mean, sq_dev = cp.fused_ensemble_stats_plain(x, y)
    var = sq_dev / (members - 1)
    se = (mean - y) ** 2
    for k, s in (('skill', skill / members),
                 ('spread', spread / (members * (members - 1))),
                 ('var', var), ('umse', se - var / members), ('se', se)):
      sums[k] = sums[k] + (s * w).sum()
  mean = {k: (v / (w.sum() * nlon * n_init)).item() for k, v in sums.items()}
  return {'crps': mean['skill'] - 0.5 * mean['spread'],
          'spread_skill': math.sqrt(mean['var'] / mean['umse']),
          'mean_rmse': math.sqrt(mean['se'])}


def year_f64_reference(n_init: int, n_lead: int, nlat: int, nlon: int,
                       regions: dict) -> dict:
  """The year's RMSE in float64 on the card, {(lead index, region): value}:
  the slabs made again from the tile, explicit weighted means."""
  import torch
  from weatherbenchx_tpu_torch import binning
  from weatherbenchx_tpu_torch.darray import DimArray
  tile = demo_tile(0, nlat, nlon)
  w = demo_lat_weights(nlat, nlon)
  lats = np.linspace(90, -90, nlat)
  lons = np.linspace(0, 360, nlon, endpoint=False)
  grid = DimArray(np.zeros((nlat, nlon), np.float32),
                  ('latitude', 'longitude'),
                  {'latitude': lats, 'longitude': lons})
  names = list(regions)
  bins = torch.from_numpy(binning.Regions(regions).create_bin_mask(
      grid).values).to(DEVICE, torch.float64)
  wb = w[None] * bins  # (region, lat, lon)
  out = {}
  for lead in range(n_lead):
    acc = torch.zeros((nlat, nlon), dtype=torch.float64, device=DEVICE)
    for j in range(n_init):
      acc += (demo_slab(tile, j * n_lead + lead)
              - demo_slab(tile, j + lead)) ** 2
    mse = (acc[None] * wb).sum((1, 2)) / (wb.sum((1, 2)) * n_init)
    for r, name in enumerate(names):
      out[(lead, name)] = math.sqrt(mse[r].item())
  return out


def values_equal(path_a: str, path_b: str) -> bool:
  from weatherbenchx_tpu_torch import io
  a, b = io.load_dataset(path_a), io.load_dataset(path_b)
  return sorted(a) == sorted(b) and all(
      a[k].dims == b[k].dims and np.array_equal(a[k].values, b[k].values)
      for k in a)


def killed_and_resumed(args: list, manifest: str, total: int) -> dict:
  """Runs the driver with ``args`` (checkpointing every chunk), SIGKILLs it
  once its checkpoint records DRIVER_KILL_AFTER chunks, then runs the same
  command again; returns the rerun's report with the kill's chunk."""
  log_path = os.path.join(DISK_STORE_DIR, 'killed.log')
  with open(log_path, 'w') as log_file:
    proc = subprocess.Popen(
        [sys.executable, '-m', STREAM_DEMO] + args,
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log_file,
        stderr=subprocess.STDOUT)
    try:
      deadline = time.monotonic() + DRIVER_TIMEOUT_S
      done = 0
      while done < DRIVER_KILL_AFTER and proc.poll() is None:
        if time.monotonic() > deadline:
          raise AssertionError('the checkpointed run did not reach '
                               f'{DRIVER_KILL_AFTER} chunks in time')
        if os.path.exists(manifest):
          with open(manifest) as f:
            done = json.load(f)['next_chunk']
        time.sleep(0.02)
    finally:
      proc.kill()
      proc.wait(timeout=60)
  if proc.returncode != -9:
    with open(log_path) as f:
      raise AssertionError(f'the checkpointed run ended by itself (exit '
                           f'{proc.returncode}) before it was killed:\n'
                           f'{f.read()[-4000:]}')
  with open(manifest) as f:
    killed_at = json.load(f)['next_chunk']
  if not DRIVER_KILL_AFTER <= killed_at < total:
    raise AssertionError(f'killed at chunk {killed_at} of {total}')
  report = driver_report(STREAM_DEMO, args)
  return dict(report, killed_at=killed_at)


def time_month_flip(pred_path: str, inits, leads, card: str) -> dict:
  """One month chunk's predictions read from the zarr store by the loader
  without and with the latitude flip (one read each: the flip is several
  times the read's run-to-run spread), each read's native decode seconds
  beside it."""
  import torch
  from weatherbenchx_tpu_torch import native
  from weatherbenchx_tpu_torch.apps import configs
  from weatherbenchx_tpu_torch.data import loaders
  out, chunks = {}, {}
  for name in ('plain', 'flip'):
    loader = loaders.PredictionsFromDataset(
        path=pred_path, rename_dimensions=None,
        preprocessing_fn=configs.sort_latitude if name == 'flip' else None)
    loader.maybe_prepare_dataset()
    native.reset_call_counts()
    t0 = time.perf_counter()
    chunks[name] = loader.load_chunk(inits, leads)
    out[name] = {'seconds': time.perf_counter() - t0,
                 'decode_cells_s': native.SECONDS['decode_cells']}
  for k, da in chunks['plain'].items():
    if not torch.equal(chunks['flip'][k].data,
                       da.data.flip(da.dims.index('latitude'))):
      raise AssertionError(f'{k}: the flipped month chunk is not the plain '
                           'one reversed along latitude')
  out['flip_share'] = 1 - out['plain']['seconds'] / out['flip']['seconds']
  log(f'drivers: one month chunk ({len(inits)} inits) read with the latitude '
      f'flip {out["flip"]["seconds"]:.3f} s (native decode '
      f'{out["flip"]["decode_cells_s"]:.3f} s), without it '
      f'{out["plain"]["seconds"]:.3f} s (decode '
      f'{out["plain"]["decode_cells_s"]:.3f} s): the flip '
      f'{100 * out["flip_share"]:.1f}% of the read; card {card}')
  return out


def check_rss_growth(label: str, report: dict) -> float:
  growth = report['rss_end_gb'] - report['rss_after_chunk_3_gb']
  if not growth < report['chunk_host_gb']:
    raise AssertionError(
        f'{label}: RSS grew {growth:.3f} GB from chunk 3 to the end, not '
        f'below one chunk\'s host bytes ({report["chunk_host_gb"]:.3f} GB)')
  return growth


def log_stream(label: str, report: dict, card: str) -> None:
  chunk_s = report['chunk_seconds']
  log(f'{label}: {report["chunks_run"]} chunks in '
      f'{report["wall_seconds"]:.2f} s, chunk seconds first '
      f'{chunk_s[0]:.3f} / median 2-6 {report["chunk_s_median_2_6"]:.3f} / '
      f'median last 5 {report["chunk_s_median_last_5"]:.3f} / mean 2-6 '
      f'{report["chunk_s_mean_2_6"]:.3f} / mean last 5 '
      f'{report["chunk_s_mean_last_5"]:.3f} / last {chunk_s[-1]:.3f} '
      f'(each {[round(c, 3) for c in chunk_s]}); RSS after the imports '
      f'{report["rss_start_gb"]:.3f}, before the first chunk '
      f'{report["rss_before_gb"]:.3f} (peak by then '
      f'{report["peak_rss_before_gb"]:.3f}), after chunk 3 '
      f'{report["rss_after_chunk_3_gb"]:.3f}, end '
      f'{report["rss_end_gb"]:.3f}, peak {report["peak_rss_gb"]:.3f} GB '
      f'(one chunk {report["chunk_host_gb"]:.3f} GB); store '
      f'{report["store_gb"]:.3f} GB; timers {json.dumps(report["timers"])}; '
      f'native seconds {json.dumps(report["native_seconds"])}; launches '
      f'{report["launches"]}; card {card}')


def stream_month(card: str) -> dict:
  """Phase 18(a): the month at full width, against float64, killed and
  resumed."""
  from weatherbenchx_tpu_torch.tools import stream_scale_demo as sd
  sizes = sd.Sizes(DISK_STORE_DIR, DRIVER_MONTH_INITS, DRIVER_MONTH_MEMBERS,
                   *DRIVER_GRID)
  chunks = math.ceil(sizes.n_init / DRIVER_MONTH_CHUNK)
  common = ['--ens', '--format', 'zarr', '--store_dir', DISK_STORE_DIR,
            '--n_init', str(sizes.n_init), '--members', str(sizes.members),
            '--grid', f'{sizes.nlon}x{sizes.nlat}']
  t0 = time.perf_counter()
  sd.main(['--make_store', '--compressor', 'blosc'] + common)
  made_s = time.perf_counter() - t0
  run = ['--run', '--device', DEVICE, '--chunk', str(DRIVER_MONTH_CHUNK)
         ] + common
  whole_path = os.path.join(DISK_STORE_DIR, 'month_whole.npz')
  whole = driver_report(STREAM_DEMO, run + ['--output', whole_path])
  log_stream('drivers: month', whole, card)
  want = chunks * sd.FUSED_LAUNCHES_PER_CHUNK
  if whole['launches'] != {'fused_ensemble_stats': want,
                           'pairwise_spread_sum': 0, 'pairwise_cross_sum': 0}:
    raise AssertionError(f'month: launches {whole["launches"]}, want {want} '
                         'fused (the CPU count per chunk x chunks) and no '
                         'other')
  t0 = time.perf_counter()
  ref = month_f64_reference(sizes.n_init, sizes.members, sizes.nlat,
                            sizes.nlon)
  ref_s = time.perf_counter() - t0
  errors = {}
  for key, name in (('crps_global', 'crps'), ('spread_skill', 'spread_skill'),
                    ('mean_rmse', 'mean_rmse')):
    errors[name] = abs(whole[key] - ref[name]) / abs(ref[name])
    if not errors[name] <= F64_RTOL:
      raise AssertionError(f'month {name}: {whole[key]} vs float64 '
                           f'{ref[name]}: rel err {errors[name]:.3g}')
  log(f'drivers: month crps {whole["crps_global"]:.7f}, spread/skill '
      f'{whole["spread_skill"]:.7f}, ensemble-mean RMSE '
      f'{whole["mean_rmse"]:.7f}; rel err vs float64 {errors} (tol '
      f'{F64_RTOL}; reference {ref_s:.1f} s); store written in '
      f'{made_s:.1f} s')
  ckpt = os.path.join(DISK_STORE_DIR, 'month.ckpt')
  resumed_path = os.path.join(DISK_STORE_DIR, 'month_resumed.npz')
  resumed = killed_and_resumed(
      run + ['--checkpoint_path', ckpt, '--checkpoint_every', '1',
             '--output', resumed_path], f'{ckpt}.manifest.json', chunks)
  if resumed['chunks_run'] != chunks - resumed['killed_at']:
    raise AssertionError(f'the resumed run ran {resumed["chunks_run"]} '
                         f'chunks after a kill at {resumed["killed_at"]}')
  if not values_equal(resumed_path, whole_path):
    raise AssertionError('the killed-and-resumed month differs from the '
                         'uninterrupted one')
  log_stream('drivers: month resumed', resumed, card)
  log(f'drivers: month killed at chunk {resumed["killed_at"]} of {chunks}, '
      f'resumed: values equal to the uninterrupted run by np.array_equal')
  growth = check_rss_growth('month', whole)
  init_times, lead_times = sd._ens_times(sizes)
  flip = time_month_flip(sd.store_paths(sizes, 'zarr', True)[1],
                         init_times[:DRIVER_MONTH_CHUNK], lead_times, card)
  loads = sum(whole['timers'][f'load_{side}_seconds']['total']
              for side in ('predictions', 'targets'))
  decode_share = whole['native_seconds']['decode_cells'] / loads
  log(f'drivers: month RSS growth from chunk 3 to the end {growth:.3f} GB '
      f'(limit {whole["chunk_host_gb"]:.3f}); native decode '
      f'{100 * decode_share:.1f}% of the loads\' seconds; card {card}')
  return {'whole': whole, 'resumed': resumed, 'rel_err': errors,
          'store_write_s': made_s, 'rss_growth_gb': growth, 'flip': flip,
          'decode_share': decode_share}


def stream_year(card: str) -> dict:
  """Phase 18(b): the year, cut to DRIVER_YEAR_INITS inits, against
  float64."""
  from weatherbenchx_tpu_torch import io
  from weatherbenchx_tpu_torch.tools import stream_scale_demo as sd
  nlat, nlon = DRIVER_GRID
  common = ['--store_dir', DISK_STORE_DIR, '--n_init', str(DRIVER_YEAR_INITS),
            '--grid', f'{nlon}x{nlat}']
  t0 = time.perf_counter()
  sd.main(['--make_store'] + common)
  made_s = time.perf_counter() - t0
  out_path = os.path.join(DISK_STORE_DIR, 'year.npz')
  report = driver_report(STREAM_DEMO, [
      '--run', '--device', DEVICE, '--chunk', str(DRIVER_YEAR_CHUNK),
      '--output', out_path] + common)
  log_stream('drivers: year', report, card)
  rmse = io.load_dataset(out_path)['rmse.2m_temperature']
  if rmse.dims != ('lead_time', 'region'):
    raise AssertionError(f'year rmse dims {rmse.dims}')
  ref = year_f64_reference(DRIVER_YEAR_INITS, sd.N_LEAD, nlat, nlon,
                           sd.YEAR_REGIONS)
  regions = [str(r) for r in rmse.coord_values('region')]
  worst = 0.0
  for (lead, region), want in ref.items():
    got = float(rmse.values[lead, regions.index(region)])
    worst = max(worst, abs(got - want) / want)
  if not worst <= F64_RTOL:
    raise AssertionError(f'year rmse: rel err vs float64 {worst:.3g}')
  growth = check_rss_growth('year', report)
  log(f'drivers: year ({DRIVER_YEAR_INITS} inits) rmse_global '
      f'{report["rmse_global"]:.7f}, rel err vs float64 {worst:.3g} (tol '
      f'{F64_RTOL}); RSS growth from chunk 3 to the end {growth:.3f} GB '
      f'(limit {report["chunk_host_gb"]:.3f}); store written in '
      f'{made_s:.1f} s; card {card}')
  return {'report': report, 'rel_err': worst, 'store_write_s': made_s,
          'rss_growth_gb': growth}


def example_lines(module, device: str) -> tuple:
  """(printed lines, kernel launches) of one example run in this process."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  text = run_main(module.__name__, ['--device', device])
  if device == 'cuda':
    import torch
    torch.cuda.synchronize()
  return text.splitlines(), dict(cp.LAUNCHES)


def examples_and_canonical(card: str) -> dict:
  """Phase 18(c): the examples on the card against their CPU runs, and the
  port's fixtures through the canonical month drive."""
  import tempfile
  from weatherbenchx_tpu_torch import io
  from weatherbenchx_tpu_torch.examples import ensemble_zarr_pipeline
  from weatherbenchx_tpu_torch.examples import quickstart
  from weatherbenchx_tpu_torch.examples import significance_testing
  from weatherbenchx_tpu_torch.tools import gen_demo_fixtures
  out = {}
  tempdir = tempfile.tempdir
  tempfile.tempdir = DISK_STORE_DIR  # where the examples' stores go
  try:
    for name, module, fused in (
        ('quickstart', quickstart, 0),
        ('significance_testing', significance_testing, 0),
        # 8 inits in chunks of 2: one M = 8 fused launch per chunk.
        ('ensemble_zarr_pipeline', ensemble_zarr_pipeline, 4)):
      t0 = time.perf_counter()
      lines, launches = example_lines(module, DEVICE)
      seconds = time.perf_counter() - t0
      cpu_lines, _ = example_lines(module, 'cpu')
      if lines != cpu_lines:
        raise AssertionError(f'example {name} printed on the card {lines}, '
                             f'on the CPU {cpu_lines}')
      if launches['fused_ensemble_stats'] != fused:
        raise AssertionError(f'example {name}: launches {launches}')
      out[name] = {'seconds': seconds, 'launches': launches}
      log(f'drivers: example {name} on the card in {seconds:.2f} s, its '
          f'{len(lines)} lines equal to its CPU run, launches {launches}; '
          f'card {card}')
  finally:
    tempfile.tempdir = tempdir
  demo = os.path.join(DISK_STORE_DIR, 'demo')
  t0 = time.perf_counter()
  gen_demo_fixtures.main([demo, '--device', DEVICE])
  fixtures_s = time.perf_counter() - t0
  for name, ds in gen_demo_fixtures.make_fixtures('cpu').items():
    got = io.load_dataset(os.path.join(demo, f'{name}.npz'))
    if sorted(got) != sorted(ds) or not all(
        np.array_equal(got[k].values, ds[k].values) for k in ds):
      raise AssertionError(f'fixtures {name}: the card\'s differ from the '
                           'CPU\'s')
  results = os.path.join(DISK_STORE_DIR, 'demo_out')
  t0 = time.perf_counter()
  run_main('weatherbenchx_tpu_torch.apps.run_benchmark_evaluation', [
      '--prediction=hres', f'--prediction_path={demo}/hres.npz',
      f'--target_path={demo}/era5.npz', f'--climatology_path={demo}/clim.npz',
      '--resolution=64x32', '--year=2020', '--init_time_start=2020-01-01',
      '--init_time_stop=2020-02-01', '--variables=geopotential,2m_temperature',
      '--levels=500,700,850', f'--output_dir={results}',
      f'--device={DEVICE}'])
  canonical_s = time.perf_counter() - t0
  values = io.load_dataset(os.path.join(
      results, 'hres_vs_era5_64x32_2020-init12h.npz'))
  spans = {}
  for key, want, tol in (('rmse', math.sqrt(2), CANONICAL_RMSE_RTOL
                          * math.sqrt(2)), ('acc', 0.5, CANONICAL_ACC_ATOL)):
    for var in ('2m_temperature', 'geopotential'):
      g = values[f'{key}.{var}'].sel(region='global').values
      spans[f'{key}.{var}'] = (float(g.min()), float(g.max()))
      if not (np.isfinite(g).all() and np.abs(g - want).max() <= tol):
        raise AssertionError(f'canonical drive {key}.{var} global: '
                             f'{spans[f"{key}.{var}"]}, want {want} +- {tol}')
  log(f'drivers: fixtures on the card in {fixtures_s:.1f} s (equal to the '
      f'CPU\'s array by array); canonical month drive in {canonical_s:.1f} s, '
      f'global bin ranges {spans} (RMSE sqrt(2) within '
      f'{CANONICAL_RMSE_RTOL:.0%}, ACC 1/2 within {CANONICAL_ACC_ATOL}); '
      f'card {card}')
  return dict(out, fixtures_s=fixtures_s, canonical_s=canonical_s,
              canonical=spans)


def driver_phase(card: str) -> dict:
  """Phase 18: the drivers at full width, checked."""
  import shutil
  t0 = time.perf_counter()
  shutil.rmtree(DISK_STORE_DIR, ignore_errors=True)
  os.makedirs(DISK_STORE_DIR)
  free = shutil.disk_usage(DISK_STORE_DIR).free
  if free < DRIVER_NEEDS_BYTES:
    raise AssertionError(f'{DISK_STORE_DIR}: {free} bytes free, the month\'s '
                         f'stores need {DRIVER_NEEDS_BYTES}')
  try:
    month = stream_month(card)
    shutil.rmtree(DISK_STORE_DIR)
    os.makedirs(DISK_STORE_DIR)
    year = stream_year(card)
    shutil.rmtree(DISK_STORE_DIR)
    os.makedirs(DISK_STORE_DIR)
    examples = examples_and_canonical(card)
  finally:
    shutil.rmtree(DISK_STORE_DIR, ignore_errors=True)
  seconds = time.perf_counter() - t0
  log(f'phase 18 drivers: {seconds:.1f} s')
  return {'month': month, 'year': year, 'examples': examples,
          'seconds': seconds}


# -- Phase 19, the docs -----------------------------------------------------------


def docs_phase(card: str) -> dict:
  """Phase 19: every how-to notebook's code cells on the card (the
  builders of tools/make_notebooks with the device DEVICE, run in a fresh
  namespace each, without nbformat), their printed numbers held to the
  committed CPU notebooks' (make_notebooks.compare_printed: 1e-5 relative,
  or one unit in the last printed digit). While they run, every array that
  reaches a metric's statistics must be on the card; a notebook that
  computes a metric must reach them. sparse_data is left out: it reads
  Parquet through pandas and pyarrow, which the port does not require on
  the GPU."""
  import torch
  from weatherbenchx_tpu_torch.metrics import base as metrics_base
  from weatherbenchx_tpu_torch.tools import make_notebooks as mn
  compute = metrics_base.generate_unique_statistics_for_all_metrics
  reached = {'calls': 0, 'arrays': 0}

  def on_card(metrics, predictions, targets):
    for side in (predictions, targets):
      for name, da in side.items():
        if da.device.type != torch.device(DEVICE).type:
          raise AssertionError(f'docs: {name} reached a metric on '
                               f'{da.device}, not {DEVICE}')
        reached['arrays'] += 1
    reached['calls'] += 1
    return compute(metrics, predictions, targets)

  out = {}
  t_phase = time.perf_counter()
  metrics_base.generate_unique_statistics_for_all_metrics = on_card
  try:
    for name, build in mn.NOTEBOOKS.items():
      if name in mn.NEEDS_PARQUET:
        log(f'phase 19 docs: {name} left out (it reads Parquet through '
            'pandas and pyarrow, which the port does not require on the '
            'GPU; its committed notebook ran on the CPU)')
        continue
      cells = build(DEVICE)
      reached.update(calls=0, arrays=0)
      t0 = time.perf_counter()
      printed = mn.run_cells(cells)
      if DEVICE == 'cuda':
        torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
      want = mn.committed_outputs(os.path.join(mn.OUT, f'{name}.ipynb'))
      if len(printed) != len(want):
        raise AssertionError(f'docs {name}: {len(printed)} code cells, the '
                             f'committed notebook has {len(want)}')
      for k, (got, ref) in enumerate(zip(printed, want)):
        diff = mn.compare_printed(got, ref)
        if diff is not None:
          raise AssertionError(f'docs {name} code cell {k}: {diff}')
      computes = any('compute_' in src or 'evaluate(' in src
                     for kind, src in cells if kind == 'code')
      if computes and not reached['calls']:
        raise AssertionError(f'docs {name}: no statistics computed')
      out[name] = {'seconds': seconds, 'cells': len(printed),
                   'statistics_calls': reached['calls'],
                   'arrays_on_card': reached['arrays']}
      log(f'phase 19 docs: {name} on the card in {seconds:.2f} s, its '
          f'{len(printed)} code cells\' printed numbers within 1e-5 of the '
          f'committed CPU notebook, {reached["calls"]} statistics passes '
          f'over {reached["arrays"]} arrays, all on {DEVICE}; card {card}')
  finally:
    metrics_base.generate_unique_statistics_for_all_metrics = compute
  out['seconds'] = time.perf_counter() - t_phase
  return out


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--seed', type=int, default=0)
  args = parser.parse_args()

  t_start = time.perf_counter()
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this script runs only on the GPU',
          file=sys.stderr)
    return 1
  card = card_line()
  log(card)
  marks = [('start', t_start)]

  def done(msg: str) -> None:
    """Logs a phase's end and keeps its time for the per-phase seconds."""
    log(msg)
    marks.append((msg.split(':')[0], time.perf_counter()))
  kind = torch.cuda.get_device_name(0)
  log(f'phase 1 device: {kind}, {torch.cuda.device_count()} device(s), '
      f'torch {torch.__version__}, CUDA {torch.version.cuda}')

  from weatherbenchx_tpu_torch.ops import _build
  t0 = time.perf_counter()
  lib_path = _build.build()
  _build.load_library()
  log(f'phase 2 build: {_build.CSRC} + {len(_build.generated_sources())} '
      f'generated files -> {lib_path} in {time.perf_counter() - t0:.1f} s '
      f'({_build.PARTS + 2} nvcc processes at once, then the link)')
  with open(lib_path + '.log') as f:
    merge_regs = mergesort_registers(build_report(f.read()))
  done('phase 2 build: every kernel without a stack frame or spills')

  main_err = check_kernels(args.seed)
  done('phase 3 kernels: all checks within tolerance')
  ev, chunks, main_launches, main_values = main_path(args.seed)
  done('phase 4 main path: ok')
  large = large_ensemble_path(args.seed, card)
  done('phase 4b large ensemble: ok')
  hens = hens_path(args.seed, card)
  done('phase 4c HENS path: ok')
  lagged = lagged_path(args.seed, card)
  done('phase 4d lagged HENS path: ok')
  stores, ens_launches = ensemble_path(args.seed)
  done('phase 5 ensemble path: ok')
  bench, bstores, bstate, in_memory = benchmark_path(args.seed, card)
  done('phase 6 benchmark path: ok')
  cli_phase(args.seed)
  done('phase 7 cli: ok')
  _, cli_outputs = benchmark_cli_phase(args.seed)
  done('phase 8 benchmark cli: ok')
  scorecard = scorecard_phase(cli_outputs)
  done('phase 15d scorecard: ok')
  disk = disk_benchmark_path(bstores, bstate, in_memory, card)
  del bstate
  done('phase 9 disk benchmark path: ok')
  res = timing(ev, chunks, stores, card)
  done('phase 10 timing: done')
  batched_main = batched_main_path(chunks, main_values, card)
  done('phase 15a batched main path: ok')
  del ev, chunks, stores
  families = family_phase(args.seed, card)
  done('phase 11 metric families: ok')
  station = station_path(args.seed, card)
  done('phase 12 station path: ok')
  unagg = unaggregated_path(bstores, card)
  del bstores
  done('phase 13 unaggregated path: ok')
  significance = significance_path(args.seed, card)
  done('phase 14 significance: ok')
  dispatch = dispatch_path(args.seed, card)
  done('phase 15c dispatch path: ok')
  latency = latency_phase(args.seed, card)
  done('phase 15e latency wrapper: ok')
  ranks = rank_path(args.seed, main_values, card)
  done('phase 16 ranks: ok')
  fuzz = fuzz_phase(card)
  done('phase 17 parity fuzz: ok')
  drivers = driver_phase(card)
  done('phase 18 drivers: ok')
  docs = docs_phase(card)
  done('phase 19 docs: ok')
  log(f'benchmark path seconds per chunk: {json.dumps(bench)}; card {card}')
  log(f'disk benchmark path: {json.dumps(disk)}; card {card}')
  hens_log = {k: v for k, v in hens.items() if k != 'timing'}
  log(f'HENS path: {json.dumps(hens_log)}; card {card}')
  lagged_log = {k: v for k, v in lagged.items() if k != 'timing'}
  log(f'lagged HENS path: {json.dumps(lagged_log)}; card {card}')
  log(f'metric families: {json.dumps(families)}; card {card}')
  log(f'station path: {json.dumps(station)}; card {card}')
  log(f'unaggregated path: {json.dumps(unagg)}; card {card}')
  log(f'significance: {json.dumps(significance)}; card {card}')
  batched = {'main': batched_main, 'benchmark': bench['batched'],
             'dispatch': dispatch, 'scorecard': scorecard,
             'latency': latency}
  log(f'batched dispatch: {json.dumps(batched)}; card {card}')
  log(f'ranks: {json.dumps(ranks)}; card {card}')
  log(f'parity fuzz: {json.dumps(fuzz)}; card {card}')
  log(f'drivers: {json.dumps(drivers)}; card {card}')
  log(f'docs: {json.dumps(docs)}; card {card}')
  phase_seconds = {name: round(t - marks[k - 1][1], 1)
                   for k, (name, t) in enumerate(marks) if k}
  log(f'seconds by phase, the build in phase 2: {json.dumps(phase_seconds)}')
  log(f'whole script: {time.perf_counter() - t_start:.1f} s '
      f'(the build included); card {card}')

  n = math.prod(GRID)
  print(json.dumps(kernels_line(main_launches, ens_launches, main_err, res,
                                n, station['ensemble'], batched_main, large,
                                hens, lagged, merge_regs)),
        flush=True)
  print(card, flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind,
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
